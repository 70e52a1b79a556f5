"""The fused pyramid gather (LI_FUSION.FUSED_PYRAMID) against the JAX
package's, on the CPU, with the same weights; and the route the port takes
in eval, in a validation step and in a training step.

- `ImagePyramidFusion(levels, xy)` against JAX's `_wide_gather` (random
  weights and BatchNorm statistics, points projecting outside the image,
  batch 2) within rtol / atol 1e-5, the gate of
  `tests/test_fused_pyramid.py`; and against the port's own materialized
  map sampled by `feature_gather`.
- The whole eval forward at the small config with FUSED_PYRAMID on, the
  port against JAX's, within 2e-4 (JAX's own fused-vs-materialized gate).
- The route counter: fused in the eval forward and the validation step,
  materialized in a finetune training step under RPN.FIXED (where the JAX
  package differentiates the whole apply), as
  `tests/test_train_step.py::test_finetune_fused_pyramid_stays_materialized`
  holds the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import jmodt_tpu.models.pointnet2 as jax_pointnet2
from jmodt_tpu.data import synthetic as jax_synthetic
from jmodt_tpu.models.image_backbone import \
    ImagePyramidFusion as JaxPyramid
from jmodt_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from jmodt_tpu.ops.pallas.three_nn import three_nn_pallas
from jmodt_torch import config as torch_config
from jmodt_torch.data.synthetic import make_pair_batch
from jmodt_torch.models import image_backbone
from jmodt_torch.models.image_backbone import (ImagePyramidFusion,
                                               feature_gather)
from jmodt_torch.models.point_rcnn import PointRCNN, build_detector
from jmodt_torch.train import train_step
from jmodt_torch.weights import jax_variables_to_state_dict, \
    load_jax_variables

KERNELS = (2, 4, 8, 16)
CHANNELS = (8, 16, 32, 64)
REDUCE = (4, 4, 4, 4)
OUT = 8
TOL = 1e-5
MODEL_TOL = 2e-4
MODEL_KEYS = ('rpn_cls', 'rpn_reg', 'backbone_xyz', 'backbone_features',
              'rois', 'roi_scores_raw', 'roi_mask', 'seg_result', 'rcnn_cls',
              'rcnn_reg', 'rcnn_feat')


def _three_nn_kernel_semantics(unknown, known):
    n = unknown.shape[1]
    u = jnp.pad(unknown, ((0, 0), (0, (-n) % 128), (0, 0)))
    d, i = three_nn_pallas(u, known, interpret=True)
    return d[:, :n], i[:, :n]


def _pyramid_setup(seed, b=2, h=32, w=64):
    rng = np.random.RandomState(seed)
    levels = [rng.randn(b, h // k, w // k, c).astype(np.float32)
              for k, c in zip(KERNELS, CHANNELS)]
    # xy beyond [-1, 1] reaches the zero-padding corner masks
    xy = (rng.rand(b, 50, 2) * 2.4 - 1.2).astype(np.float32)
    jmod = JaxPyramid(reduce_channels=REDUCE, kernels=KERNELS,
                      out_channels=OUT)
    variables = jmod.init(jax.random.PRNGKey(0), levels, train=False)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) + 0.25),
        variables)
    tmod = ImagePyramidFusion(CHANNELS, REDUCE, KERNELS, OUT)
    tmod.load_state_dict(jax_variables_to_state_dict(
        jax.device_get(variables)), strict=True)
    return jmod, variables, tmod.eval(), levels, xy


@pytest.mark.parametrize('seed', [0, 1])
def test_fused_gather_matches_jax(seed):
    jmod, variables, tmod, levels, xy = _pyramid_setup(seed)
    want = np.asarray(jmod.apply(variables, levels, train=False, xy=xy))
    before = dict(image_backbone.pyramid_routes)
    with torch.no_grad():
        got = tmod([torch.from_numpy(a) for a in levels],
                   torch.from_numpy(xy)).numpy()
    assert got.shape == want.shape == (2, 50, OUT)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert image_backbone.pyramid_routes['fused'] == before.get('fused',
                                                                0) + 1


def test_fused_gather_matches_materialized_map():
    _, _, tmod, levels, xy = _pyramid_setup(2)
    lv = [torch.from_numpy(a) for a in levels]
    with torch.no_grad():
        got = tmod(lv, torch.from_numpy(xy))
        want = feature_gather(tmod(lv), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_fused_gather_refuses_training_mode():
    _, _, tmod, levels, xy = _pyramid_setup(3)
    tmod.train()
    with pytest.raises(RuntimeError, match='eval-only'):
        tmod([torch.from_numpy(a) for a in levels], torch.from_numpy(xy))


def _fused_cfgs():
    jcfg = __graft_entry__._small_config()
    jcfg = dataclasses.replace(
        jcfg, DTYPE='float32',
        LI_FUSION=dataclasses.replace(jcfg.LI_FUSION, FUSED_PYRAMID=True))
    return jcfg, torch_config._merge(torch_config.Config(),
                                     dataclasses.asdict(jcfg))


@pytest.fixture(scope='module')
def fused_models():
    """The JAX and port eval forwards with FUSED_PYRAMID on, on the same
    small-config frame and weights."""
    jcfg, tcfg = _fused_cfgs()
    frame = jax_synthetic.make_eval_frame(5, jcfg, img_hw=(64, 128))
    pts, img, xy = frame['pts_input'], frame['img'], frame['pts_xy']
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointnet2, 'three_nn', _three_nn_kernel_semantics)
        jmodel = JaxPointRCNN(jcfg, mode='EVAL')
        variables = jax.jit(lambda k: jmodel.init(
            k, pts, img, xy, train=False))(jax.random.PRNGKey(0))
        rng = np.random.RandomState(4)
        stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape)
                                  .astype(np.float32)),
            variables['batch_stats'])
        variables = {'params': variables['params'], 'batch_stats': stats}
        jout = jax.device_get(jax.jit(lambda v: jmodel.apply(
            v, pts, img, xy, train=False))(variables))
    tmodel = load_jax_variables(PointRCNN(tcfg, device='cpu'),
                                jax.device_get(variables), device='cpu')
    before = dict(image_backbone.pyramid_routes)
    tout = tmodel(*(torch.from_numpy(np.asarray(a)) for a in (pts, img, xy)))
    routes = {k: image_backbone.pyramid_routes[k] - before.get(k, 0)
              for k in ('fused', 'materialized')}
    return jout, tout, routes


@pytest.mark.parametrize('key', MODEL_KEYS)
def test_backbone_eval_fused_matches_jax(fused_models, key):
    jout, tout, _ = fused_models
    got, want = tout[key].numpy(), np.asarray(jout[key])
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL,
                               err_msg=key)


def test_eval_forward_takes_the_fused_route(fused_models):
    _, _, routes = fused_models
    assert routes == {'fused': 1, 'materialized': 0}


def test_train_step_takes_the_materialized_route():
    """RPN.FIXED finetune: the RPN runs in eval mode under no_grad in the
    port, yet the step makes the full map, as the JAX package's
    differentiated apply does; the validation step (eval mode, no
    gradients) takes the fused route, as the JAX package's does.  One
    forward a step: the pair's two frames run as one batch."""
    _, tcfg = _fused_cfgs()
    tcfg = dataclasses.replace(
        tcfg, RPN=dataclasses.replace(tcfg.RPN, FIXED=True),
        TRAIN=dataclasses.replace(tcfg.TRAIN, FINETUNE=True))
    model = build_detector(tcfg, mode='TRAIN', device='cpu', seed=0)
    batch = make_pair_batch(seed=2, cfg=tcfg, num_pairs=1, img_hw=(64, 128))
    opt = train_step.make_optimizer(tcfg, model, 4)
    step = train_step.make_train_step(tcfg, model, opt, device='cpu')
    val = train_step.make_val_step(tcfg, model, device='cpu')
    routes = image_backbone.pyramid_routes
    for run, want in ((step, 'materialized'), (val, 'fused')):
        before = dict(routes)
        out = run(batch)
        tb = out[1] if isinstance(out, tuple) else out
        assert np.isfinite(float(tb['loss'].detach()))
        got = {k: routes[k] - before.get(k, 0)
               for k in ('fused', 'materialized')}
        assert got == {'fused': 0, 'materialized': 0, want: 1}, (want, got)
