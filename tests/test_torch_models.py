"""The port's model parts and its whole detection step against the JAX
package's, on the CPU, with the same (exported) weights.

The JAX side is initialized with `jax.jit(model.init)` and its BatchNorm
statistics are randomized so every fold and normalization is non-trivial;
its variables go to the port through `jmodt_torch.weights`.  The JAX 3-NN
is routed through its Pallas kernel in interpret mode
(`three_nn_pallas`, direct distances), which is the function K3 replaces;
the JAX package takes that kernel on the TPU, and its XLA form for small
clouds computes distances through the matmul identity instead.

Tolerances: indices and masks exact; floats within 1e-4 of the output's
scale (float32 throughout, differing only in summation order and fused
multiply-adds).
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
from jmodt_tpu.models import image_backbone as jax_img
from jmodt_tpu.models.inference import make_detection_step as jax_step
from jmodt_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from jmodt_tpu.ops.pallas.three_nn import three_nn_pallas
from jmodt_torch import config as torch_config
from jmodt_torch.data import synthetic
from jmodt_torch.models import image_backbone
from jmodt_torch.models.inference import make_detection_step
from jmodt_torch.models.point_rcnn import PointRCNN, init_weights
from jmodt_torch.models.pointnet2 import FPModule, SAModuleMSG
from jmodt_torch.weights import jax_variables_to_state_dict, \
    load_jax_variables

TOL = 1e-4


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _three_nn_kernel_semantics(unknown, known):
    """The JAX Pallas 3-NN (interpret mode) at any query count: queries
    are independent, so they are padded to its 128-row tile and cut back."""
    n = unknown.shape[1]
    u = jnp.pad(unknown, ((0, 0), (0, (-n) % 128), (0, 0)))
    d, i = three_nn_pallas(u, known, interpret=True)
    return d[:, :n], i[:, :n]


def _randomize_stats(variables, seed):
    if 'batch_stats' not in variables:
        return variables
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        return jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype)

    stats = jax.tree_util.tree_map_with_path(leaf, variables['batch_stats'])
    return {'params': variables['params'], 'batch_stats': stats}


def _load(module, variables):
    module.load_state_dict(jax_variables_to_state_dict(variables),
                           strict=True)
    return module.eval()


def _clustered(rng, b, n, scale=1.0):
    centers = rng.uniform(-10, 10, (b, 4, 3)).astype(np.float32)
    pick = rng.randint(0, 4, (b, n))
    pts = np.take_along_axis(centers, pick[..., None], axis=1)
    return (pts + rng.randn(b, n, 3).astype(np.float32) * scale)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize('fused', [False, True])
def test_sa_module_msg_matches_jax(fused):
    rng = np.random.RandomState(0)
    b, n, c, m = 2, 256, 6, 32
    xyz = _clustered(rng, b, n)
    feats = rng.randn(b, n, c).astype(np.float32)
    kw = dict(npoint=m, radii=(0.5, 1.0), nsamples=(8, 16),
              mlps=((8, 8, 16), (8, 12, 16)))
    jmod = jax_pointnet2.SAModuleMSG(use_xyz=True, use_bn=True,
                                     fused_eval=fused, **kw)
    variables = _randomize_stats(
        jax.jit(lambda k: jmod.init(k, xyz, feats, False))(
            jax.random.PRNGKey(1)), 2)
    want_xyz, want_f, want_idx = jmod.apply(variables, xyz, feats, False)
    tmod = _load(SAModuleMSG(cin=c, use_bn=True, **kw), variables)
    got_xyz, got_f, got_idx = tmod(_t(xyz), _t(feats), fused)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert _rel_err(got_f.numpy(), want_f) < TOL


def test_sa_module_group_all_matches_jax():
    rng = np.random.RandomState(1)
    xyz = rng.randn(3, 32, 3).astype(np.float32)
    feats = rng.randn(3, 32, 8).astype(np.float32)
    jmod = jax_pointnet2.SAModuleMSG(npoint=None, radii=(100.0,),
                                     nsamples=(32,), mlps=((16, 24),),
                                     use_bn=False)
    variables = jax.jit(lambda k: jmod.init(k, xyz, feats, False))(
        jax.random.PRNGKey(3))
    _, want_f, _ = jmod.apply(variables, xyz, feats, False)
    tmod = _load(SAModuleMSG(None, (100.0,), (32,), ((16, 24),), cin=8,
                             use_bn=False), variables)
    new_xyz, got_f, idx = tmod(_t(xyz), _t(feats))
    assert new_xyz is None and idx is None
    assert _rel_err(got_f.numpy(), want_f) < TOL


def test_fp_module_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_pointnet2, 'three_nn',
                        _three_nn_kernel_semantics)
    rng = np.random.RandomState(2)
    unknown = _clustered(rng, 2, 128)
    known = unknown[:, ::4].copy()          # coincident points, as in FP
    uf = rng.randn(2, 128, 5).astype(np.float32)
    kf = rng.randn(2, 32, 7).astype(np.float32)
    jmod = jax_pointnet2.FPModule(mlp=(16, 12))
    variables = _randomize_stats(
        jax.jit(lambda k: jmod.init(k, unknown, known, uf, kf))(
            jax.random.PRNGKey(4)), 5)
    want = jmod.apply(variables, unknown, known, uf, kf)
    tmod = _load(FPModule(12, (16, 12)), variables)
    got = tmod(_t(unknown), _t(known), _t(uf), _t(kf))
    assert _rel_err(got.numpy(), want) < TOL


def test_basic_block_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 24, 5).astype(np.float32)
    jmod = jax_img.BasicBlock(8)
    variables = _randomize_stats(
        jax.jit(lambda k: jmod.init(k, x))(jax.random.PRNGKey(5)), 6)
    want = jmod.apply(variables, x)
    got = _load(image_backbone.BasicBlock(5, 8), variables)(_t(x))
    assert got.shape == want.shape == (2, 8, 12, 8)
    assert _rel_err(got.numpy(), want) < TOL


@pytest.mark.parametrize('k', [2, 4])
def test_non_overlap_deconv_matches_jax(k):
    rng = np.random.RandomState(k)
    x = rng.randn(2, 3, 5, 6).astype(np.float32)
    jmod = jax_img.NonOverlapDeconv(4, k)
    params = jax.jit(lambda key: jmod.init(key, x))(jax.random.PRNGKey(k))
    params = jax.tree.map(lambda p: p + 0.1, params)   # non-zero bias
    want = jmod.apply(params, x)
    sd = jax_variables_to_state_dict(
        {'params': {'NonOverlapDeconv_0': params['params']}})
    tmod = image_backbone.NonOverlapDeconv(6, 4, k)
    tmod.load_state_dict({key.split('.', 1)[1]: v for key, v in sd.items()},
                         strict=True)
    got = tmod(_t(x))
    assert got.shape == want.shape == (2, 3 * k, 5 * k, 4)
    assert _rel_err(got.detach().numpy(), want) < TOL


def test_non_overlap_deconv_keeps_its_table_until_a_load():
    """Without autograd the tap-major table is built once; a new
    state_dict (an in-place write) makes the next call rebuild it."""
    rng = np.random.RandomState(7)
    x = _t(rng.randn(1, 2, 3, 6).astype(np.float32))
    mod = image_backbone.NonOverlapDeconv(6, 4, 2)
    init_weights(mod, 0)
    with torch.no_grad():
        first = mod(x)
        table = mod._tables[1]
        np.testing.assert_array_equal(mod(x).numpy(), first.numpy())
        assert mod._tables[1] is table
        sd = {k: v + 1.0 for k, v in mod.state_dict().items()}
        mod.load_state_dict(sd)
        got = mod(x)
    assert mod._tables[1] is not table
    want = image_backbone.NonOverlapDeconv(6, 4, 2)
    want.load_state_dict(sd)
    np.testing.assert_array_equal(got.numpy(), want(x).detach().numpy())
    assert not np.array_equal(got.numpy(), first.numpy())


def test_feature_gather_matches_jax():
    rng = np.random.RandomState(4)
    fmap = rng.randn(2, 12, 20, 6).astype(np.float32)
    # include points past the border (zero padding fades them out)
    xy = rng.uniform(-1.2, 1.2, (2, 50, 2)).astype(np.float32)
    xy[:, :4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    want = jax_img.feature_gather(fmap, xy)
    got = image_backbone.feature_gather(_t(fmap), _t(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('raw_u8', [False, True])
def test_synthetic_frame_matches_jax(raw_u8):
    jcfg = __graft_entry__._small_config()
    tcfg = torch_config._merge(torch_config.Config(),
                               dataclasses.asdict(jcfg))
    want = jax_synthetic.make_eval_frame(7, jcfg, img_hw=(64, 128),
                                         raw_u8=raw_u8)
    got = synthetic.make_eval_frame(7, tcfg, img_hw=(64, 128),
                                    raw_u8=raw_u8)
    assert want.keys() == got.keys()
    for key in want:
        assert want[key].dtype == got[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('distance_based,nms_type', [
    (True, 'normal'), (True, 'rotate'), (False, 'normal')])
def test_proposal_layer_matches_jax(distance_based, nms_type):
    from jmodt_tpu.models.proposal import proposal_layer as jax_proposals
    from jmodt_torch.models.proposal import proposal_layer
    base = __graft_entry__._small_config()
    jcfg = dataclasses.replace(
        base, DTYPE='float32',
        RPN=dataclasses.replace(base.RPN, NMS_TYPE=nms_type),
        EVAL=dataclasses.replace(base.EVAL, RPN_NMS_THRESH=0.3,
                                 RPN_DISTANCE_BASED_PROPOSE=distance_based))
    tcfg = torch_config._merge(torch_config.Config(),
                               dataclasses.asdict(jcfg))
    rng = np.random.RandomState(6)
    n = 256
    # clusters in both distance zones (z <= 40 and 40 < z <= 80), so that
    # NMS suppresses and some keep slots stay empty
    centres = np.array([[-5, 1, 20], [6, 1, 30], [0, 1, 60]], np.float32)
    xyz = (centres[rng.randint(0, 3, n)]
           + rng.randn(n, 3).astype(np.float32) * 0.3)[None]
    scores = rng.randn(1, n).astype(np.float32)
    reg = (rng.randn(1, n, 76) * 0.1).astype(np.float32)
    want = jax_proposals(jcfg, 'EVAL', scores, reg, xyz)
    got = proposal_layer(tcfg, 'EVAL', _t(scores), _t(reg), _t(xyz))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0 < int(got.mask.sum()) < got.mask.numel()
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores))


# ------------------------------------------------- the whole detection step

@pytest.fixture(scope='module')
def small_step():
    """The JAX detection step and the port's, on the same small config,
    frame and weights; returns (jax outputs, port outputs, jax model
    outputs, port model outputs)."""
    jcfg = dataclasses.replace(__graft_entry__._small_config(),
                               DTYPE='float32')
    tcfg = torch_config._merge(torch_config.Config(),
                               dataclasses.asdict(jcfg))
    frame = jax_synthetic.make_eval_frame(3, jcfg, img_hw=(64, 128),
                                          raw_u8=True)
    pts, img, xy = frame['pts_input'], frame['img'], frame['pts_xy']
    img_f = ((img.astype(np.float32) / 255.0
              - np.array([0.485, 0.456, 0.406], np.float32))
             / np.array([0.229, 0.224, 0.225], np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointnet2, 'three_nn', _three_nn_kernel_semantics)
        jmodel = JaxPointRCNN(jcfg, mode='EVAL')
        variables = _randomize_stats(jax.jit(
            lambda k: jmodel.init(k, pts, img_f, xy, train=False))(
                jax.random.PRNGKey(0)), 9)
        jout = jax.device_get(jax_step(jcfg, jmodel)(variables, pts, img,
                                                     xy))
        jmodel_out = jax.device_get(jax.jit(
            lambda v: jmodel.apply(v, pts, img_f, xy, train=False))(
                variables))
    np_vars = jax.device_get(variables)
    tmodel = load_jax_variables(PointRCNN(tcfg, device='cpu'), np_vars,
                                device='cpu')
    tout = make_detection_step(tcfg, tmodel, device='cpu')(pts, img, xy)
    tmodel_out = tmodel(_t(pts), _t(img_f), _t(xy))
    return jout, tout, jmodel_out, tmodel_out


def test_detection_step_masks_match_jax(small_step):
    jout, tout, _, _ = small_step
    for key in ('roi_mask', 'keep', 'seg_result'):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]), err_msg=key)
    assert tout['roi_mask'].any() and tout['keep'].any()


@pytest.mark.parametrize('key', ['rois', 'pred_boxes_all', 'boxes', 'scores',
                                 'feats', 'packed'])
def test_detection_step_floats_match_jax(small_step, key):
    jout, tout, _, _ = small_step
    got, want = tout[key].numpy(), np.asarray(jout[key])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.isfinite(got).all()
    assert _rel_err(got, want) < TOL, key


@pytest.mark.parametrize('key', ['rpn_cls', 'rpn_reg', 'backbone_features',
                                 'rcnn_cls', 'rcnn_reg', 'rcnn_feat'])
def test_point_rcnn_outputs_match_jax(small_step, key):
    _, _, jm, tm = small_step
    got, want = tm[key].numpy(), np.asarray(jm[key])
    assert got.shape == want.shape
    assert _rel_err(got, want) < TOL, key


def test_detection_step_runs_in_bfloat16():
    """The default compute dtype: bf16 network, float32 geometry and
    heads; finite outputs of the float32 shapes."""
    tcfg = torch_config._merge(torch_config.Config(), dataclasses.asdict(
        dataclasses.replace(__graft_entry__._small_config(),
                            DTYPE='bfloat16')))
    frame = synthetic.make_eval_frame(5, tcfg, img_hw=(64, 128),
                                      raw_u8=True)
    from jmodt_torch.models.point_rcnn import build_detector
    model = build_detector(tcfg, device='cpu', seed=1)
    out = make_detection_step(tcfg, model, device='cpu')(
        frame['pts_input'], frame['img'], frame['pts_xy'])
    m = tcfg.EVAL.RPN_POST_NMS_TOP_N
    assert out['boxes'].shape == (1, m, 7)
    assert out['feats'].shape == (1, m, tcfg.RCNN.SA_CONFIG.MLPS[-1][-1])
    for key, val in out.items():
        if val.is_floating_point():
            assert val.dtype == torch.float32, key
            assert torch.isfinite(val).all(), key
    assert out['roi_mask'].any()


def test_load_jax_variables_is_strict(small_step):
    jcfg = dataclasses.replace(__graft_entry__._small_config(),
                               DTYPE='float32')
    tcfg = torch_config._merge(torch_config.Config(),
                               dataclasses.asdict(jcfg))
    model = PointRCNN(tcfg, device='cpu')
    sd = model.state_dict()
    # the flax tree of the same config covers every port key exactly
    bogus = {'params': {'rpn': {'extra': {'Dense_0': {
        'kernel': np.zeros((2, 2), np.float32)}}}}}
    with pytest.raises(RuntimeError, match='Unexpected key'):
        model.load_state_dict(jax_variables_to_state_dict(bogus) | sd,
                              strict=True)
    with pytest.raises(RuntimeError, match='Missing key'):
        load_jax_variables(model, {'params': {}}, device='cpu')
