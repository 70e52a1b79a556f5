"""The port's training step against the JAX package's, on the CPU, with
the same weights (the port's seeded ones, exported) and the same RoI
draws (the JAX key schedule's, tests/test_torch_train_proposal.py).

- `compute_losses` and the gradients of one TRAIN forward against
  `jax.value_and_grad` of the JAX model's.  The small config in float32,
  dropout off (flax's dropout mask is not reproduced;
  tests/test_torch_train_losses.py covers dropout), REID.FG_THRESH 0 and
  lowered RCNN thresholds so that the random weights' RoIs give the ReID
  and regression terms something to differentiate; the JAX 3-NN runs its
  Pallas kernel in interpret mode (tests/test_torch_models.py says why).
  - FINETUNE (with RPN.FIXED), against JAX in float32: every loss term
    within 1e-5 of its scale, every parameter's gradient within 1e-4 of
    its own scale, and 0 where the JAX one is 0 (the frozen RPN gets
    none).
  - Full losses, against the JAX model run in float64 (`_jax_float64`):
    loss terms and the updated BatchNorm statistics within 1e-5 of scale;
    the gradient of the whole loss, and apart from it the gradient of its
    RCNN part (what the RCNN sends back into the RPN through the pooled
    features), each parameter within 3e-4 of its own scale, or of 1e-2 of
    the largest where its own is smaller.  Why float64: with train-mode
    BatchNorm at the small config's level-0 radius (0.1 m) most balls of
    a 256-point scene hold only their centre, and channels whose batch
    variance is near eps amplify rounding layer by layer, so two float32
    evaluations of this network do not agree to these bounds.  Measured
    on this batch, against the float64 run: the port's float32 loss terms
    are off by 3.2e-6 of scale and its BatchNorm statistics by 2.4e-6,
    the JAX float32 run's by 5.1e-5 and 4.6e-5 (flax's one-pass variance
    summed in XLA's order; its gradients above the floor are off by up
    to 8e-2 of their own scale).  The port's float32 gradients above the
    floor are within 1.2e-4 of their own scale (the RCNN part's within
    1.5e-4), the worst at the first two SA levels and the first fusion,
    where that rounding is amplified; hence 3e-4.  The floor: a float32
    backward resolves a gradient only to about float32's epsilon
    (1.2e-7) of the largest, and the port's gradients at the
    first level's degenerate balls (1e-9 to 3e-6 of the largest) and the
    image biases ahead of BatchNorm (exactly 0 in exact arithmetic) are
    off by up to 1.7e-7 of it; the floor allows 3e-6.
- `rpn_loss_fn` with NaN / Inf rows against the JAX one.

The optimizer, checkpoints and the entry point are in
tests/test_torch_train_loop.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import jmodt_tpu.models.backbone as jax_backbone
import jmodt_tpu.models.pointnet2 as jax_pointnet2
import jmodt_tpu.models.rcnn as jax_rcnn
import jmodt_tpu.models.rpn as jax_rpn
from jmodt_tpu.data.synthetic import make_pair_batch
from jmodt_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from jmodt_tpu.train import train_step as jax_train_step
from jmodt_torch import config as torch_config
from jmodt_torch.models.point_rcnn import PointRCNN, build_detector
from jmodt_torch.train import train_step
from jmodt_torch.weights import (export_jax_variables,
                                 jax_variables_to_state_dict,
                                 load_jax_variables)
from tests.test_torch_models import _three_nn_kernel_semantics
from tests.test_torch_train_proposal import jax_roi_draws

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# full losses, against float64: the float32 rounding that train-mode
# BatchNorm amplifies, and the backward's resolution (module docstring)
FULL_GRAD_TOL = 3e-4
GRAD_FLOOR = 1e-2
R = dataclasses.replace


def _cfgs(finetune: bool):
    jcfg = __graft_entry__._small_config()
    jcfg = R(jcfg, DTYPE='float32',
             RPN=R(jcfg.RPN, DP_RATIO=0.0, FIXED=finetune),
             RCNN=R(jcfg.RCNN, DP_RATIO=0.0, CLS_FG_THRESH=0.2,
                    REG_FG_THRESH=0.15, CLS_BG_THRESH=0.1,
                    CLS_BG_THRESH_LO=0.02),
             REID=R(jcfg.REID, FG_THRESH=0.0),
             TRAIN=R(jcfg.TRAIN, FINETUNE=finetune))
    return jcfg, torch_config._merge(torch_config.Config(),
                                     dataclasses.asdict(jcfg))


@pytest.fixture(scope='module')
def setup():
    """A batch of one frame pair and the port's seeded weights, BatchNorm
    statistics randomized, as a flax tree (`export_jax_variables`)."""
    _, tcfg = _cfgs(False)
    batch = make_pair_batch(seed=0, cfg=tcfg, num_pairs=1, img_hw=(64, 128))
    model = build_detector(tcfg, mode='TRAIN', device='cpu', seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_var'):
                buf.uniform_(0.5, 1.5, generator=g)
            else:
                buf.normal_(0.0, 0.1, generator=g)
    return batch, export_jax_variables(model)


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _jax_step(jcfg, batch, variables, key):
    """(loss terms, new batch statistics, parameter gradients of the loss,
    parameter gradients of its RCNN part) of one JAX TRAIN forward, by
    jax.vjp."""
    model = JaxPointRCNN(jcfg, mode='TRAIN')

    def losses(params):
        out, upd = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch['pts_input'], batch['img'], batch['pts_xy'],
            gt_boxes3d=batch['gt_boxes3d'], gt_tids=batch['gt_tids'],
            sample_key=key, train=True, mutable=['batch_stats'])
        loss, tb = jax_train_step.compute_losses(jcfg, out, batch)
        rcnn = tb['rcnn_loss'] * jcfg.TRAIN.RCNN_TRAIN_WEIGHT
        return (loss, rcnn), (tb, upd)

    def run(params):
        parts, vjp, (tb, upd) = jax.vjp(losses, params, has_aux=True)
        one, zero = jnp.ones_like(parts[0]), jnp.zeros_like(parts[0])
        return tb, upd, vjp((one, zero))[0], vjp((zero, one))[0]

    return jax.device_get(jax.jit(run)(variables['params']))


def _jax_float64(monkeypatch, batch, variables):
    """The JAX model computing in float64 (`compute_dtype` patched, x64 on
    while the caller runs it), on the batch and weights in float64.  Its
    random draws stay the float32 run's (uniform / normal / randint at
    their 32-bit dtypes), and the 3-NN runs on float32 coordinates, as the
    port's does."""
    for mod in (jax_rpn, jax_backbone, jax_rcnn):
        monkeypatch.setattr(mod, 'compute_dtype', lambda cfg: jnp.float64)
    monkeypatch.setattr(jax_pointnet2, 'three_nn',
                        lambda u, k: _three_nn_kernel_semantics(
                            u.astype(jnp.float32), k.astype(jnp.float32)))
    uniform, normal, randint = (jax.random.uniform, jax.random.normal,
                                jax.random.randint)
    monkeypatch.setattr(
        jax.random, 'uniform',
        lambda key, shape=(), dtype=None, minval=0.0, maxval=1.0:
        uniform(key, shape, jnp.float32, minval, maxval))
    monkeypatch.setattr(jax.random, 'normal',
                        lambda key, shape=(), dtype=None:
                        normal(key, shape, jnp.float32))
    monkeypatch.setattr(jax.random, 'randint',
                        lambda key, shape, minval, maxval, dtype=None:
                        randint(key, shape, minval, maxval, jnp.int32))

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: (np.asarray(a, np.float64)
                       if np.asarray(a).dtype == np.float32 else a), tree)

    return f64(batch), f64(variables)


def _assert_grads_match(got, want, tol, floor):
    """Every parameter's gradient within tol of max(its own scale,
    floor x the largest), and exactly 0 where the wanted one is 0.
    Returns the names whose wanted gradient is nonzero."""
    top = max(float(np.abs(w).max()) for w in want.values())
    moved = []
    for name, w in want.items():
        g = got[name]
        scale = float(np.abs(w).max())
        if scale == 0:
            assert not g.any(), name
            continue
        moved.append(name)
        err = float(np.abs(g - w).max())
        assert err <= tol * max(scale, floor * top), (name, err, scale)
    return moved


@pytest.mark.parametrize('finetune', [True, False])
def test_losses_and_grads_match_jax(monkeypatch, setup, finetune):
    """FINETUNE against JAX in float32: every loss term within 1e-5 of its
    scale, every gradient within 1e-4 of its own scale.  Full losses
    against JAX in float64: loss terms and BatchNorm statistics within
    1e-5 of scale, the gradients of the loss and of its RCNN part within
    3e-4 of each parameter's own scale, floored at 1e-2 of the largest;
    the module docstring says why."""
    batch, variables = setup
    jcfg, tcfg = _cfgs(finetune)
    key = jax.random.PRNGKey(5)
    draws = jax_roi_draws(jcfg, key, batch['pts_input'].shape[0],
                          jcfg.TRAIN.RPN_POST_NMS_TOP_N)
    if finetune:
        monkeypatch.setattr(jax_pointnet2, 'three_nn',
                            _three_nn_kernel_semantics)
        jtb, upd, jgrads, _ = _jax_step(jcfg, batch, variables, key)
    else:
        with jax.enable_x64(True):
            jtb, upd, jgrads, jrcnn = _jax_step(
                jcfg, *_jax_float64(monkeypatch, batch, variables), key)

    tmodel = load_jax_variables(PointRCNN(tcfg, mode='TRAIN'), variables,
                                device='cpu').train()
    assert tmodel.rpn.training is not finetune     # a frozen RPN stays eval
    tb_ = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    params = dict(tmodel.named_parameters())
    with torch.enable_grad():
        out = tmodel(tb_['pts_input'], tb_['img'], tb_['pts_xy'],
                     gt_boxes3d=tb_['gt_boxes3d'], gt_tids=tb_['gt_tids'],
                     draws=draws)
        loss, ttb = train_step.compute_losses(tcfg, out, tb_)
        trcnn = torch.autograd.grad(
            ttb['rcnn_loss'] * tcfg.TRAIN.RCNN_TRAIN_WEIGHT,
            list(params.values()), retain_graph=True, allow_unused=True)
        loss.backward()

    assert sorted(ttb) == sorted(jtb)
    for k, v in jtb.items():
        assert _err(ttb[k].detach(), v) <= LOSS_TOL, k
    # the terms this test differentiates are not trivial
    assert float(jtb['rcnn_loss_start']) > 0 and float(jtb['rcnn_loss']) > 0
    if not finetune:
        assert float(jtb['rpn_loss_reg']) > 0

    def as_np(tree):      # (jax_variables_to_state_dict rounds to float32)
        return {k: v.double().numpy() for k, v in
                jax_variables_to_state_dict({'params': tree}).items()}

    def grads(gs):
        return {n: (np.zeros(p.shape) if g is None else g.double().numpy())
                for (n, p), g in zip(params.items(), gs)}

    want = as_np(jgrads)
    assert sorted(params) == sorted(want)
    got = grads([p.grad for p in params.values()])
    moved = _assert_grads_match(got, want, *((GRAD_TOL, 0.0) if finetune else
                                             (FULL_GRAD_TOL, GRAD_FLOOR)))
    if finetune:
        assert all(params[n].grad is None for n in params
                   if n.startswith('rpn.'))
        assert 0 < len(moved) < len(params) // 2
        return
    assert len(moved) > len(params) // 2
    # the RCNN part alone: it reaches the RPN through the pooled features
    moved = _assert_grads_match(grads(trcnn), as_np(jrcnn), FULL_GRAD_TOL,
                                GRAD_FLOOR)
    assert any(n.startswith('rpn.') for n in moved)
    stats = jax_variables_to_state_dict({'batch_stats': upd['batch_stats']})
    sd = tmodel.state_dict()
    for name, v in stats.items():
        assert _err(sd[name], v.numpy()) <= LOSS_TOL, name


def test_loss_fns_drop_nan_rows_as_jax():
    """rpn_loss_fn with NaN / Inf rows in its inputs, against the JAX one:
    finite, and equal within 1e-6 relative."""
    jcfg, tcfg = _cfgs(False)
    b = make_pair_batch(seed=1, cfg=jcfg, num_pairs=1, img_hw=(64, 128))
    rng = np.random.RandomState(0)
    n = jcfg.RPN.NUM_POINTS
    cls = rng.randn(2, n, 1).astype(np.float32)
    reg = rng.randn(2, n, 76).astype(np.float32)
    cls[0, 3, 0] = np.nan
    reg[1, 7, 5] = np.inf
    want, wtb = jax_train_step.rpn_loss_fn(
        jcfg, cls, reg, b['rpn_cls_label'], b['rpn_reg_label'])
    got, gtb = train_step.rpn_loss_fn(
        tcfg, *(torch.from_numpy(a) for a in (
            cls, reg, b['rpn_cls_label'], b['rpn_reg_label'])))
    assert np.isfinite(float(got))
    for k, v in wtb.items():
        np.testing.assert_allclose(float(gtb[k]), float(v), rtol=1e-6,
                                   err_msg=k)
