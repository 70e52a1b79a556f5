"""The port's losses, training-mode BatchNorm and dropout against the JAX
package's (flax / jax.numpy), on the CPU.

Losses: seeded numpy inputs with NaN rows, each loss of
`jmodt_torch/losses.py` against `jmodt_tpu/losses.py` within 1e-6
relative (a NaN where the JAX loss has one).  BatchNorm in training mode
against `flax.linen.BatchNorm(use_running_average=False)`: the output and
the updated running statistics within 1e-6 (a bfloat16 output within one
bfloat16 rounding).  Dropout: flax's dropout mask is keyed by the module
path and is not reproduced, so its rate, its 1 / (1 - p) scale and its
identity in eval mode are checked on their own.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmodt_tpu import losses as jax_losses
from jmodt_torch import losses
from jmodt_torch.models.layers import BatchNorm, HeadMLP, dropout

TOL = 1e-6


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               equal_nan=True)


def _nan_rows(x, rows):
    x = x.copy()
    x[rows] = np.nan
    return x


@pytest.fixture
def data():
    rng = np.random.RandomState(11)
    n = 64
    logits = rng.randn(n).astype(np.float32) * 3
    labels = (rng.rand(n) > 0.6).astype(np.float32)
    weights = rng.rand(n).astype(np.float32)
    mask = rng.rand(n) > 0.3
    return rng, n, logits, labels, weights, mask


@pytest.mark.parametrize('nan', [False, True])
def test_elementwise_losses_match_jax(data, nan):
    rng, n, logits, labels, weights, mask = data
    if nan:
        logits = _nan_rows(logits, [3, 17])
    t = torch.from_numpy
    _close(losses.sigmoid_cross_entropy_with_logits(t(logits), t(labels)),
           jax_losses.sigmoid_cross_entropy_with_logits(logits, labels))
    for gamma in (2.0, 0.0):
        _close(losses.sigmoid_focal_loss(t(logits), t(labels), t(weights),
                                         0.25, gamma),
               jax_losses.sigmoid_focal_loss(logits, labels, weights, 0.25,
                                             gamma))
    target = np.where(rng.rand(n) > 0.8, -1, labels).astype(np.float32)
    _close(losses.dice_loss(t(logits), t(target)),
           jax_losses.dice_loss(logits, target))
    pred = rng.randn(n, 3).astype(np.float32) * 2
    tgt = rng.randn(n, 3).astype(np.float32)
    _close(losses.smooth_l1(t(pred), t(tgt)), jax_losses.smooth_l1(pred, tgt))
    _close(losses.masked_mean(t(logits), t(mask)),
           jax_losses.masked_mean(logits, mask))
    _close(losses.masked_mean(t(logits), t(np.zeros(n, bool))),
           jax_losses.masked_mean(logits, np.zeros(n, bool)))
    k = rng.randn(n, 6).astype(np.float32)
    if nan:
        k = _nan_rows(k, [5])
    lab = rng.randint(0, 6, n).astype(np.int32)
    _close(losses.cross_entropy_int_labels(t(k), t(lab), t(mask)),
           jax_losses.cross_entropy_int_labels(k, lab, mask))


def _reg_inputs(rng, n, c, nan):
    pred = rng.randn(n, c).astype(np.float32)
    label = np.concatenate([
        rng.uniform(-3.5, 3.5, (n, 3)), rng.uniform(1.0, 4.5, (n, 3)),
        rng.uniform(-7, 7, (n, 1))], axis=1).astype(np.float32)
    fg = rng.rand(n) > 0.4
    score = rng.rand(n).astype(np.float32)
    if nan:
        pred = _nan_rows(pred, [2, 9])
    return score, pred, label, fg


@pytest.mark.parametrize('nan', [False, True])
@pytest.mark.parametrize('kw', [
    # the RPN's call
    dict(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12,
         use_cls_score=True, iou_loss_type='cls_mask_with_bin'),
    # the RCNN's call: fine heading, y offset or y bins, RoI-sized anchors
    dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9, get_ry_fine=True,
         use_cls_score=True, iou_loss_type='cls_mask_with_bin'),
    dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9, get_ry_fine=True,
         get_y_by_bin=True, iou_loss_type='raw', roi_anchor=True),
], ids=['rpn', 'rcnn', 'rcnn_y_bins_roi_anchor'])
def test_get_reg_loss_matches_jax(kw, nan):
    kw = dict(kw)
    roi_anchor = kw.pop('roi_anchor', False)
    rng = np.random.RandomState(12)
    n = 80
    bins = int(kw['loc_scope'] / kw['loc_bin_size']) * 2
    y = (int(0.5 / 0.25) * 2 * 2) if kw.get('get_y_by_bin') else 1
    c = bins * 4 + kw['num_head_bin'] * 2 + 3 + y
    score, pred, label, fg = _reg_inputs(rng, n, c, nan)
    mean = np.array([1.52563191462, 1.62856739989, 3.88311640418],
                    np.float32)
    anchor = (rng.uniform(1.0, 4.0, (n, 3)).astype(np.float32) if roi_anchor
              else mean)
    want = jax_losses.get_reg_loss(score, pred, label, fg,
                                   anchor_size=jnp.asarray(anchor), **kw)
    t = torch.from_numpy
    got = losses.get_reg_loss(t(score), t(pred), t(label), t(fg),
                              anchor_size=t(anchor), **kw)
    for name in got._fields:
        _close(getattr(got, name), getattr(want, name))
    if nan:
        assert all(np.isnan(np.asarray(v)) for v in want)


# ------------------------------------------------------------ BatchNorm

@pytest.mark.parametrize('shape', [(2, 5, 7, 6), (40, 16)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_batch_norm_training_matches_flax(shape, dtype):
    rng = np.random.RandomState(13)
    x = (rng.randn(*shape) * 3 + 1.5).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean0, 'var': var0}}
    xj = jnp.asarray(x).astype(jdt)
    want, upd = bn.apply(variables, xj, mutable=['batch_stats'])

    tbn = BatchNorm(c)
    with torch.no_grad():
        for t_, v in ((tbn.weight, scale), (tbn.bias, bias),
                      (tbn.running_mean, mean0), (tbn.running_var, var0)):
            t_.copy_(torch.from_numpy(v))
    tbn.train()
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = tbn(xt)
    assert got.dtype == tdt
    _close(tbn.running_mean, upd['batch_stats']['mean'])
    _close(tbn.running_var, upd['batch_stats']['var'])
    out_tol = TOL if dtype == 'float32' else 2.0 ** -8
    _close(got.float(), np.asarray(want.astype(jnp.float32)), out_tol)
    # back in eval mode it normalizes with the running statistics
    tbn.eval()
    with torch.no_grad():
        ev = tbn(xt)
    want_ev = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                            epsilon=1e-5, dtype=jdt).apply(
        {'params': variables['params'], 'batch_stats': upd['batch_stats']},
        xj)
    _close(ev.float(), np.asarray(want_ev.astype(jnp.float32)),
           out_tol * 10)


def test_batch_norm_training_gradient_matches_jax():
    rng = np.random.RandomState(14)
    x = rng.randn(30, 8).astype(np.float32) * 2
    cot = rng.randn(30, 8).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {'mean': np.zeros(8, np.float32), 'var': np.ones(8, np.float32)}

    def loss(p, xx):
        out, _ = bn.apply({'params': p, 'batch_stats': stats}, xx,
                          mutable=['batch_stats'])
        return jnp.sum(out * cot)

    params = {'scale': scale, 'bias': np.zeros(8, np.float32)}
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    tbn = BatchNorm(8).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
    xt = torch.from_numpy(x).requires_grad_(True)
    with torch.enable_grad():
        (tbn(xt) * torch.from_numpy(cot)).sum().backward()
    for got, want in ((xt.grad, gx), (tbn.weight.grad, gp['scale']),
                      (tbn.bias.grad, gp['bias'])):
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err <= 1e-5 * max(1.0, np.abs(np.asarray(want)).max())


# -------------------------------------------------------------- dropout

def test_dropout_rate_and_scale():
    g = torch.Generator().manual_seed(0)
    x = torch.full((400, 500), 3.0)
    out = dropout(x, 0.5, g)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(out[kept], torch.full_like(out[kept], 6.0))
    out = dropout(x, 0.2, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert torch.allclose(out[kept], torch.full_like(out[kept], 3.0 / 0.8))
    # the generator decides the mask
    a = dropout(x, 0.5, torch.Generator().manual_seed(7))
    b = dropout(x, 0.5, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)


def test_head_mlp_dropout_only_in_training():
    torch.manual_seed(0)
    head = HeadMLP(8, (32, 16), 3, dp_ratio=0.5)
    ref = HeadMLP(8, (32, 16), 3, dp_ratio=0.0)
    ref.load_state_dict(head.state_dict())
    x = torch.randn(64, 8)
    with torch.no_grad():
        head.eval()
        ref.eval()
        assert torch.equal(head(x, torch.Generator().manual_seed(1)), ref(x))
        head.train()
        ref.train()
        assert torch.equal(ref(x), ref.eval()(x))   # p = 0: no dropout
        a = head(x, torch.Generator().manual_seed(1))
        b = head(x, torch.Generator().manual_seed(1))
        c = head(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ref(x))
    # dropout follows the first hidden layer only: its mask, scaled
    h0 = head.PointwiseLayer_0(x)
    mask = torch.rand(h0.shape, generator=torch.Generator().manual_seed(1)
                      ) < 0.5
    h = torch.where(mask, h0 / 0.5, torch.zeros_like(h0))
    want = head.Dense_0(head.PointwiseLayer_1(h))
    assert torch.allclose(a, want, atol=1e-6)
