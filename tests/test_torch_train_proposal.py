"""The port's train-time RoI sampling and ReID branches against the JAX
package's, on the CPU.

`jax_roi_draws` rebuilds the JAX key schedule of
`jmodt_tpu/models/proposal.py::proposal_target_layer`: `split(key, B)`,
then `split(k, 6)` a frame (fg, hard, easy ranks, rint1, rint2, jitter),
and per jitter trial t `fold_in(k_aug, t)`, its keep draw at `fold_in(tk,
0)` and RoI i's jitter at `split(fold_in(tk, 1 + i), 4)`; the port takes
those numbers as its `RoiDraws`, so both packages sample the same RoIs.
Sampled boxes, labels, masks and track ids must be equal, pooled inputs
and IoUs within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from jmodt_tpu.models import proposal as jax_proposal
from jmodt_tpu.models import rcnn as jax_rcnn
from jmodt_torch import config as torch_config
from jmodt_torch.models import proposal, rcnn
from jmodt_torch.models.rcnn import RCNN
from jmodt_torch.weights import load_jax_variables

TOL = 1e-5


def jax_roi_draws(cfg, key, b, m) -> proposal.RoiDraws:
    """The draws the JAX package's `proposal_target_layer(cfg, key, ...)`
    makes for B frames of M proposals, as the port's `RoiDraws`."""
    rc = cfg.RCNN
    r, t_max = rc.ROI_PER_IMAGE, int(rc.ROI_FG_AUG_TIMES)
    fields = {f: [] for f in proposal.RoiDraws._fields}
    for k in jax.random.split(key, b):
        k_fg, k_hard, k_easy, k_r1, k_r2, k_aug = jax.random.split(k, 6)
        for name, kk in (('rank_fg', k_fg), ('rank_hard', k_hard),
                         ('rank_easy', k_easy)):
            fields[name].append(jax.random.uniform(kk, (m,)))
        fields['rint1'].append(jax.random.randint(k_r1, (r,), 0, 1 << 30))
        fields['rint2'].append(jax.random.randint(k_r2, (r,), 0, 1 << 30))
        trials = {n: [] for n in ('aug_keep', 'aug_row', 'aug_pos',
                                  'aug_hwl', 'aug_ang')}
        lo = -0.5 if rc.REG_AUG_METHOD == 'single' else -1.0

        def jitter(kk):
            k_idx, k_pos, k_hwl, k_ang = jax.random.split(kk, 4)
            if rc.REG_AUG_METHOD == 'normal':
                pos = jax.random.normal(k_pos, (3,))
                hwl = jax.random.normal(k_hwl, (3,))
            else:
                pos = jax.random.uniform(k_pos, (3,), minval=lo, maxval=-lo)
                hwl = jax.random.uniform(k_hwl, (3,), minval=lo, maxval=-lo)
            ang = jax.random.uniform(k_ang, (1,), minval=-1.0 if
                                     rc.REG_AUG_METHOD == 'normal' else lo,
                                     maxval=1.0 if rc.REG_AUG_METHOD ==
                                     'normal' else -lo)[0]
            return jax.random.randint(k_idx, (), 0, 5), pos, hwl, ang

        for t in range(t_max):
            tk = jax.random.fold_in(k_aug, t)
            trials['aug_keep'].append(
                jax.random.uniform(jax.random.fold_in(tk, 0), (r,)))
            per = jax.vmap(lambda i: jitter(jax.random.fold_in(tk, 1 + i)))(
                jnp.arange(r))
            for n, v in zip(('aug_row', 'aug_pos', 'aug_hwl', 'aug_ang'),
                            per):
                trials[n].append(v)
        for n, v in trials.items():
            shape = {'aug_pos': (0, r, 3), 'aug_hwl': (0, r, 3)}.get(
                n, (0, r))
            fields[n].append(jnp.stack(v) if v else jnp.zeros(shape))
    out = []
    for name in proposal.RoiDraws._fields:
        arr = np.asarray(jnp.stack(fields[name]))
        if name in ('rint1', 'rint2', 'aug_row'):
            arr = arr.astype(np.int64)
        out.append(torch.from_numpy(np.array(arr)))
    return proposal.RoiDraws(*out)


def small_cfgs(**rcnn):
    """(JAX config, the port's) of the small config, float32, with RCNN
    overrides."""
    jcfg = __graft_entry__._small_config()
    jcfg = dataclasses.replace(
        jcfg, DTYPE='float32', RCNN=dataclasses.replace(jcfg.RCNN, **rcnn))
    return jcfg, torch_config._merge(torch_config.Config(),
                                     dataclasses.asdict(jcfg))


def _frames(rng, cfg, kinds, n=256, c=12):
    """RPN-side inputs of one frame per kind: 'mixed' (foreground, hard
    and easy background, more hard ones than ROI_PER_IMAGE), 'all_fg'
    (every proposal on a gt) or 'no_fg' (every proposal far from them)."""
    b, m, g = len(kinds), cfg.TRAIN.RPN_POST_NMS_TOP_N, 4
    mean = np.asarray(cfg.mean_size)
    gts = np.zeros((b, g + 2, 7), np.float32)          # two zero-padded rows
    gts[:, :g, 0] = rng.uniform(-10, 10, (b, g))
    gts[:, :g, 0] += np.arange(g) * 25.0
    gts[:, :g, 1] = 1.6
    gts[:, :g, 2] = rng.uniform(10, 30, (b, g))
    gts[:, :g, 3:6] = mean * rng.uniform(0.9, 1.1, (b, g, 3))
    gts[:, :g, 6] = rng.uniform(-np.pi, np.pi, (b, g))
    tids = np.zeros((b, g + 2), np.float32)
    tids[:, :g] = np.arange(1, g + 1)
    rois = np.zeros((b, m, 7), np.float32)
    for f, kind in enumerate(kinds):
        pick = rng.randint(0, g, m)
        base = gts[f, pick]
        # jitter magnitude per proposal: small (fg), medium (hard bg),
        # large or far (easy bg)
        if kind == 'all_fg':
            scale = np.full(m, 0.02)
        elif kind == 'no_fg':
            scale = np.full(m, 6.0)
        else:
            scale = np.concatenate([np.full(3, 0.03), np.full(10, 0.45),
                                    np.full(m - 13, 6.0)])
        jit = rng.randn(m, 7).astype(np.float32)
        rois[f] = base + jit * scale[:, None] * np.array(
            [1, 0.2, 1, 0.1, 0.1, 0.2, 0.1], np.float32)
        rois[f, :, 3:6] = np.abs(rois[f, :, 3:6])
    # points: half inside the gts' boxes, half scattered
    pts = np.zeros((b, n, 3), np.float32)
    for f in range(b):
        k = rng.randint(0, g, n // 2)
        box = gts[f, k]
        local = rng.uniform(-0.45, 0.45, (n // 2, 3)) * box[:, [4, 3, 5]]
        local[:, 1] = -(local[:, 1] + 0.45 * box[:, 3])
        c_, s_ = np.cos(box[:, 6]), np.sin(box[:, 6])
        pts[f, :n // 2, 0] = box[:, 0] + local[:, 0] * c_ + local[:, 2] * s_
        pts[f, :n // 2, 1] = box[:, 1] + local[:, 1]
        pts[f, :n // 2, 2] = box[:, 2] - local[:, 0] * s_ + local[:, 2] * c_
        pts[f, n // 2:] = rng.uniform([-20, 0, 5], [90, 2, 40], (n // 2, 3))
    feats = rng.randn(b, n, c).astype(np.float32)
    seg = (rng.rand(b, n) > 0.5).astype(np.float32)
    depth = np.linalg.norm(pts, axis=2).astype(np.float32)
    return pts, feats, seg, depth, rois, gts, tids


def _check_targets(got, want):
    for name in ('cls_label', 'reg_valid_mask', 'gt_tids'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # the jittered boxes are float arithmetic, equal within rounding
    for name in ('roi_boxes3d', 'pts_input', 'gt_of_rois', 'gt_iou',
                 'mask_score', 'max_iou'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize('aug_times,method', [(0, 'multiple'),
                                              (2, 'multiple'), (2, 'normal')])
def test_proposal_target_layer_matches_jax(aug_times, method):
    jcfg, tcfg = small_cfgs(ROI_FG_AUG_TIMES=aug_times,
                            REG_AUG_METHOD=method)
    rng = np.random.RandomState(40 + aug_times)
    kinds = ['mixed', 'all_fg', 'no_fg', 'mixed']
    args = _frames(rng, tcfg, kinds)
    key = jax.random.PRNGKey(7 + aug_times)
    want = jax_proposal.proposal_target_layer(jcfg, key, *args)
    draws = jax_roi_draws(jcfg, key, len(kinds), args[4].shape[1])
    got = proposal.proposal_target_layer(
        tcfg, draws, *(torch.from_numpy(a) for a in args))
    _check_targets(got, want)
    # every kind of frame took the branch it was made for (before jitter)
    labels = got.cls_label.reshape(len(kinds), -1).numpy()
    assert (labels[0] == 1).any() and (labels[0] == 0).any()
    assert (labels[2] <= 0).all()
    if aug_times == 0:
        assert (labels[1] == 1).all()


def test_proposal_target_features_keep_their_gradient():
    """The pooled features are a gather of rpn_features: a gradient on
    pts_input reaches them, and only at the pooled points."""
    _, tcfg = small_cfgs()
    args = [torch.from_numpy(a) for a in _frames(np.random.RandomState(3),
                                                 tcfg, ['mixed', 'all_fg'])]
    feats = args[1].requires_grad_(True)
    draws = proposal.sample_roi_draws(tcfg, 2, args[4].shape[1],
                                      torch.Generator().manual_seed(0))
    with torch.enable_grad():
        t = proposal.proposal_target_layer(tcfg, draws, *args)
        t.pts_input[..., 5:].sum().backward()
    assert feats.grad is not None and feats.grad.abs().sum() > 0
    counts = feats.grad[..., 0]                     # times each point pooled
    assert torch.equal(counts, counts.round()) and counts.max() >= 1


def test_sample_roi_draws_are_seeded_and_shaped():
    _, tcfg = small_cfgs(ROI_FG_AUG_TIMES=3)
    make = lambda s: proposal.sample_roi_draws(
        tcfg, 4, 16, torch.Generator().manual_seed(s))
    a, b, c = make(1), make(1), make(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.rank_fg, c.rank_fg)
    assert a.rank_fg.shape == (4, 16) and a.rint1.shape == (4, 8)
    assert a.aug_pos.shape == (4, 3, 8, 3) and a.aug_ang.shape == (4, 3, 8)
    assert int(a.aug_row.max()) < 5 and float(a.aug_keep.max()) < 1.0


# ---------------------------------------------------------------- ReID

@pytest.mark.parametrize('tids', [
    [3, 0, 3, 1, 2, 2, 0, 5],
    [0, 0, 0, 0, 0, 0, 0, 0],
    [4, 4, 4, 4, 4, 4, 4, 4],
    [1, 2, 3, 4, 5, 6, 7, 8],
])
def test_unique_tid_mean_features_matches_jax(tids):
    rng = np.random.RandomState(len(set(tids)))
    tids = np.asarray(tids, np.float32)
    feats = rng.randn(len(tids), 6).astype(np.float32)
    want = jax_rcnn.unique_tid_mean_features(jnp.asarray(tids),
                                             jnp.asarray(feats))
    got = rcnn.unique_tid_mean_features(torch.from_numpy(tids),
                                        torch.from_numpy(feats))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=TOL, atol=TOL)


def test_reid_matches_jax():
    """The RCNN's forward with track ids (its ReID branches over 2 frame
    pairs, one pair without a common id) against the JAX RCNN's."""
    jcfg, tcfg = small_cfgs()
    rc = jcfg.RCNN
    rng = np.random.RandomState(5)
    b, r = 4, rc.ROI_PER_IMAGE
    pts = rng.randn(b * r, rc.NUM_POINTS, 5 + 32).astype(np.float32) * 0.5
    gt_tids = np.array([[1, 1, 2, 0, 3, 0, 2, 4], [2, 1, 0, 0, 5, 5, 1, 6],
                        [7, 7, 0, 0, 0, 0, 0, 0], [0, 8, 8, 0, 0, 0, 0, 0]],
                       np.float32)
    jmod = jax_rcnn.RCNN(jcfg)
    variables = jax.jit(lambda k: jmod.init(k, pts, gt_tids))(
        jax.random.PRNGKey(0))
    want = jmod.apply(variables, pts, gt_tids)
    tmod = load_jax_variables(RCNN(tcfg), jax.device_get(variables),
                              device='cpu').eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(pts), torch.from_numpy(gt_tids))
    assert sorted(k for k in got if k.startswith('reid_')) == sorted(
        k for k in want if k.startswith('reid_'))
    for k, v in want.items():
        if k.endswith(('_mask',)) or k.startswith('reid_gt'):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    assert not got['reid_gt_link'][1].any()         # no id in common
