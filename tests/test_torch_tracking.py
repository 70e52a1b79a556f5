"""The port's device tracker and its affinity ops against the JAX
package's, on the CPU, on the same numpy inputs and head weights.

The JAX tracker pads its Kalman state to 16 / 8 dimensions with exact
zeros; the port keeps the real 10 / 7, and the comparisons cut the JAX
arrays down.  Tolerances: indices, ids and masks exact; floats within 1e-5
of their scale (float32, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmodt_tpu.models.rcnn import CorrelationHead as JaxCorrelationHead
from jmodt_tpu.models.rcnn import masked_bidirectional_softmax as jax_mbs
from jmodt_tpu.ops import geometry as jax_geometry
from jmodt_tpu.ops import rotated_iou as jax_iou
from jmodt_tpu.tracking import device_tracker as jdt
from jmodt_torch.models.rcnn import (CorrelationHead,
                                     masked_bidirectional_softmax)
from jmodt_torch.ops import geometry, rotated_iou
from jmodt_torch.tracking import device_tracker as tdt
from jmodt_torch.weights import jax_variables_to_state_dict, \
    load_jax_variables
from tests.test_torch_ops import _boxes3d, _rel_err, _t

TOL = 1e-5
FEAT = 32


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def _pair_boxes(seed):
    rng = np.random.RandomState(seed)
    a, b = _boxes3d(rng, 12, 3.0), _boxes3d(rng, 9, 3.0)
    b[:3] = a[:3]                                   # identical boxes
    b[3] = a[3]
    b[3, 1] += 0.7                                  # a height shift
    return a, b


# ------------------------------------------------------------ affinity ops

def test_boxes_iou3d_matches_jax():
    a, b = _pair_boxes(0)
    want = np.asarray(jax_iou.boxes_iou3d(a, b))
    got = rotated_iou.boxes_iou3d(_t(a), _t(b)).numpy()
    assert (want > 0).sum() > 10                    # real overlaps tested
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_boxes_center_dist_affinity_matches_jax():
    a, b = _pair_boxes(1)
    want = np.asarray(jax_geometry.boxes_center_dist_affinity(a, b))
    got = geometry.boxes_center_dist_affinity(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        geometry.boxes3d_to_corners3d(_t(a)).numpy(),
        np.asarray(jax_geometry.boxes3d_to_corners3d(a)), rtol=TOL,
        atol=TOL)


def test_masked_bidirectional_softmax_matches_jax():
    rng = np.random.RandomState(2)
    scores = rng.randn(7, 5).astype(np.float32) * 3
    rows = np.array([1, 1, 0, 1, 1, 0, 1], bool)
    cols = np.array([1, 0, 1, 1, 0], bool)
    want = np.asarray(jax_mbs(scores, rows, cols))
    got = masked_bidirectional_softmax(_t(scores), _t(rows), _t(cols))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    none = masked_bidirectional_softmax(_t(scores), _t(rows),
                                        torch.zeros(5, dtype=torch.bool))
    assert torch.equal(none, torch.zeros(7, 5))


def test_correlation_head_loads_flax_tree():
    """A standalone link / se head's flax tree strict-loads into the
    port's CorrelationHead and computes the same scores."""
    head = JaxCorrelationHead(hidden=(16, 24))
    params = jax.device_get(head.init(jax.random.PRNGKey(0),
                                      np.zeros((1, FEAT), np.float32)))
    assert set(params['params']) == {'mlp'}
    thead = load_jax_variables(CorrelationHead(FEAT, (16, 24)), params,
                               device='cpu')
    x = np.abs(np.random.RandomState(3).randn(4, 5, FEAT)).astype(np.float32)
    want = np.asarray(head.apply(params, x))
    assert _rel_err(thead(_t(x)).numpy(), want) < TOL
    sd = jax_variables_to_state_dict(params)
    sd.pop(next(iter(sd)))
    with pytest.raises(RuntimeError, match='Missing key'):
        CorrelationHead(FEAT, (16, 24)).load_state_dict(sd, strict=True)


# ------------------------------------------------------------------ Kalman

def _kalman_inputs(seed, t=6):
    rng = np.random.RandomState(seed)
    mean = rng.randn(t, 10).astype(np.float32) * 5
    a = rng.randn(t, 10, 10).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) + 10 * np.eye(10)).astype(np.float32)
    return mean, cov


def _pad(mean, cov):
    m16 = np.zeros((mean.shape[0], 16), np.float32)
    m16[:, :10] = mean
    c16 = np.zeros((cov.shape[0], 16, 16), np.float32)
    c16[:, :10, :10] = cov
    return m16, c16


@pytest.mark.parametrize('steps', [1, 3])
def test_kalman_predict_matches_jax(steps):
    mean, cov = _kalman_inputs(4)
    mean[:, 6] = [3.1, -3.1, 0.2, 3.14, -3.14, 1.0]   # wraps past pi
    mean[:, 7:] *= 0.5
    m16, c16 = _pad(mean, cov)
    wm, wc = jdt._kalman_predict(jnp.asarray(m16), jnp.asarray(c16),
                                 jnp.asarray(steps),
                                 jdt._make_mats())
    gm, gc = tdt._kalman_predict(_t(mean), _t(cov), torch.tensor(steps),
                                 tdt._make_mats('cpu'))
    assert _rel_err(gm.numpy(), np.asarray(wm)[:, :10]) < TOL
    assert _rel_err(gc.numpy(), np.asarray(wc)[:, :10, :10]) < TOL


def test_kalman_update_matches_jax():
    """Rows cover no correction, the flip by pi (|z - x| in (pi/2,
    3pi/2)), the 2 pi case (|z - x| >= 3pi/2 after the flip) and a row
    left alone by the mask."""
    mean, cov = _kalman_inputs(5)
    mean[:, 6] = [0.1, 0.2, 3.0, -3.0, 0.3, 1.0]
    z = mean[:, :7] + np.random.RandomState(6).randn(6, 7).astype(
        np.float32) * 0.3
    z[:, 6] = [0.3, 0.2 + np.pi, -3.0, 3.0, -2.0, 1.2]
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    m16, c16 = _pad(mean, cov)
    wm, wc = jdt._kalman_update(jnp.asarray(m16), jnp.asarray(c16),
                                jnp.asarray(z), mask, jdt._make_mats())
    gm, gc = tdt._kalman_update(_t(mean), _t(cov), _t(z), _t(mask),
                                tdt._make_mats('cpu'))
    assert _rel_err(gm.numpy(), np.asarray(wm)[:, :10]) < TOL
    assert _rel_err(gc.numpy(), np.asarray(wc)[:, :10, :10]) < TOL
    np.testing.assert_array_equal(gm.numpy()[5], mean[5])


# -------------------------------------------------------------- assignment

def _gated_affinity(seed, t, d):
    rng = np.random.RandomState(seed)
    aff = (rng.randn(t, d) * 4).astype(np.float32)
    aff[rng.rand(t, d) < 0.5] = -np.inf
    aff[: t // 4] = -np.inf                          # many gated rows
    aff[:, 0] = -np.inf                              # a gated column
    aff[t - 1, 1] = aff[t - 2, 1] = 3.0              # an exact tie
    return aff


@pytest.mark.parametrize('t,d', [(8, 4), (16, 16), (64, 16)])
def test_lap_assign_matches_jax(t, d):
    aff = _gated_affinity(t + d, t, d)
    for thresh in (0.0, 1.0):
        wt, wd = jdt._lap_assign(jnp.asarray(aff), thresh)
        gt, gd = tdt._lap_assign(_t(aff), thresh)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert (gt.numpy() >= 0).sum() > 0


@pytest.mark.parametrize('t,d', [(8, 4), (16, 16)])
def test_greedy_assign_matches_jax(t, d):
    aff = _gated_affinity(2 * t + d, t, d)
    wt, wd = jdt._greedy_assign(jnp.asarray(aff), 0.5)
    gt, gd = tdt._greedy_assign(_t(aff), 0.5)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_mip_assign_matches_jax():
    rng = np.random.RandomState(7)
    t, d = 12, 6
    combined = (rng.randn(t, d) * 5).astype(np.float32)
    pred = rng.uniform(0.3, 1.0, t).astype(np.float32)
    det = rng.uniform(0.3, 1.0, d).astype(np.float32)
    start = rng.uniform(0, 1, d).astype(np.float32)
    end = rng.uniform(0, 1, t).astype(np.float32)
    active = rng.rand(t) < 0.7
    mask = rng.rand(d) < 0.8
    args = (combined, pred, det, start, end, active, mask)
    want = jdt.mip_assign(*map(jnp.asarray, args), 100.0, 1.0)
    got = tdt.mip_assign(*map(_t, args), 100.0, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ the tracker step

def _heads():
    link = JaxCorrelationHead(hidden=(16, 16))
    se = JaxCorrelationHead(hidden=(16, 16))
    link_p = jax.device_get(link.init(jax.random.PRNGKey(0),
                                      np.zeros((1, FEAT), np.float32)))
    se_p = jax.device_get(se.init(jax.random.PRNGKey(5),
                                  np.zeros((1, FEAT), np.float32)))
    tlink = load_jax_variables(CorrelationHead(FEAT, (16, 16)), link_p,
                               device='cpu')
    tse = load_jax_variables(CorrelationHead(FEAT, (16, 16)), se_p,
                             device='cpu')
    return (link.apply, link_p, se.apply, se_p), (tlink, tse)


def _sequence(max_dets=8):
    """8 frames of 3 moving cars: car 1 is missed twice (frames 3, 4) and
    pruned, then comes back; a far car arrives with a low score (a
    tentative birth) and is then seen with a high one; frame 5 is empty;
    frame 7 is skipped (a 2-step predict); car 2 turns by pi at frame 8
    and its heading sits near +-pi throughout (orientation wrap)."""
    rng = np.random.RandomState(0)
    feats = rng.randn(4, FEAT).astype(np.float32)
    frames = []
    for t, fid in enumerate([1, 2, 3, 4, 5, 6, 8, 9]):
        boxes, scores, fs = [], [], []
        if t != 4:
            for i in range(3):
                if i == 1 and t in (2, 3):
                    continue
                ry = ([0.1, 3.1, -3.1][i] + (0.2 if t % 2 and i == 1 else 0)
                      + (3.14 if i == 2 and t == 6 else 0.0))
                boxes.append([i * 8.0 - 4.0, 1.6, 10.0 + 1.2 * fid + 3 * i,
                              1.5, 1.6, 3.9, ry])
                scores.append(0.95 - 0.01 * i)
                fs.append(feats[i] + 0.02 * t)
            if t in (1, 2, 3):
                boxes.append([30.0, 1.6, 60.0, 1.5, 1.6, 3.9, 0.0])
                scores.append(0.3 if t == 1 else 0.9)
                fs.append(feats[3])
        n = len(boxes)
        db = np.zeros((max_dets, 7), np.float32)
        ds = np.zeros(max_dets, np.float32)
        df = np.zeros((max_dets, FEAT), np.float32)
        dm = np.zeros(max_dets, bool)
        if n:
            db[:n], ds[:n], df[:n], dm[:n] = boxes, scores, fs, True
        frames.append((fid, db, ds, df, dm))
    return frames


_INT_FIELDS = ('misses', 'hits', 'tid', 'det_idx', 'next_id',
               'frame_count', 'last_frame_idx')


@pytest.mark.parametrize('assign', ['hungarian', 'greedy', 'mip'])
def test_tracker_step_matches_jax(assign):
    (link_apply, link_p, se_apply, se_p), (tlink, tse) = _heads()
    mip = assign == 'mip'
    kw = dict(score_thresh=0.85, assign=assign)
    jstep = jdt.make_device_tracker_step(
        link_apply, se_apply=se_apply if mip else None, **kw)
    tstep = tdt.make_device_tracker_step(
        tlink, se_head=tse if mip else None, device='cpu', **kw)
    params = (link_p, se_p) if mip else link_p
    jstate = jdt.init_state(16, FEAT)
    tstate = tdt.init_state(16, FEAT, device='cpu')
    births = set()
    for fid, db, ds, df, dm in _sequence():
        jstate, jout = jstep(jstate, jnp.asarray(fid), db, ds, df, dm,
                             params)
        tstate, tout = tstep(tstate, fid, db, ds, df, dm)
        for key in _INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(tstate, key).numpy(),
                np.asarray(getattr(jstate, key)), err_msg=f'{fid} {key}')
        assert _rel_err(tstate.mean.numpy(),
                        np.asarray(jstate.mean)[:, :10]) < TOL
        assert _rel_err(tstate.cov.numpy(),
                        np.asarray(jstate.cov)[:, :10, :10]) < TOL
        for key in ('feat', 'score'):
            assert _rel_err(getattr(tstate, key).numpy(),
                            np.asarray(getattr(jstate, key))) < TOL, key
        for key in ('tid', 'det_idx', 'emit'):
            np.testing.assert_array_equal(tout[key].numpy(),
                                          np.asarray(jout[key]))
        for key in ('box', 'score'):
            assert _rel_err(tout[key].numpy(), np.asarray(jout[key])) < TOL
        births.update(tstate.tid.numpy()[tstate.tid.numpy() > 0].tolist())
        if fid == 5:                                  # the empty frame
            assert not tout['emit'].any()
    assert len(births) >= 4


def test_device_tracker_pads_detections():
    (link_apply, link_p, _, _), (tlink, _) = _heads()
    want = jdt.DeviceTracker(link_apply, link_p, feat_dim=FEAT,
                             max_tracks=16, max_dets=8, score_thresh=0.85)
    got = tdt.DeviceTracker(tlink, FEAT, max_tracks=16, max_dets=8,
                            device='cpu', score_thresh=0.85)
    for fid, db, ds, df, dm in _sequence()[:4]:
        n = int(dm.sum())
        wo = want.update(fid, db[:n], ds[:n], df[:n])
        go = got.update(fid, db[:n], ds[:n], df[:n])
        for key in ('tid', 'emit', 'det_idx'):
            np.testing.assert_array_equal(go[key].numpy(),
                                          np.asarray(wo[key]))


# ---------------------------------------------------- lockstep streams (S)

def _streams():
    """3 streams of 8 lockstep frames (the frame ids of `_sequence`): 0 is
    `_sequence`; 1 is the same cars 30 m to the side, ending after 5 frames
    (padded with empty frames); 2 is 30 m to the other side with an empty
    gap at frames 3-4, so its next predict runs 3 steps while stream 0's
    runs 1."""
    base = _sequence()
    streams = []
    for s, (dx, empty) in enumerate(((0.0, ()), (30.0, (5, 6, 7)),
                                     (-30.0, (2, 3)))):
        frames = []
        for t, (fid, db, ds, df, dm) in enumerate(base):
            db, dm = db.copy(), dm.copy()
            db[:, 0] += dx
            if t in empty:
                dm[:] = False
            frames.append((fid, db, ds, df + 0.1 * s, dm))
        streams.append(frames)
    return streams


@pytest.mark.parametrize('assign', ['hungarian', 'greedy', 'mip'])
def test_batched_tracker_step_matches_jax(assign, monkeypatch):
    """S = 3 lockstep streams against the JAX package's vmapped step: every
    state field and output, every frame; the port reads the host twice a
    frame ('greedy': once), whatever S is."""
    (link_apply, link_p, se_apply, se_p), (tlink, tse) = _heads()
    mip = assign == 'mip'
    kw = dict(score_thresh=0.85, assign=assign)
    jstep = jdt.make_batched_tracker_step(
        link_apply, se_apply=se_apply if mip else None, **kw)
    tstep = tdt.make_batched_tracker_step(
        tlink, se_head=tse if mip else None, device='cpu', **kw)
    params = (link_p, se_p) if mip else link_p
    jstate = jdt.init_batched_state(3, 16, FEAT)
    tstate = tdt.init_batched_state(3, 16, FEAT, device='cpu')
    reads = []
    to_host = tdt._to_host
    monkeypatch.setattr(tdt, '_to_host',
                        lambda t: reads.append(t.shape) or to_host(t))
    streams = _streams()
    emitted = np.zeros(3, int)
    for t in range(8):
        fids, db, ds, df, dm = (np.stack(x) for x in zip(
            *(streams[s][t] for s in range(3))))
        jstate, jout = jstep(jstate, fids.astype(np.int32), db, ds, df, dm,
                             params)
        del reads[:]
        tstate, tout = tstep(tstate, fids, db, ds, df, dm)
        assert len(reads) == (1 if assign == 'greedy' else 2)
        for key in _INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(tstate, key).numpy(),
                np.asarray(getattr(jstate, key)), err_msg=f'{t} {key}')
        assert _rel_err(tstate.mean.numpy(),
                        np.asarray(jstate.mean)[..., :10]) < TOL
        assert _rel_err(tstate.cov.numpy(),
                        np.asarray(jstate.cov)[..., :10, :10]) < TOL
        for key in ('feat', 'score'):
            assert _rel_err(getattr(tstate, key).numpy(),
                            np.asarray(getattr(jstate, key))) < TOL, key
        for key in ('tid', 'det_idx', 'emit'):
            np.testing.assert_array_equal(tout[key].numpy(),
                                          np.asarray(jout[key]))
        for key in ('box', 'score'):
            assert _rel_err(tout[key].numpy(), np.asarray(jout[key])) < TOL
        emitted += tout['emit'].numpy().sum(-1)
    assert (emitted > 0).all()


def test_batched_tracker_step_matches_single_streams():
    """Each stream of the lockstep step equals the single-stream step run
    on that stream alone."""
    (_, _, _, _), (tlink, _) = _heads()
    kw = dict(score_thresh=0.85, device='cpu')
    batched = tdt.make_batched_tracker_step(tlink, **kw)
    single = tdt.make_device_tracker_step(tlink, **kw)
    streams = _streams()
    bstate = tdt.init_batched_state(3, 16, FEAT, device='cpu')
    states = [tdt.init_state(16, FEAT, device='cpu') for _ in range(3)]
    for t in range(8):
        fids, db, ds, df, dm = (np.stack(x) for x in zip(
            *(streams[s][t] for s in range(3))))
        bstate, bout = batched(bstate, fids, db, ds, df, dm)
        for s in range(3):
            states[s], out = single(states[s], *streams[s][t])
            for key in ('tid', 'det_idx', 'emit'):
                assert torch.equal(out[key], bout[key][s])
            for key in ('box', 'score'):
                assert _rel_err(out[key].numpy(), bout[key][s].numpy()) < TOL
