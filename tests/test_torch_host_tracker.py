"""The port's host tracker against the JAX package's, on the CPU, with the
same link / se head weights (the flax heads' variables, carried by
`load_jax_variables`) and the same detections.

- Kalman and Track: numpy copies, so states are bit-equal.
- `Tracker.update` over a 6-frame sequence with births, a missed frame, a
  skipped frame, a dying track and low-score detections, for MIP and
  Hungarian assignment: track ids, the emitted rows and their order exact
  at every frame; the affinity (combined matrix, start and end scores)
  within 1e-5 of its scale (float32, summation order only).  The port
  computes the affinity at the frame's own counts, the JAX package on
  padded buckets with masks; the comparison shows the masking gives the
  same numbers.  The scene's affinities have no ties, so the assignments
  cannot flip on rounding.
"""

import jax
import numpy as np
import pytest
import torch

from jmodt_tpu.models.rcnn import CorrelationHead as JaxCorrelationHead
from jmodt_tpu.tracking import kalman as jax_kalman
from jmodt_tpu.tracking import track as jax_track
from jmodt_tpu.tracking.tracker import Tracker as JaxTracker
from jmodt_torch.models.rcnn import CorrelationHead
from jmodt_torch.tracking import Kalman, Track, Tracker
from jmodt_torch.weights import load_jax_variables

TOL = 1e-5
FEAT = 32


@pytest.fixture(autouse=True)
def fresh_track_ids():
    Track.new_id = 1
    jax_track.Track.new_id = 1
    yield


def _heads(seed=0):
    """(JAX apply, link params, se params), and the port's heads with the
    same weights."""
    head = JaxCorrelationHead(hidden=(16, 16))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ps = [head.init(k, np.zeros((1, FEAT), np.float32)) for k in (k1, k2)]
    ports = [load_jax_variables(CorrelationHead(FEAT, (16, 16)), p,
                                device='cpu') for p in ps]
    return head.apply, ps, ports


@pytest.mark.parametrize('ry', [0.1, 3.0, -3.1])
def test_kalman_matches_jax(ry):
    rng = np.random.RandomState(0)
    box = np.array([1.0, 1.6, 12.0, 1.5, 1.6, 3.9, ry])
    a, b = jax_kalman.Kalman(box.copy()), Kalman(box.copy())
    for t in range(8):
        steps = 1 + t % 3
        np.testing.assert_array_equal(a.predict(steps), b.predict(steps))
        z = box + rng.normal(0, 0.2, 7)
        z[6] += np.pi * (t == 4)                 # a flipped heading
        a.update(z.copy())
        b.update(z.copy())
        np.testing.assert_array_equal(a.get_box(), b.get_box())
    for k in ('x', 'P'):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_track_matches_jax():
    box = np.array([1.0, 1.6, 12.0, 1.5, 1.6, 3.9, 0.2], np.float32)
    feat = np.arange(FEAT, dtype=np.float32)
    a = jax_track.Track(box, 0.9, 'a', feat)
    b = Track(box, 0.9, 'a', feat)
    assert a.id == b.id == 1 and Track.new_id == jax_track.Track.new_id == 2
    for x, y in zip(a.predict(2), b.predict(2)):
        np.testing.assert_array_equal(x, y)
    a.update_with_feature(box + 0.1, feat + 1, 0.8, 'b')
    b.update_with_feature(box + 0.1, feat + 1, 0.8, 'b')
    assert (a.misses, a.hits, a.get_data()) == (b.misses, b.hits,
                                                 b.get_data())
    np.testing.assert_array_equal(a.feature, b.feature)


def _scene():
    """Six frames of (frame id, boxes, scores, feats): three cars, the
    third born at frame 2; car 1 missed at frame 3; frame 4 skipped; a
    false positive of low score at frame 1 that never returns."""
    rng = np.random.RandomState(7)
    base = rng.randn(4, FEAT).astype(np.float32)
    frames = []
    for i, fid in enumerate((0, 1, 2, 3, 5, 6)):
        boxes, scores, feats = [], [], []
        for car in range(3):
            if (car == 2 and i < 2) or (car == 1 and i == 3):
                continue
            boxes.append([car * 6.0 - 6.0 + 0.05 * i, 1.6,
                          10.0 + 0.5 * fid + 4.0 * car, 1.5, 1.6, 3.9,
                          0.1 * car])
            scores.append(0.99 - 0.01 * car - 0.002 * i)
            feats.append(base[car] + 0.05 * rng.randn(FEAT))
        if i == 1:
            boxes.append([20.0, 1.6, 40.0, 1.5, 1.6, 3.9, 1.0])
            scores.append(0.3)
            feats.append(base[3])
        boxes = np.asarray(boxes, np.float32)
        boxes += rng.normal(0, 0.02, boxes.shape).astype(np.float32)
        frames.append((fid, boxes, np.asarray(scores, np.float32),
                       np.asarray(feats, np.float32)))
    return frames


def _recording(tracker, unpad):
    seen = []
    inner = tracker._affinity

    def affinity(*args):
        out = inner(*args)
        seen.append(unpad(out, args))
        return out

    tracker._affinity = affinity
    return seen


@pytest.mark.parametrize('hungarian', [False, True],
                         ids=['mip', 'hungarian'])
def test_tracker_matches_jax(hungarian):
    apply, (lp, sp), (link, se) = _heads()
    kw = dict(t_miss=2, t_hit=0, hungarian=hungarian, score_thresh=0.5)
    a = JaxTracker(apply, apply, lp, sp, **kw)
    b = Tracker(link, se, device='cpu', **kw)
    a.reset()
    b.reset()

    def jax_unpad(out, args):
        p, d = int(np.sum(args[-2])), int(np.sum(args[-1]))
        comb, start, end = (np.asarray(x) for x in out)
        return comb[:p, :d], start[:d], end[:p]

    seen_a = _recording(a, jax_unpad)
    seen_b = _recording(b, lambda out, args: out)
    n_emitted = 0
    for fid, boxes, scores, feats in _scene():
        infos = list(range(len(scores)))
        ra = a.update(fid, boxes, scores, feats, infos)
        rb = b.update(fid, boxes, scores, feats, infos)
        assert [(t, i) for t, i, _ in ra] == [(t, i) for t, i, _ in rb]
        np.testing.assert_array_equal([s for *_, s in ra],
                                      [s for *_, s in rb])
        assert [t.id for t in a.tracks] == [t.id for t in b.tracks]
        for ta, tb in zip(a.tracks, b.tracks):
            np.testing.assert_array_equal(ta.motion_model.x,
                                          tb.motion_model.x)
            assert (ta.misses, ta.hits) == (tb.misses, tb.hits)
        n_emitted += len(rb)
    assert len(seen_a) == len(seen_b) == 5       # every frame after the first
    for x, y in zip(seen_a, seen_b):
        for want, got in zip(x, y):
            assert want.shape == got.shape
            scale = max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
        comb = np.sort(y[0].ravel())
        assert np.all(np.diff(comb) > 1e-3)      # no ties to flip
    assert n_emitted >= 10 and Track.new_id == jax_track.Track.new_id >= 4


def test_tracker_reset_restarts_ids():
    _, _, (link, se) = _heads()
    t = Tracker(link, se, device='cpu')
    fid, boxes, scores, feats = _scene()[0]
    t.update(fid, boxes, scores, feats, list(range(len(scores))))
    assert Track.new_id > 1 and t.tracks
    t.reset()
    assert Track.new_id == 1 and not t.tracks and t.frame_count == 0
    assert t.update(0, boxes[:0], scores[:0], feats[:0], []) == []


def test_affinity_runs_on_the_tracker_device(monkeypatch):
    """The heads are moved to the tracker's device, and without a card
    the tracker refuses to be built unless asked for the CPU."""
    _, _, (link, se) = _heads()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Tracker(link, se)
    Tracker(link, se, device='cpu')
    assert next(link.parameters()).device.type == 'cpu'
