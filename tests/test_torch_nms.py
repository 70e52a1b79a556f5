"""N1's CPU side: the batched NMS of the port (`nms_bev_batched`, its plain
version on CPU tensors), the proposal layer that calls it once a zone for
all frames, and a numpy emulation of N1's algorithm (csrc/nms.cu), all
against the JAX package: `jax.vmap(jmodt_tpu.ops.nms.nms_bev)` and
`jmodt_tpu.models.proposal.proposal_layer`.  Indices and masks exact.

The CUDA kernel itself runs only on the card (chip_smoke.py phase 18
holds it to the plain version there, its pair IoU bit for bit).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from jmodt_tpu.models.proposal import proposal_layer as jax_proposal_layer
from jmodt_tpu.ops import nms as jax_nms
from jmodt_torch import config as torch_config
from jmodt_torch.models.proposal import proposal_layer
from jmodt_torch.ops import nms, rotated_iou

CASES = ('random', 'clustered', 'duplicated', 'tied', 'all_invalid',
         'budget_capped', 'below_block')


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def _bev(rng, centres, size=(1.5, 4.5)):
    wl = rng.uniform(*size, centres.shape)
    ry = rng.uniform(-np.pi, np.pi, centres.shape[:-1] + (1,))
    return np.concatenate([centres - wl / 2, centres + wl / 2, ry],
                          -1).astype(np.float32)


def _case(name, p):
    """(boxes (P, N, 5), scores (P, N), valid (P, N) or None, max_keep,
    thresh) of one adversarial NMS problem set."""
    rng = np.random.RandomState(CASES.index(name) * 10 + p)
    valid = None
    if name == 'random':
        n, keep, thresh = 120, 40, 0.1
        boxes = _bev(rng, rng.uniform(-12, 12, (p, n, 2)))
        scores = rng.randn(p, n)
    elif name == 'clustered':                     # near-threshold overlaps
        n, keep, thresh = 160, 60, 0.5
        hubs = rng.uniform(-10, 10, (6, 2))
        boxes = _bev(rng, hubs[rng.randint(0, 6, (p, n))]
                     + rng.randn(p, n, 2) * 0.3)
        scores = rng.randn(p, n)
        valid = rng.rand(p, n) > 0.1
    elif name == 'duplicated':                    # equal boxes and scores
        n, keep, thresh = 96, 50, 0.3
        boxes = np.repeat(_bev(rng, rng.uniform(-6, 6, (p, n // 4, 2))), 4,
                          axis=1)
        scores = np.repeat(rng.randn(p, n // 4), 4, axis=1)
    elif name == 'tied':
        n, keep, thresh = 100, 40, 0.5
        boxes = _bev(rng, rng.uniform(-6, 6, (p, n, 2)))
        scores = np.round(rng.randn(p, n), 1)
    elif name == 'all_invalid':
        n, keep, thresh = 50, 10, 0.5
        boxes = _bev(rng, rng.uniform(-6, 6, (p, n, 2)))
        scores = rng.randn(p, n)
        valid = np.zeros((p, n), bool)
    elif name == 'budget_capped':
        n, keep, thresh = 90, 4, 0.1
        boxes = _bev(rng, rng.uniform(-40, 40, (p, n, 2)))
        scores = rng.randn(p, n)
    else:                                          # fewer boxes than a block
        n, keep, thresh = 5, 8, 0.5
        boxes = _bev(rng, rng.uniform(-2, 2, (p, n, 2)))
        scores = rng.randn(p, n)
        valid = rng.rand(p, n) > 0.2
    return boxes, scores.astype(np.float32), valid, keep, thresh


def _jax_nms(boxes, scores, valid, keep, thresh, rotated):
    if valid is None:
        valid = np.ones(scores.shape, bool)
    fn = jax.vmap(lambda b, s, v: jax_nms.nms_bev(
        b, s, thresh, keep, valid=v, rotated=rotated))
    idx, mask = fn(boxes, scores, valid)
    return np.asarray(idx), np.asarray(mask)


def _n1_emulation(boxes, scores, valid, keep, thresh, rotated):
    """N1's algorithm in numpy over the plain IoU: each problem's stable
    descending sort (dead candidates at -inf, last), the mask bit (i, j)
    = IoU(box_i, box_j) > thresh for sorted positions i < j (the earlier
    box first), packed in 64-bit words, then the scan: the removed bits of
    word w in lane w % 32, each lane's first free position, their minimum
    kept and its mask row ORed in, until `keep` are kept."""
    iou = rotated_iou.boxes_iou_bev if rotated else rotated_iou.boxes_iou_normal
    p, n = scores.shape
    words = -(-n // 64)
    full = (1 << 64) - 1
    keep_idx = np.zeros((p, keep), np.int32)
    keep_mask = np.zeros((p, keep), bool)
    for q in range(p):
        key = scores[q] if valid is None else np.where(valid[q], scores[q],
                                                       -np.inf)
        order = np.argsort(-key, kind='stable')
        vals = key[order]
        sb = torch.from_numpy(boxes[q][order])
        over = np.triu(iou(sb, sb).numpy() > thresh, 1)
        mask = [[sum(1 << t for t in range(64)
                     if w * 64 + t < n and over[i, w * 64 + t])
                 for w in range(words)] for i in range(n)]
        removed = [sum(1 << t for t in range(64)
                       if w * 64 + t >= n or not vals[w * 64 + t] > -np.inf)
                   for w in range(words)]
        count = 0
        while count < keep:
            firsts = []
            for lane in range(32):
                first = None
                for w in range(lane, words, 32):
                    if removed[w] != full:
                        free = ~removed[w] & full
                        first = w * 64 + (free & -free).bit_length() - 1
                        break
                firsts.append(n if first is None else first)
            i = min(firsts)
            if i == n:
                break
            keep_idx[q, count], keep_mask[q, count] = order[i], True
            count += 1
            for w in range(i // 64, words):
                removed[w] |= mask[i][w]
            removed[i // 64] |= 1 << (i % 64)
    return keep_idx, keep_mask


@pytest.mark.parametrize('rotated', [True, False])
@pytest.mark.parametrize('p', [1, 3])
@pytest.mark.parametrize('name', CASES)
def test_nms_bev_batched_matches_jax_vmap(name, p, rotated):
    boxes, scores, valid, keep, thresh = _case(name, p)
    want_i, want_m = _jax_nms(boxes, scores, valid, keep, thresh, rotated)
    got_i, got_m = nms.nms_bev_batched(
        torch.from_numpy(boxes), torch.from_numpy(scores), thresh, keep,
        None if valid is None else torch.from_numpy(valid), rotated)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    if name == 'all_invalid':
        assert not want_m.any()
    elif name == 'budget_capped':
        assert want_m.all()
    else:
        assert want_m.any()


@pytest.mark.parametrize('rotated', [True, False])
@pytest.mark.parametrize('name', CASES)
def test_n1_emulation_matches_jax_blocked_greedy(name, rotated):
    boxes, scores, valid, keep, thresh = _case(name, 3)
    want_i, want_m = _jax_nms(boxes, scores, valid, keep, thresh, rotated)
    got_i, got_m = _n1_emulation(boxes, scores, valid, keep, thresh,
                                 rotated)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_i, want_i)


def test_nms_bev_is_the_batched_call_at_one_problem():
    boxes, scores, valid, keep, thresh = _case('clustered', 1)
    one = nms.nms_bev(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                      thresh, keep, torch.from_numpy(valid[0]), True)
    batched = nms.nms_bev_batched(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), thresh, keep,
                                  torch.from_numpy(valid), True)
    for a, b in zip(one, batched):
        assert torch.equal(a, b[0])


def _proposal_inputs(rng, n):
    """Three frames: candidates in both distance zones, only in zone 1
    (zone 2 empty: the fallback to zone 1's later ranks), only in zone 2
    (zone 1 empty)."""
    zones = ([[-5, 1, 20], [6, 1, 30], [0, 1, 60]], [[-5, 1, 15], [4, 1, 30]],
             [[-5, 1, 50], [6, 1, 70]])
    xyz = []
    for centres in zones:
        c = np.array(centres, np.float32)
        xyz.append(c[rng.randint(0, len(c), n)]
                   + rng.randn(n, 3).astype(np.float32) * 0.3)
    scores = rng.randn(3, n).astype(np.float32)
    reg = (rng.randn(3, n, 76) * 0.1).astype(np.float32)
    return scores, reg, np.stack(xyz)


@pytest.mark.parametrize('nms_type', ['normal', 'rotate'])
@pytest.mark.parametrize('mode', ['EVAL', 'TRAIN'])
def test_proposal_layer_zones_match_jax(mode, nms_type):
    """The proposal layer of 3 frames in one call a zone, against the JAX
    package's vmap: an empty zone 2 takes zone 1's ranks [pre1, pre1 +
    pre2) with no branch, an empty zone 1 keeps nothing."""
    base = __graft_entry__._small_config()
    mode_cfg = dict(RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=40,
                    RPN_NMS_THRESH=0.3, RPN_DISTANCE_BASED_PROPOSE=True)
    jcfg = dataclasses.replace(
        base, DTYPE='float32',
        RPN=dataclasses.replace(base.RPN, NMS_TYPE=nms_type),
        EVAL=dataclasses.replace(base.EVAL, **mode_cfg),
        TRAIN=dataclasses.replace(base.TRAIN, **mode_cfg))
    tcfg = torch_config._merge(torch_config.Config(),
                               dataclasses.asdict(jcfg))
    scores, reg, xyz = _proposal_inputs(np.random.RandomState(8), 256)
    want = jax_proposal_layer(jcfg, mode, scores, reg, xyz)
    got = proposal_layer(tcfg, mode, torch.from_numpy(scores),
                         torch.from_numpy(reg), torch.from_numpy(xyz))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores))
    mask = got.mask.numpy()
    post1 = int(40 * 0.7)
    assert mask[0, :post1].any() and mask[0, post1:].any()
    assert mask[1, post1:].any()            # zone 2 from zone 1's ranks
    assert not mask[2, :post1].any() and mask[2, post1:].any()
