"""The arithmetic of the redesigned K1, K2, K3 and K4 (jmodt_torch/csrc/
fps.cuh, fps.cu, three_nn.cu, grouped_mlp.cuh), emulated on the CPU, and
the wrappers' launch plans, K5's among them.

The CUDA kernels run only on the card, where chip_smoke.py holds them
against their plain versions.  Here their order of reduction and rounding
is emulated with numpy and torch on the CPU:

- K1: per-thread first maxima over a thread's consecutive points, the
  lowest lane and then the lowest warp holding the maximum, then the
  cluster's (value, index) reduction over the blocks.  It must give indices
  exactly equal to `farthest_point_sample_plain` and to the JAX package's
  Pallas kernel (interpret mode), on random clouds and on clouds with many
  exact ties, across block boundaries too.
- K2: W warps a cloud, thread q of the cloud's 32 W holding the points
  q + 32 W k; each lane's first maximum by a balanced tree over k, the
  warp's by the redux.sync pair (the largest value bits, then the
  smallest index among the lanes holding them), then the W warps' by
  (bits, index) through their slots.  It must give indices exactly equal
  to `farthest_point_sample_plain` and to the JAX package's batched Pallas
  kernel (interpret mode) on lattice clouds (many ties) and on clouds
  whose duplicated points lie in other lanes and warps, at the RCNN's
  shapes and others, for every W.
- K4: layers 2..L as 3xTF32 tensor-core products (hi = x rounded to TF32 on
  its bits, lo = x - hi, read by the tensor core truncated to TF32; a_lo
  w_hi + a_hi w_lo + a_hi w_hi in float32).  At the main path's widths and
  on folded weights of seeded modules it must stay within K4_TOL / 10 of
  the output's scale of a float64 evaluation, while one TF32 pass misses
  K4_TOL: the reason for the split.
- K3: each query's known set split over L lanes (lane j takes the points
  k with k % L == j), a strict `<` top-3 insertion per lane in index
  order, then a butterfly merge of the lanes' sorted triples by (distance,
  index).  It must give indices and distances exactly equal to
  `three_nn_plain` and to the JAX package's Pallas kernel (interpret
  mode), on clouds whose equal distances fall in different slices.
- K5: the plan of its FPS and consumer grids, and the order of the
  consumer grid's work tickets, in which every wait is on the FPS or on an
  earlier ticket (sa_level.cu).
"""

import numpy as np
import pytest
import torch

from jmodt_tpu.ops.pallas.fps import (farthest_point_sample_batched_pallas,
                                     farthest_point_sample_pallas)
from jmodt_tpu.ops.pallas.three_nn import three_nn_pallas
from jmodt_torch import config as torch_config
from jmodt_torch.models.point_rcnn import init_weights
from jmodt_torch.models.pointnet2 import SAModuleMSG
from jmodt_torch.ops import fused_sa, interpolate, sa_level, sampling

# chip_smoke.py's tolerance for K4 and K5 against their plain versions
K4_TOL = 1e-4


# ------------------------------------------------------------- K1 (FPS)

def emulate_k1(xyz: np.ndarray, npoint: int, plan) -> np.ndarray:
    """K1 on one cloud (N, 3) float32 with plan (blocks, threads, points a
    thread), in fps.cuh's order: returns (npoint,) int32."""
    csize, threads, ppt = plan
    n = xyz.shape[0]
    total = csize * threads * ppt
    assert total >= n > total - threads * ppt
    pts = np.zeros((total, 3), np.float32)
    pts[:n] = xyz
    md = np.zeros(total, np.float32)
    md[:n] = np.float32(1e10)          # points past N stay at 0
    shape = (csize, threads // 32, 32, ppt)
    first = np.arange(total).reshape(shape)[..., 0]
    out = np.zeros(npoint, np.int32)
    p = pts[0]
    for t in range(1, npoint):
        d = pts - p
        dist = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        md = np.minimum(md, dist)
        v = md.reshape(shape)
        k = v.argmax(-1)                                   # first maximum
        tv = np.take_along_axis(v, k[..., None], -1)[..., 0]
        ti = first + k
        # warp, then block: the lowest lane holding the largest value bits
        lane = tv.view(np.uint32).argmax(-1)[..., None]
        wv = np.take_along_axis(tv, lane, -1)[..., 0]
        wi = np.take_along_axis(ti, lane, -1)[..., 0]
        warp = wv.view(np.uint32).argmax(-1)[..., None]
        bv = np.take_along_axis(wv, warp, -1)[..., 0].view(np.uint32)
        bi = np.take_along_axis(wi, warp, -1)[..., 0]
        # cluster: the largest value, then the smallest index
        out[t] = bi[bv == bv.max()].min()
        p = pts[out[t]]
    return out


def _random_cloud(n):
    rng = np.random.RandomState(n)
    span = np.array([60.0, 4.0, 70.0], np.float32)
    return rng.rand(n, 3).astype(np.float32) * span


def _lattice_cloud():
    """16 x 8 x 16 points on a 0.5 m grid: many exact ties of min-distance,
    whose smallest index often lies in another block than the others."""
    g = np.stack(np.meshgrid(np.arange(16), np.arange(8), np.arange(16),
                             indexing='ij'), -1).reshape(-1, 3)
    return (g * 0.5).astype(np.float32)


def _duplicated_cloud():
    """512 points four times over: every copy of a point ties with it, and
    at 4+ blocks each copy lies in another block."""
    base = np.random.RandomState(5).randn(512, 3).astype(np.float32) * 3
    return np.concatenate([base] * 4)


CLOUDS = {'random': _random_cloud(2048), 'lattice': _lattice_cloud(),
          'duplicated': _duplicated_cloud()}


@pytest.mark.parametrize('plan', [(4, 128, 4), (8, 128, 2), (8, 256, 1),
                                  (4, 512, 1), (2, 128, 8)])
@pytest.mark.parametrize('cloud', sorted(CLOUDS))
def test_k1_reduction_matches_plain_and_pallas(cloud, plan):
    xyz = CLOUDS[cloud]
    npoint = 512
    got = emulate_k1(xyz, npoint, plan)
    plain = sampling.farthest_point_sample_plain(
        torch.from_numpy(xyz)[None], npoint).numpy()[0]
    np.testing.assert_array_equal(got, plain)
    pallas = np.asarray(farthest_point_sample_pallas(
        xyz[None], npoint, interpret=True))[0]
    np.testing.assert_array_equal(got, pallas)


def test_k1_ties_cross_block_boundaries():
    """The duplicated cloud's ties are between blocks: the winner is always
    the first copy, in block 0 of 4."""
    got = emulate_k1(CLOUDS['duplicated'], 300, (4, 128, 4))
    assert (got < 512).all()
    assert len(set(got.tolist())) == 300


# ----------------------------------------------------- K2 (batched FPS)

def _k2_lane_first_max(v: np.ndarray):
    """A lane's first maximum over its points (last axis, ascending index)
    by fps.cu's balanced tree: at each level the right half is taken only
    when strictly larger.  Returns (value, k)."""
    v = v.copy()
    kk = np.broadcast_to(np.arange(v.shape[-1]), v.shape).copy()
    s = 1
    while s < v.shape[-1]:
        for k in range(0, v.shape[-1] - s, 2 * s):
            take = v[..., k + s] > v[..., k]
            v[..., k] = np.where(take, v[..., k + s], v[..., k])
            kk[..., k] = np.where(take, kk[..., k + s], kk[..., k])
        s *= 2
    return v[..., 0], kk[..., 0]


def _redux_pair(bits: np.ndarray, idx: np.ndarray):
    """The warp argmax of fps.cu over the last axis (32 lanes):
    __reduce_max_sync of the value bits, then __reduce_min_sync of the
    indices of the lanes holding that maximum."""
    top = bits.max(-1)
    win = np.where(bits == top[..., None], idx, np.uint32(0xffffffff))
    return top, win.min(-1)


def emulate_k2(xyz: np.ndarray, npoint: int, warps: int) -> np.ndarray:
    """K2 on clouds (B, N, 3) float32 with `warps` warps a cloud, in
    fps.cu's order: returns (B, npoint) int32."""
    b, n, _ = xyz.shape
    t_ = 32 * warps
    ppt = 1
    while t_ * ppt < n:
        ppt *= 2
    total = t_ * ppt
    pts = np.zeros((b, total, 3), np.float32)
    pts[:, :n] = xyz
    md = np.zeros((b, total), np.float32)
    md[:, :n] = np.float32(1e10)         # points past N stay at 0
    out = np.zeros((b, npoint), np.int32)
    p = pts[:, 0]
    for t in range(1, npoint):
        d = pts - p[:, None]
        dist = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        md = np.minimum(md, dist)
        # point q + T k is thread q's k-th: (B, T, PPT)
        v, k = _k2_lane_first_max(md.reshape(b, ppt, t_).transpose(0, 2, 1))
        idx = (np.arange(t_) + t_ * k).astype(np.uint32)       # (B, T)
        top, win = _redux_pair(v.view(np.uint32).reshape(b, warps, 32),
                               idx.reshape(b, warps, 32))
        best_v, best_i = top[:, 0], win[:, 0]                   # warp 0
        for w in range(1, warps):           # each thread's slot reduction
            take = (top[:, w] > best_v) | ((top[:, w] == best_v)
                                           & (win[:, w] < best_i))
            best_v = np.where(take, top[:, w], best_v)
            best_i = np.where(take, win[:, w], best_i)
        out[:, t] = best_i
        p = pts[np.arange(b), best_i]
    return out


def _k2_clouds(b: int, n: int) -> np.ndarray:
    """(B, N, 3) float32: cloud j is a lattice (many exact ties), a cloud
    whose every point has copies at random other positions (so other
    lanes and warps), or a random one, by j % 3."""
    rng = np.random.RandomState(1000 * b + n)
    grid = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(16),
                                indexing='ij'), -1).reshape(-1, 3)
    out = np.empty((b, n, 3), np.float32)
    for j in range(b):
        if j % 3 == 0:
            out[j] = grid[rng.permutation(len(grid))[:n]] * 0.5
        elif j % 3 == 1:
            base = rng.randn(-(-n // 3), 3).astype(np.float32) * 2
            out[j] = base[rng.permutation(n) % len(base)]
        else:
            out[j] = rng.rand(n, 3).astype(np.float32) * [6.0, 2.0, 8.0]
    return out


def _k2_npoint(n: int) -> int:
    """The RCNN's steps at its shapes (512 -> 128, 128 -> 32), else N / 2
    up to 48: past the duplicated clouds' distinct points, so their
    min-distances tie at 0."""
    return {512: 128, 128: 32}.get(n, min(n // 2, 48))


@pytest.mark.parametrize('b', [2, 100, 400])
@pytest.mark.parametrize('n', [33, 128, 500, 512, 1024])
def test_k2_matches_plain_and_pallas(n, b):
    xyz = _k2_clouds(b, n)
    npoint = _k2_npoint(n)
    plain = sampling.farthest_point_sample_plain(torch.from_numpy(xyz),
                                                 npoint).numpy()
    for warps in (1, 2, 4):
        np.testing.assert_array_equal(emulate_k2(xyz, npoint, warps), plain,
                                      err_msg=f'{warps} warps a cloud')
    pallas = np.asarray(farthest_point_sample_batched_pallas(
        xyz, npoint, interpret=True))
    np.testing.assert_array_equal(plain, pallas)


def test_k2_ties_cross_lanes_and_warps():
    """Every point of the duplicated cloud has a copy in another lane or
    warp; once the distinct points are taken, every min-distance is 0 and
    each step must take the smallest index left."""
    base = np.random.RandomState(2).randn(40, 3).astype(np.float32)
    xyz = np.concatenate([base] * 8)[None]                  # N = 320
    got = emulate_k2(xyz, 60, 4)
    assert (got[0, :40] < 40).all() and len(set(got[0, :40])) == 40
    np.testing.assert_array_equal(got, sampling.farthest_point_sample_plain(
        torch.from_numpy(xyz), 60).numpy())


def test_k2_redux_pair_is_the_first_argmax():
    """The redux.sync pair over 32 lanes, each holding its own first
    maximum, gives numpy's first argmax over all the points of the lanes,
    on values with many ties (0 among them)."""
    rng = np.random.RandomState(3)
    for ppt in (1, 4, 16):
        vals = rng.randint(0, 4, (2000, ppt, 32)).astype(np.float32)
        index = np.arange(32 * ppt).reshape(ppt, 32)            # q + 32 k
        v, k = _k2_lane_first_max(vals.transpose(0, 2, 1))
        idx = (np.arange(32) + 32 * k).astype(np.uint32)
        _, win = _redux_pair(v.view(np.uint32), idx)
        flat = np.zeros((2000, 32 * ppt), np.float32)
        flat[:, index.reshape(-1)] = vals.reshape(2000, -1)
        np.testing.assert_array_equal(win, flat.argmax(-1))


# ---------------------------------------------------- K4 (3xTF32 split)

def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 on its bits: add half of the dropped 13 bits'
    range, then mask them (to nearest, ties away from zero)."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(
        torch.int32).view(torch.float32)


def _trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 bits the tensor core reads from a float32: the low 13
    mantissa bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _rna_tf32(x)
    return hi, _trunc_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """grouped_mlp.cuh's product: (a_lo w_hi + a_hi w_lo) + a_hi w_hi, each
    TF32 product exact in float32, sums in float32."""
    (ah, al), (wh, wl) = _split(a), _split(w)
    return (al @ wh + ah @ wl) + ah @ wh


def mm_tf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One TF32 pass, both operands rounded to nearest."""
    return _rna_tf32(a) @ _rna_tf32(w)


def _mlp_max(h, layers, s, mm):
    for w, b in layers:
        h = torch.relu(mm(h, w) + b)
    return h.view(-1, s, h.shape[-1]).amax(1)


def _sa_cases():
    """(name, folded layers, S) of every K4 MLP on the main path: RCNN sa_0
    and sa_1 and each scale of RPN levels 1-3 (K5's MLP phase), from
    SAModuleMSG modules built at the default config's widths and seeded."""
    cfg = torch_config.Config()
    rpn, rcnn = cfg.RPN.SA_CONFIG, cfg.RCNN.SA_CONFIG
    cases = []
    cin = 0
    for k in range(4):
        if k > 0:
            sa = SAModuleMSG(rpn.NPOINTS[k], rpn.RADIUS[k], rpn.NSAMPLE[k],
                             rpn.MLPS[k], cin=cin)
            init_weights(sa, k)
            for i, (mlp, s) in enumerate(zip(sa._mlps(), rpn.NSAMPLE[k])):
                cases.append((f'rpn_l{k}_scale{i}',
                              fused_sa.fold_pointwise_mlp(mlp), s))
        cin = sum(m[-1] for m in rpn.MLPS[k])
    cin = cfg.RCNN.XYZ_UP_LAYER[-1]
    for k in range(2):
        sa = SAModuleMSG(rcnn.NPOINTS[k], (rcnn.RADIUS[k],),
                         (rcnn.NSAMPLE[k],), (rcnn.MLPS[k],), cin=cin)
        init_weights(sa, 10 + k)
        cases.append((f'rcnn_sa{k}', fused_sa.fold_pointwise_mlp(sa.mlp_0),
                      rcnn.NSAMPLE[k]))
        cin = rcnn.MLPS[k][-1]
    return cases


with torch.no_grad():
    SA_CASES = _sa_cases()


@pytest.mark.parametrize('name,layers,s', SA_CASES,
                         ids=[c[0] for c in SA_CASES])
def test_k4_split_keeps_float32_accuracy(name, layers, s):
    (w1, b1), rest = layers[0], layers[1:]
    rng = np.random.RandomState(len(name))
    centres = 32
    catf = torch.from_numpy(rng.randn(centres * s, w1.shape[0]).astype(
        np.float32))
    h1 = torch.relu(catf @ w1 + b1)       # K4's layer-1 input, float32
    want = _mlp_max(h1.double(), [(w.double(), b.double()) for w, b in rest],
                    s, torch.matmul)
    scale = max(1.0, float(want.abs().max()))
    split = float((_mlp_max(h1, rest, s, mm_3xtf32) - want).abs().max())
    single = float((_mlp_max(h1, rest, s, mm_tf32) - want).abs().max())
    assert split / scale < K4_TOL / 10, (name, split / scale)
    assert single / scale > K4_TOL, (name, single / scale)


def test_tf32_rounding_on_the_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11)], dtype=torch.float32)
    hi = _rna_tf32(x)
    assert hi[0] == 1.0 and hi[1] == 1.0 + 2 ** -10   # a tie: away from 0
    assert hi[2] == 1.0 + 2 ** -9 and hi[3] == -(1.0 + 2 ** -10)
    hi, lo = _split(x)
    assert torch.equal(hi + lo, x)      # these inputs split exactly
    y = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        np.float32))
    hi, lo = _split(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert float(((hi.double() + lo.double() - y.double()).abs()
                  / y.double().abs()).max()) < 2 ** -20


# ---------------------------------------------------------- launch plans

MAIN_PATH_FPS = [          # (N, K1's plan on an H100, which placed 16)
    (16384, (16, 128, 8)),   # RPN level 0, any number of streams
    (4096, (4, 128, 8)),     # level 1 on the detection step; K5 L1's FPS
    (1024, (1, 128, 8)),     # level 2
    (256, (1, 128, 2)),      # level 3
]


@pytest.mark.parametrize('n,plan', MAIN_PATH_FPS)
def test_fps_launch_plan_main_path(n, plan):
    assert sampling.fps_launch_plan(n) == plan
    blocks, threads, ppt = plan
    chunk = threads * ppt
    assert threads % 32 == 0 and ppt in (1, 2, 4, 8)
    assert blocks * chunk >= n > (blocks - 1) * chunk   # no empty block


@pytest.mark.parametrize('max_cluster,plan', [(8, (8, 256, 8)),
                                              (4, (4, 512, 8)),
                                              (2, (2, 1024, 8))])
def test_fps_launch_plan_smaller_cluster(max_cluster, plan):
    """A card that places fewer than 16 blocks a cluster gets wider blocks
    at level 0."""
    assert sampling.fps_launch_plan(16384, max_cluster) == plan


def test_fps_launch_plan_limits():
    assert sampling.fps_launch_plan(sampling.FPS_MAX_POINTS) == (16, 1024, 8)
    with pytest.raises(ValueError, match='at most'):
        sampling.fps_launch_plan(sampling.FPS_MAX_POINTS + 1)
    with pytest.raises(ValueError, match='at most'):
        sampling.fps_launch_plan(16384, 1)
    assert sampling.fps_launch_plan(5) == (1, 32, 1)


MAIN_PATH_K4 = [   # (what, B, M, S, widths, grid with column split, passes)
    ('rcnn_sa0', 100, 128, 64, [128, 128, 128], (128, 100, 1), (1, 1)),
    ('rcnn_sa1', 100, 32, 64, [128, 128, 256], (32, 100, 1), (1, 2)),
    ('rcnn_sa0_s4', 400, 128, 64, [128, 128, 128], (128, 400, 1), (1, 1)),
    ('rpn_l1_0', 1, 1024, 16, [64, 64, 128], (256, 1, 1), (1, 1)),
    ('rpn_l1_1', 1, 1024, 32, [64, 96, 128], (512, 1, 1), (1, 1)),
    ('rpn_l2_0', 1, 256, 16, [128, 196, 256], (64, 1, 2), (2, 2)),
    ('rpn_l2_1', 1, 256, 32, [128, 196, 256], (128, 1, 1), (2, 2)),
    ('rpn_l3_0', 1, 64, 16, [256, 256, 512], (16, 1, 4), (2, 4)),
    ('rpn_l3_1', 1, 64, 32, [256, 384, 512], (32, 1, 4), (3, 4)),
]


@pytest.mark.parametrize('what,b,m,s,widths,grid,passes', MAIN_PATH_K4,
                         ids=[c[0] for c in MAIN_PATH_K4])
def test_k4_launch_plan_main_path(what, b, m, s, widths, grid, passes):
    plan = fused_sa.k4_launch_plan(b, m, s, widths)
    assert plan.rows == 64 and plan.centres == 64 // s
    assert plan.grid == grid and plan.passes == passes
    assert plan.col_split == grid[2]
    # the split never leaves a block without a column pass of its own
    share = -(-passes[-1] // plan.col_split)
    assert (plan.col_split - 1) * share < passes[-1]
    assert plan.smem <= 232448
    assert plan.smem == fused_sa._k4_smem_bytes(s, widths)


@pytest.mark.parametrize('s,widths,match', [
    (64, [128, 130], 'multiples of 4'),
    (12, [16, 16], 'S a multiple of 4 dividing'),
    (16, [16], 'layers'),
    (4, [1024, 1024, 1024], 'shared memory'),
])
def test_k4_launch_plan_refuses(s, widths, match):
    with pytest.raises(ValueError, match=match):
        fused_sa.k4_launch_plan(1, 64, s, widths)


MAIN_PATH_K2 = [   # (B, N, plan): RCNN sa_0 / sa_1 at S = 1 and S = 4
    (100, 512, (4, 1, 4)),
    (100, 128, (1, 4, 4)),
    (400, 512, (1, 4, 16)),
    (400, 128, (1, 4, 4)),
]
# an H100 SM: 2048 threads, 32 blocks, 227 KB of shared memory a block
# and 228 KB an SM (1 KB of it reserved a block)
_SM_THREADS, _SM_BLOCKS, _SM_SMEM = 2048, 32, 233472


def _k2_blocks_per_sm(warps, n):
    clouds = 4 // warps
    smem = 16 * clouds * n + 16 * 2 * warps * clouds + 1024
    return min(_SM_THREADS // 128, _SM_BLOCKS, _SM_SMEM // smem)


@pytest.mark.parametrize('b,n,plan', MAIN_PATH_K2)
def test_fps_batched_launch_plan_main_path(b, n, plan):
    assert sampling.fps_batched_launch_plan(b, n) == plan
    warps, clouds, ppt = plan
    assert warps * clouds == sampling.K2_BLOCK_WARPS
    assert 32 * warps * ppt >= n > 32 * warps * ppt // 2
    # every plan the wrapper could take at these shapes (the sweep's
    # 1, 2 and 4 warps a cloud) runs in one wave on the card
    for w in (1, 2, 4):
        blocks = -(-b // (4 // w))
        assert blocks <= sampling.K2_SMS * _k2_blocks_per_sm(w, n), w


def test_fps_batched_launch_plan_limits():
    assert sampling.fps_batched_launch_plan(2, 1024) == (4, 1, 8)
    assert sampling.fps_batched_launch_plan(200, 1024) == (1, 4, 32)
    assert sampling.fps_batched_launch_plan(2, 1) == (1, 4, 1)
    with pytest.raises(ValueError, match='points a cloud'):
        sampling.fps_batched_launch_plan(2, 1025)
    with pytest.raises(ValueError, match='points a cloud'):
        sampling.fps_batched_launch_plan(2, 0)
    with pytest.raises(ValueError, match='a cloud'):
        sampling.fps_batched_launch_plan(0, 512)


# ------------------------------------------------------- K3 (three-NN)

def _insert(d, i, dn, jn):
    """One strict `<` insertion of candidates (dn, jn) into sorted triples
    d, i (..., 3), where the candidate's index is above all held ones."""
    d, i = d.copy(), i.copy()
    c3, c2, c1 = dn < d[..., 2], dn < d[..., 1], dn < d[..., 0]
    d[..., 2] = np.where(c2, d[..., 1], np.where(c3, dn, d[..., 2]))
    i[..., 2] = np.where(c2, i[..., 1], np.where(c3, jn, i[..., 2]))
    d[..., 1] = np.where(c1, d[..., 0], np.where(c2, dn, d[..., 1]))
    i[..., 1] = np.where(c1, i[..., 0], np.where(c2, jn, i[..., 1]))
    d[..., 0] = np.where(c1, dn, d[..., 0])
    i[..., 0] = np.where(c1, jn, i[..., 0])
    return d, i


def _merge(xd, xi, yd, yi):
    """three_nn.cu's merge of two sorted triples: the three smallest by
    (distance, index), popped from the heads in turn."""
    out_d, out_i = np.empty_like(xd), np.empty_like(xi)
    pos_x = np.zeros(xd.shape[:-1], np.int64)
    pos_y = np.zeros(xd.shape[:-1], np.int64)
    for r in range(3):
        hx = np.take_along_axis(xd, pos_x[..., None], -1)[..., 0]
        hxi = np.take_along_axis(xi, pos_x[..., None], -1)[..., 0]
        hy = np.take_along_axis(yd, pos_y[..., None], -1)[..., 0]
        hyi = np.take_along_axis(yi, pos_y[..., None], -1)[..., 0]
        take_y = (hy < hx) | ((hy == hx) & (hyi < hxi))
        out_d[..., r] = np.where(take_y, hy, hx)
        out_i[..., r] = np.where(take_y, hyi, hxi)
        pos_y = pos_y + take_y
        pos_x = pos_x + ~take_y
    return out_d, out_i


def emulate_k3(unknown: np.ndarray, known: np.ndarray, lanes: int):
    """K3 on one cloud, (N, 3) queries and (M, 3) known float32, with
    `lanes` lanes a query, in three_nn.cu's order.  Returns the squared
    distances (N, 3) before the kernel's square root, and idx (N, 3)
    int32."""
    n, m = unknown.shape[0], known.shape[0]
    d = np.full((n, lanes, 3), np.inf, np.float32)
    i = np.full((n, lanes, 3), np.iinfo(np.int32).max, np.int64)
    for base in range(0, m, lanes):        # lane j's next point: base + j
        k = base + np.arange(lanes)
        live = k < m
        p = known[np.minimum(k, m - 1)]
        diff = p[None] - unknown[:, None]
        dn = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        dn = np.where(live[None], dn, np.float32(np.inf))  # inf: no insert
        d, i = _insert(d, i, dn, np.broadcast_to(k, dn.shape))
    off = 1
    while off < lanes:                     # XOR butterfly over the lanes
        partner = np.arange(lanes) ^ off
        d, i = _merge(d, i, d[:, partner], i[:, partner])
        off *= 2
    assert (d == d[:, :1]).all() and (i == i[:, :1]).all()
    return d[:, 0], i[:, 0].astype(np.int32)


def _k3_clouds():
    """(queries, known) pairs whose equal distances lie in different lane
    slices: a lattice queried at the centres of its cells (8 known points
    at one distance, 1 apart in index within a row), and 251 known points
    four times over (copies 251 apart: another slice for every L > 1)."""
    g = np.stack(np.meshgrid(np.arange(16), np.arange(8), np.arange(8),
                             indexing='ij'), -1).reshape(-1, 3)
    lattice = (g * 0.5).astype(np.float32)
    rng = np.random.RandomState(7)
    cells = lattice[rng.choice(len(lattice), 256, replace=False)] + 0.25
    base = rng.randn(251, 3).astype(np.float32) * 2
    dup = np.concatenate([base] * 4)
    near = base[rng.randint(0, 251, 256)] + rng.randn(256, 3).astype(
        np.float32) * 0.3
    near[:16] = base[:16]                  # queries on known points: 0 ties
    rand_u = rng.rand(256, 3).astype(np.float32) * 20
    rand_k = rng.rand(1500, 3).astype(np.float32) * 20    # 2 tiles
    return {'lattice': (cells.astype(np.float32), lattice),
            'duplicated': (near, dup), 'random': (rand_u, rand_k)}


K3_CLOUDS = _k3_clouds()


@pytest.mark.parametrize('lanes', [1, 2, 8, 16, 32])
@pytest.mark.parametrize('cloud', sorted(K3_CLOUDS))
def test_k3_split_merge_matches_plain_and_pallas(cloud, lanes):
    """Indices equal; squared distances equal to the plain version's bits
    (compared after the same square root: torch's on the CPU is not always
    the correctly rounded one that the kernel's sqrtf and numpy compute)
    and to the Pallas kernel's within float32 rounding."""
    u, k = K3_CLOUDS[cloud]
    d2, i = emulate_k3(u, k, lanes)
    dp, ip = interpolate.three_nn_plain(torch.from_numpy(u)[None],
                                        torch.from_numpy(k)[None])
    np.testing.assert_array_equal(i, ip.numpy()[0])
    np.testing.assert_array_equal(torch.sqrt(torch.from_numpy(d2)).numpy(),
                                  dp.numpy()[0])
    dj, ij = three_nn_pallas(u[None], k[None], interpret=True)
    np.testing.assert_array_equal(i, np.asarray(ij)[0])
    np.testing.assert_allclose(np.sqrt(d2), np.asarray(dj)[0], rtol=1e-6,
                               atol=0)


def test_k3_ties_cross_slices():
    """The clouds do hold ties that the split puts in different slices,
    and the merge gives them to the lower index."""
    u, k = K3_CLOUDS['duplicated']
    d, i = emulate_k3(u[:16], k, 4)
    assert (d[:, 0] == 0).all() and (i[:, 0] == np.arange(16)).all()
    assert (i[:, 1] == np.arange(16) + 251).all()      # the copy, slice 3
    u, k = K3_CLOUDS['lattice']
    d, i = emulate_k3(u, k, 8)
    tied = d[:, 0] == d[:, 2]        # inside the lattice: 8 corners equal
    assert tied.mean() > 0.5
    assert (np.diff(i[tied], axis=1) > 0).all()        # lowest indices


MAIN_PATH_K3 = [   # (B, N queries, M known, lanes, queries a thread,
                   #  threads a block, blocks over N)
    (1, 16384, 4096, 16, 4, 256, 256),   # FP level 0 (the finest)
    (1, 4096, 1024, 32, 2, 256, 256),
    (1, 1024, 256, 32, 1, 128, 256),
    (1, 256, 64, 32, 1, 64, 128),
    (4, 16384, 4096, 4, 4, 256, 64),     # lockstep streams, S = 4
    (4, 4096, 1024, 16, 4, 256, 64),
    (4, 1024, 256, 32, 2, 256, 64),
    (4, 256, 64, 32, 1, 128, 64),
]


@pytest.mark.parametrize('b,n,m,lanes,q,threads,blocks', MAIN_PATH_K3)
def test_three_nn_launch_plan_main_path(b, n, m, lanes, q, threads, blocks):
    plan = interpolate.three_nn_launch_plan(b, n, m)
    assert plan == (lanes, q, threads, (blocks, b))
    per_block = threads // lanes * q
    assert blocks * per_block >= n > (blocks - 1) * per_block
    assert m >= 2 * lanes                      # a lane holds 2+ points
    # the grid covers every SM where 64-thread blocks can
    assert blocks * b >= min(132, b * n * lanes // (64 * q))
    threads_total = blocks * b * threads
    assert threads_total >= interpolate.K3_TARGET_THREADS or (
        lanes == 32 and q == 1) or threads_total * q >= b * n * lanes


def test_three_nn_launch_plan_limits():
    assert interpolate.three_nn_launch_plan(1, 5, 3) == (1, 1, 64, (1, 1))
    assert interpolate.three_nn_launch_plan(1, 100, 8).lanes == 4
    with pytest.raises(ValueError, match='at least 3'):
        interpolate.three_nn_launch_plan(1, 16, 2)
    with pytest.raises(ValueError, match='queries'):
        interpolate.three_nn_launch_plan(1, 0, 16)


# ------------------------------------------------ K5 (whole SA level)

def _k5_levels():
    """(level, N, M, nsamples, widths per scale) of RPN levels 1-3 at the
    default config (K5's calls on the main path)."""
    sa = torch_config.Config().RPN.SA_CONFIG
    out, cin = [], sum(m[-1] for m in sa.MLPS[0])
    for k in (1, 2, 3):
        out.append((k, sa.NPOINTS[k - 1], sa.NPOINTS[k], sa.NSAMPLE[k],
                    [[3 + cin, *mlp] for mlp in sa.MLPS[k]]))
        cin = sum(m[-1] for m in sa.MLPS[k])
    return out


K5_LEVELS = {lv[0]: lv[1:] for lv in _k5_levels()}

MAIN_PATH_K5 = [   # (level, B, chunk, chunks, consumers, blocks an SM,
                   #  col splits, MLP units a chunk per scale, tickets)
    (1, 1, 64, 16, 256, 2, (1, 1), (16, 32), 1408),
    (2, 1, 16, 16, 131, 1, (1, 1), (4, 8), 480),
    (3, 1, 16, 4, 131, 1, (2, 2), (8, 16), 232),
    (1, 4, 64, 16, 232, 2, (1, 1), (16, 32), 5632),
    (2, 4, 16, 16, 128, 1, (1, 1), (4, 8), 1920),
    (3, 4, 16, 4, 128, 1, (1, 1), (4, 8), 736),
]


def k5_ticket(plan, b, nsamples, t):
    """sa_level.cu's meaning of ticket t: ('table', scale, tile), ('query',
    cloud, chunk, unit) or ('mlp', cloud, chunk, scale, unit)."""
    if t < plan.table_tiles:
        return ('table', t)
    group = plan.query_units + sum(plan.mlp_units)
    g, r = divmod(t - plan.table_tiles, group)
    k, cloud = divmod(g, b)
    if r < plan.query_units:
        return ('query', cloud, k, r)
    r -= plan.query_units
    for s, units in enumerate(plan.mlp_units):
        if r < units:
            return ('mlp', cloud, k, s, r)
        r -= units
    raise AssertionError(t)


@pytest.mark.parametrize(
    'level,b,chunk,chunks,consumers,per_sm,splits,units,tickets',
    MAIN_PATH_K5, ids=[f'L{c[0]}_B{c[1]}' for c in MAIN_PATH_K5])
def test_k5_launch_plan_main_path(level, b, chunk, chunks, consumers, per_sm,
                                  splits, units, tickets):
    n, m, nsamples, widths = K5_LEVELS[level]
    plan = sa_level.k5_launch_plan(b, n, m, nsamples, widths)
    assert plan.fps == sampling.fps_launch_plan(n)     # K1's plan, as is
    assert (plan.chunk, plan.chunks, plan.consumers, plan.per_sm) == (
        chunk, chunks, consumers, per_sm)
    assert (plan.col_splits, plan.mlp_units, plan.tickets) == (splits, units,
                                                               tickets)
    # chunks tile the centres in whole MLP blocks and query blocks
    assert chunk * (chunks - 1) < m <= chunk * chunks
    assert all(chunk % (64 // s) == 0 for s in nsamples)
    assert chunk % 8 == 0 and plan.query_units == chunk // 8
    # the consumers fill the SMs beside the FPS clusters, two an SM only
    # where half an SM's shared memory holds every scale's MLP
    assert plan.consumers / per_sm + b * plan.fps[0] <= 132
    assert (per_sm == 2) == (max(*plan.smem, 12 * n) <= 233472 // 2 - 2048)
    # every scale's MLP units in the one grid, split together where the
    # real blocks of all scales then still fit the consumers
    real = [b * m // (64 // s) * z for s, z in zip(nsamples, splits)]
    assert max(splits) == 1 or sum(real) <= plan.consumers
    assert max(splits) == max(plan.col_splits)
    assert plan.tickets == plan.table_tiles + b * chunks * (
        plan.query_units + sum(plan.mlp_units))
    assert plan.counters == 2 + b * chunks
    assert all(sm <= 232448 for sm in plan.smem)


@pytest.mark.parametrize('level,b', [(1, 1), (3, 1), (2, 4)])
def test_k5_tickets_wait_only_on_earlier_work(level, b):
    """Every MLP unit comes after all table tiles and after its chunk's
    query units; a query unit waits only on the FPS.  So a block that
    waits, waits for the FPS (all resident) or for a ticket that a running
    block already holds: the consumer grid cannot deadlock."""
    n, m, nsamples, widths = K5_LEVELS[level]
    plan = sa_level.k5_launch_plan(b, n, m, nsamples, widths)
    seen_query, tables, last_table = {}, 0, -1
    for t in range(plan.tickets):
        kind = k5_ticket(plan, b, nsamples, t)
        if kind[0] == 'table':
            tables += 1
            last_table = t
        elif kind[0] == 'query':
            seen_query[kind[1:3]] = seen_query.get(kind[1:3], 0) + 1
        else:
            assert tables == plan.table_tiles and last_table < t
            assert seen_query.get(kind[1:3]) == plan.query_units
    assert len(seen_query) == b * plan.chunks


@pytest.mark.parametrize('change,match', [
    (dict(npoint=5000), 'npoint'),
    (dict(n=19300, npoint=64), 'at most'),
    (dict(nsamples=(16, 12)), 'nsample'),
    (dict(nsamples=(16, 128)), 'nsample'),
    (dict(nsamples=(16,) * 5, widths=[[99, 64, 64]] * 5), 'scales'),
    (dict(widths=[[99, 64], [99, 64, 96]]), 'layers'),
    (dict(widths=[[99] + [64] * 6, [99, 64, 96]]), 'layers'),
    (dict(widths=[[99, 64, 66], [99, 64, 96]]), 'multiples of 4'),
    (dict(nsamples=(4, 32), widths=[[99, 1024, 1024, 1024], [99, 64, 96]]),
     'shared memory'),
])
def test_k5_launch_plan_refuses(change, match):
    args = dict(b=1, n=4096, npoint=1024, nsamples=(16, 32),
                widths=[[99, 16, 16, 32], [99, 32, 32, 64]])
    sa_level.k5_launch_plan(**args)
    with pytest.raises(ValueError, match=match):
        sa_level.k5_launch_plan(**(args | change))
