"""The port's joint detect + track step against the JAX package's, on the
CPU, at the small config in float32 with RPN.MEGA_SA.

Both run the same four frames (seeds 0-3, 64x128 uint8 images) with the
same weights: a JAX detector with randomized BatchNorm statistics and a
JAX link head, loaded into the port with `load_jax_variables`.  On the CPU
the JAX package runs its MEGA_SA levels on the fused path, the XLA twin of
its whole-level kernel, and the port runs K5's plain version; the JAX 3-NN
is routed through its Pallas kernel in interpret mode, as in
tests/test_torch_models.py.  The port runs with MEGA_SA on and off against
the same JAX output.

The lockstep step runs two streams (frames 0-2 and 1-3) at S = 2 against
the JAX package's batched step and against the port's own step on each
stream alone.  Split over devices (`devices=['cpu', 'cpu']`) at S = 4 for 3
frames, it must equal the unsplit step (tid, emit and the states' integer
fields exact, floats within 1e-4 of scale) and the JAX package's step on a
2-device mesh (within rtol and atol 1e-4, tests/test_pipeline.py's
tolerances for its sharded step).  The scan pipeline runs the four frames in a chunk of 3 and a
ragged tail of 1 against the JAX package's scan pipeline and the port's
`JointPipeline`.

Tolerances: tid and emit exact; boxes and scores within 1e-4 of their
scale (float32, summation order only).
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
from jmodt_tpu.parallel import make_mesh
from jmodt_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from jmodt_tpu.models.rcnn import CorrelationHead as JaxCorrelationHead
from jmodt_tpu.pipeline import ScanPipeline as JaxScanPipeline
from jmodt_tpu.pipeline import make_batched_joint_step as jax_batched_step
from jmodt_tpu.pipeline import make_joint_step as jax_joint_step
from jmodt_tpu.tracking.device_tracker import \
    init_batched_state as jax_init_batched_state
from jmodt_tpu.tracking.device_tracker import init_state as jax_init_state
from jmodt_torch import config as torch_config
from jmodt_torch.models.point_rcnn import PointRCNN
from jmodt_torch.models.rcnn import CorrelationHead
from jmodt_torch.pipeline import (JointPipeline, ScanPipeline,
                                  make_batched_joint_step, make_joint_step)
from jmodt_torch.tracking.device_tracker import (init_batched_state,
                                                 init_state)
from jmodt_torch.weights import load_jax_variables
from tests.test_torch_models import (_randomize_stats, _rel_err,
                                     _three_nn_kernel_semantics)

TOL = 1e-4
KW = dict(track_k=8, det_score_thresh=0.0)
MAX_TRACKS = 16


def _jax_cfg():
    base = __graft_entry__._small_config()
    return dataclasses.replace(base, DTYPE='float32',
                               RPN=dataclasses.replace(base.RPN,
                                                       MEGA_SA=True))


def _torch_cfg(mega: bool):
    jcfg = _jax_cfg()
    jcfg = dataclasses.replace(jcfg, RPN=dataclasses.replace(
        jcfg.RPN, MEGA_SA=mega))
    return torch_config._merge(torch_config.Config(),
                               dataclasses.asdict(jcfg))


@pytest.fixture(scope='module')
def joint_setup():
    """(frames, flax detector variables, flax link params, feat_dim, the
    JAX joint step's packed rows per frame)."""
    jcfg = _jax_cfg()
    frames = [jax_synthetic.make_eval_frame(s, jcfg, img_hw=(64, 128),
                                            raw_u8=True) for s in range(4)]
    f0 = frames[0]
    img_f = ((f0['img'].astype(np.float32) / 255.0
              - np.array([0.485, 0.456, 0.406], np.float32))
             / np.array([0.229, 0.224, 0.225], np.float32))
    feat_dim = jcfg.RCNN.SA_CONFIG.MLPS[-1][-1]
    head = JaxCorrelationHead(jcfg.REID.LINK_FC)
    link_p = head.init(jax.random.PRNGKey(1),
                       np.zeros((1, feat_dim), np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointnet2, 'three_nn', _three_nn_kernel_semantics)
        jmodel = JaxPointRCNN(jcfg, mode='EVAL')
        variables = _randomize_stats(jax.jit(
            lambda k: jmodel.init(k, f0['pts_input'], img_f, f0['pts_xy'],
                                  train=False))(jax.random.PRNGKey(0)), 9)
        joint = jax_joint_step(jcfg, jmodel, head.apply, **KW)
        state = jax_init_state(MAX_TRACKS, feat_dim)
        packed = []
        for i, f in enumerate(frames):
            state, p = joint(variables, link_p, state, jnp.asarray(i + 1),
                             f['pts_input'], f['img'], f['pts_xy'])
            packed.append(np.asarray(p))
        # S = 2 lockstep streams, and the scan pipeline in chunks of 3
        batched = jax_batched_step(jcfg, jmodel, head.apply, **KW)
        states = jax_init_batched_state(2, MAX_TRACKS, feat_dim)
        lockstep = []
        for i in range(3):
            pair = [frames[i], frames[i + 1]]
            states, p = batched(
                variables, link_p, states, np.full(2, i + 1, np.int32),
                *(np.concatenate([f[k] for f in pair])
                  for k in ('pts_input', 'img', 'pts_xy')))
            lockstep.append(np.asarray(p))
        scan = JaxScanPipeline(jcfg, jmodel, variables, head.apply, link_p,
                               feat_dim, chunk=3, max_tracks=MAX_TRACKS,
                               **KW)
        scanned = []
        for i, f in enumerate(frames):
            scanned.extend(scan.push(i + 1, f['pts_input'], f['img'],
                                     f['pts_xy']))
        scanned.extend(scan.flush())
    return (frames, jax.device_get(variables), jax.device_get(link_p),
            feat_dim, packed, lockstep, scanned)


def _port_parts(joint_setup, mega):
    frames, variables, link_p, feat_dim = joint_setup[:4]
    cfg = _torch_cfg(mega)
    model = load_jax_variables(PointRCNN(cfg, device='cpu'), variables,
                               device='cpu')
    head = load_jax_variables(CorrelationHead(feat_dim, cfg.REID.LINK_FC),
                              link_p, device='cpu')
    return cfg, model, head


def _check_rows(got, want):
    assert got.shape == want.shape == (MAX_TRACKS, 10)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])      # tid
    np.testing.assert_array_equal(got[:, 9], want[:, 9])      # emit
    assert _rel_err(got[:, 1:9], want[:, 1:9]) < TOL


@pytest.mark.parametrize('mega', [True, False])
def test_joint_step_matches_jax(joint_setup, mega):
    frames, _, _, feat_dim, want = joint_setup[:5]
    cfg, model, head = _port_parts(joint_setup, mega)
    joint = make_joint_step(cfg, model, head, device='cpu', **KW)
    state = init_state(MAX_TRACKS, feat_dim, device='cpu')
    for i, f in enumerate(frames):
        state, packed = joint(state, i + 1, f['pts_input'], f['img'],
                              f['pts_xy'])
        _check_rows(packed.numpy(), want[i])
    assert sum(int(p[:, 9].sum()) for p in want) > 0    # rows were emitted


def test_joint_pipeline_returns_frames_in_order(joint_setup):
    frames, _, _, feat_dim, want = joint_setup[:5]
    cfg, model, head = _port_parts(joint_setup, True)
    pipe = JointPipeline(cfg, model, head, feat_dim, max_tracks=MAX_TRACKS,
                         fetch_lag=2, device='cpu', **KW)
    results = []
    for i, f in enumerate(frames):
        r = pipe.push(i + 1, f['pts_input'], f['img'], f['pts_xy'])
        assert (r is None) == (i < 2)
        if r is not None:
            results.append(r)
    results.extend(pipe.flush())
    assert [fid for fid, _ in results] == [1, 2, 3, 4]
    for (_, rows), packed in zip(results, want):
        emitted = packed[packed[:, 9] > 0.5]
        assert [tid for tid, _, _ in rows] == emitted[:, 0].astype(
            int).tolist()
        for (_, box, score), row in zip(rows, emitted):
            assert _rel_err(box, row[1:8]) < TOL
            assert abs(score - row[8]) < TOL


def test_batched_joint_step_matches_jax_and_single_streams(joint_setup):
    """S = 2 lockstep streams: the JAX package's batched step, and the
    port's single-stream step on each stream alone."""
    frames, _, _, feat_dim, _, want, _ = joint_setup
    cfg, model, head = _port_parts(joint_setup, True)
    batched = make_batched_joint_step(cfg, model, head, device='cpu', **KW)
    joint = make_joint_step(cfg, model, head, device='cpu', **KW)
    states = init_batched_state(2, feat_dim=feat_dim, max_tracks=MAX_TRACKS,
                                device='cpu')
    singles = [init_state(MAX_TRACKS, feat_dim, device='cpu')
               for _ in range(2)]
    for i in range(3):
        pair = [frames[i], frames[i + 1]]
        states, packed = batched(
            states, np.full(2, i + 1, np.int32),
            *(np.concatenate([f[k] for f in pair])
              for k in ('pts_input', 'img', 'pts_xy')))
        assert packed.shape == (2, MAX_TRACKS, 10)
        for s, f in enumerate(pair):
            _check_rows(packed[s].numpy(), want[i][s])
            singles[s], alone = joint(singles[s], i + 1, f['pts_input'],
                                      f['img'], f['pts_xy'])
            _check_rows(packed[s].numpy(), alone.numpy())
    assert sum(int(p[..., 9].sum()) for p in want) > 0


def test_scan_pipeline_matches_jax_and_joint_pipeline(joint_setup):
    """A chunk of 3 and a ragged tail of 1 (padded by repeating the last
    frame, its pad rows dropped): the JAX package's scan pipeline and the
    port's JointPipeline give the same frames and rows."""
    frames, _, _, feat_dim, _, _, want = joint_setup
    cfg, model, head = _port_parts(joint_setup, True)
    kw = dict(max_tracks=MAX_TRACKS, device='cpu', **KW)
    scan = ScanPipeline(cfg, model, head, feat_dim, chunk=3, **kw)
    pipe = JointPipeline(cfg, model, head, feat_dim, fetch_lag=1, **kw)
    got, ref = [], []
    for i, f in enumerate(frames):
        args = (i + 1, f['pts_input'], f['img'], f['pts_xy'])
        # the first chunk is read when the next one runs: here, at flush
        assert scan.push(*args) == []
        r = pipe.push(*args)
        if r is not None:
            ref.append(r)
    got.extend(scan.flush())
    ref.extend(pipe.flush())
    assert [fid for fid, _ in got] == [fid for fid, _ in want] == [1, 2, 3, 4]
    for other in (want, ref):
        for (fid, rows), (ofid, orows) in zip(got, other):
            assert fid == ofid
            assert [r[0] for r in rows] == [r[0] for r in orows]
            for (_, box, score), (_, obox, oscore) in zip(rows, orows):
                assert _rel_err(box, obox) < TOL
                assert abs(score - oscore) < TOL
    assert sum(len(rows) for _, rows in got) > 0


SPLIT_STREAMS = 4


def _stream_inputs(frames, i):
    """Lockstep frame i of SPLIT_STREAMS streams: stream s at frame
    (i + s) mod 4."""
    pick = [frames[(i + s) % len(frames)] for s in range(SPLIT_STREAMS)]
    return (np.full(SPLIT_STREAMS, i + 1, np.int32),
            *(np.concatenate([f[k] for f in pick])
              for k in ('pts_input', 'img', 'pts_xy')))


def _concat_states(parts):
    """The per-device states of a split step as one state of all streams."""
    return parts[0]._replace(**{
        k: torch.cat([getattr(p, k) for p in parts])
        for k in parts[0]._fields if k != 'mats'})


def test_split_lockstep_matches_unsplit_and_jax_mesh(joint_setup):
    frames, variables, link_p, feat_dim = joint_setup[:4]
    jcfg = _jax_cfg()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointnet2, 'three_nn', _three_nn_kernel_semantics)
        jmodel = JaxPointRCNN(jcfg, mode='EVAL')
        head = JaxCorrelationHead(jcfg.REID.LINK_FC)
        sharded = jax_batched_step(jcfg, jmodel, head.apply,
                                   mesh=make_mesh(jax.devices()[:2]), **KW)
        jstates = jax_init_batched_state(SPLIT_STREAMS, MAX_TRACKS, feat_dim)
        jpacked = []
        for i in range(3):
            jstates, p = sharded(variables, link_p, jstates,
                                 *_stream_inputs(frames, i))
            jpacked.append(np.asarray(p))
        jstates = jax.device_get(jstates)
    cfg, model, head = _port_parts(joint_setup, True)
    devices = ['cpu', 'cpu']
    whole = make_batched_joint_step(cfg, model, head, device='cpu', **KW)
    split = make_batched_joint_step(cfg, model, head, devices=devices, **KW)
    states = init_batched_state(SPLIT_STREAMS, MAX_TRACKS, feat_dim,
                                device='cpu')
    parts = init_batched_state(SPLIT_STREAMS, MAX_TRACKS, feat_dim,
                               devices=devices)
    assert len(parts) == 2 and parts[0].tid.shape == (2, MAX_TRACKS)
    for i in range(3):
        args = _stream_inputs(frames, i)
        states, want = whole(states, *args)
        parts, got = split(parts, *args)
        assert got.shape == (SPLIT_STREAMS, MAX_TRACKS, 10)
        for s in range(SPLIT_STREAMS):
            _check_rows(got[s].numpy(), want[s].numpy())
        np.testing.assert_allclose(got.numpy(), jpacked[i], rtol=1e-4,
                                   atol=1e-4)
    assert sum(int(p[..., 9].sum()) for p in jpacked) > 0
    joined = _concat_states(parts)
    for k in joined._fields:
        if k == 'mats':
            continue
        got, want = getattr(joined, k).numpy(), getattr(states, k).numpy()
        if got.dtype.kind == 'f':
            assert _rel_err(got, want) < TOL, k
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
        jax_v = np.asarray(getattr(jstates, k))
        if k in ('mean', 'cov'):          # JAX pads the 10-dim state to 16
            jax_v = (jax_v[..., :10] if k == 'mean'
                     else jax_v[..., :10, :10])
        np.testing.assert_allclose(got, jax_v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
