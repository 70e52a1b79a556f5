"""Data-parallel training (`jmodt_torch/parallel/mesh.py`) on the CPU: two
ranks over gloo, each spawned with one torch thread and a `file://`
rendezvous under the test's temporary directory, take the step that one
process takes on the global batch.

The small config in float32 with the settings of
tests/test_torch_train_step.py (dropout off, REID.FG_THRESH 0, lowered RCNN
thresholds), weights exported from the port's seeded model with randomized
BatchNorm statistics and loaded with `weights.load_jax_variables`, and a
batch of 2 pairs from `make_pair_batch`, one pair a rank, numpy seed 3.
Seed 0's pairs leave the link head a zero gradient, so its check would
compare nothing.  In seeds 1 and 2 the TRAIN proposal layer's top 16 cut
through proposals whose scores tie within one float32 ulp (distant points
whose random-weight RPN outputs saturate alike): the two packages round
those scores apart and keep different boxes, an order of ties and not a
difference of function (ROADMAP §3 parity notes).

- Against the port's one-process step (also on one thread): every loss
  term and grad_norm, every BatchNorm running statistic and every
  parameter after the step within 1e-5 of scale, and the ranks' parameters
  bit-equal.  The exception is a parameter element whose gradient is
  float32 noise, at most 1e-6 of the largest gradient (the link head's
  output bias, whose exact gradient is 0, and under full losses elements
  that train-mode BatchNorm leaves without signal): Adam's first step
  moves such an element by up to one learning rate in the direction of
  the noise's sign, so its value after the step is not determined by the
  function; its gradient must lie under that bound in both runs.
- Against the JAX package's unsharded step on the same global batch with
  the JAX RoI draws (tests/test_torch_train_proposal.py::jax_roi_draws).
  Finetune: JAX `make_train_step` with its optax chain: loss terms within
  1e-5 of scale, each gradient within 1e-4 of its own scale (the link
  bias: both within 1e-6 of the largest gradient), each trained parameter
  after the step within 1e-5 of scale and the frozen ones unchanged (the
  tolerances of tests/test_torch_train_step.py and
  tests/test_torch_train_kitti.py).  Full losses: the JAX model in float64,
  as tests/test_torch_train_step.py holds the one-process step: loss terms
  and BatchNorm statistics within 1e-5, gradients within 3e-4 of their
  own scale floored at 1e-2 of the largest.
- The ranks' foreground counts differ, and the mean of the loss terms of
  each rank's rows taken alone misses the global ones.
- `make_loader`'s rows for each of two ranks, concatenated, are the
  one-process batches bit for bit at workers 0; at workers 2 every rank
  draws the one-process order.
- `python -m jmodt_torch.train --multihost` under torchrun (2 CPU ranks)
  writes the checkpoint the one-process CLI writes, and one tensorboard
  event file; the trainer's tensorboard scalars read back equal the
  step's own.
- The CLI stops with a message on a batch that does not split, on a
  world that does not divide into `--points_parallel` groups and on
  `--multihost` outside torchrun.
"""

import dataclasses
import os
import struct
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jmodt_tpu.models.pointnet2 as jax_pointnet2
from jmodt_tpu.data.synthetic import make_pair_batch
from jmodt_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from jmodt_tpu.train import train_step as jax_train_step
from jmodt_torch.config import small_config
from jmodt_torch.models import layers
from jmodt_torch.models.point_rcnn import PointRCNN, build_detector
from jmodt_torch.parallel import mesh
from jmodt_torch.train import __main__ as train_main
from jmodt_torch.train import data_parallel, train_step, trainer
from jmodt_torch.weights import (export_jax_variables,
                                 jax_variables_to_state_dict,
                                 load_jax_variables)
from tests.test_torch_kitti_data import _assert_samples_equal
from tests.test_torch_models import _three_nn_kernel_semantics
from tests.test_torch_train_kitti import (NOISE_TOL, SHIFT_FREE, _datasets,
                                          converted)  # noqa: F401
from tests.test_torch_train_proposal import jax_roi_draws
from tests.test_torch_train_step import (FULL_GRAD_TOL, GRAD_FLOOR, GRAD_TOL,
                                         LOSS_TOL, _assert_grads_match,
                                         _cfgs, _err, _jax_float64,
                                         _jax_step)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 2
PAIRS = 2                   # a global batch: one pair a rank
BATCH_SEED = 3
DP_TOL = 1e-5
R = dataclasses.replace


def _variables(tcfg):
    """The port's seeded weights with randomized BatchNorm statistics, as a
    flax tree."""
    model = build_detector(tcfg, mode='TRAIN', device='cpu', seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_var'):
                buf.uniform_(0.5, 1.5, generator=g)
            else:
                buf.normal_(0.0, 0.1, generator=g)
    return export_jax_variables(model)


def _one_process(*args, **kw):
    """`run_steps` in this process, on one torch thread like a rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return data_parallel.run_steps('cpu', *args, **kw)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def all_runs(tmp_path_factory):
    """finetune -> the runs of `_runs`, each made once."""
    made = {}

    def get(finetune):
        if finetune not in made:
            made[finetune] = _runs(finetune, tmp_path_factory.mktemp('dp'))
        return made[finetune]

    return get


@pytest.fixture(params=[True, False], ids=['finetune', 'full'])
def runs(request, all_runs):
    return all_runs(request.param)


def _runs(finetune, base):
    """The one-process step and the ranks' step on one global batch with
    the JAX draws, and what made them."""
    jcfg, tcfg = _cfgs(finetune)
    batch = make_pair_batch(seed=BATCH_SEED, cfg=jcfg, num_pairs=PAIRS,
                            img_hw=(64, 128))
    variables = _variables(tcfg)
    state = load_jax_variables(PointRCNN(tcfg, mode='TRAIN'), variables,
                               device='cpu').state_dict()
    key = jax.random.PRNGKey(5)
    sample_key = jax.random.split(jax.random.fold_in(key, 0))[1]
    draws = jax_roi_draws(jcfg, sample_key, 2 * PAIRS,
                          jcfg.TRAIN.RPN_POST_NMS_TOP_N)
    one = _one_process(tcfg, state, [batch], str(base / 'one'),
                       draws=[draws])
    ranks = data_parallel.on_ranks(RANKS, tcfg, state, [batch],
                                   str(base / 'ranks'), device='cpu',
                                   draws=[draws], threads=1)
    return dict(finetune=finetune, jcfg=jcfg, tcfg=tcfg, batch=batch,
                variables=variables, state=state, one=one, ranks=ranks,
                draws=draws, key=key, sample_key=sample_key, base=base)


def _noise(grads):
    """{name: mask of the elements whose gradient is float32 noise}."""
    top = max(float(g.abs().max()) for g in grads.values() if g is not None)
    return {k: g.abs() <= NOISE_TOL * top for k, g in grads.items()
            if g is not None}


def _check_params(got_state, want_state, noise, tol):
    """Every parameter and buffer within `tol` of scale, but the noise
    elements of `noise`."""
    for name, want in want_state.items():
        got = got_state[name].double()
        want = want.double()
        scale = max(float(want.abs().max()), 1.0)
        diff = (got - want).abs()
        if name in noise:
            diff = torch.where(noise[name], torch.zeros_like(diff), diff)
        assert float(diff.max()) <= tol * scale, (name, float(diff.max()))


def test_two_ranks_take_the_one_process_step(runs):
    one, ranks = runs['one'], runs['ranks']
    want = one['steps'][0]['tb']
    for r in ranks:
        got = r['steps'][0]['tb']
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert _err(got[k], v) <= DP_TOL, (k, got[k], v)
        assert r['steps'][0]['collectives'] > 0
    assert want['loss'] > 0 and want['grad_norm'] > 0
    if not runs['finetune']:
        assert want['rpn_loss_reg'] > 0
    noise = _noise(one['grads'])
    for grads in (one['grads'], ranks[0]['grads']):
        g = grads[SHIFT_FREE]
        top = max(float(x.abs().max()) for x in grads.values()
                  if x is not None)
        assert float(g.abs().max()) <= NOISE_TOL * top
    _check_params(ranks[0]['state'], one['state'], noise, DP_TOL)
    # the BatchNorm statistics moved (full losses) or stayed (finetune)
    moved = [k for k in one['state'] if 'running' in k and not torch.equal(
        one['state'][k], runs['state'][k])]
    assert bool(moved) is not runs['finetune']
    for k, v in ranks[0]['state'].items():
        assert torch.equal(v, ranks[1]['state'][k]), k
    # every rank's gradients are the summed ones
    for k, g in ranks[0]['grads'].items():
        assert (g is None) == (ranks[1]['grads'][k] is None), k
        assert g is None or torch.equal(g, ranks[1]['grads'][k]), k


def _batch_norm_float64(self, x):
    """`BatchNorm._batch_norm` with the sums of x and x^2 in float64: the
    one-process step's statistics rounded otherwise."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = xf.double().mean(axes)
    var = torch.clamp((xf.double() ** 2).mean(axes) - mean * mean,
                      min=0.0).float()
    mean = mean.float()
    self.updates += 1
    with torch.no_grad():
        self.running_mean.mul_(layers.BN_MOMENTUM).add_(
            (1 - layers.BN_MOMENTUM) * mean)
        self.running_var.mul_(layers.BN_MOMENTUM).add_(
            (1 - layers.BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + layers.BN_EPS) * self.weight
    return ((xf - mean) * mul + self.bias).to(x.dtype)


def _state_errs(got_state, want_state, noise):
    """{name: the largest error of scale of each parameter and buffer},
    the noise elements of `noise` aside."""
    errs = {}
    for name, want in want_state.items():
        diff = (got_state[name].double() - want.double()).abs()
        if name in noise:
            diff = torch.where(noise[name], torch.zeros_like(diff), diff)
        errs[name] = float(diff.max()) / max(float(want.abs().max()), 1.0)
    return errs


def test_dropout_and_batchnorm_in_every_head(tmp_path, monkeypatch):
    """Full losses with dropout 0.5 in the RPN and RCNN heads (the ReID
    heads take RCNN.DP_RATIO) and BatchNorm in the RCNN and the ReID
    heads: the ranks draw the one process's masks (rank 1's ReID heads
    after moving past rank 0's pair), sum the RCNN's statistics over the
    batch and keep each pair's ReID statistics its own, so the loss
    terms, grad_norm, BatchNorm statistics and parameters (noise elements
    aside) stay within 1e-5 of scale of the one process's, or within
    twice the gap that the one process's own float32 statistics make.

    That control is the one-process step with its BatchNorm sums in
    float64.  BatchNorm on the heads' few rows has channels whose variance
    is near eps, which amplify the statistics' rounding: on this batch the
    control moves grad_norm by 3.1e-5 of scale and the se head's second
    running variance by 2.1e-5, and the ranks' float32 sums, taken in
    another order, by 4.0e-5 and 3.1e-5; all else of either stays within
    1e-5."""
    _, tcfg = _cfgs(False)
    tcfg = R(tcfg, RPN=R(tcfg.RPN, DP_RATIO=0.5),
             RCNN=R(tcfg.RCNN, DP_RATIO=0.5, USE_BN=True),
             REID=R(tcfg.REID, USE_BN=True))
    batch = make_pair_batch(seed=BATCH_SEED, cfg=tcfg, num_pairs=PAIRS,
                            img_hw=(64, 128))
    state = build_detector(tcfg, mode='TRAIN', device='cpu',
                           seed=0).state_dict()
    assert any(k.startswith('rcnn.link_layer') and 'BatchNorm' in k
               for k in state)
    one = _one_process(tcfg, state, [batch], str(tmp_path / 'one'))
    ranks = data_parallel.on_ranks(RANKS, tcfg, state, [batch],
                                   str(tmp_path / 'ranks'), device='cpu',
                                   threads=1)
    with monkeypatch.context() as m:
        m.setattr(layers.BatchNorm, '_batch_norm', _batch_norm_float64)
        one64 = _one_process(tcfg, state, [batch], str(tmp_path / 'one64'))
    want = one['steps'][0]['tb']
    assert want['rcnn_loss_link'] > 0 and want['rpn_loss_reg'] > 0
    for k, v in want.items():
        rounding = _err(one64['steps'][0]['tb'][k], v)
        assert _err(ranks[1]['steps'][0]['tb'][k], v) <= max(
            DP_TOL, 2 * rounding), (k, rounding)
    noise = _noise(one['grads'])
    rounding = _state_errs(one64['state'], one['state'], noise)
    for k, e in _state_errs(ranks[1]['state'], one['state'], noise).items():
        assert e <= max(DP_TOL, 2 * rounding[k]), (k, e, rounding[k])
    for k, v in ranks[0]['state'].items():
        assert torch.equal(v, ranks[1]['state'][k]), k


def test_unequal_foreground_counts(all_runs):
    """Full losses: the ranks' rows hold different numbers of foreground
    points; the 2-rank terms are the global ones, and the mean of
    each rank's rows' own terms misses them."""
    runs = all_runs(False)
    batch, draws = runs['batch'], runs['draws']
    locals_ = []
    for part in range(RANKS):
        shard = mesh.shard_batch(batch, part, RANKS)
        rows = slice(2 * part, 2 * part + 2)
        alone = _one_process(
            runs['tcfg'], runs['state'], [shard],
            str(runs['base'] / f'alone{part}'),
            draws=[type(draws)(*(t[rows] for t in draws))])
        locals_.append(alone['steps'][0]['tb'])
    fg = [t['rpn_fg_sum'] for t in locals_]
    assert fg[0] != fg[1] and min(fg) > 0
    glob = runs['ranks'][0]['steps'][0]['tb']
    assert glob['rpn_fg_sum'] == sum(fg)
    for k in ('rpn_loss_cls', 'rpn_loss_reg', 'rcnn_loss_reg', 'loss'):
        mean = sum(t[k] for t in locals_) / RANKS
        assert _err(mean, glob[k]) > 100 * DP_TOL, k
        assert _err(glob[k], runs['one']['steps'][0]['tb'][k]) <= DP_TOL, k


def _jax_finetune_step(jcfg, batch, variables, key):
    """JAX `make_train_step` with its optimizer chain behind a transform
    that keeps the gradients as its state: (loss terms, new params, the
    gradients)."""
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(record, jax_train_step.make_optimizer(
        jcfg, variables['params'], 1))
    step = jax.jit(jax_train_step.make_train_step(
        jcfg, JaxPointRCNN(jcfg, mode='TRAIN'), tx))
    state = jax_train_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables['params'],
        batch_stats=variables['batch_stats'],
        opt_state=tx.init(variables['params']))
    state, tb = jax.device_get(step(state, batch, key))
    return tb, state.params, state.opt_state[0]


def _flat(tree):
    return {k: v.double().numpy() for k, v in
            jax_variables_to_state_dict({'params': tree}).items()}


def test_two_ranks_match_the_jax_step(runs, monkeypatch):
    jcfg, batch, variables = runs['jcfg'], runs['batch'], runs['variables']
    rank = runs['ranks'][0]
    got_tb = rank['steps'][0]['tb']
    if runs['finetune']:
        monkeypatch.setattr(jax_pointnet2, 'three_nn',
                            _three_nn_kernel_semantics)
        jtb, jparams, jgrads = _jax_finetune_step(jcfg, batch, variables,
                                                  runs['key'])
    else:
        with jax.enable_x64(True):
            jtb, upd, jgrads, _ = _jax_step(
                jcfg, *_jax_float64(monkeypatch, batch, variables),
                runs['sample_key'])
    assert sorted(got_tb) == sorted(set(jtb) | {'grad_norm'})
    for k, v in jtb.items():
        assert _err(got_tb[k], v) <= LOSS_TOL, k
    want = _flat(jgrads)
    got = {n: (np.zeros(want[n].shape) if g is None else g.double().numpy())
           for n, g in rank['grads'].items()}
    if not runs['finetune']:
        _assert_grads_match(got, want, FULL_GRAD_TOL, GRAD_FLOOR)
        stats = jax_variables_to_state_dict(
            {'batch_stats': upd['batch_stats']})
        for name, v in stats.items():
            assert _err(rank['state'][name], v.numpy()) <= LOSS_TOL, name
        return
    top = max(float(np.abs(w).max()) for w in want.values())
    for g in (got.pop(SHIFT_FREE), want.pop(SHIFT_FREE)):
        assert float(np.abs(g).max()) <= NOISE_TOL * top
    moved = _assert_grads_match(got, want, GRAD_TOL, 0.0)
    assert any('link_layer' in n for n in moved)
    trains = train_step.trainable_mask(runs['tcfg'], build_detector(
        runs['tcfg'], mode='TRAIN', device='cpu'))
    noise = _noise({k: torch.from_numpy(v) for k, v in _flat(jgrads).items()})
    after = {k: torch.from_numpy(v) for k, v in _flat(jparams).items()}
    start = {k: v.double() for k, v in runs['state'].items() if k in after}
    frozen = [k for k in after if not trains[k]]
    for k in frozen:
        assert torch.equal(after[k], start[k]), k
        assert torch.equal(rank['state'][k].double(), start[k]), k
    _check_params({k: rank['state'][k] for k in after}, after, noise,
                  LOSS_TOL)


# ------------------------------------------------------------ the loader

@pytest.mark.parametrize('shuffle', [True, False])
def test_loader_rank_rows_are_the_one_process_batch(converted, shuffle):
    """At workers 0 (augmentation on, so the dataset draws from its random
    state), each rank's rows of two epochs, concatenated, are the
    one-process batches bit for bit."""
    jcfg, tcfg = _cfgs(True)
    tcfg = R(tcfg, AUG_DATA=True)
    sets = [_datasets(converted, jcfg, tcfg, seed=3)[1]
            for _ in range(RANKS + 1)]
    whole = trainer.make_loader(sets[0], PAIRS, shuffle=shuffle, seed=7)
    parts = [trainer.make_loader(sets[1 + r], PAIRS, shuffle=shuffle, seed=7,
                                 part=r, parts=RANKS) for r in range(RANKS)]
    for _ in range(2):
        batches = list(whole())
        assert len(batches) == 2
        for want, *got in zip(batches, *(p() for p in parts)):
            assert [len(g['sample_id']) for g in got] == [2] * RANKS
            _assert_samples_equal(
                {k: np.concatenate([g[k] for g in got]) for k in want},
                want)


def test_loader_workers_draw_one_order(converted):
    """With worker processes every rank takes its pairs of the
    one-process order."""
    ds = _datasets(converted, *_cfgs(True), seed=3)[1]
    ids = [[b['sample_id'].tolist() for b in trainer.make_loader(
        ds, PAIRS, num_workers=2, seed=11, part=r, parts=RANKS)()]
        for r in range(RANKS)]
    whole = [b['sample_id'].tolist() for b in trainer.make_loader(
        ds, PAIRS, num_workers=2, seed=11)()]
    assert [a + b for a, b in zip(*ids)] == whole


# ---------------------------------------------------------------- the CLI

def _cli(out, *extra):
    return ['--small', '--device', 'cpu', '--epochs', '1',
            '--synthetic_pairs', '4', '--batch_size', str(PAIRS),
            '--output_dir', str(out), *extra, '--set', 'REID.FG_THRESH',
            '0.0']


def test_torchrun_multihost_matches_one_process(tmp_path):
    """Two CPU ranks under torchrun train the one-process CLI's run (2
    steps): every loss term rank 0 writes to tensorboard within 1e-5 of
    scale of the one-process run's, the frozen parameters unchanged, one
    event file and one checkpoint.  (Parameters after two Adam steps are
    not compared: the noise elements of the module docstring carry their
    first step's sign into the second.)"""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    env.pop('WORLD_SIZE', None)
    res = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', str(RANKS), '-m', 'jmodt_torch.train',
         '--multihost', *_cli(tmp_path / 'ranks')],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_main.main(_cli(tmp_path / 'one'))
    finally:
        torch.set_num_threads(threads)
    ckpt = 'ckpt/checkpoint_epoch_1.pth'
    one = torch.load(tmp_path / 'one' / ckpt, weights_only=True)
    two = torch.load(tmp_path / 'ranks' / ckpt, weights_only=True)
    assert (one['it'], one['epoch']) == (two['it'], two['epoch']) == (2, 1)
    assert two['optimizer_state']['count'] == 2
    trains = set(two['optimizer_state']['names'])
    assert trains == set(one['optimizer_state']['names'])
    for k, v in one['model_state'].items():
        if k not in trains:
            assert torch.equal(two['model_state'][k], v), k
    want = _events(tmp_path / 'one' / 'tensorboard')
    got = _events(tmp_path / 'ranks' / 'tensorboard')
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    assert ('train_loss', 2) in [(t, s) for t, s, _ in got]
    for (tag, step, g), (_, _, w) in zip(got, want):
        assert _err(g, w) <= DP_TOL, (tag, step, g, w)
    log = (tmp_path / 'ranks' / 'train.log').read_text()
    assert '2 rank(s)' in log and 'End training' in log
    assert len(list((tmp_path / 'ranks' / 'tensorboard').iterdir())) == 1
    assert len(list((tmp_path / 'ranks' / 'ckpt').iterdir())) == 1


def test_spawned_cli_ranks(tmp_path):
    """The ranks `python -m jmodt_torch.train --data_parallel` spawns run
    `data_parallel.cli_rank`, imported by name in each child: two CPU
    ranks through it train the one-process run (the tensorboard scalars
    as above) and write one checkpoint."""
    mesh.spawn(data_parallel.cli_rank, RANKS,
               args=(_cli(tmp_path / 'ranks'),), device='cpu', threads=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_main.main(_cli(tmp_path / 'one'))
    finally:
        torch.set_num_threads(threads)
    want = _events(tmp_path / 'one' / 'tensorboard')
    got = _events(tmp_path / 'ranks' / 'tensorboard')
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    for (tag, step, g), (_, _, w) in zip(got, want):
        assert _err(g, w) <= DP_TOL, (tag, step, g, w)
    assert '2 rank(s)' in (tmp_path / 'ranks' / 'train.log').read_text()
    assert [p.name for p in (tmp_path / 'ranks' / 'ckpt').iterdir()] == [
        'checkpoint_epoch_1.pth']


def _events(log_dir):
    """[(tag, step, value)] of the scalars in a tensorboard log dir (the
    TFRecord framing: length, its crc, the event, its crc)."""
    from tensorboardX.proto import event_pb2
    out = []
    for f in sorted(Path(log_dir).iterdir()):
        data = f.read_bytes()
        i = 0
        while i < len(data):
            (n,) = struct.unpack('<Q', data[i:i + 8])
            ev = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            for v in ev.summary.value:
                out.append((v.tag, ev.step, v.simple_value))
    return out


def test_trainer_writes_the_jax_trainers_scalars(tmp_path):
    """Names, steps and values of the scalars read back from the event
    file: train_loss and train_<term> at each step (values the step's
    `scalars(tb)`), train_loss_epoch, val_loss_epoch and val_<term> at the
    epoch, as jmodt_tpu/train/trainer.py writes them."""
    pytest.importorskip('tensorboardX')
    from tensorboardX import SummaryWriter
    _, cfg = _cfgs(True)
    model = build_detector(cfg, mode='TRAIN', device='cpu', seed=0)
    opt = train_step.make_optimizer(cfg, model, 2)
    writer = SummaryWriter(log_dir=str(tmp_path / 'tb'))
    tr = trainer.Trainer(cfg, model, opt, str(tmp_path / 'ckpt'),
                         device='cpu', tb_log=writer)
    seen = []
    step = tr._train_step

    def recorded(batch):
        tb = step(batch)
        seen.append(train_step.scalars(tb))
        return tb

    tr._train_step = recorded
    batches = [make_pair_batch(seed=s, cfg=cfg, num_pairs=1,
                               img_hw=(64, 128)) for s in range(3)]
    vals = []
    val = tr._val_step

    def val_recorded(batch):
        loss, tb = val(batch)
        vals.append(train_step.scalars(tb))
        return loss, tb

    tr._val_step = val_recorded
    tr.train(0, 0, 1, lambda: iter(batches[:2]), lambda: iter(batches[2:]))
    writer.close()
    want = []
    for it, s in enumerate(seen, 1):
        assert s['loss'] > 0
        want.append(('train_loss', it, s['loss']))
        want.extend(('train_' + k, it, v) for k, v in s.items())
    want.append(('train_loss_epoch', 1,
                 sum(s['loss'] for s in seen) / len(seen)))
    want.append(('val_loss_epoch', 1, vals[0]['loss']))
    want.extend(('val_' + k, 1, v) for k, v in vals[0].items())
    got = _events(tmp_path / 'tb')
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    for (_, _, g), (t, _, w) in zip(got, want):
        assert g == np.float32(w), t


def test_cli_stops_on_flags_that_cannot_run(monkeypatch, tmp_path, capsys):
    for argv, env, match in (
            (['--batch_size', '3', '--multihost'], {'WORLD_SIZE': '2'},
             'does not split over 2 ranks'),
            (['--points_parallel', '3', '--multihost'], {'WORLD_SIZE': '4'},
             'world of 4 ranks does not split into points groups of 3'),
            (['--multihost'], {}, 'start the ranks with torchrun')):
        monkeypatch.delenv('WORLD_SIZE', raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(SystemExit):
            train_main.main(['--small', '--device', 'cpu', '--output_dir',
                             str(tmp_path), *argv])
        assert match in capsys.readouterr().err
    assert not (tmp_path / 'train.log').exists()
