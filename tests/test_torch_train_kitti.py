"""Training from KITTI files on the CPU, against the JAX package's trainer
parts on the same converted tree.

The tree is a raw KITTI tracking tree of synthetic scenes
(`data/synthetic.py::write_synthetic_kitti_tree`): a training sequence of
5 frames (4 pairs) and the small_val sequence (0019) of 3, converted by
each package's converter; both datasets are pinned to their numpy loaders
(`use_native=False`) where batches are held bit-equal.

- `make_loader` at workers 0: every batch of two epochs bit-equal to the
  JAX `make_loader`'s, shuffled and in order.  At workers 2: each worker's
  first batch equals a fresh dataset's draws for its pairs (every worker
  starts from a copy of the dataset's random state, as in the JAX
  package), and the epoch order follows the seed.
- One finetune step on the first KITTI batch against JAX's
  `make_train_step` (its gradients taken through a capturing optax
  transformation): loss terms and grad_norm within 1e-5 of their scale,
  each link / se gradient within 1e-4 of its own scale, no RPN gradient
  (tests/test_torch_train_step.py's FINETUNE tolerances and config).  The
  link head's output bias is the exception: the bidirectional softmax
  does not move when every score shifts, so its exact gradient is 0 and
  both packages return float32 rounding noise; both must lie within 1e-6
  of the largest gradient.
- The CLI `main(['--small', '--device', 'cpu', '--data_root', ...])`:
  checkpoints, a `train.log` that `tools/ladder_report.py` parses, the
  val terms logged, and steps an epoch and the learning rate after the
  epoch equal to JAX's for that length (`make_optimizer`).
- `AsyncCheckpointWriter`: its file holds what a synchronous save holds,
  parameters changed after `save()` do not reach it, and a failed write
  is raised by `wait()`.
- `Trainer.eval_epoch`'s means skip NaN per term, as the JAX trainer's.
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jmodt_tpu.models.pointnet2 as jax_pointnet2
from jmodt_tpu.data import converter as jax_converter
from jmodt_tpu.data.kitti_dataset import KittiDataset as JaxKittiDataset
from jmodt_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from jmodt_tpu.train import train_step as jax_train_step
from jmodt_tpu.train import trainer as jax_trainer
from jmodt_torch.config import small_config
from jmodt_torch.data import converter
from jmodt_torch.data.kitti_dataset import KittiDataset
from jmodt_torch.data.synthetic import write_synthetic_kitti_tree
from jmodt_torch.models.point_rcnn import PointRCNN, build_detector
from jmodt_torch.train import __main__ as train_main
from jmodt_torch.train import checkpoint, train_step, trainer
from jmodt_torch.weights import (export_jax_variables,
                                 jax_variables_to_state_dict,
                                 load_jax_variables)
from tests.test_torch_kitti_data import _assert_samples_equal
from tests.test_torch_models import _three_nn_kernel_semantics
from tests.test_torch_train_proposal import jax_roi_draws
from tests.test_torch_train_step import (GRAD_TOL, LOSS_TOL,
                                         _assert_grads_match, _cfgs, _err)

ROOT = Path(__file__).resolve().parents[1]
R = dataclasses.replace
# the link head's output bias: 0 in exact arithmetic (module docstring)
SHIFT_FREE = 'rcnn.link_layer.mlp.Dense_0.bias'
NOISE_TOL = 1e-6
IMG_HW = (60, 124)          # padded to the small config's 64 x 128
SWEEP = 700                 # lidar points a frame
BATCH = 2                   # pairs a step


@pytest.fixture(scope='module')
def converted(tmp_path_factory):
    """The tree converted by both packages: (JAX's root, the port's)."""
    base = tmp_path_factory.mktemp('train_kitti')
    raw = base / 'tracking'
    cfg = small_config()
    write_synthetic_kitti_tree(str(raw), cfg, seq_ids=('0001',), n_frames=5,
                               img_hw=IMG_HW, npoints=SWEEP, seed=0)
    write_synthetic_kitti_tree(str(raw), cfg, seq_ids=('0019',), n_frames=3,
                               img_hw=IMG_HW, npoints=SWEEP, seed=1)
    out = {}
    for name, mod in (('jax', jax_converter), ('torch', converter)):
        root = base / name
        os.makedirs(root)
        os.symlink(raw, root / 'tracking')
        mod.create_train_sample_data(str(raw), str(root / 'tracking_object'))
        out[name] = root
    return out['jax'], out['torch']


def _datasets(converted, jcfg, tcfg, split='train', seed=0):
    kw = dict(npoints=tcfg.RPN.NUM_POINTS, split=split, mode='TRAIN',
              fixed_img_size=(64, 128), seed=seed)
    return (JaxKittiDataset(str(converted[0]), cfg=jcfg, use_native=False,
                            **kw),
            KittiDataset(str(converted[1]), cfg=tcfg, use_native=False,
                         **kw))


# ------------------------------------------------------------ the loader

@pytest.mark.parametrize('shuffle', [True, False])
def test_make_loader_batches_match_jax(converted, shuffle):
    jcfg, tcfg = _cfgs(True)
    a, b = _datasets(converted, jcfg, tcfg, seed=3)
    assert a.sample_pair_id_list == b.sample_pair_id_list
    assert len(b) == 4
    ja = jax_trainer.make_loader(a, BATCH, shuffle=shuffle, seed=7)
    tb = trainer.make_loader(b, BATCH, shuffle=shuffle, seed=7)
    orders = []
    for _ in range(2):                       # the order moves across epochs
        pairs = [(x, y) for x, y in zip(ja(), tb())]
        assert len(pairs) == len(b) // BATCH
        for x, y in pairs:
            _assert_samples_equal(x, y)
        orders.append([y['sample_id'].tolist() for _, y in pairs])
    assert (orders[0] != orders[1]) == shuffle
    # drop_last off keeps the short tail
    odd = trainer.make_loader(b, 3, shuffle=False, drop_last=False)
    assert [len(x['sample_id']) for x in odd()] == [6, 2]


def test_make_loader_workers_start_from_one_random_state(converted):
    """Workers each start from a copy of the dataset's random state: the
    first batch of each of 2 workers equals a fresh dataset's draws for
    its pairs.  The shuffle follows the seed."""
    cfg = R(small_config(), DTYPE='float32', AUG_DATA=True)
    ds = KittiDataset(str(converted[1]), npoints=cfg.RPN.NUM_POINTS,
                      split='train', mode='TRAIN', cfg=cfg,
                      fixed_img_size=(64, 128), seed=3)
    loader = trainer.make_loader(ds, BATCH, num_workers=2, seed=11)
    batches = list(loader())
    assert len(batches) == 2
    index = {p: i for i, p in enumerate(ds.sample_pair_id_list)}
    for batch in batches:
        ids = batch['sample_id'].tolist()
        pairs = [index[(ids[i], ids[i + 1])] for i in range(0, len(ids), 2)]
        fresh = KittiDataset(str(converted[1]), npoints=cfg.RPN.NUM_POINTS,
                             split='train', mode='TRAIN', cfg=cfg,
                             fixed_img_size=(64, 128), seed=3)
        _assert_samples_equal(batch, fresh.collate_batch(
            [fresh[j] for j in pairs]))
    again = trainer.make_loader(ds, BATCH, num_workers=2, seed=11)
    assert [b['sample_id'].tolist() for b in again()] == \
        [b['sample_id'].tolist() for b in batches]


# ------------------------------------------------------ one finetune step

def test_first_kitti_step_matches_jax(converted, monkeypatch):
    """The first batch of a shuffled epoch through one port train step and
    one JAX `make_train_step` with the same weights and RoI draws."""
    jcfg, tcfg = _cfgs(True)
    _, ds = _datasets(converted, jcfg, tcfg)
    batch = next(iter(trainer.make_loader(ds, BATCH, seed=0)()))
    batch = {k: v for k, v in batch.items() if k != 'sample_id'}
    model = build_detector(tcfg, mode='TRAIN', device='cpu', seed=0)
    variables = export_jax_variables(model)

    # JAX: make_train_step with an optax transformation that keeps the
    # gradients as its state and applies no update
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    monkeypatch.setattr(jax_pointnet2, 'three_nn', _three_nn_kernel_semantics)
    jstep = jax.jit(jax_train_step.make_train_step(
        jcfg, JaxPointRCNN(jcfg, mode='TRAIN'), capture))
    key = jax.random.PRNGKey(5)
    state = jax_train_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables['params'],
        batch_stats=variables['batch_stats'],
        opt_state=capture.init(variables['params']))
    state, jtb = jax.device_get(jstep(state, batch, key))
    sample_key = jax.random.split(jax.random.fold_in(key, 0))[1]
    draws = jax_roi_draws(jcfg, sample_key, 2 * BATCH,
                          jcfg.TRAIN.RPN_POST_NMS_TOP_N)

    # the port: its train step with the JAX draws
    tmodel = load_jax_variables(PointRCNN(tcfg, mode='TRAIN'), variables,
                                device='cpu')
    opt = train_step.make_optimizer(tcfg, tmodel, 2)
    monkeypatch.setattr(train_step, 'sample_roi_draws',
                        lambda *a: draws)
    ttb = train_step.make_train_step(tcfg, tmodel, opt, device='cpu')(batch)

    assert sorted(ttb) == sorted(jtb)
    for k, v in jtb.items():
        assert _err(ttb[k].detach(), v) <= LOSS_TOL, k
    assert float(jtb['rcnn_loss']) > 0 and float(jtb['grad_norm']) > 0
    want = {k: v.double().numpy() for k, v in jax_variables_to_state_dict(
        {'params': state.opt_state}).items()}
    params = dict(tmodel.named_parameters())
    got = {n: (np.zeros(p.shape) if p.grad is None
               else p.grad.double().numpy()) for n, p in params.items()}
    top = max(float(np.abs(w).max()) for w in want.values())
    for g in (got.pop(SHIFT_FREE), want.pop(SHIFT_FREE)):
        assert float(np.abs(g).max()) <= NOISE_TOL * top
    moved = _assert_grads_match(got, want, GRAD_TOL, 0.0)
    assert moved and all('link_layer' in n or 'se_layer' in n or
                         n.startswith('rcnn.') for n in moved)
    assert all(params[n].grad is None for n in params if n.startswith('rpn.'))
    assert any('link_layer' in n for n in moved)
    assert any('se_layer' in n for n in moved)


# ---------------------------------------------------------------- the CLI

def _ladder_report():
    spec = importlib.util.spec_from_file_location(
        'ladder_report', ROOT / 'tools' / 'ladder_report.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_lr(jcfg, steps_per_epoch, count):
    """The learning rate of JAX `make_optimizer`'s update number
    `count + 1`: with zero gradients the update of a parameter at 1 is
    -lr * WEIGHT_DECAY."""
    jcfg = R(jcfg, TRAIN=R(jcfg.TRAIN, FINETUNE=False))
    params = {'w': jnp.ones(1)}
    tx = jax_train_step.make_optimizer(jcfg, params, steps_per_epoch)
    state = tx.init(params)
    zero = {'w': jnp.zeros(1)}
    for _ in range(count + 1):
        upd, state = tx.update(zero, state, params)
    return float(-upd['w'][0] / jcfg.TRAIN.WEIGHT_DECAY)


def test_cli_trains_from_kitti_files(converted, tmp_path):
    out = tmp_path / 'out'
    train_main.main(['--small', '--device', 'cpu', '--data_root',
                     str(converted[1]), '--epochs', '1', '--workers', '0',
                     '--batch_size', str(BATCH), '--train_with_eval',
                     '--output_dir', str(out), '--set', 'REID.FG_THRESH',
                     '0.0'])
    jcfg, tcfg = _cfgs(True)
    jax_set, _ = _datasets(converted, jcfg, tcfg)
    spe = max(len(jax_set) // BATCH, 1)
    state = torch.load(out / 'ckpt' / 'checkpoint_epoch_1.pth',
                       weights_only=True)
    assert state['epoch'] == 1 and state['it'] == spe == 2
    opt = state['optimizer_state']
    assert opt['steps_per_epoch'] == spe and opt['count'] == spe
    assert all('link_layer' in n or 'se_layer' in n for n in opt['names'])
    lr = train_step.learning_rate(small_config(), opt['count'],
                                  opt['steps_per_epoch'])
    assert lr == pytest.approx(_jax_lr(jcfg, spe, spe), rel=1e-6)
    assert lr < small_config().TRAIN.LR            # the epoch stepped it
    assert (out / 'ckpt' / 'best_model.pth').is_file()

    log = (out / 'train.log').read_text()
    stages = _ladder_report().parse([str(out / 'train.log')])[0]
    assert len(stages) == 1
    assert stages[0]['finetune'] is True and stages[0]['fusion'] is True
    assert stages[0]['epochs'] == 1 and len(stages[0]['hist']) == 1
    assert 'epoch 1: val_loss=' in log and 'rcnn_loss=' in log
    assert 'End training' in log


def test_cli_rejects_parallel_flags(converted, tmp_path):
    for flag in (['--data_parallel', '2'], ['--points_parallel', '0'],
                 ['--multihost', '2']):
        with pytest.raises(SystemExit):
            train_main.main(['--small', '--device', 'cpu', *flag,
                             '--output_dir', str(tmp_path)])


# ------------------------------------------------------------ checkpoints

def test_async_checkpoint_writer(tmp_path):
    cfg = R(small_config(), DTYPE='float32')
    model = build_detector(cfg, mode='TRAIN', device='cpu', seed=0)
    opt = train_step.make_optimizer(cfg, model, 2)
    for m in opt.mu:
        m.normal_()
    opt.count = 3
    sync = checkpoint.save_checkpoint(
        checkpoint.checkpoint_state(model, opt, 1, 3), str(tmp_path / 'a'))
    writer = checkpoint.AsyncCheckpointWriter()
    try:
        path = checkpoint.save_checkpoint(
            checkpoint.checkpoint_state(model, opt, 1, 3),
            str(tmp_path / 'b'), writer=writer)
        with torch.no_grad():                  # the next steps, in place
            for p in model.parameters():
                p.add_(1.0)
            for m in opt.mu:
                m.mul_(-1.0)
        writer.wait()
        a = torch.load(sync, weights_only=True)
        b = torch.load(path, weights_only=True)
        assert a.keys() == b.keys() and a['it'] == b['it'] == 3
        for part in ('model_state', 'optimizer_state'):
            flat_a = _flatten(a[part])
            flat_b = _flatten(b[part])
            assert flat_a.keys() == flat_b.keys()
            for k, v in flat_a.items():
                if isinstance(v, torch.Tensor):
                    assert v.dtype == flat_b[k].dtype and torch.equal(
                        v, flat_b[k]), (part, k)
                else:
                    assert v == flat_b[k], (part, k)
        fresh = build_detector(cfg, mode='TRAIN', device='cpu', seed=9)
        assert checkpoint.load_checkpoint(path, fresh) == (3, 1)
        # a write that fails is raised by wait()
        (tmp_path / 'file').write_text('')
        writer.save({'epoch': 1}, str(tmp_path / 'file' / 'x'))
        with pytest.raises(OSError):
            writer.wait()
    finally:
        writer.close()


def _flatten(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f'{prefix}{k}/'))
        return out
    return {prefix: tree}


# ------------------------------------------------------------- eval epoch

LOSSES = [0.5, 0.0, float('nan'), 1.5]
TERMS = {'rcnn_loss': [1.0, float('nan'), 3.0, 5.0],
         'link_loss': [float('nan')] * 4,
         'se_loss': [2.0, 2.0, 2.0, 2.0]}


def _stub(to):
    calls = []

    def val_step(*args):
        i = len(calls)
        calls.append(i)
        return to(LOSSES[i]), {k: to(v[i]) for k, v in TERMS.items()}
    return val_step


def test_eval_epoch_means_skip_nan_as_jax(tmp_path):
    batches = [{'pts_input': np.zeros((2, 4, 3), np.float32)}] * 4
    jt = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    jt.prefetch, jt._mesh, jt.state = False, None, None
    jt._val_step = _stub(np.float32)
    want = jt.eval_epoch(batches, None)

    cfg = R(small_config(), DTYPE='float32')
    model = build_detector(cfg, mode='TRAIN', device='cpu', seed=0)
    t = trainer.Trainer(cfg, model, train_step.make_optimizer(cfg, model, 1),
                        str(tmp_path), device='cpu')
    t._val_step = _stub(lambda v: torch.tensor(v, dtype=torch.float32))
    got = t.eval_epoch(batches)
    assert got[0] == pytest.approx(want[0]) == 1.0
    assert got[1].keys() == want[1].keys() == {'rcnn_loss', 'se_loss'}
    for k, v in want[1].items():
        assert got[1][k] == pytest.approx(v)
    assert got[1]['rcnn_loss'] == pytest.approx(3.0)
