"""The port's training loop parts against the JAX package's, on the CPU.

- The optimizer: the same numpy gradients through the JAX package's optax
  chain (`make_optimizer`) and the port's, 3 steps across an epoch
  boundary, the clip active, FINETUNE's frozen mask: parameters within
  1e-6, frozen ones bit-equal.
- One finetune step leaves every frozen parameter and BatchNorm buffer
  bit-equal.
- Checkpoints: save, strict and partial load, and a resumed step equal to
  the unbroken one.
- `python -m jmodt_torch.train --small --device cpu --epochs 1`.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from jmodt_tpu.data.synthetic import make_pair_batch
from jmodt_tpu.train import train_step as jax_train_step
from jmodt_torch.models.point_rcnn import build_detector
from jmodt_torch.train import checkpoint, train_step
from jmodt_torch.weights import (export_jax_variables,
                                 jax_variables_to_state_dict)
from tests.test_torch_train_step import _cfgs

ROOT = Path(__file__).resolve().parents[1]
R = dataclasses.replace


# ------------------------------------------------------------ optimizer

def test_optimizer_matches_optax():
    """make_optimizer's chain against the port's for 3 steps over 2 steps
    an epoch (the cosine staircase moves at step 2), FINETUNE's frozen
    mask, gradients large enough that the clip acts on every step."""
    jcfg, tcfg = _cfgs(True)
    jcfg = R(jcfg, TRAIN=R(jcfg.TRAIN, TMAX=3, LR=1e-2))
    tcfg = R(tcfg, TRAIN=R(tcfg.TRAIN, TMAX=3, LR=1e-2))
    tmodel = build_detector(tcfg, mode='TRAIN', device='cpu', seed=3)
    params = export_jax_variables(tmodel)['params']
    tx = jax_train_step.make_optimizer(jcfg, params, steps_per_epoch=2)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    opt = train_step.make_optimizer(tcfg, tmodel, steps_per_epoch=2)
    assert opt.names and all('link_layer' in n or 'se_layer' in n
                             for n in opt.names)
    rng = np.random.RandomState(4)
    named = dict(tmodel.named_parameters())
    init = {n: p.detach().clone() for n, p in named.items()}
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*x.shape).astype(np.float32) * 0.3, params)
        assert float(optax.global_norm(grads)) > jcfg.TRAIN.GRAD_NORM_CLIP
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = jax_variables_to_state_dict({'params': grads})
        for name, p in named.items():
            p.grad = tgrads[name].clone()
        opt.step()
        assert opt.count == step + 1
    want = jax_variables_to_state_dict({'params': jax.device_get(params)})
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        if name not in opt.names:                 # frozen: bit-equal
            assert torch.equal(p.detach(), init[name]), name


def test_frozen_parameters_and_rpn_stats_stay_bit_equal():
    """One finetune step: every parameter outside the link / se heads and
    every RPN BatchNorm buffer is bit-equal to its value before it."""
    _, tcfg = _cfgs(True)
    model = build_detector(tcfg, mode='TRAIN', device='cpu', seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = train_step.make_optimizer(tcfg, model, 4)
    step = train_step.make_train_step(tcfg, model, opt, device='cpu')
    tb = step(make_pair_batch(seed=2, cfg=tcfg, num_pairs=1,
                              img_hw=(64, 128)))
    assert float(tb['loss'].detach()) > 0
    assert np.isfinite(float(tb['grad_norm']))
    after = model.state_dict()
    for k, v in before.items():
        if 'link_layer' in k or 'se_layer' in k:
            if k.endswith('weight'):        # decay moves every weight
                assert not torch.equal(after[k], v), k
        else:
            assert torch.equal(after[k], v), k


# ---------------------------------------------------------- checkpoints

def test_checkpoint_save_load_resume(tmp_path):
    _, tcfg = _cfgs(False)
    batches = [make_pair_batch(seed=s, cfg=tcfg, num_pairs=1,
                               img_hw=(64, 128)) for s in range(3)]

    def run(n_steps, start=None):
        model = build_detector(tcfg, mode='TRAIN', device='cpu', seed=0)
        opt = train_step.make_optimizer(tcfg, model, 2)
        if start is not None:
            it, epoch = checkpoint.load_checkpoint(start, model, opt)
            assert (it, epoch) == (2, 1)
        step = train_step.make_train_step(tcfg, model, opt, seed=9,
                                          device='cpu')
        for i in range(opt.count, n_steps):
            step(batches[i])
        return model, opt

    model, opt = run(2)
    path = checkpoint.save_checkpoint(
        checkpoint.checkpoint_state(model, opt, epoch=1, it=2),
        str(tmp_path / 'ck'))
    assert path.endswith('.pth') and os.path.isfile(path)
    # strict load: identical parameters, buffers and optimizer state
    m2 = build_detector(tcfg, mode='TRAIN', device='cpu', seed=5)
    o2 = train_step.make_optimizer(tcfg, m2, 2)
    checkpoint.load_checkpoint(path, m2, o2)
    sd, sd2 = model.state_dict(), m2.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    s1, s2 = opt.state_dict(), o2.state_dict()
    assert s1['count'] == s2['count'] == 2
    assert all(torch.equal(s1[m][n], s2[m][n]) for m in ('mu', 'nu')
               for n in s1['names'])
    # resume: the third step equals the unbroken run's
    full, _ = run(3)
    resumed, _ = run(3, start=path)
    a, b = full.state_dict(), resumed.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # partial: a model without BN statistics and with a wider head loads
    # what matches and keeps the rest; nothing matching raises
    other = R(tcfg, REID=R(tcfg.REID, LINK_FC=(64, 32)))
    m3 = build_detector(other, mode='TRAIN', device='cpu', seed=7)
    keep = m3.state_dict()['rcnn.link_layer.mlp.Dense_0.weight'].clone()
    checkpoint.load_checkpoint(path, m3, strict=False)
    sd3 = m3.state_dict()
    assert torch.equal(sd3['rcnn.cls_head.Dense_0.weight'],
                       sd['rcnn.cls_head.Dense_0.weight'])
    assert torch.equal(sd3['rcnn.link_layer.mlp.Dense_0.weight'], keep)
    torch.save({'model_state': {'nothing': torch.zeros(1)}},
               tmp_path / 'bad.pth')
    with pytest.raises(RuntimeError, match='no keys restored'):
        checkpoint.load_checkpoint(str(tmp_path / 'bad'), m3,
                                   strict=False)


def test_train_entry_point_runs_on_cpu(tmp_path):
    out = tmp_path / 'out'
    res = subprocess.run(
        [sys.executable, '-m', 'jmodt_torch.train', '--small', '--device',
         'cpu', '--epochs', '1', '--output_dir', str(out)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JMODT_DTYPE='float32'))
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'End training' in res.stderr
    assert (out / 'ckpt' / 'checkpoint_epoch_1.pth').is_file()
    state = torch.load(out / 'ckpt' / 'checkpoint_epoch_1.pth',
                       weights_only=True)
    assert state['epoch'] == 1 and state['it'] == 4
