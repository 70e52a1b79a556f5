"""The (data, points) mesh of training (`jmodt_torch/parallel/mesh.py`,
`python -m jmodt_torch.train --points_parallel P`) on the CPU: ranks over
gloo, each spawned with one torch thread and a `file://` rendezvous under
the test's temporary directory.

- The layout against the JAX package's `make_mesh_2d` / `batch_sharding`:
  rank r is the device at (r // sp, r % sp) of JAX's (data, points) mesh
  of 8 devices, and `shard_batch` cuts for each rank exactly the slice of
  every batch field that JAX's sharding places on that device (sp 2 and
  4; sp 3 of 8 refused by both).
- The points group's collectives on 2 gloo ranks, forward and backward:
  the all-gather (its backward a reduce-scatter where each rank consumes
  the whole differently, its own slice where every rank computes the
  same), the reduce-scatter and the width halo exchange, against their
  unsplit definitions; the halo'd `BasicBlock` (training-mode BatchNorm
  over both ranks) and the owner-masked `feature_gather` (points on the
  slices' boundary and off the map included) against the JAX package's
  `BasicBlock` and `feature_gather` on the whole image (1e-5 of scale),
  the gather also bit for bit against the port's unsplit one, their
  gradients against the port's unsplit modules' (1e-5 of scale).
- The train step at (dp, sp) = (1, 2) and (2, 2) against the port's
  one-process step on the same global batch of 2 pairs, with the settings
  and weights of tests/test_torch_parallel.py: finetune, every loss term,
  grad_norm and every parameter (gradient noise elements aside, as there)
  within its DP_TOL 1e-5 of scale; full losses, as that file's rule for
  steps whose train-mode BatchNorm amplifies float32 rounding, every term
  and parameter within max(1e-5, twice the gap of the one-process step
  with its BatchNorm sums in float64).  Every rank's parameters and
  buffers bit-equal; the launch counts per kernel wrapper call equal.
- The (2, 2) step against the JAX package's own points step, jitted on
  `make_mesh_2d(jax.devices()[:4], sp=2)` with `batch_sharding` (the path
  of tools/train.py:216-219), at the tolerances of
  tests/test_torch_parallel.py::test_two_ranks_match_the_jax_step (full
  losses: the JAX model in float64 on the same mesh).
- `python -m jmodt_torch.train --points_parallel 2` through its spawned
  rank body on 4 gloo ranks trains the one-process run (tensorboard
  scalars within 1e-5 of scale) and logs the mesh's shape; the CLI stops
  on a world that does not divide into points groups.
- Shapes that do not divide raise, naming the shape; the slice's modules
  import nothing of JAX; the split diagnosis needs a card unless asked.
- Under CUBLAS_WORKSPACE_CONFIG=:0:0 (`layers.split_invariant`) a
  one-output `layers.dense` is a row sum whose rows do not depend on the
  row count; without it every layer is `F.linear`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jmodt_tpu.models.pointnet2 as jax_pointnet2
from jmodt_tpu.data.synthetic import make_pair_batch
from jmodt_tpu.models import image_backbone as jax_img
from jmodt_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from jmodt_tpu.parallel import mesh as jax_mesh
from jmodt_tpu.train import train_step as jax_train_step
from jmodt_torch.config import small_config
from jmodt_torch.models import image_backbone, layers
from jmodt_torch.models.point_rcnn import PointRCNN, build_detector
from jmodt_torch.models.pointnet2 import SAModuleMSG
from jmodt_torch.parallel import mesh
from jmodt_torch.tools import split_diagnosis
from jmodt_torch.train import __main__ as train_main
from jmodt_torch.train import data_parallel, train_step
from jmodt_torch.weights import (jax_variables_to_state_dict,
                                 load_jax_variables)
from tests.test_torch_models import (_randomize_stats,
                                     _three_nn_kernel_semantics)
from tests.test_torch_package import _imports_with_jax_blocked
from tests.test_torch_parallel import (BATCH_SEED, DP_TOL, PAIRS,
                                       _batch_norm_float64, _check_params,
                                       _cli, _events, _flat, _noise,
                                       _one_process, _state_errs, _variables)
from tests.test_torch_train_kitti import NOISE_TOL, SHIFT_FREE
from tests.test_torch_train_proposal import jax_roi_draws
from tests.test_torch_train_step import (FULL_GRAD_TOL, GRAD_FLOOR, GRAD_TOL,
                                         LOSS_TOL, _assert_grads_match,
                                         _cfgs, _err, _jax_float64)

LAYOUTS = {'1x2': (1, 2), '2x2': (2, 2)}          # (dp, sp)
R = dataclasses.replace


# ------------------------------------------------------------- the layout

@pytest.mark.parametrize('sp', [2, 4])
def test_layout_matches_jax_mesh(sp):
    """Rank r sits where JAX's `make_mesh_2d` puts device r, and
    `shard_batch` gives it the slice of every field that JAX's
    `batch_sharding` places there."""
    devices = jax.devices()[:8]
    m2 = jax_mesh.make_mesh_2d(devices, sp=sp)
    dp = mesh.check_layout(8, sp)
    assert dict(m2.shape) == {'data': dp, 'points': sp}
    ids = np.vectorize(lambda d: d.id)(m2.devices)
    for r in range(8):
        assert ids[r // sp, r % sp] == devices[r].id
    assert mesh.POINT_DIMS == jax_mesh._POINT_DIMS
    cfg = small_config()
    batch = make_pair_batch(seed=0, cfg=cfg, num_pairs=4, img_hw=(64, 128))
    for key, v in batch.items():
        where = jax_mesh.batch_sharding(m2, key).devices_indices_map(v.shape)
        for r, dev in enumerate(devices):
            got = mesh.shard_batch({'pts_input': batch['pts_input'],
                                    key: v}, r // sp, dp, r % sp, sp)[key]
            np.testing.assert_array_equal(got, v[where[dev]], err_msg=key)


def test_layout_refuses_what_jax_refuses():
    with pytest.raises(AssertionError):
        jax_mesh.make_mesh_2d(jax.devices()[:8], sp=3)
    with pytest.raises(ValueError, match='world of 8 ranks does not split'):
        mesh.check_layout(8, 3)
    with pytest.raises(ValueError, match='world of 8 ranks does not split'):
        mesh.spawn(data_parallel.cli_rank, 8, device='cpu', points=3)


def test_shapes_that_do_not_divide_raise(monkeypatch):
    cfg = small_config()
    batch = make_pair_batch(seed=0, cfg=cfg, num_pairs=1, img_hw=(64, 128))
    with pytest.raises(ValueError, match=r'pts_input of shape \(2, 256, 3\)'):
        mesh.shard_points(batch, 0, 3)
    with pytest.raises(ValueError, match='an image 120 wide'):
        mesh.check_points_shapes(2, 256, (64, 32, 16, 8), 120, 4)
    with pytest.raises(ValueError, match='SA level 3\'s 8 centres'):
        mesh.check_points_shapes(16, 256, (64, 32, 16, 8), 1024, 4)
    with pytest.raises(ValueError, match='255 points'):
        mesh.check_points_shapes(2, 255, (64,), 128, 4)
    mesh.check_points_shapes(4, 256, (64, 32, 16, 8), 128, 4)
    # inside a split the modules refuse too, never computing unsplit
    monkeypatch.setattr(mesh, 'points_split', lambda: (0, 3))
    sa = SAModuleMSG(8, (0.5,), (4,), ((8,),), cin=0)
    with pytest.raises(ValueError, match='8 centres does not split'):
        sa(torch.zeros(1, 12, 3), None)
    block = image_backbone.BasicBlock(3, 4)
    with pytest.raises(ValueError, match='5 columns wide'):
        block(torch.zeros(1, 4, 5, 3))


def test_dense_row_sum_under_split_invariant(monkeypatch):
    """Under CUBLAS_WORKSPACE_CONFIG=:0:0 a one-output layer is a row sum
    in float32: a row's value does not depend on the rows beside it, and
    it is the product within float32 rounding; a wider layer, and every
    layer without the setting, is `F.linear` itself."""
    g = torch.Generator().manual_seed(0)
    one = torch.nn.Linear(64, 1)
    wide = torch.nn.Linear(64, 4)
    x = torch.randn(256, 64, generator=g)
    monkeypatch.delenv('CUBLAS_WORKSPACE_CONFIG', raising=False)
    assert not layers.split_invariant()
    for layer in (one, wide):
        torch.testing.assert_close(layers.dense(layer, x, torch.float32),
                                   F.linear(x, layer.weight, layer.bias),
                                   rtol=0, atol=0)
    monkeypatch.setenv('CUBLAS_WORKSPACE_CONFIG', ':0:0')
    assert layers.split_invariant()
    torch.testing.assert_close(layers.dense(wide, x, torch.float32),
                               F.linear(x, wide.weight, wide.bias),
                               rtol=0, atol=0)
    y = layers.dense(one, x, torch.float32)
    for rows in (1, 37, 128):
        torch.testing.assert_close(layers.dense(one, x[:rows], torch.float32),
                                   y[:rows], rtol=0, atol=0)
    torch.testing.assert_close(y, F.linear(x, one.weight, one.bias),
                               rtol=1e-5, atol=1e-6)
    assert layers.dense(one, x, torch.bfloat16).dtype == torch.bfloat16


def test_points_slice_imports_with_jax_blocked():
    """The points slice's modules import nothing of JAX or jmodt_tpu."""
    _imports_with_jax_blocked((
        'jmodt_torch.parallel.mesh', 'jmodt_torch.models.image_backbone',
        'jmodt_torch.models.pointnet2', 'jmodt_torch.models.backbone',
        'jmodt_torch.models.point_rcnn', 'jmodt_torch.train.data_parallel',
        'jmodt_torch.tools.split_diagnosis'))


def test_split_diagnosis_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        split_diagnosis.main(['--small'])


# ------------------------------------------------------- the collectives

IMG = (2, 8, 16, 5)             # the split ops' image (B, H, W, C)


def _split_inputs():
    """The split ops' whole inputs, the same on every rank."""
    g = torch.Generator().manual_seed(7)
    xy = torch.rand(2, 12, 2, generator=g) * 2.2 - 1.1   # some off the map
    xy[:, 0, 0] = 0.0            # u = 7.5: straddles the two slices
    xy[:, 1, 0] = -1.0 / 15.0    # u = 7.0: rank 0's last column
    xy[:, 2, 0] = 1.0 / 15.0     # u = 8.0: rank 1's first column
    return {k: torch.randn(s, generator=g) for k, s in (
        ('x', (2, 6, 3)), ('v', (2, 2, 6, 3)), ('w', (2, 6, 3)),
        ('p', (2, 2, 6, 3)), ('h', (2, 4, 8, 3)), ('hv', (2, 2, 4, 6, 3)),
        ('img', IMG), ('q', (2, 4, 8, 8)), ('fmap', (2, 8, 16, 4)),
        ('u', (2, 12, 4)))} | {'xy': xy}


def _split_ops_rank(device, out_dir, block_state):
    """One rank of the collectives' test: each op on this rank's slice,
    forward and backward; writes the results to `out_dir`/rank<r>.pt."""
    sp = mesh.layout()[1]
    r = mesh.rank() % sp
    t = _split_inputs()
    res = {}

    def own(x, dim, n):
        return x.narrow(dim, r * n, n).clone().requires_grad_()

    x = own(t['x'], 1, 3)
    y = mesh.gather_points(x)
    (y * t['v'][r]).sum().backward()
    res['gather'], res['gather_grad'] = y.detach(), x.grad
    x = own(t['x'], 1, 3)
    (mesh.gather_points(x, replicated=True) * t['w']).sum().backward()
    res['gather_replicated_grad'] = x.grad
    p = t['p'][r].clone().requires_grad_()
    s = mesh.scatter_points(p)
    (s * t['w'].narrow(1, 3 * r, 3)).sum().backward()
    res['scatter'], res['scatter_grad'] = s.detach(), p.grad
    h = own(t['h'], 2, 4)
    e = mesh.halo(h, 2, 1, 1)
    (e * t['hv'][r]).sum().backward()
    res['halo'], res['halo_grad'] = e.detach(), h.grad

    block = image_backbone.BasicBlock(IMG[3], 8)
    block.load_state_dict(block_state)
    block.train()
    x = own(t['img'], 2, IMG[2] // sp)
    with mesh.points_region():
        out = block(x)
    (out * t['q'].narrow(2, r * out.shape[2], out.shape[2])).sum().backward()
    res['block'], res['block_x_grad'] = out.detach(), x.grad
    res['block_grads'] = {k: p.grad for k, p in block.named_parameters()}
    res['block_state'] = block.state_dict()

    fmap = own(t['fmap'], 2, 16 // sp)
    xy = t['xy'].narrow(1, 6 * r, 6)
    with mesh.points_region():
        s = image_backbone.feature_gather(fmap, xy)
    (s * t['u'].narrow(1, 6 * r, 6)).sum().backward()
    res['gather_map'], res['gather_map_grad'] = s.detach(), fmap.grad
    res['collectives'] = mesh.stats['calls']
    torch.save(res, os.path.join(out_dir, f'rank{r}.pt'))


def test_split_ops_on_two_ranks(tmp_path):
    t = _split_inputs()
    jblock = jax_img.BasicBlock(8)
    img = t['img'].numpy()
    variables = _randomize_stats(
        jax.jit(lambda k: jblock.init(k, img))(jax.random.PRNGKey(5)), 6)
    tblock = image_backbone.BasicBlock(IMG[3], 8)
    tblock.load_state_dict(jax_variables_to_state_dict(variables))
    state = {k: v.clone() for k, v in tblock.state_dict().items()}
    rendezvous = tmp_path / 'rendezvous'
    mesh.spawn(_split_ops_rank, 2, args=(str(tmp_path), state),
               init_method=f'file://{rendezvous}', device='cpu', threads=1,
               points=2)
    ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=True)
             for r in range(2)]

    def cat(key, dim):
        return torch.cat([res[key] for res in ranks], dim)

    # the all-gather, its two backwards, the reduce-scatter, the halo
    for res in ranks:
        assert torch.equal(res['gather'], t['x'])
        assert res['collectives'] > 0
    assert torch.equal(cat('gather_grad', 1), t['v'].sum(0))
    assert torch.equal(cat('gather_replicated_grad', 1), t['w'])
    assert torch.allclose(cat('scatter', 1), t['p'].sum(0), rtol=0,
                          atol=1e-6)
    for res in ranks:
        assert torch.equal(res['scatter_grad'], t['w'])
    h = t['h'].clone().requires_grad_()
    padded = torch.nn.functional.pad(h, (0, 0, 1, 1))
    total = sum((padded[:, :, 4 * r:4 * r + 6] * t['hv'][r]).sum()
                for r in range(2))
    total.backward()
    for r, res in enumerate(ranks):
        assert torch.equal(res['halo'], padded[:, :, 4 * r:4 * r + 6])
    assert torch.allclose(cat('halo_grad', 2), h.grad, rtol=0, atol=1e-6)

    # the halo'd BasicBlock against JAX's on the whole image (training
    # BatchNorm), its gradients against the port's unsplit block
    want, upd = jblock.apply(variables, img, train=True,
                             mutable=['batch_stats'])
    assert _err(cat('block', 2), want) <= 1e-5
    stats = jax_variables_to_state_dict(upd)
    for k, v in stats.items():
        for res in ranks:
            assert _err(res['block_state'][k], v.numpy()) <= 1e-5, k
    x = t['img'].clone().requires_grad_()
    tblock.train()
    (tblock(x) * t['q']).sum().backward()
    assert _err(cat('block_x_grad', 2), x.grad) <= 1e-5
    for k, p in tblock.named_parameters():
        got = ranks[0]['block_grads'][k] + ranks[1]['block_grads'][k]
        assert _err(got, p.grad) <= 1e-5, k

    # the owner-masked gather against JAX's, and bit for bit against the
    # port's unsplit one
    want = jax_img.feature_gather(t['fmap'].numpy(), t['xy'].numpy())
    assert _err(cat('gather_map', 1), np.asarray(want)) <= 1e-5
    fmap = t['fmap'].clone().requires_grad_()
    whole = image_backbone.feature_gather(fmap, t['xy'])
    assert torch.equal(cat('gather_map', 1), whole.detach())
    (whole * t['u']).sum().backward()
    assert _err(cat('gather_map_grad', 2), fmap.grad) <= 1e-5
    assert float(fmap.grad[:, :, 7:9].abs().max()) > 0    # both sides used


def test_split_rpn_forward_is_the_one_process_forward(tmp_path):
    """The float32 RPN forward of a finetune batch on a (1, 2) mesh
    (`tools/split_diagnosis.py`): every backbone module's output, the
    image gathers and the RPN's outputs, the ranks' slices concatenated,
    equal to the one process's bit for bit."""
    cfg, state, batch = split_diagnosis.finetune_setup(small=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # as each rank
    try:
        one = split_diagnosis.stage_outputs('cpu', cfg, state, batch)
    finally:
        torch.set_num_threads(threads)
    mesh.spawn(split_diagnosis.rank_body, 2,
               args=(cfg, state, batch, str(tmp_path)), device='cpu',
               threads=1, points=2)
    ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=True)
             for r in range(2)]
    errs = split_diagnosis.stage_errors(one, ranks)
    assert len(errs) == 29 and 'gather_4' in errs
    assert all(e == 0 for e in errs.values()), errs


# ------------------------------------------------------------- the step

@pytest.fixture(scope='module')
def all_runs(tmp_path_factory):
    """finetune -> the one-process step, the control and the ranks' steps
    of every layout, each made once."""
    made = {}

    def get(finetune):
        if finetune not in made:
            made[finetune] = _runs(finetune, tmp_path_factory.mktemp('pp'))
        return made[finetune]

    return get


def _runs(finetune, base):
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
    control = None
    if not finetune:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(layers.BatchNorm, '_batch_norm', _batch_norm_float64)
            control = _one_process(tcfg, state, [batch],
                                   str(base / 'one64'), draws=[draws])
    ranks = {name: data_parallel.on_ranks(
        dp * sp, tcfg, state, [batch], str(base / name), device='cpu',
        draws=[draws], threads=1, points=sp)
        for name, (dp, sp) in LAYOUTS.items()}
    return dict(finetune=finetune, jcfg=jcfg, tcfg=tcfg, batch=batch,
                variables=variables, state=state, one=one, control=control,
                ranks=ranks, key=key, sample_key=sample_key)


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('finetune', [True, False], ids=['finetune', 'full'])
def test_points_ranks_take_the_one_process_step(all_runs, finetune, layout):
    runs = all_runs(finetune)
    one, ranks = runs['one'], runs['ranks'][layout]
    dp, sp = LAYOUTS[layout]
    assert [r['layout'] for r in ranks] == [(dp, sp)] * (dp * sp)
    want = one['steps'][0]['tb']
    assert want['loss'] > 0 and want['grad_norm'] > 0
    if not finetune:
        assert want['rpn_loss_reg'] > 0
    noise = _noise(one['grads'])
    if finetune:
        tol = {k: DP_TOL for k in want}
        ptol = {k: DP_TOL for k in one['state']}
    else:
        control = runs['control']
        tol = {k: max(DP_TOL, 2 * _err(control['steps'][0]['tb'][k], v))
               for k, v in want.items()}
        ptol = {k: max(DP_TOL, 2 * e) for k, e in
                _state_errs(control['state'], one['state'], noise).items()}
    for r in ranks:
        got = r['steps'][0]['tb']
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert _err(got[k], v) <= tol[k], (k, got[k], v, tol[k])
        assert r['steps'][0]['collectives'] > 0
        assert r['steps'][0]['launches'] == one['steps'][0]['launches']
    for k, e in _state_errs(ranks[0]['state'], one['state'], noise).items():
        assert e <= ptol[k], (k, e, ptol[k])
    for r in ranks[1:]:
        for k, v in ranks[0]['state'].items():
            assert torch.equal(v, r['state'][k]), (r['rank'], k)
        for k, g in ranks[0]['grads'].items():
            assert (g is None) == (r['grads'][k] is None), k
            assert g is None or torch.equal(g, r['grads'][k]), k
    moved = [k for k in one['state'] if 'running' in k and not torch.equal(
        one['state'][k], runs['state'][k])]
    assert bool(moved) is not finetune


def _jax_mesh_inputs(batch):
    """JAX's (2, 2) (data, points) mesh, the batch placed on it, and the
    shardings of its fields and of what is replicated."""
    from jmodt_tpu.parallel import (batch_sharding, replicated_sharding,
                                    shard_batch)
    m2 = jax_mesh.make_mesh_2d(jax.devices()[:4], sp=2)
    return (shard_batch(batch, m2),
            {k: batch_sharding(m2, k) for k in batch},
            replicated_sharding(m2))


def _jax_points_finetune_step(jcfg, batch, variables, key):
    """JAX `make_train_step` jitted on the (2, 2) mesh with its optimizer
    chain behind a transform that keeps the gradients as its state: (loss
    terms, new params, the gradients)."""
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(record, jax_train_step.make_optimizer(
        jcfg, variables['params'], 1))
    sharded, specs, repl = _jax_mesh_inputs(batch)
    step = jax.jit(jax_train_step.make_train_step(
        jcfg, JaxPointRCNN(jcfg, mode='TRAIN'), tx),
        in_shardings=(repl, specs, repl), out_shardings=(repl, repl))
    state = jax.device_put(jax_train_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables['params'],
        batch_stats=variables['batch_stats'],
        opt_state=tx.init(variables['params'])), repl)
    state, tb = jax.device_get(step(state, sharded,
                                    jax.device_put(key, repl)))
    return tb, state.params, state.opt_state[0]


def _jax_points_step(jcfg, batch, variables, key):
    """(loss terms, new batch statistics, parameter gradients) of one JAX
    TRAIN forward jitted on the (2, 2) mesh, by jax.vjp."""
    model = JaxPointRCNN(jcfg, mode='TRAIN')

    def run(params, batch):
        def losses(params):
            out, upd = model.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                batch['pts_input'], batch['img'], batch['pts_xy'],
                gt_boxes3d=batch['gt_boxes3d'], gt_tids=batch['gt_tids'],
                sample_key=key, train=True, mutable=['batch_stats'])
            loss, tb = jax_train_step.compute_losses(jcfg, out, batch)
            return loss, (tb, upd)

        loss, vjp, (tb, upd) = jax.vjp(losses, params, has_aux=True)
        return tb, upd, vjp(jnp.ones_like(loss))[0]

    sharded, specs, repl = _jax_mesh_inputs(batch)
    return jax.device_get(jax.jit(run, in_shardings=(repl, specs),
                                  out_shardings=repl)(
        jax.device_put(variables['params'], repl), sharded))


@pytest.mark.parametrize('finetune', [True, False], ids=['finetune', 'full'])
def test_points_ranks_match_the_jax_points_step(all_runs, finetune,
                                                monkeypatch):
    runs = all_runs(finetune)
    jcfg, batch, variables = runs['jcfg'], runs['batch'], runs['variables']
    rank = runs['ranks']['2x2'][0]
    got_tb = rank['steps'][0]['tb']
    if finetune:
        monkeypatch.setattr(jax_pointnet2, 'three_nn',
                            _three_nn_kernel_semantics)
        jtb, jparams, jgrads = _jax_points_finetune_step(
            jcfg, batch, variables, runs['key'])
    else:
        with jax.enable_x64(True):
            jtb, upd, jgrads = _jax_points_step(
                jcfg, *_jax_float64(monkeypatch, batch, variables),
                runs['sample_key'])
    assert sorted(got_tb) == sorted(set(jtb) | {'grad_norm'})
    for k, v in jtb.items():
        assert _err(got_tb[k], v) <= LOSS_TOL, k
    want = _flat(jgrads)
    got = {n: (np.zeros(want[n].shape) if g is None else g.double().numpy())
           for n, g in rank['grads'].items()}
    if not finetune:
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
    for k in after:
        if not trains[k]:
            assert torch.equal(after[k], start[k]), k
            assert torch.equal(rank['state'][k].double(), start[k]), k
    _check_params({k: rank['state'][k] for k in after}, after, noise,
                  LOSS_TOL)


# ---------------------------------------------------------------- the CLI

def test_spawned_cli_points_ranks(tmp_path):
    """`python -m jmodt_torch.train --points_parallel 2` over 4 gloo ranks
    (the (2, 2) mesh, through the spawned rank body) trains the
    one-process run: the tensorboard scalars within 1e-5 of scale."""
    argv = _cli(tmp_path / 'ranks', '--points_parallel', '2')
    mesh.spawn(data_parallel.cli_rank, 4, args=(argv,), device='cpu',
               threads=1, points=2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_main.main(_cli(tmp_path / 'one'))
    finally:
        torch.set_num_threads(threads)
    want = _events(tmp_path / 'one' / 'tensorboard')
    got = _events(tmp_path / 'ranks' / 'tensorboard')
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    assert ('train_loss', 2) in [(t, s) for t, s, _ in got]
    for (tag, step, g), (_, _, w) in zip(got, want):
        assert _err(g, w) <= DP_TOL, (tag, step, g, w)
    log = (tmp_path / 'ranks' / 'train.log').read_text()
    assert "(data, points) mesh: {'data': 2, 'points': 2} over 4 ranks" in log
    assert [p.name for p in (tmp_path / 'ranks' / 'ckpt').iterdir()] == [
        'checkpoint_epoch_1.pth']


def test_cli_points_parallel_alone_takes_one_process(tmp_path):
    """With one process (no torchrun, the CPU) the flag trains the
    one-process step, as tools/train.py does on one device, and says so."""
    train_main.main(['--small', '--device', 'cpu', '--epochs', '1',
                     '--synthetic_pairs', '2', '--batch_size', '2',
                     '--points_parallel', '2', '--output_dir',
                     str(tmp_path)])
    log = (tmp_path / 'train.log').read_text()
    assert '--points_parallel 2 with one rank: the one-process step' in log
    assert 'End training' in log
