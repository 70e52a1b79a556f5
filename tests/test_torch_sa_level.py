"""The port's whole-SA-level op (jmodt_torch/ops/sa_level.py, K5's plain
version on the CPU) against the JAX package's Pallas kernel in interpret
mode and its XLA twin, on the cases of tests/test_sa_level.py; and the
MEGA_SA path of the port's SAModuleMSG and PointNet2MSG.

Tolerances: FPS indices and centres exact.  Pooled features within 1e-4
of their scale against the XLA twin (the same float32 arithmetic in
another order); within 2e-3 against the interpret-mode kernel, whose bf16
hi/lo feature table is the JAX tests' own tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import jmodt_torch.models.pointnet2 as pointnet2
from jmodt_tpu.models import pointnet2 as jax_pointnet2
from jmodt_tpu.ops.pallas.sa_level import sa_level_fused as jax_sa_level
from jmodt_tpu.ops.pallas.sa_level import sa_level_fused_xla
from jmodt_torch import config as torch_config
from jmodt_torch.models.backbone import PointNet2MSG
from jmodt_torch.ops.sa_level import sa_level_fused
from tests.test_sa_level import make_folded
from tests.test_torch_models import _load, _randomize_stats, _rel_err, _t

TOL = 1e-4
KERNEL_TOL = 2e-3


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def _cloud(rng, b, n, cluster):
    if cluster:
        # clustered clouds give empty balls and overfull ones
        centers = rng.randn(b, 8, 3).astype(np.float32) * 4
        pick = rng.randint(0, 8, (b, n))
        return (centers[np.arange(b)[:, None], pick]
                + rng.randn(b, n, 3).astype(np.float32) * 0.1)
    return rng.randn(b, n, 3).astype(np.float32)


def _case(name):
    """(xyz, feats | None, npoint, radii, nsamples, folded) of one case of
    tests/test_sa_level.py."""
    if name.startswith('b'):
        b, cluster = int(name[1]), name.endswith('cluster')
        rng = np.random.RandomState(0 if cluster else 1)
        xyz = _cloud(rng, b, 256, cluster)
        feats = rng.randn(b, 256, 5).astype(np.float32)
        return (xyz, feats, 64, (0.4, 0.8), (4, 8),
                make_folded(rng, 5, ((8, 16), (8, 8))))
    if name == 'no_features':
        rng = np.random.RandomState(2)
        return (rng.randn(1, 128, 3).astype(np.float32), None, 32, (0.5,),
                (4,), make_folded(rng, 0, ((8, 8),)))
    if name == 'empty_balls':
        rng = np.random.RandomState(3)
        xyz = rng.randn(1, 128, 3).astype(np.float32) * 10
        return xyz, None, 32, (1e-4,), (4,), make_folded(rng, 0, ((8, 8),))
    if name == 'overfull_balls':
        rng = np.random.RandomState(4)
        xyz = rng.randn(1, 128, 3).astype(np.float32) * 0.05
        feats = rng.randn(1, 128, 4).astype(np.float32)
        return xyz, feats, 32, (5.0,), (4,), make_folded(rng, 4, ((8, 8),))
    assert name == 'm256'
    rng = np.random.RandomState(5)
    xyz = rng.randn(1, 512, 3).astype(np.float32)
    feats = rng.randn(1, 512, 3).astype(np.float32)
    return (xyz, feats, 256, (0.6, 1.2), (4, 8),
            make_folded(rng, 3, ((8, 8), (8, 16))))


CASES = ['b1', 'b2', 'b1_cluster', 'b2_cluster', 'no_features',
         'empty_balls', 'overfull_balls', 'm256']


def _port(xyz, feats, npoint, radii, nsamples, folded):
    return sa_level_fused(
        _t(xyz), None if feats is None else _t(feats), npoint, radii,
        nsamples, [[(torch.tensor(np.asarray(w)),
                     torch.tensor(np.asarray(b))) for w, b in s]
                   for s in folded])


@pytest.mark.parametrize('case', CASES)
def test_sa_level_matches_xla_twin(case):
    xyz, feats, npoint, radii, nsamples, folded = _case(case)
    got_xyz, got, got_idx = _port(xyz, feats, npoint, radii, nsamples,
                                  folded)
    want_xyz, want, want_idx = sa_level_fused_xla(
        jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
        npoint, radii, nsamples, folded)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) < TOL


@pytest.mark.parametrize('case', CASES)
def test_sa_level_matches_pallas_kernel(case):
    xyz, feats, npoint, radii, nsamples, folded = _case(case)
    got_xyz, got, got_idx = _port(xyz, feats, npoint, radii, nsamples,
                                  folded)
    want_xyz, want, want_idx = jax_sa_level(
        jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
        npoint, radii, nsamples, folded, interpret=True)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_sa_module_mega_path_matches_jax():
    """The port's SAModuleMSG(mega=True) against the JAX module with
    mega_eval on the same weights; on the CPU the JAX module takes its
    fused path, the kernel's XLA twin."""
    rng = np.random.RandomState(6)
    b, n, c, m = 2, 256, 6, 32
    xyz = _cloud(rng, b, n, True)
    feats = rng.randn(b, n, c).astype(np.float32)
    kw = dict(npoint=m, radii=(0.5, 1.0), nsamples=(8, 16),
              mlps=((8, 8, 16), (8, 12, 16)))
    jmod = jax_pointnet2.SAModuleMSG(use_xyz=True, use_bn=True,
                                     fused_eval=True, mega_eval=True, **kw)
    variables = _randomize_stats(
        jax.jit(lambda k: jmod.init(k, xyz, feats, False))(
            jax.random.PRNGKey(1)), 2)
    want_xyz, want_f, want_idx = jmod.apply(variables, xyz, feats, False)
    tmod = _load(pointnet2.SAModuleMSG(cin=c, use_bn=True, **kw), variables)
    got_xyz, got_f, got_idx = tmod(_t(xyz), _t(feats), mega=True)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert _rel_err(got_f.numpy(), want_f) < TOL


@pytest.mark.parametrize('n,routed', [(256, [256, 64, 32, 16]),
                                      (8200, [64, 32, 16])])
def test_backbone_routes_mega_sa_levels(monkeypatch, n, routed):
    """With MEGA_SA every level whose cloud has at most 8192 points goes
    through the whole-level op (levels 1-3 at the default widths), and the
    backbone's output equals the one with MEGA_SA off."""
    base = torch_config._merge(torch_config.Config(), dataclasses.asdict(
        dataclasses.replace(__graft_entry__._small_config(),
                            DTYPE='float32')))
    cfg = dataclasses.replace(
        base, LI_FUSION=dataclasses.replace(base.LI_FUSION, ENABLED=False),
        RPN=dataclasses.replace(base.RPN, NUM_POINTS=n, MEGA_SA=True))
    torch.manual_seed(0)
    model = PointNet2MSG(cfg).eval()
    calls = []
    real = pointnet2.sa_level_fused

    def spy(xyz, *args):
        calls.append(xyz.shape[1])
        return real(xyz, *args)

    monkeypatch.setattr(pointnet2, 'sa_level_fused', spy)
    pc = _t(np.random.RandomState(7).randn(1, n, 3).astype(np.float32) * 3)
    got_xyz, got = model(pc)
    assert calls == routed
    model.cfg = dataclasses.replace(
        cfg, RPN=dataclasses.replace(cfg.RPN, MEGA_SA=False))
    calls.clear()
    want_xyz, want = model(pc)
    assert calls == []
    assert torch.equal(got_xyz, want_xyz)
    assert _rel_err(got.numpy(), want.numpy()) < 1e-6
