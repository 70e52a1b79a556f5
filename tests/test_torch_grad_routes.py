"""The port under autograd against `jax.grad` of the JAX package, on the
CPU, with the same (exported) weights.

The port's kernels K3, K4 and K5 define no backward, so an SA level picks
its path as the JAX package's does (`models/pointnet2.py::sa_route`):
under autograd the whole-level path (K5) falls through to the BN-folded
path, which then runs its plain tensor-op form instead of K4, and the
wrappers refuse a CUDA input that requires grad while grad mode is on.
K6 has a backward (`ops/depth_to_space.py::DepthToSpace`): the inverse
move and the bias sum.  Here:

- `sa_route` against the JAX gate itself, read off which path the JAX
  `SAModuleMSG` takes for every combination of its flags;
- gradients of an RPN SA level (MEGA_SA and FUSED_SA flags), an RCNN SA
  level, `NonOverlapDeconv` and the whole small-config backbone against
  `jax.grad` of the JAX modules called with `train=False,
  under_grad=True`: every parameter's and input's gradient within 1e-4
  of its own scale (largest magnitude), float32;
- the K6 backward's plain twin against autograd of the plain move, bit
  for bit;
- each kernel wrapper refusing an input that requires grad, with the
  device check stubbed to take the kernel's branch (there is no card
  here), and only while grad mode is on.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import jmodt_tpu.ops.pallas.sa_level as jax_pallas_sa_level
from jmodt_tpu.models import backbone as jax_backbone
from jmodt_tpu.models import image_backbone as jax_img
from jmodt_tpu.models import pointnet2 as jax_pointnet2
from jmodt_torch import config as torch_config
from jmodt_torch.models import image_backbone
from jmodt_torch.models.backbone import PointNet2MSG
from jmodt_torch.models.pointnet2 import SAModuleMSG, sa_route
from jmodt_torch.ops import (depth_to_space, fused_sa, interpolate, kernels,
                             sa_level)
from jmodt_torch.weights import (jax_variables_to_state_dict,
                                 load_jax_variables)
from tests.test_torch_models import (_clustered, _randomize_stats,
                                     _three_nn_kernel_semantics)

TOL = 1e-4


def _grad_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cotangent(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _check_param_grads(module, jax_grads):
    """Every parameter of the port's `module` has a gradient within TOL of
    its scale of the JAX one (carried to the port's layouts by the weight
    converter, whose maps are permutations)."""
    want = jax_variables_to_state_dict({'params': jax_grads})
    names = [n for n, _ in module.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert float(want[name].abs().max()) > 0, name
        assert _grad_err(p.grad.numpy(), want[name].numpy()) < TOL, name


# ------------------------------------------------------------ the gate

def _jax_route(monkeypatch, variables, train, under_grad, use_bn, mega,
               fused):
    """The path the JAX SAModuleMSG takes with these flags, read off the
    calls it makes; the backend reads as a TPU, so only the flags gate the
    whole-level kernel, whose calls are stubbed."""
    taken = []
    kw = dict(npoint=8, radii=(0.5,), nsamples=(4,), mlps=((8, 8),))

    def mega_stub(xyz, feats, npoint, *_):
        taken.append('mega')
        b = xyz.shape[0]
        return (jnp.zeros((b, npoint, 3)), jnp.zeros((b, npoint, 8)),
                jnp.zeros((b, npoint), jnp.int32))

    def fused_stub(xyz, feats, new_xyz, idx, layers, use_pallas=None):
        taken.append('fused_plain' if use_pallas is False else 'fused_kernel')
        return jnp.zeros(new_xyz.shape[:2] + (8,))

    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    monkeypatch.setattr(jax_pallas_sa_level, 'sa_level_fused', mega_stub)
    monkeypatch.setattr(jax_pallas_sa_level, 'sa_level_supported',
                        lambda *_: True)
    monkeypatch.setattr(jax_pointnet2, 'fused_sa_eval', fused_stub)
    jmod = jax_pointnet2.SAModuleMSG(use_bn=use_bn, fused_eval=fused,
                                     mega_eval=mega, **kw)
    xyz = np.random.RandomState(0).randn(1, 32, 3).astype(np.float32)
    jmod.apply(variables[use_bn], xyz, None, train, under_grad,
               mutable=['batch_stats'] if train and use_bn else False)
    return taken[0] if taken else 'plain'


@pytest.fixture(scope='module')
def _gate_variables():
    xyz = np.random.RandomState(0).randn(1, 32, 3).astype(np.float32)
    out = {}
    for use_bn in (False, True):
        jmod = jax_pointnet2.SAModuleMSG(npoint=8, radii=(0.5,),
                                         nsamples=(4,), mlps=((8, 8),),
                                         use_bn=use_bn)
        out[use_bn] = jmod.init(jax.random.PRNGKey(0), xyz, None, False)
    return out


@pytest.mark.parametrize('train,under_grad,use_bn,mega,fused',
                         list(itertools.product((False, True), repeat=5)))
def test_sa_route_matches_the_jax_gate(monkeypatch, _gate_variables, train,
                                       under_grad, use_bn, mega, fused):
    want = _jax_route(monkeypatch, _gate_variables, train, under_grad,
                      use_bn, mega, fused)
    assert sa_route(train, under_grad, use_bn, mega, fused) == want


# ------------------------------------------------------ module gradients

def _sa_level_grads(jmod, variables, xyz, feats, cot, tmod, fused, mega):
    """(JAX param grads, JAX feature grad) and the port's module after its
    backward, with its feature gradient."""
    def loss(params, f):
        _, out, _ = jmod.apply({'params': params,
                                'batch_stats': variables['batch_stats']},
                               xyz, f, False, True)
        return jnp.sum(out * cot)

    jgrads, jfeat = jax.grad(loss, argnums=(0, 1))(variables['params'],
                                                   feats)
    f = torch.from_numpy(feats).requires_grad_(True)
    with torch.enable_grad():
        _, out, _ = tmod(torch.from_numpy(xyz), f, fused, mega)
        (out * torch.from_numpy(cot)).sum().backward()
    return jgrads, jfeat, f.grad


@pytest.mark.parametrize('mega,fused', [(True, True), (False, True),
                                        (True, False), (False, False)])
def test_sa_level_grads_match_jax(mega, fused):
    """An RPN-like MSG level: under autograd MEGA_SA falls through to the
    folded path (FUSED_SA) or the unfused one, as in the JAX package."""
    rng = np.random.RandomState(3)
    b, n, c, m = 2, 256, 6, 32
    xyz = _clustered(rng, b, n)
    feats = rng.randn(b, n, c).astype(np.float32)
    kw = dict(npoint=m, radii=(0.5, 1.0), nsamples=(8, 16),
              mlps=((8, 8, 16), (8, 12, 16)))
    jmod = jax_pointnet2.SAModuleMSG(use_xyz=True, use_bn=True,
                                     fused_eval=fused, mega_eval=mega, **kw)
    variables = _randomize_stats(
        jax.jit(lambda k: jmod.init(k, xyz, feats, False))(
            jax.random.PRNGKey(4)), 5)
    tmod = load_jax_variables(SAModuleMSG(cin=c, use_bn=True, **kw),
                              jax.device_get(variables), device='cpu').eval()
    cot = _cotangent((b, m, 32), 6)
    jgrads, jfeat, tfeat = _sa_level_grads(jmod, variables, xyz, feats, cot,
                                           tmod, fused, mega)
    _check_param_grads(tmod, jax.device_get(jgrads))
    assert _grad_err(tfeat.numpy(), jfeat) < TOL


@pytest.mark.parametrize('level', [0, 1])
def test_rcnn_sa_level_grads_match_jax(level):
    """An RCNN SA level of the small config (FUSED_SA): RoI clouds of 32
    points, then of 16 centres."""
    rc = __graft_entry__._small_config().RCNN
    sa = rc.SA_CONFIG
    cin = rc.XYZ_UP_LAYER[-1] if level == 0 else sa.MLPS[level - 1][-1]
    n = rc.NUM_POINTS if level == 0 else sa.NPOINTS[level - 1]
    rng = np.random.RandomState(10 + level)
    b = 8
    xyz = rng.randn(b, n, 3).astype(np.float32) * 0.3
    feats = rng.randn(b, n, cin).astype(np.float32)
    kw = dict(npoint=sa.NPOINTS[level], radii=(sa.RADIUS[level],),
              nsamples=(sa.NSAMPLE[level],), mlps=(tuple(sa.MLPS[level]),))
    jmod = jax_pointnet2.SAModuleMSG(use_xyz=True, use_bn=True,
                                     fused_eval=True, **kw)
    variables = _randomize_stats(
        jax.jit(lambda k: jmod.init(k, xyz, feats, False))(
            jax.random.PRNGKey(12)), 13)
    tmod = load_jax_variables(SAModuleMSG(cin=cin, use_bn=True, **kw),
                              jax.device_get(variables), device='cpu').eval()
    cot = _cotangent((b, sa.NPOINTS[level], sa.MLPS[level][-1]), 14)
    jgrads, jfeat, tfeat = _sa_level_grads(jmod, variables, xyz, feats, cot,
                                           tmod, True, False)
    _check_param_grads(tmod, jax.device_get(jgrads))
    assert _grad_err(tfeat.numpy(), jfeat) < TOL


@pytest.mark.parametrize('k', [2, 4, 8])
def test_non_overlap_deconv_grads_match_jax(k):
    """NonOverlapDeconv's matmul and move (through DepthToSpace and its
    plain backward on the CPU) against the JAX deconv's gradient."""
    rng = np.random.RandomState(k)
    x = rng.randn(2, 3, 5, 6).astype(np.float32)
    jmod = jax_img.NonOverlapDeconv(4, k)
    params = jmod.init(jax.random.PRNGKey(k), x)['params']
    params = dict(params, bias=jnp.asarray(rng.randn(4).astype(np.float32)))
    cot = _cotangent((2, 3 * k, 5 * k, 4), 20 + k)

    def loss(p, xx):
        return jnp.sum(jmod.apply({'params': p}, xx) * cot)

    jgrads, jx = jax.grad(loss, argnums=(0, 1))(params, x)
    tmod = image_backbone.NonOverlapDeconv(6, 4, k)
    sd = jax_variables_to_state_dict(
        {'params': {'NonOverlapDeconv_0': jax.device_get(params)}})
    tmod.load_state_dict({n.split('.', 1)[1]: v for n, v in sd.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    with torch.enable_grad():
        (tmod(tx) * torch.from_numpy(cot)).sum().backward()
    want = jax_variables_to_state_dict(
        {'params': {'NonOverlapDeconv_0': jax.device_get(jgrads)}})
    for name in ('weight', 'bias'):
        assert _grad_err(getattr(tmod, name).grad.numpy(),
                         want['NonOverlapDeconv_0.' + name].numpy()) < TOL
    assert _grad_err(tx.grad.numpy(), jx) < TOL


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_depth_to_space_backward_is_the_inverse_move(dtype):
    """DepthToSpace's backward (space-to-depth and the bias sum, plain
    tensor ops) equals autograd of the plain move, bit for bit."""
    k, r, h0, w0 = 4, 16, 3, 5
    g = torch.Generator().manual_seed(0)
    taps = torch.randn(2, h0 * w0, k * k * r, generator=g).to(dtype)
    bias = torch.randn(r, generator=g).to(dtype)
    cot = torch.randn(2, h0 * k * w0 * k, r, generator=g).to(dtype)
    grads = []
    for fn in (depth_to_space.depth_to_space,
               depth_to_space.depth_to_space_plain):
        t, bb = (taps.clone().requires_grad_(True),
                 bias.clone().requires_grad_(True))
        with torch.enable_grad():
            out = fn(t, k, r, h0, w0, bb)
            out.backward(cot)
        grads.append((out.detach(), t.grad, bb.grad))
    (out, gt, gb), (want_out, want_t, want_b) = grads
    assert torch.equal(out, want_out) and torch.equal(gt, want_t)
    assert torch.equal(gb, cot.float().sum((0, 1)).to(dtype))
    assert torch.allclose(gb.float(), want_b.float(), rtol=1e-2, atol=1e-2)
    with torch.enable_grad():
        out = depth_to_space.depth_to_space(taps.requires_grad_(True), k, r,
                                            h0, w0, bias)
    assert type(out.grad_fn).__name__ == 'DepthToSpaceBackward'


def test_backbone_grads_match_jax(monkeypatch):
    """The small-config backbone (4 SA levels with MEGA_SA and FUSED_SA,
    4 FP levels, LI-Fusion and the image pyramid) under autograd: every
    parameter's gradient against jax.grad of the JAX backbone with
    train=False, under_grad=True.  The JAX 3-NN runs its Pallas kernel in
    interpret mode, the function K3 replaces (tests/test_torch_models.py
    says why).  Level 0 has no features, so its first layer sees only the
    xyz offsets, which the folded path computes as xyz @ W1 - centre @ W1:
    where a ball holds nothing but its centre the true gradient of W1 is
    0 and both packages return float32 rounding noise of the size of
    eps * |xyz| * sum |dh| instead (the unfused path returns 0).  The
    clusters are dense enough (0.1 m) that level-0 balls hold neighbours,
    so the gradient compared is signal."""
    jcfg = __graft_entry__._small_config()
    jcfg = dataclasses.replace(
        jcfg, DTYPE='float32',
        RPN=dataclasses.replace(jcfg.RPN, FUSED_SA=True, MEGA_SA=True))
    tcfg = torch_config._merge(torch_config.Config(),
                               dataclasses.asdict(jcfg))
    rng = np.random.RandomState(30)
    n = jcfg.RPN.NUM_POINTS
    pc = _clustered(rng, 1, n, 0.1)
    img = rng.rand(1, 64, 128, 3).astype(np.float32)
    xy = (rng.rand(1, n, 2) * 2 - 1).astype(np.float32)
    monkeypatch.setattr(jax_pointnet2, 'three_nn',
                        _three_nn_kernel_semantics)
    jmod = jax_backbone.PointNet2MSG(jcfg)
    variables = _randomize_stats(
        jax.jit(lambda k: jmod.init(k, pc, img, xy))(jax.random.PRNGKey(31)),
        32)
    cot = _cotangent((1, n, jcfg.LI_FUSION.IMG_FEATURES_CHANNEL), 33)

    def loss(params):
        _, f = jmod.apply({'params': params,
                           'batch_stats': variables['batch_stats']},
                          pc, img, xy, False, True)
        return jnp.sum(f * cot)

    jgrads = jax.device_get(jax.grad(loss)(variables['params']))
    tmod = load_jax_variables(PointNet2MSG(tcfg), jax.device_get(variables),
                              device='cpu').eval()
    with torch.enable_grad():
        _, f = tmod(torch.from_numpy(pc), torch.from_numpy(img),
                    torch.from_numpy(xy))
        (f * torch.from_numpy(cot)).sum().backward()
    _check_param_grads(tmod, jgrads)


# ------------------------------------------------- wrappers refuse grad

def _k5_call(grad):
    xyz = torch.zeros(2, 64, 3, requires_grad=grad)
    layers = [((torch.zeros(8, 16), torch.zeros(16)),
               (torch.zeros(16, 32), torch.zeros(32)))] * 2
    return lambda: sa_level.sa_level_fused(
        xyz, torch.zeros(2, 64, 5), 16, (0.5, 1.0), (8, 16), layers)


def _k4_call(grad):
    w = torch.eye(2, requires_grad=grad)
    return lambda: fused_sa.grouped_gather_mlp_max(
        torch.ones(1, 4, 2), torch.zeros(1, 3, 4, dtype=torch.int32),
        torch.zeros(1, 3, 2), torch.zeros(2), [(w, torch.zeros(2))])


def _fused_sa_call(grad):
    feats = torch.ones(1, 4, 2, requires_grad=grad)
    layers = [(torch.zeros(5, 2), torch.zeros(2)),
              (torch.eye(2), torch.zeros(2))]
    return lambda: fused_sa.fused_sa_eval(
        torch.zeros(1, 4, 3), feats, torch.zeros(1, 3, 3),
        torch.zeros(1, 3, 4, dtype=torch.int32), layers)


def _k3_call(grad):
    known = torch.arange(12.0).reshape(1, 4, 3).requires_grad_(grad)
    return lambda: interpolate.three_nn(torch.zeros(1, 4, 3), known)


@pytest.mark.parametrize('make,kernel', [
    (_k5_call, 'sa_level_fused (K5)'),
    (_k4_call, 'grouped_gather_mlp_max (K4)'),
    (_fused_sa_call, 'grouped_gather_mlp_max (K4)'),
    (_k3_call, 'three_nn (K3)'),
])
def test_kernel_wrappers_refuse_grad(monkeypatch, make, kernel):
    """With the device check stubbed to take the kernel's branch, each
    wrapper raises a RuntimeError naming its kernel for an input that
    requires grad while grad mode is on.  With grad mode off, or no input
    requiring grad, the same call goes on to the device check (a
    ValueError: these are CPU tensors), so nothing else is gated."""
    monkeypatch.setattr(kernels, 'on_card', lambda t: True)
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match=kernel.replace('(', r'\(')
                           .replace(')', r'\)')):
            make(True)()
        with pytest.raises(ValueError, match='CUDA tensor'):
            make(False)()
    with torch.no_grad():
        with pytest.raises(ValueError, match='CUDA tensor'):
            make(True)()
