"""The port's depth-to-space (K6's plain version, and the wrapper on CPU
tensors) against the JAX package's Pallas kernel in interpret mode and its
XLA 6-D transpose, on the same numpy tables.

The move is a permutation, so the comparisons are exact; the bias is one
add in the table's dtype, so it is exact too.  The four shapes are the
pyramid levels of tests/test_fused_pyramid.py (k 2, 4, 8, 16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmodt_tpu.ops.pallas.depth_to_space import (depth_to_space_pallas,
                                                 depth_to_space_xla)
from jmodt_torch.ops.depth_to_space import (depth_to_space,
                                            depth_to_space_plain)

LEVELS = ((2, 4, 16, 32), (4, 4, 8, 16), (8, 4, 4, 8), (16, 4, 2, 4))


def _table(seed, b, k, r, h0, w0):
    rng = np.random.RandomState(seed)
    taps = rng.randn(b, h0 * w0, k * k * r).astype(np.float32)
    bias = rng.randn(r).astype(np.float32)
    return taps, bias


@pytest.mark.parametrize('with_bias', [False, True])
@pytest.mark.parametrize('b', [1, 2])
@pytest.mark.parametrize('k,r,h0,w0', LEVELS)
def test_depth_to_space_matches_jax(k, r, h0, w0, b, with_bias):
    taps, bias = _table(k + b, b, k, r, h0, w0)
    xla = np.asarray(depth_to_space_xla(jnp.asarray(taps), k, r, h0, w0))
    pallas = np.asarray(depth_to_space_pallas(jnp.asarray(taps), k, r, h0,
                                              w0, interpret=True))
    np.testing.assert_array_equal(pallas, xla)
    tb = torch.from_numpy(bias) if with_bias else None
    want = xla + bias if with_bias else xla
    got = depth_to_space_plain(torch.from_numpy(taps), k, r, h0, w0, tb)
    assert got.shape == (b, h0 * k * w0 * k, r)
    np.testing.assert_array_equal(got.numpy(), want)
    # a CPU tensor takes the plain version
    np.testing.assert_array_equal(
        depth_to_space(torch.from_numpy(taps), k, r, h0, w0, tb).numpy(),
        want)


def test_depth_to_space_bf16_adds_in_bf16():
    """In bfloat16 the bias is added in bfloat16, as the JAX module adds
    it after the move."""
    k, r, h0, w0 = LEVELS[0]
    taps, bias = _table(0, 2, k, r, h0, w0)
    jt = jnp.asarray(taps, jnp.bfloat16)
    want = (depth_to_space_xla(jt, k, r, h0, w0)
            + jnp.asarray(bias, jnp.bfloat16))
    got = depth_to_space_plain(torch.from_numpy(taps).bfloat16(), k, r, h0,
                               w0, torch.from_numpy(bias).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
