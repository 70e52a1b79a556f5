"""Move weights between the JAX package's flax variables and the port.

`load_jax_variables(model, variables)` takes the flax tree
{'params': ..., 'batch_stats': ...} as numpy arrays (or anything
`np.asarray` reads) and loads it with `strict=True`;
`export_jax_variables(model)` is its inverse, the port's parameters and
BatchNorm statistics as that tree of numpy arrays.  The port's module names
follow the flax tree, so only the layouts change:

  * Dense kernel (Cin, Cout)                 -> Linear weight (Cout, Cin)
  * Conv kernel HWIO (kH, kW, Cin, Cout)     -> Conv2d weight OIHW
  * NonOverlapDeconv kernel (k, k, Cin, Cout), which the JAX package
    applies spatially mirrored             -> ConvTranspose2d weight
    (Cin, Cout, k, k), flipped on both spatial axes
  * BatchNorm scale / bias / mean / var      -> weight / bias /
    running_mean / running_var
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from jmodt_torch.device import resolve_device


def _leaf(module: str, name: str, value: np.ndarray) -> tuple:
    """(state_dict leaf name, tensor layout) of one flax leaf."""
    if module.startswith('BatchNorm_'):
        return {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
                'var': 'running_var'}[name], value
    if name == 'bias':
        return 'bias', value
    if name != 'kernel':
        raise ValueError(f'unexpected flax leaf {module}/{name}')
    if module.startswith('Dense_'):
        return 'weight', value.T
    if module.startswith('Conv_'):
        return 'weight', np.transpose(value, (3, 2, 0, 1))
    if module.startswith('NonOverlapDeconv_'):
        return 'weight', np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    raise ValueError(f'unexpected flax kernel under {module}')


def jax_variables_to_state_dict(variables: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """The flax tree as the port's state_dict (CPU float32 tensors)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            name, arr = _leaf(path[-1], key, np.asarray(val, np.float32))
            sd['.'.join(path + (name,))] = torch.from_numpy(
                np.array(arr, np.float32, order='C'))    # a writable copy

    for collection in ('params', 'batch_stats'):
        walk(variables.get(collection, {}), ())
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any],
                       device=None) -> torch.nn.Module:
    """Strict-load the flax `variables` into `model` and move it to
    `device` (default: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    model.to(dev)
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model


def _flax_leaf(module: str, name: str, value: np.ndarray) -> tuple:
    """(collection, flax leaf name, flax layout) of one state_dict leaf:
    the inverse of `_leaf`."""
    if module.startswith('BatchNorm_'):
        return {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
                'running_mean': ('batch_stats', 'mean'),
                'running_var': ('batch_stats', 'var')}[name] + (value,)
    if name == 'bias':
        return 'params', 'bias', value
    if module.startswith('Dense_'):
        return 'params', 'kernel', value.T
    if module.startswith('Conv_'):
        return 'params', 'kernel', np.transpose(value, (2, 3, 1, 0))
    if module.startswith('NonOverlapDeconv_'):
        return ('params', 'kernel',
                np.transpose(value, (2, 3, 0, 1))[::-1, ::-1])
    raise ValueError(f'unexpected leaf {module}.{name}')


def state_dict_to_jax_variables(state_dict: Mapping[str, torch.Tensor]
                                ) -> Dict[str, Any]:
    """A port state_dict as the flax tree {'params': ..., 'batch_stats':
    ...} of float32 numpy arrays."""
    out: Dict[str, Any] = {'params': {}, 'batch_stats': {}}
    for key, t in state_dict.items():
        *path, name = key.split('.')
        coll, leaf, arr = _flax_leaf(
            path[-1], name, t.detach().cpu().float().numpy())
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    if not out['batch_stats']:
        del out['batch_stats']
    return out


def export_jax_variables(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of `load_jax_variables`: `model`'s parameters and
    BatchNorm statistics as a flax-layout numpy tree."""
    return state_dict_to_jax_variables(model.state_dict())
