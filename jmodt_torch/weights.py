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

A reference PointRCNN checkpoint (the upstream project's `.pth`, whose
`model_state` uses its own module names, `rpn.backbone_net.SA_modules...`)
crosses through the same flax layout: `reference_to_jax_variables` is the
port's copy of `jmodt_tpu/utils/torch_import.py::convert_model_state`
(every reference key must be consumed, or it raises), and
`reference_state_to_state_dict` names the result as the port's
state_dict, which `train/checkpoint.py` loads for any `.pth` in the
reference's names.  Nothing is downloaded: the user supplies the file.
`export_reference_state` goes the other way, a port model or state_dict to
a reference `model_state` (the port's copy of
`jmodt_tpu/utils/torch_import.py::export_model_state`), which
`python -m jmodt_torch.tools.export_torch_weights` writes as a `.pth`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

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


# ---------------------------------------------------------------------------
# Reference checkpoints: reference module names -> the flax-layout tree.

def _np32(x) -> np.ndarray:
    if hasattr(x, 'detach'):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _dense_kernel(w) -> np.ndarray:
    """Conv1d (Cout, Cin, 1) / Conv2d 1x1 (Cout, Cin, 1, 1) / Linear
    (Cout, Cin) -> Dense (Cin, Cout)."""
    w = _np32(w)
    if any(s != 1 for s in w.shape[2:]):
        raise ValueError(f'expected a 1x1 kernel, got shape {w.shape}')
    return w.reshape(w.shape[0], w.shape[1]).T


def _conv_kernel(w) -> np.ndarray:
    """Conv2d (Cout, Cin, kH, kW) -> flax (kH, kW, Cin, Cout)."""
    return np.transpose(_np32(w), (2, 3, 1, 0))


def _deconv_kernel(w) -> np.ndarray:
    """ConvTranspose2d (Cin, Cout, k, k) -> (k, k, Cin, Cout), mirrored."""
    return np.transpose(_np32(w), (2, 3, 0, 1))[::-1, ::-1]


def _set(tree: dict, path: Tuple[str, ...], val: np.ndarray) -> None:
    d = tree
    for p in path[:-1]:
        d = d.setdefault(p, {})
    if path[-1] in d:
        raise ValueError(f'duplicate target leaf {path}')
    d[path[-1]] = val


# ---------------------------------------------------------------------------
# torch-prefix -> (our path template, unit kind) rules.
#
# kinds:
#   pw      conv(+bias)(+bn): PointwiseLayer {Dense_0 [+bias] | +BatchNorm_0}
#   dense   plain Linear / final 1x1 conv with bias -> {kernel, bias}
#   conv    3x3 conv, no bias -> {kernel}
#   deconv  ConvTranspose2d -> NonOverlapDeconv {kernel, bias}
#   bn      standalone BatchNorm -> BatchNorm_0
#
# {0}, {1}, ... substitute the regex groups.
_RULES = [
    # -- RPN backbone: PointNet++ MSG SA levels (backbone.py:100-128) --
    (r'rpn\.backbone_net\.SA_modules\.(\d+)\.mlps\.(\d+)\.layer(\d+)',
     ('rpn', 'backbone', 'sa_{0}', 'mlp_{1}', 'PointwiseLayer_{2}'), 'pw'),
    # -- FP levels --
    (r'rpn\.backbone_net\.FP_modules\.(\d+)\.mlp\.layer(\d+)',
     ('rpn', 'backbone', 'fp_{0}', 'PointwiseMLP_0', 'PointwiseLayer_{1}'),
     'pw'),
    # -- image CNN blocks (BasicBlock: conv1/bn1/conv2, backbone.py:15-30) --
    (r'rpn\.backbone_net\.Img_Block\.(\d+)\.conv1',
     ('rpn', 'backbone', 'img_block_{0}', 'Conv_0'), 'conv'),
    (r'rpn\.backbone_net\.Img_Block\.(\d+)\.bn1',
     ('rpn', 'backbone', 'img_block_{0}', 'BatchNorm_0'), 'bn'),
    (r'rpn\.backbone_net\.Img_Block\.(\d+)\.conv2',
     ('rpn', 'backbone', 'img_block_{0}', 'Conv_1'), 'conv'),
    # -- LI-Fusion blocks, per-level and final (backbone.py:33-89) --
    (r'rpn\.backbone_net\.Fusion_Conv\.(\d+)\.IA_Layer\.conv1',
     ('rpn', 'backbone', 'fusion_{0}', 'IALayer_0', 'PointwiseLayer_0'),
     'pw'),
    (r'rpn\.backbone_net\.Fusion_Conv\.(\d+)\.IA_Layer\.fc([123])',
     ('rpn', 'backbone', 'fusion_{0}', 'IALayer_0', 'Dense_{1-}'), 'dense'),
    (r'rpn\.backbone_net\.Fusion_Conv\.(\d+)',
     ('rpn', 'backbone', 'fusion_{0}', 'PointwiseLayer_0'), 'pw'),
    (r'rpn\.backbone_net\.final_fusion_img_point\.IA_Layer\.conv1',
     ('rpn', 'backbone', 'final_fusion', 'IALayer_0', 'PointwiseLayer_0'),
     'pw'),
    (r'rpn\.backbone_net\.final_fusion_img_point\.IA_Layer\.fc([123])',
     ('rpn', 'backbone', 'final_fusion', 'IALayer_0', 'Dense_{0-}'),
     'dense'),
    (r'rpn\.backbone_net\.final_fusion_img_point',
     ('rpn', 'backbone', 'final_fusion', 'PointwiseLayer_0'), 'pw'),
    # -- image deconv pyramid + 1x1 reduce (backbone.py:130-139) --
    (r'rpn\.backbone_net\.DeConv\.(\d+)',
     ('rpn', 'backbone', 'img_pyramid', 'NonOverlapDeconv_{0}'), 'deconv'),
    (r'rpn\.backbone_net\.image_fusion_conv',
     ('rpn', 'backbone', 'img_pyramid', 'Conv_0'), 'dense_conv'),
    (r'rpn\.backbone_net\.image_fusion_bn',
     ('rpn', 'backbone', 'img_pyramid', 'BatchNorm_0'), 'bn'),
    # -- RPN heads (rpn.py:21-47; Sequential index 1 is a dropout) --
    (r'rpn\.rpn_cls_layer\.0',
     ('rpn', 'cls_head', 'PointwiseLayer_0'), 'pw'),
    (r'rpn\.rpn_cls_layer\.2', ('rpn', 'cls_head', 'Dense_0'), 'dense'),
    (r'rpn\.rpn_reg_layer\.0',
     ('rpn', 'reg_head', 'PointwiseLayer_0'), 'pw'),
    (r'rpn\.rpn_reg_layer\.2', ('rpn', 'reg_head', 'Dense_0'), 'dense'),
    # -- RCNN (rcnn.py:17-76) --
    (r'rcnn_net\.SA_modules\.(\d+)\.mlps\.0\.layer(\d+)',
     ('rcnn', 'sa_{0}', 'mlp_0', 'PointwiseLayer_{1}'), 'pw'),
    (r'rcnn_net\.xyz_up_layer\.layer(\d+)',
     ('rcnn', 'xyz_up', 'PointwiseLayer_{0}'), 'pw'),
    (r'rcnn_net\.merge_down_layer\.layer0',
     ('rcnn', 'merge_down', 'PointwiseLayer_0'), 'pw'),
    (r'rcnn_net\.cls_layer\.0', ('rcnn', 'cls_head', 'PointwiseLayer_0'),
     'pw'),
    (r'rcnn_net\.cls_layer\.2', ('rcnn', 'cls_head', 'PointwiseLayer_1'),
     'pw'),
    (r'rcnn_net\.cls_layer\.3', ('rcnn', 'cls_head', 'Dense_0'), 'dense'),
    (r'rcnn_net\.reg_layer\.0', ('rcnn', 'reg_head', 'PointwiseLayer_0'),
     'pw'),
    (r'rcnn_net\.reg_layer\.2', ('rcnn', 'reg_head', 'PointwiseLayer_1'),
     'pw'),
    (r'rcnn_net\.reg_layer\.3', ('rcnn', 'reg_head', 'Dense_0'), 'dense'),
    (r'rcnn_net\.link_layer\.0',
     ('rcnn', 'link_layer', 'mlp', 'PointwiseLayer_0'), 'pw'),
    (r'rcnn_net\.link_layer\.2',
     ('rcnn', 'link_layer', 'mlp', 'PointwiseLayer_1'), 'pw'),
    (r'rcnn_net\.link_layer\.3',
     ('rcnn', 'link_layer', 'mlp', 'Dense_0'), 'dense'),
    (r'rcnn_net\.se_layer\.0',
     ('rcnn', 'se_layer', 'mlp', 'PointwiseLayer_0'), 'pw'),
    (r'rcnn_net\.se_layer\.2',
     ('rcnn', 'se_layer', 'mlp', 'PointwiseLayer_1'), 'pw'),
    (r'rcnn_net\.se_layer\.3',
     ('rcnn', 'se_layer', 'mlp', 'Dense_0'), 'dense'),
]


def _fill_path(tpl: Tuple[str, ...], groups: Tuple[str, ...]
               ) -> Tuple[str, ...]:
    out = []
    for part in tpl:
        m = re.search(r'\{(\d+)(-?)\}', part)
        if m:
            idx = int(m.group(1))
            val = groups[idx]
            if m.group(2):  # '{i-}': fc1/2/3 -> Dense_0/1/2
                val = str(int(val) - 1)
            part = part[:m.start()] + val + part[m.end():]
        out.append(part)
    return tuple(out)


def reference_to_jax_variables(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Map a reference ``model_state`` dict onto the flax-layout tree
    ``{'params', 'batch_stats'}`` that `load_jax_variables` takes.

    Every key must be consumed (``num_batches_tracked`` aside) — an
    unrecognized key raises, so silent drift between the two models is
    impossible.
    """
    # group torch keys by (rule index, filled target path)
    units: Dict[Tuple[Tuple[str, ...], str], Dict[str, np.ndarray]] = {}
    for key, val in sd.items():
        if key.endswith('num_batches_tracked'):
            continue
        for pat, tpl, kind in _RULES:
            m = re.match(pat + r'\.', key)
            if m:
                path = _fill_path(tpl, m.groups())
                role = key[m.end():]
                unit = units.setdefault((path, kind), {})
                if role in unit:
                    raise ValueError(f'duplicate role {role} for {path}')
                unit[role] = val
                break
        else:
            raise ValueError(f'unrecognized reference key: {key}')

    params: dict = {}
    stats: dict = {}
    for (path, kind), unit in units.items():
        if kind == 'pw':
            # Role spellings vary by module ('conv.weight' + 'bn.bn.*',
            # 'conv1.weight' + 'bn1.*', '0.weight' + '1.*'); resolve by
            # structure: the conv weight is the unique ndim>=2 array, its
            # sibling '.bias' is the conv bias, and the BN roles share a
            # prefix with 'running_mean'.
            (conv_role,) = [r for r in unit if _np32(unit[r]).ndim >= 2]
            w = unit[conv_role]
            cpre = conv_role[:-len('weight')]  # includes trailing '.' or ''
            conv_b = unit.get(cpre + 'bias')
            bn_roles = [r for r in unit if r.endswith('running_mean')]
            _set(params, path + ('Dense_0', 'kernel'), _dense_kernel(w))
            if bn_roles:
                bpre = bn_roles[0][:-len('running_mean')]
                mean = _np32(unit[bpre + 'running_mean'])
                if conv_b is not None:
                    mean = mean - _np32(conv_b)
                _set(params, path + ('BatchNorm_0', 'scale'),
                     _np32(unit[bpre + 'weight']))
                _set(params, path + ('BatchNorm_0', 'bias'),
                     _np32(unit[bpre + 'bias']))
                _set(stats, path + ('BatchNorm_0', 'mean'), mean)
                _set(stats, path + ('BatchNorm_0', 'var'),
                     _np32(unit[bpre + 'running_var']))
            else:
                _set(params, path + ('Dense_0', 'bias'), _np32(conv_b))
        elif kind == 'dense':
            # 'weight'/'bias' (Linear) or 'conv.weight'/'conv.bias' (the
            # Sequential heads' final 1x1 conv)
            w = unit.get('weight', unit.get('conv.weight'))
            b = unit.get('bias', unit.get('conv.bias'))
            _set(params, path + ('kernel',), _dense_kernel(w))
            _set(params, path + ('bias',), _np32(b))
        elif kind == 'dense_conv':  # 1x1 Conv module kept as flax Conv
            _set(params, path + ('kernel',), _conv_kernel(unit['weight']))
            _set(params, path + ('bias',), _np32(unit['bias']))
        elif kind == 'conv':
            _set(params, path + ('kernel',), _conv_kernel(unit['weight']))
        elif kind == 'deconv':
            _set(params, path + ('kernel',), _deconv_kernel(unit['weight']))
            _set(params, path + ('bias',), _np32(unit['bias']))
        elif kind == 'bn':
            _set(params, path + ('scale',), _np32(unit['weight']))
            _set(params, path + ('bias',), _np32(unit['bias']))
            _set(stats, path + ('mean',), _np32(unit['running_mean']))
            _set(stats, path + ('var',), _np32(unit['running_var']))
        else:  # pragma: no cover
            raise AssertionError(kind)

    out: dict = {'params': params}
    if stats:
        out['batch_stats'] = stats
    return out




def is_reference_state(state_dict: Mapping[str, Any]) -> bool:
    """Whether a `model_state` uses the reference's module names."""
    return any(k.startswith(('rpn.backbone_net.', 'rcnn_net.', 'rpn.rpn_'))
               for k in state_dict)


def reference_state_to_state_dict(state_dict: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """A reference `model_state` as the port's state_dict."""
    return jax_variables_to_state_dict(reference_to_jax_variables(state_dict))


# ---------------------------------------------------------------------------
# The port -> a reference state_dict: the exact inverse of the import above.
# The conv-bias-before-BN units get a zero conv bias (the import absorbed it
# into the BN mean, so zero round-trips bit for bit and the reference's
# forward is unchanged).  Keys include num_batches_tracked so the
# reference's `load_state_dict(strict=True)` succeeds.

def _unconv1d(k: np.ndarray) -> np.ndarray:      # (Cin,Cout)->(Cout,Cin,1)
    return np.ascontiguousarray(k.T)[:, :, None]


def _unconv2d(k: np.ndarray) -> np.ndarray:      # (Cin,Cout)->(Cout,Cin,1,1)
    return np.ascontiguousarray(k.T)[:, :, None, None]


def _unlinear(k: np.ndarray) -> np.ndarray:      # (Cin,Cout)->(Cout,Cin)
    return np.ascontiguousarray(k.T)


def _unconv(k: np.ndarray) -> np.ndarray:        # (kH,kW,Cin,Cout) NCHW-back
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _undeconv(k: np.ndarray) -> np.ndarray:      # inverse of _deconv_kernel
    return np.ascontiguousarray(
        np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)))


def jax_variables_to_reference(tree: Mapping[str, Any]
                               ) -> Dict[str, np.ndarray]:
    """A flax-layout ``{'params', 'batch_stats'}`` tree -> a reference
    state_dict of numpy arrays, in the reference's key order.

    Emits only the units present in the tree (a lidar-only tree exports a
    lidar-only state_dict, loadable with strict=False).
    """
    params = tree['params']
    stats = tree.get('batch_stats', {})
    out: Dict[str, np.ndarray] = {}

    def get(d, path):
        for p in path:
            if d is None or p not in d:
                return None
            d = d[p]
        return d

    def bn(prefix, p_sub, s_sub):
        out[prefix + '.weight'] = _np32(p_sub['scale'])
        out[prefix + '.bias'] = _np32(p_sub['bias'])
        out[prefix + '.running_mean'] = _np32(s_sub['mean'])
        out[prefix + '.running_var'] = _np32(s_sub['var'])
        out[prefix + '.num_batches_tracked'] = np.asarray(0, np.int64)

    def pw(our_path, tprefix, rank, spell='pt'):
        """One PointwiseLayer unit (Dense [+ BatchNorm])."""
        sub = get(params, our_path)
        if sub is None:
            return
        k = _np32(sub['Dense_0']['kernel'])
        w = _unconv2d(k) if rank == 4 else _unconv1d(k)
        s_sub = get(stats, our_path + ('BatchNorm_0',))
        if spell == 'pt':
            out[tprefix + '.conv.weight'] = w
            if s_sub is None:
                out[tprefix + '.conv.bias'] = _np32(sub['Dense_0']['bias'])
            else:
                bn(tprefix + '.bn.bn', sub['BatchNorm_0'], s_sub)
        elif spell == 'flat1':   # Fusion conv1 + bn1 (bias absorbed -> 0)
            out[tprefix + '.conv1.weight'] = w
            out[tprefix + '.conv1.bias'] = np.zeros(k.shape[1], np.float32)
            bn(tprefix + '.bn1', sub['BatchNorm_0'], s_sub)
        elif spell == 'seq01':   # IA_Layer conv1 Sequential [Conv1d, BN]
            out[tprefix + '.0.weight'] = w
            out[tprefix + '.0.bias'] = np.zeros(k.shape[1], np.float32)
            bn(tprefix + '.1', sub['BatchNorm_0'], s_sub)
        else:  # pragma: no cover
            raise AssertionError(spell)

    def dense(our_path, tprefix, rank):
        sub = get(params, our_path)
        if sub is None:
            return
        k = _np32(sub['kernel'])
        w = {2: _unlinear, 3: _unconv1d, 4: _unconv2d}[rank](k)
        pre = tprefix + ('' if rank == 2 else '.conv')
        out[pre + '.weight'] = w
        out[pre + '.bias'] = _np32(sub['bias'])

    bb = ('rpn', 'backbone')
    for k in range(8):
        if get(params, bb + (f'sa_{k}',)) is None:
            break
        for i in range(8):
            mlp = get(params, bb + (f'sa_{k}', f'mlp_{i}'))
            if mlp is None:
                break
            for j in range(len(mlp)):
                pw(bb + (f'sa_{k}', f'mlp_{i}', f'PointwiseLayer_{j}'),
                   f'rpn.backbone_net.SA_modules.{k}.mlps.{i}.layer{j}', 4)
    for k in range(8):
        fp = get(params, bb + (f'fp_{k}', 'PointwiseMLP_0'))
        if fp is None:
            break
        for j in range(len(fp)):
            pw(bb + (f'fp_{k}', 'PointwiseMLP_0', f'PointwiseLayer_{j}'),
               f'rpn.backbone_net.FP_modules.{k}.mlp.layer{j}', 4)
    for k in range(8):
        blk = get(params, bb + (f'img_block_{k}',))
        if blk is None:
            break
        t = f'rpn.backbone_net.Img_Block.{k}'
        out[t + '.conv1.weight'] = _unconv(_np32(blk['Conv_0']['kernel']))
        out[t + '.conv2.weight'] = _unconv(_np32(blk['Conv_1']['kernel']))
        bn(t + '.bn1', blk['BatchNorm_0'],
           get(stats, bb + (f'img_block_{k}', 'BatchNorm_0')))
    for k in range(8):
        name, t = (f'fusion_{k}',
                   f'rpn.backbone_net.Fusion_Conv.{k}')
        if get(params, bb + (name,)) is None:
            break
        pw(bb + (name, 'IALayer_0', 'PointwiseLayer_0'),
           t + '.IA_Layer.conv1', 3, spell='seq01')
        for fi in range(3):
            dense(bb + (name, 'IALayer_0', f'Dense_{fi}'),
                  t + f'.IA_Layer.fc{fi + 1}', 2)
        pw(bb + (name, 'PointwiseLayer_0'), t, 3, spell='flat1')
    if get(params, bb + ('final_fusion',)) is not None:
        t = 'rpn.backbone_net.final_fusion_img_point'
        pw(bb + ('final_fusion', 'IALayer_0', 'PointwiseLayer_0'),
           t + '.IA_Layer.conv1', 3, spell='seq01')
        for fi in range(3):
            dense(bb + ('final_fusion', 'IALayer_0', f'Dense_{fi}'),
                  t + f'.IA_Layer.fc{fi + 1}', 2)
        pw(bb + ('final_fusion', 'PointwiseLayer_0'), t, 3, spell='flat1')
    pyr = get(params, bb + ('img_pyramid',))
    if pyr is not None:
        for k in range(8):
            dk = pyr.get(f'NonOverlapDeconv_{k}')
            if dk is None:
                break
            t = f'rpn.backbone_net.DeConv.{k}'
            out[t + '.weight'] = _undeconv(_np32(dk['kernel']))
            out[t + '.bias'] = _np32(dk['bias'])
        out['rpn.backbone_net.image_fusion_conv.weight'] = _unconv(
            _np32(pyr['Conv_0']['kernel']))
        out['rpn.backbone_net.image_fusion_conv.bias'] = _np32(
            pyr['Conv_0']['bias'])
        bn('rpn.backbone_net.image_fusion_bn', pyr['BatchNorm_0'],
           get(stats, bb + ('img_pyramid', 'BatchNorm_0')))
    for head, t in [('cls_head', 'rpn.rpn_cls_layer'),
                    ('reg_head', 'rpn.rpn_reg_layer')]:
        pw(('rpn', head, 'PointwiseLayer_0'), t + '.0', 3)
        dense(('rpn', head, 'Dense_0'), t + '.2', 3)
    for k in range(8):
        mlp = get(params, ('rcnn', f'sa_{k}', 'mlp_0'))
        if mlp is None:
            break
        for j in range(len(mlp)):
            pw(('rcnn', f'sa_{k}', 'mlp_0', f'PointwiseLayer_{j}'),
               f'rcnn_net.SA_modules.{k}.mlps.0.layer{j}', 4)
    for j in range(2):
        pw(('rcnn', 'xyz_up', f'PointwiseLayer_{j}'),
           f'rcnn_net.xyz_up_layer.layer{j}', 4)
    pw(('rcnn', 'merge_down', 'PointwiseLayer_0'),
       'rcnn_net.merge_down_layer.layer0', 4)
    for head, t in [(('rcnn', 'cls_head'), 'rcnn_net.cls_layer'),
                    (('rcnn', 'reg_head'), 'rcnn_net.reg_layer'),
                    (('rcnn', 'link_layer', 'mlp'), 'rcnn_net.link_layer'),
                    (('rcnn', 'se_layer', 'mlp'), 'rcnn_net.se_layer')]:
        pw(head + ('PointwiseLayer_0',), t + '.0', 3)
        pw(head + ('PointwiseLayer_1',), t + '.2', 3)
        dense(head + ('Dense_0',), t + '.3', 3)
    return out


def export_reference_state(model_or_state: Any) -> Dict[str, np.ndarray]:
    """A port model, or its state_dict, as a reference PointRCNN
    `model_state` of numpy arrays: the inverse of
    `reference_state_to_state_dict`, exact.  A lidar-only model exports
    the lidar-only subset."""
    sd = (model_or_state.state_dict()
          if isinstance(model_or_state, torch.nn.Module) else model_or_state)
    return jax_variables_to_reference(state_dict_to_jax_variables(sd))
