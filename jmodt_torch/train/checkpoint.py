"""Checkpoint save and restore (counterpart of
`jmodt_tpu/train/checkpoint.py`).

One `.pth` file holds {'epoch', 'it', 'model_state' (the model's
state_dict), 'optimizer_state' (`Optimizer.state_dict()` or None)}.
Loading is strict, or partial (`strict=False`) as the JAX package's
`load_part_ckpt`: every saved tensor whose name and shape match is restored, the rest of the model
keeps its values, and nothing matching raises.  A partial load is what lets
a detection-only checkpoint start the link / se finetune.

A reference PointRCNN `.pth` (the upstream project's module names) loads
the same way: `read_model_state` translates its `model_state` to the
port's names (`weights.reference_state_to_state_dict`).  `read_head_state`
and `infer_head_arch` read the link / se heads alone, for the tracker.

`AsyncCheckpointWriter` (the counterpart of the JAX package's orbax
writer) writes on one background thread.  The optimizer updates the
parameters in place, so `save` first copies every tensor of the state to
host memory on the calling thread; a step that runs while the file is
written cannot reach it.
"""

from __future__ import annotations

import itertools
import logging
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from jmodt_torch.weights import (is_reference_state,
                                 reference_state_to_state_dict)

logger = logging.getLogger(__name__)


def checkpoint_state(model: torch.nn.Module, optimizer: Any = None,
                     epoch: Optional[int] = None,
                     it: Optional[int] = None) -> dict:
    return {'epoch': epoch, 'it': it,
            'model_state': {k: v.detach().cpu()
                            for k, v in model.state_dict().items()},
            'optimizer_state': (optimizer.state_dict()
                                if optimizer is not None else None)}


def save_checkpoint(state: dict, filename: str, writer: Any = None) -> str:
    """Write `<filename>.pth`, or with an `AsyncCheckpointWriter` have it
    written in the background; returns its path."""
    if writer is not None:
        return writer.save(state, filename)
    path = _pth(filename)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = path + '.tmp'
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def _host_copy(obj: Any) -> Any:
    """`obj` with every tensor copied to host memory (a new tensor, also
    for one already there)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class AsyncCheckpointWriter:
    """Writes checkpoints on one background thread, in the order they were
    saved.  `save` returns once the state is copied to host memory;
    `wait` blocks until every file is written and raises the first
    failure; `close` waits and stops the thread."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix='ckpt')
        self._pending: List[Future] = []

    def save(self, state: dict, filename: str) -> str:
        snapshot = _host_copy(state)
        self._pending.append(self._pool.submit(save_checkpoint, snapshot,
                                               filename))
        return _pth(filename)

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def load_checkpoint(filename: str, model: torch.nn.Module,
                    optimizer: Any = None, strict: bool = True,
                    log: Optional[logging.Logger] = None) -> Tuple[int, int]:
    """Restore the model (strictly, or partially with strict=False) and,
    when given and saved, the optimizer.  Returns (it, epoch); -1 for an
    epoch and 0 for an it the file does not hold."""
    log = log or logger
    state = _read(filename)
    saved = _port_names(state.get('model_state') or {})
    if strict:
        model.load_state_dict(saved, strict=True)
    else:
        own = model.state_dict()
        match = {k: v for k, v in saved.items()
                 if k in own and own[k].shape == v.shape}
        if not match:
            raise RuntimeError(f'no keys restored from {filename}')
        missing = sorted(set(own) - set(match))
        unexpected = sorted(set(saved) - set(match))
        if missing:
            log.info('missing keys (%d): %s', len(missing), missing[:20])
        if unexpected:
            log.info('unexpected keys (%d): %s', len(unexpected),
                     unexpected[:20])
        model.load_state_dict(match, strict=False)
    if optimizer is not None and state.get('optimizer_state'):
        optimizer.load_state_dict(state['optimizer_state'])
    epoch = state['epoch'] if state.get('epoch') is not None else -1
    it = state['it'] if state.get('it') is not None else 0
    return int(it), int(epoch)


def _pth(filename: str) -> str:
    return filename if filename.endswith('.pth') else filename + '.pth'


def _read(filename: str) -> dict:
    return torch.load(_pth(filename), map_location='cpu', weights_only=True)


def _port_names(saved: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return (reference_state_to_state_dict(saved)
            if is_reference_state(saved) else saved)


def read_checkpoint_state(filename: str) -> dict:
    """The file's state, its `model_state` under the port's names (CPU
    tensors)."""
    state = _read(filename)
    return dict(state, model_state=_port_names(state.get('model_state')
                                               or {}))


def read_model_state(filename: str) -> Dict[str, torch.Tensor]:
    """The file's `model_state` under the port's names (CPU tensors)."""
    return read_checkpoint_state(filename)['model_state']


def read_head_state(filename: str
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """The link and se heads' state_dicts alone, keyed as a
    `CorrelationHead`'s own (reference keeps them under
    rcnn_net.{link,se}_layer)."""
    sd = read_model_state(filename)
    heads = []
    for name in ('link_layer', 'se_layer'):
        pre = f'rcnn.{name}.'
        head = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        if not head:
            raise KeyError(f'{filename} holds no rcnn.{name}')
        heads.append(head)
    return heads[0], heads[1]


def infer_head_arch(head_state: Dict[str, torch.Tensor]
                    ) -> Tuple[int, Tuple[int, ...], bool]:
    """(input width, hidden widths, use_bn) of a `CorrelationHead` from its
    own state_dict, so the tracker does not depend on the training-time
    config."""
    cin = int(head_state['mlp.PointwiseLayer_0.Dense_0.weight'].shape[1])
    hidden = []
    use_bn = False
    for i in itertools.count():
        w = head_state.get(f'mlp.PointwiseLayer_{i}.Dense_0.weight')
        if w is None:
            break
        hidden.append(int(w.shape[0]))
        use_bn = use_bn or any(k.startswith(f'mlp.PointwiseLayer_{i}.'
                                            'BatchNorm_0.')
                               for k in head_state)
    return cin, tuple(hidden), use_bn
