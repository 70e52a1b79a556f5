"""Checkpoint save and restore (counterpart of
`jmodt_tpu/train/checkpoint.py`).

One `.pth` file holds {'epoch', 'it', 'model_state' (the model's
state_dict), 'optimizer_state' (`Optimizer.state_dict()` or None)}.
Loading is strict, or partial (`strict=False`) as the JAX package's
`load_part_ckpt`: every saved tensor whose name and shape match is restored, the rest of the model
keeps its values, and nothing matching raises.  A partial load is what lets
a detection-only checkpoint start the link / se finetune.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def checkpoint_state(model: torch.nn.Module, optimizer: Any = None,
                     epoch: Optional[int] = None,
                     it: Optional[int] = None) -> dict:
    return {'epoch': epoch, 'it': it,
            'model_state': {k: v.detach().cpu()
                            for k, v in model.state_dict().items()},
            'optimizer_state': (optimizer.state_dict()
                                if optimizer is not None else None)}


def save_checkpoint(state: dict, filename: str) -> str:
    """Write `<filename>.pth`; returns its path."""
    path = filename if filename.endswith('.pth') else filename + '.pth'
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = path + '.tmp'
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(filename: str, model: torch.nn.Module,
                    optimizer: Any = None, strict: bool = True,
                    log: Optional[logging.Logger] = None) -> Tuple[int, int]:
    """Restore the model (strictly, or partially with strict=False) and,
    when given and saved, the optimizer.  Returns (it, epoch); -1 for an
    epoch and 0 for an it the file does not hold."""
    log = log or logger
    path = filename if filename.endswith('.pth') else filename + '.pth'
    state = torch.load(path, map_location='cpu', weights_only=True)
    saved = state.get('model_state') or {}
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

