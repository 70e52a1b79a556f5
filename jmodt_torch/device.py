"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None.  Raises when no card is
    present and none was asked for: the port runs on the card unless the
    caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass '
                               'device="cpu" to run on the CPU')
        return torch.device('cuda')
    return torch.device(device)
