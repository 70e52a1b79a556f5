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


def upload(x, device, dtype=None) -> torch.Tensor:
    """`x` (a tensor, numpy array, number or nested list) as a tensor on
    `device`.  Host data bound for a card goes through pinned memory with
    a non-blocking copy: a plain copy from pageable memory makes the host
    wait for the card's queue to drain, which a frame must not do.  Host
    data is copied into pinned memory first, so the caller may reuse its
    array at once (a tensor already pinned is read when the copy runs)."""
    device = torch.device(device)
    t = torch.as_tensor(x, dtype=dtype)
    if device.type != 'cuda' or t.device.type != 'cpu':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
