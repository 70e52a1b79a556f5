"""Random weights from a run's seed, made on the device in one draw.

The benchmark, not the program, makes the weights, and hands the same
tensors to the program and to the reference.  The rules are those of the
port's seeded initialisation: Kaiming-normal weights (std sqrt(2 /
fan_in)), zero biases, identity BatchNorm statistics, the focal-loss prior
-log(99) on the RPN classifier's bias and std 0.001 on the regression
outputs.  One normal draw of every weight at once, on the device, in
float32 (the dtype the parameters are held in)."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from perfbench.reference.models.image_backbone import NonOverlapDeconv
from perfbench.reference.models.layers import BatchNorm


def seeded_state(model: nn.Module, seed: int, device) -> Dict[str,
                                                             torch.Tensor]:
    """A state dict for `model` (any device, `meta` included: only names,
    shapes and module kinds are read) drawn from `seed` on `device`."""
    plan, consts = [], {}
    for name, mod in model.named_modules():
        pre = f'{name}.' if name else ''
        if isinstance(mod, BatchNorm):
            for key, value in (('weight', 1.0), ('bias', 0.0),
                               ('running_mean', 0.0), ('running_var', 1.0)):
                consts[pre + key] = (getattr(mod, key).shape, value)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, NonOverlapDeconv)):
            w = mod.weight
            fan_in = (w.shape[0] if isinstance(mod, NonOverlapDeconv)
                      else w.shape[1]) * math.prod(w.shape[2:])
            std = (0.001 if name.endswith('reg_head.Dense_0')
                   else math.sqrt(2.0 / fan_in))
            plan.append((pre + 'weight', w.shape, std))
            if mod.bias is not None:
                bias = (-math.log((1 - 0.01) / 0.01)
                        if name == 'rpn.cls_head.Dense_0' else 0.0)
                consts[pre + 'bias'] = (mod.bias.shape, bias)
    want = set(model.state_dict())
    covered = set(consts) | {k for k, _, _ in plan}
    if want != covered:
        raise ValueError(f'no rule for {sorted(want - covered)[:5]}')
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(shape) for _, shape, _ in plan)
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for key, shape, std in plan:
        n = math.prod(shape)
        state[key] = (flat[at:at + n] * std).reshape(shape)
        at += n
    for key, (shape, value) in consts.items():
        state[key] = torch.full(tuple(shape), value, device=device)
    return state
