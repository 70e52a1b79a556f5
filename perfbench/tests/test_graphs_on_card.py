"""The program's eval frame replayed as CUDA graphs against the same frames
run eagerly, on the card (`jmodt_torch/tools/graph_parity.py`): 8 frames of
`make_joint_step` at Config() with RPN.MEGA_SA, fusion and LiDAR-only, the
tracker state reset after 4, and 4 frames of the lockstep step at S = 4.
Integer and boolean outputs (NMS keeps, RoI masks, assignment, track ids)
equal, floats within 1e-4 of their scale, each frame's outputs intact
after the later frames' replays, every section replayed from the second
frame on, no wrapper launch in a replay, and the kernels that ran on the
card in each traced replayed frame equal to the eager frame's launches."""

from __future__ import annotations

import dataclasses

import pytest

TOL = 1e-4


@pytest.mark.card
@pytest.mark.parametrize('case', ['fusion', 'lidar_only', 'lockstep'])
def test_replayed_frames_equal_the_eager_frames(card, case):
    import torch

    from jmodt_torch.config import Config
    from jmodt_torch.tools import graph_parity
    cfg = dataclasses.replace(Config(), DTYPE='bfloat16')
    cfg = dataclasses.replace(cfg, RPN=dataclasses.replace(cfg.RPN,
                                                           MEGA_SA=True))
    if case == 'lidar_only':
        cfg = dataclasses.replace(cfg, LI_FUSION=dataclasses.replace(
            cfg.LI_FUSION, ENABLED=False))
    lockstep = case == 'lockstep'
    with torch.no_grad():
        res = graph_parity.check(cfg, 4 if lockstep else 8,
                                 4 if lockstep else None, 'cuda', TOL,
                                 reset=not lockstep)
    assert res['failures'] == []
    assert any(res['rows_emitted'])


@pytest.mark.card
def test_a_capture_after_every_graph_was_freed(card):
    """Once every graph of the device's memory pool is freed, the next
    capture takes a new pool (the allocator refuses the old one)."""
    import gc

    import torch
    from torch import nn

    from jmodt_torch.utils import graphs
    for _ in range(2):
        lin = nn.Linear(8, 4).cuda().eval()
        section = graphs.Section('probe', lin, [lin])
        x = torch.randn(16, 8, device='cuda')
        with torch.no_grad():
            outs = [section(x) for _ in range(3)]
            want = lin(x)
        for out in outs:
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
        del lin, section, outs
        gc.collect()
