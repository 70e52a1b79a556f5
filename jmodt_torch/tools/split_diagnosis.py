"""Where a points split's forward departs from one process's.

    python -m jmodt_torch.tools.split_diagnosis [--points 2] [--small]
        [--device cpu]

Runs the float32 RPN forward of a finetune batch of synthetic pairs (4,
seed 310; `Config()`, or the miniature config with `--small`) once in this
process and once on `--points` spawned ranks of a (1, points) mesh (gloo,
all on `--device`), and prints for every backbone module (image blocks,
SA levels, image gathers, attention layers, fusions, FP levels, pyramid)
and the RPN's outputs the largest difference of the ranks' slices,
concatenated in rank order, from the one process's output, of its scale:
0 where the split rounds as one process.  Then, for the products of the
fusion layers at the batch's shapes, the rows of the first 1/2 and 1/4 of
a product's rows that round otherwise than the same rows of the whole
product, for `F.linear` and, at one output, for the row sum that
`layers.dense` takes under `layers.split_invariant()`.  TF32 is off.  Run
it under CUBLAS_WORKSPACE_CONFIG=:0:0 to see cuBLAS without its split of
K by shape and `layers.dense` with its row sum.  Last, on a card, the cost
of the split's image gather (`image_backbone.owned_sample`, its whole-width
map) beside one process's at each of the RPN's gathers, in bfloat16 (the
training dtype): ms and the peak memory a call adds.  Runs on the CUDA
card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch
import torch.nn.functional as F
from torch import nn

from jmodt_torch.config import Config, small_config
from jmodt_torch.data.synthetic import make_pair_batch
from jmodt_torch.device import resolve_device
from jmodt_torch.models.point_rcnn import PointRCNN, build_detector
from jmodt_torch.parallel import mesh
from jmodt_torch.train.train_step import to_device

# backbone modules whose outputs are compared, by attribute name
MODULES = (['img_block_%d' % k for k in range(4)]
           + ['sa_%d' % k for k in range(4)]
           + ['fusion_%d' % k for k in range(4)]
           + ['fp_%d' % k for k in range(4)]
           + ['img_pyramid', 'final_fusion'])
PAIRS, SEED = 4, 310


def finetune_setup(small: bool):
    """(cfg, state, batch): the float32 finetune config and its weights
    (detector seed 0) and a batch of PAIRS pairs."""
    cfg = small_config() if small else Config()
    r = dataclasses.replace
    cfg = r(cfg, DTYPE='float32', RPN=r(cfg.RPN, FIXED=True),
            TRAIN=r(cfg.TRAIN, FINETUNE=True))
    state = build_detector(cfg, mode='TRAIN', device='cpu',
                           seed=0).state_dict()
    batch = make_pair_batch(SEED, cfg, num_pairs=PAIRS,
                            **({'img_hw': (64, 128)} if small else {}))
    return cfg, state, batch


def stage_outputs(device, cfg, state, batch) -> dict:
    """{name: output} of every module of MODULES (an SA level's features,
    an attention layer as 'ia_<k>', the image gathers as 'gather_<i>')
    and the RPN's outputs, for this rank's share of `batch`."""
    import jmodt_torch.models.backbone as backbone
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = PointRCNN(cfg, mode='TRAIN', device='meta').to_empty(device=dev)
    model.load_state_dict(state)
    model.train()
    out = {}
    net = model.rpn.backbone

    def keep(name):
        def hook(mod, inputs, o):
            out[name] = (o[1] if isinstance(o, tuple) else o).float().cpu()
        return hook

    for name in MODULES:
        getattr(net, name).register_forward_hook(keep(name))
    for k in range(4):
        getattr(net, f'fusion_{k}').IALayer_0.register_forward_hook(
            keep(f'ia_{k}'))
    gather = backbone.feature_gather

    def recorded(fmap, xy):
        o = gather(fmap, xy)
        out[f'gather_{sum(k.startswith("gather") for k in out)}'] = (
            o.float().cpu())
        return o

    backbone.feature_gather = recorded
    try:
        b = to_device(mesh.shard_batch(batch), dev)
        with torch.no_grad(), mesh.points_region():
            r = model.rpn(b['pts_input'], b['img'], b['pts_xy'],
                          train_step=True)
    finally:
        backbone.feature_gather = gather
    out['rpn_cls'] = r['rpn_cls'].float().cpu()
    out['features'] = r['backbone_features'].float().cpu()
    return out


def rank_body(device, cfg, state, batch, out_dir) -> None:
    torch.save(stage_outputs(device, cfg, state, batch),
               os.path.join(out_dir, f'rank{mesh.rank()}.pt'))


def stage_errors(one: dict, ranks: list) -> dict:
    """{name: largest |ranks - one| of the one process's scale}."""
    errs = {}
    for name, want in one.items():
        dim = 2 if name.startswith('img_') else 1
        got = torch.cat([r[name] for r in ranks], dim)
        errs[name] = float((got - want).abs().max()
                           / want.abs().max().clamp_min(1e-30))
    return errs


def product_rows(cfg, device) -> list:
    """[(what, rows, K, N, [rows differing at 1/2, 1/4])] for the fusion
    layers' products at the batch's row counts: `F.linear`, and at one
    output also the row sum."""
    dev = torch.device(device)
    g = torch.Generator().manual_seed(0)
    li, sa = cfg.LI_FUSION, cfg.RPN.SA_CONFIG
    out = []
    for k, m in enumerate(sa.NPOINTS):
        rows = 2 * PAIRS * m
        ic, pc = li.IMG_CHANNELS[k + 1], li.POINT_CHANNELS[k]
        for kk, n in ((ic, pc // 4), (pc // 4, 1), (2 * pc, pc)):
            x = torch.randn(rows, kk, generator=g).to(dev)
            w = torch.randn(n, kk, generator=g).to(dev)
            ways = [('linear', lambda x: F.linear(x, w))]
            if n == 1:
                ways.append(('row sum', lambda x: (x * w[0]).sum(
                    -1, keepdim=True)))
            for what, fn in ways:
                whole = fn(x)
                out.append((what, rows, kk, n, [
                    int((fn(x[:rows // s]) != whole[:rows // s]).any(1)
                        .sum()) for s in (2, 4)]))
    return out


def gather_cost(cfg, batch, points: int, device) -> list:
    """[(map shape, points sampled, (ms, MiB) one process, (ms, MiB) rank
    0 of `points`)] for the RPN's image gathers (after each image block,
    then the pyramid's map) at the batch's shapes, in bfloat16: one
    process's `_grid_sample` of the whole map against rank 0's
    `owned_sample` of its band; MiB is the peak memory the call adds."""
    from jmodt_torch.models import image_backbone
    dev = torch.device(device)
    g = torch.Generator().manual_seed(0)
    li, sa = cfg.LI_FUSION, cfg.RPN.SA_CONFIG
    b, h, w = batch['img'].shape[:3]
    shapes = [((b, h >> (k + 1), w >> (k + 1), li.IMG_CHANNELS[k + 1]), m)
              for k, m in enumerate(sa.NPOINTS)]
    shapes.append(((b, h, w, li.IMG_FEATURES_CHANNEL // 4),
                   cfg.RPN.NUM_POINTS))

    def cost(fn):
        fn()
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return (start.elapsed_time(end) / 5,
                (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20)

    out = []
    for shape, n in shapes:
        fmap = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        xy = (torch.rand((shape[0], n, 2), generator=g) * 2 - 1).to(dev)
        wr = shape[2] // points
        band = F.pad(fmap[:, :, :wr + 2], (0, 0, 1, 0))
        with torch.no_grad():
            out.append((shape, n,
                        cost(lambda: image_backbone._grid_sample(fmap, xy)),
                        cost(lambda: image_backbone.owned_sample(
                            band, xy, 0, points))))
        del fmap, xy, band
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--points', type=int, default=2)
    parser.add_argument('--small', action='store_true')
    parser.add_argument('--device', type=str, default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, state, batch = finetune_setup(args.small)
    with tempfile.TemporaryDirectory() as tmp:
        one = stage_outputs(dev, cfg, state, batch)
        mesh.spawn(rank_body, args.points, args=(cfg, state, batch, tmp),
                   device=str(dev) if dev.type == 'cpu' else 'cuda:0',
                   points=args.points)
        ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                            weights_only=True) for r in range(args.points)]
    print(f'(1, {args.points}) ranks vs one process, float32 RPN forward, '
          'largest difference of scale: ' + ', '.join(
              f'{k} {v:.3g}' for k, v in stage_errors(one, ranks).items()),
          flush=True)
    print('rows of 1/2, 1/4 of a product rounding otherwise than the whole'
          ' (CUBLAS_WORKSPACE_CONFIG='
          f'{os.environ.get("CUBLAS_WORKSPACE_CONFIG", "unset")}): '
          + '; '.join(f'{what} {rows}x{k}->{n} {d}'
                      for what, rows, k, n, d in product_rows(cfg, dev)),
          flush=True)
    if dev.type == 'cuda':
        print(f'image gathers, bfloat16, one process vs rank 0 of '
              f'{args.points} (ms a call, MiB of peak memory it adds): '
              + '; '.join(f'{"x".join(map(str, shape))} at {n} points '
                          f'{one[0]:.3f} ms {one[1]:.1f} MiB vs {mine[0]:.3f}'
                          f' ms {mine[1]:.1f} MiB' for shape, n, one, mine in
                          gather_cost(cfg, batch, args.points, dev)),
              flush=True)


if __name__ == '__main__':
    main()
