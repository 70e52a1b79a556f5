"""Export a port checkpoint to the reference's torch `.pth` format.

    python -m jmodt_torch.tools.export_torch_weights --ckpt FILE --out OUT.pth

The counterpart of `tools/export_torch_weights.py`: a detector trained in
the port (`python -m jmodt_torch.train`, also its `--async_ckpt` files)
loads into the reference codebase (`load_state_dict` on its PointRCNN,
strict for a fusion model, `strict=False` for a lidar-only one).  Writes
{'epoch', 'it', 'model_state', 'optimizer_state': None}.
"""

from __future__ import annotations

import argparse

import torch

from jmodt_torch.train.checkpoint import read_checkpoint_state
from jmodt_torch.weights import export_reference_state


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ckpt', type=str, required=True,
                    help='port checkpoint (.pth; the suffix may be left '
                         'out)')
    ap.add_argument('--out', type=str, required=True,
                    help='output torch checkpoint (.pth)')
    args = ap.parse_args(argv)

    state = read_checkpoint_state(args.ckpt)
    sd = {k: torch.from_numpy(v)
          for k, v in export_reference_state(state['model_state']).items()}
    torch.save({'epoch': state.get('epoch'), 'it': state.get('it'),
                'model_state': sd, 'optimizer_state': None}, args.out)
    print(f'wrote {args.out}: {len(sd)} tensors '
          f'(epoch={state.get("epoch")}, it={state.get("it")})')
    return args.out


if __name__ == '__main__':
    main()
