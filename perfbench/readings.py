"""The readings that the limits of a cell's comparison are set from: the
program over many seeds, the lower-precision control and the planted
faults over a few, in one process on the card, each at the cell's own
size and load.

    python3 -m perfbench.readings --workload fusion.online_s1 \
        --seeds 11 12 ... --control_seeds 21 22 23 \
        [--fault_seeds 31 32 33] [--seconds 2] [--out readings.jsonl]

A program run is a short window of the cell's traffic with its captures
(a training cell: its first steps).  A control run puts the plain
reference in the program's place with its dense, convolution and
deconvolution products rounded to float8 (e4m3, one scale a tensor;
`reference/models/layers.py::mark_fp8`), the step below the
configuration's bfloat16.  A fault run (training cells) plants half of
the batch left out, the loss's mean taken over the rest of the pairs.
Each line printed (and appended to --out) is one run's worst reading of
each number."""

from __future__ import annotations

import argparse
import json
import time

import torch

from perfbench import check, check_train, harness
from perfbench.drivers import joint, train
from perfbench.program import Program, plain_changes


def _control():
    from perfbench.reference.models.layers import mark_fp8
    return dict(program=Program('perfbench.reference'),
                changes=plain_changes('bfloat16'), mark=mark_fp8)


def half_pairs_loss(program: Program):
    """Plant the fault in `program`'s train step: its losses see only the
    first half of the batch's pairs.  Returns the undo."""
    ts = program.train_step
    real = ts.compute_losses

    def fault(cfg, output, batch):
        half = {k: v[:max(1, v.shape[0] // 2)] for k, v in output.items()
                if k.startswith('reid_')}
        return real(cfg, dict(output, **half), batch)

    ts.compute_losses = fault
    return lambda: setattr(ts, 'compute_losses', real)


def joint_readings(spec, seed: int, control: bool, seconds: float) -> dict:
    traffic = dict(spec.traffic)
    if control:
        # the control's plain pipeline is slow: it runs the frames it
        # compares, from the start of the traffic
        traffic['check_span'] = traffic['check_frames'] + 2
    run = joint.JointRun(spec.tree, spec.tracker, traffic, seed,
                         spec.device, **(_control() if control else {}))
    run.warm_up(1)
    at = joint.check_frames(seed, traffic)
    w = joint.window(run, seconds, at, frames=max(at) + 1 if control else 0)
    states = (run.model_state, run.head_state)
    run.close()
    del run
    ref = check.Reference(spec.tree, spec.tracker, *states, spec.device)
    numbers = [ref.compare(c) for c in w['captures']]
    return {k: max(n[k] for n in numbers) for k in check.NAMES}


def train_readings(spec, seed: int, mode: str) -> dict:
    undo = None
    kw = _control() if mode == 'control' else {}
    run = train.TrainRun(spec.tree, spec.traffic, seed, spec.device, **kw)
    if mode == 'fault':
        undo = half_pairs_loss(run.prog)
    try:
        cap = run.first_steps(int(spec.traffic['check_steps']))
    finally:
        if undo is not None:
            undo()
        run.close()
    del run
    ref = check_train.TrainReference(spec.tree, spec.traffic, seed,
                                     spec.device)
    return ref.compare(cap)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control_seeds', type=int, nargs='*', default=[])
    ap.add_argument('--fault_seeds', type=int, nargs='*', default=[])
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    harness.cache_dirs(harness.ROOT)
    if not torch.cuda.is_available():
        raise SystemExit('perfbench.readings needs a CUDA card')
    torch.set_num_threads(1)
    spec = harness.cell_spec(harness.ROOT, args.workload, 0, args.seconds,
                             False, 'cuda', time.perf_counter())
    runs = ([(s, 'program') for s in args.seeds]
            + [(s, 'control') for s in args.control_seeds]
            + [(s, 'fault') for s in args.fault_seeds])
    for seed, mode in runs:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        t0 = time.perf_counter()
        if spec.traffic['entry'] == 'train':
            worst = train_readings(spec, seed, mode)
        elif mode == 'fault':
            raise SystemExit('faults are planted for training cells only')
        else:
            worst = joint_readings(spec, seed, mode == 'control',
                                   args.seconds)
        line = dict(workload=args.workload, seed=seed, mode=mode,
                    seconds=time.perf_counter() - t0, **worst)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(line) + '\n')


if __name__ == '__main__':
    main()
