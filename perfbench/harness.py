"""One run of one cell:

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the program.
Everything particular to a cell is data found by name: the workload in
BENCHMARK.json names its configuration (a file under perfbench/configs/)
and its traffic (perfbench/traffic/<traffic>.json, whose "entry" names
the driver in perfbench/drivers/); the limits of its comparison are in
perfbench/limits/<workload>.json; each per-layer metric is a reader,
perfbench/metrics/<metric>.py.

The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.  No CUDA card (or fewer than the cell
asks for): exit 2 and no result.  JAX, jaxlib, flax or the JAX package
loaded in this process: exit 3 and no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'jmodt_tpu')


def cache_dirs(root: Path) -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    program's own kernels build under build/ there)."""
    os.environ['TORCH_EXTENSIONS_DIR'] = str(root / 'build' /
                                             'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(root / 'build' / 'triton')


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict[str, Any], workload: str) -> bool:
    return 'workloads' not in metric or workload in metric['workloads']


def reader(root: Path, name: str):
    """The `read(ctx)` of perfbench/metrics/<name>.py."""
    path = root / 'perfbench' / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(root: Path, workload: str, seed: int, seconds: float,
              trace: bool, device: str, t0: float,
              bench: Optional[dict] = None) -> SimpleNamespace:
    """Everything a driver needs for one run of `workload`, from the data
    files under `root`."""
    bench = bench if bench is not None else load_json(root /
                                                      'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')
    cell = cells[workload]
    configs = {c['name']: c for c in bench['configs']}
    conf = load_json(root / configs[cell['config']]['file'])
    traffic = load_json(root / 'perfbench' / 'traffic' /
                        f'{cell["traffic"]}.json')
    limits = load_json(root / 'perfbench' / 'limits' / f'{workload}.json')
    return SimpleNamespace(bench=bench, cell=cell, tree=conf['config'],
                           tracker=conf['tracker'], traffic=traffic,
                           limits=limits, seed=seed, seconds=seconds,
                           trace=trace, device=device, t0=t0, root=root)


def run(spec) -> dict:
    """The driver's run of the cell, and its result line's fields."""
    driver = importlib.import_module(
        'perfbench.drivers.' + spec.traffic['entry'])
    out = driver.run_cell(spec)
    bench, name = spec.bench, spec.cell['name']
    metrics = {}
    if not spec.trace:
        for m in bench['end_to_end']:
            if applies(m, name):
                metrics[m['name']] = {'value': out['end_to_end'][m['name']],
                                      'unit': m['unit']}
    else:
        for m in bench['per_layer']:
            if applies(m, name):
                value = reader(spec.root, m['name'])(out['layer'])
                if value is not None:
                    metrics[m['name']] = {'value': value, 'unit': m['unit']}
    return dict(out, metrics=metrics)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog='python3 -m perfbench')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    # one host thread for the program's CPU-side ops: the frame is
    # host-bound, and idle worker threads competing for the shared host's
    # cores widened the runs' spread
    torch.set_num_threads(1)
    bench = load_json(ROOT / 'BENCHMARK.json')
    chips = {w['name']: w['chips'] for w in bench['workloads']}.get(
        args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'perfbench: {args.workload} needs {chips} CUDA card(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    spec = cell_spec(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), 'cuda', t0, bench)
    out = run(spec)
    from perfbench import check
    correct = check.correct(out['checks'])
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': spec.cell['chips'],
              'memory_peak_bytes': int(out['memory_peak_bytes'])}
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': out['metrics'],
              'device': device}
    tr = out['layer'].trace if out['layer'] is not None else None
    if tr is not None:
        device['busy_s'] = tr.busy_s()
        device['window_s'] = tr.window_s
        result['breakdown'] = tr.breakdown()
    bad = forbidden_modules()
    if bad:
        print('perfbench: loaded in this process: ' + ', '.join(bad),
              file=sys.stderr)
        return 3
    result['checks'] = out['checks']
    print(f'perfbench: setup {out["end_to_end"]["setup_s"]:.3f} s, '
          f'{out["attempted"]} stream-frames, the reference check of '
          f'{out["checked"]} frames {out["check_s"]:.3f} s',
          file=sys.stderr)
    for name, c in out['checks'].items():
        ok = math.isfinite(c['value']) and c['value'] <= c['limit']
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r} '
              f'{"ok" if ok else "FAIL"} ({out["checked"]} frames)',
              file=sys.stderr)
    print(json.dumps(result))
    return 0
