"""Fixtures of the benchmark's own tests (run them with
`python3 -m pytest perfbench/tests -q`; on the card the `card` tests run
too, elsewhere they skip).

`small_root` is a copy of the benchmark's data files with a small cell
added as data alone: the port's small configuration, a small image, a
short pool, on the CPU."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA card; skips '
                            'without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def small_tree(dtype='bfloat16', finetune=False):
    """The port's small configuration on the main path; with `finetune`,
    the link / se finetune of the training cell."""
    from jmodt_torch.config import small_config
    cfg = small_config()
    cfg = dataclasses.replace(cfg, DTYPE=dtype, RPN=dataclasses.replace(
        cfg.RPN, MEGA_SA=True, FIXED=cfg.RPN.FIXED or finetune))
    if finetune:
        cfg = dataclasses.replace(
            cfg, TRAIN=dataclasses.replace(cfg.TRAIN, FINETUNE=True),
            REID=dataclasses.replace(cfg.REID, FG_THRESH=0.0))
    return dataclasses.asdict(cfg)


@pytest.fixture
def small_root(tmp_path):
    """(root, add_cell(name, streams, limits=None)): a benchmark root under
    tmp_path whose BENCHMARK.json and data files are the repo's, to which
    add_cell adds a small cell on the CPU as files and entries only (a
    training cell with streams=None)."""
    root = tmp_path / 'bench'
    (root / 'perfbench').mkdir(parents=True)
    for d in ('configs', 'traffic', 'metrics', 'limits'):
        shutil.copytree(REPO / 'perfbench' / d, root / 'perfbench' / d)
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    conf = json.loads((REPO / 'perfbench/configs/jmodt_fusion.json')
                      .read_text())
    conf['config'] = small_tree()
    (root / 'perfbench/configs/small.json').write_text(json.dumps(conf))
    (root / 'perfbench/configs/small_ft.json').write_text(json.dumps(
        dict(conf, config=small_tree(finetune=True))))
    for name in ('small', 'small_ft'):
        bench['configs'].append({'name': name, 'source': 'small_config',
                                 'file': f'perfbench/configs/{name}.json',
                                 'reduced': [], 'why': 'CPU tests'})

    def add_cell(name, streams, limits=None):
        if streams is None:
            traffic = json.loads((REPO / 'perfbench/traffic/'
                                  'finetune_b4.json').read_text())
            traffic.update(pairs=2, batches=3, image_hw=[64, 128])
        else:
            traffic = json.loads((REPO / 'perfbench/traffic/online_s1.json')
                                 .read_text())
            traffic.update(streams=streams, image_hw=[64, 128],
                           pool_frames=6, check_span=6, check_frames=3,
                           trace_frames=2, warm_frames=2)
        (root / f'perfbench/traffic/{name}.json').write_text(
            json.dumps(traffic))
        bench['workloads'].append({
            'name': name, 'config': 'small' if streams else 'small_ft',
            'traffic': name, 'chips': 1, 'why': 'CPU tests'})
        for m in bench['end_to_end'] + bench['per_layer']:
            if 'workloads' in m and (streams is None) == (
                    'fusion.finetune_b4' in m['workloads']):
                m['workloads'].append(name)
        (root / f'perfbench/limits/{name}.json').write_text(json.dumps(
            limits or {'rpn_err': 1.0, 'rcnn_err': 1.0,
                       'proposal_mismatch': 0, 'detection_mismatch': 0,
                       'track_mismatch': 0}))
        (root / 'BENCHMARK.json').write_text(json.dumps(bench))
        return bench

    return root, add_cell
