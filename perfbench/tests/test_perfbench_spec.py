"""BENCHMARK.json against the contract's form, and what it names against
the files of the benchmark; the imports of the harness and the reference."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'jmodt_tpu'}


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['perfbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    metrics = BENCH['end_to_end'] + BENCH['per_layer']
    for group in (BENCH['configs'], BENCH['workloads'], metrics):
        names = [x['name'] for x in group]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for w in BENCH['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and 1 <= len(w['why']) <= 200
    for m in metrics:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for c in BENCH['configs']:
        assert all(NAME.match(k) for k in c['reduced'])


def _cells_of(metric):
    return metric.get('workloads', [w['name'] for w in BENCH['workloads']])


def test_every_cell_reports_setup_another_and_a_layer():
    for w in BENCH['workloads']:
        e2e = [m['name'] for m in BENCH['end_to_end']
               if w['name'] in _cells_of(m)]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert any(w['name'] in _cells_of(m) for m in BENCH['per_layer'])


def test_each_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
        for cell in _cells_of(m):
            assert cell in _cells_of(e2e[m['moves']]), (m['name'], cell)


def test_everything_named_is_a_file():
    for c in BENCH['configs']:
        assert c['file'].startswith('perfbench/')
        conf = json.loads((REPO / c['file']).read_text())
        assert {'source', 'config', 'tracker', 'reduced', 'assumed'} <= set(
            conf)
    for w in BENCH['workloads']:
        traffic = json.loads((REPO / 'perfbench/traffic' /
                              f'{w["traffic"]}.json').read_text())
        assert (REPO / 'perfbench/drivers' /
                f'{traffic["entry"]}.py').exists()
        limits = json.loads((REPO / 'perfbench/limits' /
                             f'{w["name"]}.json').read_text())
        assert all(v >= 0 for v in limits.values())
    for m in BENCH['per_layer']:
        assert (REPO / 'perfbench/metrics' / f'{m["name"]}.py').exists()


def test_layer_names_agree_within_a_layer():
    by_prefix = {}
    for m in BENCH['per_layer']:
        by_prefix.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, 'attr', '')
              == 'import_module' and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


SOURCES = sorted((REPO / 'perfbench').rglob('*.py'))


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_nothing_imports_jax(path):
    found = {m.split('.')[0] for m in _imports(path)}
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_the_check_compares_whole_top_level_names():
    # the port's name begins with the JAX package's name's letters
    # but is another package
    assert 'jmodt_torch'.split('.')[0] not in FORBIDDEN
    from perfbench import harness
    assert set(harness.FORBIDDEN) == FORBIDDEN


@pytest.mark.parametrize('path', sorted(
    (REPO / 'perfbench/reference').rglob('*.py')), ids=lambda p: str(
        p.relative_to(REPO)))
def test_the_reference_imports_nothing_of_the_program(path):
    found = {m.split('.')[0] for m in _imports(path)}
    assert 'jmodt_torch' not in found and not found & FORBIDDEN
