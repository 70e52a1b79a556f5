"""The eval frame's CUDA graph sections (jmodt_torch/utils/graphs.py) on
the CPU.

With the real backend a CPU tensor always runs eagerly.  The rest replaces
the backend by a stand-in (`StubGraphs`) that "captures" by running the
section twice, as the side-stream warm-up and the capture do, and
"replays" by running it once more on the static inputs and writing its
output buffer where the capture's lies, so the helper's own logic runs
without a card: which calls stay eager (grad mode, training, a points
region, `eager()`, a training step of the backbone), the signature (a
reallocated weight makes a new one, an in-place load does not), the cap
on signatures, no capture under a profiler, the fresh outputs, the
wrapper launches counted (an eager run's and a capture's, not a warm-up's
or a replay's), the graphs a call replayed, the kernel names a launch is
read from, and the joint step at the small config replayed against
its eager run bit for bit (tools/graph_parity.py's checks).
"""

import copy
import dataclasses

import pytest
import torch
from torch import nn
from torch.utils import _pytree as pytree

from jmodt_torch.config import small_config
from jmodt_torch.ops import kernels
from jmodt_torch.parallel import mesh
from jmodt_torch.tools import graph_parity
from jmodt_torch.utils import graphs


class StubGraph:
    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out


class StubGraphs:
    """CUDA graphs' stand-in on the CPU (the module docstring)."""

    def supports(self, device):
        return True

    def capture(self, fn, args, device):
        with graphs.uncounted():
            fn(*args)
        out = fn(*args)
        return StubGraph(fn, args, out), out

    def replay(self, graph):
        with graphs.uncounted():          # a replay calls no wrapper
            new = pytree.tree_leaves(graph.fn(*graph.args))
        for dst, src in zip(pytree.tree_leaves(graph.out), new):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(3, 2)
        self.calls = 0
        self.section = graphs.Section('tiny', self.body, [self])

    def body(self, x, scale=1.0):
        self.calls += 1
        kernels.launches['tiny'] += 1
        y = self.lin(x) * scale
        return {'y': y, 'x': x, 'pair': (y, y.sum(-1) > 0), 'twice': y,
                'n': 3, 'none': None}


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(graphs, 'backend', StubGraphs())
    kernels.graphs.clear()
    kernels.launches.clear()


def _tiny():
    torch.manual_seed(0)
    return Tiny().eval()


def _same(a, b):
    assert torch.equal(a['y'], b['y']) and torch.equal(a['x'], b['x'])
    assert torch.equal(a['pair'][1], b['pair'][1])
    assert a['n'] == b['n'] == 3 and a['none'] is b['none'] is None


def test_cpu_tensors_run_eager_with_the_card_backend():
    kernels.graphs.clear()
    m = _tiny()
    x = torch.randn(4, 3)
    with torch.no_grad():
        outs = [m.section(x) for _ in range(3)]
        want = m.body(x)
    for out in outs:
        _same(out, want)
    assert kernels.graphs == {'tiny.eager': 3}


@pytest.mark.parametrize('why', ['grad', 'training', 'points_region',
                                 'eager'])
def test_ineligible_calls_run_eager(stub, why):
    m = _tiny()
    if why == 'training':
        m.train()
    x = torch.randn(4, 3)
    ctx = {'grad': torch.enable_grad(), 'training': torch.no_grad(),
           'points_region': mesh.points_region(),
           'eager': graphs.eager()}[why]
    with torch.no_grad(), ctx:
        outs = [m.section(x) for _ in range(3)]
    with torch.no_grad():
        want = m.body(x)
    for out in outs:
        _same(out, want)
    assert kernels.graphs == {'tiny.eager': 3}
    assert m.calls == 4


def test_a_backbone_in_a_training_step_runs_eager(stub):
    from jmodt_torch.models.point_rcnn import build_detector
    cfg = dataclasses.replace(small_config(), DTYPE='float32')
    model = build_detector(cfg, device='cpu', seed=0)
    frame = graph_parity.frames_of(cfg, 1, None, True, (64, 128))[0]
    pts, img, xy = (torch.as_tensor(a) for a in frame[1:])
    img = img.float() / 255.0
    with torch.no_grad():
        outs = [model.rpn.backbone(pts, img, xy, train_step=True)
                for _ in range(3)]
        assert not kernels.graphs
        for _ in range(3):
            got = model.rpn.backbone(pts, img, xy)
    assert kernels.graphs == {'backbone.eager': 1, 'backbone.captures': 1,
                              'backbone.replays': 2}
    for out in outs:
        assert torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])


def test_the_second_call_captures_and_later_calls_replay(stub):
    m = _tiny()
    xs = [torch.randn(4, 3) for _ in range(3)]
    with torch.no_grad():
        outs = [m.section(x, 2.0) for x in xs]
        wants = [m.body(x, 2.0) for x in xs]
    assert kernels.graphs == {'tiny.eager': 1, 'tiny.captures': 1,
                              'tiny.replays': 2}
    # the replays' outputs are fresh: the second is intact after the third
    for out, want, x in zip(outs, wants, xs):
        _same(out, want)
    out = outs[2]
    assert out['x'] is xs[2]                     # an argument returned
    assert out['twice'] is out['y'] and out['pair'][0] is out['y']
    assert outs[1]['y'].data_ptr() != outs[2]['y'].data_ptr()
    # eager 1, the capture 1 (its warm-up uncounted), the replay none, and
    # the 3 direct calls
    assert kernels.launches['tiny'] == 5


def test_replayed_gathers_the_graphs_replayed_inside(stub):
    m = _tiny()
    x = torch.randn(4, 3)
    with torch.no_grad():
        m.section(x)
        with graphs.replayed() as seen:
            m.section(x)
            m.section(x)
        m.section(x)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert isinstance(seen[0], StubGraph)


def test_a_reallocated_weight_is_a_new_signature(stub):
    m = _tiny()
    x = torch.randn(4, 3)
    with torch.no_grad():
        m.section(x)
        m.section(x)
        m.lin.weight = nn.Parameter(m.lin.weight + 1.0)
        _same(m.section(x), m.body(x))
        assert kernels.graphs['tiny.captures'] == 1
        _same(m.section(x), m.body(x))
        assert kernels.graphs['tiny.captures'] == 2
        m.load_state_dict({'lin.weight': m.lin.weight * 2.0,
                           'lin.bias': m.lin.bias - 1.0})
        _same(m.section(x), m.body(x))
    assert kernels.graphs == {'tiny.eager': 2, 'tiny.captures': 2,
                              'tiny.replays': 3}


def test_signatures_beyond_the_cap_run_eager(stub):
    m = _tiny()
    sizes = range(1, graphs.MAX_SIGNATURES + 3)
    with torch.no_grad():
        for _ in range(3):
            for n in sizes:
                x = torch.randn(n, 3)
                _same(m.section(x), m.body(x))
    assert kernels.graphs['tiny.captures'] == graphs.MAX_SIGNATURES
    assert kernels.graphs['tiny.replays'] == 2 * graphs.MAX_SIGNATURES
    assert kernels.graphs['tiny.eager'] == graphs.MAX_SIGNATURES + 3 * 2


def test_no_capture_while_a_profiler_records(stub):
    m = _tiny()
    x = torch.randn(4, 3)
    with torch.no_grad():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            m.section(x)
            m.section(x)
        assert kernels.graphs == {'tiny.eager': 2}
        m.section(x)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            m.section(x)
    assert kernels.graphs == {'tiny.eager': 2, 'tiny.captures': 1,
                              'tiny.replays': 2}


def test_a_copied_module_gets_sections_of_its_own(stub):
    m = _tiny()
    x = torch.randn(4, 3)
    with torch.no_grad():
        m.section(x)
        m.section(x)
    twin = copy.deepcopy(m)
    assert twin.section.fn.__self__ is twin
    assert twin.section.modules == [twin]
    assert not twin.section._graphs and not twin.section._seen
    with torch.no_grad():
        _same(twin.section(x), m.body(x))


@pytest.mark.parametrize('case', ['fusion', 'lidar_only', 'lockstep'])
def test_the_joint_step_replayed_is_the_eager_step(stub, case):
    cfg = small_config()
    cfg = dataclasses.replace(cfg, DTYPE='float32', RPN=dataclasses.replace(
        cfg.RPN, MEGA_SA=True))
    if case == 'lidar_only':
        cfg = dataclasses.replace(cfg, LI_FUSION=dataclasses.replace(
            cfg.LI_FUSION, ENABLED=False))
    streams = 2 if case == 'lockstep' else None
    kw = dict(track_k=8, det_score_thresh=0.0, assign='hungarian')
    res = graph_parity.check(cfg, 4, streams, 'cpu', tol=0.0,
                             reset=streams is None, img_hw=(64, 128),
                             joint_kw=kw)
    assert res['failures'] == []
    assert res['tensors'] >= 30 * 4
    # frame 1 eager, frame 2 captured, then replays
    assert res['graphs'][0] == {f'{s}.eager': 1
                                for s in graph_parity.SECTIONS}
    for counts in res['graphs'][2:]:
        assert counts == {f'{s}.replays': 1 for s in graph_parity.SECTIONS}


def test_launches_read_from_kernel_names():
    """`graph_parity.launches_of` counts a wrapper's launches by the CUDA
    function each runs once, its name demangled (a profiler's) or mangled
    (a graph node's); K5's FPS grid is not a K1 launch."""
    names = ['void (anonymous namespace)::fps_cluster_kernel<4>(float '
             'const*, int, int, int, int*)',
             '_ZN12_GLOBAL__N_118sa_consumer_kernelEPKfS1_PKiiiiiiiiPiPfS5_',
             '_ZN12_GLOBAL__N_118fps_cluster_kernelILi8EEEvPKfiiiPi',
             'void fps_batched_kernel<4, 2>(float const*, int, int, int, '
             'int*)',
             'nms_mask_kernel<true>(float const*)', 'nms_scan_kernel(...)',
             'void d2s_kernel<float>(float const*)',
             '_Z10lap_kernelPKfiifPiS1_',
             'void at::native::vectorized_elementwise_kernel<4>(...)',
             'overlap_kernel(...)', '_Z14overlap_kernelv']
    assert graph_parity.launches_of(names) == {
        'fps': 1, 'sa_level': 1, 'fps_batched': 1, 'nms': 1,
        'depth_to_space': 1, 'lap': 1}


def test_ball_query_launches_read_from_kernel_names():
    """The ball-query kernel counts as one `ball_query` launch, mangled or
    demangled, and as no other counter's: no other kernel's name is a
    part of its name."""
    names = ['_ZN46_GLOBAL__N__41e383bc_13_ball_query_cu_0d6f797417ball_'
             'query_kernelEPKfS1_iii10BallScalesii',
             '(anonymous namespace)::ball_query_kernel(float const*, float '
             'const*, int, int, int, BallScales, int, int)']
    assert graph_parity.launches_of(names) == {'ball_query': 2}
    for k in kernels.KERNELS.values():
        if k.symbol != 'ball_query_kernel':
            assert k.symbol not in 'ball_query_kernel'
