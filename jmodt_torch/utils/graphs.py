"""The eval frame's sections replayed as CUDA graphs.

On the card the eval frame is a fixed sequence of launches for fixed
shapes: it reads nothing back to the host (NMS, the assignment and the
Kalman predict run as device loops) and copies nothing from it inside a
section.  Launched one by one from Python it is host-bound (about 2200
launches a fusion frame), so each section is captured once per input
signature and replayed: one `cudaGraphLaunch` where the host launched
hundreds of kernels.  The work is the same: the same kernels and torch
ops, dtypes and data.

`Section(name, fn, modules)` called with `fn`'s arguments (a pytree of
tensors, None and numbers: tuples, NamedTuples, lists and dicts of them):

* runs `fn` eagerly unless every tensor is on a card, grad mode is off,
  none of `modules` is training, the call is outside
  `mesh.points_region()` and outside `eager()`;
* otherwise keys the call by its signature: the arguments' structure,
  numbers, shapes, dtypes and device (the static inputs are contiguous,
  whatever the arguments' strides), the `data_ptr` of every
  parameter and buffer of `modules` (a weight reallocated by `.to()` or
  `load_state_dict(assign=True)` makes a new signature; an in-place load is
  read by the replay), and the process's switches of the op sequence
  (TF32, cuDNN, deterministic algorithms, `kernels.on_card`);
* the first call of a signature runs eagerly (lazy set-up: the kernel
  library, cuDNN's plans, host tables built once); the second copies the
  arguments into static buffers, runs `fn` once on them on a side stream,
  captures it there into the device's one shared memory pool, and
  replays; later calls copy the arguments in (one `_foreach_copy_` a
  dtype) and replay.  No capture starts while a profiler records.
  MAX_SIGNATURES signatures a section are kept; beyond them it runs eagerly.

A replay's outputs are fresh tensors, clones of the graph's outputs, so
they outlive the next replay; an output that is one of the arguments is
that argument, and one tensor returned twice is one tensor.
`kernels.launches` counts the wrapper launches that the section's Python
makes: those of an eager run and of a capture (recorded into the graph,
which the replay after it runs), not those of the side-stream warm-up
before a capture.  A replay calls no wrapper and adds nothing there: the
kernels it launched are its graph's kernel nodes (`replayed()` gathers
the graphs a call replays, which keep their CUDA graph for that;
`tools/graph_parity.graph_kernels` reads them).  `kernels.graphs`
counts '<section>.captures', '.replays' and '.eager'.  Inside a replay
no Python of the section runs: its spans, hooks on its submodules and
patched functions stay silent.  Callers open the section's structural span around
it; tools and tests that need the finer spans or patch the section's
functions run under `eager()`.

A section must not read host data that changes between calls, mutate its
arguments, or make a host read; host tables it needs are built once as
device tensors before its first capture (`proposal.anchor_tensor`).
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils import _pytree as pytree

from jmodt_torch.ops import kernels
from jmodt_torch.parallel import mesh

MAX_SIGNATURES = 4
_EAGER = contextvars.ContextVar('jmodt_graphs_eager', default=False)
_REPLAYED = contextvars.ContextVar('jmodt_graphs_replayed', default=None)
_recording = torch._C._autograd._profiler_enabled

# how a replay gives each output leaf: a clone of the graph's output, the
# argument it is, an earlier output it repeats, or the number it is
_CLONE, _ARG, _DUP, _CONST = range(4)


@contextlib.contextmanager
def eager():
    """Inside, every section runs eagerly: its spans open, its Python and
    its hooks run, as before graphs."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


@contextlib.contextmanager
def replayed():
    """Yields a list that gathers, in order, the graphs replayed inside
    (each a `torch.cuda.CUDAGraph` that keeps its CUDA graph, so a tool
    can read its kernel nodes)."""
    seen: list = []
    token = _REPLAYED.set(seen)
    try:
        yield seen
    finally:
        _REPLAYED.reset(token)


@contextlib.contextmanager
def uncounted():
    """Launches inside are not added to `kernels.launches` (a capture's
    warm-up)."""
    saved = kernels.launches.copy()
    try:
        yield
    finally:
        kernels.launches.clear()
        kernels.launches.update(saved)


class CudaGraphs:
    """Capture and replay with torch's CUDA graphs: one side stream and one
    memory pool a device, shared by every section.  The replays of one
    process are serialized on the caller's stream, and every graph keeps
    its static inputs and outputs alive, so graphs sharing the pool
    overlap only in temporaries that each replay writes before it reads
    them.  A pool whose graphs have all been freed takes no new capture
    (the allocator asserts), so a device then gets a new one."""

    def __init__(self):
        self._pools: Dict[torch.device, Any] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._live: Dict[torch.device, weakref.WeakSet] = {}

    def supports(self, device: torch.device) -> bool:
        return device.type == 'cuda'

    def capture(self, fn: Callable, args: tuple, device: torch.device):
        """(graph, outputs) of `fn(*args)`, warmed up once on the side
        stream (uncounted) and then captured there."""
        live = self._live.setdefault(device, weakref.WeakSet())
        if not live:
            with torch.cuda.device(device):
                self._pools[device] = torch.cuda.graph_pool_handle()
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        side = self._streams[device]
        main = torch.cuda.current_stream(device)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.device(device), torch.cuda.stream(side):
            with uncounted():
                fn(*args)
            graph.capture_begin(pool=self._pools[device])
            try:
                out = fn(*args)
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
            graph.instantiate()
        main.wait_stream(side)
        live.add(graph)
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


backend = CudaGraphs()


def _switches() -> tuple:
    """The process's settings that change a section's op sequence."""
    return (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled,
            torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled(), kernels.on_card)


class _Graph:
    """One captured signature: its graph, static inputs and outputs, and
    how a replay gives each output leaf."""

    def __init__(self, graph, statics: List[torch.Tensor], outs: list,
                 out_spec, plan: List[Tuple[int, Any]]):
        self.graph = graph
        self.outs = outs
        self.out_spec = out_spec
        self.plan = plan
        groups: Dict[torch.dtype, Tuple[List[int], List[torch.Tensor]]] = {}
        for i, t in enumerate(statics):
            if isinstance(t, torch.Tensor):
                idx, dst = groups.setdefault(t.dtype, ([], []))
                idx.append(i)
                dst.append(t)
        self.groups = list(groups.values())

    def run(self, leaves: list):
        for idx, dst in self.groups:
            torch._foreach_copy_(dst, [leaves[i] for i in idx])
        backend.replay(self.graph)
        seen = _REPLAYED.get()
        if seen is not None:
            seen.append(self.graph)
        outs: list = []
        for (kind, ref), t in zip(self.plan, self.outs):
            if kind == _CLONE:
                outs.append(t.clone())
            elif kind == _ARG:
                outs.append(leaves[ref])
            elif kind == _DUP:
                outs.append(outs[ref])
            else:
                outs.append(t)
        return pytree.tree_unflatten(outs, self.out_spec)


class Section:
    """`fn` replayed as CUDA graphs where it may be (the module's
    docstring); `modules` are those whose weights `fn` reads and whose
    training flag keeps it eager."""

    def __init__(self, name: str, fn: Callable,
                 modules: Sequence[Optional[nn.Module]] = ()):
        self.name = name
        self.fn = fn
        self.modules = [m for m in modules if m is not None]
        self._tables: Optional[list] = None
        self._graphs: Dict[tuple, _Graph] = {}
        self._seen: set = set()

    def __deepcopy__(self, memo):
        """A section of the copied modules, with no graph: a graph holds
        the addresses of the originals' weights (and cannot be copied)."""
        return Section(self.name, copy.deepcopy(self.fn, memo),
                       [copy.deepcopy(m, memo) for m in self.modules])

    def _count(self, event: str) -> None:
        kernels.graphs[f'{self.name}.{event}'] += 1

    def _eager(self, args):
        self._count('eager')
        return self.fn(*args)

    def __call__(self, *args):
        if (_EAGER.get() or torch.is_grad_enabled()
                or mesh.in_points_region()
                or any(m.training for m in self.modules)):
            return self._eager(args)
        leaves, spec = pytree.tree_flatten(args)
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        dev = tensors[0].device if tensors else None
        if (dev is None or not backend.supports(dev)
                or any(t.device != dev for t in tensors)):
            return self._eager(args)
        if self._tables is None:
            # the parameter and buffer dicts, read live: a reassigned
            # weight shows up under its name
            self._tables = [d for m in self.modules for sub in m.modules()
                            for d in (sub._parameters, sub._buffers)]
        key = (spec, dev,
               tuple((x.shape, x.dtype) if isinstance(x, torch.Tensor)
                     else x for x in leaves),
               tuple(t.data_ptr() for d in self._tables for t in d.values()
                     if t is not None), _switches())
        graph = self._graphs.get(key)
        if graph is None:
            if key not in self._seen or _recording():
                if (key not in self._seen and len(self._seen)
                        + len(self._graphs) < MAX_SIGNATURES):
                    self._seen.add(key)
                return self._eager(args)
            self._seen.discard(key)
            graph = self._graphs[key] = self._capture(spec, leaves, dev)
            self._count('captures')
        self._count('replays')
        return graph.run(leaves)

    def _capture(self, spec, leaves: list, dev: torch.device) -> _Graph:
        statics = [x.clone(memory_format=torch.contiguous_format)
                   if isinstance(x, torch.Tensor) else x for x in leaves]
        graph, out = backend.capture(
            self.fn, pytree.tree_unflatten(statics, spec), dev)
        outs, out_spec = pytree.tree_flatten(out)
        static_ids = {id(t): i for i, t in enumerate(statics)
                      if isinstance(t, torch.Tensor)}
        first: Dict[int, int] = {}
        plan: List[Tuple[int, Any]] = []
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor):
                plan.append((_CONST, None))
            elif id(t) in static_ids:
                plan.append((_ARG, static_ids[id(t)]))
            elif id(t) in first:
                plan.append((_DUP, first[id(t)]))
            else:
                first[id(t)] = i
                plan.append((_CLONE, None))
        return _Graph(graph, statics, outs, out_spec, plan)
