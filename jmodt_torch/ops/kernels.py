"""Build, load and launch the port's hand-written CUDA kernels.

The sources in `jmodt_torch/csrc/*.cu` have a plain C interface.  At first
use on a CUDA tensor they are compiled for Hopper (`sm_90a`), one `nvcc`
per source, all started together, and linked into one shared library under
`build/` at the repo root, named by a hash of the sources; a later process
finds it there.  The library is loaded with `ctypes`: every pointer and the
stream go in as `c_void_p` (ints as `c_int`, floats as `c_float`), every C
entry returns `cudaGetLastError()`, and
`launch` raises if that is not 0.  Kernels launch on the current stream
of their tensors' card and allocate nothing; the wrappers allocate with
`torch.empty`.

`KERNELS` names each kernel once, by its launch counter: its C entry and
argtypes, its source, the device symbol a trace or a CUDA graph shows, and
the JAX function it stands for; the build, `launch`, the graph readers
(`tools/graph_parity.py`) and chip_smoke.py read it there.

`launches` counts, per kernel name, the launches made through `launch`, so
a caller can show that a path went through the kernels; a CUDA graph's
replay calls no wrapper and adds none (its kernels are its graph's kernel
nodes, `utils/graphs.py`).  `graphs` counts, per section of the eval frame, its captures, replays and eager
runs ('<section>.captures', '.replays', '.eager').
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
_BUILD = Path(__file__).resolve().parents[2] / 'build'
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-Xcompiler', '-fPIC')
# flags of one source on top of _NVCC_FLAGS: N1-N3 must round every product
# and sum on its own, as the plain PyTorch versions they are held to do
_FILE_FLAGS = {'nms.cu': ('-fmad=false',), 'tracker.cu': ('-fmad=false',)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Kernel(NamedTuple):
    """One hand-written kernel, as every layer of the port names it."""
    entry: str          # its C entry, declared JMODT_API in `source`
    argtypes: tuple     # the entry's ctypes argtypes, the stream last
    source: str         # the file of jmodt_torch/csrc/ that defines it
    symbol: str         # the CUDA function that one launch runs once, as
                        # a profiler trace and a graph's kernel node name it
    replaces: str       # the JAX package's function it stands for


# every kernel, keyed by its counter (the `launches` key).  K5 ('sa_level')
# also runs K1's FPS grid; N1 ('nms') also runs its mask grid, and
# 'nms_iou' is N1's pair IoU alone, to hold it to the plain IoU on the card
KERNELS = {
    'fps': Kernel('jmodt_fps', (_P, _I, _I, _I, _I, _I, _I, _P, _P),
                  'fps.cu', 'fps_cluster_kernel',
                  'jmodt_tpu/ops/pallas/fps.py:63'),
    'fps_batched': Kernel('jmodt_fps_batched',
                          (_P, _I, _I, _I, _I, _I, _P, _P), 'fps.cu',
                          'fps_batched_kernel',
                          'jmodt_tpu/ops/pallas/fps.py:134'),
    'three_nn': Kernel('jmodt_three_nn',
                       (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
                       'three_nn.cu', 'three_nn_kernel',
                       'jmodt_tpu/ops/pallas/three_nn.py:52'),
    'grouped_gather_mlp_max': Kernel(
        'jmodt_grouped_gather_mlp_max',
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_P),
         ctypes.POINTER(_P), ctypes.POINTER(_I), _P, _P),
        'grouped_gather_mlp.cu', 'grouped_gather_mlp_max_kernel',
        'jmodt_tpu/ops/pallas/grouped_gather_mlp.py:90'),
    'sa_level': Kernel(
        'jmodt_sa_level',
        (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
         ctypes.POINTER(_P), ctypes.POINTER(_P), _P, _P, ctypes.POINTER(_P),
         ctypes.POINTER(_P), ctypes.POINTER(_P), _P, _P, _P, _P, _P),
        'sa_level.cu', 'sa_consumer_kernel',
        'jmodt_tpu/ops/pallas/sa_level.py:364'),
    'depth_to_space': Kernel('jmodt_depth_to_space',
                             (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
                             'depth_to_space.cu', 'd2s_kernel',
                             'jmodt_tpu/ops/pallas/depth_to_space.py:87'),
    # the JAX package's query is plain XLA, no Pallas kernel
    'ball_query': Kernel('jmodt_ball_query',
                         (_P, _P, _I, _I, _I, _I, _P, _P, _I, _I,
                          ctypes.POINTER(_P), _P),
                         'ball_query.cu', 'ball_query_kernel',
                         'jmodt_tpu/ops/grouping.py:107'),
    # the JAX package's device loops, no Pallas kernel either
    'nms': Kernel('jmodt_nms',
                  (_P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P),
                  'nms.cu', 'nms_scan_kernel', 'jmodt_tpu/ops/nms.py:38'),
    'nms_iou': Kernel('jmodt_nms_iou', (_P, _P, _I, _I, _P, _P), 'nms.cu',
                      'nms_iou_kernel', 'jmodt_tpu/ops/rotated_iou.py:271'),
    'lap': Kernel('jmodt_lap', (_P, _I, _I, _I, _F, _P, _P, _P),
                  'tracker.cu', 'lap_kernel',
                  'jmodt_tpu/tracking/device_tracker.py:183'),
    'kalman_predict': Kernel('jmodt_kalman_predict',
                             (_P, _P, _P, _P, _I, _I, _P, _P, _P),
                             'tracker.cu', 'kalman_predict_kernel',
                             'jmodt_tpu/tracking/device_tracker.py:129'),
}
_SOURCES = tuple(dict.fromkeys(k.source for k in KERNELS.values()))
# C signature of every entry: (argtypes); restype is int (cudaError_t)
_SIGNATURES = {'jmodt_fps_max_cluster': (ctypes.POINTER(_I),),
               **{k.entry: k.argtypes for k in KERNELS.values()}}

launches: collections.Counter = collections.Counter()
graphs: collections.Counter = collections.Counter()

_lib: list = []          # the loaded ctypes.CDLL, once built
_max_cluster: list = []  # K1's largest placeable cluster, once queried


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = Path(cuda_home) / 'bin' / 'nvcc'
    return str(path) if path.exists() else 'nvcc'


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in sorted(p.name for p in _CSRC.iterdir()
                       if p.suffix in ('.cu', '.cuh')):
        digest.update(name.encode())
        digest.update((_CSRC / name).read_bytes())
    digest.update(' '.join(_NVCC_FLAGS).encode())
    digest.update(repr(sorted(_FILE_FLAGS.items())).encode())
    return _BUILD / f'libjmodt_kernels_{digest.hexdigest()[:16]}.so'


def build() -> float:
    """Compile the kernels if the library for these sources is missing;
    returns the seconds spent (0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return 0.0
    t0 = time.perf_counter()
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs = [Path(tmp) / (src + '.o') for src in _SOURCES]

        def compile_one(src_obj):
            src, obj = src_obj
            return subprocess.run(
                [nvcc, *_NVCC_FLAGS, *_FILE_FLAGS.get(src, ()), '-c',
                 str(_CSRC / src), '-o', str(obj)],
                capture_output=True, text=True)

        with ThreadPoolExecutor(len(_SOURCES)) as pool:
            results = list(pool.map(compile_one, zip(_SOURCES, objs)))
        for src, res in zip(_SOURCES, results):
            if res.returncode != 0:
                raise RuntimeError(f'nvcc failed on {src}:\n{res.stderr}')
        tmp_so = Path(tmp) / out.name
        res = subprocess.run([nvcc, *_NVCC_FLAGS, '-shared', '-o',
                              str(tmp_so), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc link failed:\n{res.stderr}')
        os.replace(tmp_so, out)      # atomic: a reader never sees half a file
    return time.perf_counter() - t0


def _library() -> ctypes.CDLL:
    if not _lib:
        build()
        lib = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.jmodt_error_string.argtypes = (ctypes.c_int,)
        lib.jmodt_error_string.restype = ctypes.c_char_p
        _lib.append(lib)
    return _lib[0]


def launch(counter: str, *args, device: torch.device) -> None:
    """Call the C entry of kernel `counter` (`KERNELS`) on `device`, the
    card its tensors lie on, and its current stream (appended as the last
    argument), raise on a CUDA error, and count one launch of `counter`.
    The runtime launches on its current device, which need not be `device`
    where one process drives several cards."""
    entry = KERNELS[counter].entry
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = lib.jmodt_error_string(err).decode()
        raise RuntimeError(f'{entry} failed: CUDA error {err} ({msg})')
    launches[counter] += 1


def fps_max_cluster() -> int:
    """The largest cluster of K1 blocks the card can place (16 on an
    H100, else 8, 4, 2 or 1), from `cudaOccupancyMaxActiveClusters`, queried
    once a process."""
    if not _max_cluster:
        lib = _library()
        out = ctypes.c_int(0)
        err = lib.jmodt_fps_max_cluster(ctypes.byref(out))
        if err != 0:
            msg = lib.jmodt_error_string(err).decode()
            raise RuntimeError(f'jmodt_fps_max_cluster failed: CUDA error '
                               f'{err} ({msg})')
        _max_cluster.append(out.value)
    return _max_cluster[0]


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper given `t` takes its kernel (a CUDA tensor) or its
    plain version (a CPU tensor).  Every wrapper asks this, so replacing
    it runs the plain versions on the card too (chip_smoke phase 10)."""
    return t.is_cuda


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if grad mode is on and one of `tensors` requires grad: the
    kernel defines no backward, so its output would carry no gradient.
    Callers under autograd take a differentiable route instead
    (`models/pointnet2.py::sa_route`)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f'{kernel} defines no backward: it takes no input '
                           'that requires grad while grad mode is on')


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: tuple) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` whose shape
    matches `shape` (None entries match any size)."""
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    check_layout(name, t, dtype, shape)


def check_layout(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple) -> None:
    """`check_cuda` without the device check."""
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f'{name}: expected shape {shape}, got '
                         f'{tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
