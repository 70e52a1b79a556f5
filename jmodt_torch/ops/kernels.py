"""Build, load and launch the port's hand-written CUDA kernels.

The sources in `jmodt_torch/csrc/*.cu` have a plain C interface.  At first
use on a CUDA tensor they are compiled for Hopper (`sm_90a`), one `nvcc`
per source, all started together, and linked into one shared library under
`build/` at the repo root, named by a hash of the sources; a later process
finds it there.  The library is loaded with `ctypes`: every pointer and the
stream go in as `c_void_p`, every C entry returns `cudaGetLastError()`, and
`launch` raises if that is not 0.  Kernels launch on PyTorch's current
stream and allocate nothing; the wrappers allocate with `torch.empty`.

`launches` counts, per kernel name, the launches made through `launch`, so
a caller can show that a path went through the kernels.
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

import torch

_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
_BUILD = Path(__file__).resolve().parents[2] / 'build'
_SOURCES = ('fps.cu', 'three_nn.cu', 'grouped_gather_mlp.cu',
            'sa_level.cu', 'depth_to_space.cu')
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-Xcompiler', '-fPIC')

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry: (argtypes); restype is int (cudaError_t)
_SIGNATURES = {
    'jmodt_fps': (_P, _I, _I, _I, _I, _I, _I, _P, _P),
    'jmodt_fps_max_cluster': (ctypes.POINTER(_I),),
    'jmodt_fps_batched': (_P, _I, _I, _I, _I, _I, _P, _P),
    'jmodt_three_nn': (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    'jmodt_grouped_gather_mlp_max': (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, ctypes.POINTER(_P),
                                     ctypes.POINTER(_P), ctypes.POINTER(_I),
                                     _P, _P),
    'jmodt_sa_level': (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                       _P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
                       _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
                       ctypes.POINTER(_P), _P, _P, _P, _P, _P),
    'jmodt_depth_to_space': (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
}

launches: collections.Counter = collections.Counter()

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
                [nvcc, *_NVCC_FLAGS, '-c', str(_CSRC / src), '-o', str(obj)],
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


def launch(counter: str, entry: str, *args) -> None:
    """Call C entry `entry` on the current stream (appended as the last
    argument), raise on a CUDA error, and count one launch of `counter`."""
    lib = _library()
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
