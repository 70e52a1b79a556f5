"""The native (C++) point-cloud loader, bound with ctypes; the counterpart
of `jmodt_tpu/native/__init__.py`.

`src/pointcloud.cpp` reads a velodyne `.bin` and, in one pass over its
points, projects them lidar -> rect -> image and keeps those in the image
(and in `PC_AREA_SCOPE`): the numpy path of `data/kitti_dataset.py` in one
loop, in float64.  At first use it is compiled with
`g++ -O3 -shared -fPIC -std=c++17` into `build/` at the repo root, named
by a hash of the source and the flags, in a temporary directory renamed
into place, so processes that build at once (loader processes, test
workers) each see a whole library or none.  Without a compiler the
functions return None with a warning and callers read with numpy.

`loads` counts, per function, the calls served by the library, so a caller
can show that frames went through it.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / 'src' / 'pointcloud.cpp'
_BUILD = Path(__file__).resolve().parents[2] / 'build'
_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

loads: collections.Counter = collections.Counter()

_lib: list = []          # the loaded ctypes.CDLL, once built
_failed: list = []       # the build's error, once it failed


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(' '.join(_FLAGS).encode())
    return _BUILD / f'libjmodt_native_{digest.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the library if it is missing; returns its path.  Raises
    `OSError` (no g++) or `subprocess.CalledProcessError`."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_so = Path(tmp) / out.name
        subprocess.run(['g++', *_FLAGS, '-o', str(tmp_so), str(_SRC)],
                       check=True, capture_output=True)
        os.replace(tmp_so, out)      # atomic: a reader never sees half a file
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None where it cannot be
    built (callers fall back to numpy)."""
    if _lib:
        return _lib[0]
    if _failed:
        return None
    try:
        path = build()
    except (OSError, subprocess.CalledProcessError) as e:
        logger.warning('native build failed (%s); using numpy fallback', e)
        _failed.append(e)
        return None
    lib = ctypes.CDLL(str(path))
    lib.load_velodyne.restype = ctypes.c_int64
    lib.load_velodyne.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.project_and_filter.restype = ctypes.c_int64
    lib.project_and_filter.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    _lib.append(lib)
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def load_velodyne(path: str, max_points: int = 300_000
                  ) -> Optional[np.ndarray]:
    """(N, 4) float32 velodyne points, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty((max_points, 4), np.float32)
    n = lib.load_velodyne(os.fsencode(path), _fptr(buf), max_points)
    if n < 0:
        raise FileNotFoundError(path)
    loads['load_velodyne'] += 1
    return buf[:n].copy()


def project_and_filter(pts_lidar: np.ndarray, v2c: np.ndarray,
                       r0: np.ndarray, p2: np.ndarray, img_shape,
                       scope=None
                       ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """Lidar -> rect -> image projection and the in-image / in-range
    filter in one pass.

    :param pts_lidar: (N, 4) [x, y, z, intensity]
    :param v2c: (3, 4); r0 (3, 3); p2 (3, 4) from Calibration
    :param img_shape: (H, W[, C]) real image extents
    :param scope: ((x0, x1), (y0, y1), (z0, z1)) or None
    :return: (pts_rect (K, 3), intensity (K,), uv (K, 2)), or None without
        the library.
    """
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts_lidar, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f'pts_lidar: expected (N, 4), got {pts.shape}')
    n = pts.shape[0]
    # rect = R0 @ V2C @ [xyz 1]: the 3x4 product once a frame
    v2c_r0 = np.ascontiguousarray(
        np.asarray(r0, np.float64) @ np.asarray(v2c, np.float64))
    p2c = np.ascontiguousarray(np.asarray(p2, np.float64))
    if v2c_r0.shape != (3, 4) or p2c.shape != (3, 4):
        raise ValueError('v2c and p2 must be (3, 4) and r0 (3, 3)')
    scope_arr = None
    scope_ptr = ctypes.POINTER(ctypes.c_double)()
    if scope is not None:
        scope_arr = np.ascontiguousarray(
            np.asarray(scope, np.float64).reshape(6))
        scope_ptr = _dptr(scope_arr)
    out_rect = np.empty((n, 3), np.float32)
    out_int = np.empty((n,), np.float32)
    out_uv = np.empty((n, 2), np.float32)
    k = lib.project_and_filter(
        _fptr(pts), n, _dptr(v2c_r0), _dptr(p2c),
        float(img_shape[0]), float(img_shape[1]), scope_ptr,
        _fptr(out_rect), _fptr(out_int), _fptr(out_uv))
    loads['project_and_filter'] += 1
    return out_rect[:k].copy(), out_int[:k].copy(), out_uv[:k].copy()
