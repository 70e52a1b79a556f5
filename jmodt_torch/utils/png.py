"""A PNG reader and writer on the standard library's zlib and numpy.

The port reads KITTI's camera images with this module, so it needs no
image library.  It reads 8-bit, non-interlaced grey (colour type 0), RGB
(2) and RGBA (6) images with any mix of the five row filters, which is what
KITTI's PNGs hold, and raises `ValueError` on anything else (16-bit,
palette, grey + alpha or interlaced images).  The writer emits 8-bit grey,
RGB or RGBA with filter 0 on every row.

The filters Average and Paeth make each byte depend on the one to its left,
so a row cannot be undone in one vector step.  A pixel depends only on its
left, upper and upper-left neighbours, so all pixels of one anti-diagonal
(row + column = k) are independent: `_unfilter` undoes the filters one
anti-diagonal at a time on a skewed copy of the image, H + W - 1 vector
steps, each over every row at once.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError('not a PNG file')
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError('truncated PNG chunk')
        yield kind, body
        pos += 12 + length
        if kind == b'IEND':
            return
    raise ValueError('PNG without IEND')


def _header(body: bytes) -> Tuple[int, int, int]:
    """(height, width, channels) of an IHDR chunk; raises on a format this
    module does not read."""
    w, h, depth, ctype, comp, filt, interlace = struct.unpack('>IIBBBBB',
                                                              body)
    if depth != 8:
        raise ValueError(f'unsupported PNG bit depth {depth}')
    if ctype not in _CHANNELS:
        raise ValueError(f'unsupported PNG colour type {ctype}')
    if comp != 0 or filt != 0:
        raise ValueError('unsupported PNG compression or filter method')
    if interlace != 0:
        raise ValueError('interlaced PNGs are not supported')
    return h, w, _CHANNELS[ctype]


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """(h, 1 + w*c) filtered scanlines -> (h, w, c) uint8 pixels."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f'bad PNG row filter {int(ftype.max())}')
    filt = raw[:, 1:].reshape(h, w, c)
    if not ftype.any():
        return filt.copy()
    # skewed layout: pixel (r, x) sits at q[r + 1, r + x + 2], so its left
    # neighbour is at q[r + 1, k + 1], its upper one at q[r, k + 1] and its
    # upper-left one at q[r, k] (k = r + x); row 0 and columns 0-1 stay 0
    q = np.zeros((h + 1, h + w + 1, c), np.int16)
    f = np.zeros_like(q)
    for r in range(h):
        f[r + 1, r + 2:r + w + 2] = filt[r]
    ft = ftype.astype(np.int16)[:, None]
    for k in range(h + w - 1):
        r0, r1 = max(0, k - w + 1), min(h - 1, k)
        t = ft[r0:r1 + 1]
        a = q[r0 + 1:r1 + 2, k + 1]
        b = q[r0:r1 + 1, k + 1]
        ul = q[r0:r1 + 1, k]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        pred = np.where(t == 1, a, np.where(
            t == 2, b, np.where(t == 3, (a + b) >> 1,
                                np.where(t == 4, paeth, 0))))
        q[r0 + 1:r1 + 2, k + 2] = (f[r0 + 1:r1 + 2, k + 2] + pred) & 255
    rows = np.arange(h)[:, None]
    cols = rows + np.arange(w)[None, :] + 2
    return q[rows + 1, cols].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8: C = 1 (grey), 3 (RGB) or 4 (RGBA)."""
    with open(path, 'rb') as fh:
        data = fh.read()
    shape = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            shape = _header(body)
        elif kind == b'PLTE':
            raise ValueError('palette PNGs are not supported')
        elif kind == b'IDAT':
            idat.append(body)
    if shape is None:
        raise ValueError('PNG without IHDR')
    h, w, c = shape
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError('PNG image data has the wrong size')
    return _unfilter(raw.reshape(h, 1 + w * c), h, w, c)


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's `Image.open(path).convert('RGB')`: grey is
    repeated over the three channels and alpha is dropped."""
    img = read_png(path)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) from the header alone."""
    with open(path, 'rb') as fh:
        head = fh.read(33)
    if head[:8] != _SIGNATURE or head[12:16] != b'IHDR':
        raise ValueError('not a PNG file')
    w, h = struct.unpack('>II', head[16:24])
    return h, w


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write (H, W) or (H, W, C) uint8, C 1, 3 or 4, with filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError('write_png takes uint8 images')
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    with open(path, 'wb') as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype,
                                             0, 0, 0)))
        fh.write(_chunk(b'IDAT', zlib.compress(rows.tobytes(), level)))
        fh.write(_chunk(b'IEND', b''))
