"""Image files for the datasets, read as ``cv2.imread`` reads them.

``imread`` decodes by content, as ``cv2.imread`` does (a Replica frame named
``frame0000.jpg`` may hold a PNG):

  - PNG is read by this module's own zlib + numpy decoder: 8-bit gray, RGB
    and RGBA and 16-bit gray and RGB, non-interlaced, all five row filters.
    Colour comes back in cv2's BGR order; with ``IMREAD_UNCHANGED`` a 16-bit
    image comes back unchanged (uint16), with ``IMREAD_COLOR`` as 8-bit BGR;
  - anything else (JPEG) goes through ``cv2``, imported when first needed;
    without it the call raises ``ImportError`` naming the file.

``resize_linear`` and ``undistort`` are cv2's, imported when first needed;
``resize_nearest`` is numpy with ``cv2.INTER_NEAREST``'s index rule, and
a resize to the image's own size is the identity. ``write_png`` writes the
8- and 16-bit PNGs this module reads (one chosen row filter), so scenes can
be made on a machine without cv2.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Tuple, Union

import numpy as np

IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}         # PNG colour type -> channels

PathLike = Union[str, Path]


def _cv2(path: PathLike, what: str):
    try:
        import cv2
    except ImportError as err:
        raise ImportError(f"{what} {path} needs cv2, which is not "
                          f"installed") from err
    return cv2


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, H: int, row_bytes: int, bpp: int
              ) -> np.ndarray:
    """Undo the per-row filters; raw (H, 1 + row_bytes) -> (H, row_bytes)
    bytes."""
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG row filter {int(ftype.max())}")
    data = raw[:, 1:]
    if not np.isin(ftype, (3, 4)).any():
        # None / Sub / Up: row by row, each row vectorized
        out = np.empty((H, row_bytes), np.uint8)
        prev = np.zeros(row_bytes, np.uint8)
        for y in range(H):
            row = data[y]
            if ftype[y] == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0,
                                dtype=np.uint8).reshape(-1)
            elif ftype[y] == 2:
                row = row + prev
            out[y] = row
            prev = out[y]
        return out
    # Average / Paeth depend on the reconstructed left, upper and upper-left
    # pixels: walk the anti-diagonals, every pixel of one diagonal at once
    W = row_bytes // bpp
    f = data.reshape(H, W, bpp).astype(np.int32)
    rec = np.zeros((H + 1, W + 1, bpp), np.int32)   # a zero row and column
    for d in range(H + W - 1):
        ys = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        t = ftype[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return rec[1:, 1:].reshape(H, row_bytes).astype(np.uint8)


def _decode_png(blob: bytes, path: PathLike) -> np.ndarray:
    """(H, W) or (H, W, C) in the file's channel order (gray, RGB, RGBA),
    uint8 or uint16."""
    pos, idat, header = 8, [], None
    while pos < len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG colour type {ctype}, bit depth {depth},"
                         f" interlace {interlace} is not supported (8- or "
                         f"16-bit gray / RGB / RGBA, not interlaced)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes, expected "
                         f"{H * (1 + W * bpp)}")
    rows = _unfilter(raw.reshape(H, 1 + W * bpp), H, W * bpp, bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(H, W, ch)
    return img[..., 0] if ch == 1 else img


def write_png(path: PathLike, img: np.ndarray, filter_type: int = 0) -> None:
    """Write a uint8 / uint16 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA
    array (channels in file order, not cv2's BGR) as a PNG whose rows all
    use ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3):
        raise ValueError(f"write_png takes uint8 / uint16 (H, W[, C]); got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    depth = 16 if img.dtype == np.uint16 else 8
    bpp = ch * depth // 8
    rows = (img.astype(">u2") if depth == 16 else img).reshape(H, -1)
    rows = np.ascontiguousarray(rows).view(np.uint8).reshape(H, W * bpp)
    x = rows.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, upleft)}[filter_type]
    filt = ((x - pred) & 255).astype(np.uint8)
    data = np.concatenate([np.full((H, 1), filter_type, np.uint8), filt], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(data.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# cv2-compatible reading and resizing
# ---------------------------------------------------------------------------

def imread(path: PathLike, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread(path, flags)`` for ``IMREAD_COLOR`` and
    ``IMREAD_UNCHANGED``: BGR(A) channel order; PNGs decoded here."""
    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED):
        raise ValueError(f"imread flags {flags}: IMREAD_COLOR (1) or "
                         f"IMREAD_UNCHANGED (-1)")
    blob = Path(path).read_bytes()
    if not blob.startswith(_SIGNATURE):
        cv2 = _cv2(path, "reading")
        img = cv2.imread(str(path), flags)
        if img is None:
            raise ValueError(f"cv2 could not read {path}")
        return img
    img = _decode_png(blob, path)
    if img.ndim == 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    if flags == IMREAD_UNCHANGED:
        return img
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _same_size(img: np.ndarray, size: Tuple[int, int]) -> bool:
    return img.shape[1] == size[0] and img.shape[0] == size[1]


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``; ``size``
    is (width, height). The identity at the image's own size."""
    if _same_size(img, size):
        return img.copy()
    cv2 = _cv2("(in memory)", "resizing an image")
    return cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)`` in numpy:
    source index floor(dst * (1 / (dst_size / src_size))), clamped."""
    if _same_size(img, size):
        return img.copy()
    (w, h), (sh, sw) = size, img.shape[:2]

    def index(n_dst, n_src):
        inv = 1.0 / (n_dst / n_src)
        return np.minimum(np.floor(np.arange(n_dst) * inv).astype(np.int64),
                          n_src - 1)

    return img[index(h, sh)][:, index(w, sw)]


def undistort(img: np.ndarray, K: np.ndarray, dist: np.ndarray
              ) -> np.ndarray:
    """``cv2.undistort``."""
    return _cv2("(in memory)", "undistorting an image").undistort(img, K, dist)
