"""A small PNG reader and writer on zlib and numpy.

The port reads colour frames and 16-bit depth maps and writes rendered
frames without PIL or imageio (JAX: data/scannet.py reads colour with PIL
and depth with imageio; utils/visualizer.py writes with imageio).  It
handles what those files are: 8-bit gray, RGB and RGBA and 16-bit gray,
non-interlaced, every scanline filter (0-4).  Arrays are [H, W] for gray
and [H, W, C] otherwise, uint8 or uint16.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the types this module reads and writes
CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode(arr: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W] / [H, W, 3] / [H, W, 4] or uint16 [H, W]
    array.  Every scanline takes filter 2 (Up): one vectorised difference,
    and it compresses natural images about as well as an adaptive choice."""
    arr = np.asarray(arr)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(channels)
    if arr.ndim not in (2, 3) or ctype is None:
        raise ValueError(f"cannot write an array of shape {arr.shape} as PNG")
    if arr.dtype == np.uint8:
        depth = 8
    elif arr.dtype == np.uint16 and channels == 1:
        depth = 16
    else:
        raise ValueError(f"cannot write {arr.dtype} with {channels} "
                         "channels as PNG")
    h, w = arr.shape[:2]
    rows = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]                     # uint8 wraps mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(arr))


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: raw [h, 1 + stride] -> [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:            # Sub: a running sum mod 256 per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:            # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of PNG bytes (see the module docstring for what is
    read); `name` goes into the error messages."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name} is not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{name} has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype) not in ((8, 0), (8, 2), (8, 6), (16, 0)):
        raise ValueError(f"{name}: PNG of bit depth {depth} and colour type "
                         f"{ctype} is not supported (8-bit gray, RGB, RGBA "
                         "and 16-bit gray are)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    channels = CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: image data of {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    px = _unfilter(raw.reshape(h, stride + 1), h, stride, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return px.reshape((h, w) if channels == 1 else (h, w, channels))


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), path)
