"""Minimal PNG codec on numpy + zlib: 16-bit grey and 8-bit RGB.

Covers exactly the two image kinds the TUM layout uses (depth: 16-bit
greyscale, meters * 5000; color: 8-bit RGB) plus 8-bit grey and RGBA on
read. The decoder implements all five scanline filters, so it reads files
written by other encoders too; interlaced images are refused. The
encoder writes filter type 0 (none) on every row.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels (0 grey, 2 RGB, 4 grey+alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) uint16 -> 16-bit grey; (H, W, 3) uint8 -> 8-bit RGB."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype == np.uint16:
        ctype, depth = 0, 16
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        ctype, depth = 2, 8
    else:
        raise ValueError(f"unsupported PNG array: shape {img.shape}, "
                         f"dtype {img.dtype}")
    h, w = img.shape[:2]
    rows = img.astype(">u2") if depth == 16 else img
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters; returns (h, stride) uint8."""
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype == 1:  # sub: running sum per byte lane
            lanes = np.zeros(stride + (-stride) % bpp, np.int32)
            lanes[:stride] = line
            cur = (np.cumsum(lanes.reshape(-1, bpp), axis=0).ravel()
                   [:stride]) & 0xFF
        elif ftype in (3, 4):  # average / Paeth: left-dependent, per byte
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) array, uint8 or uint16."""
    if buf[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(data, h, w * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return px.reshape(h, w, ch)[..., 0] if ch == 1 else px.reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
