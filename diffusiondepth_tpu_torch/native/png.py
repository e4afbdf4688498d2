"""PNG decode and encode without Pillow.

Decoding reads the chunks, checks their CRCs, inflates the IDAT stream
with Python's ``zlib`` and unfilters the scanlines in C++
(``depthops.png_unfilter``). It takes non-interlaced 8-bit grayscale, RGB
and RGBA, and 16-bit grayscale (the KITTI depth maps); any other kind
raises. The result is what ``np.array(PIL.Image.open(path))`` gives: (H, W)
uint8 or uint16 for grayscale, (H, W, 3) or (H, W, 4) uint8 for colour.

Encoding writes gray8, RGB8 and gray16 with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import depthops

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, name)
_COLOR_TYPES = {0: (1, "grayscale"), 2: (3, "RGB"), 3: (1, "palette"),
                4: (2, "grayscale+alpha"), 6: (4, "RGBA")}
_SUPPORTED = {(0, 8), (2, 8), (6, 8), (0, 16)}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    off = 8
    while off + 12 <= len(data):
        (length,) = struct.unpack(">I", data[off:off + 4])
        end = off + 12 + length
        if end > len(data):
            raise ValueError("truncated PNG chunk")
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        off = end
    raise ValueError("PNG file has no IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> numpy pixels (see the module docstring)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype, compression, filt, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"PNG colour type {ctype} is not defined")
    channels, kind = _COLOR_TYPES[ctype]
    if (ctype, depth) not in _SUPPORTED or interlace != 0 or compression or filt:
        raise ValueError(
            f"unsupported PNG: {depth}-bit {kind}, interlace {interlace}; this decoder "
            "takes non-interlaced 8-bit grayscale, RGB or RGBA and 16-bit grayscale")
    if w == 0 or h == 0:
        raise ValueError("PNG image has no pixels")
    bpp = channels * depth // 8
    raw = zlib.decompress(b"".join(idat))
    px = depthops.png_unfilter(raw, h, w * bpp, bpp, depth == 16)
    return px.reshape(h, w) if channels == 1 else px.reshape(h, w, channels)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) uint8 (gray8), (H, W) uint16 (gray16) or (H, W, 3) uint8
    (RGB8) -> PNG bytes, filter 0 on every row."""
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.dtype == np.uint8 and a.ndim == 2:
        ctype, depth, row = 0, 8, a
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        ctype, depth, row = 2, 8, a.reshape(a.shape[0], -1)
    elif a.dtype == np.uint16 and a.ndim == 2:
        ctype, depth, row = 0, 16, a.astype(">u2").view(np.uint8)
    else:
        raise ValueError(f"encode_png takes gray8, gray16 or RGB8, got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(row)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, level))
