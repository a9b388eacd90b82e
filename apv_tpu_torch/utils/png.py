"""A PNG encoder for 8-bit grayscale (L) and RGB images, on ``zlib`` and
``struct`` only.

It writes what Pillow's ``Image.save(..., format="PNG")`` writes for such
an image: the signature, IHDR, one IDAT, IEND. Each scanline takes the
filter that Pillow's encoder picks: the least sum of |filtered bytes| (a
byte v counted as min(v, 256 − v)), trying None, Up, Sub, Average (only
with ``optimize``) and Paeth in that order, a later filter winning only
when strictly smaller, and none tried once a sum is 0. The filtered
scanlines go through deflate with the Z_FILTERED strategy, at level 9 with
``optimize`` and Pillow's default level 6 otherwise.

``complexity_nats`` (``eval/ood.py``) counts the bytes of
``encode_png(..., optimize=True)``, a compressor's codelength for the
pixels. ``decode_png`` reads back what ``encode_png`` writes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}            # channels -> PNG colour type (L, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _cost(v: np.ndarray) -> np.ndarray:
    """Per-row sum of min(v, 256 − v) over uint8 bytes [..., rows, n]."""
    v = v.astype(np.int64)
    return np.where(v < 128, v, 256 - v).sum(axis=-1)


def _filter_rows(rows: np.ndarray, bpp: int, optimize: bool) -> np.ndarray:
    """uint8 scanlines [..., H, n] -> [..., H, 1 + n], each led by its
    filter type byte, with the filters chosen as Pillow chooses them."""
    raw = rows.astype(np.int64)
    up = np.zeros_like(raw)
    up[..., 1:, :] = raw[..., :-1, :]
    left = np.zeros_like(raw)
    left[..., :, bpp:] = raw[..., :, :-bpp]
    upleft = np.zeros_like(raw)
    upleft[..., 1:, bpp:] = raw[..., :-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    cands = [(0, raw), (2, raw - up), (1, raw - left)]
    if optimize:
        cands.append((3, raw - (left + up) // 2))
    cands.append((4, raw - paeth))
    cands = [(kind, (v & 0xFF).astype(np.uint8)) for kind, v in cands]

    kind_of = np.zeros(raw.shape[:-1], np.uint8)
    best = _cost(cands[0][1])
    chosen = cands[0][1].copy()
    for kind, v in cands[1:]:
        s = _cost(v)
        take = (best > 0) & (s < best)
        best = np.where(take, s, best)
        kind_of = np.where(take, kind, kind_of).astype(np.uint8)
        chosen = np.where(take[..., None], v, chosen)
    return np.concatenate([kind_of[..., None], chosen], axis=-1)


def _deflate(filtered: np.ndarray, optimize: bool) -> bytes:
    comp = zlib.compressobj(9 if optimize else 6, zlib.DEFLATED, 15, 9,
                            zlib.Z_FILTERED)
    return comp.compress(filtered.tobytes()) + comp.flush()


def encode_png(pixels: np.ndarray, *, optimize: bool = False) -> bytes:
    """uint8 [H, W] (L) or [H, W, 3] (RGB) -> PNG file bytes."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8 pixels, got {px.dtype}")
    if px.ndim == 2:
        px = px[..., None]
    if px.ndim != 3 or px.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 3], got "
                         f"{pixels.shape}")
    h, w, c = px.shape
    data = _deflate(_filter_rows(px.reshape(h, w * c), c, optimize),
                    optimize)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data)
            + _chunk(b"IEND", b""))


# the bytes of a file beside its IDAT data: signature 8, IHDR 25, IDAT
# length, type and CRC 12, IEND 12
_FRAMING = 8 + 25 + 12 + 12
_BLOCK = 256          # images filtered together by encoded_sizes


def encoded_sizes(images: np.ndarray) -> np.ndarray:
    """Byte counts of ``encode_png(image, optimize=True)`` for each uint8
    image of [N, H, W] or [N, H, W, C], the filters chosen for a block of
    images at a time."""
    px = np.asarray(images)
    if px.ndim == 3:
        px = px[..., None]
    n, h, w, c = px.shape
    out = np.empty(n, np.int64)
    for lo in range(0, n, _BLOCK):
        filtered = _filter_rows(px[lo:lo + _BLOCK].reshape(-1, h, w * c), c,
                                True)
        for i, rows in enumerate(filtered):
            out[lo + i] = _FRAMING + len(_deflate(rows, True))
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit L or RGB, not interlaced) -> uint8 [H, W] or
    [H, W, 3]; undoes the five scanline filters."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (0, 2) or interlace:
        raise ValueError(f"decode_png reads 8-bit L/RGB, got depth {depth}, "
                         f"colour type {color}, interlace {interlace}")
    bpp = 1 if color == 0 else 3
    n = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + n)
    out = np.zeros((h, n), np.uint8)
    prev = np.zeros(n, np.int64)
    for r in range(h):
        kind, line = raw[r, 0], raw[r, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:          # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(n) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        else:                    # Average, Paeth: sequential in the row
            up, cur = prev.tolist(), line.tolist()
            for i in range(n):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int64)
        out[r], prev = cur, cur
    img = out.astype(np.uint8).reshape(h, w, bpp)
    return img[..., 0] if bpp == 1 else img
