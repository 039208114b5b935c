"""Images without OpenCV or PIL: PNG on ``zlib`` + numpy, and resizes.

The JAX package reads DTU images with ``cv2.imread`` + ``cv2.resize``
(``data/dtu_test.py:26-33``) and masks with PIL (``cli/clean_mesh.py``);
neither library is promised where the port runs. This module holds numpy
copies of what those calls compute:

  * ``read_png`` / ``write_png``: 8-bit gray, RGB and RGBA PNGs,
    non-interlaced, all five row filters. Anything else raises, naming it.
  * ``imread_rgb``: ``cv2.imread(path)[..., ::-1]`` (gray is replicated and
    alpha dropped, as ``IMREAD_COLOR`` does).
  * ``resize_linear``: ``cv2.resize(img, (w, h))`` on uint8 (INTER_LINEAR):
    half-pixel centres, no antialias, 11-bit fixed-point weights and the
    vectorised vertical pass's rounding; an exact 2x shrink in both axes
    is a 2x2 mean, as OpenCV switches to INTER_AREA there. OpenCV's scalar
    tail of a row rounds once where its vector body rounds in steps, so a
    pixel can differ from OpenCV by one level.
  * ``to_gray`` / ``resize_nearest``: PIL's ``convert("L")`` and
    ``resize(..., NEAREST)``.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------


def _chunks(data: bytes, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, ftype: np.ndarray, w: int, c: int) -> np.ndarray:
    """Undo the per-row PNG filters. rows (H, W*C) uint8 -> (H, W, C) uint8."""
    h = rows.shape[0]
    data = rows.reshape(h, w, c).astype(np.int32)
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up: each row at once from the row above
        out = np.empty((h, w, c), np.int32)
        prev = np.zeros((w, c), np.int32)
        for y in range(h):
            t = ftype[y]
            cur = data[y]
            if t == 1:
                cur = np.cumsum(cur, axis=0)
            elif t == 2:
                cur = cur + prev
            out[y] = prev = cur & 255
        return out.astype(np.uint8)
    # Average and Paeth read the reconstructed left pixel: reconstruct one
    # anti-diagonal at a time, whose pixels depend only on earlier ones.
    # r has a zero row above and a zero column left of the image.
    r = np.zeros((h + 1, w + 1, c), np.int32)
    for s in range(h + w - 1):
        ys = np.arange(max(0, s - w + 1), min(h - 1, s) + 1)
        xs = s - ys
        a, b, ul = r[ys + 1, xs], r[ys, xs + 1], r[ys, xs]
        t = ftype[ys][:, None]
        pred = np.select([t == 0, t == 1, t == 2, t == 3],
                         [0, a, b, (a + b) >> 1], _paeth(a, b, ul))
        r[ys + 1, xs + 1] = (data[ys, xs] + pred) & 255
    return r[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode a PNG: (H, W) for gray, (H, W, 3) RGB or (H, W, 4) RGBA, uint8.
    Raises ``ValueError`` on other bit depths, colour types, interlacing
    or a damaged file."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, compression, filt, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; only 8-bit is supported")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: {_COLOR_NAMES.get(color, color)} PNG; only "
                         "gray, RGB and RGBA are supported")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if compression or filt:
        raise ValueError(f"{path}: unknown PNG compression/filter method")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected "
                         f"{h * (w * c + 1)}")
    raw = raw.reshape(h, w * c + 1)
    ftype = raw[:, 0]
    if ftype.max() > 4:
        raise ValueError(f"{path}: PNG row filter {int(ftype.max())} is not one "
                         "of the five")
    img = _unfilter(raw[:, 1:], ftype, w, c)
    return img[..., 0] if c == 1 else img


def write_png(path, img: np.ndarray) -> None:
    """Encode (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 as an 8-bit
    PNG (every row with the Up filter)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    h, w = img.shape[:2]
    rows = img.reshape(h, w * c)
    up = rows - np.concatenate([np.zeros((1, w * c), np.uint8), rows[:-1]])
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    Path(path).write_bytes(_SIGNATURE + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                           + chunk(b"IEND", b""))


def imread_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``cv2.imread(path)[..., ::-1]``."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


# --------------------------------------------------------------------------
# Resizes
# --------------------------------------------------------------------------

_COEF_BITS = 11                         # OpenCV INTER_RESIZE_COEF_BITS
_COEF_ONE = 1 << _COEF_BITS


def _linear_taps(n_out: int, n_in: int, clamp_weights: bool):
    """Source index and 11-bit weights of each output position (OpenCV's
    resize tables): x = (d + 0.5) * scale - 0.5 in float32, floor and
    fraction; x clamps its weight at the edges, y only its rows."""
    scale = n_in / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        edge = (s < 0) | (s >= n_in - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, n_in - 1)
    w0 = np.rint((np.float32(1.0) - f) * _COEF_ONE).astype(np.int64)
    w1 = np.rint(f * _COEF_ONE).astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def resize_linear(img: np.ndarray, wh: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) of a uint8 (H, W) or
    (H, W, C) image, within one level of OpenCV (see the module docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8, got {img.dtype}")
    out_w, out_h = int(wh[0]), int(wh[1])
    in_h, in_w = img.shape[:2]
    if (out_w, out_h) == (in_w, in_h):
        return img.copy()
    if in_w == 2 * out_w and in_h == 2 * out_h:
        s = img.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2)
                >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(out_w, in_w, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(out_h, in_h, clamp_weights=False)
    if img.ndim == 3:
        a0, a1 = a0[:, None], a1[:, None]
    src = img.astype(np.int64)
    rows = src[:, x0] * a0 + src[:, x1] * a1          # horizontal pass, exact
    # vertical pass as OpenCV's vector loop: each row >> 4, a 16-bit high
    # product with the weight, the two summed, then (+2) >> 2
    rows = np.minimum(rows >> 4, 32767)
    shape = (-1,) + (1,) * (img.ndim - 1)
    out = (((rows[y0] * b0.reshape(shape)) >> 16)
           + ((rows[y1] * b1.reshape(shape)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def to_gray(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of a uint8 gray, RGB or RGBA image."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img.copy()
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def resize_nearest(img: np.ndarray, wh: Sequence[int]) -> np.ndarray:
    """PIL's ``resize((w, h), NEAREST)``: the source pixel under each output
    pixel's centre, the centres accumulated step by step in float64 as PIL
    does (a product would round differently on some pixels)."""
    img = np.asarray(img)

    def index(n_out: int, n_in: int) -> np.ndarray:
        steps = np.full(n_out, n_in / n_out)
        steps[0] *= 0.5
        return np.minimum(np.cumsum(steps).astype(np.int64), n_in - 1)

    in_h, in_w = img.shape[:2]
    return img[index(int(wh[1]), in_h)[:, None], index(int(wh[0]), in_w)[None, :]]
