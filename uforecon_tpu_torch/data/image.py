"""Images without OpenCV or PIL: PNG on ``zlib`` + numpy, baseline JPEG, and
resizes.

The JAX package reads DTU images with ``cv2.imread`` + ``cv2.resize``
(``data/dtu_test.py:26-33``), GeneralFit's JPEG images and masks with
``cv2.imread`` (``data/general_fit.py:72-91``) and masks with PIL
(``cli/clean_mesh.py``); neither library is promised where the port runs.
This module holds numpy copies of what those calls compute:

  * ``read_png`` / ``write_png``: 8-bit gray, RGB and RGBA PNGs,
    non-interlaced, all five row filters. Anything else raises, naming it.
  * ``read_jpeg``: baseline JPEG decoded bit for bit as OpenCV's
    libjpeg-turbo decodes it (see its docstring); progressive,
    arithmetic-coded and 12-bit files raise. Huffman symbols are decoded
    one 16-bit look-ahead at a time in Python, the IDCT, upsampling and
    colour conversion vectorised over all blocks. ``write_jpeg``: baseline
    4:4:4 JPEG (Annex K tables, IJG quality scaling), for fixtures.
  * ``imread_rgb`` / ``imread_gray``: ``cv2.imread(path)[..., ::-1]`` (gray
    is replicated and alpha dropped, as ``IMREAD_COLOR`` does) and
    ``cv2.imread(path, 0)``, PNG or JPEG by the file's first bytes.
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


def _is_jpeg(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\xff\xd8"


def imread_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``cv2.imread(path)[..., ::-1]``, of a PNG or
    a JPEG (told apart by their first bytes, not the file name)."""
    if _is_jpeg(path):
        return read_jpeg(path)
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


def imread_gray(path) -> np.ndarray:
    """(H, W) uint8, as ``cv2.imread(path, 0)``, of a JPEG or a gray PNG
    (a colour PNG raises: OpenCV's conversion of it is not copied here)."""
    if _is_jpeg(path):
        return read_jpeg(path, gray=True)
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: a colour PNG read as gray is not supported")
    return img


# --------------------------------------------------------------------------
# JPEG (baseline), as libjpeg-turbo decodes it for OpenCV
# --------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# the SOF markers this decoder refuses, by the mode they name
_SOF_MODES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
              0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
              0xCE: "arithmetic-coded hierarchical progressive",
              0xCF: "arithmetic-coded hierarchical lossless"}


def _huffman_lut(counts: Sequence[int], symbols: Sequence[int]) -> list:
    """A 16-bit look-ahead table of a canonical Huffman code: entry w holds
    (code length << 8) | symbol for every window w whose leading bits are
    a code, 0 where none is."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = [(length << 8) | symbols[k]] * span
            code += 1
            k += 1
        code <<= 1
    return lut


def _entropy_segments(data: bytes, start: int, path):
    """The entropy-coded data from ``start`` up to the next marker that is
    not a restart: its restart intervals, byte-unstuffed, and the offset of
    that marker."""
    arr = np.frombuffer(data, np.uint8)
    segments, pos = [], start
    ff = np.flatnonzero(arr[start:-1] == 0xFF) + start
    nxt = arr[ff + 1]
    for i in np.flatnonzero((nxt != 0) & (nxt != 0xFF)):
        at, marker = int(ff[i]), int(nxt[i])
        seg = arr[pos:at]
        # drop fill bytes (0xFF before a marker), then the 0x00 after each 0xFF
        while len(seg) and seg[-1] == 0xFF:
            seg = seg[:-1]
        keep = np.ones(len(seg), bool)
        keep[1:] = ~((seg[1:] == 0) & (seg[:-1] == 0xFF))
        segments.append(seg[keep])
        if not 0xD0 <= marker <= 0xD7:
            return segments, at
        pos = at + 2
    raise ValueError(f"{path}: JPEG scan without an end")


def _decode_segment(seg: np.ndarray, n_mcus: int, mcu: list, coef: list,
                    block: int, path) -> int:
    """Huffman-decode ``n_mcus`` MCUs of one restart interval into ``coef``
    (64 zigzag-ordered coefficients per block, from block ``block`` on).
    ``mcu`` lists, per block of an MCU, its component's [dc table, ac table,
    predictor]. Returns the next block index."""
    buf = np.concatenate([seg, np.zeros(8, np.uint8)]).astype(np.uint64)
    # w40[i]: the 40 bits from byte i on; a 32-bit window at bit p is
    # (w40[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
    w40 = ((buf[:-4] << np.uint64(32)) | (buf[1:-3] << np.uint64(24))
           | (buf[2:-2] << np.uint64(16)) | (buf[3:-1] << np.uint64(8))
           | buf[4:]).tolist()
    limit = 8 * len(seg) + 32
    for comp in mcu:
        comp[2][0] = 0
    p = 0
    base = block * 64
    try:
        for _ in range(n_mcus):
            for dc_lut, ac_lut, pred in mcu:
                w = (w40[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
                e = dc_lut[w >> 16]
                if not e:
                    raise ValueError(f"{path}: corrupt JPEG data (bad DC code)")
                n, s = e >> 8, e & 255
                if s:
                    v = (w >> (32 - n - s)) & ((1 << s) - 1)
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    pred[0] += v
                p += n + s
                coef[base] = pred[0]
                k = 1
                while k < 64:
                    w = (w40[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
                    e = ac_lut[w >> 16]
                    if not e:
                        raise ValueError(f"{path}: corrupt JPEG data (bad AC code)")
                    n, s = e >> 8, e & 15
                    if s:
                        k += (e >> 4) & 15
                        v = (w >> (32 - n - s)) & ((1 << s) - 1)
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        coef[base + k] = v
                        p += n + s
                        k += 1
                    elif e & 0xF0 == 0xF0:      # ZRL: 16 zeros
                        p += n
                        k += 16
                    else:                       # EOB
                        p += n
                        break
                if k > 64:
                    raise ValueError(f"{path}: corrupt JPEG data (run past 63)")
                base += 64
            if p > limit:
                raise ValueError(f"{path}: truncated JPEG data")
    except IndexError:
        raise ValueError(f"{path}: truncated JPEG data") from None
    return base // 64


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` (jidctint.c) of dequantised blocks
    (N, 8, 8) int64 -> (N, 8, 8) uint8: 13-bit constants, 2 extra bits
    between the passes, and its range-limit table."""
    def fix(x):
        return int(x * (1 << 13) + 0.5)

    c = {name: fix(v) for name, v in (
        ("0_298", 0.298631336), ("0_390", 0.390180644), ("0_541", 0.541196100),
        ("0_765", 0.765366865), ("0_899", 0.899976223), ("1_175", 1.175875602),
        ("1_501", 1.501321110), ("1_847", 1.847759065), ("1_961", 1.961570560),
        ("2_053", 2.053119869), ("2_562", 2.562915447), ("3_072", 3.072711026))}

    def one_pass(x, shift):
        # x (..., 8) along the transformed axis last
        z2, z3 = x[..., 2], x[..., 6]
        z1 = (z2 + z3) * c["0_541"]
        tmp2 = z1 - z3 * c["1_847"]
        tmp3 = z1 + z2 * c["0_765"]
        tmp0 = (x[..., 0] + x[..., 4]) << 13
        tmp1 = (x[..., 0] - x[..., 4]) << 13
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * c["1_175"]
        o0 = o0 * c["0_298"]
        o1 = o1 * c["2_053"]
        o2 = o2 * c["3_072"]
        o3 = o3 * c["1_501"]
        z1 = z1 * -c["0_899"]
        z2 = z2 * -c["2_562"]
        z3 = z3 * -c["1_961"] + z5
        z4 = z4 * -c["0_390"] + z5
        o0 += z1 + z3
        o1 += z2 + z4
        o2 += z2 + z3
        o3 += z1 + z4
        half = 1 << (shift - 1)
        out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
               t13 - o0, t12 - o1, t11 - o2, t10 - o3]
        return np.stack([(v + half) >> shift for v in out], -1)

    ws = one_pass(np.swapaxes(coef, -1, -2), 13 - 2)     # columns
    ws = np.swapaxes(ws, -1, -2)
    v = one_pass(ws, 13 + 2 + 3) & 1023                  # rows
    # the post-IDCT range-limit table: [0,128) -> +128, [128,512) -> 255,
    # [512,896) -> 0, [896,1024) -> -896 (wrapped negatives)
    out = np.where(v < 128, v + 128, np.where(v < 512, 255,
                                              np.where(v < 896, 0, v - 896)))
    return out.astype(np.uint8)


def _fancy_h2(rows: np.ndarray, width: int) -> np.ndarray:
    """libjpeg's ``h2v1_fancy_upsample`` of (H, w) int32 rows whose first
    ``width`` columns are the component's: each output pixel is 3/4 of the
    nearer input and 1/4 of the further one, biases 1 and 2 alternating,
    the edge pixels copied."""
    x = rows[:, :width]
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * width), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out


def _fancy_h2v2(plane: np.ndarray, width: int, height: int) -> np.ndarray:
    """libjpeg's ``h2v2_fancy_upsample``: vertical then horizontal 3:1
    weights on column sums, (sum + 8) >> 4 and (sum + 7) >> 4 alternating;
    the rows above the first and below the last real row repeat them (its
    context rows), the edge columns take 4x their sum."""
    x = plane[:height, :width]
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    sums = np.empty((2 * height, width), np.int32)
    sums[0::2] = 3 * x + above
    sums[1::2] = 3 * x + below
    left = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
    right = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
    out = np.empty((2 * height, 2 * width), np.int32)
    out[:, 0::2] = (3 * sums + left + 8) >> 4
    out[:, 1::2] = (3 * sums + right + 7) >> 4
    out[:, 0] = (4 * sums[:, 0] + 8) >> 4
    out[:, -1] = (4 * sums[:, -1] + 7) >> 4
    return out


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's table-driven YCbCr -> RGB (jdcolor.c, 16-bit constants)."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


_EXIF_ORIENT = {  # EXIF orientation -> the transform OpenCV applies
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: np.swapaxes(a, 0, 1), 6: lambda a: np.swapaxes(a, 0, 1)[:, ::-1],
    7: lambda a: np.swapaxes(a, 0, 1)[::-1, ::-1], 8: lambda a: np.swapaxes(a, 0, 1)[::-1]}


def _exif_orientation(body: bytes) -> int:
    """The orientation tag (0x0112) of an APP1 Exif body, 1 if none."""
    if not body.startswith(b"Exif\0\0") or len(body) < 14:
        return 1
    tiff = body[6:]
    end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if end is None:
        return 1
    try:
        (ifd,) = struct.unpack(end + "I", tiff[4:8])
        (n,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
        for i in range(n):
            tag, kind, _, value = struct.unpack(end + "HHI4s", tiff[ifd + 2 + 12 * i:
                                                                  ifd + 14 + 12 * i])
            if tag == 0x0112 and kind == 3:
                return struct.unpack(end + "H", value[:2])[0]
    except struct.error:
        pass
    return 1


def read_jpeg(path, gray: bool = False) -> np.ndarray:
    """Decode a baseline JPEG as ``cv2.imread`` does with libjpeg-turbo:
    (H, W, 3) uint8 RGB, or with ``gray`` the (H, W) luma (a colour file's
    Y plane, a grey file's only component), as ``cv2.imread(path, 0)``.

    Covers sequential Huffman-coded 8-bit files (SOF0, SOF1) with 1 or 3
    components in one scan, sampling 4:4:4, 4:2:2 or 4:2:0, restart
    intervals and any size, with libjpeg's
    arithmetic: the integer IDCT (``jidctint.c`` islow), fancy upsampling
    (``jdsample.c`` h2v1 / h2v2) and the table-driven YCbCr -> RGB
    (``jdcolor.c``); an EXIF orientation is applied, as OpenCV does.
    Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files,
    other sampling and one scan per component raise ``ValueError`` naming
    what they are."""
    data = Path(path).read_bytes()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qt, dc_t, ac_t = {}, {}, {}
    frame, restart, orientation, adobe, jfif = None, 0, 1, None, False
    comps, coefs = [], {}
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and data[pos + 1] == 0xFF:
            pos += 1                                    # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: truncated or damaged JPEG")
        marker = data[pos + 1]
        if marker == 0xD9:                              # EOI
            break
        if pos + 4 > len(data):
            raise ValueError(f"{path}: truncated JPEG")
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in _SOF_MODES:
            raise ValueError(f"{path}: {_SOF_MODES[marker]} JPEG is not supported "
                             "(baseline sequential Huffman only)")
        if marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG is not supported")
        if marker == 0xDB:                              # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                qt[tq] = table.reshape(8, 8)
                i += 1 + n
        elif marker == 0xC4:                            # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                symbols = list(body[i + 17:i + 17 + sum(counts)])
                (ac_t if tc else dc_t)[th] = _huffman_lut(counts, symbols)
                i += 17 + sum(counts)
        elif marker == 0xDD:                            # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0:
            jfif = jfif or body.startswith(b"JFIF\0")
        elif marker == 0xE1:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]                            # colour transform
        elif marker in (0xC0, 0xC1):                    # SOF0 / SOF1
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG is not supported")
            if nc not in (1, 3):
                raise ValueError(f"{path}: JPEG with {nc} components is not "
                                 "supported (1 or 3)")
            if height == 0:
                raise ValueError(f"{path}: JPEG with a DNL height is not supported")
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            frame = (width, height)
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                if nc > 1 and (hmax % c["h"] or vmax % c["v"] or
                               (hmax // c["h"], vmax // c["v"]) not in
                               ((1, 1), (2, 1), (2, 2))):
                    raise ValueError(
                        f"{path}: JPEG sampling {c['h']}x{c['v']} of "
                        f"{hmax}x{vmax} is not supported (4:4:4, 4:2:2, 4:2:0)")
                c["w"] = -(-width * c["h"] // hmax)
                c["hgt"] = -(-height * c["v"] // vmax)
                # the block grid of an interleaved scan, MCU-padded
                c["bw"], c["bh"] = (mcux * c["h"], mcuy * c["v"]) if nc > 1 else \
                    (-(-c["w"] // 8), -(-c["hgt"] // 8))
                coefs[c["id"]] = np.zeros((c["bh"], c["bw"], 64), np.int64)
        elif marker == 0xDA:                            # SOS
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            ns = body[0]
            if ns != len(comps):
                raise ValueError(f"{path}: JPEG with one scan per component is not "
                                 "supported (interleaved scans only)")
            scan = []
            for k in range(ns):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                c = next((c for c in comps if c["id"] == cid), None)
                if c is None or tables >> 4 not in dc_t or tables & 15 not in ac_t:
                    raise ValueError(f"{path}: JPEG scan names a missing "
                                     "component or table")
                scan.append((c, dc_t[tables >> 4], ac_t[tables & 15]))
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise ValueError(f"{path}: progressive JPEG scan is not supported")
            segments, pos = _entropy_segments(data, pos, path)
            _decode_scan(scan, segments, restart, coefs, path)
    if frame is None:
        raise ValueError(f"{path}: JPEG without a frame")
    width, height = frame
    # libjpeg's colour-space guess: JFIF is YCbCr, else the Adobe
    # transform, else component ids 'R', 'G', 'B'
    rgb_ids = [c["id"] for c in comps] == [82, 71, 66]
    is_rgb = len(comps) == 3 and not jfif and (adobe == 0 if adobe is not None
                                               else rgb_ids)
    planes = []
    for c in comps:
        if c["tq"] not in qt:
            raise ValueError(f"{path}: JPEG component without its quantisation table")
        zz = coefs[c["id"]].reshape(-1, 64)
        pix = np.empty((len(zz), 8, 8), np.uint8)
        for b0 in range(0, len(zz), 16384):             # bounded temporaries
            blocks = zz[b0:b0 + 16384][:, np.argsort(_ZIGZAG)].reshape(-1, 8, 8)
            pix[b0:b0 + 16384] = _idct_islow(blocks * qt[c["tq"]])
        pix = pix.reshape(c["bh"], c["bw"], 8, 8)
        planes.append(pix.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8))
        if gray and not is_rgb:
            break
    if (gray and not is_rgb) or len(comps) == 1:
        out = planes[0][:height, :width]
        if not gray:
            out = np.repeat(out[..., None], 3, axis=2)
    else:
        hmax = max(c["h"] for c in comps)
        vmax = max(c["v"] for c in comps)
        full = []
        for c, plane in zip(comps, planes):
            x = plane.astype(np.int32)
            ratio = (hmax // c["h"], vmax // c["v"])
            if ratio == (2, 1):
                x = _fancy_h2(x[:c["hgt"]], c["w"])
            elif ratio == (2, 2):
                x = _fancy_h2v2(x, c["w"], c["hgt"])
            full.append(x[:height, :width])
        if not is_rgb:
            out = _ycc_to_rgb(*full)
        elif gray:                          # jdcolor.c rgb_gray_convert
            r, g, b = (v.astype(np.int64) for v in full)
            out = ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)
        else:
            out = np.stack(full, -1).astype(np.uint8)
    if orientation in _EXIF_ORIENT:
        out = _EXIF_ORIENT[orientation](out)
    return np.ascontiguousarray(out)


def _decode_scan(scan, segments, restart, coefs, path) -> None:
    """Decode the frame's scan (every component, interleaved) into the
    components' block grids (``coefs``)."""
    if len(scan) == 1:
        # one component: one block per MCU, over its own block grid
        c = scan[0][0]
        mcu_blocks, steps, mcux = [(c, 0, 0)], {id(c): (1, 1)}, c["bw"]
    else:
        mcu_blocks = [(c, v, h) for c, _, _ in scan
                      for v in range(c["v"]) for h in range(c["h"])]
        steps = {id(c): (c["v"], c["h"]) for c, _, _ in scan}
        mcux = scan[0][0]["bw"] // scan[0][0]["h"]
    n_mcus = mcux * (scan[0][0]["bh"] // steps[id(scan[0][0])][0])
    per_interval = restart or n_mcus
    if len(segments) < -(-n_mcus // per_interval):
        raise ValueError(f"{path}: JPEG scan has fewer restart intervals than "
                         "its MCUs need")
    preds = {id(c): [0] for c, _, _ in scan}
    tables = {id(c): (dc, ac) for c, dc, ac in scan}
    mcu = [[*tables[id(c)], preds[id(c)]] for c, _, _ in mcu_blocks]
    flat = [0] * (n_mcus * len(mcu_blocks) * 64)
    block = 0
    for k, start in enumerate(range(0, n_mcus, per_interval)):
        block = _decode_segment(segments[k], min(per_interval, n_mcus - start), mcu,
                                flat, block, path)
    flat = np.array(flat, np.int64).reshape(n_mcus, len(mcu_blocks), 64)
    my, mx = np.divmod(np.arange(n_mcus), mcux)
    for k, (c, v, h) in enumerate(mcu_blocks):
        sv, sh = steps[id(c)]
        coefs[c["id"]][my * sv + v, mx * sh + h] = flat[:, k]


# Annex K: the example quantisation tables (natural order) and Huffman codes
_QT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QT_CHROMA = np.full(64, 99)
_QT_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_DC_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_SYMBOLS = list(range(12))
_AC_COUNTS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]
_AC_HEAD = [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
            0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
            0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
            0x82, 0x09, 0x0A]
# the rest of the luminance AC code: every other run/size symbol, ascending
_AC_SYMBOLS = _AC_HEAD + sorted({r << 4 | s for r in range(16) for s in range(1, 11)}
                                - set(_AC_HEAD))


def _huffman_codes(counts, symbols) -> dict:
    """symbol -> (code, length) of a canonical Huffman code."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _ijg_quality(table: np.ndarray, quality: int) -> np.ndarray:
    """IJG's quality scaling (jcparam.c), clamped to baseline's 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * scale + 50) // 100, 1, 255)


def write_jpeg(path, img: np.ndarray, quality: int = 95) -> None:
    """Encode (H, W) gray or (H, W, 3) RGB uint8 as a baseline JFIF JPEG:
    4:4:4, Annex K tables scaled by the IJG quality rule, one DC and one AC
    Huffman code (Annex K's luminance ones) for every component."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_jpeg takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    x = img.astype(np.float64)
    if img.ndim == 2:
        planes = [x]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
    tables = [_ijg_quality(_QT_LUMA, quality), _ijg_quality(_QT_CHROMA, quality)]
    k = np.arange(8)
    dct = np.sqrt(np.where(k == 0, 1.0, 2.0)[:, None] / 8) * \
        np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    bh, bw = -(-h // 8), -(-w // 8)
    zz = []
    for i, plane in enumerate(planes):
        # edge-replicate to whole blocks, level-shift, 2-D DCT, quantise
        p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge") - 128
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dct @ blocks @ dct.T
        q = np.rint(coef / tables[min(i, 1)].reshape(8, 8)).astype(np.int64)
        q[..., 1:, :] = np.clip(q[..., 1:, :], -1023, 1023)   # baseline's AC range
        q[..., 0, 1:] = np.clip(q[..., 0, 1:], -1023, 1023)
        zz.append(q.reshape(bh * bw, 64)[:, _ZIGZAG])
    dc_codes = _huffman_codes(_DC_COUNTS, _DC_SYMBOLS)
    ac_codes = _huffman_codes(_AC_COUNTS, _AC_SYMBOLS)
    codes, lengths = [], []

    def put(symbol_code, value, size):
        code, n = symbol_code
        codes.append((code << size) | (value & ((1 << size) - 1)))
        lengths.append(n + size)

    preds = [0] * len(zz)
    nz_blocks = [np.nonzero(z[:, 1:]) for z in zz]
    starts = [np.searchsorted(b, np.arange(bh * bw + 1)) for b, _ in nz_blocks]
    zz_lists = [z.tolist() for z in zz]
    for blk in range(bh * bw):                  # interleaved MCUs of 1 block each
        for i in range(len(zz)):
            row = zz_lists[i][blk]
            diff = row[0] - preds[i]
            preds[i] = row[0]
            s = abs(diff).bit_length()
            put(dc_codes[s], diff if diff >= 0 else diff - 1, s)
            last = 0
            for kk in nz_blocks[i][1][starts[i][blk]:starts[i][blk + 1]].tolist():
                kk += 1
                run = kk - last - 1
                while run > 15:
                    put(ac_codes[0xF0], 0, 0)
                    run -= 16
                v = row[kk]
                s = abs(v).bit_length()
                put(ac_codes[run << 4 | s], v if v >= 0 else v - 1, s)
                last = kk
            if last < 63:
                put(ac_codes[0x00], 0, 0)
    # pack the codes MSB first, pad with 1-bits, stuff a 0x00 after each 0xFF
    lengths = np.array(lengths, np.int64)
    codes = np.array(codes, np.int64)
    nbits = int(lengths.sum())
    total = -(-nbits // 8) * 8
    bits = np.ones(total, np.uint8)
    ends = np.cumsum(lengths)
    owner = np.repeat(np.arange(len(lengths)), lengths)
    shift = ends[owner] - 1 - np.arange(nbits)
    bits[:nbits] = (codes[owner] >> shift) & 1
    data = np.packbits(bits)
    stuffed = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()

    def segment(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    nc = len(planes)
    out = [b"\xff\xd8", segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")]
    for t, table in enumerate(tables[:min(nc, 2)]):
        out.append(segment(0xDB, bytes([t]) + bytes(table[_ZIGZAG].astype(np.uint8))))
    out.append(segment(0xC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i + 1, 0x11, min(i, 1)]) for i in range(nc))))
    out.append(segment(0xC4, bytes([0x00] + _DC_COUNTS + _DC_SYMBOLS)
                       + bytes([0x10] + _AC_COUNTS + _AC_SYMBOLS)))
    out.append(segment(0xDA, bytes([nc]) + b"".join(bytes([i + 1, 0x00])
                                                     for i in range(nc))
                       + bytes([0, 63, 0])))
    Path(path).write_bytes(b"".join(out) + stuffed + b"\xff\xd9")


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
