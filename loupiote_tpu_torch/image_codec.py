"""PNG decoding and encoding, and baseline JPEG encoding, without PIL.

The reference decodes glTF and blue-noise PNGs with PIL
(``Image.open(...).convert("RGBA")``), writes screenshots and fly-through
frames with ``Image.save`` and encodes the viewer's frames as JPEG; the
card's host has no PIL, so the port has its own codec:

- ``decode_png(data)``: (H, W, 4) uint8, the bytes PIL's
  ``convert("RGBA")`` gives (Pillow 12): grey, grey + alpha, RGB, RGBA and
  palette images, bit depths 1, 2, 4, 8 and 16, Adam7 interlacing, a
  ``tRNS`` chunk as PIL applies it;
- ``encode_png(rgb_or_rgba)``: RGB(A) uint8 to PNG bytes (Sub filter);
- ``encode_jpeg(rgb, quality=85)``: baseline JFIF, 4:2:0, the standard
  tables of the JPEG specification's Annex K scaled by the IJG quality
  rule, as libjpeg (PIL's encoder) defaults;
- ``decode_jpeg(data)``: (H, W, 4) uint8, the bytes PIL's
  ``convert("RGBA")`` gives: sequential Huffman-coded 8-bit files of one
  (grey) or three components (YCbCr, or RGB where an Adobe marker or the
  component ids say so), 4:4:4, 4:2:2 and 4:2:0 sampling, restart
  markers; libjpeg's defaults repeated (the ``islow`` integer IDCT,
  "fancy" triangle upsampling, the fixed-point YCbCr tables);
- ``is_jpeg(data)`` / ``is_png(data)``: the signatures.

Chunk parsing, zlib, bit unpacking, colour conversion, the DCT and the
quantisation are numpy / torch on the host. The serial byte work (PNG's
scanline unfiltering, JPEG's Huffman bit packing and decoding) is C++,
``csrc/image_codec.cpp``, built with g++ at first use into ``_build/``;
a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np
import torch

from . import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "image_codec.cpp")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (x0, y0, dx, dy) of the seven Adam7 passes.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}

_lock = threading.Lock()
_lib = None


class CodecError(ValueError):
    """Malformed or unsupported image data."""


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.gxx(SOURCE, "libimage_codec"))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                         ctypes.c_int64, ctypes.c_int32, u8p]
            lib.jpeg_scan.restype = ctypes.c_int64
            lib.jpeg_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64]
            lib.jpeg_decode_scan.restype = ctypes.c_int64
            lib.jpeg_decode_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_void_p]
            _lib = lib
        return _lib


def is_png(data: bytes) -> bool:
    return data[:8] == PNG_SIGNATURE


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


# -- PNG decoding ------------------------------------------------------------

def _chunks(data: bytes):
    if not is_png(data):
        raise CodecError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise CodecError(f"truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise CodecError("PNG without IEND")


def _unfilter(raw: bytes, offset: int, h: int, stride: int, bpp: int):
    """(h, stride) uint8 scanlines unfiltered from raw[offset:]; returns
    them and the offset past them."""
    need = h * (stride + 1)
    if offset + need > len(raw):
        raise CodecError("PNG image data is short")
    out = np.empty((h, stride), np.uint8)
    src = np.frombuffer(raw, np.uint8, need, offset)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = _load().png_unfilter(src.ctypes.data_as(u8p), need, h, stride,
                              max(bpp, 1), out.ctypes.data_as(u8p))
    if rc != 0:
        raise CodecError("bad PNG filter type" if rc == -2
                         else "PNG image data is short")
    return out, offset + need


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """(h, w, c) sample values (uint8, or uint16 at depth 16) of
    unfiltered scanlines."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :w * c].astype(np.uint16).reshape(h, w, c)
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)  # depth < 8: one channel
    n = w * c
    bits = bits[:, :n * depth].reshape(h, n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8).reshape(h, w, c)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a PNG file, as PIL's ``convert("RGBA")``."""
    ihdr = plte = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise CodecError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise CodecError(f"PNG colour type {ctype} at depth {depth}")
    if comp or filt or interlace not in (0, 1):
        raise CodecError("unknown PNG compression, filter or interlace")
    if ctype == 3 and plte is None:
        raise CodecError("palette PNG without PLTE")
    raw = zlib.decompress(b"".join(idat))
    c = _CHANNELS[ctype]
    bpp = (c * depth + 7) // 8
    if interlace:
        s = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            rows, off = _unfilter(raw, off, ph, (pw * c * depth + 7) // 8,
                                  bpp)
            s[y0::dy, x0::dx] = _samples(rows, pw, c, depth)
    else:
        rows, _ = _unfilter(raw, 0, h, (w * c * depth + 7) // 8, bpp)
        s = _samples(rows, w, c, depth)
    return _to_rgba(s, ctype, depth, plte, trns)


def _to_rgba(s, ctype, depth, plte, trns) -> np.ndarray:
    """PIL's mode for the PNG, then its RGBA conversion (Pillow 12)."""
    h, w = s.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:len(plte), :3] = plte
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alpha), 3] = alpha
        return pal[s[..., 0]]
    if depth == 16:
        # Mode I;16 for grey (clipped at 255, tRNS unused), else the high
        # byte of each sample (RGB;16B, RGBA;16B, LA;16B).
        v = np.minimum(s, 255) if ctype == 0 else s >> 8
        s8 = v.astype(np.uint8)
    else:
        # Modes 1, L;2 and L;4 spread grey over 0-255.
        scale = {1: 255, 2: 85, 4: 17, 8: 1}[depth]
        s8 = (s * scale).astype(np.uint8) if scale != 1 else s
    if ctype in (0, 4):
        out[..., :3] = s8[..., :1]
        if ctype == 4:
            out[..., 3] = s8[..., 1]
    else:
        out[..., :3] = s8[..., :3]
        if ctype == 6:
            out[..., 3] = s8[..., 3]
    if trns is not None and ctype in (0, 2) and not (ctype == 0
                                                       and depth == 16):
        # PIL compares the converted pixel with the chunk's raw value(s)
        # (mode 1 stores a nonzero key as 255).
        key = np.array(struct.unpack(">" + "H" * (len(trns) // 2), trns),
                       np.int64)
        if ctype == 0 and depth == 1:
            key = np.where(key != 0, 255, 0)
        px = out[..., :1] if ctype == 0 else out[..., :3]
        hit = (px.astype(np.int64) == key[:px.shape[2]]).all(axis=2)
        out[..., 3][hit] = 0
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


# -- PNG encoding ------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of an (H, W, 3) or (H, W, 4) uint8 image (8-bit RGB or
    RGBA, every row Sub-filtered)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise CodecError(f"encode_png takes (H, W, 3|4) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    sub = rows.copy()
    sub[:, c:] = rows[:, c:] - rows[:, :-c]  # uint8 wraps: mod 256
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = 1
    raw[:, 1:] = sub
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# -- Sequential JPEG decoding --------------------------------------------------

# Start-of-frame markers by what they code; only 0xC0 / 0xC1 (sequential,
# Huffman) decode.
_SOF_KINDS = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential",
              0xC6: "differential", 0xC7: "differential",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
              0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded",
              0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}


def _segments(data: bytes):
    """(marker, body offset, body length) of each marker segment after
    SOI, up to EOI; after SOS the entropy-coded bytes are skipped by the
    caller, which resumes at the offset it sends back."""
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # tolerate junk between segments, as libjpeg does
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise CodecError("JPEG ends before its EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise CodecError("truncated JPEG marker segment")
        n = struct.unpack_from(">H", data, pos)[0]
        if n < 2 or pos + n > len(data):
            raise CodecError(f"truncated JPEG segment 0x{marker:02X}")
        resume = yield marker, pos + 2, n - 2
        pos = pos + n if resume is None else resume


# IDCT constants of libjpeg's jidctint.c (CONST_BITS 13, PASS1_BITS 2).
_FIX = {k: int(v * (1 << 13) + 0.5) for k, v in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644),
    ("0_541196100", 0.541196100), ("0_765366865", 0.765366865),
    ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065),
    ("1_961570560", 1.961570560), ("2_053119869", 2.053119869),
    ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}


def _idct_pass(x, shift):
    """One 1-D pass of jpeg_idct_islow over the last axis of int64 x
    (..., 8): its even and odd parts, descaled by ``shift`` bits."""
    f = _FIX
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 - z3 * f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = (x[..., 0] + x[..., 4]) << 13
    tmp1 = (x[..., 0] - x[..., 4]) << 13
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["1_175875602"]
    o0 = o0 * f["0_298631336"]
    o1 = o1 * f["2_053119869"]
    o2 = o2 * f["3_072711026"]
    o3 = o3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    half = 1 << (shift - 1)
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
           t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return (np.stack(out, axis=-1) + half) >> shift


# libjpeg's post-IDCT range limit: index (value & 1023), sample 0-255; in
# range it is value + 128 clamped, and it wraps as libjpeg's table does.
_IDCT_LIMIT = np.concatenate([
    np.arange(128, 256), np.full(384, 255), np.zeros(384),
    np.arange(0, 128)]).astype(np.uint8)


def _idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) int16 coefficients (natural order) and their quantisation
    table to (N, 8, 8) uint8 samples, as libjpeg's jpeg_idct_islow."""
    x = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_pass(np.swapaxes(x, 1, 2), 13 - 2)  # (N, col, row)
    rows = _idct_pass(np.swapaxes(cols, 1, 2), 13 + 2 + 3)
    return _IDCT_LIMIT[rows & 1023]


def _fancy_h2(p: np.ndarray, bias_even: int, bias_odd: int,
              shift: int) -> np.ndarray:
    """Horizontal triangle upsampling by 2 of int32 (h, w) sums: output
    2j is (3 p[j] + p[j - 1] + bias_even) >> shift, 2j + 1 is (3 p[j] +
    p[j + 1] + bias_odd) >> shift, the edge columns repeated."""
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + left + bias_even) >> shift
    out[:, 1::2] = (3 * p + right + bias_odd) >> shift
    return out


def _upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """A component's samples (its own real size) upsampled by (rh, rv), as
    libjpeg-turbo's defaults do: h2v1 and h2v2 "fancy" (triangle) filters
    from 3 samples wide on, boxes below that."""
    if (rh, rv) == (1, 1):
        return plane
    p = plane.astype(np.int32)
    if p.shape[1] <= 2:  # libjpeg's plain h2v1 / h2v2 upsampling
        return np.repeat(np.repeat(plane, rh, axis=1), rv, axis=0)
    if rv == 1:
        return _fancy_h2(p, 1, 2, 2).astype(np.uint8)
    # h2v2: each output row mixes its nearest input row (3/4) with the
    # next nearest above (even rows) or below (odd rows), edges repeated.
    above = np.concatenate([p[:1], p[:-1]])
    below = np.concatenate([p[1:], p[-1:]])
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    out[0::2] = _fancy_h2(3 * p + above, 8, 7, 4)
    out[1::2] = _fancy_h2(3 * p + below, 8, 7, 4)
    return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's ycc_rgb_convert: 16-bit fixed-point tables, clamped."""
    def fix(x):
        return int(x * (1 << 16) + 0.5)

    half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a sequential JPEG, as PIL's
    ``convert("RGBA")``. Progressive, arithmetic-coded, lossless,
    hierarchical, 12-bit and CMYK / four-component files raise
    ``CodecError`` naming what they are."""
    data = bytes(data)
    if not is_jpeg(data):
        raise CodecError("not a JPEG file")
    qt = {}
    dc_tables, ac_tables = {}, {}
    restart = 0
    frame = None  # (H, W, components)
    adobe = None  # the Adobe APP14 transform flag
    jfif = False
    coef = None
    latched = {}  # component index -> quantisation table at its 1st scan
    segs = _segments(data)
    resume = None
    while True:
        try:
            marker, off, n = segs.send(resume)
        except StopIteration:
            break
        resume = None
        body = data[off:off + n]
        if marker in _SOF_KINDS:
            raise CodecError(f"{_SOF_KINDS[marker]} JPEG (SOF "
                             f"0x{marker:02X}) is not supported")
        if marker == 0xCC:
            raise CodecError("arithmetic-coded JPEG (DAC) is not supported")
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and n >= 12:
            adobe = body[11]
        elif marker == 0xDB:
            i = 0
            while i < n:
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                vals = np.frombuffer(body, ">u2" if pq else np.uint8, 64,
                                     i + 1).astype(np.int64)
                table = np.empty(64, np.int64)
                table[_ZIGZAG] = vals
                qt[tq & 3] = table
                i += 1 + size
        elif marker == 0xC4:
            i = 0
            while i < n:
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                m = sum(counts)
                spec = np.zeros(272, np.uint8)
                spec[:16] = np.frombuffer(counts, np.uint8)
                spec[16:16 + m] = np.frombuffer(body, np.uint8, m, i + 17)
                (ac_tables if tc else dc_tables)[th & 3] = spec
                i += 17 + m
        elif marker == 0xDD:
            restart = struct.unpack_from(">H", body)[0]
        elif marker in (0xC0, 0xC1):
            prec, H, W, nc = struct.unpack_from(">BHHB", body)
            if prec != 8:
                raise CodecError(f"{prec}-bit JPEG is not supported")
            if nc == 4:
                raise CodecError("CMYK (four-component) JPEG is not "
                                 "supported")
            if nc not in (1, 3):
                raise CodecError(f"JPEG with {nc} components is not "
                                 f"supported")
            if H == 0 or W == 0:
                raise CodecError("JPEG with no height (DNL) or width")
            comps = [dict(id=body[6 + 3 * k], h=body[7 + 3 * k] >> 4,
                          v=body[7 + 3 * k] & 15, tq=body[8 + 3 * k])
                     for k in range(nc)]
            frame = (H, W, comps)
            coef = _frame_layout(frame)
        elif marker == 0xDA:
            if frame is None:
                raise CodecError("JPEG scan before its frame header")
            resume = _decode_scan(data, off, n, frame, coef, dc_tables,
                                  ac_tables, restart, qt, latched)
    if frame is None or not latched:
        raise CodecError("JPEG without a frame or a scan")
    H, W, comps = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for k, c in enumerate(comps):
        if k not in latched:
            raise CodecError(f"JPEG component {c['id']} has no scan")
        lay = coef["layout"][k]
        samples = _idct_islow(coef["blocks"][lay["first"]:lay["first"]
                                             + lay["n"]], latched[k])
        by, bx = lay["rows"], lay["cols"]
        plane = samples.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(by * 8, bx * 8)[:lay["height"], :lay["width"]]
        up = _upsample(plane, hmax // c["h"], vmax // c["v"])
        planes.append(up[:H, :W])
    rgba = np.full((H, W, 4), 255, np.uint8)
    if len(comps) == 1:
        rgba[..., :3] = planes[0][..., None]
        return rgba
    ids = tuple(c["id"] for c in comps)
    rgb = (adobe == 0 if adobe is not None
           else not jfif and ids == (ord("R"), ord("G"), ord("B")))
    rgba[..., :3] = (np.stack(planes, axis=-1) if rgb
                     else _ycc_to_rgb(*planes))
    return rgba


def _frame_layout(frame):
    """Each component's coefficient blocks, allocated over whole MCUs."""
    H, W, comps = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    for c in comps:
        if c["h"] not in (1, 2, 4) or c["v"] not in (1, 2, 4) or (
                hmax // c["h"], vmax // c["v"]) not in ((1, 1), (2, 1),
                                                        (2, 2)):
            raise CodecError(
                f"JPEG sampling factors {[(d['h'], d['v']) for d in comps]}"
                f" are not supported (4:4:4, 4:2:2 and 4:2:0 are)")
    mcus_x = -(-W // (8 * hmax))
    mcus_y = -(-H // (8 * vmax))
    layout, first = [], 0
    for c in comps:
        width = -(-W * c["h"] // hmax)
        height = -(-H * c["v"] // vmax)
        rows, cols = mcus_y * c["v"], mcus_x * c["h"]
        layout.append(dict(first=first, n=rows * cols, rows=rows, cols=cols,
                           width=width, height=height))
        first += rows * cols
    return {"blocks": np.zeros((first, 64), np.int16), "layout": layout,
            "mcus": (mcus_x, mcus_y), "max": (hmax, vmax)}


def _decode_scan(data, off, n, frame, coef, dc_tables, ac_tables, restart,
                 qt, latched) -> int:
    """Huffman-decode the scan whose header is data[off:off + n] into
    ``coef``; returns the offset of the marker after its entropy-coded
    bytes."""
    H, W, comps = frame
    body = data[off:off + n]
    ns = body[0]
    index = {c["id"]: k for k, c in enumerate(comps)}
    info = np.zeros((ns, 6), np.int32)
    tables = np.zeros((8, 272), np.uint8)
    for j in range(ns):
        cid, td_ta = body[1 + 2 * j], body[2 + 2 * j]
        if cid not in index:
            raise CodecError(f"JPEG scan names unknown component {cid}")
        k = index[cid]
        c, lay = comps[k], coef["layout"][k]
        td, ta = td_ta >> 4, td_ta & 15
        if td not in dc_tables or ta not in ac_tables:
            raise CodecError("JPEG scan uses an undefined Huffman table")
        if c["tq"] not in qt:
            raise CodecError("JPEG component uses an undefined "
                             "quantisation table")
        latched.setdefault(k, qt[c["tq"]].copy())
        tables[td & 3] = dc_tables[td]
        tables[4 + (ta & 3)] = ac_tables[ta]
        # A one-component scan codes the component's own blocks, one an
        # MCU; an interleaved scan h x v blocks of each an MCU.
        h, v = (1, 1) if ns == 1 else (c["h"], c["v"])
        info[j] = (h, v, lay["cols"], lay["first"], td & 3, ta & 3)
    if ns == 1:
        lay = coef["layout"][index[body[1]]]
        mcus_x, mcus_y = -(-lay["width"] // 8), -(-lay["height"] // 8)
    else:
        mcus_x, mcus_y = coef["mcus"]
    buf = np.frombuffer(data, np.uint8)
    end = _load().jpeg_decode_scan(
        buf.ctypes.data, len(data), off + n, ns, info.ctypes.data, mcus_x,
        mcus_y, restart, tables.ctypes.data, coef["blocks"].ctypes.data)
    if end < 0:
        raise CodecError("corrupt JPEG scan: " + (
            "a Huffman code no table holds" if end == -1
            else "a restart marker is missing"))
    # The entropy-coded bytes end at the next marker that is not RSTn.
    pos = end
    while pos + 1 < len(data):
        if data[pos] == 0xFF and data[pos + 1] not in (0x00, 0xFF) and not (
                0xD0 <= data[pos + 1] <= 0xD7):
            return pos
        pos += 1
    raise CodecError("JPEG ends inside a scan")


# -- Baseline JPEG encoding ----------------------------------------------------

# Annex K.1 quantisation tables, natural (row-major) order.
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int64)
# Zigzag: _ZIGZAG[k] is the natural index of the k-th coefficient.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3 Huffman tables: (code counts by length 1-16, symbols).
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _huffman_codes(table, n_symbols: int):
    """(code, length) arrays by symbol of a table (Annex C)."""
    counts, symbols = table
    code_of = np.zeros(n_symbols, np.uint16)
    size_of = np.zeros(n_symbols, np.uint8)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            size_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


def quant_tables(quality: int):
    """(luma, chroma) quantisation tables at ``quality`` (1-100), natural
    order: the IJG rule (libjpeg's ``jpeg_quality_scaling``), clamped to
    1-255 for a baseline file."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_Q_LUMA, _Q_CHROMA))


def _dct_matrix() -> torch.Tensor:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2.0)
    return torch.from_numpy(m.astype(np.float32))


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) plane, H and W multiples of 8, to (H/8, W/8, 8, 8) blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def encode_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    """Baseline JFIF bytes of an (H, W, 3 or 4) uint8 image (alpha
    dropped): YCbCr with 2x2-subsampled chroma, the standard tables."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise CodecError(f"encode_jpeg takes (H, W, 3|4) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise CodecError(f"JPEG cannot hold {w}x{h}")
    rgb = torch.from_numpy(np.ascontiguousarray(img[..., :3])).float()
    # Edge-replicate to whole 16x16 MCUs.
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    rgb = torch.nn.functional.pad(rgb.permute(2, 0, 1)[None],
                                  (0, W - w, 0, H - h),
                                  mode="replicate")[0]
    r, g, b = rgb
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b
    cb = cb.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))
    cr = cr.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))
    d = _dct_matrix()
    ql, qc = quant_tables(quality)
    zz = torch.from_numpy(_ZIGZAG)

    def quantise(plane, q):
        coef = d @ _blocks(plane) @ d.T  # (by, bx, 8, 8)
        coef = coef.reshape(*coef.shape[:2], 64)[..., zz]
        qz = torch.from_numpy(q[_ZIGZAG].astype(np.float32))
        return torch.round(coef / qz).clamp(-1023, 1023).to(torch.int16)

    yq = quantise(y, ql)  # (H/8, W/8, 64)
    cbq, crq = quantise(cb, qc), quantise(cr, qc)  # (H/16, W/16, 64)
    my, mx = H // 16, W // 16
    # Scan order: per MCU the four Y blocks (row-major), then Cb, Cr.
    yq = yq.reshape(my, 2, mx, 2, 64).permute(0, 2, 1, 3, 4).reshape(
        my, mx, 4, 64)
    mcu = torch.cat([yq, cbq[:, :, None], crq[:, :, None]], dim=2)
    blocks = np.ascontiguousarray(mcu.reshape(-1, 64).numpy())
    n = blocks.shape[0]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.int8), my * mx)
    table = np.minimum(comp, 1).astype(np.int8)
    dc = [_huffman_codes(t, 16) for t in (_DC_LUMA, _DC_CHROMA)]
    ac = [_huffman_codes(t, 256) for t in (_AC_LUMA, _AC_CHROMA)]
    dc_code = np.ascontiguousarray(np.stack([c for c, _ in dc]))
    dc_size = np.ascontiguousarray(np.stack([s for _, s in dc]))
    ac_code = np.ascontiguousarray(np.stack([c for c, _ in ac]))
    ac_size = np.ascontiguousarray(np.stack([s for _, s in ac]))
    cap = n * 64 * 6 + 1024
    out = np.empty(cap, np.uint8)
    nbytes = _load().jpeg_scan(
        blocks.ctypes.data, n, table.ctypes.data, comp.ctypes.data,
        dc_code.ctypes.data, dc_size.ctypes.data, ac_code.ctypes.data,
        ac_size.ctypes.data, out.ctypes.data, cap)
    if nbytes < 0:
        raise CodecError("JPEG scan overflowed its buffer")

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">HH", marker, len(body) + 2) + body

    head = b"\xff\xd8" + seg(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                     b"\x00\x00")
    for i, q in enumerate((ql, qc)):
        head += seg(0xFFDB, bytes([i]) + q[_ZIGZAG].astype(np.uint8)
                    .tobytes())
    head += seg(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls_id, t in ((0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA),
                      (0x11, _AC_CHROMA)):
        head += seg(0xFFC4, bytes([cls_id]) + bytes(t[0]) + bytes(t[1]))
    head += seg(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + out[:nbytes].tobytes() + b"\xff\xd9"
