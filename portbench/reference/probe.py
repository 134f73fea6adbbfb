"""Radiance ``.hdr`` decoding and the probe's tables: a frozen copy of
the port's ``loupiote_tpu_torch/scene/hdr.py``.

The probe is decoded once on the host to float32 radiance, with the
luminance CDF tables that importance-sample it (``ops/env.py``). Two
parts are written anew in numpy, because the card's host has neither
imageio nor OpenCV: ``read_hdr`` (the reference reads through imageio),
and the area-average downsampling of the luminance to the sampling grid
(the reference calls ``cv2.resize(..., INTER_AREA)``; ``_resize_area``
repeats OpenCV's arithmetic, so the tables are byte-equal).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """Decode (..., 4) uint8 RGBE to (..., 3) float32 radiance."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.exp2(e - (128.0 + 8.0)), 0.0)
    return rgbe[..., :3] * scale[..., None]


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """Encode (..., 3) float32 to (..., 4) uint8 RGBE."""
    maxc = rgb.max(axis=-1)
    valid = maxc >= 1e-32
    _, exp = np.frexp(np.maximum(maxc, 1e-32))  # maxc = m * 2^exp, m in [0.5,1)
    scale = np.where(valid, np.exp2(-exp.astype(np.float64) + 8.0), 0.0)
    mant = np.clip(np.rint(rgb * scale[..., None]), 0, 255).astype(np.uint8)
    e = np.where(valid, exp + 128, 0).astype(np.uint8)
    return np.concatenate([mant, e[..., None]], axis=-1)


def _rle_scanline(buf: bytes, pos: int, width: int):
    """One new-style run-length scanline (after its 2, 2, hi, lo word):
    each of the four channels as runs, a count byte > 128 repeating the
    next byte count - 128 times, else count literal bytes."""
    line = np.empty((4, width), np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            count = buf[pos]
            pos += 1
            if count > 128:
                n = count - 128
                if x + n > width:
                    raise ValueError("RLE run past the end of a scanline")
                line[c, x:x + n] = buf[pos]
                pos += 1
            else:
                n = count
                if n == 0 or x + n > width:
                    raise ValueError("bad RLE literal run")
                line[c, x:x + n] = np.frombuffer(buf, np.uint8, n, pos)
                pos += n
            x += n
    return line.T, pos


def read_hdr(path_or_bytes) -> np.ndarray:
    """Read a Radiance .hdr file (a path or its bytes) -> (H, W, 3)
    float32 linear radiance. Takes the header, a ``-Y H +X W``
    resolution line, and flat or new-style run-length scanlines."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if not buf.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    pos = 0
    while True:  # header lines up to the blank one
        end = buf.index(b"\n", pos)
        line = buf[pos:end].strip()
        pos = end + 1
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"unsupported format {line!r}")
        if not line:
            break
    end = buf.index(b"\n", pos)
    res = buf[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported resolution line {res!r}")
    h, w = int(res[1]), int(res[3])
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        head = buf[pos:pos + 4]
        if (8 <= w <= 0x7FFF and len(head) == 4 and head[0] == 2
                and head[1] == 2 and not head[2] & 0x80):
            if (head[2] << 8 | head[3]) != w:
                raise ValueError("RLE scanline width mismatch")
            rgbe[y], pos = _rle_scanline(buf, pos + 4, w)
        else:
            flat = np.frombuffer(buf, np.uint8, 4 * w, pos)
            rgbe[y] = flat.reshape(w, 4)
            pos += 4 * w
    return np.ascontiguousarray(rgbe_to_float(rgbe))


@dataclass
class Probe:
    """Equirect environment probe + luminance CDFs for importance sampling.

    The CDF/pdf tables live on a coarse grid (capped at ``SAMPLE_RES``),
    so a ray's CDF bisection in ops/env.py stays cheap; radiance stays at
    full resolution. Sampling the coarse distribution with its own exact
    pdf keeps the estimator unbiased.
    """

    radiance: np.ndarray  # (H, W, 3) float32
    cdf_cond: np.ndarray  # (Hc, Wc) float32: per-row conditional CDF
    cdf_marg: np.ndarray  # (Hc,) float32: marginal CDF over rows
    pdf: np.ndarray  # (Hc, Wc) float32: solid-angle pdf (per coarse texel)

    @property
    def width(self) -> int:
        return self.radiance.shape[1]

    @property
    def height(self) -> int:
        return self.radiance.shape[0]


SAMPLE_RES = (64, 128)  # (Hc, Wc) cap for the sampling grid


def _area_weights(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: (destination, source, float32
    weight) of each source cell a destination cell covers, in order."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2,
                        np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    return tab


def _resize_area(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """``cv2.resize(src, (dw, dh), interpolation=cv2.INTER_AREA)`` of a
    float64 (H, W) array no smaller than (dh, dw), with OpenCV's order of
    sums and float32 weights: integer scales average each block in sums
    of four; others weight each covered cell by its share."""
    sh, sw = src.shape
    sx, sy = 1.0 / (dw / sw), 1.0 / (dh / sh)
    ix, iy = round(sx), round(sy)
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        area = ix * iy
        blk = (src[:dh * iy, :dw * ix].reshape(dh, iy, dw, ix)
               .transpose(0, 2, 1, 3).reshape(dh, dw, area))
        total = np.zeros((dh, dw))
        k = 0
        while k <= area - 4:
            total = total + (((blk[..., k] + blk[..., k + 1])
                              + blk[..., k + 2]) + blk[..., k + 3])
            k += 4
        while k < area:
            total = total + blk[..., k]
            k += 1
        return total * np.float64(np.float32(1.0) / np.float32(area))
    rows = np.zeros((sh, dw))
    for d, s, a in _area_weights(sw, dw, sx):
        rows[:, d] = rows[:, d] + src[:, s] * np.float64(a)
    out = np.zeros((dh, dw))
    for d, s, a in _area_weights(sh, dh, sy):
        out[d] = out[d] + np.float64(a) * rows[s]
    return out


def build_probe(radiance: np.ndarray, sample_res=SAMPLE_RES) -> Probe:
    h, w = radiance.shape[:2]
    lum = (0.2126 * radiance[..., 0] + 0.7152 * radiance[..., 1]
           + 0.0722 * radiance[..., 2]).astype(np.float64)

    hc, wc = min(h, sample_res[0]), min(w, sample_res[1])
    lum_c = _resize_area(lum, hc, wc) if (hc, wc) != (h, w) else lum

    # sin(theta) weight for equirect solid-angle measure.
    theta = (np.arange(hc, dtype=np.float64) + 0.5) / hc * np.pi
    weight = lum_c * np.sin(theta)[:, None]
    weight = np.maximum(weight, 1e-12)

    row_sum = weight.sum(axis=1)
    cdf_cond = np.cumsum(weight, axis=1) / row_sum[:, None]
    cdf_marg = np.cumsum(row_sum) / row_sum.sum()

    # pdf over the coarse (u, v) texel grid in solid-angle measure:
    # p(dir) = p(u,v) / (2 pi^2 sin(theta))
    p_uv = weight / weight.sum() * (hc * wc)
    sin_t = np.maximum(np.sin(theta), 1e-8)
    pdf = p_uv / (2.0 * np.pi * np.pi * sin_t[:, None])

    return Probe(
        radiance=radiance.astype(np.float32),
        cdf_cond=cdf_cond.astype(np.float32),
        cdf_marg=cdf_marg.astype(np.float32),
        pdf=pdf.astype(np.float32),
    )


def load_probe(path: str) -> Probe:
    return build_probe(read_hdr(path))
