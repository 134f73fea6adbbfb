"""The port's image codec (loupiote_tpu_torch/image_codec.py) against PIL,
which the reference decodes and encodes with.

- PNG decoding: byte-equal to PIL's ``Image.open(...).convert("RGBA")``
  (Pillow 12) on every colour type and bit depth of the PNG
  specification, plain and Adam7-interlaced, with and without ``tRNS``
  (files written by a small raw writer here, since PIL writes no
  interlaced file), and on the files PIL itself writes (modes 1, L, LA,
  P at 1, 2, 4 and 8 bits, RGB, RGBA, I;16, with transparency).
- PNG encoding: the port's and PIL's decoders give the image back exactly.
- JPEG encoding: PIL decodes the port's baseline files; on a denoised
  frame of the arch hall (the viewer's default mode) at quality 85 the
  PSNR against the input frame is at least 35 dB (measured: 39.89 dB,
  PIL's own encoder 39.83 dB on the same frame, Pillow 12.1).
- JPEG decoding: byte-equal to PIL's ``convert("RGBA")`` (Pillow 12.1,
  its libjpeg-turbo) on files PIL writes: colour at 4:4:4, 4:2:2 and
  4:2:0, at sizes that are and are not multiples of 8 and 16, without
  and with restart intervals (DRI, in blocks and in rows), greyscale,
  optimised Huffman tables, and on the port's own encoder's files. No
  tolerance: the port repeats libjpeg's islow IDCT, its fancy
  upsampling and its fixed-point YCbCr tables. Progressive,
  arithmetic-coded, 12-bit and CMYK files raise CodecError naming what
  they are.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import loupiote_tpu_torch as lt
from loupiote_tpu_torch import image_codec as ic

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _rows(samples, depth, filters):
    """Scanlines of (h, w, c) raw samples, each filtered with the next
    filter type of ``filters`` (0-4, cycled), as a PNG encoder would."""
    h, w, c = samples.shape
    bpp = max(c * depth // 8, 1)
    out, prev = b"", None
    for y in range(h):
        row = samples[y].reshape(-1)
        if depth == 16:
            raw = row.astype(">u2").tobytes()
        elif depth == 8:
            raw = row.astype(np.uint8).tobytes()
        else:
            per = 8 // depth
            pad = np.concatenate([row, np.zeros((-len(row)) % per,
                                                row.dtype)])
            shift = np.array([(per - 1 - i) * depth for i in range(per)])
            raw = (pad.reshape(-1, per).astype(np.int64) << shift).sum(1) \
                .astype(np.uint8).tobytes()
        a = np.frombuffer(raw, np.uint8).astype(np.int64)
        up = np.zeros_like(a) if prev is None else prev
        left = np.concatenate([np.zeros(bpp, np.int64), a[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        ft = filters[y % len(filters)]
        if ft == 0:
            f = a
        elif ft == 1:
            f = a - left
        elif ft == 2:
            f = a - up
        elif ft == 3:
            f = a - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
            f = a - pred
        out += bytes([ft]) + (f % 256).astype(np.uint8).tobytes()
        prev = a
    return out


def raw_png(samples, ctype, depth, plte=None, trns=None, interlace=False,
            filters=(0, 1, 2, 3, 4)):
    h, w, _ = samples.shape
    if interlace:
        data = b"".join(_rows(samples[y0::dy, x0::dx], depth, filters)
                        for x0, y0, dx, dy in _ADAM7
                        if samples[y0::dy, x0::dx].size)
    else:
        data = _rows(samples, depth, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(data))
            + _chunk(b"IEND", b""))


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


CASES = [(ct, d, il) for ct, depths in sorted(ic._DEPTHS.items())
         for d in depths for il in (False, True)]


@pytest.mark.parametrize("ctype, depth, interlace", CASES,
                         ids=[f"type{c}-{d}bit{'-adam7' if i else ''}"
                              for c, d, i in CASES])
def test_png_decode_matches_pil(ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth + interlace)
    c = ic._CHANNELS[ctype]
    for h, w in ((13, 17), (1, 1), (9, 3)):
        samples = rng.integers(0, 1 << depth, (h, w, c))
        plte = trns = None
        if ctype == 3:
            plte = rng.integers(0, 256, (1 << depth, 3))
            trns = rng.integers(0, 256, min(1 << depth, 5)).astype(
                np.uint8).tobytes()
        elif ctype in (0, 2) and depth <= 8:
            # A key that some pixels hold.
            key = samples[0, 0]
            trns = struct.pack(">" + "H" * c, *map(int, key))
        for t in (None, trns):
            data = raw_png(samples, ctype, depth, plte, t, interlace)
            got = ic.decode_png(data)
            assert got.dtype == np.uint8 and got.shape == (h, w, 4)
            np.testing.assert_array_equal(got, pil_rgba(data))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P1", "P2", "P4", "P8",
                                  "RGB", "RGBA", "I;16", "L-trns", "RGB-trns",
                                  "P-trns"])
def test_png_decode_matches_pil_on_pil_files(mode):
    rng = np.random.default_rng(7)
    h, w = 23, 31
    kw = {}
    if mode == "1":
        im = Image.fromarray(rng.random((h, w)) > 0.5)
    elif mode.startswith("L"):
        im = Image.fromarray(rng.integers(0, 256, (h, w, 2 if mode == "LA"
                                                     else 1), np.uint8)
                             .squeeze(), "LA" if mode == "LA" else "L")
        if mode == "L-trns":
            kw["transparency"] = int(np.asarray(im)[0, 0])
    elif mode.startswith("P"):
        bits = 8 if mode == "P-trns" else int(mode[1:])
        im = Image.fromarray(rng.integers(0, 1 << bits, (h, w), np.uint8),
                             "P")
        im.putpalette(rng.integers(0, 256, 768, np.uint8).tobytes())
        kw["bits"] = bits
        if mode == "P-trns":
            kw["transparency"] = bytes(rng.integers(0, 256, 7, np.uint8))
    elif mode.startswith("RGB"):
        c = 4 if mode == "RGBA" else 3
        im = Image.fromarray(rng.integers(0, 256, (h, w, c), np.uint8))
        if mode == "RGB-trns":
            kw["transparency"] = tuple(int(v) for v in np.asarray(im)[2, 3])
    else:
        im = Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16))
        assert im.mode == "I;16"
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    data = buf.getvalue()
    np.testing.assert_array_equal(ic.decode_png(data), pil_rgba(data))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_encode_round_trip(channels, tmp_path):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (29, 41, channels), np.uint8)
    img[5] = img[4]  # equal rows, runs of equal bytes
    data = ic.encode_png(img)
    back = ic.decode_png(data)
    np.testing.assert_array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 255).all()
    np.testing.assert_array_equal(pil_rgba(data)[..., :channels], img)
    path = str(tmp_path / "x.png")
    ic.write_png(path, img)
    np.testing.assert_array_equal(ic.read_png(path)[..., :channels], img)


def test_png_decode_refuses_bad_input():
    with pytest.raises(ic.CodecError):
        ic.decode_png(b"not a png")
    bad = raw_png(np.zeros((2, 2, 3), np.int64), 2, 8, filters=(7,))
    with pytest.raises(ic.CodecError, match="filter"):
        ic.decode_png(bad)
    with pytest.raises(ic.CodecError):
        ic.encode_png(np.zeros((2, 2), np.uint8))


@pytest.fixture(scope="module")
def denoised_frame():
    r = lt.Renderer((256, 128), lt.RenderConfig(downsample_factor=1.0),
                    device="cpu")
    r.set_resources(lt.build_scene_buffers(lt.build_arch_scene(20_000),
                                           device="cpu"))
    r.set_blit_mode(lt.BlitMode.DENOISED_PATHTRACE)
    for _ in range(2):
        r.raytrace(lt.arch_camera())
    return r.blit()


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / mse)


def test_jpeg_encode_decodes_in_pil_at_35db(denoised_frame):
    img = denoised_frame
    data = ic.encode_jpeg(img, 85)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    assert ic.is_jpeg(data)
    im = Image.open(io.BytesIO(data))
    assert im.format == "JPEG" and im.size == (256, 128)
    back = np.asarray(im.convert("RGB"))
    assert _psnr(back, img) >= 35.0
    # Higher quality, closer; the alpha channel is dropped.
    rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 7, np.uint8)],
                          axis=2)
    hi = np.asarray(Image.open(io.BytesIO(ic.encode_jpeg(rgba, 95)))
                    .convert("RGB"))
    assert _psnr(hi, img) > _psnr(back, img)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (37, 53), (16, 32)])
def test_jpeg_encode_any_size(shape):
    """Sizes that are not whole 16x16 MCUs (edge pixels replicated); a
    random image exercises long AC runs and large coefficients."""
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), np.uint8)
    im = Image.open(io.BytesIO(ic.encode_jpeg(img, 85)))
    assert im.size == (shape[1], shape[0])
    back = np.asarray(im.convert("RGB"))
    flat = np.full(shape + (3,), (200, 30, 90), np.uint8)
    flat_back = np.asarray(Image.open(io.BytesIO(ic.encode_jpeg(flat, 85)))
                           .convert("RGB"))
    assert back.shape == img.shape
    assert np.abs(flat_back.astype(int) - flat).max() <= 3


def test_quant_tables_follow_the_ijg_rule():
    ql, qc = ic.quant_tables(50)
    np.testing.assert_array_equal(ql, ic._Q_LUMA)
    np.testing.assert_array_equal(qc, ic._Q_CHROMA)
    assert ic.quant_tables(100)[0].max() == 1
    assert ic.quant_tables(1)[0].max() == 255
    ql85 = ic.quant_tables(85)[0]
    np.testing.assert_array_equal(ql85, np.clip((ic._Q_LUMA * 30 + 50)
                                                // 100, 1, 255))


# -- JPEG decoding ---------------------------------------------------------------

JPEG_SHAPES = [(64, 64), (33, 47), (17, 9), (5, 3), (2, 2)]


def _jpeg_source(shape, seed=3):
    """Smooth gradients plus noise, so every block has AC energy."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0) * 100 + 128, np.cos(y / 5.0) * 100 + 128,
                     ((x + y) % 64) * 4.0], axis=-1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _pil_jpeg(img, mode="RGB", **kw):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


@pytest.mark.parametrize("restart", ["none", "blocks", "rows"])
@pytest.mark.parametrize("shape", JPEG_SHAPES)
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_jpeg_decode_matches_pil(subsampling, shape, restart):
    kw = {"none": {}, "blocks": {"restart_marker_blocks": 1},
          "rows": {"restart_marker_rows": 1}}[restart]
    data = _pil_jpeg(_jpeg_source(shape), subsampling=subsampling, **kw)
    if restart != "none":
        assert b"\xff\xdd" in data  # a DRI segment
    got = ic.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == shape + (4,)
    assert got.tobytes() == _pil_rgba(data).tobytes()


@pytest.mark.parametrize("shape", JPEG_SHAPES)
def test_jpeg_decode_grey_matches_pil(shape):
    data = _pil_jpeg(_jpeg_source(shape), mode="L", quality=90)
    assert ic.decode_jpeg(data).tobytes() == _pil_rgba(data).tobytes()


@pytest.mark.parametrize("source", ["optimized", "q100", "port"])
def test_jpeg_decode_matches_pil_on_other_tables(source):
    """Huffman tables PIL optimises per file, quality 100 (quantisation
    steps of 1) and the port's own encoder (the standard tables)."""
    img = _jpeg_source((37, 53), seed=8)
    data = {"optimized": lambda: _pil_jpeg(img, optimize=True),
            "q100": lambda: _pil_jpeg(img, quality=100),
            "port": lambda: ic.encode_jpeg(img)}[source]()
    assert ic.decode_jpeg(data).tobytes() == _pil_rgba(data).tobytes()


def _patched_sof(data, marker=None, precision=None):
    """The file with its SOF0 marker or sample precision byte changed."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_jpeg_decode_refuses_what_it_does_not_decode():
    img = _jpeg_source((16, 16))
    cases = [(_pil_jpeg(img, progressive=True), "progressive"),
             (_pil_jpeg(img, mode="CMYK"), "CMYK"),
             (_patched_sof(_pil_jpeg(img), marker=0xC9), "arithmetic"),
             (_patched_sof(_pil_jpeg(img), precision=12), "12-bit"),
             (b"\xff\xd8\xff\xe0garbage", "truncated|ends"),
             (b"not a jpeg", "not a JPEG")]
    for data, what in cases:
        with pytest.raises(ic.CodecError, match=what):
            ic.decode_jpeg(data)
