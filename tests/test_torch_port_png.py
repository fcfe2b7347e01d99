"""The serving PNG decoder (lora_tpu_torch/serve.py _png_decode) on the
stdlib's zlib, against Pillow bit for bit: every colour type the decoder
takes (gray and palette also below 8 bits), each of the five scanline
filters (PNGs written here with a chosen filter per row), alpha dropped,
palettes with tRNS, odd sizes; the mask's luma against Pillow's
convert("L") and its threshold at 127, 128 and 129; the image and mask
fields against lora_tpu's Pillow-based decoders; the round trip through the
port's own encoder; and the refusals (16-bit, interlaced, corrupt)."""

import base64
import io
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lora_tpu_torch import serve as t_serve  # noqa: E402

# (colour type, bit depth) of every layout the decoder takes
LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4),
           (3, 8), (4, 8), (6, 8)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
SIZES = [(37, 53), (1, 1), (3, 200)]  # (height, width)
# a filter per row, cycled: each of None, Sub, Up, Average, Paeth, and
# every order of neighbours between them
FILTERS = (0, 1, 2, 3, 4, 4, 3, 1, 0, 2, 4, 1, 3)


@pytest.fixture
def Image():
    return pytest.importorskip("PIL.Image")


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter(ftype, line, prior, bpp):
    """One scanline filtered with `ftype` (the PNG specification's
    forward filters, on the reconstructed bytes; a type above 4, which is
    not valid, keeps the bytes as they are)."""
    out = []
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c), 0, 0)[ftype]
        out.append((x - pred) & 0xFF)
    return bytes([ftype] + out)


def _pack(samples, depth):
    """Rows of samples at `depth` bits packed into bytes, most significant
    first, each row padded to a whole byte."""
    if depth == 8:
        return samples.astype(np.uint8).reshape(samples.shape[0], -1)
    h, n = samples.shape[0], samples.reshape(samples.shape[0], -1).shape[1]
    per = 8 // depth
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = samples.reshape(h, -1)
    shifts = np.arange(8 - depth, -1, -depth)
    return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _png(samples, ctype, depth, filters=FILTERS, palette=None, trns=None,
         interlace=0, width=None):
    """A PNG of (H, W[, C]) samples written with the given filter per row
    (cycled)."""
    h = samples.shape[0]
    w = width or samples.shape[1]
    rows = _pack(samples, depth)
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    raw, prior = b"", bytes(rows.shape[1])
    for y in range(h):
        line = rows[y].tobytes()
        raw += _filter(filters[y % len(filters)], line, prior, bpp)
        prior = line
    body = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace)))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    return body + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND",
                                                                  b"")


def _random_png(ctype, depth, h, w, seed, trns=False):
    rng = np.random.default_rng(seed)
    if ctype == 3:
        n = min(1 << depth, 200)
        palette = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, (h, w))
        alpha = bytes(rng.integers(0, 256, n // 2 + 1).astype(np.uint8)) \
            if trns else None
        return _png(idx, 3, depth, palette=palette, trns=alpha)
    if ctype == 0:
        gray = rng.integers(0, 1 << depth, (h, w))
        return _png(gray, 0, depth,
                    trns=struct.pack(">H", int(gray[0, 0])) if trns else None)
    return _png(rng.integers(0, 256, (h, w, CHANNELS[ctype])), ctype, depth)


def _pillow(Image, data, mode):
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_decoder_matches_pillow(Image, layout, size):
    """RGB pixels and luma of every layout, each scanline filter, odd
    sizes, as Pillow decodes them."""
    ctype, depth = layout
    data = _random_png(ctype, depth, *size, seed=sum(layout) + size[1])
    rgb = t_serve._png_decode(data)
    assert rgb.dtype == np.uint8 and rgb.shape == size + (3,)
    np.testing.assert_array_equal(rgb, _pillow(Image, data, "RGB"))
    np.testing.assert_array_equal(t_serve._luma(rgb),
                                  _pillow(Image, data, "L"))


@pytest.mark.parametrize("layout", [(0, 8), (0, 4), (3, 8), (3, 2)])
def test_transparency_is_ignored_as_pillow_does(Image, layout):
    """tRNS (a palette's alpha table, a gray key) does not change the RGB
    pixels or the luma."""
    data = _random_png(*layout, 19, 23, seed=7, trns=True)
    rgb = t_serve._png_decode(data)
    np.testing.assert_array_equal(rgb, _pillow(Image, data, "RGB"))
    np.testing.assert_array_equal(t_serve._luma(rgb),
                                  _pillow(Image, data, "L"))


def test_pillow_written_pngs(Image):
    """PNGs as Pillow writes them (its own filter choice and zlib
    stream): RGB, RGBA, L, LA, 1-bit, and palettes of 256 and of 3
    colours (written at 2 bits)."""
    rng = np.random.default_rng(8)
    rgba = rng.integers(0, 256, (45, 31, 4), dtype=np.uint8)
    images = [Image.fromarray(rgba[..., :3]), Image.fromarray(rgba, "RGBA"),
              Image.fromarray(rgba[..., 0]), Image.fromarray(rgba[..., :2],
                                                             "LA"),
              Image.fromarray(rgba[..., 0]).convert("1"),
              Image.fromarray(rgba[..., :3]).convert("P"),
              Image.fromarray((rgba[..., 0] % 3).astype(np.uint8), "P")]
    images[-1].putpalette([255, 0, 0, 0, 128, 255, 17, 200, 3])
    for im in images:
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        data = buf.getvalue()
        rgb = t_serve._png_decode(data)
        np.testing.assert_array_equal(rgb, _pillow(Image, data, "RGB"),
                                      err_msg=im.mode)
        np.testing.assert_array_equal(t_serve._luma(rgb),
                                      _pillow(Image, data, "L"),
                                      err_msg=im.mode)


def test_luma_matches_pillow_on_every_channel_value(Image):
    """Pillow's integer ITU-R 601-2 luma over all 256 values of each
    channel against random others, and random colours."""
    rng = np.random.default_rng(9)
    ramp = np.arange(256, dtype=np.uint8)
    rgb = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    for c in range(3):
        rgb[c, :, :, c] = ramp[:, None]
    rgb = rgb.reshape(-1, 256, 3)
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(t_serve._luma(rgb), want)


def test_mask_threshold_at_127_128_129(Image):
    """Colours whose luma is 127, 128 and 129 give keep, repaint, repaint,
    as lora_tpu's Pillow-based _b64_to_mask does."""
    from lora_tpu import serve as j_serve

    rng = np.random.default_rng(10)
    cand = rng.integers(0, 256, (200000, 3), dtype=np.uint8)
    luma = t_serve._luma(cand)
    picks = [cand[np.flatnonzero(luma == v)[:4]] for v in (127, 128, 129)]
    px = np.concatenate(picks + [np.full((4, 3), v, np.uint8)
                                 for v in (127, 128, 129)])
    img = px.reshape(1, -1, 3)
    np.testing.assert_array_equal(
        np.asarray(Image.fromarray(img).convert("L"))[0],
        t_serve._luma(img)[0])
    b64 = base64.b64encode(t_serve._png_bytes(img)).decode()
    got = t_serve._b64_to_mask(b64, 2, img.shape[:2])
    want = j_serve._b64_to_mask(b64, 2, img.shape[:2])
    np.testing.assert_array_equal(got, want)
    expect = (t_serve._luma(img) >= 128).astype(np.float32)[None, ..., None]
    np.testing.assert_array_equal(got[:1], expect)
    assert got.reshape(-1)[:4].max() == 0 and got.reshape(-1)[4:12].min() == 1


@pytest.mark.parametrize("layout", [(2, 8), (6, 8), (3, 4), (0, 1)])
def test_request_fields_match_lora_tpu(Image, layout):
    """The image field ((n, H, W, 3) float32 in [-1, 1]) and the mask
    field, one PNG replicated and a list of two, as lora_tpu decodes them
    with Pillow."""
    from lora_tpu import serve as j_serve

    a = base64.b64encode(_random_png(*layout, 24, 40, seed=11)).decode()
    b = base64.b64encode(_random_png(*layout, 24, 40, seed=12)).decode()
    for field, n in ((a, 3), ([a, b], 2)):
        got = t_serve._b64_to_image(field, n)
        assert got.dtype == np.float32 and got.shape == (n, 24, 40, 3)
        np.testing.assert_array_equal(got, j_serve._b64_to_image(field, n))
        np.testing.assert_array_equal(
            t_serve._b64_to_mask(field, n, (24, 40)),
            j_serve._b64_to_mask(field, n, (24, 40)))


def test_round_trips_the_port_encoder():
    rng = np.random.default_rng(13)
    for h, w in ((1, 1), (37, 64), (64, 37)):
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            t_serve._png_decode(t_serve._png_bytes(rgb)), rgb)
    img = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
    got = t_serve._b64_to_image(t_serve._png_b64(img), 1)[0]
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want.astype(np.float32) / 127.5 - 1)


def test_gray_png_round_trips_and_pillow_reads_it_as_mode_l(Image):
    """A 2-D uint8 array is written as an 8-bit gray PNG (colour type 0):
    _png_decode gives it back replicated to RGB, data/dataset.py's
    read_image keeps its one channel, and Pillow opens it as mode "L"
    with the same bytes."""
    rng = np.random.default_rng(15)
    for h, w in ((1, 1), (37, 64), (64, 37)):
        gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
        data = t_serve._png_bytes(gray)
        assert data[25] == 0 and data[24] == 8  # IHDR colour type, depth
        np.testing.assert_array_equal(
            t_serve._png_decode(data), np.repeat(gray[..., None], 3, -1))
        with Image.open(io.BytesIO(data)) as img:
            assert img.mode == "L" and img.size == (w, h)
            np.testing.assert_array_equal(np.asarray(img), gray)


def test_gray_png_file_reads_as_one_channel(tmp_path):
    from lora_tpu_torch.data.dataset import read_image

    gray = np.random.default_rng(16).integers(0, 256, (9, 11),
                                              dtype=np.uint8)
    path = tmp_path / "m.png"
    path.write_bytes(t_serve._png_bytes(gray))
    np.testing.assert_array_equal(read_image(str(path)), gray[..., None])


def test_refusals_name_the_case():
    rng = np.random.default_rng(14)
    rgb = rng.integers(0, 256, (4, 5, 3))
    ok = _png(rgb, 2, 8)

    def header(depth, ctype):  # ok with its IHDR (bytes 8-33) replaced
        return ok[:8] + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 5, 4, depth, ctype, 0, 0, 0)) + ok[33:]

    cases = [
        (header(16, 2), "16-bit"),
        (_png(rgb, 2, 8, interlace=1), "interlaced"),
        (ok[:40] + bytes([ok[40] ^ 1]) + ok[41:], "CRC"),
        (ok[:-20], "truncated"),
        (b"\xff\xd8\xff\xe0" + ok[4:], "not a PNG"),
        (_png(rgb, 2, 8, filters=(5,)), "filter 5"),
        (_png(rng.integers(0, 2, (4, 5)), 3, 1), "PLTE"),
        (header(8, 5), "colour type 5"),
    ]
    for data, match in cases:
        with pytest.raises(ValueError, match=match):
            t_serve._png_decode(data)
    with pytest.raises(ValueError, match="'image' carries 1 PNGs for 2"):
        t_serve._b64_to_image([base64.b64encode(ok).decode()], 2)
    with pytest.raises(ValueError, match="does not match image size"):
        t_serve._b64_to_mask(base64.b64encode(ok).decode(), 1, (5, 4))
