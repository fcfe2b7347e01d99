"""The port's native resize (lora_tpu_torch/native/imgops.c, bound through
ctypes) against lora_tpu's native module (lora_tpu/native/imgops.c, a
CPython extension): the same arithmetic on the same uint8 bytes, so the
outputs are compared bit for bit. Against the port's own F.interpolate
path it is held on smooth content, as tests/test_native.py holds
lora_tpu's: the native resize samples bilinearly without antialiasing,
the other path antialiases. With LORA_TPU_TORCH_NATIVE_IMGOPS=1 a failed
build raises with the compiler's message."""

import random

import numpy as np
import pytest

pytest.importorskip("torch")

from lora_tpu.native.build import get_imgops  # noqa: E402
from lora_tpu_torch.data import dataset as t_ds  # noqa: E402
from lora_tpu_torch.data.png import _png_bytes  # noqa: E402
from lora_tpu_torch.native import build as t_native  # noqa: E402

# mean |native - antialiased| over an image of smooth content: the filters
# differ by design; tests/test_native.py's limit for lora_tpu's
SMOOTH_MEAN_ABS = 0.02


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's library built into a fresh directory (no earlier build is
    reused), and lora_tpu's extension."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LORA_TPU_TORCH_BUILD_DIR",
              str(tmp_path_factory.mktemp("native_build")))
    mp.setattr(t_native, "_lib", None)
    mod = get_imgops()
    if mod is None:
        mp.undo()
        pytest.skip("no C toolchain for lora_tpu's extension")
    yield mod
    mp.undo()


def _smooth_image(h, w):
    ys, xs = np.indices((h, w)).astype(np.float32)
    r = np.sin(ys / 37) * 0.5 + 0.5
    g = np.cos(xs / 23) * 0.5 + 0.5
    b = (ys + xs) / (h + w)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


@pytest.mark.parametrize("h, w, c, size", [
    (80, 120, 3, 64),     # landscape: the crop's left offset
    (120, 80, 1, 64),     # portrait, one gray channel
    (37, 53, 3, 64),      # upscale
    (64, 64, 3, 64),      # no resize
    (768, 1152, 3, 512),  # the rows split over the eight threads
])
def test_bit_identical_to_lora_tpu(built, h, w, c, size):
    a = np.random.default_rng(h * w + c).integers(0, 256, (h, w, c),
                                                  dtype=np.uint8)
    got = t_native.resize_crop_normalize(a, size)
    want = np.frombuffer(built.resize_crop_normalize(a.tobytes(), h, w, c,
                                                     size),
                         np.float32).reshape(size, size, c)
    assert got.dtype == np.float32 and got.shape == (size, size, c)
    np.testing.assert_array_equal(got, want)


def test_load_image_norm_switch(built, tmp_path, monkeypatch):
    """The variable sends a PNG's resize through the native code (its bits
    exactly), near the F.interpolate path on smooth content; with colour
    jitter, or without a resize, the Python path runs."""
    arr = _smooth_image(300, 400)
    path = tmp_path / "smooth.png"
    path.write_bytes(_png_bytes(arr))
    plain = t_ds.load_image_norm(str(path), 128)
    monkeypatch.setenv(t_ds.NATIVE_IMGOPS_ENV, "1")
    native = t_ds.load_image_norm(str(path), 128)
    np.testing.assert_array_equal(native,
                                  t_native.resize_crop_normalize(arr, 128))
    assert native.shape == plain.shape == (128, 128, 3)
    assert native.min() >= -1.0 and native.max() <= 1.0
    assert np.abs(native - plain).mean() < SMOOTH_MEAN_ABS
    assert not np.array_equal(native, plain)
    for kw in (dict(color_jitter=True), dict(resize=False)):
        monkeypatch.setenv(t_ds.NATIVE_IMGOPS_ENV, "1")
        on = t_ds.load_image_norm(str(path), 128, rng=random.Random(0), **kw)
        monkeypatch.delenv(t_ds.NATIVE_IMGOPS_ENV)
        off = t_ds.load_image_norm(str(path), 128, rng=random.Random(0),
                                   **kw)
        np.testing.assert_array_equal(on, off)


def test_failed_build_raises(tmp_path, monkeypatch):
    """CC=/bin/false with the variable set: load_image_norm raises with the
    build's failure; nothing falls back."""
    monkeypatch.setenv("LORA_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setenv("CC", "/bin/false")
    monkeypatch.setenv(t_ds.NATIVE_IMGOPS_ENV, "1")
    pixels = _smooth_image(40, 60)
    with pytest.raises(RuntimeError, match="imgops.c with '/bin/false' "
                                           "failed"):
        t_ds.load_image_norm(pixels, 32)
    monkeypatch.setenv("CC", str(tmp_path / "no_such_compiler"))
    with pytest.raises(RuntimeError, match="failed"):
        t_ds.load_image_norm(pixels, 32)
    assert not list((tmp_path / "b").glob("*.so"))
    monkeypatch.delenv(t_ds.NATIVE_IMGOPS_ENV)
    assert t_ds.load_image_norm(pixels, 32).shape == (32, 32, 3)


def test_bad_dimensions_raise(built):
    with pytest.raises(ValueError, match="pixels"):
        t_native.resize_crop_normalize(np.zeros((4, 4), np.uint8), 2)
    with pytest.raises(ValueError, match="bad dimensions"):
        t_native.resize_crop_normalize(np.zeros((4, 4, 3), np.uint8), 0)
