"""The port's DreamBooth data path (lora_tpu_torch/data/dataset.py, no
Pillow for PNG) against lora_tpu's (Pillow) on PNGs written here: the same
pixels at native size, within one uint8 level (2/255 after * 2 - 1) after a
resize, the same random draws (shuffle order, flips, colour jitter) from the
same seed, the same batch keys and layouts (prior preservation's
[instance | class] rows and is_instance), the thread-pool loader, the image
geometry read from the PNG header, JPEG through Pillow only, and the
prefetch thread's end."""

import random
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from lora_tpu.data import dataset as j_ds  # noqa: E402
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu_torch.data import dataset as t_ds  # noqa: E402
from lora_tpu_torch.data.png import _png_bytes, png_size  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402

VOCAB = 1000
SIZE = 64
# a resize: Pillow's BILINEAR and F.interpolate(antialias=True) on uint8
# differ by at most one level on a few pixels (2/255 after * 2 - 1)
RESIZE_ATOL = 2 / 255 + 1e-6


def _write_png(path, rgb):
    with open(path, "wb") as f:
        f.write(_png_bytes(rgb))


def _images(d, sizes, seed):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        # smooth content plus noise: resizes see both edges and gradients
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + yy) % 256], -1)
        noise = rng.integers(-40, 40, (h, w, 3))
        _write_png(d / f"img_{i}.png",
                   np.clip(base + noise, 0, 255).astype(np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {
        "native": _images(root / "native", [(SIZE, SIZE)] * 3, 0),
        "class": _images(root / "class", [(SIZE, SIZE)] * 2, 1),
        "resize": _images(root / "resize",
                          [(100, 70), (45, 90), (64, 80), (130, 130)], 2),
    }


def _pair(root, **kw):
    j = j_ds.DreamBoothDataset(root, "a sks dog", JTokenizer(vocab_size=VOCAB),
                               size=SIZE, **kw)
    t = t_ds.DreamBoothDataset(root, "a sks dog", CLIPTokenizer(
        vocab_size=VOCAB), size=SIZE, **kw)
    return j, t


def _check_example(je, te, atol):
    assert sorted(je) == sorted(te)
    for k in je:
        want, got = np.asarray(je[k]), np.asarray(te[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("aug", [{}, {"h_flip": True},
                                 {"h_flip": True, "color_jitter": True}])
def test_dataset_matches_jax_at_native_size(dirs, aug):
    """Exact at native size, with the same flips and jitter drawn from the
    dataset's random.Random(seed), prior preservation's class images
    included."""
    j, t = _pair(dirs["native"], class_data_root=dirs["class"],
                 class_prompt="a dog", seed=3, **aug)
    assert len(j) == len(t) == 3
    for i in range(7):  # past the end: indices wrap, draws go on
        _check_example(j[i], t[i], atol=0)


def test_dataset_resized_within_a_level(dirs):
    j, t = _pair(dirs["resize"], h_flip=True, seed=4)
    worst = 0.0
    for i in range(len(j)):
        je, te = j[i], t[i]
        _check_example(je, te, atol=RESIZE_ATOL)
        worst = max(worst, float(np.abs(je["instance_images"]
                                        - te["instance_images"]).max()))
    assert worst > 0  # the resize really ran on both sides


@pytest.mark.parametrize("prior", [False, True])
def test_data_loader_matches_jax(dirs, prior):
    """The same batches in the same order: shuffled indices, flips and
    jitter, keys, dtypes and the [instance | class] layout."""
    kw = dict(class_data_root=dirs["class"], class_prompt="a dog") \
        if prior else {}
    j, t = _pair(dirs["native"], h_flip=True, color_jitter=True, seed=5,
                 **kw)
    jl = j_ds.data_loader(j, 2, seed=5, prior_preservation=prior)
    tl = t_ds.data_loader(t, 2, seed=5, prior_preservation=prior)
    for _ in range(5):
        jb, tb = next(jl), next(tl)
        _check_example(jb, tb, atol=0)
    assert tb["pixel_values"].shape == ((4 if prior else 2), SIZE, SIZE, 3)
    if prior:
        np.testing.assert_array_equal(tb["is_instance"], [1, 1, 0, 0])


def test_thread_pool_loader_gives_the_same_batches(dirs):
    """num_workers=2 decodes on threads; without augmentation its batches
    are the serial loader's."""
    def batches(workers):
        ds = t_ds.DreamBoothDataset(dirs["native"], "a sks dog",
                                    CLIPTokenizer(vocab_size=VOCAB),
                                    size=SIZE, seed=6)
        it = t_ds.data_loader(ds, 2, seed=6, num_workers=workers)
        out = [next(it) for _ in range(6)]
        it.close()
        return out

    serial, pooled = batches(0), batches(2)
    for a, b in zip(serial, pooled):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_png_size_and_crop_geometry(dirs, tmp_path):
    """The IHDR size equals Pillow's, and crop_geometry lora_tpu's."""
    paths = [f"{dirs['resize']}/img_{i}.png" for i in range(4)]
    gray = tmp_path / "gray.png"
    Image.fromarray(np.zeros((17, 29), np.uint8)).save(gray)
    for p in paths + [str(gray)]:
        with Image.open(p) as im:
            assert png_size(p) == im.size == t_ds.image_size(p)
        w, h = png_size(p)
        for resize in (True, False):
            np.testing.assert_array_equal(
                t_ds.crop_geometry(w, h, SIZE, resize),
                j_ds.crop_geometry(w, h, SIZE, resize))
    with pytest.raises(ValueError, match="not a PNG"):
        png_size(__file__)


def test_gray_png_keeps_one_channel(tmp_path):
    """An 8-bit gray PNG stays one channel (Pillow's mode "L", which
    lora_tpu keeps); a palette PNG becomes RGB."""
    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 255, (SIZE, SIZE), dtype=np.uint8)).save(
        tmp_path / "g.png")
    Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)
                    ).convert("P").save(tmp_path / "p.png")
    for name, channels in (("g.png", 1), ("p.png", 3)):
        path = str(tmp_path / name)
        got = t_ds.load_image_norm(path, SIZE)
        want = j_ds.load_image_norm(path, SIZE)
        assert got.shape == want.shape == (SIZE, SIZE, channels)
        np.testing.assert_array_equal(got, want)


def test_jpeg_reads_through_pillow_only(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    path = tmp_path / "photo.jpg"
    Image.fromarray(rng.integers(0, 255, (SIZE, 80, 3), dtype=np.uint8)
                    ).save(path)
    got = t_ds.load_image_norm(str(path), SIZE)
    np.testing.assert_allclose(got, j_ds.load_image_norm(str(path), SIZE),
                               rtol=0, atol=RESIZE_ATOL)
    assert t_ds.image_size(str(path)) == (80, SIZE)
    # without Pillow (the card's machine): a ValueError naming the file
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for fn in (lambda p: t_ds.load_image_norm(p, SIZE), t_ds.image_size):
        with pytest.raises(ValueError, match="photo.jpg.*convert the image "
                           "to PNG"):
            fn(str(path))


def test_prefetch_thread_ends_after_close():
    """An abandoned endless loader's worker thread ends (it would
    otherwise block in q.put for the rest of the process)."""
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = set(threading.enumerate())
    it = t_ds.prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    (worker,) = [th for th in set(threading.enumerate()) - before
                 if th.name == "lora_tpu_torch_prefetch"]
    it.close()
    worker.join(timeout=10)
    assert not worker.is_alive()


def test_prefetch_raises_the_workers_error():
    def failing():
        yield 1
        raise RuntimeError("decode failed")

    it = t_ds.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_device_prefetch_keeps_host_keys():
    batches = [{"pixel_values": np.full((1, 2), i, np.float32),
                "input_ids": np.full((1, 3), i, np.int64)} for i in range(4)]
    out = list(t_ds.device_prefetch(iter(batches), depth=2, device="cpu",
                                    keep_on_host=("input_ids",)))
    assert len(out) == 4
    for i, b in enumerate(out):
        assert isinstance(b["pixel_values"], torch.Tensor)
        assert isinstance(b["input_ids"], np.ndarray)
        assert b["pixel_values"][0, 0].item() == i == b["input_ids"][0, 0]


def test_color_jitter_draws_match():
    arr = np.random.default_rng(9).random((8, 8, 3), dtype=np.float32)
    a, b = random.Random(1), random.Random(1)
    np.testing.assert_array_equal(t_ds._color_jitter(arr, a),
                                  j_ds._color_jitter(arr, b))
    assert a.random() == b.random()
