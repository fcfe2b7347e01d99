"""The port's pivotal tuning and legacy TI datasets
(lora_tpu_torch/data/dataset.py PivotalTuningDataset, DreamBoothTiDataset,
generate_random_mask; data/preprocess.py) against lora_tpu's on images
the tests write, which lora_tpu reads through Pillow: at native size the
same examples bit for bit over 8 draws from the same seed (keys, shapes,
pixels, flips of the image, the mask and both inpainting arrays, texts,
ids) under each template, with token maps, filename captions,
mask-captioned JPEG data, face masks read from disk or written by the
ellipse fallback, and inpainting holes; the collated batches; and the
Gaussian blur of the face masks against Pillow's (GAUSSIAN_BLUR_TOL
levels)."""

import os
import random
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from PIL import ImageFilter  # noqa: E402

from lora_tpu.data import dataset as j_ds  # noqa: E402
from lora_tpu.data import preprocess as j_pre  # noqa: E402
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu_torch.data import dataset as t_ds  # noqa: E402
from lora_tpu_torch.data import preprocess as t_pre  # noqa: E402
from lora_tpu_torch.data.png import _png_bytes, _png_decode  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402

VOCAB = 1000
SIZE = 64
DRAWS = 8
TOKENS = ("<s1>", "<s2>")


def _write_png(path, pixels):
    with open(path, "wb") as f:
        f.write(_png_bytes(pixels))


def _images(d, n, seed, names=None):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        name = names[i] if names else f"img_{i}.png"
        _write_png(d / name, rng.integers(0, 256, (SIZE, SIZE, 3),
                                          dtype=np.uint8))
    return str(d)


def _tokenizers():
    j, t = JTokenizer(vocab_size=VOCAB), CLIPTokenizer(vocab_size=VOCAB)
    for tok in (j, t):
        tok.add_tokens(list(TOKENS))
    return j, t


def _check_draws(jd, td, n=DRAWS):
    """n examples of each, drawn in turn: the same keys, dtypes, shapes and
    values; returns the port's."""
    out = []
    for i in range(n):
        je, te = jd[i], td[i]
        assert sorted(te) == sorted(je)
        for k in je:
            if k == "text":
                assert te[k] == je[k]
                continue
            want, got = np.asarray(je[k]), np.asarray(te[k])
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        out.append(te)
    return out


def _pti_pair(root, **kw):
    jt, tt = _tokenizers()
    return (j_ds.PivotalTuningDataset(root, jt, size=SIZE, seed=3, **kw),
            t_ds.PivotalTuningDataset(root, tt, size=SIZE, seed=3, **kw))


@pytest.mark.parametrize("template", ["object", "style", "null"])
def test_templates_with_the_token_map(tmp_path, template):
    root = _images(tmp_path / "inst", 3, 0)
    examples = _check_draws(*_pti_pair(
        root, use_template=template, token_map={"DUMMY": "<s1><s2>"},
        color_jitter=True))
    bank = t_ds.TEMPLATE_MAP[template]
    assert all(e["text"] in [t.format("<s1><s2>") for t in bank]
               for e in examples)
    assert bank == j_ds.TEMPLATE_MAP[template]


def test_filename_captions_with_placeholder_at_data(tmp_path):
    """Captions from the file names, "sks" replaced by the tokens (the
    token map of placeholder_token_at_data "sks|<s1><s2>")."""
    names = ["a sks dog.png", "sks on grass.png", "plain.png"]
    root = _images(tmp_path / "inst", 3, 1, names)
    examples = _check_draws(*_pti_pair(root,
                                       token_map={"sks": "<s1><s2>"}))
    assert {e["text"] for e in examples} == {"a <s1><s2> dog",
                                             "<s1><s2> on grass", "plain"}


def test_mask_captioned_jpegs_through_pillow(tmp_path):
    """{i}.src.jpg (decoded by Pillow in both) with {i}.mask.png and
    caption.txt; the masks are one channel, * 0.5 + 1.0."""
    root = tmp_path / "inst"
    root.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3),
                                     dtype=np.uint8)).save(
            root / f"{i}.src.jpg", quality=90)
        _write_png(root / f"{i}.mask.png",
                   rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8))
    (root / "caption.txt").write_text(
        "a photo of sks\nsks in the snow\nsks at night\n")
    examples = _check_draws(*_pti_pair(str(root),
                                       use_mask_captioned_data=True,
                                       token_map={"sks": "<s1>"}))
    assert all(e["mask"].shape == (SIZE, SIZE, 1) for e in examples)
    assert all(0.5 <= e["mask"].min() and e["mask"].max() <= 1.5
               for e in examples)


def test_mask_captioned_jpeg_without_pillow_names_the_file(tmp_path,
                                                           monkeypatch):
    root = tmp_path / "inst"
    root.mkdir()
    Image.fromarray(np.zeros((SIZE, SIZE, 3), np.uint8)).save(
        root / "0.src.jpg")
    _write_png(root / "0.mask.png", np.zeros((SIZE, SIZE), np.uint8))
    (root / "caption.txt").write_text("sks\n")
    ds = t_ds.PivotalTuningDataset(str(root), _tokenizers()[1], size=SIZE,
                                   use_mask_captioned_data=True)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="0.src.jpg"):
        ds[0]


def test_face_masks_from_disk(tmp_path):
    root = _images(tmp_path / "inst", 3, 3)
    rng = np.random.default_rng(4)
    for i in range(3):
        _write_png(os.path.join(root, f"{i}.mask.png"),
                   rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8))
    before = sorted(os.listdir(root))
    examples = _check_draws(*_pti_pair(
        root, use_template="object", token_map={"DUMMY": "<s1>"},
        use_face_segmentation_condition=True))
    assert sorted(os.listdir(root)) == before  # nothing rewritten
    assert all(e["mask"].shape == (SIZE, SIZE, 1) for e in examples)


@pytest.mark.parametrize("blur_amount", [200, 70])
def test_face_masks_written_by_the_ellipse_fallback(tmp_path, blur_amount):
    """Missing masks: each package writes {i}.mask.png beside its copy of
    the images (lora_tpu through Pillow's blur and PNG writer, the port
    through its own), within GAUSSIAN_BLUR_TOL levels; then the same
    examples."""
    jr, tr = (_images(tmp_path / d, 2, 5) for d in ("j", "t"))
    jt, tt = _tokenizers()
    kw = dict(size=SIZE, seed=3, use_template="null",
              token_map={"DUMMY": "<s1>"},
              use_face_segmentation_condition=True, blur_amount=blur_amount)
    jd = j_ds.PivotalTuningDataset(jr, jt, **kw)
    td = t_ds.PivotalTuningDataset(tr, tt, **kw)
    for i in range(2):
        with Image.open(os.path.join(jr, f"{i}.mask.png")) as im:
            assert im.mode == "L"
            want = np.asarray(im)
        data = open(os.path.join(tr, f"{i}.mask.png"), "rb").read()
        with Image.open(os.path.join(tr, f"{i}.mask.png")) as im:
            assert im.mode == "L"  # the port writes gray PNGs
        got = _png_decode(data)[..., 0]
        diff = np.abs(got.astype(int) - want.astype(int)).max()
        assert diff <= t_pre.GAUSSIAN_BLUR_TOL, diff
    _check_draws(jd, td)


def test_inpainting_holes_and_flips(tmp_path):
    """The same holes and masked images; a flip turns the image, the face
    mask and both inpainting arrays together."""
    root = _images(tmp_path / "inst", 3, 6)
    rng = np.random.default_rng(7)
    for i in range(3):
        _write_png(os.path.join(root, f"{i}.mask.png"),
                   rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8))
    jd, td = _pti_pair(root, use_template="object",
                       token_map={"DUMMY": "<s1>"},
                       use_face_segmentation_condition=True,
                       train_inpainting=True)
    flips = []
    for i, e in enumerate(_check_draws(jd, td)):
        m = e["instance_masks"]
        assert set(np.unique(m)) <= {0.0, 1.0}
        np.testing.assert_array_equal(e["instance_masked_images"],
                                      e["instance_images"] * (m < 0.5))
        img = t_ds.load_image_norm(td.instance_images_path[i % 3], SIZE)
        mask = t_ds.load_image_norm(td.mask_path[i % 3], SIZE) * 0.5 + 1.0
        flipped = not np.array_equal(e["instance_images"], img)
        if flipped:
            img, mask = img[:, ::-1], mask[:, ::-1]
        np.testing.assert_array_equal(e["instance_images"], img)
        np.testing.assert_array_equal(e["mask"], mask)
        flips.append(flipped)
    assert any(flips) and not all(flips)


def test_generate_random_mask_matches():
    rng_j, rng_t = random.Random(11), random.Random(11)
    img = np.random.default_rng(8).uniform(-1, 1, (SIZE, 48, 3)).astype(
        np.float32)
    for _ in range(DRAWS):
        (jm, jmasked), (tm, tmasked) = (
            j_ds.generate_random_mask(img, rng_j),
            t_ds.generate_random_mask(img, rng_t))
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tmasked, jmasked)
    for h, w in ((SIZE, SIZE), (20, 300)):
        assert t_ds._get_cutout_holes(h, w, random.Random(1)) == \
            j_ds._get_cutout_holes(h, w, random.Random(1))


@pytest.mark.parametrize("prop", ["object", "style"])
def test_dreambooth_ti_dataset(tmp_path, prop):
    """The same prompts and ids with stochastic attributes, with prior
    preservation's class images."""
    root = _images(tmp_path / "inst", 3, 9)
    croot = _images(tmp_path / "class", 2, 10)
    jt, tt = _tokenizers()
    kw = dict(class_data_root=croot, class_prompt="a dog", size=SIZE,
              h_flip=True, seed=5, placeholder_token="<s1>",
              learnable_property=prop,
              stochastic_attribute="red,fluffy,small")
    jd = j_ds.DreamBoothTiDataset(root, "", jt, **kw)
    td = t_ds.DreamBoothTiDataset(root, "", tt, **kw)
    examples = _check_draws(jd, td)
    assert len({tuple(e["instance_prompt_ids"]) for e in examples}) > 1


def test_collated_batches_match(tmp_path):
    """data_loader over the PTI dataset with masks and inpainting, and over
    the TI dataset with prior preservation: the same batches."""
    root = _images(tmp_path / "inst", 3, 12)
    rng = np.random.default_rng(13)
    for i in range(3):
        _write_png(os.path.join(root, f"{i}.mask.png"),
                   rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8))
    jd, td = _pti_pair(root, use_template="object",
                       token_map={"DUMMY": "<s1>"},
                       use_face_segmentation_condition=True,
                       train_inpainting=True)
    croot = _images(tmp_path / "class", 2, 14)
    jt, tt = _tokenizers()
    kw = dict(class_data_root=croot, class_prompt="a dog", size=SIZE,
              seed=5, placeholder_token="<s1>")
    pairs = [((jd, td), dict(batch_size=2, seed=4)),
             ((j_ds.DreamBoothTiDataset(root, "", jt, **kw),
               t_ds.DreamBoothTiDataset(root, "", tt, **kw)),
              dict(batch_size=1, seed=4, prior_preservation=True))]
    wanted = ({"mask", "mask_values", "masked_image_values"},
              {"is_instance"})
    for ((j, t), kw), keys in zip(pairs, wanted):
        jl, tl = j_ds.data_loader(j, **kw), t_ds.data_loader(t, **kw)
        for _ in range(4):
            jb, tb = next(jl), next(tl)
            assert sorted(tb) == sorted(jb) and keys <= set(tb)
            for k in jb:
                assert tb[k].dtype == jb[k].dtype, k
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_gaussian_blur_matches_pillow():
    """The port's blur against Pillow's GaussianBlur on random and binary
    masks over sizes and radii (three box passes each way)."""
    rng = np.random.default_rng(15)
    for h, w in ((1, 1), (5, 7), (37, 53), (64, 64), (3, 200), (120, 90)):
        for radius in (0.5, 1, 2.5, 8.75, 25, 100):
            for m in (rng.integers(0, 256, (h, w), dtype=np.uint8),
                      ((rng.uniform(size=(h, w)) > 0.7) * 255).astype(
                          np.uint8)):
                want = np.asarray(Image.fromarray(m, "L").filter(
                    ImageFilter.GaussianBlur(radius)))
                got = t_pre._gaussian_blur(m, radius)
                assert got.dtype == np.uint8 and got.shape == want.shape
                diff = np.abs(got.astype(int) - want.astype(int)).max()
                assert diff <= t_pre.GAUSSIAN_BLUR_TOL, (h, w, radius, diff)


def test_ellipse_and_face_mask_fallback_match_lora_tpu(monkeypatch):
    """_ellipse_mask against lora_tpu's at the PTI phases' blur amounts,
    and face_mask_google_mediapipe's fallback (mediapipe cannot be
    imported) giving the ellipse for every image in both packages."""
    monkeypatch.setitem(sys.modules, "mediapipe", None)
    for size in ((64, 64), (640, 480), (33, 65)):
        for blur in (200, 70, 80):
            want = np.asarray(j_pre._ellipse_mask(size, blur))
            got = t_pre._ellipse_mask(size, blur)
            assert got.shape == want.shape == (size[1], size[0])
            diff = np.abs(got.astype(int) - want.astype(int)).max()
            assert diff <= t_pre.GAUSSIAN_BLUR_TOL, (size, blur, diff)
    imgs = [np.zeros((48, 80, 3), np.uint8), np.zeros((64, 64, 3), np.uint8)]
    got = t_pre.face_mask_google_mediapipe(imgs, blur_amount=200)
    want = j_pre.face_mask_google_mediapipe(
        [Image.fromarray(i) for i in imgs], blur_amount=200)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# boxes (x1, y1, x2, y2) on a 10 x 8 image: inside, across each edge and
# wholly outside each edge, corners on both sides of an integer
RECT_BOXES = [
    (2.7, 3.2, 2.9, 3.9), (1.0, 1.0, 6.5, 5.5),            # inside
    (-3.5, -2.2, -1.2, 4.0), (-1.5, 2.0, -1.0, 5.0),       # left of it
    (-1.5, 2.0, -0.99, 5.0), (-0.5, -0.5, -0.2, 3.0),      # truncate to 0
    (3.0, -5.0, 6.0, -1.0), (3.0, -5.0, 6.0, -0.5),        # above it
    (10.0, 2.0, 12.0, 4.0), (9.99, 7.99, 12.0, 12.0),      # right edge
    (3.0, 8.0, 6.0, 9.5), (2.0, 6.5, 5.0, 20.0),           # bottom edge
    (-2.0, -2.0, 12.0, 12.0), (-4.0, 3.0, 4.0, 3.0),       # across
]


@pytest.mark.parametrize("box", RECT_BOXES)
def test_fill_rectangle_matches_pillow(box):
    """The face box's fill gives Pillow's draw.rectangle(fill=255) bytes
    (lora_tpu/data/preprocess.py's draw) on boxes inside, across and
    wholly outside every edge of the image."""
    from PIL import ImageDraw

    want = Image.new("L", (10, 8), 0)
    ImageDraw.Draw(want).rectangle(list(box), fill=255)
    got = np.zeros((8, 10), np.uint8)
    t_pre._fill_rectangle(got, *box)
    np.testing.assert_array_equal(got, np.asarray(want))


class _Box:
    def __init__(self, xmin, ymin, width, height):
        self.xmin, self.ymin, self.width, self.height = (xmin, ymin, width,
                                                         height)


def _stub_mediapipe(boxes_per_image):
    """A stand-in for the mediapipe package: FaceDetection's process()
    returns the given relative boxes, one image after another (an empty
    list: no face)."""
    import types

    calls = iter(boxes_per_image)

    class FaceDetection:
        def __init__(self, model_selection, min_detection_confidence):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def process(self, arr):
            assert arr.ndim == 3 and arr.shape[-1] == 3
            dets = [types.SimpleNamespace(location_data=types.SimpleNamespace(
                relative_bounding_box=_Box(*b))) for b in next(calls)]
            return types.SimpleNamespace(detections=dets)

    mp = types.ModuleType("mediapipe")
    mp.solutions = types.SimpleNamespace(
        face_detection=types.SimpleNamespace(FaceDetection=FaceDetection))
    return mp


def test_face_mask_mediapipe_branch_matches_lora_tpu(monkeypatch):
    """face_mask_google_mediapipe with a stub mediapipe in sys.modules:
    faces inside, across an edge and wholly left of or above the image
    (drawing nothing, so the mask is the bias alone), and an image without
    a face (the ellipse), against lora_tpu's masks drawn by Pillow."""
    boxes = [[(0.2, 0.3, 0.4, 0.3)],
             [(-0.1, 0.5, 0.3, 0.7), (0.8, -0.2, 0.4, 0.5)],
             [(-0.5, 0.1, 0.3, 0.5), (0.2, -0.9, 0.5, 0.6)],
             []]
    imgs = [np.full((48, 80, 3), 100, np.uint8),
            np.zeros((64, 64, 3), np.uint8),
            np.zeros((40, 56, 3), np.uint8),
            np.zeros((32, 32, 3), np.uint8)]
    monkeypatch.setitem(sys.modules, "mediapipe", _stub_mediapipe(boxes))
    got = t_pre.face_mask_google_mediapipe(imgs, blur_amount=10)
    monkeypatch.setitem(sys.modules, "mediapipe", _stub_mediapipe(boxes))
    want = j_pre.face_mask_google_mediapipe(
        [Image.fromarray(i) for i in imgs], blur_amount=10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    bias = int(np.float32(0.05) * 255)
    assert (got[2] == bias).all()  # both boxes off the image: no face
