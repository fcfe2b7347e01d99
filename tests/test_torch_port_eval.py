"""The port's CLIP vision tower (lora_tpu_torch/models/clip_vision.py) and
eval harness (utils/eval.py) against lora_tpu's on TINY_VISION /
TINY_TEXT, in f32: the image and text features within 1e-5 relative L2;
preprocess_images on Pillow's BICUBIC bytes (data/resample.py,
RESAMPLE_TOL levels) on odd sizes, up and down, gray and RGBA, and
within one level of lora_tpu's normalized pixels; image_grid's pixels;
text_img_alignment and clip_alignment_scores within 1e-5 on the same
images; evaluate_pipe's prompts, count and statistics, and a tiny pipe
scored by the in-port CLIP; visualize_progress's order and bounds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.models import clip_vision as j_cv  # noqa: E402
from lora_tpu.utils import eval as j_eval  # noqa: E402
from lora_tpu_torch.data import resample  # noqa: E402
from lora_tpu_torch.data.tokenizer import default_tokenizer  # noqa: E402
from lora_tpu_torch.models import clip_vision as t_cv  # noqa: E402
from lora_tpu_torch.models.clip import init_clip_text  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_TEXT,
    TINY_UNET,
    TINY_VAE,
)
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from lora_tpu_torch.utils import eval as t_eval  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

REL = 1e-5
VIS = t_cv.TINY_VISION


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def clip():
    """One flat dict of HF CLIPModel keys (the tiny vision tower, the tiny
    text model and a text_projection), as torch and as jnp."""
    gen = torch.Generator().manual_seed(0)
    params = {**t_cv.init_clip_vision(VIS, gen, device="cpu"),
              **init_clip_text(TINY_TEXT, gen, device="cpu")}
    params["text_projection.weight"] = torch.randn(
        (VIS.projection_dim, TINY_TEXT.hidden_size), generator=gen) * 0.02
    return params, {k: jnp.asarray(v.numpy()) for k, v in params.items()}


def images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in sizes]


def test_vision_tower_and_features(clip):
    params, jparams = clip
    module = t_cv.CLIPVision(VIS, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert sorted(module.state_dict()) == sorted(
        j_cv.init_clip_vision(j_cv.TINY_VISION, jax.random.PRNGKey(0)))
    assert "vision_model.pre_layrnorm.weight" in module.state_dict()
    x = np.random.default_rng(1).standard_normal(
        (3, VIS.image_size, VIS.image_size, 3)).astype(np.float32)
    got = t_cv.get_image_features(params, torch.from_numpy(x), VIS)
    want = j_cv.get_image_features(jparams, jnp.asarray(x), j_cv.TINY_VISION)
    assert got.shape == (3, VIS.projection_dim)
    assert rel_l2(got.numpy(), want) <= REL
    module.load_state_dict({k: v for k, v in params.items()
                            if k in module.state_dict()})
    with torch.no_grad():
        assert torch.equal(module(torch.from_numpy(x)), got)
    ids = np.array([[5, 7, 999, 999], [3, 4, 6, 999], [998, 2, 1, 0]])
    got = t_cv.get_text_features(params, torch.from_numpy(ids), TINY_TEXT)
    want = j_cv.get_text_features(jparams, jnp.asarray(ids), TINY_TEXT)
    assert got.shape == (3, VIS.projection_dim)
    assert rel_l2(got.numpy(), want) <= REL


SIZES = [(37, 53, 3), (300, 211, 3), (28, 28, 3), (13, 9, 3), (64, 20, 3),
         (9, 400, 3)]


@pytest.mark.parametrize("size", [28, 224])
def test_preprocess_images_within_one_level(size):
    """Each image resized as Pillow's BICUBIC to its bytes (RESAMPLE_TOL
    levels, 0) on every pixel, and the normalized pixels within one level
    of lora_tpu's; a gray and an RGBA image convert as Pillow's
    convert("RGB")."""
    imgs = images(2, SIZES) + images(3, [(21, 17)])
    rgba = images(4, [(30, 25, 4)])[0]
    imgs.append(rgba)
    for img in imgs:
        mode = "L" if img.ndim == 2 else {3: "RGB", 4: "RGBA"}[img.shape[-1]]
        pil = Image.fromarray(img, mode).convert("RGB").resize(
            (size, size), Image.BICUBIC)
        got = resample.resize(t_cv._rgb(img), (size, size), resample.BICUBIC)
        diff = np.abs(got.astype(int) - np.asarray(pil, int))
        assert diff.max() <= resample.RESAMPLE_TOL, (img.shape, size)
    got = t_cv.preprocess_images(imgs, size).numpy()
    want = np.asarray(j_cv.preprocess_images(
        [Image.fromarray(i) for i in imgs], size))
    std = np.asarray(t_cv.CLIP_IMAGE_STD, np.float32)
    assert got.shape == (len(imgs), size, size, 3)
    assert (np.abs(got - want) * std * 255).max() <= 1.0 + 1e-3


def test_image_grid():
    same = images(5, [(8, 6, 3)] * 5)
    for rows, cols in ((None, None), (2, None), (None, 4), (3, 2)):
        got = t_eval.image_grid(same, rows, cols)
        want = np.asarray(j_eval.image_grid(
            [Image.fromarray(i) for i in same], rows, cols))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    mixed = same[:2] + images(6, [(16, 4, 3)])
    got = t_eval.image_grid(mixed, rows=1, cols=3)
    want = np.asarray(j_eval.image_grid(
        [Image.fromarray(i) for i in mixed], rows=1, cols=3))
    assert got.shape == want.shape == (8, 18, 3)
    np.testing.assert_array_equal(got[:, :12], want[:, :12])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("channels", [2, 4])
def test_image_grid_with_alpha(channels):
    """A semi-transparent image of another size (gray or RGB with alpha,
    levels 0 and 255 among them) is resized with its alpha and then
    converted, as lora_tpu's image_grid does: Pillow's bytes."""
    same = images(7, [(8, 6, 3)] * 2)
    odd = images(8, [(16, 4, channels), (8, 6, channels)])
    odd[0][..., -1][::3] = 0
    odd[0][..., -1][1::3] = 255
    mode = {2: "LA", 4: "RGBA"}[channels]
    got = t_eval.image_grid(same + odd, rows=2, cols=2)
    want = np.asarray(j_eval.image_grid(
        [Image.fromarray(i) for i in same]
        + [Image.fromarray(i, mode) for i in odd], rows=2, cols=2))
    assert got.shape == want.shape == (16, 12, 3)
    np.testing.assert_array_equal(got, want)


def test_to_uint8():
    arr = np.array([[[-0.5, 0.0, 0.5], [1.5, 1.0, 0.25]]], np.float32)
    got = t_eval.to_uint8(arr)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(j_eval.to_pil(arr)))


def test_alignment_scores(clip):
    params, jparams = clip
    rng = np.random.default_rng(7)
    e = [torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
         for n in (3, 3, 2)]
    assert t_eval.text_img_alignment(*e) == j_eval.text_img_alignment(*e)
    gen, tgt = images(8, [(40, 30, 3)] * 2), images(9, [(50, 50, 3)] * 3)
    prompts = ["a dog", "a photo of a cat"]
    got = t_eval.clip_alignment_scores(
        gen, prompts, tgt, params, VIS, TINY_TEXT,
        default_tokenizer(vocab_size=TINY_TEXT.vocab_size))
    want = j_eval.clip_alignment_scores_jax(
        [Image.fromarray(i) for i in gen], prompts,
        [Image.fromarray(i) for i in tgt], jparams, j_cv.TINY_VISION,
        TINY_TEXT, JTokenizer(vocab_size=TINY_TEXT.vocab_size))
    assert set(got) == set(want) == {"text_alignment_avg",
                                     "image_alignment_avg"}
    for k in want:
        assert abs(got[k] - want[k]) <= REL * abs(want[k]), k
        assert -1.0 <= got[k] <= 1.0


class _StubPipe:
    """Records prompts and generators; returns a fixed tiny image."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []
        self.patched = []

    def __call__(self, prompt, **kw):
        self.calls.append((prompt, kw))
        v = 0.25 + 0.5 * (len(self.calls) % 2)
        return np.full((1, 4, 4, 3), v, np.float32)

    def patch_pipe(self, path):
        self.patched.append(path)


def test_evaluate_pipe_prompts_and_stats():
    got_pipe, want_pipe = _StubPipe(), _StubPipe()
    got = t_eval.evaluate_pipe(got_pipe, [], class_token="dog",
                               learnt_token="<s1>", n_test=3, n_step=2,
                               seed=5)
    want = j_eval.evaluate_pipe(want_pipe, [], class_token="dog",
                                learnt_token="<s1>", n_test=3, n_step=2,
                                seed=5)
    assert got == want and got["n_images"] == 3
    assert [c[0] for c in got_pipe.calls] == [
        t.replace("<obj>", "<s1>") for t in t_eval.EXAMPLE_PROMPTS[:3]]
    assert t_eval.EXAMPLE_PROMPTS == j_eval.EXAMPLE_PROMPTS
    for i, (_, kw) in enumerate(got_pipe.calls):
        assert kw["num_inference_steps"] == 2
        assert kw["guidance_scale"] == 5.0
        assert kw["generator"].initial_seed() == 5 + i


def test_evaluate_pipe_scores_a_tiny_pipe(clip):
    """A tiny pipe through evaluate_pipe with the in-port scorer: two
    images, finite scores in [-1, 1], the statistics of the images."""
    params, _ = clip
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_UNET,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)
    sets = {"params": params, "vision_cfg": VIS, "text_cfg": TINY_TEXT,
            "tokenizer": pipe.tokenizer}
    scores = t_eval.evaluate_pipe(pipe, images(10, [(64, 64, 3)]),
                                  class_token="dog", learnt_token="<s1>",
                                  clip_model_sets=sets, n_test=2, n_step=2)
    assert scores["n_images"] == 2
    for k in ("text_alignment_avg", "image_alignment_avg"):
        assert np.isfinite(scores[k]) and -1.0 <= scores[k] <= 1.0
    assert 0.0 <= scores["gen_mean"] <= 255.0 and scores["gen_std"] > 0.0


def test_visualize_progress_order_and_bounds(tmp_path):
    for i in [3, 1, 2, 0]:
        (tmp_path / f"step_{i}.safetensors").write_bytes(b"")
    got_pipe, want_pipe = _StubPipe(), _StubPipe()
    pattern = str(tmp_path / "step_*.safetensors")
    got = t_eval.visualize_progress(pattern, "a photo", got_pipe, offset=1,
                                    limit=3, seed=4)
    want = j_eval.visualize_progress(pattern, "a photo", want_pipe,
                                     offset=1, limit=3, seed=4)
    assert got_pipe.patched == want_pipe.patched == [
        str(tmp_path / "step_1.safetensors"),
        str(tmp_path / "step_2.safetensors")]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, np.asarray(w))
    assert all(kw["generator"].initial_seed() == 4 and
               (kw["height"], kw["width"]) == (512, 512)
               for _, kw in got_pipe.calls)
