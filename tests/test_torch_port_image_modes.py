"""The port's image modes against lora_tpu's, in float32 on the tiny configs:
img2img (plain and with per-prompt routing through a stacked LoRA), the
9-channel inpaint and latent-blend inpaint under four samplers, each with
the JAX package's draws (its k_enc / k_noise / k_lat splits of the call's
key, and euler_a's fold_in draws) reproduced here and handed in; the kept
region's exactness in latent space; the rejections lora_tpu makes; the
latent-grid mask; and the draws taken from a torch.Generator."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import lora as j_lora  # noqa: E402
from lora_tpu.core.sites import unet_lora_sites  # noqa: E402
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.formats.safetensors_io import (  # noqa: E402
    UNET_DEFAULT_TARGET_REPLACE,
    save_safeloras_with_embeds,
)
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.pipelines import sd as j_sd  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax, state_dict_from_jax  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from lora_tpu_torch.models.config import TINY_TEXT, TINY_UNET, TINY_VAE  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.models.vae import VAE  # noqa: E402
from lora_tpu_torch.pipelines import sd as t_sd  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

PROMPTS = ["a photo of a dog", "a town at dusk"]
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_goldens.py's pipeline limits
LAT = (2, 8, 8, 4)  # the tiny VAE's latents of a 64x64 image


def _pipes(in_channels=4):
    """lora_tpu's and the port's tiny pipelines holding the same params
    (drawn by the port's random init)."""
    cfg = dataclasses.replace(TINY_UNET, in_channels=in_channels)
    pipe = t_sd.StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=cfg,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)
    params = [{k: v.numpy() for k, v in m.state_dict().items()}
              for m in (pipe.unet, pipe.text_encoder, pipe.vae)]
    jpipe = JPipe(unet_params={k: jnp.asarray(v) for k, v in params[0].items()},
                  text_params={k: jnp.asarray(v) for k, v in params[1].items()},
                  vae_params={k: jnp.asarray(v) for k, v in params[2].items()},
                  tokenizer=JTokenizer(vocab_size=TINY_TEXT.vocab_size),
                  unet_cfg=dataclasses.replace(j_cfg.TINY_UNET,
                                               in_channels=in_channels),
                  text_cfg=j_cfg.TINY_TEXT, vae_cfg=j_cfg.TINY_VAE)
    # the port's pipeline built from the same state dicts, as a user would
    modules = []
    for cls, c, p in ((UNet, cfg, params[0]), (CLIPTextModel, TINY_TEXT,
                                                 params[1]),
                      (VAE, TINY_VAE, params[2])):
        m = cls(c, device="cpu")
        m.load_state_dict(state_dict_from_jax(p), strict=True)
        modules.append(m)
    return jpipe, t_sd.StableDiffusionPipeline(
        *modules, CLIPTokenizer(vocab_size=TINY_TEXT.vocab_size))


@pytest.fixture(scope="module")
def pipes():
    return _pipes()


@pytest.fixture(scope="module")
def pipes9():
    return _pipes(in_channels=9)


def _image_and_mask(seed=0, n=2):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((n, 64, 64, 1), np.float32)
    mask[:, 8:40, 16:56] = 1.0       # repaint a box
    mask[-1, 40:] = 1.0              # and, in the last row, the bottom band
    return img, mask


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape,
                                                       jnp.float32)))


def _blend_draws(key, n_steps):
    """lora_tpu's inpaint_blend draws: the posterior noise from k_enc, the
    init noise from k_noise, euler_a's step i from fold_in(fold_in(key,
    777), i)."""
    k_enc, k_noise = jax.random.split(key)
    noise_rng = jax.random.fold_in(key, 777)
    return dict(posterior_noise=_normal(k_enc, LAT),
                init_noise=_normal(k_noise, LAT),
                step_noise=[_normal(jax.random.fold_in(noise_rng, i), LAT)
                            for i in range(n_steps)])


def test_img2img_matches_jax(pipes):
    """Strength 0.6 of 5 DDIM steps: the last 3, from the encoded image
    noised to the first of them."""
    jpipe, pipe = pipes
    img, _ = _image_and_mask()
    key = jax.random.PRNGKey(11)
    k_enc, k_noise = jax.random.split(key)
    kw = dict(strength=0.6, num_inference_steps=5, guidance_scale=7.5)
    want = jpipe.img2img(PROMPTS, jnp.asarray(img), rng=key, **kw)
    got = pipe.img2img(PROMPTS, torch.from_numpy(img),
                       posterior_noise=_normal(k_enc, LAT),
                       init_noise=_normal(k_noise, LAT), **kw)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_img2img_routed_through_stacked_lora_matches_jax(pipes, tmp_path):
    """lora_idx routes each prompt (and its CFG twin) through its own
    adapter of a two-adapter stack."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(3)
    sites = unet_lora_sites(j_cfg.TINY_UNET)
    path = str(tmp_path / "unet_lora.safetensors")
    save_safeloras_with_embeds({"unet": ([
        ((0.1 * rng.standard_normal((s.out_dim, 4))).astype(np.float32),
         (0.3 * rng.standard_normal((4, s.in_dim))).astype(np.float32))
        for s in sites], UNET_DEFAULT_TARGET_REPLACE)}, {}, path)
    jpipe.patch_pipe(path)
    other = {**jpipe.lora_unet, "sites": {
        n: {k: -0.5 * v for k, v in e.items()}
        for n, e in jpipe.lora_unet["sites"].items()}}
    stacked = j_lora.stack_loras([jpipe.lora_unet, other])
    jpipe.lora_unet = stacked
    pipe.lora_unet = lora_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          stacked))
    try:
        img, _ = _image_and_mask(seed=1)
        key = jax.random.PRNGKey(12)
        k_enc, k_noise = jax.random.split(key)
        kw = dict(strength=0.8, num_inference_steps=3, guidance_scale=7.5,
                  lora_idx=[1, 0])
        want = jpipe.img2img(PROMPTS, jnp.asarray(img), rng=key, **kw)
        got = pipe.img2img(PROMPTS, torch.from_numpy(img),
                           posterior_noise=_normal(k_enc, LAT),
                           init_noise=_normal(k_noise, LAT), **kw)
        np.testing.assert_allclose(got, want, **TOL)
        swapped = pipe.img2img(PROMPTS, torch.from_numpy(img),
                               posterior_noise=_normal(k_enc, LAT),
                               init_noise=_normal(k_noise, LAT),
                               **{**kw, "lora_idx": [0, 1]})
        assert np.abs(swapped - got).max() > 1e-4
    finally:
        jpipe.lora_unet = pipe.lora_unet = None


def test_inpaint_nine_channel_matches_jax(pipes9):
    """The 9-channel UNet's input [latents | mask | masked latents], 3 DDIM
    steps from latents drawn from k_lat."""
    jpipe, pipe = pipes9
    img, mask = _image_and_mask(seed=2)
    key = jax.random.PRNGKey(13)
    k_enc, k_lat = jax.random.split(key)
    kw = dict(num_inference_steps=3, guidance_scale=7.5)
    want = jpipe.inpaint(PROMPTS, jnp.asarray(img), jnp.asarray(mask),
                         rng=key, **kw)
    got = pipe.inpaint(PROMPTS, torch.from_numpy(img),
                       torch.from_numpy(mask),
                       posterior_noise=_normal(k_enc, LAT),
                       latents=_normal(k_lat, LAT), **kw)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scheduler", ["ddim", "euler", "euler_a", "dpm++"])
def test_inpaint_blend_matches_jax(pipes, scheduler):
    """Latent-blend inpainting at strength 0.75 of 4 steps under each
    sampler it takes; the kept region's final latents are the image's
    latents exactly, the repainted region's are not."""
    jpipe, pipe = pipes
    img, mask = _image_and_mask(seed=3)
    key = jax.random.PRNGKey(14)
    kw = dict(strength=0.75, num_inference_steps=4, guidance_scale=7.5,
              scheduler=scheduler)
    want = jpipe.inpaint_blend(PROMPTS, jnp.asarray(img), jnp.asarray(mask),
                               rng=key, **kw)
    got, lat, z0 = pipe.inpaint_blend(
        PROMPTS, torch.from_numpy(img), torch.from_numpy(mask),
        return_latents=True, **_blend_draws(key, 3), **kw)
    np.testing.assert_allclose(got, want, **TOL)
    small = t_sd._latent_mask(torch.from_numpy(mask), 8, 8,
                              torch.float32).numpy()
    keep = np.broadcast_to(small == 0, lat.shape)
    assert keep.any() and (~keep).any()
    np.testing.assert_array_equal(lat.numpy()[keep], z0.numpy()[keep])
    assert np.abs(lat.numpy()[~keep] - z0.numpy()[~keep]).max() > 1e-3


def test_rejections_match_jax(pipes, pipes9):
    """PNDM with blending, a strength that leaves no step, and each
    inpainting path on the other kind of UNet raise in both packages."""
    (jpipe, pipe), (jpipe9, pipe9) = pipes, pipes9
    img, mask = _image_and_mask(n=1)
    g = torch.Generator().manual_seed(0)
    ji, jm = jnp.asarray(img), jnp.asarray(mask)
    ti, tm = torch.from_numpy(img), torch.from_numpy(mask)
    for kw, match in ((dict(scheduler="pndm"), "pndm"),
                      (dict(strength=0.1, num_inference_steps=5),
                       "zero denoising steps"),
                      (dict(scheduler="lms"), "unknown scheduler")):
        with pytest.raises(ValueError, match=match):
            jpipe.inpaint_blend("x", ji, jm, **kw)
        with pytest.raises(ValueError, match=match):
            pipe.inpaint_blend("x", ti, tm, generator=g, **kw)
    with pytest.raises(AssertionError, match="in_channels=9"):
        jpipe.inpaint("x", ji, jm)
    with pytest.raises(ValueError, match="in_channels=9"):
        pipe.inpaint("x", ti, tm, generator=g)
    with pytest.raises(AssertionError, match="plain checkpoints"):
        jpipe9.inpaint_blend("x", ji, jm)
    with pytest.raises(ValueError, match="plain checkpoints"):
        pipe9.inpaint_blend("x", ti, tm, generator=g)
    # a strength that leaves no img2img step: lora_tpu fails indexing the
    # empty timestep list; the port names the cause
    with pytest.raises(IndexError):
        jpipe.img2img("x", ji, strength=0.0, num_inference_steps=5)
    with pytest.raises(ValueError, match="zero denoising steps"):
        pipe.img2img("x", ti, strength=0.0, num_inference_steps=5,
                     generator=g)
    with pytest.raises(ValueError, match="multiples of 64"):
        pipe.img2img("x", torch.zeros((1, 32, 32, 3)), generator=g)


def test_latent_mask_matches_jax():
    """Nearest sampling of the pixel mask onto the latent grid, at sizes
    whose ratio is not a whole number."""
    rng = np.random.default_rng(4)
    for (H, W), (h, w) in (((64, 64), (8, 8)), ((37, 53), (5, 7)),
                           ((100, 30), (13, 30))):
        mask = (rng.uniform(size=(2, H, W, 1)) > 0.5).astype(np.float32)
        want = np.asarray(j_sd._latent_mask(jnp.asarray(mask), h, w,
                                            jnp.float32))
        got = t_sd._latent_mask(torch.from_numpy(mask), h, w, torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)


def test_image_modes_draw_from_the_generator(pipes, pipes9):
    """Without the draws handed in, each mode takes them from the
    generator: the same seed gives the same images, another seed others,
    and no generator is an error."""
    _, pipe = pipes
    _, pipe9 = pipes9
    img, mask = _image_and_mask(seed=5)
    ti, tm = torch.from_numpy(img), torch.from_numpy(mask)
    calls = (
        lambda **k: pipe.img2img(PROMPTS, ti, num_inference_steps=3, **k),
        lambda **k: pipe9.inpaint(PROMPTS, ti, tm, num_inference_steps=2,
                                  **k),
        lambda **k: pipe.inpaint_blend(PROMPTS, ti, tm, scheduler="euler_a",
                                       num_inference_steps=3, **k))
    for call in calls:
        a, b, c = (call(generator=torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
        np.testing.assert_array_equal(a, b)
        assert np.abs(a - c).max() > 0
        assert np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0
        with pytest.raises(ValueError, match="generator"):
            call()
