"""The port's txt2img pipeline against lora_tpu's on the tiny configs, in
float32: the same params, the same latents from numpy, the same LoRA + TI
file written by lora_tpu, 3 DDIM steps with CFG 7.5. The 128x128 case puts
T = 256 tokens at the top attention level, the shape that routes to the
flash kernel on a card (the CPU runs its plain version)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import lora as j_lora  # noqa: E402
from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_lora_sites,
    unet_lora_sites,
)
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.formats.safetensors_io import (  # noqa: E402
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    save_safeloras_with_embeds,
)
from lora_tpu.models.config import TINY_TEXT, TINY_UNET, TINY_VAE  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax, state_dict_from_jax  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.models.vae import VAE  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "tiny_golden.npz")
PROMPTS = ["a photo of <s1> dog", "a <s1> style town"]
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_goldens.py's pipeline limits


def _port_pipe(unet_p, text_p, vae_p):
    """A port pipeline holding the given numpy params."""
    modules = []
    for cls, cfg, params in ((UNet, TINY_UNET, unet_p),
                             (CLIPTextModel, TINY_TEXT, text_p),
                             (VAE, TINY_VAE, vae_p)):
        m = cls(cfg, device="cpu")
        m.load_state_dict(state_dict_from_jax(params), strict=True)
        modules.append(m)
    return StableDiffusionPipeline(
        *modules, CLIPTokenizer(vocab_size=TINY_TEXT.vocab_size))


@pytest.fixture(scope="module")
def params():
    """Numpy params for both packages, drawn by the port's random init."""
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_UNET,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)
    return tuple({k: v.numpy() for k, v in m.state_dict().items()}
                 for m in (pipe.unet, pipe.text_encoder, pipe.vae))


def _pipes(params):
    unet_p, text_p, vae_p = params
    jpipe = JPipe(unet_params={k: jnp.asarray(v) for k, v in unet_p.items()},
                  text_params={k: jnp.asarray(v) for k, v in text_p.items()},
                  vae_params={k: jnp.asarray(v) for k, v in vae_p.items()},
                  tokenizer=JTokenizer(vocab_size=TINY_TEXT.vocab_size),
                  unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)
    return jpipe, _port_pipe(unet_p, text_p, vae_p)


def _lora_file(tmp_path, seed=0):
    """A rank-4 LoRA over the default UNet and text sites with nonzero up,
    plus one TI embed, written by lora_tpu."""
    rng = np.random.default_rng(seed)
    modelmap = {}
    for model, sites, target in (
            ("unet", unet_lora_sites(TINY_UNET), UNET_DEFAULT_TARGET_REPLACE),
            ("text_encoder", text_encoder_lora_sites(TINY_TEXT),
             TEXT_ENCODER_DEFAULT_TARGET_REPLACE)):
        modelmap[model] = ([
            ((0.1 * rng.standard_normal((s.out_dim, 4))).astype(np.float32),
             (0.3 * rng.standard_normal((4, s.in_dim))).astype(np.float32))
            for s in sites], target)
    embeds = {"<s1>": rng.standard_normal(TINY_TEXT.hidden_size)
              .astype(np.float32)}
    path = str(tmp_path / f"lora{seed}.safetensors")
    save_safeloras_with_embeds(modelmap, embeds, path)
    return path


def test_golden_without_lora():
    """The JAX package's frozen DDIM image (its PRNGKey(0) params and
    latents), reproduced by the port."""
    jpipe = JPipe.random_init(jax.random.PRNGKey(0), unet_cfg=TINY_UNET,
                              text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)
    pipe = _port_pipe(*({k: np.asarray(v) for k, v in p.items()} for p in (
        jpipe.unet_params, jpipe.text_params, jpipe.vae_params)))
    lat = np.array(jpipe.prepare_latents(1, 64, 64, jax.random.PRNGKey(7)))
    out = pipe("golden prompt", num_inference_steps=3, height=64, width=64,
               latents=torch.from_numpy(lat))
    np.testing.assert_allclose(out, np.load(GOLDEN)["pipe_ddim"], **TOL)


def test_patched_lora_and_ti_match_jax(params, tmp_path):
    jpipe, pipe = _pipes(params)
    path = _lora_file(tmp_path)
    assert list(jpipe.patch_pipe(path)) == list(pipe.patch_pipe(path))
    jpipe.tune_lora_scale(0.8)
    pipe.tune_lora_scale(0.8)
    assert jpipe.tokenizer(PROMPTS) == pipe.tokenizer(PROMPTS)
    lat = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    ref = jpipe(PROMPTS, num_inference_steps=3, guidance_scale=7.5,
                height=64, width=64, latents=jnp.asarray(lat))
    out = pipe(PROMPTS, num_inference_steps=3, guidance_scale=7.5,
               height=64, width=64, latents=torch.from_numpy(lat))
    assert out.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(out, ref, **TOL)

    pipe.remove_lora()
    assert pipe.lora_unet is None and pipe.lora_text is None
    base = pipe(PROMPTS, num_inference_steps=3, guidance_scale=7.5,
                height=64, width=64, latents=torch.from_numpy(lat))
    assert np.abs(base - out).max() > 1e-4


def test_stacked_loras_routed_per_prompt_at_128px(params, tmp_path):
    """lora_idx routes each prompt (and its CFG twin) through its own
    adapter of a stacked LoRA; at 128x128 the top attention level has
    T = S = 256 tokens."""
    jpipe, pipe = _pipes(params)
    path = _lora_file(tmp_path, seed=3)
    jpipe.patch_pipe(path)
    pipe.patch_pipe(path)
    other = {**jpipe.lora_unet, "sites": {
        n: {k: -0.5 * v for k, v in e.items()}
        for n, e in jpipe.lora_unet["sites"].items()}}
    stacked = j_lora.stack_loras([jpipe.lora_unet, other])
    jpipe.lora_unet = stacked
    pipe.lora_unet = lora_from_jax(
        jax.tree_util.tree_map(np.asarray, stacked))
    lat = np.random.default_rng(2).standard_normal((2, 16, 16, 4)).astype(
        np.float32)
    kw = dict(num_inference_steps=3, guidance_scale=7.5, height=128,
              width=128, lora_idx=[1, 0])
    ref = jpipe(PROMPTS, latents=jnp.asarray(lat), **kw)
    out = pipe(PROMPTS, latents=torch.from_numpy(lat), **kw)
    assert out.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(out, ref, **TOL)


def test_generator_draws_latents(params):
    _, pipe = _pipes(params)
    kw = dict(num_inference_steps=1, height=64, width=64)
    a = pipe("x", generator=torch.Generator().manual_seed(5), **kw)
    b = pipe("x", generator=torch.Generator().manual_seed(5), **kw)
    c = pipe("x", generator=torch.Generator().manual_seed(6), **kw)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
    assert np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0
    with pytest.raises(ValueError, match="generator"):
        pipe("x", **kw)


def test_unported_paths_raise(params, tmp_path):
    _, pipe = _pipes(params)
    with pytest.raises(ValueError, match="multiples of 64"):
        pipe("x", num_inference_steps=1, height=32, width=32,
             generator=torch.Generator())
    # the samplers and image modes are ported: they run, and reject what
    # lora_tpu rejects
    out = pipe("x", num_inference_steps=2, height=64, width=64,
               scheduler="pndm", generator=torch.Generator())
    assert out.shape == (1, 64, 64, 3) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown scheduler"):
        pipe("x", num_inference_steps=1, height=64, width=64,
             scheduler="lms", generator=torch.Generator())
    img = torch.zeros((1, 64, 64, 3))
    out = pipe.img2img("x", img, num_inference_steps=2,
                       generator=torch.Generator())
    assert out.shape == (1, 64, 64, 3) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="in_channels=9"):
        pipe.inpaint("x", img, torch.ones((1, 64, 64, 1)),
                     generator=torch.Generator())
    # kohya-ss files are ported: a LoCon module on proj_in loads and
    # applies (formats/kohya.py; tests/test_torch_port_kohya.py holds them
    # against lora_tpu)
    from lora_tpu_torch.formats.reader import save_file

    kohya = str(tmp_path / "kohya.safetensors")
    base = "lora_unet_down_blocks_0_attentions_0_proj_in"
    rng = np.random.default_rng(0)
    save_file({base + ".lora_up.weight": rng.standard_normal(
                   (32, 4, 1, 1)).astype(np.float32),
               base + ".lora_down.weight": rng.standard_normal(
                   (4, 32, 1, 1)).astype(np.float32),
               base + ".alpha": np.asarray(2.0, np.float32)}, kohya, {})
    before = pipe("x", num_inference_steps=2, height=64, width=64,
                  generator=torch.Generator().manual_seed(1))
    assert pipe.patch_pipe(kohya) == {}
    assert list(pipe.lora_unet["sites"]) == [
        "down_blocks.0.attentions.0.proj_in"]
    after = pipe("x", num_inference_steps=2, height=64, width=64,
                 generator=torch.Generator().manual_seed(1))
    assert np.abs(after - before).max() > 1e-4
