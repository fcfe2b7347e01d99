"""The port's StableDiffusionXLPipeline against lora_tpu's, in float32 on the
tiny XL configs: both pipes hold the same weights (lora_tpu's random init
carried across by convert.pipeline_from_jax); dual encoding; txt2img under
every scheduler with the micro-conditioning, img2img and latent-blend
inpainting with lora_tpu's draws (its k_enc / k_noise splits and euler_a's
fold_in draws) handed in; prompt_embeds passthrough; kohya-XL and
LyCORIS-XL files through patch_pipe, tune_lora_scale, remove_lora and
collapse_lora; the diffusers-layout round trip with text_encoder_2/ both
ways; quantize_base."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core.lora import init_lora  # noqa: E402
from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_locon_sites,
    unet_locon_sites,
)
from lora_tpu.formats.kohya import save_kohya_xl  # noqa: E402
from lora_tpu.models import hf_import as j_hf  # noqa: E402
from lora_tpu.models.config import (  # noqa: E402
    TINY_UNET,
    TINY_VAE,
    TINY_XL_TEXT,
    TINY_XL_TEXT2,
    TINY_XL_UNET,
)
from lora_tpu.pipelines.sdxl import StableDiffusionXLPipeline as JXL  # noqa: E402
from lora_tpu_torch.convert import pipeline_from_jax  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.models import hf_import as t_hf  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.pipelines.sd import SCHEDULERS  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline  # noqa: E402
from test_torch_port_lycoris import CASES, _rn, _save  # noqa: E402
from test_torch_port_sdxl import _module_tensors, _xl_sites  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

PROMPTS = ["a photo of a dog", "a town at dusk"]
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_port_pipeline.py's TOL
SIZE = 32  # the tiny XL UNet's stride: 8 * 2^2
LAT = (2, SIZE // 8, SIZE // 8, 4)
VOCAB = min(TINY_XL_TEXT.vocab_size, TINY_XL_TEXT2.vocab_size)


def _jax_pipe():
    return JXL.random_init(jax.random.PRNGKey(0), unet_cfg=TINY_XL_UNET,
                           text_cfg=TINY_XL_TEXT, text2_cfg=TINY_XL_TEXT2,
                           vae_cfg=TINY_VAE)


def _port(jpipe):
    return pipeline_from_jax(jpipe, CLIPTokenizer(vocab_size=VOCAB))


@pytest.fixture(scope="module")
def pipes():
    jpipe = _jax_pipe()
    return jpipe, _port(jpipe)


def _fresh(pipes):
    """A new pair of pipes over the module's weights, to patch: lora_tpu's
    random init runs op by op, so it runs once for the module."""
    jpipe = dataclasses.replace(pipes[0])
    return jpipe, _port(jpipe)


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape,
                                                       jnp.float32)))


def _step_noise(key, n_steps):
    """euler_a's draws in lora_tpu: step i from fold_in(fold_in(key, 777),
    i)."""
    noise_rng = jax.random.fold_in(key, 777)
    return [_normal(jax.random.fold_in(noise_rng, i), LAT)
            for i in range(n_steps)]


def _latents(seed=1):
    return np.random.default_rng(seed).standard_normal(LAT).astype(
        np.float32)


def _txt2img_both(jpipe, pipe, scheduler="ddim", steps=3, **kw):
    lat, key = _latents(), jax.random.PRNGKey(5)
    ref = jpipe(PROMPTS, num_inference_steps=steps, height=SIZE, width=SIZE,
                latents=jnp.asarray(lat), rng=key, scheduler=scheduler, **kw)
    out = pipe(PROMPTS, num_inference_steps=steps, height=SIZE, width=SIZE,
               latents=torch.from_numpy(lat), scheduler=scheduler,
               step_noise=(_step_noise(key, steps)
                           if SCHEDULERS[scheduler] == "euler_a" else None),
               **kw)
    return np.asarray(ref), out


def test_encode_prompt_xl_matches_jax(pipes):
    jpipe, pipe = pipes
    (jc, jp), (tc, tp) = jpipe.encode_prompt_xl(PROMPTS), \
        pipe.encode_prompt_xl(PROMPTS)
    assert tuple(tc.shape) == (2, 77, TINY_XL_TEXT.hidden_size
                               + TINY_XL_TEXT2.hidden_size)
    assert tuple(tp.shape) == (2, TINY_XL_TEXT2.projection_dim)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
def test_txt2img_matches_jax(scheduler, pipes):
    """Two prompts, CFG 5.0 (the SDXL default), 3 steps."""
    ref, out = _txt2img_both(*pipes, scheduler=scheduler)
    assert out.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(out, ref, **TOL)


def test_micro_conditioning_matches_jax(pipes):
    """original_size, the crop corner and target_size reach the UNet as in
    lora_tpu, and move the image."""
    micro = dict(original_size=(2048, 2048), crops_coords_top_left=(7, 3),
                 target_size=(768, 1024))
    ref, out = _txt2img_both(*pipes, steps=2, **micro)
    np.testing.assert_allclose(out, ref, **TOL)
    _, plain = _txt2img_both(*pipes, steps=2)
    assert np.abs(plain - out).max() > 1e-4


def _image_and_mask(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((2, SIZE, SIZE, 1), np.float32)
    mask[:, 8:24, 4:28] = 1.0
    return img, mask


def test_img2img_matches_jax(pipes):
    """Strength 0.6 of 5 DDIM steps; the time_ids take the image's size."""
    jpipe, pipe = pipes
    img, _ = _image_and_mask()
    key = jax.random.PRNGKey(3)
    k_enc, k_noise = jax.random.split(key)
    ref = jpipe.img2img(PROMPTS, jnp.asarray(img), strength=0.6,
                        num_inference_steps=5, rng=key)
    out = pipe.img2img(PROMPTS, torch.from_numpy(img), strength=0.6,
                       num_inference_steps=5,
                       posterior_noise=_normal(k_enc, LAT),
                       init_noise=_normal(k_noise, LAT))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("scheduler", ["ddim", "euler_a", "dpm++"])
def test_blend_inpaint_matches_jax(scheduler, pipes):
    """SDXL's inpaint is latent blending under any scheduler but pndm;
    the kept region's final latents are z0 exactly."""
    jpipe, pipe = pipes
    img, mask = _image_and_mask(1)
    key = jax.random.PRNGKey(4)
    k_enc, k_noise = jax.random.split(key)
    steps = 5
    n_run = int(steps * 0.8)  # the steps strength 0.8 runs
    ref = jpipe.inpaint(PROMPTS, jnp.asarray(img), jnp.asarray(mask),
                        strength=0.8, num_inference_steps=steps, rng=key,
                        scheduler=scheduler)
    out, lat, z0 = pipe.inpaint(
        PROMPTS, torch.from_numpy(img), torch.from_numpy(mask), strength=0.8,
        num_inference_steps=steps, scheduler=scheduler,
        posterior_noise=_normal(k_enc, LAT), init_noise=_normal(k_noise, LAT),
        step_noise=_step_noise(key, n_run), return_latents=True)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    kept = (torch.from_numpy(mask[:, ::8, ::8]) == 0).expand_as(lat)
    assert torch.equal(lat[kept], z0[kept])
    assert pipe.inpaint_blend == pipe.inpaint
    with pytest.raises(ValueError, match="pndm"):
        pipe.inpaint(PROMPTS, torch.from_numpy(img), torch.from_numpy(mask),
                     num_inference_steps=steps, scheduler="pndm",
                     posterior_noise=_normal(k_enc, LAT),
                     init_noise=_normal(k_noise, LAT))


def test_prompt_embeds_passthrough(pipes):
    """(context, pooled) pairs in place of the prompt strings give the
    strings' image; with CFG the negative pair is required."""
    _, pipe = pipes
    lat = torch.from_numpy(_latents(2))
    kw = dict(num_inference_steps=2, height=SIZE, width=SIZE, latents=lat)
    want = pipe(PROMPTS, negative_prompt="blurry", **kw)
    got = pipe(None, prompt_embeds=pipe.encode_prompt_xl(PROMPTS),
               negative_prompt_embeds=pipe.encode_prompt_xl(["blurry"] * 2),
               **kw)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="negative_prompt_embeds"):
        pipe(None, prompt_embeds=pipe.encode_prompt_xl(PROMPTS), **kw)
    no_cfg = pipe(None, prompt_embeds=pipe.encode_prompt_xl(PROMPTS),
                  guidance_scale=1.0, **kw)
    np.testing.assert_array_equal(
        no_cfg, pipe(PROMPTS, guidance_scale=1.0, **kw))


def _kohya_xl_file(tmp_path, seed=0):
    """lora_tpu's save_kohya_xl of rank-2 LoCon trees over the UNet, te1
    and te2 with nonzero up factors (test_sdxl_pipeline.py's file)."""
    sites = (unet_locon_sites(TINY_XL_UNET),
             text_encoder_locon_sites(TINY_XL_TEXT),
             text_encoder_locon_sites(TINY_XL_TEXT2))
    loras = []
    for s, k in zip(sites, (seed, seed + 1, seed + 2)):
        tree = init_lora(s, r=2, rng=jax.random.PRNGKey(k))
        ks = jax.random.split(jax.random.PRNGKey(k + 10), len(tree["sites"]))
        for (_, e), kk in zip(sorted(tree["sites"].items()), ks):
            e["up"] = jax.random.normal(kk, e["up"].shape) * 0.2
        loras.append(tree)
    p = str(tmp_path / f"xl{seed}.safetensors")
    save_kohya_xl(p, unet_cfg=TINY_XL_UNET, lora_unet=loras[0],
                  unet_sites=sites[0], lora_text=loras[1],
                  text_sites=sites[1], lora_text2=loras[2],
                  text2_sites=sites[2], dtype=np.float32)
    return p


def test_patch_scale_collapse_cycle(pipes, tmp_path):
    """A kohya-XL file over the three models: patched, at alpha 0.5 and
    at 0 (the base image), removed; collapse_lora folds te2 too."""
    jpipe, pipe = _fresh(pipes)
    path = _kohya_xl_file(tmp_path)
    _, base = _txt2img_both(jpipe, pipe, steps=2)
    assert jpipe.patch_pipe(path) == pipe.patch_pipe(path) == {}
    assert all(t is not None for t in (pipe.lora_unet, pipe.lora_text,
                                       pipe.lora_text2))
    ref, patched = _txt2img_both(jpipe, pipe, steps=2)
    np.testing.assert_allclose(patched, ref, **TOL)
    assert np.abs(patched - base).max() > 1e-3
    jpipe.tune_lora_scale(0.5)
    pipe.tune_lora_scale(0.5)
    ref, half = _txt2img_both(jpipe, pipe, steps=2)
    np.testing.assert_allclose(half, ref, **TOL)
    pipe.tune_lora_scale(0.0)
    _, zeroed = _txt2img_both(jpipe, pipe, steps=2)
    np.testing.assert_allclose(zeroed, base, atol=1e-5)

    folded = _port(jpipe)
    folded.patch_pipe(path)
    gen = folded.adapter_generation
    folded.collapse_lora()
    assert folded.lora_text2 is None and folded.lora_unet is None
    assert folded.adapter_generation > gen
    pipe.tune_lora_scale(1.0)
    _, again = _txt2img_both(jpipe, pipe, steps=2)
    _, collapsed = _txt2img_both(jpipe, folded, steps=2)
    np.testing.assert_allclose(collapsed, again, atol=2e-4)
    pipe.remove_lora()
    assert pipe.lora_text2 is None
    _, removed = _txt2img_both(jpipe, pipe, steps=2)
    np.testing.assert_array_equal(removed, base)


def test_patch_pipe_lycoris_xl_matches_jax(pipes, tmp_path):
    """A LyCORIS-XL file (LoHa at an LDM-named UNet site, DoRA on te2, a
    norm module on te2's first layer_norm1) through patch_pipe in both
    packages; te2's base delta follows tune_lora_scale and remove_lora
    restores te2 bit for bit."""
    jpipe, pipe = _fresh(pipes)
    rng = np.random.default_rng(12)
    site, key = _xl_sites()[0]
    tensors = _module_tensors(key, CASES["loha_linear"][1](site, rng))
    t2 = text_encoder_locon_sites(TINY_XL_TEXT2)[2]
    tensors.update(_module_tensors("lora_te2_" + t2.name.replace(".", "_"),
                                   CASES["dora_linear"][1](t2, rng)))
    npath = "text_model.encoder.layers.0.layer_norm1"
    tensors["lora_te2_" + npath.replace(".", "_") + ".w_norm"] = _rn(
        rng, TINY_XL_TEXT2.hidden_size, s=0.2)
    p = _save(tmp_path, tensors)
    orig = pipe.text_encoder_2.flat_params()[npath + ".weight"].clone()
    jpipe.patch_pipe(p)
    pipe.patch_pipe(p)
    assert pipe.has_base_deltas("text_encoder_2")
    assert not pipe.has_base_deltas("text_encoder")
    assert pipe.lora_text is None and pipe.lora_text2 is not None
    ref, out = _txt2img_both(jpipe, pipe, steps=2)
    np.testing.assert_allclose(out, ref, **TOL)
    jpipe.tune_lora_scale(0.5)
    pipe.tune_lora_scale(0.5)
    assert pipe.base_delta_alpha("text_encoder_2") == 0.5
    ref, out = _txt2img_both(jpipe, pipe, steps=2)
    np.testing.assert_allclose(out, ref, **TOL)
    pipe.remove_lora()
    assert torch.equal(pipe.text_encoder_2.flat_params()[npath + ".weight"],
                       orig)


def test_save_load_round_trip(pipes, tmp_path):
    """save_pipeline_params writes text_encoder_2/; the port's
    from_pretrained and lora_tpu's read it back, and the port reads the
    directory lora_tpu writes, all to the same image."""
    jpipe, pipe = pipes
    d_t, d_j = str(tmp_path / "port"), str(tmp_path / "jax")
    t_hf.save_pipeline_params(pipe, d_t)
    j_hf.save_pipeline_params(jpipe, d_j)
    for name in ("config.json", "model.safetensors"):
        assert (open(f"{d_t}/text_encoder_2/{name}", "rb").read()
                == open(f"{d_j}/text_encoder_2/{name}", "rb").read())
    ref, _ = _txt2img_both(jpipe, pipe, steps=2)
    for d in (d_t, d_j):
        back = StableDiffusionXLPipeline.from_pretrained(
            d, device="cpu", tokenizer=CLIPTokenizer(vocab_size=VOCAB))
        # every field but max_extra_tokens (TI growth room; not in
        # config.json)
        assert (dataclasses.replace(back.text_encoder_2.cfg,
                                    max_extra_tokens=0)
                == dataclasses.replace(pipe.text_encoder_2.cfg,
                                       max_extra_tokens=0))
        assert back.unet.cfg == pipe.unet.cfg
        _, out = _txt2img_both(jpipe, back, steps=2)
        np.testing.assert_allclose(out, ref, **TOL)
    jback = JXL.from_pretrained(d_t, require_real_tokenizer=False)
    assert jback.text2_cfg.projection_dim == TINY_XL_TEXT2.projection_dim


def test_quantize_base_leaves_te2_float(pipes):
    """quantize_base: UNet, te1 and VAE int8, te2 in the pipe's dtype; the
    quantized pipe samples finite images and te2's conditioning is
    unchanged."""
    jpipe, _ = pipes
    pipe = _port(jpipe)
    _, pooled = pipe.encode_prompt_xl(PROMPTS)
    pipe.quantize_base()
    assert pipe.unet.flat_params()["add_embedding.linear_1.weight"].dtype \
        == torch.float32  # "embedding" in the name: kept float
    assert pipe.unet.flat_params()[
        "down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    ].dtype == torch.int8
    assert all(v.is_floating_point()
               for v in pipe.text_encoder_2.state_dict().values())
    _, pooled_q = pipe.encode_prompt_xl(PROMPTS)
    assert torch.equal(pooled_q, pooled)
    out = pipe(PROMPTS, num_inference_steps=2, height=SIZE, width=SIZE,
               latents=torch.from_numpy(_latents()))
    assert np.isfinite(out).all()


def test_sd_unet_refused(pipes):
    """A UNet without the text_time conditioning is no SDXL UNet."""
    pipe = pipes[1]
    with pytest.raises(ValueError, match="text_time"):
        StableDiffusionXLPipeline(UNet(TINY_UNET, device="cpu"),
                                  pipe.text_encoder, pipe.text_encoder_2,
                                  pipe.vae, pipe.tokenizer)
