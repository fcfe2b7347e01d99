"""SD-2.1 768-v in the port against lora_tpu, in float32 on the tiny SD-2
configs (TINY_SD2_UNET: linear projections and per-block heads;
TINY_SD2_TEXT: gelu, 48 wide; TINY_VAE) with the published 768-v schedule
(scaled_linear, steps_offset 1, set_alpha_to_one false, v_prediction).

A v-prediction model's output is v, not eps. The port's loop turns it into
eps after CFG for every sampler but DDIM, whose step converts it itself:
at the step's timestep for PNDM and DPM++, at its sigma on the unscaled
latents for the Euler pair (diffusers' EulerDiscreteScheduler). lora_tpu's
_denoise_loop rebuilds its schedule without prediction_type and hands v to
every step as eps, DDIM's included. So the oracle here is lora_tpu's own
unet_forward, pred_to_x0_eps and step functions in a loop written below
with the conversion; every sampler and image mode of the port is held to
it within TOL, lora_tpu's pipeline is shown to differ from it, and
eps-prediction runs no conversion and still equals lora_tpu's loop. Also:
the published SD-2.1 configs read into SD21_UNET / SD21_TEXT / SD21_VAE and
the v schedule, a directory round trip that keeps their keys, a server
request on the v-prediction pipe. train_dreambooth with the v target is
in test_torch_port_sd21_train.py (its JAX train step's compile would take
this file past a minute)."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.models import hf_import as j_hf  # noqa: E402
from lora_tpu.models import schedulers as j_sch  # noqa: E402
from lora_tpu.models.unet import unet_forward as j_unet_forward  # noqa: E402
from lora_tpu.pipelines import sd as j_sd  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu_torch.data.png import _png_decode  # noqa: E402
from lora_tpu_torch.models import hf_import as t_hf  # noqa: E402
from lora_tpu_torch.models import schedulers as t_sch  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    SD21_TEXT,
    SD21_UNET,
    SD21_VAE,
    TINY_SD2_TEXT,
    TINY_SD2_UNET,
    TINY_VAE,
)
from lora_tpu_torch.pipelines import sd as t_sd  # noqa: E402
from lora_tpu_torch.serve import PipelineServer  # noqa: E402

from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

TOL = dict(rtol=2e-4, atol=2e-4)  # test_torch_port_samplers.py's limits
# lora_tpu's loop against the oracle: v taken as eps moves the latents by
# far more than TOL (at least this much, at the worst entry)
FAULT_MIN = 1e-2
V_SCHEDULE = dict(beta_start=0.00085, beta_end=0.012,
                  beta_schedule="scaled_linear", set_alpha_to_one=False,
                  steps_offset=1, prediction_type="v_prediction")
PROMPTS = ["a photo of a dog", "a town at dusk"]
LAT = (2, 8, 8, 4)  # the tiny VAE's latents of a 64x64 image
SCHEDULERS = ["ddim", "pndm", "euler", "euler_a", "dpm++", "euler_karras",
              "euler_a_karras"]


def _port_pipe(prediction_type="v_prediction"):
    pipe = t_sd.StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_SD2_UNET,
        text_cfg=TINY_SD2_TEXT, vae_cfg=TINY_VAE)
    pipe.schedule = t_sch.make_schedule(
        **dict(V_SCHEDULE, prediction_type=prediction_type))
    return pipe


def _jax_pipe(pipe):
    """lora_tpu's pipeline holding the port pipe's params and schedule."""
    p = [{k: jnp.asarray(v.numpy()) for k, v in m.state_dict().items()}
         for m in (pipe.unet, pipe.text_encoder, pipe.vae)]
    return JPipe(unet_params=p[0], text_params=p[1], vae_params=p[2],
                 tokenizer=JTokenizer(vocab_size=TINY_SD2_TEXT.vocab_size),
                 unet_cfg=j_cfg.TINY_SD2_UNET, text_cfg=j_cfg.TINY_SD2_TEXT,
                 vae_cfg=j_cfg.TINY_VAE,
                 schedule=j_sch.make_schedule(
                     **dict(V_SCHEDULE,
                            prediction_type=pipe.schedule.prediction_type)))


@pytest.fixture(scope="module")
def pipes():
    pipe = _port_pipe()
    return _jax_pipe(pipe), pipe


# -- the oracle ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _unet_fn(cfg):
    return jax.jit(lambda p, x, t, ctx: j_unet_forward(p, x, t, ctx, cfg))


def _oracle_loop(prediction_type):
    """A loop with _denoise_loop's signature on lora_tpu's unet_forward,
    pred_to_x0_eps and step functions, on a schedule of the given
    prediction type, with the model output turned into eps after CFG as
    the port's loop turns it (DDIM's step converts it itself)."""
    def loop(unet_params, lora_unet, latents, text_emb, uncond_emb,
             guidance_scale, ts, sched_alphas, final_alpha, unet_cfg,
             num_inference_steps, use_cfg, method="ddim",
             extra_channels=None, sigmas=None, noise_rng=None, lora_idx=None,
             add_text_embeds=None, add_time_ids=None, blend_mask=None,
             blend_z0=None, blend_noise=None):
        assert lora_unet is None and add_text_embeds is None
        assert extra_channels is None
        sched = j_sch.NoiseSchedule(
            num_train_timesteps=1000, alphas_cumprod=sched_alphas,
            final_alpha_cumprod=final_alpha, prediction_type=prediction_type)
        fwd = _unet_fn(unet_cfg)
        ctx = jnp.concatenate([uncond_emb, text_emb]) if use_cfg else text_emb
        B = latents.shape[0]
        f32 = jnp.float32
        step_delta = 1000 // num_inference_steps
        ts = [int(t) for t in np.asarray(ts)]

        def model(inp, t):
            x = jnp.concatenate([inp, inp]) if use_cfg else inp
            out = fwd(unet_params, x, jnp.full((x.shape[0],), t, jnp.int32),
                      ctx)
            if use_cfg:
                u, c = out[:B], out[B:]
                out = u + guidance_scale.astype(out.dtype) * (c - u)
            return out

        def eps_t(out, lat, t):  # timestep space
            if prediction_type == "epsilon":
                return out
            return j_sch.pred_to_x0_eps(sched, out.astype(f32),
                                        lat.astype(f32), jnp.int32(t))[1]

        def eps_sigma(out, lat, sigma):  # sigma space, unscaled latents
            if prediction_type == "epsilon":
                return out
            x = lat.astype(f32)
            x0 = x / (sigma**2 + 1) - out.astype(f32) * sigma / jnp.sqrt(
                sigma**2 + 1)
            return (x - x0) / sigma

        def blend_t(lat, t_next):
            if blend_mask is None:
                return lat
            tn = jnp.full((B,), t_next, jnp.int32)
            known = j_sch.add_noise(sched, blend_z0, blend_noise,
                                    jnp.maximum(tn, 0))
            known = jnp.where((tn < 0)[:, None, None, None], blend_z0, known)
            return (blend_mask * lat
                    + (1.0 - blend_mask) * known).astype(lat.dtype)

        def blend_sigma(lat, sigma_next):
            if blend_mask is None:
                return lat
            known = blend_z0 + sigma_next.astype(f32) * blend_noise
            return (blend_mask * lat
                    + (1.0 - blend_mask) * known).astype(lat.dtype)

        lat = latents
        if method == "pndm":
            state = j_sch.pndm_init_state(lat.shape)
        if method == "dpm++":
            state = j_sch.dpmpp_init_state(lat.shape)
        for i, t in enumerate(ts):
            if method == "ddim":
                lat = j_sch.ddim_step(sched, model(lat, t),
                                      jnp.full((B,), t, jnp.int32), lat,
                                      jnp.full((B,), t - step_delta,
                                               jnp.int32))
                lat = blend_t(lat, t - step_delta)
            elif method == "pndm":
                lat, state = j_sch.pndm_step(
                    sched, state, eps_t(model(lat, t), lat, t),
                    jnp.int32(t), lat, step_delta)
            elif method == "dpm++":
                t_next = ts[i + 1] if i + 1 < len(ts) else -1
                lat, state = j_sch.dpmpp_step(
                    sched, state, eps_t(model(lat, t), lat, t), jnp.int32(t),
                    lat, jnp.int32(t_next))
                lat = blend_t(lat, t_next)
            else:  # euler | euler_a
                sigma, sigma_next = sigmas[i], sigmas[i + 1]
                out = model(j_sch.euler_scale_model_input(lat, sigma), t)
                eps = eps_sigma(out, lat, sigma)
                if method == "euler":
                    lat = j_sch.euler_step(lat, eps, sigma, sigma_next)
                else:
                    noise = jax.random.normal(jax.random.fold_in(noise_rng, i),
                                              lat.shape, jnp.float32)
                    lat = j_sch.euler_ancestral_step(lat, eps, sigma,
                                                     sigma_next, noise)
                lat = blend_sigma(lat, sigma_next)
        return lat

    return loop


def _loop_inputs(pipe, scheduler, steps):
    rng = np.random.default_rng(10)
    lat = rng.standard_normal(LAT).astype(np.float32)
    emb, unc = (rng.standard_normal((2, 7, TINY_SD2_UNET.cross_attention_dim)
                                    ).astype(np.float32) for _ in range(2))
    ts, sigmas = pipe._scheduler_arrays(scheduler, steps)
    if sigmas is not None:
        lat = lat * sigmas[0]
    return lat, emb, unc, ts, sigmas


def _run_loops(pipe, jpipe, scheduler, steps=3):
    """(the port's _denoise, the oracle loop, lora_tpu's _denoise_loop) on
    the same latents, conditioning (CFG 7.5), tables and draws."""
    lat, emb, unc, ts, sigmas = _loop_inputs(pipe, scheduler, steps)
    method = t_sd.SCHEDULERS[scheduler]
    noise_rng = jax.random.fold_in(jax.random.PRNGKey(3), 777)
    kw = {}
    if method == "euler_a":
        kw["step_noise"] = [
            torch.from_numpy(np.array(jax.random.normal(
                jax.random.fold_in(noise_rng, i), LAT, jnp.float32)))
            for i in range(len(ts))]
    with torch.inference_mode():
        got = pipe._denoise(torch.from_numpy(lat), torch.from_numpy(emb),
                            torch.from_numpy(unc), 7.5, steps, ts, method,
                            sigmas, **kw)
    args = (jpipe.unet_params, None, jnp.asarray(lat), jnp.asarray(emb),
            jnp.asarray(unc), jnp.float32(7.5), jnp.asarray(ts, jnp.int32),
            jpipe.schedule.alphas_cumprod,
            jnp.float32(jpipe.schedule.final_alpha_cumprod),
            j_cfg.TINY_SD2_UNET, steps, True)
    jkw = dict(method=method, noise_rng=noise_rng,
               sigmas=None if sigmas is None else jnp.asarray(sigmas))
    oracle = _oracle_loop(pipe.schedule.prediction_type)(*args, **jkw)
    return got.numpy(), np.asarray(oracle), args, jkw


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_v_prediction_samplers_match_the_oracle(pipes, scheduler):
    """Every sampler on the v-prediction UNet against the oracle loop."""
    jpipe, pipe = pipes
    got, want, _, _ = _run_loops(pipe, jpipe, scheduler)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scheduler", ["pndm", "euler", "dpm++",
                                       "euler_a_karras"])
def test_eps_prediction_runs_no_conversion(scheduler, monkeypatch):
    """On an eps-prediction schedule the loop converts nothing (the output
    reaches the steps as it was), and equals the oracle, which is then
    lora_tpu's loop, within TOL."""
    pipe = _port_pipe("epsilon")
    jpipe = _jax_pipe(pipe)

    def refuse(*a, **k):
        raise AssertionError("an eps-prediction output was converted")

    monkeypatch.setattr(t_sd.schedulers, "sigma_pred_to_eps", refuse)
    real = t_sd.schedulers.pred_to_x0_eps
    calls = []
    monkeypatch.setattr(t_sd.schedulers, "pred_to_x0_eps",
                        lambda *a: calls.append(1) or real(*a))
    got, want, _, _ = _run_loops(pipe, jpipe, scheduler)
    assert calls == []
    np.testing.assert_allclose(got, want, **TOL)


def test_sigma_pred_to_eps():
    """The sigma-space conversion: eps passes through as the same tensor;
    v and x0 give the eps whose Euler step lands on diffusers' x0."""
    rng = np.random.default_rng(4)
    x, out = (torch.from_numpy(rng.standard_normal(LAT).astype(np.float32))
              for _ in range(2))
    sigma = torch.tensor(3.5)
    eps_sched = t_sch.make_schedule()
    assert t_sch.sigma_pred_to_eps(eps_sched, out, x, sigma) is out
    for kind, x0 in (("v_prediction",
                      x / (sigma**2 + 1) - out * sigma / (sigma**2 + 1)
                      ** 0.5), ("sample", out)):
        sched = t_sch.make_schedule(prediction_type=kind)
        eps = t_sch.sigma_pred_to_eps(sched, out, x, sigma)
        np.testing.assert_allclose((x - sigma * eps).numpy(), x0.numpy(),
                                   rtol=1e-5, atol=1e-5)


# -- the pipeline's modes, lora_tpu's pipeline on the oracle loop ------------

def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape,
                                                       jnp.float32)))


def _image_and_mask(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 64, 1), np.float32)
    mask[:, 8:40, 16:56] = 1.0
    return img, mask


@pytest.fixture()
def oracle_pipeline(monkeypatch):
    """lora_tpu's pipeline methods run the oracle loop."""
    monkeypatch.setattr(j_sd, "_denoise_loop", _oracle_loop("v_prediction"))


@pytest.mark.parametrize("scheduler", ["ddim", "dpm++", "euler_a_karras"])
def test_txt2img_matches_the_oracle(pipes, scheduler, oracle_pipeline):
    """txt2img through __call__, lora_tpu's latents (and euler_a's draws)
    handed in."""
    jpipe, pipe = pipes
    key = jax.random.PRNGKey(5)
    lat = np.asarray(jpipe.prepare_latents(2, 64, 64, key))
    noise_rng = jax.random.fold_in(key, 777)
    step_noise = [_normal(jax.random.fold_in(noise_rng, i), LAT)
                  for i in range(3)]
    want = jpipe(PROMPTS, num_inference_steps=3, height=64, width=64,
                 rng=key, scheduler=scheduler)
    got = pipe(PROMPTS, num_inference_steps=3, height=64, width=64,
               latents=torch.from_numpy(lat), scheduler=scheduler,
               step_noise=step_noise)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_lora_tpu_pipeline_takes_v_as_eps(pipes, monkeypatch):
    """lora_tpu's own pipeline is not the oracle: its loop rebuilds the
    schedule without prediction_type, so even DDIM steps on v as if it
    were eps."""
    jpipe, _ = pipes
    kw = dict(num_inference_steps=3, height=64, width=64,
              rng=jax.random.PRNGKey(5), scheduler="ddim")
    lora_tpu = jpipe(PROMPTS, **kw)
    monkeypatch.setattr(j_sd, "_denoise_loop", _oracle_loop("v_prediction"))
    oracle = jpipe(PROMPTS, **kw)
    assert np.abs(lora_tpu - oracle).max() > FAULT_MIN


def test_img2img_matches_the_oracle(pipes, oracle_pipeline):
    """DDIM img2img at strength 0.6 of 5 steps, lora_tpu's draws handed
    in."""
    jpipe, pipe = pipes
    img, _ = _image_and_mask(0)
    key = jax.random.PRNGKey(11)
    k_enc, k_noise = jax.random.split(key)
    kw = dict(strength=0.6, num_inference_steps=5, guidance_scale=7.5)
    want = jpipe.img2img(PROMPTS, jnp.asarray(img), rng=key, **kw)
    got = pipe.img2img(PROMPTS, torch.from_numpy(img),
                       posterior_noise=_normal(k_enc, LAT),
                       init_noise=_normal(k_noise, LAT), **kw)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scheduler", ["ddim", "euler", "dpm++"])
def test_inpaint_blend_matches_the_oracle(pipes, scheduler, oracle_pipeline):
    """Latent-blend inpainting at strength 0.75 of 4 steps: the converted
    steps, then the kept region blended back; it ends at z0 exactly."""
    jpipe, pipe = pipes
    img, mask = _image_and_mask(3)
    key = jax.random.PRNGKey(14)
    k_enc, k_noise = jax.random.split(key)
    kw = dict(strength=0.75, num_inference_steps=4, guidance_scale=7.5,
              scheduler=scheduler)
    want = jpipe.inpaint_blend(PROMPTS, jnp.asarray(img), jnp.asarray(mask),
                               rng=key, **kw)
    got, lat, z0 = pipe.inpaint_blend(
        PROMPTS, torch.from_numpy(img), torch.from_numpy(mask),
        posterior_noise=_normal(k_enc, LAT), init_noise=_normal(k_noise, LAT),
        return_latents=True, **kw)
    np.testing.assert_allclose(got, want, **TOL)
    small = t_sd._latent_mask(torch.from_numpy(mask), 8, 8,
                              torch.float32).numpy()
    keep = np.broadcast_to(small == 0, lat.shape)
    np.testing.assert_array_equal(lat.numpy()[keep], z0.numpy()[keep])


# -- the published configs and the directory round trip ---------------------

# stabilityai/stable-diffusion-2-1 unet/, text_encoder/, vae/ and scheduler/
# config.json, as published
SD21_PUBLISHED = {
    "unet": {
        "_class_name": "UNet2DConditionModel", "act_fn": "silu",
        "attention_head_dim": [5, 10, 20, 20],
        "block_out_channels": [320, 640, 1280, 1280],
        "center_input_sample": False, "cross_attention_dim": 1024,
        "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                             "CrossAttnDownBlock2D", "DownBlock2D"],
        "downsample_padding": 1, "dual_cross_attention": False,
        "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4,
        "layers_per_block": 2, "mid_block_scale_factor": 1,
        "norm_eps": 1e-05, "norm_num_groups": 32, "num_class_embeds": None,
        "only_cross_attention": False, "out_channels": 4, "sample_size": 96,
        "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D",
                           "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"],
        "upcast_attention": True, "use_linear_projection": True},
    "text_encoder": {
        "architectures": ["CLIPTextModel"], "attention_dropout": 0.0,
        "bos_token_id": 0, "dropout": 0.0, "eos_token_id": 2,
        "hidden_act": "gelu", "hidden_size": 1024,
        "initializer_factor": 1.0, "initializer_range": 0.02,
        "intermediate_size": 4096, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 77, "model_type": "clip_text_model",
        "num_attention_heads": 16, "num_hidden_layers": 23,
        "pad_token_id": 1, "projection_dim": 512, "torch_dtype": "float32",
        "vocab_size": 49408},
    "vae": {
        "_class_name": "AutoencoderKL", "act_fn": "silu",
        "block_out_channels": [128, 256, 512, 512],
        "down_block_types": ["DownEncoderBlock2D"] * 4, "in_channels": 3,
        "latent_channels": 4, "layers_per_block": 2, "norm_num_groups": 32,
        "out_channels": 3, "sample_size": 768,
        "up_block_types": ["UpDecoderBlock2D"] * 4},
    "scheduler": {
        "_class_name": "DDIMScheduler", "beta_end": 0.012,
        "beta_schedule": "scaled_linear", "beta_start": 0.00085,
        "clip_sample": False, "num_train_timesteps": 1000,
        "prediction_type": "v_prediction", "set_alpha_to_one": False,
        "skip_prk_steps": True, "steps_offset": 1, "trained_betas": None},
}


def test_published_sd21_configs_read_as_sd21(tmp_path, monkeypatch):
    """The published configs give SD21_UNET, SD21_TEXT, SD21_VAE, the
    768-v schedule and upcast_attention in both packages (the weights'
    reader stubbed: only the configs are read)."""
    for sub, cfg in SD21_PUBLISHED.items():
        os.makedirs(tmp_path / sub)
        name = ("scheduler_config.json" if sub == "scheduler"
                else "config.json")
        with open(tmp_path / sub / name, "w") as f:
            json.dump(cfg, f)
    for hf in (t_hf, j_hf):
        monkeypatch.setattr(hf, "_load_state_dict", lambda d: {})
    loaders = (("unet", t_hf.load_unet, j_hf.load_unet, SD21_UNET),
               ("text_encoder", t_hf.load_text_encoder,
                j_hf.load_text_encoder, SD21_TEXT),
               ("vae", t_hf.load_vae, j_hf.load_vae, SD21_VAE))
    for sub, t_load, j_load, want in loaders:
        _, got = t_load(str(tmp_path / sub))
        assert got == want, sub
        assert dataclasses.asdict(j_load(str(tmp_path / sub))[1]) == \
            dataclasses.asdict(want), sub
    assert t_hf.load_upcast_attention(str(tmp_path / "unet")) is True
    sched = t_hf.load_scheduler_config(str(tmp_path))
    assert sched.prediction_type == "v_prediction"
    assert sched.steps_offset == 1 and sched.final_alpha_cumprod != 1.0
    np.testing.assert_array_equal(sched.alphas_cumprod.numpy(),
                                  t_sch.make_schedule().alphas_cumprod
                                  .numpy())


def test_directory_round_trip_keeps_the_sd21_keys(pipes, tmp_path):
    """A v-prediction SD-2 pipe with upcast_attention, written by
    save_pipeline_params: the published keys in its configs, read back by
    from_pretrained (the same configs, flag, schedule and params, so the
    same UNet call) and by lora_tpu's loader."""
    _, pipe = pipes
    pipe.unet.upcast_attention = True
    try:
        d = str(tmp_path / "sd21")
        t_hf.save_pipeline_params(pipe, d, fp16=False)
    finally:
        pipe.unet.upcast_attention = False
    with open(os.path.join(d, "unet", "config.json")) as f:
        unet = json.load(f)
    assert unet["attention_head_dim"] == list(
        TINY_SD2_UNET.num_attention_heads)
    assert unet["use_linear_projection"] is True
    assert unet["upcast_attention"] is True
    assert unet["cross_attention_dim"] == TINY_SD2_UNET.cross_attention_dim
    with open(os.path.join(d, "text_encoder", "config.json")) as f:
        assert json.load(f)["hidden_act"] == "gelu"
    with open(os.path.join(d, "scheduler", "scheduler_config.json")) as f:
        assert json.load(f)["prediction_type"] == "v_prediction"
    back = t_sd.StableDiffusionPipeline.from_pretrained(
        d, device="cpu", require_real_tokenizer=False)
    assert back.unet.cfg == TINY_SD2_UNET
    # the TI rows' headroom is not a config key: the loader's default
    assert back.text_encoder.cfg == dataclasses.replace(
        TINY_SD2_TEXT,
        max_extra_tokens=back.text_encoder.cfg.max_extra_tokens)
    assert back.unet.upcast_attention is True
    assert back.schedule.prediction_type == "v_prediction"
    for a, b in ((back.unet, pipe.unet), (back.text_encoder,
                                          pipe.text_encoder)):
        for k, v in b.state_dict().items():
            torch.testing.assert_close(a.state_dict()[k], v, rtol=0, atol=0)
    *_, cfgs = j_hf.load_pipeline_params(d)
    assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(TINY_SD2_UNET)
    assert j_hf.load_scheduler_config(d).prediction_type == "v_prediction"
    plain = t_sd.StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_SD2_UNET,
        text_cfg=TINY_SD2_TEXT, vae_cfg=TINY_VAE)
    d2 = str(tmp_path / "plain")
    t_hf.save_pipeline_params(plain, d2)
    with open(os.path.join(d2, "unet", "config.json")) as f:
        assert "upcast_attention" not in json.load(f)  # diffusers: false
    assert t_sd.StableDiffusionPipeline.from_pretrained(
        d2, device="cpu", require_real_tokenizer=False
    ).unet.upcast_attention is False


# -- a server request -------------------------------------------------------

def test_server_request_on_the_v_pipe(pipes):
    """A txt2img request over HTTP (euler, 3 steps, 64x64): the PNG is the
    pipeline's image called directly, and the embed cache holds the text
    encoder's width."""
    import base64
    import urllib.request

    _, pipe = pipes
    srv = PipelineServer(pipe, port=0).start()
    try:
        payload = {"prompt": "a tiny tree", "steps": 3, "height": 64,
                   "width": 64, "seed": 1, "scheduler": "euler"}
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        png = _png_decode(base64.b64decode(out["images"][0]))
        widths = {tuple(e.shape) for e in srv._embeds.values()}
    finally:
        srv.stop()
    direct = pipe("a tiny tree", num_inference_steps=3, height=64, width=64,
                  scheduler="euler",
                  latents=pipe.prepare_latents(
                      1, 64, 64, torch.Generator().manual_seed(1)))
    assert png.shape == (64, 64, 3)
    want = np.clip(direct[0] * 255, 0, 255)
    assert np.abs(png.astype(np.float64) - want).max() <= 1.0
    assert widths == {(TINY_SD2_TEXT.max_position_embeddings,
                       TINY_SD2_TEXT.hidden_size)}
