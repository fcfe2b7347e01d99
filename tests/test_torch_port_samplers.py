"""The port's samplers against lora_tpu's, in float32 on the CPU: every
timestep and sigma table bit for bit, each step function on the same
numpy inputs, the denoising loop per scheduler (Karras sigmas included,
with the 9-channel input and latent blending) against
lora_tpu.pipelines.sd._denoise_loop on the tiny UNet, Euler-ancestral with
the JAX package's per-step draws handed in, and __call__ against the PNDM,
Euler and DPM++ images frozen in tests/goldens/tiny_golden.npz."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.models import schedulers as j_sch  # noqa: E402
from lora_tpu.pipelines import sd as j_sd  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.models import schedulers as t_sch  # noqa: E402
from lora_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from lora_tpu_torch.models.config import TINY_TEXT, TINY_UNET, TINY_VAE  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.models.vae import VAE  # noqa: E402
from lora_tpu_torch.pipelines.sd import (  # noqa: E402
    SCHEDULERS,
    StableDiffusionPipeline,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "tiny_golden.npz")
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_goldens.py's pipeline limits
# a step's float32 arithmetic, with XLA's and torch's exp, log and sqrt:
# a few ulps of values that random eps drive up to ~40 (an ulp of 32 is
# 3.8e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_COUNTS = (1, 3, 7, 20, 50)
LAT_SHAPE = (2, 8, 8, 4)

J_SCHED = j_sch.make_schedule()
T_SCHED = t_sch.make_schedule()


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("steps", STEP_COUNTS)
def test_tables_bit_for_bit(steps):
    """Every timestep and sigma table, numpy in both packages."""
    for name in ("ddim_timesteps", "pndm_timesteps", "dpmpp_timesteps",
                 "euler_timesteps", "euler_sigmas"):
        want = getattr(j_sch, name)(J_SCHED, steps)
        got = getattr(t_sch, name)(T_SCHED, steps)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for rho in (7.0, 3.0):
        (sig_w, ts_w), (sig_g, ts_g) = (
            m.karras_sigmas(s, steps, rho)
            for m, s in ((j_sch, J_SCHED), (t_sch, T_SCHED)))
        assert sig_g.dtype == np.float32 and ts_g.dtype == ts_w.dtype
        np.testing.assert_array_equal(sig_g, sig_w)
        np.testing.assert_array_equal(ts_g, ts_w)
    # the warm-up's duplicate needs a second-highest step
    assert len(t_sch.pndm_timesteps(T_SCHED, steps)) == steps + (steps > 1)


def _steps_against_jax(j_step, t_step, j_state, t_state, n, seed):
    """Run n steps of a stateful sampler in both packages on the same
    random eps; compare every output and the final state."""
    rng = _rng(seed)
    x = _normal(rng, LAT_SHAPE)
    jx, tx = jnp.asarray(x), _t(x)
    for i in range(n):
        eps = _normal(rng, LAT_SHAPE)
        jx, j_state = j_step(j_state, jnp.asarray(eps), jx, i)
        tx, t_state = t_step(t_state, _t(eps), tx, i)
        np.testing.assert_allclose(tx.numpy(), _np(jx), **STEP_TOL,
                                   err_msg=f"step {i}")
    for k in j_state:
        np.testing.assert_allclose(t_state[k].numpy(), _np(j_state[k]),
                                   **STEP_TOL, err_msg=k)


@pytest.mark.parametrize("steps", (3, 10))
def test_pndm_steps_match_jax(steps):
    """PLMS over its S + 1 timesteps: the warm-up's duplicated step
    (averaged eps, restarted from the saved sample), then the 2-, 3- and
    4-point combinations."""
    ts = j_sch.pndm_timesteps(J_SCHED, steps)
    ratio = J_SCHED.num_train_timesteps // steps

    def j_step(state, eps, x, i):
        return j_sch.pndm_step(J_SCHED, state, eps, jnp.int32(ts[i]), x,
                               ratio)

    def t_step(state, eps, x, i):
        return t_sch.pndm_step(T_SCHED, state, eps, torch.tensor(ts[i]), x,
                               ratio)

    _steps_against_jax(j_step, t_step, j_sch.pndm_init_state(LAT_SHAPE),
                       t_sch.pndm_init_state(LAT_SHAPE), len(ts), 1)


@pytest.mark.parametrize("steps", (3, 10))
def test_dpmpp_steps_match_jax(steps):
    """DPM-Solver++(2M): first order, then the multistep combination; the
    last step goes to prev_t = -1 (the final alpha)."""
    ts = j_sch.dpmpp_timesteps(J_SCHED, steps)
    nxt = np.concatenate([ts[1:], [-1]])

    def j_step(state, eps, x, i):
        return j_sch.dpmpp_step(J_SCHED, state, eps, jnp.int32(ts[i]), x,
                                jnp.int32(nxt[i]))

    def t_step(state, eps, x, i):
        return t_sch.dpmpp_step(T_SCHED, state, eps, torch.tensor(ts[i]), x,
                                torch.tensor(nxt[i]))

    _steps_against_jax(j_step, t_step, j_sch.dpmpp_init_state(LAT_SHAPE),
                       t_sch.dpmpp_init_state(LAT_SHAPE), len(ts), 2)


@pytest.mark.parametrize("karras", (False, True))
def test_euler_steps_match_jax(karras):
    """The input scaling, the Euler step and the ancestral step (noise
    handed to both) along a whole sigma table, ending at sigma 0."""
    sig = (j_sch.karras_sigmas(J_SCHED, 6)[0] if karras
           else j_sch.euler_sigmas(J_SCHED, 6))
    rng = _rng(3)
    for i in range(len(sig) - 1):
        x, eps, noise = (_normal(rng, LAT_SHAPE) for _ in range(3))
        js, jn = jnp.float32(sig[i]), jnp.float32(sig[i + 1])
        ts_, tn = torch.tensor(sig[i]), torch.tensor(sig[i + 1])
        np.testing.assert_allclose(
            t_sch.euler_scale_model_input(_t(x), ts_).numpy(),
            _np(j_sch.euler_scale_model_input(jnp.asarray(x), js)),
            **STEP_TOL)
        np.testing.assert_allclose(
            t_sch.euler_step(_t(x), _t(eps), ts_, tn).numpy(),
            _np(j_sch.euler_step(jnp.asarray(x), jnp.asarray(eps), js, jn)),
            **STEP_TOL)
        np.testing.assert_allclose(
            t_sch.euler_ancestral_step(_t(x), _t(eps), ts_, tn,
                                       _t(noise)).numpy(),
            _np(j_sch.euler_ancestral_step(jnp.asarray(x), jnp.asarray(eps),
                                           js, jn, jnp.asarray(noise))),
            **STEP_TOL)


@pytest.mark.parametrize("t", (0, 1, 500, 999))
def test_ddpm_step_matches_jax(t):
    """The DDPM posterior step at one timestep (no noise at t = 0)."""
    rng = _rng(4 + t)
    out, x, noise = (_normal(rng, LAT_SHAPE) for _ in range(3))
    want = j_sch.ddpm_step(J_SCHED, jnp.asarray(out), jnp.int32(t),
                           jnp.asarray(x), jnp.asarray(noise))
    got = t_sch.ddpm_step(T_SCHED, _t(out), torch.tensor(t), _t(x),
                          _t(noise))
    np.testing.assert_allclose(got.numpy(), _np(want), **STEP_TOL)


def test_step_functions_keep_the_sample_dtype():
    """f32 arithmetic, cast back to the sample's dtype (bf16 in serving)."""
    rng = _rng(5)
    x = _t(_normal(rng, LAT_SHAPE)).to(torch.bfloat16)
    eps = _t(_normal(rng, LAT_SHAPE)).to(torch.bfloat16)
    s0, s1 = torch.tensor(14.6), torch.tensor(9.0)
    assert t_sch.euler_step(x, eps, s0, s1).dtype == torch.bfloat16
    assert t_sch.euler_ancestral_step(x, eps, s0, s1, eps).dtype == \
        torch.bfloat16
    assert t_sch.euler_scale_model_input(x, s0).dtype == torch.bfloat16
    prev, st = t_sch.pndm_step(T_SCHED, t_sch.pndm_init_state(LAT_SHAPE),
                               eps, torch.tensor(901), x, 100)
    assert prev.dtype == torch.bfloat16 and st["ets"].dtype == torch.float32
    prev, st = t_sch.dpmpp_step(T_SCHED, t_sch.dpmpp_init_state(LAT_SHAPE),
                                eps, torch.tensor(999), x, torch.tensor(666))
    assert prev.dtype == torch.bfloat16 and st["d_prev"].dtype == \
        torch.float32
    b = torch.full((2,), 500)
    assert t_sch.ddpm_step(T_SCHED, eps, b, x, eps).dtype == torch.bfloat16


# -- the denoising loop on the tiny UNet -------------------------------------

def _unet_params(in_channels):
    unet = UNet(dataclasses.replace(TINY_UNET, in_channels=in_channels),
                device="cpu", generator=torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in unet.state_dict().items()}


@pytest.fixture(scope="module")
def unets():
    """{in_channels: (port pipeline, JAX params)} holding the same tiny
    UNet weights (the text encoder and VAE are unused by the loop)."""
    out = {}
    for ch in (4, 9):
        params = _unet_params(ch)
        cfg = dataclasses.replace(TINY_UNET, in_channels=ch)
        unet = UNet(cfg, device="cpu")
        unet.load_state_dict(state_dict_from_jax(params), strict=True)
        pipe = StableDiffusionPipeline(
            unet, CLIPTextModel(TINY_TEXT, device="cpu"),
            VAE(TINY_VAE, device="cpu"),
            CLIPTokenizer(vocab_size=TINY_TEXT.vocab_size))
        out[ch] = (pipe, {k: jnp.asarray(v) for k, v in params.items()})
    return out


def _euler_a_draws(noise_rng, n, shape):
    """lora_tpu's per-step draws of euler_a: normal(fold_in(rng, i))."""
    return [np.asarray(jax.random.normal(jax.random.fold_in(noise_rng, i),
                                         shape, jnp.float32))
            for i in range(n)]


def _loop_pair(unets, scheduler, steps=3, in_channels=4, blend=False,
               t_start=0):
    """The port's _denoise and lora_tpu's _denoise_loop on the same
    latents, conditioning (CFG 7.5), tables and draws. The Karras
    schedulers run the Euler loops on Karras sigmas (the same compiled JAX
    loop as the plain Euler ones)."""
    pipe, jparams = unets[in_channels]
    rng = _rng(10)
    lat = _normal(rng, LAT_SHAPE)
    emb = _normal(rng, (2, 7, TINY_UNET.cross_attention_dim))
    unc = _normal(rng, (2, 7, TINY_UNET.cross_attention_dim))
    method = SCHEDULERS[scheduler]
    ts, sigmas = pipe._scheduler_arrays(scheduler, steps)
    ts = ts[t_start:]
    if sigmas is not None:
        sigmas = sigmas[t_start:]
    kw, jkw = {}, {}
    if in_channels == 9:
        extra = np.concatenate([
            (rng.uniform(size=LAT_SHAPE[:3] + (1,)) > 0.5).astype(np.float32),
            _normal(rng, LAT_SHAPE)], -1)
        kw["extra_channels"] = _t(extra)
        jkw["extra_channels"] = jnp.asarray(extra)
    if blend:
        mask = (rng.uniform(size=LAT_SHAPE[:3] + (1,)) > 0.5).astype(
            np.float32)
        z0, noise0 = _normal(rng, LAT_SHAPE), _normal(rng, LAT_SHAPE)
        kw["blend"] = (_t(mask), _t(z0), _t(noise0))
        jkw.update(blend_mask=jnp.asarray(mask), blend_z0=jnp.asarray(z0),
                   blend_noise=jnp.asarray(noise0))
    noise_rng = jax.random.fold_in(jax.random.PRNGKey(3), 777)
    if method == "euler_a":
        kw["step_noise"] = [_t(d) for d in
                            _euler_a_draws(noise_rng, len(ts), LAT_SHAPE)]
    want = j_sd._denoise_loop(
        jparams, None, jnp.asarray(lat), jnp.asarray(emb), jnp.asarray(unc),
        jnp.float32(7.5), jnp.asarray(ts, jnp.int32),
        J_SCHED.alphas_cumprod, jnp.float32(J_SCHED.final_alpha_cumprod),
        dataclasses.replace(j_cfg.TINY_UNET, in_channels=in_channels),
        steps, True, method=method,
        sigmas=None if sigmas is None else jnp.asarray(sigmas),
        noise_rng=noise_rng, **jkw)
    with torch.inference_mode():
        got = pipe._denoise(_t(lat), _t(emb), _t(unc), 7.5, steps, ts,
                            method, sigmas, **kw)
    return got.numpy(), np.asarray(want), kw.get("blend")


@pytest.mark.parametrize("scheduler", ["ddim", "pndm", "euler", "euler_a",
                                       "dpm++", "euler_karras",
                                       "euler_a_karras"])
def test_denoise_loop_matches_jax(unets, scheduler):
    got, want, _ = _loop_pair(unets, scheduler)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_denoise_loop_nine_channels_matches_jax(unets):
    """The 9-channel UNet: [latents | mask | masked latents] on the last
    axis of every step's input."""
    got, want, _ = _loop_pair(unets, "ddim", in_channels=9)
    np.testing.assert_allclose(got, want, **TOL)


def test_denoise_loop_blend_matches_jax(unets):
    """Latent blending after every step in sigma space (euler_a, its draws
    handed in), from a strength cut (the first of 4 steps skipped), ending
    at sigma 0: the kept region ends at z0 exactly. Blending at timestep
    levels (ddim, dpm++) runs through inpaint_blend in
    test_torch_port_image_modes.py."""
    got, want, (mask, z0, _) = _loop_pair(unets, "euler_a", steps=4,
                                          blend=True, t_start=1)
    np.testing.assert_allclose(got, want, **TOL)
    keep = np.broadcast_to(mask.numpy() == 0, got.shape)
    np.testing.assert_array_equal(got[keep], z0.numpy()[keep])


def test_loop_rejects_what_lora_tpu_rejects(unets):
    pipe, _ = unets[4]
    lat = torch.zeros(LAT_SHAPE)
    emb = torch.zeros((2, 7, TINY_UNET.cross_attention_dim))
    ts = t_sch.pndm_timesteps(T_SCHED, 2)
    blend = (torch.ones(LAT_SHAPE[:3] + (1,)), lat, lat)
    with pytest.raises(ValueError, match="pndm"):
        pipe._denoise(lat, emb, None, 1.0, 2, ts, "pndm", blend=blend)
    with pytest.raises(ValueError, match="unknown scheduler method"):
        pipe._denoise(lat, emb, None, 1.0, 2, ts, "lms")
    sig = t_sch.euler_sigmas(T_SCHED, 2)
    with pytest.raises(ValueError, match="generator"):
        pipe._denoise(lat, emb, None, 1.0, 2, ts[:2], "euler_a", sig)
    with pytest.raises(ValueError, match="unknown scheduler"):
        pipe("x", num_inference_steps=1, height=64, width=64,
             scheduler="lms", generator=torch.Generator())


# -- __call__ ------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_pipes():
    """The JAX package's PRNGKey(0) tiny pipeline and the port holding the
    same params, with the golden latents (PRNGKey(7))."""
    jpipe = JPipe.random_init(jax.random.PRNGKey(0), unet_cfg=j_cfg.TINY_UNET,
                              text_cfg=j_cfg.TINY_TEXT,
                              vae_cfg=j_cfg.TINY_VAE)
    modules = []
    for cls, cfg, params in ((UNet, TINY_UNET, jpipe.unet_params),
                             (CLIPTextModel, TINY_TEXT, jpipe.text_params),
                             (VAE, TINY_VAE, jpipe.vae_params)):
        m = cls(cfg, device="cpu")
        m.load_state_dict(state_dict_from_jax(
            {k: np.asarray(v) for k, v in params.items()}), strict=True)
        modules.append(m)
    pipe = StableDiffusionPipeline(
        *modules, CLIPTokenizer(vocab_size=TINY_TEXT.vocab_size))
    lat = np.array(jpipe.prepare_latents(1, 64, 64, jax.random.PRNGKey(7)))
    return jpipe, pipe, lat


@pytest.mark.parametrize("scheduler", ["pndm", "euler", "dpm++"])
def test_golden(golden_pipes, scheduler):
    """The JAX package's frozen images of these samplers, reproduced by the
    port (as test_torch_port_pipeline.py's DDIM golden)."""
    _, pipe, lat = golden_pipes
    out = pipe("golden prompt", num_inference_steps=3, height=64, width=64,
               latents=torch.from_numpy(lat), scheduler=scheduler)
    np.testing.assert_allclose(out, np.load(GOLDEN)[f"pipe_{scheduler}"],
                               **TOL)


def test_karras_calls_run_and_euler_a_draws_from_the_generator(
        golden_pipes):
    """The Karras names through __call__ (their tables and loops are held
    against lora_tpu above) give finite images in [0, 1]; euler_a's draws
    follow the call's generator."""
    _, pipe, lat = golden_pipes
    for scheduler in ("euler_karras", "euler_a_karras"):
        out = pipe("x", num_inference_steps=2, height=64, width=64,
                   latents=torch.from_numpy(lat), scheduler=scheduler,
                   generator=torch.Generator().manual_seed(1))
        assert out.shape == (1, 64, 64, 3) and np.isfinite(out).all()
        assert out.min() >= 0.0 and out.max() <= 1.0
    kw = dict(num_inference_steps=2, height=64, width=64,
              latents=torch.from_numpy(lat), scheduler="euler_a")
    a, b, c = (pipe("x", generator=torch.Generator().manual_seed(s), **kw)
               for s in (1, 1, 2))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
    with pytest.raises(ValueError, match="generator"):
        pipe("x", **kw)
