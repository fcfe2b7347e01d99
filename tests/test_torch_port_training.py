"""The port's training loss against lora_tpu's, in float32 on the tiny
configs: the loss value and the gradient of every trainable leaf
(lora_unet, lora_text, ti) for each loss variant.

jax.random's draws cannot be made with torch, so each case reproduces the
JAX loss_step's draws from its key (jax.random.split(rng, 5), then normal /
randint / the VAE's posterior noise, as lora_tpu/training/loss.py:82-93 and
models/vae.py:156-160 draw them) and hands them to the port explicitly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_lora_sites,
    unet_lora_sites,
)
from lora_tpu.models import schedulers as j_sched  # noqa: E402
from lora_tpu.models.config import TINY_TEXT, TINY_UNET, TINY_VAE  # noqa: E402
from lora_tpu.training import loss as j_loss  # noqa: E402
from lora_tpu_torch.convert import trainable_from_jax  # noqa: E402
from lora_tpu_torch.models import schedulers as t_sched  # noqa: E402
from lora_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.models.vae import VAE  # noqa: E402
from lora_tpu_torch.training import loss as t_loss  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

TI_IDS = np.array([998, 999], np.int32)
# f32 on both sides; the two frameworks' convolutions and matmuls sum in
# other orders, so values agree to ~1e-6 relative and gradients to ~1e-5 of
# their group's largest entry
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


def random_lora(sites, seed, r=2, scale=0.8):
    """A LoRA with nonzero up and down on every site (numpy leaves), so
    every leaf gets a nonzero gradient."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in sites:
        k = () if s.kind == "linear" else tuple(s.kernel)
        tail = () if s.kind == "linear" else (1, 1)
        out[s.name] = {
            "up": (0.1 * rng.standard_normal((s.out_dim, r) + tail)
                   ).astype(np.float32),
            "down": (0.1 * rng.standard_normal((r, s.in_dim) + k)
                     ).astype(np.float32)}
    return {"sites": out, "scale": np.float32(scale)}


def jax_draws(rng, lat_shape, t_hi, dtype=jnp.float32):
    """The draws of the JAX loss_step for key `rng`, as numpy."""
    k_vae, k_noise, k_t, _k_drop, k_mvae = jax.random.split(rng, 5)
    return {
        "noise": np.asarray(jax.random.normal(k_noise, lat_shape, dtype)),
        "timesteps": np.asarray(jax.random.randint(k_t, (lat_shape[0],), 0,
                                                   t_hi)),
        "vae_noise": np.asarray(jax.random.normal(k_vae, lat_shape, dtype)),
        "masked_vae_noise": np.asarray(jax.random.normal(k_mvae, lat_shape,
                                                         dtype)),
    }


def _port_init(cls, cfg, seed):
    """The port's flat params of a tiny model from a seed (lora_tpu's
    distributions) and the same arrays for lora_tpu: lora_tpu's own init
    runs op by op here, ~35 s for the three models."""
    tp = cls(cfg, device="cpu",
             generator=torch.Generator().manual_seed(seed)).flat_params()
    return {k: jnp.asarray(v.numpy()) for k, v in tp.items()}, tp


@pytest.fixture(scope="module")
def bases():
    """(JAX params, the port's flat dicts) for the tiny UNet, CLIP, VAE."""
    pairs = [_port_init(UNet, TINY_UNET, 0), _port_init(CLIPTextModel,
                                                        TINY_TEXT, 1),
             _port_init(VAE, TINY_VAE, 2)]
    return tuple(j for j, _ in pairs), tuple(t for _, t in pairs)


def _batch(case, bsz):
    rng = np.random.default_rng(11)
    b = {}
    if case == "uncached":
        b["pixel_values"] = rng.uniform(-1, 1, (bsz, 64, 64, 3)).astype(
            np.float32)
    else:
        b["latents"] = rng.standard_normal((bsz, 8, 8, 4)).astype(np.float32)
    if case == "precomputed_embeddings":
        b["encoder_hidden_states"] = rng.standard_normal(
            (bsz, 7, TINY_UNET.cross_attention_dim)).astype(np.float32)
    else:
        ids = rng.integers(0, 900, (bsz, 7)).astype(np.int32)
        ids[:, 1], ids[:, 3] = TI_IDS  # the TI tokens, so TI gets gradient
        b["input_ids"] = ids
    if case == "mask":
        b["mask"] = (rng.uniform(size=(bsz, 64, 64, 1)) > 0.5).astype(
            np.float32)
    if case == "prior_is_instance":
        b["is_instance"] = np.array([1, 0, 0, 1], np.float32)
    return b


CASES = {
    "cached": ({}, {}),
    "uncached": ({"cached_latents": False}, {}),
    "v_prediction": ({}, {"prediction_type": "v_prediction"}),
    "mask": ({"mask_temperature": 2.0}, {}),
    "prior_is_instance": ({"with_prior_preservation": True,
                           "prior_loss_weight": 0.7}, {}),
    "precomputed_embeddings": ({}, {}),
}


def _trainable(case):
    t = {"lora_unet": random_lora(unet_lora_sites(TINY_UNET), 1)}
    if case != "precomputed_embeddings":  # the trainer's guard: no text
        t["lora_text"] = random_lora(text_encoder_lora_sites(TINY_TEXT), 2)
        t["ti"] = {"embeds": (0.02 * np.random.default_rng(3).standard_normal(
            (2, TINY_TEXT.hidden_size))).astype(np.float32)}
    return t


def _grads(tree):
    if isinstance(tree, torch.Tensor):
        return tree.grad.numpy()
    return {k: _grads(v) for k, v in tree.items()}


def _assert_grads_close(got, want, where=""):
    """Every leaf of `want` (a JAX gradient tree) against `got`, with an
    absolute floor scaled to the group's largest gradient."""
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    scale = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(
            np.asarray(flat_g[path]), np.asarray(w), rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * scale,
            err_msg=f"{where}{jax.tree_util.keystr(path)}")


# the cases of test_loss_step_matches_jax, one JAX compile each, spread
# over three files so that the test workers (one file each) share them:
# this file, test_torch_port_loss_uncached.py and
# test_torch_port_loss_prior.py
CASES_HERE = ("mask",)


@pytest.mark.parametrize("case", CASES_HERE)
def test_loss_step_matches_jax(bases, case):
    check_loss_step(bases, case)


def check_loss_step(bases, case):
    """The loss value and every trainable leaf's gradient of one CASES
    entry against lora_tpu's jitted value_and_grad."""
    cfg_kw, sched_kw = CASES[case]
    j_cfg = j_loss.LossConfig(**cfg_kw)
    t_cfg = t_loss.LossConfig(**cfg_kw)
    j_s = j_sched.make_schedule(**sched_kw)
    t_s = t_sched.make_schedule(**sched_kw)
    (ju, jt, jv), (tu, tt, tv) = bases
    bsz = 4 if case == "prior_is_instance" else 2
    batch = _batch(case, bsz)
    trainable = _trainable(case)
    rng = jax.random.PRNGKey(21)
    draws = jax_draws(rng, (bsz, 8, 8, 4), j_s.num_train_timesteps)

    def f(t, base, b):
        return j_loss.loss_step(
            t, b, rng, unet_params=base[0], text_params=base[1],
            vae_params=base[2], unet_cfg=TINY_UNET, text_cfg=TINY_TEXT,
            vae_cfg=TINY_VAE, sched=j_s, cfg=j_cfg,
            ti_ids=jnp.asarray(TI_IDS))

    j_val, j_grads = jax.jit(jax.value_and_grad(f))(
        jax.tree_util.tree_map(jnp.asarray, trainable), (ju, jt, jv),
        {k: jnp.asarray(v) for k, v in batch.items()})

    t_tr = trainable_from_jax(trainable)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "input_ids" in t_batch:
        t_batch["input_ids"] = t_batch["input_ids"].long()
    loss = t_loss.loss_step(
        t_tr, t_batch, None, unet_params=tu, text_params=tt, vae_params=tv,
        unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE, sched=t_s,
        cfg=t_cfg, ti_ids=torch.from_numpy(TI_IDS).long(),
        **{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    loss.backward()

    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=LOSS_RTOL)
    for group in trainable:
        _assert_grads_close(_grads(t_tr[group]), j_grads[group],
                            where=f"{case}/{group}")


def test_inpainting_inputs_match_jax(bases):
    """The 9-channel inpainting input (noisy | mask | masked latents),
    cached, on a UNet with in_channels 9."""
    cfg_unet = dataclasses.replace(TINY_UNET, in_channels=9)
    ju, tu = _port_init(UNet, cfg_unet, 4)
    (_, jt, jv), (_, tt, tv) = bases
    rng_np = np.random.default_rng(5)
    batch = {
        "latents": rng_np.standard_normal((2, 8, 8, 4)).astype(np.float32),
        "encoder_hidden_states": rng_np.standard_normal(
            (2, 7, TINY_UNET.cross_attention_dim)).astype(np.float32),
        "masked_image_latents": rng_np.standard_normal((2, 8, 8, 4)).astype(
            np.float32),
        "mask_values": (rng_np.uniform(size=(2, 8, 8, 1)) > 0.5).astype(
            np.float32),
    }
    trainable = {"lora_unet": random_lora(unet_lora_sites(cfg_unet), 6)}
    rng = jax.random.PRNGKey(8)
    sched = j_sched.make_schedule()
    draws = jax_draws(rng, (2, 8, 8, 4), 1000)
    cfg = dict(train_inpainting=True)

    def f(t):
        return j_loss.loss_step(
            t, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
            unet_params=ju, text_params=jt, vae_params=jv, unet_cfg=cfg_unet,
            text_cfg=TINY_TEXT, vae_cfg=TINY_VAE, sched=sched,
            cfg=j_loss.LossConfig(**cfg))

    j_val, j_grads = jax.jit(jax.value_and_grad(f))(
        jax.tree_util.tree_map(jnp.asarray, trainable))
    t_tr = trainable_from_jax(trainable)
    loss = t_loss.loss_step(
        t_tr, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
        unet_params=tu, text_params=tt, vae_params=tv, unet_cfg=cfg_unet,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
        sched=t_sched.make_schedule(), cfg=t_loss.LossConfig(**cfg),
        noise=torch.from_numpy(np.array(draws["noise"])),
        timesteps=torch.from_numpy(np.array(draws["timesteps"])))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=LOSS_RTOL)
    _assert_grads_close(_grads(t_tr["lora_unet"]), j_grads["lora_unet"])


@pytest.mark.parametrize("h,w", [(8, 8), (16, 8), (5, 3)])
def test_resize_mask_nearest_matches_jax(h, w):
    m = np.random.default_rng(9).uniform(size=(2, 64, 48, 1)).astype(
        np.float32)
    want = j_loss._resize_mask_nearest(jnp.asarray(m), h, w)
    got = t_loss._resize_mask_nearest(torch.from_numpy(m), h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("is_instance", [None, [1, 0, 1, 0], [0, 1, 1, 0]])
def test_prior_preserving_reduce_matches_jax(is_instance):
    per = np.array([0.3, 1.2, 0.7, 2.5], np.float32)
    mask = None if is_instance is None else np.array(is_instance, np.float32)
    want = j_loss.prior_preserving_reduce(
        jnp.asarray(per), None if mask is None else jnp.asarray(mask), 0.6)
    got = t_loss.prior_preserving_reduce(
        torch.from_numpy(per), None if mask is None else torch.from_numpy(mask),
        0.6)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_get_velocity_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    n = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    t = np.array([0, 499, 999], np.int32)
    want = j_sched.get_velocity(j_sched.make_schedule(), jnp.asarray(x),
                                jnp.asarray(n), jnp.asarray(t))
    got = t_sched.get_velocity(t_sched.make_schedule(), torch.from_numpy(x),
                               torch.from_numpy(n), torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sdxl_loss_raises(bases):
    """SDXL's text_time UNet trains: the loss from cached latents and
    precomputed conditioning (context, te2's pooled rows, time_ids) is
    lora_tpu's (tests/test_torch_port_sdxl_train*.py hold the rest)."""
    from lora_tpu.models.config import TINY_XL_UNET

    (_, jt, jv), (_, tt, tv) = bases
    ju, tu = _port_init(UNet, TINY_XL_UNET, 5)
    rng_np = np.random.default_rng(6)
    batch = {
        "latents": rng_np.standard_normal((2, 8, 8, 4)).astype(np.float32),
        "encoder_hidden_states": rng_np.standard_normal(
            (2, 7, TINY_XL_UNET.cross_attention_dim)).astype(np.float32),
        "add_text_embeds": rng_np.standard_normal((2, 28)).astype(
            np.float32),
        "add_time_ids": np.array([[64, 64, 0, 0, 64, 64],
                                  [80, 120, 0, 16, 64, 64]], np.float32)}
    rng = jax.random.PRNGKey(9)
    draws = jax_draws(rng, (2, 8, 8, 4), 1000)
    want = jax.jit(lambda b: j_loss.loss_step(
        {}, b, rng, unet_params=ju, text_params=jt, vae_params=jv,
        unet_cfg=TINY_XL_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
        sched=j_sched.make_schedule(), cfg=j_loss.LossConfig()))(
            {k: jnp.asarray(v) for k, v in batch.items()})
    got = t_loss.loss_step(
        {}, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
        unet_params=tu, text_params=tt, vae_params=tv,
        unet_cfg=TINY_XL_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
        sched=t_sched.make_schedule(), cfg=t_loss.LossConfig(),
        noise=torch.from_numpy(np.array(draws["noise"])),
        timesteps=torch.from_numpy(np.array(draws["timesteps"])))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
