"""The port's UNet, CLIP text encoder and VAE against lora_tpu's, in float32
on the tiny configs: params are carried across with lora_tpu_torch.convert,
inputs come from numpy, and the outputs also match the JAX package's frozen
goldens (tests/goldens/tiny_golden.npz) at tests/test_goldens.py's
tolerances."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_lora_sites,
    unet_lora_sites,
)
from lora_tpu.models import clip as j_clip  # noqa: E402
from lora_tpu.models import config as cfgs  # noqa: E402
from lora_tpu.models import unet as j_unet  # noqa: E402
from lora_tpu.models import vae as j_vae  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax, state_dict_from_jax  # noqa: E402
from lora_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.models.vae import VAE  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "tiny_golden.npz")
RTOL, ATOL = 1e-4, 1e-5
# one XLA compile per (config, LoRA or not) instead of one per eager op
_jax_unet = jax.jit(j_unet.unet_forward, static_argnums=(4,))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def unet_params():
    """JAX UNet params per config name, drawn once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = j_unet.init_unet(getattr(cfgs, name),
                                           jax.random.PRNGKey(0))
        return cache[name]

    return get


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _port(module_cls, cfg, jax_params):
    m = module_cls(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(_np(jax_params)), strict=True)
    return m


def _lora_tree(sites, seed, r=4):
    """A rank-4 LoRA with nonzero up on every site (numpy leaves)."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in sites:
        k = () if s.kind == "linear" else tuple(s.kernel)
        tail = () if s.kind == "linear" else (1, 1)
        out[s.name] = {
            "up": (0.1 * rng.standard_normal((s.out_dim, r) + tail))
            .astype(np.float32),
            "down": (0.1 * rng.standard_normal((r, s.in_dim) + k))
            .astype(np.float32)}
    return {"sites": out, "scale": np.float32(0.8)}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("cfg_name", ["TINY_UNET", "TINY_SD2_UNET"])
@pytest.mark.parametrize("with_lora", [False, True])
def test_unet_matches_jax(unet_params, cfg_name, with_lora):
    cfg = getattr(cfgs, cfg_name)
    jp = unet_params(cfg_name)
    unet = _port(UNet, cfg, jp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 7, cfg.cross_attention_dim)).astype(
        np.float32)
    tree = (_lora_tree(unet_lora_sites(cfg), seed=2) if with_lora else None)
    ref = _jax_unet(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), cfg,
                    tree and _jax_tree(tree))
    with torch.inference_mode():
        out = unet(torch.from_numpy(x), torch.from_numpy(t).long(),
                   torch.from_numpy(ctx), lora=tree and lora_from_jax(tree))
    assert out.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    if with_lora:  # the LoRA really moved the output
        with torch.inference_mode():
            base = unet(torch.from_numpy(x), torch.from_numpy(t).long(),
                        torch.from_numpy(ctx))
        assert (base - out).abs().max() > 1e-3


def test_unet_golden(golden, unet_params):
    cfg = cfgs.TINY_UNET
    unet = _port(UNet, cfg, unet_params("TINY_UNET"))
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (2, 8, 8, 4)))
    ctx = np.array(jax.random.normal(jax.random.PRNGKey(4),
                                     (2, 7, cfg.cross_attention_dim)))
    with torch.inference_mode():
        out = unet(torch.from_numpy(x), torch.tensor([10, 500]),
                   torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), golden["unet"], rtol=RTOL,
                               atol=ATOL)


def test_unet_state_dict_keys_are_the_flat_names(unet_params):
    cfg = cfgs.TINY_SD2_UNET
    jp = unet_params("TINY_SD2_UNET")
    unet = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert sorted(unet.state_dict()) == sorted(jp)
    for k, v in unet.state_dict().items():
        assert tuple(v.shape) == tuple(jp[k].shape), k


def test_sdxl_text_time_raises(unet_params):
    """The SDXL text_time UNet builds (it raised before SDXL was ported):
    lora_tpu's parameter names and shapes, add_embedding included."""
    jp = unet_params("TINY_XL_UNET")
    unet = UNet(cfgs.TINY_XL_UNET, device="cpu",
                generator=torch.Generator().manual_seed(0))
    assert sorted(unet.state_dict()) == sorted(jp)
    assert "add_embedding.linear_1.weight" in jp
    for k, v in unet.state_dict().items():
        assert tuple(v.shape) == tuple(jp[k].shape), k


@pytest.mark.parametrize("cfg_name,mode", [("TINY_TEXT", "last"),
                                           ("TINY_SD2_TEXT", "penultimate"),
                                           ("TINY_XL_TEXT2", "pooled")])
def test_clip_matches_jax(cfg_name, mode):
    """With a LoRA on every default site and two TI rows written in."""
    cfg = getattr(cfgs, cfg_name)
    jp = j_clip.init_clip_text(cfg, jax.random.PRNGKey(1))
    clip = _port(CLIPTextModel, cfg, jp)
    rng = np.random.default_rng(3)
    eos = cfg.vocab_size - 1
    ids = np.array([[eos - 1, 5, 9, 2, eos, eos, eos],
                    [eos - 1, 7, 5, eos, eos, eos, eos]], np.int32)
    ti_embeds = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    ti_ids = np.array([5, 9], np.int32)
    tree = _lora_tree(text_encoder_lora_sites(cfg), seed=4)
    kw = {"penultimate": mode == "penultimate",
          "pooled_eos_id": eos if mode == "pooled" else None}
    ref = j_clip.clip_text_forward(
        jp, jnp.asarray(ids), cfg, lora=_jax_tree(tree),
        ti_embeds=jnp.asarray(ti_embeds), ti_ids=jnp.asarray(ti_ids), **kw)
    with torch.inference_mode():
        out = clip(torch.from_numpy(ids).long(), lora=lora_from_jax(tree),
                   ti_embeds=torch.from_numpy(ti_embeds),
                   ti_ids=torch.from_numpy(ti_ids).long(), **kw)
    refs = ref if mode == "pooled" else (ref,)
    outs = out if mode == "pooled" else (out,)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def test_clip_golden(golden):
    cfg = cfgs.TINY_TEXT
    clip = _port(CLIPTextModel, cfg,
                 j_clip.init_clip_text(cfg, jax.random.PRNGKey(1)))
    with torch.inference_mode():
        out = clip(torch.tensor([[1, 5, 9, 2, 0, 0, 0]]))
    np.testing.assert_allclose(out.numpy(), golden["clip"], rtol=RTOL,
                               atol=ATOL)


def test_vae_decode_matches_jax_and_golden(golden):
    cfg = cfgs.TINY_VAE
    jp = j_vae.init_vae(cfg, jax.random.PRNGKey(2))
    vae = _port(VAE, cfg, jp)
    z = np.random.default_rng(5).standard_normal((2, 4, 4, 4)).astype(
        np.float32)
    ref = j_vae.vae_decode(jp, jnp.asarray(z), cfg)
    with torch.inference_mode():
        out = vae.decode(torch.from_numpy(z))
        gold = vae.decode(torch.from_numpy(golden["z"]))
    assert out.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gold.numpy(), golden["vae_dec"], rtol=RTOL,
                               atol=ATOL)


def test_vae_encode_mean_matches_jax():
    """The encoder, with its asymmetric (0, 1) downsampling pad."""
    cfg = cfgs.TINY_VAE
    jp = j_vae.init_vae(cfg, jax.random.PRNGKey(2))
    vae = _port(VAE, cfg, jp)
    x = (0.5 * np.random.default_rng(6).standard_normal((1, 32, 32, 3))
         ).astype(np.float32)
    ref = j_vae.vae_encode(jp, jnp.asarray(x), cfg, jax.random.PRNGKey(0),
                           sample=False)
    with torch.inference_mode():
        out = vae.encode(torch.from_numpy(x), sample=False)
    assert out.shape == (1, 4, 4, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
