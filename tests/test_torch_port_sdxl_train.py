"""SDXL training in the port against lora_tpu's, in float32 on the tiny XL
configs: the loss and the gradient of every trainable leaf (lora_unet,
lora_text, lora_text2) through both text encoders and the text_time
conditioning, cached and uncached, with and without the text LoRAs and
gradient checkpointing. tests/test_torch_port_sdxl_train_step.py holds the
train step and te2's ids.

jax.random's draws are reproduced from each key and handed to the port, as
in tests/test_torch_port_training.py, whose tolerances these are.
"""

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
from lora_tpu.models.config import (  # noqa: E402
    TINY_VAE,
    TINY_XL_TEXT,
    TINY_XL_TEXT2,
    TINY_XL_UNET,
)
from lora_tpu.training import loss as j_loss  # noqa: E402
from lora_tpu_torch.convert import trainable_from_jax  # noqa: E402
from lora_tpu_torch.models import schedulers as t_sched  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import (  # noqa: E402
    StableDiffusionXLPipeline,
)
from lora_tpu_torch.training import loss as t_loss  # noqa: E402

from test_torch_port_training import (  # noqa: E402
    _assert_grads_close,
    jax_draws,
    random_lora,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

# f32 on both sides (tests/test_torch_port_training.py:42-43)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4
EOS = 999
T = 9  # tokens per prompt


@pytest.fixture(scope="module")
def bases():
    """(JAX params, the port's flat dicts) of the tiny XL UNet, te1, te2 and
    VAE, in the 4-tuple order of the SDXL step's base: the port's init from
    a seed, lora_tpu's distributions (lora_tpu's own init takes ~35 s here,
    op by op)."""
    pipe = StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_XL_UNET,
        text_cfg=TINY_XL_TEXT, text2_cfg=TINY_XL_TEXT2, vae_cfg=TINY_VAE)
    tp = tuple(m.flat_params() for m in (pipe.unet, pipe.text_encoder,
                                         pipe.text_encoder_2, pipe.vae))
    jp = tuple({k: jnp.asarray(v.numpy()) for k, v in p.items()} for p in tp)
    return jp, tp


def _ids(bsz, rng):
    """te1-style ids: BOS, words, EOS, then EOS padding; each row's text a
    different length, so te2's zero padding and pooled row differ."""
    ids = np.full((bsz, T), EOS, np.int32)
    for b in range(bsz):
        n = 3 + 2 * b
        ids[b, 0] = 998
        ids[b, 1:n] = rng.integers(0, 900, n - 1)
    return ids


def _batch(case, bsz=2):
    rng = np.random.default_rng(31)
    b = {"add_time_ids": np.array([[64, 64, 0, 0, 64, 64],
                                   [80, 120, 0, 16, 64, 64]],
                                  np.float32)[:bsz]}
    if case.startswith("uncached"):
        b["pixel_values"] = rng.uniform(-1, 1, (bsz, 64, 64, 3)).astype(
            np.float32)
    else:
        b["latents"] = rng.standard_normal((bsz, 8, 8, 4)).astype(np.float32)
    if case == "precomputed_embeddings":
        b["encoder_hidden_states"] = rng.standard_normal(
            (bsz, T, TINY_XL_UNET.cross_attention_dim)).astype(np.float32)
        b["add_text_embeds"] = rng.standard_normal(
            (bsz, TINY_XL_TEXT2.projection_dim)).astype(np.float32)
    else:
        b["input_ids"] = _ids(bsz, rng)
    if case.endswith("input_ids_2"):
        ids2 = j_loss.ids2_from_ids(b["input_ids"], EOS)
        ids2[:, -1] = 7  # te2's ids as given, not derived
        b["input_ids_2"] = ids2
    return b


# case: (LossConfig kwargs, trains te1 and te2's LoRAs); each JAX compile
# of the loss's value and gradient takes 20-70 s here, so the cases pair
# the variants up: cached latents / uncached (VAE encode), te1 and te2's
# LoRAs / the UNet's alone, gradient checkpointing on / off, te2's ids
# derived / given, the text encoded in the step / precomputed. The first
# and third share one JAX compile (_jax_inputs)
CASES = {
    "cached_text_lora": ({}, True),
    "uncached_text_lora_remat": ({"cached_latents": False,
                                  "gradient_checkpointing": True}, True),
    "unet_only_input_ids_2": ({}, False),
    "precomputed_embeddings": ({}, False),
}


def _trainable(text: bool):
    t = {"lora_unet": random_lora(unet_lora_sites(TINY_XL_UNET), 1)}
    if text:
        t["lora_text"] = random_lora(text_encoder_lora_sites(TINY_XL_TEXT), 2)
        t["lora_text2"] = random_lora(
            text_encoder_lora_sites(TINY_XL_TEXT2), 3)
    return t


def _grads(tree):
    """The leaves' gradients; None (a leaf no op read) as zeros, which is
    what jax.grad gives it: te1 is read at its penultimate layer, so its
    last layer's LoRA never runs."""
    if isinstance(tree, torch.Tensor):
        return (np.zeros(tuple(tree.shape), np.float32) if tree.grad is None
                else tree.grad.numpy())
    return {k: _grads(v) for k, v in tree.items()}


def _unread(group, site):
    return (group == "lora_text" and site.startswith(
        f"text_model.encoder.layers.{TINY_XL_TEXT.num_hidden_layers - 1}."))


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("input_ids", "input_ids_2"):
        if k in out:
            out[k] = out[k].long()
    return out


def _jax_inputs(batch, trainable):
    """lora_tpu's (trainable, batch) for a case, in one structure for every
    case that encodes ids, so those share a JAX compile: te2's ids always
    given (where the port derives them, lora_tpu's ids2_from_ids of te1's,
    which its loss would compute), and te1 and te2's LoRAs always there (at
    scale 0 where the port trains the UNet's alone: they add exactly 0)."""
    trainable = dict(trainable)
    if "input_ids" in batch:
        batch = dict(batch)
        batch.setdefault("input_ids_2", np.asarray(
            j_loss.ids2_from_ids(batch["input_ids"], EOS)))
        for group, tree in _trainable(True).items():
            trainable.setdefault(group, dict(tree, scale=np.float32(0.0)))
    return (jax.tree_util.tree_map(jnp.asarray, trainable),
            {k: jnp.asarray(v) for k, v in batch.items()})


_JAX_LOSSES = {}  # LossConfig kwargs -> lora_tpu's jitted value and grad


@pytest.mark.parametrize("case", list(CASES))
def test_sdxl_loss_step_matches_jax(bases, case):
    cfg_kw, text = CASES[case]
    (ju, jt, jt2, jv), (tu, tt, tt2, tv) = bases
    batch = _batch(case)
    trainable = _trainable(text)
    rng = jax.random.PRNGKey(41)
    sched = j_sched.make_schedule()
    draws = jax_draws(rng, (2, 8, 8, 4), sched.num_train_timesteps)

    key = tuple(sorted(cfg_kw.items()))
    if key not in _JAX_LOSSES:
        def f(t, b):
            return j_loss.loss_step(
                t, b, rng, unet_params=ju, text_params=jt, vae_params=jv,
                unet_cfg=TINY_XL_UNET, text_cfg=TINY_XL_TEXT,
                vae_cfg=TINY_VAE, sched=sched,
                cfg=j_loss.LossConfig(**cfg_kw), text2_params=jt2,
                text2_cfg=TINY_XL_TEXT2, eos_id=EOS)

        _JAX_LOSSES[key] = jax.jit(jax.value_and_grad(f))
    j_val, j_grads = _JAX_LOSSES[key](*_jax_inputs(batch, trainable))

    t_tr = trainable_from_jax(trainable)
    loss = t_loss.loss_step(
        t_tr, _torch_batch(batch), None, unet_params=tu, text_params=tt,
        vae_params=tv, unet_cfg=TINY_XL_UNET, text_cfg=TINY_XL_TEXT,
        vae_cfg=TINY_VAE, sched=t_sched.make_schedule(),
        cfg=t_loss.LossConfig(**cfg_kw), text2_params=tt2,
        text2_cfg=TINY_XL_TEXT2, eos_id=EOS,
        **{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    loss.backward()

    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=LOSS_RTOL)
    assert set(trainable) <= set(j_grads)
    for group in trainable:
        _assert_grads_close(_grads(t_tr[group]), j_grads[group],
                            where=f"{case}/{group}")
        # every site that runs gets a gradient (te2's pooled row and the
        # time embedding reach te2's last layer)
        for site, entry in _grads(t_tr[group])["sites"].items():
            moved = max(np.abs(g).max() for g in entry.values())
            assert (moved == 0) == _unread(group, site), (group, site)


def test_sdxl_ti_raises_lora_tpus_error(bases):
    _, (tu, tt, tt2, tv) = bases
    with pytest.raises(ValueError, match="textual inversion is not "
                                         "supported for SDXL training"):
        t_loss.loss_step(
            {"ti": {"embeds": torch.zeros(2, TINY_XL_TEXT.hidden_size)}},
            _torch_batch(_batch("cached_text_lora")), None, unet_params=tu,
            text_params=tt, vae_params=tv, unet_cfg=TINY_XL_UNET,
            text_cfg=TINY_XL_TEXT, vae_cfg=TINY_VAE,
            sched=t_sched.make_schedule(), cfg=t_loss.LossConfig(),
            text2_params=tt2, text2_cfg=TINY_XL_TEXT2, eos_id=EOS)
