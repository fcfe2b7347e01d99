"""The port's SDXL train step against lora_tpu's, in float32 on the tiny XL
configs: three steps on the (unet, text, text2, vae) base with LoRAs on the
UNet, te1 and te2; gradient checkpointing with the text_time conditioning;
the SD step's 3-tuple base; te2's ids against lora_tpu's and the
tokenizer's. tests/test_torch_port_sdxl_train.py holds the loss."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.models import schedulers as j_sched  # noqa: E402
from lora_tpu.models.config import (  # noqa: E402
    TINY_VAE,
    TINY_XL_TEXT,
    TINY_XL_TEXT2,
    TINY_XL_UNET,
)
from lora_tpu.training import loss as j_loss  # noqa: E402
from lora_tpu.training import optim as j_optim  # noqa: E402
from lora_tpu.training import train_step as j_ts  # noqa: E402
from lora_tpu_torch.convert import (  # noqa: E402
    trainable_from_jax,
    trainable_to_numpy,
)
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.models import schedulers as t_sched  # noqa: E402
from lora_tpu_torch.training import loss as t_loss  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402
from lora_tpu_torch.training import train_step as t_ts  # noqa: E402

from test_torch_port_sdxl_train import (  # noqa: E402,F401
    EOS,
    LOSS_RTOL,
    _batch,
    _grads,
    _ids,
    _one_torch_thread,
    _torch_batch,
    _trainable,
    bases,
)
from test_torch_port_training import jax_draws  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

CFGS = dict(unet_cfg=TINY_XL_UNET, text_cfg=TINY_XL_TEXT, vae_cfg=TINY_VAE,
            text2_cfg=TINY_XL_TEXT2)


def test_sdxl_remat_gives_the_same_gradients(bases):
    """Gradient checkpointing with added_cond: te2's pooled row reaches
    every resnet through add_embedding and the time embedding, which pass
    through checkpoint as arguments; the same ops on the same inputs give
    the same bits on the CPU."""
    _, (tu, tt, tt2, tv) = bases
    batch = _torch_batch(_batch("cached_text_lora"))
    out = []
    for remat in (False, True):
        tree = trainable_from_jax(_trainable(True))
        loss = t_loss.loss_step(
            tree, batch, None, unet_params=tu, text_params=tt, vae_params=tv,
            unet_cfg=TINY_XL_UNET, text_cfg=TINY_XL_TEXT, vae_cfg=TINY_VAE,
            sched=t_sched.make_schedule(),
            cfg=t_loss.LossConfig(gradient_checkpointing=remat),
            text2_params=tt2, text2_cfg=TINY_XL_TEXT2, eos_id=EOS,
            noise=torch.ones(2, 8, 8, 4), timesteps=torch.tensor([10, 700]))
        loss.backward()
        out.append((loss.item(), jax.tree_util.tree_leaves(
            _grads(tree))))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


def test_sdxl_train_step_matches_jax(bases):
    """3 steps of make_train_step on the (unet, text, text2, vae) base:
    LoRAs on the UNet, te1 and te2 with their own learning rates, clip 1.0;
    as tests/test_torch_port_train_step.py holds the SD step."""
    jb, tb = bases
    tree = _trainable(True)
    lrs = {"lora_unet": 1e-3, "lora_text": 5e-4, "lora_text2": 5e-4}
    batch = _batch("cached_text_lora")
    keys = [jax.random.PRNGKey(200 + i) for i in range(3)]

    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    j_opt = j_optim.make_optimizer(j_tree, lrs)
    j_step = j_ts.make_train_step(
        sched=j_sched.make_schedule(), loss_cfg=j_loss.LossConfig(),
        optimizer=j_opt, eos_id=EOS, **CFGS)
    state = j_opt.init(j_tree)
    j_losses = []
    for key in keys:
        j_tree, state, loss = j_step(
            j_tree, state, jb, {k: jnp.asarray(v) for k, v in batch.items()},
            key)
        j_losses.append(float(loss))

    t_tree = trainable_from_jax(tree)
    t_step = t_ts.make_train_step(
        sched=t_sched.make_schedule(), loss_cfg=t_loss.LossConfig(),
        optimizer=t_optim.make_optimizer(t_tree, lrs), eos_id=EOS, **CFGS)
    t_losses = []
    for key in keys:
        d = jax_draws(key, (2, 8, 8, 4), 1000)
        t_losses.append(t_step(
            t_tree, tb, _torch_batch(batch),
            noise=torch.from_numpy(np.array(d["noise"])),
            timesteps=torch.from_numpy(np.array(d["timesteps"]))).item())

    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    got = dict(jax.tree_util.tree_leaves_with_path(trainable_to_numpy(t_tree)))
    start = dict(jax.tree_util.tree_leaves_with_path(tree))
    moved = {}
    for path, want in jax.tree_util.tree_leaves_with_path(j_tree):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=0,
                                   atol=min(lrs.values()) / 3,
                                   err_msg=jax.tree_util.keystr(path))
        group = path[0].key
        moved[group] = max(moved.get(group, 0.0), float(
            np.abs(np.asarray(want) - start[path]).max()))
    assert all(m > 1e-4 for m in moved.values()), moved


def test_sdxl_step_takes_the_three_tuple_base_without_text2(bases):
    """Without text2_cfg the base stays (unet, text, vae), so SD callers are
    unchanged, and an SDXL UNet with TI ends where lora_tpu's does."""
    _, (tu, tt, _, tv) = bases
    tree = trainable_from_jax({"ti": {"embeds": np.zeros(
        (2, TINY_XL_TEXT.hidden_size), np.float32)}})
    step = t_ts.make_train_step(
        unet_cfg=TINY_XL_UNET, text_cfg=TINY_XL_TEXT, vae_cfg=TINY_VAE,
        sched=t_sched.make_schedule(), loss_cfg=t_loss.LossConfig(),
        optimizer=t_optim.make_optimizer(tree, {"ti": 1e-3}))
    with pytest.raises(ValueError, match="dual-tokenizer TI"):
        step(tree, (tu, tt, tv), _torch_batch(_batch("cached_text_lora")))


def test_ids2_from_ids_matches_jax_and_the_tokenizer():
    """Against lora_tpu's ids2_from_ids on numpy and jax inputs, and
    against the tokenizer's own te2 padding (pad_token_id=0), which the
    pipeline encodes with."""
    def port(ids, eos):
        got = t_loss.ids2_from_ids(torch.as_tensor(np.asarray(ids)), eos)
        assert got.dtype == torch.long
        return got.numpy()

    rng = np.random.default_rng(5)
    ids = _ids(3, rng).astype(np.int64)
    want = np.asarray(j_loss.ids2_from_ids(ids, EOS))
    np.testing.assert_array_equal(
        np.asarray(j_loss.ids2_from_ids(jnp.asarray(ids), EOS)), want)
    np.testing.assert_array_equal(port(ids, EOS), want)
    # lora_tpu's unit case
    eos = 9
    np.testing.assert_array_equal(
        port([[1, 4, 2, eos, eos, eos], [1, eos, eos, eos, eos, eos]], eos),
        [[1, 4, 2, eos, 0, 0], [1, eos, 0, 0, 0, 0]])
    prompts = ["a photo of sks dog", "a watercolor of a lighthouse at dawn "
               "over a calm sea with two boats", "x " * 90]
    for tok in (CLIPTokenizer(vocab_size=1000), JTokenizer(vocab_size=1000)):
        ids1 = np.array(tok(prompts)["input_ids"])
        ids2 = np.array(tok(prompts, pad_token_id=0)["input_ids"])
        np.testing.assert_array_equal(port(ids1, tok.eos_token_id), ids2)
        np.testing.assert_array_equal(
            np.asarray(j_loss.ids2_from_ids(ids1, tok.eos_token_id)), ids2)
