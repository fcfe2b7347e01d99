"""The port's optimizer and train step against lora_tpu's (optax), and the
training-only pieces of the forward: gradient checkpointing (remat) and
LoRA dropout with its per-site random source. Float32, tiny configs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_lora_sites,
    unet_lora_sites,
)
from lora_tpu.models import schedulers as j_sched  # noqa: E402
from lora_tpu.models.clip import init_clip_text  # noqa: E402
from lora_tpu.models.config import TINY_TEXT, TINY_UNET, TINY_VAE  # noqa: E402
from lora_tpu.models.unet import init_unet  # noqa: E402
from lora_tpu.training import loss as j_loss  # noqa: E402
from lora_tpu.training import optim as j_optim  # noqa: E402
from lora_tpu.training import train_step as j_ts  # noqa: E402
from lora_tpu_torch.convert import (  # noqa: E402
    state_dict_from_jax,
    trainable_from_jax,
    trainable_to_numpy,
)
from lora_tpu_torch.core.lora import lora_delta_dense  # noqa: E402
from lora_tpu_torch.models import layers as t_layers  # noqa: E402
from lora_tpu_torch.models import schedulers as t_sched  # noqa: E402
from lora_tpu_torch.training import loss as t_loss  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402
from lora_tpu_torch.training import train_step as t_ts  # noqa: E402

from test_torch_port_training import TI_IDS, jax_draws, random_lora  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny CPU shapes gain nothing from intra-op threads, and with
    several test processes on the cores those threads oversubscribe them
    (several times slower); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_trainable(with_ti=False):
    rng = np.random.default_rng(0)
    t = {"lora_unet": {
        "sites": {"a.to_q": {"up": rng.standard_normal((6, 2)),
                             "down": rng.standard_normal((2, 5))},
                  "b.conv": {"up": rng.standard_normal((3, 2, 1, 1)),
                             "down": rng.standard_normal((2, 4, 3, 3))}},
        "scale": np.float32(1.0)}}
    if with_ti:
        t["ti"] = {"embeds": rng.standard_normal((2, 5))}
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


def _toy_grads(tree, n, seed, mult=1.0):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda a: (mult * 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32), tree) for _ in range(n)]


def _set_grads(t_tree, g_tree):
    if isinstance(t_tree, torch.Tensor):
        t_tree.grad = torch.from_numpy(np.array(g_tree))
        return
    for k in t_tree:
        _set_grads(t_tree[k], g_tree[k])


OPT_CASES = {
    # name: (with_ti, lrs, make_optimizer kwargs, steps, gradient multiplier)
    "default": (False, {"lora_unet": 1e-3}, {}, 3, 1.0),
    "warmup_cosine": (False, {"lora_unet": ("cosine", 1e-2, 10, 2)}, {}, 3,
                      1.0),
    "grad_accum_2": (False, {"lora_unet": 1e-3}, {"grad_accum": 2}, 4, 1.0),
    "ti_group_no_decay": (True, {"lora_unet": 1e-3, "ti": 5e-2},
                          {"weight_decay": 0.5}, 3, 1.0),
    "clip_binds": (True, {"lora_unet": 1e-3, "ti": 1e-3},
                   {"max_grad_norm": 1.0}, 3, 100.0),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_make_optimizer_matches_optax(case):
    with_ti, lrs, kw, steps, mult = OPT_CASES[case]
    tree = _toy_trainable(with_ti)
    grads = _toy_grads(tree, steps, seed=1, mult=mult)
    j_lrs = {k: j_optim.make_lr_schedule(*v) if isinstance(v, tuple) else v
             for k, v in lrs.items()}
    t_lrs = {k: t_optim.make_lr_schedule(*v) if isinstance(v, tuple) else v
             for k, v in lrs.items()}

    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = j_optim.make_optimizer(j_tree, j_lrs, **kw)
    state = opt.init(j_tree)
    for g in grads:
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                state, j_tree)
        j_tree = optax.apply_updates(j_tree, upd)

    t_tree = trainable_from_jax(tree)
    t_opt = t_optim.make_optimizer(t_tree, t_lrs, **kw)
    for g in grads:
        _set_grads(t_tree, g)
        t_opt.step()
    got = trainable_to_numpy(t_tree)
    # f32 Adam on both sides; the global norm is summed in another order
    for path, want in jax.tree_util.tree_leaves_with_path(j_tree):
        np.testing.assert_allclose(
            dict(jax.tree_util.tree_leaves_with_path(got))[path],
            np.asarray(want), rtol=1e-5, atol=1e-7,
            err_msg=f"{case}{jax.tree_util.keystr(path)}")
    assert t_opt.count == (steps // kw.get("grad_accum", 1))


@pytest.mark.parametrize("name,warmup", [("constant", 0), ("linear", 0),
                                         ("cosine", 0), ("linear", 10),
                                         ("cosine", 3)])
def test_lr_schedules_match_optax(name, warmup):
    j = j_optim.make_lr_schedule(name, 1e-3, 100, warmup_steps=warmup)
    t = t_optim.make_lr_schedule(name, 1e-3, 100, warmup_steps=warmup)
    # optax evaluates in f32: near the end of the cosine 1 + cos(x) loses
    # digits there, so the floor is 1e-7 of the peak lr
    for count in (0, 1, 2, 5, 10, 11, 50, 99, 100, 150):
        assert t(count) == pytest.approx(float(j(count)), rel=1e-6, abs=1e-10)
    if warmup:
        assert t(0) == 0.0


def test_low_memory_adam_raises():
    """Both low-memory Adams run (tests/test_torch_port_optim_lowmem.py
    holds them against optax); only an unknown mode raises."""
    for mode in ("int8", "bf16", True):
        t_tree = trainable_from_jax(_toy_trainable())
        before = jax.tree_util.tree_map(np.array, trainable_to_numpy(t_tree))
        opt = t_optim.make_optimizer(t_tree, {"lora_unet": 1e-3},
                                     low_memory=mode)
        _set_grads(t_tree, _toy_grads(before, 1, seed=2)[0])
        opt.step()
        after = trainable_to_numpy(t_tree)
        assert opt.count == 1
        assert not np.array_equal(after["lora_unet"]["sites"]["a.to_q"]["up"],
                                  before["lora_unet"]["sites"]["a.to_q"]["up"])
    with pytest.raises(ValueError, match="low_memory"):
        t_optim.make_optimizer(trainable_from_jax(_toy_trainable()),
                               {"lora_unet": 1e-3}, low_memory="int4")


def test_ti_norm_prior_matches_jax():
    emb = np.array([[3.0, 4.0], [0.1, 0.0], [1.0, -2.0]], np.float32)
    for lr in (1.0, 1e-3):
        want = j_ts.ti_norm_prior(jnp.asarray(emb), lr=lr, target_norm=0.4)
        got = t_ts.ti_norm_prior(torch.from_numpy(emb), lr=lr, target_norm=0.4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_trainable_round_trip():
    tree = {"lora_unet": random_lora(unet_lora_sites(TINY_UNET), 1),
            "lora_text": random_lora(text_encoder_lora_sites(TINY_TEXT), 2),
            "ti": {"embeds": np.ones((2, 32), np.float32)}}
    t = trainable_from_jax(tree)
    leaves = t_optim.tree_leaves(t)
    assert leaves and all(x.requires_grad and x.is_leaf
                          and x.dtype == torch.float32 for x in leaves)
    back = trainable_to_numpy(t)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the train step on the tiny models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base():
    jp = (init_unet(TINY_UNET, jax.random.PRNGKey(0)),
          init_clip_text(TINY_TEXT, jax.random.PRNGKey(1)), {})
    tp = tuple(state_dict_from_jax({k: np.asarray(v) for k, v in p.items()})
               for p in jp)
    return jp, tp


def _step_batch():
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 900, (2, 7)).astype(np.int32)
    ids[:, 2], ids[:, 4] = TI_IDS
    return {"latents": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
            "input_ids": ids}


def test_train_step_matches_jax(base):
    """3 steps of make_train_step (LoRA on the UNet and the text encoder,
    TI, three learning rates, clip 1.0), each step's draws reproduced from
    its key. Adam divides each entry by its own RMS, so an entry whose
    gradient is near the f32 noise floor moves by up to lr in either
    direction: the trees agree to a third of the smallest lr, and the
    losses to 1e-5."""
    (ju, jt, jv), (tu, tt, tv) = base
    tree = {"lora_unet": random_lora(unet_lora_sites(TINY_UNET), 1),
            "lora_text": random_lora(text_encoder_lora_sites(TINY_TEXT), 2),
            "ti": {"embeds": (0.02 * np.random.default_rng(3)
                              .standard_normal((2, TINY_TEXT.hidden_size))
                              ).astype(np.float32)}}
    lrs = {"lora_unet": 1e-3, "lora_text": 5e-4, "ti": 5e-3}
    batch = _step_batch()
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]

    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    j_opt = j_optim.make_optimizer(j_tree, lrs)
    j_step = j_ts.make_train_step(
        unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
        sched=j_sched.make_schedule(), loss_cfg=j_loss.LossConfig(),
        optimizer=j_opt, ti_ids=jnp.asarray(TI_IDS))
    state = j_opt.init(j_tree)
    j_losses = []
    for key in keys:
        j_tree, state, loss = j_step(
            j_tree, state, (ju, jt, jv),
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
        j_losses.append(float(loss))

    t_tree = trainable_from_jax(tree)
    t_step = t_ts.make_train_step(
        unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
        sched=t_sched.make_schedule(), loss_cfg=t_loss.LossConfig(),
        optimizer=t_optim.make_optimizer(t_tree, lrs),
        ti_ids=torch.from_numpy(TI_IDS).long())
    t_batch = {"latents": torch.from_numpy(batch["latents"]),
               "input_ids": torch.from_numpy(batch["input_ids"]).long()}
    t_losses = []
    for key in keys:
        d = jax_draws(key, (2, 8, 8, 4), 1000)
        loss = t_step(t_tree, (tu, tt, tv), t_batch,
                      noise=torch.from_numpy(np.array(d["noise"])),
                      timesteps=torch.from_numpy(np.array(d["timesteps"])))
        assert loss.ndim == 0 and not loss.requires_grad
        t_losses.append(loss.item())

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    got = trainable_to_numpy(t_tree)
    moved = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(j_tree):
        g = dict(jax.tree_util.tree_leaves_with_path(got))[path]
        np.testing.assert_allclose(g, np.asarray(want), rtol=0,
                                   atol=min(lrs.values()) / 3,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, float(np.abs(np.asarray(want) -
                                        dict(jax.tree_util.tree_leaves_with_path(
                                            tree))[path]).max()))
    assert moved > 1e-3  # the steps really moved the trees


def test_train_step_mesh_raises(base, tmp_path):
    """A mesh of a 1-rank gloo group gives the no-mesh step's losses and
    leaves, bit for bit (tests/test_torch_port_mesh.py and
    test_torch_port_dp.py hold 2-rank meshes against one process); an
    object that is no parallel.mesh.Mesh raises TypeError."""
    from lora_tpu_torch.parallel import mesh as mesh_lib

    from test_torch_port_mesh import one_rank_group

    _, (tu, tt, tv) = base
    tree = {"lora_unet": random_lora(unet_lora_sites(TINY_UNET), 1),
            "lora_text": random_lora(text_encoder_lora_sites(TINY_TEXT), 2)}
    batch = _step_batch()
    t_batch = {"latents": torch.from_numpy(batch["latents"]),
               "input_ids": torch.from_numpy(batch["input_ids"]).long()}
    runs = []
    with one_rank_group(tmp_path):
        for mesh in (None, mesh_lib.make_mesh(dp=1)):
            t_tree = trainable_from_jax(tree)
            step = t_ts.make_train_step(
                unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
                sched=t_sched.make_schedule(), loss_cfg=t_loss.LossConfig(),
                optimizer=t_optim.make_optimizer(
                    t_tree, {"lora_unet": 1e-3, "lora_text": 5e-4}),
                mesh=mesh)
            losses = [step(t_tree, (tu, tt, tv), t_batch,
                           torch.Generator().manual_seed(i)).item()
                      for i in range(2)]
            runs.append((losses, t_optim.tree_leaves(t_tree)))
    (l0, t0), (l1, t1) = runs
    assert l0 == l1
    for a, b in zip(t0, t1):
        assert torch.equal(a, b)
    opt = t_optim.make_optimizer(trainable_from_jax(_toy_trainable()),
                                 {"lora_unet": 1e-3})
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        t_ts.make_train_step(
            unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
            sched=t_sched.make_schedule(), loss_cfg=t_loss.LossConfig(),
            optimizer=opt, mesh=object())


# ---------------------------------------------------------------------------
# remat and dropout (torch only: the masks cannot match jax.random's)
# ---------------------------------------------------------------------------

def _loss_and_grads(base, cfg, dropout_seed=None, seed=1):
    _, (tu, tt, tv) = base
    tree = trainable_from_jax(
        {"lora_unet": random_lora(unet_lora_sites(TINY_UNET), seed)})
    rng = np.random.default_rng(13)
    batch = {"latents": torch.from_numpy(
                 rng.standard_normal((2, 8, 8, 4)).astype(np.float32)),
             "encoder_hidden_states": torch.from_numpy(
                 rng.standard_normal((2, 7, 32)).astype(np.float32))}
    loss = t_loss.loss_step(
        tree, batch, None, unet_params=tu, text_params=tt, vae_params=tv,
        unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
        sched=t_sched.make_schedule(), cfg=cfg,
        noise=torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(
            np.float32)),
        timesteps=torch.tensor([10, 700]), dropout_seed=dropout_seed)
    loss.backward()
    return loss.item(), [x.grad.clone() for x in t_optim.tree_leaves(tree)]


@pytest.mark.parametrize("dropout_p", [0.0, 0.3])
def test_remat_matches_no_remat(base, dropout_p):
    """Gradient checkpointing recomputes each block in the backward; with
    dropout the recompute must draw the same masks (per-site generators,
    not the global RNG), or the gradients would silently differ. CPU f32
    recomputes the same ops on the same inputs: exact."""
    plain = _loss_and_grads(base, t_loss.LossConfig(lora_dropout_p=dropout_p),
                            dropout_seed=42)
    remat = _loss_and_grads(base, t_loss.LossConfig(
        lora_dropout_p=dropout_p, gradient_checkpointing=True),
        dropout_seed=42)
    assert remat[0] == plain[0]
    for a, b in zip(remat[1], plain[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if dropout_p > 0:  # the masks are really there
        other = _loss_and_grads(base, t_loss.LossConfig(
            lora_dropout_p=dropout_p), dropout_seed=43)
        assert other[0] != plain[0]


def test_dropout_p0_is_no_dropout():
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
    entry = {"up": torch.randn(8, 4), "down": torch.randn(4, 16)}
    scale = torch.tensor(0.7)
    gen = torch.Generator().manual_seed(0)
    torch.testing.assert_close(lora_delta_dense(x, entry, scale, gen, 0.0),
                               lora_delta_dense(x, entry, scale),
                               rtol=0, atol=0)
    params = {"l.weight": torch.randn(8, 16), "l.bias": torch.randn(8)}
    lora = {"sites": {"l": entry}, "scale": scale}
    torch.testing.assert_close(
        t_layers.dense(params, "l", x, {**lora, "rng": 5, "dropout_p": 0.0}),
        t_layers.dense(params, "l", x, lora), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["dense", "conv", "delta"])
def test_dropout_statistics(kind):
    """p = 0.25 on a bypass whose output is all ones: the same (seed, site)
    gives the same mask, another seed or site another one; the zeroed share
    is p and the mean stays 1 (both within 5 sigma of the binomial), since
    kept entries are scaled by 1 / (1 - p)."""
    p = 0.25
    if kind == "conv":
        x = torch.ones(1, 4, 64, 64)
        entry = {"up": torch.ones(8, 1, 1, 1),
                 "down": torch.full((1, 4, 1, 1), 0.25)}
        w = torch.zeros(8, 4, 1, 1)
        fn = t_layers.conv2d
    else:
        x = torch.ones(4, 128, 64)
        entry = ({"delta": torch.eye(64)} if kind == "delta" else
                 {"up": torch.ones(64, 1), "down": torch.full((1, 64), 1 / 64)})
        w = torch.zeros(64, 64)
        fn = t_layers.dense

    def run(seed, site="c"):
        lora = {"sites": {site: entry}, "scale": torch.tensor(1.0),
                "rng": seed, "dropout_p": p}
        return fn({site + ".weight": w}, site, x, lora=lora)

    a = run(3)
    torch.testing.assert_close(a, run(3), rtol=0, atol=0)
    assert not torch.equal(a, run(4))
    assert not torch.equal(a, run(3, site="d"))
    n = a.numel()
    zeroed = (a == 0).float().mean().item()
    assert abs(zeroed - p) < 5 * (p * (1 - p) / n) ** 0.5
    kept = a[a != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - p)))
    assert abs(a.mean().item() - 1.0) < 5 * (p / (1 - p) / n) ** 0.5
