"""parallel/mesh.py, the port's counterpart of lora_tpu/parallel/mesh.py:
the mesh refusals (against tests/test_training.py:225-240), param_pspec's
tp and FSDP axes for every weight of the tiny UNet, text encoders and VAE
against lora_tpu's, a 1-rank group, and on two CPU ranks over gloo (through this
file: `python tests/test_torch_port_mesh.py --worker ROOT`):

  - the train step with dp = 2 against lora_tpu's single-device step at
    the global batch (tests/test_training.py:174-206's rtol 1e-4), the JAX
    draws handed in for the global batch;
  - loss_step's global draws and reductions: uncached latents (the VAE
    posterior noise), LoRA dropout masks, a pixel mask whose peak is on
    the other rank, and the prior term split at the global midpoint: the
    ranks' mean loss and mean LoRA gradients are the one-process values on
    the global batch.
"""

import contextlib
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from lora_tpu_torch.convert import (  # noqa: E402
    trainable_from_jax,
    trainable_to_numpy,
)
from lora_tpu_torch.models import schedulers as t_sched  # noqa: E402
from lora_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_TEXT,
    TINY_UNET,
    TINY_VAE,
    TINY_XL_TEXT2,
)
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.models.vae import VAE  # noqa: E402
from lora_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from lora_tpu_torch.training import loss as t_loss  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402
from lora_tpu_torch.training import train_step as t_ts  # noqa: E402

from test_torch_port_dp import launch, ok  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

LRS = {"lora_unet": 1e-3, "lora_text": 5e-4, "ti": 5e-3}
TI_IDS = np.array([998, 999], np.int32)
STEP_RTOL = 1e-4  # tests/test_training.py:204's, the 8-device dp step
PARTS_RTOL = 1e-5


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A gloo process group of this process alone, for the block."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_from_flags_and_batch_guard():
    """lora_tpu's meshes and refusals with the same messages."""
    assert mesh_lib.mesh_from_flags(world=8) is None
    assert mesh_lib.mesh_from_flags(data_parallel=True, fsdp=2,
                                    world=1) is None
    m = mesh_lib.mesh_from_flags(data_parallel=True, world=8)
    assert m.shape == {"dp": 8, "fsdp": 1, "tp": 1} and not m.distributed
    m2 = mesh_lib.mesh_from_flags(data_parallel=True, fsdp=2, world=8)
    assert (m2.shape["dp"], m2.shape["fsdp"]) == (4, 2)
    assert mesh_lib.mesh_from_flags(fsdp=8, world=8).shape["dp"] == 1
    # tensor parallelism: lora_tpu's (2, 2, 2) on 8 devices; tp alone is
    # a mesh (dp 1), and no mesh on one device
    m3 = mesh_lib.mesh_from_flags(data_parallel=True, fsdp=2, tp=2, world=8)
    assert m3.shape == {"dp": 2, "fsdp": 2, "tp": 2} and not m3.distributed
    assert m3.coords == {"dp": 0, "fsdp": 0, "tp": 0}
    assert mesh_lib.mesh_from_flags(tp=2, world=2).shape == {
        "dp": 1, "fsdp": 1, "tp": 2}
    assert mesh_lib.mesh_from_flags(tp=2, world=1) is None
    assert mesh_lib.make_mesh(dp=4, tp=2, world=8).shape["tp"] == 2
    with pytest.raises(ValueError, match="divide the device count"):
        mesh_lib.mesh_from_flags(tp=3, world=8)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.mesh_from_flags(tp=2, world=8)  # dp disabled, 2 != 8
    with pytest.raises(ValueError, match="divide the device count"):
        mesh_lib.mesh_from_flags(data_parallel=True, fsdp=3, world=8)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.mesh_from_flags(fsdp=2, world=8)  # dp disabled, 2 != 8
    with pytest.raises(ValueError, match="mesh 3x1x1 != 8 devices"):
        mesh_lib.make_mesh(dp=3, world=8)
    # per-chip batch semantics: an indivisible global batch fails loudly
    with pytest.raises(ValueError, match="per-chip"):
        mesh_lib.shard_batch({"latents": torch.zeros((3, 2))}, m)
    with pytest.raises(RuntimeError, match="no process group"):
        m.all_reduce(torch.zeros(1))
    # a geometric mesh's blocks: rank 0's rows of a global batch
    got = mesh_lib.shard_batch({"x": np.arange(16)}, m2)
    np.testing.assert_array_equal(got["x"], [0, 1, 2, 3])
    assert mesh_lib.batch_sharding(None) == (0, 1)
    assert mesh_lib.data_parallel_size(m2) == 4


@pytest.mark.parametrize("n", [2, 4])
def test_param_pspec_matches_lora_tpu(n):
    """The tp and FSDP axes of every weight of the tiny UNet, text
    encoders (SD's, and SDXL's te2 with its projection) and VAE are
    lora_tpu's: fsdp = n alone, and tp = n without and with fsdp = 2."""
    pytest.importorskip("jax")
    from lora_tpu.parallel import mesh as j_mesh

    models = [(cls, cfg, cls(cfg, device="meta").flat_params())
              for cls, cfg in ((UNet, TINY_UNET), (CLIPTextModel, TINY_TEXT),
                               (CLIPTextModel, TINY_XL_TEXT2),
                               (VAE, TINY_VAE))]
    names = tp_axes = 0
    for fsdp, tp in ((n, 1), (1, n), (2, n)):
        shape = {"dp": 1, "fsdp": fsdp, "tp": tp}
        fake = types.SimpleNamespace(shape=shape)
        mesh = mesh_lib.make_mesh(dp=1, fsdp=fsdp, tp=tp, world=fsdp * tp)
        for _, _, params in models:
            for name, w in params.items():
                shp = tuple(w.shape)
                for use_fsdp, use_tp in ((True, True), (True, False),
                                         (False, True)):
                    want = tuple(j_mesh.param_pspec(
                        name, shp, fake, use_fsdp=use_fsdp, use_tp=use_tp))
                    assert mesh_lib.param_pspec(
                        name, shp, mesh, use_fsdp=use_fsdp,
                        use_tp=use_tp) == want, (name, shape)
                    tp_axes += "tp" in want
                assert mesh_lib.param_pspec(name, shp, mesh) == \
                    (None,) * len(shp)
                names += 1
    assert names > 3 * 500 and tp_axes > 3 * 100


def test_one_rank_group(tmp_path):
    """A group of one rank: no mesh from the trainers' flags, an explicit
    dp = 1 mesh, the host-side helpers as no-ops."""
    with one_rank_group(tmp_path):
        assert mesh_lib.mesh_from_flags(data_parallel=True, fsdp=2) is None
        m = mesh_lib.make_mesh(dp=1)
        assert m.distributed and m.rank == 0 and not m.groups
        mesh_lib.warm_collectives(m)
        mesh_lib.multihost_barrier("x")
        assert mesh_lib.is_main_process()
        assert mesh_lib.PreemptionCoordinator(1).should_stop(True, 0)
        assert not mesh_lib.PreemptionCoordinator().should_stop(False, 0)
        t = torch.ones(3)
        assert m.all_reduce(t) is t and torch.equal(t, torch.ones(3))
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def tiny_base():
    """The port's tiny UNet, text encoder and VAE from fixed seeds (the
    same bits in every process)."""
    return tuple(cls(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(s)).flat_params()
                 for s, (cls, cfg) in enumerate(((UNet, TINY_UNET),
                                                 (CLIPTextModel, TINY_TEXT),
                                                 (VAE, TINY_VAE))))


def step_batch():
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 900, (4, 7)).astype(np.int64)
    ids[:, 2], ids[:, 4] = TI_IDS
    return {"latents": rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
            "input_ids": ids}


def _step(mesh, tree_np, base, draws):
    tree = trainable_from_jax(tree_np)
    step = t_ts.make_train_step(
        unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
        sched=t_sched.make_schedule(), loss_cfg=t_loss.LossConfig(),
        optimizer=t_optim.make_optimizer(tree, LRS),
        ti_ids=torch.from_numpy(TI_IDS).long(), mesh=mesh)
    batch = mesh_lib.shard_batch(
        {k: torch.from_numpy(v) for k, v in step_batch().items()}, mesh)
    losses = [step(tree, base[:2] + ({},), batch,
                   noise=torch.from_numpy(d["noise"]),
                   timesteps=torch.from_numpy(d["timesteps"])).item()
              for d in draws]
    return losses, trainable_to_numpy(tree)


def _parts_loss(mesh, tree, base, batch, rank_rows):
    """loss_step with every global draw and reduction in play, on this
    rank's rows (rank_rows) of `batch`, draws from one seed."""
    cfg = t_loss.LossConfig(cached_latents=False, lora_dropout_p=0.3,
                            with_prior_preservation=True,
                            prior_loss_weight=0.7)
    part = {k: v[rank_rows] for k, v in batch.items()}
    return t_loss.loss_step(
        tree, part, torch.Generator().manual_seed(5), unet_params=base[0],
        text_params=base[1], vae_params=base[2], unet_cfg=TINY_UNET,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE, sched=t_sched.make_schedule(),
        cfg=cfg, mesh=mesh)


def _parts(mesh, tree_np, base) -> dict:
    """The group's mean loss and mean gradients against this process's
    one-process values on the global batch (max relative differences)."""
    rng = np.random.default_rng(4)
    mask = rng.uniform(0.0, 1.0, (4, 64, 64, 1)).astype(np.float32)
    mask[3, 5, 5, 0] = 9.0  # the peak, on the last rank's rows
    batch = {"pixel_values": torch.from_numpy(rng.uniform(
                 -1, 1, (4, 64, 64, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(step_batch()["input_ids"]),
             "mask": torch.from_numpy(mask)}
    out = {}
    for name, m, rows in (("global", None, slice(0, 4)),
                          ("group", mesh, slice(2 * mesh.rank,
                                                2 * mesh.rank + 2))):
        tree = trainable_from_jax(tree_np)
        loss = _parts_loss(m, tree, base, batch, rows)
        loss.backward()
        params = t_optim.tree_leaves(tree)
        if m is not None:
            loss = m.mean_grads(params, loss)
        out[name] = (float(loss), [p.grad.clone() for p in params])
    (lg, gg), (lm, gm) = out["global"], out["group"]
    top = max(float(g.abs().max()) for g in gg)
    return {"loss": lg, "loss_rel": abs(lm - lg) / abs(lg),
            "grad_rel": max(float((a - b).abs().max()) for a, b in
                            zip(gm, gg)) / top}


def worker(argv) -> None:
    torch.set_num_threads(1)
    root = argv[0]
    assert mesh_lib.initialize_distributed_from_env()
    mesh = mesh_lib.make_mesh(dp=2)
    mesh_lib.warm_collectives(mesh)
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        tree_np, draws = pickle.load(f)
    base = tiny_base()
    losses, tree = _step(mesh, tree_np, base, draws)
    parts = _parts(mesh, {"lora_unet": tree_np["lora_unet"]}, base)
    if mesh_lib.is_main_process():
        with open(os.path.join(root, "step.pkl"), "wb") as f:
            pickle.dump((losses, tree), f)
        with open(os.path.join(root, "parts.json"), "w") as f:
            json.dump(parts, f)


def test_two_rank_step_matches_lora_tpu(tmp_path):
    """2 steps with dp = 2 (LoRA on the UNet and the text encoder, TI rows,
    clip 1.0) against lora_tpu's single-device step on the global batch of
    4; and loss_step's global draws and reductions on the two ranks."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lora_tpu.core.sites import text_encoder_lora_sites, unet_lora_sites
    from lora_tpu.models import schedulers as j_sched
    from lora_tpu.training import loss as j_loss
    from lora_tpu.training import optim as j_optim
    from lora_tpu.training import train_step as j_ts
    from test_torch_port_training import jax_draws, random_lora

    tree = {"lora_unet": random_lora(unet_lora_sites(TINY_UNET), 1),
            "lora_text": random_lora(text_encoder_lora_sites(TINY_TEXT), 2),
            "ti": {"embeds": (0.02 * np.random.default_rng(3)
                              .standard_normal((2, TINY_TEXT.hidden_size))
                              ).astype(np.float32)}}
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    draws = [{k: np.array(v) for k, v in jax_draws(
        key, (4, 8, 8, 4), 1000).items() if k in ("noise", "timesteps")}
        for key in keys]
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump((tree, draws), f)
    proc = launch(__file__, [str(tmp_path)], timeout=300)

    base = tiny_base()
    jb = tuple({k: jnp.asarray(v.numpy()) for k, v in p.items()}
               for p in base[:2]) + ({},)
    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    j_opt = j_optim.make_optimizer(j_tree, LRS)
    j_step = j_ts.make_train_step(
        unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE,
        sched=j_sched.make_schedule(), loss_cfg=j_loss.LossConfig(),
        optimizer=j_opt, ti_ids=jnp.asarray(TI_IDS))
    state = j_opt.init(j_tree)
    batch = {k: jnp.asarray(v) for k, v in step_batch().items()}
    j_losses = []
    for key in keys:
        j_tree, state, loss = j_step(j_tree, state, jb, batch, key)
        j_losses.append(float(loss))

    ok(proc)
    with open(tmp_path / "step.pkl", "rb") as f:
        t_losses, t_tree = pickle.load(f)
    np.testing.assert_allclose(t_losses, j_losses, rtol=STEP_RTOL)
    got = dict(jax.tree_util.tree_leaves_with_path(t_tree))
    for path, want in jax.tree_util.tree_leaves_with_path(j_tree):
        np.testing.assert_allclose(got[path], np.asarray(want),
                                   rtol=STEP_RTOL, atol=min(LRS.values()) / 3,
                                   err_msg=jax.tree_util.keystr(path))
    with open(tmp_path / "parts.json") as f:
        parts = json.load(f)
    assert np.isfinite(parts["loss"])
    assert parts["loss_rel"] < PARTS_RTOL and parts["grad_rel"] < 1e-4, parts


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2:])
