"""Tensor parallelism in the port (parallel/tensor.py, the tp blocks of
parallel/mesh.py ShardedParams) on CPU ranks over gloo, started by
lora_launch_torch --cpu through this file
(`python tests/test_torch_port_tp.py --worker ROOT MODE`), against one
process; one process is itself held to lora_tpu by the other files.

  - two ranks, tp = 2: the tiny UNet's output and LoRA gradients (LoRA
    dropout on), with and without gradient checkpointing, and its output
    with two stacked adapters and on an int8 base; a UNet whose
    first level has one head, so that its attention blocks read their
    weights whole (the gather path); the CLIP text forward; vae_encode
    (its one-head attention gathers); and the loss and gradients of an
    uncached step against lora_tpu's single-device jax.grad;
  - two ranks, train_dreambooth with tensor_parallel = 2 at the same
    global batch: cached with prior preservation, uncached with the text
    encoder, tiny SDXL with both text encoders; train_pti with face masks,
    and with LoRA dropout p = 0.1 (exact: each rank draws the full-width
    mask and keeps its features);
  - four ranks: dp 2 x tp 2, and fsdp 2 x tp 2 under gradient
    checkpointing;
  - `lora_db --tensor_parallel 2` under the launcher writes the LoRA file
    of one process.

The three launches run while the test process computes the references.
Tolerances: test_torch_port_dp.py's (losses within 1e-5 relative, every
leaf within 1e-4 of the largest entry); the forwards within
tests/test_training.py:220's 2e-4; against lora_tpu,
test_torch_port_training.py's.
"""

import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lora_tpu_torch.cli import _fire, lora_db  # noqa: E402
from lora_tpu_torch.convert import trainable_from_jax  # noqa: E402
from lora_tpu_torch.core.lora import (  # noqa: E402
    init_lora,
    stack_loras,
    with_lora_idx,
)
from lora_tpu_torch.core.quantize import quantize_params_int8  # noqa: E402
from lora_tpu_torch.core.sites import (  # noqa: E402
    text_encoder_lora_sites,
    unet_lora_sites,
)
from lora_tpu_torch.formats.reader import load_file  # noqa: E402
from lora_tpu_torch.models import schedulers as t_sched  # noqa: E402
from lora_tpu_torch.models.clip import (  # noqa: E402
    CLIPTextModel,
    clip_text_forward,
)
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_TEXT,
    TINY_UNET,
    TINY_VAE,
)
from lora_tpu_torch.models.hf_import import save_pipeline_params  # noqa: E402
from lora_tpu_torch.models.unet import UNet, unet_forward  # noqa: E402
from lora_tpu_torch.models.vae import VAE, vae_encode  # noqa: E402
from lora_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from lora_tpu_torch.parallel import tensor as tp_lib  # noqa: E402
from lora_tpu_torch.training import dreambooth as t_db  # noqa: E402
from lora_tpu_torch.training import loss as t_loss  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402
from lora_tpu_torch.training import pti as t_pti  # noqa: E402
from lora_tpu_torch.training.train_step import make_trainable  # noqa: E402

from test_torch_port_dp import (  # noqa: E402
    CASES as DP_CASES,
    DB,
    PTI,
    REPO,
    assert_same_run,
    leaves_of,
    load_result,
    recording_losses,
    save_result,
    tiny_pipe,
    write_images,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

FWD_RTOL, FWD_ATOL = 2e-4, 1e-5  # tests/test_training.py:220's
# test_torch_port_quantize.py's floor for the tiny int8 UNet (of max|out|)
UNET_KERNEL_MAX_REL, UNET_KERNEL_MEAN_REL = 2e-3, 3e-4
TI_IDS = np.array([998, 999], np.int32)
ONE_HEAD = dataclasses.replace(TINY_UNET, num_attention_heads=(1, 2, 2, 2))
# (trainer, its flags) of each case; every run is at global batch 2
TRAINERS = {
    "cached_prior": ("db", DP_CASES["cached_prior"]),
    "uncached_text": ("db", DP_CASES["uncached_text"]),
    "sdxl": ("xl", dict(DP_CASES["sdxl"], train_text_encoder=True)),
    "pti_masks": ("pti", {}),
    "pti_dropout": ("pti", dict(lora_dropout_p=0.1)),
    "fsdp_ckpt": ("db", dict(cached_latents=True, train_text_encoder=True,
                             gradient_checkpointing=True,
                             cache_text_embeddings=False)),
}
TWO_RANKS = ("cached_prior", "uncached_text", "sdxl", "pti_masks",
             "pti_dropout")
# four ranks: case -> (its mesh flags, the case whose one-process run it
# matches)
FOUR_RANKS = {
    "dp_tp": (dict(data_parallel=True, tensor_parallel=2,
                   train_batch_size=1), "uncached_text"),
    "fsdp_tp": (dict(fsdp=2, tensor_parallel=2, train_batch_size=2),
                "fsdp_ckpt"),
}
CLI_FLAGS = ["--instance_prompt", "a photo of sks dog", "--resolution", "64",
             "--lora_rank", "2", "--max_train_steps", "2", "--save_steps",
             "0", "--train_text_encoder", "--seed", "0",
             "--train_batch_size", "2", "--device", "cpu"]
ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
       "LORA_TPU_ALLOW_HASHED_TOKENIZER": "1"}


@contextlib.contextmanager
def counting_splits():
    """How many blocks over tp-sharded params ran split and how many read
    their weights whole, while the block runs."""
    real = tp_lib.split_block
    counts = {"split": 0, "whole": 0}

    def counted(p, names, heads=None):
        mesh = real(p, names, heads)
        if isinstance(p, mesh_lib.ShardedParams) and p.mesh.shape["tp"] > 1:
            counts["split" if mesh is not None else "whole"] += 1
        return mesh

    tp_lib.split_block = counted
    try:
        yield counts
    finally:
        tp_lib.split_block = real


# ---------------------------------------------------------------------------
# the forwards, on two ranks
# ---------------------------------------------------------------------------

def _lora(sites, seed):
    """A rank-2 LoRA with nonzero up (every gradient nonzero), trainable."""
    lora = init_lora(sites, r=2, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 100)
    for site in lora["sites"].values():
        site["up"].normal_(std=0.05, generator=gen)
    make_trainable({"lora": lora})
    return lora


def _compare(run, whole, sharded, mesh, lora) -> dict:
    """run(params) on the whole params and on the tp-sharded ones: the
    outputs' and the LoRA gradients' largest differences (the split
    parts summed over tp) beside their tolerances, and the blocks that
    ran split or whole."""
    leaves = t_optim.tree_leaves(lora)
    res = []
    for p in (whole, sharded):
        for x in leaves:
            x.grad = None
        with counting_splits() as counts:
            out = run(p)
            (out.float() ** 2).sum().backward()
        tp_lib.sum_split_grads(leaves, mesh)
        res.append((out.detach(), [x.grad.clone() for x in leaves]))
    (want, gw), (got, gg) = res
    return {"out": float((got - want).abs().max()),
            "out_tol": FWD_ATOL + FWD_RTOL * float(want.abs().max()),
            "grad": max(float((a - b).abs().max()) for a, b in zip(gg, gw)),
            "grad_tol": FWD_ATOL + FWD_RTOL * max(float(g.abs().max())
                                                  for g in gw),
            **counts}


def _serving_trees(unet, mesh, lat, t, ctx) -> dict:
    """Serving's trees under tp: two stacked adapters routed per row (on
    the float base), and an int8 base (the block's codes, the scales cut
    to its rows). Each output's largest and mean difference relative to
    the whole params' largest entry, and the split counts."""
    loras = [init_lora(unet_lora_sites(TINY_UNET), r=2,
                       generator=torch.Generator().manual_seed(s),
                       device="cpu") for s in (5, 6)]
    gen = torch.Generator().manual_seed(7)
    for lora in loras:
        for site in lora["sites"].values():
            site["up"].normal_(std=0.05, generator=gen)
    stacked = with_lora_idx(stack_loras(loras), [0, 1])
    out = {}
    for name, params, lora in (("stacked", unet, stacked),
                               ("int8", quantize_params_int8(unet), None)):
        with torch.no_grad(), counting_splits() as counts:
            want = unet_forward(params, lat, t, ctx, TINY_UNET, lora=lora)
            got = unet_forward(mesh_lib.shard_params(params, mesh,
                                                     use_tp=True),
                               lat, t, ctx, TINY_UNET, lora=lora)
        rel = (got - want).abs() / want.abs().max()
        out[name] = {"max_rel": float(rel.max()),
                     "mean_rel": float(rel.mean()), **counts}
    return out


def forward_checks(mesh) -> dict:
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(
        np.float32))
    ctx = torch.from_numpy(rng.standard_normal(
        (2, 7, TINY_UNET.cross_attention_dim)).astype(np.float32))
    t = torch.tensor([5, 10])
    out = {}
    for name, cfg in (("unet", TINY_UNET), ("one_head", ONE_HEAD)):
        whole = UNet(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0)
                     ).flat_params()
        sharded = mesh_lib.shard_params(whole, mesh, use_tp=True)
        lora = _lora(unet_lora_sites(cfg), 1)
        for remat in (False, True):
            out[f"{name} remat={remat}"] = _compare(
                lambda p: unet_forward(p, lat, t, ctx, cfg, lora=dict(
                    lora, dropout_p=0.1, rng=3), remat=remat),
                whole, sharded, mesh, lora)
        if name == "unet":
            out["unet kept"] = sum(sharded.local(n).numel()
                                   for n in sharded) / sum(
                w.numel() for w in whole.values())
            out.update(_serving_trees(whole, mesh, lat, t, ctx))
    text = CLIPTextModel(TINY_TEXT, device="cpu",
                         generator=torch.Generator().manual_seed(1)
                         ).flat_params()
    ids = torch.from_numpy(rng.integers(0, 900, (2, 7)))
    lora = _lora(text_encoder_lora_sites(TINY_TEXT), 2)
    out["text"] = _compare(
        lambda p: clip_text_forward(p, ids, TINY_TEXT, lora=dict(
            lora, dropout_p=0.1, rng=4)),
        text, mesh_lib.shard_params(text, mesh, use_tp=True), mesh, lora)
    vae = VAE(TINY_VAE, device="cpu",
              generator=torch.Generator().manual_seed(2)).flat_params()
    vae_tp = mesh_lib.shard_params(vae, mesh, use_tp=True)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32))
    want = vae_encode(vae, x, TINY_VAE, sample=False)
    got = vae_encode(vae_tp, x, TINY_VAE, sample=False)
    attn = "encoder.mid_block.attentions.0.to_q.weight"
    out["vae"] = {"out": float((got - want).abs().max()),
                  "attn_local": list(vae_tp.local(attn).shape),
                  "attn": list(vae[attn].shape)}
    return out


def tiny_base():
    return tuple(cls(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(s)).flat_params()
                 for s, (cls, cfg) in enumerate(((UNet, TINY_UNET),
                                                 (CLIPTextModel, TINY_TEXT),
                                                 (VAE, TINY_VAE))))


def _grads(tree):
    if isinstance(tree, torch.Tensor):
        return tree.grad.numpy().copy()
    return {k: _grads(v) for k, v in tree.items()}


def jax_step_check(mesh, root) -> None:
    """The uncached loss on the tp-sharded base with lora_tpu's draws
    handed in: its value and the trainable leaves' gradients (rank 0
    writes them)."""
    with open(os.path.join(root, "jax_inputs.pkl"), "rb") as f:
        tree_np, batch, draws = pickle.load(f)
    base = tuple(mesh_lib.shard_params(p, mesh, use_tp=True)
                 for p in tiny_base())
    tree = trainable_from_jax(tree_np)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch["input_ids"] = t_batch["input_ids"].long()
    loss = t_loss.loss_step(
        tree, t_batch, None, unet_params=base[0], text_params=base[1],
        vae_params=base[2], unet_cfg=TINY_UNET, text_cfg=TINY_TEXT,
        vae_cfg=TINY_VAE, sched=t_sched.make_schedule(),
        cfg=t_loss.LossConfig(cached_latents=False),
        ti_ids=torch.from_numpy(TI_IDS).long(),
        **{k: torch.from_numpy(v) for k, v in draws.items()})
    loss.backward()
    tp_lib.sum_split_grads(t_optim.tree_leaves(tree), mesh)
    if mesh_lib.is_main_process():
        with open(os.path.join(root, "jax_step.pkl"), "wb") as f:
            pickle.dump((float(loss), _grads(tree)), f)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def run_trainer(case: str, root: str, out: str, flags: dict):
    """One trainer run of `case` into `out` with the mesh flags (or one
    process): its losses and final leaves, and the blocks that ran split
    or whole over tp-sharded params."""
    kind, extra = TRAINERS[case]
    inst = os.path.join(root, "inst")
    with counting_splits() as counts:
        if kind == "pti":
            cfg = t_pti.PTIConfig(**{**PTI, **extra, **flags},
                                  instance_data_dir=inst, output_dir=out)
            with recording_losses(t_pti) as losses:
                res = t_pti.train_pti(tiny_pipe(), cfg)
        else:
            extra = dict(extra)
            if extra.get("with_prior_preservation"):
                extra["class_data_dir"] = os.path.join(out, "class")
            cfg = t_db.DreamBoothConfig(**{**DB, **extra, **flags},
                                        instance_data_dir=inst,
                                        output_dir=out)
            with recording_losses(t_db) as losses:
                res = t_db.train_dreambooth(tiny_pipe(kind == "xl"), cfg)
    return {"losses": losses, "leaves": leaves_of(res["trainable"])}, counts


def _worker_runs(root: str, runs) -> None:
    """Each run (name, trainer case, mesh flags) into root/name: rank 0
    writes the losses and leaves, every rank its losses and split
    counts."""
    rank = mesh_lib.rank()
    for name, case, flags in runs:
        res, counts = run_trainer(case, root, os.path.join(root, name),
                                  flags)
        with open(os.path.join(root, f"{name}.rank{rank}.json"), "w") as f:
            json.dump({"losses": res["losses"], **counts}, f)
        if mesh_lib.is_main_process():
            save_result(os.path.join(root, f"{name}.npz"), res)


def worker(argv) -> None:
    torch.set_num_threads(1)
    root, mode = argv
    assert mesh_lib.initialize_distributed_from_env()
    if mode == "two":
        mesh = mesh_lib.make_mesh(dp=1, tp=2)
        mesh_lib.warm_collectives(mesh)
        checks = forward_checks(mesh)
        with open(os.path.join(root, f"fwd{mesh_lib.rank()}.json"),
                  "w") as f:
            json.dump(checks, f)
        jax_step_check(mesh, root)
        _worker_runs(root, [(c, c, dict(tensor_parallel=2,
                                        train_batch_size=2))
                            for c in TWO_RANKS])
    else:
        _worker_runs(root, [(name, case, flags) for name, (flags, case) in
                            FOUR_RANKS.items()])
    mesh_lib.finalize_distributed()


def _popen(cmd, log):
    return subprocess.Popen(cmd, cwd=REPO, env=ENV, text=True,
                            stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The three launches, started together: two ranks (the forwards and
    the two-rank trainer cases), four ranks, and the CLI on two ranks.
    Returns (root, wait), wait(name) -> the launch's output, asserting
    that it exited 0."""
    from test_torch_port_training import jax_draws, random_lora

    import jax

    root = str(tmp_path_factory.mktemp("tp"))
    write_images(os.path.join(root, "inst"), 2, 0)
    tree = {"lora_unet": random_lora(unet_lora_sites(TINY_UNET), 1),
            "lora_text": random_lora(text_encoder_lora_sites(TINY_TEXT), 2),
            "ti": {"embeds": (0.02 * np.random.default_rng(3)
                              .standard_normal((2, TINY_TEXT.hidden_size))
                              ).astype(np.float32)}}
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 900, (2, 7)).astype(np.int32)
    ids[:, 1], ids[:, 3] = TI_IDS
    batch = {"pixel_values": rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32), "input_ids": ids}
    draws = jax_draws(jax.random.PRNGKey(21), (2, 8, 8, 4), 1000)
    with open(os.path.join(root, "jax_inputs.pkl"), "wb") as f:
        pickle.dump((tree, batch, draws), f)
    model = os.path.join(root, "model")
    save_pipeline_params(tiny_pipe(), model)
    launcher = [sys.executable, "-m", "lora_tpu_torch.launch", "--cpu",
                "--nproc"]
    procs = {}
    for name, nproc, tail in (
            ("two", 2, [__file__, "--worker", root, "two"]),
            ("four", 4, [__file__, "--worker", os.path.join(root, "four"),
                         "four"]),
            ("cli", 2, ["-m", "lora_tpu_torch.cli.lora_db",
                        "--pretrained_model_name_or_path", model,
                        "--instance_data_dir", os.path.join(root, "inst"),
                        "--output_dir", os.path.join(root, "cli"),
                        *CLI_FLAGS, "--tensor_parallel", "2"])):
        if name == "four":
            os.makedirs(os.path.join(root, "four", "inst"))
            write_images(os.path.join(root, "four", "inst"), 2, 0)
        log = open(os.path.join(root, f"{name}.log"), "w")
        procs[name] = (_popen(launcher + [str(nproc), "--",
                                          sys.executable] + tail, log), log)

    def wait(name: str) -> str:
        proc, log = procs[name]
        try:
            proc.wait(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        with open(os.path.join(root, f"{name}.log")) as f:
            text = f.read()
        assert proc.returncode == 0, text[-8000:]
        return text

    yield root, wait
    for name in procs:
        if procs[name][0].poll() is None:
            procs[name][0].kill()
            procs[name][0].wait()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_tp_blocks_of_lora_tpu_rules():
    """Each rank's blocks: the rules' axes halve where tp divides them, the
    GEGLU rows pair each value block with its gate block, and a read gives
    the whole weight back; a block splits only when every weight of it is
    sharded and tp divides its heads."""
    mesh = mesh_lib.make_mesh(dp=1, tp=2, world=2)
    w = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    params = {"b.ff.net.0.proj.weight": w, "b.attn1.to_q.weight": w,
              "b.attn1.to_out.0.weight": w.T.contiguous(),
              "b.attn1.to_k.weight": torch.zeros(3, 3)}
    sh = mesh_lib.ShardedParams(params, mesh, use_fsdp=False, use_tp=True)
    # rank 0: value rows 0-1 and gate rows 4-5 of the [value; gate] rows
    assert sh.tp_index("b.ff.net.0.proj.weight").tolist() == [0, 1, 4, 5]
    assert torch.equal(sh.block("b.ff.net.0.proj.weight"), w[[0, 1, 4, 5]])
    assert torch.equal(sh.block("b.attn1.to_q.weight"), w[:4])
    assert torch.equal(sh.block("b.attn1.to_out.0.weight"), w.T[:, :4])
    assert sh.block("b.attn1.to_k.weight").shape == (3, 3)  # 3 % 2: whole
    assert not sh.tp_split(["b.attn1.to_q.weight", "b.attn1.to_k.weight"])
    assert sh.tp_split(["b.attn1.to_q.weight", "b.attn1.to_out.0.weight"])


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_forwards(launches, rank):
    root, wait = launches
    wait("two")
    with open(os.path.join(root, f"fwd{rank}.json")) as f:
        check = json.load(f)
    for key in ("unet remat=False", "unet remat=True", "one_head remat=False",
                "one_head remat=True", "text"):
        c = check[key]
        assert c["out"] <= c["out_tol"] and c["grad"] <= c["grad_tol"], (
            key, c)
    # serving's trees: stacked adapters as exactly as the forwards; an int8
    # base at test_torch_port_quantize.py's floor (every int8 dense rounds
    # its input to bf16, so the tp sums' last bits flip some roundings)
    assert check["stacked"]["max_rel"] <= FWD_RTOL, check["stacked"]
    assert check["int8"]["max_rel"] < UNET_KERNEL_MAX_REL and \
        check["int8"]["mean_rel"] < UNET_KERNEL_MEAN_REL, check["int8"]
    for tree in ("stacked", "int8"):
        assert (check[tree]["split"], check[tree]["whole"]) == (48, 0)
    # every attention and FF block of the tiny UNet splits (16
    # transformers, 3 blocks each; the recompute runs them again); with
    # one head at the first level its 5 transformers' attentions gather
    assert (check["unet remat=False"]["split"],
            check["unet remat=False"]["whole"]) == (48, 0)
    assert check["unet remat=True"]["split"] == 96
    assert (check["one_head remat=False"]["split"],
            check["one_head remat=False"]["whole"]) == (38, 10)
    assert (check["text"]["split"], check["text"]["whole"]) == (4, 0)
    assert 0.5 < check["unet kept"] < 0.9
    # the VAE's one-head attention is sharded and reads its weights whole
    assert check["vae"]["attn_local"][0] * 2 == check["vae"]["attn"][0]
    assert check["vae"]["out"] == 0.0, check["vae"]


def test_two_rank_step_matches_lora_tpu(launches):
    """The uncached loss and the gradients of the UNet LoRA, the text
    LoRA and the TI rows under tp = 2 against lora_tpu's single-device
    jax.value_and_grad."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from lora_tpu.models import schedulers as j_sched
    from lora_tpu.training import loss as j_loss
    from test_torch_port_training import LOSS_RTOL, _assert_grads_close

    root, wait = launches
    with open(os.path.join(root, "jax_inputs.pkl"), "rb") as f:
        tree, batch, _ = pickle.load(f)
    jb = tuple({k: jnp.asarray(v.numpy()) for k, v in p.items()}
               for p in tiny_base())
    rng = jax.random.PRNGKey(21)

    def f(t, base, b):
        return j_loss.loss_step(
            t, b, rng, unet_params=base[0], text_params=base[1],
            vae_params=base[2], unet_cfg=TINY_UNET, text_cfg=TINY_TEXT,
            vae_cfg=TINY_VAE, sched=j_sched.make_schedule(),
            cfg=j_loss.LossConfig(cached_latents=False),
            ti_ids=jnp.asarray(TI_IDS))

    j_val, j_grads = jax.jit(jax.value_and_grad(f))(
        jax.tree_util.tree_map(jnp.asarray, tree), jb,
        {k: jnp.asarray(v) for k, v in batch.items()})
    wait("two")
    with open(os.path.join(root, "jax_step.pkl"), "rb") as f:
        loss, grads = pickle.load(f)
    np.testing.assert_allclose(loss, float(j_val), rtol=LOSS_RTOL)
    for group in tree:
        _assert_grads_close(grads[group], j_grads[group], where=group)


@pytest.fixture(scope="module")
def refs(launches, tmp_path_factory):
    """One process at global batch 2, for every trainer case: (its losses
    and leaves, the split counts, the files it wrote)."""
    root, out = launches[0], str(tmp_path_factory.mktemp("ref"))
    res = {}
    for case in TRAINERS:
        run, counts = run_trainer(case, root, os.path.join(out, case),
                                  dict(train_batch_size=2))
        res[case] = (run, counts, sorted(os.listdir(os.path.join(out,
                                                                 case))))
    return res


def _check_case(root, case, nproc, want, what):
    run, counts, files = want
    assert_same_run(load_result(os.path.join(root, f"{case}.npz")), run,
                    what)
    ranks = []
    for r in range(nproc):
        with open(os.path.join(root, f"{case}.rank{r}.json")) as f:
            ranks.append(json.load(f))
    # every rank returns the global loss, and the path split
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks), what
    assert all(r["split"] > 0 for r in ranks), (what, ranks)
    assert counts == {"split": 0, "whole": 0}
    # rank 0 alone wrote the one process's files
    assert sorted(os.listdir(os.path.join(root, case))) == files, what


@pytest.mark.parametrize("case", TWO_RANKS)
def test_two_rank_trainer_matches_one_process(launches, refs, case):
    root, wait = launches
    wait("two")
    _check_case(root, case, 2, refs[case], f"tp=2 {case}")


@pytest.mark.parametrize("case", list(FOUR_RANKS))
def test_four_rank_trainer_matches_one_process(launches, refs, case):
    root, wait = launches
    wait("four")
    _check_case(os.path.join(root, "four"), case, 4,
                refs[FOUR_RANKS[case][1]], case)


def test_lora_db_cli_tensor_parallel(launches, tmp_path, monkeypatch):
    """lora_db --tensor_parallel 2 on two ranks writes the LoRA file of
    one process (rank 0 alone writing)."""
    root, wait = launches
    monkeypatch.setenv("LORA_TPU_ALLOW_HASHED_TOKENIZER", "1")
    _fire.fire(lora_db.train, [
        "--pretrained_model_name_or_path", os.path.join(root, "model"),
        "--instance_data_dir", os.path.join(root, "inst"), "--output_dir",
        str(tmp_path / "ref"), *CLI_FLAGS])
    log = wait("cli")
    assert "[p0] lora_tpu_torch: joined a process group: backend=gloo " \
        "world_size=2" in log
    assert sorted(os.listdir(os.path.join(root, "cli"))) == sorted(
        os.listdir(tmp_path / "ref"))
    got, _ = load_file(os.path.join(root, "cli", "lora_weight.safetensors"))
    want, _ = load_file(str(tmp_path / "ref" / "lora_weight.safetensors"))
    assert sorted(got) == sorted(want) and want
    top = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * top,
                                   err_msg=k)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2:])
