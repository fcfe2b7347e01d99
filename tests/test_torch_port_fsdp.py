"""FSDP of the frozen base in the port (parallel/mesh.py ShardedParams) on
two CPU ranks over gloo, through this file
(`python tests/test_torch_port_fsdp.py --worker ROOT`):

  - each rank keeps half of every weight that lora_tpu's param_pspec
    shards, and the UNet forward over the sharded params (each weight
    all-gathered where it is read) gives the unsharded output within
    tests/test_training.py:207-222's 2e-4, with LoRA, and under gradient
    checkpointing (whose recompute gathers again) the same LoRA gradients;
  - train_dreambooth with fsdp=2 (dp = 1: both ranks hold the same rows)
    against one unsharded process, with gradient checkpointing: the same
    losses and LoRA.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lora_tpu_torch.core.lora import init_lora  # noqa: E402
from lora_tpu_torch.core.sites import unet_lora_sites  # noqa: E402
from lora_tpu_torch.models.config import TINY_UNET  # noqa: E402
from lora_tpu_torch.models.unet import UNet, unet_forward  # noqa: E402
from lora_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from lora_tpu_torch.training import dreambooth as t_db  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402
from lora_tpu_torch.training.train_step import make_trainable  # noqa: E402

from test_torch_port_dp import (  # noqa: E402
    DB,
    assert_same_run,
    launch,
    leaves_of,
    load_result,
    ok,
    recording_losses,
    save_result,
    tiny_pipe,
    write_images,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

FWD_RTOL, FWD_ATOL = 2e-4, 1e-5  # tests/test_training.py:220's
TRAIN = dict(DB, cached_latents=True, gradient_checkpointing=True,
             train_text_encoder=True, cache_text_embeddings=False)


def _inputs():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(
                np.float32)),
            torch.tensor([5, 10]),
            torch.from_numpy(rng.standard_normal(
                (2, 7, TINY_UNET.cross_attention_dim)).astype(np.float32)))


def _forward(params, lora, remat):
    """The UNet output and the LoRA's gradients of its sum of squares."""
    for leaf in t_optim.tree_leaves(lora):
        leaf.grad = None
    out = unet_forward(params, *_inputs(), TINY_UNET, lora=lora, remat=remat)
    (out ** 2).sum().backward()
    return out.detach(), [x.grad.clone() for x in t_optim.tree_leaves(lora)]


def forward_check(mesh) -> dict:
    """Max differences of the sharded forward (and backward) from the
    unsharded one on this rank, and the share of the base it keeps."""
    unet = UNet(TINY_UNET, device="cpu",
                generator=torch.Generator().manual_seed(0)).flat_params()
    sharded = mesh_lib.shard_params(unet, mesh, use_fsdp=True)
    lora = init_lora(unet_lora_sites(TINY_UNET), r=2,
                     generator=torch.Generator().manual_seed(1),
                     device="cpu")
    gen = torch.Generator().manual_seed(2)
    for site in lora["sites"].values():  # nonzero up: every grad nonzero
        site["up"].normal_(std=0.05, generator=gen)
    make_trainable({"lora_unet": lora})
    out = {}
    for remat in (False, True):
        want, gw = _forward(unet, lora, remat)
        got, gg = _forward(sharded, lora, remat)
        out[f"remat={remat}"] = {
            "out": float((got - want).abs().max()),
            "out_tol": FWD_ATOL + FWD_RTOL * float(want.abs().max()),
            "grad": max(float((a - b).abs().max()) for a, b in zip(gg, gw)),
            "grad_tol": FWD_ATOL + FWD_RTOL * max(
                float(g.abs().max()) for g in gw)}
    kept = sum(sharded.local(n).numel() for n in sharded)
    out["kept"] = kept / sum(w.numel() for w in unet.values())
    out["sharded"] = sum(sharded.local(n).shape != w.shape
                         for n, w in unet.items())
    out["weights"] = len(unet)
    return out


def run_trainer(root, out, fsdp: bool) -> dict:
    flags = dict(fsdp=2) if fsdp else {}
    cfg = t_db.DreamBoothConfig(**TRAIN, **flags, train_batch_size=2,
                                instance_data_dir=os.path.join(root, "inst"),
                                output_dir=out)
    with recording_losses(t_db) as losses:
        res = t_db.train_dreambooth(tiny_pipe(), cfg)
    return {"losses": losses, "leaves": leaves_of(res["trainable"])}


def worker(argv) -> None:
    torch.set_num_threads(1)
    root = argv[0]
    assert mesh_lib.initialize_distributed_from_env()
    mesh = mesh_lib.make_mesh(dp=1, fsdp=2)
    check = forward_check(mesh)
    with open(os.path.join(root, f"fwd{mesh_lib.rank()}.json"), "w") as f:
        json.dump(check, f)
    res = run_trainer(root, os.path.join(root, "fsdp"), fsdp=True)
    if mesh_lib.is_main_process():
        save_result(os.path.join(root, "fsdp.npz"), res)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fsdp"))
    write_images(os.path.join(root, "inst"), 2, 0)
    ok(launch(__file__, [root], timeout=300))
    return root


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_unet_forward(run, rank):
    with open(os.path.join(run, f"fwd{rank}.json")) as f:
        check = json.load(f)
    for remat in ("remat=False", "remat=True"):
        c = check[remat]
        assert c["out"] <= c["out_tol"] and c["grad"] <= c["grad_tol"], c
    # every sharded weight halves; the unsharded ones (odd or 1-long axes)
    # are few and small
    assert check["sharded"] > 0.9 * check["weights"]
    assert 0.5 <= check["kept"] < 0.51


def test_fsdp_trainer_matches_unsharded(run, tmp_path):
    got = load_result(os.path.join(run, "fsdp.npz"))
    want = run_trainer(run, str(tmp_path / "ref"), fsdp=False)
    assert_same_run(got, want, "fsdp=2")
    assert sorted(os.listdir(os.path.join(run, "fsdp"))) == sorted(
        os.listdir(tmp_path / "ref"))


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2:])
