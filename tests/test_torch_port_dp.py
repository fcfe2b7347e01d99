"""Data-parallel training in the port across real processes: two CPU ranks
over gloo, started by lora_launch_torch --cpu, against one process at the
same global batch (train_batch_size 1 x dp 2 against train_batch_size 2).
lora_tpu's contract (docs/multihost.md): the group's run is one process's
run at the global batch, because every rank draws the same sample stream
and the global batch's random draws and keeps its own rows.

Cases of train_dreambooth: cached latents with prior preservation (the
cached loader gives rank 0 only instance rows and rank 1 only class rows,
so the prior term needs the global counts; rank 0 generates the class
images while rank 1 waits at the barrier), uncached with the text encoder,
gradient accumulation under a global-norm clip that binds, the blockwise
int8 Adam, and a tiny SDXL pipe; and train_pti with TI rows, the face
masks' masked loss and gradient accumulation. Checked: every micro-step's
loss within 1e-5 relative, the final trainable leaves within 1e-4 of their
largest entry, and the output directory written by rank 0 alone.

The ranks run in one group, every case in turn, through this file itself
(`python tests/test_torch_port_dp.py --worker ROOT CASE...`); the
references run in the test process.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lora_tpu_torch.data.png import _png_bytes  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_TEXT,
    TINY_UNET,
    TINY_VAE,
    TINY_XL_TEXT,
    TINY_XL_TEXT2,
    TINY_XL_UNET,
)
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import (  # noqa: E402
    StableDiffusionXLPipeline,
)
from lora_tpu_torch.training import dreambooth as t_db  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402
from lora_tpu_torch.training import pti as t_pti  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
LOSS_RTOL = 1e-5
TREE_TOL = 1e-4  # of the largest entry
DB = dict(resolution=SIZE, lora_rank=2, max_train_steps=3, save_steps=2,
          seed=0, instance_prompt="a photo of sks dog", learning_rate=1e-3,
          learning_rate_text=5e-4)
PTI = dict(resolution=SIZE, lora_rank=2, max_train_steps_ti=2,
           max_train_steps_tuning=2, gradient_accumulation_steps=2,
           save_steps=100, seed=0, placeholder_tokens="<s1>|<s2>",
           use_template="object", train_text_encoder=True,
           color_jitter=False, use_face_segmentation_condition=True,
           learning_rate_ti=5e-3, learning_rate_unet=1e-3)
CASES = {
    "cached_prior": dict(cached_latents=True, with_prior_preservation=True,
                         class_prompt="a photo of a dog",
                         num_class_images=2, sample_steps=2),
    "uncached_text": dict(train_text_encoder=True),
    "accum_clip": dict(gradient_accumulation_steps=2, max_grad_norm=1e-3,
                       cached_latents=True),
    "adam8bit": dict(use_8bit_adam=True, cached_latents=True,
                     train_text_encoder=True),
    "sdxl": dict(output_format="safe", max_train_steps=2, save_steps=0),
    "pti": None,
}


def launch(script: str, args, nproc: int = 2, timeout: float = 240,
           env=None, launcher_args=()) -> subprocess.CompletedProcess:
    """`lora_launch_torch --cpu --nproc N -- python SCRIPT --worker ARGS`
    from the repo root, one thread per rank."""
    cmd = [sys.executable, "-m", "lora_tpu_torch.launch", "--cpu",
           "--nproc", str(nproc), *launcher_args, "--", sys.executable,
           script, "--worker", *args]
    return subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
             **(env or {})})


def ok(proc: subprocess.CompletedProcess) -> str:
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-4000:]
    return proc.stdout


@contextlib.contextmanager
def recording_losses(module):
    """Each micro-step's loss of the trainer module's steps."""
    real = module.make_train_step
    losses = []

    def make_train_step(**kw):
        step = real(**kw)

        def recorded(*a, **k):
            loss = step(*a, **k)
            losses.append(float(loss))
            return loss

        return recorded

    module.make_train_step = make_train_step
    try:
        yield losses
    finally:
        module.make_train_step = real


def write_images(d, n, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        with open(os.path.join(d, f"img_{i}.png"), "wb") as f:
            f.write(_png_bytes(rng.integers(0, 255, (SIZE, SIZE, 3),
                                            dtype=np.uint8)))
    return d


def tiny_pipe(xl: bool = False):
    gen = torch.Generator().manual_seed(0)
    if xl:
        return StableDiffusionXLPipeline.random_init(
            gen, "cpu", unet_cfg=TINY_XL_UNET, text_cfg=TINY_XL_TEXT,
            text2_cfg=TINY_XL_TEXT2, vae_cfg=TINY_VAE)
    return StableDiffusionPipeline.random_init(
        gen, "cpu", unet_cfg=TINY_UNET, text_cfg=TINY_TEXT,
        vae_cfg=TINY_VAE)


def leaves_of(trainable) -> list:
    return [x.detach().numpy().copy()
            for x in t_optim.tree_leaves(trainable)]


def run_case(case: str, root: str, out: str, parallel: bool) -> dict:
    """One trainer run of `case` at global batch 2 into `out`: two ranks
    with data_parallel (train_batch_size 1 each) or one process
    (train_batch_size 2). Returns the losses and the trainable leaves."""
    inst = os.path.join(root, "inst")
    flags = dict(data_parallel=True, train_batch_size=1) if parallel \
        else dict(train_batch_size=2)
    if case == "pti":
        module = t_pti
        cfg = t_pti.PTIConfig(**PTI, **flags, instance_data_dir=inst,
                              output_dir=out)
        with recording_losses(t_pti) as losses:
            res = t_pti.train_pti(tiny_pipe(), cfg)
    else:
        module = t_db
        extra = dict(CASES[case])
        if extra.get("with_prior_preservation"):
            extra["class_data_dir"] = os.path.join(out, "class")
        cfg = t_db.DreamBoothConfig(**{**DB, **extra, **flags},
                                    instance_data_dir=inst, output_dir=out)
        with recording_losses(module) as losses:
            res = t_db.train_dreambooth(tiny_pipe(case == "sdxl"), cfg)
    return {"losses": losses, "leaves": leaves_of(res["trainable"])}


def save_result(path: str, result: dict) -> None:
    np.savez(path, losses=np.asarray(result["losses"]),
             **{f"leaf{i}": x for i, x in enumerate(result["leaves"])})


def load_result(path: str) -> dict:
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("leaf")])
        return {"losses": list(z["losses"]),
                "leaves": [z[f"leaf{i}"] for i in range(n)]}


def assert_same_run(got: dict, want: dict, what: str,
                    int8_lr: float = 0.0) -> None:
    """Losses within LOSS_RTOL and leaves within TREE_TOL of the largest
    entry. int8_lr: the blockwise-int8 Adam's learning rate. Its moments
    round to 1/127 of their block's peak, so a gradient that differs in
    its last bits can move one code by one step and that entry's update by
    up to lr: such entries (at most 1% of each leaf) are held to lr."""
    assert len(got["losses"]) == len(want["losses"]) > 0, what
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, err_msg=what)
    assert len(got["leaves"]) == len(want["leaves"]), what
    top = max(float(np.abs(w).max()) for w in want["leaves"])
    for i, (g, w) in enumerate(zip(got["leaves"], want["leaves"])):
        off = np.abs(g - w) > TREE_TOL * top
        if int8_lr:
            assert off.mean() <= 0.01, f"{what} leaf {i}: {off.sum()} off"
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=max(TREE_TOL * top, int8_lr),
                                       err_msg=f"{what} leaf {i}")
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=TREE_TOL * top,
                                   err_msg=f"{what} leaf {i}")


def worker(argv) -> None:
    """A rank: join the launcher's group, run each case with
    data_parallel, rank 0 saves ROOT/CASE.npz."""
    from lora_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    root, cases = argv[0], argv[1:]
    assert mesh_lib.initialize_distributed_from_env()
    for case in cases:
        res = run_case(case, root, os.path.join(root, case), parallel=True)
        if mesh_lib.is_main_process():
            save_result(os.path.join(root, case + ".npz"), res)
        print(f"CASE {case} rank {mesh_lib.rank()} "
              f"{json.dumps(res['losses'])}", flush=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank runs of every case, in one group."""
    root = str(tmp_path_factory.mktemp("dp"))
    write_images(os.path.join(root, "inst"), 2, 0)
    out = ok(launch(__file__, [root, *CASES], timeout=400))
    return root, out


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_train_the_global_batch(runs, case, tmp_path):
    root, out = runs
    got = load_result(os.path.join(root, case + ".npz"))
    want = run_case(case, root, str(tmp_path / "ref"), parallel=False)
    assert_same_run(got, want, case, int8_lr=DB["learning_rate"]
                    if case == "adam8bit" else 0.0)
    # both ranks ran every micro-step; rank 0 alone wrote the directory,
    # which holds what the one-process run wrote, and one metrics line per
    # logged step
    lines = [ln for ln in out.splitlines() if f"CASE {case} rank" in ln]
    assert sorted(ln.split(" rank ")[1].split()[0] for ln in lines) == [
        "0", "1"], lines
    ref_files = sorted(f for f in os.listdir(tmp_path / "ref")
                       if f != "class")
    dp_files = sorted(f for f in os.listdir(os.path.join(root, case))
                      if f != "class")
    assert dp_files == ref_files
    with open(os.path.join(root, case, "metrics.jsonl")) as f:
        dp_metrics = [json.loads(ln) for ln in f]
    with open(tmp_path / "ref" / "metrics.jsonl") as f:
        ref_metrics = [json.loads(ln) for ln in f]
    assert [sorted(m) for m in dp_metrics] == [sorted(m) for m in
                                               ref_metrics]


def test_class_images_made_once(runs):
    """Rank 0 generated the class images; rank 1 waited at the barrier and
    trained on the same files."""
    root, out = runs
    cls = os.path.join(root, "cached_prior", "class")
    assert sorted(os.listdir(cls)) == ["gen_0.png", "gen_1.png"]
    assert out.count("Generating 2 class images") == 1


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2:])
