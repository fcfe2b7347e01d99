"""The port's PTI and legacy TI command lines
(lora_tpu_torch/cli/lora_pti.py, cli/lora_ti.py): --help, a 1+1-step
lora_pti run and a 2-step lora_ti run on the CPU through `python -m` on a
tiny diffusers directory written by models/hf_import.save_pipeline_params,
and the card as the default device."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lora_tpu_torch.cli import lora_pti, lora_ti  # noqa: E402
from lora_tpu_torch.data.png import _png_bytes  # noqa: E402
from lora_tpu_torch.formats.reader import load_file  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_TEXT,
    TINY_UNET,
    TINY_VAE,
)
from lora_tpu_torch.models.hf_import import save_pipeline_params  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny directory has no CLIP vocabulary: from_pretrained needs the
# opt-in to the hashed tokenizer (data/tokenizer.py)
# one intra-op thread in the CLI's process: the tiny steps gain nothing
# from more, which oversubscribe the cores beside the other test workers
ENV = dict(os.environ, LORA_TPU_ALLOW_HASHED_TOKENIZER="1",
           OMP_NUM_THREADS="1",
           PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_UNET,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)
    save_pipeline_params(pipe, str(d / "model"))
    (d / "inst").mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(64, 64), (80, 64)]):
        (d / "inst" / f"{i}.png").write_bytes(_png_bytes(
            rng.integers(0, 255, (h, w, 3), dtype=np.uint8)))
    return d


def _run(module, *args, timeout=300):
    return subprocess.run([sys.executable, "-m",
                           f"lora_tpu_torch.cli.{module}", *args], cwd=ROOT,
                          env=ENV, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("module", ["lora_pti", "lora_ti"])
def test_help(module):
    res = _run(module, "--help", timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--pretrained_model_name_or_path", "--mixed_precision",
                 "--device"):
        assert flag in res.stdout, flag


def test_lora_pti_one_plus_one_steps_on_the_cpu(model_dir, tmp_path):
    out = tmp_path / "out"
    res = _run("lora_pti",
               "--pretrained_model_name_or_path", str(model_dir / "model"),
               "--device", "cpu",
               "--instance_data_dir", str(model_dir / "inst"),
               "--placeholder_tokens", "<s1>|<s2>", "--use_template",
               "object", "--output_dir", str(out), "--resolution", "64",
               "--max_train_steps_ti", "1", "--max_train_steps_tuning", "1",
               "--gradient_accumulation_steps", "1", "--lora_rank", "2",
               "--use_face_segmentation_condition", "--save_steps", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PTI : drift:" in res.stdout
    assert {"final_lora.safetensors", "step_1.safetensors",
            "step_inv_1.safetensors", "metrics.jsonl"} <= set(
        os.listdir(out))
    assert {"0.mask.png", "1.mask.png"} <= set(
        os.listdir(model_dir / "inst"))
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [(r["phase"], r.get("step")) for r in records] == [
        ("inversion", 1), ("inversion", None), ("tune", 1), ("tune", None)]
    tensors, meta = load_file(str(out / "final_lora.safetensors"))
    assert meta["<s1>"] == meta["<s2>"] == "<embed>"
    assert {"unet", "text_encoder"} <= set(meta)


def test_lora_ti_two_steps_on_the_cpu(model_dir, tmp_path):
    out = tmp_path / "out"
    res = _run("lora_ti",
               "--pretrained_model_name_or_path", str(model_dir / "model"),
               "--device", "cpu",
               "--instance_data_dir", str(model_dir / "inst"),
               "--placeholder_token", "<s>", "--output_dir", str(out),
               "--resolution", "64", "--max_train_steps", "2",
               "--unfreeze_lora_step", "1", "--save_steps", "0",
               "--lora_rank", "2", "--output_format", "safe")
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(os.listdir(out)) == ["lora_ti_final.safetensors",
                                       "metrics.jsonl"]


@pytest.mark.parametrize("cli", [lora_pti, lora_ti])
def test_unknown_flag_and_the_card_by_default(cli, model_dir, tmp_path,
                                              monkeypatch):
    with pytest.raises(SystemExit, match="unknown flag --no_such_flag"):
        cli.train(str(model_dir / "model"), device="cpu", no_such_flag=1)
    monkeypatch.setenv("LORA_TPU_ALLOW_HASHED_TOKENIZER", "1")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.train(str(model_dir / "model"),
                      instance_data_dir=str(model_dir / "inst"),
                      output_dir=str(tmp_path / "o"))
