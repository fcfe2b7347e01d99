"""The port's DreamBooth command line (lora_tpu_torch/cli/lora_db.py):
--help, a 2-step run on the CPU through `python -m` on a tiny diffusers
directory written by models/hf_import.save_pipeline_params, the card as
the default device, and an SDXL directory, which trains the XL way."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lora_tpu_torch.cli import lora_db  # noqa: E402
from lora_tpu_torch.data.png import _png_bytes  # noqa: E402
from lora_tpu_torch.formats.kohya import is_kohya_xl  # noqa: E402
from lora_tpu_torch.formats.reader import load_file  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_TEXT,
    TINY_UNET,
    TINY_VAE,
    TINY_XL_TEXT,
    TINY_XL_TEXT2,
    TINY_XL_UNET,
)
from lora_tpu_torch.models.hf_import import save_pipeline_params  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import (  # noqa: E402
    StableDiffusionXLPipeline,
)
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


def _run(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "lora_tpu_torch.cli.lora_db",
                           *args], cwd=ROOT, env=ENV, capture_output=True,
                          text=True, timeout=timeout)


def test_help():
    res = _run("--help", timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--pretrained_model_name_or_path", "--mixed_precision",
                 "--device"):
        assert flag in res.stdout


def test_two_steps_on_the_cpu(model_dir, tmp_path):
    out = tmp_path / "out"
    res = _run("--pretrained_model_name_or_path", str(model_dir / "model"),
               "--device", "cpu",
               "--instance_data_dir", str(model_dir / "inst"),
               "--instance_prompt", "a photo of sks dog",
               "--output_dir", str(out), "--resolution", "64",
               "--max_train_steps", "2", "--lora_rank", "2",
               "--use_8bit_adam", "--train_text_encoder",
               "--save_train_state", "--save_steps", "2")
    assert res.returncode == 0, res.stderr[-3000:]
    assert {"lora_weight.safetensors", "lora_weight.pt",
            "lora_weight.text_encoder.pt", "lora_weight_s2.safetensors",
            "train_state.safetensors", "metrics.jsonl"} <= set(os.listdir(out))
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records[0]["step"] == 1 and np.isfinite(records[0]["loss"])
    assert records[-1]["steps"] == 2 and not records[-1]["preempted"]
    tensors, meta = load_file(str(out / "lora_weight.safetensors"))
    assert {"unet", "text_encoder"} <= set(meta)
    assert all(t.dtype == np.float16 for t in tensors.values())


def test_unknown_flag_and_defaults(model_dir, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="unknown flag --no_such_flag"):
        lora_db.train(str(model_dir / "model"), device="cpu",
                      no_such_flag=1)
    monkeypatch.setenv("LORA_TPU_ALLOW_HASHED_TOKENIZER", "1")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lora_db.train(str(model_dir / "model"),
                          instance_data_dir=str(model_dir / "inst"),
                          output_dir=str(tmp_path / "o"))


def test_sdxl_directory_is_refused(model_dir, tmp_path, monkeypatch):
    """A directory with text_encoder_2/ trains the XL way: te1 and te2 with
    gradient checkpointing, a kohya-XL file that the SDXL pipe loaded from
    the same directory patches (and the indexed formats refused, as
    lora_tpu refuses them)."""
    xl_dir = tmp_path / "xl"
    save_pipeline_params(StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_XL_UNET,
        text_cfg=TINY_XL_TEXT, text2_cfg=TINY_XL_TEXT2, vae_cfg=TINY_VAE),
        str(xl_dir))
    monkeypatch.setenv("LORA_TPU_ALLOW_HASHED_TOKENIZER", "1")
    flags = dict(instance_data_dir=str(model_dir / "inst"),
                 instance_prompt="a photo of sks dog", resolution=64,
                 lora_rank=2, max_train_steps=2, save_steps=0)
    with pytest.raises(ValueError, match="kohya-XL schema only"):
        lora_db.train(str(xl_dir), device="cpu",
                      output_dir=str(tmp_path / "refused"), **flags)
    out = tmp_path / "out"
    res = lora_db.train(str(xl_dir), device="cpu", output_dir=str(out),
                        output_format="safe", train_text_encoder=True,
                        gradient_checkpointing=True, **flags)
    assert res["steps"] == 2 and np.isfinite(res["final_loss"])
    assert sorted(res["trainable"]) == ["lora_text", "lora_text2",
                                        "lora_unet"]
    assert sorted(os.listdir(out)) == ["lora_weight.safetensors",
                                       "metrics.jsonl"]
    keys = list(load_file(str(out / "lora_weight.safetensors"))[0])
    assert is_kohya_xl(keys)
    for prefix in ("lora_unet_input_blocks_", "lora_te1_", "lora_te2_"):
        assert any(k.startswith(prefix) for k in keys), prefix
    pipe = StableDiffusionXLPipeline.from_pretrained(str(xl_dir),
                                                     device="cpu")
    pipe.patch_pipe(str(out / "lora_weight.safetensors"))
    assert all(getattr(pipe, a) is not None
               for a in ("lora_unet", "lora_text", "lora_text2"))


def test_metrics_logger_and_profiling(tmp_path, capsys):
    """utils/metrics.py writes lora_tpu's JSONL records; utils/profiling.py
    traces a block with torch.profiler into a Chrome trace, names regions
    in it, and times a block."""
    from lora_tpu_torch.utils import metrics, profiling

    log = metrics.MetricsLogger(str(tmp_path / "m.jsonl"), echo=False)
    log.log(step=1, loss=0.5)
    log.log(step=2, loss=0.25, sps=3.0)
    with open(tmp_path / "m.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [(r["step"], r["loss"]) for r in records] == [(1, 0.5), (2, 0.25)]
    assert all("t" in r for r in records) and records[1]["sps"] == 3.0
    timer = metrics.StepTimer()
    assert timer.steps_per_sec == 0.0
    for _ in range(3):
        timer.tick()
    assert timer.steps_per_sec > 0

    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("lora_step"):
            torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "lora_step" in f.read()
    with profiling.timed("block"):
        pass
    assert "[timing] block:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert profiling.memory_stats() == {}
