"""The plain reference against lora_tpu_torch at the tiny sizes (the port
in float32 on the CPU runs its plain paths), and what the run path and the
reference import."""

import os
import subprocess
import sys

import pytest

from benchmark.serving import ServeCell
from benchmark.tests.tiny import TINY, TINY_SD2, tiny_mix
from benchmark.training import TrainCell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("cfg", [TINY, TINY_SD2], ids=["sd1", "sd2_v"])
def test_served_images_match_the_reference(cfg, tmp_path):
    """Text encoder with LoRA and TI, dpm++ under CFG (v prediction for the
    SD-2 topology), VAE decode and the PNG. Both sides compute in float32;
    round-off in a different order, carried through the sampler and cut to
    8 bits, leaves single pixels a level or two apart."""
    cell = ServeCell(cfg, tiny_mix("closed_b8_512"), 31337, "cpu",
                     str(tmp_path))
    cell.setup()
    cell.run(1.0, False)
    cell.close()
    n = cell.check()
    assert n["image_max_abs"] <= 2 / 255 + 1e-9
    assert n["image_rms"] < 2e-3


@pytest.mark.parametrize("cfg", [TINY, TINY_SD2], ids=["sd1", "sd2_v"])
def test_training_steps_match_the_reference(cfg, tmp_path):
    """VAE encode, both LoRAs, the prior-preservation loss, the clipped
    gradient and AdamW over three steps: float32 round-off apart."""
    cell = TrainCell(cfg, tiny_mix("db_prior_b4_512"), 4242, "cpu",
                     str(tmp_path))
    cell.setup()
    cell.close()
    n = cell.check()
    assert n["loss_gap"] < 1e-5
    assert n["grad1_gap"] < 1e-4
    assert n["change_gap"] < 1e-3


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    mods = _modules_after(
        "import benchmark.reference.sd, benchmark.reference.sampler, "
        "benchmark.reference.tokens, benchmark.reference.txt2img, "
        "benchmark.reference.dreambooth")
    assert "lora_tpu_torch" not in mods and "lora_tpu" not in mods
    for f in os.listdir(os.path.join(ROOT, "benchmark", "reference")):
        if f.endswith(".py"):
            with open(os.path.join(ROOT, "benchmark", "reference", f)) as fh:
                assert "lora_tpu" not in fh.read(), f


def test_run_path_imports_neither_jax_nor_lora_tpu():
    """A whole tiny run in a fresh process: the top-level names compared
    whole (lora_tpu_torch passes, lora_tpu does not)."""
    mods = _modules_after(
        "import torch\n"
        "from benchmark import run\n"
        "from benchmark.tests.tiny import TINY, bench_with_all_cells, "
        "tiny_mix\n"
        "b = bench_with_all_cells(run.manifest())\n"
        "for cell, mix in (('sd15.train_db', 'db_prior_b4_512'), "
        "('sd15.serve_closed', 'closed_b8_512')):\n"
        "    run.run_cell(b, cell, 3, 0.5, True, 'cpu', cfg=TINY, "
        "mix=tiny_mix(mix))\n"
        "assert run.forbidden_modules() == [], run.forbidden_modules()")
    assert "lora_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "lora_tpu"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "lora_tpu_torch_like.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "lora_tpu.core", sys)
    assert "lora_tpu" in run.forbidden_modules()
