"""The port's DreamBooth trainer against lora_tpu's, continued (see
tests/test_torch_port_dreambooth.py for the method and the tolerances):
the blockwise-int8 Adam (use_8bit_adam, with the text encoder), gradient
accumulation over 2 micro-steps, and LoCon targets saved in the kohya
schema (the same key set)."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from lora_tpu.formats.reader import load_file  # noqa: E402

from test_torch_port_dreambooth import (  # noqa: E402
    base_params,
    check_same_run,
    run_both,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401


@pytest.fixture(scope="module")
def params():
    return base_params()


@pytest.mark.parametrize("case", ["adam8bit", "grad_accum", "locon"])
def test_train_dreambooth_matches_jax(case, params, tmp_path, monkeypatch):
    j_res, t_res, j_out, t_out = run_both(case, params, tmp_path, monkeypatch)
    check_same_run(case, j_res, t_res, j_out, t_out)
    if case == "locon":
        name = "lora_weight.safetensors"
        keys = set(load_file(str(t_out / name))[0])
        assert keys == set(load_file(str(j_out / name))[0])
        assert any(k.startswith("lora_te_") for k in keys)
        # the LoCon superset: resnet convs too
        assert any("resnets" in k and k.endswith(".lora_down.weight")
                   for k in keys)
