"""The port's legacy TI+LoRA trainer (lora_tpu_torch/training/ti_legacy.py)
against lora_tpu's: train_ti_lora_legacy in f32 on the tiny configs for 4
steps with unfreeze_lora_step 2, prior preservation, the text encoder and
output_format "both", from the same PNGs, with lora_tpu's draws handed in
through the seams of tests/test_torch_port_pti.py. Checked in both
packages: the TI row trains only through step 2 (the s2 save's row and
the final save's are the same bits) and the LoRA only from step 3 (the s2
save's up factors are all zero); between them the final trees within 1e-4
relative L2, the same metrics, the same artifacts (the .pt files hold the
tensors the .safetensors file holds). Then, port alone, a SIGTERM after
step 3 leaves lora_ti_preempt_3 and no final save."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from lora_tpu.formats.reader import load_file  # noqa: E402
from lora_tpu.formats import pt_io as j_pt  # noqa: E402
from lora_tpu.training import ti_legacy as j_ti  # noqa: E402
from lora_tpu_torch.training import ti_legacy as t_ti  # noqa: E402

from test_torch_port_pti import (  # noqa: E402, F401
    LOSS_RTOL,
    _meta,
    _one_torch_thread,
    base_params,
    check_trees,
    hand_in_jax_draws,
    jax_pipe,
    metrics,
    port_pipe,
    rel_l2,
    TREE_REL_L2,
    write_images,
)
from test_torch_port_pti_control import preempt_at  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

FLAGS = dict(resolution=64, lora_rank=2, max_train_steps=4,
             unfreeze_lora_step=2, save_steps=2, seed=0,
             placeholder_token="<s1>", with_prior_preservation=True,
             class_prompt="a photo of a dog", train_text_encoder=True,
             output_format="both", stochastic_attribute="red,small")
SAVES = ("lora_ti_s2", "lora_ti_s4", "lora_ti_final")


@pytest.fixture(scope="module")
def params():
    return base_params()


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    root = tmp_path_factory.mktemp("ti")
    flags = dict(FLAGS, instance_data_dir=write_images(root / "inst", 3, 0),
                 class_data_dir=write_images(root / "class", 2, 1))
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        hand_in_jax_draws(mp, t_ti, flags["seed"])
        for name in ("jax", "torch"):
            cfg = dict(flags, output_dir=str(root / f"out_{name}"))
            out[name] = (j_ti.train_ti_lora_legacy(
                jax_pipe(params), j_ti.LegacyTiConfig(**cfg))
                if name == "jax" else t_ti.train_ti_lora_legacy(
                    port_pipe(params), t_ti.LegacyTiConfig(**cfg)))
    finally:
        mp.undo()
    return out["jax"], out["torch"], root / "out_jax", root / "out_torch"


def test_legacy_ti_matches_jax(runs):
    j_res, t_res, j_out, t_out = runs
    assert not j_res["preempted"] and not t_res["preempted"]
    np.testing.assert_allclose(t_res["final_loss"], j_res["final_loss"],
                               rtol=LOSS_RTOL)
    check_trees("legacy", j_res, t_res)
    jm, tm = metrics(j_out / "metrics.jsonl"), metrics(t_out / "metrics.jsonl")
    assert [(r["step"], r["phase"]) for r in tm] == \
        [(r["step"], r["phase"]) for r in jm] == [(1, "ti")]
    np.testing.assert_allclose(tm[0]["loss"], jm[0]["loss"], rtol=LOSS_RTOL)
    names = sorted(os.listdir(j_out))
    assert sorted(os.listdir(t_out)) == names
    assert names == sorted(["metrics.jsonl"] + [
        s + e for s in SAVES for e in (".safetensors", ".pt",
                                       ".text_encoder.pt", ".ti.pt")])
    for name in names:
        if not name.endswith(".safetensors"):
            continue
        (jt, jmeta), (tt, tmeta) = (load_file(str(d / name))
                                    for d in (j_out, t_out))
        # the target lists are json.dumps(list(a set)): their order
        # follows string hashing, so they compare as sets
        assert _meta(tmeta) == _meta(jmeta) and sorted(tt) == sorted(jt), \
            name
        rel = rel_l2([tt[k] for k in jt], list(jt.values()))
        assert rel <= TREE_REL_L2 + 2 ** -11, (name, rel)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_gates_switch_after_unfreeze_step(runs, package):
    """Through step 2 only the TI row moves (the LoRA up factors of the s2
    save are zero); from step 3 only the LoRAs (the row of the s2 save is
    the final save's, bit for bit)."""
    out = runs[2] if package == "jax" else runs[3]
    s2, _ = load_file(str(out / "lora_ti_s2.safetensors"))
    final, _ = load_file(str(out / "lora_ti_final.safetensors"))
    np.testing.assert_array_equal(s2["<s1>"], final["<s1>"])
    ups = [k for k in s2 if k.endswith(":up")]
    assert ups and all(not s2[k].any() for k in ups)
    assert any(final[k].any() for k in ups)
    assert j_pt.load_ti_pt(str(out / "lora_ti_s2.ti.pt"))["<s1>"].tobytes() \
        == j_pt.load_ti_pt(str(out / "lora_ti_final.ti.pt"))["<s1>"].tobytes()


def test_pt_files_hold_the_safetensors_tensors(runs):
    """The port's .pt files (UNet pairs, text-encoder pairs, the TI row)
    hold what its .safetensors file holds, read by lora_tpu's readers."""
    out = runs[3]
    for save in SAVES:
        st, meta = load_file(str(out / f"{save}.safetensors"))
        for model, suffix in (("unet", ".pt"),
                              ("text_encoder", ".text_encoder.pt")):
            flat = j_pt.load_lora_pt(str(out / (save + suffix)))
            n = sum(1 for k in st if k.startswith(model + ":"))
            assert len(flat) == n, (save, model)
            for i in range(n // 2):
                for j, leaf in enumerate(("up", "down")):
                    want = st[f"{model}:{i}:{leaf}"]
                    np.testing.assert_array_equal(
                        np.asarray(flat[2 * i + j], want.dtype), want)
        ti = j_pt.load_ti_pt(str(out / f"{save}.ti.pt"))
        assert sorted(ti) == [k for k, v in meta.items() if v == "<embed>"]
        np.testing.assert_array_equal(np.asarray(ti["<s1>"],
                                                 st["<s1>"].dtype),
                                      st["<s1>"])


def test_preempted_legacy_run(params, tmp_path, monkeypatch):
    calls = preempt_at(monkeypatch, t_ti, 3)
    out = tmp_path / "out"
    res = t_ti.train_ti_lora_legacy(port_pipe(params), t_ti.LegacyTiConfig(
        **dict(FLAGS, with_prior_preservation=False, save_steps=0,
               instance_data_dir=write_images(tmp_path / "inst", 2, 2),
               output_dir=str(out))))
    assert res["preempted"] and calls[0] == 3
    assert sorted(os.listdir(out)) == sorted(
        ["metrics.jsonl"] + ["lora_ti_preempt_3" + e for e in (
            ".safetensors", ".pt", ".text_encoder.pt", ".ti.pt")])
