"""The port's pivotal tuning trainer alone (lora_tpu_torch/training/pti.py)
on the tiny CPU pipeline: preemption by SIGTERM sent from a step hook at
micro-step k (no timer) in inversion, which stops before tuning and writes
no final artifact, and in tuning, which keeps its step_* save and writes
no final artifact; every refusal (SDXL, with lora_tpu's error, a device
mesh, unknown LoRA targets, LoCon with the extended targets, unsorted
placeholder tokens, a token already in the tokenizer, a multi-token
initializer, unequal token and initializer counts); and the wandb-gated
eval at the tuning saves, which leaves the training pipe and the steps as
they were."""

import dataclasses
import json
import os
import signal

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
from lora_tpu_torch.training import pti as t_pti  # noqa: E402
from lora_tpu_torch.utils import eval as t_eval  # noqa: E402

SIZE = 64
BASE = dict(resolution=SIZE, lora_rank=2, max_train_steps_ti=3,
            max_train_steps_tuning=3, gradient_accumulation_steps=2,
            save_steps=100, seed=0, placeholder_tokens="<s1>|<s2>",
            use_template="object", train_text_encoder=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_pipe():
    return StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_UNET,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)


@pytest.fixture(scope="module")
def inst(tmp_path_factory):
    d = tmp_path_factory.mktemp("inst")
    rng = np.random.default_rng(0)
    for i in range(2):
        (d / f"img_{i}.png").write_bytes(_png_bytes(
            rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)))
    return str(d)


def preempt_at(monkeypatch, module, k):
    """SIGTERM to this process after the k-th micro-step of the run (the
    trainer's guard turns it into a flag it reads before the next one)."""
    real = module.make_train_step
    calls = [0]

    def make_train_step(**kw):
        step = real(**kw)

        def hooked(*a, **kw2):
            loss = step(*a, **kw2)
            calls[0] += 1
            if calls[0] == k:
                os.kill(os.getpid(), signal.SIGTERM)
            return loss

        return hooked

    monkeypatch.setattr(module, "make_train_step", make_train_step)
    return calls


def test_preempted_in_inversion(inst, tmp_path, monkeypatch):
    """SIGTERM after micro-step 3 (step 1 done, step 2 half way): the
    inversion's rows saved as step_inv_1, no tuning, no final artifact."""
    calls = preempt_at(monkeypatch, t_pti, 3)
    out = tmp_path / "out"
    res = t_pti.train_pti(tiny_pipe(), t_pti.PTIConfig(
        **BASE, instance_data_dir=inst, output_dir=str(out)))
    assert res["preempted"] and calls[0] == 3
    assert "lora_unet" not in res["trainable"]
    assert sorted(os.listdir(out)) == ["metrics.jsonl",
                                       "step_inv_1.safetensors"]


def test_preempted_in_tuning(inst, tmp_path, monkeypatch):
    """SIGTERM after the 6 inversion micro-steps and 3 of tuning: the
    tuning's step_1 save, no final artifact."""
    calls = preempt_at(monkeypatch, t_pti, 6 + 3)
    out = tmp_path / "out"
    res = t_pti.train_pti(tiny_pipe(), t_pti.PTIConfig(
        **BASE, instance_data_dir=inst, output_dir=str(out)))
    assert res["preempted"] and calls[0] == 9
    assert "lora_unet" in res["trainable"]
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "step_1.safetensors"]


def test_refusals(inst, tmp_path):
    cfg = t_pti.PTIConfig(**BASE, instance_data_dir=inst,
                          output_dir=str(tmp_path / "o"))
    # SDXL ends where lora_tpu's train_pti ends: the first inversion step
    # raises the loss's error
    xl = StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_XL_UNET,
        text_cfg=TINY_XL_TEXT, text2_cfg=TINY_XL_TEXT2, vae_cfg=TINY_VAE)
    with pytest.raises(ValueError, match="^textual inversion is not "
                       "supported for SDXL training \\(dual-tokenizer TI is "
                       "out of scope\\)$"):
        t_pti.train_pti(xl, cfg)
    # data_parallel and fsdp on a 1-rank group are no mesh (lora_tpu's
    # mesh_from_flags): they train; tensor parallelism is Slice 7b's
    from test_torch_port_mesh import one_rank_group

    with one_rank_group(tmp_path):
        for flags in ({"data_parallel": True}, {"fsdp": 2}):
            res = t_pti.train_pti(tiny_pipe(), dataclasses.replace(
                cfg, max_train_steps_ti=1, max_train_steps_tuning=1,
                gradient_accumulation_steps=1,
                output_dir=str(tmp_path / str(sorted(flags))), **flags))
            assert not res["preempted"] and np.isfinite(res["final_loss"])
    with pytest.raises(NotImplementedError, match="Slice 7b"):
        t_pti.train_pti(tiny_pipe(), dataclasses.replace(
            cfg, tensor_parallel=2))
    for bad, match in (
            ({"lora_targets": "everything"}, "default\\|extended\\|locon"),
            ({"lora_targets": "locon", "use_extended_lora": True},
             "conflicts"),
            ({"placeholder_tokens": "<s2>|<s1>"}, "should be sorted"),
            ({"initializer_tokens": "dog"}, "Unequal"),
            ({"initializer_tokens": "<zero>|big dog"}, "single token")):
        with pytest.raises(ValueError, match=match):
            t_pti.train_pti(tiny_pipe(), dataclasses.replace(cfg, **bad))
    pipe = tiny_pipe()
    pipe.tokenizer.add_tokens("<s1>")
    with pytest.raises(ValueError, match="already contains the token <s1>"):
        t_pti.train_pti(pipe, cfg)


def test_setup_ti_rows_and_table(tmp_path):
    """<rand-sigma> from the generator, <zero>, a token's row; the table
    grows with zero rows to the new ids."""
    pipe = tiny_pipe()
    table = pipe.text_encoder.get_parameter(
        "text_model.embeddings.token_embedding.weight").detach().clone()
    gen = torch.Generator().manual_seed(5)
    ids, rows = t_pti.setup_ti(pipe, ["<a>", "<b>", "<c>"],
                               ["<rand-0.5>", "<zero>", "dog"], gen)
    want0 = torch.randn(table.shape[1],
                        generator=torch.Generator().manual_seed(5)) * 0.5
    torch.testing.assert_close(rows[0], want0, rtol=0, atol=0)
    assert torch.equal(rows[1], torch.zeros_like(rows[1]))
    dog = pipe.tokenizer.encode("dog")
    assert torch.equal(rows[2], table[dog[0]])
    assert ids.tolist() == [TINY_TEXT.vocab_size + i for i in range(3)]
    grown = pipe.text_encoder.get_parameter(
        "text_model.embeddings.token_embedding.weight")
    assert grown.shape[0] == TINY_TEXT.vocab_size + 3
    assert torch.equal(grown[:table.shape[0]], table)
    assert not grown[table.shape[0]:].any()


def test_wandb_eval_is_skipped_naming_slice_5(inst, tmp_path, capsys,
                                              monkeypatch):
    """The wandb-gated eval runs at each tuning save (lora_tpu's, ported in
    Slice 5): a phase="eval" line with the images' statistics, no "eval
    skipped:", the training pipe's LoRA trees, token table, tokenizer and
    adapter generation the same objects and bits after it as before, and
    the step after it equal to a run without the eval."""
    real = t_pti.eval_at_save
    seen = []

    def state(pipe):
        table = pipe.text_encoder.get_parameter(t_pti._TOKEN_TABLE)
        return (pipe.lora_unet, pipe.lora_text, table.detach().clone(),
                dict(pipe.tokenizer.added_tokens), pipe.adapter_generation)

    def checked(pipe, *a, **kw):
        before = state(pipe)
        out = real(pipe, *a, **kw)
        after = state(pipe)
        assert after[0] is before[0] and after[1] is before[1]
        assert torch.equal(after[2], before[2])
        assert after[3:] == before[3:]
        seen.append(out)
        return out

    monkeypatch.setattr(t_pti, "eval_at_save", checked)
    # the eval generates at the pipeline's default 512px, where the tiny
    # UNet's plain attention over 4096 tokens takes seconds a call on the
    # CPU: the pipeline is called at the training size here instead
    real_eval = t_eval.evaluate_pipe

    class AtSize:
        def __init__(self, pipe):
            self.pipe, self.device = pipe, pipe.device

        def __call__(self, prompt, **kw):
            return self.pipe(prompt, height=SIZE, width=SIZE, **kw)

    monkeypatch.setattr(t_eval, "evaluate_pipe",
                        lambda pipe, *a, **kw: real_eval(AtSize(pipe), *a,
                                                         **kw))
    runs = {}
    for wandb in (True, False):
        out = tmp_path / f"o_{wandb}"
        runs[wandb] = t_pti.train_pti(tiny_pipe(), t_pti.PTIConfig(**dict(
            BASE, max_train_steps_ti=1, max_train_steps_tuning=2,
            gradient_accumulation_steps=1, save_steps=1, log_wandb=wandb,
            continue_inversion=True),
            instance_data_dir=inst, output_dir=str(out)))
        assert not runs[wandb]["preempted"]
    assert "eval skipped:" not in capsys.readouterr().out
    assert len(seen) == 2
    lines = [json.loads(line) for line in
             open(tmp_path / "o_True" / "metrics.jsonl")]
    evals = [r for r in lines if r.get("phase") == "eval"]
    assert [r["step"] for r in evals] == [1, 2]
    for r in evals:
        assert r["n_images"] == 4
        assert 0.0 <= r["gen_mean"] <= 255.0 and r["gen_std"] >= 0.0
    assert not any(r.get("phase") == "eval" for r in
                   map(json.loads, open(tmp_path / "o_False" /
                                        "metrics.jsonl")))
    assert {"step_1.safetensors", "step_inv_1.safetensors",
            "final_lora.safetensors"} <= set(os.listdir(tmp_path / "o_True"))
    with_eval, without = (runs[w]["trainable"] for w in (True, False))
    for group in ("lora_unet", "ti"):
        a, b = with_eval[group], without[group]
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y), group
