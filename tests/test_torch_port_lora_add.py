"""The port's lora_add (lora_tpu_torch/cli/lora_add.py) and CompVis export
(formats/ckpt_export.py) against lora_tpu's on the tiny configs, in f32:
lpl on .pt pairs (with and without the text file) and on safetensors with
TI passthrough, ljl, upl into a directory and upl-ckpt-v2 into a .ckpt with
its A1111 embedding: every output tensor and all metadata the same bits as
lora_tpu's; params_from_ckpt back to the collapsed params; the UNet and
VAE key maps equal to lora_tpu's for every config in models/config.py;
and the refusals."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from lora_tpu.cli.lora_add import add as j_add  # noqa: E402
from lora_tpu.formats import ckpt_export as j_ckpt  # noqa: E402
from lora_tpu_torch.cli.lora_add import add as t_add  # noqa: E402
from lora_tpu_torch.formats import ckpt_export as t_ckpt  # noqa: E402
from lora_tpu_torch.formats import pt_io  # noqa: E402
from lora_tpu_torch.formats.reader import load_file  # noqa: E402
from lora_tpu_torch.formats.safetensors_io import (  # noqa: E402
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    save_safeloras_with_embeds,
)
from lora_tpu_torch.models import config as t_cfg  # noqa: E402
from lora_tpu_torch.models.hf_import import save_pipeline_params  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

RANK = 2


def tiny_pipe(seed=0):
    return StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(seed), "cpu",
        unet_cfg=t_cfg.TINY_UNET, text_cfg=t_cfg.TINY_TEXT,
        vae_cfg=t_cfg.TINY_VAE)


def random_pairs(sites, seed):
    rng = np.random.default_rng(seed)
    return [((0.1 * rng.standard_normal((s.out_dim, RANK))).astype(np.float32),
             rng.standard_normal((RANK, s.in_dim)).astype(np.float32))
            for s in sites]


def write_lora(pipe, path, seed, tokens):
    """A full-site UNet and text LoRA file of rank RANK, fp16 as the
    trainers save it, with one TI row per token."""
    rng = np.random.default_rng(seed + 100)
    save_safeloras_with_embeds(
        {"unet": (random_pairs(pipe.unet_sites(), seed),
                  UNET_DEFAULT_TARGET_REPLACE),
         "text_encoder": (random_pairs(pipe.text_sites(), seed + 1),
                          TEXT_ENCODER_DEFAULT_TARGET_REPLACE)},
        {t: rng.standard_normal(t_cfg.TINY_TEXT.hidden_size).astype(
            np.float32) for t in tokens},
        path, cast_fp16=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lora_add")
    pipe = tiny_pipe()
    base = str(root / "base")
    save_pipeline_params(pipe, base)
    a, b = str(root / "a.safetensors"), str(root / "b.safetensors")
    write_lora(pipe, a, 1, ["<a1>", "<a2>"])
    write_lora(pipe, b, 7, ["<b1>"])
    return {"root": root, "base": base, "a": a, "b": b}


@pytest.mark.parametrize("with_text", [False, True])
def test_lpl_pt(tmp_path, with_text):
    rng = np.random.default_rng(3)
    for name, seed in (("x", 0), ("y", 1)):
        pairs = [(rng.standard_normal((6, 2)), rng.standard_normal((2, 5)))
                 for _ in range(3)]
        pt_io.save_lora_pt(pairs, str(tmp_path / f"{name}.pt"))
        if with_text:
            pt_io.save_lora_pt(pairs[:1], str(tmp_path /
                                              f"{name}.text_encoder.pt"))
    out = {}
    for tag, add in (("j", j_add), ("t", t_add)):
        out[tag] = str(tmp_path / f"{tag}.pt")
        add(str(tmp_path / "x.pt"), str(tmp_path / "y.pt"), out[tag],
            alpha_1=0.3, alpha_2=0.9, mode="lpl", with_text_lora=with_text)
    outs = [out["j"], out["t"]]
    if with_text:
        outs += [pt_io.text_lora_path(o) for o in outs]
    else:
        assert not os.path.exists(pt_io.text_lora_path(out["t"]))
    for p_j, p_t in zip(outs[::2], outs[1::2]):
        wj = torch.load(p_j, weights_only=True)
        wt = torch.load(p_t, weights_only=True)
        assert len(wj) == len(wt) and len(wt) in (2, 6)
        for a, b in zip(wj, wt):
            assert a.dtype == b.dtype == torch.float16
            assert torch.equal(a, b)


def test_lpl_pt_without_text_files_skips(tmp_path, capsys):
    """--with_text_lora where the .text_encoder.pt files are missing: the
    UNet pair merges and the text pair is skipped, as in lora_tpu."""
    pairs = [(np.ones((4, 2)), np.ones((2, 4)))]
    for n in ("x", "y"):
        pt_io.save_lora_pt(pairs, str(tmp_path / f"{n}.pt"))
    t_add(str(tmp_path / "x.pt"), str(tmp_path / "y.pt"),
          str(tmp_path / "o.pt"), mode="lpl", with_text_lora=True)
    assert "No text encoder found" in capsys.readouterr().out
    assert os.listdir(tmp_path) and not os.path.exists(
        tmp_path / "o.text_encoder.pt")


def test_lpl_safetensors_ti_passthrough(files, tmp_path):
    out = {}
    for tag, add in (("j", j_add), ("t", t_add)):
        out[tag] = str(tmp_path / f"{tag}.safetensors")
        add(files["a"], files["b"], out[tag], alpha_1=0.25, alpha_2=0.6,
            mode="lpl")
    with open(out["j"], "rb") as fj, open(out["t"], "rb") as ft:
        assert fj.read() == ft.read()
    tensors, meta = load_file(out["t"])
    assert {"<a1>", "<a2>", "<b1>"} <= set(tensors)
    assert tensors["<a1>"].dtype == np.float32
    assert tensors["unet:0:up"].dtype == np.float16


def test_ljl(files, tmp_path):
    out = {}
    for tag, add in (("j", j_add), ("t", t_add)):
        out[tag] = str(tmp_path / f"{tag}.safetensors")
        add(files["a"], files["b"], out[tag], mode="ljl")
    with open(out["j"], "rb") as fj, open(out["t"], "rb") as ft:
        assert fj.read() == ft.read()
    tensors, meta = load_file(out["t"])
    assert meta["unet:0:rank"] == str(2 * RANK)
    assert {k for k, v in meta.items() if v == "<embed>"} == {
        "<s0-0>", "<s0-1>", "<s1-0>"}


def _dir_tensors(path):
    out = {}
    for sub in sorted(os.listdir(path)):
        d = os.path.join(path, sub)
        for f in sorted(os.listdir(d)):
            fp = os.path.join(d, f)
            if f.endswith(".safetensors"):
                out[f"{sub}/{f}"] = load_file(fp)
            else:
                with open(fp) as fh:
                    out[f"{sub}/{f}"] = json.load(fh)
    return out


def test_upl(files, tmp_path):
    """upl: the collapsed directory's every tensor the same bits as
    lora_tpu's (both fold in f32), the TI rows in the grown token table,
    and the same configs; from_pretrained reads it back, table and all."""
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    j_add(files["base"], files["a"], out_j, alpha_1=0.7, mode="upl")
    t_add(files["base"], files["a"], out_t, alpha_1=0.7, mode="upl",
          device="cpu")
    dj, dt = _dir_tensors(out_j), _dir_tensors(out_t)
    assert sorted(dj) == sorted(dt)
    for name in dj:
        if not name.endswith(".safetensors"):
            assert dt[name] == dj[name], name
            continue
        (tj, mj), (tt, mt) = dj[name], dt[name]
        assert mj == mt and sorted(tj) == sorted(tt), name
        for k in tj:
            assert tj[k].dtype == tt[k].dtype == np.float32, k
            np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
    table = dt["text_encoder/model.safetensors"][0][
        "text_model.embeddings.token_embedding.weight"]
    assert table.shape[0] == t_cfg.TINY_TEXT.vocab_size + 2
    base = load_file(os.path.join(files["base"], "unet",
                                  "diffusion_pytorch_model.safetensors"))[0]
    moved = [k for k in base if not np.array_equal(
        base[k], dt["unet/diffusion_pytorch_model.safetensors"][0][k])]
    assert len(moved) == len(tiny_pipe().unet_sites())
    # the directory loads back with its grown token table
    back = StableDiffusionPipeline.from_pretrained(
        out_t, device="cpu", require_real_tokenizer=False)
    np.testing.assert_array_equal(back.text_encoder.get_parameter(
        "text_model.embeddings.token_embedding.weight").numpy(), table)


@pytest.fixture(scope="module")
def ckpts(files):
    root = files["root"]
    out = {"j": str(root / "j_model.ckpt"), "t": str(root / "t_model.ckpt")}
    j_add(files["base"], files["a"], out["j"], alpha_1=0.5,
          mode="upl-ckpt-v2")
    t_add(files["base"], files["a"], out["t"], alpha_1=0.5,
          mode="upl-ckpt-v2", device="cpu")
    return out


def test_upl_ckpt_v2(ckpts):
    """upl-ckpt-v2: the CompVis state dicts hold the same keys and fp16
    tensors, bit for bit; the A1111 embedding .pt beside it carries the
    file's TI rows in sorted-token order under string_to_token 265."""
    sj = torch.load(ckpts["j"], weights_only=False)["state_dict"]
    st = torch.load(ckpts["t"], weights_only=True)["state_dict"]
    assert sorted(sj) == sorted(st)
    for k in sj:
        assert sj[k].dtype == st[k].dtype == torch.float16, k
        assert torch.equal(sj[k], st[k]), k
    assert "first_stage_model.decoder.mid.attn_1.q.weight" in st
    assert st["first_stage_model.decoder.mid.attn_1.q.weight"].ndim == 4
    ej = torch.load(ckpts["j"][:-5] + ".pt", weights_only=False)
    et = torch.load(ckpts["t"][:-5] + ".pt", weights_only=True)
    assert et["string_to_token"]["*"].item() == 265
    assert et["name"] == "t_model" and ej["name"] == "j_model"
    assert torch.equal(et["string_to_param"]["*"], ej["string_to_param"]["*"])
    want = load_file(os.path.join(os.path.dirname(ckpts["t"]),
                                  "a.safetensors"))[0]
    np.testing.assert_array_equal(et["string_to_param"]["*"].numpy(),
                                  np.stack([want["<a1>"], want["<a2>"]]))


def test_params_from_ckpt_round_trip(files, ckpts):
    """params_from_ckpt gives back lora_tpu's import of the same file and,
    through convert_to_ckpt again, the same state dict."""
    got = t_ckpt.params_from_ckpt(ckpts["t"], t_cfg.TINY_UNET,
                                  t_cfg.TINY_VAE)
    want = j_ckpt.params_from_ckpt(ckpts["t"], t_cfg.TINY_UNET,
                                   t_cfg.TINY_VAE)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == torch.float32
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
    pipe = tiny_pipe()
    for module, params in zip((pipe.unet, pipe.text_encoder, pipe.vae), got):
        module.load_state_dict(params, strict=True)
    path = str(files["root"] / "again.ckpt")
    t_ckpt.convert_to_ckpt(pipe, path)
    st = torch.load(ckpts["t"], weights_only=True)["state_dict"]
    again = torch.load(path, weights_only=True)["state_dict"]
    assert sorted(again) == sorted(st)
    assert all(torch.equal(again[k], st[k]) for k in st)


def _configs(cls):
    return sorted(n for n in dir(t_cfg) if isinstance(getattr(t_cfg, n), cls))


@pytest.mark.parametrize("name", _configs(t_cfg.UNetConfig))
def test_unet_key_map(name):
    from lora_tpu.models import config as j_cfg

    got = t_ckpt.unet_key_map(getattr(t_cfg, name))
    assert got == j_ckpt.unet_key_map(getattr(j_cfg, name))
    assert "conv_in" in got and "mid_block.attentions.0" in got


@pytest.mark.parametrize("name", _configs(t_cfg.VAEConfig))
def test_vae_key_map(name):
    from lora_tpu.models import config as j_cfg

    assert t_ckpt.vae_key_map(getattr(t_cfg, name)) == \
        j_ckpt.vae_key_map(getattr(j_cfg, name))


def test_unet_key_map_is_one_copy():
    from lora_tpu_torch.formats import kohya

    assert kohya.unet_key_map is t_ckpt.unet_key_map


def test_refusals(files, tmp_path):
    with pytest.raises(ValueError, match="lpl needs two .pt or two "
                                         ".safetensors files"):
        t_add(files["a"], str(tmp_path / "x.pt"), str(tmp_path / "o"))
    with pytest.raises(ValueError, match="Only .ckpt files are supported"):
        t_add(files["base"], files["a"], str(tmp_path / "o.bin"),
              mode="upl-ckpt-v2", device="cpu")
    with pytest.raises(ValueError, match="Only .safetensors files are "
                                         "supported"):
        t_add(files["a"], str(tmp_path / "x.pt"), str(tmp_path / "o"),
              mode="ljl")
    with pytest.raises(ValueError, match="Unknown mode nope"):
        t_add(files["a"], files["b"], str(tmp_path / "o"), mode="nope")


def test_upl_defaults_to_the_card(files, tmp_path, monkeypatch):
    """Without --device, upl loads on the card; without CUDA it raises and
    does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_add(files["base"], files["a"], str(tmp_path / "o"), mode="upl")
    assert not os.path.exists(tmp_path / "o")
