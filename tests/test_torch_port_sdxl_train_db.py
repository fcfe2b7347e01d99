"""The port's DreamBooth trainer on SDXL against lora_tpu's, the slice as a
whole, as tests/test_trainers.py holds lora_tpu's SDXL trainer (its mesh
case aside): train_dreambooth for 3 steps in f32 on the tiny XL configs,
from the same PNGs, base weights, LoRA init (lora_tpu's init_lora through
the port's init seam: SDXL refuses .pt resume) and step draws (handed in
through the port's step factory and VAE encode, monkeypatched, as in
tests/test_torch_port_dreambooth.py, whose checks and tolerances these
are). Checked: the three LoRA trees, metrics.jsonl, and the kohya-XL
files' names, keys, metadata and tensors. Then: the cached text against
the uncached, per-image time_ids, lora_tpu's refusals, a train-state
resume carrying lora_text2, and PTI and legacy TI ending where lora_tpu's
end."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.formats.kohya import is_kohya_xl  # noqa: E402
from lora_tpu.formats.reader import load_file  # noqa: E402
from lora_tpu.models.config import (  # noqa: E402
    TINY_VAE,
    TINY_XL_TEXT,
    TINY_XL_TEXT2,
    TINY_XL_UNET,
)
from lora_tpu.pipelines.sdxl import (  # noqa: E402
    StableDiffusionXLPipeline as JXLPipe,
)
from lora_tpu.training import dreambooth as j_db  # noqa: E402
from lora_tpu.training import pti as j_pti  # noqa: E402
from lora_tpu.training import ti_legacy as j_ti  # noqa: E402
from lora_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from lora_tpu_torch.data.png import _png_bytes  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.models.vae import VAE  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import (  # noqa: E402
    StableDiffusionXLPipeline,
)
from lora_tpu_torch.training import dreambooth as t_db  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402
from lora_tpu_torch.training import pti as t_pti  # noqa: E402
from lora_tpu_torch.training import ti_legacy as t_ti  # noqa: E402

from test_torch_port_dreambooth import (  # noqa: E402
    SIZE,
    STEPS,
    check_same_run,
    hand_in_jax_draws,
    hand_in_jax_init,
    write_images,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

BASE = dict(resolution=SIZE, lora_rank=2, max_train_steps=STEPS,
            save_steps=2, seed=0, instance_prompt="a photo of sks dog",
            learning_rate=1e-4, learning_rate_text=5e-5,
            output_format="safe")
CASES = {
    # the recipe's flags (recipes/run_lora_db_xl.sh): both text encoders,
    # gradient checkpointing; uncached latents, per-image time_ids
    "text_remat": dict(train_text_encoder=True, gradient_checkpointing=True),
    # cached latents and the cached dual-encoder text, the constant row
    "cached_latents": dict(cached_latents=True),
}
# lora_tpu's own limit for the cached-text first-step loss against the
# uncached one (tests/test_trainers.py:536)
CACHED_TEXT_RTOL = 2e-4
MODELS = (("unet", UNet, TINY_XL_UNET), ("text", CLIPTextModel, TINY_XL_TEXT),
          ("text2", CLIPTextModel, TINY_XL_TEXT2), ("vae", VAE, TINY_VAE))


@pytest.fixture(scope="module")
def params():
    """Numpy params of the tiny XL UNet, te1, te2 and VAE (the port's
    init)."""
    pipe = StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_XL_UNET,
        text_cfg=TINY_XL_TEXT, text2_cfg=TINY_XL_TEXT2, vae_cfg=TINY_VAE)
    return {name: {k: v.numpy() for k, v in getattr(pipe, attr)
                   .state_dict().items()}
            for name, attr in (("unet", "unet"), ("text", "text_encoder"),
                               ("text2", "text_encoder_2"), ("vae", "vae"))}


def jax_pipe(params):
    j = {k: {n: jnp.asarray(v) for n, v in p.items()}
         for k, p in params.items()}
    return JXLPipe(unet_params=j["unet"], text_params=j["text"],
                   text2_params=j["text2"], vae_params=j["vae"],
                   tokenizer=JTokenizer(vocab_size=TINY_XL_TEXT.vocab_size),
                   unet_cfg=TINY_XL_UNET, text_cfg=TINY_XL_TEXT,
                   text2_cfg=TINY_XL_TEXT2, vae_cfg=TINY_VAE)


def port_pipe(params):
    modules = []
    for name, cls, cfg in MODELS:
        m = cls(cfg, device="cpu")
        m.load_state_dict(state_dict_from_jax(params[name]), strict=True)
        modules.append(m)
    return StableDiffusionXLPipeline(
        *modules, CLIPTokenizer(vocab_size=TINY_XL_TEXT.vocab_size))


# the cases of test_train_dreambooth_xl_matches_jax: this file's, and
# text_remat's in test_torch_port_dreambooth_xl_remat.py (the longest run
# of the suite, so it takes a test worker of its own)
CASES_HERE = ("cached_latents",)


@pytest.mark.parametrize("case", CASES_HERE)
def test_train_dreambooth_xl_matches_jax(case, params, tmp_path,
                                         monkeypatch):
    check_train_dreambooth_xl(case, params, tmp_path, monkeypatch)


def check_train_dreambooth_xl(case, params, tmp_path, monkeypatch):
    """train_dreambooth on SDXL with one CASES entry's flags against
    lora_tpu's, and the kohya-XL file's names and prefixes."""
    flags = dict(BASE, **CASES[case],
                 instance_data_dir=write_images(tmp_path / "inst", 3, 0))
    hand_in_jax_init(monkeypatch)
    hand_in_jax_draws(monkeypatch, flags["seed"])
    j_res = j_db.train_dreambooth(jax_pipe(params), j_db.DreamBoothConfig(
        **flags, output_dir=str(tmp_path / "out_jax")))
    t_res = t_db.train_dreambooth(port_pipe(params), t_db.DreamBoothConfig(
        **flags, output_dir=str(tmp_path / "out_torch")))
    check_same_run(case, j_res, t_res, tmp_path / "out_jax",
                   tmp_path / "out_torch")
    groups = ["lora_unet"] + (["lora_text", "lora_text2"]
                              if flags.get("train_text_encoder") else [])
    assert sorted(t_res["trainable"]) == sorted(groups)
    names = sorted(os.listdir(tmp_path / "out_torch"))
    assert names == ["lora_weight.safetensors", "lora_weight_s2.safetensors",
                     "metrics.jsonl"]
    keys = list(load_file(str(tmp_path / "out_torch" /
                              "lora_weight.safetensors"))[0])
    assert is_kohya_xl(keys)
    prefixes = ["lora_unet_input_blocks_"] + (
        ["lora_te1_", "lora_te2_"] if len(groups) == 3 else [])
    for prefix in prefixes:
        assert any(k.startswith(prefix) for k in keys), prefix


def test_cached_text_matches_uncached_loss(params, tmp_path):
    """The frozen-text fast path (te1 and te2 encoded once, the pooled rows
    cached beside the context) gives the first step's loss of encoding in
    the step."""
    inst = write_images(tmp_path / "inst", 2, 1)
    losses = []
    for cache in (True, False):
        res = t_db.train_dreambooth(port_pipe(params), t_db.DreamBoothConfig(
            **dict(BASE, max_train_steps=1, save_steps=0),
            instance_data_dir=inst, cache_text_embeddings=cache,
            output_dir=str(tmp_path / f"o_{cache}")))
        losses.append(res["final_loss"])
    np.testing.assert_allclose(losses[0], losses[1], rtol=CACHED_TEXT_RTOL)


def test_per_image_time_ids(params, tmp_path, monkeypatch):
    """Uncached training feeds each image's original size and crop corner
    into add_time_ids, the rows lora_tpu's test names
    (tests/test_trainers.py:578-609); cached latents the constant
    training-size row."""
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(7)
    for name, (h, w) in (("wide", (80, 120)), ("tall", (120, 80))):
        (d / f"{name}.png").write_bytes(_png_bytes(
            rng.integers(0, 255, (h, w, 3), dtype=np.uint8)))
    captured = []
    real = t_db.make_train_step

    def spy(**kw):
        step = real(**kw)

        def wrapped(trainable, base, batch, **kw2):
            captured.append(batch["add_time_ids"].numpy().copy())
            return step(trainable, base, batch, **kw2)

        return wrapped

    monkeypatch.setattr(t_db, "make_train_step", spy)
    cfg = t_db.DreamBoothConfig(**dict(BASE, max_train_steps=6, save_steps=0),
                                instance_data_dir=str(d),
                                output_dir=str(tmp_path / "o"))
    res = t_db.train_dreambooth(port_pipe(params), cfg)
    assert np.isfinite(res["final_loss"])
    rows = {tuple(r) for b in captured for r in b}
    # resize-short to 64: wide -> (64, 96), crop left 16; tall -> top 16
    assert rows == {(80, 120, 0, 16, 64, 64), (120, 80, 16, 0, 64, 64)}
    captured.clear()
    t_db.train_dreambooth(port_pipe(params), dataclasses.replace(
        cfg, cached_latents=True, max_train_steps=2,
        output_dir=str(tmp_path / "o2")))
    assert {tuple(r) for b in captured for r in b} == {
        (64, 64, 0, 0, 64, 64)}


@pytest.mark.parametrize("bad", [{"output_format": "both"},
                                 {"output_format": "pt"},
                                 {"resume_unet": "x.pt"},
                                 {"resume_text_encoder": "x.pt",
                                  "train_text_encoder": True}])
def test_refusals_match_lora_tpu(params, tmp_path, bad):
    """lora_tpu's SDXL refusals, type and message, before anything runs."""
    flags = dict(BASE, instance_data_dir=str(tmp_path),
                 output_dir=str(tmp_path / "o"), **bad)
    with pytest.raises(ValueError) as want:
        j_db.train_dreambooth(jax_pipe(params), j_db.DreamBoothConfig(**flags))
    with pytest.raises(ValueError) as got:
        t_db.train_dreambooth(port_pipe(params),
                              t_db.DreamBoothConfig(**flags))
    assert str(got.value) == str(want.value)
    assert "kohya-XL" in str(got.value) or ".pt adapter" in str(got.value)


def test_train_state_resume_carries_lora_text2(params, tmp_path):
    """2 steps saving the full train state, resumed to 4: the bits of a
    straight 4-step run, te2's LoRA and its Adam moments included."""
    flags = dict(BASE, max_train_steps=4, save_steps=0,
                 train_text_encoder=True,
                 instance_data_dir=write_images(tmp_path / "one", 1, 3))
    straight = t_db.train_dreambooth(port_pipe(params), t_db.DreamBoothConfig(
        **flags, output_dir=str(tmp_path / "straight")))
    first = t_db.train_dreambooth(port_pipe(params), t_db.DreamBoothConfig(
        **dict(flags, max_train_steps=2, save_steps=2),
        save_train_state=True, output_dir=str(tmp_path / "first")))
    assert first["steps"] == 2
    resumed = t_db.train_dreambooth(port_pipe(params), t_db.DreamBoothConfig(
        **flags, output_dir=str(tmp_path / "resumed"),
        resume_state=str(tmp_path / "first" / "train_state.safetensors")))
    assert resumed["steps"] == 4 and "lora_text2" in resumed["trainable"]
    for a, b in zip(t_optim.tree_leaves(straight["trainable"]),
                    t_optim.tree_leaves(resumed["trainable"])):
        assert torch.equal(a, b)
    assert resumed["final_loss"] == straight["final_loss"]
    a, b = (load_file(str(tmp_path / d / "lora_weight.safetensors"))[0]
            for d in ("straight", "resumed"))
    assert sorted(a) == sorted(b)
    assert any(k.startswith("lora_te2_") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_pti_and_legacy_ti_end_where_lora_tpu_ends(params, tmp_path):
    """lora_tpu has no SDXL path for either trainer: the first TI step
    raises its loss's ValueError. The port ends at the same point with the
    same type and message."""
    inst = write_images(tmp_path / "inst", 2, 2)
    runs = {
        "pti": (j_pti, t_pti, "train_pti", "PTIConfig", dict(
            placeholder_tokens="<s1>|<s2>", use_template="object",
            resolution=SIZE, max_train_steps_ti=2, max_train_steps_tuning=2,
            gradient_accumulation_steps=1, save_steps=100)),
        "ti": (j_ti, t_ti, "train_ti_lora_legacy", "LegacyTiConfig", dict(
            placeholder_token="<s>", resolution=SIZE, max_train_steps=2,
            unfreeze_lora_step=1, save_steps=100)),
    }
    for name, (j_mod, t_mod, fn, cfg_cls, kw) in runs.items():
        errors = []
        for mod, pipe in ((j_mod, jax_pipe(params)),
                          (t_mod, port_pipe(params))):
            cfg = getattr(mod, cfg_cls)(instance_data_dir=inst,
                                        output_dir=str(tmp_path / name),
                                        **kw)
            with pytest.raises(Exception) as e:
                getattr(mod, fn)(pipe, cfg)
            errors.append((type(e.value), str(e.value)))
        assert errors[1] == errors[0], name
        assert errors[0][0] is ValueError
        assert "not supported for SDXL training" in errors[0][1]
