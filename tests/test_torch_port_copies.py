"""lora_tpu_torch's copies of lora_tpu's framework-free modules (configs,
structure, LoRA sites, tokenizer, safetensors reader/schema, the CLI flag
parser) stay equal to the originals, and the port imports no jax."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from lora_tpu.core import sites as j_sites  # noqa: E402
from lora_tpu.data import tokenizer as j_tok  # noqa: E402
from lora_tpu.formats import safetensors_io as j_st  # noqa: E402
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.models import structure as j_struct  # noqa: E402
from lora_tpu_torch.core import sites as t_sites  # noqa: E402
from lora_tpu_torch.data import tokenizer as t_tok  # noqa: E402
from lora_tpu_torch.formats import safetensors_io as t_st  # noqa: E402
from lora_tpu_torch.models import config as t_cfg  # noqa: E402
from lora_tpu_torch.models import structure as t_struct  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["models/config.py", "models/structure.py", "core/sites.py",
          "data/tokenizer.py", "formats/reader.py",
          "formats/safetensors_io.py", "cli/_fire.py"]
CONFIGS = sorted(
    n for n, v in vars(j_cfg).items()
    if isinstance(v, (j_cfg.UNetConfig, j_cfg.VAEConfig,
                      j_cfg.CLIPTextConfig)))
UNET_CONFIGS = [n for n in CONFIGS
                if isinstance(getattr(j_cfg, n), j_cfg.UNetConfig)]
TEXT_CONFIGS = [n for n in CONFIGS
                if isinstance(getattr(j_cfg, n), j_cfg.CLIPTextConfig)]
UNET_TARGETS = [None, j_st.UNET_DEFAULT_TARGET_REPLACE,
                j_st.UNET_EXTENDED_TARGET_REPLACE, {"GEGLU"},
                {"CrossAttention"}]


def _code_without_docstrings(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_has_the_original_code(rel):
    """Only comments and docstrings may differ."""
    assert (_code_without_docstrings(os.path.join(ROOT, "lora_tpu_torch", rel))
            == _code_without_docstrings(os.path.join(ROOT, "lora_tpu", rel)))


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_equal(name):
    j, t = getattr(j_cfg, name), getattr(t_cfg, name)
    assert type(j).__name__ == type(t).__name__
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("name", UNET_CONFIGS)
def test_structure_equal(name):
    j, t = getattr(j_cfg, name), getattr(t_cfg, name)
    assert j_struct.time_embed_dim(j) == t_struct.time_embed_dim(t)
    for fn in ("down_blocks", "up_blocks"):
        assert ([dataclasses.asdict(b) for b in getattr(j_struct, fn)(j)]
                == [dataclasses.asdict(b) for b in getattr(t_struct, fn)(t)])
    assert (dataclasses.asdict(j_struct.mid_block(j))
            == dataclasses.asdict(t_struct.mid_block(t)))


@pytest.mark.parametrize("name", UNET_CONFIGS)
def test_unet_sites_equal(name):
    j, t = getattr(j_cfg, name), getattr(t_cfg, name)
    for target in UNET_TARGETS:
        assert ([dataclasses.astuple(s) for s in j_sites.unet_lora_sites(j, target)]
                == [dataclasses.astuple(s)
                    for s in t_sites.unet_lora_sites(t, target)])
    assert ([dataclasses.astuple(s) for s in j_sites.unet_locon_sites(j)]
            == [dataclasses.astuple(s) for s in t_sites.unet_locon_sites(t)])


@pytest.mark.parametrize("name", TEXT_CONFIGS)
def test_text_sites_equal(name):
    j, t = getattr(j_cfg, name), getattr(t_cfg, name)
    for target in (None, j_st.TEXT_ENCODER_DEFAULT_TARGET_REPLACE):
        assert ([dataclasses.astuple(s)
                 for s in j_sites.text_encoder_lora_sites(j, target)]
                == [dataclasses.astuple(s)
                    for s in t_sites.text_encoder_lora_sites(t, target)])
    assert ([dataclasses.astuple(s) for s in j_sites.text_encoder_locon_sites(j)]
            == [dataclasses.astuple(s)
                for s in t_sites.text_encoder_locon_sites(t)])


@pytest.mark.parametrize("vocab_size", [1000, 49408])
def test_tokenizer_ids_equal(vocab_size):
    j = j_tok.CLIPTokenizer(vocab_size=vocab_size)
    t = t_tok.CLIPTokenizer(vocab_size=vocab_size)
    prompts = ["a photo of <s1> dog", "A  <s1> style town, <s2>!",
               "golden prompt", ""]
    assert j(prompts) == t(prompts)
    assert j.add_tokens(["<s1>", "<s2>"]) == t.add_tokens(["<s1>", "<s2>"])
    assert j.add_tokens("<s1>") == t.add_tokens("<s1>") == 0
    assert j(prompts) == t(prompts)
    assert (j.convert_tokens_to_ids("<s2>")
            == t.convert_tokens_to_ids("<s2>"))


def _lora_file_inputs(seed=0):
    rng = np.random.default_rng(seed)
    sites = j_sites.unet_lora_sites(j_cfg.TINY_UNET)
    pairs = []
    for s in sites[:6]:
        r = 4
        up = rng.standard_normal((s.out_dim, r)).astype(np.float32)
        down = rng.standard_normal((r, s.in_dim)).astype(np.float32)
        pairs.append((up, down))
    tsites = j_sites.text_encoder_lora_sites(j_cfg.TINY_TEXT)
    tpairs = [(rng.standard_normal((s.out_dim, 4)).astype(np.float32),
               rng.standard_normal((4, s.in_dim)).astype(np.float32))
              for s in tsites]
    embeds = {"<s1>": rng.standard_normal(32).astype(np.float32),
              "<s2>": rng.standard_normal(32).astype(np.float32)}
    modelmap = {"unet": (pairs, j_st.UNET_DEFAULT_TARGET_REPLACE),
                "text_encoder": (tpairs,
                                 j_st.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)}
    return modelmap, embeds


@pytest.mark.parametrize("cast_fp16", [False, True])
def test_lora_file_parses_and_writes_identically(tmp_path, cast_fp16):
    modelmap, embeds = _lora_file_inputs()
    j_path = str(tmp_path / "j.safetensors")
    t_path = str(tmp_path / "t.safetensors")
    j_st.save_safeloras_with_embeds(modelmap, embeds, j_path, cast_fp16)
    t_st.save_safeloras_with_embeds(modelmap, embeds, t_path, cast_fp16)
    with open(j_path, "rb") as a, open(t_path, "rb") as b:
        assert a.read() == b.read()

    j_loras, j_embeds = j_st.load_safeloras_both(j_path)
    t_loras, t_embeds = t_st.load_safeloras_both(j_path)
    assert sorted(j_loras) == sorted(t_loras) == ["text_encoder", "unet"]
    for model in j_loras:
        jw, jr, jt = j_loras[model]
        tw, tr, tt = t_loras[model]
        assert jr == tr and jt == tt and len(jw) == len(tw)
        for a, b in zip(jw, tw):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert sorted(j_embeds) == sorted(t_embeds) == ["<s1>", "<s2>"]
    for k in j_embeds:
        np.testing.assert_array_equal(j_embeds[k], t_embeds[k])


def test_port_imports_no_jax():
    modules = ["lora_tpu_torch", "lora_tpu_torch.convert",
               "lora_tpu_torch.cli._fire", "lora_tpu_torch.cli.lora_db",
               "lora_tpu_torch.cli.lora_pti", "lora_tpu_torch.cli.lora_ti",
               "lora_tpu_torch.cli.lora_add",
               "lora_tpu_torch.cli.lora_distill",
               "lora_tpu_torch.cli.pt_to_safetensors",
               "lora_tpu_torch.cli.kohya_convert",
               "lora_tpu_torch.launch", "lora_tpu_torch.lora_manager",
               "lora_tpu_torch.parallel", "lora_tpu_torch.parallel.mesh",
               "lora_tpu_torch.core.lora", "lora_tpu_torch.core.quantize",
               "lora_tpu_torch.core.save", "lora_tpu_torch.core.sites",
               "lora_tpu_torch.core.svd",
               "lora_tpu_torch.data.dataset", "lora_tpu_torch.data.png",
               "lora_tpu_torch.data.preprocess",
               "lora_tpu_torch.data.tokenizer",
               "lora_tpu_torch.formats.ckpt_export",
               "lora_tpu_torch.formats.kohya",
               "lora_tpu_torch.formats.lycoris",
               "lora_tpu_torch.formats.pt_io",
               "lora_tpu_torch.formats.reader",
               "lora_tpu_torch.formats.safetensors_io",
               "lora_tpu_torch.models.clip",
               "lora_tpu_torch.models.clip_vision",
               "lora_tpu_torch.models.config",
               "lora_tpu_torch.models.hf_import",
               "lora_tpu_torch.models.layers",
               "lora_tpu_torch.models.schedulers",
               "lora_tpu_torch.models.structure",
               "lora_tpu_torch.models.unet", "lora_tpu_torch.models.vae",
               "lora_tpu_torch.native", "lora_tpu_torch.native.build",
               "lora_tpu_torch.ops.attention", "lora_tpu_torch.ops.build",
               "lora_tpu_torch.ops.flash_attention",
               "lora_tpu_torch.ops.int8_matmul",
               "lora_tpu_torch.ops.adam8bit",
               "lora_tpu_torch.pipelines.sd",
               "lora_tpu_torch.pipelines.sdxl", "lora_tpu_torch.serve",
               "lora_tpu_torch.training.checkpoint",
               "lora_tpu_torch.training.dreambooth",
               "lora_tpu_torch.training.loss",
               "lora_tpu_torch.training.optim",
               "lora_tpu_torch.training.pti",
               "lora_tpu_torch.training.ti_legacy",
               "lora_tpu_torch.training.train_step",
               "lora_tpu_torch.utils.eval",
               "lora_tpu_torch.utils.metrics",
               "lora_tpu_torch.utils.profiling"]
    # ... and none imports Pillow or transformers at import time (the
    # card's machine has neither; the dataset imports Pillow only for a
    # JPEG, utils/eval.py transformers only for a local CLIP checkpoint)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'lora_tpu',\n"
            "                                    'PIL', 'transformers'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
