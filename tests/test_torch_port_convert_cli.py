"""The port's format converters (lora_tpu_torch/cli/pt_to_safetensors.py and
cli/kohya_convert.py) against lora_tpu's on the tiny configs: the same
output bytes from the same inputs (the .pt files' model names from their
file names, TI dicts, the stored fp16 dtype kept; kohya files both ways,
extended targets, embeds dropped with the notice), where a default target
set is written, up to that set's order; the --NAME.rank cross-check, the
target override, the overwrite and name-collision refusals, and the
command lines."""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from lora_tpu.cli import kohya_convert as j_kc  # noqa: E402
from lora_tpu.cli import pt_to_safetensors as j_pts  # noqa: E402
from lora_tpu_torch.cli import kohya_convert as t_kc  # noqa: E402
from lora_tpu_torch.cli import pt_to_safetensors as t_pts  # noqa: E402
from lora_tpu_torch.core.sites import (  # noqa: E402
    text_encoder_lora_sites,
    unet_lora_sites,
)
from lora_tpu_torch.formats import pt_io  # noqa: E402
from lora_tpu_torch.formats.reader import load_file  # noqa: E402
from lora_tpu_torch.formats.safetensors_io import (  # noqa: E402
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    UNET_EXTENDED_TARGET_REPLACE,
    load_safeloras_both,
    save_safeloras_with_embeds,
)
from lora_tpu_torch.models.config import TINY_TEXT, TINY_UNET  # noqa: E402

USITES = unet_lora_sites(TINY_UNET)
XSITES = unet_lora_sites(TINY_UNET, UNET_EXTENDED_TARGET_REPLACE)
TSITES = text_encoder_lora_sites(TINY_TEXT)


def _pairs(sites, seed, r=2):
    rng = np.random.default_rng(seed)
    out = []
    for s in sites:
        k = (1, 1) if s.kind == "conv" else ()
        kk = tuple(s.kernel) if s.kind == "conv" else ()
        out.append(((0.1 * rng.standard_normal((s.out_dim, r) + k)),
                    rng.standard_normal((r, s.in_dim) + kk)))
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def pt_files(tmp_path):
    """The legacy trainer's three files: lora_weight.pt,
    lora_weight.text_encoder.pt (fp16 lists) and lora_weight.ti.pt."""
    paths = {"unet": str(tmp_path / "lora_weight.pt"),
             "text": str(tmp_path / "lora_weight.text_encoder.pt"),
             "ti": str(tmp_path / "lora_weight.ti.pt"),
             "custom": str(tmp_path / "extra.custom.pt")}
    pt_io.save_lora_pt(_pairs(USITES, 1), paths["unet"])
    pt_io.save_lora_pt(_pairs(TSITES, 2), paths["text"])
    pt_io.save_lora_pt(_pairs(TSITES[:2], 3, r=3), paths["custom"])
    rng = np.random.default_rng(4)
    pt_io.save_ti_pt({"<s1>": rng.standard_normal(32),
                      "<s2>": rng.standard_normal(32)}, paths["ti"])
    return paths


def test_model_names():
    for path, name in (("/x/lora_weight.pt", "unet"),
                       ("lora_weight.text_encoder.pt", "text_encoder"),
                       ("a/b.custom.pt", "custom")):
        assert t_pts.model_name_for(path) == j_pts.model_name_for(path) == \
            name


def targets_as_sets(path):
    """A file's metadata with each model's target list as a set: the
    default targets are Python sets in both packages, written in the set's
    order, which follows the hash of each module's compiled constants."""
    _, meta = load_file(path)
    return {k: (frozenset(json.loads(v)) if v.startswith("[") else v)
            for k, v in meta.items()}


@pytest.mark.parametrize("which", [("unet", "text", "ti"), ("unet",),
                                   ("ti", "custom", "text")])
@pytest.mark.parametrize("targets", ["given", "default"])
def test_pt_to_safetensors_bytes(pt_files, tmp_path, which, targets):
    """Targets given in order: the same bytes as lora_tpu's file. Default
    targets: the same tensors, and the same metadata up to the order of
    each target set."""
    ins = [pt_files[w] for w in which]
    kw = {"custom.target_modules": "CLIPAttention,CLIPMLP"}
    if targets == "given":
        kw.update({"unet.target_modules": "GEGLU,CrossAttention,Attention",
                   "text_encoder.target_modules": "CLIPAttention"})
    j_pts.convert(*ins, outpath=str(tmp_path / "j.safetensors"), **kw)
    t_pts.convert(*ins, outpath=str(tmp_path / "t.safetensors"), **kw)
    if targets == "given":
        assert _bytes(tmp_path / "j.safetensors") == \
            _bytes(tmp_path / "t.safetensors")
    tj, _ = load_file(str(tmp_path / "j.safetensors"))
    tt, _ = load_file(str(tmp_path / "t.safetensors"))
    assert list(tt) == list(tj)
    assert all(np.array_equal(tt[k], tj[k]) and tt[k].dtype == tj[k].dtype
               for k in tj)
    assert targets_as_sets(str(tmp_path / "t.safetensors")) == \
        targets_as_sets(str(tmp_path / "j.safetensors"))
    loras, embeds = load_safeloras_both(str(tmp_path / "t.safetensors"))
    want = {"unet": "unet", "text": "text_encoder", "custom": "custom"}
    assert set(loras) == {want[w] for w in which if w in want}
    assert set(embeds) == ({"<s1>", "<s2>"} if "ti" in which else set())
    for model, (flat, ranks, target) in loras.items():
        assert all(w.dtype == np.float16 for w in flat)  # stored dtype kept
        if model == "custom":
            assert ranks == [3, 3] and target == ["CLIPAttention",
                                                  "CLIPMLP"]


def test_pt_to_safetensors_checks(pt_files, tmp_path):
    out = str(tmp_path / "o.safetensors")
    t_pts.convert(pt_files["unet"], outpath=out, **{"unet.rank": 2})
    for mod in (j_pts, t_pts):
        with pytest.raises(ValueError, match="already exists"):
            mod.convert(pt_files["unet"], outpath=out)
        with pytest.raises(ValueError, match=r"--unet.rank 99 does not "
                                             r"match the file's actual rank "
                                             r"2"):
            mod.convert(pt_files["unet"], outpath=out, overwrite=True,
                        **{"unet.rank": 99})
    dup = tmp_path / "sub"
    dup.mkdir()
    pt_io.save_lora_pt(_pairs(USITES, 5), str(dup / "lora_weight.pt"))
    with pytest.raises(ValueError, match="map to model name 'unet'"):
        t_pts.convert(pt_files["unet"], str(dup / "lora_weight.pt"),
                      outpath=str(tmp_path / "d.safetensors"))


def test_pt_to_safetensors_command_line(pt_files, tmp_path, monkeypatch):
    """The bare --overwrite flag in any position, --NAME.rank as a value."""
    out = str(tmp_path / "cli.safetensors")
    for argv in (["prog", pt_files["unet"], "--outpath", out],
                 ["prog", pt_files["unet"], "--outpath", out, "--overwrite",
                  "--unet.rank", "2"],
                 ["prog", "--overwrite", pt_files["unet"], pt_files["ti"],
                  "--outpath", out]):
        monkeypatch.setattr(sys, "argv", argv)
        t_pts.main()
    assert set(load_safeloras_both(out)[1]) == {"<s1>", "<s2>"}


@pytest.mark.parametrize("sites,target", [
    (USITES, UNET_DEFAULT_TARGET_REPLACE),
    (XSITES, UNET_EXTENDED_TARGET_REPLACE)])
def test_kohya_convert_both_ways(tmp_path, capsys, sites, target):
    """cloneofsimo -> kohya (TI embeds dropped with lora_tpu's notice) and
    kohya -> cloneofsimo (the target set recovered from the sites), each
    as lora_tpu's output: the same bytes, the way back up to its target
    set's order."""
    native = str(tmp_path / "native.safetensors")
    save_safeloras_with_embeds(
        {"unet": ([(u.astype(np.float32), d.astype(np.float32))
                   for u, d in _pairs(sites, 7)], target),
         "text_encoder": ([(u.astype(np.float32), d.astype(np.float32))
                           for u, d in _pairs(TSITES, 8)],
                          TEXT_ENCODER_DEFAULT_TARGET_REPLACE)},
        {"<t>": np.ones(32, np.float32)}, native, cast_fp16=True)
    kw = dict(unet_cfg=TINY_UNET, text_cfg=TINY_TEXT)
    for tag, mod in (("j", j_kc), ("t", t_kc)):
        mod.convert(native, str(tmp_path / f"{tag}_k.safetensors"), **kw)
        out = capsys.readouterr().out
        assert "note: 1 TI embed(s) dropped" in out
        mod.convert(str(tmp_path / f"{tag}_k.safetensors"),
                    str(tmp_path / f"{tag}_back.safetensors"), **kw)
    assert _bytes(tmp_path / "j_k.safetensors") == \
        _bytes(tmp_path / "t_k.safetensors")
    # back in the cloneofsimo schema: the target sets are written in set
    # order (targets_as_sets), the tensors as lora_tpu's
    tj, _ = load_file(str(tmp_path / "j_back.safetensors"))
    tt, _ = load_file(str(tmp_path / "t_back.safetensors"))
    assert list(tt) == list(tj)
    assert all(np.array_equal(tt[k], tj[k]) and tt[k].dtype == tj[k].dtype
               for k in tj)
    assert targets_as_sets(str(tmp_path / "t_back.safetensors")) == \
        targets_as_sets(str(tmp_path / "j_back.safetensors"))
    a, _ = load_safeloras_both(native)
    b, _ = load_safeloras_both(str(tmp_path / "t_back.safetensors"))
    assert set(a) == set(b) == {"unet", "text_encoder"}
    for model in a:
        assert a[model][1] == b[model][1]
        assert set(a[model][2]) == set(b[model][2])
        for x, y in zip(a[model][0], b[model][0]):
            np.testing.assert_array_equal(np.asarray(y, np.float16), x)


def test_kohya_convert_refusals_and_command_line(tmp_path, monkeypatch,
                                                 capsys):
    """A kohya file over a module subset no cloneofsimo target set matches
    is refused with lora_tpu's message; the command line takes exactly two
    paths."""
    from lora_tpu_torch.core.lora import lora_from_pairs
    from lora_tpu_torch.formats.kohya import save_kohya

    part = str(tmp_path / "part.safetensors")
    save_kohya(part, lora_unet=lora_from_pairs(_pairs(USITES[:3], 9),
                                               USITES[:3]),
               unet_sites=USITES[:3])
    kw = dict(unet_cfg=TINY_UNET, text_cfg=TINY_TEXT)
    msgs = []
    for mod in (j_kc, t_kc):
        with pytest.raises(ValueError) as e:
            mod.convert(part, str(tmp_path / "x.safetensors"), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "flat positional format" in msgs[1]
    monkeypatch.setattr(sys, "argv", ["lora_kohya_torch", part])
    with pytest.raises(SystemExit) as e:
        t_kc.main()
    assert e.value.code == 2
    monkeypatch.setattr(sys, "argv", ["lora_kohya_torch", "--help"])
    t_kc.main()
    assert "usage: lora_kohya_torch" in capsys.readouterr().out
