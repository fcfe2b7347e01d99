"""The port's pivotal tuning trainer against lora_tpu's with masks and
other LoRA targets (the seams and checks of tests/test_torch_port_pti.py):
face-segmentation masks that the datasets write themselves (the ellipse
fallback: mediapipe is on neither machine) at mask_temperature 0.5 with
the extended UNet targets, and LoCon targets, whose kohya file and A1111
embedding sidecar lora_tpu's loaders read back."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_locon_sites,
    unet_locon_sites,
)
from lora_tpu.formats.kohya import load_kohya  # noqa: E402
from lora_tpu.formats.pt_io import load_a1111_embedding  # noqa: E402
from lora_tpu.models.config import TINY_TEXT, TINY_UNET  # noqa: E402
from lora_tpu_torch.data.png import _png_decode  # noqa: E402

from test_torch_port_pti import (  # noqa: E402, F401
    BASE,
    TREE_REL_L2,
    _one_torch_thread,
    base_params,
    check_same_run,
    metrics,
    rel_l2,
    run_both,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

CASES = {
    "face_masks": dict(use_face_segmentation_condition=True,
                       mask_temperature=0.5, use_extended_lora=True),
    "locon": dict(lora_targets="locon", train_text_encoder=True),
}


@pytest.fixture(scope="module")
def params():
    return base_params()


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    out = {}
    for case, flags in CASES.items():
        root = tmp_path_factory.mktemp(case)
        out[case] = (root,) + run_both(dict(BASE, **flags), params, root)
    return out


def test_face_masks_match_jax(runs):
    """The trainer with the masks each dataset wrote: the same run, and
    the same {i}.mask.png bytes (lora_tpu writes them through Pillow, the
    port through data/png.py, each with its own blur)."""
    root, j_res, t_res, j_out, t_out = runs["face_masks"]
    names = check_same_run("face_masks", j_res, t_res, j_out, t_out)
    assert "final_lora.safetensors" in names
    masks = sorted(f for f in os.listdir(root / "inst_jax")
                   if f.endswith(".mask.png"))
    assert masks == ["0.mask.png", "1.mask.png", "2.mask.png"]
    assert sorted(f for f in os.listdir(root / "inst_torch")
                  if f.endswith(".mask.png")) == masks
    for m in masks:
        got, want = (_png_decode((root / d / m).read_bytes())
                     for d in ("inst_torch", "inst_jax"))
        np.testing.assert_array_equal(got, want)
        assert want[32, 32, 0] > want[0, 0, 0]  # a soft centered ellipse


def test_locon_files_read_back_by_lora_tpu(runs):
    """LoCon targets: the same run; the port's kohya file loads through
    lora_tpu's load_kohya on the LoCon sites, and its .embeds.pt sidecar
    through lora_tpu's load_a1111_embedding, within the trees' tolerance
    of lora_tpu's own files."""
    _, j_res, t_res, j_out, t_out = runs["locon"]
    names = check_same_run("locon", j_res, t_res, j_out, t_out)
    assert {"final_lora.safetensors", "final_lora.embeds.pt",
            "step_2.safetensors", "step_2.embeds.pt",
            "step_inv_2.safetensors"} <= set(names)
    us, ts = unet_locon_sites(TINY_UNET), text_encoder_locon_sites(TINY_TEXT)
    (ju, jt), (tu, tt) = (load_kohya(str(d / "final_lora.safetensors"),
                                     unet_sites=us, text_sites=ts)
                          for d in (j_out, t_out))
    for got, want in ((tu, ju), (tt, jt)):
        assert sorted(got["sites"]) == sorted(want["sites"])
        pairs = [(got["sites"][s][k], want["sites"][s][k])
                 for s in want["sites"] for k in want["sites"][s]]
        assert rel_l2(*zip(*pairs)) <= TREE_REL_L2 + 2 ** -11
    (jn, je), (tn, te) = (load_a1111_embedding(str(d / "final_lora.embeds.pt"))
                          for d in (j_out, t_out))
    assert tn == jn == "final_lora" and sorted(te) == sorted(je)
    assert rel_l2([te[k] for k in je], list(je.values())) <= TREE_REL_L2
    assert [r["phase"] for r in metrics(t_out / "metrics.jsonl")] == [
        "inversion", "inversion", "tune", "tune"]
