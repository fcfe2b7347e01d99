"""Convert legacy ``.pt`` LoRA / TI files into the single-file safetensors
format, the counterpart of lora_tpu/cli/pt_to_safetensors.py (the
reference's cli_pt_to_safetensors.py):

    python -m lora_tpu_torch.cli.pt_to_safetensors A.pt [B.text_encoder.pt
        C.ti.pt ...] --outpath OUT.safetensors [--overwrite]
        [--NAME.target_modules A,B] [--NAME.rank R]

File-type detection matches the reference: a ``.pt`` holding a dict is a
textual-inversion embed file, a list is a flat LoRA weight list. The model
name is derived from the reference's filename convention
(cli_pt_to_safetensors.py:57-58):

    lora_weight.pt               -> unet
    lora_weight.text_encoder.pt  -> text_encoder
    anything.NAME.pt             -> NAME

Per-model overrides: ``--NAME.target_modules A,B`` sets the serialized
target set; ``--NAME.rank 8`` is accepted as a cross-check against the
rank derived from the tensors (mismatch is an error). Defaults per model
name follow the reference's ``_target_by_name``
(cli_pt_to_safetensors.py:13-17).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from ..formats.safetensors_io import (
    DEFAULT_TARGET_REPLACE,
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    pairs_from_flat,
    save_safeloras_with_embeds,
)

DEFAULT_TARGETS_BY_NAME = {
    "unet": UNET_DEFAULT_TARGET_REPLACE,
    "text_encoder": TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
}


def model_name_for(path: str) -> str:
    """Reference filename convention (cli_pt_to_safetensors.py:57-58):
    the penultimate dot-component names the model, defaulting to unet."""
    parts = os.path.basename(path).split(".")
    return parts[-2] if len(parts) > 2 else "unet"


def _is_ti_file(obj) -> bool:
    return isinstance(obj, dict)


def convert(*modelpaths: str, outpath: str, overwrite: bool = False,
            **settings):
    """convert(path1, path2, ..., outpath=..., unet.rank=4,
    text_encoder.target_modules=CLIPAttention)"""
    if os.path.exists(outpath) and not overwrite:
        raise ValueError(
            f"Output path {outpath} already exists (pass --overwrite)"
        )

    modelmap: Dict[str, Tuple[Sequence, Iterable[str]]] = {}
    embeds: Dict[str, np.ndarray] = {}

    for path in modelpaths:
        # every file the trainers or lora_tpu write loads with
        # weights_only=True (formats/pt_io.py); nothing in a file runs code
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if _is_ti_file(obj):
            print(f"TI embeds {sorted(obj.keys())} from {path}")
            for token, tensor in obj.items():
                embeds[token] = tensor.detach().float().numpy()
            continue

        name = model_name_for(path)
        if name in modelmap:
            raise ValueError(
                f"Two LoRA files map to model name {name!r} "
                f"(second: {path}); rename one using the x.NAME.pt convention"
            )
        target = settings.get(
            f"{name}.target_modules",
            DEFAULT_TARGETS_BY_NAME.get(name, DEFAULT_TARGET_REPLACE),
        )
        if isinstance(target, str):
            target = [t.strip() for t in target.split(",")]
        # keep the stored dtype (fp16 from save_lora_weight) so converted
        # files match reference conversions byte-for-byte
        pairs = pairs_from_flat([w.detach().cpu().numpy() for w in obj])
        # rank is derived from the tensors themselves; accept the
        # reference-style --NAME.rank override only as a cross-check
        want_rank = settings.get(f"{name}.rank")
        if want_rank is not None:
            got = int(pairs[0][1].shape[0])  # down is (r, in[, kh, kw])
            if int(want_rank) != got:
                raise ValueError(
                    f"--{name}.rank {want_rank} does not match the file's "
                    f"actual rank {got}")
        print(f"LoRA model {name!r} from {path}: {len(pairs)} sites, "
              f"targets {sorted(target)}")
        modelmap[name] = (pairs, target)

    print(f"Saving weights to {outpath}")
    save_safeloras_with_embeds(modelmap, embeds, outpath)


def main():
    args = sys.argv[1:]
    paths = []
    kwargs = {}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
                i += 1
            elif (a[2:] in ("overwrite",)  # boolean flags never take a value
                  or i + 1 >= len(args) or args[i + 1].startswith("--")):
                k, v = a[2:], "true"
                i += 1
            else:
                k, v = a[2:], args[i + 1]
                i += 2
            kwargs[k] = v
        else:
            paths.append(a)
            i += 1
    outpath = kwargs.pop("outpath")
    overwrite = str(kwargs.pop("overwrite", "false")).lower() in (
        "true", "1", "yes", "")
    convert(*paths, outpath=outpath, overwrite=overwrite, **kwargs)


if __name__ == "__main__":
    main()
