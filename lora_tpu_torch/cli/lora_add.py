"""`lora_add`: merge, collapse and export LoRA files, the counterpart of
lora_tpu/cli/lora_add.py (the reference's cli_lora_add.py):

    python -m lora_tpu_torch.cli.lora_add PATH_1 PATH_2 OUTPUT_PATH \
        [--alpha_1 0.5] [--alpha_2 0.5] [--mode lpl] [--with_text_lora] \
        [--device cpu]

(installed as the console script lora_add_torch). Modes:
  lpl          LoRA + LoRA, per tensor alpha_1 * x1 + alpha_2 * x2: two .pt
               files (and their .text_encoder.pt with --with_text_lora) or
               two safetensors files (written fp16; TI embeds pass through)
  upl          a diffusers directory (PATH_1) with a LoRA file (PATH_2)
               folded in at alpha_1, written as a diffusers directory
  upl-ckpt-v2  the same, written as a CompVis .ckpt, with the file's TI
               embeds as an A1111 embedding .pt beside it
  ljl          LoRA join: the ranks concatenated, the TI tokens renamed

lpl and ljl are arithmetic on the files' arrays on the host, as in
lora_tpu; the upl modes load the base in f32 on `device` (the card unless
--device cpu), so the LoRA folds in f32.
"""

from __future__ import annotations

import os
from typing import Literal

import numpy as np
import torch

from ..formats import pt_io
from ..formats.reader import save_file
from ..formats.safetensors_io import safe_open
from ._fire import fire


def _lpl_pt(path_1, path_2, output_path, alpha_1, alpha_2,
            with_text_lora) -> None:
    pairs = [(path_1, path_2, "unet")]
    if with_text_lora:
        pairs.append((pt_io.text_lora_path(path_1),
                      pt_io.text_lora_path(path_2), "text_encoder"))
    for p1, p2, opt in pairs:
        if opt == "text_encoder" and not (
                os.path.exists(p1) and os.path.exists(p2)):
            print(f"No text encoder found in {p1}, skipping...")
            continue
        l1, l2 = pt_io.load_lora_pt(p1), pt_io.load_lora_pt(p2)
        merged = [alpha_1 * a + alpha_2 * b for a, b in zip(l1, l2)]
        out = (output_path if opt == "unet"
               else pt_io.text_lora_path(output_path))
        pt_io.save_lora_pt([(merged[2 * i], merged[2 * i + 1])
                            for i in range(len(merged) // 2)], out)
        print(f"Saving merged {opt} to {out}")


def _lpl_safetensors(path_1, path_2, output_path, alpha_1, alpha_2) -> None:
    s1, s2 = safe_open(path_1), safe_open(path_2)
    try:
        metadata = dict(s1.metadata())
        metadata.update(dict(s2.metadata()))
        ret = {}
        for key in set(list(s1.keys()) + list(s2.keys())):
            if key.startswith("text_encoder") or key.startswith("unet"):
                t1 = np.asarray(s1.get_tensor(key), np.float32)
                t2 = np.asarray(s2.get_tensor(key), np.float32)
                ret[key] = (alpha_1 * t1 + alpha_2 * t2).astype(np.float16)
            else:  # TI embeds pass through from whichever file has them
                src = s1 if key in s1.keys() else s2
                ret[key] = np.asarray(src.get_tensor(key))
        save_file(ret, output_path, metadata)
    finally:
        s1.close()
        s2.close()


def _upl(path_1, path_2, output_path, alpha_1, mode, device) -> None:
    from ..models.hf_import import save_pipeline_params
    from ..pipelines.sd import StableDiffusionPipeline

    print(f"Merging UNET/CLIP from {path_1} with LoRA from {path_2} to "
          f"{output_path}. Merging ratio : {alpha_1}.")
    if mode == "upl-ckpt-v2" and not output_path.endswith(".ckpt"):
        raise ValueError("Only .ckpt files are supported")
    pipe = StableDiffusionPipeline.from_pretrained(
        path_1, device=device, require_real_tokenizer=False)
    tok_dict = pipe.patch_pipe(path_2, patch_ti=(mode == "upl"))
    pipe.collapse_lora(alpha_1)
    if mode == "upl":
        save_pipeline_params(pipe, output_path)
        return
    from ..formats.ckpt_export import convert_to_ckpt

    name = os.path.basename(output_path)[:-5]
    print(f"You will be using {name} as the token in A1111 webui.")
    convert_to_ckpt(pipe, output_path, as_half=True)
    if tok_dict:
        cat = torch.stack([torch.from_numpy(np.array(tok_dict[k],
                                                     np.float32))
                           for k in sorted(tok_dict)])
        torch.save({"string_to_token": {"*": torch.tensor(265)},
                    "string_to_param": {"*": cat}, "name": name},
                   output_path[:-5] + ".pt")
        print(f"Textual embedding saved as {output_path[:-5]}.pt")


def _ljl(path_1, path_2, output_path) -> None:
    from ..lora_manager import lora_join

    print("Using Join mode : alpha will not have an effect here.")
    if not (path_1.endswith(".safetensors")
            and path_2.endswith(".safetensors")):
        raise ValueError("Only .safetensors files are supported")
    s1, s2 = safe_open(path_1), safe_open(path_2)
    try:
        total_tensor, total_metadata, _, _ = lora_join([s1, s2])
        save_file(total_tensor, output_path, total_metadata)
    finally:
        s1.close()
        s2.close()


def add(
    path_1: str,
    path_2: str,
    output_path: str,
    alpha_1: float = 0.5,
    alpha_2: float = 0.5,
    mode: Literal["lpl", "upl", "upl-ckpt-v2", "ljl"] = "lpl",
    with_text_lora: bool = False,
    device: str = "cuda",
):
    print("Lora Add, mode " + mode)
    if mode == "lpl":
        if path_1.endswith(".pt") and path_2.endswith(".pt"):
            _lpl_pt(path_1, path_2, output_path, alpha_1, alpha_2,
                    with_text_lora)
        elif path_1.endswith(".safetensors") and \
                path_2.endswith(".safetensors"):
            _lpl_safetensors(path_1, path_2, output_path, alpha_1, alpha_2)
        else:
            raise ValueError("lpl needs two .pt or two .safetensors files")
    elif mode in ("upl", "upl-ckpt-v2"):
        _upl(path_1, path_2, output_path, alpha_1, mode, device)
    elif mode == "ljl":
        _ljl(path_1, path_2, output_path)
    else:
        raise ValueError(f"Unknown mode {mode}")


def main():
    fire(add)


if __name__ == "__main__":
    main()
