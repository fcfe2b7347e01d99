"""`lora_distill`: SVD-distill a full fine-tune into a LoRA, the
counterpart of lora_tpu/cli/lora_distill.py (the reference's
cli_svd.py:95-146):

    python -m lora_tpu_torch.cli.lora_distill TARGET_MODEL BASE_MODEL \
        [--rank 4] [--clamp_quantile 0.99] [--save_path OUT.safetensors] \
        [--extended | --locon] [--from_lora] [--device cpu]

(installed as the console script lora_distill_torch). The directories load
in f32 on `device`, the card unless --device cpu, and the SVDs run there
(core/svd.py).
"""

from __future__ import annotations

import os

import torch

from ..core.save import save_all
from ..core.svd import svd_distill
from ..formats.safetensors_io import (
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    UNET_EXTENDED_TARGET_REPLACE,
)
from ._fire import fire


def _from_lora(target_model, is_xl, cfgs, bases, device):
    """The adapter file `target_model` loaded against the base params
    (kohya / LyCORIS, SD-1.x or XL) and folded into them: the tuned
    (unet, text, text2) params."""
    from ..core.lora import collapse_lora
    from ..core.sites import text_encoder_locon_sites, unet_locon_sites
    from ..formats.kohya import is_kohya_xl, load_kohya, load_kohya_xl
    from ..formats.lycoris import is_lycoris, load_lycoris, load_lycoris_xl
    from ..formats.reader import SafetensorsFile

    ucfg, tcfg, t2cfg = cfgs
    base_unet, base_text, base_text2 = bases
    with SafetensorsFile(target_model) as f:
        keys = list(f.keys())
    if not any(k.startswith(("lora_unet_", "lora_te_", "lora_te1_",
                             "lora_te2_")) for k in keys):
        raise ValueError(
            "--from_lora expects a kohya/LyCORIS-schema .safetensors "
            "adapter (lora_unet_*/lora_te*_ keys); reference-schema "
            "files are already plain (up, down) pairs")
    if is_xl != is_kohya_xl(keys):
        raise ValueError(
            f"--from_lora adapter schema "
            f"({'XL' if is_kohya_xl(keys) else 'SD1.x'}) does not match the "
            f"base model family ({'XL' if is_xl else 'SD1.x'})")
    kw = dict(unet_sites=unet_locon_sites(ucfg),
              text_sites=text_encoder_locon_sites(tcfg), device=device)
    base_kw = dict(unet_params=base_unet, text_params=base_text)
    lt2 = None
    if is_xl:
        kw.update(unet_cfg=ucfg, text2_sites=text_encoder_locon_sites(t2cfg))
        if is_lycoris(keys):
            lu, lt, lt2 = load_lycoris_xl(target_model, text2_params=base_text2,
                                          **base_kw, **kw)
        else:
            lu, lt, lt2 = load_kohya_xl(target_model, **kw)
    elif is_lycoris(keys):
        lu, lt = load_lycoris(target_model, **base_kw, **kw)
    else:
        lu, lt = load_kohya(target_model, **kw)
    for mname, t in (("unet", lu), ("text_encoder", lt),
                     ("text_encoder_2", lt2)):
        if t and t.get("param_deltas"):
            raise ValueError(
                f"--from_lora cannot convert this adapter: it carries "
                f"{len(t['param_deltas'])} norm/bias param deltas on "
                f"{mname} (LyCORIS norm/full modules) which plain "
                f"LoRA cannot represent")
    return tuple(collapse_lora(base, lora) if lora else base
                 for base, lora in ((base_unet, lu), (base_text, lt),
                                    (base_text2, lt2)))


def svd_distill_cli(
    target_model: str,
    base_model: str,
    rank: int = 4,
    clamp_quantile: float = 0.99,
    device: str = "cuda",
    save_path: str = "svd_distill.safetensors",
    extended: bool = False,
    locon: bool = False,
    from_lora: bool = False,
):
    """Distill TARGET_MODEL - BASE_MODEL (two diffusers directories) into a
    rank-`rank` LoRA over the default UNet and text sites, written as
    save_all writes it.

    `--extended` adds the resnet sites. `--locon` distills over the kohya /
    LoCon superset (every Linear / Conv2d of the transformer, resnet and
    resampler blocks and the CLIP MLP) and writes a kohya file.
    `--from_lora` takes TARGET_MODEL as a kohya / LyCORIS .safetensors
    adapter, folds it into BASE_MODEL and distills the result: any LyCORIS
    algorithm to a plain (up, down) LoRA. An SDXL base (a text_time UNet)
    distills over both text encoders and writes kohya-XL; --from_lora then
    takes kohya-XL and LyCORIS-XL files."""
    from ..core.sites import (
        text_encoder_locon_sites,
        text_encoder_lora_sites,
        unet_locon_sites,
        unet_lora_sites,
    )
    from ..models.hf_import import load_pipeline_params, load_text_encoder

    if locon and extended:
        raise ValueError(
            "--extended and --locon are conflicting target flags: locon "
            "already covers the extended (resnet/conv) sites via the kohya "
            "schema; pass exactly one")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"lora_distill runs on device={device!r} (the default) and no "
            f"CUDA device is available; pass --device cpu to run on the CPU")
    base_unet, base_text, _, (ucfg, tcfg, _) = load_pipeline_params(
        base_model, device=device)
    is_xl = ucfg.addition_embed_type == "text_time"
    base_text2 = t2cfg = tuned_text2 = None
    if is_xl:
        base_text2, t2cfg = load_text_encoder(
            os.path.join(base_model, "text_encoder_2"), device=device)
    if from_lora:
        tuned_unet, tuned_text, tuned_text2 = _from_lora(
            target_model, is_xl, (ucfg, tcfg, t2cfg),
            (base_unet, base_text, base_text2), device)
    else:
        tuned_unet, tuned_text, _, _ = load_pipeline_params(target_model,
                                                            device=device)
        if is_xl:
            tuned_text2, _ = load_text_encoder(
                os.path.join(target_model, "text_encoder_2"), device=device)

    if locon:
        usites = unet_locon_sites(ucfg)
        tsites = text_encoder_locon_sites(tcfg)
    else:
        # the reference injects the extended targets but saves the default
        # set (cli_svd.py:112 and save_all's default), so its resnet
        # factors never reach the file: distill what is saved. --extended
        # keeps them
        unet_targets = (UNET_EXTENDED_TARGET_REPLACE if extended
                        else UNET_DEFAULT_TARGET_REPLACE)
        usites = unet_lora_sites(ucfg, unet_targets)
        tsites = text_encoder_lora_sites(tcfg)

    print(f"SVD distilling {len(usites)} unet + {len(tsites)} text sites "
          f"at rank {rank}")
    lora_unet = svd_distill(base_unet, tuned_unet, usites, rank,
                            clamp_quantile)
    lora_text = svd_distill(base_text, tuned_text, tsites, rank,
                            clamp_quantile)
    if is_xl:
        from ..formats.kohya import save_kohya_xl

        t2sites = (text_encoder_locon_sites(t2cfg) if locon
                   else text_encoder_lora_sites(t2cfg))
        lora_text2 = svd_distill(base_text2, tuned_text2, t2sites, rank,
                                 clamp_quantile)
        save_kohya_xl(save_path, unet_cfg=ucfg, lora_unet=lora_unet,
                      unet_sites=usites, lora_text=lora_text,
                      text_sites=tsites, lora_text2=lora_text2,
                      text2_sites=t2sites)
    elif locon:
        from ..formats.kohya import save_kohya

        save_kohya(save_path, lora_unet=lora_unet, unet_sites=usites,
                   lora_text=lora_text, text_sites=tsites)
    else:
        save_all(save_path, lora_unet=lora_unet, unet_sites=usites,
                 lora_text=lora_text, text_sites=tsites, save_ti=False,
                 target_replace_module_unet=unet_targets,
                 target_replace_module_text=TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    print(f"Saved to {save_path}")


def main():
    fire(svd_distill_cli)


if __name__ == "__main__":
    main()
