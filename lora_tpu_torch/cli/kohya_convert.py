"""Convert between cloneofsimo-format and kohya-ss/webui-format LoRA
safetensors (direction auto-detected from the input's key schema), the
counterpart of lora_tpu/cli/kohya_convert.py:

    python -m lora_tpu_torch.cli.kohya_convert in.safetensors out.safetensors

(installed as the console script lora_kohya_torch). The conversion is file
arithmetic on the host.

cloneofsimo -> kohya drops TI embeds (the kohya schema has no embed slot;
export those separately via pt/safetensors) and prints a notice. Site
order/rank metadata round-trips losslessly for the module sets both
formats cover. See formats/kohya.py for the key mapping.
"""

from __future__ import annotations

import sys

from ..formats.kohya import load_kohya, save_kohya
from ..formats.reader import SafetensorsFile
from ..formats.safetensors_io import (
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    UNET_EXTENDED_TARGET_REPLACE,
    parse_safeloras,
    parse_safeloras_embeds,
    save_safeloras_with_embeds,
)


def convert(inpath: str, outpath: str, unet_cfg=None, text_cfg=None) -> None:
    from ..core.lora import lora_from_flat, lora_to_pairs
    from ..core.sites import text_encoder_lora_sites, unet_lora_sites
    from ..models import config as _cfg

    SD15_UNET = unet_cfg or _cfg.SD15_UNET
    SD15_TEXT = text_cfg or _cfg.SD15_TEXT

    with SafetensorsFile(inpath) as f:
        is_kohya = any(k.startswith(("lora_unet_", "lora_te_"))
                       for k in f.keys())

    if is_kohya:
        usites = unet_lora_sites(SD15_UNET, UNET_EXTENDED_TARGET_REPLACE)
        tsites = text_encoder_lora_sites(SD15_TEXT)
        lu, lt = load_kohya(inpath, unet_sites=usites, text_sites=tsites)
        modelmap = {}
        if lu is not None:
            covered = set(lu["sites"])
            # the flat cloneofsimo format encodes site identity by POSITION
            # in a target-set traversal — only exact set matches serialize
            target = None
            for cand in (UNET_DEFAULT_TARGET_REPLACE,
                         UNET_EXTENDED_TARGET_REPLACE):
                cand_sites = unet_lora_sites(SD15_UNET, cand)
                if covered == {s.name for s in cand_sites}:
                    target, usites = cand, cand_sites
                    break
            if target is None:
                raise ValueError(
                    "kohya file covers a module subset that does not match "
                    "a cloneofsimo target set (DEFAULT or EXTENDED); the "
                    "flat positional format cannot represent it")
            modelmap["unet"] = (lora_to_pairs(lu, usites), target)
        if lt is not None:
            covered = set(lt["sites"])
            if covered != {s.name for s in tsites}:
                raise ValueError(
                    "kohya file covers a text-encoder module subset; the "
                    "flat positional format cannot represent it")
            modelmap["text_encoder"] = (lora_to_pairs(lt, tsites),
                                        TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
        save_safeloras_with_embeds(modelmap, {}, outpath)
        print(f"kohya -> cloneofsimo: wrote {sorted(modelmap)} to {outpath}")
    else:
        with SafetensorsFile(inpath) as f:
            loras = parse_safeloras(f)
            embeds = parse_safeloras_embeds(f)
        kw = {}
        if "unet" in loras:
            weights, _, target = loras["unet"]
            kw["unet_sites"] = unet_lora_sites(SD15_UNET, set(target))
            kw["lora_unet"] = lora_from_flat(weights, kw["unet_sites"])
        if "text_encoder" in loras:
            weights, _, target = loras["text_encoder"]
            kw["text_sites"] = text_encoder_lora_sites(SD15_TEXT)
            kw["lora_text"] = lora_from_flat(weights, kw["text_sites"])
        save_kohya(outpath, **kw)
        if embeds:
            print(f"note: {len(embeds)} TI embed(s) dropped — the kohya "
                  "schema has no embed slot")
        print(f"cloneofsimo -> kohya: wrote {sorted(k for k in kw if k.startswith('lora'))} to {outpath}")


def main():
    if "--help" in sys.argv[1:] or "-h" in sys.argv[1:]:
        print("usage: lora_kohya_torch IN.safetensors OUT.safetensors\n")
        print(__doc__)
        return
    if len(sys.argv) != 3:
        print(__doc__)
        raise SystemExit(2)
    convert(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()
