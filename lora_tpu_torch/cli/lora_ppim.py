"""`lora_ppim`: build a mask-captioned dataset from a folder of images, the
counterpart of lora_tpu/cli/lora_ppim.py:

    python -m lora_tpu_torch.cli.lora_ppim FILES OUTPUT_DIR \
        [--caption_text "a photo of"] [--target_prompts "a face"] \
        [--target_size 512] [--use_face_detection_instead] [--temp 1.0] \
        [--n_length -1] [--device cpu] [--seed 0]

(installed as the console script lora_ppim_torch). FILES is a directory or
a glob. BLIP, CLIPSeg and Swin2SR run from $LORA_TPU_AUX_MODELS/{blip,
clipseg,swin2sr} on the card unless --device cpu; without them each stage
falls back as lora_tpu's does. Writing {i}.src.jpg needs Pillow.
"""

from __future__ import annotations

from ..data.preprocess import load_and_save_masks_and_captions
from ._fire import fire


def main():
    fire(load_and_save_masks_and_captions)


if __name__ == "__main__":
    main()
