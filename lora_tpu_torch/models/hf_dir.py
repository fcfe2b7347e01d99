"""Read a `transformers` checkpoint directory without `transformers`: the
preprocessing towers (models/blip.py, models/clipseg.py, models/swin2sr.py)
load the directories lora_tpu's from_pretrained loads.

A directory holds config.json, the weights as model.safetensors (read by
formats/reader.py) or pytorch_model.bin (torch.load(weights_only=True), so
a file that pickles more than tensors is refused, not executed), and
preprocessor_config.json. config.json is written as a diff against the
config class's defaults, so each tower's config dataclass carries
transformers' defaults and `config_from_dict` fills only the keys present.

Parameter names are the state-dict names. `load_params` loads strictly:
every parameter the tower reads must be in the file with its shape, and
the file may hold nothing else, apart from the buffers transformers
rebuilds at load (position_ids, Swin's relative position tables) and the
keys a tower declares tied.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..data import resample
from ..formats.reader import SafetensorsFile
from .layers import gelu, quick_gelu

Params = Dict[str, torch.Tensor]

# buffers that transformers rebuilds at load and older checkpoints persist
_BUFFERS = ("position_ids", "relative_position_index",
            "relative_coords_table")

# the environment variable naming a directory with one checkpoint
# directory per model (blip/, clipseg/, swin2sr/), lora_tpu's lookup
AUX_MODELS_ENV = "LORA_TPU_AUX_MODELS"


def aux_model_dir(name: str) -> Optional[str]:
    """$LORA_TPU_AUX_MODELS/<name> when it is a directory, else None."""
    base = os.environ.get(AUX_MODELS_ENV)
    if base and os.path.isdir(os.path.join(base, name)):
        return os.path.join(base, name)
    return None


def check_device(device, what: str) -> torch.device:
    """The device as a torch.device; asked for the card without one,
    raise rather than run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on device={str(device)!r} (the default) and no "
            f"CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def read_json(model_dir: str, name: str, required: bool = True) -> dict:
    path = os.path.join(model_dir, name)
    if not os.path.exists(path):
        if required:
            raise FileNotFoundError(f"{model_dir}: no {name}")
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def config_from_dict(cls, d: dict, **overrides):
    """A config dataclass from a config.json dict: transformers' defaults
    (the dataclass's) where the file is silent, lists as tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d.items() if k in names}
    kw.update(overrides)
    return cls(**kw)


def _state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        with SafetensorsFile(st) as f:
            return {k: torch.from_numpy(np.array(f.get_tensor(k)))
                    for k in f.keys()}
    pt = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(pt):
        return dict(torch.load(pt, map_location="cpu", weights_only=True))
    raise FileNotFoundError(
        f"{model_dir}: no model.safetensors or pytorch_model.bin")


def load_params(model_dir: str, expected: Dict[str, Tuple[int, ...]], *,
                device, dtype=torch.float32,
                tied: Iterable[str] = ()) -> Params:
    """The directory's weights as {name: tensor} on `device` in `dtype`,
    held strictly to `expected` ({name: shape}). Keys in `tied` may be in
    the file or not (the tower rebuilds them) and are dropped."""
    sd = _state_dict(model_dir)
    tied = set(tied)
    sd = {k: v for k, v in sd.items()
          if k not in tied and k.rsplit(".", 1)[-1] not in _BUFFERS}
    missing = sorted(set(expected) - set(sd))
    unexpected = sorted(set(sd) - set(expected))
    wrong = sorted(k for k in set(expected) & set(sd)
                   if tuple(sd[k].shape) != tuple(expected[k]))
    if missing or unexpected or wrong:
        raise ValueError(
            f"{model_dir}: the weights do not match the config: "
            f"missing {missing[:8]}{' ...' if len(missing) > 8 else ''}, "
            f"unexpected {unexpected[:8]}"
            f"{' ...' if len(unexpected) > 8 else ''}, wrong shape "
            + ", ".join(f"{k} {tuple(sd[k].shape)} != {tuple(expected[k])}"
                        for k in wrong[:8]))
    return {k: v.to(device=device, dtype=dtype) for k, v in sd.items()}


_ACTS = {"gelu": gelu, "quick_gelu": quick_gelu, "relu": torch.relu}


def act_fn(name: str):
    """transformers' ACT2FN for the activations these towers use."""
    if name not in _ACTS:
        raise ValueError(f"hidden_act {name!r} is not one of {sorted(_ACTS)}")
    return _ACTS[name]


def processor_size(size) -> Tuple[int, int]:
    """(height, width) of an image processor's resize "size":
    {"height", "width"} or one int."""
    if isinstance(size, dict):
        if "height" not in size:
            raise ValueError(f"image processor size {size!r}: only "
                             "height/width sizes are supported")
        return int(size["height"]), int(size["width"])
    return int(size), int(size)


def image_pixels(img: np.ndarray, pre: dict, *, size: Tuple[int, int],
                 resample_filter: int, mean, std) -> np.ndarray:
    """A (H, W, 3) uint8 image through a transformers image processor
    (BlipImageProcessor, ViTImageProcessor): resized by Pillow's filter
    (data/resample.py), rescaled in float64 and cast to float32, then
    (x - mean) / std in float32. (h, w, 3) float32, channels last."""
    x = np.asarray(img)
    if pre.get("do_resize", True):
        h, w = processor_size(pre["size"]) if "size" in pre else size
        x = resample.resize(x, (w, h), int(pre.get("resample",
                                                   resample_filter)))
    if pre.get("do_rescale", True):
        x = (x.astype(np.float64) * pre.get("rescale_factor", 1 / 255))
    x = x.astype(np.float32)
    if pre.get("do_normalize", True):
        m = np.asarray(pre.get("image_mean", mean), np.float32)
        s = np.asarray(pre.get("image_std", std), np.float32)
        x = (x - m) / s
    return x


def shapes(params: Params) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in params.items()}
