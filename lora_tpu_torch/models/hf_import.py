"""Import HF diffusers/transformers checkpoints into flat param dicts of
tensors, and export them back: the counterpart of
lora_tpu/models/hf_import.py.

The param keys ARE the diffusers/transformers state_dict keys (torch weight
layout), so import is an identity mapping plus:
  - legacy VAE AttentionBlock names (query/key/value/proj_attn) -> modern
    to_q/to_k/to_v/to_out.0 (and (C,C) <- (C,C,1,1) squeeze where needed)
  - a cast to the requested compute dtype, on the requested device.
Weights come from safetensors (the port's own reader, formats/reader.py) or
torch .bin shards (torch.load(weights_only=True)).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..formats.reader import SafetensorsFile
from .config import CLIPTextConfig, UNetConfig, VAEConfig

Params = Dict[str, torch.Tensor]

_VAE_LEGACY = {
    ".query.": ".to_q.",
    ".key.": ".to_k.",
    ".value.": ".to_v.",
    ".proj_attn.": ".to_out.0.",
}


def _load_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    for fname in (
        "diffusion_pytorch_model.safetensors",
        "model.safetensors",
        "diffusion_pytorch_model.bin",
        "pytorch_model.bin",
    ):
        path = os.path.join(model_dir, fname)
        if not os.path.exists(path):
            continue
        if fname.endswith(".safetensors"):
            with SafetensorsFile(path) as f:
                return {k: np.array(f.get_tensor(k)) for k in f.keys()}
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no model weights found under {model_dir}")


def _to_params(sd: Dict[str, np.ndarray], dtype, device) -> Params:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device=device,
                                                            dtype=dtype)
            for k, v in sd.items()}


def _read_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def load_unet(model_dir: str, dtype=torch.float32,
              device="cpu") -> Tuple[Params, UNetConfig]:
    cfg_json = _read_config(model_dir)
    down_types = cfg_json["down_block_types"]
    up_types = cfg_json["up_block_types"]
    # diffusers' attention_head_dim actually holds num_heads: the SD1.x
    # configs publish the int 8 (8 heads), the SD2.x configs a per-block
    # list (5, 10, 20, 20); SDXL publishes num_attention_heads: null and the
    # head counts under attention_head_dim; an explicit num_attention_heads
    # wins if present
    head_dim = cfg_json.get("attention_head_dim", 8)
    head_dim = cfg_json.get("num_attention_heads") or head_dim
    num_heads = (tuple(int(h) for h in head_dim)
                 if isinstance(head_dim, (list, tuple)) else int(head_dim))
    tx = cfg_json.get("transformer_layers_per_block", 1)
    tx = (tuple(int(t) for t in tx)
          if isinstance(tx, (list, tuple)) else int(tx))
    cfg = UNetConfig(
        sample_size=cfg_json.get("sample_size", 64),
        in_channels=cfg_json.get("in_channels", 4),
        out_channels=cfg_json.get("out_channels", 4),
        block_out_channels=tuple(cfg_json["block_out_channels"]),
        down_block_has_attn=tuple(t.startswith("CrossAttn") for t in down_types),
        up_block_has_attn=tuple(t.startswith("CrossAttn") for t in up_types),
        layers_per_block=cfg_json.get("layers_per_block", 2),
        num_attention_heads=num_heads,
        transformer_layers=tx,
        cross_attention_dim=cfg_json.get("cross_attention_dim", 768),
        use_linear_projection=cfg_json.get("use_linear_projection", False),
        norm_num_groups=cfg_json.get("norm_num_groups", 32),
        freq_shift=cfg_json.get("freq_shift", 0),
        flip_sin_to_cos=cfg_json.get("flip_sin_to_cos", True),
        addition_embed_type=cfg_json.get("addition_embed_type"),
        addition_time_embed_dim=cfg_json.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=cfg_json.get(
            "projection_class_embeddings_input_dim"),
    )
    return _to_params(_load_state_dict(model_dir), dtype, device), cfg


def load_upcast_attention(model_dir: str) -> bool:
    """The UNet config's upcast_attention (the published SD-2.1 768-v config
    sets it): diffusers then computes the attention logits and softmax in
    f32. Both of the port's attention routes already do
    (ops/attention.py's plain path in f32, the flash kernels' f32 softmax
    and logsumexp), so the flag moves no arithmetic; the pipeline keeps it
    on its UNet only to write the directory back as it was read."""
    return bool(_read_config(model_dir).get("upcast_attention", False))


def load_vae(model_dir: str, dtype=torch.float32,
             device="cpu") -> Tuple[Params, VAEConfig]:
    cfg_json = _read_config(model_dir)
    cfg = VAEConfig(
        in_channels=cfg_json.get("in_channels", 3),
        out_channels=cfg_json.get("out_channels", 3),
        latent_channels=cfg_json.get("latent_channels", 4),
        block_out_channels=tuple(cfg_json["block_out_channels"]),
        layers_per_block=cfg_json.get("layers_per_block", 2),
        norm_num_groups=cfg_json.get("norm_num_groups", 32),
        scaling_factor=cfg_json.get("scaling_factor", 0.18215),
    )
    out: Dict[str, np.ndarray] = {}
    for k, v in _load_state_dict(model_dir).items():
        for old, new in _VAE_LEGACY.items():
            if old in k:
                k = k.replace(old, new)
                if v.ndim == 4 and v.shape[2:] == (1, 1):
                    v = v[:, :, 0, 0]  # legacy 1x1-conv attn proj -> linear
                break
        out[k] = v
    return _to_params(out, dtype, device), cfg


def load_text_encoder(model_dir: str, dtype=torch.float32,
                      device="cpu") -> Tuple[Params, CLIPTextConfig]:
    cfg_json = _read_config(model_dir)
    cfg = CLIPTextConfig(
        vocab_size=cfg_json.get("vocab_size", 49408),
        hidden_size=cfg_json.get("hidden_size", 768),
        intermediate_size=cfg_json.get("intermediate_size", 3072),
        num_hidden_layers=cfg_json.get("num_hidden_layers", 12),
        num_attention_heads=cfg_json.get("num_attention_heads", 12),
        max_position_embeddings=cfg_json.get("max_position_embeddings", 77),
        hidden_act=cfg_json.get("hidden_act", "quick_gelu"),
        # SD1.x text configs also carry projection_dim but ship NO
        # projection weights (architectures: CLIPTextModel); only the
        # WithProjection export (SDXL text_encoder_2) has the extra matmul
        projection_dim=(cfg_json.get("projection_dim")
                        if "CLIPTextModelWithProjection"
                        in cfg_json.get("architectures", []) else None),
    )
    sd = {k: v for k, v in _load_state_dict(model_dir).items()
          if not k.endswith("position_ids")}  # buffer, not a weight
    return _to_params(sd, dtype, device), cfg


def load_scheduler_config(path: str):
    """A NoiseSchedule from scheduler/scheduler_config.json if present, the
    default schedule otherwise."""
    from .schedulers import make_schedule

    cfg_path = os.path.join(path, "scheduler", "scheduler_config.json")
    if not os.path.exists(cfg_path):
        return make_schedule()
    with open(cfg_path) as f:
        c = json.load(f)
    return make_schedule(
        num_train_timesteps=c.get("num_train_timesteps", 1000),
        beta_start=c.get("beta_start", 0.00085),
        beta_end=c.get("beta_end", 0.012),
        beta_schedule=c.get("beta_schedule", "scaled_linear"),
        set_alpha_to_one=c.get("set_alpha_to_one", False),
        steps_offset=c.get("steps_offset", 1),
        prediction_type=c.get("prediction_type", "epsilon"),
    )


def load_pipeline_params(path: str, dtype=torch.float32, device="cpu"):
    """A diffusers-layout pipeline directory (unet/ vae/ text_encoder/) ->
    (unet params, text params, vae params, (unet, text, vae configs))."""
    unet_p, unet_cfg = load_unet(os.path.join(path, "unet"), dtype, device)
    vae_p, vae_cfg = load_vae(os.path.join(path, "vae"), dtype, device)
    text_p, text_cfg = load_text_encoder(os.path.join(path, "text_encoder"),
                                         dtype, device)
    return unet_p, text_p, vae_p, (unet_cfg, text_cfg, vae_cfg)


def _unet_config_dict(u: UNetConfig, upcast_attention: bool = False) -> dict:
    return {
        "_class_name": "UNet2DConditionModel",
        "sample_size": u.sample_size, "in_channels": u.in_channels,
        "out_channels": u.out_channels,
        "block_out_channels": list(u.block_out_channels),
        "layers_per_block": u.layers_per_block,
        "attention_head_dim": (list(u.num_attention_heads)
                               if isinstance(u.num_attention_heads, tuple)
                               else u.num_attention_heads),
        "transformer_layers_per_block": (
            list(u.transformer_layers)
            if isinstance(u.transformer_layers, tuple)
            else u.transformer_layers),
        "cross_attention_dim": u.cross_attention_dim,
        "use_linear_projection": u.use_linear_projection,
        # written where set (SD-2.1 768-v), as diffusers defaults it to
        # false: other directories keep lora_tpu's keys
        **({"upcast_attention": True} if upcast_attention else {}),
        "norm_num_groups": u.norm_num_groups,
        "freq_shift": u.freq_shift, "flip_sin_to_cos": u.flip_sin_to_cos,
        **({"addition_embed_type": u.addition_embed_type,
            "addition_time_embed_dim": u.addition_time_embed_dim,
            "projection_class_embeddings_input_dim":
                u.projection_class_embeddings_input_dim}
           if u.addition_embed_type else {}),
        "down_block_types": [
            "CrossAttnDownBlock2D" if a else "DownBlock2D"
            for a in u.down_block_has_attn],
        "up_block_types": [
            "CrossAttnUpBlock2D" if a else "UpBlock2D"
            for a in u.up_block_has_attn],
    }


def _vae_config_dict(v: VAEConfig) -> dict:
    return {
        "_class_name": "AutoencoderKL",
        "in_channels": v.in_channels, "out_channels": v.out_channels,
        "latent_channels": v.latent_channels,
        "block_out_channels": list(v.block_out_channels),
        "layers_per_block": v.layers_per_block,
        "norm_num_groups": v.norm_num_groups,
        "scaling_factor": v.scaling_factor,
        "down_block_types": ["DownEncoderBlock2D"] * len(v.block_out_channels),
        "up_block_types": ["UpDecoderBlock2D"] * len(v.block_out_channels),
    }


def _text_config_dict(t: CLIPTextConfig) -> dict:
    return {
        "architectures": (["CLIPTextModelWithProjection"]
                          if t.projection_dim is not None
                          else ["CLIPTextModel"]),
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "max_position_embeddings": t.max_position_embeddings,
        "hidden_act": t.hidden_act,
        **({"projection_dim": t.projection_dim}
           if t.projection_dim is not None else {}),
    }


def save_pipeline_params(pipe, path: str, fp16: bool = False) -> None:
    """Export a pipeline to a diffusers-layout directory (safetensors
    weights + config.json per model, scheduler_config.json; an SDXL pipe's
    text_encoder_2/ too) that load_pipeline_params and the JAX package's
    loader read back."""
    from ..formats.reader import save_file

    os.makedirs(path, exist_ok=True)
    dt = torch.float16 if fp16 else torch.float32

    def dump(sub: str, module, cfg_dict: dict):
        d = os.path.join(path, sub)
        os.makedirs(d, exist_ok=True)
        # cast where the tensors live: from the card, fp16 crosses to the
        # host at half the bytes (rounded to nearest even on either side)
        sd = {k: v.detach().to(dt).cpu().numpy()
              for k, v in module.state_dict().items()}
        fname = ("model.safetensors" if sub.startswith("text_encoder")
                 else "diffusion_pytorch_model.safetensors")
        save_file(sd, os.path.join(d, fname))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg_dict, f, indent=2)

    dump("unet", pipe.unet, _unet_config_dict(pipe.unet.cfg,
                                              pipe.unet.upcast_attention))
    dump("vae", pipe.vae, _vae_config_dict(pipe.vae.cfg))
    dump("text_encoder", pipe.text_encoder,
         _text_config_dict(pipe.text_encoder.cfg))
    if getattr(pipe, "text_encoder_2", None) is not None:
        # SDXL's second encoder, under text_encoder_2/ as diffusers saves it
        dump("text_encoder_2", pipe.text_encoder_2,
             _text_config_dict(pipe.text_encoder_2.cfg))
    sd_dir = os.path.join(path, "scheduler")
    os.makedirs(sd_dir, exist_ok=True)
    s = pipe.schedule
    with open(os.path.join(sd_dir, "scheduler_config.json"), "w") as f:
        json.dump({
            "_class_name": "DDPMScheduler",
            "num_train_timesteps": s.num_train_timesteps,
            "beta_start": 0.00085, "beta_end": 0.012,
            "beta_schedule": "scaled_linear",
            "set_alpha_to_one": s.final_alpha_cumprod == 1.0,
            "steps_offset": s.steps_offset,
            "prediction_type": s.prediction_type,
        }, f, indent=2)
