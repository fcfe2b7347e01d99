"""The program under test, built from the benchmark's inputs: the port's
StableDiffusionPipeline over the benchmark's weights, with its LoRA + TI
file loaded through patch_pipe. The only module of the benchmark besides
the serving and training runners that imports the program."""

from __future__ import annotations

import dataclasses

import torch


def port_configs(cfg: dict):
    """The port's config objects that the configuration file names,
    checked against the published values in the file."""
    from lora_tpu_torch.models import config as pc

    u, t, v = (getattr(pc, cfg["port"][k])
               for k in ("unet", "text_encoder", "vae"))
    pu, pt, pv = cfg["unet"], cfg["text_encoder"], cfg["vae"]
    heads = pu.get("num_attention_heads") or pu["attention_head_dim"]
    n = len(pu["block_out_channels"])
    want = {
        "unet": (dataclasses.asdict(u), {
            "block_out_channels": tuple(pu["block_out_channels"]),
            "layers_per_block": pu["layers_per_block"],
            "cross_attention_dim": pu["cross_attention_dim"],
            "use_linear_projection": pu.get("use_linear_projection", False),
            "norm_num_groups": pu["norm_num_groups"],
            "norm_eps": pu["norm_eps"],
            "in_channels": pu["in_channels"],
            "out_channels": pu["out_channels"],
            "flip_sin_to_cos": pu["flip_sin_to_cos"],
            "freq_shift": pu["freq_shift"],
            "down_block_has_attn": tuple(b.startswith("CrossAttn")
                                         for b in pu["down_block_types"]),
            "up_block_has_attn": tuple(b.startswith("CrossAttn")
                                       for b in pu["up_block_types"])}),
        "text_encoder": (dataclasses.asdict(t), {
            k: pt[k] for k in ("vocab_size", "hidden_size",
                               "intermediate_size", "num_hidden_layers",
                               "num_attention_heads", "hidden_act",
                               "max_position_embeddings", "layer_norm_eps")}),
        "vae": (dataclasses.asdict(v), {
            "block_out_channels": tuple(pv["block_out_channels"]),
            "layers_per_block": pv["layers_per_block"],
            "latent_channels": pv["latent_channels"],
            "norm_num_groups": pv["norm_num_groups"],
            "scaling_factor": pv["scaling_factor"]}),
    }
    bad = [f"{m}.{k}: port {have.get(k)!r} != {w!r}"
           for m, (have, wants) in want.items() for k, w in wants.items()
           if have.get(k) != w]
    port_heads = u.num_attention_heads
    port_heads = (list(port_heads) if isinstance(port_heads, tuple)
                  else [port_heads] * n)
    if port_heads != (list(heads) if isinstance(heads, list) else [heads] * n):
        bad.append(f"unet heads: port {port_heads} != {heads}")
    if bad:
        raise ValueError("the port's config objects differ from the "
                         "configuration file: " + "; ".join(bad))
    return u, t, v


def build_pipe(cfg: dict, weights: dict, lora_path: str, lora_scale: float,
               dtype):
    """The port's pipeline holding `weights` (no copy), with the adapter
    file patched in at `lora_scale`."""
    from lora_tpu_torch.data.tokenizer import CLIPTokenizer
    from lora_tpu_torch.models.clip import CLIPTextModel
    from lora_tpu_torch.models.schedulers import make_schedule
    from lora_tpu_torch.models.unet import UNet
    from lora_tpu_torch.models.vae import VAE
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    ucfg, tcfg, vcfg = port_configs(cfg)
    mods = []
    for cls, c, model in ((UNet, ucfg, "unet"),
                          (CLIPTextModel, tcfg, "text_encoder"),
                          (VAE, vcfg, "vae")):
        m = cls(c, device="meta", dtype=dtype)
        m.load_state_dict(weights[model], strict=True, assign=True)
        mods.append(m)
    s = cfg["scheduler"]
    schedule = make_schedule(
        num_train_timesteps=s["num_train_timesteps"],
        beta_start=s["beta_start"], beta_end=s["beta_end"],
        beta_schedule=s["beta_schedule"],
        set_alpha_to_one=s["set_alpha_to_one"],
        steps_offset=s["steps_offset"],
        prediction_type=s.get("prediction_type", "epsilon"))
    pipe = StableDiffusionPipeline(
        *mods, CLIPTokenizer(vocab_size=tcfg.vocab_size), schedule=schedule)
    if lora_path is not None:
        pipe.patch_pipe(lora_path)
        pipe.tune_lora_scale(lora_scale)
    return pipe


def build_libraries(stems) -> None:
    """The CUDA libraries a cell launches, built (once per checkout) side
    by side before anything else runs."""
    from lora_tpu_torch.ops.build import build

    build(list(stems))


def flash_launches() -> dict:
    """The program's launch counters of its three flash wrappers."""
    from lora_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.flash_fwd.launches, "dq": fa.flash_bwd_dq.launches,
            "dkv": fa.flash_bwd_dkv.launches}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
