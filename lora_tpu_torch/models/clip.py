"""CLIP text encoder (SD-1.x ViT-L/14, SD-2.x OpenCLIP export) in PyTorch.

The counterpart of lora_tpu/models/clip.py: pre-LN transformer with a causal
mask, quick-GELU or GELU, final LayerNorm; param names match the HF
state_dict so a converted checkpoint loads unchanged. Textual-inversion rows
are written over the token table at forward time (`apply_ti`), or into a
grown table by the pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.quantize import dequantize_weight
from ..ops.attention import attention
from ..parallel import tensor as tp_lib
from .config import CLIPTextConfig
from .layers import Initializer, ParamModule, Params, dense, gelu, layer_norm
from .layers import quick_gelu

# hidden_act values published in the SD text-encoder configs
_ACTS = {"quick_gelu": quick_gelu, "gelu": gelu}
_ATTN = (".q_proj.weight", ".k_proj.weight", ".v_proj.weight",
         ".out_proj.weight")


def init_clip_text(cfg: CLIPTextConfig, generator: Optional[torch.Generator],
                   *, device, dtype=torch.float32) -> Params:
    """Random-init params, the JAX package's draws: N(0, 0.02) linears and
    token table, N(0, 0.01) positions (uninitialised without a generator)."""
    d, ff, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    ini = Initializer(generator, device, dtype)
    p = ini.p

    def lin(name, i, o, std=0.02):
        p[name + ".weight"] = ini.normal((o, i), std)
        p[name + ".bias"] = ini.zeros((o,))

    p["text_model.embeddings.token_embedding.weight"] = ini.normal(
        (cfg.vocab_size, d), 0.02)
    p["text_model.embeddings.position_embedding.weight"] = ini.normal(
        (cfg.max_position_embeddings, d), 0.01)
    for i in range(L):
        base = f"text_model.encoder.layers.{i}"
        ini.norm(base + ".layer_norm1", d)
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            lin(f"{base}.self_attn.{proj}", d, d)
        ini.norm(base + ".layer_norm2", d)
        lin(base + ".mlp.fc1", d, ff)
        lin(base + ".mlp.fc2", ff, d)
    ini.norm("text_model.final_layer_norm", d)
    if cfg.projection_dim is not None:
        # CLIPTextModelWithProjection (SDXL text_encoder_2): bias-free
        p["text_projection.weight"] = ini.normal((cfg.projection_dim, d),
                                                 d ** -0.5)
    return p


def apply_ti(params: Params, ti_embeds: Optional[torch.Tensor],
             ti_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """The token-embedding table with TI rows written in (a copy).
    ti_embeds: (K, D); ti_ids: (K,) token ids."""
    table = params["text_model.embeddings.token_embedding.weight"]
    if ti_embeds is None:
        return table
    table = table.clone()
    table[ti_ids] = ti_embeds.to(table.dtype)
    return table


def clip_text_forward(
    params: Params,
    input_ids: torch.Tensor,  # (B, T) integer
    cfg: CLIPTextConfig,
    lora=None,
    ti_embeds: Optional[torch.Tensor] = None,
    ti_ids: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    penultimate: bool = False,
    pooled_eos_id: Optional[int] = None,
):
    """last_hidden_state (B, T, D) after the final LayerNorm, what SD's
    conditioning consumes. penultimate=True returns the second-to-last
    layer's state without the final norm (clip skip 2). pooled_eos_id
    returns (hidden, pooled): the final-normed state at each row's first
    eos, through text_projection when the config has one (dequantized if
    int8, where lora_tpu reads the int8 codes as they are)."""
    B, T = input_ids.shape
    d = cfg.hidden_size
    h = cfg.num_attention_heads
    dh = d // h
    act = _ACTS[cfg.hidden_act]

    table = apply_ti(params, ti_embeds, ti_ids)
    pos = params["text_model.embeddings.position_embedding.weight"][:T]
    x = (table[input_ids] + pos[None]).to(dtype)

    def heads(y):  # (B, T, h' * dh) -> (B, h', T, dh), h' = h / tp if split
        return y.reshape(B, T, -1, dh).transpose(1, 2)

    def unheads(y):
        return y.transpose(1, 2).reshape(B, T, -1)

    penult = None
    for i in range(cfg.num_hidden_layers):
        if i == cfg.num_hidden_layers - 1:
            penult = x  # input to the last layer = hidden_states[-2]
            if penultimate and pooled_eos_id is None:
                break  # the last layer's output is never consumed
        base = f"text_model.encoder.layers.{i}"
        res = x
        y = layer_norm(params, base + ".layer_norm1", x, cfg.layer_norm_eps)
        sa = base + ".self_attn"
        # tensor parallelism (parallel/tensor.py): the rank's heads when
        # the attention splits, its hidden features when the MLP does
        mesh = tp_lib.split_block(params, [sa + n for n in _ATTN], h)
        split = None
        if mesh is not None:
            split = "column"
            y = tp_lib.copy_to_tp(y, mesh)
        q = heads(dense(params, sa + ".q_proj", y, lora, split))
        k = heads(dense(params, sa + ".k_proj", y, lora, split))
        v = heads(dense(params, sa + ".v_proj", y, lora, split))
        att = unheads(attention(q, k, v, causal=True))
        x = res + dense(params, sa + ".out_proj", att, lora,
                        "row" if split else None)

        res = x
        y = layer_norm(params, base + ".layer_norm2", x, cfg.layer_norm_eps)
        mesh = tp_lib.split_block(params, [base + ".mlp.fc1.weight",
                                           base + ".mlp.fc2.weight"])
        split = None
        if mesh is not None:
            split = "column"
            y = tp_lib.copy_to_tp(y, mesh)
        y = act(dense(params, base + ".mlp.fc1", y, lora, split))
        x = res + dense(params, base + ".mlp.fc2", y, lora,
                        "row" if split else None)

    hidden = (penult if penultimate
              else layer_norm(params, "text_model.final_layer_norm", x,
                              cfg.layer_norm_eps))
    if pooled_eos_id is None:
        return hidden
    final = layer_norm(params, "text_model.final_layer_norm", x,
                       cfg.layer_norm_eps)
    eos_pos = (input_ids == pooled_eos_id).int().argmax(dim=-1)
    pooled = final[torch.arange(B, device=final.device), eos_pos]
    if "text_projection.weight" in params:
        pooled = pooled @ dequantize_weight(
            params, "text_projection.weight", pooled.dtype).T
    return hidden, pooled


def dual_encode(text_params, text2_params, ids1: torch.Tensor,
                ids2: torch.Tensor, text_cfg: CLIPTextConfig,
                text2_cfg: CLIPTextConfig, lora1=None, lora2=None,
                dtype=torch.float32, eos_id: int = 49407
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDXL's conditioning from both encoders' token ids (flat params):
    (context (B, T, d1 + d2), pooled (B, projection_dim)), te1's and te2's
    penultimate states joined on the last axis (te2's cast to te1's dtype)
    and te2's projected pooled state at each row's first `eos_id`. The
    pipeline's prompts and the trainer's loss and text cache all encode
    through it."""
    h1 = clip_text_forward(text_params, ids1, text_cfg, lora=lora1,
                           dtype=dtype, penultimate=True)
    h2, pooled = clip_text_forward(text2_params, ids2, text2_cfg, lora=lora2,
                                   dtype=dtype, penultimate=True,
                                   pooled_eos_id=eos_id)
    return torch.cat([h1, h2.to(h1.dtype)], dim=-1), pooled


class CLIPTextModel(ParamModule):
    def __init__(self, cfg: CLIPTextConfig, *, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(init_clip_text(cfg, generator, device=device,
                                        dtype=dtype))
        self.cfg = cfg

    def forward(self, input_ids, lora=None, dtype=torch.float32, **kw):
        return clip_text_forward(self.flat_params(), input_ids, self.cfg,
                                 lora=lora, dtype=dtype, **kw)
