"""BLIP image captioning in PyTorch, without `transformers`: the
counterpart of BlipForConditionalGeneration and BlipProcessor, which
lora_tpu's blip_captioning_dataset (lora_tpu/data/preprocess.py:81-104)
runs on the host.

The tower: a ViT (patch conv with bias, class token, learned positions,
pre-LN blocks with one fused qkv projection, the post-LN applied to every
token) and a BERT decoder (post-LN blocks: causal self-attention,
cross-attention to the image tokens, GELU MLP) with the LM head tied to
the word embeddings. Param keys are the checkpoint's state-dict keys, so a
directory lora_tpu's from_pretrained reads loads strictly (models/hf_dir.py).

`generate` is transformers' sampling loop as BLIP calls it
(modeling_blip.py generate): the prompt's first id overwritten with the
decoder's bos, its trailing [SEP] dropped (no prompt: [bos]), tokens drawn
until sep_token_id (the stop token BLIP passes as eos) with finished rows
padded with pad_token_id, and max_length counting the prompt. Each step's
scores go through the processors transformers builds, in its order:
repetition penalty and minimum length from the directory's generation
config, then temperature, top-k and top-p. Draws come from an explicit
torch.Generator (torch.multinomial on the softmax, as transformers draws
from the global one); greedy decoding takes the argmax. The self-attention
keys and values are cached across steps and the cross-attention ones are
computed once per image.

No attention here reaches the flash kernels: the vision tower's 577 tokens
(384 px, patch 16) and the decoder's causal and cross-attention fail their
shape rule, so every call takes ops/attention.py's plain path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data import resample
from ..data.bert_tokenizer import BertTokenizer
from ..ops.attention import attention
from . import hf_dir
from .layers import Initializer, Params, dense, layer_norm


@dataclasses.dataclass(frozen=True)
class BlipVisionConfig:
    """transformers' BlipVisionConfig defaults."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 384
    patch_size: int = 16
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    """transformers' BlipTextConfig defaults."""
    vocab_size: int = 30524
    hidden_size: int = 768
    encoder_hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    bos_token_id: int = 30522
    eos_token_id: int = 2
    sep_token_id: int = 102
    pad_token_id: int = 0
    tie_word_embeddings: bool = True
    position_embedding_type: str = "absolute"


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    vision: BlipVisionConfig = BlipVisionConfig()
    text: BlipTextConfig = BlipTextConfig()


# Salesforce/blip-image-captioning-large: a ViT-L/16 at 384 px and a
# BERT-base decoder cross-attending to its 1024-wide tokens
BLIP_LARGE = BlipConfig(
    vision=BlipVisionConfig(hidden_size=1024, intermediate_size=4096,
                            num_hidden_layers=24, num_attention_heads=16),
    text=BlipTextConfig(num_attention_heads=12, encoder_hidden_size=1024))

# the processor's defaults (BlipImageProcessor: OpenAI CLIP's statistics)
BLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
BLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

_TIED = ("text_decoder.cls.predictions.decoder.bias",)
_TIED_WEIGHT = "text_decoder.cls.predictions.decoder.weight"


def config_from_json(d: dict) -> BlipConfig:
    """BlipConfig from config.json: the text tower cross-attends to the
    vision tower's width, as transformers' BlipConfig sets it."""
    vision = hf_dir.config_from_dict(BlipVisionConfig,
                                     d.get("vision_config") or {})
    text = hf_dir.config_from_dict(BlipTextConfig, d.get("text_config") or {},
                                   encoder_hidden_size=vision.hidden_size)
    if text.position_embedding_type != "absolute":
        raise ValueError("BLIP's text position_embedding_type "
                         f"{text.position_embedding_type!r} is not supported")
    return BlipConfig(vision, text)


def config_to_json(cfg: BlipConfig) -> dict:
    return {"architectures": ["BlipForConditionalGeneration"],
            "model_type": "blip",
            "vision_config": dataclasses.asdict(cfg.vision),
            "text_config": dataclasses.asdict(cfg.text)}


def init_blip(cfg: BlipConfig, generator: Optional[torch.Generator], *,
              device, dtype=torch.float32) -> Params:
    """Random-init params (N(0, 0.02) weights and embeddings, zero biases,
    unit norms; uninitialised without a generator)."""
    ini = Initializer(generator, device, dtype)
    p = ini.p

    def lin(name, i, o):
        p[name + ".weight"] = ini.normal((o, i), 0.02)
        p[name + ".bias"] = ini.zeros((o,))

    v, t = cfg.vision, cfg.text
    d, n_pos = v.hidden_size, (v.image_size // v.patch_size) ** 2 + 1
    base = "vision_model"
    p[base + ".embeddings.class_embedding"] = ini.normal((1, 1, d), 0.02)
    p[base + ".embeddings.patch_embedding.weight"] = ini.normal(
        (d, 3, v.patch_size, v.patch_size), 0.02)
    p[base + ".embeddings.patch_embedding.bias"] = ini.zeros((d,))
    p[base + ".embeddings.position_embedding"] = ini.normal((1, n_pos, d),
                                                            0.02)
    for i in range(v.num_hidden_layers):
        b = f"{base}.encoder.layers.{i}"
        ini.norm(b + ".layer_norm1", d)
        lin(b + ".self_attn.qkv", d, 3 * d)
        lin(b + ".self_attn.projection", d, d)
        ini.norm(b + ".layer_norm2", d)
        lin(b + ".mlp.fc1", d, v.intermediate_size)
        lin(b + ".mlp.fc2", v.intermediate_size, d)
    ini.norm(base + ".post_layernorm", d)

    h = t.hidden_size
    base = "text_decoder.bert"
    p[base + ".embeddings.word_embeddings.weight"] = ini.normal(
        (t.vocab_size, h), 0.02)
    p[base + ".embeddings.position_embeddings.weight"] = ini.normal(
        (t.max_position_embeddings, h), 0.02)
    ini.norm(base + ".embeddings.LayerNorm", h)
    for i in range(t.num_hidden_layers):
        b = f"{base}.encoder.layer.{i}"
        for att, kv_in in (("attention", h),
                           ("crossattention", t.encoder_hidden_size)):
            lin(f"{b}.{att}.self.query", h, h)
            lin(f"{b}.{att}.self.key", kv_in, h)
            lin(f"{b}.{att}.self.value", kv_in, h)
            lin(f"{b}.{att}.output.dense", h, h)
            ini.norm(f"{b}.{att}.output.LayerNorm", h)
        lin(b + ".intermediate.dense", h, t.intermediate_size)
        lin(b + ".output.dense", t.intermediate_size, h)
        ini.norm(b + ".output.LayerNorm", h)
    head = "text_decoder.cls.predictions"
    lin(head + ".transform.dense", h, h)
    ini.norm(head + ".transform.LayerNorm", h)
    p[head + ".bias"] = ini.zeros((t.vocab_size,))
    if not t.tie_word_embeddings:
        p[_TIED_WEIGHT] = ini.normal((t.vocab_size, h), 0.02)
    return p


# -- the towers --------------------------------------------------------------

def vision_forward(params: Params, pixel_values: torch.Tensor,
                   cfg: BlipVisionConfig) -> torch.Tensor:
    """pixel_values (B, H, W, 3), normalised -> image tokens (B, 1 + N, D)
    after the post-LN (BlipVisionModel's last_hidden_state)."""
    B = pixel_values.shape[0]
    d, nh = cfg.hidden_size, cfg.num_attention_heads
    act = hf_dir.act_fn(cfg.hidden_act)
    e = "vision_model.embeddings"
    x = F.conv2d(pixel_values.permute(0, 3, 1, 2),
                 params[e + ".patch_embedding.weight"],
                 params[e + ".patch_embedding.bias"], stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([params[e + ".class_embedding"].expand(B, 1, d), x], 1)
    x = x + params[e + ".position_embedding"][:, :x.shape[1]]
    for i in range(cfg.num_hidden_layers):
        b = f"vision_model.encoder.layers.{i}"
        y = layer_norm(params, b + ".layer_norm1", x, cfg.layer_norm_eps)
        qkv = dense(params, b + ".self_attn.qkv", y)
        q, k, v = qkv.reshape(B, -1, 3, nh, d // nh).permute(2, 0, 3, 1, 4)
        att = attention(q, k, v).transpose(1, 2).reshape(B, -1, d)
        x = x + dense(params, b + ".self_attn.projection", att)
        y = layer_norm(params, b + ".layer_norm2", x, cfg.layer_norm_eps)
        x = x + dense(params, b + ".mlp.fc2",
                      act(dense(params, b + ".mlp.fc1", y)))
    return layer_norm(params, "vision_model.post_layernorm", x,
                      cfg.layer_norm_eps)


def _heads(y: torch.Tensor, nh: int) -> torch.Tensor:
    B, T, d = y.shape
    return y.reshape(B, T, nh, d // nh).transpose(1, 2)


def cross_cache(params: Params, image_embeds: torch.Tensor,
                cfg: BlipTextConfig) -> List[tuple]:
    """Each decoder layer's cross-attention keys and values of the image
    tokens, (B, heads, N, dh) each."""
    nh = cfg.num_attention_heads
    out = []
    for i in range(cfg.num_hidden_layers):
        c = f"text_decoder.bert.encoder.layer.{i}.crossattention.self"
        out.append((_heads(dense(params, c + ".key", image_embeds), nh),
                    _heads(dense(params, c + ".value", image_embeds), nh)))
    return out


def decoder_forward(params: Params, input_ids: torch.Tensor,
                    cross: List[tuple], cfg: BlipTextConfig,
                    past: Optional[List[tuple]] = None):
    """Logits (B, T, vocab) of input_ids (B, T) at positions len(past)...,
    and the self-attention keys and values of every position so far."""
    B, T = input_ids.shape
    nh, eps = cfg.num_attention_heads, cfg.layer_norm_eps
    act = hf_dir.act_fn(cfg.hidden_act)
    start = 0 if past is None else past[0][0].shape[2]
    e = "text_decoder.bert.embeddings"
    table = params[e + ".word_embeddings.weight"]
    x = table[input_ids] + params[e + ".position_embeddings.weight"][
        start:start + T]
    x = layer_norm(params, e + ".LayerNorm", x, eps)

    def unheads(y):
        return y.transpose(1, 2).reshape(B, T, -1)

    new_past = []
    for i in range(cfg.num_hidden_layers):
        b = f"text_decoder.bert.encoder.layer.{i}"
        s = b + ".attention.self"
        q = _heads(dense(params, s + ".query", x), nh)
        k = _heads(dense(params, s + ".key", x), nh)
        v = _heads(dense(params, s + ".value", x), nh)
        if past is not None:
            k = torch.cat([past[i][0], k], 2)
            v = torch.cat([past[i][1], v], 2)
        new_past.append((k, v))
        att = unheads(attention(q, k, v, causal=True))
        x = layer_norm(params, b + ".attention.output.LayerNorm",
                       dense(params, b + ".attention.output.dense", att) + x,
                       eps)
        q = _heads(dense(params, b + ".crossattention.self.query", x), nh)
        att = unheads(attention(q, cross[i][0], cross[i][1]))
        x = layer_norm(params, b + ".crossattention.output.LayerNorm",
                       dense(params, b + ".crossattention.output.dense", att)
                       + x, eps)
        y = act(dense(params, b + ".intermediate.dense", x))
        x = layer_norm(params, b + ".output.LayerNorm",
                       dense(params, b + ".output.dense", y) + x, eps)
    h = "text_decoder.cls.predictions"
    y = layer_norm(params, h + ".transform.LayerNorm",
                   act(dense(params, h + ".transform.dense", x)), eps)
    w = table if cfg.tie_word_embeddings else params[_TIED_WEIGHT]
    return F.linear(y, w, params[h + ".bias"]), new_past


def caption_logits(params: Params, pixel_values: torch.Tensor,
                   input_ids: torch.Tensor, cfg: BlipConfig) -> torch.Tensor:
    """BlipForConditionalGeneration(pixel_values, input_ids).logits:
    (B, T, vocab), every position in one pass (teacher forcing)."""
    image = vision_forward(params, pixel_values, cfg.vision)
    return decoder_forward(params, input_ids,
                           cross_cache(params, image, cfg.text), cfg.text)[0]


# -- generation --------------------------------------------------------------

# generation-config keys and the values at which they do nothing; a
# directory that sets one of them otherwise is refused, not ignored
_GEN_INERT = {"no_repeat_ngram_size": 0, "encoder_no_repeat_ngram_size": 0,
              "bad_words_ids": None, "forced_bos_token_id": None,
              "forced_eos_token_id": None, "suppress_tokens": None,
              "begin_suppress_tokens": None, "min_new_tokens": None,
              "exponential_decay_length_penalty": None, "min_p": None,
              "typical_p": 1.0, "epsilon_cutoff": 0.0, "eta_cutoff": 0.0,
              "num_beams": 1, "guidance_scale": None,
              "sequence_bias": None, "renormalize_logits": False,
              "remove_invalid_values": False, "num_return_sequences": 1,
              "encoder_repetition_penalty": 1.0}


def generation_settings(gen: dict) -> dict:
    """The processors' settings of a generation_config.json dict:
    repetition_penalty, min_length and top_p (top_k and temperature come
    from the call, as lora_tpu passes them)."""
    for key, inert in _GEN_INERT.items():
        value = gen.get(key)
        if value is not None and value != inert:
            raise ValueError(f"generation_config.json sets {key}="
                             f"{gen[key]!r}, which the port does not apply")
    return {"repetition_penalty": float(gen.get("repetition_penalty") or 1.0),
            "min_length": int(gen.get("min_length") or 0),
            "top_p": float(gen.get("top_p") or 1.0)}


def process_scores(ids: torch.Tensor, scores: torch.Tensor, *,
                   do_sample: bool, top_k: int, temperature: float,
                   top_p: float = 1.0, repetition_penalty: float = 1.0,
                   min_length: int = 0, stop_id: int = -1) -> torch.Tensor:
    """One step's float32 scores (B, vocab) through transformers'
    processors in its order: RepetitionPenalty, MinLength, then (sampling
    only) Temperature, TopK, TopP."""
    if repetition_penalty != 1.0:
        s = torch.gather(scores, 1, ids)
        s = torch.where(s < 0, s * repetition_penalty,
                        s / repetition_penalty)
        scores = scores.scatter(1, ids, s)
    if min_length > 0 and ids.shape[-1] < min_length:
        scores = scores.clone()
        scores[:, stop_id] = -float("inf")
    if not do_sample:
        return scores
    if temperature != 1.0:
        scores = scores / temperature
    if top_k:
        k = min(max(top_k, 1), scores.shape[-1])
        kth = torch.topk(scores, k)[0][..., -1, None]
        scores = scores.masked_fill(scores < kth, -float("inf"))
    if top_p < 1.0:
        sorted_scores, order = torch.sort(scores, descending=False)
        cum = sorted_scores.softmax(dim=-1).cumsum(dim=-1)
        drop = cum <= (1 - top_p)
        drop[..., -1:] = False
        scores = scores.masked_fill(drop.scatter(1, order, drop),
                                    -float("inf"))
    return scores


@torch.no_grad()
def generate(params: Params, pixel_values: torch.Tensor, cfg: BlipConfig,
             input_ids: Optional[torch.Tensor] = None, *,
             max_length: int = 150, do_sample: bool = True, top_k: int = 50,
             temperature: float = 0.7, top_p: float = 1.0,
             repetition_penalty: float = 1.0, min_length: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """BlipForConditionalGeneration.generate: token ids (B, <= max_length),
    the prompt (bos first, its [SEP] dropped) included."""
    t = cfg.text
    image = vision_forward(params, pixel_values, cfg.vision)
    B, device = image.shape[0], image.device
    if input_ids is None:
        ids = torch.tensor([[t.bos_token_id, t.eos_token_id]] * B,
                           device=device)
    else:
        ids = input_ids.to(device).clone()
    ids[:, 0] = t.bos_token_id
    ids = ids[:, :-1]
    cross = cross_cache(params, image, t)
    logits, past = decoder_forward(params, ids, cross, t)
    unfinished = torch.ones(B, dtype=torch.bool, device=device)
    while ids.shape[1] < max_length:
        scores = process_scores(
            ids, logits[:, -1].float(), do_sample=do_sample, top_k=top_k,
            temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty, min_length=min_length,
            stop_id=t.sep_token_id)
        if do_sample:
            nxt = torch.multinomial(scores.softmax(dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = scores.argmax(dim=-1)
        nxt = torch.where(unfinished, nxt, torch.full_like(nxt,
                                                           t.pad_token_id))
        ids = torch.cat([ids, nxt[:, None]], 1)
        unfinished = unfinished & (nxt != t.sep_token_id)
        if not bool(unfinished.any()):
            break
        logits, past = decoder_forward(params, nxt[:, None], cross, t, past)
    return ids


# -- the checkpoint directory ------------------------------------------------

class BlipCaptioner:
    """A BLIP captioning directory on a device: the params, the tokenizer,
    the image processor's settings and the generation config."""

    def __init__(self, model_dir: str, device="cuda"):
        device = hf_dir.check_device(device, "BLIP captioning")
        self.cfg = config_from_json(hf_dir.read_json(model_dir,
                                                     "config.json"))
        expected = hf_dir.shapes(init_blip(self.cfg, None, device="meta"))
        tied = _TIED + ((_TIED_WEIGHT,) if self.cfg.text.tie_word_embeddings
                        else ())
        self.params = hf_dir.load_params(model_dir, expected, device=device,
                                         tied=tied)
        self.device = device
        self.tokenizer = BertTokenizer.from_dir(model_dir)
        self.pre = hf_dir.read_json(model_dir, "preprocessor_config.json",
                                    required=False)
        self.gen = generation_settings(hf_dir.read_json(
            model_dir, "generation_config.json", required=False))

    def pixels(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """BlipImageProcessor on (H, W, 3) uint8 images: BICUBIC to the
        configured size, rescale, CLIP mean and std; (B, h, w, 3)."""
        s = self.cfg.vision.image_size
        px = [hf_dir.image_pixels(img, self.pre, size=(s, s),
                                  resample_filter=resample.BICUBIC,
                                  mean=BLIP_IMAGE_MEAN, std=BLIP_IMAGE_STD)
              for img in images]
        return torch.from_numpy(np.stack(px)).to(self.device)

    def prompt_ids(self, text: Optional[str], batch: int
                   ) -> Optional[torch.Tensor]:
        if text is None:
            return None
        ids = self.tokenizer.encode(text)
        return torch.tensor([ids] * batch, device=self.device)

    def generate(self, image: np.ndarray, text: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None,
                 max_length: int = 150, do_sample: bool = True,
                 top_k: int = 50, temperature: float = 0.7) -> torch.Tensor:
        """The generated ids (1, L) of one image, lora_tpu's call."""
        return generate(self.params, self.pixels([image]), self.cfg,
                        self.prompt_ids(text, 1), max_length=max_length,
                        do_sample=do_sample, top_k=top_k,
                        temperature=temperature, generator=generator,
                        **self.gen)

    def caption(self, image: np.ndarray, text: Optional[str] = None,
                **kw) -> str:
        ids = self.generate(image, text, **kw)
        return self.tokenizer.decode(ids[0].tolist(),
                                     skip_special_tokens=True)
