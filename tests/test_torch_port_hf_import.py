"""The port's diffusers-layout import/export (models/hf_import.py) and
StableDiffusionPipeline.from_pretrained against lora_tpu's, on the tiny
configs: directories written by one package are read by the other with the
same params and configs, and a reloaded pipeline renders the same images."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.models import hf_import as j_hf  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.models import hf_import as t_hf  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_TEXT,
    TINY_UNET,
    TINY_VAE,
)
from lora_tpu_torch.models.schedulers import make_schedule  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401


def _port_pipe(schedule=None):
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_UNET,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)
    if schedule is not None:
        pipe.schedule = schedule
    return pipe


def _numpy_params(pipe):
    return tuple({k: v.numpy() for k, v in m.state_dict().items()}
                 for m in (pipe.unet, pipe.text_encoder, pipe.vae))


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A tiny pipeline directory written by lora_tpu's save_pipeline_params
    (params drawn by the port's random init)."""
    unet_p, text_p, vae_p = _numpy_params(_port_pipe())
    jpipe = JPipe(unet_params={k: jnp.asarray(v) for k, v in unet_p.items()},
                  text_params={k: jnp.asarray(v) for k, v in text_p.items()},
                  vae_params={k: jnp.asarray(v) for k, v in vae_p.items()},
                  tokenizer=JTokenizer(vocab_size=TINY_TEXT.vocab_size),
                  unet_cfg=j_cfg.TINY_UNET, text_cfg=j_cfg.TINY_TEXT,
                  vae_cfg=j_cfg.TINY_VAE)
    d = str(tmp_path_factory.mktemp("jax_sd") / "sd")
    j_hf.save_pipeline_params(jpipe, d)
    return d


def _assert_same(t_loaded, j_loaded):
    *t_params, t_cfgs = t_loaded
    *j_params, j_cfgs = j_loaded
    for tc, jc in zip(t_cfgs, j_cfgs):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for tp, jp in zip(t_params, j_params):
        assert set(tp) == set(jp)
        for k in jp:
            assert tp[k].dtype == torch.float32
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                          err_msg=k)


def test_load_pipeline_params_matches_jax(jax_dir):
    t_loaded = t_hf.load_pipeline_params(jax_dir)
    _assert_same(t_loaded, j_hf.load_pipeline_params(jax_dir))
    assert t_loaded[3][0] == TINY_UNET and t_loaded[3][2] == TINY_VAE


def test_from_pretrained_renders_like_the_converted_pipeline(jax_dir):
    tok = CLIPTokenizer(vocab_size=TINY_TEXT.vocab_size)
    pipe = StableDiffusionPipeline.from_pretrained(jax_dir, tokenizer=tok,
                                                   device="cpu")
    ref = _port_pipe()
    assert pipe.dtype == torch.float32 and pipe.device == torch.device("cpu")
    assert not any(p.requires_grad for p in pipe.unet.parameters())
    lat = ref.prepare_latents(1, 64, 64, torch.Generator().manual_seed(1))
    kw = dict(num_inference_steps=2, height=64, width=64, latents=lat)
    np.testing.assert_allclose(pipe("z", **kw), ref("z", **kw), atol=1e-6)
    with pytest.raises(FileNotFoundError, match="vocab"):
        StableDiffusionPipeline.from_pretrained(jax_dir, device="cpu")


def test_from_pretrained_defaults_to_the_card(jax_dir, monkeypatch):
    """The default device is "cuda"; where CUDA is missing, the call says
    so and names device="cpu" before it reads any weights."""
    import inspect

    sig = inspect.signature(StableDiffusionPipeline.from_pretrained)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StableDiffusionPipeline.from_pretrained(jax_dir)


def test_vae_legacy_attention_key_mapping(tmp_path):
    """Old-diffusers VAE checkpoints use query/key/value/proj_attn names
    and store the output projection as a 1x1 conv."""
    from lora_tpu_torch.formats.reader import save_file

    params = _numpy_params(_port_pipe())[2]
    legacy = {}
    for k, v in params.items():
        for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                         (".to_v.", ".value."), (".to_out.0.", ".proj_attn.")):
            if ".attentions.0" + new in k:
                k = k.replace(new, old)
                if old == ".proj_attn." and v.ndim == 2:
                    v = v[:, :, None, None]
                break
        legacy[k] = v
    d = str(tmp_path / "vae")
    os.makedirs(d)
    save_file(legacy, os.path.join(d, "diffusion_pytorch_model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"block_out_channels": list(TINY_VAE.block_out_channels),
                   "norm_num_groups": TINY_VAE.norm_num_groups}, f)
    loaded, cfg = t_hf.load_vae(d)
    j_loaded, j_cfg = j_hf.load_vae(d)
    assert cfg == TINY_VAE and dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert set(loaded) == set(params) == set(j_loaded)
    for k in params:
        np.testing.assert_array_equal(loaded[k].numpy(), params[k])


def test_torch_bin_weights_load(tmp_path):
    """A .bin state dict (torch.save) loads with weights_only=True."""
    params = _numpy_params(_port_pipe())[2]
    d = str(tmp_path / "vae")
    os.makedirs(d)
    torch.save({k: torch.from_numpy(v).half() for k, v in params.items()},
               os.path.join(d, "diffusion_pytorch_model.bin"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"block_out_channels": list(TINY_VAE.block_out_channels),
                   "norm_num_groups": TINY_VAE.norm_num_groups}, f)
    loaded, _ = t_hf.load_vae(d, dtype=torch.bfloat16)
    for k in params:
        want = torch.from_numpy(params[k]).half().float().bfloat16()
        assert torch.equal(loaded[k], want), k


@pytest.mark.parametrize("kw", [{}, dict(set_alpha_to_one=True, steps_offset=0,
                                         prediction_type="v_prediction")])
def test_scheduler_config_round_trip(tmp_path, kw):
    d = str(tmp_path / "sd")
    t_hf.save_pipeline_params(_port_pipe(make_schedule(**kw)), d)
    got = t_hf.load_scheduler_config(d)
    want = j_hf.load_scheduler_config(d)
    assert got.num_train_timesteps == want.num_train_timesteps
    assert got.final_alpha_cumprod == want.final_alpha_cumprod
    assert got.steps_offset == want.steps_offset == kw.get("steps_offset", 1)
    assert got.prediction_type == want.prediction_type
    np.testing.assert_array_equal(got.alphas_cumprod.numpy(),
                                  np.asarray(want.alphas_cumprod))
    np.testing.assert_array_equal(got.alphas_cumprod.numpy(),
                                  make_schedule(**kw).alphas_cumprod.numpy())
    # a directory without scheduler/ gets the default schedule
    assert t_hf.load_scheduler_config(str(tmp_path)).steps_offset == 1


@pytest.mark.parametrize("fp16", [False, True])
def test_save_pipeline_params_round_trip(tmp_path, fp16):
    pipe = _port_pipe()
    d = str(tmp_path / "sd")
    t_hf.save_pipeline_params(pipe, d, fp16=fp16)
    t_loaded = t_hf.load_pipeline_params(d)
    _assert_same(t_loaded, j_hf.load_pipeline_params(d))
    for params, m in zip(t_loaded[:3],
                         (pipe.unet, pipe.text_encoder, pipe.vae)):
        for k, v in m.state_dict().items():
            want = v.half().float() if fp16 else v
            assert torch.equal(params[k], want), k
