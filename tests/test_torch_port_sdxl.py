"""SDXL's models and adapter files in the port against lora_tpu, in float32
on the tiny XL configs (TINY_XL_UNET, TINY_XL_TEXT, TINY_XL_TEXT2): the
text_time UNet with and without a LoRA, its added_cond refusals, te2's
tokens and projection; kohya-XL files (the LDM key map, the bytes the port
saves, the round trip, the refusals) and LyCORIS-XL files (every algorithm
at an LDM-named UNet site, te1 / te2 modules with a norm module, the int8
base refusal). Params and inputs are drawn with numpy from a seed and handed
to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import lora as j_lora  # noqa: E402
from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_locon_sites,
    unet_locon_sites,
    unet_lora_sites,
)
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.formats import kohya as j_kohya  # noqa: E402
from lora_tpu.formats import lycoris as j_lyco  # noqa: E402
from lora_tpu.models import config as cfgs  # noqa: E402
from lora_tpu.models import unet as j_unet  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax, state_dict_from_jax  # noqa: E402
from lora_tpu_torch.core.quantize import quantize_params_int8  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.formats import kohya as t_kohya  # noqa: E402
from lora_tpu_torch.formats import lycoris as t_lyco  # noqa: E402
from lora_tpu_torch.models.clip import clip_text_forward  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline  # noqa: E402
from test_torch_port_kohya import assert_entries_match, same_error  # noqa: E402
from test_torch_port_lycoris import CASES, _rn, _save  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

XU, XT, XT2 = cfgs.TINY_XL_UNET, cfgs.TINY_XL_TEXT, cfgs.TINY_XL_TEXT2
RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_port_models.py's UNet limits
_jax_unet = jax.jit(j_unet.unet_forward, static_argnums=(4,))


@pytest.fixture(scope="module")
def xl():
    """The port's tiny XL pipe, and its params as numpy per model."""
    pipe = StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=XU, text_cfg=XT,
        text2_cfg=XT2, vae_cfg=cfgs.TINY_VAE)
    return pipe, {m: {k: v.detach().numpy()
                      for k, v in pipe._module(m).state_dict().items()}
                  for m in ("unet", "text_encoder", "text_encoder_2")}


def _factored(sites, r, seed):
    """A LoRA tree over `sites` with nonzero up factors (numpy leaves)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for s in sites:
        tail = () if s.kind == "linear" else tuple(s.kernel)
        up_tail = () if s.kind == "linear" else (1, 1)
        pairs.append(((0.1 * rng.standard_normal((s.out_dim, r) + up_tail)
                       ).astype(np.float32),
                      (0.3 * rng.standard_normal((r, s.in_dim) + tail)
                       ).astype(np.float32)))
    tree = j_lora.lora_from_pairs(pairs, sites)
    return {"sites": {n: {k: np.asarray(v) for k, v in e.items()}
                      for n, e in tree["sites"].items()},
            "scale": np.asarray(tree["scale"])}


def _unet_inputs(seed, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 8, 8, 4)).astype(np.float32),
            np.array([3, 801][:batch]),
            rng.standard_normal((batch, 6, XU.cross_attention_dim)).astype(
                np.float32),
            {"text_embeds": rng.standard_normal(
                (batch, XT2.projection_dim)).astype(np.float32),
             "time_ids": np.array([[1024, 768, 0, 16, 1024, 1024],
                                   [512, 512, 8, 0, 768, 1024]][:batch],
                                  np.float32)})


# -- the text_time UNet ------------------------------------------------------

@pytest.mark.parametrize("with_lora", [False, True])
def test_text_time_unet_matches_jax(with_lora, xl):
    _, npar = xl
    x, t, ctx, cond = _unet_inputs(1)
    tree = (_factored(unet_lora_sites(XU), 3, seed=2) if with_lora
            else None)
    jtree = (None if tree is None else
             {"sites": {n: {k: jnp.asarray(v) for k, v in e.items()}
                        for n, e in tree["sites"].items()},
              "scale": jnp.asarray(tree["scale"])})
    ref = _jax_unet({k: jnp.asarray(v) for k, v in npar["unet"].items()},
                    jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), XU,
                    lora=jtree, added_cond={k: jnp.asarray(v)
                                            for k, v in cond.items()})
    unet = UNet(XU, device="cpu")
    unet.load_state_dict(state_dict_from_jax(npar["unet"]), strict=True)
    with torch.inference_mode():
        out = unet(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx),
                   lora=None if tree is None else lora_from_jax(tree),
                   added_cond={k: torch.from_numpy(v)
                               for k, v in cond.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    if with_lora:
        return
    # the micro-conditioning is live: other time_ids move the output
    with torch.inference_mode():
        moved = unet(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx), added_cond={
                         "text_embeds": torch.from_numpy(
                             cond["text_embeds"]),
                         "time_ids": torch.from_numpy(cond["time_ids"][::-1]
                                                      .copy())})
    assert np.abs(moved.numpy() - out.numpy()).max() > 1e-4


def test_added_cond_refusals(xl):
    """added_cond is required iff the config declares addition_embed_type,
    with lora_tpu's message either way."""
    _, npar = xl
    x, t, ctx, cond = _unet_inputs(2)
    sd_p = j_unet.init_unet(cfgs.TINY_UNET, jax.random.PRNGKey(0))
    sd = UNet(cfgs.TINY_UNET, device="cpu")
    sd.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in sd_p.items()}), strict=True)
    xl_unet = UNet(XU, device="cpu")
    ctx_sd = np.zeros((2, 6, cfgs.TINY_UNET.cross_attention_dim), np.float32)
    for jfn, tfn in (
            (lambda: j_unet.unet_forward(
                {k: jnp.asarray(v) for k, v in npar["unet"].items()},
                jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), XU),
             lambda: xl_unet(torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(ctx))),
            (lambda: j_unet.unet_forward(
                sd_p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx_sd),
                cfgs.TINY_UNET, added_cond={k: jnp.asarray(v)
                                            for k, v in cond.items()}),
             lambda: sd(torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(ctx_sd), added_cond={
                            k: torch.from_numpy(v)
                            for k, v in cond.items()}))):
        same_error(jfn, tfn)


def test_tokenizer_2_pads_with_id_0():
    """te2's tokens pad with id 0 after the EOS, as lora_tpu's tokenizer
    gives them, and reach the encoder (the pooled row reads the first
    EOS)."""
    j, t = JTokenizer(vocab_size=XT.vocab_size), CLIPTokenizer(
        vocab_size=XT.vocab_size)
    prompts = ["a cat", "a photo of a dog on the beach"]
    ids = t(prompts, pad_token_id=0)["input_ids"]
    assert ids == j(prompts, pad_token_id=0)["input_ids"]
    assert ids != t(prompts)["input_ids"]
    for row in ids:
        eos = row.index(t.eos_token_id)
        assert set(row[eos + 1:]) == {0}


def test_text_projection_dequantized(xl):
    """text_projection goes through dequantize_weight: the same pooled row
    on a float weight, the dequantized weight's on an int8 one."""
    pipe, npar = xl
    params = pipe.text_encoder_2.flat_params()
    ids = torch.tensor(CLIPTokenizer(vocab_size=XT2.vocab_size)(
        ["a cat"], pad_token_id=0)["input_ids"])
    eos = CLIPTokenizer(vocab_size=XT2.vocab_size).eos_token_id
    with torch.inference_mode():
        _, pooled = clip_text_forward(params, ids, XT2, pooled_eos_id=eos)
        q = quantize_params_int8({"text_projection.weight":
                                  params["text_projection.weight"]})
        assert q["text_projection.weight"].dtype == torch.int8
        _, pooled_q = clip_text_forward({**params, **q}, ids, XT2,
                                        pooled_eos_id=eos)
        w = (q["text_projection.weight"].float()
             * q["text_projection.weight_scale"][:, None])
        _, pooled_w = clip_text_forward(
            {**params, "text_projection.weight": w}, ids, XT2,
            pooled_eos_id=eos)
    np.testing.assert_array_equal(pooled_q.numpy(), pooled_w.numpy())
    # per-channel int8: within a percent of the float weight's row
    assert (np.linalg.norm(pooled_q.numpy() - pooled.numpy())
            < 1e-2 * np.linalg.norm(pooled.numpy()))


# -- kohya-XL ----------------------------------------------------------------

@pytest.mark.parametrize("cfg_name", ["TINY_XL_UNET", "SDXL_UNET"])
def test_xl_unet_ldm_key_map_matches_jax(cfg_name):
    """Every LoCon site's LDM key, on the tiny and on the published SDXL
    config (per-block transformer depth 1, 2, 10), as lora_tpu names it."""
    cfg = getattr(cfgs, cfg_name)
    sites = unet_locon_sites(cfg)
    want = {k: s.name for k, s in j_kohya._xl_unet_index(sites, cfg).items()}
    got = {k: s.name for k, s in t_kohya._xl_unet_index(sites, cfg).items()}
    assert got == want and len(got) == len(sites)
    if cfg_name == "SDXL_UNET":
        assert (got["lora_unet_middle_block_1_transformer_blocks_9_attn2_to_k"]
                == "mid_block.attentions.0.transformer_blocks.9.attn2.to_k")
        assert (got["lora_unet_output_blocks_2_2_conv"]
                == "up_blocks.0.upsamplers.0.conv")
    for model, c in (("text_encoder", XT), ("text_encoder_2", XT2)):
        s2 = text_encoder_locon_sites(c)
        assert ({k: s.name for k, s in t_kohya._xl_index(model, s2,
                                                         cfg).items()}
                == {k: s.name for k, s in j_kohya._xl_index(model, s2,
                                                            cfg).items()})


def _xl_trees():
    """LoCon trees over the three models (rank 2, nonzero up)."""
    sites = (unet_locon_sites(XU), text_encoder_locon_sites(XT),
             text_encoder_locon_sites(XT2))
    return sites, [_factored(s, 2, seed=10 + i) for i, s in enumerate(sites)]


def _save_kw(trees, sites, to):
    return dict(unet_cfg=XU, lora_unet=to(trees[0]), unet_sites=sites[0],
                lora_text=to(trees[1]), text_sites=sites[1],
                lora_text2=to(trees[2]), text2_sites=sites[2])


def _jax_tree(tree):
    return {"sites": {n: {k: jnp.asarray(v) for k, v in e.items()}
                      for n, e in tree["sites"].items()},
            "scale": jnp.asarray(tree["scale"])}


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_kohya_xl_save_writes_lora_tpu_bytes(dtype, tmp_path):
    sites, trees = _xl_trees()
    pj, pt = str(tmp_path / "j.safetensors"), str(tmp_path / "t.safetensors")
    j_kohya.save_kohya_xl(pj, dtype=dtype, **_save_kw(trees, sites,
                                                      _jax_tree))
    t_kohya.save_kohya_xl(pt, dtype=dtype, **_save_kw(trees, sites,
                                                      lora_from_jax))
    assert open(pj, "rb").read() == open(pt, "rb").read()


def test_kohya_xl_round_trip_matches_jax(tmp_path):
    sites, trees = _xl_trees()
    p = str(tmp_path / "xl.safetensors")
    j_kohya.save_kohya_xl(p, dtype=np.float32,
                          **_save_kw(trees, sites, _jax_tree))
    from lora_tpu_torch.formats.reader import SafetensorsFile

    with SafetensorsFile(p) as f:
        keys = list(f.keys())
    assert t_kohya.is_kohya_xl(keys) and j_kohya.is_kohya_xl(keys)
    assert not t_kohya.is_kohya_xl(
        ["lora_unet_down_blocks_1_attentions_0_proj_in.alpha"])
    kw = dict(unet_cfg=XU, unet_sites=sites[0], text_sites=sites[1],
              text2_sites=sites[2])
    want = j_kohya.load_kohya_xl(p, **kw)
    got = t_kohya.load_kohya_xl(p, **kw)
    for g, w, tree in zip(got, want, trees):
        assert_entries_match(g, w)
        assert_entries_match(g, tree)


def test_kohya_xl_refusals_match_lora_tpu(tmp_path):
    """Unknown prefixes, a module outside the sites, an unrecognized key, a
    LyCORIS sub-tensor, and an XL file given to the plain loader: the same
    ValueError as lora_tpu."""
    sites, trees = _xl_trees()
    kw = dict(unet_cfg=XU, unet_sites=sites[0], text_sites=sites[1],
              text2_sites=sites[2])
    zeros = np.zeros((2, 2), np.float32)
    base = "lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q"
    t2 = sites[2][0]
    te2_ok = {f"lora_te2_{t2.name.replace('.', '_')}.lora_up.weight":
              np.zeros((t2.out_dim, 2), np.float32),
              f"lora_te2_{t2.name.replace('.', '_')}.lora_down.weight":
              np.zeros((2, t2.in_dim), np.float32)}
    bad = {
        "prefix": {"lora_refiner_foo.lora_up.weight": zeros},
        "outside": {**te2_ok, "lora_te2_text_model_encoder_layers_9_mlp_fc1"
                    ".lora_up.weight": zeros},
        "key": {base + ".lora_up.bias": zeros},
        "sub": {base + ".hada_w1_a.weight": zeros},
    }
    for name, tensors in bad.items():
        p = _save(tmp_path, tensors, name + ".safetensors")
        same_error(lambda: j_kohya.load_kohya_xl(p, **kw),
                   lambda: t_kohya.load_kohya_xl(p, **kw))
    p = str(tmp_path / "xl.safetensors")
    j_kohya.save_kohya_xl(p, **_save_kw(trees, sites, _jax_tree))
    plain = dict(unet_sites=sites[0], text_sites=sites[1])
    same_error(lambda: j_kohya.load_kohya(p, **plain),
               lambda: t_kohya.load_kohya(p, **plain))
    # an SD-1 kohya file's diffusers UNet names match no LDM key: both
    # packages load nothing from it
    sd = str(tmp_path / "sd.safetensors")
    j_kohya.save_kohya(sd, lora_unet=_jax_tree(trees[0]),
                       unet_sites=sites[0])
    assert j_kohya.load_kohya_xl(sd, **kw) == (None, None, None)
    assert t_kohya.load_kohya_xl(sd, **kw) == (None, None, None)


# -- LyCORIS-XL --------------------------------------------------------------

def _xl_sites():
    """(LIN: the first transformer's attn1.to_q, FF: its GEGLU projection,
    CONV: the first resnet's 3x3 conv1) of the tiny XL UNet, with their
    LDM kohya keys."""
    us, ls = unet_lora_sites(XU), unet_locon_sites(XU)
    picked = (us[0], next(s for s in us if s.name.endswith("ff.net.0.proj")),
              next(s for s in ls if s.name.endswith("resnets.0.conv1")))
    index = {s.name: k for k, s in j_kohya._xl_unet_index(ls, XU).items()}
    return [(s, index[s.name]) for s in picked]


def _module_tensors(key, leaves):
    w = ("lora_up", "lora_down", "lora_mid", "a1", "a2", "b1", "b2")
    return {f"{key}.{leaf}.weight" if leaf in w else f"{key}.{leaf}": v
            for leaf, v in leaves.items()}


def _load_xl_both(p, npar, tpipe):
    kw = dict(unet_cfg=XU, unet_sites=unet_locon_sites(XU),
              text_sites=text_encoder_locon_sites(XT),
              text2_sites=text_encoder_locon_sites(XT2))
    return (j_lyco.load_lycoris_xl(
                p, unet_params=npar["unet"], text_params=npar["text_encoder"],
                text2_params=npar["text_encoder_2"], **kw),
            t_lyco.load_lycoris_xl(
                p, unet_params=tpipe.unet.flat_params(),
                text_params=tpipe.text_encoder.flat_params(),
                text2_params=tpipe.text_encoder_2.flat_params(), **kw))


@pytest.mark.parametrize("case", CASES)
def test_lycoris_xl_algorithm_loads_the_same(case, xl, tmp_path):
    """Each algorithm of the SD test's cases at an LDM-named UNet site."""
    pipe, npar = xl
    site_i, build = CASES[case]
    site, key = _xl_sites()[site_i]
    leaves = build(site, np.random.default_rng(list(CASES).index(case)))
    p = _save(tmp_path, _module_tensors(key, leaves))
    want, got = _load_xl_both(p, npar, pipe)
    assert got[1] is None and got[2] is None
    assert list(got[0]["sites"]) == [site.name]
    assert_entries_match(got[0], want[0])


def test_lycoris_xl_text_modules_and_norm_load_the_same(xl, tmp_path):
    """A LoHa te1 module, a DoRA te2 module and a norm module on te2's
    first layer_norm1, beside a LoKr UNet module: three trees, te2's with
    the param delta."""
    pipe, npar = xl
    rng = np.random.default_rng(5)
    t1 = text_encoder_locon_sites(XT)[0]
    t2 = text_encoder_locon_sites(XT2)[1]
    tensors = {}
    for prefix, s, leaves in (
            ("lora_te1", t1, CASES["loha_linear"][1](t1, rng)),
            ("lora_te2", t2, CASES["dora_linear"][1](t2, rng))):
        tensors.update(_module_tensors(
            prefix + "_" + s.name.replace(".", "_"), leaves))
    site, key = _xl_sites()[0]
    tensors.update(_module_tensors(key, CASES["lokr_linear_full"][1](site,
                                                                     rng)))
    npath = "text_model.encoder.layers.0.layer_norm1"
    tensors["lora_te2_" + npath.replace(".", "_") + ".w_norm"] = _rn(
        rng, XT2.hidden_size, s=0.1)
    p = _save(tmp_path, tensors)
    want, got = _load_xl_both(p, npar, pipe)
    for g, w in zip(got, want):
        assert_entries_match(g, w)
    assert set(got[2]["param_deltas"]) == {npath + ".weight"}


def test_lycoris_xl_refusals_match_lora_tpu(xl, tmp_path):
    pipe, npar = xl
    kw = dict(unet_cfg=XU, unet_sites=unet_locon_sites(XU),
              text2_sites=text_encoder_locon_sites(XT2))
    site, key = _xl_sites()[0]
    rng = np.random.default_rng(8)
    bad = {
        "prefix": {"lora_te_foo.hada_w1_a": _rn(rng, 2, 2)},
        "outside": _module_tensors(
            "lora_unet_input_blocks_99_1_proj_in",
            CASES["loha_linear"][1](site, rng)),
        "no_params": _module_tensors(key, CASES["dora_linear"][1](site,
                                                                  rng)),
    }
    for name, tensors in bad.items():
        p = _save(tmp_path, tensors, name + ".safetensors")
        same_error(lambda: j_lyco.load_lycoris_xl(p, **kw),
                   lambda: t_lyco.load_lycoris_xl(p, **kw))


def test_int8_base_refuses_xl_dora_but_te2_stays_float(tmp_path):
    """quantize_base turns the UNet, te1 and the VAE int8 and leaves te2 in
    the pipe's dtype: a DoRA module on the int8 UNet is refused with the
    port's message, the same module on te2 still loads."""
    pipe = StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(1), "cpu", unet_cfg=XU, text_cfg=XT,
        text2_cfg=XT2, vae_cfg=cfgs.TINY_VAE)
    pipe.quantize_base()
    for m in (pipe.unet, pipe.text_encoder, pipe.vae):
        assert any(v.dtype == torch.int8 for v in m.state_dict().values())
    assert all(v.dtype == torch.float32
               for v in pipe.text_encoder_2.state_dict().values())
    rng = np.random.default_rng(9)
    site, key = _xl_sites()[0]
    p = _save(tmp_path, _module_tensors(key, CASES["dora_linear"][1](site,
                                                                     rng)))
    with pytest.raises(ValueError, match=(
            f"DORA module {key!r}: the unet base weight "
            f"{site.name + '.weight'!r} is int8-quantized")):
        pipe.patch_pipe(p)
    t2 = text_encoder_locon_sites(XT2)[0]
    ok = _save(tmp_path, _module_tensors(
        "lora_te2_" + t2.name.replace(".", "_"),
        CASES["dora_linear"][1](t2, rng)), "te2.safetensors")
    pipe.patch_pipe(ok)
    assert "delta" in pipe.lora_text2["sites"][t2.name]
    assert pipe.lora_unet is None and pipe.lora_text is None
