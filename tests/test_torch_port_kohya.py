"""kohya-ss / LoCon files in the port (lora_tpu_torch/formats/kohya.py and
patch_pipe) against lora_tpu in float32 on the tiny configs, SD-1 and SD-2:
files written by lora_tpu's save_kohya and by hand (alpha != rank, partial
coverage, CP-decomposed convs) load to the same sites, entry keys and
values; the port's save_kohya writes lora_tpu's bytes; every refusal
carries lora_tpu's message; and patch_pipe + one UNet call and one
text-encoder call agree with the JAX pipe."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import lora as j_lora  # noqa: E402
from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_locon_sites,
    text_encoder_lora_sites,
    unet_locon_sites,
    unet_lora_sites,
)
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.formats import kohya as j_kohya  # noqa: E402
from lora_tpu.formats.reader import save_file  # noqa: E402
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.models.unet import unet_forward as j_unet_forward  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax  # noqa: E402
from lora_tpu_torch.formats import kohya as t_kohya  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

# the pipelines' limits (tests/test_torch_port_pipeline.py TOL)
PIPE_TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = ["a photo of a dog", "a town"]
# configs: (unet, text) tiny pairs of the SD-1 and the SD-2 topology
CFGS = {"sd1": (j_cfg.TINY_UNET, j_cfg.TINY_TEXT),
        "sd2": (j_cfg.TINY_SD2_UNET, j_cfg.TINY_SD2_TEXT)}


def assert_entries_match(port, jtree, rel=1e-5):
    """The same site names (in order), entry keys and scale; each value
    within rel * max |value| of lora_tpu's."""
    if jtree is None:
        assert port is None
        return
    assert list(port["sites"]) == list(jtree["sites"])
    for name, entry in jtree["sites"].items():
        assert set(port["sites"][name]) == set(entry), name
        for k, v in entry.items():
            want = np.asarray(v, np.float32)
            got = port["sites"][name][k].float().cpu().numpy()
            assert got.shape == want.shape, (name, k)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                err_msg=f"{name}.{k}")
    assert float(port["scale"]) == float(jtree["scale"])
    assert set(port.get("param_deltas", {})) == set(
        jtree.get("param_deltas", {}))
    for k, v in jtree.get("param_deltas", {}).items():
        want = np.asarray(v, np.float32)
        np.testing.assert_allclose(
            port["param_deltas"][k].cpu().numpy(), want, rtol=0,
            atol=rel * max(np.abs(want).max(), 1e-30), err_msg=k)


def same_error(fn_j, fn_t):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


def make_pipes(cfg_name, seed=0):
    """(the JAX pipe, the port's pipe) holding the same random params."""
    unet_cfg, text_cfg = CFGS[cfg_name]
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(seed), "cpu", unet_cfg=unet_cfg,
        text_cfg=text_cfg, vae_cfg=j_cfg.TINY_VAE)
    unet_p, text_p, vae_p = (
        {k: jnp.asarray(v.numpy()) for k, v in m.state_dict().items()}
        for m in (pipe.unet, pipe.text_encoder, pipe.vae))
    jpipe = JPipe(unet_params=unet_p, text_params=text_p, vae_params=vae_p,
                  tokenizer=JTokenizer(vocab_size=text_cfg.vocab_size),
                  unet_cfg=unet_cfg, text_cfg=text_cfg,
                  vae_cfg=j_cfg.TINY_VAE)
    return jpipe, pipe


def unet_and_text_calls(jpipe, pipe, seed=1):
    """One UNet call (batch 2, 8x8 latents) and one text-encoder call of
    each pipe with its loaded adapters, as numpy: ((jax unet, port unet),
    (jax text, port text))."""
    cfg = pipe.unet.cfg
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, cfg.in_channels)).astype(np.float32)
    t = np.array([7, 501])
    ctx = rng.standard_normal((2, 5, cfg.cross_attention_dim)).astype(
        np.float32)
    ref = j_unet_forward(jpipe.unet_params, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(ctx), jpipe.unet_cfg,
                         lora=jpipe.lora_unet)
    with torch.inference_mode():
        got = pipe.unet(torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(ctx), lora=pipe.lora_unet)
    assert jpipe.tokenizer(PROMPTS) == pipe.tokenizer(PROMPTS)
    return ((np.asarray(ref), got.numpy()),
            (np.asarray(jpipe.encode_prompt(PROMPTS)),
             pipe.encode_prompt(PROMPTS).numpy()))


def _factored_tree(sites, r, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    pairs = []
    for s in sites:
        if s.kind == "linear":
            up, down = (s.out_dim, r), (r, s.in_dim)
        else:
            up, down = (s.out_dim, r, 1, 1), (r, s.in_dim) + tuple(s.kernel)
        pairs.append(((0.1 * rng.standard_normal(up)).astype(np.float32),
                      (0.3 * rng.standard_normal(down)).astype(np.float32)))
    return j_lora.lora_from_pairs(pairs, sites, scale)


def _locon_tensors(unet_sites, text_sites, r, alpha, seed, cp_every=3):
    """A LoCon file by hand: every site, rank r, `.alpha` = alpha (not the
    rank), every `cp_every`-th 3x3 conv CP-decomposed with lora_mid."""
    rng = np.random.default_rng(seed)
    t = {}
    n_conv = 0
    for model, sites in (("unet", unet_sites), ("text_encoder", text_sites)):
        for s in sites:
            key = j_kohya.kohya_key(model, s.name)
            if s.kind == "linear":
                t[key + ".lora_down.weight"] = rng.standard_normal(
                    (r, s.in_dim)).astype(np.float32)
                t[key + ".lora_up.weight"] = (0.1 * rng.standard_normal(
                    (s.out_dim, r))).astype(np.float32)
            else:
                kh, kw = s.kernel
                cp = (kh, kw) != (1, 1) and n_conv % cp_every == 0
                n_conv += (kh, kw) != (1, 1)
                if cp:
                    t[key + ".lora_down.weight"] = rng.standard_normal(
                        (r, s.in_dim, 1, 1)).astype(np.float32)
                    t[key + ".lora_mid.weight"] = rng.standard_normal(
                        (r, r, kh, kw)).astype(np.float32)
                else:
                    t[key + ".lora_down.weight"] = rng.standard_normal(
                        (r, s.in_dim, kh, kw)).astype(np.float32)
                t[key + ".lora_up.weight"] = (0.1 * rng.standard_normal(
                    (s.out_dim, r, 1, 1))).astype(np.float32)
            t[key + ".alpha"] = np.asarray(alpha, np.float32)
    return t


def _save(tmp_path, tensors, name="kohya.safetensors"):
    p = str(tmp_path / name)
    save_file({k: np.asarray(v) for k, v in tensors.items()}, p)
    return p


def _both(path, **kw):
    """(lora_tpu's (lu, lt), the port's (lu, lt)) of one file."""
    return (j_kohya.load_kohya(path, **kw),
            t_kohya.load_kohya(path, **kw))


@pytest.mark.parametrize("cfg", CFGS)
def test_lora_tpu_save_loads_the_same(cfg, tmp_path):
    """lora_tpu's save_kohya (f16, the scale folded into up) read back by
    both loaders, against the default and the LoCon site sets."""
    unet_cfg, text_cfg = CFGS[cfg]
    us, ts = unet_lora_sites(unet_cfg), text_encoder_lora_sites(text_cfg)
    p = str(tmp_path / "saved.safetensors")
    j_kohya.save_kohya(p, lora_unet=_factored_tree(us, 4, 1, scale=0.7),
                       unet_sites=us,
                       lora_text=_factored_tree(ts, 4, 2), text_sites=ts)
    for kw in (dict(unet_sites=us, text_sites=ts),
               dict(unet_sites=unet_locon_sites(unet_cfg),
                    text_sites=text_encoder_locon_sites(text_cfg)),
               dict(unet_sites=us)):
        (jlu, jlt), (tlu, tlt) = _both(p, **kw)
        assert_entries_match(tlu, jlu)
        assert_entries_match(tlt, jlt)
        assert tlu["sites"][us[0].name]["up"].dtype == torch.float32


@pytest.mark.parametrize("cfg", CFGS)
def test_locon_cp_and_alpha_load_the_same(cfg, tmp_path):
    """A LoCon file over every site with alpha 4 at rank 8 and CP convs:
    the exact CP fold and the webui multiplier agree with lora_tpu's."""
    unet_cfg, text_cfg = CFGS[cfg]
    us, ts = unet_locon_sites(unet_cfg), text_encoder_locon_sites(text_cfg)
    t = _locon_tensors(us, ts, r=8, alpha=4.0, seed=3)
    assert any(k.endswith(".lora_mid.weight") for k in t)
    p = _save(tmp_path, t)
    (jlu, jlt), (tlu, tlt) = _both(p, unet_sites=us, text_sites=ts)
    assert len(tlu["sites"]) == len(us) and len(tlt["sites"]) == len(ts)
    assert_entries_match(tlu, jlu)
    assert_entries_match(tlt, jlt)
    # dtype and device as asked
    lu16, _ = t_kohya.load_kohya(p, unet_sites=us, dtype=torch.bfloat16)
    assert {e["up"].dtype for e in lu16["sites"].values()} == {
        torch.bfloat16}


def test_partial_coverage_and_missing_alpha(tmp_path):
    """Attention-only files (a subset of the sites, one without `.alpha`,
    whose multiplier is then 1) load the same; a model absent from the file
    comes back None."""
    us = unet_lora_sites(j_cfg.TINY_UNET)
    sub = [s for s in us if ".attn1." in s.name]
    t = _locon_tensors(sub, [], r=2, alpha=8.0, seed=4)
    del t[j_kohya.kohya_key("unet", sub[0].name) + ".alpha"]
    p = _save(tmp_path, t)
    (jlu, jlt), (tlu, tlt) = _both(
        p, unet_sites=us, text_sites=text_encoder_lora_sites(j_cfg.TINY_TEXT))
    assert jlt is None and tlt is None
    assert list(tlu["sites"]) == [s.name for s in sub]
    assert_entries_match(tlu, jlu)


def test_port_save_writes_lora_tpu_bytes(tmp_path):
    us = unet_lora_sites(j_cfg.TINY_UNET)
    ts = text_encoder_lora_sites(j_cfg.TINY_TEXT)
    ju, jt = _factored_tree(us, 3, 5, scale=0.5), _factored_tree(ts, 3, 6)
    tu, tt = (lora_from_jax({"sites": {n: {k: np.asarray(v)
                                           for k, v in e.items()}
                                       for n, e in tree["sites"].items()},
                             "scale": np.asarray(tree["scale"])})
              for tree in (ju, jt))
    pj, pt = str(tmp_path / "j.safetensors"), str(tmp_path / "t.safetensors")
    j_kohya.save_kohya(pj, lora_unet=ju, unet_sites=us, lora_text=jt,
                       text_sites=ts)
    t_kohya.save_kohya(pt, lora_unet=tu, unet_sites=us, lora_text=tt,
                       text_sites=ts)
    assert open(pj, "rb").read() == open(pt, "rb").read()


def test_rejections_match_lora_tpu(tmp_path):
    us = unet_locon_sites(j_cfg.TINY_UNET)
    ts = text_encoder_locon_sites(j_cfg.TINY_TEXT)
    lin = next(s for s in us if s.kind == "linear")
    conv = next(s for s in us if s.kind == "conv" and s.kernel == (3, 3))
    key = j_kohya.kohya_key("unet", lin.name)
    good = _locon_tensors([lin], [], r=2, alpha=2.0, seed=7)
    cases = {
        "unrecognized": {**good, key + ".lora_up.bias": np.zeros(2)},
        "sub-tensors": {**good, key + ".hada_w1_a.weight": np.zeros((2, 2))},
        "prefix": {**good, "lora_te1_text_model_x.lora_up.weight":
                   np.zeros((2, 2), np.float32)},
        "outside": {**good, "lora_unet_nowhere_proj.lora_up.weight":
                    np.zeros((2, 2), np.float32)},
        "text outside": {**good, **_locon_tensors([], ts[:1], r=2,
                                                  alpha=2.0, seed=9),
                         "lora_te_text_model_nowhere.alpha": np.float32(1)},
        "mid on a linear": {**good, key + ".lora_mid.weight":
                            np.zeros((2, 2, 3, 3), np.float32)},
    }
    ck = j_kohya.kohya_key("unet", conv.name)
    cp = _locon_tensors([conv], [], r=2, alpha=2.0, seed=8, cp_every=1)
    cases["mid shapes"] = {**cp, ck + ".lora_down.weight":
                           np.zeros((2, conv.in_dim, 3, 3), np.float32)}
    cases["mid geometry"] = {**cp, ck + ".lora_mid.weight":
                             np.zeros((2, 2, 1, 1), np.float32)}
    for name, tensors in cases.items():
        p = _save(tmp_path, tensors, name.replace(" ", "_") + ".st")
        same_error(lambda: j_kohya.load_kohya(p, unet_sites=us,
                                              text_sites=ts),
                   lambda: t_kohya.load_kohya(p, unet_sites=us,
                                              text_sites=ts))


@pytest.mark.parametrize("cfg", CFGS)
def test_patch_pipe_kohya_matches_jax(cfg, tmp_path):
    """patch_pipe of a LoCon file (every site, alpha != rank, CP convs) at
    scale 0.8: one UNet call and one text-encoder call agree with the JAX
    pipe's; the file carries no embeds and bumps the adapter generation."""
    jpipe, pipe = make_pipes(cfg)
    unet_cfg, text_cfg = CFGS[cfg]
    p = _save(tmp_path, _locon_tensors(unet_locon_sites(unet_cfg),
                                       text_encoder_locon_sites(text_cfg),
                                       r=4, alpha=2.0, seed=9))
    gen = pipe.adapter_generation
    assert jpipe.patch_pipe(p) == {} and pipe.patch_pipe(p) == {}
    assert pipe.adapter_generation == gen + 1
    assert not pipe.has_base_deltas("unet")
    assert_entries_match(pipe.lora_unet, jpipe.lora_unet)
    assert_entries_match(pipe.lora_text, jpipe.lora_text)
    for p_ in (jpipe, pipe):
        p_.tune_lora_scale(0.8)
    (ju, tu), (jt, tt) = unet_and_text_calls(jpipe, pipe)
    np.testing.assert_allclose(tu, ju, **PIPE_TOL)
    np.testing.assert_allclose(tt, jt, **PIPE_TOL)
    # patch_unet=False leaves the UNet's adapter alone
    pipe.remove_lora()
    pipe.patch_pipe(p, patch_unet=False)
    assert pipe.lora_unet is None and pipe.lora_text is not None
