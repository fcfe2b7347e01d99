"""LyCORIS files in the port (lora_tpu_torch/formats/lycoris.py and the
pipeline's base-param deltas) against lora_tpu in float32 on the tiny
configs, SD-1 and SD-2: every algorithm (LoHa flat and Tucker; LoKr full,
factored and Tucker; IA3; DoRA; diag-OFT with its clamp and rescale; BOFT
with its global clamp; GLoRA; full with diff_b; norm; plain LoRA with a CP
mid in a mixed file) loads to the same sites, entry keys, param deltas and
values; every refusal carries lora_tpu's message; an int8 base refuses the
base-weight-dependent algorithms; patch_pipe + one UNet call and one
text-encoder call agree with the JAX pipe; and the base-delta lifecycle
(tune, remove, repatch, collapse) restores and folds as lora_tpu's does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import lora as j_lora  # noqa: E402
from lora_tpu.core.sites import (  # noqa: E402
    Site,
    text_encoder_locon_sites,
    unet_locon_sites,
    unet_lora_sites,
)
from lora_tpu.formats import lycoris as j_lyco  # noqa: E402
from lora_tpu.formats.kohya import kohya_key  # noqa: E402
from lora_tpu.formats.reader import save_file  # noqa: E402
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax  # noqa: E402
from lora_tpu_torch.core import lora as t_lora  # noqa: E402
from lora_tpu_torch.formats import lycoris as t_lyco  # noqa: E402
from lora_tpu_torch.formats.reader import SafetensorsFile  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from test_torch_port_kohya import (  # noqa: E402
    CFGS,
    PIPE_TOL,
    assert_entries_match,
    make_pipes,
    same_error,
    unet_and_text_calls,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401


def _sites(cfg_name):
    """(LIN: attn1.to_q, FF: the GEGLU projection (c -> 8c, with a bias),
    CONV: the first resnet's 3x3 conv1) of the config's UNet."""
    unet_cfg = CFGS[cfg_name][0]
    us, ls = unet_lora_sites(unet_cfg), unet_locon_sites(unet_cfg)
    return (us[0], next(s for s in us if s.name.endswith("ff.net.0.proj")),
            next(s for s in ls if s.name.endswith("resnets.0.conv1")))


@pytest.fixture(scope="module")
def params():
    """Per config: the port's random tiny UNet and text params, as tensors
    (the port's loaders) and as numpy (lora_tpu's)."""
    out = {}
    for name, (unet_cfg, text_cfg) in CFGS.items():
        pipe = StableDiffusionPipeline.random_init(
            torch.Generator().manual_seed(3), "cpu", unet_cfg=unet_cfg,
            text_cfg=text_cfg, vae_cfg=j_cfg.TINY_VAE)
        t = {"unet": pipe.unet.flat_params(),
             "text": pipe.text_encoder.flat_params()}
        out[name] = (t, {k: {n: v.detach().numpy() for n, v in p.items()}
                         for k, p in t.items()})
    return out


def _rn(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _shape(site):
    return (site.out_dim, site.in_dim) + (
        () if site.kind == "linear" else tuple(site.kernel))


def _half_blocks(dim, stages=1):
    """An even block size b with dim % (b * 2^(stages-1)) == 0."""
    return next(b for b in (8, 4, 2) if dim % (b * 2 ** (stages - 1)) == 0)


# one module per case: name -> (site index in _sites: 0 LIN, 1 FF, 2 CONV,
# builder(site, rng) -> {leaf: array})
def _loha(site, rng, alpha=1.5, r=3):
    flat = int(np.prod(_shape(site)[1:]))
    t = {"hada_w1_a": _rn(rng, site.out_dim, r),
         "hada_w1_b": _rn(rng, r, flat),
         "hada_w2_a": _rn(rng, site.out_dim, r),
         "hada_w2_b": _rn(rng, r, flat)}
    if alpha is not None:
        t["alpha"] = np.float32(alpha)
    return t


def _loha_tucker(site, rng, r=2):
    kh, kw = site.kernel
    return {"hada_t1": _rn(rng, r, r, kh, kw),
            "hada_t2": _rn(rng, r, r, kh, kw),
            "hada_w1_a": _rn(rng, r, site.out_dim),
            "hada_w1_b": _rn(rng, r, site.in_dim),
            "hada_w2_a": _rn(rng, r, site.out_dim),
            "hada_w2_b": _rn(rng, r, site.in_dim), "alpha": np.float32(r)}


def _lokr(site, rng, mode):
    o1, i1 = 4, 4
    o2, i2 = site.out_dim // o1, site.in_dim // i1
    k = tuple(site.kernel) if site.kind == "conv" else ()
    t = {"alpha": np.float32(4.0)}
    if mode == "w1_full_w2_factored":
        t.update(lokr_w1=_rn(rng, o1, i1), lokr_w2_a=_rn(rng, o2, 2),
                 lokr_w2_b=_rn(rng, 2, i2 * int(np.prod(k or (1,)))))
    elif mode == "full":
        t.update(lokr_w1=_rn(rng, o1, i1), lokr_w2=_rn(rng, o2, i2, *k))
    elif mode == "w1_factored_w2_full":
        t.update(lokr_w1_a=_rn(rng, o1, 2), lokr_w1_b=_rn(rng, 2, i1),
                 lokr_w2=_rn(rng, o2, i2, *k))
    else:  # tucker
        t.update(lokr_w1=_rn(rng, o1, i1), lokr_t2=_rn(rng, 2, 2, *k),
                 lokr_w2_a=_rn(rng, 2, o2), lokr_w2_b=_rn(rng, 2, i2))
    return t


def _ia3(site, rng, on_input):
    return {"weight": _rn(rng, site.in_dim if on_input else site.out_dim),
            "on_input": np.asarray(on_input), "alpha": np.float32(1.0)}


def _lora(site, rng, r=2, alpha=1.0, mid=False):
    if site.kind == "linear":
        down = _rn(rng, r, site.in_dim)
        up = _rn(rng, site.out_dim, r, s=0.1)
    else:
        kh, kw = site.kernel
        down = _rn(rng, r, site.in_dim, *((1, 1) if mid else (kh, kw)))
        up = _rn(rng, site.out_dim, r, 1, 1, s=0.1)
    t = {"lora_down": down, "lora_up": up, "alpha": np.float32(alpha)}
    if mid:
        t["lora_mid"] = _rn(rng, r, r, *site.kernel)
    return t


def _dora(site, rng):
    t = _lora(site, rng, alpha=1.5)
    t["dora_scale"] = (rng.random((site.out_dim,) + (1,) * (
        len(_shape(site)) - 1)) + 0.5).astype(np.float32)
    return t


def _oft(site, rng, alpha=None, rescale=False):
    b = _half_blocks(site.out_dim)
    t = {"oft_blocks": _rn(rng, site.out_dim // b, b, b, s=0.1)}
    if alpha is not None:
        t["alpha"] = np.float32(alpha)
    if rescale:
        t["rescale"] = (rng.random((site.out_dim, 1)) + 0.5).astype(
            np.float32)
    return t


def _boft(site, rng, alpha=None, rescale=False):
    b = _half_blocks(site.out_dim, stages=2)
    t = {"oft_blocks": np.stack([_rn(rng, site.out_dim // b, b, b, s=3.0),
                                 _rn(rng, site.out_dim // b, b, b, s=0.01)])}
    if alpha is not None:
        t["alpha"] = np.float32(alpha)
    if rescale:
        t["rescale"] = (rng.random((site.out_dim, 1)) + 0.5).astype(
            np.float32)
    return t


def _glora(site, rng, r=3):
    one = (1, 1) if site.kind == "conv" else ()
    k = tuple(site.kernel) if site.kind == "conv" else ()
    return {"a1": _rn(rng, r, site.in_dim, *one, s=0.1),
            "a2": _rn(rng, site.in_dim, r, *one, s=0.1),
            "b1": _rn(rng, r, site.in_dim, *one, s=0.1),
            "b2": _rn(rng, site.out_dim, r, *k, s=0.1),
            "alpha": np.float32(1.5)}


def _full(site, rng, bias):
    t = {"diff": _rn(rng, *_shape(site), s=0.01)}
    if bias:
        t["diff_b"] = _rn(rng, site.out_dim, s=0.01)
    return t


CASES = {
    "loha_linear": (0, _loha),
    "loha_default_alpha": (1, lambda s, g: _loha(s, g, alpha=None, r=2)),
    "loha_conv_flat": (2, lambda s, g: _loha(s, g, alpha=None, r=2)),
    "loha_conv_tucker": (2, _loha_tucker),
    "lokr_linear_w2_factored": (0, lambda s, g: _lokr(
        s, g, "w1_full_w2_factored")),
    "lokr_linear_full": (0, lambda s, g: _lokr(s, g, "full")),
    "lokr_linear_w1_factored": (1, lambda s, g: _lokr(
        s, g, "w1_factored_w2_full")),
    "lokr_conv_full": (2, lambda s, g: _lokr(s, g, "full")),
    "lokr_conv_tucker": (2, lambda s, g: _lokr(s, g, "tucker")),
    "ia3_input": (0, lambda s, g: _ia3(s, g, True)),
    "ia3_output": (2, lambda s, g: _ia3(s, g, False)),
    "dora_linear": (0, _dora),
    "dora_conv": (2, _dora),
    "oft_linear": (0, _oft),
    "oft_clamped": (0, lambda s, g: _oft(s, g, alpha=1e-3)),
    "oft_rescaled": (1, lambda s, g: _oft(s, g, rescale=True)),
    "oft_conv": (2, _oft),
    "boft_linear": (0, _boft),
    "boft_global_clamp": (0, lambda s, g: _boft(s, g, alpha=0.05)),
    "boft_conv_rescaled": (2, lambda s, g: _boft(s, g, rescale=True)),
    "glora_linear": (0, _glora),
    "glora_conv": (2, _glora),
    "full_with_bias": (1, lambda s, g: _full(s, g, True)),
    "full_conv": (2, lambda s, g: _full(s, g, False)),
}


def _module_file(tmp_path, site, leaves, name="lyco.safetensors"):
    key = kohya_key("unet", site.name)
    tensors = {}
    for leaf, v in leaves.items():
        w = leaf in ("lora_up", "lora_down", "lora_mid", "a1", "a2", "b1",
                     "b2")
        tensors[f"{key}.{leaf}.weight" if w else f"{key}.{leaf}"] = v
    return _save(tmp_path, tensors, name)


def _save(tmp_path, tensors, name="lyco.safetensors"):
    p = str(tmp_path / name)
    save_file({k: np.asarray(v) for k, v in tensors.items()}, p)
    return p


def _load_both(path, params, cfg, text=False):
    """(lora_tpu's (lu, lt), the port's (lu, lt)) of one file, with the
    config's LoCon sites and base params."""
    unet_cfg, text_cfg = CFGS[cfg]
    (tp, npar) = params[cfg]
    kw = dict(unet_sites=unet_locon_sites(unet_cfg),
              text_sites=text_encoder_locon_sites(text_cfg) if text else None)
    return (j_lyco.load_lycoris(path, unet_params=npar["unet"],
                                text_params=npar["text"], **kw),
            t_lyco.load_lycoris(path, unet_params=tp["unet"],
                                text_params=tp["text"], **kw))


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("case", CASES)
def test_algorithm_loads_the_same(case, cfg, params, tmp_path):
    site_i, build = CASES[case]
    site = _sites(cfg)[site_i]
    leaves = build(site, np.random.default_rng(list(CASES).index(case)))
    p = _module_file(tmp_path, site, leaves)
    with SafetensorsFile(p) as f:
        keys = list(f.keys())
    assert t_lyco.is_lycoris(keys) and j_lyco.is_lycoris(keys)
    (jlu, _), (tlu, tlt) = _load_both(p, params, cfg)
    assert tlt is None
    assert list(tlu["sites"]) == [site.name]
    assert_entries_match(tlu, jlu)


@pytest.mark.parametrize("cfg", CFGS)
def test_mixed_file_with_norms_and_text_loads_the_same(cfg, params,
                                                       tmp_path):
    """One file: a plain LoRA with a CP mid, LoHa, LoKr, DoRA, OFT, a full
    module with diff_b, norm modules on a resnet's norm1 and a CLIP
    layer_norm1, and text-encoder LoHa and IA3 modules."""
    unet_cfg, text_cfg = CFGS[cfg]
    lin, ff, conv = _sites(cfg)
    ls = unet_locon_sites(unet_cfg)
    conv2 = next(s for s in ls if s.name.endswith("resnets.1.conv1"))
    ts = text_encoder_locon_sites(text_cfg)
    rng = np.random.default_rng(5)
    tensors = {}
    for model, site, leaves in (
            ("unet", conv2, _lora(conv2, rng, r=2, alpha=4.0, mid=True)),
            ("unet", lin, _loha(lin, rng)),
            ("unet", ff, _full(ff, rng, True)),
            ("unet", conv, _dora(conv, rng)),
            ("text_encoder", ts[0], _loha(ts[0], rng)),
            ("text_encoder", ts[4], _ia3(ts[4], rng, True))):
        key = kohya_key(model, site.name)
        for leaf, v in leaves.items():
            w = leaf in ("lora_up", "lora_down", "lora_mid")
            tensors[f"{key}.{leaf}.weight" if w else f"{key}.{leaf}"] = v
    npath = "down_blocks.0.resnets.0.norm1"
    tpath = "text_model.encoder.layers.0.layer_norm1"
    c = params[cfg][1]["unet"][npath + ".weight"].shape[0]
    d = text_cfg.hidden_size
    tensors.update({
        "lora_unet_" + npath.replace(".", "_") + ".w_norm": _rn(rng, c),
        "lora_unet_" + npath.replace(".", "_") + ".b_norm": _rn(rng, c),
        "lora_te_" + tpath.replace(".", "_") + ".w_norm": _rn(rng, d)})
    p = _save(tmp_path, tensors)
    (jlu, jlt), (tlu, tlt) = _load_both(p, params, cfg, text=True)
    assert set(tlu["param_deltas"]) == {npath + ".weight", npath + ".bias",
                                        ff.name + ".bias"}
    assert set(tlt["param_deltas"]) == {tpath + ".weight"}
    assert "up" in tlu["sites"][conv2.name]
    assert_entries_match(tlu, jlu)
    assert_entries_match(tlt, jlt)
    # convert.lora_from_jax carries the param deltas across
    carried = lora_from_jax({
        "sites": {n: {k: np.asarray(v) for k, v in e.items()}
                  for n, e in jlu["sites"].items()},
        "scale": np.asarray(jlu["scale"]),
        "param_deltas": jlu["param_deltas"]})
    assert carried["param_deltas"][npath + ".weight"].dtype == torch.float32
    assert_entries_match(carried, jlu, rel=0)
    # dtype asked for: the entries; param deltas stay f32
    (tp, _) = params[cfg]
    lu16, _ = t_lyco.load_lycoris(p, unet_sites=ls, unet_params=tp["unet"],
                                  dtype=torch.bfloat16)
    assert {t.dtype for e in lu16["sites"].values() for t in e.values()} \
        == {torch.bfloat16}
    assert {t.dtype for t in lu16["param_deltas"].values()} == {
        torch.float32}


def test_boft_hand_computed_4_channel(tmp_path):
    """lora_tpu's hand-derived 4-channel BOFT golden (two stages of 2x2
    Givens blocks) through the port: 1/(1+s^2) [[1-s^2, 2s], [-2s, 1-s^2]]
    per block, stage 1 pairing channels (0, 2) and (1, 3)."""
    site = Site("fake.proj", "linear", 3, 4)
    w = np.arange(12, dtype=np.float32).reshape(4, 3) / 7.0 + 0.25
    s = [0.3, -0.5, 0.2, 0.7]
    q = np.zeros((2, 2, 2, 2), np.float32)
    q[0, 0, 0, 1], q[0, 1, 0, 1] = s[0], s[1]
    q[1, 0, 0, 1], q[1, 1, 0, 1] = s[2], s[3]

    def giv(v):
        d = 1.0 + v * v
        return np.array([[(1 - v * v) / d, 2 * v / d],
                         [-2 * v / d, (1 - v * v) / d]])

    r0 = np.zeros((4, 4))
    r0[:2, :2], r0[2:, 2:] = giv(s[0]), giv(s[1])
    r1 = np.zeros((4, 4))
    for (a, c_), g in (((0, 2), giv(s[2])), ((1, 3), giv(s[3]))):
        r1[a, a], r1[a, c_] = g[0, 0], g[0, 1]
        r1[c_, a], r1[c_, c_] = g[1, 0], g[1, 1]
    p = _module_file(tmp_path, site, {"oft_blocks": q})
    lu, _ = t_lyco.load_lycoris(p, unet_sites=[site], unet_params={
        "fake.proj.weight": torch.from_numpy(w)})
    np.testing.assert_allclose(lu["sites"][site.name]["delta"].numpy(),
                               r1 @ r0 @ w - w, rtol=1e-5, atol=1e-6)


def _rejections(cfg, npar):
    """name -> (tensors, pass params); each refused by both packages."""
    lin, ff, conv = _sites(cfg)
    rng = np.random.default_rng(11)
    k = {s: kohya_key("unet", s.name) for s in (lin, ff, conv)}
    loha = {f"{k[lin]}.{n}": v for n, v in _loha(lin, rng).items()}
    npath = "down_blocks.0.resnets.0.norm1"
    nbase = "lora_unet_" + npath.replace(".", "_")
    c = npar["unet"][npath + ".weight"].shape[0]
    kq = k[lin]
    return {
        "mixed norm leaf": ({**loha, kq + ".w_norm": _rn(rng, lin.out_dim)},
                            True),
        "unrecognized leaf": ({**loha, kq + ".mystery_factor":
                               np.zeros((2, 2), np.float32)}, True),
        "loha + dora_scale": ({**loha, kq + ".dora_scale":
                               np.ones((lin.out_dim, 1), np.float32)}, True),
        "ia3 without params": ({kq + ".weight": _rn(rng, lin.in_dim),
                                kq + ".on_input": np.asarray(True)}, False),
        "ia3 without on_input": ({kq + ".weight": _rn(rng, lin.in_dim)},
                                 True),
        "ia3 gain size": ({kq + ".weight": _rn(rng, lin.in_dim + 1),
                           kq + ".on_input": np.asarray(True)}, True),
        "glora without params": ({f"{kq}.{n}.weight" if n != "alpha"
                                  else f"{kq}.alpha": v
                                  for n, v in _glora(lin, rng).items()},
                                 False),
        "glora 3x3 a1": ({f"{k[conv]}.{n}.weight" if n != "alpha"
                          else f"{k[conv]}.alpha": v for n, v in
                          {**_glora(conv, rng), "a1": _rn(
                              rng, 3, conv.in_dim, 3, 3)}.items()}, True),
        "boft odd blocks": ({kq + ".oft_blocks": np.zeros(
            (1, lin.out_dim // 4, 4, 4), np.float32)[:, :, :3, :3]}, True),
        "oft grid": ({kq + ".oft_blocks": np.zeros((3, 5, 5), np.float32)},
                     True),
        "oft rescale size": ({kq + ".oft_blocks": _rn(
            rng, lin.out_dim // 4, 4, 4), kq + ".rescale": np.ones(
                (lin.out_dim + 1, 1), np.float32)}, True),
        "dora scale size": ({f"{kq}.{n}.weight" if n in ("lora_up",
                                                         "lora_down")
                             else f"{kq}.{n}": v for n, v in
                             {**_dora(lin, rng), "dora_scale": np.ones(
                                 (lin.out_dim + 2, 1), np.float32)}.items()},
                            True),
        "full bias on a bias-less site": ({kq + ".diff": _rn(
            rng, lin.out_dim, lin.in_dim), kq + ".diff_b": _rn(
                rng, lin.out_dim)}, True),
        "full bias without params": ({k[ff] + ".diff": _rn(
            rng, ff.out_dim, ff.in_dim), k[ff] + ".diff_b": _rn(
                rng, ff.out_dim)}, False),
        "full bias shape": ({k[ff] + ".diff": _rn(rng, ff.out_dim, ff.in_dim),
                             k[ff] + ".diff_b": _rn(rng, ff.out_dim + 1)},
                            True),
        "full diff shape": ({k[ff] + ".diff": _rn(rng, ff.in_dim,
                                                   ff.out_dim)}, True),
        "full bias only": ({k[ff] + ".diff_b": _rn(rng, ff.out_dim)}, True),
        "norm without params": ({nbase + ".w_norm": _rn(rng, c)}, False),
        "norm nowhere": ({"lora_unet_nowhere_norm9.w_norm": _rn(rng, c)},
                         True),
        "norm shape": ({nbase + ".w_norm": _rn(rng, c - 1)}, True),
        "norm b_norm shape": ({"lora_unet_conv_in.b_norm": _rn(rng, 4)},
                              True),
        "norm on a matmul site": ({kq + ".w_norm": _rn(rng, lin.out_dim)},
                                  True),
        "unknown prefix": ({"lora_te2_text_model_x.diff": _rn(rng, 2, 2)},
                           True),
        "outside the sites": ({"lora_unet_nowhere_proj.diff": _rn(rng, 2, 2)},
                              True),
        "loha missing factor": ({kq + ".hada_w1_a": _rn(rng, lin.out_dim, 2)},
                                True),
        "loha one tucker core": ({**{f"{k[conv]}.{n}": v for n, v in
                                     _loha_tucker(conv, rng).items()
                                     if n != "hada_t2"}}, True),
        "loha tucker on a linear": ({**loha, kq + ".hada_t1": _rn(
            rng, 3, 3, 1, 1), kq + ".hada_t2": _rn(rng, 3, 3, 1, 1)}, True),
        "lokr missing w1": ({kq + ".lokr_w2": _rn(rng, 4, 4)}, True),
        "lokr w1 twice": ({kq + ".lokr_w1": _rn(rng, 4, 4),
                           kq + ".lokr_w1_a": _rn(rng, 4, 2),
                           kq + ".lokr_w2": _rn(rng, 4, 4)}, True),
        "lokr missing w2": ({kq + ".lokr_w1": _rn(rng, 4, 4)}, True),
        "lokr t2 without factors": ({k[conv] + ".lokr_w1": _rn(rng, 4, 4),
                                     k[conv] + ".lokr_t2": _rn(
                                         rng, 2, 2, 3, 3)}, True),
        "lokr t2 on a linear": ({kq + ".lokr_w1": _rn(rng, 4, 4),
                                 kq + ".lokr_t2": _rn(rng, 2, 2, 1, 1),
                                 kq + ".lokr_w2_a": _rn(rng, 2, 4),
                                 kq + ".lokr_w2_b": _rn(rng, 2, 4)}, True),
        "lokr kron shapes": ({kq + ".lokr_w1": _rn(rng, 3, 4),
                              kq + ".lokr_w2": _rn(rng, 4, 4)}, True),
        "lokr w1 3-D": ({kq + ".lokr_w1": _rn(rng, 4, 4, 1),
                         kq + ".lokr_w2": _rn(rng, 4, 4)}, True),
    }


@pytest.mark.parametrize("cfg", CFGS)
def test_rejections_match_lora_tpu(cfg, params, tmp_path):
    unet_cfg = CFGS[cfg][0]
    tp, npar = params[cfg]
    sites = unet_locon_sites(unet_cfg)
    for name, (tensors, with_params) in _rejections(cfg, npar).items():
        p = _save(tmp_path, tensors, name.replace(" ", "_") + ".st")
        same_error(
            lambda: j_lyco.load_lycoris(
                p, unet_sites=sites,
                unet_params=npar["unet"] if with_params else None),
            lambda: t_lyco.load_lycoris(
                p, unet_sites=sites,
                unet_params=tp["unet"] if with_params else None))


@pytest.mark.parametrize("case", ["ia3_input", "dora_linear", "oft_linear",
                                  "boft_linear", "glora_conv"])
def test_int8_base_refuses_base_dependent_modules(case, tmp_path):
    """On a quantized pipe the base weight is int8 codes: the module is
    refused with its name and algorithm, never composed on the codes."""
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(4), "cpu", unet_cfg=j_cfg.TINY_UNET,
        text_cfg=j_cfg.TINY_TEXT, vae_cfg=j_cfg.TINY_VAE)
    site_i, build = CASES[case]
    site = _sites("sd1")[site_i]
    p = _module_file(tmp_path, site, build(site, np.random.default_rng(6)))
    pipe.patch_pipe(p)  # a float base: loads
    pipe.remove_lora()
    pipe.quantize_base()
    algo = case.split("_")[0].upper().replace("BOFT", "OFT")
    with pytest.raises(ValueError, match=(
            f"{algo} module {kohya_key('unet', site.name)!r}: the unet base "
            f"weight {site.name + '.weight'!r} is int8-quantized")):
        pipe.patch_pipe(p)
    # modules that do not read the base weight still load on int8
    ok = _module_file(tmp_path, site, _full(site, np.random.default_rng(7),
                                            False), "ok.safetensors")
    pipe.patch_pipe(ok)
    assert "delta" in pipe.lora_unet["sites"][site.name]
    with pytest.raises(ValueError, match="collapse the LoRA before "
                       "quantize_base"):
        pipe.collapse_lora()


def _every_algorithm_file(tmp_path, cfg, pipe):
    """A file over the config's sites: each algorithm on its own module
    (UNet and text), norm modules on every resnet norm1 and every CLIP
    layer_norm1, and a full module's bias diff."""
    unet_cfg, text_cfg = CFGS[cfg]
    ls = [s for s in unet_locon_sites(unet_cfg)]
    lin = [s for s in ls if s.kind == "linear"]
    conv = [s for s in ls if s.kind == "conv" and s.kernel == (3, 3)]
    ts = text_encoder_locon_sites(text_cfg)
    rng = np.random.default_rng(8)
    plan = [(lin[0], _loha(lin[0], rng)), (lin[1], _lokr(lin[1], rng,
                                                        "full")),
            (lin[2], _ia3(lin[2], rng, False)), (lin[3], _dora(lin[3], rng)),
            (lin[4], _oft(lin[4], rng, rescale=True)),
            (lin[5], _full(lin[5], rng, True)),
            (lin[6], _glora(lin[6], rng)), (lin[7], _boft(lin[7], rng)),
            (lin[8], _lora(lin[8], rng, alpha=0.5)),
            (conv[0], _loha_tucker(conv[0], rng)),
            (conv[1], _lokr(conv[1], rng, "tucker")),
            (conv[2], _lora(conv[2], rng, alpha=4.0, mid=True)),
            (conv[3], _glora(conv[3], rng))]
    tensors = {}
    for model, site, leaves in ([("unet", s, lv) for s, lv in plan]
                                + [("text_encoder", ts[0], _loha(ts[0], rng)),
                                   ("text_encoder", ts[1],
                                    _dora(ts[1], rng))]):
        key = kohya_key(model, site.name)
        for leaf, v in leaves.items():
            w = leaf in ("lora_up", "lora_down", "lora_mid", "a1", "a2",
                         "b1", "b2")
            tensors[f"{key}.{leaf}.weight" if w else f"{key}.{leaf}"] = v
    for prefix, module in (("lora_unet", pipe.unet),
                           ("lora_te", pipe.text_encoder)):
        for name, t in module.flat_params().items():
            if name.endswith(("norm1.weight", "layer_norm1.weight")):
                base = prefix + "_" + name[:-len(".weight")].replace(".", "_")
                tensors[base + ".w_norm"] = _rn(rng, t.shape[0], s=0.3)
                tensors[base + ".b_norm"] = _rn(rng, t.shape[0], s=0.3)
    return _save(tmp_path, tensors, f"every_{cfg}.safetensors")


@pytest.mark.parametrize("cfg", CFGS)
def test_patch_pipe_lycoris_matches_jax(cfg, tmp_path):
    """patch_pipe of a file with every algorithm and norm modules: the
    same trees and base params as lora_tpu's pipe, and at scale 0.7 one
    UNet call and one text-encoder call agree with the JAX pipe."""
    jpipe, pipe = make_pipes(cfg, seed=2)
    p = _every_algorithm_file(tmp_path, cfg, pipe)
    jpipe.patch_pipe(p)
    pipe.patch_pipe(p)
    assert pipe.has_base_deltas("unet") and pipe.has_base_deltas(
        "text_encoder")
    assert "param_deltas" not in pipe.lora_unet
    assert_entries_match(pipe.lora_unet, jpipe.lora_unet)
    assert_entries_match(pipe.lora_text, jpipe.lora_text)
    for p_ in (jpipe, pipe):
        p_.tune_lora_scale(0.7)
    for module, jparams in ((pipe.unet, jpipe.unet_params),
                            (pipe.text_encoder, jpipe.text_params)):
        for k, v in module.flat_params().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    (ju, tu), (jt, tt) = unet_and_text_calls(jpipe, pipe)
    np.testing.assert_allclose(tu, ju, **PIPE_TOL)
    np.testing.assert_allclose(tt, jt, **PIPE_TOL)


def _norm_full_file(tmp_path, pipe, name="nf.safetensors", w=None):
    """lora_tpu's lifecycle fixture: w_norm/b_norm on the first resnet's
    norm1 and a full module (diff + diff_b) on the first GEGLU projection."""
    rng = np.random.default_rng(60)
    npath = "down_blocks.0.resnets.0.norm1"
    c = pipe.unet.flat_params()[npath + ".weight"].shape[0]
    ff = _sites("sd1")[1]
    fkey = kohya_key("unet", ff.name)
    nbase = "lora_unet_" + npath.replace(".", "_")
    tensors = {nbase + ".w_norm": _rn(rng, c, s=0.3) if w is None
               else np.full(c, w, np.float32)}
    if w is None:
        tensors.update({nbase + ".b_norm": _rn(rng, c, s=0.3),
                        fkey + ".diff": _rn(rng, ff.out_dim, ff.in_dim,
                                            s=0.05),
                        fkey + ".diff_b": _rn(rng, ff.out_dim, s=0.05)})
    return _save(tmp_path, tensors, name), npath, ff


def _tiny_pipe(seed=2):
    return StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(seed), "cpu", unet_cfg=j_cfg.TINY_UNET,
        text_cfg=j_cfg.TINY_TEXT, vae_cfg=j_cfg.TINY_VAE)


def _image(pipe):
    return pipe("a cat", num_inference_steps=2, height=64, width=64,
                generator=torch.Generator().manual_seed(3))


def test_norm_full_modules_pipe_lifecycle(tmp_path):
    """patch_pipe applies norm w/b deltas and a full module's bias diff to
    the base params; tune_lora_scale lerps them exactly (alpha 0 equals the
    unpatched pipe); remove_lora restores the originals bit for bit;
    collapse folds at alpha and drops the record."""
    pipe = _tiny_pipe()
    p, npath, ff = _norm_full_file(tmp_path, pipe)
    params = pipe.unet.flat_params()
    orig = {k: params[k].clone() for k in (
        npath + ".weight", npath + ".bias", ff.name + ".bias")}
    base_img = _image(pipe)
    gen = pipe.adapter_generation
    pipe.patch_pipe(p)
    assert pipe.adapter_generation == gen + 1
    assert set(pipe.lora_unet["sites"]) == {ff.name}
    assert "param_deltas" not in pipe.lora_unet
    assert pipe.has_base_deltas("unet")
    assert not pipe.has_base_deltas("text_encoder")
    assert pipe.base_delta_alpha("unet") == 1.0
    deltas = pipe.base_deltas["unet"]["deltas"]
    params = pipe.unet.flat_params()
    for k in orig:
        np.testing.assert_allclose(params[k].numpy(),
                                   (orig[k] + deltas[k]).numpy(), rtol=1e-6)
    patched_img = _image(pipe)
    assert np.abs(patched_img - base_img).max() > 1e-4

    pipe.tune_lora_scale(0.0)
    assert pipe.base_delta_alpha("unet") == 0.0
    params = pipe.unet.flat_params()
    for k in orig:
        assert torch.equal(params[k], orig[k])
    np.testing.assert_allclose(_image(pipe), base_img, atol=1e-5)
    pipe.tune_lora_scale(0.5)
    np.testing.assert_allclose(
        pipe.unet.flat_params()[npath + ".weight"].numpy(),
        (orig[npath + ".weight"] + 0.5 * deltas[npath + ".weight"]).numpy(),
        rtol=1e-5)

    pipe.remove_lora()
    assert pipe.base_deltas is None and not pipe.has_base_deltas("unet")
    params = pipe.unet.flat_params()
    for k in orig:
        assert torch.equal(params[k], orig[k])
    np.testing.assert_allclose(_image(pipe), base_img, atol=1e-6)

    pipe.patch_pipe(p)
    before = _image(pipe)
    pipe.collapse_lora(1.0)
    assert pipe.base_deltas is None and pipe.lora_unet is None
    np.testing.assert_allclose(
        pipe.unet.flat_params()[npath + ".weight"].numpy(),
        (orig[npath + ".weight"] + deltas[npath + ".weight"]).numpy(),
        rtol=1e-6)
    np.testing.assert_allclose(_image(pipe), before, atol=2e-4)


def test_norm_deltas_repatch_restores_previous(tmp_path):
    """Patching file B over file A first restores A's base-param edits:
    deltas never stack across patch_pipe calls."""
    pipe = _tiny_pipe(4)
    pa, npath, _ = _norm_full_file(tmp_path, pipe, "a.safetensors", w=1.0)
    pb, _, _ = _norm_full_file(tmp_path, pipe, "b.safetensors", w=-2.0)
    orig = pipe.unet.flat_params()[npath + ".weight"].clone()
    pipe.patch_pipe(pa)
    assert torch.equal(pipe.unet.flat_params()[npath + ".weight"], orig + 1)
    pipe.patch_pipe(pb)
    assert torch.equal(pipe.unet.flat_params()[npath + ".weight"], orig - 2)
    pipe.remove_lora()
    assert torch.equal(pipe.unet.flat_params()[npath + ".weight"], orig)


def test_norm_deltas_cleared_by_plain_lora_repatch(tmp_path):
    """A plain kohya LoRA (and an indexed-schema file) patched over a
    LyCORIS norm adapter also restores its base-param edits."""
    from lora_tpu.formats.kohya import save_kohya

    pipe = _tiny_pipe(4)
    pa, npath, _ = _norm_full_file(tmp_path, pipe, "a.safetensors", w=1.0)
    orig = pipe.unet.flat_params()[npath + ".weight"].clone()
    lin = _sites("sd1")[0]
    pb = str(tmp_path / "b.safetensors")
    rng = np.random.default_rng(7)
    save_kohya(pb, lora_unet=j_lora.lora_from_pairs(
        [(_rn(rng, lin.out_dim, 2), _rn(rng, 2, lin.in_dim))], [lin]),
        unet_sites=[lin])
    pipe.patch_pipe(pa)
    assert pipe.has_base_deltas("unet")
    pipe.patch_pipe(pb)
    assert not pipe.has_base_deltas("unet")
    assert torch.equal(pipe.unet.flat_params()[npath + ".weight"], orig)
    assert list(pipe.lora_unet["sites"]) == [lin.name]


@pytest.mark.parametrize("cfg", CFGS)
def test_collapse_equals_patched_forward(cfg, tmp_path):
    """Every algorithm and the norm deltas at alpha 0.6: one UNet call and
    one text-encoder call with the adapters equal the same calls after
    collapse_lora(0.6), which folds the base deltas at 0.6 too; and the
    folded weights equal lora_tpu's collapse of the same pipe."""
    jpipe, pipe = make_pipes(cfg, seed=5)
    p = _every_algorithm_file(tmp_path, cfg, pipe)
    pipe.patch_pipe(p)
    jpipe.patch_pipe(p)
    pipe.tune_lora_scale(0.6)
    (_, patched_u), (_, patched_t) = unet_and_text_calls(jpipe, pipe)
    pipe.collapse_lora(0.6)
    jpipe.collapse_lora(0.6)
    assert pipe.lora_unet is None and pipe.base_deltas is None
    (ju, folded_u), (jt, folded_t) = unet_and_text_calls(jpipe, pipe)
    np.testing.assert_allclose(folded_u, patched_u, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(folded_t, patched_t, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(folded_u, ju, **PIPE_TOL)
    np.testing.assert_allclose(folded_t, jt, **PIPE_TOL)
    for module, jparams in ((pipe.unet, jpipe.unet_params),
                            (pipe.text_encoder, jpipe.text_params)):
        for k, v in module.flat_params().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_collapse_of_delta_entries_through_core(tmp_path):
    """core/lora.collapse_lora of a LyCORIS tree (deltas and factored
    entries) equals lora_tpu's on the same params."""
    pipe = _tiny_pipe(6)
    p = _every_algorithm_file(tmp_path, "sd1", pipe)
    tp = pipe.unet.flat_params()
    npar = {k: v.numpy() for k, v in tp.items()}
    sites = unet_locon_sites(j_cfg.TINY_UNET)
    jlu, _ = j_lyco.load_lycoris(p, unet_sites=sites, unet_params=npar)
    tlu, _ = t_lyco.load_lycoris(p, unet_sites=sites, unet_params=tp)
    ref = j_lora.collapse_lora({k: jnp.asarray(v) for k, v in npar.items()},
                               jlu, 0.3)
    got = t_lora.collapse_lora(tp, tlu, 0.3)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _chip_smoke():
    """chip_smoke.py (the repository root's script) as a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_adapters",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cfg", CFGS)
def test_chip_smoke_adapter_files_load_the_same(cfg, tmp_path):
    """The files chip_smoke.py's phase 11 writes from a pipeline (K: LoCon
    with CP convs and alpha != rank; L: every algorithm round-robin over
    the LoCon sites, norm modules; L without the base-weight-dependent
    algorithms), here from a tiny CPU pipeline: lora_tpu and the port load
    them to the same trees."""
    from lora_tpu.formats import kohya as j_kohya
    from lora_tpu_torch.formats import kohya as t_kohya

    cs = _chip_smoke()
    _, pipe = make_pipes(cfg, seed=7)
    gen = torch.Generator().manual_seed(8)
    unet_cfg, text_cfg = CFGS[cfg]
    sites = dict(unet_sites=unet_locon_sites(unet_cfg),
                 text_sites=text_encoder_locon_sites(text_cfg))
    k_path = str(tmp_path / "k.safetensors")
    counts = cs._kohya_file(pipe, k_path, gen)
    assert counts["cp_convs"] > 0
    (jlu, jlt), (tlu, tlt) = (j_kohya.load_kohya(k_path, **sites),
                              t_kohya.load_kohya(k_path, **sites))
    assert len(tlu["sites"]) + len(tlt["sites"]) == counts["modules"]
    assert_entries_match(tlu, jlu)
    assert_entries_match(tlt, jlt)
    tp = {"unet": pipe.unet.flat_params(),
          "text": pipe.text_encoder.flat_params()}
    npar = {k: {n: v.numpy() for n, v in d.items()} for k, d in tp.items()}
    for exclude in ((), cs.BASE_DEPENDENT):
        l_path = str(tmp_path / f"l{len(exclude)}.safetensors")
        info = cs._lycoris_file(pipe, l_path, gen, exclude=exclude)
        assert set(info["counts"]["conv"]) == set(
            cs.LYCORIS_CONV) - set(exclude)
        jlu, jlt = j_lyco.load_lycoris(l_path, unet_params=npar["unet"],
                                       text_params=npar["text"], **sites)
        tlu, tlt = t_lyco.load_lycoris(l_path, unet_params=tp["unet"],
                                       text_params=tp["text"], **sites)
        assert len(tlu["sites"]) + len(tlt["sites"]) == len(info["plan"])
        assert_entries_match(tlu, jlu)
        assert_entries_match(tlt, jlt)
