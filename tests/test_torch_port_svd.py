"""The port's SVD distillation (lora_tpu_torch/core/svd.py) and its CLI
(cli/lora_distill.py) against lora_tpu's on the tiny configs, in f32.
Singular vectors are fixed only up to sign, and LAPACK under XLA and under
torch may choose differently, so every check compares up @ down (and the
clamp threshold), never the factors: the products within 1e-5 relative L2
and, where a clamp cuts, the threshold within 2e-6 relative, on residuals
with distinct singular values. The port factors in f64 (core/svd.py), so
these bounds measure lora_tpu's f32 factorization against the f64 one;
without a clamp the port's product is held to the f64 truncation too. The CLI runs in every mode (the default, --extended,
--locon, --from_lora on kohya and LyCORIS files, an SDXL directory pair
and --from_lora on kohya-XL and LyCORIS-XL files); the trees it saves are
held to those bounds, and its files to the same keys and metadata as
lora_tpu's with products within fp16 storage's rounding. Every refusal
carries lora_tpu's message."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.cli import lora_distill as j_cli  # noqa: E402
from lora_tpu.core import svd as j_svd  # noqa: E402
from lora_tpu.formats import kohya as j_kohya  # noqa: E402
from lora_tpu_torch.cli import lora_distill as t_cli  # noqa: E402
from lora_tpu_torch.core import svd as t_svd  # noqa: E402
from lora_tpu_torch.core.lora import lora_from_pairs  # noqa: E402
from lora_tpu_torch.core.sites import (  # noqa: E402
    text_encoder_locon_sites,
    text_encoder_lora_sites,
    unet_locon_sites,
    unet_lora_sites,
)
from lora_tpu_torch.formats import kohya as t_kohya  # noqa: E402
from lora_tpu_torch.formats.reader import load_file, save_file  # noqa: E402
from lora_tpu_torch.formats.safetensors_io import (  # noqa: E402
    UNET_EXTENDED_TARGET_REPLACE,
)
from lora_tpu_torch.models import config as cfg  # noqa: E402
from lora_tpu_torch.models.hf_import import save_pipeline_params  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

PROD_REL = 1e-5
# lora_tpu factors in f32: on the tree's sites its clamp threshold sits up
# to 1.2e-6 from the port's f64 one (about 20 f32 ulps: an f32 SVD's
# backward error is ~n * eps of the matrix), so the bound is 2e-6, not 1e-6
THRESH_REL = 2e-6
# the files store fp16 factors: a product may move by the rounding of its
# factors (2^-11 relative each)
FILE_REL = 2e-3


def spectrum_delta(shape, rng, k=None, top=0.05):
    """A residual of `shape` (out, in[, kh, kw]) with k distinct singular
    values top * 0.75^i (all of them by default) and random singular
    vectors."""
    m, n = shape[0], int(np.prod(shape[1:]))
    k = k or min(m, n)
    a, _ = np.linalg.qr(rng.standard_normal((m, k)))
    b, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = top * 0.75 ** np.arange(k)
    return ((a * s) @ b.T).reshape(shape).astype(np.float32)


def rel_l2(got, want):
    """||got - want|| / ||want||; 0 where both are zero (a site the adapter
    leaves alone)."""
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def product(up, down):
    up, down = (np.asarray(x, np.float32) for x in (up, down))
    return up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)


def threshold(up, down):
    return max(float(np.abs(np.asarray(up)).max()),
               float(np.abs(np.asarray(down)).max()))


@pytest.mark.parametrize("shape", [(24, 40), (40, 24), (16, 8, 3, 3),
                                   (12, 20, 1, 1)])
@pytest.mark.parametrize("q", [1.0, 0.9])
def test_svd_distill_site(shape, q):
    rng = np.random.default_rng(sum(shape))
    base = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    tuned = base + spectrum_delta(shape, rng)
    up_j, down_j = j_svd.svd_distill_site(jnp.asarray(base),
                                          jnp.asarray(tuned), 4, q)
    up_t, down_t = t_svd.svd_distill_site(torch.from_numpy(base),
                                          torch.from_numpy(tuned), 4, q)
    assert up_t.dtype == down_t.dtype == torch.float32
    assert tuple(up_t.shape) == up_j.shape and \
        tuple(down_t.shape) == down_j.shape
    if len(shape) == 4:
        assert tuple(up_t.shape) == (shape[0], 4, 1, 1)
        assert tuple(down_t.shape) == (4,) + shape[1:]
    assert rel_l2(product(up_t, down_t), product(up_j, down_j)) <= PROD_REL
    if q < 1.0:
        hj, ht = threshold(up_j, down_j), threshold(up_t, down_t)
        assert abs(ht - hj) <= THRESH_REL * hj
    else:  # no clamp: the rank-4 truncation of the residual
        want = (tuned - base).reshape(shape[0], -1)
        u, s, vh = np.linalg.svd(want.astype(np.float64))
        trunc = (u[:, :4] * s[:4]) @ vh[:4]
        assert rel_l2(product(up_t, down_t), trunc) <= PROD_REL


@pytest.mark.parametrize("shape", [(48, 20), (20, 48)])
def test_gram_route_matches_the_svd(shape):
    """The top factors from the Gram matrix's eigenvectors, tall and wide,
    are the f64 SVD's (to sign): U * S and Vh within 1e-12."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(spectrum_delta(shape, rng))
    us, vh = t_svd._top_factors(x, 5)
    U, S, Vh = torch.linalg.svd(x.double(), full_matrices=False)
    sign = torch.sign((vh * Vh[:5]).sum(1))
    assert torch.allclose(vh, sign[:, None] * Vh[:5], rtol=0, atol=1e-12)
    assert torch.allclose(us, sign * (U[:, :5] * S[:5]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(30, 16), (16, 30)])
def test_degenerate_residual_takes_the_svd(shape):
    """A rank-2 residual distilled at rank 4: the Gram route cannot give the
    null directions, so the full SVD does (unit rows of Vh, zero U * S
    there), and up @ down is the residual, as lora_tpu's."""
    rng = np.random.default_rng(3)
    base = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    tuned = base + spectrum_delta(shape, rng, k=2)
    us, vh = t_svd._top_factors(torch.from_numpy(tuned - base), 4)
    np.testing.assert_allclose(vh.norm(dim=1).numpy(), 1.0, atol=1e-12)
    # the f32 subtraction leaves ~1e-9 in the null directions
    assert float(us[:, 2:].abs().max()) < 1e-6
    up_t, down_t = t_svd.svd_distill_site(torch.from_numpy(base),
                                          torch.from_numpy(tuned), 4, 1.0)
    up_j, down_j = j_svd.svd_distill_site(jnp.asarray(base),
                                          jnp.asarray(tuned), 4, 1.0)
    assert rel_l2(product(up_t, down_t), product(up_j, down_j)) <= PROD_REL
    assert rel_l2(product(up_t, down_t), tuned - base) <= PROD_REL


def test_svd_distill_tree():
    """svd_distill over every fourth of the tiny UNet's extended sites
    (linears and convs of each shape class): every site's product and
    threshold as lora_tpu's; scale 1."""
    pipe = tiny_pipe()
    sites = unet_lora_sites(cfg.TINY_UNET, UNET_EXTENDED_TARGET_REPLACE)[::4]
    assert {s.kind for s in sites} == {"linear", "conv"}
    rng = np.random.default_rng(4)
    base = {k: v for k, v in pipe.unet.flat_params().items()}
    tuned = dict(base)
    for s in sites:
        w = base[s.name + ".weight"]
        tuned[s.name + ".weight"] = w + torch.from_numpy(
            spectrum_delta(tuple(w.shape), rng))
    got = t_svd.svd_distill(base, tuned, sites, rank=3)
    want = j_svd.svd_distill({k: jnp.asarray(v.numpy()) for k, v in
                              base.items()},
                             {k: jnp.asarray(v.numpy()) for k, v in
                              tuned.items()}, sites, rank=3)
    assert float(got["scale"]) == 1.0
    assert_trees_match(got, want, sites)


def assert_trees_match(got, want, sites, clamped=True):
    """Per site: the products within PROD_REL and, where the factors were
    clamped, the threshold (the largest |factor| left) within
    THRESH_REL."""
    assert list(got["sites"]) == [s.name for s in sites]
    for s in sites:
        g, w = got["sites"][s.name], want["sites"][s.name]
        assert rel_l2(product(g["up"].cpu(), g["down"].cpu()),
                      product(w["up"], w["down"])) <= PROD_REL, s.name
        if clamped:
            hj, ht = threshold(w["up"], w["down"]), threshold(
                g["up"].cpu(), g["down"].cpu())
            assert abs(ht - hj) <= THRESH_REL * hj, s.name


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def tiny_pipe(seed=0):
    return StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(seed), "cpu", unet_cfg=cfg.TINY_UNET,
        text_cfg=cfg.TINY_TEXT, vae_cfg=cfg.TINY_VAE)


def tiny_xl_pipe(seed=0):
    return StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(seed), "cpu",
        unet_cfg=cfg.TINY_XL_UNET, text_cfg=cfg.TINY_XL_TEXT,
        text2_cfg=cfg.TINY_XL_TEXT2, vae_cfg=cfg.TINY_VAE)


def _perturb(module, sites, rng):
    params = module.flat_params()
    for s in sites:
        k = s.name + ".weight"
        module.set_param(k, params[k] + torch.from_numpy(
            spectrum_delta(tuple(params[k].shape), rng)))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Base and tuned directories, SD and SDXL: the tuned weights differ at
    every LoCon site (a superset of every mode's sites) by a residual with
    a distinct spectrum."""
    root = tmp_path_factory.mktemp("distill")
    out = {}
    for tag, make, text_models in (("sd", tiny_pipe, ("text_encoder",)),
                                   ("xl", tiny_xl_pipe,
                                    ("text_encoder", "text_encoder_2"))):
        pipe = make()
        out[tag] = str(root / f"{tag}_base")
        save_pipeline_params(pipe, out[tag])
        rng = np.random.default_rng(8)
        _perturb(pipe.unet, unet_locon_sites(pipe.unet.cfg), rng)
        for m in text_models:
            te = getattr(pipe, m)
            _perturb(te, text_encoder_locon_sites(te.cfg), rng)
        out[tag + "_tuned"] = str(root / f"{tag}_tuned")
        save_pipeline_params(pipe, out[tag + "_tuned"])
    out["root"] = root
    return out


class _Capture:
    """Records the LoRA trees each package's savers get (the saver then
    writes its file as usual)."""

    def __init__(self, monkeypatch):
        self.trees = {}
        for tag, cli, kohya in (("j", j_cli, j_kohya), ("t", t_cli, t_kohya)):
            self._wrap(monkeypatch, cli, "save_all", tag)
            for name in ("save_kohya", "save_kohya_xl"):
                self._wrap(monkeypatch, kohya, name, tag)

    def _wrap(self, monkeypatch, mod, name, tag):
        real = getattr(mod, name)

        def saver(path, *a, **kw):
            self.trees[tag] = {k: v for k, v in kw.items()
                               if k.startswith("lora_")}
            self.trees[tag + "_sites"] = {k: v for k, v in kw.items()
                                          if k.endswith("_sites")}
            return real(path, *a, **kw)

        monkeypatch.setattr(mod, name, saver)


def targets_as_sets(meta):
    """File metadata with each model's target list (json.dumps of a set in
    both packages, so its order is the set's) as a set."""
    return {k: (frozenset(json.loads(v)) if v.startswith("[") else v)
            for k, v in meta.items()}


def run_both(monkeypatch, tmp_path, **kw):
    """lora_distill in both packages; checks the trees and the files, and
    returns the port's file."""
    cap = _Capture(monkeypatch)
    out = {}
    for tag, fn, extra in (("j", j_cli.svd_distill_cli, {}),
                           ("t", t_cli.svd_distill_cli, {"device": "cpu"})):
        out[tag] = str(tmp_path / f"{tag}.safetensors")
        fn(save_path=out[tag], **kw, **extra)
    tj, tt = cap.trees["j"], cap.trees["t"]
    assert sorted(tj) == sorted(tt)
    for k in tj:
        sites = cap.trees["t_sites"][k.replace("lora_unet", "unet_sites")
                                     .replace("lora_text2", "text2_sites")
                                     .replace("lora_text", "text_sites")]
        assert_trees_match(tt[k], tj[k], sites,
                           kw.get("clamp_quantile", 0.99) < 1.0)
    fj, mj = load_file(out["j"])
    ft, mt = load_file(out["t"])
    assert targets_as_sets(mt) == targets_as_sets(mj)
    assert list(ft) == list(fj)
    ups = sorted(k for k in ft if k.endswith(("up", "up.weight")))
    assert ups
    for k in ups:
        dk = k.replace("lora_up", "lora_down").replace(":up", ":down")
        assert ft[k].dtype == fj[k].dtype == np.float16
        assert rel_l2(product(ft[k], ft[dk]),
                      product(fj[k], fj[dk])) <= FILE_REL, k
    return out["t"], mt


@pytest.mark.parametrize("mode", ["default", "extended", "locon"])
def test_cli_directories(dirs, tmp_path, monkeypatch, mode):
    path, meta = run_both(monkeypatch, tmp_path,
                          target_model=dirs["sd_tuned"],
                          base_model=dirs["sd"], rank=3,
                          extended=mode == "extended",
                          locon=mode == "locon")
    keys = list(load_file(path)[0])
    if mode == "locon":
        assert all(k.startswith(("lora_unet_", "lora_te_")) for k in keys)
        assert any("resnets" in k for k in keys)
    else:
        assert meta["unet"] and meta["text_encoder"]
        n_unet = sum(k.startswith("unet:") for k in keys) // 2
        targets = UNET_EXTENDED_TARGET_REPLACE if mode == "extended" \
            else None
        assert n_unet == len(unet_lora_sites(cfg.TINY_UNET, targets))


def _kohya_file(path, pipe, rng, xl=False):
    """A kohya (or kohya-XL) file over the UNet's and text encoders'
    default sites, rank 2, from numpy draws."""
    def tree(sites):
        return lora_from_pairs(
            [((0.1 * rng.standard_normal(
                (s.out_dim, 2) + ((1, 1) if s.kind == "conv" else ())))
              .astype(np.float32),
              rng.standard_normal((2, s.in_dim) + tuple(
                  s.kernel if s.kind == "conv" else ())).astype(np.float32))
             for s in sites], sites)

    us = pipe.unet_sites()
    ts = text_encoder_lora_sites(pipe.text_encoder.cfg)
    if not xl:
        t_kohya.save_kohya(path, lora_unet=tree(us), unet_sites=us,
                           lora_text=tree(ts), text_sites=ts,
                           dtype=np.float32)
        return
    t2 = text_encoder_lora_sites(pipe.text_encoder_2.cfg)
    t_kohya.save_kohya_xl(path, unet_cfg=pipe.unet.cfg, lora_unet=tree(us),
                          unet_sites=us, lora_text=tree(ts), text_sites=ts,
                          lora_text2=tree(t2), text2_sites=t2,
                          dtype=np.float32)


def _loha_file(path, pipe, rng, xl=False, norm=False):
    """A LyCORIS file: LoHa modules (full-rank deltas) on two UNet sites and
    the first site of each text encoder (and, with `norm`, a norm module
    on a resnet's norm1)."""
    tensors = {}
    us = pipe.unet_sites()[:2]
    models = [("unet", s) for s in us]
    models.append(("text_encoder", text_encoder_lora_sites(
        pipe.text_encoder.cfg)[0]))
    if xl:
        models.append(("text_encoder_2", text_encoder_lora_sites(
            pipe.text_encoder_2.cfg)[0]))
    for model, s in models:
        key = (next(iter(t_kohya._xl_index(model, [s], pipe.unet.cfg)))
               if xl else t_kohya.kohya_key(model, s.name))
        for leaf, shape in (("hada_w1_a", (s.out_dim, 2)),
                            ("hada_w1_b", (2, s.in_dim)),
                            ("hada_w2_a", (s.out_dim, 2)),
                            ("hada_w2_b", (2, s.in_dim))):
            scale = 0.3 if leaf.endswith("_a") else 1.0
            tensors[f"{key}.{leaf}"] = (scale * rng.standard_normal(
                shape)).astype(np.float32)
        tensors[f"{key}.alpha"] = np.float32(2.0)
    if norm:
        c = pipe.unet.flat_params()["down_blocks.0.resnets.0.norm1.weight"]
        tensors["lora_unet_down_blocks_0_resnets_0_norm1.w_norm"] = (
            0.1 * rng.standard_normal(c.shape[0])).astype(np.float32)
    save_file(tensors, path)


@pytest.mark.parametrize("kind", ["kohya", "lycoris"])
def test_cli_from_lora(dirs, tmp_path, monkeypatch, kind):
    src = str(tmp_path / f"{kind}.safetensors")
    rng = np.random.default_rng(12)
    (_kohya_file if kind == "kohya" else _loha_file)(src, tiny_pipe(), rng)
    path, meta = run_both(monkeypatch, tmp_path, target_model=src,
                          base_model=dirs["sd"], rank=4,
                          clamp_quantile=1.0, from_lora=True)
    assert meta["unet"] and meta["text_encoder"]


@pytest.mark.parametrize("kind", ["dirs", "kohya", "lycoris"])
def test_cli_xl(dirs, tmp_path, monkeypatch, kind):
    """An SDXL base: both text encoders distill, and the file is kohya-XL
    (LDM UNet names, lora_te1_ / lora_te2_)."""
    if kind == "dirs":
        kw = dict(target_model=dirs["xl_tuned"], rank=3)
    else:
        src = str(tmp_path / f"{kind}.safetensors")
        rng = np.random.default_rng(13)
        (_kohya_file if kind == "kohya" else _loha_file)(
            src, tiny_xl_pipe(), rng, xl=True)
        kw = dict(target_model=src, rank=4, clamp_quantile=1.0,
                  from_lora=True)
    path, _ = run_both(monkeypatch, tmp_path, base_model=dirs["xl"], **kw)
    keys = list(load_file(path)[0])
    assert t_kohya.is_kohya_xl(keys)
    for prefix in ("lora_unet_output_blocks_", "lora_te1_", "lora_te2_"):
        assert any(k.startswith(prefix) for k in keys), prefix


def _same_error(fn_j, fn_t):
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)
    return str(et.value)


def test_refusals(dirs, tmp_path):
    def both(**kw):
        return _same_error(
            lambda: j_cli.svd_distill_cli(save_path=str(tmp_path / "j"),
                                          **kw),
            lambda: t_cli.svd_distill_cli(save_path=str(tmp_path / "t"),
                                          device="cpu", **kw))

    msg = both(target_model=str(tmp_path / "none"),
               base_model=str(tmp_path / "none"), extended=True, locon=True)
    assert "conflicting target flags" in msg
    rng = np.random.default_rng(14)
    ref = str(tmp_path / "ref.safetensors")
    from lora_tpu_torch.formats.safetensors_io import (
        UNET_DEFAULT_TARGET_REPLACE,
        save_safeloras_with_embeds,
    )
    save_safeloras_with_embeds(
        {"unet": ([(np.zeros((4, 2), np.float32),
                    np.zeros((2, 4), np.float32))],
                  UNET_DEFAULT_TARGET_REPLACE)}, {}, ref)
    msg = both(target_model=ref, base_model=dirs["sd"], from_lora=True)
    assert "already plain" in msg
    sd_file = str(tmp_path / "sd.safetensors")
    _kohya_file(sd_file, tiny_pipe(), rng)
    msg = both(target_model=sd_file, base_model=dirs["xl"], from_lora=True)
    assert "(SD1.x) does not match the base model family (XL)" in msg
    xl_file = str(tmp_path / "xl.safetensors")
    _kohya_file(xl_file, tiny_xl_pipe(), rng, xl=True)
    msg = both(target_model=xl_file, base_model=dirs["sd"], from_lora=True)
    assert "(XL) does not match the base model family (SD1.x)" in msg
    norm_file = str(tmp_path / "norm.safetensors")
    _loha_file(norm_file, tiny_pipe(), rng, norm=True)
    msg = both(target_model=norm_file, base_model=dirs["sd"],
               from_lora=True)
    assert "param deltas on unet" in msg


def test_cli_defaults_to_the_card(dirs, tmp_path, monkeypatch):
    """Without --device the distillation runs on the card; without CUDA it
    raises and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.svd_distill_cli(target_model=dirs["sd_tuned"],
                              base_model=dirs["sd"],
                              save_path=str(tmp_path / "o.safetensors"))
