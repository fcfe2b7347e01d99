"""The port's LoRA combinators (lora_tpu_torch/core/lora.py) against
lora_tpu's on the same trees, in float32 on the CPU: lora_from_deltas,
set_lora_diag, merge_loras, add_lora, join_loras, collapse_lora,
lora_ranks, inspect_lora, stack_loras and with_lora_idx, factored and
full-rank delta entries, SD-1 and SD-2 tiny sites; each refusal with the
JAX package's message; and the int8 refusal of collapse_lora."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import lora as j_lora  # noqa: E402
from lora_tpu.core.sites import unet_locon_sites  # noqa: E402
from lora_tpu.models.config import TINY_SD2_UNET, TINY_UNET  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax  # noqa: E402
from lora_tpu_torch.core import lora as t_lora  # noqa: E402
from lora_tpu_torch.core.quantize import quantize_params_int8  # noqa: E402

# both sides compute the same f32 products; only the summation order of
# the up @ down products differs
TOL = dict(rtol=1e-5, atol=1e-6)
CFGS = {"sd1": TINY_UNET, "sd2": TINY_SD2_UNET}


def _sites(cfg):
    """Three linear sites (two widths) and two convs (3x3 and, in SD-1,
    the 1x1 proj_in; SD-2's proj_in is linear)."""
    all_sites = unet_locon_sites(cfg)
    lin = [s for s in all_sites if s.kind == "linear"][:2]
    lin.append(next(s for s in all_sites if s.name.endswith("ff.net.2")))
    return lin + [s for s in all_sites if s.kind == "conv"][:2]


def _pairs(sites, r, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for s in sites:
        if s.kind == "linear":
            up, down = (s.out_dim, r), (r, s.in_dim)
        else:
            up, down = (s.out_dim, r, 1, 1), (r, s.in_dim) + tuple(s.kernel)
        out.append(((scale * rng.standard_normal(up)).astype(np.float32),
                    rng.standard_normal(down).astype(np.float32)))
    return out


def _deltas(sites, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(
        (s.out_dim, s.in_dim) + (() if s.kind == "linear"
                                 else tuple(s.kernel))).astype(np.float32)
        for s in sites]


def _trees(jtree):
    """(the JAX tree, the same tree in the port, its sites in the same
    order: the combinators' messages name the first site that fails)."""
    return jtree, lora_from_jax({
        "sites": {name: {k: np.asarray(v) for k, v in entry.items()}
                  for name, entry in jtree["sites"].items()},
        "scale": np.asarray(jtree["scale"])})


def _factored(sites, r=3, seed=0, scale=1.0):
    return _trees(j_lora.lora_from_pairs(_pairs(sites, r, seed), sites,
                                         scale))


def _delta_tree(sites, seed=1):
    return _trees(j_lora.lora_from_deltas(_deltas(sites, seed), sites))


def _assert_same(port, jtree):
    assert set(port["sites"]) == set(jtree["sites"])
    for name, entry in jtree["sites"].items():
        assert set(port["sites"][name]) == set(entry), name
        for k, v in entry.items():
            np.testing.assert_allclose(port["sites"][name][k].numpy(),
                                       np.asarray(v), **TOL)
    np.testing.assert_allclose(port["scale"].numpy(),
                               np.asarray(jtree["scale"]), **TOL)
    assert ("idx" in port) == ("idx" in jtree)
    if "idx" in jtree:
        np.testing.assert_array_equal(port["idx"].numpy(), jtree["idx"])


def _same_error(fn_j, fn_t, sites=()):
    """Both raise ValueError with the same message, up to which of `sites`
    it names (lora_tpu's stack_loras walks a set of names)."""
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    msgs = [str(et.value), str(ej.value)]
    for s in sorted((s.name for s in sites), key=len, reverse=True):
        msgs = [m.replace(s, "<site>") for m in msgs]
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("cfg", CFGS)
def test_lora_from_deltas(cfg):
    sites = _sites(CFGS[cfg])
    deltas = _deltas(sites, 2)
    jtree = j_lora.lora_from_deltas(deltas, sites, scale=0.7)
    port = t_lora.lora_from_deltas(deltas, sites, scale=0.7)
    _assert_same(port, jtree)
    # tensors are taken as they are, cast to the dtype asked for
    bf = t_lora.lora_from_deltas([torch.from_numpy(d) for d in deltas],
                                 sites, dtype=torch.bfloat16)
    assert all(e["delta"].dtype == torch.bfloat16
               for e in bf["sites"].values())
    _same_error(lambda: j_lora.lora_from_deltas(deltas[:1], sites),
                lambda: t_lora.lora_from_deltas(deltas[:1], sites))
    bad = [deltas[2]] + deltas[1:]
    with pytest.raises(ValueError, match="expects delta shape"):
        j_lora.lora_from_deltas(bad, sites)
    with pytest.raises(ValueError, match="expects delta shape"):
        t_lora.lora_from_deltas(bad, sites)


@pytest.mark.parametrize("cfg", CFGS)
def test_set_lora_diag_and_ranks(cfg):
    sites = _sites(CFGS[cfg])
    jtree, port = _factored(sites, r=3)
    diag = np.array([1.0, 0.0, 0.5], np.float32)
    _assert_same(t_lora.set_lora_diag(port, diag),
                 j_lora.set_lora_diag(jtree, diag))
    assert t_lora.lora_ranks(port, sites) == j_lora.lora_ranks(jtree, sites)
    jd, td = _delta_tree(sites)
    _same_error(lambda: j_lora.lora_ranks(jd, sites),
                lambda: t_lora.lora_ranks(td, sites))


@pytest.mark.parametrize("cfg", CFGS)
def test_merge_loras(cfg):
    sites = _sites(CFGS[cfg])
    j1, t1 = _factored(sites, seed=3)
    j2, t2 = _factored(sites, seed=4, scale=0.5)
    _assert_same(t_lora.merge_loras(t1, t2, 0.3, 0.9),
                 j_lora.merge_loras(j1, j2, 0.3, 0.9))
    jd1, td1 = _delta_tree(sites, 5)
    jd2, td2 = _delta_tree(sites, 6)
    _assert_same(t_lora.merge_loras(td1, td2, -0.4, 1.2),
                 j_lora.merge_loras(jd1, jd2, -0.4, 1.2))
    # refusals: a factored entry against a delta, other site sets, shapes
    _same_error(lambda: j_lora.merge_loras(j1, jd1, 1.0, 1.0),
                lambda: t_lora.merge_loras(t1, td1, 1.0, 1.0))
    js, ts = _factored(sites[:2], seed=7)
    _same_error(lambda: j_lora.merge_loras(j1, js, 1.0, 1.0),
                lambda: t_lora.merge_loras(t1, ts, 1.0, 1.0))
    jr, tr = _factored(sites, r=2, seed=8)
    _same_error(lambda: j_lora.merge_loras(j1, jr, 1.0, 1.0),
                lambda: t_lora.merge_loras(t1, tr, 1.0, 1.0))


@pytest.mark.parametrize("cfg", CFGS)
def test_add_lora(cfg):
    sites = _sites(CFGS[cfg])
    j1, t1 = _factored(sites, seed=9, scale=0.8)
    j2, t2 = _factored(sites, seed=10)
    _assert_same(t_lora.add_lora(t1, t2, 0.25, 0.75),
                 j_lora.add_lora(j1, j2, 0.25, 0.75))
    jd1, td1 = _delta_tree(sites, 11)
    jd2, td2 = _delta_tree(sites, 12)
    _assert_same(t_lora.add_lora(td1, td2, 2.0, -1.0),
                 j_lora.add_lora(jd1, jd2, 2.0, -1.0))
    _same_error(lambda: j_lora.add_lora(j1, jd1),
                lambda: t_lora.add_lora(t1, td1))
    _same_error(lambda: j_lora.add_lora(jd1, j1),
                lambda: t_lora.add_lora(td1, t1))


@pytest.mark.parametrize("cfg", CFGS)
def test_join_loras(cfg):
    sites = _sites(CFGS[cfg])
    j1, t1 = _factored(sites, r=2, seed=13)
    j2, t2 = _factored(sites, r=3, seed=14)
    (jj, jranks), (tj, tranks) = (j_lora.join_loras([j1, j2]),
                                  t_lora.join_loras([t1, t2]))
    assert tranks == jranks == [2, 3]
    _assert_same(tj, jj)
    jd, td = _delta_tree(sites)
    _same_error(lambda: j_lora.join_loras([j1, jd]),
                lambda: t_lora.join_loras([t1, td]))
    js, ts = _factored(sites[:3], seed=15)
    _same_error(lambda: j_lora.join_loras([j1, js]),
                lambda: t_lora.join_loras([t1, ts]))
    # a tree whose sites hold different ranks
    mixed_pairs = _pairs(sites[:1], 2, 16) + _pairs(sites[1:], 3, 17)
    jm, tm = _trees(j_lora.lora_from_pairs(mixed_pairs, sites))
    _same_error(lambda: j_lora.join_loras([jm, j1]),
                lambda: t_lora.join_loras([tm, t1]))


def _base_params(sites, seed=18):
    rng = np.random.default_rng(seed)
    return {s.name + ".weight": rng.standard_normal(
        (s.out_dim, s.in_dim) + (() if s.kind == "linear"
                                 else tuple(s.kernel))).astype(np.float32)
        for s in sites}


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("kind", ["factored", "delta"])
def test_collapse_lora(cfg, kind):
    sites = _sites(CFGS[cfg])
    jtree, port = (_factored(sites, seed=19) if kind == "factored"
                   else _delta_tree(sites, 20))
    params = _base_params(sites)
    params["other.bias"] = np.ones(3, np.float32)
    ref = j_lora.collapse_lora({k: jnp.asarray(v) for k, v in params.items()},
                               jtree, 0.6)
    got = t_lora.collapse_lora({k: torch.from_numpy(v)
                                for k, v in params.items()}, port, 0.6)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL)
    # a bf16 weight folds in f32 and casts back, as lora_tpu does
    bf = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in params.items()}
    got_bf = t_lora.collapse_lora(bf, port, 0.6)
    ref_bf = j_lora.collapse_lora(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()},
        jtree, 0.6)
    for k in ref_bf:
        assert got_bf[k].dtype == torch.bfloat16
        np.testing.assert_allclose(
            got_bf[k].float().numpy(),
            np.asarray(ref_bf[k], np.float32), rtol=1e-2, atol=1e-2)


def test_collapse_refuses_an_int8_base():
    sites = _sites(TINY_UNET)
    _, port = _factored(sites)
    params = quantize_params_int8({k: torch.from_numpy(v) for k, v in
                                   _base_params(sites).items()})
    key = sites[0].name + ".weight"
    with pytest.raises(ValueError, match=f"{key!r} is an int8-quantized "
                       "weight; collapse the LoRA before quantize_base"):
        t_lora.collapse_lora(params, port)


@pytest.mark.parametrize("cfg", CFGS)
def test_inspect_lora(cfg):
    sites = _sites(CFGS[cfg])
    for jtree, port in (_factored(sites, seed=21), _delta_tree(sites, 22)):
        ref, got = j_lora.inspect_lora(jtree), t_lora.inspect_lora(port)
        assert list(got) == list(ref)
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-5)


@pytest.mark.parametrize("cfg", CFGS)
def test_stack_loras_and_routing(cfg):
    """The stacked tree equals lora_tpu's, and with_lora_idx routes each
    batch element of a linear and a conv bypass through its adapter."""
    sites = _sites(CFGS[cfg])
    j1, t1 = _factored(sites, seed=23, scale=0.7)
    j2, t2 = _factored(sites, seed=24)
    js = j_lora.with_lora_idx(j_lora.stack_loras([j1, j2]), [1, 0, 1])
    ts = t_lora.with_lora_idx(t_lora.stack_loras([t1, t2]), [1, 0, 1])
    assert ts["idx"].dtype == torch.long
    _assert_same(ts, js)
    rng = np.random.default_rng(25)
    lin = sites[0]
    x = rng.standard_normal((3, 5, lin.in_dim)).astype(np.float32)
    ref = j_lora.lora_delta_dense(jnp.asarray(x), js["sites"][lin.name],
                                  js["scale"], idx=js["idx"])
    got = t_lora.lora_delta_dense(torch.from_numpy(x), ts["sites"][lin.name],
                                  ts["scale"], idx=ts["idx"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    conv = next(s for s in sites if s.kind == "conv")
    xc = rng.standard_normal((3, 6, 6, conv.in_dim)).astype(np.float32)
    ref = j_lora.lora_delta_conv(jnp.asarray(xc), js["sites"][conv.name],
                                 js["scale"], conv.stride, conv.padding,
                                 idx=js["idx"])
    got = t_lora.lora_delta_conv(
        torch.from_numpy(xc).permute(0, 3, 1, 2), ts["sites"][conv.name],
        ts["scale"], conv.stride, conv.padding, idx=ts["idx"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)
    # refusals: delta entries, other site sets, other ranks
    jd, td = _delta_tree(sites)
    _same_error(lambda: j_lora.stack_loras([j1, jd]),
                lambda: t_lora.stack_loras([t1, td]), sites)
    jp, tp = _factored(sites[:2], seed=26)
    _same_error(lambda: j_lora.stack_loras([j1, jp]),
                lambda: t_lora.stack_loras([t1, tp]))
    jr, tr = _factored(sites, r=2, seed=27)
    with pytest.raises(ValueError, match="rank mismatch at"):
        j_lora.stack_loras([j1, jr])
    with pytest.raises(ValueError, match="rank mismatch at"):
        t_lora.stack_loras([t1, tr])


def test_lora_to_pairs_refuses_deltas_as_lora_tpu_does():
    sites = _sites(TINY_UNET)
    jd, td = _delta_tree(sites)
    _same_error(lambda: j_lora.lora_to_pairs(jd, sites),
                lambda: t_lora.lora_to_pairs(td, sites))
