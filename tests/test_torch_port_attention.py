"""The port's attention against lora_tpu's: the flash kernels' plain PyTorch
versions against the Pallas forward and backward (interpret mode on the
CPU), the autograd Function's backward against autograd through the plain
attention path, the plain attention path against the XLA path, the routing
rule, and the wrappers' no-fallback rule for CUDA tensors (the CUDA kernels
themselves run only on the card: chip_smoke.py compares them with their
plain versions there)."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.ops import attention as j_att  # noqa: E402
from lora_tpu.ops import flash_attention as j_fa  # noqa: E402
from lora_tpu_torch.ops import attention as t_att  # noqa: E402
from lora_tpu_torch.ops import build as t_build  # noqa: E402
from lora_tpu_torch.ops import flash_attention as t_fa  # noqa: E402


def _qkv(B, H, T, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, T, D), dtype=np.float32),
            rng.standard_normal((B, H, S, D), dtype=np.float32),
            rng.standard_normal((B, H, S, D), dtype=np.float32))


@pytest.mark.parametrize("shape", [(1, 2, 256, 256, 40), (1, 2, 256, 512, 80),
                                   (2, 2, 512, 256, 160)])
def test_reference_matches_pallas_forward(shape):
    B, H, T, S, D = shape
    q, k, v = _qkv(*shape)
    scale = D ** -0.5
    o_j, lse_j = j_fa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale)
    o_t, lse_t = t_fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    # the tolerance of tests/test_flash_attention.py
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j).reshape(B, H, T), atol=1e-4)


@pytest.mark.parametrize("shape,causal", [
    ((2, 3, 7, 7, 16), True),      # CLIP's causal self-attention
    ((2, 3, 5, 9, 16), True),      # Tq < Tk: the mask keeps the diagonal band
    ((2, 3, 64, 77, 16), False),   # UNet cross-attention (S = 77)
    ((1, 2, 256, 256, 40), False),  # a kernel-eligible shape: plain on CPU
])
def test_attention_matches_xla(shape, causal):
    B, H, T, S, D = shape
    q, k, v = _qkv(*shape, seed=1)
    scale = D ** -0.5
    mask = (jnp.tril(jnp.ones((T, S), bool), k=S - T)[None, None]
            if causal else None)
    ref = j_att._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale, mask)
    out = t_att.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("q_shape,k_shape", [
    ((1, 8, 4096, 40), (1, 8, 4096, 40)),
    ((1, 8, 1024, 80), (1, 8, 1024, 80)),
    ((1, 8, 256, 160), (1, 8, 256, 160)),
    ((1, 8, 64, 160), (1, 8, 64, 160)),
    ((1, 8, 256, 160), (1, 8, 77, 160)),
    ((1, 8, 9216, 40), (1, 8, 9216, 40)),
    ((1, 8, 576, 40), (1, 8, 576, 40)),
    ((1, 8, 256, 40), (1, 8, 384, 40)),
])
def test_supported_agrees_with_jax(q_shape, k_shape):
    assert t_fa.supported(q_shape, k_shape) == j_fa.supported(q_shape, k_shape)


@pytest.mark.parametrize("shape", [(1, 2, 256, 512, 40), (1, 2, 256, 256, 32),
                                   (1, 2, 512, 256, 64), (1, 2, 256, 384, 160),
                                   (1, 2, 256, 256, 80)])
def test_backward_reference_matches_pallas(shape):
    """flash_attention_backward_reference against the Pallas _bwd on _fwd's
    residuals: the shapes of tests/test_flash_attention.py (D = 32, 40, 64,
    and 160; T != S), D = 80 so that each SD-1.5 head width (40, 80, 160)
    is held, and its gradient tolerance."""
    B, H, T, S, D = shape
    q, k, v = _qkv(*shape, seed=4)
    do = np.random.default_rng(5).standard_normal((B, H, T, D),
                                                  dtype=np.float32)
    scale = D ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_j, lse_j = j_fa._fwd(jq, jk, jv, scale)
    want = j_fa._bwd(scale, (jq, jk, jv, o_j, lse_j), jnp.asarray(do))
    got = t_fa.flash_attention_backward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(o_j)),
        torch.from_numpy(np.array(lse_j).reshape(B, H, T)),
        torch.from_numpy(do), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2, 256, 256, 40), torch.float32),
    ((2, 2, 300, 77, 64), torch.float32),
    ((1, 2, 256, 128, 80), torch.bfloat16),
])
def test_function_backward_matches_autograd(shape, dtype):
    """The autograd Function's CPU backward (the two plain backward pieces)
    against autograd through the plain attention path. f32: the same
    function, differentiated two ways: 1e-5. bf16: both round P to bf16
    (the Function before P.V and dS, the plain path after its f32 softmax)
    and the gradients to bf16: 2e-2 of the largest gradient."""
    B, H, T, S, D = shape
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(*shape, seed=6))
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, H, T, D), dtype=np.float32)).to(dtype)
    scale = D ** -0.5
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = t_fa.flash_attention(*a, scale)
    assert not lse.requires_grad
    (o.float() * do.float()).sum().backward()
    ref = t_att._plain_attention(*b, scale, None)
    (ref.float() * do.float()).sum().backward()
    for name, x, y in zip(("dq", "dk", "dv"), a, b):
        assert x.grad.dtype == dtype and x.grad.shape == x.shape
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        big = y.grad.float().abs().max().item()
        torch.testing.assert_close(x.grad.float(), y.grad.float(), rtol=tol,
                                   atol=tol * big, msg=name)


def test_cpu_wrapper_runs_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 300, 77, 64, seed=2))
    counters = (t_fa.flash_fwd, t_fa.flash_bwd_dq, t_fa.flash_bwd_dkv)
    before = [f.launches for f in counters]
    q.requires_grad_()
    o, lse = t_fa.flash_attention(q, k, v, 0.125)
    o.sum().backward()
    o_ref, lse_ref = t_fa.flash_attention_reference(q.detach(), k, v, 0.125)
    assert [f.launches for f in counters] == before
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=0)
    assert o.shape == (1, 2, 300, 64) and lse.shape == (1, 2, 300)
    assert lse.dtype == torch.float32


def test_non_cpu_tensors_never_fall_back():
    """Off the CPU each wrapper launches its kernel or raises: a device that
    is not CUDA raises instead of taking the plain version, whether or not
    the tensors require grad, in the forward and in both backward
    wrappers."""
    q = torch.empty((1, 2, 256, 64), device="meta", requires_grad=True)
    k = torch.empty((1, 2, 256, 64), device="meta")
    stats = torch.empty((1, 2, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_fa.flash_attention(q, k, k, 0.125)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_fa.flash_attention(q.detach(), k, k, 0.125)
    for bwd in (t_fa.flash_bwd_dq, t_fa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            bwd(q.detach(), k, k, k, stats, stats, 0.125)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(t_build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_build, "_libs", {})
    monkeypatch.setattr(t_fa, "_fns", {})
    monkeypatch.setattr(t_build, "_find_nvcc", lambda: None)
    for entry in t_fa._ENTRY:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            t_fa._entry(entry)


def _bthd(B, T, H, D, dtype=torch.bfloat16):
    """(B, H, T, D) as the UNet passes it: a transposed view of (B, T, H, D)."""
    return torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)


# (T, D) of SD-1.5's spatial self-attention at 512px, at the serving batch
# (B = 4) and the training batch (B = 1), all 8 heads
SD15_SELF_ATTN = [(B, T, D) for B in (4, 1)
                  for T, D in ((4096, 40), (1024, 80), (256, 160))]


def _route_case(case):
    """(q, k, v) of one routing case and the kernel it must take."""
    if case[0] == "main":
        _, B, T, D = case
        q = _bthd(B, T, 8, D)
        return (q, q, q), "wgmma"
    name = case[0]
    if name == "contiguous":  # (B, H, T, D) itself, D = 64 (SD-2's heads)
        q = torch.zeros((1, 2, 300, 64), dtype=torch.bfloat16)
        k = torch.zeros((1, 2, 77, 64), dtype=torch.bfloat16)
        return (q, k, k), "wgmma"
    if name == "widest":
        q = _bthd(1, 64, 2, 160)
        return (q, q, q), "wgmma"
    if name == "f32":
        q = _bthd(1, 64, 2, 40, torch.float32)
        return (q, q, q), "mma"
    if name == "wide_head":  # D > 160: the mma kernel takes up to 256
        q = _bthd(1, 64, 2, 168)
        return (q, q, q), "mma"
    if name == "broadcast":  # k and v shared over heads: a stride of 0
        q = _bthd(1, 64, 2, 40)
        k = torch.zeros((1, 1, 64, 40), dtype=torch.bfloat16).expand(
            1, 2, 64, 40)
        return (q, k, k), "mma"
    raise ValueError(name)


@pytest.mark.parametrize("case", [("main", *s) for s in SD15_SELF_ATTN] + [
    ("contiguous",), ("widest",), ("f32",), ("wide_head",), ("broadcast",)],
    ids=lambda c: "-".join(map(str, c)))
def test_fwd_route(case):
    """bf16 at every main-path shape (the UNet's transposed views) and
    contiguous tensors take the wgmma kernel; f32, D > 160 and broadcast
    strides the mma kernel. The route reads dtype, D and strides only."""
    (q, k, v), want = _route_case(case)
    assert all(t_fa._layout_ok(t) for t in (q, k, v))
    assert t_fa._fwd_route(q, k, v) == want


def test_fwd_route_leaves_odd_layouts_to_check():
    """A layout _check refuses (strides that are not multiples of 8, here
    a D = 40 slice of 44-wide rows) never reaches the wgmma kernel's tensor
    maps: the route gives mma, and on the card _check raises before any
    launch, as it did before the wgmma kernel."""
    q = torch.zeros((1, 2, 64, 44), dtype=torch.bfloat16)[..., :40]
    assert not t_fa._layout_ok(q)
    assert t_fa._fwd_route(q, q, q) == "mma"


def test_wgmma_max_d_matches_the_kernel_instances():
    """The route's widest wgmma head is the source's MAX_DP, and the
    source instantiates every 16-column width up to it, so each D the route
    sends (8 to WGMMA_MAX_D, D % 8 == 0) has an instance."""
    src = open(os.path.join(os.path.dirname(t_fa.__file__), "csrc",
                            "flash_fwd_wgmma.cu")).read()
    max_dp = int(re.search(r"constexpr int MAX_DP = (\d+);", src).group(1))
    cases = [int(x) for x in re.findall(r"^\s*FLASH_WGMMA_CASE\((\d+)\)\s*$",
                                        src, re.M)]
    assert max_dp == t_fa.WGMMA_MAX_D
    assert cases == list(range(16, max_dp + 1, 16))


@pytest.mark.parametrize("B,T,D", SD15_SELF_ATTN)
@pytest.mark.parametrize("sms", [132, 114])
def test_fwd_bm_fills_the_card(B, T, D, sms):
    """128 q rows per CTA where that still gives a CTA per SM, else 64:
    the grid is at least the SM count whenever 64-row tiles can reach it,
    and never larger than it needs to be."""
    bh = B * 8
    bm = t_fa._fwd_bm(T, bh, sms)
    assert bm in (64, 128)
    ctas = -(-T // bm) * bh
    if bm == 64:
        assert -(-T // 128) * bh < sms
    else:
        assert ctas >= sms
    assert {(4, 4096): 128, (4, 1024): 128, (4, 256): 64, (1, 4096): 128,
            (1, 256): 64}.get((B, T), bm) == bm


def test_cpu_bf16_call_launches_nothing():
    """A bf16 call at a wgmma shape on CPU tensors takes the plain version
    and moves neither count."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 256, 2, 40), np.float32)).to(
        torch.bfloat16).transpose(1, 2)
    before = (dict(t_fa.flash_fwd.launches_by_kernel), t_fa.flash_fwd.launches)
    assert t_fa._fwd_route(q, q, q) == "wgmma"
    o, lse = t_fa.flash_fwd(q, q, q, 40 ** -0.5)
    o_ref, lse_ref = t_fa.flash_attention_reference(q, q, q, 40 ** -0.5)
    assert (dict(t_fa.flash_fwd.launches_by_kernel),
            t_fa.flash_fwd.launches) == before
    assert sum(before[0].values()) == before[1]
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=0)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(t_build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_build, "_find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        t_build.build()
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())


def _two_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh"):
        (src / name).write_text(f"// {name}\n")
    monkeypatch.setattr(t_build, "_CSRC_DIR", str(src))
    sources = t_build._sources()
    assert {k: os.path.basename(v) for k, v in sources.items()} == {
        "a": "a.cu", "b": "b.cu"}
    return src, {stem: t_build._key(path) for stem, path in sources.items()}


def test_build_key_covers_every_source(tmp_path, monkeypatch):
    """One library per csrc/*.cu, each keyed by its own source, every
    header and the flags: editing the shared header rebuilds all."""
    src, keys = _two_sources(tmp_path, monkeypatch)
    assert keys["a"] != keys["b"]
    (src / "common.cuh").write_text("// changed\n")
    new = {stem: t_build._key(p) for stem, p in t_build._sources().items()}
    assert all(new[s] != keys[s] for s in keys)


def test_build_key_source_edit_rebuilds_only_its_library(tmp_path,
                                                         monkeypatch):
    src, keys = _two_sources(tmp_path, monkeypatch)
    (src / "a.cu").write_text("// changed\n")
    new = {stem: t_build._key(p) for stem, p in t_build._sources().items()}
    assert new["a"] != keys["a"] and new["b"] == keys["b"]


def test_load_library_builds_only_its_source(tmp_path, monkeypatch):
    """The first use of one kernel compiles its own source and no other."""
    _two_sources(tmp_path, monkeypatch)
    monkeypatch.setattr(t_build, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(t_build, "_libs", {})
    monkeypatch.setattr(t_build, "_find_nvcc", lambda: "nvcc")
    compiled = []

    class Proc:  # nvcc that "builds" by writing its output file
        returncode = 0

        def __init__(self, cmd, **kw):
            compiled.append(os.path.basename(cmd[-1]))
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return "", ""

        def poll(self):
            return 0

    monkeypatch.setattr(t_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(t_build.ctypes, "CDLL", lambda path: path)
    path = t_build.load_library("b")
    assert compiled == ["b.cu"]
    assert os.path.basename(path).startswith("b_") and path.endswith(".so")
    assert os.path.exists(path[:-3] + ".log")
    assert t_build.load_library("b") == path and compiled == ["b.cu"]
    assert sorted(t_build.build()) == ["a", "b"] and compiled == ["b.cu",
                                                                 "a.cu"]
    with pytest.raises(RuntimeError, match="no csrc"):
        t_build.build(["c"])



@pytest.mark.parametrize("case", [("main", *s) for s in SD15_SELF_ATTN] + [
    ("contiguous",), ("widest",), ("f32",), ("wide_head",), ("broadcast",)],
    ids=lambda c: "-".join(map(str, c)))
def test_bwd_route(case):
    """The dK/dV kernel of a call: bf16 at every training-path shape (the
    UNet's transposed views, dO alike) and contiguous tensors take the
    wgmma kernel; f32, D above WGMMA_DKV_MAX_D and broadcast strides the
    mma kernel. The route reads dtype, D and strides only."""
    (q, k, v), want = _route_case(case)
    if case[0] == "wide_head":
        q = _bthd(1, 64, 2, t_fa.WGMMA_DKV_MAX_D + 8)
        q, k, v = q, q, q
    do = torch.zeros_like(q)
    assert all(t_fa._layout_ok(t) for t in (q, k, v, do))
    assert t_fa._bwd_route(q, k, v, do) == want


def test_bwd_route_leaves_odd_layouts_to_check():
    """A layout _check refuses (strides that are not multiples of 8) never
    reaches the wgmma dK/dV kernel's tensor maps, in q, k, v or dO: the
    route gives mma, and on the card _check raises before any launch."""
    good = _bthd(1, 64, 2, 40)
    odd = torch.zeros((1, 2, 64, 44), dtype=torch.bfloat16)[..., :40]
    assert not t_fa._layout_ok(odd)
    assert t_fa._bwd_route(good, good, good, good) == "wgmma"
    for i in range(4):
        args = [good] * 4
        args[i] = odd
        assert t_fa._bwd_route(*args) == "mma"


def test_wgmma_dkv_max_d_matches_the_kernel_instances():
    """The route's widest wgmma dK/dV head is the source's MAX_DP, and the
    source instantiates every 16-column width up to it, so each D the route
    sends (8 to WGMMA_DKV_MAX_D, D % 8 == 0) has an instance."""
    src = open(os.path.join(os.path.dirname(t_fa.__file__), "csrc",
                            "flash_bwd_dkv_wgmma.cu")).read()
    max_dp = int(re.search(r"constexpr int MAX_DP = (\d+);", src).group(1))
    cases = [int(x) for x in re.findall(r"^\s*DKV_WGMMA_CASE\((\d+)\)\s*$",
                                        src, re.M)]
    assert max_dp == t_fa.WGMMA_DKV_MAX_D
    assert cases == list(range(16, max_dp + 1, 16))


@pytest.mark.parametrize("B,T,D", SD15_SELF_ATTN)
@pytest.mark.parametrize("sms", [132, 114])
def test_dkv_bn_fills_the_card(B, T, D, sms):
    """128 kv rows per CTA where that still gives a CTA per SM, else 64:
    the grid is at least the SM count whenever 64-row tiles can reach it,
    and never larger than it needs to be. At the training shapes (B = 1)
    that is 256 CTAs at S = 4096 and 128 (not 64) at S = 1024."""
    bh = B * 8
    bn = t_fa._dkv_bn(T, bh, sms)
    assert bn in (64, 128)
    ctas = -(-T // bn) * bh
    if bn == 64:
        assert -(-T // 128) * bh < sms
    else:
        assert ctas >= sms
    assert {(1, 4096): (128, 256), (1, 1024): (64, 128),
            (1, 256): (64, 32)}.get((B, T), (bn, ctas)) == (bn, ctas)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q_tilde_matches_jax_scale_q(dtype):
    """The wgmma dK/dV kernel's Q~, formed by the wrapper before the
    launch, is bit for bit the JAX _scale_q that _bwd hands its kernels:
    f32(q) * scale rounded once to q's dtype."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 3, 37, 40), dtype=np.float32) * 4)
    scale = 40 ** -0.5
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(j_fa._scale_q(jnp.asarray(x).astype(jdt), scale)
                      ).astype(np.float32)
    q = torch.from_numpy(x).to(dtype)
    got = t_fa._q_tilde(q, scale)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        # the inputs themselves agree bit for bit first
        assert np.array_equal(
            np.asarray(jnp.asarray(x).astype(jdt)).astype(np.float32),
            q.float().numpy())
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_q_tilde_keeps_the_transposed_layout():
    """Q~ of the UNet's transposed view keeps its strides, which the wgmma
    kernel's tensor maps take as they are."""
    q = torch.randn((1, 64, 2, 40)).to(torch.bfloat16).transpose(1, 2)
    qt = t_fa._q_tilde(q, 0.125)
    assert qt.stride() == q.stride() and t_fa._layout_ok(qt)


def test_cpu_bwd_dkv_call_launches_nothing():
    """A bf16 flash_bwd_dkv call at a wgmma shape on CPU tensors takes the
    plain version and moves neither count."""
    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v, do = t(1, 256, 2, 40), t(1, 128, 2, 40), t(1, 128, 2, 40), \
        t(1, 256, 2, 40)
    _, lse = t_fa.flash_attention_reference(q, k, v, 40 ** -0.5)
    delta = torch.from_numpy(rng.standard_normal((1, 2, 256), np.float32))
    args = (q, k, v, do, lse, delta, 40 ** -0.5)
    before = (dict(t_fa.flash_bwd_dkv.launches_by_kernel),
              t_fa.flash_bwd_dkv.launches)
    assert t_fa._bwd_route(q, k, v, do) == "wgmma"
    dk, dv = t_fa.flash_bwd_dkv(*args)
    dk_ref, dv_ref = t_fa.flash_bwd_dkv_reference(*args)
    assert (dict(t_fa.flash_bwd_dkv.launches_by_kernel),
            t_fa.flash_bwd_dkv.launches) == before
    assert sum(before[0].values()) == before[1]
    torch.testing.assert_close(dk, dk_ref, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv_ref, rtol=0, atol=0)
    assert dk.dtype == dv.dtype == torch.bfloat16 and dk.shape == k.shape


@pytest.mark.parametrize("case", [("main", *s) for s in SD15_SELF_ATTN] + [
    ("contiguous",), ("widest",), ("f32",), ("wide_head",), ("broadcast",)],
    ids=lambda c: "-".join(map(str, c)))
def test_dq_route(case):
    """The dQ kernel of a call: bf16 at every training-path shape (the
    UNet's transposed views, dO alike) and contiguous tensors take the
    wgmma kernel; f32, D above WGMMA_DQ_MAX_D and broadcast strides the
    mma kernel. The route reads dtype, D and strides only."""
    (q, k, v), want = _route_case(case)
    if case[0] == "wide_head":
        q = _bthd(1, 64, 2, t_fa.WGMMA_DQ_MAX_D + 8)
        q, k, v = q, q, q
    do = torch.zeros_like(q)
    assert all(t_fa._layout_ok(t) for t in (q, k, v, do))
    assert t_fa._dq_route(q, k, v, do) == want


def test_dq_route_leaves_odd_layouts_to_check():
    """A layout _check refuses (strides that are not multiples of 8) never
    reaches the wgmma dQ kernel's tensor maps, in q, k, v or dO: the route
    gives mma, and on the card _check raises before any launch."""
    good = _bthd(1, 64, 2, 40)
    odd = torch.zeros((1, 2, 64, 44), dtype=torch.bfloat16)[..., :40]
    assert not t_fa._layout_ok(odd)
    assert t_fa._dq_route(good, good, good, good) == "wgmma"
    for i in range(4):
        args = [good] * 4
        args[i] = odd
        assert t_fa._dq_route(*args) == "mma"


def test_wgmma_dq_max_d_matches_the_kernel_instances():
    """The route's widest wgmma dQ head is the source's MAX_DP, and the
    source instantiates every 16-column width up to it, so each D the route
    sends (8 to WGMMA_DQ_MAX_D, D % 8 == 0) has an instance."""
    src = open(os.path.join(os.path.dirname(t_fa.__file__), "csrc",
                            "flash_bwd_dq_wgmma.cu")).read()
    max_dp = int(re.search(r"constexpr int MAX_DP = (\d+);", src).group(1))
    cases = [int(x) for x in re.findall(r"^\s*DQ_WGMMA_CASE\((\d+)\)\s*$",
                                        src, re.M)]
    configs = [int(x) for x in re.findall(
        r"^\s*DQ_WGMMA_CONFIG\((\d+)\)\s*$", src, re.M)]
    assert max_dp == t_fa.WGMMA_DQ_MAX_D
    assert cases == configs == list(range(16, max_dp + 1, 16))


@pytest.mark.parametrize("B,T,D", SD15_SELF_ATTN)
@pytest.mark.parametrize("sms", [132, 114])
def test_dq_bm_fills_the_card(B, T, D, sms):
    """128 q rows per CTA where that still gives a CTA per SM, else 64.
    At the training shapes (B = 1) that is 256 CTAs at T = 4096, 128 (of
    64 rows) at T = 1024 and 32 at T = 256."""
    bh = B * 8
    bm = t_fa._dq_bm(T, bh, sms)
    assert bm in (64, 128)
    ctas = -(-T // bm) * bh
    if bm == 64:
        assert -(-T // 128) * bh < sms
    else:
        assert ctas >= sms
    assert {(1, 4096): (128, 256), (1, 1024): (64, 128),
            (1, 256): (64, 32)}.get((B, T), (bm, ctas)) == (bm, ctas)


def test_cpu_bwd_dq_call_launches_nothing():
    """bf16 flash_bwd_dq and flash_attention_backward calls at a wgmma
    shape on CPU tensors take the plain versions and move no count of
    either backward wrapper."""
    rng = np.random.default_rng(13)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v, do = t(1, 256, 2, 40), t(1, 128, 2, 40), t(1, 128, 2, 40), \
        t(1, 256, 2, 40)
    scale = 40 ** -0.5
    o, lse = t_fa.flash_attention_reference(q, k, v, scale)
    delta = t_fa._delta(o, do)
    args = (q, k, v, do, lse, delta, scale)
    wrappers = (t_fa.flash_bwd_dq, t_fa.flash_bwd_dkv)
    before = [(dict(f.launches_by_kernel), f.launches) for f in wrappers]
    assert t_fa._dq_route(q, k, v, do) == "wgmma"
    dq = t_fa.flash_bwd_dq(*args)
    dq_b, dk_b, dv_b = t_fa.flash_attention_backward(q, k, v, o, lse, do,
                                                     scale)
    assert [(dict(f.launches_by_kernel), f.launches)
            for f in wrappers] == before
    assert all(sum(by.values()) == n for by, n in before)
    dq_ref = t_fa.flash_bwd_dq_reference(*args)
    dk_ref, dv_ref = t_fa.flash_bwd_dkv_reference(*args)
    for got, want in ((dq, dq_ref), (dq_b, dq_ref), (dk_b, dk_ref),
                      (dv_b, dv_ref)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape


def test_dq_ragged_tails_add_nothing():
    """The wgmma dQ kernel's ragged tails, on the plain version: TMA
    zero-fills q~ and dO rows past T (L and delta are 0 there) and K and V
    rows past S. Rows past T then get dS = 0 (S = 0, P = 1, dP = 0), and
    kv rows past S multiply a zero K row, so the padded call, sliced to
    T, is the unpadded one (f32; the sums run over extra exact zeros in
    another blocking: 1e-6 of the largest value), and its padded rows are
    0. The unpadded one matches the Pallas _bwd (interpret mode) at the
    tolerance of test_backward_reference_matches_pallas."""
    B, H, T, S, D = 1, 2, 256, 384, 40
    q, k, v = _qkv(B, H, T, S, D, seed=14)
    do = np.random.default_rng(15).standard_normal((B, H, T, D),
                                                   dtype=np.float32)
    scale = D ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_j, lse_j = j_fa._fwd(jq, jk, jv, scale)
    want = j_fa._bwd(scale, (jq, jk, jv, o_j, lse_j), jnp.asarray(do))[0]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = torch.from_numpy(np.array(lse_j).reshape(B, H, T))
    delta = t_fa._delta(torch.from_numpy(np.array(o_j)), tdo)
    got = t_fa.flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=5e-4)

    def pad(x, rows):  # zero rows past the tensor's own, along dim 2
        shape = list(x.shape)
        shape[2] = rows - shape[2]
        return torch.cat([x, x.new_zeros(shape)], dim=2)

    Tp, Sp = T + 64, S + 128  # a q tile and a kv tile past the edges
    padded = t_fa.flash_bwd_dq_reference(
        pad(tq, Tp), pad(tk, Sp), pad(tv, Sp), pad(tdo, Tp),
        pad(lse[..., None], Tp)[..., 0], pad(delta[..., None], Tp)[..., 0],
        scale)
    big = got.abs().max().item()
    torch.testing.assert_close(padded[:, :, :T], got, rtol=0,
                               atol=1e-6 * big)
    assert torch.equal(padded[:, :, T:], torch.zeros_like(padded[:, :, T:]))
