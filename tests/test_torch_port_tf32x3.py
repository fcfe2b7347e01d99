"""The f32 dK/dV kernel on 3xTF32 (csrc/flash_bwd_dkv_tf32x3.cu) on the CPU:
the wrapper's hi/lo split, a model of the kernel's arithmetic built from the
wrapper's own operand tensors (the split of every f32 operand, the
pi-permuted transposed copies of Q~ and dO) against the plain version and
the Pallas _bwd (interpret mode), a model of the register fragments that
shows why pi lets the score accumulators feed the dV and dK products as
they are, the route, the tile rule, and the counts. The kernel itself runs
only on the card: chip_smoke.py compares it with its plain version there."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.ops import flash_attention as j_fa  # noqa: E402
from lora_tpu_torch.ops import flash_attention as t_fa  # noqa: E402

PI = [0, 2, 4, 6, 1, 3, 5, 7]
# The kernel's dK and dV against the plain version, as a share of the
# largest value: 3xTF32 errs by about 2^-21 of each product's terms, and the
# exponentials and sums run in another order
REL_TOL = 1e-5
SRC = os.path.join(os.path.dirname(t_fa.__file__), "csrc",
                   "flash_bwd_dkv_tf32x3.cu")


def _bits(x):
    return x.view(torch.int32)


# --- the split -------------------------------------------------------------

def _extreme():
    tiny = np.float32(2.0 ** -100)
    vals = [0.0, -0.0, 1.0, -1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
            1 - 2 ** -24, 3.0e38, -3.0e38, 1e30, -1e-30, float(tiny),
            65504.0, 1 / 3, -np.pi, 2 ** -60 * 1.2345678]
    return torch.tensor(vals, dtype=torch.float32)


@pytest.mark.parametrize("case", ["normal", "wide", "uniform", "extreme"])
def test_split_tf32_zeroes_low_bits_and_keeps_f32(case):
    """hi and lo have their low 13 mantissa bits zero (tf32), and
    |x - hi - lo| <= 2^-21 |x| (the bound is 2^-22 while the remainder is a
    normal number, which holds for |x| >= 2^-100)."""
    rng = np.random.default_rng(21)
    x = {"normal": lambda: rng.standard_normal(4096),
         "wide": lambda: rng.standard_normal(4096) * 10.0 ** rng.integers(
             -25, 25, 4096),
         "uniform": lambda: rng.uniform(-1, 1, 4096),
         "extreme": lambda: _extreme().numpy()}[case]()
    x = torch.as_tensor(np.asarray(x, np.float32))
    hi, lo = t_fa._split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):
        assert int((_bits(part) & 0x1FFF).abs().max()) == 0
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())


def test_split_tf32_rounds_to_nearest_ties_away():
    """hi is cvt.rna.tf32.f32: to nearest, ties away from zero, on the
    magnitude for either sign."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp, -(one + 1.5 * ulp)], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         -(one + 2 * ulp)], dtype=torch.float32)
    assert torch.equal(t_fa._rna_tf32(x), want)


def test_split_tf32_keeps_the_layout():
    """The split of the UNet's transposed views keeps their strides, which
    the kernel's tensor maps take as they are."""
    x = torch.randn((1, 64, 2, 40)).transpose(1, 2)
    hi, lo = t_fa._split_tf32(x)
    assert hi.stride() == lo.stride() == x.stride()
    assert t_fa._tma_ok(hi, lo)


# --- the transposed copies ---------------------------------------------------

@pytest.mark.parametrize("T", [8, 37, 64, 300])
def test_transposed_copy_is_pi_permuted_and_zero_padded(T):
    B, H, D = 1, 2, 24
    x = torch.randn((B, H, T, D))
    y = t_fa._tf32x3_transposed(x)
    tp = -(-T // t_fa.TF32X3_T_ALIGN) * t_fa.TF32X3_T_ALIGN
    assert y.shape == (B, H, D, tp) and y.is_contiguous()
    for col in range(tp):
        row = 8 * (col // 8) + PI[col % 8]
        want = x[:, :, row] if row < T else torch.zeros((B, H, D))
        assert torch.equal(y[:, :, :, col], want)


# --- a model of the kernel's arithmetic ------------------------------------

def _mm3(a, b, terms=3):
    """A B from split operands a = (hi, lo), b = (hi, lo): hi.hi + hi.lo +
    lo.hi as three f32 products of tf32 values (each exact in f32) summed
    in f32, as the three wgmmas into one accumulator; terms=1 is hi.hi
    alone (plain TF32)."""
    out = a[0] @ b[0]
    if terms == 3:
        out = out + a[0] @ b[1] + a[1] @ b[0]
    return out


def _emulate(q, k, v, do, lse, delta, scale, terms=3):
    """dK, dV as the kernel computes them, from the wrapper's own operands
    (t_fa._tf32x3_operands): S^T and dP^T from the split Q~, dO, K, V;
    P^T and dS^T split; dV and dK against the pi-permuted transposed
    copies, with P^T and dS^T read in the order the register fragments
    give them (k position p of a group of 8 is q column pi(p))."""
    qt = t_fa._q_tilde(q, scale)
    ops = t_fa._tf32x3_operands(qt, do, k, v, ("dkv",))["dkv"]
    (qh, ql, oh, ol, kh, kl, vh, vl, qth, qtl, oth, otl) = ops
    T = q.shape[2]
    tp = qth.shape[-1]
    if terms == 1:  # plain TF32: the lo parts are not read
        ql, ol, kl, vl, qtl, otl = (torch.zeros_like(t) for t in
                                    (ql, ol, kl, vl, qtl, otl))
    st = _mm3((kh, kl), (qh.transpose(-1, -2), ql.transpose(-1, -2)), terms)
    dpt = _mm3((vh, vl), (oh.transpose(-1, -2), ol.transpose(-1, -2)), terms)
    pt = torch.exp(st - lse[:, :, None, :])
    dst = pt * (dpt - delta[:, :, None, :])
    # q columns past T: L = delta = 0 and zero rows give P = 1, dS = 0
    pad = (0, tp - T)
    pt = torch.nn.functional.pad(pt, pad, value=1.0)
    dst = torch.nn.functional.pad(dst, pad)
    perm = torch.tensor([8 * (c // 8) + PI[c % 8] for c in range(tp)])
    ph, pl = t_fa._split_tf32(pt[..., perm].contiguous())
    dh, dl = t_fa._split_tf32(dst[..., perm].contiguous())
    if terms == 1:
        pl, dl = torch.zeros_like(pl), torch.zeros_like(dl)
    dv = _mm3((ph, pl), (oth.transpose(-1, -2), otl.transpose(-1, -2)), terms)
    dk = _mm3((dh, dl), (qth.transpose(-1, -2), qtl.transpose(-1, -2)), terms)
    return dk, dv


def _inputs(B, H, T, S, D, seed, heads_inner=False):
    rng = np.random.default_rng(seed)

    def make(L):
        if heads_inner:
            return torch.from_numpy(rng.standard_normal(
                (B, L, H, D), np.float32)).transpose(1, 2)
        return torch.from_numpy(rng.standard_normal((B, H, L, D), np.float32))

    q, k, v, do = make(T), make(S), make(S), make(T)
    scale = D ** -0.5
    o, lse = t_fa.flash_attention_reference(q, k, v, scale)
    return q, k, v, do, lse, t_fa._delta(o, do), scale


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("shape", [
    (1, 2, 256, 256, 40), (1, 2, 300, 77, 40), (2, 1, 37, 129, 8),
    (1, 2, 200, 130, 64), (1, 1, 70, 50, 80), (1, 1, 33, 65, 96)])
def test_emulated_kernel_matches_the_plain_version(shape):
    """3xTF32 as the kernel runs it, including ragged T and S and the
    UNet's transposed views, within REL_TOL of flash_bwd_dkv_reference's
    largest value."""
    B, H, T, S, D = shape
    args = _inputs(B, H, T, S, D, seed=sum(shape),
                   heads_inner=shape[0] == 1)
    want = t_fa.flash_bwd_dkv_reference(*args)
    got = _emulate(*args)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert _rel(g, w) <= REL_TOL, name


def test_plain_tf32_misses_the_limit():
    """Why the port uses 3xTF32: hi.hi alone (1xTF32, 10 mantissa bits)
    is more than REL_TOL from the f32 result."""
    args = _inputs(1, 2, 256, 256, 40, seed=31)
    want = t_fa.flash_bwd_dkv_reference(*args)
    one = _emulate(*args, terms=1)
    three = _emulate(*args)
    for g1, g3, w in zip(one, three, want):
        assert _rel(g1, w) > 10 * REL_TOL
        assert _rel(g3, w) <= REL_TOL


def test_emulated_kernel_matches_pallas_bwd():
    """The model against the Pallas _bwd (interpret mode, f32 dots at
    HIGHEST) on _fwd's residuals: dK and dV within REL_TOL of the largest
    value."""
    B, H, T, S, D = 1, 2, 256, 128, 40
    rng = np.random.default_rng(41)
    q, k, v, do = (rng.standard_normal((B, H, n, D), dtype=np.float32)
                   for n in (T, S, S, T))
    scale = D ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_j, lse_j = j_fa._fwd(jq, jk, jv, scale)
    _, dk_j, dv_j = j_fa._bwd(scale, (jq, jk, jv, o_j, lse_j), jnp.asarray(do))
    tdo = torch.from_numpy(do)
    lse = torch.from_numpy(np.array(lse_j).reshape(B, H, T))
    delta = t_fa._delta(torch.from_numpy(np.array(o_j)), tdo)
    dk, dv = _emulate(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), tdo, lse, delta, scale)
    for name, g, w in (("dk", dk, dk_j), ("dv", dv, dv_j)):
        assert _rel(g, torch.from_numpy(np.array(w))) <= REL_TOL, name


def test_ragged_tails_add_nothing():
    """q rows past T (zero Q~ and dO rows, L = delta = 0: P = 1, dS = 0)
    add nothing, and kv rows past S only fill their own rows: the model on
    inputs padded past T and S, sliced, is the model on the unpadded ones."""
    B, H, T, S, D = 1, 2, 100, 70, 40
    q, k, v, do, lse, delta, scale = _inputs(B, H, T, S, D, seed=51)
    dk, dv = _emulate(q, k, v, do, lse, delta, scale)

    def pad(x, rows):
        return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[2]))

    Tp, Sp = T + 28, S + 58
    dkp, dvp = _emulate(pad(q, Tp), pad(k, Sp), pad(v, Sp), pad(do, Tp),
                        pad(lse[..., None], Tp)[..., 0],
                        pad(delta[..., None], Tp)[..., 0], scale)
    torch.testing.assert_close(dkp[:, :, :S], dk, rtol=0, atol=0)
    torch.testing.assert_close(dvp[:, :, :S], dv, rtol=0, atol=0)


# --- the register fragments ------------------------------------------------

def _acc_map(g, t, i):
    """(row, column) of accumulator registers d0..d3 of n8 block i in lane
    (g, t) of a warp's 16 rows (the wgmma f32 accumulator layout)."""
    c = 8 * i + 2 * t
    return [(g, c), (g, c + 1), (g + 8, c), (g + 8, c + 1)]


def _a_map(g, t):
    """(row, k) of the .tf32 register-A fragment a0..a3 of an m64nNk8
    wgmma in lane (g, t) of a warp's 16 rows."""
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


@pytest.mark.parametrize("copy", ["dkv_dO", "dq_K"])
@pytest.mark.parametrize("order,permuted,exact", [
    ((0, 2, 1, 3), True, True),     # the kernel's choice
    ((0, 1, 2, 3), True, False),    # the registers as they come: wrong
    ((0, 2, 1, 3), False, False),   # without pi in the transposed copies
])
def test_accumulator_feeds_register_a_through_pi(order, permuted, exact,
                                                 copy):
    """A warp's 16 rows of a score accumulator (32 columns: P^T over q in
    the dK/dV kernel, dS over kv in the dQ kernel) read back as register-A
    fragments (a_r = d_order[r] of n8 block i for k8 step i) and multiplied
    with the transposed copy the kernel reads (dO^T, padded to
    TF32X3_T_ALIGN, or K^T, padded to TF32X3_S_ALIGN) give the product
    exactly when the registers go (d0, d2, d1, d3) and the copy is
    pi-permuted; any other choice gives another product."""
    rng = np.random.default_rng(61)
    BQ, D = 32, 24
    pt = rng.standard_normal((16, BQ))
    do = rng.standard_normal((BQ, D))
    align = {"dkv_dO": t_fa.TF32X3_T_ALIGN,
             "dq_K": t_fa.TF32X3_S_ALIGN}[copy]
    dot = t_fa._tf32x3_transposed(torch.from_numpy(do)[None, None],
                                  align)[0, 0]
    assert dot.shape == (D, -(-BQ // align) * align)
    if not permuted:
        dot = torch.from_numpy(np.ascontiguousarray(do.T))
    dot = dot.numpy()[:, :BQ]
    got = np.zeros((16, D))
    for i in range(BQ // 8):
        a = np.zeros((16, 8))  # the k8 step's A as the hardware reads it
        for g in range(8):
            for t in range(4):
                regs = [pt[r, c] for r, c in _acc_map(g, t, i)]
                for r, (row, kk) in enumerate(_a_map(g, t)):
                    a[row, kk] = regs[order[r]]
        got += a @ dot[:, 8 * i:8 * i + 8].T
    assert np.allclose(got, pt @ do, rtol=1e-12, atol=1e-12) == exact


# --- the route, the tiles, the counts --------------------------------------

def _bthd(B, T, H, D, dtype=torch.float32):
    return torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("D", [8, 40, 64, 72, 80, 96])
def test_f32_routes_to_tf32x3_up_to_its_widest_head(D):
    q = _bthd(1, 64, 2, D)
    assert t_fa._bwd_route(q, q, q, q) == "tf32x3"
    c = torch.zeros((1, 2, 77, D))
    assert t_fa._bwd_route(c, c, c, c) == "tf32x3"


@pytest.mark.parametrize("D", [168, 256])
def test_wider_f32_heads_stay_on_mma(D):
    q = _bthd(1, 64, 2, D)
    assert t_fa._bwd_route(q, q, q, q) == "mma"


def test_f32_odd_layouts_and_broadcasts_stay_on_mma():
    """A layout _check refuses, in any of q, k, v, dO, and a stride of 0
    (k and v shared over heads) take the mma kernel."""
    good = _bthd(1, 64, 2, 40)
    odd = torch.zeros((1, 2, 64, 44))[..., :40]
    assert not t_fa._layout_ok(odd)
    for i in range(4):
        args = [good] * 4
        args[i] = odd
        assert t_fa._bwd_route(*args) == "mma"
    shared = torch.zeros((1, 1, 64, 40)).expand(1, 2, 64, 40)
    assert t_fa._bwd_route(good, shared, shared, good) == "mma"


def test_constants_match_the_kernel_source():
    """WGMMA_F32_DKV_MAX_D is the source's MAX_DP and its instance switch,
    which covers every multiple of 8 up to it (the entry point and the
    config entry alike); TF32X3_BN128_MAX_D is where BN_MAX drops to 64;
    TF32X3_T_ALIGN is T_ALIGN."""
    src = open(SRC).read()
    max_dp = int(re.search(r"constexpr int MAX_DP = (\d+);", src).group(1))
    cases = [int(x) for x in re.findall(
        r"^\s*DKV_TF32X3_CASE\((\d+)\)\s*$", src, re.M)]
    configs = [int(x) for x in re.findall(
        r"^\s*DKV_TF32X3_CONFIG\((\d+)\)\s*$", src, re.M)]
    assert max_dp == t_fa.WGMMA_F32_DKV_MAX_D
    assert cases == configs == list(range(8, max_dp + 1, 8))
    bn = re.search(r"BN_MAX = DP <= (\d+) \? 128 : 64;", src)
    assert int(bn.group(1)) == t_fa.TF32X3_BN128_MAX_D
    align = re.search(r"constexpr int T_ALIGN = (\d+);", src)
    assert int(align.group(1)) == t_fa.TF32X3_T_ALIGN
    assert t_fa._ENTRY["dkv_tf32x3"] == ("flash_bwd_dkv_tf32x3",
                                         "flash_bwd_dkv_tf32x3", 16)


@pytest.mark.parametrize("S,D,want", [
    (4096, 40, 128), (1024, 40, 64), (4096, 64, 128), (4096, 72, 64),
    (1024, 80, 64), (256, 96, 64)])
def test_dkv_tf32x3_bn(S, D, want):
    """_dkv_bn's rule (B = 1, H = 8, 132 SMs) where the instance holds 128
    kv rows, else 64."""
    assert t_fa._dkv_tf32x3_bn(S, 8, D, 132) == want


def test_cpu_f32_call_launches_nothing():
    """An f32 flash_bwd_dkv call at a tf32x3 shape on CPU tensors takes the
    plain version and moves no count, the tf32x3 one included."""
    q, k, v, do, lse, delta, scale = _inputs(1, 2, 256, 128, 40, seed=71,
                                             heads_inner=True)
    args = (q, k, v, do, lse, delta, scale)
    assert t_fa._bwd_route(q, k, v, do) == "tf32x3"
    fn = t_fa.flash_bwd_dkv
    before = (dict(fn.launches_by_kernel), fn.launches)
    assert set(before[0]) == {"wgmma", "tf32x3", "tf32x3_wide", "mma"}
    dk, dv = fn(*args)
    o, _ = t_fa.flash_attention_reference(q, k, v, scale)
    t_fa.flash_attention_backward(q, k, v, o, lse, do, scale)
    assert (dict(fn.launches_by_kernel), fn.launches) == before
    dk_ref, dv_ref = t_fa.flash_bwd_dkv_reference(*args)
    torch.testing.assert_close(dk, dk_ref, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv_ref, rtol=0, atol=0)
