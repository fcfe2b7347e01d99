"""The f32 dQ kernel for wide heads (96 < D <= 160) on a cluster of two CTAs
(csrc/flash_bwd_dq_tf32x3_wide.cu) on the CPU: a model of the pair's
arithmetic built from the wrapper's own operand tensors (the Q side: S and
P; the dO side: dP; both: dS from what they hand each other, and each its
own column boxes of dQ, one fresh accumulator per kv tile added in f32)
against the plain version and the Pallas _bwd (interpret mode), the masked
kv columns and the q rows past T, the column boxes of the two ranks, the
route, the constants and shared memory of each instance read back from the
source, and the counts. The kernel itself runs only on the card:
chip_smoke.py compares it with its plain version there."""

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
# The kernel's dQ against the plain version, as a share of the largest
# value: the limit chip_smoke.py holds the kernel to on the card. 3xTF32
# errs by about 2^-21 of each product's terms, and the exponentials and
# sums run in another order
REL_TOL = 1e-4
CSRC = os.path.join(os.path.dirname(t_fa.__file__), "csrc")
WIDE = list(range(t_fa.WGMMA_F32_DQ_MAX_D + 8,
                  t_fa.WGMMA_F32_DQ_WIDE_MAX_D + 1, 8))


def _src(name="flash_bwd_dq_tf32x3_wide.cu"):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _const(name, src=None):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         src or _src()).group(1))


# an H100's dynamic shared memory per block, as the kernels' header has it
SMEM_MAX = _const("SMEM_MAX", _src("sm90.cuh"))
BN = _const("BN")
BM = _const("BM")


def _boxes(dp):
    """The dQ column boxes (8 columns each) of rank 0 and rank 1: the first
    ceil(DP / 16) and the rest, as the source's Cfg splits them."""
    kb = dp // 8
    nb0 = (kb + 1) // 2
    return list(range(nb0)), list(range(nb0, kb))


# --- a model of the pair's arithmetic --------------------------------------

def _mm3(a, b, terms=3):
    """A B from split operands a = (hi, lo), b = (hi, lo): hi.hi + hi.lo +
    lo.hi as three f32 products of tf32 values summed in f32, as the three
    wgmmas into one accumulator; terms=1 is hi.hi alone (plain TF32)."""
    out = a[0] @ b[0]
    if terms == 3:
        out = out + a[0] @ b[1] + a[1] @ b[0]
    return out


def _t(x):
    return x.transpose(-1, -2)


def _tiles(x, s_pad):
    """(..., T, S) score columns padded with zeros to the transposed copy's
    S' columns, pi-permuted within each group of 8 (k position p of a group
    is kv column pi(p): the register-A order of the accumulator
    fragments)."""
    x = torch.nn.functional.pad(x, (0, s_pad - x.shape[-1]))
    perm = torch.tensor([8 * (c // 8) + PI[c % 8] for c in range(s_pad)])
    return x[..., perm].contiguous()


def _q_side(ops, lse, s_valid, terms=3):
    """Rank 0: S = Q~ K^T, its columns >= s_valid to -inf, P = exp(S - L).
    Returns P as it hands it over."""
    (qh, ql, _, _, kh, kl, _, _, _, _) = ops
    s = _mm3((qh, ql), (_t(kh), _t(kl)), terms)
    s[..., s_valid:] = -float("inf")
    return torch.exp(s - lse[..., None])


def _do_side(ops, terms=3):
    """Rank 1: dP = dO V^T. Returns dP as it hands it over."""
    (_, _, oh, ol, _, _, vh, vl, _, _) = ops
    return _mm3((oh, ol), (_t(vh), _t(vl)), terms)


def _columns(ds, ops, boxes, terms=3):
    """One rank's columns of dQ (before the scale): the sum over kv tiles of
    BN columns of dS K^T'[its rows], each tile's product (three tf32
    products) a fresh accumulator added into the sum in f32."""
    kth, ktl = ops[8], ops[9]
    rows = [8 * b + r for b in boxes for r in range(8)]
    s_pad = kth.shape[-1]
    dh, dl = t_fa._split_tf32(_tiles(ds, s_pad))
    if terms == 1:
        dl = torch.zeros_like(dl)
    out = None
    for j in range(0, s_pad, BN):
        acc = _mm3((dh[..., j:j + BN], dl[..., j:j + BN]),
                   (_t(kth[..., rows, j:j + BN]),
                    _t(ktl[..., rows, j:j + BN])), terms)
        out = acc if out is None else out + acc
    return out


def _emulate(q, k, v, do, lse, delta, scale, terms=3, s_valid=None):
    """dQ as the cluster pair computes it, from the wrapper's own operands
    (t_fa._tf32x3_operands, "dq"); kv columns from s_valid on masked."""
    ops = t_fa._tf32x3_operands(t_fa._q_tilde(q, scale), do, k, v,
                                ("dq",))["dq"]
    if terms == 1:  # plain TF32: the lo parts are not read
        ops = tuple(x if i % 2 == 0 else torch.zeros_like(x)
                    for i, x in enumerate(ops))
    p = _q_side(ops, lse, k.shape[2] if s_valid is None else s_valid, terms)
    dp = _do_side(ops, terms)
    # both ranks form the same dS from the P and dP they hold
    ds = p * (dp - delta[..., None])
    parts = [_columns(ds, ops, boxes, terms) for boxes in _boxes(q.shape[3])]
    return torch.cat(parts, dim=-1) * scale


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
    (1, 2, 256, 256, 160), (1, 2, 300, 77, 160), (2, 1, 37, 129, 104),
    (1, 2, 200, 130, 104), (1, 1, 70, 50, 136), (2, 2, 33, 65, 152)])
def test_emulated_pair_matches_the_plain_version(shape):
    """3xTF32 as the pair runs it, with ragged T and S, the UNet's
    transposed views and unequal column boxes (D = 104, 136, 152), within
    REL_TOL of flash_bwd_dq_reference's largest value."""
    B, H, T, S, D = shape
    args = _inputs(B, H, T, S, D, seed=sum(shape),
                   heads_inner=shape[0] == 1)
    want = t_fa.flash_bwd_dq_reference(*args)
    got = _emulate(*args)
    assert got.shape == want.shape
    assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("D", [104, 160])
def test_emulated_pair_matches_pallas_bwd(D):
    """The model against the Pallas _bwd (interpret mode, f32 dots at
    HIGHEST) on _fwd's residuals: dQ within REL_TOL of the largest
    value."""
    B, H, T, S = 1, 2, 256, 128
    rng = np.random.default_rng(47 + D)
    q, k, v, do = (rng.standard_normal((B, H, n, D), dtype=np.float32)
                   for n in (T, S, S, T))
    scale = D ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_j, lse_j = j_fa._fwd(jq, jk, jv, scale)
    dq_j, _, _ = j_fa._bwd(scale, (jq, jk, jv, o_j, lse_j), jnp.asarray(do))
    tdo = torch.from_numpy(do)
    lse = torch.from_numpy(np.array(lse_j).reshape(B, H, T))
    delta = t_fa._delta(torch.from_numpy(np.array(o_j)), tdo)
    dq = _emulate(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), tdo, lse, delta, scale)
    assert _rel(dq, torch.from_numpy(np.array(dq_j))) <= REL_TOL


def test_plain_tf32_misses_the_limit():
    """Why the pair runs 3xTF32 at D = 160 too: hi.hi alone (1xTF32, 10
    mantissa bits) is more than REL_TOL from the f32 result."""
    args = _inputs(1, 2, 256, 256, 160, seed=37)
    want = t_fa.flash_bwd_dq_reference(*args)
    assert _rel(_emulate(*args, terms=1), want) > REL_TOL
    assert _rel(_emulate(*args), want) <= REL_TOL


def test_masked_kv_columns_and_q_rows_past_t_add_nothing():
    """kv columns >= S (rows of K and V that are not zero, masked to -inf
    before the exponential: P = 0, dS = 0) and q rows past T (zero Q~ and
    dO rows, L = delta = 0: P = 1, dP = 0, dS = 0) add nothing: the model
    on inputs padded past T and S, sliced, is the model on the unpadded
    ones (to 1e-6 of the largest value: the CPU's matmuls block their sums
    by the row count), and the padded rows are exactly 0."""
    B, H, T, S, D = 1, 2, 100, 70, 160
    q, k, v, do, lse, delta, scale = _inputs(B, H, T, S, D, seed=59)
    dq = _emulate(q, k, v, do, lse, delta, scale)
    rng = np.random.default_rng(61)

    def pad(x, rows, noise=False):
        extra = (torch.from_numpy(rng.standard_normal(
            (B, H, rows - x.shape[2], x.shape[3]), np.float32))
            if noise else x.new_zeros((B, H, rows - x.shape[2], x.shape[3])))
        return torch.cat([x, extra], dim=2)

    Tp, Sp = T + 28, S + 58
    dqp = _emulate(pad(q, Tp), pad(k, Sp, True), pad(v, Sp, True),
                   pad(do, Tp), pad(lse[..., None], Tp)[..., 0],
                   pad(delta[..., None], Tp)[..., 0], scale, s_valid=S)
    assert torch.isfinite(dqp).all()
    assert _rel(dqp[:, :, :T], dq) <= 1e-6
    torch.testing.assert_close(dqp[:, :, T:], torch.zeros_like(dqp[:, :, T:]),
                               rtol=0, atol=0)


def test_unmasked_kv_columns_would_poison_the_sum():
    """Why rank 0 masks: K rows past S read as zero give P = exp(-L), which
    overflows f32 where L < -88, and that inf dS times a zero K^T column is
    NaN. Scores near -100 everywhere (q and k opposed along one axis) put
    L there."""
    B, H, T, S, D = 1, 1, 16, 20, 104
    rng = np.random.default_rng(67)

    def make(L, axis):
        x = 0.1 * rng.standard_normal((B, H, L, D), np.float32)
        x[..., 0] += axis
        return torch.from_numpy(x)

    scale = D ** -0.5
    q, k = make(T, 10 * D ** 0.5), make(S, -10.0)
    v, do = make(S, 0.0), make(T, 1.0)
    o, lse = t_fa.flash_attention_reference(q, k, v, scale)
    delta = t_fa._delta(o, do)
    assert lse.max() < -88
    zeros = k.new_zeros((B, H, 12, D))
    kp, vp = torch.cat([k, zeros], 2), torch.cat([v, zeros], 2)
    args = (q, kp, vp, do, lse, delta, scale)
    assert torch.isfinite(_emulate(*args, s_valid=S)).all()
    assert not torch.isfinite(_emulate(*args, s_valid=S + 12)).all()


# --- the column boxes of the two ranks --------------------------------------

@pytest.mark.parametrize("dp", WIDE)
def test_column_boxes_cover_every_column_once(dp):
    """Rank 0's ceil(DP / 16) boxes and rank 1's rest cover columns 0..DP
    once each; each share is a width the tf32 register-A wgmma takes
    (sm90.cuh has its accumulator array), and rank 0's is the larger."""
    b0, b1 = _boxes(dp)
    cols = [8 * b + c for b in b0 + b1 for c in range(8)]
    assert sorted(cols) == list(range(dp)) and len(set(cols)) == dp
    assert len(b0) - len(b1) in (0, 1)
    widths = {int(n) for n in re.findall(
        r"void wgmma_rs_tf32\(float \(&d\)\[(\d+)\]", _src("sm90.cuh"))}
    assert {4 * len(b0), 4 * len(b1)} <= widths


# --- the route --------------------------------------------------------------

def _bthd(B, T, H, D, dtype=torch.float32):
    return torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("D", WIDE)
def test_wide_f32_dq_routes_to_the_pair(D):
    """f32 dQ at every width above WGMMA_F32_DQ_MAX_D up to
    WGMMA_F32_DQ_WIDE_MAX_D takes tf32x3_wide, the UNet's transposed views
    and contiguous tensors alike."""
    q = _bthd(1, 64, 2, D)
    assert t_fa._dq_route(q, q, q, q) == "tf32x3_wide"
    c = torch.zeros((1, 2, 77, D))
    assert t_fa._dq_route(c, c, c, c) == "tf32x3_wide"


@pytest.mark.parametrize("D,want", [
    (96, "tf32x3"), (168, "mma"), (256, "mma")])
def test_f32_dq_route_either_side_of_the_pair(D, want):
    q = _bthd(1, 64, 2, D)
    assert t_fa._dq_route(q, q, q, q) == want


@pytest.mark.parametrize("D", [104, 160])
def test_wide_f32_dq_odd_layouts_and_broadcasts_stay_on_mma(D):
    """A layout _check refuses, in any of q, k, v, dO, and a stride of 0
    (k and v shared over heads) take the mma kernel."""
    good = _bthd(1, 64, 2, D)
    odd = torch.zeros((1, 2, 64, D + 4))[..., :D]
    assert not t_fa._layout_ok(odd)
    for i in range(4):
        args = [good] * 4
        args[i] = odd
        assert t_fa._dq_route(*args) == "mma"
    shared = torch.zeros((1, 1, 64, D)).expand(1, 2, 64, D)
    assert t_fa._dq_route(good, shared, shared, good) == "mma"


@pytest.mark.parametrize("D,want", [
    (104, "wgmma"), (160, "wgmma"), (168, "mma")])
def test_bf16_dq_route_unchanged(D, want):
    q = _bthd(1, 64, 2, D, torch.bfloat16)
    assert t_fa._dq_route(q, q, q, q) == want


def test_both_backward_kernels_read_one_split_at_d160():
    """At D = 160 both backward routes are in TF32X3_ROUTES, so
    flash_attention_backward forms one split for both: the "dq" and "dkv"
    parts share Q~, dO, K and V hi and lo, and "dq" adds K's transposed
    copies."""
    q = _bthd(1, 64, 2, 160)
    routes = {t_fa._dq_route(q, q, q, q), t_fa._bwd_route(q, q, q, q)}
    assert routes == {"tf32x3_wide"} and routes <= set(t_fa.TF32X3_ROUTES)
    args = _inputs(1, 2, 40, 24, 160, seed=79)
    qt = t_fa._q_tilde(args[0], args[-1])
    ops = t_fa._tf32x3_operands(qt, args[3], args[1], args[2])
    assert len(ops["dq"]) == 10 and len(ops["dkv"]) == 12
    assert all(a is b for a, b in zip(ops["dq"][:8], ops["dkv"][:8]))
    assert ops["dq"][8].shape == (1, 2, 160, t_fa.TF32X3_S_ALIGN)


# --- the constants, the instances, shared memory ---------------------------

def test_constants_match_the_kernel_source():
    """WGMMA_F32_DQ_WIDE_MAX_D is the source's MAX_DP, its MIN_DP is one
    step above WGMMA_F32_DQ_MAX_D, its instance switch covers every
    multiple of 8 between them (entry point and config entry alike), BM is
    TF32X3_DQ_WIDE_BM, S_ALIGN is TF32X3_S_ALIGN and holds whole kv tiles,
    and the entry takes the tf32x3 dQ kernel's thirteen pointers."""
    src = _src()
    assert _const("MAX_DP") == t_fa.WGMMA_F32_DQ_WIDE_MAX_D
    assert _const("MIN_DP") == t_fa.WGMMA_F32_DQ_MAX_D + 8
    cases = [int(x) for x in re.findall(
        r"^\s*DQ_WIDE_CASE\((\d+)\)\s*$", src, re.M)]
    configs = [int(x) for x in re.findall(
        r"^\s*DQ_WIDE_CONFIG\((\d+)\)\s*$", src, re.M)]
    assert cases == configs == WIDE
    assert BM == t_fa.TF32X3_DQ_WIDE_BM == 64
    assert _const("S_ALIGN") == t_fa.TF32X3_S_ALIGN
    assert t_fa.TF32X3_S_ALIGN % BN == 0 and BN % 8 == 0
    assert "__cluster_dims__(2, 1, 1)" in src
    assert t_fa._ENTRY["dq_tf32x3_wide"] == (
        "flash_bwd_dq_tf32x3_wide", "flash_bwd_dq_tf32x3_wide", 13)
    assert t_fa._ENTRY["dq_tf32x3_wide"][2] == t_fa._ENTRY["dq_tf32x3"][2]


def _cfg(dp):
    """The source's Cfg<DP> and Smem<DP> evaluated in Python from its own
    rules: (STAGES, dynamic shared memory bytes, registers a consumer
    thread in arrays, rank 0's share)."""
    kb, nk = dp // 8, BN // 8
    nb0 = len(_boxes(dp)[0])
    x_bytes = 2 * kb * BM * 8 * 4
    stage = (2 * kb * BN * 8 + 2 * nk * nb0 * 64) * 4
    p_bytes = 2 * BM * BN * 4
    fit = (SMEM_MAX - 1024 - 256 - x_bytes - p_bytes) // stage
    stages = min(4, fit)
    smem = x_bytes + stages * stage + p_bytes + 8 * (2 * stages + 3) + 1024
    regs = 8 * nb0 + 2 * BN
    return stages, smem, regs


def _note_table():
    """{DP: (stages, shared memory, registers)} from the source note."""
    rows = re.findall(r"^//\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s*$", _src(),
                      re.M)
    return {int(r[0]): tuple(int(x) for x in r[1:]) for r in rows}


@pytest.mark.parametrize("dp", WIDE)
def test_each_instance_fits_shared_memory(dp):
    """Each instance's ring depth, shared memory and register arrays as the
    source note states them are what its rules give; the shared memory
    fits SMEM_MAX with at least 2 stages and the arrays stay below 255
    registers."""
    stages, smem, regs = _cfg(dp)
    assert _note_table()[dp] == (stages, smem, regs)
    assert stages >= 2 and smem <= SMEM_MAX and regs < 255
    if dp == 160:
        assert (stages, smem, regs) == (2, 222264, 144)


def test_note_table_covers_every_instance():
    assert sorted(_note_table()) == WIDE


# --- the counts --------------------------------------------------------------

def test_cpu_f32_wide_dq_call_launches_nothing():
    """An f32 flash_bwd_dq call and a whole backward at a tf32x3_wide
    shape on CPU tensors take the plain versions and move no count."""
    q, k, v, do, lse, delta, scale = _inputs(1, 2, 64, 48, 160, seed=73,
                                             heads_inner=True)
    args = (q, k, v, do, lse, delta, scale)
    assert t_fa._dq_route(q, k, v, do) == "tf32x3_wide"
    fns = (t_fa.flash_bwd_dq, t_fa.flash_bwd_dkv)
    before = [(dict(f.launches_by_kernel), f.launches) for f in fns]
    assert set(before[0][0]) == {"wgmma", "tf32x3", "tf32x3_wide", "mma"}
    dq = t_fa.flash_bwd_dq(*args)
    o, _ = t_fa.flash_attention_reference(q, k, v, scale)
    dq_b, _, _ = t_fa.flash_attention_backward(q, k, v, o, lse, do, scale)
    assert [(dict(f.launches_by_kernel), f.launches) for f in fns] == before
    want = t_fa.flash_bwd_dq_reference(*args)
    torch.testing.assert_close(dq, want, rtol=0, atol=0)
    torch.testing.assert_close(dq_b, want, rtol=0, atol=0)
