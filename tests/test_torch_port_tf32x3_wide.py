"""The f32 dK/dV kernel for wide heads (96 < D <= 160) on a cluster of two
CTAs (csrc/flash_bwd_dkv_tf32x3_wide.cu) on the CPU: a model of the pair's
arithmetic built from the wrapper's own operand tensors (the K side: S^T,
P^T and dV; the V side: dP^T, dS^T from the P^T it is handed, and dK; one
fresh accumulator per q tile added in f32) against the plain version and
the Pallas _bwd (interpret mode), the q rows past T, the route, the
constants and shared memory of each instance read back from the source,
and the counts. The kernel itself runs only on the card:
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
# The kernel's dK and dV against the plain version, as a share of the
# largest value: the limit chip_smoke.py holds the kernel to on the card.
# 3xTF32 errs by about 2^-21 of each product's terms, and the exponentials
# and sums run in another order
REL_TOL = 1e-4
CSRC = os.path.join(os.path.dirname(t_fa.__file__), "csrc")
WIDE = list(range(t_fa.WGMMA_F32_DKV_MAX_D + 8,
                  t_fa.WGMMA_F32_DKV_WIDE_MAX_D + 1, 8))


def _src(name="flash_bwd_dkv_tf32x3_wide.cu"):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _const(name, src=None):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         src or _src()).group(1))


# an H100's dynamic shared memory per block, as the kernels' header has it
SMEM_MAX = _const("SMEM_MAX", _src("sm90.cuh"))
BQ = _const("BQ")


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


def _tiles(x, t_pad, value=0.0):
    """(..., kv, T) score columns padded to the q tiles' T_pad columns,
    pi-permuted within each group of 8 (k position p of a group is q column
    pi(p): the register-A order of the accumulator fragments)."""
    x = torch.nn.functional.pad(x, (0, t_pad - x.shape[-1]), value=value)
    perm = torch.tensor([8 * (c // 8) + PI[c % 8] for c in range(t_pad)])
    return x[..., perm].contiguous()


def _tile_sum(a, bt, t_pad, terms):
    """sum over q tiles of BQ columns of A_tile B_tile, each tile's product
    (three tf32 products) a fresh accumulator added into the sum in f32:
    a = (hi, lo) (..., 64-row kv, T_pad), bt = (hi, lo) of the transposed
    copy (..., D, T')."""
    out = None
    for j in range(0, t_pad, BQ):
        acc = _mm3(tuple(x[..., j:j + BQ] for x in a),
                   tuple(_t(x[..., j:j + BQ]) for x in bt), terms)
        out = acc if out is None else out + acc
    return out


def _k_side(ops, lse, T, terms=3):
    """Rank 0: S^T = K Q~^T, P^T = exp(S^T - L) (q columns past T: Q~ = 0
    and L = 0 give P = 1), dV = sum over q tiles of P^T dO. Returns (P^T as
    handed over, in q order, T_pad columns; dV)."""
    (qh, ql, _, _, kh, kl, _, _, _, _, oth, otl) = ops
    t_pad = -(-T // BQ) * BQ
    st = _mm3((kh, kl), (_t(qh), _t(ql)), terms)
    pt = torch.exp(st - lse[:, :, None, :])
    pt = torch.nn.functional.pad(pt, (0, t_pad - T), value=1.0)
    ph, pl = t_fa._split_tf32(_tiles(pt, t_pad))
    if terms == 1:
        pl = torch.zeros_like(pl)
    return pt, _tile_sum((ph, pl), (oth, otl), t_pad, terms)


def _v_side(ops, delta, pt, T, terms=3):
    """Rank 1: dP^T = V dO^T, dS^T = P^T o (dP^T - delta) with P^T as rank
    0 handed it (q columns past T: dO = 0 and delta = 0 give dS = 0),
    dK = sum over q tiles of dS^T Q~."""
    (_, _, oh, ol, _, _, vh, vl, qth, qtl, _, _) = ops
    t_pad = pt.shape[-1]
    dpt = _mm3((vh, vl), (_t(oh), _t(ol)), terms)
    dpt = torch.nn.functional.pad(dpt, (0, t_pad - T))
    dlt = torch.nn.functional.pad(delta, (0, t_pad - T))
    dst = pt * (dpt - dlt[:, :, None, :])
    dh, dl = t_fa._split_tf32(_tiles(dst, t_pad))
    if terms == 1:
        dl = torch.zeros_like(dl)
    return _tile_sum((dh, dl), (qth, qtl), t_pad, terms)


def _emulate(q, k, v, do, lse, delta, scale, terms=3):
    """dK, dV as the cluster pair computes them, from the wrapper's own
    operands (t_fa._tf32x3_operands, "dkv")."""
    ops = t_fa._tf32x3_operands(t_fa._q_tilde(q, scale), do, k, v,
                                ("dkv",))["dkv"]
    if terms == 1:  # plain TF32: the lo parts are not read
        ops = tuple(x if i % 2 == 0 else torch.zeros_like(x)
                    for i, x in enumerate(ops))
    T = q.shape[2]
    pt, dv = _k_side(ops, lse, T, terms)
    dk = _v_side(ops, delta, pt, T, terms)
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
    (1, 2, 256, 256, 160), (1, 2, 300, 77, 160), (2, 1, 37, 129, 104),
    (1, 2, 200, 130, 128), (1, 1, 70, 50, 104), (2, 2, 33, 65, 128)])
def test_emulated_pair_matches_the_plain_version(shape):
    """3xTF32 as the pair runs it, with ragged T and S and the UNet's
    transposed views, within REL_TOL of flash_bwd_dkv_reference's largest
    value."""
    B, H, T, S, D = shape
    args = _inputs(B, H, T, S, D, seed=sum(shape),
                   heads_inner=shape[0] == 1)
    want = t_fa.flash_bwd_dkv_reference(*args)
    got = _emulate(*args)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= REL_TOL, name


def test_emulated_pair_matches_pallas_bwd():
    """The model against the Pallas _bwd (interpret mode, f32 dots at
    HIGHEST) on _fwd's residuals at D = 160: dK and dV within REL_TOL of
    the largest value."""
    B, H, T, S, D = 1, 2, 256, 128, 160
    rng = np.random.default_rng(43)
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


def test_plain_tf32_misses_the_limit():
    """Why the pair runs 3xTF32 at D = 160 too: hi.hi alone (1xTF32, 10
    mantissa bits) is more than REL_TOL from the f32 result."""
    args = _inputs(1, 2, 256, 256, 160, seed=33)
    want = t_fa.flash_bwd_dkv_reference(*args)
    one = _emulate(*args, terms=1)
    three = _emulate(*args)
    for g1, g3, w in zip(one, three, want):
        assert _rel(g1, w) > REL_TOL
        assert _rel(g3, w) <= REL_TOL


def test_q_rows_past_t_add_nothing():
    """q rows past T (zero Q~ and dO rows, L = delta = 0: P = 1, dS = 0)
    add nothing, and kv rows past S only fill their own rows: the model on
    inputs padded past T and S, sliced, is the model on the unpadded ones."""
    B, H, T, S, D = 1, 2, 100, 70, 160
    q, k, v, do, lse, delta, scale = _inputs(B, H, T, S, D, seed=53)
    dk, dv = _emulate(q, k, v, do, lse, delta, scale)

    def pad(x, rows):
        return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[2]))

    Tp, Sp = T + 28, S + 58
    dkp, dvp = _emulate(pad(q, Tp), pad(k, Sp), pad(v, Sp), pad(do, Tp),
                        pad(lse[..., None], Tp)[..., 0],
                        pad(delta[..., None], Tp)[..., 0], scale)
    torch.testing.assert_close(dkp[:, :, :S], dk, rtol=0, atol=0)
    torch.testing.assert_close(dvp[:, :, :S], dv, rtol=0, atol=0)


# --- the route --------------------------------------------------------------

def _bthd(B, T, H, D, dtype=torch.float32):
    return torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("D,want", [
    (96, "tf32x3"), (104, "tf32x3_wide"), (112, "tf32x3_wide"),
    (128, "tf32x3_wide"), (160, "tf32x3_wide"), (168, "mma"), (256, "mma")])
def test_f32_dkv_route_by_head_width(D, want):
    """f32 dK/dV: tf32x3 up to WGMMA_F32_DKV_MAX_D, tf32x3_wide above it up
    to WGMMA_F32_DKV_WIDE_MAX_D, the mma kernel beyond; the UNet's
    transposed views and contiguous tensors alike."""
    q = _bthd(1, 64, 2, D)
    assert t_fa._bwd_route(q, q, q, q) == want
    c = torch.zeros((1, 2, 77, D))
    assert t_fa._bwd_route(c, c, c, c) == want


@pytest.mark.parametrize("D,want", [
    (104, "wgmma"), (160, "wgmma"), (168, "mma")])
def test_bf16_dkv_route_unchanged(D, want):
    q = _bthd(1, 64, 2, D, torch.bfloat16)
    assert t_fa._bwd_route(q, q, q, q) == want


@pytest.mark.parametrize("D", [104, 160])
def test_wide_f32_odd_layouts_and_broadcasts_stay_on_mma(D):
    """A layout _check refuses, in any of q, k, v, dO, and a stride of 0
    (k and v shared over heads) take the mma kernel."""
    good = _bthd(1, 64, 2, D)
    odd = torch.zeros((1, 2, 64, D + 4))[..., :D]
    assert not t_fa._layout_ok(odd)
    for i in range(4):
        args = [good] * 4
        args[i] = odd
        assert t_fa._bwd_route(*args) == "mma"
    shared = torch.zeros((1, 1, 64, D)).expand(1, 2, 64, D)
    assert t_fa._bwd_route(good, shared, shared, good) == "mma"


@pytest.mark.parametrize("D", [104, 160])
def test_wide_f32_dq_route_takes_tf32x3_wide(D):
    """dQ at these widths has its own cluster-pair kernel too
    (csrc/flash_bwd_dq_tf32x3_wide.cu), so one split serves both."""
    q = _bthd(1, 64, 2, D)
    assert t_fa._dq_route(q, q, q, q) == "tf32x3_wide"


# --- the constants, the instances, shared memory ---------------------------

def test_constants_match_the_kernel_source():
    """WGMMA_F32_DKV_WIDE_MAX_D is the source's MAX_DP, its MIN_DP is one
    step above WGMMA_F32_DKV_MAX_D, its instance switch covers every
    multiple of 8 between them (entry point and config entry alike), BN is
    TF32X3_WIDE_BN, T_ALIGN is TF32X3_T_ALIGN and holds a q tile, and the
    entry takes the tf32x3 kernel's sixteen pointers."""
    src = _src()
    assert _const("MAX_DP") == t_fa.WGMMA_F32_DKV_WIDE_MAX_D
    assert _const("MIN_DP") == t_fa.WGMMA_F32_DKV_MAX_D + 8
    cases = [int(x) for x in re.findall(
        r"^\s*DKV_WIDE_CASE\((\d+)\)\s*$", src, re.M)]
    configs = [int(x) for x in re.findall(
        r"^\s*DKV_WIDE_CONFIG\((\d+)\)\s*$", src, re.M)]
    assert cases == configs == WIDE
    assert _const("BN") == t_fa.TF32X3_WIDE_BN == 64
    assert _const("T_ALIGN") == t_fa.TF32X3_T_ALIGN
    assert BQ <= t_fa.TF32X3_T_ALIGN and BQ % 8 == 0
    assert "__cluster_dims__(2, 1, 1)" in src
    assert t_fa._ENTRY["dkv_tf32x3_wide"] == (
        "flash_bwd_dkv_tf32x3_wide", "flash_bwd_dkv_tf32x3_wide", 16)
    assert t_fa._ENTRY["dkv_tf32x3_wide"][2] == t_fa._ENTRY["dkv_tf32x3"][2]


def _cfg(dp):
    """The source's Cfg<DP> and Smem<DP> evaluated in Python from its own
    rules: (STAGES, dynamic shared memory bytes, registers a consumer
    thread in arrays)."""
    bn = _const("BN")
    x_bytes = 2 * (dp // 8) * bn * 8 * 4
    stage = 16 * BQ * dp
    p_bytes = 2 * bn * BQ * 4
    fit = (SMEM_MAX - 1024 - 256 - x_bytes - p_bytes) // (stage + BQ * 4)
    stages = min(4, fit)
    smem = (x_bytes + stages * stage + p_bytes + stages * BQ * 4
            + 8 * (2 * stages + 5) + 1024)
    regs = dp // 2 + dp // 2 + BQ // 2 + BQ
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
    fits SMEM_MAX with at least 2 stages (3 at DP = 160) and the arrays
    stay below 255 registers."""
    stages, smem, regs = _cfg(dp)
    assert _note_table()[dp] == (stages, smem, regs)
    assert stages >= 2 and smem <= SMEM_MAX and regs < 255
    if dp == 160:
        assert (stages, smem, regs) == (3, 214296, 184)


def test_note_table_covers_every_instance():
    assert sorted(_note_table()) == WIDE


# --- the counts --------------------------------------------------------------

def test_cpu_f32_wide_call_launches_nothing():
    """An f32 flash_bwd_dkv call and a whole backward at a tf32x3_wide
    shape on CPU tensors take the plain versions and move no count."""
    q, k, v, do, lse, delta, scale = _inputs(1, 2, 64, 48, 160, seed=73,
                                             heads_inner=True)
    args = (q, k, v, do, lse, delta, scale)
    assert t_fa._bwd_route(q, k, v, do) == "tf32x3_wide"
    fns = (t_fa.flash_bwd_dq, t_fa.flash_bwd_dkv)
    before = [(dict(f.launches_by_kernel), f.launches) for f in fns]
    assert set(before[1][0]) == {"wgmma", "tf32x3", "tf32x3_wide", "mma"}
    dk, dv = t_fa.flash_bwd_dkv(*args)
    o, _ = t_fa.flash_attention_reference(q, k, v, scale)
    _, dk_b, dv_b = t_fa.flash_attention_backward(q, k, v, o, lse, do, scale)
    assert [(dict(f.launches_by_kernel), f.launches) for f in fns] == before
    dk_ref, dv_ref = t_fa.flash_bwd_dkv_reference(*args)
    for got, want in ((dk, dk_ref), (dv, dv_ref), (dk_b, dk_ref),
                      (dv_b, dv_ref)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
