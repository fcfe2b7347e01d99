"""The f32 dQ kernel on 3xTF32 (csrc/flash_bwd_dq_tf32x3.cu) on the CPU: a
model of the kernel's arithmetic built from the wrapper's own operand
tensors (the split of every f32 operand, the pi-permuted transposed copy of
K, dS read in register-fragment order, one fresh accumulator per kv tile
added in f32) against the plain version and the Pallas _bwd (interpret
mode), the masking of kv columns past S, the split that both tf32x3
kernels share, the route, the tile rule, and the counts. The kernel itself
runs only on the card: chip_smoke.py compares it with its plain version
there."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.ops import flash_attention as j_fa  # noqa: E402
from lora_tpu_torch.ops import flash_attention as t_fa  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

PI = [0, 2, 4, 6, 1, 3, 5, 7]
# The kernel's dQ against the plain version, as a share of the largest
# value: the limit chip_smoke.py holds the kernel to on the card. 3xTF32
# errs by about 2^-21 of each product's terms, and the exponentials and
# sums run in another order
REL_TOL = 1e-4
CSRC = os.path.join(os.path.dirname(t_fa.__file__), "csrc")


def _src(name="flash_bwd_dq_tf32x3.cu"):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# an H100's dynamic shared memory per block, as the kernels' header has it
SMEM_MAX = int(re.search(r"constexpr int SMEM_MAX = (\d+);",
                         _src("sm90.cuh")).group(1))


def _cfg(dp):
    """The source's Cfg<DP> evaluated in Python from its own rules:
    (BN, STAGES, dynamic shared memory bytes, BM_MAX)."""
    src = _src()
    bm = re.search(r"BM_MAX = DP <= (\d+) \? 128 : 64;", src)
    bn = re.search(r"BN = DP <= (\d+) \? 64 : DP <= (\d+) \? 32 : 16;", src)
    bm_max = 128 if dp <= int(bm.group(1)) else 64
    bn_ = (64 if dp <= int(bn.group(1))
           else 32 if dp <= int(bn.group(2)) else 16)
    stage = 6 * bn_ * dp * 4
    q_bytes = 4 * (dp // 8) * bm_max * 8 * 4
    stages = min(4, (SMEM_MAX - 1024 - 256 - q_bytes) // stage)
    smem = q_bytes + stages * stage + 8 * (2 * stages + 1) + 1024
    return bn_, stages, smem, bm_max


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


def _t(x):
    return x.transpose(-1, -2)


def _emulate(q, k, v, do, lse, delta, scale, terms=3, mask=True):
    """dQ as the kernel computes it, from the wrapper's own operands
    (t_fa._tf32x3_operands(...)["dq"]), one kv tile of the source's BN
    columns at a time: S and dP from the split Q~, dO, K, V (K and V rows
    past S zero, as TMA fills them); the tile's columns past S masked to
    -inf (mask=False leaves them); dS split and read in the order the
    register fragments give it (k position p of a group of 8 is kv column
    pi(p)) against the pi-permuted transposed copy of K; each tile's product
    a fresh accumulator added into dQ in f32; dQ times scale."""
    qt = t_fa._q_tilde(q, scale)
    ops = t_fa._tf32x3_operands(qt, do, k, v, ("dq",))["dq"]
    qh, ql, oh, ol, kh, kl, vh, vl, kth, ktl = ops
    S, D = k.shape[2], k.shape[3]
    sp = kth.shape[-1]
    bn = _cfg(D)[0]
    if terms == 1:  # plain TF32: the lo parts are not read
        ql, ol, kl, vl, ktl = (torch.zeros_like(t) for t in
                               (ql, ol, kl, vl, ktl))
    kh, kl, vh, vl = (torch.nn.functional.pad(t, (0, 0, 0, sp - S))
                      for t in (kh, kl, vh, vl))
    perm = torch.tensor([8 * (c // 8) + PI[c % 8] for c in range(bn)])
    dq = torch.zeros_like(qh)
    for j in range(0, -(-S // bn) * bn, bn):
        c = slice(j, j + bn)
        s = _mm3((qh, ql), (_t(kh[..., c, :]), _t(kl[..., c, :])), terms)
        dp = _mm3((oh, ol), (_t(vh[..., c, :]), _t(vl[..., c, :])), terms)
        if mask and S - j < bn:
            s[..., S - j:] = -torch.inf
        p = torch.exp(s - lse[..., None])
        ds = p * (dp - delta[..., None])
        dh, dl = t_fa._split_tf32(ds[..., perm].contiguous())
        if terms == 1:
            dl = torch.zeros_like(dl)
        dq = dq + _mm3((dh, dl), (_t(kth[..., c]), _t(ktl[..., c])), terms)
    return dq * scale


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
    (1, 2, 200, 130, 64), (1, 1, 70, 50, 80), (1, 1, 33, 65, 96),
    (1, 2, 64, 300, 40)])
def test_emulated_kernel_matches_the_plain_version(shape):
    """3xTF32 as the kernel runs it, including ragged T and S, several kv
    tiles and the UNet's transposed views, within REL_TOL of
    flash_bwd_dq_reference's largest value."""
    B, H, T, S, D = shape
    args = _inputs(B, H, T, S, D, seed=sum(shape),
                   heads_inner=shape[0] == 1)
    want = t_fa.flash_bwd_dq_reference(*args)
    got = _emulate(*args)
    assert got.shape == want.shape
    assert _rel(got, want) <= REL_TOL


def test_plain_tf32_misses_the_limit():
    """Why the port uses 3xTF32: hi.hi alone (1xTF32, 10 mantissa bits)
    is more than REL_TOL from the f32 dQ."""
    args = _inputs(1, 2, 256, 256, 40, seed=31)
    want = t_fa.flash_bwd_dq_reference(*args)
    assert _rel(_emulate(*args, terms=1), want) > REL_TOL
    assert _rel(_emulate(*args), want) <= REL_TOL / 10


def test_emulated_kernel_matches_pallas_bwd():
    """The model against the Pallas _bwd (interpret mode, f32 dots at
    HIGHEST) on _fwd's residuals: dQ within REL_TOL of the largest
    value."""
    B, H, T, S, D = 1, 2, 256, 128, 40
    rng = np.random.default_rng(43)
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


def test_masked_kv_columns_add_nothing():
    """Scores near -100 put L below -88: a zero K row past S would give
    P = exp(-L), which overflows f32, and inf times the zero K^T column is
    NaN. Masked to -inf (P = 0, dS = 0), the columns past S of the last
    tile add nothing: the model is finite and within REL_TOL of the plain
    version; unmasked it is not finite."""
    B, H, T, S, D = 1, 1, 16, 70, 8
    rng = np.random.default_rng(53)
    scale = D ** -0.5
    base = np.zeros(D, np.float32)
    base[0] = 10.0
    # K along e0 sets the scores near -100; its other columns (3 times
    # larger than q's) set dQ, so dQ does not cancel down to rounding
    spread = np.full(D, 3.0, np.float32)
    spread[0] = 0.1
    k = base + spread * rng.standard_normal((B, H, S, D)).astype(np.float32)
    q = -base / scale + 0.1 * rng.standard_normal((B, H, T, D)).astype(
        np.float32)
    v, do = (rng.standard_normal((B, H, n, D)).astype(np.float32)
             for n in (S, T))
    q, k, v, do = map(torch.from_numpy, (q, k, v, do))
    o, lse = t_fa.flash_attention_reference(q, k, v, scale)
    assert float(lse.max()) < -88
    args = (q, k, v, do, lse, t_fa._delta(o, do), scale)
    want = t_fa.flash_bwd_dq_reference(*args)
    got = _emulate(*args)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= REL_TOL
    assert not bool(torch.isfinite(_emulate(*args, mask=False)).all())


# --- the shared split --------------------------------------------------------

def _old_dkv_operands(q_tilde, do, k, v):
    """The dK/dV kernel's twelve operands as the wrapper formed them before
    the split was shared: each f32 tensor split into hi and lo (Q~, dO, K,
    V in their layouts), then the transposed copies of Q~ and dO."""
    qh, ql = t_fa._split_tf32(q_tilde)
    oh, ol = t_fa._split_tf32(do)
    return (qh, ql, oh, ol, *t_fa._split_tf32(k), *t_fa._split_tf32(v),
            t_fa._tf32x3_transposed(qh), t_fa._tf32x3_transposed(ql),
            t_fa._tf32x3_transposed(oh), t_fa._tf32x3_transposed(ol))


@pytest.mark.parametrize("heads_inner", [True, False])
def test_shared_split_keeps_the_dkv_operands_bit_for_bit(heads_inner):
    """One split for both kernels: the dK/dV part is the old operands bit
    for bit, layouts included; the dQ part shares the split of Q~, dO, K and
    V (the same tensors) and adds the pi-permuted copies of K hi and lo,
    padded to TF32X3_S_ALIGN."""
    q, k, v, do, _, _, scale = _inputs(1, 2, 100, 77, 40, seed=61,
                                       heads_inner=heads_inner)
    qt = t_fa._q_tilde(q, scale)
    ops = t_fa._tf32x3_operands(qt, do, k, v)
    assert set(ops) == {"dq", "dkv"}
    old = _old_dkv_operands(qt, do, k, v)
    assert len(ops["dkv"]) == len(old) == 12
    for got, want in zip(ops["dkv"], old):
        assert got.shape == want.shape and got.stride() == want.stride()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert len(ops["dq"]) == 10
    assert all(a is b for a, b in zip(ops["dq"][:8], ops["dkv"][:8]))
    kh, kl = ops["dq"][4:6]
    for got, part in zip(ops["dq"][8:], (kh, kl)):
        want = t_fa._tf32x3_transposed(part, t_fa.TF32X3_S_ALIGN)
        assert got.shape == (1, 2, 40, 128) and got.is_contiguous()
        assert torch.equal(got, want)
    for name in ("dq", "dkv"):
        alone = t_fa._tf32x3_operands(qt, do, k, v, (name,))
        assert set(alone) == {name}
        assert all(torch.equal(a, b) for a, b in zip(alone[name], ops[name]))


# --- the route, the tiles, the counts --------------------------------------

def _bthd(B, T, H, D, dtype=torch.float32):
    return torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("D", [8, 40, 64, 72, 80, 96])
def test_f32_dq_routes_to_tf32x3_up_to_its_widest_head(D):
    q = _bthd(1, 64, 2, D)
    assert t_fa._dq_route(q, q, q, q) == "tf32x3"
    c = torch.zeros((1, 2, 77, D))
    assert t_fa._dq_route(c, c, c, c) == "tf32x3"


@pytest.mark.parametrize("D", [104, 160, 256])
def test_wider_f32_dq_heads_stay_on_mma(D):
    """Heads wider than this kernel's go to the tf32x3_wide dQ kernel up to
    WGMMA_F32_DQ_WIDE_MAX_D, and beyond it stay on the mma kernel."""
    q = _bthd(1, 64, 2, D)
    want = "tf32x3_wide" if D <= t_fa.WGMMA_F32_DQ_WIDE_MAX_D else "mma"
    assert t_fa._dq_route(q, q, q, q) == want


def test_f32_dq_odd_layouts_and_broadcasts_stay_on_mma():
    """A layout _check refuses, in any of q, k, v, dO, and a stride of 0
    (k and v shared over heads) take the mma dQ kernel; bf16 keeps its
    wgmma kernel."""
    good = _bthd(1, 64, 2, 40)
    odd = torch.zeros((1, 2, 64, 44))[..., :40]
    assert not t_fa._layout_ok(odd)
    for i in range(4):
        args = [good] * 4
        args[i] = odd
        assert t_fa._dq_route(*args) == "mma"
    shared = torch.zeros((1, 1, 64, 40)).expand(1, 2, 64, 40)
    assert t_fa._dq_route(good, shared, shared, good) == "mma"
    bf = _bthd(1, 64, 2, 40, torch.bfloat16)
    assert t_fa._dq_route(bf, bf, bf, bf) == "wgmma"


def test_constants_match_the_kernel_source():
    """WGMMA_F32_DQ_MAX_D is the source's MAX_DP and its instance switch,
    which covers every multiple of 8 up to it (the entry point and the
    config entry alike); TF32X3_DQ_BM128_MAX_D is where BM_MAX drops to 64;
    TF32X3_S_ALIGN is S_ALIGN; the entry takes 13 pointers."""
    src = _src()
    max_dp = int(re.search(r"constexpr int MAX_DP = (\d+);", src).group(1))
    cases = [int(x) for x in re.findall(
        r"^\s*DQ_TF32X3_CASE\((\d+)\)\s*$", src, re.M)]
    configs = [int(x) for x in re.findall(
        r"^\s*DQ_TF32X3_CONFIG\((\d+)\)\s*$", src, re.M)]
    assert max_dp == t_fa.WGMMA_F32_DQ_MAX_D
    assert cases == configs == list(range(8, max_dp + 1, 8))
    bm = re.search(r"BM_MAX = DP <= (\d+) \? 128 : 64;", src)
    assert int(bm.group(1)) == t_fa.TF32X3_DQ_BM128_MAX_D
    align = re.search(r"constexpr int S_ALIGN = (\d+);", src)
    assert int(align.group(1)) == t_fa.TF32X3_S_ALIGN
    assert t_fa._ENTRY["dq_tf32x3"] == ("flash_bwd_dq_tf32x3",
                                        "flash_bwd_dq_tf32x3", 13)


@pytest.mark.parametrize("dp,want", [
    (8, (64, 4, 128)), (32, (64, 3, 128)), (40, (64, 2, 128)),
    (48, (32, 3, 128)), (64, (32, 2, 128)), (72, (32, 2, 64)),
    (80, (32, 2, 64)), (88, (32, 2, 64)), (96, (16, 3, 64))])
def test_tile_rule_fits_shared_memory(dp, want):
    """The source's Cfg<DP> (BN kv rows per stage, ring depth, BM_MAX)
    at each width: at least two stages and the whole CTA within the H100's
    232,448 bytes of shared memory, and each BN a divisor of S_ALIGN."""
    bn, stages, smem, bm_max = _cfg(dp)
    assert (bn, stages, bm_max) == want
    assert smem <= SMEM_MAX and t_fa.TF32X3_S_ALIGN % bn == 0


@pytest.mark.parametrize("T,bh,D,want", [
    (4096, 8, 40, 128), (1024, 8, 40, 64), (4096, 8, 64, 128),
    (4096, 8, 72, 64), (1024, 8, 80, 64), (256, 8, 96, 64),
    (9216, 5, 64, 128)])
def test_dq_tf32x3_bm(T, bh, D, want):
    """_dq_bm's rule (132 SMs) where the instance holds 128 q rows, else
    64."""
    assert t_fa._dq_tf32x3_bm(T, bh, D, 132) == want


def test_cpu_f32_dq_call_launches_nothing():
    """An f32 flash_bwd_dq call and a whole backward at a tf32x3 shape on
    CPU tensors take the plain versions and move no count of either
    backward wrapper, the tf32x3 ones included."""
    q, k, v, do, lse, delta, scale = _inputs(1, 2, 256, 128, 40, seed=71,
                                             heads_inner=True)
    args = (q, k, v, do, lse, delta, scale)
    assert t_fa._dq_route(q, k, v, do) == "tf32x3"
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
