"""The f32 flash-attention forward on 3xTF32 (csrc/flash_fwd_tf32x3.cu) on
the CPU: a model of the kernel's arithmetic (the split of Q~, K, V and P
into tf32 hi and lo as the kernel makes it and the tensor cores read it,
the pi-permuted V^T, P read in register-fragment order, one fresh P V
accumulator per kv tile folded into O with the softmax's correction)
against the plain version and the Pallas _fwd (interpret mode), the
masking of kv columns past S, the split of Q~ the kernel makes in shared
memory against the wrapper's _split_tf32, the splitters' V^T index map
against _tf32x3_transposed, the route, the tile and shared-memory rule read
back from the source, and the counts. The kernel itself runs only on the
card: chip_smoke.py compares it with its plain version there."""

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
# The kernel's O and L against the plain version, as a share of each one's
# largest value: the limits chip_smoke.py holds the kernel to on the card
# (there absolute: O 1e-4, L 1e-5). 3xTF32 errs by about 2^-21 of each
# product's terms, and the exponentials and sums run in another order
O_TOL, L_TOL = 1e-4, 1e-5
NEG_INIT = -1e30  # the kernel's running-max init
CSRC = os.path.join(os.path.dirname(t_fa.__file__), "csrc")


def _src(name="flash_fwd_tf32x3.cu"):
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
    per = int(re.search(r"STAGE_BYTES = (\d+) \* BN \* DP \* 4;",
                        src).group(1))
    bm_max = 128 if dp <= int(bm.group(1)) else 64
    bn_ = (64 if dp <= int(bn.group(1))
           else 32 if dp <= int(bn.group(2)) else 16)
    q_bytes = 8 * bm_max * dp        # Q~ hi, lo
    stage = 4 * per * bn_ * dp       # K, K lo, V, V^T hi, lo
    stages = min(4, (SMEM_MAX - 1024 - 256 - q_bytes) // stage)
    barriers = 8 * (3 * stages + 2)
    return bn_, stages, q_bytes + stages * stage + barriers + 1024, bm_max


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


def _trunc(x):
    """What the tensor cores read of an f32 tf32 operand: its bit pattern
    with the low 13 mantissa bits dropped (truncation)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split_read(x, hi_rule):
    """(hi, lo) of x as the kernel writes them and the tensor cores read
    them. hi_rule "rna": hi = rna(x) (V, P), lo = x - hi; "trunc": hi = x as
    TMA lands it (K), lo = x - trunc(x). Both lo exact in f32 and truncated
    when read."""
    hi = t_fa._rna_tf32(x) if hi_rule == "rna" else _trunc(x)
    return hi, _trunc(x - hi)


def _emulate(q, k, v, scale, terms=3, mask=True):
    """(O, L) as the kernel computes them, one kv tile of the source's BN
    rows at a time: Q~ = q * scale split by _split_tf32, K and V split as
    _split_read has it (K and V rows past S zero, as TMA fills them), V^T
    pi-permuted; S = Q~ K^T;
    the tile's columns past S masked to -inf (mask=False leaves them); the
    online softmax (m from NEG_INIT, corr = exp(m_old - m), l = l corr +
    rowsum(P)); P split and read in the order the register fragments give
    it (k position p of a group of 8 is kv column pi(p)) against V^T; each
    tile's P V a fresh accumulator folded as O = O corr + tile; O / l and
    L = m + log(l)."""
    S, D = k.shape[2], k.shape[3]
    bn = _cfg(D)[0]
    sp = -(-S // bn) * bn
    qh, ql = t_fa._split_tf32(t_fa._q_tilde(q, scale))
    kh, kl, vh, vl = (torch.nn.functional.pad(x, (0, 0, 0, sp - S))
                      for x in (*_split_read(k, "trunc"),
                                *_split_read(v, "rna")))
    vth, vtl = (t_fa._tf32x3_transposed(x, bn) for x in (vh, vl))
    if terms == 1:  # plain TF32: the lo parts are not read
        ql, kl, vtl = (torch.zeros_like(x) for x in (ql, kl, vtl))
    perm = torch.tensor([8 * (c // 8) + PI[c % 8] for c in range(bn)])
    m = torch.full(q.shape[:3], NEG_INIT)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for j in range(0, sp, bn):
        c = slice(j, j + bn)
        s = _mm3((qh, ql), (_t(kh[..., c, :]), _t(kl[..., c, :])), terms)
        if mask and S - j < bn:
            s[..., S - j:] = -torch.inf
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * corr + p.sum(-1)
        ph, pl = _split_read(p[..., perm].contiguous(), "rna")
        if terms == 1:
            pl = torch.zeros_like(pl)
        tile = _mm3((ph, pl), (_t(vth[..., c]), _t(vtl[..., c])), terms)
        o = o * corr[..., None] + tile
        m = mx
    return o / l[..., None], m + torch.log(l)


def _inputs(B, H, T, S, D, seed, heads_inner=False):
    rng = np.random.default_rng(seed)

    def make(L):
        if heads_inner:
            return torch.from_numpy(rng.standard_normal(
                (B, L, H, D), np.float32)).transpose(1, 2)
        return torch.from_numpy(rng.standard_normal((B, H, L, D), np.float32))

    return make(T), make(S), make(S), D ** -0.5


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("D", [8, 40, 80, 160])
@pytest.mark.parametrize("TS", [(64, 64), (300, 77)],
                         ids=lambda ts: f"T{ts[0]}-S{ts[1]}")
def test_emulated_kernel_matches_the_plain_version(TS, D):
    """3xTF32 as the kernel runs it, at SD-1.5's head widths and D = 8, at
    T = S = 64 (the UNet's transposed views) and ragged (300, 77) (several
    q tiles, the last kv tile part masked): O and L within O_TOL and L_TOL
    of flash_attention_reference's largest values."""
    T, S = TS
    q, k, v, scale = _inputs(1, 2, T, S, D, seed=T + S + D,
                             heads_inner=T == S)
    o_ref, l_ref = t_fa.flash_attention_reference(q, k, v, scale)
    o, l = _emulate(q, k, v, scale)
    assert o.shape == o_ref.shape and l.shape == l_ref.shape
    assert _rel(o, o_ref) <= O_TOL
    assert _rel(l, l_ref) <= L_TOL


def test_plain_tf32_misses_the_limit():
    """Why the port uses 3xTF32: hi.hi alone (1xTF32, 10 mantissa bits)
    puts O more than O_TOL from the f32 forward."""
    q, k, v, scale = _inputs(1, 2, 256, 256, 40, seed=31)
    o_ref, _ = t_fa.flash_attention_reference(q, k, v, scale)
    assert _rel(_emulate(q, k, v, scale, terms=1)[0], o_ref) > O_TOL
    assert _rel(_emulate(q, k, v, scale)[0], o_ref) <= O_TOL / 10


@pytest.mark.parametrize("D", [40, 80])
def test_emulated_kernel_matches_pallas_fwd(D):
    """The model against the Pallas _fwd (interpret mode, f32 dots at
    HIGHEST): O and L within O_TOL and L_TOL of the largest values."""
    B, H, T, S = 1, 2, 256, 128
    rng = np.random.default_rng(43 + D)
    q, k, v = (rng.standard_normal((B, H, n, D), dtype=np.float32)
               for n in (T, S, S))
    scale = D ** -0.5
    o_j, lse_j = j_fa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale)
    o, l = _emulate(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), scale)
    assert _rel(o, torch.from_numpy(np.array(o_j))) <= O_TOL
    assert _rel(l, torch.from_numpy(np.array(lse_j).reshape(B, H, T))) \
        <= L_TOL


def test_masked_kv_columns_add_nothing():
    """Scores around -100 (L below -50): the zero K rows TMA fills past S
    would score 0, take the running max and all of the softmax's mass
    (P = 1 against e^-100, against zero V rows), so O would fall to 0 and
    L to log(51). Masked to -inf (P = 0), the columns past S of the last
    tile add nothing: O and L within the limits of the plain version's."""
    B, H, T, S, D = 1, 1, 16, 77, 8
    rng = np.random.default_rng(53)
    scale = D ** -0.5
    base = np.zeros(D, np.float32)
    base[0] = 10.0
    k = base + rng.standard_normal((B, H, S, D)).astype(np.float32)
    q = -base / scale + 0.1 * rng.standard_normal((B, H, T, D)).astype(
        np.float32)
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    q, k, v = map(torch.from_numpy, (q, k, v))
    o_ref, l_ref = t_fa.flash_attention_reference(q, k, v, scale)
    assert float(l_ref.max()) < -50
    o, l = _emulate(q, k, v, scale)
    assert _rel(o, o_ref) <= O_TOL and _rel(l, l_ref) <= L_TOL
    o_bad, l_bad = _emulate(q, k, v, scale, mask=False)
    assert _rel(o_bad, o_ref) > 0.5 and _rel(l_bad, l_ref) > 0.5


# --- the split made in shared memory ----------------------------------------

def _rna_model(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 written from its definition, apart from the
    wrapper's bit arithmetic: x rounded to 11 significant bits, to nearest
    with ties away from zero, computed exactly in float64 from frexp."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)  # |x| in [2^(e-1), 2^e)
    ulp = np.ldexp(1.0, e - 11)
    r = np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp
    return np.where(x64 == 0, x64, r).astype(np.float32)


@pytest.mark.parametrize("heads_inner", [True, False])
def test_in_kernel_split_of_q_is_the_wrappers_split_bit_for_bit(heads_inner):
    """What the splitters write over q: Q~ = q * f32(scale) in f32,
    hi = rna(Q~), lo = rna(Q~ - hi), modelled from cvt.rna's definition,
    equal bit for bit to _split_tf32(_q_tilde(q, scale)), the operands the
    tf32x3 backward kernels read."""
    q, _, _, scale = _inputs(1, 2, 100, 77, 40, seed=61,
                             heads_inner=heads_inner)
    qt = q.numpy() * np.float32(scale)
    assert qt.dtype == np.float32
    hi = _rna_model(qt)
    lo = _rna_model(qt - hi)
    for got, ref in zip((hi, lo), t_fa._split_tf32(t_fa._q_tilde(q, scale))):
        assert np.array_equal(np.ascontiguousarray(got).view(np.int32),
                              ref.contiguous().numpy().view(np.int32))


@pytest.mark.parametrize("hi_rule,bound", [("trunc", 2.0 ** -21),
                                           ("rna", 2.0 ** -22)])
def test_k_v_and_p_splits_hold_their_bounds(hi_rule, bound):
    """K read as its own hi (truncated) with lo = K - trunc(K), and V and P
    with hi = rna(x), lo = x - hi, each lo truncated when read: both parts
    tf32 (low 13 bits zero as read) and x = hi + lo within `bound` |x|,
    over values spanning many binades and the ties of rna."""
    rng = np.random.default_rng(67)
    x = (rng.standard_normal(20000) * np.exp2(
        rng.integers(-30, 30, 20000))).astype(np.float32)
    x[:8] = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
                      1 - 2.0 ** -12, 3.0, 0.0, 2.0 ** -20, 1e-30],
                     np.float32)
    t = torch.from_numpy(x)
    hi, lo = (_trunc(y) for y in _split_read(t, hi_rule))
    assert not bool(((hi.view(torch.int32) | lo.view(torch.int32))
                     & 0x1FFF).any())
    err = (t.double() - hi.double() - lo.double()).abs()
    assert bool((err <= bound * t.double().abs()).all())


def _swz(r, c):
    """The float index of (row r, column c) of a box of 8-column, 32-byte
    rows under the 32-byte swizzle: 16-byte chunk c // 4 of row r sits at
    chunk (c // 4) ^ ((r >> 2) & 1)."""
    return r * 8 + ((((c >> 2) ^ (r >> 2)) & 1) << 2) + (c & 3)


@pytest.mark.parametrize("D", [8, 40, 80, 160])
def test_vt_index_map_is_tf32x3_transposed(D):
    """The splitters' V^T: a V tile as TMA lands it (D / 8 swizzled boxes
    of BN kv rows), moved block by block with the kernel's own index
    expressions (lane (p, m2) reads columns 2 m2, 2 m2 + 1 of kv row pi(p)
    and writes V^T rows 2 m2 + (e ^ first), column p, of box nb), then
    unswizzled, is _tf32x3_transposed of the tile, every element written
    once. Each warp's 32 loads of a block fall on 256 contiguous bytes and
    each of its stores on 32 distinct banks."""
    src = _src()
    for line in ("const int o = ((p & 3) << 1) | (p >> 2);  // pi(p)",
                 "const int first = m2 >> 1;",
                 "const int src = o * BOX + ((((m2 >> 1) ^ (o >> 2)) & 1) "
                 "<< 2) + ((m2 & 1) << 1);",
                 "const int r = 2 * m2 + (e ^ first);",
                 "dst[e] = r * BOX + ((((p >> 2) ^ (r >> 2)) & 1) << 2) + "
                 "(p & 3);",
                 "s.v[stage][kb] + 8 * nb * BOX + src);",
                 "split_fast((e ^ first) ? x2.y : x2.x, hi, lo);"):
        assert line in src, line
    bn = _cfg(D)[0]
    kb_n, nb_n = D // 8, bn // 8
    rng = np.random.default_rng(D)
    tile = rng.standard_normal((bn, D)).astype(np.float32)
    raw = np.zeros((kb_n, bn * 8), np.float32)
    for r in range(bn):
        for c in range(D):
            raw[c // 8, _swz(r, c % 8)] = tile[r, c]
    vt = np.full((nb_n, D * 8), np.nan, np.float32)
    for blk in range(nb_n * kb_n):
        nb, kb = divmod(blk, kb_n)
        loads, stores = [], [[], []]
        for lane in range(32):
            p, m2 = lane & 7, lane >> 3
            o = ((p & 3) << 1) | (p >> 2)
            first = m2 >> 1
            src_at = o * 8 + ((((m2 >> 1) ^ (o >> 2)) & 1) << 2) + (
                (m2 & 1) << 1)
            at = 8 * nb * 8 + src_at
            x2 = raw[kb, at:at + 2]
            loads.append(at)
            for e in range(2):
                r = 2 * m2 + (e ^ first)
                dst = 8 * kb * 8 + r * 8 + (
                    (((p >> 2) ^ (r >> 2)) & 1) << 2) + (p & 3)
                assert np.isnan(vt[nb, dst])
                vt[nb, dst] = x2[1] if e ^ first else x2[0]
                stores[e].append(dst % 32)
        assert sorted(loads) == list(range(64 * nb, 64 * nb + 64, 2))
        assert all(len(set(b)) == 32 for b in stores)
    got = np.array([[vt[col // 8, _swz(row, col % 8)] for col in range(bn)]
                    for row in range(D)])
    want = t_fa._tf32x3_transposed(torch.from_numpy(tile)[None, None], bn)
    assert np.array_equal(got, want[0, 0].numpy())


# --- the route, the tiles, the counts --------------------------------------

def _bthd(B, T, H, D, dtype=torch.float32):
    return torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("D", [8, 40, 80, 96, 104, 128, 160])
def test_f32_forward_routes_to_tf32x3_up_to_its_widest_head(D):
    q = _bthd(1, 64, 2, D)
    assert t_fa._fwd_route(q, q, q) == "tf32x3"
    c = torch.zeros((1, 2, 77, D))
    assert t_fa._fwd_route(c, c, c) == "tf32x3"


@pytest.mark.parametrize("D", [168, 256])
def test_wider_f32_forward_heads_stay_on_mma(D):
    q = _bthd(1, 64, 2, D)
    assert t_fa._fwd_route(q, q, q) == "mma"


def test_f32_forward_odd_layouts_and_broadcasts_stay_on_mma():
    """A layout _check refuses, in any of q, k, v, and a stride of 0 (k and
    v shared over heads) take flash_fwd.cu; bf16 keeps its wgmma kernel."""
    good = _bthd(1, 64, 2, 40)
    odd = torch.zeros((1, 2, 64, 44))[..., :40]
    assert not t_fa._layout_ok(odd)
    for i in range(3):
        args = [good] * 3
        args[i] = odd
        assert t_fa._fwd_route(*args) == "mma"
    shared = torch.zeros((1, 1, 64, 40)).expand(1, 2, 64, 40)
    assert t_fa._fwd_route(good, shared, shared) == "mma"
    bf = _bthd(1, 64, 2, 40, torch.bfloat16)
    assert t_fa._fwd_route(bf, bf, bf) == "wgmma"


def test_constants_match_the_kernel_source():
    """WGMMA_F32_FWD_MAX_D is the source's MAX_DP and its instance switch,
    which covers every multiple of 8 up to it (the entry point and the
    config entry alike); TF32X3_FWD_BM128_MAX_D is where BM_MAX drops to
    64; the entry takes 5 pointers, as the other two forward kernels'."""
    src = _src()
    max_dp = int(re.search(r"constexpr int MAX_DP = (\d+);", src).group(1))
    cases = [int(x) for x in re.findall(
        r"^\s*FWD_TF32X3_CASE\((\d+)\)\s*$", src, re.M)]
    configs = [int(x) for x in re.findall(
        r"^\s*FWD_TF32X3_CONFIG\((\d+)\)\s*$", src, re.M)]
    assert max_dp == t_fa.WGMMA_F32_FWD_MAX_D
    assert cases == configs == list(range(8, max_dp + 1, 8))
    bm = re.search(r"BM_MAX = DP <= (\d+) \? 128 : 64;", src)
    assert int(bm.group(1)) == t_fa.TF32X3_FWD_BM128_MAX_D
    assert t_fa._ENTRY["tf32x3"] == ("flash_fwd_tf32x3", "flash_fwd_tf32x3",
                                     5)
    # the splitters are warps 1-3 of the producer warpgroup
    assert int(re.search(r"constexpr int SPLITTERS = (\d+);",
                         src).group(1)) == 96


@pytest.mark.parametrize("dp,want", [
    (8, (64, 4, 128)), (32, (64, 4, 128)), (40, (64, 3, 128)),
    (48, (32, 4, 128)), (64, (32, 4, 128)), (80, (32, 2, 128)),
    (88, (32, 2, 128)), (96, (16, 4, 128)), (128, (16, 2, 128)),
    (136, (16, 3, 64)), (160, (16, 2, 64))])
def test_tile_rule_fits_shared_memory(dp, want):
    """The source's Cfg<DP> (BN kv rows per stage, ring depth, BM_MAX) at
    each width: at least two stages and the whole CTA within the H100's
    232,448 bytes of shared memory."""
    bn, stages, smem, bm_max = _cfg(dp)
    assert (bn, stages, bm_max) == want
    assert smem <= SMEM_MAX


@pytest.mark.parametrize("T,bh,D,want", [
    (4096, 32, 40, 128), (4096, 8, 40, 128), (1024, 32, 80, 128),
    (1024, 8, 80, 64), (256, 32, 160, 64), (256, 8, 160, 64),
    (9216, 5, 64, 128), (4096, 8, 128, 128), (4096, 8, 136, 64)])
def test_fwd_tf32x3_bm(T, bh, D, want):
    """_fwd_bm's rule (132 SMs) where the instance holds 128 q rows, else
    64."""
    assert t_fa._fwd_tf32x3_bm(T, bh, D, 132) == want


def test_cpu_f32_forward_launches_nothing():
    """An f32 flash_fwd call and a flash_attention call at a tf32x3 shape
    on CPU tensors take the plain version and move no count of the forward
    wrapper, the tf32x3 one included."""
    q, k, v, scale = _inputs(1, 2, 256, 128, 40, seed=71, heads_inner=True)
    assert t_fa._fwd_route(q, k, v) == "tf32x3"
    before = (dict(t_fa.flash_fwd.launches_by_kernel), t_fa.flash_fwd.launches)
    assert set(before[0]) == {"wgmma", "tf32x3", "mma"}
    assert sum(before[0].values()) == before[1]
    got = t_fa.flash_fwd(q, k, v, scale)
    got_a = t_fa.flash_attention(q, k, v, scale)
    assert (dict(t_fa.flash_fwd.launches_by_kernel),
            t_fa.flash_fwd.launches) == before
    want = t_fa.flash_attention_reference(q, k, v, scale)
    for a, b in ((got, want), (got_a, want)):
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
        torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
