"""The f32 route of the int8 matmul (csrc/int8_matmul_wgmma_f32.cu) on the
CPU: the route that sends f32 x to it, a bit-level model of its rounding
of x (each consumer thread's part of the f32 boxes TMA lands rounded into
the swizzled bf16 tile the wgmma descriptor reads) against
x.to(torch.bfloat16), the banks of those loads and stores, a model of its
f32 sum
(one tensor-core accumulator over all of K) against the plain version at
SD-1.5's longest K, the plain version against the Pallas _kernel
(interpret mode) for f32 x at ragged shapes, each instance's ring and
shared memory read back from the source, and its tile model. The kernel
itself runs only on the card: chip_smoke.py compares it with its plain
version there."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import quantize as j_q  # noqa: E402
from lora_tpu.ops import int8_matmul as j_i8  # noqa: E402
from lora_tpu_torch.ops import int8_matmul as t_i8  # noqa: E402
from test_torch_port_quantize import SD15_INT8_SHAPES, _wq, _x  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

CSRC = os.path.join(os.path.dirname(t_i8.__file__), "csrc")
# max |kernel - plain| / max |plain| of f32 outputs on the card
# (chip_smoke.py INT8_REL_TOL[torch.float32]): the two differ only in the
# order of the f32 sums
F32_REL_TOL = 1e-5


def _src(name="int8_matmul_wgmma_f32.cu"):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _const(name, src=None):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         src or _src()).group(1))


SMEM_MAX = _const("SMEM_MAX", _src("sm90.cuh"))


# --- the route -------------------------------------------------------------

@pytest.mark.parametrize("mkn", SD15_INT8_SHAPES, ids=str)
def test_route_sends_every_sd15_f32_serving_shape_to_wgmma_f32(mkn):
    M, K, N = mkn
    assert t_i8._route(_x(M, K, torch.float32), _wq(N, K)) == "wgmma_f32"


@pytest.mark.parametrize("case", ["k_not_16", "n_not_8", "x_4_bytes_past",
                                  "x_8_bytes_past", "w_misaligned"])
def test_route_sends_unaligned_f32_to_mma(case):
    """f32 x that TMA cannot load: K % 16 != 0 (16-byte rows of int8 W),
    N % 8 != 0 and bases that are not 16-byte aligned."""
    M, K, N = 100, 320, 320
    x, wq = _x(M, K, torch.float32), _wq(N, K)
    if case == "k_not_16":
        x, wq = _x(M, 40, torch.float32), _wq(N, 40)
    elif case == "n_not_8":
        wq = _wq(77, K)
    elif case == "w_misaligned":
        wq = torch.zeros(N * K + 16, dtype=torch.int8)[1:N * K + 1]
        wq = wq.view(N, K)
    else:
        off = 1 if case == "x_4_bytes_past" else 2
        x = torch.zeros(M * K + 4, dtype=torch.float32)[off:M * K + off]
        x = x.view(M, K)
        assert x.data_ptr() % 16 == 4 * off
    assert t_i8._route(x, wq) == "mma"


def test_meta_tensor_raises_on_the_wgmma_f32_route():
    """Off the CPU the wrapper launches its kernel or raises, on this route
    too."""
    x = torch.empty((64, 320), device="meta", dtype=torch.float32)
    wq = torch.empty((320, 320), device="meta", dtype=torch.int8)
    assert t_i8._route(x, wq) == "wgmma_f32"
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_i8.int8_matmul(x, wq, torch.empty(320, device="meta"))


def test_wrapper_entry_and_count_of_the_route():
    """The route's C entry takes the wgmma kernel's arguments (a tile
    after M, N, K), and its launches have their own count."""
    assert t_i8._ENTRY["wgmma_f32"] == (
        "int8_matmul_wgmma_f32", "int8_matmul_wgmma_f32",
        t_i8._ENTRY["wgmma"][2])
    assert set(t_i8.int8_matmul.launches_by_kernel) == {"wgmma", "wgmma_f32",
                                                        "mma"}
    src = _src()
    assert re.search(r'extern "C" int int8_matmul_wgmma_f32\(const void\* x, '
                     r'const void\* wq, const void\* scale, void\* out,\s*'
                     r'int M, int N, int K, int bm, int bn, void\* stream\)',
                     src)


# --- the rounding of x ------------------------------------------------------

def _bf16_rne_bits(x):
    """cvt.rn.bf16x2.f32 on each f32 (not NaN): the top 16 bits of
    x + 0x7FFF + (bit 16 of x), round to nearest, ties to even; overflow
    past the largest bf16 goes to infinity."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _swizzle_chunk(r, j):
    """Where chunk j (16 bytes) of row r (128 bytes) of a 128-byte
    swizzled tile sits: chunk j ^ (r % 8)."""
    return j ^ (r & 7)


def _thread_part(ct, nc, bm):
    """The kernel's share of one K step's x for consumer thread ct of
    nc * 128: its chunk cj (columns 8 cj .. 8 cj + 7) and its rows
    xr0 + XSTEP p, p < BM / XSTEP, as the source computes them."""
    src = _src()
    xstep = nc * int(re.search(r"XSTEP = NC \* (\d+);", src).group(1))
    cl = ct & 15
    cro = (cl >> 2) & 1
    cj = (cl & 3) | ((cro ^ (cl >> 3)) << 2)
    xr0 = 2 * (ct >> 4) + cro
    assert bm % xstep == 0
    return cj, list(range(xr0, bm, xstep))


def _landed_boxes(x):
    """A K step of x (bm x 64 f32) as TMA lands it: two boxes of 32
    columns, 128-byte rows, 16-byte chunk j of row r at chunk j ^ (r % 8)."""
    bm = x.shape[0]
    boxes = np.zeros((2, bm, 32), np.float32)
    for b in range(2):
        for r in range(bm):
            for j in range(8):
                s = _swizzle_chunk(r, j)
                boxes[b, r, 4 * s:4 * s + 4] = x[r, 32 * b + 4 * j:][:4]
    return boxes


def _rounded_tile(x, nc):
    """The bf16 x tile of one K step as the consumers write it: each thread
    reads, for each of its rows, f32 chunks 2 (cj % 4) and 2 (cj % 4) + 1
    of box cj / 4 (two 16-byte loads), rounds the 8 values to four bf16
    pairs (the first value in the low half) and stores 16 bytes at chunk cj
    of the row, swizzled as the B descriptor reads it. Returns the tile's
    bf16 bits and every (thread, row, cj, [loaded chunks], stored chunk)."""
    bm = x.shape[0]
    boxes = _landed_boxes(x)
    tile = np.zeros((bm, 64), np.uint16)
    events = []
    for ct in range(nc * 128):
        cj, rows = _thread_part(ct, nc, bm)
        c0 = 2 * (cj & 3)
        for r in rows:
            loads = [_swizzle_chunk(r, c0), _swizzle_chunk(r, c0 + 1)]
            v = np.concatenate([boxes[cj >> 2, r, 4 * i:4 * i + 4]
                                for i in loads])
            dst = _swizzle_chunk(r, cj)
            tile[r, 8 * dst:8 * dst + 8] = _bf16_rne_bits(v)
            events.append((ct, r, cj, loads, dst))
    return tile, events


def _unswizzled(tile):
    """The bf16 tile as the wgmma descriptor reads it: element k of row r
    at chunk k // 8 swizzled by the row."""
    bm = tile.shape[0]
    out = np.zeros_like(tile)
    for r in range(bm):
        for j in range(8):
            s = _swizzle_chunk(r, j)
            out[r, 8 * j:8 * j + 8] = tile[r, 8 * s:8 * s + 8]
    return out


def _special_values(n, rng):
    """Ties to even at every position of the dropped half, subnormals,
    the largest finite values, +-inf, zeros of both signs, and normal
    values of every scale."""
    ties = (rng.integers(0, 2**31, n // 4, dtype=np.uint64) << 16 | 0x8000) \
        & 0xFFFFFFFF
    ties[: n // 16] |= 0x10000  # odd kept part: rounds up
    near = rng.integers(0, 2**32, n // 4, dtype=np.uint64)
    near = (near & 0xFFFF0000) | rng.choice(
        np.array([0x7FFF, 0x8001, 0x0001, 0xFFFF], np.uint64), n // 4)
    sub = rng.integers(1, 0x007FFFFF, n // 8, dtype=np.uint64) | (
        rng.integers(0, 2, n // 8, dtype=np.uint64) << 31)
    big = np.array([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF, 0x7F7F8000,
                    0x7F7F8001, 0x7F800000, 0xFF800000, 0x00000000,
                    0x80000000, 0x00008000, 0x00018000, 0x80018000],
                   np.uint64)
    finite = np.concatenate([ties, near])
    top = (finite >> 23) & 0xFF == 0xFF  # random exponents of inf / NaN
    finite[top] &= ~np.uint64(1 << 30)   # halved to finite ones
    bits = np.concatenate([finite, sub, big]).astype(np.uint32)
    normal = (rng.standard_normal(n - bits.size) * np.exp2(
        rng.integers(-100, 100, n - bits.size))).astype(np.float32)
    out = np.concatenate([bits.view(np.float32), normal])
    rng.shuffle(out)
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("bm,nc", [(64, 1), (128, 1), (256, 1), (64, 2),
                                   (128, 2), (256, 2)])
def test_consumers_round_x_to_bf16_bit_for_bit(bm, nc):
    """The consumers' bf16 tile, made from the f32 boxes as TMA lands them
    and read back through the B descriptor's swizzle, is x.to(torch.bfloat16)
    bit for bit: ties to even, subnormals,
    the largest finite values (which round to infinity), +-inf; every
    16-byte chunk written once, by one thread."""
    rng = np.random.default_rng(bm + nc)
    x = _special_values(bm * 64, rng).reshape(bm, 64)
    tile, events = _rounded_tile(x, nc)
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(_unswizzled(tile).view(np.int16), want)
    assert sorted((r, cj) for _, r, cj, _, _ in events) == [
        (r, j) for r in range(bm) for j in range(8)]


def test_bf16_rounding_model_is_torchs_on_every_tie_pattern():
    """The rounding model against torch for every value of the 16 dropped
    bits beside an even and an odd kept part, in normal and subnormal
    exponents and at the top of the range."""
    low = np.arange(1 << 16, dtype=np.uint32)
    highs = np.array([0x3F80, 0x3F81, 0x0000, 0x0001, 0x807F, 0x7F7F, 0xFF7E],
                     np.uint32)
    bits = (highs[:, None] << 16 | low[None, :]).reshape(-1)
    x = bits.view(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(_bf16_rne_bits(x).view(np.int16), want)


@pytest.mark.parametrize("bm,nc", [(64, 1), (128, 2), (256, 2)])
def test_rounding_is_free_of_bank_conflicts(bm, nc):
    """In each pass of each half warp over two rows, the 8 lanes of a
    quarter warp load 8 distinct 16-byte bank groups (even chunks of one
    row, odd of the other) in each of the two loads, and store to 8."""
    _, events = _rounded_tile(np.zeros((bm, 64), np.float32), nc)
    by_pass = {}
    for ct, r, cj, loads, dst in events:
        p = _thread_part(ct, nc, bm)[1].index(r)
        by_pass.setdefault((ct // 16, p), []).append((ct, r, cj, loads, dst))
    for lanes in by_pass.values():
        assert len(lanes) == 16
        rows = sorted({r for _, r, _, _, _ in lanes})
        assert len(rows) == 2 and rows[1] == rows[0] + 1
        for half in (0, 1):  # the half warp's two quarter warps
            quarter = [e for e in lanes if e[0] % 16 // 8 == half]
            for i in (0, 1):
                assert sorted(e[3][i] for e in quarter) == list(range(8))
            assert sorted(e[4] for e in quarter) == list(range(8))


# --- the f32 sum -----------------------------------------------------------

def _tensor_core_sum(x, q, bits=24, k=16):
    """x (M, K) bf16 values and q (N, K) int8 values as float64 -> the
    (M, N) f32 sums one tensor-core accumulator makes over all of K in
    wgmma k16 steps (NVIDIA's f32 accumulation as Fasi, Higham, Mikaitis
    and Pranesh measured it: the step's k exact products and the
    accumulator aligned to the largest of them, each truncated toward zero
    to `bits` significant bits of it, summed, and the sum truncated to
    `bits` bits)."""
    M, K = x.shape
    N = q.shape[0]
    acc = np.zeros((M, N))
    for s in range(0, K, k):
        p = x[:, None, s:s + k] * q[None, :, s:s + k]  # exact
        terms = np.concatenate([acc[..., None], p], axis=-1)
        top = np.abs(terms).max(axis=-1, keepdims=True)
        ulp = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0)))
                      - (bits - 1))
        total = (np.trunc(terms / ulp) * ulp).sum(axis=-1)
        mag = np.abs(total)
        ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
                      - (bits - 1))
        acc = np.trunc(total / ulp) * ulp
    return acc.astype(np.float32)


@pytest.mark.parametrize("bits", [24, 22])
@pytest.mark.parametrize("K", [3072, 5120])
def test_one_tensor_core_sum_over_k_holds_the_f32_limit(K, bits):
    """The kernel's arithmetic: x rounded to bf16, W widened exactly, one
    f32 tensor-core accumulator over all of K, times scale[n] in f32, no
    rounding after it. Against the plain version (x.to(bf16) @ W in f32,
    then the scale) within 1e-5 of the largest output at SD-1.5's longest
    K (3072: CLIP fc2; 5120: the 16x16 level's ff net.2), with the
    accumulator truncating at 24 bits (the published model) and, as a
    margin, at 22 (4x the error: what int8_matmul.cu, on the same tensor
    cores, measured at K = 5120 against its bound here, 3.6e-6)."""
    rng = np.random.default_rng(K + bits)
    M, N = 16, 64
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    scale = np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-12).astype(
        np.float32)
    q = np.clip(np.round(w / scale[:, None]), -127, 127)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    got = _tensor_core_sum(xb.astype(np.float64), q, bits) * scale
    want = t_i8.int8_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(q.astype(np.int8)),
        torch.from_numpy(scale)).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= F32_REL_TOL, rel
    exact = (xb.astype(np.float64) @ q.T) * scale
    assert np.abs(got - exact).max() / np.abs(exact).max() <= F32_REL_TOL


# --- the plain version -----------------------------------------------------

@pytest.mark.parametrize("mkn", [(33, 48, 40), (7, 64, 72), (100, 320, 320),
                                 (5, 13, 9), (77, 3072, 768),
                                 (4, 1280, 320)], ids=str)
def test_reference_matches_pallas_for_f32_x(mkn):
    """The plain version, which the kernel is held to on the card, against
    the Pallas _kernel in interpret mode, f32 x at ragged shapes (M, N and
    K tails, K % 16 != 0) and at CLIP fc2 and time_emb_proj: the same
    function, the f32 sums in another order."""
    M, K, N = mkn
    rng = np.random.default_rng(M * 7 + K)
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    q = j_q.quantize_params_int8({"lin.weight": jnp.asarray(w)})
    x = rng.standard_normal((M, K)).astype(np.float32)
    want = np.asarray(j_i8.int8_matmul(jnp.asarray(x), q["lin.weight"],
                                       q["lin.weight_scale"]))
    got = t_i8.int8_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(np.array(q["lin.weight"])),
        torch.from_numpy(np.array(q["lin.weight_scale"])))
    assert got.shape == (M, N) and got.dtype == torch.float32
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel <= F32_REL_TOL, rel


# --- instances and tiles ---------------------------------------------------

def _instances(macro):
    return [(int(a), int(b)) for a, b in re.findall(
        rf"^\s*{macro}\((\d+), (\d+)\)\s*$", _src(), re.M)]


def _ring(bm, bn):
    """The source's Tile<BM, BN> and Smem<BM, BN> evaluated in Python from
    its own rules: (stages, dynamic shared memory bytes)."""
    src = _src()
    bk, box = _const("BK"), _const("BOX")
    assert re.search(r"STAGE_BYTES = BM \* BK \* 4 \+ BM \* BK \* 2 \+ "
                     r"BN \* BK;", src)
    assert re.search(r"FIT = \(SMEM_MAX - 1024 - 256\) / STAGE_BYTES;", src)
    assert re.search(r"STAGES = FIT > 8 \? 8 : FIT;", src)
    assert 2 * box == bk  # two f32 boxes per K step
    stage = bm * bk * 4 + bm * bk * 2 + bn * bk
    stages = min(8, (SMEM_MAX - 1024 - 256) // stage)
    # the f32 boxes, bf16 tiles and W tiles, two barriers a stage, and the
    # alignment slack
    return stages, stages * stage + 2 * 8 * stages + 1024


def test_instances_are_the_tiles_of_both_models():
    """The entry's and the config's instance lists are TILES, the keys of
    the f32 time model; the bf16 kernel has the same instances."""
    tiles = set(t_i8.TILES)
    assert set(_instances("INT8_WGMMA_F32_CASE")) == tiles
    assert set(_instances("INT8_WGMMA_F32_CONFIG")) == tiles
    assert set(t_i8._TILE_US_F32) == tiles == set(t_i8._TILE_US)
    assert set(t_i8._TILE_MODELS) == {"wgmma", "wgmma_f32"}


@pytest.mark.parametrize("tile,stages", [
    ((64, 64), 8), ((128, 64), 4), ((256, 64), 2),
    ((64, 128), 7), ((128, 128), 4), ((256, 128), 2)], ids=str)
def test_each_instance_fits_shared_memory(tile, stages):
    """Each instance's ring (two f32 boxes, the bf16 tile and the int8 W
    tile a stage) within the H100's 232,448 bytes of a block's shared
    memory (227 KB), with at least two stages."""
    got, smem = _ring(*tile)
    assert got == stages >= 2
    assert smem <= SMEM_MAX


@pytest.mark.parametrize("mkn", SD15_INT8_SHAPES[::3] + [
    (16383, 320, 2560), (7, 64, 72), (33, 48, 40)], ids=str)
def test_f32_tile_is_the_least_modelled_instance(mkn):
    """The f32 route's tile is an instance of least modelled time under
    _TILE_US_F32 (whole waves on 132 SMs), which need not be the bf16
    route's."""
    M, K, N = mkn

    def us(tile):
        tiles = -(-M // tile[0]) * -(-N // tile[1])
        per_wave, per_step = t_i8._TILE_US_F32[tile]
        return -(-tiles // 132) * (per_wave + per_step * -(-K // 64))

    tile = t_i8._tile(M, K, N, 132, "wgmma_f32")
    assert tile in t_i8.TILES
    assert all(us(tile) <= us(t) for t in t_i8.TILES)


@pytest.mark.parametrize("mkn, tile", [
    ((1024, 5120, 1280), (128, 128)),  # the 16x16 level's ff net.2
    ((4, 1280, 1280), (64, 64)),       # time_emb_proj: 64 rows of x
    ((77, 3072, 768), (64, 64)),       # CLIP fc2: 12 tiles walk K alone
], ids=str)
def test_f32_tile_picks_as_measured(mkn, tile):
    """The f32 model's picks where one instance measured clearly fastest
    (chip_smoke.py --int8-tiles on an H100)."""
    assert t_i8._tile(*mkn, 132, "wgmma_f32") == tile
