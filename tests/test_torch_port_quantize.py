"""The port's int8 path against lora_tpu's: quantization bit for bit, the
int8 kernel's plain PyTorch version against the Pallas int8_matmul
(interpret mode on the CPU), the wrapper's no-fallback rule, JAX-quantized
params loading into a quantized port UNet, and the tiny quantized UNet
against JAX's kernel route and its dequantize-then-matmul route. The CUDA
kernel itself runs only on the card: chip_smoke.py compares it with its
plain version there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import quantize as j_q  # noqa: E402
from lora_tpu.models.config import TINY_TEXT, TINY_UNET, TINY_VAE  # noqa: E402
from lora_tpu.models.unet import unet_forward as j_unet  # noqa: E402
from lora_tpu.ops import int8_matmul as j_i8  # noqa: E402
from lora_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from lora_tpu_torch.core import quantize as t_q  # noqa: E402
from lora_tpu_torch.core.lora import init_lora  # noqa: E402
from lora_tpu_torch.core.sites import unet_lora_sites  # noqa: E402
from lora_tpu_torch.models.unet import UNet, unet_forward as t_unet  # noqa: E402
from lora_tpu_torch.ops import int8_matmul as t_i8  # noqa: E402
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

# int8_matmul_reference vs the Pallas kernel: both round x to bf16 and sum
# exact bf16 x int8 products in f32, in another order. f32 outputs: the
# order of K <= 1280 f32 sums, 1e-5. bf16 outputs: the f32 results differ
# by that much, so after the one rounding to bf16 they agree or sit on the
# two sides of a rounding boundary: one bf16 ulp of the expected value, plus
# the same 1e-5 absolute for sums that cancel to near zero (there the f32
# order alone moves the result by more than its own ulp).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# the tiny quantized UNet, f32, port vs the JAX Pallas route. Every int8
# dense rounds its input to bf16 in both, so a 1e-7 difference upstream
# flips some activations' bf16 rounding (2^-8 relative) in later layers: the
# JAX route itself moves by 5e-4 - 8e-4 (max) and 1.2e-4 - 1.8e-4 (mean) of
# max|out| when its input is perturbed by 1e-7 relative (measured on the
# CPU, three seeds). The UNet is held at about that floor; each dense alone
# is held at F32_TOL (test_quantized_dense_matches_jax_kernel_route).
UNET_KERNEL_MAX_REL, UNET_KERNEL_MEAN_REL = 2e-3, 3e-4


def _np_weights(rng, dtype=np.float32):
    w = {
        "blk.attn1.to_q.weight": rng.standard_normal((24, 16)) * 0.2,
        "blk.ff.net.2.weight": rng.standard_normal((16, 40)),
        "blk.ff.net.2.bias": rng.standard_normal(16),
        "blk.conv1.weight": rng.standard_normal((8, 4, 3, 3)) * 0.1,
        "blk.conv_shortcut.weight": rng.standard_normal((8, 4, 1, 1)),
        "blk.norm1.weight": rng.standard_normal(8),
        "blk.norm1.bias": rng.standard_normal(8),
        "text_model.embeddings.token_embedding.weight":
            rng.standard_normal((50, 16)),
        "text_model.embeddings.position_embedding.weight":
            rng.standard_normal((7, 16)),
        "time_embedding.linear_1.weight": rng.standard_normal((32, 16)),
    }
    w["blk.attn1.to_q.weight"][3] = 0.0  # an all-zero channel: the 1e-12 floor
    # exact halves of the scale: round half to even
    w["blk.ff.net.2.weight"][0, :5] = np.array([127, 0.5, 1.5, 2.5, -3.5])
    return {k: v.astype(dtype) for k, v in w.items()}


def _to_t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_bit_for_bit(dtype):
    w = _np_weights(np.random.default_rng(0))
    jw = {k: jnp.asarray(v, dtype) for k, v in w.items()}
    tw = {k: _to_t(v).to(getattr(torch, dtype)) for k, v in w.items()}
    jq, tq = j_q.quantize_params_int8(jw), t_q.quantize_params_int8(tw)
    assert set(jq) == set(tq)
    assert {k for k in tq if tq[k].dtype == torch.int8} == {
        "blk.attn1.to_q.weight", "blk.ff.net.2.weight", "blk.conv1.weight",
        "blk.conv_shortcut.weight"}
    for k in jq:
        a = np.asarray(jq[k].astype(jnp.float32))
        b = tq[k].float().numpy()
        assert str(tq[k].dtype).replace("torch.", "") == jq[k].dtype.name, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert tq["blk.attn1.to_q.weight_scale"][3].item() == np.float32(1e-12)
    assert tq["blk.ff.net.2.weight"][0, :5].tolist() == [127, 0, 2, 2, -4]


@pytest.fixture(scope="module")
def unet_params():
    """Tiny UNet params as numpy (the port's random init) and JAX's
    quantization of them (eager, as quantize_base runs it)."""
    unet = UNet(TINY_UNET, device="cpu",
                generator=torch.Generator().manual_seed(0))
    params = {k: v.numpy() for k, v in unet.state_dict().items()}
    jq = j_q.quantize_params_int8({k: jnp.asarray(v)
                                   for k, v in params.items()})
    return params, jq


def test_quantize_tiny_unet_matches_jax(unet_params):
    params, jq = unet_params
    tq = t_q.quantize_params_int8({k: _to_t(v) for k, v in params.items()})
    assert set(jq) == set(tq)
    for k in jq:
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]),
                                      err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_jax(dtype):
    w = _np_weights(np.random.default_rng(1))
    jq = j_q.quantize_params_int8({k: jnp.asarray(v) for k, v in w.items()})
    tq = t_q.quantize_params_int8({k: _to_t(v) for k, v in w.items()})
    for k in ("blk.attn1.to_q.weight", "blk.conv1.weight",
              "blk.norm1.weight"):
        a = j_q.dequantize_weight(jq, k, getattr(jnp, dtype))
        b = t_q.dequantize_weight(tq, k, getattr(torch, dtype))
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a.astype(jnp.float32)))


def _assert_within_bf16_ulp(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    bad = np.abs(got - want) > ulp + F32_TOL["atol"]
    assert not bad.any(), (got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", [(100, 320, 320), (256, 512, 1280),
                                 (7, 77, 64), (33, 48, 40)])
def test_reference_matches_pallas(mnk, xdt):
    """(M, N, K) of tests/test_quantize.py plus K % 16 != 0, with a leading
    batch dimension, x in f32 and bf16."""
    M, N, K = mnk
    rng = np.random.default_rng(M + K)
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    q = j_q.quantize_params_int8({"lin.weight": jnp.asarray(w)})
    x = rng.standard_normal((2, M, K)).astype(np.float32)
    jx = jnp.asarray(x, xdt)
    want = j_i8.int8_matmul(jx, q["lin.weight"], q["lin.weight_scale"])
    tx = _to_t(x).to(getattr(torch, xdt))
    got = t_i8.int8_matmul_reference(tx, _to_t(q["lin.weight"]),
                                     _to_t(q["lin.weight_scale"]))
    assert got.shape == (2, M, N) and got.dtype == tx.dtype
    want = np.asarray(want.astype(jnp.float32))
    if xdt == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        _assert_within_bf16_ulp(got.float().numpy(), want)


def test_cpu_wrapper_runs_the_plain_version():
    x = torch.randn(3, 5, 16)
    wq = torch.randint(-127, 128, (8, 16), dtype=torch.int8)
    s = torch.rand(8)
    before = t_i8.int8_matmul.launches
    out = t_i8.int8_matmul(x, wq, s)
    assert t_i8.int8_matmul.launches == before
    torch.testing.assert_close(out, t_i8.int8_matmul_reference(x, wq, s),
                               rtol=0, atol=0)


def test_non_cpu_tensors_never_fall_back():
    """Off the CPU the wrapper launches its kernel or raises: a device that
    is not CUDA raises instead of taking the plain version."""
    x = torch.empty((4, 16), device="meta")
    wq = torch.empty((8, 16), device="meta", dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_i8.int8_matmul(x, wq, torch.empty(8, device="meta"))


def _sd15_int8_shapes():
    """(M, K, N) of every int8 call of SD-1.5 quantized serving at 512px:
    the UNet at device batch 2, 4 and 8 (warmup, request A and request B of
    chip_smoke.py, CFG rows), CLIP on 1, 2 and 4 prompts, the VAE decoder's
    attention on 1, 2 and 4 latents."""
    shapes = set()
    for b in (2, 4, 8):
        hw = 64 * 64 * b
        for m, c in ((hw, 320), (hw // 4, 640), (hw // 16, 1280),
                     (hw // 64, 1280)):
            shapes |= {(m, c, c), (m, c, 8 * c), (m, 4 * c, c)}
        for c in (320, 640, 1280):
            shapes |= {(77 * b, 768, c), (b, 1280, c)}
    for n in (1, 2, 4):
        m = 77 * n
        shapes |= {(m, 768, 768), (m, 768, 3072), (m, 3072, 768),
                   (4096 * n, 512, 512)}
    return sorted(shapes)


SD15_INT8_SHAPES = _sd15_int8_shapes()


def _x(M, K, dtype=torch.bfloat16):
    """An (M, K) x on a fresh (64-byte aligned) base, without M * K
    storage: _route reads only dtype, shape and the base pointer."""
    return torch.zeros((1, 1), dtype=dtype).expand(M, K)


def _wq(N, K):
    return torch.zeros((1, 1), dtype=torch.int8).expand(N, K)


@pytest.mark.parametrize("mkn", SD15_INT8_SHAPES, ids=str)
def test_route_sends_every_sd15_serving_shape_to_wgmma(mkn):
    M, K, N = mkn
    assert t_i8._route(_x(M, K), _wq(N, K)) == "wgmma"


@pytest.mark.parametrize("case", ["f32", "k_not_16", "n_not_8",
                                  "x_misaligned", "w_misaligned"])
def test_route_sends_the_rest_to_mma(case):
    """What TMA cannot load: 16-byte row strides, N % 8 and bases that are
    not 16-byte aligned. Aligned f32 x goes to the f32 wgmma kernel."""
    M, K, N = 100, 320, 320
    x, wq = _x(M, K), _wq(N, K)
    if case == "f32":
        x = _x(M, K, torch.float32)
    elif case == "k_not_16":
        x, wq = _x(M, 40), _wq(N, 40)
    elif case == "n_not_8":
        wq = _wq(77, K)
    elif case == "x_misaligned":
        x = torch.zeros(M * K + 8, dtype=torch.bfloat16)[1:M * K + 1]
        x = x.view(M, K)
    else:
        wq = torch.zeros(N * K + 16, dtype=torch.int8)[1:N * K + 1]
        wq = wq.view(N, K)
    assert t_i8._route(x, wq) == ("wgmma_f32" if case == "f32" else "mma")


@pytest.mark.parametrize("mkn", SD15_INT8_SHAPES + [
    (16383, 320, 2560), (7, 64, 72), (100, 320, 320), (33, 48, 40)], ids=str)
@pytest.mark.parametrize("sms", [132, 114])
def test_tile_is_a_box_instance_of_least_modelled_time(mkn, sms):
    """A tile TMA's boxes allow (at most 256 rows, rows of x a multiple of
    16 for wgmma's n, 64 W rows per consumer warpgroup), and none of the
    instances is modelled faster: whole waves of tiles on `sms` SMs, each
    costing its per-wave time plus its time per K step of 64."""
    M, K, N = mkn

    def us(tile):
        tiles = -(-M // tile[0]) * -(-N // tile[1])
        per_wave, per_step = t_i8._TILE_US[tile]
        return -(-tiles // sms) * (per_wave + per_step * -(-K // 64))

    bm, bn = t_i8._tile(M, K, N, sms)
    assert (bm, bn) in t_i8.TILES and set(t_i8._TILE_US) == set(t_i8.TILES)
    assert bm <= 256 and bm % 16 == 0 and bn in (64, 128)
    assert all(us((bm, bn)) <= us(t) for t in t_i8.TILES)


@pytest.mark.parametrize("mkn, tile", [
    ((16384, 320, 2560), (256, 128)),  # 1,280 tiles: the largest tile
    ((4, 1280, 1280), (64, 64)),       # time_emb_proj: 64 rows of x
    ((77, 3072, 768), (64, 64)),       # CLIP fc2: 12 tiles walk K alone
    # 80 tiles of 256 x 64 on 132 SMs beat 320 of 64 x 64 in 3 waves
    ((1024, 5120, 1280), (256, 64)),
], ids=str)
def test_tile_picks_as_measured(mkn, tile):
    assert t_i8._tile(*mkn) == tile


def test_meta_tensor_raises_on_the_wgmma_route():
    x = torch.empty((64, 320), device="meta", dtype=torch.bfloat16)
    wq = torch.empty((320, 320), device="meta", dtype=torch.int8)
    assert t_i8._route(x, wq) == "wgmma"
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_i8.int8_matmul(x, wq, torch.empty(320, device="meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_counts_no_launch_in_either_kernel(dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 64, 320), generator=gen).to(dtype)
    wq = torch.randint(-127, 128, (320, 320), generator=gen,
                       dtype=torch.int8)
    s = torch.rand(320, generator=gen)
    before = (t_i8.int8_matmul.launches,
              dict(t_i8.int8_matmul.launches_by_kernel))
    out = t_i8.int8_matmul(x, wq, s)
    assert (t_i8.int8_matmul.launches,
            t_i8.int8_matmul.launches_by_kernel) == before
    assert set(before[1]) == {"wgmma", "wgmma_f32", "mma"}
    assert before[0] == sum(before[1].values())
    torch.testing.assert_close(out, t_i8.int8_matmul_reference(x, wq, s),
                               rtol=0, atol=0)


def test_int8_widening_bit_trick_is_exact():
    """int8_matmul_wgmma.cu widens int8 to bf16 without the int-to-float
    converter: u = q ^ 0x80 in the low byte of the f32 2^23 (0x4B000000),
    minus 2^23 + 128 in f32, then the top 16 bits of the f32 as the bf16.
    The same arithmetic in numpy, for every int8, gives exactly bf16(q)."""
    q = np.arange(-128, 128, dtype=np.int32)
    u = (q.astype(np.uint32) ^ 0x80) & 0xFF
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(f, q.astype(np.float32))
    top = (f.view(np.uint32) >> 16).astype(np.uint16)
    want = torch.from_numpy(q).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(top.view(np.int16), want)


def _tiny_pipe(dtype=torch.float32):
    return StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", dtype=dtype,
        unet_cfg=TINY_UNET, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)


def test_jax_quantized_params_load_into_quantized_unet(unet_params):
    jq = unet_params[1]
    sd = state_dict_from_jax({k: np.asarray(v) for k, v in jq.items()},
                             dtype=torch.bfloat16)
    pipe = _tiny_pipe(torch.bfloat16)
    pipe.quantize_base()
    pipe.unet.load_state_dict(sd, strict=True)
    for k, v in pipe.unet.state_dict().items():
        if np.asarray(jq[k]).dtype == np.int8:
            assert v.dtype == torch.int8
            np.testing.assert_array_equal(v.numpy(), np.asarray(jq[k]))
        elif k.endswith("_scale"):
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), np.asarray(jq[k]))
        else:
            assert v.dtype == torch.bfloat16, k


def _jax_unet(jq, x, t, ctx):
    """The JAX UNet under a fresh jit (a new function object, so the traces
    of the kernel route and the dequantize route never share a cache)."""
    fn = jax.jit(lambda p, x, t, c: j_unet(p, x, t, c, TINY_UNET))
    return np.asarray(fn(jq, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))


def _unet_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal(
        (2, 7, TINY_UNET.cross_attention_dim)).astype(np.float32)
    return x, np.array([500, 20]), ctx


def _kernel_route(monkeypatch):
    """JAX routes every 2-D int8 dense through its Pallas kernel (interpret
    mode on the CPU), as the port routes every one through int8_matmul."""
    monkeypatch.setattr(j_i8, "supported", lambda x, wq: wq.ndim == 2)


def test_quantized_dense_matches_jax_kernel_route(monkeypatch,
                                                  unet_params):
    """A 2-D int8 dense of each distinct (shape, bias) of the tiny quantized
    UNet, the port's layers.dense against JAX's on the same input: tight."""
    from lora_tpu.models import layers as j_layers
    from lora_tpu_torch.models import layers as t_layers

    _kernel_route(monkeypatch)
    jq = unet_params[1]
    tp = state_dict_from_jax({k: np.asarray(v) for k, v in jq.items()})
    by_shape = {}
    for k, v in sorted(jq.items()):
        if k.endswith(".weight") and v.dtype == jnp.int8 and v.ndim == 2:
            name = k[:-len(".weight")]
            by_shape.setdefault((v.shape, name + ".bias" in jq), name)
    names = list(by_shape.values())
    assert len(names) >= 8
    rng = np.random.default_rng(5)
    for name in names:
        x = rng.standard_normal((2, 5, jq[name + ".weight"].shape[1])
                                ).astype(np.float32)
        want = np.asarray(j_layers.dense(jq, name, jnp.asarray(x)))
        got = t_layers.dense(tp, name, _to_t(x)).numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **F32_TOL)


def test_quantized_unet_matches_jax_kernel_route(monkeypatch, unet_params):
    """The port is as close to the JAX kernel route as that route is to
    itself when its input moves by 1e-7 relative (the floor that the bf16
    rounding of every dense input sets), and within the fixed bounds."""
    _kernel_route(monkeypatch)
    jq = unet_params[1]
    x, t, ctx = _unet_inputs()
    ref = _jax_unet(jq, x, t, ctx)
    nudged = _jax_unet(jq, x * np.float32(1 + 1e-7), t, ctx)
    tp = state_dict_from_jax({k: np.asarray(v) for k, v in jq.items()})
    out = t_unet(tp, _to_t(x), _to_t(t), _to_t(ctx), TINY_UNET).numpy()
    rel = np.abs(out - ref) / np.abs(ref).max()
    assert rel.max() < UNET_KERNEL_MAX_REL and rel.mean() < UNET_KERNEL_MEAN_REL
    floor = np.linalg.norm(nudged - ref) / np.linalg.norm(ref)
    assert 0 < floor and np.linalg.norm(out - ref) / np.linalg.norm(ref) \
        < 2 * floor


def test_quantized_unet_close_to_jax_dequant_route_and_lora_applies(
        unet_params):
    """Against the JAX CPU route (dequantize, then an f32 matmul, no bf16
    rounding of x) within tests/test_quantize.py's bounds; a LoRA on the
    quantized UNet still moves the output."""
    jq = unet_params[1]
    x, t, ctx = _unet_inputs()
    ref = _jax_unet(jq, x, t, ctx)
    tp = state_dict_from_jax({k: np.asarray(v) for k, v in jq.items()})
    args = (_to_t(x), _to_t(t), _to_t(ctx), TINY_UNET)
    q8 = t_unet(tp, *args).numpy()
    denom = np.abs(ref).max()
    assert np.abs(q8 - ref).max() / denom < 0.15
    assert np.abs(q8 - ref).mean() / denom < 0.02

    gen = torch.Generator().manual_seed(4)
    lora = init_lora(unet_lora_sites(TINY_UNET), r=2, generator=gen,
                     device="cpu")
    for e in lora["sites"].values():
        e["up"] = 0.05 * torch.randn(e["up"].shape, generator=gen)
    with_lora = t_unet(tp, *args, lora=lora).numpy()
    assert np.abs(with_lora - q8).max() > 1e-4


def test_memory_halves():
    unet = UNet(TINY_UNET, device="cpu", dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0))
    params = unet.flat_params()
    q = t_q.quantize_params_int8(params)

    def nbytes(d):
        return sum(v.numel() * v.element_size() for v in d.values())

    assert nbytes(q) < 0.7 * nbytes(params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipe_dtype_survives_quantize_base(dtype, tmp_path):
    """The compute dtype is stored, not read from a weight that
    quantization turns int8: latents and a LoRA patched after
    quantize_base() come in the pipeline's dtype."""
    from lora_tpu_torch.core.lora import lora_to_pairs
    from lora_tpu_torch.formats.safetensors_io import (
        UNET_DEFAULT_TARGET_REPLACE,
        save_safeloras_with_embeds,
    )

    pipe = _tiny_pipe(dtype)
    pipe.quantize_base()
    assert pipe.unet.get_parameter("conv_in.weight").dtype == torch.int8
    assert pipe.dtype == dtype and pipe.device == torch.device("cpu")
    lat = pipe.prepare_latents(1, 64, 64, torch.Generator().manual_seed(0))
    assert lat.dtype == dtype
    sites = pipe.unet_sites()
    lora = init_lora(sites, r=2, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    path = str(tmp_path / "lora.safetensors")
    save_safeloras_with_embeds(
        {"unet": (lora_to_pairs(lora, sites), UNET_DEFAULT_TARGET_REPLACE)},
        {}, path)
    gen0 = pipe.adapter_generation
    pipe.patch_pipe(path)
    assert pipe.adapter_generation == gen0 + 1
    assert {e["up"].dtype for e in pipe.lora_unet["sites"].values()} == {dtype}
    img = pipe("x", num_inference_steps=1, height=64, width=64, latents=lat)
    assert img.shape == (1, 64, 64, 3) and np.isfinite(img).all()
