"""The port's attention against lora_tpu's: the flash kernel's plain PyTorch
version against the Pallas forward (interpret mode on the CPU), the plain
attention path against the XLA path, the routing rule, and the wrapper's
no-fallback rule for CUDA tensors (the CUDA kernel itself runs only on the
card: chip_smoke.py compares it with the plain version there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.ops import attention as j_att  # noqa: E402
from lora_tpu.ops import flash_attention as j_fa  # noqa: E402
from lora_tpu_torch.ops import attention as t_att  # noqa: E402
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


def test_cpu_wrapper_runs_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 300, 77, 64, seed=2))
    before = t_fa.flash_attention.launches
    o, lse = t_fa.flash_attention(q, k, v, 0.125)
    o_ref, lse_ref = t_fa.flash_attention_reference(q, k, v, 0.125)
    assert t_fa.flash_attention.launches == before
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=0)
    assert o.shape == (1, 2, 300, 64) and lse.shape == (1, 2, 300)
    assert lse.dtype == torch.float32


def test_non_cpu_tensors_never_fall_back():
    """Off the CPU the wrapper launches its kernel or raises: a tensor that
    requires grad raises (no backward kernel yet), and a device that is not
    CUDA raises instead of taking the plain version."""
    q = torch.empty((1, 2, 256, 64), device="meta", requires_grad=True)
    k = torch.empty((1, 2, 256, 64), device="meta")
    with pytest.raises(NotImplementedError, match="Queue B items 2-3"):
        t_fa.flash_attention(q, k, k, 0.125)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_fa.flash_attention(q.detach(), k, k, 0.125)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(t_fa, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_fa, "_lib", None)
    monkeypatch.setattr(t_fa, "_find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        t_fa._load()


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(t_fa, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_fa, "_find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        t_fa.build()
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())

