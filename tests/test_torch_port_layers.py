"""The port's primitive layers and LoRA bypass against lora_tpu's: dense and
conv2d with a rank-4 LoRA (plain, diag selector, full-rank delta, stacked
adapters routed by idx), group_norm, layer_norm and timestep_embedding, in
float32 from the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.models import layers as j_layers  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax, to_torch  # noqa: E402
from lora_tpu_torch.models import layers as t_layers  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

ATOL = 1e-5
KINDS = ["plain", "diag", "delta", "stacked"]


def _lora(kind, rng, name, out_dim, in_dim, kernel=None, n_adapters=3,
          batch=2):
    """A JAX LoRA tree (numpy leaves) with one site of the given kind."""
    r = 4
    k = () if kernel is None else kernel
    up_tail = () if kernel is None else (1, 1)
    scale = np.float32(0.7)
    if kind == "delta":
        entry = {"delta": rng.standard_normal((out_dim, in_dim) + k)
                 .astype(np.float32) * 0.1}
    elif kind == "stacked":
        entry = {"up": rng.standard_normal((n_adapters, out_dim, r) + up_tail)
                 .astype(np.float32),
                 "down": rng.standard_normal((n_adapters, r, in_dim) + k)
                 .astype(np.float32)}
        scale = np.array([0.5, 1.0, 1.5], np.float32)
    else:
        entry = {"up": rng.standard_normal((out_dim, r) + up_tail)
                 .astype(np.float32),
                 "down": rng.standard_normal((r, in_dim) + k)
                 .astype(np.float32)}
        if kind == "diag":
            entry["diag"] = np.array([1.0, 0.0, 2.0, -1.0], np.float32)
    tree = {"sites": {name: entry}, "scale": scale}
    if kind == "stacked":
        tree["idx"] = np.array([2, 0], np.int32)[:batch]
    return tree


def _jax_tree(tree):
    out = {"sites": {n: {k: jnp.asarray(v) for k, v in e.items()}
                     for n, e in tree["sites"].items()},
           "scale": jnp.asarray(tree["scale"])}
    if "idx" in tree:
        out["idx"] = jnp.asarray(tree["idx"])
    return out


def _params(rng, name, shape, bias=True):
    p = {name + ".weight": rng.standard_normal(shape).astype(np.float32)}
    if bias:
        p[name + ".bias"] = rng.standard_normal(shape[0]).astype(np.float32)
    return p


@pytest.mark.parametrize("kind", KINDS)
def test_dense_with_lora(kind):
    rng = np.random.default_rng(0)
    p = _params(rng, "blk.proj", (24, 16))
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    tree = _lora(kind, rng, "blk.proj", 24, 16)
    ref = j_layers.dense({k: jnp.asarray(v) for k, v in p.items()},
                         "blk.proj", jnp.asarray(x), _jax_tree(tree))
    out = t_layers.dense({k: to_torch(v) for k, v in p.items()}, "blk.proj",
                         torch.from_numpy(x), lora_from_jax(tree))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("stride,padding", [((1, 1), (1, 1)),
                                            ((2, 2), (1, 1))])
def test_conv2d_with_lora(kind, stride, padding):
    rng = np.random.default_rng(1)
    p = _params(rng, "res.conv1", (12, 8, 3, 3))
    x = rng.standard_normal((2, 9, 9, 8)).astype(np.float32)  # NHWC
    tree = _lora(kind, rng, "res.conv1", 12, 8, kernel=(3, 3))
    ref = j_layers.conv2d({k: jnp.asarray(v) for k, v in p.items()},
                          "res.conv1", jnp.asarray(x), stride, padding,
                          _jax_tree(tree))
    out = t_layers.conv2d({k: to_torch(v) for k, v in p.items()},
                          "res.conv1", torch.from_numpy(x).permute(0, 3, 1, 2),
                          stride, padding, lora_from_jax(tree))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=ATOL)


def test_dense_without_lora_site_is_plain():
    rng = np.random.default_rng(2)
    p = _params(rng, "a", (6, 4))
    x = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    tree = lora_from_jax(_lora("plain", rng, "other", 6, 4))
    tp = {k: to_torch(v) for k, v in p.items()}
    torch.testing.assert_close(t_layers.dense(tp, "a", x, tree),
                               t_layers.dense(tp, "a", x), rtol=0, atol=0)


def test_int8_base_weight_raises():
    """An int8 dense weight needs its per-channel scale, and off the CPU it
    launches the int8 kernel or raises (no silent plain path); with the
    scale, on the CPU, it runs the kernel's plain version."""
    p = {"a.weight": torch.zeros((4, 4), dtype=torch.int8)}
    with pytest.raises(KeyError, match="a.weight_scale"):
        t_layers.dense(p, "a", torch.zeros((1, 4)))
    p["a.weight_scale"] = torch.ones(4)
    assert torch.equal(t_layers.dense(p, "a", torch.ones((1, 4))),
                       torch.zeros((1, 4)))
    meta = {k: v.to("meta") for k, v in p.items()}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_layers.dense(meta, "a", torch.zeros((1, 4), device="meta"))


@pytest.mark.parametrize("groups,channels", [(8, 32), (32, 64)])
def test_group_norm(groups, channels):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 6, 5, channels)) * 3 + 1).astype(np.float32)
    p = {"n.weight": rng.standard_normal(channels).astype(np.float32),
         "n.bias": rng.standard_normal(channels).astype(np.float32)}
    ref = j_layers.group_norm({k: jnp.asarray(v) for k, v in p.items()}, "n",
                              jnp.asarray(x), groups, 1e-5)
    out = t_layers.group_norm({k: to_torch(v) for k, v in p.items()}, "n",
                              torch.from_numpy(x).permute(0, 3, 1, 2),
                              groups, 1e-5)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=ATOL)


def test_layer_norm():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 7, 48)) * 2 - 1).astype(np.float32)
    p = {"n.weight": rng.standard_normal(48).astype(np.float32),
         "n.bias": rng.standard_normal(48).astype(np.float32)}
    ref = j_layers.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, "n",
                              jnp.asarray(x), 1e-5)
    out = t_layers.layer_norm({k: to_torch(v) for k, v in p.items()}, "n",
                              torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=ATOL)


@pytest.mark.parametrize("dim,flip,shift", [(32, True, 0.0), (33, False, 1.0),
                                            (320, True, 0.0)])
@pytest.mark.parametrize("ts,atol", [
    ((0, 1, 10, 50), ATOL),
    # XLA's and torch's f32 exp differ by an ulp on some frequencies; the
    # argument t * f then moves by t * 2^-23, up to 1.2e-4 at t = 999
    ((1, 10, 500, 999), 2 * 999 * 2.0**-23),
])
def test_timestep_embedding(dim, flip, shift, ts, atol):
    t = np.array(ts, np.int32)
    ref = j_layers.timestep_embedding(jnp.asarray(t), dim,
                                      flip_sin_to_cos=flip, freq_shift=shift)
    out = t_layers.timestep_embedding(torch.from_numpy(t).long(), dim,
                                      flip_sin_to_cos=flip, freq_shift=shift)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


def test_activations_and_upsample():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)  # NHWC
    xt = torch.from_numpy(x)
    for j_fn, t_fn in ((j_layers.silu, t_layers.silu),
                       (j_layers.gelu, t_layers.gelu),
                       (j_layers.quick_gelu, t_layers.quick_gelu)):
        np.testing.assert_allclose(t_fn(xt).numpy(),
                                   np.asarray(j_fn(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    up = t_layers.upsample_nearest_2x(xt.permute(0, 3, 1, 2))
    np.testing.assert_array_equal(
        up.permute(0, 2, 3, 1).numpy(),
        np.asarray(j_layers.upsample_nearest_2x(jnp.asarray(x))))


def test_convert_keeps_bfloat16_bits():
    """bf16 JAX leaves (np.asarray gives ml_dtypes' bfloat16) cross with
    their bits unchanged."""
    a = jnp.asarray(np.random.default_rng(6).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = to_torch(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))
