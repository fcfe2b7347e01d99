"""The port's low-memory Adams (make_optimizer(low_memory="int8" | "bf16"))
against lora_tpu's with its default fused=True (each group's update on its
raveled vector, jitted as the JAX train step runs it), and the plain
version of the blockwise-int8 update kernel (ops/adam8bit.py) against
lora_tpu's _quantize / _dequantize. Float32 on the CPU; the trees put leaf
boundaries inside 256-element blocks, groups whose length is not a multiple
of 256, a group of one element, a group whose gradients are all zero, the
"ti" group (no weight decay), an active clip and grad_accum=2."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from lora_tpu.training import optim as j_optim  # noqa: E402
from lora_tpu_torch.convert import (  # noqa: E402
    trainable_from_jax,
    trainable_to_numpy,
)
from lora_tpu_torch.ops import adam8bit  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

UPDATES = 5
# params: the same f32 arithmetic up to XLA's contraction of a product
# into a sum (an FMA) where the port rounds twice; an element then moves
# by an ulp of its update, far below 1e-6 of its value
PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-7
# int8 codes: a moment within an ulp of a rounding boundary may land on
# the other code
CODE_DIFF_SHARE = 1e-3


def _shapes(case):
    """{group: {leaf path: shape}} of each case (nested dicts; lora groups
    carry their scale leaf, as trainable trees do)."""
    unet = {"scale": (), "sites": {"a": {"down": (2, 150), "up": (70, 2)},
                                   "b": {"down": (3, 40), "up": (9, 3)}}}
    tree = {"lora_unet": unet, "ti": {"embeds": (3, 100)}}
    if case == "zero_group":
        tree["lora_text"] = {"scale": (), "sites": {"q": {"down": (1, 128),
                                                          "up": (128, 1)}}}
    if case == "single_element":
        tree["ti"] = {"embeds": (1, 1)}
    return tree


CASES = {
    # name: (make_optimizer kwargs, gradient multiplier)
    "blocks_across_leaves": ({"max_grad_norm": 1.0}, 0.01),
    "zero_group": ({"max_grad_norm": 1.0}, 0.01),
    "single_element": ({"max_grad_norm": 1.0}, 0.01),
    "clip_accum": ({"max_grad_norm": 1.0, "grad_accum": 2}, 30.0),
}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, tuple):
        return (scale * rng.standard_normal(shapes)).astype(np.float32)
    return {k: _tree(v, rng, scale) for k, v in shapes.items()}


def _set_grads(t_tree, g_tree):
    if isinstance(t_tree, torch.Tensor):
        t_tree.grad = torch.from_numpy(np.array(g_tree))
        return
    for k in t_tree:
        _set_grads(t_tree[k], g_tree[k])


def _inner(state, accum):
    """{group: the first state of its chain (scale_by_adam / _8bit)}."""
    if accum:
        state = state.inner_opt_state
    return {k: v[0] for k, v in state.items()}


def _run(mode, case):
    kw, mult = CASES[case]
    shapes = _shapes(case)
    rng = np.random.default_rng(0)
    tree = _tree(shapes, rng)
    micro = UPDATES * kw.get("grad_accum", 1)
    grads = [_tree(shapes, rng, mult) for _ in range(micro)]
    if case == "zero_group":
        for g in grads:
            g["lora_text"] = jax.tree_util.tree_map(np.zeros_like,
                                                    g["lora_text"])
    lrs = {"lora_unet": 1e-3, "ti": 5e-3, "lora_text": 2e-3}
    lrs = {k: v for k, v in lrs.items() if k in tree}

    j_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    j_opt = j_optim.make_optimizer(j_tree, lrs, low_memory=mode, **kw)
    state = j_opt.init(j_tree)
    update = jax.jit(j_opt.update)
    for g in grads:
        u, state = update(jax.tree_util.tree_map(jnp.asarray, g), state,
                          j_tree)
        j_tree = optax.apply_updates(j_tree, u)

    t_tree = trainable_from_jax(tree)
    t_opt = t_optim.make_optimizer(t_tree, lrs, low_memory=mode, **kw)
    for g in grads:
        _set_grads(t_tree, g)
        t_opt.step()
    assert t_opt.count == UPDATES
    return tree, j_tree, _inner(state, "grad_accum" in kw), t_tree, t_opt


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_low_memory_optimizer_matches_jax(mode, case):
    tree, j_tree, j_state, t_tree, t_opt = _run(mode, case)
    got = dict(jax.tree_util.tree_leaves_with_path(
        trainable_to_numpy(t_tree)))
    moved = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(j_tree):
        np.testing.assert_allclose(got[path], np.asarray(want),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{mode} {case} "
                                   f"{jax.tree_util.keystr(path)}")
        start = dict(jax.tree_util.tree_leaves_with_path(tree))[path]
        moved = max(moved, float(np.abs(np.asarray(want) - start).max()))
    assert moved > 1e-3  # the updates really moved the params

    for group, js in j_state.items():
        ts = t_opt.moments[group]
        assert int(js.count) == UPDATES
        if mode == "bf16":
            assert ts["mu"].dtype == torch.bfloat16
            np.testing.assert_allclose(
                ts["mu"].float().numpy(),
                np.asarray(js.mu.astype(jnp.float32)), rtol=2 ** -7,
                atol=0, err_msg=f"{case} {group} mu (one bf16 ulp)")
            np.testing.assert_allclose(ts["nu"].numpy(), np.asarray(js.nu),
                                       rtol=1e-5, atol=1e-12)
            continue
        n = int(np.asarray(js.mu.q).size)
        for name in ("mu", "nu"):
            jq = getattr(js, name)
            j_codes = np.asarray(jq.q).reshape(-1)
            j_scale = np.asarray(jq.scale).reshape(-1)
            t_codes = ts[name + "_q"].numpy()
            t_scale = ts[name + "_s"].numpy()
            assert t_codes.dtype == np.int8 and t_codes.size == n
            diff = np.abs(t_codes.astype(int) - j_codes.astype(int))
            assert diff.max() <= 1, (case, group, name)
            assert (diff > 0).mean() <= CODE_DIFF_SHARE, (case, group, name)
            # each dequantized moment within one quantization step of its
            # block
            step = np.maximum(t_scale, j_scale)[:, None]
            deq_t = t_codes.reshape(-1, 256) * t_scale[:, None]
            deq_j = j_codes.reshape(-1, 256) * j_scale[:, None]
            assert (np.abs(deq_t - deq_j) <= step * (1 + 1e-6)).all()
        if case == "zero_group" and group == "lora_text":
            # no gradient: both moments stay zero, every block scale 1
            assert not ts["mu_q"].any() and not ts["nu_q"].any()
            assert (ts["mu_s"] == 1).all() and (ts["nu_s"] == 1).all()


@pytest.mark.parametrize("n", [1, 37, 256, 256 * 3 + 37, 5000])
def test_quantize_matches_jax(n):
    """The plain version's blockwise quantize / dequantize against
    lora_tpu's _quantize / _dequantize, bit for bit: random magnitudes over
    nine decades, ties at half a code, and an all-zero block (scale 1)."""
    rng = np.random.default_rng(n)
    for trial in range(8):
        x = (rng.standard_normal(n)
             * 10.0 ** rng.integers(-6, 3)).astype(np.float32)
        if trial == 1 and n > 256:
            x[256:512] = 0.0
        if trial == 2:
            x[:] = 0.0
        if trial == 3:  # exact half-code ties: round half to even
            x = (np.arange(n) % 7 - 3).astype(np.float32) * 0.5
            x[0] = 127.0
        want = j_optim._quantize(jnp.asarray(x))
        q, s = adam8bit.quantize(torch.from_numpy(x))
        assert q.dtype == torch.int8 and q.numel() == -(-n // 256) * 256
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(want.q).reshape(-1))
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(want.scale).reshape(-1))
        np.testing.assert_array_equal(
            adam8bit.dequantize(q, s, n).numpy(),
            np.asarray(j_optim._dequantize(want, x.shape)))
        if trial == 2:
            assert (s.numpy() == 1.0).all()


def test_update_plain_version_matches_jax_adam8bit():
    """One call of adam8bit_update (the plain version on the CPU) against
    lora_tpu's adamw_8bit on one vector of 256 * 3 + 37 elements: the
    tail of the last block counts as zeros, the clip scale multiplies the
    gradient first, and the state carries sqrt(nu)."""
    n = 256 * 3 + 37
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal(n).astype(np.float32)
    grads = [(0.3 * rng.standard_normal(n)).astype(np.float32)
             for _ in range(3)]
    clip = np.float32(0.7)
    opt = j_optim.adamw_8bit(2e-3, weight_decay=1e-2)
    state, jp = opt.init(jnp.asarray(p0)), jnp.asarray(p0)
    update = jax.jit(opt.update)

    p = torch.from_numpy(p0.copy())
    mu_q, mu_s = adam8bit.quantize(torch.zeros(n))
    nu_q, nu_s = mu_q.clone(), mu_s.clone()
    for count, g in enumerate(grads, start=1):
        u, state = update(jnp.asarray(g * clip), state, jp)
        jp = jp + u
        c1, c2 = t_optim._bias_corrections((0.9, 0.999), count)
        adam8bit.adam8bit_update(
            torch.from_numpy(g), torch.tensor(clip), p, mu_q, mu_s, nu_q,
            nu_s, lr=2e-3, wd=1e-2, b1=0.9, b2=0.999, eps=1e-8, c1=c1, c2=c2)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=PARAM_RTOL,
                               atol=PARAM_ATOL)
    j_mu, j_nu = state[0].mu, state[0].nu
    for got_q, got_s, want in ((mu_q, mu_s, j_mu), (nu_q, nu_s, j_nu)):
        diff = got_q.numpy().astype(int) - np.asarray(want.q).reshape(-1)
        assert np.abs(diff).max() <= 1
        assert (diff != 0).mean() <= CODE_DIFF_SHARE
        np.testing.assert_allclose(got_s.numpy(),
                                   np.asarray(want.scale).reshape(-1),
                                   rtol=1e-6)
    assert not mu_q[n:].any() and not nu_q[n:].any()  # the padded tail


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch (the kernel's count is for launches only)."""
    n = 300
    q, s = adam8bit.quantize(torch.zeros(n))
    p = torch.ones(n)
    before = adam8bit.adam8bit_update.launches
    adam8bit.adam8bit_update(torch.full((n,), 0.5), None, p, q, s,
                             q.clone(), s.clone(), lr=0.1, wd=0.0, b1=0.9,
                             b2=0.999, eps=1e-8, c1=0.1, c2=0.001)
    assert adam8bit.adam8bit_update.launches == before
    # the first Adam step moves every element by lr * g / |g|
    torch.testing.assert_close(p, torch.full((n,), 0.9), rtol=1e-6,
                               atol=1e-6)
    assert (q[:n] == 127).all()  # mu = 0.05 everywhere: each absmax


def test_state_bytes():
    """The int8 state is one byte per moment and element (plus a scale per
    256), the bf16 state 2 + 4 bytes, AdamW's 8."""
    rng = np.random.default_rng(1)
    tree = {"lora_unet": {"scale": np.float32(1.0), "sites": {"a": {
        "down": rng.standard_normal((4, 1000)).astype(np.float32),
        "up": np.zeros((1000, 4), np.float32)}}}}
    n = 8001

    def state_bytes(mode):
        opt = t_optim.make_optimizer(trainable_from_jax(tree),
                                     {"lora_unet": 1e-3}, low_memory=mode)
        return sum(t.numel() * t.element_size()
                   for t in opt.state_tensors()[1:])

    nb = -(-n // 256)
    assert state_bytes("int8") == 2 * (nb * 256 + 4 * nb)
    assert state_bytes("bf16") == 6 * n
    assert state_bytes(False) == 8 * n + 4 * 3  # + a step per param
