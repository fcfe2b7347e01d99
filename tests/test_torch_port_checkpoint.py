"""The port's checkpoint files against lora_tpu's: the legacy .pt files
(flat fp16 nn.Parameter lists, TI dicts, A1111 embeddings, the JSON form)
and save_all's safetensors and .pt forms, each written by one package and
read by the other; the train state (training/checkpoint.py) round trip, bit
for bit, for AdamW and both low-memory Adams, mid-accumulation; the
mismatches that raise; and PreemptionGuard."""

import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from lora_tpu.core.save import save_all as j_save_all  # noqa: E402
from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_lora_sites,
    unet_lora_sites,
)
from lora_tpu.formats import pt_io as j_pt  # noqa: E402
from lora_tpu.formats.reader import load_file  # noqa: E402
from lora_tpu.models.config import TINY_TEXT, TINY_UNET  # noqa: E402
from lora_tpu_torch.convert import lora_from_jax  # noqa: E402
from lora_tpu_torch.convert import trainable_from_jax  # noqa: E402
from lora_tpu_torch.core import sites as t_sites  # noqa: E402
from lora_tpu_torch.core.save import save_all as t_save_all  # noqa: E402
from lora_tpu_torch.formats import pt_io as t_pt  # noqa: E402
from lora_tpu_torch.training import checkpoint as t_ckpt  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402

from test_torch_port_training import random_lora  # noqa: E402

PACKAGES = {"jax": j_pt, "torch": t_pt}


def _pairs(seed, n=3):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((8, 2))).astype(np.float32),
             (rng.standard_normal((2, 6))).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_pt_files_cross_read(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    pairs = _pairs(0)
    flat = [a for pair in pairs for a in pair]

    w.save_lora_pt(pairs, str(tmp_path / "l.pt"))
    got = r.load_lora_pt(str(tmp_path / "l.pt"))
    assert len(got) == len(flat)
    for g, want in zip(got, flat):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, want.astype(np.float16))

    w.save_lora_json(pairs, str(tmp_path / "l.json"))
    for g, want in zip(r.load_lora_json(str(tmp_path / "l.json")), flat):
        np.testing.assert_array_equal(g, want)

    embeds = {"<s1>": np.arange(5, dtype=np.float32),
              "<s2>": -np.arange(5, dtype=np.float32)}
    w.save_ti_pt(embeds, str(tmp_path / "ti.pt"))
    got = r.load_ti_pt(str(tmp_path / "ti.pt"))
    assert sorted(got) == sorted(embeds)
    for k in embeds:
        np.testing.assert_array_equal(got[k], embeds[k])

    w.save_a1111_embedding("<s1>", embeds["<s1>"], str(tmp_path / "a.pt"),
                           name="one")
    name, got = r.load_a1111_embedding(str(tmp_path / "a.pt"))
    assert name == "one" and list(got) == ["one"]
    np.testing.assert_array_equal(got["one"], embeds["<s1>"])

    w.save_a1111_multi_embedding(embeds, str(tmp_path / "m.pt"), name="multi")
    name, got = r.load_a1111_embedding(str(tmp_path / "m.pt"))
    assert name == "multi" and sorted(got) == sorted(embeds)
    for k in embeds:
        np.testing.assert_array_equal(got[k], embeds[k])


def test_pt_paths_and_raw_contents(tmp_path):
    for path in ("out/lora_weight.pt", "a.b.pt"):
        assert t_pt.text_lora_path(path) == j_pt.text_lora_path(path)
        assert t_pt.ti_lora_path(path) == j_pt.ti_lora_path(path)
    with pytest.raises(ValueError, match=".pt"):
        t_pt.text_lora_path("x.safetensors")
    # the list elements are fp16 nn.Parameters, as lora_tpu writes them
    t_pt.save_lora_pt(_pairs(1, 1), str(tmp_path / "p.pt"))
    raw = torch.load(str(tmp_path / "p.pt"), weights_only=True)
    assert all(isinstance(x, torch.nn.Parameter) and x.dtype == torch.float16
               for x in raw)


def _loras(seed):
    """A UNet and a text LoRA (numpy, scale 0.8) and the port's copies."""
    us, ts = unet_lora_sites(TINY_UNET), text_encoder_lora_sites(TINY_TEXT)
    j_u, j_t = random_lora(us, seed), random_lora(ts, seed + 1)
    return (j_u, j_t, us, ts), (lora_from_jax(j_u), lora_from_jax(j_t),
                                t_sites.unet_lora_sites(TINY_UNET),
                                t_sites.text_encoder_lora_sites(TINY_TEXT))


def _meta(meta):
    """File metadata with each model's target list as a set: both packages
    write json.dumps(list(a set)), whose order varies with string
    hashing."""
    out = {}
    for k, v in meta.items():
        out[k] = frozenset(json.loads(v)) if v.startswith("[") else v
    return out


@pytest.mark.parametrize("safe_form", [True, False])
def test_save_all_matches_jax(tmp_path, safe_form):
    """The same LoRA saved by both packages: the same files, keys,
    metadata and fp16 tensors; each package's .pt files read by the
    other."""
    (j_u, j_t, us, ts), (t_u, t_t, tus, tts) = _loras(3)
    embeds = {"<s1>": np.linspace(-1, 1, TINY_TEXT.hidden_size,
                                  dtype=np.float32)}
    ext = ".safetensors" if safe_form else ".pt"
    out = {}
    for name, fn, args in (
            ("jax", j_save_all, (j_u, us, j_t, ts)),
            ("torch", t_save_all, (t_u, tus, t_t, tts))):
        d = tmp_path / name
        d.mkdir()
        fn(str(d / f"lora{ext}"), lora_unet=args[0], unet_sites=args[1],
           lora_text=args[2], text_sites=args[3], embeds=embeds,
           safe_form=safe_form)
        out[name] = d
    assert sorted(os.listdir(out["jax"])) == sorted(os.listdir(out["torch"]))
    for fname in os.listdir(out["jax"]):
        if safe_form:
            (jt, jm), (tt, tm) = (load_file(str(out[n] / fname))
                                  for n in ("jax", "torch"))
            assert _meta(jm) == _meta(tm) and sorted(jt) == sorted(tt)
            for k in jt:
                assert tt[k].dtype == jt[k].dtype, k
                np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
            continue
        reader = j_pt.load_ti_pt if ".ti." in fname else j_pt.load_lora_pt
        treader = t_pt.load_ti_pt if ".ti." in fname else t_pt.load_lora_pt
        for got, want in ((treader(str(out["jax"] / fname)),
                           reader(str(out["jax"] / fname))),
                          (reader(str(out["torch"] / fname)),
                           reader(str(out["jax"] / fname)))):
            if isinstance(want, dict):
                assert sorted(got) == sorted(want)
                got, want = [got[k] for k in sorted(got)], \
                    [want[k] for k in sorted(want)]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the train state
# ---------------------------------------------------------------------------

def _trainable(seed=0):
    rng = np.random.default_rng(seed)
    return trainable_from_jax({
        "lora_unet": {"sites": {
            "a": {"up": rng.standard_normal((300, 2)).astype(np.float32),
                  "down": rng.standard_normal((2, 70)).astype(np.float32)}},
            "scale": np.float32(1.0)},
        "lora_text": {"sites": {
            "b": {"up": rng.standard_normal((5, 2)).astype(np.float32),
                  "down": rng.standard_normal((2, 9)).astype(np.float32)}},
            "scale": np.float32(1.0)}})


def _opt(tree, mode, accum=2):
    return t_optim.make_optimizer(tree, {"lora_unet": 1e-2,
                                         "lora_text": 5e-3},
                                  low_memory=mode, grad_accum=accum)


def _micro_steps(tree, opt, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        for leaf in t_optim.tree_leaves(tree):
            leaf.grad = torch.from_numpy(
                rng.standard_normal(leaf.shape).astype(np.float32))
        opt.step()


@pytest.mark.parametrize("mode", [False, "bf16", "int8"])
def test_train_state_round_trip(tmp_path, mode):
    """Save after 5 micro-steps at grad_accum=2 (one mid-accumulation),
    load into a fresh tree and optimizer: every leaf, every optimizer
    tensor, the step and the generator come back bit for bit, and the next
    steps agree bit for bit."""
    tree = _trainable()
    opt = _opt(tree, mode)
    _micro_steps(tree, opt, 5, seed=1)
    assert opt.count == 2 and opt.mini_step == 1
    gen = torch.Generator().manual_seed(11)
    torch.randn(3, generator=gen)
    path = str(tmp_path / "state.safetensors")
    t_ckpt.save_train_state(path, tree, opt, step=2, generator=gen)

    tree2 = _trainable(seed=9)
    opt2 = _opt(tree2, mode)
    gen2 = torch.Generator().manual_seed(0)
    assert t_ckpt.load_train_state(path, tree2, opt2, gen2) == 2
    for a, b in zip(t_optim.tree_leaves(tree), t_optim.tree_leaves(tree2)):
        assert torch.equal(a, b)
    s1, s2 = opt.state_tensors(), opt2.state_tensors()
    assert len(s1) == len(s2)
    for a, b in zip(s1, s2):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (opt2.count, opt2.mini_step) == (2, 1)
    assert torch.equal(torch.randn(4, generator=gen),
                       torch.randn(4, generator=gen2))
    _micro_steps(tree, opt, 3, seed=2)
    _micro_steps(tree2, opt2, 3, seed=2)
    for a, b in zip(t_optim.tree_leaves(tree), t_optim.tree_leaves(tree2)):
        assert torch.equal(a, b)


def test_train_state_before_any_step(tmp_path):
    """A state saved before the first update (AdamW has no state yet)
    loads and trains on exactly as a fresh one."""
    tree, tree2 = _trainable(), _trainable()
    opt, opt2 = _opt(tree, False, 1), _opt(tree2, False, 1)
    path = str(tmp_path / "s.safetensors")
    t_ckpt.save_train_state(path, tree, opt, 0, torch.Generator())
    t_ckpt.load_train_state(path, tree2, opt2)
    _micro_steps(tree, opt, 2, seed=3)
    _micro_steps(tree2, opt2, 2, seed=3)
    for a, b in zip(t_optim.tree_leaves(tree), t_optim.tree_leaves(tree2)):
        assert torch.equal(a, b)


def test_train_state_mismatches_raise(tmp_path):
    tree = _trainable()
    opt = _opt(tree, "int8")
    _micro_steps(tree, opt, 2, seed=4)
    path = str(tmp_path / "s.safetensors")
    t_ckpt.save_train_state(path, tree, opt, 1, torch.Generator())
    # another optimizer: another number of leaves
    other = _trainable()
    with pytest.raises(ValueError, match="leaves"):
        t_ckpt.load_train_state(path, other, _opt(other, "bf16"))
    # another rank: the same count, another shape; nothing is changed
    rng = np.random.default_rng(5)
    wide = trainable_from_jax({
        "lora_unet": {"sites": {"a": {
            "up": rng.standard_normal((300, 3)).astype(np.float32),
            "down": rng.standard_normal((3, 70)).astype(np.float32)}},
            "scale": np.float32(1.0)},
        "lora_text": {"sites": {"b": {
            "up": rng.standard_normal((5, 2)).astype(np.float32),
            "down": rng.standard_normal((2, 9)).astype(np.float32)}},
            "scale": np.float32(1.0)}})
    before = [t.clone() for t in t_optim.tree_leaves(wide)]
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.load_train_state(path, wide, _opt(wide, "int8"))
    for a, b in zip(before, t_optim.tree_leaves(wide)):
        assert torch.equal(a, b)


def test_preemption_guard():
    prev = signal.getsignal(signal.SIGTERM)
    with t_ckpt.PreemptionGuard() as guard:
        assert not guard.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.should_stop
    assert signal.getsignal(signal.SIGTERM) is prev
