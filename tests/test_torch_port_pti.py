"""The port's pivotal tuning trainer (lora_tpu_torch/training/pti.py)
against lora_tpu's, the slice as a whole: train_pti in f32 on the tiny
configs, from the same PNGs and the same base weights, 3 inversion and 3
tuning steps of 2 micro-steps each. jax.random's draws cannot be made with
torch, so the port gets lora_tpu's through its seams, monkeypatched (none
is a config field or a flag): the key chain of the JAX trainer
(PRNGKey(seed), split for the TI rows, the cache, each micro-step, the
LoRA init) is replayed in the order the port draws, and hands in the
<rand-sigma> rows of setup_ti, the posterior noise of cache_latents' VAE
encodes, each micro-step's noise, timesteps and VAE noise, and
lora_tpu's init_lora. Checked: the final TI rows and LoRA trees within
1e-4 relative L2, the same metrics.jsonl phases and steps with losses
within 1e-4, and the same artifact names, keys and metadata with tensors
within fp16 rounding.

Cases here: two placeholder tokens (one <rand-0.017>, one initialised from
a token's row) with the text encoder and cached latents, whose inversion
also shows the norm prior pulling each row toward 0.4 in both packages;
and continue_inversion at its own learning rate, uncached, under a cosine
schedule with warmup. tests/test_torch_port_pti_masks.py runs face masks
and LoCon targets, tests/test_torch_port_pti_inpaint.py the 9-channel
inpainting UNet (each JAX run compiles two train steps, ~60 s on a CPU, and
--dist loadfile gives a file one worker)."""

import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import lora as j_lora  # noqa: E402
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.formats.reader import load_file  # noqa: E402
from lora_tpu.models.config import TINY_TEXT, TINY_UNET, TINY_VAE  # noqa: E402
from lora_tpu.training import pti as j_pti  # noqa: E402
from lora_tpu_torch.convert import (  # noqa: E402
    lora_from_jax,
    trainable_to_numpy,
)
from lora_tpu_torch.training import pti as t_pti  # noqa: E402

from test_torch_port_dreambooth import (  # noqa: E402, F401
    _jax_sites,
    _meta,
    _metrics as metrics,
    _one_torch_thread,
    base_params,
    jax_pipe,
    port_pipe,
    write_images,
)
from test_torch_port_training import jax_draws  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

SIZE = 64
# f32 on both sides; the frameworks sum convolutions and matmuls in other
# orders (~1e-6 relative per op), which a few Adam steps carry along
TREE_REL_L2 = 1e-4
LOSS_RTOL = 1e-4
BASE = dict(resolution=SIZE, lora_rank=2, max_train_steps_ti=3,
            max_train_steps_tuning=3, gradient_accumulation_steps=2,
            save_steps=2, seed=0, placeholder_tokens="<s1>|<s2>",
            use_template="object", train_text_encoder=False)
INPAINT_UNET = dataclasses.replace(TINY_UNET, in_channels=9)


# ---------------------------------------------------------------------------
# the seams: lora_tpu's key chain, replayed in the port's order
# ---------------------------------------------------------------------------

class JaxChain:
    """The JAX trainer's key: PRNGKey(seed), split once for the TI rows,
    once for the cache, once per micro-step, and three ways at the LoRA
    init."""

    def __init__(self, seed):
        self.rng = jax.random.PRNGKey(seed)
        self.cache = None
        self.pending = []

    def split(self):
        self.rng, k = jax.random.split(self.rng)
        return k


def hand_in_jax_draws(monkeypatch, module, seed, vae_cfg=TINY_VAE):
    """The trainer `module` (training/pti.py or training/ti_legacy.py) gets
    lora_tpu's draws: setup_ti's <rand-sigma> rows, cache_latents' VAE
    posterior noise, each micro-step's noise / timesteps / VAE noise, and
    init_lora, all from the replayed key chain."""
    chain = JaxChain(seed)
    lat_c = vae_cfg.latent_channels
    down = 2 ** (len(vae_cfg.block_out_channels) - 1)

    real_setup = module.setup_ti

    def setup_ti(pipe, tokens, inits, generator):
        ids, rows = real_setup(pipe, tokens, inits, generator)
        r = chain.split()
        rows = rows.clone()
        for i, init in enumerate(inits):
            r, k = jax.random.split(r)
            if init.startswith("<rand"):
                sigma = float(re.findall(r"<rand-(.*)>", init)[0])
                rows[i] = torch.from_numpy(np.array(
                    jax.random.normal(k, (rows.shape[1],), jnp.float32)
                    * sigma))
        return ids, rows

    monkeypatch.setattr(module, "setup_ti", setup_ti)

    if hasattr(module, "cache_latents"):
        real_cache, real_encode = module.cache_latents, module.vae_encode

        def cache_latents(pipe, dataset, generator, dtype=torch.float32):
            chain.cache = chain.split()
            return real_cache(pipe, dataset, generator, dtype)

        def vae_encode(p, x, cfg, generator=None, sample=True, noise=None):
            chain.cache, k = jax.random.split(chain.cache)
            shape = (x.shape[0], x.shape[1] // down, x.shape[2] // down,
                     lat_c)
            noise = np.array(jax.random.normal(k, shape))
            return real_encode(p, x, cfg, None, sample,
                               torch.from_numpy(noise))

        monkeypatch.setattr(module, "cache_latents", cache_latents)
        monkeypatch.setattr(module, "vae_encode", vae_encode)

    real_step = module.make_train_step

    def make_train_step(**kw):
        step = real_step(**kw)
        lc = kw["loss_cfg"]
        t_hi = int(kw["sched"].num_train_timesteps * lc.t_multiplier)

        def seamed(trainable, base, batch, generator=None):
            ref = batch.get("latents")
            if ref is None:
                b, h, w, _ = batch["pixel_values"].shape
                shape = (b, h // down, w // down, lat_c)
            else:
                shape = tuple(ref.shape)
            d = jax_draws(chain.split(), shape, t_hi)
            names = ["noise", "timesteps"]
            if not lc.cached_latents:
                names.append("vae_noise")
                if lc.train_inpainting:
                    names.append("masked_vae_noise")
            return step(trainable, base, batch,
                        **{n: torch.from_numpy(np.array(d[n]))
                           for n in names})

        return seamed

    monkeypatch.setattr(module, "make_train_step", make_train_step)

    def init_lora(sites, r=4, *, generator, device, scale=1.0, **kw):
        if chain.pending:
            key = chain.pending.pop()
        else:
            chain.rng, key, k_text = jax.random.split(chain.rng, 3)
            chain.pending.append(k_text)
        tree = j_lora.init_lora(_jax_sites(sites), r=r, rng=key,
                                scale=scale)
        return lora_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                             device=device)

    monkeypatch.setattr(module.lora_core, "init_lora", init_lora)
    return chain


# ---------------------------------------------------------------------------
# both trainers on the same inputs, and the comparison
# ---------------------------------------------------------------------------

def run_both(flags, params, root, unet_cfg=TINY_UNET, images=None):
    """(JAX result, port result, JAX output dir, port output dir). Each
    package gets its own copy of the instance images (a dataset may write
    face masks beside them); `images(dir)` writes them (3 PNGs by
    default)."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        hand_in_jax_draws(mp, t_pti, flags["seed"])
        for name in ("jax", "torch"):
            inst = root / f"inst_{name}"
            (images or (lambda d: write_images(d, 3, 0)))(inst)
            cfg = dict(flags, instance_data_dir=str(inst),
                       output_dir=str(root / f"out_{name}"))
            if name == "jax":
                out[name] = j_pti.train_pti(jax_pipe(params, unet_cfg),
                                            j_pti.PTIConfig(**cfg))
            else:
                out[name] = t_pti.train_pti(port_pipe(params, unet_cfg),
                                            t_pti.PTIConfig(**cfg))
    finally:
        mp.undo()
    return out["jax"], out["torch"], root / "out_jax", root / "out_torch"


def rel_l2(got, want):
    g = np.concatenate([np.ravel(x).astype(np.float64) for x in got])
    w = np.concatenate([np.ravel(x).astype(np.float64) for x in want])
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def check_trees(case, j_res, t_res):
    """The final trainable groups (the LoRAs, and the TI rows where they
    train in tuning) within TREE_REL_L2 relative L2 each."""
    want = jax.tree_util.tree_map(np.asarray, j_res["trainable"])
    got = trainable_to_numpy(t_res["trainable"])
    assert sorted(got) == sorted(want), case
    for group in want:
        wl = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(want[group])}
        gl = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(got[group])}
        assert sorted(gl) == sorted(wl), (case, group)
        rel = rel_l2([gl[p] for p in wl], list(wl.values()))
        assert rel <= TREE_REL_L2, (case, group, rel)


def check_metrics(case, j_out, t_out):
    jm, tm = metrics(j_out / "metrics.jsonl"), metrics(t_out / "metrics.jsonl")
    assert [sorted(r) for r in tm] == [sorted(r) for r in jm], case
    for a, b in zip(tm, jm):
        assert (a.get("phase"), a.get("step")) == (b.get("phase"),
                                                   b.get("step"))
        for k in ("loss", "final_loss"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL)
    return tm


def file_pairs(name, j_out, t_out):
    """[(port tensor, JAX tensor)] of one artifact, read by lora_tpu's
    readers; safetensors metadata must match."""
    if name.endswith(".embeds.pt"):
        from lora_tpu.formats.pt_io import load_a1111_embedding

        (jn, je), (tn, te) = (load_a1111_embedding(str(d / name))
                              for d in (j_out, t_out))
        assert tn == jn and sorted(te) == sorted(je), name
        return [(te[k], je[k]) for k in je]
    (jt, jmeta), (tt, tmeta) = (load_file(str(d / name))
                                for d in (j_out, t_out))
    assert _meta(tmeta) == _meta(jmeta) and sorted(tt) == sorted(jt), name
    return [(tt[k], jt[k]) for k in jt]


def check_artifacts(case, j_out, t_out):
    names = sorted(os.listdir(j_out))
    assert sorted(os.listdir(t_out)) == names, case
    for name in names:
        if name == "metrics.jsonl":
            continue
        pairs = file_pairs(name, j_out, t_out)
        for g, w in pairs:
            assert g.dtype == w.dtype and g.shape == w.shape, name
        # the trees' difference plus one fp16 rounding (2^-11 relative)
        rel = rel_l2([g for g, _ in pairs], [w for _, w in pairs])
        assert rel <= TREE_REL_L2 + 2 ** -11, (case, name, rel)
    return names


def check_same_run(case, j_res, t_res, j_out, t_out):
    assert not t_res["preempted"] and not j_res["preempted"]
    assert t_res["placeholder_tokens"] == j_res["placeholder_tokens"]
    np.testing.assert_array_equal(t_res["ti_ids"], j_res["ti_ids"])
    np.testing.assert_allclose(t_res["final_loss"], j_res["final_loss"],
                               rtol=LOSS_RTOL)
    check_trees(case, j_res, t_res)
    check_metrics(case, j_out, t_out)
    return check_artifacts(case, j_out, t_out)


def embeds_of(path):
    """{token: row} of a safetensors artifact's TI entries."""
    from lora_tpu.formats.safetensors_io import load_safeloras_embeds

    return load_safeloras_embeds(str(path))


# ---------------------------------------------------------------------------
# the cases of this file
# ---------------------------------------------------------------------------

CASES = {
    # two tokens, one drawn and one copied from a token's row; the text
    # encoder; cached latents
    "two_tokens": dict(initializer_tokens="<rand-0.017>|dog",
                       train_text_encoder=True),
    # the TI rows keep training in tuning at their own lr; uncached;
    # cosine with warmup in both phases
    "continue_inversion": dict(continue_inversion=True,
                               continue_inversion_lr=2e-4,
                               cached_latents=False, lr_scheduler="cosine",
                               lr_warmup_steps=1,
                               lr_scheduler_lora="cosine",
                               lr_warmup_steps_lora=1),
}


@pytest.fixture(scope="module")
def params():
    return base_params()


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    """Both trainers on each case, once for the module."""
    return {case: run_both(dict(BASE, **flags), params,
                           tmp_path_factory.mktemp(case))
            for case, flags in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_pti_matches_jax(case, runs):
    j_res, t_res, j_out, t_out = runs[case]
    names = check_same_run(case, j_res, t_res, j_out, t_out)
    assert names == ["final_lora.safetensors", "metrics.jsonl",
                     "step_2.safetensors", "step_inv_2.safetensors"]
    tm = metrics(t_out / "metrics.jsonl")
    assert [(r["phase"], "final_loss" in r) for r in tm] == [
        ("inversion", False), ("inversion", True), ("tune", False),
        ("tune", True)]
    # the TI rows of the final file: the inversion's, moved on in tuning
    # with continue_inversion
    te, je = (embeds_of(d / "final_lora.safetensors") for d in (t_out,
                                                                j_out))
    assert sorted(te) == sorted(je) == ["<s1>", "<s2>"]
    assert rel_l2([te[k] for k in je], list(je.values())) <= TREE_REL_L2


def test_norm_prior_pulls_rows_toward_0_4(runs, params):
    """Each TI row's norm after inversion (the step_inv_2 save and the
    final rows of the two-token run) is nearer 0.4 than its initial norm,
    in both packages, and the row copied from "dog" starts at its row."""
    j_res, t_res, j_out, t_out = runs["two_tokens"]
    table = params[1]["text_model.embeddings.token_embedding.weight"]
    dog = JTokenizer(vocab_size=TINY_TEXT.vocab_size).encode("dog")
    assert len(dog) == 1
    k0 = jax.random.split(jax.random.split(jax.random.PRNGKey(0))[1])[1]
    init = {"<s1>": np.asarray(jax.random.normal(k0, (table.shape[1],))
                               * 0.017),
            "<s2>": table[dog[0]]}
    for out in (j_out, t_out):
        rows = embeds_of(out / "final_lora.safetensors")
        for tok, row in rows.items():
            n0 = np.linalg.norm(init[tok])
            n1 = np.linalg.norm(row)
            assert abs(n1 - 0.4) < abs(n0 - 0.4), (out, tok, n0, n1)
