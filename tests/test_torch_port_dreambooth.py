"""The port's DreamBooth trainer (lora_tpu_torch/training/dreambooth.py)
against lora_tpu's, the slice as a whole: train_dreambooth for 3 steps in
f32 on the tiny configs, from the same PNGs, the same base weights and the
same starting LoRA (written once by lora_tpu's save_all as .pt files and
passed as resume_unet / resume_text_encoder; locon, which refuses .pt
resume, starts from lora_tpu's init_lora through the port's init seam).
jax.random's draws cannot be made with torch, so each case hands the JAX
trainer's step draws (PRNGKey(seed + 7), split once per micro-step) and its
cached-latent posterior noise (PRNGKey(seed + 99)) to the port through its
step factory and its VAE encode, monkeypatched: neither is a config field
or a flag. Checked: the final LoRA trees within 1e-4 relative L2, the same
metrics.jsonl steps with losses within 1e-4, and the same artifact names,
keys and metadata with tensors within fp16 rounding. Then, port alone: a
preemption (SIGTERM from a step hook) and a resume give the bits of a
straight run, the unported paths raise, and an SDXL pipe trains.

Cases here: uncached with the text encoder and prior preservation, and
cached latents; tests/test_torch_port_dreambooth_optim.py runs
use_8bit_adam, gradient_accumulation_steps=2 and LoCon targets (each JAX
run compiles its train step, ~45 s here, and --dist loadfile gives a file
one worker)."""

import dataclasses
import json
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.core import lora as j_lora  # noqa: E402
from lora_tpu.core.save import save_all as j_save_all  # noqa: E402
from lora_tpu.core.sites import (  # noqa: E402
    text_encoder_lora_sites,
    unet_lora_sites,
)
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.formats.reader import load_file  # noqa: E402
from lora_tpu.models.config import TINY_TEXT, TINY_UNET, TINY_VAE  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu.training import dreambooth as j_db  # noqa: E402
from lora_tpu_torch.convert import (  # noqa: E402
    lora_from_jax,
    state_dict_from_jax,
    trainable_to_numpy,
)
from lora_tpu_torch.data.png import _png_bytes  # noqa: E402
from lora_tpu_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from lora_tpu_torch.formats import pt_io as t_pt  # noqa: E402
from lora_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from lora_tpu_torch.models.unet import UNet  # noqa: E402
from lora_tpu_torch.models.vae import VAE  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_XL_TEXT,
    TINY_XL_TEXT2,
    TINY_XL_UNET,
)
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import (  # noqa: E402
    StableDiffusionXLPipeline,
)
from lora_tpu_torch.training import dreambooth as t_db  # noqa: E402
from lora_tpu_torch.training import optim as t_optim  # noqa: E402

from test_torch_port_training import jax_draws, random_lora  # noqa: E402

SIZE = 64
STEPS = 3
# f32 on both sides; the frameworks sum convolutions and matmuls in other
# orders (~1e-6 relative per op), which 3 Adam steps carry to the LoRA
TREE_REL_L2 = 1e-4
LOSS_RTOL = 1e-4
BASE = dict(resolution=SIZE, lora_rank=2, max_train_steps=STEPS,
            save_steps=2, seed=0, instance_prompt="a photo of sks dog",
            learning_rate=1e-4, learning_rate_text=5e-5)
CASES = {
    "text_prior": dict(train_text_encoder=True, with_prior_preservation=True,
                       class_prompt="a photo of a dog", num_class_images=2),
    "cached_latents": dict(cached_latents=True),
    "locon": dict(lora_targets="locon", output_format="safe",
                  train_text_encoder=True),
    "adam8bit": dict(use_8bit_adam=True, train_text_encoder=True),
    "grad_accum": dict(gradient_accumulation_steps=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny CPU shapes gain nothing from intra-op threads, and with
    several test processes on the cores those threads oversubscribe them;
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_images(d, n, seed):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        with open(d / f"img_{i}.png", "wb") as f:
            f.write(_png_bytes(rng.integers(0, 255, (SIZE, SIZE, 3),
                                            dtype=np.uint8)))
    return str(d)


def base_params(unet_cfg=TINY_UNET):
    """Numpy params of the tiny UNet, CLIP and VAE (the port's init)."""
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=unet_cfg,
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)
    return tuple({k: v.numpy() for k, v in m.state_dict().items()}
                 for m in (pipe.unet, pipe.text_encoder, pipe.vae))


def jax_pipe(params, unet_cfg=TINY_UNET):
    unet_p, text_p, vae_p = params
    return JPipe(unet_params={k: jnp.asarray(v) for k, v in unet_p.items()},
                 text_params={k: jnp.asarray(v) for k, v in text_p.items()},
                 vae_params={k: jnp.asarray(v) for k, v in vae_p.items()},
                 tokenizer=JTokenizer(vocab_size=TINY_TEXT.vocab_size),
                 unet_cfg=unet_cfg, text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)


def port_pipe(params, unet_cfg=TINY_UNET):
    modules = []
    for cls, cfg, p in ((UNet, unet_cfg, params[0]),
                        (CLIPTextModel, TINY_TEXT, params[1]),
                        (VAE, TINY_VAE, params[2])):
        m = cls(cfg, device="cpu")
        m.load_state_dict(state_dict_from_jax(p), strict=True)
        modules.append(m)
    return StableDiffusionPipeline(
        *modules, CLIPTokenizer(vocab_size=TINY_TEXT.vocab_size))


def _jax_keys(seed):
    """The keys the JAX trainer hands its steps, one per micro-step."""
    rng = jax.random.PRNGKey(seed)
    while True:
        rng, k = jax.random.split(rng)
        yield k


def hand_in_jax_draws(monkeypatch, seed):
    """The port's trainer gets lora_tpu's draws: its step factory's steps
    take each micro-step's noise, timesteps and VAE posterior noise from the
    JAX key sequence, and its cached-latent encode the JAX posterior
    noise."""
    real_step, real_encode = t_db.make_train_step, t_db.vae_encode
    lat_c = TINY_VAE.latent_channels
    down = 2 ** (len(TINY_VAE.block_out_channels) - 1)

    def make_train_step(**kw):
        step = real_step(**kw)
        keys = _jax_keys(seed + 7)

        def seamed(trainable, base, batch, generator=None):
            ref = batch.get("latents")
            if ref is None:
                b, h, w, _ = batch["pixel_values"].shape
                shape = (b, h // down, w // down, lat_c)
            else:
                shape = tuple(ref.shape)
            d = jax_draws(next(keys), shape, 1000)
            draws = {k: torch.from_numpy(np.array(d[k]))
                     for k in ("noise", "timesteps")}
            if ref is None:
                draws["vae_noise"] = torch.from_numpy(np.array(
                    d["vae_noise"]))
            return step(trainable, base, batch, **draws)

        return seamed

    cache_keys = _jax_keys(seed + 99)

    def vae_encode(p, x, cfg, generator=None, sample=True, noise=None):
        mean_shape = (x.shape[0], x.shape[1] // down, x.shape[2] // down,
                      lat_c)
        noise = np.asarray(jax.random.normal(next(cache_keys), mean_shape))
        return real_encode(p, x, cfg, None, sample, torch.from_numpy(noise))

    monkeypatch.setattr(t_db, "make_train_step", make_train_step)
    monkeypatch.setattr(t_db, "vae_encode", vae_encode)


def hand_in_jax_init(monkeypatch):
    """The port's LoRA init gives lora_tpu's init_lora from the same seed
    (the generator's seed names the JAX key)."""
    def init_lora(sites, r=4, *, generator, device, **kw):
        key = jax.random.PRNGKey(generator.initial_seed())
        tree = j_lora.init_lora(_jax_sites(sites), r=r, rng=key)
        return lora_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                             device=device)

    monkeypatch.setattr(t_db.lora_core, "init_lora", init_lora)


def _jax_sites(sites):
    from lora_tpu.core.sites import Site

    return [Site(**dataclasses.asdict(s)) for s in sites]


def start_lora(tmp, text: bool):
    """The starting LoRA (nonzero up and down on every site), written by
    lora_tpu's save_all as the legacy .pt files: {resume flags}."""
    us, ts = unet_lora_sites(TINY_UNET), text_encoder_lora_sites(TINY_TEXT)
    path = str(tmp / "start.pt")
    j_save_all(path, lora_unet=random_lora(us, 1, r=2, scale=1.0),
               unet_sites=us,
               lora_text=random_lora(ts, 2, r=2, scale=1.0) if text
               else None, text_sites=ts, save_ti=False, safe_form=False)
    flags = {"resume_unet": path}
    if text:
        flags["resume_text_encoder"] = str(tmp / "start.text_encoder.pt")
    return flags


def run_both(case, params, root, monkeypatch):
    """(JAX result, port result, JAX output dir, port output dir)."""
    root.mkdir(parents=True, exist_ok=True)
    flags = dict(BASE, **CASES[case])
    flags["instance_data_dir"] = write_images(root / "inst", 3, 0)
    if flags.get("lora_targets") == "locon":
        hand_in_jax_init(monkeypatch)
    else:
        flags.update(start_lora(root, flags.get("train_text_encoder",
                                                False)))
    hand_in_jax_draws(monkeypatch, flags["seed"])
    out = {}
    for name in ("jax", "torch"):
        cfg = dict(flags, output_dir=str(root / f"out_{name}"))
        if flags.get("with_prior_preservation"):
            # the same class PNGs for both (lora_tpu would write JPEGs)
            cfg["class_data_dir"] = str(root / f"class_{name}")
            write_images(root / f"class_{name}", 2, 1)
        if name == "jax":
            out[name] = j_db.train_dreambooth(jax_pipe(params),
                                              j_db.DreamBoothConfig(**cfg))
        else:
            out[name] = t_db.train_dreambooth(port_pipe(params),
                                              t_db.DreamBoothConfig(**cfg))
    return out["jax"], out["torch"], root / "out_jax", root / "out_torch"


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _meta(meta):
    """Metadata with the target lists as sets (json.dumps(list(a set)))."""
    return {k: frozenset(json.loads(v)) if v.startswith("[") else v
            for k, v in meta.items()}


def check_same_run(case, j_res, t_res, j_out, t_out):
    assert t_res["steps"] == j_res["steps"] == STEPS
    assert not t_res["preempted"] and not j_res["preempted"]
    np.testing.assert_allclose(t_res["final_loss"], j_res["final_loss"],
                               rtol=LOSS_RTOL)
    # the LoRA trees
    want = jax.tree_util.tree_map(np.asarray, j_res["trainable"])
    got = trainable_to_numpy(t_res["trainable"])
    assert sorted(got) == sorted(want)
    moved = 0.0
    for group in want:
        # relative L2 over the group's whole tree: a zero-initialised up
        # factor is itself ~lr after 3 steps, and Adam moves an entry whose
        # gradient is at the f32 noise floor by up to lr either way
        assert sorted(got[group]["sites"]) == sorted(want[group]["sites"])
        gl = dict(jax.tree_util.tree_leaves_with_path(got[group]))
        wl = jax.tree_util.tree_leaves_with_path(want[group])
        w = np.concatenate([np.ravel(x) for _, x in wl])
        g = np.concatenate([np.ravel(gl[path]) for path, _ in wl])
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= TREE_REL_L2, (case, group, rel)
        for entry in want[group]["sites"].values():
            moved = max(moved, float(np.abs(entry["up"]).max()))
    assert moved > 0  # the up factors are nonzero after training
    # metrics.jsonl: the same records, losses within LOSS_RTOL
    jm = _metrics(j_out / "metrics.jsonl")
    tm = _metrics(t_out / "metrics.jsonl")
    assert [sorted(r) for r in tm] == [sorted(r) for r in jm]
    assert [r.get("step") for r in tm] == [r.get("step") for r in jm]
    for a, b in zip(tm, jm):
        for k in ("loss", "final_loss"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL)
    # the artifacts: names, keys, metadata; tensors within fp16 rounding
    # of trees that agree to TREE_REL_L2
    names = sorted(os.listdir(j_out))
    assert sorted(os.listdir(t_out)) == names, case
    for name in names:
        if name.endswith(".safetensors"):
            (jt, jmeta), (tt, tmeta) = (load_file(str(d / name))
                                        for d in (j_out, t_out))
            assert _meta(tmeta) == _meta(jmeta) and sorted(tt) == sorted(jt)
            pairs = [(tt[k], jt[k]) for k in jt]
        elif name.endswith(".pt"):
            pairs = list(zip(t_pt.load_lora_pt(str(t_out / name)),
                             t_pt.load_lora_pt(str(j_out / name))))
        else:
            continue
        for g, w in pairs:
            assert g.dtype == w.dtype and g.shape == w.shape, name
        # the file's tensors: the trees' difference plus one fp16 rounding
        # (2^-11 relative) of each value
        g, w = (np.concatenate([np.ravel(p[i]).astype(np.float64)
                                for p in pairs]) for i in (0, 1))
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= TREE_REL_L2 + 2 ** -11, (case, name, rel)


@pytest.fixture(scope="module")
def params():
    return base_params()


@pytest.mark.parametrize("case", ["text_prior", "cached_latents"])
def test_train_dreambooth_matches_jax(case, params, tmp_path, monkeypatch):
    j_res, t_res, j_out, t_out = run_both(case, params, tmp_path, monkeypatch)
    check_same_run(case, j_res, t_res, j_out, t_out)


# ---------------------------------------------------------------------------
# the port alone: preemption, refusals
# ---------------------------------------------------------------------------

def _preempt_at(monkeypatch, k):
    """Sends SIGTERM to this process after the k-th micro-step (the
    trainer's guard turns it into a flag it reads before the next one)."""
    real = t_db.make_train_step

    def make_train_step(**kw):
        step = real(**kw)
        calls = [0]

        def hooked(*a, **kw2):
            loss = step(*a, **kw2)
            calls[0] += 1
            if calls[0] == k:
                os.kill(os.getpid(), signal.SIGTERM)
            return loss

        return hooked

    monkeypatch.setattr(t_db, "make_train_step", make_train_step)


def test_preempt_and_resume_gives_the_straight_runs_bits(params, tmp_path,
                                                          monkeypatch):
    flags = dict(BASE, max_train_steps=6, save_steps=0,
                 train_text_encoder=True, use_8bit_adam=True,
                 instance_data_dir=write_images(tmp_path / "one", 1, 3))
    straight = t_db.train_dreambooth(port_pipe(params), t_db.DreamBoothConfig(
        **flags, output_dir=str(tmp_path / "straight")))
    out = tmp_path / "preempted"
    with monkeypatch.context() as m:
        _preempt_at(m, 3)
        first = t_db.train_dreambooth(port_pipe(params),
                                      t_db.DreamBoothConfig(
                                          **flags, output_dir=str(out)))
    assert first["preempted"] and first["steps"] == 3
    files = set(os.listdir(out))
    assert {"train_state.safetensors", "lora_weight_spreempt_3.safetensors",
            "lora_weight_spreempt_3.pt"} <= files
    assert "lora_weight.safetensors" not in files
    resumed = t_db.train_dreambooth(port_pipe(params), t_db.DreamBoothConfig(
        **flags, output_dir=str(tmp_path / "resumed"),
        resume_state=str(out / "train_state.safetensors")))
    assert not resumed["preempted"] and resumed["steps"] == 6
    for a, b in zip(t_optim.tree_leaves(straight["trainable"]),
                    t_optim.tree_leaves(resumed["trainable"])):
        assert torch.equal(a, b)
    assert resumed["final_loss"] == straight["final_loss"]
    # the files carry the same bits
    for name in ("lora_weight.safetensors", "lora_weight.text_encoder.pt"):
        a = (load_file(str(tmp_path / "straight" / name))[0]
             if name.endswith(".safetensors")
             else dict(enumerate(t_pt.load_lora_pt(
                 str(tmp_path / "straight" / name)))))
        b = (load_file(str(tmp_path / "resumed" / name))[0]
             if name.endswith(".safetensors")
             else dict(enumerate(t_pt.load_lora_pt(
                 str(tmp_path / "resumed" / name)))))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_unported_paths_and_bad_flags_raise(params, tmp_path):
    inst = write_images(tmp_path / "inst", 1, 4)
    cfg = t_db.DreamBoothConfig(**dict(BASE, instance_data_dir=inst,
                                       output_dir=str(tmp_path / "o")))
    # SDXL trains the XL way, in the kohya-XL schema only (lora_tpu's
    # refusal of the indexed formats)
    xl = StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu", unet_cfg=TINY_XL_UNET,
        text_cfg=TINY_XL_TEXT, text2_cfg=TINY_XL_TEXT2, vae_cfg=TINY_VAE)
    with pytest.raises(ValueError, match="kohya-XL schema only"):
        t_db.train_dreambooth(xl, cfg)
    res = t_db.train_dreambooth(xl, dataclasses.replace(
        cfg, output_format="safe", max_train_steps=1,
        output_dir=str(tmp_path / "xl")))
    assert res["steps"] == 1 and np.isfinite(res["final_loss"])
    pipe = port_pipe(params)
    # fsdp on a 1-rank group is no mesh (lora_tpu's mesh_from_flags): it
    # trains; tensor parallelism is Slice 7b's
    from test_torch_port_mesh import one_rank_group

    with one_rank_group(tmp_path):
        res = t_db.train_dreambooth(pipe, dataclasses.replace(
            cfg, fsdp=2, max_train_steps=1,
            output_dir=str(tmp_path / "fsdp")))
    assert res["steps"] == 1 and np.isfinite(res["final_loss"])
    with pytest.raises(NotImplementedError, match="Slice 7b"):
        t_db.train_dreambooth(pipe, dataclasses.replace(cfg,
                                                        tensor_parallel=2))
    for bad, match in (({"lora_targets": "locon"}, "kohya schema"),
                       ({"lora_targets": "locon", "output_format": "safe",
                         "resume_unet": "x.pt"}, "resume"),
                       ({"lora_targets": "everything"}, "default|extended")):
        with pytest.raises(ValueError, match=match):
            t_db.train_dreambooth(pipe, dataclasses.replace(cfg, **bad))
    # data_parallel on one device is no mesh: it trains
    res = t_db.train_dreambooth(pipe, dataclasses.replace(
        cfg, data_parallel=True, max_train_steps=1,
        output_dir=str(tmp_path / "dp")))
    assert res["steps"] == 1


def test_class_images_are_pngs(params, tmp_path):
    """generate_class_images writes gen_{i}.png (the port's PNG encoder),
    num_class_images of them, at the training resolution."""
    from lora_tpu_torch.data.png import png_size

    d = tmp_path / "class"
    write_images(d, 1, 5)
    shutil.copy(d / "img_0.png", d / "keep.png")
    cfg = t_db.DreamBoothConfig(class_data_dir=str(d), class_prompt="a dog",
                                num_class_images=4, resolution=SIZE,
                                sample_steps=2, seed=3)
    t_db.generate_class_images(port_pipe(params), cfg)
    made = sorted(f for f in os.listdir(d) if f.startswith("gen_"))
    assert made == ["gen_2.png", "gen_3.png"]
    for f in made:
        assert png_size(str(d / f)) == (SIZE, SIZE)
