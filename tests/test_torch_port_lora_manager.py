"""The port's lora_join and LoRAManager (lora_tpu_torch/lora_manager.py) and
apply_ti(idempotent=False) against lora_tpu's on the tiny configs, in
f32: the joined tensors, metadata, rank list and token counts equal to
lora_tpu's; LoRAManager's UNet call and text encoding within 1e-5 of
lora_tpu's, before and after tune; tune's selector on the UNet LoRA
alone; prompt's rewriting; the refusals with lora_tpu's messages; and the
renaming of a token already in the tokenizer, with the token table."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu import lora_manager as j_mgr  # noqa: E402
from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.models.unet import unet_forward as j_unet_forward  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu_torch import lora_manager as t_mgr  # noqa: E402
from lora_tpu_torch.formats.safetensors_io import (  # noqa: E402
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    safe_open,
    save_safeloras_with_embeds,
)
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

REL = 1e-5
PROMPTS = ["a <1> photo of <2>", "a town"]


def make_pipes(seed=0):
    """(the JAX pipe, the port's pipe) holding the same random params."""
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(seed), "cpu", unet_cfg=j_cfg.TINY_UNET,
        text_cfg=j_cfg.TINY_TEXT, vae_cfg=j_cfg.TINY_VAE)
    unet_p, text_p, vae_p = (
        {k: jnp.asarray(v.numpy()) for k, v in m.state_dict().items()}
        for m in (pipe.unet, pipe.text_encoder, pipe.vae))
    jpipe = JPipe(unet_params=unet_p, text_params=text_p, vae_params=vae_p,
                  tokenizer=JTokenizer(vocab_size=j_cfg.TINY_TEXT.vocab_size),
                  unet_cfg=j_cfg.TINY_UNET, text_cfg=j_cfg.TINY_TEXT,
                  vae_cfg=j_cfg.TINY_VAE)
    return jpipe, pipe


def _pairs(sites, r, seed):
    """Random factors at the scales of the kohya tests (up 0.1, down 0.3):
    several times larger deltas turn the random tiny UNet chaotic, and two
    f32 orders of summation then part by more than the limit."""
    rng = np.random.default_rng(seed)
    return [((0.1 * rng.standard_normal((s.out_dim, r))).astype(np.float32),
             (0.3 * rng.standard_normal((r, s.in_dim))).astype(np.float32))
            for s in sites]


def write_lora(pipe, path, seed, tokens, r=2, models=("unet", "text_encoder"),
               text_r=None):
    rng = np.random.default_rng(seed + 50)
    modelmap = {}
    if "unet" in models:
        modelmap["unet"] = (_pairs(pipe.unet_sites(), r, seed),
                            UNET_DEFAULT_TARGET_REPLACE)
    if "text_encoder" in models:
        modelmap["text_encoder"] = (
            _pairs(pipe.text_sites(), text_r or r, seed + 1),
            TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    save_safeloras_with_embeds(
        modelmap, {t: rng.standard_normal(32).astype(np.float32)
                   for t in tokens}, path, cast_fp16=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mgr")
    _, pipe = make_pipes()
    paths = [str(root / "one.safetensors"), str(root / "two.safetensors")]
    write_lora(pipe, paths[0], 1, ["<x>", "<y>"])
    write_lora(pipe, paths[1], 5, ["<z>"], r=3)
    return paths


def test_lora_join_matches(files):
    handles = [safe_open(p) for p in files]
    got = t_mgr.lora_join(handles)
    want = j_mgr.lora_join(handles)
    for h in handles:
        h.close()
    tt, mt, rt, nt = got
    tj, mj, rj, nj = want
    assert (rt, nt) == (rj, nj) == ([2, 3], [2, 1])
    assert mt == mj and mt["unet:0:rank"] == "5"
    assert list(tt) == list(tj)
    for k in tj:
        a, b = np.asarray(tj[k]), np.asarray(tt[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


def _unet_call(jpipe, pipe, seed=3):
    cfg = pipe.unet.cfg
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, cfg.in_channels)).astype(np.float32)
    t = np.array([11, 700])
    ctx = rng.standard_normal((2, 5, cfg.cross_attention_dim)).astype(
        np.float32)
    want = np.asarray(j_unet_forward(
        jpipe.unet_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        jpipe.unet_cfg, lora=jpipe.lora_unet))
    with torch.inference_mode():
        got = pipe.unet(torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(ctx), lora=pipe.lora_unet).numpy()
    return got, want


def assert_close(got, want, rel=REL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_manager_unet_and_text(files):
    """LoRAManager on both pipes: the UNet call and the encoding of the
    rewritten prompts within 1e-5 of lora_tpu's, before and after tune."""
    jpipe, pipe = make_pipes()
    jm = j_mgr.LoRAManager(files, jpipe)
    tm = t_mgr.LoRAManager(files, pipe)
    assert (tm.ranklist, tm.token_size_list) == (jm.ranklist,
                                                 jm.token_size_list)
    prompts = [tm.prompt(p) for p in PROMPTS]
    assert prompts == [jm.prompt(p) for p in PROMPTS]
    assert prompts[0] == "a <s0-0><s0-1> photo of <s1-0>"
    assert pipe.tokenizer(prompts) == jpipe.tokenizer(prompts)
    for scales in (None, [0.5, 0.2]):
        if scales is not None:
            jm.tune(scales)
            tm.tune(scales)
        got, want = _unet_call(jpipe, pipe)
        assert_close(got, want)
        assert_close(pipe.encode_prompt(prompts).numpy(),
                     np.asarray(jpipe.encode_prompt(prompts)))
    table = "text_model.embeddings.token_embedding.weight"
    np.testing.assert_array_equal(
        pipe.text_encoder.get_parameter(table).numpy(),
        np.asarray(jpipe.text_params[table]))


def test_tune_gates_only_the_unet(files):
    """tune(scales): the UNet LoRA's every site carries the selector, each
    file's scale repeated over its rank; the text LoRA carries none;
    tune([1, 0]) is file 1's adapter alone."""
    _, pipe = make_pipes()
    mgr = t_mgr.LoRAManager(files, pipe)
    mgr.tune([0.5, 0.25])
    for entry in pipe.lora_unet["sites"].values():
        np.testing.assert_array_equal(entry["diag"].numpy(),
                                      [0.5, 0.5, 0.25, 0.25, 0.25])
    assert all("diag" not in e for e in pipe.lora_text["sites"].values())
    mgr.tune([1.0, 0.0])
    got = _unet_call_port(pipe)
    _, alone = make_pipes()
    alone.patch_pipe(files[0])
    assert_close(got, _unet_call_port(alone))
    with pytest.raises(ValueError, match=r"need one scale per joined LoRA "
                                         r"\(2\), got 3"):
        mgr.tune([1.0, 1.0, 1.0])
    assert mgr.prompt(None) is None
    assert mgr.prompt("<2> and <1>") == "<s1-0> and <s0-0><s0-1>"


def _unet_call_port(pipe, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 32)).astype(np.float32)
    with torch.inference_mode():
        return pipe.unet(torch.from_numpy(x), torch.tensor([11, 700]),
                         torch.from_numpy(ctx),
                         lora=pipe.lora_unet).numpy()


def _same_error(fn_j, fn_t):
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)
    return str(et.value)


def test_refusals(files, tmp_path):
    _, pipe = make_pipes()
    mixed = str(tmp_path / "mixed.safetensors")
    write_lora(pipe, mixed, 9, [], r=2, text_r=3)
    unet_only = str(tmp_path / "unet_only.safetensors")
    write_lora(pipe, unet_only, 11, [], models=("unet",))

    def join(mod, paths):
        handles = [safe_open(p) for p in paths]
        try:
            return mod.lora_join(handles)
        finally:
            for h in handles:
                h.close()

    msg = _same_error(lambda: join(j_mgr, [files[0], mixed]),
                      lambda: join(t_mgr, [files[0], mixed]))
    assert msg == "Rank should be the same per model"
    msg = _same_error(lambda: join(j_mgr, [files[0], unet_only]),
                      lambda: join(t_mgr, [files[0], unet_only]))
    assert "absent from input file(s) [1]" in msg
    with pytest.raises(ValueError, match="absent from input file"):
        t_mgr.LoRAManager([files[0], unet_only], pipe)


def test_apply_ti_renames_when_not_idempotent():
    """apply_ti(idempotent=False): a token already in the tokenizer is
    renamed as lora_tpu renames it (<t-1>, then <t-1-2>, ...); the rows land
    in a grown table at the same ids as lora_tpu's. idempotent=True writes
    over the existing row."""
    jpipe, pipe = make_pipes()
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal(32).astype(np.float32) for _ in range(4)]
    table = "text_model.embeddings.token_embedding.weight"
    calls = [({"<t>": rows[0]}, True), ({"<t>": rows[1]}, False),
             ({"<t>": rows[2]}, False), ({"<t>": rows[3], "<u>": rows[0]},
                                         True)]
    for embeds, idem in calls:
        got = pipe.apply_ti(embeds, idempotent=idem)
        want = jpipe.apply_ti(embeds, idempotent=idem)
        assert got == want
    assert pipe.tokenizer.added_tokens == jpipe.tokenizer.added_tokens
    assert list(pipe.tokenizer.added_tokens) == ["<t>", "<t-1>", "<t-1-2>",
                                                 "<u>"]
    got = pipe.text_encoder.get_parameter(table).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpipe.text_params[table]))
    assert got.shape[0] == 1000 + 4
    ids = pipe.tokenizer.added_tokens
    np.testing.assert_array_equal(got[ids["<t>"]], rows[3])
    np.testing.assert_array_equal(got[ids["<t-1>"]], rows[1])
    np.testing.assert_array_equal(got[ids["<t-1-2>"]], rows[2])
