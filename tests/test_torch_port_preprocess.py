"""The port's model-backed preprocessing (lora_ppim) against lora_tpu's.

Tiny random BLIP, CLIPSeg and Swin2SR checkpoints are written once for the
module with `transformers`' save_pretrained and hand-rolled vocab files,
as tests/test_preprocess_models.py writes them; lora_tpu's functions run
them through `transformers` and Pillow, the port through its own towers
(models/blip.py, models/clipseg.py, models/swin2sr.py) and numpy. Images
are made with numpy from a seed.

Tolerances: Pillow's resizes and crops, 0 levels (RESAMPLE_TOL); BLIP's
logits under teacher forcing on lora_tpu's tokens, 1e-5 of their largest
magnitude; greedy captions and a sampled caption equal (the sampled one
with the port's torch.Generator seeded as torch.manual_seed was for
lora_tpu's draws, on the CPU); CLIPSeg masks and Swin2SR pixels within
1 level, the share of pixels off by one reported and held under 1%.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("transformers")
Image = pytest.importorskip("PIL.Image")

from lora_tpu_torch.data import preprocess as t_pre  # noqa: E402
from lora_tpu_torch.data import resample  # noqa: E402
from lora_tpu_torch.data.bert_tokenizer import BertTokenizer  # noqa: E402
from lora_tpu_torch.models import blip as t_blip  # noqa: E402
from lora_tpu_torch.models import clipseg as t_seg  # noqa: E402
from lora_tpu_torch.models import swin2sr as t_sr  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

SEED = 3
BLIP_LOGITS_REL = 1e-5
PIXEL_TOL = 1  # levels, CLIPSeg masks and Swin2SR pixels
PIXEL_OFF_SHARE = 0.01  # the largest share of pixels off by PIXEL_TOL
WORDS = ["a", "photo", "of", "person", "dog", "cat", "face"]


def write_clip_vocab(d, words):
    """A CLIP BPE vocab.json / merges.txt over lower-case letters and
    digits whose merges build each of `words`; returns the vocab size."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789")
    toks = (["<|startoftext|>", "<|endoftext|>"] + chars
            + [c + "</w>" for c in chars])
    merges = []
    for w in words:
        pieces = list(w[:-1]) + [w[-1] + "</w>"]
        cur = pieces[0]
        for nxt in pieces[1:]:
            if f"{cur} {nxt}" not in merges:
                merges.append(f"{cur} {nxt}")
            cur += nxt
            if cur not in toks:
                toks.append(cur)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(toks)}, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return len(toks)


@pytest.fixture(scope="module")
def aux(tmp_path_factory):
    """Tiny random checkpoints in the layout _aux_model_dir reads: blip/
    (BLIP's [DEC] and [ENC] added to the vocab as special tokens, [DEC]
    the decoder's bos), clipseg/ (rd64-refined's complex transposed
    convolution at patch 16, a 5x5 grid read from a 4x4 position table),
    clipseg_simple/ (the default transposed convolution) and swin2sr/
    (windows of 4 on a 32 grid: shifted windows and their masks)."""
    from transformers import (BertTokenizer as HFBert, BlipConfig,
                              BlipForConditionalGeneration,
                              BlipImageProcessor, BlipProcessor,
                              BlipTextConfig, BlipVisionConfig,
                              CLIPSegConfig, CLIPSegForImageSegmentation,
                              CLIPSegProcessor, CLIPSegTextConfig,
                              CLIPSegVisionConfig, CLIPTokenizer,
                              Swin2SRConfig, Swin2SRForImageSuperResolution,
                              Swin2SRImageProcessor, ViTImageProcessor)

    base = tmp_path_factory.mktemp("aux_models")
    torch.manual_seed(0)

    blip = str(base / "blip")
    os.makedirs(blip)
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
             + [f"tok{i}" for i in range(40)] + ["##s", ",", "."])
    with open(os.path.join(blip, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    tok = HFBert(os.path.join(blip, "vocab.txt"))
    tok.add_special_tokens({"bos_token": "[DEC]",
                            "additional_special_tokens": ["[ENC]"]})
    tc = BlipTextConfig(vocab_size=len(vocab) + 2, hidden_size=32,
                        num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64, max_position_embeddings=192,
                        bos_token_id=len(vocab), sep_token_id=3,
                        pad_token_id=0, eos_token_id=2)
    vc = BlipVisionConfig(hidden_size=48, num_hidden_layers=2,
                          num_attention_heads=2, intermediate_size=64,
                          image_size=32, patch_size=8)
    BlipForConditionalGeneration(BlipConfig(
        text_config=tc.to_dict(),
        vision_config=vc.to_dict())).save_pretrained(blip)
    BlipProcessor(BlipImageProcessor(size={"height": 32, "width": 32}),
                  tok).save_pretrained(blip)

    for name, complex_ in (("clipseg", True), ("clipseg_simple", False)):
        seg = str(base / name)
        os.makedirs(seg)
        n = write_clip_vocab(seg, WORDS + ["tok"])
        stc = CLIPSegTextConfig(vocab_size=n, hidden_size=32,
                                num_hidden_layers=2, num_attention_heads=2,
                                intermediate_size=64,
                                max_position_embeddings=77, bos_token_id=0,
                                eos_token_id=1, pad_token_id=1)
        svc = CLIPSegVisionConfig(hidden_size=32, num_hidden_layers=3,
                                  num_attention_heads=2,
                                  intermediate_size=64, image_size=64,
                                  patch_size=16)
        CLIPSegForImageSegmentation(CLIPSegConfig(
            text_config=stc.to_dict(), vision_config=svc.to_dict(),
            projection_dim=16, reduce_dim=16, extract_layers=[0, 2],
            decoder_num_attention_heads=2, decoder_intermediate_size=32,
            use_complex_transposed_convolution=complex_)).save_pretrained(
                seg)
        CLIPSegProcessor(
            ViTImageProcessor(size={"height": 80, "width": 80},
                              image_mean=list(t_seg.IMAGENET_MEAN),
                              image_std=list(t_seg.IMAGENET_STD)),
            CLIPTokenizer(os.path.join(seg, "vocab.json"),
                          os.path.join(seg, "merges.txt"),
                          model_max_length=77)).save_pretrained(seg)

    sr = str(base / "swin2sr")
    os.makedirs(sr)
    Swin2SRForImageSuperResolution(Swin2SRConfig(
        embed_dim=16, depths=[2, 2], num_heads=[2, 2], window_size=4,
        image_size=32, upscale=2)).save_pretrained(sr)
    Swin2SRImageProcessor().save_pretrained(sr)
    return str(base)


def _imgs(sizes, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(h, w, 3) * 255).astype(np.uint8) for h, w in sizes]


def _pil(imgs):
    return [Image.fromarray(a) for a in imgs]


def _level_check(ref: np.ndarray, got: np.ndarray, what: str) -> None:
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    diff = np.abs(ref.astype(np.int64) - got)
    share = float((diff > 0).mean())
    assert diff.max() <= PIXEL_TOL, (what, int(diff.max()))
    assert share <= PIXEL_OFF_SHARE, (what, share)


# -- Pillow's arithmetic -----------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("filt", ["BICUBIC", "BILINEAR", "LANCZOS"])
def test_resize_matches_pillow(filt, mode):
    """resize gives Pillow's bytes up, down, at odd sizes, one side at a
    time and both, on gray and RGB images, and on both with an alpha
    channel (Pillow resamples those premultiplied) whose levels include
    0 and 255."""
    f = getattr(resample, filt)
    rs = np.random.RandomState(len(filt) + len(mode))
    for h, w in [(1, 1), (7, 5), (40, 48), (33, 97), (577, 311)]:
        shape = (h, w) if mode == "L" else (h, w, len(mode))
        a = (rs.rand(*shape) * 255).astype(np.uint8)
        if mode.endswith("A"):
            a[..., -1][rs.rand(h, w) < 0.2] = 0
            a[..., -1][rs.rand(h, w) < 0.2] = 255
        for size in [(2 * w + 1, 3 * h), (max(1, w // 3), max(1, h // 2)),
                     (64, 64), (384, 384), (w, h + 5), (w + 3, h),
                     (w, h)]:
            ref = np.asarray(Image.fromarray(a, mode).resize(size, f))
            got = resample.resize(a, size, f)
            assert ref.shape == got.shape
            assert np.abs(ref.astype(np.int64) - got).max() <= \
                resample.RESAMPLE_TOL, (filt, mode, (h, w), size)


def test_crop_matches_pillow():
    """A float box is rounded as Pillow rounds it (round half to even),
    the part outside the image zero, gray and RGB."""
    rs = np.random.RandomState(1)
    for shape in [(40, 48, 3), (40, 48)]:
        a = (rs.rand(*shape) * 255).astype(np.uint8)
        for box in [(0.5, 0, 40.5, 40), (1.5, 2.49, 20.5, 30.51),
                    (2.6, 0, 42.6, 40), (-3, -2, 10, 10),
                    (30, 20, 60, 50), (3.5, 4.5, 3.5, 9.5)]:
            ref = np.asarray(Image.fromarray(a).crop(box))
            np.testing.assert_array_equal(resample.crop(a, box), ref)
    with pytest.raises(ValueError):
        resample.crop(a, (5, 0, 2, 4))


def test_salience_crop_matches_lora_tpu():
    """_center_of_mass and _crop_to_square (with and without the LANCZOS
    resize) give lora_tpu's values and bytes, wide and tall, including
    centroids that land on half pixels."""
    from lora_tpu.data import preprocess as j_pre

    rs = np.random.RandomState(2)
    for h, w in [(100, 200), (120, 90), (64, 64), (37, 81)]:
        mask = np.zeros((h, w), np.uint8)
        mask[rs.randint(h // 2):, rs.randint(w // 2):] = rs.randint(1, 255)
        img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
        com = t_pre._center_of_mass(mask)
        assert com == j_pre._center_of_mass(Image.fromarray(mask, "L"))
        for c in (com, (w / 2 + 0.5, h / 2 + 0.5), (0, 0)):
            for resize_to in (None, 48):
                ref = np.asarray(j_pre._crop_to_square(Image.fromarray(img),
                                                       c, resize_to))
                np.testing.assert_array_equal(
                    t_pre._crop_to_square(img, c, resize_to), ref)
    assert t_pre._center_of_mass(np.zeros((40, 60), np.uint8)) == (30, 20)


# -- the BERT tokenizer -------------------------------------------------------

def test_bert_tokenizer_matches_transformers(aux):
    """encode ([CLS] ... [SEP], lower case, accents, punctuation, CJK,
    [UNK], the added tokens whole) and decode (special tokens skipped or
    kept, ## merged, clean-up) against BlipProcessor's tokenizer."""
    from transformers import BlipProcessor

    d = os.path.join(aux, "blip")
    hf = BlipProcessor.from_pretrained(d).tokenizer
    me = BertTokenizer.from_dir(d)
    assert len(me) == len(hf)
    for text in ["a photo of a dog", "A Photo, of CATs!", "Café dogs .",
                 "中文 a", "[DEC] a [ENC]dog", "xyz unknownword",
                 "a\tb\x00c", "tok1tok2 , tok3."]:
        assert me.encode(text) == hf(text)["input_ids"], text
    rs = np.random.RandomState(0)
    for _ in range(200):
        ids = rs.randint(0, len(hf), rs.randint(1, 12)).tolist()
        for skip in (True, False):
            assert me.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), ids


# -- BLIP ---------------------------------------------------------------------

@pytest.fixture
def lora_tpu_blip_calls(monkeypatch):
    """lora_tpu's BLIP generate calls, recorded (kwargs and ids), with
    torch's global RNG seeded with SEED before the first, and overrides
    of their kwargs."""
    from transformers import BlipForConditionalGeneration

    orig = BlipForConditionalGeneration.generate
    calls, overrides = [], {}

    def generate(self, *args, **kw):
        if not calls:
            torch.manual_seed(SEED)
        kw.update(overrides)
        out = orig(self, *args, **kw)
        calls.append((kw, out))
        return out

    monkeypatch.setattr(BlipForConditionalGeneration, "generate", generate)
    return calls, overrides


@pytest.fixture
def port_blip_overrides(monkeypatch):
    orig = t_blip.BlipCaptioner.caption
    overrides = {}

    def caption(self, image, text=None, **kw):
        kw.update(overrides)
        return orig(self, image, text, **kw)

    monkeypatch.setattr(t_blip.BlipCaptioner, "caption", caption)
    return overrides


@pytest.mark.parametrize("text", [None, "a photo of"])
def test_blip_logits_under_teacher_forcing(aux, text, lora_tpu_blip_calls):
    """The port's logits at every position of lora_tpu's sampled tokens
    (its call, its prompt) within BLIP_LOGITS_REL of transformers' model,
    from the same pixels."""
    from lora_tpu.data.preprocess import blip_captioning_dataset
    from transformers import BlipForConditionalGeneration, BlipProcessor

    d = os.path.join(aux, "blip")
    imgs = _imgs([(40, 48), (23, 61)])
    blip_captioning_dataset(_pil(imgs), text=text, model_dir=d)
    calls, _ = lora_tpu_blip_calls
    hf = BlipForConditionalGeneration.from_pretrained(d).eval()
    proc = BlipProcessor.from_pretrained(d)
    cap = t_blip.BlipCaptioner(d, device="cpu")
    for img, (kw, ids) in zip(imgs, calls):
        assert kw["max_length"] == 150 and kw["top_k"] == 50
        px = proc(Image.fromarray(img), return_tensors="pt")["pixel_values"]
        mine_px = cap.pixels([img])
        assert torch.equal(mine_px, px.permute(0, 2, 3, 1))
        with torch.no_grad():
            ref = hf(pixel_values=px, input_ids=ids).logits
        got = t_blip.caption_logits(cap.params, mine_px, ids, cap.cfg)
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= BLIP_LOGITS_REL, err


@pytest.mark.parametrize("text", [None, "a photo of"])
def test_blip_greedy_captions_equal(aux, text, lora_tpu_blip_calls,
                                    port_blip_overrides):
    """With top_k=1 (greedy) both functions give the same captions and
    the port's generate gives lora_tpu's ids, prompt included."""
    from lora_tpu.data.preprocess import blip_captioning_dataset

    d = os.path.join(aux, "blip")
    calls, overrides = lora_tpu_blip_calls
    overrides["top_k"] = port_blip_overrides["top_k"] = 1
    imgs = _imgs([(40, 48), (23, 61), (64, 64)], seed=4)
    ref = blip_captioning_dataset(_pil(imgs), text=text, model_dir=d)
    got = t_pre.blip_captioning_dataset(imgs, text=text, model_dir=d,
                                        device="cpu", seed=0)
    assert got == ref and all(isinstance(c, str) for c in got)
    cap = t_blip.BlipCaptioner(d, device="cpu")
    for img, (_, ids) in zip(imgs, calls):
        mine = cap.generate(img, text, do_sample=False)
        assert torch.equal(mine, ids)


def test_blip_sampled_caption_equal_with_a_seeded_generator(
        aux, lora_tpu_blip_calls):
    """lora_tpu's sampled captions (max_length 150, top_k 50, temperature
    0.7) after torch.manual_seed(SEED) equal the port's with a
    torch.Generator seeded SEED: the same filtered distribution and the
    same draws, in the same order over the images (on the CPU)."""
    from lora_tpu.data.preprocess import blip_captioning_dataset

    d = os.path.join(aux, "blip")
    imgs = _imgs([(40, 48), (23, 61)], seed=5)
    ref = blip_captioning_dataset(_pil(imgs), model_dir=d)
    got = t_pre.blip_captioning_dataset(imgs, model_dir=d, device="cpu",
                                        seed=SEED)
    assert got == ref
    gen = torch.Generator().manual_seed(SEED)
    again = t_pre.blip_captioning_dataset(imgs, model_dir=d, device="cpu",
                                          generator=gen)
    assert again == ref


@pytest.mark.parametrize("settings", [
    {}, {"repetition_penalty": 1.3}, {"min_length": 9}, {"top_p": 0.8},
    {"repetition_penalty": 0.7, "min_length": 4, "top_p": 0.5}])
@pytest.mark.parametrize("do_sample", [True, False])
def test_blip_filtered_distribution_matches_transformers(settings,
                                                         do_sample):
    """process_scores equals transformers' LogitsProcessorList in its
    order (repetition penalty, min length, then temperature, top-k, top-p
    when sampling) on random scores, bit for bit."""
    from transformers.generation import logits_process as lp

    procs = []
    if settings.get("repetition_penalty", 1.0) != 1.0:
        procs.append(lp.RepetitionPenaltyLogitsProcessor(
            settings["repetition_penalty"]))
    if settings.get("min_length", 0):
        procs.append(lp.MinLengthLogitsProcessor(settings["min_length"], 3))
    if do_sample:
        procs += [lp.TemperatureLogitsWarper(0.7), lp.TopKLogitsWarper(50)]
        if settings.get("top_p", 1.0) < 1.0:
            procs.append(lp.TopPLogitsWarper(settings["top_p"]))
    g = torch.Generator().manual_seed(0)
    scores = torch.randn(2, 300, generator=g) * 3
    ids = torch.randint(0, 300, (2, 6), generator=g)
    ref = lp.LogitsProcessorList(procs)(ids, scores.clone())
    got = t_blip.process_scores(ids, scores.clone(), do_sample=do_sample,
                                top_k=50, temperature=0.7, stop_id=3,
                                **settings)
    assert torch.equal(got, ref)
    if do_sample:
        assert int(torch.isfinite(got).sum(-1).max()) <= 50


def test_blip_generation_config_is_applied_or_refused(aux, tmp_path):
    """A generation_config.json's repetition_penalty, min_length and top_p
    reach the processors; a setting the port does not apply is refused."""
    assert t_blip.generation_settings({"repetition_penalty": 1.2,
                                       "min_length": 5, "top_p": 0.9,
                                       "bos_token_id": 5}) == {
        "repetition_penalty": 1.2, "min_length": 5, "top_p": 0.9}
    with pytest.raises(ValueError, match="no_repeat_ngram_size"):
        t_blip.generation_settings({"no_repeat_ngram_size": 3})
    with pytest.raises(ValueError, match="num_beams"):
        t_blip.generation_settings({"num_beams": 4})


# -- CLIPSeg ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["clipseg", "clipseg_simple"])
def test_clipseg_masks_match_lora_tpu(aux, name):
    """Masks within PIXEL_TOL levels of lora_tpu's clipseg_mask_generator
    (the share off by one under PIXEL_OFF_SHARE), at each image's size,
    with prompts the tokenizer pads and one it truncates; the logits
    against transformers' from the same ids and pixels."""
    from lora_tpu.data.preprocess import clipseg_mask_generator
    from transformers import CLIPSegForImageSegmentation, CLIPSegProcessor

    d = os.path.join(aux, name)
    imgs = _imgs([(40, 48), (61, 23), (80, 80)], seed=6)
    prompts = ["a face", "photo of a dog tok12 cat xyz",
               " ".join(["person"] * 100)]
    for temp in (1.0, 0.5):
        ref = clipseg_mask_generator(_pil(imgs), prompts, model_dir=d,
                                     temp=temp)
        got = t_pre.clipseg_mask_generator(imgs, prompts, model_dir=d,
                                           temp=temp, device="cpu")
        for r, g in zip(ref, got):
            assert r.mode == "L"
            _level_check(np.asarray(r), g, "clipseg mask")
    hf = CLIPSegForImageSegmentation.from_pretrained(d).eval()
    proc = CLIPSegProcessor.from_pretrained(d)
    masker = t_seg.CLIPSegMasker(d, device="cpu")
    for img, p in zip(imgs, prompts):
        inp = proc(text=[p], images=[Image.fromarray(img)],
                   padding="max_length", truncation=True, return_tensors="pt")
        assert inp["input_ids"].tolist() == masker.input_ids([p]).tolist()
        with torch.no_grad():
            ref = hf(**inp).logits
        got = masker.logits(img, p)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


# -- Swin2SR ------------------------------------------------------------------

def test_swin2sr_matches_lora_tpu(aux):
    """Same shapes (the processor's padding kept, twice the size) and
    pixels within PIXEL_TOL levels of lora_tpu's swin_ir_sr; an image as
    wide as the target passes through untouched."""
    from lora_tpu.data.preprocess import swin_ir_sr

    d = os.path.join(aux, "swin2sr")
    imgs = _imgs([(24, 24), (17, 30), (40, 40), (20, 64)], seed=7)
    ref = swin_ir_sr(_pil(imgs), target_size=(48, 48), model_dir=d)
    got = t_pre.swin_ir_sr(imgs, target_size=(48, 48), model_dir=d,
                           device="cpu")
    for r, g, img in zip(ref, got, imgs):
        _level_check(np.asarray(r), g, "swin2sr")
    assert got[3] is imgs[3]
    assert got[0].shape == (64, 64, 3) and got[1].shape == (48, 64, 3)


# -- loading ------------------------------------------------------------------

def test_towers_load_strictly_and_refuse_a_missing_card(aux, tmp_path):
    """Each tower loads its directory strictly: an extra or a missing
    weight, or one of the wrong shape, raises naming it. Asked for the
    card without one, each tower and each stage with a directory raises."""
    import shutil

    from lora_tpu_torch.formats.reader import load_file, save_file

    for name, cls in (("blip", t_blip.BlipCaptioner),
                      ("clipseg", t_seg.CLIPSegMasker),
                      ("swin2sr", t_sr.Swin2SRUpscaler)):
        src = os.path.join(aux, name)
        tensors, meta = load_file(os.path.join(src, "model.safetensors"))
        key = sorted(tensors)[len(tensors) // 2]
        for change, what in (("extra", "unexpected"),
                             ("missing", "missing"), ("shape", "wrong")):
            d = tmp_path / f"{name}_{change}"
            shutil.copytree(src, d)
            t = dict(tensors)
            if change == "extra":
                t["extra.weight"] = np.zeros(3, np.float32)
            elif change == "missing":
                del t[key]
            else:
                t[key] = np.zeros((1,) + t[key].shape, t[key].dtype)
            save_file(t, str(d / "model.safetensors"), metadata=meta)
            with pytest.raises(ValueError, match=what):
                cls(str(d), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                cls(src)
    if not torch.cuda.is_available():
        img = _imgs([(20, 20)])
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pre.blip_captioning_dataset(img, model_dir=os.path.join(
                aux, "blip"))
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pre.clipseg_mask_generator(img, "a", model_dir=os.path.join(
                aux, "clipseg"))
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pre.swin_ir_sr(img, (64, 64), model_dir=os.path.join(
                aux, "swin2sr"))


def test_chip_smoke_checkpoints_load_in_transformers(tmp_path):
    """chip_smoke.py's phase 18 writes its checkpoint directories without
    transformers (vocab files, configs, safetensors from the port's
    random init): at tiny widths transformers' processors and models
    (lora_tpu's functions) read them, and the port's towers agree with
    them there."""
    import importlib.util

    from lora_tpu.data.preprocess import (blip_captioning_dataset,
                                          clipseg_mask_generator, swin_ir_sr)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    dirs = chip_smoke.ppim_write_checkpoints(
        str(tmp_path), torch.Generator().manual_seed(0), "cpu",
        chip_smoke.PPIM_TINY_BLIP, chip_smoke.PPIM_TINY_CLIPSEG,
        chip_smoke.PPIM_TINY_SWIN2SR)
    imgs = _imgs([(40, 48), (30, 22)], seed=8)
    ref = blip_captioning_dataset(_pil(imgs), text="a photo of",
                                  model_dir=dirs["blip"])
    assert all(isinstance(c, str) for c in ref)
    from transformers import BlipProcessor

    hf_tok = BlipProcessor.from_pretrained(dirs["blip"]).tokenizer
    cap = t_blip.BlipCaptioner(dirs["blip"], device="cpu")
    for text in ("a photo of", "w12 w7, photo"):
        assert cap.tokenizer.encode(text) == hf_tok(text)["input_ids"]
    assert cap.tokenizer.token_id("bos_token") == cap.cfg.text.bos_token_id
    masks = clipseg_mask_generator(_pil(imgs), ["a photo of w12", "w7"],
                                   model_dir=dirs["clipseg"])
    got = t_pre.clipseg_mask_generator(imgs, ["a photo of w12", "w7"],
                                       model_dir=dirs["clipseg"],
                                       device="cpu")
    for r, g in zip(masks, got):
        _level_check(np.asarray(r), g, "clipseg mask")
    sr = swin_ir_sr(_pil(imgs), target_size=(64, 64),
                    model_dir=dirs["swin2sr"])
    for r, g in zip(sr, t_pre.swin_ir_sr(imgs, (64, 64),
                                         model_dir=dirs["swin2sr"],
                                         device="cpu")):
        _level_check(np.asarray(r), g, "swin2sr")


# -- the entry point and the CLI --------------------------------------------------

def _png_inputs(root, sizes, seed=9):
    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(_imgs(sizes, seed)):
        Image.fromarray(img).save(os.path.join(root, f"im{i}.png"))
    return root


def _same_dataset(a, b, n):
    assert open(os.path.join(a, "caption.txt")).read() == \
        open(os.path.join(b, "caption.txt")).read()
    for i in range(n):
        for f in (f"{i}.src.jpg", f"{i}.mask.png"):
            x = np.asarray(Image.open(os.path.join(a, f)))
            y = np.asarray(Image.open(os.path.join(b, f)))
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


@pytest.mark.parametrize("models", [False, True])
@pytest.mark.parametrize("face", [False, True])
def test_entry_point_matches_lora_tpu(aux, tmp_path, monkeypatch, models, face,
                                 lora_tpu_blip_calls):
    """load_and_save_masks_and_captions on PNG inputs (one gray) with
    every model found under LORA_TPU_AUX_MODELS, or none (the fallbacks),
    CLIPSeg or face masks: caption.txt equal, masks equal once decoded,
    {i}.src.jpg equal once Pillow decodes both (the port's BLIP draws from
    a generator seeded SEED, lora_tpu's after torch.manual_seed(SEED)).
    The output loads through the port's PivotalTuningDataset."""
    from lora_tpu.data.preprocess import (
        load_and_save_masks_and_captions as j_run)

    from lora_tpu_torch.data.dataset import PivotalTuningDataset
    from lora_tpu_torch.data.tokenizer import CLIPTokenizer

    src = _png_inputs(str(tmp_path / "raw"), [(56, 72), (90, 40), (30, 30)])
    gray = (np.random.RandomState(1).rand(50, 66) * 255).astype(np.uint8)
    Image.fromarray(gray, "L").save(os.path.join(src, "im3.png"))
    if models:
        aux_dir = tmp_path / "aux"
        aux_dir.mkdir()
        for name in ("blip", "clipseg", "swin2sr"):
            os.symlink(os.path.join(aux, name), aux_dir / name)
        monkeypatch.setenv("LORA_TPU_AUX_MODELS", str(aux_dir))
    else:
        monkeypatch.delenv("LORA_TPU_AUX_MODELS", raising=False)
    a, b = str(tmp_path / "j"), str(tmp_path / "t")
    ref = j_run(src, a, target_size=64, use_face_detection_instead=face)
    got = t_pre.load_and_save_masks_and_captions(
        src, b, target_size=64, use_face_detection_instead=face,
        device="cpu", seed=SEED)
    assert got == ref and len(got) == 4
    _same_dataset(a, b, 4)
    ds = PivotalTuningDataset(b, CLIPTokenizer(vocab_size=1000),
                              use_mask_captioned_data=True, size=64, seed=0)
    ex = ds[0]
    assert ex["instance_images"].shape == (64, 64, 3)
    assert ex["mask"].shape[:2] == (64, 64)


def test_stages_return_arrays(aux, monkeypatch):
    """preprocess_images returns captions, (target, target, 3) images and
    (target, target) masks without writing anything; n_length and a
    caption prompt reach the stages."""
    monkeypatch.delenv("LORA_TPU_AUX_MODELS", raising=False)
    caps, imgs, masks = t_pre.preprocess_images(
        _imgs([(56, 72), (90, 40)]), caption_text="a photo of",
        target_size=48, device="cpu")
    assert caps == ["a photo of a person"] * 2
    assert [i.shape for i in imgs] == [(48, 48, 3)] * 2
    assert [m.shape for m in masks] == [(48, 48)] * 2
    assert all(i.dtype == np.uint8 for i in imgs + masks)


def test_cli_matches_the_library_and_needs_pillow(aux, tmp_path, monkeypatch):
    """lora_ppim's main (fire over load_and_save_masks_and_captions) writes
    the library's files with --device cpu --seed; where Pillow cannot be
    imported the entry point raises naming it before any tower loads."""
    from lora_tpu_torch.cli import lora_ppim

    src = _png_inputs(str(tmp_path / "raw"), [(56, 72), (30, 30)])
    aux_dir = tmp_path / "aux"
    aux_dir.mkdir()
    for name in ("blip", "clipseg", "swin2sr"):
        os.symlink(os.path.join(aux, name), aux_dir / name)
    monkeypatch.setenv("LORA_TPU_AUX_MODELS", str(aux_dir))
    a, b = str(tmp_path / "lib"), str(tmp_path / "cli")
    t_pre.load_and_save_masks_and_captions(src, a, target_size=48,
                                           device="cpu", seed=1)
    monkeypatch.setattr(sys, "argv", [
        "lora_ppim", src, b, "--target_size", "48", "--device", "cpu",
        "--seed", "1", "--n_length", "2"])
    lora_ppim.main()
    _same_dataset(a, b, 2)

    import builtins

    real_import = builtins.__import__

    def no_pillow(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow here")
        return real_import(name, *args, **kw)

    def loaded(*a, **k):
        raise AssertionError("a tower loaded before the Pillow check")

    monkeypatch.setattr(builtins, "__import__", no_pillow)
    monkeypatch.setattr(t_blip.BlipCaptioner, "__init__", loaded)
    with pytest.raises(RuntimeError, match="Pillow"):
        t_pre.load_and_save_masks_and_captions(src, str(tmp_path / "none"),
                                               device="cpu")
    assert not os.path.exists(tmp_path / "none")
