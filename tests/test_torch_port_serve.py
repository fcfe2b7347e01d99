"""The port's serving endpoint (lora_tpu_torch/serve.py) on the tiny CPU
pipeline with int8 base weights: the behaviour of tests/test_serve.py
(micro-batching, buckets, warmup, the embed cache, backpressure, drain, the
crash path, admit-time validation), the image modes (img2img, latent-blend
and 9-channel inpaint: serving, coalescing by mode and strength, the
rejections lora_tpu makes at admit, the embed cache, warmup, shedding
before the PNG decode), every sampler served and an unknown one refused at
admit, HTTP pixels equal to a direct pipeline call, the quantized pipeline
against lora_tpu's, the stdlib PNG encoder against lora_tpu's Pillow one,
SDXL pipelines (the embed cache of (context, pooled) pairs, te2's adapter
in the embed key, inpainting by latent blending, main() serving an SDXL
directory), and main()'s argument validation."""

import base64
import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from lora_tpu.data.tokenizer import CLIPTokenizer as JTokenizer  # noqa: E402
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.pipelines.sd import StableDiffusionPipeline as JPipe  # noqa: E402
from lora_tpu_torch import serve as t_serve  # noqa: E402
from lora_tpu_torch.core.lora import init_lora, lora_to_pairs  # noqa: E402
from lora_tpu_torch.models.config import (  # noqa: E402
    TINY_TEXT,
    TINY_UNET,
    TINY_VAE,
    TINY_XL_TEXT,
    TINY_XL_TEXT2,
    TINY_XL_UNET,
)
from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline  # noqa: E402
from lora_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline  # noqa: E402
from lora_tpu_torch.serve import (  # noqa: E402
    PipelineServer,
    SchedulerDown,
    ServerOverloaded,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

# the quantized tiny pipeline, port vs lora_tpu with every 2-D int8 dense on
# its Pallas kernel: both round each dense input to bf16, so f32 differences
# in the sum order flip some of those roundings (2^-8 relative) in later
# layers; the JAX UNet moves by up to 8e-4 of its output range under a 1e-7
# input perturbation alone (tests/test_torch_port_quantize.py). Images in
# [0, 1] after 2 steps and the VAE: 4x the measured gap (4.5e-3 max,
# 3.3e-4 mean).
IMAGE_MAX_ABS, IMAGE_MEAN_ABS = 2e-2, 1.5e-3


def _tiny_pipe(in_channels=4):
    import dataclasses

    return StableDiffusionPipeline.random_init(
        torch.Generator().manual_seed(0), "cpu",
        unet_cfg=dataclasses.replace(TINY_UNET, in_channels=in_channels),
        text_cfg=TINY_TEXT, vae_cfg=TINY_VAE)


@pytest.fixture(scope="module")
def server():
    pipe = _tiny_pipe()
    pipe.quantize_base()
    srv = PipelineServer(pipe, port=0).start()
    yield srv
    srv.stop()


def _post(srv, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read()), r.status


def _status(srv, payload):
    try:
        return _post(srv, payload)[1], None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body["ok"] is True and body["devices"]


def test_generate(server):
    out, status = _post(server, {"prompt": "a tiny tree", "steps": 2,
                                 "height": 64, "width": 64, "seed": 1})
    assert status == 200
    assert len(out["images"]) == 1 and out["latency_ms"] > 0
    png = base64.b64decode(out["images"][0])
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_generate_batch_and_errors(server):
    out, status = _post(server, {"prompt": ["a", "b"], "steps": 2,
                                 "height": 64, "width": 64})
    assert status == 200 and len(out["images"]) == 2
    assert _status(server, {"steps": "NaN?"})[0] == 400
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/nope", timeout=30)
        missing = False
    except urllib.error.HTTPError as e:
        missing = e.code == 404
    assert missing


def test_micro_batching_coalesces_concurrent_requests(server):
    """Concurrent same-config requests are served in ONE device batch, each
    keeping its own seed."""
    results = {}

    def fire(name, seed):
        results[name] = _post(server, {"prompt": "a tiny tree", "steps": 2,
                                       "height": 64, "width": 64,
                                       "seed": seed})

    # occupy the worker so the followers queue up together
    lead = threading.Thread(target=fire, args=("lead", 0))
    lead.start()
    time.sleep(0.3)
    followers = [threading.Thread(target=fire, args=(f"f{i}", i + 1))
                 for i in range(3)]
    for t in followers:
        t.start()
    for t in [lead] + followers:
        t.join()
    assert all(status == 200 for _, status in results.values())
    sizes = {k: out["batched_with"] for k, (out, _) in results.items()}
    assert max(sizes.values()) >= 2, sizes
    assert results["f0"][0]["images"][0] != results["f1"][0]["images"][0]


def test_embed_cache_hits_and_determinism(server):
    payload = {"prompt": "a cached prompt", "steps": 2,
               "height": 64, "width": 64, "seed": 7}
    out1, _ = _post(server, payload)
    h0 = server.embed_cache_hits
    out2, _ = _post(server, payload)
    # second request: prompt AND negative prompt both hit the cache
    assert server.embed_cache_hits >= h0 + 2
    assert out1["images"] == out2["images"]


def test_embed_cache_tracks_effective_alpha(server):
    """With a text-encoder LoRA patched, a request that omits alpha runs at
    the pipe's current scale, and the cache keys on that EFFECTIVE scale."""
    pipe = server.pipe
    had_text = pipe.lora_text
    pipe.lora_text = init_lora(pipe.text_sites(), r=2, device="cpu",
                               generator=torch.Generator().manual_seed(5))
    for e in pipe.lora_text["sites"].values():
        e["up"] = e["up"] + 0.05
    try:
        base = {"prompt": "alpha probe", "steps": 2, "height": 64,
                "width": 64, "seed": 11}
        out_a, _ = _post(server, {**base, "alpha": 0.0})
        out_none, _ = _post(server, base)       # runs at effective 0.0
        out_b, _ = _post(server, {**base, "alpha": 1.0})
        out_none2, _ = _post(server, base)      # now effective 1.0
        assert out_none["images"] == out_a["images"]
        assert out_none2["images"] == out_b["images"]
        assert out_a["images"] != out_b["images"]
    finally:
        pipe.lora_text = had_text
        pipe.tune_lora_scale(1.0)


def test_embed_cache_keys_on_scale_set_before_start(server):
    """A pipe tuned to 0.8 before its server starts: a request without alpha
    caches embeddings at 0.8, and a later alpha=1.0 request encodes afresh
    (lora_tpu keys the first under an assumed 1.0 and would reuse them)."""
    pipe = server.pipe
    had_text = pipe.lora_text
    pipe.lora_text = init_lora(pipe.text_sites(), r=2, device="cpu",
                               generator=torch.Generator().manual_seed(6))
    for e in pipe.lora_text["sites"].values():
        e["up"] = e["up"] + 0.05
    base = {"prompt": "scale probe", "steps": 2, "height": 64, "width": 64,
            "seed": 13}
    servers = []
    try:
        pipe.tune_lora_scale(0.8)
        servers.append(PipelineServer(pipe, port=0).start())
        out_08, _ = _post(servers[0], base)
        misses = servers[0].embed_cache_misses
        out_10, _ = _post(servers[0], {**base, "alpha": 1.0})
        assert servers[0].embed_cache_misses == misses + 2  # prompt + ""
        pipe.tune_lora_scale(1.0)
        servers.append(PipelineServer(pipe, port=0).start())
        fresh_10, _ = _post(servers[1], base)
        assert out_10["images"] == fresh_10["images"]
        assert out_08["images"] != out_10["images"]
    finally:
        for srv in servers:
            srv.stop()
        pipe.lora_text = had_text
        pipe.tune_lora_scale(1.0)


def test_embed_cache_invalidated_on_adapter_swap(server, tmp_path):
    """patch_pipe on a live server at the SAME alpha must not serve the old
    adapter's cached embeddings."""
    from lora_tpu_torch.formats.safetensors_io import (
        TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
        save_safeloras_with_embeds,
    )

    pipe = server.pipe
    had_text, had_unet = pipe.lora_text, pipe.lora_unet

    def make_file(seed, bump):
        sites = pipe.text_sites()
        lt = init_lora(sites, r=2, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
        for e in lt["sites"].values():
            e["up"] = e["up"] + bump
        p = str(tmp_path / f"adapter{seed}.safetensors")
        save_safeloras_with_embeds(
            {"text_encoder": (lora_to_pairs(lt, sites),
                              TEXT_ENCODER_DEFAULT_TARGET_REPLACE)}, {}, p)
        return p

    base = {"prompt": "swap probe", "steps": 2, "height": 64, "width": 64,
            "seed": 3, "alpha": 1.0}
    try:
        pipe.patch_pipe(make_file(21, 0.05), patch_unet=False)
        out1, _ = _post(server, base)
        pipe.patch_pipe(make_file(22, -0.05), patch_unet=False)
        out2, _ = _post(server, base)  # same text, same alpha, new adapter
        assert out1["images"] != out2["images"]
    finally:
        pipe.lora_text, pipe.lora_unet = had_text, had_unet
        pipe.adapter_generation += 1


def test_embed_cache_keys_on_text_base_delta_alpha(server, tmp_path):
    """A LyCORIS file whose text modules are all norms leaves no text LoRA,
    yet its base deltas make the embeddings depend on alpha: the cache
    keys on the alpha they were last applied at (a key without it would
    serve alpha 0's embeddings at alpha 1)."""
    from lora_tpu_torch.formats.reader import save_file

    pipe = server.pipe
    had_text, had_unet = pipe.lora_text, pipe.lora_unet
    rng = np.random.default_rng(4)
    tensors = {}
    for i in range(TINY_TEXT.num_hidden_layers):
        base = f"lora_te_text_model_encoder_layers_{i}_layer_norm1"
        for leaf in ("w_norm", "b_norm"):
            tensors[f"{base}.{leaf}"] = (0.5 * rng.standard_normal(
                TINY_TEXT.hidden_size)).astype(np.float32)
    path = str(tmp_path / "text_norms.safetensors")
    save_file(tensors, path)
    base = {"prompt": "norm probe", "steps": 2, "height": 64, "width": 64,
            "seed": 17}
    try:
        with server.lock:
            pipe.patch_pipe(path)
        assert pipe.lora_text is None and pipe.has_base_deltas(
            "text_encoder")
        out_a, _ = _post(server, {**base, "alpha": 0.0})
        out_none, _ = _post(server, base)        # runs at effective 0.0
        out_b, _ = _post(server, {**base, "alpha": 1.0})
        out_none2, _ = _post(server, base)       # now effective 1.0
        assert out_none["images"] == out_a["images"]
        assert out_none2["images"] == out_b["images"]
        assert out_a["images"] != out_b["images"]
        keys = {k for t, k in server._embeds if t == "norm probe"}
        assert len(keys) == 2, keys
    finally:
        with server.lock:
            pipe.remove_lora()
        pipe.lora_text, pipe.lora_unet = had_text, had_unet
    # remove_lora wrote the original params back
    assert not pipe.has_base_deltas("text_encoder")


def test_stacked_adapters_routed_in_one_group(server):
    """stack_loras + lora_idx: one 2-prompt request routes row 0 through
    adapter A and row 1 through adapter B, in one device batch; each row
    equals that row of the same request served with its adapter alone
    (unstacked, unrouted), within the quantized pipeline's limits: the
    routed bypass sums in another order, and every int8 dense rounds its
    input to bf16."""
    from lora_tpu_torch.core.lora import stack_loras

    pipe = server.pipe
    had_text, had_unet = pipe.lora_text, pipe.lora_unet
    adapters = []
    for seed in (31, 32):
        lora = init_lora(pipe.unet_sites(), r=2, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
        g = torch.Generator().manual_seed(seed + 10)
        for e in lora["sites"].values():
            e["up"] = 0.3 * torch.randn(e["up"].shape, generator=g)
        adapters.append(lora)
    base = {"prompt": ["route a", "route b"], "steps": 2, "height": 64,
            "width": 64, "seed": 19}

    def pixels(out):
        return [t_serve._png_decode(base64.b64decode(b)) / 255.0
                for b in out["images"]]

    try:
        pipe.lora_text = None
        pipe.lora_unet = stack_loras(adapters)
        routed, status = _post(server, {**base, "lora_idx": [0, 1]})
        assert status == 200 and routed["batched_with"] == 1
        assert server.last_device_batch == 2
        alone = []
        for lora in adapters:
            pipe.lora_unet = lora
            alone.append(pixels(_post(server, base)[0]))
    finally:
        pipe.lora_text, pipe.lora_unet = had_text, had_unet
    got = pixels(routed)
    for row in (0, 1):
        diff = np.abs(got[row] - alone[row][row])
        assert diff.max() <= IMAGE_MAX_ABS and diff.mean() <= IMAGE_MEAN_ABS
        other = np.abs(got[row] - alone[1 - row][row])
        assert other.mean() > 10 * IMAGE_MEAN_ABS, other.mean()


def test_mixed_config_concurrency(server):
    """Concurrent requests with DIFFERENT configs are never merged, and all
    complete (the spill path seeds the next batch)."""
    results = {}

    def fire(name, payload):
        results[name] = _post(server, payload)

    threads = [threading.Thread(target=fire, args=(f"r{i}", {
        "prompt": f"mixed {i % 2}", "steps": 2 if i % 2 == 0 else 3,
        "height": 64, "width": 64, "seed": i})) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(status == 200 for _, status in results.values())
    assert all(len(out["images"]) == 1 for out, _ in results.values())


def test_deadline_cuts_coalescing_window(server):
    """With a 3 s window, a lone deadline_ms=100 request returns far
    sooner: the batch is cut once budget - estimated exec is spent."""
    srv = PipelineServer(server.pipe, port=0, batch_window_ms=3000.0).start()
    try:
        _post(srv, {"prompt": "warm", "steps": 2, "height": 64, "width": 64,
                    "deadline_ms": 100})
        t0 = time.perf_counter()
        out, status = _post(srv, {"prompt": "deadline probe", "steps": 2,
                                  "height": 64, "width": 64,
                                  "deadline_ms": 100})
        wall = time.perf_counter() - t0
        assert status == 200 and out["batched_with"] == 1
        assert wall < 2.5, f"deadline did not cut the window ({wall:.2f}s)"
    finally:
        srv.stop()


def test_queue_bound_sheds_with_503(server):
    srv = PipelineServer(server.pipe, port=0, max_queue=0).start()
    try:
        status, body = _status(srv, {"prompt": "shed me", "steps": 2,
                                     "height": 64, "width": 64})
        assert status == 503 and "max_queue" in body["error"]
        assert srv.shed_count == 1
    finally:
        srv.stop()


def test_batch_bucketing_pads_device_batch(server):
    """A group of 3 runs as the 4-bucket while each request keeps its own
    image."""
    srv = PipelineServer(server.pipe, port=0, batch_window_ms=1500.0).start()
    try:
        results = {}

        def fire(name, seed):
            results[name] = _post(srv, {"prompt": "bucket probe",
                                        "steps": 2, "height": 64,
                                        "width": 64, "seed": seed})

        threads = [threading.Thread(target=fire, args=(f"f{i}", i + 1))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(s == 200 for _, s in results.values())
        sizes = {k: out["batched_with"] for k, (out, _) in results.items()}
        assert max(sizes.values()) == 3, sizes
        assert srv.last_device_batch == 4
        f_imgs = {k: results[k][0]["images"][0] for k in ("f0", "f1", "f2")}
        assert len(set(f_imgs.values())) == 3
    finally:
        srv.stop()


def test_warmup_runs_all_buckets(server):
    srv = PipelineServer(server.pipe, port=0, max_batch=4).start()
    try:
        secs = srv.warmup(steps=2, height=64, width=64)
        assert secs > 0 and srv.batch_buckets == (1, 2, 4)
        assert srv.last_device_batch == 4  # largest bucket ran last
        out, status = _post(srv, {"prompt": "after warmup", "steps": 2,
                                  "height": 64, "width": 64})
        assert status == 200 and len(out["images"]) == 1
    finally:
        srv.stop()


def test_prompt_list_rows_count_toward_bucket_cap(server):
    """Two 3-prompt requests in one window run as one 6-row group padded to
    the 8-bucket."""
    srv = PipelineServer(server.pipe, port=0, batch_window_ms=1500.0,
                         max_batch=8).start()
    try:
        results = {}

        def fire(name, seed):
            results[name] = _post(srv, {
                "prompt": [f"row {seed} {j}" for j in range(3)],
                "steps": 2, "height": 64, "width": 64, "seed": seed})

        ts = [threading.Thread(target=fire, args=(f"r{i}", i))
              for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert all(s == 200 for _, s in results.values())
        assert all(len(out["images"]) == 3 for out, _ in results.values())
        assert srv.last_device_batch == 8
    finally:
        srv.stop()


def test_oversize_prompt_list_rejected(server):
    status, body = _status(server, {"prompt": [f"p{i}" for i in range(9)],
                                    "steps": 2, "height": 64, "width": 64})
    assert status == 400 and "max_batch" in body["error"]


def test_largest_bucket_must_equal_max_batch(server):
    with pytest.raises(ValueError, match="max_batch"):
        PipelineServer(server.pipe, port=0, max_batch=8,
                       batch_buckets=(1, 2, 4))
    srv = PipelineServer(server.pipe, port=0, max_batch=12)
    assert srv.batch_buckets == (1, 2, 4, 8, 12)
    srv.stop()


def test_metrics_endpoint(server):
    out, status = _post(server, {"prompt": "metrics probe", "steps": 2,
                                 "height": 64, "width": 64, "seed": 3})
    assert status == 200
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=30) as r:
        m = json.loads(r.read())
    assert m["requests"] >= 1 and m["images"] >= 1
    assert m["inflight"] == 0 and m["draining"] is False
    assert m["uptime_s"] > 0
    assert m["exec_ewma_s"] is None or m["exec_ewma_s"] > 0
    assert m["embed_cache_hits"] + m["embed_cache_misses"] > 0


def test_drain_finishes_admitted_sheds_new(server):
    srv = PipelineServer(server.pipe, port=0).start()
    try:
        results = {}

        def fire(name, seed):
            try:
                results[name] = _post(srv, {"prompt": "drain probe",
                                            "steps": 2, "height": 64,
                                            "width": 64, "seed": seed})
            except urllib.error.HTTPError as e:
                results[name] = (None, e.code)

        t = threading.Thread(target=fire, args=("admitted", 1))
        t.start()
        deadline = time.monotonic() + 30
        while srv.metrics()["inflight"] == 0 and "admitted" not in results:
            assert time.monotonic() < deadline, "request never admitted"
            time.sleep(0.01)
        assert srv.drain(timeout=120) is True
        t.join()
        out, status = results["admitted"]
        assert status == 200 and len(out["images"]) == 1
        fire("late", 2)
        assert results["late"] == (None, 503)
        m = srv.metrics()
        assert m["draining"] is True and m["inflight"] == 0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["draining"] is True
    finally:
        srv.stop()


def test_empty_prompt_list_rejected(server):
    for bad in ([], 7):
        assert _status(server, {"prompt": bad, "steps": 2, "height": 64,
                                "width": 64})[0] == 400


def test_backpressure_counts_rows_not_requests(server):
    """max_queue is a ROW budget: one queued 3-row request trips the shed
    threshold that three queued 1-row requests would."""
    srv = PipelineServer(server.pipe, port=0, max_queue=2)
    results = {}

    def submit(name, req):
        try:
            results[name] = srv.generate(req)
        except Exception as e:
            results[name] = e

    # park the worker: it collects request A, then blocks on the pipe lock
    with srv.lock:
        ta = threading.Thread(target=submit, args=(
            "a", {"prompt": "a", "steps": 2, "height": 64, "width": 64}),
            daemon=True)
        ta.start()
        for _ in range(500):
            if srv._queued_rows == 0 and srv._inflight == 1:
                break
            time.sleep(0.01)
        tb = threading.Thread(target=submit, args=(
            "b", {"prompt": ["b1", "b2", "b3"], "steps": 3,
                  "height": 64, "width": 64}), daemon=True)
        tb.start()
        for _ in range(500):
            if srv._queued_rows == 3:
                break
            time.sleep(0.01)
        assert srv._queued_rows == 3
        with pytest.raises(ServerOverloaded, match="queued rows"):
            srv.generate({"prompt": "d", "steps": 2,
                          "height": 64, "width": 64})
        assert srv.shed_count == 1
        assert srv.metrics()["queued_rows"] == 3
    ta.join(timeout=300)
    tb.join(timeout=300)
    assert len(results["a"]["images"]) == 1
    assert len(results["b"]["images"]) == 3
    assert srv._queued_rows == 0
    srv.httpd.server_close()


def test_malformed_numeric_field_rejected_at_admit(server):
    for bad in ({"prompt": "x", "steps": "abc"},
                {"prompt": "x", "guidance": "hot"},
                {"prompt": "x", "height": "tall"}):
        payload = {**bad, "steps": bad.get("steps", 2)}
        assert _status(server, payload)[0] == 400, bad
    out, status = _post(server, {"prompt": "still alive", "steps": 2,
                                 "height": 64, "width": 64, "seed": 9})
    assert status == 200 and len(out["images"]) == 1
    assert server.metrics()["scheduler_alive"] is True


def test_lora_idx_and_seed_validated_at_admit(server):
    for bad in ({"prompt": ["a", "b"], "lora_idx": [0]},
                {"prompt": "x", "lora_idx": ["zero"]},
                {"prompt": "x", "lora_idx": "zero"},
                {"prompt": "x", "seed": "abc"}):
        with pytest.raises(ValueError):
            server.generate({"steps": 2, "height": 64, "width": 64, **bad})
    m = server.metrics()
    assert m["queued_rows"] == 0 and m["inflight"] == 0
    out, status = _post(server, {"prompt": "alive", "steps": 2,
                                 "height": 64, "width": 64, "seed": 5})
    assert status == 200 and len(out["images"]) == 1


def _image_png(seed=11, h=64, w=64):
    rng = np.random.default_rng(seed)
    return base64.b64encode(t_serve._png_bytes(
        rng.integers(0, 256, (h, w, 3), dtype=np.uint8))).decode()


def _mask_png(h=64, w=64):
    """Repaint the right half."""
    m = np.zeros((h, w, 3), np.uint8)
    m[:, w // 2:] = 255
    return base64.b64encode(t_serve._png_bytes(m)).decode()


def _sixteen_bit_png():
    """The header of a 16-bit RGB PNG: refused before its data is read."""
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", 64, 64, 16, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(b"")) + chunk(b"IEND", b""))
    return base64.b64encode(png).decode()


def test_image_modes_rejected_with_400(server):
    """The image modes are served; what lora_tpu rejects at admit is a 400
    there, for live requests and for warmup, and never enters the queue."""
    img = _image_png()
    cases = [
        ({"mode": "paint-by-numbers"}, "unknown mode"),
        ({"mode": "img2img"}, "requires a base64 PNG 'image'"),
        ({"mode": "inpaint", "image": img}, "requires a base64 PNG 'mask'"),
        ({"mode": "inpaint", "image": img, "mask": _mask_png(32, 32)},
         "does not match image size"),
        ({"mode": "img2img", "image": img, "scheduler": "euler"},
         "ddim only"),
        ({"mode": "inpaint", "image": img, "mask": _mask_png(),
          "scheduler": "pndm"}, "pndm"),
        ({"mode": "img2img", "image": _image_png(h=40, w=40)},
         "multiples of 64"),
        ({"mode": "img2img", "prompt": ["a", "b"], "image": [img]},
         "carries 1 PNGs for 2"),
        ({"mode": "img2img", "image": img, "strength": 0.1, "steps": 5},
         "zero denoising steps"),
        ({"mode": "img2img", "image": _sixteen_bit_png()}, "16-bit"),
        ({"mode": "img2img", "image": "aGk="}, "not a PNG"),
        ({"mode": "img2img", "image": img, "strength": "lots"},
         "malformed request field"),
    ]
    for extra, msg in cases:
        status, body = _status(server, {"prompt": "x", "steps": 2, **extra})
        assert status == 400 and msg in body["error"], (extra, body)
    with pytest.raises(ValueError, match="pndm"):
        server.warmup(steps=2, height=64, width=64, modes=("inpaint",),
                      scheduler="pndm")
    m = server.metrics()
    assert m["queued_rows"] == 0 and m["inflight"] == 0


def test_unknown_scheduler_is_a_400_at_admit(server):
    """A scheduler the pipeline does not know never enters a group; every
    sampler lora_tpu serves is served."""
    for bad in ("lms", 3, None):
        status, body = _status(server, {"prompt": "x", "steps": 2,
                                        "height": 64, "width": 64,
                                        "scheduler": bad})
        assert status == 400 and "unknown scheduler" in body["error"], bad
    m = server.metrics()
    assert m["queued_rows"] == 0 and m["inflight"] == 0
    for sched in ("pndm", "euler", "euler_a", "dpm++", "euler_karras",
                  "euler_a_karras"):
        out, status = _post(server, {"prompt": "a sampler probe", "steps": 3,
                                     "height": 64, "width": 64, "seed": 2,
                                     "scheduler": sched})
        assert status == 200 and len(out["images"]) == 1, sched
    assert server.metrics()["scheduler_alive"] is True


def test_img2img_serving(server):
    payload = {"mode": "img2img", "prompt": "a tiny tree",
               "image": _image_png(), "steps": 2, "strength": 1.0,
               "seed": 3}
    out, status = _post(server, payload)
    assert status == 200 and len(out["images"]) == 1
    rgb = t_serve._png_decode(base64.b64decode(out["images"][0]))
    assert rgb.shape == (64, 64, 3)
    # a single-request group is fully seed-deterministic
    out2, _ = _post(server, payload)
    assert out["images"] == out2["images"]


def test_inpaint_serving_keep_all_matches_roundtrip(server):
    """An all-keep mask (latent blending on the plain 4-channel pipe)
    returns decode(encode(image)) exactly, up to the PNG's truncation to 8
    bits: the posterior noise is the first draw of the group's generator,
    seeded with the request's seed."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    payload = {"mode": "inpaint", "prompt": "x",
               "image": base64.b64encode(t_serve._png_bytes(arr)).decode(),
               "mask": base64.b64encode(t_serve._png_bytes(
                   np.zeros((64, 64, 3), np.uint8))).decode(),
               "steps": 2, "guidance": 1.0, "seed": 9, "scheduler": "euler"}
    out, status = _post(server, payload)
    assert status == 200
    got = t_serve._png_decode(base64.b64decode(out["images"][0]))
    pipe = server.pipe
    image = torch.from_numpy(arr.astype(np.float32) / 127.5 - 1.0)[None]
    with torch.inference_mode():
        z0 = pipe._encode_image(image, torch.Generator().manual_seed(9),
                                None)
        expect = pipe._decode(z0)[0]
    assert np.abs(got / 255.0 - expect).max() <= 1.0 / 255.0 + 1e-6


def test_image_mode_coalescing(server):
    """Concurrent same-config img2img requests run in one device batch;
    txt2img never merges with an image mode, nor one strength with
    another."""
    img = _image_png()
    results = {}

    def fire(name, seed):
        results[name] = _post(server, {"mode": "img2img", "prompt": "t",
                                       "image": img, "steps": 2,
                                       "strength": 1.0, "seed": seed})

    lead = threading.Thread(target=fire, args=("lead", 0))
    lead.start()
    time.sleep(0.3)
    followers = [threading.Thread(target=fire, args=(f"f{i}", i + 1))
                 for i in range(2)]
    for t in followers:
        t.start()
    for t in [lead] + followers:
        t.join(timeout=300)
    assert all(s == 200 for _, s in results.values())
    assert max(out["batched_with"] for out, _ in results.values()) >= 2
    # the group's draws come from its first member's seed, so members of
    # one batch differ only through their position in it
    P = t_serve._Pending
    assert P({"prompt": "t"}).key() != P({"mode": "img2img", "prompt": "t",
                                          "image": img}).key()
    assert P({"mode": "img2img", "prompt": "t", "image": img,
              "strength": 0.5}).key() != \
        P({"mode": "img2img", "prompt": "t", "image": img,
           "strength": 0.6}).key()
    assert P({"mode": "img2img", "prompt": "t", "image": img}).key() != \
        P({"mode": "inpaint", "prompt": "t", "image": img,
           "mask": _mask_png()}).key()


def test_image_mode_uses_embed_cache(server):
    """A repeated img2img request serves its prompt and negative prompt
    embeddings from the cache and returns the same PNG."""
    payload = {"mode": "img2img", "prompt": "a cached img2img prompt",
               "image": _image_png(seed=21), "steps": 2, "strength": 1.0,
               "seed": 4}
    out1, _ = _post(server, payload)
    h0 = server.embed_cache_hits
    out2, _ = _post(server, payload)
    assert server.embed_cache_hits >= h0 + 2
    assert out1["images"] == out2["images"]


def test_warmup_covers_image_modes(server):
    srv = PipelineServer(server.pipe, port=0, max_batch=2).start()
    try:
        secs = srv.warmup(steps=2, height=64, width=64,
                          modes=("img2img", "inpaint"), strength=1.0)
        assert secs > 0 and srv.last_device_batch == 2
        out, status = _post(srv, {"mode": "img2img", "prompt": "live",
                                  "image": _image_png(), "steps": 2,
                                  "strength": 1.0, "seed": 3})
        assert status == 200 and len(out["images"]) == 1
    finally:
        srv.stop()


def test_image_modes_shed_before_decode(server, monkeypatch):
    """A draining or full server sheds image-mode requests before paying
    their base64 + PNG decode."""
    def boom(*a, **k):
        raise AssertionError("image decode ran before the shed check")

    srv = PipelineServer(server.pipe, port=0)
    try:
        monkeypatch.setattr(t_serve, "_b64_to_image", boom)
        srv.draining = True
        with pytest.raises(ServerOverloaded):
            srv.generate({"mode": "img2img", "prompt": "x", "steps": 2,
                          "image": _image_png(), "strength": 1.0})
        srv.draining = False
        srv.max_queue = 0
        with pytest.raises(ServerOverloaded):
            srv.generate({"mode": "inpaint", "prompt": "x", "steps": 2,
                          "image": _image_png(), "mask": _mask_png()})
        assert srv.shed_count == 2
    finally:
        srv.stop()


def test_http_image_pixels_equal_direct_pipeline_call(server):
    """img2img and latent-blend inpaint (euler_a: its step noise too) over
    HTTP return the PNGs of the pipeline called directly with a generator
    seeded with the request's seed and the same embeddings."""
    pipe = server.pipe
    prompts = ["an image parity probe", "another row"]
    img = _image_png(seed=31)
    image = torch.from_numpy(t_serve._b64_to_image(img, 2))
    mask = torch.from_numpy(t_serve._b64_to_mask(_mask_png(), 2, (64, 64)))
    with torch.inference_mode():
        emb = pipe.encode_prompt(prompts)
        neg = pipe.encode_prompt(["", ""])
    kw = dict(num_inference_steps=4, guidance_scale=7.5, prompt_embeds=emb,
              negative_prompt_embeds=neg)
    for mode, direct in (
            ("img2img", lambda g: pipe.img2img(None, image, strength=0.75,
                                               generator=g, **kw)),
            ("inpaint", lambda g: pipe.inpaint_blend(
                None, image, mask, strength=0.75, scheduler="euler_a",
                generator=g, **kw))):
        out, status = _post(server, {
            "mode": mode, "prompt": prompts, "image": img,
            "mask": _mask_png() if mode == "inpaint" else None,
            "scheduler": "euler_a" if mode == "inpaint" else "ddim",
            "steps": 4, "guidance": 7.5, "strength": 0.75, "seed": 17})
        assert status == 200
        want = direct(torch.Generator().manual_seed(17))
        assert out["images"] == [t_serve._png_b64(im) for im in want], mode


def test_nine_channel_inpaint_serving():
    """A 9-channel checkpoint serves mode='inpaint' through its UNet path
    (ddim), and rejects img2img, another sampler and lora_idx at admit."""
    srv = PipelineServer(_tiny_pipe(in_channels=9), port=0)
    try:
        out = srv.generate({"mode": "inpaint", "prompt": ["a dog", "a cat"],
                            "image": _image_png(), "mask": _mask_png(),
                            "steps": 2, "seed": 1})
        assert len(out["images"]) == 2
        base = {"prompt": "x", "image": _image_png(), "mask": _mask_png(),
                "steps": 2}
        for extra, msg in (({"mode": "img2img"}, "9-channel"),
                           ({"mode": "inpaint", "scheduler": "euler"},
                            "ddim only"),
                           ({"mode": "inpaint", "lora_idx": [0]},
                            "lora_idx")):
            with pytest.raises(ValueError, match=msg):
                srv.generate({**base, **extra})
        secs = srv.warmup(steps=2, height=64, width=64, modes=("inpaint",))
        assert secs > 0
        m = srv.metrics()
        assert m["queued_rows"] == 0 and m["inflight"] == 0
    finally:
        srv.stop()


def test_nine_channel_checkpoint_rejects_txt2img():
    srv = PipelineServer(_tiny_pipe(in_channels=9), port=0)
    try:
        with pytest.raises(ValueError, match="9-channel"):
            srv.generate({"prompt": "x", "steps": 2})
        with pytest.raises(ValueError, match="9-channel"):
            srv.warmup(steps=2, height=64, width=64)
        m = srv.metrics()
        assert m["queued_rows"] == 0 and m["inflight"] == 0
    finally:
        srv.stop()


def _tiny_xl_pipe(seed=0):
    return StableDiffusionXLPipeline.random_init(
        torch.Generator().manual_seed(seed), "cpu", unet_cfg=TINY_XL_UNET,
        text_cfg=TINY_XL_TEXT, text2_cfg=TINY_XL_TEXT2, vae_cfg=TINY_VAE)


def test_sdxl_pipeline_refused():
    """An SDXL pipe is served (it was refused before SDXL was ported): an
    HTTP generate returns the PNGs of the pipe called directly with the
    seed's latents and the (context, pooled) pairs, CFG 5.0."""
    pipe = _tiny_xl_pipe()
    srv = PipelineServer(pipe, port=0).start()
    try:
        prompts = ["an xl parity probe", "a second row"]
        out, status = _post(srv, {"prompt": prompts, "steps": 2,
                                  "guidance": 5.0, "height": 64,
                                  "width": 64, "seed": 13})
        assert status == 200
    finally:
        srv.stop()
    lat = pipe.prepare_latents(2, 64, 64, torch.Generator().manual_seed(13))
    # the cache encodes the shared negative prompt once, in a batch of one
    neg = tuple(torch.cat([e, e]) for e in pipe.encode_prompt_xl([""]))
    direct = pipe(None, num_inference_steps=2, guidance_scale=5.0,
                  height=64, width=64, latents=lat,
                  prompt_embeds=pipe.encode_prompt_xl(prompts),
                  negative_prompt_embeds=neg)
    assert out["images"] == [t_serve._png_b64(im) for im in direct]


def test_xl_pipeline_serving():
    """tests/test_serve.py's counterpart: the embed cache stores (context,
    pooled) pairs, CFG negatives flow through, and a repeat is served
    from the cache with the same pixels."""
    srv = PipelineServer(_tiny_xl_pipe(), port=0).start()
    req = {"prompt": "a tiny xl tree", "steps": 2, "height": 64,
           "width": 64, "seed": 1, "guidance": 5.0}
    try:
        out, status = _post(srv, req)
        assert status == 200 and len(out["images"]) == 1
        assert base64.b64decode(out["images"][0])[:8] == b"\x89PNG\r\n\x1a\n"
        entry = srv._embeds[("a tiny xl tree", srv._embed_key_alpha())]
        assert [tuple(e.shape) for e in entry] == [
            (77, TINY_XL_TEXT.hidden_size + TINY_XL_TEXT2.hidden_size),
            (TINY_XL_TEXT2.projection_dim,)]
        misses = srv.embed_cache_misses
        out2, _ = _post(srv, req)
        assert out2["images"] == out["images"]
        assert srv.embed_cache_misses == misses and srv.embed_cache_hits > 0
    finally:
        srv.stop()


def test_xl_te2_lora_keys_embed_cache(tmp_path):
    """A te2-only kohya-XL file (lora_text stays None) puts te2's scale in
    the embed key: repeats at one alpha hit, an alpha change misses and
    re-encodes, and alpha 0 gives the unpatched render's pixels."""
    from lora_tpu_torch.core.sites import text_encoder_lora_sites
    from lora_tpu_torch.formats.kohya import save_kohya_xl

    pipe = _tiny_xl_pipe()
    t2 = text_encoder_lora_sites(TINY_XL_TEXT2)
    lt2 = init_lora(t2, r=2, generator=torch.Generator().manual_seed(5),
                    device="cpu")
    for e in lt2["sites"].values():
        e["up"] = e["up"] + 0.1
    path = str(tmp_path / "te2only.safetensors")
    save_kohya_xl(path, unet_cfg=TINY_XL_UNET, lora_text2=lt2,
                  text2_sites=t2, dtype=np.float32)
    srv = PipelineServer(pipe, port=0).start()
    req = {"prompt": "an xl probe", "steps": 2, "height": 64, "width": 64,
           "seed": 2, "alpha": 1.0}
    try:
        base_out, _ = _post(srv, req)
        assert srv._embed_key_alpha()[1] is None
        with srv.lock:
            pipe.patch_pipe(path)
        assert pipe.lora_text is None and pipe.lora_unet is None
        assert pipe.lora_text2 is not None
        out1, _ = _post(srv, req)
        assert out1["images"] != base_out["images"]  # te2's LoRA is live
        m0 = srv.embed_cache_misses
        out1b, _ = _post(srv, req)
        assert srv.embed_cache_misses == m0
        assert out1b["images"] == out1["images"]
        out0, _ = _post(srv, dict(req, alpha=0.0))
        assert srv.embed_cache_misses > m0
        assert out0["images"] == base_out["images"]
    finally:
        srv.stop()


def test_xl_inpaint_serving_routes_blend():
    """An SDXL inpaint request takes latent blending (there is no 9-channel
    SDXL UNet): the pixels of pipe.inpaint with the seed's generator."""
    pipe = _tiny_xl_pipe()
    srv = PipelineServer(pipe, port=0)
    try:
        assert srv._is_xl and not srv._nine_channel()
        out = srv.generate({"mode": "inpaint", "prompt": "a dog",
                            "image": _image_png(), "mask": _mask_png(),
                            "steps": 2, "guidance": 5.0, "seed": 1,
                            "scheduler": "euler_a"})
        img2 = srv.generate({"mode": "img2img", "prompt": "a dog",
                             "image": _image_png(), "steps": 2,
                             "guidance": 5.0, "seed": 1})
    finally:
        srv.stop()
    assert len(out["images"]) == 1 and len(img2["images"]) == 1
    image = torch.from_numpy(t_serve._b64_to_image(_image_png(), 1))
    mask = torch.from_numpy(t_serve._b64_to_mask(_mask_png(), 1, (64, 64)))
    direct = pipe.inpaint("a dog", image, mask, num_inference_steps=2,
                          scheduler="euler_a",
                          generator=torch.Generator().manual_seed(1))
    assert out["images"] == [t_serve._png_b64(im) for im in direct]


def test_main_serves_an_sdxl_directory(tmp_path, monkeypatch):
    """main() on a diffusers-layout SDXL directory (text_encoder_2/) loads
    the SDXL pipeline in bf16 and answers a request over HTTP, then drains
    on SIGTERM."""
    import signal

    from lora_tpu_torch.models.hf_import import save_pipeline_params

    save_pipeline_params(_tiny_xl_pipe(), str(tmp_path))
    monkeypatch.setenv("LORA_TPU_ALLOW_HASHED_TOKENIZER", "1")
    handlers, started, got = {}, threading.Event(), {}
    monkeypatch.setattr(signal, "signal",
                        lambda sig, fn: handlers.__setitem__(sig, fn))
    start = PipelineServer.start

    def recorded_start(self):
        got["srv"] = self
        started.set()
        return start(self)

    monkeypatch.setattr(PipelineServer, "start", recorded_start)

    def client():
        try:
            started.wait(120)
            srv = got["srv"]
            time.sleep(0.2)
            got["out"] = _post(srv, {"prompt": "an xl main probe",
                                     "steps": 2, "height": 64, "width": 64,
                                     "guidance": 5.0})
        finally:
            handlers[signal.SIGTERM]()

    th = threading.Thread(target=client)
    th.start()
    t_serve.main(["--model", str(tmp_path), "--device", "cpu", "--port",
                  "0", "--no_warmup", "--max_batch", "1"])
    th.join(60)
    srv = got["srv"]
    assert isinstance(srv.pipe, StableDiffusionXLPipeline)
    assert srv.pipe.dtype == torch.bfloat16
    out, status = got["out"]
    assert status == 200 and len(out["images"]) == 1


def _crash_after_one(srv):
    release = threading.Event()

    def boom():
        release.wait(60)
        raise RuntimeError("collector exploded")

    srv._collect = boom
    # the worker is blocked inside the ORIGINAL _collect; one request flows
    # through it, after which the next loop iteration hits boom()
    out = srv.generate({"prompt": "last good", "steps": 2,
                        "height": 64, "width": 64, "seed": 1})
    assert len(out["images"]) == 1
    return release


def _waiter(srv, name, errs):
    try:
        srv.generate({"prompt": name, "steps": 2, "height": 64, "width": 64})
    except Exception as e:
        errs[name] = e


def _wait_queued(srv):
    deadline = time.monotonic() + 30
    while srv._queue.qsize() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)


def test_scheduler_crash_fails_loudly_not_hangs(server):
    srv = PipelineServer(server.pipe, port=0).start()
    try:
        release = _crash_after_one(srv)
        errs = {}
        t = threading.Thread(target=_waiter, args=(srv, "stranded", errs))
        t.start()
        _wait_queued(srv)
        assert srv._queue.qsize() == 1
        release.set()
        t.join(timeout=30)
        assert not t.is_alive(), "stranded waiter HUNG after scheduler death"
        assert isinstance(errs["stranded"], SchedulerDown)
        with pytest.raises(SchedulerDown):
            srv.generate({"prompt": "after crash", "steps": 2})
        assert srv.metrics()["scheduler_alive"] is False
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30)
            code, body = 200, {}
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        assert code == 500 and body["ok"] is False
        assert "collector exploded" in body["fatal"]
    finally:
        srv.stop()


def test_crash_restores_accounting_and_drain_unblocks(server):
    srv = PipelineServer(server.pipe, port=0)
    try:
        release = _crash_after_one(srv)
        errs = {}
        t1 = threading.Thread(target=_waiter, args=(srv, "stranded", errs))
        t1.start()
        _wait_queued(srv)
        assert srv.metrics()["queued_rows"] == 1
        release.set()
        t1.join(timeout=30)
        assert isinstance(errs["stranded"], SchedulerDown)
        m = srv.metrics()
        assert m["queued_rows"] == 0 and m["inflight"] == 0
        # enqueue race: slip a request past the fatal check
        fatal, srv._fatal = srv._fatal, None
        t2 = threading.Thread(target=_waiter, args=(srv, "racer", errs))
        t2.start()
        _wait_queued(srv)
        assert srv.metrics()["inflight"] == 1
        srv._fatal = fatal
        t2.join(timeout=30)  # watchdog tick is 2 s
        assert not t2.is_alive(), "racer HUNG on a dead scheduler"
        assert isinstance(errs["racer"], SchedulerDown)
        m = srv.metrics()
        assert m["queued_rows"] == 0 and m["inflight"] == 0
        assert srv.drain(timeout=5) is True
    finally:
        srv.stop()


def test_base_exception_in_group_gets_scheduler_down(server):
    srv = PipelineServer(server.pipe, port=0)
    try:
        def boom(group):
            raise SystemExit("operator pulled the plug")

        srv._run_group = boom
        with pytest.raises(SchedulerDown):
            srv.generate({"prompt": "inflight", "steps": 2,
                          "height": 64, "width": 64})
        m = srv.metrics()
        assert m["scheduler_alive"] is False
        assert m["queued_rows"] == 0 and m["inflight"] == 0
        assert srv.drain(timeout=5) is True
    finally:
        srv.stop()


def test_http_pixels_equal_direct_pipeline_call(server):
    """Slice parity on the quantized server: an HTTP generate returns the
    PNGs of the pipeline called directly with the same seed's latents and
    the same embeddings."""
    pipe = server.pipe
    prompts = ["a parity probe", "a second row"]
    out, status = _post(server, {"prompt": prompts, "steps": 2,
                                 "guidance": 7.5, "height": 64, "width": 64,
                                 "seed": 13})
    assert status == 200
    lat = pipe.prepare_latents(2, 64, 64, torch.Generator().manual_seed(13))
    with torch.inference_mode():
        emb = pipe.encode_prompt(prompts)
        neg = pipe.encode_prompt(["", ""])
    direct = pipe(None, num_inference_steps=2, guidance_scale=7.5,
                  height=64, width=64, latents=lat, prompt_embeds=emb,
                  negative_prompt_embeds=neg)
    assert out["images"] == [t_serve._png_b64(im) for im in direct]
    # and the string path of the pipeline gives the same pixels
    by_text = pipe(prompts, num_inference_steps=2, guidance_scale=7.5,
                   height=64, width=64, latents=lat)
    np.testing.assert_array_equal(by_text, direct)


@pytest.fixture
def jax_kernel_route(monkeypatch):
    """lora_tpu routes every 2-D int8 dense through its Pallas kernel
    (interpret mode on the CPU), as the port routes them through
    int8_matmul; the traces made under the patch are dropped afterwards."""
    from lora_tpu.ops import int8_matmul as j_i8

    monkeypatch.setattr(j_i8, "supported", lambda x, wq: wq.ndim == 2)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_quantized_pipeline_matches_jax(jax_kernel_route):
    pipe = _tiny_pipe()
    params = [{k: jnp.asarray(v.numpy()) for k, v in m.state_dict().items()}
              for m in (pipe.unet, pipe.text_encoder, pipe.vae)]
    jpipe = JPipe(unet_params=params[0], text_params=params[1],
                  vae_params=params[2],
                  tokenizer=JTokenizer(vocab_size=TINY_TEXT.vocab_size),
                  unet_cfg=j_cfg.TINY_UNET, text_cfg=j_cfg.TINY_TEXT,
                  vae_cfg=j_cfg.TINY_VAE)
    jpipe.quantize_base()
    pipe.quantize_base()
    for m, jp in ((pipe.unet, jpipe.unet_params),
                  (pipe.text_encoder, jpipe.text_params),
                  (pipe.vae, jpipe.vae_params)):
        sd = m.state_dict()
        assert set(sd) == set(jp)
        for k in sd:
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(jp[k]))
    lat = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    prompts = ["a photo of a dog", "a town"]
    kw = dict(num_inference_steps=2, guidance_scale=7.5, height=64, width=64)
    ref = jpipe(prompts, latents=jnp.asarray(lat), **kw)
    out = pipe(prompts, latents=torch.from_numpy(lat), **kw)
    err = np.abs(out - ref)
    assert err.max() < IMAGE_MAX_ABS and err.mean() < IMAGE_MEAN_ABS


def test_png_encoder_matches_jax_pillow_png():
    """The stdlib encoder's PNG decodes (with Pillow, here only) to the same
    uint8 pixels as lora_tpu's Pillow-written PNG of the same image."""
    from PIL import Image

    from lora_tpu import serve as j_serve

    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, (37, 64, 3)).astype(np.float32)
    img[0, :4, 0] = [0.0, 1.0, 0.5, 254.5 / 255]

    def pixels(b64):
        im = Image.open(io.BytesIO(base64.b64decode(b64)))
        assert im.mode == "RGB" and im.size == (64, 37)
        return np.asarray(im)

    got, want = pixels(t_serve._png_b64(img)), pixels(j_serve._png_b64(img))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def test_main_validates_arguments(tmp_path, monkeypatch, capsys):
    """Malformed flags and a missing device exit 2 before any model loads;
    an SDXL checkpoint (text_encoder_2/) no longer exits 2: it goes to the
    SDXL pipeline's loader."""
    cases = [
        (["--model", "/nonexistent", "--batch_buckets", "1, x"],
         "comma-separated ints"),
        (["--model", "/nonexistent", "--device", "nonsense"], "--device"),
        # the image modes pass validation: the device check after it fails
        (["--model", "/nonexistent", "--warmup_modes",
          "txt2img, img2img, inpaint", "--device", "nonsense"], "--device"),
        (["--model", "/nonexistent", "--warmup_modes", "paint"],
         "unknown mode"),
        (["--model", "/nonexistent", "--warmup_modes", ","], "--no_warmup"),
    ]
    for argv, msg in cases:
        with pytest.raises(SystemExit) as ei:
            t_serve.main(argv)
        assert ei.value.code == 2 and msg in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ei:
        t_serve.main(["--model", "/nonexistent"])
    assert ei.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err
    (tmp_path / "text_encoder_2").mkdir()
    loaded = []

    def load(path, **kw):
        loaded.append((path, kw))
        raise FileNotFoundError("stop after the loader was chosen")

    monkeypatch.setattr(StableDiffusionXLPipeline, "from_pretrained", load)
    with pytest.raises(FileNotFoundError, match="loader was chosen"):
        t_serve.main(["--model", str(tmp_path), "--device", "cpu"])
    assert loaded == [(str(tmp_path), {"dtype": torch.bfloat16,
                                       "device": torch.device("cpu")})]
