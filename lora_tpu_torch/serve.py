"""Serving endpoint over the port's StableDiffusionPipeline: the counterpart
of lora_tpu/serve.py (stdlib HTTP and zlib, no other dependency).

  POST /generate   {"prompt": str | [str], "steps": int, "guidance": float,
                    "height": int, "width": int, "seed": int,
                    "scheduler": str, "alpha": float, "lora_idx": [int],
                    "negative_prompt": str, "deadline_ms": float,
                    "mode": "txt2img" | "img2img" | "inpaint",
                    "image": base64 PNG | [base64 PNG, ...],
                    "mask": base64 PNG | [...], "strength": float}
                   -> {"images": [base64 PNG, ...], "latency_ms": float,
                       "batched_with": int}
                   -> 400 {"error": ...} for a malformed or unsupported
                      request, rejected at admit
                   -> 503 {"error": ...} when queued ROWS reach max_queue
                      (prompt lists count once per prompt) or the server is
                      draining for shutdown
                   -> 500 {"error": ...} once the scheduler thread died
  GET  /healthz    -> {"ok": bool, "devices": [...], "draining": bool}
  GET  /metrics    -> requests/images served, shed count, embed cache
                      hits/misses, queue depth, exec-time EWMA, uptime

Concurrent requests with the same sampling config (mode/strength/steps/
guidance/size/scheduler/alpha/negative prompt/routing) are MICRO-BATCHED: a
worker thread coalesces them (up to `max_batch` rows, within
`batch_window_ms`, cut early when a member's `deadline_ms` budget minus the
EWMA-estimated batch execution time is about to be spent) into one device
batch, padded up to a batch bucket so only len(batch_buckets) batch shapes
ever run; each request keeps its own prompt and `lora_idx` adapter routing,
and txt2img requests their own seed-derived latents
(torch.Generator(device).manual_seed(seed)). Prompt embeddings come from an
LRU keyed by (text, adapter generation, effective alpha). The scheduler
name is checked against the pipeline's set at admit.

Adapters: the pipe may hold an indexed, kohya / LoCon or LyCORIS file
(patch_pipe, also on a live server: the adapter generation invalidates the
cached embeddings), or K stacked adapters (core/lora.stack_loras) that
`lora_idx` routes per prompt row. A request's `alpha` re-tunes the LoRAs
and a LyCORIS file's base-param deltas (norm modules, bias diffs); the
effective text alpha in the embed key covers both, so a file whose text
modules are all norms still keys its embeddings on alpha.

Image modes: mode="img2img" takes a base64 PNG `image` (its size defines the
sampling size; one PNG per prompt row, or a single PNG replicated);
mode="inpaint" also takes a same-size `mask` PNG (luma >= 128 = repaint)
and runs the 9-channel inpainting UNet if the checkpoint has one, else
latent-blend inpainting. img2img and the 9-channel inpaint sample with
ddim; blend inpainting takes any scheduler but pndm. Their randomness (the
VAE posterior sample and the init noise; euler_a's step noise, also in
txt2img) is drawn batch-wide from the FIRST member's seed, so it is
reproducible per (seed, batch composition). PNGs are decoded on zlib
(data/png.py _png_decode: 8-bit and palette/gray below 8 bits,
non-interlaced; a 16-bit or interlaced PNG is a 400 that names the case).

SDXL pipelines (pipelines/sdxl.py) serve through the same endpoint: the
embed cache stores (context, te2 pooled) pairs, the embed key also covers
te2's LoRA and base deltas, and mode="inpaint" always takes latent
blending (there is no 9-channel SDXL UNet).
"""

from __future__ import annotations

import base64
import collections
import json
import os
import queue
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .data.png import _png_bytes, _png_decode

MODES = ("txt2img", "img2img", "inpaint")


def _png_b64(arr: np.ndarray) -> str:
    """A float image (H, W, 3) in [0, 1] as a base64 PNG, quantized as the
    JAX package's _png_b64 does: clip, * 255, truncate to uint8."""
    rgb = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return base64.b64encode(_png_bytes(rgb)).decode()


def _luma(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma as Pillow's convert("L") computes it, in integers:
    (R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16


def _png_rows(b64s, n_rows: int, field: str) -> list:
    """Decoded RGB pixels of a request field: a single base64 PNG is
    replicated across the prompt rows; a list must carry one per row."""
    items = [b64s] * n_rows if isinstance(b64s, str) else list(b64s)
    if len(items) != n_rows:
        raise ValueError(f"{field!r} carries {len(items)} PNGs for {n_rows} "
                         "prompt rows")
    return [_png_decode(base64.b64decode(s)) for s in items]


def _b64_to_image(b64s, n_rows: int) -> np.ndarray:
    """Base64 PNG(s) as (n_rows, H, W, 3) float32 in [-1, 1], all the same
    size (one device batch is one shape)."""
    rows = [r.astype(np.float32) / 127.5 - 1.0
            for r in _png_rows(b64s, n_rows, "image")]
    if any(r.shape != rows[0].shape for r in rows):
        raise ValueError("all 'image' PNGs in one request must share a size")
    return np.stack(rows)


def _b64_to_mask(b64s, n_rows: int, hw: tuple) -> np.ndarray:
    """Base64 PNG(s) as a binary (n_rows, H, W, 1) float32 mask (luma >=
    128 -> 1.0 = repaint), checked against the image size."""
    rows = []
    for rgb in _png_rows(b64s, n_rows, "mask"):
        m = (_luma(rgb) >= 128).astype(np.float32)
        if m.shape != tuple(hw):
            raise ValueError(
                f"mask size {m.shape} does not match image size {tuple(hw)}")
        rows.append(m[..., None])
    return np.stack(rows)


class ServerOverloaded(Exception):
    """Queue bound exceeded: shed with HTTP 503 instead of queueing into
    certain deadline misses."""


class SchedulerDown(Exception):
    """The micro-batching scheduler thread died (HTTP 500): the server can
    no longer execute work and healthz reports unhealthy; restart it."""


class _Pending:
    """One enqueued request awaiting its slot in a micro-batch."""

    def __init__(self, req: dict):
        self.req = req
        self.done = threading.Event()
        self.images = None
        self.error: Optional[Exception] = None
        self.batched_with = 1
        # crash-path accounting (guarded by the server's _shed_lock):
        # _dequeued = _collect already took our rows off _queued_rows;
        # _failed = a crash path already failed us (idempotence flag)
        self._dequeued = False
        self._failed = False
        self.t0 = time.monotonic()
        pr = req.get("prompt", "")
        self.n_rows = 1 if isinstance(pr, str) else len(pr)
        # absolute latency budget; None = no deadline (fixed window only)
        d = req.get("deadline_ms")
        self.deadline = self.t0 + float(d) / 1000.0 if d is not None else None
        self.mode = req.get("mode", "txt2img")
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected "
                             "txt2img | img2img | inpaint")
        self.image = self.mask = None
        if self.mode != "txt2img":
            if req.get("image") is None:
                raise ValueError(
                    f"mode {self.mode!r} requires a base64 PNG 'image'")
            self.image = _b64_to_image(req["image"], self.n_rows)
            # the init image defines the sampling size; key() groups by it
            req["height"] = int(self.image.shape[1])
            req["width"] = int(self.image.shape[2])
            if self.mode == "inpaint":
                if req.get("mask") is None:
                    raise ValueError(
                        "mode 'inpaint' requires a base64 PNG 'mask'")
                self.mask = _b64_to_mask(req["mask"], self.n_rows,
                                         self.image.shape[1:3])
        # coerce EVERY field the scheduler thread would otherwise touch NOW,
        # inside the requester's thread: malformed fields are a 400 at
        # admit time, never a crash of a coalesced batch or of key()
        try:
            self.seed = int(req.get("seed", 0))
            li = req.get("lora_idx")
            if li is None:
                self.lora_idx: Optional[list] = None
            else:
                items = li if isinstance(li, list) else [li] * self.n_rows
                if len(items) != self.n_rows:
                    raise ValueError(
                        f"'lora_idx' carries {len(items)} entries for "
                        f"{self.n_rows} prompt rows")
                self.lora_idx = [int(i) for i in items]
            self.steps = int(req.get("steps", 30))
            self.strength = (float(req.get("strength", 0.8))
                             if self.mode != "txt2img" else None)
            self._key = (
                self.steps, float(req.get("guidance", 7.5)),
                int(req.get("height", 512)), int(req.get("width", 512)),
                req.get("scheduler", "ddim"), req.get("alpha"),
                req.get("negative_prompt", ""),
                self.lora_idx is not None, self.mode, self.strength)
        except (TypeError, ValueError) as e:
            raise ValueError(f"malformed request field: {e}")

    def key(self):
        return self._key


def _devices() -> list:
    if torch.cuda.is_available():
        return [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())]
    return ["cpu"]


class PipelineServer:
    def __init__(self, pipe, host: str = "127.0.0.1", port: int = 8500,
                 max_batch: int = 8, batch_window_ms: float = 25.0,
                 embed_cache_size: int = 256, max_queue: int = 32,
                 batch_buckets: Optional[tuple] = None):
        self.pipe = pipe
        # SDXL pipes condition on (context, te2 pooled) pairs: the embed
        # cache stores the pair per prompt and the pipe call takes both
        self._is_xl = hasattr(pipe, "encode_prompt_xl")
        self.lock = threading.Lock()
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1000.0
        # allowed device batch sizes (see _assemble_rows); default: powers
        # of two up to max_batch
        if batch_buckets is None:
            batch_buckets = tuple(b for b in (1, 2, 4, 8, 16, 32, 64)
                                  if b < max_batch) + (max_batch,)
        self.batch_buckets = tuple(sorted(set(batch_buckets)))
        # every group the coalescer cuts (rows <= max_batch) pads up into
        # some warmed bucket: no live request meets an unwarmed shape
        if self.batch_buckets[-1] != max_batch:
            raise ValueError(
                f"largest batch bucket {self.batch_buckets[-1]} must equal "
                f"max_batch {max_batch}, or batches between them would run "
                f"unwarmed shapes at serve time")
        self.last_device_batch = 0
        # backpressure in queued ROWS (prompt lists count once per prompt)
        self.max_queue = max_queue
        self.shed_count = 0
        self._queued_rows = 0  # rows admitted but not yet pulled into a batch
        self._shed_lock = threading.Lock()  # row check + count are atomic
        # graceful drain: once set, new requests are shed with 503 while
        # everything already admitted finishes
        self.draining = False
        self._inflight = 0            # admitted, not yet done.set()
        self._idle = threading.Condition(self._shed_lock)
        self.request_count = 0  # lifetime admits (monotonic, for /metrics)
        self.image_count = 0
        self._t_started = time.monotonic()
        # EWMA of recent batch execution seconds: the deadline-aware
        # coalescer's estimate of how long a batch takes once cut
        self._exec_ewma: Optional[float] = None
        # LRU (text, (adapter generation, effective alpha)) -> embedding on
        # the pipe's device: repeated prompts (and the shared negative
        # prompt) skip tokenize + CLIP forward
        self._embeds: "collections.OrderedDict" = collections.OrderedDict()
        self._embed_cache_size = embed_cache_size
        self.embed_cache_hits = 0
        self.embed_cache_misses = 0
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._spill: Optional[_Pending] = None
        self._fatal: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()
        server_self = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    fatal = server_self._fatal
                    self._send(500 if fatal is not None else 200,
                               {"ok": fatal is None,
                                "draining": server_self.draining,
                                **({"fatal": repr(fatal)}
                                   if fatal is not None else {}),
                                "devices": _devices()})
                elif self.path == "/metrics":
                    self._send(200, server_self.metrics())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/generate":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    out = server_self.generate(req)
                    self._send(200, out)
                except ServerOverloaded as e:
                    self._send(503, {"error": str(e)})
                except SchedulerDown as e:
                    self._send(500, {"error": str(e)})
                except Exception as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.thread: Optional[threading.Thread] = None

    def generate(self, req: dict) -> dict:
        t0 = time.perf_counter()
        if req.get("mode", "txt2img") != "txt2img":
            # shed image modes BEFORE paying their base64 + PNG decode when
            # the server is draining or full (checked again below)
            with self._shed_lock:
                if self.draining or self._queued_rows >= self.max_queue:
                    self.shed_count += 1
                    raise ServerOverloaded(
                        "server is draining or at max_queue; retry with "
                        "backoff")
        pending = _Pending(req)
        if pending.n_rows < 1:
            # an empty prompt list would crash the whole coalesced group in
            # the bucket padding (prompts[-1])
            raise ValueError("prompt must be a non-empty string or list")
        if pending.n_rows > self.max_batch:
            raise ValueError(
                f"prompt list of {pending.n_rows} exceeds max_batch "
                f"{self.max_batch}; split the request")
        self._check_image_mode(pending)
        if self._fatal is not None:
            raise SchedulerDown(
                f"serving scheduler crashed: {self._fatal!r}")
        with self._shed_lock:
            if self.draining:
                self.shed_count += 1
                raise ServerOverloaded(
                    "server is draining for shutdown; retry elsewhere")
            if self._queued_rows >= self.max_queue:
                self.shed_count += 1
                raise ServerOverloaded(
                    f"queued rows {self._queued_rows} >= max_queue "
                    f"{self.max_queue}; retry with backoff")
            self._inflight += 1
            self.request_count += 1
            self._queued_rows += pending.n_rows
            self._queue.put(pending)
        # watchdog wait: if the scheduler dies between our enqueue and its
        # crash-drain, the fatal flag still wakes us within one tick, and
        # _fail_stranded undoes our accounting exactly once
        while not pending.done.wait(timeout=2.0):
            if self._fatal is not None:
                self._fail_stranded(pending, SchedulerDown(
                    f"serving scheduler crashed: {self._fatal!r}"))
                break
        pending.done.wait()
        if pending.error is not None:
            raise pending.error
        with self._shed_lock:
            self.image_count += pending.n_rows
        return {"images": [_png_b64(im) for im in pending.images],
                "latency_ms": round((time.perf_counter() - t0) * 1000, 1),
                "batched_with": pending.batched_with}

    def _nine_channel(self) -> bool:
        """A 9-channel inpainting UNet (never SDXL: it inpaints by latent
        blending)."""
        cfg = self.pipe.unet.cfg
        return not self._is_xl and cfg.in_channels != cfg.out_channels

    def _check_image_mode(self, pending: "_Pending") -> None:
        """Reject at admit (400) what the checkpoint or the routed pipeline
        path cannot run, so it never fails a coalesced group: a scheduler
        the pipeline does not know, a mode the UNet cannot serve, a size
        the UNet cannot round-trip, a sampler the mode does not take, a
        strength that leaves no step."""
        from .pipelines.sd import SCHEDULERS

        sched = pending.req.get("scheduler", "ddim")
        if not isinstance(sched, str) or sched not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {sched!r}; expected one of "
                             f"{', '.join(SCHEDULERS)}")
        nine_ch = self._nine_channel()
        if pending.mode == "txt2img":
            if nine_ch:
                raise ValueError(
                    "this checkpoint's UNet is a 9-channel inpainting UNet; "
                    "it serves mode='inpaint' only")
            return
        self.pipe._check_size(int(pending.image.shape[1]),
                              int(pending.image.shape[2]))
        if pending.mode == "img2img":
            if nine_ch:
                raise ValueError(
                    "this checkpoint's UNet is a 9-channel inpainting UNet; "
                    "img2img is not supported (use mode='inpaint')")
            if sched != "ddim":
                raise ValueError("img2img serving samples with ddim only")
        elif nine_ch:
            if sched != "ddim":
                raise ValueError(
                    "9-channel inpainting serving samples with ddim only")
            if pending.lora_idx is not None:
                raise ValueError("lora_idx routing is not supported on the "
                                 "9-channel inpainting path")
            return  # strength does not apply
        elif sched == "pndm":
            raise ValueError("latent-blend inpainting does not support the "
                             "pndm scheduler")
        if int(pending.steps * pending.strength) <= 0:
            raise ValueError(
                f"strength={pending.strength} leaves zero denoising steps at "
                f"steps={pending.steps}")

    # -- micro-batching worker ----------------------------------------------
    def _window_remaining(self, group, window_end: float) -> float:
        """Seconds the coalescer may still wait: the fixed window, cut early
        when any member's latency budget minus the EWMA-estimated batch
        execution time is nearly spent."""
        w = window_end - time.monotonic()
        est = self._exec_ewma or 0.0
        for p in group:
            if p.deadline is not None:
                w = min(w, p.deadline - est - time.monotonic())
        return w

    def _collect(self) -> list:
        """Block for one request, then coalesce same-config arrivals within
        the deadline-aware window (a config mismatch is spilled to seed the
        next batch)."""
        first = self._spill or self._queue.get()
        self._spill = None
        group = [first]
        with self._shed_lock:  # first leaves the queue -> starts executing
            self._queued_rows -= first.n_rows
            first._dequeued = True
        rows = first.n_rows
        window_end = time.monotonic() + self.batch_window
        # cap by ROW count: the bucketed device batch never exceeds
        # max_batch, the largest warmed bucket
        while rows < self.max_batch:
            remaining = self._window_remaining(group, window_end)
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if (nxt.key() == first.key()
                    and rows + nxt.n_rows <= self.max_batch):
                group.append(nxt)
                rows += nxt.n_rows
                with self._shed_lock:
                    self._queued_rows -= nxt.n_rows
                    nxt._dequeued = True
            else:
                # the spill stays logically queued (it seeds the next
                # batch), so its rows remain counted against max_queue
                self._spill = nxt
                break
        return group

    def _note_exec_time(self, seconds: float) -> None:
        self._exec_ewma = (seconds if self._exec_ewma is None
                           else 0.3 * seconds + 0.7 * self._exec_ewma)

    def _fail_stranded(self, p: "_Pending", err: Exception) -> None:
        """Fail a pending the dead scheduler will never pull, undoing its
        admit-time accounting exactly once (idempotent: the crash-drain and
        a waiter's watchdog may both call it). Skips requests already done
        or already in a cut group."""
        with self._idle:  # _idle shares _shed_lock
            if p.done.is_set() or p._failed:
                return
            p._failed = True
            if not p._dequeued:
                self._queued_rows -= p.n_rows
            self._inflight -= 1
            self._idle.notify_all()
        p.error = err
        p.done.set()

    def _drain(self):
        try:
            while True:
                group = self._collect()
                t0 = time.monotonic()
                try:
                    self._run_group(group)
                    self._note_exec_time(time.monotonic() - t0)
                except Exception as e:
                    for p in group:
                        p.error = e
                except BaseException as e:
                    # about to kill the scheduler: the in-flight group gets
                    # the same SchedulerDown contract as queued waiters
                    for p in group:
                        p.error = SchedulerDown(
                            f"serving scheduler crashed: {e!r}")
                    raise
                finally:
                    for p in group:
                        p.batched_with = len(group)
                        p.done.set()
                    with self._idle:
                        self._inflight -= len(group)
                        if self._inflight == 0:
                            self._idle.notify_all()
        except BaseException as e:  # never die SILENTLY: flip healthz,
            # refuse admits, and fail every waiter so no request hangs
            self._fatal = e
            err = SchedulerDown(f"serving scheduler crashed: {e!r}")
            stranded = [self._spill] if self._spill is not None else []
            self._spill = None
            while True:
                try:
                    stranded.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            for p in stranded:
                self._fail_stranded(p, err)
            print("lora_serve: FATAL scheduler crash "
                  f"({len(stranded)} queued requests failed)",
                  file=sys.stderr)
            traceback.print_exc(file=sys.stderr)

    def _cached_embeds(self, texts: list, alpha):
        """Encode `texts`, serving repeats from the LRU cache (caller holds
        the pipe lock and has already applied `alpha`): the stacked
        embeddings, or for SDXL the stacked (context, pooled) pair."""
        missing = [t for t in dict.fromkeys(texts)
                   if (t, alpha) not in self._embeds]
        if missing:
            if self._is_xl:
                ctx, pooled = self.pipe.encode_prompt_xl(missing)
                fresh = list(zip(ctx, pooled))
            else:
                fresh = self.pipe.encode_prompt(missing)
            for t, e in zip(missing, fresh):
                self._embeds[(t, alpha)] = e
        self.embed_cache_misses += len(missing)
        self.embed_cache_hits += len(texts) - len(missing)
        rows = []
        for t in texts:
            self._embeds.move_to_end((t, alpha))
            rows.append(self._embeds[(t, alpha)])
        while len(self._embeds) > self._embed_cache_size:
            self._embeds.popitem(last=False)
        if self._is_xl:
            return tuple(torch.stack(part) for part in zip(*rows))
        return torch.stack(rows)

    def _embed_key_alpha(self):
        """The embed cache's adapter component: the adapter generation (a
        patch_pipe / apply_ti / remove_lora on a live server invalidates
        the entries) and the EFFECTIVE text alpha, from the pipe (not the
        request field: a request that omits alpha runs at the current
        scale, which may have been tuned before the server started): the
        text LoRA's scale, and the alpha the text encoder's LyCORIS base
        deltas were last applied at (a file of norm modules alone leaves
        no text LoRA, yet its embeddings follow alpha), for each text
        encoder (SDXL: te1 and te2). Without any, the embeddings do not
        depend on alpha: one entry per text. Unlike lora_tpu, which tracks
        the last request's alpha from an assumed 1.0, this key holds
        whatever scale the pipe was given. Caller holds the pipe lock."""
        gen = self.pipe.adapter_generation
        parts = []
        for model, attr in self.pipe._TEXT_LORAS:
            lora = getattr(self.pipe, attr)
            parts += [None if lora is None else tuple(
                lora["scale"].reshape(-1).tolist()),
                self.pipe.base_delta_alpha(model)]
        if all(p is None for p in parts):
            return gen, None
        return gen, tuple(parts)

    def _assemble_rows(self, group: list):
        """Flatten a coalesced group into device-batch rows: (prompts padded
        up to the chosen bucket by repeating the last row, per-request row
        counts, the merged per-row lora_idx or None, the pad count)."""
        prompts, counts = [], []
        lora_idx: Optional[list] = []
        for p in group:
            pr = p.req.get("prompt", "")
            pr = [pr] if isinstance(pr, str) else list(pr)
            prompts += pr
            counts.append(len(pr))
            if lora_idx is not None and p.lora_idx is not None:
                lora_idx += p.lora_idx
            else:
                lora_idx = None
        n_real = len(prompts)
        bucket = next((b for b in self.batch_buckets if b >= n_real), n_real)
        self.last_device_batch = bucket
        pad = bucket - n_real
        if pad:
            prompts += [prompts[-1]] * pad
            if lora_idx is not None:
                lora_idx += [lora_idx[-1]] * pad
        return prompts, counts, lora_idx, pad

    @torch.inference_mode()
    def _run_group(self, group: list):
        if group[0].mode != "txt2img":
            self._run_image_group(group)
            return
        r0 = group[0].req
        height, width = int(r0.get("height", 512)), int(r0.get("width", 512))
        prompts, counts, lora_idx, pad = self._assemble_rows(group)
        dev = self.pipe.device
        latents = [self.pipe.prepare_latents(
            n, height, width, torch.Generator(device=dev).manual_seed(p.seed))
            for p, n in zip(group, counts)]
        guidance = float(r0.get("guidance", 7.5))
        negative = r0.get("negative_prompt", "")
        if pad:
            latents.append(latents[-1][-1:].expand(pad, -1, -1, -1))
        with self.lock:
            emb, neg = self._group_embeds(r0, prompts, guidance, negative)
            imgs = self.pipe(
                None,
                num_inference_steps=group[0].steps,
                guidance_scale=guidance,
                height=height, width=width,
                scheduler=r0.get("scheduler", "ddim"),
                latents=torch.cat(latents),
                lora_idx=lora_idx,
                prompt_embeds=emb,
                negative_prompt_embeds=neg,
                # euler_a's step noise, batch-wide from the first member
                generator=torch.Generator(device=dev).manual_seed(
                    group[0].seed),
            )
        self._scatter(group, counts, imgs)

    def _group_embeds(self, r0: dict, prompts: list, guidance: float,
                      negative: str):
        """The group's prompt and (with CFG) negative embeddings from the
        cache, after applying the group's alpha (caller holds the pipe
        lock)."""
        alpha = r0.get("alpha")
        if alpha is not None:
            self.pipe.tune_lora_scale(float(alpha))
        emb = self._cached_embeds(prompts, self._embed_key_alpha())
        neg = (self._cached_embeds([negative] * len(prompts),
                                   self._embed_key_alpha())
               if guidance > 1.0 else None)
        return emb, neg

    @staticmethod
    def _scatter(group: list, counts: list, imgs) -> None:
        off = 0
        for p, n in zip(group, counts):
            p.images = imgs[off:off + n]
            off += n

    @torch.inference_mode()
    def _run_image_group(self, group: list):
        """img2img / inpaint micro-batch: rows are (prompt, image[, mask])
        triples, coalesced and bucket-padded as txt2img's are (key() adds
        mode and strength; the init image pins height/width). The group's
        randomness (VAE posterior sample, init noise, euler_a's step noise)
        is drawn batch-wide from the FIRST member's seed: per-row seeding
        would need per-row posterior draws the pipelines do not expose, so
        image-mode reproducibility is per (seed, batch composition), as in
        lora_tpu. Prompt rows come from the embed cache."""
        r0 = group[0].req
        prompts, counts, lora_idx, pad = self._assemble_rows(group)
        images = np.concatenate([p.image for p in group])
        masks = (np.concatenate([p.mask for p in group])
                 if group[0].mask is not None else None)
        if pad:
            images = np.concatenate([images, np.repeat(images[-1:], pad, 0)])
            if masks is not None:
                masks = np.concatenate([masks, np.repeat(masks[-1:], pad, 0)])
        dev = self.pipe.device
        image = torch.from_numpy(images).to(dev)
        mask = None if masks is None else torch.from_numpy(masks).to(dev)
        guidance = float(r0.get("guidance", 7.5))
        kw = dict(num_inference_steps=group[0].steps, guidance_scale=guidance,
                  generator=torch.Generator(device=dev).manual_seed(
                      group[0].seed))
        with self.lock:
            kw["prompt_embeds"], kw["negative_prompt_embeds"] = \
                self._group_embeds(r0, prompts, guidance,
                                   r0.get("negative_prompt", ""))
            if group[0].mode == "img2img":
                imgs = self.pipe.img2img(None, image,
                                         strength=group[0].strength,
                                         lora_idx=lora_idx, **kw)
            elif self._nine_channel():
                imgs = self.pipe.inpaint(None, image, mask, **kw)
            else:
                imgs = self.pipe.inpaint_blend(
                    None, image, mask, strength=group[0].strength,
                    scheduler=r0.get("scheduler", "ddim"), lora_idx=lora_idx,
                    **kw)
        self._scatter(group, counts, imgs)

    def warmup(self, steps: int = 30, height: int = 512, width: int = 512,
               guidance: float = 7.5, scheduler: str = "ddim",
               modes: tuple = ("txt2img",), strength: float = 0.8) -> float:
        """Run one group per batch bucket at this sampling config and each
        of `modes` before taking traffic (deploy-time warmup: the first call
        of each batch shape pays the one-off costs: allocator growth, kernel
        builds). Image modes run on a black height x width image (and an
        all-repaint mask); the init image pins their size, so warm the sizes
        you will receive. A mode the checkpoint cannot serve raises, as a
        live request would. Returns the wall seconds spent."""
        t0 = time.monotonic()
        img = mask = None
        if any(m != "txt2img" for m in modes):
            img = _png_b64(np.zeros((height, width, 3), np.float32))
            mask = _png_b64(np.ones((height, width, 3), np.float32))
        for mode in modes:
            base = {"steps": steps, "height": height, "width": width,
                    "guidance": guidance, "scheduler": scheduler,
                    "mode": mode, "strength": strength, "image": img,
                    "mask": mask if mode == "inpaint" else None}
            self._check_image_mode(_Pending({"prompt": "warmup probe",
                                             **base}))
            for b in self.batch_buckets:
                self._run_group([_Pending({"prompt": f"warmup {i}",
                                           "seed": i, **base})
                                 for i in range(b)])
        return time.monotonic() - t0

    def metrics(self) -> dict:
        """Counters for dashboards/autoscalers (also GET /metrics); all
        monotonic or instantaneous, safe to scrape at any rate."""
        with self._shed_lock:
            return {
                "uptime_s": round(time.monotonic() - self._t_started, 1),
                "requests": self.request_count,
                "images": self.image_count,
                "shed": self.shed_count,
                "inflight": self._inflight,
                "queue_depth": self._queue.qsize(),
                "queued_rows": self._queued_rows,
                "draining": self.draining,
                "last_device_batch": self.last_device_batch,
                "exec_ewma_s": (round(self._exec_ewma, 4)
                                if self._exec_ewma is not None else None),
                "embed_cache_hits": self.embed_cache_hits,
                "embed_cache_misses": self.embed_cache_misses,
                "scheduler_alive": self._fatal is None,
            }

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown, phase 1: stop admitting (new requests are shed
        with 503) and wait until every admitted request has completed.
        True when fully drained, False on timeout."""
        with self._idle:
            self.draining = True
            return self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout)

    def start(self):
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self

    def stop(self):
        # shutdown() blocks on serve_forever()'s exit handshake: only call
        # it on a started server
        if self.thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m lora_tpu_torch.serve",
        description="Serve txt2img, img2img and inpainting from a "
                    "diffusers-layout SD or SDXL checkpoint.")
    ap.add_argument("--model", required=True)
    ap.add_argument("--lora", default=None)
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 base weights (pipe.quantize_base())")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--batch_window_ms", type=float, default=25.0)
    ap.add_argument("--max_queue", type=int, default=32)
    ap.add_argument("--batch_buckets", default=None,
                    help="comma-separated allowed device batch sizes "
                         "(largest must equal --max_batch); default: "
                         "powers of two up to max_batch")
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip the deploy-time run of every batch bucket")
    ap.add_argument("--warmup_steps", type=int, default=30,
                    help="sampler steps used for the warmup config")
    ap.add_argument("--warmup_modes", default="txt2img",
                    help="comma-separated modes to warm "
                         "(txt2img,img2img,inpaint); image modes warm at "
                         "the default 512px size")
    args = ap.parse_args(argv)
    # validate before the model loads: a typo must not cost a checkpoint
    # load and a warmup before it fails
    try:
        buckets = (tuple(int(b.strip())
                         for b in args.batch_buckets.split(",") if b.strip())
                   if args.batch_buckets else None)
    except ValueError:
        ap.error(f"--batch_buckets: expected comma-separated ints, got "
                 f"{args.batch_buckets!r}")
    warm_modes = tuple(m.strip()
                       for m in args.warmup_modes.split(",") if m.strip())
    for m in warm_modes:
        if m not in MODES:
            ap.error(f"--warmup_modes: unknown mode {m!r}; expected "
                     "txt2img | img2img | inpaint")
    if not warm_modes and not args.no_warmup:
        ap.error("--warmup_modes is empty; pass --no_warmup to skip warmup")
    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        ap.error(f"--device: {e}")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: CUDA is not available on this "
                 "host")
    # an SDXL directory carries a second text encoder: serve it with the
    # dual-encoder pipeline
    if os.path.isdir(os.path.join(args.model, "text_encoder_2")):
        from .pipelines.sdxl import StableDiffusionXLPipeline as Pipe
    else:
        from .pipelines.sd import StableDiffusionPipeline as Pipe

    pipe = Pipe.from_pretrained(args.model, dtype=torch.bfloat16,
                                device=device)
    if args.lora:
        pipe.patch_pipe(args.lora)
    if args.quantize:
        pipe.quantize_base()
    srv = PipelineServer(pipe, port=args.port, max_batch=args.max_batch,
                         batch_window_ms=args.batch_window_ms,
                         max_queue=args.max_queue,
                         batch_buckets=buckets)
    if not args.no_warmup:
        spent = srv.warmup(steps=args.warmup_steps, modes=warm_modes)
        print(f"warmup ran buckets {srv.batch_buckets} in {spent:.1f}s")
    srv.start()
    print(f"serving on :{srv.port}", flush=True)

    # graceful shutdown: on SIGTERM/SIGINT stop admitting (503), finish
    # everything already in the queue, then exit
    import signal

    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
    signal.signal(signal.SIGINT, lambda *_: stop_evt.set())
    stop_evt.wait()
    print("draining...")
    drained = srv.drain(timeout=float(
        os.environ.get("LORA_TPU_DRAIN_TIMEOUT_S", 120)))
    srv.stop()
    print(f"drained={drained} served={srv.request_count} "
          f"shed={srv.shed_count}")


if __name__ == "__main__":
    main()
