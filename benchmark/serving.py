"""The serving runner: the port's PipelineServer in process, driven through
`generate` (the call its HTTP handler makes, without the socket) by a
closed loop of client threads or by open-loop arrivals, then a sample of
the served images checked against the plain reference.

Closed loop: each client sends its next request when its last returns.
Open loop: requests are sent at their arrival times whatever the server
does, each on its own thread, and timed from when they were due.
"""

from __future__ import annotations

import base64
import dataclasses
import gc
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from . import compare, flops, inputs, port, windows
from .fileio import png_decode
from .profiling import Profiler

LIBRARIES = ("flash_fwd_wgmma",)


@dataclasses.dataclass
class Request:
    prompt: str
    seed: int
    guidance: float
    t_due: float
    t_done: Optional[float] = None
    png: Optional[str] = None
    batched_with: int = 0
    error: Optional[str] = None


class ServeCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 tmpdir: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.tmpdir = tmpdir
        self.srv = None
        self.requests: List[Request] = []
        self.t0 = self.t1 = 0.0
        self.trace = self.labels = None
        self.trace_launches = 0
        self.cut = None  # (start, end) of the traced part of the window

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from lora_tpu_torch.serve import PipelineServer

        mix = self.mix
        if self.device.type == "cuda":
            port.build_libraries(LIBRARIES)
        weights = inputs.make_weights(self.cfg, self.seed, self.device,
                                      self.dtype)
        lora, ti = inputs.make_lora(self.cfg, weights, self.seed,
                                    mix["lora_rank"], self.device)
        path = os.path.join(self.tmpdir, "adapter.safetensors")
        with open(path, "wb") as f:
            f.write(inputs.lora_file_bytes(self.cfg, lora, ti))
        del lora
        pipe = port.build_pipe(self.cfg, weights, path, mix["lora_scale"],
                               self.dtype)
        del weights
        self.srv = PipelineServer(
            pipe, host="127.0.0.1", port=0, max_batch=mix["max_batch"],
            batch_window_ms=mix["batch_window_ms"],
            max_queue=mix["max_queue"],
            batch_buckets=tuple(mix["batch_buckets"]))
        for g in sorted({g for g, _ in mix["guidance_mix"]}):
            self.srv.warmup(steps=mix["warmup_steps"], height=mix["height"],
                            width=mix["width"], guidance=g,
                            scheduler=mix["scheduler"])
        port.synchronize(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _request(self, r: Request) -> None:
        mix = self.mix
        try:
            out = self.srv.generate({
                "prompt": r.prompt, "seed": r.seed, "guidance": r.guidance,
                "steps": mix["steps"], "height": mix["height"],
                "width": mix["width"], "scheduler": mix["scheduler"],
                "negative_prompt": mix["negative_prompt"]})
            r.png, r.batched_with = out["images"][0], out["batched_with"]
        except Exception as e:  # a refused or failed request misses
            r.error = f"{type(e).__name__}: {e}"
        r.t_done = time.perf_counter()

    # -- the window -----------------------------------------------------
    def run(self, seconds: float, trace: bool) -> None:
        if self.mix["runner"] == "serve_closed":
            self._closed(seconds, trace)
        else:
            self._open(seconds, trace)

    def _traced(self, t_start: float, seconds: float) -> None:
        """Profile whole groups from about t_start for about `seconds`: the
        server's pipe lock, held between groups, delimits the span, and
        the device is idle at both ends, so every flash launch counted on
        the host inside is in the trace. The lock is held only to start
        the profiler and to mark the span's end; the profiler stops after
        the lock is let go. The window's rate in a traced run leaves out
        what completes from here to the end of the label span (self.cut),
        in which the profiler holds the program up."""
        time.sleep(max(0.0, t_start - time.perf_counter()))
        t_cut = time.perf_counter()
        prof = Profiler(host=False)
        with self.srv.lock:
            port.synchronize(self.device)
            c0 = port.flash_launches()["fwd"]
            prof.start()
        time.sleep(seconds)
        with self.srv.lock:
            port.synchronize(self.device)
            self.trace_launches = port.flash_launches()["fwd"] - c0
            prof.mark()
        prof.stop()
        labels = Profiler(host=True)
        labels.start()
        time.sleep(self.mix["label_s"])
        labels.stop()
        self.trace, self.labels = prof, labels
        self.cut = (t_cut, time.perf_counter())

    def _closed(self, seconds: float, trace: bool) -> None:
        mix = self.mix
        prompts = inputs.prompt_templates(mix)
        lock = threading.Lock()
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + seconds

        def client(c: int):
            rng = np.random.default_rng(inputs.sub_seed(self.seed,
                                                        f"client.{c}"))
            while time.perf_counter() < self.t1:
                k = int(inputs.zipf_choices(rng, len(prompts), mix["zipf_s"],
                                            1)[0])
                r = Request(prompts[k], int(rng.integers(0, 2**31 - 1)),
                            mix["guidance_mix"][0][0], time.perf_counter())
                self._request(r)
                with lock:
                    self.requests.append(r)

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(mix["clients"])]
        for t in threads:
            t.start()
        if trace:
            self._traced(self.t0 + mix["trace_after_s"], mix["trace_s"])
        for t in threads:
            t.join(timeout=seconds + mix["wait_after_s"])

    def _open(self, seconds: float, trace: bool) -> None:
        mix = self.mix
        prompts = inputs.prompt_templates(mix)
        due = inputs.arrivals(mix, seconds, self.seed)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "requests"))
        n = len(due)
        picks = inputs.zipf_choices(rng, len(prompts), mix["zipf_s"], n)
        counts = [int(round(share * n)) for _, share in mix["guidance_mix"]]
        counts[0] += n - sum(counts)
        guid = rng.permutation(np.repeat(
            [g for g, _ in mix["guidance_mix"]], counts))
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + seconds
        self.requests = [Request(prompts[int(k)], int(rng.integers(0, 2**31 - 1)),
                                 float(g), self.t0 + float(a))
                         for k, g, a in zip(picks, guid, due)]
        threads = []

        def dispatch():
            for r in self.requests:
                time.sleep(max(0.0, r.t_due - time.perf_counter()))
                t = threading.Thread(target=self._request, args=(r,),
                                     daemon=True)
                t.start()
                threads.append(t)

        d = threading.Thread(target=dispatch, daemon=True)
        d.start()
        if trace:
            self._traced(self.t0 + mix["trace_after_s"], mix["trace_s"])
        d.join()
        deadline = self.t1 + mix["wait_after_s"]
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))

    # -- results --------------------------------------------------------
    def _group_rate(self, cut=None) -> float:
        """The closed loop's images per second (windows.group_rate)."""
        done = [(r.t_done, 1) for r in self.requests
                if r.error is None and r.t_done]
        return windows.group_rate(done, self.t0, self.t1,
                                  self.mix["group_gap_s"], cut)[0]

    def end_to_end(self) -> dict:
        mix = self.mix
        out = {}
        if mix["runner"] == "serve_closed":
            out["images_per_s"] = self._group_rate()
        else:
            deadline = self.t1 + mix["wait_after_s"]
            lat = [(r.t_done - r.t_due) if (r.error is None and r.t_done
                                             and r.t_done <= deadline)
                   else deadline - r.t_due for r in self.requests]
            out["latency_p80_s"] = windows.nearest_rank(lat, 0.8)
        return out

    def counts(self):
        """(requests sent in the window, of them refused or failed)."""
        sent = [r for r in self.requests if r.t_due <= self.t1]
        return len(sent), sum(1 for r in sent if r.error is not None
                              or r.t_done is None)

    def per_layer_context(self) -> dict:
        """What the per-layer readers read."""
        mix, cfg = self.mix, self.cfg
        ok = [r for r in self.requests if r.error is None and r.t_done]
        in_window = [r for r in ok if r.t_done <= self.t1]
        h, w = mix["height"], mix["width"]
        per_image = flops.image_flops(cfg, h, w, mix["steps"])
        ctx = {"cell_kind": mix["runner"],
               "trace": self.trace and self.trace.summary(),
               "labels": self.labels and self.labels.summary(),
               "flash_fwd_launches": self.trace_launches,
               "flash_levels": flops.flash_levels(cfg["unet"], h, w),
               "unet_batch": 2 * mix["max_batch"],
               "batched_with": [r.batched_with for r in in_window],
               "image_flops": per_image}
        # the rates leave out the traced part of the window (self.cut)
        if mix["runner"] == "serve_closed":
            ctx["images_per_s"] = self._group_rate(self.cut)
        else:
            a, b = self.cut or (self.t1, self.t1)
            done = [r for r in in_window if not a <= r.t_done <= b]
            ctx["images_per_s"] = len(done) / (self.t1 - self.t0 - (b - a))
        return ctx

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def close(self) -> None:
        """Stop the server's socket and free the program's state."""
        if self.srv is not None:
            self.srv.stop()
            self.srv.pipe = None
            self.srv = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def sample(self) -> List[Request]:
        """Every request of one served group, drawn from the seed among the
        largest groups whose requests all came back, so that a fault in
        any one row of a batch shows. A group's requests complete together
        (windows.groups)."""
        ok = sorted((r for r in self.requests if r.error is None and r.png),
                    key=lambda r: r.t_done)
        by_time = {}
        for r in ok:
            by_time.setdefault(r.t_done, []).append(r)
        whole = []
        for g in windows.groups(by_time, self.mix["group_gap_s"]):
            reqs = [r for t in g for r in by_time[t]]
            if all(r.batched_with == len(reqs) for r in reqs):
                whole.append(reqs)
        if not whole:
            return []
        most = max(len(g) for g in whole)
        whole = [g for g in whole if len(g) == most]
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "check"))
        return whole[int(rng.integers(len(whole)))]

    def check(self, control: bool = False) -> dict:
        """The sampled requests' served images against the reference's
        (with control=True the control's images in their place); call
        after close()."""
        reqs = self.sample()
        ref = compare.reference_images(self.cfg, self.mix, self.seed,
                                       self.device, reqs)
        if control:
            served = compare.reference_images(self.cfg, self.mix, self.seed,
                                              self.device, reqs, True)
        else:
            served = [png_decode(base64.b64decode(r.png)) for r in reqs]
        return compare.image_numbers(served, ref, len(self.requests) > 0)
