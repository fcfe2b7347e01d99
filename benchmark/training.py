"""The DreamBooth-LoRA training runner: the step as the port's
train_dreambooth composes it (DreamBoothDataset through data_loader,
prefetch and device_prefetch; make_train_step's step over the frozen base;
make_optimizer's AdamW), with the noise, the timesteps and the VAE
posterior noise handed in through the step's draw seams.

Set-up builds one step object and runs its first `checked_steps` steps
through the same call and feed as the window; the window goes on from
there. Left out of train_dreambooth's loop: the periodic and final saves,
the loss read-back every 10 steps and the SIGTERM poll.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import numpy as np
import torch

from . import compare, inputs, port
from .fileio import png_decode
from .profiling import Profiler
from .reference import dreambooth as ref_db
from .reference import sd

LIBRARIES = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")


def named_leaves(trainable: dict):
    """(leaf name, tensor) in the optimizer's order (its groups in order,
    each group's leaves by sorted keys), named as the reference names
    them."""
    out = []
    for group, model in (("lora_unet", "unet"), ("lora_text", "text_encoder")):
        tree = trainable[group]
        out.append((f"{model}.scale", tree["scale"]))
        for site in sorted(tree["sites"]):
            e = tree["sites"][site]
            out += [(f"{model}.{site}.down", e["down"]),
                    (f"{model}.{site}.up", e["up"])]
    return out


def init_lora(cfg: dict, seed: int, rank: int, device) -> Dict[str, dict]:
    """The adapter training starts from (a resumed one: every factor
    nonzero), {model: {"scale", "sites": {site: (up, down)}}}, float32."""
    from .reference.tokens import text_sites, unet_sites

    g = inputs.generator(seed, "train.lora", device)
    shapes = {n: s for m in inputs.model_shapes(cfg).values()
              for n, s, _ in m}
    out = {}
    for model, sites in (("unet", unet_sites(cfg["unet"])),
                         ("text_encoder", text_sites(cfg["text_encoder"]))):
        tree = {}
        for site in sites:
            o, i = shapes[site + ".weight"]
            down = torch.randn((rank, i), generator=g, device=device) / rank
            up = 0.01 * torch.randn((o, rank), generator=g, device=device)
            tree[site] = (up, down)
        out[model] = {"scale": torch.ones((), device=device), "sites": tree}
    return out


class TrainCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, tmpdir: str):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.tmpdir = tmpdir
        self.rows = 2 * mix["train_batch_size"]
        self.checked: dict = {}
        self.steps = 0
        self.t0 = self.t1 = 0.0
        self.wait_s: List[float] = []
        self.trace = self.labels = None
        self.trace_steps = 0
        self.trace_launches = {}
        self.cut = (0, 0.0)  # steps and seconds of the traced part
        self.step_index = 0

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from lora_tpu_torch.core.lora import init_lora as port_init
        from lora_tpu_torch.core.sites import (
            text_encoder_lora_sites,
            unet_lora_sites,
        )
        from lora_tpu_torch.data.dataset import (
            DreamBoothDataset,
            data_loader,
            device_prefetch,
            prefetch,
        )
        from lora_tpu_torch.training.loss import LossConfig
        from lora_tpu_torch.training.optim import (
            make_lr_schedule,
            make_optimizer,
        )
        from lora_tpu_torch.training.train_step import (
            make_train_step,
            make_trainable,
        )

        mix, dev = self.mix, self.device
        if dev.type == "cuda":
            port.build_libraries(LIBRARIES)
        self.inst_dir, self.class_dir = inputs.write_training_images(
            self.tmpdir, mix["num_instance_images"], mix["num_class_images"],
            mix["resolution"], self.seed)
        weights = inputs.make_weights(self.cfg, self.seed, dev,
                                      self.dtype)
        pipe = port.build_pipe(self.cfg, weights, None, 1.0, self.dtype)
        del weights
        self.pipe = pipe
        ds = DreamBoothDataset(
            instance_data_root=self.inst_dir,
            instance_prompt=mix["instance_prompt"], tokenizer=pipe.tokenizer,
            class_data_root=self.class_dir, class_prompt=mix["class_prompt"],
            size=mix["resolution"], color_jitter=mix["color_jitter"],
            seed=self.seed)
        self._host = prefetch(data_loader(
            ds, mix["train_batch_size"], seed=self.seed,
            prior_preservation=True))
        self.loader = device_prefetch(self._host, device=dev)
        # the trainer's own trees, filled with the benchmark's start
        start = init_lora(self.cfg, self.seed, mix["lora_rank"], dev)
        trainable = {}
        for group, model, sites in (
                ("lora_unet", "unet", unet_lora_sites(pipe.unet.cfg)),
                ("lora_text", "text_encoder",
                 text_encoder_lora_sites(pipe.text_encoder.cfg))):
            tree = port_init(sites, r=mix["lora_rank"],
                             generator=torch.Generator(dev).manual_seed(0),
                             device=dev)
            for site, entry in tree["sites"].items():
                up, down = start[model]["sites"][site]
                entry["up"].copy_(up)
                entry["down"].copy_(down)
            trainable[group] = tree
        make_trainable(trainable)
        self.trainable = trainable
        total = mix["checked_steps"] + 10_000
        self.opt = make_optimizer(
            trainable,
            {"lora_unet": make_lr_schedule("constant", mix["learning_rate"],
                                           total, 0),
             "lora_text": make_lr_schedule("constant",
                                           mix["learning_rate_text"],
                                           total, 0)},
            weight_decay=mix["adam_weight_decay"],
            max_grad_norm=mix["max_grad_norm"])
        self.step_fn = make_train_step(
            unet_cfg=pipe.unet.cfg, text_cfg=pipe.text_encoder.cfg,
            vae_cfg=pipe.vae.cfg, sched=pipe.schedule,
            loss_cfg=LossConfig(cached_latents=False,
                                with_prior_preservation=True,
                                prior_loss_weight=mix["prior_loss_weight"]),
            optimizer=self.opt, dtype=self.dtype)
        self.base = (pipe.unet.flat_params(), pipe.text_encoder.flat_params(),
                     pipe.vae.flat_params())
        names = named_leaves(trainable)
        if [id(t) for _, t in names] != [id(t) for t in self.opt.params]:
            raise RuntimeError("leaf order differs from the optimizer's")
        self.checked["p0"] = {n: t.detach().clone() for n, t in names}
        losses = []
        for s in range(mix["checked_steps"]):
            losses.append(self.step())
            if s == 0:  # the first moment after one step: (1 - b1) g
                st = self.opt.state_tensors()[1:]
                b1 = self.opt.betas[0]
                self.checked["grad1"] = {
                    n: st[3 * i + 1].detach().float() / (1 - b1)
                    for i, (n, _) in enumerate(names)}
        self.checked["p3"] = {n: t.detach().clone() for n, t in names}
        self.checked["losses"] = [float(x) for x in losses]
        port.synchronize(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def step(self) -> torch.Tensor:
        """One training step through the loader and the step function."""
        t = time.perf_counter()
        batch = next(self.loader)
        self.wait_s.append(time.perf_counter() - t)
        self.step_index += 1
        vae_noise, noise, ts = inputs.step_draws(
            self.seed, self.step_index, self.rows,
            (self.mix["resolution"] // 8,) * 2, self.device,
            self.cfg["scheduler"]["num_train_timesteps"], self.dtype)
        return self.step_fn(self.trainable, self.base, batch,
                            noise=noise, timesteps=ts, vae_noise=vae_noise)

    # -- the window -----------------------------------------------------
    def run(self, seconds: float, trace: bool) -> None:
        port.synchronize(self.device)
        self.wait_s = []
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        while time.perf_counter() < end:
            if trace and self.steps == self.mix["trace_after_steps"]:
                self._traced(self.mix["trace_steps"])
            self.step()
            self.steps += 1
        port.synchronize(self.device)
        self.t1 = time.perf_counter()

    def _traced(self, k: int) -> None:
        """Profile k whole steps: the device idle at both ends. The steps
        from here to the end of the label span, which the profiler holds
        up, are left out of the rate that mfu.train reads (self.cut)."""
        t_cut, s_cut = time.perf_counter(), self.steps
        port.synchronize(self.device)
        prof = Profiler(host=False)
        c0 = port.flash_launches()
        prof.start()
        for _ in range(k):
            self.step()
            self.steps += 1
        port.synchronize(self.device)
        c1 = port.flash_launches()
        prof.mark()
        prof.stop()
        self.trace_steps = k
        self.trace_launches = {w: c1[w] - c0[w] for w in c1}
        labels = Profiler(host=True)
        labels.start()
        for _ in range(self.mix["label_steps"]):
            self.step()
            self.steps += 1
        port.synchronize(self.device)
        labels.stop()
        self.trace, self.labels = prof, labels
        self.cut = (self.steps - s_cut, time.perf_counter() - t_cut)

    # -- results --------------------------------------------------------
    def end_to_end(self) -> dict:
        return {"train_images_per_s":
                self.steps * self.rows / (self.t1 - self.t0)}

    def counts(self):
        return self.steps, 0

    def per_layer_context(self) -> dict:
        from . import flops

        mix = self.mix
        r = mix["resolution"]
        steps, seconds = self.cut
        return {"cell_kind": "train_db",
                "trace": self.trace and self.trace.summary(),
                "labels": self.labels and self.labels.summary(),
                "trace_steps": self.trace_steps,
                "flash_launches": self.trace_launches,
                "flash_levels": flops.flash_levels(self.cfg["unet"], r, r),
                "unet_batch": self.rows,
                "step_flops": flops.train_step_flops(self.cfg, r, self.rows),
                "steps_per_s": (self.steps - steps)
                / (self.t1 - self.t0 - seconds),
                "data_wait_s": list(self.wait_s)}

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def close(self) -> None:
        self.loader.close()
        self._host.close()
        self.pipe = self.trainable = self.opt = self.step_fn = None
        self.base = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def reference(self, control: bool = False) -> dict:
        """The reference's checked steps on the same rows and draws (with
        control=True in the control's fp8 operands)."""
        mix, cfg, dev = self.mix, self.cfg, self.device
        with sd.plain_float32(), compare.precision(control):
            _, params = compare.reference_params(cfg, self.seed, dev)
            lora = init_lora(cfg, self.seed, mix["lora_rank"], dev)
            read = {}

            def image(d, i):
                key = (d, i)
                if key not in read:
                    path = os.path.join(d, f"{i:03d}.png")
                    with open(path, "rb") as f:
                        read[key] = png_decode(f.read())
                return read[key]

            from .reference.tokens import token_ids
            vocab = cfg["text_encoder"]["vocab_size"]
            ids_i = token_ids(mix["instance_prompt"], vocab, {})
            ids_c = token_ids(mix["class_prompt"], vocab, {})
            stream = ref_db.sample_stream(
                mix["num_instance_images"], mix["num_class_images"],
                mix["train_batch_size"], self.seed)
            batches = []
            n = mix["train_batch_size"]
            for step in range(1, mix["checked_steps"] + 1):
                inst, cls = next(stream)
                px = [ref_db.pixels(image(self.inst_dir, i), (b, c))
                      for i, b, c in inst]
                px += [ref_db.pixels(image(self.class_dir, i)) for i in cls]
                vae_noise, noise, ts = inputs.step_draws(
                    self.seed, step, self.rows, (mix["resolution"] // 8,) * 2,
                    dev, cfg["scheduler"]["num_train_timesteps"],
                    self.dtype)
                batches.append({
                    "pixels": torch.from_numpy(np.stack(px)).to(dev).permute(
                        0, 3, 1, 2),
                    "ids": torch.tensor([ids_i] * n + [ids_c] * n,
                                        device=dev),
                    "is_instance": torch.tensor([1.0] * n + [0.0] * n),
                    "vae_noise": vae_noise.float().permute(0, 3, 1, 2),
                    "noise": noise.float().permute(0, 3, 1, 2),
                    "timesteps": ts})
            p0 = {n: t.detach().clone() for n, t in ref_db.leaves(lora)}
            out = ref_db.train_steps(params, cfg, lora, batches, {
                "lr": {"unet": mix["learning_rate"],
                       "text_encoder": mix["learning_rate_text"]},
                "weight_decay": mix["adam_weight_decay"],
                "betas": (0.9, 0.999), "eps": 1e-8,
                "max_grad_norm": mix["max_grad_norm"],
                "prior_loss_weight": mix["prior_loss_weight"]})
        return {"losses": out["losses"], "grad1": out["grad1"], "p0": p0,
                "p3": out["after"][-1]}

    def check(self, control: bool = False) -> dict:
        """The checked steps against the reference's (with control=True
        the control's steps in their place); call after close()."""
        ref = self.reference()
        prog = self.reference(control=True) if control else self.checked
        return compare.train_numbers(prog, ref)
