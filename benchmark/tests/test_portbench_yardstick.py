"""The yardstick's arithmetic against hand counts: FLOPs, attention
bounds, the trace's busy time, the PNG codec and the metric readers."""

import numpy as np
import torch

from benchmark import fileio, flops, inputs
from benchmark.profiling import TraceSummary
from benchmark.reference import sd
from benchmark.run import read_metric


def test_counted_flops_match_hand_counts():
    p = {"l.weight": torch.empty(96, 64, device="meta"),
         "l.bias": torch.empty(96, device="meta"),
         "c.weight": torch.empty(16, 8, 3, 3, device="meta"),
         "c.bias": torch.empty(16, device="meta")}
    x = torch.empty(5, 7, 64, device="meta")
    assert flops.count_flops(lambda: sd.linear(p, "l", x)) == 2 * 35 * 64 * 96
    xc = torch.empty(2, 8, 10, 12, device="meta")
    assert flops.count_flops(lambda: sd.conv(p, "c", xc, padding=1)) == \
        2 * 2 * 16 * 10 * 12 * 8 * 9
    q = torch.empty(2, 3, 300, 16, device="meta")
    k = torch.empty(2, 3, 77, 16, device="meta")
    assert flops.count_flops(lambda: sd.attend(q, k, k)) == \
        4 * 2 * 3 * 300 * 77 * 16


def test_flash_bounds_by_hand():
    # T = S = 4096, D = 40, B*H = 32: compute-bound
    B, H, T, D = 4, 8, 4096, 40
    assert flops.flash_fwd_bound_s(B, H, T, T, D) == \
        4.0 * B * H * T * T * D / 989e12
    assert flops.flash_bwd_bound_s(B, H, T, T, D) == \
        10.0 * B * H * T * T * D / 989e12
    # tiny T: bandwidth-bound
    b = flops.flash_fwd_bound_s(1, 1, 128, 128, 64)
    assert b == 2 * 1 * 1 * (4 * 128) * 64 / 3.35e12


def test_flash_levels_are_the_programs_counts():
    """15 forward launches a SD-1.5 UNet call at 512 px; 10 a SD-2.1 call
    at 768 px (the T = 576 and 144 levels and every cross-attention take
    the plain path)."""
    sd15 = inputs.load_json("configs", "sd15.json")
    sd21 = inputs.load_json("configs", "sd21.json")
    l15 = flops.flash_levels(sd15["unet"], 512, 512)
    l21 = flops.flash_levels(sd21["unet"], 768, 768)
    assert len(l15) == 15 and {T for T, _, _ in l15} == {4096, 1024, 256}
    assert {D for _, _, D in l15} == {40, 80, 160}
    assert len(l21) == 10 and {(T, H, D) for T, H, D in l21} == {
        (9216, 5, 64), (2304, 10, 64)}


def test_trace_busy_is_the_union_of_intervals():
    dev = [("k1", 0, 100), ("k2", 50, 150), ("k3", 300, 400),
           ("flash_fwd_x", 400, 450)]
    host = [("bench.step", 140, 320), ("aten::mm", 160, 200)]
    t = TraceSummary(1e-6, dev, host)
    assert t.busy_s == 300 / 1e9
    assert t.time_of("flash_fwd") == (1, 50 / 1e9)
    gaps = dict(t.idle_gaps())
    assert abs(sum(gaps.values()) - 150 / 1e9) < 1e-15
    ops = dict(t.device_ops())
    assert ops["k1"] == 100 / 1e9


def test_png_round_trip():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    assert np.array_equal(fileio.png_decode(fileio.png_encode(img)), img)
    from lora_tpu_torch.data.png import _png_bytes
    assert np.array_equal(fileio.png_decode(_png_bytes(img)), img)


def test_readers_read_nothing_from_nothing():
    import os
    names = [f[:-3] for f in os.listdir(os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "metrics"))
        if f.endswith(".py")]
    assert len(names) == 9
    for n in names:
        assert read_metric(n, {}) is None
        assert read_metric(n, {"cell_kind": "other"}) is None


def test_roofline_reader_needs_the_counted_launches():
    levels = [(4096, 8, 40), (1024, 8, 80)]
    dev = [("flash_fwd_wgmma_kernel", i * 1000, i * 1000 + 500)
           for i in range(4)]
    ctx = {"cell_kind": "serve_closed", "trace": TraceSummary(1.0, dev, []),
           "flash_fwd_launches": 4, "flash_levels": levels, "unet_batch": 2}
    want = 100 * 2 * sum(flops.flash_fwd_bound_s(2, H, T, T, D)
                         for T, H, D in levels) / (4 * 500e-9)
    assert abs(read_metric("flash_fwd_roofline.serve", ctx) - want) < 1e-6
    ctx["flash_fwd_launches"] = 6  # the trace lacks launches: no reading
    assert read_metric("flash_fwd_roofline.serve", ctx) is None
