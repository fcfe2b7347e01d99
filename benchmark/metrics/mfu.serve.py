"""mfu.serve: the served images' model FLOPs (benchmark/flops.py
image_flops, from the plain reference at the cell's shapes) at the
window's rate, over the card's bf16 peak, in %. The rate leaves out the
traced part of the window, in which the profiler holds the server up."""

from benchmark import flops


def read(ctx):
    rate = ctx.get("images_per_s")
    if ctx.get("cell_kind") != "serve_closed" or not rate or rate != rate:
        return None
    return 100.0 * rate * ctx["image_flops"] / flops.PEAK_BF16_FLOPS
