"""mfu.serve_open: the model FLOPs of the requests completed in the open
loop's window over the window's seconds and the card's bf16 peak, in %,
both leaving out the traced part of the window."""

from benchmark import flops


def read(ctx):
    rate = ctx.get("images_per_s")
    if ctx.get("cell_kind") != "serve_open" or not rate:
        return None
    return 100.0 * rate * ctx["image_flops"] / flops.PEAK_BF16_FLOPS
