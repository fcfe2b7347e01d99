"""flash_fwd_roofline.serve: the least time of the traced span's forward
flash launches (their shapes' work at the card's peaks) over the device
time of the kernels named flash_fwd*, in %. Read only where the trace
holds exactly the launches the program counted, whole UNet calls of the
served batch."""

from benchmark import flops


def read(ctx):
    trace, levels = ctx.get("trace"), ctx.get("flash_levels")
    launches = ctx.get("flash_fwd_launches", 0)
    if ctx.get("cell_kind") != "serve_closed" or trace is None \
            or not levels or not launches or launches % len(levels):
        return None
    n, seconds = trace.time_of(r"flash_fwd")
    if n != launches or seconds <= 0:
        return None
    B = ctx["unet_batch"]
    per_call = sum(flops.flash_fwd_bound_s(B, H, T, T, D)
                   for T, H, D in levels)
    return 100.0 * per_call * (launches // len(levels)) / seconds
