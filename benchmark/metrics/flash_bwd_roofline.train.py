"""flash_bwd_roofline.train: the least time of the traced steps' backward
attention (dQ and dK/dV launches: their shapes' work at the card's peaks)
over the device time of the kernels named flash_bwd_dq* and
flash_bwd_dkv*, in %."""

from benchmark import flops


def read(ctx):
    trace, levels = ctx.get("trace"), ctx.get("flash_levels")
    c = ctx.get("flash_launches") or {}
    dq, dkv = c.get("dq", 0), c.get("dkv", 0)
    if ctx.get("cell_kind") != "train_db" or trace is None or not levels \
            or not dq or dq != dkv or dq % len(levels):
        return None
    n_dq, t_dq = trace.time_of(r"flash_bwd_dq")
    n_dkv, t_dkv = trace.time_of(r"flash_bwd_dkv")
    if n_dq != dq or n_dkv != dkv or t_dq + t_dkv <= 0:
        return None
    B = ctx["unet_batch"]
    per_call = sum(flops.flash_bwd_bound_s(B, H, T, T, D)
                   for T, H, D in levels)
    return 100.0 * per_call * (dq // len(levels)) / (t_dq + t_dkv)
