"""mfu.train: one step's FLOPs (benchmark/flops.py train_step_flops: the
forward and the backward the LoRA gradients need, nothing recomputed) at
the window's steps per second, over the card's bf16 peak, in %. The
steps and seconds of the traced part are left out."""

from benchmark import flops


def read(ctx):
    if ctx.get("cell_kind") != "train_db" or not ctx.get("steps_per_s"):
        return None
    return 100.0 * ctx["steps_per_s"] * ctx["step_flops"] / \
        flops.PEAK_BF16_FLOPS
