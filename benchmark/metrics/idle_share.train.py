"""idle_share.train: 1 - the union of the device's kernel and copy
intervals over the traced steps, in %."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("cell_kind") != "train_db" or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
