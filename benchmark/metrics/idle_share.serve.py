"""idle_share.serve: 1 - the union of the device's kernel and copy
intervals over the traced span of whole served groups, in %."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("cell_kind") != "serve_closed" or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
