"""data_wait_ms.train: the host milliseconds a window step waits in
next(loader) (the trainer's prefetching loaders), the mean over the
window's steps; the benchmark's own span around the call."""


def read(ctx):
    w = ctx.get("data_wait_s")
    if ctx.get("cell_kind") != "train_db" or not w:
        return None
    return 1e3 * sum(w) / len(w)
