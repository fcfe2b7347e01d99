"""batch_rows.serve_open: mean rows per device group over the requests
completed in the window, from each response's batched_with (one row a
request): requests / sum(1 / batched_with)."""


def read(ctx):
    b = [x for x in ctx.get("batched_with", ()) if x]
    if ctx.get("cell_kind") != "serve_open" or not b:
        return None
    return len(b) / sum(1.0 / x for x in b)
