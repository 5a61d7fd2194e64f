"""Kernels a batch: the kernels in the traced window over the batches the
scan dispatched in it (every one of them finishes inside the window)."""


def read(ctx):
    tr, batches = ctx.get("trace"), ctx.get("batches")
    if tr is None or not batches or not tr.kernels:
        return None
    return len(tr.kernels) / batches
