"""Percent: the least time of the batches' analysis (``work.
device_pass_least_s``: the valid samples read once with the outputs, or the
statistics' float64 operations at the fp64 tensor cores' peak and the
float32 ones at the CUDA cores', whichever takes longer) over the device
time of every kernel in the traced window, copies left out."""


def read(ctx):
    tr, least = ctx.get("trace"), ctx.get("least_s")
    if tr is None or "batches" not in ctx or not least or tr.kernel_s <= 0:
        return None
    return 100.0 * least / tr.kernel_s
