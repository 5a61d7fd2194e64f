"""Percent: the least time of the window's k-NN calls (``work.knn_least_s``:
2 N^2 D float64 operations at the fp64 tensor cores' peak, or the rows read
and the answers written at the memory's rate, whichever is longer) over the
device's busy time in the traced window."""


def read(ctx):
    tr, least = ctx.get("trace"), ctx.get("least_s")
    if tr is None or "calls" not in ctx or not least or tr.busy_s <= 0:
        return None
    return 100.0 * least / tr.busy_s
