"""Percent of the scan's traced window in which no kernel and no copy ran
on the card."""


def read(ctx):
    tr = ctx.get("trace")
    return tr.idle_share() if tr is not None and "batches" in ctx else None
