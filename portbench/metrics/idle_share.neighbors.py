"""Percent of the neighbours cell's traced window in which no kernel and no
copy ran on the card."""


def read(ctx):
    tr = ctx.get("trace")
    return tr.idle_share() if tr is not None and "calls" in ctx else None
