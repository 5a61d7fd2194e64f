"""Seconds a batch in the program's ``device_dispatch`` stage
(``pipeline._dispatch_analysis``: the pageable host-to-device copy of the
batch, then the analysis's launches): the stage timer's seconds over its
count in the window."""


def read(ctx):
    st = ctx.get("stages", {}).get("device_dispatch")
    return st["seconds"] / st["count"] if st and st["count"] else None
