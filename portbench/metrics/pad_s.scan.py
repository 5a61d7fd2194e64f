"""Seconds a batch in the program's ``pad`` stage (``pipeline._scan``'s
``np.zeros`` of the [B, L] batch and its row copies): the stage timer's
seconds over its count in the window."""


def read(ctx):
    st = ctx.get("stages", {}).get("pad")
    return st["seconds"] / st["count"] if st and st["count"] else None
