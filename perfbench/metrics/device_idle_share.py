"""The device's idle share over the traced stretch of whole proofs:
1 - (union of kernel, copy and memset intervals) / wall time."""


def read(ctx):
    s = ctx.stretch
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 1.0 - s.busy_s / s.window_s
