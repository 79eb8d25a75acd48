"""NIZK entry: the witness ints packed into a device MLE, a proof
(phase `mf/pack`)."""


def read(ctx):
    return ctx.phase_ms("mf/pack")
