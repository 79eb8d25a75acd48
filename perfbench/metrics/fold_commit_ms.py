"""FRI fold+commit a proof (phase `fri/fold+commit`, which ends in the
roots' readback, so it holds the device work)."""


def read(ctx):
    return ctx.phase_ms("fri/fold+commit")
