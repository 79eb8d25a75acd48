"""FRI queries a proof (phase `fri/queries`: index derivation, one
gather and its readback, the openings)."""


def read(ctx):
    return ctx.phase_ms("fri/queries")
