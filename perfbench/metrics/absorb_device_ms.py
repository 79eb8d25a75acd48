"""FS absorb, device: the chain kernel's column hashes a proof (phase
`ali/column_hashes`, which ends in the digests' readback)."""


def read(ctx):
    return ctx.phase_ms("ali/column_hashes")
