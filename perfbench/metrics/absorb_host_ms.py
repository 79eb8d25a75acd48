"""FS absorb, host: the host engine's four column chains a proof
(phase `ali/host_absorb`, which ends in the native call's return)."""


def read(ctx):
    return ctx.phase_ms("ali/host_absorb")
