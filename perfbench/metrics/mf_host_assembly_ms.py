"""NIZK host assembly a proof: the Fiat-Shamir transcript, spot checks
and openings on the host (phase `mf/host_assembly`)."""


def read(ctx):
    return ctx.phase_ms("mf/host_assembly")
