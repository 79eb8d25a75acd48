"""NIZK chain a proof: from the chain's first enqueue to the readback
that waits for it (phase `mf/chain_device`, which ends at enqueue, plus
`mf/gather_ctx` or `mf/download`, whichever the size takes, which end
in a readback)."""


def read(ctx):
    if "mf/chain_device" not in ctx.phases:
        return None
    return ctx.phase_ms("mf/chain_device", "mf/gather_ctx", "mf/download")
