"""K4's share of its roofline, in %: the least time the card could take
for the four column chains' rate blocks of a proof, the columns read
once and the four chain states read and written once, times the
traced proofs, over the device time of
`poseidon_absorb_chain_kernel` in the stretch."""

from perfbench import roofline

KERNELS = r"^poseidon_absorb_chain_kernel"


def read(ctx):
    s = ctx.stretch
    if s is None:
        return None
    work = roofline.work(ctx.config, ctx.traffic).get("k4")
    dev = s.kernel_seconds(KERNELS)
    if not work or dev <= 0:
        return None
    nbytes = (4 * (1 << int(ctx.traffic["k"])) + 2 * 4 * 17) \
        * roofline.ELEMENT_BYTES
    return (100.0 * roofline.bound_seconds(work, nbytes)[0] * s.proofs
            / dev)
