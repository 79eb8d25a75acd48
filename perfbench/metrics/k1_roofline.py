"""K1's share of its roofline, in %: the least time the card could take
for the t = 9 and t = 17 permutations a proof gives K1 (counted from the
configuration by `perfbench.roofline`), times the traced proofs, over
the device time of every K1 kernel (`poseidon_permute_kernel<t>`,
`poseidon_permute_warp_kernel<t>`) in the stretch."""

from perfbench import roofline

KERNELS = r"^poseidon_permute(_warp)?_kernel<"


def read(ctx):
    s = ctx.stretch
    if s is None:
        return None
    work = roofline.work(ctx.config, ctx.traffic).get("k1")
    dev = s.kernel_seconds(KERNELS)
    if not work or dev <= 0:
        return None
    return 100.0 * roofline.bound_seconds(work)[0] * s.proofs / dev
