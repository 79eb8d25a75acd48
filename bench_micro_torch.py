#!/usr/bin/env python3
"""Component micro-benchmarks of the PyTorch/CUDA port (the reference's
poseidon.rs, merkle.rs and protocol.rs bench surfaces, and the NTT/LDE).

    python3 bench_micro_torch.py

Prints the card line (`nvidia-smi --query-gpu=name,power.limit`) first,
then one JSON line per metric, each also written to `microbench_torch.json`
(MICRO_OUT, empty for none):
  poseidon_t17_perms_per_s        batched t=17 permutations, B = 2^16
  poseidon_t17_field_muls_per_s   the same in the algorithmic count of
                                  `utils.roofline.poseidon_field_muls`
  poseidon_t17_mac64_per_s        the same in the kernel's 64-bit
                                  multiply-adds (`roofline.permute_macs`)
  poseidon_t17_ops_fraction       those multiply-adds' share of the
                                  card's operation rate (`roofline`)
  merkle_build_2e16_s             arity-16 DS tree of 2^16 leaves
  merkle_open_verify_q64_ms       q=64 union-of-paths open + verify
  ntt_2e{20,22}_{elems_per_s,s,field_muls_per_s,mac64_per_s,ops_fraction}
  lde_2e20_blowup4_{s,out_elems_per_s}
  mle_commit_k{12,14,16}_s        MLE commit (arity-16 tree)
  mle_open_verify_k*_q{64,128}_ms MLE open + verify
Each is the median of REPS = 5 warm runs, its samples beside it; device
times by CUDA events, host paths (open, verify, commit with its root
readback) by the host clock ending in a synchronise.

Env: MICRO_SIZE=small cuts every size by 2^4 (a quick check): a metric
whose name gives a size then names the size that ran, and nothing is
written unless MICRO_OUT names a file.  Without a CUDA device it raises.
"""

import json
import os
import statistics
import sys
import time

REPS = 5


def main():
    import numpy as np
    import torch

    from stark_mlwe_tpu_torch import merkle as dmk
    from stark_mlwe_tpu_torch.channel import DeviceMerkleCommitment
    from stark_mlwe_tpu_torch.device import resolve
    from stark_mlwe_tpu_torch.ops import fr, ntt
    from stark_mlwe_tpu_torch.ops import poseidon as dpos
    from stark_mlwe_tpu_torch.spec.merkle import MerkleChannelCfg
    from stark_mlwe_tpu_torch.spec.poseidon import params_for_width
    from stark_mlwe_tpu_torch.utils import roofline
    from stark_mlwe_tpu_torch.utils.profiling import card_line

    dev = resolve(None)
    print(card_line(), flush=True)
    cut = {"full": 0, "small": 4}[os.environ.get("MICRO_SIZE", "full")]
    # a quick check's numbers never land in the full-size file
    out_path = os.environ.get("MICRO_OUT",
                              "" if cut else "microbench_torch.json")
    rng = np.random.default_rng(0)
    lines = []

    def out(metric, value, unit, samples=None):
        rec = {"metric": metric, "value": value, "unit": unit,
               "vs_baseline": None}
        if samples is not None:
            rec["samples"] = samples
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
        if out_path:  # incremental: partial runs persist
            with open(out_path, "w") as f:
                f.write("\n".join(lines) + "\n")

    seeds = iter(range(1, 1 << 20))

    def rand_mont(n):
        """n field elements below P, read as Montgomery form."""
        return fr.to_device(fr.seeded_limbs(next(seeds), n), dev)

    def device_s(fn):
        """Seconds of one call on the card (CUDA events), after a warm-up:
        median and samples."""
        fn()
        torch.cuda.synchronize(dev)
        samples = []
        for _ in range(REPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize(dev)
            samples.append(e0.elapsed_time(e1) / 1e3)
        return statistics.median(samples), samples

    def host_s(fn):
        """Host-clock seconds of one call ending in a synchronise, after a
        warm-up: median and samples."""
        fn()
        torch.cuda.synchronize(dev)
        samples = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            samples.append(time.perf_counter() - t0)
        return statistics.median(samples), samples

    # --- poseidon permutation throughput -------------------------------
    params = params_for_width(17)
    dp = dpos.device_params(params)
    B = 1 << (16 - cut)
    states = rand_mont(B * 17).reshape(B, 17, fr.N)
    dt, samples = device_s(lambda: dpos.permute(states, dp))
    out("poseidon_t17_perms_per_s", B / dt, "perms/s",
        [B / s for s in samples])
    rates = roofline.poseidon_rates(params, B / dt)
    out("poseidon_t17_field_muls_per_s", rates["field_muls_per_s"],
        "muls/s")
    out("poseidon_t17_mac64_per_s", rates["mac64_per_s"], "mac64/s")
    out("poseidon_t17_ops_fraction", rates["ops_fraction"], "of peak")

    # --- merkle build + open/verify -------------------------------------
    n = 1 << (16 - cut)
    leaves = rand_mont(n)
    cfg = MerkleChannelCfg.new(16, tree_label=0)
    dt, samples = host_s(lambda: dmk.build_tree(leaves, cfg).root())
    out(f"merkle_build_2e{16 - cut}_s", dt, "s", samples)
    tree = dmk.build_tree(leaves, cfg)
    root = tree.root()
    q = 64
    idx = sorted(int(i) for i in rng.choice(n, size=q, replace=False))
    vals = tree.node_ints(0, idx)

    def open_verify():
        proof = tree.open_many(idx)
        if not dmk.verify_many_ds(root, idx, vals, proof, 0, cfg.params,
                                  dev):
            raise AssertionError("merkle open/verify refused")

    dt, samples = host_s(open_verify)
    out("merkle_open_verify_q64_ms", dt * 1e3, "ms",
        [s * 1e3 for s in samples])

    # --- NTT throughput ---------------------------------------------------
    for logm in (20 - cut, 22 - cut):
        m = 1 << logm
        x = rand_mont(m)
        dt, samples = device_s(lambda: ntt.ntt(x))
        out(f"ntt_2e{logm}_elems_per_s", m / dt, "elems/s",
            [m / s for s in samples])
        out(f"ntt_2e{logm}_s", dt, "s", samples)
        r = roofline.ntt_rates(m, dt)
        out(f"ntt_2e{logm}_field_muls_per_s", r["field_muls_per_s"],
            "muls/s")
        out(f"ntt_2e{logm}_mac64_per_s", r["mac64_per_s"], "mac64/s")
        out(f"ntt_2e{logm}_ops_fraction", r["ops_fraction"], "of peak")
        del x

    # --- LDE blowup 4 on 2^20 (output 2^22) ---------------------------------
    m = 1 << (20 - cut)
    x = rand_mont(m)
    dt, samples = device_s(lambda: ntt.lde(x, 4))
    out(f"lde_2e{20 - cut}_blowup4_s", dt, "s", samples)
    out(f"lde_2e{20 - cut}_blowup4_out_elems_per_s", 4 * m / dt, "elems/s")
    del x

    # --- MLE commit + open (protocol.rs:39-64) -----------------------------
    for kk in (12 - cut, 14 - cut, 16 - cut):
        nv = 1 << kk
        vals_dev = rand_mont(nv)
        scheme = DeviceMerkleCommitment(tree_label=0x11E, device=dev)
        dt, samples = host_s(lambda: scheme.commit(vals_dev))
        out(f"mle_commit_k{kk}_s", dt, "s", samples)
        root, tree = scheme.commit(vals_dev)
        for q in (64, 128):
            idx = sorted(int(i) for i in
                         rng.choice(nv, size=q, replace=False))
            vals_ints = tree.node_ints(0, idx)

            def mle_open_verify():
                proof = scheme.open(idx, tree)
                if not scheme.verify(root, idx, vals_ints, proof):
                    raise AssertionError("MLE open/verify refused")

            dt, samples = host_s(mle_open_verify)
            out(f"mle_open_verify_k{kk}_q{q}_ms", dt * 1e3, "ms",
                [s * 1e3 for s in samples])


if __name__ == "__main__":
    sys.exit(main())
