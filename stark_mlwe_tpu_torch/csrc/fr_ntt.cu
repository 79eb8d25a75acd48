// K6 fr_ntt_tiles: B independent radix-2 decimation-in-time NTTs of length
// L = 2^logL over Fr (2 <= L <= 4096), each followed by an optional
// elementwise product with an epilogue table.
//
// Replaces the Pallas kernel `_ntt_tiles` (ops/ntt_pallas.py of the JAX
// package, body `_ntt_kernel`).  It keeps WHAT that kernel computes - every
// butterfly stage of a transform in fast memory, one launch, the four-step
// twiddle fused behind the last stage - and none of its shape: the batch-last
// [L, 16, 128] lane tiles, the gather that bit-reverses the input before the
// launch and the two transposes around every level of the four-step recursion
// exist there because that machine needs the batch in its lane dimension.
//
// What bounds it on this card: the Montgomery products.  Each element is
// read once and written once (64 bytes) against (log2 L)/2 + 1 products, so
// the work is integer multiply-adds from L = 4 on; at the 2^22 columns
// (2,048 transforms of 2,048 with the step table) that is 25.2 M products
// against 134 MB of reads and writes.  The design (`ntt.cuh`) spends the
// card's issue on them and little else:
//   - the products are `fr32.cuh`'s carry chains (909 cycles of one warp a
//     product, against 1,392 for compare-based carries on 64-bit limbs);
//   - a thread holds 2^R elements in registers and runs R stages on them
//     between two barriers (radix-2^R passes, R = NTT_R = 2), so a
//     transform of 2,048 takes 6 pass barriers and shared-memory round
//     trips where a barrier a stage would take 11;
//   - shared memory holds eight limb planes under a bank swizzle, so every
//     warp access of the load, the passes and the store meets 32 banks
//     (elements stored whole, 32 bytes apart, would meet 4-way conflicts);
//   - a block of one transform of 2,048 (64 KB) has 256 threads, two
//     groups of four elements a thread each pass, and at most 128 registers
//     a thread (its bound of 512; `ptxas -v` in chip_smoke.py's log), so
//     two blocks share an SM (16 warps): 2,048 transforms are 8 waves of
//     264 blocks.
// Other radices, thread counts and transforms a block, built from the same
// steps, are timed beside this one by scripts/ntt_tile_sweep.py.
// A block reads its transforms' elements where they lie - element stride and
// per-level batch strides are arguments, so a transform may be a column of a
// matrix - and writes with strides of its own.  An element is 32 bytes, one
// DRAM sector, so a strided access wastes no memory traffic.  The stage
// twiddles w_L^j (L/2 elements, at most 64 KB) are read through the
// read-only path and stay in L1/L2.

#include <cuda_runtime.h>

#include "ntt.cuh"

__global__ void __launch_bounds__(NTT_MAX_THREADS)
fr_ntt_tiles_kernel(const NttTileArgs a) {
  ntt_tile_block<NTT_R>(a);
}

// Strides are in elements of 32 bytes.  `cnt`, `in_bs`, `out_bs` are host
// arrays of `nlev` entries, innermost level first.
extern "C" int fr_ntt_tiles(const void *in, void *out, const void *wt,
                            const void *ep, long B, int logL, int tpb,
                            long in_es, long out_es, long ep_period, int nlev,
                            const long *cnt, const long *in_bs,
                            const long *out_bs, void *stream) {
  NttTileArgs a;
  if (!ntt_args(&a, in, out, wt, ep, B, logL, tpb, in_es, out_es, ep_period,
                nlev, cnt, in_bs, out_bs, NTT_R))
    return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  return ntt_launch(fr_ntt_tiles_kernel, a, ntt_threads(logL, tpb),
                    (cudaStream_t)stream, allowed);
}
