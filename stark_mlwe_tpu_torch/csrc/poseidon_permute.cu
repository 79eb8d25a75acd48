// K1 poseidon_permute: batched Poseidon permutation, widths t = 17 and t = 9,
// in two layouts chosen by the batch size (`ops/poseidon.py`
// `permute_layout`).
//
// Replaces the Pallas kernel `_permute_tiles` (ops/poseidon_pallas.py of the
// JAX package).  What it keeps of that kernel is WHAT it computes and that a
// state never leaves the chip between rounds; what it drops is everything
// shaped by the other machine (nibble planes for the matrix unit, the
// batch-last tiling).
//
// What bounds it: integer operations, not bytes (a state is read once and
// written once, 64*t bytes, against ~1e5 32-bit multiply-adds), and at the
// prover's batches the latency of one permutation.  Most launches of the
// prover are tree levels of 1 to 4,096 states; the card has 528 SM
// sub-partitions.  So:
//
//   warp    (`poseidon_permute_warp`, small and mid batches) one warp per
//           state, lane i holding element i in registers: the routine of
//           `poseidon_chain.cuh` that K4 runs, every exchange a shuffle.
//           A lane forms one row of each dense product, so a permutation
//           takes a seventh (t = 17) to a quarter (t = 9) of the time one
//           thread needs for the whole state; four warps a block, so up to
//           528 states put one warp on each sub-partition.  Constants: the transposed packs of
//           `DeviceParams.group_consts`.
//   thread  (`poseidon_permute`, large batches) one thread per state
//           (`poseidon.cuh`), the state in thread-local memory.  No lane
//           idles and nothing is exchanged, so once the card is full it
//           permutes several times as many states per second as the warp
//           layout.  A warp per block spreads mid batches over many SMs.
//           Constants: the row-major packs of `DeviceParams.kernel_consts`.
//
// Where one overtakes the other was measured on an H100 (`chip_smoke.py`'s
// sweep; `ops/poseidon.py` `WARP_MAX_B`).  Both are on the 32-bit
// carry-chain arithmetic of `fr32.cuh` and give the same bytes as each
// other, the host engine and the spec.

#include <cuda_runtime.h>

#include "poseidon.cuh"
#include "poseidon_chain.cuh"

#define PW_WARPS 4  // states (warps) per block of the warp layout

template <int T>
__global__ void __launch_bounds__(32)
poseidon_permute_kernel(const u32 *__restrict__ in, u32 *__restrict__ out,
                        long B, PoseidonConsts k) {
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  u32 cur[T * 8], nxt[T * 8];
  const u32 *src = in + b * T * 8;
  for (int i = 0; i < T * 8; ++i) cur[i] = src[i];
  poseidon_permute_one<T>(cur, nxt, k);
  u32 *dst = out + b * T * 8;
  for (int i = 0; i < T * 8; ++i) dst[i] = cur[i];
}

template <int T>
__global__ void __launch_bounds__(32 * PW_WARPS)
poseidon_permute_warp_kernel(const u32 *__restrict__ in,
                             u32 *__restrict__ out, long B, ChainConsts k) {
  const int lane = threadIdx.x & 31;
  const long b = (long)blockIdx.x * PW_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: no shuffle loses a lane
  u32 x[1][8] = {{0, 0, 0, 0, 0, 0, 0, 0}};
  if (lane < T) fr32_load(in + (b * T + lane) * 8, x[0]);
  poseidon_permute_warp<T>(x, PcWarp{lane}, k);
  if (lane < T) {
#pragma unroll
    for (int l = 0; l < 8; ++l) out[(b * T + lane) * 8 + l] = x[0][l];
  }
}

static bool bad_args(long B, long per_block, int rf, int rp) {
  return B <= 0 || (B + per_block - 1) / per_block > 0x7fffffffL || rp < 1 ||
         (rf & 1);
}

// in, out: [B, t, 8]; the constants of `DeviceParams.kernel_consts`.
extern "C" int poseidon_permute(const void *in, void *out, long B, int t,
                                int rf, int rp, const void *mds,
                                const void *rc_full, const void *rc_part,
                                const void *qrow, const void *qcol,
                                const void *mfinal, void *stream) {
  PoseidonConsts k{(const u32 *)mds,  (const u32 *)rc_full,
                   (const u32 *)rc_part, (const u32 *)qrow,
                   (const u32 *)qcol, (const u32 *)mfinal, rf, rp};
  const int threads = 32;
  if (bad_args(B, threads, rf, rp)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (t == 17)
    poseidon_permute_kernel<17><<<blocks, threads, 0, s>>>(
        (const u32 *)in, (u32 *)out, B, k);
  else if (t == 9)
    poseidon_permute_kernel<9><<<blocks, threads, 0, s>>>(
        (const u32 *)in, (u32 *)out, B, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// in, out: [B, t, 8]; the constants of `DeviceParams.group_consts` (dense
// matrices transposed).
extern "C" int poseidon_permute_warp(const void *in, void *out, long B, int t,
                                     int rf, int rp, const void *mdsT,
                                     const void *rc_full, const void *rc_part,
                                     const void *qrow, const void *qcol,
                                     const void *mfinalT, void *stream) {
  ChainConsts k{(const u32 *)mdsT, (const u32 *)rc_full,
                (const u32 *)rc_part, (const u32 *)qrow,
                (const u32 *)qcol, (const u32 *)mfinalT, rf, rp};
  if (bad_args(B, PW_WARPS, rf, rp)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + PW_WARPS - 1) / PW_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (t == 17)
    poseidon_permute_warp_kernel<17><<<blocks, 32 * PW_WARPS, 0, s>>>(
        (const u32 *)in, (u32 *)out, B, k);
  else if (t == 9)
    poseidon_permute_warp_kernel<9><<<blocks, 32 * PW_WARPS, 0, s>>>(
        (const u32 *)in, (u32 *)out, B, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
