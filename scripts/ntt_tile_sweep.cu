// K6's layouts beside the one it takes, for `scripts/ntt_tile_sweep.py`.
//
// Each instance is K6's block routine (`ntt_tile_block` of
// csrc/ntt.cuh) under a __global__ of its own: the pass radix R, the most
// threads a block (`__launch_bounds__`, which caps the registers a thread)
// and whether the products run.  PRODUCTS = false leaves the twiddle loads
// and the Montgomery products out: the same loads, shared-memory round
// trips, additions, subtractions, barriers and stores, but wrong results,
// so only its time is read.  Not part of the port: a measuring tool, built
// by the script that runs it.

#include <cuda_runtime.h>

#include "../stark_mlwe_tpu_torch/csrc/ntt.cuh"

template <int R, int MAXT, bool PRODUCTS>
__global__ void __launch_bounds__(MAXT) ntt_sweep_kernel(const NttTileArgs a) {
  ntt_tile_block<R, PRODUCTS>(a);
}

template <int R, int MAXT, bool PRODUCTS>
static int run(const NttTileArgs &a, int threads, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  if (threads > MAXT) return (int)cudaErrorInvalidValue;
  return ntt_launch(ntt_sweep_kernel<R, MAXT, PRODUCTS>, a, threads, stream,
                    allowed);
}

// The arguments of `fr_ntt_tiles`, then the instance (r, max_threads,
// products) and the threads a block.  Instances: (2, 512, 1) is K6's own
// code and bound, (2, 512, 0) the same without products, (3, 512, 1),
// (3, 256, 1) and (4, 256, 1).
extern "C" int ntt_sweep(const void *in, void *out, const void *wt,
                         const void *ep, long B, int logL, int tpb,
                         long in_es, long out_es, long ep_period, int nlev,
                         const long *cnt, const long *in_bs,
                         const long *out_bs, int r, int max_threads,
                         int products, int threads, void *stream) {
  NttTileArgs a;
  if (!ntt_args(&a, in, out, wt, ep, B, logL, tpb, in_es, out_es, ep_period,
                nlev, cnt, in_bs, out_bs, r))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (r == 2 && max_threads == 512)
    return products ? run<2, 512, true>(a, threads, s)
                    : run<2, 512, false>(a, threads, s);
  if (products && r == 3 && max_threads == 512)
    return run<3, 512, true>(a, threads, s);
  if (products && r == 3 && max_threads == 256)
    return run<3, 256, true>(a, threads, s);
  if (products && r == 4 && max_threads == 256)
    return run<4, 256, true>(a, threads, s);
  return (int)cudaErrorInvalidValue;
}
