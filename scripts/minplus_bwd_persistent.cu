// K2's backward as one persistent cooperative launch: the form measured
// against the package's chain of 1 + iters launches (programmatic dependent
// launch) and not kept.  Built only by `scripts/bench_minplus_bwd.py
// --variant TAG=scripts/minplus_bwd_persistent.cu[:NAME=VALUE,...]`, which
// inlines the package's source below, so both forms share every pass: the
// blocks stride over the first launch's tie items, meet at a grid barrier,
// then over each squaring's gather items (and the next squaring's tie
// items), a barrier after each squaring, on the package's plan for (B,
// N).  Grid: as many blocks as fit on the card at once (the occupancy the
// runtime reports).

#include <cooperative_groups.h>

#include "../multihop_offload_tpu_torch/csrc/minplus_bwd.cu"

namespace {

namespace cg = cooperative_groups;

template <int CW, class P>
__global__ void __launch_bounds__(P::T, P::kMinBlocks)
bwd_persistent_kernel(const Args a, const float* __restrict__ g, float* __restrict__ out,
                      float* __restrict__ tmp) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tiles = a.geo.tiles_x * a.geo.tiles_x, B = a.geo.B, iters = a.geo.iters;
  for (int item = blockIdx.x; item < tiles * B; item += gridDim.x) {
    first_ties_item<CW, P>(a, item / tiles, item % tiles, smem);
    __syncthreads();
  }
  grid.sync();
  for (int s = iters - 1; s >= 0; --s) {
    const float* gin = s == iters - 1 ? g : (s % 2 ? out : tmp);
    float* gout = s % 2 ? tmp : out;
    const int ties = s > 0 ? tiles * B : 0;
    for (int item = blockIdx.x; item < ties + tiles * B; item += gridDim.x) {
      if (item < ties)
        next_ties_item<CW, P>(a, s, item / tiles, item % tiles, smem);
      else
        gather_item<CW, P>(a, s, (item - ties) / tiles, (item - ties) % tiles, gin, gout, smem,
                        false);
      __syncthreads();
    }
    grid.sync();
  }
}

template <int CW, class P>
int run_persistent(const Args& a, const float* g, float* out, float* tmp, cudaStream_t st) {
  const Geo& geo = a.geo;
  const int tiles = geo.tiles_x * geo.tiles_x;
  const int tie_words = tie_smem_words<P>(geo), gather_words = gather_smem_words<P>(geo);
  const int bytes = 4 * (tie_words > gather_words ? tie_words : gather_words);
  auto* kernel = bwd_persistent_kernel<CW, P>;
  cudaError_t err = allow_smem<bwd_persistent_kernel<CW, P>>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P::T, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = 2 * tiles * geo.B;
  const int blocks = per_sm * sms < items ? per_sm * sms : items;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {const_cast<Args*>(&a), &g, &out, &tmp};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(blocks), dim3(P::T),
                                                      params, bytes, st));
}

}  // namespace

// `mho_minplus_closure_bwd_f32`'s interface and checks, in one launch
extern "C" int mho_minplus_closure_bwd_persistent_f32(const void* stack, long long slice,
                                                      const void* lead, int iters, const void* g,
                                                      void* out, void* tmp, void* tie_m,
                                                      void* tie_f, int B, int N, void* stream) {
  if (iters <= 0 || B <= 0 || N <= 0) return 0;
  const Geo geo = geometry(B, N, iters);
  const Args a{static_cast<const float*>(stack), slice, static_cast<const int*>(lead),
               static_cast<float*>(tie_m), static_cast<float*>(tie_f), geo};
  const uintptr_t at = reinterpret_cast<uintptr_t>(stack) | reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(tmp) |
                       reinterpret_cast<uintptr_t>(tie_m) | reinterpret_cast<uintptr_t>(tie_f) |
                       static_cast<uintptr_t>(slice * 4);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  float* tp = static_cast<float*>(tmp);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = wide_plan(geo);
  if (N % 4 == 0 && at % 16 == 0)
    return wide ? run_persistent<4, Wide>(a, gp, op, tp, st)
                : run_persistent<4, Full>(a, gp, op, tp, st);
  return wide ? run_persistent<1, Wide>(a, gp, op, tp, st)
              : run_persistent<1, Full>(a, gp, op, tp, st);
}
