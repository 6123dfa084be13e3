// The bf16 one-hop weight matrices of a batch of graphs, built straight
// from their padded link lists, the first step of the COO-fed APSP on the
// bf16 leg of the precision policy:
//
//     W[b] = +inf, 0 on the diagonal, min-scattered with delays[b, l] at
//            (u, v) and (v, u) for every real link l = (u, v).
//
// Replaces, with `csrc/minplus_bf16.cu`, the TPU kernel
// `multihop_offload_tpu/ops/minplus.py:apsp_minplus_coo`
// (`_coo_apsp_kernel`) under bf16: the JAX decision paths scatter W from
// the link list, narrow it to bf16 and square it (`env/policies.py:86-93`,
// `precision.py:wrap_apsp`).  The wrapper (`ops/minplus.py:
// apsp_coo_cuda` on bf16 delays) takes the narrowed delays, this kernel builds W
// in device memory and K2's bf16 kernel squares it uncopied.  Each W entry
// is one delay (or the min of several, and rounding is monotone), so the
// result equals the JAX chain bit for bit.
//
// What bounds the build on an H100: bytes, 11 L + 2 N^2 per graph.
//
// Exactness: the scatter is an exact min by a 16-bit compare-and-swap loop
// on the bf16 bits (compared as floats), and masked links are skipped
// (they carry +inf in the plain version, inert under min), so W equals
// `weight_matrix_from_edges` with the diagonal zeroed bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned short kInfBits = 0x7f80;  // bf16 +inf

__device__ __forceinline__ void atomic_min_bf16(unsigned short* addr, unsigned short v) {
  const float fv = __bfloat162float(__ushort_as_bfloat16(v));
  unsigned short old = *reinterpret_cast<volatile unsigned short*>(addr);
  while (fv < __bfloat162float(__ushort_as_bfloat16(old))) {
    const unsigned short prev = atomicCAS(addr, old, v);
    if (prev == old) break;
    old = prev;
  }
}

// One block per graph: fill W, then min-scatter its real links.
__global__ void __launch_bounds__(kThreads)
coo_weights_bf16_kernel(const int* __restrict__ ends, const unsigned char* __restrict__ mask,
                        const unsigned short* __restrict__ delays,
                        unsigned short* __restrict__ out, int L, int N) {
  const int b = blockIdx.x;
  unsigned short* w = out + static_cast<long long>(b) * N * N;
  for (int e = threadIdx.x; e < N * N; e += kThreads) {
    w[e] = (e / N == e % N) ? 0 : kInfBits;
  }
  __syncthreads();
  const long long base = static_cast<long long>(b) * L;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    if (!mask[base + l]) continue;
    const int u = ends[2 * (base + l)], v = ends[2 * (base + l) + 1];
    const unsigned short d = delays[base + l];
    atomic_min_bf16(&w[u * N + v], d);
    atomic_min_bf16(&w[v * N + u], d);
  }
}

}  // namespace

// W into out (B, N, N) bf16, one block per graph, on `stream`; returns the
// cudaError_t of the launch (0 = success).  ends (B, L, 2) int32, mask
// (B, L) bool, delays (B, L) bf16; all contiguous.
extern "C" int mho_coo_weights_bf16(const void* ends, const void* mask, const void* delays,
                                    void* out, int B, int L, int N, void* stream) {
  coo_weights_bf16_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ends), static_cast<const unsigned char*>(mask),
      static_cast<const unsigned short*>(delays), static_cast<unsigned short*>(out), L, N);
  return static_cast<int>(cudaGetLastError());
}
