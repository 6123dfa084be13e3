// K2's backward: the vector-Jacobian product of one min-plus squaring of a
// batch of (N, N) float32 distance matrices,
//
//     O = min(D, M),   M[i, j] = min_k D[i, k] + D[k, j],
//
// taken as reverse-mode autodiff takes it through `env/apsp.py:24-26`
// (`jnp.minimum(d, jnp.min(d[:, :, None] + d[None, :, :], axis=1))`):
// `lax.minimum` gives half of the cotangent to each side of a tie, and the
// min reduction splits its share evenly among every k that attains it.
// PyTorch's `minimum` and `amin` split the same way, so the plain version
// is autograd through `ops/minplus.py:minplus_square_plain`.
//
// Replaces no TPU kernel: the JAX package differentiates the XLA squarings
// (`env/apsp.py:apsp_minplus(early_stop=False)`, on the tape of
// `rl/rollout.py:150-155`); there the forward is K2 (`csrc/minplus.cu`).
//
// For cotangent G of O, with D the squaring's input, two launches:
//
//   1. `bwd_split_kernel`: recompute M and cnt[i, j], the number of k
//      with D[i, k] + D[k, j] == M[i, j], in one pass over k (a running
//      min and the count of its ties); split G between the two sides of
//      the minimum (1, 1/2 or 0 each), write G's direct share to the
//      output and w = G_M / cnt, with M, to scratch.
//   2. `bwd_gather_kernel`: each output element gathers, with no atomics,
//
//          G_D[p, q] += sum_j [D[p, q] + D[q, j] == M[p, j]] w[p, j]
//                     + sum_i [D[i, p] + D[p, q] == M[i, q]] w[i, q]
//
//      (D[p, q] as the first and as the second operand of a candidate), so
//      the result is the same bits on every call.
//
// Exactness: every candidate is one correctly rounded add (`__fadd_rn`, no
// contraction), as in K2 and the plain version, so M and the tie sets are
// the plain version's exactly; the result differs from it only by the
// order of the float sums.  Unreachable pairs (M = +inf) tie at every k:
// cnt = N, and a zero cotangent there gives 0, never NaN (a matching
// candidate adds w; nothing is multiplied by +inf).
//
// Early stop: the forward (`ops/minplus.py:_minplus_closure_saved`) keeps
// the input of every squaring in a stack of slices, squaring s reading
// slice s and writing slice s + 1; K2's early stop skips squaring s of
// matrix b when squaring s - 1 changed nothing there, and then writes no
// slice.  `lead[b]` is the number of leading squarings that changed b, so
// slice min(s, lead[b]) holds squaring s's input for every s: the fixed
// point where the squaring was skipped.  Every squaring of the schedule
// takes its VJP, since the VJP at the fixed point is not the identity
// (ties split the cotangent).
//
// What bounds it: operations, like K2.  Pass 1 is a squaring's 2 N^3
// (add, min) plus the tie count; pass 2 two N^3 (add, compare, add) sums.
// This first version keeps the tiles plain: 32 x 32 outputs a block of 256
// threads, 4 rows a thread, the k (or j, i) range in chunks of 32 staged
// through shared memory with a padded pitch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kT = 32;            // output tile kT x kT
constexpr int kRows = 8;          // thread rows; a thread takes kT / kRows rows
constexpr int kR = kT / kRows;
constexpr int kC = 32;            // chunk of the contraction staged a step
constexpr int kPitch = kC + 1;    // shared pitch: a warp's column reads miss no bank
static_assert(kT == kC && kT % kRows == 0, "square staged tiles");

// matrix b's input to squaring s: slice min(s, lead[b]) of the stack
__device__ __forceinline__ const float* input_of(const float* stack, long long slice,
                                                 const int* lead, int s, int b, int N) {
  const int t = min(s, lead[b]);
  return stack + t * slice + static_cast<long long>(b) * N * N;
}

__device__ __forceinline__ float at(const float* m, int r, int c, int N) {
  return (r < N && c < N) ? m[r * N + c] : CUDART_INF_F;
}

// pass 1: M, w = G_M / cnt, and G's direct share into gd
__global__ void __launch_bounds__(kT * kRows)
bwd_split_kernel(const float* __restrict__ stack, long long slice, const int* __restrict__ lead,
                 int s, const float* __restrict__ g, float* __restrict__ gd,
                 float* __restrict__ m_out, float* __restrict__ w_out, int N) {
  __shared__ float As[kT][kPitch];   // As[i][k] = D[i0 + i][k0 + k]
  __shared__ float Bs[kC][kT + 1];   // Bs[k][j] = D[k0 + k][j0 + j]
  const int b = blockIdx.z;
  const float* D = input_of(stack, slice, lead, s, b, N);
  const long long off = static_cast<long long>(b) * N * N;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kT + tx;
  const int i0 = blockIdx.y * kT, j0 = blockIdx.x * kT;
  float m[kR];
  int cnt[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = CUDART_INF_F;
    cnt[r] = 0;
  }
  for (int k0 = 0; k0 < N; k0 += kC) {
    for (int e = tid; e < kT * kC; e += kT * kRows) {
      const int r = e / kC, c = e % kC;
      As[r][c] = at(D, i0 + r, k0 + c, N);
      Bs[r][c] = at(D, k0 + r, j0 + c, N);
    }
    __syncthreads();
    const int kn = min(kC, N - k0);
    for (int k = 0; k < kn; ++k) {
      const float bk = Bs[k][tx];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float v = __fadd_rn(As[ty + kRows * r][k], bk);
        cnt[r] = v < m[r] ? 1 : cnt[r] + (v == m[r]);
        m[r] = fminf(m[r], v);
      }
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j >= N) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + ty + kRows * r;
    if (i >= N) continue;
    const long long e = off + i * N + j;
    const float d = D[i * N + j], gg = g[e], mm = m[r];
    const float half = 0.5f * gg;
    const float direct = d < mm ? gg : (d == mm ? half : 0.0f);
    const float via_m = mm < d ? gg : (d == mm ? half : 0.0f);
    gd[e] = direct;
    m_out[e] = mm;
    w_out[e] = via_m / static_cast<float>(cnt[r]);
  }
}

// pass 2: each output element gathers the candidates it is an operand of
__global__ void __launch_bounds__(kT * kRows)
bwd_gather_kernel(const float* __restrict__ stack, long long slice, const int* __restrict__ lead,
                  int s, const float* __restrict__ m_in, const float* __restrict__ w_in,
                  float* __restrict__ gd, int N) {
  __shared__ float Xs[kT][kPitch];   // sum over j: D[q0 + q][j]; over i: D[i][p0 + p]
  __shared__ float Ms[kT][kPitch];   // M[p0 + p][j];              M[i][q0 + q]
  __shared__ float Ws[kT][kPitch];   // w[p0 + p][j];              w[i][q0 + q]
  const int b = blockIdx.z;
  const float* D = input_of(stack, slice, lead, s, b, N);
  const long long off = static_cast<long long>(b) * N * N;
  const float* M = m_in + off;
  const float* W = w_in + off;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kT + tx;
  const int p0 = blockIdx.y * kT, q0 = blockIdx.x * kT;
  const int q = q0 + tx;
  float dpq[kR], acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    dpq[r] = at(D, p0 + ty + kRows * r, q, N);
    acc[r] = 0.0f;
  }
  // D[p, q] as the first operand: candidates (p, q, j) of M[p, j]
  for (int c0 = 0; c0 < N; c0 += kC) {
    for (int e = tid; e < kT * kC; e += kT * kRows) {
      const int r = e / kC, c = e % kC;
      Xs[r][c] = at(D, q0 + r, c0 + c, N);
      Ms[r][c] = at(M, p0 + r, c0 + c, N);
      Ws[r][c] = (p0 + r < N && c0 + c < N) ? W[(p0 + r) * N + c0 + c] : 0.0f;
    }
    __syncthreads();
    const int cn = min(kC, N - c0);
    for (int c = 0; c < cn; ++c) {
      const float dq = Xs[tx][c];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int pr = ty + kRows * r;
        if (__fadd_rn(dpq[r], dq) == Ms[pr][c]) acc[r] += Ws[pr][c];
      }
    }
    __syncthreads();
  }
  // D[p, q] as the second operand: candidates (i, p, q) of M[i, q]
  for (int c0 = 0; c0 < N; c0 += kC) {
    for (int e = tid; e < kT * kC; e += kT * kRows) {
      const int r = e / kT, c = e % kT;  // r along i, c along p or q
      Xs[r][c] = at(D, c0 + r, p0 + c, N);
      Ms[r][c] = at(M, c0 + r, q0 + c, N);
      Ws[r][c] = (c0 + r < N && q0 + c < N) ? W[(c0 + r) * N + q0 + c] : 0.0f;
    }
    __syncthreads();
    const int cn = min(kC, N - c0);
    for (int c = 0; c < cn; ++c) {
      const float mq = Ms[c][tx], wq = Ws[c][tx];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (__fadd_rn(Xs[c][ty + kRows * r], dpq[r]) == mq) acc[r] += wq;
      }
    }
    __syncthreads();
  }
  if (q >= N) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int p = p0 + ty + kRows * r;
    if (p < N) gd[off + p * N + q] += acc[r];
  }
}

}  // namespace

// The VJP of squaring `s` of (B, N, N) float32 matrices, both passes on
// `stream`; returns the cudaError_t of the first failed launch (0 =
// success).  stack: the forward's slices, `slice` elements apart (slice t
// = the input of squaring t where it ran); lead (B,) int32; g (B, N, N)
// the cotangent of the squaring's output; gd (B, N, N) receives the
// cotangent of its input; m, w (B, N, N) scratch.  All contiguous, g and
// gd distinct.
extern "C" int mho_minplus_square_bwd_f32(const void* stack, long long slice, const void* lead,
                                          int s, const void* g, void* gd, void* m, void* w,
                                          int B, int N, void* stream) {
  const dim3 grid((N + kT - 1) / kT, (N + kT - 1) / kT, B), block(kT, kRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(stack);
  const int* ld = static_cast<const int*>(lead);
  bwd_split_kernel<<<grid, block, 0, st>>>(sk, slice, ld, s, static_cast<const float*>(g),
                                           static_cast<float*>(gd), static_cast<float*>(m),
                                           static_cast<float*>(w), N);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  bwd_gather_kernel<<<grid, block, 0, st>>>(sk, slice, ld, s, static_cast<const float*>(m),
                                            static_cast<const float*>(w),
                                            static_cast<float*>(gd), N);
  return static_cast<int>(cudaGetLastError());
}
