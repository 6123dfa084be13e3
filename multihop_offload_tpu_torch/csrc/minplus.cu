// K2 in float32: one min-plus squaring of a batch of (N, N) float32
// distance matrices, the shared body `minplus.cuh` on float elements (its
// note says what the kernel replaces, what bounds it and how its tiles
// follow N).  `csrc/minplus_bf16.cu` instantiates the same body on bf16.

#include "minplus.cuh"

// Launches squaring `step` on `stream`; returns the cudaError_t of the
// shared-memory attribute call or of the launch (0 = success).  src/dst
// (B, N, N) float32 contiguous, distinct; flags (steps, B) int32 zeroed
// before step 0; executed: one uint64.
extern "C" int mho_minplus_square_f32(const void* src, void* dst, void* flags,
                                      void* executed, int B, int N, int step,
                                      void* stream) {
  return square<float>(src, dst, flags, executed, B, N, step, stream);
}

// The float32 tile plan the launcher picks for (B, N), for logs and benches:
// info[0..9] as `minplus.cuh:plan` lists them.
extern "C" int mho_minplus_plan(int B, int N, int* info) {
  return plan<float>(B, N, info);
}
