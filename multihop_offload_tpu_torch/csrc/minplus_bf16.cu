// K2 in bf16: one min-plus squaring of a batch of (N, N) bf16 distance
// matrices, every candidate sum rounded to bf16 as a bf16 squaring rounds
// it: the shared body `minplus.cuh` on bf16 elements, with packed bf16x2
// adds and mins (`minplus_elem.cuh`), bit-identical to the plain closure in
// bf16.  Replaces `multihop_offload_tpu/ops/minplus.py:
// minplus_power_kernel_call` on the bf16 leg of the precision policy
// (`precision.py:wrap_apsp` narrows W; the Pallas kernel keeps the input's
// dtype, `:96`); the wrapper (`ops/minplus.py:minplus_closure_cuda` on
// bf16) launches it once per squaring, with the float32 kernel's plans,
// copies and early stop.

#include "minplus.cuh"

// Launches squaring `step` on `stream`; returns the cudaError_t of the
// shared-memory attribute call or of the launch (0 = success).  src/dst
// (B, N, N) bf16 contiguous, distinct; flags (steps, B) int32 zeroed before
// step 0; executed: one uint64.
extern "C" int mho_minplus_square_bf16(const void* src, void* dst, void* flags,
                                       void* executed, int B, int N, int step,
                                       void* stream) {
  return square<bf16>(src, dst, flags, executed, B, N, step, stream);
}

// The bf16 tile plan the launcher picks for (B, N): info[0..9] as
// `minplus.cuh:plan` lists them.
extern "C" int mho_minplus_plan(int B, int N, int* info) {
  return plan<bf16>(B, N, info);
}
