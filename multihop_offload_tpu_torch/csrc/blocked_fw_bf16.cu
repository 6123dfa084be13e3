// K3 in bf16: exact all-pairs shortest paths of a batch of (N, N) bf16
// distance matrices by blocked Floyd-Warshall on 128 x 128 pivot blocks, in
// place, every candidate sum rounded to bf16 where the plain version
// `ops/minplus.py:blocked_fw_plain` rounds it on bf16 input: the shared body
// `blocked_fw.cuh` on bf16 elements, with packed bf16x2 adds and mins
// (`minplus_elem.cuh`), bit-identical to the plain version in bf16.
// Replaces `multihop_offload_tpu/ops/minplus.py:blocked_fw_call` on the bf16
// leg of the precision policy: a decision path under bf16 whose padded N is
// in (256, 2048] narrows W to bf16 before the blocked FW
// (`precision.py:wrap_apsp`), and the TPU kernel then runs on bf16 tiles.
// The schedule, the launches (3 N / 128 a call, no host sync), the thread
// blocks and the in-place argument are the float32 kernel's.

#include "blocked_fw.cuh"

// Runs the whole sweep on `stream` (the float32 launcher's order).  d (B, N,
// N) bf16 contiguous and 16-byte aligned, N a multiple of 128, updated in
// place.  Returns the first cudaError_t (0 = success).
extern "C" int mho_blocked_fw_bf16(void* d, int B, int N, void* stream) {
  return blocked_fw<bf16>(d, B, N, stream);
}
