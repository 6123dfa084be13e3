// K3 in float32: exact all-pairs shortest paths of a batch of (N, N)
// float32 distance matrices by blocked Floyd-Warshall on 128 x 128 pivot
// blocks, in place: the shared body `blocked_fw.cuh` on float elements (its
// note says what the kernel replaces, what bounds it and how its three
// phases are laid out).  `csrc/blocked_fw_bf16.cu` instantiates the same
// body on bf16.

#include "blocked_fw.cuh"

// Runs the whole sweep on `stream`: for each of the N / 128 pivot blocks,
// the pivot, panels and outer launches (only the pivot when N = 128).  d
// (B, N, N) float32 contiguous, N a multiple of 128, updated in place.
// Returns the first cudaError_t (0 = success).
extern "C" int mho_blocked_fw_f32(void* d, int B, int N, void* stream) {
  return blocked_fw<float>(d, B, N, stream);
}
