// The element types of the min-plus kernels, K2 (`minplus.cuh`) and K3
// (`blocked_fw.cuh`): float32, and bf16 on packed bf16x2 arithmetic.  Each
// kernel has one body, templated on the element type E, and reaches its
// elements only through a run: 4 consecutive elements of a row (4 floats,
// 16 bytes; or 2 bf16 pairs, 8 bytes), and through the few operations
// below.
//
// A candidate in bf16 is one `__hadd2` (the correctly rounded bf16 sum,
// round to nearest even: the sum a bf16 min-plus squaring rounds each
// candidate to, JAX `multihop_offload_tpu/ops/minplus.py:76, 143, 152`) and
// one `__hmin2` (exact), two elements an instruction each, where float32
// takes one FADD and one FMNMX an element.  The plain versions
// (`ops/minplus.py`) add in bf16 as the CPU does, in fp32 with one rounding
// to bf16; that equals the correctly rounded sum, since rounding a sum first
// to fp32's 24 bits and then to bf16's 8 is innocuous (24 >= 2 * 8 + 2).
// Min is exact, so every result is bit-identical to the plain version's.
// An element broadcast to both halves of a pair (`bcast`) costs at most one
// PRMT, shared by every pair it meets.

#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

template <class E>
constexpr bool kIsBf16 = std::is_same<E, bf16>::value;

// 4 consecutive elements of a row, loaded and stored as one 16- or 8-byte word
template <class E>
struct Run;
template <>
struct alignas(16) Run<float> {
  float v[4];
};
template <>
struct alignas(8) Run<bf16> {
  bf162 v[2];  // columns (0, 1) and (2, 3)
};

// one element broadcast over a run's lanes: a float, or a bf16 in both
// halves of a pair
template <class E>
using Bc = typename std::conditional<kIsBf16<E>, bf162, float>::type;

__device__ __forceinline__ uint32_t as_u32(bf162 x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

__device__ __forceinline__ bf162 as_bf162(uint32_t u) {
  bf162 x;
  memcpy(&x, &u, 4);
  return x;
}

// the run at p (16-byte aligned in float32, 8-byte in bf16), as one load
template <class E>
__device__ __forceinline__ Run<E> load_run(const E* p) {
  Run<E> r;
  if constexpr (kIsBf16<E>) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    r.v[0] = as_bf162(u.x);
    r.v[1] = as_bf162(u.y);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    r.v[0] = f.x, r.v[1] = f.y, r.v[2] = f.z, r.v[3] = f.w;
  }
  return r;
}

// r to p, as one store
template <class E>
__device__ __forceinline__ void store_run(E* p, const Run<E>& r) {
  if constexpr (kIsBf16<E>)
    *reinterpret_cast<uint2*>(p) = make_uint2(as_u32(r.v[0]), as_u32(r.v[1]));
  else
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
}

template <class E>
__device__ __forceinline__ Run<E> inf_run() {
  Run<E> r;
  if constexpr (kIsBf16<E>) {
    const bf162 inf = as_bf162(0x7f807f80u);  // +inf in both halves
    r.v[0] = r.v[1] = inf;
  } else {
#pragma unroll
    for (int f = 0; f < 4; ++f) r.v[f] = CUDART_INF_F;
  }
  return r;
}

// element f of r
template <class E>
__device__ __forceinline__ E get(const Run<E>& r, int f) {
  if constexpr (kIsBf16<E>)
    return (f & 1) ? __high2bfloat16(r.v[f >> 1]) : __low2bfloat16(r.v[f >> 1]);
  else
    return r.v[f];
}

// element f of r, broadcast
template <class E>
__device__ __forceinline__ Bc<E> bcast(const Run<E>& r, int f) {
  if constexpr (kIsBf16<E>)
    return (f & 1) ? __high2bfloat162(r.v[f >> 1]) : __low2bfloat162(r.v[f >> 1]);
  else
    return r.v[f];
}

template <class E>
__device__ __forceinline__ Bc<E> bcast(E x) {
  if constexpr (kIsBf16<E>)
    return __bfloat162bfloat162(x);
  else
    return x;
}

// r = min(r, a + b), element by element: one add and one min an element
// (float32) or a pair (bf16)
template <class E>
__device__ __forceinline__ void relax(Run<E>& r, Bc<E> a, const Run<E>& b) {
  if constexpr (kIsBf16<E>) {
#pragma unroll
    for (int c = 0; c < 2; ++c) r.v[c] = __hmin2(r.v[c], __hadd2(a, b.v[c]));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) r.v[c] = fminf(r.v[c], a + b.v[c]);
  }
}

// r = min(r, b), element by element
template <class E>
__device__ __forceinline__ void meet(Run<E>& r, const Run<E>& b) {
  if constexpr (kIsBf16<E>) {
#pragma unroll
    for (int c = 0; c < 2; ++c) r.v[c] = __hmin2(r.v[c], b.v[c]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) r.v[c] = fminf(r.v[c], b.v[c]);
  }
}

// a and b differ: as floats in float32, by their bits in bf16
template <class E>
__device__ __forceinline__ bool ne(E a, E b) {
  if constexpr (kIsBf16<E>)
    return __bfloat16_as_ushort(a) != __bfloat16_as_ushort(b);
  else
    return a != b;
}

template <class E>
__device__ __forceinline__ bool differs(const Run<E>& a, const Run<E>& b) {
  if constexpr (kIsBf16<E>)
    return (as_u32(a.v[0]) != as_u32(b.v[0])) | (as_u32(a.v[1]) != as_u32(b.v[1]));
  else
    return (a.v[0] != b.v[0]) | (a.v[1] != b.v[1]) | (a.v[2] != b.v[2]) | (a.v[3] != b.v[3]);
}

// the 32-bit words of r, kept live for a clock read (bench builds only)
template <class E>
__device__ __forceinline__ void keep_live(const Run<E>& r) {
  if constexpr (kIsBf16<E>) {
    asm volatile("" ::"r"(as_u32(r.v[0])), "r"(as_u32(r.v[1])));
  } else {
    asm volatile("" ::"f"(r.v[0]), "f"(r.v[1]), "f"(r.v[2]), "f"(r.v[3]));
  }
}

}  // namespace
