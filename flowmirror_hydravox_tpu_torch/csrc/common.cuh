// Helpers of the port's Hopper kernels (sm_90a): 16-byte vector loads with
// f32 conversion, f32 stores to the storage type, cp.async, int8 to bf16
// conversion, the bf16 tensor-core mma.sync tile, warp reductions, and the
// integer ticket that elects the last block of a group to merge the group's
// partials.
//
// Included by decode_attention.cu and mlp_gemv.cu; ops/nvcc_build.py
// rebuilds a library when this header is newer than it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hv {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // 16 bytes
  __device__ __forceinline__ static void load(const float* p, float* dst) {
    float4 x = *reinterpret_cast<const float4*>(p);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;  // 16 bytes
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* dst) {
    uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16-byte asynchronous copy global -> shared; with pred false the 16 bytes
// are zero-filled and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four int8 values (the bytes of q, lowest first) as two bf16 pairs: lo
// holds bytes 0 and 1 (byte 0 in the low half), hi bytes 2 and 3. Exact:
// each byte, offset by 128, goes into the mantissa of 2^23 and the offset
// is subtracted in f32; an integer of magnitude <= 128 is a bf16, the high
// half of its f32.
__device__ __forceinline__ void int8x4_to_bf16x2(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;  // each byte as v + 128
  constexpr float kBias = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - kBias;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// D += A B for one m16n8k16 bf16 tile with f32 accumulators (PTX ISA
// fragment layout: lane = 4 * group + tig; a0 (row group, k 2 tig..+1),
// a1 (row group + 8, same k), a2/a3 the same at k + 8; b0 (k 2 tig..+1,
// col group), b1 at k + 8; c0/c1 (row group, cols 2 tig..+1), c2/c3 row
// group + 8).
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Called by every thread of a block after it wrote its partials. Returns
// true in the block that arrives last of `n` blocks sharing `*ticket`; that
// block then sees every partial (read them with __ldcg) and must reset the
// ticket with `release_ticket` once done. Integer atomics only: which block
// is last varies, the order in which it merges the partials does not.
__device__ __forceinline__ bool last_of_group(int* ticket, int n) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1) == n - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last != 0;
}
__device__ __forceinline__ void release_ticket(int* ticket) {
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace hv
