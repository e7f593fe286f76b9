// Helpers of the port's Hopper kernels (sm_90a): 16-byte vector loads with
// f32 conversion, f32 stores to the storage type, cp.async, mbarriers and
// the TMA's bulk copies, int8 to bf16 conversion, the bf16 tensor-core
// mma.sync tile, warp reductions, and the integer ticket that elects the
// last block of a group to merge the group's partials.
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

// mbarriers in shared memory and the TMA's copies that complete on them
// (PTX ISA: mbarrier, cp.async.bulk, cp.async.bulk.tensor). One thread
// arms a barrier with the bytes it expects (`mbar_expect_tx`, which is also
// that thread's arrival), the copies count them off, and every thread waits
// for the phase's parity.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// makes initialised barriers visible to the TMA (the async proxy)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
// orders this thread's earlier shared-memory accesses before the async
// proxy's next writes (a TMA load into memory the block has just used)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a box of a 2-D tensor map (`tmap`, a __grid_constant__ parameter) at
// element coordinates (c0 innermost, c1) into shared memory (128-byte aligned)
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, int c0, int c1,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1),
        "r"(smem_u32(bar)) : "memory");
}
// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Four 8x8 b16 matrices from shared memory, transposed (ldmatrix .trans):
// lanes 8q .. 8q + 7 give the addresses of matrix q's 8 rows of 16 bytes;
// lane (g = lane / 4, t = lane % 4) receives, of each matrix, b16 column g
// of rows 2t and 2t + 1. Volatile, so that it stays after the barrier
// waits that make the TMA's writes visible.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// (a & b) | c in one instruction
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Four int8 values (the bytes of q, lowest first) as two bf16 pairs: even
// holds bytes 0 and 2 (byte 0 in the low half), odd bytes 1 and 3. Exact:
// a byte b is (b & 127) - (b & 128); the bf16 with exponent 2^7 and
// mantissa b & 127 is 128 + (b & 127), the one with mantissa bit 7 set is
// 256, so one bf16x2 subtraction of the two forms leaves b in each half,
// every value on the way a bf16.
__device__ __forceinline__ void int8x4_to_bf16x2(uint32_t q, uint32_t& even, uint32_t& odd) {
  const uint32_t low7 = 0x007F007Fu, sign = 0x00800080u, exp7 = 0x43004300u;
  const uint32_t qo = q >> 8;
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(even) : "r"(and_or(q, low7, exp7)), "r"(and_or(q, sign, exp7)));
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(odd) : "r"(and_or(qo, low7, exp7)), "r"(and_or(qo, sign, exp7)));
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
