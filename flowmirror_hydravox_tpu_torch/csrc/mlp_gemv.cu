// Fused SwiGLU-MLP GEMV for decode rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel `pallas_mlp_gemv` (body `_mlp_kernel`) of
// flowmirror_hydravox_tpu/ops/pallas_mlp.py. It computes what that kernel
// computes:
//
//   x (M, H), gate and up (H, I), down (I, H), row-major, one dtype T;
//   h   = round_T(silu(x @ gate) * (x @ up))   both products accumulated in f32
//   out = round_T(h @ down)                     accumulated in f32
//
// What bounds it on the card: bytes. Each weight element is read once and
// takes 2*M operations, so at decode sizes (M <= 40) it does at most ~40
// operations per bf16 byte, far below the H100's ~295 balance point. The
// least time is the weights' 3*H*I elements over 3.35 TB/s: 7.8 us for one
// backbone layer (896 x 4864, bf16) and 35.3 us for one MTP head
// (896 x 22016).
//
// Design (a simple, right first version). The TPU kernel carried one f32
// accumulator (M, H) across a sequential grid over I tiles; blocks on the
// card run in parallel and carry nothing between them, so the work is cut
// into passes:
//   - pass 1 (`swiglu_kernel`): one block per TN columns of I. It walks H in
//     chunks of KC: the chunk of x's rows and of gate's and up's columns goes
//     to shared memory as f32, and each thread accumulates RPT (row, column)
//     outputs of both products in registers. The epilogue applies silu, the
//     product, and the rounding to T, into an (M, ldh) scratch the wrapper
//     allocates.
//   - pass 2 (`down_kernel`): one block per (TN columns of H, split of I),
//     the same chunk loop over its share of I. It writes f32 partials
//     (splits, M, H), or the output itself when there is one split.
//   - pass 3 (`sum_splits_kernel`): sums the partials in split order and
//     rounds to T. No float atomics anywhere: the same inputs give the same
//     output on every run.
//   - Rows: a block holds up to MR = 64 rows of x (or h) and loops over them,
//     so each weight byte is read from memory once per call for M <= 64 (a
//     coalesced decode step has at most B 8 x K 5 = 40 rows). Larger M takes
//     further row blocks (gridDim.y of pass 1, gridDim.z of pass 2), and each
//     of them reads the weights again.
//   - Loads are 16 bytes wide with neighbouring threads on neighbouring
//     columns; gate and up fall back to element loads when I is not a
//     multiple of the vector width (I only has to be >= 1).
//   - Enough blocks: pass 1 has I / TN = 152 blocks at I = 4864; the wrapper
//     splits I in pass 2 until ~264 blocks are in flight.
// Later work: tensor-core (mma / wgmma) tiles, TMA, and a pipelined weight
// stream; here each chunk is loaded, then consumed, with no overlap.
//
// Plain C interface (bound with ctypes): the wrapper allocates h, the
// partials and the output, passes PyTorch's current stream, and raises on a
// non-zero return (a refused launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TN = 32;               // output columns per block: one warp wide
constexpr int KC = 64;               // reduction depth of one shared-memory chunk
constexpr int MR = 64;               // rows per block
constexpr int WARPS = THREADS / TN;  // a warp owns rows r0, r0 + WARPS, ...
constexpr int RPT = MR / WARPS;      // rows per thread

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// acc[nb][j] += sum_{k0 <= k < k1} a[m, k] * b_nb[k, col0 + c] for this
// thread's column c = tid % TN and rows m = tid / TN + j * WARPS < m_cnt.
// `a` points at the block's first row (row stride lda, a multiple of the
// vector width, readable up to the next multiple of it past k1); b_nb are
// (K, n_cols) with row stride ldb. Out-of-range rows and columns read as 0.
template <typename T, int NB>
__device__ __forceinline__ void gemm_rows(const T* __restrict__ a, int lda, int m_cnt,
                                          const T* __restrict__ b0, const T* __restrict__ b1,
                                          int ldb, int n_cols, bool b_vec, int col0, int k0,
                                          int k1, float (&a_s)[MR][KC],
                                          float (&b_s)[NB][KC][TN], float (&acc)[NB][RPT]) {
  constexpr int VN = Vec<T>::N;
  const int tid = threadIdx.x;
  const int c = tid % TN;
  const int r0 = tid / TN;
  for (int kc = k0; kc < k1; kc += KC) {
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = tid; e < m_cnt * (KC / VN); e += THREADS) {
      const int m = e / (KC / VN);
      const int kk = (e % (KC / VN)) * VN;
      float tmp[VN];
      if (kc + kk < k1) {
        Vec<T>::load(a + (size_t)m * lda + kc + kk, tmp);
#pragma unroll
        for (int i = 0; i < VN; ++i)
          if (kc + kk + i >= k1) tmp[i] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) tmp[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) a_s[m][kk + i] = tmp[i];
    }
    for (int e = tid; e < KC * (TN / VN); e += THREADS) {
      const int kk = e / (TN / VN);
      const int cc = (e % (TN / VN)) * VN;
      const int k = kc + kk;
      const int col = col0 + cc;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const T* bp = nb == 0 ? b0 : b1;
        float tmp[VN];
        if (k < k1 && b_vec && col + VN <= n_cols) {
          Vec<T>::load(bp + (size_t)k * ldb + col, tmp);
        } else {
#pragma unroll
          for (int i = 0; i < VN; ++i)
            tmp[i] = (k < k1 && col + i < n_cols) ? to_float(bp[(size_t)k * ldb + col + i]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < VN; ++i) b_s[nb][kk][cc + i] = tmp[i];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; k += 4) {
      float bv[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[nb][q] = b_s[nb][k + q][c];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int m = r0 + j * WARPS;  // the same for the whole warp
        if (m < m_cnt) {
          const float4 av = *reinterpret_cast<const float4*>(&a_s[m][k]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            float s = acc[nb][j];
            s = fmaf(av.x, bv[nb][0], s);
            s = fmaf(av.y, bv[nb][1], s);
            s = fmaf(av.z, bv[nb][2], s);
            s = fmaf(av.w, bv[nb][3], s);
            acc[nb][j] = s;
          }
        }
      }
    }
  }
}

// Pass 1: h[m, i] = round_T(silu(x @ gate) * (x @ up)) for one tile of I.
template <typename T>
__global__ void __launch_bounds__(THREADS)
swiglu_kernel(const T* __restrict__ x, const T* __restrict__ gate, const T* __restrict__ up,
              T* __restrict__ h, int m_total, int hdim, int idim, int ldh, int b_vec) {
  __shared__ __align__(16) float a_s[MR][KC];
  __shared__ __align__(16) float b_s[2][KC][TN];
  const int m0 = blockIdx.y * MR;
  const int m_cnt = min(MR, m_total - m0);
  const int col0 = blockIdx.x * TN;
  float acc[2][RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[0][j] = acc[1][j] = 0.f;
  gemm_rows<T, 2>(x + (size_t)m0 * hdim, hdim, m_cnt, gate, up, idim, idim, b_vec != 0, col0,
                  0, hdim, a_s, b_s, acc);
  const int col = col0 + threadIdx.x % TN;
  if (col >= idim) return;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int m = threadIdx.x / TN + j * WARPS;
    if (m < m_cnt) {
      const float g = acc[0][j];
      from_float(h + (size_t)(m0 + m) * ldh + col, g / (1.f + expf(-g)) * acc[1][j]);
    }
  }
}

// Pass 2: h @ down over one split [k0, k1) of I, for one tile of H.
template <typename T>
__global__ void __launch_bounds__(THREADS)
down_kernel(const T* __restrict__ h, const T* __restrict__ down, T* __restrict__ out,
            float* __restrict__ part, int m_total, int hdim, int idim, int ldh, int chunk) {
  __shared__ __align__(16) float a_s[MR][KC];
  __shared__ __align__(16) float b_s[1][KC][TN];
  const int col0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MR;
  const int m_cnt = min(MR, m_total - m0);
  const int k0 = split * chunk;
  const int k1 = min(k0 + chunk, idim);
  float acc[1][RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[0][j] = 0.f;
  gemm_rows<T, 1>(h + (size_t)m0 * ldh, ldh, m_cnt, down, nullptr, hdim, hdim, true, col0, k0,
                  k1, a_s, b_s, acc);
  const int col = col0 + threadIdx.x % TN;
  if (col >= hdim) return;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int m = threadIdx.x / TN + j * WARPS;
    if (m < m_cnt) {
      const size_t row = (size_t)(m0 + m);
      if (part != nullptr) {
        part[((size_t)split * m_total + row) * hdim + col] = acc[0][j];
      } else {
        from_float(out + row * hdim + col, acc[0][j]);
      }
    }
  }
}

// Pass 3: out = round_T(sum over splits, in split order).
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ part, T* __restrict__ out, int n,
                                  int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * n + idx];
  from_float(out + idx, s);
}

template <typename T>
void launch(const void* x, const void* gate, const void* up, const void* down, void* h,
            float* part, void* out, int m, int hdim, int idim, int ldh, int splits, int chunk,
            cudaStream_t stream) {
  const int row_blocks = (m + MR - 1) / MR;
  dim3 grid1((idim + TN - 1) / TN, row_blocks);
  swiglu_kernel<T><<<grid1, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<T*>(h), m, hdim, idim, ldh, idim % Vec<T>::N == 0);
  dim3 grid2((hdim + TN - 1) / TN, splits, row_blocks);
  down_kernel<T><<<grid2, THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(down), static_cast<T*>(out),
      splits > 1 ? part : nullptr, m, hdim, idim, ldh, chunk);
  if (splits > 1) {
    const int n = m * hdim;
    sum_splits_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(part, static_cast<T*>(out), n,
                                                              splits);
  }
}

}  // namespace

extern "C" {

// Tile sizes, read by the wrapper to plan the split of I and the scratch.
int hv_mlp_gemv_cols_per_block() { return TN; }
int hv_mlp_gemv_chunk() { return KC; }
int hv_mlp_gemv_rows_per_block() { return MR; }

// dtype: 0 = float32, 1 = bfloat16. h is (m, ldh) of the dtype, ldh a
// multiple of 8 and >= idim; part is (splits, m, hdim) f32 when splits > 1.
// Returns 0, -1 for an unsupported dtype, or the cudaError_t of the launches.
int hv_mlp_gemv(int dtype, const void* x, const void* gate, const void* up, const void* down,
                void* h, float* part, void* out, int m, int hdim, int idim, int ldh, int splits,
                int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, gate, up, down, h, part, out, m, hdim, idim, ldh, splits, chunk, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, gate, up, down, h, part, out, m, hdim, idim, ldh, splits, chunk,
                          st);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
