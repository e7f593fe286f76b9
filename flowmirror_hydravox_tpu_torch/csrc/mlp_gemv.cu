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
// and its int8-weight form (`hv_mlp_gemv_int8`, for weight-only int8 trees,
// ops/quant.py): gate, up and down int8 with per-output-column f32 scales
// s_g, s_u (I) and s_d (H), x of dtype T;
//   a = (x @ g8) * s_g,  b = (x @ u8) * s_u       accumulated in f32
//   h   = round_T(silu(a) * b)
//   out = round_T((h @ d8) * s_d)                 s_d after the split sum
//
// What bounds it on the card: bytes. Each weight element is read once and
// takes 2*M operations, so at decode sizes (M <= 40) it does at most ~40
// operations per bf16 byte, far below the H100's ~295 balance point. The
// least time is the weights' 3*H*I elements over 3.35 TB/s: 7.8 us for one
// backbone layer (896 x 4864, bf16) and 35.3 us for one MTP head
// (896 x 22016). Reaching it takes several MB of loads in flight across the
// card and a read pattern that uses whole 128-byte lines. The int8 form
// reads half the bytes: 3.9 us and 17.7 us.
//
// Design. The weights are read as they are, in JAX's (in, out) layout:
//   - Warp tile: 64 output columns x 16 rows of the reduction (a k-step).
//     A lane reads 16 contiguous bytes of a weight row (bf16: 8 columns of
//     4 rows per k-step; f32: 2 columns of 16 rows), so eight lanes cover a
//     row's 128-byte segment. The loads go straight to registers, KU k-steps
//     a round (2-4: what the accumulators leave), the first round requested
//     before x is staged; with 8-16 warps a block, several MB are in flight
//     across the card.
//   - bf16 math on the tensor cores: mma.sync m16n8k16 with the weight
//     tile as the 16-row operand and up to 8 rows of x as the 8-wide one.
//     The 16 "rows" of one mma are the columns 8g + 2j and 8g + 2j + 1
//     (g = lane / 4) of the warp tile, so the registers of a lane's four
//     16-byte loads (rows 2t, 2t+1, 2t+8, 2t+9 of the k-step, t = lane % 4)
//     become the four A fragments of mma j = 0..3 by two byte permutes
//     each; the weights never pass through shared memory. x rows are
//     zero-padded to 8, 16 or 40 (row groups MG = 1, 2, 5); at 40 the
//     accumulators leave room for 8-byte loads only, so the warp tile is
//     32 columns (two mma a k-step). f32 math on the CUDA cores (FMA, full
//     f32), 8 or 16 rows.
//   - x stays put: a block stages its rows of x (or of h) in shared memory
//     once, by cp.async all in flight together, padded by 16 bytes a row so
//     the mma's B fragments come from distinct banks.
//   - Pass 1 (`swiglu_kernel`): one block per column tile of I, 16 warps
//     (8 at 40 rows, so that two blocks fit an SM and the 152 blocks of
//     I 4864 run in one wave); the first half of the warps reduce x @ gate
//     and the second x @ up, each over its share of the k-steps of H. The
//     block adds the shares in warp order, applies silu and the product,
//     and rounds h to T into an (M, ldh) scratch (ldh = I rounded up to 8,
//     the pad written as 0).
//   - Pass 2 (`down_kernel`): one block per (column tile of H, split of I);
//     its 8 warps share the split's k-steps. It is launched as pass 1's
//     programmatic dependent: its blocks start once every pass-1 block
//     runs, request their first round of `down`, and wait for pass 1 to
//     complete (griddepcontrol.wait) only before they read h, so `down`
//     streams while pass 1 finishes. With one split the block writes the
//     output; otherwise it writes f32 partials, and the last block of its
//     column tile, elected by an integer ticket, sums the partials in split
//     order, rounds to T and resets the ticket. No float atomics: the same
//     inputs give bit-equal outputs. Two launches a call.
//   - Any M >= 1 (more than 40 rows in bf16, 16 in f32, take further row
//     blocks, each reading the weights again), any I >= 1 (element loads
//     for gate and up when I is not a multiple of 8), H a multiple of 8.
//   - The int8 form is the same kernels with the weight type a template
//     parameter: a lane loads the same columns as raw bytes (8 or 4 a row,
//     2 for f32 rows), keeps them raw while they are in flight, and turns
//     them into the bf16 (or f32) fragments exactly, in registers, just
//     before the k-step's mma (int8x4_to_bf16x2 in common.cuh); the scales
//     multiply the f32 sums where pass 1 applies silu and where pass 2
//     writes its output. A right and simple form: the warp tile and the
//     planning are the bf16 form's, so a row read is 64 or 32 bytes rather
//     than 128.
//
// Plain C interface (bound with ctypes): the wrapper allocates h, the
// partials, the output and the zeroed ticket buffer (reused across calls
// on one stream), passes PyTorch's current stream, and raises on a non-zero
// return (a refused launch).

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int W2 = 8;   // warps of a pass-2 block
constexpr int KS = 16;  // rows of the reduction per k-step
// dynamic shared memory a block may use: the H100's 227 KB opt-in less 1 KB
// for the static shared memory of the ticket
constexpr int MAX_SMEM = 232448 - 1024;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Row stride (elements) of the staged x or h rows: the k-steps' extent,
// plus 16 bytes for bf16 so that the 8 rows of a B fragment hit 8
// different bank quads.
template <typename T>
__host__ __device__ constexpr int staged_ld(int k) {
  return round_up(k, KS) + (sizeof(T) == 2 ? 8 : 0);
}

template <typename T, typename W, int MG>
struct WarpTile;

// bf16: tensor cores. A lane loads CW columns of a weight row (16 bytes
// at 1-2 row groups, 8 at 5, where the accumulators take the registers),
// so the warp tile is TN = 8 CW columns and a k-step J = CW / 2 mma per row
// group. acc[gr][j][c]: x row gr * 8 + 2 t + (c & 1), column
// CW g + 2 j + (c >> 1) of the warp tile.
template <int MG>
struct WarpTile<bf16, bf16, MG> {
  static constexpr int CW = MG <= 2 ? 8 : 4;
  static constexpr int J = CW / 2;
  static constexpr int TN = 8 * CW;
  struct Frag {
    uint32_t r[4][J];  // rows 2t, 2t+1, 2t+8, 2t+9 of the k-step; columns CW g ..
  };
  float acc[MG][J][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int gr = 0; gr < MG; ++gr)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[gr][j][c] = 0.f;
  }

  // Load this lane's part of one k-step: rows krow + 2t, +1, +8, +9,
  // columns col0 + CW g .. + CW - 1, one load a row where the columns come
  // in whole 16-byte vectors, else element by element (a ragged I). Rows
  // and columns out of range read as 0.
  __device__ __forceinline__ static void load(Frag& f, const bf16* __restrict__ w, int ldw,
                                              int n_cols, int col0, int krow, int k_lim,
                                              bool vec) {
    const int lane = threadIdx.x % 32;
    const int col = col0 + (lane / 4) * CW;
    const int t = lane % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = krow + 2 * t + (i & 1) + (i >> 1) * 8;
      const bf16* p = w + (size_t)row * ldw + col;
      const bool in = row < k_lim && col < n_cols;
      if (vec && CW == 8) {
        const uint4 u = in ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
        f.r[i][0] = u.x;
        f.r[i][1 % J] = u.y;
        f.r[i][2 % J] = u.z;
        f.r[i][3 % J] = u.w;
      } else if (vec) {
        const uint2 u = in ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
        f.r[i][0] = u.x;
        f.r[i][1 % J] = u.y;
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const uint32_t lo =
              row < k_lim && col + 2 * j < n_cols ? __bfloat16_as_ushort(p[2 * j]) : 0;
          const uint32_t hi =
              row < k_lim && col + 2 * j + 1 < n_cols ? __bfloat16_as_ushort(p[2 * j + 1]) : 0;
          f.r[i][j] = lo | hi << 16;
        }
      }
    }
  }

  // xs: the block's staged rows (row stride ldx); xk: the k-step's first
  // column in them
  __device__ __forceinline__ void step(const Frag& f, const bf16* xs, int ldx, int xk) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    uint32_t b0[MG], b1[MG];
#pragma unroll
    for (int gr = 0; gr < MG; ++gr) {
      const bf16* xp = xs + (gr * 8 + g) * ldx + xk + 2 * t;
      b0[gr] = *reinterpret_cast<const uint32_t*>(xp);
      b1[gr] = *reinterpret_cast<const uint32_t*>(xp + 8);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      // A row g: column CW g + 2j at k 2t, 2t+1 (low halves of rows 2t,
      // 2t+1); A row g + 8: column CW g + 2j + 1 (high halves); a2/a3 at k + 8
      const uint32_t a0 = __byte_perm(f.r[0][j], f.r[1][j], 0x5410);
      const uint32_t a1 = __byte_perm(f.r[0][j], f.r[1][j], 0x7632);
      const uint32_t a2 = __byte_perm(f.r[2][j], f.r[3][j], 0x5410);
      const uint32_t a3 = __byte_perm(f.r[2][j], f.r[3][j], 0x7632);
#pragma unroll
      for (int gr = 0; gr < MG; ++gr)
        hv::mma_bf16_16816(acc[gr][j], a0, a1, a2, a3, b0[gr], b1[gr]);
    }
  }

  // red: this warp's [8 MG][TN] f32 tile
  __device__ __forceinline__ void store(float* red) const {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int gr = 0; gr < MG; ++gr)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[(gr * 8 + 2 * t + (c & 1)) * TN + CW * g + 2 * j + (c >> 1)] = acc[gr][j][c];
  }
};

// f32: CUDA cores. acc[m][c]: x row m, column 2 lane + c of the warp tile.
template <int MG>
struct WarpTile<float, float, MG> {
  static constexpr int TN = 64;
  struct Frag {
    float2 w[KS];
  };
  float acc[MG * 8][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MG * 8; ++m) acc[m][0] = acc[m][1] = 0.f;
  }

  __device__ __forceinline__ static void load(Frag& f, const float* __restrict__ w, int ldw,
                                              int n_cols, int col0, int krow, int k_lim,
                                              bool vec) {
    const int col = col0 + 2 * (threadIdx.x % 32);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int row = krow + kk;
      const float* p = w + (size_t)row * ldw + col;
      if (vec) {
        f.w[kk] = (row < k_lim && col < n_cols) ? __ldg(reinterpret_cast<const float2*>(p))
                                                : make_float2(0.f, 0.f);
      } else {
        f.w[kk] = make_float2((row < k_lim && col < n_cols) ? p[0] : 0.f,
                              (row < k_lim && col + 1 < n_cols) ? p[1] : 0.f);
      }
    }
  }

  __device__ __forceinline__ void step(const Frag& f, const float* xs, int ldx, int xk) {
#pragma unroll
    for (int m = 0; m < MG * 8; ++m) {
#pragma unroll
      for (int kk = 0; kk < KS; kk += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + m * ldx + xk + kk);
        acc[m][0] = fmaf(xv.x, f.w[kk].x, acc[m][0]);
        acc[m][1] = fmaf(xv.x, f.w[kk].y, acc[m][1]);
        acc[m][0] = fmaf(xv.y, f.w[kk + 1].x, acc[m][0]);
        acc[m][1] = fmaf(xv.y, f.w[kk + 1].y, acc[m][1]);
        acc[m][0] = fmaf(xv.z, f.w[kk + 2].x, acc[m][0]);
        acc[m][1] = fmaf(xv.z, f.w[kk + 2].y, acc[m][1]);
        acc[m][0] = fmaf(xv.w, f.w[kk + 3].x, acc[m][0]);
        acc[m][1] = fmaf(xv.w, f.w[kk + 3].y, acc[m][1]);
      }
    }
  }

  __device__ __forceinline__ void store(float* red) const {
    const int c0 = 2 * (threadIdx.x % 32);
#pragma unroll
    for (int m = 0; m < MG * 8; ++m) {
      red[m * TN + c0] = acc[m][0];
      red[m * TN + c0 + 1] = acc[m][1];
    }
  }
};

// int8 weights (the int8 form), bf16 rows: the same warp tile and mma as
// bf16 weights. A lane loads the same CW columns of a weight row, CW bytes
// (8 or 4), and keeps them raw until the k-step is used, so that a round's
// loads stay in flight while x is staged; `step` turns them into the bf16
// fragments (exactly: |w8| <= 127 needs 8 significant bits) and runs the
// bf16 tile's step.
template <int MG>
struct WarpTile<bf16, int8_t, MG> : WarpTile<bf16, bf16, MG> {
  using Base = WarpTile<bf16, bf16, MG>;
  static constexpr int CW = Base::CW;
  static constexpr int QW = CW / 4;  // 32-bit words of a lane's row
  struct Frag {
    uint32_t q[4][QW];  // rows 2t, 2t+1, 2t+8, 2t+9 of the k-step; columns CW g ..
  };

  __device__ __forceinline__ static void load(Frag& f, const int8_t* __restrict__ w, int ldw,
                                              int n_cols, int col0, int krow, int k_lim,
                                              bool vec) {
    const int lane = threadIdx.x % 32;
    const int col = col0 + (lane / 4) * CW;
    const int t = lane % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = krow + 2 * t + (i & 1) + (i >> 1) * 8;
      const int8_t* p = w + (size_t)row * ldw + col;
      const bool in = row < k_lim && col < n_cols;
      if (vec && QW == 2) {
        const uint2 u = in ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
        f.q[i][0] = u.x;
        f.q[i][1 % QW] = u.y;
      } else if (vec) {
        f.q[i][0] = in ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
      } else {
#pragma unroll
        for (int wd = 0; wd < QW; ++wd) {
          uint32_t word = 0;  // a 0 byte is the weight 0
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (row < k_lim && col + 4 * wd + b < n_cols)
              word |= (uint32_t)(uint8_t)p[4 * wd + b] << (8 * b);
          f.q[i][wd] = word;
        }
      }
    }
  }

  __device__ __forceinline__ void step(const Frag& f, const bf16* xs, int ldx, int xk) {
    typename Base::Frag b;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int wd = 0; wd < QW; ++wd)
        hv::int8x4_to_bf16x2(f.q[i][wd], b.r[i][2 * wd], b.r[i][2 * wd + 1]);
    Base::step(b, xs, ldx, xk);
  }
};

// int8 weights, f32 rows: the f32 tile; a lane keeps its two raw bytes a
// row until `step` converts them.
template <int MG>
struct WarpTile<float, int8_t, MG> : WarpTile<float, float, MG> {
  using Base = WarpTile<float, float, MG>;
  struct Frag {
    uint32_t q[KS];  // the low 16 bits: columns 2 lane, 2 lane + 1
  };

  __device__ __forceinline__ static void load(Frag& f, const int8_t* __restrict__ w, int ldw,
                                              int n_cols, int col0, int krow, int k_lim,
                                              bool vec) {
    const int col = col0 + 2 * (threadIdx.x % 32);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int row = krow + kk;
      const int8_t* p = w + (size_t)row * ldw + col;
      if (vec) {
        f.q[kk] = (row < k_lim && col < n_cols)
                      ? __ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
      } else {
        f.q[kk] = ((row < k_lim && col < n_cols) ? (uint32_t)(uint8_t)p[0] : 0u) |
                  ((row < k_lim && col + 1 < n_cols) ? (uint32_t)(uint8_t)p[1] << 8 : 0u);
      }
    }
  }

  __device__ __forceinline__ void step(const Frag& f, const float* xs, int ldx, int xk) {
    typename Base::Frag b;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      b.w[kk] = make_float2((float)(int8_t)(f.q[kk] & 0xff), (float)(int8_t)(f.q[kk] >> 8));
    Base::step(b, xs, ldx, xk);
  }
};

// k-steps of loads in flight per warp, as registers allow next to the
// accumulators: bf16 4 at 1 and 5 row groups (8-byte loads at 5), 2 at 2;
// f32 2
template <typename T, int MG>
__host__ __device__ constexpr int k_unroll() {
  return sizeof(T) == 2 && MG != 2 ? 4 : 2;
}

// warps of a pass-1 block: 16 (8 slices of H for each of gate and up); 8
// at 5 row groups, so that two blocks fit an SM and the 152 blocks of
// I 4864 run in one wave
template <int MG>
__host__ __device__ constexpr int w1() {
  return MG <= 2 ? 16 : 8;
}

// Shared memory of a block: the staged rows (8 MG x ld elements), later
// reused for the warps' [warps][8 MG][TN] f32 tiles.
template <typename T, int MG>
__host__ __device__ constexpr int smem_bytes(int ld, int warps) {
  constexpr int TN = WarpTile<T, T, MG>::TN;
  return MG * 8 * ld * (int)sizeof(T) > warps * MG * 8 * TN * 4 ? MG * 8 * ld * (int)sizeof(T)
                                                                : warps * MG * 8 * TN * 4;
}

// One warp's share of a product: k-steps first, first + stride, ... (n of
// them) of weight rows starting at krow0, against the staged rows xs whose
// column 0 is weight row krow0. The loads go to registers, KU k-steps a
// round; the first round is issued before `stage` (which stages xs and
// syncs the block, and which every warp calls), so it is in flight while x
// or h is staged, and each later round is issued as soon as the previous
// one is used.
template <typename T, typename W, int MG, typename Stage>
__device__ __forceinline__ void warp_product(WarpTile<T, W, MG>& tile, const W* __restrict__ w,
                                             int ldw, int n_cols, int col0, int krow0,
                                             int k_lim, bool vec, int first, int stride, int n,
                                             const T* xs, int ldx, Stage stage) {
  constexpr int KU = k_unroll<T, MG>();
  typename WarpTile<T, W, MG>::Frag f[KU];
  auto load_round = [&](int i) {
#pragma unroll
    for (int u = 0; u < KU; ++u)
      if (i + u < n)
        WarpTile<T, W, MG>::load(f[u], w, ldw, n_cols, col0,
                                 krow0 + (first + (i + u) * stride) * KS, k_lim, vec);
  };
  load_round(0);
  stage();
  tile.zero();
  for (int i = 0; i < n; i += KU) {
#pragma unroll
    for (int u = 0; u < KU; ++u)
      if (i + u < n) tile.step(f[u], xs, ldx, (first + (i + u) * stride) * KS);
    if (i + KU < n) load_round(i + KU);
  }
}

// Copy rows [m0, m0 + m_cnt) x columns [k0, k0 + k_cnt) of src (row stride
// ld) into xs (8 MG rows, stride ldx), zero elsewhere up to the k-steps'
// extent, and sync the block. k0 and ld are multiples of 8 elements, and
// src is readable up to the next multiple of 8 past k0 + k_cnt. The copies
// are cp.async, all in flight at once: one memory round trip.
template <typename T, int MG>
__device__ __forceinline__ void stage_rows(T* xs, int ldx, const T* __restrict__ src, int ld,
                                           int m0, int m_cnt, int k0, int k_cnt) {
  constexpr int VN = 16 / sizeof(T);
  const int kpad = round_up(k_cnt, KS);
  for (int e = threadIdx.x * VN; e < MG * 8 * kpad; e += blockDim.x * VN) {
    const int m = e / kpad;
    const int k = e % kpad;
    const bool in = m < m_cnt && k < k_cnt;
    hv::cp_async16(xs + m * ldx + k, in ? src + (size_t)(m0 + m) * ld + k0 + k : src, in);
  }
  hv::cp_async_commit();
  hv::cp_async_wait<0>();
  __syncthreads();
}

// Pass 1: h[m, i] = round_T(silu(a) * b), a = x @ gate and b = x @ up, for
// TN columns of I. Warps [0, W1/2) reduce x @ gate, the others x @ up, each
// over every (W1/2)-th k-step of H. With int8 weights (W = int8_t) a and b
// are the f32 sums times the columns' scales sg and su.
template <typename T, typename W, int MG>
__global__ void __launch_bounds__(w1<MG>() * 32)
swiglu_kernel(const T* __restrict__ x, const W* __restrict__ gate, const W* __restrict__ up,
              const float* __restrict__ sg, const float* __restrict__ su, T* __restrict__ h,
              int m_total, int hdim, int idim, int ldh, int vec) {
  // pass 2 may launch now: it streams `down` while this pass runs, and
  // waits for this grid to finish before it reads h
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);           // [8 MG][ldx], then reused as
  float* red = reinterpret_cast<float*>(smem);  // [W1][8 MG][TN]
  constexpr bool QUANT = std::is_same<W, int8_t>::value;
  constexpr int W1 = w1<MG>();
  constexpr int TN = WarpTile<T, W, MG>::TN;
  constexpr int Q = W1 / 2;
  const int ldx = staged_ld<T>(hdim);
  const int m0 = blockIdx.y * MG * 8;
  const int m_cnt = min(MG * 8, m_total - m0);
  const int col0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32;
  const int slice = warp % Q;
  const int n_steps = (hdim + KS - 1) / KS;
  const int n = slice < n_steps ? (n_steps - slice + Q - 1) / Q : 0;

  WarpTile<T, W, MG> tile;
  warp_product(tile, warp < Q ? gate : up, idim, idim, col0, 0, hdim, vec != 0, slice, Q, n,
               xs, ldx, [&] { stage_rows<T, MG>(xs, ldx, x, hdim, m0, m_cnt, 0, hdim); });
  __syncthreads();  // xs is consumed; its space becomes red
  tile.store(red + warp * MG * 8 * TN);
  __syncthreads();

  for (int e = threadIdx.x; e < m_cnt * TN; e += W1 * 32) {
    const int m = e / TN;
    const int c = e % TN;
    const int col = col0 + c;
    if (col >= ldh) continue;
    float val = 0.f;  // the pad columns [I, ldh) of h are written as 0
    if (col < idim) {
      float g = 0.f, u = 0.f;
#pragma unroll
      for (int w = 0; w < Q; ++w) {
        g += red[(w * MG * 8 + m) * TN + c];
        u += red[((w + Q) * MG * 8 + m) * TN + c];
      }
      if constexpr (QUANT) {
        g *= __ldg(sg + col);
        u *= __ldg(su + col);
      }
      val = g / (1.f + expf(-g)) * u;
    }
    hv::from_float(h + (size_t)(m0 + m) * ldh + col, val);
  }
}

// Pass 2: out = round_T(h @ down), I cut into splits of `chunk` rows;
// partials summed in split order by the last block of each column tile.
// With int8 weights the sum over every split is multiplied by the column's
// scale sd before the rounding.
template <typename T, typename W, int MG>
__global__ void __launch_bounds__(W2 * 32)
down_kernel(const T* __restrict__ h, const W* __restrict__ down, const float* __restrict__ sd,
            T* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
            int m_total, int hdim, int idim, int ldh, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);
  constexpr bool QUANT = std::is_same<W, int8_t>::value;
  constexpr int TN = WarpTile<T, W, MG>::TN;
  const int col0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int m0 = blockIdx.z * MG * 8;
  const int m_cnt = min(MG * 8, m_total - m0);
  const int k0 = split * chunk;
  const int k1 = min(k0 + chunk, idim);
  const int ldx = staged_ld<T>(chunk);
  const int warp = threadIdx.x / 32;
  const int n_steps = (k1 - k0 + KS - 1) / KS;
  const int n = warp < n_steps ? (n_steps - warp + W2 - 1) / W2 : 0;

  WarpTile<T, W, MG> tile;
  warp_product(tile, down, hdim, hdim, col0, k0, k1, true, warp, W2, n, xs, ldx, [&] {
    // h is pass 1's output: wait for that grid (launched as its programmatic
    // dependent, this block may have started while it ran)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    stage_rows<T, MG>(xs, ldx, h, ldh, m0, m_cnt, k0, k1 - k0);
  });
  __syncthreads();
  tile.store(red + warp * MG * 8 * TN);
  __syncthreads();

  for (int e = threadIdx.x; e < m_cnt * TN; e += W2 * 32) {
    const int m = e / TN;
    const int col = col0 + e % TN;
    if (col >= hdim) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W2; ++w) s += red[(w * MG * 8 + m) * TN + e % TN];
    const size_t row = (size_t)(m0 + m);
    if (splits == 1) {
      if constexpr (QUANT) s *= __ldg(sd + col);
      hv::from_float(out + row * hdim + col, s);
    } else {
      part[((size_t)split * m_total + row) * hdim + col] = s;
    }
  }
  if (splits == 1) return;

  int* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (!hv::last_of_group(ticket, splits)) return;
  constexpr int U = 8;  // partials loaded together, so their latencies overlap
  for (int e = threadIdx.x; e < m_cnt * TN; e += W2 * 32) {
    const int col = col0 + e % TN;
    if (col >= hdim) continue;
    const size_t row = (size_t)(m0 + e / TN);
    float s = 0.f;
    for (int s0 = 0; s0 < splits; s0 += U) {
      float pv[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        pv[u] = s0 + u < splits ? __ldcg(part + ((size_t)(s0 + u) * m_total + row) * hdim + col)
                                : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) s += pv[u];
    }
    if constexpr (QUANT) s *= __ldg(sd + col);
    hv::from_float(out + row * hdim + col, s);
  }
  hv::release_ticket(ticket);
}

template <typename T, typename W, int MG>
int launch(const void* x, const void* gate, const void* up, const void* down, const float* sg,
           const float* su, const float* sd, void* h, float* part, int* tickets, void* out,
           int m, int hdim, int idim, int ldh, int splits, int chunk, cudaStream_t stream) {
  static bool configured = false;  // the attributes are set once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(swiglu_kernel<T, W, MG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(down_kernel<T, W, MG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int W1 = w1<MG>();
  constexpr int TN = WarpTile<T, W, MG>::TN;
  const int rows = MG * 8;
  const int row_blocks = (m + rows - 1) / rows;
  const int smem1 = smem_bytes<T, MG>(staged_ld<T>(hdim), W1);
  const int smem2 = smem_bytes<T, MG>(staged_ld<T>(chunk), W2);
  if (smem1 > MAX_SMEM || smem2 > MAX_SMEM) return -2;
  dim3 grid1((idim + TN - 1) / TN, row_blocks);
  swiglu_kernel<T, W, MG><<<grid1, W1 * 32, smem1, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gate), static_cast<const W*>(up), sg, su,
      static_cast<T*>(h), m, hdim, idim, ldh, idim % 8 == 0);
  // pass 2 is pass 1's programmatic dependent: its blocks may start (and
  // stream `down`) once every pass-1 block runs; griddepcontrol.wait in it
  // holds the reads of h until pass 1 is complete
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((hdim + TN - 1) / TN, splits, row_blocks);
  cfg.blockDim = dim3(W2 * 32);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, down_kernel<T, W, MG>, static_cast<const T*>(h),
                                 static_cast<const W*>(down), sd, static_cast<T*>(out), part,
                                 tickets, m, hdim, idim, ldh, chunk);
}

// A form's instantiations: dtype 0 = float32 rows (row_groups 1 or 2) with
// weights of type WF, 1 = bfloat16 rows (row_groups 1, 2 or 5) with
// weights of type WB.
template <typename WF, typename WB>
int dispatch(int dtype, const void* x, const void* gate, const void* up, const void* down,
             const float* sg, const float* su, const float* sd, void* h, float* part,
             int* tickets, void* out, int m, int hdim, int idim, int ldh, int row_groups,
             int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (dtype == 0 && row_groups == 1) {
    rc = launch<float, WF, 1>(x, gate, up, down, sg, su, sd, h, part, tickets, out, m, hdim,
                              idim, ldh, splits, chunk, st);
  } else if (dtype == 0 && row_groups == 2) {
    rc = launch<float, WF, 2>(x, gate, up, down, sg, su, sd, h, part, tickets, out, m, hdim,
                              idim, ldh, splits, chunk, st);
  } else if (dtype == 1 && row_groups == 1) {
    rc = launch<bf16, WB, 1>(x, gate, up, down, sg, su, sd, h, part, tickets, out, m, hdim,
                             idim, ldh, splits, chunk, st);
  } else if (dtype == 1 && row_groups == 2) {
    rc = launch<bf16, WB, 2>(x, gate, up, down, sg, su, sd, h, part, tickets, out, m, hdim,
                             idim, ldh, splits, chunk, st);
  } else if (dtype == 1 && row_groups == 5) {
    rc = launch<bf16, WB, 5>(x, gate, up, down, sg, su, sd, h, part, tickets, out, m, hdim,
                             idim, ldh, splits, chunk, st);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes, read once by the wrapper to plan row blocks, the split of I
// and the scratch (the same for both forms).
int hv_mlp_gemv_cols_per_block(int dtype, int row_groups) {
  if (dtype == 1)
    return row_groups <= 2 ? WarpTile<bf16, bf16, 1>::TN : WarpTile<bf16, bf16, 5>::TN;
  return WarpTile<float, float, 1>::TN;
}
int hv_mlp_gemv_k_step() { return KS; }

// dtype: 0 = float32 (row_groups 1 or 2), 1 = bfloat16 (row_groups 1, 2
// or 5): a block holds 8 * row_groups rows of x; gate, up and down are of
// the dtype. h is (m, ldh) of the dtype, ldh = I rounded up to 8; part is
// (splits, m, hdim) f32 when splits > 1; tickets (row blocks * H / 64,)
// int32 are zero and left zero. Returns 0, -1 for an unsupported dtype or
// row_groups, -2 when the staged rows do not fit in shared memory, or the
// cudaError_t of the launches.
int hv_mlp_gemv(int dtype, const void* x, const void* gate, const void* up, const void* down,
                void* h, float* part, int* tickets, void* out, int m, int hdim, int idim,
                int ldh, int row_groups, int splits, int chunk, void* stream) {
  return dispatch<float, bf16>(dtype, x, gate, up, down, nullptr, nullptr, nullptr, h, part,
                               tickets, out, m, hdim, idim, ldh, row_groups, splits, chunk,
                               stream);
}

// The int8 form: as hv_mlp_gemv, with gate, up and down int8 (16-byte
// aligned, down's rows a multiple of 8 bytes) and their per-output-column
// f32 scales sg, su (I,) and sd (H,).
int hv_mlp_gemv_int8(int dtype, const void* x, const void* gate, const void* up,
                     const void* down, const float* sg, const float* su, const float* sd,
                     void* h, float* part, int* tickets, void* out, int m, int hdim, int idim,
                     int ldh, int row_groups, int splits, int chunk, void* stream) {
  return dispatch<int8_t, int8_t>(dtype, x, gate, up, down, sg, su, sd, h, part, tickets, out,
                                  m, hdim, idim, ldh, row_groups, splits, chunk, stream);
}

}  // extern "C"
