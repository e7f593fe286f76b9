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
//
// The int8 form, bf16 rows (`int8_mlp_kernel`, one launch a call). What
// bounds it: bytes, half the dense form's (3.9 us at 896 x 4864, 17.7 us at
// 896 x 22016), and at the backbone width the launch floor (~5 us on the
// card) as much. Reading the int8 weights with the dense form's warp tiles
// took as many memory round trips as the dense form (a row read of 64 or
// 32 bytes rather than 128), left 56 of 132 SMs idle at I 4864 in pass 1,
// and chained h through device memory into a second launch. The TPU
// kernel's decomposition (tile I, sum h_tile @ down_tile over the tiles) is
// spread over blocks instead:
//   - A chunk is 32 columns of I. Block b takes chunks b, b + G, ... (G
//     blocks), so it reduces gate and up over all of H for its columns and
//     its h is whole inside the block: h = round_T(silu(a) * b) goes to
//     shared memory (`hs`) and never to device memory (`int8_mlp_kernel`,
//     the loop over the block's chunks). The block multiplies it by the
//     chunk's 32 rows of `down` into its (M, H) f32 partial, held in
//     registers across its chunks: QT 32-column tiles of H a warp (the
//     instantiation: QT 4 up to H 1024, 8 up to 2048).
//   - The weights reach shared memory by the TMA (`request`): gate and up
//     through 2-D tensor maps, in eight pieces of H a chunk, one a warp, each
//     on its own mbarrier, so that a warp multiplies its piece as soon as it
//     lands; down's 32 rows by 1-D bulk copies on a ninth barrier, waited on
//     only for the down product. The wrapper builds the tensor maps once per
//     weight tensor. All of a chunk's bytes are requested at once: with one
//     chunk a block (I 4864: 152 blocks, two an SM) every byte of the call
//     is in flight in the first round trip; with more (I 22016) two blocks
//     an SM each walk their chunks. The wrapper plans the grid from the
//     shapes and from the clusters the card holds at once (ops/mlp_gemv.py,
//     `plan_int8`): all blocks run in one wave.
//   - Where the TMA's 16-byte rules fail (I or H not a multiple of 16: I
//     4863, I 100) the same kernel fills the same stages with plain loads
//     through registers (byte loads for gate and up, whose rows may start
//     at any byte); it never gives way to the plain version.
//   - ldmatrix .trans reads a 16-row x 32-column weight tile so that each
//     register holds two rows of two adjacent columns (the TMA's 32-byte
//     swizzle and down's padded rows keep the reads on distinct banks); the
//     int8 values become bf16 exactly in registers, two a bf16x2
//     subtraction (`hv::int8x4_to_bf16x2`), straight into the A fragments
//     of mma.sync m16n8k16 with the weight columns as the 16-row operand,
//     as in the dense form. The 8 warps split H's k-steps for gate and up
//     (sums added in warp order) and H's 32-column tiles for down.
//   - The cross-block sum stays deterministic: the blocks of a thread block
//     cluster (up to 8) put their partials in shared memory, and block r of
//     the cluster sums column range r over the cluster's blocks in rank
//     order through distributed shared memory. With one cluster that sum,
//     times s_d and rounded, is the output. Otherwise each cluster writes
//     its f32 partial, and for each range the last cluster to arrive
//     (integer ticket, `hv::last_of_group`) sums the clusters' partials in
//     a fixed order, applies s_d and rounds once. No float atomics: two
//     calls are bit-equal.
//   - Rows: 8, 16 or 24 a block (row groups 1-3; 24 only at QT 4, where
//     the warps' partials leave the registers for them); more take further
//     row blocks (grid y), each reading the weights again (from L2 when
//     they run together). A chunk's stage holds 96 bytes per row of H, so a
//     block's shared memory bounds H: 16 rows a block up to H 1664, 8 rows
//     up to H 1920 (the wrapper plans 8-row blocks past 1664 and raises
//     past 1920).
// f32 rows take the int8 instantiation of the two passes above (the weight
// type a template parameter; a lane loads 2 bytes a row and turns them into
// f32 in registers; the scales multiply the f32 sums where pass 1 applies
// silu and where pass 2 writes its output). Every shape the port serves is
// bf16.
//
// Plain C interface (bound with ctypes): the wrapper allocates h (the
// two-pass forms only), the partials, the output and the zeroed ticket
// buffer (reused across calls on one stream), passes PyTorch's current
// stream, and raises on a non-zero return (a refused launch).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <string.h>

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


// ---------------------------------------------------------------------------
// The int8 form, bf16 rows: one launch a call (the note at the top).

constexpr int QC = 32;  // columns of I a chunk
constexpr int QW = 8;   // warps of a block
// QT, a template parameter: the 32-column tiles of H a warp takes in the
// down product, whose partial it holds in registers; 4 up to H 1024, 8 up
// to 2048 (the TMA's 256-row box bounds H there too; shared memory, as
// `int8_smem_bytes` counts it, bounds it lower still)
constexpr int QT_MAX = 8;
__host__ __device__ constexpr int qt_for(int hdim) { return hdim <= QW * 4 * 32 ? 4 : QT_MAX; }
constexpr int HS_LD = QC + 8;         // row stride of h (80 bytes: the mma reads hit 32 banks)
constexpr int RED_LD = QC + 8;        // row stride of the warps' f32 sums (2-way bank conflicts)

// Byte offsets in a block's dynamic shared memory, from a 1024-byte
// aligned base (ops/mlp_gemv.py `int8_smem_bytes` mirrors `total`). Each
// of the `stages` stages holds a chunk: gate [hpad][32] and up [hpad][32],
// in QW pieces of rb rows, warp w's k-steps (a box of the tensor map each,
// on barrier w of the stage; the TMA's 32-byte swizzle swaps the 16-byte
// halves of rows 4-7 of every 8, so that ldmatrix reads 8 rows from 8
// distinct bank groups; once multiplied, the warps' f32 sums of gate and
// up overlay them, so the pair takes at least that room), then down's 32
// rows at a stride of dld bytes (dld = 16 mod 128: 8 rows, 8 bank groups).
// Then x's rows [8 MG][ldx] bf16, h [8 MG][HS_LD] bf16, the block's range
// of s_d, and QW + 1 mbarriers a stage. After the last chunk the block's
// partial [8 MG][H] f32 overlays stage 0.
struct Int8Layout {
  int rb, hpad, dld, ldx, gu, stage, xs, hs, sds, bars, total;
  __host__ __device__ Int8Layout(int hdim, int mg, int stages) {
    rb = KS * ((hdim + KS * QW - 1) / (KS * QW));
    hpad = QW * rb;
    dld = round_up(hdim, 128) + 16;
    ldx = staged_ld<bf16>(hdim);
    const int red = QW * 2 * 8 * mg * RED_LD * 4;
    gu = 2 * hpad * QC > red ? 2 * hpad * QC : red;
    stage = round_up(gu + QC * dld, 1024);
    xs = stages * stage;
    hs = xs + 8 * mg * ldx * 2;
    sds = hs + 8 * mg * HS_LD * 2;
    bars = round_up(sds + hdim * 4, 8);
    total = bars + stages * (QW + 1) * 8 + 1024;  // + the room to align the base
  }
};

// One block: 8 MG rows of x (grid y) against chunks blockIdx.x,
// blockIdx.x + gridDim.x, ... of I; then the cluster's and the clusters'
// sums. `tma` 0 (I or H not a multiple of 16): the stages are filled by
// plain loads, and the tensor maps are not read.
template <int MG, int QT>
__global__ void __launch_bounds__(QW * 32, MG == 1 && QT == 4 ? 2 : 1)
int8_mlp_kernel(const __grid_constant__ CUtensorMap tm_gate,
                const __grid_constant__ CUtensorMap tm_up, const bf16* __restrict__ x,
                const int8_t* __restrict__ gate, const int8_t* __restrict__ up,
                const int8_t* __restrict__ down, const float* __restrict__ sg,
                const float* __restrict__ su, const float* __restrict__ sd,
                bf16* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
                int m_total, int hdim, int idim, int stages, int tma) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hv::smem_u32(smem_raw) & 1023)) & 1023);
  const Int8Layout L(hdim, MG, stages);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  float* sds = reinterpret_cast<float*>(smem + L.sds);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // [stage][QW pieces, down]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = blockIdx.y * MG * 8;
  const int m_cnt = min(MG * 8, m_total - m0);
  const int n_chunks = (idim + QC - 1) / QC;
  const int n_mine = (int)blockIdx.x < n_chunks
                         ? (n_chunks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
                         : 0;
  const int k_steps = (hdim + KS - 1) / KS;
  const int ks0 = warp * (L.rb / KS);  // this warp's k-steps of H: [ks0, ks1)
  const int ks1 = min(k_steps, ks0 + L.rb / KS);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int span = round_up((hdim + cl - 1) / cl, 4);  // this block's columns of the sums
  const int lo = rank * span;
  const int n4 = lo < hdim ? (min(hdim, lo + span) - lo) / 4 : 0;

  // A weight tile of 16 rows (a k-step) x 32 columns is read by one
  // ldmatrix.x4.trans as four 8x8 b16 matrices (rows 0-7 / 8-15 x bytes
  // 0-15 / 16-31); lane l gives row (l / 8 % 2) * 8 + l % 8, half l / 16.
  // Lane (g, t) then holds, of each, the bytes of columns 2g, 2g + 1 at rows
  // 2t, 2t + 1: converted, the A fragments of the mma whose rows g and g + 8
  // are columns 2g and 2g + 1 (of 16j.., j the matrix pair).
  const int lrow = (lane >> 3 & 1) * 8 + (lane & 7);
  const int lhalf = lane >> 4;
  const int gu_lane = lrow * QC + ((lhalf ^ (lrow >> 2 & 1)) << 4);  // swizzled
  const int dn_lane = lrow * L.dld + (lhalf << 4);

  if (tma && threadIdx.x == 0) {
    for (int i = 0; i < (QW + 1) * stages; ++i) hv::mbar_init(bars + i, 1);
    hv::mbar_init_fence();
  }
  __syncthreads();

  // Warp 0 requests the block's i-th chunk into stage i % stages: each
  // warp's piece of gate and up as a box of the tensor maps on that warp's
  // barrier (out-of-range rows and columns arrive as zeros), down's rows by
  // one bulk copy each on the stage's last barrier.
  const void* tmap_g = &tm_gate;
  const void* tmap_u = &tm_up;
  auto request = [&](int i) {
    const int c0 = ((int)blockIdx.x + i * (int)gridDim.x) * QC;
    unsigned char* st = smem + (i % stages) * L.stage;
    uint64_t* bar = bars + (QW + 1) * (i % stages);
    const int n_rows = min(QC, idim - c0);
    if (lane == 0) {
      for (int w = 0; w < QW && w * L.rb < hdim; ++w) {
        hv::mbar_expect_tx(bar + w, 2 * L.rb * QC);
        hv::tma_load_2d(st + w * L.rb * QC, tmap_g, c0, w * L.rb, bar + w);
        hv::tma_load_2d(st + (L.hpad + w * L.rb) * QC, tmap_u, c0, w * L.rb, bar + w);
      }
      hv::mbar_expect_tx(bar + QW, n_rows * hdim);
    }
    __syncwarp();
    if (lane < n_rows)
      hv::bulk_load(st + L.gu + lane * L.dld, down + (size_t)(c0 + lane) * hdim, hdim, bar + QW);
  };
  if (tma && warp == 0)
    for (int i = 0; i < min(stages, n_mine); ++i) request(i);
  // Scales are read a chunk ahead (each thread's h column is threadIdx.x
  // % 32 in every chunk) and s_d of this block's output range at the start,
  // so that no scale read waits on device memory after the weights.
  float sg_next = 0.f, su_next = 0.f;
  auto fetch_scales = [&](int i) {
    const int col = ((int)blockIdx.x + i * (int)gridDim.x) * QC + (int)threadIdx.x % QC;
    sg_next = col < idim ? __ldg(sg + col) : 0.f;
    su_next = col < idim ? __ldg(su + col) : 0.f;
  };
  if (n_mine > 0) fetch_scales(0);
  for (int e = threadIdx.x; e < 4 * n4; e += QW * 32) sds[e] = __ldg(sd + lo + e);
  // x's rows, staged while the first chunks are in flight
  stage_rows<bf16, MG>(xs, L.ldx, x, hdim, m0, m_cnt, 0, hdim);

  float accd[QT][MG][2][4] = {};  // the block's partial of out: tiles warp + 8 nt of H
  for (int i = 0; i < n_mine; ++i) {
    const int c0 = ((int)blockIdx.x + i * (int)gridDim.x) * QC;
    unsigned char* st = smem + (i % stages) * L.stage;
    uint64_t* bar = bars + (QW + 1) * (i % stages);
    const uint32_t parity = (i / stages) & 1;
    const float sgc = sg_next, suc = su_next;
    if (i + 1 < n_mine) fetch_scales(i + 1);
    if (tma) {
      if (ks0 < ks1) hv::mbar_wait(bar + warp, parity);
    } else {
      // plain loads: gate and up a 4-byte word at a time from single
      // bytes (their rows start at any byte), zero outside H x I; down's
      // rows 8 bytes at a time
      for (int e = threadIdx.x; e < L.hpad * (QC / 4); e += QW * 32) {
        const int r = e / (QC / 4);
        const int col = c0 + 4 * (e % (QC / 4));
        uint32_t wg = 0, wu = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (r < hdim && col + b < idim) {
            const size_t o = (size_t)r * idim + col + b;
            wg |= (uint32_t)(uint8_t)gate[o] << (8 * b);
            wu |= (uint32_t)(uint8_t)up[o] << (8 * b);
          }
        }
        const int wd = e % (QC / 4);  // the TMA's 32-byte swizzle, as ldmatrix reads it
        const int o = r * QC + (((wd >> 2) ^ (r >> 2 & 1)) << 4) + 4 * (wd & 3);
        *reinterpret_cast<uint32_t*>(st + o) = wg;
        *reinterpret_cast<uint32_t*>(st + L.hpad * QC + o) = wu;
      }
      const int n8 = hdim / 8;
      for (int e = threadIdx.x; e < QC * n8; e += QW * 32) {
        const int r = e / n8;
        const uint2 v = c0 + r < idim
                            ? __ldg(reinterpret_cast<const uint2*>(down + (size_t)(c0 + r) * hdim) +
                                    e % n8)
                            : make_uint2(0, 0);
        *reinterpret_cast<uint2*>(st + L.gu + r * L.dld + 8 * (e % n8)) = v;
      }
      __syncthreads();
    }

    // a = x @ gate and b = x @ up for the chunk's 32 columns; warp w takes
    // its piece of H, as soon as that piece has landed
    float acc[2][MG][2][4] = {};
#pragma unroll 2
    for (int ks = ks0; ks < ks1; ++ks) {
      uint32_t q[2][4];
      hv::ldsm_x4_trans(q[0], st + ks * KS * QC + gu_lane);
      hv::ldsm_x4_trans(q[1], st + (L.hpad + ks * KS) * QC + gu_lane);
      uint32_t b0[MG], b1[MG];
#pragma unroll
      for (int gr = 0; gr < MG; ++gr) {
        const bf16* xp = xs + (gr * 8 + g) * L.ldx + ks * KS + 2 * t;
        b0[gr] = *reinterpret_cast<const uint32_t*>(xp);
        b1[gr] = *reinterpret_cast<const uint32_t*>(xp + 8);
      }
#pragma unroll
      for (int mat = 0; mat < 2; ++mat)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t a0, a1, a2, a3;
          hv::int8x4_to_bf16x2(q[mat][2 * j], a0, a1);
          hv::int8x4_to_bf16x2(q[mat][2 * j + 1], a2, a3);
#pragma unroll
          for (int gr = 0; gr < MG; ++gr)
            hv::mma_bf16_16816(acc[mat][gr][j], a0, a1, a2, a3, b0[gr], b1[gr]);
        }
    }
    __syncthreads();  // gate and up are read: the warps' sums overlay them
    float* red = reinterpret_cast<float*>(st);  // [warp][gate, up][8 MG][RED_LD]
#pragma unroll
    for (int mat = 0; mat < 2; ++mat)
#pragma unroll
      for (int gr = 0; gr < MG; ++gr)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[((warp * 2 + mat) * 8 * MG + gr * 8 + 2 * t + (c & 1)) * RED_LD + 16 * j + 2 * g +
                (c >> 1)] = acc[mat][gr][j][c];
    __syncthreads();
    // h = round_T(silu(a) * b), the sums added in warp order; 0 past I
    for (int e = threadIdx.x; e < MG * 8 * QC; e += QW * 32) {
      const int m = e / QC;
      const int c = e % QC;
      const int col = c0 + c;
      float v = 0.f;
      if (col < idim) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int w = 0; w < QW; ++w) {
          a += red[((w * 2) * 8 * MG + m) * RED_LD + c];
          b += red[((w * 2 + 1) * 8 * MG + m) * RED_LD + c];
        }
        a *= sgc;
        b *= suc;
        v = a / (1.f + expf(-a)) * b;
      }
      hs[m * HS_LD + c] = __float2bfloat16(v);
    }
    __syncthreads();

    // out += h @ down over the chunk's 32 rows (rows past I meet h = 0)
    if (tma) hv::mbar_wait(bar + QW, parity);
    const unsigned char* dp = st + L.gu + dn_lane;
#pragma unroll
    for (int kk = 0; kk < QC; kk += KS) {
      uint32_t b0[MG], b1[MG];
#pragma unroll
      for (int gr = 0; gr < MG; ++gr) {
        const bf16* hp = hs + (gr * 8 + g) * HS_LD + kk + 2 * t;
        b0[gr] = *reinterpret_cast<const uint32_t*>(hp);
        b1[gr] = *reinterpret_cast<const uint32_t*>(hp + 8);
      }
#pragma unroll
      for (int nt = 0; nt < QT; ++nt) {
        const int tile = warp + nt * QW;
        if (tile * 32 < hdim) {
          uint32_t q[4];
          hv::ldsm_x4_trans(q, dp + kk * L.dld + tile * 32);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t a0, a1, a2, a3;
            hv::int8x4_to_bf16x2(q[2 * j], a0, a1);
            hv::int8x4_to_bf16x2(q[2 * j + 1], a2, a3);
#pragma unroll
            for (int gr = 0; gr < MG; ++gr)
              hv::mma_bf16_16816(accd[nt][gr][j], a0, a1, a2, a3, b0[gr], b1[gr]);
          }
        }
      }
    }
    // the stage is consumed; order this block's writes to it before the
    // TMA's next ones, then refill it
    hv::fence_proxy_async();
    __syncthreads();
    if (tma && warp == 0 && i + stages < n_mine) request(i + stages);
  }

  // The block's partial into stage 0 (every copy has landed and been read),
  // its rows of x only.
  float* P = reinterpret_cast<float*>(smem);  // [8 MG][H]
#pragma unroll
  for (int nt = 0; nt < QT; ++nt)
#pragma unroll
    for (int gr = 0; gr < MG; ++gr)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = (warp + nt * QW) * 32 + 16 * j + 2 * g + (c >> 1);
          const int row = gr * 8 + 2 * t + (c & 1);
          if (col < hdim && row < m_cnt) P[row * hdim + col] = accd[nt][gr][j][c];
        }

  // Block `rank` of the cluster sums column range `rank` over the
  // cluster's blocks, in rank order, through distributed shared memory.
  cluster.sync();
  const int n_clu = (int)gridDim.x / cl;
  auto write_out = [&](size_t row, int col, float4 s) {
    const float4 sc = *reinterpret_cast<const float4*>(sds + (col - lo));
    const __nv_bfloat162 lo2 = __floats2bfloat162_rn(s.x * sc.x, s.y * sc.y);
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(s.z * sc.z, s.w * sc.w);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo2);
    v.y = *reinterpret_cast<const uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(out + row * hdim + col) = v;
  };
  auto add4 = [](float4& s, float4 v) {
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  };
  constexpr int U = 8;  // partials loaded together, so their latencies overlap
  for (int e = threadIdx.x; e < m_cnt * n4; e += QW * 32) {
    const int m = e / n4;
    const int col = lo + 4 * (e % n4);
    float4 v[U];
#pragma unroll
    for (int q = 0; q < U; ++q)
      v[q] = q < cl ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(P + m * hdim + col, q))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < U; ++q) add4(s, v[q]);
    const size_t row = (size_t)(m0 + m);
    if (n_clu == 1)
      write_out(row, col, s);
    else
      *reinterpret_cast<float4*>(part + ((size_t)(blockIdx.x / cl) * m_total + row) * hdim +
                                 col) = s;
  }

  // The last cluster to arrive for this range sums the clusters' partials:
  // T threads an element (a power of two that keeps the block's threads
  // busy), thread j of them over clusters j, j + T, ... in order, then the
  // T sums over a fixed shuffle tree. The order is fixed, so two calls are
  // bit-equal.
  int* ticket = tickets + blockIdx.y * cl + rank;
  if (n_clu > 1 && hv::last_of_group(ticket, n_clu)) {
    const int n_el = m_cnt * n4;
    int T = 1;
    while (T < 32 && n_el * T * 2 <= QW * 32) T *= 2;
    const int j = threadIdx.x % T;
    for (int base = 0; base < n_el; base += QW * 32 / T) {
      const int e = base + threadIdx.x / T;
      const bool valid = e < n_el;
      const size_t row = (size_t)(m0 + (valid ? e / n4 : 0));
      const int col = lo + 4 * (valid ? e % n4 : 0);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c0 = j; valid && c0 < n_clu; c0 += T * U) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u * T;
          v[u] = c < n_clu ? __ldcg(reinterpret_cast<const float4*>(
                                 part + ((size_t)c * m_total + row) * hdim + col))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) add4(s, v[u]);
      }
      for (int o = 1; o < T; o <<= 1) {
        s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
        s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
        s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
        s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
      }
      if (valid && j == 0) write_out(row, col, s);
    }
    hv::release_ticket(ticket);
  }
  cluster.sync();  // no block leaves while another may read its partial
}

template <int MG, int QT>
cudaError_t configure_int8() {
  static bool configured = false;  // set once per instantiation
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_mlp_kernel<MG, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  configured = err == cudaSuccess;
  return err;
}

cudaLaunchConfig_t int8_config(dim3 grid, int smem, int cluster, cudaLaunchAttribute* attr,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(QW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MG, int QT>
int launch_int8(const CUtensorMap& tg, const CUtensorMap& tu, const void* x, const void* gate,
                const void* up, const void* down, const float* sg, const float* su,
                const float* sd, float* part, int* tickets, void* out, int m, int hdim,
                int idim, int blocks, int cluster, int stages, int smem, int tma,
                cudaStream_t stream) {
  if (smem != Int8Layout(hdim, MG, stages).total || smem > MAX_SMEM || hdim > QW * QT * 32 ||
      blocks % cluster != 0)
    return -2;
  cudaError_t err = configure_int8<MG, QT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      int8_config(dim3(blocks, (m + MG * 8 - 1) / (MG * 8)), smem, cluster, &attr, stream);
  err = cudaLaunchKernelEx(&cfg, int8_mlp_kernel<MG, QT>, tg, tu, static_cast<const bf16*>(x),
                           static_cast<const int8_t*>(gate), static_cast<const int8_t*>(up),
                           static_cast<const int8_t*>(down), sg, su, sd, static_cast<bf16*>(out),
                           part, tickets, m, hdim, idim, stages, tma);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int MG, int QT>
int resident_int8(int smem, int cluster) {
  cudaError_t err = configure_int8<MG, QT>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = int8_config(dim3(cluster), smem, cluster, &attr, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)int8_mlp_kernel<MG, QT>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
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

// The int8 form, f32 rows (dtype 0; row_groups 1 or 2): as hv_mlp_gemv,
// two passes, with gate, up and down int8 (16-byte aligned, down's rows a
// multiple of 8 bytes) and their per-output-column f32 scales sg, su (I,)
// and sd (H,).
int hv_mlp_gemv_int8_f32(int dtype, const void* x, const void* gate, const void* up,
                         const void* down, const float* sg, const float* su, const float* sd,
                         void* h, float* part, int* tickets, void* out, int m, int hdim,
                         int idim, int ldh, int row_groups, int splits, int chunk,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (dtype == 0 && row_groups == 1)
    rc = launch<float, int8_t, 1>(x, gate, up, down, sg, su, sd, h, part, tickets, out, m, hdim,
                                  idim, ldh, splits, chunk, st);
  else if (dtype == 0 && row_groups == 2)
    rc = launch<float, int8_t, 2>(x, gate, up, down, sg, su, sd, h, part, tickets, out, m, hdim,
                                  idim, ldh, splits, chunk, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The TMA descriptor of an int8 weight (rows, cols) row-major, as the int8
// form reads gate and up: boxes of 32 columns x Int8Layout::rb rows, the
// 32-byte swizzle, zeros out of range. Written into `out` (128 bytes); cols must be a multiple of
// 16 and `w` 16-byte aligned. Returns 0 or the driver's error code (-3: no
// entry point).
int hv_mlp_gemv_int8_tensor_map(void* out, const void* w, int rows, int cols) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) return -3;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)QC, (cuuint32_t)Int8Layout(rows, 1, 1).rb};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  memcpy(out, &map, sizeof(map));
  return 0;
}

// Thread block clusters of `cluster` blocks of the int8 form (row_groups 1
// or 2, or 3 up to H 1024) at H `hdim` with `smem` bytes of dynamic shared
// memory that fit on the card at once (cudaOccupancyMaxActiveClusters), or
// minus the error.
int hv_mlp_gemv_int8_resident(int row_groups, int hdim, int smem, int cluster) {
  const bool wide = qt_for(hdim) == QT_MAX;
  if (row_groups == 1)
    return wide ? resident_int8<1, QT_MAX>(smem, cluster) : resident_int8<1, 4>(smem, cluster);
  if (row_groups == 2)
    return wide ? resident_int8<2, QT_MAX>(smem, cluster) : resident_int8<2, 4>(smem, cluster);
  if (row_groups == 3 && !wide) return resident_int8<3, 4>(smem, cluster);
  return -1;
}

// The int8 form, bf16 rows: one launch. x (m, hdim) bf16; gate and up
// (hdim, idim), down (idim, hdim) int8, 16-byte aligned; sg, su (idim,), sd
// (hdim,) f32; out (m, hdim) bf16. A block holds 8 * row_groups rows (row
// groups 1 or 2, or 3 up to H 1024); `blocks` blocks in clusters of
// `cluster` (a divisor) walk the chunks through `stages` stages of `smem`
// bytes (Int8Layout's total). part is
// (blocks / cluster, m, hdim) f32 when there is more than one cluster;
// tickets (row blocks * cluster,) int32 are zero and left zero. With tma,
// tmap_gate and tmap_up are gate's and up's descriptors
// (hv_mlp_gemv_int8_tensor_map); without, they may be null. Returns 0, -1
// for an unsupported row_groups, -2 for a plan the kernel does not take
// (hdim above 2048, smem not the layout's), or the cudaError_t of the launch.
int hv_mlp_gemv_int8(const void* tmap_gate, const void* tmap_up, const void* x, const void* gate,
                     const void* up, const void* down, const float* sg, const float* su,
                     const float* sd, float* part, int* tickets, void* out, int m, int hdim,
                     int idim, int row_groups, int blocks, int cluster, int stages, int smem,
                     int tma, void* stream) {
  CUtensorMap tg, tu;
  memset(&tg, 0, sizeof(tg));
  memset(&tu, 0, sizeof(tu));
  if (tma) {
    memcpy(&tg, tmap_gate, sizeof(tg));
    memcpy(&tu, tmap_up, sizeof(tu));
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = qt_for(hdim) == QT_MAX;
#define HV_LAUNCH_INT8(MG, QT)                                                                \
  launch_int8<MG, QT>(tg, tu, x, gate, up, down, sg, su, sd, part, tickets, out, m, hdim, idim, \
                      blocks, cluster, stages, smem, tma, st)
  if (row_groups == 1) return wide ? HV_LAUNCH_INT8(1, QT_MAX) : HV_LAUNCH_INT8(1, 4);
  if (row_groups == 2) return wide ? HV_LAUNCH_INT8(2, QT_MAX) : HV_LAUNCH_INT8(2, 4);
  if (row_groups == 3 && !wide) return HV_LAUNCH_INT8(3, 4);
#undef HV_LAUNCH_INT8
  return -1;
}

}  // extern "C"
