// GQA decode attention against a preallocated KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `pallas_decode_attention` (body
// `_decode_attn_kernel`) of flowmirror_hydravox_tpu/ops/pallas_attention.py.
// It computes what that kernel computes, under the batched contract of
// flowmirror_hydravox_tpu/ops/attention.py::decode_attention:
//
//   q (B, T, Hq, D), k/v cache (B, S_max, Hkv, D), cache_len (B,) int32,
//   out[b, t, h] = softmax_s(q[b,t,h] . k[b,s,h/G] * D^-0.5) @ v[b,s,h/G]
//   over key positions s <= cache_len[b] + t (and s < S_max), G = Hq / Hkv.
//
// What bounds it on the card. By bytes, the least time is tiny: a decode
// step reads the query block and the valid K/V rows once (at the serving
// shape, 14 rows x 257 keys x 64 dims, ~130 KB: 41 ns at 3.35 TB/s), far
// below what one launch costs. So what bounds it in practice is latency:
// the launch, one round trip to memory for the K/V tiles, the serial chain
// of arithmetic inside a block, and the merge of the splits of S.
//
// Design, aimed at the shortest chain rather than throughput:
//   - A block owns one (row tile, batch row b, KV head h, split of S). A row
//     is one (token t, query head g of the KV group), r = t * G + g; a row
//     tile holds RT = 4 rows (7 rows at T 1 are two tiles, 14 at T 2 four),
//     so that the tiles of one KV head spread over as many SMs: measured on
//     the H100, the arithmetic of one SM, not memory, bounds a block.
//   - The block's 4 warps are key streams: each round the block takes 4
//     tiles of TK = 32 keys (128 keys), warp j the tile j. For the scores a
//     lane owns one key (held in registers) and computes its dot products
//     with the tile's 4 rows (8 independent FMA chains, q broadcast from
//     shared memory); the softmax max is a warp shuffle per row; for P.V a
//     lane owns two of the D dims of the 4 rows (at D 16, of one row) and
//     walks the tile's 32 keys. That is ~600 FMAs a lane per key tile,
//     against ~16k dependent FMAs per thread in the one-row-per-thread
//     design this replaces. The 4 streams' (m, l, acc) are combined in
//     shared memory, in stream order.
//   - K/V tiles stream into shared memory with cp.async, two rounds in
//     flight, in the cache's own dtype (rows padded by 16 bytes so that
//     lanes reading different keys hit different banks); scores and
//     accumulators are f32, the softmax online in the log2 domain (q
//     prescaled by D^-0.5 * log2(e)). The first round and q are requested
//     before cache_len arrives, so the block waits for one memory round
//     trip, not two.
//   - Splits of S: the wrapper cuts S_max into chunks of whole rounds until
//     B * Hkv * row tiles * splits approaches one wave of the 132 SMs
//     (at the serving shape, 4 splits of 128 keys); only the splits below
//     cache_len[b] + t_last + 1 (t_last the tile's last token) do any
//     work, the others exit at once.
//   - The merge is in the same launch. With one working split the block
//     writes the normalised output; otherwise it writes its (m, l, acc)
//     partial, and the last block of its (b, h, row tile), elected by an
//     integer ticket, merges the partials in split order
//     (loading 8 splits at a time, so their latencies overlap), writes the
//     output and resets the ticket to 0 for the next call. No float
//     atomics: the same inputs give bit-equal outputs.
//   - CUDA cores, not tensor cores, in both dtypes: with 4-row tiles an
//     SM's share is a few hundred FMAs a lane per key tile, and the same
//     code keeps f32 exact (no TF32). Tensor-core tiles (mma.sync) would
//     cut that share further for long caches and the prefill.
//
// Plain C interface (bound with ctypes): the wrapper allocates the output,
// the partials and the zeroed ticket buffer (reused across calls on one
// stream), passes the current stream, and raises on a non-zero return (a
// refused launch).

#include "common.cuh"

namespace {

using hv::Vec;

constexpr int RT = 4;      // query rows per block (row tile); every warp works on all of them
constexpr int NW = 4;      // warps per block: key streams, warp w takes tiles w, w + NW, ...
constexpr int TK = 32;     // keys per tile: one per lane
constexpr int STAGES = 2;  // rounds of NW tiles in flight

template <typename T, int D>
struct Layout {
  static constexpr int VN = Vec<T>::N;
  static constexpr int KROW = D + VN;  // elements per padded K/V row
  static constexpr int CPR = D / VN;   // 16-byte chunks per K/V row
  static constexpr size_t kv_bytes = (size_t)STAGES * NW * 2 * TK * KROW * sizeof(T);
  static constexpr size_t q_bytes = (size_t)RT * D * sizeof(float);
  static constexpr size_t p_bytes = (size_t)NW * TK * RT * sizeof(float);
  static constexpr size_t w_bytes = (size_t)NW * RT * (D + 2) * sizeof(float);
  static constexpr size_t lim_bytes = (size_t)RT * sizeof(int);
  static constexpr size_t total = kv_bytes + q_bytes + p_bytes + w_bytes + lim_bytes;
  static_assert(D % 2 == 0 && D <= 64 && 32 % (D / 2) == 0, "lanes split D in pairs");
  static_assert(RT == 4 && RT % (32 / (D / 2)) == 0, "4 rows split evenly over a warp");
};

// a[i] for a run-time i < N, without local memory
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float x = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j) x = i == j ? a[j] : x;
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ cache_len,
                   T* __restrict__ out, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int* __restrict__ tickets, int n_tok,
                   int hq, int hkv, int s_max, int chunk, float scale_log2) {
  using L = Layout<T, D>;
  constexpr int VN = L::VN;
  constexpr int LPR = D / 2;    // lanes per row in P.V, two dims each
  constexpr int RG = 32 / LPR;  // rows a warp covers at once in P.V (1 at D 64, 4 at D 16)
  constexpr int RPL = RT / RG;  // rows per lane in P.V

  extern __shared__ __align__(16) unsigned char smem[];
  T* kv_s = reinterpret_cast<T*>(smem);                       // [STAGES][NW][2][TK][KROW]
  float* q_s = reinterpret_cast<float*>(smem + L::kv_bytes);  // [RT][D]
  float* p_s = q_s + RT * D;                                  // [NW][TK][RT]
  float* wacc_s = p_s + NW * TK * RT;                         // [NW][RT][D]
  float* wm_s = wacc_s + NW * RT * D;                         // [NW][RT]
  float* wl_s = wm_s + NW * RT;                               // [NW][RT]
  int* lim_s = reinterpret_cast<int*>(wl_s + NW * RT);        // [RT]

  const int group = hq / hkv;
  const int rows_total = group * n_tok;
  const int row_tiles = gridDim.x;
  const int splits = gridDim.z;
  const int tile = blockIdx.x;
  const int b = blockIdx.y / hkv;
  const int h = blockIdx.y % hkv;
  const int split = blockIdx.z;
  const int row0 = tile * RT;
  const int nrows = min(RT, rows_total - row0);
  const int s_begin = split * chunk;
  const int s_stop = min(s_begin + chunk, s_max);  // the split's keys, before cache_len
  const int clen = __ldg(cache_len + b);           // in flight with the loads below

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // the NW tiles of round i (keys [s0, lim), zero-filled past lim) into
  // `stage`
  auto load_round = [&](int i, int stage, int lim) {
    for (int c = tid; c < NW * TK * L::CPR; c += NW * 32) {
      const int st = c / (TK * L::CPR);
      const int j = c / L::CPR % TK;
      const int part = (c % L::CPR) * VN;
      const int s = s_begin + (i * NW + st) * TK + j;
      const bool ok = s < lim;
      const size_t off = ((size_t)(b * s_max + (ok ? s : s_begin)) * hkv + h) * D + part;
      T* ks = kv_s + (size_t)(stage * NW + st) * 2 * TK * L::KROW;
      hv::cp_async16(ks + j * L::KROW + part, k + off, ok);
      hv::cp_async16(ks + (TK + j) * L::KROW + part, v + off, ok);
    }
  };

  // The first round and q are in flight before cache_len is known: the
  // round is loaded to the end of the split (keys past cache_len are masked
  // below), so no load waits on another.
  load_round(0, 0, s_stop);
  hv::cp_async_commit();

  for (int e = tid * VN; e < RT * D; e += NW * 32 * VN) {
    const int r = e / D;
    const int d = e % D;
    float tmp[VN];
    if (r < nrows) {
      const int rr = row0 + r;
      const int head = h * group + rr % group;
      Vec<T>::load(q + ((size_t)(b * n_tok + rr / group) * hq + head) * D + d, tmp);
#pragma unroll
      for (int i = 0; i < VN; ++i) tmp[i] *= scale_log2;
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) q_s[e + i] = tmp[i];
  }

  const int t_last = (row0 + nrows - 1) / group;
  const int kv_end = min(clen + t_last + 1, s_max);
  const int active = (kv_end + chunk - 1) / chunk;  // splits that hold keys
  if (split >= active) {                            // uniform over the block
    hv::cp_async_wait<0>();
    return;
  }
  const int s_end = min(s_begin + chunk, kv_end);
  const int n_tiles = (s_end - s_begin + TK - 1) / TK;
  const int n_rounds = (n_tiles + NW - 1) / NW;
  if (tid < RT) lim_s[tid] = tid < nrows ? clen + (row0 + tid) / group : -1;

  // in P.V this lane's rows rg + RG * i and dims d0, d0 + 1
  const int rg = lane / LPR;
  const int d0 = (lane % LPR) * 2;
  float* my_p = p_s + warp * TK * RT;

  float m[RT], l[RT], acc[RPL][2];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int i = 0; i < n_rounds; ++i) {
    hv::cp_async_wait<0>();
    __syncthreads();  // round i is in; every warp is done with round i - 1
    if (i + 1 < n_rounds) load_round(i + 1, (i + 1) % STAGES, s_end);  // in flight meanwhile
    hv::cp_async_commit();
    const int t = i * NW + warp;  // this warp's tile
    if (t >= n_tiles) continue;
    const T* ks = kv_s + (size_t)((i % STAGES) * NW + warp) * 2 * TK * L::KROW;
    const T* vs = ks + TK * L::KROW;
    const int s = s_begin + t * TK + lane;  // this lane's key

    // scores of this lane's key against the tile's rows
    float kf[D];
#pragma unroll
    for (int dc = 0; dc < D; dc += VN) Vec<T>::load(ks + lane * L::KROW + dc, kf + dc);
    float part[RT][2] = {};
#pragma unroll
    for (int d4 = 0; d4 < D; d4 += 4) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(q_s + r * D + d4);
        float& a = part[r][(d4 / 4) & 1];
        a = fmaf(qq.x, kf[d4], a);
        a = fmaf(qq.y, kf[d4 + 1], a);
        a = fmaf(qq.z, kf[d4 + 2], a);
        a = fmaf(qq.w, kf[d4 + 3], a);
      }
    }

    // online softmax: every lane holds each row's running max (warp
    // uniform) and its own share of the row sums; a row past the tile's
    // last row has limit -1 and stays at m -inf, p 0
    float alpha[RT], p[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float x = (s < s_end && s <= lim_s[r]) ? part[r][0] + part[r][1] : -INFINITY;
      const float m_new = fmaxf(m[r], hv::warp_max(x));
      alpha[r] = 1.f;
      p[r] = 0.f;
      if (m_new != -INFINITY) {
        alpha[r] = exp2f(m[r] - m_new);  // 0 while m is still -inf
        p[r] = exp2f(x - m_new);         // 0 for a masked key
      }
      m[r] = m_new;
      l[r] = fmaf(l[r], alpha[r], p[r]);
    }
    *reinterpret_cast<float4*>(my_p + lane * RT) = make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();

    // P.V: this lane's rows and two dims over the tile's keys
#pragma unroll
    for (int i2 = 0; i2 < RPL; ++i2) {
      const float a = RG == 1 ? alpha[i2] : pick(alpha, rg);
      acc[i2][0] *= a;
      acc[i2][1] *= a;
    }
#pragma unroll 8
    for (int j = 0; j < TK; ++j) {
      float2 vv;
      if constexpr (sizeof(T) == 2) {
        vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vs + j * L::KROW + d0));
      } else {
        vv = *reinterpret_cast<const float2*>(vs + j * L::KROW + d0);
      }
      if constexpr (RG == 1) {
        const float4 p4 = *reinterpret_cast<const float4*>(my_p + j * RT);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int i2 = 0; i2 < RPL; ++i2) {
          acc[i2][0] = fmaf(pj[i2], vv.x, acc[i2][0]);
          acc[i2][1] = fmaf(pj[i2], vv.y, acc[i2][1]);
        }
      } else {
        const float pj = my_p[j * RT + rg];
        acc[0][0] = fmaf(pj, vv.x, acc[0][0]);
        acc[0][1] = fmaf(pj, vv.y, acc[0][1]);
      }
    }
  }

  // each warp's (m, l, acc) to shared memory (a warp whose stream had no
  // tile leaves m -inf, l 0, acc 0), then the key streams combined in
  // order: the output with one working split, else the partial
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float lr = hv::warp_sum(l[r]);
    if (lane == 0) {
      wm_s[warp * RT + r] = m[r];
      wl_s[warp * RT + r] = lr;
    }
  }
#pragma unroll
  for (int i2 = 0; i2 < RPL; ++i2) {
    float* w = wacc_s + (warp * RT + rg + RG * i2) * D + d0;
    w[0] = acc[i2][0];
    w[1] = acc[i2][1];
  }
  __syncthreads();
  const size_t grp = ((size_t)blockIdx.y * row_tiles + tile);  // (b, h, row tile)
  for (int e = tid; e < nrows * D; e += NW * 32) {
    const int r = e / D;
    const int d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int st = 0; st < NW; ++st) mx = fmaxf(mx, wm_s[st * RT + r]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {  // -inf: no key of this split reaches row r
#pragma unroll
      for (int st = 0; st < NW; ++st) {
        const float wt = exp2f(wm_s[st * RT + r] - mx);  // 0 for a stream without keys
        num = fmaf(wt, wacc_s[(st * RT + r) * D + d], num);
        den = fmaf(wt, wl_s[st * RT + r], den);
      }
    }
    if (active == 1) {
      const int rr = row0 + r;
      const int head = h * group + rr % group;
      hv::from_float(out + ((size_t)(b * n_tok + rr / group) * hq + head) * D + d, num / den);
    } else {
      const size_t pr = (grp * splits + split) * RT + r;
      part_acc[pr * D + d] = num;
      if (d == 0) {
        part_ml[pr * 2] = mx;
        part_ml[pr * 2 + 1] = den;
      }
    }
  }
  if (active == 1) return;

  // the last block of this (b, h, row tile) merges the splits in order
  if (!hv::last_of_group(tickets + grp, active)) return;
  constexpr int U = 8;  // partials loaded together, so their latencies overlap
  for (int e = tid; e < nrows * D; e += NW * 32) {
    const int r = e / D;
    const int d = e % D;
    float mx = -INFINITY, num = 0.f, den = 0.f;
    for (int s0 = 0; s0 < active; s0 += U) {
      float mv[U], av[U], lv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t pr = (grp * splits + min(s0 + u, active - 1)) * RT + r;
        mv[u] = s0 + u < active ? __ldcg(part_ml + pr * 2) : -INFINITY;
        lv[u] = __ldcg(part_ml + pr * 2 + 1);
        av[u] = __ldcg(part_acc + pr * D + d);
      }
      // a split whose keys all lie past row r has m -inf and weight 0
      float gm = mx;
#pragma unroll
      for (int u = 0; u < U; ++u) gm = fmaxf(gm, mv[u]);
      if (gm == -INFINITY) continue;
      const float scale = exp2f(mx - gm);  // 0 while mx is still -inf
      num *= scale;
      den *= scale;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (mv[u] == -INFINITY) continue;
        const float wt = exp2f(mv[u] - gm);
        num = fmaf(wt, av[u], num);
        den = fmaf(wt, lv[u], den);
      }
      mx = gm;
    }
    const int rr = row0 + r;
    const int head = h * group + rr % group;
    hv::from_float(out + ((size_t)(b * n_tok + rr / group) * hq + head) * D + d, num / den);
  }
  hv::release_ticket(tickets + grp);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* cache_len, void* out,
           float* part_acc, float* part_ml, int* tickets, int batch, int n_tok, int hq,
           int hkv, int s_max, int splits, int chunk, float scale_log2, cudaStream_t stream) {
  using L = Layout<T, D>;
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int row_tiles = ((hq / hkv) * n_tok + RT - 1) / RT;
  dim3 grid(row_tiles, batch * hkv, splits);
  decode_attn_kernel<T, D><<<grid, NW * 32, L::total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cache_len,
      static_cast<T*>(out), part_acc, part_ml, tickets, n_tok, hq, hkv, s_max, chunk,
      scale_log2);
  return 0;
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                 const int* cache_len, void* out, float* part_acc, float* part_ml,
                 int* tickets, int batch, int n_tok, int hq, int hkv, int s_max, int splits,
                 int chunk, float scale_log2, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, cache_len, out, part_acc, part_ml, tickets, batch, n_tok,
                           hq, hkv, s_max, splits, chunk, scale_log2, stream);
    case 64:
      return launch<T, 64>(q, k, v, cache_len, out, part_acc, part_ml, tickets, batch, n_tok,
                           hq, hkv, s_max, splits, chunk, scale_log2, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Tile sizes, read once by the wrapper to plan row tiles and S splits: a
// block takes NW key tiles of TK keys at a time.
int hv_decode_attention_rows_per_tile() { return RT; }
int hv_decode_attention_keys_per_round() { return NW * TK; }

// dtype: 0 = float32, 1 = bfloat16. part_acc (groups, splits, RT, D) and
// part_ml (groups, splits, RT, 2) f32 are needed when splits > 1, groups =
// B * Hkv * row tiles; tickets (groups,) int32 must be zero and are left
// zero. Returns 0, -1 for an unsupported head dim or dtype, or the
// cudaError_t of the launch.
int hv_decode_attention(int dtype, const void* q, const void* k, const void* v,
                        const int* cache_len, void* out, float* part_acc, float* part_ml,
                        int* tickets, int batch, int n_tok, int hq, int hkv, int head_dim,
                        int s_max, int splits, int chunk, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_dim<float>(head_dim, q, k, v, cache_len, out, part_acc, part_ml, tickets,
                             batch, n_tok, hq, hkv, s_max, splits, chunk, scale_log2, st);
  } else if (dtype == 1) {
    rc = dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, cache_len, out, part_acc, part_ml,
                                     tickets, batch, n_tok, hq, hkv, s_max, splits, chunk,
                                     scale_log2, st);
  } else {
    rc = -1;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
