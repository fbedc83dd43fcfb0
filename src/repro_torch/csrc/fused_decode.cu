// Fused GQA-batched Loki decode for Hopper (sm_90a), contiguous or paged
// caches: the kernels, their launchers and their shape queries. One build
// covers the storage types its define names (decode_common.cuh by_storage):
// none for float32 and bfloat16 caches, -DLOKI_STORAGE_F16, _I8 or _F8 for
// one other storage each (kernels/_build.py builds each as a library of its
// own, all nvcc runs side by side).
//
// Replaces the Pallas TPU kernels of repro/kernels/fused_decode.py:
//   fused_loki_decode       (score -> select -> attend in one pass),
//   select_blocks           (score -> select only, for the two-kernel pair),
//   fused_exact_topk_decode (the same pass with d = W: exact full-width
//                            scores, no recency boost; the exact_topk
//                            policy).
//
// What bounds it on an H100: bytes. Per (b, kv-head) the score stream reads
// the leading d features of every live key (d = 32 fp32 = 128 B a token;
// d = W for exact top-k) and the attention pass reads k_blocks winning K̂
// and V blocks; the arithmetic is a few FMAs per byte, far below the card's
// ~295 ops/byte ridge. Every intermediate stays on chip: the block maxima
// sit in shared memory, the selection never leaves the cluster, and the
// winners are read once per KV group (all G query heads share them).
//
// The fused kernels (fused_loki_decode, fused_exact_topk_decode) run as
// split-KV over a thread-block cluster: grid (Hkv, B, C), one cluster of C
// CTAs of 4 warps per (kv-head, slot), C picked on the host from shapes
// only (about 4 CTAs per SM, 1 <= C <= min(8, S / bs); cluster_size in
// decode_common.cuh), so the host never reads cur_len. In one launch:
//   1. score: CTA r takes an equal share of the live block range [lo, hi)
//      (block_share, the full decode's split rule) and streams the leading
//      d features of its live tokens through a per-warp two-stage ring of
//      16-byte cp.async copies, lanes across a token's features (d = 32
//      fp32: 8 lanes a token, 4 tokens per warp instruction), in chunks of
//      up to 32 tokens that never straddle a block. Lane i then scores
//      token i of the chunk from shared memory, summing q̂[:d]·k̂[:d] in
//      feature order (the order select_blocks uses, so the block maxima
//      are bit-identical to it and to every C); the group max, the +1e4
//      local-window boost after it, and a warp max go to the CTA's own
//      (nb,) row of block maxima through a shared atomic max (exact).
//   2. select: cluster.sync(); every CTA reads the live entries of the row
//      from their owners through distributed shared memory and runs the
//      same k_blocks rounds of argmax-and-suppress (all 4 warps, one CTA
//      barrier a round; ties to the lower index, -1 once no finite maximum
//      is left), so all C CTAs hold the same selection with no broadcast.
//   3. attend (attend_share in decode_common.cuh, which
//      block_sparse_attention_grouped runs too): CTA r takes an equal share
//      of the winners (2 of 8 at C = 4) and streams their live tokens
//      through the full decode's warp ring (stream_chunks: 4-token chunks,
//      16-byte cp.async, per-warp online softmax), then merges its 4 warps
//      (merge_warps) into a partial (acc[G, D], m, l) in its own shared
//      memory.
//   4. merge: cluster.sync(); CTA rank 0 reads the C partials through
//      distributed shared memory and merges them by log-sum-exp in rank
//      order (merge_partials: alpha = 0 for an empty partial, the 1e-30
//      floor) into (B, Hkv, G, D) in q's dtype; a last cluster.sync() keeps
//      the peers' shared memory alive until it has. No global scratch and
//      no second kernel.
// Shared memory (fused_layout, exported as loki_fused_smem_bytes and
// mirrored by kernels/tuning.py fused_smem_bytes): the scaled query, the
// block-maxima row, the selection, and one region that holds in turn the
// score ring, the selection's copy of the row, the attention ring and the
// merge buffers: 37,600 B at llama2-7b's fp32 cache
// (d 32, smax 4096, block 128, k_blocks 8), so 6 CTAs per SM fit.
// ptxas (-O3, sm_90a) for the fused cluster kernel: G <= 1 at D <= 128,
// the main path's shape, 72-80 registers (28 B spilled with fp32 queries
// over a bf16 cache, none on the main path's bf16 queries over fp32);
// G <= 4, or G <= 1 at D > 128: 96-128 registers, up to 44 B spilled;
// G <= 16 at D <= 128: 243-247 registers, no spill; G <= 16 at D > 128:
// 255 registers and 276 B of spill stores. At the main shape shared
// memory, not registers, limits residency (6 CTAs per SM). chip_smoke.py
// saves the whole build log beside its report. A loop around the
// attention stream (attend_share) doubled the main instantiation's
// registers and slowed it, so attend_share streams each share in one
// pass.
//
// select_blocks keeps the one-CTA body (score_and_select): one block of
// 256 threads per (kv-head, batch) pair.
//
// Paged mode: with a page table the caches are the serving engine's pools
// (R, Hkv, ·) with no batch dimension, and every block read resolves its
// row through BlockRows (decode_common.cuh); S is then the logical length
// n_tab * page_size. Paged and contiguous run the same shares, so their
// outputs are bit-identical.
//
// Quantized pools (int8, fp8-e4m3 codes with per-page float32 K and V
// scales, paged only) run the same bodies: the score stream copies the
// codes raw and lane 0 copies the block's K scale into the padding of the
// stage's first row; each token's dot dequantizes code by code (code *
// scale, then the fma), in the order select_blocks uses, so their block
// maxima stay bit-identical; the attention phase carries each token's K and
// V scales in its ring stage (decode_common.cuh split_fill). At
// int8:pca:r=32 a token's score row is 32 B and its attention row 160 B,
// against 128 B and 1 KB for the fp32 cache.
//
// Requires cur_len >= 1 per row (the decode invariant: the new token is in
// the cache already); it is not checked here, to keep the hot path free of
// host syncs.
#include "decode_common.cuh"

namespace loki {

template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
select_blocks_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                     const int* __restrict__ cur_len, BlockRows rows,
                     int* __restrict__ out, int Hkv, int G, int W, int d,
                     int bs, int nb, int kb, float scale, int local_window,
                     int sliding_window, int vec) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  float* qs = smem;                                   // G*W
  float* scores = qs + G * W;                         // nb
  const int ln = cur_len[b];
  const size_t bh = (size_t)b * Hkv + h;
  load_query(q + bh * G * W, qs, G * W, scale);
  score_and_select(k, qs, scores, out + bh * kb, rows, b, h, ln, Hkv, G, W,
                   d, bs, nb, kb, local_window, sliding_window, vec != 0);
}

// ------------------------------------------------- the fused cluster kernel

constexpr int SCORE_STAGES = 2;
constexpr int SCORE_MAX_TOK = 32;     // one token per lane
// a score stage: 32 tokens of d = 32 fp32 (128 B + 16 B of padding each)
constexpr int SCORE_STAGE_BYTES = 32 * 144;

// Bytes of one staged token row of the score stream: its leading d
// features in the cache dtype rounded up to 16 B, plus 16 B so that lanes
// reading neighbouring rows with 16-byte loads hit distinct banks.
template <typename TK>
__host__ __device__ inline int score_row_bytes(int d) {
  return (int)round16((size_t)d * sizeof(TK)) + 16;
}

// Where a score stage holds its block's K scale (scaled storage): the
// padding after the first row's d features
template <typename TK>
__host__ __device__ inline size_t score_scale_at(int d) {
  return round16((size_t)d * sizeof(TK));
}

// Tokens per score chunk: the largest power of two <= 32 that divides bs
// (so a chunk never straddles two blocks) and keeps a stage within
// SCORE_STAGE_BYTES (at least one token).
__host__ __device__ inline int score_tokens(int row_bytes, int bs) {
  int t = SCORE_MAX_TOK;
  while (t > 1 && (t * row_bytes > SCORE_STAGE_BYTES || bs % t != 0)) t >>= 1;
  return t;
}

// Byte offsets of the fused kernel's dynamic shared memory. ``uni`` holds,
// in turn, the 4 warps' score rings, the selection's copy of the block
// maxima, the 4 warps' attention rings, and the warp-merge scratch
// followed by the CTA's partial (G x (D + 2) float32).
struct FusedLayout {
  size_t qs, blkmax, sel, wsel, uni, total;
  int row_bytes, tok;
};

template <typename TK>
__host__ __device__ inline FusedLayout fused_layout(int G, int W, int D,
                                                    int d, int bs, int nb,
                                                    int kb) {
  FusedLayout L;
  L.row_bytes = score_row_bytes<TK>(d);
  L.tok = score_tokens(L.row_bytes, bs);
  size_t off = 0;
  L.qs = off;
  off += round16(sizeof(float) * G * pad4(W));
  L.blkmax = off;
  off += round16(sizeof(float) * nb);
  L.sel = off;                            // the kb winners
  off += round16(sizeof(int) * (size_t)kb);
  L.wsel = off;                           // 2 rounds x 4 warps (value, index)
  off += round16(2 * SPLIT_WARPS * (sizeof(float) + sizeof(int)));
  L.uni = off;
  const size_t score_ring =
      (size_t)SPLIT_WARPS * SCORE_STAGES * L.tok * L.row_bytes;
  const size_t attn_ring =
      (size_t)SPLIT_WARPS * SPLIT_STAGES * split_stage_bytes<TK>(W, D);
  const size_t merge = sizeof(float) * (SPLIT_WARPS + 1) * G * (D + 2);
  const size_t row = sizeof(float) * nb;
  size_t u = score_ring;
  u = attn_ring > u ? attn_ring : u;
  u = merge > u ? merge : u;
  u = row > u ? row : u;
  L.total = off + round16(u);
  return L;
}

// Maximum of a shared float and v, exact for all non-NaN values: the
// float order is the int order for non-negative floats and the reversed
// unsigned order for negative ones.
__device__ __forceinline__ void atomic_max_f(float* p, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

// Copy the leading d features of the live tokens of score chunk c
// (positions c * T .. c * T + T - 1 within [t_lo, t_hi), all in one block)
// into a ring stage, one row of ``rs`` bytes per token, then commit one
// cp.async group. 16-byte copies run across a token's features; rows
// whose width is not a 16-byte multiple are copied element by element.
// Scaled storage: lane 0 also copies the block's K scale into the padding
// after the first row's features (score_scale_at).
template <typename TK>
__device__ __forceinline__ void score_fill(
    uint8_t* stage, const TK* __restrict__ k, const BlockRows& rows, int b,
    int h, int Hkv, int W, int d, int bs, int T, int rs, int c, int t_lo,
    int t_hi, bool vec, int lane) {
  const int c0 = c * T;
  const int p0 = max(c0, t_lo), p1 = min(c0 + T, t_hi);
  const int blk = c0 / bs;
  const int64_t r0 = rows.first_row(b, blk) - (int64_t)blk * bs;
  if constexpr (Store<TK>::scaled)
    if (lane == 0)
      cp_async4(stage + score_scale_at<TK>(d), rows.ksc + rows.page(b, blk));
  if (vec) {
    constexpr int E = 16 / sizeof(TK);
    const int ppt = (d + E - 1) / E;              // 16 B pieces per token
    const int n = (p1 - p0) * ppt;
    for (int i = lane; i < n; i += 32) {
      const int u = i / ppt, pc = i - u * ppt, p = p0 + u;
      cp_async16(stage + (size_t)(p - c0) * rs + pc * 16,
                 k + ((r0 + p) * Hkv + h) * (int64_t)W + pc * E);
    }
  } else {
    const int n = (p1 - p0) * d;
    for (int i = lane; i < n; i += 32) {
      const int u = i / d, f = i - u * d, p = p0 + u;
      reinterpret_cast<TK*>(stage + (size_t)(p - c0) * rs)[f] =
          k[((r0 + p) * Hkv + h) * (int64_t)W + f];
    }
  }
  cp_async_commit();
}

// max over the G heads of q̂[:d]·k̂[:d] for one staged token row, each dot
// summed in feature order as score_and_select sums it (scaled storage:
// each code times the block's scale ks first, as there)
template <typename TK, int GM>
__device__ __forceinline__ float score_token(const uint8_t* row,
                                             const float* qs, int Wp, int G,
                                             int d, float ks) {
  const TK* kr = reinterpret_cast<const TK*>(row);
  constexpr int E = 16 / sizeof(TK);
  float acc[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g] = 0.f;
  int f = 0;
  for (; f + E <= d; f += E) {
    float kv[E];
    load16(kr + f, kv);
    if constexpr (Store<TK>::scaled) {
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] *= ks;
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g] = fmaf(qs[g * Wp + f + e], kv[e], acc[g]);
  }
  for (; f < d; ++f) {
    float kv = to_f(kr[f]);
    if constexpr (Store<TK>::scaled) kv *= ks;
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) acc[g] = fmaf(qs[g * Wp + f], kv, acc[g]);
  }
  float s = NEG_INF;
#pragma unroll
  for (int g = 0; g < GM; ++g)
    if (g < G) s = fmaxf(s, acc[g]);
  return s;
}

// (value, index) pairs: the larger value wins, ties to the lower index
__device__ __forceinline__ void argmax_take(float& bv, int& bi, float ov,
                                            int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

template <typename TQ, typename TK, int GM, int DC>
__global__ void __launch_bounds__(SPLIT_THREADS)
fused_cluster_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                     const TK* __restrict__ v,
                     const int* __restrict__ cur_len, BlockRows rows,
                     TQ* __restrict__ out, int Hkv, int G, int W, int D,
                     int d, int bs, int nb, int kb, float scale,
                     int local_window, int sliding_window, int vec_k,
                     int vec_kv) {
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, b = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const FusedLayout L = fused_layout<TK>(G, W, D, d, bs, nb, kb);
  const int Wp = pad4(W);
  const size_t bh = (size_t)b * Hkv + h;
  float* qs = reinterpret_cast<float*>(base + L.qs);        // G x Wp
  float* blkmax = reinterpret_cast<float*>(base + L.blkmax); // nb
  int* sel = reinterpret_cast<int*>(base + L.sel);           // kb
  float* wv = reinterpret_cast<float*>(base + L.wsel);       // 2 x warps
  int* wi = reinterpret_cast<int*>(wv + 2 * SPLIT_WARPS);
  uint8_t* uni = base + L.uni;

  for (int i = tid; i < G * Wp; i += SPLIT_THREADS) {
    const int g = i / Wp, c = i % Wp;
    qs[i] = c < W ? to_f(q[(bh * G + g) * W + c]) * scale : 0.f;
  }
  for (int j = tid; j < nb; j += SPLIT_THREADS) blkmax[j] = NEG_INF;
  const int ln = cur_len[b];
  const BlockShare sh = block_share(ln, nb, bs, sliding_window, rank, C);
  __syncthreads();

  // ---- 1. score this CTA's share of the live blocks
  {
    int t_lo = sh.first * bs;
    if (sliding_window > 0) t_lo = max(t_lo, ln - sliding_window);
    const int t_hi = min(sh.end * bs, ln);
    const int T = L.tok, rs = L.row_bytes;
    const int c_first = t_lo / T;
    const int n_ch = t_hi > t_lo ? (t_hi + T - 1) / T - c_first : 0;
    const int my_n = n_ch > warp
                         ? (n_ch - warp + SPLIT_WARPS - 1) / SPLIT_WARPS
                         : 0;
    const size_t stage = (size_t)T * rs;
    uint8_t* ring = uni + (size_t)warp * SCORE_STAGES * stage;
    auto chunk = [&](int j) { return c_first + warp + j * SPLIT_WARPS; };
#pragma unroll
    for (int j = 0; j < SCORE_STAGES - 1; ++j) {
      if (j < my_n)
        score_fill(ring + j * stage, k, rows, b, h, Hkv, W, d, bs, T, rs,
                   chunk(j), t_lo, t_hi, vec_k != 0, lane);
      else
        cp_async_commit();
    }
    for (int j = 0; j < my_n; ++j) {
      const int jn = j + SCORE_STAGES - 1;
      if (jn < my_n)
        score_fill(ring + (jn % SCORE_STAGES) * stage, k, rows, b, h, Hkv, W,
                   d, bs, T, rs, chunk(jn), t_lo, t_hi, vec_k != 0, lane);
      else
        cp_async_commit();
      cp_async_wait<SCORE_STAGES - 1>();
      __syncwarp();
      const int c = chunk(j), pos = c * T + lane;
      const uint8_t* st = ring + (j % SCORE_STAGES) * stage;
      float ks = 1.f;
      if constexpr (Store<TK>::scaled)
        ks = *reinterpret_cast<const float*>(st + score_scale_at<TK>(d));
      float s = NEG_INF;
      if (lane < T && pos >= t_lo && pos < t_hi) {
        s = score_token<TK, GM>(st + (size_t)lane * rs, qs, Wp, G, d, ks);
        // max(a + c, b + c) == max(a, b) + c under monotone rounding, so
        // the boost after the group max equals the TPU kernel's boost
        // before it
        if (local_window > 0 && pos >= ln - local_window) s += 1e4f;
      }
      s = warp_max(s);
      if (lane == 0) atomic_max_f(blkmax + c * T / bs, s);
      __syncwarp();                   // the stage is refilled next round
    }
    cp_async_wait<0>();
  }
  cluster.sync();                     // every CTA's block maxima, final

  // ---- 2. select: the same k_blocks winners in every CTA of the cluster
  float* row = reinterpret_cast<float*>(uni);
  for (int j = tid; j < nb; j += SPLIT_THREADS) {
    float x = NEG_INF;
    if (j >= sh.lo && j < sh.hi)
      x = *cluster.map_shared_rank(blkmax + j, (j - sh.lo) / sh.per);
    row[j] = x;
  }
  __syncthreads();
  int nv = kb;                        // winners with a finite maximum
  for (int t = 0; t < kb; ++t) {
    // thread tid alone reads and suppresses entries j = tid (mod 128)
    float bv = NEG_INF;
    int bi = 0x7fffffff;
    for (int j = tid; j < nb; j += SPLIT_THREADS)
      argmax_take(bv, bi, row[j], j);
    for (int o = 16; o > 0; o >>= 1)
      argmax_take(bv, bi, __shfl_xor_sync(FULL, bv, o),
                  __shfl_xor_sync(FULL, bi, o));
    float* rv = wv + (t & 1) * SPLIT_WARPS;   // two buffers: one barrier
    int* ri = wi + (t & 1) * SPLIT_WARPS;     // per round
    if (lane == 0) {
      rv[warp] = bv;
      ri[warp] = bi;
    }
    __syncthreads();
    bv = rv[0];
    bi = ri[0];
    for (int w = 1; w < SPLIT_WARPS; ++w) argmax_take(bv, bi, rv[w], ri[w]);
    if (!(bv > NEG_INF * 0.5f)) {     // the same in every thread
      nv = t;
      break;
    }
    if (tid == bi % SPLIT_THREADS) row[bi] = NEG_INF;
    if (tid == 0) sel[t] = bi;
  }

  // ---- 3-4. attend this CTA's share of the winners, merge in rank 0
  attend_share<TQ, TK, SPLIT_TOK, false, false, GM, DC>(
      sel, nv, qs, uni, split_stage_bytes<TK>(W, D),
      [&](uint8_t* stage, int pos0, int t1) {
        split_fill(stage, k, v, rows, b, h, Hkv, W, D, bs, pos0, t1,
                   vec_kv != 0, lane);
      },
      ln, G, W, D, bs, sliding_window, 1.f, out + bh * G * D);
}

// The host side of one launch: shapes, the page table, the per-page scales
// (scaled storage) and the stream.
struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const void* cur_len;
  const void* table;
  const void* ksc;
  const void* vsc;
  void* out;
  int B, S, Hkv, G, W, D, d, bs, kb, n_tab, page_size;
  float scale;
  int local_window, sliding_window;
  cudaStream_t stream;
  long long* info;    // not null: report (C, smem, clusters), no launch

  BlockRows rows() const {
    return make_rows(table, n_tab, page_size, S, bs, ksc, vsc);
  }
  int vec() const { return (d % 4 == 0) && (W % 4 == 0); }
};

template <typename TQ, typename TK>
struct Fused {
  template <int GM, int DC>
  static cudaError_t go(const Launch& a) {
    const int nb = a.S / a.bs;
    const FusedLayout L =
        fused_layout<TK>(a.G, a.W, a.D, a.d, a.bs, nb, a.kb);
    const int C = cluster_size(nb, a.B * a.Hkv, sm_count());
    // 16-byte copies need rows of whole 16-byte pieces
    const int vec_k = (a.W * sizeof(TK)) % 16 == 0;
    const int vec_kv = vec_k && (a.D * sizeof(TK)) % 16 == 0;
    return launch_cluster(
        fused_cluster_kernel<TQ, TK, GM, DC>, a.Hkv, a.B, C, L.total,
        a.stream, a.info, static_cast<const TQ*>(a.q),
        static_cast<const TK*>(a.k), static_cast<const TK*>(a.v),
        static_cast<const int*>(a.cur_len), a.rows(), static_cast<TQ*>(a.out),
        a.Hkv, a.G, a.W, a.D, a.d, a.bs, nb, a.kb, a.scale, a.local_window,
        a.sliding_window, vec_k, vec_kv);
  }
  template <int GM>
  static cudaError_t by_width(const Launch& a) {
    return pad4(a.D) <= 128 ? go<GM, 1>(a) : go<GM, 2>(a);
  }
  static cudaError_t run(const Launch& a) {
    const bool vec = (a.W * sizeof(TK)) % 16 == 0 &&
                     (a.D * sizeof(TK)) % 16 == 0;
    if (!storage_ok<TK>(a.table, a.ksc, a.vsc, true, vec))
      return cudaErrorInvalidValue;
    if (a.G == 1) return by_width<1>(a);
    if (a.G <= 4) return by_width<4>(a);
    return by_width<MAXG>(a);
  }
};

template <typename TQ, typename TK>
cudaError_t launch_select(const Launch& a) {
  const int nb = a.S / a.bs;
  const size_t smem = sizeof(float) * ((size_t)a.G * a.W + nb);
  auto kern = select_blocks_kernel<TQ, TK>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.Hkv, a.B), THREADS, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
      static_cast<const int*>(a.cur_len), a.rows(), static_cast<int*>(a.out),
      a.Hkv, a.G, a.W, a.d, a.bs, nb, a.kb, a.scale, a.local_window,
      a.sliding_window, a.vec());
  return cudaGetLastError();
}

inline bool shape_ok(const Launch& a) {
  return a.G >= 1 && a.G <= MAXG && a.W >= 1 && a.W <= MAXDIM && a.D >= 1 &&
         a.D <= MAXDIM && a.d >= 1 && a.d <= a.W && a.bs >= 1 &&
         a.S % a.bs == 0 && a.kb >= 1 && a.kb <= a.S / a.bs &&
         rows_ok(a.table, a.n_tab, a.page_size, a.S, a.bs);
}

template <typename TQ, typename TK>
struct Select {
  static cudaError_t run(const Launch& a) {
    if (!storage_ok<TK>(a.table, a.ksc, nullptr, false,
                        (a.W * sizeof(TK)) % 16 == 0))
      return cudaErrorInvalidValue;
    return launch_select<TQ, TK>(a);
  }
};

}  // namespace loki

using namespace loki;

// Every launcher: q_bf16 is 0 for a float32 query, 1 for bfloat16; kv the
// cache's storage code (decode_common.cuh KV_*); table is nullptr for a
// contiguous cache (n_tab = page_size = 0), else the (B, n_tab) int32 page
// table, with S = n_tab * page_size the logical length; k_scale / v_scale
// the (n_pages,) float32 page scales of an int8 or fp8 pool, else nullptr.
// Returns a cudaError_t (cudaErrorInvalidValue for a storage this library
// is not built for).
extern "C" int loki_fused_decode(const void* q, const void* k, const void* v,
                                 const void* cur_len, const void* table,
                                 const void* k_scale, const void* v_scale,
                                 void* out, int q_bf16, int kv, int B, int S,
                                 int Hkv, int G, int W, int D, int d, int bs,
                                 int kb, int n_tab, int page_size,
                                 float scale, int local_window,
                                 int sliding_window, void* stream) {
  const Launch a{q, k, v, cur_len, table, k_scale, v_scale, out, B, S,
                      Hkv, G, W, D, d, bs, kb, n_tab, page_size, scale,
                      local_window, sliding_window,
                      static_cast<cudaStream_t>(stream), nullptr};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Fused>(q_bf16, kv, a);
}

// The exact_topk policy's kernel: the fused pass at d = W with no recency
// boost (JAX fused_exact_topk_decode builds _fused_kernel the same way).
extern "C" int loki_fused_exact_topk_decode(
    const void* q, const void* k, const void* v, const void* cur_len,
    const void* table, const void* k_scale, const void* v_scale, void* out,
    int q_bf16, int kv, int B, int S, int Hkv, int G, int W, int D, int bs,
    int kb, int n_tab, int page_size, float scale, int sliding_window,
    void* stream) {
  const Launch a{q, k, v, cur_len, table, k_scale, v_scale, out, B, S,
                      Hkv, G, W, D, W, bs, kb, n_tab, page_size, scale, 0,
                      sliding_window, static_cast<cudaStream_t>(stream),
                      nullptr};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Fused>(q_bf16, kv, a);
}

// The fused kernels' dynamic shared memory in bytes at a shape (d = W for
// exact top-k) and storage code; kernels/tuning.py fused_smem_bytes must
// give the same.
extern "C" long long loki_fused_smem_bytes(int kv, int G, int W, int D,
                                           int d, int bs, int nb, int kb) {
  return with_storage(kv, [&](auto* tag) {
    using TK = std::remove_pointer_t<decltype(tag)>;
    return (long long)fused_layout<TK>(G, W, D, d, bs, nb, kb).total;
  });
}

// What a fused launch at this shape would use, without launching: info[0]
// the cluster size C, info[1] the dynamic shared memory in bytes, info[2]
// cudaOccupancyMaxActiveClusters for that kernel, memory and C. A scaled
// storage is asked as if paged (the kernels take it only so).
extern "C" int loki_fused_cluster_info(int q_bf16, int kv, int B, int S,
                                       int Hkv, int G, int W, int D, int d,
                                       int bs, int kb, long long* info) {
  static const int table = 0;
  static const float scale1 = 1.f;
  const bool scaled = kv == KV_I8 || kv == KV_F8;
  const Launch a{nullptr, nullptr, nullptr, nullptr,
                      scaled ? &table : nullptr, scaled ? &scale1 : nullptr,
                      scaled ? &scale1 : nullptr, nullptr, B, S, Hkv, G, W,
                      D, d, bs, kb, scaled ? 1 : 0, scaled ? S : 0, 1.f, 0,
                      0, nullptr, info};
  if (!shape_ok(a) || info == nullptr) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Fused>(q_bf16, kv, a);
}

extern "C" int loki_select_blocks(const void* q, const void* k,
                                  const void* cur_len, const void* table,
                                  const void* k_scale, void* out, int q_bf16,
                                  int kv, int B, int S, int Hkv, int G, int W,
                                  int d, int bs, int kb, int n_tab,
                                  int page_size, float scale,
                                  int local_window, int sliding_window,
                                  void* stream) {
  const Launch a{q, k, nullptr, cur_len, table, k_scale, nullptr, out,
                      B, S, Hkv, G, W, W, d, bs, kb, n_tab, page_size, scale,
                      local_window, sliding_window,
                      static_cast<cudaStream_t>(stream), nullptr};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Select>(q_bf16, kv, a);
}
