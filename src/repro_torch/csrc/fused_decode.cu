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
//   1. score (score_range in decode_common.cuh): CTA r takes an equal share of the live block range [lo, hi)
//      (block_share, the full decode's split rule) and streams the leading
//      d features of its live tokens through a per-warp two-stage ring of
//      16-byte cp.async copies, lanes across a token's features (d = 32
//      fp32: 8 lanes a token, 4 tokens per warp instruction), in chunks of
//      up to 32 tokens that never straddle a block. Lane i then scores
//      token i of the chunk from shared memory, summing q̂[:d]·k̂[:d] in
//      feature order (so the block maxima are bit-identical at every C
//      and chunk size); the group max, the +1e4
//      local-window boost after it, and a warp max go to the CTA's own
//      (nb,) row of block maxima through a shared atomic max (exact).
//   2. select (cluster_select): cluster.sync(); every CTA reads the live entries of the row
//      from their owners through distributed shared memory and runs the
//      same k_blocks rounds of argmax-and-suppress (all 4 warps, one CTA
//      barrier a round; ties to the lower index, -1 once no finite maximum
//      is left), so all C CTAs hold the same selection with no broadcast.
//   3. attend (attend_share in decode_common.cuh, which
//      block_sparse_attention_grouped runs too): CTA r takes an equal share
//      of the winners (2 of 8 at C = 4) and streams their live tokens
//      through the full decode's warp ring (fp32, bf16: stream_chunks,
//      4-token chunks; fp16, int8, fp8: attend_share_narrow and
//      stream_narrow, chunks sized in bytes that never leave a block;
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
// select_blocks runs phases 1-2 alone (select_cluster_kernel): the same
// grid, C, shares, score_range and cluster_select, so its block maxima and
// winners are the fused kernels' bits; it selects in place over each
// CTA's own row of block maxima (a second cluster.sync() instead of a copy
// of the row), and CTA rank 0 writes the (B, Hkv, kb) int32 winners, -1
// once no finite maximum is left. Shared memory (score_layout, exported as
// loki_select_smem_bytes, mirrored by kernels/tuning.py select_smem_bytes):
// the scaled query, the block-maxima row, the argmax exchange and the 4
// warps' score rings, 37,568 B at the main shape. ptxas: 48-64 registers,
// 8 B spilled at G <= 16 over a bf16 cache, none elsewhere. A deeper score
// ring (3 or 4 stages, or 4 stages of 16-token chunks) was no faster here
// or in block_max_scores, and its shared memory slowed the fused kernels.
//
// Paged mode: with a page table the caches are the serving engine's pools
// (R, Hkv, ·) with no batch dimension, and every block read resolves its
// row through BlockRows (decode_common.cuh); S is then the logical length
// n_tab * page_size. Paged and contiguous run the same shares, so their
// outputs are bit-identical.
//
// Quantized pools (int8, fp8-e4m3 codes with per-page float32 K and V
// scales, paged only): the score stream copies the codes raw and lane 0
// copies the block's K scale into the padding of the stage's first row;
// each token's dot dequantizes code by code (code * scale, then the fma),
// so the block maxima are the plain path's. The attention phase runs the
// narrow body (as over fp16 pools): each chunk lies in one page, its stage
// carries that page's K and V scales, and they are folded in once per
// token ((q·codes) * K scale; p * V scale before p·V). At int8:pca:r=32 a
// token's score row is 32 B and its attention row 160 B, against 128 B
// and 1 KB for the fp32 cache; the attention ring (32 tokens a stage) is
// then the largest use of the shared region, 45,536 B in all.
//
// Requires cur_len >= 1 per row (the decode invariant: the new token is in
// the cache already); it is not checked here, to keep the hot path free of
// host syncs.
#include "decode_common.cuh"

namespace loki {

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
      (size_t)SPLIT_WARPS * SPLIT_STAGES * attn_stage_bytes<TK>(W, D);
  const size_t merge = sizeof(float) * (SPLIT_WARPS + 1) * G * (D + 2);
  const size_t row = sizeof(float) * nb;
  size_t u = score_ring;
  u = attn_ring > u ? attn_ring : u;
  u = merge > u ? merge : u;
  u = row > u ? row : u;
  L.total = off + round16(u);
  return L;
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
  const int tid = threadIdx.x, lane = tid & 31;
  const FusedLayout L = fused_layout<TK>(G, W, D, d, bs, nb, kb);
  const size_t bh = (size_t)b * Hkv + h;
  float* qs = reinterpret_cast<float*>(base + L.qs);        // G x pad4(W)
  float* blkmax = reinterpret_cast<float*>(base + L.blkmax); // nb
  int* sel = reinterpret_cast<int*>(base + L.sel);           // kb
  float* wv = reinterpret_cast<float*>(base + L.wsel);       // 2 x warps
  int* wi = reinterpret_cast<int*>(wv + 2 * SPLIT_WARPS);
  uint8_t* uni = base + L.uni;

  load_query_padded(q + bh * G * W, qs, G, W, scale);
  for (int j = tid; j < nb; j += SPLIT_THREADS) blkmax[j] = NEG_INF;
  const int ln = cur_len[b];
  const BlockShare sh = block_share(ln, nb, bs, sliding_window, rank, C);
  __syncthreads();

  // ---- 1. score this CTA's share of the live blocks
  const int2 t = share_tokens(sh, bs, ln, sliding_window);
  score_range<TK, GM>(k, rows, b, h, Hkv, W, d, bs, L.tok, L.row_bytes, qs,
                      pad4(W), G, 1.f, t.x, t.y, ln, local_window, blkmax,
                      0, uni, vec_k != 0);

  // ---- 2. select: the same k_blocks winners in every CTA of the cluster,
  // over a copy of the row in the shared region
  const int nv = cluster_select(blkmax, reinterpret_cast<float*>(uni), sh,
                                nb, kb, wv, wi,
                                [&](int i, int bi) { sel[i] = bi; });

  // ---- 3-4. attend this CTA's share of the winners, merge in rank 0
  if constexpr (Narrow<TK>::value) {
    attend_share_narrow<TQ, TK, GM, DC>(
        sel, nv, qs, uni, narrow_tokens(W, D, sizeof(TK)), k, v, rows, b, h,
        Hkv, ln, G, W, D, bs, sliding_window, out + bh * G * D);
  } else {
    attend_share<TQ, TK, SPLIT_TOK, false, false, GM, DC>(
        sel, nv, qs, uni, split_stage_bytes<TK>(W, D),
        [&](uint8_t* stage, int pos0, int t1) {
          split_fill(stage, k, v, rows, b, h, Hkv, W, D, bs, pos0, t1,
                     vec_kv != 0, lane);
        },
        ln, G, W, D, bs, sliding_window, 1.f, out + bh * G * D);
  }
}

// ------------------------------------------ the select_blocks cluster kernel

// Phases 1-2 of the fused kernel alone (the same score_range and
// cluster_select), selecting in place over each CTA's own block-maxima row
// (score_layout: no copy of the row, so the longest rows the two-kernel
// plan takes fit); CTA rank 0 writes the winners to out[b, h, :] as it
// finds them, then -1 for the rest.
template <typename TQ, typename TK, int GM>
__global__ void __launch_bounds__(SPLIT_THREADS)
select_cluster_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                      const int* __restrict__ cur_len, BlockRows rows,
                      int* __restrict__ out, int Hkv, int G, int W, int d,
                      int bs, int nb, int kb, float scale, int local_window,
                      int sliding_window, int vec_k) {
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, b = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const ScoreLayout L = score_layout<TK>(G, W, d, bs, nb);
  const size_t bh = (size_t)b * Hkv + h;
  float* qs = reinterpret_cast<float*>(base + L.qs);        // G x pad4(W)
  float* blkmax = reinterpret_cast<float*>(base + L.blkmax); // nb
  float* wv = reinterpret_cast<float*>(base + L.wsel);       // 2 x warps
  int* wi = reinterpret_cast<int*>(wv + 2 * SPLIT_WARPS);

  load_query_padded(q + bh * G * W, qs, G, W, scale);
  for (int j = tid; j < nb; j += SPLIT_THREADS) blkmax[j] = NEG_INF;
  const int ln = cur_len[b];
  const BlockShare sh = block_share(ln, nb, bs, sliding_window, rank, C);
  __syncthreads();

  const int2 t = share_tokens(sh, bs, ln, sliding_window);
  score_range<TK, GM>(k, rows, b, h, Hkv, W, d, bs, L.tok, L.row_bytes, qs,
                      pad4(W), G, 1.f, t.x, t.y, ln, local_window, blkmax,
                      0, base + L.ring, vec_k != 0);
  int* o = out + bh * kb;
  const int nv = cluster_select(blkmax, blkmax, sh, nb, kb, wv, wi,
                                [&](int i, int bi) {
                                  if (rank == 0) o[i] = bi;
                                });
  if (rank == 0)
    for (int i = nv + tid; i < kb; i += SPLIT_THREADS) o[i] = -1;
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
  // the rows (slots x kv heads) the cluster size is planned for: the
  // engine's full width, so a packed step of fewer slots launches each
  // slot as the full-width step does (its rounding then does not depend
  // on which slots share the step)
  int plan_rows;

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
    const int C = cluster_size(nb, a.plan_rows, sm_count());
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

inline bool shape_ok(const Launch& a) {
  return a.G >= 1 && a.G <= MAXG && a.W >= 1 && a.W <= MAXDIM && a.D >= 1 &&
         a.D <= MAXDIM && a.d >= 1 && a.d <= a.W && a.bs >= 1 &&
         a.S % a.bs == 0 && a.kb >= 1 && a.kb <= a.S / a.bs &&
         a.plan_rows >= 1 &&
         rows_ok(a.table, a.n_tab, a.page_size, a.S, a.bs);
}

template <typename TQ, typename TK>
struct Select {
  template <int GM>
  static cudaError_t go(const Launch& a) {
    const int nb = a.S / a.bs;
    const ScoreLayout L = score_layout<TK>(a.G, a.W, a.d, a.bs, nb);
    const int C = cluster_size(nb, a.plan_rows, sm_count());
    const int vec_k = (a.W * sizeof(TK)) % 16 == 0;
    return launch_cluster(
        select_cluster_kernel<TQ, TK, GM>, a.Hkv, a.B, C, L.total, a.stream,
        a.info, static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const int*>(a.cur_len), a.rows(),
        static_cast<int*>(a.out), a.Hkv, a.G, a.W, a.d, a.bs, nb, a.kb,
        a.scale, a.local_window, a.sliding_window, vec_k);
  }
  static cudaError_t run(const Launch& a) {
    if (!storage_ok<TK>(a.table, a.ksc, nullptr, false,
                        (a.W * sizeof(TK)) % 16 == 0))
      return cudaErrorInvalidValue;
    if (a.G == 1) return go<1>(a);
    if (a.G <= 4) return go<4>(a);
    return go<MAXG>(a);
  }
};

}  // namespace loki

using namespace loki;

// Every launcher: q_bf16 is 0 for a float32 query, 1 for bfloat16; kv the
// cache's storage code (decode_common.cuh KV_*); table is nullptr for a
// contiguous cache (n_tab = page_size = 0), else the (B, n_tab) int32 page
// table, with S = n_tab * page_size the logical length; k_scale / v_scale
// the (n_pages,) float32 page scales of an int8 or fp8 pool, else nullptr;
// plan_rows the rows (slots x kv heads) the cluster size is planned for,
// B * Hkv or the engine's full width for a packed step of B slots.
// Returns a cudaError_t (cudaErrorInvalidValue for a storage this library
// is not built for).
extern "C" int loki_fused_decode(const void* q, const void* k, const void* v,
                                 const void* cur_len, const void* table,
                                 const void* k_scale, const void* v_scale,
                                 void* out, int q_bf16, int kv, int B, int S,
                                 int Hkv, int G, int W, int D, int d, int bs,
                                 int kb, int n_tab, int page_size,
                                 int plan_rows, float scale,
                                 int local_window, int sliding_window,
                                 void* stream) {
  const Launch a{q, k, v, cur_len, table, k_scale, v_scale, out, B, S,
                      Hkv, G, W, D, d, bs, kb, n_tab, page_size, scale,
                      local_window, sliding_window,
                      static_cast<cudaStream_t>(stream), nullptr, plan_rows};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Fused>(q_bf16, kv, a);
}

// The exact_topk policy's kernel: the fused pass at d = W with no recency
// boost (JAX fused_exact_topk_decode builds _fused_kernel the same way).
extern "C" int loki_fused_exact_topk_decode(
    const void* q, const void* k, const void* v, const void* cur_len,
    const void* table, const void* k_scale, const void* v_scale, void* out,
    int q_bf16, int kv, int B, int S, int Hkv, int G, int W, int D, int bs,
    int kb, int n_tab, int page_size, int plan_rows, float scale,
    int sliding_window, void* stream) {
  const Launch a{q, k, v, cur_len, table, k_scale, v_scale, out, B, S,
                      Hkv, G, W, D, W, bs, kb, n_tab, page_size, scale, 0,
                      sliding_window, static_cast<cudaStream_t>(stream),
                      nullptr, plan_rows};
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
                                       int bs, int kb, int plan_rows,
                                       long long* info) {
  static const int table = 0;
  static const float scale1 = 1.f;
  const bool scaled = kv == KV_I8 || kv == KV_F8;
  const Launch a{nullptr, nullptr, nullptr, nullptr,
                      scaled ? &table : nullptr, scaled ? &scale1 : nullptr,
                      scaled ? &scale1 : nullptr, nullptr, B, S, Hkv, G, W,
                      D, d, bs, kb, scaled ? 1 : 0, scaled ? S : 0, 1.f, 0,
                      0, nullptr, info, plan_rows};
  if (!shape_ok(a) || info == nullptr) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Fused>(q_bf16, kv, a);
}

extern "C" int loki_select_blocks(const void* q, const void* k,
                                  const void* cur_len, const void* table,
                                  const void* k_scale, void* out, int q_bf16,
                                  int kv, int B, int S, int Hkv, int G, int W,
                                  int d, int bs, int kb, int n_tab,
                                  int page_size, int plan_rows, float scale,
                                  int local_window, int sliding_window,
                                  void* stream) {
  const Launch a{q, k, nullptr, cur_len, table, k_scale, nullptr, out,
                      B, S, Hkv, G, W, W, d, bs, kb, n_tab, page_size, scale,
                      local_window, sliding_window,
                      static_cast<cudaStream_t>(stream), nullptr, plan_rows};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Select>(q_bf16, kv, a);
}

// select_blocks' dynamic shared memory in bytes at a shape and storage
// code; kernels/tuning.py select_smem_bytes must give the same.
extern "C" long long loki_select_smem_bytes(int kv, int G, int W, int d,
                                            int bs, int nb) {
  return with_storage(kv, [&](auto* tag) {
    using TK = std::remove_pointer_t<decltype(tag)>;
    return (long long)score_layout<TK>(G, W, d, bs, nb).total;
  });
}

// What a select_blocks launch at this shape would use, without launching:
// info[0] the cluster size C, info[1] the dynamic shared memory in bytes,
// info[2] cudaOccupancyMaxActiveClusters for that kernel, memory and C. A
// scaled storage is asked as if paged (the kernel takes it only so).
extern "C" int loki_select_cluster_info(int q_bf16, int kv, int B, int S,
                                        int Hkv, int G, int W, int d, int bs,
                                        int kb, int plan_rows,
                                        long long* info) {
  static const int table = 0;
  static const float scale1 = 1.f;
  const bool scaled = kv == KV_I8 || kv == KV_F8;
  const Launch a{nullptr, nullptr, nullptr, nullptr,
                      scaled ? &table : nullptr, scaled ? &scale1 : nullptr,
                      nullptr, nullptr, B, S, Hkv, G, W, W, d, bs, kb,
                      scaled ? 1 : 0, scaled ? S : 0, 1.f, 0, 0, nullptr,
                      info, plan_rows};
  if (!shape_ok(a) || info == nullptr) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Select>(q_bf16, kv, a);
}
