// GQA-batched decode attention for Hopper (sm_90a), contiguous or paged
// caches, and the per-head block-sparse attention.
//
// block_sparse_attention_grouped replaces the Pallas TPU kernel of the same
// name in repro/kernels/gather_attention.py: exact attention over a
// group-shared block selection blk_idx (B, Hkv, n_sel), -1 entries
// contributing nothing. It is the second half of the two-kernel pair
// (after select_blocks).
//
// full_decode replaces paged_full_decode of the same file: the full
// policy's decode, an online softmax over the live blocks only, from the
// sliding window's first block to ceil(cur_len / bs), so the bytes read
// follow the live prefix and never the table's capacity.
//
// What bounds all of them on an H100: bytes. They read each K̂ block of
// width W and V block of width D per (b, kv-head) once, whatever G is (the
// G query heads of a KV group share every block), and do O(G) FMAs per
// element read. The TPU kernels walked the blocks as a sequential grid axis
// (or a fori_loop) with the softmax state in scratch.
//
// block_sparse_attention_grouped: one block of 256 threads per (kv-head,
// batch) pair walks the selected blocks in a loop (attend_blocks), with
// the online softmax state and one block's scores in shared memory and the
// (G, D) accumulators in registers.
//
// full_decode is split-KV, because one CTA per (kv-head, slot) is 128 CTAs
// on 132 SMs at llama2-7b's 4 slots, each walking ~25 blocks with one
// block's loads in flight. Grid (Hkv, B, n_split): split s takes an equal
// share of the live block range [lo, hi), computed on the device from
// cur_len; n_split comes from the host, from shapes only (the wrapper aims
// at about 4 CTAs per SM), so the host never reads cur_len. In a split,
// each of 4 warps streams its own chunks of 4 tokens through a private
// two-stage shared-memory ring filled by 16-byte cp.async (the next
// chunk's K̂ and V rows in flight while the warp computes on this one; no
// CTA barrier in the loop; the body, stream_chunks and merge_warps in
// decode_common.cuh, is shared with the fused cluster kernels of
// fused_decode.cu): lanes hold 4 columns (8 at D > 128), a token's
// G scores are warp sums, and the warp keeps its own (G,) online softmax
// and (G, D) accumulators in registers. The 4 warps then merge by
// log-sum-exp in shared memory, and the split writes its partial (acc[G,
// D], m, l) in float32 to a scratch tensor; a second small kernel in the
// same launcher call merges the n_split partials by log-sum-exp (alpha = 0
// for an empty partial, the 1e-30 floor) into (B, Hkv, G, D). A split with
// no live block writes m = -1e30, l = 0. Widths whose rows are not 16-byte
// multiples are copied element by element into the same ring. Shared
// memory: the scaled query (G x W float32) + 4 warps x 2 stages x 4 tokens
// x (W + D) cache elements, the warp merge reusing the ring: 32.5 KB at
// llama2-7b's fp32 cache, so its 512 CTAs are all resident at once: small
// chunks and many resident warps beat deeper rings and longer chunks here
// (measured on an H100: PERF.md §6).
//
// Paged mode: with a page table the caches are the pools (R, Hkv, ·) and
// every block read resolves through BlockRows; S is the logical length
// n_tab * page_size.
//
// block_sparse_attention replaces the per-head Pallas TPU kernel of the
// same name (repro/kernels/gather_attention.py:75), the last stage of the
// per-head pipeline (ops.loki_decode_attention): exact online-softmax
// attention of each (BH) row over its own blk_idx (BH, n_sel) blocks,
// masking positions >= cur_len; a row masked everywhere gives zeros. It
// has no -1 sentinel, no window and no page table, as the TPU kernel has
// none. What bounds it: bytes, the n_sel selected K̂ and V blocks of a row
// at full width (llama2-7b per head: 128 rows x 8 blocks x 128 tokens x
// 2 x 512 B fp32 = 134 MB, 40 us at 3.35 TB/s). The TPU walked n_sel as a
// sequential grid axis with the softmax state in VMEM scratch; here one
// CTA per row walks the blocks in a loop, with one block's scores and the
// softmax state in shared memory and the (D,) accumulator in registers.
// K̂ is read through a token stride and a feature stride, so the
// feature-major pipeline reads the selected blocks straight from K̂ᵀ
// (BH, D, S) without a token-major copy of the cache. Either way a warp
// takes a token and its lanes the features f = lane + 32 m, so the two
// layouts sum each dot in the same order (coalesced when token-major; in
// feature-major the lanes read 32 feature rows, each line serving the
// next tokens from L1).
#include "decode_common.cuh"

namespace loki {

template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
block_sparse_attention_grouped_kernel(
    const TQ* __restrict__ q, const TK* __restrict__ k,
    const TK* __restrict__ v, const int* __restrict__ blk_idx,
    const int* __restrict__ cur_len, BlockRows rows, TQ* __restrict__ out,
    int Hkv, int G, int W, int D, int bs, int n_sel, float scale,
    int sliding_window) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  float* qs = smem;                                   // G*W
  int* sel = reinterpret_cast<int*>(qs + G * W);      // n_sel
  float* sc = reinterpret_cast<float*>(sel + n_sel);  // G*bs
  float* m_s = sc + G * bs;                           // G
  float* l_s = m_s + G;                               // G
  float* alpha_s = l_s + G;                           // G
  float* red = alpha_s + G;                           // nsplit*G*D
  const int ln = cur_len[b];
  const size_t bh = (size_t)b * Hkv + h;
  load_query(q + bh * G * W, qs, G * W, scale);
  for (int t = threadIdx.x; t < n_sel; t += blockDim.x)
    sel[t] = blk_idx[bh * n_sel + t];
  __syncthreads();
  attend_blocks(k, v, qs, sel, 0, n_sel, sc, m_s, l_s, alpha_s, red,
                out + bh * G * D, rows, b, h, ln, Hkv, G, W, D, bs,
                sliding_window);
}

// ---------------------------------------------------- split-KV full decode

template <typename TK>
inline size_t split_smem_bytes(int G, int W, int D) {
  const size_t ring = (size_t)SPLIT_WARPS * SPLIT_STAGES *
                      split_stage_bytes<TK>(W, D);
  const size_t merge = sizeof(float) * SPLIT_WARPS * G * (D + 2);
  return round16(sizeof(float) * G * pad4(W)) + (ring > merge ? ring : merge);
}

// GM >= G query heads per group, DC = column groups of 4 per lane (1 for
// D <= 128, 2 for D <= 256). part: (B, Hkv, n_split, G, D + 2) float32,
// each row acc[D], m, l.
template <typename TQ, typename TK, int GM, int DC>
__global__ void __launch_bounds__(SPLIT_THREADS)
full_decode_split_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                         const TK* __restrict__ v,
                         const int* __restrict__ cur_len, BlockRows rows,
                         float* __restrict__ part, int Hkv, int G, int W,
                         int D, int bs, int nb, float scale,
                         int sliding_window, int vec) {
  extern __shared__ float4 smem4[];
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Wp = pad4(W);
  const size_t bh = (size_t)b * Hkv + h;
  float* qs = reinterpret_cast<float*>(smem4);        // G x Wp, scaled
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4) +
                  round16(sizeof(float) * G * Wp);
  const size_t stage_bytes = split_stage_bytes<TK>(W, D);
  uint8_t* my_ring = ring + (size_t)warp * SPLIT_STAGES * stage_bytes;
  for (int i = tid; i < G * Wp; i += SPLIT_THREADS) {
    const int g = i / Wp, c = i % Wp;
    qs[i] = c < W ? to_f(q[(bh * G + g) * W + c]) * scale : 0.f;
  }

  // this split's share of the live blocks, then its live tokens [t0, t1)
  const int ln = cur_len[b];
  const BlockShare sh = block_share(ln, nb, bs, sliding_window, sp, n_split);
  int t0 = sh.first * bs;
  if (sliding_window > 0) t0 = max(t0, ln - sliding_window);
  const int t1 = min(sh.end * bs, ln);
  const int n_chunks = t1 > t0 ? (t1 - t0 + SPLIT_TOK - 1) / SPLIT_TOK : 0;
  // warp w takes chunks w, w + SPLIT_WARPS, ...
  const int my_n = n_chunks > warp
                       ? (n_chunks - warp + SPLIT_WARPS - 1) / SPLIT_WARPS
                       : 0;
  __syncthreads();                                    // qs

  WarpSoftmax<GM, DC> st;
  st.init();
  stream_chunks<TK>(st, qs, my_ring, stage_bytes, k, v, rows, b, h, Hkv, G,
                    W, D, bs, my_n,
                    [&](int j) {
                      return make_int2(
                          t0 + (warp + j * SPLIT_WARPS) * SPLIT_TOK, t1);
                    },
                    vec != 0, lane);
  __syncthreads();                    // every ring is free: merge there
  merge_warps(st, reinterpret_cast<float*>(ring),
              part + (bh * n_split + sp) * G * (D + 2), G, D);
}

// Merge the n_split partials of each (b, kv-head) by log-sum-exp.
template <typename TQ>
__global__ void __launch_bounds__(SPLIT_THREADS)
full_decode_combine_kernel(const float* __restrict__ part,
                           TQ* __restrict__ out, int G, int D, int n_split) {
  const size_t bh = blockIdx.x;
  const float* pb = part + bh * n_split * G * (D + 2);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, c = i % D;
    store_f(out + bh * G * D + i,
            merge_partials([&](int s) { return pb + s * G * (D + 2); },
                           n_split, g, c, D));
  }
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const void* blk_idx;
  const void* cur_len;
  const void* table;
  void* out;
  int B, S, Hkv, G, W, D, bs, n_sel, n_tab, page_size;
  float scale;
  int sliding_window;
  cudaStream_t stream;
  float* part;        // full decode: the splits' partials
  int n_split;

  BlockRows rows() const {
    return make_rows(table, n_tab, page_size, S, bs);
  }
  bool ok() const {
    return G >= 1 && G <= MAXG && W >= 1 && W <= MAXDIM && D >= 1 &&
           D <= MAXDIM && bs >= 1 && S % bs == 0 &&
           rows_ok(table, n_tab, page_size, S, bs);
  }
};

template <typename TQ, typename TK>
struct Grouped {
  static cudaError_t run(const Launch& a) {
    const int nsplit = THREADS / a.D;
    const size_t smem = sizeof(float) *
                        ((size_t)a.G * a.W + a.n_sel + a.G * a.bs +
                         3 * a.G + (size_t)nsplit * a.G * a.D);
    auto kern = block_sparse_attention_grouped_kernel<TQ, TK>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(a.Hkv, a.B), THREADS, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const TK*>(a.v), static_cast<const int*>(a.blk_idx),
        static_cast<const int*>(a.cur_len), a.rows(),
        static_cast<TQ*>(a.out), a.Hkv, a.G, a.W, a.D, a.bs, a.n_sel,
        a.scale, a.sliding_window);
    return cudaGetLastError();
  }
};

template <typename TQ, typename TK>
struct Full {
  template <int GM, int DC>
  static cudaError_t go(const Launch& a) {
    const size_t smem = split_smem_bytes<TK>(a.G, a.W, a.D);
    // 16-byte copies need rows of whole 16-byte pieces
    const int vec =
        (a.W * sizeof(TK)) % 16 == 0 && (a.D * sizeof(TK)) % 16 == 0;
    auto kern = full_decode_split_kernel<TQ, TK, GM, DC>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(a.Hkv, a.B, a.n_split), SPLIT_THREADS, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const TK*>(a.v), static_cast<const int*>(a.cur_len),
        a.rows(), a.part, a.Hkv, a.G, a.W, a.D, a.bs, a.S / a.bs, a.scale,
        a.sliding_window, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    full_decode_combine_kernel<TQ><<<a.B * a.Hkv, SPLIT_THREADS, 0,
                                     a.stream>>>(
        a.part, static_cast<TQ*>(a.out), a.G, a.D, a.n_split);
    return cudaGetLastError();
  }
  template <int GM>
  static cudaError_t by_width(const Launch& a) {
    return pad4(a.D) <= 128 ? go<GM, 1>(a) : go<GM, 2>(a);
  }
  static cudaError_t run(const Launch& a) {
    if (a.G == 1) return by_width<1>(a);
    if (a.G <= 4) return by_width<4>(a);
    return by_width<MAXG>(a);
  }
};

// The per-head kernel: one CTA per row r. Scores are q̂·K̂[s] then * scale
// (the TPU kernel's order, gather_attention.py:49); the grouped kernels
// scale q̂ first.
template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
block_sparse_attention_kernel(const TQ* __restrict__ q,
                              const TK* __restrict__ k,
                              const TK* __restrict__ v,
                              const int* __restrict__ blk_idx,
                              const int* __restrict__ cur_len,
                              TQ* __restrict__ out, int S, int D, int bs,
                              int n_sel, int64_t k_row, int64_t k_tok,
                              int64_t k_feat, float scale) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* qs = smem;                                   // D
  int* sel = reinterpret_cast<int*>(qs + D);          // n_sel
  float* sc = reinterpret_cast<float*>(sel + n_sel);  // bs
  float* red = sc + bs;                               // nsplit*D
  __shared__ float st[2];                             // running max, alpha
  __shared__ float l_run;
  const int nb = S / bs;
  const int ln = cur_len[r];
  const int nsplit = blockDim.x / D;
  const int col = tid % D, split = tid / D;
  const bool owns = split < nsplit;
  load_query(q + (int64_t)r * D, qs, D, 1.f);
  for (int t = tid; t < n_sel; t += blockDim.x)
    sel[t] = blk_idx[(int64_t)r * n_sel + t];
  if (tid == 0) {
    st[0] = NEG_INF;
    l_run = 0.f;
  }
  float acc = 0.f;
  __syncthreads();

  const TK* kr = k + (int64_t)r * k_row;
  const TK* vr = v + (int64_t)r * S * D;
  for (int t = 0; t < n_sel; ++t) {
    const int blk = sel[t];
    // an index outside the cache is never read (the TPU kernel's result
    // for one is undefined); the same value in every thread
    if (blk < 0 || blk >= nb) continue;
    for (int i0 = warp * TOK_UNROLL; i0 < bs; i0 += NWARPS * TOK_UNROLL) {
      float kv[TOK_UNROLL][PER_LANE];
      bool live[TOK_UNROLL];
#pragma unroll
      for (int u = 0; u < TOK_UNROLL; ++u) {
        const int i = i0 + u, pos = blk * bs + i;
        live[u] = i < bs && pos < ln;
        const TK* row = kr + (int64_t)pos * k_tok;
#pragma unroll
        for (int m = 0; m < PER_LANE; ++m) {
          const int f = lane + 32 * m;
          kv[u][m] = (live[u] && f < D) ? to_f(row[f * k_feat]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < TOK_UNROLL; ++u) {
        float p = 0.f;
#pragma unroll
        for (int m = 0; m < PER_LANE; ++m) {
          const int f = lane + 32 * m;
          if (f < D) p = fmaf(qs[f], kv[u][m], p);
        }
        p = warp_sum(p);
        if (lane == 0 && i0 + u < bs)
          sc[i0 + u] = live[u] ? p * scale : NEG_INF;
      }
    }
    __syncthreads();

    if (warp == 0) {
      float bm = NEG_INF;
      for (int i = lane; i < bs; i += 32) bm = fmaxf(bm, sc[i]);
      bm = warp_max(bm);
      const float m_prev = st[0];
      const float m_new = fmaxf(m_prev, bm);
      // guard: a block with no live position and an empty accumulator
      // must not produce exp(NEG_INF - NEG_INF)
      const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      const float alpha =
          m_prev > NEG_INF * 0.5f ? expf(fminf(m_prev - m_safe, 0.f)) : 0.f;
      float sum = 0.f;
      for (int i = lane; i < bs; i += 32) {
        const float s = sc[i];
        const float p = s > NEG_INF * 0.5f ? expf(s - m_safe) : 0.f;
        sc[i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        st[0] = m_new;
        st[1] = alpha;
        l_run = l_run * alpha + sum;
      }
    }
    __syncthreads();

    if (owns) {
      acc *= st[1];
      // positions past cur_len have p == 0: stop there
      const int n_live = max(0, min(bs, ln - blk * bs));
      const TK* vb = vr + (int64_t)blk * bs * D + col;
      for (int i0 = split; i0 < n_live; i0 += nsplit * V_UNROLL) {
        float vv[V_UNROLL];
#pragma unroll
        for (int u = 0; u < V_UNROLL; ++u) {
          const int i = i0 + u * nsplit;
          vv[u] = i < n_live ? to_f(vb[(int64_t)i * D]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < V_UNROLL; ++u) {
          const int i = i0 + u * nsplit;
          if (i < n_live) acc = fmaf(sc[i], vv[u], acc);
        }
      }
    }
    __syncthreads();                  // sc is rewritten by the next block
  }

  if (owns) red[split * D + col] = acc;
  __syncthreads();
  for (int c = tid; c < D; c += blockDim.x) {
    float a = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) a += red[sp * D + c];
    store_f(out + (int64_t)r * D + c, a / fmaxf(l_run, 1e-30f));
  }
}

struct HeadLaunch {
  const void* q;
  const void* k;
  const void* v;
  const void* blk_idx;
  const void* cur_len;
  void* out;
  int BH, S, D, bs, n_sel;
  long long k_row, k_tok, k_feat;
  float scale;
  cudaStream_t stream;

  bool ok() const {
    return BH >= 1 && D >= 1 && D <= MAXDIM && bs >= 1 && S >= bs &&
           S % bs == 0 && n_sel >= 1 && (k_tok == 1 || k_feat == 1);
  }
};

template <typename TQ, typename TK>
struct PerHead {
  static cudaError_t run(const HeadLaunch& a) {
    const int nsplit = THREADS / a.D;
    const size_t smem = sizeof(float) * ((size_t)a.D + a.n_sel + a.bs +
                                         (size_t)nsplit * a.D);
    auto kern = block_sparse_attention_kernel<TQ, TK>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<a.BH, THREADS, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const TK*>(a.v), static_cast<const int*>(a.blk_idx),
        static_cast<const int*>(a.cur_len), static_cast<TQ*>(a.out), a.S,
        a.D, a.bs, a.n_sel, a.k_row, a.k_tok, a.k_feat, a.scale);
    return cudaGetLastError();
  }
};

}  // namespace loki

using namespace loki;

// q_bf16 / kv_bf16: 0 = float32, 1 = bfloat16; table is nullptr for a
// contiguous cache (n_tab = page_size = 0), else the (B, n_tab) int32 page
// table with S = n_tab * page_size. Returns a cudaError_t.
extern "C" int loki_block_sparse_attention_grouped(
    const void* q, const void* k, const void* v, const void* blk_idx,
    const void* cur_len, const void* table, void* out, int q_bf16,
    int kv_bf16, int B, int S, int Hkv, int G, int W, int D, int bs,
    int n_sel, int n_tab, int page_size, float scale, int sliding_window,
    void* stream) {
  const Launch a{q, k, v, blk_idx, cur_len, table, out, B, S, Hkv, G, W, D,
                 bs, n_sel, n_tab, page_size, scale, sliding_window,
                 static_cast<cudaStream_t>(stream), nullptr, 0};
  if (!a.ok() || n_sel < 1) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Grouped>(q_bf16, kv_bf16, a);
}

// Full decode: part is the (B, Hkv, n_split, G, D + 2) float32 scratch,
// 1 <= n_split <= S / bs.
extern "C" int loki_full_decode(const void* q, const void* k, const void* v,
                                const void* cur_len, const void* table,
                                void* out, void* part, int q_bf16,
                                int kv_bf16, int B, int S, int Hkv, int G,
                                int W, int D, int bs, int n_tab,
                                int page_size, int n_split, float scale,
                                int sliding_window, void* stream) {
  const Launch a{q, k, v, nullptr, cur_len, table, out, B, S, Hkv, G, W, D,
                 bs, 0, n_tab, page_size, scale, sliding_window,
                 static_cast<cudaStream_t>(stream), static_cast<float*>(part),
                 n_split};
  if (!a.ok() || part == nullptr || n_split < 1 || n_split > S / bs)
    return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Full>(q_bf16, kv_bf16, a);
}

// The per-head kernel: q (BH, D); k̂ element (r, s, f) at k + r * k_row +
// s * k_tok + f * k_feat (token-major: k_tok = D, k_feat = 1; the
// feature-major K̂ᵀ (BH, D, S): k_tok = 1, k_feat = S); v (BH, S, D)
// contiguous; blk_idx (BH, n_sel) int32; out (BH, D). Returns a
// cudaError_t.
extern "C" int loki_block_sparse_attention(
    const void* q, const void* k, const void* v, const void* blk_idx,
    const void* cur_len, void* out, int q_bf16, int kv_bf16, int BH, int S,
    int D, int bs, int n_sel, long long k_row, long long k_tok,
    long long k_feat, float scale, void* stream) {
  const HeadLaunch a{q, k, v, blk_idx, cur_len, out, BH, S, D, bs, n_sel,
                     k_row, k_tok, k_feat, scale,
                     static_cast<cudaStream_t>(stream)};
  if (!a.ok()) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<PerHead>(q_bf16, kv_bf16, a);
}
