// Shared device code of the Loki decode kernels (fused_decode.cu,
// gather_attention.cu): float conversion, warp reductions, the logical
// block -> cache row map, the one-CTA score -> select phase and exact
// attention phase over a list (or a range) of KV blocks (select_blocks,
// block_sparse_attention_grouped), and the split-KV streaming body that
// the full decode and the fused cluster kernels share: a per-warp
// cp.async ring over 4-token chunks of any token ranges, a per-warp online
// softmax, the 4-warp log-sum-exp merge and the log-sum-exp merge of
// per-CTA partials.
//
// Layout (the JAX package's model-native one):
//   q_hat  (B, Hkv, G, W)   grouped PCA-basis queries, W = stored key width
//   k_hat  (B, S, Hkv, W)   key cache in the PCA basis, or the paged pool
//                           (R, Hkv, W) read through a page table
//   v      (B, S, Hkv, D)   value cache, or the pool (R, Hkv, D)
// The one-CTA phases stage every value as float32 in shared memory; the
// split-KV rings copy cache rows as they are stored (fp32 or bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace loki {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXG = 16;          // query heads per KV group
constexpr int MAXDIM = 256;       // key / value width (gemma-7b: 256)
constexpr int PER_LANE = MAXDIM / 32;
constexpr int TOK_UNROLL = 4;     // key rows in flight per warp (attention)
constexpr int V_UNROLL = 8;       // value rows in flight per thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// four consecutive elements; the caller guarantees 16 B (fp32) or 8 B
// (bf16) alignment
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = c.x; o[3] = c.y;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// qs[g*W + w] = q[g*W + w] * scale for this (b, h)'s (G, W) query tile
template <typename TQ>
__device__ void load_query(const TQ* __restrict__ q, float* qs, int n,
                           float scale) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) qs[i] = to_f(q[i]) * scale;
}

// Where logical KV block ``blk`` of batch row ``b`` starts, as a cache row
// (token) index. A contiguous cache (table == nullptr) holds it at
// b * S + blk * bs. A paged pool holds it through the page table,
// table[b, blk / bpp] * page_size + (blk % bpp) * bs with bpp = page_size /
// bs (JAX fused_decode.py:152-160, gather_attention.py:418-423): pages are a
// whole number of blocks, so a block never straddles two pages. Both forms
// run the same kernel body, so paged output is bit-identical to contiguous
// output on the same logical data. Offsets are 64-bit: a pool of 4,096
// 128-token pages at llama2-7b's width (R * Hkv * W elements) passes 2^31.
struct BlockRows {
  const int* table;   // (B, n_tab) int32 page ids, or nullptr
  int n_tab;          // pages per table row
  int bpp;            // kernel blocks per page
  int S;              // contiguous cache length per batch row
  int bs;             // tokens per kernel block

  __device__ __forceinline__ int64_t first_row(int b, int blk) const {
    if (table == nullptr) return (int64_t)b * S + (int64_t)blk * bs;
    const int page = table[(int64_t)b * n_tab + blk / bpp];
    return ((int64_t)page * bpp + blk % bpp) * bs;
  }
};

// The host-side checks and BlockRows of a launch: S is the logical length,
// n_tab * page_size when paged. False when a paged launch's blocks would
// straddle pages or its table does not cover S.
inline bool rows_ok(const void* table, int n_tab, int page_size, int S,
                    int bs) {
  return table == nullptr || (page_size > 0 && page_size % bs == 0 &&
                              n_tab >= 1 && S == n_tab * page_size);
}
inline BlockRows make_rows(const void* table, int n_tab, int page_size,
                           int S, int bs) {
  return BlockRows{static_cast<const int*>(table), n_tab,
                   table ? page_size / bs : 1, S, bs};
}

// Phases 1-2 of the TPU kernel's _score_and_select.
//
// Phase 1 streams the leading-d slice of every live block's keys. A warp
// takes one block, each lane one token at a time, and reads the token's d
// contiguous features itself (d = 32 fp32 is one 128 B line). The score of
// a token is the max over the G heads of q̂[:d]·k̂[:d]; positions outside
// cur_len (or the sliding window) are NEG_INF, and the local window's live
// positions get +1e4. Only the block maximum survives, in scores[nb].
// Streaming stops at the last live block, ceil(cur_len / bs): dead blocks
// are all NEG_INF and can never be selected.
//
// Phase 2: warp 0 runs k_blocks rounds of argmax-and-suppress over
// scores[] (ties to the lower index, lax.top_k's order) and writes the
// winners to sel[], or -1 once no block with a finite maximum is left.
template <typename TK>
__device__ void score_and_select(const TK* __restrict__ k, const float* qs,
                                 float* scores, int* sel,
                                 const BlockRows& rows, int b, int h, int ln,
                                 int Hkv, int G, int W, int d, int bs, int nb,
                                 int kb, int local_window, int sliding_window,
                                 bool vec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < nb; j += blockDim.x) scores[j] = NEG_INF;
  const int lo = sliding_window > 0 ? max(ln - sliding_window, 0) / bs : 0;
  const int hi = min(nb, (ln + bs - 1) / bs);
  __syncthreads();

  for (int j = lo + warp; j < hi; j += NWARPS) {
    float best = NEG_INF;
    const int64_t row0 = rows.first_row(b, j);
    for (int i = lane; i < bs; i += 32) {
      const int pos = j * bs + i;
      bool live = pos < ln;
      if (sliding_window > 0) live = live && pos >= ln - sliding_window;
      if (!live) continue;
      const TK* row = k + ((row0 + i) * Hkv + h) * (int64_t)W;
      float acc[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
      if (vec) {
        for (int f = 0; f < d; f += 4) {
          float kv[4];
          load4(row + f, kv);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              const float* qg = qs + g * W + f;
              acc[g] = fmaf(qg[0], kv[0], acc[g]);
              acc[g] = fmaf(qg[1], kv[1], acc[g]);
              acc[g] = fmaf(qg[2], kv[2], acc[g]);
              acc[g] = fmaf(qg[3], kv[3], acc[g]);
            }
          }
        }
      } else {
        for (int f = 0; f < d; ++f) {
          const float kv = to_f(row[f]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) acc[g] = fmaf(qs[g * W + f], kv, acc[g]);
        }
      }
      float s = NEG_INF;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) s = fmaxf(s, acc[g]);
      // max(a + c, b + c) == max(a, b) + c under monotone rounding, so the
      // boost after the group max equals the TPU kernel's boost before it
      if (local_window > 0 && pos >= ln - local_window) s += 1e4f;
      best = fmaxf(best, s);
    }
    best = warp_max(best);
    if (lane == 0) scores[j] = best;
  }
  __syncthreads();

  if (warp == 0) {
    bool exhausted = false;
    for (int t = 0; t < kb; ++t) {
      float bv = NEG_INF;
      int bi = 0x7fffffff;
      if (!exhausted) {
        for (int j = lane; j < nb; j += 32) {
          const float v = scores[j];
          if (v > bv || (v == bv && j < bi)) { bv = v; bi = j; }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(FULL, bv, o);
          const int oi = __shfl_xor_sync(FULL, bi, o);
          if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
        }
      }
      const bool valid = !exhausted && bv > NEG_INF * 0.5f;
      if (lane == 0) {
        sel[t] = valid ? bi : -1;
        if (valid) scores[bi] = NEG_INF;
      }
      exhausted = !valid;
      __syncwarp();
    }
  }
  __syncthreads();
}

// Exact attention over the blocks listed in sel[0..n) (-1 entries skipped;
// they contribute exactly nothing in the TPU kernels too), or, when sel is
// nullptr, over the range first .. first + n - 1, folded into a (G,)-wide
// online softmax with the TPU kernels' m_safe / alpha guards.
//
// Per block: a warp takes TOK_UNROLL tokens and its lanes read each token's
// W key features (coalesced), giving the G scores by warp sums; a warp per head
// then updates the running max and sum and turns the scores into weights;
// finally thread (split, col) accumulates weight * v[token][col] for the
// tokens i = split (mod nsplit) into registers, G accumulators each. The
// nsplit partial sums meet in shared memory at the end.
//
// Shared scratch: sc[G*bs], m_s[G], l_s[G], alpha_s[G], red[nsplit*G*D].
template <typename TK, typename TQ>
__device__ void attend_blocks(const TK* __restrict__ k,
                              const TK* __restrict__ v, const float* qs,
                              const int* sel, int first, int n, float* sc,
                              float* m_s, float* l_s, float* alpha_s,
                              float* red, TQ* __restrict__ out,
                              const BlockRows& rows, int b, int h, int ln,
                              int Hkv, int G, int W, int D, int bs,
                              int sliding_window) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nsplit = blockDim.x / D;
  const int col = tid % D, split = tid / D;
  const bool owns = split < nsplit;
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    const int blk = sel != nullptr ? sel[t] : first + t;
    if (blk < 0) continue;            // the same value in every thread
    const int64_t row0 = rows.first_row(b, blk);

    // TOK_UNROLL tokens per warp at a time: their loads are all in flight
    // before the first reduction waits on one
    for (int i0 = warp * TOK_UNROLL; i0 < bs; i0 += NWARPS * TOK_UNROLL) {
      float kr[TOK_UNROLL][PER_LANE];
      bool live[TOK_UNROLL];
#pragma unroll
      for (int u = 0; u < TOK_UNROLL; ++u) {
        const int i = i0 + u, pos = blk * bs + i;
        live[u] = i < bs && pos < ln &&
                  (sliding_window <= 0 || pos >= ln - sliding_window);
        const TK* row = k + ((row0 + i) * Hkv + h) * (int64_t)W;
#pragma unroll
        for (int m = 0; m < PER_LANE; ++m) {
          const int f = lane + 32 * m;
          kr[u][m] = (live[u] && f < W) ? to_f(row[f]) : 0.f;
        }
      }
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int u = 0; u < TOK_UNROLL; ++u) {
          float p = 0.f;
#pragma unroll
          for (int m = 0; m < PER_LANE; ++m) {
            const int f = lane + 32 * m;
            if (f < W) p = fmaf(qs[g * W + f], kr[u][m], p);
          }
          p = warp_sum(p);
          if (lane == 0 && i0 + u < bs)
            sc[g * bs + i0 + u] = live[u] ? p : NEG_INF;
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      float bm = NEG_INF;
      for (int i = lane; i < bs; i += 32) bm = fmaxf(bm, sc[g * bs + i]);
      bm = warp_max(bm);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, bm);
      // guard: a selected block with no live position and an empty
      // accumulator must not produce exp(NEG_INF - NEG_INF)
      const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      const float alpha =
          m_prev > NEG_INF * 0.5f ? expf(fminf(m_prev - m_safe, 0.f)) : 0.f;
      float sum = 0.f;
      for (int i = lane; i < bs; i += 32) {
        const float s = sc[g * bs + i];
        const float p = s > NEG_INF * 0.5f ? expf(s - m_safe) : 0.f;
        sc[g * bs + i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    if (owns) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      // positions past cur_len have p == 0: stop there; V_UNROLL rows
      // per thread are loaded before any is used
      const int n_live = max(0, min(bs, ln - blk * bs));
      const TK* vb = v + (row0 * Hkv + h) * (int64_t)D + col;
      for (int i0 = split; i0 < n_live; i0 += nsplit * V_UNROLL) {
        float vv[V_UNROLL];
#pragma unroll
        for (int u = 0; u < V_UNROLL; ++u) {
          const int i = i0 + u * nsplit;
          vv[u] = i < n_live ? to_f(vb[(int64_t)i * Hkv * D]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < V_UNROLL; ++u) {
          const int i = i0 + u * nsplit;
          if (i < n_live) {
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
              if (g < G) acc[g] = fmaf(sc[g * bs + i], vv[u], acc[g]);
          }
        }
      }
    }
    __syncthreads();                  // sc is rewritten by the next block
  }

  if (owns) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) red[(split * G + g) * D + col] = acc[g];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, c = idx % D;
    float a = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) a += red[(sp * G + g) * D + c];
    store_f(out + idx, a / fmaxf(l_s[g], 1e-30f));
  }
}

// ------------------------------------------------ split-KV streaming body

constexpr int SPLIT_WARPS = 4;
constexpr int SPLIT_THREADS = 32 * SPLIT_WARPS;
constexpr int SPLIT_TOK = 4;          // tokens per warp and ring stage
constexpr int SPLIT_STAGES = 2;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// one warp's ring stage: SPLIT_TOK rows of K̂ then of V in the cache dtype,
// rows padded to 4 elements
template <typename TK>
__host__ __device__ inline size_t split_stage_bytes(int W, int D) {
  return round16((size_t)SPLIT_TOK * (pad4(W) + pad4(D)) * sizeof(TK));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy the K̂ and V rows of tokens pos0 .. pos0 + SPLIT_TOK - 1 (those below
// t1) into a warp's ring stage, then commit one cp.async group (empty when
// nothing was issued, so the group count stays in step). The tokens' cache
// rows are resolved first, walking the blocks, so a paged chunk does one
// page-table read per block it touches, before any copy is issued.
template <typename TK>
__device__ void split_fill(uint8_t* stage, const TK* __restrict__ k,
                           const TK* __restrict__ v, const BlockRows& rows,
                           int b, int h, int Hkv, int W, int D, int bs,
                           int pos0, int t1, bool vec, int lane) {
  TK* ks = reinterpret_cast<TK*>(stage);
  TK* vs = ks + SPLIT_TOK * pad4(W);
  const int n_tok = min(SPLIT_TOK, t1 - pos0);
  int64_t rk[SPLIT_TOK];              // (cache row) * Hkv + h per token
  int blk = pos0 / bs, off = pos0 % bs;
  int64_t base = rows.first_row(b, blk);
#pragma unroll
  for (int u = 0; u < SPLIT_TOK; ++u) {
    if (off == bs) {
      ++blk;
      off = 0;
      if (u < n_tok) base = rows.first_row(b, blk);
    }
    rk[u] = (base + off++) * Hkv + h;
  }
  if (vec) {
    constexpr int E = 16 / sizeof(TK);             // elements per 16 B
    const int kp = W / E, vp = D / E;
#pragma unroll
    for (int u = 0; u < SPLIT_TOK; ++u) {
      if (u >= n_tok) break;
      for (int i = lane; i < kp; i += 32)
        cp_async16(ks + u * W + i * E, k + rk[u] * W + i * E);
      for (int i = lane; i < vp; i += 32)
        cp_async16(vs + u * D + i * E, v + rk[u] * D + i * E);
    }
  } else {
    const int Wp = pad4(W), Dp = pad4(D);
#pragma unroll
    for (int u = 0; u < SPLIT_TOK; ++u) {
      if (u >= n_tok) break;
      for (int c = lane; c < Wp; c += 32)
        store_f(ks + u * Wp + c, c < W ? to_f(k[rk[u] * W + c]) : 0.f);
      for (int c = lane; c < Dp; c += 32)
        store_f(vs + u * Dp + c, c < D ? to_f(v[rk[u] * D + c]) : 0.f);
    }
  }
  cp_async_commit();
}

// One warp's online softmax: the (G,) running max and sum and the (G, D)
// accumulators, lane-held columns 4 * lane + 128 * jj. GM >= G query heads
// per group, DC = column groups of 4 per lane (1 for D <= 128, 2 for
// D <= 256).
template <int GM, int DC>
struct WarpSoftmax {
  float m[GM], l[GM], acc[GM][4 * DC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 4 * DC; ++e) acc[g][e] = 0.f;
    }
  }
};

// Stream a warp's ``my_n`` chunks through its two-stage ring and fold each
// into ``st``. ``chunk_at(j)`` gives the warp's j-th chunk as int2 {first
// token, end of its range}: the chunk is tokens first .. first +
// SPLIT_TOK - 1 below the end. The next chunk's K̂ and V rows are in flight
// (16-byte cp.async) while the warp computes on this one; no CTA barrier in
// the loop. qs: the scaled float32 query, G x Wp. Ends with every copy
// landed; the caller synchronises the CTA before reusing the ring.
template <typename TK, int GM, int DC, typename ChunkAt>
__device__ __forceinline__ void stream_chunks(
    WarpSoftmax<GM, DC>& st, const float* qs, uint8_t* my_ring,
    size_t stage_bytes, const TK* __restrict__ k, const TK* __restrict__ v,
    const BlockRows& rows, int b, int h, int Hkv, int G, int W, int D, int bs,
    int my_n, ChunkAt chunk_at, bool vec, int lane) {
  const int Wp = pad4(W), Dp = pad4(D);
#pragma unroll
  for (int j = 0; j < SPLIT_STAGES - 1; ++j) {
    if (j < my_n) {
      const int2 c = chunk_at(j);
      split_fill(my_ring + j * stage_bytes, k, v, rows, b, h, Hkv, W, D, bs,
                 c.x, c.y, vec, lane);
    } else {
      cp_async_commit();
    }
  }

  for (int j = 0; j < my_n; ++j) {
    const int jn = j + SPLIT_STAGES - 1;             // the chunk to prefetch
    if (jn < my_n) {
      const int2 c = chunk_at(jn);
      split_fill(my_ring + (jn % SPLIT_STAGES) * stage_bytes, k, v, rows, b,
                 h, Hkv, W, D, bs, c.x, c.y, vec, lane);
    } else {
      cp_async_commit();
    }
    cp_async_wait<SPLIT_STAGES - 1>();
    __syncwarp();

    const TK* ks =
        reinterpret_cast<const TK*>(my_ring + (j % SPLIT_STAGES) * stage_bytes);
    const TK* vs = ks + SPLIT_TOK * Wp;
    const int2 cj = chunk_at(j);
    const int n_tok = min(SPLIT_TOK, cj.y - cj.x);  // >= 1
    float sc[GM][SPLIT_TOK];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float qf[4 * DC];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int c = 4 * lane + 128 * jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[4 * jj + e] = 0.f;
        if (c < Wp) load4(qs + g * Wp + c, qf + 4 * jj);
      }
#pragma unroll
      for (int u = 0; u < SPLIT_TOK; ++u) {
        float p = 0.f;
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          const int c = 4 * lane + 128 * jj;
          if (c < Wp) {
            float kv[4];
            load4(ks + u * Wp + c, kv);
#pragma unroll
            for (int e = 0; e < 4; ++e) p = fmaf(qf[4 * jj + e], kv[e], p);
          }
        }
        p = warp_sum(p);
        sc[g][u] = u < n_tok ? p : NEG_INF;
      }
      // online softmax of head g over the chunk (the TPU kernel's guards)
      float bm = NEG_INF;
#pragma unroll
      for (int u = 0; u < SPLIT_TOK; ++u) bm = fmaxf(bm, sc[g][u]);
      const float m_new = fmaxf(st.m[g], bm);
      const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      const float alpha =
          st.m[g] > NEG_INF * 0.5f ? expf(fminf(st.m[g] - m_safe, 0.f)) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < SPLIT_TOK; ++u) {
        const float x = sc[g][u];
        const float p = x > NEG_INF * 0.5f ? expf(x - m_safe) : 0.f;
        sc[g][u] = p;
        sum += p;
      }
      st.l[g] = st.l[g] * alpha + sum;
      st.m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * DC; ++e) st.acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < SPLIT_TOK; ++u) {
      if (u >= n_tok) break;          // rows past the end hold stale bytes
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int c = 4 * lane + 128 * jj;
        if (c < Dp) {
          float vv[4];
          load4(vs + u * Dp + c, vv);
#pragma unroll
          for (int g = 0; g < GM; ++g)
            if (g < G)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                st.acc[g][4 * jj + e] =
                    fmaf(sc[g][u], vv[e], st.acc[g][4 * jj + e]);
        }
      }
    }
    __syncwarp();                     // the stage is refilled next round
  }
  cp_async_wait<0>();
}

// The SPLIT_WARPS warps' states by log-sum-exp into one partial, written
// to ``out`` (G rows of acc[D], m, l; global or shared memory). mw is
// SPLIT_WARPS x G x (D + 2) floats of shared scratch (the ring, once the
// caller has synchronised the CTA after stream_chunks).
template <int GM, int DC>
__device__ __forceinline__ void merge_warps(const WarpSoftmax<GM, DC>& st,
                                            float* mw, float* out, int G,
                                            int D) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    float* dst = mw + (warp * G + g) * (D + 2);
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * lane + 128 * jj + e;
        if (c < D) dst[c] = st.acc[g][4 * jj + e];
      }
    if (lane == 0) {
      dst[D] = st.m[g];
      dst[D + 1] = st.l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * (D + 2); i += SPLIT_THREADS) {
    const int g = i / (D + 2), c = i % (D + 2);
    float mx = NEG_INF;
    for (int w = 0; w < SPLIT_WARPS; ++w)
      mx = fmaxf(mx, mw[(w * G + g) * (D + 2) + D]);
    const float m_safe = mx <= NEG_INF * 0.5f ? 0.f : mx;
    float a = 0.f;
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float* src = mw + (w * G + g) * (D + 2);
      const float wt =
          src[D] > NEG_INF * 0.5f ? expf(fminf(src[D] - m_safe, 0.f)) : 0.f;
      a += wt * src[c == D ? D + 1 : c];
    }
    out[i] = c == D ? mx : a;       // c == D + 1 sums l
  }
}

// Output (g, c) of ``n`` partials merged by log-sum-exp in order s = 0 ..
// n - 1: ``part(s)`` points at partial s (G rows of acc[D], m, l).
// alpha = 0 for an empty partial (m = -1e30), the 1e-30 floor on the sum.
template <typename PartAt>
__device__ __forceinline__ float merge_partials(PartAt part, int n, int g,
                                                int c, int D) {
  float mx = NEG_INF;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, part(s)[g * (D + 2) + D]);
  const float m_safe = mx <= NEG_INF * 0.5f ? 0.f : mx;
  float a = 0.f, den = 0.f;
  for (int s = 0; s < n; ++s) {
    const float* src = part(s) + g * (D + 2);
    const float wt =
        src[D] > NEG_INF * 0.5f ? expf(fminf(src[D] - m_safe, 0.f)) : 0.f;
    a += wt * src[c];
    den += wt * src[D + 1];
  }
  return a / fmaxf(den, 1e-30f);
}

// The live block range [lo, hi) of a row (the sliding window's first block
// .. ceil(cur_len / bs)) and share ``s`` of ``n`` equal shares of it,
// [first, end): ceil((hi - lo) / n) blocks each, trailing shares possibly
// empty. The host's kernels/gather_attention.py split_blocks repeats it.
struct BlockShare {
  int lo, hi, per, first, end;
};
__device__ __forceinline__ BlockShare block_share(int ln, int nb, int bs,
                                                  int sliding_window, int s,
                                                  int n) {
  BlockShare r;
  r.lo = sliding_window > 0 ? max(ln - sliding_window, 0) / bs : 0;
  r.hi = min(nb, (ln + bs - 1) / bs);
  r.per = (max(r.hi - r.lo, 0) + n - 1) / n;
  r.first = r.lo + s * r.per;
  r.end = min(r.hi, r.first + r.per);
  return r;
}

// Run F<TQ, TK>::run(a) for the launch's (query, cache) dtype pair:
// 0 = float32, 1 = bfloat16.
template <template <typename, typename> class F, typename Args>
cudaError_t by_dtype(int q_bf16, int kv_bf16, const Args& a) {
  if (q_bf16 && kv_bf16) return F<__nv_bfloat16, __nv_bfloat16>::run(a);
  if (q_bf16) return F<__nv_bfloat16, float>::run(a);
  if (kv_bf16) return F<float, __nv_bfloat16>::run(a);
  return F<float, float>::run(a);
}

// Dynamic shared memory above 48 KB needs the opt-in attribute.
template <typename Kern>
inline cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace loki
