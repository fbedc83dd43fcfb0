// Shared device code of the Loki decode kernels (fused_decode.cu,
// gather_attention.cu, approx_scores.cu): float conversion, warp
// reductions, the logical block -> cache row map, the score stream (a
// per-warp cp.async ring of token rows, lane i scoring token i, block
// maxima by an exact shared atomic max) and the cluster select that the
// fused kernels, select_blocks and block_max_scores run, and the split-KV
// streaming body that every attention kernel shares: a per-warp cp.async
// ring over small chunks of any token ranges, a per-warp online softmax,
// the 4-warp log-sum-exp merge, the log-sum-exp merge of per-CTA partials,
// and attend_share, the attention over a list of blocks by one
// thread-block cluster (the fused kernels' phases 3-4,
// block_sparse_attention_grouped and block_sparse_attention), with the
// host's cluster-size rule and residency query.
//
// Layout (the JAX package's model-native one):
//   q_hat  (B, Hkv, G, W)   grouped PCA-basis queries, W = stored key width
//   k_hat  (B, S, Hkv, W)   key cache in the PCA basis, or the paged pool
//                           (R, Hkv, W) read through a page table
//   v      (B, S, Hkv, D)   value cache, or the pool (R, Hkv, D)
// The rings copy cache rows as they are stored.
//
// Storage: fp32, bf16 and fp16 caches hold values; int8 and fp8-e4m3
// (quantized page layouts) hold codes with one float32 scale per pool page
// for K and one for V (BlockRows::ksc, vsc; paged only). Every kernel
// dequantizes a row as it reads it: code -> float32 * page scale, element
// by element, then the dot (and V likewise before p·V), the order the TPU
// kernels use (repro/kernels/fused_decode.py:104-108). The rings copy the
// codes as raw bytes; a stage of the split-KV ring carries its tokens' K
// and V scales beside the rows, the score ring the block's K scale in the
// padding of its first row.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace loki {

namespace cg = cooperative_groups;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXG = 16;          // query heads per KV group
constexpr int MAXDIM = 256;       // key / value width (gemma-7b: 256)
constexpr unsigned FULL = 0xffffffffu;

// Whether a storage type holds codes with per-page scales.
template <typename TK>
struct Store {
  static constexpr bool scaled = false;
};
template <>
struct Store<int8_t> {
  static constexpr bool scaled = true;
};
template <>
struct Store<__nv_fp8_e4m3> {
  static constexpr bool scaled = true;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_f(__half* p, float x) {
  *p = __float2half_rn(x);
}

// two fp8-e4m3 codes (the low byte first) as float32
__device__ __forceinline__ float2 fp8x2_to_f2(uint32_t u) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(u & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}
// four int8 codes of a 32-bit word (the low byte first) as float32
__device__ __forceinline__ void i8x4_to_f(uint32_t u, float* o) {
  const char4 c = *reinterpret_cast<const char4*>(&u);
  o[0] = (float)c.x; o[1] = (float)c.y; o[2] = (float)c.z; o[3] = (float)c.w;
}

// four consecutive elements; the caller guarantees their alignment (16 B
// fp32, 8 B bf16 / fp16, 4 B int8 / fp8)
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
__device__ __forceinline__ void load4(const __half* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 c = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = c.x; o[3] = c.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  i8x4_to_f(*reinterpret_cast<const uint32_t*>(p), o);
}
__device__ __forceinline__ void load4(const __nv_fp8_e4m3* p, float* o) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  const float2 a = fp8x2_to_f2(u), c = fp8x2_to_f2(u >> 16);
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
// A quantized pool also gives each block its page's K and V scales (ksc,
// vsc: (n_pages,) float32, one per physical page; null otherwise).
struct BlockRows {
  const int* table;   // (B, n_tab) int32 page ids, or nullptr
  int n_tab;          // pages per table row
  int bpp;            // kernel blocks per page
  int S;              // contiguous cache length per batch row
  int bs;             // tokens per kernel block
  const float* ksc;   // per-page K scales (scaled storage), or nullptr
  const float* vsc;   // per-page V scales (scaled storage), or nullptr

  // the physical page holding logical block blk of row b (paged only)
  __device__ __forceinline__ int page(int b, int blk) const {
    return table[(int64_t)b * n_tab + blk / bpp];
  }
  __device__ __forceinline__ int64_t first_row(int b, int blk) const {
    if (table == nullptr) return (int64_t)b * S + (int64_t)blk * bs;
    return ((int64_t)page(b, blk) * bpp + blk % bpp) * bs;
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
                           int S, int bs, const void* ksc = nullptr,
                           const void* vsc = nullptr) {
  return BlockRows{static_cast<const int*>(table), n_tab,
                   table ? page_size / bs : 1, S, bs,
                   static_cast<const float*>(ksc),
                   static_cast<const float*>(vsc)};
}

// The launch-time check of a storage type: scaled storage (int8, fp8) is
// paged and comes with its K scales (and V scales, ``need_v``); other
// storage comes without scales; the storage beside fp32 and bf16 (fp16,
// int8, fp8) is copied only in 16-byte pieces, so its rows (``vec``) must
// be whole 16-byte runs.
template <typename TK>
inline bool storage_ok(const void* table, const void* ksc, const void* vsc,
                       bool need_v, bool vec) {
  if (Store<TK>::scaled)
    return table != nullptr && ksc != nullptr && (vsc != nullptr || !need_v) &&
           vec;
  const bool wide = sizeof(TK) == 4 || std::is_same<TK, __nv_bfloat16>::value;
  return ksc == nullptr && vsc == nullptr && (wide || vec);
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

// one warp's ring stage: TOK rows of K̂ then of V in the cache dtype, rows
// padded to 4 elements (a feature-major K̂ stage holds the same elements),
// then for scaled storage the TOK tokens' K scales and their V scales
template <typename TK, int TOK = SPLIT_TOK>
__host__ __device__ inline size_t split_scales_offset(int W, int D) {
  return (size_t)TOK * (pad4(W) + pad4(D)) * sizeof(TK);
}
template <typename TK, int TOK = SPLIT_TOK>
__host__ __device__ inline size_t split_stage_bytes(int W, int D) {
  return round16(split_scales_offset<TK, TOK>(W, D) +
                 (Store<TK>::scaled ? 2 * TOK * sizeof(float) : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
// four bytes (a page scale): cp.async.ca takes 4-, 8- and 16-byte copies
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
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

// sixteen bytes of staged cache row as float32: 4 fp32, 8 bf16 / fp16 or
// 16 int8 / fp8 values
__device__ __forceinline__ void load16(const float* p, float* o) {
  load4(p, o);
}
__device__ __forceinline__ void load16(const __half* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  i8x4_to_f(u.x, o);
  i8x4_to_f(u.y, o + 4);
  i8x4_to_f(u.z, o + 8);
  i8x4_to_f(u.w, o + 12);
}
__device__ __forceinline__ void load16(const __nv_fp8_e4m3* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = fp8x2_to_f2(w[i]), c = fp8x2_to_f2(w[i] >> 16);
    o[4 * i] = a.x;
    o[4 * i + 1] = a.y;
    o[4 * i + 2] = c.x;
    o[4 * i + 3] = c.y;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Copy the K̂ and V rows of tokens pos0 .. pos0 + SPLIT_TOK - 1 (those below
// t1) into a warp's ring stage, then commit one cp.async group (empty when
// nothing was issued, so the group count stays in step). The tokens' cache
// rows are resolved first, walking the blocks, so a paged chunk does one
// page-table read per block it touches, before any copy is issued. Scaled
// storage also copies each token's page scales, K then V (a chunk may
// straddle two pages), 4 bytes each, by lanes 0 .. 2 * SPLIT_TOK - 1; its
// rows always go by 16-byte copies (storage_ok), so it has no element by
// element fill.
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
  int my_page = 0;                    // scaled: lane's token's page
  if constexpr (Store<TK>::scaled) my_page = rows.page(b, blk);
#pragma unroll
  for (int u = 0; u < SPLIT_TOK; ++u) {
    if (off == bs) {
      ++blk;
      off = 0;
      if (u < n_tok) {
        base = rows.first_row(b, blk);
        if constexpr (Store<TK>::scaled)
          if ((lane & (SPLIT_TOK - 1)) >= u) my_page = rows.page(b, blk);
      }
    }
    rk[u] = (base + off++) * Hkv + h;
  }
  if constexpr (Store<TK>::scaled) {
    float* sc = reinterpret_cast<float*>(
        stage + split_scales_offset<TK>(W, D));
    const int u = lane & (SPLIT_TOK - 1);
    if (lane < 2 * SPLIT_TOK && u < n_tok)
      cp_async4(sc + lane,
                (lane < SPLIT_TOK ? rows.ksc : rows.vsc) + my_page);
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
  } else if constexpr (!Store<TK>::scaled) {  // scaled: vec always
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

// A feature-major K̂ stage holds feature f's TOK tokens (one 16-byte piece)
// at piece fm_slot(f). The xor permutes each aligned group of 4 pieces so
// that a quarter-warp's 16-byte reads (features 4 l + e, l = 0 .. 7) fall
// in 8 distinct bank groups.
__host__ __device__ inline int fm_slot(int f) { return f ^ ((f >> 3) & 3); }

// The per-head kernel's fill: tokens pos0 .. pos0 + TOK - 1 (those below
// t1) of one row's K̂ and V into a warp's ring stage, then one cp.async
// group. kr is the row's K̂, element (s, f) at kr[s * k_tok + f * k_feat];
// vr its V, (S, D) contiguous. Token-major K̂ (k_feat = 1) is staged as
// split_fill stages it, one row of pad4(D) elements per token; a
// feature-major K̂ᵀ (FM, k_tok = 1) as one 16-byte piece of TOK tokens per
// feature, each copied straight from its feature row. vec: 16-byte copies
// (the launcher checks the alignment and strides, and for FM that every
// chunk starts on a piece and ends inside the cache); otherwise element by
// element, zero-padded to pad4(D).
template <typename TK, int TOK, bool FM>
__device__ __forceinline__ void head_fill(uint8_t* stage,
                                          const TK* __restrict__ kr,
                                          const TK* __restrict__ vr,
                                          int64_t k_tok, int64_t k_feat,
                                          int D, int pos0, int t1, bool vec,
                                          int lane) {
  const int Dp = pad4(D);
  TK* ks = reinterpret_cast<TK*>(stage);
  TK* vs = ks + TOK * Dp;
  const int n_tok = min(TOK, t1 - pos0);
  constexpr int E = 16 / sizeof(TK);
  if (vec) {
    if constexpr (FM) {
      for (int f = lane; f < D; f += 32)
        cp_async16(ks + fm_slot(f) * TOK, kr + f * k_feat + pos0);
    } else {
      for (int u = 0; u < n_tok; ++u)
        for (int i = lane; i < D / E; i += 32)
          cp_async16(ks + u * Dp + i * E,
                     kr + (int64_t)(pos0 + u) * k_tok + i * E);
    }
    for (int u = 0; u < n_tok; ++u)
      for (int i = lane; i < D / E; i += 32)
        cp_async16(vs + u * Dp + i * E, vr + (int64_t)(pos0 + u) * D + i * E);
  } else {
    if constexpr (FM) {
      for (int i = lane; i < Dp * TOK; i += 32) {
        const int f = i / TOK, u = i % TOK;
        store_f(ks + fm_slot(f) * TOK + u,
                f < D && u < n_tok ? to_f(kr[f * k_feat + pos0 + u]) : 0.f);
      }
    } else {
      for (int u = 0; u < n_tok; ++u)
        for (int c = lane; c < Dp; c += 32)
          store_f(ks + u * Dp + c,
                  c < D ? to_f(kr[(int64_t)(pos0 + u) * k_tok + c]) : 0.f);
    }
    for (int u = 0; u < n_tok; ++u)
      for (int c = lane; c < Dp; c += 32)
        store_f(vs + u * Dp + c,
                c < D ? to_f(vr[(int64_t)(pos0 + u) * D + c]) : 0.f);
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
// token, end of its range}: the chunk is tokens first .. first + TOK - 1
// below the end; ``fill(stage, first, end)`` copies it into a stage and
// commits one cp.async group. The next chunk's K̂ and V rows are in flight
// (16-byte cp.async) while the warp computes on this one; no CTA barrier in
// the loop. qs: the float32 query, G x Wp. A token's score is the warp sum
// of q·k̂ over the lanes' columns, each lane summing its 4 (8) columns in
// order, times ``dot_scale`` when SCALE_DOT (the per-head kernel scales
// after the dot, as its TPU kernel does; the others pass a scaled query).
// FM: the K̂ stage is feature-major (head_fill); the lanes then read their
// features' pieces and sum in the same order, so both layouts give the
// same bits. Scaled storage: each K and V element is multiplied by its
// token's page scale (from the stage) before the dot and before p·V. Ends
// with every copy landed; the caller synchronises the CTA before reusing
// the ring.
template <typename TK, int TOK = SPLIT_TOK, bool FM = false,
          bool SCALE_DOT = false, int GM, int DC, typename ChunkAt,
          typename Fill>
__device__ __forceinline__ void stream_chunks(
    WarpSoftmax<GM, DC>& st, const float* qs, uint8_t* my_ring,
    size_t stage_bytes, int G, int W, int D, int my_n, ChunkAt chunk_at,
    Fill fill, float dot_scale, int lane) {
  static_assert(!FM || TOK * sizeof(TK) == 16,
                "a feature's chunk is one 16-byte piece");
  const int Wp = pad4(W), Dp = pad4(D);
#pragma unroll
  for (int j = 0; j < SPLIT_STAGES - 1; ++j) {
    if (j < my_n) {
      const int2 c = chunk_at(j);
      fill(my_ring + j * stage_bytes, c.x, c.y);
    } else {
      cp_async_commit();
    }
  }

  for (int j = 0; j < my_n; ++j) {
    const int jn = j + SPLIT_STAGES - 1;             // the chunk to prefetch
    if (jn < my_n) {
      const int2 c = chunk_at(jn);
      fill(my_ring + (jn % SPLIT_STAGES) * stage_bytes, c.x, c.y);
    } else {
      cp_async_commit();
    }
    cp_async_wait<SPLIT_STAGES - 1>();
    __syncwarp();

    const TK* ks =
        reinterpret_cast<const TK*>(my_ring + (j % SPLIT_STAGES) * stage_bytes);
    const TK* vs = ks + TOK * Wp;
    // scaled storage: the TOK tokens' K scales, then their V scales
    const float* ssc = reinterpret_cast<const float*>(
        reinterpret_cast<const uint8_t*>(ks) +
        split_scales_offset<TK, TOK>(W, D));
    const int2 cj = chunk_at(j);
    const int n_tok = min(TOK, cj.y - cj.x);        // >= 1
    // feature-major: this lane's 4 * DC features, TOK tokens each
    float kf[FM ? DC : 1][4][FM ? TOK : 1];
    if constexpr (FM) {
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int c = 4 * lane + 128 * jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c < Wp) {
            load16(ks + fm_slot(c + e) * TOK, kf[jj][e]);
          } else {
#pragma unroll
            for (int u = 0; u < TOK; ++u) kf[jj][e][u] = 0.f;
          }
        }
      }
    }
    float sc[GM][TOK];
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
      for (int u = 0; u < TOK; ++u) {
        float p = 0.f;
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          const int c = 4 * lane + 128 * jj;
          if (c < Wp) {
            float kv[4];
            if constexpr (FM) {
#pragma unroll
              for (int e = 0; e < 4; ++e) kv[e] = kf[jj][e][u];
            } else {
              load4(ks + u * Wp + c, kv);
            }
            if constexpr (Store<TK>::scaled) {
#pragma unroll
              for (int e = 0; e < 4; ++e) kv[e] *= ssc[u];
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) p = fmaf(qf[4 * jj + e], kv[e], p);
          }
        }
        p = warp_sum(p);
        if constexpr (SCALE_DOT) p *= dot_scale;
        sc[g][u] = u < n_tok ? p : NEG_INF;
      }
      // online softmax of head g over the chunk (the TPU kernel's guards)
      float bm = NEG_INF;
#pragma unroll
      for (int u = 0; u < TOK; ++u) bm = fmaxf(bm, sc[g][u]);
      const float m_new = fmaxf(st.m[g], bm);
      const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      const float alpha =
          st.m[g] > NEG_INF * 0.5f ? expf(fminf(st.m[g] - m_safe, 0.f)) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < TOK; ++u) {
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
    for (int u = 0; u < TOK; ++u) {
      if (u >= n_tok) break;          // rows past the end hold stale bytes
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int c = 4 * lane + 128 * jj;
        if (c < Dp) {
          float vv[4];
          load4(vs + u * Dp + c, vv);
          if constexpr (Store<TK>::scaled) {
#pragma unroll
            for (int e = 0; e < 4; ++e) vv[e] *= ssc[TOK + u];
          }
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

// ---------------------------------- the score stream and the cluster select

// Phases 1-2 of the TPU kernels' _score_and_select, shared by the fused
// cluster kernels, the select_blocks cluster kernel (fused_decode.cu) and
// the per-head block_max_scores (approx_scores.cu), so all give one set of
// block maxima bits.

constexpr int SCORE_STAGES = 2;
constexpr int SCORE_MAX_TOK = 32;     // one token per lane
// a score stage: 32 tokens of d = 32 fp32 (128 B + 16 B of padding each)
constexpr int SCORE_STAGE_BYTES = 32 * 144;
// the H100's per-block dynamic shared memory with the opt-in attribute
constexpr size_t SMEM_LIMIT = 227 * 1024;

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
// summed from 0 in feature order with one fma per feature (scaled storage:
// each code times the block's scale ks first). SCALE_DOT: each head's dot
// times dot_scale before the max (block_max_scores scales after the dot,
// as its TPU kernel does; the others pass a scaled query).
template <typename TK, int GM, bool SCALE_DOT = false>
__device__ __forceinline__ float score_token(const uint8_t* row,
                                             const float* qs, int Wp, int G,
                                             int d, float ks,
                                             float dot_scale) {
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
    if (g < G) s = fmaxf(s, SCALE_DOT ? acc[g] * dot_scale : acc[g]);
  return s;
}

// qs[g * pad4(W) + c] = q[g * W + c] * scale, 0 in the padding, for one
// (b, h)'s (G, W) query tile
template <typename TQ>
__device__ __forceinline__ void load_query_padded(const TQ* __restrict__ q,
                                                  float* qs, int G, int W,
                                                  float scale) {
  const int Wp = pad4(W);
  for (int i = threadIdx.x; i < G * Wp; i += blockDim.x) {
    const int g = i / Wp, c = i % Wp;
    qs[i] = c < W ? to_f(q[g * W + c]) * scale : 0.f;
  }
}

// The live tokens [first, end) of a CTA's share of the blocks: from its
// first block (or the sliding window's start, if later) to its last
// block's end or cur_len.
__device__ __forceinline__ int2 share_tokens(const BlockShare& sh, int bs,
                                             int ln, int sliding_window) {
  int t_lo = sh.first * bs;
  if (sliding_window > 0) t_lo = max(t_lo, ln - sliding_window);
  return make_int2(t_lo, min(sh.end * bs, ln));
}

// Phase 1: score the live tokens [t_lo, t_hi) of row (b, h) into the
// block maxima, blkmax[blk - blk0] for block blk (the caller sets them to
// NEG_INF first; they stay so for a block with no token here). The range's
// T-token chunks (T divides bs) go to the 4 warps in turn, warp w taking
// chunks w, w + 4, ...; each warp streams its chunks through its own
// two-stage ring in ``rings`` (SCORE_STAGES x T x rs bytes per warp) of
// 16-byte cp.async copies, lanes across a token's features (d = 32 fp32:
// 8 lanes a token, 4 tokens per warp instruction), the next chunk in
// flight while lane i scores token i of this one from shared memory
// (score_token). The +1e4 local-window boost goes after the group max,
// then a warp max and one exact shared atomic max per chunk. Ends with
// every copy landed; the caller synchronises before reading blkmax.
template <typename TK, int GM, bool SCALE_DOT = false>
__device__ __forceinline__ void score_range(
    const TK* __restrict__ k, const BlockRows& rows, int b, int h, int Hkv,
    int W, int d, int bs, int T, int rs, const float* qs, int Wp, int G,
    float dot_scale, int t_lo, int t_hi, int ln, int local_window,
    float* blkmax, int blk0, uint8_t* rings, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c_first = t_lo / T;
  const int n_ch = t_hi > t_lo ? (t_hi + T - 1) / T - c_first : 0;
  const int my_n =
      n_ch > warp ? (n_ch - warp + SPLIT_WARPS - 1) / SPLIT_WARPS : 0;
  const size_t stage = (size_t)T * rs;
  uint8_t* ring = rings + (size_t)warp * SCORE_STAGES * stage;
  auto chunk = [&](int j) { return c_first + warp + j * SPLIT_WARPS; };
#pragma unroll
  for (int j = 0; j < SCORE_STAGES - 1; ++j) {
    if (j < my_n)
      score_fill(ring + j * stage, k, rows, b, h, Hkv, W, d, bs, T, rs,
                 chunk(j), t_lo, t_hi, vec, lane);
    else
      cp_async_commit();
  }
  for (int j = 0; j < my_n; ++j) {
    const int jn = j + SCORE_STAGES - 1;
    if (jn < my_n)
      score_fill(ring + (jn % SCORE_STAGES) * stage, k, rows, b, h, Hkv, W,
                 d, bs, T, rs, chunk(jn), t_lo, t_hi, vec, lane);
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
      s = score_token<TK, GM, SCALE_DOT>(st + (size_t)lane * rs, qs, Wp, G,
                                         d, ks, dot_scale);
      // max(a + c, b + c) == max(a, b) + c under monotone rounding, so
      // the boost after the group max equals the TPU kernel's boost
      // before it
      if (local_window > 0 && pos >= ln - local_window) s += 1e4f;
    }
    s = warp_max(s);
    if (lane == 0) atomic_max_f(blkmax + c * T / bs - blk0, s);
    __syncwarp();                     // the stage is refilled next round
  }
  cp_async_wait<0>();
}

// (value, index) pairs: the larger value wins, ties to the lower index
__device__ __forceinline__ void argmax_take(float& bv, int& bi, float ov,
                                            int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

// Phase 2 of a cluster kernel, after every CTA scored its share ``sh`` of
// the row's blocks into its own blkmax (score_range): cluster.sync(); each
// CTA assembles the whole row of block maxima in ``row`` from the entries'
// owners through distributed shared memory, then runs the same k_blocks
// rounds of argmax-and-suppress over it (all 4 warps, one CTA barrier a
// round; ties to the lower index), so all C CTAs find the same winners
// with no broadcast. ``row`` is either nb free floats (the fused kernels'
// shared region), or blkmax itself: each CTA then fills in only the
// entries its peers own, and a second cluster.sync() keeps every CTA's
// own entries unsuppressed until its peers have read them. win(t, bi)
// runs in thread 0 for winner t; returns the number of winners with a
// finite maximum (the same in every thread). wv, wi: 2 x 4 (value, index)
// pairs of shared scratch.
template <typename Win>
__device__ __forceinline__ int cluster_select(float* blkmax, float* row,
                                              const BlockShare& sh, int nb,
                                              int kb, float* wv, int* wi,
                                              Win win) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool in_place = row == blkmax;
  cluster.sync();                     // every CTA's block maxima, final
  for (int j = tid; j < nb; j += SPLIT_THREADS) {
    const bool live = j >= sh.lo && j < sh.hi;
    const int owner = live ? (j - sh.lo) / sh.per : rank;
    if (!in_place)
      row[j] = live ? *cluster.map_shared_rank(blkmax + j, owner) : NEG_INF;
    else if (owner != rank)
      row[j] = *cluster.map_shared_rank(blkmax + j, owner);
  }
  if (in_place)
    cluster.sync();                   // every peer's entries read
  else
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
    if (tid == 0) win(t, bi);
  }
  return nv;
}

// Byte offsets of a score kernel's dynamic shared memory (select_blocks;
// block_max_scores at G = 1, W = d): the float32 query (G x pad4(W)), n
// block maxima, the argmax exchange (2 rounds x 4 warps (value, index)),
// then the 4 warps' score rings (SCORE_STAGES stages of tok rows of
// row_bytes). A row too long to fit beside the rings halves the chunk
// until it does (the block maxima do not depend on the chunk).
// kernels/tuning.py select_smem_bytes mirrors it.
struct ScoreLayout {
  size_t qs, blkmax, wsel, ring, total;
  int row_bytes, tok;
};

template <typename TK>
__host__ __device__ inline ScoreLayout score_layout(int G, int W, int d,
                                                    int bs, int n) {
  ScoreLayout L;
  L.row_bytes = score_row_bytes<TK>(d);
  L.tok = score_tokens(L.row_bytes, bs);
  size_t off = 0;
  L.qs = off;
  off += round16(sizeof(float) * G * pad4(W));
  L.blkmax = off;
  off += round16(sizeof(float) * n);
  L.wsel = off;
  off += round16(2 * SPLIT_WARPS * (sizeof(float) + sizeof(int)));
  L.ring = off;
  const size_t per_tok = (size_t)SPLIT_WARPS * SCORE_STAGES * L.row_bytes;
  while (L.tok > 1 && off + per_tok * L.tok > SMEM_LIMIT) L.tok >>= 1;
  L.total = off + per_tok * L.tok;
  return L;
}

// ------------------------------------- attention over a list, one cluster

// The entries of idx[0 .. n) that lie in [0, nb), in list order, into sel
// (warp 0 writes them); every thread returns their count. Other entries
// (the -1 sentinels) contribute nothing. Needs whole warps.
__device__ __forceinline__ int keep_valid(const int* __restrict__ idx, int n,
                                          int nb, int* sel) {
  const int lane = threadIdx.x & 31;
  const bool writer = threadIdx.x < 32;
  int nv = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int x = t0 + lane < n ? idx[t0 + lane] : -1;
    const bool ok = x >= 0 && x < nb;
    const unsigned m = __ballot_sync(FULL, ok);
    if (writer && ok) sel[nv + __popc(m & ((1u << lane) - 1u))] = x;
    nv += __popc(m);
  }
  return nv;
}

// Phases 3-4 of a cluster kernel. CTA r of the C in its cluster attends
// share r of the nv blocks in sel[0 .. nv) (list order, each in [0, nb)):
// entries [r * per, (r + 1) * per), per = ceil(nv / C), trailing shares
// possibly empty. A block's live tokens run from blk * bs (or ln -
// sliding_window, if later) to min(blk * bs + bs, ln). The share's
// TOK-token chunks are numbered block after block and warp w takes chunks
// w, w + 4, ...; a chunk's block is found by walking the share's list (a
// few entries), so no table is built. Each warp streams its chunks
// (stream_chunks) through its ring in ``uni``; the CTA merges its 4 warps
// into its partial (merge_warps; G x (D + 2) float32 after the warps'
// scratch in ``uni``); after cluster.sync() rank 0 reads the C partials
// through distributed shared memory and merges them by log-sum-exp in rank
// order into out (G x D in TQ). A CTA with no chunk adds m = -1e30, l = 0.
// The caller writes sel and the query before the call (the first barrier
// here orders them, and frees ``uni``); the last cluster.sync() keeps the
// peers' partials alive until rank 0 has read them.
template <typename TQ, typename TK, int TOK, bool FM, bool SCALE_DOT, int GM,
          int DC, typename Fill>
__device__ __forceinline__ void attend_share(
    const int* sel, int nv, const float* qs, uint8_t* uni, size_t stage_bytes,
    Fill fill, int ln, int G, int W, int D, int bs, int sliding_window,
    float dot_scale, TQ* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = (nv + C - 1) / C;
  const int s0 = rank * per, n_mine = max(0, min(nv, s0 + per) - s0);
  const int* mine = sel + s0;
  // block blk's live tokens {first, end}
  const auto span = [&](int blk) {
    int t0 = blk * bs;
    if (sliding_window > 0) t0 = max(t0, ln - sliding_window);
    return make_int2(t0, min(blk * bs + bs, ln));
  };
  const auto n_chunks = [](int2 t) {
    return t.y > t.x ? (t.y - t.x + TOK - 1) / TOK : 0;
  };
  __syncthreads();                    // sel and qs written, uni free
  int n_ch = 0;
  for (int i = 0; i < n_mine; ++i) n_ch += n_chunks(span(mine[i]));
  const int my_n =
      n_ch > warp ? (n_ch - warp + SPLIT_WARPS - 1) / SPLIT_WARPS : 0;
  WarpSoftmax<GM, DC> st;
  st.init();
  stream_chunks<TK, TOK, FM, SCALE_DOT>(
      st, qs, uni + (size_t)warp * SPLIT_STAGES * stage_bytes, stage_bytes, G,
      W, D, my_n,
      [&](int j) {
        int c = warp + j * SPLIT_WARPS, i = 0;
        int2 t = span(mine[0]);
        for (int n = n_chunks(t); c >= n; n = n_chunks(t)) {
          c -= n;
          t = span(mine[++i]);
        }
        return make_int2(t.x + c * TOK, t.y);
      },
      fill, dot_scale, lane);
  __syncthreads();                    // every ring is free: merge there
  float* mw = reinterpret_cast<float*>(uni);
  float* part = mw + SPLIT_WARPS * G * (D + 2);
  merge_warps(st, mw, part, G, D);

  cluster.sync();                     // every CTA's partial, written
  if (rank == 0) {
    for (int i = tid; i < G * D; i += SPLIT_THREADS) {
      const int g = i / D, c = i % D;
      store_f(out + i,
              merge_partials(
                  [&](int s) { return cluster.map_shared_rank(part, s); }, C,
                  g, c, D));
    }
  }
  cluster.sync();                     // peers' partials read
}

// Byte offsets of the dynamic shared memory of block_sparse_attention and
// block_sparse_attention_grouped: the float32 query (G x pad4(W)) and the
// kept block list (n_sel ints), then one region for the 4 warps' rings,
// which the warp merge and the CTA's partial reuse. kernels/tuning.py
// attend_smem_bytes mirrors it.
struct AttendLayout {
  size_t qs, sel, uni, total;
};

template <typename TK, int TOK>
__host__ __device__ inline AttendLayout attend_layout(int G, int W, int D,
                                                      int n_sel) {
  AttendLayout L;
  size_t off = 0;
  L.qs = off;
  off += round16(sizeof(float) * G * pad4(W));
  L.sel = off;
  off += round16(sizeof(int) * (size_t)n_sel);
  L.uni = off;
  const size_t ring =
      (size_t)SPLIT_WARPS * SPLIT_STAGES * split_stage_bytes<TK, TOK>(W, D);
  const size_t merge = sizeof(float) * (SPLIT_WARPS + 1) * G * (D + 2);
  L.total = off + round16(ring > merge ? ring : merge);
  return L;
}

// ------------------------------------------------------------- host side

// Run F<TQ, TK>::run(a) for the launch's (query, cache) dtype pair:
// 0 = float32, 1 = bfloat16.
template <template <typename, typename> class F, typename Args>
cudaError_t by_dtype(int q_bf16, int kv_bf16, const Args& a) {
  if (q_bf16 && kv_bf16) return F<__nv_bfloat16, __nv_bfloat16>::run(a);
  if (q_bf16) return F<__nv_bfloat16, float>::run(a);
  if (kv_bf16) return F<float, __nv_bfloat16>::run(a);
  return F<float, float>::run(a);
}

// Cache storage codes of the decode kernels 1-5 (kernels/_build.py
// STORAGE): 0 float32, 1 bfloat16, 2 float16, 3 int8, 4 float8_e4m3fn.
enum : int { KV_F32 = 0, KV_BF16 = 1, KV_F16 = 2, KV_I8 = 3, KV_F8 = 4 };

template <template <typename, typename> class F, typename TK, typename Args>
cudaError_t by_query(int q_bf16, const Args& a) {
  return q_bf16 ? F<__nv_bfloat16, TK>::run(a) : F<float, TK>::run(a);
}

// The storage types a build covers: -DLOKI_STORAGE_F16, _I8 or _F8 one
// each (kernels/_build.py LIBRARIES), none of them float32 and bfloat16
// (LOKI_STORAGE_WIDE).
#if !defined(LOKI_STORAGE_F16) && !defined(LOKI_STORAGE_I8) && \
    !defined(LOKI_STORAGE_F8)
#define LOKI_STORAGE_WIDE
#endif

// Run F<TQ, TK>::run(a) for the launch's query dtype (float32 or bfloat16)
// and cache storage code, over the storage types this build covers. Any
// other code is refused.
template <template <typename, typename> class F, typename Args>
cudaError_t by_storage(int q_bf16, int kv, const Args& a) {
  switch (kv) {
#ifdef LOKI_STORAGE_WIDE
    case KV_F32: return by_query<F, float>(q_bf16, a);
    case KV_BF16: return by_query<F, __nv_bfloat16>(q_bf16, a);
#endif
#ifdef LOKI_STORAGE_F16
    case KV_F16: return by_query<F, __half>(q_bf16, a);
#endif
#ifdef LOKI_STORAGE_I8
    case KV_I8: return by_query<F, int8_t>(q_bf16, a);
#endif
#ifdef LOKI_STORAGE_F8
    case KV_F8: return by_query<F, __nv_fp8_e4m3>(q_bf16, a);
#endif
    default: break;
  }
  return cudaErrorInvalidValue;
}

// fn(static_cast<TK*>(nullptr)) for a storage code's type, any code (the
// shared-memory layout queries); -1 for an unknown code.
template <typename Fn>
long long with_storage(int kv, Fn fn) {
  switch (kv) {
    case KV_F32: return fn(static_cast<float*>(nullptr));
    case KV_BF16: return fn(static_cast<__nv_bfloat16*>(nullptr));
    case KV_F16: return fn(static_cast<__half*>(nullptr));
    case KV_I8: return fn(static_cast<int8_t*>(nullptr));
    case KV_F8: return fn(static_cast<__nv_fp8_e4m3*>(nullptr));
    default: return -1;
  }
}

// Dynamic shared memory above 48 KB needs the opt-in attribute.
template <typename Kern>
inline cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr int MAX_CLUSTER = 8;        // the portable cluster size limit
constexpr int CLUSTER_CTAS_PER_SM = 4;

// The SM count of the current device, read once per device.
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

// CTAs per cluster from shapes only: about CLUSTER_CTAS_PER_SM CTAs per SM
// over ``rows`` clusters, 1 <= C <= min(MAX_CLUSTER, nb).
// kernels/fused_decode.py fused_cluster_size is the same rule.
inline int cluster_size(int nb, int rows, int n_sm) {
  int c = CLUSTER_CTAS_PER_SM * n_sm / (rows > 1 ? rows : 1);
  c = c < MAX_CLUSTER ? c : MAX_CLUSTER;
  c = c < nb ? c : nb;
  return c > 1 ? c : 1;
}

// cudaOccupancyMaxActiveClusters for a kernel, shared memory and cluster
// size, asked once per device.
inline cudaError_t max_clusters(const void* kern,
                                const cudaLaunchConfig_t& cfg, int C,
                                int* n) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t, int>, int> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, kern, cfg.dynamicSmemBytes, C);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *n = it->second;
    return cudaSuccess;
  }
  const cudaError_t err = cudaOccupancyMaxActiveClusters(n, kern, &cfg);
  if (err == cudaSuccess) seen[key] = *n;
  return err;
}

// Launch ``kern`` on grid (gx, gy, C) as clusters of C CTAs along z, each
// SPLIT_THREADS threads with ``smem`` bytes of dynamic shared memory; or,
// when ``info`` is not null, only report info[0] = C, info[1] = smem and
// info[2] = cudaOccupancyMaxActiveClusters. A cluster that cannot be
// resident never launches: no fallback.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kern)(Params...), int gx, int gy, int C,
                           size_t smem, cudaStream_t stream, long long* info,
                           Args... args) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, C);
  cfg.blockDim = dim3(SPLIT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  err = max_clusters(reinterpret_cast<const void*>(kern), cfg, C,
                     &n_clusters);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    info[0] = C;
    info[1] = (long long)smem;
    info[2] = n_clusters;
    return cudaSuccess;
  }
  if (n_clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace loki
