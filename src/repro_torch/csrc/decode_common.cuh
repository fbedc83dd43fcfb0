// Shared device code of the Loki decode kernels (fused_decode.cu,
// gather_attention.cu, approx_scores.cu): float conversion, warp
// reductions, the logical block -> cache row map, the score stream (a
// per-warp cp.async ring of token rows, lane i scoring token i, block
// maxima by an exact shared atomic max) and the cluster select that the
// fused kernels, select_blocks and block_max_scores run, and the two
// split-KV streaming bodies that every attention kernel shares: the wide
// body (fp32 and bf16 caches; stream_chunks: a per-warp cp.async ring over
// 4-token chunks of any token ranges, a token's scores as warp sums) and
// the narrow body (fp16, int8 and fp8 caches; stream_narrow: chunks sized
// in bytes that never leave a block, lanes across tokens for the scores),
// each with a per-warp online softmax; then the 4-warp log-sum-exp merge,
// the log-sum-exp merge of per-CTA partials, and attend_share /
// attend_share_narrow, the attention over a list of blocks by one
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
// for K and one for V (BlockRows::ksc, vsc; paged only). The score stream
// dequantizes a row as it reads it: code -> float32 * page scale, element
// by element, then the dot, the order the TPU kernels use
// (repro/kernels/fused_decode.py:104-108), so its block maxima are the
// plain path's bits. The narrow attention body folds the scales instead:
// a chunk lies in one block, so in one page, and a token's score is
// (q·codes) * K scale, its p·V weight p * V scale. The rings copy the
// codes as raw bytes; a narrow stage carries its page's K and V scales
// after its rows, the score ring the block's K scale in the padding of
// its first row.
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
// The same values without the conversion unit (an eighth of the FMA rate
// on Hopper), for the narrow attention body: code + 128 (the byte ^ 0x80)
// becomes the low mantissa byte of 2^23 by one byte permute, and 2^23 +
// 128 is subtracted, exactly.
__device__ __forceinline__ void i8x4_to_f_exact(uint32_t u, float* o) {
  const uint32_t x = u ^ 0x80808080u;
  o[0] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.f;
  o[1] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.f;
  o[2] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.f;
  o[3] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.f;
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
  i8x4_to_f_exact(*reinterpret_cast<const uint32_t*>(p), o);
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

// one warp's ring stage of the wide body: TOK rows of K̂ then of V in the
// cache dtype, rows padded to 4 elements (a feature-major K̂ stage holds
// the same elements)
template <typename TK, int TOK = SPLIT_TOK>
__host__ __device__ inline size_t split_stage_bytes(int W, int D) {
  return round16((size_t)TOK * (pad4(W) + pad4(D)) * sizeof(TK));
}

// Whether a storage type streams through the narrow attention body
// (stream_narrow) rather than the wide one (stream_chunks).
template <typename TK>
struct Narrow {
  static constexpr bool value =
      Store<TK>::scaled || std::is_same<TK, __half>::value;
};

// The narrow body's chunks are sized in bytes: a stage holds at most
// NARROW_STAGE_BYTES of K and V rows as stored (32 tokens of
// int8:pca:r=32, 32 + 128 one-byte codes each: about the 4 KB of a wide
// fp32 stage), and one token per lane at most.
constexpr int NARROW_STAGE_BYTES = 5120;
constexpr int NARROW_MAX_TOK = 32;

// Tokens per narrow stage: the largest power of two <= NARROW_MAX_TOK whose
// K and V rows fit NARROW_STAGE_BYTES (at least 1). The ring is sized for
// it (a layout short of room may halve it); a launch streams narrow_chunk
// tokens at a time.
__host__ __device__ inline int narrow_tokens(int W, int D, int size) {
  int t = NARROW_MAX_TOK;
  while (t > 1 && t * (W + D) * size > NARROW_STAGE_BYTES) t >>= 1;
  return t;
}
// A launch's chunk: a stage's ``tok`` tokens cut to the largest power of
// two that divides bs, so that a chunk never leaves its block (nor its
// page).
__host__ __device__ inline int narrow_chunk(int tok, int bs) {
  const int p = bs & -bs;
  return tok < p ? tok : p;
}
// Bytes between two staged K rows: whole 16-byte pieces, an odd number of
// them, so that the lanes of neighbouring tokens reading the same piece
// fall in distinct bank groups (as the score ring's 144-byte rows do).
__host__ __device__ inline int narrow_k_pitch(int W, int size) {
  return (((W * size + 15) / 16) | 1) * 16;
}
// One warp's narrow stage: ``tok`` K rows at narrow_k_pitch, as many V
// rows of D codes, then for scaled storage the chunk's page's K and V
// scales (16 bytes).
template <typename TK>
__host__ __device__ inline size_t narrow_stage_bytes(int W, int D, int tok) {
  return (size_t)tok * (narrow_k_pitch(W, sizeof(TK)) +
                        round16((size_t)D * sizeof(TK))) +
         (Store<TK>::scaled ? 16 : 0);
}
// A stage of the attention ring of either body (TOK: the wide body's
// chunk; the narrow body sizes its own)
template <typename TK, int TOK = SPLIT_TOK>
__host__ __device__ inline size_t attn_stage_bytes(int W, int D) {
  if constexpr (Narrow<TK>::value)
    return narrow_stage_bytes<TK>(W, D, narrow_tokens(W, D, sizeof(TK)));
  else
    return split_stage_bytes<TK, TOK>(W, D);
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

// The wide body's fill: copy the K̂ and V rows of tokens pos0 .. pos0 +
// SPLIT_TOK - 1 (those below t1) into a warp's ring stage, then commit one
// cp.async group (empty when nothing was issued, so the group count stays
// in step). The tokens' cache rows are resolved first, walking the blocks,
// so a paged chunk does one page-table read per block it touches, before
// any copy is issued.
template <typename TK>
__device__ void split_fill(uint8_t* stage, const TK* __restrict__ k,
                           const TK* __restrict__ v, const BlockRows& rows,
                           int b, int h, int Hkv, int W, int D, int bs,
                           int pos0, int t1, bool vec, int lane) {
  static_assert(!Narrow<TK>::value, "narrow storage: NarrowSrc::fill");
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

// The wide body (fp32 and bf16 caches): stream a warp's ``my_n`` chunks
// through its two-stage ring and fold each into ``st``. ``chunk_at(j)``
// gives the warp's j-th chunk as int2 {first token, end of its range}: the
// chunk is tokens first .. first + TOK - 1 below the end; ``fill(stage,
// first, end)`` copies it into a stage and commits one cp.async group.
// The next chunk's K̂ and V rows are in flight (16-byte cp.async) while the
// warp computes on this one; no CTA barrier in the loop. qs: the float32
// query, G x Wp. A token's score is the warp sum of q·k̂ over the lanes'
// columns, each lane summing its 4 (8) columns in order, times
// ``dot_scale`` when SCALE_DOT (the per-head kernel scales after the dot,
// as its TPU kernel does; the others pass a scaled query).
// FM: the K̂ stage is feature-major (head_fill); the lanes then read their
// features' pieces and sum in the same order, so both layouts give the
// same bits. Ends with every copy landed; the caller synchronises the CTA
// before reusing the ring.
template <typename TK, int TOK = SPLIT_TOK, bool FM = false,
          bool SCALE_DOT = false, int GM, int DC, typename ChunkAt,
          typename Fill>
__device__ __forceinline__ void stream_chunks(
    WarpSoftmax<GM, DC>& st, const float* qs, uint8_t* my_ring,
    size_t stage_bytes, int G, int W, int D, int my_n, ChunkAt chunk_at,
    Fill fill, float dot_scale, int lane) {
  static_assert(!FM || TOK * sizeof(TK) == 16,
                "a feature's chunk is one 16-byte piece");
  static_assert(!Narrow<TK>::value, "narrow storage: stream_narrow");
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

// ------------------------------------------------ the narrow attention body

// A launch's narrow chunks over stages of ``tok`` tokens: T = narrow_chunk
// tokens (2^lt), the staged K and V rows' pitches, the stage size
// (narrow_stage_bytes) and the 16-byte pieces of a K and of a V row.
struct NarrowGeom {
  int T, lt, kpitch, vpitch, kp, vp;
  size_t stage;
};

template <typename TK>
__device__ __forceinline__ NarrowGeom narrow_geom(int W, int D, int bs,
                                                  int tok) {
  NarrowGeom g;
  g.T = narrow_chunk(tok, bs);
  g.lt = __ffs(g.T) - 1;
  g.kpitch = narrow_k_pitch(W, sizeof(TK));
  g.vpitch = D * (int)sizeof(TK);
  g.kp = W * (int)sizeof(TK) / 16;
  g.vp = g.vpitch / 16;
  g.stage = narrow_stage_bytes<TK>(W, D, tok);
  return g;
}

// 16-byte cp.async copies of n rows of ``pieces`` pieces each, row u read
// from src + u * stride (elements) and written to dst + u * pitch (bytes):
// the 32 lanes across the (row, piece) pairs, lane i taking pairs i, i +
// 32, ...
template <typename TK>
__device__ __forceinline__ void copy_rows16(uint8_t* dst, int pitch,
                                            const TK* __restrict__ src,
                                            int64_t stride, int n,
                                            int pieces, int lane) {
  constexpr int E = 16 / sizeof(TK);
  const int du = 32 / pieces, dp = 32 - du * pieces;
  int u = lane / pieces, p = lane - u * pieces;
  while (u < n) {
    cp_async16(dst + u * pitch + p * 16, src + u * stride + p * E);
    u += du;
    p += dp;
    if (p >= pieces) {
      p -= pieces;
      ++u;
    }
  }
}

// The narrow body's source: row (b, h) of the caches k and v. fill copies
// a chunk's tokens pos0 .. pos0 + n - 1 (n = min(T, t1 - pos0), all in
// pos0's block, so in one page) into a warp's stage after one page-table
// read: the rows by 16-byte cp.async, the lanes across (token, piece)
// pairs, and for scaled storage the page's K and V scales by lanes 0 and
// 1 after the V rows; then one cp.async group.
template <typename TK>
struct NarrowSrc {
  const TK* __restrict__ k;
  const TK* __restrict__ v;
  BlockRows rows;
  int b, h, Hkv, W, D, bs;

  __device__ __forceinline__ void fill(uint8_t* stage, const NarrowGeom& ng,
                                       int pos0, int t1, int lane) const {
    const int blk = pos0 / bs, n = min(ng.T, t1 - pos0);
    const int pg = rows.table == nullptr ? 0 : rows.page(b, blk);
    const int64_t r0 =                // the cache row of token pos0
        rows.table == nullptr
            ? (int64_t)b * rows.S + pos0
            : ((int64_t)pg * rows.bpp + blk % rows.bpp) * bs +
                  (pos0 - blk * bs);
    uint8_t* vs = stage + (size_t)ng.T * ng.kpitch;
    if constexpr (Store<TK>::scaled)
      if (lane < 2)
        cp_async4(vs + (size_t)ng.T * ng.vpitch + 4 * lane,
                  (lane == 0 ? rows.ksc : rows.vsc) + pg);
    copy_rows16(stage, ng.kpitch, k + (r0 * Hkv + h) * W, (int64_t)Hkv * W,
                n, ng.kp, lane);
    copy_rows16(vs, ng.vpitch, v + (r0 * Hkv + h) * D, (int64_t)Hkv * D, n,
                ng.vp, lane);
    cp_async_commit();
  }
};

// A staged 16-byte piece of codes as float32 for the narrow body: load16,
// but int8 through i8x4_to_f_exact (the score stream keeps i8x4_to_f).
template <typename TK>
__device__ __forceinline__ void narrow_load16(const TK* p, float* o) {
  load16(p, o);
}
template <>
__device__ __forceinline__ void narrow_load16(const int8_t* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  i8x4_to_f_exact(u.x, o);
  i8x4_to_f_exact(u.y, o + 4);
  i8x4_to_f_exact(u.z, o + 8);
  i8x4_to_f_exact(u.w, o + 12);
}

// The narrow body (fp16, int8 and fp8 caches): stream a warp's ``my_n``
// chunks of ``src`` through its two-stage ring and fold each into ``st``,
// as stream_chunks does, but with chunks of ng.T tokens that never leave a
// block (``chunk_at(j)``: {first token, end of its block's live tokens})
// and the lanes across tokens for the scores. Lane u + T s takes token u's
// pieces s, s + L, ... (L = 32 / T lanes a token), summing q·codes for
// each head piece by piece in feature order; xor shuffles add the L
// lanes' sums and the page's K scale multiplies the dot. The online
// softmax then takes one max and one sum across the T tokens' lanes per
// chunk and head, and one expf a lane. p·V keeps the lanes across the D
// columns (4 * lane + 128 * jj, the wide body's, so merge_warps serves
// both): each token's p times the page's V scale is broadcast from its
// lane, once per token and head. Rows past the chunk's end hold stale
// bytes: their scores are replaced by -1e30 and their V rows never read. Ends with every copy landed; the caller
// synchronises the CTA before reusing the ring.
template <typename TK, int GM, int DC, typename ChunkAt>
__device__ __forceinline__ void stream_narrow(
    WarpSoftmax<GM, DC>& st, const float* qs, uint8_t* my_ring,
    const NarrowGeom& ng, const NarrowSrc<TK>& src, int G, int my_n,
    ChunkAt chunk_at, int lane) {
  static_assert(Narrow<TK>::value, "wide storage: stream_chunks");
  constexpr int E = 16 / sizeof(TK);
  const int W = src.W, D = src.D;
  const int Wp = pad4(W), T = ng.T, L = 32 / T;
  const int u = lane & (T - 1), s = lane >> ng.lt;   // token, its share
#pragma unroll
  for (int j = 0; j < SPLIT_STAGES - 1; ++j) {
    if (j < my_n) {
      const int2 c = chunk_at(j);
      src.fill(my_ring + j * ng.stage, ng, c.x, c.y, lane);
    } else {
      cp_async_commit();
    }
  }

  for (int j = 0; j < my_n; ++j) {
    const int jn = j + SPLIT_STAGES - 1;             // the chunk to prefetch
    if (jn < my_n) {
      const int2 c = chunk_at(jn);
      src.fill(my_ring + (jn % SPLIT_STAGES) * ng.stage, ng, c.x, c.y, lane);
    } else {
      cp_async_commit();
    }
    cp_async_wait<SPLIT_STAGES - 1>();
    __syncwarp();

    const uint8_t* stg = my_ring + (j % SPLIT_STAGES) * ng.stage;
    const uint8_t* vs = stg + (size_t)T * ng.kpitch;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (Store<TK>::scaled) {
      const float2 sc =
          *reinterpret_cast<const float2*>(vs + (size_t)T * ng.vpitch);
      ksc = sc.x;
      vsc = sc.y;
    }
    const int2 cj = chunk_at(j);
    const int n_tok = min(T, cj.y - cj.x);          // >= 1
    // this lane's part of its token's G dots
    float x[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) x[g] = 0.f;
    const TK* kr = reinterpret_cast<const TK*>(stg + (size_t)u * ng.kpitch);
    for (int p = s; p < ng.kp; p += L) {
      float kv[E];
      narrow_load16(kr + p * E, kv);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float4* q4 =
              reinterpret_cast<const float4*>(qs + g * Wp + p * E);
#pragma unroll
          for (int e = 0; e < E / 4; ++e) {
            const float4 qv = q4[e];
            x[g] = fmaf(qv.x, kv[4 * e], x[g]);
            x[g] = fmaf(qv.y, kv[4 * e + 1], x[g]);
            x[g] = fmaf(qv.z, kv[4 * e + 2], x[g]);
            x[g] = fmaf(qv.w, kv[4 * e + 3], x[g]);
          }
        }
      }
    }
    // online softmax of each head over the chunk (the TPU kernel's guards)
    float pv[GM];                     // p * V scale of this lane's token
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      pv[g] = 0.f;
      if (g < G) {
        for (int o = T; o < 32; o <<= 1)
          x[g] += __shfl_xor_sync(FULL, x[g], o);
        const float sc = u < n_tok ? x[g] * ksc : NEG_INF;
        float bm = sc;
        for (int o = T >> 1; o > 0; o >>= 1)
          bm = fmaxf(bm, __shfl_xor_sync(FULL, bm, o));
        const float m_new = fmaxf(st.m[g], bm);
        const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
        const float alpha = st.m[g] > NEG_INF * 0.5f
                                ? expf(fminf(st.m[g] - m_safe, 0.f))
                                : 0.f;
        const float p = sc > NEG_INF * 0.5f ? expf(sc - m_safe) : 0.f;
        float sum = p;
        for (int o = T >> 1; o > 0; o >>= 1)
          sum += __shfl_xor_sync(FULL, sum, o);
        st.l[g] = st.l[g] * alpha + sum;
        st.m[g] = m_new;
#pragma unroll
        for (int e = 0; e < 4 * DC; ++e) st.acc[g][e] *= alpha;
        pv[g] = p * vsc;
      }
    }
#pragma unroll 4
    for (int t = 0; t < n_tok; ++t) {
      const TK* vr = reinterpret_cast<const TK*>(vs + (size_t)t * ng.vpitch);
      float vv[DC][4];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int c = 4 * lane + 128 * jj;
        if (c < D) {
          load4(vr + c, vv[jj]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) vv[jj][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float pt = __shfl_sync(FULL, pv[g], t);
#pragma unroll
          for (int jj = 0; jj < DC; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              st.acc[g][4 * jj + e] =
                  fmaf(pt, vv[jj][e], st.acc[g][4 * jj + e]);
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

// The end of a cluster's attention: once every ring is free, the CTA's 4
// warps merge into its partial (merge_warps; G x (D + 2) float32 after the
// warps' scratch in ``uni``); after cluster.sync() rank 0 reads the C
// partials through distributed shared memory and merges them by
// log-sum-exp in rank order into out (G x D in TQ); the last
// cluster.sync() keeps the peers' partials alive until it has.
template <typename TQ, int GM, int DC>
__device__ __forceinline__ void cluster_merge(const WarpSoftmax<GM, DC>& st,
                                              uint8_t* uni, int G, int D,
                                              int rank, int C,
                                              TQ* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
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

// Phases 3-4 of a cluster kernel. CTA r of the C in its cluster attends
// share r of the nv blocks in sel[0 .. nv) (list order, each in [0, nb)):
// entries [r * per, (r + 1) * per), per = ceil(nv / C), trailing shares
// possibly empty. A block's live tokens run from blk * bs (or ln -
// sliding_window, if later) to min(blk * bs + bs, ln). The share's
// TOK-token chunks are numbered block after block and warp w takes chunks
// w, w + 4, ...; a chunk's block is found by walking the share's list (a
// few entries), so no table is built. Each warp streams its chunks
// (stream_chunks, the wide body) through its ring in ``uni``; then
// cluster_merge. A CTA with no chunk adds m = -1e30, l = 0. The caller
// writes sel and the query before the call (the first barrier here orders
// them, and frees ``uni``).
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
  cluster_merge(st, uni, G, D, rank, C, out);
}

// attend_share for the narrow storage types (fp16, int8, fp8): the same
// shares of sel and the same merges, but each block's live tokens cut into
// chunks of ng.T tokens from its first live token, so a chunk never leaves
// its block, streamed by stream_narrow through stages of ``tok`` tokens
// from row (b, h) of k and v.
template <typename TQ, typename TK, int GM, int DC>
__device__ __forceinline__ void attend_share_narrow(
    const int* sel, int nv, const float* qs, uint8_t* uni, int tok,
    const TK* __restrict__ k, const TK* __restrict__ v,
    const BlockRows& rows, int b, int h, int Hkv, int ln, int G, int W, int D,
    int bs, int sliding_window, TQ* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = (nv + C - 1) / C;
  const int s0 = rank * per, n_mine = max(0, min(nv, s0 + per) - s0);
  const int* mine = sel + s0;
  const NarrowGeom ng = narrow_geom<TK>(W, D, bs, tok);
  const auto span = [&](int blk) {
    int t0 = blk * bs;
    if (sliding_window > 0) t0 = max(t0, ln - sliding_window);
    return make_int2(t0, min(blk * bs + bs, ln));
  };
  const auto n_chunks = [&](int2 t) {
    return t.y > t.x ? (t.y - t.x + ng.T - 1) >> ng.lt : 0;
  };
  __syncthreads();                    // sel and qs written, uni free
  int n_ch = 0;
  for (int i = 0; i < n_mine; ++i) n_ch += n_chunks(span(mine[i]));
  const int my_n =
      n_ch > warp ? (n_ch - warp + SPLIT_WARPS - 1) / SPLIT_WARPS : 0;
  WarpSoftmax<GM, DC> st;
  st.init();
  stream_narrow<TK>(
      st, qs, uni + (size_t)warp * SPLIT_STAGES * ng.stage, ng,
      NarrowSrc<TK>{k, v, rows, b, h, Hkv, W, D, bs}, G, my_n,
      [&](int j) {
        int c = warp + j * SPLIT_WARPS, i = 0;
        int2 t = span(mine[0]);
        for (int n = n_chunks(t); c >= n; n = n_chunks(t)) {
          c -= n;
          t = span(mine[++i]);
        }
        return make_int2(t.x + c * ng.T, t.y);
      },
      lane);
  cluster_merge(st, uni, G, D, rank, C, out);
}

// Byte offsets of the dynamic shared memory of block_sparse_attention and
// block_sparse_attention_grouped: the float32 query (G x pad4(W)) and the
// kept block list (n_sel ints), then one region for the 4 warps' rings,
// which the warp merge and the CTA's partial reuse: TOK-token stages of
// the wide body, or ``tok``-token ones of the narrow body (narrow_tokens,
// halved while a long list leaves the ring too little room, so the
// longest lists the two-kernel plan takes still fit). kernels/tuning.py
// attend_smem_bytes mirrors it.
struct AttendLayout {
  size_t qs, sel, uni, total;
  int tok;
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
  const size_t merge = sizeof(float) * (SPLIT_WARPS + 1) * G * (D + 2);
  const auto total = [&](size_t stage) {
    const size_t ring = (size_t)SPLIT_WARPS * SPLIT_STAGES * stage;
    return off + round16(ring > merge ? ring : merge);
  };
  if constexpr (Narrow<TK>::value) {
    L.tok = narrow_tokens(W, D, sizeof(TK));
    while (L.tok > 1 &&
           total(narrow_stage_bytes<TK>(W, D, L.tok)) > SMEM_LIMIT)
      L.tok >>= 1;
    L.total = total(narrow_stage_bytes<TK>(W, D, L.tok));
  } else {
    L.tok = TOK;
    L.total = total(split_stage_bytes<TK, TOK>(W, D));
  }
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
// when ``info`` is not null, only report info[0] = C, info[1] = smem,
// info[2] = cudaOccupancyMaxActiveClusters and info[3] =
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (resident CTAs per SM). A
// cluster that cannot be resident never launches: no fallback.
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
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        SPLIT_THREADS, smem);
    info[3] = per_sm;
    return err;
  }
  if (n_clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace loki
