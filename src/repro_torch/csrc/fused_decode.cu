// Fused GQA-batched Loki decode for Hopper (sm_90a), contiguous or paged
// caches.
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
// ~295 ops/byte ridge. The design keeps every intermediate on chip: the
// block maxima sit in shared memory, the selection never leaves the block,
// and the winners are read once per KV group (all G query heads share
// them).
//
// Grid: one block of 256 threads per (kv-head, batch) pair. The TPU ran
// those pairs in order; here they run in parallel, and B*Hkv blocks fill
// the 132 SMs only when B*Hkv >= 132 (llama2-7b at 4 slots: 128). A
// split-KV form with a cross-block select is later work.
//
// Paged mode: with a page table the caches are the serving engine's pools
// (R, Hkv, ·) with no batch dimension, and every block read resolves its
// row through BlockRows (decode_common.cuh); S is then the logical length
// n_tab * page_size. Nothing else changes.
//
// Requires cur_len >= 1 per row (the decode invariant: the new token is in
// the cache already); it is not checked here, to keep the hot path free of
// host syncs.
#include "decode_common.cuh"

namespace loki {

template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
fused_loki_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                         const TK* __restrict__ v,
                         const int* __restrict__ cur_len, BlockRows rows,
                         TQ* __restrict__ out, int Hkv, int G, int W, int D,
                         int d, int bs, int nb, int kb, float scale,
                         int local_window, int sliding_window, int vec) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  float* qs = smem;                                   // G*W
  float* scores = qs + G * W;                         // nb
  int* sel = reinterpret_cast<int*>(scores + nb);     // kb
  float* sc = reinterpret_cast<float*>(sel + kb);     // G*bs
  float* m_s = sc + G * bs;                           // G
  float* l_s = m_s + G;                               // G
  float* alpha_s = l_s + G;                           // G
  float* red = alpha_s + G;                           // nsplit*G*D
  const int ln = cur_len[b];
  const size_t bh = (size_t)b * Hkv + h;
  load_query(q + bh * G * W, qs, G * W, scale);
  score_and_select(k, qs, scores, sel, rows, b, h, ln, Hkv, G, W, d, bs, nb,
                   kb, local_window, sliding_window, vec != 0);
  attend_blocks(k, v, qs, sel, 0, kb, sc, m_s, l_s, alpha_s, red,
                out + bh * G * D, rows, b, h, ln, Hkv, G, W, D, bs,
                sliding_window);
}

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

// The host side of one launch: shapes, the page table and the stream.
struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const void* cur_len;
  const void* table;
  void* out;
  int B, S, Hkv, G, W, D, d, bs, kb, n_tab, page_size;
  float scale;
  int local_window, sliding_window;
  cudaStream_t stream;

  BlockRows rows() const {
    return make_rows(table, n_tab, page_size, S, bs);
  }
  int vec() const { return (d % 4 == 0) && (W % 4 == 0); }
};

template <typename TQ, typename TK>
cudaError_t launch_fused(const Launch& a) {
  const int nb = a.S / a.bs;
  const int nsplit = THREADS / a.D;
  const size_t smem = sizeof(float) *
                      ((size_t)a.G * a.W + nb + a.kb + a.G * a.bs +
                       3 * a.G + (size_t)nsplit * a.G * a.D);
  auto kern = fused_loki_decode_kernel<TQ, TK>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.Hkv, a.B), THREADS, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
      static_cast<const TK*>(a.v), static_cast<const int*>(a.cur_len),
      a.rows(), static_cast<TQ*>(a.out), a.Hkv, a.G, a.W, a.D, a.d, a.bs, nb,
      a.kb, a.scale, a.local_window, a.sliding_window, a.vec());
  return cudaGetLastError();
}

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
struct Fused {
  static cudaError_t run(const Launch& a) { return launch_fused<TQ, TK>(a); }
};
template <typename TQ, typename TK>
struct Select {
  static cudaError_t run(const Launch& a) { return launch_select<TQ, TK>(a); }
};

}  // namespace loki

using namespace loki;

// Every launcher: q_bf16 / kv_bf16 are 0 for float32, 1 for bfloat16;
// table is nullptr for a contiguous cache (n_tab = page_size = 0), else the
// (B, n_tab) int32 page table, with S = n_tab * page_size the logical
// length. Returns a cudaError_t.
extern "C" int loki_fused_decode(const void* q, const void* k, const void* v,
                                 const void* cur_len, const void* table,
                                 void* out, int q_bf16, int kv_bf16, int B,
                                 int S, int Hkv, int G, int W, int D, int d,
                                 int bs, int kb, int n_tab, int page_size,
                                 float scale, int local_window,
                                 int sliding_window, void* stream) {
  const Launch a{q, k, v, cur_len, table, out, B, S, Hkv, G, W, D, d, bs,
                 kb, n_tab, page_size, scale, local_window, sliding_window,
                 static_cast<cudaStream_t>(stream)};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Fused>(q_bf16, kv_bf16, a);
}

// The exact_topk policy's kernel: the fused pass at d = W with no recency
// boost (JAX fused_exact_topk_decode builds _fused_kernel the same way).
extern "C" int loki_fused_exact_topk_decode(
    const void* q, const void* k, const void* v, const void* cur_len,
    const void* table, void* out, int q_bf16, int kv_bf16, int B, int S,
    int Hkv, int G, int W, int D, int bs, int kb, int n_tab, int page_size,
    float scale, int sliding_window, void* stream) {
  const Launch a{q, k, v, cur_len, table, out, B, S, Hkv, G, W, D, W, bs,
                 kb, n_tab, page_size, scale, 0, sliding_window,
                 static_cast<cudaStream_t>(stream)};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Fused>(q_bf16, kv_bf16, a);
}

extern "C" int loki_select_blocks(const void* q, const void* k,
                                  const void* cur_len, const void* table,
                                  void* out, int q_bf16, int kv_bf16, int B,
                                  int S, int Hkv, int G, int W, int d, int bs,
                                  int kb, int n_tab, int page_size,
                                  float scale, int local_window,
                                  int sliding_window, void* stream) {
  const Launch a{q, k, nullptr, cur_len, table, out, B, S, Hkv, G, W, W, d,
                 bs, kb, n_tab, page_size, scale, local_window,
                 sliding_window, static_cast<cudaStream_t>(stream)};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Select>(q_bf16, kv_bf16, a);
}
