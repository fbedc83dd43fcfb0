// Fused GQA-batched Loki decode for Hopper (sm_90a), contiguous caches.
//
// Replaces the Pallas TPU kernels of repro/kernels/fused_decode.py:
//   fused_loki_decode (score -> select -> attend in one pass) and
//   select_blocks     (score -> select only, for the two-kernel pair).
//
// What bounds it on an H100: bytes. Per (b, kv-head) the score stream reads
// the leading d features of every live key (d = 32 fp32 = 128 B a token)
// and the attention pass reads k_blocks winning K̂ and V blocks; the
// arithmetic is a few FMAs per byte, far below the card's ~295 ops/byte
// ridge. The design keeps every intermediate on chip: the block maxima sit
// in shared memory, the selection never leaves the block, and the winners
// are read once per KV group (all G query heads share them).
//
// Grid: one block of 256 threads per (kv-head, batch) pair. The TPU ran
// those pairs in order; here they run in parallel, and B*Hkv blocks fill
// the 132 SMs only when B*Hkv >= 132 (llama2-7b at 4 slots: 128). A
// split-KV form with a cross-block select is later work.
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
                         const int* __restrict__ cur_len, TQ* __restrict__ out,
                         int S, int Hkv, int G, int W, int D, int d, int bs,
                         int nb, int kb, float scale, int local_window,
                         int sliding_window, int vec) {
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
  score_and_select(k, qs, scores, sel, b, h, ln, S, Hkv, G, W, d, bs, nb, kb,
                   local_window, sliding_window, vec != 0);
  attend_blocks(k, v, qs, sel, kb, sc, m_s, l_s, alpha_s, red,
                out + bh * G * D, b, h, ln, S, Hkv, G, W, D, bs,
                sliding_window);
}

template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
select_blocks_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                     const int* __restrict__ cur_len, int* __restrict__ out,
                     int S, int Hkv, int G, int W, int d, int bs, int nb,
                     int kb, float scale, int local_window,
                     int sliding_window, int vec) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  float* qs = smem;                                   // G*W
  float* scores = qs + G * W;                         // nb
  const int ln = cur_len[b];
  const size_t bh = (size_t)b * Hkv + h;
  load_query(q + bh * G * W, qs, G * W, scale);
  score_and_select(k, qs, scores, out + bh * kb, b, h, ln, S, Hkv, G, W, d,
                   bs, nb, kb, local_window, sliding_window, vec != 0);
}

template <typename TQ, typename TK>
cudaError_t launch_fused(const void* q, const void* k, const void* v,
                         const void* cur_len, void* out, int B, int S, int Hkv,
                         int G, int W, int D, int d, int bs, int kb,
                         float scale, int local_window, int sliding_window,
                         cudaStream_t stream) {
  const int nb = S / bs;
  const int nsplit = THREADS / D;
  const size_t smem = sizeof(float) * ((size_t)G * W + nb + kb + G * bs +
                                       3 * G + (size_t)nsplit * G * D);
  const int vec = (d % 4 == 0) && (W % 4 == 0);
  auto kern = fused_loki_decode_kernel<TQ, TK>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), static_cast<const int*>(cur_len),
      static_cast<TQ*>(out), S, Hkv, G, W, D, d, bs, nb, kb, scale,
      local_window, sliding_window, vec);
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t launch_select(const void* q, const void* k, const void* cur_len,
                          void* out, int B, int S, int Hkv, int G, int W,
                          int d, int bs, int kb, float scale, int local_window,
                          int sliding_window, cudaStream_t stream) {
  const int nb = S / bs;
  const size_t smem = sizeof(float) * ((size_t)G * W + nb);
  const int vec = (d % 4 == 0) && (W % 4 == 0);
  auto kern = select_blocks_kernel<TQ, TK>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const int*>(cur_len), static_cast<int*>(out), S, Hkv, G, W,
      d, bs, nb, kb, scale, local_window, sliding_window, vec);
  return cudaGetLastError();
}

inline bool shape_ok(int G, int W, int D, int d, int bs, int S, int kb) {
  return G >= 1 && G <= MAXG && W >= 1 && W <= MAXDIM && D >= 1 &&
         D <= MAXDIM && d >= 1 && d <= W && bs >= 1 && S % bs == 0 &&
         kb >= 1 && kb <= S / bs;
}

}  // namespace loki

using namespace loki;

// q_bf16 / kv_bf16: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int loki_fused_decode(const void* q, const void* k, const void* v,
                                 const void* cur_len, void* out, int q_bf16,
                                 int kv_bf16, int B, int S, int Hkv, int G,
                                 int W, int D, int d, int bs, int kb,
                                 float scale, int local_window,
                                 int sliding_window, void* stream) {
  if (!shape_ok(G, W, D, d, bs, S, kb)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return (int)launch_fused<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, cur_len, out, B, S, Hkv, G, W, D, d, bs, kb, scale,
        local_window, sliding_window, st);
  if (q_bf16)
    return (int)launch_fused<__nv_bfloat16, float>(
        q, k, v, cur_len, out, B, S, Hkv, G, W, D, d, bs, kb, scale,
        local_window, sliding_window, st);
  if (kv_bf16)
    return (int)launch_fused<float, __nv_bfloat16>(
        q, k, v, cur_len, out, B, S, Hkv, G, W, D, d, bs, kb, scale,
        local_window, sliding_window, st);
  return (int)launch_fused<float, float>(q, k, v, cur_len, out, B, S, Hkv, G,
                                         W, D, d, bs, kb, scale, local_window,
                                         sliding_window, st);
}

extern "C" int loki_select_blocks(const void* q, const void* k,
                                  const void* cur_len, void* out, int q_bf16,
                                  int kv_bf16, int B, int S, int Hkv, int G,
                                  int W, int d, int bs, int kb, float scale,
                                  int local_window, int sliding_window,
                                  void* stream) {
  if (!shape_ok(G, W, W, d, bs, S, kb)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return (int)launch_select<__nv_bfloat16, __nv_bfloat16>(
        q, k, cur_len, out, B, S, Hkv, G, W, d, bs, kb, scale, local_window,
        sliding_window, st);
  if (q_bf16)
    return (int)launch_select<__nv_bfloat16, float>(
        q, k, cur_len, out, B, S, Hkv, G, W, d, bs, kb, scale, local_window,
        sliding_window, st);
  if (kv_bf16)
    return (int)launch_select<float, __nv_bfloat16>(
        q, k, cur_len, out, B, S, Hkv, G, W, d, bs, kb, scale, local_window,
        sliding_window, st);
  return (int)launch_select<float, float>(q, k, cur_len, out, B, S, Hkv, G, W,
                                          d, bs, kb, scale, local_window,
                                          sliding_window, st);
}
