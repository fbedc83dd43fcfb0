// GQA-batched block-sparse attention for Hopper (sm_90a), contiguous caches.
//
// Replaces the Pallas TPU kernel block_sparse_attention_grouped of
// repro/kernels/gather_attention.py: exact attention over a group-shared
// block selection blk_idx (B, Hkv, n_sel), -1 entries contributing nothing.
// It is the second half of the two-kernel pair (after select_blocks).
//
// What bounds it on an H100: bytes. It reads n_sel K̂ blocks of width W and
// V blocks of width D per (b, kv-head) once, whatever G is (the G query
// heads of a KV group share every block), and does O(G) FMAs per element
// read. The TPU kernel walked the selection as a third, sequential grid
// axis with its softmax state in scratch; here one block of 256 threads per
// (kv-head, batch) pair walks the selection in a loop, with the online
// softmax state in shared memory and the (G, D) accumulators in registers.
#include "decode_common.cuh"

namespace loki {

template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
block_sparse_attention_grouped_kernel(
    const TQ* __restrict__ q, const TK* __restrict__ k,
    const TK* __restrict__ v, const int* __restrict__ blk_idx,
    const int* __restrict__ cur_len, TQ* __restrict__ out, int S, int Hkv,
    int G, int W, int D, int bs, int n_sel, float scale, int sliding_window) {
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
  attend_blocks(k, v, qs, sel, n_sel, sc, m_s, l_s, alpha_s, red,
                out + bh * G * D, b, h, ln, S, Hkv, G, W, D, bs,
                sliding_window);
}

template <typename TQ, typename TK>
cudaError_t launch_grouped(const void* q, const void* k, const void* v,
                           const void* blk_idx, const void* cur_len,
                           void* out, int B, int S, int Hkv, int G, int W,
                           int D, int bs, int n_sel, float scale,
                           int sliding_window, cudaStream_t stream) {
  const int nsplit = THREADS / D;
  const size_t smem = sizeof(float) * ((size_t)G * W + n_sel + G * bs +
                                       3 * G + (size_t)nsplit * G * D);
  auto kern = block_sparse_attention_grouped_kernel<TQ, TK>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), static_cast<const int*>(blk_idx),
      static_cast<const int*>(cur_len), static_cast<TQ*>(out), S, Hkv, G, W,
      D, bs, n_sel, scale, sliding_window);
  return cudaGetLastError();
}

}  // namespace loki

using namespace loki;

// q_bf16 / kv_bf16: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int loki_block_sparse_attention_grouped(
    const void* q, const void* k, const void* v, const void* blk_idx,
    const void* cur_len, void* out, int q_bf16, int kv_bf16, int B, int S,
    int Hkv, int G, int W, int D, int bs, int n_sel, float scale,
    int sliding_window, void* stream) {
  if (G < 1 || G > MAXG || W < 1 || W > MAXDIM || D < 1 || D > MAXDIM ||
      bs < 1 || S % bs != 0 || n_sel < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return (int)launch_grouped<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, blk_idx, cur_len, out, B, S, Hkv, G, W, D, bs, n_sel, scale,
        sliding_window, st);
  if (q_bf16)
    return (int)launch_grouped<__nv_bfloat16, float>(
        q, k, v, blk_idx, cur_len, out, B, S, Hkv, G, W, D, bs, n_sel, scale,
        sliding_window, st);
  if (kv_bf16)
    return (int)launch_grouped<float, __nv_bfloat16>(
        q, k, v, blk_idx, cur_len, out, B, S, Hkv, G, W, D, bs, n_sel, scale,
        sliding_window, st);
  return (int)launch_grouped<float, float>(q, k, v, blk_idx, cur_len, out, B,
                                           S, Hkv, G, W, D, bs, n_sel, scale,
                                           sliding_window, st);
}
