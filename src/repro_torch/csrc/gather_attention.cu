// GQA-batched decode attention for Hopper (sm_90a), contiguous or paged
// caches: two kernels on the shared attention body of decode_common.cuh.
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
// What bounds both on an H100: bytes. They read each K̂ block of width W
// and V block of width D per (b, kv-head) once, whatever G is (the G query
// heads of a KV group share every block), and do O(G) FMAs per element
// read. The TPU kernels walked the blocks as a sequential grid axis (or a
// fori_loop) with the softmax state in scratch; here one block of 256
// threads per (kv-head, batch) pair walks them in a loop, with the online
// softmax state and one block's scores in shared memory and the (G, D)
// accumulators in registers. B*Hkv = 128 at llama2-7b's 4 slots leaves 4 of
// the 132 SMs idle and one block per SM waiting on memory latency: a
// split-KV form is later work.
//
// Paged mode: with a page table the caches are the pools (R, Hkv, ·) and
// every block read resolves through BlockRows; S is the logical length
// n_tab * page_size.
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

template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
full_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                   const TK* __restrict__ v, const int* __restrict__ cur_len,
                   BlockRows rows, TQ* __restrict__ out, int Hkv, int G,
                   int W, int D, int bs, int nb, float scale,
                   int sliding_window) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  float* qs = smem;                                   // G*W
  float* sc = qs + G * W;                             // G*bs
  float* m_s = sc + G * bs;                           // G
  float* l_s = m_s + G;                               // G
  float* alpha_s = l_s + G;                           // G
  float* red = alpha_s + G;                           // nsplit*G*D
  const int ln = cur_len[b];
  const size_t bh = (size_t)b * Hkv + h;
  // live blocks only: the window's first block .. ceil(cur_len / bs)
  const int lo = sliding_window > 0 ? max(ln - sliding_window, 0) / bs : 0;
  const int hi = min(nb, (ln + bs - 1) / bs);
  load_query(q + bh * G * W, qs, G * W, scale);
  __syncthreads();
  attend_blocks(k, v, qs, static_cast<const int*>(nullptr), lo,
                max(hi - lo, 0), sc, m_s, l_s, alpha_s, red,
                out + bh * G * D, rows, b, h, ln, Hkv, G, W, D, bs,
                sliding_window);
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
  static cudaError_t run(const Launch& a) {
    const int nsplit = THREADS / a.D;
    const size_t smem = sizeof(float) *
                        ((size_t)a.G * a.W + a.G * a.bs + 3 * a.G +
                         (size_t)nsplit * a.G * a.D);
    auto kern = full_decode_kernel<TQ, TK>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(a.Hkv, a.B), THREADS, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const TK*>(a.v), static_cast<const int*>(a.cur_len),
        a.rows(), static_cast<TQ*>(a.out), a.Hkv, a.G, a.W, a.D, a.bs,
        a.S / a.bs, a.scale, a.sliding_window);
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
                 static_cast<cudaStream_t>(stream)};
  if (!a.ok() || n_sel < 1) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Grouped>(q_bf16, kv_bf16, a);
}

extern "C" int loki_full_decode(const void* q, const void* k, const void* v,
                                const void* cur_len, const void* table,
                                void* out, int q_bf16, int kv_bf16, int B,
                                int S, int Hkv, int G, int W, int D, int bs,
                                int n_tab, int page_size, float scale,
                                int sliding_window, void* stream) {
  const Launch a{q, k, v, nullptr, cur_len, table, out, B, S, Hkv, G, W, D,
                 bs, 0, n_tab, page_size, scale, sliding_window,
                 static_cast<cudaStream_t>(stream)};
  if (!a.ok()) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Full>(q_bf16, kv_bf16, a);
}
