// Per-head Loki block maxima for Hopper (sm_90a): the first stage of the
// per-head decode pipeline (ops.loki_decode_attention and its
// feature-major twin).
//
// Replaces the Pallas TPU kernels
//   block_max_scores     repro/kernels/approx_scores.py:50 (token-major
//                        K̂ (BH, S, D)),
//   block_max_scores_fm  repro/kernels/approx_scores_fm.py:54
//                        (feature-major K̂ᵀ (BH, D, S)).
// Both give out[r, j] = max over the live tokens s of block j of
// q̂[r, :d]·K̂[r, s, :d] * scale, and exactly -1e30 for a block with no
// position below cur_len[r].
//
// What bounds them on an H100: bytes. They read the leading d features of
// every live key once (llama2-7b's per-head shape: 128 rows, cur_len
// 1800..3100, d = 32 of D = 128, fp32: about 40 MB, 12 us at 3.35 TB/s)
// and do 2 flops per element read. The design reads nothing else: dead
// blocks are written as -1e30 without a load, and only the d-slice of a
// live row is touched.
//
// Token-major (block_max_scores_kernel): the fused kernels' score stream
// (score_range in decode_common.cuh) at Hkv = 1, G = 1, W = D and no page
// table. A CTA of 4 warps takes a run of blocks of one row (RUN_TOKENS
// tokens; 4 CTAs per row, 512 CTAs at the main shape) and streams the
// leading d features of the run's live tokens through a per-warp two-stage
// ring of 16-byte cp.async copies, lanes across a token's features (one
// warp instruction covers 4 fp32 tokens); lane i scores token i from
// shared memory with one fma per feature, then times scale (SCALE_DOT),
// and each chunk's warp max goes to the run's block maxima by an exact
// shared atomic max.
//
// Feature-major (block_max_scores_fm_kernel): one CTA of THREADS threads
// per (row, run of blocks); a thread owns a token and walks the d feature
// rows, so neighbouring threads read neighbouring tokens of one row: each
// load of a warp is one coalesced 128 B (fp32) line. Each thread scores
// its tokens into shared memory; then warp w reduces blocks w, w + NWARPS,
// ... of the run (a warp max). The TPU's layout reason (lane tiling,
// DESIGN.md §3.1) does not exist here; only the output matters.
//
// Both sum q̂[f]·K̂[s, f] for f = 0..d-1 from 0 in the same order with one
// fma each and scale after the dot (as the TPU kernels do), and a block
// maximum is exact whatever order it is taken in, so the two give
// bit-identical maxima on the same data.
#include "decode_common.cuh"

namespace loki {

constexpr int RUN_TOKENS = 1024;  // tokens per CTA (a whole number of blocks)

template <typename TQ, typename TK>
__global__ void __launch_bounds__(SPLIT_THREADS)
block_max_scores_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                        const int* __restrict__ cur_len,
                        float* __restrict__ out, int S, int D, int d, int bs,
                        int blocks_per_cta, float scale, int vec) {
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  const ScoreLayout L = score_layout<TK>(1, d, d, bs, blocks_per_cta);
  float* qs = reinterpret_cast<float*>(base + L.qs);          // d
  float* blkmax = reinterpret_cast<float*>(base + L.blkmax);  // the run
  const int r = blockIdx.y, tid = threadIdx.x;
  const int nb = S / bs;
  const int j0 = blockIdx.x * blocks_per_cta;
  const int nblk = min(blocks_per_cta, nb - j0);
  const int ln = cur_len[r];
  load_query_padded(q + (int64_t)r * D, qs, 1, d, 1.f);
  for (int j = tid; j < nblk; j += SPLIT_THREADS) blkmax[j] = NEG_INF;
  __syncthreads();

  // row r of the (BH, S, D) cache is batch row r of a contiguous one
  const BlockRows rows{nullptr, 0, 1, S, bs, nullptr, nullptr};
  score_range<TK, 1, true>(k, rows, r, 0, 1, D, d, bs, L.tok, L.row_bytes,
                           qs, 0, 1, scale,
                           j0 * bs, min((j0 + nblk) * bs, ln), ln, 0,
                           blkmax, j0, base + L.ring, vec != 0);
  __syncthreads();
  // a block with no live position stays exactly NEG_INF
  for (int j = tid; j < nblk; j += SPLIT_THREADS)
    out[(int64_t)r * nb + j0 + j] = blkmax[j];
}

template <typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS)
block_max_scores_fm_kernel(const TQ* __restrict__ q,
                           const TK* __restrict__ k,
                           const int* __restrict__ cur_len,
                           float* __restrict__ out, int S, int D, int d,
                           int bs, int blocks_per_cta, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // d
  float* sc = qs + d;                     // blocks_per_cta * bs
  const int r = blockIdx.y;
  const int nb = S / bs;
  const int j0 = blockIdx.x * blocks_per_cta;
  const int nblk = min(blocks_per_cta, nb - j0);
  const int ln = cur_len[r];
  const int t0 = j0 * bs, ntok = nblk * bs;
  load_query(q + (int64_t)r * D, qs, d, 1.f);
  __syncthreads();

  const TK* kr = k + (int64_t)r * S * D;
  for (int i = threadIdx.x; i < ntok; i += blockDim.x) {
    const int s = t0 + i;
    float acc = NEG_INF;
    if (s < ln) {
      acc = 0.f;
      const TK* col = kr + s;             // K̂ᵀ[r, f, s] at f * S + s
      for (int f = 0; f < d; ++f)
        acc = fmaf(qs[f], to_f(col[(int64_t)f * S]), acc);
      acc *= scale;
    }
    sc[i] = acc;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < nblk; b += NWARPS) {
    float m = NEG_INF;
    // a block with no live position stays exactly NEG_INF
    if ((j0 + b) * bs < ln)
      for (int i = lane; i < bs; i += 32) m = fmaxf(m, sc[b * bs + i]);
    m = warp_max(m);
    if (lane == 0) out[(int64_t)r * nb + j0 + b] = m;
  }
}

struct Launch {
  const void* q;
  const void* k;
  const void* cur_len;
  void* out;
  int BH, S, D, d, bs;
  float scale;
  cudaStream_t stream;

  bool ok() const {
    return BH >= 1 && D >= 1 && D <= MAXDIM && d >= 1 && d <= D && bs >= 1 &&
           S >= bs && S % bs == 0;
  }
  int blocks_per_cta() const { return bs >= RUN_TOKENS ? 1 : RUN_TOKENS / bs; }
  dim3 grid() const {
    const int bpc = blocks_per_cta();
    return dim3((S / bs + bpc - 1) / bpc, BH);
  }
};

template <typename TQ, typename TK>
struct Scores {
  static cudaError_t run(const Launch& a) {
    const int bpc = a.blocks_per_cta();
    const ScoreLayout L = score_layout<TK>(1, a.d, a.d, a.bs, bpc);
    auto kern = block_max_scores_kernel<TQ, TK>;
    cudaError_t err = allow_smem(kern, L.total);
    if (err != cudaSuccess) return err;
    // 16-byte copies need rows of whole 16-byte pieces
    const int vec = (a.D * sizeof(TK)) % 16 == 0;
    kern<<<a.grid(), SPLIT_THREADS, L.total, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const int*>(a.cur_len), static_cast<float*>(a.out), a.S,
        a.D, a.d, a.bs, bpc, a.scale, vec);
    return cudaGetLastError();
  }
};

template <typename TQ, typename TK>
struct ScoresFm {
  static cudaError_t run(const Launch& a) {
    const int bpc = a.blocks_per_cta();
    const size_t smem = sizeof(float) * ((size_t)a.d + (size_t)bpc * a.bs);
    auto kern = block_max_scores_fm_kernel<TQ, TK>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<a.grid(), THREADS, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const int*>(a.cur_len), static_cast<float*>(a.out), a.S,
        a.D, a.d, a.bs, bpc, a.scale);
    return cudaGetLastError();
  }
};

}  // namespace loki

using namespace loki;

// q (BH, D) and k (BH, S, D), each float32 (0) or bfloat16 (1); out
// (BH, S / bs) float32. Returns a cudaError_t.
extern "C" int loki_block_max_scores(const void* q, const void* k,
                                     const void* cur_len, void* out,
                                     int q_bf16, int k_bf16, int BH, int S,
                                     int D, int d, int bs, float scale,
                                     void* stream) {
  const Launch a{q, k, cur_len, out, BH, S, D, d, bs, scale,
                 static_cast<cudaStream_t>(stream)};
  if (!a.ok()) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Scores>(q_bf16, k_bf16, a);
}

// The feature-major entry: k is K̂ᵀ (BH, D, S); d % 8 == 0 as in the TPU
// kernel's contract.
extern "C" int loki_block_max_scores_fm(const void* q, const void* k_T,
                                        const void* cur_len, void* out,
                                        int q_bf16, int k_bf16, int BH, int S,
                                        int D, int d, int bs, float scale,
                                        void* stream) {
  const Launch a{q, k_T, cur_len, out, BH, S, D, d, bs, scale,
                 static_cast<cudaStream_t>(stream)};
  if (!a.ok() || d % 8 != 0) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<ScoresFm>(q_bf16, k_bf16, a);
}
