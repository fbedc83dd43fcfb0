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
// live row is touched. Token-major: a thread owns a token and reads its d
// contiguous features with 16 B (fp32) or 8 B (bf16) vector loads, so a
// warp's loads fill whole 128 B lines. Feature-major: a thread owns a
// token and walks the d feature rows, so neighbouring threads read
// neighbouring tokens of one row: each load of a warp is one coalesced
// 128 B (fp32) line. The TPU's layout reason (lane tiling, DESIGN.md
// §3.1) does not exist here; only the output matters.
//
// Grid: one CTA of THREADS threads per (row, run of blocks), the run
// covering RUN_TOKENS tokens (at least one block). Each thread scores its
// tokens into shared memory; then warp w reduces blocks w, w + NWARPS, ...
// of the run (a warp max). Both layouts sum q̂[f]·K̂[s, f] for f = 0..d-1
// in the same order with one FMA each and scale after the dot (as the TPU
// kernels do), so they give bit-identical maxima on the same data.
#include "decode_common.cuh"

namespace loki {

constexpr int RUN_TOKENS = 1024;  // tokens per CTA (a whole number of blocks)

template <typename TQ, typename TK, bool FM>
__global__ void __launch_bounds__(THREADS)
block_max_scores_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                        const int* __restrict__ cur_len,
                        float* __restrict__ out, int S, int D, int d, int bs,
                        int blocks_per_cta, float scale, int vec) {
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
      if (FM) {
        const TK* col = kr + s;           // K̂ᵀ[r, f, s] at f * S + s
        for (int f = 0; f < d; ++f)
          acc = fmaf(qs[f], to_f(col[(int64_t)f * S]), acc);
      } else if (vec) {
        const TK* row = kr + (int64_t)s * D;
        for (int f = 0; f < d; f += 4) {
          float kv[4];
          load4(row + f, kv);
          acc = fmaf(qs[f], kv[0], acc);
          acc = fmaf(qs[f + 1], kv[1], acc);
          acc = fmaf(qs[f + 2], kv[2], acc);
          acc = fmaf(qs[f + 3], kv[3], acc);
        }
      } else {
        const TK* row = kr + (int64_t)s * D;
        for (int f = 0; f < d; ++f) acc = fmaf(qs[f], to_f(row[f]), acc);
      }
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
};

template <bool FM>
struct Scores {
  template <typename TQ, typename TK>
  struct By {
    static cudaError_t run(const Launch& a) {
      const int bpc = a.blocks_per_cta();
      const int nb = a.S / a.bs;
      const size_t smem = sizeof(float) * ((size_t)a.d + (size_t)bpc * a.bs);
      auto kern = block_max_scores_kernel<TQ, TK, FM>;
      cudaError_t err = allow_smem(kern, smem);
      if (err != cudaSuccess) return err;
      const int vec = (a.d % 4 == 0) && (a.D % 4 == 0);
      kern<<<dim3((nb + bpc - 1) / bpc, a.BH), THREADS, smem, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
          static_cast<const int*>(a.cur_len), static_cast<float*>(a.out),
          a.S, a.D, a.d, a.bs, bpc, a.scale, vec);
      return cudaGetLastError();
    }
  };
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
  return (int)by_dtype<Scores<false>::By>(q_bf16, k_bf16, a);
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
  return (int)by_dtype<Scores<true>::By>(q_bf16, k_bf16, a);
}
