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
// Feature-major (block_max_scores_fm_kernel): lanes across tokens, never
// across features. A feature row of K̂ᵀ is contiguous in tokens, so a
// 16-byte piece holds 4 fp32 or 8 bf16 tokens of one feature and a warp
// instruction reads 512 contiguous bytes of one row; the 8 warps of a CTA
// read each feature row of their run (FM_RUN_BYTES of tokens, a whole
// number of blocks: 1024 fp32 or 2048 bf16 tokens) as one 4 KB stretch.
// Thread t owns the piece at tokens 16 / sizeof(TK) * t of the run and
// loads the leading d features of it in groups of FM_DEPTH (8) rows, one
// 16-byte ld.global.nc a row that does not allocate in L1 (every byte is
// read once); the next group's loads go out before this group's fmas, so
// a thread keeps up to 256 B in flight, and it keeps one accumulator per
// token. q̂ is read through L1 inside the dot (no staging, no barrier
// before the first load). A piece wholly at or past cur_len is not read,
// and a run with no live token writes its blocks' -1e30 and reads
// nothing. The scores go through shared memory (4 B a token of the run)
// to a warp max per block. Where bs * sizeof(TK) is not a multiple of 16
// a run does not start on a piece, and each thread scores single tokens
// with scalar loads, 8 features a group all the same. The TPU's layout
// reason (lane tiling, DESIGN.md §3.1) does not exist here; only the
// output matters.
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

// The feature-major kernel's run: THREADS pieces of 16 bytes of tokens
constexpr int FM_RUN_BYTES = THREADS * 16;
constexpr int FM_DEPTH = 8;        // feature rows a group (two in flight)

// P tokens of one feature row as stored, in W 32-bit words: a 16-byte
// piece (P = 4 fp32 or 8 bf16; 16-byte aligned, W = 4) through the
// non-coherent path without an L1 allocation, or one element (P = W = 1).
// volatile keeps a group's loads together: ptxas otherwise moves each next
// to its fmas. The words stay packed until their fma.
template <int P>
__host__ __device__ constexpr int fm_words() {
  return P == 1 ? 1 : 4;
}
template <typename TK, int P>
__device__ __forceinline__ void load_tokens(const TK* p, uint32_t* w) {
  static_assert(sizeof(TK) == 4 || sizeof(TK) == 2, "fp32 or bf16 K̂ᵀ");
  if constexpr (P == 1) {
    if constexpr (sizeof(TK) == 4)
      w[0] = *reinterpret_cast<const unsigned int*>(p);
    else
      w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else {
    static_assert(P * sizeof(TK) == 16, "a 16-byte piece");
    asm volatile(
        "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p));
  }
}
// token u of those words as float32; bf16 to float32 is exact (the 16
// bits become the high half)
template <typename TK>
__device__ __forceinline__ float token(const uint32_t* w, int u) {
  if constexpr (sizeof(TK) == 4) return __uint_as_float(w[u]);
  return __uint_as_float(u & 1 ? w[u >> 1] & 0xffff0000u : w[u >> 1] << 16);
}

// FM_DEPTH feature rows of the P tokens at ``rows`` (row e at rows + e * S)
template <typename TK, int P>
__device__ __forceinline__ void fm_load(
    const TK* __restrict__ rows, int64_t S,
    uint32_t (&kv)[FM_DEPTH][fm_words<P>()]) {
#pragma unroll
  for (int e = 0; e < FM_DEPTH; ++e)
    load_tokens<TK, P>(rows + e * S, kv[e]);
}

// acc[u] = fma(q̂[e], k[e][u], acc[u]) for e = 0 .. FM_DEPTH - 1 in order;
// q̂ is read through L1, where a CTA's threads share it
template <typename TQ, typename TK, int P>
__device__ __forceinline__ void fm_fma(
    const TQ* __restrict__ q, const uint32_t (&kv)[FM_DEPTH][fm_words<P>()],
    float* acc) {
#pragma unroll
  for (int e = 0; e < FM_DEPTH; ++e) {
    const float qf = to_f(__ldg(q + e));
#pragma unroll
    for (int u = 0; u < P; ++u)
      acc[u] = fmaf(qf, token<TK>(kv[e], u), acc[u]);
  }
}

// acc[u] += q̂[:d]·K̂ᵀ[:d, u] for the P tokens at ``col`` (feature f at
// col + f * S), one fma per feature from f = 0 up. Two groups of FM_DEPTH
// rows live in registers: the next group's loads go out before this
// group's fmas. d % FM_DEPTH == 0 (the kernel's contract).
template <typename TQ, typename TK, int P>
__device__ __forceinline__ void fm_dot(const TK* __restrict__ col,
                                       int64_t S, const TQ* __restrict__ q,
                                       int d, float* acc) {
  uint32_t a[FM_DEPTH][fm_words<P>()], b[FM_DEPTH][fm_words<P>()];
  fm_load<TK, P>(col, S, a);
  for (int f = 0; f < d; f += 2 * FM_DEPTH) {
    if (f + FM_DEPTH < d) fm_load<TK, P>(col + (f + FM_DEPTH) * S, S, b);
    fm_fma<TQ, TK, P>(q + f, a, acc);
    if (f + FM_DEPTH >= d) break;
    if (f + 2 * FM_DEPTH < d)
      fm_load<TK, P>(col + (f + 2 * FM_DEPTH) * S, S, a);
    fm_fma<TQ, TK, P>(q + f + FM_DEPTH, b, acc);
  }
}

// P = 16 / sizeof(TK) tokens a thread (16-byte pieces) or P = 1 (a run
// that does not start on a piece)
template <typename TQ, typename TK, int P>
__global__ void __launch_bounds__(THREADS)
block_max_scores_fm_kernel(const TQ* __restrict__ q,
                           const TK* __restrict__ k,
                           const int* __restrict__ cur_len,
                           float* __restrict__ out, int S, int D, int d,
                           int bs, int blocks_per_cta, float scale) {
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);  // blocks_per_cta * bs
  const int r = blockIdx.y, tid = threadIdx.x;
  const int nb = S / bs;
  const int j0 = blockIdx.x * blocks_per_cta;
  const int nblk = min(blocks_per_cta, nb - j0);
  const int ln = cur_len[r];
  const int t0 = j0 * bs, ntok = nblk * bs;
  float* o = out + (int64_t)r * nb + j0;
  if (t0 >= ln) {                 // no live position: -1e30, nothing read
    for (int j = tid; j < nblk; j += THREADS) o[j] = NEG_INF;
    return;
  }
  const TQ* qr = q + (int64_t)r * D;
  const int live = min(ntok, ln - t0);
  const TK* col = k + (int64_t)r * D * S + t0;  // K̂ᵀ[r, f, t0 + i]
  for (int i = tid * P; i < ntok; i += THREADS * P) {
    float acc[P];
#pragma unroll
    for (int u = 0; u < P; ++u) acc[u] = 0.f;
    if (i < live) fm_dot<TQ, TK, P>(col + i, S, qr, d, acc);
    float v[P];
#pragma unroll
    for (int u = 0; u < P; ++u)
      v[u] = i + u < live ? acc[u] * scale : NEG_INF;   // scale after the dot
    if constexpr (P % 4 == 0) {
#pragma unroll
      for (int u = 0; u < P; u += 4)
        *reinterpret_cast<float4*>(sc + i + u) =
            make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
    } else {
      sc[i] = v[0];
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int b = warp; b < nblk; b += NWARPS) {
    float m = NEG_INF;
    // a block with no live position stays exactly NEG_INF
    if ((j0 + b) * bs < ln)
      for (int i = lane; i < bs; i += 32) m = fmaxf(m, sc[b * bs + i]);
    m = warp_max(m);
    if (lane == 0) o[b] = m;
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
  long long* info;    // feature-major, not null: report, no launch

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

// The feature-major launch at a shape: 16-byte pieces or elements, the
// blocks of a run, the dynamic shared memory (tuning.scores_fm_smem_bytes)
template <typename TK>
struct FmPlan {
  bool vec;
  int bpc;
  size_t smem;
  explicit FmPlan(const Launch& a) {
    constexpr int run = FM_RUN_BYTES / (int)sizeof(TK);
    // a run starts on a 16-byte piece of each feature row (S is a
    // multiple of bs, so the rows' length is a multiple of 16 bytes too)
    vec = (a.bs * sizeof(TK)) % 16 == 0;
    bpc = a.bs >= run ? 1 : run / a.bs;
    smem = sizeof(float) * (size_t)bpc * a.bs;
  }
};

template <typename TQ, typename TK>
struct ScoresFm {
  template <int P>
  static cudaError_t go(const Launch& a, const FmPlan<TK>& p) {
    auto kern = block_max_scores_fm_kernel<TQ, TK, P>;
    cudaError_t err = allow_smem(kern, p.smem);
    if (err != cudaSuccess) return err;
    if (a.info) {
      cudaFuncAttributes attr;
      int per_sm = 0;
      err = cudaFuncGetAttributes(&attr, kern);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            THREADS, p.smem);
      if (err != cudaSuccess) return err;
      a.info[0] = p.vec;
      a.info[1] = (long long)p.smem;
      a.info[2] = per_sm;
      a.info[3] = attr.numRegs;
      a.info[4] = (long long)attr.localSizeBytes;
      a.info[5] = p.bpc;
      return cudaSuccess;
    }
    const dim3 grid((a.S / a.bs + p.bpc - 1) / p.bpc, a.BH);
    kern<<<grid, THREADS, p.smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const int*>(a.cur_len), static_cast<float*>(a.out), a.S,
        a.D, a.d, a.bs, p.bpc, a.scale);
    return cudaGetLastError();
  }
  static cudaError_t run(const Launch& a) {
    const FmPlan<TK> p(a);
    return p.vec ? go<(int)(16 / sizeof(TK))>(a, p) : go<1>(a, p);
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
                 static_cast<cudaStream_t>(stream), nullptr};
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
                 static_cast<cudaStream_t>(stream), nullptr};
  if (!a.ok() || d % 8 != 0) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<ScoresFm>(q_bf16, k_bf16, a);
}

// What a feature-major launch at this shape would use, without launching:
// info[0] 1 for 16-byte pieces (0: element by element), info[1] its
// dynamic shared memory, info[2] resident CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), info[3] registers and
// info[4] local (spill) bytes a thread, info[5] blocks per CTA.
extern "C" int loki_block_max_scores_fm_info(int q_bf16, int k_bf16, int BH,
                                             int S, int D, int d, int bs,
                                             long long* info) {
  const Launch a{nullptr, nullptr, nullptr, nullptr, BH, S, D, d, bs, 1.f,
                 nullptr, info};
  if (!a.ok() || d % 8 != 0 || info == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)by_dtype<ScoresFm>(q_bf16, k_bf16, a);
}
