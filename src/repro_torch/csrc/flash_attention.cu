// Flash attention (causal or not) for Hopper (sm_90a), float32 arithmetic.
//
// Replaces the Pallas TPU kernel flash_attention
// (repro/kernels/flash_attention.py:67): q (BH, Sq, D), k and v (BH, Sk, D)
// -> (BH, Sq, D) in q's dtype, softmax(q k^T * scale) v with the online
// softmax of flash_attention.py:47-56 (running max with the -1e30 / m_safe
// guards, alpha rescaling, 1e-30 floor on the denominator). The causal mask
// is top-left aligned: query i sees keys j <= i, both counted from 0, also
// when Sq != Sk.
//
// What bounds it on an H100: operations. llama2-7b's prefill shape (BH 32,
// Sq = Sk = 3072, D 128, causal) does 4 * BH * D * Sq * Sk / 2 = 77 GFLOP on
// 100 MB of bf16 in and out: 0.08 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 0.03 ms of bytes. This kernel does its products in float32
// on the CUDA cores (67 TFLOP/s, 1.2 ms at best), as the TPU kernel's body
// computes in float32; tensor cores (wgmma with TMA-fed tiles) are the
// redesign's work. What this design does about the operation count: tiles
// of BQ = 64 queries and BK = 64 keys live in shared memory, each thread
// holds a 4 x 4 block of scores and a 4-row slice of the output in
// registers, so every shared-memory load feeds 4 (scores) or 4 to 16
// (output) FMAs, and key tiles wholly above the causal diagonal are never
// loaded. CTAs with the longest causal loops are issued first.
//
// Grid: one CTA of 256 threads per (query tile, row). Thread (ty, tx) =
// (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3; for the scores
// the keys tx + 16 jj (jj < 4), for the output the columns 4 tx + 64 mm
// + e. A row's 16 owners are 16 lanes of one warp, so row maxima and sums
// are warp shuffles. Tiles are zero-filled past Sq, Sk and D, and masked
// keys get -1e30, so any Sq, Sk >= 1 and D <= 256 run; the wrapper
// enforces the TPU contract's block divisibility.
#include "decode_common.cuh"

namespace loki {

constexpr int FBQ = 64;          // queries per tile
constexpr int FBK = 64;          // keys per tile
constexpr int FTHREADS = 256;    // 16 x 16 threads
constexpr int PLD = FBK + 4;     // row stride of the probability tile

template <int DP>
constexpr size_t flash_smem() {
  return sizeof(float) * ((size_t)(FBQ + 2 * FBK) * (DP + 4) +
                          (size_t)FBQ * PLD);
}

// rows x DP tile of src rows row0.., zero past n_rows and D, times mul
template <int DP, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst, int row0, int n_rows,
                                          int D, float mul, int rows) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < rows * DP; idx += FTHREADS) {
    const int r = idx / DP, f = idx % DP, row = row0 + r;
    dst[r * LD + f] = (row < n_rows && f < D)
                          ? to_f(src[(int64_t)row * D + f]) * mul
                          : 0.f;
  }
}

template <typename TQ, typename TK, int DP>
__global__ void __launch_bounds__(FTHREADS)
flash_attention_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                       const TK* __restrict__ v, TQ* __restrict__ out,
                       int Sq, int Sk, int D, int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int NC = DP / 64;                 // float4 output columns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // FBQ x LD, scaled
  float* Ks = Qs + FBQ * LD;                    // FBK x LD
  float* Vs = Ks + FBK * LD;                    // FBK x LD
  float* Ps = Vs + FBK * LD;                    // FBQ x PLD

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;    // longest loops first
  const int bh = blockIdx.y;
  const int q0 = qt * FBQ;
  const TQ* qb = q + (int64_t)bh * Sq * D;
  const TK* kb = k + (int64_t)bh * Sk * D;
  const TK* vb = v + (int64_t)bh * Sk * D;

  // q is scaled in float32 before the dot, as the TPU kernel does
  load_tile<DP>(qb, Qs, q0, Sq, D, scale, FBQ);

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = NEG_INF;
    l[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[ii][c] = 0.f;
  }

  const int q_last = min(q0 + FBQ, Sq) - 1;
  int n_kt = (Sk + FBK - 1) / FBK;
  if (causal) n_kt = min(n_kt, q_last / FBK + 1);   // tiles above: all masked

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * FBK;
    load_tile<DP>(kb, Ks, k0, Sk, D, 1.f, FBK);
    load_tile<DP>(vb, Vs, k0, Sk, D, 1.f, FBK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
    for (int f = 0; f < DP; f += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        a[ii] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + ii) * LD + f);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * jj) * LD + f);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float t = s[ii][jj];
          t = fmaf(a[ii].x, b[jj].x, t);
          t = fmaf(a[ii].y, b[jj].y, t);
          t = fmaf(a[ii].z, b[jj].z, t);
          t = fmaf(a[ii].w, b[jj].w, t);
          s[ii][jj] = t;
        }
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int qpos = q0 + ty * 4 + ii;
      float bm = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        const bool live = kpos < Sk && (!causal || qpos >= kpos);
        s[ii][jj] = live ? s[ii][jj] : NEG_INF;
        bm = fmaxf(bm, s[ii][jj]);
      }
      for (int o = 8; o > 0; o >>= 1)
        bm = fmaxf(bm, __shfl_xor_sync(FULL, bm, o));
      const float m_new = fmaxf(m[ii], bm);
      const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      const float alpha =
          m[ii] > NEG_INF * 0.5f ? expf(fminf(m[ii] - m_safe, 0.f)) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p =
            s[ii][jj] <= NEG_INF * 0.5f ? 0.f : expf(s[ii][jj] - m_safe);
        Ps[(ty * 4 + ii) * PLD + tx + 16 * jj] = p;
        sum += p;
      }
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      l[ii] = l[ii] * alpha + sum;
      m[ii] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[ii][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < FBK; ++j) {
      float p[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) p[ii] = Ps[(ty * 4 + ii) * PLD + j];
#pragma unroll
      for (int mm = 0; mm < NC; ++mm) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + j * LD + tx * 4 + 64 * mm);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          acc[ii][mm * 4 + 0] = fmaf(p[ii], vv.x, acc[ii][mm * 4 + 0]);
          acc[ii][mm * 4 + 1] = fmaf(p[ii], vv.y, acc[ii][mm * 4 + 1]);
          acc[ii][mm * 4 + 2] = fmaf(p[ii], vv.z, acc[ii][mm * 4 + 2]);
          acc[ii][mm * 4 + 3] = fmaf(p[ii], vv.w, acc[ii][mm * 4 + 3]);
        }
      }
    }
    __syncthreads();                  // Ks, Vs, Ps are rewritten next tile
  }

  TQ* ob = out + (int64_t)bh * Sq * D;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qpos = q0 + ty * 4 + ii;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[ii], 1e-30f);
#pragma unroll
    for (int mm = 0; mm < NC; ++mm)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 64 * mm + e;
        if (c < D)
          store_f(ob + (int64_t)qpos * D + c, acc[ii][mm * 4 + e] * inv);
      }
  }
}

struct FlashLaunch {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int BH, Sq, Sk, D, causal;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TK, int DP>
cudaError_t launch_flash(const FlashLaunch& a) {
  constexpr size_t smem = flash_smem<DP>();
  auto kern = flash_attention_kernel<TQ, TK, DP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((a.Sq + FBQ - 1) / FBQ, a.BH), FTHREADS, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
      static_cast<const TK*>(a.v), static_cast<TQ*>(a.out), a.Sq, a.Sk, a.D,
      a.causal, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TK>
struct Flash {
  static cudaError_t run(const FlashLaunch& a) {
    if (a.D <= 64) return launch_flash<TQ, TK, 64>(a);
    if (a.D <= 128) return launch_flash<TQ, TK, 128>(a);
    return launch_flash<TQ, TK, 256>(a);
  }
};

}  // namespace loki

using namespace loki;

// q (BH, Sq, D) and k, v (BH, Sk, D), contiguous; q_bf16 / kv_bf16: 0 =
// float32, 1 = bfloat16 (k and v share one); out (BH, Sq, D) in q's dtype.
// Returns a cudaError_t.
extern "C" int loki_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int q_bf16,
                                    int kv_bf16, int BH, int Sq, int Sk,
                                    int D, int causal, float scale,
                                    void* stream) {
  const FlashLaunch a{q, k, v, out, BH, Sq, Sk, D, causal, scale,
                      static_cast<cudaStream_t>(stream)};
  if (BH < 1 || Sq < 1 || Sk < 1 || D < 1 || D > MAXDIM)
    return (int)cudaErrorInvalidValue;
  return (int)by_dtype<Flash>(q_bf16, kv_bf16, a);
}
