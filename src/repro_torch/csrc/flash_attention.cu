// Flash attention (causal or not) for Hopper (sm_90a): a bf16 tensor-core
// body for bf16 q, k, v and a float32 CUDA-core body for every other dtype
// combination.
//
// Replaces the Pallas TPU kernel flash_attention
// (repro/kernels/flash_attention.py:67): q (BH, Sq, D), k and v (BH, Sk, D)
// -> (BH, Sq, D) in q's dtype, softmax(q k^T * scale) v with the online
// softmax of flash_attention.py:47-62 (running max with the -1e30 / m_safe
// guards, alpha = 0 for an empty row, 1e-30 floor on the denominator). The
// causal mask is top-left aligned: query i sees keys j <= i, both counted
// from 0, also when Sq != Sk.
//
// What bounds it on an H100: operations. llama2-7b's prefill shape (BH 32,
// Sq = Sk = 3072, D 128, causal) does 4 * BH * D * Sq * Sk / 2 = 77 GFLOP on
// 100 MB of bf16 in and out: 0.08 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 0.03 ms of bytes.
//
// The bf16 body (flash_tc_kernel) reaches the tensor cores. A CTA of three
// warpgroups takes a 128-query tile of one row: warpgroup 0 is the
// producer, whose one thread feeds TMA loads (cp.async.bulk.tensor, 128-byte
// swizzle) of the Q tile and of a two-stage ring of K/V tiles, with mbarrier
// completion (full: bytes landed; empty: all 8 consumer warps done with the
// K or the V half of a stage); warpgroups 1 and 2 each own 64 query rows:
//   S = Q·Kᵀ   wgmma m64n{BK}k16, A = Q and B = the K tile, both K-major
//              from shared memory, bf16 products summed in float32;
//   P·V        wgmma m64n{D}k16 with A = P from registers (the S
//              accumulator rounded to bf16 A fragments in place) and B = the
//              V tile read with the transpose bit.
// The online softmax stays float32 in registers: unscaled bf16 q times bf16
// k (exact products), the scale applied to the float32 scores together
// with log2(e) so that exp is one ex2.approx, the TPU body's m_safe /
// alpha / 1e-30 guards, and the row sum l taken over the float32 P. The one
// rounding the TPU body does not have is P -> bf16 before P·V.
//
// What sets its pace is the softmax's exponentials, not the tensor cores:
// one per score against 512 flops of products at D = 128, on a unit 16
// wide per SM. So exp is one MUFU instruction (not the library exp2f),
// tile kt's softmax runs while the tensor cores do tile kt - 1's P·V
// (issue S_kt and PV_kt-1, wait for S_kt alone), and the two consumers
// take turns to issue their products (named barriers), so one's softmax
// meets the other's wgmma. On the card each choice beat its alternative
// (and a third K/V stage did not help): PERF.md §6.
// Key tiles above the causal diagonal are never loaded; the longest causal
// loops are issued first. The producer drops to 24 registers and the
// consumers rise to 240 (setmaxnreg); ptxas reports 168 registers (the
// 384-thread launch bound) and no spill at D 64, 128 and 256. Tiles: BK =
// 128 keys at D <= 128 and 64 at D = 256 (the D = 256 accumulator alone is
// 128 registers a thread); dynamic shared memory 1 KB alignment + Q (128 x
// D bf16) + 2 stages of K and V (BK x D bf16 each): 82,944 B at D 64,
// 164,864 B at D 128, 197,632 B at D 256. Rows past Sq and keys past Sk
// arrive as zeros (TMA's out-of-bounds fill) and are masked, so any Sq, Sk
// >= 1 runs; TMA needs 16-byte row strides, so D is a multiple of 8 (the
// wrapper raises otherwise).
//
// Every other dtype combination (float32, or float32 mixed with bf16) runs
// the float32 body (flash_attention_kernel): its callers asked for float32
// digits, which TF32 tensor cores would not keep. Its products are fp32
// FMAs on the CUDA cores (67 TFLOP/s): tiles of BQ = 64 queries and BK = 64
// keys live in shared memory as float32, each thread holds a 4 x 4 block of
// scores and a 4-row slice of the output in registers, so every
// shared-memory load feeds 4 (scores) or 4 to 16 (output) FMAs, and key
// tiles wholly above the causal diagonal are never loaded. Thread (ty, tx)
// = (tid / 16, tid % 16) of its 256 owns query rows 4 ty .. 4 ty + 3; for
// the scores the keys tx + 16 jj (jj < 4), for the output the columns
// 4 tx + 64 mm + e. A row's 16 owners are 16 lanes of one warp, so row
// maxima and sums are warp shuffles. Tiles are zero-filled past Sq, Sk and
// D, and masked keys get -1e30; it takes D <= 256.
//
// The wrapper enforces the TPU contract's block divisibility for both.
#include "decode_common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------- bf16 tensor-core body

namespace tc {

using namespace hopper;

constexpr int BQ = 128;            // queries per CTA: 64 per consumer
constexpr int NTHREADS = 384;      // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Tile {
  static constexpr int BK = DP == 256 ? 64 : 128;   // keys per stage
  static constexpr int STAGES = 2;         // depth of the K/V ring
  static constexpr int PANELS = DP / 64;   // 64-column (128 B) panels
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Shared memory holds each tile as PANELS panels of (rows x 64) bf16, one
// 128-byte row per key or query, swizzled by TMA in 8-row (1024 B) atoms.
template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_tc_kernel(__grid_constant__ const CUtensorMap tq,
                __grid_constant__ const CUtensorMap tk,
                __grid_constant__ const CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int Sq, int Sk, int D,
                int causal, float scale_log2) {
  using T = Tile<DP>;
  constexpr int BK = T::BK, STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES],
      k_empty[STAGES], v_empty[STAGES];
  // TMA's 128-byte swizzle repeats every 1024 B: align the tiles to it
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + T::Q_BYTES;                  // STAGES x KV_BYTES
  uint8_t* Vs = Ks + STAGES * T::KV_BYTES;        // STAGES x KV_BYTES

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest loops first
  const int q_last = min(q0 + BQ, Sq) - 1;
  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, q_last / BK + 1);   // tiles above: masked

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMER_WARPS);
      mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load. K and V
    // stages are freed apart (K after S = Q·Kᵀ, V after P·V), so K runs
    // about two tiles ahead of its use.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&q_full, T::Q_BYTES);
      for (int p = 0; p < T::PANELS; ++p)
        tma_load_3d(Qs + p * BQ * 128, &tq, &q_full, 64 * p, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        // a fresh barrier counts as done for parity 1: the first STAGES
        // waits pass
        const uint32_t free_phase = ((kt / STAGES) & 1) ^ 1;
        uint8_t* kd = Ks + s * T::KV_BYTES;
        uint8_t* vd = Vs + s * T::KV_BYTES;
        mbar_wait(&k_empty[s], free_phase);
        mbar_expect_tx(&k_full[s], T::KV_BYTES);
        for (int p = 0; p < T::PANELS; ++p)
          tma_load_3d(kd + p * BK * 128, &tk, &k_full[s], 64 * p, kt * BK,
                      bh);
        mbar_wait(&v_empty[s], free_phase);
        mbar_expect_tx(&v_full[s], T::KV_BYTES);
        for (int p = 0; p < T::PANELS; ++p)
          tma_load_3d(vd + p * BK * 128, &tv, &v_full[s], 64 * p, kt * BK,
                      bh);
      }
    }
    return;
  }

  // ---- consumer warpgroups: c owns query rows q0 + 64 c .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // accumulator element i of this thread: row row0 + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + col0 + (i & 1) (wgmma's m64nN float32 layout)
  const int row0 = q0 + 64 * c + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint8_t* Qc = Qs + c * 64 * 128;

  float o[DP / 2], sacc[BK / 2];
  uint32_t pa[BK / 16][4];          // P of the tile in flight, bf16 pairs
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // S = Q·Kᵀ of tile kt over D in k16 steps: panel kk / 4, 32 B steps
  // within it (issued, not waited for)
  auto issue_s = [&](int kt) {
    const uint8_t* k_s = Ks + (kt % STAGES) * T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(sacc, smem_desc(Qc + p * BQ * 128 + off, 16, 1024),
               smem_desc(k_s + p * BK * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P·V of tile kt, 16 keys (2048 B of each V panel) per step
  auto issue_pv = [&](int kt) {
    const uint8_t* v_s = Vs + (kt % STAGES) * T::KV_BYTES;
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      wgmma_rs(o, pa[t], smem_desc(v_s + t * 2048, BK * 128, 1024), 1);
    wgmma_commit();
  };
  // sacc -> float32 P in place (scores in log2 units, masked keys -1e30,
  // the TPU body's m_safe / alpha guards); updates m and l, sets alpha
  float alpha[2];
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + 64 * c);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      float x = sacc[i] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
        if (key >= Sk || (causal && key > row0 + 8 * r)) x = NEG_INF;
      }
      sacc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float m_safe[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's BK columns of this tile live in 4 lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      alpha[r] = m[r] > NEG_INF * 0.5f
                     ? ex2(fminf(m[r] - m_safe[r], 0.f)) : 0.f;
      m[r] = m_new;
    }
    // a masked score (-1e30) is at least 5e29 below m_safe, so its p
    // underflows to exactly 0, as the TPU body's select makes it
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sacc[i] = ex2(sacc[i] - m_safe[r]);
      rsum[r] += sacc[i];
    }
    // l stays a per-lane partial sum until the end: alpha is the same in
    // the row's 4 lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
  };
  // P as bf16 A fragments: keys 16 t .. 16 t + 15 are accumulator
  // elements 8 t .. 8 t + 7, already in the A operand's order
  auto pack_p = [&]() {
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[t][j] = pack_bf16(sacc[8 * t + 2 * j], sacc[8 * t + 2 * j + 1]);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Ping-pong: the two consumers take turns to issue their wgmma (named
  // barrier 1 + c is c's turn), so one's softmax runs while the other's
  // products do. Each has n_kt + 1 turns; warpgroup 1 opens the first
  // turn of warpgroup 0 and does not signal after its own last one.
  auto my_turn = [&]() { named_sync(1 + c, 256); };
  auto end_turn = [&](bool last) {
    if (!(last && c == 1)) named_arrive(2 - c, 256);
  };
  if (c == 1) named_arrive(1, 256);

  // Tile kt's softmax runs while the tensor cores do tile kt - 1's P·V:
  // issue S_kt and PV_{kt-1}, wait for S_kt only, softmax, then wait for
  // PV_{kt-1} before O is rescaled and P overwritten.
  mbar_wait(&q_full, 0);
  mbar_wait(&k_full[0], 0);
  my_turn();
  wgmma_fence();
  issue_s(0);
  end_turn(false);
  wgmma_wait<0>();
  fence_regs(sacc);
  release(&k_empty[0]);
  softmax(0);
  pack_p();
  for (int kt = 1; kt < n_kt; ++kt) {
    const int s = kt % STAGES, sp = (kt - 1) % STAGES;
    mbar_wait(&k_full[s], (kt / STAGES) & 1);
    mbar_wait(&v_full[sp], ((kt - 1) / STAGES) & 1);
    my_turn();
    wgmma_fence();
    issue_s(kt);
    issue_pv(kt - 1);
    end_turn(false);
    wgmma_wait<1>();                  // S_kt done, PV_{kt-1} may run on
    fence_regs(sacc);
    release(&k_empty[s]);
    softmax(kt);
    wgmma_wait<0>();
    fence_regs(o);
    release(&v_empty[sp]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p();
  }
  const int sl = (n_kt - 1) % STAGES;
  mbar_wait(&v_full[sl], ((n_kt - 1) / STAGES) & 1);
  my_turn();
  wgmma_fence();
  issue_pv(n_kt - 1);
  end_turn(true);
  wgmma_wait<0>();
  fence_regs(o);
  release(&v_empty[sl]);

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = out + (int64_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = row0 + 8 * r, col = 8 * (i >> 2) + col0;
    if (row < Sq && col < D)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * D + col) =
          __floats2bfloat162_rn(o[i] / den[r], o[i + 1] / den[r]);
  }
}

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// the library needs no -lcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled lookup_encoder() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t rc = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t rc = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(p);
}

// looked up once, thread-safe (a function-local static); null if the
// driver does not have it
inline EncodeTiled encoder() {
  static const EncodeTiled fn = lookup_encoder();
  return fn;
}

// (BH, S, D) bf16 as a 3-D tensor map read in boxes of 64 columns x rows,
// 128-byte swizzled; rows past S read as zeros
inline bool bf16_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
                     int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

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

template <int DP>
cudaError_t launch_flash_tc(const FlashLaunch& a) {
  using T = tc::Tile<DP>;
  CUtensorMap mq, mk, mv;
  if (!tc::bf16_map(&mq, a.q, a.BH, a.Sq, a.D, tc::BQ) ||
      !tc::bf16_map(&mk, a.k, a.BH, a.Sk, a.D, T::BK) ||
      !tc::bf16_map(&mv, a.v, a.BH, a.Sk, a.D, T::BK))
    return cudaErrorInvalidValue;
  auto kern = tc::flash_tc_kernel<DP>;
  cudaError_t err = allow_smem(kern, T::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.BH, (a.Sq + tc::BQ - 1) / tc::BQ), tc::NTHREADS, T::SMEM,
         a.stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(a.out), a.Sq,
                     a.Sk, a.D, a.causal, a.scale * tc::LOG2E);
  return cudaGetLastError();
}

}  // namespace loki

using namespace loki;

// q (BH, Sq, D) and k, v (BH, Sk, D), contiguous; q_bf16 / kv_bf16: 0 =
// float32, 1 = bfloat16 (k and v share one); out (BH, Sq, D) in q's dtype.
// bf16 q, k and v run the tensor-core body (D a multiple of 8), anything
// else the float32 body. Returns a cudaError_t.
extern "C" int loki_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int q_bf16,
                                    int kv_bf16, int BH, int Sq, int Sk,
                                    int D, int causal, float scale,
                                    void* stream) {
  const FlashLaunch a{q, k, v, out, BH, Sq, Sk, D, causal, scale,
                      static_cast<cudaStream_t>(stream)};
  if (BH < 1 || Sq < 1 || Sk < 1 || D < 1 || D > MAXDIM)
    return (int)cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    if (D <= 64) return (int)launch_flash_tc<64>(a);
    if (D <= 128) return (int)launch_flash_tc<128>(a);
    return (int)launch_flash_tc<256>(a);
  }
  return (int)by_dtype<Flash>(q_bf16, kv_bf16, a);
}
