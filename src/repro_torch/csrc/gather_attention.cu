// GQA-batched decode attention for Hopper (sm_90a), contiguous or paged
// caches: block_sparse_attention_grouped and the split-KV full decode, with
// their launchers and shape queries, and the per-head
// block_sparse_attention. One build covers the storage types its define
// names (decode_common.cuh by_storage): none for float32 and bfloat16
// caches (the per-head kernel, which has no other storage, builds only
// there), -DLOKI_STORAGE_F16, _I8 or _F8 for one other storage each
// (kernels/_build.py builds each as a library of its own).
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
// block_sparse_attention replaces the per-head Pallas TPU kernel of the
// same name (repro/kernels/gather_attention.py:75), the last stage of the
// per-head pipeline (ops.loki_decode_attention): exact online-softmax
// attention of each (BH) row over its own blk_idx (BH, n_sel) blocks,
// masking positions >= cur_len; a row masked everywhere gives zeros. It
// has no window and no page table, as the TPU kernel has none.
//
// What bounds all of them on an H100: bytes. They read each K̂ block of
// width W and V block of width D per (b, kv-head) once, whatever G is (the
// G query heads of a KV group share every block), and do O(G) FMAs per
// element read (llama2-7b at 4 slots, 8 blocks of 128 fp32 tokens per
// row: 134 MB, 40 us at 3.35 TB/s). The TPU kernels walked the blocks as a
// sequential grid axis (or a fori_loop) with the softmax state in scratch.
// One CTA per row, walking its blocks, is 128 CTAs on 132 SMs at that
// shape, so all three split each row's work over several CTAs. Over fp32
// and bf16 caches all three stream through the wide body
// (decode_common.cuh stream_chunks): each of a CTA's 4 warps streams its
// own chunks of 4 tokens (8 for the per-head kernel over bf16) through a
// private two-stage shared-memory ring filled by 16-byte cp.async (the
// next chunk's K̂ and V rows in flight while the warp computes on this
// one; no CTA barrier in the loop): lanes hold 4 columns (8 at D > 128), a
// token's G scores are warp sums, and the warp keeps its own (G,) online
// softmax and (G, D) accumulators in registers. Widths whose rows are not
// 16-byte multiples are copied element by element into the same ring.
//
// Over fp16, int8 and fp8 caches (one library per storage, the grouped
// kernel and the full decode only) the same warps and rings run the
// narrow body (stream_narrow, NarrowSrc), which sizes its chunks in
// bytes rather than tokens: a stage holds the largest power of two of
// tokens, at most 32, whose K̂ and V rows fit 5 KB (32 tokens at
// int8:pca:r=32, 160 B a token; 16 at int8 or fp8 native; 8 at fp16
// native), cut to a divisor of bs, and a chunk runs from a block's first
// live token and never leaves the block, so a chunk is one page: one
// page-table read, one pair of page scales, and the rows by 16-byte
// cp.async spread over all 32 lanes. Its scores run with the lanes across
// tokens (32 / T lanes a token, one or a few xor shuffles), the K scale
// multiplying each token's dot; the online softmax takes one max and one
// sum per chunk and head; p·V keeps the lanes across the columns, each
// token's p times the V scale broadcast from its lane. The wide body's
// 4-token stages carried 0.6 KB at int8:pca:r=32 and paid a warp sum, an
// expf and a scale multiply per element for every token, whatever the
// storage; the wide body and its machine code are unchanged. Either body
// ends in the same warp state, so the 4 warps merge by log-sum-exp in
// shared memory (merge_warps) alike.
//
// block_sparse_attention_grouped and block_sparse_attention: one
// thread-block cluster of C CTAs per row, (slot, kv-head) or (BH) row, C
// from shapes only (cluster_size, the fused kernels' rule: about 4 CTAs
// per SM; 4 at llama2-7b's 128 rows, so 512 CTAs). Every CTA keeps the
// row's entries in [0, S / bs) in list order (keep_valid; -1 and other
// entries contribute nothing), takes an equal share of them and streams
// their live tokens; CTA rank 0 merges the C partials by log-sum-exp in
// rank order through distributed shared memory (attend_share, the fused
// kernels' phases 3-4). The pair select_blocks + grouped therefore runs
// the fused kernel's selection, shares and merge order, and gives its
// bits. Shared memory (attend_layout, mirrored by kernels/tuning.py
// attend_smem_bytes): the float32 query, the kept list, and the rings,
// which the merges reuse: 33,312 B at llama2-7b's fp32 cache (n_sel 8),
// 45,344 B at int8:pca:r=32 (a list so long that the narrow ring no
// longer fits beside it halves the narrow stage). The per-head kernel
// reads K̂ through a row, a token and a feature stride, so the
// feature-major pipeline reads the selected blocks straight from K̂ᵀ (BH,
// D, S): each feature row's run of a chunk's tokens is one 16-byte
// cp.async into a feature-major stage
// (head_fill), from which each lane reads its own features' pieces, so
// both layouts sum every dot in the same order and give the same bits.
// Its scores are q̂·k̂ then * scale, the TPU kernel's order. Chunks of 8
// fp32 (16 bf16) tokens, whose feature-row runs are whole 32-byte
// sectors, made the feature-major read as fast as the token-major one but
// slowed the token-major one (twice the ring, fewer resident CTAs) and
// both over bf16 caches, so the runs stay 16 bytes (PERF.md §6). ptxas
// (-O3, sm_90a): the grouped kernel at G <= 1, D <= 128 80-126 registers
// (16 B spilled over an fp32 cache), G <= 4 115-128, G <= 16 at D > 128
// 255 registers and 588-596 B of spill stores; the per-head kernel 55-95
// registers, no spill. Over fp16, int8 and fp8 (the narrow body) the
// grouped kernel at G <= 1 takes 40-64 registers (72-128 before it) and
// the full decode 56-64 (90-94).
//
// full_decode is split-KV: grid (Hkv, B, n_split); split s takes an equal
// share of the live block range [lo, hi), computed on the device from
// cur_len; n_split comes from the host, from shapes only (the wrapper aims
// at about 4 CTAs per SM), so the host never reads cur_len. Each split
// writes its partial (acc[G, D], m, l) in float32 to a scratch tensor; a
// second small kernel in the same launcher call merges the n_split
// partials by log-sum-exp (alpha = 0 for an empty partial, the 1e-30
// floor) into (B, Hkv, G, D). A split with no live block writes m = -1e30,
// l = 0. The wide body's split streams 4-token chunks from its first live
// token; the narrow body's the first block's chunks from there, then
// T-aligned ones, so none leaves its block (a window's start may cut the
// first). Shared memory: the scaled query (G x W float32) + 4 warps x 2
// ring stages, the warp merge reusing the ring: 32.5 KB at llama2-7b's
// fp32 cache (4 tokens x (W + D) floats a stage), so its 512 CTAs are all
// resident at once: small chunks and many resident warps beat deeper rings
// and longer chunks for the wide body (measured on an H100: PERF.md §6);
// 44.3 KB at int8:pca:r=32 (32 tokens a stage).
//
// Paged mode (full decode, grouped): with a page table the caches are the
// pools (R, Hkv, ·) and every block read resolves through BlockRows; S is
// the logical length n_tab * page_size. Paged and contiguous run the same
// shares, so their outputs are bit-identical. Quantized pools (int8, fp8
// codes, per-page float32 K and V scales, paged only) take the narrow
// body, its stages carrying their page's scales after the rows; at
// int8:pca:r=32 a token's K and V rows are 160 B against 1 KB in fp32.
#include "decode_common.cuh"

namespace loki {

// One CTA of the grouped kernel: its cluster of C attends the (slot b,
// kv-head h) row of blk_idx.
template <typename TQ, typename TK, int GM, int DC>
__global__ void __launch_bounds__(SPLIT_THREADS)
grouped_cluster_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                       const TK* __restrict__ v,
                       const int* __restrict__ blk_idx,
                       const int* __restrict__ cur_len, BlockRows rows,
                       TQ* __restrict__ out, int Hkv, int G, int W, int D,
                       int bs, int nb, int n_sel, float scale,
                       int sliding_window, int vec) {
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const AttendLayout L = attend_layout<TK, SPLIT_TOK>(G, W, D, n_sel);
  const int Wp = pad4(W);
  const size_t bh = (size_t)b * Hkv + h;
  float* qs = reinterpret_cast<float*>(base + L.qs);        // G x Wp, scaled
  int* sel = reinterpret_cast<int*>(base + L.sel);           // n_sel
  for (int i = tid; i < G * Wp; i += SPLIT_THREADS) {
    const int g = i / Wp, c = i % Wp;
    qs[i] = c < W ? to_f(q[(bh * G + g) * W + c]) * scale : 0.f;
  }
  const int nv = keep_valid(blk_idx + bh * n_sel, n_sel, nb, sel);
  if constexpr (Narrow<TK>::value) {
    attend_share_narrow<TQ, TK, GM, DC>(
        sel, nv, qs, base + L.uni, L.tok, k, v, rows, b, h, Hkv, cur_len[b],
        G, W, D, bs, sliding_window, out + bh * G * D);
  } else {
    attend_share<TQ, TK, SPLIT_TOK, false, false, GM, DC>(
        sel, nv, qs, base + L.uni, split_stage_bytes<TK>(W, D),
        [&](uint8_t* stage, int pos0, int t1) {
          split_fill(stage, k, v, rows, b, h, Hkv, W, D, bs, pos0, t1,
                     vec != 0, lane);
        },
        cur_len[b], G, W, D, bs, sliding_window, 1.f, out + bh * G * D);
  }
}

// ---------------------------------------------------- split-KV full decode

// The split kernel's dynamic shared memory: the scaled float32 query (G x
// pad4(W)), then the 4 warps' rings (attn_stage_bytes), which the warp
// merge (4 x G x (D + 2) float32) reuses. Exported as loki_full_smem_bytes;
// kernels/tuning.py full_smem_bytes mirrors it.
template <typename TK>
inline size_t split_smem_bytes(int G, int W, int D) {
  const size_t ring = (size_t)SPLIT_WARPS * SPLIT_STAGES *
                      attn_stage_bytes<TK>(W, D);
  const size_t merge = sizeof(float) * SPLIT_WARPS * G * (D + 2);
  return round16(sizeof(float) * G * pad4(W)) + (ring > merge ? ring : merge);
}

// GM >= G query heads per group, DC = column groups of 4 per lane (1 for
// D <= 128, 2 for D <= 256). part: (B, Hkv, n_split, G, D + 2) float32,
// each row acc[D], m, l.
template <typename TQ, typename TK, int GM, int DC>
__global__ void __launch_bounds__(SPLIT_THREADS)
full_decode_split_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                         const TK* __restrict__ v,
                         const int* __restrict__ cur_len, BlockRows rows,
                         float* __restrict__ part, int Hkv, int G, int W,
                         int D, int bs, int nb, float scale,
                         int sliding_window, int vec) {
  extern __shared__ float4 smem4[];
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Wp = pad4(W);
  const size_t bh = (size_t)b * Hkv + h;
  float* qs = reinterpret_cast<float*>(smem4);        // G x Wp, scaled
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4) +
                  round16(sizeof(float) * G * Wp);
  const size_t stage_bytes = split_stage_bytes<TK>(W, D);
  uint8_t* my_ring = ring + (size_t)warp * SPLIT_STAGES * stage_bytes;
  for (int i = tid; i < G * Wp; i += SPLIT_THREADS) {
    const int g = i / Wp, c = i % Wp;
    qs[i] = c < W ? to_f(q[(bh * G + g) * W + c]) * scale : 0.f;
  }

  // this split's share of the live blocks, then its live tokens [t0, t1)
  const int ln = cur_len[b];
  const BlockShare sh = block_share(ln, nb, bs, sliding_window, sp, n_split);
  int t0 = sh.first * bs;
  if (sliding_window > 0) t0 = max(t0, ln - sliding_window);
  const int t1 = min(sh.end * bs, ln);
  WarpSoftmax<GM, DC> st;
  if constexpr (Narrow<TK>::value) {
    // chunks that never leave a block: the first block's from t0, then
    // T-aligned ones (T divides bs), warp w taking chunks w, w + 4, ...
    const NarrowGeom ng =
        narrow_geom<TK>(W, D, bs, narrow_tokens(W, D, sizeof(TK)));
    const int T = ng.T;
    const int a = min((t0 / bs + 1) * bs, t1);   // the first block's end
    const int n0 = t1 > t0 ? (a - t0 + T - 1) >> ng.lt : 0;
    const int n_chunks = n0 + (t1 > a ? (t1 - a + T - 1) >> ng.lt : 0);
    const int my_n = n_chunks > warp
                         ? (n_chunks - warp + SPLIT_WARPS - 1) / SPLIT_WARPS
                         : 0;
    __syncthreads();                                  // qs
    st.init();
    stream_narrow<TK>(
        st, qs, ring + (size_t)warp * SPLIT_STAGES * ng.stage, ng,
        NarrowSrc<TK>{k, v, rows, b, h, Hkv, W, D, bs}, G, my_n,
        [&](int j) {
          const int c = warp + j * SPLIT_WARPS;
          return c < n0 ? make_int2(t0 + c * T, a)
                        : make_int2(a + (c - n0) * T, t1);
        },
        lane);
  } else {
    const int n_chunks =
        t1 > t0 ? (t1 - t0 + SPLIT_TOK - 1) / SPLIT_TOK : 0;
    // warp w takes chunks w, w + SPLIT_WARPS, ...
    const int my_n = n_chunks > warp
                         ? (n_chunks - warp + SPLIT_WARPS - 1) / SPLIT_WARPS
                         : 0;
    __syncthreads();                                  // qs

    st.init();
    stream_chunks<TK>(st, qs, my_ring, stage_bytes, G, W, D, my_n,
                      [&](int j) {
                        return make_int2(
                            t0 + (warp + j * SPLIT_WARPS) * SPLIT_TOK, t1);
                      },
                      [&](uint8_t* stage, int pos0, int end) {
                        split_fill(stage, k, v, rows, b, h, Hkv, W, D, bs,
                                   pos0, end, vec != 0, lane);
                      },
                      1.f, lane);
  }
  __syncthreads();                    // every ring is free: merge there
  merge_warps(st, reinterpret_cast<float*>(ring),
              part + (bh * n_split + sp) * G * (D + 2), G, D);
}

// Merge the n_split partials of each (b, kv-head) by log-sum-exp.
template <typename TQ>
__global__ void __launch_bounds__(SPLIT_THREADS)
full_decode_combine_kernel(const float* __restrict__ part,
                           TQ* __restrict__ out, int G, int D, int n_split) {
  const size_t bh = blockIdx.x;
  const float* pb = part + bh * n_split * G * (D + 2);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, c = i % D;
    store_f(out + bh * G * D + i,
            merge_partials([&](int s) { return pb + s * G * (D + 2); },
                           n_split, g, c, D));
  }
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const void* blk_idx;
  const void* cur_len;
  const void* table;
  const void* ksc;    // per-page scales of a quantized pool, else nullptr
  const void* vsc;
  void* out;
  int B, S, Hkv, G, W, D, bs, n_sel, n_tab, page_size;
  float scale;
  int sliding_window;
  cudaStream_t stream;
  float* part;        // full decode: the splits' partials
  int n_split;
  long long* info;    // not null: report the launch's plan, no launch

  BlockRows rows() const {
    return make_rows(table, n_tab, page_size, S, bs, ksc, vsc);
  }
  template <typename TK>
  bool storage() const {
    return storage_ok<TK>(table, ksc, vsc, true,
                          (W * sizeof(TK)) % 16 == 0 &&
                              (D * sizeof(TK)) % 16 == 0);
  }
  bool ok() const {
    return G >= 1 && G <= MAXG && W >= 1 && W <= MAXDIM && D >= 1 &&
           D <= MAXDIM && bs >= 1 && S % bs == 0 &&
           rows_ok(table, n_tab, page_size, S, bs);
  }
};

template <typename TQ, typename TK>
struct Grouped {
  template <int GM, int DC>
  static cudaError_t go(const Launch& a) {
    const int nb = a.S / a.bs;
    const AttendLayout L = attend_layout<TK, SPLIT_TOK>(a.G, a.W, a.D, a.n_sel);
    const int C = cluster_size(nb, a.B * a.Hkv, sm_count());
    // 16-byte copies need rows of whole 16-byte pieces
    const int vec =
        (a.W * sizeof(TK)) % 16 == 0 && (a.D * sizeof(TK)) % 16 == 0;
    return launch_cluster(
        grouped_cluster_kernel<TQ, TK, GM, DC>, a.Hkv, a.B, C, L.total,
        a.stream, a.info, static_cast<const TQ*>(a.q),
        static_cast<const TK*>(a.k), static_cast<const TK*>(a.v),
        static_cast<const int*>(a.blk_idx),
        static_cast<const int*>(a.cur_len), a.rows(), static_cast<TQ*>(a.out),
        a.Hkv, a.G, a.W, a.D, a.bs, nb, a.n_sel, a.scale, a.sliding_window,
        vec);
  }
  template <int GM>
  static cudaError_t by_width(const Launch& a) {
    return pad4(a.D) <= 128 ? go<GM, 1>(a) : go<GM, 2>(a);
  }
  static cudaError_t run(const Launch& a) {
    if (!a.storage<TK>()) return cudaErrorInvalidValue;
    if (a.G == 1) return by_width<1>(a);
    if (a.G <= 4) return by_width<4>(a);
    return by_width<MAXG>(a);
  }
};

template <typename TQ, typename TK>
struct Full {
  template <int GM, int DC>
  static cudaError_t go(const Launch& a) {
    const size_t smem = split_smem_bytes<TK>(a.G, a.W, a.D);
    // 16-byte copies need rows of whole 16-byte pieces
    const int vec =
        (a.W * sizeof(TK)) % 16 == 0 && (a.D * sizeof(TK)) % 16 == 0;
    auto kern = full_decode_split_kernel<TQ, TK, GM, DC>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    if (a.info != nullptr) {          // report, no launch
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, SPLIT_THREADS, smem);
      a.info[0] = Narrow<TK>::value
                      ? narrow_chunk(narrow_tokens(a.W, a.D, sizeof(TK)), a.bs)
                      : SPLIT_TOK;
      a.info[1] = (long long)attn_stage_bytes<TK>(a.W, a.D);
      a.info[2] = (long long)smem;
      a.info[3] = per_sm;
      return err;
    }
    kern<<<dim3(a.Hkv, a.B, a.n_split), SPLIT_THREADS, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const TK*>(a.v), static_cast<const int*>(a.cur_len),
        a.rows(), a.part, a.Hkv, a.G, a.W, a.D, a.bs, a.S / a.bs, a.scale,
        a.sliding_window, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    full_decode_combine_kernel<TQ><<<a.B * a.Hkv, SPLIT_THREADS, 0,
                                     a.stream>>>(
        a.part, static_cast<TQ*>(a.out), a.G, a.D, a.n_split);
    return cudaGetLastError();
  }
  template <int GM>
  static cudaError_t by_width(const Launch& a) {
    return pad4(a.D) <= 128 ? go<GM, 1>(a) : go<GM, 2>(a);
  }
  static cudaError_t run(const Launch& a) {
    if (!a.storage<TK>()) return cudaErrorInvalidValue;
    if (a.G == 1) return by_width<1>(a);
    if (a.G <= 4) return by_width<4>(a);
    return by_width<MAXG>(a);
  }
};

}  // namespace loki

using namespace loki;

// q_bf16: 0 = float32, 1 = bfloat16 query; kv the cache's storage code
// (decode_common.cuh KV_*); table is nullptr for a contiguous cache
// (n_tab = page_size = 0), else the (B, n_tab) int32 page table with S =
// n_tab * page_size; k_scale / v_scale the (n_pages,) float32 page scales
// of an int8 or fp8 pool, else nullptr. Returns a cudaError_t
// (cudaErrorInvalidValue for a storage this library is not built for).
extern "C" int loki_block_sparse_attention_grouped(
    const void* q, const void* k, const void* v, const void* blk_idx,
    const void* cur_len, const void* table, const void* k_scale,
    const void* v_scale, void* out, int q_bf16, int kv, int B, int S,
    int Hkv, int G, int W, int D, int bs, int n_sel, int n_tab,
    int page_size, float scale, int sliding_window, void* stream) {
  const Launch a{q, k, v, blk_idx, cur_len, table, k_scale, v_scale,
                     out, B, S, Hkv, G, W, D, bs, n_sel, n_tab, page_size,
                     scale, sliding_window,
                     static_cast<cudaStream_t>(stream), nullptr, 0, nullptr};
  if (!a.ok() || n_sel < 1) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Grouped>(q_bf16, kv, a);
}

// What a grouped launch at this shape would use, without launching:
// info[0] the cluster size C, info[1] the dynamic shared memory in bytes,
// info[2] cudaOccupancyMaxActiveClusters for that kernel, memory and C. A
// scaled storage is asked as if paged (the kernel takes it only so).
extern "C" int loki_grouped_cluster_info(int q_bf16, int kv, int B, int S,
                                         int Hkv, int G, int W, int D,
                                         int bs, int n_sel,
                                         long long* info) {
  static const int table = 0;
  static const float scale1 = 1.f;
  const bool scaled = kv == KV_I8 || kv == KV_F8;
  const Launch a{nullptr, nullptr, nullptr, nullptr, nullptr,
                     scaled ? &table : nullptr, scaled ? &scale1 : nullptr,
                     scaled ? &scale1 : nullptr, nullptr, B, S, Hkv, G, W, D,
                     bs, n_sel, scaled ? 1 : 0, scaled ? S : 0, 1.f, 0,
                     nullptr, nullptr, 0, info};
  if (!a.ok() || n_sel < 1 || info == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)by_storage<Grouped>(q_bf16, kv, a);
}

// The attention kernels' dynamic shared memory in bytes at a shape and
// storage code (attend_layout; ``tok`` the wide body's chunk: 4 for the
// grouped kernel, 16 / element size for the per-head one; the narrow body
// sizes its own); kernels/tuning.py attend_smem_bytes must give the same.
extern "C" long long loki_attend_smem_bytes(int kv, int G, int W, int D,
                                            int n_sel, int tok) {
  return with_storage(kv, [&](auto* tag) -> long long {
    using TK = std::remove_pointer_t<decltype(tag)>;
    switch (tok) {
      case 4: return (long long)attend_layout<TK, 4>(G, W, D, n_sel).total;
      case 8: return (long long)attend_layout<TK, 8>(G, W, D, n_sel).total;
      case 16: return (long long)attend_layout<TK, 16>(G, W, D, n_sel).total;
      default: return -1;
    }
  });
}

// The split-KV full decode's dynamic shared memory in bytes at a shape and
// storage code (split_smem_bytes); kernels/tuning.py full_smem_bytes must
// give the same.
extern "C" long long loki_full_smem_bytes(int kv, int G, int W, int D) {
  return with_storage(kv, [&](auto* tag) {
    using TK = std::remove_pointer_t<decltype(tag)>;
    return (long long)split_smem_bytes<TK>(G, W, D);
  });
}

// Full decode: part is the (B, Hkv, n_split, G, D + 2) float32 scratch,
// 1 <= n_split <= S / bs.
extern "C" int loki_full_decode(const void* q, const void* k, const void* v,
                                const void* cur_len, const void* table,
                                const void* k_scale, const void* v_scale,
                                void* out, void* part, int q_bf16, int kv,
                                int B, int S, int Hkv, int G, int W, int D,
                                int bs, int n_tab, int page_size, int n_split,
                                float scale, int sliding_window,
                                void* stream) {
  const Launch a{q, k, v, nullptr, cur_len, table, k_scale, v_scale,
                     out, B, S, Hkv, G, W, D, bs, 0, n_tab, page_size, scale,
                     sliding_window, static_cast<cudaStream_t>(stream),
                     static_cast<float*>(part), n_split, nullptr};
  if (!a.ok() || part == nullptr || n_split < 1 || n_split > S / bs)
    return (int)cudaErrorInvalidValue;
  return (int)by_storage<Full>(q_bf16, kv, a);
}

// What a full-decode launch at this shape would use, without launching:
// info[0] tokens per chunk, info[1] bytes per ring stage, info[2] the
// split kernel's dynamic shared memory, info[3] its
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at that memory (resident
// CTAs per SM). A scaled storage is asked as if paged.
extern "C" int loki_full_decode_info(int q_bf16, int kv, int G, int W, int D,
                                     int bs, long long* info) {
  static const int table = 0;
  static const float scale1 = 1.f;
  const bool scaled = kv == KV_I8 || kv == KV_F8;
  const Launch a{nullptr, nullptr, nullptr, nullptr, nullptr,
                 scaled ? &table : nullptr, scaled ? &scale1 : nullptr,
                 scaled ? &scale1 : nullptr, nullptr, 1, bs, 1, G, W, D, bs,
                 0, scaled ? 1 : 0, scaled ? bs : 0, 1.f, 0, nullptr,
                 nullptr, 1, info};
  if (!a.ok() || info == nullptr) return (int)cudaErrorInvalidValue;
  return (int)by_storage<Full>(q_bf16, kv, a);
}

// ------------------------------------------------ the per-head kernel

#ifdef LOKI_STORAGE_WIDE
namespace loki {

// One CTA of the per-head kernel: its cluster of C attends row r of
// blk_idx (BH, n_sel). K̂ is read in place through its strides: FM = a
// feature-major K̂ᵀ (k_tok = 1), else token-major (k_feat = 1). Scores are
// q̂·K̂[s] then * scale (the TPU kernel's order, gather_attention.py:49);
// the grouped kernels scale q̂ first.
template <typename TQ, typename TK, int DC, bool FM>
__global__ void __launch_bounds__(SPLIT_THREADS)
head_cluster_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v,
                    const int* __restrict__ blk_idx,
                    const int* __restrict__ cur_len, TQ* __restrict__ out,
                    int S, int D, int bs, int n_sel, int64_t k_row,
                    int64_t k_tok, int64_t k_feat, float scale, int vec) {
  constexpr int TOK = 16 / sizeof(TK);
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const AttendLayout L = attend_layout<TK, TOK>(1, D, D, n_sel);
  const int Dp = pad4(D);
  float* qs = reinterpret_cast<float*>(base + L.qs);        // Dp, unscaled
  int* sel = reinterpret_cast<int*>(base + L.sel);           // n_sel
  for (int c = tid; c < Dp; c += SPLIT_THREADS)
    qs[c] = c < D ? to_f(q[(int64_t)r * D + c]) : 0.f;
  const int nv = keep_valid(blk_idx + (int64_t)r * n_sel, n_sel, S / bs, sel);
  const TK* kr = k + r * k_row;
  const TK* vr = v + (int64_t)r * S * D;
  attend_share<TQ, TK, TOK, FM, true, 1, DC>(
      sel, nv, qs, base + L.uni, split_stage_bytes<TK, TOK>(D, D),
      [&](uint8_t* stage, int pos0, int t1) {
        head_fill<TK, TOK, FM>(stage, kr, vr, k_tok, k_feat, D, pos0, t1,
                               vec != 0, lane);
      },
      cur_len[r], 1, D, D, bs, 0, scale, out + (int64_t)r * D);
}

struct HeadLaunch {
  const void* q;
  const void* k;
  const void* v;
  const void* blk_idx;
  const void* cur_len;
  void* out;
  int BH, S, D, bs, n_sel;
  long long k_row, k_tok, k_feat;
  float scale;
  cudaStream_t stream;
  long long* info;    // not null: report (C, smem, clusters), no launch

  bool ok() const {
    return BH >= 1 && D >= 1 && D <= MAXDIM && bs >= 1 && S >= bs &&
           S % bs == 0 && n_sel >= 1 && (k_tok == 1 || k_feat == 1);
  }
};

template <typename TQ, typename TK>
struct PerHead {
  template <int DC, bool FM>
  static cudaError_t go(const HeadLaunch& a) {
    constexpr int TOK = 16 / sizeof(TK);
    constexpr size_t E = 16 / sizeof(TK);
    const int nb = a.S / a.bs;
    const AttendLayout L = attend_layout<TK, TOK>(1, a.D, a.D, a.n_sel);
    const int C = cluster_size(nb, a.BH, sm_count());
    // 16-byte copies: aligned rows of whole 16-byte pieces; feature-major
    // chunks start on a piece and end inside their block
    const auto aligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    int vec = aligned(a.k) && aligned(a.v) && a.D % E == 0 &&
              a.k_row % E == 0;
    vec = vec && (FM ? a.k_feat % E == 0 && a.bs % TOK == 0
                     : a.k_tok % E == 0);
    return launch_cluster(
        head_cluster_kernel<TQ, TK, DC, FM>, a.BH, 1, C, L.total, a.stream,
        a.info, static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const TK*>(a.v), static_cast<const int*>(a.blk_idx),
        static_cast<const int*>(a.cur_len), static_cast<TQ*>(a.out), a.S,
        a.D, a.bs, a.n_sel, (int64_t)a.k_row, (int64_t)a.k_tok,
        (int64_t)a.k_feat, a.scale, vec);
  }
  template <bool FM>
  static cudaError_t by_width(const HeadLaunch& a) {
    return pad4(a.D) <= 128 ? go<1, FM>(a) : go<2, FM>(a);
  }
  static cudaError_t run(const HeadLaunch& a) {
    return a.k_feat != 1 ? by_width<true>(a) : by_width<false>(a);
  }
};

}  // namespace loki

// The per-head kernel: q (BH, D); k̂ element (r, s, f) at k + r * k_row +
// s * k_tok + f * k_feat (token-major: k_tok = D, k_feat = 1; the
// feature-major K̂ᵀ (BH, D, S): k_tok = 1, k_feat = S); v (BH, S, D)
// contiguous; blk_idx (BH, n_sel) int32; out (BH, D). Returns a
// cudaError_t.
extern "C" int loki_block_sparse_attention(
    const void* q, const void* k, const void* v, const void* blk_idx,
    const void* cur_len, void* out, int q_bf16, int kv_bf16, int BH, int S,
    int D, int bs, int n_sel, long long k_row, long long k_tok,
    long long k_feat, float scale, void* stream) {
  const HeadLaunch a{q, k, v, blk_idx, cur_len, out, BH, S, D, bs, n_sel,
                     k_row, k_tok, k_feat, scale,
                     static_cast<cudaStream_t>(stream), nullptr};
  if (!a.ok()) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<PerHead>(q_bf16, kv_bf16, a);
}

// What a per-head launch at this shape and K̂ layout (fm: feature-major)
// would use, without launching: info as loki_grouped_cluster_info's.
extern "C" int loki_head_cluster_info(int q_bf16, int kv_bf16, int BH, int S,
                                      int D, int bs, int n_sel, int fm,
                                      long long* info) {
  const HeadLaunch a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     BH, S, D, bs, n_sel, (long long)S * D,
                     fm ? 1LL : (long long)D, fm ? (long long)S : 1LL, 1.f,
                     nullptr, info};
  if (!a.ok() || info == nullptr) return (int)cudaErrorInvalidValue;
  return (int)by_dtype<PerHead>(q_bf16, kv_bf16, a);
}

#endif  // LOKI_STORAGE_WIDE
