"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --only kernels # build + kernel checks only
    python3 chip_smoke.py --only train   # the train phase only (no build,
                                         # no kernels line)
    python3 chip_smoke.py --only families  # build, the families' kernel
                                           # cases and the families phase
    python3 chip_smoke.py --only recurrent # build, hymba's kernel cases
                                           # and the recurrent phase

Phases, each of which fails the run on any error:
  1. build   the CUDA sources in src/repro_torch/csrc with nvcc (sm_90a),
             one nvcc per source, all started together;
  2. kernels hold the nine kernels against their plain torch versions:
             the five decode kernels (fused_loki_decode, select_blocks,
             block_sparse_attention_grouped, paged_full_decode,
             fused_exact_topk_decode) at llama2-7b and qwen2.5-3b decode
             shapes (plus a sliding-window, a head_dim-256 and a
             short-cur_len case, fp32 and bf16 caches), the four cluster
             kernels (the two fused ones, select_blocks and
             block_sparse_attention_grouped) also against themselves (two
             calls bit for bit) and, but for select_blocks, against their
             plain cluster form at the launcher's own cluster size, with
             the launcher's shared memory equal to tuning.fused_smem_bytes,
             select_smem_bytes or attend_smem_bytes and its clusters
             resident; each kernel's paged form bit for bit against its
             contiguous form
             on the same logical data (shuffled page tables with a
             trash-page row); the five kernels' storage modes (fp16, int8,
             fp8, native and at PCA rank 32, on pools the port's writers
             fill) against their plain versions and plain split or
             cluster forms, the pairs against the fused kernels bit for
             bit, their shared memory against tuning's, then untimed at
             qwen2.5-3b G=8 (int8:pca:r=32) and a 1000-token window (fp8);
             the tiered pair on the main case (select_blocks over a
             sidecar of the pool's leading d columns == over the pool,
             the grouped kernel through a frame table over a permuted
             frame pool == through the page table, the pair == the fused
             kernel, an unselected page on the trash frame changes
             nothing; bit for bit);
             the five kernels at the batch widths of packed decode (B 1
             and 2 at Hkv 32, planned for their own rows: clusters of 8,
             16 and 8 full-decode splits) at fp32 and int8:pca:r=32,
             paged, checked the same way, their cluster plans resident;
             the five kernels at granite-moe-3b's decode shape (G 3, D
             64, d 16; bf16 q over fp32 K/V) and at whisper-small's (G 1,
             D 64, S 448, 32-token blocks), mixtral-8x22b's sliding
             window (G 6, window 4096, S 8192), llava-next-mistral-
             7b's (G 4) and hymba-1.5b's (Hkv 5, G 5, D 64, d 16: 20
             rows) at S 4096 (kb 8) and at its short runs' S 1024 (kb
             2), checked, paged == contiguous (pages of 128, 64, 512,
             128, 128 and 128) and timed as the main case is;
             the per-head pipeline's three (block_max_scores,
             block_max_scores_fm, block_sparse_attention) at llama2-7b's
             decode step flattened per head (bf16 q over fp32 K/V, fp32,
             bf16), head_dim 256 and short cur_len (dead-block ties),
             S 390 at bs 30 and d 8 (the fm kernel's single tokens) and
             cur_len inside a 16-byte bf16 piece, the two layouts bit for
             bit, the fm launch's shared memory against
             tuning.scores_fm_smem_bytes, and two block_max_scores calls
             bit for bit (block_sparse_attention also over
             K̂ᵀ in place, each layout against its plain cluster form at
             the launcher's C, with its plan checked as above, and two
             calls bit for bit); flash_attention at the llama2-7b
             prefill shape (causal and not), Sq != Sk, head_dim 64 and 256
             (bf16 cases on the tensor-core body within FLASH_BF16_BOUND
             and FLASH_BF16_REL_L2, whose wgmma the built library is checked for; fp32 cases on
             the float32 body); check that CUDA shapes no kernel takes
             raise; time each kernel at its main-path shape (flash beside
             its float32 body on an fp32 copy and SDPA; the split-KV full
             decode beside SDPA, with its split count and scratch; the
             two block-list kernels beside SDPA under a mask of the
             selected tokens; the cluster kernels with their cluster size,
             shared memory and resident clusters, the fused ones beside
             the full decode on the same cache; each storage mode beside
             the same kernel's fp32 mode, its bound and, at fp16, SDPA);
  3. dense   llama2-7b at full width through the dense engine with
             loki_block (4 long prompts, 16 new tokens each), then full
             and exact_topk through it, the launch counters of each run
             proving every layer of every tick ran the planned kernel and
             no other; then the paper's baselines pcaattn and h2o and
             chunked Loki (n_chunks 4) through it (dense_pcaattn,
             dense_h2o, dense_loki_chunked: no decode kernel launched, one
             host sync in a decode tick, asserted; greedy agreement with
             the full run reported);
  4. step    the decode-step path: one decode step of all four slots
             through the fused kernel, each layer's call repeated through
             ops.loki_decode_two_kernel on the same inputs, bit for bit
             (its own launch counts); the per-head path: each layer's call
             flattened per head through ops.loki_decode_attention, then
             through
             ops.loki_decode_attention_fm on a feature-major copy (each
             counted on its own), held against the fused kernel without
             its recency window; the step's logits held against the plain
             per-head path; then a torch.profiler breakdown of one decode
             step and greedy agreement of a whole run with the plain path;
  5. paged   the main path: the paged engine at its defaults (prefix
             cache on, gather-packed decode) serves the same four prompts
             at full width (fp32 pool, 128-token pages, 512-token prefill
             chunks) once each with loki_block (in a pool too small for
             all four, so it must preempt), full and exact_topk, counted
             per run; then at page layout int8:pca:r=32 under the three
             policies and at fp8 and bf16 under loki_block, each a path
             of its own (paged_int8pca_loki_block, ...), with the same
             prompts, pool pages, chunking and preemption; decode tick
             time by step rows, device idle share, pool bytes, packed and
             masked ticks, prefix hits and host syncs per tick of each (1
             per decode tick asserted under each, packed ticks included);
             after each run one decode step of a freshly prefilled pool
             at its layout, kernels against the plain versions through
             the same dispatch (asserted) and against the fp32 layout
             (reported), and at int8:pca:r=32 each layer's fused call
             repeated through the pair, bit for bit (paged_int8pca_step);
             Fault 2's other sides: full and exact_topk with packed decode
             off at fp32 and int8:pca:r=32 (paged_full_masked, ...),
             loki_block packed in a pool of every slot at its page bound
             at both (paged_loki_block_packed, ...) and unpacked at int8;
             then a 2100-token system prompt
             before four 300-token suffixes, request 0 first, in a
             40-page pool, fp32 and int8:pca:r=32 (paged_prefix_loki_block,
             paged_int8pca_prefix_loki_block): 6300 tokens served from
             cached pages, 3 copy-on-write tails and no preemption
             asserted, copy_cache_page on the engine's pools bit for bit,
             greedy agreement with the same prompts unshared (the _off
             paths);
  5b. tiered the tiered KV pool: a CUDA engine with kernel_fail in its
             fault plan refuses to build; loki_block unpacked in a pool of
             every slot at its page bound (paged_loki_block_masked, the
             fused kernel), then the same prompts at 33 device frames
             (paged_tiered_min, the least a request allows), at 65
             (paged_tiered_half) and at 33 under the seeded fault plan
             seed=7,dma_timeout=0.2,hbm_oom_on_promote=0.1
             (paged_tiered_chaos), each with the auditor on every tick:
             64/64 tokens equal to the single tier's, the chaos run's DONE
             outputs equal to paged_tiered_min's with both sites fired,
             demotions and promotions and no preemption, select_blocks and
             block_sparse_attention_grouped on every layer of every decode
             run and fused_loki_decode never, host syncs as the engine
             counts them (decode runs and demotions); per decode step
             runs, re-runs, deferrals, promotions, demotions and bytes each
             way, the copies' rate on profiled ticks, prefetch hits, winner
             against live pages a slot, device bytes against the single
             tier's and the peak of pinned host buffers;
  5c. fault 2 packed == masked greedy tokens, 64 of 64, under full,
             exact_topk and loki_block at fp32 and int8:pca:r=32 (the
             fp32 loki_block masked side is paged_loki_block_masked),
             asserted;
  6. flash   the prefill-flash path: one 3072-token prompt through
             lm.prefill at full width, each layer's causal-attention q, k,
             v through ops.flash (counted), held against plain flash
             within FLASH_BF16_BOUND and FLASH_BF16_REL_L2;
  7. granite granite-moe-3b-a800m at published width (seeded bf16
             weights, PCA calibrated on synthetic data): per policy
             (loki_block, full, exact_topk) the dense engine's greedy
             tokens, then the paged engine at its defaults
             (paged_granite_<policy>: planned launches and one host sync
             a decode tick asserted, agreement with the dense engine
             reported), then loki_block with float32 weights at 8 of the
             32 layers (paged_granite_fp32_loki_block: paged == dense,
             64 of 64, capacity drops included, asserted).
  7b. families the window and encoder families at published width
             (seeded weights, PCA calibrated), each paged run at the
             engine's defaults beside the dense engine's greedy tokens,
             checked by paged_checked, every page back in the pool:
             whisper-small (12 + 12 layers, 1500 stand-in frames a
             request, smax 448, page 64, block 32) under loki_block, full
             and exact_topk with bf16 weights (agreement reported) and
             float32 weights (paged == dense, 64 of 64, asserted), and
             loki_block over an int8 pool (int8 cross K/V);
             mixtral-8x22b's 4096-token window (MIXTRAL_LAYERS of 56
             layers in bf16, MIXTRAL_FP32_LAYERS in float32; smax 8192,
             512-token pages and chunks, prompts 4609-5889) under
             loki_block and full: every slot within its window budget
             after every tick, pages recycled, a slot's peak at
             ceil(4096 / 512) + 1 pages (asserted); in float32 paged ==
             dense asserted with one page-table group and with windows
             alternating 4096 and 0 (two groups through rank-3 tables,
             the full group pinning its pages), and one decode step over
             tables with recycled entries on the trash page bit-equal to
             the step over the unrecycled tables (mixtral_recycled_step,
             mixtral_groups_recycled_step); llava-next-mistral-7b (32
             layers) under loki_block with the paged phase's prompts,
             then one prefill with 576 seeded patch embeddings (logits
             finite and moved from the prefill without them, asserted).
  7c. recurrent the recurrent-state families at published width
             (seeded weights): hymba-1.5b (32 layers, attention beside
             mamba; PCA calibrated) under loki_block, full and exact_topk
             with bf16 weights (paged against dense reported) and float32
             weights (paged == dense, 64 of 64, asserted; the planned
             kernel on every attention layer of every decode step and one
             host sync a decode tick asserted, every page back and no
             private entry left), then in float32 packed == masked, the
             tight pool (one preemption under page pressure; the growth
             that preempted evicts a retained page, so the restore falls
             back to recompute, asserted; tokens equal),
             the priority run (restore_run: the snapshot and the retained
             private pages restored, tokens equal, the prompt computed
             once) and ms per prefill chunk; the tier at
             HYMBA_TIERED_LAYERS layers and HYMBA_SHORT_SMAX at the
             fewest legal frames == the single tier, 64 of 64; then
             xlstm-125m (12 layers, no KV cache, policy full, no kernel)
             in bf16 and float32 (paged == dense asserted) and its
             priority run (the snapshot alone restored).
  8. train   the serving phases' models freed first; (a) qwen2.5-3b at
             published width (36 layers, 3.09 B parameters), float32
             masters from the port's seeded init, bf16 compute, 6 steps
             of 8 x 128 tokens through make_train_step with the
             TrainConfig launch/train.py builds: finite losses and grad
             norms, the first loss within 1.0 of ln V, the last below the
             first (asserted); step ms, AdamW ms (CUDA events around
             apply_updates), tok/s and peak memory; (b) qwen2.5-3b and
             granite-moe-3b smoke, float32, 3 steps on the card against
             the port's CPU path from the same params and batches; (c)
             crash at step 7 and resume from step 5 through TrainRunner
             and run_with_restarts (losses within rtol 1e-5; bit-equality
             and the gradient leaves two identical backward passes give
             apart reported); (d) python -m repro_torch.launch.train twice
             against one checkpoint directory (the second resumes); (e) no
             kernel wrapper launches in the phase (asserted).
The second-to-last line is a JSON object listing the kernels; the last is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores
BF16_FLOPS = 989e12             # H100 SXM bf16 dense tensor-core peak
NEG_INF = -1e30
DEV = "cuda"


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


#: main() also writes every log line to chiprun_out/chip_smoke.log
_LOG = []


def log(msg: str) -> None:
    print(msg, flush=True)
    for fh in _LOG:
        fh.write(msg + "\n")
        fh.flush()


def card_state() -> str:
    """The card's SM and memory clocks, temperature and power draw now, as
    nvidia-smi reads them (logged around the timings: a card held below
    its clocks runs a memory-bound kernel slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip() if out.returncode == 0 else "unreadable"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

_FLUSH = {}


def flush_l2() -> None:
    """Overwrite 256 MB so the next launch finds the 50 MB L2 cold, as the
    decode step does (its cache is far larger than L2)."""
    buf = _FLUSH.get("buf")
    if buf is None:
        buf = _FLUSH["buf"] = torch.empty(64 << 20, dtype=torch.float32,
                                          device=DEV)
    buf.zero_()


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, L2 flushed before each, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ----------------------------------------------------------------- kernels

KERNELS = ("fused_loki_decode", "select_blocks",
           "block_sparse_attention_grouped", "paged_full_decode",
           "fused_exact_topk_decode")


def make_case(name, *, B, Hkv, G, D, S, bs, d, kb, lw, sw, cur, kv_dtype,
              q_dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    f = dict(device=DEV, generator=gen)
    return dict(
        name=name, bs=bs, d=d, kb=kb, lw=lw, sw=sw,
        q=torch.randn((B, Hkv, G, D), **f).to(q_dtype),
        k=torch.randn((B, S, Hkv, D), **f).to(kv_dtype),
        v=torch.randn((B, S, Hkv, D), **f).to(kv_dtype),
        cur=torch.tensor(cur, dtype=torch.int32, device=DEV))


GRANITE_CASE = "granite-moe-3b G=3 D=64 q:bf16 kv:fp32"
GRANITE_SHAPE = dict(B=4, Hkv=8, G=3, D=64, S=4096, bs=128, d=16, kb=8,
                     lw=16, sw=0, cur=[1536, 2048, 2560, 3072])
#: the window and encoder families' decode shapes (the families phase's
#: engines; bf16 queries over the engines' fp32 caches): whisper-small (G
#: 1, D 64, smax 448 in 32-token blocks), mixtral-8x22b's sliding window
#: (G 6, window 4096, smax 8192) and llava-next-mistral-7b (G 4)
WHISPER_CASE = "whisper-small G=1 D=64 bs=32 q:bf16 kv:fp32"
WHISPER_SHAPE = dict(B=4, Hkv=12, G=1, D=64, S=448, bs=32, d=16, kb=3,
                     lw=16, sw=0, cur=[201, 265, 329, 393])
MIXTRAL_CASE = "mixtral-8x22b G=6 window=4096 q:bf16 kv:fp32"
MIXTRAL_SHAPE = dict(B=4, Hkv=8, G=6, D=128, S=8192, bs=128, d=32, kb=16,
                     lw=16, sw=4096, cur=[4609, 5121, 5377, 5889])
LLAVA_CASE = "llava-next-mistral-7b G=4 q:bf16 kv:fp32"
LLAVA_SHAPE = dict(B=4, Hkv=8, G=4, D=128, S=4096, bs=128, d=32, kb=8,
                   lw=16, sw=0, cur=[1530, 2040, 2550, 3060])
#: hymba-1.5b's decode step (the recurrent phase's engines): Hkv 5, the
#: first odd KV-head count the planners meet (B * Hkv = 20 rows), G 5, D
#: 64, d 16 at its prompts' first decode positions
HYMBA_CASE = "hymba-1.5b Hkv=5 G=5 D=64 q:bf16 kv:fp32"
HYMBA_SHAPE = dict(B=4, Hkv=5, G=5, D=64, S=4096, bs=128, d=16, kb=8,
                   lw=16, sw=0, cur=[120, 248, 376, 632])
#: the same at the short runs' context (HYMBA_SHORT_SMAX: the tight pool,
#: the priority restore and the tier), where the planner keeps 2 blocks of
#: 8 (max(int(0.25 * 1024 / 128), 1))
HYMBA_SHORT_CASE = "hymba-1.5b smax=1024 kb=2 Hkv=5 G=5 D=64 q:bf16 kv:fp32"
HYMBA_SHORT_SHAPE = dict(HYMBA_SHAPE, S=1024, kb=2)
#: result keys of the cases timed on their own (beside the main case), and
#: the page size each is paged at
CASE_KEYS = {GRANITE_CASE: ("granite", 128), WHISPER_CASE: ("whisper", 64),
             MIXTRAL_CASE: ("mixtral", 512), LLAVA_CASE: ("llava", 128),
             HYMBA_CASE: ("hymba", 128),
             HYMBA_SHORT_CASE: ("hymba_short", 128)}


def kernel_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    llama = dict(B=4, Hkv=32, G=1, D=128, S=4096, bs=128, d=32, kb=8, lw=16,
                 sw=0, cur=[3000, 2500, 1800, 3100])
    qwen = dict(llama, Hkv=2, G=8)
    return [
        # the main path: bf16 queries over the engines' fp32 caches
        make_case("llama2-7b q:bf16 kv:fp32", **llama, kv_dtype=f32,
                  q_dtype=bf16, seed=1),
        make_case("llama2-7b q:bf16 kv:bf16", **llama, kv_dtype=bf16,
                  q_dtype=bf16, seed=2),
        make_case("llama2-7b q:fp32 kv:fp32", **llama, kv_dtype=f32,
                  q_dtype=f32, seed=3),
        make_case("qwen2.5-3b G=8 kv:fp32", **qwen, kv_dtype=f32,
                  q_dtype=f32, seed=4),
        make_case("qwen2.5-3b G=8 kv:bf16", **qwen, kv_dtype=bf16,
                  q_dtype=bf16, seed=5),
        make_case("sliding_window=1000", **dict(llama, sw=1000, kb=9),
                  kv_dtype=f32, q_dtype=f32, seed=6),
        make_case("head_dim=256", **dict(llama, Hkv=16, D=256, d=64),
                  kv_dtype=f32, q_dtype=f32, seed=7),
        make_case("short cur_len, -1 sentinels",
                  **dict(llama, cur=[100, 1, 300, 129]), kv_dtype=f32,
                  q_dtype=f32, seed=8),
        # granite-moe-3b's decode step: G = 3 (not a power of two), D 64,
        # score width d 16; bf16 queries over the engine's fp32 cache
        make_case(GRANITE_CASE, **GRANITE_SHAPE, kv_dtype=f32,
                  q_dtype=bf16, seed=9),
        make_case(WHISPER_CASE, **WHISPER_SHAPE, kv_dtype=f32,
                  q_dtype=bf16, seed=10),
        make_case(MIXTRAL_CASE, **MIXTRAL_SHAPE, kv_dtype=f32,
                  q_dtype=bf16, seed=11),
        make_case(LLAVA_CASE, **LLAVA_SHAPE, kv_dtype=f32, q_dtype=bf16,
                  seed=12),
        make_case(HYMBA_CASE, **HYMBA_SHAPE, kv_dtype=f32, q_dtype=bf16,
                  seed=13),
        make_case(HYMBA_SHORT_CASE, **HYMBA_SHORT_SHAPE, kv_dtype=f32,
                  q_dtype=bf16, seed=14),
    ]


def tolerance(dtype):
    # fp32 out: the kernel and the plain version sum in different orders
    # and use expf on different inputs, ~1e-6 relative; bf16 out: both
    # round the same fp32 value to bf16, which can straddle a rounding
    # boundary — one bf16 ulp is 2**-8 relative
    return (1e-4, 1e-4) if dtype == torch.float32 else (2e-3, 1e-2)


def near_tie_rows(blk, kb):
    """(B,Hkv) mask of rows whose first kb+1 sorted block scores hold two
    within fp32 rounding of each other: there the selection order may
    legitimately differ between two summation orders."""
    vals, _ = torch.sort(blk, dim=-1, descending=True)
    vals = vals[..., :kb + 1]
    live = vals > NEG_INF / 2
    gap = (vals[..., :-1] - vals[..., 1:]).abs()
    # a few fp32 ulps of the value (the +1e4 recency boost rounds to a
    # 1e-3 grid) plus the spread of two summation orders of ~1 scores
    tol = 1e-5 + 1e-6 * vals[..., :-1].abs()
    tie = (gap <= tol) & live[..., :-1] & live[..., 1:]
    return tie.any(-1)


def kernel_kw(case, exact=False):
    """The fused kernels' keyword arguments of a case; ``exact``: the
    exact-top-k kernel's (no d, no recency window)."""
    kw = dict(k_blocks=case["kb"], block_size=case["bs"],
              sliding_window=case["sw"], scale=case["v"].shape[-1] ** -0.5)
    if not exact:
        kw.update(d=case["d"], local_window=case["lw"])
    return kw


def check_selection(case, q, k, cur, *, d, lw):
    """select_blocks against its plain version at (d, local window):
    indices equal on every row without a near-tie. Returns (plain
    selection, rows that agree, near-tie rows)."""
    from repro_torch.kernels import fused_decode as F
    kw = dict(kernel_kw(case), d=d, local_window=lw)
    ties = near_tie_rows(F.block_scores_plain(
        q, k, cur, d=d, block_size=case["bs"], scale=kw["scale"],
        local_window=lw, sliding_window=case["sw"]), case["kb"])
    sel_k = F.select_blocks(q, k, cur, **kw)
    sel_p = F.select_blocks_plain(q, k, cur, **kw)
    sync()
    diff = (sel_k != sel_p).any(-1)
    if (diff & ~ties).any():
        raise AssertionError(f"{case['name']}: select_blocks (d={d}) indices "
                             f"differ in {int((diff & ~ties).sum())} rows "
                             "with no near-tie")
    return sel_k, sel_p, ~diff, ties


def checked_plan(what, ask, want_smem, nb, rows):
    """A cluster launcher's plan (``ask()``: C, its shared memory, its
    library's layout function and cudaOccupancyMaxActiveClusters), checked:
    the launcher's shared memory equals the layout function and the tuning
    mirror ``want_smem`` (one layout, three sources), its C equals
    fused_cluster_size at this card's SM count over ``rows`` clusters, and
    at least one cluster of that size fits on the card."""
    from repro_torch.kernels import gather_attention as GA
    if DEV != "cuda":                 # a CPU rehearsal: no library to ask
        return dict(C=GA.fused_cluster_size(nb, rows, 132), smem=want_smem,
                    max_clusters=None)
    plan = ask()
    if not plan["smem"] == plan["smem_layout"] == want_smem:
        raise AssertionError(f"{what}: launcher shared memory {plan} != "
                             f"tuning {want_smem}")
    rule = GA.fused_cluster_size(nb, rows, GA._sm_count(torch.device(DEV)))
    if plan["C"] != rule:
        raise AssertionError(f"{what}: launcher C {plan['C']} != "
                             f"fused_cluster_size {rule}")
    if plan["max_clusters"] < 1:
        raise AssertionError(f"{what}: no cluster of {plan['C']} CTAs fits "
                             f"({plan})")
    return plan


def fused_plans(case):
    """The cluster launchers' plans at a case (``checked_plan``):
    fused_loki_decode (d), fused_exact_topk_decode (d = W) against
    tuning.fused_smem_bytes, select_blocks (d) against
    tuning.select_smem_bytes, and block_sparse_attention_grouped over the
    case's k_blocks entries against tuning.attend_smem_bytes."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA
    from repro_torch.kernels import tuning
    q, k, v = case["q"], case["k"], case["v"]
    B, Hkv, G, W = q.shape
    nb = k.shape[1] // case["bs"]
    kb = min(case["kb"], nb)
    plans = {}
    for name, d in (("fused_loki_decode", case["d"]),
                    ("fused_exact_topk_decode", W)):
        want = tuning.fused_smem_bytes(nb=nb, k_blocks=kb, g=G, kdim=W,
                                       dim=v.shape[-1], bs=case["bs"], d=d,
                                       storage=tuning.storage_of(k))
        plans[name] = checked_plan(
            f"{case['name']}: {name}",
            lambda: F.cluster_plan(q, k, v, d=d, k_blocks=kb,
                                   block_size=case["bs"]),
            want, nb, B * Hkv)
    plans["select_blocks"] = checked_plan(
        f"{case['name']}: select_blocks",
        lambda: F.select_plan(q, k, d=case["d"], k_blocks=kb,
                              block_size=case["bs"]),
        tuning.select_smem_bytes(nb=nb, g=G, kdim=W, d=case["d"],
                                 bs=case["bs"],
                                 storage=tuning.storage_of(k)),
        nb, B * Hkv)
    idx = torch.zeros((B, Hkv, kb), dtype=torch.int32, device=DEV)
    plans["block_sparse_attention_grouped"] = checked_plan(
        f"{case['name']}: block_sparse_attention_grouped",
        lambda: GA.attend_plan(q, k, v, idx, block_size=case["bs"]),
        tuning.attend_smem_bytes(n_sel=kb, g=G, kdim=W, dim=v.shape[-1],
                                 storage=tuning.storage_of(k)), nb, B * Hkv)
    return plans


def check_kernels(results, only=None):
    """Each of the five kernels against its plain version on every case
    (``only``: the cases named there);
    the four cluster kernels (the fused ones, select_blocks and the grouped
    attention) also against a second call, bit for bit, and but for
    select_blocks (whose selection does not depend on C) against their
    plain cluster form at the launcher's own C."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA

    for case in kernel_cases():
        if only is not None and case["name"] not in only:
            continue
        q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
        W = k.shape[-1]
        kw, ex_kw = kernel_kw(case), kernel_kw(case, exact=True)
        plans = fused_plans(case)
        full_smem = full_smem_checked(case["name"], q, k, v,
                                      case["bs"])["smem"]
        att_kw = dict(block_size=case["bs"], scale=kw["scale"],
                      sliding_window=case["sw"])
        # select_blocks at the fused kernel's scale, so all three share
        # one selection; at d = W without the recency window it is the
        # exact-top-k kernel's selection
        sel_k, sel_p, agree, ties = check_selection(case, q, k, cur,
                                                    d=case["d"],
                                                    lw=case["lw"])
        _, sel_x, agree_x, ties_x = check_selection(case, q, k, cur, d=W,
                                                    lw=0)
        fused = {"fused_loki_decode": lambda: F.fused_loki_decode(
                     q, k, v, cur, **kw),
                 "fused_exact_topk_decode": lambda: F.fused_exact_topk_decode(
                     q, k, v, cur, **ex_kw),
                 "select_blocks": lambda: F.select_blocks(q, k, cur, **kw),
                 "block_sparse_attention_grouped": lambda:
                     GA.block_sparse_attention_grouped(q, k, v, sel_p, cur,
                                                       **att_kw)}
        runs = {
            "fused_loki_decode": (fused["fused_loki_decode"](),
                                  F.fused_loki_decode_plain(q, k, v, cur,
                                                            **kw), agree),
            "block_sparse_attention_grouped": (
                fused["block_sparse_attention_grouped"](),
                GA.attend_blocks_plain(q, k, v, sel_p, cur, **att_kw), None),
            "block_sparse_attention_grouped (cluster)": (
                fused["block_sparse_attention_grouped"](),
                GA.grouped_cluster_plain(
                    q, k, v, sel_p, cur, **att_kw,
                    n_cta=plans["block_sparse_attention_grouped"]["C"]),
                None),
            "paged_full_decode": (
                GA.paged_full_decode(q, k, v, cur, **att_kw),
                GA.full_decode_plain(q, k, v, cur, scale=kw["scale"],
                                     sliding_window=case["sw"]), None),
            # the same kernel against the plain split-then-merge at the
            # wrapper's own split count
            "paged_full_decode (splits)": (
                GA.paged_full_decode(q, k, v, cur, **att_kw),
                GA.full_decode_split_plain(
                    q, k, v, cur, **att_kw,
                    n_split=full_split(case["bs"], k.shape[1],
                                       q.shape[0] * q.shape[1])), None),
            "fused_exact_topk_decode": (
                fused["fused_exact_topk_decode"](),
                F.fused_exact_topk_decode_plain(q, k, v, cur, **ex_kw),
                agree_x),
            # the fused kernels against the plain cluster form at the
            # launcher's own cluster size
            "fused_loki_decode (cluster)": (
                fused["fused_loki_decode"](),
                F.fused_cluster_plain(
                    q, k, v, cur, **kw,
                    n_cta=plans["fused_loki_decode"]["C"]), agree),
            "fused_exact_topk_decode (cluster)": (
                fused["fused_exact_topk_decode"](),
                F.fused_cluster_plain(
                    q, k, v, cur, **ex_kw, d=W, local_window=0,
                    n_cta=plans["fused_exact_topk_decode"]["C"]), agree_x),
        }
        sync()
        for kname, call in fused.items():
            again = call()
            sync()
            first = sel_k if kname == "select_blocks" else runs[kname][0]
            if not torch.equal(again, first):
                raise AssertionError(f"{case['name']}: {kname}: two calls "
                                     "differ")
        atol, rtol = tolerance(q.dtype)
        errs = {}
        for kname, (got, want, rows) in runs.items():
            g32, w32 = got.float(), want.float()
            if rows is not None:
                g32, w32 = g32[rows], w32[rows]
            if not torch.isfinite(g32).all():
                raise AssertionError(f"{case['name']}: {kname} non-finite")
            torch.testing.assert_close(g32, w32, atol=atol, rtol=rtol,
                                       msg=lambda m: f"{case['name']}: "
                                       f"{kname}: {m}")
            errs[kname] = float((g32 - w32).abs().max()) if g32.numel() \
                else 0.0
        errs["select_blocks"] = float(
            (sel_k - sel_p).abs()[agree].max()) if agree.any() else 0.0
        errs["paged_full_decode"] = max(
            errs["paged_full_decode"], errs.pop("paged_full_decode (splits)"))
        for kname in ("fused_loki_decode", "fused_exact_topk_decode",
                      "block_sparse_attention_grouped"):
            errs[kname] = max(errs[kname], errs.pop(f"{kname} (cluster)"))
        log(f"kernels: {case['name']}: indices equal in "
            f"{int(agree.sum())}/{agree.numel()} rows at d={case['d']} "
            f"(near-ties {int(ties.sum())}) and {int(agree_x.sum())}/"
            f"{agree_x.numel()} at d={W} (near-ties {int(ties_x.sum())}), "
            f"-1 sentinels {int((sel_p < 0).sum())}; max|err| "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (atol {atol}, rtol {rtol}; cluster kernels also vs their "
            f"plain cluster form but select_blocks, and two calls bit for "
            f"bit); clusters: "
            + ", ".join(f"{n} C {p['C']}, {p['smem']} B shared, "
                        f"{p['max_clusters']} resident"
                        for n, p in plans.items())
            + f"; paged_full_decode {full_smem} B shared (== "
            "tuning.full_smem_bytes)")
        key = CASE_KEYS.get(case["name"], ("main",))[0]
        if key not in results:
            results[key] = dict(case=case, sel=sel_p, sel_exact=sel_x,
                                errs=errs, plans=plans)


def paged_copy(case, ps, seed):
    """The case's caches scattered into a pool through a shuffled page
    table, plus one idle batch row whose all-zero table row reads the
    trash page 0 (cur_len 1), as idle slots do in the paged engine.
    Returns (q, cur, table, pool k, pool v, logical k, logical v): the
    logical caches are what the table reads, gathered."""
    from repro_torch.serving.paged_cache import gather_logical
    q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
    B, S = k.shape[:2]
    mp = S // ps
    gen = torch.Generator().manual_seed(seed)
    table = torch.zeros((B + 1, mp), dtype=torch.int32)
    table[:B] = (torch.randperm(B * mp, generator=gen) + 1).view(B, mp)
    table = table.to(DEV)
    n_pages = B * mp + 1
    pools = []
    for x in (k, v):
        pool = torch.randn((n_pages * ps,) + x.shape[2:], device=DEV).to(
            x.dtype)                             # the trash page: garbage
        rows = (table[:B, :, None].long() * ps
                + torch.arange(ps, device=DEV)).reshape(-1)
        pool[rows] = x.reshape((B * S,) + x.shape[2:])
        pools.append(pool)
    q2 = torch.cat([q, q[:1]])
    cur2 = torch.cat([cur, torch.ones(1, dtype=cur.dtype, device=DEV)])
    return (q2, cur2, table, *pools,
            gather_logical(pools[0], table, ps),
            gather_logical(pools[1], table, ps))


def paged_calls(case, q, cur, table, ps, k, v, sel):
    """The five kernels on (q, cur) over caches k, v: contiguous when
    ``table`` is None, else the pools through ``table``."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA
    pg = dict(page_table=table, page_size=ps) if table is not None else {}
    kw, ex_kw = kernel_kw(case), kernel_kw(case, exact=True)
    att_kw = dict(block_size=case["bs"], scale=kw["scale"],
                  sliding_window=case["sw"], **pg)
    return {
        "fused_loki_decode": lambda: F.fused_loki_decode(q, k, v, cur, **kw,
                                                         **pg),
        "select_blocks": lambda: F.select_blocks(q, k, cur, **kw, **pg),
        "block_sparse_attention_grouped": lambda:
            GA.block_sparse_attention_grouped(q, k, v, sel, cur, **att_kw),
        "paged_full_decode": lambda: GA.paged_full_decode(q, k, v, cur,
                                                          **att_kw),
        "fused_exact_topk_decode": lambda: F.fused_exact_topk_decode(
            q, k, v, cur, **ex_kw, **pg),
    }


def check_paged(results, only=None):
    """#1-#5 paged against contiguous on the same logical data, asserted
    bit-identical: the paged form differs only in where a block's rows
    are read from. Shuffled tables with a trash-page row, pages of one and
    of two kernel blocks."""
    from repro_torch.kernels import fused_decode as F
    cases = kernel_cases()
    pairs = ((cases[0], 128), (cases[0], 256), (cases[4], 128),
             (cases[5], 256), (cases[7], 128)) + tuple(
                 (c, CASE_KEYS[c["name"]][1]) for c in cases
                 if c["name"] in CASE_KEYS)
    for case, ps in pairs:
        if only is not None and case["name"] not in only:
            continue
        q, cur, table, pk, pv, lk, lv = paged_copy(case, ps, seed=ps)
        sel = F.select_blocks(q, lk, cur, **kernel_kw(case))
        paged = paged_calls(case, q, cur, table, ps, pk, pv, sel)
        contig = paged_calls(case, q, cur, None, ps, lk, lv, sel)
        for name in KERNELS:
            a, b = paged[name](), contig[name]()
            sync()
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{case['name']} page_size {ps}: {name} paged differs "
                    "from contiguous on the same logical data (max |d| "
                    f"{float((a.float() - b.float()).abs().max()):.3e})")
        log(f"kernels: paged == contiguous bit for bit, all five kernels, "
            f"{case['name']}, page_size {ps} (shuffled table, trash row)")
        key = "paged_" + CASE_KEYS.get(case["name"], ("",))[0]
        key = key.rstrip("_")
        if key not in results:
            results[key] = (q, cur, table, pk, pv, sel)
        del pk, pv, lk, lv


def check_tiered_kernels(results, ps=128):
    """The tiered pool's kernel pair on the main case (B 4 and an idle
    row, 128-token pages), each asserted:
      - select_blocks over a sidecar (the pool's leading d columns, a pool
        of its own) with the scale D**-0.5 gives the indices it gives over
        the pool itself;
      - block_sparse_attention_grouped through a frame table over a
        permuted frame pool equals the same call through the logical
        table, bit for bit;
      - the pair via the sidecar and the frames equals fused_loki_decode
        over the single-tier pool, bit for bit;
      - a HOST page no block selects (its entry sent to the trash frame,
        whose rows are garbage) leaves the output unchanged, bit for bit.
    Logs the winners' share of each slot's live pages on this data."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA
    case = kernel_cases()[0]
    q, cur, table, pk, pv, _, _ = paged_copy(case, ps, seed=ps)
    kw, d = kernel_kw(case), case["d"]
    pg = dict(page_table=table, page_size=ps)
    lat = pk[..., :d].contiguous()
    sel = F.select_blocks(q, pk, cur, **kw, **pg)
    sel_lat = F.select_blocks(q[..., :d].contiguous(), lat, cur, **kw, **pg)
    sync()
    if not torch.equal(sel, sel_lat):
        raise AssertionError("tiered: select_blocks over the sidecar "
                             "differs from over the pool")
    # frames: the pages permuted into a frame pool (frame 0 stays trash)
    n_pages = pk.shape[0] // ps
    gen = torch.Generator().manual_seed(5)
    frame_of = torch.cat([torch.zeros(1, dtype=torch.long),
                          torch.randperm(n_pages - 1, generator=gen) + 1])
    frame_of = frame_of.to(DEV)
    rows = (frame_of[:, None] * ps + torch.arange(ps, device=DEV)).reshape(-1)
    fk, fv = torch.empty_like(pk), torch.empty_like(pv)
    fk[rows], fv[rows] = pk, pv
    ftable = frame_of[table.long()].to(torch.int32)
    att = dict(block_size=case["bs"], scale=kw["scale"],
               sliding_window=case["sw"], page_size=ps)
    by_frames = GA.block_sparse_attention_grouped(q, fk, fv, sel_lat, cur,
                                                  page_table=ftable, **att)
    by_pages = GA.block_sparse_attention_grouped(q, pk, pv, sel_lat, cur,
                                                 page_table=table, **att)
    fused = F.fused_loki_decode(q, pk, pv, cur, **kw, **pg)
    sync()
    for what, a, b in (("through the frame table", by_frames, by_pages),
                       ("the pair via sidecar and frames", by_frames, fused)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"tiered: {what} differs (max |d| "
                f"{float((a.float() - b.float()).abs().max()):.3e})")
    # a page of slot 0 that no head's selection names: live if one exists
    mp = table.shape[1]
    chosen = set(sel[0].reshape(-1).tolist()) - {-1}
    live = -(-int(cur[0]) // ps)
    free = [j for j in range(mp) if j not in chosen]
    j = next((j for j in free if j < live), free[0])
    host = ftable.clone()
    host[0, j] = 0                 # frame 0 holds the trash page's garbage
    hidden = GA.block_sparse_attention_grouped(q, fk, fv, sel_lat, cur,
                                               page_table=host, **att)
    sync()
    if not torch.equal(hidden, by_frames):
        raise AssertionError(f"tiered: unselected HOST page {j} changed "
                             "the output")
    share = [len(set(sel[b].reshape(-1).tolist()) - {-1})
             / -(-int(cur[b]) // ps) for b in range(len(cur) - 1)]
    log(f"kernels: tiered pair at B {len(cur) - 1} (+ idle row), page {ps}:"
        " select_blocks over the sidecar (W = d = "
        f"{d}) == over the pool; grouped through a frame table over a "
        "permuted frame pool == through the page table; the pair via "
        "sidecar and frames == fused_loki_decode, bit for bit; an "
        f"unselected {'live' if j < live else 'dead'} page {j} of slot 0 on "
        "the trash frame leaves the output unchanged. Winners' share of "
        "each slot's live pages (union over 32 heads x 8 blocks): "
        + ", ".join(f"{x:.3f}" for x in share))
    results["tiered_kernels"] = dict(winner_share=share, host_page=j,
                                     host_page_live=j < live)


def check_no_fallback():
    """A CUDA tensor never reaches a plain path: a decode shape no kernel
    plan takes (G = 32 query heads per KV head, above the kernels' 16),
    for loki_block and for full, and a paged call whose page (64 tokens)
    the plan's block (128) does not divide, raise instead."""
    from repro_torch.configs.base import LokiConfig
    from repro_torch.core import dispatch

    gen = torch.Generator(device=DEV).manual_seed(9)
    f = dict(device=DEV, generator=gen)
    q = torch.randn((1, 32, 128), **f)
    k, v = torch.randn((2, 1, 256, 1, 128), **f)
    proj = torch.eye(128, device=DEV)[None]
    cur = torch.tensor([200], dtype=torch.int32, device=DEV)
    pool = torch.randn((5 * 64, 1, 128), **f)
    table = torch.arange(1, 5, dtype=torch.int32, device=DEV)[None]
    cfg = LokiConfig(enabled=True, backend="auto")
    calls = {
        "loki_block, G = 32": lambda: dispatch.loki_block_decode(
            q, k, v, cur, proj, cfg),
        "full, G = 32": lambda: dispatch.full_paged_decode(
            q, k, v, cur, backend="auto"),
        "loki_block, page 64 / block 128": lambda: dispatch.loki_block_decode(
            q[:, :1], pool, pool, cur, proj, cfg, page_table=table,
            page_size=64),
        "exact_topk, page 64 / block 128":
            lambda: dispatch.exact_topk_paged_decode(
                q[:, :1], pool, pool, cur, cfg, page_table=table,
                page_size=64),
    }
    for what, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            log(f"kernels: no plan on the card raises ({what}): {e}")
            continue
        raise AssertionError(f"a CUDA decode with no kernel plan did not "
                             f"raise ({what})")


def live_work(case, sel):
    """Tokens the scoring pass must read and winner tokens the attention
    pass must read, for this run's data."""
    cur = case["cur"].long().cpu()
    B, _, Hkv, _ = case["k"].shape
    bs, sw = case["bs"], case["sw"]
    lo = (cur - sw).clamp(min=0) if sw else torch.zeros_like(cur)
    scored = int(((cur - lo) * Hkv).sum())
    sel = sel.long().cpu()
    pos = sel[..., None] * bs + torch.arange(bs)
    ok = (sel[..., None] >= 0) & (pos < cur[:, None, None, None])
    if sw:
        ok &= pos >= (cur - sw)[:, None, None, None]
    return scored, int(ok.sum())


def selected_tokens(sel, cur, bs, s_len, sw=0):
    """(rows..., S) bool: the live tokens of the blocks listed in ``sel``
    (rows..., n) (entries outside [0, S / bs) skipped), below cur_len
    (per leading row) and inside the sliding window."""
    nb = s_len // bs
    ok = (sel >= 0) & (sel < nb)
    blk = torch.zeros(sel.shape[:-1] + (nb + 1,), dtype=torch.bool,
                      device=sel.device)
    blk.scatter_(-1, torch.where(ok, sel.long(), nb), True)
    tok = blk[..., :nb].repeat_interleave(bs, dim=-1)
    pos = torch.arange(s_len, device=sel.device)
    c = cur.long().reshape(cur.shape + (1,) * (sel.ndim - cur.ndim))
    tok &= pos < c
    if sw:
        tok &= pos >= c - sw
    return tok


def full_split(bs, s_len, rows):
    """The full decode's split count at a shape, as its wrapper picks it
    (shapes and this card's SM count only)."""
    from repro_torch.kernels import gather_attention as GA
    n_sm = GA._sm_count(torch.device(DEV)) if DEV == "cuda" else 132
    return GA.full_decode_n_split(s_len // bs, rows, n_sm)


def bounds(case, sel, sel_exact):
    """bound_ms of the five kernels (bytes each input read once, each
    output written once; float32 operations at 67 TFLOP/s)."""
    q, k, v = case["q"], case["k"], case["v"]
    B, Hkv, G, W = q.shape
    D = v.shape[-1]
    d, kb = case["d"], case["kb"]
    ksz, qsz = k.element_size(), q.element_size()
    scored, won = live_work(case, sel)
    _, won_x = live_work(case, sel_exact)
    q_b, out_b, len_b = q.numel() * qsz, B * Hkv * G * D * qsz, 4 * B
    idx_b = 4 * B * Hkv * kb
    score_b = scored * d * ksz
    win_b = won * ((W - d) + D) * ksz          # rest of K̂ rows + V rows
    win_full_b = won * (W + D) * ksz
    score_ops = 2 * scored * G * d
    attn_ops = 2 * won * G * (W + D)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
        return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"

    return {
        "fused_loki_decode": bound(q_b + score_b + win_b + len_b + out_b,
                                   score_ops + attn_ops),
        "select_blocks": bound(q_b + score_b + len_b + idx_b, score_ops),
        "block_sparse_attention_grouped": bound(
            q_b + win_full_b + idx_b + len_b + out_b, attn_ops),
        # every live K and V row once
        "paged_full_decode": bound(q_b + scored * (W + D) * ksz + len_b
                                   + out_b, 2 * scored * G * (W + D)),
        # every live K row at full width, then the winners' V rows
        "fused_exact_topk_decode": bound(
            q_b + scored * W * ksz + won_x * D * ksz + len_b + out_b,
            2 * scored * G * W + 2 * won_x * G * (W + D)),
    }


def library_calls(q, k, v, cur, sel, bs, sw, scale):
    """paged_full_decode's and block_sparse_attention_grouped's functions
    as one scaled_dot_product_attention call each over a logical
    (B, S, Hkv, ·) cache: full attention of the same queries under the
    live-token mask (also the paper's yardstick, not the same function,
    for the sparse kernels), and attention under a boolean mask of the
    selected blocks' live tokens. The views and masks (and the query in
    the cache's dtype) are built here, outside any timed window; each
    call returns (B, Hkv, G, D)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Hkv, G, W = q.shape
    qs = q.reshape(B, Hkv * G, 1, W).to(k.dtype)
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    if G > 1:
        kt = kt.repeat_interleave(G, dim=1)
        vt = vt.repeat_interleave(G, dim=1)
    pos = torch.arange(k.shape[1], device=k.device)
    mask = (pos[None, :] < cur[:, None].long())[:, None, None, :]
    sel_mask = selected_tokens(sel, cur, bs, k.shape[1], sw)
    if G > 1:
        sel_mask = sel_mask.repeat_interleave(G, dim=1)
    sel_mask = sel_mask[:, :, None, :]
    shape = (B, Hkv, G, v.shape[-1])
    return {
        "paged_full_decode": lambda: sdpa(
            qs, kt, vt, attn_mask=mask, scale=scale).reshape(shape),
        "block_sparse_attention_grouped": lambda: sdpa(
            qs, kt, vt, attn_mask=sel_mask, scale=scale).reshape(shape),
    }


def plain_calls(case, sel):
    """The five kernels' plain versions on a case (the grouped attention
    over ``sel``)."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA
    q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
    kw, ex_kw = kernel_kw(case), kernel_kw(case, exact=True)
    att_kw = dict(block_size=case["bs"], scale=kw["scale"],
                  sliding_window=case["sw"])
    return {
        "fused_loki_decode": lambda: F.fused_loki_decode_plain(
            q, k, v, cur, **kw),
        "select_blocks": lambda: F.select_blocks_plain(q, k, cur, **kw),
        "block_sparse_attention_grouped": lambda: GA.attend_blocks_plain(
            q, k, v, sel, cur, **att_kw),
        "paged_full_decode": lambda: GA.full_decode_plain(
            q, k, v, cur, scale=kw["scale"],
            sliding_window=case["sw"]),
        "fused_exact_topk_decode": lambda: F.fused_exact_topk_decode_plain(
            q, k, v, cur, **ex_kw),
    }


def time_cases(results, only=CASE_KEYS):
    """Kernels 1-5 at each decode shape of ``CASE_KEYS`` (granite-moe-3b:
    G 3, D 64, d 16; whisper-small, mixtral-8x22b's window, llava),
    contiguous and paged (the case's page size, one idle row), beside
    their plain versions, their bounds and, for the two attention
    kernels, one scaled_dot_product_attention call."""
    for name_, (key, ps) in only.items():
        g = results[key]
        case, sel = g["case"], g["sel"]
        q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
        scale = kernel_kw(case)["scale"]
        kern = paged_calls(case, q, cur, None, 0, k, v, sel)
        pq, pcur, ptable, pk, pv, psel = results.pop(f"paged_{key}")
        paged = paged_calls(case, pq, pcur, ptable, ps, pk, pv, psel)
        plain = plain_calls(case, sel)
        lib_calls = library_calls(q, k, v, cur, sel, case["bs"], case["sw"],
                                  scale)
        lib = {n: time_ms(f) for n, f in lib_calls.items()}
        bnd = bounds(case, sel, g["sel_exact"])
        timing = {}
        for name in KERNELS:
            ms, paged_ms = time_ms(kern[name]), time_ms(paged[name])
            plain_ms = time_ms(plain[name], reps=5)
            timing[name] = dict(ms=ms, paged_ms=paged_ms, plain_ms=plain_ms,
                                bound_ms=bnd[name][0], bound_by=bnd[name][1],
                                library_ms=lib.get(name))
            log(f"timing: {name} at {name_}: {ms:.4f} ms contiguous, "
                f"{paged_ms:.4f} ms paged (page {ps}), bound "
                f"{bnd[name][0]:.4f} ms by {bnd[name][1]}, plain "
                f"{plain_ms:.4f} ms"
                + (f", scaled_dot_product_attention {lib[name]:.4f} ms"
                   if name in lib else ""))
        results[f"{key}_timing"] = timing
        del pk, pv, kern, paged


def time_kernels(results):
    """Each kernel contiguous and paged, its plain version and, for the
    full decode, the one PyTorch call that computes the same function, at
    the main-path shape."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA

    main = results["main"]
    case, sel = main["case"], main["sel"]
    q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
    kw, ex_kw = kernel_kw(case), kernel_kw(case, exact=True)
    att_kw = dict(block_size=case["bs"], scale=kw["scale"],
                  sliding_window=case["sw"])
    kern = paged_calls(case, q, cur, None, 0, k, v, sel)
    pq, pcur, ptable, pk, pv, psel = results["paged"]
    paged = paged_calls(case, pq, pcur, ptable, 128, pk, pv, psel)
    plain = plain_calls(case, sel)
    B, Hkv = q.shape[:2]
    lib_calls = library_calls(q, k, v, cur, sel, case["bs"], case["sw"],
                              kw["scale"])
    sdpa_ms = time_ms(lib_calls["paged_full_decode"])
    lib = {"paged_full_decode": sdpa_ms,
           "block_sparse_attention_grouped": time_ms(
               lib_calls["block_sparse_attention_grouped"])}
    lib_err = float((lib_calls["block_sparse_attention_grouped"]().float()
                     - kern["block_sparse_attention_grouped"]().float())
                    .abs().max())
    bnd = bounds(case, sel, main["sel_exact"])
    timing = {}
    log(f"timing: card before (SM clock, memory clock, temperature, "
        f"power): {card_state()}")
    for name in KERNELS:
        ms, paged_ms = time_ms(kern[name]), time_ms(paged[name])
        plain_ms = time_ms(plain[name], reps=5)
        timing[name] = dict(ms=ms, paged_ms=paged_ms, plain_ms=plain_ms,
                            bound_ms=bnd[name][0], bound_by=bnd[name][1],
                            library_ms=lib.get(name))
        log(f"timing: {name} at {case['name']}: {ms:.4f} ms contiguous, "
            f"{paged_ms:.4f} ms paged (page 128, one more idle row), bound "
            f"{bnd[name][0]:.4f} ms by {bnd[name][1]}, plain "
            f"{plain_ms:.4f} ms")
    log(f"timing: scaled_dot_product_attention over the same live cache "
        f"(library call of paged_full_decode's function): {sdpa_ms:.4f} ms")
    log(f"timing: scaled_dot_product_attention under the selected blocks' "
        f"token mask (library call of block_sparse_attention_grouped's "
        f"function): {lib['block_sparse_attention_grouped']:.4f} ms, max "
        f"|d| to the kernel {lib_err:.3e}")
    log(f"timing: card after: {card_state()}")
    full = timing["paged_full_decode"]
    for name, plan in main["plans"].items():
        if plan["C"] < 2:
            raise AssertionError(f"{name} at the main shape launches "
                                 f"clusters of {plan['C']} CTA")
        t = timing[name]
        log(f"timing: {name} launches clusters of C = {plan['C']} CTAs "
            f"({B * Hkv * plan['C']} CTAs of 128 threads), "
            f"{plan['smem']} B dynamic shared memory each, "
            f"cudaOccupancyMaxActiveClusters {plan['max_clusters']}, "
            f"{plan['ctas_per_sm']} CTAs resident per SM; "
            f"{t['ms']:.4f} / {t['paged_ms']:.4f} ms contiguous / paged = "
            f"{t['ms'] / t['bound_ms']:.2f}x / "
            f"{t['paged_ms'] / t['bound_ms']:.2f}x its bound, "
            f"{t['ms'] / full['ms']:.2f}x / "
            f"{t['paged_ms'] / full['paged_ms']:.2f}x paged_full_decode on "
            f"the same cache ({full['ms']:.4f} / {full['paged_ms']:.4f} ms)")
    results["fused_plans"] = main["plans"]
    # the scratch as the allocator saw it: one call's peak beyond its output
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = kern["paged_full_decode"]()
    sync()
    scratch = (torch.cuda.max_memory_allocated() - base
               - out.numel() * out.element_size())
    del out
    n_split = full_split(case["bs"], k.shape[1], B * Hkv)
    fp = GA.full_plan(q, k, v, block_size=case["bs"])
    log(f"timing: paged_full_decode splits each (slot, kv-head)'s live "
        f"blocks {n_split} ways by its wrapper's rule ({B * Hkv * n_split} "
        f"CTAs on {torch.cuda.get_device_properties(0).multi_processor_count}"
        f" SMs; chunks of {fp['tokens']} tokens, {fp['stage']} B a ring "
        f"stage, {fp['smem']} B shared memory, {fp['ctas_per_sm']} CTAs "
        f"resident per SM); one call's device memory beyond its output (the "
        f"float32 partials): {scratch} B")
    results.setdefault("timing", {}).update(timing)
    results["sdpa_ms"] = sdpa_ms
    del results["paged"]


# ------------------------------------------------ page layouts (storage)

#: the storages of the kernels' new modes (PageLayout dtypes: int8 and fp8
#: codes carry per-page scales, fp16 values none), each at the main case's
#: native key width (rank 0, W = D) and in the PCA basis cut to rank 32
LAYOUT_STORAGE = ("fp16", "int8", "fp8")
LAYOUT_RANKS = (0, 32)


def layout_tag(dtype, rank):
    return dtype + (f":pca:r={rank}" if rank else "")


def layout_case(case, dtype, rank, ps=128, seed=0, label="llama2-7b",
                idle=True):
    """A kernel case's caches stored at a page layout: a shuffled pool of
    ``ps``-token pages (plus, with ``idle``, a row on the trash page,
    cur_len 1), K
    cut to its leading ``rank`` features (0: all), written by the port's
    own pool writers: int8 and fp8 through write_chunk_rows_q (codes and
    per-page scales), fp16 through write_chunk_rows. The dict holds the
    query, lengths, table, pools and scales, the dequantized logical views
    (``lk``, ``lv``) the plain versions read, and the case's block size,
    k_blocks, windows and name (``label`` and the layout)."""
    from repro_torch.configs.base import PageLayout
    from repro_torch.kernels import gather_attention as GA
    from repro_torch.serving import paged_cache as PC
    lay = PageLayout(dtype=dtype)
    W = rank or case["k"].shape[-1]
    q, k, v, cur = (case["q"][..., :W].contiguous(), case["k"][..., :W],
                    case["v"], case["cur"])
    B, S = k.shape[:2]
    mp = S // ps
    gen = torch.Generator().manual_seed(seed)
    table = torch.zeros((B + 1, mp), dtype=torch.int32)
    table[:B] = (torch.randperm(B * mp, generator=gen) + 1).view(B, mp)
    table = table.to(DEV)
    n_pages = B * mp + 1
    pools, scales = [], []
    for x in (k, v):
        pool = torch.zeros((n_pages * ps,) + x.shape[2:], device=DEV,
                           dtype=PC.STORAGE_DTYPE[dtype])
        sc = torch.zeros(n_pages, device=DEV) if lay.quantized else None
        for b in range(B):
            if sc is None:
                PC.write_chunk_rows(pool, x[b], table[b], 0, ps)
            else:
                PC.write_chunk_rows_q(pool, sc, x[b].float(), table[b], 0,
                                      ps, qmax=lay.qmax)
        pools.append(pool)
        scales.append(sc)
    if idle:
        q = torch.cat([q, q[:1]])
        cur = torch.cat([cur, torch.ones(1, dtype=cur.dtype, device=DEV)])
    else:
        table = table[:B]
    q2, cur2 = q, cur
    _, lk, lv = GA.logical(q2, pools[0], pools[1], table, ps, scales[0],
                           scales[1])
    return dict(name=f"{label} {layout_tag(dtype, rank)}", dtype=dtype,
                rank=rank, W=W, ps=ps, q=q2, cur=cur2, table=table,
                k=pools[0], v=pools[1], ks=scales[0], vs=scales[1], lk=lk,
                lv=lv, bs=case["bs"], d=min(case["d"], W), kb=case["kb"],
                lw=case["lw"], sw=case["sw"], scale=v.shape[-1] ** -0.5)


def layout_calls(lc, sel, sel_x):
    """The five kernels on a layout case's pool (``sel``, ``sel_x``: the
    grouped attention's block lists at the Loki and exact selections), and
    their plain versions on the dequantized logical view."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA
    q, cur, k, v, lk, lv = (lc[n] for n in ("q", "cur", "k", "v", "lk",
                                            "lv"))
    pg = dict(page_table=lc["table"], page_size=lc["ps"])
    sc = dict(k_scale=lc["ks"], v_scale=lc["vs"])
    base = dict(k_blocks=lc["kb"], block_size=lc["bs"], scale=lc["scale"],
                sliding_window=lc["sw"])
    kw = dict(base, d=lc["d"], local_window=lc["lw"])
    att = dict(block_size=lc["bs"], scale=lc["scale"],
               sliding_window=lc["sw"])
    kern = {
        "fused_loki_decode": lambda: F.fused_loki_decode(q, k, v, cur, **kw,
                                                         **pg, **sc),
        "select_blocks": lambda: F.select_blocks(q, k, cur, **kw, **pg,
                                                 k_scale=lc["ks"]),
        "block_sparse_attention_grouped": lambda:
            GA.block_sparse_attention_grouped(q, k, v, sel, cur, **att, **pg,
                                              **sc),
        "paged_full_decode": lambda: GA.paged_full_decode(q, k, v, cur,
                                                          **att, **pg, **sc),
        "fused_exact_topk_decode": lambda: F.fused_exact_topk_decode(
            q, k, v, cur, **base, **pg, **sc),
        "exact pair": lambda: GA.block_sparse_attention_grouped(
            q, k, v, sel_x, cur, **att, **pg, **sc),
    }
    plain = {
        "fused_loki_decode": lambda: F.fused_loki_decode_plain(
            q, lk, lv, cur, **kw),
        "select_blocks": lambda: F.select_blocks_plain(q, lk, cur, **kw),
        "block_sparse_attention_grouped": lambda: GA.attend_blocks_plain(
            q, lk, lv, sel, cur, **att),
        "paged_full_decode": lambda: GA.full_decode_plain(
            q, lk, lv, cur, scale=lc["scale"], sliding_window=lc["sw"]),
        "fused_exact_topk_decode": lambda: F.fused_exact_topk_decode_plain(
            q, lk, lv, cur, **base),
    }
    return kern, plain, kw, base


def layout_plans(lc):
    """The launchers' shared memory at a layout case, each equal to its
    tuning mirror (the fused, select and grouped ones through
    ``checked_plan``, with C and residency; the full decode's through
    ``loki_full_smem_bytes``)."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA
    from repro_torch.kernels import tuning
    q, k, v = lc["q"], lc["k"], lc["v"]
    B, Hkv, G, W = q.shape
    D, st = v.shape[-1], tuning.storage_of(k)
    nb = lc["table"].shape[1] * lc["ps"] // lc["bs"]
    pg = dict(page_table=lc["table"], page_size=lc["ps"])
    plans = {}
    for name, d in (("fused_loki_decode", lc["d"]),
                    ("fused_exact_topk_decode", W)):
        plans[name] = checked_plan(
            f"{lc['name']}: {name}",
            lambda: F.cluster_plan(q, k, v, d=d, k_blocks=lc["kb"],
                                   block_size=lc["bs"], **pg),
            tuning.fused_smem_bytes(nb=nb, k_blocks=lc["kb"], g=G, kdim=W,
                                    dim=D, bs=lc["bs"], d=d, storage=st),
            nb, B * Hkv)
    plans["select_blocks"] = checked_plan(
        f"{lc['name']}: select_blocks",
        lambda: F.select_plan(q, k, d=lc["d"], k_blocks=lc["kb"],
                              block_size=lc["bs"], **pg),
        tuning.select_smem_bytes(nb=nb, g=G, kdim=W, d=lc["d"], bs=lc["bs"],
                                 storage=st), nb, B * Hkv)
    idx = torch.zeros((B, Hkv, lc["kb"]), dtype=torch.int32, device=DEV)
    plans["block_sparse_attention_grouped"] = checked_plan(
        f"{lc['name']}: block_sparse_attention_grouped",
        lambda: GA.attend_plan(q, k, v, idx, block_size=lc["bs"], **pg),
        tuning.attend_smem_bytes(n_sel=lc["kb"], g=G, kdim=W, dim=D,
                                 storage=st), nb, B * Hkv)
    plans["paged_full_decode"] = full_smem_checked(lc["name"], q, k, v,
                                                   lc["bs"])
    return plans


def full_smem_checked(what, q, k, v, bs):
    """paged_full_decode's plan as its library gives it (``full_plan``:
    tokens per chunk, stage bytes, shared memory, resident CTAs per SM),
    its shared memory and its layout query's (``loki_full_smem_bytes``)
    asserted equal to tuning.full_smem_bytes, its stage to
    tuning.split_stage_bytes, at least one CTA resident per SM."""
    from repro_torch.kernels import gather_attention as GA
    from repro_torch.kernels import tuning
    B, Hkv, G, W = q.shape
    D, st = v.shape[-1], tuning.storage_of(k)
    want = tuning.full_smem_bytes(g=G, kdim=W, dim=D, storage=st)
    if DEV != "cuda":
        return dict(smem=want)
    plan = GA.full_plan(q, k, v, block_size=bs)
    stage = tuning.split_stage_bytes(kdim=W, dim=D, storage=st)
    if not plan["smem"] == plan["smem_layout"] == want \
            or plan["stage"] != stage or plan["ctas_per_sm"] < 1:
        raise AssertionError(f"{what}: paged_full_decode plan {plan} != "
                             f"tuning.full_smem_bytes {want}, stage {stage}")
    return plan


def layout_bounds(lc, sel, sel_x):
    """bound_ms of the five kernels at a layout case: bytes at the storage
    width (each input read once: the live rows each kernel must read, the
    page scales it reads, the query, lengths and indices; each output
    written once) over 3.35 TB/s, against float32 operations (the
    dequantizing multiply of each code read included) at 67 TFLOP/s."""
    q, k = lc["q"], lc["k"]
    B, Hkv, G, W = q.shape
    D, d, kb, bs = lc["v"].shape[-1], lc["d"], lc["kb"], lc["bs"]
    isz, qsz = k.element_size(), q.element_size()
    cur = lc["cur"].long().cpu()
    scored = int(cur.sum()) * Hkv

    def won(s):
        s = s.long().cpu()
        pos = s[..., None] * bs + torch.arange(bs)
        return int(((s[..., None] >= 0)
                    & (pos < cur[:, None, None, None])).sum())
    won_l, won_x = won(sel), won(sel_x)
    n_pages = lc["ks"].numel() if lc["ks"] is not None else 0
    sc_b = 4 * n_pages                      # one scale vector, read once
    q_b, out_b, len_b = q.numel() * qsz, B * Hkv * G * D * qsz, 4 * B
    idx_b = 4 * B * Hkv * kb

    def bound(nbytes, elems, fmas):
        tb = nbytes / HBM_BYTES_PER_S
        to = (2 * fmas + (elems if n_pages else 0)) / FP32_FLOPS
        return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"

    return {
        "fused_loki_decode": bound(
            q_b + scored * d * isz + won_l * ((W - d) + D) * isz + 2 * sc_b
            + len_b + out_b, scored * d + won_l * (W + D),
            scored * G * d + won_l * G * (W + D)),
        "select_blocks": bound(q_b + scored * d * isz + sc_b + len_b
                               + idx_b, scored * d, scored * G * d),
        "block_sparse_attention_grouped": bound(
            q_b + won_l * (W + D) * isz + 2 * sc_b + idx_b + len_b + out_b,
            won_l * (W + D), won_l * G * (W + D)),
        "paged_full_decode": bound(
            q_b + scored * (W + D) * isz + 2 * sc_b + len_b + out_b,
            scored * (W + D), scored * G * (W + D)),
        "fused_exact_topk_decode": bound(
            q_b + scored * W * isz + won_x * D * isz + 2 * sc_b + len_b
            + out_b, scored * W + won_x * D,
            scored * G * W + won_x * G * (W + D)),
    }


#: correctness-only layout cases beside the timed main ones, each a
#: (kernel_cases() index, storage, rank): the narrow body at G = 8
#: (qwen2.5-3b) and under a sliding window whose start cuts a block
LAYOUT_CHECKS = ((3, "int8", 32), (5, "fp8", 0))


def check_layouts(results):
    """The five kernels' storage modes (fp16; int8 and fp8 with per-page
    scales) on pools the port's own writers fill, at the main case, native
    and at rank 32, then untimed at the LAYOUT_CHECKS cases, each through
    ``layout_checked`` (the pairs bit for bit against the fused kernels at
    the Loki and exact selections, so select_blocks' block maxima are the
    fused kernels' bits; shared memory equal to tuning's at every
    storage); then, at the main case, each timed (CUDA events, L2
    flushed, median of 20) beside its plain version, its bound at the
    storage bytes and, for fp16 pools, the library call of the same
    function (``library_calls`` over the fp16 view; int8 and fp8 modes
    have none)."""
    cases = kernel_cases()
    todo = [(cases[0], dtype, rank, True) for dtype in LAYOUT_STORAGE
            for rank in LAYOUT_RANKS]
    todo += [(cases[i], dtype, rank, False)
             for i, dtype, rank in LAYOUT_CHECKS]
    timing, errs, plans_all = {}, {}, {}
    for case, dtype, rank, timed in todo:
        lc = layout_case(case, dtype, rank, seed=rank + len(dtype),
                         label=("llama2-7b" if timed else case["name"]))
        tag = layout_tag(dtype, rank)
        chk = layout_checked(lc)
        plans_all[lc["name"]] = chk["plans"]
        if timed:
            time_layout(lc, tag, chk["kern"], chk["plain"], chk["got"],
                        chk["sel"], chk["sel_x"], timing)
            for name in KERNELS:
                errs[f"{name}[{tag}]"] = chk["errs"][name]
        del lc, chk
        if DEV == "cuda":
            torch.cuda.empty_cache()
    results["layout_timing"] = timing
    results["layout_errs"] = errs
    results["layout_plans"] = plans_all


#: the batch widths of gather-packed decode at 4 slots (buckets 1 and 2;
#: 3 and 4 live slots run full width) and the layouts the paged runs
#: reach them at: the engines' fp32 pool and int8:pca:r=32
PACKED_WIDTHS = (1, 2)
PACKED_LAYOUTS = (("fp32", 0), ("int8", 32))


def check_packed_widths(results):
    """Kernels 1-5 at the packed buckets' widths (llama2-7b: Hkv 32, D
    128, S 4096, bs 128, d 32, k_blocks 8; bf16 queries; rows B * Hkv = 32
    and 64 against the main case's 128), paged, at fp32 and
    int8:pca:r=32, each through ``layout_checked`` as the layout cases
    are, so a cluster of C CTAs that cannot be resident fails here and
    not inside the engine. Logs C, the full decode's split count and the
    resident clusters at each width."""
    base = dict(Hkv=32, G=1, D=128, S=4096, bs=128, d=32, kb=8, lw=16, sw=0)
    curs = {1: [3000], 2: [3000, 2500]}
    out = {}
    for B in PACKED_WIDTHS:
        case = make_case(f"packed B={B}", B=B, **base, cur=curs[B],
                         kv_dtype=torch.float32, q_dtype=torch.bfloat16,
                         seed=20 + B)
        for dtype, rank in PACKED_LAYOUTS:
            lc = layout_case(case, dtype, rank, seed=30 + B + rank,
                             label=f"packed B={B}", idle=False)
            chk = layout_checked(lc)
            n_split = full_split(lc["bs"], lc["lk"].shape[1],
                                 B * base["Hkv"])
            plans = chk["plans"]
            out[lc["name"]] = dict(plans, n_split=n_split,
                                   max_abs_err=chk["errs"])
            log(f"packed widths: {lc['name']}: rows {B * base['Hkv']}: "
                + ", ".join(f"{n} C {p['C']}, {p['max_clusters']} resident "
                            "clusters" for n, p in plans.items() if "C" in p)
                + f"; paged_full_decode {n_split} splits, "
                f"{plans['paged_full_decode'].get('ctas_per_sm')} CTAs per "
                "SM resident")
            del lc, chk
        del case
        if DEV == "cuda":
            torch.cuda.empty_cache()
    results["packed_widths"] = out


def layout_checked(lc):
    """The five kernels on one layout case (``layout_case``), each against
    its plain version on the dequantized view at tolerance(q's dtype)
    (select_blocks: indices equal on rows without a near-tie), the cluster
    kernels against their plain cluster form at the launcher's C, the full
    decode against its plain splits, the pairs select_blocks + grouped
    equal to the fused kernels bit for bit, every launcher's plan checked
    (``layout_plans``); logged. Returns the errors, the calls and their
    outputs, the two selections and the plans."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA
    q, cur, lk, lv = lc["q"], lc["cur"], lc["lk"], lc["lv"]
    plans = layout_plans(lc)
    W, sw = lc["W"], lc["sw"]
    sels = {}
    for what, d, lw in (("loki", lc["d"], lc["lw"]), ("exact", W, 0)):
        kw = dict(d=d, local_window=lw, k_blocks=lc["kb"],
                  block_size=lc["bs"], scale=lc["scale"],
                  sliding_window=sw)
        ties = near_tie_rows(F.block_scores_plain(
            q, lk, cur, d=d, block_size=lc["bs"], scale=lc["scale"],
            local_window=lw, sliding_window=sw), lc["kb"])
        sel_k = F.select_blocks(q, lc["k"], cur, **kw,
                                page_table=lc["table"],
                                page_size=lc["ps"], k_scale=lc["ks"])
        sel_p = F.select_blocks_plain(q, lk, cur, **kw)
        sync()
        diff = (sel_k != sel_p).any(-1)
        if (diff & ~ties).any():
            raise AssertionError(
                f"{lc['name']}: select_blocks ({what}) indices "
                f"differ in {int((diff & ~ties).sum())} rows with no "
                "near-tie")
        sels[what] = (sel_k, sel_p, ~diff)
    (sel_k, sel_p, agree), (sel_kx, _, agree_x) = (sels["loki"],
                                                    sels["exact"])
    kern, plain, kw, base = layout_calls(lc, sel_k, sel_kx)
    got = {n: f() for n, f in kern.items()}
    sync()
    # the pairs, bit for bit: the grouped kernel over select_blocks'
    # list is the fused kernel
    for fused, pair in (("fused_loki_decode",
                         "block_sparse_attention_grouped"),
                        ("fused_exact_topk_decode", "exact pair")):
        if not torch.equal(got[fused], got[pair]):
            gap = float((got[fused] - got[pair]).float().abs().max())
            raise AssertionError(
                f"{lc['name']}: select_blocks + grouped differs from "
                f"{fused} (max |d| {gap:.3e})")
    pg = dict(page_table=lc["table"], page_size=lc["ps"],
              k_scale=lc["ks"], v_scale=lc["vs"])
    att = dict(block_size=lc["bs"], scale=lc["scale"], sliding_window=sw)
    grouped_p = GA.block_sparse_attention_grouped(
        q, lc["k"], lc["v"], sel_p, cur, **att, **pg)
    runs = {
        "fused_loki_decode": (got["fused_loki_decode"],
                              plain["fused_loki_decode"](), agree),
        "fused_loki_decode (cluster)": (
            got["fused_loki_decode"],
            F.fused_cluster_plain(
                q, lc["k"], lc["v"], cur, **kw, **pg,
                n_cta=plans["fused_loki_decode"]["C"]), agree),
        "fused_exact_topk_decode": (
            got["fused_exact_topk_decode"],
            plain["fused_exact_topk_decode"](), agree_x),
        "fused_exact_topk_decode (cluster)": (
            got["fused_exact_topk_decode"],
            F.fused_cluster_plain(
                q, lc["k"], lc["v"], cur, **base, d=W,
                local_window=0, **pg,
                n_cta=plans["fused_exact_topk_decode"]["C"]),
            agree_x),
        "block_sparse_attention_grouped": (
            grouped_p, GA.attend_blocks_plain(q, lk, lv, sel_p, cur,
                                              **att), None),
        "block_sparse_attention_grouped (cluster)": (
            grouped_p,
            GA.grouped_cluster_plain(
                q, lc["k"], lc["v"], sel_p, cur, **att, **pg,
                n_cta=plans["block_sparse_attention_grouped"]["C"]),
            None),
        "paged_full_decode": (got["paged_full_decode"],
                              plain["paged_full_decode"](), None),
        "paged_full_decode (splits)": (
            got["paged_full_decode"],
            GA.full_decode_split_plain(
                q, lc["k"], lc["v"], cur, **att, **pg,
                n_split=full_split(lc["bs"], lk.shape[1],
                                   q.shape[0] * q.shape[1])), None),
    }
    atol, rtol = tolerance(q.dtype)
    e = {}
    for kname, (g, w, rows) in runs.items():
        g32, w32 = g.float(), w.float()
        if rows is not None:
            g32, w32 = g32[rows], w32[rows]
        if not torch.isfinite(g32).all():
            raise AssertionError(f"{lc['name']}: {kname} non-finite")
        torch.testing.assert_close(
            g32, w32, atol=atol, rtol=rtol,
            msg=lambda m: f"{lc['name']}: {kname}: {m}")
        e[kname.split(" ")[0]] = max(
            e.get(kname.split(" ")[0], 0.0),
            float((g32 - w32).abs().max()) if g32.numel() else 0.0)
    e["select_blocks"] = 0.0          # indices equal off near-ties
    full = plans["paged_full_decode"]
    log(f"layouts: {lc['name']}: pool {lc['k'].dtype} K width {W}, "
        f"G {q.shape[2]}, window {sw}: indices equal in "
        f"{int(agree.sum())}/{agree.numel()} rows (d={lc['d']}) and "
        f"{int(agree_x.sum())}/{agree_x.numel()} (d={W}); pairs == "
        f"fused kernels bit for bit; max|err| "
        + ", ".join(f"{n} {x:.3e}" for n, x in e.items())
        + f" (atol {atol}, rtol {rtol}); shared memory "
        + ", ".join(f"{n} {p['smem']} B" for n, p in plans.items()))
    log(f"layouts: {lc['name']}: attention body: chunks of "
        f"{full.get('tokens')} tokens, {full.get('stage')} B a ring "
        f"stage; resident CTAs per SM: paged_full_decode "
        f"{full.get('ctas_per_sm')}, "
        + ", ".join(f"{n} {p.get('ctas_per_sm')}"
                    for n, p in plans.items()
                    if n != "paged_full_decode"))
    return dict(errs=e, kern=kern, plain=plain, got=got, sel=sel_k,
                sel_x=sel_kx, plans={
                    n: {k: p.get(k) for k in ("C", "smem", "max_clusters",
                                              "ctas_per_sm", "tokens",
                                              "stage") if k in p}
                    for n, p in plans.items()})


def time_layout(lc, tag, kern, plain, got, sel, sel_x, timing):
    """A main layout case's five kernels timed (CUDA events, L2 flushed,
    median of 20) beside their plain versions, their bounds at the storage
    bytes and, for an fp16 pool, the library call of the same function
    (one SDPA over the fp16 logical view; an int8 or fp8 pool needs its
    dequantizing multiply first, so no single library call computes those
    modes: library_ms null), into ``timing`` by "kernel[layout]"."""
    q, cur, lk, lv = lc["q"], lc["cur"], lc["lk"], lc["lv"]
    bnd = layout_bounds(lc, sel, sel_x)
    lib, lib_err = {}, {}
    if lc["ks"] is None:
        calls = library_calls(q, lk, lv, cur, sel, lc["bs"], 0, lc["scale"])
        for n, f in calls.items():
            lib[n] = time_ms(f) if DEV == "cuda" else float("nan")
            lib_err[n] = float((f().float() - got[n].float()).abs().max())
        del calls
        log(f"layouts: {lc['name']}: scaled_dot_product_attention over the "
            f"fp16 logical view (library call of the same function): "
            + "; ".join(f"{n} {lib[n]:.4f} ms, max |d| to the kernel "
                        f"{lib_err[n]:.3e}" for n in lib))
    for name in KERNELS:
        # a CPU rehearsal has no events to time with
        ms = time_ms(kern[name]) if DEV == "cuda" else float("nan")
        plain_ms = (time_ms(plain[name], reps=5) if DEV == "cuda"
                    else float("nan"))
        timing[f"{name}[{tag}]"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bnd[name][0],
            bound_by=bnd[name][1], library_ms=lib.get(name))
    log(f"layouts: {lc['name']}: ms (bound, plain) "
        + "; ".join(f"{n} {timing[f'{n}[{tag}]']['ms']:.4f} "
                    f"({timing[f'{n}[{tag}]']['bound_ms']:.4f} by "
                    f"{timing[f'{n}[{tag}]']['bound_by']}, "
                    f"{timing[f'{n}[{tag}]']['plain_ms']:.4f})"
                    for n in KERNELS))


def log_storage_against_fp32(results):
    """Each storage mode's time beside the same kernel's fp32 mode on the
    same case (the fp32 pool, paged, from time_kernels), its ratio to its
    bound and, for the full decode's fp16 modes, to the SDPA call over the
    fp16 view."""
    fp32 = results["timing"]
    for key, t in results["layout_timing"].items():
        name = key.split("[")[0]
        ref = fp32[name]["paged_ms"]
        lib = t["library_ms"]
        log(f"storage: {key} {t['ms']:.4f} ms against fp32 {ref:.4f} ms "
            f"({t['ms'] / ref:.2f}x), {t['ms'] / t['bound_ms']:.2f}x its "
            f"bound {t['bound_ms']:.4f} ms"
            + (f", {t['ms'] / lib:.2f}x SDPA over the fp16 view "
               f"({lib:.4f} ms)" if lib is not None and name in (
                   "paged_full_decode", "block_sparse_attention_grouped")
               else ""))


# ------------------------------------------- per-head pipeline and flash

HEAD_KERNELS = ("block_max_scores", "block_max_scores_fm",
                "block_sparse_attention")


def make_head_case(name, *, BH, D, S, bs, d, kb, cur, heads, kv_dtype,
                   q_dtype, seed):
    """A per-head case: (BH, D) queries over (BH, S, D) caches, the
    batch's cur_len repeated for each of its ``heads`` rows."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    f = dict(device=DEV, generator=gen)
    return dict(
        name=name, bs=bs, d=d, kb=kb,
        q=torch.randn((BH, D), **f).to(q_dtype),
        k=torch.randn((BH, S, D), **f).to(kv_dtype),
        v=torch.randn((BH, S, D), **f).to(kv_dtype),
        cur=torch.tensor(cur, dtype=torch.int32,
                         device=DEV).repeat_interleave(heads))


def head_cases():
    """The per-head shapes, made one at a time: llama2-7b's decode step
    flattened per head (B 4 x Hkv 32 rows) first."""
    f32, bf16 = torch.float32, torch.bfloat16
    llama = dict(BH=128, D=128, S=4096, bs=128, d=32, kb=8, heads=32,
                 cur=[3000, 2500, 1800, 3100])
    yield make_head_case("llama2-7b per head q:bf16 kv:fp32", **llama,
                         kv_dtype=f32, q_dtype=bf16, seed=21)
    yield make_head_case("llama2-7b per head q:fp32 kv:fp32", **llama,
                         kv_dtype=f32, q_dtype=f32, seed=22)
    yield make_head_case("llama2-7b per head q:bf16 kv:bf16", **llama,
                         kv_dtype=bf16, q_dtype=bf16, seed=23)
    yield make_head_case("per head head_dim=256, d=64",
                         **dict(llama, BH=64, D=256, d=64, heads=16),
                         kv_dtype=f32, q_dtype=f32, seed=24)
    yield make_head_case("per head short cur_len, dead-block ties",
                         **dict(llama, cur=[1, 100, 129, 300]),
                         kv_dtype=f32, q_dtype=f32, seed=25)
    # block_max_scores_fm's edges: a run that does not start on a 16-byte
    # piece (bs * 4 % 16 != 0, also S * 4: single tokens) at the least d;
    # cur_len inside a 16-byte piece (8 bf16 tokens) and inside a run
    yield make_head_case("per head S 390, bs 30, d 8 (fm single tokens)",
                         BH=8, D=128, S=390, bs=30, d=8, kb=8, heads=2,
                         cur=[390, 200, 31, 389], kv_dtype=f32,
                         q_dtype=f32, seed=27)
    yield make_head_case("per head cur_len inside a 16-byte piece, bf16",
                         **dict(llama, BH=16, d=16, heads=4,
                                cur=[1003, 2051, 517, 4093]),
                         kv_dtype=bf16, q_dtype=bf16, seed=28)


def head_plans(case, kT, sel):
    """block_sparse_attention's launcher plans at a per-head case over the
    token-major K̂ and the feature-major K̂ᵀ (``checked_plan``, against
    tuning.attend_smem_bytes at G = 1 and 16-byte chunks)."""
    from repro_torch.kernels import gather_attention as GA
    from repro_torch.kernels import tuning
    q, k = case["q"], case["k"]
    bh, dim = q.shape
    want = tuning.attend_smem_bytes(n_sel=sel.shape[1], g=1, kdim=dim,
                                    dim=dim, storage=tuning.storage_of(k),
                                    tok=16 // k.element_size())
    return {lay: checked_plan(
        f"{case['name']}: block_sparse_attention {lay}",
        lambda: GA.head_plan(q, kk, sel, block_size=case["bs"]), want,
        k.shape[1] // case["bs"], bh)
        for lay, kk in (("token-major", k),
                        ("feature-major", kT.transpose(1, 2)))}


def fm_plan_checked(case, q, kT):
    """block_max_scores_fm's launch at a case (``fm_plan``), checked: its
    shared memory equals tuning.scores_fm_smem_bytes, it reads 16-byte
    pieces exactly where a run starts on one (bs times the item size a
    multiple of 16), and a CTA fits on an SM."""
    from repro_torch.kernels import approx_scores_fm as ASF
    from repro_torch.kernels import tuning
    bs, d = case["bs"], case["d"]
    want = dict(vec=int(bs * kT.element_size() % 16 == 0),
                smem=tuning.scores_fm_smem_bytes(
                    bs=bs, storage=tuning.storage_of(kT)))
    if DEV != "cuda":                 # a CPU rehearsal: no library to ask
        return dict(want, ctas_per_sm=None, registers=None,
                    local_bytes=None)
    plan = ASF.fm_plan(q, kT, d=d, block_size=bs)
    if any(plan[key] != val for key, val in want.items()) or \
            plan["ctas_per_sm"] < 1:
        raise AssertionError(f"{case['name']}: block_max_scores_fm launch "
                             f"{plan} != {want} (tuning), or no CTA fits")
    return plan


def check_head_kernels(results):
    """block_max_scores, block_max_scores_fm and block_sparse_attention
    against their plain versions on every per-head case, and the ops
    pipelines built on them. Block maxima: within fp32 summation order
    (1e-4), dead blocks exactly -1e30, the two layouts bit for bit;
    selections equal on rows without a near-tie (dead blocks tie exactly
    in both and go to the lower index in both); attention within
    ``tolerance``."""
    from repro_torch.core.loki import topk_lower_index
    from repro_torch.kernels import approx_scores as AS
    from repro_torch.kernels import approx_scores_fm as ASF
    from repro_torch.kernels import gather_attention as GA
    from repro_torch.kernels import ops

    for case in head_cases():
        q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
        bs, d, kb = case["bs"], case["d"], case["kb"]
        kw = dict(d=d, block_size=bs, scale=q.shape[-1] ** -0.5)
        kT = k.transpose(1, 2).contiguous()          # feature-major copy
        fm = fm_plan_checked(case, q, kT)
        blk = AS.block_max_scores(q, k, cur, **kw)
        blk_again = AS.block_max_scores(q, k, cur, **kw)
        blk_fm = ASF.block_max_scores_fm(q, kT, cur, **kw)
        blk_p = AS.block_max_scores_plain(q, k, cur, **kw)
        blk_fm_p = ASF.block_max_scores_fm_plain(q, kT, cur, **kw)
        sync()
        dead = blk_p <= NEG_INF / 2
        errs = {}
        for name, got, want in (("block_max_scores", blk, blk_p),
                                ("block_max_scores_fm", blk_fm, blk_fm_p)):
            if not torch.equal(got[dead], want[dead]) or \
                    (got[~dead] <= NEG_INF / 2).any():
                raise AssertionError(f"{case['name']}: {name}: dead blocks "
                                     "are not exactly -1e30")
            torch.testing.assert_close(
                got[~dead], want[~dead], atol=1e-4, rtol=1e-4,
                msg=lambda m: f"{case['name']}: {name}: {m}")
            errs[name] = float((got - want).abs()[~dead].max())
        # the two kernels sum each dot in one order (the plain versions,
        # run in a CPU rehearsal, do not)
        if DEV == "cuda" and not torch.equal(blk_fm, blk):
            raise AssertionError(f"{case['name']}: feature-major block "
                                 "maxima differ from token-major ones")
        if not torch.equal(blk_again, blk):
            raise AssertionError(f"{case['name']}: block_max_scores: two "
                                 "calls differ")
        ties = near_tie_rows(blk_p, kb)
        sel = topk_lower_index(blk_p, kb)[1]
        diff = (topk_lower_index(blk, kb)[1] != sel).any(-1)
        if (diff & ~ties).any():
            raise AssertionError(f"{case['name']}: selections differ in "
                                 f"{int((diff & ~ties).sum())} rows with no "
                                 "near-tie")
        att_kw = dict(block_size=bs, scale=kw["scale"])
        kTv = kT.transpose(1, 2)                     # K̂ᵀ read in place
        plans = head_plans(case, kT, sel)
        att = GA.block_sparse_attention(q, k, v, sel, cur, **att_kw)
        att_fm = GA.block_sparse_attention(q, kTv, v, sel, cur, **att_kw)
        want = GA.block_sparse_attention_plain(q, k, v, sel, cur, **att_kw)
        clus = GA.head_cluster_plain(q, k, v, sel, cur, **att_kw,
                                     n_cta=plans["token-major"]["C"])
        clus_fm = GA.head_cluster_plain(q, kTv, v, sel, cur, **att_kw,
                                        n_cta=plans["feature-major"]["C"])
        pipe = ops.loki_decode_attention(q, k, v, cur, d=d, k_blocks=kb,
                                         block_size=bs)
        pipe_fm = ops.loki_decode_attention_fm(q, kT, v, cur, d=d,
                                               k_blocks=kb, block_size=bs)
        again = GA.block_sparse_attention(q, k, v, sel, cur, **att_kw)
        again_fm = GA.block_sparse_attention(q, kTv, v, sel, cur, **att_kw)
        sync()
        if DEV == "cuda":
            # one body, one summation order for both K̂ layouts
            for what, a, b in (("fm vs token-major", att_fm, att),
                               ("two calls", again, att),
                               ("two calls (fm)", again_fm, att_fm)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{case['name']}: "
                                         f"block_sparse_attention {what} "
                                         "differ")
        atol, rtol = tolerance(q.dtype)
        rows = ~ties
        # the fm pipeline reads the selected blocks through K̂ᵀ's strides
        for what, got, ref in (("block_sparse_attention", att, want),
                               ("block_sparse_attention (cluster)", att,
                                clus),
                               ("block_sparse_attention fm (cluster)",
                                att_fm, clus_fm),
                               ("loki_decode_attention", pipe[rows],
                                want[rows]),
                               ("loki_decode_attention_fm", pipe_fm, pipe)):
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{case['name']}: {what} non-finite")
            torch.testing.assert_close(
                got.float(), ref.float(), atol=atol, rtol=rtol,
                msg=lambda m: f"{case['name']}: {what}: {m}")
        errs["block_sparse_attention"] = max(
            float((got.float() - ref.float()).abs().max())
            for got, ref in ((att, want), (att, clus), (att_fm, clus_fm)))
        live_blocks = (cur.long() + bs - 1) // bs
        log(f"kernels: {case['name']}: block maxima max|err| "
            f"{errs['block_max_scores']:.3e} (fm "
            f"{errs['block_max_scores_fm']:.3e}, fm == token-major and two "
            f"token-major calls bit for bit), dead blocks "
            f"{int(dead.sum())}; fm launch: 16-byte pieces {fm['vec']}, "
            f"{fm['smem']} B shared (= tuning), {fm['registers']} "
            f"registers, {fm['local_bytes']} B local, {fm['ctas_per_sm']} "
            f"CTAs per SM; selections equal in {int((~diff).sum())}/"
            f"{diff.numel()} rows (near-ties {int(ties.sum())}, rows choosing "
            f"dead blocks {int((live_blocks < kb).sum())}); "
            f"block_sparse_attention max|err| "
            f"{errs['block_sparse_attention']:.3e} (also vs its plain "
            f"cluster form, token-major and fm; fm == token-major and two "
            f"calls bit for bit), pipelines fm == token-major "
            f"{bool(torch.equal(pipe_fm, pipe))} (atol {atol}, rtol {rtol}); "
            f"clusters: " + ", ".join(
                f"{n} C {p['C']}, {p['smem']} B shared, "
                f"{p['max_clusters']} resident" for n, p in plans.items()))
        if "head_main" not in results:
            results["head_main"] = dict(case=case, kT=kT, sel=sel,
                                        plans=plans)
            results.setdefault("errs", {}).update(errs)
        del kT


def flash_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, BH, Sq, Sk, D, dtype, causal): the prefill shape first
    return [("llama2-7b prefill, causal", 32, 3072, 3072, 128, bf16, True),
            ("llama2-7b prefill, non-causal", 32, 3072, 3072, 128, bf16,
             False),
            ("Sq 1024 < Sk 3072, causal", 8, 1024, 3072, 128, bf16, True),
            ("Sq 1024 < Sk 3072, non-causal", 8, 1024, 3072, 128, bf16,
             False),
            ("Sq 3072 > Sk 1024, causal", 8, 3072, 1024, 128, bf16, True),
            ("Sq 3072 > Sk 1024, non-causal", 8, 3072, 1024, 128, f32,
             False),
            ("head_dim 64, fp32", 8, 1024, 1024, 64, f32, True),
            ("head_dim 64, bf16", 8, 1024, 1024, 64, bf16, True),
            ("head_dim 256, fp32", 8, 1024, 1024, 256, f32, True),
            ("head_dim 256, bf16", 8, 1024, 1024, 256, bf16, False)]


def make_flash(bh, sq, sk, dim, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    f = dict(device=DEV, generator=gen)
    return (torch.randn((bh, sq, dim), **f).to(dtype),
            torch.randn((bh, sk, dim), **f).to(dtype),
            torch.randn((bh, sk, dim), **f).to(dtype))


# Absolute slack of the bf16 check: two float32 orders of the same sums
# differ by ~1e-6 absolute, more than one bf16 ulp of an output near zero.
BF16_ATOL = 1e-5
# The bf16 tensor-core flash body rounds P to bf16 before P·V, which the
# float32 plain version does not: each weight p moves by at most 2**-8 p,
# so an output moves by at most 2**-8 (P|V|)/l. FLASH_BF16_BOUND is twice
# that, plus one bf16 ulp of the output (both round a float32 value to
# bf16) and BF16_ATOL.
FLASH_BF16_BOUND = "ulp(out) + 2**-7 (P|V|)/l + BF16_ATOL"
# The per-element bound is loose on long causal rows, where (P|V|)/l is
# about 0.2 of a typical output, so the bf16 cases also hold the whole
# output's rel-L2 to the plain version under this limit: twice the largest
# reading on an H100 (2.1e-3 to 2.5e-3 over the seven bf16 cases, 1.1e-3
# on the prefill-flash path; PERF.md §6).
FLASH_BF16_REL_L2 = 5e-3


def check_flash_close(got, q, k, v, causal, what):
    """flash_attention's output against the plain version: bf16 within
    FLASH_BF16_BOUND per element, with (P|V|)/l from the plain version's
    float32 softmax, and within FLASH_BF16_REL_L2 in rel-L2; float32
    within ``tolerance``. Returns (max |err|,
    rel-L2, largest err / bound or None)."""
    from repro_torch.kernels import flash_attention as FA
    scale = q.shape[-1] ** -0.5
    want = FA.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    rel = float((g - w).norm() / w.norm().clamp(min=1e-30))
    if got.dtype != torch.bfloat16:
        atol, rtol = tolerance(got.dtype)
        torch.testing.assert_close(g, w, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{what}: {m}")
        return float(err.max()), rel, None
    s_ = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s_ = torch.where(mask[None], s_, NEG_INF)
    pv = torch.einsum("bqk,bkd->bqd", torch.softmax(s_, dim=-1),
                      v.float().abs())
    del s_
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bound = ulp + 2.0 ** -7 * pv + BF16_ATOL
    bad = err > bound
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond "
                             f"{FLASH_BF16_BOUND} (max |err| "
                             f"{float(err.max()):.3e}, rel-L2 {rel:.3e})")
    if rel > FLASH_BF16_REL_L2:
        raise AssertionError(f"{what}: rel-L2 {rel:.3e} beyond "
                             f"{FLASH_BF16_REL_L2:.0e}")
    return float(err.max()), rel, float((err / bound).max())


def check_flash(results):
    """flash_attention against its plain version on every flash case: the
    bf16 cases (tensor-core body) within FLASH_BF16_BOUND, the fp32 ones
    (float32 body) within ``tolerance``."""
    from repro_torch.kernels import flash_attention as FA
    for i, (name, bh, sq, sk, dim, dtype, causal) in enumerate(flash_cases()):
        q, k, v = make_flash(bh, sq, sk, dim, dtype, seed=31 + i)
        got = FA.flash_attention(q, k, v, causal=causal)
        sync()
        err, rel, ratio = check_flash_close(got, q, k, v, causal,
                                            f"flash {name}")
        log(f"kernels: flash_attention {name} (BH {bh}, {sq} x {sk}, D "
            f"{dim}, {str(dtype)[6:]}, "
            f"{'tensor-core' if dtype == torch.bfloat16 else 'float32'} "
            f"body): max|err| {err:.3e}, rel-L2 {rel:.3e}"
            + (f", largest err / bound {ratio:.3f} ({FLASH_BF16_BOUND})"
               if ratio is not None else " (tolerance)"))
        if i == 0:
            results["flash_main"] = (q, k, v)
            results.setdefault("errs", {})["flash_attention"] = err
        del got


def check_head_raises():
    """CUDA shapes the per-head kernels and flash do not take raise: the
    contract's (fm d = 12, flash Sq = 3000, S % bs != 0) with ValueError,
    and a width the launcher refuses (D = 512) with its error code."""
    from repro_torch.kernels import approx_scores as AS
    from repro_torch.kernels import approx_scores_fm as ASF
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gather_attention as GA

    gen = torch.Generator(device=DEV).manual_seed(26)
    f = dict(device=DEV, generator=gen)
    q, k = torch.randn((2, 128), **f), torch.randn((2, 1000, 128), **f)
    cur = torch.tensor([900, 300], dtype=torch.int32, device=DEV)
    kT = torch.randn((2, 128, 1024), **f)
    fq, fk = torch.randn((2, 3000, 128), **f), torch.randn((2, 3072, 128), **f)
    wide = torch.randn((1, 128, 512), **f)
    calls = {
        "block_max_scores_fm, d = 12": (ValueError, lambda:
            ASF.block_max_scores_fm(q, kT, cur, d=12)),
        "flash_attention, Sq = 3000": (ValueError, lambda:
            FA.flash_attention(fq, fk, fk)),
        "block_max_scores, S = 1000 % 128": (ValueError, lambda:
            AS.block_max_scores(q, k, cur, d=32)),
        "block_sparse_attention, S = 1000 % 128": (ValueError, lambda:
            GA.block_sparse_attention(q, k, k, torch.zeros(
                (2, 1), dtype=torch.int32, device=DEV), cur)),
        "flash_attention, D = 512 (launcher)": (RuntimeError, lambda:
            FA.flash_attention(wide, wide, wide)),
    }
    for what, (err, call) in calls.items():
        try:
            call()
        except err as e:
            log(f"kernels: raises on the card ({what}): {e}")
            continue
        raise AssertionError(f"a CUDA call outside the contract did not "
                             f"raise {err.__name__} ({what})")


def head_bounds(case, sel):
    """bound_ms of the per-head kernels at ``case`` for this run's data:
    bytes (each input read once, each output written once) over 3.35
    TB/s against float32 operations over 67 TFLOP/s."""
    q, k, cur = case["q"], case["k"], case["cur"].long()
    bh, dim = q.shape
    bs, d = case["bs"], case["d"]
    nb = k.shape[1] // bs
    ksz, qsz = k.element_size(), q.element_size()
    live = int(cur.clamp(max=k.shape[1]).sum())
    pos = sel.long()[..., None] * bs + torch.arange(bs, device=sel.device)
    won = int((pos < cur[:, None, None]).sum())
    meta = 4 * bh                                       # cur_len

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
        return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"

    scores = bound(live * d * ksz + bh * d * qsz + bh * nb * 4 + meta,
                   2 * live * d)
    return {"block_max_scores": scores, "block_max_scores_fm": scores,
            "block_sparse_attention": bound(
                won * 2 * dim * ksz + bh * dim * qsz + sel.numel() * 4
                + meta + bh * dim * qsz, 4 * won * dim)}


def flash_bound(q, k, causal):
    """bound_ms of flash_attention: bytes over 3.35 TB/s against the
    operations of the live (query, key) pairs over the tensor-core peak
    of the inputs' type (bf16 989 TFLOP/s; float32 67 TFLOP/s)."""
    bh, sq, dim = q.shape
    sk = k.shape[1]
    n = min(sq, sk)
    pairs = n * (n + 1) // 2 + max(0, sq - sk) * sk if causal else sq * sk
    ops = 4 * bh * dim * pairs
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * \
        k.element_size()
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    tb, to = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def time_head_kernels(results):
    """The four kernels of this path, their plain versions and, for
    flash and block_sparse_attention, scaled_dot_product_attention (the
    same function, timed here only), at the main per-head and prefill
    shapes; block_sparse_attention also over the feature-major K̂ᵀ."""
    from repro_torch.kernels import approx_scores as AS
    from repro_torch.kernels import approx_scores_fm as ASF
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gather_attention as GA

    main = results.pop("head_main")
    case, kT, sel = main["case"], main["kT"], main["sel"]
    q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
    kw = dict(d=case["d"], block_size=case["bs"], scale=q.shape[-1] ** -0.5)
    att_kw = dict(block_size=case["bs"], scale=kw["scale"])
    runs = {
        "block_max_scores": (lambda: AS.block_max_scores(q, k, cur, **kw),
                             lambda: AS.block_max_scores_plain(q, k, cur,
                                                               **kw)),
        "block_max_scores_fm": (
            lambda: ASF.block_max_scores_fm(q, kT, cur, **kw),
            lambda: ASF.block_max_scores_fm_plain(q, kT, cur, **kw)),
        "block_sparse_attention": (
            lambda: GA.block_sparse_attention(q, k, v, sel, cur, **att_kw),
            lambda: GA.block_sparse_attention_plain(q, k, v, sel, cur,
                                                    **att_kw)),
    }
    bnd = head_bounds(case, sel)
    # block_sparse_attention's function as one library call: SDPA over the
    # rows under a boolean mask of the selected blocks' live tokens, built
    # (with the views) outside the timed window
    hq, hk, hv = q[None, :, None].to(k.dtype), k[None], v[None]
    hmask = selected_tokens(sel, cur, case["bs"], k.shape[1])[None, :, None]
    head_sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        hq, hk, hv, attn_mask=hmask, scale=kw["scale"])
    lib = {"block_sparse_attention": time_ms(head_sdpa)}
    head_sdpa_err = float((head_sdpa()[0, :, 0].float()
                           - GA.block_sparse_attention(
                               q, k, v, sel, cur, **att_kw).float())
                          .abs().max())
    fm_ms = time_ms(lambda: GA.block_sparse_attention(
        q, kT.transpose(1, 2), v, sel, cur, **att_kw))
    fq, fk, fv = results.pop("flash_main")
    runs["flash_attention"] = (
        lambda: FA.flash_attention(fq, fk, fv, causal=True),
        lambda: FA.flash_attention_plain(fq, fk, fv, causal=True,
                                         scale=fq.shape[-1] ** -0.5))
    bnd["flash_attention"] = flash_bound(fq, fk, True)
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        fq[None], fk[None], fv[None], is_causal=True))
    lib["flash_attention"] = sdpa
    # the float32 body on an fp32 copy of the same shape
    f32 = [x.float() for x in (fq, fk, fv)]
    fp32_body_ms = time_ms(lambda: FA.flash_attention(*f32, causal=True))
    del f32
    timing = results.setdefault("timing", {})
    for name, (kern, plain) in runs.items():
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=5)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[name][0],
                            bound_by=bnd[name][1], library_ms=lib.get(name))
        where = ("llama2-7b prefill (32, 3072, 3072, 128) bf16 causal"
                 if name == "flash_attention" else case["name"])
        log(f"timing: {name} at {where}: {ms:.4f} ms, bound "
            f"{bnd[name][0]:.4f} ms by {bnd[name][1]}, plain "
            f"{plain_ms:.4f} ms"
            + (f", scaled_dot_product_attention {lib[name]:.4f} ms"
               if name in lib else ""))
    att = timing["block_sparse_attention"]
    att["fm_ms"] = fm_ms
    results["head_plans"] = main["plans"]
    for lay, plan in main["plans"].items():
        log(f"timing: block_sparse_attention ({lay} K̂) launches clusters "
            f"of C = {plan['C']} CTAs ({q.shape[0] * plan['C']} CTAs of 128 "
            f"threads), {plan['smem']} B dynamic shared memory each, "
            f"cudaOccupancyMaxActiveClusters {plan['max_clusters']}")
    log(f"timing: block_sparse_attention over the feature-major K̂ᵀ: "
        f"{fm_ms:.4f} ms against {att['ms']:.4f} ms token-major "
        f"({fm_ms / att['ms']:.2f}x; bound {att['bound_ms']:.4f} ms); SDPA "
        f"under the selected tokens' mask max |d| to the kernel "
        f"{head_sdpa_err:.3e}")
    timing["flash_attention"]["fp32_body_ms"] = fp32_body_ms
    log(f"timing: flash_attention's float32 body on an fp32 copy of the "
        f"prefill shape: {fp32_body_ms:.4f} ms; tensor-core body "
        f"{timing['flash_attention']['ms']:.4f} ms = "
        f"{fp32_body_ms / timing['flash_attention']['ms']:.1f}x faster, "
        f"{timing['flash_attention']['ms'] / sdpa:.2f}x SDPA")


# -------------------------------------------------------------------- serve

# Prompt lengths of the dense engine's loki_block path and decode step.
LENGTHS = (1500, 2000, 2500, 3000)
# Prompt lengths of the paged path (and of the dense runs that give its
# greedy reference). Each prompt's 16 decode positions cross a 128-token
# page boundary, so the paged engine's oldest requests grow by a page
# while decoding and, in a tight pool, preempt the youngest; LENGTHS never
# cross one in 16 steps, and FIFO then never preempts.
PAGED_LENGTHS = (1530, 2040, 2550, 3060)
MAX_NEW = 16


def prompts(vocab: int, lengths, seed: int):
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=vocab, seq_len=max(lengths),
                                  global_batch=len(lengths), seed=seed,
                                  n_states=32, temperature=0.22))
    toks = data.batch_at(0)["tokens"]
    return [toks[i, :n] for i, n in enumerate(lengths)]


def policy_cfg(cfg, policy):
    """``cfg`` (loki_block, k_f = d_f = 0.25) under another policy, with
    the same block size and k_f."""
    return cfg if policy == "loki_block" else cfg.with_policy(policy)


def planned_kernels(cfg, smax: int, policy: str):
    """The kernels the planner picks for one decode step of ``policy`` at
    the config's page layout (its key width and storage type; the dense
    engine's caches and the default layout are float32)."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import tuning
    from repro_torch.serving import paged_cache as PC
    hd = cfg.resolved_head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    bs = cfg.loki.block_size
    kd = cfg.page_layout.k_width(hd)
    st = str(PC.STORAGE_DTYPE[cfg.page_layout.dtype]).removeprefix("torch.")
    if policy == "full":
        plan = tuning.plan_full_decode(smax, hd, g, kd, bs, storage=st)
        return plan, ("paged_full_decode",)
    if policy == "exact_topk":
        plan = tuning.plan_decode(smax, hd, g, kd, bs, storage=st)
        fused = "fused_exact_topk_decode"
    else:
        plan, _ = dispatch.decode_plan(cfg.loki, smax, hd, g, kd, st)
        fused = "fused_loki_decode"
    if plan is None:
        raise AssertionError(f"no kernel plan for {policy} at smax {smax}")
    return plan, ((fused,) if plan.variant == "fused" else
                  ("select_blocks", "block_sparse_attention_grouped"))


def check_launches(path, counts, planned, steps, n_layers):
    want = {n: steps * n_layers if n in planned else 0 for n in counts}
    if counts != want:
        raise AssertionError(f"{path} launches {counts}, expected {want} "
                             f"({steps} decode steps x {n_layers} layers "
                             f"of {planned})")


def serve(results, *, smoke=False, smax=4096, lengths=LENGTHS,
          paged_lengths=PAGED_LENGTHS):
    """The dense engine's path: loki_block at full width, counted on its
    own, the decode-step path and greedy agreement with the plain path;
    then the paged prompts through the dense engine with each of
    loki_block, full and exact_topk (full and exact_topk on the
    contiguous kernels, counted per run), whose greedy tokens the paged
    runs are compared with. ``smoke``/``smax``/``lengths`` shrink it for
    a CPU rehearsal of this script (``DEV = "cpu"``); the run uses
    defaults. Returns (params, cfg, paged prompts, greedy tokens by
    policy) for the paged path."""
    from repro_torch import kernels as K
    from repro_torch.core import dispatch
    from repro_torch.launch.serve import (EngineSection, ServeConfig,
                                          calibrated_params)
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.serving.engine import Request
    from repro_torch.serving.lifecycle import is_terminal

    sc = ServeConfig(engine=EngineSection(
        arch="llama2-7b", smoke=smoke, kind="dense", policy="loki_block",
        backend="auto", n_slots=4, smax=smax), warm_steps=0, device=DEV)
    cfg = sc.resolve_model()
    t0 = time.perf_counter()
    calib_data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=96,
                                        global_batch=8, seed=7, n_states=32,
                                        temperature=0.22))
    params = calibrated_params(cfg, calib_data, seed=0, device=DEV)
    sync()
    log(f"serve: {cfg.arch}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype} weights; init + PCA calibration "
        f"{time.perf_counter() - t0:.1f} s")
    lengths = list(lengths)
    toks = prompts(cfg.vocab, lengths, seed=11)
    plan, planned = planned_kernels(cfg, sc.engine.smax, "loki_block")
    log(f"serve: planner picked {plan} at smax {sc.engine.smax}")

    def run_engine(backend, policy="loki_block", toks=toks):
        eng = ServeConfig(engine=dataclasses.replace(sc.engine,
                                                     backend=backend),
                          device=DEV).build_engine(
                              params, policy_cfg(cfg, policy))
        reqs = [Request(rid=i, prompt=t, max_new=MAX_NEW)
                for i, t in enumerate(toks)]
        for r in reqs:
            eng.submit(r)
        tick_ms = []
        t_all = time.perf_counter()
        while not all(is_terminal(r) for r in reqs):
            if len(tick_ms) > 100:
                raise AssertionError("serving did not finish in 100 ticks")
            t_tick = time.perf_counter()
            eng.tick()
            sync()
            tick_ms.append(1e3 * (time.perf_counter() - t_tick))
        bad = [r.rid for r in reqs if str(r.status) != "done"]
        if bad:
            raise AssertionError(f"{policy} requests not DONE: {bad}")
        ticks = eng.ticks
        del eng
        if DEV == "cuda":
            torch.cuda.empty_cache()
        return ticks, reqs, tick_ms, time.perf_counter() - t_all

    # ---- the dense path: counts set to 0 just before, read just after
    K.reset_launch_counts()
    ticks, reqs, tick_ms, wall = run_engine("auto")
    counts = K.launch_counts()
    # ---- end of the dense path
    for be in ("pallas", "xla"):
        if dispatch.backend_disabled(be):
            raise AssertionError(f"backend {be} disabled: "
                                 f"{dispatch.backend_disabled(be)}")
    toks_out = sum(len(r.out) for r in reqs)
    decode_ms = statistics.median(tick_ms[1:])
    log(f"serve: {len(reqs)} requests, prompts {lengths}, {toks_out} tokens "
        f"in {ticks} ticks, {wall:.2f} s incl. prefill -> "
        f"{toks_out / wall:.1f} tok/s; first tick (4 prefills + decode) "
        f"{tick_ms[0]:.1f} ms, decode tick median {decode_ms:.2f} ms -> "
        f"{4e3 / decode_ms:.1f} tok/s at 4 slots")
    log(f"serve: dense-path launches {counts}")
    check_launches("dense path", counts, planned, ticks, cfg.n_layers)
    launches = {"dense": counts}

    step = decode_step_check(params, cfg, toks, sc.engine.smax)
    results["profile"] = profile_decode(params, cfg, toks, sc.engine.smax)

    # greedy agreement with the plain per-head path over the same run
    _, reqs_x, _, _ = run_engine("xla")
    same = sum(a == b for r, rx in zip(reqs, reqs_x)
               for a, b in zip(r.out, rx.out))
    log(f"serve: greedy tokens equal to backend=xla in {same}/{toks_out} "
        "(reported, not asserted)")
    launches["decode_step"] = step.pop("launches")
    launches.update(step["per_head"].pop("launches"))

    # the paged path's greedy reference, one dense run per policy
    paged_toks = prompts(cfg.vocab, list(paged_lengths), seed=11)
    greedy = {}
    for policy in ("loki_block", "full", "exact_topk"):
        _, p_planned = planned_kernels(policy_cfg(cfg, policy),
                                       sc.engine.smax, policy)
        K.reset_launch_counts()
        p_ticks, p_reqs, p_ms, _ = run_engine("auto", policy, paged_toks)
        p_counts = K.launch_counts()
        check_launches(f"dense {policy}", p_counts, p_planned, p_ticks,
                       cfg.n_layers)
        launches[f"dense_{policy}"] = p_counts
        greedy[policy] = [r.out for r in p_reqs]
        log(f"serve: dense engine, {policy}, prompts {list(paged_lengths)}: "
            f"{p_ticks} ticks, decode tick median "
            f"{statistics.median(p_ms[1:]):.2f} ms, launches {p_counts}")
    results["launches"] = launches
    results["serve"] = dict(ticks=ticks, decode_tick_ms=decode_ms,
                            tok_per_s=toks_out / wall, **step)
    serve_baselines(results, params, cfg, paged_toks, greedy["full"],
                    smax=sc.engine.smax)
    return params, cfg, paged_toks, greedy


#: the paper's comparison baselines and chunked Loki through the dense
#: engine: (path, policy, extra LokiConfig fields)
BASELINE_RUNS = (("dense_pcaattn", "pcaattn", {}), ("dense_h2o", "h2o", {}),
                 ("dense_loki_chunked", "loki", dict(n_chunks=4)))


def serve_baselines(results, params, cfg, toks, ref, *, smax, n_slots=4):
    """``BASELINE_RUNS`` through the dense engine, each counted on its
    own: every request DONE, no decode kernel launched (the three are
    plain torch, as they are jnp in the JAX package), one host sync in a
    decode tick (asserted); the decode tick's median and greedy agreement
    with the dense ``full`` run (``ref``, reported)."""
    from repro_torch import kernels as K
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.lifecycle import is_terminal
    out = results.setdefault("baselines", {})
    for path, policy, extra in BASELINE_RUNS:
        bcfg = cfg.with_policy(policy, **extra)
        eng = ServingEngine(params, bcfg, n_slots=n_slots, smax=smax,
                            device=DEV)
        reqs = [Request(rid=i, prompt=t, max_new=MAX_NEW)
                for i, t in enumerate(toks)]
        for r in reqs:
            eng.submit(r)
        # ---- the path: counts set to 0 just before, read just after
        K.reset_launch_counts()
        tick_ms, syncs = [], None
        t_all = time.perf_counter()
        while not all(is_terminal(r) for r in reqs):
            if eng.ticks > 100:
                raise AssertionError(f"{path} did not finish in 100 ticks")
            if eng.ticks == 1 and syncs is None:
                syncs = sync_count(eng.tick)
                continue
            t_tick = time.perf_counter()
            eng.tick()
            sync()
            tick_ms.append(1e3 * (time.perf_counter() - t_tick))
        wall = time.perf_counter() - t_all
        counts = K.launch_counts()
        # ---- end of the path
        del eng
        if DEV == "cuda":
            torch.cuda.empty_cache()
        results.setdefault("launches", {})[path] = counts
        bad = [r.rid for r in reqs if str(r.status) != "done"]
        if bad:
            raise AssertionError(f"{path}: requests not DONE: {bad}")
        if any(counts.values()):
            raise AssertionError(f"{path}: decode kernels launched "
                                 f"{counts}; {policy} is plain torch")
        if DEV == "cuda" and syncs != 1:
            raise AssertionError(f"{path}: {syncs} host syncs in a decode "
                                 "tick, expected 1")
        n_out = sum(len(r.out) for r in reqs)
        same = sum(a == b for r, w in zip(reqs, ref)
                   for a, b in zip(r.out, w))
        decode_ms = statistics.median(tick_ms[1:])
        out[path] = dict(policy=policy, **extra, ticks=len(tick_ms) + 1,
                         first_tick_ms=tick_ms[0],
                         decode_tick_ms=decode_ms,
                         tok_per_s=n_out / wall, host_syncs_decode=syncs,
                         greedy_equal_full=same, tokens=n_out)
        log(f"baselines: {path} ({policy}{', ' if extra else ''}"
            + ", ".join(f"{k}={v}" for k, v in extra.items())
            + f"): {len(tick_ms) + 1} ticks, first tick (4 prefills + "
            f"decode) {tick_ms[0]:.1f} ms, decode tick median "
            f"{decode_ms:.2f} ms -> {1e3 * n_slots / decode_ms:.1f} tok/s at "
            f"{n_slots} slots; {n_out} tokens in {wall:.2f} s; host syncs "
            f"in a decode tick {syncs}; decode kernel launches {counts}; "
            f"greedy tokens equal to the dense full run's in "
            f"{same}/{n_out} (reported, not asserted)")


def tight_pool(lengths, page_size: int, chunk: int) -> int:
    """Pages (with the trash page) that hold the three oldest prompts and
    the youngest one's first chunk: the oldest then preempt the youngest
    when their decode crosses into a new page."""
    return 1 + sum(-(-(n - 1) // page_size) for n in lengths[:-1]) \
        + -(-chunk // page_size)


def sync_count(fn) -> int:
    """Calls in ``fn`` that made the host wait for the card, counted by
    PyTorch's sync debug mode (CUDA only; 0 on the CPU)."""
    import warnings
    if DEV != "cuda":
        fn()
        return 0
    # switched on outside the record: the first switch warns once itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def idle_share(busy_ms, total_ms):
    """1 - busy/total, at least 0; nan where either was not measured (a
    run that profiled no such tick)."""
    if math.isnan(busy_ms) or math.isnan(total_ms):
        return float("nan")
    return max(0.0, 1 - busy_ms / total_ms)


def device_busy_ms(fn, steps: int, copies=None) -> float:
    """Device time per call of ``fn`` over ``steps`` calls, by
    torch.profiler (kernels and copies only). ``copies``: a dict that
    receives the ms per call of host-to-device and device-to-host copies
    ("h2d", "d2h"), part of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(steps):
            fn()
        sync()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and e.device_type != DeviceType.CPU]
    if copies is not None:
        for key, tag in (("h2d", "Memcpy HtoD"), ("d2h", "Memcpy DtoH")):
            copies[key] = sum(dev_us(e) for e in events
                              if tag in e.key) / steps / 1e3
    return sum(dev_us(e) for e in events) / steps / 1e3


#: the paged runs: (page layout, policy); "" is the default fp32 native
#: layout, the main path's. Each runs at the engine's defaults: prefix
#: cache on (distinct prompts: hits only where a preempted request comes
#: back to its own cached pages) and gather-packed decode
PAGED_RUNS = (("", "loki_block"), ("", "full"), ("", "exact_topk"),
              ("int8:pca:r=32", "loki_block"), ("int8:pca:r=32", "full"),
              ("int8:pca:r=32", "exact_topk"), ("fp8", "loki_block"),
              ("bf16", "loki_block"))
#: the shared-system-prompt runs (layout, policy): a PREFIX_LEN-token
#: prefix (16 full pages and 52 tokens into the 17th) before four distinct
#: SUFFIX_LEN-token suffixes, in PREFIX_POOL pages
PREFIX_RUNS = (("", "loki_block"), ("int8:pca:r=32", "loki_block"))
#: Fault 2's runs (layout, policy, packed), each beside a packed run of
#: PAGED_RUNS or of this list: the masked side (packed decode off) of
#: full and exact_topk at both layouts and of loki_block at int8, and
#: loki_block packed at both layouts in a pool of every slot at its page
#: bound (PAGED_RUNS' loki_block preempts in its tight pool). The fp32
#: loki_block masked side is the tiered phase's paged_loki_block_masked.
FAULT2_LAYOUTS = ("", "int8:pca:r=32")
FAULT2_RUNS = (("", "full", False), ("", "exact_topk", False),
               ("", "loki_block", True), ("int8:pca:r=32", "full", False),
               ("int8:pca:r=32", "exact_topk", False),
               ("int8:pca:r=32", "loki_block", True),
               ("int8:pca:r=32", "loki_block", False))
PREFIX_LEN, SUFFIX_LEN, PREFIX_POOL = 2100, 300, 40


def fault2_pair(layout: str, policy: str):
    """(packed path, masked path) of Fault 2's comparison."""
    base = paged_path(layout, policy)
    return (base + "_packed" if policy == "loki_block" else base,
            base + "_masked")


def paged_path(layout: str, policy: str) -> str:
    """A paged run's path name: paged_<policy> at the default layout,
    paged_<storage>[pca]_<policy> at another (int8:pca:r=32 ->
    paged_int8pca_loki_block)."""
    if not layout:
        return f"paged_{policy}"
    tag = layout.split(":")[0] + ("pca" if ":pca" in layout else "")
    return f"paged_{tag}_{policy}"


def packed_rows(n_live: int, n_slots: int) -> int:
    """Rows of a decode step over ``n_live`` selected slots, as the
    engine's ``_packed_order`` picks them: the power-of-two bucket, or
    all ``n_slots`` (masked) when the bucket is not narrower."""
    bucket = 1 << max(n_live - 1, 0).bit_length()
    return bucket if bucket < n_slots else n_slots


def drive_paged(path, eng, reqs, *, hold_first=False, max_ticks=400,
                profiled=2):
    """Serve ``reqs`` through a paged engine as one path, counted on its
    own. ``hold_first``: request 0 is submitted alone and the others once
    it reaches DECODE (its prompt pages registered). Decode-only ticks are
    timed by their step's rows (host clock around tick() and a
    synchronise), but up to ``profiled`` of each width are profiled
    (device busy; on a tiered engine also the copies each way and the
    bytes the tick moved), the first full-width one first (a tight pool
    leaves few); host syncs are counted in the first decode-only tick
    after it, the first decode-only packed tick and the first prefill
    tick, beside the syncs the engine counted there (its decode runs'
    and demotions'). Returns the measurements, the launch counts and the
    engine's stats."""
    from repro_torch import kernels as K
    from repro_torch.serving.lifecycle import Status, is_terminal
    pending = list(reqs[1:]) if hold_first else []
    for r in reqs[:1] if hold_first else reqs:
        eng.submit(r)
    n = eng.n_slots
    tick_ms, busy, syncs, counted, copies = {}, {}, {}, {}, []

    def engine_syncs():
        return eng.n_host_syncs + eng.n_demote_syncs

    def moved():
        return eng.n_h2d_bytes, eng.n_d2h_bytes

    def busy_tick(rows):
        got, before = {}, moved()
        busy.setdefault(rows, []).append(device_busy_ms(eng.tick, 1, got))
        if eng.tiered:
            after = moved()
            copies.append(dict(got, h2d_bytes=after[0] - before[0],
                               d2h_bytes=after[1] - before[1]))

    def sync_tick(what):
        before = engine_syncs()
        syncs[what] = sync_count(eng.tick)
        counted[what] = engine_syncs() - before

    # ---- the path: counts set to 0 just before, read just after
    K.reset_launch_counts()
    t_all = time.perf_counter()
    while not all(is_terminal(r) for r in reqs):
        if eng.ticks > max_ticks:
            raise AssertionError(f"{path} did not finish in {max_ticks} "
                                 "ticks")
        if pending and reqs[0].status in (Status.DECODE, Status.DONE):
            for r in pending:
                eng.submit(r)
            pending = []
        chunks, steps = eng.n_prefill_chunks, eng.n_decode_steps
        decode_only = not eng._queue and not eng._prefill_at
        rows = packed_rows(int(eng.live.sum()), n) if eng.packed else n
        if decode_only and rows == n and n not in busy:
            busy_tick(n)
        elif decode_only and "decode" not in syncs:
            sync_tick("decode")
        elif decode_only and rows < n and "packed" not in syncs:
            sync_tick("packed")
        elif chunks and not decode_only and "prefill" not in syncs:
            sync_tick("prefill")
        elif decode_only and len(busy.get(rows, ())) < profiled:
            busy_tick(rows)
        else:
            t_tick = time.perf_counter()
            eng.tick()
            sync()
            if eng.n_prefill_chunks == chunks \
                    and eng.n_decode_steps > steps:
                tick_ms.setdefault(rows, []).append(
                    1e3 * (time.perf_counter() - t_tick))
    sync()
    wall = time.perf_counter() - t_all
    counts = K.launch_counts()
    # ---- end of the path
    return dict(counts=counts, syncs=syncs, counted=counted,
                tick_ms=tick_ms, busy=busy, copies=copies, wall=wall,
                stats=eng.stats())


def paged_checked(path, reqs, run, planned, n_layers):
    """A paged run's asserts: every request DONE, the planned kernel on
    every layer of every decode step and no other, one host sync in a
    decode tick, packed ticks included."""
    bad = [r.rid for r in reqs if str(r.status) != "done"]
    if bad:
        raise AssertionError(f"{path}: requests not DONE: {bad}")
    st, syncs = run["stats"], run["syncs"]
    check_launches(path, run["counts"], planned, st["n_decode_steps"],
                   n_layers)
    for what in ("decode", "packed"):
        if syncs.get(what, 1) != 1:
            raise AssertionError(f"{path}: {syncs[what]} host syncs in a "
                                 f"{what} tick, expected 1")
    if "decode" not in syncs:
        raise AssertionError(f"{path}: no decode-only tick")


def paged_report(path, reqs, run, ref, ref_name, n_slots, **extra):
    """One paged run's numbers (and their log lines): ticks, steps,
    packed and masked ticks, rows saved, prefix hits and copies,
    preemptions, whole-run and full-width decode tick times, device busy
    and idle share, packed tick times by rows, host syncs, launches, and
    greedy agreement with ``ref`` (reported, not asserted; None: no
    reference). Device busy and idle share by step rows too (a width's
    idle share against its own tick median)."""
    st, pk = run["stats"], run["stats"]["packed"]
    toks_out = sum(len(r.out) for r in reqs)
    same = None if ref is None else sum(
        a == b for r, want in zip(reqs, ref) for a, b in zip(r.out, want))
    ms = run["tick_ms"]
    by_rows = {r: statistics.median(v) for r, v in sorted(ms.items())}
    busy_rows = {r: statistics.median(v)
                 for r, v in sorted(run["busy"].items())}
    idle_rows = {r: idle_share(b, by_rows[r])
                 for r, b in busy_rows.items() if r in by_rows}
    tick = by_rows.get(n_slots, float("nan"))
    busy = busy_rows.get(n_slots, float("nan"))
    wall = run["wall"]
    out = dict(
        layout=st["layout"], ticks=st["ticks"],
        decode_steps=st["n_decode_steps"],
        prefill_chunks=st["n_prefill_chunks"],
        n_packed_ticks=pk["n_packed_ticks"],
        n_masked_ticks=pk["n_masked_ticks"],
        packed_rows_saved=pk["n_rows_saved"],
        prefix_hit_rate=st["prefix_hit_rate"],
        n_prefix_hit_tokens=st["n_prefix_hit_tokens"],
        n_cow_copies=st["n_cow_copies"], n_preempted=st["n_preempted"],
        wall_s=wall, tok_per_s=toks_out / wall, decode_tick_ms=tick,
        decode_tok_per_s=1e3 * n_slots / tick, device_busy_ms=busy,
        idle_share=idle_share(busy, tick),
        decode_tick_ms_by_rows=by_rows, device_busy_ms_by_rows=busy_rows,
        idle_share_by_rows=idle_rows,
        host_syncs_per_tick=run["syncs"], launches=run["counts"],
        greedy_equal_reference=same, greedy_reference=ref_name,
        tokens=toks_out, **extra)
    log(f"paged: {path} ({st['layout']}): {st['ticks']} ticks "
        f"({st['n_decode_steps']} decode steps: {pk['n_packed_ticks']} "
        f"packed, {pk['n_masked_ticks']} full width, "
        f"{pk['n_rows_saved']} rows saved; {st['n_prefill_chunks']} "
        f"prefill chunks), preempted {st['n_preempted']}, prefix hits "
        f"{st['n_prefix_hit_tokens']} tokens (hit rate "
        f"{st['prefix_hit_rate']:.3f}), copy-on-write "
        f"{st['n_cow_copies']}; {toks_out} tokens in {wall:.2f} s -> "
        f"{toks_out / wall:.1f} tok/s; full-width decode tick median "
        f"{tick:.2f} ms -> {1e3 * n_slots / tick:.1f} tok/s at "
        f"{n_slots} slots; decode tick median by rows "
        + ", ".join(f"{r}: {t:.2f} ms" for r, t in by_rows.items())
        + f"; device busy {busy:.2f} ms per full-width decode tick -> idle "
        f"share {out['idle_share']:.3f}; busy (idle share) by rows "
        + ", ".join(f"{r}: {b:.2f} ms ({idle_rows.get(r, float('nan')):.3f})"
                    for r, b in busy_rows.items())
        + f"; host syncs per tick {run['syncs']}")
    log(f"paged: {path}: launches {run['counts']}"
        + (f"; greedy tokens equal to {ref_name}'s in {same}/{toks_out} "
           "(reported, not asserted)" if ref is not None else ""))
    return out


def serve_paged(results, params, cfg, toks, greedy, *, smax=4096,
                page_size=128, chunk=512, runs=PAGED_RUNS,
                prefix_runs=PREFIX_RUNS, fault2_runs=FAULT2_RUNS):
    """The paged path: the paged engine at its defaults (prefix cache,
    packed decode) serves the four prompts at full width, once per
    (layout, policy) of ``runs``, counted on its own each time.
    loki_block runs in a pool too small for all four (``tight_pool``) and
    must preempt. A run at another layout than the default is compared
    with the default layout's run of its policy (greedy tokens, reported)
    and checked by ``layout_step`` (one decode step, kernels against the
    plain path on the same pool). Then ``fault2_runs`` (the sides of
    Fault 2's packed == masked comparisons, ``check_fault2``), and the
    shared-system-prompt runs (``serve_prefix``)."""
    from repro_torch.configs.base import PageLayout
    from repro_torch.serving.engine import Request
    from repro_torch.serving.scheduler import PagedServingEngine

    lengths = [len(t) for t in toks]
    out, outs_fp32, ref_logits = {}, {}, {}

    def run_one(path, pcfg, policy, n_pages, **kw):
        plan, planned = planned_kernels(pcfg, smax, policy)
        eng = PagedServingEngine(params, pcfg, n_slots=4, smax=smax,
                                 page_size=page_size, n_pages=n_pages,
                                 prefill_chunk=chunk, backend="auto",
                                 device=DEV, **kw)
        pool_bytes, page_bytes = eng.pool_bytes, eng.bytes_per_page
        reqs = [Request(rid=i, prompt=t, max_new=MAX_NEW)
                for i, t in enumerate(toks)]
        run = drive_paged(path, eng, reqs)
        del eng
        if DEV == "cuda":
            torch.cuda.empty_cache()
        paged_checked(path, reqs, run, planned, cfg.n_layers)
        results.setdefault("launches", {})[path] = run["counts"]
        results.setdefault("tokens", {})[path] = [r.out for r in reqs]
        return reqs, run, dict(plan=str(plan), policy=policy,
                               n_pages=n_pages or 1 + 4 * (smax // page_size),
                               pool_bytes=pool_bytes,
                               bytes_per_page_layer=page_bytes)

    for layout, policy in runs:
        path = paged_path(layout, policy)
        pcfg = policy_cfg(cfg, policy)
        if layout:
            pcfg = pcfg.with_layout(PageLayout.parse(layout))
        n_pages = (tight_pool(lengths, page_size, chunk)
                   if policy == "loki_block" else None)
        reqs, run, info = run_one(path, pcfg, policy, n_pages)
        if policy == "loki_block" and run["stats"]["n_preempted"] < 1:
            raise AssertionError(f"{path} in a {n_pages}-page pool did not "
                                 "preempt")
        if layout:
            ref, ref_name = outs_fp32[policy], "the fp32 native paged run"
        else:
            ref, ref_name = greedy[policy], "the dense engine"
            outs_fp32[policy] = [r.out for r in reqs]
        out[path] = paged_report(path, reqs, run, ref, ref_name, 4, **info)
        step = layout_step(results, params, pcfg, toks, policy, layout,
                           ref_logits, smax=smax, page_size=page_size,
                           chunk=chunk)
        out[path].update(step)
    # Fault 2's other sides: masked runs and roomy packed loki_block runs
    # (checked by check_fault2 once the tiered phase has run)
    for layout, policy, packed in fault2_runs:
        pair = fault2_pair(layout, policy)
        path = pair[0] if packed else pair[1]
        pcfg = policy_cfg(cfg, policy)
        if layout:
            pcfg = pcfg.with_layout(PageLayout.parse(layout))
        reqs, run, info = run_one(path, pcfg, policy, None, packed=packed)
        ref = outs_fp32.get(policy) if layout else greedy.get(policy)
        out[path] = paged_report(
            path, reqs, run, ref, "the fp32 native paged run" if layout
            else "the dense engine", 4, **info)
    results["paged_serve"] = out
    if prefix_runs:
        serve_prefix(results, params, cfg, smax=smax, page_size=page_size,
                     chunk=chunk, runs=prefix_runs)


#: granite's prompt lengths: each prompt's len - 1 tokens (the dense
#: engine's one-shot prefill, the paged engine's 512-token chunks) are a
#: whole number of 256-token MoE dispatch groups
GRANITE_LENGTHS = (1537, 2049, 2561, 3073)
GRANITE_POLICIES = ("loki_block", "full", "exact_topk")


def serve_granite(results, *, smoke=False, smax=4096, page_size=128,
                  chunk=512, lengths=GRANITE_LENGTHS,
                  policies=GRANITE_POLICIES, fp32_layers=8):
    """granite-moe-3b-a800m at published width (32 layers, d_model 1536,
    24 heads over 8 KV heads, 40 experts top-8; seeded bf16 weights, PCA
    calibrated on synthetic batches): per policy, the dense engine serves
    the four prompts (the greedy reference), then the paged engine at its
    defaults (prefix cache, packed decode; fp32 pool of every slot at its
    page bound, 128-token pages, 512-token chunks), counted on its own
    (``paged_granite_<policy>``) and checked by ``paged_checked``: every
    request DONE, the planned kernel on every layer of every decode step,
    one host sync in a decode tick. Greedy agreement with the dense engine
    is reported: in bf16 the two prefills round apart (the dense one
    attends over bf16 K/V, the chunked one over the fp32 pool), and
    capacity routing turns one flipped expert pick into another drop set
    for the rest of its 256-token group (drops go in token order). Then
    the same pair under loki_block with float32 weights and activations,
    depth cut to ``fp32_layers`` (``paged_granite_fp32_loki_block``): there
    the paged engine's tokens equal the dense engine's, 64 of 64, capacity
    drops included (asserted). ``smoke`` and the sizes shrink it for a CPU
    rehearsal."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch.serve import (EngineSection, ServeConfig,
                                          calibrated_params)
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.scheduler import PagedServingEngine

    sc = ServeConfig(engine=EngineSection(
        arch="granite-moe-3b-a800m", smoke=smoke, kind="paged",
        policy="loki_block", backend="auto", n_slots=4, smax=smax),
        device=DEV)
    cfg = sc.resolve_model()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=96,
                                  global_batch=8, seed=7, n_states=32,
                                  temperature=0.22))
    toks = prompts(cfg.vocab, lengths, seed=13)

    def requests():
        return [Request(rid=i, prompt=t, max_new=MAX_NEW)
                for i, t in enumerate(toks)]

    def pair(path, params, pcfg, policy):
        """The dense engine's greedy tokens, then the paged engine's run
        of ``path``, checked; -> (dense tokens, paged requests, run,
        info)."""
        eng = ServingEngine(params, pcfg, n_slots=4, smax=smax, device=DEV)
        reqs = requests()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done(100)
        dense = [r.out for r in reqs]
        del eng
        if DEV == "cuda":
            torch.cuda.empty_cache()
        if [len(o) for o in dense] != [MAX_NEW] * len(toks):
            raise AssertionError(f"{path}: dense reference {dense}")
        plan, planned = planned_kernels(pcfg, smax, policy)
        eng = PagedServingEngine(params, pcfg, n_slots=4, smax=smax,
                                 page_size=page_size, prefill_chunk=chunk,
                                 backend="auto", device=DEV)
        info = dict(plan=str(plan), policy=policy, dtype=pcfg.dtype,
                    n_layers=pcfg.n_layers, n_pages=eng.pool.n_pages,
                    pool_bytes=eng.pool_bytes)
        reqs = requests()
        run = drive_paged(path, eng, reqs)
        del eng
        if DEV == "cuda":
            torch.cuda.empty_cache()
        paged_checked(path, reqs, run, planned, pcfg.n_layers)
        results.setdefault("launches", {})[path] = run["counts"]
        return dense, reqs, run, info

    t0 = time.perf_counter()
    params = calibrated_params(cfg, data, seed=0, device=DEV)
    sync()
    n_params = sum(t.numel() for t in tensors_of(params))
    log(f"granite: {cfg.arch}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
        f"heads, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
        f"{n_params / 1e9:.2f} B parameters in {cfg.dtype}; init + PCA "
        f"calibration {time.perf_counter() - t0:.1f} s")
    out = {}
    for policy in policies:
        path = f"paged_granite_{policy}"
        dense, reqs, run, info = pair(path, params, policy_cfg(cfg, policy),
                                      policy)
        out[path] = paged_report(path, reqs, run, dense,
                                 "the dense engine", 4, **info)
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    fcfg = cfg.replace(dtype="float32",
                       n_layers=min(fp32_layers, cfg.n_layers))
    path = "paged_granite_fp32_loki_block"
    dense, reqs, run, info = pair(path, calibrated_params(
        fcfg, data, seed=0, device=DEV), fcfg, "loki_block")
    out[path] = paged_report(path, reqs, run, dense, "the dense engine", 4,
                             **info)
    if [r.out for r in reqs] != dense:
        raise AssertionError(f"{path}: paged tokens differ from the dense "
                             f"engine's ({out[path]['greedy_equal_reference']}"
                             f"/{out[path]['tokens']} equal)")
    log(f"granite: {path}: paged == dense, {out[path]['tokens']} of "
        f"{out[path]['tokens']} greedy tokens ({fcfg.n_layers} of "
        f"{cfg.n_layers} layers, float32)")
    results["granite_serve"] = out
    if DEV == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------ window and encoder families

#: whisper-small's prompts (200-400 tokens) in its published 448-token
#: text context; 64-token pages of two 32-token blocks, so loki_block's
#: 3 of 14 blocks are fewer than the 7-13 live ones
WHISPER_LENGTHS = (201, 265, 329, 393)
WHISPER_SMAX, WHISPER_PAGE, WHISPER_BLOCK, WHISPER_CHUNK = 448, 64, 32, 128
#: mixtral's prompts: past the 4096-token window, and each len - 1 a whole
#: number of 256-token MoE dispatch groups (the dense engine's one-shot
#: prefill and the paged engine's 512-token chunks route alike); with
#: 512-token pages and chunks the pages recycle in prefill and in decode
MIXTRAL_LENGTHS = (4609, 5121, 5377, 5889)
MIXTRAL_SMAX, MIXTRAL_PAGE, MIXTRAL_CHUNK = 8192, 512, 512
#: mixtral's depth cut: bf16 runs at MIXTRAL_LAYERS of 56 layers (4.8 GB
#: of bf16 weights a layer), the float32 equality runs at
#: MIXTRAL_FP32_LAYERS
MIXTRAL_LAYERS, MIXTRAL_FP32_LAYERS = 8, 2
LLAVA_PATCH_SEED = 5


def family_requests(toks, frames=None):
    from repro_torch.serving.engine import Request
    return [Request(rid=i, prompt=t, max_new=MAX_NEW,
                    frames=None if frames is None else frames[i])
            for i, t in enumerate(toks)]


def dense_greedy(path, params, cfg, toks, smax, frames=None, n_slots=None):
    """The dense engine's greedy tokens for ``toks`` (the paged runs'
    reference), every request MAX_NEW tokens long, in ``n_slots`` slots
    (default one a prompt: the row count the paged runs plan for)."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(params, cfg, n_slots=n_slots or len(toks),
                        smax=smax, device=DEV)
    reqs = family_requests(toks, frames)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(100)
    del eng
    if DEV == "cuda":
        torch.cuda.empty_cache()
    out = [r.out for r in reqs]
    if [len(o) for o in out] != [MAX_NEW] * len(toks):
        raise AssertionError(f"{path}: dense reference {out}")
    return out


def window_checked(eng):
    """After a tick: every page-table group of every slot within its
    spec-table bound, and a full-attention group holding every page it
    covers (it pins them; only window groups recycle)."""
    for g, w in enumerate(eng.group_windows):
        for slot, pages in enumerate(eng._group_pages(g)):
            held = sum(p is not None for p in pages)
            if held > eng._group_pages_hard[g]:
                raise AssertionError(f"tick {eng.ticks}: slot {slot} group "
                                     f"{g} holds {held} pages, above "
                                     f"{eng._group_pages_hard[g]}")
            if not w and None in pages:
                raise AssertionError(f"tick {eng.ticks}: slot {slot}'s "
                                     f"full-attention group {g} recycled "
                                     "a page")


def paged_run(results, path, params, cfg, policy, toks, *, smax, page_size,
              chunk, frames=None, tick_check=None, profiled=2, **kw):
    """The paged engine at its defaults over ``toks`` as one counted path
    (``drive_paged``), ``tick_check(engine)`` after every tick, checked by
    ``paged_checked`` and for every page back in the pool, with no
    private entry or state snapshot left. A model without attention (the
    ssm family) plans no kernel. Returns (requests, run, info)."""
    from repro_torch.serving import cache_spec as CS
    from repro_torch.serving.scheduler import PagedServingEngine
    plan, planned = (planned_kernels(cfg, smax, policy)
                     if CS.has_paged_attn(cfg) else (None, ()))
    eng = PagedServingEngine(params, cfg, n_slots=len(toks), smax=smax,
                             page_size=page_size, prefill_chunk=chunk,
                             backend="auto", device=DEV, **kw)
    info = dict(plan=str(plan), policy=policy, dtype=cfg.dtype,
                n_layers=cfg.n_layers, n_pages=eng.pool.n_pages,
                page_size=page_size, pool_bytes=eng.pool_bytes,
                n_table_groups=eng.n_groups)
    if tick_check is not None:
        tick = eng.tick

        def checked_tick(*a):
            tick(*a)
            tick_check(eng)
        eng.tick = checked_tick
    reqs = family_requests(toks, frames)
    run = drive_paged(path, eng, reqs, profiled=profiled)
    back = eng.pool.free_pages + eng.pool.cached_pages
    n_pages = eng.pool.n_pages
    kept = (eng._state_snap, eng._page_snap,
            [p for p in eng.pool.lru_page_ids() if eng.pool.is_private(p)])
    if any(kept):
        raise AssertionError(f"{path}: snapshots or private entries left "
                             f"after the run: {kept}")
    del eng
    if DEV == "cuda":
        torch.cuda.empty_cache()
    paged_checked(path, reqs, run, planned, cfg.n_layers)
    if back != n_pages - 1:
        raise AssertionError(f"{path}: the pool got {back} of its "
                             f"{n_pages - 1} pages back")
    results.setdefault("launches", {})[path] = run["counts"]
    return reqs, run, info


def equal_checked(path, reqs, dense, report, phase="families"):
    if [r.out for r in reqs] != dense:
        raise AssertionError(f"{path}: paged tokens differ from the dense "
                             f"engine's ({report['greedy_equal_reference']}"
                             f"/{report['tokens']} equal)")
    log(f"{phase}: {path}: paged == dense, {report['tokens']} of "
        f"{report['tokens']} greedy tokens")


def serve_whisper(results, out, *, smoke=False, smax=WHISPER_SMAX,
                  page_size=WHISPER_PAGE, block=WHISPER_BLOCK,
                  chunk=WHISPER_CHUNK, lengths=WHISPER_LENGTHS):
    """whisper-small at published width (12 encoder and 12 decoder layers,
    d_model 768, 12 heads, vocab 51865, 1500 stand-in frames a request,
    ``launch.serve._frames``), smax 448, 64-token pages, 32-token blocks:
    with bf16 and then float32 weights, per policy (loki_block, full,
    exact_topk) the dense engine's greedy tokens, then the paged engine at
    its defaults (cross K/V installed at admission, prefix caching
    bypassed; ``paged_whisper_[fp32_]<policy>``: planned launches and one
    host sync a decode tick asserted); paged == dense asserted in float32
    and reported in bf16. Then loki_block at bf16 over an int8 pool
    (quantized cross K/V, one scale a layer and slot)."""
    from repro_torch.configs.base import PageLayout
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch import serve as S

    sc = S.ServeConfig(engine=S.EngineSection(
        arch="whisper-small", smoke=smoke, kind="paged",
        policy="loki_block", backend="auto", n_slots=4, smax=smax),
        device=DEV)
    cfg = sc.resolve_model()
    cfg = cfg.replace(loki=dataclasses.replace(cfg.loki, block_size=block))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=96,
                                  global_batch=8, seed=7, n_states=32,
                                  temperature=0.22))
    toks = prompts(cfg.vocab, lengths, seed=17)
    frames = [S._frames(cfg, 4000 + i)[0].numpy() for i in range(len(toks))]
    kw = dict(smax=smax, page_size=page_size, chunk=chunk, frames=frames)
    for dtype in ("bfloat16", "float32"):
        dcfg = cfg.replace(dtype=dtype)
        t0 = time.perf_counter()
        params = S.calibrated_params(dcfg, data, seed=0, device=DEV)
        sync()
        n_params = sum(t.numel() for t in tensors_of(params))
        log(f"families: {cfg.arch}, {cfg.enc_layers} encoder + "
            f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads} heads, vocab {cfg.vocab}, enc_seq "
            f"{cfg.enc_seq}, {n_params / 1e6:.1f} M parameters in {dtype}; "
            f"init + PCA calibration {time.perf_counter() - t0:.1f} s")
        dense_lb = None
        for policy in GRANITE_POLICIES:
            pcfg = policy_cfg(dcfg, policy)
            tag = "" if dtype == "bfloat16" else "fp32_"
            path = f"paged_whisper_{tag}{policy}"
            dense = dense_greedy(path, params, pcfg, toks, smax, frames)
            reqs, run, info = paged_run(results, path, params, pcfg, policy,
                                        toks, **kw)
            out[path] = paged_report(path, reqs, run, dense,
                                     "the dense engine", 4, **info)
            if dtype == "float32":
                equal_checked(path, reqs, dense, out[path])
            if policy == "loki_block":
                dense_lb = dense
        if dtype == "bfloat16":
            path = "paged_whisper_int8_loki_block"
            pcfg = dcfg.with_layout(PageLayout.parse("int8"))
            reqs, run, info = paged_run(results, path, params, pcfg,
                                        "loki_block", toks, **kw)
            out[path] = paged_report(path, reqs, run, dense_lb,
                                     "the dense engine (bf16)", 4, **info)
        del params
        if DEV == "cuda":
            torch.cuda.empty_cache()


def recycled_step(results, path, params, cfg, toks, *, smax, page_size,
                  chunk):
    """Four prompts prefilled chunk by chunk through shuffled tables (one
    row per page-table group: rank 3 with ``cfg.window_layers``), then one
    decode step over those tables and one over the same tables with every
    page a window group's window has passed pointed at the trash page: the
    logits bit for bit (counted as ``path``)."""
    from repro_torch import kernels as K
    from repro_torch.models import lm
    from repro_torch.serving import cache_spec as CS
    b, mp = len(toks), smax // page_size
    windows = CS.group_windows(cfg)
    n_groups = len(windows)
    gen = torch.Generator().manual_seed(3)
    table = (torch.randperm(b * n_groups * mp, generator=gen) + 1).view(
        b, n_groups, mp).int()
    cache = lm.init_paged_cache(cfg, 1 + table.numel(), page_size,
                                n_slots=b, device=DEV)
    grouped = cfg.window_layers is not None

    def rows(t):
        return (t if grouped else t[:, 0]).to(DEV).contiguous()
    for s, t in enumerate(toks):
        for start in range(0, len(t) - 1, chunk):
            nv = min(chunk, len(t) - 1 - start)
            buf = torch.zeros((1, chunk), dtype=torch.int32)
            buf[0, :nv] = torch.as_tensor(t[start:start + nv])
            lm.prefill_chunk(params, cfg, cache, buf.to(DEV), start, nv,
                             rows(table[s:s + 1]), page_size, slot=s)
    pos = torch.tensor([len(t) - 1 for t in toks], dtype=torch.int32)
    tok = torch.tensor([int(t[-1]) for t in toks], dtype=torch.int32)
    rec = table.clone()
    for s in range(b):
        for g, w in enumerate(windows):
            if w:
                rec[s, g, :max(0, int(pos[s]) - w + 1) // page_size] = 0
    n_trash = int((rec == 0).sum())
    if not n_trash:
        raise AssertionError(f"{path}: no table entry recycled")
    K.reset_launch_counts()
    logits = [lm.decode_step(params, cfg, cache, tok.to(DEV), pos.to(DEV),
                             page_table=rows(t), page_size=page_size)[0]
              for t in (table, rec)]
    counts = K.launch_counts()
    sync()
    if not torch.equal(logits[0], logits[1]):
        raise AssertionError(
            f"{path}: the step over recycled tables differs from the "
            "unrecycled one (max |d| "
            f"{float((logits[0] - logits[1]).abs().max()):.3e})")
    results.setdefault("launches", {})[path] = counts
    log(f"families: {path}: one decode step over tables with {n_trash} "
        f"recycled entries on the trash page == over the unrecycled "
        f"tables, bit for bit ({n_groups} page-table group(s), windows "
        f"{list(windows)}); launches {counts}")
    del cache


def serve_mixtral(results, out, *, smoke=False, smax=MIXTRAL_SMAX,
                  page_size=MIXTRAL_PAGE, chunk=MIXTRAL_CHUNK,
                  lengths=MIXTRAL_LENGTHS, n_layers=MIXTRAL_LAYERS,
                  fp32_layers=MIXTRAL_FP32_LAYERS):
    """mixtral-8x22b's sliding window at published width (d_model 6144,
    48 heads over 8 KV heads, head_dim 128, window 4096, 8 experts top-2),
    depth cut to ``n_layers`` of 56 (bf16) and ``fp32_layers`` (float32):
    per policy (loki_block, full) the dense engine's greedy tokens, then
    the paged engine at its defaults (smax 8192, 512-token pages and
    chunks; ``paged_mixtral_<policy>``), every slot within its window
    budget after every tick, pages recycled, a slot's peak at
    ceil(4096 / page) + 1 and every page back in the pool (asserted),
    agreement reported; with float32 weights paged == dense asserted
    (``paged_mixtral_fp32_loki_block``) and one decode step over recycled
    tables bit-equal to the unrecycled one (``mixtral_recycled_step``);
    then the same float32 model with windows alternating 4096 and 0 (two
    page-table groups through rank-3 tables: the full group pins its
    pages, the window group recycles; ``paged_mixtral_groups_loki_block``,
    ``mixtral_groups_recycled_step``), paged == dense asserted."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch import serve as S
    from repro_torch.serving import cache_spec as CS

    sc = S.ServeConfig(engine=S.EngineSection(
        arch="mixtral-8x22b", smoke=smoke, kind="paged",
        policy="loki_block", backend="auto", n_slots=4, smax=smax),
        device=DEV)
    cfg = sc.resolve_model()
    full_depth = cfg.n_layers
    w = cfg.sliding_window
    budget = CS.window_page_budget(w, page_size)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=96,
                                  global_batch=8, seed=7, n_states=32,
                                  temperature=0.22))
    toks = prompts(cfg.vocab, lengths, seed=19)
    kw = dict(smax=smax, page_size=page_size, chunk=chunk,
              tick_check=window_checked)

    def recycled_checked(path, run, groups=1):
        st = run["stats"]
        if st["n_recycled_pages"] < 1:
            raise AssertionError(f"{path}: no page recycled")
        if groups == 1 and st["peak_slot_pages"] != budget:
            raise AssertionError(f"{path}: peak {st['peak_slot_pages']} "
                                 f"pages a slot, not ceil({w} / "
                                 f"{page_size}) + 1 = {budget}")
        got = st.get("table_groups", {}).get("n_groups", 1)
        if got != groups:
            raise AssertionError(f"{path}: {got} page-table groups, "
                                 f"expected {groups}")

    bcfg = cfg.replace(n_layers=min(n_layers, full_depth))
    t0 = time.perf_counter()
    params = S.calibrated_params(bcfg, data, seed=0, device=DEV)
    sync()
    n_params = sum(t.numel() for t in tensors_of(params))
    log(f"families: {cfg.arch}, {bcfg.n_layers} of {full_depth} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"KV heads, window {w}, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, {n_params / 1e9:.2f} B parameters in "
        f"{bcfg.dtype}; init + PCA calibration "
        f"{time.perf_counter() - t0:.1f} s")
    for policy in ("loki_block", "full"):
        pcfg = policy_cfg(bcfg, policy)
        path = f"paged_mixtral_{policy}"
        dense = dense_greedy(path, params, pcfg, toks, smax)
        reqs, run, info = paged_run(results, path, params, pcfg, policy,
                                    toks, **kw)
        recycled_checked(path, run)
        out[path] = paged_report(
            path, reqs, run, dense, "the dense engine", 4, **info,
            n_recycled_pages=run["stats"]["n_recycled_pages"],
            peak_slot_pages=run["stats"]["peak_slot_pages"])
    if DEV == "cuda":
        log(f"families: {cfg.arch} at {bcfg.n_layers} layers: peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    fcfg = cfg.replace(dtype="float32",
                       n_layers=min(fp32_layers, full_depth))
    params = S.calibrated_params(fcfg, data, seed=0, device=DEV)
    gcfg = fcfg.with_window_layers(tuple(
        w if i % 2 == 0 else 0 for i in range(fcfg.n_layers)))
    for path, pcfg, groups in (("paged_mixtral_fp32_loki_block", fcfg, 1),
                               ("paged_mixtral_groups_loki_block", gcfg, 2)):
        dense = dense_greedy(path, params, pcfg, toks, smax)
        reqs, run, info = paged_run(results, path, params, pcfg,
                                    "loki_block", toks, **kw)
        recycled_checked(path, run, groups)
        out[path] = paged_report(
            path, reqs, run, dense, "the dense engine", 4, **info,
            n_recycled_pages=run["stats"]["n_recycled_pages"],
            peak_slot_pages=run["stats"]["peak_slot_pages"],
            window_layers=pcfg.window_layers)
        equal_checked(path, reqs, dense, out[path])
        step = ("mixtral_recycled_step" if groups == 1
                else "mixtral_groups_recycled_step")
        recycled_step(results, step, params, pcfg, toks, smax=smax,
                      page_size=page_size, chunk=chunk)
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()


def serve_llava(results, out, *, smoke=False, smax=4096, page_size=128,
                chunk=512, lengths=PAGED_LENGTHS):
    """llava-next-mistral-7b at published width (32 layers, 32 heads over
    8 KV heads, its Mistral-7B backbone; seeded bf16 weights, PCA
    calibrated): the paged engine at its defaults under loki_block over
    the llama prompts (``paged_llava_loki_block``), the dense engine's
    tokens as reference (agreement reported); then one ``lm.prefill`` of
    the first prompt with 576 seeded patch embeddings in place of its last
    576 tokens: the (text) logits finite and apart from the same prefill
    without patches (asserted)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch import serve as S
    from repro_torch.models import lm

    sc = S.ServeConfig(engine=S.EngineSection(
        arch="llava-next-mistral-7b", smoke=smoke, kind="paged",
        policy="loki_block", backend="auto", n_slots=4, smax=smax),
        device=DEV)
    cfg = sc.resolve_model()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=96,
                                  global_batch=8, seed=7, n_states=32,
                                  temperature=0.22))
    toks = prompts(cfg.vocab, lengths, seed=11)
    t0 = time.perf_counter()
    params = S.calibrated_params(cfg, data, seed=0, device=DEV)
    sync()
    n_params = sum(t.numel() for t in tensors_of(params))
    log(f"families: {cfg.arch}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
        f"heads, {n_params / 1e9:.2f} B parameters in {cfg.dtype}; init + "
        f"PCA calibration {time.perf_counter() - t0:.1f} s")
    path = "paged_llava_loki_block"
    dense = dense_greedy(path, params, cfg, toks, smax)
    reqs, run, info = paged_run(results, path, params, cfg, "loki_block",
                                toks, smax=smax, page_size=page_size,
                                chunk=chunk)
    out[path] = paged_report(path, reqs, run, dense, "the dense engine", 4,
                             **info)
    gen = torch.Generator(device=DEV).manual_seed(LLAVA_PATCH_SEED)
    patches = torch.randn((1, cfg.vision_tokens, cfg.d_model),
                          generator=gen, device=DEV)
    tok = torch.as_tensor(toks[0][None], device=DEV)
    with_p = lm.prefill(params, cfg, tok, smax, patches=patches)[0].float()
    plain = lm.prefill(params, cfg, tok, smax)[0].float()
    if not torch.isfinite(with_p).all():
        raise AssertionError("llava: prefill with patches gave non-finite "
                             "logits")
    moved = float((with_p - plain).abs().max())
    if not moved > 0:
        raise AssertionError("llava: the patches did not move the text "
                             "row's logits")
    out["llava_patches"] = dict(prompt=len(toks[0]),
                                vision_tokens=cfg.vision_tokens,
                                max_abs_logit_moved=moved)
    log(f"families: llava prefill of {len(toks[0])} tokens with "
        f"{cfg.vision_tokens} seeded patch embeddings: logits finite, the "
        f"text row's logits moved by up to {moved:.3e} from the prefill "
        "without patches")
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()


def serve_families(results, *, smoke=False, whisper=None, mixtral=None,
                   llava=None):
    """The window and encoder families at published width:
    ``serve_whisper``, ``serve_mixtral``, ``serve_llava`` (each keyword a
    dict of sizes for a CPU rehearsal)."""
    out = {}
    t0 = time.perf_counter()
    for name, fn, sizes in (("whisper", serve_whisper, whisper),
                            ("mixtral", serve_mixtral, mixtral),
                            ("llava", serve_llava, llava)):
        fn(results, out, smoke=smoke, **(sizes or {}))
        log(f"families: {name} done at {time.perf_counter() - t0:.1f} s "
            "into the phase")
    results["families_serve"] = out


# ------------------------------------------------ recurrent-state families

#: hymba's prompts: each request's decode crosses a 128-token page at its
#: 9th token, after the youngest took its first chunk's pages (in the
#: tight pool the oldest then preempt the youngest, mid-prefill: its
#: recompute folds in no generated token, whose K/V prefill would compute
#: with exact attention where decode took Loki's blocks); short beside the
#: llama prompts because the mamba prefill runs its recurrence token by
#: token (a kernel a token and layer): 2272 prompt tokens (377-761) took
#: the phase 241 s of its 200 on a slow host, so 1376
HYMBA_LENGTHS = (121, 249, 377, 633)
#: the priority run's urgent request
HYMBA_URGENT = 257
#: the tight-pool and tiered runs' context cap: 8 pages a request, so the
#: tight pool (11 pages) may hold one whole request and 9 frames, the
#: fewest legal, hold 9 of the 15 pages the four requests reach
HYMBA_SHORT_SMAX = 1024
#: the tiered run's depth cut (of 32 layers)
HYMBA_TIERED_LAYERS = 8
XLSTM_LENGTHS = HYMBA_LENGTHS


def pool_pages(lengths, page_size: int) -> int:
    """Pages (with the trash page) that hold every request at its full
    length, prompt and MAX_NEW tokens: a pool with no page to spare."""
    return 1 + sum(-(-(n + MAX_NEW) // page_size) for n in lengths)


def restore_run(results, path, params, cfg, toks, urgent, refs, *, smax,
                page_size, chunk, decoded=2):
    """The snapshot restore, counted as ``path``: the requests of ``toks``
    run under the priority policy until each has ``decoded`` tokens out,
    then an urgent request (priority 1, prompt ``urgent``) preempts the
    least urgent running one for its slot: its state goes to the host and,
    with pages, its pages become private pool entries, in a pool of
    ``pool_pages`` (none to spare; the urgent request's pages come from the
    free list, so no retained page is evicted). Asserted: one preemption
    and one restore, every request's tokens equal to ``refs`` (the dense
    engine's, the urgent request's last), the preempted prompt computed
    once, every page back and no private entry or snapshot left. Returns
    the report."""
    from repro_torch import kernels as K
    from repro_torch.serving import cache_spec as CS
    from repro_torch.serving.engine import Request
    from repro_torch.serving.lifecycle import is_terminal
    from repro_torch.serving.scheduler import PagedServingEngine
    n_pages = pool_pages([len(t) for t in toks] + [len(urgent)], page_size)
    eng = PagedServingEngine(params, cfg, n_slots=len(toks), smax=smax,
                             page_size=page_size, prefill_chunk=chunk,
                             policy="priority", n_pages=n_pages,
                             backend="auto", device=DEV)
    reqs = family_requests(toks) + [Request(
        rid=len(toks), prompt=urgent, max_new=MAX_NEW, priority=1)]
    # ---- the path: counts set to 0 just before, read just after
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs[:-1]:
        eng.submit(r)
    while min(len(r.out) for r in reqs[:-1]) < decoded:
        eng.tick()
    eng.submit(reqs[-1])
    while not all(is_terminal(r) for r in reqs):
        if eng.ticks > 400:
            raise AssertionError(f"{path} did not finish in 400 ticks")
        eng.tick()
    sync()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    # ---- end of the path
    st = eng.stats()
    back = eng.pool.free_pages == eng.pool.n_pages - 1
    left = bool(eng._state_snap or eng._page_snap)
    del eng
    outs = [r.out for r in reqs]
    same = sum(a == b for o, w in zip(outs, refs) for a, b in zip(o, w))
    computed = sum(len(t) - 1 for t in toks) + len(urgent) - 1
    ok = (st["n_preempted"] == 1 and st["n_state_restores"] == 1
          and outs == refs and back and not left
          and st["n_prefill_computed_tokens"] == computed)
    report = dict(n_pages=n_pages, n_preempted=st["n_preempted"],
                  n_state_restores=st["n_state_restores"],
                  prefill_computed_tokens=st["n_prefill_computed_tokens"],
                  tokens=len(refs) * MAX_NEW, equal_reference=same,
                  pool_back=back, wall_s=wall, launches=counts,
                  pages=CS.has_paged_attn(cfg))
    if not ok:
        raise AssertionError(f"{path}: {report}, left {left}")
    results.setdefault("launches", {})[path] = counts
    log(f"recurrent: {path}: the urgent request preempted a request "
        f"{decoded} tokens into its decode; its state snapshot"
        + (" and its pages, kept private," if report["pages"] else "")
        + f" restored at re-admission (prompt computed once: "
        f"{computed} prompt tokens in all); {same}/{same} tokens equal to "
        f"the dense engine's"
        + (f", in a pool of {n_pages} pages with none to spare, every page "
           "back" if report["pages"] else "")
        + f"; {wall:.2f} s; launches {counts}")
    return report


def prefill_chunk_ms(path, params, cfg, tok, *, smax, page_size, chunk):
    """One prompt ``tok`` prefilled chunk by chunk into a fresh one-slot
    paged cache: each chunk's host time around a synchronise, then the
    first chunk again under the profiler (device busy, so the host's
    share shows). Returns the numbers and logs them."""
    from repro_torch.models import lm
    mp = smax // page_size
    cache = lm.init_paged_cache(cfg, mp + 1, page_size, n_slots=1,
                                device=DEV)
    table = torch.arange(1, mp + 1, dtype=torch.int32, device=DEV)[None]
    n_pre = len(tok) - 1
    bufs = []
    for c0 in range(0, n_pre, chunk):
        nv = min(chunk, n_pre - c0)
        buf = torch.zeros((1, chunk), dtype=torch.int32)
        buf[0, :nv] = torch.as_tensor(tok[c0:c0 + nv])
        bufs.append((buf.to(DEV), c0, nv))

    def run(buf, c0, nv):
        lm.prefill_chunk(params, cfg, cache, buf, c0, nv, table, page_size,
                         slot=0)
    sync()
    ms = []
    for b in bufs:
        t0 = time.perf_counter()
        run(*b)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    busy = device_busy_ms(lambda: run(*bufs[0]), 1)
    del cache
    out = dict(chunk=chunk, tokens=[b[2] for b in bufs], ms=ms,
               ms_per_token=sum(ms) / n_pre, first_chunk_busy_ms=busy,
               first_chunk_idle_share=idle_share(busy, ms[0]))
    scan, n_rec = recurrence_ms(params, cfg, chunk)
    if scan is not None:
        out.update(recurrence_ms_per_layer=scan, recurrent_layers=n_rec)
    log(f"recurrent: {path}: a {len(tok)}-token prompt in chunks of "
        f"{chunk}: " + ", ".join(f"{n} tokens {m:.1f} ms"
                                 for n, m in zip(out["tokens"], ms))
        + f" ({out['ms_per_token']:.3f} ms a token); the first chunk's "
        f"device busy {busy:.1f} ms -> idle share "
        f"{out['first_chunk_idle_share']:.3f}"
        + (f"; one layer's token-by-token recurrence over {chunk} tokens "
           f"alone {scan:.1f} ms ({n_rec} such layers: "
           f"{scan * n_rec:.1f} ms)" if scan is not None else ""))
    return out


def recurrence_ms(params, cfg, n_tok):
    """Host ms around a synchronise of one layer's token-by-token
    recurrence over ``n_tok`` tokens, alone: mamba's ``_mamba_scan``
    (hybrid) or the sLSTM loop (ssm, its first sLSTM layer), and the
    number of layers that run one; (None, 0) for a family without."""
    from repro_torch.models import blocks as B
    from repro_torch.models import lm
    from repro_torch.serving import cache_spec as CS
    gen = torch.Generator(device=DEV).manual_seed(0)
    kinds = [CS.layer_kind(cfg, i) for i in range(cfg.n_layers)]
    if "hybrid" in kinds:
        p = lm.layer_params(params, 0)["ssm"]
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        xz = torch.randn((1, n_tok, 2 * d_in), generator=gen,
                         device=DEV).to(p["in_proj"].dtype)
        st = B.init_mamba_cache(cfg, 1, torch.float32, DEV)

        def one():
            B._mamba_scan(p, xz, st["conv"], st["ssm"], cfg)
    elif "slstm" in kinds:
        p = lm.layer_params(params, kinds.index("slstm"))["ssm"]
        x = torch.randn((1, n_tok, cfg.d_model), generator=gen,
                        device=DEV).to(p["w_out"].dtype)

        def one():
            B.slstm_train(p, x, cfg)
    else:
        return None, 0
    one()
    sync()
    t0 = time.perf_counter()
    one()
    sync()
    return (1e3 * (time.perf_counter() - t0),
            kinds.count("hybrid") + kinds.count("slstm"))


def serve_hymba(results, out, *, smoke=False, smax=4096, page_size=128,
                chunk=512, lengths=HYMBA_LENGTHS, urgent=HYMBA_URGENT,
                tiered_layers=HYMBA_TIERED_LAYERS,
                short_smax=HYMBA_SHORT_SMAX):
    """hymba-1.5b at published width (32 layers, d_model 1600, 25 heads
    over 5 KV heads, head_dim 64, mamba d_inner 3200 with a 16-wide state;
    seeded weights, PCA calibrated): with bf16 and then float32 weights,
    per policy (loki_block, full, exact_topk) the dense engine's greedy
    tokens, then the paged engine at its defaults (prefix caching
    bypassed for the StateSlot; ``paged_hymba_[fp32_]<policy>``: planned
    launches on every attention layer of every decode step and one host
    sync a decode tick asserted, every page back and no private entry
    left); paged == dense asserted in float32, reported in bf16. Then, in
    float32 under loki_block: packed decode off (``..._masked``: the same
    tokens as the packed run, asserted), the tight pool at context
    ``short_smax`` (the oldest preempt the youngest when their decode
    grows a page; tokens equal to the dense engine's at that context, the
    restore or its recompute fallback reported), the priority run
    (``restore_run`` at ``short_smax``: a snapshot and retained pages
    restored, asserted), and ms per prefill chunk. Last the tier:
    ``tiered_layers`` layers at bf16, context ``short_smax``, the single
    tier unpacked, then the fewest legal frames (tokens equal,
    asserted)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch import serve as S
    from repro_torch.serving.engine import Request
    from repro_torch.serving.scheduler import PagedServingEngine

    sc = S.ServeConfig(engine=S.EngineSection(
        arch="hymba-1.5b", smoke=smoke, kind="paged", policy="loki_block",
        backend="auto", n_slots=4, smax=smax), device=DEV)
    cfg = sc.resolve_model()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=96,
                                  global_batch=8, seed=7, n_states=32,
                                  temperature=0.22))
    toks = prompts(cfg.vocab, lengths, seed=23)
    hot = prompts(cfg.vocab, (urgent,), seed=24)[0]
    kw = dict(smax=smax, page_size=page_size, chunk=chunk)
    # one profiled tick a width: a hymba tick takes the profiler far
    # longer to record than to run
    pkw = dict(kw, profiled=1)
    for dtype in ("bfloat16", "float32"):
        dcfg = cfg.replace(dtype=dtype)
        tag = "" if dtype == "bfloat16" else "fp32_"
        t0 = time.perf_counter()
        params = S.calibrated_params(dcfg, data, seed=0, device=DEV)
        sync()
        n_params = sum(t.numel() for t in tensors_of(params))
        log(f"recurrent: {cfg.arch}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
            f"heads, head_dim {cfg.resolved_head_dim}, mamba d_inner "
            f"{cfg.ssm.expand * cfg.d_model} state {cfg.ssm.state_dim} "
            f"conv {cfg.ssm.conv_width}, vocab {cfg.vocab}: "
            f"{n_params / 1e9:.3f} B parameters ({n_params}) in {dtype}; "
            f"init + PCA calibration {time.perf_counter() - t0:.1f} s")
        runs = {}
        for policy in GRANITE_POLICIES:
            pcfg = policy_cfg(dcfg, policy)
            path = f"paged_hymba_{tag}{policy}"
            dense = dense_greedy(path, params, pcfg, toks, smax)
            reqs, run, info = paged_run(results, path, params, pcfg, policy,
                                        toks, **pkw)
            out[path] = paged_report(path, reqs, run, dense,
                                     "the dense engine", 4, **info)
            runs[policy] = (dense, [r.out for r in reqs])
            if dtype == "float32":
                equal_checked(path, reqs, dense, out[path], "recurrent")
        if dtype == "float32":
            dense, packed = runs["loki_block"]
            path = "paged_hymba_fp32_loki_block_masked"
            reqs, run, info = paged_run(results, path, params, dcfg,
                                        "loki_block", toks, packed=False,
                                        **pkw)
            out[path] = paged_report(path, reqs, run, packed,
                                     "the packed run", 4, **info)
            if [r.out for r in reqs] != packed:
                raise AssertionError(f"{path}: masked tokens differ from "
                                     "the packed run's")
            log(f"recurrent: {path}: packed == masked, {len(toks) * MAX_NEW}"
                f" of {len(toks) * MAX_NEW} greedy tokens")
            path = "paged_hymba_fp32_tight"
            short = dense_greedy(path, params, dcfg, toks, short_smax)
            reqs, run, info = paged_run(
                results, path, params, dcfg, "loki_block", toks,
                n_pages=tight_pool(lengths, page_size, chunk),
                smax=short_smax, page_size=page_size, chunk=chunk,
                profiled=1)
            st = run["stats"]
            out[path] = paged_report(path, reqs, run, short,
                                     "the dense engine", 4, **info,
                                     n_state_restores=st["n_state_restores"])
            # here the older requests' growth preempts the youngest
            # mid-prefill, so its recompute folds in no token decoded
            # under Loki's selection and reproduces the dense engine's
            # tokens (asserted below). Its pages are retained only as
            # unreferenced private entries, and that growth takes its page
            # by evicting the least recently released of them: the
            # retained set is never whole again, and the restore (all or
            # nothing, as in the reference) falls back to recomputing.
            # (A request that preempts itself, nothing less urgent holding
            # pages, keeps its set whole and restores.)
            prompt = sum(len(t) - 1 for t in toks)
            fallback = (st["n_preempted"] == 1
                        and st["n_state_restores"] == 0
                        and st["n_prefill_computed_tokens"] > prompt)
            if not fallback:
                raise AssertionError(
                    f"{path}: expected one preemption recomputed (no "
                    f"restore): preempted {st['n_preempted']}, restored "
                    f"{st['n_state_restores']}, prefill computed "
                    f"{st['n_prefill_computed_tokens']} of {prompt} prompt "
                    "tokens")
            equal_checked(path, reqs, short, out[path], "recurrent")
            log(f"recurrent: {path}: {st['n_preempted']} preemption, "
                f"{st['n_state_restores']} restored from the snapshot: the "
                "growth that preempted evicted a retained page, so the "
                "folded prompt was recomputed ("
                f"{st['n_prefill_computed_tokens']} prefill tokens computed "
                f"for {prompt} prompt tokens), tokens equal to the dense "
                "engine's")
            ref = dense_greedy("hymba_urgent", params, dcfg, [hot],
                               short_smax, n_slots=len(toks))
            out["paged_hymba_fp32_restore"] = restore_run(
                results, "paged_hymba_fp32_restore", params, dcfg, toks,
                hot, short + ref, smax=short_smax, page_size=page_size,
                chunk=chunk)
            out["hymba_prefill_chunks"] = prefill_chunk_ms(
                "hymba_prefill_chunks", params, dcfg, toks[-1], **kw)
        del params
        if DEV == "cuda":
            torch.cuda.empty_cache()
    # the tier at a reduced depth and context
    tcfg = cfg.replace(n_layers=min(tiered_layers, cfg.n_layers))
    params = S.calibrated_params(tcfg, data, seed=0, device=DEV)
    tkw = dict(n_slots=len(toks), smax=short_smax, page_size=page_size,
               prefill_chunk=chunk, backend="auto", device=DEV)

    def requests():
        return [Request(rid=i, prompt=t, max_new=MAX_NEW)
                for i, t in enumerate(toks)]
    path = "paged_hymba_tiered_single"
    plan, planned = planned_kernels(tcfg, short_smax, "loki_block")
    eng = PagedServingEngine(params, tcfg, packed=False, **tkw)
    single = eng.pool_bytes
    reqs = requests()
    run = drive_paged(path, eng, reqs, profiled=1)
    del eng
    paged_checked(path, reqs, run, planned, tcfg.n_layers)
    results.setdefault("launches", {})[path] = run["counts"]
    out[path] = paged_report(path, reqs, run, None, None, 4, plan=str(plan),
                             n_layers=tcfg.n_layers)
    ref = [r.out for r in reqs]
    path = "paged_hymba_tiered_min"
    frames = 1 + short_smax // page_size
    eng = PagedServingEngine(params, tcfg, device_pages=frames,
                             max_inflight=2, audit=True, **tkw)
    info = dict(policy="loki_block", n_layers=tcfg.n_layers,
                n_pages=eng.pool.n_pages, device_pages=frames,
                device_bytes=eng.pool_bytes, single_tier_bytes=single)
    reqs = requests()
    run = drive_paged(path, eng, reqs, profiled=1)
    del eng
    tiered_checked(path, reqs, run, tcfg.n_layers)
    results.setdefault("launches", {})[path] = run["counts"]
    out[path] = tiered_report(path, reqs, run, ref, 4, **info)
    if [r.out for r in reqs] != ref:
        raise AssertionError(f"{path}: tiered tokens differ from the single"
                             " tier's")
    log(f"recurrent: {path}: tiered == single tier, {len(toks) * MAX_NEW} "
        f"of {len(toks) * MAX_NEW} greedy tokens at {frames} frames, "
        f"{tcfg.n_layers} of {cfg.n_layers} layers, smax {short_smax}")
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()


def serve_xlstm(results, out, *, smoke=False, smax=4096, page_size=128,
                chunk=512, lengths=XLSTM_LENGTHS, urgent=HYMBA_URGENT):
    """xlstm-125m at published width (12 layers of d_model 768, 4 heads,
    an sLSTM block every 6th, the rest mLSTM; vocab 50304): no KV cache,
    so the launcher forces its policy to full and no kernel runs. With
    bf16 and float32 weights the dense engine's greedy tokens, then the
    paged engine (``paged_xlstm_[fp32_]full``: no kernel launched and one
    host sync a decode tick asserted); paged == dense asserted in float32.
    Then the float32 priority run (``restore_run``: the snapshot restored,
    no pages to retain)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch import serve as S

    sc = S.ServeConfig(engine=S.EngineSection(
        arch="xlstm-125m", smoke=smoke, kind="paged", policy="loki_block",
        backend="auto", n_slots=4, smax=smax), device=DEV)
    cfg = sc.resolve_model()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=96,
                                  global_batch=8, seed=7, n_states=32,
                                  temperature=0.22))
    toks = prompts(cfg.vocab, lengths, seed=29)
    hot = prompts(cfg.vocab, (urgent,), seed=30)[0]
    kw = dict(smax=smax, page_size=page_size, chunk=chunk)
    for dtype in ("bfloat16", "float32"):
        dcfg = cfg.replace(dtype=dtype)
        tag = "" if dtype == "bfloat16" else "fp32_"
        params = S.calibrated_params(dcfg, data, seed=0, device=DEV)
        n_params = sum(t.numel() for t in tensors_of(params))
        log(f"recurrent: {cfg.arch}, {cfg.n_layers} layers (one in "
            f"{cfg.slstm_every} an sLSTM block), d_model {cfg.d_model}, "
            f"{cfg.ssm.n_heads} heads, vocab {cfg.vocab}: "
            f"{n_params / 1e6:.1f} M parameters in {dtype}, policy "
            f"{dcfg.attn_policy()}")
        path = f"paged_xlstm_{tag}full"
        dense = dense_greedy(path, params, dcfg, toks, smax)
        reqs, run, info = paged_run(results, path, params, dcfg, "full",
                                    toks, profiled=1, **kw)
        out[path] = paged_report(path, reqs, run, dense, "the dense engine",
                                 4, **info)
        if dtype == "float32":
            equal_checked(path, reqs, dense, out[path], "recurrent")
            ref = dense_greedy("xlstm_urgent", params, dcfg, [hot], smax,
                               n_slots=len(toks))
            out["paged_xlstm_fp32_restore"] = restore_run(
                results, "paged_xlstm_fp32_restore", params, dcfg, toks,
                hot, dense + ref, **kw)
            out["xlstm_prefill_chunks"] = prefill_chunk_ms(
                "xlstm_prefill_chunks", params, dcfg, toks[-1], **kw)
        del params
        if DEV == "cuda":
            torch.cuda.empty_cache()


def serve_recurrent(results, *, smoke=False, hymba=None, xlstm=None):
    """The recurrent-state families at published width: ``serve_hymba``
    and ``serve_xlstm`` (each keyword a dict of sizes for a CPU
    rehearsal), the phase's seconds logged."""
    out = {}
    t0 = time.perf_counter()
    for name, fn, sizes in (("hymba", serve_hymba, hymba),
                            ("xlstm", serve_xlstm, xlstm)):
        fn(results, out, smoke=smoke, **(sizes or {}))
        log(f"recurrent: {name} done at {time.perf_counter() - t0:.1f} s "
            "into the phase")
    out["phase_s"] = time.perf_counter() - t0
    results["recurrent_serve"] = out


def tensors_of(tree):
    """The tensors of a parameter tree (nested dicts and lists)."""
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from tensors_of(v)
    else:
        yield tree


def prefix_prompts(vocab: int, n: int = 4):
    """A PREFIX_LEN-token system prompt before ``n`` distinct
    SUFFIX_LEN-token suffixes whose first tokens differ pairwise, so each
    partial-tail match stops exactly at the prefix's end."""
    import numpy as np
    base = prompts(vocab, [PREFIX_LEN], seed=13)[0]
    sfx = [np.array(t) for t in prompts(vocab, [SUFFIX_LEN] * n, seed=17)]
    for i, t in enumerate(sfx):
        t[0] = (97 * (i + 1)) % vocab
    return [np.concatenate([base, t]).astype(np.int32) for t in sfx]


def serve_prefix(results, params, cfg, *, smax, page_size, chunk,
                 runs=PREFIX_RUNS, pool=PREFIX_POOL):
    """The shared-system-prompt path, once per (layout, policy): request
    0 alone, the other three once it decodes, in a ``pool``-page pool that
    holds the run only shared. Asserts 3 x PREFIX_LEN prompt tokens served
    from cached pages, 3 copy-on-write tails (request 0 still reads the
    shared tail), no preemption, the planned launches and one host sync a
    decode tick; then ``lm.copy_cache_page`` once more on the engine's
    pools, equal to its source bit for bit (scales included). Greedy
    tokens against the same prompts served with prefix_cache=False,
    packed=False in the default pool first (``<path>_off``, counted on
    its own too; reported)."""
    from repro_torch.configs.base import PageLayout
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request
    from repro_torch.serving.scheduler import PagedServingEngine

    toks = prefix_prompts(cfg.vocab)
    n_slots = len(toks)
    out = results.setdefault("paged_serve", {})
    for layout, policy in runs:
        path = paged_path(layout, "prefix_" + policy)
        pcfg = policy_cfg(cfg, policy)
        if layout:
            pcfg = pcfg.with_layout(PageLayout.parse(layout))
        plan, planned = planned_kernels(pcfg, smax, policy)
        ref = None
        for name, kw in ((path + "_off", dict(prefix_cache=False,
                                              packed=False)),
                         (path, dict(n_pages=pool))):
            eng = PagedServingEngine(params, pcfg, n_slots=n_slots,
                                     smax=smax, page_size=page_size,
                                     prefill_chunk=chunk, backend="auto",
                                     device=DEV, **kw)
            info = dict(plan=str(plan), policy=policy,
                        n_pages=eng.pool.n_pages, pool_bytes=eng.pool_bytes,
                        bytes_per_page_layer=eng.bytes_per_page)
            reqs = [Request(rid=i, prompt=t, max_new=MAX_NEW)
                    for i, t in enumerate(toks)]
            run = drive_paged(name, eng, reqs, hold_first=True)
            paged_checked(name, reqs, run, planned, cfg.n_layers)
            results.setdefault("launches", {})[name] = run["counts"]
            if name == path:
                want = dict(n_prefix_hit_tokens=3 * PREFIX_LEN,
                            n_cow_copies=3, n_preempted=0)
                got = {k: run["stats"][k] for k in want}
                if got != want:
                    raise AssertionError(f"{path}: {got}, expected {want}")
                info["copy_cache_page_bit_equal"] = copy_page_checked(
                    path, lm, pcfg, eng, page_size)
            del eng
            if DEV == "cuda":
                torch.cuda.empty_cache()
            out[name] = paged_report(
                name, reqs, run, ref,
                "the same prompts' unshared, masked run", n_slots, **info)
            ref = [r.out for r in reqs]


def copy_page_checked(path, lm, cfg, eng, page_size) -> bool:
    """``lm.copy_cache_page`` on a finished engine's pools: a registered
    (cached) page into a free one, every layer's K and V rows and, at a
    quantized layout, the page's scales equal to the source's bit for
    bit (asserted)."""
    src = eng.pool.lru_page_ids()[0]
    dst = eng.pool.free_page_ids()[0]
    lm.copy_cache_page(cfg, eng.cache, src, dst, page_size)
    sync()
    attn = eng.cache["layers"]["attn"]
    for name, t in attn.items():
        if name.endswith("scale"):
            a, b = t[:, dst], t[:, src]
        else:
            a = t[:, dst * page_size:(dst + 1) * page_size]
            b = t[:, src * page_size:(src + 1) * page_size]
        if not torch.equal(a, b):
            raise AssertionError(f"{path}: copy_cache_page {src} -> {dst}: "
                                 f"{name} differs from its source")
    log(f"paged: {path}: copy_cache_page (page {src} -> {dst}, "
        f"{sorted(attn)}) equal to its source bit for bit")
    return True


#: the tiered runs: (path, device frames in requests' worth of pages, a
#: FaultPlan spec); each with 1 + that many pages' frames (with the trash
#: frame), 2 fetches in flight and the auditor on every tick, beside the
#: single-tier pool of every slot at its page bound
TIERED_RUNS = (("paged_tiered_min", 1, ""), ("paged_tiered_half", 2, ""),
               ("paged_tiered_chaos", 1,
                "seed=7,dma_timeout=0.2,hbm_oom_on_promote=0.1"))
TIERED_PAIR = ("select_blocks", "block_sparse_attention_grouped")


def tiered_checked(path, reqs, run, n_layers):
    """A tiered run's asserts: every request DONE; on every decode run
    select_blocks and block_sparse_attention_grouped on every layer, and
    no other kernel (fused_loki_decode cannot split its reads across the
    two pools); the host syncs PyTorch saw in each counted tick equal
    those the engine counted (its decode runs' and demotions'), one at
    least; demotions, promotions and no preemption."""
    bad = [r.rid for r in reqs if str(r.status) != "done"]
    if bad:
        raise AssertionError(f"{path}: requests not DONE: {bad}")
    st = run["stats"]
    ti = st["tiered"]
    check_launches(path, run["counts"], TIERED_PAIR, ti["n_decode_runs"],
                   n_layers)
    if run["syncs"] != run["counted"] or not run["counted"].get("decode"):
        raise AssertionError(f"{path}: host syncs {run['syncs']}, the "
                             f"engine counted {run['counted']}")
    if not (ti["n_demoted"] > 0 and ti["n_promoted"] > 0
            and st["n_preempted"] == 0):
        raise AssertionError(f"{path}: demoted {ti['n_demoted']}, promoted "
                             f"{ti['n_promoted']}, preempted "
                             f"{st['n_preempted']}")


def tiered_report(path, reqs, run, ref, n_slots, **info):
    """A tiered run's numbers and log lines: paged_report's, then per
    decode step the decode runs, re-runs and deferrals, promotions and
    demotions, bytes each way and the copies' rate on the profiled ticks,
    prefetch hits and sync fetches, winner against live pages a slot,
    device bytes against the single tier's and the peak of pinned host
    buffers."""
    out = paged_report(path, reqs, run, ref, "the single-tier unpacked run",
                       n_slots, **info)
    ti = run["stats"]["tiered"]
    steps = max(run["stats"]["n_decode_steps"], 1)
    cp = run["copies"]
    moved = {k: sum(c[f"{k}_bytes"] for c in cp) for k in ("h2d", "d2h")}
    copy_ms = {k: sum(c[k] for c in cp) for k in ("h2d", "d2h")}
    rate = {k: moved[k] / copy_ms[k] / 1e6 if copy_ms[k] else float("nan")
            for k in moved}
    per = dict(
        runs=ti["n_decode_runs"] / steps, reruns=ti["n_decode_reruns"] / steps,
        deferrals=ti["n_deferred"] / steps,
        promotions=ti["n_promoted"] / steps, demotions=ti["n_demoted"] / steps,
        h2d_bytes=ti["h2d_bytes"] / steps, d2h_bytes=ti["d2h_bytes"] / steps)
    slots = max(ti["winner_slots"], 1)
    win, live = ti["winner_pages"] / slots, ti["live_pages"] / slots
    out.update(tiered=ti, per_decode_step=per, copy_gb_per_s=rate,
               profiled_copies=cp, winner_pages_per_slot=win,
               live_pages_per_slot=live,
               winner_share=win / live if live else float("nan"))
    log(f"tiered: {path}: per decode step {per['runs']:.2f} runs "
        f"({per['reruns']:.2f} re-runs), {per['deferrals']:.2f} deferred "
        f"slots, {per['promotions']:.2f} promotions, {per['demotions']:.2f} "
        f"demotions, {per['h2d_bytes'] / 1e9:.3f} GB host-to-device and "
        f"{per['d2h_bytes'] / 1e9:.3f} GB device-to-host ({steps} decode "
        f"steps, {ti['n_decode_runs']} runs, totals {ti['h2d_bytes']} / "
        f"{ti['d2h_bytes']} B); copies on the profiled ticks "
        f"{moved['h2d']} B in {copy_ms['h2d']:.2f} ms -> "
        f"{rate['h2d']:.2f} GB/s host-to-device, {moved['d2h']} B in "
        f"{copy_ms['d2h']:.2f} ms -> {rate['d2h']:.2f} GB/s device-to-host;"
        f" prefetch hit rate {ti['prefetch_hit_rate']:.3f} "
        f"({ti['n_prefetch_hits']} hits, {ti['n_prefetch_misses']} misses),"
        f" {ti['n_sync_fetches']} sync fetches, {ti['n_fetches_issued']} "
        f"queued ({ti['n_sync_fallbacks']} copied again); winner pages "
        f"{win:.2f} of {live:.2f} live pages a slot (share "
        f"{out['winner_share']:.3f}); device bytes {info['device_bytes']} "
        f"(frames + sidecar) against {info['single_tier_bytes']} single "
        f"tier ({info['device_bytes'] / info['single_tier_bytes']:.3f}); "
        f"peak pinned host buffers {ti['peak_host_bytes']} B; "
        f"{ti['n_demote_syncs']} demotion syncs; whole run "
        f"{run['wall']:.2f} s")
    return out


def serve_tiered(results, params, cfg, toks, *, smax=4096, page_size=128,
                 chunk=512, runs=TIERED_RUNS):
    """The tiered path: first the single-tier reference, loki_block
    unpacked in a pool of every slot at its page bound
    (``paged_loki_block_masked``, the fused kernel, counted on its own);
    then each run of ``runs`` over the same prompts and logical pool,
    counted on its own: the tiered runs without faults give the
    reference's tokens, 64 of 64 (every step at 4 rows on both, so the
    kernels' cluster sizes match), and the chaos run's DONE outputs equal
    ``paged_tiered_min``'s with both tier sites fired. Before that a CUDA
    engine with kernel_fail in its plan must refuse to build."""
    from repro_torch.serving import faults as FI
    from repro_torch.serving.engine import Request
    from repro_torch.serving.scheduler import PagedServingEngine

    kw = dict(n_slots=4, smax=smax, page_size=page_size, prefill_chunk=chunk,
              backend="auto", device=DEV)
    if DEV == "cuda":
        try:
            PagedServingEngine(params, cfg, faults=FI.FaultPlan(
                at={"kernel_fail": {3}}), **kw)
        except ValueError as e:
            log(f"tiered: a CUDA engine with kernel_fail in its plan "
                f"refuses: {e}")
        else:
            raise AssertionError("a CUDA engine accepted kernel_fail")
    out = results.setdefault("paged_serve", {})
    launches = results.setdefault("launches", {})
    mp = smax // page_size

    def requests():
        return [Request(rid=i, prompt=t, max_new=MAX_NEW)
                for i, t in enumerate(toks)]

    path = "paged_loki_block_masked"
    plan, planned = planned_kernels(cfg, smax, "loki_block")
    eng = PagedServingEngine(params, cfg, packed=False, **kw)
    single = eng.pool_bytes
    info = dict(plan=str(plan), policy="loki_block", n_pages=eng.pool.n_pages,
                pool_bytes=single)
    reqs = requests()
    run = drive_paged(path, eng, reqs)
    del eng
    if DEV == "cuda":
        torch.cuda.empty_cache()
    paged_checked(path, reqs, run, planned, cfg.n_layers)
    launches[path] = run["counts"]
    out[path] = paged_report(path, reqs, run, None, None, 4, **info)
    ref = [r.out for r in reqs]
    results.setdefault("tokens", {})[path] = ref
    done = {}
    for path, mult, spec in runs:
        fplan = FI.FaultPlan.parse(spec) if spec else None
        eng = PagedServingEngine(params, cfg, device_pages=1 + mult * mp,
                                 max_inflight=2, audit=True, faults=fplan,
                                 **kw)
        info = dict(policy="loki_block", n_pages=eng.pool.n_pages,
                    device_pages=eng.pool.device_pages, faults=spec,
                    device_bytes=eng.pool_bytes, single_tier_bytes=single)
        reqs = requests()
        run = drive_paged(path, eng, reqs)
        del eng
        if DEV == "cuda":
            torch.cuda.empty_cache()
        tiered_checked(path, reqs, run, cfg.n_layers)
        launches[path] = run["counts"]
        outs = [r.out for r in reqs]
        if fplan is None:
            if outs != ref:
                same = sum(a == b for o, w in zip(outs, ref)
                           for a, b in zip(o, w))
                raise AssertionError(f"{path}: {same}/{len(toks) * MAX_NEW} "
                                     "tokens equal to the single tier's")
            done[mult] = outs
        else:
            fired = dict(fplan.counts)
            if not (fired.get("dma_timeout") and
                    fired.get("hbm_oom_on_promote")):
                raise AssertionError(f"{path}: tier sites fired {fired}")
            if outs != done[mult]:
                raise AssertionError(f"{path}: DONE outputs differ from the "
                                     "fault-free tiered run's")
            info["faults_fired"] = fired
            log(f"tiered: {path}: faults fired {fired}, DONE outputs equal "
                "to the fault-free run's")
        out[path] = tiered_report(path, reqs, run, ref, 4, **info)


def check_fault2(results, layouts=FAULT2_LAYOUTS):
    """Fault 2 closed: under each of full, exact_topk and loki_block, at
    each layout, the packed run's greedy tokens equal the masked run's,
    every one of them (asserted), with packed ticks on the packed side.
    The engine plans every step's kernels for its full width, so a slot's
    split count and cluster size do not follow the step's rows."""
    toks, serve_out = results["tokens"], results["paged_serve"]
    out = {}
    for layout in layouts:
        for policy in ("full", "exact_topk", "loki_block"):
            packed, masked = fault2_pair(layout, policy)
            a, b = toks[packed], toks[masked]
            n = sum(len(o) for o in b)
            same = sum(x == y for o, w in zip(a, b) for x, y in zip(o, w))
            n_packed = serve_out[packed]["n_packed_ticks"]
            if serve_out[masked]["n_packed_ticks"] or n_packed < 1:
                raise AssertionError(f"Fault 2: {packed} ran {n_packed} "
                                     f"packed ticks, {masked} "
                                     f"{serve_out[masked]['n_packed_ticks']}")
            if a != b:
                raise AssertionError(f"Fault 2: {packed} (packed) and "
                                     f"{masked} (masked) agree in {same}/{n} "
                                     "greedy tokens")
            out[packed] = dict(masked=masked, equal=same, tokens=n,
                               packed_ticks=n_packed)
            log(f"fault 2: {packed} (packed, {n_packed} packed ticks) == "
                f"{masked} (masked): {same}/{n} greedy tokens")
    results["fault2"] = out


@contextlib.contextmanager
def plain_kernels():
    """The ops wrappers the paged policies' dispatch calls, replaced by
    their kernels' plain versions over the dequantized logical views: a
    step taken inside runs the dispatch's own path with the plain version
    of each kernel, the same function."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA
    from repro_torch.kernels import ops

    def views(q, k, v, kw):
        q, k, v = GA.logical(q, k, v, kw.pop("page_table", None),
                             kw.pop("page_size", 0), kw.pop("k_scale", None),
                             kw.pop("v_scale", None))
        kw.pop("plan_rows", None)       # the plain versions do not split
        if kw.get("scale") is None:
            kw["scale"] = v.shape[-1] ** -0.5
        if "k_blocks" in kw:
            kw["k_blocks"] = min(kw["k_blocks"], k.shape[1] // kw["block_size"])
        return q, k, v

    def fused(q, k, v, cur, **kw):
        return F.fused_loki_decode_plain(*views(q, k, v, kw), cur, **kw)

    def exact(q, k, v, cur, **kw):
        return F.fused_exact_topk_decode_plain(*views(q, k, v, kw), cur, **kw)

    def full(q, k, v, cur, **kw):
        q, k, v = views(q, k, v, kw)
        return GA.full_decode_plain(q, k, v, cur, scale=kw["scale"],
                                    sliding_window=kw["sliding_window"])
    real = {n: getattr(ops, n) for n in ("loki_decode_fused",
                                         "exact_topk_decode_fused",
                                         "full_decode")}
    ops.loki_decode_fused, ops.exact_topk_decode_fused, ops.full_decode = \
        fused, exact, full
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(ops, n, fn)


def layout_step(results, params, cfg, toks, policy, layout, ref_logits, *,
                smax, page_size, chunk):
    """One decode step of the four prompts (all but each last token
    prefilled in ``chunk``-token chunks into a fresh pool at the layout)
    through the kernels and through the plain path on the same pool (the
    same dispatch with each kernel's plain version, ``plain_kernels``):
    their logits within BF16_LOGITS_BOUND (rel-L2, asserted);
    the kernel logits against the default layout's for the policy
    (``ref_logits``, filled by the default layout's call first; the
    layout's own error, reported). At int8:pca:r=32 under loki_block each
    layer's fused call is then repeated through the two-kernel pair on its
    own inputs, bit for bit: the path ``paged_int8pca_step``, counted on
    its own."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serving.paged_cache import PagePool

    per = [PagePool.pages_for(len(t), page_size) for t in toks]
    mp = smax // page_size
    table = torch.zeros((len(toks), mp), dtype=torch.int32)
    nxt = 1
    for i, n in enumerate(per):
        table[i, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    table = table.to(DEV)
    cache = lm.init_paged_cache(cfg, nxt, page_size, device=DEV)
    for i, t in enumerate(toks):
        p = torch.as_tensor(t[:-1], device=DEV)
        for s0 in range(0, len(p), chunk):
            nv = min(chunk, len(p) - s0)
            c = torch.zeros((1, chunk), dtype=p.dtype, device=DEV)
            c[0, :nv] = p[s0:s0 + nv]
            lm.prefill_chunk(params, cfg, cache, c, s0, nv, table[i:i + 1],
                             page_size)
    token = torch.as_tensor([int(t[-1]) for t in toks], device=DEV)
    pos = torch.as_tensor([len(t) - 1 for t in toks], dtype=torch.int32,
                          device=DEV)

    def step(backend):
        c = cfg.replace(loki=dataclasses.replace(cfg.loki, backend=backend))
        logits, _ = lm.decode_step(params, c, cache, token, pos,
                                   page_table=table, page_size=page_size)
        sync()
        return logits.float()

    rel = lambda a, b: float((a - b).norm() / b.norm())
    # (a CPU rehearsal reaches the kernels' plain versions only through
    # backend "pallas"; "auto" is the xla path there)
    backend = "auto" if DEV == "cuda" else "pallas"
    with recording(ops, "loki_decode_fused") as calls:
        kern = step(backend)
    res = {}
    if layout == "int8:pca:r=32" and policy == "loki_block":
        if len(calls) != cfg.n_layers:
            raise AssertionError(f"fused kernel called {len(calls)} times "
                                 f"in a {cfg.n_layers}-layer step")
        # ---- the paged pair path: counts set to 0 just before, read after
        K.reset_launch_counts()
        for layer, (args, kwargs, want) in enumerate(calls):
            two = ops.loki_decode_two_kernel(*args, **kwargs)
            sync()
            if DEV == "cuda" and not torch.equal(two, want):
                raise AssertionError(
                    f"int8:pca:r=32 layer {layer}: select_blocks + grouped "
                    "differs from fused_loki_decode")
        counts = K.launch_counts()
        # ---- end of the paged pair path
        check_launches("paged_int8pca_step", counts,
                       ("select_blocks", "block_sparse_attention_grouped"),
                       1, cfg.n_layers)
        results.setdefault("launches", {})["paged_int8pca_step"] = counts
        res["pair_equal_fused_layers"] = len(calls)
    # the plain step rewrites the step's rows (from its own layer inputs),
    # so it comes after the pair has read the kernel step's pools
    with plain_kernels():
        plain = step(backend)
    for name, x in (("kernel", kern), ("plain", plain)):
        if not torch.isfinite(x).all() or x.shape != (len(toks), cfg.vocab):
            raise AssertionError(f"{layout or 'fp32'} {policy} step: {name} "
                                 f"logits bad {tuple(x.shape)}")
    gap = rel(kern, plain)
    if gap > BF16_LOGITS_BOUND:
        raise AssertionError(f"{layout or 'fp32'} {policy} step: kernel "
                             f"logits vs plain rel-L2 {gap:.3e} > "
                             f"{BF16_LOGITS_BOUND}")
    res["step_rel_kernel_vs_plain"] = gap
    if not layout:
        ref_logits[policy] = kern
    else:
        res["step_rel_vs_fp32_native"] = rel(kern, ref_logits[policy])
        res["step_argmax_equal_fp32_native"] = int(
            (kern.argmax(-1) == ref_logits[policy].argmax(-1)).sum())
    del cache, calls
    if DEV == "cuda":
        torch.cuda.empty_cache()
    log(f"paged: {paged_path(layout, policy)}: one decode step, logits "
        f"rel-L2 kernels vs plain {gap:.3e} (bound {BF16_LOGITS_BOUND})"
        + (f"; vs the fp32 native layout {res['step_rel_vs_fp32_native']:.3e}"
           f", argmax equal {res['step_argmax_equal_fp32_native']}/"
           f"{len(toks)} (the layout's own error, reported)" if layout
           else "")
        + ("; the pair select_blocks + grouped == fused on all "
           f"{res['pair_equal_fused_layers']} layers (paged_int8pca_step)"
           if "pair_equal_fused_layers" in res else ""))
    return res


def prefilled_cache(params, cfg, toks, smax):
    """A float32 cache holding the prompts (all but each last token), one
    slot each, and the (token, pos) of the next decode step."""
    from repro_torch.models import lm

    cache = lm.init_cache(cfg, len(toks), smax, torch.float32, device=DEV)
    for i, t in enumerate(toks):
        view = {"layers": {"attn": {n: a[:, i:i + 1] for n, a in
                                    cache["layers"]["attn"].items()}}}
        lm.prefill(params, cfg, torch.as_tensor(t[None, :-1], device=DEV),
                   smax, cache=view)
    token = torch.as_tensor([int(t[-1]) for t in toks], device=DEV)
    pos = torch.as_tensor([len(t) - 1 for t in toks], dtype=torch.int32,
                          device=DEV)
    return cache, token, pos


def profile_decode(params, cfg, toks, smax, steps=3):
    """Where a decode step's time goes: torch.profiler device time by
    kernel over ``steps`` steps, against their wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm

    cache, token, pos = prefilled_cache(params, cfg, toks, smax)
    lm.decode_step(params, cfg, cache, token, pos)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lm.decode_step(params, cfg, cache, token, pos)
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    del cache
    torch.cuda.empty_cache()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side rows only (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched
    rows = sorted(((dev_us(e) / steps / 1e3, e.count // steps, e.key)
                   for e in prof.key_averages()
                   if dev_us(e) > 0 and e.device_type != DeviceType.CPU),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile: decode step (4 slots) wall {wall_ms:.2f} ms under the "
        f"profiler, device busy {busy:.2f} ms -> idle share "
        f"{idle_share(busy, wall_ms):.3f}")
    for ms, n, key in rows[:12]:
        log(f"profile:   {ms:8.3f} ms  {n:5d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy,
                top=[dict(ms=ms, calls=n, name=key[:120])
                     for ms, n, key in rows[:12]])


@contextlib.contextmanager
def recording(module, name):
    """Record (args, kwargs, output) of every call of ``module.name`` made
    inside the block, passing each call through unchanged."""
    real, calls = getattr(module, name), []

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


# Relative L2 bound on one bf16 decode step's logits, fused kernel against
# the plain per-head path. The two compute the same function up to float32
# summation order (1.07e-6 apart in float32), but in bf16 every layer
# rounds its attention output and residual stream to 8 mantissa bits, and
# the 32-layer random-weight stack grows the rare one-ulp differences: the
# H100 reading was 3.07e-2, the same in two runs (PERF.md). The bound is
# twice that; the same plain path without its recency window, a different
# function, read 1.29e-1.
BF16_LOGITS_BOUND = 0.06


def decode_step_check(params, cfg, toks, smax):
    """The decode-step path. Prefill the four prompts into one cache, take
    one decode step through the planned fused kernel while recording each
    layer's call, and hold ops.loki_decode_two_kernel on each recorded
    call's inputs against its output; the counts are set to 0 just before
    and read just after. Then take the same step through the plain
    per-head path and compare the logits."""
    from repro_torch import kernels as K
    from repro_torch.core import loki
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cache, token, pos = prefilled_cache(params, cfg, toks, smax)

    def step(backend, **loki_kw):
        c = cfg.replace(loki=dataclasses.replace(cfg.loki, backend=backend,
                                                 **loki_kw))
        logits, _ = lm.decode_step(params, c, cache, token, pos)
        sync()
        return logits.float()

    # ---- the decode-step path: counts set to 0 just before, read just after
    K.reset_launch_counts()
    with recording(ops, "loki_decode_fused") as calls:
        fused = step("pallas")
    if len(calls) != cfg.n_layers:
        raise AssertionError(f"fused kernel called {len(calls)} times in a "
                             f"{cfg.n_layers}-layer step")
    two_err = 0.0
    for layer, (args, kwargs, out) in enumerate(calls):
        # the same q̂ and the same cache rows: the two-kernel pair selects
        # the same blocks (select_blocks' block maxima are the fused
        # kernel's bits) and attends them with the fused kernel's shares,
        # chunks and merge order (attend_share), so it gives its bits
        two = ops.loki_decode_two_kernel(*args, **kwargs)
        sync()
        two_err = max(two_err, float((two.float() - out.float()).abs().max()))
        if DEV == "cuda" and not torch.equal(two, out):
            raise AssertionError(f"layer {layer}: two_kernel differs from "
                                 f"fused (max |d| {two_err:.3e})")
        atol, rtol = tolerance(out.dtype)
        torch.testing.assert_close(
            two.float(), out.float(), atol=atol, rtol=rtol,
            msg=lambda m: f"layer {layer}: two_kernel vs fused: {m}")
    sync()
    counts = K.launch_counts()
    # ---- end of the decode-step path
    log(f"step: decode-step path launches {counts}; two_kernel vs fused "
        f"on each layer's inputs max|err| {two_err:.3e} (bit for bit on "
        f"the card, asserted)")
    check_launches("decode-step path", counts,
                   ("fused_loki_decode", "select_blocks",
                    "block_sparse_attention_grouped"), 1, cfg.n_layers)
    per_head = per_head_path(calls, cfg)

    # the step's own K/V rows are rewritten from its own layer inputs, so
    # each step reads the prefilled rows plus rows it wrote itself
    with recording(loki, "loki_decode_block") as plain_calls:
        plain = step("xla")
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    # where a bf16 gap comes from, layer by layer: the kernel against its
    # plain version on the kernel's own recorded inputs (rows whose block
    # maxima nearly tie left out), and the fused step's attention output
    # against the plain step's, each on its own layer inputs, the plain
    # one rounded to the activation dtype as attn_decode rounds it
    same_in, across, n_ties = [], [], 0
    for (args, kwargs, out), (_, _, p_out) in zip(calls, plain_calls):
        q, k, v, cur = args
        kw = {n: x for n, x in kwargs.items()
              if n not in ("page_table", "page_size", "k_scale", "v_scale",
                           "plan_rows")}
        kw["scale"] = kwargs["scale"] or v.shape[-1] ** -0.5
        want = F.fused_loki_decode_plain(q, k, v, cur, **kw)
        rows = ~near_tie_rows(F.block_scores_plain(
            q, k, cur, d=kw["d"], block_size=kw["block_size"],
            scale=kw["scale"], local_window=kw["local_window"],
            sliding_window=kw["sliding_window"]), kw["k_blocks"])
        n_ties += int((~rows).sum())
        atol, rtol = tolerance(out.dtype)
        torch.testing.assert_close(
            out.float()[rows], want.float()[rows], atol=atol, rtol=rtol,
            msg=lambda m: f"layer {len(same_in)}: fused vs plain: {m}")
        same_in.append(rel(out[rows], want[rows]))
        across.append(rel(out.reshape(p_out.shape), p_out.to(out.dtype)))
    del calls, plain_calls
    log(f"step: fused kernel vs its plain version on each layer's inputs: "
        f"rel-L2 max {max(same_in):.3e} over {len(same_in)} layers "
        f"(near-tie rows left out {n_ties})")
    log("step: attention output rel-L2, fused step vs xla step, by layer: "
        + ", ".join(f"{i}: {across[i]:.3e}" for i in
                    sorted({0, 1, 3, 7, 15, len(across) - 1})
                    if i < len(across)))
    # a negative control: the plain path without the recency window is a
    # different function, so its gap should stand well above the bound
    other = step("xla", local_window=0)
    del cache
    if DEV == "cuda":
        torch.cuda.empty_cache()
    for name, x in (("fused", fused), ("xla", plain)):
        if not torch.isfinite(x).all() or x.shape != (len(toks), cfg.vocab):
            raise AssertionError(f"{name} logits bad: {tuple(x.shape)}")
    gap, control = rel(fused, plain), rel(other, plain)
    same = int((fused.argmax(-1) == plain.argmax(-1)).sum())
    bound = BF16_LOGITS_BOUND if cfg.dtype == "bfloat16" else None
    log(f"step: one decode step in {cfg.dtype}, logits rel-L2 fused vs xla "
        f"{gap:.3e} ({'bound %g' % bound if bound else 'reported'}); "
        f"argmax equal {same}/{len(toks)}; xla without the recency window "
        f"vs xla {control:.3e} (a different function, reported)")
    if bound is not None and gap > bound:
        raise AssertionError(f"decode-step logits disagree beyond {bound}")
    return {"launches": counts, "per_head": per_head,
            "two_vs_fused_max_abs_err": two_err,
            "layer_rel_kernel_vs_plain_max": max(same_in),
            "layer_rel_fused_vs_xla_step": across,
            f"{cfg.dtype}_rel_fused_vs_xla": gap,
            f"{cfg.dtype}_rel_no_recency_vs_xla": control}


def per_head_views(args):
    """A recorded fused call's (B,Hkv,1,W) query and (B,S,Hkv,·) caches
    as the per-head pipeline's (B*Hkv, ·) rows (token-major copies), and
    cur_len repeated per head."""
    q, k, v, cur = args
    b, n_kv, g, w = q.shape
    if g != 1:
        raise AssertionError(f"per-head views need G = 1, got {g}")
    rows = lambda x: x.transpose(1, 2).reshape(b * n_kv, x.shape[1],
                                               x.shape[-1]).contiguous()
    return q.reshape(b * n_kv, w).contiguous(), rows(k), rows(v), \
        cur.repeat_interleave(n_kv)


def per_head_path(calls, cfg, d=32, k_blocks=8):
    """The per-head path on the decode step's 32 recorded fused calls
    (llama2-7b at full width, G = 1), flattened to (B*Hkv, ·) rows:
    ops.loki_decode_attention (token-major) and ops.loki_decode_attention_
    fm (a feature-major copy of K̂), each run counted on its own, held
    against ops.loki_decode_fused without its recency window on the same
    inputs (rows without a near-tie) and against each other."""
    from repro_torch import kernels as K
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import ops

    scale = cfg.resolved_head_dim ** -0.5
    fkw = dict(d=d, k_blocks=k_blocks, block_size=cfg.loki.block_size,
               scale=scale, local_window=0, sliding_window=0)
    fused, rows = [], []
    for args, _, _ in calls:
        q, k, v, cur = args
        fused.append(ops.loki_decode_fused(q, k, v, cur, **fkw).reshape(
            -1, v.shape[-1]))
        rows.append(~near_tie_rows(F.block_scores_plain(
            q, k, cur, d=d, block_size=fkw["block_size"], scale=scale),
            k_blocks).reshape(-1))
    kw = dict(d=d, k_blocks=k_blocks, block_size=fkw["block_size"])

    # ---- the per-head path: counts set to 0 just before, read just after
    K.reset_launch_counts()
    tm = [ops.loki_decode_attention(*per_head_views(args), **kw)
          for args, _, _ in calls]
    sync()
    counts_tm = K.launch_counts()
    # ---- end of the per-head path
    check_launches("per-head path", counts_tm,
                   ("block_max_scores", "block_sparse_attention"), 1,
                   cfg.n_layers)

    # ---- the feature-major per-head path, counted on its own; the peak
    # device memory of each call shows that no copy of K̂ᵀ is made
    K.reset_launch_counts()
    fm, extra = [], 0
    for args, _, _ in calls:
        q, k, v, cur = per_head_views(args)
        kT = k.transpose(1, 2).contiguous()
        k_bytes = kT.numel() * kT.element_size()
        del k
        if DEV == "cuda":
            sync()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        fm.append(ops.loki_decode_attention_fm(q, kT, v, cur, **kw))
        if DEV == "cuda":
            sync()
            extra = max(extra, torch.cuda.max_memory_allocated() - base)
        del kT
    sync()
    counts_fm = K.launch_counts()
    # ---- end of the feature-major per-head path
    if extra > k_bytes / 16:
        raise AssertionError(f"an fm pipeline call allocated {extra} B, "
                             f"against a K̂ of {k_bytes} B")
    check_launches("per-head fm path", counts_fm,
                   ("block_max_scores_fm", "block_sparse_attention"), 1,
                   cfg.n_layers)

    atol, rtol = tolerance(tm[0].dtype)
    err, err_fm, n_ties, same = 0.0, 0.0, 0, 0
    for layer, (a, b, c, r) in enumerate(zip(tm, fm, fused, rows)):
        torch.testing.assert_close(
            a.float()[r], c.float()[r], atol=atol, rtol=rtol,
            msg=lambda m: f"layer {layer}: per-head vs fused: {m}")
        torch.testing.assert_close(
            b.float(), a.float(), atol=atol, rtol=rtol,
            msg=lambda m: f"layer {layer}: fm vs token-major: {m}")
        err = max(err, float((a.float() - c.float())[r].abs().max()))
        err_fm = max(err_fm, float((b.float() - a.float()).abs().max()))
        n_ties += int((~r).sum())
        same += int(torch.equal(a, b))
    log(f"per-head: launches token-major {counts_tm}, feature-major "
        f"{counts_fm}; per-head vs fused (local_window 0) max|err| "
        f"{err:.3e} over {len(tm)} layers (near-tie rows left out "
        f"{n_ties}); fm vs token-major max|err| {err_fm:.3e}, bit-equal in "
        f"{same}/{len(tm)} layers; an fm call's extra device memory at "
        f"most {extra} B (atol {atol}, rtol {rtol})")
    return {"launches": {"per_head": counts_tm, "per_head_fm": counts_fm},
            "vs_fused_max_abs_err": err, "fm_vs_tm_max_abs_err": err_fm,
            "near_tie_rows": n_ties, "fm_extra_bytes": extra}


PREFILL_TOKENS = 3072          # a multiple of 128: JAX's flash contract


def prefill_flash(results, params, cfg, smax=4096):
    """The prefill-flash path: one 3072-token prompt through lm.prefill at
    full width with causal_attention's q, k, v recorded on every layer;
    ops.flash(causal=True) on each layer's (H, S, D) views, counted on its
    own and held against the plain flash version within FLASH_BF16_BOUND
    and FLASH_BF16_REL_L2.
    The gap to the model's own causal_attention output is reported: the
    model scales a bf16 q before the dot, flash scales the float32
    scores."""
    from repro_torch import kernels as K
    from repro_torch.core import attention as A
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    toks = prompts(cfg.vocab, [PREFILL_TOKENS], seed=13)[0]
    heads = lambda x: x[0].transpose(0, 1).contiguous()     # (H, S, D)
    with recording(A, "causal_attention") as calls:
        lm.prefill(params, cfg, torch.as_tensor(toks[None], device=DEV),
                   smax)
        sync()
    if len(calls) != cfg.n_layers:
        raise AssertionError(f"causal_attention called {len(calls)} times "
                             f"in a {cfg.n_layers}-layer prefill")
    views = [tuple(heads(x) for x in args[:3]) for args, _, _ in calls]
    model = [heads(out) for _, _, out in calls]
    del calls
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # ---- the prefill-flash path: counts set to 0 just before, read after
    K.reset_launch_counts()
    outs = [ops.flash(q, k, v, causal=True) for q, k, v in views]
    sync()
    counts = K.launch_counts()
    # ---- end of the prefill-flash path
    check_launches("prefill-flash path", counts, ("flash_attention",), 1,
                   cfg.n_layers)
    err, rel, ratio, gap = 0.0, 0.0, 0.0, []
    for layer, ((q, k, v), out, ref) in enumerate(zip(views, outs, model)):
        e, r, t = check_flash_close(out, q, k, v, True,
                                    f"prefill layer {layer}")
        err, rel, ratio = max(err, e), max(rel, r), max(ratio, t or 0.0)
        gap.append(float((out.float() - ref.float()).norm()
                         / ref.float().norm()))
    log(f"prefill-flash: {cfg.n_layers} layers of ({views[0][0].shape[0]}, "
        f"{PREFILL_TOKENS}, {views[0][0].shape[-1]}) {views[0][0].dtype}, "
        f"launches {counts}; flash vs plain max|err| {err:.3e}, rel-L2 "
        f"{rel:.3e}, largest err / bound {ratio:.3f} ({FLASH_BF16_BOUND}); "
        f"rel-L2 to the model's causal_attention, by layer (reported): "
        + ", ".join(f"{i}: {gap[i]:.3e}" for i in
                    sorted({0, 1, 15, len(gap) - 1}) if i < len(gap)))
    results.setdefault("launches", {})["prefill_flash"] = counts
    results["prefill_flash"] = dict(max_abs_err=err, rel_l2=rel,
                                    err_over_bound=ratio,
                                    rel_l2_to_model=gap)


# --------------------------------------------------------------------- main

# ------------------------------------------------------------------ train

TRAIN_ARCH = "qwen2.5-3b"
TRAIN_STEPS = 6
#: 3 steps of the smoke models on the card against the port's CPU path
TRAIN_PAIRS = ("qwen2.5-3b", "granite-moe-3b-a800m")
#: the CPU tests' train config (tests/test_torch_train.py)
TRAIN_SMALL = dict(lr=1e-3, warmup_steps=2, total_steps=20, seed=0)


def train_published(*, arch=TRAIN_ARCH, steps=TRAIN_STEPS,
                    smoke=False):
    """(a) ``arch`` at published width, every layer: float32 masters from
    the port's seeded init, bf16 compute, the TrainConfig and DataConfig
    ``launch/train.py`` builds for ``--steps steps`` (8 x 128 tokens),
    ``steps`` steps through ``make_train_step``, no checkpoint. Asserts
    finite losses and grad norms, a first loss within 1.0 of ln V and a
    last loss below the first. Step ms: host clock around a synchronised
    step; AdamW ms: CUDA events around ``adamw.apply_updates``; both the
    median of steps 2 on."""
    import math

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.synthetic import SyntheticLM, torch_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.training import step as tstep

    args = train_cli.parse_args(["--arch", arch, "--steps", str(steps)])
    cfg = (get_smoke_config if smoke else get_config)(arch)
    tcfg, dcfg = train_cli.train_config(args), train_cli.data_config(
        cfg, args)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=tcfg.seed, device=DEV, dtype=cfg.param_dtype)
    state = tstep.TrainState(params, adamw.init_state(params))
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tensors_of(params))
    state_gb = (torch.cuda.memory_allocated() / 1e9 if DEV == "cuda"
                else float("nan"))
    log(f"train: {cfg.arch}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {n_params / 1e9:.3f} B parameters in "
        f"{cfg.param_dtype}, compute {cfg.dtype}; params + AdamW moments "
        f"{state_gb:.2f} GB allocated after init ({init_s:.1f} s)")

    opt_times = []
    real = adamw.apply_updates

    def timed(*a, **kw):
        if DEV != "cuda":
            t = time.perf_counter()
            out = real(*a, **kw)
            opt_times.append((time.perf_counter() - t) * 1e3)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **kw)
        end.record()
        opt_times.append((start, end))
        return out

    data = SyntheticLM(dcfg)
    step_fn = tstep.make_train_step(cfg, tcfg)
    step_ms, losses, gnorms = [], [], []
    adamw.apply_updates = timed
    try:
        for i in range(steps):
            batch = torch_batch(data.batch_at(i), DEV)
            sync()
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            sync()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    finally:
        adamw.apply_updates = real
    opt_ms = [x if DEV != "cuda" else x[0].elapsed_time(x[1])
              for x in opt_times]
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda"
               else float("nan"))
    profile = (profile_train_step(step_fn, state, torch_batch(
        data.batch_at(steps), DEV)) if DEV == "cuda" else None)
    del state, params, m
    if DEV == "cuda":
        torch.cuda.empty_cache()
    ln_v = math.log(cfg.vocab)
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train: non-finite loss or grad norm: "
                             f"{losses} {gnorms}")
    if abs(losses[0] - ln_v) > 1.0:
        raise AssertionError(f"train: first loss {losses[0]:.4f} is not "
                             f"within 1.0 of ln V = {ln_v:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: last loss {losses[-1]:.4f} is not "
                             f"below the first {losses[0]:.4f}")
    tokens = dcfg.global_batch * dcfg.seq_len
    med_step = statistics.median(step_ms[1:])
    med_opt = statistics.median(opt_ms[1:])
    out = {"arch": cfg.arch, "n_layers": cfg.n_layers,
           "n_params": n_params, "tokens_per_step": tokens,
           "train_config": dataclasses.asdict(tcfg),
           "init_s": init_s, "state_gb": state_gb, "peak_gb": peak_gb,
           "step_ms": step_ms, "adamw_ms": opt_ms,
           "step_ms_median": med_step, "adamw_ms_median": med_opt,
           "adamw_share": med_opt / med_step,
           "tokens_per_s": tokens / (med_step / 1e3),
           "losses": losses, "grad_norms": gnorms, "ln_vocab": ln_v,
           "profile": profile}
    log(f"train: {steps} steps of {tokens} tokens: step {med_step:.2f} ms "
        f"(median of steps 2-{steps}; all {[round(x, 2) for x in step_ms]}),"
        f" AdamW {med_opt:.2f} ms ({med_opt / med_step:.3f} of the step), "
        f"{tokens / (med_step / 1e3):.0f} tok/s, peak "
        f"{peak_gb:.2f} GB allocated")
    log(f"train: losses {[round(x, 4) for x in losses]} (ln V "
        f"{ln_v:.4f}), grad norms {[round(x, 3) for x in gnorms]}")
    return out


def profile_train_step(step_fn, state, batch):
    """Where a train step's time goes: torch.profiler device time by
    kernel over one more step (not among the measured ones), against its
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(((dev_us(e) / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if dev_us(e) > 0 and e.device_type != DeviceType.CPU),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"train profile: one step wall {wall_ms:.2f} ms under the "
        f"profiler, device busy {busy:.2f} ms -> idle share "
        f"{idle_share(busy, wall_ms):.3f}; {sum(r[1] for r in rows)} "
        f"device ops")
    for ms, n, key in rows[:15]:
        log(f"train profile:   {ms:8.3f} ms  {n:5d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy,
                device_ops=sum(r[1] for r in rows),
                top=[dict(ms=ms, calls=n, name=key[:120])
                     for ms, n, key in rows[:15]])


def _train_run(cfg, tcfg, np_params, data, steps, device):
    """``steps`` steps from ``np_params`` on ``device`` -> (losses, grad
    norms, final params as numpy by path)."""
    from repro_torch.data.synthetic import torch_batch
    from repro_torch.models import lm
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.training import step as tstep

    params = params_from_numpy(np_params, cfg, device=device)
    state = tstep.TrainState(params, adamw.init_state(params))
    step_fn = tstep.make_train_step(cfg, tcfg)
    losses, gnorms = [], []
    for i in range(steps):
        state, m = step_fn(state, torch_batch(data.batch_at(i), device))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms, {p: x.cpu().numpy()
                            for p, x in lm.tree_items(state.params)}


def train_card_vs_cpu(*, archs=TRAIN_PAIRS, steps=3):
    """(b) The smoke models in float32, ``steps`` steps on the card and
    on the port's CPU path from the same numpy params and batches: losses
    and grad norms within rtol 1e-4, every parameter within atol 1e-4
    (the worst difference is reported)."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.models import lm

    tcfg = TrainConfig(**TRAIN_SMALL)
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        init = lm.init(cfg, seed=0, device="cpu", dtype="float32")
        np_params = lm.tree_map(lambda t: t.numpy(), init)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4, seed=1))
        card = _train_run(cfg, tcfg, np_params, data, steps, DEV)
        host = _train_run(cfg, tcfg, np_params, data, steps, "cpu")
        for got, want, what in ((card[0], host[0], "losses"),
                                (card[1], host[1], "grad norms")):
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       err_msg=f"train {arch}: {what}")
        for path, x in card[2].items():
            np.testing.assert_allclose(x, host[2][path], rtol=0, atol=1e-4,
                                       err_msg=f"train {arch}: {path}")
        worst = max(float(np.abs(x - host[2][p]).max())
                    for p, x in card[2].items())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], host[0]))
        out[cfg.arch] = {"losses_card": card[0], "losses_cpu": host[0],
                         "loss_max_rel": loss_rel, "param_max_abs": worst}
        log(f"train: {cfg.arch} {steps} steps card vs cpu (float32): loss "
            f"rel {loss_rel:.2e}, params max abs {worst:.2e} (atol 1e-4)")
    return out


def train_resume(*, fail_at=7, n_steps=12):
    """(c) tests/test_runner.py's crash and resume on the card: the
    llama2-7b smoke model through ``TrainRunner`` and
    ``run_with_restarts`` with ``FailureInjector(fail_at)``, checkpoints
    every 5 steps in a temporary directory; the resumed losses against
    the uninterrupted run's within rtol 1e-5, bit-equality reported.
    Then each smoke model's gradients twice from the same state and
    batch: the leaves that differ name the card's non-deterministic
    ops."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import DataConfig, SyntheticLM, \
        torch_batch
    from repro_torch.models import lm
    from repro_torch.training import step as tstep
    from repro_torch.training.runner import (FailureInjector, TrainRunner,
                                             run_with_restarts)

    cfg = get_smoke_config("llama2-7b")
    tcfg = TrainConfig(**TRAIN_SMALL)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    with tempfile.TemporaryDirectory() as d:
        ref = TrainRunner(cfg, tcfg, dcfg, os.path.join(d, "ref"),
                          ckpt_every=5, device=DEV).run(n_steps)
        inj = FailureInjector(fail_at=fail_at)
        got = run_with_restarts(
            lambda: TrainRunner(cfg, tcfg, dcfg, os.path.join(d, "crash"),
                                ckpt_every=5, device=DEV), n_steps,
            injector=inj)
    want = [m["loss"] for m in ref["metrics"]]
    resumed = [m["loss"] for m in got["metrics"]]
    if not inj.fired or len(resumed) != n_steps - 5:
        raise AssertionError(f"train resume: fired {inj.fired}, "
                             f"{len(resumed)} steps after the restart")
    np.testing.assert_allclose(resumed, want[-len(resumed):], rtol=1e-5,
                               err_msg="train resume: losses")
    bit_equal = resumed == want[-len(resumed):]
    params_equal = all(
        torch.equal(x, y) for (_, x), (_, y) in zip(
            lm.tree_items(got["state"].params),
            lm.tree_items(ref["state"].params)))
    nondet = {}
    for arch in ("llama2-7b", "granite-moe-3b-a800m"):
        c = get_smoke_config(arch)
        params = lm.init(c, seed=0, device=DEV, dtype="float32")
        batch = torch_batch(SyntheticLM(DataConfig(
            vocab=c.vocab, seq_len=32, global_batch=4, seed=1)).batch_at(0),
            DEV)
        g1 = tstep.grads_of(params, batch, c, tcfg)[0]
        g2 = tstep.grads_of(params, batch, c, tcfg)[0]
        nondet[c.arch] = [k for (k, x), (_, y) in zip(
            lm.tree_items(g1), lm.tree_items(g2)) if not torch.equal(x, y)]
    log(f"train resume: restart at step {fail_at}, resumed from step 5: "
        f"losses within rtol 1e-5 of the uninterrupted run, bit-equal "
        f"{bit_equal}, final params bit-equal {params_equal}; gradient "
        f"leaves that differ between two identical backward passes: "
        f"{nondet}")
    return {"bit_equal": bit_equal, "params_bit_equal": params_equal,
            "losses": resumed, "reference": want[-len(resumed):],
            "max_rel": max(abs(a - b) / abs(b) for a, b in
                           zip(resumed, want[-len(resumed):])),
            "nondeterministic_grad_leaves": nondet}


def train_cli_twice(steps=3):
    """(d) ``python -m repro_torch.launch.train --arch qwen2.5-3b --smoke
    --steps 3`` twice against one checkpoint directory: both exit 0, the
    second resumes from step 3."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "qwen2.5-3b", "--smoke", "--steps", str(steps), "--ckpt-dir",
               d] + (["--device", "cpu"] if DEV == "cpu" else [])
        runs = []
        for _ in range(2):
            t = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600, env=env, cwd=ROOT)
            runs.append((r, time.perf_counter() - t))
    for i, (r, _) in enumerate(runs):
        if r.returncode != 0:
            raise AssertionError(f"train CLI run {i + 1} exited "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
    resume = f"resumed from checkpoint step {steps}"
    if resume in runs[0][0].stdout or resume not in runs[1][0].stdout:
        raise AssertionError(f"train CLI: no resume line on the second run:"
                             f" {runs[1][0].stdout}")
    for i, (r, s) in enumerate(runs):
        log(f"train CLI run {i + 1} ({s:.1f} s): "
            + " | ".join(r.stdout.strip().splitlines()))
    return {"stdout": [r.stdout for r, _ in runs],
            "wall_s": [s for _, s in runs]}


def train(results, *, smoke=False):
    """The training path: (a) qwen2.5-3b at published width, (b) the
    smoke models on the card against the port's CPU path, (c) crash and
    resume, (d) the CLI twice; (e) no kernel wrapper launches during any
    of it."""
    from repro_torch import kernels as K

    t0 = time.perf_counter()
    if DEV == "cuda":
        log(f"train: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
            f"allocated before the phase; {card_state()}")
    K.reset_launch_counts()
    out = {"published": train_published(smoke=smoke),
           "card_vs_cpu": train_card_vs_cpu(), "resume": train_resume(),
           "cli": train_cli_twice()}
    counts = K.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"train: kernel wrappers launched {counts}")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t0
    if DEV == "cuda":
        log(f"train: {card_state()}")
    log(f"train: no kernel launched ({counts}); phase {out['wall_s']:.1f} s")
    results["train"] = out


SOURCES = {
    "fused_loki_decode": ("src/repro_torch/csrc/fused_decode.cu",
                          "src/repro/kernels/fused_decode.py:248",
                          "paged_loki_block"),
    "select_blocks": ("src/repro_torch/csrc/fused_decode.cu",
                      "src/repro/kernels/fused_decode.py:439",
                      "paged_tiered_min"),
    "block_sparse_attention_grouped": (
        "src/repro_torch/csrc/gather_attention.cu",
        "src/repro/kernels/gather_attention.py:368", "paged_tiered_min"),
    "paged_full_decode": ("src/repro_torch/csrc/gather_attention.cu",
                          "src/repro/kernels/gather_attention.py:215",
                          "paged_full"),
    "fused_exact_topk_decode": ("src/repro_torch/csrc/fused_decode.cu",
                                "src/repro/kernels/fused_decode.py:328",
                                "paged_exact_topk"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:67",
                        "prefill_flash"),
    "block_max_scores": ("src/repro_torch/csrc/approx_scores.cu",
                         "src/repro/kernels/approx_scores.py:50",
                         "per_head"),
    "block_sparse_attention": ("src/repro_torch/csrc/gather_attention.cu",
                               "src/repro/kernels/gather_attention.py:75",
                               "per_head"),
    "block_max_scores_fm": ("src/repro_torch/csrc/approx_scores.cu",
                            "src/repro/kernels/approx_scores_fm.py:54",
                            "per_head_fm"),
}


#: the granite paths and, per kernel, the one that runs it at fp32 (None:
#: the planner picks another kernel at granite's shape)
GRANITE_RUN_PATHS = tuple(f"paged_granite_{p}" for p in GRANITE_POLICIES) \
    + ("paged_granite_fp32_loki_block",)
GRANITE_PATHS = {
    "fused_loki_decode": "paged_granite_loki_block",
    "select_blocks": None,
    "block_sparse_attention_grouped": None,
    "paged_full_decode": "paged_granite_full",
    "fused_exact_topk_decode": "paged_granite_exact_topk",
}


#: the families phase's paths (fp32 and bf16 pools: the kernels' float32
#: library) and, per kernel, the one that runs it at the case's shape
WHISPER_RUN_PATHS = tuple(f"paged_whisper_{d}{p}" for d in ("", "fp32_")
                          for p in GRANITE_POLICIES)
MIXTRAL_RUN_PATHS = ("paged_mixtral_loki_block", "paged_mixtral_full",
                     "paged_mixtral_fp32_loki_block",
                     "paged_mixtral_groups_loki_block",
                     "mixtral_recycled_step", "mixtral_groups_recycled_step")
LLAVA_RUN_PATHS = ("paged_llava_loki_block",)
HYMBA_RUN_PATHS = tuple(f"paged_hymba_{d}{p}" for d in ("", "fp32_")
                        for p in GRANITE_POLICIES) + (
    "paged_hymba_fp32_loki_block_masked",)
#: the runs at HYMBA_SHORT_SMAX (the short case's shape)
HYMBA_SHORT_RUN_PATHS = ("paged_hymba_fp32_tight", "paged_hymba_fp32_restore",
                         "paged_hymba_tiered_single",
                         "paged_hymba_tiered_min")
#: per timed case of CASE_KEYS: its label in the kernels line, the paths
#: run at its shape, and per kernel the path that runs it (absent: the
#: planner picks another kernel at that shape)
CASE_PATHS = {
    "granite": ("granite-moe-3b", GRANITE_RUN_PATHS, GRANITE_PATHS),
    "whisper": ("whisper-small", WHISPER_RUN_PATHS, {
        "fused_loki_decode": "paged_whisper_loki_block",
        "paged_full_decode": "paged_whisper_full",
        "fused_exact_topk_decode": "paged_whisper_exact_topk"}),
    "mixtral": ("mixtral-8x22b-swa", MIXTRAL_RUN_PATHS, {
        "fused_loki_decode": "paged_mixtral_loki_block",
        "paged_full_decode": "paged_mixtral_full"}),
    "llava": ("llava-next-mistral-7b", LLAVA_RUN_PATHS, {
        "fused_loki_decode": "paged_llava_loki_block"}),
    "hymba": ("hymba-1.5b", HYMBA_RUN_PATHS, {
        "fused_loki_decode": "paged_hymba_loki_block",
        "paged_full_decode": "paged_hymba_full",
        "fused_exact_topk_decode": "paged_hymba_exact_topk"}),
    "hymba_short": ("hymba-1.5b smax=1024", HYMBA_SHORT_RUN_PATHS, {
        "fused_loki_decode": "paged_hymba_tiered_single",
        "select_blocks": "paged_hymba_tiered_min",
        "block_sparse_attention_grouped": "paged_hymba_tiered_min"}),
}


#: the storage modes' TPU kernel bodies (the ``quant=True`` branches that
#: multiply each block by its page scale after its DMA) and the path of
#: each kernel at a layout run on (None: the kernel phase only)
SCALED_BODIES = {
    "fused_loki_decode": "src/repro/kernels/fused_decode.py:134",
    "select_blocks": "src/repro/kernels/fused_decode.py:402",
    "block_sparse_attention_grouped":
        "src/repro/kernels/gather_attention.py:303",
    "paged_full_decode": "src/repro/kernels/gather_attention.py:115",
    "fused_exact_topk_decode": "src/repro/kernels/fused_decode.py:134",
}
LAYOUT_PATHS = {
    ("fused_loki_decode", "int8:pca:r=32"): "paged_int8pca_loki_block",
    ("select_blocks", "int8:pca:r=32"): "paged_int8pca_step",
    ("block_sparse_attention_grouped", "int8:pca:r=32"): "paged_int8pca_step",
    ("paged_full_decode", "int8:pca:r=32"): "paged_int8pca_full",
    ("fused_exact_topk_decode", "int8:pca:r=32"): "paged_int8pca_exact_topk",
    ("fused_loki_decode", "fp8"): "paged_fp8_loki_block",
}
#: the paths whose pools hold int8 or fp8 codes (their decode kernels run
#: those storage modes only)
LAYOUT_RUNS = set(LAYOUT_PATHS.values()) | {
    "paged_int8pca_prefix_loki_block", "paged_int8pca_prefix_loki_block_off",
    "paged_whisper_int8_loki_block"
} | {path for layout, policy, _ in FAULT2_RUNS if layout
     for path in fault2_pair(layout, policy)}


def case_entries(results, launches, keys=tuple(CASE_PATHS)):
    """The kernels line's entries of kernels 1-5 at granite-moe-3b's
    decode shape (G 3, D 64, d 16), at the window and encoder families'
    (whisper, mixtral, llava) and at hymba's two contexts: one per
    (kernel, case)."""
    out = []
    for key in keys:
        label, run_paths, by_kernel = CASE_PATHS[key]
        for name in KERNELS:
            t = results[f"{key}_timing"][name]
            path = by_kernel.get(name)
            out.append({
                "name": f"{name}[{label}]", "route": "cuda",
                "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                "path": path,
                "launches": launches.get(path, {}).get(name, 0)
                if path else 0,
                "launches_by_path": {p: launches.get(p, {}).get(name, 0)
                                     for p in run_paths},
                "max_abs_err": results[key]["errs"][name],
                "ms": t["ms"], "paged_ms": t["paged_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return out


def ptxas_summary(text):
    """A ptxas -v log in a few lines: the kernel count, the register range
    and the kernels that spill; each tensor-core flash kernel and each
    instantiation of the two block-list cluster kernels, the select_blocks
    cluster kernel and the two block_max_scores kernels on its own line;
    any line about wgmma (a serialised wgmma would show there)."""
    kernels, out, name = [], [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_ZN4loki(?:2tc)?\d+(\w+?)"
                      r"I(\w*?)EEv", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        elif "spill stores" in line:
            spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and "registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            kernels.append((name, regs, spill))
            if re.match(r"(flash_tc|grouped_cluster|head_cluster|"
                        r"select_cluster|block_max_scores_kernel|"
                        r"block_max_scores_fm_kernel)", name):
                out.append(f"{name}: {regs} registers, {spill} B spilled")
            name = None
        if "wgmma" in line or "warpgroup" in line:
            out.append(line.strip()[:160])
    if kernels:
        regs = [r for _, r, _ in kernels]
        spills = [f"{n} ({b} B)" for n, _, b in kernels if b]
        out.insert(0, f"{len(kernels)} kernels, {min(regs)}-{max(regs)} "
                   f"registers, spilling: {', '.join(spills) or 'none'}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["kernels", "train", "families",
                                       "recurrent"], default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.serving import paged_cache as PC

    t_start = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    _LOG.append(open(os.path.join(out_dir, "chip_smoke.log"), "w"))
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    if args.only == "train":
        results = {}
        train(results)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        with open(os.path.join(out_dir, "chip_smoke_train.json"), "w") as fh:
            json.dump({"card": card, "train": results["train"]}, fh,
                      indent=1)
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    secs = _build.build_all()
    log(f"build: {len(_build.LIBRARIES)} CUDA libraries built with nvcc "
        f"(sm_90a) in {secs:.1f} s")
    for name in _build.LIBRARIES:
        text = _build.build_log(name)
        with open(os.path.join(out_dir, f"ptxas_{name}.log"), "w") as fh:
            fh.write(text)
        for line in ptxas_summary(text):
            log(f"ptxas {name}: {line}")
    sass = _build.sass("flash_attention")
    n_hgmma = sass.count("HGMMA")
    if not n_hgmma:
        raise AssertionError("the built flash_attention library holds no "
                             "wgmma (HGMMA) instruction")
    log(f"build: flash_attention's library holds {n_hgmma} HGMMA (wgmma) "
        "instructions")

    results = {}
    if args.only == "families":
        # the families' kernel cases, then their serving paths
        families = {k: CASE_KEYS[k] for k in (WHISPER_CASE, MIXTRAL_CASE,
                                              LLAVA_CASE)}
        check_kernels(results, only=families)
        check_paged(results, only=families)
        time_cases(results, only=families)
        log(f"kernels done at {time.perf_counter() - t_start:.1f} s")
        serve_families(results)
        log(f"families done at {time.perf_counter() - t_start:.1f} s")
        kernels = case_entries(results, results.get("launches", {}),
                               keys=("whisper", "mixtral", "llava"))
        with open(os.path.join(out_dir, "chip_smoke_families.json"),
                  "w") as fh:
            json.dump({"card": card, "build_s": secs,
                       "script_s": time.perf_counter() - t_start,
                       "kernels": kernels,
                       "launches": results.get("launches"),
                       "families_serve": results.get("families_serve")},
                      fh, indent=1)
        log(card)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only == "recurrent":
        # hymba's kernel case, then the recurrent-state families' paths
        hymba = {k: CASE_KEYS[k] for k in (HYMBA_CASE, HYMBA_SHORT_CASE)}
        check_kernels(results, only=hymba)
        check_paged(results, only=hymba)
        time_cases(results, only=hymba)
        log(f"kernels done at {time.perf_counter() - t_start:.1f} s")
        serve_recurrent(results)
        log(f"recurrent done at {time.perf_counter() - t_start:.1f} s")
        kernels = case_entries(results, results.get("launches", {}),
                               keys=("hymba", "hymba_short"))
        with open(os.path.join(out_dir, "chip_smoke_recurrent.json"),
                  "w") as fh:
            json.dump({"card": card, "build_s": secs,
                       "script_s": time.perf_counter() - t_start,
                       "kernels": kernels,
                       "launches": results.get("launches"),
                       "recurrent_serve": results.get("recurrent_serve")},
                      fh, indent=1)
        log(card)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    check_kernels(results)
    check_layouts(results)
    check_packed_widths(results)
    check_paged(results)
    check_tiered_kernels(results)
    check_no_fallback()
    check_head_kernels(results)
    check_flash(results)
    check_head_raises()
    time_kernels(results)
    time_cases(results)
    log_storage_against_fp32(results)
    time_head_kernels(results)
    log(f"kernels done at {time.perf_counter() - t_start:.1f} s")
    if args.only != "kernels":
        params, cfg, toks, greedy = serve(results)
        log(f"dense paths done at {time.perf_counter() - t_start:.1f} s")
        serve_paged(results, params, cfg, toks, greedy)
        log(f"paged paths done at {time.perf_counter() - t_start:.1f} s")
        serve_tiered(results, params, cfg, toks)
        log(f"tiered paths done at {time.perf_counter() - t_start:.1f} s")
        check_fault2(results)
        prefill_flash(results, params, cfg)
        del params
        if DEV == "cuda":
            torch.cuda.empty_cache()
        serve_granite(results)
        log(f"granite paths done at {time.perf_counter() - t_start:.1f} s")
        serve_families(results)
        log(f"families paths done at {time.perf_counter() - t_start:.1f} s")
        serve_recurrent(results)
        log(f"recurrent paths done at {time.perf_counter() - t_start:.1f} s")
        # the serving phases' models and pools go before training
        del cfg, toks, greedy
        gc.collect()
        torch.cuda.empty_cache()
        train(results)
        log(f"train done at {time.perf_counter() - t_start:.1f} s")
    launches = results.get("launches", {})

    errs = dict(results["main"]["errs"], **results["errs"])
    kernels = []
    for name, (src, replaces, path) in SOURCES.items():
        t = results["timing"][name]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": path,
            "launches": launches.get(path, {}).get(name, 0),
            # a decode kernel's float32 and bfloat16 modes: every path but
            # those that run a storage mode of its own (listed there)
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in launches.items()
                                 if name not in KERNELS
                                 or p not in LAYOUT_RUNS},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}
        for extra in ("fp32_body_ms", "fm_ms"):
            if extra in t:
                entry[extra] = t[extra]
        if name in KERNELS:
            entry.update(paged_ms=t["paged_ms"],
                         full_attention_sdpa_ms_not_same_function=results[
                             "sdpa_ms"])
        kernels.append(entry)
    kernels += case_entries(results, launches)
    # the storage modes of kernels 1-5, one entry per (kernel, layout)
    for key, t in results["layout_timing"].items():
        name, tag = key[:-1].split("[")
        path = LAYOUT_PATHS.get((name, tag))
        storage = str(PC.STORAGE_DTYPE[tag.split(":")[0]])[len("torch."):]
        _, fused_lib, attn_lib = _build.STORAGE[storage]
        lib = fused_lib if "fused_decode" in SOURCES[name][0] else attn_lib
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[name][0],
            "library": f"{lib} ({' '.join(_build.LIBRARIES[lib][1])})",
            "replaces": SCALED_BODIES[name] if not tag.startswith("fp16")
            else SOURCES[name][1], "path": path,
            "launches": launches.get(path, {}).get(name, 0) if path else 0,
            # only the path that runs this storage mode launched it
            "launches_by_path": ({path: launches.get(path, {}).get(name, 0)}
                                 if path else {}),
            "max_abs_err": results["layout_errs"][key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "build_s": secs,
                   "script_s": time.perf_counter() - t_start,
                   "kernels": kernels,
                   "launches": launches, "serve": results.get("serve"),
                   "paged_serve": results.get("paged_serve"),
                   "baselines": results.get("baselines"),
                   "fault2": results.get("fault2"),
                   "granite_serve": results.get("granite_serve"),
                   "families_serve": results.get("families_serve"),
                   "recurrent_serve": results.get("recurrent_serve"),
                   "prefill_flash": results.get("prefill_flash"),
                   "train": results.get("train"),
                   "profile": results.get("profile"),
                   "fused_plans": results.get("fused_plans"),
                   "head_plans": results.get("head_plans"),
                   "layout_plans": results.get("layout_plans"),
                   "packed_widths": results.get("packed_widths")}, fh,
                  indent=1)
    log(card)                   # as nvidia-smi prints it: name, limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for fh in _LOG:
            fh.close()
    sys.exit(code)
