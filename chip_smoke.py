"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --only kernels # build + kernel checks only

Phases, each of which fails the run on any error:
  1. build   the CUDA sources in src/repro_torch/csrc with nvcc (sm_90a);
  2. kernels hold fused_loki_decode, select_blocks and
             block_sparse_attention_grouped against their plain torch
             versions at llama2-7b and qwen2.5-3b decode shapes (plus a
             sliding-window, a head_dim-256 and a short-cur_len case, fp32
             and bf16 caches), time each at the main-path shape, and check
             that a CUDA shape no kernel plan takes raises;
  3. serve   the main path: llama2-7b at full width through the dense
             engine with the loki_block policy, 4 long prompts, 16 new
             tokens each, the launch counters proving every layer of every
             tick ran the planned kernel and no other;
  4. step    the decode-step path: one decode step of all four slots
             through the fused kernel, each layer's call repeated through
             ops.loki_decode_two_kernel on the same inputs (its own launch
             counts), and the step's logits held against the plain
             per-head path; then a torch.profiler breakdown of one decode
             step and greedy agreement of a whole run with the plain path.
The second-to-last line is a JSON object listing the kernels; the last is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores
NEG_INF = -1e30
DEV = "cuda"


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


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


def kernel_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    llama = dict(B=4, Hkv=32, G=1, D=128, S=4096, bs=128, d=32, kb=8, lw=16,
                 sw=0, cur=[3000, 2500, 1800, 3100])
    qwen = dict(llama, Hkv=2, G=8)
    return [
        # the main path: bf16 queries over the dense engine's fp32 cache
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


def bounds(case, sel):
    """bound_ms of the three kernels (bytes each input read once, each
    output written once; float32 operations at 67 TFLOP/s)."""
    q, k, v = case["q"], case["k"], case["v"]
    B, Hkv, G, W = q.shape
    D = v.shape[-1]
    d, kb = case["d"], case["kb"]
    ksz, qsz = k.element_size(), q.element_size()
    scored, won = live_work(case, sel)
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
    }


def check_kernels(results):
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA

    for case in kernel_cases():
        q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
        dim = v.shape[-1]
        kw = dict(d=case["d"], k_blocks=case["kb"], block_size=case["bs"],
                  local_window=case["lw"], sliding_window=case["sw"])
        scale = dim ** -0.5
        blk = F.block_scores_plain(q, k, cur, d=case["d"],
                                   block_size=case["bs"], scale=scale,
                                   local_window=case["lw"],
                                   sliding_window=case["sw"])
        ties = near_tie_rows(blk, case["kb"])
        # select_blocks at the fused kernel's scale, so all three share
        # one selection
        sel_k = F.select_blocks(q, k, cur, scale=scale, **kw)
        sel_p = F.select_blocks_plain(q, k, cur, scale=scale, **kw)
        sync()
        diff_rows = (sel_k != sel_p).any(-1)
        bad = diff_rows & ~ties
        if bad.any():
            raise AssertionError(f"{case['name']}: select_blocks indices "
                                 f"differ in {int(bad.sum())} rows with no "
                                 "near-tie")
        agree = ~diff_rows
        out_k = F.fused_loki_decode(q, k, v, cur, scale=scale, **kw)
        out_p = F.fused_loki_decode_plain(q, k, v, cur, scale=scale, **kw)
        att_k = GA.block_sparse_attention_grouped(
            q, k, v, sel_p, cur, block_size=case["bs"], scale=scale,
            sliding_window=case["sw"])
        att_p = GA.attend_blocks_plain(q, k, v, sel_p, cur,
                                       block_size=case["bs"], scale=scale,
                                       sliding_window=case["sw"])
        sync()
        atol, rtol = tolerance(q.dtype)
        errs = {}
        for kname, got, want, rows in (
                ("fused_loki_decode", out_k, out_p, agree),
                ("block_sparse_attention_grouped", att_k, att_p, None)):
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
        n_sent = int((sel_p < 0).sum())
        log(f"kernels: {case['name']}: indices equal in "
            f"{int(agree.sum())}/{agree.numel()} rows (near-ties reported "
            f"{int(ties.sum())}, differing {int(diff_rows.sum())}), "
            f"-1 sentinels {n_sent}, max|err| fused "
            f"{errs['fused_loki_decode']:.3e} attention "
            f"{errs['block_sparse_attention_grouped']:.3e} "
            f"(atol {atol}, rtol {rtol})")
        if "main" not in results:
            results["main"] = dict(case=case, sel=sel_p, errs=errs)


def check_no_fallback():
    """A CUDA tensor never reaches a plain path: a decode shape no kernel
    plan takes (here G = 32 query heads per KV head, above the kernels'
    16) raises instead."""
    from repro_torch.configs.base import LokiConfig
    from repro_torch.core import dispatch

    gen = torch.Generator(device=DEV).manual_seed(9)
    f = dict(device=DEV, generator=gen)
    q = torch.randn((1, 32, 128), **f)
    k, v = torch.randn((2, 1, 256, 1, 128), **f)
    proj = torch.eye(128, device=DEV)[None]
    cur = torch.tensor([200], dtype=torch.int32, device=DEV)
    try:
        dispatch.loki_block_decode(q, k, v, cur, proj,
                                   LokiConfig(enabled=True, backend="auto"))
    except NotImplementedError as e:
        log(f"kernels: no plan at G = 32 on the card raises: {e}")
        return
    raise AssertionError("a CUDA decode with no kernel plan did not raise")


def time_kernels(results):
    """Kernel, plain version and SDPA yardstick at the main-path shape."""
    from repro_torch.kernels import fused_decode as F
    from repro_torch.kernels import gather_attention as GA

    case, sel = results["main"]["case"], results["main"]["sel"]
    q, k, v, cur = case["q"], case["k"], case["v"], case["cur"]
    scale = v.shape[-1] ** -0.5
    kw = dict(d=case["d"], k_blocks=case["kb"], block_size=case["bs"],
              local_window=case["lw"], sliding_window=case["sw"])
    att_kw = dict(block_size=case["bs"], scale=scale,
                  sliding_window=case["sw"])
    runs = {
        "fused_loki_decode": (
            lambda: F.fused_loki_decode(q, k, v, cur, scale=scale, **kw),
            lambda: F.fused_loki_decode_plain(q, k, v, cur, scale=scale,
                                              **kw)),
        "select_blocks": (
            lambda: F.select_blocks(q, k, cur, scale=scale, **kw),
            lambda: F.select_blocks_plain(q, k, cur, scale=scale, **kw)),
        "block_sparse_attention_grouped": (
            lambda: GA.block_sparse_attention_grouped(q, k, v, sel, cur,
                                                      **att_kw),
            lambda: GA.attend_blocks_plain(q, k, v, sel, cur, **att_kw)),
    }
    # the paper's yardstick, NOT the same function: full attention of the
    # same queries over the same live cache, one library call
    B, Hkv, G, D = q.shape
    qs = q.reshape(B, Hkv * G, 1, D).to(k.dtype)
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    if G > 1:
        kt = kt.repeat_interleave(G, dim=1)
        vt = vt.repeat_interleave(G, dim=1)
    pos = torch.arange(k.shape[1], device=DEV)
    mask = (pos[None, :] < cur[:, None].long())[:, None, None, :]
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=mask, scale=scale))
    bnd = bounds(case, sel)
    timing = {}
    for name, (kern, plain) in runs.items():
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=5)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[name][0],
                            bound_by=bnd[name][1])
        log(f"timing: {name} at {case['name']}: {ms:.4f} ms (bound "
            f"{bnd[name][0]:.4f} ms by {bnd[name][1]}, plain {plain_ms:.4f} "
            "ms)")
    log(f"timing: full attention over the same live cache "
        f"(scaled_dot_product_attention, not the same function): "
        f"{sdpa_ms:.4f} ms")
    results["timing"], results["sdpa_ms"] = timing, sdpa_ms


# -------------------------------------------------------------------- serve

def prompts(vocab: int, lengths, seed: int):
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=vocab, seq_len=max(lengths),
                                  global_batch=len(lengths), seed=seed,
                                  n_states=32, temperature=0.22))
    toks = data.batch_at(0)["tokens"]
    return [toks[i, :n] for i, n in enumerate(lengths)]


def serve(results, *, smoke=False, smax=4096,
          lengths=(1500, 2000, 2500, 3000)):
    """The main path. ``smoke``/``smax``/``lengths`` shrink it for a CPU
    rehearsal of this script (``DEV = "cpu"``); the run uses defaults."""
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
    hd = cfg.resolved_head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    plan, d = dispatch.decode_plan(cfg.loki, sc.engine.smax, hd, g, hd, 4)
    log(f"serve: planner picked {plan} at smax {sc.engine.smax} (d={d})")
    if plan is None:
        raise AssertionError("no kernel plan at the main-path shape")

    def run_engine(backend):
        eng = ServeConfig(engine=dataclasses.replace(sc.engine,
                                                     backend=backend),
                          device=DEV).build_engine(params, cfg)
        reqs = [Request(rid=i, prompt=t, max_new=16)
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
        return eng, reqs, tick_ms, time.perf_counter() - t_all

    # ---- the main path: counts set to 0 just before, read just after
    K.reset_launch_counts()
    eng, reqs, tick_ms, wall = run_engine("auto")
    counts = K.launch_counts()
    # ---- end of the main path
    ticks = eng.ticks
    bad = [r.rid for r in reqs if str(r.status) != "done"]
    if bad:
        raise AssertionError(f"requests not DONE: {bad}")
    for be in ("pallas", "xla"):
        if dispatch.backend_disabled(be):
            raise AssertionError(f"backend {be} disabled: "
                                 f"{dispatch.backend_disabled(be)}")
    del eng
    if DEV == "cuda":
        torch.cuda.empty_cache()
    toks_out = sum(len(r.out) for r in reqs)
    decode_ms = statistics.median(tick_ms[1:])
    log(f"serve: {len(reqs)} requests, prompts {lengths}, {toks_out} tokens "
        f"in {ticks} ticks, {wall:.2f} s incl. prefill -> "
        f"{toks_out / wall:.1f} tok/s; first tick (4 prefills + decode) "
        f"{tick_ms[0]:.1f} ms, decode tick median {decode_ms:.2f} ms -> "
        f"{4e3 / decode_ms:.1f} tok/s at 4 slots")
    log(f"serve: main-path launches {counts}")
    planned = (("fused_loki_decode",) if plan.variant == "fused" else
               ("select_blocks", "block_sparse_attention_grouped"))
    want = {n: ticks * cfg.n_layers if n in planned else 0 for n in counts}
    if counts != want:
        raise AssertionError(f"main-path launches {counts}, expected {want} "
                             f"({ticks} ticks x {cfg.n_layers} layers of the "
                             f"{plan.variant} plan)")

    step = decode_step_check(params, cfg, toks, sc.engine.smax)
    results["profile"] = profile_decode(params, cfg, toks, sc.engine.smax)

    # greedy agreement with the plain per-head path over the same run
    eng_x, reqs_x, _, _ = run_engine("xla")
    same = sum(a == b for r, rx in zip(reqs, reqs_x)
               for a, b in zip(r.out, rx.out))
    log(f"serve: greedy tokens equal to backend=xla in {same}/{toks_out} "
        "(reported, not asserted)")
    del eng_x
    results["launches"] = {"serve": counts,
                           "decode_step": step.pop("launches")}
    results["serve"] = dict(ticks=ticks, decode_tick_ms=decode_ms,
                            tok_per_s=toks_out / wall, **step)


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
        f"{max(0.0, 1 - busy / wall_ms):.3f}")
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
        # the same blocks and attends in the same order
        two = ops.loki_decode_two_kernel(*args, **kwargs)
        atol, rtol = tolerance(out.dtype)
        torch.testing.assert_close(
            two.float(), out.float(), atol=atol, rtol=rtol,
            msg=lambda m: f"layer {layer}: two_kernel vs fused: {m}")
        two_err = max(two_err, float((two.float() - out.float()).abs().max()))
    sync()
    counts = K.launch_counts()
    # ---- end of the decode-step path
    log(f"step: decode-step path launches {counts}; two_kernel vs fused "
        f"on each layer's inputs max|err| {two_err:.3e}")
    if any(n != cfg.n_layers for n in counts.values()):
        raise AssertionError(f"decode-step launches {counts}, expected "
                             f"{cfg.n_layers} of each kernel")

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
        kw = dict(kwargs, scale=kwargs["scale"] or v.shape[-1] ** -0.5)
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
    return {"launches": counts, "two_vs_fused_max_abs_err": two_err,
            "layer_rel_kernel_vs_plain_max": max(same_in),
            "layer_rel_fused_vs_xla_step": across,
            f"{cfg.dtype}_rel_fused_vs_xla": gap,
            f"{cfg.dtype}_rel_no_recency_vs_xla": control}


# --------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["kernels"], default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} CUDA sources built with nvcc "
        f"(sm_90a) in {secs:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    results = {}
    check_kernels(results)
    check_no_fallback()
    time_kernels(results)
    if args.only != "kernels":
        serve(results)
    launches = results.get("launches", {})

    sources = {
        "fused_loki_decode": ("src/repro_torch/csrc/fused_decode.cu",
                              "src/repro/kernels/fused_decode.py:248"),
        "select_blocks": ("src/repro_torch/csrc/fused_decode.cu",
                          "src/repro/kernels/fused_decode.py:439"),
        "block_sparse_attention_grouped": (
            "src/repro_torch/csrc/gather_attention.cu",
            "src/repro/kernels/gather_attention.py:368"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        t = results["timing"][name]
        # each kernel's count comes from the path that runs it: the main
        # path's plan, else the decode-step path's two-kernel pair
        path = ("serve" if launches.get("serve", {}).get(name)
                else "decode_step")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": path,
            "launches": launches.get(path, {}).get(name, 0),
            "max_abs_err": results["main"]["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "full_attention_sdpa_ms_not_same_function": results["sdpa_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "kernels": kernels,
                   "launches": launches, "serve": results.get("serve"),
                   "profile": results.get("profile")}, fh, indent=1)
    log(card)                   # as nvidia-smi prints it: name, limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
