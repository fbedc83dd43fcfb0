"""Backend selection for the decode hot path.

Counterpart of ``repro.core.dispatch``. One chokepoint per policy decides,
per decode step, which implementation runs:

  backend="xla"    — the plain torch reference (``loki.loki_decode_block``
                     per-head selection; ``attention.decode_full``;
                     ``baselines.exact_topk_decode``), over the gathered
                     logical view when the caches are paged pools.
  backend="pallas" — the hand-written CUDA kernels (group-shared
                     selection), with ``kernels/tuning.py`` picking the
                     variant and the block size; paged pools go to the
                     kernels with their page table. On CPU tensors the
                     kernels' plain versions run, as the JAX package's
                     interpret mode does.
  backend="auto"   — "pallas" for CUDA tensors, "xla" on the CPU.

``loki_tiered_decode`` is ``loki_block_decode`` over a tiered pool: the
score pass over the latent sidecar, exact attention over device frames.

``plan_rows`` (an int, slots x kv heads): the rows the kernels' split count
and cluster size are planned for. The paged engine passes its full width
on every step, so a gather-packed step launches each slot as the masked
step does and their greedy outputs agree bit for bit; None plans for the
step's own B * Hkv.

On CPU tensors, shapes no kernel plan covers fall back to torch *with the
kernels' group-shared selection*, so a backend choice is numerically
consistent across shapes. CUDA tensors have no fallback: a shape no kernel
takes (including a paged call whose page size the plan's block does not
divide), or a disabled kernel backend, raises. Per-page scales (quantized
layouts) pass through to every kernel; the plain paths read the
dequantized logical view (``gather_logical_dq``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import LokiConfig
from repro_torch.core import attention as A
from repro_torch.core import baselines, loki
from repro_torch.kernels import ops, tuning
from repro_torch.serving.paged_cache import check_scales, gather_logical_dq

BACKENDS = ("auto", "pallas", "xla")

# Backends disabled at runtime after a failure: every later
# ``resolve_backend`` then routes CPU tensors to the plain path and raises
# for CUDA tensors. Only an explicit ``disable_backend`` call sets it;
# process-wide on purpose.
_DISABLED: dict = {}          # backend -> reason


def disable_backend(backend: str, reason: str = "") -> None:
    """Mark a backend failed; resolve_backend avoids it from now on."""
    if backend not in BACKENDS or backend == "auto":
        raise ValueError(f"cannot disable backend {backend!r}")
    _DISABLED[backend] = reason or "runtime failure"


def enable_backend(backend: str) -> None:
    """Clear a failure mark (tests, or operator-driven recovery)."""
    _DISABLED.pop(backend, None)


def backend_disabled(backend: str) -> Optional[str]:
    """The failure reason if ``backend`` is disabled, else None."""
    return _DISABLED.get(backend)


def resolve_backend(backend: str, device_type: str = "cpu") -> str:
    """'auto' | 'pallas' | 'xla' -> the concrete backend for tensors on
    ``device_type``. On the CPU a backend disabled by an earlier failure
    steps down to the plain path (never disabled — the floor of the
    ladder); on CUDA the kernel backend has no plain stand-in, so a
    disabled one raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown loki backend {backend!r}; have {BACKENDS}")
    if backend == "auto":
        backend = "pallas" if device_type == "cuda" else "xla"
    if backend == "pallas" and "pallas" in _DISABLED:
        if device_type == "cuda":
            raise RuntimeError(f"loki backend 'pallas' is disabled "
                               f"({_DISABLED['pallas']}); CUDA tensors have "
                               "no plain fallback")
        return "xla"
    return backend


def _device_type(t) -> str:
    return "cuda" if t.is_cuda else t.device.type


def gathered(k_cache, v_cache, page_table, page_size, k_scale=None,
             v_scale=None):
    """Logical (B,Smax,Hkv,·) views of possibly pooled caches, dequantized
    through the per-page scales of a quantized layout."""
    if page_table is None:
        return k_cache, v_cache
    return (gather_logical_dq(k_cache, k_scale, page_table, page_size),
            gather_logical_dq(v_cache, v_scale, page_table, page_size))


def _cache_shape(k_cache, v_cache, page_table, page_size):
    """(smax, n_kv, kd, dim) of a contiguous cache or a paged pool."""
    if page_table is not None:
        smax = page_table.shape[1] * page_size
    else:
        smax = k_cache.shape[1]
    return smax, k_cache.shape[-2], k_cache.shape[-1], v_cache.shape[-1]


def _page_fits(plan, page_table, page_size):
    """The plan, or None when its blocks would straddle pages."""
    if plan is not None and page_table is not None \
            and page_size % plan.block_size:
        return None
    return plan


def _no_plan(policy: str, smax: int, dim: int, g: int, d: int,
             page_size: int):
    paged = f", page_size={page_size}" if page_size else ""
    return NotImplementedError(
        f"no CUDA kernel plan for {policy} decode at smax={smax}, "
        f"head_dim={dim}, G={g}, d={d}{paged}: the kernels take G <= "
        f"{tuning.MAX_G}, head_dim <= {tuning.MAX_DIM}, smax a multiple of "
        "8, a page size that the block size divides and a block-maxima "
        "row that fits shared memory beside the rings (the fused and "
        "select kernels keep the whole row on chip: "
        "kernels/tuning.py fused_smem_bytes, select_smem_bytes)")


def _token_fallback(q_rope, k_hat_cache, v_cache, cur_len, proj, cfg, *,
                    sliding_window, logit_scale):
    """Token-granular torch path over logical (gathered) caches."""
    return loki.loki_decode(q_rope, k_hat_cache, v_cache, cur_len, proj,
                            cfg, sliding_window=sliding_window,
                            logit_scale=logit_scale)


def decode_plan(cfg: LokiConfig, smax: int, dim: int, g: int, kd: int,
                storage: str):
    """(plan, d) of a loki_block decode step: the kernel plan (None when no
    kernel takes the shape) and the approximate-score width; ``storage``
    the cache's storage type (``tuning.storage_of``)."""
    d = min(max(int(cfg.d_f * dim), 8), kd)
    return tuning.plan_decode(smax, dim, g, d, cfg.block_size,
                              storage=storage), d


def _grouped_query(q, n_kv: int, width: int):
    b, h = q.shape[0], q.shape[1]
    return q.reshape(b, n_kv, h // n_kv, width)


def _lengths(cur_len, b: int, device):
    cur = torch.as_tensor(cur_len, device=device)
    return cur.to(torch.int32).expand(b).contiguous()


def loki_block_decode(q_rope, k_hat_cache, v_cache, cur_len, proj,
                      cfg: LokiConfig, *, sliding_window: int = 0,
                      logit_scale=None, page_table=None, page_size: int = 0,
                      k_scale=None, v_scale=None, plan_rows=None):
    """Block-granular Loki decode through the configured backend.

    q_rope (B,H,D); k_hat_cache (B,Smax,Hkv,W) with W <= D the stored key
    width, or the pool (R,Hkv,W) with ``page_table (B, n_pages)`` and
    ``page_size``; v_cache likewise with width D; cur_len (B,) or scalar;
    proj (Hkv,D,D). Returns (B,H,D). ``sliding_window`` and
    ``cfg.local_window`` are honoured identically on every backend.
    Quantized layouts pass the pools' (n_pages,) float32 ``k_scale`` and
    ``v_scale``."""
    check_scales(k_hat_cache, k_scale, v_scale, page_table, page_size)
    backend = resolve_backend(cfg.backend, _device_type(q_rope))
    b, h = q_rope.shape[0], q_rope.shape[1]
    smax, n_kv, kd, dim = _cache_shape(k_hat_cache, v_cache, page_table,
                                       page_size)
    g = h // n_kv
    if logit_scale is None and kd < dim:
        # rank-r keys: the softmax temperature is set by the true head_dim
        logit_scale = dim ** -0.5
    plan, d = decode_plan(cfg, smax, dim, g, kd,
                          tuning.storage_of(k_hat_cache))
    plan = _page_fits(plan, page_table, page_size)
    fb_args = dict(sliding_window=sliding_window, logit_scale=logit_scale)
    pargs = dict(page_table=page_table, page_size=page_size)
    qargs = dict(k_scale=k_scale, v_scale=v_scale)

    if backend == "xla":
        if smax % cfg.block_size:
            # short caches: adopt the planner's dividing block size rather
            # than tripping the reference assert
            if plan is None:
                return _token_fallback(
                    q_rope, *gathered(k_hat_cache, v_cache, **pargs,
                                       **qargs),
                    cur_len, proj, cfg, **fb_args)
            cfg = dataclasses.replace(cfg, block_size=plan.block_size)
        return loki.loki_decode_block(
            q_rope, *gathered(k_hat_cache, v_cache, **pargs, **qargs),
            cur_len, proj, cfg, **fb_args)
    if plan is None:
        if q_rope.is_cuda:
            raise _no_plan("loki_block", smax, dim, g, d, page_size)
        # no kernel takes the shape: torch fallback on the CPU, keeping the
        # kernels' group-shared selection when the block decomposition exists
        kc, vc = gathered(k_hat_cache, v_cache, **pargs, **qargs)
        if smax % cfg.block_size == 0 and (
                page_table is None or page_size % cfg.block_size == 0):
            return loki.loki_decode_block(q_rope, kc, vc, cur_len, proj, cfg,
                                          group_select=True, **fb_args)
        return _token_fallback(q_rope, kc, vc, cur_len, proj, cfg, **fb_args)

    nb = smax // plan.block_size
    k_blocks = max(int(cfg.k_f * nb), 1)
    if sliding_window:
        # a sliding window overlaps at most ceil(w/bs)+1 blocks; selection
        # slots beyond that can only fill with -1 sentinels
        k_blocks = min(k_blocks, -(-sliding_window // plan.block_size) + 1)
    qg = _grouped_query(q_rope, n_kv, dim)
    q_hat = torch.einsum("bhgd,hde->bhge", qg, proj.to(q_rope.dtype))
    q_hat = q_hat[..., :kd].contiguous()
    fn = (ops.loki_decode_fused if plan.variant == "fused"
          else ops.loki_decode_two_kernel)
    out = fn(q_hat, k_hat_cache, v_cache, _lengths(cur_len, b, q_rope.device),
             d=d, k_blocks=k_blocks, block_size=plan.block_size,
             scale=logit_scale, local_window=cfg.local_window,
             sliding_window=sliding_window, plan_rows=plan_rows, **pargs,
             **qargs)
    return out.reshape(b, h, dim)


def loki_tiered_decode(q_rope, k_pool, v_pool, lat_pool, cur_len, proj,
                       cfg: LokiConfig, *, page_table, frame_table,
                       page_size: int, sliding_window: int = 0,
                       logit_scale=None, token_granular: bool = False):
    """Tiered Loki decode through the configured backend.

    The score and top-k pass reads only the always-resident latent-K
    sidecar ``lat_pool (R_log, Hkv, d)`` through the logical
    ``page_table``; exact attention reads the winners' rows from the
    frame pools ``k_pool``/``v_pool (R_dev, Hkv, ·)`` through
    ``frame_table``. Returns (out (B,H,D), winners (B, max_pages) bool).

    Routing mirrors ``loki_block_decode`` decision for decision (backend,
    the planner's block size, group-shared selection where no plan fits
    on the CPU, the token fallback), so a tiered engine selects the pages
    its single-tier twin attends. With a plan, the kernel pair runs as it
    is: ``select_blocks`` over the sidecar through the page table, then
    ``block_sparse_attention_grouped`` over the frames through the frame
    table; the fused kernel cannot split its reads across two pools, so
    the tier always takes the pair (bit-equal to the fused kernel on the
    card). The select kernel's default scale is its own width's, here d:
    the call passes ``D**-0.5``, the scale the single tier scores with.
    ``token_granular`` (the ``loki`` policy) is the plain token top-k, as
    the single tier's ``loki`` is. A CUDA call no plan takes raises."""
    b, h = q_rope.shape[0], q_rope.shape[1]
    n_kv, kd = k_pool.shape[-2], k_pool.shape[-1]
    dim = v_pool.shape[-1]
    max_pages = page_table.shape[1]
    smax = max_pages * page_size
    g = h // n_kv
    if logit_scale is None and kd < dim:
        logit_scale = dim ** -0.5
    common = dict(page_table=page_table, frame_table=frame_table,
                  page_size=page_size, sliding_window=sliding_window,
                  logit_scale=logit_scale)
    args = (q_rope, k_pool, v_pool, lat_pool, cur_len, proj)
    if token_granular:
        return loki.loki_decode_tiered(*args, cfg, token_granular=True,
                                       **common)
    backend = resolve_backend(cfg.backend, _device_type(q_rope))
    plan, d = decode_plan(cfg, smax, dim, g, kd, tuning.storage_of(k_pool))
    plan = _page_fits(plan, page_table, page_size)
    if backend == "xla":
        if smax % cfg.block_size:
            if plan is None:
                return loki.loki_decode_tiered(*args, cfg,
                                               token_granular=True, **common)
            cfg = dataclasses.replace(cfg, block_size=plan.block_size)
        return loki.loki_decode_tiered(*args, cfg, **common)
    if plan is None:
        if q_rope.is_cuda:
            raise _no_plan("loki_block", smax, dim, g, d, page_size)
        group = smax % cfg.block_size == 0 \
            and page_size % cfg.block_size == 0
        return loki.loki_decode_tiered(*args, cfg, group_select=group,
                                       token_granular=not group, **common)

    bs = plan.block_size
    k_blocks = max(int(cfg.k_f * (smax // bs)), 1)
    if sliding_window:
        k_blocks = min(k_blocks, -(-sliding_window // bs) + 1)
    q_hat = torch.einsum("bhgd,hde->bhge", _grouped_query(q_rope, n_kv, dim),
                         proj.to(q_rope.dtype))[..., :kd].contiguous()
    cur = _lengths(cur_len, b, q_rope.device)
    scale = logit_scale if logit_scale is not None else dim ** -0.5
    blk_idx = ops.select_blocks(q_hat[..., :d].contiguous(), lat_pool, cur,
                                d=d, k_blocks=k_blocks, block_size=bs,
                                scale=scale, local_window=cfg.local_window,
                                sliding_window=sliding_window,
                                page_table=page_table, page_size=page_size)
    out = ops.block_sparse_attention_grouped(
        q_hat, k_pool, v_pool, blk_idx, cur, block_size=bs, scale=scale,
        sliding_window=sliding_window, page_table=frame_table,
        page_size=page_size)
    # a block lies in one page (the plan's block divides the page)
    return out.reshape(b, h, dim), loki.winner_pages(
        blk_idx.long() * bs, blk_idx >= 0, page_size, max_pages)


def full_paged_decode(q, k_cache, v_cache, cur_len, *, backend: str = "auto",
                      block_size: int = 128, sliding_window: int = 0,
                      logit_scale=None, page_table=None, page_size: int = 0,
                      k_scale=None, v_scale=None, plan_rows=None):
    """Full-attention decode through the configured backend.

    q (B,H,W) queries in the storage basis (W <= D the stored key width);
    k_cache (B,Smax,Hkv,W) or the pool (R,Hkv,W) with ``page_table``;
    v_cache (·,Hkv,D). Returns (B,H,D). backend="xla" gathers the logical
    view into ``attention.decode_full``; "pallas" streams the live blocks
    through paged_full_decode (the same function, an online softmax).
    Quantized layouts pass the pools' per-page ``k_scale``/``v_scale``."""
    check_scales(k_cache, k_scale, v_scale, page_table, page_size)
    backend = resolve_backend(backend, _device_type(q))
    b, h = q.shape[0], q.shape[1]
    smax, n_kv, kd, dim = _cache_shape(k_cache, v_cache, page_table,
                                       page_size)
    g = h // n_kv
    if logit_scale is None and kd < dim:
        logit_scale = dim ** -0.5

    plan = None
    if backend == "pallas":
        plan = _page_fits(tuning.plan_full_decode(
            smax, dim, g, kd, block_size,
            storage=tuning.storage_of(k_cache)), page_table, page_size)
        if plan is None and q.is_cuda:
            raise _no_plan("full", smax, dim, g, kd, page_size)
    qargs = dict(k_scale=k_scale, v_scale=v_scale)
    if plan is None:
        kc, vc = gathered(k_cache, v_cache, page_table, page_size, **qargs)
        return A.decode_full(q, kc, vc, cur_len,
                             sliding_window=sliding_window,
                             logit_scale=logit_scale)
    qg = _grouped_query(q, n_kv, kd).contiguous()
    out = ops.full_decode(qg, k_cache, v_cache,
                          _lengths(cur_len, b, q.device),
                          block_size=plan.block_size, scale=logit_scale,
                          sliding_window=sliding_window,
                          page_table=page_table, page_size=page_size,
                          plan_rows=plan_rows, **qargs)
    return out.reshape(b, h, dim)


def exact_topk_paged_decode(q, k_cache, v_cache, cur_len, cfg: LokiConfig,
                            *, logit_scale=None, page_table=None,
                            page_size: int = 0, k_scale=None, v_scale=None,
                            plan_rows=None):
    """Exact-top-k decode through the configured backend.

    backend="xla" is the token-granular reference
    (``baselines.exact_topk_decode`` over the gathered logical view);
    "pallas" fuses the exact score pass with block top-k (score width =
    the full stored key width, group-shared selection), planned at
    d = kd. ``baselines.exact_topk_decode_block`` is its plain oracle and
    the CPU fallback for shapes no plan covers. Quantized layouts pass the
    pools' per-page ``k_scale``/``v_scale``."""
    check_scales(k_cache, k_scale, v_scale, page_table, page_size)
    backend = resolve_backend(cfg.backend, _device_type(q))
    b, h = q.shape[0], q.shape[1]
    smax, n_kv, kd, dim = _cache_shape(k_cache, v_cache, page_table,
                                       page_size)
    g = h // n_kv
    if logit_scale is None and kd < dim:
        logit_scale = dim ** -0.5

    qargs = dict(k_scale=k_scale, v_scale=v_scale)
    if backend == "xla":
        kc, vc = gathered(k_cache, v_cache, page_table, page_size, **qargs)
        return baselines.exact_topk_decode(q, kc, vc, cur_len, cfg,
                                           logit_scale=logit_scale)
    # the exact score pass reads the full stored width: plan with d = kd
    plan = _page_fits(tuning.plan_decode(
        smax, dim, g, kd, cfg.block_size,
        storage=tuning.storage_of(k_cache)), page_table, page_size)
    if plan is None:
        if q.is_cuda:
            raise _no_plan("exact_topk", smax, dim, g, kd, page_size)
        if smax % cfg.block_size == 0 and (
                page_table is None or page_size % cfg.block_size == 0):
            return baselines.exact_topk_decode_block(
                q, k_cache, v_cache, cur_len, cfg, logit_scale=logit_scale,
                group_select=True, page_table=page_table,
                page_size=page_size, **qargs)
        kc, vc = gathered(k_cache, v_cache, page_table, page_size, **qargs)
        return baselines.exact_topk_decode(q, kc, vc, cur_len, cfg,
                                           logit_scale=logit_scale)

    nb = smax // plan.block_size
    k_blocks = max(int(cfg.k_f * nb), 1)
    qg = _grouped_query(q, n_kv, kd).contiguous()
    cur = _lengths(cur_len, b, q.device)
    pargs = dict(page_table=page_table, page_size=page_size,
                 plan_rows=plan_rows, **qargs)
    if plan.variant == "fused":
        out = ops.exact_topk_decode_fused(
            qg, k_cache, v_cache, cur, k_blocks=k_blocks,
            block_size=plan.block_size, scale=logit_scale, **pargs)
    else:
        # the pair at d = kd scores exactly: the same selection as fused
        out = ops.loki_decode_two_kernel(
            qg, k_cache, v_cache, cur, d=kd, k_blocks=k_blocks,
            block_size=plan.block_size, scale=logit_scale, local_window=0,
            sliding_window=0, **pargs)
    return out.reshape(b, h, dim)
