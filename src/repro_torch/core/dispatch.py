"""Backend selection for the Loki decode hot path.

Counterpart of ``repro.core.dispatch``. One chokepoint decides, per decode
step, which implementation of block-granular Loki runs:

  backend="xla"    — the plain torch reference (``loki.loki_decode_block``),
                     per-head selection.
  backend="pallas" — the hand-written CUDA kernels (group-shared
                     selection), with ``kernels/tuning.py`` picking the
                     single-pass or two-kernel variant and the block size.
                     On CPU tensors the kernels' plain versions run, as the
                     JAX package's interpret mode does.
  backend="auto"   — "pallas" for CUDA tensors, "xla" on the CPU.

On CPU tensors, shapes no kernel plan covers fall back to torch *with the
kernels' group-shared selection*, so a backend choice is numerically
consistent across shapes. CUDA tensors have no fallback: a shape no kernel
takes, or a disabled kernel backend, raises. Contiguous caches only in this
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import LokiConfig
from repro_torch.core import loki
from repro_torch.kernels import ops, tuning

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


def _token_fallback(q_rope, k_hat_cache, v_cache, cur_len, proj, cfg, *,
                    sliding_window, logit_scale):
    """Token-granular torch path."""
    return loki.loki_decode(q_rope, k_hat_cache, v_cache, cur_len, proj,
                            cfg, sliding_window=sliding_window,
                            logit_scale=logit_scale)


def decode_plan(cfg: LokiConfig, smax: int, dim: int, g: int, kd: int,
                itemsize: int):
    """(plan, d) of a loki_block decode step: the kernel plan (None when no
    kernel takes the shape) and the approximate-score width."""
    d = min(max(int(cfg.d_f * dim), 8), kd)
    return tuning.plan_decode(smax, dim, g, d, cfg.block_size,
                              itemsize=itemsize), d


def loki_block_decode(q_rope, k_hat_cache, v_cache, cur_len, proj,
                      cfg: LokiConfig, *, sliding_window: int = 0,
                      logit_scale=None, page_table=None, page_size: int = 0,
                      k_scale=None, v_scale=None):
    """Block-granular Loki decode through the configured backend.

    q_rope (B,H,D); k_hat_cache (B,Smax,Hkv,W) with W <= D the stored key
    width; v_cache (B,Smax,Hkv,D); cur_len (B,) or scalar; proj (Hkv,D,D).
    Returns (B,H,D). ``sliding_window`` and ``cfg.local_window`` are
    honoured identically on every backend."""
    if page_table is not None or k_scale is not None or v_scale is not None:
        raise NotImplementedError("paged kernels: next slice")
    backend = resolve_backend(cfg.backend, q_rope.device.type)
    b, h = q_rope.shape[0], q_rope.shape[1]
    _, smax, n_kv, kd = k_hat_cache.shape
    dim = v_cache.shape[-1]
    g = h // n_kv
    if logit_scale is None and kd < dim:
        # rank-r keys: the softmax temperature is set by the true head_dim
        logit_scale = dim ** -0.5
    plan, d = decode_plan(cfg, smax, dim, g, kd, k_hat_cache.element_size())
    fb_args = dict(sliding_window=sliding_window, logit_scale=logit_scale)

    if backend == "xla":
        if smax % cfg.block_size:
            # short caches: adopt the planner's dividing block size rather
            # than tripping the reference assert
            if plan is None:
                return _token_fallback(q_rope, k_hat_cache, v_cache,
                                       cur_len, proj, cfg, **fb_args)
            cfg = dataclasses.replace(cfg, block_size=plan.block_size)
        return loki.loki_decode_block(q_rope, k_hat_cache, v_cache, cur_len,
                                      proj, cfg, **fb_args)
    if plan is None:
        if q_rope.is_cuda:
            raise NotImplementedError(
                f"no CUDA kernel plan for loki_block decode at smax={smax}, "
                f"head_dim={dim}, G={g}, d={d}: the kernels take G <= "
                f"{tuning.MAX_G}, head_dim <= {tuning.MAX_DIM}, smax a "
                "multiple of 8 and a score row within shared memory "
                "(split-KV form: ROADMAP queue 2 item 1)")
        # no kernel takes the shape: torch fallback on the CPU, keeping the
        # kernels' group-shared selection when the block decomposition exists
        if smax % cfg.block_size == 0:
            return loki.loki_decode_block(q_rope, k_hat_cache, v_cache,
                                          cur_len, proj, cfg,
                                          group_select=True, **fb_args)
        return _token_fallback(q_rope, k_hat_cache, v_cache, cur_len, proj,
                               cfg, **fb_args)

    nb = smax // plan.block_size
    k_blocks = max(int(cfg.k_f * nb), 1)
    if sliding_window:
        # a sliding window overlaps at most ceil(w/bs)+1 blocks; selection
        # slots beyond that can only fill with -1 sentinels
        k_blocks = min(k_blocks, -(-sliding_window // plan.block_size) + 1)
    qg = q_rope.reshape(b, n_kv, g, dim)
    q_hat = torch.einsum("bhgd,hde->bhge", qg, proj.to(q_rope.dtype))
    q_hat = q_hat[..., :kd].contiguous()
    cur = torch.as_tensor(cur_len, device=q_rope.device)
    cur = cur.to(torch.int32).expand(b).contiguous()
    fn = (ops.loki_decode_fused if plan.variant == "fused"
          else ops.loki_decode_two_kernel)
    out = fn(q_hat, k_hat_cache, v_cache, cur, d=d, k_blocks=k_blocks,
             block_size=plan.block_size, scale=logit_scale,
             local_window=cfg.local_window, sliding_window=sliding_window)
    return out.reshape(b, h, dim)
