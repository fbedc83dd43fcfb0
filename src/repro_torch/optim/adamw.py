"""AdamW and its schedule over the port's parameter trees (counterpart of
``repro.optim.adamw``).

The update is the reference's formula, ``u = (mu / c1) / (sqrt(nu / c2)
+ eps)`` with weight decay on leaves of rank 2 and up, not
``torch.optim.AdamW``'s (which puts eps after ``sqrt(nu) /
sqrt(c2)``). The learning rate and the bias corrections are float32
tensors computed from the int32 step on the device, as the JAX code
computes them, so no step waits for the host.

It runs in place: each leaf, a slice of at most ``SLICE`` elements at a
time, computes its new value and moments and writes them over the old.
At published width an out-of-place step would keep three or four copies
of the largest leaf alive (qwen2.5-3b's stacked MLP input is 6.5 GB in
float32). A step that must be skipped (``guard``) writes ``where(ok,
new, old)`` slice by slice, so skipping needs no second copy of the
state either.

PCA projection matrices (leaves under a ``pca`` key) are calibration
artifacts, not trainable weights: they get zero updates and 0-d
placeholder moments.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.lm import tree_items, tree_rebuild

#: elements a leaf is updated in at a time (256 MB of float32)
SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d, on the parameters' device
    mu: Any
    nu: Any


def _is_frozen(key: str) -> bool:
    return "pca" in key.split("/")


def init_state(params) -> AdamWState:
    """Zero moments shaped like the parameters (0-d for frozen leaves)
    and step 0."""
    def zeros(key, x):
        return (torch.zeros((), dtype=x.dtype, device=x.device)
                if _is_frozen(key) else torch.zeros_like(x))
    dev = next(tree_items(params))[1].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_rebuild(params, zeros),
                      tree_rebuild(params, zeros))


def cosine_schedule(cfg: TrainConfig):
    """step (int tensor) -> learning rate (float32 tensor): linear warmup
    to ``cfg.lr`` over ``warmup_steps``, then a cosine to 0 at
    ``total_steps``."""
    def lr_at(step):
        step = step.float()
        warm = cfg.lr * step / max(cfg.warmup_steps, 1)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * cfg.lr * (1 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr_at


def _slices(x: torch.Tensor):
    """x flattened, in views of at most SLICE elements."""
    flat = x.view(-1)
    return [flat[i:i + SLICE] for i in range(0, flat.numel(), SLICE)] \
        if flat.numel() else [flat]


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    return sum(c.float().square().sum() for c in _slices(x))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(_sum_sq(x) for _, x in tree_items(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_rebuild(grads, lambda _, g: g * scale.to(g.dtype)), norm


def apply_updates(params, grads, state: AdamWState, cfg: TrainConfig, *,
                  guard: Optional[torch.Tensor] = None):
    """One AdamW step, in place over ``params`` and the state's moments.
    Returns (params, new state, grad norm before clipping).

    ``guard`` (a 0-d tensor, the step's loss): the step lands only where
    the loss and the grad norm are finite; otherwise every parameter,
    moment and the step count keep their values (``TrainConfig.
    nan_skip``). Decided on the device: no host sync."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip else None)
    ok = (None if guard is None
          else torch.isfinite(gnorm) & torch.isfinite(guard))
    step = state.step + 1
    lr = cosine_schedule(cfg)(step)
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def write(dst, new):
        dst.copy_(new if ok is None else torch.where(ok, new, dst))

    # the four trees have one structure: their leaves pair up in order
    for (key, p), (_, p_g), (_, p_mu), (_, p_nu) in zip(
            tree_items(params), tree_items(grads), tree_items(state.mu),
            tree_items(state.nu)):
        if _is_frozen(key):
            continue
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        for p_s, g_s, mu_s, nu_s in zip(_slices(p), _slices(p_g),
                                        _slices(p_mu), _slices(p_nu)):
            g = g_s if scale is None else g_s * scale.to(g_s.dtype)
            g = g.float()
            mu = b1 * mu_s + (1 - b1) * g
            nu = b2 * nu_s + (1 - b2) * g.square()
            u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            if decay:
                u = u + decay * p_s.float()
            write(p_s, (p_s - lr * u).to(p_s.dtype))
            write(mu_s, mu)
            write(nu_s, nu)
    if ok is not None:
        step = torch.where(ok, step, state.step)
    return params, AdamWState(step, state.mu, state.nu), gnorm
