"""Train, eval and serve steps (counterpart of ``repro.training.step``).

``make_train_step`` builds the step: loss -> grad -> (compression) ->
AdamW, with gradient accumulation over microbatches, a remat policy and
NaN-skip. The state holds float32 masters (``cfg.param_dtype``);
``loss_fn`` casts them to the compute dtype inside the function autograd
differentiates, so the gradients land on the masters in float32, as the
JAX code's ``.astype`` at every use gives them. The step updates the
state in place (the JAX step donates it) and returns device tensors as
metrics: nothing in it waits for the host.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim.compression import compressed_psum


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def loss_fn(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """(loss + 1e-2 * aux, (loss, aux)): the cross entropy with z-loss
    over ``batch["labels"]`` (masked by ``batch["mask"]`` if given) and
    the MoE layers' aux loss (0 for the dense family). The batch's
    ``frames`` (encoder-decoder) and ``patches`` (vlm) go to the forward
    when present."""
    logits, aux = lm.forward(lm.cast_params(params, cfg), batch["tokens"],
                             cfg, frames=batch.get("frames"),
                             patches=batch.get("patches"),
                             remat=tcfg.remat)
    loss = L.softmax_xent(logits, batch["labels"], z_loss=tcfg.z_loss,
                          mask=batch.get("mask"))
    return loss + 1e-2 * aux, (loss, aux)


def grads_of(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """(grads, loss, aux) of ``loss_fn``; a leaf the loss does not use
    (the PCA bases) gets zeros, as ``jax.grad`` gives it."""
    live = lm.tree_map(lambda p: p.detach().requires_grad_(), params)
    total, (loss, aux) = loss_fn(live, batch, cfg, tcfg)
    keys, xs = zip(*lm.tree_items(live))
    gs = dict(zip(keys, torch.autograd.grad(total, xs, allow_unused=True)))
    grads = lm.tree_rebuild(
        params, lambda key, p: gs[key] if gs[key] is not None
        else torch.zeros_like(p))
    return grads, loss.detach(), aux.detach()


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        b = batch["tokens"].shape[0]
        if tcfg.microbatch and tcfg.microbatch < b:
            mb = tcfg.microbatch
            if b % mb:
                raise ValueError(f"batch {b} is not a whole number of "
                                 f"{mb}-row microbatches")
            n = b // mb
            grads, loss, aux = None, 0.0, 0.0
            for i in range(n):      # summed in microbatch order, then / n
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, l_i, a_i = grads_of(params, micro, cfg, tcfg)
                if grads is None:
                    grads = g
                else:
                    for (_, acc), (_, g_i) in zip(lm.tree_items(grads),
                                                  lm.tree_items(g)):
                        acc.add_(g_i)
                loss, aux = loss + l_i, aux + a_i
            for _, acc in lm.tree_items(grads):
                acc.div_(n)
            loss, aux = loss / n, aux / n
        else:
            grads, loss, aux = grads_of(params, batch, cfg, tcfg)

        if tcfg.grad_compression != "none":
            grads = compressed_psum(grads, tcfg)

        params, opt, gnorm = adamw.apply_updates(
            params, grads, state.opt, tcfg,
            guard=loss if tcfg.nan_skip else None)
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm,
                   "step": opt.step}
        return TrainState(params, opt), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, tcfg: Optional[TrainConfig] = None):
    """params, batch -> {"loss", "ppl_proxy", "acc"}: the cross entropy
    without z-loss, its exp, and the argmax accuracy. ``tcfg`` is taken
    for the reference's signature; the step uses none of it."""
    del tcfg

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = lm.forward(lm.cast_params(params, cfg), batch["tokens"],
                               cfg)
        loss = L.softmax_xent(logits, batch["labels"],
                              mask=batch.get("mask"))
        acc = (logits.argmax(-1) == batch["labels"].long()).float().mean()
        return {"loss": loss, "ppl_proxy": torch.exp(loss), "acc": acc}

    return eval_step


def make_serve_steps(cfg: ModelConfig, smax: int):
    """(prefill_fn, decode_fn) over the port's contiguous cache; the
    prefill takes the reference's ``frames``/``patches``."""
    def prefill_fn(params, tokens, frames=None, patches=None):
        return lm.prefill(params, cfg, tokens, smax, frames=frames,
                          patches=patches)

    def decode_fn(params, cache, token, pos_len):
        return lm.decode_step(params, cfg, cache, token, pos_len)

    return prefill_fn, decode_fn
