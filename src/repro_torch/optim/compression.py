"""Gradient compression for slow cross-pod links (counterpart of
``repro.optim.compression``).

* ``topk`` keeps the largest ``ratio`` of each leaf by magnitude (ties
  to the lower index, ``lax.top_k``'s order); ``error_feedback_compress``
  carries what was not sent into the next step in float32.
* ``int8`` quantizes each 256-element chunk symmetrically before the
  reduce and dequantizes after (``torch.round`` rounds half to even, as
  ``jnp.round`` does).

In one process ``compressed_psum`` has no reduction to make: it
compresses and decompresses every leaf, which models the wire format and
the numerical error it brings. Top-k applies only to leaves of at least
1024 elements.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.loki import topk_lower_index
from repro_torch.models.lm import tree_map


def topk_compress(g: torch.Tensor, ratio: float):
    """Keep the top ``ratio`` fraction by magnitude. Returns (values, idx,
    size)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    _, idx = topk_lower_index(flat.abs(), k)
    return flat[idx], idx, flat.numel()


def topk_decompress(vals, idx, size: int):
    return torch.zeros((size,), dtype=vals.dtype,
                       device=vals.device).index_put((idx,), vals)


def int8_compress(g: torch.Tensor, chunk: int = 256):
    """Per-chunk symmetric int8. Returns (q (n, chunk) int8, scale (n, 1)
    float32, shape, pad)."""
    flat = g.reshape(-1).float()
    pad = (-flat.numel()) % chunk
    c = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, chunk)
    scale = c.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(c / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale, tuple(g.shape), pad


def int8_decompress(q, scale, shape, pad: int):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum(grads, tcfg: TrainConfig):
    """Apply the configured wire-format compression to every gradient
    leaf."""
    if tcfg.grad_compression == "topk":
        def leaf(g):
            if g.ndim == 0 or g.numel() < 1024:
                return g
            vals, idx, size = topk_compress(g, tcfg.compression_ratio)
            return topk_decompress(vals, idx, size).reshape(g.shape)
        return tree_map(leaf, grads)
    if tcfg.grad_compression == "int8":
        def leaf(g):
            if g.ndim == 0:
                return g
            return int8_decompress(*int8_compress(g)).to(g.dtype)
        return tree_map(leaf, grads)
    return grads


def error_feedback_compress(g, err, ratio: float):
    """Top-k with error feedback: returns (wire values, wire idx, new
    err)."""
    corrected = g.float() + err
    vals, idx, size = topk_compress(corrected, ratio)
    sent = topk_decompress(vals, idx, size).reshape(g.shape)
    return vals, idx, corrected - sent
