"""Parameters from the JAX package's tree, handed over as numpy arrays.

The JAX tree of every model the port serves (``repro.models.lm.init``)
has the same nesting as the port's: stacked (L, ...) layer leaves, the
``pca`` leaf and, with qkv bias, ``bq``/``bk``/``bv``; the MoE layers'
``moe``; the hybrid layers' mamba leaves under ``ssm`` and their
``ln_ssm``; the ssm family's list of per-layer trees (mLSTM or sLSTM under
``ssm``; its layers are not stacked, ``cache_spec.uses_scan``); the
encoder-decoder's ``enc_layers``/``enc_norm`` and each decoder layer's
``ln_x``/``xattn``; the vlm's ``vision_adapter``. The caller converts it
with ``jax.tree.map(np.asarray, params)``, so this module never sees JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serving import cache_spec as CS

_LAYOUT = {True: "stacked (L, ...) leaves",
           False: "a list of per-layer trees"}


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """numpy tree -> the port's parameters on ``device`` (the card unless
    ``device="cpu"``), matrices cast once to ``cfg.dtype``."""
    dev = resolve_device(device)
    stacked = {"layers": CS.uses_scan(cfg), "enc_layers": True}
    for key, want in stacked.items():
        if key in tree and isinstance(tree[key], dict) != want:
            raise ValueError(f"expected {_LAYOUT[want]} under {key!r}")
    params = lm.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
    return lm.cast_params(params, cfg)
