"""Parameters from the JAX package's tree, handed over as numpy arrays.

The JAX tree of a dense model (``repro.models.lm.init``) has the same
nesting as the port's: stacked (L, ...) layer leaves, the ``pca`` leaf and,
with qkv bias, ``bq``/``bk``/``bv``. The caller converts it with
``jax.tree.map(np.asarray, params)``, so this module never sees JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """numpy tree -> the port's parameters on ``device`` (the card unless
    ``device="cpu"``), matrices cast once to ``cfg.dtype``."""
    lm.check_family(cfg)
    dev = resolve_device(device)
    if not isinstance(tree.get("layers"), dict):
        raise ValueError("expected stacked (L, ...) layer leaves")
    params = lm.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
    return lm.cast_params(params, cfg)
