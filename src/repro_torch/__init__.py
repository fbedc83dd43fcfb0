"""Loki on PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``repro`` module for module (``configs``, ``core``,
``kernels``, ``models``, ``serving``, ``launch``, ``data``). The package
imports torch, numpy and the standard library only. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; the
decode kernels are CUDA C++ in ``csrc/``, built with ``nvcc`` on first use.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when CUDA is requested but absent — an entry point
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev
