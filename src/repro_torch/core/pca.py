"""Offline PCA calibration of attention keys (paper Section 3 + 4.1).

The torch counterpart of ``repro.core.pca``. Streaming per-(layer, head)
second-moment accumulation over a calibration run, eigendecomposition into
orthogonal projections P (descending explained variance), and the Rank@v
analysis of Figures 1/2.

The statistics and the eigendecomposition stay in numpy float64, as in the
JAX package, so the eigenvectors match the reference. The outer products
are taken on the keys' own device in float64 (the card when serving), so
only the (L, Hkv, D, D) sums cross to the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class KeyStats:
    """Streaming covariance stats for keys of shape (L, Hkv, D)."""
    sum_outer: np.ndarray   # (L, Hkv, D, D)
    sum_vec: np.ndarray     # (L, Hkv, D)
    count: int

    @classmethod
    def create(cls, n_layers: int, n_kv: int, d: int) -> "KeyStats":
        return cls(np.zeros((n_layers, n_kv, d, d), np.float64),
                   np.zeros((n_layers, n_kv, d), np.float64), 0)

    def update(self, keys) -> None:
        """keys: (L, B, S, Hkv, D) tensor or array (one captured pass)."""
        k = torch.as_tensor(keys).to(torch.float64)
        l, b, s, h, d = k.shape
        k = k.movedim(3, 1).reshape(l, h, b * s, d)
        self.sum_outer += (k.transpose(-1, -2) @ k).cpu().numpy()
        self.sum_vec += k.sum(dim=2).cpu().numpy()
        self.count += b * s

    def covariance(self) -> np.ndarray:
        mu = self.sum_vec / max(self.count, 1)
        return (self.sum_outer / max(self.count, 1)
                - np.einsum("lhd,lhe->lhde", mu, mu))


def eig_projections(cov: np.ndarray):
    """Eigendecompose (L,Hkv,D,D) covariances.

    Returns (P, eigvals): P (L,Hkv,D,D) with components as *columns* ordered
    by descending eigenvalue (so ``k @ P`` puts high-variance dims first),
    and the normalized eigenvalue spectra (L,Hkv,D), descending."""
    w, v = np.linalg.eigh(cov)          # ascending
    w = w[..., ::-1]
    v = v[..., ::-1]
    w = np.maximum(w, 0.0)
    w_norm = w / np.maximum(w.sum(axis=-1, keepdims=True), 1e-12)
    return v.astype(np.float32), w_norm.astype(np.float32)


def rank_at(eigvals: np.ndarray, v: float = 0.90) -> np.ndarray:
    """Rank_{l,h}@v of Eq. (2): smallest d with cumulative variance >= v."""
    c = np.cumsum(eigvals, axis=-1)
    return (c < v).sum(axis=-1) + 1


@dataclasses.dataclass
class PCACalibration:
    """Projections for both candidate transforms (pre- and post-rotary
    covariance eigenbases; Lemma 4.1 holds for any orthogonal P)."""
    proj_pre: np.ndarray        # (L, Hkv, D, D)
    proj_post: np.ndarray
    eig_pre: np.ndarray         # (L, Hkv, D) normalized, descending
    eig_post: np.ndarray

    def projections(self, transform: str) -> np.ndarray:
        return self.proj_pre if transform == "pre" else self.proj_post


def calibrate(forward_capture, batches, n_layers: int, n_kv: int,
              d: int) -> PCACalibration:
    """Run ``forward_capture(batch) -> (pre_keys, post_keys)`` over
    calibration batches, each (L,B,S,Hkv,D), and produce both transforms."""
    st_pre = KeyStats.create(n_layers, n_kv, d)
    st_post = KeyStats.create(n_layers, n_kv, d)
    for batch in batches:
        pre, post = forward_capture(batch)
        st_pre.update(pre)
        st_post.update(post)
    p_pre, e_pre = eig_projections(st_pre.covariance())
    p_post, e_post = eig_projections(st_post.covariance())
    return PCACalibration(p_pre, p_post, e_pre, e_post)


def calibrate_model(params, cfg, token_batches,
                    frames=None) -> PCACalibration:
    """Calibrate PCA transforms for an LM by capturing its keys over token
    batches (each (B,S) integer tensor or array). ``frames``: the
    encoder-decoder's encoder input (B, enc_seq, d_model), shared across
    batches."""
    from repro_torch.models import lm
    device = params["embed"]["table"].device
    if frames is not None:
        frames = torch.as_tensor(frames, device=device)

    @torch.no_grad()
    def fwd(tokens):
        tokens = torch.as_tensor(tokens, device=device)
        _, _, (pre, post, _q) = lm.forward(params, tokens, cfg,
                                           frames=frames,
                                           capture_keys=True)
        return pre, post

    return calibrate(fwd, token_batches, cfg.n_layers, cfg.n_kv_heads,
                     cfg.resolved_head_dim)


def install_projections(params, calib: PCACalibration,
                        transform: str = "pre"):
    """Return params whose attention ``pca`` leaf is the calibrated
    projection (stacked (L,Hkv,D,D)). Everything else is shared by
    reference."""
    pca = params["layers"]["attn"]["pca"]
    proj = torch.as_tensor(calib.projections(transform)).to(
        device=pca.device, dtype=pca.dtype)
    new = dict(params)
    layers = dict(params["layers"])
    layers["attn"] = dict(layers["attn"], pca=proj)
    new["layers"] = layers
    return new
