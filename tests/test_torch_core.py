"""The port's core math against the JAX package's jnp functions.

Same numpy inputs into both; float32 results within rtol = atol = 2e-5
(two implementations summing in different orders), the PCA statistics —
float64 sums in both packages — within 1e-10.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LokiConfig as JLokiConfig
from repro.core import attention as jattn
from repro.core import loki as jloki
from repro.core import pca as jpca
from repro_torch.configs.base import LokiConfig
from repro_torch.core import attention, loki, pca

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("s,chunk", [(64, 512), (64, 16), (48, 32)])
@pytest.mark.parametrize("sliding_window", [0, 10])
def test_causal_attention(s, chunk, sliding_window):
    """One chunk, several, and a length the chunk does not divide (JAX
    then takes one chunk; the port a shorter last one — rows are
    independent)."""
    q = _rand(2, s, 4, 16, seed=1)
    k = _rand(2, s, 2, 16, seed=2)
    v = _rand(2, s, 2, 16, seed=3)
    want = jattn.causal_attention(*_j(q, k, v), chunk=chunk,
                                  sliding_window=sliding_window)
    got = attention.causal_attention(*_t(q, k, v), chunk=chunk,
                                     sliding_window=sliding_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sliding_window", [0, 7])
def test_decode_full(sliding_window):
    q = _rand(3, 4, 16, seed=4)
    k = _rand(3, 32, 2, 16, seed=5)
    v = _rand(3, 32, 2, 16, seed=6)
    cur = np.array([32, 9, 1], np.int32)
    want = jattn.decode_full(*_j(q, k, v, cur),
                             sliding_window=sliding_window)
    got = attention.decode_full(*_t(q, k, v, cur),
                                sliding_window=sliding_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_heads_and_attend_selected():
    rng = np.random.RandomState(7)
    cache_k = _rand(2, 24, 2, 8, seed=8)
    cache_v = _rand(2, 24, 2, 12, seed=9)
    idx = rng.randint(0, 24, size=(2, 2, 3, 5)).astype(np.int32)
    valid = rng.rand(2, 2, 3, 5) > 0.3
    q = _rand(2, 6, 8, seed=10)
    jk = jattn.gather_heads(*_j(cache_k, idx))
    tk = attention.gather_heads(*_t(cache_k, idx))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jv = jattn.gather_heads(*_j(cache_v, idx))
    want = jattn.attend_selected(jnp.asarray(q), jk, jv, jnp.asarray(valid),
                                 logit_scale=0.3)
    got = attention.attend_selected(torch.from_numpy(q), tk,
                                    attention.gather_heads(*_t(cache_v, idx)),
                                    torch.from_numpy(valid), logit_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _orthogonal(hkv, dim, seed):
    rng = np.random.RandomState(seed)
    return np.stack([np.linalg.qr(rng.randn(dim, dim))[0]
                     for _ in range(hkv)]).astype(np.float32)


@pytest.mark.parametrize("sliding_window", [0, 40])
@pytest.mark.parametrize("kd", [32, 16])
def test_loki_decode_token_topk(sliding_window, kd):
    b, hkv, g, s, dim = 2, 2, 2, 96, 32
    q = _rand(b, hkv * g, dim, seed=11)
    k = _rand(b, s, hkv, kd, seed=12)
    v = _rand(b, s, hkv, dim, seed=13)
    proj = _orthogonal(hkv, dim, seed=14)
    cur = np.array([96, 30], np.int32)
    jcfg = JLokiConfig(enabled=True, min_k=8)
    cfg = LokiConfig(**dataclasses.asdict(jcfg))
    scale = None if kd == dim else dim ** -0.5
    want = jloki.loki_decode(*_j(q, k, v, cur, proj), jcfg,
                             sliding_window=sliding_window,
                             logit_scale=scale)
    got = loki.loki_decode(*_t(q, k, v, cur, proj), cfg,
                           sliding_window=sliding_window, logit_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_token_topk_ties_go_to_lower_index():
    """Equal approximate scores: lax.top_k keeps index order, and so must
    the port (torch.topk promises no order)."""
    scores = np.zeros((1, 1, 1, 40), np.float32)
    scores[..., [3, 9, 17, 30, 31]] = 5.0       # five-way tie for the top
    scores[..., 20:] = np.where(scores[..., 20:] == 0, -1e30,
                                scores[..., 20:])
    jcfg = JLokiConfig(enabled=True, k_f=0.1, min_k=4)
    cfg = LokiConfig(**dataclasses.asdict(jcfg))
    jidx, jvalid = jloki.select_topk(jnp.asarray(scores), jcfg,
                                     jnp.int32(20), 40)
    tidx, tvalid = loki.select_topk(torch.from_numpy(scores), cfg,
                                    torch.tensor(20), 40)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tidx.numpy().ravel().tolist() == [3, 9, 17, 30]


def test_project_qk():
    q = _rand(2, 4, 16, seed=15)
    k = _rand(2, 5, 2, 16, seed=16)
    proj = _orthogonal(2, 16, seed=17)
    jq, jk = jloki.project_qk(*_j(q, k, proj))
    tq, tk = loki.project_qk(*_t(q, k, proj))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)


def test_pca_statistics_and_eigenbasis():
    """KeyStats sums and covariances (float64 in both packages), the
    normalized spectra, and eigenvectors up to each column's sign."""
    rng = np.random.RandomState(18)
    mix = rng.randn(8, 8)
    st_j = jpca.KeyStats.create(2, 3, 8)
    st_t = pca.KeyStats.create(2, 3, 8)
    for i in range(3):
        keys = (rng.randn(2, 2, 10, 3, 8) @ mix).astype(np.float32)
        st_j.update(keys)
        st_t.update(torch.from_numpy(keys))
    assert st_t.count == st_j.count
    np.testing.assert_allclose(st_t.covariance(), st_j.covariance(),
                               rtol=1e-10, atol=1e-10)
    p_j, e_j = jpca.eig_projections(st_j.covariance())
    p_t, e_t = pca.eig_projections(st_t.covariance())
    np.testing.assert_allclose(e_t, e_j, rtol=1e-6, atol=1e-7)
    sign = np.sign((p_t * p_j).sum(axis=-2, keepdims=True))
    np.testing.assert_allclose(p_t * sign, p_j, atol=1e-5)
    np.testing.assert_array_equal(pca.rank_at(e_t, 0.9),
                                  jpca.rank_at(e_j, 0.9))
