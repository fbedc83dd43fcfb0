"""The port's per-head pipeline and flash attention against the JAX package.

On CPU tensors the port's wrappers run the kernels' plain torch versions
(the CUDA kernels are held against those same plain versions on the card by
chip_smoke.py). Here the plain versions of block_max_scores,
block_max_scores_fm, block_sparse_attention and flash_attention meet the
JAX Pallas kernels in interpret mode and the oracles of
``repro.kernels.ref`` on the same numpy inputs, over the parameter grids of
tests/test_kernels.py and with its tolerances (fp32 2e-5 / 1e-5 / 2e-5,
bf16 2e-2 / 5e-2 / 3e-2 for block maxima / sparse attention / flash).
The ``ops`` pipelines meet JAX's ``ops.loki_decode_attention`` and its
feature-major twin, and the whole slice is one llama2-7b smoke decode
step whose recorded kernel calls run per head through both packages.
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.approx_scores import block_max_scores as jbms
from repro.kernels.approx_scores_fm import block_max_scores_fm as jbms_fm
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.gather_attention import block_sparse_attention as jbsa
from repro_torch.configs import get_smoke_config
from repro_torch.core import pca
from repro_torch.kernels import gather_attention, ops
from repro_torch.kernels.approx_scores import block_max_scores
from repro_torch.kernels.approx_scores_fm import block_max_scores_fm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gather_attention import block_sparse_attention
from repro_torch.models import lm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's tolerances, by kernel and dtype
SCORE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TOL = dict(rtol=2e-5, atol=2e-5)


def _pair(a, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of one dtype
    (both round fp32 to bf16 to nearest even: the same values)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a.copy()).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _decode_inputs(bh, s, dim, seed, cur):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, dim).astype(np.float32),
            rng.randn(bh, s, dim).astype(np.float32),
            rng.randn(bh, s, dim).astype(np.float32),
            np.asarray(cur, np.int32))


# ------------------------------------------------------------ block maxima

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,dim,bs,d", [
    (4, 256, 64, 32, 16),
    (2, 512, 128, 128, 32),
    (1, 128, 128, 64, 64),
    (3, 384, 256, 128, 32),
    (8, 256, 64, 64, 8),
])
def test_block_max_scores_matches_ref(bh, s, dim, bs, d, dtype):
    rng = np.random.RandomState(bh * s + d)
    q = rng.randn(bh, dim).astype(np.float32)
    k = rng.randn(bh, s, dim).astype(np.float32)
    cur = rng.randint(1, s + 1, size=bh).astype(np.int32)
    (jq, tq), (jk, tk) = _pair(q, dtype), _pair(k, dtype)
    want = ref.block_max_scores_ref(jq, jk, jnp.asarray(cur), d=d,
                                    block_size=bs)
    got = block_max_scores(tq, tk, torch.from_numpy(cur), d=d, block_size=bs)
    assert got.dtype == torch.float32 and got.shape == (bh, s // bs)
    _close(got, want, SCORE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_max_scores_matches_pallas(dtype):
    """Against the Pallas kernel in interpret mode; the short row has dead
    blocks, which both give exactly -1e30."""
    q, k, _, cur = _decode_inputs(2, 256, 64, seed=5, cur=[256, 40])
    (jq, tq), (jk, tk) = _pair(q, dtype), _pair(k, dtype)
    want = jbms(jq, jk, jnp.asarray(cur), d=16, block_size=32,
                interpret=True)
    got = block_max_scores(tq, tk, torch.from_numpy(cur), d=16,
                           block_size=32)
    _close(got, want, SCORE_TOL[dtype])
    assert (got[1, 2:] == -1e30).all()
    np.testing.assert_array_equal(_np(got)[1, 2:], _np(want)[1, 2:])


@pytest.mark.parametrize("bh,s,dim,bs,d", [
    (4, 256, 64, 64, 16), (2, 512, 128, 128, 32), (8, 256, 128, 64, 64),
    (1, 384, 64, 128, 8), (2, 390, 64, 30, 8),
])
def test_block_max_scores_fm_matches_ref_and_token_major(bh, s, dim, bs, d):
    q, k, _, _ = _decode_inputs(bh, s, dim, seed=bh * s, cur=[0])
    cur = np.random.RandomState(s).randint(s // 2, s + 1, size=bh).astype(
        np.int32)
    scale = dim ** -0.5
    want = ref.block_max_scores_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(cur), d=d, block_size=bs,
                                    scale=scale)
    tq, tk, tcur = (torch.from_numpy(x) for x in (q, k, cur))
    got = block_max_scores_fm(tq, tk.transpose(1, 2).contiguous(), tcur, d=d,
                              block_size=bs, scale=scale)
    _close(got, want, 1e-5)
    _close(got, block_max_scores(tq, tk, tcur, d=d, block_size=bs,
                                 scale=scale), 1e-5)


def test_block_max_scores_fm_matches_pallas():
    q, k, _, cur = _decode_inputs(2, 256, 64, seed=6, cur=[200, 33])
    kT = np.ascontiguousarray(k.transpose(0, 2, 1))
    want = jbms_fm(jnp.asarray(q), jnp.asarray(kT), jnp.asarray(cur), d=16,
                   block_size=64, interpret=True)
    got = block_max_scores_fm(torch.from_numpy(q), torch.from_numpy(kT),
                              torch.from_numpy(cur), d=16, block_size=64)
    _close(got, want, SCORE_TOL["float32"])


# ------------------------------------------------- per-head sparse attention

def _selection(bh, nb, nsel, seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(nb)[:nsel] for _ in range(bh)]
                    ).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,dim,bs,nsel", [
    (4, 256, 64, 32, 4),
    (2, 512, 128, 128, 2),
    (3, 384, 256, 128, 3),
    (1, 1024, 128, 128, 8),
])
def test_block_sparse_attention_matches_ref(bh, s, dim, bs, nsel, dtype):
    """Random distinct selections; the same through a feature-major cache
    read in place (a transposed view)."""
    q, k, v, _ = _decode_inputs(bh, s, dim, seed=nsel + s, cur=[0])
    cur = np.random.RandomState(bh).randint(bs, s + 1, size=bh).astype(
        np.int32)
    bidx = _selection(bh, s // bs, nsel, seed=bh + nsel)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    want = ref.block_sparse_attention_ref(jq, jk, jv, jnp.asarray(bidx),
                                          jnp.asarray(cur), block_size=bs)
    tidx, tcur = torch.from_numpy(bidx), torch.from_numpy(cur)
    got = block_sparse_attention(tq, tk, tv, tidx, tcur, block_size=bs)
    assert got.dtype == tq.dtype and got.shape == (bh, dim)
    _close(got, want, ATTN_TOL[dtype])
    fm = tk.transpose(1, 2).contiguous().transpose(1, 2)
    assert fm.stride()[1] == 1
    assert torch.equal(block_sparse_attention(tq, fm, tv, tidx, tcur,
                                              block_size=bs), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_attention_matches_pallas(dtype):
    """Against the Pallas kernel in interpret mode, with a row whose
    selected blocks all lie past cur_len: zeros in both."""
    q, k, v, cur = _decode_inputs(3, 256, 64, seed=8, cur=[256, 90, 20])
    bidx = np.array([[7, 2, 0], [1, 3, 2], [5, 1, 6]], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    want = jbsa(jq, jk, jv, jnp.asarray(bidx), jnp.asarray(cur),
                block_size=32, interpret=True)
    got = block_sparse_attention(tq, tk, tv, torch.from_numpy(bidx),
                                 torch.from_numpy(cur), block_size=32)
    _close(got, want, ATTN_TOL[dtype])
    assert (got[2] == 0).all() and (_np(want)[2] == 0).all()


@pytest.mark.parametrize("fm", [False, True])
def test_block_sparse_attention_cluster_matches_pallas(fm):
    """#8's cluster form (entries kept in list order, per-CTA shares and
    partials with the dot scaled after it, the rank-ordered log-sum-exp
    merge) at C = 1 and 3 against the Pallas kernel in interpret mode,
    over a token-major K̂ or a feature-major K̂ᵀ read through
    transpose(1, 2); the row whose blocks all lie past cur_len gives
    zeros."""
    q, k, v, cur = _decode_inputs(3, 256, 64, seed=9, cur=[256, 90, 20])
    bidx = np.array([[7, 2, 0, 5], [1, 3, 2, 0], [5, 1, 6, 2]], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x) for x in (q, k, v))
    want = jbsa(jq, jk, jv, jnp.asarray(bidx), jnp.asarray(cur),
                block_size=32, interpret=True)
    if fm:
        tk = tk.transpose(1, 2).contiguous().transpose(1, 2)
    for n_cta in (1, 3):
        got = gather_attention.head_cluster_plain(
            tq, tk, tv, torch.from_numpy(bidx), torch.from_numpy(cur),
            block_size=32, scale=64 ** -0.5, n_cta=n_cta)
        _close(got, want, ATTN_TOL["float32"])
        assert (got[2] == 0).all()


# --------------------------------------------------------------------- flash

def _flash_inputs(bh, sq, sk, dim, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, dim).astype(np.float32),
            rng.randn(bh, sk, dim).astype(np.float32),
            rng.randn(bh, sk, dim).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,dim,bq,bk", [
    (2, 128, 128, 64, 32, 32),
    (1, 256, 256, 128, 128, 64),
    (3, 128, 128, 256, 64, 128),
    (2, 64, 192, 64, 32, 64),        # Sq < Sk: top-left causal mask
    (2, 192, 64, 64, 64, 32),        # Sq > Sk
])
def test_flash_matches_ref(bh, sq, sk, dim, bq, bk, causal, dtype):
    q, k, v = _flash_inputs(bh, sq, sk, dim, seed=sq + sk + dim)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = flash_attention(tq, tk, tv, block_q=bq, block_k=bk, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (bh, sq, dim)
    _close(got, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas(causal):
    q, k, v = _flash_inputs(2, 64, 128, 32, seed=9)
    want = jflash(*(jnp.asarray(x) for x in (q, k, v)), block_q=32,
                  block_k=64, causal=causal, interpret=True)
    got = ops.flash(*(torch.from_numpy(x) for x in (q, k, v)), block_q=32,
                    block_k=64, causal=causal)
    _close(got, want, FLASH_TOL["float32"])


# ------------------------------------------------------------- the pipelines

@pytest.mark.parametrize("d,k_blocks,cur", [
    (16, 2, [256, 256, 256, 256]),
    (8, 3, [256, 150, 70, 1]),      # dead blocks tie in the selection
])
def test_pipelines_match_jax(d, k_blocks, cur):
    q, k, v, cur = _decode_inputs(4, 256, 64, seed=d + k_blocks, cur=cur)
    kT = np.ascontiguousarray(k.transpose(0, 2, 1))
    kw = dict(d=d, k_blocks=k_blocks, block_size=64)
    j = [jnp.asarray(x) for x in (q, k, v, cur, kT)]
    t = [torch.from_numpy(x) for x in (q, k, v, cur, kT)]
    want = jops.loki_decode_attention(*j[:4], **kw, interpret=True)
    got = ops.loki_decode_attention(*t[:4], **kw)
    _close(got, want, TOL["atol"])
    want_fm = jops.loki_decode_attention_fm(j[0], j[4], j[2], j[3], **kw,
                                            interpret=True)
    got_fm = ops.loki_decode_attention_fm(t[0], t[4], t[2], t[3], **kw)
    _close(got_fm, want_fm, TOL["atol"])
    assert torch.equal(got_fm, got)


def test_all_blocks_selected_equals_dense():
    """k_blocks = all blocks: the pipeline is dense attention."""
    q, k, v, _ = _decode_inputs(2, 256, 64, seed=3, cur=[0])
    cur = np.array([256, 128], np.int32)
    tq, tk, tv, tcur = (torch.from_numpy(x) for x in (q, k, v, cur))
    out = ops.loki_decode_attention(tq, tk, tv, tcur, d=64, k_blocks=8,
                                    block_size=32)
    sc = np.einsum("bd,bsd->bs", q, k) * 64 ** -0.5
    sc = np.where(np.arange(256)[None] < cur[:, None], sc, -np.inf)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    want = np.einsum("bs,bsd->bd", w / w.sum(-1, keepdims=True), v)
    _close(out, want, 2e-5)


def test_feature_major_pipeline_matches_token_major():
    q, k, v, _ = _decode_inputs(4, 512, 64, seed=42, cur=[0])
    cur = torch.full((4,), 512, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = ops.loki_decode_attention(tq, tk, tv, cur, d=16, k_blocks=2,
                                   block_size=128)
    fm = ops.loki_decode_attention_fm(tq, tk.transpose(1, 2).contiguous(),
                                      tv, cur, d=16, k_blocks=2,
                                      block_size=128)
    _close(fm, tm, 1e-5)


# ----------------------------------------------------------- the whole slice

@contextlib.contextmanager
def _recording(module, name):
    real, calls = getattr(module, name), []

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _per_head(q, k, v, cur):
    """(B,Hkv,1,W),(B,S,Hkv,W),(B,S,Hkv,D),(B,) -> per-head (BH,·) rows."""
    b, n_kv, g, w = q.shape
    assert g == 1
    rows = lambda x: x.transpose(1, 2).reshape(b * n_kv, x.shape[1],
                                               x.shape[-1]).contiguous()
    return (q.reshape(b * n_kv, w), rows(k), rows(v),
            cur.repeat_interleave(n_kv))


def test_smoke_decode_step_per_head_matches_jax():
    """One llama2-7b smoke decode step through the kernel backend; each
    layer's recorded fused call, flattened per head, goes through the
    port's pipelines and JAX's interpret-mode pipeline on the same arrays
    (within 2e-5), and the per-head pipeline equals the fused kernel
    without its recency window (G = 1: group-shared selection is per-head
    selection)."""
    cfg = get_smoke_config("llama2-7b").with_policy(
        "loki_block", k_f=0.25, d_f=0.25, block_size=32, local_window=0)
    cfg = cfg.replace(loki=dataclasses.replace(cfg.loki, backend="pallas"))
    params = lm.init(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, cfg.vocab, size=(2, 48)) for _ in range(2)]
    params = pca.install_projections(
        params, pca.calibrate_model(params, cfg, batches), "pre")
    toks = torch.as_tensor(rng.randint(0, cfg.vocab, size=(2, 150)))
    logits, cache, pos = lm.prefill(params, cfg, toks, 256,
                                    cache_dtype=torch.float32)
    with _recording(ops, "loki_decode_fused") as calls:
        lm.decode_step(params, cfg, cache, logits.argmax(-1), pos)
    assert len(calls) == cfg.n_layers
    for args, kwargs, out in calls:
        q, k, v, cur = _per_head(*args)
        kw = dict(d=kwargs["d"], k_blocks=kwargs["k_blocks"],
                  block_size=kwargs["block_size"])
        assert kw["d"] % 8 == 0 and kwargs["local_window"] == 0
        kT = k.transpose(1, 2).contiguous()
        got = ops.loki_decode_attention(q, k, v, cur, **kw)
        got_fm = ops.loki_decode_attention_fm(q, kT, v, cur, **kw)
        j = [jnp.asarray(x.numpy()) for x in (q, k, v, cur, kT)]
        want = jops.loki_decode_attention(*j[:4], **kw, interpret=True)
        want_fm = jops.loki_decode_attention_fm(j[0], j[4], j[2], j[3],
                                                **kw, interpret=True)
        _close(got, want, TOL["atol"])
        _close(got_fm, want_fm, TOL["atol"])
        fused = ops.loki_decode_fused(*args, **dict(
            kwargs, scale=q.shape[-1] ** -0.5))
        _close(got, fused.reshape(got.shape), TOL["atol"])


# ----------------------------------------------------------- the contract

def test_contract_raises():
    q, k, v, cur = (torch.from_numpy(x) for x in
                    _decode_inputs(2, 200, 64, seed=1, cur=[200, 100]))
    with pytest.raises(ValueError, match="multiple of block_size"):
        block_max_scores(q, k, cur, d=16, block_size=64)
    with pytest.raises(ValueError, match="multiple of block_size"):
        block_max_scores_fm(q, k.transpose(1, 2), cur, d=16, block_size=64)
    with pytest.raises(ValueError, match="multiple of block_size"):
        block_sparse_attention(q, k, v, torch.zeros((2, 1), dtype=torch.int32),
                               cur, block_size=64)
    k2 = k[:, :192]
    with pytest.raises(ValueError, match="multiple of 8"):
        block_max_scores_fm(q, k2.transpose(1, 2), cur, d=12, block_size=64)
    with pytest.raises(ValueError, match="k_blocks"):
        ops.loki_decode_attention(q, k2.contiguous(), v[:, :192].contiguous(),
                                  cur, d=16, k_blocks=4, block_size=64)
    # neither the token nor the feature stride is 1
    odd = torch.zeros(2, 64, 192, 2)[..., 0].transpose(1, 2)
    with pytest.raises(ValueError, match="strides"):
        block_sparse_attention(q, odd, v[:, :192].contiguous(),
                               torch.zeros((2, 1), dtype=torch.int32), cur,
                               block_size=64)
    fq, fk, fv = (torch.from_numpy(x) for x in _flash_inputs(1, 3000, 256,
                                                             64, seed=2))
    with pytest.raises(ValueError, match="multiples"):
        flash_attention(fq, fk, fv)                 # Sq 3000 % 128
    with pytest.raises(ValueError, match="multiples"):
        flash_attention(fk, fq, fq)                 # Sk 3000 % 128
