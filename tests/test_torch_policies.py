"""The paper's baseline policies and chunked Loki in the port, against the
JAX package's, on CPU; and the packed decode's launch plan.

``pcaattn_decode``, ``h2o_decode`` (step by step through evictions, its
state compared too) and ``loki_decode_chunked`` meet their JAX functions
on the same numpy inputs; ``lm.prefill`` + ``decode_step`` under each of
the three policies meet JAX's on the same weights (llama2-7b smoke); the
dense engine serves h2o as sequential ``decode_step`` does; the launcher
falls back to the dense engine for a policy that cannot be paged. The
last test records the rows a packed paged step plans its kernels for.
Tolerance 2e-5 at float32, the kernels' own.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import LokiConfig as JLokiConfig
from repro.core import baselines as jbaselines
from repro.core import loki as jloki
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import LokiConfig
from repro_torch.core import baselines, loki
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import PagedServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)


def _jit(fn, **static):
    """JAX's entry point jitted with its static arguments bound: one
    compile per test instead of one per primitive (called by keyword)."""
    return jax.jit(functools.partial(fn, **static))


B, H, HKV, D, SMAX = 2, 4, 2, 16, 64


def _qkv(seed, smax=SMAX, kd=D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, smax, HKV, kd).astype(np.float32)
    v = rng.randn(B, smax, HKV, D).astype(np.float32)
    proj = np.stack([np.linalg.qr(rng.randn(D, D))[0]
                     for _ in range(HKV)]).astype(np.float32)
    return q, k, v, proj


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def test_pcaattn_decode_matches_jax():
    """Scores over the leading d PCA dims at D**-0.5, softmax over the
    live prefix of each row."""
    q, k, v, proj = _qkv(0, kd=4)
    cur = np.array([40, 7], np.int32)
    want = jbaselines.pcaattn_decode(*map(jnp.asarray, (q, k, v, cur, proj)),
                                     JLokiConfig())
    got = baselines.pcaattn_decode(*_t(q, k, v, cur, proj), LokiConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_h2o_decode_matches_jax_through_evictions():
    """Twelve steps into an 8-slot budget from empty, each row at its own
    position: the first eight fill it, the rest evict (the recent half
    protected); out, k, v, pos, acc and fill equal JAX's at every step."""
    budget, steps = 8, 12
    rng = np.random.RandomState(1)
    jst = jbaselines.h2o_init(B, budget, HKV, D, jnp.float32)
    tst = baselines.h2o_init(B, budget, HKV, D, torch.float32)
    base = np.array([0, 30], np.int32)
    for i in range(steps):
        q = rng.randn(B, H, D).astype(np.float32)
        k = rng.randn(B, HKV, D).astype(np.float32)
        v = rng.randn(B, HKV, D).astype(np.float32)
        step = base + i
        jout, jst = jbaselines.h2o_decode(*map(jnp.asarray, (q, k, v)), jst,
                                          jnp.asarray(step))
        tout, tst = baselines.h2o_decode(*_t(q, k, v), tst,
                                         torch.from_numpy(step))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for name in ("k", "v", "acc"):
            np.testing.assert_allclose(getattr(tst, name).numpy(),
                                       np.asarray(getattr(jst, name)), **TOL)
        for name in ("pos", "fill"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)))
    assert int(tst.fill.min()) == budget
    # evictions happened: some early positions left the budget
    assert (tst.pos.numpy() >= base[:, None] + budget).any()


@pytest.mark.parametrize("n_chunks,sw,lw", [(2, 0, 4), (4, 24, 0)])
def test_loki_decode_chunked_matches_jax(n_chunks, sw, lw):
    """Per-chunk top-(k / n_chunks) from the approximate scores, exact
    attention over the union; a short row leaves chunks with no live
    token (their picks invalid)."""
    q, k, v, proj = _qkv(2 + n_chunks)
    cur = np.array([SMAX, 11], np.int32)
    kw = dict(k_f=0.25, d_f=0.5, min_k=4, local_window=lw,
              n_chunks=n_chunks)
    want = jloki.loki_decode_chunked(*map(jnp.asarray, (q, k, v, cur, proj)),
                                     JLokiConfig(**kw), sliding_window=sw)
    got = loki.loki_decode_chunked(*_t(q, k, v, cur, proj), LokiConfig(**kw),
                                   sliding_window=sw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------- model and engine

POLICIES = {"pcaattn": {}, "h2o": {}, "loki": dict(n_chunks=4)}
POLICY_KW = dict(k_f=0.25, d_f=0.25, min_k=8, block_size=8)


def _model(policy):
    kw = dict(POLICY_KW, **POLICIES[policy])
    jcfg = jget_smoke("llama2-7b").with_policy(policy, **kw)
    cfg = get_smoke_config("llama2-7b").with_policy(policy, **kw)
    params = jlm.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(4)
    hd = cfg.resolved_head_dim
    pca = np.stack([[np.linalg.qr(rng.randn(hd, hd))[0]
                     for _ in range(cfg.n_kv_heads)]
                    for _ in range(cfg.n_layers)]).astype(np.float32)
    params["layers"]["attn"]["pca"] = jnp.asarray(pca)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    return jcfg, cfg, params, tparams


@pytest.mark.parametrize("policy", list(POLICIES))
def test_prefill_and_decode_logits_match_jax(policy):
    """Prompts of 40 tokens (past h2o's 16-token budget) into a 64-row
    cache, then five decode steps; every step's logits vs JAX."""
    jcfg, cfg, params, tparams = _model(policy)
    toks = np.random.RandomState(5).randint(0, cfg.vocab, size=(2, 40))
    jl, jcache, jpos = _jit(jlm.prefill, cfg=jcfg, smax=SMAX,
                            cache_dtype=jnp.float32)(
        params, tokens=jnp.asarray(toks))
    tl, tcache, tpos = lm.prefill(tparams, cfg, torch.as_tensor(toks), SMAX,
                                  cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tcache["layers"]["attn"]) == set(jcache["layers"]["attn"])
    jdecode = _jit(jlm.decode_step, cfg=jcfg)
    for _ in range(5):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jdecode(params, cache=jcache, token=jnp.asarray(tok),
                             pos_len=jpos)
        tl, tcache = lm.decode_step(tparams, cfg, tcache,
                                    torch.as_tensor(tok), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name, arr in tcache["layers"]["attn"].items():
        np.testing.assert_allclose(arr.numpy(),
                                   np.asarray(jcache["layers"]["attn"][name]),
                                   **TOL)


def test_dense_engine_serves_h2o_as_sequential_decode():
    """Three requests through two slots (one waits for a free slot, whose
    budgeted state its prefill rewrites) give the tokens of each prompt
    decoded alone with lm.prefill + decode_step."""
    _, cfg, _, tparams = _model("h2o")
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32)
               for n in (30, 9, 21)]
    eng = ServingEngine(tparams, cfg, n_slots=2, smax=SMAX, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in
            enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(100)
    for r, p in zip(reqs, prompts):
        logits, cache, pos = lm.prefill(tparams, cfg,
                                        torch.as_tensor(p[None, :-1]), SMAX,
                                        cache_dtype=torch.float32)
        tok, want = torch.as_tensor(p[-1:]), []
        for _ in range(6):
            logits, cache = lm.decode_step(tparams, cfg, cache, tok, pos)
            tok = torch.argmax(logits, -1).to(torch.int32)
            want.append(int(tok[0]))
            pos = pos + 1
        assert r.out == want, (r.rid, r.out, want)


def test_launcher_falls_back_to_dense_for_unpageable_policy(capsys):
    """--engine paged with h2o prints the JAX launcher's note and serves
    through the dense engine; it does not raise."""
    reqs = serve.main(["--engine", "paged", "--policy", "h2o", "--arch",
                       "llama2-7b", "--requests", "2", "--max-new", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "note: policy 'h2o' cannot rebuild exact prefix attention" in out
    assert "falling back to the dense engine" in out
    assert "engine=dense" in out
    assert all(len(r.out) == 3 for r in reqs)


def test_chunked_loki_refused_on_a_tiered_pool():
    """As the reference: chunked selection has no tiered form."""
    cfg = get_smoke_config("llama2-7b").with_policy("loki", n_chunks=2,
                                                    block_size=8)
    params = lm.init(cfg, device="cpu")
    cache = lm.init_paged_cache(cfg, 5, 8, device_pages=3, device="cpu")
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="chunked"):
        lm.decode_step(params, cfg, cache, torch.tensor([1]),
                       torch.tensor([3]), page_table=table, page_size=8,
                       frame_table=torch.tensor([[1, 2]], dtype=torch.int32))


# ---------------------------------------------- packed decode's launch plan

_WRAPPERS = {"full": ("full_decode",),
             "exact_topk": ("exact_topk_decode_fused",
                            "loki_decode_two_kernel"),
             "loki_block": ("loki_decode_fused", "loki_decode_two_kernel")}


@pytest.mark.parametrize("policy", list(_WRAPPERS))
def test_packed_step_plans_for_the_engines_rows(policy, monkeypatch):
    """Fault 2's plumbing: every decode step of a packed paged engine hands
    the kernel wrappers the engine's rows (n_slots x Hkv) as an int, on
    packed steps of fewer rows too, so a slot's split count and cluster
    size never follow the step's batch; and the float32 unembedding runs
    over n_slots rows (on the card a one-row float32 GEMM rounds apart)."""
    cfg = get_smoke_config("qwen2.5-3b")
    kw = dict(k_f=0.5, d_f=0.5, block_size=8, local_window=4, min_k=4)
    cfg = (cfg.with_policy(policy, **kw) if policy != "full" else
           cfg.replace(loki=dataclasses.replace(cfg.loki, block_size=8)))
    cfg = cfg.replace(loki=dataclasses.replace(cfg.loki, backend="pallas"))
    params = lm.init(cfg, seed=0, device="cpu")
    seen = []
    for name in _WRAPPERS[policy]:
        real = getattr(ops, name)

        def rec(*a, _real=real, **k):
            seen.append((a[0].shape[0], k.get("plan_rows")))
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, rec)
    unembed_rows = []
    real_unembed = lm.L.unembed_apply

    def unembed(p, x, cfg):
        unembed_rows.append(x.shape[0])
        return real_unembed(p, x, cfg)
    monkeypatch.setattr(lm.L, "unembed_apply", unembed)
    n_slots = 4
    eng = PagedServingEngine(params, cfg, n_slots=n_slots, smax=64,
                             page_size=8, prefill_chunk=8, device="cpu")
    rng = np.random.RandomState(7)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab, size=n)
                    .astype(np.int32), max_new=m)
            for i, (n, m) in enumerate(((20, 3), (12, 9), (9, 5)))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(200)
    assert eng.stats()["packed"]["n_packed_ticks"] > 0
    rows = {r for _, r in seen}
    assert rows == {n_slots * cfg.n_kv_heads}, rows
    assert all(isinstance(r, int) for r in rows)
    assert {b for b, _ in seen} > {n_slots}     # narrower packed steps ran
    st = eng.stats()                            # prefill chunks: 1 row
    assert sorted(unembed_rows) == [1] * st["n_prefill_chunks"] \
        + [n_slots] * st["n_decode_steps"]
