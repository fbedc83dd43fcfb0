"""The port's paged serving path against the JAX package's, on CPU.

The paged-cache helpers and the page pool meet their JAX counterparts on
the same numpy pools, tables and alloc/release scripts. The model's paged
entry points (``prefill_chunk`` into a shuffled pool, then four batched
``decode_step(page_table=...)``) meet JAX's on the same weights, handed over
through numpy, for the four paged policies; the kernels' plain versions
stand in for the CUDA kernels (JAX: Pallas in interpret mode). Tolerance
2e-5, the kernels' own. The paged engine is held against the port's own
sequential dense decode, as tests/test_serving.py holds JAX's: the JAX
engines race on host arrays they update in place, so no JAX engine run is
an oracle here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.serving import paged_cache as JPC
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.lifecycle import Status
from repro_torch.serving.scheduler import PagedServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- pool helpers

def _pool_case(seed=0):
    rng = np.random.RandomState(seed)
    pool = rng.randn(10 * 8, 2, 4).astype(np.float32)
    table = np.array([[3, 7, 1, 9], [0, 0, 0, 0], [8, 2, 6, 4]], np.int32)
    return rng, pool, table


def test_pool_reads_and_token_writes_match_jax():
    rng, pool, table = _pool_case()
    np.testing.assert_array_equal(
        PC.logical_rows(torch.from_numpy(table), 8).numpy(),
        np.asarray(JPC.logical_rows(jnp.asarray(table), 8)))
    np.testing.assert_array_equal(
        PC.gather_logical(torch.from_numpy(pool), torch.from_numpy(table),
                          8).numpy(),
        np.asarray(JPC.gather_logical(jnp.asarray(pool), jnp.asarray(table),
                                      8)))
    pos = np.array([17, 0, 31], np.int32)
    np.testing.assert_array_equal(
        PC.token_rows(torch.from_numpy(table), torch.from_numpy(pos),
                      8).numpy(),
        np.asarray(JPC.token_rows(jnp.asarray(table), jnp.asarray(pos), 8)))
    new = rng.randn(3, 2, 4).astype(np.float32)
    got = PC.write_token_rows(torch.from_numpy(pool.copy()),
                              torch.from_numpy(new), torch.from_numpy(table),
                              torch.from_numpy(pos), 8).numpy()
    want = np.asarray(JPC.write_token_rows(jnp.asarray(pool),
                                           jnp.asarray(new),
                                           jnp.asarray(table),
                                           jnp.asarray(pos), 8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pos_start,n_valid", [(0, 6), (5, 6), (26, 3)])
def test_chunk_writes_match_jax(pos_start, n_valid):
    """A padded chunk: real rows land through the table, pad rows in the
    trash page (page 0, whose content is left out: both write several pad
    rows to one row, in no defined order)."""
    rng, pool, table = _pool_case(1)
    new = rng.randn(6, 2, 4).astype(np.float32)
    got = PC.write_chunk_rows(torch.from_numpy(pool.copy()),
                              torch.from_numpy(new),
                              torch.from_numpy(table[0]), pos_start, 8,
                              n_valid=n_valid).numpy()
    want = np.asarray(JPC.write_chunk_rows(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(table[0]),
        jnp.int32(pos_start), 8, n_valid=jnp.int32(n_valid)))
    np.testing.assert_array_equal(got[8:], want[8:])


def test_page_pool_sequences_match_jax():
    """The same alloc / acquire / release script gives the same pages,
    free lists and refcounts; the guards raise alike."""
    mine, ref = PC.PagePool(8, 16), JPC.PagePool(8, 16)
    script = [("alloc", 3), ("alloc", 2), ("acquire", [2]), ("release", [1]),
              ("release", [2]), ("alloc", 4), ("release", [2, 3]),
              ("alloc", 2), ("alloc", 0), ("release", [4, 5, 6])]
    for op, arg in script:
        a, b = getattr(mine, op)(arg), getattr(ref, op)(arg)
        assert a == b, (op, arg, a, b)
        assert mine.free_page_ids() == ref.free_page_ids()
        assert mine.holders() == ref.holders()
        assert (mine.free_pages, mine.available_pages, mine.used_pages) == \
            (ref.free_pages, ref.available_pages, ref.used_pages)
    for pool in (mine, ref):
        with pytest.raises(ValueError, match="double-free"):
            pool.release([4])
        with pytest.raises(ValueError, match="trash"):
            pool.release([0])
        with pytest.raises(ValueError, match="unheld"):
            pool.acquire([4])
        assert pool.alloc(99) is None
    assert PC.PagePool.pages_for(33, 16) == JPC.PagePool.pages_for(33, 16)


# ----------------------------------------------- model: chunked prefill

PS, CHUNK, MAX_PAGES = 16, 16, 6
TABLES = np.array([[5, 2, 9, 1, 7, 3], [8, 11, 4, 10, 6, 12],
                   [0, 0, 0, 0, 0, 0]], np.int32)      # row 2: idle slot
PROMPTS = (37, 50)


def _cfgs(arch, policy, backend):
    kw = dict(k_f=0.25, d_f=0.25, block_size=8, local_window=4, min_k=4)
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    if policy != "full":
        jcfg, cfg = jcfg.with_policy(policy, **kw), cfg.with_policy(policy,
                                                                    **kw)
    else:
        jcfg = jcfg.replace(loki=dataclasses.replace(jcfg.loki,
                                                     block_size=8))
        cfg = cfg.replace(loki=dataclasses.replace(cfg.loki, block_size=8))
    return (jcfg.replace(loki=dataclasses.replace(jcfg.loki,
                                                  backend=backend)),
            cfg.replace(loki=dataclasses.replace(cfg.loki,
                                                 backend=backend)))


def _params(jcfg, cfg):
    params = jlm.init(jax.random.PRNGKey(0), jcfg)
    # an orthogonal PCA basis per (layer, kv-head): the Loki policies store
    # rotated keys, so the basis must be more than the identity
    rng = np.random.RandomState(4)
    hd = cfg.resolved_head_dim
    pca = np.stack([[np.linalg.qr(rng.randn(hd, hd))[0]
                     for _ in range(cfg.n_kv_heads)]
                    for _ in range(cfg.n_layers)]).astype(np.float32)
    params["layers"]["attn"]["pca"] = jnp.asarray(pca)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    return params, tparams


MODEL_CASES = [("llama2-7b", p, "pallas")
               for p in ("full", "exact_topk", "loki", "loki_block")] + [
    ("qwen2.5-3b", p, "pallas") for p in ("full", "exact_topk",
                                          "loki_block")] + [
    ("llama2-7b", p, "xla") for p in ("full", "exact_topk")]


@pytest.mark.parametrize("arch,policy,backend", MODEL_CASES)
def test_prefill_chunk_and_paged_decode_match_jax(arch, policy, backend):
    """Two prompts prefilled chunk by chunk into shuffled pages, then four
    batched decode steps over their tables plus an idle slot whose all-zero
    row sends it to the trash page; logits of both live rows vs JAX."""
    jcfg, cfg = _cfgs(arch, policy, backend)
    params, tparams = _params(jcfg, cfg)
    n_pages = int(TABLES.max()) + 1
    jcache = jlm.init_paged_cache(jcfg, n_pages, PS, jnp.float32)
    tcache = lm.init_paged_cache(cfg, n_pages, PS, device="cpu")
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32)
               for n in PROMPTS]
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt) - 1, CHUNK):
            nv = min(CHUNK, len(prompt) - 1 - start)
            chunk = np.zeros((1, CHUNK), np.int32)
            chunk[0, :nv] = prompt[start:start + nv]
            jl, jcache = jlm.prefill_chunk(
                params, jcfg, jcache, jnp.asarray(chunk), jnp.int32(start),
                jnp.int32(nv), jnp.asarray(TABLES[slot:slot + 1]), PS)
            tl, tcache = lm.prefill_chunk(
                tparams, cfg, tcache, torch.from_numpy(chunk), start, nv,
                torch.from_numpy(TABLES[slot:slot + 1]), PS)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.array([p[-1] for p in prompts] + [0], np.int32)
    pos = np.array([len(p) - 1 for p in prompts] + [0], np.int32)
    for _ in range(4):
        jl, jcache = jlm.decode_step(params, jcfg, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos),
                                     page_table=jnp.asarray(TABLES),
                                     page_size=PS)
        tl, tcache = lm.decode_step(tparams, cfg, tcache,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(pos),
                                    page_table=torch.from_numpy(TABLES),
                                    page_size=PS)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tok[2] = 0
        pos = pos + np.array([1, 1, 0], np.int32)
    # the live pages hold the same rows (page 0, the trash page, aside)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache["layers"]["attn"][name].numpy()[:, PS:],
            np.asarray(jcache["layers"]["attn"][name])[:, PS:], **TOL)


def test_paged_entry_points_refuse_what_is_not_ported():
    cfg = get_smoke_config("llama2-7b")
    with pytest.raises(NotImplementedError, match="item 8"):
        lm.init_paged_cache(cfg.replace(sliding_window=64), 4, 8,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        lm.init_paged_cache(cfg, 4, 8, device_pages=2, device="cpu")
    params = lm.init(cfg, device="cpu")
    cache = lm.init_paged_cache(cfg, 4, 8, device="cpu")
    tok, pos = torch.zeros(1, dtype=torch.int32), torch.zeros(
        1, dtype=torch.int32)
    table = torch.zeros((1, 3), dtype=torch.int32)
    for kw in (dict(live=torch.ones(1, dtype=torch.bool)),
               dict(slot_idx=tok), dict(frame_table=table)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lm.decode_step(params, cfg, cache, tok, pos, page_table=table,
                           page_size=8, **kw)
    with pytest.raises(NotImplementedError, match="groups"):
        lm.decode_step(params, cfg, cache, tok, pos,
                       page_table=table[:, None], page_size=8)


# ------------------------------------------ engine vs sequential dense

def _engine_model(policy="full", backend="pallas"):
    cfg = get_smoke_config("qwen2.5-3b")
    if policy != "full":
        cfg = cfg.with_policy(policy, k_f=0.5, d_f=0.5, block_size=8,
                              local_window=4, min_k=4)
    cfg = cfg.replace(loki=dataclasses.replace(cfg.loki, backend=backend))
    return lm.init(cfg, seed=0, device="cpu"), cfg


def _sequential_dense(params, cfg, prompts, max_new, smax,
                      admission="strict"):
    """Ground truth: each prompt served alone by the port's dense engine."""
    outs = []
    for p in prompts:
        eng = ServingEngine(params, cfg, n_slots=1, smax=smax,
                            admission=admission, device="cpu")
        r = Request(rid=0, prompt=p.copy(), max_new=max_new)
        eng.submit(r)
        eng.run_until_done(500)
        outs.append(r.out)
    return outs


def _serve(eng, prompts, max_new, max_ticks=1000):
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_ticks)
    return reqs


@pytest.mark.parametrize("policy", ["full", "exact_topk", "loki_block"])
def test_paged_matches_sequential_dense_at_2x_concurrency(policy):
    """Twice as many requests as slots; greedy outputs identical to
    serving each prompt alone through the dense engine."""
    params, cfg = _engine_model(policy)
    prompts = [(np.arange(5 + 3 * i) * 7 + i) % cfg.vocab for i in range(4)]
    truth = _sequential_dense(params, cfg, prompts, max_new=5, smax=64)
    eng = PagedServingEngine(params, cfg, n_slots=2, smax=64, page_size=16,
                             prefill_chunk=4, device="cpu")
    reqs = _serve(eng, prompts, 5)
    for r, t in zip(reqs, truth):
        assert r.done and r.out == t, (r.rid, r.out, t)
    st = eng.stats()
    # one device->host copy per decode step, no other
    assert st["n_host_syncs"] == st["n_decode_steps"] > 0
    assert eng.pool.free_pages == eng.pool.n_pages - 1
    assert not eng.page_table.any()


def test_paged_more_queued_requests_than_pages():
    """8 requests over a pool that fits about 2 drain by page reuse."""
    params, cfg = _engine_model()
    prompts = [(np.arange(6 + i) * 5 + i) % cfg.vocab for i in range(8)]
    truth = _sequential_dense(params, cfg, prompts, max_new=4, smax=32)
    eng = PagedServingEngine(params, cfg, n_slots=2, smax=32, page_size=8,
                             prefill_chunk=4, n_pages=6, device="cpu")
    total = sum(PC.PagePool.pages_for(len(p) + 4, 8) for p in prompts)
    assert total > eng.pool.n_pages - 1
    for r, t in zip(_serve(eng, prompts, 4), truth):
        assert r.done and r.out == t, (r.rid, r.out, t)


def test_paged_preemption_reproduces_greedy_outputs():
    """Memory pressure forces recompute preemption mid-generation; the
    re-admitted requests reproduce the identical continuation (full
    attention: the recomputed prefix is the one decode saw)."""
    params, cfg = _engine_model()
    prompts = [(np.arange(9 + i) * 5 + i) % cfg.vocab for i in range(4)]
    truth = _sequential_dense(params, cfg, prompts, max_new=14, smax=32)
    eng = PagedServingEngine(params, cfg, n_slots=2, smax=32, page_size=8,
                             prefill_chunk=4, n_pages=6, device="cpu")
    reqs = _serve(eng, prompts, 14)
    assert eng.n_preempted > 0
    assert sum(r.n_preempts for r in reqs) == eng.n_preempted
    for r, t in zip(reqs, truth):
        assert r.done and r.out == t, (r.rid, r.out, t)
    assert eng.stats()["lifecycle"] == {"done": 4}


def test_engine_refuses_unported_features_and_small_pools():
    params, cfg = _engine_model()
    for kw in (dict(prefix_cache=True), dict(packed=True),
               dict(device_pages=4), dict(shed_after=2), dict(audit=True)):
        with pytest.raises(NotImplementedError, match="item 7"):
            PagedServingEngine(params, cfg, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="priority"):
        PagedServingEngine(params, cfg, policy="priority", device="cpu")
    with pytest.raises(ValueError, match="cannot hold one full request"):
        PagedServingEngine(params, cfg, smax=64, page_size=8, n_pages=4,
                           device="cpu")
    with pytest.raises(ValueError, match="dense engine"):
        PagedServingEngine(params, cfg.with_policy("h2o"), device="cpu")


def test_engine_cancel_and_strict_admission():
    params, cfg = _engine_model()
    eng = PagedServingEngine(params, cfg, n_slots=1, smax=32, page_size=8,
                             prefill_chunk=4, device="cpu")
    big = Request(rid=0, prompt=np.arange(30, dtype=np.int32), max_new=8)
    eng.submit(big)
    assert big.status is Status.FAILED and "oversized" in big.detail
    running = Request(rid=1, prompt=np.arange(1, 7, dtype=np.int32),
                      max_new=10)
    queued = Request(rid=2, prompt=np.arange(2, 9, dtype=np.int32),
                     max_new=10)
    eng.submit(running)
    eng.submit(queued)
    for _ in range(3):
        eng.tick()
    assert running.status is Status.DECODE and running.out
    assert eng.cancel(2) and queued.status is Status.CANCELLED
    assert eng.cancel(1) and running.status is Status.CANCELLED
    assert not eng.cancel(1)
    assert eng.pool.free_pages == eng.pool.n_pages - 1


def test_serve_runs_the_paged_engine_on_cpu():
    reqs = serve.main(["--engine", "paged", "--arch", "llama2-7b",
                       "--policy", "exact_topk", "--requests", "3",
                       "--max-new", "3", "--smax", "128", "--page-size",
                       "16", "--n-pages", "9", "--prefill-chunk", "16",
                       "--device", "cpu"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
