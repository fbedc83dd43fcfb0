"""The port's paged engine at the reference's defaults, on CPU: prefix
caching with copy-on-write tails, gather-packed decode, priority classes
and load shedding.

The pool's prefix index follows ``repro.serving.paged_cache.PagePool`` on
one script; ``lm.copy_cache_page`` and the packed ``lm.decode_step``
(``slot_idx``) meet ``repro.models.lm`` on the same numpy pools and
weights (tolerance rtol = atol = 2e-5, the kernels' own; the copy bit for
bit). The engine is held against the port's own sequential dense decode,
greedy token for token, as the reference's scheduler tests hold JAX's:
the JAX engines race on host arrays they update in place, so no JAX
engine is an oracle here. Every case that preempts runs under ``full``:
recompute preemption gives the greedy continuation back only there.
qwen2.5-3b smoke (G = 4), smax 64, page 8, chunk 8.
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
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.lifecycle import Status, is_terminal
from repro_torch.serving.scheduler import PAGED_POLICIES, PagedServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)
ARCH, SMAX, PS, CHUNK = "qwen2.5-3b", 64, 8, 8
POLICY_KW = dict(k_f=0.5, d_f=0.5, block_size=8, local_window=4, min_k=4)


def _policy(cfg, policy):
    if policy == "full":
        return cfg.replace(loki=dataclasses.replace(cfg.loki, block_size=8))
    return cfg.with_policy(policy, **POLICY_KW)


_MODELS = {}


def _model(policy="full"):
    """The port's smoke model (random weights, seed 0) at a policy, the
    kernels' plain versions standing in (backend pallas on CPU)."""
    if policy not in _MODELS:
        cfg = _policy(get_smoke_config(ARCH), policy)
        cfg = cfg.replace(loki=dataclasses.replace(cfg.loki,
                                                   backend="pallas"))
        _MODELS[policy] = (lm.init(cfg, seed=0, device="cpu"), cfg)
    return _MODELS[policy]


def _solo(params, cfg, prompt, max_new):
    """Greedy truth: one prompt served alone by the port's dense engine."""
    eng = ServingEngine(params, cfg, n_slots=1, smax=SMAX, device="cpu")
    r = Request(rid=0, prompt=prompt.copy(), max_new=max_new)
    eng.submit(r)
    eng.run_until_done(500)
    return r.out


def _engine(params, cfg, **kw):
    kw = dict(dict(n_slots=2, smax=SMAX, page_size=PS, prefill_chunk=CHUNK,
                   device="cpu"), **kw)
    return PagedServingEngine(params, cfg, **kw)


def _serve(eng, prompts, max_new, **req_kw):
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new, **req_kw)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(2000)
    return reqs


def _at_baseline(eng):
    """Every reference returned: no page held, free + cached = usable."""
    return (eng.pool.used_pages == 0 and not eng.page_table.any()
            and eng.pool.free_pages + eng.pool.cached_pages
            == eng.pool.n_pages - 1)


# ------------------------------------------------- the pool's prefix index

def test_page_pool_prefix_script_matches_jax():
    """alloc / register / match_prefix (full chain, partial tail, miss) /
    release to the LRU / deregister / an evicting alloc, on both pools:
    the same returns, free lists, holders, LRU and counters; page_key's
    bytes equal."""
    toks = np.arange(12, dtype=np.int32)
    div = np.concatenate([toks[:10], [99, 98]]).astype(np.int32)
    assert PC.page_key(PC.ROOT_KEY, toks[:4]) == JPC.page_key(
        JPC.ROOT_KEY, toks[:4])
    mine, ref = PC.PagePool(8, 4), JPC.PagePool(8, 4)
    keys = {}

    def step(fn):
        a, b = fn(mine, keys.get("m")), fn(ref, keys.get("r"))
        assert a == b, (a, b)
        assert mine.free_page_ids() == ref.free_page_ids()
        assert mine.holders() == ref.holders()
        assert mine.lru_page_ids() == ref.lru_page_ids()
        assert (mine.free_pages, mine.cached_pages, mine.available_pages,
                mine.used_pages) == (ref.free_pages, ref.cached_pages,
                                     ref.available_pages, ref.used_pages)
        assert (mine.n_lookups, mine.n_hits, mine.n_hit_tokens,
                mine.n_evicted) == (ref.n_lookups, ref.n_hits,
                                    ref.n_hit_tokens, ref.n_evicted)
        return a

    step(lambda p, _: p.alloc(3))
    for side, p in (("m", mine), ("r", ref)):
        k = PC.ROOT_KEY
        for i, page in enumerate((1, 2, 3)):
            k = p.register(page, k, toks[4 * i:4 * i + 4])
        keys[side] = k
    assert keys["m"] == keys["r"]
    assert [mine.is_registered(i) for i in range(5)] == \
        [ref.is_registered(i) for i in range(5)]
    step(lambda p, _: p.release([1, 2, 3]))                 # -> the LRU
    step(lambda p, _: p.match_prefix(toks, 12))             # full chain
    step(lambda p, _: p.release([1, 2, 3]))
    step(lambda p, _: p.match_prefix(div, 11))              # partial tail
    step(lambda p, _: p.match_prefix(div + 1, 11))          # miss
    step(lambda p, _: p.deregister(3))                      # sole reader
    step(lambda p, _: p.release([1, 2, 3]))                 # 3 -> free
    step(lambda p, _: p.alloc(6))                           # evicts 1
    step(lambda p, _: p.match_prefix(toks, 12))             # chain broken
    assert not mine.is_private(2) and not ref.is_private(2)
    for pool in (mine, ref):
        with pytest.raises(ValueError, match="full page"):
            pool.register(4, PC.ROOT_KEY, toks[:3])


# ----------------------------------------------------- model entry points

@pytest.mark.parametrize("layout", ["", "int8:pca:r=16"])
def test_copy_cache_page_matches_jax_bit_for_bit(layout):
    """One page copied in every layer's K and V pool (and its scales at a
    quantized layout), from the same random pools: equal bit for bit, and
    only the target page changed."""
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    if layout:
        jcfg, cfg = jcfg.with_layout(layout), cfg.with_layout(layout)
    n_pages = 6
    jcache = jlm.init_paged_cache(jcfg, n_pages, PS, jnp.float32)
    tcache = lm.init_paged_cache(cfg, n_pages, PS, device="cpu")
    rng = np.random.RandomState(5)
    for name, t in tcache["layers"]["attn"].items():
        if t.dtype == torch.int8:
            a = rng.randint(-127, 128, size=t.shape).astype(np.int8)
        else:
            a = rng.rand(*t.shape).astype(np.float32)
        t.copy_(torch.from_numpy(a))
        jcache["layers"]["attn"][name] = jnp.asarray(a)
    before = {n: t.clone() for n, t in tcache["layers"]["attn"].items()}
    jout = jlm.copy_cache_page(jcfg, jcache, 4, 2, PS)
    tout = lm.copy_cache_page(cfg, tcache, 4, 2, PS)
    assert tout is tcache                              # in place
    for name, t in tout["layers"]["attn"].items():
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(jout["layers"]["attn"][name]))
        if name.endswith("scale"):
            assert torch.equal(t[:, 2], before[name][:, 4])
            changed = torch.ones(n_pages, dtype=torch.bool)
            changed[2] = False
            assert torch.equal(t[:, changed], before[name][:, changed])
        else:
            rows = slice(2 * PS, 3 * PS)
            assert torch.equal(t[:, rows], before[name][:, 4 * PS:5 * PS])
            assert torch.equal(t[:, :2 * PS], before[name][:, :2 * PS])
            assert torch.equal(t[:, 3 * PS:], before[name][:, 3 * PS:])


@pytest.mark.parametrize("policy", ["full", "loki_block"])
def test_packed_decode_step_matches_masked_and_jax(policy):
    """Two of four slots packed (slot ids 2, 0) against the full-width
    masked step over the same pools: the packed rows' logits equal the
    slots' rows; and against JAX's ``decode_step(slot_idx=...)``."""
    jcfg = _policy(jget_smoke(ARCH), policy)
    jcfg = jcfg.replace(loki=dataclasses.replace(jcfg.loki,
                                                 backend="pallas"))
    cfg = _model(policy)[1]
    params = jlm.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    rng = np.random.RandomState(7)
    n_pages, mp = 17, SMAX // PS
    jcache = jlm.init_paged_cache(jcfg, n_pages, PS, jnp.float32)
    pools = {n: rng.randn(*a.shape).astype(np.float32)
             for n, a in jcache["layers"]["attn"].items()}
    jcache = {"layers": {"attn": {n: jnp.asarray(a)
                                  for n, a in pools.items()}}}
    table = np.zeros((4, mp), np.int32)
    table[0, :4] = [3, 9, 1, 12]
    table[2, :3] = [7, 2, 15]
    tok = np.array([11, 0, 37, 0], np.int32)
    pos = np.array([29, 0, 21, 0], np.int32)
    sel = np.array([1, 0, 1, 0], bool)
    sidx = np.array([2, 0], np.int32)

    def fresh():
        return {"layers": {"attn": {n: torch.from_numpy(a.copy())
                                    for n, a in pools.items()}}}
    masked, _ = lm.decode_step(
        tparams, cfg, fresh(), torch.from_numpy(tok), torch.from_numpy(pos),
        page_table=torch.from_numpy(table * sel[:, None]), page_size=PS)
    packed, tcache = lm.decode_step(
        tparams, cfg, fresh(), torch.from_numpy(tok[sidx]),
        torch.from_numpy(pos[sidx]), page_table=torch.from_numpy(
            table[sidx]), page_size=PS, slot_idx=torch.from_numpy(sidx))
    np.testing.assert_allclose(packed.numpy(), masked.numpy()[sidx],
                               rtol=1e-6, atol=1e-6)
    jl, jout = jlm.decode_step(params, jcfg, jcache, jnp.asarray(tok[sidx]),
                               jnp.asarray(pos[sidx]),
                               page_table=jnp.asarray(table[sidx]),
                               page_size=PS, slot_idx=jnp.asarray(sidx))
    np.testing.assert_allclose(packed.numpy(), np.asarray(jl), **TOL)
    for name, t in tcache["layers"]["attn"].items():
        np.testing.assert_allclose(
            t.numpy()[:, PS:], np.asarray(jout["layers"]["attn"][name])[
                :, PS:], **TOL)
    with pytest.raises(ValueError, match="distinct"):
        lm.decode_step(tparams, cfg, fresh(), torch.from_numpy(tok[sidx]),
                       torch.from_numpy(pos[sidx]),
                       page_table=torch.from_numpy(table[sidx]),
                       page_size=PS, slot_idx=torch.tensor([2, 2]))


# ------------------------------------------------------ prefix caching

@pytest.mark.parametrize("policy", ["full", "loki_block"])
def test_prefix_cache_matches_sequential_dense(policy):
    """Four prompts behind one 24-token system prompt, two slots: the
    later ones hit the cached pages, and every output is the greedy
    continuation of the prompt served alone."""
    params, cfg = _model(policy)
    base = (np.arange(24) * 11 + 3) % cfg.vocab
    prompts = [np.concatenate([base, (np.arange(5 + i) * 7 + 2 + i)
                               % cfg.vocab]) for i in range(4)]
    truth = [_solo(params, cfg, p, 6) for p in prompts]
    eng = _engine(params, cfg)
    assert eng.prefix_caching and eng.packed
    reqs = _serve(eng, prompts, 6)
    assert [r.out for r in reqs] == truth
    st = eng.stats()
    assert st["n_prefix_hit_tokens"] >= 2 * 24
    assert 0.0 < st["prefix_hit_rate"] < 1.0
    assert st["n_host_syncs"] == st["n_decode_steps"] > 0
    assert _at_baseline(eng) and eng.pool.cached_pages > 0


def _registered_rows(eng):
    """The rows (and scales) of every registered page, copied."""
    attn = eng.cache["layers"]["attn"]
    out = {}
    for page in eng.pool._by_page:
        rows = slice(page * PS, (page + 1) * PS)
        out[page] = {n: (t[:, page] if n.endswith("scale") else t[:, rows])
                     .clone() for n, t in attn.items()}
    return out


@pytest.mark.parametrize("layout,donor_live", [
    ("", True), ("", False), ("int8:pca:r=16", True)])
def test_copy_on_write_tail(layout, donor_live):
    """B's prompt matches A's first 20 tokens: pages 0-1 whole, page 2 in
    its first 4 rows (the partial tail). With A still decoding, B copies
    the tail before its first write (one copy); with A done, B is the
    tail's only reader and takes it over (no copy). Registered pages keep
    their rows and scales bit for bit through B's writes (the quantized
    read-modify-write never touches one); outputs are the greedy truth
    (fp32) and A's later rerun still hits A's 32 prompt tokens."""
    params, cfg = _model("full")
    if layout:
        cfg = cfg.with_layout(layout)
    a = (np.arange(33) * 11 + 3) % cfg.vocab            # n_pre 32: 4 pages
    b = np.concatenate([a[:20], (np.arange(12) * 13 + 7) % cfg.vocab])
    eng = _engine(params, cfg, n_slots=2 if donor_live else 1)
    ra = Request(rid=0, prompt=a.copy(), max_new=16 if donor_live else 4)
    eng.submit(ra)
    while not eng.live.any():                           # a prefilled and
        eng.tick()                                      # registered
    tail = eng.slot_pages[0][2]
    if not donor_live:
        eng.run_until_done(300)
    donors = _registered_rows(eng)
    assert len(donors) == 4 and tail in donors
    rb = Request(rid=1, prompt=b.copy(), max_new=4)
    eng.submit(rb)
    eng.run_until_done(400)
    assert ra.done and rb.done
    assert eng.n_cow_copies == (1 if donor_live else 0)
    assert eng.n_prefix_hit_tokens == 20
    after = _registered_rows(eng)
    # the tail's sole reader took it over and wrote into it; every other
    # donor page is still indexed, its rows and scales untouched
    kept = set(donors) - ({tail} if not donor_live else set())
    assert kept <= set(after)
    for page in kept:
        for name, t in after[page].items():
            assert torch.equal(t, donors[page][name]), (page, name)
    if not layout:
        assert ra.out == _solo(params, cfg, a, len(ra.out))
        assert rb.out == _solo(params, cfg, b, 4)
        if donor_live:
            rerun = Request(rid=2, prompt=a.copy(), max_new=16)
            eng.submit(rerun)
            eng.run_until_done(400)
            assert rerun.out == ra.out
            assert eng.n_prefix_hit_tokens == 20 + 32
    assert _at_baseline(eng)


def test_eviction_comes_before_preemption():
    """Cached pages of a finished request are reclaimed, least recently
    released first, before any running request is preempted."""
    params, cfg = _model("full")
    eng = _engine(params, cfg, smax=32, n_pages=9)      # 8 usable pages
    warm = Request(rid=0, prompt=(np.arange(17) * 11 + 3) % cfg.vocab,
                   max_new=2)
    eng.submit(warm)
    eng.run_until_done(200)
    assert eng.pool.cached_pages == 2
    prompts = [(np.arange(20) * 7 + 5 + i) % cfg.vocab for i in range(2)]
    reqs = _serve(eng, prompts, 12)
    assert eng.pool.n_evicted >= 1 and eng.n_preempted == 0
    assert [r.out for r in reqs] == [_solo(params, cfg, p, 12)
                                     for p in prompts]


def test_preemption_with_shared_pages_matches_sequential_dense():
    """A tight pool and shared prefixes: preemption only drops references
    (shared pages are never freed under another reader), and every output
    is the greedy truth."""
    params, cfg = _model("full")
    base = (np.arange(16) * 5 + 1) % cfg.vocab
    prompts = [np.concatenate([base, (np.arange(3 + i) * 7 + i) % cfg.vocab])
               for i in range(4)]
    eng = _engine(params, cfg, smax=32, n_pages=6)
    reqs = _serve(eng, prompts, 10)
    assert eng.n_preempted > 0 and eng.n_prefix_hit_tokens > 0
    assert [r.out for r in reqs] == [_solo(params, cfg, p, 10)
                                     for p in prompts]
    assert _at_baseline(eng)


# ------------------------------------------------------- packed decode

@pytest.mark.parametrize("policy", PAGED_POLICIES)
def test_packed_matches_masked_greedy(policy):
    """Three requests on six slots (50% occupancy at most): the packed
    engine gives the masked engine's greedy tokens, through packed ticks
    (buckets of 4, 2 and 1 rows)."""
    params, cfg = _model(policy)
    prompts = [(np.arange(5 + i) * 3 + i) % cfg.vocab for i in range(3)]
    outs = {}
    for packed in (False, True):
        eng = _engine(params, cfg, n_slots=6, packed=packed)
        outs[packed] = [r.out for r in _serve(eng, prompts, 6)]
        st = eng.stats()
        assert st["n_host_syncs"] == st["n_decode_steps"]
    assert outs[True] == outs[False]
    pk = st["packed"]
    assert pk["enabled"] and pk["n_packed_ticks"] == st["n_decode_steps"]
    assert pk["n_masked_ticks"] == 0 and pk["n_rows_saved"] > 0
    assert pk["n_sealed_fallbacks"] == 0


# ------------------------------------------------ priority and shedding

def test_priority_admission_order_single_slot():
    """Both waiting before the first tick: priority admits the urgent one
    first though it came second; FIFO keeps arrival order. Outputs stay
    the greedy truth either way."""
    params, cfg = _model("full")
    p_lo = (np.arange(6) * 7 + 2) % cfg.vocab
    p_hi = (np.arange(9) * 5 + 3) % cfg.vocab
    truth = (_solo(params, cfg, p_lo, 4), _solo(params, cfg, p_hi, 4))
    done_order = {}
    for pol in ("fifo", "priority"):
        eng = _engine(params, cfg, n_slots=1, policy=pol)
        lo = Request(rid=0, prompt=p_lo.copy(), max_new=4, priority=0)
        hi = Request(rid=1, prompt=p_hi.copy(), max_new=4, priority=1)
        eng.submit(lo)
        eng.submit(hi)
        eng.run_until_done(400)
        assert (lo.out, hi.out) == truth, pol
        done_order[pol] = lo.t_done < hi.t_done
        assert eng.n_preempted == 0
    assert done_order == {"fifo": True, "priority": False}


def test_priority_preempts_a_lower_class_and_fifo_never_does():
    """A strictly more urgent arrival takes the only slot mid-decode under
    priority; the preempted request is folded, requeued and finishes with
    its greedy truth. Under FIFO the same arrival waits."""
    params, cfg = _model("full")
    p_lo = (np.arange(7) * 7 + 2) % cfg.vocab
    p_hi = (np.arange(5) * 5 + 3) % cfg.vocab
    truth = (_solo(params, cfg, p_lo, 10), _solo(params, cfg, p_hi, 4))
    for pol in ("priority", "fifo"):
        eng = _engine(params, cfg, n_slots=1, policy=pol)
        lo = Request(rid=0, prompt=p_lo.copy(), max_new=10, priority=0)
        eng.submit(lo)
        for _ in range(5):
            eng.tick()
        assert lo.out and not lo.done
        hi = Request(rid=1, prompt=p_hi.copy(), max_new=4, priority=9)
        eng.submit(hi)
        eng.tick()
        if pol == "priority":
            assert eng.n_preempted == 1 and eng.slot_req[0] is hi
        else:
            assert eng.n_preempted == 0 and eng.slot_req[0] is lo
        eng.run_until_done(500)
        assert (lo.out, hi.out) == truth, pol
        assert (hi.t_done < lo.t_done) == (pol == "priority")


def test_shed_after_ends_a_churned_request_shed():
    """A pool too small for the stream churns preemptions; with
    shed_after=2 a request preempted twice ends SHED with a retry-after
    hint instead of requeueing, and the rest finish with their greedy
    truth."""
    params, cfg = _model("full")
    prompts = [(np.arange(9 + i) * 5 + i) % cfg.vocab for i in range(4)]
    eng = _engine(params, cfg, smax=32, n_pages=6, shed_after=2)
    reqs = _serve(eng, prompts, 14)
    shed = [r for r in reqs if r.status is Status.SHED]
    assert shed and all(is_terminal(r) for r in reqs)
    for r in shed:
        assert r.retry_after > 0 and "pool pressure" in r.detail
        assert r.n_preempts == 2
    assert eng.n_shed == len(shed) == eng.stats()["lifecycle"]["shed"]
    done = [(r, p) for r, p in zip(reqs, prompts) if r.done]
    assert done
    for r, p in done:
        assert r.out == _solo(params, cfg, p, 14)
    assert _at_baseline(eng)
