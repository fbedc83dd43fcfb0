"""The port's tiered KV pool, fault plan and invariant auditor, on CPU.

The pool's tier state machine and ``FetchQueue`` follow
``repro.serving.paged_cache`` on one script (returns, raises, states,
frames); ``FaultPlan`` follows ``repro.serving.faults`` hit for hit;
``lm.decode_step(frame_table=)``, ``copy_cache_page`` and
``promote_page_rows`` on a tiered pool meet ``repro.models.lm`` (jitted,
Pallas in interpret mode) on the same numpy pools and weights, logits at
fp32 rtol = atol = 2e-5 (the kernels' own), winners, copies and pools
bit for bit or at the same tolerance. The engines are held against the
port's own single-tier engine, token for token, as the reference's tier
and fault tests hold JAX's: the JAX engines race on host arrays they
update in place, so no JAX engine is an oracle here. Cases that preempt
run under ``full``: recompute preemption gives the greedy continuation
back only there. llama2-7b smoke (G = 1), page 8, chunk 4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.serving import faults as JFI
from repro.serving import paged_cache as JPC
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import PageLayout
from repro_torch.core import dispatch
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import faults as FI
from repro_torch.serving import paged_cache as PC
from repro_torch.serving import scheduler as SCH
from repro_torch.serving.engine import Request
from repro_torch.serving.lifecycle import Status
from repro_torch.serving.scheduler import PagedServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)
ARCH, PS = "llama2-7b", 8
POLICY_KW = dict(k_f=0.5, d_f=0.5, block_size=8, local_window=4, min_k=4)


# ------------------------------------------------------------ pool script

def _outcome(fn):
    """A call's return, or its exception's type and message."""
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raise", str(e))


def _tier_state(pool):
    return (pool.free_page_ids(), pool.holders(), pool.lru_page_ids(),
            pool.free_frame_ids(), pool.frame_map(),
            pool.resident_page_ids(), pool.host_page_ids(),
            pool.inflight_page_ids(), pool.pinned_page_ids(),
            pool.n_demoted, pool.n_promoted, pool.free_frames,
            pool.available_pages, pool.tiered)


def test_pool_tier_script_matches_jax():
    """alloc / demote / pin / promote_begin, complete and abort / release
    of a cached resident page / an alloc that evicts it for its frame,
    the in-flight budget, the fault seams (alloc_fail, pool_exhaustion,
    hbm_oom_on_promote) and every guard that raises, on both pools: the
    same returns, messages and tier states."""
    mine = PC.PagePool(10, 4, device_pages=5, max_inflight=2)
    ref = JPC.PagePool(10, 4, device_pages=5, max_inflight=2)
    plans = (FI.FaultPlan(at={"alloc_fail": {1}, "pool_exhaustion": {2},
                              "hbm_oom_on_promote": {(3, 2)}}),
             JFI.FaultPlan(at={"alloc_fail": {1}, "pool_exhaustion": {2},
                               "hbm_oom_on_promote": {(3, 2)}}))
    mine.set_faults(plans[0])
    ref.set_faults(plans[1])
    toks = np.arange(4, dtype=np.int32)

    def step(fn, tick=0):
        for plan in plans:
            plan.advance(tick)
        got, want = _outcome(lambda: fn(mine)), _outcome(lambda: fn(ref))
        assert got == want, (got, want)
        assert _tier_state(mine) == _tier_state(ref)

    step(lambda p: p.alloc(3))
    step(lambda p: p.alloc(2))                  # frames short: None
    step(lambda p: p.alloc(1), tick=1)          # alloc_fail
    step(lambda p: p.available_pages, tick=2)   # pool_exhaustion reads 0
    step(lambda p: p.demote(1))
    step(lambda p: p.demote(1))                 # double-demote
    step(lambda p: p.demote(0))                 # trash page
    step(lambda p: p.demote(7))                 # free page
    step(lambda p: p.tier_of(7))                # free page
    step(lambda p: p.pin(2))
    step(lambda p: p.demote(2))                 # pinned
    step(lambda p: p.unpin(2))
    step(lambda p: p.unpin(2))                  # unpinned
    step(lambda p: p.pin(1))                    # non-resident
    step(lambda p: p.promote_begin(1))
    step(lambda p: p.free([1]))                 # in flight
    step(lambda p: p.promote_complete(1))
    step(lambda p: p.promote_complete(1))       # nothing in flight
    step(lambda p: p.promote_begin(1))          # resident
    step(lambda p: p.demote(2))
    step(lambda p: p.promote_begin(2), tick=3)  # hbm_oom_on_promote
    step(lambda p: p.promote_begin(2, faultable=False), tick=3)
    step(lambda p: p.promote_abort(2))
    step(lambda p: p.promote_abort(2))          # nothing in flight
    step(lambda p: (p.demote(3), p.promote_begin(2), p.promote_begin(3)))
    step(lambda p: p.demote(1))
    step(lambda p: p.promote_begin(1))          # budget spent: None
    step(lambda p: (p.promote_complete(2), p.promote_complete(3)))
    step(lambda p: p.register(3, PC.ROOT_KEY if p is mine
                              else JPC.ROOT_KEY, toks))
    step(lambda p: p.release([3]))              # resident, cached
    step(lambda p: p.alloc(4))                  # evicts page 3's frame
    step(lambda p: p.release([1, 2]))
    step(lambda p: p.frame_of(1))
    flat, flat_ref = PC.PagePool(8, 4), JPC.PagePool(8, 4)
    page = flat.alloc(1)[0]
    flat_ref.alloc(1)
    for fn in (lambda p: p.demote(page), lambda p: p.promote_begin(page),
               lambda p: (p.tier_of(page), p.frame_of(page))):
        assert _outcome(lambda: fn(flat)) == _outcome(lambda: fn(flat_ref))


@pytest.mark.parametrize("timeout_at", [{(0, 2)}, set()])
def test_fetch_queue_matches_jax(timeout_at):
    """Requests past the budget complete the oldest first, a request with
    no frame returns False, drain lands the rest, and a dma_timeout aborts
    the fetch and copies again: the same copies (page, frame), counters
    and tier states as JAX's queue."""
    pools = (PC.PagePool(12, 4, device_pages=5, max_inflight=2),
             JPC.PagePool(12, 4, device_pages=5, max_inflight=2))
    logs, queues = ([], []), []
    for pool, log, pc, fi in zip(pools, logs, (PC, JPC), (FI, JFI)):
        for p in pool.alloc(4)[:3]:
            pool.demote(p)
        plan = fi.FaultPlan(at={"dma_timeout": set(timeout_at)})
        plan.advance(0)
        queues.append(pc.FetchQueue(pool, lambda pg, fr, log=log:
                                    log.append((pg, fr)), faults=plan))
    host = pools[0].host_page_ids()
    assert host == pools[1].host_page_ids()
    for p in host:                       # the third completes the first
        assert queues[0].request(p) == queues[1].request(p)
        assert queues[0].in_flight == queues[1].in_flight
        assert _tier_state(pools[0]) == _tier_state(pools[1])
    for q in queues:
        q.drain()
    assert logs[0] == logs[1]
    assert (queues[0].n_issued, queues[0].n_sync_fallback) == (
        queues[1].n_issued, queues[1].n_sync_fallback)
    assert _tier_state(pools[0]) == _tier_state(pools[1])
    assert queues[0].n_sync_fallback == len(timeout_at)


def test_fault_plan_matches_jax():
    """Hits and counts over a grid of seeds, sites, ticks and units (rates
    and point schedules), and parse / describe / the refusals: the same as
    JAX's plan."""
    rates = {s: 0.3 for s in FI.FaultPlan.SITES}
    at = {"nan_logits": {(5, 1)}, "kernel_fail": {7}}
    assert FI.FaultPlan.SITES == JFI.FaultPlan.SITES
    for seed in range(3):
        mine = FI.FaultPlan(seed=seed, rates=rates, at=at)
        ref = JFI.FaultPlan(seed=seed, rates=rates, at=at)
        for tick in range(12):
            mine.advance(tick)
            ref.advance(tick)
            for site in FI.FaultPlan.SITES:
                for unit in range(4):
                    for _ in range(2):          # counted once per key
                        assert mine.hit(site, unit) == ref.hit(site, unit)
        assert dict(mine.counts) == dict(ref.counts)
    spec = "seed=9,nan_logits=0.05,slot_corrupt@17,alloc_fail@3"
    assert FI.FaultPlan.parse(spec).describe() == \
        JFI.FaultPlan.parse(spec).describe()
    for bad in ("nan_logits", "bogus=0.5"):
        with pytest.raises(ValueError) as got:
            FI.FaultPlan.parse(bad)
        with pytest.raises(ValueError) as want:
            JFI.FaultPlan.parse(bad)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------- model entry points

def _cfgs(policy):
    jcfg = jget_smoke(ARCH).with_policy(policy, **POLICY_KW)
    cfg = get_smoke_config(ARCH).with_policy(policy, **POLICY_KW)
    return (jcfg.replace(loki=dataclasses.replace(jcfg.loki,
                                                  backend="pallas")),
            cfg.replace(loki=dataclasses.replace(cfg.loki,
                                                 backend="pallas")))


def _params(jcfg, cfg):
    params = jlm.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(4)
    hd = cfg.resolved_head_dim
    pca = np.stack([[np.linalg.qr(rng.randn(hd, hd))[0]
                     for _ in range(cfg.n_kv_heads)]
                    for _ in range(cfg.n_layers)]).astype(np.float32)
    params["layers"]["attn"]["pca"] = jnp.asarray(pca)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")


# three slots over 10 logical pages and 6 device frames: pages 3 and 9 are
# HOST (frame 0, the trash frame), the idle third row reads only trash
TABLES = np.array([[3, 7, 1, 9], [8, 2, 6, 4], [0, 0, 0, 0]], np.int32)
FRAMES = np.array([[0, 4, 2, 0], [5, 1, 3, 4], [0, 0, 0, 0]], np.int32)


def _tiered_caches(cfg, seed=0):
    """Random tiered pools, the same in both packages' layouts."""
    rng = np.random.RandomState(seed)
    t = lm.init_paged_cache(cfg, 10, PS, device_pages=6, device="cpu")
    for name, a in t["layers"]["attn"].items():
        a.copy_(torch.from_numpy(rng.randn(*a.shape).astype(np.float32)))
    j = {"layers": {"attn": {n: jnp.asarray(a.numpy())
                             for n, a in t["layers"]["attn"].items()}}}
    return t, j


@pytest.mark.parametrize("policy", ["loki", "loki_block"])
def test_tiered_decode_step_matches_jax(policy):
    """Two tiered decode steps over frame tables with HOST pages: logits,
    winners (exactly) and every pool (frames, sidecar) against JAX."""
    jcfg, cfg = _cfgs(policy)
    params, tparams = _params(jcfg, cfg)
    tcache, jcache = _tiered_caches(cfg)
    jstep = jax.jit(lambda p, c, t, pl, pt, ft: jlm.decode_step(
        p, jcfg, c, t, pl, page_table=pt, page_size=PS, frame_table=ft))
    tok = np.array([5, 9, 0], np.int32)
    pos = np.array([26, 29, 0], np.int32)
    for _ in range(2):
        jl, jwin, jcache = jstep(params, jcache, jnp.asarray(tok),
                                 jnp.asarray(pos), jnp.asarray(TABLES),
                                 jnp.asarray(FRAMES))
        tl, twin, tcache = lm.decode_step(
            tparams, cfg, tcache, torch.from_numpy(tok),
            torch.from_numpy(pos), page_table=torch.from_numpy(TABLES),
            page_size=PS, frame_table=torch.from_numpy(FRAMES))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **TOL)
        np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + np.array([1, 1, 0], np.int32)
    assert np.asarray(jwin)[0, [0, 3]].any(), "no HOST page attended"
    attn = tcache["layers"]["attn"]
    for name in ("k", "v"):                     # frame 0 (trash) aside
        np.testing.assert_allclose(
            attn[name].numpy()[:, PS:],
            np.asarray(jcache["layers"]["attn"][name])[:, PS:], **TOL)
    np.testing.assert_allclose(
        attn["k_lat"].numpy()[:, PS:],
        np.asarray(jcache["layers"]["attn"]["k_lat"])[:, PS:], **TOL)


def test_tiered_copy_and_promote_match_jax():
    """copy_cache_page between frames (the sidecar by page) and
    promote_page_rows into a frame: every pool equal to JAX's, bit for
    bit."""
    jcfg, cfg = _cfgs("loki_block")
    tcache, jcache = _tiered_caches(cfg, seed=1)
    lm.copy_cache_page(cfg, tcache, 7, 5, PS, src_frame=4, dst_frame=3)
    jcache = jlm.copy_cache_page(jcfg, jcache, 7, 5, PS, src_frame=4,
                                 dst_frame=3)
    rng = np.random.RandomState(2)
    attn = tcache["layers"]["attn"]
    rows = [rng.randn(attn[n].shape[0], PS, *attn[n].shape[2:]).astype(
        np.float32) for n in ("k", "v")]
    lm.promote_page_rows(cfg, tcache, torch.from_numpy(rows[0]),
                         torch.from_numpy(rows[1]), 2, PS)
    jcache = jlm.promote_page_rows(jcfg, jcache, jnp.asarray(rows[0]),
                                   jnp.asarray(rows[1]), 2, PS)
    for name, a in attn.items():
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(jcache["layers"]["attn"][name]))
    np.testing.assert_array_equal(attn["k"].numpy()[:, 2 * PS:3 * PS],
                                  rows[0])


# ------------------------------------------------------------ the engine

_MODELS = {}


def _model(policy="loki_block"):
    """The port's smoke model (random weights, seed 0), the kernels'
    plain versions standing in (backend pallas on the CPU)."""
    if policy not in _MODELS:
        cfg = get_smoke_config(ARCH)
        if policy == "full":
            cfg = cfg.replace(loki=dataclasses.replace(cfg.loki,
                                                       block_size=8))
        else:
            cfg = cfg.with_policy(policy, **POLICY_KW)
        cfg = cfg.replace(loki=dataclasses.replace(cfg.loki,
                                                   backend="pallas"))
        _MODELS[policy] = (lm.init(cfg, seed=0, device="cpu"), cfg)
    return _MODELS[policy]


def _stream(cfg, n=4, plen=18, max_new=10):
    rng = np.random.default_rng(11)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=plen)
                    .astype(np.int32), max_new=max_new) for i in range(n)]


def _run(policy="loki_block", reqs=None, **kw):
    params, cfg = _model(policy)
    kw = dict(dict(n_slots=2, smax=48, page_size=PS, prefill_chunk=4,
                   audit=True, device="cpu"), **kw)
    eng = PagedServingEngine(params, cfg, **kw)
    reqs = _stream(cfg) if reqs is None else reqs
    for r in reqs:
        eng.submit(r)
    eng.drain(2000)
    return reqs, eng


def _at_baseline(eng):
    return (eng.pool.used_pages == 0 and not eng.page_table.any()
            and eng.pool.free_pages + eng.pool.cached_pages
            == eng.pool.n_pages - 1)


@pytest.mark.parametrize("policy", ["loki", "loki_block"])
def test_tiered_engine_equals_single_tier(policy):
    """The minimum legal device tier (one request plus one frame, the most
    demotion traffic) gives the single-tier engine's tokens, token for
    token, with no preemption; the auditor runs every tick."""
    base, e0 = _run(policy)
    tiered, e1 = _run(policy, device_pages=e0.req_budget + 1)
    assert all(r.done for r in base + tiered)
    assert [r.out for r in tiered] == [r.out for r in base]
    st = e1.stats()
    assert st["tiered"]["n_demoted"] > 0 and st["tiered"]["n_promoted"] > 0
    assert st["n_preempted"] == 0 and not st["packed"]["enabled"]
    # one device->host copy per run, none for a demotion on the CPU
    assert st["n_host_syncs"] == st["tiered"]["n_decode_runs"]
    # cached prompt pages park in the LRU, some of them on the host
    assert _at_baseline(e1)
    assert set(e1._host_kv) == set(e1.pool.host_page_ids())


def test_context_larger_than_device_tier_completes():
    """Six requests on four slots, their pages well beyond the device
    tier: the run drains, token for token with the single tier."""
    _, cfg = _model("loki")

    def reqs():
        return _stream(cfg, n=6, plen=20, max_new=12)
    base, e0 = _run("loki", reqs(), n_slots=4, smax=64)
    dev = e0.req_budget + 1
    tiered, e1 = _run("loki", reqs(), n_slots=4, smax=64, device_pages=dev)
    assert e1.pool.n_pages > dev
    assert e1.stats()["tiered"]["n_demoted"] > 0
    assert [r.out for r in tiered] == [r.out for r in base]


def test_demotion_before_preemption():
    """Frame pressure at the minimum tier is met by demotion and deferral:
    the logical pool has room for every request, so nothing is
    preempted. Prompts of one to five pages, prefilled a page a chunk: a
    chunk that grows the slot and then defers (its older pages cannot all
    come back this tick) moves the tail pin with the growth, which the
    auditor checks every tick (invariant H). Tokens as the single tier's."""
    _, cfg = _model()

    def reqs():
        rng = np.random.default_rng(3)
        return [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=n)
                        .astype(np.int32), max_new=10)
                for i, n in enumerate((10, 18, 26, 34))]
    kw = dict(n_slots=4, prefill_chunk=PS)
    base, _ = _run(reqs=reqs(), **kw)
    got, eng = _run(reqs=reqs(), device_pages=7, **kw)
    assert all(r.done for r in got)
    st = eng.stats()["tiered"]
    assert st["n_demoted"] > 0 and st["n_deferred"] > 0
    assert eng.n_preempted == 0
    assert [r.out for r in got] == [r.out for r in base]


def test_prefetch_counters():
    """A device tier that holds every page scores only hits; the minimum
    tier records misses, promotions through the queue and a hit rate
    strictly between 0 and 1; winner pages never exceed live pages."""
    _, flat = _run()
    assert "tiered" not in flat.stats()
    _, roomy = _run(device_pages=1 + 2 * flat.req_budget)
    st = roomy.stats()["tiered"]
    assert st["n_prefetch_hits"] > 0 and st["n_prefetch_misses"] == 0
    assert st["prefetch_hit_rate"] == 1.0 and st["n_sync_fetches"] == 0
    assert st["n_decode_runs"] == roomy.n_decode_steps
    _, tight = _run(device_pages=flat.req_budget + 1)
    st = tight.stats()["tiered"]
    assert st["n_prefetch_misses"] > 0 and st["n_fetches_issued"] > 0
    assert 0.0 < st["prefetch_hit_rate"] < 1.0
    assert 0 < st["winner_pages"] <= st["live_pages"]
    assert st["h2d_bytes"] == tight._page_bytes * (
        st["n_fetches_issued"] + st["n_sync_fetches"]
        + st["n_sync_fallbacks"])
    assert st["d2h_bytes"] == tight._page_bytes * st["n_demoted"]
    assert st["peak_host_bytes"] > 0


def test_tier_chaos_with_auditor():
    """dma_timeout (a fetch never lands: copied again) and
    hbm_oom_on_promote (no staging frame: demote, retry or defer) with the
    auditor on every tick: DONE outputs equal the fault-free tiered
    run's."""
    truth, _ = _run(reqs=_stream(_model()[1], n=5), n_slots=3,
                    device_pages=9)
    plan = FI.FaultPlan.parse(
        "seed=5,dma_timeout=0.5,hbm_oom_on_promote=0.5")
    reqs, eng = _run(reqs=_stream(_model()[1], n=5), n_slots=3,
                     device_pages=9, faults=plan)
    assert [r.out for r in reqs] == [r.out for r in truth]
    assert plan.counts["dma_timeout"] > 0
    assert plan.counts["hbm_oom_on_promote"] > 0
    assert eng.stats()["tiered"]["n_sync_fallbacks"] > 0
    assert eng.stats()["faults"] == dict(plan.counts)


def test_auditor_catches_slot_corrupt():
    """slot_corrupt repoints a slot's tail entry silently; the auditor
    raises at that very tick."""
    plan = FI.FaultPlan(at={"slot_corrupt": {6}})
    params, cfg = _model()
    eng = PagedServingEngine(params, cfg, n_slots=2, smax=48, page_size=PS,
                             prefill_chunk=4, faults=plan, audit=True,
                             device="cpu")
    for r in _stream(cfg, n=2):
        eng.submit(r)
    with pytest.raises(FI.AuditError, match=r"invariant [BCE]"):
        eng.drain(50)
    assert eng.ticks == 7 and plan.counts["slot_corrupt"] >= 1


@pytest.mark.parametrize("packed", [False, True])
def test_nan_logits_quarantines_one_slot(packed):
    """A NaN row FAILs that slot's request alone, masked and packed (two
    live slots of four: a packed row carries the slot); the others finish
    with the fault-free run's tokens."""
    n_slots = 4 if packed else 2
    truth, _ = _run("full", n_slots=n_slots, packed=packed)
    plan = FI.FaultPlan(at={"nan_logits": {(6, 0)}})
    reqs, eng = _run("full", n_slots=n_slots, packed=packed, faults=plan)
    failed = [r for r in reqs if r.status is Status.FAILED]
    assert len(failed) == 1 and "non-finite" in failed[0].detail
    assert eng.n_quarantined == 1
    assert (eng.stats()["packed"]["n_packed_ticks"] > 0) == packed
    for r, t in zip(reqs, truth):
        assert r.status is Status.FAILED or r.out == t.out
    assert _at_baseline(eng)


@pytest.mark.parametrize("site,rate", [("alloc_fail", 0.25),
                                       ("pool_exhaustion", 0.6)])
def test_pool_faults_degrade(site, rate):
    """Transient allocation failures slow serving down (retries and
    preemptions) but every request finishes with the fault-free tokens,
    the auditor green throughout."""
    truth, _ = _run("full")
    plan = FI.FaultPlan(seed=5, rates={site: rate})
    reqs, eng = _run("full", faults=plan)
    assert plan.counts[site] >= 1
    for r, t in zip(reqs, truth):
        assert r.done and r.out == t.out, r.rid
    assert _at_baseline(eng)


def test_kernel_fail_ladder_on_cpu():
    """On a CPU engine an injected kernel_fail disables the kernel backend
    and re-runs the step on the plain gathered path, which the rest of the
    stream keeps: the tokens of an engine on that path throughout."""
    try:
        want, _ = _run(backend="xla")
        plan = FI.FaultPlan(at={"kernel_fail": {6}})
        reqs, eng = _run(faults=plan)
        assert eng.n_backend_fallbacks == 1
        assert eng.stats()["n_backend_fallbacks"] == 1
        assert dispatch.backend_disabled("pallas") is not None
        assert dispatch.resolve_backend("pallas", "cpu") == "xla"
        assert [r.out for r in reqs] == [r.out for r in want]
    finally:
        dispatch.enable_backend("pallas")


def test_engine_refuses_what_the_tier_cannot_serve(monkeypatch):
    """A policy other than Loki's, a quantized layout, too few frames, and
    on a CUDA engine a plan that can fire kernel_fail (no floor)."""
    params, cfg = _model()
    full = _model("full")
    with pytest.raises(ValueError, match="Loki policy"):
        PagedServingEngine(*full, device_pages=7, device="cpu")
    with pytest.raises(ValueError, match="non-quantized"):
        PagedServingEngine(params,
                           cfg.with_layout(PageLayout.parse("int8")),
                           device_pages=7, smax=48, page_size=PS,
                           device="cpu")
    with pytest.raises(ValueError, match="cannot hold one full request"):
        PagedServingEngine(params, cfg, smax=48, page_size=PS,
                           device_pages=6, device="cpu")
    monkeypatch.setattr(SCH, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="ROADMAP §3"):
        PagedServingEngine(params, cfg, faults=FI.FaultPlan(
            at={"kernel_fail": {3}}))


def test_serve_runs_the_tiered_engine_on_cpu(capsys):
    """The launcher's tier and fault flags, the reference's names: the run
    serves every request and ends with the tiered counters."""
    from repro_torch.launch import serve
    reqs = serve.main(["--engine", "paged", "--arch", "llama2-7b",
                       "--policy", "loki_block", "--requests", "3",
                       "--max-new", "3", "--smax", "64", "--page-size",
                       "16", "--device-pages", "5", "--max-inflight", "1",
                       "--faults", "seed=7,dma_timeout=0.2", "--audit",
                       "--device", "cpu"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    out = capsys.readouterr().out
    assert "tiered pool: 5 device frames" in out and "packed=False" in out
    assert "faults: [seed=7,dma_timeout=0.2] audit=per-tick" in out
    assert "demoted" in out and "prefetch hit rate" in out
    with pytest.raises(ValueError, match="use --engine paged"):
        serve.main(["--engine", "dense", "--device-pages", "5",
                    "--device", "cpu"])
