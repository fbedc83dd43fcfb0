"""The port's window and encoder families against the JAX package's, on
CPU: whisper (encoder-decoder, CrossAttnStatic), llava (vlm), mixtral's
sliding window (recycled pages on the trash page) and per-layer page-table
groups, and per-layer page ranks.

The model entry points meet JAX's on the same smoke weights (handed over
through numpy by ``params_from_numpy``), tolerance 2e-5 at float32; the
kernels' plain versions stand in for the CUDA kernels (JAX: Pallas in
interpret mode). The cache-spec registry meets JAX's for every ported arch.
The port's paged engine is held against the port's own dense engine, never
against a JAX engine (they race on host arrays they update in place).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.serving import cache_spec as JCS
from repro.serving import paged_cache as JPC
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import PageLayout, TrainConfig
from repro_torch.data.synthetic import DataConfig, SyntheticLM, torch_batch
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.serving import cache_spec as CS
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import PagedServingEngine
from repro_torch.training.step import TrainState, make_train_step

TOL = dict(rtol=2e-5, atol=2e-5)
KW = dict(k_f=0.25, d_f=0.5, block_size=8, local_window=4, min_k=4)
PS = 8
WHISPER, LLAVA, MIXTRAL = ("whisper-small", "llava-next-mistral-7b",
                           "mixtral-8x22b")


def _jit(fn, **static):
    """JAX's entry point jitted with its static arguments bound (called
    by keyword)."""
    return jax.jit(functools.partial(fn, **static))


def _cfgs(arch, policy="full", layout=None, windows=None, ranks=None):
    """The same config in both packages: the policy (block size 8), the
    kernel backend (the port's plain kernels against JAX's Pallas kernels
    in interpret mode), a page layout, per-layer windows, per-layer
    ranks."""
    out = []
    for c in (jget_smoke(arch), get_smoke_config(arch)):
        if policy != "full":
            c = c.with_policy(policy, **KW)
        c = c.replace(loki=dataclasses.replace(c.loki, block_size=8,
                                               backend="pallas"))
        if layout:
            c = c.with_layout(type(c.page_layout).parse(layout))
        if windows is not None:
            c = c.with_window_layers(windows)
        if ranks is not None:
            c = c.with_ranks(ranks)
        out.append(c)
    return out


_PARAMS = {}


def _params(arch, jcfg, cfg):
    """JAX's smoke weights with a random orthogonal PCA basis per (layer,
    kv head), and the port's copy of them (one per arch: the weights do
    not depend on the policy)."""
    if arch not in _PARAMS:
        params = jlm.init(jax.random.PRNGKey(0), jcfg)
        rng = np.random.RandomState(4)
        hd = cfg.resolved_head_dim
        pca = np.stack([[np.linalg.qr(rng.randn(hd, hd))[0]
                         for _ in range(cfg.n_kv_heads)]
                        for _ in range(cfg.n_layers)]).astype(np.float32)
        params["layers"]["attn"]["pca"] = jnp.asarray(pca)
        _PARAMS[arch] = (params, jax.tree.map(np.asarray, params))
    params, host = _PARAMS[arch]
    return params, params_from_numpy(host, cfg, device="cpu")


def _frames(cfg, batch, seed=3):
    return np.random.RandomState(seed).randn(
        batch, cfg.enc_seq, cfg.d_model).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# ------------------------------------------------ dense path vs JAX

@pytest.mark.parametrize("policy", ["full", "loki_block"])
def test_whisper_forward_prefill_decode_match_jax(policy):
    """whisper's forward over frames, its one-shot prefill (cross K/V
    written inline) and four decode steps reading them, against JAX's."""
    jcfg, cfg = _cfgs(WHISPER, policy)
    params, tparams = _params(WHISPER, jcfg, cfg)
    fr = _frames(cfg, 2)
    toks = np.random.RandomState(5).randint(0, cfg.vocab, (2, 13))
    jl, _ = jlm.forward(params, jnp.asarray(toks), jcfg,
                        frames=jnp.asarray(fr))
    tl, _ = lm.forward(tparams, torch.as_tensor(toks), cfg,
                       frames=torch.from_numpy(fr))
    _close(tl, jl)
    jl, jcache, jpos = jlm.prefill(params, jcfg, jnp.asarray(toks), 32,
                                   frames=jnp.asarray(fr),
                                   cache_dtype=jnp.float32)
    tl, tcache, tpos = lm.prefill(tparams, cfg, torch.as_tensor(toks), 32,
                                  frames=torch.from_numpy(fr),
                                  cache_dtype=torch.float32)
    _close(tl, jl)
    _close(tcache["layers"]["cross_k"], jcache["layers"]["cross_k"])
    jdecode = _jit(jlm.decode_step, cfg=jcfg)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jdecode(params, cache=jcache, token=jnp.asarray(tok),
                             pos_len=jpos)
        tl, tcache = lm.decode_step(tparams, cfg, tcache,
                                    torch.as_tensor(tok), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        _close(tl, jl)


def test_llava_forward_and_prefill_with_patches_match_jax():
    """llava's projected patches in place of the prompt's last
    ``vision_tokens`` tokens: forward and prefill against JAX's, and the
    text rows' logits move when the patches do."""
    jcfg, cfg = _cfgs(LLAVA)
    params, tparams = _params(LLAVA, jcfg, cfg)
    toks = np.random.RandomState(6).randint(0, cfg.vocab, (2, 40))
    pa = np.random.RandomState(7).randn(2, cfg.vision_tokens,
                                        cfg.d_model).astype(np.float32)
    jl, _ = jlm.forward(params, jnp.asarray(toks), jcfg,
                        patches=jnp.asarray(pa))
    tl, _ = lm.forward(tparams, torch.as_tensor(toks), cfg,
                       patches=torch.from_numpy(pa))
    _close(tl, jl)
    plain, _ = lm.forward(tparams, torch.as_tensor(toks), cfg)
    assert not torch.allclose(plain[:, -1], tl[:, -1])
    jl, _, _ = jlm.prefill(params, jcfg, jnp.asarray(toks), 64,
                           patches=jnp.asarray(pa), cache_dtype=jnp.float32)
    tl, _, _ = lm.prefill(tparams, cfg, torch.as_tensor(toks), 64,
                          patches=torch.from_numpy(pa),
                          cache_dtype=torch.float32)
    _close(tl, jl)


# ------------------------------------------------ paged path vs JAX

def _jax_install_cross(jcfg, jcache, ck, cv, n_slots):
    """The reference scheduler's ``_install_cross`` for every slot, on
    JAX's cache (quantized layouts: one amax scale per layer and slot)."""
    layers = dict(jcache["layers"])
    for name, x in (("cross_k", ck), ("cross_v", cv)):
        x = x.astype(jnp.float32)
        if name + "_scale" in layers:
            qmax = jcfg.page_layout.qmax
            amax = jnp.max(jnp.abs(x), axis=(2, 3, 4))        # (L, slots)
            s = jnp.maximum(amax, JPC.QUANT_EPS) / qmax
            layers[name + "_scale"] = s
            x = JPC.quantize_rows(x, s[:, :, None, None, None],
                                  layers[name].dtype, qmax)
        layers[name] = x.astype(layers[name].dtype)[:, :n_slots]
    return {"layers": layers}


def _dq(layers, name):
    x = np.asarray(layers[name], np.float32)
    if name + "_scale" in layers:
        x = x * np.asarray(layers[name + "_scale"])[:, :, None, None, None]
    return x


def _paged_pair(arch, jcfg, cfg, params, tparams, tables, prompts, *,
                chunk=4, frames=None, recycle=None, steps=4, quant_step=0):
    """Both packages' paged entry points on the same pools: each prompt
    prefilled chunk by chunk through its slot's table (``tables[slot]``,
    (max_pages,) or rank 2 with groups), then ``steps`` batched decode
    steps over every slot. ``recycle(table, next_q)`` -> the table with
    the pages a query at ``next_q`` no longer sees sent to the trash page,
    applied before each chunk and each step as the engine does. With
    ``frames`` the cross K/V go in first; the port's install is held
    against JAX's within ``quant_step`` code steps (0: exactly), then
    JAX's copy goes into both caches. Returns both caches."""
    n_slots = len(prompts)
    n_pages = int(tables.max()) + 1
    jcache = jlm.init_paged_cache(jcfg, n_pages, PS, jnp.float32,
                                  n_slots=n_slots)
    tcache = lm.init_paged_cache(cfg, n_pages, PS, n_slots=n_slots,
                                 device="cpu")
    if frames is not None:
        ck, cv = jlm.encode_cross_kv(params, jcfg, jnp.asarray(frames))
        tck, tcv = lm.encode_cross_kv(tparams, cfg, torch.from_numpy(frames))
        _close(tck, ck)
        jcache = _jax_install_cross(jcfg, jcache, ck, cv, n_slots)
        for s in range(n_slots):
            lm.install_cross_kv(cfg, tcache, s, tck[:, s:s + 1],
                                tcv[:, s:s + 1])
        tl, jla = tcache["layers"], jcache["layers"]
        for name in ("cross_k", "cross_v"):
            scale = (np.asarray(jla[name + "_scale"]).max()
                     if name + "_scale" in jla else 0.0)
            np.testing.assert_allclose(
                _dq({k: v.numpy() for k, v in tl.items() if "cross" in k},
                    name),
                _dq(jla, name), rtol=2e-5, atol=2e-5 + quant_step * scale)
            for key in (name, name + "_scale"):
                if key in jla:
                    tl[key].copy_(torch.from_numpy(np.array(jla[key])))
    recycle = recycle or (lambda t, q: t)
    jchunk = _jit(jlm.prefill_chunk, cfg=jcfg, page_size=PS)
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt) - 1, chunk):
            nv = min(chunk, len(prompt) - 1 - start)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :nv] = prompt[start:start + nv]
            table = recycle(tables[slot], start)[None]
            jl, jcache = jchunk(params, cache=jcache, tokens=jnp.asarray(buf),
                                pos_start=jnp.int32(start),
                                n_valid=jnp.int32(nv),
                                page_table=jnp.asarray(table),
                                slot=jnp.int32(slot))
            tl, tcache = lm.prefill_chunk(tparams, cfg, tcache,
                                          torch.from_numpy(buf), start, nv,
                                          torch.from_numpy(table), PS,
                                          slot=slot)
            _close(tl, jl)
    tok = np.array([p[-1] for p in prompts], np.int32)
    pos = np.array([len(p) - 1 for p in prompts], np.int32)
    jdecode = _jit(jlm.decode_step, cfg=jcfg, page_size=PS)
    for _ in range(steps):
        table = np.stack([recycle(t, int(q)) for t, q in zip(tables, pos)])
        jl, jcache = jdecode(params, cache=jcache, token=jnp.asarray(tok),
                             pos_len=jnp.asarray(pos),
                             page_table=jnp.asarray(table))
        tl, tcache = lm.decode_step(tparams, cfg, tcache,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(pos),
                                    page_table=torch.from_numpy(table),
                                    page_size=PS)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    return jcache, tcache


def _tables(n_slots, max_pages, seed=0, n_groups=None):
    """Shuffled page ids 1.. for every slot (and group)."""
    lead = (n_slots,) if n_groups is None else (n_slots, n_groups)
    n = int(np.prod(lead)) * max_pages
    ids = np.random.RandomState(seed).permutation(n) + 1
    return ids.reshape(lead + (max_pages,)).astype(np.int32)


@pytest.mark.parametrize("policy,layout", [("full", ""), ("loki_block", ""),
                                           ("full", "int8"),
                                           ("loki_block", "int8")])
def test_whisper_paged_with_cross_kv_matches_jax(policy, layout):
    """whisper's paged path: cross K/V installed per slot (int8: codes
    with one scale per layer and slot, within one code step of JAX's),
    chunked prefill attending them, four batched decode steps."""
    jcfg, cfg = _cfgs(WHISPER, policy, layout)
    params, tparams = _params(WHISPER, jcfg, cfg)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in (14, 9)]
    _paged_pair(WHISPER, jcfg, cfg, params, tparams, _tables(2, 4), prompts,
                frames=_frames(cfg, 2), quant_step=1 if layout else 0)


def test_whisper_chunked_prefill_matches_oneshot():
    """The port's chunks attend the admission-written cross K/V
    (``encode_cross_kv`` + ``install_cross_kv``); their logits equal the
    one-shot prefill's, which writes the cross K/V inline."""
    cfg = get_smoke_config(WHISPER)
    tparams = lm.init(cfg, seed=1, device="cpu")
    prompt = (np.arange(13) * 5 + 2) % cfg.vocab
    fr = torch.from_numpy(_frames(cfg, 1))
    toks = torch.as_tensor(prompt[None].astype(np.int32))
    ref, _, _ = lm.prefill(tparams, cfg, toks, 32, frames=fr,
                           cache_dtype=torch.float32)
    cache = lm.init_paged_cache(cfg, 6, PS, n_slots=2, device="cpu")
    lm.install_cross_kv(cfg, cache, 1, *lm.encode_cross_kv(tparams, cfg, fr))
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    for start in range(0, len(prompt), 4):
        nv = min(4, len(prompt) - start)
        buf = np.zeros((1, 4), np.int32)
        buf[0, :nv] = prompt[start:start + nv]
        lg, cache = lm.prefill_chunk(tparams, cfg, cache,
                                     torch.from_numpy(buf), start, nv, table,
                                     PS, slot=1)
    np.testing.assert_allclose(lg.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def _recycler(windows, gids=None):
    """The engine's recycling on a hand-made table: entries below
    ``(next_q - w + 1) // PS`` point at the trash page, per group."""
    def one(row, next_q, w):
        row = row.copy()
        if w:
            row[:max(0, next_q - w + 1) // PS] = 0
        return row

    def recycle(table, next_q):
        if table.ndim == 1:
            return one(table, next_q, windows[0])
        return np.stack([one(r, next_q, w) for r, w in zip(table, windows)])
    return recycle


@pytest.mark.parametrize("policy", ["full", "loki_block"])
def test_mixtral_window_through_recycled_tables_matches_jax(policy):
    """mixtral's 64-token window past its end: chunks and decode steps
    through tables whose recycled entries read the trash page, against
    JAX's on the same tables; then one step over the recycled table
    equals, bit for bit, the same step over the unrecycled one."""
    jcfg, cfg = _cfgs(MIXTRAL, policy)
    params, tparams = _params(MIXTRAL, jcfg, cfg)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in (90, 75)]
    tables = _tables(2, 14)
    recycle = _recycler((cfg.sliding_window,))
    _, tcache = _paged_pair(MIXTRAL, jcfg, cfg, params, tparams, tables,
                            prompts, chunk=16, recycle=recycle, steps=3)
    tok = torch.tensor([3, 4], dtype=torch.int32)
    pos = np.array([92, 77], np.int32)
    rec = np.stack([recycle(t, int(q)) for t, q in zip(tables, pos)])
    assert (rec == 0).sum() > 0
    out = []
    for table in (rec, tables):
        cache = lm.tree_map(torch.clone, tcache)
        out.append(lm.decode_step(tparams, cfg, cache, tok,
                                  torch.from_numpy(pos),
                                  page_table=torch.from_numpy(table),
                                  page_size=PS)[0])
    assert torch.equal(out[0], out[1])


def test_mixtral_window_groups_through_rank3_tables_match_jax():
    """``with_window_layers((16, 0))``: two page-table groups, layer 0
    reading the window group's row (recycled) and layer 1 the full
    group's, through (B, 2, max_pages) tables."""
    jcfg, cfg = _cfgs(MIXTRAL, "loki_block", windows=(16, 0))
    assert CS.group_windows(cfg) == (0, 16) == JCS.group_windows(jcfg)
    assert CS.layer_group_ids(cfg) == (1, 0)
    params, tparams = _params(MIXTRAL, jcfg, cfg)
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in (40, 29)]
    _paged_pair(MIXTRAL, jcfg, cfg, params, tparams,
                _tables(2, 8, n_groups=2), prompts, chunk=8,
                recycle=_recycler(CS.group_windows(cfg)), steps=3)


def test_page_ranks_paged_decode_matches_jax():
    """Per-layer latent-K ranks (full width, then half): one pool as wide
    as the widest rank, the narrower layer's tail columns zeroed."""
    jcfg, cfg = _cfgs("llama2-7b", "loki_block")
    hd = cfg.resolved_head_dim
    jcfg, cfg = jcfg.with_ranks((hd, hd // 2)), cfg.with_ranks((hd, hd // 2))
    assert CS.layer_k_widths(cfg) == JCS.layer_k_widths(jcfg) == (hd, hd // 2)
    params, tparams = _params("llama2-7b", jcfg, cfg)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in (21, 12)]
    _, tcache = _paged_pair("llama2-7b", jcfg, cfg, params, tparams,
                            _tables(2, 5), prompts)
    k = tcache["layers"]["attn"]["k"]
    assert k.shape[-1] == hd and not k[1, ..., hd // 2:].any()


# ------------------------------------------------ the cache-spec registry

PORTED = list(JARCHS)


def _variants(arch):
    yield jget_smoke(arch), get_smoke_config(arch)
    jc, tc = jget_smoke(arch), get_smoke_config(arch)
    if arch == MIXTRAL:
        yield (jc.with_window_layers((16, 0)),
               tc.with_window_layers((16, 0)))
    if arch == "llama2-7b":
        hd = tc.resolved_head_dim
        yield jc.with_ranks((hd, 8)), tc.with_ranks((hd, 8))
        lay = "int8:pca:r=16"
        yield (jc.with_layout(type(jc.page_layout).parse(lay)),
               tc.with_layout(PageLayout.parse(lay)))


@pytest.mark.parametrize("arch", PORTED)
def test_cache_spec_registry_matches_jax(arch):
    """Per ported arch (and mixtral's window groups, llama's ranks and a
    quantized layout): the spec table's kinds, windows and widths, the
    budgets, recycle window, groups, sharing and the printed table."""
    for jc, tc in _variants(arch):
        js, ts = JCS.layer_specs(jc), CS.layer_specs(tc)
        assert [s.kind for s in ts] == [s.kind for s in js]
        assert [type(s.attn).__name__ for s in ts] == \
            [type(s.attn).__name__ for s in js]
        assert [getattr(s.attn, "window", 0) for s in ts] == \
            [getattr(s.attn, "window", 0) for s in js]
        assert [s.cross is not None for s in ts] == \
            [s.cross is not None for s in js]
        for fn in ("layer_k_widths", "max_k_width", "latent_score_width",
                   "recycle_window", "group_windows", "layer_group_ids",
                   "n_table_groups", "pageable", "prefix_shareable"):
            assert getattr(CS, fn)(tc) == getattr(JCS, fn)(jc), fn
        for smax, ps in ((64, 16), (128, 8), (1 << 20, 16)):
            assert CS.request_page_budget(tc, smax, ps) == \
                JCS.request_page_budget(jc, smax, ps)
            for g in range(len(CS.group_windows(tc))):
                assert CS.group_page_budget(tc, g, smax, ps) == \
                    JCS.group_page_budget(jc, g, smax, ps)
            assert CS.format_spec_table(tc, smax, ps) == \
                JCS.format_spec_table(jc, smax, ps).replace(
                    jc.arch, tc.arch)
    assert CS.window_page_budget(4096, 128) == \
        JCS.window_page_budget(4096, 128)


def test_servable_archs_are_the_references_less_stateslot_families():
    """Every family is served now, the StateSlot ones (hymba, xlstm)
    included: the port's servable archs are the reference's."""
    assert CS.servable_archs() == JCS.servable_archs()
    assert {"hymba-1.5b", "xlstm-125m"} <= set(CS.servable_archs())


# ------------------------------------- the paged engine vs the dense one

def _engine_params(arch, policy, windows=None):
    cfg = get_smoke_config(arch)
    cfg = (cfg.with_policy(policy, **KW) if policy != "full" else cfg)
    cfg = cfg.replace(loki=dataclasses.replace(cfg.loki, block_size=8,
                                               backend="pallas"))
    if windows is not None:
        cfg = cfg.with_window_layers(windows)
    return lm.init(cfg, seed=2, device="cpu"), cfg


def _requests(cfg, lengths, max_new, frames=None):
    return [Request(rid=i, prompt=(np.arange(n) * 7 + i) % cfg.vocab,
                    max_new=max_new,
                    frames=None if frames is None else frames[i])
            for i, n in enumerate(lengths)]


def _dense_truth(params, cfg, lengths, max_new, smax, frames=None):
    """Each prompt alone through the port's dense engine."""
    outs = []
    for i, r in enumerate(_requests(cfg, lengths, max_new, frames)):
        eng = ServingEngine(params, cfg, n_slots=1, smax=smax, device="cpu")
        eng.submit(r)
        eng.run_until_done(500)
        assert r.done, r.status
        outs.append(r.out)
    return outs


def _drive(eng, reqs, each_tick=None, max_ticks=2000):
    for r in reqs:
        eng.submit(r)
    for _ in range(max_ticks):
        if not eng._queue and not eng._admit_order:
            break
        eng.tick()
        if each_tick is not None:
            each_tick(eng)
    return reqs


@pytest.mark.parametrize("policy", ["full", "loki_block"])
def test_whisper_paged_engine_matches_dense_engine(policy):
    """whisper through the paged engine (cross K/V installed at admission,
    prefix caching bypassed) gives the dense engine's greedy tokens."""
    params, cfg = _engine_params(WHISPER, policy)
    frames = _frames(cfg, 3)
    lengths = (11, 6, 17)
    truth = _dense_truth(params, cfg, lengths, 6, 48, frames)
    eng = PagedServingEngine(params, cfg, n_slots=2, smax=48, page_size=PS,
                             prefill_chunk=4, device="cpu", audit=True)
    assert not eng.prefix_caching and "CrossAttnStatic" in \
        eng.prefix_cache_reason
    reqs = _drive(eng, _requests(cfg, lengths, 6, frames))
    assert [r.out for r in reqs] == truth
    st = eng.stats()
    assert st["n_host_syncs"] == st["n_decode_steps"] > 0
    assert eng.pool.free_pages == eng.pool.n_pages - 1


def _window_bound(budget):
    def check(eng):
        for slot in range(eng.n_slots):
            held = sum(p is not None for p in eng.slot_pages[slot])
            assert held <= budget, (eng.ticks, slot, held)
    return check


@pytest.mark.parametrize("policy", ["full", "loki_block"])
def test_mixtral_paged_engine_recycles_within_window_budget(policy):
    """mixtral's 64-token window on the paged engine: pages recycled in
    prefill and decode, ceil(64/8)+1 pages a slot at every tick (chunks of
    one page), greedy tokens equal to the dense engine's, every page
    back in the pool."""
    params, cfg = _engine_params(MIXTRAL, policy)
    lengths, max_new, smax = (81, 30), 30, 128
    truth = _dense_truth(params, cfg, lengths, max_new, smax)
    eng = PagedServingEngine(params, cfg, n_slots=2, smax=smax,
                             page_size=PS, prefill_chunk=PS, device="cpu",
                             audit=True)
    budget = CS.window_page_budget(cfg.sliding_window, PS)
    assert eng.req_budget == budget == 9 < eng.max_pages
    reqs = _drive(eng, _requests(cfg, lengths, max_new),
                  _window_bound(budget))
    assert [r.out for r in reqs] == truth
    st = eng.stats()
    assert st["n_recycled_pages"] > 0 and st["peak_slot_pages"] == budget
    assert eng.pool.free_pages == eng.pool.n_pages - 1


def test_recycled_pages_freed_exactly_once_under_pressure():
    """A pool too small for both requests: preemption and completion of
    requests that recycled pages free each page once (the pool raises on
    a double free, the auditor checks every tick); tokens as the dense
    engine's."""
    params, cfg = _engine_params(MIXTRAL, "full")
    lengths, max_new, smax = (70, 66, 20), 24, 128
    truth = _dense_truth(params, cfg, lengths, max_new, smax)
    eng = PagedServingEngine(params, cfg, n_slots=2, smax=smax,
                             page_size=PS, prefill_chunk=PS, n_pages=17,
                             device="cpu", audit=True)
    reqs = _drive(eng, _requests(cfg, lengths, max_new))
    assert [r.out for r in reqs] == truth
    assert eng.n_preempted > 0 and eng.n_recycled_pages > 0
    assert eng.pool.free_pages == eng.pool.n_pages - 1


def test_window_groups_engine_matches_dense_engine():
    """Two page-table groups (windows 16 and 0): the full group pins its
    pages while the window group recycles, each within its bound at every
    tick; packed decode over rank-3 tables; tokens as the dense
    engine's."""
    params, cfg = _engine_params(MIXTRAL, "loki_block", windows=(16, 0))
    lengths, max_new, smax = (30, 19, 41), 12, 64
    truth = _dense_truth(params, cfg, lengths, max_new, smax)
    eng = PagedServingEngine(params, cfg, n_slots=4, smax=smax,
                             page_size=PS, prefill_chunk=PS, device="cpu",
                             audit=True)

    def bound(e):
        for g in range(e.n_groups):
            for slot in range(e.n_slots):
                held = sum(p is not None for p in e._group_pages(g)[slot])
                assert held <= e._group_pages_hard[g]
        assert all(p is not None for pl in e.slot_pages for p in pl)
    reqs = _drive(eng, _requests(cfg, lengths, max_new), bound)
    assert [r.out for r in reqs] == truth
    st = eng.stats()
    assert st["table_groups"]["group_windows"] == [0, 16]
    assert st["n_recycled_pages"] > 0 and st["packed"]["n_packed_ticks"] > 0
    assert eng.pool.free_pages == eng.pool.n_pages - 1


def test_encoder_decoder_engines_need_frames():
    params, cfg = _engine_params(WHISPER, "full")
    eng = PagedServingEngine(params, cfg, n_slots=1, smax=32, page_size=PS,
                             device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.submit(Request(rid=0, prompt=np.arange(4), max_new=2))
    dense = ServingEngine(params, cfg, n_slots=1, smax=32, device="cpu")
    dense.submit(Request(rid=0, prompt=np.arange(4), max_new=2))
    with pytest.raises(ValueError, match="frames"):
        dense.tick()


def test_warm_steps_are_train_steps():
    """``--warm-steps 2``: the served params are those of two
    ``make_train_step`` steps from the same start, cast for serving."""
    cfg = get_smoke_config("llama2-7b")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=2, seed=7, n_states=32,
                                  temperature=0.22))
    got, m = serve.warm_params(cfg, data, steps=2, seed=0, device="cpu")
    params = lm.init(cfg, seed=0, device="cpu", dtype=cfg.param_dtype)
    state = TrainState(params, adamw.init_state(params))
    step = make_train_step(cfg, TrainConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=2))
    for i in range(2):
        state, _ = step(state, torch_batch(data.batch_at(i), "cpu"))
    want = dict(lm.tree_items(lm.cast_params(state.params, cfg)))
    for key, leaf in lm.tree_items(got):
        assert torch.equal(leaf, want[key]), key
    assert np.isfinite(float(m["loss"]))
