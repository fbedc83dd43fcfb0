"""The port's MoE family against the JAX package's, on CPU.

``moe_apply`` (capacity routing with drops, its aux loss) and
``moe_decode`` meet JAX's on the same layer weights and inputs; the
granite-moe smoke model's ``forward``, ``prefill`` + ``decode_step`` and
paged ``prefill_chunk`` + ``decode_step`` meet JAX's on the same weights
(handed over through numpy by ``params_from_numpy``), and so does the
mixtral smoke model's dense path (sliding window, drop-free capacity).
The paged engine serves granite as the dense engine does where the
prefill's dispatch groups line up. Tolerance 2e-5 at float32.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.models import blocks, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import PagedServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)


def _jit(fn, **static):
    """JAX's entry point jitted with its static arguments bound: one
    compile per test instead of one per primitive (called by keyword)."""
    return jax.jit(functools.partial(fn, **static))
GRANITE = "granite-moe-3b-a800m"
KW = dict(k_f=0.25, d_f=0.5, block_size=8, local_window=4, min_k=4)

_MODELS = {}


def _model(arch=GRANITE, policy="loki_block"):
    """JAX's smoke weights with a random orthogonal PCA basis, and the
    port's copy of them."""
    if (arch, policy) not in _MODELS:
        jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
        if policy != "full":
            jcfg, cfg = jcfg.with_policy(policy, **KW), \
                cfg.with_policy(policy, **KW)
        else:
            jcfg = jcfg.replace(loki=dataclasses.replace(jcfg.loki,
                                                         block_size=8))
            cfg = cfg.replace(loki=dataclasses.replace(cfg.loki,
                                                       block_size=8))
        # the kernels' plain versions against JAX's kernels in interpret
        # mode: both select blocks group-shared
        jcfg = jcfg.replace(loki=dataclasses.replace(jcfg.loki,
                                                     backend="pallas"))
        cfg = cfg.replace(loki=dataclasses.replace(cfg.loki,
                                                   backend="pallas"))
        params = jlm.init(jax.random.PRNGKey(0), jcfg)
        rng = np.random.RandomState(4)
        hd = cfg.resolved_head_dim
        pca = np.stack([[np.linalg.qr(rng.randn(hd, hd))[0]
                         for _ in range(cfg.n_kv_heads)]
                        for _ in range(cfg.n_layers)]).astype(np.float32)
        params["layers"]["attn"]["pca"] = jnp.asarray(pca)
        tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
        _MODELS[(arch, policy)] = (jcfg, cfg, params, tparams)
    return _MODELS[(arch, policy)]


def _layer(params, tparams, i=0):
    return (jax.tree.map(lambda a: a[i], params["layers"]["moe"]),
            {k: v[i] for k, v in tparams["layers"]["moe"].items()})


def _skewed(n_tok, d, seed):
    """Tokens around one shared direction, so the router sends most of
    them to the same experts and capacity drops some."""
    rng = np.random.RandomState(seed)
    return (rng.randn(1, 1, d) + 0.5 * rng.randn(1, n_tok, d)).astype(
        np.float32)


@pytest.mark.parametrize("n_tok", [40, 512])
def test_moe_apply_matches_jax_with_drops(n_tok):
    """One dispatch group (40 tokens) and two (512): outputs and the aux
    loss equal JAX's while experts over capacity drop tokens."""
    jcfg, cfg, params, tparams = _model()
    jp, tp = _layer(params, tparams)
    x = _skewed(n_tok, cfg.d_model, n_tok)
    want, want_aux = _jit(jblocks.moe_apply, cfg=jcfg)(jp,
                                                       x=jnp.asarray(x))
    got, aux = blocks.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    # drops did happen: some expert got more picks than its capacity
    m = cfg.moe
    g = min(blocks.MOE_GROUP, n_tok)
    cap = max(4, -(-int(math.ceil(g * m.top_k / m.n_experts
                                  * m.capacity_factor)) // 4) * 4)
    logits = x.reshape(-1, g, cfg.d_model) @ tp["router"].numpy()
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :m.top_k]
    counts = np.stack([np.bincount(t.ravel(), minlength=m.n_experts)
                       for t in top])
    assert (counts > cap).any(), (counts, cap)


def test_moe_decode_matches_jax():
    jcfg, cfg, params, tparams = _model()
    jp, tp = _layer(params, tparams, 1)
    x = np.random.RandomState(3).randn(5, cfg.d_model).astype(np.float32)
    want = _jit(jblocks.moe_decode, cfg=jcfg)(jp, x=jnp.asarray(x))
    got = blocks.moe_decode(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_apply_refuses_a_partial_dispatch_group():
    """300 tokens are not a whole number of 256-token groups: the
    reference's reshape is undefined there, and the port raises."""
    _, cfg, _, tparams = _model()
    _, tp = _layer(_model()[2], tparams)
    with pytest.raises(ValueError, match="dispatch groups"):
        blocks.moe_apply(tp, torch.zeros((1, 300, cfg.d_model)), cfg)


@pytest.mark.parametrize("policy", ["loki_block", "full"])
def test_granite_forward_prefill_and_decode_match_jax(policy):
    """forward (logits and the aux loss summed over layers), prefill of
    two 40-token prompts (80 tokens, one dispatch group) and four decode
    steps."""
    jcfg, cfg, params, tparams = _model(policy=policy)
    toks = np.random.RandomState(5).randint(0, cfg.vocab, size=(2, 40))
    want, want_aux = _jit(jlm.forward, cfg=jcfg)(params,
                                                 tokens=jnp.asarray(toks))
    got, aux = lm.forward(tparams, torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert float(aux) > 0
    jl, jcache, jpos = _jit(jlm.prefill, cfg=jcfg, smax=64,
                            cache_dtype=jnp.float32)(
        params, tokens=jnp.asarray(toks))
    tl, tcache, tpos = lm.prefill(tparams, cfg, torch.as_tensor(toks), 64,
                                  cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdecode = _jit(jlm.decode_step, cfg=jcfg)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jdecode(params, cache=jcache, token=jnp.asarray(tok),
                             pos_len=jpos)
        tl, tcache = lm.decode_step(tparams, cfg, tcache,
                                    torch.as_tensor(tok), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_granite_paged_prefill_chunk_and_decode_match_jax():
    """Two prompts prefilled 16 tokens a chunk into shuffled pages, then
    four batched decode steps with an idle slot on the trash page."""
    jcfg, cfg, params, tparams = _model()
    ps, chunk = 16, 16
    tables = np.array([[5, 2, 9, 1], [8, 11, 4, 10], [0, 0, 0, 0]],
                      np.int32)
    jcache = jlm.init_paged_cache(jcfg, 12, ps, jnp.float32)
    tcache = lm.init_paged_cache(cfg, 12, ps, device="cpu")
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32)
               for n in (37, 50)]
    jchunk = _jit(jlm.prefill_chunk, cfg=jcfg, page_size=ps)
    jdecode = _jit(jlm.decode_step, cfg=jcfg, page_size=ps)
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt) - 1, chunk):
            nv = min(chunk, len(prompt) - 1 - start)
            c = np.zeros((1, chunk), np.int32)
            c[0, :nv] = prompt[start:start + nv]
            jl, jcache = jchunk(
                params, cache=jcache, tokens=jnp.asarray(c),
                pos_start=jnp.int32(start), n_valid=jnp.int32(nv),
                page_table=jnp.asarray(tables[slot:slot + 1]))
            tl, tcache = lm.prefill_chunk(
                tparams, cfg, tcache, torch.from_numpy(c), start, nv,
                torch.from_numpy(tables[slot:slot + 1]), ps)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.array([p[-1] for p in prompts] + [0], np.int32)
    pos = np.array([len(p) - 1 for p in prompts] + [0], np.int32)
    for _ in range(4):
        jl, jcache = jdecode(params, cache=jcache, token=jnp.asarray(tok),
                             pos_len=jnp.asarray(pos),
                             page_table=jnp.asarray(tables))
        tl, tcache = lm.decode_step(tparams, cfg, tcache,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(pos),
                                    page_table=torch.from_numpy(tables),
                                    page_size=ps)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tok[2] = 0
        pos = pos + np.array([1, 1, 0], np.int32)


def test_mixtral_smoke_dense_path_matches_jax():
    """Mixtral's smoke model (sliding window 64, capacity = n_experts, so
    no drops) on the dense path: a 90-token prompt past the window, then
    four decode steps; the paged engine serves the window now, recycling
    its pages (tests/test_torch_families.py)."""
    jcfg, cfg, params, tparams = _model("mixtral-8x22b", "full")
    toks = np.random.RandomState(8).randint(0, cfg.vocab, size=(1, 90))
    jl, jcache, jpos = _jit(jlm.prefill, cfg=jcfg, smax=128,
                            cache_dtype=jnp.float32)(
        params, tokens=jnp.asarray(toks))
    tl, tcache, tpos = lm.prefill(tparams, cfg, torch.as_tensor(toks), 128,
                                  cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdecode = _jit(jlm.decode_step, cfg=jcfg)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jdecode(params, cache=jcache, token=jnp.asarray(tok),
                             pos_len=jpos)
        tl, tcache = lm.decode_step(tparams, cfg, tcache,
                                    torch.as_tensor(tok), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    eng = PagedServingEngine(tparams, cfg, page_size=16, device="cpu")
    assert eng.window == cfg.sliding_window == 64
    assert eng.req_budget == -(-64 // 16) + 1


@pytest.mark.parametrize("policy", ["loki_block", "exact_topk"])
def test_granite_paged_engine_matches_dense_engine(policy):
    """The paged engine (packed, prefix cache on) against the dense
    engine on prompts whose len - 1 tokens are whole 256-token dispatch
    groups, prefilled 256 tokens a chunk: every group routes the same
    tokens on both paths, drops included, and greedy tokens agree."""
    _, cfg, _, tparams = _model(policy=policy)
    rng = np.random.RandomState(10)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32)
               for n in (257, 513, 257)]
    outs = []
    for paged in (False, True):
        eng = (PagedServingEngine(tparams, cfg, n_slots=2, smax=520,
                                  page_size=8, prefill_chunk=256,
                                  device="cpu") if paged else
               ServingEngine(tparams, cfg, n_slots=2, smax=520,
                             device="cpu"))
        reqs = [Request(rid=i, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done(300)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
