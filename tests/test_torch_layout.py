"""The port's page layouts against the JAX package's, on CPU.

Quantized pools (int8, fp8-e4m3 codes with one float32 scale per page)
are written by both packages from the same numpy rows: the codes must be
equal bit for bit and the scales equal, from page 1 on (page 0, the trash
page, takes the dead slots' writes in no defined order). The plain and
plain-cluster forms of the five decode kernels meet the JAX kernels in
interpret mode on a shuffled pool with a ragged table whose dead tail
points at the trash page, at fp16, int8 and fp8. The model's paged entry
points meet ``repro.models.lm`` under four layouts and the three paged
policies, logits and the pools each side wrote (never a JAX engine: its
engines race, ROADMAP queue 3).
Tolerance rtol = atol = 2e-5, the kernels' own.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import fused_decode as jfused
from repro.kernels import gather_attention as jgather
from repro.models import lm as jlm
from repro.serving import paged_cache as JPC
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import fused_decode, gather_attention, tuning
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import Request
from repro_torch.serving.scheduler import PagedServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)
QMAX = {"int8": 127.0, "fp8": 448.0}
JDTYPE = {"fp16": jnp.float16, "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint16)


# ------------------------------------------------------- pool writes

@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_writes_match_jax(dtype):
    """Two chunks (the second padded) into one request's pages, then six
    batched token writes over three slots (one idle on the trash page, one
    starting mid-page); quantize_rows and the dequantized logical view
    along the way."""
    rng = np.random.RandomState(3)
    ps, n_pages, h, w, qmax = 8, 10, 2, 4, QMAX[dtype]
    tdt, jdt = PC.STORAGE_DTYPE[dtype], JDTYPE[dtype]
    x = rng.randn(ps, h, w).astype(np.float32)
    s = np.float32(0.37)
    np.testing.assert_array_equal(
        _bits(PC.quantize_rows(torch.from_numpy(x), torch.tensor(s), tdt,
                               qmax).view(torch.uint8).numpy()),
        _bits(JPC.quantize_rows(jnp.asarray(x), s, jdt, qmax)))
    jpool = jnp.zeros((n_pages * ps, h, w), jdt)
    jsc = jnp.zeros((n_pages,), jnp.float32)
    tpool = torch.zeros((n_pages * ps, h, w), dtype=tdt)
    tsc = torch.zeros(n_pages)
    row = np.array([3, 7, 1, 9, 2], np.int32)
    for start, c, nv in ((0, 12, 12), (12, 12, 9)):
        new = (rng.randn(c, h, w) * rng.uniform(0.5, 3)).astype(np.float32)
        jpool, jsc = JPC.write_chunk_rows_q(
            jpool, jsc, jnp.asarray(new), jnp.asarray(row), start, ps,
            n_valid=nv, qmax=qmax)
        PC.write_chunk_rows_q(tpool, tsc, torch.from_numpy(new),
                              torch.from_numpy(row), start, ps, n_valid=nv,
                              qmax=qmax)
    tables = np.array([row, [0] * 5, [5, 6, 4, 8, 0]], np.int32)
    pos = np.array([21, 0, 3], np.int32)
    for _ in range(6):
        new = (rng.randn(3, h, w) * rng.uniform(0.5, 3)).astype(np.float32)
        jpool, jsc = JPC.write_token_rows_q(
            jpool, jsc, jnp.asarray(new), jnp.asarray(tables),
            jnp.asarray(pos), ps, qmax=qmax)
        PC.write_token_rows_q(tpool, tsc, torch.from_numpy(new),
                              torch.from_numpy(tables), torch.from_numpy(pos),
                              ps, qmax=qmax)
        pos = pos + np.array([1, 0, 1], np.int32)
    np.testing.assert_array_equal(tpool.view(torch.uint8).numpy()[ps:],
                                  _bits(jpool)[ps:])
    np.testing.assert_array_equal(tsc.numpy()[1:], np.asarray(jsc)[1:])
    live = tables[[0, 2]]
    np.testing.assert_array_equal(
        PC.gather_logical_dq(tpool, tsc, torch.from_numpy(live), ps).numpy(),
        np.asarray(JPC.gather_logical_dq(jpool, jsc, jnp.asarray(live), ps)))


# ------------------------------------------------------- kernels 1-5

B, HKV, G, S, DIM, BS, PS = 2, 2, 4, 256, 64, 32, 32
CUR = np.array([S, 100], np.int32)


def _paged_case(layout, seed=0):
    """Rotated caches scattered into a shuffled pool (page 0 the trash
    page), row 1's dead tail re-pointed at the trash page, then stored at
    ``layout`` (fp16 codes as they are; int8 and fp8 quantized per page,
    the scales from the port's own writer, checked above)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, HKV, G, DIM).astype(np.float32)
    k = rng.randn(B, S, HKV, DIM).astype(np.float32)
    v = rng.randn(B, S, HKV, DIM).astype(np.float32)
    mp = S // PS
    table = (rng.permutation(B * mp) + 1).reshape(B, mp).astype(np.int32)
    n_pages = B * mp + 1
    pool_k = np.zeros((n_pages * PS, HKV, DIM), np.float32)
    pool_v = np.zeros_like(pool_k)
    for i in range(B):
        for p in range(mp):
            rows = slice(table[i, p] * PS, table[i, p] * PS + PS)
            pool_k[rows] = k[i, p * PS:(p + 1) * PS]
            pool_v[rows] = v[i, p * PS:(p + 1) * PS]
    table[1, -(-100 // PS):] = 0                    # dead tail -> trash
    tdt = PC.STORAGE_DTYPE[layout]
    if layout not in QMAX:
        tk, tv = (torch.from_numpy(p).to(tdt) for p in (pool_k, pool_v))
        ks = vs = None
    else:
        ident = torch.arange(n_pages, dtype=torch.int32)
        tk = torch.zeros(pool_k.shape, dtype=tdt)
        tv = torch.zeros(pool_v.shape, dtype=tdt)
        ks, vs = torch.zeros(n_pages), torch.zeros(n_pages)
        for pool, sc, src in ((tk, ks, pool_k), (tv, vs, pool_v)):
            PC.write_chunk_rows_q(pool, sc, torch.from_numpy(src), ident, 0,
                                  PS, qmax=QMAX[layout])
    return dict(q=q, table=table, tk=tk, tv=tv, ks=ks, vs=vs)


def _jax(case):
    def j(t):
        if t is None:
            return None
        if t.dtype == torch.float8_e4m3fn:
            return jnp.asarray(t.view(torch.uint8).numpy()).view(
                jnp.float8_e4m3fn)
        if t.dtype == torch.float16:
            return jnp.asarray(t.numpy())
        return jnp.asarray(t.numpy())
    return (jnp.asarray(case["q"]), j(case["tk"]), j(case["tv"]),
            jnp.asarray(CUR), jnp.asarray(case["table"]), j(case["ks"]),
            j(case["vs"]))


KERNELS = ["select_blocks", "fused_loki_decode", "fused_exact_topk_decode",
           "block_sparse_attention_grouped", "paged_full_decode"]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("layout", ["fp16", "int8", "fp8"])
def test_scaled_kernels_match_jax(layout, kernel):
    """Each kernel's plain version (the wrapper on CPU tensors) and its
    plain cluster form against the JAX kernel in interpret mode, on the
    same pool codes and scales (scale pinned at D**-0.5)."""
    case = _paged_case(layout, seed=KERNELS.index(kernel))
    jq, jk, jv, jcur, jtab, jks, jvs = _jax(case)
    q = torch.from_numpy(case["q"])
    cur, tab = torch.from_numpy(CUR), torch.from_numpy(case["table"])
    tk, tv, ks, vs = case["tk"], case["tv"], case["ks"], case["vs"]
    paged = dict(page_size=PS)
    scale = DIM ** -0.5
    if kernel == "select_blocks":
        kw = dict(d=16, k_blocks=3, block_size=BS, local_window=8,
                  scale=scale)
        want = jfused.select_blocks(jq, jk, jcur, **kw, page_table=jtab,
                                    **paged, k_scale=jks, interpret=True)
        got = fused_decode.select_blocks(q, tk, cur, **kw, page_table=tab,
                                         **paged, k_scale=ks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    if kernel == "block_sparse_attention_grouped":
        blk = np.array([[[5, 0, -1, 2], [7, 1, 3, -1]],
                        [[3, -1, 0, 1], [2, 0, -1, -1]]], np.int32)
        want = jgather.block_sparse_attention_grouped(
            jq, jk, jv, jnp.asarray(blk), jcur, block_size=BS, scale=scale,
            page_table=jtab, **paged, k_scale=jks, v_scale=jvs,
            interpret=True)
        args = (q, tk, tv, torch.from_numpy(blk), cur)
        got = gather_attention.block_sparse_attention_grouped(
            *args, block_size=BS, scale=scale, page_table=tab, **paged,
            k_scale=ks, v_scale=vs)
        cluster = gather_attention.grouped_cluster_plain(
            *args, block_size=BS, scale=scale, n_cta=3, page_table=tab,
            **paged, k_scale=ks, v_scale=vs)
    elif kernel == "paged_full_decode":
        want = jgather.paged_full_decode(
            jq, jk, jv, jcur, block_size=BS, scale=scale, page_table=jtab,
            **paged, k_scale=jks, v_scale=jvs, interpret=True)
        got = gather_attention.paged_full_decode(
            q, tk, tv, cur, block_size=BS, scale=scale, page_table=tab,
            **paged, k_scale=ks, v_scale=vs)
        cluster = gather_attention.full_decode_split_plain(
            q, tk, tv, cur, block_size=BS, scale=scale, n_split=3,
            page_table=tab, **paged, k_scale=ks, v_scale=vs)
    else:
        exact = kernel == "fused_exact_topk_decode"
        kw = dict(k_blocks=3, block_size=BS, scale=scale)
        jkw = dict(kw) if exact else dict(kw, d=16, local_window=8)
        want = getattr(jfused, kernel)(
            jq, jk, jv, jcur, **jkw, page_table=jtab, **paged, k_scale=jks,
            v_scale=jvs, interpret=True)
        got = getattr(fused_decode, kernel)(
            q, tk, tv, cur, **jkw, page_table=tab, **paged, k_scale=ks,
            v_scale=vs)
        ckw = dict(kw, d=DIM) if exact else dict(kw, d=16, local_window=8)
        cluster = fused_decode.fused_cluster_plain(
            q, tk, tv, cur, **ckw, n_cta=3, page_table=tab, **paged,
            k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cluster.numpy(), np.asarray(want), **TOL)


def test_scaled_stage_geometry():
    """One-byte (scaled) storage streams through the narrow attention body:
    at int8:pca:r=32 a stage holds 32 tokens (K rows of 3 16-byte pieces,
    V rows of 128 B) and then the page's K and V scales (16 B); the score
    ring keeps its layout (the block's scale rides in row 0's padding)."""
    stage = 32 * (48 + 128) + 16
    assert tuning.split_stage_bytes(kdim=32, dim=128, storage="int8") == \
        stage
    assert tuning.split_stage_bytes(kdim=128, dim=128,
                                    storage="bfloat16") == 4 * 256 * 2
    assert tuning.full_smem_bytes(g=1, kdim=32, dim=128, storage="int8") == \
        128 + 4 * 2 * stage
    assert tuning.attend_smem_bytes(n_sel=8, g=1, kdim=32, dim=128,
                                    storage="int8") == 128 + 32 + 4 * 2 * stage
    assert tuning.score_tokens(d=32, bs=128, itemsize=1) == (32, 48)
    # the fused kernels: the attention ring is now the largest use of the
    # shared region, above the score ring (32 tokens of 48 B a stage)
    assert tuning.fused_smem_bytes(nb=32, k_blocks=8, g=1, kdim=32, dim=128,
                                   bs=128, d=32, storage="int8") == \
        128 + 128 + 32 + 64 + 4 * 2 * stage


# ------------------------------------------------------- the model

PSZ, CHUNK = 16, 16
TABLES = np.array([[5, 2, 9, 1, 7, 3], [8, 11, 4, 10, 6, 12],
                   [0, 0, 0, 0, 0, 0]], np.int32)      # row 2: idle slot
PROMPTS = (21, 30)
LAYOUT_CASES = [(lay, pol) for lay in ("int8:pca:r=16", "fp8", "fp16:pca",
                                       "bf16")
                for pol in ("loki_block", "full", "exact_topk")]


def _model(policy, layout):
    kw = dict(k_f=0.25, d_f=0.25, block_size=8, local_window=4, min_k=4)
    jcfg, cfg = jget_smoke("llama2-7b"), get_smoke_config("llama2-7b")
    if policy != "full":
        jcfg, cfg = (c.with_policy(policy, **kw) for c in (jcfg, cfg))
    jcfg, cfg = (c.replace(loki=dataclasses.replace(
        c.loki, block_size=8, backend="pallas")).with_layout(layout)
        for c in (jcfg, cfg))
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


def _sync(tcache, jcache):
    """Copy JAX's pools and scales into the port's, bit for bit."""
    for name, t in tcache["layers"]["attn"].items():
        a = np.asarray(jcache["layers"]["attn"][name])
        if t.element_size() == 1 or t.dtype == torch.bfloat16:
            view = torch.uint8 if t.element_size() == 1 else torch.int16
            t.view(view).copy_(torch.from_numpy(a.view(
                np.uint8 if t.element_size() == 1 else np.int16).copy()))
        else:
            t.copy_(torch.from_numpy(a.copy()))


#: one code step of a storage, relative to the code's magnitude (the
#: float storages: an ulp is at most |x| * 2**-mantissa bits) and its least
#: step (fp8's subnormal step); int8 steps by 1
CODE_STEP = {"fp8": (2.0 ** -3, 2.0 ** -9), "fp16": (2.0 ** -10, 2.0 ** -24),
             "bf16": (2.0 ** -7, 2.0 ** -126)}


def _check_writes(tcache, jcache, layout, written):
    """The pools the port's model path wrote (PCA rotation, rank cut,
    whole-page re-quantization) against the reference's, dequantized
    through both packages' ``gather_logical_dq``: each slot's first
    ``written[b]`` positions, per layer, within one code step at the
    page's scale (the keys feeding the two writers differ in their last
    float32 bits, so a value on a rounding boundary rounds apart) plus
    what the two page scales' own difference moves the largest code by;
    the scales themselves at TOL. fp16 pools also take 2**-11 of their
    largest value (their chunk's attention weights round to fp16)."""
    dt = layout.split(":")[0]
    tab = TABLES[:len(written)]
    mask = np.arange(tab.shape[1] * PSZ)[None, :] < np.asarray(written)[:, None]
    tatt, jatt = tcache["layers"]["attn"], jcache["layers"]["attn"]
    for kind in ("k", "v"):
        tsc, jsc = tatt.get(f"{kind}_scale"), jatt.get(f"{kind}_scale")
        for layer in range(tatt[kind].shape[0]):
            ts = None if tsc is None else tsc[layer]
            js = None if jsc is None else jsc[layer]
            got = PC.gather_logical_dq(tatt[kind][layer], ts,
                                       torch.from_numpy(tab), PSZ)
            got = got.float().numpy()[mask]
            want = np.asarray(JPC.gather_logical_dq(
                jatt[kind][layer], js, jnp.asarray(tab), PSZ),
                np.float32)[mask]
            if js is None:
                rel, least = CODE_STEP[dt]
                tol = np.maximum(np.abs(want) * rel, least)
            else:
                s_j = np.asarray(JPC.gather_scales(js, jnp.asarray(tab),
                                                   PSZ))[mask][:, None, None]
                s_t = PC.gather_scales(ts, torch.from_numpy(tab),
                                       PSZ).numpy()[mask][:, None, None]
                np.testing.assert_allclose(s_t, s_j, **TOL)
                code = np.abs(want) / s_j
                step = (np.ones_like(code) if dt == "int8" else
                        np.maximum(code * CODE_STEP[dt][0], CODE_STEP[dt][1]))
                tol = (step * np.maximum(s_t, s_j)
                       + QMAX[dt] * np.abs(s_t - s_j))
            if dt == "fp16":
                # a chunk's fp16 attention weights round apart upstream (the
                # chunk logits' 2**-11, test below): one such rounding of
                # the layer's largest value moves every later layer's rows
                tol = tol + 2.0 ** -11 * np.abs(want).max()
            bad = np.abs(got - want) > tol
            assert not bad.any(), (
                f"{kind} pool, layer {layer}: {int(bad.sum())} of {bad.size} "
                f"written values differ by more than one code step (max "
                f"|d| {float(np.abs(got - want).max()):.3e})")


@pytest.mark.parametrize("layout,policy", LAYOUT_CASES)
def test_paged_layout_logits_match_jax(layout, policy):
    """Two prompts prefilled chunk by chunk into shuffled pages at the
    layout, then a batched decode step with an idle slot on the trash
    page: logits of the live rows vs ``repro.models.lm`` (jitted, its
    Pallas kernels in interpret mode), and after each call the pools each
    package wrote, within one code step (``_check_writes``). Each call
    starts from JAX's pools, copied bit for bit: the two packages' keys
    differ in their last float32 bits (RMSNorm and the projections sum in
    other orders), and storage rounding (a page re-quantized at a new
    scale, a bf16 row) would let such a difference flip a stored code and
    carry it into every later step. A prefill chunk at fp16 storage rounds
    its attention weights to fp16 before p·V, as the reference does, so a
    float32 weight within an ulp of an fp16 rounding boundary rounds apart
    in the two packages: its chunk logits are held to one fp16 ulp
    (2**-11) instead."""
    jcfg, cfg, params, tparams = _model(policy, layout)
    n_pages = int(TABLES.max()) + 1
    jcache = jlm.init_paged_cache(jcfg, n_pages, PSZ, jnp.float32)
    tcache = lm.init_paged_cache(cfg, n_pages, PSZ, device="cpu")
    for name, t in tcache["layers"]["attn"].items():
        assert t.shape == jcache["layers"]["attn"][name].shape
        assert str(t.dtype).split(".")[-1] == \
            str(jcache["layers"]["attn"][name].dtype)
    jprefill = jax.jit(functools.partial(jlm.prefill_chunk, cfg=jcfg,
                                         page_size=PSZ))
    jdecode = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                        page_size=PSZ))
    chunk_tol = (dict(rtol=2 ** -11, atol=2 ** -11)
                 if layout.startswith("fp16") else TOL)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32)
               for n in PROMPTS]
    written = [0, 0]
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt) - 1, CHUNK):
            nv = min(CHUNK, len(prompt) - 1 - start)
            chunk = np.zeros((1, CHUNK), np.int32)
            chunk[0, :nv] = prompt[start:start + nv]
            _sync(tcache, jcache)
            jl, jcache = jprefill(
                params, cache=jcache, tokens=jnp.asarray(chunk),
                pos_start=jnp.int32(start), n_valid=jnp.int32(nv),
                page_table=jnp.asarray(TABLES[slot:slot + 1]))
            tl, tcache = lm.prefill_chunk(
                tparams, cfg, tcache, torch.from_numpy(chunk), start, nv,
                torch.from_numpy(TABLES[slot:slot + 1]), PSZ)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **chunk_tol)
            written[slot] = start + nv
            _check_writes(tcache, jcache, layout, written)
    tok = np.array([p[-1] for p in prompts] + [0], np.int32)
    pos = np.array([len(p) - 1 for p in prompts] + [0], np.int32)
    _sync(tcache, jcache)
    jl, jcache = jdecode(params, cache=jcache, token=jnp.asarray(tok),
                         pos_len=jnp.asarray(pos),
                         page_table=jnp.asarray(TABLES))
    tl, tcache = lm.decode_step(tparams, cfg, tcache, torch.from_numpy(tok),
                                torch.from_numpy(pos),
                                page_table=torch.from_numpy(TABLES),
                                page_size=PSZ)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
    _check_writes(tcache, jcache, layout, [len(p) for p in prompts])


def test_paged_engine_serves_a_quantized_latent_layout():
    """The paged engine at int8:pca:r=16 under loki_block: four requests
    through a pool too small for all at once finish, one host sync per
    decode step, the pool freed and its stats naming the layout."""
    _, cfg, _, tparams = _model("loki_block", "int8:pca:r=16")
    eng = PagedServingEngine(tparams, cfg, n_slots=2, smax=32, page_size=8,
                             prefill_chunk=8, n_pages=7, device="cpu")
    assert eng.cache["layers"]["attn"]["k"].dtype == torch.int8
    assert eng.cache["layers"]["attn"]["k"].shape[-1] == 16
    rng = np.random.RandomState(2)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab, size=n).astype(
        np.int32), max_new=6) for i, n in enumerate((9, 14, 5, 11))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done and len(r.out) == 6 for r in reqs)
    st = eng.stats()
    assert st["n_host_syncs"] == st["n_decode_steps"] > 0
    assert st["layout"] == "int8:pca:r=16"
    assert st["bytes_per_page"] == 8 * cfg.n_kv_heads * (16 + 32)
    assert eng.pool.free_pages == eng.pool.n_pages - 1
    assert not eng.page_table.any()
