"""The port's recurrent-state families against the JAX package's, on CPU:
hymba (hybrid: attention beside mamba) and xlstm (ssm: mLSTM and sLSTM
blocks, no attention).

The blocks (``_mamba_scan``, the chunked mamba prefill, ``mlstm_train``
with a carried state and a padded tail, ``slstm_train``, the three
decodes) and the model entry points (``forward``, ``prefill``,
``prefill_chunk`` chunk by chunk, ``decode_step(live=)`` with a dead slot)
meet JAX's on the same smoke weights (JAX's ``lm.init`` handed over
through numpy by ``params_from_numpy``), rtol = atol = 2e-5 at float32;
the kernels' plain versions stand in for the CUDA kernels (JAX: Pallas in
interpret mode). The private entries of the page pool follow JAX's
``PagePool`` on one script. The port's engines are held against the
port's own sequential dense decode, greedy token for token, never against
a JAX engine (they race on host arrays they update in place): the paged
engine per family and policy, packed against masked decode, the snapshot
restores after priority and mid-prefill preemption (hymba's retained
pages among them), the tier against a single tier, and a slot reused
after a finished request.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import blocks as JB
from repro.models import lm as jlm
from repro.serving import cache_spec as JCS
from repro.serving import paged_cache as JPC
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import cache_spec as CS
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import PagedServingEngine

TOL = dict(rtol=2e-5, atol=2e-5)
KW = dict(k_f=0.25, d_f=0.5, block_size=8, local_window=4, min_k=4)
PS = 8
HYMBA, XLSTM = "hymba-1.5b", "xlstm-125m"


def _cfgs(arch, policy="full"):
    """The same smoke config in both packages at ``policy`` (block size
    8), the port's plain kernels against JAX's Pallas in interpret
    mode."""
    out = []
    for c in (jget_smoke(arch), get_smoke_config(arch)):
        if policy != "full":
            c = c.with_policy(policy, **KW)
        out.append(c.replace(loki=dataclasses.replace(
            c.loki, block_size=8, backend="pallas")))
    return out


_PARAMS = {}


def _params(arch, cfg):
    """JAX's smoke weights (a random orthogonal PCA basis per layer and kv
    head for hymba) and the port's copy of them."""
    if arch not in _PARAMS:
        jcfg = jget_smoke(arch)
        params = jlm.init(jax.random.PRNGKey(0), jcfg)
        if arch == HYMBA:
            rng = np.random.RandomState(4)
            hd = jcfg.resolved_head_dim
            pca = np.stack([[np.linalg.qr(rng.randn(hd, hd))[0]
                             for _ in range(jcfg.n_kv_heads)]
                            for _ in range(jcfg.n_layers)])
            params["layers"]["attn"]["pca"] = jnp.asarray(pca, jnp.float32)
        _PARAMS[arch] = (params, jax.tree.map(np.asarray, params))
    params, host = _PARAMS[arch]
    return params, params_from_numpy(host, cfg, device="cpu")


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def _close_tree(t, j):
    """Every leaf of the port's tree against the JAX tree's (lists or
    dicts of tensors, the same keys)."""
    if isinstance(j, dict):
        assert sorted(t) == sorted(j)
        for k in j:
            _close_tree(t[k], j[k])
    elif isinstance(j, list):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _close_tree(a, b)
    else:
        _close(t.numpy(), j)


def _layer(params, tparams, i):
    """Layer i's parameters in both packages."""
    if isinstance(params["layers"], list):
        return params["layers"][i], tparams["layers"][i]
    return (jax.tree.map(lambda a: a[i], params["layers"]),
            lm.layer_params(tparams, i))


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ------------------------------------------------------------ the blocks

@pytest.mark.parametrize("n_valid", [None, 5])
def test_mamba_scan_matches_jax(n_valid):
    """``_mamba_scan`` from a random carried conv window and state: the
    outputs, the new window (ending at the n_valid-th token) and the
    float32 state."""
    jcfg, cfg = _cfgs(HYMBA)
    params, tparams = _params(HYMBA, cfg)
    jp, tp = _layer(params, tparams, 1)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    xz = _rand((2, 9, 2 * d_in), 1)
    conv = _rand((2, s.conv_width - 1, d_in), 2)
    st = _rand((2, d_in, s.state_dim), 3, 0.5)
    jy, jc, js = JB._mamba_scan(jp["ssm"], jnp.asarray(xz), jnp.asarray(conv),
                                jnp.asarray(st), jcfg, n_valid=n_valid)
    ty, tc, ts = B._mamba_scan(tp["ssm"], torch.from_numpy(xz),
                               torch.from_numpy(conv), torch.from_numpy(st),
                               cfg, n_valid=n_valid)
    for t, j in ((ty, jy), (tc, jc), (ts, js)):
        _close(t.numpy(), j)


def test_mamba_prefill_chunks_match_jax_and_the_one_shot_state():
    """Three 8-token chunks of a 21-token prompt, the last padded: each
    chunk's output and carried state against JAX's
    ``mamba_prefill_chunk``, and the final state against the one-shot
    prefill's."""
    jcfg, cfg = _cfgs(HYMBA)
    params, tparams = _params(HYMBA, cfg)
    jp, tp = _layer(params, tparams, 0)
    x = _rand((1, 24, cfg.d_model), 5)
    x[:, 21:] = 0.0
    jst = JB.init_mamba_cache(jcfg, 1, jnp.float32)
    tst = B.init_mamba_cache(cfg, 1, torch.float32, "cpu")
    for c0 in range(0, 24, 8):
        nv = min(8, 21 - c0)
        jy, jst = JB.mamba_prefill_chunk(jp["ssm"], jst,
                                         jnp.asarray(x[:, c0:c0 + 8]), nv,
                                         jcfg)
        ty, tst = B.mamba_prefill_chunk(tp["ssm"], tst,
                                        torch.from_numpy(x[:, c0:c0 + 8]),
                                        nv, cfg)
        _close(ty[:, :nv].numpy(), jy[:, :nv])
        _close_tree(tst, jst)
    _, one = B.mamba_prefill(tp["ssm"], torch.from_numpy(x[:, :21]), cfg)
    _close_tree(tst, {k: np.asarray(v) for k, v in one.items()})


@pytest.mark.parametrize("s,n_valid,carried", [(12, None, False),
                                               (12, 7, True),
                                               (512, 300, True)])
def test_mlstm_train_matches_jax(s, n_valid, carried):
    """Chunkwise mLSTM: one chunk, a padded tail from a carried state,
    and two 256-token chunks (``MLSTM_CHUNK``) with a padded tail; the
    outputs of the valid positions and the final {C, n, m}."""
    jcfg, cfg = _cfgs(XLSTM)
    params, tparams = _params(XLSTM, cfg)
    jp, tp = _layer(params, tparams, 0)
    assert CS.layer_kind(cfg, 0) == "mlstm"
    x = _rand((2, s, cfg.d_model), 6)
    init = None
    if carried:
        nh, dh = cfg.ssm.n_heads, cfg.d_model // cfg.ssm.n_heads
        init = {"C": _rand((2, nh, dh, dh), 7, 0.3),
                "n": _rand((2, nh, dh), 8, 0.3),
                "m": _rand((2, nh), 9)}
    jy, jst = JB.mlstm_train(
        jp["ssm"], jnp.asarray(x), jcfg, return_state=True,
        initial_state=None if init is None else jax.tree.map(jnp.asarray,
                                                             init),
        n_valid=n_valid)
    ty, tst = B.mlstm_train(
        tp["ssm"], torch.from_numpy(x), cfg, return_state=True,
        initial_state=None if init is None else {
            k: torch.from_numpy(v) for k, v in init.items()},
        n_valid=n_valid)
    nv = s if n_valid is None else n_valid
    _close(ty[:, :nv].numpy(), jy[:, :nv])
    _close_tree(tst, jst)


@pytest.mark.parametrize("n_valid", [None, 6])
def test_slstm_train_matches_jax(n_valid):
    """The sLSTM recurrence from a carried state, with and without a
    padded tail: every output and the final {c, n, h, m}."""
    jcfg, cfg = _cfgs(XLSTM)
    params, tparams = _params(XLSTM, cfg)
    jp, tp = _layer(params, tparams, 1)
    assert CS.layer_kind(cfg, 1) == "slstm"
    x = _rand((2, 10, cfg.d_model), 10)
    init = {k: _rand((2, cfg.d_model), 11 + i, 0.5)
            for i, k in enumerate(("c", "n", "h", "m"))}
    init["n"] = np.abs(init["n"]) + 1.0
    jy, jst = JB.slstm_train(jp["ssm"], jnp.asarray(x), jcfg,
                             return_state=True,
                             initial_state=jax.tree.map(jnp.asarray, init),
                             n_valid=n_valid)
    ty, tst = B.slstm_train(tp["ssm"], torch.from_numpy(x), cfg,
                            return_state=True,
                            initial_state={k: torch.from_numpy(v)
                                           for k, v in init.items()},
                            n_valid=n_valid)
    _close(ty.numpy(), jy)
    _close_tree(tst, jst)


@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_block_decodes_match_jax(block):
    """Three decode tokens of each block from a prefilled state."""
    arch, i = {"mamba": (HYMBA, 0), "mlstm": (XLSTM, 0),
               "slstm": (XLSTM, 1)}[block]
    jcfg, cfg = _cfgs(arch)
    params, tparams = _params(arch, cfg)
    jp, tp = _layer(params, tparams, i)
    x = _rand((3, 6, cfg.d_model), 20)
    if block == "mamba":
        _, jst = jlm._mamba_prefill(jp["ssm"], jnp.asarray(x), jcfg)
        jst = {"conv": jst["conv"].astype(jnp.float32), "ssm": jst["ssm"]}
        jfn, tfn = JB.mamba_decode, B.mamba_decode
    else:
        jtrain = JB.mlstm_train if block == "mlstm" else JB.slstm_train
        _, jst = jtrain(jp["ssm"], jnp.asarray(x), jcfg, return_state=True)
        jfn = JB.mlstm_decode if block == "mlstm" else JB.slstm_decode
        tfn = B.mlstm_decode if block == "mlstm" else B.slstm_decode
    tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    for t in range(3):
        xt = _rand((3, cfg.d_model), 30 + t)
        jy, jst = jfn(jp["ssm"], jst, jnp.asarray(xt), jcfg)
        ty, tst = tfn(tp["ssm"], tst, torch.from_numpy(xt), cfg)
        _close(ty.numpy(), jy)
        _close_tree(tst, jst)


# ------------------------------------------------------- lm against JAX

@pytest.mark.parametrize("arch", [HYMBA, XLSTM])
def test_forward_matches_jax(arch):
    """The teacher-forced forward; hymba's captured keys (what
    ``core/pca.calibrate_model`` reads) too, xlstm capturing none."""
    jcfg, cfg = _cfgs(arch)
    params, tparams = _params(arch, cfg)
    toks = np.random.RandomState(5).randint(0, cfg.vocab, (2, 13))
    jl, _, jcap = jlm.forward(params, jnp.asarray(toks), jcfg,
                              capture_keys=True)
    tl, _, tcap = lm.forward(tparams, torch.as_tensor(toks), cfg,
                             capture_keys=True)
    _close(tl.numpy(), jl)
    for t, j in zip(tcap, jcap):
        if j is None:
            assert t is None
        else:
            _close(t.numpy(), j)


@pytest.mark.parametrize("arch,policy", [(HYMBA, "full"),
                                         (HYMBA, "loki_block"),
                                         (XLSTM, "full")])
def test_prefill_and_decode_match_jax(arch, policy):
    """The one-shot prefill (the recurrent state its final carry) and
    four decode steps over the dense cache: logits and cache."""
    jcfg, cfg = _cfgs(arch, policy)
    params, tparams = _params(arch, cfg)
    toks = np.random.RandomState(6).randint(0, cfg.vocab, (2, 21))
    jl, jc, jpos = jlm.prefill(params, jcfg, jnp.asarray(toks), 32,
                               cache_dtype=jnp.float32)
    tl, tc, tpos = lm.prefill(tparams, cfg, torch.as_tensor(toks), 32,
                              cache_dtype=torch.float32)
    _close(tl.numpy(), jl)
    _close_tree(tc["layers"], jc["layers"])
    step = _jit(jlm.decode_step, cfg=jcfg)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = step(params, cache=jc, token=jnp.asarray(tok),
                      pos_len=jpos)
        tl, tc = lm.decode_step(tparams, cfg, tc, torch.as_tensor(tok),
                                tpos)
        jpos, tpos = jpos + 1, tpos + 1
        _close(tl.numpy(), jl)
    _close_tree(tc["layers"], jc["layers"])


def _tree_np(t):
    return lm.tree_map(lambda a: a.numpy().copy(), t)


def _close_paged(t, j):
    """A paged cache's layers against JAX's, the trash page's rows (where
    both write their pad and dead rows, in no set order) left out."""
    if isinstance(j, list):
        for a, b in zip(t, j):
            _close_paged(a, b)
        return
    for k in j:
        if k == "attn":
            for n in j[k]:
                _close(t[k][n].numpy()[:, PS:], np.asarray(j[k][n])[:, PS:])
        else:
            _close_tree(t[k], j[k])


@pytest.mark.parametrize("arch,policy", [(HYMBA, "full"),
                                         (HYMBA, "loki_block"),
                                         (XLSTM, "full")])
def test_prefill_chunk_and_live_decode_match_jax(arch, policy):
    """Two prompts prefilled chunk by chunk into slots 0 and 2 of a
    three-slot paged cache (the last chunk padded), then three paged
    decode steps with ``live`` marking slot 1 dead: logits of the live
    rows and every cache leaf against JAX's, and the dead slot's state
    exactly as it was."""
    jcfg, cfg = _cfgs(arch, policy)
    params, tparams = _params(arch, cfg)
    n_pages, mp, c = 16, 6, 8
    jc = jlm.init_paged_cache(jcfg, n_pages, PS, jnp.float32, n_slots=3)
    tc = lm.init_paged_cache(cfg, n_pages, PS, torch.float32, n_slots=3,
                             device="cpu")
    table = np.zeros((3, mp), np.int32)
    table[0, :4] = [3, 7, 1, 9]
    table[2, :4] = [2, 12, 5, 14]
    chunk = _jit(jlm.prefill_chunk, cfg=jcfg, page_size=PS)
    rng = np.random.RandomState(7)
    lens = {0: 19, 2: 26}
    for slot, n in lens.items():
        toks = rng.randint(0, cfg.vocab, n).astype(np.int32)
        for c0 in range(0, n, c):
            nv = min(c, n - c0)
            buf = np.zeros((1, c), np.int32)
            buf[0, :nv] = toks[c0:c0 + nv]
            jl, jc = chunk(params, cache=jc, tokens=jnp.asarray(buf),
                           pos_start=c0, n_valid=nv,
                           page_table=jnp.asarray(table[slot:slot + 1]),
                           slot=slot)
            tl, tc = lm.prefill_chunk(tparams, cfg, tc, torch.as_tensor(buf),
                                      c0, nv,
                                      torch.as_tensor(table[slot:slot + 1]),
                                      PS, slot=slot)
            _close(tl.numpy(), jl)
    _close_paged(tc["layers"], jc["layers"])
    dead = [{k: v[1].numpy().copy()
             for k, v in lm.state_cache(tc, i).items()}
            for i in range(cfg.n_layers)]
    live = np.array([True, False, True])
    pos = np.array([lens[0], 0, lens[2]], np.int32)
    tok = np.array([5, 0, 9], np.int32)
    pt = table * live[:, None]
    step = _jit(jlm.decode_step, cfg=jcfg, page_size=PS)
    for _ in range(3):
        jl, jc = step(params, cache=jc, token=jnp.asarray(tok),
                      pos_len=jnp.asarray(pos), page_table=jnp.asarray(pt),
                      live=jnp.asarray(live))
        tl, tc = lm.decode_step(tparams, cfg, tc, torch.as_tensor(tok),
                                torch.as_tensor(pos),
                                page_table=torch.as_tensor(pt), page_size=PS,
                                live=torch.as_tensor(live))
        _close(tl.numpy()[live], np.asarray(jl)[live])
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32) * live
        pos = pos + live
    _close_paged(tc["layers"], jc["layers"])
    for i in range(cfg.n_layers):
        for k, v in lm.state_cache(tc, i).items():
            assert np.array_equal(v[1].numpy(), dead[i][k]), (i, k)


def _bf16(arch):
    """The smoke configs at float32 and bf16 compute in both packages,
    JAX's float32 weights and the port's copy of them cast to bf16."""
    jcfg32, cfg32 = _cfgs(arch)
    jcfg = dataclasses.replace(jcfg32, dtype="bfloat16")
    cfg = dataclasses.replace(cfg32, dtype="bfloat16")
    params, _ = _params(arch, cfg32)
    return jcfg32, jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def _block_run(pkg, block, p, cfg, x, xs, dtype):
    """A block over a 12-token input with a padded tail (n_valid 9) from a
    fresh state, then three decode tokens: (outputs, final state). JAX's
    calls are jitted."""
    jx = pkg is JB
    cast = ((lambda a: jnp.asarray(a, dtype)) if jx
            else (lambda a: torch.from_numpy(a).to(dtype)))
    wrap = (lambda fn, **kw: _jit(fn, cfg=cfg, **kw)) if jx else (
        lambda fn, **kw: functools.partial(fn, cfg=cfg, **kw))
    if block == "mamba":
        st = (JB.init_mamba_cache(cfg, 2, jnp.float32) if jx
              else B.init_mamba_cache(cfg, 2, torch.float32, "cpu"))
        y, st = wrap(pkg.mamba_prefill_chunk)(p, st, cast(x), 9)
    else:
        train = pkg.mlstm_train if block == "mlstm" else pkg.slstm_train
        y, st = wrap(train, return_state=True, n_valid=9)(p, cast(x))
    step = wrap(getattr(pkg, f"{block}_decode"))
    ys = [y[:, :9]]
    for xt in xs:
        y, st = step(p, st, cast(xt))
        ys.append(y)
    return ys, st


def _lm_run(pkg, params, cfg, cache, toks, table):
    """``prefill_chunk`` over a 19-token prompt in chunks of 8 (the last
    padded) into slot 0 of a one-slot paged cache, then three paged
    ``decode_step``s with ``live``: the logits of every call. JAX's calls
    are jitted."""
    if pkg is jlm:
        arr = jnp.asarray
        chunk = _jit(jlm.prefill_chunk, cfg=cfg, page_size=PS)
        step = _jit(jlm.decode_step, cfg=cfg, page_size=PS)
    else:
        arr = torch.as_tensor
        chunk = functools.partial(lm.prefill_chunk, cfg=cfg, page_size=PS)
        step = functools.partial(lm.decode_step, cfg=cfg, page_size=PS)
    out = []
    for c0 in range(0, len(toks), 8):
        nv = min(8, len(toks) - c0)
        buf = np.zeros((1, 8), np.int32)
        buf[0, :nv] = toks[c0:c0 + nv]
        lg, cache = chunk(params, cache=cache, tokens=arr(buf), pos_start=c0,
                          n_valid=nv, page_table=arr(table), slot=0)
        out.append(lg)
    pos, tok = np.array([len(toks)], np.int32), np.array([5], np.int32)
    for _ in range(3):
        lg, cache = step(params, cache=cache, token=arr(tok),
                         pos_len=arr(pos), page_table=arr(table),
                         live=arr(np.ones(1, bool)))
        out.append(lg)
        pos, tok = pos + 1, (tok * 7 + 3) % cfg.vocab
    return out


def _np32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a, jnp.float32)))


def _bf16_close(name, t, j16, j32):
    """The port's bf16 result against JAX's. The two packages round bf16
    differently (XLA keeps excess precision across fused elementwise ops,
    torch rounds each op), so they differ by about as much as JAX's bf16
    differs from its float32: mean |port - JAX bf16| <= 1.5 x mean |JAX
    bf16 - JAX float32| (worst reading 1.13, hymba's logits), and max
    |port - JAX bf16| <= 3e-2 of max |JAX bf16| (worst reading 2.4e-2,
    hymba's first chunk's logits; my CPU runs)."""
    t, j16, j32 = _np32(t), _np32(j16), _np32(j32)
    d = np.abs(t - j16)
    gap = np.abs(j16 - j32).mean()
    assert d.mean() <= 1.5 * gap, (name, d.mean(), gap)
    assert d.max() <= 3e-2 * np.abs(j16).max(), (name, d.max())


#: what the two packages compute alike at bf16 compute (my CPU readings:
#: the sLSTM block's outputs bit-equal and its float32 states within
#: 2.6e-7 relative, mLSTM's stabiliser m within 8.8e-7 relative, mamba's
#: conv window bit-equal), held at the float32 tolerance TOL; the rest at
#: ``_bf16_close``'s bounds
BF16_EXACT = {("mlstm", "m"), ("mamba", "conv")}


@pytest.mark.parametrize("case", ["mamba", "mlstm", "slstm", HYMBA])
def test_bf16_matches_jax(case):
    """bf16 compute (``dataclasses.replace(cfg, dtype="bfloat16")`` on both
    sides, float32 weights cast at use in JAX and once in the port): the
    mamba, mLSTM and sLSTM blocks (a padded chunk, then three decodes)
    and hymba's paged ``prefill_chunk`` chunk by chunk, then three
    ``decode_step(live=)``s, over bf16 pools (JAX's chunk keeps its
    carry's dtype only over a pool of the compute dtype). Outputs are
    bf16 in both and every recurrent state keeps JAX's dtype (float32 but
    mamba's conv window, bf16 as the activations). What both compute
    alike (the sLSTM block, mLSTM's stabiliser, mamba's conv window; a
    gate pre-activation rounded to bf16 moves the stabiliser by 1e-3) is
    held at TOL, the rest within ``_bf16_close``'s bounds of JAX's bf16
    run: there a rounding moved within the mamba scan (its float32 state
    rounded to bf16 a token) stays inside the packages' own rounding
    difference and goes unseen."""
    if case == HYMBA:
        jcfg32, jcfg, cfg, params, tparams = _bf16(case)
        toks = np.random.RandomState(7).randint(0, cfg.vocab, 19)
        table = np.zeros((1, 6), np.int32)
        table[0, :4] = [3, 7, 1, 9]
        runs = [_lm_run(jlm, params, c, jlm.init_paged_cache(
                    c, 16, PS, jnp.dtype(c.dtype), n_slots=1), toks, table)
                for c in (jcfg, jcfg32)]
        tc = lm.init_paged_cache(cfg, 16, PS, torch.bfloat16, n_slots=1,
                                 device="cpu")
        got = _lm_run(lm, tparams, cfg, tc, toks, table)
        for k, (t, j16, j32) in enumerate(zip(got, *runs)):
            _bf16_close(f"{case} call {k}", t, j16, j32)
        return
    arch, i = {"mamba": (HYMBA, 0), "mlstm": (XLSTM, 0),
               "slstm": (XLSTM, 1)}[case]
    jcfg32, jcfg, cfg, params, tparams = _bf16(arch)
    jp, tp = _layer(params, tparams, i)
    x = _rand((2, 12, cfg.d_model), 6)
    xs = [_rand((2, cfg.d_model), 30 + t) for t in range(3)]
    j16 = _block_run(JB, case, jp["ssm"], jcfg, x, xs, jnp.bfloat16)
    j32 = _block_run(JB, case, jp["ssm"], jcfg32, x, xs, jnp.float32)
    ys, st = _block_run(B, case, tp["ssm"], cfg, x, xs, torch.bfloat16)
    for k, y in enumerate(ys):
        assert y.dtype == torch.bfloat16 and j16[0][k].dtype == jnp.bfloat16
        if case == "slstm":
            _close(_np32(y), _np32(j16[0][k]))
        else:
            _bf16_close(f"{case} y{k}", y, j16[0][k], j32[0][k])
    assert sorted(st) == sorted(j16[1])
    for key, v in st.items():
        assert str(v.dtype).removeprefix("torch.") == str(j16[1][key].dtype)
        if (case, key) in BF16_EXACT or case == "slstm":
            _close(_np32(v), _np32(j16[1][key]))
        else:
            _bf16_close(f"{case} state {key}", v, j16[1][key], j32[1][key])


# ----------------------------------------------- the port's own engines

def _engine_params(arch, policy="full"):
    cfg = get_smoke_config(arch)
    cfg = cfg.with_policy(policy, **KW) if policy != "full" else cfg
    cfg = cfg.replace(loki=dataclasses.replace(cfg.loki, block_size=8,
                                               backend="pallas"))
    return lm.init(cfg, seed=2, device="cpu"), cfg


def _requests(cfg, lengths, max_new, priority=0):
    return [Request(rid=i, prompt=(np.arange(n) * 7 + 3 * i) % cfg.vocab,
                    max_new=max_new, priority=priority)
            for i, n in enumerate(lengths)]


_TRUTH = {}


def _dense_truth(params, cfg, lengths, max_new, smax=48):
    """Each prompt alone through the port's dense engine."""
    key = (cfg.arch, cfg.attn_policy(), lengths, max_new, smax)
    if key not in _TRUTH:
        outs = []
        for r in _requests(cfg, lengths, max_new):
            eng = ServingEngine(params, cfg, n_slots=1, smax=smax,
                                device="cpu")
            eng.submit(r)
            eng.run_until_done(500)
            assert r.done, r.status
            outs.append(r.out)
        _TRUTH[key] = outs
    return _TRUTH[key]


def _paged(params, cfg, **kw):
    kw = dict(dict(n_slots=2, smax=48, page_size=PS, prefill_chunk=4,
                   device="cpu", audit=True), **kw)
    return PagedServingEngine(params, cfg, **kw)


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(2000)
    return [r.out for r in reqs]


def _pool_back(eng):
    """Every page back in the pool and no private entry left."""
    pool = eng.pool
    return (pool.used_pages == 0 and pool.free_pages == pool.n_pages - 1
            and not eng._page_snap and not eng._state_snap)


LENGTHS = (11, 6, 17)


@pytest.mark.parametrize("arch,policy", [(HYMBA, "full"),
                                         (HYMBA, "loki_block"),
                                         (XLSTM, "full")])
def test_paged_engine_matches_sequential_dense(arch, policy):
    """The paged engine at its defaults (prefix caching bypassed for the
    StateSlot) against each prompt alone through the dense engine: greedy
    tokens, one host sync a decode step, every page back in the pool."""
    params, cfg = _engine_params(arch, policy)
    truth = _dense_truth(params, cfg, LENGTHS, 6)
    eng = _paged(params, cfg)
    assert not eng.prefix_caching
    assert "StateSlot" in eng.prefix_cache_reason or not eng.has_pages
    assert _drive(eng, _requests(cfg, LENGTHS, 6)) == truth
    st = eng.stats()
    assert st["n_host_syncs"] == st["n_decode_steps"] > 0
    assert _pool_back(eng)


@pytest.mark.parametrize("arch,policy", [(HYMBA, "loki_block"),
                                         (XLSTM, "full")])
def test_packed_equals_masked(arch, policy):
    """Gather-packed decode (the live slots' state gathered, advanced and
    scattered back) against full-width masked decode: the same tokens."""
    params, cfg = _engine_params(arch, policy)
    outs = {}
    for packed in (True, False):
        eng = _paged(params, cfg, n_slots=4, packed=packed)
        outs[packed] = _drive(eng, _requests(cfg, (5, 23, 9), 7))
        assert (eng.n_packed_ticks > 0) == packed
        assert _pool_back(eng)
    assert outs[True] == outs[False]


def _preempted_by_priority(arch, policy, n_ticks, lengths, chunk=4):
    """One slot: a low-priority request runs ``n_ticks`` ticks, then a
    high-priority one arrives and preempts it for the slot. Returns the
    engine and both requests' tokens."""
    params, cfg = _engine_params(arch, policy)
    eng = _paged(params, cfg, n_slots=1, policy="priority",
                 prefill_chunk=chunk)
    low, high = _requests(cfg, lengths, 6)
    high.priority = 1
    eng.submit(low)
    for _ in range(n_ticks):
        eng.tick()
    eng.submit(high)
    eng.run_until_done(2000)
    assert low.n_preempts == 1 and low.done and high.done
    return eng, [low.out, high.out], params, cfg


@pytest.mark.parametrize("arch,n_ticks", [(XLSTM, 7), (XLSTM, 2),
                                          (HYMBA, 7), (HYMBA, 2)],
                         ids=["xlstm-decode", "xlstm-mid-prefill",
                              "hymba-decode", "hymba-mid-prefill"])
def test_preemption_restores_the_snapshot(arch, n_ticks):
    """Priority preemption mid-decode (7 ticks: prefill done, a few
    tokens out) and mid-prefill (2 ticks of 4-token chunks): the state is
    snapshotted (hymba's pages retained as private entries), restored at
    re-admission without recomputing what it had folded in, and the
    tokens equal the unpreempted run's."""
    lengths = (17, 9)
    eng, outs, params, cfg = _preempted_by_priority(arch, "full", n_ticks,
                                                    lengths)
    assert outs == _dense_truth(params, cfg, lengths, 6)
    assert eng.n_state_restores == 1
    # the restored request computed its prompt once: 16 + 8 prefilled
    assert eng.n_prefill_computed_tokens == sum(n - 1 for n in lengths)
    assert _pool_back(eng)


def test_hybrid_restore_falls_back_to_recompute_when_pages_are_evicted():
    """A retained page evicted while its request waits: the restore is
    all or nothing, so the request recomputes its folded prompt from a
    fresh state, the tokens unchanged and the survivors freed."""
    params, cfg = _engine_params(HYMBA)
    eng = _paged(params, cfg, n_slots=1, policy="priority")
    low, high = _requests(cfg, (17, 9), 6)
    high.priority = 1
    eng.submit(low)
    for _ in range(7):
        eng.tick()
    eng.submit(high)
    eng.tick()                       # preempts low, admits high
    assert eng._page_snap
    keys = next(iter(eng._page_snap.values()))[1]
    eng.pool._evict_one()            # the least recently released page
    assert keys[0] not in eng.pool._index
    eng.run_until_done(2000)
    assert [low.out, high.out] == _dense_truth(params, cfg, (17, 9), 6)
    assert eng.n_state_restores == 0 and _pool_back(eng)


def test_tiered_hymba_matches_single_tier():
    """hymba under loki_block over a tiered pool at its fewest frames
    (every page but one request's off the card at times): the tokens of
    the single-tier engine, the auditor on every tick; re-run slots'
    state rewinds to the phase's snapshot."""
    params, cfg = _engine_params(HYMBA, "loki_block")
    lengths = (30, 21, 26)
    kw = dict(smax=64, prefill_chunk=PS, packed=False)
    single = _drive(_paged(params, cfg, **kw), _requests(cfg, lengths, 8))
    eng = _paged(params, cfg, device_pages=9, **kw)
    assert _drive(eng, _requests(cfg, lengths, 8)) == single
    ti = eng.stats()["tiered"]
    assert ti["n_demoted"] > 0 and ti["n_promoted"] > 0


@pytest.mark.parametrize("engine", ["paged", "dense"])
@pytest.mark.parametrize("arch", [HYMBA, XLSTM])
def test_reused_slot_carries_no_state(engine, arch):
    """One slot serving two requests in turn: the second's tokens equal
    its solo run's (its state was reset at admission, not inherited)."""
    params, cfg = _engine_params(arch)
    if engine == "paged":
        eng = _paged(params, cfg, n_slots=1)
    else:
        eng = ServingEngine(params, cfg, n_slots=1, smax=48, device="cpu")
    lengths = (13, 1)
    assert _drive(eng, _requests(cfg, lengths, 5)) == _dense_truth(
        params, cfg, lengths, 5)


# ----------------------------------------------- the pool and the specs

def test_private_entries_script_matches_jax():
    """register_private / release / match_prefix (never reaching a
    private page) / reclaim_private whole, and after an eviction (all or
    nothing: the survivors freed), on both pools: the same returns, free
    lists, holders and LRU."""
    mine, ref = PC.PagePool(8, 4), JPC.PagePool(8, 4)

    def both(fn):
        a, b = fn(mine), fn(ref)
        assert a == b, (a, b)
        assert mine.free_page_ids() == ref.free_page_ids()
        assert mine.holders() == ref.holders()
        assert mine.lru_page_ids() == ref.lru_page_ids()
        return a
    pages = both(lambda p: p.alloc(3))
    keys = both(lambda p: [p.register_private(x) for x in pages])
    assert all(mine.is_private(x) and ref.is_private(x) for x in pages)
    both(lambda p: p.release(pages))
    both(lambda p: p.match_prefix(np.arange(8, dtype=np.int32), 8))
    assert both(lambda p: p.reclaim_private(keys)) == pages
    assert not any(mine.is_registered(x) for x in pages)
    keys = both(lambda p: [p.register_private(x) for x in pages])
    both(lambda p: p.release(pages))
    both(lambda p: p.alloc(5))                 # evicts the oldest private
    assert both(lambda p: p.reclaim_private(keys)) is None
    both(lambda p: p.available_pages)
    with pytest.raises(ValueError, match="unheld"):
        mine.register_private(mine.free_page_ids()[0])


@pytest.mark.parametrize("arch", [HYMBA, XLSTM])
def test_state_helpers_match_jax(arch):
    """``fresh_state_tree`` against JAX's (shapes, dtypes, values), and a
    slot's snapshot restored over another slot's state by
    ``reset_slot_state`` bit for bit."""
    jcfg, cfg = _cfgs(arch)
    jfresh = JCS.fresh_state_tree(jcfg, jnp.float32, include_cross=False)
    fresh = CS.fresh_state_tree(cfg, torch.float32, "cpu")
    _close_tree(fresh, jfresh)
    scan = CS.uses_scan(cfg)
    cache = lm.init_paged_cache(cfg, 4, PS, torch.float32, n_slots=3,
                                device="cpu")
    layers = cache["layers"]
    gen = torch.Generator().manual_seed(0)
    lm.tree_map(lambda a: a.copy_(torch.randn(a.shape, generator=gen)),
                layers)
    snap = CS.snapshot_slot_state(layers, fresh, 2, scan)
    want = _tree_np(snap)
    CS.reset_slot_state(layers, fresh, 2, scan)
    _close_tree(CS.snapshot_slot_state(layers, fresh, 2, scan),
                _tree_np(fresh))
    CS.reset_slot_state(layers, snap, 0, scan)
    got = CS.snapshot_slot_state(layers, fresh, 0, scan)
    flat_w = [t for _, t in lm.tree_items(want)]
    flat_g = [t.numpy() for _, t in lm.tree_items(got)]
    assert all(np.array_equal(a, b) for a, b in zip(flat_w, flat_g))


@pytest.mark.parametrize("arch", [HYMBA, XLSTM])
def test_serve_launcher_runs_the_family(arch):
    """``repro_torch.launch.serve`` on the paged engine (xlstm's policy
    forced to full with the reference's note)."""
    reqs = serve.main(["--arch", arch, "--engine", "paged", "--policy",
                       "loki_block", "--requests", "2", "--max-new", "3",
                       "--smax", "64", "--device", "cpu"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
