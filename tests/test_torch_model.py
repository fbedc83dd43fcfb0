"""The port's dense model against the JAX package's, on the same weights.

JAX initialises the smoke model, calibrates and installs its PCA
projections; the port takes the same tree through numpy
(``models.convert.params_from_numpy``). Logits of ``forward``, ``prefill``
and four ``decode_step``s then meet across the packages with the
``loki_block`` policy, the kernel backend (JAX: Pallas in interpret mode;
port: the kernels' plain versions on CPU) and the ``xla`` backend each.
Tolerance 2e-5, the kernels' own: two float32 frameworks summing in
different orders through two layers, the unembedding and a softmax over
selected blocks stay within it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import pca as jpca
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.core import pca
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
SMAX = 256
LOKI = dict(k_f=0.25, d_f=0.25, block_size=32)


def _setup(arch):
    jcfg = jget_smoke(arch).with_policy("loki_block", **LOKI)
    cfg = get_smoke_config(arch).with_policy("loki_block", **LOKI)
    params = jlm.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, jcfg.vocab, size=(2, 48)).astype(np.int32)
               for _ in range(2)]
    calib = jpca.calibrate_model(params, jcfg,
                                 [jnp.asarray(b) for b in batches])
    params = jpca.install_projections(params, calib, "pre")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    return jcfg, cfg, params, tparams, batches, calib


def _with_backend(cfg, backend):
    return cfg.replace(loki=dataclasses.replace(cfg.loki, backend=backend))


@pytest.fixture(scope="module", params=["llama2-7b", "qwen2.5-3b"])
def model(request):
    return _setup(request.param)


def test_forward_and_pca_calibration(model):
    jcfg, cfg, params, tparams, batches, calib = model
    toks = np.random.RandomState(2).randint(0, cfg.vocab, size=(2, 24))
    want, _ = jlm.forward(params, jnp.asarray(toks), jcfg)
    got, _ = lm.forward(tparams, torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port's own calibration from its captured keys: same spectra
    mine = pca.calibrate_model(tparams, cfg, batches)
    np.testing.assert_allclose(mine.eig_pre, calib.eig_pre, atol=1e-5)
    np.testing.assert_allclose(mine.eig_post, calib.eig_post, atol=1e-5)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_prefill_and_decode_steps(model, backend):
    jcfg, cfg, params, tparams, _, _ = model
    jcfg = _with_backend(jcfg, backend)
    cfg = _with_backend(cfg, backend)
    toks = np.random.RandomState(3).randint(0, cfg.vocab, size=(2, 150))
    jl, jcache, jpos = jlm.prefill(params, jcfg, jnp.asarray(toks), SMAX,
                                   cache_dtype=jnp.float32)
    tl, tcache, tpos = lm.prefill(tparams, cfg, torch.as_tensor(toks), SMAX,
                                  cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jlm.decode_step(params, jcfg, jcache, jnp.asarray(tok),
                                     jpos)
        tl, tcache = lm.decode_step(tparams, cfg, tcache,
                                    torch.as_tensor(tok), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(
        tcache["layers"]["attn"]["k"].numpy(),
        np.asarray(jcache["layers"]["attn"]["k"]), **TOL)


def test_unported_families_and_policies_raise():
    """What is still refused: a policy the reference does not have. Every
    family is served now: the MoE family (mixtral, granite), the
    encoder-decoder (whisper), the vlm (llava), the hybrid (hymba) and the
    recurrent ssm family (xlstm, its heterogeneous layers a list), and the
    pcaattn and h2o policies (tests/test_torch_moe.py,
    tests/test_torch_families.py, tests/test_torch_recurrent.py,
    tests/test_torch_policies.py)."""
    for arch in ("hymba-1.5b", "xlstm-125m", "whisper-small",
                 "llava-next-mistral-7b"):
        c = get_smoke_config(arch)
        params = lm.init(c, device="cpu")
        assert isinstance(params["layers"], list) == (c.family == "ssm")
        lm.init_cache(c, 1, 32, device="cpu")
    cfg = get_smoke_config("llama2-7b")
    for policy in ("pcaattn", "h2o"):
        lm.init_cache(cfg.with_policy(policy), 1, 32, device="cpu")
    lm.init(get_smoke_config("mixtral-8x22b"), device="cpu")
    with pytest.raises(ValueError, match="serves"):
        lm.init_cache(cfg.with_policy("sparse"), 1, 32, device="cpu")


def test_full_policy_is_plain_only(model):
    """``full`` over the contiguous cache: backend="xla" runs the plain
    ``decode_full``; the kernel backend now runs paged_full_decode (its
    plain version on CPU), which computes the same function."""
    _, cfg, _, tparams, _, _ = model
    full = cfg.with_policy("full")
    toks = torch.arange(1, 40).reshape(1, -1) % cfg.vocab
    tok = torch.tensor([1])
    logits = {}
    for backend in ("xla", "pallas"):
        _, cache, pos = lm.prefill(tparams, full, toks, 64,
                                   cache_dtype=torch.float32)
        logits[backend], _ = lm.decode_step(
            tparams, _with_backend(full, backend), cache, tok, pos)
    np.testing.assert_allclose(logits["pallas"].numpy(),
                               logits["xla"].numpy(), **TOL)
