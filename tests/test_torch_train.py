"""The port's training path against the JAX package's, on CPU.

``make_train_step`` over three steps (losses, grad norms, parameters) for
llama2-7b-smoke plain, with ``microbatch=2``, ``remat="full"`` and
``grad_compression="int8"``, and granite-moe-3b-smoke plain, from JAX's
initial parameters handed over through numpy; both again with float32
masters and bfloat16 compute (own tolerance, in that test);
``make_eval_step``;
``nan_skip`` on a poisoned batch. Port only: remat gradients bit-equal
to no remat, the checkpoint manager's behaviours (and a checkpoint of
the same train state read by the other package), restart and resume
through ``TrainRunner`` and ``run_with_restarts``, and the CLI run twice.

Tolerance: losses and grad norms rtol 1e-5. Parameters: within 1e-5 on
all but at most 1e-3 of each leaf's elements, and within 2e-4 on every
element. AdamW's first steps normalise each element's gradient (u =
g / (|g| + eps) at step 1), so where |g| is within float32 noise of zero
(measured: a first gradient of 6e-8 against a median of 3e-3) or, under
int8 compression, at a rounding boundary of its chunk, the two
packages' float32 noise moves u by O(1) and the element by a fraction of
the learning rate (Σ lr = 2.5e-3 over the three steps; worst measured
4.7e-5 plain, 8.6e-5 int8).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.training import step as jstep
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import DataConfig, SyntheticLM, torch_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.training import step as tstep
from repro_torch.training.runner import (FailureInjector, TrainRunner,
                                         run_with_restarts)

GRANITE = "granite-moe-3b-a800m"
BASE = dict(lr=1e-3, warmup_steps=2, total_steps=20, seed=0)
N_STEPS = 3


def _data(cfg):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4, seed=1))


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    params = jlm.init(jax.random.PRNGKey(0), jget_smoke(arch))
    return params, jax.tree.map(np.asarray, params)


def _port_state(arch):
    params = params_from_numpy(_jax_init(arch)[1], get_smoke_config(arch),
                               device="cpu")
    return tstep.TrainState(params, adamw.init_state(params))


@functools.lru_cache(maxsize=None)
def _jax_run(arch, extra, dtype="float32"):
    """JAX's step, jitted once per configuration, over N_STEPS batches
    from the float32 masters, computing in ``dtype``: (metrics per step,
    final params as numpy)."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    step = jax.jit(jstep.make_train_step(jcfg,
                                         JTrainConfig(**BASE, **dict(extra))))
    params = _jax_init(arch)[0]
    state = jstep.TrainState(params, jadamw.init_state(params))
    data, metrics = _data(jcfg), []
    for i in range(N_STEPS):
        state, m = step(state, jax.tree.map(jnp.asarray, data.batch_at(i)))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


def _assert_params_close(got, want):
    want = dict(lm.tree_items(want))
    for key, x in lm.tree_items(got):
        d = np.abs(x.numpy() - want[key])
        assert d.max() <= 2e-4, (key, d.max())
        assert (d > 1e-5).mean() <= 1e-3, (key, (d > 1e-5).sum())


VARIANTS = {
    "llama-plain": ("llama2-7b", ()),
    "llama-microbatch2": ("llama2-7b", (("microbatch", 2),)),
    "llama-remat-full": ("llama2-7b", (("remat", "full"),)),
    "llama-int8": ("llama2-7b", (("grad_compression", "int8"),)),
    "granite-plain": (GRANITE, ()),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax(variant):
    arch, extra = VARIANTS[variant]
    want, want_params = _jax_run(arch, extra)
    cfg = get_smoke_config(arch)
    step = tstep.make_train_step(cfg, TrainConfig(**BASE, **dict(extra)))
    state, data = _port_state(arch), _data(cfg)
    for i in range(N_STEPS):
        state, m = step(state, torch_batch(data.batch_at(i), "cpu"))
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want[i][k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        assert int(m["step"]) == want[i]["step"] == i + 1
    _assert_params_close(state.params, want_params)


@pytest.mark.parametrize("arch", ["llama2-7b", GRANITE])
def test_train_step_bf16_matches_jax(arch):
    """Mixed precision, as the card trains at published width: float32
    masters, bfloat16 compute (the smoke config with ``dtype="bfloat16"``
    on both sides). The masters stay float32 and the differentiated
    function sees bf16 matrices.

    Tolerance, from measured readings (bf16 rounding in two packages):
    losses rtol 2e-3 (worst 9.6e-4), granite's aux rtol 5e-3 (worst
    2.9e-3) and grad norms rtol 1.5e-2 (worst 7.3e-3: its routing).
    Parameters: per leaf, the mean |port - JAX| at most 0.15 of the mean
    |JAX - init| the three steps moved it (worst 0.09, granite's router;
    a gradient that does not reach the masters gives 1.0)."""
    want, want_params = _jax_run(arch, (), "bfloat16")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    step = tstep.make_train_step(cfg, TrainConfig(**BASE))
    state, data = _port_state(arch), _data(cfg)
    for i in range(N_STEPS):
        state, m = step(state, torch_batch(data.batch_at(i), "cpu"))
        for k, rtol in (("loss", 2e-3), ("aux", 5e-3), ("grad_norm", 1.5e-2)):
            np.testing.assert_allclose(float(m[k]), want[i][k], rtol=rtol,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        assert int(m["step"]) == want[i]["step"] == i + 1
    cast = dict(lm.tree_items(lm.cast_params(state.params, cfg)))
    init = dict(lm.tree_items(_jax_init(arch)[1]))
    want_params = dict(lm.tree_items(want_params))
    for key, x in lm.tree_items(state.params):
        assert x.dtype == torch.float32, key
        if key.rsplit("/", 1)[-1] in lm.CAST_LEAVES:
            assert cast[key].dtype == torch.bfloat16, key
        moved = np.abs(want_params[key] - init[key]).mean()
        d = np.abs(x.numpy() - want_params[key]).mean()
        assert d <= 0.15 * moved, (key, d, moved)


def test_eval_step_matches_jax():
    arch = "llama2-7b"
    params, np_params = _jax_init(arch)
    batch = _data(get_smoke_config(arch)).batch_at(5)
    want = jax.jit(jstep.make_eval_step(jget_smoke(arch)))(
        params, jax.tree.map(jnp.asarray, batch))
    got = tstep.make_eval_step(get_smoke_config(arch))(
        params_from_numpy(np_params, get_smoke_config(arch), device="cpu"),
        torch_batch(batch, "cpu"))
    assert set(got) == set(want) == {"loss", "ppl_proxy", "acc"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_nan_skip_poisoned_batch_like_jax():
    """tests/test_runner.py's poisoned batch: both packages keep every
    parameter as it was and do not count the step."""
    arch = "llama2-7b"
    bad = {"tokens": np.zeros((4, 16), np.int32),
           "labels": np.zeros((4, 16), np.int32),
           "mask": np.full((4, 16), np.nan, np.float32)}
    params = _jax_init(arch)[0]
    jstate = jstep.TrainState(params, jadamw.init_state(params))
    jnew, jm = jax.jit(jstep.make_train_step(jget_smoke(arch),
                                             JTrainConfig(**BASE)))(
        jstate, jax.tree.map(jnp.asarray, bad))
    state = _port_state(arch)
    before = {k: x.clone() for k, x in lm.tree_items(state.params)}
    new, m = tstep.make_train_step(get_smoke_config(arch),
                                   TrainConfig(**BASE))(
        state, torch_batch(bad, "cpu"))
    assert int(m["step"]) == int(jm["step"]) == 0
    assert not np.isfinite(float(m["loss"]))
    jparams = dict(lm.tree_items(jnew.params))
    for key, x in lm.tree_items(new.params):
        assert torch.equal(x, before[key]), key
        np.testing.assert_array_equal(x.numpy(), np.asarray(jparams[key]))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["llama2-7b", GRANITE])
def test_remat_gradients_bit_equal(arch, remat):
    cfg = get_smoke_config(arch)
    params = _port_state(arch).params
    batch = torch_batch(_data(cfg).batch_at(0), "cpu")
    ref, l0, a0 = tstep.grads_of(params, batch, cfg, TrainConfig(**BASE))
    got, l1, a1 = tstep.grads_of(params, batch, cfg,
                                 TrainConfig(**BASE, remat=remat))
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for (key, g), (_, want) in zip(lm.tree_items(got), lm.tree_items(ref)):
        assert torch.equal(g, want), key


# ------------------------------------------------------------ checkpoints

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32) + seed,
                       "c": [torch.ones(2) * seed, torch.zeros(3, 3)]}}


def _assert_tree_equal(x, y):
    if isinstance(x, dict):
        assert sorted(x) == sorted(y)
        for k in x:
            _assert_tree_equal(x[k], y[k])
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y)
        for a, b in zip(x, y):
            _assert_tree_equal(a, b)
    else:
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    mgr.save(7, t, blocking=True)
    step, restored = mgr.restore_latest(_tree(seed=1))
    assert step == 7
    _assert_tree_equal(t, restored)


def test_checkpoint_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.steps() == [3, 4]


def test_checkpoint_restore_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1), blocking=True)
    mgr.save(2, _tree(2), blocking=True)
    step_dir = os.path.join(tmp_path, "step_2")
    for f in os.listdir(step_dir):
        with open(os.path.join(step_dir, f), "wb") as fh:
            fh.write(b"garbage")
    step, restored = mgr.restore_latest(_tree(seed=9))
    assert step == 1, "should fall back to the previous intact checkpoint"
    _assert_tree_equal(_tree(1), restored)


def test_checkpoint_restore_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    step, restored = mgr.restore_latest(_tree(3))
    assert step is None
    _assert_tree_equal(_tree(3), restored)


def test_checkpoint_async_save_copies_before_returning(tmp_path):
    """The port updates its state in place: what is saved is the state
    at the call, whatever the caller writes afterwards."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(5)
    mgr.save(5, t, blocking=False)
    t["a"].add_(100.0)
    t["nested"]["c"][0].zero_()
    mgr.wait()
    step, restored = mgr.restore_latest(_tree(0))
    assert step == 5
    _assert_tree_equal(_tree(5), restored)


def test_checkpoint_no_partial_visible(tmp_path):
    """Atomic rename: directory listing never shows a half-written step."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree(1), blocking=True)
    names = os.listdir(tmp_path)
    assert all(not n.startswith(("tmp", ".tmp")) for n in names), names


def test_checkpoint_bf16_leaf_and_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = {"w": torch.randn(3, 5).to(torch.bfloat16), "s": torch.tensor(3)}
    mgr.save(1, t, blocking=True)
    step, got = mgr.restore_latest({"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                                    "s": torch.tensor(0)})
    assert step == 1
    _assert_tree_equal(t, got)
    with pytest.raises(NotImplementedError, match="item 11"):
        mgr.restore_latest(t, shardings={})


def test_checkpoint_train_state_read_across_packages(tmp_path):
    """The same on-disk layout: the port restores a train state JAX
    wrote, and JAX one the port wrote, leaf for leaf."""
    arch = "llama2-7b"
    params = _jax_init(arch)[0]
    jstate = jstep.TrainState(params, jadamw.init_state(params))
    JCheckpointManager(str(tmp_path / "jax")).save(3, jstate, blocking=True)
    step, got = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        _port_state(arch))
    assert step == 3 and got.opt.step.dtype == torch.int32
    assert got.opt.step.shape == () and got.opt.mu["layers"]["attn"]["pca"].shape == ()
    for (key, x), (_, want) in zip(lm.tree_items(got.params),
                                   lm.tree_items(_jax_init(arch)[1])):
        np.testing.assert_array_equal(x.numpy(), want, err_msg=key)

    state = _port_state(arch)
    state.params["embed"]["table"].mul_(2.0)
    CheckpointManager(str(tmp_path / "port")).save(4, state, blocking=True)
    step, back = JCheckpointManager(str(tmp_path / "port")).restore_latest(
        jstate)
    assert step == 4
    for (key, x), (_, want) in zip(lm.tree_items(state.params),
                                   lm.tree_items(back.params)):
        np.testing.assert_array_equal(np.asarray(want), x.numpy(),
                                      err_msg=key)


# ------------------------------------------------------------ runner, CLI

def _runner_cfgs():
    cfg = get_smoke_config("llama2-7b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    return cfg, TrainConfig(**BASE), dcfg


def test_restart_resumes_bit_exact(tmp_path):
    cfg, tcfg, dcfg = _runner_cfgs()
    ref = TrainRunner(cfg, tcfg, dcfg, str(tmp_path / "ref"), ckpt_every=5,
                      device="cpu").run(12)
    ref_losses = [m["loss"] for m in ref["metrics"]]

    def make():
        return TrainRunner(cfg, tcfg, dcfg, str(tmp_path / "crash"),
                           ckpt_every=5, device="cpu")

    out = run_with_restarts(make, 12, injector=FailureInjector(fail_at=7))
    resumed = [m["loss"] for m in out["metrics"]]
    assert len(resumed) == 7            # steps 5..11 after the restart
    np.testing.assert_allclose(resumed, ref_losses[-7:], rtol=1e-5)
    assert resumed == ref_losses[-7:]   # and bit for bit on the CPU
    for (key, x), (_, want) in zip(lm.tree_items(out["state"].params),
                                   lm.tree_items(ref["state"].params)):
        assert torch.equal(x, want), key
    assert out["final_step"] == 12 and out["stragglers"] >= 0


def test_injector_raises_once():
    inj = FailureInjector(fail_at=3)
    inj(2)
    with pytest.raises(RuntimeError):
        inj(3)
    inj(3)  # second pass does not raise


def test_cli_trains_then_resumes(tmp_path, capsys):
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "3", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv)
    first = capsys.readouterr().out
    assert "arch=qwen2.5-3b-smoke mesh=(1, 1)" in first
    assert "step     2 loss" in first and first.rstrip().endswith("done")
    assert "resumed" not in first
    train_cli.main(argv)
    second = capsys.readouterr().out
    assert "resumed from checkpoint step 3" in second
    assert second.rstrip().endswith("done")
    with pytest.raises(NotImplementedError, match="item 11"):
        train_cli.main(argv + ["--mesh", "2x1"])


def test_serve_steps_match_jax():
    """``make_serve_steps``: a prefill and one decode step of the
    llama2-7b smoke model against JAX's, on the same weights."""
    arch, smax = "llama2-7b", 32
    params, np_params = _jax_init(arch)
    cfg = get_smoke_config(arch)
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (2, 9)).astype(
        np.int32)
    jprefill, jdecode = jstep.make_serve_steps(jget_smoke(arch), smax)
    jlogits, jcache, jpos = jprefill(params, jnp.asarray(toks))
    jnext = jnp.argmax(jlogits, -1).astype(jnp.int32)
    jlogits2, _ = jdecode(params, jcache, jnext, jpos)
    prefill, decode = tstep.make_serve_steps(cfg, smax)
    tparams = params_from_numpy(np_params, cfg, device="cpu")
    logits, cache, pos = prefill(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-5, atol=2e-5)
    logits2, _ = decode(tparams, cache, torch.from_numpy(np.array(jnext)),
                        pos)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits2),
                               rtol=2e-5, atol=2e-5)
