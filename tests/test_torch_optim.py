"""The port's loss, AdamW and gradient compression against the JAX
package's, on CPU.

``softmax_xent`` values and gradients, ``apply_updates`` over three
steps (a frozen ``pca`` leaf, clipping on and off), ``cosine_schedule``,
``clip_by_global_norm``, the top-k and int8 round trips (ties, padding),
``error_feedback_compress`` and ``compressed_psum`` meet JAX's on the
same numpy inputs. Tolerance 1e-6 relative at float32 (the arithmetic is
the same elementwise float32 in the same order; sums reduce in another
order); indices, int8 codes and the frozen leaves exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers, lm
from repro_torch.optim import adamw, compression

TOL = dict(rtol=1e-6, atol=1e-7)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, **tol):
    want = dict(lm.tree_items(want))
    for key, x in lm.tree_items(got):
        np.testing.assert_allclose(x.numpy(), np.asarray(want[key]),
                                   err_msg=key, **(tol or TOL))


# ------------------------------------------------------------ loss

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_softmax_xent_value_and_grad(z_loss, masked):
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 5, 37) * 3).astype(np.float32)
    labels = rng.randint(0, 37, (2, 5)).astype(np.int32)
    mask = (rng.rand(2, 5) > 0.4).astype(np.float32) if masked else None

    def jloss(x):
        return jlayers.softmax_xent(
            x, jnp.asarray(labels), z_loss=z_loss,
            mask=None if mask is None else jnp.asarray(mask))
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = layers.softmax_xent(
        x, torch.from_numpy(labels), z_loss=z_loss,
        mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **TOL)


# ------------------------------------------------------------ AdamW

def _opt_tree(seed):
    rng = np.random.RandomState(seed)
    return {"attn": {"wq": rng.randn(8, 16).astype(np.float32),
                     "pca": np.eye(4, dtype=np.float32)},
            "norm": {"scale": rng.randn(16).astype(np.float32)},
            "w": rng.randn(3, 5, 7).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
def test_apply_updates_three_steps_match_jax(clip):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    p0 = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    jst = jadamw.init_state(jp)
    tp = _t(p0)
    tst = adamw.init_state(tp)
    for step in range(3):
        g = _opt_tree(10 + step)
        jp, jst, jn = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                           jst, jcfg)
        tp, tst, tn = adamw.apply_updates(tp, _t(g), tst, cfg)
        np.testing.assert_allclose(tn.item(), float(jn), **TOL)
    assert tst.step.dtype == torch.int32 and tst.step.item() == 3
    _assert_tree_close(tp, _np(jp))
    _assert_tree_close(tst.mu, _np(jst.mu))
    _assert_tree_close(tst.nu, _np(jst.nu))
    # the frozen leaf: untouched, 0-d placeholder moments
    assert torch.equal(tp["attn"]["pca"], torch.eye(4))
    assert tst.mu["attn"]["pca"].shape == ()


def test_apply_updates_guard_skips_non_finite_step():
    cfg = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    tp = _t(_opt_tree(0))
    st = adamw.init_state(tp)
    tp, st, _ = adamw.apply_updates(tp, _t(_opt_tree(1)), st, cfg,
                                    guard=torch.tensor(1.0))
    before = jax.tree.map(lambda t: t.clone(), (tp, st.mu, st.nu))
    bad = _t(_opt_tree(2))
    bad["w"][0, 0, 0] = float("nan")
    tp, st2, gn = adamw.apply_updates(tp, bad, st, cfg,
                                      guard=torch.tensor(1.0))
    assert not torch.isfinite(gn)
    assert st2.step.item() == 1
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(
            (tp, st2.mu, st2.nu))):
        assert torch.equal(a, b)
    # a non-finite loss skips the step too
    tp, st3, _ = adamw.apply_updates(tp, _t(_opt_tree(3)), st2, cfg,
                                     guard=torch.tensor(float("inf")))
    assert st3.step.item() == 1


def test_cosine_schedule_matches_jax():
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=25)
    jlr = jadamw.cosine_schedule(JTrainConfig(**kw))
    lr = adamw.cosine_schedule(TrainConfig(**kw))
    steps = np.arange(0, 31, dtype=np.int32)
    got = lr(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlr(jnp.asarray(steps))), **TOL)


def test_clip_by_global_norm_matches_jax():
    g = _opt_tree(5)
    jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = adamw.clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(tn.item(), float(jn), **TOL)
    _assert_tree_close(tg, _np(jg))
    np.testing.assert_allclose(adamw.global_norm(tg).item(), 1.0, rtol=1e-5)


# ------------------------------------------------------------ compression

def test_topk_roundtrip_matches_jax_with_ties():
    rng = np.random.RandomState(7)
    g = np.round(rng.randn(40, 50), 1).astype(np.float32)   # many ties
    jv, ji, js = jcomp.topk_compress(jnp.asarray(g), 0.05)
    tv, ti, ts = compression.topk_compress(torch.from_numpy(g), 0.05)
    assert ts == js
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        compression.topk_decompress(tv, ti, ts).numpy(),
        np.asarray(jcomp.topk_decompress(jv, ji, js)))


@pytest.mark.parametrize("shape", [(64,), (33,), (8, 77)])
def test_int8_roundtrip_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    g = rng.randn(*shape).astype(np.float32)
    jq, js, jshape, jpad = jcomp.int8_compress(jnp.asarray(g))
    tq, ts, tshape, tpad = compression.int8_compress(torch.from_numpy(g))
    assert (tshape, tpad) == (tuple(jshape), jpad)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(
        compression.int8_decompress(tq, ts, tshape, tpad).numpy(),
        np.asarray(jcomp.int8_decompress(jq, js, jshape, jpad)), **TOL)


def test_error_feedback_compress_matches_jax():
    rng = np.random.RandomState(11)
    g = rng.randn(3000).astype(np.float32)
    err = (rng.randn(3000) * 0.1).astype(np.float32)
    jv, ji, je = jcomp.error_feedback_compress(jnp.asarray(g),
                                               jnp.asarray(err), 0.01)
    tv, ti, te = compression.error_feedback_compress(
        torch.from_numpy(g), torch.from_numpy(err), 0.01)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compressed_psum_matches_jax(scheme):
    rng = np.random.RandomState(13)
    tree = {"big": rng.randn(40, 40).astype(np.float32),     # >= 1024
            "small": rng.randn(100).astype(np.float32),      # topk skips
            "scalar": np.float32(rng.randn())}
    kw = dict(grad_compression=scheme, compression_ratio=0.05)
    want = jcomp.compressed_psum(jax.tree.map(jnp.asarray, tree),
                                 JTrainConfig(**kw))
    got = compression.compressed_psum(_t(tree), TrainConfig(**kw))
    _assert_tree_close(got, _np(want))
    if scheme == "topk":
        assert torch.equal(got["small"], torch.from_numpy(tree["small"]))
        assert int((got["big"] != 0).sum()) == 80
