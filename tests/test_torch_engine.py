"""The port's dense serving engine on CPU, held against the port's own
``prefill`` + ``decode_step`` (the JAX engine's greedy-identity tests are
red on this tree through test order, so they are no oracle here)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import EngineSection, ServeConfig
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import (Engine, Request, ServingEngine,
                                        sample_next)
from repro_torch.serving.lifecycle import Status

SMAX = 128


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("llama2-7b").with_policy("loki_block",
                                                    block_size=16)
    cfg = cfg.replace(loki=dataclasses.replace(cfg.loki, backend="pallas"))
    return lm.init(cfg, seed=0, device="cpu"), cfg


def _direct(params, cfg, prompt, n):
    if len(prompt) > 1:
        toks = torch.as_tensor(prompt[None, :-1].astype(np.int64))
        _, cache, pos = lm.prefill(params, cfg, toks, SMAX,
                                   cache_dtype=torch.float32)
    else:                               # nothing to prefill
        cache = lm.init_cache(cfg, 1, SMAX, torch.float32, device="cpu")
        pos = torch.zeros((1,), dtype=torch.int32)
    tok = torch.as_tensor([int(prompt[-1])])
    out = []
    for _ in range(n):
        logits, cache = lm.decode_step(params, cfg, cache, tok, pos)
        pos = pos + 1
        tok = torch.argmax(logits, -1)
        out.append(int(tok[0]))
    return out


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 512, size=n).astype(np.int32)


def test_ragged_batch_matches_direct_decode(model):
    params, cfg = model
    prompts = [_prompt(70, 1), _prompt(23, 2), _prompt(1, 3)]
    eng = ServingEngine(params, cfg, n_slots=3, smax=SMAX, device="cpu")
    assert isinstance(eng, Engine)
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.drain(max_ticks=50)
    for r, p in zip(reqs, prompts):
        assert r.status is Status.DONE and r.done
        assert r.out == _direct(params, cfg, p, 6)


def test_slots_recycle(model):
    params, cfg = model
    eng = ServingEngine(params, cfg, n_slots=1, smax=SMAX, device="cpu")
    reqs = [Request(rid=i, prompt=_prompt(10 + i, i), max_new=3)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.drain(max_ticks=50)
    assert all(r.status is Status.DONE for r in reqs)
    assert eng.ticks == 9
    assert [r.out for r in reqs] == [
        _direct(params, cfg, r.prompt, 3) for r in reqs]
    assert eng.stats()["lifecycle"] == {"done": 3}


def test_eos_stops_early(model):
    params, cfg = model
    prompt = _prompt(12, 4)
    eos = _direct(params, cfg, prompt, 1)[0]
    eng = ServingEngine(params, cfg, n_slots=1, smax=SMAX, eos_id=eos,
                        device="cpu")
    req = Request(rid=0, prompt=prompt, max_new=20)
    eng.submit(req)
    eng.drain(max_ticks=50)
    assert req.done and req.out == [eos]


def test_strict_admission_and_cancel(model):
    params, cfg = model
    eng = ServingEngine(params, cfg, n_slots=1, smax=SMAX, device="cpu")
    big = Request(rid=0, prompt=_prompt(SMAX - 2, 5), max_new=8)
    eng.submit(big)
    assert big.status is Status.FAILED and "oversized" in big.detail
    running = Request(rid=1, prompt=_prompt(9, 6), max_new=10)
    queued = Request(rid=2, prompt=_prompt(9, 7), max_new=10)
    eng.submit(running)
    eng.submit(queued)
    eng.tick()
    assert running.status is Status.DECODE and len(running.out) == 1
    assert eng.cancel(2) and queued.status is Status.CANCELLED
    assert eng.cancel(1) and running.status is Status.CANCELLED
    assert not eng.cancel(1)
    assert not eng.live.any()
    lenient = ServingEngine(params, cfg, n_slots=1, smax=SMAX,
                            admission="lenient", device="cpu")
    trunc = Request(rid=3, prompt=_prompt(SMAX + 20, 8), max_new=4)
    lenient.submit(trunc)
    lenient.drain(max_ticks=20)
    assert trunc.done and len(trunc.out) == 4


def test_sampling_is_seeded():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    a = sample_next(logits, greedy=False,
                    rng=torch.Generator().manual_seed(5), ticks=0)
    b = sample_next(logits, greedy=False,
                    rng=torch.Generator().manual_seed(5), ticks=0)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert torch.equal(sample_next(logits, greedy=True, rng=None, ticks=0),
                       logits.argmax(-1).to(torch.int32))


def test_serve_refuses_what_the_slice_lacks():
    ServeConfig(engine=EngineSection(kind="paged")).check()
    with pytest.raises(ValueError, match="engine kind"):
        ServeConfig(engine=EngineSection(kind="tiered")).check()
    with pytest.raises(NotImplementedError, match="training"):
        ServeConfig(warm_steps=10).check()


def test_serve_runs_on_cpu_when_asked():
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", "llama2-7b", "--policy", "loki_block",
                       "--requests", "2", "--max-new", "3", "--smax", "256",
                       "--device", "cpu"])
    assert all(r.done and len(r.out) == 3 for r in reqs)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = get_smoke_config("llama2-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(cfg)
    params = lm.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"layers": {}}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 16)
