"""Deterministic synthetic token pipeline (a copy of
``repro.data.synthetic`` without its JAX helper).

Offline container => no real corpora. The generator produces a *structured*
Markov-ish token stream (not uniform noise) so that perplexity/top-k
benchmarks have signal: a small trained model actually concentrates attention
mass, which is what Loki's top-k selection exploits.

Properties the framework relies on:
  * fully deterministic given (seed, step)  -> exact resume after restart
  * per-host sharding by process index      -> multi-host data parallel
  * O(1) state (the iterator *is* the step) -> checkpoint-free data resume
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 512
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 1234
    n_states: int = 64          # markov states; lower = more predictable
    temperature: float = 0.7


class SyntheticLM:
    """Order-1 Markov chain over a random stochastic matrix + positional
    repetition structure (forces long-range attention: token t attends to
    t - period)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        logits = rng.randn(cfg.n_states, cfg.vocab) / cfg.temperature
        self.emit = _softmax(logits)
        trans = rng.randn(cfg.n_states, cfg.n_states) / cfg.temperature
        self.trans = _softmax(trans)
        self.period = max(cfg.seq_len // 4, 8)

    def batch_at(self, step: int, host: int = 0, n_hosts: int = 1
                 ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // n_hosts
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 613 + host * 7919) % (2**31 - 1))
        b, s = per_host, cfg.seq_len + 1
        states = rng.randint(0, cfg.n_states, size=(b,))
        toks = np.empty((b, s), np.int32)
        for t in range(s):
            # emit
            probs = self.emit[states]
            c = probs.cumsum(axis=1)
            u = rng.rand(b, 1)
            toks[:, t] = (u < c).argmax(axis=1)
            # every `period` steps, copy an old token (long-range structure)
            if t >= self.period and t % self.period == 0:
                toks[:, t] = toks[:, t - self.period]
            # transition
            tc = self.trans[states].cumsum(axis=1)
            states = (rng.rand(b, 1) < tc).argmax(axis=1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, start_step: int = 0, host: int = 0, n_hosts: int = 1
                ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step, host, n_hosts)
            step += 1


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
