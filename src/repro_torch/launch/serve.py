"""Serving launcher of the port (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --engine dense \
        --policy loki_block --requests 4 --max-new 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy full --page-size 16 --n-pages 33 --prefill-chunk 32
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy loki_block --layout int8:pca:r=16 --device cpu

Builds the dense slot engine (``--engine dense``) or the paged engine
(``--engine paged``: a page pool of ``--n-pages`` pages of
``--page-size`` tokens, prompts prefilled ``--prefill-chunk`` tokens at a
time) with the selected attention policy, calibrates the PCA transforms
for the Loki policies (and for pages stored in the PCA basis) on synthetic
batches, and reports throughput over a synthetic request stream. Runs on
the card unless ``--device cpu`` is given.

``--layout`` sets the paged engine's page layout in ``PageLayout.parse``
syntax, ``dtype[:basis][:r=N]``: storage fp32 | fp16 | bf16 | int8 | fp8
(int8 and fp8 pages carry per-page float32 scales), basis native | pca,
and a latent key rank r under pca (e.g. ``int8:pca:r=32``); empty is the
default fp32 native layout.

Every knob lives in :class:`ServeConfig`; the flags are thin aliases.
``warm_steps > 0`` raises (the port has no training yet). ``--full``
selects the published width (the JAX launcher's ``--smoke`` cannot be
turned off).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, PageLayout
from repro_torch.core import pca as PCA
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.lifecycle import summarize
from repro_torch.serving.scheduler import PagedServingEngine


@dataclasses.dataclass(frozen=True)
class EngineSection:
    """What runs: model, attention policy, kernel backend, batch shape."""
    arch: str = "qwen2.5-3b"
    smoke: bool = True
    kind: str = "dense"            # dense | paged
    policy: str = "loki"
    k_f: float = 0.25
    d_f: float = 0.25
    backend: str = "auto"          # auto | pallas | xla
    n_slots: int = 4
    smax: int = 128


@dataclasses.dataclass(frozen=True)
class PagedSection:
    """The paged engine's pool and prefill chunking (``kind="paged"``).
    None page_size = the Loki block size; None n_pages = every slot at
    its page bound."""
    page_size: Optional[int] = None
    n_pages: Optional[int] = None
    prefill_chunk: int = 32
    layout: str = ""               # PageLayout.parse spec; "" = default

    def page_layout(self) -> PageLayout:
        return PageLayout.parse(self.layout) if self.layout else PageLayout()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    engine: EngineSection = dataclasses.field(default_factory=EngineSection)
    paged: PagedSection = dataclasses.field(default_factory=PagedSection)
    admission: str = "strict"      # strict | lenient
    requests: int = 6
    max_new: int = 16
    warm_steps: int = 0
    seed: int = 0
    device: str = "cuda"

    @classmethod
    def from_args(cls, a: argparse.Namespace) -> "ServeConfig":
        return cls(
            engine=EngineSection(
                arch=a.arch, smoke=not a.full, kind=a.engine,
                policy=a.policy, k_f=a.k_f, d_f=a.d_f, backend=a.backend,
                n_slots=a.n_slots, smax=a.smax),
            paged=PagedSection(page_size=a.page_size, n_pages=a.n_pages,
                               prefill_chunk=a.prefill_chunk,
                               layout=a.layout),
            admission=a.admission, requests=a.requests, max_new=a.max_new,
            warm_steps=a.warm_steps, seed=a.seed, device=a.device)

    def resolve_model(self) -> ModelConfig:
        cfg = (get_smoke_config if self.engine.smoke
               else get_config)(self.engine.arch)
        if self.engine.policy != "full":
            cfg = cfg.with_policy(self.engine.policy, k_f=self.engine.k_f,
                                  d_f=self.engine.d_f)
        lay = self.paged.page_layout()
        if lay != PageLayout():
            cfg = cfg.with_layout(lay)
        return cfg

    def check(self) -> None:
        """Refuse what the port does not carry yet, before any work."""
        if self.engine.kind not in ("dense", "paged"):
            raise ValueError(f"engine kind {self.engine.kind!r}; use "
                             "'dense' or 'paged'")
        if self.paged.layout and self.engine.kind != "paged":
            raise ValueError("--layout sets the paged engine's page layout; "
                             "use --engine paged")
        if self.warm_steps:
            raise NotImplementedError(
                "warm_steps > 0 needs training, not ported yet (ROADMAP "
                "queue 1 item 10)")

    def build_engine(self, params, cfg: ModelConfig):
        self.check()
        common = dict(n_slots=self.engine.n_slots, smax=self.engine.smax,
                      backend=self.engine.backend, admission=self.admission,
                      device=self.device)
        if self.engine.kind == "paged":
            return PagedServingEngine(
                params, cfg, page_size=self.paged.page_size,
                n_pages=self.paged.n_pages,
                prefill_chunk=self.paged.prefill_chunk, **common)
        return ServingEngine(params, cfg, **common)


def calibrated_params(cfg: ModelConfig, data: SyntheticLM, *, seed: int,
                      device):
    """Random weights from ``seed`` with PCA projections calibrated on two
    synthetic batches and installed, as the JAX launcher does: for the
    Loki policies and for pages stored in the PCA basis."""
    params = lm.init(cfg, seed=seed, device=device)
    if cfg.attn_policy() in ("loki", "loki_block") or \
            cfg.page_layout.basis == "pca":
        batches = [data.batch_at(1000 + i)["tokens"] for i in range(2)]
        calib = PCA.calibrate_model(params, cfg, batches)
        params = PCA.install_projections(params, calib, "pre")
    return params


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="published width instead of the smoke config")
    ap.add_argument("--policy", default="loki",
                    choices=["full", "exact_topk", "loki", "loki_block"])
    ap.add_argument("--k-f", type=float, default=0.25)
    ap.add_argument("--d-f", type=float, default=0.25)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="decode kernel backend for loki_block (auto = the "
                         "CUDA kernels on the card)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--smax", type=int, default=128)
    ap.add_argument("--engine", default="dense", choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged engine: tokens per page (default: the Loki "
                         "block size)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="paged engine: pool pages incl. the trash page "
                         "(default: every slot at its page bound)")
    ap.add_argument("--layout", default="",
                    help="paged engine's PageLayout spec "
                         "'dtype[:basis][:r=N]': dtype fp32|fp16|bf16|int8|"
                         "fp8, basis native|pca, latent rank r (pca only); "
                         "e.g. 'int8:pca:r=32'. Empty = fp32 native")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="paged engine: prompt tokens per prefill chunk")
    ap.add_argument("--admission", default="strict",
                    choices=["strict", "lenient"])
    ap.add_argument("--warm-steps", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    sc = ServeConfig.from_args(build_parser().parse_args(argv))
    sc.check()
    device = resolve_device(sc.device)
    cfg = sc.resolve_model()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=96,
                                  global_batch=8, seed=7, n_states=32,
                                  temperature=0.22))
    params = calibrated_params(cfg, data, seed=sc.seed, device=device)
    eng = sc.build_engine(params, cfg)
    if sc.engine.kind == "paged":
        lay = cfg.page_layout
        print(f"layout: {lay.describe()} — {eng.bytes_per_page} B/page/layer"
              + (" (per-page f32 scales beside the table)"
                 if lay.quantized else ""))
    reqs = [Request(rid=i,
                    prompt=data.batch_at(4000 + i)["tokens"][0, :24 + 4 * i],
                    max_new=sc.max_new)
            for i in range(sc.requests)]
    for r in reqs:
        eng.submit(r)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.drain()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"engine={sc.engine.kind} policy={cfg.attn_policy()} "
          f"device={device} served {len(reqs)} "
          f"requests ({toks} tokens) in {eng.ticks} ticks, {dt:.2f}s -> "
          f"{toks / dt:.1f} tok/s, {1e3 * dt / max(eng.ticks, 1):.1f} "
          "ms/tick")
    print(f"lifecycle: {summarize(reqs)}")
    if sc.engine.kind == "paged":
        st = eng.stats()
        print(f"paged: {eng.pool.n_pages} pages of {eng.page_size}, "
              f"preempted {st['n_preempted']}, decode steps "
              f"{st['n_decode_steps']}, prefill chunks "
              f"{st['n_prefill_chunks']}, host syncs {st['n_host_syncs']}")
    for r in reqs[:2]:
        print(f"  req{r.rid}: {r.out[:10]}")
    return reqs


if __name__ == "__main__":
    main()
