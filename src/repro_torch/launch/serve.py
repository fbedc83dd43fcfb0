"""Serving launcher of the port (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --engine dense \
        --policy loki_block --requests 4 --max-new 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy full --page-size 16 --n-pages 33 --prefill-chunk 32
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy loki_block --layout int8:pca:r=16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --sched-policy priority --prefix-cache off --shed-after 2
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy loki_block --smax 64 --page-size 16 --device-pages 5 \
        --faults seed=7,dma_timeout=0.2,hbm_oom_on_promote=0.1 --audit \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine dense \
        --policy h2o --arch llama2-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy loki_block --arch granite-moe-3b-a800m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy loki_block --arch whisper-small --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy full --arch mixtral-8x22b --page-size 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --policy loki_block --arch hymba-1.5b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --arch xlstm-125m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine dense \
        --warm-steps 10 --device cpu

Builds the dense slot engine (``--engine dense``) or the paged engine
(``--engine paged``: a page pool of ``--n-pages`` pages of
``--page-size`` tokens, prompts prefilled ``--prefill-chunk`` tokens at a
time) with the selected attention policy, calibrates the PCA transforms
for the Loki policies and ``pcaattn`` (and for pages stored in the PCA
basis) on synthetic batches, and reports throughput over a synthetic
request stream. Runs on the card unless ``--device cpu`` is given. The
policies whose caches cannot rebuild exact prefix attention (``h2o``,
``pcaattn``) serve through the dense engine: ``--engine paged`` with one
of them prints a note and falls back to it, as the JAX launcher does.

``--layout`` sets the paged engine's page layout in ``PageLayout.parse``
syntax, ``dtype[:basis][:r=N]``: storage fp32 | fp16 | bf16 | int8 | fp8
(int8 and fp8 pages carry per-page float32 scales), basis native | pca,
and a latent key rank r under pca (e.g. ``int8:pca:r=32``); empty is the
default fp32 native layout.

The paged engine's scheduler, with the reference's flags and defaults:
``--sched-policy fifo|priority``, ``--prefill-budget`` and
``--decode-budget`` (0: one chunk, every live slot), ``--prefix-cache
on|off`` (on; bypassed with its reason for configs that cannot share
pages) and ``--shed-after`` (0: never shed). Decode is gather-packed.
``--device-pages N`` makes the pool tiered (N frames of full-D K/V on the
card, the rest in pinned host buffers, a Loki policy only; 0: single
tier) with ``--max-inflight`` fetches in flight (2); ``--faults`` takes a
``FaultPlan.parse`` spec (empty: off) and ``--audit`` runs the invariant
auditor after every tick. The run ends with the tiered pool's counters.

The served families are those of ``cache_spec.servable_archs``, every
one of the JAX package's: dense, MoE (mixtral's sliding window recycles
its pages on the paged engine), the encoder-decoder (whisper: each
request carries deterministic stand-in encoder frames, ``_frames``, as in
the JAX launcher), the vlm (llava, served as its dense backbone), the
hybrid (hymba: attention beside mamba, its state snapshotted on
preemption) and the ssm family (xlstm: no KV cache, so its policy is
forced to full with the JAX launcher's note). ``--warm-steps N`` trains
the random weights N steps first (the JAX launcher's warm-up: AdamW at lr
3e-3, 5 warmup steps, through ``training.step.make_train_step``).

Every knob lives in :class:`ServeConfig`; the flags are thin aliases.
``--full`` selects the published width (the JAX launcher's ``--smoke``
cannot be turned off).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, PageLayout, TrainConfig
from repro_torch.core import pca as PCA
from repro_torch.data.synthetic import DataConfig, SyntheticLM, torch_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.serving import cache_spec as CS
from repro_torch.serving import faults as FI
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.lifecycle import summarize
from repro_torch.serving.scheduler import PagedServingEngine
from repro_torch.training.step import TrainState, make_train_step


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
    device_pages: int = 0          # tiered pool: device frames; 0 = off
    max_inflight: int = 2          # fetches in flight (tiered pool)

    def page_layout(self) -> PageLayout:
        return PageLayout.parse(self.layout) if self.layout else PageLayout()


@dataclasses.dataclass(frozen=True)
class SchedulerSection:
    """The paged engine's tick policy: admission order, per-tick token
    budgets, prefix sharing and shedding."""
    policy: str = "fifo"           # fifo | priority
    prefill_budget: int = 0        # prompt tok/tick (0 = one chunk)
    decode_budget: int = 0         # live slots decoded/tick (0 = all)
    prefix_cache: bool = True
    shed_after: int = 0            # preemptions before SHED (0 = never)
    faults: str = ""               # FaultPlan.parse spec; "" = off
    audit: bool = False            # invariant auditor after every tick

    def fault_plan(self) -> Optional[FI.FaultPlan]:
        return FI.FaultPlan.parse(self.faults) if self.faults else None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    engine: EngineSection = dataclasses.field(default_factory=EngineSection)
    paged: PagedSection = dataclasses.field(default_factory=PagedSection)
    scheduler: SchedulerSection = dataclasses.field(
        default_factory=SchedulerSection)
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
                               layout=a.layout,
                               device_pages=a.device_pages,
                               max_inflight=a.max_inflight),
            scheduler=SchedulerSection(
                policy=a.sched_policy, prefill_budget=a.prefill_budget,
                decode_budget=a.decode_budget,
                prefix_cache=a.prefix_cache == "on",
                shed_after=a.shed_after, faults=a.faults, audit=a.audit),
            admission=a.admission, requests=a.requests, max_new=a.max_new,
            warm_steps=a.warm_steps, seed=a.seed, device=a.device)

    def resolve_model(self) -> ModelConfig:
        cfg = (get_smoke_config if self.engine.smoke
               else get_config)(self.engine.arch)
        policy = self.engine.policy
        if cfg.family == "ssm" and policy != "full":
            print(f"note: {self.engine.arch} has no KV cache; policy "
                  "forced to full")
            policy = "full"
        if policy != "full":
            cfg = cfg.with_policy(policy, k_f=self.engine.k_f,
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
        if self.engine.kind != "paged" and (
                self.paged.layout or self.paged.device_pages
                or self.scheduler.faults or self.scheduler.audit):
            raise ValueError("--layout, --device-pages, --faults and "
                             "--audit set the paged engine; use --engine "
                             "paged")
        archs = CS.servable_archs()
        if self.engine.arch not in archs:
            raise ValueError(f"unknown arch {self.engine.arch!r}; the port "
                             f"serves {', '.join(archs)}")

    def serves_paged(self, cfg: ModelConfig) -> bool:
        """Whether ``build_engine`` builds the paged engine: asked for, and
        the config pageable. Otherwise (a policy whose cache cannot
        rebuild exact prefix attention) it prints the JAX launcher's note
        and the dense engine serves."""
        if self.engine.kind != "paged":
            return False
        ok, why = CS.pageable(cfg)
        if not ok:
            print(f"note: {why}; falling back to the dense engine")
        return ok

    def build_engine(self, params, cfg: ModelConfig):
        self.check()
        common = dict(n_slots=self.engine.n_slots, smax=self.engine.smax,
                      backend=self.engine.backend, admission=self.admission,
                      device=self.device)
        if self.serves_paged(cfg):
            sch = self.scheduler
            return PagedServingEngine(
                params, cfg, page_size=self.paged.page_size,
                n_pages=self.paged.n_pages,
                prefill_chunk=self.paged.prefill_chunk, policy=sch.policy,
                prefill_budget=sch.prefill_budget or None,
                decode_budget=sch.decode_budget or None,
                prefix_cache=sch.prefix_cache,
                shed_after=sch.shed_after or None,
                faults=sch.fault_plan(), audit=sch.audit,
                device_pages=self.paged.device_pages or None,
                max_inflight=self.paged.max_inflight, **common)
        return ServingEngine(params, cfg, **common)


def _frames(cfg: ModelConfig, seed: int, batch: int = 1) -> torch.Tensor:
    """Deterministic stand-in encoder frames (B, enc_seq, d_model) float32
    on the host: no audio frontend (the conv stem is stubbed, see
    configs/whisper_small.py). Drawn from a torch generator, so they
    differ from the JAX launcher's draws."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=gen)


def batch_with_extras(cfg: ModelConfig, data: SyntheticLM, i: int, device):
    """Synthetic batch ``i`` on ``device``, with stand-in frames for the
    encoder-decoder."""
    batch = torch_batch(data.batch_at(i), device)
    if cfg.is_encoder_decoder:
        batch["frames"] = _frames(cfg, i, batch["tokens"].shape[0]).to(
            batch["tokens"].device)
    return batch


def warm_params(cfg: ModelConfig, data: SyntheticLM, *, steps: int,
                seed: int, device):
    """The JAX launcher's warm-up: float32 masters from ``seed``, ``steps``
    train steps (AdamW, lr 3e-3, 5 warmup steps, cosine over ``steps``)
    over ``batch_with_extras(i)``, returned cast for serving -> (params,
    last metrics)."""
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    params = lm.init(cfg, seed=seed, device=device, dtype=cfg.param_dtype)
    state = TrainState(params, adamw.init_state(params))
    step = make_train_step(cfg, tcfg)
    metrics = {}
    for i in range(steps):
        state, metrics = step(state, batch_with_extras(cfg, data, i, device))
    return lm.cast_params(state.params, cfg), metrics


def calibrated_params(cfg: ModelConfig, data: SyntheticLM, *, seed: int,
                      device, warm_steps: int = 0):
    """Random weights from ``seed`` (warmed ``warm_steps`` train steps,
    ``warm_params``) with PCA projections calibrated on two synthetic
    batches and installed, as the JAX launcher does: for the Loki
    policies, ``pcaattn`` and pages stored in the PCA basis. The
    encoder-decoder calibrates over stand-in frames."""
    if warm_steps:
        params, m = warm_params(cfg, data, steps=warm_steps, seed=seed,
                                device=device)
        print(f"warmed {warm_steps} steps, loss {float(m['loss']):.3f}")
    else:
        params = lm.init(cfg, seed=seed, device=device)
    if cfg.attn_policy() in ("loki", "loki_block", "pcaattn") or \
            cfg.page_layout.basis == "pca":
        batches = [data.batch_at(1000 + i)["tokens"] for i in range(2)]
        frames = (_frames(cfg, 0, batches[0].shape[0])
                  if cfg.is_encoder_decoder else None)
        calib = PCA.calibrate_model(params, cfg, batches, frames=frames)
        params = PCA.install_projections(params, calib, "pre")
    return params


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="published width instead of the smoke config")
    ap.add_argument("--policy", default="loki",
                    choices=["full", "exact_topk", "loki", "loki_block",
                             "h2o", "pcaattn"],
                    help="decode attention policy; h2o and pcaattn serve "
                         "through the dense engine only")
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
    ap.add_argument("--device-pages", type=int, default=0,
                    help="paged engine, tiered KV pool: full-D K/V frames "
                         "kept on the card; pages beyond spill to pinned "
                         "host buffers and come back through the fetch "
                         "queue when Loki's selection attends them (0 = "
                         "single tier; needs a loki policy)")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="paged engine: host-to-device fetches the tiered "
                         "pool keeps in flight")
    ap.add_argument("--sched-policy", default="fifo",
                    choices=["fifo", "priority"],
                    help="paged engine's scheduling policy; priority "
                         "admits by Request.priority and may preempt a "
                         "lower class for a slot")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="paged engine: prompt tokens computed per tick "
                         "(0 = one chunk per tick)")
    ap.add_argument("--decode-budget", type=int, default=0,
                    help="paged engine: live slots decoded per tick "
                         "(0 = all)")
    ap.add_argument("--prefix-cache", default="on", choices=["on", "off"],
                    help="paged engine: share identical prompt-prefix "
                         "pages across requests (bypassed for configs "
                         "that cannot share pages)")
    ap.add_argument("--shed-after", type=int, default=0,
                    help="paged engine: preemptions a request survives "
                         "before it is shed (terminal SHED with a "
                         "retry-after hint); 0 = never shed")
    ap.add_argument("--faults", default="",
                    help="paged engine: deterministic fault plan "
                         "(serving/faults.py), e.g. "
                         "'seed=3,nan_logits=0.05,alloc_fail@7'; sites: "
                         + ", ".join(FI.FaultPlan.SITES)
                         + " (kernel_fail: CPU engines only)")
    ap.add_argument("--audit", action="store_true",
                    help="paged engine: run the pool/slot/table invariant "
                         "auditor after every tick (raises AuditError on "
                         "a violation)")
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
    params = calibrated_params(cfg, data, seed=sc.seed, device=device,
                               warm_steps=sc.warm_steps)
    eng = sc.build_engine(params, cfg)
    paged = isinstance(eng, PagedServingEngine)
    if paged:
        if eng.window or eng.n_groups > 1:
            print(f"windows: page-table groups {list(eng.group_windows)} "
                  f"(0 = full attention), budget {eng.req_budget} "
                  "pages/request, pages recycled as they leave a window")
        lay = cfg.page_layout
        if eng.has_pages:
            print(f"layout: {lay.describe()} — {eng.bytes_per_page} "
                  "B/page/layer" + (" (per-page f32 scales beside the "
                                    "table)" if lay.quantized else ""))
        share = ("on" if eng.prefix_caching else
                 f"bypassed ({eng.prefix_cache_reason})"
                 if sc.scheduler.prefix_cache else "off")
        print(f"scheduler: policy={eng.policy.name} budgets="
              f"{eng.budget.prefill_tokens}p/{eng.budget.decode_tokens}d "
              f"tok/tick prefix-cache={share} packed={eng.packed} "
              f"shed_after={eng.shed_after}")
        if eng.tiered:
            print(f"tiered pool: {eng.pool.device_pages} device frames, "
                  "host buffers beyond, rank-"
                  f"{eng.cache['layers']['attn']['k_lat'].shape[-1]} latent "
                  f"sidecar resident, <= {eng.pool.max_inflight} fetches "
                  "in flight (demote before preempt)")
        plan = sc.scheduler.fault_plan()
        if plan is not None or sc.scheduler.audit:
            print("faults: " + (f"[{plan.describe()}]" if plan is not None
                                else "off")
                  + (" audit=per-tick" if sc.scheduler.audit else ""))
    reqs = [Request(rid=i,
                    prompt=data.batch_at(4000 + i)["tokens"][0, :24 + 4 * i],
                    max_new=sc.max_new,
                    frames=(_frames(cfg, 4000 + i)[0].numpy()
                            if cfg.is_encoder_decoder else None))
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
    print(f"engine={'paged' if paged else 'dense'} "
          f"policy={cfg.attn_policy()} "
          f"device={device} served {len(reqs)} "
          f"requests ({toks} tokens) in {eng.ticks} ticks, {dt:.2f}s -> "
          f"{toks / dt:.1f} tok/s, {1e3 * dt / max(eng.ticks, 1):.1f} "
          "ms/tick")
    print(f"lifecycle: {summarize(reqs)}")
    if paged:
        st = eng.stats()
        print(f"paged: {eng.pool.n_pages} pages of {eng.page_size}, "
              f"preempted {st['n_preempted']}, shed {st['n_shed']}, "
              f"decode steps {st['n_decode_steps']} "
              f"({st['packed']['n_packed_ticks']} packed), prefill chunks "
              f"{st['n_prefill_chunks']}, prefix hit rate "
              f"{st['prefix_hit_rate']:.3f}, copy-on-write "
              f"{st['n_cow_copies']}, host syncs {st['n_host_syncs']}, "
              f"recycled pages {st['n_recycled_pages']}, peak pages a "
              f"slot {st['peak_slot_pages']}")
        if st.get("faults") or st["n_quarantined"] \
                or st["n_backend_fallbacks"]:
            print(f"faults: injected {st.get('faults', {})}, quarantined "
                  f"{st['n_quarantined']}, backend fallbacks "
                  f"{st['n_backend_fallbacks']}")
        if "tiered" in st:
            ti = st["tiered"]
            print(f"tiered pool: {ti['device_pages']} device frames, "
                  f"{ti['n_demoted']} demoted / {ti['n_promoted']} "
                  f"promoted, prefetch hit rate "
                  f"{ti['prefetch_hit_rate']:.2f}, {ti['n_sync_fetches']} "
                  f"sync fetches, {ti['n_fetches_issued']} queued fetches "
                  f"({ti['n_sync_fallbacks']} re-copied), "
                  f"{ti['n_decode_reruns']} decode reruns in "
                  f"{ti['n_decode_runs']} runs, {ti['n_deferred']} "
                  f"deferrals, {ti['h2d_bytes']} B host-to-device / "
                  f"{ti['d2h_bytes']} B device-to-host, peak host buffers "
                  f"{ti['peak_host_bytes']} B")
    for r in reqs[:2]:
        print(f"  req{r.rid}: {r.out[:10]}")
    return reqs


if __name__ == "__main__":
    main()
