"""Per-layer CacheSpec table of the paged engine (counterpart of
``repro.serving.cache_spec``).

Each decoder layer declares its decode-state components; the paged cache
(``models/lm.init_paged_cache``) and the scheduler are driven by that table.
Component kinds:

  PagedAttn        growable page-table K/V in the shared pool
                   ((n_pages * page_size, Hkv, W) per layer, no batch dim);
                   a request holds ceil(len / page_size) pages. Its
                   PageLayout sets the storage dtype (fp32, fp16, bf16,
                   int8, fp8), the key basis (native or pca), the stored
                   key width W (rank r under pca) and, for int8 and fp8,
                   per-page float32 scales.
  WindowPagedAttn  PagedAttn under a sliding-window mask: only the last
                   ``window`` positions are ever attended, so pages that
                   slide wholly out of the window are recycled (freed, and
                   their table entries pointed at the trash page, whose
                   rows the window mask hides). A request holds at most
                   ceil(window / page_size) + 1 pages.
  StateSlot        fixed-size recurrent state (mamba conv/ssm, mLSTM
                   C/n/m, sLSTM c/n/h/m) carried per slot across prefill
                   chunks and decode steps, O(1) in the request's length.
                   It is reset at admission; on preemption the paged
                   engine snapshots it to the host (and parks a hybrid's
                   own K/V pages as private pool entries) so re-admission
                   restores it instead of recomputing the folded prompt.
  CrossAttnStatic  whisper's encoder K/V, written once at admission
                   (``lm.encode_cross_kv``) into the request's slot and
                   read-only afterwards; quantized layouts keep one scale
                   per (layer, slot).

Layers whose windows differ read separate page tables (page-table groups,
``group_windows``): a full-attention layer pins its pages while a window
group recycles at its own window. ``page_ranks`` gives each layer its own
latent-K rank. MoE layers ([attn, moe]) page their attention exactly as
dense layers do; the vlm family is a dense backbone; the hybrid family
(hymba) holds both PagedAttn and a StateSlot in each layer, the ssm family
(xlstm: mLSTM and sLSTM layers, a list rather than a stack) StateSlots
only. The state helpers at the end build, snapshot and reset the
StateSlot leaves of both engines' caches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, PageLayout

# policies whose caches cannot rebuild exact prefix attention; they serve
# through the dense engine only
UNPAGEABLE_POLICIES = ("h2o", "pcaattn")


# ------------------------------------------------------------ layer kinds

def is_slstm(cfg: ModelConfig, i: int) -> bool:
    """xlstm: one block in ``slstm_every`` (the last of each run) is an
    sLSTM block, the rest mLSTM."""
    return bool(cfg.slstm_every) and (i % cfg.slstm_every
                                      == cfg.slstm_every - 1)


def layer_kind(cfg: ModelConfig, i: int) -> str:
    """dense|moe|hybrid|mlstm|slstm|dec — what block layer ``i`` is."""
    if cfg.family == "ssm":
        return "slstm" if is_slstm(cfg, i) else "mlstm"
    if cfg.family == "moe":
        return "moe"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.is_encoder_decoder:
        return "dec"
    return "dense"


def uses_scan(cfg: ModelConfig) -> bool:
    """Whether the layers stack on a leading L axis (JAX scans them). The
    ssm family's layers differ in kind, so its parameters and caches are
    a list of per-layer trees."""
    return cfg.family != "ssm"


# ------------------------------------------------------------- components

@dataclasses.dataclass(frozen=True)
class PagedAttn:
    """Growable page-table K/V in the shared pool. ``shareable``: a full
    page's K/V depends only on the token prefix, so identical prompt
    prefixes may share pages (prefix caching)."""
    n_kv_heads: int
    head_dim: int
    layout: PageLayout = dataclasses.field(default_factory=PageLayout)
    shareable = True

    @property
    def k_width(self) -> int:
        return self.layout.k_width(self.head_dim)

    def bytes_per_page(self, page_size: int) -> int:
        """K and V bytes of one page of one layer (the scales aside)."""
        return page_size * self.layout.bytes_per_page_row(self.head_dim,
                                                          self.n_kv_heads)


@dataclasses.dataclass(frozen=True)
class WindowPagedAttn(PagedAttn):
    """Paged K/V whose attended suffix is bounded by ``window``: pages
    that slide out of it are recycled. Not shareable: recycling frees a
    request's pages mid-stream and points their entries at the trash
    page, so another request aliasing them would read trash as context."""
    window: int = 0
    shareable = False


@dataclasses.dataclass(frozen=True)
class CrossAttnStatic:
    """Encoder K/V written once at admission, read-only afterwards. Not
    shareable: the decoder's self-attention K/V depend on the request's
    frames through cross-attention, so equal token prefixes do not give
    equal pages. ``layout``: the storage dtype is honoured (quantized
    cross K/V carry one scale per slot), the basis is native (PCA
    calibrates self-attention keys only)."""
    enc_seq: int
    n_kv_heads: int
    head_dim: int
    layout: PageLayout = dataclasses.field(default_factory=PageLayout)
    shareable = False


@dataclasses.dataclass(frozen=True)
class StateSlot:
    """Fixed-size per-slot recurrent state; ``state`` names the block
    (mamba|mlstm|slstm) whose cache builder defines its leaves. Not
    shareable: the state sums up the whole prefix, so a request cannot
    skip prefill over cached pages (the skipped tokens would be missing
    from its state). Families with a StateSlot bypass prefix caching."""
    state: str
    shareable = False


Component = Union[PagedAttn, WindowPagedAttn, StateSlot, CrossAttnStatic]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's decode-state declaration: named components ('attn' ->
    pooled K/V, 'ssm' -> the StateSlot leaves, 'cross' ->
    cross_k/cross_v)."""
    kind: str
    components: Tuple[Tuple[str, Component], ...]

    def component(self, name: str):
        return dict(self.components).get(name)

    @property
    def attn(self):
        c = self.component("attn")
        return c if isinstance(c, PagedAttn) else None

    @property
    def state(self):
        c = self.component("ssm")
        return c if isinstance(c, StateSlot) else None

    @property
    def cross(self):
        c = self.component("cross")
        return c if isinstance(c, CrossAttnStatic) else None


# --------------------------------------------------------------- registry

def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """The spec table: one LayerSpec per decoder layer. Every paged
    component carries ``cfg.page_layout`` (cross-attention with the basis
    forced native). ``cfg.page_ranks`` gives each layer's attn component
    its own layout at that layer's rank, so per-layer widths derive from
    the table alone."""
    hd = cfg.resolved_head_dim
    lay = cfg.page_layout
    if lay.rank > hd:
        raise ValueError(f"page_layout rank {lay.rank} > head_dim {hd}")
    ranks = cfg.page_ranks
    if ranks is not None:
        if len(ranks) != cfg.n_layers:
            raise ValueError(f"page_ranks needs {cfg.n_layers} entries, "
                             f"got {len(ranks)}")
        if any(r > hd for r in ranks):
            raise ValueError(f"page_ranks {ranks} exceed head_dim {hd}")
    cross_lay = dataclasses.replace(lay, basis="native", rank=0)

    def attn_for(i: int) -> PagedAttn:
        li = lay if ranks is None else dataclasses.replace(
            lay, basis="pca", rank=ranks[i])
        w = cfg.layer_window(i)
        if w:
            return WindowPagedAttn(cfg.n_kv_heads, hd, li, window=w)
        return PagedAttn(cfg.n_kv_heads, hd, li)

    def one(i: int) -> LayerSpec:
        kind = layer_kind(cfg, i)
        comps = []
        if kind in ("dense", "moe", "hybrid", "dec"):
            comps.append(("attn", attn_for(i)))
        if kind == "hybrid":
            comps.append(("ssm", StateSlot("mamba")))
        if kind in ("mlstm", "slstm"):
            comps.append(("ssm", StateSlot(kind)))
        if kind == "dec":
            comps.append(("cross", CrossAttnStatic(
                cfg.enc_seq, cfg.n_kv_heads, hd, cross_lay)))
        return LayerSpec(kind, tuple(comps))

    return tuple(one(i) for i in range(cfg.n_layers))


def has_paged_attn(cfg: ModelConfig) -> bool:
    return any(s.attn is not None for s in layer_specs(cfg))


def max_k_width(cfg: ModelConfig) -> int:
    """Stored K width of the stacked pools: every layer's pool lives in
    one (L, ...) array, so the width is the widest layer's ``k_width``;
    narrower layers zero their tail columns at write time."""
    widths = [s.attn.k_width for s in layer_specs(cfg) if s.attn is not None]
    return max(widths) if widths else cfg.resolved_head_dim


def layer_k_widths(cfg: ModelConfig) -> Tuple[int, ...]:
    """Per-layer stored K widths (a layer with no attn reports 0)."""
    return tuple(s.attn.k_width if s.attn is not None else 0
                 for s in layer_specs(cfg))


def latent_score_width(cfg: ModelConfig) -> int:
    """Width of the always-resident latent-K sidecar of a tiered pool: the
    leading-d slice Loki's score pass reads, d = min(max(d_f·D, 8), kd) as
    in ``loki.loki_decode``, clamped to the stored K width. The sidecar's
    rows are bitwise copies of the leading columns of the stored
    (PCA-basis) keys, so scoring from it is the single-tier scoring."""
    d = max(int(cfg.loki.d_f * cfg.resolved_head_dim), 8)
    return min(d, max_k_width(cfg))


def has_state_slots(cfg: ModelConfig) -> bool:
    return any(s.state is not None for s in layer_specs(cfg))


def pageable(cfg: ModelConfig) -> Tuple[bool, str]:
    """Can this config serve from the paged engine? (ok, reason)."""
    if has_paged_attn(cfg) and cfg.attn_policy() in UNPAGEABLE_POLICIES:
        return False, (f"policy {cfg.attn_policy()!r} cannot rebuild exact "
                       "prefix attention from its cache; use the dense "
                       "engine")
    return True, ""


def prefix_shareable(cfg: ModelConfig) -> Tuple[bool, str]:
    """Can prompt-prefix pages be shared across this config's requests?
    (ok, reason). The engine bypasses prefix caching with the reason
    instead of raising: window, state and cross components pin pages to
    one request."""
    if not has_paged_attn(cfg):
        return False, "no paged-attention layers to share"
    for s in layer_specs(cfg):
        for name, comp in s.components:
            if not comp.shareable:
                return False, (f"{type(comp).__name__} ({name}) pins pages "
                               "to one request")
    return True, ""


def assert_pageable(cfg: ModelConfig) -> None:
    ok, reason = pageable(cfg)
    if not ok:
        raise ValueError(f"{cfg.arch}: {reason} (paged serving)")


def servable_archs() -> Tuple[str, ...]:
    """Archs whose (default-policy) smoke config the paged engine serves:
    the set launch/serve.py allows, derived rather than hard-coded."""
    from repro_torch.configs import ARCHS, get_smoke_config
    return tuple(a for a in ARCHS if pageable(get_smoke_config(a))[0])


# ---------------------------------------------------------------- budgets

def window_page_budget(window: int, page_size: int) -> int:
    """Most live pages a window layer needs: the window spans at most
    ceil(window / page_size) pages, plus the page being written."""
    return -(-window // page_size) + 1


def recycle_window(cfg: ModelConfig) -> int:
    """The window one shared page table may recycle against, or 0: only
    when every attention layer is windowed (a full-attention layer pins
    its pages), at the widest of their windows."""
    windows = []
    for s in layer_specs(cfg):
        if isinstance(s.attn, WindowPagedAttn):
            windows.append(s.attn.window)
        elif s.attn is not None:
            return 0
    return max(windows) if windows else 0


def group_windows(cfg: ModelConfig) -> Tuple[int, ...]:
    """Window of each page-table group. Layers with equal windows share a
    table (their masks pass a page at the same position); distinct windows
    get distinct tables. Group 0 is the full-attention group when there is
    one, else the widest window; the rest follow by descending window."""
    windows = {s.attn.window if isinstance(s.attn, WindowPagedAttn) else 0
               for s in layer_specs(cfg) if s.attn is not None}
    if not windows:
        return ()
    return tuple(sorted(windows, key=lambda w: (w != 0, -w)))


def layer_group_ids(cfg: ModelConfig) -> Tuple[int, ...]:
    """Page-table group of each layer (-1: no paged attention)."""
    gid = {w: i for i, w in enumerate(group_windows(cfg))}
    out = []
    for s in layer_specs(cfg):
        if s.attn is None:
            out.append(-1)
        elif isinstance(s.attn, WindowPagedAttn):
            out.append(gid[s.attn.window])
        else:
            out.append(gid[0])
    return tuple(out)


def n_table_groups(cfg: ModelConfig) -> int:
    return max(len(group_windows(cfg)), 1)


def group_page_budget(cfg: ModelConfig, gid: int, smax: int,
                      page_size: int) -> int:
    """Most pages one request holds in group ``gid``'s table."""
    max_pages = -(-smax // page_size)
    w = group_windows(cfg)[gid]
    if w:
        return min(max_pages, window_page_budget(w, page_size))
    return max_pages


def request_page_budget(cfg: ModelConfig, smax: int, page_size: int) -> int:
    """Most pages one request holds at once, summed over its page-table
    groups (a mixed model holds group 0's whole prefix plus each window
    group's bounded set)."""
    if not has_paged_attn(cfg):
        return 0
    return sum(group_page_budget(cfg, g, smax, page_size)
               for g in range(len(group_windows(cfg))))


# ------------------------------------------------------------ state slots
# A cache's ``layers`` holds the StateSlot leaves under "ssm": stacked
# (L, n_slots, ...) in a dict for the scan families (slot axis 1), and per
# layer (n_slots, ...) in a list for the ssm family (slot axis 0). The
# helpers below take and give trees of that layout.

def state_slot_init(cfg: ModelConfig, comp: StateSlot, batch: int, dtype,
                    device, n_layers=None) -> Dict[str, Any]:
    """Fresh state leaves of ``batch`` slots of a StateSlot component
    (mamba's conv window in ``dtype``, everything else float32); mamba's
    stacked on ``n_layers`` when given (the hybrid's scanned layers; the
    ssm family's layers are a list)."""
    from repro_torch.models import blocks as B
    if comp.state == "mamba":
        return B.init_mamba_cache(cfg, batch, dtype, device,
                                  n_layers=n_layers)
    if comp.state == "mlstm":
        return B.init_mlstm_cache(cfg, batch, device)
    if comp.state == "slstm":
        return B.init_slstm_cache(cfg, batch, device)
    raise ValueError(f"unknown StateSlot kind {comp.state!r}")


def fresh_state_tree(cfg: ModelConfig, dtype, device):
    """Batch-1 fresh values of every StateSlot leaf, shaped to copy into
    one slot of either engine's cache (``reset_slot_state``); None when
    the model keeps no recurrent state (rows past an attention slot's
    position are never read, so it needs no reset). Cross K/V needs none
    either: it is installed at every admission."""
    specs = layer_specs(cfg)
    if uses_scan(cfg):
        st = specs[0].state
        if st is None:
            return None
        return {"ssm": state_slot_init(cfg, st, 1, dtype, device,
                                       n_layers=cfg.n_layers)}
    layers = [{"ssm": state_slot_init(cfg, s.state, 1, dtype, device)}
              if s.state is not None else {} for s in specs]
    return layers if any(layers) else None


def _slot_leaves(layers, fresh, scan: bool):
    """(cache leaf, matching fresh leaf, slot axis) of every state leaf."""
    def pairs(full, one):
        if isinstance(one, dict):
            for k in one:
                yield from pairs(full[k], one[k])
        else:
            yield full, one
    if scan:
        return [(f, o, 1) for f, o in pairs(layers, fresh)]
    return [(f, o, 0) for lc, fr in zip(layers, fresh)
            for f, o in pairs(lc, fr)]


def snapshot_slot_state(layers, fresh, slot: int, scan: bool):
    """One slot's state leaves of a cache's ``layers``, shaped as
    ``fresh_state_tree`` gives them, so that ``reset_slot_state(layers,
    snapshot, slot, scan)`` restores them verbatim: the paged engine's
    snapshot at preemption. On a card the leaves go to pinned host memory
    without waiting for it: the copy back at re-admission is issued on the
    same stream, after this one. On the CPU they are copies."""
    def take(full, axis):
        one = full.narrow(axis, slot, 1)
        if one.device.type != "cuda":
            return one.clone()
        host = torch.empty(one.shape, dtype=one.dtype, pin_memory=True)
        return host.copy_(one, non_blocking=True)

    def walk(full, one, axis):
        if isinstance(one, dict):
            return {k: walk(full[k], one[k], axis) for k in one}
        return take(full, axis)
    if scan:
        return walk(layers, fresh, 1)
    return [walk(lc, fr, 0) for lc, fr in zip(layers, fresh)]


def reset_slot_state(layers, fresh, slot: int, scan: bool):
    """Overwrite one slot's state leaves of a cache's ``layers`` with
    ``fresh`` (``fresh_state_tree`` values or a ``snapshot_slot_state``),
    in place, without waiting for the card. Returns ``layers``."""
    for full, one, axis in _slot_leaves(layers, fresh, scan):
        full.narrow(axis, slot, 1).copy_(one, non_blocking=True)
    return layers


# ------------------------------------------------------------ spec table

def _fmt_layout(comp: Component) -> str:
    lay = getattr(comp, "layout", None)
    if lay is None or lay == PageLayout():
        return ""
    return f", layout={lay.describe()}"


def _fmt_component(name: str, comp: Component, smax: int,
                   page_size: int) -> str:
    if isinstance(comp, WindowPagedAttn):
        return (f"{name}=WindowPagedAttn(window={comp.window}, "
                f"<= {window_page_budget(comp.window, page_size)} pages"
                f"{_fmt_layout(comp)})")
    if isinstance(comp, PagedAttn):
        return (f"{name}=PagedAttn(<= {-(-smax // page_size)} pages"
                f"{_fmt_layout(comp)})")
    if isinstance(comp, StateSlot):
        return f"{name}=StateSlot({comp.state})"
    return (f"{name}=CrossAttnStatic(enc_seq={comp.enc_seq}, "
            f"written at admission{_fmt_layout(comp)})")


def format_spec_table(cfg: ModelConfig, smax: int, page_size: int) -> str:
    """The reference's human-readable per-layer spec table, consecutive
    identical layers folded into one row."""
    specs = layer_specs(cfg)
    rows = []
    start = 0
    for i in range(1, len(specs) + 1):
        if i == len(specs) or specs[i] != specs[start]:
            s = specs[start]
            comps = " ".join(_fmt_component(n, c, smax, page_size)
                             for n, c in s.components) or "(stateless)"
            span = (f"{start}" if i - 1 == start else f"{start}-{i - 1}")
            rows.append(f"  layer {span:>7}  {s.kind:<7} {comps}")
            start = i
    budget = request_page_budget(cfg, smax, page_size)
    ok, why = prefix_shareable(cfg)
    share = "prefix_shareable" if ok else f"prefix_unshareable ({why})"
    lay = cfg.page_layout
    bpr = lay.bytes_per_page_row(cfg.resolved_head_dim, cfg.n_kv_heads)
    rw = recycle_window(cfg)
    head = (f"CacheSpec[{cfg.arch}] smax={smax} page_size={page_size} "
            f"budget={budget} pages/request"
            + (f" recycle_window={rw}" if rw else "")
            + f" layout={lay.describe()}"
            + (f" ranks=per-layer(max r={max_k_width(cfg)})"
               if cfg.page_ranks is not None else "")
            + f" ({bpr * page_size} B/page/layer) {share}")
    return "\n".join([head] + rows)
