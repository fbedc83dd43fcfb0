"""Per-layer CacheSpec table of the paged engine (counterpart of
``repro.serving.cache_spec``), dense and MoE families.

Each decoder layer declares its decode-state components; the paged cache
(``models/lm.init_paged_cache``) and the scheduler are driven by that table.
The port carries one component kind so far:

  PagedAttn  growable page-table K/V in the shared pool
             ((n_pages * page_size, Hkv, W) per layer, no batch dim); a
             request holds ceil(len / page_size) pages. Its PageLayout
             sets the storage dtype (fp32, fp16, bf16, int8, fp8), the key
             basis (native or pca), the stored key width W (rank r under
             pca) and, for int8 and fp8, per-page float32 scales.

MoE layers ([attn, moe]) page their attention exactly as dense layers do:
the experts keep no decode state. The reference's WindowPagedAttn,
StateSlot and CrossAttnStatic (sliding window, recurrent and encoder
families) come with the other families (ROADMAP queue 1 item 8), and
per-layer ranks (``page_ranks``) with them. Both raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig, PageLayout

# policies whose caches cannot rebuild exact prefix attention; they serve
# through the dense engine only
UNPAGEABLE_POLICIES = ("h2o", "pcaattn")


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
class LayerSpec:
    """One layer's decode-state declaration: named components."""
    kind: str
    components: Tuple[Tuple[str, PagedAttn], ...]

    def component(self, name: str):
        return dict(self.components).get(name)

    @property
    def attn(self):
        c = self.component("attn")
        return c if isinstance(c, PagedAttn) else None


def _check_ported(cfg: ModelConfig) -> None:
    if (cfg.family not in ("dense", "moe") or cfg.is_encoder_decoder
            or cfg.vision_tokens or cfg.window_layers is not None
            or cfg.sliding_window):
        raise NotImplementedError(
            f"{cfg.arch}: only dense and MoE full-attention layers page in "
            "the port so far (window, state and cross-attention components: "
            "ROADMAP queue 1 item 8)")
    if cfg.page_ranks is not None:
        raise NotImplementedError(
            "per-layer page ranks (page_ranks) are not ported yet; they "
            "serve the families of ROADMAP queue 1 item 8")


def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """The spec table: one LayerSpec per decoder layer."""
    _check_ported(cfg)
    attn = PagedAttn(cfg.n_kv_heads, cfg.resolved_head_dim, cfg.page_layout)
    return tuple(LayerSpec(cfg.family, (("attn", attn),))
                 for _ in range(cfg.n_layers))


def has_paged_attn(cfg: ModelConfig) -> bool:
    return any(s.attn is not None for s in layer_specs(cfg))


def max_k_width(cfg: ModelConfig) -> int:
    """Stored K width of the stacked pools: the max per-layer ``k_width``
    (one width for every layer here: per-layer ranks are not ported)."""
    widths = [s.attn.k_width for s in layer_specs(cfg) if s.attn is not None]
    return max(widths) if widths else cfg.resolved_head_dim


def latent_score_width(cfg: ModelConfig) -> int:
    """Width of the always-resident latent-K sidecar of a tiered pool: the
    leading-d slice Loki's score pass reads, d = min(max(d_f·D, 8), kd) as
    in ``loki.loki_decode``, clamped to the stored K width. The sidecar's
    rows are bitwise copies of the leading columns of the stored
    (PCA-basis) keys, so scoring from it is the single-tier scoring."""
    d = max(int(cfg.loki.d_f * cfg.resolved_head_dim), 8)
    return min(d, max_k_width(cfg))


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
    instead of raising."""
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


def request_page_budget(cfg: ModelConfig, smax: int, page_size: int) -> int:
    """Max pages one request can hold at once: every full-attention layer
    keeps its whole prefix, so ceil(smax / page_size)."""
    if not has_paged_attn(cfg):
        return 0
    return -(-smax // page_size)
