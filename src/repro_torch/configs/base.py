"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``. The config is a
plain frozen dataclass (hashable -> usable as a jit static arg) and fully
determines parameter shapes, block composition and sharding-relevant dims.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0          # per-expert hidden dim
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba (S6) / xLSTM state settings."""
    state_dim: int = 16           # N: per-channel state size (mamba) / head qk dim (mlstm)
    expand: int = 2               # d_inner = expand * d_model (mamba)
    conv_width: int = 4
    n_heads: int = 4              # mlstm/slstm heads


#: storage bytes per element for each PageLayout dtype
LAYOUT_ITEMSIZE = {"fp32": 4, "fp16": 2, "bf16": 2, "int8": 1, "fp8": 1}
_LAYOUT_QMAX = {"int8": 127.0, "fp8": 448.0}   # fp8 = e4m3 max normal


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """Declarative physical layout of paged KV-cache components.

    Single source of truth for page allocation, the store path (prefill
    chunk / decode append) and every read path (XLA views and the Pallas
    decode kernels). One layout per CacheSpec component; ``StateSlot``
    stays full-precision native and takes no layout.

    dtype  — page storage dtype: fp32 | fp16 | bf16 | int8 | fp8 (e4m3).
             Quantized dtypes store one f32 amax scale per page next to
             the page table (Double Sparsity, arXiv 2408.07092).
    basis  — "native" stores keys as produced; "pca" stores keys already
             projected into the calibrated PCA basis (SALS, arXiv
             2510.24273). Exact at full rank by Lemma 4.1 (orthogonal P
             preserves q·k); queries are rotated at read time and the
             back-projection folds into the attention epilogue (softmax
             weights are basis-free, V stays native).
    rank   — latent K width under basis="pca": keep only the leading r
             PCA dims (0 = full head_dim). V is never truncated.
    scale_granularity — only "page" is implemented: one scale per
             physical page per pool (K and V scales are separate).
    """
    dtype: str = "fp32"
    basis: str = "native"
    rank: int = 0
    scale_granularity: str = "page"

    def __post_init__(self):
        if self.dtype not in LAYOUT_ITEMSIZE:
            raise ValueError(f"PageLayout dtype {self.dtype!r}; "
                             f"have {sorted(LAYOUT_ITEMSIZE)}")
        if self.basis not in ("native", "pca"):
            raise ValueError(f"PageLayout basis {self.basis!r}")
        if self.rank and self.basis != "pca":
            raise ValueError("PageLayout rank requires basis='pca'")
        if self.rank < 0:
            raise ValueError("PageLayout rank must be >= 0")
        if self.scale_granularity != "page":
            raise ValueError("only per-page scales are implemented")

    # ------------------------------------------------------------ queries

    @property
    def quantized(self) -> bool:
        return self.dtype in _LAYOUT_QMAX

    @property
    def qmax(self) -> float:
        """Largest representable magnitude of the quantized dtype."""
        return _LAYOUT_QMAX[self.dtype]

    @property
    def itemsize(self) -> int:
        return LAYOUT_ITEMSIZE[self.dtype]

    def k_width(self, head_dim: int) -> int:
        """Stored K feature width: latent rank under pca, else head_dim."""
        if self.basis == "pca" and self.rank:
            return min(self.rank, head_dim)
        return head_dim

    def bytes_per_page_row(self, head_dim: int, n_kv_heads: int) -> int:
        """K+V bytes of one token row (scales amortize over the page)."""
        per = self.itemsize * n_kv_heads
        return per * (self.k_width(head_dim) + head_dim)

    # ------------------------------------------------------------- parse

    @classmethod
    def parse(cls, s: str) -> "PageLayout":
        """Parse ``"fp16"`` / ``"fp16:pca"`` / ``"int8:pca:r=32"`` specs."""
        parts = [p for p in s.strip().split(":") if p]
        if not parts:
            return cls()
        dtype, basis, rank = parts[0], "native", 0
        for tok in parts[1:]:
            if tok in ("native", "pca"):
                basis = tok
            elif tok.startswith("r="):
                rank = int(tok[2:])
            else:
                raise ValueError(f"bad layout token {tok!r} in {s!r}")
        return cls(dtype=dtype, basis=basis, rank=rank)

    def describe(self) -> str:
        r = f":r={self.rank}" if self.rank else ""
        return f"{self.dtype}:{self.basis}{r}"


@dataclasses.dataclass(frozen=True)
class LokiConfig:
    """Paper technique knobs (Section 4)."""
    enabled: bool = False
    d_f: float = 0.25             # fraction of head_dim used for approximate scores
    k_f: float = 0.25             # fraction of tokens kept for exact attention
    transform: str = "pre"        # calibration covariance source: "pre"|"post" rotary
    block_size: int = 128         # block granularity of the TPU (Pallas) select path
    token_granular: bool = True   # XLA path: paper-faithful token-level top-k
    min_k: int = 16               # never select fewer than this many tokens
    local_window: int = 16        # always-keep recency window (attention-sink safety)
    # distributed selection: split the cache into n_chunks sequence chunks and
    # take top-(k/n_chunks) per chunk. Aligned with the kv_seq sharding this
    # keeps every gather shard-local (no cross-device cache movement) — the
    # TPU-native adaptation of the paper's token top-k (DESIGN.md §3).
    # 0 = global top-k (paper-faithful; GSPMD-hostile at scale).
    n_chunks: int = 0
    # decode-kernel backend for the block-granular path. The names are the
    # JAX package's, so configs and CLI flags read the same in both:
    #   "auto"   — the CUDA kernels for CUDA tensors, "xla" on the CPU
    #   "pallas" — the hand-written kernels (their plain versions on CPU)
    #   "xla"    — the plain per-head torch reference
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "model"
    family: str = "dense"         # dense|moe|hybrid|ssm|encdec|vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab: int = 256
    mlp: str = "swiglu"           # swiglu|geglu|sq_relu|gelu
    norm: str = "rms"             # rms|ln
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rope: bool = True
    sliding_window: int = 0       # 0 = disabled (mixtral SWA)
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    loki: LokiConfig = dataclasses.field(default_factory=LokiConfig)
    # physical layout of paged KV pages (serving); default is today's
    # fp32/native layout so training and the dense engine are untouched
    page_layout: PageLayout = dataclasses.field(default_factory=PageLayout)
    # per-layer latent-K ranks (Loki §4.2: the key spectrum varies by
    # layer). None = page_layout.rank everywhere; a tuple of n_layers ints
    # overrides the stored K width layer by layer (pca basis only). Pools
    # are allocated at the max width; narrower layers zero-mask the tail
    # dims at write time, which is self-consistent truncation (zeroed dims
    # contribute nothing to q̂·k̂).
    page_ranks: Optional[Tuple[int, ...]] = None
    # per-layer sliding windows for architectures that mix SWA and
    # full-attention layers (mixtral-SWA interleave, hymba's global/local
    # split). Entry i is layer i's window; 0 = full attention. None =
    # ``sliding_window`` uniformly. Layers with equal windows form one
    # page-table group (cache_spec.table_groups): window groups recycle
    # pages per layer while the full-attention group shares one table.
    window_layers: Optional[Tuple[int, ...]] = None
    # decode attention policy: full|loki|loki_block|exact_topk|pcaattn|h2o
    policy: str = "full"
    # hybrid: which layers are attention (hymba runs attn ∥ mamba inside a block)
    hybrid_parallel: bool = False
    # ssm (xlstm): 1-in-`slstm_every` blocks is an sLSTM block, rest mLSTM
    slstm_every: int = 0
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500           # whisper: fixed 30s -> 1500 frames
    # vlm
    vision_tokens: int = 0        # patch embeddings prepended by the stub frontend
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    def attn_policy(self) -> str:
        return self.policy

    def with_policy(self, policy: str, **loki_kw) -> "ModelConfig":
        lk = dataclasses.replace(
            self.loki, enabled=policy in ("loki", "loki_block"), **loki_kw)
        return dataclasses.replace(self, policy=policy, loki=lk)

    def with_loki(self, **kw) -> "ModelConfig":
        lk = dataclasses.replace(self.loki, enabled=True, **kw)
        return dataclasses.replace(self, policy="loki", loki=lk)

    def with_layout(self, layout) -> "ModelConfig":
        if isinstance(layout, str):
            layout = PageLayout.parse(layout)
        return dataclasses.replace(self, page_layout=layout)

    def with_ranks(self, ranks) -> "ModelConfig":
        """Per-layer latent-K ranks (forces a pca-basis layout)."""
        ranks = tuple(int(r) for r in ranks)
        if len(ranks) != self.n_layers:
            raise ValueError(f"page_ranks needs {self.n_layers} entries, "
                             f"got {len(ranks)}")
        if any(r <= 0 for r in ranks):
            raise ValueError("page_ranks entries must be positive")
        lay = self.page_layout
        if lay.basis != "pca":
            lay = dataclasses.replace(lay, basis="pca",
                                      rank=max(ranks))
        return dataclasses.replace(self, page_layout=lay,
                                   page_ranks=ranks)

    def layer_window(self, i: int) -> int:
        """Effective sliding window of layer ``i`` (0 = full attention)."""
        if self.window_layers is not None:
            return self.window_layers[i]
        return self.sliding_window

    def with_window_layers(self, windows) -> "ModelConfig":
        """Per-layer sliding windows (0 entries = full-attention layers)."""
        windows = tuple(int(w) for w in windows)
        if len(windows) != self.n_layers:
            raise ValueError(f"window_layers needs {self.n_layers} entries, "
                             f"got {len(windows)}")
        if any(w < 0 for w in windows):
            raise ValueError("window_layers entries must be >= 0")
        return dataclasses.replace(self, window_layers=windows)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: int = 0           # 0 = no accumulation
    remat: str = "none"           # none|full|dots
    z_loss: float = 1e-4
    seed: int = 0
    # distributed-optimization knobs
    grad_compression: str = "none"   # none|topk|int8 (cross-pod reduction)
    compression_ratio: float = 0.01  # topk: fraction of grads communicated
    nan_skip: bool = True            # skip steps with non-finite grads
