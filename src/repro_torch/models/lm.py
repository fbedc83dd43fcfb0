"""Language-model assembly (counterpart of ``repro.models.lm``) for every
family of the JAX package.

One parameter tree, the JAX package's layout (per-layer leaves stacked on a
leading L axis; the ssm family's heterogeneous layers a list of per-layer
trees), and its entry points:

  init(cfg, ...)                                   -> params
  forward(params, tokens, cfg, frames=, patches=, remat=) -> (logits, aux)
  prefill(params, cfg, tokens, smax, frames=, patches=)
                                                   -> (logits, cache, pos_len)
  decode_step(params, cfg, cache, token, pos_len)  -> (logits, cache)
  init_paged_cache(cfg, n_pages, page_size)        -> paged cache
  prefill_chunk(params, cfg, cache, tokens, pos_start, n_valid,
                page_table, page_size, slot=)      -> (logits, cache)
  decode_step(..., page_table=, page_size=)        -> (logits, cache)
  decode_step(..., slot_idx=)                       packed rows
  decode_step(..., live=)                           dead slots keep state
  encode_cross_kv(params, cfg, frames)             -> (k, v) per layer
  copy_cache_page(cfg, cache, src, dst, page_size)  -> cache (COW)
  init_paged_cache(..., device_pages=)              tiered pool
  decode_step(..., frame_table=)     -> (logits, winners, cache)
  prefill_chunk(..., frame_row=)     -> (logits, cache)
  promote_page_rows(cfg, cache, k_rows, v_rows, frame, page_size)

Caches are updated in place where the JAX code donated them. Block
composition:
  dense   [attn, mlp]
  moe     [attn, moe] (the MoE layer's leaves under ``p["moe"]`` in place
          of ``p["mlp"]``; ``forward`` returns its aux loss summed over
          layers)
  hybrid  [attn ∥ mamba, mlp] (hymba: the two heads' outputs each
          normalised by ``ln_ssm`` and averaged)
  ssm     [mlstm, mlp] or [slstm, mlp] (xlstm; no attention, no pages)
  encdec  encoder [attn, mlp] over stand-in frame embeddings + decoder
          [attn, cross-attn, mlp] (whisper; sinusoidal positions)
  vlm     the dense backbone, projected patch embeddings prepended in
          place of the prompt's last ``vision_tokens`` tokens (llava)
Each layer attends within its own window (``cfg.layer_window``); with
``cfg.window_layers`` the paged entry points take a rank-3 table
``(B, n_groups, max_pages)`` and each layer reads its page-table group's
row (``cache_spec.layer_group_ids``). ``cfg.page_ranks`` gives each layer
its own latent-K rank. The recurrent state (the StateSlot leaves, under
``"ssm"`` in a cache's layers) is float32 but for mamba's conv window.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, PageLayout
from repro_torch.core import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.serving import cache_spec as CS
from repro_torch.serving import paged_cache as PC


def _ffn(p, h, cfg: ModelConfig):
    """A layer's feed-forward half over (B,S,E) -> (y, aux): the MLP, or
    the capacity-routed MoE (``blocks.moe_apply``) with its aux loss."""
    if cfg.family == "moe":
        return B.moe_apply(p["moe"], h, cfg)
    return L.mlp_apply(p["mlp"], h, cfg), None


def _ffn_decode(p, h, cfg: ModelConfig):
    """The feed-forward half of one decode token (B,E): the MLP, or the
    per-token expert gather (``blocks.moe_decode``)."""
    if cfg.family == "moe":
        return B.moe_decode(p["moe"], h, cfg)
    return L.mlp_apply(p["mlp"], h, cfg)


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_key(prefix: str, k) -> str:
    return f"{prefix}/{k}" if prefix else str(k)


def tree_items(tree, prefix: str = ""):
    """(key, leaf) pairs of a tree of dicts, lists, tuples and
    NamedTuples, in the JAX tree's order (dict keys sorted). A key is the
    JAX checkpoint's: dict keys, list indices and ``.field`` for a
    NamedTuple's fields, joined by "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], _tree_key(prefix, k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from tree_items(getattr(tree, k), _tree_key(prefix, "." + k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, _tree_key(prefix, i))
    else:
        yield prefix, tree


def tree_rebuild(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, keys as
    ``tree_items`` gives them."""
    if isinstance(tree, dict):
        return {k: tree_rebuild(v, fn, _tree_key(prefix, k))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_rebuild(getattr(tree, k), fn,
                                         _tree_key(prefix, "." + k))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rebuild(v, fn, _tree_key(prefix, i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def layer_params(params, i: int):
    """Layer i's parameters: views into the stacked (L, ...) leaves, or
    the ssm family's own tree of layer i."""
    if isinstance(params["layers"], list):
        return params["layers"][i]
    return tree_map(lambda a: a[i], params["layers"])


def unbind_layers(params, n_layers: int, key: str = "layers"):
    """Every layer's parameters of ``params[key]`` (the decoder's, or the
    encoder's ``enc_layers``), each stacked leaf split once with
    ``unbind`` (the ssm family's list as it is). Under autograd the
    backward of ``unbind`` stacks the L gradients once, where L ``a[i]``
    selects would each write a zero-filled gradient the size of the whole
    stack."""
    if isinstance(params[key], list):
        return list(params[key])
    split = tree_map(lambda a: a.unbind(0), params[key])
    return [tree_map(lambda t: t[i], split) for i in range(n_layers)]


# --------------------------------------------------------------- init

#: leaves the JAX code casts to the activation dtype at every use; the
#: port casts them once (same values). The MoE router, mamba's ``a_log``,
#: the mLSTM's gate leaves ``w_if``/``b_if`` and the sLSTM's recurrent
#: ``r_gates``/``b_gates`` stay float32: the JAX code reads them so
CAST_LEAVES = {"table", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_in",
               "w_out", "vision_adapter", "in_proj", "conv_w", "x_proj",
               "dt_proj", "dt_bias", "d_skip", "out_proj", "wo_gate",
               "w_gates"}


def cast_params(params, cfg: ModelConfig):
    """Cast the matrices and biases to ``cfg.dtype`` once. Norm scales and
    biases, the ``pca`` projections and the leaves CAST_LEAVES leaves out
    stay float32, as the JAX code uses them."""
    dt = L.torch_dtype(cfg.dtype)

    def walk(tree):
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return {k: (walk(v) if isinstance(v, (dict, list))
                    else v.to(dt) if k in CAST_LEAVES else v)
                for k, v in tree.items()}
    return walk(params)


def _init_ffn(gen, cfg: ModelConfig, n: int, kind: str, kw):
    return (B.init_moe if kind == "moe" else L.init_mlp)(
        gen, cfg, n_layers=n, **kw)


def _init_recurrent(gen, cfg: ModelConfig, kind: str, *, device, kw):
    """One xlstm layer's tree (unstacked): ln1, its mLSTM or sLSTM block
    under ``ssm``, ln2 and an MLP of hidden width 2 d_model."""
    blk = B.init_mlstm if kind == "mlstm" else B.init_slstm
    return {"ln1": L.init_norm(cfg, device=device),
            "ssm": blk(gen, cfg, **kw),
            "ln2": L.init_norm(cfg, device=device),
            "mlp": L.init_mlp(gen, cfg, n_layers=None,
                              d_ff=2 * cfg.d_model, **kw)}


def _init_stack(gen, cfg: ModelConfig, n: int, kind: str, *, device, kw,
                ffn=None):
    """The stacked leaves of ``n`` layers of ``kind`` (dense|moe|dec|enc),
    the JAX tree's keys: ln1, attn, ln2 and mlp or moe; a decoder layer
    of the encoder-decoder also ln_x and its cross-attention xattn.
    ``ffn``: the feed-forward leaves if already drawn."""
    if ffn is None:
        ffn = _init_ffn(gen, cfg, n, kind, kw)
    p = {"ln1": L.init_norm(cfg, device=device, n_layers=n),
         "attn": B.init_attention(gen, cfg, n_layers=n, **kw),
         "ln2": L.init_norm(cfg, device=device, n_layers=n),
         ("moe" if kind == "moe" else "mlp"): ffn}
    if kind == "dec":
        p["ln_x"] = L.init_norm(cfg, device=device, n_layers=n)
        p["xattn"] = B.init_attention(gen, cfg, n_layers=n, **kw)
    if kind == "hybrid":
        p["ssm"] = B.init_mamba(gen, cfg, n_layers=n, **kw)
        p["ln_ssm"] = L.init_norm(cfg, device=device, n_layers=n)
    return p


def init(cfg: ModelConfig, *, seed: int = 0,
         generator: Optional[torch.Generator] = None, device=None,
         dtype: Optional[str] = None):
    """Random parameters: normal(0, 1/sqrt(fan_in)) matrices (embedding
    scale d_model**-0.5), unit norm scales, zero biases, identity PCA.
    The draws come from ``generator`` (or a fresh one seeded with
    ``seed``) on ``device``; they differ from ``jax.random``'s. The
    matrices are drawn in float32 and stored at ``dtype`` (default
    ``cfg.dtype``, what serving runs; the trainer keeps float32 masters,
    ``cfg.param_dtype``). The ssm family's layers are a list of per-layer
    trees (mLSTM or sLSTM, ``cache_spec.layer_kind``)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    kw = dict(dtype=L.torch_dtype(dtype or cfg.dtype), device=dev)
    kind = CS.layer_kind(cfg, 0)
    if not CS.uses_scan(cfg):
        return {"embed": L.init_embed(gen, cfg, **kw),
                "layers": [_init_recurrent(gen, cfg, CS.layer_kind(cfg, i),
                                           device=dev, kw=kw)
                           for i in range(cfg.n_layers)],
                "final_norm": L.init_norm(cfg, device=dev)}
    # draw order: the feed-forward leaves, the embedding, the rest
    ffn = _init_ffn(gen, cfg, cfg.n_layers, kind, kw)
    params = {"embed": L.init_embed(gen, cfg, **kw)}
    params["layers"] = _init_stack(gen, cfg, cfg.n_layers, kind, device=dev,
                                   kw=kw, ffn=ffn)
    if cfg.is_encoder_decoder:
        params["enc_layers"] = _init_stack(gen, cfg, cfg.enc_layers, "enc",
                                           device=dev, kw=kw)
        params["enc_norm"] = L.init_norm(cfg, device=dev)
    if cfg.vision_tokens:
        # the stub frontend: one linear adapter over precomputed patch
        # embeddings (the vision tower is out of scope, as in the JAX code)
        params["vision_adapter"] = L._init(gen, (cfg.d_model, cfg.d_model),
                                           **kw)
    params["final_norm"] = L.init_norm(cfg, device=dev)
    return params


# --------------------------------------------------------------- positions

@functools.lru_cache(maxsize=16)
def _sinusoid_table(s: int, d: int, device: torch.device):
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None]
    ang = pos / np.power(10000.0, 2 * i / d)
    return torch.as_tensor(np.concatenate([np.sin(ang), np.cos(ang)],
                                          axis=-1), dtype=torch.float32,
                           device=device)[None]


def _sinusoidal(s: int, d: int, device) -> torch.Tensor:
    """(1, s, d) float32 sinusoidal positions 0..s-1, computed in float64
    on the host as the JAX code does, made once per (s, d, device)."""
    return _sinusoid_table(s, d, torch.device(device))


def _sinusoidal_at(pos, d: int) -> torch.Tensor:
    """(N, d) float32 sinusoids at positions ``pos`` (N,), computed on
    ``pos``'s device (no host round trip)."""
    i = torch.arange(d // 2, device=pos.device)[None]
    ang = pos[:, None].float() / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _adds_sinusoids(cfg: ModelConfig) -> bool:
    """Decoders without rotary positions, and the encoder-decoder's
    decoder, add sinusoids to the token embeddings; the ssm family, whose
    recurrence orders its tokens, adds none."""
    return (not cfg.rope or cfg.is_encoder_decoder) and cfg.family != "ssm"


def _embed_inputs(params, tokens, cfg: ModelConfig, patches=None):
    """Token embeddings (B,S,E) with the vlm's projected patches in place
    of the last ``vision_tokens`` tokens and the sinusoids added."""
    x = L.embed_apply(params["embed"], tokens, cfg)
    s = tokens.shape[1]
    if cfg.vision_tokens and patches is not None:
        vis = L.dot(patches.to(x.dtype), params["vision_adapter"])
        x = torch.cat([vis, x[:, :s - cfg.vision_tokens]], dim=1)
    if _adds_sinusoids(cfg):
        x = x + _sinusoidal(s, cfg.d_model, x.device).to(x.dtype)
    return x


# --------------------------------------------------------------- encoder

def _encode(params, frames, cfg: ModelConfig):
    """The whisper encoder over stand-in frame embeddings (B,S_enc,E):
    sinusoids, then non-causal [attn, mlp] layers and ``enc_norm``."""
    if frames is None:
        raise ValueError(f"{cfg.arch}: the encoder-decoder needs frames "
                         "(B, enc_seq, d_model)")
    x = frames.to(L.torch_dtype(cfg.dtype))
    x = x + _sinusoidal(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    for p in unbind_layers(params, cfg.enc_layers, "enc_layers"):
        h = L.norm_apply(p["ln1"], x)
        x = x + B.encoder_attn_train(p["attn"], h, cfg)
        h = L.norm_apply(p["ln2"], x)
        x = x + L.mlp_apply(p["mlp"], h, cfg)
    return L.norm_apply(params["enc_norm"], x)


def _enc_kv(p, enc_x, cfg: ModelConfig):
    """A decoder layer's cross (k, v) of the encoder's hidden states."""
    _, k, v = B._qkv(p["xattn"], enc_x, cfg)
    return k, v


def _cross_train(p, x, ek, ev, cfg: ModelConfig):
    """The decoder's cross-attention residual over encoder K/V (B,S,E)."""
    h = L.norm_apply(p["ln_x"], x)
    q, _, _ = B._qkv(p["xattn"], h, cfg)
    o = A.cross_attention(q, ek.to(q.dtype), ev.to(q.dtype))
    b, s = x.shape[:2]
    return L.dot(o.reshape(b, s, cfg.q_dim).to(x.dtype), p["xattn"]["wo"])


@torch.no_grad()
def encode_cross_kv(params, cfg: ModelConfig, frames):
    """Encoder K/V for every decoder layer (the CrossAttnStatic
    component): the encoder runs once over ``frames (B, enc_seq,
    d_model)`` and each decoder layer's cross-attention projects it.
    Returns (k, v), each (L, B, enc_seq, Hkv, D)."""
    enc_x = _encode(params, frames, cfg)
    kv = [_enc_kv(layer_params(params, i), enc_x, cfg)
          for i in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


# --------------------------------------------------------------- forward

def _hybrid_mix(p, a, s):
    """hymba's fusion of its parallel heads: the attention and SSM outputs
    each normalised by ``ln_ssm``, then averaged."""
    return 0.5 * (L.norm_apply(p["ln_ssm"], a)
                  + L.norm_apply(p["ln_ssm"], s))


def _recurrent_train(p, x, cfg: ModelConfig, kind: str):
    """One xlstm layer of the teacher-forced forward -> (x, None)."""
    h = L.norm_apply(p["ln1"], x)
    fn = B.mlstm_train if kind == "mlstm" else B.slstm_train
    x = x + fn(p["ssm"], h, cfg)
    h = L.norm_apply(p["ln2"], x)
    return x + L.mlp_apply(p["mlp"], h, cfg), None


def _block_train(p, x, positions, cfg: ModelConfig, window: int,
                 enc_x=None, capture=None):
    """One layer of the teacher-forced forward -> (x, aux or None):
    self-attention within ``window`` (beside mamba for the hybrid), the
    cross-attention over the encoder output ``enc_x`` (encoder-decoder),
    the feed-forward half."""
    h = L.norm_apply(p["ln1"], x)
    a = B.attn_train(p["attn"], h, positions, cfg, capture=capture,
                     sliding_window=window)
    if "ssm" in p:
        a = _hybrid_mix(p, a, B.mamba_train(p["ssm"], h, cfg))
    x = x + a
    if enc_x is not None:
        x = x + _cross_train(p, x, *_enc_kv(p, enc_x, cfg), cfg)
    h = L.norm_apply(p["ln2"], x)
    y, a = _ffn(p, h, cfg)
    return x + y, a


#: the matmul outputs ``remat="dots"`` keeps (JAX's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    """``fn`` under the remat policy: "none" keeps every activation,
    "full" recomputes the layer in the backward (JAX's
    nothing_saveable), "dots" keeps the matmul outputs and recomputes the
    rest (checkpoint_dots)."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be none, full or dots, got {remat!r}")


def forward(params, tokens, cfg: ModelConfig, *, frames=None,
            patches=None, remat: str = "none", capture_keys: bool = False):
    """Teacher-forced forward -> (logits (B,S,V), aux), aux the MoE layers'
    aux losses summed over layers (0 for the dense family).

    ``remat`` ("none", "full", "dots"): what each layer keeps for the
    backward (``_remat``), as the JAX scan's ``jax.checkpoint`` policy.
    ``capture_keys`` also returns (pre, post, q): pre/post-rotary keys
    (L,B,S,Hkv,D) and post-rotary queries (L,B,S,H,D) for PCA
    calibration; like the reference's unrolled loop it runs without
    remat. Differentiable: the trainer calls it on its float32 masters
    cast inside the differentiated function (``training/step.py``).

    ``frames (B, enc_seq, d_model)``: the encoder-decoder's stand-in
    encoder input (required there). ``patches (B, vision_tokens,
    d_model)``: the vlm's patch embeddings, projected by the adapter and
    put in place of the prompt's last ``vision_tokens`` tokens. Each layer
    attends within ``cfg.layer_window(i)``; the JAX code's forward and
    prefill use ``cfg.sliding_window`` for every layer, which differs only
    under ``window_layers``, where its decode uses the per-layer windows
    and so disagrees with its own prefill. The ssm family has no keys to
    capture: (None, None, None)."""
    x = _embed_inputs(params, tokens, cfg, patches)
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    enc_x = _encode(params, frames, cfg) if cfg.is_encoder_decoder else None
    captures = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mode = "none" if capture_keys else remat
    block = _remat(_block_train, mode)
    recurrent = _remat(_recurrent_train, mode)
    for i, p in enumerate(unbind_layers(params, cfg.n_layers)):
        kind = CS.layer_kind(cfg, i)
        if kind in ("mlstm", "slstm"):
            x, _ = recurrent(p, x, cfg, kind)
            continue
        cap = {} if capture_keys else None
        x, a = block(p, x, positions, cfg, cfg.layer_window(i), enc_x, cap)
        if a is not None:
            aux = aux + a
        if cap is not None:
            captures.append(cap)
    x = L.norm_apply(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x, cfg)
    if capture_keys:
        return logits, aux, tuple(
            torch.stack([c[n] for c in captures]) if captures else None
            for n in ("pre", "post", "q"))
    return logits, aux


# --------------------------------------------------------------- caches

def init_cache(cfg: ModelConfig, batch: int, smax: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Stacked (L, B, Smax, Hkv, D) decode cache for the whole model
    (``h2o``: its budgeted state, ``blocks.init_attn_cache``); the
    encoder-decoder also keeps each slot's cross K/V, ``cross_k`` and
    ``cross_v`` (L, B, enc_seq, Hkv, D), the hybrid each slot's mamba
    state under ``ssm`` (L, B, ...). The ssm family's cache is a list of
    per-layer ``{"ssm": ...}`` (its mLSTM or sLSTM state, (B, ...))."""
    dev = resolve_device(device)
    specs = CS.layer_specs(cfg)
    if not CS.uses_scan(cfg):
        return {"layers": [{"ssm": CS.state_slot_init(cfg, s.state, batch,
                                                      dtype, dev)}
                           for s in specs]}
    layers = {"attn": B.init_attn_cache(cfg, batch, smax, dtype, dev,
                                        n_layers=cfg.n_layers)}
    if specs[0].state is not None:
        layers["ssm"] = CS.state_slot_init(cfg, specs[0].state, batch,
                                           dtype, dev, n_layers=cfg.n_layers)
    if cfg.is_encoder_decoder:
        for name in ("cross_k", "cross_v"):
            layers[name] = torch.zeros(
                (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim), dtype=dtype, device=dev)
    return {"layers": layers}


def layer_cache(cache, i: int):
    """Layer i's cache leaves ({"k","v"}, or h2o's state): views, so
    writes land in the stacked cache."""
    return tree_map(lambda a: a[i], cache["layers"]["attn"])


def state_cache(cache, i: int):
    """Layer i's StateSlot leaves, slot axis first (views), or None."""
    layers = cache["layers"]
    if isinstance(layers, list):
        return layers[i].get("ssm")
    if "ssm" not in layers:
        return None
    return tree_map(lambda a: a[i], layers["ssm"])


def slot_view(cache, lo: int, hi: int):
    """The cache of slots [lo, hi): every leaf but the pooled attention of
    a paged cache is sliced on its slot axis (views, so writes land in
    the cache)."""
    layers = cache["layers"]
    if isinstance(layers, list):
        return {"layers": tree_map(lambda a: a[lo:hi], layers)}
    return {"layers": tree_map(lambda a: a[:, lo:hi], layers)}


def _put_state(dst, new) -> None:
    """Copy a block's new state into the cache's state views ``dst``."""
    for k, t in new.items():
        dst[k].copy_(t.to(dst[k].dtype))


@torch.no_grad()
def install_cross_kv(cfg: ModelConfig, cache, slot: int, ck, cv):
    """Write one request's cross K/V, ``ck``/``cv`` (L, 1, enc_seq, Hkv,
    D) from ``encode_cross_kv``, into its slot of a paged cache, in place
    (the CrossAttnStatic lifecycle: once, at admission). A quantized
    layout stores codes with one amax scale per (layer, slot), as the
    reference's scheduler does; being written once, the slot needs no
    read-modify-write. Returns the cache."""
    layers = cache["layers"]
    for name, x in (("cross_k", ck), ("cross_v", cv)):
        dst = layers[name][:, slot]
        x = x[:, 0].float()
        if name + "_scale" in layers:
            qmax = cfg.page_layout.qmax
            amax = x.abs().amax(dim=tuple(range(1, x.ndim)))        # (L,)
            scale = torch.clamp(amax, min=PC.QUANT_EPS) / qmax
            layers[name + "_scale"][:, slot] = scale
            x = PC.quantize_rows(
                x, scale.reshape((-1,) + (1,) * (x.ndim - 1)), dst.dtype,
                qmax)
        dst.copy_(x.to(dst.dtype))
    return cache


def _cross_rows(cache, i: int, slots=None):
    """Layer i's cross K/V of the step's rows as float32 when quantized
    (the codes times their slot's scale), else as stored. ``slots``: the
    rows' slot ids (None: every slot, in order)."""
    lay = cache["layers"]
    ck, cv = lay["cross_k"][i], lay["cross_v"][i]
    if slots is not None:
        ck, cv = ck[slots], cv[slots]
    if "cross_k_scale" in lay:
        ks, vs = lay["cross_k_scale"][i], lay["cross_v_scale"][i]
        if slots is not None:
            ks, vs = ks[slots], vs[slots]
        ck = ck.float() * ks[:, None, None, None]
        cv = cv.float() * vs[:, None, None, None]
    return ck, cv


def _cross_decode(p, x, ck, cv, cfg: ModelConfig, n_rows: int):
    """The decoder's cross-attention residual of one decode token: x
    (rows,E), of which the first ``n_rows`` are the step's; every encoder
    row is attended (``attention.decode_full`` at cur_len = enc_seq, with
    no length tensor to build). Plain torch: the JAX code's is jnp."""
    rows = x.shape[0]
    h = L.norm_apply(p["ln_x"], x)
    q, _, _ = B._qkv(p["xattn"], h[:, None], cfg)
    q = q[:n_rows, 0]                                     # (b,H,D)
    scores = A.decode_scores(q, ck)
    w = torch.softmax(scores, dim=-1).to(cv.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", w, cv).reshape(n_rows, cfg.q_dim)
    o = F.pad(o.to(x.dtype), (0, 0, 0, rows - n_rows))
    return L.dot(o, p["xattn"]["wo"])


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, smax: int, *, frames=None,
            patches=None, cache_dtype=torch.bfloat16, cache=None):
    """Process a prompt -> (logits_last (B,V), cache, pos_len (B,)).

    ``cache``: an existing (L, B, Smax, ...) cache (or a view of some of
    its slots, ``slot_view``) to fill in place instead of allocating a new
    one. ``frames``/``patches`` as ``forward`` takes them; the
    encoder-decoder writes each layer's cross K/V into the cache, the
    hybrid and ssm families each layer's final recurrent state (the ssm
    family's layers keep the carry of their train-path recurrences, as
    JAX's prefill does)."""
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, smax, cache_dtype, device=tokens.device)
    x = _embed_inputs(params, tokens, cfg, patches)
    positions = torch.arange(s, device=tokens.device)[None]
    enc_x = _encode(params, frames, cfg) if cfg.is_encoder_decoder else None
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        h = L.norm_apply(p["ln1"], x)
        kind = CS.layer_kind(cfg, i)
        if kind in ("mlstm", "slstm"):
            fn = B.mlstm_train if kind == "mlstm" else B.slstm_train
            y, st = fn(p["ssm"], h, cfg, return_state=True)
            _put_state(state_cache(cache, i), st)
            x = x + y
            x = x + L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], x), cfg)
            continue
        a = B.attn_prefill(p["attn"], layer_cache(cache, i), h, positions,
                           cfg, sliding_window=cfg.layer_window(i))
        if kind == "hybrid":
            sy, st = B.mamba_prefill(p["ssm"], h, cfg)
            _put_state(state_cache(cache, i), st)
            a = _hybrid_mix(p, a, sy)
        x = x + a
        if enc_x is not None:
            ek, ev = _enc_kv(p, enc_x, cfg)
            for name, t in (("cross_k", ek), ("cross_v", ev)):
                dst = cache["layers"][name][i]
                dst.copy_(t.to(dst.dtype))
            x = x + _cross_train(p, x, ek, ev, cfg)
        h = L.norm_apply(p["ln2"], x)
        x = x + _ffn(p, h, cfg)[0]
    x = L.norm_apply(params["final_norm"], x[:, -1:])
    logits = L.unembed_apply(params["embed"], x, cfg)[:, 0]
    pos_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, cache, pos_len


class _StepState:
    """One decode step's view of a layer's StateSlot leaves: the rows the
    step computes (every slot, or the packed slots ``slots`` gathered with
    zero rows appended up to the step's row count) and the write back of
    the rows' new state. ``live`` (the step's B rows, bool): a dead row's
    state is written back as it was (mid-prefill and idle slots, a packed
    step's pad slots); the appended rows are never written back (they
    stand for no slot)."""

    def __init__(self, leaves, slots, live, n_rows: int, rows: int):
        self.leaves, self.slots, self.live = leaves, slots, live
        self.n_rows = n_rows
        self.old = (leaves if slots is None else
                    {k: v.index_select(0, slots) for k, v in leaves.items()})
        self.rows = self.old if rows == n_rows else {
            k: F.pad(v, (0, 0) * (v.ndim - 1) + (0, rows - n_rows))
            for k, v in self.old.items()}

    def commit(self, new) -> None:
        for k, full in self.leaves.items():
            nw = new[k][:self.n_rows].to(full.dtype)
            if self.live is not None:
                m = self.live.reshape((-1,) + (1,) * (nw.ndim - 1))
                nw = torch.where(m, nw, self.old[k])
            if self.slots is None:
                full.copy_(nw)
            else:
                full.index_copy_(0, self.slots, nw)


def _recurrent_decode(p, x, cfg: ModelConfig, kind: str, state: _StepState):
    """One xlstm layer's decode step over x (rows,E)."""
    h = L.norm_apply(p["ln1"], x)
    fn = B.mlstm_decode if kind == "mlstm" else B.slstm_decode
    y, new = fn(p["ssm"], state.rows, h, cfg)
    state.commit(new)
    x = x + y
    return x + L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], x), cfg)


def _layer_decode(p, c, x, pos_len, cfg: ModelConfig, *, page_table=None,
                  page_size: int = 0, frame_table=None, plan_rows=None,
                  n_rows=None, window=None, rank=None, cross=None,
                  state=None):
    """One layer's decode step -> (x, winners or None). ``cross``: the
    step rows' cross (k, v) of an encoder-decoder layer; ``state``: the
    hybrid's ``_StepState``, whose mamba heads run beside attention."""
    h = L.norm_apply(p["ln1"], x)
    y = B.attn_decode(p["attn"], c, h, pos_len, cfg, page_table=page_table,
                      page_size=page_size, frame_table=frame_table,
                      plan_rows=plan_rows, n_rows=n_rows,
                      sliding_window=window, rank=rank)
    win = None
    if frame_table is not None:
        y, win = y
    if state is not None:
        s, new = B.mamba_decode(p["ssm"], state.rows, h, cfg)
        state.commit(new)
        y = _hybrid_mix(p, y, s)
    x = x + y
    if cross is not None:
        x = x + _cross_decode(p, x, *cross, cfg,
                              x.shape[0] if n_rows is None else n_rows)
    h = L.norm_apply(p["ln2"], x)
    return x + _ffn_decode(p, h, cfg), win


def _check_slot_idx(slot_idx, batch: int) -> None:
    """``slot_idx`` of a packed step: (B,) integer slot ids, distinct and
    non-negative (checked where that costs no host sync)."""
    if (slot_idx.ndim != 1 or slot_idx.shape[0] != batch
            or slot_idx.dtype.is_floating_point):
        raise ValueError(f"slot_idx must be ({batch},) integer slot ids, "
                         f"got {tuple(slot_idx.shape)} {slot_idx.dtype}")
    if slot_idx.device.type == "cpu" and (
            int(slot_idx.min()) < 0
            or torch.unique(slot_idx).numel() != batch):
        raise ValueError(f"slot_idx must hold distinct slot ids, got "
                         f"{slot_idx.tolist()}")


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, token, pos_len, *,
                page_table=None, page_size: int = 0, live=None,
                frame_table=None, slot_idx=None, plan_slots=None):
    """One generation step. token (B,) int; pos_len (B,) tokens cached.
    Returns (logits (B,V) float32, cache) — the cache updated in place.

    With ``page_table (B, max_pages)``/``page_size`` the cache is the
    pooled layout of ``init_paged_cache`` and every layer's reads and
    writes resolve through the table.

    ``slot_idx (B,)`` integer, gather-packed decode: the batch rows are a
    compaction of the engine's slots (distinct slot ids), and the table,
    tokens and positions arrive packed. The dense family keeps no
    per-slot state, so the reference's gather and scatter of per-slot
    components is empty here: the pooled K/V is addressed through the
    table alone. Distinctness is checked on a host tensor only (on the
    card the check would cost a host sync).

    The StateSlot families gather their packed slots' recurrent state
    before the layers and scatter the advanced state back after, as the
    reference does (``_StepState``).

    ``live (B,)`` bool: rows whose slots are dead this step (idle,
    mid-prefill, over the decode budget, a packed step's pad rows) keep
    their recurrent state: their K/V writes land on the trash page, but
    state has no trash row. Ignored by the families without state.

    ``plan_slots`` (an int): the engine's slot count. A packed step of B <
    plan_slots rows computes each slot as the engine's full-width (masked)
    step does, so the two agree bit for bit: the decode kernels plan
    their split count and cluster size for ``plan_slots x Hkv`` rows, and
    the row-wise ops (norms, projections, MLP or MoE, the recurrent
    blocks, unembedding) run over plan_slots rows, zero rows (and zero
    states) appended, only the attention over the B rows. On the card
    those ops' kernels, and so their rounding, follow the row count (an
    RMSNorm's mean over 2 rows and over 4 can round apart); their cost at
    decode is the weights' bytes, which the rows do not change. None: the
    step's own B.

    ``frame_table (B, max_pages)`` (tiered pools): each table entry's
    device frame (0, the trash frame, for HOST pages). The return becomes
    (logits, winners, cache), ``winners (B, max_pages)`` bool the union
    over layers of the logical pages the Loki selection attended: the
    scheduler promotes HOST winners and re-runs those slots.

    With ``cfg.window_layers`` the table is rank 3, ``(B, n_groups,
    max_pages)``: each layer reads its page-table group's row and attends
    within its own window. The encoder-decoder reads each row's cross K/V
    from its slot (``slot_idx``, or the row's own index). Tiered pools
    with page-table groups raise (the JAX code refuses them too)."""
    if slot_idx is not None:
        _check_slot_idx(slot_idx, token.shape[0])
    tables = _layer_tables(cfg, page_table)
    if frame_table is not None and page_table.ndim == 3:
        raise ValueError("tiered pools do not compose with per-layer "
                         "window groups (window_layers)")
    ranks = cfg.page_ranks if page_table is not None else None
    b = token.shape[0]
    rows = b if plan_slots is None else max(int(plan_slots), b)
    plan_rows = None if plan_slots is None else rows * cfg.n_kv_heads
    x = L.embed_apply(params["embed"], token, cfg)
    if _adds_sinusoids(cfg):
        x = x + _sinusoidal_at(pos_len.expand(b), cfg.d_model).to(x.dtype)
    x = F.pad(x, (0, 0, 0, rows - b))
    slots = None if slot_idx is None else slot_idx.long()
    winners = None
    for i in range(cfg.n_layers):
        leaves = state_cache(cache, i)
        state = (None if leaves is None
                 else _StepState(leaves, slots, live, b, rows))
        kind = CS.layer_kind(cfg, i)
        if kind in ("mlstm", "slstm"):
            x = _recurrent_decode(layer_params(params, i), x, cfg, kind,
                                  state)
            continue
        cross = (_cross_rows(cache, i, slots) if cfg.is_encoder_decoder
                 else None)
        x, win = _layer_decode(layer_params(params, i),
                               layer_cache(cache, i), x, pos_len, cfg,
                               page_table=tables[i], page_size=page_size,
                               frame_table=frame_table, plan_rows=plan_rows,
                               n_rows=b, window=cfg.layer_window(i),
                               rank=None if ranks is None else ranks[i],
                               cross=cross, state=state)
        if win is not None:
            winners = win if winners is None else winners | win
    x = L.norm_apply(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x, cfg)[:b]
    if frame_table is not None:
        return logits, winners, cache
    return logits, cache


def _layer_tables(cfg: ModelConfig, page_table):
    """Each layer's (B, max_pages) table: the table itself, or its
    page-table group's row of a rank-3 ``(B, n_groups, max_pages)``
    table (made contiguous once per group)."""
    if page_table is None or page_table.ndim == 2:
        return [page_table] * cfg.n_layers
    n = CS.n_table_groups(cfg)
    if page_table.ndim != 3 or page_table.shape[1] != n:
        raise ValueError(f"{cfg.arch}: a rank-3 page table must be (B, "
                         f"{n} groups, max_pages), got "
                         f"{tuple(page_table.shape)}")
    rows = [page_table[:, g].contiguous() for g in range(n)]
    return [rows[g] for g in CS.layer_group_ids(cfg)]


# --------------------------------------------------------------- paged

def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, n_slots: int = 1,
                     device_pages: Optional[int] = None, device=None):
    """Paged decode cache: per layer a shared pool
    (n_pages * page_size, Hkv, W) of K and of V, stacked on a leading L
    axis, no batch dim; requests map logical positions to pool rows through
    per-slot page tables. Memory follows the page budget, not
    n_slots * smax. ``n_slots`` sizes per-slot state, which the dense
    family has none of.

    The layout (``cfg.page_layout``) sets the pools' storage dtype and the
    key width W (rank r under the pca basis); the default layout keeps the
    caller's ``dtype``, as the reference does. Quantized layouts (int8,
    fp8) add (L, n_pages) float32 ``k_scale``/``v_scale`` sidecars, zero
    until a page is written.

    ``device_pages`` makes the pool tiered: the K and V pools shrink to
    ``device_pages`` frames while an always-resident latent-K sidecar
    ``k_lat`` (L, n_pages * page_size, Hkv, d) keeps the leading
    ``cache_spec.latent_score_width`` columns of every logical page's
    (PCA-basis) keys, so Loki's score pass never needs the host tier. Like
    the reference it refuses quantized layouts: their writes re-derive
    per-page scales, which a tiered step's re-run would not repeat bit for
    bit. Per-layer ranks on a tiered pool are not ported yet (ROADMAP
    queue 1 item 8).

    Per-layer ranks (``page_ranks``): every layer's pool is as wide as the
    widest layer's rank (``cache_spec.max_k_width``); narrower layers zero
    their tail columns at write time. The encoder-decoder adds each
    slot's cross K/V (the CrossAttnStatic component), ``cross_k`` and
    ``cross_v`` (L, n_slots, enc_seq, Hkv, D), written at admission, with
    (L, n_slots) float32 ``cross_k_scale``/``cross_v_scale`` under a
    quantized layout. The StateSlot families add each slot's recurrent
    state under ``ssm`` (``cache_spec.state_slot_init``: the hybrid's
    stacked (L, n_slots, ...), the ssm family's per layer in a list of
    ``{"ssm": ...}``, which holds no pages at all)."""
    CS.assert_pageable(cfg)
    B.check_policy(cfg)
    specs = CS.layer_specs(cfg)
    dev = resolve_device(device)
    if not CS.uses_scan(cfg):
        return {"layers": [{"ssm": CS.state_slot_init(cfg, s.state, n_slots,
                                                      dtype, dev)}
                           for s in specs]}
    spec = specs[0].attn
    lay = spec.layout
    if device_pages is not None:
        if not 2 <= device_pages <= n_pages:
            raise ValueError(f"device_pages {device_pages} must be in "
                             f"[2, n_pages={n_pages}]")
        if lay.quantized:
            raise ValueError("tiered pools require a non-quantized "
                             "PageLayout (per-page scale RMW is not "
                             "replay-idempotent)")
        if cfg.page_ranks is not None:
            raise NotImplementedError(
                "per-layer ranks on a tiered pool are not ported yet "
                "(ROADMAP queue 1 item 8)")

    def pool_dtype(lay):
        return dtype if lay == PageLayout() else PC.STORAGE_DTYPE[lay.dtype]
    pdt = pool_dtype(lay)
    rows = (n_pages if device_pages is None else device_pages) * page_size
    lead = (cfg.n_layers, rows, spec.n_kv_heads)
    attn = {"k": torch.zeros(lead + (CS.max_k_width(cfg),), dtype=pdt,
                             device=dev),
            "v": torch.zeros(lead + (spec.head_dim,), dtype=pdt,
                             device=dev)}
    if device_pages is not None:
        attn["k_lat"] = torch.zeros(
            (cfg.n_layers, n_pages * page_size, spec.n_kv_heads,
             CS.latent_score_width(cfg)), dtype=pdt, device=dev)
    if lay.quantized:
        for name in ("k_scale", "v_scale"):
            attn[name] = torch.zeros((cfg.n_layers, n_pages),
                                     dtype=torch.float32, device=dev)
    layers = {"attn": attn}
    if specs[0].state is not None:
        layers["ssm"] = CS.state_slot_init(cfg, specs[0].state, n_slots,
                                           dtype, dev, n_layers=cfg.n_layers)
    cross = specs[0].cross
    if cross is not None:
        for name in ("cross_k", "cross_v"):
            layers[name] = torch.zeros(
                (cfg.n_layers, n_slots, cross.enc_seq, cross.n_kv_heads,
                 cross.head_dim), dtype=pool_dtype(cross.layout), device=dev)
        if cross.layout.quantized:
            for name in ("cross_k_scale", "cross_v_scale"):
                layers[name] = torch.zeros((cfg.n_layers, n_slots),
                                           dtype=torch.float32, device=dev)
    return {"layers": layers}


@torch.no_grad()
def prefill_chunk(params, cfg: ModelConfig, cache, tokens, pos_start: int,
                  n_valid: int, page_table, page_size: int, *, slot=None,
                  frame_row=None):
    """One step of a paged, chunked prefill for a single request.

    tokens (1, C): a fixed-size chunk whose first ``n_valid`` entries are
    real prompt tokens at logical positions ``pos_start ..
    pos_start+C-1`` (the rest is padding, written to the trash page).
    page_table (1, max_pages) or (max_pages,); with ``cfg.window_layers``
    (1, n_groups, max_pages) or (n_groups, max_pages), each layer taking
    its page-table group's row. Each layer scatters the chunk's K/V into
    the pools in place and attends causally, within its own window, over
    the cached prefix plus the chunk. Returns (logits (1, V) of chunk
    token ``n_valid - 1``, cache). ``slot`` (an int): the request's slot,
    whose cross K/V (written at admission) the encoder-decoder's chunk
    attends, and whose recurrent state (the hybrid's mamba, the ssm
    family's mLSTM and sLSTM) the chunk carries on: pad tokens leave it
    as it was, so chunked prefill gives the one-shot recurrence. The ssm
    family has no pages: its chunk runs the recurrences alone.
    ``frame_row (max_pages,)`` or (1, max_pages) (tiered pools): each
    table entry's device frame; K/V go through it, the latent sidecar
    through the table."""
    CS.assert_pageable(cfg)
    if frame_row is not None and frame_row.ndim == 2:
        frame_row = frame_row[0]
    if cfg.window_layers is not None:
        table_row = page_table[0] if page_table.ndim == 3 else page_table
    else:
        table_row = page_table[0] if page_table.ndim == 2 else page_table
    if table_row.ndim == 2:
        groups = [table_row[g] for g in range(table_row.shape[0])]
        rows = [groups[g] for g in CS.layer_group_ids(cfg)]
    else:
        rows = [table_row] * cfg.n_layers
    ranks = cfg.page_ranks
    slot = 0 if slot is None else int(slot)
    b, c = tokens.shape
    x = L.embed_apply(params["embed"], tokens, cfg)
    if _adds_sinusoids(cfg):
        positions = pos_start + torch.arange(c, device=tokens.device)
        x = x + _sinusoidal_at(positions, cfg.d_model)[None].to(x.dtype)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        h = L.norm_apply(p["ln1"], x)
        kind = CS.layer_kind(cfg, i)
        st = state_cache(cache, i)
        if st is not None:
            st = {k: v[slot:slot + 1] for k, v in st.items()}
        if kind in ("mlstm", "slstm"):
            fn = B.mlstm_train if kind == "mlstm" else B.slstm_train
            y, new = fn(p["ssm"], h, cfg, return_state=True,
                        initial_state=st, n_valid=n_valid)
            _put_state(st, new)
            x = x + y
            x = x + L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], x), cfg)
            continue
        a = B.attn_prefill_chunk(p["attn"], layer_cache(cache, i), h,
                                 pos_start, n_valid, cfg,
                                 table_row=rows[i], page_size=page_size,
                                 frame_row=frame_row,
                                 rank=None if ranks is None else ranks[i],
                                 sliding_window=cfg.layer_window(i))
        if kind == "hybrid":
            sy, new = B.mamba_prefill_chunk(p["ssm"], st, h, n_valid, cfg)
            _put_state(st, new)
            a = _hybrid_mix(p, a, sy)
        x = x + a
        if cfg.is_encoder_decoder:
            ek, ev = _cross_rows(cache, i, slice(slot, slot + 1))
            x = x + _cross_train(p, x, ek, ev, cfg)
        h = L.norm_apply(p["ln2"], x)
        x = x + _ffn(p, h, cfg)[0]
    x = L.norm_apply(params["final_norm"], x[:, n_valid - 1:n_valid])
    logits = L.unembed_apply(params["embed"], x, cfg)[:, 0]
    return logits, cache


@torch.no_grad()
def copy_cache_page(cfg: ModelConfig, cache, src_page: int, dst_page: int,
                    page_size: int, src_frame=None, dst_frame=None):
    """Copy-on-write over a paged cache, in place: physical page ``src``'s
    rows into ``dst`` in every layer's K and V pool, and the page's scales
    when the layout is quantized (the codes dequantize as the donor's only
    at the donor's scale). The scheduler calls it before a request that
    shares a cached tail page writes into it; the page ids are host ints.
    On a tiered pool the K/V rows move between ``src_frame`` and
    ``dst_frame`` (both pages RESIDENT) and the latent sidecar by page.
    Returns the cache."""
    attn = cache["layers"]["attn"]
    if src_frame is not None:
        for name in ("k", "v"):
            PC.copy_page_rows(attn[name], src_frame, dst_frame, page_size)
        PC.copy_page_rows(attn["k_lat"], src_page, dst_page, page_size)
        return cache
    for name in ("k", "v"):
        PC.copy_page_rows(attn[name], src_page, dst_page, page_size)
    if cfg.page_layout.quantized:
        for name in ("k_scale", "v_scale"):
            PC.copy_page_scale(attn[name], src_page, dst_page)
    return cache


@torch.no_grad()
def promote_page_rows(cfg: ModelConfig, cache, k_rows, v_rows, frame: int,
                      page_size: int):
    """Land a promoted page's full-D rows in its staging frame, in place:
    ``k_rows (L, page_size, Hkv, kw)``/``v_rows (L, page_size, Hkv, D)``
    are the bytes taken at demotion, ``frame`` the frame
    ``PagePool.promote_begin`` gave. From pinned host memory the copies
    do not block the host; they run on the caller's current stream. The
    latent sidecar never left the card. Returns the cache."""
    del cfg
    attn = cache["layers"]["attn"]
    rows = slice(frame * page_size, (frame + 1) * page_size)
    attn["k"][:, rows].copy_(k_rows, non_blocking=True)
    attn["v"][:, rows].copy_(v_rows, non_blocking=True)
    return cache
