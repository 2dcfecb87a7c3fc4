"""Decoder-only language models, dense family (port of ``repro.models.lm``).

``DecoderLM`` holds the parameters as an ``nn.Module``: ``embed``
(V, d), ``head`` (d, V) unless the embeddings are tied, ``ln_final`` and
``layers``, one ``blocks.DecoderLayer`` per layer (the reference stacks
them along a leading axis under ``units/``; ``models.weights`` maps the
names).  ``forward`` is a Python loop over the layers: no scan, no remat.

Public entry points: ``init``, ``make_cache``, ``prefill``, ``decode``.
They keep the reference's signatures with the module in place of
``params``.  Caches are dicts of tensors in the reference's layout --
``k`` and ``v`` (n_layers, B, S, Hkv, dh), and for sliding-window models
a ring of ``min(seq, window)`` slots with ``pos`` (n_layers, B, S) int32
-- and ``prefill`` and ``decode`` update the cache passed to them in
place and return it.

The other unit kinds (MoE, SSM, hybrid), VLM patches, whisper and
``loss_fn`` are not ported yet (ROADMAP.md, queue 1: the model and
training stack) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Initializer, apply_norm, make_norm

_LATER = "(ROADMAP.md, queue 1: the model and training stack)"


# -- structure ------------------------------------------------------------------

def unit_layout(cfg: ModelConfig) -> tuple[str, int]:
    """Returns (unit_kind, n_units), as the reference does."""
    if cfg.family in ("ssm",):
        return "ssm", cfg.n_layers
    if cfg.family == "hybrid":
        if not cfg.shared_every or cfg.n_layers % cfg.shared_every:
            raise ValueError("hybrid models need n_layers % shared_every == 0")
        return "hybrid", cfg.n_layers // cfg.shared_every
    if cfg.moe is not None and cfg.moe.every == 2:
        if cfg.n_layers % 2:
            raise ValueError("alternating MoE models need an even n_layers")
        return "dense_moe", cfg.n_layers // 2
    if cfg.moe is not None:
        return "moe", cfg.n_layers
    return "dense", cfg.n_layers


def _check_ported(cfg: ModelConfig) -> int:
    """n_layers of a dense decoder-only model; other families raise."""
    if cfg.encdec:
        raise NotImplementedError(
            f"encoder-decoder models (whisper) are not ported yet {_LATER}")
    if cfg.n_patches or cfg.family == "vlm":
        raise NotImplementedError(f"VLM models are not ported yet {_LATER}")
    kind, n_units = unit_layout(cfg)
    if kind != "dense":
        raise NotImplementedError(
            f"{kind!r} units ({cfg.name}) are not ported yet {_LATER}")
    return n_units


class DecoderLM(nn.Module):
    """The parameters of a dense decoder-only LM."""

    def __init__(self, cfg: ModelConfig, init: Initializer):
        super().__init__()
        n_layers = _check_ported(cfg)
        self.embed = init.make((cfg.vocab_size, cfg.d_model),
                               fan_in=cfg.d_model)
        if not cfg.tie_embeddings:
            self.head = init.make((cfg.d_model, cfg.vocab_size))
        self.ln_final = make_norm(init, cfg.norm, cfg.d_model)
        self.layers = nn.ModuleList(
            blocks.make_decoder_layer(init, cfg, moe_layer=False)
            for _ in range(n_layers))


def init(cfg: ModelConfig, generator: torch.Generator | None = None, *,
         device: str | torch.device = "cuda") -> DecoderLM:
    """A ``DecoderLM`` with the reference's init rules, drawn from
    ``generator`` (which must live on ``device``).  ``device="meta"``
    gives shapes and dtypes only, as the reference's ``abstract=True``."""
    dev = resolve_device(device)
    return DecoderLM(cfg, Initializer(generator, cfg.pdtype, dev))


# -- caches ---------------------------------------------------------------------

def _attn_cache(cfg: ModelConfig, batch: int, seq: int, *, stack: int,
                seq_shard: bool, ring: bool, dtype, device) -> dict:
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA caches are not ported yet {_LATER}")
    if seq_shard:
        raise NotImplementedError(
            "seq_shard: the sequence-sharded decode cache is not ported yet "
            "(ROADMAP.md, queue 1: the sharded models)")
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = {
        "k": torch.zeros((stack, batch, seq, hkv, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((stack, batch, seq, hkv, dh), dtype=dtype,
                         device=device),
    }
    if ring:
        cache["pos"] = torch.full((stack, batch, seq), -1, dtype=torch.int32,
                                  device=device)
    return cache


def make_cache(cfg: ModelConfig, batch: int, seq: int, *,
               seq_shard: bool = False, dtype=None,
               device: str | torch.device = "cuda") -> dict:
    """Decode cache.  ``seq`` = max cache length.

    Sliding-window models get a ring buffer of size min(seq, window).  The
    reference also returns the caches' logical sharding axes, which have
    no counterpart on one card.
    """
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype
    n_units = _check_ported(cfg)
    ring = cfg.sliding_window is not None
    if ring:
        seq = min(seq, cfg.sliding_window)
    return _attn_cache(cfg, batch, seq, stack=n_units, seq_shard=seq_shard,
                       ring=ring, dtype=dtype, device=dev)


# -- stack forward --------------------------------------------------------------

def _unit_fwd(cfg: ModelConfig, kind: str, layer: blocks.DecoderLayer,
              x: torch.Tensor, positions: torch.Tensor, *, mode: str,
              cache=None, kv_len=None, seq_shard: bool = False):
    if kind != "dense":
        raise NotImplementedError(f"{kind!r} units are not ported yet {_LATER}")
    window = cfg.sliding_window
    ring = window is not None and mode == "decode"
    return blocks.decoder_layer_fwd(
        layer, cfg, x, positions, moe_layer=False, mode=mode, cache=cache,
        kv_len=kv_len, window=window, seq_shard=seq_shard, ring=ring)


def forward(cfg: ModelConfig, model: DecoderLM, x: torch.Tensor,
            positions: torch.Tensor, *, mode: str, cache: dict | None = None,
            kv_len=None, seq_shard: bool = False):
    """Run the layer stack.  x: (B, S, d) embedded input.

    Returns (x, cache): for ``prefill`` the fresh per-layer k and v stacked
    (n_layers, B, S, Hkv, dh); for ``decode`` ``cache`` itself, updated in
    place through per-layer views; for ``train`` None.
    """
    kind, _ = unit_layout(cfg)
    fresh = []
    for i, layer in enumerate(model.layers):
        layer_cache = (None if cache is None
                       else {name: t[i] for name, t in cache.items()})
        x, new_cache = _unit_fwd(cfg, kind, layer, x, positions, mode=mode,
                                 cache=layer_cache, kv_len=kv_len,
                                 seq_shard=seq_shard)
        fresh.append(new_cache)
    if mode == "decode":
        return x, cache
    if mode == "prefill":
        return x, {name: torch.stack([c[name] for c in fresh])
                   for name in fresh[0]}
    return x, None


def _embed(cfg: ModelConfig, model: DecoderLM, tokens: torch.Tensor):
    x = model.embed[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x.to(cfg.cdtype)


def _head(cfg: ModelConfig, model: DecoderLM, x: torch.Tensor):
    x = apply_norm(cfg.norm, x, model.ln_final)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, model.embed)
    return x @ model.head


# -- public API -----------------------------------------------------------------

def prefill(cfg: ModelConfig, model: DecoderLM, tokens: torch.Tensor,
            cache: dict | None, *, patches=None, seq_shard: bool = False):
    """Run a full prompt and write its k/v into ``cache`` (in place).

    tokens: (B, S) integer tensor on the model's device.  Returns
    (cache, logits of the last position, (B, 1, V)).  With ``cache=None``
    the fresh prompt-length k/v are returned as the cache.
    """
    if patches is not None:
        raise NotImplementedError(f"VLM patches are not ported yet {_LATER}")
    B, S = tokens.shape
    x = _embed(cfg, model, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    x, fresh = forward(cfg, model, x, positions, mode="prefill",
                       seq_shard=seq_shard)
    logits = _head(cfg, model, x[:, -1:])
    cache = _merge_prefill_cache(cfg, cache, fresh, S)
    return cache, logits


def _merge_prefill_cache(cfg: ModelConfig, cache: dict | None, fresh: dict,
                         prompt_len: int):
    """Write prefill k/v (length S_p) into the decode cache buffers, in place.

    As the reference: every ``pos`` is reset to -1 and then set for the
    last min(S, S_p) positions at slots ``pos % S``; k and v are written
    as a sequence when the cache and prompt lengths differ (at ring slots
    ``pos % S`` for sliding-window models, else from slot 0) and copied
    when the shapes are equal; a buffer of another shape is left alone.
    """
    if cache is None:
        return fresh

    def write_pos(dst):
        S = dst.shape[-1]
        take = min(S, prompt_len)
        pos = torch.arange(prompt_len - take, prompt_len, dtype=torch.int32,
                           device=dst.device)
        dst.fill_(-1)
        dst[:, :, (pos % S).long()] = pos

    def write_seq(dst, src):
        take = min(prompt_len, dst.shape[2])
        src_t = src[:, :, prompt_len - take : prompt_len].to(dst.dtype)
        if cfg.sliding_window is not None:
            S = dst.shape[2]
            idx = torch.arange(prompt_len - take, prompt_len,
                               device=dst.device) % S
            dst[:, :, idx] = src_t
        else:
            dst[:, :, :take] = src_t

    for name, dst in cache.items():
        if name == "pos" and name not in fresh:
            write_pos(dst)
            continue
        src = fresh[name]
        if (dst.dim() >= 3 and src.dim() == dst.dim()
                and dst.shape[:2] == src.shape[:2]
                and dst.shape[3:] == src.shape[3:]
                and dst.shape[2] != src.shape[2]):
            write_seq(dst, src)
        elif src.shape == dst.shape:
            dst.copy_(src)
    return cache


def decode(cfg: ModelConfig, model: DecoderLM, cache: dict,
           token: torch.Tensor, kv_len: torch.Tensor, *,
           seq_shard: bool = False):
    """One decode step.  token: (B,) int; kv_len: (B,) current lengths.

    Updates ``cache`` in place.  Returns (logits (B, 1, V), cache).
    """
    x = _embed(cfg, model, token[:, None])
    positions = kv_len.to(torch.int32).reshape(-1, 1)
    x, cache = forward(cfg, model, x, positions, mode="decode", cache=cache,
                       kv_len=kv_len, seq_shard=seq_shard)
    return _head(cfg, model, x), cache
