"""Transformer blocks of the dense family: GQA attention, MLP, decoder layer.

Port of the dense parts of ``repro.models.blocks``.  The weights keep the
reference's einsum shapes: ``wq`` (d, H, dh), ``wk`` and ``wv``
(d, Hkv, dh), ``wo`` (H, dh, d), ``w_gate`` and ``w_up`` (d, ff),
``w_down`` (ff, d).  Full-sequence attention goes through K8
(``kernels.flash_attention``) when ``cfg.use_flash_attention`` is set and
through ``blockwise_attention`` otherwise, as at the reference's
``blocks.py:62-68``.  The MLA, MoE and SSM branches are not ported yet
(ROADMAP.md, queue 1: the model and training stack) and raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import blockwise_attention, decode_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Initializer, apply_norm, apply_rope, glu_act, make_norm,
)

_LATER = "(ROADMAP.md, queue 1: the model and training stack)"


# -- GQA attention --------------------------------------------------------------

def make_attn(init: Initializer, cfg: ModelConfig) -> nn.ParameterDict:
    d, H, Hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    return nn.ParameterDict({
        "wq": init.make((d, H, dh)),
        "wk": init.make((d, Hkv, dh)),
        "wv": init.make((d, Hkv, dh)),
        "wo": init.make((H, dh, d)),
    })


def attn_qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_fwd(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
             causal: bool = True, window: int | None = None):
    """Full-sequence attention (prefill).  Returns (out, (k, v)); k and v
    are returned for cache construction.  The reference's ``rope=False``
    and external ``kv`` serve whisper, which is not ported yet."""
    q, k, v = attn_qkv(p, cfg, x, positions)
    if cfg.use_flash_attention:
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = blockwise_attention(q, k, v, causal=causal, window=window)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, (k, v)


def attn_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                kv_len: torch.Tensor, *, window: int | None = None,
                seq_shard: bool = False, ring: bool = False):
    """Single-token decode; writes the new token's k and v into ``cache``
    in place.

    cache: {"k": (B, S, Hkv, dh), "v": ..., optional "pos": (B, S)}.
    ``ring``: sliding-window ring buffer (slot = pos % S); otherwise the
    slot is min(pos, S - 1).
    """
    B = x.shape[0]
    pos = kv_len.to(torch.int32).reshape(-1)
    q, k_new, v_new = attn_qkv(p, cfg, x, pos[:, None])   # (B, 1, H*, dh)
    q = q[:, 0]
    k_cache, v_cache = cache["k"], cache["v"]
    S = k_cache.shape[1]
    slot = (pos % S if ring else torch.clamp(pos, max=S - 1)).long()
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v_new[:, 0].to(v_cache.dtype)
    if "pos" in cache:
        cache["pos"][bidx, slot] = pos
        pos_ids = cache["pos"]
        valid = (pos_ids >= 0) & (pos_ids <= pos[:, None])
        if window is not None:
            valid = valid & (pos_ids > pos[:, None] - window)
        out = _decode_masked(q, k_cache, v_cache, valid)
    else:
        out = decode_attention(q, k_cache, v_cache, pos + 1, window=window,
                               seq_shard=seq_shard)
    out = torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]
    return out, cache


def _decode_masked(q, k_cache, v_cache, valid):
    B, S, Hkv, Dh = k_cache.shape
    H = q.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * Dh**-0.5
    s = torch.where(valid[:, None, None, :], s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, v_cache.shape[-1]).to(q.dtype)


# -- dense MLP ------------------------------------------------------------------

def make_mlp(init: Initializer, cfg: ModelConfig) -> nn.ParameterDict:
    d, ff = cfg.d_model, cfg.d_ff
    p = nn.ParameterDict()
    if cfg.mlp != "gelu":
        p["w_gate"] = init.make((d, ff))
    p["w_up"] = init.make((d, ff))
    p["w_down"] = init.make((ff, d))
    return p


def mlp_fwd(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    else:
        h = glu_act(cfg.mlp, x @ p["w_gate"], x @ p["w_up"])
    return h @ p["w_down"]


# -- layers ---------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """One attention + MLP layer: ``ln_attn``, ``ln_mlp`` (``None`` for
    ``nonparam_ln``), ``attn`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, init: Initializer):
        super().__init__()
        self.ln_attn = make_norm(init, cfg.norm, cfg.d_model)
        self.ln_mlp = make_norm(init, cfg.norm, cfg.d_model)
        self.attn = make_attn(init, cfg)
        self.mlp = make_mlp(init, cfg)


def make_decoder_layer(init: Initializer, cfg: ModelConfig, *,
                       moe_layer: bool) -> DecoderLayer:
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA attention is not ported yet {_LATER}")
    if moe_layer:
        raise NotImplementedError(f"MoE layers are not ported yet {_LATER}")
    return DecoderLayer(cfg, init)


def decoder_layer_fwd(p: DecoderLayer, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, moe_layer: bool, mode: str,
                      cache: dict | None = None, kv_len=None,
                      window: int | None = None, seq_shard: bool = False,
                      ring: bool = False):
    """One attention + MLP layer.  Returns (x, cache): for ``prefill`` the
    layer's {"k", "v"}, for ``decode`` the updated ``cache``, else None.
    The reference's third value, the MoE auxiliary losses, is zero for a
    dense layer and is not returned."""
    if moe_layer:
        raise NotImplementedError(f"MoE layers are not ported yet {_LATER}")
    h = apply_norm(cfg.norm, x, p.ln_attn)
    if mode == "decode":
        a, new_cache = attn_decode(p.attn, cfg, h, cache, kv_len,
                                   window=window, seq_shard=seq_shard,
                                   ring=ring)
    else:
        a, (k, v) = attn_fwd(p.attn, cfg, h, positions, window=window)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    x = x + a
    h = apply_norm(cfg.norm, x, p.ln_mlp)
    return x + mlp_fwd(p.mlp, cfg, h), new_cache
