"""Attention: blockwise prefill path and decode path (port of
``repro.models.attention``).

``blockwise_attention`` walks the KV sequence in blocks with an online
softmax, so the (Sq x Skv) score matrix never exists whole.  It is the
model's path when ``use_flash_attention`` is off.  Layouts are the
reference's: q (B, Sq, H, Dh), k and v (B, Skv, Hkv, D*), GQA with
H % Hkv == 0.  Scores and statistics are float32; p is cast to v's dtype
before the PV product, as in the reference.
"""
from __future__ import annotations

import torch


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int | None, kv_len=None) -> torch.Tensor:
    """(Sq, Tkv) additive float32 bias (0 or -inf) from position masks."""
    if causal:
        m = k_pos[None, :] <= q_pos[:, None]
    else:
        m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    if window is not None:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    if kv_len is not None:
        m = m & (k_pos[None, :] < kv_len)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(m, zero, float("-inf"))


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    block_kv: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k: (B, Skv, Hkv, Dh); v: (B, Skv, Hkv, Dv).

    Returns (B, Sq, H, Dv) in q's dtype.  H % Hkv == 0 (GQA groups).
    """
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    g = H // Hkv
    scale = scale if scale is not None else Dh**-0.5
    blk = min(block_kv, Skv)
    n_blk = -(-Skv // blk)
    dev = q.device
    # (B, Hkv, g, Sq, Dh) in float32: bf16 products are exact in float32,
    # and the sums run in float32 (the reference's preferred_element_type).
    qg = q.reshape(B, Sq, Hkv, g, Dh).permute(0, 2, 3, 1, 4).float()
    q_pos = q_offset + torch.arange(Sq, dtype=torch.int32, device=dev)
    m = torch.full((B, Hkv, g, Sq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, Dv), dtype=torch.float32, device=dev)
    for bi in range(n_blk):
        lo, hi = bi * blk, min((bi + 1) * blk, Skv)
        kblk = k[:, lo:hi].permute(0, 2, 1, 3).float()      # (B, Hkv, T, Dh)
        vblk = v[:, lo:hi].permute(0, 2, 1, 3)              # (B, Hkv, T, Dv)
        k_pos = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kblk) * scale
        s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # Guard fully-masked rows (m == -inf).
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                          vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len,
    *,
    window: int | None = None,
    scale: float | None = None,
    seq_shard: bool = False,
) -> torch.Tensor:
    """Single-token decode. q: (B, H, Dh); caches: (B, S, Hkv, D*).

    ``kv_len``: (B,) or scalar -- number of valid cache positions; the new
    token attends to positions < kv_len (and >= kv_len - window).
    ``seq_shard`` (a sequence-sharded cache) is not ported yet.
    """
    if seq_shard:
        raise NotImplementedError(
            "seq_shard: the sequence-sharded decode cache is not ported yet "
            "(ROADMAP.md, queue 1: the sharded models)")
    B, S, Hkv, Dh = k_cache.shape
    H = q.shape[1]
    g = H // Hkv
    Dv = v_cache.shape[-1]
    scale = scale if scale is not None else Dh**-0.5
    qg = q.reshape(B, Hkv, g, Dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                             device=q.device).reshape(-1, 1)
    valid = pos[None, :] < kv_len
    if window is not None:
        valid = valid & (pos[None, :] >= kv_len - window)
    s = torch.where(valid[:, None, None, :], s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, Dv).to(q.dtype)
