"""K8: flash attention forward -- causal, sliding-window, GQA.

``flash_attention(q, k, v, causal=, window=, scale=)`` takes q
(B, Sq, H, Dh) and k, v (B, Skv, Hkv, Dh|Dv) and returns (B, Sq, H, Dv) in
q's dtype, as the reference's Pallas kernel
(``repro.kernels.flash_attention.flash_attention``) does: an online
softmax whose statistics (m, l, acc) are float32 across KV tiles, the
output ``acc / max(l, 1e-30)`` (a row with every key masked gives 0), the
g = H / Hkv query heads of one KV head sharing its keys, and the masks
``k <= q`` (causal) and ``k > q - window``, with q and k positions both
counted from 0.  p is cast to v's dtype before the PV product.

For tensors on the card it launches a CUDA kernel through one C entry
point (``csrc/flash_attention.cu``), which routes by dtype: bf16 to a
tensor-core kernel (``mma.sync`` on 128 folded q rows a block, key
tiles of 64, 48 at head width 80 and 32 at 256), float32 to a
register-tiled kernel on IEEE FP32 FMAs (``csrc/flash_attention_f32.cu``:
128 folded q rows a block up to width 80 and 64 above, key tiles of 32,
each thread a 4-row micro-tile of S and of O), since TF32 would not meet
the float32 tolerance.  Head widths up to 256.  For tensors on the CPU it runs
``flash_attention_plain``.  The reference's ``tq``, ``tk`` and
``interpret`` are the TPU's tiling and backend knobs; the kernels pick
their own tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import blockwise_attention

# Kernel launches made by ``flash_attention`` in this process.
launches = 0

MAX_HEAD_DIM = 256
MAX_GROUP = 32  # query heads per KV head that one thread block folds


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``blockwise_attention``, an online softmax
    over blocks of keys, so no (Sq x Skv) score matrix is ever formed."""
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D (B, S, heads, head_dim), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    if k.shape != (B, Skv, Hkv, Dh) or v.shape[0] != B:
        raise ValueError(f"k must be (B, Skv, Hkv, Dh) = {(B, Skv, Hkv, Dh)} "
                         f"and v (B, Skv, Hkv, Dv), got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"H = {H} query heads must be a multiple of "
                         f"Hkv = {Hkv} KV heads")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"at most {MAX_GROUP} query heads per KV head, got "
                         f"{H // Hkv}")
    if not 1 <= Dh <= MAX_HEAD_DIM or not 1 <= Dv <= MAX_HEAD_DIM:
        raise ValueError(f"head widths must lie in [1, {MAX_HEAD_DIM}], got "
                         f"Dh = {Dh}, Dv = {Dv}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q is on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if window is not None and not -2**31 <= window < 2**31:
        raise ValueError(f"window {window} does not fit an int32")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, Hkv, D*) -> (B, Sq, H, Dv)."""
    global launches
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    scale = scale if scale is not None else Dh**-0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, Hkv, Dh, Dv, int(causal), int(window is not None),
            window if window is not None else 0, scale,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "flash_attention")
    launches += 1
    return out
