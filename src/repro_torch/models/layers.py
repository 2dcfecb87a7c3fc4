"""Shared model building blocks: parameter initialiser, norms, RoPE, GLU.

Port of ``repro.models.layers``.  ``Initializer`` plays the part of the
reference's parameter factory (``layers.py:57-67``): it makes each
parameter by the same rule (``normal`` with std ``1/sqrt(fan_in)``,
``fan_in`` the second-to-last dimension of the unstacked shape unless
given; ``zeros``; ``ones``).
The random numbers differ: the reference seeds each tensor from Python's
``hash()`` of its path, which changes from process to process, and the
port draws from one ``torch.Generator``.  Tests therefore carry weights
across with ``models.weights.params_from_reference``.

``cross_entropy`` and ``sinusoidal_positions`` wait for training and
whisper (ROADMAP.md, queue 1: the model and training stack).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Initializer:
    """Makes parameters by the reference's init rules on one device.

    On the ``meta`` device the parameters have shapes and dtypes only
    (the reference's ``abstract=True``), and no generator is needed.
    """

    def __init__(self, generator: torch.Generator | None, dtype: torch.dtype,
                 device: torch.device):
        if generator is None and device.type != "meta":
            raise ValueError("a generator is needed to initialise parameters "
                             f"on {device}")
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def make(self, shape: tuple[int, ...], init: str = "normal",
             fan_in: int | None = None) -> nn.Parameter:
        shape = tuple(shape)
        if self.device.type == "meta":
            return nn.Parameter(torch.empty(shape, dtype=self.dtype,
                                            device=self.device),
                                requires_grad=False)
        if init == "zeros":
            arr = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            arr = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init == "normal":
            fi = fan_in if fan_in is not None else (
                shape[-2] if len(shape) >= 2 else shape[-1])
            std = 1.0 / math.sqrt(max(1, fi))
            arr = (torch.randn(shape, generator=self.generator,
                               dtype=torch.float32, device=self.device)
                   * std).to(self.dtype)
        else:
            raise ValueError(init)
        return nn.Parameter(arr, requires_grad=False)


# -- norms ----------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor | None = None,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32; the scale multiplies by ``1 + weight``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * (1.0 + weight.float())
    return x.to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor | None = None,
              bias: torch.Tensor | None = None,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm; with weight=bias=None this is OLMo's non-parametric LN."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def apply_norm(kind: str, x: torch.Tensor, params) -> torch.Tensor:
    """``params``: the norm's ``ParameterDict`` from ``make_norm``, or None."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"] if params is not None else None)
    if kind == "layernorm":
        return layernorm(
            x,
            params["scale"] if params is not None else None,
            params["bias"] if params is not None and "bias" in params
            else None,
        )
    if kind == "nonparam_ln":
        return layernorm(x, None, None)
    raise ValueError(kind)


def make_norm(init: Initializer, kind: str, d: int) -> nn.ParameterDict | None:
    """The norm's parameters: none for ``nonparam_ln``; an rmsnorm scale
    starting at zero; a layernorm scale of ones and bias of zeros."""
    if kind == "nonparam_ln":
        return None
    if kind == "rmsnorm":
        return nn.ParameterDict({"scale": init.make((d,), init="zeros")})
    if kind == "layernorm":
        return nn.ParameterDict({"scale": init.make((d,), init="ones"),
                                 "bias": init.make((d,), init="zeros")})
    raise ValueError(kind)


# -- rotary position embeddings -------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S).

    Rotates the two halves of the head dimension (not interleaved pairs).
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # (dh/2,)
    ang = positions[..., None].float() * freqs                # (..., S, dh/2)
    if x.dim() == ang.dim() + 1:                              # heads axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- activations ----------------------------------------------------------------

def glu_act(kind: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(kind)
