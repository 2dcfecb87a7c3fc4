"""Weights carried over from the reference's parameter tree.

``params_from_reference(cfg, tree, device)`` turns the numpy pytree of
``repro.models.lm.init``'s params (nested dicts of arrays; the layers
stacked along a leading axis under ``units/``) into the port's
``DecoderLM``, so that both packages run on the same weights.  The port's
parameter ``layers.{i}.{rest}`` is row i of the reference's
``units/{rest}``; every other name maps with ``.`` read as ``/``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Initializer
from repro_torch.models.lm import DecoderLM


def reference_name(name: str) -> tuple[str, int | None]:
    """The reference's path of a port parameter, and its layer row."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["units", *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _tensor(arr: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    # numpy has no bfloat16: widen it exactly to float32 first.
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def params_from_reference(cfg: ModelConfig, tree: dict,
                          device: str | torch.device = "cuda") -> DecoderLM:
    """The port's ``DecoderLM`` holding the reference tree's weights.

    Raises if a name or shape of either side finds no counterpart.
    """
    dev = resolve_device(device)
    model = DecoderLM(cfg, Initializer(None, cfg.pdtype, torch.device("meta")))
    flat = _flatten(tree)
    state, used = {}, set()
    for name, p in model.named_parameters():
        ref, layer = reference_name(name)
        if ref not in flat:
            raise KeyError(f"{name}: the reference tree has no {ref!r}")
        arr = flat[ref] if layer is None else flat[ref][layer]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)}, reference "
                             f"{ref!r} has {tuple(arr.shape)}")
        state[name] = _tensor(arr, p.dtype, dev)
        used.add(ref)
    if set(flat) - used:
        raise KeyError(f"reference parameters with no counterpart: "
                       f"{sorted(set(flat) - used)}")
    model.load_state_dict(state, assign=True)
    return model
