"""Serving shells of the port: LM continuous batching (``ServeEngine``).

The dedup query service (``repro.serving.DedupQueryService``) is not
ported yet (ROADMAP.md, queue 1: the read path).
"""
from repro_torch.serving.engine import EngineStats, Request, ServeEngine

__all__ = ["ServeEngine", "Request", "EngineStats"]
