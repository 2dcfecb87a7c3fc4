"""Serving shells of the port: LM continuous batching (``ServeEngine``) and
the dedup query service (``DedupQueryService``).

Submodules are imported on first access: ``engine`` pulls the model
stack, which the query service does not need, and ``dedup_service``
imports ``repro_torch.core``, which resolves its ``DedupQueryService``
from here.
"""

__all__ = [
    "ServeEngine",
    "Request",
    "EngineStats",
    "DedupQueryService",
    "QueryRequest",
    "QueryServiceStats",
]

_ENGINE = ("ServeEngine", "Request", "EngineStats")
_DEDUP = ("DedupQueryService", "QueryRequest", "QueryServiceStats")


def __getattr__(name: str):
    if name in _ENGINE:
        from repro_torch.serving import engine

        return getattr(engine, name)
    if name in _DEDUP:
        from repro_torch.serving import dedup_service

        return getattr(dedup_service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
