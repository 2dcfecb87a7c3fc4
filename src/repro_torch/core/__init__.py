"""Core of the port: hashing, shingling, minhash, LSH, engine, pipeline.

The public names are those of ``repro.core.__all__`` that the port has
ported, and no others.  ``DedupQueryService`` lives in
``repro_torch.serving`` and is resolved on first access: the service
imports this package, so an eager import would be a cycle.
"""
from repro_torch.core.candidates import (
    BandMatrixSource,
    CandidateSource,
    EdgeStreamSource,
    ShardedEdgeSource,
    StoreBandSource,
    candidate_pairs,
)
from repro_torch.core.dist_lsh import (
    DistLSHConfig,
    ShardedClusterResult,
    StepFeed,
    cluster_step_output,
    docs_mesh,
    feed_step_groups,
    make_dedup_step,
    make_streamed_dedup_step,
)
from repro_torch.core.engine import (
    ClusterAccumulator,
    ClusterStats,
    cluster_source,
)
from repro_torch.core.lsh import LSHParams, candidate_probability
from repro_torch.core.pipeline import DedupConfig, DedupPipeline, DedupResult
from repro_torch.core.query import QueryResult, query_view
from repro_torch.core.retention import (
    BandBloomFilter,
    RetentionManager,
    RetentionPolicy,
)
from repro_torch.core.session import (
    BandIndex,
    ClusterSnapshot,
    DedupSession,
    DocIdAllocator,
    SessionView,
)
from repro_torch.core.unionfind import ThresholdUnionFind, connected_components
from repro_torch.core.verify import (
    BatchVerifier,
    CallbackVerifier,
    DeviceScoredEdgeVerifier,
    ExactJaccardVerifier,
    ShardedEdgeVerifier,
    SignatureVerifier,
)

__all__ = [
    "DedupConfig", "DedupPipeline", "DedupResult", "LSHParams",
    "candidate_probability", "ThresholdUnionFind", "connected_components",
    "DistLSHConfig", "ShardedClusterResult", "StepFeed",
    "cluster_step_output", "feed_step_groups", "make_dedup_step",
    "make_streamed_dedup_step", "docs_mesh",
    "BandBloomFilter", "RetentionManager", "RetentionPolicy",
    "BandIndex", "ClusterSnapshot", "DedupSession", "DedupQueryService",
    "DocIdAllocator", "SessionView", "QueryResult", "query_view",
    "BandMatrixSource", "CandidateSource", "EdgeStreamSource",
    "ShardedEdgeSource", "StoreBandSource",
    "candidate_pairs",
    "ClusterAccumulator", "ClusterStats", "cluster_source",
    "BatchVerifier", "CallbackVerifier", "DeviceScoredEdgeVerifier",
    "ExactJaccardVerifier", "ShardedEdgeVerifier", "SignatureVerifier",
]


def __getattr__(name: str):
    if name == "DedupQueryService":
        from repro_torch.serving.dedup_service import DedupQueryService

        return DedupQueryService
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
