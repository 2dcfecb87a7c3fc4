"""Core of the port: hashing, shingling, minhash, LSH, engine, pipeline.

The public names are those of ``repro.core.__all__`` that the port has
ported, and no others.
"""
from repro_torch.core.candidates import (
    BandMatrixSource,
    CandidateSource,
    ShardedEdgeSource,
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
from repro_torch.core.unionfind import ThresholdUnionFind
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
    "candidate_probability", "ThresholdUnionFind",
    "DistLSHConfig", "ShardedClusterResult", "StepFeed",
    "cluster_step_output", "feed_step_groups", "make_dedup_step",
    "make_streamed_dedup_step", "docs_mesh",
    "BandMatrixSource", "CandidateSource", "ShardedEdgeSource",
    "candidate_pairs",
    "ClusterAccumulator", "ClusterStats", "cluster_source",
    "BatchVerifier", "CallbackVerifier", "DeviceScoredEdgeVerifier",
    "ExactJaccardVerifier", "ShardedEdgeVerifier", "SignatureVerifier",
]
