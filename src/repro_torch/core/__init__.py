"""Core of the port: hashing, shingling, minhash, LSH, engine, pipeline.

The public names mirror ``repro.core``'s for the ported slice.
"""
from repro_torch.core.candidates import (
    BandMatrixSource,
    CandidateSource,
    ShardedEdgeSource,
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
    merge_cluster_rounds,
)
from repro_torch.core.pipeline import DedupConfig, DedupPipeline, DedupResult
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import (
    BatchVerifier,
    DeviceScoredEdgeVerifier,
    ExactJaccardVerifier,
    ShardedEdgeVerifier,
    SignatureVerifier,
)

__all__ = [
    "BandMatrixSource", "CandidateSource", "ClusterAccumulator",
    "ClusterStats", "cluster_source", "merge_cluster_rounds",
    "DedupConfig", "DedupPipeline", "DedupResult", "ThresholdUnionFind",
    "BatchVerifier", "ExactJaccardVerifier", "SignatureVerifier",
    "ShardedEdgeSource", "ShardedEdgeVerifier", "DeviceScoredEdgeVerifier",
    "DistLSHConfig", "ShardedClusterResult", "StepFeed",
    "cluster_step_output", "docs_mesh", "feed_step_groups",
    "make_dedup_step", "make_streamed_dedup_step",
]
