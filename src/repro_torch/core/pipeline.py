"""End-to-end deduplication pipeline (port of ``repro.core.pipeline``).

text docs -> tokenize/stem -> pack -> n-gram hashes -> minhash signatures
-> band matrix -> candidate runs -> verified similarities -> threshold
union-find clusters -> keep-list (one representative per cluster).

``DedupPipeline.run`` computes signatures and band values on the
pipeline's device -- in one pass of K1 (``fused_ingest``), through the
staged kernels K3 (n-gram hashes) and K4 (minhash) with ``use_kernels``,
with the staged PyTorch chain, or, with ``byte_ingest``, from raw UTF-8
bytes through K6 and K1 (``bytes_to_bands``) -- then clusters on the
host as one chunk of a ``core.session.DedupSession`` (one
``engine.ClusterAccumulator`` fed a ``candidates.BandMatrixSource``), with
exact Jaccard or the signature estimate (``numpy``, ``torch`` or
``kernel`` backend, the last being K2) as the verifier.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import lsh, minhash, shingle
from repro_torch.core.engine import ClusterStats
from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import (
    BACKENDS,
    ExactJaccardVerifier,
    SignatureVerifier,
)
from repro_torch.device import resolve_device
# Modules, not their functions: importing a kernel module first imports
# this package, which must then not ask for names that module has not
# defined yet.
from repro_torch.kernels import byte_shingle as k6
from repro_torch.kernels import fused_ingest as k1
from repro_torch.kernels import minhash as k4
from repro_torch.kernels import ngram as k3


@dataclass(frozen=True)
class DedupConfig:
    """Paper defaults: n=8, M=100, r=2 (=> b=50), thresholds from §9-10."""

    ngram: int = 8
    num_hashes: int = 100
    rows_per_band: int = 2
    edge_threshold: float = 0.75
    tree_threshold: float = 0.40
    use_disjoint_sets: bool = True
    exact_verification: bool = True  # exact Jaccard vs signature estimate
    # Staged signatures through K3 and K4, and estimate verify through K2
    # (the "auto" backend).
    use_kernels: bool = False
    fused_ingest: bool = False  # signatures and bands in one pass of K1
    byte_ingest: bool = False  # device bytes -> bands (no stemming; K6, K1)
    verify_backend: str = "auto"  # estimate mode: numpy | torch | kernel
    verify_batch: str = "run"  # engine batch granularity: run | band
    # The reference's default: the environment picks the band-store tier.
    store: str = field(default_factory=lambda: os.environ.get(
        "REPRO_STORE_BACKEND", "memory"))

    def __post_init__(self):
        if self.verify_backend not in ("auto", *BACKENDS):
            raise ValueError(f"unknown verify backend {self.verify_backend!r}")
        if self.store not in ("memory", "sqlite"):
            raise ValueError(f"unknown store backend {self.store!r}; "
                             "one of ('memory', 'sqlite')")
        if self.byte_ingest and self.exact_verification:
            raise ValueError(
                "byte_ingest never builds host token lists, so exact "
                "Jaccard verification is impossible; set "
                "exact_verification=False (signature-estimate mode)")

    @property
    def num_bands(self) -> int:
        return self.num_hashes // self.rows_per_band

    def resolved_backend(self) -> str:
        if self.verify_backend != "auto":
            return self.verify_backend
        return "kernel" if self.use_kernels else "numpy"


@dataclass
class DedupResult:
    labels: np.ndarray  # (D,) cluster root per doc
    keep_mask: np.ndarray  # (D,) bool — True for cluster representatives
    pairs: list  # evaluated (a, b, sim)
    stats: ClusterStats
    uf: ThresholdUnionFind
    signatures: np.ndarray  # (D, M) uint32
    bands: np.ndarray  # (D, b, 2) uint32
    timings: dict = field(default_factory=dict)

    @property
    def num_clusters(self) -> int:
        """Number of duplicate clusters, i.e. components of size >= 2."""
        _, counts = np.unique(self.labels, return_counts=True)
        return int((counts >= 2).sum())

    @property
    def num_duplicates_removed(self) -> int:
        return int((~self.keep_mask).sum())


class DedupPipeline:
    """The paper's batch dedup on one device (``"cuda"`` unless told).

    Without a CUDA device, constructing it raises ``RuntimeError`` unless
    ``device="cpu"`` is passed; on the CPU the kernels' plain versions run.
    """

    def __init__(self, config: DedupConfig | None = None, *, device="cuda"):
        self.config = config or DedupConfig()
        self.device = resolve_device(device)
        self.seeds = minhash.default_seeds(self.config.num_hashes)
        # Per-stage wall times of the last compute call.
        self.stage_timings: dict[str, float] = {}

    @classmethod
    def from_reference(cls, config_fields: dict, seeds: np.ndarray, *,
                       device="cuda") -> "DedupPipeline":
        """Build from ``dataclasses.asdict`` of ``repro``'s DedupConfig and
        that pipeline's seed vector, so both packages hash alike.

        ``use_pallas`` becomes ``use_kernels``, and the verify backends
        ``"pallas"`` and ``"jnp"`` become ``"kernel"`` and ``"torch"``.
        The reference's ``seed`` field is dropped: its pipeline does not
        read it, and the seed vector arrives as ``seeds``.
        """
        fields = dict(config_fields)
        fields.pop("seed", None)
        fields["use_kernels"] = fields.pop("use_pallas", False)
        backend = fields.get("verify_backend", "auto")
        fields["verify_backend"] = {"pallas": "kernel",
                                    "jnp": "torch"}.get(backend, backend)
        pipe = cls(DedupConfig(**fields), device=device)
        seeds = np.asarray(seeds, dtype=np.uint32)
        if seeds.shape != pipe.seeds.shape:
            raise ValueError(f"expected {pipe.seeds.shape} seeds, got "
                             f"{seeds.shape}")
        pipe.seeds = seeds
        return pipe

    # -- stages ------------------------------------------------------------

    def tokenize(self, texts: list[str]) -> list[list[str]]:
        return [shingle.tokenize(t) for t in texts]

    def _sync(self) -> None:
        """Wait for the device, so a host clock times finished work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_arrays(self, token_lists, pad_len):
        """(signatures, band values) as word tensors on the device.

        Records ``pack_s`` (token ids and the padded matrix, on the host),
        ``upload_s`` and ``ingest_s`` (K1, or the staged chain: K3, K4 and
        the plain fold with ``use_kernels``, else plain PyTorch) in
        ``stage_timings``.
        """
        cfg = self.config
        t0 = time.perf_counter()
        packed = shingle.pack_documents(token_lists, pad_len)
        t1 = time.perf_counter()
        tokens = u32_from_numpy(packed.tokens, self.device)
        lengths = torch.from_numpy(packed.lengths).to(self.device)
        seeds = u32_from_numpy(self.seeds, self.device)
        self._sync()
        t2 = time.perf_counter()
        if cfg.fused_ingest:
            sig, bands, _ = k1.fused_ingest(tokens, lengths, seeds, n=cfg.ngram,
                                         r=cfg.rows_per_band)
        elif cfg.use_kernels:
            ng, valid = k3.ngram_hashes(tokens, lengths, n=cfg.ngram)
            sig = k4.minhash_signatures(ng, valid, seeds)
            bands = lsh.band_values(sig, cfg.rows_per_band)
        else:
            ng, valid = shingle.ngram_hashes(tokens, lengths, n=cfg.ngram)
            sig = minhash.signatures(ng, valid, seeds)
            bands = lsh.band_values(sig, cfg.rows_per_band)
        self._sync()
        self.stage_timings.update(pack_s=t1 - t0, upload_s=t2 - t1,
                                  ingest_s=time.perf_counter() - t2)
        return sig, bands

    def _device_arrays_bytes(self, docs, pad_len):
        """(signatures, band values) as word tensors on the device, from
        the documents' UTF-8 bytes: ``bytes_to_bands`` (K6, compaction,
        K1) whatever ``use_kernels`` says.

        Records ``pack_s`` (the padded byte matrix), ``upload_s`` and
        ``ingest_s`` in ``stage_timings``.
        """
        cfg = self.config
        t0 = time.perf_counter()
        packed = shingle.pack_bytes(docs, pad_len)
        t1 = time.perf_counter()
        data = torch.from_numpy(packed.data).to(self.device)
        lengths = torch.from_numpy(packed.lengths).to(self.device)
        seeds = u32_from_numpy(self.seeds, self.device)
        self._sync()
        t2 = time.perf_counter()
        sig, bands, _ = k6.bytes_to_bands(data, lengths, seeds, n=cfg.ngram,
                                       r=cfg.rows_per_band)
        self._sync()
        self.stage_timings.update(pack_s=t1 - t0, upload_s=t2 - t1,
                                  ingest_s=time.perf_counter() - t2)
        return sig, bands

    def compute_signatures(self, token_lists: list[list[str]],
                           pad_len: int | None = None) -> np.ndarray:
        return u32_to_numpy(self._device_arrays(token_lists, pad_len)[0])

    def compute_bands(self, sig: np.ndarray) -> np.ndarray:
        return u32_to_numpy(lsh.band_values(
            u32_from_numpy(sig, self.device), self.config.rows_per_band))

    def compute_arrays(
        self, token_lists: list[list[str]], pad_len: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One batch's (signatures, band values) as numpy uint32.

        With ``config.fused_ingest`` both come out of one pass of K1;
        otherwise the staged chain runs (K3 and K4 with
        ``config.use_kernels``, else plain PyTorch).  The bits are the
        same either way.  ``pad_len`` (>= the longest document) widens the
        packed matrix without changing the outputs.
        """
        sig, bands = self._device_arrays(token_lists, pad_len)
        return u32_to_numpy(sig), u32_to_numpy(bands)

    def compute_arrays_bytes(
        self, docs: list[str | bytes], pad_len: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One batch's (signatures, band values) from UTF-8 bytes, as numpy
        uint32.

        The bytes are the only upload; tokenizing (no stemming) happens on
        the device.  The outputs equal ``compute_arrays`` of
        ``tokenize(text, do_stem=False)``.  ``pad_len`` widens the byte
        matrix and must exceed the longest document's byte length
        (``shingle.pack_bytes``).
        """
        sig, bands = self._device_arrays_bytes(docs, pad_len)
        return u32_to_numpy(sig), u32_to_numpy(bands)

    def make_verifier(self, token_lists: list[list[str]], sig):
        """The batched pair verifier for this config.

        ``sig`` is the (D, M) signature matrix, as numpy uint32 or as a
        word tensor; a tensor on the pipeline's device is used in place.
        """
        cfg = self.config
        if cfg.exact_verification:
            return ExactJaccardVerifier.from_token_lists(token_lists,
                                                         cfg.ngram)
        return SignatureVerifier(sig, backend=cfg.resolved_backend(),
                                 device=self.device)

    # -- end to end ----------------------------------------------------------

    def run(self, texts: list[str]) -> DedupResult:
        """One-shot dedup of ``texts``: labels, keep mask and evaluated pairs.

        The clustering is one chunk of a host ``DedupSession``
        (``_merge_precomputed``), fed the verifier ``make_verifier`` builds.
        """
        from repro_torch.core.session import DedupSession

        cfg = self.config
        timings = {}
        if cfg.byte_ingest:
            # No host tokenizing: the engine needs only one placeholder
            # per document (estimate mode never reads tokens).
            token_lists = [[] for _ in texts]
            timings["tokenize_s"] = 0.0
            pad_len = shingle.pow2_bucket(max(
                (len(t.encode("utf-8")) for t in texts), default=0) + 1)
            sig_dev, bands_dev = self._device_arrays_bytes(texts, pad_len)
        else:
            t0 = time.perf_counter()
            token_lists = self.tokenize(texts)
            timings["tokenize_s"] = time.perf_counter() - t0
            pad_len = shingle.pow2_bucket(
                max((len(t) for t in token_lists), default=1))
            sig_dev, bands_dev = self._device_arrays(token_lists, pad_len)
        t0 = time.perf_counter()
        sig, bands = u32_to_numpy(sig_dev), u32_to_numpy(bands_dev)
        timings.update(self.stage_timings,
                       download_s=time.perf_counter() - t0)
        timings["signatures_s"] = sum(timings[k] for k in (
            "pack_s", "upload_s", "ingest_s", "download_s"))

        # The device backends verify against the matrix already on the
        # device; only the numpy backend reads the host copy.
        t0 = time.perf_counter()
        on_host = cfg.exact_verification or cfg.resolved_backend() == "numpy"
        verifier = self.make_verifier(token_lists,
                                      sig if on_host else sig_dev)
        timings["verifier_build_s"] = time.perf_counter() - t0

        sess = DedupSession(cfg, verifier=verifier, device=self.device)
        snap = sess._merge_precomputed(token_lists, sig, bands)
        # cluster_s is the merge (engine loop and verify); the snapshot's
        # labels and sorted pair list are timed apart, as labels_s (with
        # the keep mask) and pairs_s.
        timings["cluster_s"] = sess.stage_timings["merge_s"]
        timings["verify_s"] = snap.stats.verify_seconds
        t0 = time.perf_counter()
        labels = snap.labels
        # The first doc of each cluster is its representative.
        keep = np.zeros(len(texts), dtype=bool)
        keep[np.unique(labels, return_index=True)[1]] = True
        timings["labels_s"] = (sess.stage_timings["labels_s"]
                               + time.perf_counter() - t0)
        timings["pairs_s"] = sess.stage_timings["pairs_s"]
        return DedupResult(
            labels=labels,
            keep_mask=keep,
            pairs=snap.pairs,
            stats=snap.stats,
            uf=sess.uf,
            signatures=sig,
            bands=bands,
            timings=timings,
        )
