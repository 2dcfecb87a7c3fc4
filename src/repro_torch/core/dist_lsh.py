"""Sharded dedup step on ``torch.distributed`` (port of ``repro.core.dist_lsh``).

The reference runs this step under ``shard_map`` over a TPU mesh; here
it is SPMD with one process per card, and ``shard_map``'s collectives
become ``torch.distributed`` calls (NCCL on cards, gloo on CPUs):

* Documents are sharded over the processes: rank r holds rows
  ``[r * D_loc, (r + 1) * D_loc)`` and all their bands, the paper's
  Cassandra **Design 2** layout.
* Per band, each rank scatters its ``(band value, doc id, verify_k
  signature prefix)`` entries into one bounded bucket per rank by the
  band value's top bits, an ``all_to_all`` delivers the buckets, and
  each rank sorts what it received by (valid, hi, lo) and finds the
  equal-value runs: the paper's sort-based method (§3.6 method 2).
* Each run member becomes a star edge to its run head, and a two-stage
  verify decides it:

  1. *Prefix prescreen* on the device: member and head are compared on
     the exchanged ``verify_k`` prefix, and edges whose estimate clears
     ``edge_threshold - prescreen_margin`` are appended to a bounded
     per-rank edge buffer of each band group.
  2. *Full-signature verify*: on the host merge (``stage2="host"``:
     ``cluster_step_output`` -> ``candidates.ShardedEdgeSource`` ->
     ``verify.ShardedEdgeVerifier`` -> ``engine.ClusterAccumulator``),
     or on the device (``stage2="device"``: K7,
     ``kernels.sigjaccard.masked_indexed_pair_counts``, scores the edges
     whose two ends lie in the rank's own rows; cross-shard edges are
     scored by the head's owner against a bounded buffer of member rows
     exchanged between the ranks, ``sig_row_capacity``, with
     ``masked_pair_counts``; an ``all_reduce`` sums the disjoint
     counts).  Then ``verify.DeviceScoredEdgeVerifier`` serves those
     scores and re-scores only what the row buffer could not hold.

The ``band_groups`` groups of bands each get their own edge buffer and
overflow count.  Every buffer is static in shape: overflow is counted,
never silent, and ``cluster_step_output`` then re-derives the
candidates on the host from the step's own signatures.  Global doc ids
come from ``doc_offsets`` (default: the contiguous row offsets), so the
chunks of a larger corpus get ids that do not collide.

Words are uint32 carried as int32 bits (``core.hashing``); empty buffer
slots hold ``INVALID`` (U32_MAX, -1 as int32).  Every sort on words is
unsigned (on int64 values in [0, 2**32)) and stable, as the
reference's ``lax.sort`` and ``argsort`` are, and the reference's
dropped out-of-range writes go to one spare row that is cut off.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import lsh, minhash, shingle
from repro_torch.core.candidates import (
    BandMatrixSource,
    ShardedEdgeSource,
    host_array,
    host_u32,
)
from repro_torch.core.engine import ClusterAccumulator, ClusterStats
from repro_torch.core.hashing import (
    MASK32,
    as_u32,
    to_bits,
    u32_from_numpy,
    u32_to_numpy,
)
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import (
    DeviceScoredEdgeVerifier,
    ShardedEdgeVerifier,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import sigjaccard
# Modules, not their functions: importing kernels.fused_ingest or
# kernels.byte_shingle first imports this package, which must then not ask
# for names those modules have not defined yet.
from repro_torch.kernels import byte_shingle as k6
from repro_torch.kernels import fused_ingest as k1

# U32_MAX as an int32 word: the empty slot of every buffer.
INVALID = -1

STAGE2_MODES = ("host", "device")


@dataclass(frozen=True)
class DistLSHConfig:
    ngram: int = 8
    num_hashes: int = 100
    rows_per_band: int = 2
    verify_k: int = 32          # signature prefix length exchanged for verify
    edge_threshold: float = 0.75
    prescreen_margin: float = 0.15  # stage-1 keeps est >= edge_t - margin
    bucket_slack: float = 2.0   # capacity = slack * D_local / n_dev
    edge_capacity: int = 4096   # prescreened-edge buffer per device/group
    m_chunk: int = 16
    band_groups: int = 1        # G bounded buffers of b/G bands each
    stage2: str = "host"        # full-signature verify: "host" | "device"
    sig_row_capacity: int = 1024  # cross-shard published-row buffer (0: off)
    fused_ingest: bool = False  # one pass of K1: shingle -> minhash -> fold
    byte_ingest: bool = False   # step inputs are uint8 bytes, not tokens

    @property
    def num_bands(self) -> int:
        return self.num_hashes // self.rows_per_band

    @property
    def prescreen_threshold(self) -> float:
        """Stage-1 on-device prefix-prescreen keep threshold."""
        return max(0.0, self.edge_threshold - self.prescreen_margin)

    @property
    def bands_per_group(self) -> int:
        if self.num_bands % self.band_groups != 0:
            raise ValueError(
                f"band_groups={self.band_groups} does not divide "
                f"num_bands={self.num_bands}")
        return self.num_bands // self.band_groups


@dataclass(frozen=True)
class DocsMesh:
    """The flat "docs" view of the processes: one shard per process.

    ``group`` is None only for a single shard without a process group;
    then the step calls no collective.
    """

    group: dist.ProcessGroup | None
    rank: int
    n_dev: int
    device: torch.device


def docs_mesh(device="cuda", group=None) -> DocsMesh:
    """The docs mesh of this process: ``group`` (default: the default
    process group if one is initialized, else none and one shard) and
    its device.

    ``"cuda"`` means this process's current card; without a card it
    raises unless ``device="cpu"`` is passed.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return DocsMesh(group=None, rank=0, n_dev=1, device=dev)
    return DocsMesh(group=group, rank=dist.get_rank(group),
                    n_dev=dist.get_world_size(group), device=dev)


# -- collectives ------------------------------------------------------------

def _all_gather(t: torch.Tensor, mesh: DocsMesh) -> torch.Tensor:
    """(n_dev, *t.shape): every rank's ``t`` in rank order."""
    if mesh.group is None:
        return t[None]
    if t.dtype == torch.bool:
        return _all_gather(t.to(torch.uint8), mesh).to(torch.bool)
    out = torch.empty((mesh.n_dev, *t.shape), dtype=t.dtype, device=t.device)
    # The list form: gloo takes no stacked output tensor.
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=mesh.group)
    return out


def _all_reduce_sum(t: torch.Tensor, mesh: DocsMesh) -> torch.Tensor:
    """Sum of every rank's ``t`` (in place)."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def _all_to_all(boxed: torch.Tensor, mesh: DocsMesh) -> torch.Tensor:
    """Send ``boxed[j]`` to rank j; row i of the result came from rank i.
    A single shard keeps its buffer, as the reference does."""
    if mesh.n_dev == 1:
        return boxed
    out = torch.empty_like(boxed)
    dist.all_to_all_single(out, boxed.contiguous(), group=mesh.group)
    return out


# -- the step ---------------------------------------------------------------

def _head_index(heads: torch.Tensor) -> torch.Tensor:
    """For each position, the index of the last run head at or before it
    (``heads[0]`` must be set)."""
    idx = torch.arange(heads.shape[0], device=heads.device)
    return torch.cummax(torch.where(heads, idx, 0), dim=0).values


def _bucket_scatter(entries: torch.Tensor, bucket: torch.Tensor,
                    n_dev: int, cap: int):
    """Scatter entries (D_loc, F) into (n_dev, cap, F) by bucket id.

    Returns (out, overflow_count).  Entries past a bucket's capacity are
    dropped from the buffer but counted.
    """
    d_loc, f = entries.shape
    order = torch.sort(bucket, stable=True).indices
    sb = bucket[order]
    heads = torch.ones(d_loc, dtype=torch.bool, device=entries.device)
    heads[1:] = sb[1:] != sb[:-1]
    pos = torch.arange(d_loc, device=entries.device) - _head_index(heads)
    ok = pos < cap
    overflow = (~ok).sum()
    out = torch.full((n_dev * cap + 1, f), INVALID, dtype=torch.int32,
                     device=entries.device)
    out[torch.where(ok, sb * cap + pos, n_dev * cap)] = entries[order]
    return out[:-1].reshape(n_dev, cap, f), overflow


def _band_exchange_and_edges(band_hi, band_lo, doc_ids, sig_k,
                             cfg: DistLSHConfig, mesh: DocsMesh, cap: int):
    """One band: bucket -> all_to_all -> sort -> star edges -> prescreen.

    Inputs are the rank's own: band_hi/lo (D_loc,) words, doc_ids
    (D_loc,) global id words, sig_k (D_loc, k) words.  Returns (edges
    (n_dev*cap, 2) words, prefix estimates (n_dev*cap,) float32,
    edge_mask, #candidates, overflow); ``edge_mask`` marks the stage-1
    survivors.
    """
    n_dev, k = mesh.n_dev, cfg.verify_k
    if n_dev > 1:
        # Logical shift: the top bits of the unsigned band value.
        shift = 32 - max(1, int(np.log2(n_dev)))
        bucket = as_u32(band_hi) >> shift
    else:
        bucket = torch.zeros(band_hi.shape, dtype=torch.int64,
                             device=band_hi.device)
    entries = torch.cat([band_hi[:, None], band_lo[:, None],
                         doc_ids[:, None], sig_k], dim=1)  # (D_loc, 3 + k)
    boxed, overflow = _bucket_scatter(entries, bucket, n_dev, cap)
    recv = _all_to_all(boxed, mesh).reshape(n_dev * cap, 3 + k)

    hi, lo, doc = recv[:, 0], recv[:, 1], recv[:, 2]
    valid = doc != INVALID
    # Invalid slots to the end; key (invalid, hi, lo) unsigned, ties in
    # receive order.  65 key bits fit no int64, so two stable passes.
    perm = torch.sort(as_u32(lo), stable=True).indices
    key = ((~valid).to(torch.int64) << 32) | as_u32(hi)
    perm = perm[torch.sort(key[perm], stable=True).indices]
    hi_s, lo_s, doc_s, valid_s = hi[perm], lo[perm], doc[perm], valid[perm]
    sig_s = recv[perm, 3:]

    heads = torch.ones_like(valid_s)
    heads[1:] = ~((hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
                  & valid_s[1:])
    head_idx = _head_index(heads)
    cand_mask = ~heads & valid_s  # member of a run
    agree = (sig_s == sig_s[head_idx]).sum(dim=-1, dtype=torch.int32)
    # ``jnp.mean`` under jit multiplies the sum by the float32 reciprocal
    # of k (checked against the reference at verify_k = 24, where 7 of
    # the 25 counts differ from a division).
    est = agree.to(torch.float32) * (np.float32(1) / np.float32(k)).item()
    thr = float(np.float32(cfg.prescreen_threshold))
    edge_mask = cand_mask & (est >= thr)
    edges = torch.stack([doc_s[head_idx], doc_s], dim=-1)
    return edges, est, edge_mask, cand_mask.sum(), overflow


def _prescreen_scan(bands_g, doc_ids, sig_k, cfg: DistLSHConfig,
                    mesh: DocsMesh, cap: int):
    """Scan one band group's bands into the rank's bounded edge buffer.

    bands_g: (D_loc, bg, 2) words.  Returns (buf (e_cap, 2), buf_sim
    (e_cap,), emask (e_cap,), stats (3,) int32 [edge_count, candidates,
    overflow]).  Counts stay on the device: no step of the scan waits
    for the host.
    """
    e_cap = cfg.edge_capacity
    dev = bands_g.device
    buf = torch.full((e_cap + 1, 2), INVALID, dtype=torch.int32, device=dev)
    buf_sim = torch.zeros((e_cap + 1,), dtype=torch.float32, device=dev)
    count, n_cand, ovf = (torch.zeros((), dtype=torch.int64, device=dev)
                          for _ in range(3))
    for j in range(bands_g.shape[1]):
        edges, est, emask, c, o = _band_exchange_and_edges(
            bands_g[:, j, 0], bands_g[:, j, 1], doc_ids, sig_k, cfg, mesh,
            cap)
        # Append the survivors; those past the buffer land in the spare
        # row and are counted as overflow.
        dst = torch.where(emask, count + torch.cumsum(emask, dim=0) - 1,
                          e_cap).clamp(max=e_cap)
        buf[dst] = edges
        buf_sim[dst] = est
        wanted = count + emask.sum()
        count = wanted.clamp(max=e_cap)
        n_cand = n_cand + c
        ovf = ovf + o + (wanted - count)
    emask = torch.arange(e_cap, device=dev) < count
    stats = torch.stack([count, n_cand, ovf]).to(torch.int32)
    return buf[:e_cap], buf_sim[:e_cap], emask, stats


def _local_prepare(tokens, lengths, seeds, cfg: DistLSHConfig):
    """The rank's (signatures (D_loc, M), bands (D_loc, b, 2)) words."""
    n, r = cfg.ngram, cfg.rows_per_band
    # PyTorch runs eagerly, so a new input width compiles nothing; the
    # reference's shape-bucketing rule does not apply to these calls.
    if cfg.byte_ingest:
        # repro-lint: disable=RPR003 -- eager PyTorch, nothing recompiles
        sig, bands, _ = k6.bytes_to_bands(tokens, lengths, seeds, n=n, r=r)
        return sig, bands
    if cfg.fused_ingest:
        # repro-lint: disable=RPR003 -- eager PyTorch, nothing recompiles
        sig, bands, _ = k1.fused_ingest(tokens, lengths, seeds, n=n, r=r)
        return sig, bands
    ng, valid = shingle.ngram_hashes(tokens, lengths, n=n)
    sig = minhash.signatures(ng, valid, seeds, m_chunk=cfg.m_chunk)
    return sig, lsh.band_values(sig, r)


def _device_stage2(all_edges, all_emask, sig, doc_offset: int,
                   cfg: DistLSHConfig, mesh: DocsMesh):
    """Full-M counts of every gathered edge, summed over the ranks.

    Returns (counts (n_dev*e_cap,) int32, covered (n_dev*e_cap,) bool,
    row_overflow (1,) int32).  Each rank scores the edges whose two ends
    lie in its rows (K7, indexed), and, when ``sig_row_capacity`` > 0
    and there are several ranks, the cross-shard edges whose head it
    owns against the member rows the other ranks publish (K7,
    pre-gathered).  The contributions are disjoint.
    """
    d_loc, m = sig.shape
    flat = all_edges.reshape(-1, 2)
    mask_flat = all_emask.reshape(-1)
    # Shard-relative ids wrap mod 2**32 as the reference's int32 ids do;
    # an id is in the shard iff its unsigned offset is below D_loc.
    a_u = (as_u32(flat[:, 0]) - doc_offset) & MASK32
    b_u = (as_u32(flat[:, 1]) - doc_offset) & MASK32
    a_in, b_in = a_u < d_loc, b_u < d_loc
    a_loc, b_loc = to_bits(a_u), to_bits(b_u)
    local = mask_flat & a_in & b_in
    counts = sigjaccard.masked_indexed_pair_counts(sig, a_loc, b_loc, local)
    covered = local
    row_ovf = torch.zeros((1,), dtype=torch.int32, device=sig.device)
    rc = cfg.sig_row_capacity
    if mesh.n_dev > 1 and rc > 0:
        # Publish the distinct member rows of edges whose member is mine
        # and whose head is not, into a buffer of ``rc`` rows; rows past
        # it are counted and their edges left to the host re-score.
        publish = mask_flat & b_in & ~a_in
        s = torch.sort(torch.where(publish, b_u, d_loc)).values
        uniq = torch.ones_like(publish)
        uniq[1:] = s[1:] != s[:-1]
        uniq &= s < d_loc
        pos = torch.cumsum(uniq, dim=0) - 1
        dst = torch.where(uniq & (pos < rc), pos, rc)
        row_ids = torch.full((rc + 1,), INVALID, dtype=torch.int32,
                             device=sig.device)
        rows = torch.zeros((rc + 1, m), dtype=torch.int32, device=sig.device)
        row_ids[dst] = to_bits(s + doc_offset)
        rows[dst] = sig[s.clamp(max=d_loc - 1)]
        row_ovf = (uniq.sum() - rc).clamp(min=0).to(torch.int32).reshape(1)
        tbl_ids = as_u32(_all_gather(row_ids[:rc], mesh).reshape(-1))
        tbl_rows = _all_gather(rows[:rc], mesh).reshape(-1, m)
        # Score the cross edges whose head is mine: look the member's row
        # up by global id (published ids are distinct).
        order = torch.sort(tbl_ids, stable=True).indices
        sorted_ids = tbl_ids[order]
        member = as_u32(flat[:, 1])
        at = torch.searchsorted(sorted_ids, member).clamp(
            max=sorted_ids.shape[0] - 1)
        hit = (sorted_ids[at] == member) & mask_flat & a_in & ~b_in
        a_rows = sig[a_loc.to(torch.int64).clamp(0, d_loc - 1)]
        counts = counts + sigjaccard.masked_pair_counts(
            a_rows, tbl_rows[order[at]], hit)
        covered = covered | hit
    counts = _all_reduce_sum(counts, mesh)
    covered = _all_reduce_sum(covered.to(torch.int32), mesh) > 0
    return counts, covered, row_ovf


def _group_layout(d_loc: int, doc_offset: int, cfg: DistLSHConfig,
                  mesh: DocsMesh):
    """A band group's bucket capacity per destination and the rank's
    global doc ids (int32 words): the shapes ``_prescreen_scan`` gets."""
    cap = max(1, int(np.ceil(cfg.bucket_slack * d_loc / mesh.n_dev)))
    doc_ids = to_bits(doc_offset + torch.arange(d_loc, device=mesh.device))
    return cap, doc_ids


def _local_group(bands_g, sig, doc_offset: int, cfg: DistLSHConfig,
                 mesh: DocsMesh, stage2: str) -> dict:
    """One band group: the rank's prescreen scan, then the buffers of
    every rank gathered in rank order (and device stage 2)."""
    cap, doc_ids = _group_layout(sig.shape[0], doc_offset, cfg, mesh)
    sig_k = sig[:, : cfg.verify_k]
    buf, buf_sim, emask, stats = _prescreen_scan(
        bands_g, doc_ids, sig_k, cfg, mesh, cap)
    all_edges = _all_gather(buf, mesh)
    all_emask = _all_gather(emask, mesh)
    out = {"edges": all_edges.reshape(-1, 2),
           "prescreen_sims": _all_gather(buf_sim, mesh).reshape(-1),
           "edge_mask": all_emask.reshape(-1),
           "stats": _all_gather(stats, mesh)}
    if stage2 == "device":
        counts, covered, row_ovf = _device_stage2(
            all_edges, all_emask, sig, doc_offset, cfg, mesh)
        out.update(device_match_counts=counts, device_covered=covered,
                   row_overflow=_all_gather(row_ovf, mesh).reshape(-1))
    return out


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A tensor, or a numpy array (uint32 -> int32 words), on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return u32_from_numpy(x, device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def make_streamed_dedup_step(cfg: DistLSHConfig, mesh: DocsMesh, *,
                             stage2: str | None = None):
    """Build the band-group sharded dedup step for ``mesh``.

    ``step(tokens (D, L), lengths (D,), seeds (M,), doc_offsets (n_dev,)
    | None)`` -> dict(sig (D, M), stage2, groups=[dict(edges (n_dev *
    E_cap, 2), prescreen_sims, edge_mask, stats (n_dev, 3), band_start,
    [device_match_counts, device_covered, row_overflow (n_dev,)]), ...]).

    Every rank passes the whole input (numpy arrays or tensors; uint32
    token words, or uint8 bytes with ``cfg.byte_ingest``) and works on
    its row block; D must be divisible by the shard count.  The outputs
    are the reference's global arrays, gathered in rank order on every
    rank as tensors on the mesh's device: words as int32 bits, masks as
    bool, stats and counts as int32.  With ``stage2="device"``,
    ``device_match_counts`` holds each edge's full-M agreement count (not
    divided by M) where ``device_covered`` is set.

    ``doc_offsets[i]`` is the global id of rank i's first row; the
    default is the contiguous row offsets ``i * D_loc``.
    """
    stage2 = cfg.stage2 if stage2 is None else stage2
    if stage2 not in STAGE2_MODES:
        raise ValueError(f"unknown stage2 mode {stage2!r}")
    G, bg = cfg.band_groups, cfg.bands_per_group

    def step(tokens, lengths, seeds, doc_offsets=None):
        D = tokens.shape[0]
        if D % mesh.n_dev:
            raise ValueError(f"{D} documents do not split evenly over "
                             f"{mesh.n_dev} shards")
        d_loc = D // mesh.n_dev
        if doc_offsets is None:
            offset = d_loc * mesh.rank
        else:
            offset = int(host_u32(doc_offsets).reshape(-1)[mesh.rank])
        rows = slice(mesh.rank * d_loc, (mesh.rank + 1) * d_loc)
        dev = mesh.device
        sig, bands = _local_prepare(
            _to_device(tokens[rows], dev),
            _to_device(lengths[rows], dev).to(torch.int32),
            _to_device(seeds, dev), cfg)
        groups = []
        for g in range(G):
            gout = _local_group(bands[:, g * bg : (g + 1) * bg], sig,
                                offset & MASK32, cfg, mesh, stage2)
            gout["band_start"] = g * bg
            groups.append(gout)
        return {"sig": _all_gather(sig, mesh).reshape(D, -1),
                "groups": groups, "stage2": stage2}

    return step


def make_dedup_step(cfg: DistLSHConfig, mesh: DocsMesh):
    """Build the end-of-step view of the sharded step (stage 2 on host).

    ``dedup_step(tokens, lengths, seeds, doc_offsets=None)`` ->
    dict(edges (G*n_dev*E_cap, 2), prescreen_sims, edge_mask, sig (D, M),
    stats (G*n_dev, 3)): the band groups' buffers concatenated, group
    major.  ``make_streamed_dedup_step`` gives the groups one by one and
    the device-resident stage 2.
    """
    streamed = make_streamed_dedup_step(cfg, mesh, stage2="host")

    def dedup_step(tokens, lengths, seeds, doc_offsets=None):
        out = streamed(tokens, lengths, seeds, doc_offsets)
        gs = out["groups"]
        return {
            "edges": torch.cat([g["edges"] for g in gs]),
            "prescreen_sims": torch.cat([g["prescreen_sims"] for g in gs]),
            "edge_mask": torch.cat([g["edge_mask"] for g in gs]),
            "sig": out["sig"],
            "stats": torch.cat([g["stats"] for g in gs]),
        }

    return dedup_step


# ---------------------------------------------------------------------------
# Host merge: stage-2 verify and clustering through the shared engine
# ---------------------------------------------------------------------------

@dataclass
class ShardedClusterResult:
    """Outcome of ``cluster_step_output`` (sharded path, host merge)."""

    uf: ThresholdUnionFind
    stats: ClusterStats
    pairs: list  # evaluated (a, b, sim) with full-signature sims
    num_edges: int          # stage-1 survivors fed into the engine
    overflow: int           # device bucket/edge-buffer overflow count
    retried: bool           # True when the overflow fallback pass ran
    device_stats: np.ndarray  # (n_dev, 3) [edge_count, candidates, ovf]
    group_stats: list = field(default_factory=list)  # per band group
    device_scored: int = 0  # stage-2 pairs served from device scores
    host_rescored: int = 0  # stage-2 pairs re-scored on the host
    row_overflow: int = 0   # cross-shard row-buffer overflow (stage2=device)

    def labels(self) -> np.ndarray:
        return self.uf.components()


@dataclass
class StepFeed:
    """Outcome of ``feed_step_groups`` (one step fed into an accumulator)."""

    num_edges: int
    overflow: int
    row_overflow: int
    device_stats: np.ndarray
    group_stats: list


def _resolve_stream(stream: bool | None, device: torch.device) -> bool:
    """Whether ``feed_step_groups`` brings each group's buffers to the
    host only when its loop reaches the group.

    ``None`` streams unless the step ran on the CPU of a one-core host,
    where device work and host merge share the only core, so waiting for
    everything up front costs nothing.  Results are the same either way.
    """
    if stream is not None:
        return bool(stream)
    if device.type != "cpu":
        return True
    return (os.cpu_count() or 1) > 1


def _host_group(g_out: dict, device_scored: bool) -> dict:
    """One group's buffers on the host as numpy arrays (edge words as
    uint32)."""
    hosted = {"stats": host_array(g_out["stats"]),
              "edges": host_u32(g_out["edges"]),
              "edge_mask": host_array(g_out["edge_mask"]).astype(bool)}
    if device_scored:
        hosted.update(
            counts=host_array(g_out["device_match_counts"]),
            covered=host_array(g_out["device_covered"]).astype(bool),
            row_overflow=host_array(g_out["row_overflow"]))
    return hosted


def feed_step_groups(
    acc: ClusterAccumulator,
    out: dict,
    cfg: DistLSHConfig,
    *,
    num_docs: int,
    edge_offset: int = 0,
    verifier=None,
    stream: bool | None = None,
    on_group_merged=None,
) -> StepFeed:
    """Feed one step output into a ``ClusterAccumulator``, group by group.

    Per band group: bring the edge buffer to the host, register the
    device's stage-2 scores with ``verifier`` (``stage2="device"``), and
    feed the group's ``ShardedEdgeSource`` to the accumulator.  Edge ids
    are shifted by ``edge_offset`` and range-filtered to
    ``[0, num_docs)``.

    ``stream=False`` brings every group's buffers to the host before the
    loop; ``True`` brings each group's when the loop reaches it; ``None``
    decides by ``_resolve_stream``.  The feed is the same in every mode.

    ``on_group_merged`` (if given) runs after each group's feed, before
    the next group's buffers are taken: a session's retention sweep, so
    rows are evicted inside a step too.  The sweep may run mid-step: it
    releases only rows of docs that lost roothood outside its protection
    window, and the later groups' edges touch only this step's rows,
    which the caller protects, and current roots.

    Returns the step's edge and overflow accounting; the overflow
    fallback stays with the caller.
    """
    groups = out.get("groups")
    if groups is None:
        # End-of-step view: one (G*n_dev, 3) stats array whose rows are
        # the (group, device) buffers; treat it as a single group.
        groups = [out]
    device_scored = out.get("stage2") == "device"
    hosted = (_host_group(g, device_scored) for g in groups)
    if not _resolve_stream(stream, out["sig"].device):
        hosted = list(hosted)
    m = out["sig"].shape[1]

    num_edges = 0
    row_overflow = 0
    group_stats = []
    device_stats_parts = []
    for g in hosted:
        g_stats, edges, mask = g["stats"], g["edges"], g["edge_mask"]
        device_stats_parts.append(g_stats)
        source = ShardedEdgeSource.from_device_buffers(
            edges, mask, num_docs=num_docs, num_shards=g_stats.shape[0],
            edge_offset=edge_offset)
        if device_scored and hasattr(verifier, "add_scores"):
            # Counts to float32 before /M: numpy would divide int32 by a
            # float32 in float64, and the registry would then hold other
            # bits than the host estimator's correctly rounded float32.
            local = edges.astype(np.int64) - int(edge_offset)
            sims = g["counts"].astype(np.float32) / np.float32(m)
            reg = (mask & g["covered"]
                   & (local >= 0).all(axis=-1)
                   & (local < num_docs).all(axis=-1))
            verifier.add_scores(local[reg], sims[reg])
            row_overflow += int(g["row_overflow"].sum())
        num_edges += source.num_edges
        group_stats.append(acc.feed(source, verifier=verifier))
        if on_group_merged is not None:
            on_group_merged()

    if device_scored and hasattr(verifier, "clear_scores"):
        # Registered scores are dead once their edges have been fed.
        verifier.clear_scores()

    device_stats = np.concatenate(device_stats_parts)
    return StepFeed(
        num_edges=num_edges,
        overflow=int(device_stats[:, 2].sum()),
        row_overflow=row_overflow,
        device_stats=device_stats,
        group_stats=group_stats)


def cluster_step_output(
    out: dict,
    cfg: DistLSHConfig,
    *,
    tree_threshold: float = 0.40,
    backend: str = "numpy",
    batch: str = "run",
    num_docs: int | None = None,
    doc_id_base: int = 0,
    overflow_fallback: bool = True,
    batch_pairs: int = 8192,
    stream: bool | None = None,
) -> ShardedClusterResult:
    """Stage 2 of the sharded path: full-signature verify and merge.

    Takes the output of ``make_dedup_step`` or of
    ``make_streamed_dedup_step`` and drives its prescreened edges through
    the shared engine: ``ShardedEdgeSource`` -> ``ShardedEdgeVerifier``
    (the full (D, M) signatures on the step's device, backend ``numpy``,
    ``torch`` or ``kernel``) -> ``engine.ClusterAccumulator``, so
    thresholds, estimates and exclusion counts are those of
    ``DedupPipeline``.  A ``stage2="device"`` output gets a
    ``DeviceScoredEdgeVerifier`` that serves the device's scores.

    ``num_docs`` bounds the real documents (edges touching padding rows
    are dropped).  ``doc_id_base`` echoes the ``doc_offsets`` base of a
    chunk of a larger corpus: edge ids are global, ``sig`` rows local,
    and every returned id is a local row.

    If any shard overflowed a bucket or its edge buffer, and with
    ``overflow_fallback``, the candidates are derived again on the host
    from the step's own signatures (``BandMatrixSource``) and fed
    through the same accumulator, so no candidate is lost.

    ``stream`` is ``feed_step_groups``'s: when each group's buffers come
    to the host; the result is the same.
    """
    sig = out["sig"]
    num_docs = sig.shape[0] if num_docs is None else int(num_docs)

    cls = (DeviceScoredEdgeVerifier if out.get("stage2") == "device"
           else ShardedEdgeVerifier)
    verifier = cls(sig[:num_docs], backend=backend, batch_pairs=batch_pairs,
                   device=sig.device)
    acc = ClusterAccumulator(
        num_docs, verifier, cfg.edge_threshold, tree_threshold,
        batch=batch)

    feed = feed_step_groups(
        acc, out, cfg, num_docs=num_docs, edge_offset=doc_id_base,
        verifier=verifier, stream=stream)

    retried = False
    if feed.overflow > 0 and overflow_fallback:
        retried = True
        bands = u32_to_numpy(lsh.band_values(sig[:num_docs],
                                             cfg.rows_per_band))
        acc.feed(BandMatrixSource(bands))

    return ShardedClusterResult(
        uf=acc.uf, stats=acc.stats, pairs=acc.pairs,
        num_edges=feed.num_edges, overflow=feed.overflow,
        retried=retried, device_stats=feed.device_stats,
        group_stats=feed.group_stats,
        device_scored=getattr(verifier, "n_passthrough", 0),
        host_rescored=getattr(verifier, "n_rescored", 0),
        row_overflow=feed.row_overflow)
