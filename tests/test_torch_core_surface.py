"""The rest of ``repro.core``'s surface in the port, held against the
reference's functions: ``candidates.EdgeStreamSource`` and
``StoreBandSource``, ``lsh.sort_band``,
``run_heads`` and ``star_edges``, ``unionfind.connected_components`` and
``cluster_min_score_audit``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.candidates as ref_candidates
import repro.core.lsh as ref_lsh
import repro.core.unionfind as ref_unionfind
import repro.core as ref_core
import repro_torch.core as core
from repro_torch.core import lsh, retention, unionfind
from repro_torch.core.bandstore import Design2Store
from repro_torch.core.candidates import EdgeStreamSource, StoreBandSource
from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy


def _band(seed, d=64, distinct=5):
    """(D, 2) uint32 band values with many ties and the top bit set."""
    rng = np.random.RandomState(seed)
    vals = rng.randint(0, distinct, size=(d, 2)).astype(np.uint32)
    vals[::3, 0] |= np.uint32(0x80000000)
    return vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_band_run_heads_and_star_edges_match_reference(seed):
    vals = _band(seed)
    docs = np.arange(len(vals), dtype=np.int32)[::-1].copy()
    got_v, got_d = lsh.sort_band(u32_from_numpy(vals), torch.from_numpy(docs))
    want_v, want_d = ref_lsh.sort_band(jnp.asarray(vals), jnp.asarray(docs))
    np.testing.assert_array_equal(u32_to_numpy(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    heads = lsh.run_heads(got_v)
    np.testing.assert_array_equal(heads.numpy(),
                                  np.asarray(ref_lsh.run_heads(want_v)))
    edges, mask = lsh.star_edges(got_v, got_d)
    want_e, want_m = ref_lsh.star_edges(want_v, want_d)
    assert edges.dtype == torch.int32
    np.testing.assert_array_equal(edges.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("n,e,seed", [(1, 1, 0), (20, 12, 1), (200, 150, 2),
                                      (300, 40, 3)])
def test_connected_components_matches_reference(n, e, seed):
    rng = np.random.RandomState(seed)
    edges = rng.randint(0, n, size=(e, 2)).astype(np.int32)
    # A long path needs several doubling rounds.
    if n >= 200:
        path = np.arange(n - 1, dtype=np.int32)
        edges = np.concatenate([edges, np.stack([path + 1, path], 1)])
    mask = rng.rand(len(edges)) < 0.8
    got = unionfind.connected_components(torch.from_numpy(edges),
                                         torch.from_numpy(mask), n)
    want = ref_unionfind.connected_components(jnp.asarray(edges),
                                              jnp.asarray(mask), num_nodes=n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cluster_min_score_audit_matches_reference():
    rng = np.random.RandomState(5)
    edges = rng.randint(0, 30, size=(60, 2))
    sims = rng.uniform(0.3, 1.0, size=60).astype(np.float32)
    labels = np.arange(30)
    for threshold in (0.2, 0.6):
        assert unionfind.cluster_min_score_audit(
            labels, edges, sims, threshold) == \
            ref_unionfind.cluster_min_score_audit(labels, edges, sims,
                                                  threshold)


def test_edge_stream_source_matches_reference():
    rng = np.random.RandomState(7)
    groups = []
    for _ in range(3):
        e = rng.randint(90, 140, size=(16, 2)).astype(np.uint32)
        groups.append((e, rng.rand(16) < 0.7))
    seen, ref_seen = [], []
    got = EdgeStreamSource(
        ((u32_from_numpy(e), torch.from_numpy(m)) for e, m in groups),
        num_docs=40, num_shards=2, edge_offset=100,
        on_group=lambda g, e, m: seen.append(g))
    want = ref_candidates.EdgeStreamSource(
        iter(groups), num_docs=40, num_shards=2, edge_offset=100,
        on_group=lambda g, e, m: ref_seen.append(g))
    assert got.num_bands == want.num_bands == 0
    got_runs, want_runs = list(got.iter_bands()), list(want.iter_bands())
    assert len(got_runs) == len(want_runs) == 6
    for a, b in zip(got_runs, want_runs):
        assert a.band_id == b.band_id
        for f in ("sorted_vals", "sorted_docs", "run_starts", "run_ends"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert seen == ref_seen == [0, 1, 2]
    assert (got.num_edges, got.groups_consumed, got.num_bands) == \
        (want.num_edges, want.groups_consumed, want.num_bands)


def test_store_band_source_matches_reference():
    """``StoreBandSource`` over a Design-2 store yields the reference's
    runs over the same store, band by band (ids above 2**31 kept)."""
    rng = np.random.RandomState(9)
    bands = rng.randint(0, 3, size=(30, 4, 2)).astype(np.uint32)
    ids = np.arange(30, dtype=np.int64) + np.int64(2**31 - 10)
    store = Design2Store(part_size=7)
    store.put_band_rows(ids, bands)
    store.commit()
    got = StoreBandSource(store, 4, int(ids[-1]) + 1)
    want = ref_candidates.StoreBandSource(store, 4, int(ids[-1]) + 1)
    assert (got.num_docs, got.num_bands) == (want.num_docs, want.num_bands)
    got_runs, want_runs = list(got.iter_bands()), list(want.iter_bands())
    assert len(got_runs) == len(want_runs) == 4
    for a, b in zip(got_runs, want_runs):
        assert a.band_id == b.band_id
        for f in ("sorted_vals", "sorted_docs", "run_starts", "run_ends"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert got.scan_s > 0.0
    np.testing.assert_array_equal(core.candidate_pairs(got),
                                  ref_candidates.candidate_pairs(want))


def test_exports():
    assert core.connected_components is unionfind.connected_components
    assert core.EdgeStreamSource is EdgeStreamSource
    assert core.StoreBandSource is StoreBandSource
    assert {"connected_components", "EdgeStreamSource",
            "StoreBandSource"} <= set(core.__all__)
    assert "StoreBandSource" in ref_core.__all__
    for name in ("BandBloomFilter", "RetentionManager", "RetentionPolicy"):
        assert name in core.__all__, name
        assert getattr(core, name) is getattr(retention, name)
        assert hasattr(ref_core, name) and name in ref_core.__all__
