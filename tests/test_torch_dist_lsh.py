"""Port parity for the sharded dedup step on one shard, in this process.

K7's plain versions are held against the reference's Pallas kernels in
interpret mode; ``ShardedEdgeSource`` and the two stage-2 verifiers
against the reference's; the one-shard step and its host merge
(``make_streamed_dedup_step`` / ``make_dedup_step`` ->
``cluster_step_output``, port on ``device="cpu"``) against the
reference's on one JAX CPU device, over both stage-2 modes, the three
ingest branches, one and five band groups, an edge-buffer overflow and a
``verify_k`` that is not a power of two.  Every comparison is bit for
bit.  Four shards over gloo are in ``test_torch_dist_lsh_gloo.py``.
"""
import os
import subprocess
import sys
from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.kernels.ops as ref_ops
from repro.core import dist_lsh as R
from repro.core.candidates import ShardedEdgeSource as RefShardedEdgeSource
from repro.core.verify import DeviceScoredEdgeVerifier as RefDeviceScored
from repro.core.verify import ShardedEdgeVerifier as RefShardedVerifier
from repro.kernels import sigjaccard as ref_sigjac
import repro_torch.core as port_core
import repro_torch.kernels.ops as port_ops
from repro_torch.core import dist_lsh as T
from repro_torch.core import minhash, shingle
from repro_torch.core.candidates import ShardedEdgeSource, candidate_pairs
from repro_torch.core.hashing import u32_from_numpy
from repro_torch.core.pipeline import DedupConfig, DedupPipeline
from repro_torch.core.verify import (
    DeviceScoredEdgeVerifier,
    ShardedEdgeVerifier,
    SignatureVerifier,
)
from repro_torch.data import inject_near_duplicates, make_i2b2_like
from repro_torch.kernels import sigjaccard as k7


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# -- K7 -----------------------------------------------------------------------

def _masked_inputs(D, M, P, seed):
    """Small word values, indices in and out of [0, D) -- -1 (INVALID as
    int32), D, int32 min and max among them -- on valid and invalid
    lanes alike, 1/8 of the lanes with a == b."""
    rng = np.random.RandomState(seed)
    sig = rng.randint(0, 3, size=(D, M)).astype(np.uint32)
    a = rng.randint(-3, D + 3, size=P).astype(np.int32)
    b = rng.randint(-3, D + 3, size=P).astype(np.int32)
    edge = np.array([-1, D, D - 1, 0, -2**31, 2**31 - 1, -1, D],
                    dtype=np.int32)
    a[:8], b[-8:] = edge, edge
    b[8 : P // 8] = a[8 : P // 8]
    valid = rng.rand(P) < 0.5
    valid[:4] = True
    valid[4:8] = False
    return sig, a, b, valid


@pytest.mark.parametrize("M", [1, 7, 100, 130])
@pytest.mark.parametrize("P", [300, 37])
def test_masked_indexed_pair_counts_matches_pallas(M, P):
    D = 50
    sig, a, b, valid = _masked_inputs(D, M, P, seed=M + P)
    want = np.asarray(ref_sigjac.masked_indexed_pair_counts(
        jnp.asarray(sig), jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid)))
    got = k7.masked_indexed_pair_counts(
        u32_from_numpy(sig), torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(valid))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.float32), want)
    assert not got.numpy()[~valid].any()
    # The estimate is counts / M, correctly rounded, as the reference's
    # eager estimate.
    est = k7.masked_indexed_pair_estimate(
        u32_from_numpy(sig), torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(valid))
    want_est = np.asarray(ref_sigjac.masked_indexed_pair_estimate(
        jnp.asarray(sig), jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid)))
    assert np.array_equal(est.numpy().view(np.uint32), want_est.view(np.uint32))


@pytest.mark.parametrize("M", [1, 7, 100, 130])
def test_masked_pair_counts_matches_pallas(M):
    sig, a, b, valid = _masked_inputs(60, M, 301, seed=M)
    rows_a, rows_b = sig[np.clip(a, 0, 59)], sig[(b.astype(np.int64) % 60)]
    want = np.asarray(ref_sigjac.masked_pair_counts(
        jnp.asarray(rows_a), jnp.asarray(rows_b), jnp.asarray(valid)))
    got = k7.masked_pair_counts(u32_from_numpy(rows_a),
                                u32_from_numpy(rows_b),
                                torch.from_numpy(valid))
    assert np.array_equal(got.numpy().astype(np.float32), want)


def test_masked_pair_counts_take_no_pairs():
    # The reference's kernels refuse P = 0; the port returns no counts.
    sig = u32_from_numpy(np.zeros((4, 5), dtype=np.uint32))
    none = torch.zeros(0, dtype=torch.int32)
    assert k7.masked_indexed_pair_counts(
        sig, none, none, none.bool()).shape == (0,)
    assert k7.masked_pair_counts(sig[:0], sig[:0], none.bool()).shape == (0,)
    with pytest.raises(TypeError):
        k7.masked_indexed_pair_counts(sig, none.long(), none, none.bool())


def test_kernel_module_imports_first():
    # The kernel module imports core.minhash, whose package imports
    # core.verify, which uses the kernel module: the cycle must close.
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    subprocess.run([sys.executable, "-c",
                    "import repro_torch.kernels.sigjaccard"],
                   check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": src})


def test_new_names_are_exported_under_reference_names():
    for name in ("masked_indexed_pair_counts", "masked_indexed_pair_estimate",
                 "masked_pair_counts"):
        assert name in ref_ops.__all__ and name in port_ops.__all__
        assert getattr(port_ops, name) is getattr(k7, name)
    for name in ("ShardedEdgeSource", "ShardedEdgeVerifier",
                 "DeviceScoredEdgeVerifier", "DistLSHConfig",
                 "ShardedClusterResult", "StepFeed", "cluster_step_output",
                 "docs_mesh", "feed_step_groups", "make_dedup_step",
                 "make_streamed_dedup_step"):
        assert name in ref_core.__all__ and name in port_core.__all__
        assert hasattr(port_core, name)


# -- sources and verifiers ------------------------------------------------------

def test_sharded_edge_source_matches_reference():
    inv = np.uint32(0xFFFFFFFF)
    rng = np.random.RandomState(2)
    edges = rng.randint(0, 12, size=(10, 2)).astype(np.uint32) + 100
    edges[2] = [inv, inv]           # an empty slot
    edges[5] = [104, 111]           # touches a pad doc (>= num_docs)
    edges[7] = [99, 103]            # below the offset
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1], dtype=bool)
    for num_shards in (1, 2, 3):
        got = ShardedEdgeSource.from_device_buffers(
            u32_from_numpy(edges), torch.from_numpy(mask), num_docs=10,
            num_shards=num_shards, edge_offset=100)
        want = RefShardedEdgeSource.from_device_buffers(
            edges, mask, num_docs=10, num_shards=num_shards, edge_offset=100)
        assert (got.num_docs, got.num_bands, got.num_edges) == \
            (want.num_docs, want.num_bands, want.num_edges)
        for g, w in zip(got.iter_bands(), want.iter_bands(), strict=True):
            assert g.band_id == w.band_id
            for f in ("sorted_vals", "sorted_docs", "run_starts", "run_ends"):
                assert np.array_equal(getattr(g, f), getattr(w, f)), f
        assert np.array_equal(candidate_pairs(got), candidate_pairs(want))
    plain = ShardedEdgeSource(edges.astype(np.int64) - 100, None, num_docs=10)
    assert plain.num_edges == RefShardedEdgeSource(
        edges.astype(np.int64) - 100, None, num_docs=10).num_edges


def _sig_pairs(seed=7, D=40, M=100, P=300):
    rng = np.random.RandomState(seed)
    sig = rng.randint(0, 50, size=(D, M)).astype(np.uint32)
    pairs = rng.randint(0, D, size=(P, 2)).astype(np.int64)
    return sig, pairs


def test_sharded_edge_verifier_matches_reference_and_host_estimator():
    sig, pairs = _sig_pairs()
    want = RefShardedVerifier(sig, backend="numpy")(pairs)
    for backend in ("numpy", "torch", "kernel"):
        v = ShardedEdgeVerifier(sig, backend=backend, batch_pairs=128,
                                device="cpu")
        assert np.array_equal(v(pairs).view(np.uint32), want.view(np.uint32))
        assert v.drift_count(pairs, SignatureVerifier(
            sig, backend="numpy", device="cpu")) == 0
    v = ShardedEdgeVerifier.from_step_output(
        {"sig": u32_from_numpy(sig)}, backend="kernel", device="cpu")
    assert np.array_equal(v(pairs), want)
    assert v.drift_count(np.zeros((0, 2), dtype=np.int64), v) == 0


def test_device_scored_verifier_counts_match_reference():
    sig, pairs = _sig_pairs(seed=8)
    registered = pairs[::3]
    # Scores as the device gives them: counts / M.
    counts = (sig[registered[:, 0]] == sig[registered[:, 1]]).sum(-1)
    sims = counts.astype(np.float32) / np.float32(100)
    ref = RefDeviceScored(sig, backend="numpy", batch_pairs=64)
    ref.add_scores(registered[:, ::-1], sims)   # either order registers
    port = DeviceScoredEdgeVerifier(sig, backend="kernel", batch_pairs=64,
                                    device="cpu")
    port.add_scores(registered[:, ::-1], sims)
    assert port.num_scores == ref.num_scores
    canon = np.sort(pairs, axis=1)
    want = ref(canon)
    got = port(canon)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (port.n_passthrough, port.n_rescored) == \
        (ref.n_passthrough, ref.n_rescored)
    assert port.n_passthrough > 0 and port.n_rescored > 0
    port.clear_scores()
    assert port.num_scores == 0 and port.n_passthrough > 0


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.docs_mesh()
    sig, _ = _sig_pairs()
    for cls in (ShardedEdgeVerifier, DeviceScoredEdgeVerifier):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(sig)


def test_step_refuses_uneven_shards():
    mesh = T.DocsMesh(group=None, rank=0, n_dev=2, device=torch.device("cpu"))
    step = T.make_streamed_dedup_step(T.DistLSHConfig(), mesh)
    packed = shingle.pack_documents([["a", "b"]] * 3)
    with pytest.raises(ValueError, match="split evenly"):
        step(packed.tokens, packed.lengths, minhash.default_seeds(100))
    with pytest.raises(ValueError, match="stage2"):
        T.make_streamed_dedup_step(T.DistLSHConfig(), mesh, stage2="tpu")


# -- the one-shard step against the reference ------------------------------------

GROUP_KEYS = ("edges", "prescreen_sims", "edge_mask", "stats")
DEVICE_KEYS = ("device_match_counts", "device_covered", "row_overflow")


def _as_np(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def assert_step_outputs_equal(port: dict, ref: dict) -> None:
    """Every array of a step output, bit for bit (the port's int32
    device counts against the reference's float32 counts)."""
    assert np.array_equal(_as_np(port["sig"]), np.asarray(ref["sig"]))
    pg = port.get("groups", [port])
    rg = ref.get("groups", [ref])
    assert len(pg) == len(rg)
    for p, r in zip(pg, rg):
        assert set(p) == set(r)
        for key in GROUP_KEYS:
            want = np.asarray(r[key])
            got = np.asarray(p[key])
            if key in ("edges", "prescreen_sims"):
                assert np.array_equal(got.view(want.dtype), want), key
            else:
                assert np.array_equal(got, want), key
        if "device_match_counts" in r:
            assert np.array_equal(
                np.asarray(p["device_match_counts"]).astype(np.float32),
                np.asarray(r["device_match_counts"]))
            for key in DEVICE_KEYS[1:]:
                assert np.array_equal(np.asarray(p[key]), np.asarray(r[key]))


def assert_results_equal(port, ref) -> None:
    """Every field of two ``cluster_step_output`` results."""
    assert np.array_equal(port.labels(), ref.labels())
    assert port.pairs == ref.pairs
    for f in ("num_edges", "overflow", "retried", "device_scored",
              "host_rescored", "row_overflow"):
        assert getattr(port, f) == getattr(ref, f), f
    assert np.array_equal(port.device_stats, ref.device_stats)
    assert len(port.group_stats) == len(ref.group_stats)
    for p, r in zip(port.group_stats, ref.group_stats):
        assert (p.pairs_generated, p.pairs_evaluated, p.pairs_excluded,
                p.unions_done) == (r.pairs_generated, r.pairs_evaluated,
                                   r.pairs_excluded, r.unions_done)


def _notes():
    notes = make_i2b2_like(56, seed=0)
    notes, _ = inject_near_duplicates(notes, 8, frac_low=0.0,
                                      frac_high=0.005, seed=1)
    return notes


def _inputs(ingest: str):
    notes = _notes()
    if ingest == "byte":
        width = shingle.pow2_bucket(max(len(n.encode()) for n in notes) + 1)
        packed = shingle.pack_bytes(notes, width)
        return packed.data, packed.lengths
    packed = shingle.pack_documents([shingle.tokenize(t) for t in notes])
    return packed.tokens, packed.lengths


def _run_both(kind: str, cfg: dict, data, lengths, **merge):
    seeds = minhash.default_seeds(100)
    rcfg, tcfg = R.DistLSHConfig(**cfg), T.DistLSHConfig(**cfg)
    make_r = R.make_dedup_step if kind == "end" else R.make_streamed_dedup_step
    make_t = T.make_dedup_step if kind == "end" else T.make_streamed_dedup_step
    ref_out = make_r(rcfg, R.docs_mesh())(jnp.asarray(data),
                                          jnp.asarray(lengths),
                                          jnp.asarray(seeds))
    port_out = make_t(tcfg, T.docs_mesh("cpu"))(data, lengths, seeds)
    assert_step_outputs_equal(port_out, ref_out)
    ref = R.cluster_step_output(ref_out, rcfg, num_docs=len(data), **merge)
    port = T.cluster_step_output(port_out, tcfg, num_docs=len(data), **merge)
    assert_results_equal(port, ref)
    return port_out, port


BASE = dict(edge_capacity=512, edge_threshold=0.88, bucket_slack=16.0)


@pytest.mark.parametrize("ingest,stage2,groups", [
    ("staged", "host", 1),
    ("staged", "device", 5),
    ("fused", "host", 5),
    ("fused", "device", 1),
    ("byte", "host", 5),
    ("byte", "device", 5),
])
def test_one_shard_step_and_merge_match_reference(ingest, stage2, groups):
    data, lengths = _inputs(ingest)
    cfg = dict(BASE, stage2=stage2, band_groups=groups,
               fused_ingest=ingest == "fused", byte_ingest=ingest == "byte")
    out, res = _run_both("streamed", cfg, data, lengths,
                         tree_threshold=0.40, overflow_fallback=False)
    assert res.num_edges > 0 and res.overflow == 0
    if stage2 == "device":
        assert res.device_scored > 0
        assert all(g["device_match_counts"].dtype == torch.int32
                   for g in out["groups"])


def test_end_of_step_view_matches_reference():
    data, lengths = _inputs("staged")
    _, res = _run_both("end", dict(BASE, band_groups=5), data, lengths)
    assert res.num_edges > 0 and not res.retried


def test_prefix_estimate_rounds_as_reference_for_verify_k_24():
    # With k = 24, 7 of the 25 prefix counts give other float32 bits
    # when divided than when multiplied by the reciprocal.  Near
    # duplicates at the default perturbation rates spread the counts,
    # and edge threshold 0.15 keeps every run member in the buffer.
    notes, _ = inject_near_duplicates(make_i2b2_like(40, seed=0), 24, seed=1)
    packed = shingle.pack_documents([shingle.tokenize(t) for t in notes])
    data, lengths = packed.tokens, packed.lengths
    out, _ = _run_both("streamed", dict(BASE, verify_k=24, band_groups=5,
                                        edge_threshold=0.15),
                       data, lengths)
    counts = np.arange(25, dtype=np.float32)
    divided = counts / np.float32(24)
    multiplied = counts * (np.float32(1) / np.float32(24))
    differ = set(divided[divided != multiplied].view(np.uint32).tolist()) | \
        set(multiplied[divided != multiplied].view(np.uint32).tolist())
    seen = set()
    for g in out["groups"]:
        seen |= set(g["prescreen_sims"][g["edge_mask"]].numpy()
                    .view(np.uint32).tolist())
    assert seen & differ


def _overflow_docs():
    rng = np.random.RandomState(1)
    vocab = [f"t{i}" for i in range(300)]
    docs = [list(rng.choice(vocab, size=48)) for _ in range(32)]
    for i in range(1, 10):
        docs[i] = docs[0]      # 10-way duplicate group
    return shingle.pack_documents(docs)


@pytest.mark.parametrize("fallback", [True, False])
@pytest.mark.parametrize("stage2", ["host", "device"])
def test_edge_buffer_overflow_matches_reference(fallback, stage2):
    packed = _overflow_docs()
    cfg = dict(edge_capacity=2, edge_threshold=0.5, bucket_slack=16.0,
               stage2=stage2)
    _, res = _run_both("streamed", cfg, packed.tokens, packed.lengths,
                       tree_threshold=0.4, overflow_fallback=fallback)
    assert res.overflow > 0 and res.retried == fallback
    labels = res.labels()
    if fallback:
        assert len({int(labels[i]) for i in range(10)}) == 1


def test_doc_offsets_shift_ids_as_reference():
    data, lengths = _inputs("fused")
    cfg = dict(BASE, fused_ingest=True, band_groups=2, stage2="device")
    seeds = minhash.default_seeds(100)
    offsets = np.array([2**32 - 20], dtype=np.uint32)   # ids wrap past 2**32
    ref_out = R.make_streamed_dedup_step(R.DistLSHConfig(**cfg), R.docs_mesh())(
        jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(seeds),
        jnp.asarray(offsets))
    port_out = T.make_streamed_dedup_step(
        T.DistLSHConfig(**cfg), T.docs_mesh("cpu"))(data, lengths, seeds,
                                                    offsets)
    assert_step_outputs_equal(port_out, ref_out)
    assert port_out["groups"][0]["device_match_counts"].any()


def test_sharded_engine_matches_host_pipeline():
    """The port's sharded path against the port's ``DedupPipeline.run``
    (estimate mode, threshold 0.88): same signatures, the same sim on
    every pair both evaluate, the same clusters."""
    notes = _notes()
    host = DedupPipeline(DedupConfig(
        edge_threshold=0.88, exact_verification=False,
        verify_backend="numpy"), device="cpu").run(notes)
    packed = shingle.pack_documents([shingle.tokenize(t) for t in notes])
    cfg = T.DistLSHConfig(edge_capacity=4096, edge_threshold=0.88,
                          bucket_slack=16.0)
    out = T.make_dedup_step(cfg, T.docs_mesh("cpu"))(
        packed.tokens, packed.lengths, minhash.default_seeds(100))
    assert np.array_equal(_u32(out["sig"]), host.signatures)
    res = T.cluster_step_output(out, cfg, tree_threshold=0.40,
                                num_docs=len(notes), overflow_fallback=False)
    assert res.overflow == 0 and res.num_edges > 0
    host_sims = {(a, b): s for a, b, s in host.pairs}
    shared = [(a, b, s) for a, b, s in res.pairs if (a, b) in host_sims]
    assert shared
    assert all(s == host_sims[(a, b)] for a, b, s in shared)

    def comps(labels):
        d = defaultdict(list)
        for i, lab in enumerate(labels):
            d[int(lab)].append(i)
        return {frozenset(v) for v in d.values() if len(v) >= 2}
    assert comps(res.labels()) == comps(host.labels)
