"""Port parity for the slice as a whole: ``DedupPipeline.run`` and the corpus.

The port's pipeline is built from the reference's config and seeds
(``DedupPipeline.from_reference``) and must return the reference's
labels, keep mask, signatures, bands and (a, b, sim) list bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.pipeline as ref_pipeline
import repro.data as ref_data
import repro_torch.core.pipeline as pipeline_mod
import repro_torch.data as data
from repro_torch.core import shingle
from repro_torch.core.pipeline import DedupConfig, DedupPipeline


@pytest.fixture(scope="module")
def notes():
    notes, _ = ref_data.inject_near_duplicates(
        ref_data.make_i2b2_like(60, seed=0), 30, seed=1)
    return notes + ["", "short note only", notes[3]]


# -- corpus --------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(5, 0), (40, 7)])
def test_corpus_strings_match_reference(n, seed):
    base = data.make_i2b2_like(n, seed=seed)
    assert base == ref_data.make_i2b2_like(n, seed=seed)
    got = data.inject_near_duplicates(base, 25, seed=seed + 1)
    assert got == ref_data.inject_near_duplicates(base, 25, seed=seed + 1)
    rng_a, rng_b = np.random.RandomState(seed), np.random.RandomState(seed)
    assert data.perturb(base[0], 0.3, rng_a) == \
        ref_data.perturb(base[0], 0.3, rng_b)


def test_paper_testsets_match_reference():
    got_notes, got_srcs = data.accuracy_testset(seed=2)
    want_notes, want_srcs = ref_data.accuracy_testset(seed=2)
    assert got_notes == want_notes and list(got_srcs) == list(want_srcs)
    assert data.clustering_testset(seed=3) == ref_data.clustering_testset(seed=3)


# -- the slice end to end ------------------------------------------------------

# (reference config, overrides for the port's side).  The kernel backend's
# oracle is the reference's numpy backend: its Pallas estimate is 1 ulp off
# the numpy estimator for some counts, while K2's counts / M is not.
CONFIGS = {
    "exact": (dict(), {}),
    "exact_fused": (dict(fused_ingest=True), {}),
    "estimate_numpy": (dict(exact_verification=False, verify_backend="numpy"),
                       {}),
    "estimate_fused_kernel": (
        dict(exact_verification=False, fused_ingest=True,
             verify_backend="numpy", verify_batch="band"),
        dict(use_pallas=True, verify_backend="pallas")),
    "estimate_byte": (
        dict(byte_ingest=True, exact_verification=False,
             verify_backend="numpy"), {}),
    "exact_staged_kernel": (dict(use_pallas=True), {}),
    "estimate_staged_kernel": (
        dict(use_pallas=True, exact_verification=False,
             verify_backend="numpy", verify_batch="band"),
        dict(verify_backend="pallas")),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_matches_reference(notes, name):
    ref_fields, port_overrides = CONFIGS[name]
    ref_cfg = ref_pipeline.DedupConfig(store="memory", **ref_fields)
    ref_pipe = ref_pipeline.DedupPipeline(ref_cfg)
    want = ref_pipe.run(notes)
    fields = {**dataclasses.asdict(ref_cfg), **port_overrides}
    pipe = DedupPipeline.from_reference(fields, ref_pipe.seeds, device="cpu")
    got = pipe.run(notes)
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.keep_mask, want.keep_mask)
    assert np.array_equal(got.signatures, want.signatures)
    assert np.array_equal(got.bands, want.bands)
    assert got.signatures.dtype == np.uint32 and got.bands.dtype == np.uint32
    assert [(a, b) for a, b, _ in got.pairs] == \
        [(a, b) for a, b, _ in want.pairs]
    got_sims = np.array([s for _, _, s in got.pairs], dtype=np.float32)
    want_sims = np.array([s for _, _, s in want.pairs], dtype=np.float32)
    assert np.array_equal(got_sims, want_sims)
    assert got.num_clusters == want.num_clusters > 0
    assert got.stats.pairs_evaluated == want.stats.pairs_evaluated


def test_staged_kernel_config_maps_and_runs_k3_k4(notes, monkeypatch):
    ref_cfg = ref_pipeline.DedupConfig(store="memory", use_pallas=True)
    pipe = DedupPipeline.from_reference(
        dataclasses.asdict(ref_cfg), ref_pipeline.DedupPipeline(ref_cfg).seeds,
        device="cpu")
    assert pipe.config.use_kernels and not pipe.config.fused_ingest
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    # The pipeline calls the kernel modules' functions (k3, k4), so the spy
    # sits on those modules' attributes.
    spy(pipeline_mod.k3, "ngram_hashes")
    spy(pipeline_mod.k4, "minhash_signatures")
    sig = pipe.compute_signatures(pipe.tokenize(notes))
    assert calls == ["ngram_hashes", "minhash_signatures"]
    assert sig.shape == (len(notes), 100)


def test_compute_arrays_bytes_matches_reference(notes):
    ref_cfg = ref_pipeline.DedupConfig(
        store="memory", byte_ingest=True, exact_verification=False)
    ref_pipe = ref_pipeline.DedupPipeline(ref_cfg)
    pipe = DedupPipeline.from_reference(dataclasses.asdict(ref_cfg),
                                        ref_pipe.seeds, device="cpu")
    want_sig, want_bands = ref_pipe.compute_arrays_bytes(notes, 2048)
    sig, bands = pipe.compute_arrays_bytes(notes, 2048)
    assert np.array_equal(sig, want_sig) and np.array_equal(bands, want_bands)
    assert set(pipe.stage_timings) == {"pack_s", "upload_s", "ingest_s"}
    # The same bits as the host chain without stemming.
    toks = [shingle.tokenize(t, do_stem=False) for t in notes]
    host_sig, host_bands = pipe.compute_arrays(toks)
    assert np.array_equal(sig, host_sig) and np.array_equal(bands, host_bands)
    with pytest.raises(ValueError, match="max doc bytes"):
        pipe.compute_arrays_bytes(notes, 64)


@pytest.mark.parametrize("fused", [False, True])
def test_compute_stages_match_reference(notes, fused):
    ref_cfg = ref_pipeline.DedupConfig(store="memory", fused_ingest=fused)
    ref_pipe = ref_pipeline.DedupPipeline(ref_cfg)
    pipe = DedupPipeline.from_reference(dataclasses.asdict(ref_cfg),
                                        ref_pipe.seeds, device="cpu")
    toks = pipe.tokenize(notes)
    assert toks == ref_pipe.tokenize(notes)
    want_sig, want_bands = ref_pipe.compute_arrays(toks, 256)
    sig, bands = pipe.compute_arrays(toks, 256)
    assert np.array_equal(sig, want_sig) and np.array_equal(bands, want_bands)
    assert np.array_equal(pipe.compute_signatures(toks), want_sig)
    assert np.array_equal(pipe.compute_bands(sig), want_bands)
    assert set(pipe.stage_timings) == {"pack_s", "upload_s", "ingest_s"}


def test_run_times_every_stage_and_verifies_on_device(notes):
    pipe = DedupPipeline(DedupConfig(
        exact_verification=False, fused_ingest=True, use_kernels=True),
        device="cpu")
    res = pipe.run(notes)
    parts = ("pack_s", "upload_s", "ingest_s", "download_s")
    assert res.timings["signatures_s"] == sum(res.timings[k] for k in parts)
    for key in ("tokenize_s", "verifier_build_s", "cluster_s", "verify_s",
                "labels_s", "pairs_s", *parts):
        assert res.timings[key] >= 0
    # The kernel backend reads the signature matrix as a device tensor.
    verifier = pipe.make_verifier([], torch.from_numpy(
        res.signatures.view(np.int32)))
    assert verifier.backend == "kernel" and verifier._host is None


def test_from_reference_maps_names():
    fields = dataclasses.asdict(ref_pipeline.DedupConfig(
        store="memory", use_pallas=True, fused_ingest=True,
        verify_backend="jnp"))
    seeds = np.arange(100, dtype=np.uint32)
    pipe = DedupPipeline.from_reference(fields, seeds, device="cpu")
    assert pipe.config.use_kernels and pipe.config.verify_backend == "torch"
    assert np.array_equal(pipe.seeds, seeds)
    cfg = DedupConfig(use_kernels=True, fused_ingest=True)
    assert cfg.resolved_backend() == "kernel"
    with pytest.raises(ValueError):
        DedupPipeline.from_reference(fields, seeds[:5], device="cpu")


def test_default_device_raises_without_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DedupPipeline(DedupConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DedupPipeline.from_reference({}, np.zeros(100, np.uint32))


@pytest.mark.parametrize("name", ["exact", "estimate_numpy"])
def test_run_under_sqlite_matches_reference(notes, name, monkeypatch):
    """``store="sqlite"``: the one-chunk session's cross-step index is a
    ``SqliteBandStore`` on ``":memory:"``, as the reference's is, and the
    run's outputs equal the reference's sqlite run."""
    import repro_torch.core.session as session_mod

    ref_fields, port_overrides = CONFIGS[name]
    ref_cfg = ref_pipeline.DedupConfig(store="sqlite", **ref_fields)
    ref_pipe = ref_pipeline.DedupPipeline(ref_cfg)
    want = ref_pipe.run(notes)
    fields = {**dataclasses.asdict(ref_cfg), **port_overrides}
    pipe = DedupPipeline.from_reference(fields, ref_pipe.seeds, device="cpu")
    assert pipe.config.store == "sqlite"
    made = []
    store_cls = session_mod.SqliteBandStore
    monkeypatch.setattr(session_mod, "SqliteBandStore",
                        lambda **kw: made.append(kw) or store_cls(**kw))
    got = pipe.run(notes)
    assert len(made) == 1 and made[0]["path"] == ":memory:"
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.keep_mask, want.keep_mask)
    assert np.array_equal(got.signatures, want.signatures)
    assert np.array_equal(got.bands, want.bands)
    assert got.pairs == want.pairs
    assert got.stats.pairs_evaluated == want.stats.pairs_evaluated > 0


def test_byte_ingest_with_exact_verification_raises():
    with pytest.raises(ValueError, match="exact Jaccard"):
        DedupConfig(byte_ingest=True)
    with pytest.raises(ValueError):
        ref_pipeline.DedupConfig(store="memory", byte_ingest=True)
    assert DedupConfig(byte_ingest=True, exact_verification=False).byte_ingest


def test_bad_config_values_raise():
    with pytest.raises(ValueError):
        DedupConfig(verify_backend="pallas")
    with pytest.raises(ValueError):
        DedupConfig(store="redis")


def test_store_default_reads_the_environment(monkeypatch):
    monkeypatch.delenv("REPRO_STORE_BACKEND", raising=False)
    assert DedupConfig().store == "memory"
    monkeypatch.setenv("REPRO_STORE_BACKEND", "memory")
    assert DedupConfig().store == "memory"
    monkeypatch.setenv("REPRO_STORE_BACKEND", "sqlite")
    assert ref_pipeline.DedupConfig().store == "sqlite"
    assert DedupConfig().store == "sqlite"
    monkeypatch.setenv("REPRO_STORE_BACKEND", "redis")
    with pytest.raises(ValueError):
        DedupConfig()


def test_core_exports_the_ported_names_of_the_reference():
    import importlib
    import pkgutil

    import repro.core as ref_core
    import repro_torch.core as core

    modules = [importlib.import_module(f"repro_torch.core.{m.name}")
               for m in pkgutil.iter_modules(core.__path__)]
    ported = {name for name in ref_core.__all__
              if any(hasattr(m, name) for m in modules)}
    assert set(core.__all__) <= set(ref_core.__all__)
    assert ported <= set(core.__all__)
    assert {"CallbackVerifier", "LSHParams", "candidate_probability",
            "candidate_pairs"} <= set(core.__all__)
    assert "merge_cluster_rounds" not in core.__all__
    for name in core.__all__:
        assert getattr(core, name) is not None, name
