"""Port parity of the sharded ``DedupSession`` (``backend="sharded"``).

In process, on one shard without a process group (``device="cpu"``):
the port's session against ``repro``'s ``DedupPipeline.run`` and its
own sharded session (``tests/test_session.py``'s single-device case),
``feed_step_groups`` in its three ``stream`` modes, and the CLI's
``--sharded`` against the reference CLI's report.

On four shards: every case of ``CASES`` runs through the port in four
spawned processes (``torch.distributed`` with the gloo backend) and
through the reference in one subprocess with four forced JAX host
devices, both on the corpus of ``tests/test_distributed.py``'s session
tests.  Every rank writes each snapshot's labels, ``ClusterStats``
counters, (a, b, sim) list and sharded counters to an ``.npz``; every
rank's must equal the reference's bit for bit.
"""
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tests.conftest import REPO, run_with_devices

N_SHARDS = 4
COUNTERS = ("pairs_generated", "pairs_evaluated", "pairs_excluded",
            "pairs_above_edge", "unions_done", "unions_rejected",
            "verify_batches")
SHARDED = ("overflow", "retried", "device_scored", "host_rescored",
           "row_overflow")

# test_distributed.py's session config; buffers of 256 edges hold every
# prescreened edge of these steps (each case checks overflow == 0).
BASE = dict(edge_capacity=256, edge_threshold=0.88, bucket_slack=16.0)
# name, chunks, DistLSHConfig fields, input ("tokens" or "nostem" token
# lists, or "bytes", the texts).  3 chunks of 64 notes leave pad rows on 4 shards
# (22 and 21 notes to shards of 6).
CASES = [
    # test_distributed.py:326, N-step parity with both stage-2 modes.
    *[(f"multistep_{s2}_{n}", n, dict(BASE, band_groups=5, stage2=s2),
       "tokens") for s2 in ("host", "device") for n in (2, 4)],
    # :395, fused ingest against the staged sessions above.
    ("fused_host_2", 2, dict(BASE, band_groups=5, fused_ingest=True),
     "tokens"),
    ("fused_device_2", 2, dict(BASE, band_groups=5, stage2="device",
                               fused_ingest=True), "tokens"),
    # :446, byte ingest against fused no-stem tokens (its device cell).
    *[(f"{kind}_device_3", 3, dict(BASE, band_groups=1, stage2="device",
                                   fused_ingest=kind == "nostem",
                                   byte_ingest=kind == "bytes"), kind)
      for kind in ("nostem", "bytes")],
    # Edge buffers of 4: the steps overflow and the host retry runs.
    ("overflow", 3, dict(BASE, edge_capacity=4, band_groups=5,
                         stage2="device"), "tokens"),
]
# The reference runs in three subprocesses of about the same time (each
# session compiles its own steps).
REFERENCE_PARTS = (
    ("multistep_device_2", "multistep_device_4", "overflow"),
    ("multistep_host_2", "multistep_host_4", "fused_host_2"),
    ("fused_device_2", "nostem_device_3", "bytes_device_3"),
)


def corpus(data) -> list[str]:
    """``tests/test_distributed.py``'s session corpus, made by ``data``
    (``repro.data`` or ``repro_torch.data``): 56 notes and 8
    near-duplicates."""
    notes = data.make_i2b2_like(56, seed=0)
    notes, _ = data.inject_near_duplicates(notes, 8, frac_low=0.0,
                                           frac_high=0.005, seed=1)
    return notes


def snapshot_arrays(snap, prefix: str) -> dict:
    """A ``ClusterSnapshot`` as numpy arrays under ``prefix``."""
    return {
        f"{prefix}.labels": np.asarray(snap.labels),
        f"{prefix}.pair_ids": np.array([(a, b) for a, b, _ in snap.pairs],
                                       dtype=np.int64).reshape(-1, 2),
        f"{prefix}.pair_sims": np.array([s for _, _, s in snap.pairs],
                                        dtype=np.float32),
        f"{prefix}.stats": np.array([getattr(snap.stats, f)
                                     for f in COUNTERS]),
        f"{prefix}.sharded": np.array([getattr(snap, f) for f in SHARDED]),
        f"{prefix}.n_docs": np.array(snap.n_docs),
    }


def run_cases(session_cls, dist_cls, config_cls, shingle, data, names=None,
              **session_kw):
    """Every case (or those in ``names``) through ``session_cls`` (the
    reference's ``DedupSession`` or the port's, with ``DistLSHConfig``,
    ``DedupConfig``, ``shingle`` and ``data`` from the same package); the
    snapshot after each chunk as arrays.  Imports no torch, so the
    reference's subprocess does not pay for it."""
    notes = corpus(data)
    # Token lists made once (the sessions take them pre-tokenized); the
    # one-shard tests below go through the session's own tokenize.
    inputs = {"tokens": [shingle.tokenize(t) for t in notes],
              "nostem": [shingle.tokenize(t, do_stem=False) for t in notes],
              "bytes": notes}
    out = {}
    for name, n_chunks, dcfg, kind in CASES:
        if names is not None and name not in names:
            continue
        docs = inputs[kind]
        cfg = config_cls(edge_threshold=0.88, exact_verification=False,
                         byte_ingest=kind == "bytes", store="memory")
        sess = session_cls(cfg, backend="sharded",
                           dist_config=dist_cls(**dcfg), **session_kw)
        chunks = [[docs[i] for i in idx] for idx in
                  np.array_split(np.arange(len(docs)), n_chunks)]
        for i, snap in enumerate(sess.ingest_stream(
                chunks, tokenized=kind != "bytes")):
            out.update(snapshot_arrays(snap, f"{name}.s{i}"))
    return out


def _port_worker(rank: int, init_file: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=N_SHARDS)
    try:
        from repro_torch import data
        from repro_torch.core import DedupConfig, DedupSession, shingle
        from repro_torch.core.dist_lsh import DistLSHConfig

        out = run_cases(DedupSession, DistLSHConfig,
                        lambda **kw: DedupConfig(verify_backend="kernel",
                                                 **kw),
                        shingle, data, device="cpu")
        np.savez(os.path.join(out_dir, f"port{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


REFERENCE = """
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import jax
    assert jax.device_count() == {n}
    from repro import data
    from repro.core import DedupConfig, DedupSession, shingle
    from repro.core.dist_lsh import DistLSHConfig
    from tests.test_torch_sharded_session import run_cases
    np.savez({out!r}, **run_cases(DedupSession, DistLSHConfig, DedupConfig,
                                  shingle, data, names={names!r}))
"""


@pytest.fixture(scope="module")
def four_shards(tmp_path_factory):
    """(every rank's outputs, the reference's); both runs overlap."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("sharded_session")
    workers = mp.start_processes(
        _port_worker, args=(str(tmp / "pg_init"), str(tmp)),
        nprocs=N_SHARDS, join=False, start_method="spawn")
    refs = [str(tmp / f"ref{i}.npz") for i in range(len(REFERENCE_PARTS))]
    try:
        with ThreadPoolExecutor(len(refs)) as pool:
            for fut in [pool.submit(
                    run_with_devices,
                    REFERENCE.format(repo=REPO, n=N_SHARDS, out=path,
                                     names=list(names)),
                    n_devices=N_SHARDS, timeout=300)
                    for names, path in zip(REFERENCE_PARTS, refs)]:
                fut.result()
    finally:
        deadline = time.monotonic() + 300
        while not workers.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in workers.processes:
                    proc.kill()
                raise TimeoutError("the four gloo processes did not end")
    ranks = []
    for r in range(N_SHARDS):
        with np.load(str(tmp / f"port{r}.npz")) as f:
            ranks.append(dict(f))
    ref = {}
    for path in refs:
        with np.load(path) as f:
            ref.update(f)
    return ranks, ref


def _field(out, name, i, key):
    return out[f"{name}.s{i}.{key}"]


def _last(out, name):
    n = max(int(k.split(".")[1][1:]) for k in out if k.startswith(name + "."))
    return {key: _field(out, name, n, key)
            for key in ("labels", "pair_ids", "pair_sims", "stats",
                        "sharded", "n_docs")}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_four_rank_session_matches_reference(four_shards, name):
    """Every rank's snapshot after every chunk equals the reference's:
    labels, ``ClusterStats``, (a, b, sim) and the sharded counters."""
    ranks, ref = four_shards
    keys = sorted(k for k in ref if k.startswith(name + "."))
    assert keys
    for rank, port in enumerate(ranks):
        assert keys == sorted(k for k in port if k.startswith(name + "."))
        for key in keys:
            want, got = ref[key], port[key]
            assert got.shape == want.shape, (rank, key)
            assert got.tobytes() == want.astype(got.dtype).tobytes(), \
                (rank, key)


def _pairs(last) -> dict:
    return dict(zip(map(tuple, last["pair_ids"].tolist()),
                    last["pair_sims"].tolist()))


def test_four_rank_session_contracts(four_shards):
    """What ``tests/test_distributed.py``'s session tests pin, on the
    port's rank 0: nothing overflows in the default buffers, and device
    stage 2 then re-scores nothing on the host; fused equals staged and
    byte equals no-stem tokens in labels and pairs; the small buffers
    overflow, the retry runs, and the partition is the staged one's."""
    port = four_shards[0][0]
    counts = {c[0]: dict(zip(SHARDED, _last(port, c[0])["sharded"].tolist()))
              for c in CASES}
    for name, c in counts.items():
        if name != "overflow":
            assert c["overflow"] == c["row_overflow"] == c["retried"] == 0
        if "device" in name:
            assert c["host_rescored"] == 0, name
    for a, b in (("multistep_host_2", "fused_host_2"),
                 ("multistep_device_2", "fused_device_2"),
                 ("nostem_device_3", "bytes_device_3")):
        x, y = _last(port, a), _last(port, b)
        np.testing.assert_array_equal(x["labels"], y["labels"])
        assert _pairs(x) and _pairs(x) == _pairs(y)
    assert counts["overflow"]["overflow"] > 0
    assert counts["overflow"]["retried"] >= 1
    np.testing.assert_array_equal(
        _last(port, "overflow")["labels"],
        _last(port, "multistep_host_2")["labels"])
    assert int(_last(port, "overflow")["n_docs"]) == 64


# -- one shard, in process -----------------------------------------------------

ONE_SHARD = dict(ngram=4, num_hashes=20, edge_threshold=0.5)


def _one_shard_docs() -> list[str]:
    """``tests/test_session.py``'s single-device corpus: 24 random docs,
    doc 3 copied to doc 5 and, across the chunks, to doc 21."""
    rng = np.random.RandomState(0)
    vocab = [f"t{i}" for i in range(300)]
    docs = [" ".join(rng.choice(vocab, size=48)) for _ in range(24)]
    docs[5] = docs[3]
    docs[21] = docs[3]
    return docs


def _one_shard_dist(pkg, stage2: str):
    return pkg.DistLSHConfig(**ONE_SHARD, verify_k=8, edge_capacity=256,
                             bucket_slack=16.0, band_groups=2, stage2=stage2)


@pytest.mark.parametrize("stage2", ["host", "device"])
def test_one_shard_session_matches_reference(stage2):
    """``tests/test_session.py:154`` on the port: a one-shard sharded
    session over two chunks equals the reference's sharded session
    snapshot for snapshot, and the reference's one-shot ``run`` in
    labels and shared sims."""
    import repro.core.dist_lsh as ref_dist
    import repro.core.pipeline as ref_pipeline
    import repro.core.session as ref_session
    from repro_torch.core import DedupConfig, DedupSession, dist_lsh

    docs = _one_shard_docs()
    fields = dict(ONE_SHARD, exact_verification=False, store="memory")
    ref_cfg = ref_pipeline.DedupConfig(**fields)
    one = ref_pipeline.DedupPipeline(ref_cfg).run(docs)
    ref = ref_session.DedupSession(ref_cfg, backend="sharded",
                                   dist_config=_one_shard_dist(ref_dist,
                                                               stage2))
    port = DedupSession(DedupConfig(verify_backend="kernel", **fields),
                        backend="sharded",
                        dist_config=_one_shard_dist(dist_lsh, stage2),
                        device="cpu")
    for idx in np.array_split(np.arange(len(docs)), 2):
        chunk = [docs[i] for i in idx]
        got = snapshot_arrays(port.ingest(chunk), "")
        want = snapshot_arrays(ref.ingest(chunk), "")
        for key in want:
            assert got[key].tobytes() == want[key].astype(
                got[key].dtype).tobytes(), key
    snap = port.snapshot()
    np.testing.assert_array_equal(snap.labels, one.labels)
    sims = {(a, b): s for a, b, s in one.pairs}
    shared = [(a, b, s) for a, b, s in snap.pairs if (a, b) in sims]
    assert shared and all(s == sims[(a, b)] for a, b, s in shared)
    assert snap.overflow == 0
    assert snap.labels[3] == snap.labels[5] == snap.labels[21]
    if stage2 == "device":
        # One shard: every in-chunk edge is scored on the device.
        assert snap.device_scored > 0 and snap.host_rescored == 0
    assert port.view().n_docs == len(docs)


def test_sharded_session_checks_its_configuration():
    """The step's hash parameters and device must be the session's."""
    import torch

    from repro_torch.core import DedupConfig, DedupSession, dist_lsh

    cfg = DedupConfig(**ONE_SHARD, exact_verification=False, store="memory")
    with pytest.raises(ValueError, match="DistLSHConfig.num_hashes=100"):
        DedupSession(cfg, backend="sharded", device="cpu",
                     dist_config=dist_lsh.DistLSHConfig(ngram=4))
    mesh = dist_lsh.DocsMesh(group=None, rank=0, n_dev=1,
                             device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="the mesh runs on cuda:0"):
        DedupSession(cfg, backend="sharded", device="cpu", mesh=mesh,
                     dist_config=_one_shard_dist(dist_lsh, "host"))


def test_feed_step_groups_is_the_same_in_every_stream_mode():
    """``stream`` True, False and None give one feed: edges, overflow,
    device stats, the accumulator's counters and pairs, and the
    registry's pass-throughs."""
    import torch

    from repro_torch.core import dist_lsh, minhash, shingle
    from repro_torch.core.engine import ClusterAccumulator
    from repro_torch.core.verify import DeviceScoredEdgeVerifier

    docs = _one_shard_docs()
    packed = shingle.pack_documents([shingle.tokenize(t) for t in docs])
    cfg = _one_shard_dist(dist_lsh, "device")
    out = dist_lsh.make_streamed_dedup_step(cfg, dist_lsh.docs_mesh("cpu"))(
        packed.tokens, packed.lengths, minhash.default_seeds(20))
    feeds = []
    for stream in (True, False, None):
        v = DeviceScoredEdgeVerifier(out["sig"], backend="kernel",
                                     device="cpu")
        acc = ClusterAccumulator(len(docs), v, cfg.edge_threshold, 0.4)
        feed = dist_lsh.feed_step_groups(acc, out, cfg, num_docs=len(docs),
                                         verifier=v, stream=stream)
        feeds.append((feed.num_edges, feed.overflow, feed.row_overflow,
                      feed.device_stats.tolist(),
                      [[getattr(s, f) for f in COUNTERS]
                       for s in feed.group_stats],
                      acc.pairs, v.n_passthrough, v.n_rescored))
    assert feeds[0][0] > 0 and feeds[0][6] > 0
    assert feeds[0] == feeds[1] == feeds[2]
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert dist_lsh._resolve_stream(None, card)
    assert dist_lsh._resolve_stream(None, cpu) == ((os.cpu_count() or 1) > 1)
    assert not dist_lsh._resolve_stream(False, card)


_TIMES = re.compile(r"\(\d+ pairs/s\)|[\d.]+s total|in [\d.]+ ms")


def test_sharded_cli_report_matches_reference(capsys):
    """``--sharded`` on ``--device cpu`` (a one-rank gloo group the
    command makes and destroys) reports the reference CLI's counts, and
    its query demo runs on the session's view."""
    import torch.distributed as dist

    import repro.launch.dedup as ref_dedup
    from repro_torch.launch import dedup

    common = ["--notes", "40", "--dups", "25", "--steps", "2", "--sharded",
              "--band-groups", "5", "--fused-ingest", "--query", "4"]
    reports = []
    for main, argv in ((dedup.main, common + ["--device", "cpu"]),
                       (ref_dedup.main, common)):
        main(argv)
        reports.append([_TIMES.sub("", ln)
                        for ln in capsys.readouterr().out.splitlines()])
    assert reports[0] == reports[1]
    assert reports[0][1].startswith(
        "sharded[1 devices x 5 band-group(s) x 2 step(s)]: 65 docs")
    assert reports[0][2].startswith("query[view v1]: 4/4 re-queried notes")
    assert not dist.is_initialized()
