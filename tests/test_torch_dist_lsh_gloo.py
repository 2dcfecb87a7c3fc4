"""Four shards: the port's sharded step over gloo against the reference's.

The port runs in four spawned processes (``torch.distributed`` with the
gloo backend, ``device="cpu"``), the reference in one subprocess with
four forced JAX host devices.  Both run every case below on the same
inputs, made here from numpy seeds, and write their outputs to ``.npz``
files: every step output and every field of every
``cluster_step_output`` result must agree bit for bit.  The cases are
those of ``tests/test_distributed.py``'s dedup tests, with the planted
documents placed for 16 documents per device, and a bucket overflow.
"""
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tests.conftest import REPO, run_with_devices

N_SHARDS = 4
SEEDS_M = 100


def _random_docs(seed, vocab_size, n_docs, n_tokens):
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(vocab_size)]
    return [list(rng.choice(vocab, size=n_tokens)) for _ in range(n_docs)]


def _corpora() -> dict:
    """Token lists of 64 documents each, 16 per shard."""
    cross = _random_docs(0, 400, 64, 64)
    # 3, 5 and the near-duplicate 9 on shard 0, 41 on shard 2.
    cross[5] = cross[3]
    cross[41] = cross[3]
    cross[9] = cross[3][:60] + cross[9][:4]
    stage2 = _random_docs(0, 400, 64, 64)
    # Same-shard (1, 5) on shard 0 and (17, 20, 22) on shard 1;
    # cross-shard (3, 41).
    stage2[5] = stage2[1]
    stage2[20] = stage2[17]
    stage2[41] = stage2[3]
    stage2[22] = stage2[17][:60] + stage2[22][:4]
    rows = _random_docs(3, 400, 64, 64)
    # Heads 1-3 on shard 0, members 41-43 on shard 2: three member rows
    # for a row buffer of one.
    for h in (1, 2, 3):
        rows[40 + h] = rows[h]
    chunk = _random_docs(0, 300, 64, 48)
    chunk[63] = chunk[0]       # across shards 0 and 3
    chunk[17] = chunk[16]      # inside shard 1
    group = _random_docs(1, 300, 64, 48)
    for i in range(1, 10):
        group[i] = group[0]    # a 10-way group on shard 0
    return dict(cross=cross, stage2=stage2, rows=rows, chunk=chunk,
                group=group)


BASE = dict(edge_threshold=0.5, bucket_slack=16.0, edge_capacity=512)
DEVICE = dict(BASE, band_groups=5, stage2="device")

# name, corpus, step ("end": make_dedup_step, "streamed"), config,
# doc_offsets base (None: the default), merges (cluster_step_output
# keyword sets).
CASES = [
    # test_distributed.py:9, cross-shard duplicates.
    ("cross_shard", "cross", "end", dict(BASE, bucket_slack=2.0,
                                         edge_capacity=256), None, [{}]),
    # :101, chunked doc_offsets.
    ("chunk_default", "chunk", "end", BASE, None,
     [dict(tree_threshold=0.4)]),
    ("chunk_offsets", "chunk", "end", BASE, 1000,
     [dict(tree_threshold=0.4, doc_id_base=1000)]),
    # :204, device stage 2 with the row exchange on and off, against the
    # end-of-step host path.
    ("stage2_host", "stage2", "end", BASE, None,
     [dict(overflow_fallback=False)]),
    ("stage2_rc1024", "stage2", "streamed",
     dict(DEVICE, sig_row_capacity=1024), None,
     [dict(overflow_fallback=False)]),
    ("stage2_rc0", "stage2", "streamed", dict(DEVICE, sig_row_capacity=0),
     None, [dict(overflow_fallback=False)]),
    # :276, row-buffer overflow.
    ("rows_rc1", "rows", "streamed",
     dict(BASE, stage2="device", sig_row_capacity=1), None,
     [dict(overflow_fallback=False)]),
    # A bucket overflow: capacity ceil(0.5 * 16 / 4) = 2 entries.
    ("bucket_overflow", "group", "streamed",
     dict(BASE, bucket_slack=0.5, band_groups=2), None,
     [dict(tree_threshold=0.4), dict(tree_threshold=0.4,
                                     overflow_fallback=False)]),
]

RESULT_FIELDS = ("num_edges", "overflow", "retried", "device_scored",
                 "host_rescored", "row_overflow")


def make_inputs(path: str) -> None:
    """Pack every corpus into ``path`` (.npz) with the port's host code."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import minhash, shingle

    arrays = {"seeds": minhash.default_seeds(SEEDS_M)}
    for name, docs in _corpora().items():
        packed = shingle.pack_documents(docs)
        arrays[f"{name}.tokens"] = packed.tokens
        arrays[f"{name}.lengths"] = packed.lengths
    np.savez(path, **arrays)


def _host(key: str, x) -> np.ndarray:
    """A step output as numpy; the port's int32 words as uint32."""
    a = np.asarray(x)
    if key in ("sig", "edges") and a.dtype == np.int32:
        return a.view(np.uint32)
    return a


def run_cases(dl, mesh, inputs, *, merge: bool) -> dict:
    """Run every case through ``dl`` (``repro.core.dist_lsh`` or
    ``repro_torch.core.dist_lsh``); the outputs as numpy arrays."""
    out = {}
    for name, corpus, kind, cfg, base, merges in CASES:
        cfg = dl.DistLSHConfig(**cfg)
        make = dl.make_dedup_step if kind == "end" \
            else dl.make_streamed_dedup_step
        tokens = inputs[f"{corpus}.tokens"]
        args = [tokens, inputs[f"{corpus}.lengths"], inputs["seeds"]]
        if base is not None:
            d_loc = len(tokens) // N_SHARDS
            args.append(np.uint32(base) + np.uint32(d_loc)
                        * np.arange(N_SHARDS, dtype=np.uint32))
        step_out = make(cfg, mesh)(*args)
        out[f"{name}.sig"] = _host("sig", step_out["sig"])
        for g, g_out in enumerate(step_out.get("groups", [step_out])):
            for key, val in g_out.items():
                if key not in ("sig", "band_start"):
                    out[f"{name}.g{g}.{key}"] = _host(key, val)
        if not merge:
            continue
        for i, kw in enumerate(merges):
            res = dl.cluster_step_output(step_out, cfg, num_docs=len(tokens),
                                         **kw)
            pre = f"{name}.m{i}"
            out[f"{pre}.labels"] = res.labels()
            out[f"{pre}.pair_ids"] = np.array(
                [(a, b) for a, b, _ in res.pairs], dtype=np.int64)
            out[f"{pre}.pair_sims"] = np.array(
                [s for _, _, s in res.pairs], dtype=np.float32)
            out[f"{pre}.fields"] = np.array(
                [int(getattr(res, f)) for f in RESULT_FIELDS])
            out[f"{pre}.device_stats"] = res.device_stats
    return out


def _port_worker(rank: int, inputs_path: str, init_file: str,
                 out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=N_SHARDS)
    try:
        from repro_torch.core import dist_lsh

        out = run_cases(dist_lsh, dist_lsh.docs_mesh("cpu"),
                        np.load(inputs_path), merge=rank == 0)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


REFERENCE = """
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import jax
    assert jax.device_count() == {n}
    from repro.core import dist_lsh
    from tests.test_torch_dist_lsh_gloo import run_cases
    out = run_cases(dist_lsh, dist_lsh.docs_mesh(), np.load({inputs!r}),
                    merge=True)
    np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(port, reference) outputs of every case; both runs overlap."""
    tmp = tmp_path_factory.mktemp("four_shards")
    inputs = str(tmp / "inputs.npz")
    make_inputs(inputs)
    port_path, ref_path = str(tmp / "port.npz"), str(tmp / "ref.npz")
    workers = mp.start_processes(
        _port_worker, args=(inputs, str(tmp / "pg_init"), port_path),
        nprocs=N_SHARDS, join=False, start_method="spawn")
    try:
        run_with_devices(REFERENCE.format(repo=REPO, n=N_SHARDS,
                                          inputs=inputs, out=ref_path),
                         n_devices=N_SHARDS, timeout=300)
    finally:
        deadline = time.monotonic() + 300
        while not workers.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in workers.processes:
                    proc.kill()
                raise TimeoutError("the four gloo processes did not end")
    with np.load(port_path) as port, np.load(ref_path) as ref:
        return dict(port), dict(ref)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_four_shard_case_matches_reference(outputs, name):
    port, ref = outputs
    keys = sorted(k for k in ref if k.startswith(name + "."))
    assert keys and keys == sorted(k for k in port if k.startswith(name + "."))
    for key in keys:
        want, got = ref[key], port[key]
        if key.endswith(".device_match_counts"):
            got = got.astype(np.float32)  # the port's counts are int32
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key


def _fields(out, name, i=0):
    return dict(zip(RESULT_FIELDS, out[f"{name}.m{i}.fields"].tolist()))


def test_four_shards_find_the_planted_duplicates(outputs):
    port, _ = outputs
    lab = port["cross_shard.m0.labels"]
    assert lab[3] == lab[5] == lab[41] == lab[9]
    lab = port["stage2_rc1024.m0.labels"]
    assert lab[1] == lab[5] and lab[17] == lab[20] == lab[22]
    assert lab[3] == lab[41]
    assert np.array_equal(lab, port["stage2_host.m0.labels"])
    assert np.array_equal(port["stage2_rc0.m0.labels"], lab)


def test_four_shards_offsets_and_device_scores(outputs):
    port, _ = outputs
    ids = port["chunk_offsets.g0.edges"][port["chunk_offsets.g0.edge_mask"]]
    assert ids.size and ids.min() >= 1000 and ids.max() < 1064
    lab = port["chunk_offsets.m0.labels"]
    assert lab[0] == lab[63] and lab[16] == lab[17]
    on, off = _fields(port, "stage2_rc1024"), _fields(port, "stage2_rc0")
    assert on["device_scored"] > 0 and on["host_rescored"] == 0
    assert on["row_overflow"] == 0
    assert off["host_rescored"] > 0
    rows = _fields(port, "rows_rc1")
    assert rows["row_overflow"] > 0 and rows["host_rescored"] > 0
    ovf, no_fallback = (_fields(port, "bucket_overflow", i) for i in (0, 1))
    assert ovf["overflow"] > 0 and ovf["retried"] and not no_fallback["retried"]
    lab = port["bucket_overflow.m0.labels"]
    assert len(set(lab[:10].tolist())) == 1
