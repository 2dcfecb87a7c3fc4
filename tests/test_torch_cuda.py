"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc (the kernels have no CPU
mode) and skips elsewhere.  The file imports neither JAX nor ``repro``,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import minhash, shingle
from repro_torch.core.dist_lsh import (
    DistLSHConfig,
    cluster_step_output,
    docs_mesh,
    make_streamed_dedup_step,
)
from repro_torch.core.hashing import u32_from_numpy
from repro_torch.core.minhash import estimate_from_counts
from repro_torch.core.pipeline import DedupConfig, DedupPipeline
from repro_torch.core.verify import SignatureVerifier
from repro_torch.data import inject_near_duplicates, make_i2b2_like
from repro_torch.configs import get_reduced
from repro_torch.kernels import bandfold as k5
from repro_torch.kernels import byte_shingle as k6
from repro_torch.kernels import fused_ingest as k1
from repro_torch.kernels import minhash as k4
from repro_torch.kernels import ngram as k3
from repro_torch.kernels import flash_attention as k8
from repro_torch.kernels import sigjaccard as k2
from repro_torch.launch.serve import serve_batch
from repro_torch.models import lm
from repro_torch.serving import DedupQueryService, ServeEngine
from repro_torch.core.session import DedupSession

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _packed(D, L, M, seed, device):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 2**32, size=(D, L), dtype=np.uint64)
    lengths = rng.randint(0, L + 1, size=D).astype(np.int32)
    lengths[: min(D, 9)] = np.arange(min(D, 9))  # empty and short documents
    lengths[-1] = L
    seeds = rng.randint(0, 2**32, size=M, dtype=np.uint64)
    return (u32_from_numpy(tokens.astype(np.uint32), device),
            torch.from_numpy(lengths).to(device),
            u32_from_numpy(seeds.astype(np.uint32), device))


@pytest.mark.parametrize("D,L,M,n,r", [
    (300, 40, 16, 8, 2),
    (64, 5, 16, 8, 2),       # L < n
    (50, 33, 15, 3, 3),      # M not a multiple of the warp
    (40, 2500, 100, 8, 2),   # L longer than the pool: rounds
    (3, 64, 260, 8, 2),      # M larger than the block
    (300, 5, 1, 8, 1),       # M = 1, L < n: 32 documents a block (kMaxDocs)
    (1000, 256, 100, 8, 2),  # the main path's lane map: 25 lanes x 5 slices
    (200, 7, 128, 8, 2),     # L < n, several documents a block
    (130, 40, 128, 3, 4),    # r > 2
    (37, 300, 260, 8, 2),    # S = 8, 33 lanes x 3 slices
    (9, 4100, 260, 5, 5),    # rows over two rounds of the pool
    (5, 64, 2050, 8, 2),     # seed lanes in passes
])
def test_fused_ingest_kernel_matches_plain(cuda, D, L, M, n, r):
    args = _packed(D, L, M, seed=L, device=cuda)
    k1.launches = 0
    got = k1.fused_ingest(*args, n=n, r=r)
    torch.cuda.synchronize()
    assert k1.launches == 1
    for g, w in zip(got, k1.fused_ingest_plain(*args, n=n, r=r)):
        assert torch.equal(g, w)


def test_ingest_schedules_match_the_python_side(cuda):
    # K1's map as the CPU emulation walks it (tests/test_torch_ingest_schedule.py,
    # which imports JAX only inside its reference tests).
    from test_torch_ingest_schedule import lane_map

    assert k1.schedule(1, 5)["docs"] == 32
    for M in list(range(1, 300)) + [1000, 2050, 5000]:
        for L in (1, 3, 5, 8, 40, 256, 1024, 1025, 2500, 4100):
            assert k1.schedule(M, L) == lane_map(M, L), (M, L)
    data = torch.zeros(4 * 16 + 1, dtype=torch.uint8, device=cuda)
    out = torch.zeros(64, dtype=torch.int32, device=cuda)
    assert k6.schedule(data, out, out) == "vector"
    assert k6.schedule(data[1:], out, out) == "scalar"
    assert k6.schedule(data, out[1:], out) == "scalar"
    assert k6.schedule(data, out, out[3:]) == "scalar"


def test_pair_counts_kernel_matches_plain(cuda):
    rng = np.random.RandomState(13)
    D, M, P = 1000, 100, 20000
    sig = u32_from_numpy(rng.randint(0, 3, size=(D, M)).astype(np.uint32),
                         cuda)
    a = torch.from_numpy(rng.randint(0, D, size=P)).to(cuda)
    b = torch.from_numpy(rng.randint(0, D, size=P)).to(cuda)
    b[:100] = a[:100]
    k2.launches = 0
    got = k2.pair_counts(sig, a, b)
    torch.cuda.synchronize()
    assert k2.launches == 1
    assert torch.equal(got, k2.pair_counts_plain(sig, a, b))
    # The kernel reads indices unchecked; the verifier checks them first.
    bad = np.stack([a.cpu().numpy(), b.cpu().numpy()], axis=1)
    bad[0, 0] = D
    verifier = SignatureVerifier(sig, backend="kernel", device=cuda)
    with pytest.raises(IndexError):
        verifier(bad)
    assert k2.launches == 1


def test_estimate_from_counts_is_correctly_rounded_on_card(cuda):
    # Dividing by a Python scalar on the card multiplies by its
    # reciprocal; the estimate must still equal numpy's division.
    counts = torch.arange(101, dtype=torch.int32, device=cuda)
    got = estimate_from_counts(counts, 100).cpu().numpy()
    want = np.arange(101, dtype=np.float32) / np.float32(100)
    assert np.array_equal(got, want)


def test_pipeline_with_kernels_matches_plain_path(cuda):
    notes, _ = inject_near_duplicates(make_i2b2_like(200, seed=0), 100,
                                      seed=1)
    kern = DedupPipeline(DedupConfig(
        exact_verification=False, fused_ingest=True, use_kernels=True,
        verify_batch="band"), device=cuda).run(notes)
    plain = DedupPipeline(DedupConfig(
        exact_verification=False, verify_backend="numpy",
        verify_batch="band"), device=cuda).run(notes)
    assert np.array_equal(kern.signatures, plain.signatures)
    assert np.array_equal(kern.bands, plain.bands)
    assert np.array_equal(kern.labels, plain.labels)
    assert kern.pairs == plain.pairs


@pytest.mark.parametrize("D,L,n", [
    (300, 40, 8),
    (64, 5, 8),       # L < n
    (20, 700, 3),     # several tiles of 256
    (3, 2500, 8),
    (500, 4, 1),      # n = 1; one quad a row
    (40, 4, 13),      # L < n on the vector path
    (30, 257, 13),    # L % 4 != 0: the scalar path
    (16384, 256, 8),  # the main path's matrix: tiles strided over the grid
])
def test_ngram_kernel_matches_plain(cuda, D, L, n):
    tokens, lengths, _ = _packed(D, L, 1, seed=L + n, device=cuda)
    k3.launches = 0
    got = k3.ngram_hashes(tokens, lengths, n=n)
    torch.cuda.synchronize()
    assert k3.launches == 1
    assert k3.schedule(tokens, *got) == ("vector" if L % 4 == 0 else "scalar")
    for g, w in zip(got, k3.ngram_hashes_plain(tokens, lengths, n=n)):
        assert torch.equal(g, w)
    assert got[1].dtype == torch.bool and bool(got[1].any())


@pytest.mark.parametrize("D,L,n", [(300, 40, 8), (41, 256, 13)])
def test_ngram_kernel_scalar_path_on_a_misaligned_view(cuda, D, L, n):
    """A token view one word into its storage is contiguous but not
    16-byte aligned: the kernel takes the scalar path, says so, and
    agrees, hashes and validity."""
    tokens, lengths, _ = _packed(D, L, 1, seed=L + n + 1, device=cuda)
    store = torch.zeros(D * L + 1, dtype=torch.int32, device=cuda)
    view = store[1:].view(D, L)
    view.copy_(tokens)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    got = k3.ngram_hashes(view, lengths, n=n)
    torch.cuda.synchronize()
    assert k3.schedule(view, *got) == "scalar"
    for g, w in zip(got, k3.ngram_hashes_plain(view, lengths, n=n)):
        assert torch.equal(g, w)


def _masks(D, L, seed):
    """Row masks as tests/test_torch_staged_schedule.py's MASKS: random
    0.8 everywhere, then none, all, 1-in-64, a prefix and a single
    position in rows 0-4."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(D, L) < 0.8
    valid[0] = False  # no valid position: U32_MAX
    valid[1] = True
    valid[2] = np.arange(L) % 64 == 5 % L
    valid[3] = np.arange(L) < rng.randint(1, L + 1)
    valid[4] = np.arange(L) == rng.randint(0, L)
    return valid


@pytest.mark.parametrize("D,L,M", [
    (200, 40, 100),
    (30, 200, 1),
    (30, 200, 130),    # more seeds than threads
    (5, 2500, 260),    # several L tiles
    (1000, 256, 100),  # the main path's map: 8 rows a block
    (40, 256, 128),
    (13, 129, 260),    # L % 4 != 0: the scalar path
    (7, 64, 2050),     # seed lanes in passes
    (6, 4100, 100),    # rows over three rounds of the pool
    (301, 4, 7),       # 32 rows a block
])
def test_minhash_kernel_matches_plain(cuda, D, L, M):
    tokens, _, seeds = _packed(D, L, M, seed=D + L + M, device=cuda)
    valid = torch.from_numpy(_masks(D, L, seed=L)).to(cuda)
    k4.launches = 0
    got = k4.minhash_signatures(tokens, valid, seeds)
    torch.cuda.synchronize()
    assert k4.launches == 1
    assert k4.path(tokens, valid) == ("vector" if L % 4 == 0 else "scalar")
    assert torch.equal(got, k4.minhash_signatures_plain(tokens, valid, seeds))
    assert bool((got[0] == -1).all())


def test_minhash_kernel_scalar_path_on_a_misaligned_view(cuda):
    D, L, M = 40, 256, 100
    tokens, _, seeds = _packed(D, L, M, seed=3, device=cuda)
    valid = torch.from_numpy(_masks(D, L, seed=4)).to(cuda)
    store = torch.zeros(D * L + 2, dtype=torch.int32, device=cuda)
    view = store[2:].view(D, L)
    view.copy_(tokens)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    got = k4.minhash_signatures(view, valid, seeds)
    torch.cuda.synchronize()
    assert k4.path(view, valid) == "scalar"
    assert torch.equal(got, k4.minhash_signatures_plain(view, valid, seeds))


def test_staged_schedules_match_the_python_side(cuda):
    # K3's paths and K4's map and paths as the CPU emulations walk them
    # (tests/test_torch_staged_schedule.py).
    from test_torch_staged_schedule import k3_path, k4_path
    from test_torch_ingest_schedule import lane_map

    for M in list(range(1, 300)) + [1000, 2050, 5000]:
        for L in (1, 3, 4, 5, 129, 256, 1024, 2048, 2049, 2500, 4100):
            assert k4.schedule(M, L) == lane_map(M, L), (M, L)
    tok = torch.zeros(4 * 64 + 4, dtype=torch.int32, device=cuda)
    flags = torch.zeros(4 * 64 + 4, dtype=torch.bool, device=cuda)
    for L in (1, 4, 6, 64):
        for a, b, c in ((0, 0, 0), (1, 0, 0), (0, 2, 0), (0, 0, 1), (0, 0, 4)):
            t, h, v = tok[a:a + L], tok[b:b + L], flags[c:c + L]
            t, h, v = t.view(1, L), h.view(1, L), v.view(1, L)
            assert k3.schedule(t, h, v) == k3_path(
                L, t.data_ptr(), h.data_ptr(), v.data_ptr()), (L, a, b, c)
            assert k4.path(t, v) == k4_path(L, t.data_ptr(), v.data_ptr())
    assert k3.schedule(tok[:64].view(4, 16), tok[4:68].view(4, 16),
                       flags[4:68].view(4, 16)) == "vector"
    assert k3.schedule(tok[:64].view(4, 16), tok[1:65].view(4, 16),
                       flags[:64].view(4, 16)) == "scalar"
    assert k4.path(tok[:64].view(4, 16), flags[:64].view(4, 16)) == "vector"


@pytest.mark.parametrize("D,M,r", [(1000, 100, 2), (77, 24, 8), (5, 7, 1),
                                   (300, 15, 3)])
def test_band_values_kernel_matches_plain(cuda, D, M, r):
    _, _, sig = _packed(1, 1, D * M, seed=M + r, device=cuda)
    sig = sig.reshape(D, M)
    k5.launches = 0
    got = k5.band_values(sig, r)
    torch.cuda.synchronize()
    assert k5.launches == 1
    assert torch.equal(got, k5.band_values_plain(sig, r))


def _text_bytes(D, LB, seed):
    """Text-like rows: alnum runs of both cases, spaces, punctuation,
    bytes >= 0x80, garbage past each length, some rows of one run."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
        b"     .,;:-/()", dtype=np.uint8)
    data = alphabet[rng.randint(0, len(alphabet), size=(D, LB))]
    high = rng.rand(D, LB) < 0.01
    data[high] = rng.randint(0x80, 0x100, size=int(high.sum()))
    lengths = rng.randint(0, LB, size=D).astype(np.int32)
    lengths[:4] = [0, 1, LB - 1, LB - 1]
    data[3, : LB - 1] = ord("Z")  # one run to the end of the row
    return data, lengths


@pytest.mark.parametrize("D,LB", [(257, 300), (40, 2049), (6, 5), (301, 2),
                                  (99, 17), (2049, 16), (7, 2049)])
def test_byte_token_kernel_matches_plain(cuda, D, LB):
    data, lengths = _text_bytes(D, LB, seed=LB)
    data, lengths = (torch.from_numpy(x).to(cuda) for x in (data, lengths))
    k6.launches = 0
    got = k6.byte_token_hashes(data, lengths)
    torch.cuda.synchronize()
    assert k6.launches == 1
    assert k6.schedule(data, *got) == "vector"
    for g, w in zip(got, k6.byte_token_hashes_plain(data, lengths)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("D,LB", [(40, 2049), (33, 5)])
def test_byte_token_kernel_scalar_path_on_a_misaligned_view(cuda, D, LB):
    """A view one byte into its storage is contiguous but not 16-byte
    aligned: the kernel takes the scalar path, says so, and agrees."""
    data, lengths = _text_bytes(D, LB, seed=LB + 1)
    store = torch.zeros(D * LB + 1, dtype=torch.uint8, device=cuda)
    view = store[1:].view(D, LB)
    view.copy_(torch.from_numpy(data).to(cuda))
    lengths = torch.from_numpy(lengths).to(cuda)
    assert view.is_contiguous() and view.data_ptr() % 16 == 1
    got = k6.byte_token_hashes(view, lengths)
    torch.cuda.synchronize()
    assert k6.schedule(view, *got) == "scalar"
    for g, w in zip(got, k6.byte_token_hashes_plain(view, lengths)):
        assert torch.equal(g, w)


def test_bytes_to_bands_kernels_match_plain_chain(cuda):
    data, lengths = _text_bytes(500, 1024, seed=5)
    data, lengths = (torch.from_numpy(x).to(cuda) for x in (data, lengths))
    _, _, seeds = _packed(1, 1, 100, seed=6, device=cuda)
    k1.launches = k6.launches = 0
    sig, bands, counts = k6.bytes_to_bands(data, lengths, seeds)
    torch.cuda.synchronize()
    assert k1.launches == 1 and k6.launches == 1
    tok, ends = k6.byte_token_hashes_plain(
        torch.nn.functional.pad(data, (0, 1)), lengths)
    tokens, pcounts = k6.compact_tokens(tok, ends, 1025 // 2 + 1)
    psig, pbands, _ = k1.fused_ingest_plain(tokens, pcounts, seeds)
    assert torch.equal(counts, pcounts)
    assert torch.equal(sig, psig) and torch.equal(bands, pbands)


@pytest.mark.parametrize("fields,kernels", [
    (dict(byte_ingest=True), (k6, k1, k2)),
    (dict(fused_ingest=False), (k3, k4, k2)),
])
def test_byte_and_staged_runs_match_plain_path(cuda, fields, kernels):
    notes, _ = inject_near_duplicates(make_i2b2_like(200, seed=0), 100,
                                      seed=1)
    cfg = dict(fields, use_kernels=True, exact_verification=False,
               verify_batch="band")
    for k in kernels:
        k.launches = 0
    kern = DedupPipeline(DedupConfig(**cfg), device=cuda).run(notes)
    assert all(k.launches > 0 for k in kernels)
    # On the CPU every wrapper runs its plain version.
    plain = DedupPipeline(DedupConfig(**cfg | dict(verify_backend="numpy")),
                          device="cpu").run(notes)
    assert np.array_equal(kern.signatures, plain.signatures)
    assert np.array_equal(kern.bands, plain.bands)
    assert np.array_equal(kern.labels, plain.labels)
    assert kern.pairs == plain.pairs


def _masked_inputs(D, M, P, seed, device):
    """K7 inputs: small word values (counts spread over 0..M), indices
    in and out of [0, D) (-1 is INVALID as int32) on valid and invalid
    lanes alike, half the lanes valid, 1/8 with a == b."""
    rng = np.random.RandomState(seed)
    sig = rng.randint(0, 3, size=(D, M)).astype(np.uint32)
    a = rng.randint(-2, D + 2, size=P).astype(np.int32)
    b = rng.randint(-2, D + 2, size=P).astype(np.int32)
    edge = np.array([-1, D, D - 1, 0, -2**31, 2**31 - 1], dtype=np.int32)
    a[: min(P, 6)] = edge[: min(P, 6)]
    b[-min(P, 6):] = edge[: min(P, 6)]
    b[: P // 8] = a[: P // 8]
    valid = rng.rand(P) < 0.5
    valid[: min(P, 3)] = True
    return (u32_from_numpy(sig, device),
            *(torch.from_numpy(x).to(device) for x in (a, b, valid)))


@pytest.mark.parametrize("D,P", [(300, 1000), (5, 257), (1, 40)])
def test_masked_indexed_pair_counts_kernel_matches_plain(cuda, D, P):
    for M in range(1, 261):
        sig, a, b, valid = _masked_inputs(D, M, P, seed=M, device=cuda)
        k2.masked_launches = 0
        got = k2.masked_indexed_pair_counts(sig, a, b, valid)
        torch.cuda.synchronize()
        assert k2.masked_launches == 1
        want = k2.masked_indexed_pair_counts_plain(sig, a, b, valid)
        assert torch.equal(got, want), M
        assert bool((got[~valid] == 0).all())


@pytest.mark.parametrize("P", [1000, 257, 1])
def test_masked_pair_counts_kernel_matches_plain(cuda, P):
    for M in range(1, 261):
        sig, a, b, valid = _masked_inputs(300, M, P, seed=M + 1, device=cuda)
        rows_a, rows_b = sig[a.long().clamp(0, 299)], sig[b.long().clamp(0, 299)]
        k2.masked_launches = 0
        got = k2.masked_pair_counts(rows_a, rows_b, valid)
        torch.cuda.synchronize()
        assert k2.masked_launches == 1
        assert torch.equal(got, k2.masked_pair_counts_plain(rows_a, rows_b,
                                                             valid)), M


def test_masked_pair_counts_empty_and_all_invalid(cuda):
    sig, a, b, valid = _masked_inputs(50, 100, 300, seed=9, device=cuda)
    k2.masked_launches = 0
    assert k2.masked_indexed_pair_counts(sig, a[:0], b[:0],
                                         valid[:0]).shape == (0,)
    assert k2.masked_pair_counts(sig[:0], sig[:0], valid[:0]).shape == (0,)
    assert k2.masked_launches == 0  # nothing to launch for P = 0
    none = torch.zeros_like(valid)
    got = k2.masked_indexed_pair_counts(sig, a, b, none)
    got_rows = k2.masked_pair_counts(sig, sig.flip(0), none[:50])
    torch.cuda.synchronize()
    assert k2.masked_launches == 2
    assert not bool(got.any()) and not bool(got_rows.any())
    est = k2.masked_indexed_pair_estimate(sig, a, b, valid).cpu().numpy()
    counts = k2.masked_indexed_pair_counts_plain(sig, a, b, valid)
    assert np.array_equal(est, counts.cpu().numpy().astype(np.float32)
                          / np.float32(100))


@pytest.mark.parametrize("stage2", ["host", "device"])
def test_sharded_step_on_card_matches_cpu(cuda, stage2):
    notes, _ = inject_near_duplicates(make_i2b2_like(200, seed=0), 100,
                                      seed=1)
    packed = shingle.pack_documents([shingle.tokenize(t) for t in notes])
    args = (packed.tokens, packed.lengths, minhash.default_seeds(100))
    cfg = DistLSHConfig(fused_ingest=True, band_groups=5, stage2=stage2,
                        edge_capacity=4096, bucket_slack=16.0)
    k1.launches = k2.masked_launches = 0
    card = make_streamed_dedup_step(cfg, docs_mesh(cuda))(*args)
    torch.cuda.synchronize()
    assert k1.launches == 1
    assert k2.masked_launches == (cfg.band_groups if stage2 == "device" else 0)
    plain = make_streamed_dedup_step(cfg, docs_mesh("cpu"))(*args)
    assert torch.equal(card["sig"].cpu(), plain["sig"])
    for cg, pg in zip(card["groups"], plain["groups"], strict=True):
        assert set(cg) == set(pg)
        for key, val in cg.items():
            if key != "band_start":
                assert val.device.type == "cuda"
                assert torch.equal(val.cpu(), pg[key]), key
    got = cluster_step_output(card, cfg, backend="kernel",
                              num_docs=len(notes))
    want = cluster_step_output(plain, cfg, num_docs=len(notes))
    assert np.array_equal(got.labels(), want.labels())
    assert got.pairs == want.pairs and got.num_edges > 0
    assert (got.device_scored, got.host_rescored) == \
        (want.device_scored, want.host_rescored)


def _nccl_worker(rank: int, world: int, init_file: str) -> None:
    """One rank of the NCCL step, held against the same step on the CPU
    over a gloo group of the same processes."""
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        gloo = dist.new_group(backend="gloo")
        notes, _ = inject_near_duplicates(make_i2b2_like(300, seed=0), 100,
                                          seed=1)
        # Shuffled, so duplicates land on different ranks.
        order = np.random.RandomState(2).permutation(len(notes))
        packed = shingle.pack_documents(
            [shingle.tokenize(notes[i]) for i in order])
        args = (packed.tokens, packed.lengths, minhash.default_seeds(100))
        for stage2, rc in (("host", 1024), ("device", 1024), ("device", 1)):
            cfg = DistLSHConfig(fused_ingest=True, band_groups=5,
                                stage2=stage2, sig_row_capacity=rc,
                                edge_capacity=4096, bucket_slack=16.0)
            k2.masked_launches = 0
            card = make_streamed_dedup_step(cfg, docs_mesh("cuda"))(*args)
            torch.cuda.synchronize()
            if stage2 == "device":  # both forms, in every band group
                assert k2.masked_launches == 2 * cfg.band_groups
            plain = make_streamed_dedup_step(
                cfg, docs_mesh("cpu", group=gloo))(*args)
            assert torch.equal(card["sig"].cpu(), plain["sig"])
            for cg, pg in zip(card["groups"], plain["groups"], strict=True):
                for key, val in cg.items():
                    if key != "band_start":
                        assert torch.equal(val.cpu(), pg[key]), key
            if rank == 0:
                got = cluster_step_output(card, cfg, backend="kernel",
                                          num_docs=len(notes))
                want = cluster_step_output(plain, cfg, num_docs=len(notes))
                assert np.array_equal(got.labels(), want.labels())
                assert got.pairs == want.pairs and got.num_edges > 0
                assert (got.device_scored, got.host_rescored,
                        got.row_overflow) == (want.device_scored,
                                              want.host_rescored,
                                              want.row_overflow)
                if stage2 == "device":
                    assert got.device_scored > 0
                    assert (got.row_overflow > 0) == (rc == 1)
    finally:
        dist.destroy_process_group()


def test_sharded_step_over_nccl_matches_gloo(cuda, tmp_path):
    """Several ranks, one card each: all_to_all, all_gather and
    all_reduce over NCCL, and both K7 forms, against the same program
    on the CPU over gloo."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    world = 4 if cards >= 4 else 2
    mp.start_processes(_nccl_worker, args=(world, str(tmp_path / "pg")),
                       nprocs=world, join=True, start_method="spawn")


def test_sharded_session_on_card_matches_cpu(cuda):
    """A one-shard sharded session with device stage 2 over 3 chunks (K1
    once a chunk, K7 once a band group a chunk, K2 on the cross-step
    edges) equals the same session on the CPU, snapshot for snapshot."""
    notes, _ = inject_near_duplicates(make_i2b2_like(200, seed=0), 100,
                                      seed=1)
    # Shuffled, so chunks hold duplicates of their own (device-scored)
    # and of earlier chunks (cross-step).
    order = np.random.RandomState(2).permutation(len(notes))
    chunks = [[notes[i] for i in idx] for idx in np.array_split(order, 3)]
    cfg = DedupConfig(fused_ingest=True, exact_verification=False,
                      verify_backend="kernel")
    dcfg = DistLSHConfig(fused_ingest=True, band_groups=5, stage2="device",
                         edge_capacity=4096, bucket_slack=16.0)
    out = {}
    for device in ("cpu", "cuda"):
        k1.launches = k2.launches = k2.masked_launches = 0
        sess = DedupSession(cfg, backend="sharded", dist_config=dcfg,
                            device=device)
        out[device] = [(s.labels.tolist(), s.pairs, s.overflow, s.retried,
                        s.device_scored, s.host_rescored, s.row_overflow)
                       for s in sess.ingest_stream(chunks)]
        launched = (k1.launches, k2.masked_launches, k2.launches)
    assert out["cuda"] == out["cpu"]
    assert launched[0] == len(chunks)
    assert launched[1] == len(chunks) * dcfg.band_groups
    assert launched[2] > 0 and out["cuda"][-1][4] > 0


@pytest.mark.parametrize("store", ["memory", "sqlite"])
def test_sharded_retention_session_on_card_matches_cpu(cuda, store,
                                                       tmp_path):
    """A one-shard sharded session with device stage 2 under an LRU window
    of 16 refining every 2 steps, its cross-step index in memory or in
    sqlite, over 4 chunks: equal to the same session on the CPU snapshot
    for snapshot, rows evicted (also by the sweeps between band groups,
    whose freed rows the next chunk fills on the card), no host
    re-score, and refine's fold through K5."""
    from repro_torch.core import RetentionPolicy

    notes, _ = inject_near_duplicates(make_i2b2_like(200, seed=0), 100,
                                      seed=1)
    order = np.random.RandomState(2).permutation(len(notes))
    chunks = [[notes[i] for i in idx] for idx in np.array_split(order, 4)]
    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel",
                      store=store)
    dcfg = DistLSHConfig(fused_ingest=True, band_groups=5, stage2="device",
                         edge_capacity=4096, bucket_slack=16.0)
    out = {}
    for device in ("cpu", "cuda"):
        k5.launches = k2.masked_launches = 0
        sess = DedupSession(cfg, backend="sharded", dist_config=dcfg,
                            retention=RetentionPolicy(lru_window=16,
                                                      refine_every=2),
                            store_path=str(tmp_path / f"{device}.db"),
                            device=device)
        sweep, in_step = sess.retention.sweep, []

        def counted(s, protect_from=None):
            n = sweep(s, protect_from=protect_from)
            if protect_from is not None:
                in_step.append(n)
            return n

        sess.retention.sweep = counted
        out[device] = [(s.labels.tolist(), s.pairs, s.overflow, s.retried,
                        s.device_scored, s.host_rescored, s.row_overflow,
                        s.evicted, s.retained_rows, s.refine_merges,
                        s.filter_only_hits, s.representatives.tolist())
                       for s in sess.ingest_stream(chunks)]
        launched = (k5.launches, k2.masked_launches)
    assert out["cuda"] == out["cpu"]
    last = out["cuda"][-1]
    assert last[7] > 0 and last[5] == 0 and last[4] > 0
    assert sum(in_step) > 0
    assert launched[0] == 2                 # K5 once a refine
    assert launched[1] == len(chunks) * dcfg.band_groups
    assert sess.refines_run == 2


# -- K8: flash attention ---------------------------------------------------------

def _attn_inputs(B, Sq, Skv, H, Hkv, Dh, dtype, device, seed=0, Dv=None):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((B, Sq, H, Dh), (B, Skv, Hkv, Dh),
                               (B, Skv, Hkv, Dv or Dh)))


def _assert_k8_matches_plain(q, k, v, causal, window, scale=None):
    k8.launches = 0
    got = k8.flash_attention(q, k, v, causal=causal, window=window,
                             scale=scale)
    torch.cuda.synchronize()
    assert k8.launches == 1 and got.dtype == q.dtype
    want = k8.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    scale=scale)
    assert got.shape == want.shape == q.shape[:3] + v.shape[3:]
    if q.dtype == torch.float32:  # IEEE FMAs in both, sums in another order
        torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)
        return
    # bf16: both round p to bf16 (relative 2**-9) against the running max
    # of their own tile order, so their sums differ by at most 2**-8 of
    # sum_j p_j |v_j| / l (the plain version on |v|); both round the
    # output, at most one unit in the last place (<= 2**-7 |want|) apart.
    want = want.float()
    vbar = k8.flash_attention_plain(q, k, v.abs(), causal=causal,
                                    window=window, scale=scale).float()
    bound = 2**-7 * want.abs() + 2**-8 * vbar + 1e-5
    assert bool(((got.float() - want).abs() <= bound).all())


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,window,causal", [
    (2, 64, 64, 8, 2, 16, None, True),
    (1, 100, 100, 4, 4, 8, None, True),
    (2, 96, 96, 8, 2, 16, 24, True),
    (1, 37, 37, 6, 2, 16, None, True),
    (2, 10, 30, 4, 2, 16, 7, True),
    (2, 10, 30, 4, 2, 16, 7, False),
    (1, 300, 300, 32, 8, 80, 64, True),     # h2o-danube's heads
    (1, 130, 130, 16, 16, 256, None, True),  # gemma's head width
    (1, 70, 70, 4, 2, 16, 0, True),          # every key masked: zeros
    (1, 200, 200, 16, 16, 128, None, True),  # olmo's head width
    (4, 512, 512, 32, 8, 80, None, True),    # a serving batch
    (1, 333, 333, 32, 8, 80, 100, True),     # window not a key tile, ragged
    (2, 50, 50, 6, 2, 36, 20, True),         # Dh % 8 != 0: element copies
    # The float32 kernel's edges: g = 32 (one KV head, four positions a
    # row tile), many row and key tiles with a window off the key grid,
    # one KV head with more keys than queries and no causal mask, and a
    # multi-tile case in every tier (8, 36, 80, 128, 256).
    (1, 200, 200, 32, 1, 80, None, True),
    (1, 1000, 1000, 32, 8, 80, 300, True),
    (2, 70, 300, 8, 1, 64, None, False),
    (1, 257, 257, 4, 2, 8, 40, True),
    (1, 190, 190, 6, 3, 36, None, True),
    (1, 330, 330, 8, 4, 128, 100, True),
    (1, 200, 200, 8, 2, 256, 70, True),
    (1, 90, 90, 4, 2, 37, 30, True),         # Dh % 4 != 0: 4-byte copies
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, H, Hkv, Dh,
                                              window, causal, dtype):
    q, k, v = _attn_inputs(B, Sq, Skv, H, Hkv, Dh, dtype, cuda)
    _assert_k8_matches_plain(q, k, v, causal, window)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,Dv,window,causal", [
    (1, 150, 150, 8, 2, 64, 80, 40, True),    # Dv > Dh: V staged wider
    (2, 70, 90, 6, 2, 64, 36, None, False),   # Dv % 8 != 0: element copies
    (1, 130, 130, 4, 4, 128, 64, None, True),  # Dv < Dh
    (1, 120, 160, 8, 4, 64, 70, 50, True),    # Dv % 4 != 0, Skv > Sq
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_with_value_width(
        cuda, B, Sq, Skv, H, Hkv, Dh, Dv, window, causal, dtype):
    q, k, v = _attn_inputs(B, Sq, Skv, H, Hkv, Dh, dtype, cuda, Dv=Dv)
    _assert_k8_matches_plain(q, k, v, causal, window)


@pytest.mark.parametrize("scale", [-0.3, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_any_sign_of_scale(cuda, scale, dtype):
    """A negative or zero scale: both kernels scale the scores before the
    mask and the row max, as the plain version does."""
    q, k, v = _attn_inputs(1, 200, 200, 8, 2, 80, dtype, cuda)
    _assert_k8_matches_plain(q, k, v, True, 70, scale)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _attn_inputs(1, 8, 8, 4, 2, 16, torch.float32, cuda)
    k8.launches = 0
    with pytest.raises(ValueError):
        k8.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        k8.flash_attention(q.half(), k.half(), v.half())
    assert k8.launches == 0


@pytest.mark.parametrize("byte_ingest", [False, True])
def test_kernel_session_and_query_service_on_card_match_cpu(cuda,
                                                            byte_ingest):
    """A 3-chunk ``kernel`` session (K1 or K6 -> K1, and K2) and a
    ``kernel`` query service on the card equal the same run on the CPU."""
    notes, _ = inject_near_duplicates(make_i2b2_like(60, seed=3), 40, seed=4)
    queries = notes[::3] + make_i2b2_like(8, seed=9)
    cfg = DedupConfig(fused_ingest=True, byte_ingest=byte_ingest,
                      exact_verification=False, verify_backend="kernel",
                      verify_batch="band")
    out = {}
    for device in ("cpu", "cuda"):
        k1.launches = k2.launches = k6.launches = 0
        sess = DedupSession(cfg, device=device)
        for chunk in np.array_split(np.arange(len(notes)), 3):
            snap = sess.ingest([notes[i] for i in chunk])
        svc = DedupQueryService(sess, backend="kernel")
        results = svc.query(queries)
        out[device] = (snap.labels.tolist(), snap.pairs,
                       sess.signatures.tolist(), results)
        launched = (k1.launches, k2.launches, k6.launches)
    assert out["cuda"] == out["cpu"]
    assert launched[0] == 4 and launched[1] > 0  # 3 chunks + 1 query batch
    assert launched[2] == (4 if byte_ingest else 0)
    assert all(r.best_sim == 1.0 for r in out["cuda"][3][:len(notes[::3])])


def test_freed_slots_land_in_every_copy_on_card(cuda):
    """After ``release_rows``, ``extend_signatures`` fills the freed rows
    of the host copy and, by one indexed copy a chunk, of the device
    copy; K2 on slot-mapped pairs equals the numpy backend; an evicted
    doc raises ``KeyError``."""
    rng = np.random.RandomState(21)
    sig = rng.randint(0, 4, size=(300, 100)).astype(np.uint32)
    kern = SignatureVerifier(sig[:200].copy(), backend="kernel", device=cuda)
    host = SignatureVerifier(sig[:200].copy(), backend="numpy", device=cuda)
    kern(np.array([[0, 1]]))                  # the device copy exists
    kern.signatures                           # and the host copy
    for v in (kern, host):
        v.release_rows(range(10, 120, 3))
    kern.extend_signatures(u32_from_numpy(sig[200:240], cuda))
    kern.extend_signatures(sig[240:])
    host.extend_signatures(sig[200:])
    assert kern.n_live_rows == host.n_live_rows == 300 - 37
    dev = kern._device_signatures().cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(dev, kern.signatures)
    np.testing.assert_array_equal(kern.signatures, host.signatures)
    live = np.array(sorted(kern.frozen_rows()[1]))
    pairs = np.stack([rng.choice(live, 20000), rng.choice(live, 20000)], 1)
    k2.launches = 0
    got = kern(pairs)
    assert k2.launches == 3                   # 8,192-pair flushes
    np.testing.assert_array_equal(got.view(np.uint32),
                                  host(pairs).view(np.uint32))
    with pytest.raises(KeyError, match="doc 13 has no retained"):
        kern(np.array([[0, 13]]))


def test_retention_session_with_refine_on_card_matches_cpu(cuda):
    """A 256-note session under a small window, a key budget and a refine
    every 2 steps: on the card (K1, K2, K5 in each refine) it equals the
    same session on the CPU field by field, and refine's K5 fold equals
    ``core.lsh.band_values`` on the same device rows."""
    from repro_torch.core import RetentionPolicy, lsh

    notes, _ = inject_near_duplicates(make_i2b2_like(160, seed=5), 96,
                                      frac_low=0.0, frac_high=0.005, seed=6)
    policy = RetentionPolicy(lru_window=16, band_key_budget=96,
                             bloom_bits=1 << 12, refine_every=2)
    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel")
    out = {}
    for device in ("cpu", "cuda"):
        k1.launches = k2.launches = k5.launches = 0
        sess = DedupSession(cfg, retention=policy, device=device)
        for chunk in np.array_split(np.arange(len(notes)), 4):
            snap = sess.ingest([notes[i] for i in chunk])
        out[device] = (snap.labels.tolist(), snap.pairs, snap.evicted,
                       snap.retained_rows, snap.representatives.tolist(),
                       snap.filter_only_hits, snap.refine_merges,
                       sess.band_index.stats())
        launched = (k1.launches, k2.launches, k5.launches)
    assert out["cuda"] == out["cpu"]
    assert snap.evicted > 0 and sess.band_index.compacted_keys > 0
    assert sess.refines_run == 2
    assert launched[0] == 4 and launched[1] > 0 and launched[2] == 2
    v = sess.verifier
    slots = v._slot_index(np.array(snap.representatives))
    rows = v._device_signatures()[torch.from_numpy(slots).to(cuda)]
    assert torch.equal(k5.band_values(rows, cfg.rows_per_band),
                       lsh.band_values(rows, cfg.rows_per_band))


def test_streaming_session_on_card_matches_cpu(cuda, tmp_path):
    """A 256-note streaming session (K1 once a flush, K2) over a store
    file equals the same session on the CPU in labels, pairs and the
    store's entry count, with and without an eviction window."""
    from repro_torch.core import RetentionPolicy

    notes, _ = inject_near_duplicates(make_i2b2_like(160, seed=5), 96,
                                      frac_low=0.0, frac_high=0.005, seed=6)
    cfg = DedupConfig(fused_ingest=True, use_kernels=True,
                      exact_verification=False, verify_backend="kernel")
    for run, policy in enumerate((None, RetentionPolicy(lru_window=16))):
        out = {}
        for device in ("cpu", "cuda"):
            k1.launches = k2.launches = 0
            sess = DedupSession(cfg, backend="streaming", chunk_docs=32,
                                retention=policy, device=device,
                                store_path=str(tmp_path / f"{device}{run}.db"))
            for chunk in np.array_split(np.arange(len(notes)), 4):
                snap = sess.ingest([notes[i] for i in chunk])
            out[device] = (snap.labels.tolist(), snap.pairs, snap.evicted,
                           sess._impl.sd.store.n_entries())
            launched = (k1.launches, k2.launches)
        assert out["cuda"] == out["cpu"]
        assert launched[0] == len(notes) // 32 and launched[1] > 0
        assert (out["cuda"][2] > 0) == (policy is not None)


def test_streaming_phase1_keeps_signatures_on_card(cuda):
    """An owned streaming session hands each flush's K1 rows to the
    verifier on the card: the phase-1 host cache stays empty, the
    verifier has no host copy, and its device rows equal K1's output."""
    notes, _ = inject_near_duplicates(make_i2b2_like(60, seed=3), 40, seed=4)
    cfg = DedupConfig(fused_ingest=True, exact_verification=False,
                      verify_backend="kernel")
    sess = DedupSession(cfg, backend="streaming", chunk_docs=16,
                        device=cuda)
    for chunk in np.array_split(np.arange(len(notes)), 3):
        sess.ingest([notes[i] for i in chunk])
    v = sess.verifier
    assert len(sess._impl.sd._sig_cache) == 0
    assert v._host is None and v._dev.device.type == "cuda"
    pipe = DedupPipeline(cfg, device=cuda)
    toks = pipe.tokenize(notes)
    pad = shingle.pow2_bucket(max(len(t) for t in toks))
    want, _ = pipe._device_arrays(toks, pad)
    assert torch.equal(v._device_signatures(), want)


def test_disk_signature_verifier_launches_k2_prime_and_matches_cpu(cuda):
    """The sqlite tier's verifier gathers rows off disk through its
    cache and scores them with K2' on the card: launches counted, sims
    equal to its CPU twin and to numpy's mean, cache counters alike."""
    from repro_torch.core.bandstore import (
        DiskSignatureVerifier,
        SqliteBandStore,
    )

    rng = np.random.RandomState(15)
    sig = rng.randint(0, 4, size=(300, 100)).astype(np.uint32)
    pairs = rng.randint(0, 300, size=(20000, 2)).astype(np.int64)
    store = SqliteBandStore(num_bands=1)
    store.put_signatures(np.arange(300), sig)
    out = {}
    for device in ("cpu", "cuda"):
        v = DiskSignatureVerifier(store, 100, cache_rows=128, device=device)
        k2.masked_launches = 0
        out[device] = (v(pairs), v.cache_hits, v.cache_misses)
        torch.cuda.synchronize()
        launched = k2.masked_launches
    assert launched == -(-len(pairs) // v.batch_pairs)
    assert np.array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1:] == out["cpu"][1:]
    want = (sig[pairs[:, 0]] == sig[pairs[:, 1]]).mean(axis=-1,
                                                     dtype=np.float32)
    assert np.array_equal(out["cuda"][0], want)


def test_sqlite_streaming_session_on_card_matches_cpu(cuda, tmp_path):
    """A small streaming session over a sqlite store file (K1 once a
    flush, K2' for the verify, no K2) equals the same session on the
    CPU, with and without an eviction window; rows and entries alike."""
    from repro_torch.core import RetentionPolicy

    notes, _ = inject_near_duplicates(make_i2b2_like(160, seed=5), 96,
                                      frac_low=0.0, frac_high=0.005, seed=6)
    cfg = DedupConfig(fused_ingest=True, exact_verification=False,
                      store="sqlite")
    for run, policy in enumerate((None, RetentionPolicy(lru_window=16))):
        out = {}
        for device in ("cpu", "cuda"):
            k1.launches = k2.launches = k2.masked_launches = 0
            sess = DedupSession(cfg, backend="streaming", chunk_docs=32,
                                retention=policy, device=device,
                                store_path=str(tmp_path / f"{device}{run}.db"))
            for chunk in np.array_split(np.arange(len(notes)), 4):
                snap = sess.ingest([notes[i] for i in chunk])
            store = sess._impl.sd.store
            out[device] = (snap.labels.tolist(), snap.pairs, snap.evicted,
                           snap.retained_rows, store.n_entries(),
                           store.n_signatures())
            launched = (k1.launches, k2.launches, k2.masked_launches)
        assert out["cuda"] == out["cpu"]
        assert launched[0] == len(notes) // 32
        assert launched[1] == 0 and launched[2] > 0
        assert (out["cuda"][2] > 0) == (policy is not None)


def test_serve_batch_with_flash_on_card_matches_cpu(cuda):
    cfg = get_reduced("h2o-danube-1.8b").with_(use_flash_attention=True)
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = np.random.RandomState(0).randint(
        2, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    want, _ = serve_batch(cfg, model, prompts, 6)
    k8.launches = 0
    got, _ = serve_batch(cfg, model.to(cuda), prompts, 6)
    assert k8.launches == cfg.n_layers  # one launch per layer per prefill
    assert np.array_equal(got, want)
    eng = ServeEngine(cfg, model, slots=2, cache_len=24, eos_id=-1)
    for n in (5, 11, 3):
        eng.submit(prompts[0, :n], max_tokens=4)
    assert len(eng.run_until_drained()) == 3
    assert k8.launches == cfg.n_layers * (1 + eng.stats.prefills)


def test_pair_estimate_kernel_matches_plain(cuda):
    rng = np.random.RandomState(14)
    P, M = 5000, 100
    a = u32_from_numpy(rng.randint(0, 3, size=(P, M)).astype(np.uint32), cuda)
    b = u32_from_numpy(rng.randint(0, 3, size=(P, M)).astype(np.uint32), cuda)
    k2.masked_launches = 0
    got = k2.pair_estimate(a, b)
    torch.cuda.synchronize()
    assert k2.masked_launches == 1
    want = estimate_from_counts(
        (a == b).sum(dim=1, dtype=torch.int32), M)
    assert torch.equal(got, want)


def _offset(x: torch.Tensor) -> torch.Tensor:
    """The same values in a flat buffer viewed from its second word: a
    contiguous tensor whose base is 4 bytes past 16-byte alignment."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def _k2_case(cuda, P, misaligned):
    rng = np.random.RandomState(P)
    D = 300
    for M in range(1, 261):
        sig = u32_from_numpy(rng.randint(0, 3, size=(D, M)).astype(np.uint32),
                             cuda)
        if misaligned:
            sig = _offset(sig)
        a = torch.from_numpy(rng.randint(0, D, size=P)).to(cuda)
        b = torch.from_numpy(rng.randint(0, D, size=P)).to(cuda)
        a[0], b[-1] = 0, D - 1  # the first and last rows
        b[: P // 8] = a[: P // 8]
        vector = M % 4 == 0 and not misaligned
        G, path = k2.schedule(M, sig, sig)
        assert G in (1, 2, 4, 8, 16, 32), M
        assert path == ("vector" if vector else "scalar"), M
        k2.launches = 0
        got = k2.pair_counts(sig, a, b)
        torch.cuda.synchronize()
        assert k2.launches == 1
        assert torch.equal(got, k2.pair_counts_plain(sig, a, b)), (M, P)


def _k7_case(cuda, mask, misaligned):
    D, P = 300, 4099
    for M in range(1, 261):
        sig, a, b, valid = _masked_inputs(D, M, P, seed=M, device=cuda)
        lanes = torch.arange(P, device=cuda)
        valid = {"all": torch.ones_like(valid), "none": torch.zeros_like(valid),
                 "1-in-64": lanes % 64 == 5, "every-other": lanes % 2 == 1,
                 "mixed": valid}[mask]
        rows_a = sig[a.long().clamp(0, D - 1)]
        rows_b = sig[b.long().clamp(0, D - 1)]
        if misaligned:
            sig, rows_a = _offset(sig), _offset(rows_a)
        vector = M % 4 == 0 and not misaligned
        G, path = k2.schedule(M, sig, sig)
        assert G in (1, 2, 4, 8, 16, 32)
        assert path == ("vector" if vector else "scalar")
        assert k2.schedule(M, rows_a, rows_b) == (G, path)
        k2.masked_launches = 0
        got = k2.masked_indexed_pair_counts(sig, a, b, valid)
        got_rows = k2.masked_pair_counts(rows_a, rows_b, valid)
        torch.cuda.synchronize()
        assert k2.masked_launches == 2
        want = k2.masked_indexed_pair_counts_plain(sig, a, b, valid)
        assert torch.equal(got, want), (M, mask)
        assert torch.equal(got_rows, want), (M, mask)


def _verifier_case(cuda):
    rng = np.random.RandomState(15)
    D, M = 2000, 100
    sig = rng.randint(0, 3, size=(D, M)).astype(np.uint32)
    kern = SignatureVerifier(sig, backend="kernel", device=cuda)
    ref = SignatureVerifier(sig, backend="numpy", device=cuda)
    k2.launches = 0
    for P in (1, 8192, 8193, 3):  # 8,193 is two batches: 8,192 and 1
        pairs = rng.randint(0, D, size=(P, 2))
        pairs[0] = [0, D - 1]
        got = kern(pairs)
        assert got.dtype == np.float32 and got.shape == (P,)
        assert np.array_equal(got.view(np.uint32),
                              ref(pairs).view(np.uint32)), P
    assert k2.launches == kern.n_batches == 5


@pytest.mark.parametrize("case", [
    "k2-P1", "k2-P7", "k2-P8193", "k2-P65537", "k2-misaligned",
    "k7-all", "k7-none", "k7-1-in-64", "k7-every-other", "k7-misaligned",
    "verifier-flushes"])
def test_pair_count_kernels_match_plain_on_every_path(cuda, case):
    """K2 and K7 (both forms) against their plain versions for every M in
    1..260, on the 16-byte path and, from a base one word past 16-byte
    alignment, on the scalar path; K7 under four masks; the kernel
    verifier's single-upload batches against the numpy verifier."""
    kind, _, arg = case.partition("-")
    if kind == "k2":
        _k2_case(cuda, 8193 if arg == "misaligned" else int(arg[1:]),
                 arg == "misaligned")
    elif kind == "k7":
        _k7_case(cuda, "mixed" if arg == "misaligned" else arg,
                 arg == "misaligned")
    else:
        _verifier_case(cuda)
