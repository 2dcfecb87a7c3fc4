"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc (the kernels have no CPU
mode) and skips elsewhere.  The file imports neither JAX nor ``repro``,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hashing import u32_from_numpy
from repro_torch.core.minhash import estimate_from_counts
from repro_torch.core.pipeline import DedupConfig, DedupPipeline
from repro_torch.core.verify import SignatureVerifier
from repro_torch.data import inject_near_duplicates, make_i2b2_like
from repro_torch.kernels import fused_ingest as k1
from repro_torch.kernels import sigjaccard as k2

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
    (40, 2500, 100, 8, 2),   # L longer than one shared-memory tile
    (3, 64, 260, 8, 2),      # M larger than the block
])
def test_fused_ingest_kernel_matches_plain(cuda, D, L, M, n, r):
    args = _packed(D, L, M, seed=L, device=cuda)
    k1.launches = 0
    got = k1.fused_ingest(*args, n=n, r=r)
    torch.cuda.synchronize()
    assert k1.launches == 1
    for g, w in zip(got, k1.fused_ingest_plain(*args, n=n, r=r)):
        assert torch.equal(g, w)


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
