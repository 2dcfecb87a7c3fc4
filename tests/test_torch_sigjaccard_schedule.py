"""K2's and K7's lane map, emulated on the CPU and held to the reference.

The CUDA kernels (``csrc/sigjaccard.cu``, ``csrc/sigjaccard_masked.cu``,
body in ``csrc/pair_counts_common.cuh``) cannot run here, so a numpy
emulation walks the same schedule: groups of G = ``lane_group(M)``
lanes a pair, 16-byte chunks ``sub + k G`` per lane loaded before any
compare, the scalar path's tail chunk, the xor-shuffle sum within a
group, K2's 32/G pairs a warp step with indices shuffled from the lane
that loaded them, and K7's 32-lane tiles compacted by ballot, rank and
the k-th set bit, each count shuffled back to its lane.  Its counts are
held bit for bit to ``repro.kernels.sigjaccard``'s Pallas kernels in
interpret mode and to the port's plain versions.  The card tests
(``test_torch_cuda.py``) hold the kernels themselves to the plain
versions.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shingle as ref_shingle
from repro.core.minhash import default_seeds, signatures_np
from repro.core.verify import SignatureVerifier as RefSignatureVerifier
from repro.data import inject_near_duplicates, make_i2b2_like
from repro.kernels import sigjaccard as ref
from repro_torch.core.verify import SignatureVerifier
from repro_torch.kernels import build
from repro_torch.kernels import sigjaccard as k2

LANES = np.arange(32)
FILL_B = 0xFFFFFFFF  # the scalar tail's fill in row b; row a's is 0
WARPS = 16  # a small grid, so that warps stride over the work
MS = [1, 3, 4, 20, 30, 100, 101, 128, 130, 256, 260]  # 260: two batches
# Chunks of 16 bytes a lane loads from each row before comparing
# (``kBatch`` in csrc/pair_counts_common.cuh, pinned to it below).
LANE_CHUNKS = 2


def lane_group(M: int) -> int:
    """Lanes per pair for rows of M words, as ``lane_group`` in
    csrc/pair_counts_common.cuh: the least power of two, at most 32,
    whose lanes cover the row's ceil(M / 4) chunks of 16 bytes in
    ``LANE_CHUNKS`` chunks a lane."""
    chunks = (M + 3) // 4
    need = (chunks + LANE_CHUNKS - 1) // LANE_CHUNKS
    g = 1
    while g < need and g < 32:
        g *= 2
    return g


def _chunk(words, base: int, j: int, M: int, fill: int, vector: bool):
    """Chunk j of the row at word offset ``base`` of ``words``."""
    w = 4 * j
    if vector:  # one 16-byte load: a whole, aligned chunk
        assert w + 3 < M and (base + w) % 4 == 0
    return [int(words[base + w + i]) if w + i < M else fill for i in range(4)]


def _lane_agree(words, oa: int, ob: int, M: int, G: int, sub: int,
                active: bool, vector: bool) -> int:
    chunks = (M + 3) // 4
    c = 0
    for base in range(0, chunks, LANE_CHUNKS * G):
        va, vb = [], []
        for k in range(LANE_CHUNKS):  # every load before any compare
            j = base + sub + k * G
            if active and j < chunks:
                va.append(_chunk(words, oa, j, M, 0, vector))
                vb.append(_chunk(words, ob, j, M, FILL_B, vector))
            else:
                va.append([0] * 4)
                vb.append([FILL_B] * 4)
        c += sum(x == y for ca, cb in zip(va, vb) for x, y in zip(ca, cb))
    return c


def _group_sum(c: np.ndarray, G: int) -> np.ndarray:
    o = G // 2
    while o > 0:
        c = c + c[LANES ^ o]
        o //= 2
    return c


def _warp_agree(words, oa, ob, M, G, active, vector) -> np.ndarray:
    """Every lane's group sum for one round (per-lane row offsets)."""
    c = np.array([_lane_agree(words, int(oa[l]), int(ob[l]), M, G, l % G,
                              bool(active[l]), vector) for l in LANES])
    return _group_sum(c, G)


def _nth_set_bit(mask: int, k: int) -> int:
    pos = 0
    for w in (16, 8, 4, 2, 1):
        low = bin(mask & ((1 << w) - 1)).count("1")
        if k >= low:
            k -= low
            mask >>= w
            pos += w
    return pos


def _words(sig: np.ndarray, misaligned: bool) -> tuple[np.ndarray, int]:
    """The matrix as one flat buffer, from word 1 when misaligned."""
    off = 1 if misaligned else 0
    return np.concatenate([np.zeros(off, np.uint32), sig.ravel()]), off


def emulate_k2(sig: np.ndarray, a: np.ndarray, b: np.ndarray,
               vector: bool) -> np.ndarray:
    D, M = sig.shape
    G = lane_group(M)
    pairs_per_step = 32 // G
    words, off = _words(sig, not vector)
    P = len(a)
    counts = np.zeros(P, np.int64)
    writes = np.zeros(P, np.int64)
    grp, sub = LANES // G, LANES % G
    for warp in range(WARPS):
        for step in range(warp, -(-P // pairs_per_step), WARPS):
            first = step * pairs_per_step
            load = (LANES < pairs_per_step) & (first + LANES < P)
            ia = np.where(load, a[np.minimum(first + LANES, P - 1)], 0)
            ib = np.where(load, b[np.minimum(first + LANES, P - 1)], 0)
            ia, ib = ia[grp], ib[grp]  # shuffled from lane grp
            active = first + grp < P
            c = _warp_agree(words, off + ia * M, off + ib * M, M, G, active,
                            vector)
            lead = active & (sub == 0)
            counts[first + grp[lead]] = c[lead]
            writes[first + grp[lead]] += 1
    assert np.all(writes == 1)
    return counts


def emulate_k7(sig_a: np.ndarray, sig_b: np.ndarray | None, a, b,
               valid: np.ndarray, vector: bool) -> np.ndarray:
    """Indexed form (``sig_b`` None: rows a[p], b[p] of ``sig_a``,
    clipped) or pre-gathered form (rows p of ``sig_a`` and ``sig_b``)."""
    M = sig_a.shape[1]
    if sig_b is None:
        D = sig_a.shape[0]
        words, off = _words(sig_a, not vector)
        row_a = off + np.clip(a.astype(np.int64), 0, D - 1) * M
        row_b = off + np.clip(b.astype(np.int64), 0, D - 1) * M
    else:
        both = np.concatenate([sig_a, sig_b])
        words, off = _words(both, not vector)
        row_a = off + np.arange(len(valid)) * M
        row_b = off + (len(valid) + np.arange(len(valid))) * M
    G = lane_group(M)
    pairs_per_round = 32 // G
    P = len(valid)
    counts = np.full(P, -1, np.int64)
    grp = LANES // G
    for warp in range(WARPS):
        for t in range(warp, -(-P // 32), WARPS):
            p = t * 32 + LANES
            inside = p < P
            q = np.minimum(p, P - 1)
            v = inside & valid[q]
            oa = np.where(v, row_a[q], 0)
            ob = np.where(v, row_b[q], 0)
            mask = int(sum(1 << int(l) for l in LANES[v]))
            n = int(v.sum())
            rank = np.array([bin(mask & ((1 << int(l)) - 1)).count("1")
                             for l in LANES])
            mine = np.zeros(32, np.int64)
            for first in range(0, n, pairs_per_round):
                k = first + grp
                active = k < n
                src = np.array([_nth_set_bit(mask, int(kk) if act else 0)
                                for kk, act in zip(k, active)])
                assert np.all(v[src[active]])
                c = _warp_agree(words, oa[src], ob[src], M, G, active, vector)
                got = c[((rank - first) & (pairs_per_round - 1)) * G]
                sel = v & (rank >= first) & (rank < first + pairs_per_round)
                mine[sel] = got[sel]
            counts[p[inside]] = mine[inside]
    assert np.all(counts >= 0)
    return counts


def _inputs(D: int, M: int, P: int, seed: int):
    rng = np.random.RandomState(seed)
    sig = rng.randint(0, 3, size=(D, M)).astype(np.uint32)
    a = rng.randint(0, D, size=P).astype(np.int64)
    b = rng.randint(0, D, size=P).astype(np.int64)
    a[:2], b[:2] = [0, D - 1], [D - 1, 0]  # the first and last rows
    b[2:6] = a[2:6]  # identical rows: count M
    return sig, a, b


def _paths(M: int) -> list[bool]:
    return [True, False] if M % 4 == 0 else [False]


def test_lane_group_and_constants_match_the_kernel_source():
    text = (build.CSRC / "pair_counts_common.cuh").read_text()
    assert re.search(r"constexpr int kBatch = (\d+);", text).group(1) == \
        str(LANE_CHUNKS)
    assert "pair_counts_common.cuh" in (build.CSRC / "sigjaccard.cu").read_text()
    assert "pair_counts_common.cuh" in \
        (build.CSRC / "sigjaccard_masked.cu").read_text()
    want = {1: 1, 3: 1, 8: 1, 9: 2, 16: 2, 17: 4, 20: 4, 30: 4, 32: 4,
            33: 8, 64: 8, 65: 16, 100: 16, 101: 16, 128: 16, 130: 32,
            256: 32, 260: 32, 1000: 32}
    assert {M: lane_group(M) for M in want} == want
    for M in range(1, 600):
        G, chunks = lane_group(M), (M + 3) // 4
        assert G in (1, 2, 4, 8, 16, 32)
        assert G == 32 or G * LANE_CHUNKS >= chunks  # one batch covers M
        assert G == 1 or (G // 2) * LANE_CHUNKS < chunks  # the least such
    # M = 100: 25 chunks over 16 lanes x 2 chunks = 78 % of the slots.
    assert 25 / (lane_group(100) * LANE_CHUNKS) == 0.78125


def test_nth_set_bit_matches_the_set_bits():
    rng = np.random.RandomState(0)
    masks = [0xFFFFFFFF, 1, 1 << 31, 0x80000001, 0xAAAAAAAA] + \
        [int(x) for x in rng.randint(1, 2**32, size=200, dtype=np.uint64)]
    for mask in masks:
        bits = [i for i in range(32) if mask >> i & 1]
        assert [_nth_set_bit(mask, k) for k in range(len(bits))] == bits


@pytest.mark.parametrize("M", MS)
def test_k2_lane_map_matches_reference(M):
    D = 37
    G = lane_group(M)
    P = (32 // G) * 5 + 1 if G < 32 else 97  # not a multiple of 32 / G
    sig, a, b = _inputs(D, M, P, seed=M)
    est = np.asarray(ref.indexed_pair_estimate(
        jnp.asarray(sig), jnp.asarray(a), jnp.asarray(b)))
    want = np.rint(est * M).astype(np.int64)
    plain = k2.pair_counts_plain(torch.from_numpy(sig.view(np.int32)),
                                 torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(plain.numpy(), want)
    assert np.all(want[2:6] == M)
    for vector in _paths(M):
        assert np.array_equal(emulate_k2(sig, a, b, vector), want), vector


@pytest.mark.parametrize("M", MS)
def test_k7_lane_map_matches_reference(M):
    D, P = 29, 141  # P not a multiple of the 32-lane tile
    sig, a, b = _inputs(D, M, P, seed=100 + M)
    rng = np.random.RandomState(M)
    a, b = a.astype(np.int32), b.astype(np.int32)
    a[10:14], b[14:18] = [-3, D, D + 7, -1], [D, -5, 2 * D, -1]  # clipped
    valid = rng.rand(P) < 0.4
    valid[:18] = True
    valid[64:96] = False  # a tile with no valid lane
    valid[96:128] = True  # a tile with every lane valid
    want = np.asarray(ref.masked_indexed_pair_counts(
        jnp.asarray(sig), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(valid))).astype(np.int64)
    t = torch.from_numpy
    plain = k2.masked_indexed_pair_counts_plain(
        t(sig.view(np.int32)), t(a), t(b), t(valid))
    assert np.array_equal(plain.numpy(), want)
    assert np.all(want[~valid] == 0)
    # The pre-gathered form on the clipped rows of the same pairs.
    rows_a = sig[np.clip(a, 0, D - 1)]
    rows_b = sig[np.clip(b, 0, D - 1)]
    want_rows = np.asarray(ref.masked_pair_counts(
        jnp.asarray(rows_a), jnp.asarray(rows_b),
        jnp.asarray(valid))).astype(np.int64)
    assert np.array_equal(want_rows, want)
    for vector in _paths(M):
        assert np.array_equal(emulate_k7(sig, None, a, b, valid, vector),
                              want), vector
        assert np.array_equal(emulate_k7(rows_a, rows_b, None, None, valid,
                                         vector), want), vector


def test_verifier_flush_path_matches_reference_numpy():
    """The kernel and torch backends' batch path (one (2, P) index block
    up, one float32 download) on the seeded corpus, over flushes of mixed
    sizes, equals the reference's numpy verifier."""
    notes, _ = inject_near_duplicates(make_i2b2_like(40, seed=5), 24,
                                      frac_high=0.1, seed=6)
    packed = ref_shingle.pack_documents([ref_shingle.tokenize(t)
                                         for t in notes])
    ng, valid = ref_shingle.ngram_hashes_np(packed.tokens, packed.lengths)
    sig = signatures_np(ng, valid, default_seeds(100))
    rng = np.random.RandomState(8)
    ref_v = RefSignatureVerifier(sig, backend="numpy")
    for backend in ("kernel", "torch"):
        v = SignatureVerifier(sig, backend=backend, device="cpu")
        for P in (1, 8192, 8193, 3):
            pairs = rng.randint(0, len(sig), size=(P, 2))
            got = v(pairs)
            assert got.dtype == np.float32 and got.shape == (P,)
            assert np.array_equal(got.view(np.uint32),
                                  ref_v(pairs).view(np.uint32)), (backend, P)
        assert v.n_batches == 5
