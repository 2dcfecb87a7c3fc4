"""K3's and K4's maps, emulated on the CPU and held to the reference.

The CUDA kernels (``csrc/ngram.cu``, ``csrc/minhash.cu``) cannot run
here, so numpy walks their schedules step by step.

K3: the flat walk over quads of positions: tiles of ``K3_TILE`` quads
(``K3_QUADS`` a thread), a grid that strides over them with each quad's
row and column moved by the stride (no division in the walk), the tile
and the ``(n + 2) // 4`` quads after it staged, and then, on the vector
path, four rolling windows a quad with column tests a quad at a time; on
the scalar path (L % 4 != 0 or a misaligned base), each position's own
window and row.  Validity comes from the lengths in the same pass.

K4: the lane map of K1 (``lane_map``), filled by compaction: cells of
four columns, ``K4_CELLS`` a thread a round; each warp's cells grouped by
row (``__match_any_sync``), summed by a warp scan and added to the row's
count by one atomic, in any order of the warps; each row's run of valid
hashes at its first quad, its last quad padded by the lane holding the
run's first entry; then K1's walk of the pool.

Each walk is held bit for bit to the reference's Pallas kernels in
interpret mode and to the port's plain versions.  The card tests
(``test_torch_cuda.py``) hold the kernels to the plain versions and
their schedules to the Python copies here (``k3_path``, ``k4_path``).
"""
import functools
import re

import numpy as np
import pytest
import torch
from test_torch_ingest_schedule import (
    MASK,
    NGRAM_BASE,
    POOL,
    THREADS,
    _fmix,
    _seeded_hash,
    lane_map,
)

from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
from repro_torch.kernels import build
from repro_torch.kernels import minhash as k4
from repro_torch.kernels import ngram as k3

U32 = np.uint32

# Constants of csrc/ngram.cu and csrc/minhash.cu.
K3_THREADS, K3_QUADS = 256, 2  # threads a block, quads a thread a tile
K3_TILE = K3_THREADS * K3_QUADS  # quads a tile
K4_CELLS = POOL // 4 // THREADS  # cells of four columns a thread a round


def k3_path(L: int, tokens_ptr: int, hashes_ptr: int, valid_ptr: int) -> str:
    """The path ``ngram_hashes_schedule`` gives these bases."""
    vec = L % 4 == 0 and tokens_ptr % 16 == 0 and hashes_ptr % 16 == 0 \
        and valid_ptr % 4 == 0
    return "vector" if vec else "scalar"


def k4_path(L: int, ngrams_ptr: int, valid_ptr: int) -> str:
    """The path ``minhash_path`` gives these bases."""
    vec = L % 4 == 0 and ngrams_ptr % 16 == 0 and valid_ptr % 4 == 0
    return "vector" if vec else "scalar"


def _nvalid(lengths: np.ndarray, n: int) -> np.ndarray:
    ln = lengths.astype(np.int64)
    return np.where(ln >= n, ln - n + 1, (ln > 0).astype(np.int64))


# -- K3 ----------------------------------------------------------------------------

def emulate_k3(tokens: np.ndarray, lengths: np.ndarray, n: int, vector: bool,
               grid: int = 1):
    D, L = tokens.shape
    assert not vector or L % 4 == 0
    total = D * L
    quads = -(-total // 4)
    halo = (n + 2) // 4
    span = K3_TILE + halo
    words = np.zeros(4 * (quads + span), U32)
    words[:total] = tokens.ravel()  # zeros past the matrix
    hashes = np.zeros(total, U32)
    valid = np.zeros(total, bool)
    written = np.zeros(total, np.int64)
    nv = _nvalid(lengths, n)
    B = U32(NGRAM_BASE)
    bn = U32(pow(NGRAM_BASE, n, 1 << 32))
    stride = grid * K3_TILE
    step_rows, step_cols = divmod(4 * stride, L)
    tid = np.arange(K3_TILE)  # quad j * K3_THREADS + thread of the tile
    for blk in range(grid):
        p_first = 4 * (blk * K3_TILE + tid)
        row, col = p_first // L, p_first % L
        for t0 in range(blk * K3_TILE, quads, stride):
            tile = words[4 * t0 : 4 * (t0 + span)].reshape(span, 4)
            p0 = 4 * (t0 + tid)
            # The walk's row and column, moved by the stride, are p0's.
            assert np.array_equal(row, p0 // L)
            assert np.array_equal(col, p0 % L)
            act = p0 < total
            t, c, r, p = tid[act], col[act], row[act], p0[act]
            if vector:
                def quad(u, ok=True):
                    assert np.all(t + u < span)  # inside the staged tile
                    keep = ok & (c + 4 * u < L)  # a column test a quad
                    return np.where(keep[:, None], tile[t + u], U32(0))

                acc = np.zeros(len(t), U32)
                u = 0
                while 4 * u + 4 <= n:
                    v = quad(u)
                    for k in range(4):
                        acc = acc * B + v[:, k]
                    u += 1
                rem = n - 4 * u
                a = quad(u)
                b = quad(u + 1) if rem >= 2 else np.zeros_like(a)
                for k in range(rem):
                    acc = acc * B + a[:, k]
                ab = np.concatenate([a, b], axis=1)
                own = tile[t]
                h = [_fmix(acc)]
                for j in range(3):  # acc' = acc B + t[l + n] - t[l] B^n
                    acc = acc * B + ab[:, rem + j] - own[:, j] * bn
                    h.append(_fmix(acc))
                for j in range(4):
                    hashes[p + j] = h[j]
                    valid[p + j] = c + j < nv[r]
                    written[p + j] += 1
            else:
                flat = tile.ravel()
                for j in range(4):
                    inside = p + j < total
                    rj = r + (c + j) // L
                    cj = (c + j) % L
                    acc = np.zeros(len(t), U32)
                    for k in range(n):
                        acc = acc * B + np.where(cj + k < L,
                                                 flat[4 * t + j + k], U32(0))
                    hashes[(p + j)[inside]] = _fmix(acc)[inside]
                    valid[(p + j)[inside]] = (cj < nv[np.minimum(rj, D - 1)])[
                        inside]
                    written[(p + j)[inside]] += 1
            row = row + step_rows
            col = col + step_cols
            wrap = col >= L
            col[wrap] -= L
            row[wrap] += 1
    assert np.all(written == 1)  # every position written once
    return hashes.reshape(D, L), valid.reshape(D, L)


K3_NS = [1, 3, 8, 13]
K3_LS = [1, 3, 4, 5, 8, 256, 257, 2500]


def _k3_inputs(L: int, n: int, seed: int):
    # Over 2,048 positions, so the one-block grid walks several tiles.
    D = {1: 2200, 3: 800, 4: 600, 5: 500, 8: 300, 256: 10, 257: 10,
         2500: 6}[L]
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 2**32, size=(D, L), dtype=np.uint64).astype(U32)
    lengths = rng.randint(0, L + 1, size=D).astype(np.int32)
    forced = [0, 1, max(0, n - 1), n, L, min(L, n + 4)]  # empty, short, L < n
    lengths[: len(forced)] = forced
    return tokens, lengths


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's K3 and K4 (Pallas, interpret mode on the CPU)."""
    from repro.kernels.minhash import minhash_signatures
    from repro.kernels.ngram import ngram_hashes

    return ngram_hashes, minhash_signatures


@pytest.mark.parametrize("L", K3_LS)
@pytest.mark.parametrize("n", K3_NS)
def test_k3_quad_map_matches_reference(n, L):
    tokens, lengths = _k3_inputs(L, n, seed=n * 31 + L)
    ref_ngram, _ = _reference()
    ref_h, ref_v = (np.asarray(x) for x in ref_ngram(tokens, lengths, n=n))
    plain_h, plain_v = k3.ngram_hashes_plain(u32_from_numpy(tokens),
                                             torch.from_numpy(lengths), n=n)
    plain_h, plain_v = u32_to_numpy(plain_h), plain_v.numpy()
    assert np.array_equal(plain_v, ref_v)
    # The reference's halo is clamped at its last tile; it differs from
    # the zeros past column L only where no position is valid.
    assert np.array_equal(plain_h[ref_v], ref_h[ref_v])
    assert ref_v.any()
    for vector in (True, False) if L % 4 == 0 else (False,):
        h, v = emulate_k3(tokens, lengths, n, vector)
        assert np.array_equal(v, ref_v), vector
        assert np.array_equal(h, plain_h), vector


def test_k3_walk_strides_over_the_grid():
    """Three blocks striding over 49 tiles, on both paths, row and column
    moved without a division."""
    tokens, lengths = _k3_inputs(2500, 8, seed=5)
    tokens = np.tile(tokens, (10, 2))  # 20 rows of 5,000
    lengths = np.tile(lengths, 10)
    want = k3.ngram_hashes_plain(u32_from_numpy(tokens),
                                 torch.from_numpy(lengths), n=8)
    for vector in (True, False):
        h, v = emulate_k3(tokens, lengths, 8, vector, grid=3)
        assert np.array_equal(h, u32_to_numpy(want[0]))
        assert np.array_equal(v, want[1].numpy())


# -- K4 ----------------------------------------------------------------------------

def emulate_k4(ng: np.ndarray, valid: np.ndarray, seeds: np.ndarray,
               vector: bool, seed: int = 0) -> np.ndarray:
    D, L = ng.shape
    M = len(seeds)
    assert not vector or L % 4 == 0
    p = lane_map(M, L)
    S, lanes, slices, docs, tile = (p[k] for k in
                                    ("S", "lanes", "slices", "docs", "tile"))
    cols = tile // 4
    rounds = -(-L // tile)
    assert docs * tile <= POOL and (docs == 1 or rounds == 1)
    rng = np.random.RandomState(seed)  # the order in which warps add
    sig = np.zeros((D, M), U32)
    visits = np.zeros((D, L, M), np.int32)  # (position, seed) triples walked
    # Cell c: thread c % THREADS, the thread's cell c // THREADS.
    cell = np.arange(K4_CELLS * THREADS)
    for d0 in range(0, D, docs):
        nd = min(docs, D - d0)
        part = np.full((nd, M), MASK, U32)
        for rd in range(rounds):
            l0 = rd * tile
            bb = cell // cols
            col = l0 + 4 * (cell - bb * cols)
            row = np.where((bb < nd) & (col < L), bb, -1)
            pos = col[:, None] + np.arange(4)  # the cell's four columns
            act = (row[:, None] >= 0) & (pos < L)
            rr, pp = np.where(act, d0 + row[:, None], 0), np.where(act, pos, 0)
            flags = act & valid[rr, pp]
            # The vector path loads the cell's four hashes where any flag is
            # set, the scalar path the flagged ones; unflagged words are
            # never written to the pool.
            words = np.where(flags, ng[rr, pp], U32(0))
            count = flags.sum(axis=1)
            # Each warp's cells, one k at a time, warps in a random order.
            cnt = np.zeros(nd, np.int64)
            off = np.zeros(len(cell), np.int64)
            steps = [w for w in range(THREADS // 32) for _ in range(K4_CELLS)]
            rng.shuffle(steps)
            next_k = [0] * (THREADS // 32)
            for w in steps:
                k = next_k[w]
                next_k[w] += 1
                cs = 32 * w + np.arange(32) + THREADS * k
                r, c = row[cs], count[cs]
                incl = np.cumsum(c)
                for val in set(r.tolist()):
                    peers = np.flatnonzero(r == val)
                    lead, last = peers[0], peers[-1]
                    before = incl[lead] - c[lead]
                    total = incl[last] - before
                    # The lanes of a row are contiguous, so the scan's
                    # difference is the peers' sum.
                    assert total == c[peers].sum()
                    base = 0
                    if val >= 0 and total > 0:
                        base = cnt[val]
                        cnt[val] += total
                    off[cs[peers]] = base + incl[peers] - c[peers] - before
            nq = (cnt + 3) >> 2
            qend = np.cumsum(nq)
            qs = np.concatenate([[0], qend])
            pool = np.zeros(4 * qs[-1], U32)
            src = np.full(4 * qs[-1], -1, np.int64)  # each slot's column
            for ci in np.flatnonzero(count):
                first = 4 * qs[row[ci]]
                slots = first + off[ci] + np.arange(count[ci])
                assert np.all(src[slots] == -1)
                pool[slots] = words[ci][flags[ci]]
                src[slots] = pos[ci][flags[ci]]
                if off[ci] == 0:  # the row's first entry pads its last quad
                    pad = np.arange(first + cnt[row[ci]],
                                    first + 4 * nq[row[ci]])
                    assert np.all(src[pad] == -1)
                    pool[pad] = words[ci][flags[ci]][0]
                    src[pad] = pos[ci][flags[ci]][0]
            assert np.all(src >= 0)  # every slot of the pool written
            quads, srcq = pool.reshape(-1, 4), src.reshape(-1, 4)
            for thread in range(THREADS):  # K1's walk
                g, q = thread % lanes, thread // lanes
                for ps in range(p["passes"]):
                    m0 = (ps * lanes + g) * S
                    if m0 >= M or q >= slices:
                        break
                    ms = np.minimum(np.arange(m0, m0 + S), M - 1)
                    own = np.arange(m0, m0 + S) < M
                    for b in range(nd):
                        first, end = qs[b], qs[b + 1]
                        js = np.arange(first + (q - first % slices) % slices,
                                       end, slices)
                        if len(js) == 0:
                            continue
                        h = _seeded_hash(quads[js][:, :, None],
                                         seeds[ms][None, None, :])
                        part[b, ms[own]] = np.minimum(
                            part[b, ms[own]], h.min(axis=(0, 1))[own])
                        np.add.at(visits[d0 + b], (srcq[js].ravel()[:, None],
                                                   ms[own][None, :]), 1)
        sig[d0 : d0 + nd] = part
    # Every valid (position, seed) triple is walked; no other one is.
    assert np.array_equal(visits > 0, np.broadcast_to(valid[:, :, None],
                                                      visits.shape))
    return sig


K4_MS = [1, 7, 100, 128, 130, 260]
K4_LS = [4, 129, 256, 2500]
MASKS = ("all", "none", "1-in-64", "random 0.8", "prefix", "single")


@functools.lru_cache(maxsize=None)
def _k4_inputs(L: int):
    """Two rows of each mask of ``MASKS``, and 260 seeds: a smaller M takes
    a prefix of them (each seed's column is its own)."""
    rng = np.random.RandomState(L)
    D = 2 * len(MASKS)
    ng = rng.randint(0, 2**32, size=(D, L), dtype=np.uint64).astype(U32)
    valid = np.zeros((D, L), bool)
    cols = np.arange(L)
    for i, mask in enumerate(MASKS):
        for d in (2 * i, 2 * i + 1):
            if mask == "all":
                valid[d] = True
            elif mask == "1-in-64":
                valid[d] = cols % 64 == rng.randint(0, 64) % L
            elif mask == "random 0.8":
                valid[d] = rng.rand(L) < 0.8
            elif mask == "prefix":
                valid[d, : rng.randint(1, L + 1)] = True
            elif mask == "single":
                valid[d, rng.randint(0, L)] = True
    seeds = rng.randint(0, 2**32, size=max(K4_MS), dtype=np.uint64).astype(U32)
    _, ref_minhash = _reference()
    want = np.asarray(ref_minhash(ng, valid, seeds))
    return ng, valid, seeds, want


@pytest.mark.parametrize("L", K4_LS)
@pytest.mark.parametrize("M", K4_MS)
def test_k4_pool_map_matches_reference(M, L):
    ng, valid, all_seeds, all_want = _k4_inputs(L)
    seeds, want = all_seeds[:M], all_want[:, :M]
    assert np.all(want[2:4] == MASK)  # the rows with no valid position
    plain = k4.minhash_signatures_plain(
        u32_from_numpy(ng), torch.from_numpy(valid), u32_from_numpy(seeds))
    assert np.array_equal(u32_to_numpy(plain), want)
    for vector in (True, False) if L % 4 == 0 else (False,):
        got = emulate_k4(ng, valid, seeds, vector, seed=M + L)
        assert np.array_equal(got, want), vector


def test_k4_lane_map_covers_every_round():
    for L in (1, 3, 4, 129, 256, 1024, 2048, 2049, 2500, 4100):
        for M in list(range(1, 300)) + [1000, 2050, 5000]:
            p = lane_map(M, L)
            # A round's cells fit the threads' K4_CELLS each, and a row
            # longer than the pool is one row a block.
            assert p["docs"] * p["tile"] // 4 <= K4_CELLS * THREADS
            assert p["docs"] == 1 or p["tile"] >= L
            assert p["tile"] % 4 == 0 and p["tile"] <= POOL
            assert p["docs"] <= 32  # one warp scans the rows' counts


def test_staged_constants_match_the_kernel_sources():
    ngram_cu = (build.CSRC / "ngram.cu").read_text()
    minhash_cu = (build.CSRC / "minhash.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", ngram_cu).group(1) \
        == str(K3_THREADS)
    assert re.search(r"constexpr int kQuads = (\d+);", ngram_cu).group(1) \
        == str(K3_QUADS)
    assert "constexpr int kTile = kThreads * kQuads;" in ngram_cu
    assert "const int halo = (n + 2) / 4;" in ngram_cu
    assert ("return L % 4 == 0 && aligned(tokens, 16) && aligned(hashes, 16)"
            " &&") in ngram_cu and "aligned(valid, 4);" in ngram_cu
    assert "constexpr int kCells = kPool / 4 / kThreads;" in minhash_cu
    assert "return L % 4 == 0 && aligned(ngrams, 16) && aligned(valid, 4);" \
        in minhash_cu
    assert '#include "minhash_pool_common.cuh"' in minhash_cu
    assert K4_CELLS == 4
    # The main path's map: 8 rows of 256 a block, 25 lanes x 5 groups.
    assert lane_map(100, 256) == {"threads": 128, "S": 4, "lanes": 25,
                                  "passes": 1, "slices": 5, "docs": 8,
                                  "tile": 256}
