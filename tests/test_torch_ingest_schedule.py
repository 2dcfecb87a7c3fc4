"""K1's and K6's lane maps, emulated on the CPU and held to the reference.

The CUDA kernels (``csrc/fused_ingest.cu``, ``csrc/byte_shingle.cu``)
cannot run here, so numpy walks their schedules step by step.

K1: the lane map that ``lane_map`` below gives (a copy of the kernel's
``make_plan``; the card test ``test_ingest_schedules_match_the_python_side``
holds the library's ``fused_ingest_schedule`` to it): several rows a
block, seed lanes of S seeds each (in passes where M needs more lanes
than the block has), groups of lanes sharing the block's pool of n-gram
hashes (each row's quads in turn, its last quad padded with its first
hash; rounds of the pool's size for a longer row), every lane's 16-byte
reads of four hashes, fmix32 with plain shifts, each row's minima
leaving a lane by an atomic minimum, then the band fold.

K6: the flat stream of 16-position chunks: one division a chunk for its
first row, rows that start inside it, masks of token bytes and row
starts, the chunk that owns each end walking back over earlier chunks to
its token's start, the warp's outputs staged through a swizzled buffer
(vector path) or written word by word (scalar path, a misaligned base).

Each walk is held bit for bit to the reference's Pallas kernels in
interpret mode and to the port's plain versions.  The card tests
(``test_torch_cuda.py``) hold the kernels themselves to the plain
versions; they import ``lane_map`` from here, so JAX and ``repro`` are
imported only inside the tests that compare with the reference.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
from repro_torch.kernels import build
from repro_torch.kernels import byte_shingle as k6
from repro_torch.kernels import fused_ingest as k1

U32 = np.uint32
MASK = (1 << 32) - 1
GOLDEN, NGRAM_BASE = 0x9E3779B9, 0x01000193
LANE_SEEDS = (0x2545F491, 0x9E3779B9)
FNV_OFFSET, FNV_PRIME = 2166136261, 16777619
CHUNK = 16  # K6's positions a thread

# Constants of K1's lane map (csrc/minhash_pool_common.cuh).
THREADS = 128
POOL = 2048  # positions of a block's pool of n-gram hashes
MAX_DOCS = 32
PART_WORDS = 4096  # a block's running minima, docs x M words at most
SEEDS_PER_LANE = (4, 8, 2, 1)  # in order of preference at equal lane use


def lane_map(M: int, L: int) -> dict:
    """K1's lane map for rows of L tokens and M seeds, as ``make_plan`` in
    csrc/minhash_pool_common.cuh chooses it: the S of ``SEEDS_PER_LANE``
    whose map gives the most lane use, M slices / (THREADS S passes), the
    first on ties; as many documents a block as fit the pool whole, and
    rounds of ``POOL`` positions for longer rows.  Keyed as
    ``fused_ingest.schedule``."""
    quads = -(-L // 4)
    best, best_use = None, None
    for S in SEEDS_PER_LANE:
        groups = -(-M // S)
        lanes, passes = (THREADS, -(-groups // THREADS)) \
            if groups >= THREADS else (groups, 1)
        use = (M * (THREADS // lanes), S * passes)
        if best is None or use[0] * best_use[1] > best_use[0] * use[1]:
            best, best_use = (S, lanes, passes), use
    S, lanes, passes = best
    docs = max(1, min(POOL // (4 * quads), MAX_DOCS, PART_WORDS // M))
    return {"threads": THREADS, "S": S, "lanes": lanes, "passes": passes,
            "slices": THREADS // lanes, "docs": docs,
            "tile": min(4 * quads, POOL)}


def _reference():
    """The reference's K1 and K6 (Pallas, interpret mode on the CPU)."""
    from repro.kernels.byte_shingle import byte_token_hashes
    from repro.kernels.fused_ingest import fused_ingest

    return fused_ingest, byte_token_hashes


def _fmix(x):
    x = x ^ (x >> U32(16))
    x = x * U32(0x85EBCA6B)
    x = x ^ (x >> U32(13))
    x = x * U32(0xC2B2AE35)
    return x ^ (x >> U32(16))


def _seeded_hash(x, seed):
    """hash_u32(x, seed) = fmix32(x * GOLDEN32 + seed)."""
    return _fmix(x * U32(GOLDEN) + seed)


def _ngram(window):
    acc = np.zeros(window.shape[:-1], U32)
    for k in range(window.shape[-1]):
        acc = acc * U32(NGRAM_BASE) + window[..., k]
    return _fmix(acc)


# -- K1 ----------------------------------------------------------------------------

def emulate_k1(tokens: np.ndarray, lengths: np.ndarray, seeds: np.ndarray,
               n: int, r: int):
    D, L = tokens.shape
    M = len(seeds)
    p = lane_map(M, L)
    S, lanes, slices, docs, tile = (p[k] for k in
                                    ("S", "lanes", "slices", "docs", "tile"))
    span = tile + n - 1
    sig = np.zeros((D, M), U32)
    bands = np.zeros((D, M // r, 2), U32)
    valid = np.zeros((D, L), bool)
    visits = np.zeros((D, L, M), np.int64)  # (position, seed) triples walked
    for d0 in range(0, D, docs):
        nd = min(docs, D - d0)
        lens = lengths[d0 : d0 + nd].astype(np.int64)
        nvalid = np.minimum(L, np.where(lens >= n, lens - n + 1,
                                        (lens > 0).astype(np.int64)))
        part = np.full((nd, M), MASK, U32)
        rounds = -(-int(nvalid[0]) // tile) if docs == 1 else 1
        for rd in range(rounds):
            l0 = rd * tile
            nts = [min(tile, int(v) - l0) for v in nvalid]
            # The pool: each row's quads in turn, its last one padded with
            # the row's first hash of the round.
            qs = np.concatenate([[0], np.cumsum([max(0, nt + 3) >> 2
                                                 for nt in nts])])
            pool = np.zeros(4 * qs[-1], U32)
            for bb, nt in enumerate(nts):
                if nt <= 0:
                    continue
                tok = np.zeros(span, U32)  # the round's tokens, zeros past L
                got = tokens[d0 + bb, l0 : min(L, l0 + span)]
                tok[: len(got)] = got
                windows = np.lib.stride_tricks.sliding_window_view(tok, n)
                src = np.arange((nt + 3) & ~3)
                src[nt:] = 0
                pool[4 * qs[bb] : 4 * qs[bb + 1]] = _ngram(windows[src])
            quads = pool.reshape(-1, 4)  # one 16-byte read a quad
            for thread in range(p["threads"]):
                g, q = thread % lanes, thread // lanes
                for ps in range(p["passes"]):
                    m0 = (ps * lanes + g) * S
                    if m0 >= M or q >= slices:
                        break
                    ms = np.minimum(np.arange(m0, m0 + S), M - 1)
                    own = np.arange(m0, m0 + S) < M
                    for bb in range(nd):  # lane group q: quads q + k slices
                        first, end = qs[bb], qs[bb + 1]
                        js = np.arange(first + (q - first % slices) % slices,
                                       end, slices)
                        if len(js) == 0:
                            continue
                        h = _seeded_hash(quads[js][:, :, None],
                                         seeds[ms][None, None, :])
                        # The row's minima leave the lane by atomicMin.
                        part[bb, ms[own]] = np.minimum(
                            part[bb, ms[own]], h.min(axis=(0, 1))[own])
                        pos = l0 + 4 * (js - first)[:, None] + np.arange(4)
                        pos = np.where(pos < l0 + nts[bb], pos, l0).ravel()
                        np.add.at(visits[d0 + bb], (pos[:, None],
                                                    ms[own][None, :]), 1)
        for bb in range(nd):
            row = part[bb]
            sig[d0 + bb] = row
            for band in range(M // r):
                for lane, seed in enumerate(LANE_SEEDS):
                    h = np.array([seed], U32)
                    for k in range(r):
                        h = _fmix(h * U32(GOLDEN) + row[band * r + k])
                    bands[d0 + bb, band, lane] = h[0]
            valid[d0 + bb, : nvalid[bb]] = True
    # Every valid (position, seed) triple is walked; no other one is.
    assert np.all((visits > 0) == valid[:, :, None])
    return sig, bands, valid


K1_MS = [1, 15, 100, 128, 260]
K1_LS = [5, 40, 256, 2500]


def _k1_inputs(L: int, M: int, n: int, seed: int):
    D = {5: 11, 40: 9, 256: 6, 2500: 8}[L]
    if lane_map(M, L)["docs"] > 1:
        D = max(D, lane_map(M, L)["docs"] + 3)  # a full block and a part
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 2**32, size=(D, L), dtype=np.uint64).astype(U32)
    lengths = rng.randint(0, L + 1, size=D).astype(np.int32)
    forced = [0, 1, n - 1, n, L, min(L, n + 4)]  # empty, short, L < n
    if L > 1024:
        forced += [1100, 2048 + n + 3]  # rows over one and two tiles
    lengths[: len(forced)] = forced
    seeds = rng.randint(0, 2**32, size=M, dtype=np.uint64).astype(U32)
    return tokens, lengths, seeds


@pytest.mark.parametrize("L", K1_LS)
@pytest.mark.parametrize("M", K1_MS)
def test_k1_lane_map_matches_reference(M, L):
    n, r = (8, 2) if M % 2 == 0 else (3, 1) if M == 1 else (5, 3)
    tokens, lengths, seeds = _k1_inputs(L, M, n, seed=M * 7 + L)
    ref_fused_ingest, _ = _reference()
    want = [np.asarray(x) for x in ref_fused_ingest(tokens, lengths, seeds,
                                                    n=n, r=r)]
    plain = k1.fused_ingest_plain(u32_from_numpy(tokens),
                                  torch.from_numpy(lengths),
                                  u32_from_numpy(seeds), n=n, r=r)
    assert np.array_equal(u32_to_numpy(plain[0]), want[0])
    assert np.array_equal(u32_to_numpy(plain[1]), want[1])
    assert np.array_equal(plain[2].numpy(), want[2])
    got = emulate_k1(tokens, lengths, seeds, n, r)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_k1_lane_map_and_constants_match_the_kernel_source():
    # K1's lane map and min loop live in the header it shares with K4.
    assert '#include "minhash_pool_common.cuh"' in \
        (build.CSRC / "fused_ingest.cu").read_text()
    text = (build.CSRC / "minhash_pool_common.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kThreads") == THREADS
    assert const("kPool") == POOL
    assert const("kMaxDocs") == MAX_DOCS
    assert const("kPartWords") == PART_WORDS
    listed = re.search(r"kSeedsPerLane\[\] = \{([\d, ]+)\}", text).group(1)
    assert tuple(int(s) for s in listed.split(",")) == SEEDS_PER_LANE
    # M = 100 on the main path's rows: 5 groups of 25 lanes of 4 seeds, 8
    # rows a block.
    assert lane_map(100, 256) == {"threads": 128, "S": 4, "lanes": 25,
                                  "passes": 1, "slices": 5, "docs": 8,
                                  "tile": 256}
    assert tuple(lane_map(100, 256)) == k1.MAP_KEYS


@pytest.mark.parametrize("L", [1, 3, 4, 5, 8, 9, 40, 256, 1024, 1025, 2048,
                               4096])
def test_k1_lane_map_covers_every_seed_within_the_block(L):
    for M in list(range(1, 300)) + [1000, 2000, 5000]:
        p = lane_map(M, L)
        assert p["lanes"] * p["slices"] <= p["threads"]
        assert p["S"] in SEEDS_PER_LANE
        assert p["lanes"] * p["S"] * p["passes"] >= M  # every seed a lane
        assert p["passes"] == 1 or p["lanes"] == p["threads"]
        assert p["docs"] == 1 or p["docs"] * p["tile"] <= POOL
        assert p["docs"] == 1 or p["tile"] >= L  # one round a row
        assert p["docs"] * M <= max(M, PART_WORDS)
        assert p["tile"] % 4 == 0 and p["tile"] <= max(POOL, L + 3)


# -- K6 ----------------------------------------------------------------------------

def _alnum(b: int) -> bool:
    return 97 <= b <= 122 or 65 <= b <= 90 or 48 <= b <= 57


def _fold(b: int) -> int:
    return b + 32 if 65 <= b <= 90 else b


def _hash_u32(x: int, seed: int) -> int:
    return int(_fmix(np.array([(x * GOLDEN + seed) & MASK], U32))[0])


def stage_slot(u: int) -> int:
    """``stage_slot`` in csrc/byte_shingle.cu."""
    t = u >> 2
    return (t << 2) | (((u & 3) + (t >> 1)) & 3)


def _chunk(words: np.ndarray, off: int, lengths, D: int, W: int, c: int,
           seed: int, vector: bool, hashed: np.ndarray):
    """Chunk c's 16 token ids and its end mask, as ``chunk_tokens``."""
    total = D * W
    p0 = c * CHUNK
    if vector and p0 + CHUNK <= total:  # one aligned 16-byte load
        assert (off + p0) % 16 == 0
        b = [int(x) for x in words[off + p0 : off + p0 + CHUNK]]
    else:
        b = [int(words[off + p0 + k]) if p0 + k < total else 0
             for k in range(CHUNK)]
    row, col = divmod(p0, W)  # the chunk's one division
    ln = int(lengths[row])
    prev = col > 0 and col - 1 < ln and _alnum(int(words[off + p0 - 1]))
    tmask = rmask = 0
    cc, rl, rr = col, ln, row
    for k in range(CHUNK):
        if cc == W:
            cc, rr = 0, rr + 1
            rl = int(lengths[rr]) if rr < D else 0
        rmask |= (cc == 0) << k
        tmask |= (cc < rl and _alnum(b[k])) << k
        cc += 1
    before = ((tmask << 1) | prev) & 0xFFFF
    emask = ~tmask & before & ~rmask & 0xFFFF
    smask = tmask & (~before | rmask)
    h = FNV_OFFSET
    stop = (~tmask | rmask) & 0xFFFF
    first = (stop & -stop).bit_length() - 1
    if prev and stop and not (rmask >> first) & 1:
        s, sc = p0 - 1, col - 1  # walk back to the inherited token's start
        while sc > 0 and _alnum(int(words[off + s - 1])):
            s, sc = s - 1, sc - 1
        for j in range(s, p0):
            h = ((h ^ _fold(int(words[off + j]))) * FNV_PRIME) & MASK
            hashed[j] += 1
    ids = [0] * CHUNK
    run = []  # positions of the run being hashed in this chunk
    for k in range(CHUNK):
        if (emask >> k) & 1:
            ids[k] = _hash_u32(h, seed)
            hashed[[p0 + j for j in run]] += 1
        if (tmask >> k) & 1:
            if (smask >> k) & 1:
                h, run = FNV_OFFSET, []
            h = ((h ^ _fold(b[k])) * FNV_PRIME) & MASK
            run.append(k)
    return ids, emask


def emulate_k6(data: np.ndarray, lengths: np.ndarray, seed: int,
               vector: bool):
    D, W = data.shape
    total = D * W
    off = 0 if vector else 1  # the scalar path: a base one byte in
    words = np.concatenate([np.zeros(off, np.uint8), data.ravel(),
                            np.zeros(CHUNK, np.uint8)])
    chunks = -(-total // CHUNK)
    tok = np.full(total, -1, np.int64)
    ends = np.full(total, -1, np.int64)
    hashed = np.zeros(total, np.int64)  # token bytes hashed into an emitted id
    for w in range(-(-chunks // 32)):  # warps of 32 chunks
        st = [None] * 128
        se = [None] * 128
        for lane in range(32):
            c = 32 * w + lane
            if c >= chunks:
                continue
            ids, emask = _chunk(words, off, lengths, D, W, c, seed, vector,
                                hashed)
            bits = [(emask >> k) & 1 for k in range(CHUNK)]
            if vector:  # four 16-byte words a thread into the staging slots
                for k in range(4):
                    st[stage_slot(lane * 4 + k)] = ids[4 * k : 4 * k + 4]
                    se[stage_slot(lane * 4 + k)] = bits[4 * k : 4 * k + 4]
            else:
                for k in range(CHUNK):
                    if c * CHUNK + k < total:
                        tok[c * CHUNK + k], ends[c * CHUNK + k] = ids[k], bits[k]
        if vector:  # lane l stores words l, 32 + l, 64 + l, 96 + l
            for k in range(4):
                for lane in range(32):
                    u = 32 * k + lane
                    pos = (32 * w) * CHUNK + 4 * u
                    for j in range(4):
                        if pos + j < total:
                            tok[pos + j] = st[stage_slot(u)][j]
                            ends[pos + j] = se[stage_slot(u)][j]
    assert np.all(tok >= 0) and np.all(ends >= 0)  # every position written once
    # Each byte of an emitted token is hashed once, by the end's owner.
    pos = np.arange(W)[None, :]
    b = data.astype(np.int64)
    alnum = (((b >= 97) & (b <= 122)) | ((b >= 65) & (b <= 90))
             | ((b >= 48) & (b <= 57))) & (pos < lengths[:, None])
    emitted = alnum.copy()
    for d in range(D):  # a run touching the last column never ends
        i = W - 1
        while i >= 0 and alnum[d, i]:
            emitted[d, i] = False
            i -= 1
    assert np.array_equal(hashed.reshape(D, W), emitted.astype(np.int64))
    return tok.reshape(D, W).astype(U32), ends.reshape(D, W).astype(np.int32)


def _k6_inputs(D: int, W: int, seed: int):
    """Text-like rows: alnum runs of both cases, separators, bytes >= 0x80,
    garbage past each length; rows of length 0 and W - 1, a row that is one
    run to its end and one run the length of the row."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTU"
                             b"VWXYZ0123456789   .,;:-", dtype=np.uint8)
    data = alphabet[rng.randint(0, len(alphabet), size=(D, W))]
    high = rng.rand(D, W) < 0.03
    data[high] = rng.randint(0x80, 0x100, size=int(high.sum()))
    lengths = rng.randint(0, W + 1, size=D).astype(np.int32)
    lengths[:5] = [0, W - 1, W - 1, W, 1]
    data[1, : W - 1] = ord("Q")  # one run to the end of the row
    data[2, W - 1] = ord(" ")
    data[3, :] = ord("z")  # one run the length of the row: never ends
    return data, lengths


@pytest.mark.parametrize("W", [2, 5, 16, 17, 300, 2049])
def test_k6_flat_stream_matches_reference(W):
    D = {2: 70, 5: 41, 16: 33, 17: 31, 300: 12, 2049: 6}[W]
    data, lengths = _k6_inputs(D, W, seed=W)
    _, ref_byte_tokens = _reference()
    ptok, pends = ref_byte_tokens(data, lengths)
    want = (np.asarray(ptok), np.asarray(pends))
    tok, ends = k6.byte_token_hashes_plain(torch.from_numpy(data),
                                           torch.from_numpy(lengths))
    assert np.array_equal(u32_to_numpy(tok), want[0])
    assert np.array_equal(ends.numpy(), want[1])
    assert want[1].sum() > 0
    for vector in (True, False):
        got = emulate_k6(data, lengths, k6.TOKEN_SEED, vector)
        assert np.array_equal(got[0], want[0]), vector
        assert np.array_equal(got[1], want[1]), vector


def test_k6_staging_slots_are_conflict_free():
    slots = [stage_slot(u) for u in range(128)]
    assert sorted(slots) == list(range(128))
    for k in range(4):  # writes: word k of 8 consecutive threads
        for t0 in range(0, 32, 8):
            assert len({stage_slot(4 * t + k) % 8
                        for t in range(t0, t0 + 8)}) == 8
    for u0 in range(0, 128, 8):  # reads: 8 consecutive words
        assert len({stage_slot(u) % 8 for u in range(u0, u0 + 8)}) == 8
    text = (build.CSRC / "byte_shingle.cu").read_text()
    assert re.search(r"constexpr int kChunk = (\d+);", text).group(1) == \
        str(CHUNK)
    assert "return (t << 2) | (((u & 3) + (t >> 1)) & 3);" in text
