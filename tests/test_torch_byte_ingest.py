"""Port parity for byte ingest: ``pack_bytes``, K6 and ``bytes_to_bands``.

K6's plain version is held against the reference's Pallas kernel in
interpret mode and its numpy oracle; ``bytes_to_bands`` against the
reference's chain and against the host chain ``tokenize(do_stem=False)``
-> ``pack_documents`` -> K1.  Every comparison is bit for bit.  The CUDA
kernel is held against the plain version in ``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import shingle as ref_shingle
from repro.kernels.byte_shingle import byte_token_hashes as ref_byte_tokens
from repro.kernels.byte_shingle import bytes_to_bands as ref_bytes_to_bands
from repro_torch.core import shingle
from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
from repro_torch.kernels import byte_shingle as k6
from repro_torch.kernels import fused_ingest as k1

# ASCII clinical text, case folding, digits, 2-, 3- and 4-byte UTF-8,
# empty and separator-only documents, long runs.
CORPUS = [
    "CHIEF COMPLAINT : fever . Vitals BP 120/80 , HR 92 .",
    "patient denies chest pain; möglich über café naïve",
    "температура 38.5 градусов — прием 2x daily",
    "心电图 normal ECG 🚑 stat",
    "",
    "...",
    "a",
    "A" * 40 + " " + "b2" * 30,
    "x" * 300,
]


def _seeds(m, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2**32, size=(m,), dtype=np.uint64).astype(np.uint32)


def _k6_both(data, lengths):
    """(port plain, Pallas interpret) K6 outputs as numpy uint32 / int32."""
    tok, ends = k6.byte_token_hashes_plain(torch.from_numpy(data),
                                           torch.from_numpy(lengths))
    ptok, pends = ref_byte_tokens(jnp.asarray(data), jnp.asarray(lengths))
    assert tok.dtype == torch.int32 and ends.dtype == torch.int32
    return (u32_to_numpy(tok), ends.numpy()), (np.asarray(ptok),
                                               np.asarray(pends))


# -- pack_bytes -------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [None, 301, 512])
def test_pack_bytes_matches_reference(max_len):
    docs = CORPUS + [b"raw \xff bytes"]
    got = shingle.pack_bytes(docs, max_len)
    want = ref_shingle.pack_bytes(docs, max_len)
    assert np.array_equal(got.data, want.data)
    assert np.array_equal(got.lengths, want.lengths)
    assert got.data.dtype == np.uint8 and got.lengths.dtype == np.int32
    assert got.num_docs == want.num_docs == len(docs)


def test_pack_bytes_width_must_exceed_every_length():
    for pack in (shingle.pack_bytes, ref_shingle.pack_bytes):
        with pytest.raises(ValueError, match="max doc bytes"):
            pack(["x" * 300], 300)
    assert shingle.pack_bytes([]).data.shape == (0, 1)


# -- K6: byte token hashes ---------------------------------------------------------

def test_byte_tokens_plain_matches_pallas_with_garbage_past_length():
    rng = np.random.RandomState(7)
    D, LB = 6, 96
    data = rng.randint(0, 256, size=(D, LB)).astype(np.uint8)
    data[:, ::3] = rng.randint(97, 123, size=(D, LB // 3))  # more runs
    lengths = np.array([0, 1, 40, LB - 1, LB - 1, 17], dtype=np.int32)
    (tok, ends), (ptok, pends) = _k6_both(data, lengths)
    assert np.array_equal(tok, ptok) and np.array_equal(ends, pends)
    otok, oends = ref_shingle.byte_token_hashes_np(data, lengths)
    assert np.array_equal(tok, otok) and np.array_equal(ends, oends)
    assert ends[0].sum() == 0 and ends.sum() > 10


def test_byte_tokens_plain_matches_pallas_across_the_tile_edge():
    # The Pallas kernel walks 128- and 256-byte tiles with a carried FNV
    # state; these tokens run across those edges.
    texts = ["ab " * 43 + "tail", "c" * 126, "d" * 127, "e" * 128,
             "F" * 129, "g" * 127 + " h", "Q" * 255 + " " + "z" * 40]
    packed = ref_shingle.pack_bytes(texts, 512)
    (tok, ends), (ptok, pends) = _k6_both(packed.data, packed.lengths)
    assert np.array_equal(tok, ptok) and np.array_equal(ends, pends)
    ptok128, _ = ref_byte_tokens(jnp.asarray(packed.data),
                                 jnp.asarray(packed.lengths), td=2, tlb=128)
    assert np.array_equal(tok, np.asarray(ptok128))


def test_byte_tokens_plain_matches_pallas_on_utf8_and_case():
    packed = ref_shingle.pack_bytes(CORPUS, 512)
    (tok, ends), (ptok, pends) = _k6_both(packed.data, packed.lengths)
    assert np.array_equal(tok, ptok) and np.array_equal(ends, pends)
    for d, text in enumerate(CORPUS):
        want = ref_shingle.token_ids(ref_shingle.tokenize(text,
                                                          do_stem=False))
        assert np.array_equal(tok[d][ends[d] == 1], want), text


def test_byte_tokens_wrapper_on_cpu_runs_the_plain_version():
    packed = shingle.pack_bytes(CORPUS[:4], 256)
    data = torch.from_numpy(packed.data)
    lengths = torch.from_numpy(packed.lengths)
    k6.launches = 0
    for g, w in zip(k6.byte_token_hashes(data, lengths),
                    k6.byte_token_hashes_plain(data, lengths)):
        assert torch.equal(g, w)
    assert k6.launches == 0


def test_byte_tokens_wrapper_rejects_what_the_kernel_does_not_take():
    data = torch.zeros((3, 16), dtype=torch.uint8)
    lengths = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        k6.byte_token_hashes(data.int(), lengths)
    with pytest.raises(TypeError):
        k6.byte_token_hashes(data, lengths.long())
    with pytest.raises(ValueError):
        k6.byte_token_hashes(data, lengths[:2])
    with pytest.raises(ValueError, match="no kernel"):
        k6.byte_token_hashes(data.to("meta"), lengths.to("meta"))


# -- bytes_to_bands ---------------------------------------------------------------

def _bytes_to_bands(texts, seeds, n, r):
    width = shingle.pow2_bucket(
        max((len(t.encode("utf-8")) for t in texts), default=0) + 1)
    packed = shingle.pack_bytes(texts, width)
    return packed, k6.bytes_to_bands(
        torch.from_numpy(packed.data), torch.from_numpy(packed.lengths),
        u32_from_numpy(seeds), n=n, r=r)


def _host_chain(texts, seeds, n, r):
    toks = [shingle.tokenize(t, do_stem=False) for t in texts]
    packed = shingle.pack_documents(
        toks, shingle.pow2_bucket(max((len(t) for t in toks), default=1)))
    sig, bands, _ = k1.fused_ingest_plain(
        u32_from_numpy(packed.tokens), torch.from_numpy(packed.lengths),
        u32_from_numpy(seeds), n=n, r=r)
    return u32_to_numpy(sig), u32_to_numpy(bands), packed.lengths


@pytest.mark.parametrize("texts,m,n,r", [
    (CORPUS, 20, 8, 2),
    (["one two", "a b c", "", "solo", "🚑 🚑", "x y z w"], 15, 3, 3),
])
def test_bytes_to_bands_matches_reference_and_host_chain(texts, m, n, r):
    seeds = _seeds(m)
    packed, (sig, bands, counts) = _bytes_to_bands(texts, seeds, n, r)
    psig, pbands, pcounts = ref_bytes_to_bands(
        jnp.asarray(packed.data), jnp.asarray(packed.lengths),
        jnp.asarray(seeds), n=n, r=r)
    assert np.array_equal(u32_to_numpy(sig), np.asarray(psig))
    assert np.array_equal(u32_to_numpy(bands), np.asarray(pbands))
    assert np.array_equal(counts.numpy(), np.asarray(pcounts))
    hsig, hbands, hcounts = _host_chain(texts, seeds, n, r)
    assert np.array_equal(u32_to_numpy(sig), hsig)
    assert np.array_equal(u32_to_numpy(bands), hbands)
    assert np.array_equal(counts.numpy(), hcounts)


def test_bytes_to_bands_of_no_documents_is_empty():
    seeds = _seeds(10)
    data = np.zeros((0, 256), dtype=np.uint8)
    lengths = np.zeros((0,), dtype=np.int32)
    got = k6.bytes_to_bands(torch.from_numpy(data), torch.from_numpy(lengths),
                            u32_from_numpy(seeds), n=8, r=2)
    want = ref_bytes_to_bands(jnp.asarray(data), jnp.asarray(lengths),
                              jnp.asarray(seeds), n=8, r=2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.int32
    with pytest.raises(ValueError, match="not divisible"):
        k6.bytes_to_bands(torch.from_numpy(data), torch.from_numpy(lengths),
                          u32_from_numpy(seeds), r=3)


def test_compact_tokens_packs_each_row_in_order_and_zero_fills():
    tok = torch.tensor([[0, 5, 0, 7, 0, 9], [0, 0, 0, 0, 0, 0],
                        [0, 0, 3, 0, 0, 0]], dtype=torch.int32)
    ends = (tok != 0).to(torch.int32)
    tokens, counts = k6.compact_tokens(tok, ends, 4)
    assert counts.dtype == torch.int32 and counts.tolist() == [3, 0, 1]
    assert tokens.tolist() == [[5, 7, 9, 0], [0, 0, 0, 0], [3, 0, 0, 0]]
