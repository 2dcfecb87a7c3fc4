"""K8's plain version and the port's attention against the reference's.

The reference's ``flash_attention`` runs in Pallas interpret mode on the
CPU, as ``tests/test_kernels.py`` runs it; inputs are made with numpy
from a seed and handed to both packages.  Float32 throughout, so the
tolerance is ``test_kernels.py``'s ``atol=3e-5``: the two online softmaxes
visit the keys in tiles of other sizes, which changes only the float32
rounding of their sums.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import attention as ref_attention
from repro.models import blocks as ref_blocks
from repro_torch.kernels import flash_attention as k8
from repro_torch.kernels import ops
from repro_torch.models import attention, blocks

ATOL = 3e-5

# test_kernels.py:157-161's four shapes (GQA, MHA, window 24, ragged 37)
# and one with fewer queries than keys.
SHAPES = [
    # B, Sq, Skv, H, Hkv, Dh, window
    (2, 64, 64, 8, 2, 16, None),
    (1, 100, 100, 4, 4, 8, None),
    (2, 96, 96, 8, 2, 16, 24),
    (1, 37, 37, 6, 2, 16, None),
    (2, 10, 30, 4, 2, 16, 7),
]


def _qkv(B, Sq, Skv, H, Hkv, Dh, seed=0, Dv=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, Dh).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, Dh).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, Dv or Dh).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,window", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_reference_kernel_and_blockwise(
        B, Sq, Skv, H, Hkv, Dh, window, causal):
    q, k, v = _qkv(B, Sq, Skv, H, Hkv, Dh)
    got = k8.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window).numpy()
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                tq=32, tk=32))
    np.testing.assert_allclose(got, want, atol=ATOL)
    if Sq == Skv:  # the reference's blockwise path pads only keys
        bw = np.asarray(ref_attention.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, block_kv=16))
        np.testing.assert_allclose(got, bw, atol=ATOL)


def test_flash_plain_tiles_long_sequences_and_empty_rows():
    # Longer than one block of keys, a window that empties whole blocks,
    # and a window of 0 that masks every key (rows give 0, as the
    # reference).
    q, k, v = _qkv(1, 600, 600, 4, 2, 8, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for window in (150, 0):
        got = k8.flash_attention_plain(tq, tk, tv, window=window).numpy()
        want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window))
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert not got.any()


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    q, k, v = map(torch.from_numpy, _qkv(1, 20, 20, 4, 2, 16, seed=1))
    before = k8.launches
    got = ops.flash_attention(q, k, v, window=5)
    assert torch.equal(got, k8.flash_attention_plain(q, k, v, window=5))
    assert k8.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 4, 2, 16, seed=2))
    with pytest.raises(TypeError):
        k8.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        k8.flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError):
        k8.flash_attention(q[:, :, :3], k, v)            # H % Hkv != 0
    with pytest.raises(ValueError):
        k8.flash_attention(q, k[..., :8], v)             # Dh differs
    wide = torch.zeros(1, 4, 2, 264)
    with pytest.raises(ValueError):
        k8.flash_attention(wide, wide[:, :, :1], wide[:, :, :1])


def test_blockwise_attention_matches_reference():
    for B, Sq, Skv, H, Hkv, Dh, window in SHAPES[:4]:
        q, k, v = _qkv(B, Sq, Skv, H, Hkv, Dh, seed=4, Dv=Dh + 8)
        for q_offset, blk in ((0, 16), (5, 24)):
            got = attention.blockwise_attention(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                window=window, q_offset=q_offset, block_kv=blk).numpy()
            want = np.asarray(ref_attention.blockwise_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                window=window, q_offset=q_offset, block_kv=blk))
            np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    rng = np.random.RandomState(5)
    B, S, H, Hkv, Dh = 3, 12, 4, 2, 16
    q = rng.randn(B, H, Dh).astype(np.float32)
    kc = rng.randn(B, S, Hkv, Dh).astype(np.float32)
    vc = rng.randn(B, S, Hkv, Dh).astype(np.float32)
    kv_len = np.array([1, 7, 12], np.int32)
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(kv_len), window=window).numpy()
    want = np.asarray(ref_attention.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kv_len), window=window))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # The ring path's masked decode, on a pos map with empty slots.
    pos = np.array([[0, 1, 2, -1] + [-1] * 8,
                    [8, 9, 10, 11, 4, 5, 6, 7] + [-1] * 4,
                    list(range(12))], np.int32)
    valid = (pos >= 0) & (pos <= kv_len[:, None] - 1)
    got = blocks._decode_masked(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc),
                                torch.from_numpy(valid)).numpy()
    want = np.asarray(ref_blocks._decode_masked(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_mask_bias_matches_reference():
    qp = np.arange(3, 9, dtype=np.int32)
    kp = np.arange(0, 10, dtype=np.int32)
    for causal, window, kv_len in ((True, None, None), (True, 3, 8),
                                   (False, 2, None)):
        got = attention._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp),
                                   causal=causal, window=window,
                                   kv_len=kv_len).numpy()
        want = np.asarray(ref_attention._mask_bias(
            jnp.asarray(qp), jnp.asarray(kp), causal=causal, window=window,
            kv_len=kv_len))
        assert np.array_equal(got, want)
