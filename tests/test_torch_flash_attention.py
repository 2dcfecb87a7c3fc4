"""K8's plain version and the port's attention against the reference's.

The reference's ``flash_attention`` runs in Pallas interpret mode on the
CPU, as ``tests/test_kernels.py`` runs it; inputs are made with numpy
from a seed and handed to both packages.  Float32 throughout, so the
tolerance is ``test_kernels.py``'s ``atol=3e-5``: the two online softmaxes
visit the keys in tiles of other sizes, which changes only the float32
rounding of their sums.

``k8_schedule`` walks the CUDA bf16 kernel's schedule in torch on the CPU
(the kernel itself runs only on the card), so its tile arithmetic is
checked here against the reference's kernel.
"""
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import attention as ref_attention
from repro.models import blocks as ref_blocks
from repro_torch.kernels import build
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


# -- the bf16 kernel's schedule, emulated -----------------------------------------

# Tiling of csrc/flash_attention.cu's tensor-core kernel, held to the source
# by test_schedule_constants_match_the_kernel_source.
K8_TIERS = (16, 80, 128, 256)   # head widths instantiated; others pad up
K8_Q_ROWS = 128                  # folded q rows a block: 8 warps x 16
LOG2E = np.float32(1.4426950408889634)


def k8_key_tile(tier: int) -> int:
    return {256: 32, 80: 48}.get(tier, 64)


def k8_schedule(q, k, v, *, causal=True, window=None, scale=None):
    """The bf16 kernel's schedule in torch, for q, k, v on the CPU.

    Rows of a KV head are its g query heads folded as ``pos * g + j``, cut
    into tiles of ``K8_Q_ROWS``; each tile walks its keys from the window
    start of its first position to its last position + 1 in tiles of
    ``k8_key_tile``, zero-filling keys past the end.  Scores are float32
    products times scale x log2 e (both float32, as the launcher computes
    it), masked only on tiles that cross the diagonal, the window edge or
    the end; on interior tiles the mask is asserted to be all true.
    p = exp2(s - m_safe) sums into l in float32 and is rounded to v's
    dtype only for PV.  Returns (B, Sq, H, Dv) in q's dtype.
    """
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    g = H // Hkv
    rows = Sq * g
    tier = next(t for t in K8_TIERS if max(Dh, Dv) <= t)
    tk = k8_key_tile(tier)
    scale = np.float32(Dh**-0.5 if scale is None else scale)
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)

    def key_lo(pos):
        return 0 if window is None else min(max(pos - window + 1, 0), Skv)

    def key_hi(pos):
        return min(pos + 1, Skv) if causal else Skv

    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype)
    for b in range(B):
        for hkv in range(Hkv):
            heads = slice(hkv * g, (hkv + 1) * g)
            qf = q[b, :, heads].reshape(rows, Dh).float()  # row pos * g + j
            kh, vh = k[b, :, hkv], v[b, :, hkv]
            of = torch.empty((rows, Dv), dtype=torch.float32)
            for row0 in range(0, rows, K8_Q_ROWS):
                r = torch.arange(row0, min(row0 + K8_Q_ROWS, rows))
                pos = (r // g).tolist()
                pmin, pmax = pos[0], pos[-1]
                lo, hi = key_lo(pmin), key_hi(pmax)
                inner_lo, inner_hi = key_lo(pmax), key_hi(pmin)
                klo = torch.tensor([key_lo(p) for p in pos])
                khi = torch.tensor([key_hi(p) for p in pos])
                # No row sees a key the block does not load.
                assert bool((((klo >= lo) & (khi <= hi)) | (klo >= khi)).all())
                m = torch.full((len(pos),), float("-inf"))
                l = torch.zeros(len(pos))
                acc = torch.zeros((len(pos), Dv))
                for k0 in range(lo, hi, tk):
                    keys = torch.arange(k0, k0 + tk)
                    live = keys < hi
                    kt = torch.zeros((tk, Dh))
                    vt = torch.zeros((tk, Dv), dtype=v.dtype)
                    kt[live] = kh[keys[live]].float()
                    vt[live] = vh[keys[live]]
                    s = (qf[r] @ kt.T) * scale_log2
                    ok = (keys[None] >= klo[:, None]) & (keys[None] < khi[:, None])
                    if k0 < inner_lo or k0 + tk > inner_hi:
                        s = s.masked_fill(~ok, float("-inf"))
                    else:
                        assert bool(ok.all()), "interior tile needs a mask"
                    m_new = torch.maximum(m, s.amax(dim=1))
                    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                    corr = torch.where(torch.isfinite(m),
                                       torch.exp2(m - m_safe), 0.0)
                    p = torch.exp2(s - m_safe[:, None])
                    l = l * corr + p.sum(dim=1)
                    acc = acc * corr[:, None] + p.to(v.dtype).float() @ vt.float()
                    m = m_new
                of[r] = acc / torch.clamp(l, min=1e-30)[:, None]
            out[b, :, heads] = of.reshape(Sq, g, Dv).to(q.dtype)
    return out


def bf16_bound(want, vbar):
    """chip_smoke.py's per-element bound for bf16: one ulp of the output
    (2**-7 |want|), p's rounding against a tile-order-dependent running max
    (2**-8 of the plain version on |v|), and 1e-5 for float32 sums."""
    return 2**-7 * want.abs() + 2**-8 * vbar + 1e-5


SCHEDULE_SHAPES = [
    # B, Sq, Skv, H, Hkv, Dh, window, causal
    (1, 150, 150, 6, 2, 16, None, True),    # g = 3, ragged last q tile
    (2, 40, 170, 4, 2, 16, None, False),    # Skv > Sq, not causal
    (2, 10, 30, 4, 2, 16, 7, True),         # Skv > Sq, causal, window
    (1, 100, 100, 8, 2, 16, 1, True),       # window of 1
    (1, 200, 200, 4, 1, 16, 64, True),      # window of one key tile
    (1, 70, 70, 4, 2, 16, 0, True),         # every key masked: zeros
    (1, 100, 100, 4, 4, 8, None, True),     # Dh 8, zero-padded to 16
    (2, 50, 50, 6, 2, 36, 20, True),        # Dh 36, zero-padded to 80
    (1, 260, 260, 8, 2, 80, 100, True),     # h2o-danube's tier, g = 4
    (1, 130, 130, 8, 2, 80, 48, True),      # window of that tier's key tile
    (1, 90, 90, 2, 2, 256, None, True),     # gemma's tier: 32-key tiles
]


def _check_schedule(B, Sq, Skv, H, Hkv, Dh, Dv, window, causal, dtype):
    qn, kn, vn = _qkv(B, Sq, Skv, H, Hkv, Dh, seed=6, Dv=Dv)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(tdt) for x in (qn, kn, vn))
    got = k8_schedule(q, k, v, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, Sq, H, Dv)
    ref = np.array(ref_flash(*(jnp.asarray(x, dtype=getattr(jnp, dtype))
                                 for x in (qn, kn, vn)),
                               causal=causal, window=window).astype(jnp.float32))
    plain = k8.flash_attention_plain(q, k, v, causal=causal,
                                     window=window).float()
    got = got.float()
    if window == 0:
        assert not got.any()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
        torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
        return
    vbar = k8.flash_attention_plain(q, k, v.abs(), causal=causal,
                                    window=window).float()
    for want in (torch.from_numpy(ref), plain):
        err = (got - want).abs() / bf16_bound(want, vbar)
        assert float(err.max()) <= 1.0


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,window,causal", SCHEDULE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_schedule_matches_reference_kernel_and_plain(
        B, Sq, Skv, H, Hkv, Dh, window, causal, dtype):
    _check_schedule(B, Sq, Skv, H, Hkv, Dh, Dh, window, causal, dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,Dv,window,causal", [
    (1, 150, 150, 8, 2, 64, 80, 40, True),    # Dv > Dh: the tier is Dv's
    (2, 70, 90, 6, 2, 64, 36, None, False),   # Dv % 8 != 0
    (1, 130, 130, 4, 4, 128, 64, None, True),  # Dv < Dh
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_schedule_with_value_width_matches_reference_and_plain(
        B, Sq, Skv, H, Hkv, Dh, Dv, window, causal, dtype):
    _check_schedule(B, Sq, Skv, H, Hkv, Dh, Dv, window, causal, dtype)


def test_schedule_constants_match_the_kernel_source():
    src = (build.CSRC / "flash_attention.cu").read_text()
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    assert "kQRows = kWarps * 16;" in src and 16 * warps == K8_Q_ROWS
    t1, k1, t2, k2, rest = map(int, re.search(
        r"kKeys = kD == (\d+) \? (\d+) : kD == (\d+) \? (\d+) : (\d+);",
        src).groups())
    assert [k8_key_tile(t) for t in K8_TIERS] == [
        {t1: k1, t2: k2}.get(t, rest) for t in K8_TIERS]
    tiers = sorted({int(x) for x in re.findall(r"launch_bf16<(\d+)>\(", src)})
    assert tuple(tiers) == K8_TIERS
