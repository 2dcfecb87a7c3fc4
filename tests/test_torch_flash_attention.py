"""K8's plain version and the port's attention against the reference's.

The reference's ``flash_attention`` runs in Pallas interpret mode on the
CPU, as ``tests/test_kernels.py`` runs it; inputs are made with numpy
from a seed and handed to both packages.  Float32 throughout, so the
tolerance is ``test_kernels.py``'s ``atol=3e-5``: the two online softmaxes
visit the keys in tiles of other sizes, which changes only the float32
rounding of their sums.

``k8_schedule`` and ``k8_f32_schedule`` walk the CUDA kernels' schedules
(bf16 and float32) in torch on the CPU (the kernels themselves run only
on the card), so their tile arithmetic is checked here against the
reference's kernel.
"""
import functools
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
    tier = next(t for t in K8_TIERS if max(q.shape[3], v.shape[3]) <= t)
    return _tiled_flash(q, k, v, causal=causal, window=window, scale=scale,
                        q_rows=K8_Q_ROWS, key_tile=k8_key_tile(tier))


def _tiled_flash(q, k, v, *, causal, window, scale, q_rows, key_tile):
    """The tile walk both K8 kernels share (see ``k8_schedule``)."""
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    g = H // Hkv
    rows = Sq * g
    tk = key_tile
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
            for row0 in range(0, rows, q_rows):
                r = torch.arange(row0, min(row0 + q_rows, rows))
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
                    s = qf[r] @ kt.T * scale_log2
                    ok = (keys[None] >= klo[:, None]) & (keys[None] < khi[:, None])
                    if k0 < inner_lo or k0 + tk > inner_hi:
                        s = s.masked_fill(~ok, float("-inf"))
                    else:
                        assert bool(ok.all()), "interior tile needs a mask"
                    mx = s.amax(dim=1)
                    m_new = torch.maximum(m, mx)
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


@functools.lru_cache(maxsize=None)
def _schedule_case(B, Sq, Skv, H, Hkv, Dh, Dv, window, causal, dtype,
                   scale=None):
    """Inputs of one schedule case and the reference's output on them,
    computed once for every schedule that uses it: its kernel in interpret
    mode, or with a ``scale`` its ``blockwise_attention`` (the kernel takes
    ``scale`` traced, which its ``pallas_call`` cannot capture)."""
    qn, kn, vn = _qkv(B, Sq, Skv, H, Hkv, Dh, seed=6, Dv=Dv)
    args = [jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (qn, kn, vn)]
    if scale is None:
        ref = ref_flash(*args, causal=causal, window=window)
    else:
        ref = ref_attention.blockwise_attention(*args, causal=causal,
                                                window=window, scale=scale)
    return qn, kn, vn, np.array(ref.astype(jnp.float32))


def _check_schedule(B, Sq, Skv, H, Hkv, Dh, Dv, window, causal, dtype,
                    schedule=k8_schedule, scale=None):
    qn, kn, vn, ref = _schedule_case(B, Sq, Skv, H, Hkv, Dh, Dv, window,
                                     causal, dtype, scale)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(tdt) for x in (qn, kn, vn))
    got = schedule(q, k, v, causal=causal, window=window, scale=scale)
    assert got.dtype == tdt and got.shape == (B, Sq, H, Dv)
    plain = k8.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale).float()
    got = got.float()
    if window == 0:
        assert not got.any()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
        torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
        return
    vbar = k8.flash_attention_plain(q, k, v.abs(), causal=causal,
                                    window=window, scale=scale).float()
    for want in (torch.from_numpy(ref), plain):
        err = (got - want).abs() / bf16_bound(want, vbar)
        assert float(err.max()) <= 1.0


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,window,causal", SCHEDULE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_schedule_matches_reference_kernel_and_plain(
        B, Sq, Skv, H, Hkv, Dh, window, causal, dtype):
    _check_schedule(B, Sq, Skv, H, Hkv, Dh, Dh, window, causal, dtype)


VALUE_WIDTH_SHAPES = [
    # B, Sq, Skv, H, Hkv, Dh, Dv, window, causal
    (1, 150, 150, 8, 2, 64, 80, 40, True),    # Dv > Dh: the tier is Dv's
    (2, 70, 90, 6, 2, 64, 36, None, False),   # Dv % 8 != 0
    (1, 130, 130, 4, 4, 128, 64, None, True),  # Dv < Dh
]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,Dv,window,causal",
                         VALUE_WIDTH_SHAPES)
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


# -- the float32 kernel's schedule, emulated --------------------------------------

# Tiling of csrc/flash_attention_f32.cu's register-tiled kernel, held to the
# source by test_f32_schedule_constants_match_the_kernel_source.
K8_F32_TIERS = (16, 80, 128, 256)  # head widths instantiated; others pad up
K8_F32_KEYS = 32                    # keys a K/V tile, every tier
K8_F32_ROWS_PER_THREAD = 4


def k8_f32_threads(tier: int) -> int:
    """Threads a block: 128, 256 at width 256."""
    return 128 if tier <= 128 else 256


def k8_f32_lanes(tier: int) -> int:
    """Lanes that share a folded q row: 4 up to width 80, 8 at 128, 16 at
    256."""
    return 4 if tier <= 80 else 8 if tier <= 128 else 16


def k8_f32_q_rows(tier: int) -> int:
    """Folded q rows a block: 128 up to width 80, 64 above."""
    return (k8_f32_threads(tier) // k8_f32_lanes(tier)
            * K8_F32_ROWS_PER_THREAD)


def k8_f32_schedule(q, k, v, *, causal=True, window=None, scale=None):
    """The float32 kernel's schedule in torch, for float32 q, k, v on the CPU.

    ``k8_schedule``'s fold, key range, zero fill, edge-only masks and exp
    form (scores times scale x log2 e before the mask and the max, p =
    exp2(s - m_safe)), on row tiles of ``k8_f32_q_rows`` and key tiles of
    ``K8_F32_KEYS``, with no rounding of p.  Returns (B, Sq, H, Dv)
    float32.
    """
    assert q.dtype == k.dtype == v.dtype == torch.float32
    tier = next(t for t in K8_F32_TIERS if max(q.shape[3], v.shape[3]) <= t)
    return _tiled_flash(q, k, v, causal=causal, window=window, scale=scale,
                        q_rows=k8_f32_q_rows(tier), key_tile=K8_F32_KEYS)


F32_SCHEDULE_SHAPES = [
    (B, Sq, Skv, H, Hkv, Dh, Dh, window, causal)
    for B, Sq, Skv, H, Hkv, Dh, window, causal in SCHEDULE_SHAPES
] + VALUE_WIDTH_SHAPES + [
    (1, 60, 60, 32, 1, 16, 16, 20, True),      # g = 32: 4 positions a tile
    (1, 150, 150, 4, 1, 128, 128, 45, True),   # window off the key grid
]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,Dv,window,causal",
                         F32_SCHEDULE_SHAPES)
def test_f32_kernel_schedule_matches_reference_kernel_and_plain(
        B, Sq, Skv, H, Hkv, Dh, Dv, window, causal):
    _check_schedule(B, Sq, Skv, H, Hkv, Dh, Dv, window, causal, "float32",
                    schedule=k8_f32_schedule)


@pytest.mark.parametrize("scale", [-0.3, 0.0])
@pytest.mark.parametrize("dtype,schedule", [("float32", k8_f32_schedule),
                                            ("bfloat16", k8_schedule)])
def test_kernel_schedules_take_any_sign_of_scale(scale, dtype, schedule):
    """Scores are scaled before the mask and the row max, so a negative
    or zero scale gives the reference's output (the row max of s x c is
    not (max s) x c there, and a masked -inf times 0 is not -inf); held
    against the reference's ``blockwise_attention`` and the plain
    version."""
    _check_schedule(2, 10, 30, 4, 2, 16, 16, 7, True, dtype,
                    schedule=schedule, scale=scale)


def test_f32_schedule_constants_match_the_kernel_source():
    src = (build.CSRC / "flash_attention_f32.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    def by_tier(name, pattern):
        """A Tier member ``kD <= a ? x : ...`` as a function of the tier."""
        expr = re.search(rf"static constexpr int {name} = ({pattern});",
                         src).group(1)
        cuts = [(int(a), int(x)) for a, x in
                re.findall(r"kD <= (\d+) \? (\d+) :", expr)]
        last = int(re.search(r": (\d+)$", expr).group(1))
        return lambda t: next((x for a, x in cuts if t <= a), last)

    assert const("kKeys") == K8_F32_KEYS
    assert const("kTM") == K8_F32_ROWS_PER_THREAD
    threads = by_tier("kThreads", r"[^;]+")
    lanes = by_tier("kRX", r"[^;]+")
    assert [threads(t) for t in K8_F32_TIERS] == [
        k8_f32_threads(t) for t in K8_F32_TIERS]
    assert [lanes(t) for t in K8_F32_TIERS] == [
        k8_f32_lanes(t) for t in K8_F32_TIERS]
    assert "kRY = kThreads / kRX;" in src and "kRows = kRY * kTM;" in src
    assert [k8_f32_q_rows(t) for t in K8_F32_TIERS] == [128, 128, 64, 64]
    tiers = sorted({int(x) for x in re.findall(r"launch<(\d+)>\(", src)})
    assert tuple(tiers) == K8_F32_TIERS
