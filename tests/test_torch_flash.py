"""The port's flash kernels' plain versions vs the JAX Pallas kernels.

flash_fwd_reference / flash_decode_reference (megatron_tpu_torch
ops/flash/flash_template.py) are what the CUDA kernels are held against
on the card. Here they are held against the TPU kernels themselves, run
as the JAX package's own tests run them on the CPU: in Pallas interpret
mode, by calling _fwd / flash_mha / flash_decode / flash_decode_mq
directly. Same numpy inputs, fp32, atol 1e-5. Covered: causal and
bidirectional, sliding window, the q-vs-k offset delta, GQA, ragged
kv_lengths, a multi-query decode, and sequence lengths that are not a
multiple of the CUDA kernels' 64-row tile.

The backward kernels' plain version is held against the Pallas backward
in tests/test_torch_flash_bwd.py.

Also: masks.py against the JAX masks module, and the kernels' loop
bounds (live_tile_range, live_q_tile_range) against the block predicates
they replace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.ops.pallas import flash_template as jft
from megatron_tpu.ops.pallas import masks as jmasks
from megatron_tpu_torch.ops.attention import attention
from megatron_tpu_torch.ops.flash import flash_template as tft
from megatron_tpu_torch.ops.flash import masks as tmasks

ATOL = 1e-5


def _arr(r, *shape):
    return r.normal(size=shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=1e-5)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 1, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_visible_and_positions_match_jax(causal, window):
    for delta in (0, 3, 17):
        tq, tk = tmasks.prefill_positions(2, 1, 8, 8, delta)
        jq, jk = jmasks.prefill_positions(2, 1, 8, 8, delta)
        np.testing.assert_array_equal(tq, np.asarray(jq))
        np.testing.assert_array_equal(tk, np.asarray(jk))
        np.testing.assert_allclose(
            tmasks.visible(tq, tk, causal=causal, window=window)
            .astype(np.float32),
            np.asarray(jmasks.visible(jq, jk, causal=causal, window=window))
            .astype(np.float32), atol=1e-5)
    for kv_len in (1, 9, 30):
        tq, tk = tmasks.decode_positions(1, 8, kv_len, 2, 6)
        jq, jk = jmasks.decode_positions(1, 8, kv_len, 2, 6)
        np.testing.assert_array_equal(tq, np.asarray(jq))
        np.testing.assert_array_equal(tk, np.asarray(jk))


@pytest.mark.parametrize("window", [None, 1, 7, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_block_live_matches_jax(causal, window):
    for delta in (0, 5, 64):
        for qi in range(5):
            for ki in range(8):
                assert bool(tmasks.prefill_block_live(
                    qi, ki, 8, 8, causal=causal, window=window,
                    delta=delta)) == bool(jmasks.prefill_block_live(
                        qi, ki, 8, 8, causal=causal, window=window,
                        delta=delta))
    for kv_len in range(0, 50):
        for sq in (1, 3):
            for ki in range(7):
                assert bool(tmasks.decode_block_live(
                    ki, 8, kv_len, sq, window=window)) == bool(
                        jmasks.decode_block_live(ki, 8, kv_len, sq,
                                                 window=window))


@pytest.mark.parametrize("window", [None, 1, 7, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_live_tile_range_is_exactly_the_live_tiles(causal, window):
    """The CUDA kernels loop over [lo, hi) instead of skipping dead tiles
    inside a full grid: that range must hold exactly the tiles
    block_live accepts, on every edge (including negative positions)."""
    blk, n_k = 8, 9
    for q_lo in range(-20, 80, 3):
        for span in (0, 1, 7, 20):
            q_hi = q_lo + span
            lo, hi = tmasks.live_tile_range(blk, n_k, q_lo, q_hi,
                                            causal=causal, window=window)
            live = [ki for ki in range(n_k) if bool(jmasks.block_live(
                ki, blk, q_lo, q_hi, causal=causal, window=window))]
            assert list(range(lo, hi)) == live, (q_lo, q_hi)


@pytest.mark.parametrize("window", [None, 1, 7, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_live_q_tile_range_is_exactly_the_live_q_tiles(causal, window):
    """The dk/dv kernel loops its kv tile over q tiles [lo, hi): for a kv
    tile spanning a whole block, exactly the q tiles prefill_block_live
    accepts; for any key span, exactly the q tiles holding a row that
    sees one of its keys (every edge, offsets of both signs)."""
    bq, bk, n_q = 8, 8, 9
    for delta in (-13, 0, 5, 64):
        for ki in range(9):
            lo, hi = tmasks.live_q_tile_range(
                bq, n_q, ki * bk, ki * bk + bk - 1, causal=causal,
                window=window, delta=delta)
            live = [qi for qi in range(n_q) if bool(jmasks.prefill_block_live(
                qi, ki, bq, bk, causal=causal, window=window, delta=delta))]
            assert list(range(lo, hi)) == live, (delta, ki)
        for k_lo in range(-3, 75, 4):
            for span in (0, 3, 11):
                k_hi = k_lo + span
                lo, hi = tmasks.live_q_tile_range(
                    bq, n_q, k_lo, k_hi, causal=causal, window=window,
                    delta=delta)
                k_pos = np.arange(k_lo, k_hi + 1)[None, :]
                live = [qi for qi in range(n_q) if tmasks.visible(
                    np.arange(qi * bq, qi * bq + bq)[:, None] + delta, k_pos,
                    causal=causal, window=window).any()]
                assert list(range(lo, hi)) == live, (delta, k_lo, k_hi)


# ---------------------------------------------------------------------------
# prefill forward: flash_fwd_reference vs the _fwd_kernel (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,delta", [
    (True, None, 0), (True, 5, 0), (True, None, 6), (True, 4, 6),
    (False, None, 0), (False, 6, 0),
])
def test_flash_fwd_reference_matches_pallas_fwd(causal, window, delta):
    """o and lse against _fwd itself (the lse it emits, lane-padded to
    128, is column 0 here), including the ring offset delta."""
    r = np.random.default_rng(10)
    b, s, h, d = 2, 24, 2, 16
    q, k, v = _arr(r, b, s, h, d), _arr(r, b, s, h, d), _arr(r, b, s, h, d)
    jo, jlse = jft._fwd(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
        1.0 / np.sqrt(d), causal, window, 8, 8, delta=delta)
    to, tlse = tft.flash_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sliding_window=window, delta=delta)
    _close(to, np.asarray(jo).transpose(0, 2, 1, 3))
    # rows that see nothing: both give ~NEG_INF, compare relative
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("s,hq,hkv,window", [
    (24, 4, 2, None),    # GQA, S not a multiple of 64
    (24, 4, 1, 7),       # MQA + window
    (100, 2, 2, None),   # S ragged against the 64-row tile, block = 100
    (100, 4, 2, 33),
])
def test_flash_mha_matches_pallas_flash_mha(s, hq, hkv, window):
    r = np.random.default_rng(11)
    q, k, v = _arr(r, 2, s, hq, 16), _arr(r, 2, s, hkv, 16), \
        _arr(r, 2, s, hkv, 16)
    want = jft.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         sliding_window=window, block_q=s, block_k=s)
    got = tft.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), sliding_window=window)
    _close(got, want)


def test_flash_fwd_fully_masked_rows_emit_zero():
    """delta < 0 puts the first queries before every key: o = 0 and
    lse ~ NEG_INF, the clamp-at-1e-30 contract the kernel keeps."""
    r = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(_arr(r, 1, 8, 2, 16)) for _ in range(3))
    o, lse = tft.flash_fwd_reference(q, k, v, delta=-3)
    assert torch.all(o[:, :3] == 0)
    assert torch.all(lse[:, :, :3] < -1e29)
    assert torch.isfinite(o).all()


# ---------------------------------------------------------------------------
# decode: flash_decode_reference vs the dense _decode_kernel (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,window", [
    (4, 4, None), (4, 2, None), (4, 1, 40), (8, 2, 100),
])
def test_flash_decode_reference_matches_pallas_flash_decode(hq, hkv, window):
    """Ragged prefixes (1, a block edge, mid-block, the full cache) over a
    cache of two 128-position kernel blocks."""
    r = np.random.default_rng(13)
    b, s, d = 4, 256, 16
    q = _arr(r, b, 1, hq, d)
    k, v = _arr(r, b, s, hkv, d), _arr(r, b, s, hkv, d)
    lens = np.array([1, 128, 77, 256], np.int32)
    want = jft.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), sliding_window=window,
                            block_k=128)
    got = tft.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lens),
                           sliding_window=window)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 9])
def test_flash_decode_mq_matches_pallas(window):
    """Sq = 3 (the speculative verify form): query j sees
    k_pos < kv_len + j."""
    r = np.random.default_rng(14)
    b, sq, hq, hkv, s, d = 3, 3, 4, 2, 128, 16
    q = _arr(r, b, sq, hq, d)
    k, v = _arr(r, b, s, hkv, d), _arr(r, b, s, hkv, d)
    lens = np.array([1, 64, 126], np.int32)
    want = jft.flash_decode_mq(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lens),
                               sliding_window=window, block_k=128)
    got = tft.flash_decode_mq(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens),
                              sliding_window=window)
    _close(got, want)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_attention_routes_to_kernel_wrappers():
    """impl="pallas" goes to flash_mha for a full causal pass and to
    flash_decode with kv_lengths; both match the dense path. On the CPU
    the wrappers run their plain versions, which launch nothing."""
    r = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(_arr(r, 2, 10, 2, 16)) for _ in range(3))
    before = (tft.flash_fwd.launches, tft.flash_decode.launches)
    _close(attention(q, k, v, impl="pallas"),
           attention(q, k, v, impl="xla").numpy())
    lens = torch.tensor([3, 10], dtype=torch.int32)
    _close(attention(q[:, :1], k, v, impl="pallas", kv_lengths=lens),
           attention(q[:, :1], k, v, impl="xla", kv_lengths=lens).numpy())
    assert (tft.flash_fwd.launches, tft.flash_decode.launches) == before


def test_wrappers_refuse_devices_without_a_kernel():
    """Only the CPU takes the plain version: any other device launches
    the CUDA kernel or raises."""
    q = torch.empty(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tft.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        tft.flash_decode(q[:, :1], q, q,
                         torch.empty(1, dtype=torch.int32, device="meta"))
    lse = torch.empty(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tft.flash_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="unsupported device"):
        tft.flash_bwd_dkv(q, q, q, q, lse, lse)
