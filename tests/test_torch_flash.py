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

Also: masks.py against the JAX masks module, the kernels' loop bounds
(live_tile_range, live_q_tile_range) against the block predicates they
replace, the kernels' tile classification (tile_class) against the dense
mask, and the kernel build's hash over every csrc header.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

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


def _dense_tile(q0, bq, k0, bk, sq, skv, causal, window, delta):
    """The pairs of a tile that count: row < sq, column < skv, visible."""
    rows = np.arange(q0, q0 + bq)[:, None]
    cols = np.arange(k0, k0 + bk)[None, :]
    return (tmasks.visible(rows + delta, cols, causal=causal, window=window)
            & (rows < sq) & (cols < skv))


@pytest.mark.parametrize("direction", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("delta", [-5, 0, 30])
@pytest.mark.parametrize("window", [None, 1, 17, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_class_matches_the_dense_mask(causal, window, delta, direction):
    """tile_class is exact against the dense boolean mask: FULL iff every
    pair of the tile counts, DEAD iff none does, on ragged Sq/Skv, in the
    forward's direction (a 128-row q tile against each 128-column kv
    tile, the kv tiles of live_tile_range), the dq kernel's (a 128-row q
    tile against each 64-row kv tile of its live_tile_range) and the dk/dv
    kernel's (each 64-row q tile of live_q_tile_range against a 128-row kv
    tile). Tiles outside the kernels' loop bounds are DEAD."""
    bq, bk = {"fwd": (128, 128), "dq": (128, 64), "dkv": (64, 128)}[direction]
    kw = dict(causal=causal, window=window, delta=delta)
    seen = set()
    for sq, skv in ((1, 1), (127, 129), (300, 200), (257, 1000)):
        n_q, n_k = -(-sq // bq), -(-skv // bk)
        for qi in range(n_q):
            lo, hi = tmasks.live_tile_range(
                bk, n_k, qi * bq + delta, min(qi * bq + bq, sq) - 1 + delta,
                causal=causal, window=window)
            for ki in range(n_k):
                cls = tmasks.tile_class(qi * bq, bq, ki * bk, bk, sq, skv,
                                        **kw)
                m = _dense_tile(qi * bq, bq, ki * bk, bk, sq, skv, causal,
                                window, delta)
                want = (tmasks.TILE_FULL if m.all() else
                        tmasks.TILE_DEAD if not m.any() else tmasks.TILE_EDGE)
                assert cls == want, (sq, skv, qi, ki)
                seen.add(cls)
                if direction != "dkv" and not lo <= ki < hi:
                    assert cls == tmasks.TILE_DEAD, (sq, skv, qi, ki)
        if direction == "dkv":
            for ki in range(n_k):
                lo, hi = tmasks.live_q_tile_range(
                    bq, n_q, ki * bk, min(ki * bk + bk, skv) - 1, **kw)
                for qi in set(range(n_q)) - set(range(lo, hi)):
                    assert tmasks.tile_class(
                        qi * bq, bq, ki * bk, bk, sq, skv, **kw) == \
                        tmasks.TILE_DEAD, (sq, skv, qi, ki)
    assert tmasks.TILE_EDGE in seen


def test_tile_class_full_tiles_are_the_bulk_of_a_causal_pass():
    """What the kernels save: at S 4096 causal, 496 of the forward's 528
    live 128 x 128 tiles are FULL (only the 32 diagonal tiles are
    masked); with a window of 256 each q tile sees at most 3 kv tiles,
    and the window's lower-edge tile is masked beside the diagonal."""
    def count(window):
        n = 4096 // 128
        cls = [tmasks.tile_class(qi * 128, 128, ki * 128, 128, 4096, 4096,
                                 causal=True, window=window)
               for qi in range(n) for ki in range(n)]
        return cls.count(tmasks.TILE_FULL), cls.count(tmasks.TILE_EDGE)
    assert count(None) == (496, 32)
    assert count(256) == (31, 32 + 30)


@pytest.mark.parametrize("window", [None, 1, 7, 256])
def test_decode_split_schedule_covers_exactly_the_live_tiles(window):
    """The split-K decode kernel's schedule (masks.cuh mirrors it): for
    every kv_len of a 10-tile cache, Sq 1 and 5 and several split sizes,
    the splits' tile ranges are disjoint, their union is exactly the live
    tiles (the tiles the JAX kernel's decode_block_live accepts), the
    first decode_live_splits of them hold a tile and every split past
    them is empty; the grid's splits cover the whole cache."""
    blk, n_tiles = 64, 10
    s_len = blk * n_tiles
    for split_tiles in (1, 2, 3, 4, 10):
        n_split = tmasks.decode_splits(n_tiles, split_tiles)
        assert n_split * split_tiles >= n_tiles
        for sq in (1, 5):
            for kv_len in range(1, s_len - sq + 2):
                lo, hi = tmasks.live_tile_range(
                    blk, n_tiles, kv_len - 1, kv_len + sq - 2, causal=True,
                    window=window)
                live = [ki for ki in range(n_tiles) if bool(
                    jmasks.decode_block_live(ki, blk, kv_len, sq,
                                             window=window))]
                assert list(range(lo, hi)) == live
                n_live = tmasks.decode_live_splits(lo, hi, split_tiles)
                assert 1 <= n_live <= n_split
                seen = []
                for split in range(n_split):
                    first, last = tmasks.decode_split_range(
                        split, split_tiles, lo, hi)
                    tiles = list(range(first, last))
                    assert len(tiles) <= split_tiles
                    assert bool(tiles) == (split < n_live) or not live
                    seen += tiles
                assert seen == live, (split_tiles, sq, kv_len)


def test_decode_split_tiles_spreads_the_slots_over_the_card():
    """decode_split_tiles depends only on the host's knowledge: the
    cache's tile count, B * Hkv and the SM count. More (slot, head) pairs
    mean longer splits; a split is never shorter than 2 tiles (unless
    the cache is shorter) nor longer than the cache."""
    for n_tiles in (1, 2, 5, 32, 512):
        prev = 0
        for pairs in (1, 8, 64, 256, 4096):
            t = tmasks.decode_split_tiles(n_tiles, pairs, 132)
            assert min(2, n_tiles) <= t <= n_tiles
            assert t >= prev
            prev = t
    # the serving shape: 8 slots x 32 kv heads over 2048 positions
    assert tmasks.decode_split_tiles(32, 256, 132) == 11
    assert tft.decode_plan(2048, 8, 32, 1, 132)["grid"] == (32, 8, 3)


# ---------------------------------------------------------------------------
# kernel build: the library hash covers every header
# ---------------------------------------------------------------------------


def test_build_hashes_every_header(tmp_path, monkeypatch):
    """lib_path hashes each kernel's source and every *.cuh in csrc/, so
    an edit to any header (masks.cuh, sm90.cuh, ...) builds a new
    library instead of loading a stale one."""
    from megatron_tpu_torch.ops.flash import build
    assert build.headers() == sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert {"masks.cuh", "sm90.cuh"} <= set(build.headers())
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.lib_path(name) for name in build.KERNELS}
    assert before == {name: build.lib_path(name) for name in build.KERNELS}
    for header in build.headers():
        (csrc / header).write_bytes((csrc / header).read_bytes() + b"\n")
        after = {name: build.lib_path(name) for name in build.KERNELS}
        assert all(after[n] != before[n] for n in build.KERNELS), header
        before = after
    (csrc / "extra.cuh").write_bytes(b"#pragma once\n")
    assert "extra.cuh" in build.headers()
    assert all(build.lib_path(n) != before[n] for n in build.KERNELS)


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


def _split_case(r, b, sq, hq, hkv, s, d=16):
    q = _arr(r, b, sq, hq, d)
    return q, _arr(r, b, s, hkv, d), _arr(r, b, s, hkv, d)


@pytest.mark.parametrize("split_tiles", [1, 2, 3])
@pytest.mark.parametrize("sq,hq,hkv,window", [
    (1, 4, 4, None), (1, 4, 2, 40), (5, 4, 2, None), (5, 4, 1, 1),
    (3, 2, 2, 70),
])
def test_decode_split_merge_matches_the_plain_decode(split_tiles, sq, hq,
                                                     hkv, window):
    """The split-K kernel's arithmetic in plain fp32 (per-split partials
    over fixed runs of 64-position tiles, merged in split order) equals
    flash_decode_reference at 1e-5. The lengths put split edges inside a
    query's reach (64, 65, 128), give splits where a row sees nothing
    (Sq 5 at kv_len 64; window 1), and kv_len 0 gives a row that sees
    nothing at all (o = 0)."""
    r = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(a) for a in _split_case(r, 6, sq, hq, hkv,
                                                         256))
    lens = torch.tensor([0, 1, 64, 65, 128, 256 - sq + 1], dtype=torch.int32)
    got = tft.flash_decode_split_reference(q, k, v, lens, window,
                                           split_tiles=split_tiles)
    want = tft.flash_decode_reference(q, k, v, lens, window)
    _close(got, want.numpy())
    assert torch.all(got[0, 0] == 0)


@pytest.mark.parametrize("split_tiles", [1, 3])
@pytest.mark.parametrize("sq,hq,hkv,window", [
    (1, 4, 2, None), (1, 8, 2, 100), (4, 4, 1, None), (5, 4, 2, 9),
])
def test_decode_split_merge_matches_pallas_decode(split_tiles, sq, hq, hkv,
                                                  window):
    """The same split-and-merge against the JAX package's decode kernel
    in interpret mode: flash_decode (Sq 1) or flash_decode_mq (Sq > 1)
    on a 256-position cache."""
    r = np.random.default_rng(17)
    q, k, v = _split_case(r, 4, sq, hq, hkv, 256)
    lens = np.array([1, 64, 129, 256 - sq + 1], np.int32)
    fn = jft.flash_decode if sq == 1 else jft.flash_decode_mq
    want = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              jnp.asarray(lens), sliding_window=window, block_k=128)
    got = tft.flash_decode_split_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), window, split_tiles=split_tiles)
    _close(got, want)


@pytest.mark.parametrize("sq,window", [(1, None), (3, 20)])
def test_decode_split_merge_matches_pallas_paged_decode(sq, window):
    """Through a page table: the split-and-merge over each row's gathered
    pages against the JAX package's paged_flash_decode (Sq 1) /
    paged_flash_decode_mq in interpret mode, pages scattered, two rows
    sharing their first pages, unused entries on the scratch page 0."""
    r = np.random.default_rng(18)
    b, hq, hkv, d, ps, max_pages = 3, 4, 2, 16, 16, 12
    n_pages = 1 + b * max_pages
    q = _arr(r, b, sq, hq, d)
    kp, vp = _arr(r, n_pages, ps, hkv, d), _arr(r, n_pages, ps, hkv, d)
    table = (r.permutation(n_pages - 1) + 1)[:b * max_pages].reshape(
        b, max_pages).astype(np.int32)
    table[1, :3] = table[0, :3]
    lens = np.array([5, 70, max_pages * ps - sq + 1], np.int32)
    for i, n in enumerate(lens):
        table[i, -(-(n + sq - 1) // ps):] = 0
    fn = jft.paged_flash_decode if sq == 1 else jft.paged_flash_decode_mq
    want = fn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
              jnp.asarray(table), jnp.asarray(lens), sliding_window=window)
    tk, tv = (tft._gather_pages(torch.from_numpy(a), torch.from_numpy(table))
              for a in (kp, vp))
    got = tft.flash_decode_split_reference(
        torch.from_numpy(q), tk, tv, torch.from_numpy(lens), window,
        split_tiles=1)
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
