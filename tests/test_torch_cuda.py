"""Card-only checks of the port's CUDA kernels (marker `cuda`).

The kernels have no CPU mode, so every test here skips without a CUDA
device. They import torch and megatron_tpu_torch only; tests/conftest.py
imports the JAX package, which a machine with the card need not have, so
on the card run them without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each forward kernel is held against its plain version on the same bf16
inputs (computed in fp32) with |kernel - plain| <= 2e-2 + 2e-2 * |plain|,
at small shapes that hit the ragged edges: sequence lengths around the
kernels' 64- and 128-row tiles, GQA, sliding windows, the q-vs-k offset
with Sq != Skv, q/k/v as strided views of a fused buffer, and ragged
per-slot prefixes; the paged decode kernel also at page
sizes 8, 16 and 64 with scattered, shared and scratch pages. The
backward kernels (dq, dk/dv) are held
against the plain fp32 backward of the same bf16 inputs and the same
o/lse, relative to each tensor's largest plain magnitude M:
|kernel - plain| <= 2e-3 * M + 2e-2 * |plain| (the tolerance of the JAX
package's own backward test, tests/test_pallas_attention.py; the kernels
round p and ds to bf16 for the tensor cores). A CUDA TrainState saves
and loads bitwise, an async save overlapping a train step (which updates
the device tensors in place) keeps the state from before the step, and
load_params_only places the params on the card.

The engines' captured decode step: the CUDA graph gives the eager
engine's tokens and logprobs exactly (plain, n-gram and draft-model
speculation, dense and paged) and its launch counters count every replay
by query length; speculative greedy tokens equal the plain ones or part
at a bf16 near-tie (teacher-forced, >= 99% of positions); a failed step
recaptures; a capture that fails raises; the decode kernel under capture
refuses a stream it never ran on and then replays bit for bit; a verify
past one block's 64 query rows (G 16, k 4: 80 rows) serves the plain
tokens or parts at a near-tie. The decode kernels take 71, 72 and 355
query rows per kv head (Falcon-7B's decode and verify, G 8 at k 8), and
tiny Falcon-like (parallel attention, multi-query, D 64) and GPT-2-like
(absolute positions, biases) engines replay their eager tokens exactly.

Serving control under the graph: a weight reload copies new weights into
the captured tensors between replays (no recapture) and the engine then
serves what an engine built on the new weights serves; an int8 KV tick
replays the eager int8 tick bit for bit; a deadline that expires in
mid-decode clears its slot so the next replay does not decode the row.

Tensor parallelism's checkpoint and serving shapes: a CUDA TrainState
cut into two tp2 ranks (gloo processes sharing the card) saves into the
sharded layout through each rank's AsyncCheckpointSaver (pinned
buffers), and loads back bitwise at world size 1 and at tp2, on the
card; B1 at S 2047 and B4 at B8 Sq 1, with a tp2 serving rank's 16 query
and 16 kv heads of D 128, match their plain versions, as do B1-B4 at a
Falcon-40B tp2 rank's 64 query over 4 kv heads of D 64 and B5 at the
paged engine's tp2 rank (16 heads, 16-token pages).

Multi-host coordination on the card's torch: the store backend over a
two-process gloo group's own TCPStore (check, get, set; whether the
store has list_keys and multi_get is reported, not relied on), and the
sideband watchdog exiting 76 from a process whose main thread is blocked
inside a gloo all-reduce of CUDA tensors (its peer alive but silent:
heartbeats stopped, never entering the collective), within the peer
death timeout plus a slack.

Context parallelism: the one-process emulated ring (every virtual
rank's schedule, ops/ring_attention.py) at cp 2 and 4 runs each live
stripe pair on B1/B2/B3 and matches the same ring on the plain versions,
values and gradients (zig-zag causal, a window of 4096, GQA 32/8, and
the contiguous ring at S % 2cp != 0). fp8_matmul's torch._scaled_mm
route matches its plain fp32 products at a small and at a Llama-2-7B
product shape.

Dropout and migration on the card: the default mask source (a Philox
generator on the card, seeded from the key path's hash) keeps 1 - rate
of the positions within 4 sigma and draws the same mask for the same
path; a request exported mid-decode and imported into a captured
engine (dense and paged: the KV written in place into the tensors the
graph reads), then decoded by graph replay, emits the tokens of an
uninterrupted captured engine, greedy and sampled.
"""

import dataclasses
import os

import pytest
import torch

from megatron_tpu_torch.config import OptimizerConfig, TrainingConfig
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import empty_params, init_params
from megatron_tpu_torch.ops.flash import flash_template as ft
from megatron_tpu_torch.training import checkpointing
from megatron_tpu_torch.training.optimizer import init_train_state, leaf_paths
from megatron_tpu_torch.training.train_step import make_train_step

pytestmark = pytest.mark.cuda
ATOL = RTOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _assert_close(got, want):
    err = (got.float() - want.float()).abs()
    assert bool((err <= ATOL + RTOL * want.float().abs()).all()), \
        float(err.max())


@pytest.mark.parametrize("s,hq,hkv,d,window,delta", [
    (1, 4, 4, 128, None, 0), (63, 4, 2, 128, None, 0),
    (130, 8, 2, 64, None, 0), (130, 4, 1, 128, 17, 0),
    (100, 4, 4, 128, None, 30), (70, 2, 2, 64, 9, -5),
    # the 128-row tile's edges
    (127, 4, 4, 128, None, 0), (128, 4, 2, 64, None, 0),
    (129, 4, 4, 128, 17, 0), (255, 8, 2, 128, None, 0),
])
def test_flash_fwd_kernel_matches_plain(gen, s, hq, hkv, d, window, delta):
    q = _randn(gen, 2, s, hq, d)
    k, v = _randn(gen, 2, s, hkv, d), _randn(gen, 2, s, hkv, d)
    before = ft.flash_fwd.launches
    o, lse = ft.flash_fwd(q, k, v, sliding_window=window, delta=delta)
    torch.cuda.synchronize()
    assert ft.flash_fwd.launches == before + 1
    o_ref, lse_ref = ft.flash_fwd_reference(
        q.float(), k.float(), v.float(), sliding_window=window, delta=delta)
    _assert_close(o, o_ref)
    _assert_close(lse, lse_ref)


@pytest.mark.parametrize("sq,hq,hkv,window", [
    (1, 4, 4, None), (1, 8, 2, None), (3, 8, 2, None), (1, 4, 4, 50),
    (4, 4, 1, 33),
])
def test_flash_decode_kernel_matches_plain(gen, sq, hq, hkv, window):
    S = 200
    q = _randn(gen, 4, sq, hq, 128)
    k, v = _randn(gen, 4, S, hkv, 128), _randn(gen, 4, S, hkv, 128)
    lens = torch.tensor([1, 64, 130, S - sq + 1], dtype=torch.int32,
                        device="cuda")
    before = ft.flash_decode.launches
    o = ft.flash_decode(q, k, v, lens, sliding_window=window)
    torch.cuda.synchronize()
    assert ft.flash_decode.launches == before + 1
    _assert_close(o, ft.flash_decode_reference(q.float(), k.float(),
                                               v.float(), lens, window))


def test_flash_decode_reads_a_strided_cache(gen):
    """The engine hands the kernel per-layer views of the stacked cache."""
    cache = _randn(gen, 3, 4, 256, 2, 128)       # [L, B, S, Hkv, D]
    q = _randn(gen, 4, 1, 4, 128)
    lens = torch.tensor([5, 100, 256, 1], dtype=torch.int32, device="cuda")
    k, v = cache[1], cache[2]
    _assert_close(ft.flash_decode(q, k, v, lens),
                  ft.flash_decode_reference(q.float(), k.float(),
                                            v.float(), lens))


@pytest.mark.parametrize("ps,sq,hq,hkv,window", [
    (8, 1, 4, 4, None), (16, 3, 8, 2, 40), (64, 1, 4, 2, None),
])
def test_paged_flash_decode_kernel_matches_plain(gen, ps, sq, hq, hkv,
                                                 window):
    """Pages out of order, two rows sharing their first pages, entries
    past a row's length and behind its window on the scratch page."""
    B, max_pages = 4, 256 // ps
    n_pages = 1 + B * max_pages
    q = _randn(gen, B, sq, hq, 128)
    kp, vp = (_randn(gen, n_pages, ps, hkv, 128) for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).view(B, max_pages).to(torch.int32)
    table[1, :2] = table[0, :2]
    lens_list = [1, 70, 130, 256 - sq + 1]
    for b, n in enumerate(lens_list):
        table[b, -(-(n + sq - 1) // ps):] = 0
        if window is not None:
            table[b, :max(0, n - 1 - window) // ps] = 0
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    fn = ft.paged_flash_decode if sq == 1 else ft.paged_flash_decode_mq
    given = table.clone()
    if window is not None:
        # an entry outside the pool, in a tile the kernel loads (the last
        # page released behind row 3's window): read as the scratch
        # page, not out of bounds
        given[3, (lens_list[3] - 1 - window) // ps - 1] = n_pages + 7
    before = ft.paged_flash_decode.launches
    o = fn(q, kp, vp, given, lens, sliding_window=window)
    torch.cuda.synchronize()
    assert ft.paged_flash_decode.launches == before + 1
    _assert_close(o, ft.paged_flash_decode_reference(
        q.float(), kp.float(), vp.float(), table, lens, window))
    with pytest.raises(ValueError, match="int32"):
        fn(q, kp, vp, table.long(), lens)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sq,hq,hkv,d,window", [
    (1, 71, 1, 64, None), (5, 71, 1, 64, None), (9, 64, 8, 128, None),
    (2, 48, 1, 64, 100),
])
def test_decode_kernels_take_more_rows_than_one_block(gen, paged, sq, hq,
                                                      hkv, d, window):
    """Sq * G past one block's 64 query rows (71 and 355: Falcon-7B's
    decode and its k-4 verify; 72: G 8 at k 8; 96 with a window): row
    tiles of 64, each with its own partials and ticket."""
    B, S, ps = 4, 512, 16
    assert ft.decode_plan(S, B, hkv, sq * hq // hkv)["row_tiles"] > 1
    q = _randn(gen, B, sq, hq, d)
    lens_list = [1, 65, 300, S - sq + 1]
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    if paged:
        n_pages = 1 + B * (S // ps)
        k, v = (_randn(gen, n_pages, ps, hkv, d) for _ in range(2))
        table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                 + 1).view(B, S // ps).to(torch.int32).contiguous()
        fn = ft.paged_flash_decode if sq == 1 else ft.paged_flash_decode_mq
        o = fn(q, k, v, table, lens, sliding_window=window)
        want = ft.paged_flash_decode_reference(q.float(), k.float(),
                                               v.float(), table, lens,
                                               window)
    else:
        k, v = _randn(gen, B, S, hkv, d), _randn(gen, B, S, hkv, d)
        o = ft.flash_decode(q, k, v, lens, sliding_window=window)
        want = ft.flash_decode_reference(q.float(), k.float(), v.float(),
                                         lens, window)
    torch.cuda.synchronize()
    _assert_close(o, want)


def _split_edge_lengths(plan, sq, window, s_len):
    """kv_lengths at the split edges (split size - 1, + 0, + 1 positions,
    whose deepest query reaches one past, to, or into the next split) and
    at a window's lower edge on a tile boundary."""
    edge = plan["split_tiles"] * ft.DECODE_BLOCK
    lens = [edge - sq, edge - sq + 1, edge - sq + 2]
    lens.append((window or 0) + 2 * ft.DECODE_BLOCK)
    lens.append((window or 0) + 2 * ft.DECODE_BLOCK + 1)
    lens.append(s_len - sq + 1)
    return [max(1, min(n, s_len - sq + 1)) for n in lens]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sq,hq,hkv,window", [
    (1, 8, 8, None), (1, 8, 2, 64), (5, 8, 2, None), (5, 16, 4, 100),
])
def test_decode_kernels_at_split_and_window_edges(gen, paged, sq, hq, hkv,
                                                  window):
    """The split-K decode (dense and paged) with kv_lengths on the edges
    of its own splits and of the window: every split's partial and the
    in-kernel merge against the plain version."""
    B, S, ps = 6, 1024, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ft.decode_plan(S, B, hkv, sq * (hq // hkv), sms)
    lens_list = _split_edge_lengths(plan, sq, window, S)
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    q = _randn(gen, B, sq, hq, 128)
    if paged:
        n_pages = 1 + B * (S // ps)
        kp, vp = (_randn(gen, n_pages, ps, hkv, 128) for _ in range(2))
        table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                 + 1).view(B, S // ps).to(torch.int32)
        fn = ft.paged_flash_decode if sq == 1 else ft.paged_flash_decode_mq
        before = ft.paged_flash_decode.launches
        o = fn(q, kp, vp, table, lens, sliding_window=window)
        torch.cuda.synchronize()
        assert ft.paged_flash_decode.launches == before + 1
        want = ft.paged_flash_decode_reference(q.float(), kp.float(),
                                               vp.float(), table, lens,
                                               window)
    else:
        k, v = _randn(gen, B, S, hkv, 128), _randn(gen, B, S, hkv, 128)
        before = ft.flash_decode.launches
        o = ft.flash_decode(q, k, v, lens, sliding_window=window)
        torch.cuda.synchronize()
        assert ft.flash_decode.launches == before + 1
        want = ft.flash_decode_reference(q.float(), k.float(), v.float(),
                                         lens, window)
    _assert_close(o, want)
    # the kernel left every ticket at zero: a second call agrees
    again = (fn(q, kp, vp, table, lens, sliding_window=window) if paged
             else ft.flash_decode(q, k, v, lens, sliding_window=window))
    torch.cuda.synchronize()
    assert torch.equal(again, o)


def test_decode_launches_on_two_streams_keep_their_own_tickets(gen):
    """Decode launches in flight at once on two streams of one card each
    merge their own splits: every result is bit-equal to the same call on
    the default stream."""
    B, S, hkv = 8, 2048, 8
    q = _randn(gen, B, 1, 32, 128)
    k, v = _randn(gen, B, S, hkv, 128), _randn(gen, B, S, hkv, 128)
    lens = torch.tensor([1, 63, 64, 2047, 2048, 500, 1000, 1500],
                        dtype=torch.int32, device="cuda")
    want = ft.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(20):
        for s, out in zip(streams, outs):
            with torch.cuda.stream(s):
                out.append(ft.flash_decode(q, k, v, lens))
    torch.cuda.synchronize()
    for out in outs:
        assert all(torch.equal(o, want) for o in out)


def test_paged_engine_decodes_through_the_paged_kernel(gen):
    """A 2-layer bf16 model served by the paged engine on the card: each
    decode tick launches the paged kernel once per layer, chunks launch
    no kernel, and the engine's greedy logprobs stay finite."""
    import numpy as np

    from megatron_tpu_torch.inference.engine import Request
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    cfg = presets.tiny(hidden_size=512, num_attention_heads=4,
                       num_kv_heads=2, vocab_size=128, params_dtype="bfloat16",
                       attention_impl="pallas")
    eng = PagedInferenceEngine(cfg, init_params(cfg, 0), num_slots=3,
                               max_seq_len=128, page_size=8, prefill_chunk=16,
                               vocab_size=128, metrics=MetricsRegistry())
    counts = ("flash_fwd", "flash_decode", "paged_flash_decode")
    before = [getattr(ft, n).launches for n in counts]
    reqs = [eng.submit(Request(prompt=np.arange(1, n + 1, dtype=np.int32),
                               max_new_tokens=9)) for n in (3, 40, 70)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    assert all(r.error is None and len(r.generated) == 9 for r in reqs)
    assert all(np.isfinite(r.logprobs).all() for r in reqs)
    ran = [getattr(ft, n).launches - b for n, b in zip(counts, before)]
    assert ran == [0, 0, cfg.num_layers * eng.stats["ticks"]]


def _assert_close_rel(got, want, name):
    want = want.float()
    m = float(want.abs().max())
    err = (got.float() - want).abs()
    assert bool((err <= 2e-3 * m + 2e-2 * want.abs()).all()), \
        (name, float(err.max()), m)


@pytest.mark.parametrize("s,hq,hkv,d,causal,window,delta", [
    (3, 4, 4, 128, True, None, 0), (63, 4, 2, 128, True, None, 0),
    (130, 8, 2, 64, True, None, 0), (130, 4, 1, 128, True, 17, 0),
    (100, 4, 4, 128, True, None, 30), (70, 2, 2, 64, True, 9, -5),
    (96, 4, 2, 128, False, None, 0), (200, 4, 4, 64, False, 33, 0),
    # the 128-row kv tile's and the 64-row q tile's edges
    (127, 4, 4, 128, True, None, 0), (128, 4, 2, 64, True, None, 0),
    (129, 4, 4, 128, False, None, 0), (255, 8, 2, 128, True, 33, 0),
])
def test_flash_bwd_kernels_match_plain(gen, s, hq, hkv, d, causal, window,
                                       delta):
    # (S = 1 is left out: there dq is 0 in exact arithmetic and both sides
    # hold only rounding noise, which a relative tolerance cannot judge)
    q = _randn(gen, 2, s, hq, d)
    k, v = _randn(gen, 2, s, hkv, d), _randn(gen, 2, s, hkv, d)
    do = _randn(gen, 2, s, hq, d)
    o, lse = ft.flash_fwd(q, k, v, causal=causal, sliding_window=window,
                          delta=delta)
    before = (ft.flash_bwd_dq.launches, ft.flash_bwd_dkv.launches)
    got = ft.flash_bwd(q, k, v, o, lse, do, causal=causal,
                       sliding_window=window, delta=delta)
    torch.cuda.synchronize()
    assert (ft.flash_bwd_dq.launches, ft.flash_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want = ft.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                  do, causal=causal, sliding_window=window,
                                  delta=delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _assert_close_rel(a, b, name)


@pytest.mark.parametrize("hkv,window", [(8, None), (2, 256)])
def test_flash_bwd_dq_at_a_second_draw(hkv, window):
    """dq at S 1000 from a second seed (chip_smoke.py's second draw of
    phase 2b), under the backward gate with room to spare: the kernel
    splits ds into bf16 hi + lo parts, so one bf16 rounding of ds no
    longer decides the result (the one-rounding form passed the first
    draw and failed the second on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1234 + 13)
    q, do = _randn(g, 1, 1000, 8, 128), _randn(g, 1, 1000, 8, 128)
    k, v = _randn(g, 1, 1000, hkv, 128), _randn(g, 1, 1000, hkv, 128)
    o, lse = ft.flash_fwd(q, k, v, sliding_window=window)
    dsum = ft._bwd_dsum(o, do)
    dq = ft.flash_bwd_dq(q, k, v, do, lse, dsum, sliding_window=window)
    torch.cuda.synchronize()
    want = ft.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                  do, sliding_window=window)[0].float()
    allowed = 2e-3 * float(want.abs().max()) + 2e-2 * want.abs()
    margin = float(((dq.float() - want).abs() / allowed).max())
    assert margin <= 0.5, margin


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_take_a_ring_stripe_and_a_fused_qkv_buffer(gen,
                                                                causal):
    """Sq != Skv with a runtime offset (a ring stripe: 200 queries at
    positions 500..699 against 700 keys), q/k/v as strided views of one
    [B, S, 3, H, D] buffer (the TMA descriptors' strides), GQA 4: the
    forward and the dk/dv and dq kernels against their plain versions."""
    fused = _randn(gen, 2, 700, 3, 8, 128)
    q = fused[:, 500:, 0]
    k, v = fused[:, :, 1, :2], fused[:, :, 2, :2]
    do = _randn(gen, 2, 200, 8, 128)
    kw = dict(causal=causal, sliding_window=None, delta=500)
    o, lse = ft.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = ft.flash_fwd_reference(q.float(), k.float(), v.float(),
                                            **kw)
    _assert_close(o, o_ref)
    _assert_close(lse, lse_ref)
    got = ft.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = ft.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                  do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_close_rel(a, b, name)


def test_flash_mha_autograd_runs_the_backward_kernels(gen):
    """flash_mha on CUDA tensors that require a gradient: one forward and
    one dq + one dk/dv launch, gradients equal to the plain backward."""
    q = _randn(gen, 1, 150, 4, 128).requires_grad_()
    k = _randn(gen, 1, 150, 2, 128).requires_grad_()
    v = _randn(gen, 1, 150, 2, 128).requires_grad_()
    do = _randn(gen, 1, 150, 4, 128)
    before = (ft.flash_fwd.launches, ft.flash_bwd_dq.launches,
              ft.flash_bwd_dkv.launches)
    o = ft.flash_mha(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert (ft.flash_fwd.launches, ft.flash_bwd_dq.launches,
            ft.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    with torch.no_grad():
        o2, lse = ft.flash_fwd(q, k, v)
    want = ft.flash_bwd_reference(q.detach().float(), k.detach().float(),
                                  v.detach().float(), o2, lse, do)
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        _assert_close_rel(t.grad, w, name)


def test_kernels_refuse_what_they_do_not_cover(gen):
    q = _randn(gen, 1, 8, 2, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        ft.flash_fwd(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head_dim"):
        x = _randn(gen, 1, 8, 2, 96)
        ft.flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="backward"):
        ft.flash_fwd(q.clone().requires_grad_(), q, q)
    with pytest.raises(ValueError, match="int32"):
        ft.flash_decode(q[:, :1], q, q, torch.tensor([3], device="cuda"))


def test_lm_forward_kernel_route_matches_dense_route(gen):
    """A 2-layer bf16 model: the kernel route and the dense route give
    logits within bf16 noise of each other, with and without caches."""
    from megatron_tpu_torch.inference.generation import _init_caches
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.models.params import init_params

    cfg = presets.tiny(hidden_size=512, num_attention_heads=4,
                       num_kv_heads=2, vocab_size=128, params_dtype="bfloat16",
                       attention_impl="pallas")
    dense = dataclasses.replace(cfg, attention_impl="xla")
    params = init_params(cfg, 0)
    toks = torch.randint(0, 128, (2, 70), generator=gen, device="cuda")
    with torch.no_grad():
        _assert_close(lm_forward(cfg, params, toks),
                      lm_forward(dense, params, toks).float())
        ck, cd = _init_caches(cfg, 2, 128), _init_caches(cfg, 2, 128)
        lk, _ = lm_forward(cfg, params, toks, kv_caches=ck, cache_index=0)
        ld, _ = lm_forward(dense, params, toks, kv_caches=cd, cache_index=0)
        _assert_close(lk, ld.float())
        depth = torch.tensor([70, 40], device="cuda")
        step = toks[:, :1]
        lk, _ = lm_forward(cfg, params, step, kv_caches=ck, cache_index=depth)
        ld, _ = lm_forward(dense, params, step, kv_caches=cd,
                           cache_index=depth)
        _assert_close(lk, ld.float())


def test_train_step_runs_the_attention_kernels(gen):
    """make_train_step on a 2-layer bf16 model (D 128, GQA 4/2, ragged S
    200), 2 microbatches, selective recompute: every step launches
    flash_fwd twice per layer and microbatch (forward + recompute) and
    the dq and dk/dv kernels once, and its losses track the same steps
    taken through the dense attention with autograd within 3e-2 (bf16
    weights; both runs round differently, and three Adam steps carry
    the differences along)."""
    from megatron_tpu_torch.config import OptimizerConfig, TrainingConfig
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.training.optimizer import (init_train_state,
                                                       leaf_paths)
    from megatron_tpu_torch.training.train_step import make_train_step

    cfg = presets.tiny(hidden_size=512, num_attention_heads=4,
                       num_kv_heads=2, vocab_size=128, seq_length=200,
                       params_dtype="bfloat16", attention_impl="pallas")
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    tc = TrainingConfig(micro_batch_size=1, global_batch_size=2,
                        train_iters=3, recompute_granularity="selective")
    toks = torch.randint(0, 128, (3, 2, 201), generator=gen, device="cuda")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    losses, launched = {}, {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        params = init_params(c, 0)
        for _, p in leaf_paths(params):
            p.requires_grad_(True)
        state = init_train_state(opt, params)
        step = make_train_step(c, opt, tc, 2)
        before = [getattr(ft, n).launches for n in names]
        losses[impl] = []
        for i in range(3):
            state, m = step(state, {"tokens": toks[i, :, :-1],
                                    "labels": toks[i, :, 1:]})
            assert float(m["skipped"]) == 0.0
            losses[impl].append(float(m["loss"]))
        torch.cuda.synchronize()
        launched[impl] = [getattr(ft, n).launches - b
                          for n, b in zip(names, before)]
    assert launched["pallas"] == [2 * 2 * 2 * 3, 2 * 2 * 3, 2 * 2 * 3]
    assert launched["xla"] == [0, 0, 0]
    for a, b in zip(losses["pallas"], losses["xla"]):
        assert abs(a - b) <= 3e-2, (losses["pallas"], losses["xla"])


# ---------------------------------------------------------------------------
# checkpoints of a CUDA TrainState (training/checkpointing.py)
# ---------------------------------------------------------------------------


def _cuda_state(gen, seed):
    cfg = presets.tiny(hidden_size=256, vocab_size=128, seq_length=64,
                       params_dtype="bfloat16", attention_impl="pallas")
    params = init_params(cfg, seed)
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    state = init_train_state(OptimizerConfig(lr=1e-3), params)
    with torch.no_grad():
        for tree in (state.mu, state.nu):
            for _, t in leaf_paths(tree):
                t.normal_(generator=gen)
        state.step.fill_(seed + 3)
    return cfg, state


def _host_leaves(state):
    return {(f, n): t.detach().cpu().clone()
            for f in ("params", "master", "mu", "nu")
            for n, t in leaf_paths(getattr(state, f))}


def test_cuda_train_state_save_load_is_bitwise(gen, tmp_path):
    _, state = _cuda_state(gen, 0)
    checkpointing.save_checkpoint(str(tmp_path), state, 5, 50)
    _, template = _cuda_state(gen, 1)
    restored, it, consumed = checkpointing.load_checkpoint(str(tmp_path),
                                                           template)
    assert (it, consumed) == (5, 50)
    for (f, n), t in _host_leaves(state).items():
        got = dict(leaf_paths(getattr(restored, f)))[n]
        assert got.is_cuda and torch.equal(got.cpu(), t), (f, n)
    assert int(restored.step) == int(state.step)


def test_async_save_overlapping_a_step_keeps_the_pre_step_state(gen,
                                                                tmp_path):
    """save() returns once the state is on the host; the train step that
    follows updates the same device tensors in place while the files are
    written, and the checkpoint holds the state from before the step."""
    cfg, state = _cuda_state(gen, 0)
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    step = make_train_step(cfg, opt, TrainingConfig(
        micro_batch_size=2, global_batch_size=2, train_iters=1), 1)
    toks = torch.randint(0, 128, (2, 65), generator=gen, device="cuda")
    before = _host_leaves(state)
    saver = checkpointing.AsyncCheckpointSaver(str(tmp_path))
    saver.save(state, 1, 2)
    state, _ = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    saver.close()
    assert not torch.equal(state.params["embed"]["tokens"].cpu(),
                           before[("params", "embed/tokens")])
    for f in ("params", "master", "mu", "nu"):
        saved = torch.load(os.path.join(
            checkpointing.checkpoint_dir(str(tmp_path), 1), "state",
            f + ".pt"), weights_only=True)
        for n, t in saved.items():
            assert torch.equal(t, before[(f, n)]), (f, n)


def test_load_params_only_places_params_on_the_card(gen, tmp_path):
    cfg, state = _cuda_state(gen, 0)
    checkpointing.save_checkpoint(str(tmp_path), state, 3)
    params = checkpointing.load_params_only(
        str(tmp_path), empty_params(cfg, device="cuda"))
    for (n, p), (_, m) in zip(leaf_paths(params), leaf_paths(state.master)):
        assert p.is_cuda and p.dtype == torch.bfloat16, n
        assert torch.equal(p, m.to(torch.bfloat16)), n


# ---------------------------------------------------------------------------
# the captured decode step and speculative decoding on the card
# ---------------------------------------------------------------------------


def _serving_model():
    """A 2-layer bf16 model with the kernels' head dim 128 and GQA 2."""
    cfg = presets.tiny(hidden_size=512, num_attention_heads=4,
                       num_kv_heads=2, vocab_size=128, seq_length=256,
                       params_dtype="bfloat16", attention_impl="pallas")
    return cfg, init_params(cfg, 0)


def _serve(eng, prompts, n=12, **kw):
    import numpy as np

    from megatron_tpu_torch.inference.engine import Request

    reqs = [eng.submit(Request(prompt=np.asarray(p, dtype=np.int32),
                               max_new_tokens=n, **kw)) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return reqs


_PROMPTS = ([3, 7, 11, 2], list(range(1, 41)), [5, 9, 5, 9, 5, 9, 5, 9],
            list(range(50, 127)))


def _engine(cfg, params, paged=False, **kw):
    from megatron_tpu_torch.inference.engine import InferenceEngine
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 256)
    if paged:
        return PagedInferenceEngine(cfg, params, page_size=16,
                                    prefill_chunk=32, vocab_size=128,
                                    metrics=MetricsRegistry(), **kw)
    return InferenceEngine(cfg, params, vocab_size=128,
                           metrics=MetricsRegistry(), **kw)


def _spec(cfg, params, drafter, layers=1):
    from megatron_tpu_torch.inference.speculative import SpecConfig

    if drafter == "ngram":
        return SpecConfig(k=4)
    dcfg = dataclasses.replace(cfg, num_layers=layers).validate()
    return SpecConfig(k=4, drafter="model", draft_cfg=dcfg, draft_params={
        **params, "layers": {k: {n: t[:layers] for n, t in v.items()}
                             for k, v in params["layers"].items()}})


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("drafter", [None, "ngram", "model"])
def test_graph_engine_matches_the_eager_engine(gen, paged, drafter):
    """The captured tick replays the eager tick's kernels at its shapes:
    greedy and sampled tokens identical, logprobs identical, and the
    launch counters count every replay (the decode kernel once per
    layer a tick, by form: Sq 1 plain and for the draft's k + 1
    forwards, Sq k + 1 the verify)."""
    cfg, params = _serving_model()
    runs = []
    for graph in (False, True):
        spec = _spec(cfg, params, drafter) if drafter else None
        eng = _engine(cfg, params, paged, cuda_graph=graph, speculative=spec)
        assert (eng.capture_seconds is not None) == graph
        c0 = ft.launch_counts()
        reqs = _serve(eng, _PROMPTS) + _serve(eng, _PROMPTS[:2],
                                              temperature=0.8, seed=3)
        c1 = ft.launch_counts()
        name = "paged_flash_decode" if paged else "flash_decode"
        ticks = eng.stats["ticks"]
        forms = {k[len(name) + 1:]: c1[k] - c0.get(k, 0) for k in c1
                 if k.startswith(name + "/") and c1[k] != c0.get(k, 0)}
        if drafter is None:
            want = {"sq1": 2 * ticks}
        elif drafter == "ngram":
            want = {"sq5": 2 * ticks}
        else:
            want = {"sq1": 5 * 1 * ticks, "sq5": 2 * ticks}
        assert forms == want
        assert eng.stats["decode_recompiles"] == 0
        runs.append([(r.generated, r.logprobs) for r in reqs])
    assert runs[0] == runs[1]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_speculative_tokens_match_plain_or_part_at_a_near_tie(gen, paged,
                                                              drafter):
    """Greedy speculative output against plain decode in bf16: the verify
    forward's GEMMs run at [N, k+1] rows, so a token may part from the
    plain one at a bf16 near-tie. Every speculative token is the plain
    teacher-forced argmax or within that position's bf16 error band
    (the largest |bf16 - fp32| logit difference there), at >= 99% of
    positions; the full-depth draft accepts most drafts."""
    cfg, params = _serving_model()
    spec = _spec(cfg, params, drafter, layers=2)
    plain = _serve(_engine(cfg, params, paged), _PROMPTS, n=24)
    eng = _engine(cfg, params, paged, speculative=spec)
    fast = _serve(eng, _PROMPTS, n=24)
    if drafter == "model":
        assert eng.stats["spec_accepted"] > 0.5 * eng.stats["spec_proposed"]
    near, total, same = _near_ties(cfg, params, _PROMPTS, plain, fast)
    assert near / total >= 0.99, (near, total, same)


def _near_ties(cfg, params, prompts, plain, fast):
    """(positions where fast's token is the teacher-forced bf16 argmax or
    within that position's bf16 error band, positions, tokens equal to
    plain's)."""
    from megatron_tpu_torch.models.language_model import lm_forward

    dense = dataclasses.replace(cfg, attention_impl="xla")
    ref = dataclasses.replace(dense, params_dtype="float32")
    p32 = {k: ({kk: ({n: t.float() for n, t in vv.items()}
                     if isinstance(vv, dict) else vv.float())
                for kk, vv in v.items()} if isinstance(v, dict)
               else v.float()) for k, v in params.items()}
    near = total = same = 0
    with torch.no_grad():
        for prompt, a, b in zip(prompts, plain, fast):
            seq = torch.tensor([list(prompt) + b.generated[:-1]],
                               device="cuda")
            lb = lm_forward(dense, params, seq)[0, len(prompt) - 1:].float()
            l32 = lm_forward(ref, p32, seq)[0, len(prompt) - 1:]
            tok = torch.tensor(b.generated, device="cuda")
            gap = lb.max(-1).values - lb.gather(1, tok[:, None])[:, 0]
            band = (lb - l32).abs().max(-1).values
            near += int((gap <= band).sum())
            total += len(b.generated)
            same += sum(x == y for x, y in zip(a.generated, b.generated))
    return near, total, same


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("family", ["falcon", "gpt2"])
def test_family_graph_engine_matches_the_eager_engine(gen, paged, family):
    """Falcon-like (parallel attention, layernorm, gelu, multi-query: G
    8 over 1 kv head at D 64) and GPT-2-like (absolute positions read
    from the captured carry's lengths, biases, tied): the captured tick
    gives the eager engine's greedy and sampled tokens and logprobs
    exactly, plain and with an n-gram verify."""
    from megatron_tpu_torch.inference.speculative import SpecConfig

    kw = (dict(num_kv_heads=1, parallel_attn=True) if family == "falcon"
          else dict(position_embedding_type="absolute",
                    max_position_embeddings=256, use_bias_linear=True,
                    use_bias_qkv=True, num_kv_heads=None))
    cfg = presets.tiny(hidden_size=512, num_attention_heads=8,
                       vocab_size=128, seq_length=256,
                       normalization="layernorm", activation="gelu",
                       tie_embed_logits=True, params_dtype="bfloat16",
                       attention_impl="pallas", **kw)
    params = init_params(cfg, 0)
    for spec in (None, SpecConfig(k=4)):
        runs = []
        for graph in (False, True):
            eng = _engine(cfg, params, paged, cuda_graph=graph,
                          speculative=spec)
            reqs = _serve(eng, _PROMPTS) + _serve(eng, _PROMPTS[:2],
                                                  temperature=0.8, seed=3)
            assert eng.stats["decode_recompiles"] == 0
            runs.append([(r.generated, r.logprobs) for r in reqs])
        assert runs[0] == runs[1], (family, paged, spec)


def test_failed_step_recaptures_the_graph(gen):
    """A replay that raises fails the requests in flight, rebuilds the
    caches and captures again (counted in decode_recompiles); the engine
    then serves what a fresh engine serves."""
    import numpy as np

    from megatron_tpu_torch.inference.engine import Request

    cfg, params = _serving_model()
    eng = _engine(cfg, params, speculative=_spec(cfg, params, "ngram"))
    first = eng._step
    reqs = [eng.submit(Request(prompt=np.arange(1, 9, dtype=np.int32),
                               max_new_tokens=20))]
    eng.step()

    def broken():
        raise RuntimeError("injected replay failure")

    eng._step = broken
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert reqs[0].done.is_set() and "decode step failed" in reqs[0].error
    assert eng._step is not first and eng._step is not broken
    assert eng.stats["decode_recompiles"] == 1
    got = _serve(eng, _PROMPTS)
    want = _serve(_engine(cfg, params,
                          speculative=_spec(cfg, params, "ngram")), _PROMPTS)
    assert [r.generated for r in got] == [r.generated for r in want]


def test_capture_failure_raises_and_nothing_goes_eager():
    """A step body that syncs with the host cannot be captured: engine
    construction raises instead of serving eagerly (run in a child
    process, so the failed capture cannot touch this one's context)."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "from megatron_tpu_torch.inference.engine import InferenceEngine\n"
        "from megatron_tpu_torch.models import presets\n"
        "from megatron_tpu_torch.models.params import init_params\n"
        "from megatron_tpu_torch.telemetry.metrics import MetricsRegistry\n"
        "cfg = presets.tiny(hidden_size=512, num_attention_heads=4,"
        " num_kv_heads=2, vocab_size=128, params_dtype='bfloat16',"
        " attention_impl='pallas')\n"
        "body = InferenceEngine._step_body\n"
        "def syncing(self):\n"
        "    out = body(self)\n"
        "    out['toks'][0].item()\n"
        "    return out\n"
        "InferenceEngine._step_body = syncing\n"
        "try:\n"
        "    InferenceEngine(cfg, init_params(cfg, 0), num_slots=2,"
        " max_seq_len=128, metrics=MetricsRegistry())\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', 'capture' in str(e))\n"
        "    sys.exit(0)\n"
        "print('NO ERROR')\n"
        "sys.exit(1)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0 and "RAISED True" in proc.stdout, \
        proc.stdout + proc.stderr[-3000:]


def test_decode_workspace_and_tickets_under_capture(gen):
    """The decode kernel captured in a graph: without a launch on the
    capture stream first it raises (its tickets would be zeroed only by
    replays); after the warm-up the replays give the eager result bit
    for bit, and CapturedStep adds the captured launches per replay."""
    from megatron_tpu_torch.inference.cuda_graph import CapturedStep

    B, S, hkv = 8, 2048, 8
    q = _randn(gen, B, 5, 32, 128)
    k, v = _randn(gen, B, S, hkv, 128), _randn(gen, B, S, hkv, 128)
    lens = torch.tensor([1, 63, 64, 500, 1000, 1500, 2000, 2044],
                        dtype=torch.int32, device="cuda")
    want = ft.flash_decode(q, k, v, lens)
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="never ran on"):
        with torch.cuda.graph(graph, stream=side):
            ft.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    step = CapturedStep(lambda: {"o": ft.flash_decode(q, k, v, lens)},
                        torch.device("cuda"))
    assert step.launch_delta == {"flash_decode": 1, "flash_decode/sq5": 1}
    before = ft.flash_decode.launches
    for _ in range(3):
        assert torch.equal(step()["o"], want)
    assert ft.flash_decode.launches == before + 3


def test_engine_refuses_a_verify_past_the_kernel_rows(gen):
    """Once refused, now served: (k + 1) * G = 80 query rows per kv head
    (G 16, k 4) take two row tiles of the decode kernel, and the greedy
    speculative tokens are the plain engine's or part at a bf16 near-tie
    (the verify's GEMMs run at other shapes)."""
    from megatron_tpu_torch.inference.speculative import SpecConfig

    cfg = presets.tiny(hidden_size=2048, num_attention_heads=16,
                       num_kv_heads=1, vocab_size=128,
                       params_dtype="bfloat16", attention_impl="pallas")
    params = init_params(cfg, 0)
    plain = _serve(_engine(cfg, params), _PROMPTS, n=16)
    eng = _engine(cfg, params, speculative=SpecConfig(k=4))
    c0 = ft.launch_counts()         # after the capture's warm-up launches
    fast = _serve(eng, _PROMPTS, n=16)
    forms = ft.launch_counts()
    assert forms["flash_decode/sq5"] - c0.get("flash_decode/sq5", 0) \
        == 2 * eng.stats["ticks"]
    near, total, _ = _near_ties(cfg, params, _PROMPTS, plain, fast)
    assert near / total >= 0.99, (near, total)


@pytest.mark.parametrize("paged", [False, True])
def test_reload_under_replay_serves_the_new_weights(gen, paged):
    """update_params between replays: the captured graph reads the new
    weights (copied into its tensors), with no capture beyond the
    warm-up one, and the tokens equal an engine built on them."""
    cfg, params = _serving_model()
    new = init_params(cfg, 1)
    eng = _engine(cfg, params, paged)
    graph = eng._step
    before = _serve(eng, _PROMPTS)
    applied = eng.update_params(new, version=7)
    after = _serve(eng, _PROMPTS)
    fresh = _serve(_engine(cfg, init_params(cfg, 1), paged), _PROMPTS)
    assert applied.is_set() and eng.params_version == 7
    assert eng._step is graph
    assert eng.stats["decode_recompiles"] == 0
    assert eng.stats["weight_reloads"] == 1
    got = [(r.generated, r.logprobs) for r in after]
    assert got == [(r.generated, r.logprobs) for r in fresh]
    assert got != [(r.generated, r.logprobs) for r in before]


@pytest.mark.parametrize("paged", [False, True])
def test_int8_graph_tick_matches_the_eager_tick(gen, paged):
    """int8 caches (quantize on write, dequantize the whole cache for the
    decode kernel) under the graph: tokens and logprobs equal the eager
    engine's bit for bit, and the decode kernel runs once per layer a
    tick."""
    cfg, params = _serving_model()
    runs = []
    for graph in (False, True):
        eng = _engine(cfg, params, paged, cuda_graph=graph,
                      kv_cache_int8=True)
        assert eng.caches[0].dtype == torch.int8
        assert eng.caches[2].dtype == torch.float32
        c0 = ft.launch_counts()
        reqs = _serve(eng, _PROMPTS) + _serve(eng, _PROMPTS[:2],
                                              temperature=0.8, seed=3)
        name = "paged_flash_decode" if paged else "flash_decode"
        assert (ft.launch_counts()[name] - c0[name]
                == 2 * eng.stats["ticks"])
        assert eng.stats["decode_recompiles"] == 0
        runs.append([(r.generated, r.logprobs) for r in reqs])
    assert runs[0] == runs[1]


def test_deadline_clears_a_slot_between_replays(gen):
    """A request whose deadline expires in mid-decode fails with
    timed_out, its slot's carry row goes inactive, so the next replays
    leave it alone, and the other requests get the tokens they get
    without it."""
    import time

    import numpy as np

    from megatron_tpu_torch.inference.engine import Request

    cfg, params = _serving_model()
    eng = _engine(cfg, params)
    others = [eng.submit(Request(prompt=np.asarray(p, np.int32),
                                 max_new_tokens=20)) for p in _PROMPTS[:2]]
    victim = eng.submit(Request(prompt=np.asarray(_PROMPTS[2], np.int32),
                                max_new_tokens=100, deadline_s=600.0))
    for _ in range(4):
        eng.step()
    i = next(j for j, r in enumerate(eng.slots) if r is victim)
    victim._deadline = time.monotonic() - 1.0
    eng.step()
    assert victim.timed_out and "mid-decode" in victim.error
    assert eng.slots[i] is None and eng.stats["timeouts"] == 1
    held = int(eng._carry["lengths"][i])
    assert int(eng._carry["active"][i]) == 0
    eng.step()
    assert int(eng._carry["lengths"][i]) == held
    eng.run_until_idle()
    alone = _serve(_engine(cfg, params), _PROMPTS[:2], n=20)
    assert [r.generated for r in others] == [r.generated for r in alone]
    assert eng.stats["decode_recompiles"] == 0


# ---------------------------------------------------------------------------
# the loop and the data: the prefetcher's streams, the native index
# builder, a step's determinism
# ---------------------------------------------------------------------------


def test_prefetcher_batches_are_never_torn(gen, monkeypatch):
    """The prefetcher's copies run on its own stream, held back here by
    torch.cuda._sleep before each one, and the worker does not wait for
    them (land=False): a batch popped and read on the compute stream at
    once must still hold all of its values, because the compute stream
    waits on the batch's event (and record_stream keeps the memory)."""
    import numpy as np

    from megatron_tpu_torch.training import prefetch

    real = prefetch.to_device

    def delayed(batch, device, stream=None, **kw):
        if stream is not None:
            with torch.cuda.stream(stream):
                torch.cuda._sleep(50_000_000)   # ~tens of ms
        return real(batch, device, stream, **kw)

    monkeypatch.setattr(prefetch, "to_device", delayed)
    n = 1 << 22
    source = ({"x": np.full((n,), i + 1, np.int32)} for i in range(6))
    pf = prefetch.DevicePrefetcher(source, "cuda", depth=2, land=False)
    sums = []
    while (b := next(pf, None)) is not None:
        sums.append(int(b["x"].sum(dtype=torch.int64)))
        del b
    pf.close()
    assert sums == [(i + 1) * n for i in range(6)]


def test_native_index_builder_on_the_card_host():
    import numpy as np

    from megatron_tpu_torch.data import helpers

    assert helpers.native_helpers() is not None
    assert helpers.library_path().exists()
    r = np.random.default_rng(0)
    sizes = r.integers(3, 500, 2000).astype(np.int32)
    doc = np.concatenate([r.permutation(2000) for _ in range(2)])
    args = (sizes, doc, 128, 2, int(sizes.sum()))
    np.testing.assert_array_equal(
        helpers.build_sample_idx(*args),
        helpers.build_sample_idx(*args, native=False))
    di, ds = helpers.build_blending_indices(np.array([0.6, 0.4]), 5000)
    pi, ps = helpers.build_blending_indices(np.array([0.6, 0.4]), 5000,
                                            native=False)
    np.testing.assert_array_equal(di, pi)
    np.testing.assert_array_equal(ds, ps)


def test_two_runs_of_a_step_are_bitwise_equal(gen):
    """One state and one batch, the step run twice from copies of the
    state: bitwise-equal states and metrics (the replay check's premise,
    on the flash kernels, bf16 with fp32 masters, 2 microbatches)."""
    from megatron_tpu_torch.training import resilience
    from megatron_tpu_torch.training.pretrain import clone_state

    cfg = presets.tiny(hidden_size=512, num_attention_heads=4,
                       num_kv_heads=2, vocab_size=128, seq_length=256,
                       params_dtype="bfloat16", attention_impl="pallas")
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    tc = TrainingConfig(micro_batch_size=1, global_batch_size=2,
                        train_iters=2, recompute_granularity="selective")
    params = init_params(cfg, 0)
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    state = init_train_state(opt, params)
    step = make_train_step(cfg, opt, tc, 2)
    toks = torch.randint(0, 128, (2, 2, 257), generator=gen, device="cuda")
    state, _ = step(state, {"tokens": toks[0, :, :-1],
                            "labels": toks[0, :, 1:]})
    batch = {"tokens": toks[1, :, :-1], "labels": toks[1, :, 1:]}
    a, ma = step(clone_state(state), batch)
    b, mb = step(clone_state(state), batch)
    assert resilience.tree_bitwise_mismatch(
        {"state": a, "metrics": ma}, {"state": b, "metrics": mb}) == []


def test_flash_kernels_at_the_tp2_per_rank_shape(gen):
    """B1 forward and B2/B3 backward at a tensor-parallel rank's share of
    Llama-2-7B's attention at tp2 (16 query and 16 kv heads of D 128,
    S 2048), against their plain versions."""
    q = _randn(gen, 1, 2048, 16, 128)
    k, v = _randn(gen, 1, 2048, 16, 128), _randn(gen, 1, 2048, 16, 128)
    do = _randn(gen, 1, 2048, 16, 128)
    o, lse = ft.flash_fwd(q, k, v)
    o_ref, lse_ref = ft.flash_fwd_reference(q.float(), k.float(), v.float())
    _assert_close(o, o_ref)
    _assert_close(lse, lse_ref)
    got = ft.flash_bwd(q, k, v, o, lse, do)
    want = ft.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                  do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_close_rel(a, b, name)


def test_flash_kernels_at_the_tp2_serving_shapes(gen):
    """A tp2 serving rank of Llama-2-7B: B1 over a 2047-token prefill and
    B4 over a decode tick of 8 ragged slots of 2048, each with 16 query
    and 16 kv heads of D 128."""
    q, k, v = (_randn(gen, 1, 2047, 16, 128) for _ in range(3))
    o, lse = ft.flash_fwd(q, k, v)
    o_ref, lse_ref = ft.flash_fwd_reference(q.float(), k.float(), v.float())
    _assert_close(o, o_ref)
    _assert_close(lse, lse_ref)
    q = _randn(gen, 8, 1, 16, 128)
    k, v = _randn(gen, 8, 2048, 16, 128), _randn(gen, 8, 2048, 16, 128)
    lens = torch.tensor([1, 63, 64, 2047, 2048, 500, 1000, 1500],
                        dtype=torch.int32, device="cuda")
    _assert_close(ft.flash_decode(q, k, v, lens),
                  ft.flash_decode_reference(q.float(), k.float(), v.float(),
                                            lens))


def test_flash_kernels_at_the_falcon40b_tp2_rank_shape(gen):
    """A tp2 rank of Falcon-40B (64 query heads over 4 kv heads of D 64,
    a group of 16): B1 forward and B2/B3 backward at S 2048, and B4 over
    a decode tick of 8 ragged slots of 2048 (16 rows a kv head), against
    their plain versions."""
    q = _randn(gen, 1, 2048, 64, 64)
    k, v = _randn(gen, 1, 2048, 4, 64), _randn(gen, 1, 2048, 4, 64)
    do = _randn(gen, 1, 2048, 64, 64)
    o, lse = ft.flash_fwd(q, k, v)
    o_ref, lse_ref = ft.flash_fwd_reference(q.float(), k.float(), v.float())
    _assert_close(o, o_ref)
    _assert_close(lse, lse_ref)
    got = ft.flash_bwd(q, k, v, o, lse, do)
    want = ft.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                  do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_close_rel(a, b, name)
    q = _randn(gen, 8, 1, 64, 64)
    k, v = _randn(gen, 8, 2048, 4, 64), _randn(gen, 8, 2048, 4, 64)
    lens = torch.tensor([1, 63, 64, 2047, 2048, 500, 1000, 1500],
                        dtype=torch.int32, device="cuda")
    _assert_close(ft.flash_decode(q, k, v, lens),
                  ft.flash_decode_reference(q.float(), k.float(), v.float(),
                                            lens))


def test_paged_decode_at_the_tp2_paged_rank_shape(gen):
    """A tp2 rank of Llama-2-7B on the paged engine: B5 over 8 ragged
    slots of 2048 through a shuffled table of 16-token pages, 16 query
    and 16 kv heads of D 128, against its plain version."""
    B, ps, max_pages = 8, 16, 128
    n_pages = 1 + B * max_pages
    q = _randn(gen, B, 1, 16, 128)
    kp, vp = (_randn(gen, n_pages, ps, 16, 128) for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).view(B, max_pages).to(torch.int32)
    lens_list = [1, 63, 64, 2047, 2048, 500, 1000, 1500]
    for b, n in enumerate(lens_list):
        table[b, -(-n // ps):] = 0
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    before = ft.paged_flash_decode.launches
    o = ft.paged_flash_decode(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert ft.paged_flash_decode.launches == before + 1
    _assert_close(o, ft.paged_flash_decode_reference(
        q.float(), kp.float(), vp.float(), table, lens))


def _sharded_cfg():
    return presets.tiny(hidden_size=256, num_attention_heads=4,
                        num_kv_heads=2, ffn_hidden_size=512, vocab_size=256,
                        seq_length=64, params_dtype="bfloat16")


def _sharded_full_state():
    """A bf16 TrainState on the card whose params, masters and moments
    all differ (the same on every process: seeded init, then arithmetic)."""
    cfg = _sharded_cfg()
    state = init_train_state(OptimizerConfig(), init_params(cfg, 0))
    with torch.no_grad():
        for (_, p), (_, m), (_, mu), (_, nu) in zip(
                leaf_paths(state.params), leaf_paths(state.master),
                leaf_paths(state.mu), leaf_paths(state.nu)):
            m.add_(0.25)
            mu.copy_(p.float() * 0.5)
            nu.copy_(p.float().square())
        state.step.fill_(7)
    return cfg, state


def _tp2_slice(state, cfg, mesh):
    """A tp2 rank's TrainState by the training path's own cut."""
    from megatron_tpu_torch.models.params import shard_params
    from megatron_tpu_torch.training.optimizer import nest_paths

    def cut(t):
        return nest_paths(shard_params(dict(leaf_paths(t)), cfg, mesh))

    return dataclasses.replace(
        state, params=cut(state.params), master=cut(state.master),
        mu=cut(state.mu), nu=cut(state.nu))


def _sharded_save_rank(rank, port, save):
    """One of two gloo ranks sharing the card: its tp2 slice of the
    state, saved into the sharded layout."""
    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models.params import StatePlacement
    from megatron_tpu_torch.parallel.mesh import build_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        cfg, full = _sharded_full_state()
        mesh = build_mesh(ParallelConfig(tensor_parallel=2))
        saver = checkpointing.AsyncCheckpointSaver(
            save, placement=StatePlacement.of(cfg, mesh, zero1=False))
        saver.save(_tp2_slice(full, cfg, mesh), 3, consumed_samples=12)
        saver.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_sharded_layout_round_trips_a_cuda_state(gen, tmp_path):
    """Saved by two tp2 ranks on the card, loaded on the card at world
    size 1 and at tp2: every leaf bitwise."""
    import socket

    import torch.multiprocessing as mp

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models.params import StatePlacement
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training import resilience

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    save = str(tmp_path / "sharded")
    mp.spawn(_sharded_save_rank, args=(port, save), nprocs=2, join=True)
    layout = os.path.join(checkpointing.checkpoint_dir(save, 3), "state",
                          checkpointing.LAYOUT)
    assert os.path.exists(layout)
    cfg, full = _sharded_full_state()
    template = init_train_state(OptimizerConfig(), init_params(cfg, 1))
    got, it, consumed = checkpointing.load_checkpoint(save, template)
    assert (it, consumed) == (3, 12) and got.mu["layers"]["attn"]["wq"].is_cuda
    fields = ("params", "master", "mu", "nu")
    assert resilience.tree_bitwise_mismatch(
        {f: getattr(got, f) for f in fields},
        {f: getattr(full, f) for f in fields}) == []
    assert int(got.step) == 7
    for r in range(2):
        mesh = build_mesh(ParallelConfig(tensor_parallel=2), world_size=2,
                          rank=r)
        want = _tp2_slice(full, cfg, mesh)
        template = _tp2_slice(init_train_state(
            OptimizerConfig(), init_params(cfg, 2)), cfg, mesh)
        got, _, _ = checkpointing.load_checkpoint(
            save, template,
            placement=StatePlacement.of(cfg, mesh, zero1=False))
        assert resilience.tree_bitwise_mismatch(
            {f: getattr(got, f) for f in fields},
            {f: getattr(want, f) for f in fields}) == [], r


def test_world_size_one_nccl_step_equals_the_single_process_step(gen):
    """The parallel code at degree 1 over an NCCL group of one rank: two
    steps from one state give the single-process step's states and
    metrics bitwise (every collective is the identity there)."""
    import socket

    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.training import resilience
    from megatron_tpu_torch.training.pretrain import clone_state

    cfg = presets.tiny(hidden_size=512, num_attention_heads=4,
                       num_kv_heads=2, vocab_size=128, seq_length=256,
                       params_dtype="bfloat16", attention_impl="pallas")
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant",
                          use_distributed_optimizer=True)
    tc = TrainingConfig(micro_batch_size=1, global_batch_size=2,
                        train_iters=2, recompute_granularity="selective")
    params = init_params(cfg, 0)
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    state = init_train_state(opt, params)
    toks = torch.randint(0, 128, (2, 2, 257), generator=gen, device="cuda")
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = build_mesh(ParallelConfig())
        runs = []
        for m in (None, mesh):
            st = clone_state(state)
            step = make_train_step(cfg, opt, tc, 2, mesh=m)
            for b in batches:
                st, metrics = step(st, b)
            runs.append({"state": st, "metrics": metrics})
        assert resilience.tree_bitwise_mismatch(*runs) == []
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Mixtral's MoE layer, weight-quantized serving, the async loop's pop
# ---------------------------------------------------------------------------


def _moe_cfg(**kw):
    base = dict(hidden_size=512, num_attention_heads=4, num_kv_heads=2,
                ffn_hidden_size=256, vocab_size=128, seq_length=256,
                num_experts=8, moe_top_k=2, params_dtype="bfloat16",
                attention_impl="pallas", rope_theta=1e6)
    base.update(kw)
    return presets.tiny(**base)


@pytest.mark.parametrize("dispatch", ["capacity", "dropless"])
def test_moe_block_on_the_card_matches_its_cpu_form(gen, dispatch):
    """One MoE layer in bf16 on the card (the dropless products through
    torch._grouped_mm) against the same bf16 weights and input through
    the CPU form in fp32: output, aux loss and every gradient within
    |card - cpu| <= 2e-2 * (M + |cpu|), M the tensor's largest magnitude
    (bf16 activations between the products)."""
    from megatron_tpu_torch.ops import moe

    cfg = _moe_cfg(moe_dispatch=dispatch, moe_capacity_factor=1.0)
    p = {k: v[0] for k, v in init_params(cfg, 3)["layers"]["moe"].items()}
    x = _randn(gen, 2, 128, 512)
    outs = []
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        c = dataclasses.replace(cfg, params_dtype=(
            "bfloat16" if dtype == torch.bfloat16 else "float32"))
        lp = {k: v.detach().to(dev, dtype).clone().requires_grad_(True)
              for k, v in p.items()}
        xi = x.detach().to(dev, dtype).clone().requires_grad_(True)
        y, aux = moe.moe_block(c, lp, xi)
        (y.float().square().sum() + aux).backward()
        outs.append([y.detach(), aux.detach(), xi.grad]
                    + [lp[k].grad for k in sorted(lp)])
    if dispatch == "dropless":
        assert moe.grouped_mm_available(x)
    for got, want in zip(*outs):
        got, want = got.float().cpu(), want.float()
        m = want.abs().max()
        assert bool(((got - want).abs() <= 2e-2 * (m + want.abs())).all())


def test_dropless_matches_capacity_on_the_card_at_ample_capacity(gen):
    """At ample capacity nothing drops, so the card's dropless layer
    (grouped products) equals its capacity layer (per-expert bmm) within
    bf16 rounding: |a - b| <= 2e-2 * (M + |b|)."""
    from megatron_tpu_torch.ops import moe

    cfg = _moe_cfg(moe_capacity_factor=8.0)
    p = {k: v[0] for k, v in init_params(cfg, 4)["layers"]["moe"].items()}
    x = _randn(gen, 4, 64, 512)
    with torch.no_grad():
        a, aux_a = moe.moe_block(cfg, p, x)
        b, aux_b = moe.moe_block(
            dataclasses.replace(cfg, moe_dispatch="dropless"), p, x)
    m = b.float().abs().max()
    assert bool(((a.float() - b.float()).abs()
                 <= 2e-2 * (m + b.float().abs())).all())
    assert float(aux_a) == pytest.approx(float(aux_b), rel=1e-5)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dispatch", ["capacity", "dropless"])
def test_moe_graph_tick_matches_the_eager_tick(gen, paged, dispatch):
    """A Mixtral-shaped engine's decode tick is captured (the capacity
    path at S = 1 has static shapes; dropless keeps its spans on the
    device) and replays the eager tick's tokens and logprobs exactly,
    with the decode kernel once per layer a tick."""
    cfg = _moe_cfg(moe_dispatch=dispatch)
    params = init_params(cfg, 0)
    runs = []
    for graph in (False, True):
        eng = _engine(cfg, params, paged, cuda_graph=graph)
        assert eng.eager_reason is None
        assert (eng.capture_seconds is not None) == graph
        c0 = ft.launch_counts()
        reqs = _serve(eng, _PROMPTS) + _serve(eng, _PROMPTS[:2],
                                              temperature=0.8, seed=3)
        name = "paged_flash_decode" if paged else "flash_decode"
        assert (ft.launch_counts()[name] - c0[name]
                == 2 * eng.stats["ticks"])
        assert eng.stats["decode_recompiles"] == 0
        runs.append([(r.generated, r.logprobs) for r in reqs])
    assert runs[0] == runs[1]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_weight_quant_dequantize_and_graph_tick(gen, mode, paged):
    """An fp8 / int8 leaf quantizes and dequantizes on the card to the
    CPU's values bit for bit, and a quantized engine's captured tick (the
    dequantize captured with the products) replays the eager tick
    exactly, on either engine."""
    from megatron_tpu_torch.ops.weight_quant import (
        deq, quantize_params_for_serving,
    )

    cfg, params = _serving_model()
    q = quantize_params_for_serving(params, mode)
    leaf = q["layers"]["mlp"]["w_in"]
    cpu = {k: v.cpu() for k, v in leaf.items()}
    assert torch.equal(deq(leaf, torch.bfloat16).cpu(),
                       deq(cpu, torch.bfloat16))
    ref = quantize_params_for_serving(
        {"layers": {"mlp": {"w_in": params["layers"]["mlp"]["w_in"].cpu()}}},
        mode)["layers"]["mlp"]["w_in"]
    kind = "q8" if mode == "int8" else "f8"
    assert torch.equal(leaf[kind].cpu().view(torch.uint8),
                       ref[kind].view(torch.uint8))
    runs = []
    for graph in (False, True):
        eng = _engine(cfg, q, paged, cuda_graph=graph)
        reqs = _serve(eng, _PROMPTS)
        assert eng.stats["decode_recompiles"] == 0
        runs.append([(r.generated, r.logprobs) for r in reqs])
    assert runs[0] == runs[1]


def test_prefetch_pop_alone_with_the_worker_parked(gen):
    """The async loop's pop with the worker parked (the queue full, no
    permit): the worker starts no batch during the pops, so
    each pop runs alone; its time is printed beside a host iterator's
    next() (the synchronous loop's data fetch) on the same batches."""
    import time

    import numpy as np

    from megatron_tpu_torch.training import prefetch

    batches = [{"tokens": np.full((2, 1024), i, np.int64),
                "labels": np.full((2, 1024), i, np.int64),
                "loss_mask": np.ones((2, 1024), np.float32)}
               for i in range(64)]
    pops = []
    for _ in range(20):
        pf = prefetch.DevicePrefetcher(iter(batches), "cuda", depth=2)
        while pf._q.qsize() < 2:
            time.sleep(0.01)
        put = pf.batches_put
        for _ in range(2):
            t0 = time.perf_counter()
            next(pf)
            pops.append((time.perf_counter() - t0) * 1e3)
        assert pf.batches_put == put
        pf.close()
    host = []
    it = iter(batches)
    for _ in range(40):
        t0 = time.perf_counter()
        next(it)
        host.append((time.perf_counter() - t0) * 1e3)
    print(f"pop alone: median {np.median(pops):.4f} ms (max "
          f"{max(pops):.4f}); host next(): median {np.median(host):.4f} ms")


# ---------------------------------------------------------------------------
# context parallelism: the ring's stripe pairs on the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cp,s,hq,hkv,window,zigzag", [
    (2, 8192, 32, 8, None, True), (4, 8192, 32, 8, None, True),
    (2, 8192, 32, 8, 4096, True), (4, 16384, 32, 8, 4096, True),
    # S % 2cp != 0: the contiguous ring, with and without a window
    (2, 8194, 32, 8, None, False), (4, 8196, 32, 8, 4096, False)])
def test_emulated_ring_kernels_match_plain_stripes(gen, cp, s, hq, hkv,
                                                    window, zigzag):
    """Every virtual rank's ring (ops/ring_attention.py) with each live
    stripe pair on B1 forward and B2/B3 backward, at Llama-2-7B-like
    heads of D 128 with GQA 32/8, causal and Mistral's window of 4096,
    against the same ring on the plain versions: output within the
    forward gate, dq/dk/dv within the backward gate of the largest plain
    magnitude; B1/B2/B3 launched once per live pair."""
    from megatron_tpu_torch.ops import ring_attention as ra

    q = _randn(gen, 1, s, hq, 128)
    k, v = _randn(gen, 1, s, hkv, 128), _randn(gen, 1, s, hkv, 128)
    do = _randn(gen, 1, s, hq, 128)
    n = 2 if zigzag else 1
    live = sum(p.live for my in range(cp) for _, pairs in ra.ring_schedule(
        my, cp, s // (n * cp), window, zigzag) for p in pairs)
    runs = {}
    for plain in (False, True):
        before = [f.launches for f in (ft.flash_fwd, ft.flash_bwd_dq,
                                       ft.flash_bwd_dkv)]
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ra.ring_attention_emulated(*xs, cp, sliding_window=window,
                                         zigzag=zigzag, plain=plain)
        out.backward(do)
        torch.cuda.synchronize()
        ran = [f.launches - b for f, b in zip(
            (ft.flash_fwd, ft.flash_bwd_dq, ft.flash_bwd_dkv), before)]
        assert ran == ([0, 0, 0] if plain else [live] * 3), (plain, ran)
        runs[plain] = [out.detach()] + [t.grad for t in xs]
    _assert_close(runs[False][0], runs[True][0])
    for name, a, b in zip(("dq", "dk", "dv"), runs[False][1:],
                          runs[True][1:]):
        assert a.dtype == torch.bfloat16
        _assert_close_rel(a, b, name)


@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (4096, 4096, 11008)])
@pytest.mark.parametrize("fmt", ["hybrid", "e4m3"])
@pytest.mark.parametrize("wgrad", [True, False])
def test_fp8_matmul_scaled_mm_matches_plain(gen, m, k, n, fmt, wgrad):
    """ops/fp8.fp8_matmul on the card (torch._scaled_mm, the inverse
    scales, fp32 before the cast) against its plain version on the same
    bf16 inputs: out, dx and dw within 2^-7 of the plain's largest
    magnitude (both round to bf16 after fp32 sums in different orders);
    a product that is not a multiple of 16 raises."""
    from megatron_tpu_torch.ops.fp8 import fp8_matmul

    x = _randn(gen, 1, m, k)
    w = (_randn(gen, k, n).float() * 0.02).to(torch.bfloat16)
    g = _randn(gen, 1, m, n)
    runs = {}
    for plain in (False, True):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = fp8_matmul(xs, ws, fmt=fmt, fp8_wgrad=wgrad, plain=plain)
        out.backward(g)
        runs[plain] = (out.detach(), xs.grad, ws.grad)
    for name, a, b in zip(("out", "dx", "dw"), runs[False], runs[True]):
        assert a.dtype == b.dtype == torch.bfloat16, name
        m_ = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2 ** -7 * m_, \
            name
    with pytest.raises(ValueError, match="multiple of 16"):
        fp8_matmul(_randn(gen, 8, 40), _randn(gen, 40, 32))


def test_flash_bwd_dkv_holds_the_gate_at_a_long_sequence(gen):
    """dk/dv at S 16384 (Ulysses' rank at cp2 runs the whole sequence
    over its heads) against the plain backward: the dSᵀ product sums
    16384 queries, where one bf16 rounding of ds left dk outside the
    backward gate (margin 1.42 at 16 heads); the hi/lo split of dSᵀ keeps
    it inside. 8 heads of D 128 keep the plain version's fp32 [H, S, S]
    tensors within the card."""
    s, h = 16384, 8
    q, k, v, do = (_randn(gen, 1, s, h, 128) for _ in range(4))
    o, lse = ft.flash_fwd(q, k, v)
    dsum = ft._bwd_dsum(o, do)
    dk, dv = ft.flash_bwd_dkv(q, k, v, do, lse, dsum)
    torch.cuda.synchronize()
    want = ft._bwd_plain(q, k, v, do, lse, dsum, True, None, 0)
    for name, a, b in zip(("dk", "dv"), (dk, dv), want[1:]):
        _assert_close_rel(a, b, name)


@pytest.mark.parametrize("paged", [True, False])
def test_decode_partial_form_at_local_length_zero_and_page_edges(gen,
                                                                 paged):
    """B5's partial form (return_lse: fp32 o, lse [B, Hq, Sq]), the form a
    context-parallel rank's stripe takes, and B4's dense launch of it:
    rows of length 0 (a rank holding no page of the row: o = 0, lse at
    NEG_INF), 1, a page boundary (16, 64), past it and long, against the
    plain version: o within the kernels' gate, lse within 2e-2 (natural
    log, fp32 sums; the kernel rounds P to bf16 only for P V). The
    partial launches count under launches_by_form["lse"]."""
    from megatron_tpu_torch.ops.flash.masks import NEG_INF

    B, ps, max_pages, hq, hkv = 8, 16, 64, 32, 8
    lens_list = [0, 1, 16, 17, 64, 0, 1000, 1024]
    q = _randn(gen, B, 1, hq, 128)
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    if paged:
        n_pages = 1 + B * max_pages
        kp, vp = (_randn(gen, n_pages, ps, hkv, 128) for _ in range(2))
        table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                 + 1).view(B, max_pages).to(torch.int32)
        args = (kp, vp, table, lens)
        fn, ref, w = (ft.paged_flash_decode, ft.paged_flash_decode_reference,
                      ft.paged_flash_decode)
    else:
        k, v = (_randn(gen, B, max_pages * ps, hkv, 128) for _ in range(2))
        args = (k, v, lens)
        fn, ref, w = ft.flash_decode, ft.flash_decode_reference, \
            ft.flash_decode
    before = w.launches_by_form.get("lse", 0)
    o, lse = fn(q, *args, return_lse=True)
    torch.cuda.synchronize()
    assert w.launches_by_form["lse"] == before + 1
    assert o.dtype == lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, hq, 1)
    want_o, want_l = ref(q.float(), *[a.float() if a.is_floating_point()
                                      else a for a in args[:-1]], lens,
                         return_lse=True)
    _assert_close(o, want_o)
    live = lens > 0
    assert float((lse[live] - want_l[live]).abs().max()) <= 2e-2
    assert not o[~live].any()
    assert bool((lse[~live] <= NEG_INF / 2).all())
    assert bool((want_l[~live] <= NEG_INF / 2).all())


def _ring_rank(rank, port, out):
    """One of two gloo ranks sharing the card: its seeded CUDA tensor one
    ring hop each way in every transport mode."""
    import torch.distributed as dist

    from megatron_tpu_torch.quant import collectives as qc
    from megatron_tpu_torch.quant.primitives import (
        dequantize_chunked, quantize_chunked,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        g = torch.Generator(device="cuda")
        xs = [torch.randn(4, 3, 128, generator=g.manual_seed(r),
                          device="cuda") for r in range(2)]
        got = {}
        for mode in ("dense", "int8", "fp8"):
            back = qc.ring_permute(xs[rank], dist.group.WORLD,
                                   [(0, 1), (1, 0)], mode, 32)
            want = xs[1 - rank]
            if mode != "dense":
                want = dequantize_chunked(*quantize_chunked(want, 32, mode))
            got[mode] = (back.is_cuda, bool(torch.equal(back, want)))
        torch.save(got, f"{out}.rank{rank}")
    finally:
        dist.destroy_process_group()


def test_compressed_ring_permute_round_trips_cuda_tensors(gen, tmp_path):
    """The CP ring hop on CUDA tensors between two gloo ranks on the card:
    dense arrives bitwise, int8 and fp8 as the card's own quantize ->
    dequantize of the peer's tensor (the fp8 payload as bytes), on the
    card."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "ring")
    mp.spawn(_ring_rank, args=(port, out), nprocs=2, join=True)
    for r in range(2):
        got = torch.load(f"{out}.rank{r}")
        assert got == {m: (True, True) for m in ("dense", "int8", "fp8")}, r


_STORE_RANK = """
import json, sys, time
import torch, torch.distributed as dist
from megatron_tpu_torch.training.coordination import (
    ClusterCoordinator, CommitAborted, StoreBackend)

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
store = dist.distributed_c10d._get_default_store()
c = ClusterCoordinator(StoreBackend(2), rank, 2, peer_death_timeout_s=10,
                       poll_s=0.05)
c.topology_barrier(60)
c.commit_barrier(3, f"crc{rank}", 30)
target, _ = c.agree_exit_iteration(5 + rank, 30)
aborted = False
if rank == 0:
    try:
        c.commit_barrier(9, "x", 1.0)
    except CommitAborted:
        aborted = True
x = torch.full((4,), float(rank + 1), device="cuda")
dist.all_reduce(x)
c.publish_value("done", True)
while c.read_value("done", host=1 - rank) is None:
    time.sleep(0.05)
dist.barrier()
with open(f"{out}.rank{rank}", "w") as f:
    json.dump({"target": target, "aborted": aborted,
               "sum": x.cpu().tolist(),
               "list_keys": hasattr(store, "list_keys"),
               "multi_get": hasattr(store, "multi_get"),
               "torch": torch.__version__}, f)
dist.destroy_process_group()
"""


def _ranks(script, *args, env=None):
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(port), *args], cwd=repo,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def test_store_backend_on_the_cards_torch(gen, tmp_path):
    """The coordinator over the store of a gloo group of two processes on
    the card: the topology barrier, a commit, the exit agreement, and a
    one-sided commit that aborts."""
    import json

    out = str(tmp_path / "store")
    procs = _ranks(_STORE_RANK, out)
    logs = [p.communicate(timeout=180)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    got = [json.load(open(f"{out}.rank{r}")) for r in range(2)]
    assert [g["target"] for g in got] == [6, 6]
    assert got[0]["aborted"] and got[0]["sum"] == [3.0] * 4
    print("torch", got[0]["torch"], "list_keys", got[0]["list_keys"],
          "multi_get", got[0]["multi_get"])


_BLOCKED_RANK = """
import os, sys, time
import torch, torch.distributed as dist
from megatron_tpu_torch.training.coordination import (
    ClusterCoordinator, StoreBackend)

rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
c = ClusterCoordinator(StoreBackend(2), rank, 2, peer_death_timeout_s=5)
c.start_heartbeats()
c.topology_barrier(60)
x = torch.ones(1 << 20, device="cuda")
dist.all_reduce(x)
if rank == 1:
    # alive but silent: no heartbeats, never in the next collective
    c.stop_watchdog()
    time.sleep(600)
c.start_watchdog(lambda verdict: (print("verdict", verdict, flush=True),
                                  os._exit(76)))
print("blocked", time.monotonic(), flush=True)
dist.all_reduce(x)
print("COLLECTIVE-RETURNED", flush=True)
"""


def test_sideband_exits_76_out_of_a_blocked_gloo_collective(gen):
    """Rank 0 blocked in a gloo all-reduce of a CUDA tensor whose peer
    stopped heartbeating: the sideband thread exits 76 within the 5 s
    death window plus a 10 s slack."""
    import time

    procs = _ranks(_BLOCKED_RANK)
    try:
        out0 = procs[0].communicate(timeout=120)[0]
        exited = time.monotonic()   # CLOCK_MONOTONIC: the children's too
    finally:
        procs[1].kill()
        procs[1].communicate()
    assert procs[0].returncode == 76, out0
    assert "verdict" in out0 and "peer_death" in out0, out0
    assert "COLLECTIVE-RETURNED" not in out0
    blocked = float(out0.split("blocked ")[1].split()[0])
    print(f"exit 76 {exited - blocked:.2f} s after the block began")
    assert exited - blocked <= 5 + 10


def test_philox_mask_source_keep_rate_and_determinism(gen):
    import math

    from megatron_tpu_torch.parallel.random import (
        RngStreams, default_mask_source,
    )

    key = RngStreams(1234).dropout(7).fold_in(2).fold_in(5).split(3)[1]
    shape, rate = (16, 2048, 512), 0.1
    dev = torch.device("cuda")
    m = default_mask_source(key, shape, rate, dev)
    assert m.device.type == "cuda" and m.dtype == torch.bool
    n = m.numel()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(float(m.float().mean()) - (1 - rate)) < 4 * sigma
    assert torch.equal(m, default_mask_source(key, shape, rate, dev))
    assert not torch.equal(m, default_mask_source(key.fold_in(0), shape,
                                                  rate, dev))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_import_into_a_captured_engine_replays_the_uninterrupted_tokens(
        gen, paged, temperature):
    """Export mid-decode from one captured engine, import into another
    (its KV written in place into the graph's tensors), and decode by
    replay: the tokens of an uninterrupted captured engine."""
    import numpy as np

    from megatron_tpu_torch.inference.engine import Request
    from megatron_tpu_torch.inference.fleet.migration import (
        pack_state, unpack_state,
    )

    cfg, params = _serving_model()
    prompt = np.asarray(_PROMPTS[1], np.int32)

    def request():
        return Request(prompt=prompt.copy(), max_new_tokens=24,
                       temperature=temperature, seed=5)

    solo = _engine(cfg, params, paged)
    want = solo.submit(request())
    solo.run_until_idle()
    src = _engine(cfg, params, paged)
    r = src.submit(request())
    for _ in range(6):
        src.step()
    assert not r.done.is_set()
    dst = _engine(cfg, params, paged)
    assert dst.capture_seconds is not None
    caches = [c.data_ptr() for c in dst.caches]
    req, path = dst.import_request_state(
        *unpack_state(pack_state(*src.export_request_state(r))))
    assert path == "kv_import"
    assert [c.data_ptr() for c in dst.caches] == caches
    dst.run_until_idle()
    torch.cuda.synchronize()
    assert req.error is None and req.generated == want.generated
    assert dst.stats["decode_recompiles"] == 0
