#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (megatron_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases; any that fails makes the run exit non-zero (the later phases
still run, so one call shows every failure):

  1. build    compile every kernel from megatron_tpu_torch/csrc (one nvcc
              per source, all started together) and print the build
              seconds and -Xptxas -v lines.
  2. kernels  call each forward kernel's wrapper on the card at the serving
              and training paths' shapes (Llama-2-7B: H=32, D=128; S up
              to 2047 for serving, 4096 for training) and hold it against
              its plain PyTorch version on the same bf16 inputs, computed
              in fp32. Tolerance: |kernel - plain| <= 2e-2 + 2e-2 * |plain|
              elementwise (bf16 inputs and outputs; the kernels also round
              P to bf16 for the tensor cores). Time kernel, plain version
              and one PyTorch library call (scaled_dot_product_attention,
              a yardstick the port never calls) with CUDA events, and
              compute each case's bound from its shapes.
  2b. backward  the dq and dk/dv kernels at the training shapes (S 4096,
              H 32, D 128 causal; GQA G=4 with window 256; ragged S 1000)
              against the plain fp32 backward of the same bf16 inputs and
              the same o/lse. Tolerance relative to each tensor's largest
              plain magnitude M: |kernel - plain| <= 2e-3 * M + 2e-2 *
              |plain| (the JAX package's own backward test,
              tests/test_pallas_attention.py; the kernels round p and ds to
              bf16 for the tensor cores, the plain version keeps fp32).
              The library yardstick is the backward of
              scaled_dot_product_attention at the same shape.
  3. serving  start the port's HTTP server in-process (Llama-2-7B at full
              width and depth, random init from a seed, bf16, 8 slots,
              2048-token slots, null tokenizer), send 4 concurrent greedy
              requests of 5, 100, 700 and 1500 prompt tokens x 32 new
              tokens, repeat one, teacher-force every finished sequence
              through the plain path (the dense attention) and require
              the engine's token to be its argmax, or a near-tie within
              the plain bf16 path's own error against fp32, at >= 99% of
              positions (teacher_force), and require the launch counters
              to equal 32 x prefills and 32 x decode ticks with no
              dense-fallback warning. The model and cache are freed
              before training.
  4. training write a synthetic corpus (Zipf token ids, 32000 vocab, from
              SEED) with the port's MMapIndexedDatasetBuilder into
              megatron_tpu_torch/build/, then call
              megatron_tpu_torch.tools.pretrain_gpt.main in-process:
              Llama-2-7B at full width cut to 8 layers, S 4096, bf16,
              micro-batch 1, global batch 2 (2 microbatches), selective
              recompute, the flash kernels, 8 steps at a constant lr
              TRAIN_LR, an evaluation every 4 steps. Require finite
              losses, no skipped step, a first loss within 0.5 of
              first_loss_expected(), a last loss at least LOSS_DROP_GATE
              below the first, exact launch counts (see
              expected_train_launches) and no dense-fallback warning;
              print step time, tokens/s, MFU and peak memory.
  4b. dense   one forward + backward of a 2-layer model of the same width
              at S 4096, same init and batch, through the kernels and
              through the dense attention with autograd: the loss, the
              gradient norm and every gradient leaf must agree (gates at
              the constants below).
  5. report   one JSON line listing each kernel with its launches on its
              path (serving and training), then the card's name and power
              limit, then {"ok": true, "device": {...}} as the last line.

It needs one CUDA card; with none (or outside a checkout) it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
import warnings

ATOL = 2e-2
RTOL = 2e-2
# backward kernels: err <= BWD_ATOL_REL * max|plain| + BWD_RTOL * |plain|,
# the JAX package's own backward gate. The kernels round p and ds to bf16
# (relative error 2^-9) before summing them over up to 4096 keys or
# queries, and write bf16; on the card the largest error was 0.035 on a dv
# whose largest value is 11.2 (window 256, G = 4), inside the gate.
BWD_ATOL_REL = 2e-3
BWD_RTOL = 2e-2
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
SEED = 1234
NUM_LAYERS = 32
PROMPT_LENS = (5, 100, 700, 1500)
NEW_TOKENS = 32
MATCH_GATE = 0.99

# phase 4: Llama-2-7B width cut to TRAIN_LAYERS layers
TRAIN_LAYERS = 8
TRAIN_SEQ = 4096
TRAIN_ITERS = 8
TRAIN_MICRO, TRAIN_GLOBAL = 1, 2
EVAL_INTERVAL, EVAL_ITERS = 4, 1
VOCAB = 32000
CORPUS_DOCS = 64              # 1024..3072 tokens each: ~131k tokens
ZIPF_A = 1.2
# Adam's first update is lr * sign(g) on every one of the 1.88 B weights
# (bias correction makes m/sqrt(v) = g/|g|), a step far outside the
# region where the loss is locally linear: on the card a constant 3e-4
# sent the loss from 11.30 to 26.90 after the first step and it was still
# at 12.79 after 8. At 1e-5 it falls from the first step on.
TRAIN_LR = "1e-5"
FIRST_LOSS_WINDOW = 0.5       # |first loss - first_loss_expected()| <= this
# first loss - last loss >= this; the card measured a drop of 2.34 nats
# (11.30 -> 8.97) at these settings, so the gate leaves room for noise
LOSS_DROP_GATE = 1.0
# phase 4b: kernel step vs dense step. Measured on the card: loss 2.5e-4
# apart, grad norm 9e-7 relative, every leaf within 5.6e-3 of its max (one
# to two bf16 ulps of the largest gradient)
STEP_LOSS_ATOL = 2e-2
STEP_NORM_RTOL = 2e-2
STEP_LEAF_TOL = 2e-2          # max|kernel - dense| / max|dense| per leaf

REPO = os.path.dirname(os.path.abspath(__file__))
TPU_KERNELS = "megatron_tpu/ops/pallas/flash_template.py"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, budget_ms: float = 200.0) -> float:
    """Mean device time of fn() over a warm run of launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    iters = int(max(3, min(100, budget_ms / one)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa(F, q, k, v, **kw):
    """One scaled_dot_product_attention call on [B, S, H, D] inputs (the
    library yardstick; the port never calls it). GQA goes through
    enable_gqa where this PyTorch has it, else K/V are expanded once,
    outside the timed call."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    g = q.shape[2] // k.shape[2]
    if g > 1:
        try:
            F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
            kw["enable_gqa"] = True
        except TypeError:
            kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def compare(torch, got, want):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= ATOL + RTOL * want.float().abs()).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def check_flash_fwd(torch, F, ft, card):
    """Prefill forward at Llama-2-7B widths; S = 2047 is the engine's
    largest bucket at 2048-token slots (its reported case), S = 4096 the
    training path's sequence."""
    cases = [dict(S=64, hq=32, hkv=32, window=None),
             dict(S=512, hq=32, hkv=32, window=None),
             dict(S=2047, hq=32, hkv=32, window=None),
             dict(S=2047, hq=32, hkv=8, window=256),
             dict(S=4096, hq=32, hkv=32, window=None)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    D, worst, report = 128, 0.0, None
    for c in cases:
        S, hq, hkv, W = c["S"], c["hq"], c["hkv"], c["window"]
        q = torch.randn(1, S, hq, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn(1, S, hkv, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn(1, S, hkv, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        o, lse = ft.flash_fwd(q, k, v, causal=True, sliding_window=W)
        torch.cuda.synchronize()
        o_ref, lse_ref = ft.flash_fwd_reference(
            q.float(), k.float(), v.float(), causal=True, sliding_window=W)
        err, ok = compare(torch, o, o_ref)
        lerr, lok = compare(torch, lse, lse_ref)
        ms = cuda_ms(torch, lambda: ft.flash_fwd(q, k, v, sliding_window=W))
        plain_ms = cuda_ms(torch, lambda: ft.flash_fwd_reference(
            q, k, v, sliding_window=W))
        if W is None:
            library_ms = cuda_ms(torch, sdpa(F, q, k, v, is_causal=True))
        else:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
            library_ms = cuda_ms(torch, sdpa(F, q, k, v, attn_mask=mask))
        rows = torch.arange(S, dtype=torch.float64)
        pairs = float((rows + 1).clamp(max=W).sum() if W else
                      (rows + 1).sum())
        flops = 4.0 * D * hq * pairs
        nbytes = 2.0 * (2 * S * hq * D + 2 * S * hkv * D) + 4.0 * hq * S
        bound_ms, bound_by = bound(flops, nbytes)
        line = {"phase": "kernel", "name": "flash_fwd", "card": card,
                "shape": f"B=1 S={S} Hq={hq} Hkv={hkv} D={D} window={W}",
                "max_abs_err": err, "lse_max_abs_err": lerr,
                "ok": ok and lok, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
        emit(line)
        if not (ok and lok):
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version: {line}")
        worst = max(worst, err, lerr)
        if S == 2047 and W is None:
            report = line
    return dict(report, max_abs_err=worst)


def check_flash_decode(torch, F, ft, card):
    """One decode tick's attention at 8 slots x 2048 positions with ragged
    prefixes (the G = 1, Sq = 1 case is the serving path's and is the
    reported one), plus GQA G = 4 and the Sq = 5 verify form."""
    B, S, D = 8, 2048, 128
    base = [1, 63, 64, 2047, 2048, 500, 1000, 1500]
    cases = [dict(sq=1, hq=32, hkv=32), dict(sq=1, hq=32, hkv=8),
             dict(sq=5, hq=32, hkv=8), dict(sq=5, hq=32, hkv=32)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst, report = 0.0, None
    for c in cases:
        sq, hq, hkv = c["sq"], c["hq"], c["hkv"]
        lens_list = [min(n, S - sq + 1) for n in base]
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        q = torch.randn(B, sq, hq, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn(B, S, hkv, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn(B, S, hkv, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        o = ft.flash_decode(q, k, v, lens)
        torch.cuda.synchronize()
        o_ref = ft.flash_decode_reference(q.float(), k.float(), v.float(),
                                          lens)
        err, ok = compare(torch, o, o_ref)
        ms = cuda_ms(torch, lambda: ft.flash_decode(q, k, v, lens))
        plain_ms = cuda_ms(torch, lambda: ft.flash_decode_reference(
            q, k, v, lens))
        kpos = torch.arange(S, device="cuda")
        qpos = lens[:, None].long() - 1 + torch.arange(sq, device="cuda")
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        library_ms = cuda_ms(torch, sdpa(F, q, k, v, attn_mask=mask))
        visible_kv = sum(min(S, n + sq - 1) for n in lens_list)
        pairs = sum(min(S, n + j) for n in lens_list for j in range(sq))
        flops = 4.0 * D * hq * pairs
        nbytes = (2.0 * 2 * visible_kv * hkv * D + 2.0 * 2 * B * sq * hq * D
                  + 4.0 * B)
        bound_ms, bound_by = bound(flops, nbytes)
        line = {"phase": "kernel", "name": "flash_decode", "card": card,
                "shape": f"B={B} S={S} Sq={sq} Hq={hq} Hkv={hkv} D={D} "
                         f"kv_lengths={lens_list}",
                "max_abs_err": err, "ok": ok, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
        emit(line)
        if not ok:
            raise AssertionError(f"flash_decode disagrees with its plain "
                                 f"version: {line}")
        worst = max(worst, err)
        if sq == 1 and hq == hkv:
            report = line
    return dict(report, max_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 2b: backward kernels vs the plain backward
# ---------------------------------------------------------------------------


def sdpa_backward(torch, F, q, k, v, do, **kw):
    """The backward of one scaled_dot_product_attention call (dq, dk and
    dv together), as a closure over a forward run once outside the
    timing; the library yardstick, never called by the port."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = sdpa(F, q, k, v, **kw)()
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v), dot,
                                       retain_graph=True)


def compare_rel(got, want):
    """(max |err|, max |plain|, ok) under the backward tolerance."""
    want = want.float()
    m = float(want.abs().max())
    err = (got.float() - want).abs()
    ok = bool((err <= BWD_ATOL_REL * m + BWD_RTOL * want.abs()).all())
    return float(err.max()), m, ok


def check_flash_bwd(torch, F, ft, card):
    """dq and dk/dv at the training shapes. Bounds: dq does 3 products of
    2·D FLOPs per visible (q, k) pair and query head (S = q·kᵀ, dP =
    dO·vᵀ, dQ = dS·k), dk/dv 4 (S, dP, dV = Pᵀ·dO, dK = dSᵀ·q); bytes are
    each input read once and each output written once."""
    cases = [dict(S=4096, hq=32, hkv=32, window=None),
             dict(S=4096, hq=32, hkv=8, window=256),
             dict(S=1000, hq=32, hkv=32, window=None)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    D = 128
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    report = {}
    for c in cases:
        S, hq, hkv, W = c["S"], c["hq"], c["hkv"], c["window"]
        q, do = (torch.randn(1, S, hq, D, generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(1, S, hkv, D, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        kw = dict(causal=True, sliding_window=W)
        o, lse = ft.flash_fwd(q, k, v, **kw)
        dsum = ft._bwd_dsum(o, do)
        dq = ft.flash_bwd_dq(q, k, v, do, lse, dsum, **kw)
        dk, dv = ft.flash_bwd_dkv(q, k, v, do, lse, dsum, **kw)
        torch.cuda.synchronize()
        want = ft.flash_bwd_reference(q.float(), k.float(), v.float(), o,
                                      lse, do, **kw)
        errs = {n: compare_rel(g, w)
                for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        del want
        ms = {"flash_bwd_dq": cuda_ms(torch, lambda: ft.flash_bwd_dq(
                  q, k, v, do, lse, dsum, **kw)),
              "flash_bwd_dkv": cuda_ms(torch, lambda: ft.flash_bwd_dkv(
                  q, k, v, do, lse, dsum, **kw))}
        # the plain version of both kernels is one function (the CPU path
        # of both wrappers); it computes dq, dk and dv together
        plain_ms = cuda_ms(torch, lambda: ft._bwd_plain(
            q, k, v, do, lse, dsum, True, W, 0))
        if W is None:
            lib = sdpa_backward(torch, F, q, k, v, do, is_causal=True)
        else:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
            lib = sdpa_backward(torch, F, q, k, v, do, attn_mask=mask)
        library_ms = cuda_ms(torch, lib)
        del lib
        rows = torch.arange(S, dtype=torch.float64)
        pairs = float((rows + 1).clamp(max=W).sum() if W else
                      (rows + 1).sum())
        stats = 4.0 * 2 * hq * S                       # lse and dsum
        q_bytes, kv_bytes = 2.0 * S * hq * D, 2.0 * S * hkv * D
        work = {
            "flash_bwd_dq": (6.0 * D * hq * pairs,
                             3 * q_bytes + 2 * kv_bytes + stats),
            "flash_bwd_dkv": (8.0 * D * hq * pairs,
                              2 * q_bytes + 4 * kv_bytes + stats)}
        for name, tensors in (("flash_bwd_dq", ("dq",)),
                              ("flash_bwd_dkv", ("dk", "dv"))):
            bound_ms, bound_by = bound(*work[name])
            err = max(errs[t][0] for t in tensors)
            ok = all(errs[t][2] for t in tensors)
            line = {"phase": "kernel", "name": name, "card": card,
                    "shape": f"B=1 S={S} Hq={hq} Hkv={hkv} D={D} window={W}",
                    "max_abs_err": err,
                    "max_abs_plain": {t: errs[t][1] for t in tensors},
                    "ok": ok, "ms": ms[name], "plain_ms": plain_ms,
                    "plain_computes": "dq, dk and dv",
                    "library_ms": library_ms,
                    "library_computes": "dq, dk and dv (SDPA backward)",
                    "bound_ms": bound_ms, "bound_by": bound_by}
            emit(line)
            if not ok:
                raise AssertionError(f"{name} disagrees with the plain "
                                     f"backward: {line}")
            worst[name] = max(worst[name], err)
            if S == 4096 and W is None:
                report[name] = line
        del q, k, v, do, o, lse, dsum, dq, dk, dv
        torch.cuda.empty_cache()
    return {n: dict(report[n], max_abs_err=worst[n]) for n in report}


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


def _put(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _metric(text: str, name: str) -> float:
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[1])
    raise KeyError(name)


def serve(torch, ft, card):
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg = presets.from_model_name("llama2-7B")
    assert cfg.num_layers == NUM_LAYERS and cfg.attention_impl == "pallas"
    t0 = time.monotonic()
    params = init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    # the null tokenizer's eod id is its vocab_size: 32000 sits outside
    # the 32000-row embedding table, so it is never sampled and never fed
    # (every prompt id below is < 32000)
    tokenizer = NullTokenizer(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()

    ready, handles = threading.Event(), []
    thread = threading.Thread(
        target=run_server, daemon=True, name="smoke-server",
        kwargs=dict(cfg=cfg, params=params, tokenizer=tokenizer,
                    host="127.0.0.1", port=0, engine_slots=8,
                    engine_max_seq_len=2048, device="cuda", ready=ready,
                    service_out=handles))
    thread.start()
    if not ready.wait(300):
        raise RuntimeError("server did not start")
    service, server = handles
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
                   for n in PROMPT_LENS]
        results = [None] * len(prompts)

        def one(i):
            t = time.monotonic()
            status, body = _put(base + "/api", {
                "prompts": [" ".join(map(str, prompts[i]))],
                "tokens_to_generate": NEW_TOKENS, "temperature": 0.0})
            results[i] = (status, body, time.monotonic() - t)

        eng = service.engine
        # the main path's run: every count starts at 0 here
        ft.flash_fwd.launches = 0
        ft.flash_decode.launches = 0
        prefills0, ticks0 = eng.stats["admitted"], eng.stats["ticks"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t_conc = time.monotonic()
            workers = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(900)
            conc_s = time.monotonic() - t_conc
            status, repeat = _put(base + "/api", {
                "prompts": [" ".join(map(str, prompts[1]))],
                "tokens_to_generate": NEW_TOKENS, "temperature": 0.0})
        launches = {"flash_fwd": ft.flash_fwd.launches,
                    "flash_decode": ft.flash_decode.launches}
        prefills = eng.stats["admitted"] - prefills0
        ticks = eng.stats["ticks"] - ticks0

        generated = []
        for i, res in enumerate(results):
            if res is None or res[0] != 200:
                raise AssertionError(f"request {i} failed: {res}")
            toks = [int(t) for t in res[1]["text"][0].split()]
            if toks[:len(prompts[i])] != prompts[i] or \
                    len(toks) != len(prompts[i]) + NEW_TOKENS:
                raise AssertionError(
                    f"request {i}: {len(toks)} tokens for a "
                    f"{len(prompts[i])}-token prompt + {NEW_TOKENS}")
            generated.append(toks[len(prompts[i]):])
        if status != 200 or repeat["text"][0] != results[1][1]["text"][0]:
            raise AssertionError("repeated greedy request changed its text")
        fallbacks = [str(w.message) for w in caught
                     if "falling back" in str(w.message)]
        if fallbacks:
            raise AssertionError(f"dense fallback fired: {fallbacks}")
        want = {"flash_fwd": NUM_LAYERS * prefills,
                "flash_decode": NUM_LAYERS * ticks}
        if launches != want or prefills != len(prompts) + 1:
            raise AssertionError(f"launches {launches} != {want} "
                                 f"(prefills {prefills}, ticks {ticks})")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        server.shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")

    del service, server, handles
    torch.cuda.empty_cache()
    tf = teacher_force(torch, dataclasses, cfg, params, prompts, generated)

    ttft = (_metric(metrics, "engine_ttft_seconds_sum")
            / _metric(metrics, "engine_ttft_seconds_count"))
    tpot = (_metric(metrics, "engine_time_per_output_token_seconds_sum")
            / _metric(metrics, "engine_time_per_output_token_seconds_count"))
    line = {"phase": "serving", "card": card, "model": "llama2-7B",
            "layers": NUM_LAYERS, "slots": 8, "max_seq_len": 2048,
            "param_init_s": init_s,
            "requests": [{"prompt_tokens": len(p), "new_tokens": len(g),
                          "wall_s": res[2]}
                         for p, g, res in zip(prompts, generated, results)],
            "concurrent_wall_s": conc_s,
            "tokens_per_s": len(prompts) * NEW_TOKENS / conc_s,
            "ttft_mean_s": ttft, "per_token_mean_s": tpot,
            "prefills": prefills, "decode_ticks": ticks,
            "launches": launches,
            "max_memory_allocated_gib": peak_gib, **tf}
    emit(line)
    if tf["teacher_forced_match"] < MATCH_GATE:
        raise AssertionError(
            f"teacher-forced match {tf['teacher_forced_match']:.4f} < "
            f"{MATCH_GATE} (argmax or a near-tie within the plain bf16 "
            "path's own error)")
    return launches


def teacher_force(torch, dataclasses, cfg, params, prompts, generated):
    """Hold the engine's greedy tokens against the plain path.

    Each finished sequence is teacher-forced through lm_forward with the
    dense attention (the plain path) in bf16, and through the same plain
    path in fp32 (weights upcast) as the referee. A position agrees when
    the engine's token is the bf16 plain argmax, or a near-tie: its
    plain logit lies within that position's bf16 error band, the largest
    |bf16 plain - fp32 plain| logit difference there. A random-init 7B
    in bf16 has logit gaps of the order of that band (the bf16 plain
    path's own argmax matches the fp32 one at ~90% of positions), so a
    strict argmax gate would test bf16 rounding, not the engine; the
    strict rates are reported beside the gate."""
    from megatron_tpu_torch.models.language_model import lm_forward

    plain = dataclasses.replace(cfg, attention_impl="xla")
    ref = dataclasses.replace(plain, params_dtype="float32")

    def up(t):
        return ({k: up(v) for k, v in t.items()} if isinstance(t, dict)
                else t.float())

    params32 = up(params)
    strict = near = plain_vs_fp32 = total = 0
    worst_gap = 0.0
    with torch.no_grad():
        for prompt, gen in zip(prompts, generated):
            seq = torch.tensor([prompt + gen[:-1]], device="cuda")
            p0 = len(prompt) - 1          # logits from the last prompt row
            lb = lm_forward(plain, params, seq)[0, p0:].float()
            l32 = lm_forward(ref, params32, seq)[0, p0:]
            tok = torch.tensor(gen, device="cuda")
            gap = lb.max(-1).values - lb.gather(1, tok[:, None])[:, 0]
            band = (lb - l32).abs().max(-1).values
            strict += int((lb.argmax(-1) == tok).sum())
            near += int((gap <= band).sum())
            plain_vs_fp32 += int((lb.argmax(-1) == l32.argmax(-1)).sum())
            total += len(gen)
            worst_gap = max(worst_gap, float(gap.max()))
    del params32
    torch.cuda.empty_cache()
    return {"teacher_forced_match": near / total,
            "teacher_forced_strict_argmax": strict / total,
            "plain_bf16_vs_fp32_argmax": plain_vs_fp32 / total,
            "teacher_forced_worst_gap": worst_gap,
            "teacher_forced_positions": total}


# ---------------------------------------------------------------------------
# phase 4: training through the entry point
# ---------------------------------------------------------------------------


def zipf_tokens(np, rng, n):
    """Zipf-distributed ids folded into the vocab: a skewed unigram a
    model learns within a few steps, unlike uniform noise."""
    return (rng.zipf(ZIPF_A, size=n) - 1) % VOCAB


def write_corpus(np, prefix: str) -> int:
    from megatron_tpu_torch.data.indexed_dataset import (
        MMapIndexedDatasetBuilder,
    )

    rng = np.random.default_rng(SEED)
    builder = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    n_tokens = 0
    for _ in range(CORPUS_DOCS):
        n = int(rng.integers(1024, 3073))
        builder.add_item(zipf_tokens(np, rng, n).astype(np.uint16))
        builder.end_document()
        n_tokens += n
    builder.finalize(prefix + ".idx")
    return n_tokens


def first_loss_expected(cfg) -> float:
    """Cross-entropy of the random init: the LM head's weights (std
    init_method_std) over a unit-RMS final hidden state give logits of
    variance sigma^2 = std^2 * h, and E[logsumexp] of V such logits is
    about ln V + sigma^2 / 2 (10.37 + 0.82 for Llama-2-7B), while the
    target's logit averages 0."""
    sigma2 = cfg.init_method_std ** 2 * cfg.hidden_size
    return math.log(cfg.vocab_size) + sigma2 / 2


def expected_train_launches(n_micro: int) -> dict:
    """Launch counts of the training run. Every layer of every microbatch
    of every step runs one dq and one dk/dv launch in its backward.
    Under selective recompute each layer's core attention is
    checkpointed, so its forward runs twice per microbatch (once in the
    forward pass, once recomputed in the backward); each evaluation
    batch runs one more forward per layer."""
    n_evals = TRAIN_ITERS // EVAL_INTERVAL
    bwd = TRAIN_LAYERS * n_micro * TRAIN_ITERS
    return {"flash_fwd": 2 * bwd + TRAIN_LAYERS * n_evals * EVAL_ITERS,
            "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd, "flash_decode": 0}


def train(torch, np, ft, card):
    from megatron_tpu_torch.models.params import num_params
    from megatron_tpu_torch.tools import pretrain_gpt

    build_dir = os.path.join(REPO, "megatron_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    prefix = os.path.join(build_dir, "smoke_corpus")
    corpus_tokens = write_corpus(np, prefix)
    argv = ["--model_name", "llama2-7B", "--num_layers", str(TRAIN_LAYERS),
            "--seq_length", str(TRAIN_SEQ), "--bf16",
            "--micro_batch_size", str(TRAIN_MICRO),
            "--global_batch_size", str(TRAIN_GLOBAL),
            "--train_iters", str(TRAIN_ITERS), "--log_interval", "1",
            "--eval_interval", str(EVAL_INTERVAL),
            "--eval_iters", str(EVAL_ITERS), "--lr", TRAIN_LR,
            "--lr_decay_style", "constant", "--clip_grad", "1.0",
            "--recompute_granularity", "selective",
            "--attention_impl", "pallas", "--data_path", prefix,
            "--split", "90,10,0", "--seed", str(SEED), "--device", "cuda"]
    log_lines = []

    def log(msg):
        log_lines.append(msg)
        print(msg, flush=True)

    torch.cuda.reset_peak_memory_stats()
    # the main path's run: every count starts at 0 here
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_decode"):
        getattr(ft, name).launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.monotonic()
        loop = pretrain_gpt.main(argv, log=log)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    launches = {n: getattr(ft, n).launches for n in
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_decode")}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    cfg = loop.cfg.model
    hist = loop.history
    losses = [h["lm_loss"] for h in hist]
    steps_s = sorted(h["window_s"] for h in hist[1:])   # step 1 warms up
    step_s = steps_s[len(steps_s) // 2] if steps_s else float("nan")
    tokens_per_step = TRAIN_GLOBAL * TRAIN_SEQ
    tokens_per_s = tokens_per_step / step_s
    model_flops_per_token = 3.0 * cfg.flops_per_token_fwd()
    n_micro = TRAIN_GLOBAL // TRAIN_MICRO
    want = expected_train_launches(n_micro)
    fallbacks = [str(w.message) for w in caught
                 if "falling back" in str(w.message)
                 or "flash_bwd disabled" in str(w.message)]
    line = {"phase": "training", "card": card, "model": "llama2-7B",
            "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "seq_length": cfg.seq_length, "params": num_params(cfg),
            "micro_batch": TRAIN_MICRO, "global_batch": TRAIN_GLOBAL,
            "recompute": loop.cfg.training.recompute_granularity,
            "corpus_tokens": corpus_tokens, "wall_s": wall_s,
            "lr": float(TRAIN_LR), "losses": losses,
            "first_loss_expected": first_loss_expected(cfg),
            "evals": [e["lm_loss"] for e in loop.evals],
            "skipped": [h["skipped"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_times_s": [h["window_s"] for h in hist],
            "step_s_median": step_s, "tokens_per_s": tokens_per_s,
            "model_tflops_per_s": tokens_per_s * model_flops_per_token / 1e12,
            "mfu": tokens_per_s * model_flops_per_token / PEAK_BF16_FLOPS,
            "max_memory_allocated_gib": peak_gib,
            "launches": launches, "expected_launches": want}
    emit(line)
    del loop
    first, last = (losses[0], losses[-1]) if losses else (math.nan,) * 2
    problems = []
    if len(losses) != TRAIN_ITERS or not all(map(math.isfinite, losses)):
        problems.append(f"losses {losses}")
    if any(h["skipped"] for h in hist):
        problems.append("a step was skipped")
    if not abs(first - first_loss_expected(cfg)) <= FIRST_LOSS_WINDOW:
        problems.append(f"first loss {first} not within "
                        f"{FIRST_LOSS_WINDOW} of {first_loss_expected(cfg)}")
    if not first - last >= LOSS_DROP_GATE:
        problems.append(f"loss fell by {first - last}, gate "
                        f"{LOSS_DROP_GATE}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if fallbacks:
        problems.append(f"dense fallback fired: {fallbacks}")
    if len(line["evals"]) != TRAIN_ITERS // EVAL_INTERVAL:
        problems.append(f"evaluations {line['evals']}")
    if problems:
        raise AssertionError("training: " + "; ".join(problems))
    return launches


def step_vs_dense(torch, np, ft, card):
    """One forward + backward of the same 2-layer model on the same batch
    through the kernels (attention_impl="pallas") and through the dense
    attention with autograd ("xla")."""
    import dataclasses

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.language_model import lm_loss
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.training.optimizer import (
        global_grad_norm, leaf_paths,
    )

    cfg = dataclasses.replace(presets.llama2("7B"), num_layers=2)
    params = init_params(cfg, SEED, device="cuda")
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(SEED + 4)
    text = torch.from_numpy(zipf_tokens(np, rng, TRAIN_SEQ + 1)
                            .astype(np.int64)[None]).cuda()
    batch = {"tokens": text[:, :-1], "labels": text[:, 1:]}
    runs = {}
    for impl in ("pallas", "xla"):
        before = {n: getattr(ft, n).launches
                  for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        loss, _ = lm_loss(dataclasses.replace(cfg, attention_impl=impl),
                          params, batch, recompute="selective")
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in leaf_paths(params)}
        for _, p in leaf_paths(params):
            p.grad = None
        ran = {n: getattr(ft, n).launches - before[n] for n in before}
        runs[impl] = (float(loss.detach()), grads,
                      float(global_grad_norm(grads)), ran)
    (lk, gk, nk, ran_k), (ld, gd, nd, ran_d) = runs["pallas"], runs["xla"]
    leaf_err = {n: float((gk[n].float() - gd[n].float()).abs().max())
                / max(float(gd[n].float().abs().max()), 1e-30) for n in gd}
    line = {"phase": "kernel_vs_dense_step", "card": card,
            "model": "llama2-7B", "layers": 2, "seq_length": TRAIN_SEQ,
            "loss_kernels": lk, "loss_dense": ld, "loss_abs_diff": abs(lk - ld),
            "grad_norm_kernels": nk, "grad_norm_dense": nd,
            "grad_norm_rel_diff": abs(nk - nd) / nd,
            "leaf_rel_err": leaf_err,
            "worst_leaf_rel_err": max(leaf_err.values()),
            "kernel_launches": ran_k, "dense_launches": ran_d,
            "gates": {"loss_atol": STEP_LOSS_ATOL,
                      "grad_norm_rtol": STEP_NORM_RTOL,
                      "leaf_rel": STEP_LEAF_TOL}}
    emit(line)
    problems = []
    if not abs(lk - ld) <= STEP_LOSS_ATOL:
        problems.append(f"loss {lk} vs {ld}")
    if not abs(nk - nd) <= STEP_NORM_RTOL * nd:
        problems.append(f"grad norm {nk} vs {nd}")
    bad = {n: e for n, e in leaf_err.items() if not e <= STEP_LEAF_TOL}
    if bad:
        problems.append(f"gradient leaves {bad}")
    if min(ran_k.values()) < 2 or any(ran_d.values()):
        problems.append(f"kernel run launched {ran_k}, dense run {ran_d}")
    if problems:
        raise AssertionError("kernel step vs dense step: "
                             + "; ".join(problems))


def free_cuda(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from megatron_tpu_torch.ops.flash import build
        from megatron_tpu_torch.ops.flash import flash_template as ft
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = card_line()
        emit({"phase": "device", "card": card,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        t0 = time.monotonic()
        built = build.build()
        emit({"phase": "build", "card": card,
              "wall_s": time.monotonic() - t0,
              "kernels": {n: {"seconds": b["seconds"], "ptxas": b["ptxas"]}
                          for n, b in built.items()}})
    except Exception:  # noqa: BLE001 - nothing runs without the kernels
        traceback.print_exc()
        return 1

    failed, results = [], {}

    def phase(name, fn, *args):
        try:
            results[name] = fn(*args)
        except Exception:  # noqa: BLE001 - any failed phase fails the run
            traceback.print_exc()
            failed.append(name)
        free_cuda(torch)

    phase("flash_fwd", check_flash_fwd, torch, F, ft, card)
    phase("flash_decode", check_flash_decode, torch, F, ft, card)
    phase("flash_bwd", check_flash_bwd, torch, F, ft, card)
    phase("serving", serve, torch, ft, card)
    phase("training", train, torch, np, ft, card)
    phase("kernel_vs_dense_step", step_vs_dense, torch, np, ft, card)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    serving, training = results["serving"], results["training"]
    reports = {"flash_fwd": results["flash_fwd"],
               "flash_decode": results["flash_decode"],
               **results["flash_bwd"]}
    kernels = []
    for name, source, line in (("flash_fwd", "flash_fwd.cu", 92),
                               ("flash_decode", "flash_decode.cu", 419),
                               ("flash_bwd_dq", "flash_bwd.cu", 197),
                               ("flash_bwd_dkv", "flash_bwd.cu", 235)):
        rep = reports[name]
        by_path = {"serving": serving.get(name, 0),
                   "training": training.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"megatron_tpu_torch/csrc/{source}",
            "replaces": f"{TPU_KERNELS}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "shape": rep["shape"]})
    emit({"kernels": kernels, "card": card})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
