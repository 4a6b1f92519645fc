#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (megatron_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which ends the run with a non-zero exit code on failure:

  1. build    compile every kernel of the serving path from
              megatron_tpu_torch/csrc (one nvcc per source, all started
              together) and print the build seconds and -Xptxas -v lines.
  2. kernels  call each kernel's wrapper on the card at the serving path's
              shapes (Llama-2-7B: H=32, D=128) and hold it against its
              plain PyTorch version on the same bf16 inputs, computed in
              fp32. Tolerance: |kernel - plain| <= 2e-2 + 2e-2 * |plain|
              elementwise (bf16 inputs and outputs; the kernels also round
              P to bf16 for the tensor cores). Time kernel, plain version
              and one PyTorch library call (scaled_dot_product_attention,
              a yardstick the port never calls) with CUDA events, and
              compute each case's bound from its shapes.
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
              dense-fallback warning.
  4. report   one JSON line listing each kernel with its launches on the
              serving run, then the card's name and power limit, then
              {"ok": true, "device": {...}} as the last line.

It needs one CUDA card; with none (or outside a checkout) it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
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
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
SEED = 1234
NUM_LAYERS = 32
PROMPT_LENS = (5, 100, 700, 1500)
NEW_TOKENS = 32
MATCH_GATE = 0.99

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
    largest bucket at 2048-token slots (its reported case)."""
    cases = [dict(S=64, hq=32, hkv=32, window=None),
             dict(S=512, hq=32, hkv=32, window=None),
             dict(S=2047, hq=32, hkv=32, window=None),
             dict(S=2047, hq=32, hkv=8, window=256)]
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


def main() -> int:
    try:
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

        fwd = check_flash_fwd(torch, F, ft, card)
        dec = check_flash_decode(torch, F, ft, card)
        launches = serve(torch, ft, card)

        kernels = []
        for rep, source, line in ((fwd, "flash_fwd.cu", 92),
                                  (dec, "flash_decode.cu", 419)):
            kernels.append({
                "name": rep["name"], "route": "cuda",
                "source": f"megatron_tpu_torch/csrc/{source}",
                "replaces": f"{TPU_KERNELS}:{line}",
                "launches": launches[rep["name"]],
                "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"], "shape": rep["shape"]})
        emit({"kernels": kernels, "card": card})
        print(card_line(), flush=True)
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
