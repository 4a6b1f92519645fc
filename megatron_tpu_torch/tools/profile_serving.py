"""Where a serving tick's time goes on the card, eager against CUDA graph.

    python -m megatron_tpu_torch.tools.profile_serving [--ticks 10]
    python -m megatron_tpu_torch.tools.profile_serving --kv_paging
    python -m megatron_tpu_torch.tools.profile_serving --drafter model \\
        --draft_layers 4
    python -m megatron_tpu_torch.tools.profile_serving --kv_cache_int8 \\
        [--kv_paging]
    python -m megatron_tpu_torch.tools.profile_serving \\
        --model_name falcon-7B        # or gpt2-1.3B, any preset

Builds the engine as the server does (--model_name, default Llama-2-7B,
at full width and depth, random init, bf16, 8 slots x 2048 positions, or
x the position table of an absolute model, e.g. GPT-2's 1024) four
times in one
call: the plain tick and the speculative tick (k --spec_k, the n-gram
drafter, or with --drafter model the target's first --draft_layers
layers as the draft), each eager (cuda_graph=False) and as the captured
CUDA graph. Each engine gets the same 8 greedy requests (prompts of 5 to
1500 tokens at 2048 positions, scaled to a shorter slot; the
speculative engines' last prompt repeats a 64-token pattern so the
n-gram lookup has something to propose), warms up, then times --ticks
decode ticks with all 8 slots active under torch.profiler. The dense
engine also times one admission (prefill + first token) of the longest
prompt (1500 tokens into the 1536 bucket at 2048 positions).

With --kv_cache_int8 the four engines are the plain tick with bf16
caches and with int8 caches (ops/kv_quant.py: quantize on write,
dequantize the whole cache every layer), each eager and by graph; no
speculative tick is run then.

With --kv_paging it builds the paged engine instead (16-token pages,
32-token prefill chunks, the default pool), fills the 8 slots through
chunked prefill, times the decode ticks (page allocation included) and
one 32-token prefill chunk of a 1500-token prompt.

For each window it prints one JSON line: the host wall time of a run
without the profiler (ending in a synchronize), the summed device time
of the CUDA kernels the profiler saw in a second run of the same work,
the device idle share 1 - device/wall (one stream, so kernels do not
overlap), the kernels the device ran and the launch calls the host made
(a graph replay is one host call for its whole tick), the decode
kernels' launches a tick by query length (Sq 1, Sq k + 1), for
speculative ticks the tokens emitted a tick and a slot-tick, and the
kernels with the most device time. The graph engines also print their
capture time, and every engine's line its cache bytes and the peak
memory allocated since the engine was built. Every line carries the
card's name and power limit. CUDA only.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

#: host runtime calls that put work on the device
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def _window(torch, name, fn, card, top=8, extra=dict):
    """Time fn() on the host clock (ending in a synchronize), then run it
    again under the profiler for the kernels' device times, and print
    the window's breakdown with extra() (called after both runs). The
    profiler's own host overhead stays out of wall_ms. fn returns its
    step count. Returns (wall_ms, {kernel name: (device ms, count)})."""
    from torch.profiler import ProfilerActivity, profile

    from megatron_tpu_torch.ops.flash import flash_template as ft

    torch.cuda.synchronize()
    c0 = ft.launch_counts()
    t0 = time.perf_counter()
    n = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    c1 = ft.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, host_calls = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key in _LAUNCH_CALLS:
                host_calls += e.count
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us / 1e3,
                          e.count)
    device_ms = sum(ms for ms, _ in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    forms = {k: (c1[k] - c0.get(k, 0)) / n for k in c1
             if "/sq" in k and c1[k] != c0.get(k, 0)}
    print(json.dumps({
        "window": name, "card": card, "steps": n, "wall_ms": wall_ms,
        "wall_ms_per_step": wall_ms / n,
        "device_ms": device_ms if kernels else "not measured",
        "device_ms_per_step": device_ms / n if kernels else "not measured",
        "device_idle_share": (1 - device_ms / wall_ms) if kernels
        else "not measured",
        "device_kernels": sum(c for _, c in kernels.values()),
        "device_kernels_per_step": sum(c for _, c in kernels.values()) / n,
        "host_launch_calls_per_step": host_calls / n,
        "decode_launches_per_step_by_form": forms,
        **extra(),
        "top_kernels": [{"kernel": k[:90], "ms": ms, "count": c,
                         "share_of_device": ms / device_ms}
                        for k, (ms, c) in ranked]}), flush=True)
    return wall_ms, kernels


def _prompts(np, rng, cfg, lens, repeat):
    out = [rng.integers(0, cfg.vocab_size - 1, size=n).astype(np.int32)
           for n in lens]
    if repeat:
        pattern = rng.integers(0, cfg.vocab_size - 1, size=64)
        out[-1] = np.tile(pattern, -(-lens[-1] // 64))[:lens[-1]].astype(
            np.int32)
    return out


#: the prompt lengths of the 8 slots whose decode ticks are timed, at
#: 2048 positions a slot
TICK_LENS = (5, 100, 300, 500, 700, 1000, 1200, 1500)


def slot_len(cfg) -> int:
    """Positions a slot holds: 2048, or an absolute model's table if
    shorter (GPT-2: 1024)."""
    if cfg.position_embedding_type == "absolute":
        return min(2048, cfg.max_position_embeddings)
    return 2048


def tick_lens(cfg) -> tuple:
    """TICK_LENS scaled to the model's slot length."""
    n = slot_len(cfg)
    return tuple(max(1, t * n // 2048) for t in TICK_LENS)


def filled_engine(np, cfg, params, rng, *, paged, speculative=None,
                  graph=True, int8=False):
    """An 8-slot x slot_len(cfg) engine as the server builds it (paged:
    16-token pages, 32-token prefill chunks, the default pool) given one
    greedy request per tick_lens(cfg) prompt, stepped until all 8 decode
    (the dense
    engine admits them in one step, the paged one through ~170 chunked
    prefill ticks), then 5 warm decode ticks. max_new_tokens leaves
    room for those and for the timed windows."""
    from megatron_tpu_torch.inference.engine import InferenceEngine, Request
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    n, lens = slot_len(cfg), tick_lens(cfg)
    kw = dict(num_slots=8, max_seq_len=n, metrics=MetricsRegistry(),
              speculative=speculative, cuda_graph=graph, kv_cache_int8=int8)
    eng = (PagedInferenceEngine(cfg, params, page_size=16, prefill_chunk=32,
                                **kw)
           if paged else InferenceEngine(cfg, params, **kw))
    k1 = 1 + (speculative.k if speculative else 0)
    for prompt in _prompts(np, rng, cfg, lens, speculative is not None):
        eng.submit(Request(prompt=prompt,
                           max_new_tokens=n - k1 - len(prompt)))
    while len(eng._decode_rows()) < len(lens):
        eng.step()
    for _ in range(5):
        eng.step()
    return eng


def decode_ticks(eng, n, paged):
    """_window's fn for n decode ticks of a filled_engine (the paged
    engine allocates each tick's pages first, as step() does)."""
    def ticks():
        for _ in range(n):
            if paged:
                eng._ensure_decode_pages()
            eng._decode_tick()
        return n
    return ticks


def main(argv=None) -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_name", default="llama2-7B",
                   help="preset, NAME-SIZE (e.g. falcon-7B, gpt2-1.3B)")
    p.add_argument("--ticks", type=int, default=10)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--kv_paging", action="store_true",
                   help="profile the paged engine (decode ticks and one "
                        "prefill chunk)")
    p.add_argument("--spec_k", type=int, default=4)
    p.add_argument("--drafter", choices=("ngram", "model"), default="ngram")
    p.add_argument("--draft_layers", type=int, default=4,
                   help="the model drafter's depth: the target's first N "
                        "layers")
    p.add_argument("--kv_cache_int8", action="store_true",
                   help="profile the plain tick with bf16 and with int8 "
                        "caches instead of the plain and speculative tick")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.tools import run_text_generation_server as rts

    card = _card()
    cfg = presets.from_model_name(args.model_name)
    params = init_params(cfg, args.seed)
    spec = rts.load_spec(rts.parse_args(
        ["--serve_speculative", args.drafter, "--serve_spec_k",
         str(args.spec_k), "--serve_draft_layers", str(args.draft_layers)]),
        cfg, params)
    run = _profile_paged if args.kv_paging else _profile_dense
    if args.kv_cache_int8:
        engines = [(None, int8) for int8 in (False, True)]
    else:
        engines = [(speculative, False) for speculative in (None, spec)]
    for speculative, int8 in engines:
        for graph in (False, True):
            # the last engine's graph holds a reference cycle through its
            # step body: collect it, so each peak is one engine's
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run(torch, np, args, card, cfg, params, speculative, graph, int8)
    return 0


def _tag(eng, speculative, graph, args) -> dict:
    kind = "plain" if speculative is None else (
        f"spec_{speculative.drafter}_k{speculative.k}"
        + (f"_{args.draft_layers}layers" if speculative.drafter == "model"
           else ""))
    return {"tick": kind, "mode": "graph" if graph else "eager",
            "kv": "int8" if eng.kv_cache_int8 else "bf16",
            "cache_bytes": sum(c.nbytes for c in eng.caches),
            "capture_s": eng.capture_seconds}


def _memory(torch) -> dict:
    """Peak device memory since the engine was built (reset before)."""
    return {"max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2**30}


def _spec_extra(eng, s0, speculative) -> dict:
    if speculative is None:
        return {}
    d = {k: eng.stats[k] - s0[k] for k in
         ("ticks", "spec_proposed", "spec_accepted", "spec_emitted")}
    return {"spec": {**d,
                     "tokens_per_tick": d["spec_emitted"] / max(d["ticks"], 1),
                     "tokens_per_slot_tick": d["spec_emitted"] * speculative.k
                     / max(d["spec_proposed"], 1),
                     "accept_rate": d["spec_accepted"]
                     / max(d["spec_proposed"], 1)}}


def _profile_dense(torch, np, args, card, cfg, params, speculative, graph,
                   int8):
    from megatron_tpu_torch.inference.engine import Request

    rng = np.random.default_rng(args.seed)
    eng = filled_engine(np, cfg, params, rng, paged=False,
                        speculative=speculative, graph=graph, int8=int8)
    tag = _tag(eng, speculative, graph, args)
    s0 = dict(eng.stats)
    ticks = decode_ticks(eng, args.ticks, paged=False)

    name = f"decode_ticks_8_slots_{tag['tick']}_{tag['kv']}_{tag['mode']}"
    _window(torch, name, ticks, card,
            extra=lambda: {**tag, **_spec_extra(eng, s0, speculative),
                           **_memory(torch)})
    if speculative is None and graph:
        eng.run_until_idle()

        longest = tick_lens(cfg)[-1]

        def prefill():
            eng.submit(Request(prompt=rng.integers(
                0, cfg.vocab_size - 1, size=longest).astype(np.int32),
                max_new_tokens=1))
            return eng._admit()

        prefill()                      # warm this bucket once
        _window(torch, f"prefill_bucket_{eng._bucket(longest)}_"
                f"{tag['kv']}",
                prefill, card, extra=lambda: {"kv": tag["kv"]})
    eng.stop()


def _profile_paged(torch, np, args, card, cfg, params, speculative, graph,
                   int8):
    from megatron_tpu_torch.inference.engine import Request

    rng = np.random.default_rng(args.seed)
    eng = filled_engine(np, cfg, params, rng, paged=True,
                        speculative=speculative, graph=graph, int8=int8)
    tag = _tag(eng, speculative, graph, args)
    s0 = dict(eng.stats)
    ticks = decode_ticks(eng, args.ticks, paged=True)

    name = (f"paged_decode_ticks_8_slots_{tag['tick']}_{tag['kv']}_"
            f"{tag['mode']}")
    _window(torch, name, ticks, card,
            extra=lambda: {**tag, **_spec_extra(eng, s0, speculative),
                           **_memory(torch)})
    if speculative is None and graph:
        # free one slot for a fresh long prompt and time its chunks
        eng._retire(eng._decode_rows()[-1])
        eng.submit(Request(prompt=rng.integers(
            0, cfg.vocab_size - 1, size=tick_lens(cfg)[-1]).astype(
                np.int32), max_new_tokens=1))
        eng._admit()
        eng._prefill_tick()            # warm one chunk
        _window(torch, f"paged_prefill_chunk_{eng.prefill_chunk}_"
                f"{tag['kv']}", eng._prefill_tick, card,
                extra=lambda: {"kv": tag["kv"]})
    eng.stop()


if __name__ == "__main__":
    sys.exit(main())
