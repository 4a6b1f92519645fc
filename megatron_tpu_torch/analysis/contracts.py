"""Golden comm contracts: the collective calls each parallel configuration
of the port makes per step, pinned in golden/*.json (counterpart of
megatron_tpu/analysis/contracts.py).

The JAX package pins the collectives of a traced or compiled program.
The port has no program to audit: its collectives are the calls of
parallel/mappings.py and quant/collectives.py, each inside a ``comm.*``
range. So a contract here is measured, not derived: two gloo ranks on
the CPU run the configuration at the pinned tiny geometry under
torch.profiler, and rank 0's trace (telemetry/tracing) gives the comm.*
calls per step, by collective base (analysis/taxonomy.py): the manifest's
``comm`` section. A training contract is the loop's --profile window
over two steps divided by its two ``train_step`` markers
(training/pretrain.py): the step's calls and the loop's own per
iteration (its exit-flag agreement); a decode contract is the calls
inside one engine tick's ``decode_tick`` range (inference/engine.py).
Every profiled step must show the same counts. Where the
port's byte model prices the step (quant/collectives.forward_comm_bytes
for the decode configurations) the manifest adds its wire bytes.

A change that adds or drops a collective changes these counts and fails
tests/test_torch_tracing.py. After an intentional change, regenerate:

    python -m megatron_tpu_torch.tools.comm_report --regen [name ...]

and commit the JSON diff. A live run is held against a manifest with
``tools/trace_report --contract NAME``.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import tempfile
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"

#: ranks of every contract's launch (the host matrix's two)
WORLD = 2

#: the pinned geometry: the JAX contracts' tiny_model
#: (megatron_tpu/analysis/targets.py)
GEOMETRY = dict(num_layers=4, hidden_size=32, num_attention_heads=4,
                num_kv_heads=2, ffn_hidden_size=64, vocab_size=128,
                seq_length=32, params_dtype="float32")
#: training: the steps run and the profiled window [start, end)
TRAIN_STEPS = 4
TRAIN_WINDOW = (2, 4)
TRAIN_GLOBAL_BATCH = 4
#: decoding: slots (every one busy), prompt length and new tokens
DECODE_SLOTS = 4
DECODE_PROMPT = 8
DECODE_NEW = 4

#: name -> (kind, loop flags or the engine's compress_collectives mode)
CONFIGS: Dict[str, Dict[str, Any]] = {
    # tensor parallel + sequence parallel: the all-gather/reduce-scatter
    # pairs of Korthikanti's SP around each block
    "train_tp2_sp": dict(kind="train", argv=[
        "--tensor_model_parallel_size", "2", "--sequence_parallel"]),
    # a 2-stage pipeline: the p2p exchanges of the 1F1B schedule
    "train_pp2": dict(kind="train", argv=[
        "--pipeline_model_parallel_size", "2"]),
    # data parallel 2 with ZeRO-1 (the JAX manifest is dp8 on its fake
    # mesh): gradient reduce-scatter, parameter all-gather
    "train_dp2_zero1": dict(kind="train", argv=[
        "--use_distributed_optimizer"]),
    # the dense engine's decode tick at tp2 with explicit full-precision
    # TP collectives (the baseline ledger)
    "decode_tp2_dense": dict(kind="decode", mode="dense"),
    # the same tick with int8 compressed collectives
    "decode_tp2_int8": dict(kind="decode", mode="int8"),
}

#: the marker each kind's counts are taken between
MARKERS = {"train": "train_step", "decode": "decode_tick"}

#: (compressed config, dense baseline, minimum wire-byte ratio) that
#: --check verifies
COMPRESSION_GATES = (("decode_tp2_int8", "decode_tp2_dense", 3.0),)


def manifest_path(name: str) -> Path:
    return GOLDEN_DIR / f"{name}.json"


def load_manifest(name: str) -> Dict[str, Any]:
    path = manifest_path(name)
    if not path.exists():
        raise FileNotFoundError(
            f"no golden manifest for {name!r} — generate it with "
            f"'python -m megatron_tpu_torch.tools.comm_report --regen "
            f"{name}'")
    return json.loads(path.read_text())


# -- counting ---------------------------------------------------------------


def marker_spans(events, marker: str):
    """The `marker` spans of a trace, in time order: a step marker
    (train_step, folded as telemetry/tracing folds it), else the host
    ranges of that name (decode_tick)."""
    from megatron_tpu_torch.telemetry.tracing.events import step_markers

    marks = step_markers(events).get(marker)
    if marks is not None:
        return marks
    return sorted((e for e in events
                   if e.name == marker and e.plane.startswith("/host")),
                  key=lambda e: e.start_ps)


def counts_per_marker(trace, marker: str) -> List[Dict[str, int]]:
    """For each `marker` span of a trace (telemetry/tracing ChromeTrace),
    the comm.* calls inside it by collective base."""
    from megatron_tpu_torch.telemetry.tracing.events import comm_ranges

    ranges = comm_ranges(trace.events)
    out = []
    for m in marker_spans(trace.events, marker):
        counts: Dict[str, int] = {}
        for r in ranges:
            if m.start_ps <= r.start_ps and r.end_ps <= m.end_ps:
                counts[r.collective] = counts.get(r.collective, 0) + 1
        out.append(dict(sorted(counts.items())))
    return out


def per_step_counts(trace, marker: str, whole: bool) -> Dict[str, int]:
    """The comm.* calls of one step. Every marker's own calls must agree;
    whole: the calls of the whole trace divided by the markers (a
    training window: the step's calls and the loop's own, such as its
    exit-flag agreement over the host group), else one marker's (the
    decode tick's, whose trace also holds the prefills)."""
    per = counts_per_marker(trace, marker)
    if not per:
        raise ValueError(f"no {marker!r} marker in {trace.path}")
    if any(c != per[0] for c in per[1:]):
        raise ValueError(f"the {marker!r} steps of {trace.path} differ in "
                         f"their comm.* calls: {per}")
    if not whole:
        return per[0]
    from megatron_tpu_torch.telemetry.tracing.events import comm_ranges

    total: Dict[str, int] = {}
    for r in comm_ranges(trace.events):
        total[r.collective] = total.get(r.collective, 0) + 1
    if any(n % len(per) for n in total.values()):
        raise ValueError(f"{trace.path}: comm.* calls {total} do not divide "
                         f"into its {len(per)} steps")
    return {op: n // len(per) for op, n in sorted(total.items())}


# -- the configurations, run on every rank of a gloo launch -------------------


def _model():
    from megatron_tpu_torch.config import ModelConfig

    return ModelConfig(**GEOMETRY).validate()


def train_argv(name: str, profile_dir: str, window=TRAIN_WINDOW,
               steps: int = TRAIN_STEPS, device: str = "cpu") -> List[str]:
    """The loop's flags of a train contract with a --profile window."""
    return ["--micro_batch_size", "1",
            "--global_batch_size", str(TRAIN_GLOBAL_BATCH),
            "--train_iters", str(steps), "--lr", "1e-3",
            "--lr_decay_style", "constant", "--log_interval", "1",
            "--eval_interval", str(steps + 1), "--eval_iters", "1",
            "--seed", "0", "--profile",
            "--profile_step_start", str(window[0]),
            "--profile_step_end", str(window[1]),
            "--profile_dir", profile_dir, "--device", device,
            *CONFIGS[name]["argv"]]


def synthetic_batches(cfg, global_batch: int, seed: int = 0):
    """train_iter_factory of random LM batches at the geometry."""
    import numpy as np

    def factory(consumed, gbs):
        rng = np.random.default_rng(seed + consumed)
        while True:
            text = rng.integers(0, cfg.vocab_size,
                                (gbs, cfg.seq_length + 1))
            yield {"tokens": text[:, :-1].astype(np.int64),
                   "labels": text[:, 1:].astype(np.int64),
                   "loss_mask": np.ones((gbs, cfg.seq_length), np.float32)}

    return factory


def run_train(name: str, profile_dir: str, window=TRAIN_WINDOW,
              steps: int = TRAIN_STEPS, device: str = "cpu"):
    """A train contract's loop on this rank (torch.distributed already
    initialized; the golden manifests come from the CPU, a check on the
    card passes device "cuda"); returns the TrainLoop (rank 0's
    profile_traces)."""
    from megatron_tpu_torch.arguments import args_to_run_config, parse_args
    from megatron_tpu_torch.training.pretrain import pretrain

    model = _model()
    args = parse_args(train_argv(name, profile_dir, window, steps, device))
    cfg = args_to_run_config(args, model=model)
    return pretrain(cfg, synthetic_batches(model, TRAIN_GLOBAL_BATCH),
                    log=lambda s: None, device=device)


def run_decode(name: str, profile_dir: str) -> Optional[Dict[str, Any]]:
    """A decode contract's engine at tp2 (rank 0 serves, the other rank
    follows): DECODE_SLOTS greedy prompts of DECODE_PROMPT tokens,
    DECODE_NEW tokens each, profiled on rank 0. Returns rank 0's trace
    path and the byte model's price of one tick (None elsewhere)."""
    import numpy as np
    import torch

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.inference.server import GenerationService
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.parallel.distributed import ServingChannel
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.quant.collectives import forward_comm_bytes
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg = _model()
    mesh = build_mesh(ParallelConfig(tensor_parallel=WORLD))
    params = init_params(cfg, 0, device="cpu", mesh=mesh)
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (DECODE_SLOTS, DECODE_PROMPT)).astype(np.int32)
    lengths = np.full(DECODE_SLOTS, DECODE_PROMPT, np.int32)
    # rank 0's profiler records every thread: the ticks run on the
    # engine's step-loop thread
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
        if mesh.rank == 0 else contextlib.nullcontext())
    with prof:
        svc = GenerationService(
            cfg, params, NullTokenizer(cfg.vocab_size), device="cpu",
            metrics=MetricsRegistry(), mesh=mesh,
            channel=ServingChannel(mesh.control_group, mesh.rank),
            cuda_graph=False, engine_slots=DECODE_SLOTS,
            engine_max_seq_len=cfg.seq_length,
            compress_collectives=CONFIGS[name]["mode"])
        if mesh.rank != 0:
            svc.follow()
            return None
        try:
            eng = svc.engine
            eng.generate(prompts, lengths, DECODE_NEW)
            priced = forward_comm_bytes(cfg, eng.tp_comm, DECODE_SLOTS, 1)
        finally:
            svc.shutdown()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    return {"trace": path, "tick_bytes": priced}


def measure_job(names, out_dir: str) -> Dict[str, Any]:
    """Every rank: run each named configuration; rank 0 returns {name:
    manifest}."""
    import torch.distributed as dist

    from megatron_tpu_torch.telemetry.tracing.events import (
        load_chrome_trace,
    )

    out = {}
    for name in names:
        kind = CONFIGS[name]["kind"]
        prof_dir = os.path.join(out_dir, name)
        priced = None
        if kind == "train":
            loop = run_train(name, prof_dir)
            trace = loop.profile_traces[0] if dist.get_rank() == 0 else None
        else:
            got = run_decode(name, prof_dir)
            trace = got["trace"] if got else None
            priced = got["tick_bytes"] if got else None
        if trace is None:
            continue
        counts = per_step_counts(load_chrome_trace(trace), MARKERS[kind],
                                 whole=kind == "train")
        out[name] = manifest_of(name, counts, priced)
    return out


def manifest_of(name: str, counts: Dict[str, int],
                priced: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    import torch

    comm: Dict[str, Any] = {"collectives": {
        op: {"count": n} for op, n in sorted(counts.items())}}
    if priced is not None:
        mode = CONFIGS[name].get("mode")
        comm["total_wire_bytes"] = int(
            priced["compressed"] if mode in ("int8", "fp8")
            else priced["dense"])
    return {"config": name, "marker": MARKERS[CONFIGS[name]["kind"]],
            "world": WORLD, "geometry": GEOMETRY,
            "toolchain": {"torch": torch.__version__.split("+")[0]},
            "comm": comm}


# -- the launch ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int, names, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        result = measure_job(names, out_dir)
        if rank == 0:
            with open(os.path.join(out_dir, "manifests.json"), "w") as f:
                json.dump(result, f)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def build_manifests(names: Optional[List[str]] = None
                    ) -> Dict[str, Dict[str, Any]]:
    """Measure the named configurations (all by default) in one two-rank
    gloo launch on the CPU; {name: manifest}."""
    import torch.multiprocessing as mp

    names = list(names or CONFIGS)
    unknown = sorted(set(names) - set(CONFIGS))
    if unknown:
        raise KeyError(f"unknown contract config(s) {unknown} "
                       f"(known: {', '.join(sorted(CONFIGS))})")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(_free_port(), names, tmp), nprocs=WORLD,
                 join=True)
        with open(os.path.join(tmp, "manifests.json")) as f:
            return json.load(f)


def write_manifests(names: Optional[List[str]] = None) -> List[Path]:
    GOLDEN_DIR.mkdir(exist_ok=True)
    paths = []
    for name, manifest in build_manifests(names).items():
        path = manifest_path(name)
        path.write_text(json.dumps(manifest, indent=2, sort_keys=True)
                        + "\n")
        paths.append(path)
    return paths


# -- comparisons --------------------------------------------------------------


def diff_section(golden: Dict[str, Any], fresh: Dict[str, Any],
                 label: str) -> List[str]:
    """Human-readable mismatches between two collective dicts."""
    out: List[str] = []
    for key in sorted(set(golden) | set(fresh)):
        g, f = golden.get(key), fresh.get(key)
        if g == f:
            continue
        if g is None:
            out.append(f"{label}: NEW collective {key}: {f}")
        elif f is None:
            out.append(f"{label}: collective DISAPPEARED {key}: was {g}")
        else:
            out.append(f"{label}: {key}: golden {g} != current {f}")
    return out


def check_contract(name: str, fresh: Dict[str, Any]) -> List[str]:
    """A freshly measured manifest against golden: [] when it holds."""
    golden = load_manifest(name)
    problems = diff_section(golden["comm"]["collectives"],
                            fresh["comm"]["collectives"], name)
    g_bytes = golden["comm"].get("total_wire_bytes")
    f_bytes = fresh["comm"].get("total_wire_bytes")
    if g_bytes != f_bytes:
        problems.append(f"{name}: total_wire_bytes golden {g_bytes} != "
                        f"current {f_bytes}")
    return problems


def wire_bytes(manifest: Dict[str, Any]) -> int:
    return int(manifest.get("comm", {}).get("total_wire_bytes", 0))


def compression_ratio(compressed: Dict[str, Any],
                      dense: Dict[str, Any]) -> float:
    """dense / compressed wire bytes of two manifests."""
    c = wire_bytes(compressed)
    return wire_bytes(dense) / c if c > 0 else 0.0


def check_compression_gates(
        fresh: Optional[Dict[str, Dict[str, Any]]] = None) -> List[str]:
    """Every COMPRESSION_GATES pair (golden, or fresh {name: manifest})."""
    problems: List[str] = []
    for comp_name, dense_name, floor in COMPRESSION_GATES:
        try:
            comp = (fresh or {}).get(comp_name) or load_manifest(comp_name)
            dense = (fresh or {}).get(dense_name) or load_manifest(dense_name)
        except FileNotFoundError as e:
            problems.append(f"compression gate {comp_name}: {e}")
            continue
        ratio = compression_ratio(comp, dense)
        if ratio < floor:
            problems.append(
                f"compression gate: {comp_name} wire bytes are only "
                f"{ratio:.2f}x below {dense_name} (floor {floor}x) — "
                "the compressed path is moving dense-sized payloads")
    return problems
