"""The port's trace reader and report tools against the JAX package:
analyze_events and compare_contract on the same synthetic OpEvent lists,
the Chrome-trace loader on a profiled tiny CPU run against the interval
formulas the smoke used inline (the card's busy union over the trace's
window, the host comm.* ranges' union), the comm contracts' tables, and
the telemetry report and Perfetto timeline of the same journals."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import copy
import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest

from megatron_tpu.telemetry.tracing import analyze as j_analyze
from megatron_tpu.telemetry.tracing import events as j_events
from megatron_tpu_torch.analysis import contracts, taxonomy
from megatron_tpu_torch.telemetry.tracing import analyze, events
from megatron_tpu_torch.tools import comm_report, telemetry_report
from megatron_tpu_torch.tools import trace_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_GOLDEN = os.path.join(REPO, "megatron_tpu", "analysis", "golden")

OPS = ("fusion.1", "dot.2", "copy.3", "add.4")
COLLS = ("all-reduce.7", "all-gather-start.2", "all-gather-done.2",
         "all-to-all.5", "collective-permute.9", "reduce-scatter.3")


def synthetic_events(seed):
    """(JAX OpEvents, port OpEvents) of the same random timeline: two
    device planes of op lines with loop envelopes nesting ops and
    collectives, and a host line of step markers (the JAX package's
    PjitFunction(train_step), the port's train_step range)."""
    rng = np.random.default_rng(seed)
    rows = []
    for plane in ("/device:TPU:0", "/device:TPU:1"):
        for line in ("XLA Ops", "stream 2"):
            t = int(rng.integers(0, 1000))
            for _ in range(12):
                dur = int(rng.integers(200, 3000))
                rows.append(("while.1", "compute", t, dur, plane, line))
                c = t + int(rng.integers(0, 50))
                while c < t + dur - 60:
                    d = int(rng.integers(10, 200))
                    if rng.random() < 0.4:
                        name = COLLS[rng.integers(len(COLLS))]
                    else:
                        name = OPS[rng.integers(len(OPS))]
                    kind = ("collective" if taxonomy.collective_base(name)
                            else "compute")
                    rows.append((name, kind, c, min(d, t + dur - c), plane,
                                 line))
                    c += d + int(rng.integers(0, 40))
                t += dur + int(rng.integers(0, 300))
    marks, t = [], 0
    for _ in range(4):
        t += int(rng.integers(100, 6000))
        d = int(rng.integers(500, 4000))
        marks.append((t, d))
        t += d
    jax_ev, port_ev = [], []
    for name, kind, s, d, plane, line in rows:
        base = taxonomy.collective_base(name)
        for cls, out in ((j_events.OpEvent, jax_ev), (events.OpEvent,
                                                      port_ev)):
            out.append(cls(name=name, kind=kind, start_ps=s, duration_ps=d,
                           plane=plane, line=line, module="jit_train_step",
                           collective=base))
    for s, d in marks:
        jax_ev.append(j_events.OpEvent(
            name="PjitFunction(train_step)", kind="host", start_ps=s,
            duration_ps=d, plane="/host:CPU", line="python"))
        port_ev.append(events.OpEvent(
            name="train_step", kind="host", start_ps=s, duration_ps=d,
            plane="/host:CPU", line="thread 1"))
    return jax_ev, port_ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_events_equals_jax(seed):
    jax_ev, port_ev = synthetic_events(seed)
    jr = j_analyze.analyze_events(jax_ev)
    tr = analyze.analyze_events(port_ev)
    assert tr.to_dict(top=50) == jr.to_dict(top=50)
    assert tr.exposed_collective_s == jr.exposed_collective_s
    assert tr.steps["train_step"]["count"] == 4
    for line in ("XLA Ops", "stream 2"):
        jl = [e for e in jax_ev if e.line == line]
        tl = [e for e in port_ev if e.line == line]
        assert ([(e.name, s, n) for e, s, n in j_analyze.self_segments(jl)]
                == [(e.name, s, n) for e, s, n in analyze.self_segments(tl)])
    spans = [(e.start_ps, e.end_ps) for e in port_ev]
    merged = analyze.merge_intervals(spans)
    assert merged == j_analyze.merge_intervals(spans)
    for a, b in spans[:20]:
        assert (analyze.overlap_ps(a, b + 500, merged)
                == j_analyze.overlap_ps(a, b + 500, merged))
    # the contract check on a JAX manifest, inferred and given counts
    for name in ("ulysses_cp2", "train_tp2_sp", "decode_tp2_int8"):
        with open(os.path.join(J_GOLDEN, f"{name}.json")) as f:
            manifest = json.load(f)
        assert (analyze.expected_collectives(manifest)
                == j_analyze.expected_collectives(manifest))
        for execs in (None, 2):
            assert (analyze.compare_contract(tr, manifest, name,
                                             execs).to_dict()
                    == j_analyze.compare_contract(jr, manifest, name,
                                                  execs).to_dict())


# -- a profiled tiny CPU run --------------------------------------------------


def _ns(us):
    """A Chrome timestamp (microseconds, nanosecond decimals) as whole
    nanoseconds: the formulas below run on exact integers, so the reader
    must give their unions exactly."""
    return int(round(float(us) * 1e3))


def _trace_stats(raw):
    """chip_smoke.py's inline formula before the reader replaced it: the
    union of kernel intervals over the span of every complete event
    (nanoseconds; milliseconds out)."""
    evs = [e for e in raw if e.get("ph") == "X" and "ts" in e]
    spans = [(_ns(e["ts"]), _ns(e["ts"]) + _ns(e.get("dur", 0)))
             for e in evs]
    kernels = sorted((_ns(e["ts"]), _ns(e["ts"]) + _ns(e.get("dur", 0)))
                     for e in evs if e.get("cat") == "kernel")
    busy, end = 0, -math.inf
    for a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return window / 1e6, busy / 1e6, len(kernels)


def _comm_share(raw):
    """chip_smoke.py's inline comm.* formula (host ranges only)."""
    evs = [e for e in raw if e.get("ph") == "X" and "ts" in e]
    ranges = [e for e in evs if str(e.get("name", "")).startswith("comm.")
              and not str(e.get("cat", "")).startswith("gpu")]
    comm = sorted((_ns(e["ts"]), _ns(e["ts"]) + _ns(e.get("dur", 0)))
                  for e in ranges)
    busy, end = 0, -math.inf
    for a, b in comm:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_op = {}
    for e in ranges:
        by_op[e["name"]] = by_op.get(e["name"], 0) + _ns(e["dur"])
    return busy / 1e6, {k: v / 1e6 for k, v in by_op.items()}


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """A tiny single-process TrainLoop (contracts' geometry, 4 steps) with
    a --profile window over steps 2 and 3 and a telemetry journal."""
    from megatron_tpu_torch.arguments import args_to_run_config, parse_args
    from megatron_tpu_torch.training.pretrain import pretrain

    d = tmp_path_factory.mktemp("prof")
    model = contracts._model()
    argv = contracts.train_argv("train_dp2_zero1", str(d / "traces"),
                                window=(2, 4), steps=4)
    argv.remove("--use_distributed_optimizer")
    args = parse_args(argv + ["--telemetry_dir", str(d / "tele")])
    cfg = args_to_run_config(args, model=model)
    loop = pretrain(cfg, contracts.synthetic_batches(model, 4),
                    log=lambda s: None, device="cpu")
    assert len(loop.profile_traces) == 1
    return loop.profile_traces[0], str(d / "tele")


def _with_card_events(raw, seed=0):
    """The trace's events plus, at random instants inside its window,
    kernels on a card stream, comm.* host ranges and their card-side
    gpu_user_annotation copies (which must count for the window only)."""
    rng = np.random.default_rng(seed)
    xs = [e for e in raw if e.get("ph") == "X" and "ts" in e]
    lo = min(float(e["ts"]) for e in xs)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in xs)
    out = list(raw)
    for i in range(40):
        ts = round(float(rng.uniform(lo, hi)), 3)
        dur = round(float(rng.uniform(1, (hi - lo) / 30)), 3)
        out.append({"ph": "X", "cat": "kernel", "name": f"flash_fwd_{i % 3}",
                    "pid": 0, "tid": 7, "ts": ts, "dur": dur})
        if i % 2:
            op = ("comm.all_reduce", "comm.p2p", "comm.all_gather")[i % 3]
            out.append({"ph": "X", "cat": "user_annotation", "name": op,
                        "pid": 99, "tid": 1, "ts": ts, "dur": dur / 2})
            out.append({"ph": "X", "cat": "gpu_user_annotation", "name": op,
                        "pid": 0, "tid": 7, "ts": ts + 5.0, "dur": hi - lo})
    return out


def test_chrome_loader_gives_the_smoke_formulas(profiled, tmp_path):
    path, _ = profiled
    with open(path) as f:
        doc = json.load(f)
    for seed in (0, 1):
        doc2 = dict(doc, traceEvents=_with_card_events(doc["traceEvents"],
                                                       seed))
        p = tmp_path / f"t{seed}.json"
        p.write_text(json.dumps(doc2))
        card = analyze.analyze_trace(str(p)).card
        window_ms, busy_ms, n = _trace_stats(doc2["traceEvents"])
        comm_ms, by_op = _comm_share(doc2["traceEvents"])
        assert card.kernels == n == 40
        assert card.window_ms == window_ms
        assert card.busy_ms == busy_ms
        # the shares of the exact integer nanoseconds (ms * 1e6 alone can
        # land an ulp off the integer, and the quotient with it)
        window_ns, busy_ns = round(window_ms * 1e6), round(busy_ms * 1e6)
        assert card.idle_share == 1 - busy_ns / window_ns
        assert card.comm_ms == comm_ms
        assert card.comm_share == round(comm_ms * 1e6) / window_ns
        assert card.comm_ms_by_op == pytest.approx(by_op, rel=1e-15)
    # the profiled window itself: two train_step markers, no comm.* at
    # world size 1, host time only
    report = analyze.analyze_trace(path)
    assert report.steps["train_step"]["count"] == 2
    assert report.collective_counts() == {}
    assert report.card.kernels == 0 and report.card.idle_share == 1.0
    assert report.busy_s["host"] > 0


def test_trace_report_cli_text_json_policy_and_contract(profiled, tmp_path,
                                                       capsys):
    path, _ = profiled
    traces_dir = os.path.dirname(path)
    assert trace_report.main([traces_dir, "--top", "5"]) == 0
    text = capsys.readouterr().out
    assert "steps (step marker spans):" in text and "train_step" in text
    assert trace_report.main([path, "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["report"]["steps"]["train_step"]["count"] == 2
    policy = tmp_path / "policy.json"
    assert trace_report.main([path, "--emit-comm-policy", str(policy),
                              "--exposed-threshold", "0.5"]) == 0
    doc = json.loads(policy.read_text())
    assert set(doc["sites"]) == set(doc["site_exposure"])
    # no comm.* at world size 1: a contract with collectives mismatches
    assert trace_report.main([path, "--contract", "train_tp2_sp",
                              "--check"]) == 1
    assert "NEVER RAN" in capsys.readouterr().out


def test_golden_manifests_and_comm_report(capsys):
    names = sorted(contracts.CONFIGS)
    for name in names:
        m = contracts.load_manifest(name)
        assert m["config"] == name and m["geometry"] == contracts.GEOMETRY
        assert m["comm"]["collectives"], name
    assert contracts.check_compression_gates() == []
    dense = contracts.load_manifest("decode_tp2_dense")
    broken = copy.deepcopy(contracts.load_manifest("decode_tp2_int8"))
    broken["comm"]["total_wire_bytes"] = dense["comm"]["total_wire_bytes"]
    assert contracts.check_compression_gates(
        {"decode_tp2_int8": broken}) != []
    assert contracts.check_contract("train_pp2",
                                    contracts.load_manifest("train_pp2")) == []
    extra = copy.deepcopy(contracts.load_manifest("train_pp2"))
    extra["comm"]["collectives"]["all-gather"] = {"count": 1}
    assert "NEW collective" in contracts.check_contract("train_pp2",
                                                        extra)[0]
    assert comm_report.main([]) == 0
    table = capsys.readouterr().out
    assert all(f"== {n} " in table for n in names)
    assert comm_report.main(["--diff", "decode_tp2_dense",
                             "decode_tp2_int8"]) == 0
    ratio = float(capsys.readouterr().out.split("ratio")[-1]
                  .split(":")[1].strip().rstrip("x"))
    assert ratio == pytest.approx(
        contracts.compression_ratio(broken and contracts.load_manifest(
            "decode_tp2_int8"), dense), abs=0.01)
    assert ratio >= 3.0


# -- the telemetry report ----------------------------------------------------


def _jax_report():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import telemetry_report as j_report
    finally:
        sys.path.pop(0)
    return j_report


def _synthetic_journal(path, seed):
    """A journal written by the port's EventJournal with every kind the
    report reads."""
    from megatron_tpu_torch.telemetry.journal import EventJournal

    rng = np.random.default_rng(seed)
    j = EventJournal(str(path))
    j.emit("run_start", host=0, num_hosts=1)
    for it in range(1, 13):
        j.emit("step", iteration=it,
               step_ms=float(rng.uniform(50, 90)),
               data_wait_ms=float(rng.uniform(0, 5)),
               tokens_per_s=float(rng.uniform(1e4, 2e4)),
               loss=float(rng.uniform(2, 3)))
        if it % 4 == 0:
            j.emit("checkpoint_begin", iteration=it)
            j.emit("checkpoint_stall", iteration=it,
                   seconds=float(rng.uniform(0.1, 0.5)))
            j.emit("checkpoint_commit", iteration=it, seconds=0.6)
        if it % 6 == 0:
            j.emit("eval", iteration=it, seconds=float(rng.uniform(0.2, 1)))
    j.emit("profile_begin", iteration=3, source="--profile")
    j.emit("profile_end", iteration=5)
    for r in range(6):
        j.emit("serve_request", status=200, wall_s=float(rng.uniform(0.1, 1)),
               ttft_s=float(rng.uniform(0.01, 0.1)),
               tpot_s=float(rng.uniform(0.001, 0.01)), tokens=8)
    j.emit("goodput", wall_s=20.0, productive_s=15.5, compile_s=1.0,
           data_wait_s=0.2, checkpoint_stall_s=0.9, eval_s=1.1)
    j.emit("preemption", iteration=12, notice_host=0)
    j.close()


def test_telemetry_report_and_perfetto_equal_jax(profiled, tmp_path):
    j_report = _jax_report()
    _, tele = profiled
    synth = tmp_path / "synth" / "events.jsonl"
    synth.parent.mkdir()
    _synthetic_journal(synth, 0)
    for journals in ([tele], [str(synth.parent)], [tele, str(synth)]):
        jev = j_report.load_journals(journals)
        tev = telemetry_report.load_journals(journals)
        assert tev == jev
        js, ts = j_report.summarize(jev), telemetry_report.summarize(tev)
        assert ts == js
        assert telemetry_report.render(ts) == j_report.render(js)
        jp, tp = tmp_path / "j.json", tmp_path / "t.json"
        j_doc = j_report.write_perfetto(journals, str(jp))
        t_doc = telemetry_report.write_perfetto(journals, str(tp))
        for doc in (j_doc, t_doc):
            doc["metadata"].pop("tool")
        assert t_doc == j_doc
    assert ts["steps"] == 12 + 4
    assert telemetry_report.main([tele, "--format", "json"]) == 0


def test_loader_classifies_every_event_kind():
    raw = [
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_"
         "bf16_RING_LL(x)", "pid": 0, "tid": 3, "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel", "pid": 0,
         "tid": 7, "ts": 10.0, "dur": 2.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 7, "ts": 1.0, "dur": 1.0},
        {"ph": "X", "cat": "user_annotation", "name": "comm.all_reduce",
         "pid": 9, "tid": 1, "ts": 9.0, "dur": 1.5},
        {"ph": "X", "cat": "cpu_op", "name": "c10d::allreduce_", "pid": 9,
         "tid": 1, "ts": 9.2, "dur": 1.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "comm.all_reduce",
         "pid": 0, "tid": 3, "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#4",
         "pid": 9, "tid": 1, "ts": 0.5, "dur": 12.0},
        {"ph": "i", "name": "marker", "pid": 9, "tid": 1, "ts": 100.0},
    ]
    evs, window = events.classify_chrome_events(raw)
    kinds = {e.name[:12]: (e.kind, e.collective) for e in evs}
    assert kinds["ncclDevKerne"] == ("collective", "all-reduce")
    assert kinds["flash_fwd_ke"] == ("compute", None)
    assert kinds["Memcpy HtoD"] == ("infeed", None)
    assert kinds["comm.all_red"] == ("collective", "all-reduce")
    assert kinds["c10d::allred"] == ("collective", "all-reduce")
    assert kinds["ProfilerStep"][0] == "host"
    assert len(evs) == 6 and window == (500_000, 40_000_000)
    report = analyze.analyze_events(evs)
    # one call: the range counts, the NCCL kernel and the c10d op do not
    assert report.collective_counts() == {"all-reduce": 1}
    assert report.steps["ProfilerStep"]["count"] == 1
    # the time: the host range's and the NCCL kernel's, not the c10d op's
    # inside the range again; the range (9.0-10.5 us) is exposed but for
    # 10.0-10.5 under the flash kernel (10.0-12.0), the NCCL kernel
    # (10.0-15.0, another stream of the same card) but for 10.0-12.0
    coll = {c.op: c for c in report.collectives}["all-reduce"]
    assert coll.total_ps == 1_500_000 + 5_000_000
    assert coll.exposed_ps == 1_000_000 + 3_000_000
    host = [e for e in evs if e.name == "comm.all_reduce"][0]
    assert dataclasses.asdict(host)["plane"].startswith("/host")
