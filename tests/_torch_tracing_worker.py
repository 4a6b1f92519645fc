"""A two-rank gloo job for tests/test_torch_parallel.py's launch: the
tp2 + SP training loop with a --profile window (analysis/contracts.py's
train_tp2_sp at its pinned geometry), read back with the port's trace
reader and held against the golden manifest. Imports torch and the port
only."""

import tempfile


def live_contract(steps: int = 4, window=(2, 4)):
    """Rank 0: the window's comm.* counts, step markers, per-marker
    counts and the comparison with train_tp2_sp's manifest."""
    import torch.distributed as dist

    from megatron_tpu_torch.analysis import contracts
    from megatron_tpu_torch.telemetry.tracing import (
        analyze_trace, compare_contract, load_chrome_trace,
    )

    with tempfile.TemporaryDirectory() as d:
        loop = contracts.run_train("train_tp2_sp", d, window, steps)
        if dist.get_rank() != 0:
            return None
        trace = load_chrome_trace(loop.profile_traces[0])
    report = analyze_trace(trace)
    markers = report.steps.get("train_step", {}).get("count", 0)
    manifest = contracts.load_manifest("train_tp2_sp")
    return {"markers": markers,
            "counts": report.collective_counts(),
            "per_step": contracts.counts_per_marker(trace, "train_step"),
            "inferred": compare_contract(report, manifest,
                                         "train_tp2_sp").to_dict(),
            "given": compare_contract(report, manifest, "train_tp2_sp",
                                      executions=markers).to_dict()}
