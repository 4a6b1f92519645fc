"""Runtime trace analysis of torch.profiler Chrome traces (counterpart
of megatron_tpu/telemetry/tracing/).

The training loop's ``--profile`` window, profile_training and the
smoke's profiled runs write Chrome trace-event JSON. This package reads
it with no import beyond the standard library (no torch):

  * ``events``  — the trace's complete events as classified OpEvents
                  (kernels, transfers, comm.* ranges, host ranges, step
                  markers) and the trace's window;
  * ``analyze`` — per-op self time, the compute / collective / idle
                  split, each collective's total vs. EXPOSED time, per-
                  step wall, the card's idle share and the comm.* share,
                  and measured-vs-expected against a comm contract.

``megatron_tpu_torch/tools/trace_report.py`` is the command line.
"""

from megatron_tpu_torch.telemetry.tracing.analyze import (  # noqa: F401
    CardShare, TraceReport, analyze_events, analyze_trace, card_share,
    compare_contract, expected_collectives, merge_intervals, overlap_ps,
    self_segments,
)
from megatron_tpu_torch.telemetry.tracing.events import (  # noqa: F401
    ChromeTrace, OpEvent, classify_chrome_events, find_trace_files,
    load_chrome_trace, step_markers,
)
