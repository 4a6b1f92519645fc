"""Per-card memory fit of a (model, topology) train step against one
H100 80 GB, without allocating it (counterpart of tools/hbm_check.py;
training/aot.py runs one rank's step under fake tensors).

    python -m megatron_tpu_torch.tools.hbm_check --proof llama2_7b_dp2tp4
    python -m megatron_tpu_torch.tools.hbm_check --model llama2 --size 70B \\
        --tp 8 --pp 4 --devices 64 --seq_length 4096 --recompute full
    python -m megatron_tpu_torch.tools.hbm_check --model llama2 --size 7B \\
        --num_layers 8 --devices 1 --json

--devices is the world size (the data-parallel degree is what is left
of it after tp x pp x cp; the optimizer state is ZeRO-1 sharded over
it, as the JAX tool's). The budget is 80 GiB, or --budget_gib; on the
card the default budget is the card's own memory. Exits 1 when the step
does not fit.
"""

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--proof", choices=["llama2_7b_dp2tp4",
                                       "llama2_70b_dp2tp8pp4"],
                   help="run a canned headline proof")
    p.add_argument("--model", default="llama2",
                   help="preset family (llama2, mistral, falcon, ...)")
    p.add_argument("--size", default="7B")
    p.add_argument("--num_layers", type=int, default=None,
                   help="cut the preset's depth")
    p.add_argument("--seq_length", type=int, default=None)
    p.add_argument("--params_dtype", default=None)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--cp", type=int, default=1)
    p.add_argument("--sequence_parallel", action="store_true")
    p.add_argument("--devices", type=int, default=8,
                   help="world size (dp is derived)")
    p.add_argument("--micro_batch_size", type=int, default=1)
    p.add_argument("--num_microbatches", type=int, default=2)
    p.add_argument("--recompute", default="selective",
                   choices=["none", "selective", "full"])
    p.add_argument("--budget_gib", type=float, default=None,
                   help="memory budget (default: an H100's 80 GiB, or the "
                        "card's own when one is present)")
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args(argv)

    import torch

    from megatron_tpu_torch.training.aot import (
        GIB, H100_BYTES, SCALE_PROOFS, hbm_fit_report,
    )

    if args.budget_gib is not None:
        budget = int(args.budget_gib * GIB)
    elif torch.cuda.is_available():
        budget = torch.cuda.get_device_properties(0).total_memory
    else:
        budget = H100_BYTES
    if args.proof:
        recipe, _budget, _cards = SCALE_PROOFS[args.proof]
        cfg, par, kw = recipe()
    else:
        from megatron_tpu_torch.config import ParallelConfig
        from megatron_tpu_torch.models import presets

        kw = {"seq_length": args.seq_length} if args.seq_length else {}
        cfg = presets.PRESETS[args.model](size=args.size, **kw)
        over = {k: v for k, v in (("num_layers", args.num_layers),
                                  ("params_dtype", args.params_dtype))
                if v is not None}
        if over:
            cfg = dataclasses.replace(cfg, **over).validate()
        par = ParallelConfig(tensor_parallel=args.tp,
                             pipeline_parallel=args.pp,
                             context_parallel=args.cp,
                             sequence_parallel=args.sequence_parallel)
        kw = dict(micro_batch_size=args.micro_batch_size,
                  num_microbatches=args.num_microbatches,
                  recompute=args.recompute, world_size=args.devices)
    rep = hbm_fit_report(cfg, par, **kw)
    if args.as_json:
        print(json.dumps({**dataclasses.asdict(rep),
                          "state_bytes": rep.state_bytes,
                          "temp_peak_bytes": rep.temp_peak_bytes,
                          "per_chip_bytes": rep.per_chip_bytes,
                          "budget_bytes": budget,
                          "fits": rep.fits(budget)}))
    else:
        print((args.proof + ": " if args.proof else "")
              + rep.summary(budget))
    return 0 if rep.fits(budget) else 1


if __name__ == "__main__":
    sys.exit(main())
