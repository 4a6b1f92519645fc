"""Checkpoint copy / dtype-cast / verify / prune over the port's
checkpoints (counterpart of tools/checkpoint_util.py).

Both of the port's layouts read here: one file per field (world size 1)
and the sharded layout (training/checkpointing.py). Resharding needs no
tool: a checkpoint loads at any topology. What is left:

  # copy and cast (no subcommand): the state's whole leaves, assembled on
  # the CPU from either layout and written in the one-file-per-field
  # layout; no model is built, so any tree (decoder, BERT, T5, a task
  # head) copies
  python -m megatron_tpu_torch.tools.checkpoint_util --load ckpts/run \\
      --save ckpts/export [--load_iters N] \\
      [--target_params_dtype bfloat16] [--params_only]

  # verify the manifests (existence and size; --deep adds the crc32s);
  # exits non-zero when a checked checkpoint is invalid, and prints each
  # checkpoint's provenance tags ("preemption")
  python -m megatron_tpu_torch.tools.checkpoint_util verify \\
      --load ckpts/run [--load_iters N] [--deep]

  # retention: all but the newest K committed checkpoints (never the
  # tracker's target nor the newest preemption checkpoint), and staging
  # dirs idle for --staging_age_mins
  python -m megatron_tpu_torch.tools.checkpoint_util prune \\
      --load ckpts/run --keep_latest_k 3 [--dry_run]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def verify_main(argv=None):
    """`verify`: manifest-check one or all checkpoints of a run dir. File
    I/O only: no model, no device."""
    p = argparse.ArgumentParser(prog="checkpoint_util verify")
    p.add_argument("--load", required=True)
    p.add_argument("--load_iters", type=int, default=None,
                   help="verify only this iteration (default: all found)")
    p.add_argument("--deep", action="store_true",
                   help="also verify crc32 checksums (reads every byte)")
    args = p.parse_args(argv)

    from megatron_tpu_torch.training import checkpointing

    iters = ([args.load_iters] if args.load_iters is not None
             else checkpointing.committed_iterations(args.load))
    if not iters:
        raise SystemExit(f"no checkpoints found in {args.load}")
    results = []
    for it in iters:
        path = checkpointing.checkpoint_dir(args.load, it)
        ok, detail = checkpointing.verify_checkpoint(path, deep=args.deep)
        results.append((it, ok))
        tags = checkpointing.checkpoint_tags(path)
        print(f"iter {it:7d}: {'OK     ' if ok else 'INVALID'} {detail}"
              + (f" [tags: {','.join(tags)}]" if tags else ""))
    tracked = checkpointing.read_tracker(args.load)
    print(f"tracker: {tracked}; newest valid: "
          f"{max((i for i, ok in results if ok), default=None)}")
    if not all(ok for _, ok in results):
        raise SystemExit(1)
    return results


def prune_main(argv=None):
    """`prune`: keep_latest_k retention and stale staging cleanup, through
    the manifest API the train loop uses."""
    p = argparse.ArgumentParser(prog="checkpoint_util prune")
    p.add_argument("--load", required=True)
    p.add_argument("--keep_latest_k", type=int, required=True)
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--staging_age_mins", type=float, default=60.0,
                   help="only remove staging dirs idle this long: a live "
                        "run's async save writes into a .tmp dir and must "
                        "not be pruned from under it")
    args = p.parse_args(argv)

    from megatron_tpu_torch.training import checkpointing

    pruned = checkpointing.prune_checkpoints(
        args.load, args.keep_latest_k, dry_run=args.dry_run)
    stale = ([] if args.dry_run
             else checkpointing.cleanup_staging(
                 args.load, min_age_seconds=args.staging_age_mins * 60))
    verb = "would prune" if args.dry_run else "pruned"
    print(f"{verb} iterations {pruned}; removed staging dirs {stale}; "
          f"kept {checkpointing.list_valid_checkpoints(args.load)}")
    return pruned


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "verify":
        return verify_main(argv[1:])
    if argv and argv[0] == "prune":
        return prune_main(argv[1:])
    p = argparse.ArgumentParser(prog="checkpoint_util")
    p.add_argument("--load", required=True)
    p.add_argument("--save", required=True)
    p.add_argument("--load_iters", type=int, default=None)
    p.add_argument("--target_params_dtype", default=None,
                   choices=["bfloat16", "float16", "float32"])
    p.add_argument("--params_only", action="store_true",
                   help="drop the optimizer state (a serving or export "
                        "copy): the moments become zeros, the step stays")
    args = p.parse_args(argv)

    import torch

    from megatron_tpu_torch.training import checkpointing

    it = (args.load_iters if args.load_iters is not None
          else checkpointing.resolve_load_iteration(args.load)[0])
    path = checkpointing.checkpoint_dir(args.load, it)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    saved_cfg = meta.get("config") or {}
    state = checkpointing.state_from_fields(checkpointing.read_state(path))
    if state.nonfinite_streak is None:
        # a checkpoint that predates the field: the fresh value
        state.nonfinite_streak = torch.zeros((), dtype=torch.int32)
    if args.params_only:
        zeros = lambda tree: checkpointing._map_tree(
            lambda _n, t: torch.zeros_like(t), tree)
        state = dataclasses.replace(
            state, mu=zeros(state.mu), nu=zeros(state.nu),
            nonfinite_streak=torch.zeros_like(state.nonfinite_streak))
    if args.target_params_dtype:
        dt = getattr(torch, args.target_params_dtype)
        state = dataclasses.replace(state, params=checkpointing._map_tree(
            lambda _n, t: t.to(dt), state.params))
        if "model" in saved_cfg:
            saved_cfg["model"]["params_dtype"] = args.target_params_dtype
    out = checkpointing.save_checkpoint(
        args.save, state, it, meta.get("consumed_train_samples", 0),
        config=saved_cfg)
    print(f"wrote checkpoint (iteration {it}"
          + (", params-only" if args.params_only else "")
          + (f", params {args.target_params_dtype}"
             if args.target_params_dtype else "")
          + f") to {out}")
    return out


if __name__ == "__main__":
    main()
