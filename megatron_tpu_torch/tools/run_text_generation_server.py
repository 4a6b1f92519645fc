"""Start the port's REST generation server on a random-init model.

    python -m megatron_tpu_torch.tools.run_text_generation_server \\
        --model_name llama2-7B --tokenizer_type null \\
        --serve_num_slots 8 --serve_max_seq_len 2048 --port 5000 \\
        [--serve_kv_paging --serve_page_size 16 --serve_prefill_chunk 32]

The flag names are the JAX CLI's (tools/run_text_generation_server.py)
for what the port supports, plus --device (default cuda). Weights are
random from --seed: loading checkpoints is not ported yet.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_name", default=None,
                   help="preset, optionally NAME-SIZE (default llama2-7B "
                        "without --load; with --load, checked against the "
                        "checkpoint's config)")
    p.add_argument("--load", default=None,
                   help="checkpoint directory to serve (the tracker's "
                        "iteration, or the newest valid one)")
    p.add_argument("--tokenizer_type", default="null",
                   help="only 'null' is ported: ids in, ids out; its eod "
                        "id is the model's vocab size")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--serve_num_slots", type=int, default=8,
                   help="KV-cache slots of the continuous-batching engine")
    p.add_argument("--serve_max_seq_len", type=int, default=None,
                   help="per-slot KV-cache length (default "
                        "min(seq_length, 2048))")
    p.add_argument("--serve_kv_paging", action="store_true",
                   help="paged KV cache: one shared page pool + radix "
                        "prefix cache + chunked prefill instead of "
                        "per-slot cache rows — shared prompt prefixes "
                        "skip prefill and long prompts can't stall the "
                        "decode batch")
    p.add_argument("--serve_page_size", type=int, default=16,
                   help="tokens per KV page (paged mode); a power of two "
                        "(1, 2, 4, ..., e.g. 8, 16, 64) for the paged "
                        "flash-decode kernel, else the engine refuses it")
    p.add_argument("--serve_prefill_chunk", type=int, default=32,
                   help="prompt tokens prefilled per engine tick (paged "
                        "mode): chunked prefill interleaves with decode "
                        "so one long prompt never stalls the batch")
    p.add_argument("--serve_num_pages", type=int, default=None,
                   help="KV pool size in pages (paged mode; default = "
                        "slots x pages-per-sequence + the scratch page, "
                        "i.e. the slot engine's capacity). Smaller "
                        "oversubscribes: the engine evicts cached prefixes "
                        "and preempts the youngest request under pressure")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def load_model(args):
    """(cfg, params, iteration or None) for --load / --model_name."""
    import dataclasses

    from megatron_tpu_torch.config import ModelConfig
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import empty_params, init_params
    from megatron_tpu_torch.training import checkpointing

    if not args.load:
        cfg = presets.from_model_name(args.model_name or "llama2-7B")
        print("WARNING: serving randomly initialized weights (no --load)",
              flush=True)
        return cfg, init_params(cfg, args.seed, device=args.device), None
    iteration, _ = checkpointing.resolve_load_iteration(args.load)
    saved = checkpointing.saved_run_config(args.load, iteration)
    # the serving presets' kernel route; the architecture is the saved one
    cfg = dataclasses.replace(ModelConfig(**saved["model"]),
                              attention_impl="pallas").validate()
    if args.model_name:
        checkpointing.check_config_compatibility(
            saved, {"model": presets.from_model_name(args.model_name)
                    .__dict__})
    params = checkpointing.load_params_only(
        args.load, empty_params(cfg, device=args.device), iteration)
    print(f"loaded checkpoint at iteration {iteration} from {args.load}",
          flush=True)
    return cfg, params, iteration


def main(argv=None, **server_kwargs):
    """server_kwargs go to inference.server.run_server (in-process
    callers pass `ready` and `service_out`)."""
    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.tokenizer import build_tokenizer

    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, _ = load_model(args)
    tokenizer = build_tokenizer(args.tokenizer_type,
                                vocab_size=cfg.vocab_size)
    max_seq_len = args.serve_max_seq_len or min(cfg.seq_length, 2048)
    row_bytes = (2 * cfg.num_layers * cfg.n_kv_heads * cfg.head_dim
                 * torch.finfo(cfg.dtype).bits / 8)
    if args.serve_kv_paging:
        ps = args.serve_page_size
        pages = (args.serve_num_pages
                 or args.serve_num_slots * (-(-max_seq_len // ps)) + 1)
        print(f"paged KV pool: {pages} pages x {ps} tokens = "
              f"{row_bytes * pages * ps / 2**30:.2f} GiB ({cfg.dtype})",
              flush=True)
    else:
        print(f"persistent KV cache: {args.serve_num_slots} slots x "
              f"{max_seq_len} tokens = "
              f"{row_bytes * args.serve_num_slots * max_seq_len / 2**30:.2f}"
              " GiB", flush=True)
    run_server(cfg, params, tokenizer, host=args.host, port=args.port,
               engine_slots=args.serve_num_slots,
               engine_max_seq_len=max_seq_len, device=args.device,
               kv_paging=args.serve_kv_paging,
               page_size=args.serve_page_size,
               prefill_chunk=args.serve_prefill_chunk,
               num_pages=args.serve_num_pages, **server_kwargs)


if __name__ == "__main__":
    main()
