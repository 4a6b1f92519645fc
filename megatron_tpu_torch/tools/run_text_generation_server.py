"""Start the port's REST generation server on a random-init model.

    python -m megatron_tpu_torch.tools.run_text_generation_server \\
        --model_name llama2-7B --tokenizer_type null \\
        --serve_num_slots 8 --serve_max_seq_len 2048 --port 5000

The flag names are the JAX CLI's (tools/run_text_generation_server.py)
for what the port supports, plus --device (default cuda). Weights are
random from --seed: loading checkpoints is not ported yet.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_name", default="llama2-7B",
                   help="preset, optionally NAME-SIZE (e.g. llama2-7B)")
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
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def main(argv=None):
    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.tokenizer import build_tokenizer

    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.from_model_name(args.model_name)
    tokenizer = build_tokenizer(args.tokenizer_type,
                                vocab_size=cfg.vocab_size)
    params = init_params(cfg, args.seed, device=args.device)
    print("WARNING: serving randomly initialized weights (no checkpoint "
          "loading in the port yet)", flush=True)
    max_seq_len = args.serve_max_seq_len or min(cfg.seq_length, 2048)
    gib = (2 * cfg.num_layers * args.serve_num_slots * max_seq_len
           * cfg.n_kv_heads * cfg.head_dim
           * torch.finfo(cfg.dtype).bits / 8) / 2**30
    print(f"persistent KV cache: {args.serve_num_slots} slots x "
          f"{max_seq_len} tokens = {gib:.2f} GiB", flush=True)
    run_server(cfg, params, tokenizer, host=args.host, port=args.port,
               engine_slots=args.serve_num_slots,
               engine_max_seq_len=max_seq_len, device=args.device)


if __name__ == "__main__":
    main()
