"""Convert a native checkpoint back to a HuggingFace directory
(counterpart of the repo's tools/native_to_hf.py).

    python -m megatron_tpu_torch.tools.native_to_hf --load ckpts/run \\
        --output hf_out [--model_type llama] [--dtype bfloat16]

Writes config.json and pytorch_model.bin (torch.save of the state dict
in --dtype), which transformers' from_pretrained loads. The weights are
the checkpoint's fp32 masters when it has them (load_params_only), and
the model type is the one the checkpoint recorded (hf_model_type, set by
tools/hf_to_native) unless --model_type is given. Loads on --device
(default "cuda").
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def main(argv=None) -> str:
    """Returns the output directory."""
    from megatron_tpu_torch.config import DTYPES, ModelConfig
    from megatron_tpu_torch.interop.hf import (
        hf_config_from_native, params_to_hf_state_dict,
    )
    from megatron_tpu_torch.models.params import empty_params
    from megatron_tpu_torch.training import checkpointing

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--load", required=True, help="native checkpoint dir")
    p.add_argument("--output", required=True, help="HF output dir")
    p.add_argument("--model_type", default=None,
                   help="llama | mistral | mixtral | falcon | gpt2 (default: "
                        "from the checkpoint)")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    saved = checkpointing.saved_run_config(args.load)
    cfg = ModelConfig(**saved["model"]).validate()
    model_type = args.model_type or saved.get("hf_model_type")
    if not model_type:
        raise SystemExit("--model_type required (not recorded in the "
                         "checkpoint)")
    dtype = DTYPES[args.dtype]
    params = checkpointing.load_params_only(
        args.load, empty_params(cfg, device=args.device, dtype=dtype))
    sd = {k: v.cpu() for k, v in
          params_to_hf_state_dict(params, cfg, model_type).items()}
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "config.json"), "w") as f:
        json.dump(hf_config_from_native(cfg, model_type,
                                        torch_dtype=args.dtype), f, indent=2)
    torch.save(sd, os.path.join(args.output, "pytorch_model.bin"))
    print(f"wrote HF checkpoint to {args.output}", flush=True)
    return args.output


if __name__ == "__main__":
    main()
