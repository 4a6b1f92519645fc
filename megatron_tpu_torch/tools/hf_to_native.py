"""Convert a HuggingFace checkpoint directory to a native checkpoint
(counterpart of the repo's tools/hf_to_native.py).

    python -m megatron_tpu_torch.tools.hf_to_native --model HF_DIR \\
        --output ckpts/llama2-7b [--dtype bfloat16] [--device cuda]

Reads the directory without transformers: config.json, and the weights
from *.safetensors (through the safetensors package, which must then be
installed) or else pytorch_model*.bin (torch.load, weights only). Writes
iteration 0 with a fresh optimizer state and the HF model type in the
saved config (hf_model_type), through training/checkpointing.py. The
state is built on --device (default "cuda").
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Any, Dict, Tuple

import torch


def read_hf_checkpoint(model_dir: str
                       ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """(config.json dict, state dict on the CPU) of an HF directory. All
    shards are read; safetensors files win over .bin files."""
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    bin_files = sorted(glob.glob(os.path.join(model_dir,
                                              "pytorch_model*.bin")))
    if st_files:
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(
                f"{model_dir} holds safetensors weights and the safetensors "
                "package is not installed; install it or convert the "
                "weights to pytorch_model.bin") from e
        for path in st_files:
            sd.update(load_file(path, device="cpu"))
    elif bin_files:
        for path in bin_files:
            sd.update(torch.load(path, map_location="cpu", weights_only=True,
                                 mmap=True))
    else:
        raise FileNotFoundError(
            f"no *.safetensors or pytorch_model*.bin in {model_dir}")
    return config, sd


def main(argv=None) -> str:
    """Returns the written checkpoint's directory."""
    from megatron_tpu_torch.config import OptimizerConfig, RunConfig
    from megatron_tpu_torch.interop.hf import (
        config_from_hf, hf_state_dict_to_params,
    )
    from megatron_tpu_torch.training import checkpointing
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, tree_map,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True, help="HF checkpoint directory")
    p.add_argument("--output", required=True, help="native checkpoint dir")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float16", "float32"])
    p.add_argument("--seq_length", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    hf_config, sd = read_hf_checkpoint(args.model)
    cfg = config_from_hf(hf_config, seq_length=args.seq_length)
    cfg = dataclasses.replace(cfg, params_dtype=args.dtype)
    model_type = hf_config["model_type"]
    print(f"converting {model_type} model: {cfg.num_layers} layers, "
          f"hidden {cfg.hidden_size}, vocab {cfg.vocab_size}", flush=True)
    params = hf_state_dict_to_params(sd, cfg, model_type, dtype=cfg.dtype)
    del sd
    params = tree_map(lambda t: t.to(args.device), params)
    state = init_train_state(OptimizerConfig(), params)
    path = checkpointing.save_checkpoint(
        args.output, state, iteration=0, consumed_samples=0,
        config={**RunConfig(model=cfg).to_dict(),
                "hf_model_type": model_type})
    print(f"wrote native checkpoint to {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
