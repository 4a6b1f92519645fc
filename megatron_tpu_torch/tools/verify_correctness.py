"""Side-by-side correctness check of the port against a HuggingFace model
(counterpart of the repo's verify_correctness.py).

The same weights go into the port and into transformers, the same
batches through both, and per-iteration max/mean absolute logit error
and loss delta are reported. Pass: the mean absolute error under
--max_avg_error (default 0.01 at fp32, 0.1 at 16-bit, the reference's
docs). --train_iters N instead runs N optimizer steps of the port's
Adam against torch.optim.AdamW and gates the worst per-step loss delta
and the final parameter delta.

    python -m megatron_tpu_torch.tools.verify_correctness \\
        --model /path/to/hf_dir --iters 10 [--load native_ckpt] \\
        [--data tokens.npy] [--batch 2 --seq 256] [--dtype bfloat16] \\
        [--train_iters 5] [--device cuda]

--model is a directory on disk (config.json and the weights, as
save_pretrained writes them); nothing is fetched. The port's side runs
the flash kernels (attention_impl "pallas"): on the card the logits
check launches B1, the training parity B1, B2 and B3; on the CPU the
wrappers take their plain versions. The HF model runs in fp32 on the
same device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

#: the parity bounds' defaults, (loss delta, param delta) by dtype:
#: fp32's are the JAX tool's; 16-bit ones are ten times looser, as the
#: logits bound is
TRAIN_BOUNDS = {"float32": (1e-3, 1e-3), "bfloat16": (1e-2, 1e-2)}


def _parse(argv):
    p = argparse.ArgumentParser(prog="verify_correctness")
    p.add_argument("--model", required=True,
                   help="HF model directory on disk (config.json + weights)")
    p.add_argument("--load", default=None,
                   help="native checkpoint (default: the HF weights "
                        "converted in memory)")
    p.add_argument("--data", default=None,
                   help=".npy int token array [N, S]; default random tokens")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--max_avg_error", type=float, default=None,
                   help="fail if the mean abs logit error exceeds this")
    p.add_argument("--train_iters", type=int, default=0,
                   help="run N optimizer steps on both stacks (the port's "
                        "Adam vs torch AdamW) and gate the per-step loss "
                        "delta and the final param delta; 0 = forward only")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--max_train_loss_delta", type=float, default=None,
                   help="fail if any per-step |loss_ours - loss_torch| "
                        "exceeds this (default by dtype: TRAIN_BOUNDS)")
    p.add_argument("--max_param_delta", type=float, default=None,
                   help="fail if the final param max-abs delta exceeds "
                        "this (default by dtype: TRAIN_BOUNDS)")
    return p.parse_args(argv)


def main(argv=None, log=print):
    """Returns the summary dict (the numbers the gate read); raises
    SystemExit on a failed gate."""
    args = _parse(argv)
    import numpy as np
    import torch
    from transformers import AutoModelForCausalLM

    from megatron_tpu_torch.interop.hf import (
        config_from_hf, hf_state_dict_to_params,
    )
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss

    if not os.path.isdir(args.model):
        raise SystemExit(f"--model {args.model}: not a directory (the tool "
                         "reads an HF model from disk, it fetches nothing)")
    device = torch.device(args.device)
    with open(os.path.join(args.model, "config.json")) as f:
        hf_config = json.load(f)
    cfg = dataclasses.replace(config_from_hf(hf_config, seq_length=args.seq),
                              params_dtype=args.dtype,
                              attention_impl="pallas").validate()
    vocab = hf_config["vocab_size"]
    hf_model = AutoModelForCausalLM.from_pretrained(
        args.model, dtype=torch.float32).to(device).eval()

    if args.load:
        from megatron_tpu_torch.models.params import init_params
        from megatron_tpu_torch.training import checkpointing

        params = checkpointing.load_params_only(
            args.load, init_params(cfg, 0, device=device))
    else:
        # copies: at fp32 the conversion would alias HF's own tensors,
        # which its optimizer updates in the training parity
        sd = {k: v.detach().clone() for k, v in hf_model.state_dict().items()}
        params = hf_state_dict_to_params(sd, cfg, hf_config["model_type"],
                                         dtype=cfg.dtype)

    if args.data:
        data = np.load(args.data)
    else:
        data = np.random.default_rng(0).integers(
            0, vocab, (max(args.iters, 1) * args.batch, args.seq))

    if args.train_iters > 0:
        return run_training_parity(args, cfg, params, hf_model, vocab, data,
                                   log)

    max_errs, mean_errs, loss_deltas = [], [], []
    for i in range(args.iters):
        batch = data[i * args.batch:(i + 1) * args.batch].astype(np.int64)
        if len(batch) < args.batch:
            break
        tokens = torch.from_numpy(batch[:, :-1]).to(device)
        labels = torch.from_numpy(batch[:, 1:]).to(device)
        with torch.no_grad():
            ref = hf_model(tokens).logits.float()
            ours = lm_forward(cfg, params, tokens).float()[..., :vocab]
        err = (ours - ref).abs()
        our_loss = float(cross_entropy_loss(ours, labels)[0])
        ref_loss = float(torch.nn.functional.cross_entropy(
            ref.reshape(-1, vocab), labels.reshape(-1)))
        max_errs.append(float(err.max()))
        mean_errs.append(float(err.mean()))
        loss_deltas.append(abs(our_loss - ref_loss))
        log(f"iter {i}: max_abs_err={max_errs[-1]:.3e} "
            f"mean_abs_err={mean_errs[-1]:.3e} our_loss={our_loss:.6f} "
            f"ref_loss={ref_loss:.6f} delta={loss_deltas[-1]:.3e}")
    summary = {"iters": len(max_errs),
               "avg_max_abs_err": float(np.mean(max_errs)),
               "avg_mean_abs_err": float(np.mean(mean_errs)),
               "avg_loss_delta": float(np.mean(loss_deltas)),
               "threshold": args.max_avg_error
               or (0.01 if args.dtype == "float32" else 0.1)}
    log(f"\nsummary over {summary['iters']} iters: "
        f"avg max_abs_err={summary['avg_max_abs_err']:.3e} "
        f"avg mean_abs_err={summary['avg_mean_abs_err']:.3e} "
        f"avg loss delta={summary['avg_loss_delta']:.3e}")
    if summary["avg_mean_abs_err"] > summary["threshold"]:
        raise SystemExit(f"FAIL: avg abs error "
                         f"{summary['avg_mean_abs_err']:.3e} > "
                         f"{summary['threshold']}")
    log("PASS")
    return summary


def run_training_parity(args, cfg, params, hf_model, vocab, data, log=print):
    """N-step optimizer parity: the port's Adam against torch AdamW, the
    same weights, data and hyperparameters on both stacks, gating the
    per-step |loss_ours - loss_torch| and the final param max-abs delta
    (torch's state dict converted into the port's layout through the same
    interop mapping, so layout bugs surface too; the port's fp32 masters
    when it keeps them).

    The semantics that line up with torch.optim.AdamW (the JAX tool's):
    decoupled weight decay inside the update (algebraically torch's
    p.mul_(1 - lr * wd)); bias correction with eps outside the sqrt;
    biases and norm scales never decay (the port tests by path name, as
    per-layer norm scales are stacked 2-D; torch by ndim); and clipping
    by min(1, clip / (global_norm + 1e-6)), torch's clip_grad_norm_."""
    import numpy as np
    import torch

    from megatron_tpu_torch.config import OptimizerConfig
    from megatron_tpu_torch.interop.hf import hf_state_dict_to_params
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, leaf_paths, make_optimizer_step, nest_paths,
    )

    n = args.train_iters
    device = next(hf_model.parameters()).device
    loss_bound, param_bound = TRAIN_BOUNDS[args.dtype]
    loss_bound = args.max_train_loss_delta or loss_bound
    param_bound = args.max_param_delta or param_bound
    opt_cfg = OptimizerConfig(
        lr=args.lr, lr_decay_style="constant", lr_warmup_iters=0,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad)

    decay, no_decay = [], []
    for p in hf_model.parameters():
        p.requires_grad_(True)
        (decay if p.ndim >= 2 else no_decay).append(p)
    torch_opt = torch.optim.AdamW(
        [{"params": decay, "weight_decay": args.weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=args.lr, betas=(opt_cfg.adam_beta1, opt_cfg.adam_beta2),
        eps=opt_cfg.adam_eps)

    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    state = init_train_state(opt_cfg, params)
    opt_step = make_optimizer_step(opt_cfg, train_iters=n)

    n_batches = max(1, len(data) // args.batch)
    loss_deltas = []
    for i in range(n):
        lo = (i % n_batches) * args.batch
        batch = data[lo:lo + args.batch].astype(np.int64)
        tokens = torch.from_numpy(batch[:, :-1]).to(device)
        labels = torch.from_numpy(batch[:, 1:]).to(device)

        torch_opt.zero_grad(set_to_none=True)
        t_logits = hf_model(tokens).logits.float()
        t_loss = torch.nn.functional.cross_entropy(
            t_logits.reshape(-1, vocab), labels.reshape(-1))
        t_loss.backward()
        if args.clip_grad > 0:
            torch.nn.utils.clip_grad_norm_(hf_model.parameters(),
                                           args.clip_grad)
        torch_opt.step()

        leaves = leaf_paths(state.params)
        for _, p in leaves:
            p.grad = None
        logits = lm_forward(cfg, state.params, tokens)[..., :vocab]
        loss = cross_entropy_loss(logits, labels)[0]
        loss.backward()
        grads = nest_paths({k: p.grad.float() for k, p in leaves})
        state, _ = opt_step(state, grads)
        our, ref_loss = float(loss.detach()), float(t_loss.detach())
        loss_deltas.append(abs(our - ref_loss))
        log(f"step {i}: our_loss={our:.6f} torch_loss={ref_loss:.6f} "
            f"delta={loss_deltas[-1]:.3e}")

    ref = dict(leaf_paths(hf_state_dict_to_params(
        hf_model.state_dict(), cfg, hf_model.config.model_type,
        dtype=torch.float32)))
    final = state.master if state.master is not None else state.params
    param_delta = max(float((t.detach().float() - ref[k]).abs().max())
                      for k, t in leaf_paths(final))
    worst = max(loss_deltas)
    summary = {"train_iters": n, "worst_loss_delta": worst,
               "param_delta": param_delta, "loss_bound": loss_bound,
               "param_bound": param_bound}
    log(f"\ntraining parity over {n} steps: worst loss delta={worst:.3e} "
        f"final param max-abs delta={param_delta:.3e}")
    if worst > loss_bound:
        raise SystemExit(f"FAIL: loss delta {worst:.3e} > {loss_bound}")
    if param_delta > param_bound:
        raise SystemExit(f"FAIL: param delta {param_delta:.3e} > "
                         f"{param_bound}")
    log("PASS")
    return summary


if __name__ == "__main__":
    main()
