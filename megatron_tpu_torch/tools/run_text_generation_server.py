"""Start the port's REST generation server on a random-init model.

    python -m megatron_tpu_torch.tools.run_text_generation_server \\
        --model_name llama2-7B --tokenizer_type null \\
        [--tokenizer_type GPT2BPETokenizer --vocab_file V --merges_file M] \\
        --serve_num_slots 8 --serve_max_seq_len 2048 --port 5000 \\
        [--serve_kv_paging --serve_page_size 16 --serve_prefill_chunk 32] \
        [--serve_speculative {ngram,model} --serve_spec_k 4 \
         --serve_draft_layers N --serve_draft_checkpoint DIR] \
        [--kv_cache_int8] [--serve_max_queue N] \
        [--serve_request_timeout S] [--serve_drain_timeout S] \
        [--serve_warmup] [--weight_int8 | --weight_fp8]

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m megatron_tpu_torch.tools.run_text_generation_server \\
        --tensor_model_parallel_size 2 --load ckpts/run ...
        [--serve_kv_paging ...]

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m megatron_tpu_torch.tools.run_text_generation_server \\
        --tensor_model_parallel_size 2 --pipeline_model_parallel_size 2 \\
        --load ckpts/run ...

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m megatron_tpu_torch.tools.run_text_generation_server \\
        --context_parallel_size 2 --serve_context_parallel --serve_kv_paging \\
        [--serve_cp_collectives {dense,int8,fp8}] \\
        [--serve_cp_geometry {ring,2d} --serve_cp_subgroup G] \\
        [--serve_cp_overlap {on,off}] [--serve_cp_comm_policy FILE] ...

The flag names are the JAX CLI's (tools/run_text_generation_server.py)
for what the port supports, plus --device (default cuda). Weights are
random from --seed, or loaded with --load, which is also the default
directory of POST /admin/reload. --serve_num_slots 0 serves one request
at a time through the one-shot loop. SIGTERM or SIGINT drains (503 to
new requests, the requests in flight finish within
--serve_drain_timeout) and exits; a second signal exits at once. With --serve_speculative
model the draft is the target's architecture cut to its first
--serve_draft_layers layers: loaded from --serve_draft_checkpoint (its
first N layers when the checkpoint is deeper), or else the target's own
first N layers (the stacked [L, ...] weights sliced, sharing their
memory), with a warning. --weight_int8 / --weight_fp8 quantize the
matmul weights and the token embedding at load (ops/weight_quant.py:
one byte a weight plus per-channel fp32 scales, dequantized a layer at a
time inside the forward); as on the JAX server they are exclusive, and
refused for MoE models (the experts stay bf16) and for a multi-rank
process. POST /admin/reload of such a server quantizes the new weights
into the served tensors.

--tensor_model_parallel_size N and --pipeline_model_parallel_size P
(the JAX CLI's flags) serve over N x P ranks of python -m
torch.distributed.run (NCCL on CUDA, gloo on the CPU or with
--distributed_backend gloo, as training): each rank holds its slices of
the params (its stage's layers at P > 1), loaded from a checkpoint
saved at any topology (--load; the sharded layout or the
one-file-per-field one) or built whole from --seed on its device and
cut to its slice (the tokens of the one-process server at the same
seed), and its kv heads' caches (or page pools, --serve_kv_paging).
A MoE model is served so too (its experts cut over the tensor ranks
inside each expert, ops/moe.py); the mesh is tp x pp only, as the JAX
server's: there is no expert axis in serving.
Rank 0 binds the HTTP port and logs; the others follow it. At N > 1
either engine's tick runs eagerly (no CUDA graph: a gloo collective
cannot be captured). At P > 1 the server runs one-shot through the
pipelined forward, as the JAX server does: --serve_num_slots is
ignored, --kv_cache_int8 is refused and beam search is a 400. Refused
above one rank, as the JAX server refuses them on a mesh:
--weight_int8/--weight_fp8, --serve_speculative and /admin/reload.

--serve_compress_collectives {none,int8,fp8} (with --serve_comm_policy, a
site-policy JSON) moves the engine's tensor-parallel reductions and
logits gather low-bit (quant/collectives.py); a no-op at tp 1.
--context_parallel_size C with --serve_context_parallel serves over
tp x C ranks through the ContextParallelEngine
(inference/context_parallel/): each sequence's KV pages striped over
the C context ranks, each layer's attention merged over a ring (or the
2d geometry, --serve_cp_geometry 2d --serve_cp_subgroup G) whose hop
moves --serve_cp_collectives bytes. It needs --serve_kv_paging and
refuses --kv_cache_int8, pipeline parallelism and the one-shot paths;
--serve_cp_lanes > 1 (the JAX server's CP x DP lanes) is refused.
"""

from __future__ import annotations

import argparse
import os

import torch


def server_tokenizer(args, vocab_size: int):
    """The tokenizer the flags name (the null tokenizer's ids are the
    model's table, vocab_size)."""
    from megatron_tpu_torch.tokenizer import build_tokenizer

    return build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merges_file=args.merges_file, tokenizer_model=args.tokenizer_model,
        vocab_size=vocab_size, vocab_extra_ids=args.vocab_extra_ids or 0,
        new_tokens=args.new_tokens)


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
                   choices=["null", "GPT2BPETokenizer",
                            "SentencePieceTokenizer", "HFTokenizer"],
                   help="null: ids in, ids out, its eod id the model's "
                        "vocab size; GPT2BPETokenizer needs --vocab_file "
                        "and --merges_file; SentencePieceTokenizer "
                        "--tokenizer_model; HFTokenizer a name or path in "
                        "--vocab_file (tokenizer/tokenizer.py)")
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--merges_file", default=None)
    p.add_argument("--merge_file", dest="merges_file", default=None,
                   help="the reference's spelling of --merges_file")
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--vocab_extra_ids", type=int, default=None)
    p.add_argument("--no_new_tokens", action="store_false",
                   dest="new_tokens",
                   help="do not add the special tokens to a sentencepiece "
                        "tokenizer")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--serve_profile_dir", default=None,
                   help="output dir of POST /admin/profile's on-demand "
                        "torch.profiler captures (default "
                        "runs/serve_profile); read a capture with "
                        "tools/trace_report")
    p.add_argument("--serve_num_slots", type=int, default=8,
                   help="KV-cache slots of the continuous-batching engine; "
                        "0 serves one request at a time through the "
                        "one-shot loop")
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
    p.add_argument("--serve_speculative", choices=("ngram", "model"),
                   default=None,
                   help="speculative decoding in the engine: per-slot "
                        "drafts + one batched [N, k+1] verify forward per "
                        "tick, exact accept/reject (greedy output is "
                        "token-identical to plain decode). 'ngram' is the "
                        "zero-weight prompt-lookup drafter; 'model' a "
                        "draft network (see --serve_draft_*)")
    p.add_argument("--serve_spec_k", type=int, default=4,
                   help="drafted tokens per slot per tick (the engine "
                        "reserves k positions of sequence headroom)")
    p.add_argument("--serve_draft_layers", type=int, default=None,
                   help="draft model depth (--serve_speculative model): "
                        "the target architecture cut to its first N "
                        "layers (default: the target's depth)")
    p.add_argument("--serve_draft_checkpoint", default=None,
                   help="checkpoint directory for the draft's weights "
                        "(its first --serve_draft_layers layers); without "
                        "it the draft serves the target's first layers")
    p.add_argument("--kv_cache_int8", action="store_true",
                   help="int8 KV cache (or page pools) with fp32 scales: "
                        "half the cache bytes of bf16, so twice the tokens "
                        "per card")
    p.add_argument("--serve_max_queue", type=int, default=None,
                   help="bound the engine's admission queue: requests "
                        "beyond this many waiters get HTTP 503 + "
                        "Retry-After (default: unbounded)")
    p.add_argument("--serve_request_timeout", type=float, default=None,
                   help="per-request deadline in seconds (engine path): a "
                        "queued or mid-decode request past it fails with "
                        "HTTP 504; a request's deadline_s may shorten it "
                        "but never extend it (default: no deadline)")
    p.add_argument("--serve_drain_timeout", type=float, default=30.0,
                   help="graceful-drain budget on SIGTERM/SIGINT: stop "
                        "admitting, wait up to this many seconds for the "
                        "requests in flight, then exit")
    p.add_argument("--serve_warmup", action="store_true",
                   help="run one throwaway request (kernel builds, first "
                        "prefill and decode) before /readyz turns 200")
    p.add_argument("--weight_int8", action="store_true",
                   help="int8 weight-only quantization at load: half the "
                        "weight bytes of bf16; single-card serving only")
    p.add_argument("--weight_fp8", action="store_true",
                   help="fp8 (e4m3) weight-only quantization at load: the "
                        "same byte a weight on a log grid; single-card "
                        "serving only")
    p.add_argument("--tensor_model_parallel_size", type=int, default=1,
                   help="serve over this many ranks of python -m "
                        "torch.distributed.run (tensor parallelism)")
    p.add_argument("--pipeline_model_parallel_size", type=int, default=1,
                   help="serve over this many pipeline stages (one-shot "
                        "only: the pipelined forward)")
    p.add_argument("--context_parallel_size", type=int, default=1,
                   help="serve over this many context ranks (with "
                        "--serve_context_parallel; the training flag's "
                        "name)")
    p.add_argument("--serve_compress_collectives",
                   choices=("none", "int8", "fp8"), default="none",
                   help="low-bit tensor-parallel collectives in the "
                        "engine: the per-layer output reductions and the "
                        "logits gather move int8/fp8 payloads with "
                        "per-chunk fp32 scales. No-op at tp 1")
    p.add_argument("--serve_comm_policy", default=None,
                   help="per-collective compression policy JSON "
                        '({"sites": {site: bool}}): sites left off stay '
                        "dense. Default: every site")
    p.add_argument("--serve_context_parallel", action="store_true",
                   help="context-parallel serving: each sequence's paged "
                        "KV striped over the context ranks, attention "
                        "merged over a ring. Needs --serve_kv_paging and "
                        "--context_parallel_size >= 2")
    p.add_argument("--serve_cp_collectives",
                   choices=("dense", "int8", "fp8"), default="dense",
                   help="transport of the CP ring hops: int8/fp8 compress "
                        "the attention partials; the log-sum-exp rows "
                        "stay fp32")
    p.add_argument("--serve_cp_comm_policy", default=None,
                   help="site-policy JSON gating the cp_ring and cp_a2a "
                        "sites")
    p.add_argument("--serve_cp_geometry", choices=("ring", "2d"),
                   default="ring",
                   help="'ring' merges over all cp ranks; '2d' factors "
                        "cp = cp_seq x cp_head: a head all-to-all inside "
                        "each --serve_cp_subgroup-sized subgroup, ring hops "
                        "only across subgroups")
    p.add_argument("--serve_cp_subgroup", type=int, default=0,
                   help="subgroup size (cp_head) of --serve_cp_geometry "
                        "2d: divides cp and a rank's query heads")
    p.add_argument("--serve_cp_overlap", choices=("on", "off"),
                   default="on",
                   help="ring schedule: 'on' posts hop l+1 before merging "
                        "hop l; 'off' the serial chain. Same numerics")
    p.add_argument("--serve_cp_lanes", type=int, default=1,
                   help="independent CP engine lanes on one host: only 1 "
                        "is served (ROADMAP.md item 12)")
    p.add_argument("--distributed_backend", default=None,
                   choices=["nccl", "gloo"],
                   help="the process group's backend: nccl on CUDA, gloo "
                        "on the CPU (default); gloo on CUDA only when "
                        "named here")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def check_parallel_flags(args) -> None:
    """The refusals of parallel serving, before any rank starts; at
    pp > 1 the engine's slots are dropped, as on the JAX server."""
    tp, pp = args.tensor_model_parallel_size, args.pipeline_model_parallel_size
    cp = args.context_parallel_size
    if tp < 1 or pp < 1 or cp < 1:
        raise SystemExit("--tensor_model_parallel_size, "
                         "--pipeline_model_parallel_size and "
                         "--context_parallel_size must be >= 1")
    check_cp_flags(args)
    if tp * pp * cp == 1:
        return
    refused = {
        "--weight_int8": args.weight_int8, "--weight_fp8": args.weight_fp8,
        "--serve_speculative": bool(args.serve_speculative)}
    for flag, on in refused.items():
        if on:
            raise SystemExit(
                f"{flag} at --tensor_model_parallel_size {tp} "
                f"--pipeline_model_parallel_size {pp} "
                f"--context_parallel_size {cp}: single-rank serving "
                "only, as on the JAX server's mesh")
    if pp > 1:
        if args.kv_cache_int8:
            raise SystemExit(
                "--kv_cache_int8 is not supported with pipeline-parallel "
                "serving (the pp>1 forward threads bf16 cache pairs); "
                "drop one of the two flags")
        if args.serve_num_slots:
            if os.environ.get("RANK", "0") == "0":
                print("pipelined (pp>1) serving runs one-shot; ignoring "
                      f"--serve_num_slots {args.serve_num_slots}",
                      flush=True)
            args.serve_num_slots = 0


def check_cp_flags(args) -> None:
    """The context-parallel flags' refusals (the JAX server's, and the
    lanes, which are not ported)."""
    cp = args.context_parallel_size
    if args.serve_cp_lanes != 1:
        raise SystemExit(
            f"--serve_cp_lanes {args.serve_cp_lanes}: several "
            "context-parallel engine lanes on one host are not ported (they "
            "need a dispatch protocol between lane leaders; ROADMAP.md item "
            "12, with the fleet)")
    if not args.serve_context_parallel:
        if cp > 1:
            raise SystemExit(
                f"--context_parallel_size {cp} serves only through the "
                "context-parallel engine: add --serve_context_parallel "
                "--serve_kv_paging")
        return
    if cp < 2:
        raise SystemExit("--serve_context_parallel needs "
                         "--context_parallel_size >= 2")
    if not (args.serve_kv_paging and args.serve_num_slots):
        raise SystemExit("--serve_context_parallel runs over the paged "
                         "engine: add --serve_kv_paging (and "
                         "--serve_num_slots > 0)")
    if args.kv_cache_int8:
        raise SystemExit("--serve_context_parallel supports no int8 KV "
                         "pools (--kv_cache_int8)")
    if args.pipeline_model_parallel_size > 1:
        raise SystemExit("--serve_context_parallel with "
                         "--pipeline_model_parallel_size > 1: the engine "
                         "runs the single-stage forward")


def weight_quant_mode(args, cfg):
    """"int8", "fp8" or None for --weight_int8 / --weight_fp8, with the
    JAX server's refusals."""
    if args.weight_int8 and args.weight_fp8:
        raise SystemExit("--weight_int8 and --weight_fp8 are exclusive")
    if not (args.weight_int8 or args.weight_fp8):
        return None
    mode = "int8" if args.weight_int8 else "fp8"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit(
            f"--weight_{mode} is single-card serving only (the quantized "
            "leaves change the tree the sharding specs mirror)")
    if cfg.num_experts is not None:
        raise SystemExit(
            f"--weight_{mode} does not cover MoE expert weights: the bulk "
            "of a MoE model's parameters would stay bf16 while the flag "
            "promises halved weight bytes; serve MoE without it")
    return mode


def load_model(args, mesh=None, log=print):
    """(cfg, params, iteration or None) for --load / --model_name; with a
    tensor-parallel mesh, this rank's slices of the params."""
    import dataclasses

    from megatron_tpu_torch.config import ModelConfig
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import (
        StatePlacement, empty_params, init_params,
    )
    from megatron_tpu_torch.training import checkpointing

    if not args.load:
        cfg = presets.from_model_name(args.model_name or "llama2-7B")
        log("WARNING: serving randomly initialized weights (no --load)")
        return cfg, init_params(cfg, args.seed, device=args.device,
                                mesh=mesh), None
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
        args.load, empty_params(cfg, device=args.device, mesh=mesh),
        iteration, placement=(None if mesh is None else
                              StatePlacement.of(cfg, mesh, zero1=False)))
    log(f"loaded checkpoint at iteration {iteration} from {args.load}")
    return cfg, params, iteration


def load_spec(args, cfg, params):
    """The engine's SpecConfig for --serve_speculative (None without it);
    with "model" it carries the draft's config and weights."""
    import dataclasses

    from megatron_tpu_torch.inference.speculative import SpecConfig
    from megatron_tpu_torch.models.params import empty_params
    from megatron_tpu_torch.training import checkpointing

    if not args.serve_speculative:
        return None
    spec = SpecConfig(k=args.serve_spec_k, drafter=args.serve_speculative)
    if spec.drafter != "model":
        return spec
    layers = args.serve_draft_layers or cfg.num_layers
    if not 1 <= layers <= cfg.num_layers:
        raise SystemExit(f"--serve_draft_layers {layers} not in [1, "
                         f"{cfg.num_layers}]")
    dcfg = dataclasses.replace(cfg, num_layers=layers).validate()

    def first(tree, copy):
        return {k: first(v, copy) if isinstance(v, dict)
                else (v[:layers].clone() if copy else v[:layers])
                for k, v in tree.items()}

    if args.serve_draft_checkpoint:
        ck = args.serve_draft_checkpoint
        iteration, _ = checkpointing.resolve_load_iteration(ck)
        depth = checkpointing.saved_run_config(ck, iteration).get(
            "model", {}).get("num_layers", cfg.num_layers)
        if depth < layers:
            raise SystemExit(f"--serve_draft_checkpoint {ck} has {depth} "
                             f"layers, fewer than the draft's {layers}")
        full = checkpointing.load_params_only(
            ck, empty_params(dataclasses.replace(cfg, num_layers=depth),
                             device=args.device), iteration)
        print(f"loaded draft checkpoint at iteration {iteration} from {ck} "
              f"(its first {layers} of {depth} layers)", flush=True)
        return dataclasses.replace(
            spec, draft_cfg=dcfg,
            draft_params={**full, "layers": first(full["layers"], True)})
    print(f"WARNING: draft model serving the target's first {layers} of "
          f"{cfg.num_layers} layers (no --serve_draft_checkpoint)",
          flush=True)
    return dataclasses.replace(
        spec, draft_cfg=dcfg,
        draft_params={**params, "layers": first(params["layers"], False)})


def main(argv=None, **server_kwargs):
    """server_kwargs go to inference.server.run_server (in-process
    callers pass `ready` and `service_out`). Under torch.distributed.run
    every rank calls it; rank 0 serves and returns when the server
    stops, the others return when rank 0 sends the stop."""
    from megatron_tpu_torch.parallel.distributed import (
        ServingChannel, destroy_distributed, initialize_distributed,
        local_device, serving_mesh,
    )

    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.serve_num_slots < 0:
        raise SystemExit("--serve_num_slots must be >= 0 (0: one-shot)")
    if args.serve_speculative and not args.serve_num_slots:
        raise SystemExit("--serve_speculative runs inside the engine: "
                         "--serve_num_slots must be > 0")
    check_parallel_flags(args)
    world = (args.tensor_model_parallel_size
             * args.pipeline_model_parallel_size * args.context_parallel_size)
    if not initialize_distributed(args.device, args.distributed_backend):
        if world > 1:
            raise SystemExit(
                f"serving over {world} ranks needs one process per rank: "
                "python -m torch.distributed.run --nproc_per_node "
                f"{world} -m megatron_tpu_torch.tools."
                "run_text_generation_server ...")
        return _serve(args, None, None, server_kwargs)
    try:
        mesh = serving_mesh(args.tensor_model_parallel_size,
                            args.pipeline_model_parallel_size,
                            args.context_parallel_size)
        args.device = str(local_device(args.device))
        if mesh.world_size == 1:
            return _serve(args, None, None, server_kwargs)
        return _serve(args, mesh, ServingChannel(mesh.control_group,
                                                 mesh.rank), server_kwargs)
    finally:
        destroy_distributed()


def _serve(args, mesh, channel, server_kwargs):
    """Serve (rank 0, or the only process) or follow (ranks > 0)."""
    from megatron_tpu_torch.inference.server import (
        GenerationService, run_server,
    )
    from megatron_tpu_torch.ops.kv_quant import kv_head_bytes

    leads = mesh is None or mesh.rank == 0

    def log(msg):
        if leads:
            print(msg, flush=True)

    cfg, params, iteration = load_model(args, mesh, log)
    weight_quant = weight_quant_mode(args, cfg)
    if weight_quant:
        from megatron_tpu_torch.ops.weight_quant import (
            quantize_params_for_serving, weight_bytes,
        )

        before = weight_bytes(params)
        params = quantize_params_for_serving(params, weight_quant)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
        log(f"serving {weight_quant}-quantized weights (matmul + "
            f"embedding tables): {weight_bytes(params) / 2**30:.2f} GiB "
            f"(from {before / 2**30:.2f} GiB)")
    speculative = load_spec(args, cfg, params)
    tokenizer = server_tokenizer(args, cfg.vocab_size)
    max_seq_len = args.serve_max_seq_len or min(cfg.seq_length, 2048)
    # bytes a cached position takes over all layers, K and V: int8 values
    # plus an fp32 scale per head, or the model dtype
    per_head = kv_head_bytes(cfg.head_dim, cfg.dtype, args.kv_cache_int8)
    tp = 1 if mesh is None else mesh.tp
    cp = 1 if mesh is None else mesh.cp
    row_bytes = 2 * cfg.num_layers * (cfg.n_kv_heads // tp) * per_head
    kind = "int8 + fp32 scales" if args.kv_cache_int8 else str(cfg.dtype)
    if args.serve_kv_paging and args.serve_num_slots:
        ps = args.serve_page_size
        pages = (args.serve_num_pages
                 or args.serve_num_slots * (-(-max_seq_len // ps)) + 1)
        log(f"paged KV pool: {pages} pages x {ps} tokens = "
            f"{row_bytes * pages * ps / 2**30:.2f} GiB ({kind})"
            + (f", {1 / cp:.3g} of it a context rank" if cp > 1 else ""))
    elif args.serve_num_slots:
        log(f"persistent KV cache: {args.serve_num_slots} slots x "
            f"{max_seq_len} tokens = "
            f"{row_bytes * args.serve_num_slots * max_seq_len / 2**30:.2f}"
            f" GiB ({kind})" + (f" per rank of {tp}" if tp > 1 else ""))
    kw = dict(engine_slots=args.serve_num_slots,
              engine_max_seq_len=max_seq_len, device=args.device,
              kv_paging=args.serve_kv_paging,
              page_size=args.serve_page_size,
              prefill_chunk=args.serve_prefill_chunk,
              num_pages=args.serve_num_pages,
              speculative=speculative, kv_cache_int8=args.kv_cache_int8,
              engine_max_queue=args.serve_max_queue,
              request_timeout=args.serve_request_timeout,
              reload_dir=args.load, weights_version=iteration,
              compress_collectives=args.serve_compress_collectives,
              comm_policy=args.serve_comm_policy,
              cp_serving=args.serve_context_parallel,
              cp_collectives=args.serve_cp_collectives,
              cp_comm_policy=args.serve_cp_comm_policy,
              cp_geometry=args.serve_cp_geometry,
              cp_subgroup=args.serve_cp_subgroup,
              cp_overlap=args.serve_cp_overlap == "on",
              profile_dir=args.serve_profile_dir)
    if mesh is not None:
        kw.update(mesh=mesh, channel=channel, cuda_graph=False)
        if mesh.pp > 1:
            log(f"pipeline parallel {mesh.pp} x tensor parallel {mesh.tp}: "
                "one-shot through the pipelined forward")
        elif mesh.cp > 1:
            log(f"context parallel {mesh.cp} x tensor parallel {mesh.tp}: "
                f"the paged KV striped over the context ranks, the "
                f"{args.serve_cp_geometry} merge over "
                f"{args.serve_cp_collectives} hops; the tick runs eagerly")
        else:
            log(f"tensor parallel {mesh.tp}: the engine's tick runs eagerly "
                "(cuda_graph=False: a gloo collective cannot be captured)")
        if not leads:
            GenerationService(cfg, params, tokenizer, **kw).follow()
            return
    run_server(cfg, params, tokenizer, host=args.host, port=args.port,
               drain_timeout=args.serve_drain_timeout,
               warmup=args.serve_warmup, **kw, **server_kwargs)

if __name__ == "__main__":
    main()
