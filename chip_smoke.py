#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (megatron_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases; any that fails makes the run exit non-zero (the later phases
still run, so one call shows every failure):

  1. build    compile every kernel from megatron_tpu_torch/csrc (one nvcc
              per source, all started together) and print the build
              seconds and -Xptxas -v lines.
  2. kernels  call each forward kernel's wrapper on the card at the serving
              and training paths' shapes (Llama-2-7B: H=32, D=128; S up
              to 2047 for serving, 4096 for training; flash_fwd also at
              S 1, 127, 129 and 1000 around its 128-row tiles, a ring
              stripe with Sq != Skv and delta != 0, bidirectional, D 64,
              GQA 4, q/k/v as views of a fused [B, S, 3, H, D] buffer,
              and phase 5b's Falcon-7B (Hq 71 over Hkv 1, D 64, S 2048)
              and GPT-2 1.3B (H 32, D 64, S 1024), and phase 7's
              per-rank shape at tp2 (16 q and 16 kv heads, S 2048), and
              phase 7g's context-parallel shapes: a stripe of 4096
              against a past stripe, 8192 queries at offset 8192
              against 16384 keys: FWD_CASES; 2b's BWD_CASES likewise;
              a plain version whose fp32 scores pass PLAIN_SCORE_BYTES
              runs over groups of kv heads) and hold
              it against its plain PyTorch version on the same bf16
              inputs, computed in fp32. Tolerance:
              |kernel - plain| <= 2e-2 + 2e-2 * |plain| elementwise (bf16
              inputs and outputs; the kernels also round P to bf16 for the
              tensor cores). Time kernel, plain version and one PyTorch
              library call (scaled_dot_product_attention, a yardstick the
              port never calls) with CUDA events, and compute each case's
              bound from its shapes and mask; print TFLOP/s and the bound's
              share of the kernel time. Each kernel line has two times:
              ms, CUDA events around eager calls (what a caller waits per
              call, the wrapper's host path included; plain_ms and
              library_ms are timed the same way, so ratios compare ms),
              and device_ms, the same calls captured in a CUDA graph and
              replayed (graph_ms: without the host's launch path, which
              sets ms where the kernel is short). The decode lines (8 slots x 2048
              positions: Sq 1 with Hq/Hkv 32/32 and 32/8, Sq 5 with 32/8
              and 32/32, and past one block's 64 query rows per kv head:
              Falcon-7B's Sq 1 and Sq 5 at 71/1 and D 64, i.e. 71 and 355
              rows, and Sq 9 at 64/8, 72 rows; and GPT-2 1.3B's Sq 1 at
              32/32, D 64, 1024 positions) also print the split-K
              launch: kv tiles per split, splits and grid (kv heads x row
              tiles on its x axis).
  2c. paged    the paged decode kernel (paged_flash_decode) against its
              plain version (gather + the fp32 decode reference), same
              tolerance as phase 2: B 8, 128 table entries of ps 16 (2048
              positions), H 32, D 128, Sq 1, kv_lengths 1..2048, physical
              pages a seeded permutation of the pool with two rows sharing
              their first 32 pages; Sq 5 at H 32 (the paged verify form
              phase 3c launches); Hq 32 / Hkv 8, Sq 5 with window 256
              and scratch entries behind the window; ps 8 and ps 64; the
              three row-tile cases of phase 2 at ps 16. Time
              the kernel, the plain version, SDPA on the gathered dense
              view (the library yardstick) and the dense flash_decode
              kernel on that view (what paging costs), and compute each
              shape's bound. Then B5's partial form (return_lse: fp32 o
              and the rows' lse, a context-parallel rank's stripe), in a
              child process with a timeout: B 8, ps 16, Sq 1, H 32, D 128
              over a 128-entry local table with local lengths 0, 1, 16,
              1000, 17, 64, 1500 and 2048, against
              paged_flash_decode_reference(return_lse=True): o at the
              same tolerance, lse within 2e-2, the empty rows' o 0 and
              lse at NEG_INF; timed like the rest (eager, graph, plain,
              SDPA on the gathered view).
  2b. backward  the dq and dk/dv kernels at the training shapes (S 4096,
              H 32, D 128 causal; GQA G=4 with window 256; ragged S 1000;
              and the forward's extra shapes: BWD_CASES)
              against the plain fp32 backward of the same bf16 inputs and
              the same o/lse, and the three original cases again at a
              second seeded draw (BWD_DRAW2_SEED). Tolerance relative to
              each tensor's largest plain magnitude M: |kernel - plain| <=
              2e-3 * M + 2e-2 * |plain| (the JAX package's own backward
              test, tests/test_pallas_attention.py; the kernels round p
              and ds to bf16 for the tensor cores, the dq kernel ds as a
              bf16 hi + lo pair, the plain version keeps fp32). Each line
              prints its margin (largest err / allowed, <= 1 passes); the
              dq_rounding lines hold a plain dq with ds rounded once to
              bf16 against the same gate, beside the kernel's margin.
              The library yardstick is the backward of
              scaled_dot_product_attention at the same shape.
  3. serving  start the port's HTTP server in-process (Llama-2-7B at full
              width and depth, random init from a seed, bf16, 8 slots,
              2048-token slots, null tokenizer), send 4 concurrent greedy
              requests of 5, 100, 700 and 1500 prompt tokens x 32 new
              tokens, repeat one, teacher-force every finished sequence
              through the plain path (the dense attention) and require
              the engine's token to be its argmax, or a near-tie within
              the plain bf16 path's own error against fp32, at >= 99% of
              positions (teacher_force), and require the launch counters
              to equal 32 x prefills and 32 x decode ticks with no
              dense-fallback warning. The engine's decode tick is one
              CUDA graph captured at start and replayed (its launches
              counted per replay); engine_decode_recompiles_total must
              read 0. After that run, one more request under
              torch.profiler: the decode counters' delta must equal the
              flash_decode kernels the device ran (the counter under
              replay is the capture's count, so the trace confirms it).
              The model and cache are freed before training.
  3b. paged   the same server with kv_paging (16-token pages, 32-token
              prefill chunks, the default pool): the phase-3 traffic and
              its repeat, then two requests sharing the first 512 tokens
              of the 700-token prompt; then the paged engine in-process
              with a 147-page pool on the four prompts, which preempts the
              1500-token request. Gates: every request answers prompt +
              32 tokens, >= 2 prefix hits, >= 1 preemption, the
              teacher-forced gate on every sequence, paged_flash_decode
              launched 32 x decode ticks with flash_decode and flash_fwd
              at 0, no dense-fallback warning and no capture beyond the
              warm-up one.
  3c. spec    speculative serving (--serve_speculative, k SPEC_K) through
              the server on both engines, the 5- and 100-token phase-3
              prompts plus one of 512 tokens repeating a 64-token
              pattern, three drafters:
              ngram (on random weights: no draft accepted), model at
              full depth (the target's own weights: near-full
              acceptance), model cut to the target's first
              SPEC_PARTIAL_LAYERS (which accepts part of its drafts: the
              rollback after 0 < a < k, the draft cache overwritten past
              it, paged write spans across a partial accept). Gates per
              run: every request
              answers prompt + 32 tokens; the launches by form equal
              32 x ticks of the Sq k + 1 verify form (flash_decode dense,
              paged_flash_decode paged) plus (k + 1) x draft layers x
              ticks of the Sq 1 form for the model drafter, and flash_fwd
              (target + draft layers) x prefills dense, 0 paged;
              engine_decode_recompiles_total 0; a full-depth draft
              accepts at least half its drafts; the SPEC_PARTIAL_LAYERS
              draft accepts some but not all, with at least one
              slot-tick of 0 < a < k (engine_spec_accept_length). Each
              run prints its cut tokens (accepted past max_new_tokens,
              never emitted). The n-gram engine also
              runs in-process eagerly (cuda_graph=False) and by graph on
              the same traffic: tokens identical, the largest logprob
              difference and both tick means printed. Every distinct
              sequence passes phase 3's teacher-forced gate (argmax or a
              bf16 near-tie): speculative greedy tokens may part from the
              plain ones only at a near-tie, since the verify's GEMMs run
              at other shapes.
  3d. control serving control at full width and depth unless stated:
              (a) a one-shot server (engine_slots 0) answers the phase-3
              prompts x 32 greedy tokens, serialized, through the dense
              attention (no kernel launch), under the teacher-forced
              gate; (b) a "tokens_to_generate": 0 request scores the four
              prompts in one flash_fwd pass (32 launches) and agrees with
              the plain path's logprobs within twice each position's bf16
              band (the largest |bf16 - fp32| logit difference there) at
              >= 99% of positions; (c) beam search, BEAM_WIDTH beams of
              BEAM_TOKENS tokens on the 100-token prompt: the best beam
              scores at least the greedy sequence's length-penalised
              logprob and every beam re-scores through score_tokens to its
              score, both within twice the plain bf16 path's mean
              |bf16 - fp32| logprob error over the sequence's own
              BEAM_TOKENS positions; (d) an 8-slot
              engine with max_queue CONTROL_QUEUE answers CONTROL_BURST
              concurrent 1500-token requests with some 503s (each with
              Retry-After) and the rest in full, a deadline_s of
              CONTROL_DEADLINE_S with 504 and "timeout": true, then the
              phase-3 traffic with phase 3's tokens and launches; (e) on
              the same server /readyz is 503 (warmed false) with /healthz
              200 until warmup() ran, then a drain answers /api 503 with
              Retry-After and /readyz 503, and readmit serves again; (f)
              the depth cut to RELOAD_LAYERS (printed): POST /admin/reload
              of RELOAD_SEED's weights from save_params_checkpoint under
              replay, after which the tokens equal a fresh engine's on
              those weights and differ from before, with no capture beyond
              the warm-up one, the decode counter at RELOAD_LAYERS x
              ticks, weights_version 1 in every response and a torn
              checkpoint answered 409; the reload's wall and bytes are
              printed; (g) the phase-3 traffic through int8 servers on
              both engines (flash_fwd 32 x prefills dense, the decode
              kernels 32 x ticks) under the teacher-forced gate run with
              the same int8 round trip, then each engine's graph tick with
              bf16 and int8 caches over 8 slots of 5 .. 1500-token prompts
              (device and wall ms a tick, cache bytes, peak memory), the
              paged engine's at CONTROL_PAGED_TICK_LAYERS layers (cut for
              the wall).
  3e. weight  Llama-2-7B at full size through the server on the dense
              engine with int8 and then fp8 weight-only quantization
              (ops/weight_quant.py, the server's --weight_int8 /
              --weight_fp8): the phase-3 traffic, launches flash_fwd 32 x
              prefills and flash_decode 32 x ticks, no capture beyond the
              warm-up one, phase 3's teacher-forced gate against the plain
              path on the same quantized weights (and the same gate
              against the bf16 model, reported, not gated), the weight
              bytes resident, and the graph tick's device time with bf16
              (3d's dense bf16 tick when 3d ran), int8 and fp8 weights,
              in this call.
  3f. text    the text path at Llama-2-7B's full width and depth (bf16,
              8 slots x 2048): phase 6a's vocabulary learner (loop_vocab:
              256 byte symbols + 400 merges + <|endoftext|>, ~660 ids
              over the 32,000-row table) writes vocab.json and
              merges.txt, and the server starts through
              run_text_generation_server's own main and flags
              (--tokenizer_type GPT2BPETokenizer --vocab_file
              --merges_file, a thread of this process). Four text
              prompts of 5/100/700/1500 BPE tokens as concurrent greedy
              PUT /api requests x 32 tokens; two through
              tools/text_generation_cli in a child process (stdin piped);
              then MSDP: 16 WoW dialogues through msdp_preprocess's
              process_wow_dataset, get_knwl_gen_prompts,
              get_resp_gen_prompts and prepare_input, msdp's
              prompt-knowledge and prompt-response (6 examples a
              prompt, the 2048-token slot's fit) on 8 samples through
              --megatron_api_url (32 tokens), eval-f1 of both (random
              weights: F1 near 0, printed). Gates: every request returns
              its prompt's text; every id the server decodes is below the
              tokenizer's vocabulary (the sampling clamp); flash_fwd 32 x
              prefills and flash_decode 32 x ticks over the whole phase;
              the four text sequences pass phase 3's teacher-forced gate,
              and the one-shot generate_tokens on the server's weights
              is reported beside them (tokens agreeing before the first
              difference). TTFT and TPOT of the phase's requests printed.
              The memory-fit processes (phase 4) start with this phase.
  4. training write a synthetic corpus (Zipf token ids, 32000 vocab, from
              SEED) with the port's MMapIndexedDatasetBuilder into
              megatron_tpu_torch/build/, then call
              megatron_tpu_torch.tools.pretrain_gpt.main in-process:
              Llama-2-7B at full width cut to 8 layers, S 4096, bf16,
              micro-batch 1, global batch 2 (2 microbatches), selective
              recompute, the flash kernels, 8 steps at a constant lr
              TRAIN_LR, an evaluation every 4 steps. Require finite
              losses, no skipped step, a first loss within 0.5 of
              first_loss_expected(), a last loss at least LOSS_DROP_GATE
              below the first, exact launch counts (see
              expected_train_launches) and no dense-fallback warning;
              print step time, tokens/s, MFU and peak memory. Before the
              run, training/aot's fit report of this step (tools/
              hbm_check, a process of its own tracing the step under
              fake tensors on the host's CPU): the measured
              max_memory_allocated must lie within FIT_BAND of its
              per-card bytes.
  4d. proofs  (memory_proofs, after 4c) hbm_check --proof
              llama2_7b_dp2tp4 and llama2_70b_dp2tp8pp4 against 80 GiB,
              traced on the host's CPU since phase 3f: each must fit.
  4b. dense   one forward + backward of a 2-layer model of the same width
              at S 4096, same init and batch, through the kernels and
              through the dense attention with autograd: the loss, the
              gradient norm and every gradient leaf must agree (gates at
              the constants below).
  4c. fp8     the fp8 training products (ops/fp8.py): fp8_matmul at a
              Llama-2-7B block's product shapes, both formats, against
              its plain version (forward and both gradients), then
              FP8_STEPS steps of the width x FP8_LAYERS in bf16,
              --fp8_hybrid and --fp8_e4m3 through pretrain_gpt from the
              same weights and batches: each fp8 loss within
              FP8_LOSS_RTOL of bf16's, finite and falling, exact
              launches; the step times printed side by side.
  5. finetune the finetuning path, in a temporary directory (its df
              printed first; the phase fails with less than 40 GB free):
              an HF-layout Llama at Llama-2-7B width cut to FT_LAYERS = 1
              layer (0.464 B parameters; cut from 2 layers for time),
              bf16 from a seeded generator on the
              card, written as config.json + pytorch_model.bin ->
              tools/hf_to_native (iteration 0, 6.5 GB with the fp32
              masters and moments; native_to_hf of it must equal the
              input bitwise) -> 16 synthetic chats of 300 to 6000 tokens
              through tools/preprocess_instruct_data (null tokenizer) ->
              tools/finetune three times at S 4096, bf16, the flash
              kernels, selective recompute, micro-batch 1, global batch
              2, lr 1e-5 constant, scalar_loss_mask 0.1: A 4 steps from
              the converted checkpoint (--finetune), B 2 steps and a
              save, C resumed from B's save to step 4 and saved. Gates:
              C's losses at steps 3-4 and its final params, masters, mu
              and nu equal A's bitwise (the first differing tensor is
              named); each run's launches equal expected_train_launches
              for FT_LAYERS layers. Then run_text_generation_server
              --load C answers two greedy requests (its params must equal
              C's masters in bf16, flash_decode FT_LAYERS launches a
              tick, phase 3's
              teacher-forced gate) and native_to_hf -> hf_to_native ->
              native_to_hf of C must be an identity. Prints the losses,
              step time, checkpoint bytes, save stall / commit / load /
              crc32 times and the launch counts.
  5b. families Falcon-7B at full width and depth (6.92 B parameters,
              71 query heads over 1 kv head, D 64, parallel attention,
              tied 65024-row vocab; random init from SEED, bf16) through
              the HTTP server on the dense and the paged engine: the
              phase-3 prompts x 32 greedy tokens and a repeat, every
              answer prompt + 32 tokens, launches flash_fwd 32 x prefills
              and flash_decode 32 x ticks (paged: paged_flash_decode 32 x
              ticks, the rest 0), engine_decode_recompiles_total 0, then
              phase 3's teacher-forced gate on every sequence and each
              engine's graph tick over 8 filled slots; Falcon-7B width
              cut to 4 layers trained 4 steps at S 2048 through
              pretrain_gpt under selective recompute and again under
              --recompute_granularity full --recompute_method block
              --recompute_num_layers 2 (peak memory of both printed),
              each with finite losses falling by FAMILY_LOSS_DROP_GATE
              and exact launch counts (block:2 recomputes the first two
              layers' forwards); phase 4b's kernel step against a dense
              step at Falcon width x 2 layers, S 2048, the kernel step
              through the chunked cross-entropy (512-token chunks of the
              tied LM head). GPT-2 1.3B (absolute positions over 1024,
              biases, tied 50304-row vocab) at full size: served by the
              dense engine (prompts of 5, 100, 500 and 900 tokens, the
              same gates) and trained 2 steps at S 1024.
  5c. mixtral Mixtral-8x7B's width (h 4096, ffn 14336, 8 experts top-2,
              32/8 heads, vocab 32000, rope theta 1e6), random init from
              SEED, bf16: (a) cut to MIXTRAL_SERVE_LAYERS = 16 layers
              (23.5 B parameters, 47.0 GB; full depth's 93.4 GB does not
              fit one card, and weight quantization does not cover the
              experts) with the HF conversion's capacity factor 8
              (dropless), through the HTTP server on the dense and the
              paged engine, each with the captured tick: phase 5b's
              serving gates, phase 3's teacher-forced near-tie rate on
              every sequence (the fp32 referee upcast one layer at a
              time; reported, not gated: bf16 rounding flips top-k
              routing decisions, so one referee's band does not cover
              another order's routing) and the dense graph tick's device
              time; the engines' MoE path gated instead in fp32 at
              MIXTRAL_FP32_LAYERS = 4 layers with the dense attention
              (no kernel takes fp32), both engines eager: each token the
              fp32 plain path's teacher-forced argmax at >= 99% of
              positions; (b) a dropless layer
              (torch._grouped_mm) against the capacity layer at ample
              capacity at a small shape, forward and gradients, and the
              capacity layer's dispatch/combine time at the training
              shape; (c) pretrain_gpt --model_name mixtral-8x7B at 2
              layers (3.16 B parameters), S 8192, 2 x 1, phase 4's flags
              and lr: finite losses, no skipped step, a "moe aux loss"
              in every log line, exact launches; step time, MFU by the
              config's own FLOPs, peak memory. The cuts print as
              `reduced`.
  5d. encoder the encoder families at their published widths, random
              init from SEED, bf16, in a temporary directory: a
              sentence-level corpus, titles, MNLI TSVs and RACE dirs
              the script writes (ids as text for the null tokenizer);
              (a) tools/pretrain_bert at BERT-large (24 x 1024, 16
              heads, S 512, vocab 30592) with the SOP head, saved; (b)
              tasks/main MNLI at S 128 and RACE at S 512 from (a)'s
              checkpoint with --head_lr_mult 10; (c) tools/pretrain_t5
              at T5-base (12 + 12 x 768, 12 heads, encoder 512, decoder
              128, vocab 32128, 100 extra ids); (d) tools/pretrain_ict
              at BERT-base width, separate towers, S 256, ict_head_size
              128. Each family then builds a TrainLoop with its entry
              point's hooks and init: gates: the entry point's first
              bf16 loss within ENC_BAND of the same batch's fp32 loss
              (the init upcast, TF32 off), ENC_FIT_STEPS steps on that
              one batch make its loss fall, every loss finite, and for
              (b) the loaded encoder leaves (params and fp32 masters)
              equal (a)'s checkpoint bit for bit. Prints step ms,
              tokens/s and peak memory a family, and the B1-B5 launches
              of the phase (these families take the dense attention, as
              in the JAX package: 0 expected, not asserted); (e) ORQA on
              (d)'s saved towers: tools/build_retrieval_index over the
              corpus's blocks, tasks.orqa on ORQA_QUESTIONS questions cut
              from indexed blocks (hit rates printed, ordered), and
              tasks.main RET-FINETUNE-NQ from (d)'s checkpoint,
              ORQA_FIT_STEPS steps on one batch of generated DPR rows
              (its loss must fall).
  6. loop     the loop and the data, in a temporary directory: (a) a
              seeded JSONL corpus (20,000 documents of Zipf-drawn words),
              a GPT-2 byte-level vocabulary learned from it and written
              here (256 byte symbols, 400 merges, <|endoftext|>), the
              corpus through `python -m
              megatron_tpu_torch.tools.preprocess_data --workers 4
              --append_eod` (docs/s, tokens/s), and the native index
              builder, built into megatron_tpu_torch/build, held equal
              to its Python version on this corpus; (b) GPT-2 1.3B at
              full size through pretrain_gpt on that corpus
              (--dataloader_type cyclic --eod_mask_loss, 2 x 1, lr 1e-6,
              8 steps, --metrics perplexity accuracy, timers level 2,
              params norm, memory, journal, /metrics scraped mid-run,
              flight recorder, a torch.profiler window over step 3),
              once --no_async_loop and once async: losses bitwise equal,
              one host sync a step, the native index builder used, the
              Chrome trace naming flash_fwd, flash_bwd_dq and
              flash_bwd_dkv (read by the port's trace reader,
              telemetry/tracing, as is every trace below), exact
              launches; tools/trace_report on each run's trace prints its
              self-time table, names the three kernels and gives the
              idle share this phase prints; median step, tokens/s, MFU,
              device idle share in the window, data wait and goodput
              shares printed; a 2-step replay check at full size (two
              runs of a step bitwise equal); (c) five fault runs at
              GPT-2 width x 2 layers in child processes at once:
              nan_loss:3:3 rolls back and its steps 6-8 equal a
              --skip_iters 3 4 5 run's bitwise; preempt_at:5 commits a
              "preemption" checkpoint and exits 0, and its resume equals
              an uninterrupted run bitwise (notice -> commit printed);
              hang_step:4 exits 70 with a flight bundle; corrupt_step:2
              under --replay_check_interval 2 raises SDCError;
              --save_interval auto takes a cadence and saves.
  7. parallel multi-GPU training through python -m
              torch.distributed.run (each rank runs this script's
              --rank-run mode: tools/pretrain_gpt's main on phase 4's
              corpus, its kernel launches, losses, grad norms and step
              times written to a file): (a) one rank over NCCL, phase
              4's run through the parallel code at degree 1: its losses
              must equal phase 4's bitwise, its step time printed
              beside phase 4's; (b) two ranks sharing the card over gloo
              (NCCL refuses two ranks on one card; CUDA tensors staged
              through host memory) at Llama-2-7B width x PAR_LAYERS
              layers, S PAR_SEQ, global batch PAR_GLOBAL, micro-batch 1,
              bf16, selective recompute, PAR_STEPS steps: tp2 with
              sequence parallelism, pp2 (1F1B), pp2 with two virtual
              chunks (interleaved) and dp2 with ZeRO-1, each held to one
              single-process run of the same model, weights and batches
              (losses within PAR_LOSS_ATOL, grad norms within a relative
              PAR_NORM_RTOL, the validation loss too; margins printed),
              exact launches per rank, the step time and, from a
              torch.profiler trace of the last step on rank 0, the share
              of it inside the comm.* ranges of parallel/mappings.py:
              gloo-through-host numbers, not NCCL ones; (c) the sharded
              checkpoint: tp2_sp saves asynchronously at its last step
              (--save); tp2_sp, pp2 and pp2 x vpp2 resume from it and
              take one more step (every run of (b) and (c), after 7d
              and 7e, is one launch of two ranks: --rank-serve OUT --
              ARGV [--then ARGV]...),
              each within PAR_LOSS_ATOL of the single-process run's
              step PAR_STEPS + 1 (that run takes one step more), the two
              pipeline topologies within PAR_RESUME_ATOL of each other
              and within PAR_LOSS_ATOL of tp2_sp's; its bytes against a world-1 save's, each rank's
              save stall, commit or vote, load seconds and bytes read;
              a world-1 run_text_generation_server --load serves it one
              request.
  7d. tp2     (parallel_serving; run first in phase 7's two-rank
              launch, with 7e) Llama-2-7B's width x TP_SERVE_LAYERS
     serving  served at tp2 by two gloo ranks sharing the card (each is
              this script's --rank-serve mode): the dense engine with an
              eager tick, 8 slots x 2048, phase 3's traffic, then
              TP_TICKS ticks over 8 filled slots timed and traced on rank
              0 (kernel ms, gloo's host copies, the comm.* share), then
              one request through the one-shot server (--serve_num_slots
              0); tokens against the one-process plain path by phase 3's
              teacher-forced gate, launches per rank (B1 at S <= 2047 and
              B4 at B 8, 16 heads of D 128 a rank: both held against
              their plain versions in phases 2/2a), TTFT and tick wall.
  7e. the     (parallel_serving, the rest of 7d's launch) (a) the paged
     dense    engine at tp2 on 7d's weights: phase 3b's traffic and
     families 147-page pool in chunks of TP_PREFILL_CHUNK (a
     at more  preemption), the 100-token prompt again (a prefix hit),
     than one then its tick over filled slots timed and traced; B5 = 32
     rank     x ticks a rank, B1 = B4 = 0; (b) Llama-2-7B at pp2 through
              the one-shot server's pipelined forward: the 100-token
              prompt x 32 (phase 3's gate) and the four prompts scored
              (phase 3d's scoring gate), B1 = 16 a stage, the p2p share
              of the request traced; (c) Falcon-40B's width x
              FALCON_TRAIN_LAYERS trained at tp2 + SP with --metrics
              against its one-process run (phase 7's tolerances; B1-B3
              as counted), and its predicted ids over 2048 seeded tokens
              at the seeded init: the vocab-parallel argmax equal to the
              argmax of the gathered logits on each rank, and against
              the one-process plain logits at phase 3's gate; (d)
              Falcon-40B's width x FALCON_SERVE_LAYERS on the tp2 dense
              engine, phase 3's traffic (phase 3's gate; B1, B4
              counted). The new per-rank kernel shapes
              (B1-B3 at S 2048 Hq 64 Hkv 4 D 64, B4 at R 16, B5 at 16
              heads, ps 16) are phase 2-2c cases.
  7f. MoE   (parallel and parallel_serving, in the same launch)
     above   Mixtral-8x7B's width: (a)-(c) MIXTRAL_PAR_LAYERS layer at
     one     S MIXTRAL_PAR_SEQ, global batch PAR_GLOBAL, bf16,
     rank    selective recompute, PAR_STEPS steps, at tp2 + SP (capacity
              1.25, micro-batch 2), ep2 + ZeRO-1 (capacity) and ep2
              dropless (micro-batch 1 a rank), each held to the one-
              process run of its dispatch at micro-batch 2 (losses,
              validation loss and moe_aux_loss within PAR_LOSS_ATOL,
              grad norms within PAR_NORM_RTOL, margins printed), exact
              launches a rank, step time, peak GiB a rank and the
              comm.* share of the traced step with comm.all_to_all
              apart; (d) the width x MIXTRAL_PAR_SERVE_LAYERS on the tp2
              dense engine with the dense attention, phase 3's traffic,
              in fp32 (each token the one-process fp32 plain path's
              teacher-forced argmax at >= MIXTRAL_FP32_GATE) and in bf16
              (phase 3's near-tie rate, reported). The tp2 rank's
              and ep2 rank's B1-B3 shapes (S MIXTRAL_PAR_SEQ, Hq 16 Hkv
              4 and Hq 32 Hkv 8, D 128) are phase 2/2b cases, and so
              are 7b's (S PAR_SEQ, 16 heads at tp2, 32 elsewhere).
  7g. context (parallel, last in the same launch) Llama-2-7B's width x
     paral-  CP_LAYERS at S CP_SEQ, CP_STEPS steps at cp2 with
     lelism  --attention_impl ring (zig-zag stripes of CP_STRIPE),
              ulysses and pallas (the all-gathered K/V), each held to
              the one-process run at the same S (losses, grad norms and
              the validation loss at phase 7's gates), the ranks in
              agreement, and each rank's B1-B3 launches printed and
              equal to the schedule's (the ring: 5 stripe pairs a layer
              and pass at cp2).
  7h. long    (last in the same launch) serving at cp2 and compressed
     context  TP collectives: (a) Llama-2-7B's width x CP_SERVE_LAYERS
              through the context-parallel server (--serve_context_
              parallel: the paged KV striped over the 2 ranks, each
              layer's attention merged over an overlapped ring of dense
              hops; a rank's decode partial on B5's partial form, a
              chunk's on the plain stripe path), 8 slots x 8192, pages of
              16, chunks of 128, phase 3b's prompts plus one of 6000
              tokens x 32 new tokens, then its tick over 8 filled slots
              timed and traced; (b) the same with int8 hops; (c) 7d's
              tp2 engine server with --serve_compress_collectives int8,
              phase 3's traffic (its tick wall beside 7d's). Gates: phase 3's
              teacher-forced match for (a) and (b), and for (c) with both
              plain passes through the same int8 collectives, run on the
              ranks (phase 3's against the uncompressed path reported
              beside it: the transport's error is outside the bf16
              band by design, as an int8 cache's is); B5 partial-form
              launches = layers x ticks a rank (B1 = B4 = 0),
              engine_cp_ring_steps_total = layers x (ticks + chunks), the
              cp byte counters = cp_ring_comm_bytes x ticks and chunks,
              (c)'s engine_comm_*_bytes = forward_comm_bytes x ticks +
              each prefill's, B1/B4 as 7d's.
  7i. the     (in the same launch, after 7g) the encoder families'
     encoder  entry points on the two ranks (ENC_PAR_CASES, published
     families widths x ENC_PAR_LAYERS): BERT-large at tp2 + SP, T5-base
     above    on the interleaved pp2 ring, ICT's BERT-base towers at dp2
     one rank + ZeRO-1, ENC_PAR_STEPS steps each, held to one process
              at the same global microbatches (phase 7's gates), the
              ranks in agreement; step s, the comm.* share of a traced
              step and peak GiB a rank printed, B1-B5 counted (0: the
              dense attention); BERT's tp2 state loaded by a world-1
              TrainLoop bit for bit (each rank's slices' crc32).
  7j. comm    (last in the same launch) the train_tp2_sp comm contract
     contract (analysis/contracts.py): its loop at the pinned tiny
              geometry with a --profile window of two steps, on the
              card over gloo; tools/trace_report --contract train_tp2_sp
              --executions 2 --check on rank 0's trace: every
              collective's comm.* calls equal the golden manifest's
              (measured on the CPU) times 2, and two train_step markers.
  8. report   each phase's wall seconds as it ends and all of them
              after phase 7d (seconds_by_phase, with the total), then one
              JSON line listing each kernel with its launches on its path
              (serving, paged_serving, speculative_serving,
              serving_control, weight_quant, text_serving, training,
              fp8_training,
              finetune, families, mixtral, loop, parallel,
              context_parallel, parallel_serving, cp_serving and
              compressed_tp_serving; B5's partial form on a line of its
              own as paged_flash_decode_lse),
              then the card's name and power limit, then {"ok": true,
              "device": {...}} as the last line.

`--phases NAME,...` runs only those phases (the names of
seconds_by_phase) and prints no result (exit 1).

It needs one CUDA card; with none (or outside a checkout) it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
import warnings
import zlib
from typing import Optional

ATOL = 2e-2
RTOL = 2e-2
# backward kernels: err <= BWD_ATOL_REL * max|plain| + BWD_RTOL * |plain|,
# the JAX package's own backward gate. The kernels round p and ds to bf16
# (relative error 2^-9) before summing them over up to 4096 keys or
# queries, and write bf16; on the card the largest error was 0.035 on a dv
# whose largest value is 11.2 (window 256, G = 4), inside the gate.
BWD_ATOL_REL = 2e-3
BWD_RTOL = 2e-2
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
SEED = 1234
NUM_LAYERS = 32
PROMPT_LENS = (5, 100, 700, 1500)
NEW_TOKENS = 32
MATCH_GATE = 0.99
# phase 3b: the paged engine. At ps 16 the four prompts need 1 + 7 + 44 +
# 94 = 146 pages at admission, so a 147-page pool (146 + scratch) admits
# all four at once and is dry when the 5-token request's decode first
# crosses a page (position 16): nothing is cache-only then, so the
# youngest request (the 1500-token one, still mid-prefill) is preempted
PAGE_SIZE = 16
PREFILL_CHUNK = 32
PRESSURE_PAGES = 147
SHARED_PREFIX, OWN_SUFFIX = 512, 64
# phase 3c: speculative serving, k SPEC_K, the first SPEC_REQUESTS
# phase-3 prompts (the 700- and 1500-token ones were cut for the
# script's wall: every drafter, engine and multi-chunk prefill is still
# driven) plus one of SPEC_REPEAT tokens repeating a SPEC_PATTERN-token
# pattern (so the n-gram lookup proposes). The random-init target copies no pattern, so
# the n-gram drafts are never accepted (a 4-layer draft model, which
# agreed with it nowhere either, ran here until PR 15 and was cut for
# the script's wall); a cut of SPEC_PARTIAL_LAYERS layers agrees with it
# in part
# (PERF.md has the counts), so its ticks roll back after 0 < a < k
# accepted drafts
SPEC_K = 4
SPEC_REQUESTS = 2
SPEC_PATTERN, SPEC_REPEAT = 64, 512
SPEC_PARTIAL_LAYERS = 31

# phase 3d: serving control. The lifecycle run's engine takes at most
# CONTROL_QUEUE waiting requests and gets CONTROL_BURST concurrent
# 1500-token requests (each prefill takes tens of ms, so most arrive while
# the queue is full); CONTROL_DEADLINE_S is far below the decode of
# CONTROL_DEADLINE_TOKENS tokens (about 10 ms a tick on an H100). Beam search: BEAM_WIDTH beams of BEAM_TOKENS tokens on
# the 100-token prompt. The reload run cuts the depth to RELOAD_LAYERS
# (a 1.35 GB checkpoint) and reloads RELOAD_SEED's weights. The int8
# ticks are timed with the 8 slots filled as tools/profile_serving.py
# fills them (its TICK_LENS prompts of 5 .. 1500 tokens); the paged
# engine's at CONTROL_PAGED_TICK_LAYERS layers (its fill is ~170 chunked
# prefill ticks: 58 of the phase's 120 s at full depth), and phase 3e
# takes the dense bf16 tick measured here (CONTROL_TICKS).
CONTROL_PAGED_TICK_LAYERS = 8
CONTROL_TICKS: dict = {}
CONTROL_QUEUE = 2
CONTROL_BURST = 8
CONTROL_DEADLINE_S = 0.05
CONTROL_DEADLINE_TOKENS = 256
BEAM_WIDTH = 4
BEAM_TOKENS = 16
RELOAD_LAYERS = 2
RELOAD_SEED = SEED + 1
TICK_COUNT = 10

# phase 4: Llama-2-7B width cut to TRAIN_LAYERS layers
TRAIN_LAYERS = 8
TRAIN_SEQ = 4096
TRAIN_ITERS = 8
TRAIN_MICRO, TRAIN_GLOBAL = 1, 2
EVAL_INTERVAL, EVAL_ITERS = 4, 1
VOCAB = 32000
CORPUS_DOCS = 64              # 1024..3072 tokens each: ~131k tokens
ZIPF_A = 1.2
# Adam's first update is lr * sign(g) on every one of the 1.88 B weights
# (bias correction makes m/sqrt(v) = g/|g|), a step far outside the
# region where the loss is locally linear: on the card a constant 3e-4
# sent the loss from 11.30 to 26.90 after the first step and it was still
# at 12.79 after 8. At 1e-5 it falls from the first step on.
TRAIN_LR = "1e-5"
FIRST_LOSS_WINDOW = 0.5       # |first loss - first_loss_expected()| <= this
# first loss - last loss >= this; the card measured a drop of 2.34 nats
# (11.30 -> 8.97) at these settings, so the gate leaves room for noise
LOSS_DROP_GATE = 1.0
# phase 4b: kernel step vs dense step. Measured on the card: loss 2.5e-4
# apart, grad norm 9e-7 relative, every leaf within 5.6e-3 of its max (one
# to two bf16 ulps of the largest gradient)
STEP_LOSS_ATOL = 2e-2
STEP_NORM_RTOL = 2e-2
STEP_LEAF_TOL = 2e-2          # max|kernel - dense| / max|dense| per leaf

# phase 7: multi-GPU training. (b)'s cases share one single-process
# yardstick run: the same model, corpus, seed and batches. Tolerance: the
# ranks sum bf16 partial products (a row-parallel output, the embedding's
# vocab blocks) where one process rounds one fp32-accumulated product,
# and the microbatch and data-rank orders of the fp32 sums differ; phase
# 4b's bf16 step gates (STEP_*) are the measure of that noise. On the
# card (NVIDIA H100 80GB HBM3, 700 W) tp2_sp came 1.7e-3 apart in loss
# and 8.3e-5 in grad norm, pp2 1.9e-4 and 3.2e-5, the others <= 1e-6 (at
# S 4096). (b)-(c) run at S PAR_SEQ: a length other than the flag's
# default 2048 (which keeps the preset's 4096); 1024 cuts the
# host-staged collectives of tp2_sp 4x for the wall (the gloo phases
# move bytes, which the checks do not need)
PAR_LAYERS = 4
PAR_SEQ = 1024
PAR_GLOBAL = 4
PAR_STEPS = 2
# rank 0 traces the last step (its step time is a traced one)
PAR_PROFILE = (PAR_STEPS, PAR_STEPS + 1)
PAR_CASES = {
    "tp2_sp": ["--tensor_model_parallel_size", "2", "--sequence_parallel"],
    "pp2": ["--pipeline_model_parallel_size", "2"],
    "pp2_vpp2": ["--pipeline_model_parallel_size", "2",
                 "--num_layers_per_virtual_pipeline_stage", "1"],
    "dp2_zero1": ["--use_distributed_optimizer"],
}
PAR_LOSS_ATOL = STEP_LOSS_ATOL
PAR_NORM_RTOL = STEP_NORM_RTOL
PAR_TIMEOUT_S = 900          # a launch: 7d, 7e, every two-rank case and resume
# phase 7c: the sharded checkpoint. PAR_SAVE_CASE saves asynchronously
# at its last step (after its traced step: the trace is unchanged); then,
# in the same launches, it resumes from it at its own topology and the
# PAR_LOAD_CASES at theirs, and each takes step PAR_STEPS + 1. Every
# resumed forward reads the same weights. The two pipeline topologies
# compute the same bf16 products and agree within PAR_RESUME_ATOL;
# against tp2's forward, whose row-parallel partial sums are rounded to
# bf16 before they are added, the card measured 5.5e-4 (H100 80GB HBM3,
# 700 W; loss 13.84), so that pair is held to PAR_LOSS_ATOL, phase 7's
# gate of tp2 against one process
PAR_SAVE_CASE, PAR_LOAD_CASES = "tp2_sp", ("pp2", "pp2_vpp2")
PAR_RESUME_ATOL = 1e-4
PAR_SERVE_NEW = 16            # the world-1 server's request of the ckpt
# phase 7d: Llama-2-7B's width x TP_SERVE_LAYERS served at tp2 by two
# gloo ranks sharing the card (python -m torch.distributed.run; each rank
# is this script's --rank-serve mode): the dense engine, eager tick, 8
# slots x 2048, phase 3's traffic, then TP_TICKS decode ticks over 8
# filled slots timed and traced on rank 0, then one request through the
# one-shot server (engine_slots 0). 7d, 7e(a) and 7e(b) served the full
# 32 layers before phase 7g came (145.6 s of a 1067.9 s run of this
# script with 7g, on an H100 80GB HBM3 at 700 W): cut to 8 for the wall,
# then to 4 for phase 7i (7d 34.4 s and 7e(a) 30.0 s at 8 layers, same
# card); every per-layer collective and kernel of the path still runs
TP_SERVE_LAYERS = 4
TP_SLOTS, TP_SEQ, TP_TICKS = 8, 2048, 5
TP_ONE_SHOT_NEW = 8
TP_TICK_LENS = (5, 100, 300, 500, 700, 1000, 1200, 1500)
# phase 7e, in phase 7d's launch (rank_serve): (a) the paged engine at
# tp2 on 7d's weights, phase 3b's traffic and 147-page pool (the pool is
# full at admission, so the first decode page preempts) in prefill
# chunks of TP_PREFILL_CHUNK tokens (3b's 32 took 75 chunks, 52.5 s at
# tp2 over gloo on an H100 80GB HBM3 at 700 W), then its tick timed and
# traced over TP_SLOTS slots filled with one-chunk prompts of
# PAGED_TICK_LENS tokens; (b) Llama-2-7B at pp2 through the one-shot
# server: the 100-token prompt x NEW_TOKENS and the four prompts scored;
# (c) Falcon-40B's width x FALCON_TRAIN_LAYERS trained at tp2 + SP, S
# FALCON_SEQ, with --metrics FALCON_METRICS (1 layer since phase 7i:
# 2 layers, 1.91 B parameters, a 38 GB TrainState, took 7e(c) 24.3 s on
# an H100 80GB HBM3 at 700 W; the one layer runs every site of the
# block); (d) Falcon-40B's
# width x FALCON_SERVE_LAYERS (6.0 B parameters, 12.1 GB of bf16) on the
# tp2 dense engine, phase 3's traffic
TP_PREFILL_CHUNK = 128
# phase 7h, last in phase 7's launch: (a) Llama-2-7B's width x
# CP_SERVE_LAYERS on the context-parallel engine at cp2 (ring,
# overlapped, dense hops), CP_SERVE_SLOTS slots x CP_SERVE_SEQ in pages of
# PAGE_SIZE and chunks of TP_PREFILL_CHUNK (a rank's pool: 2049 pages,
# 0.54 GB a layer), phase 3b's prompts plus one of CP_LONG_PROMPT tokens,
# NEW_TOKENS each; (b) the same with int8 hops; (c) 7d's tp2 dense engine
# at CP_SERVE_LAYERS, phase 3's traffic, dense then with int8 TP
# collectives. (a) and (b) served TP_SERVE_LAYERS (8) in the first whole
# run with 7h (13.7 and 16.2 s, 7h 68.6 s of a 996.6 s run on an H100
# 80GB HBM3 at 700 W, over the 960 s aim), and (c) did in the next (7h
# 37.7 s of 1093.9 s): cut to 2 layers for the wall; every per-layer
# kernel, hop and collective site of the path still runs
CP_SERVE_LAYERS = 2
# 7h(c)'s second gate: the largest logit change the int8 TP collectives
# make to the plain bf16 forward (the same context and weights) is at most
# TRANSPORT_BAND_RATIO x the largest bf16 band of the same positions. A
# value crosses the wire with an error of at most 1/254 of its 32-value
# chunk's max (quant/primitives.quantization_error_bound), about twice
# bf16's 2^-9 rounding, at three sites a layer where bf16 rounds at every
# product and add: the transport's change is of the bf16 band's order,
# and the ratio keeps JAX's 4x headroom (test_teacher_forced_parity_gate)
TRANSPORT_BAND_RATIO = 4.0
CP_SERVE_SLOTS, CP_SERVE_SEQ, CP_LONG_PROMPT = 8, 8192, 6000
PAGED_TICK_LENS = (TP_PREFILL_CHUNK,) * TP_SLOTS
FALCON40 = "falcon-40B"
FALCON_SEQ = 2048             # the preset's
FALCON_TRAIN_LAYERS = 1
FALCON_SERVE_LAYERS = 8
FALCON_METRICS = ("perplexity", "accuracy")

# phase 7f: Mixtral-8x7B's width (h 4096, ffn 14336, 8 experts top-2,
# 32/8 heads, vocab 32000) in phase 7's two-rank launch, each case held
# to one process on the same weights and batches. Depth is cut to
# MIXTRAL_PAR_LAYERS: 2 layers are 3.16 B parameters, a 57 GB TrainState
# in one process, and at ep2 each rank also holds every non-expert
# leaf; 1 layer is 1.71 B, ~31 GB over the two ranks. The sequence is
# MIXTRAL_PAR_SEQ, half the preset's 8192 for the wall: pretrain_gpt
# keeps a preset's length unless a length other than the flag's default
# 2048 is asked for (the JAX CLI's rule), so S 2048 cannot be asked for.
# tp2_sp runs micro-batches of 2 rows, the ep2 cases of 1 a rank (dp 2):
# every case's global microbatch is 2 rows, so one one-process run at
# micro-batch 2 per dispatch is the yardstick of all (the router's
# statistics are a global microbatch's)
MIXTRAL_PAR_LAYERS = 1
MIXTRAL_PAR_SEQ = 4096
MIXTRAL_PAR_CASES = {
    "mixtral_tp2_sp": ["--tensor_model_parallel_size", "2",
                       "--sequence_parallel", "--micro_batch_size", "2"],
    "mixtral_ep2_zero1": ["--expert_model_parallel_size", "2",
                          "--use_distributed_optimizer"],
    "mixtral_ep2_dropless": ["--expert_model_parallel_size", "2",
                             "--moe_dispatch", "dropless"],
}
MIXTRAL_PAR_REF_MICRO = 2
# 7f(d): the width x 2 layers served at tp2 on the dense engine with the
# dense attention, in fp32 (gated: bf16 flips a random-init MoE's
# routing, phase 5c) and in bf16 (its near-tie rate reported)
MIXTRAL_PAR_SERVE_LAYERS = 2
MIXTRAL_PAR_REDUCED = [
    f"training depth 32 -> {MIXTRAL_PAR_LAYERS} layer (the TrainState of "
    "two would not leave room for two ranks' activations on one card)",
    f"training sequence 8192 -> {MIXTRAL_PAR_SEQ} (2048 is the CLI's "
    "default, which keeps the preset's 8192)",
    f"serving depth 32 -> {MIXTRAL_PAR_SERVE_LAYERS} layers in fp32 (12.6 "
    "GB a copy), capacity factor 1.25 -> 8 (phase 5c's)"]

# phase 4c: the fp8 training products (ops/fp8.py). (a) fp8_matmul at
# each product shape of a Llama-2-7B block at S TRAIN_SEQ (x [4096, K] @
# w [K, N]: wq, wk, wv and wo 4096 x 4096, w_in 4096 x 22016, SwiGLU's two
# halves, w_out 11008 x 4096), both formats: torch._scaled_mm's forward
# and both gradients against the plain version's fp32 products of the
# same fp8 operands, within FP8_TOL of the plain's largest magnitude
# (both outputs are rounded to bf16, 2^-8 relative, after fp32 sums in
# different orders); (b) FP8_STEPS steps of the width x FP8_LAYERS in
# bf16, --fp8_hybrid and --fp8_e4m3 through pretrain_gpt (one seed, one
# corpus, the same batches): every fp8 loss within FP8_LOSS_RTOL of
# bf16's (tests/test_fp8.py's 5%), finite and falling; the loop's step
# windows and a synchronized forward + backward of each format on the
# same weights and row, side by side
FP8_LAYERS = 2
FP8_STEPS = 3
FP8_LOSS_RTOL = 0.05
FP8_TOL = 2.0 ** -7
FP8_PRODUCTS = {"wq/wk/wv/wo": (4096, 4096), "w_in": (4096, 22016),
                "w_out": (11008, 4096)}
FP8_RUNS = {"bf16": [], "hybrid": ["--fp8_hybrid"], "e4m3": ["--fp8_e4m3"]}
FP8_TIMED = 5          # synchronized fwd + bwd runs a format is timed over
# phase 7g: context parallelism, in phase 7's two-rank launch (gloo, one
# card): Llama-2-7B's width x CP_LAYERS at S CP_SEQ, 8192 tokens a rank
# (the zig-zag ring's stripes are CP_STRIPE long), CP_STEPS steps at cp2
# with --attention_impl ring, ulysses and pallas (the all-gathered K/V),
# each held to one process at the same S within phase 7's gates; every
# rank's B1-B3 launches printed and held to the schedule's count. One
# layer since phase 7i (the three runs took 71.2 s at 2 layers on an
# H100 80GB HBM3 at 700 W, most of it the gradients' context sum): the
# layer's ring, Ulysses and gathered-K/V passes all still run
CP_LAYERS = 1
CP_STRIPE = 4096
CP_SEQ = 4 * CP_STRIPE
CP_STEPS = 2
CP_CASES = {f"cp2_{impl}": ["--context_parallel_size", "2",
                            "--attention_impl", impl]
            for impl in ("ring", "ulysses", "pallas")}

REPO = os.path.dirname(os.path.abspath(__file__))
TPU_KERNELS = "megatron_tpu/ops/pallas/flash_template.py"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, budget_ms: float = 200.0) -> float:
    """Mean device time of fn() over a warm run of launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    iters = int(max(3, min(100, budget_ms / one)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call without the host's launch path:
    `calls` calls captured in one CUDA graph (on the stream that ran the
    warm-up call), replayed `replays` times between CUDA events. Where the
    wrapper's host path (checks, ctypes, workspace) takes longer than the
    kernel, cuda_ms measures the host and this the kernel. Where the
    kernel is long the two agree within a few percent, and either may
    read higher."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa(F, q, k, v, **kw):
    """One scaled_dot_product_attention call on [B, S, H, D] inputs (the
    library yardstick; the port never calls it). GQA goes through
    enable_gqa where this PyTorch has it, else K/V are expanded once,
    outside the timed call."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    g = q.shape[2] // k.shape[2]
    if g > 1:
        try:
            F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
            kw["enable_gqa"] = True
        except TypeError:
            kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def compare(torch, got, want):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= ATOL + RTOL * want.float().abs()).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def attn_case(S=None, Sq=None, Skv=None, hq=32, hkv=32, D=128, causal=True,
              window=None, delta=0, fused=False, B=1):
    """One prefill attention shape of phases 2 and 2b. fused: q, k and v
    are strided views of one [B, S, 3, H, D] buffer (the layout of a fused
    QKV projection), which the kernels read through their tensor maps."""
    Sq = Sq or S
    return dict(Sq=Sq, Skv=Skv or Sq, hq=hq, hkv=hkv, D=D, causal=causal,
                window=window, delta=delta, fused=fused, B=B)


def case_name(c) -> str:
    return (f"B={c['B']} Sq={c['Sq']} Skv={c['Skv']} Hq={c['hq']} Hkv={c['hkv']} "
            f"D={c['D']} causal={c['causal']} window={c['window']} "
            f"delta={c['delta']}" + (" fused_qkv" if c["fused"] else ""))


def case_inputs(torch, gen, c, with_do=False):
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] (and dO like q) in bf16,
    drawn in the original order (q, dO, k, v), so the original shapes
    keep their inputs."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    B = c["B"]
    if c["fused"]:
        assert c["Sq"] == c["Skv"] and c["hq"] == c["hkv"]
        buf = randn(B, c["Sq"], 3, c["hq"], c["D"])
        q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
        do = randn(B, c["Sq"], c["hq"], c["D"]) if with_do else None
    else:
        q = randn(B, c["Sq"], c["hq"], c["D"])
        do = randn(B, c["Sq"], c["hq"], c["D"]) if with_do else None
        k = randn(B, c["Skv"], c["hkv"], c["D"])
        v = randn(B, c["Skv"], c["hkv"], c["D"])
    return (q, k, v, do) if with_do else (q, k, v)


def visible_pairs(torch, c) -> float:
    """(query, key) pairs the mask lets through, per head: the work the
    bound counts (this run's mask, not the dense S x S)."""
    pos = torch.arange(c["Sq"], dtype=torch.float64) + c["delta"]
    hi = ((pos + 1).clamp(0, c["Skv"]) if c["causal"]
          else torch.full_like(pos, c["Skv"]))
    lo = ((pos - c["window"] + 1).clamp(0, c["Skv"]) if c["window"]
          else torch.zeros_like(pos))
    return float((hi - lo).clamp(min=0).sum())


def sdpa_mask_kw(torch, c) -> dict:
    """scaled_dot_product_attention's arguments for the case's mask (none
    when every pair is visible: a causal block wholly in its queries'
    past is the same work as a bidirectional one)."""
    if (c["causal"] and c["window"] is None and c["delta"] == 0
            and c["Sq"] == c["Skv"]):
        return dict(is_causal=True)
    past = c["causal"] and c["delta"] >= c["Skv"] - 1
    if (past or not c["causal"]) and c["window"] is None:
        return {}
    qp = torch.arange(c["Sq"], device="cuda")[:, None] + c["delta"]
    kp = torch.arange(c["Skv"], device="cuda")[None, :]
    mask = (kp <= qp) if c["causal"] else torch.ones_like(kp == qp)
    if c["window"] is not None:
        mask = mask & (kp > qp - c["window"])
    return dict(attn_mask=mask)


def mask_kw(c) -> dict:
    return dict(causal=c["causal"], sliding_window=c["window"],
                delta=c["delta"])


def rates(flops, ms, bound_ms) -> dict:
    return {"tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}


# the plain versions materialize fp32 [B, H, Sq, Skv] scores; past this
# many bytes they run over groups of kv heads (each head's attention is
# its own, so the pieces put together are the same function)
PLAIN_SCORE_BYTES = 4 * 2**30


def head_groups(c) -> int:
    """How many kv-head groups a case's plain version runs in."""
    need = -(-4 * c["B"] * c["hq"] * c["Sq"] * c["Skv"] // PLAIN_SCORE_BYTES)
    return next(n for n in range(1, c["hkv"] + 1)
                if c["hkv"] % n == 0 and n >= need)


def plain_by_heads(torch, c, fn, q_like, kv_like, lse_like=()):
    """fn over kv-head groups of the case: q_like tensors [B, S, Hq, D]
    and lse_like [B, Hq, S] cut by query heads, kv_like [B, S, Hkv, D] by
    kv heads; each output put back together along its head dim (dim 1
    for a [B, H, S] one, else 2)."""
    n = head_groups(c)
    if n == 1:
        return fn(*q_like, *kv_like, *lse_like)
    parts = [fn(*(t.chunk(n, dim=2)[i] for t in q_like),
                *(t.chunk(n, dim=2)[i] for t in kv_like),
                *(t.chunk(n, dim=1)[i] for t in lse_like))
             for i in range(n)]
    return tuple(torch.cat([p[j] for p in parts], dim=1 if p0.dim() == 3
                           else 2)
                 for j, p0 in enumerate(parts[0]))


# phase 2: the forward's shapes. The first five are the original ones (S
# 2047, the serving prefill's largest bucket, is the reported case, S 4096
# the training path's sequence); then the 128-row tile's edges, a ring stripe (Sq !=
# Skv, delta != 0), bidirectional, D 64, GQA, a fused QKV buffer,
# phase 3d's scored batch (the four phase-3 prompts padded to 1500, less
# the last position: B 4, S 1499, which ends inside a 128-row tile), and
# phase 5b's training shapes: Falcon-7B's 71 query heads over one kv head
# at D 64, S 2048, and GPT-2 1.3B's 32 heads at D 64, S 1024
# (and phase 7's per-rank shape: Llama-2-7B's heads at tp2, S 2048,
# phase 5c's Mixtral training shape: 32 q heads over 8 kv heads, S 8192,
# and phase 7e's Falcon-40B rank at tp2: 64 q heads over 4 kv heads, D 64)
FALCON_ATTN = dict(hq=71, hkv=1, D=64)
GPT2_ATTN = dict(hq=32, hkv=32, D=64)
TP2_ATTN = dict(hq=16, hkv=16, D=128)
FALCON40_TP2_ATTN = dict(hq=64, hkv=4, D=64)
# a Mixtral tp2 rank (phase 7f); its ep2 rank's heads are the whole
# model's (Hq 32 Hkv 8)
MIXTRAL_TP2_ATTN = dict(hq=16, hkv=4, D=128)
# phase 7g's context-parallel shapes (Llama-2-7B's heads, S 16384 over
# two ranks): a zig-zag ring's stripe of c = 4096 against itself (delta
# 0, the diagonal pair) and against a stripe wholly in its past (delta
# c; every later delta is the same work), the all-gathered K/V's ranks,
# 8192 queries at offset 0 and 8192 against all 16384 keys, and
# Ulysses' rank, the whole sequence over half the heads
CP_ATTN_CASES = [attn_case(CP_STRIPE),
                 attn_case(Sq=CP_STRIPE, Skv=CP_STRIPE, delta=CP_STRIPE),
                 attn_case(Sq=2 * CP_STRIPE, Skv=4 * CP_STRIPE,
                           delta=2 * CP_STRIPE),
                 attn_case(Sq=2 * CP_STRIPE, Skv=4 * CP_STRIPE),
                 attn_case(4 * CP_STRIPE, **TP2_ATTN)]
FWD_CASES = [attn_case(64), attn_case(512), attn_case(2047),
             attn_case(2047, hkv=8, window=256), attn_case(4096),
             attn_case(1), attn_case(127), attn_case(129), attn_case(1000),
             attn_case(Sq=1024, Skv=4096, delta=3072),
             attn_case(2047, causal=False), attn_case(2047, D=64),
             attn_case(2047, hkv=8), attn_case(2047, fused=True),
             attn_case(1499, B=4), attn_case(2048, **FALCON_ATTN),
             attn_case(1024, **GPT2_ATTN), attn_case(2048, **TP2_ATTN),
             attn_case(8192, hkv=8), attn_case(2047, **TP2_ATTN),
             attn_case(2048, **FALCON40_TP2_ATTN),
             attn_case(4096, **MIXTRAL_TP2_ATTN), attn_case(4096, hkv=8),
             attn_case(1024, **TP2_ATTN), attn_case(1024),
             *CP_ATTN_CASES[1:]]


def check_flash_fwd(torch, F, ft, card):
    """Prefill forward at Llama-2-7B widths (FWD_CASES); every case runs,
    and the phase fails after the last if any disagreed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, report, failed = 0.0, None, []
    for c in FWD_CASES:
        q, k, v = case_inputs(torch, gen, c)
        kw = mask_kw(c)
        o, lse = ft.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = plain_by_heads(
            torch, c, lambda q, k, v: ft.flash_fwd_reference(
                q.float(), k.float(), v.float(), **kw), (q,), (k, v))
        err, ok = compare(torch, o, o_ref)
        lerr, lok = compare(torch, lse, lse_ref)
        del o_ref, lse_ref
        ms = cuda_ms(torch, lambda: ft.flash_fwd(q, k, v, **kw))
        device_ms = graph_ms(torch, lambda: ft.flash_fwd(q, k, v, **kw),
                             calls=5)
        plain_ms = cuda_ms(torch, lambda: plain_by_heads(
            torch, c, lambda q, k, v: ft.flash_fwd_reference(q, k, v, **kw),
            (q,), (k, v)))
        library_ms = cuda_ms(torch,
                             sdpa(F, q, k, v, **sdpa_mask_kw(torch, c)))
        B, D, hq, hkv = c["B"], c["D"], c["hq"], c["hkv"]
        flops = 4.0 * B * D * hq * visible_pairs(torch, c)
        nbytes = B * (2.0 * (2 * c["Sq"] * hq * D + 2 * c["Skv"] * hkv * D)
                      + 4.0 * hq * c["Sq"])
        bound_ms, bound_by = bound(flops, nbytes)
        line = {"phase": "kernel", "name": "flash_fwd", "card": card,
                "shape": case_name(c), "max_abs_err": err,
                "lse_max_abs_err": lerr, "ok": ok and lok, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                **rates(flops, ms, bound_ms)}
        emit(line)
        if not (ok and lok):
            failed.append(line["shape"])
        worst = max(worst, err, lerr)
        if c == FWD_CASES[2]:
            report = line
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"at {failed}")
    return dict(report, max_abs_err=worst)


def decode_split(torch, ft, S, B, hkv, rows) -> dict:
    """The split-K launch the decode wrappers make for this shape."""
    plan = ft.decode_plan(S, B, hkv, rows, torch.cuda.get_device_properties(
        0).multi_processor_count)
    return {"split_tiles": plan["split_tiles"], "splits": plan["splits"],
            "grid": list(plan["grid"])}


# phases 2 and 2c: one decode tick at 8 slots x 2048 positions with
# ragged prefixes. Dense: the serving path's Sq 1, G 1 (the reported
# case), GQA G 4 and the Sq 5 verify form; paged: the serving path's ps 16
# (reported) and its Sq 5 verify form, GQA with Sq 5 and a window, page
# sizes 8 and 64. Both also past one block's 64 query rows per kv head:
# Falcon-7B's Sq 1 (71 rows) and Sq 5 verify (355), both at D 64 over one
# kv head, and G 8 at Sq 9 (72 rows: a k-8 verify on Llama-2-70B's heads);
# dense also GPT-2 1.3B's tick (32 heads at D 64 over its 1024 positions)
DECODE_B, DECODE_S, DECODE_D = 8, 2048, 128
DECODE_LENS = [1, 63, 64, 2047, 2048, 500, 1000, 1500]
ROW_TILE_CASES = [dict(sq=1, hq=71, hkv=1, d=64), dict(sq=5, hq=71, hkv=1,
                                                     d=64),
                  dict(sq=9, hq=64, hkv=8)]
DECODE_CASES = [dict(sq=1, hq=32, hkv=32), dict(sq=1, hq=32, hkv=8),
                dict(sq=5, hq=32, hkv=8), dict(sq=5, hq=32, hkv=32),
                *ROW_TILE_CASES, dict(sq=1, hq=32, hkv=32, d=64, s=1024),
                dict(sq=1, hq=16, hkv=16),
                dict(sq=1, hq=64, hkv=4, d=64)]     # phase 7e: Falcon-40B
PAGED_CASES_TP2 = [dict(ps=16, sq=1, hq=16, hkv=16, window=None)]
PAGED_CASES = [dict(ps=16, sq=1, hq=32, hkv=32, window=None),
               dict(ps=16, sq=5, hq=32, hkv=32, window=None),
               dict(ps=16, sq=5, hq=32, hkv=8, window=256),
               dict(ps=16, sq=1, hq=32, hkv=8, window=None),   # Mixtral
               dict(ps=8, sq=1, hq=32, hkv=32, window=None),
               dict(ps=64, sq=1, hq=32, hkv=32, window=None),
               *(dict(c, ps=16, window=None) for c in ROW_TILE_CASES),
               *PAGED_CASES_TP2]      # phase 7e: Llama-2-7B's tp2 rank


def decode_case(torch, gen, c):
    """q [B, Sq, Hq, D], the cache k/v [B, S, Hkv, D] and kv_lengths of
    one DECODE_CASES entry."""
    B, S, D = DECODE_B, c.get("s", DECODE_S), c.get("d", DECODE_D)
    sq, hq, hkv = c["sq"], c["hq"], c["hkv"]
    lens_list = [min(n, S - sq + 1) for n in DECODE_LENS]
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    q = torch.randn(B, sq, hq, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, hkv, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, hkv, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    return q, k, v, lens, lens_list


def check_flash_decode(torch, F, ft, card):
    """DECODE_CASES against the plain version; the first G = 1, Sq = 1
    case is the reported one."""
    B = DECODE_B
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst, report = 0.0, None
    for c in DECODE_CASES:
        sq, hq, hkv, D = c["sq"], c["hq"], c["hkv"], c.get("d", DECODE_D)
        S = c.get("s", DECODE_S)
        q, k, v, lens, lens_list = decode_case(torch, gen, c)
        o = ft.flash_decode(q, k, v, lens)
        torch.cuda.synchronize()
        o_ref = ft.flash_decode_reference(q.float(), k.float(), v.float(),
                                          lens)
        err, ok = compare(torch, o, o_ref)
        ms = cuda_ms(torch, lambda: ft.flash_decode(q, k, v, lens))
        device_ms = graph_ms(torch, lambda: ft.flash_decode(q, k, v, lens))
        plain_ms = cuda_ms(torch, lambda: ft.flash_decode_reference(
            q, k, v, lens))
        kpos = torch.arange(S, device="cuda")
        qpos = lens[:, None].long() - 1 + torch.arange(sq, device="cuda")
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        library_ms = cuda_ms(torch, sdpa(F, q, k, v, attn_mask=mask))
        visible_kv = sum(min(S, n + sq - 1) for n in lens_list)
        pairs = sum(min(S, n + j) for n in lens_list for j in range(sq))
        flops = 4.0 * D * hq * pairs
        nbytes = (2.0 * 2 * visible_kv * hkv * D + 2.0 * 2 * B * sq * hq * D
                  + 4.0 * B)
        bound_ms, bound_by = bound(flops, nbytes)
        line = {"phase": "kernel", "name": "flash_decode", "card": card,
                "shape": f"B={B} S={S} Sq={sq} Hq={hq} Hkv={hkv} D={D} "
                         f"kv_lengths={lens_list}",
                **decode_split(torch, ft, S, B, hkv, sq * (hq // hkv)),
                "max_abs_err": err, "ok": ok, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, **rates(flops, ms, bound_ms),
                "device_bound_share": bound_ms / device_ms}
        emit(line)
        if not ok:
            raise AssertionError(f"flash_decode disagrees with its plain "
                                 f"version: {line}")
        worst = max(worst, err)
        if report is None and sq == 1 and hq == hkv:
            report = line
    return dict(report, max_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 2c: the paged decode kernel vs its plain version
# ---------------------------------------------------------------------------


def paged_case(torch, gen, B, S, ps, sq, hq, hkv, window, D=128):
    """Pools, a page table and kv_lengths as the paged engine builds them:
    physical pages a seeded permutation of the pool, rows 0 and 1 sharing
    their first 32 pages (a prefix-cache hit), entries past a row's
    length and pages fully behind the window on the scratch page 0."""
    max_pages = S // ps
    n_pages = 1 + B * max_pages
    lens_list = [min(n, S - sq + 1) for n in DECODE_LENS]
    q = torch.randn(B, sq, hq, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(n_pages, ps, hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(n_pages, ps, hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.view(B, max_pages).to(torch.int32)
    shared = min(32, max_pages)
    table[1, :shared] = table[0, :shared]
    for b, n in enumerate(lens_list):
        used = -(-(n + sq - 1) // ps)
        table[b, used:] = 0
        if window is not None:
            # the engine releases pages whose positions all lie at or
            # below kv_len - 1 - window
            table[b, :max(0, n - 1 - window) // ps] = 0
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    return q, kp, vp, table.contiguous(), lens, lens_list


def check_paged_flash_decode(torch, F, ft, card):
    """PAGED_CASES against the plain version; the serving path's shape
    (ps 16, Sq 1, H 32) is the reported one."""
    B, S = DECODE_B, DECODE_S
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst, report = 0.0, None
    for c in PAGED_CASES:
        ps, sq, hq, hkv, W = (c[k] for k in ("ps", "sq", "hq", "hkv",
                                              "window"))
        D = c.get("d", DECODE_D)
        q, kp, vp, table, lens, lens_list = paged_case(
            torch, gen, B, S, ps, sq, hq, hkv, W, D)
        fn = ft.paged_flash_decode if sq == 1 else ft.paged_flash_decode_mq
        o = fn(q, kp, vp, table, lens, sliding_window=W)
        torch.cuda.synchronize()
        o_ref = ft.paged_flash_decode_reference(
            q.float(), kp.float(), vp.float(), table, lens, W)
        err, ok = compare(torch, o, o_ref)
        ms = cuda_ms(torch, lambda: fn(q, kp, vp, table, lens,
                                       sliding_window=W))
        device_ms = graph_ms(torch, lambda: fn(q, kp, vp, table, lens,
                                               sliding_window=W))
        plain_ms = cuda_ms(torch, lambda: ft.paged_flash_decode_reference(
            q, kp, vp, table, lens, W))
        # the dense view the pages hold, gathered once outside the timing
        kd = kp[table.long()].reshape(B, S, hkv, D)
        vd = vp[table.long()].reshape(B, S, hkv, D)
        dense_ms = cuda_ms(torch, lambda: ft.flash_decode(
            q, kd, vd, lens, sliding_window=W))
        kpos = torch.arange(S, device="cuda")
        qpos = lens[:, None].long() - 1 + torch.arange(sq, device="cuda")
        mask = kpos[None, None, :] <= qpos[:, :, None]
        if W is not None:
            mask &= kpos[None, None, :] > qpos[:, :, None] - W
        library_ms = cuda_ms(torch, sdpa(F, q, kd, vd,
                                         attn_mask=mask[:, None]))
        del kd, vd
        lo = [max(0, n - W) if W else 0 for n in lens_list]
        visible_kv = sum(min(S, n + sq - 1) - l
                         for n, l in zip(lens_list, lo))
        pairs = sum(min(S, n + j) - (max(0, n + j - W) if W else 0)
                    for n in lens_list for j in range(sq))
        flops = 4.0 * D * hq * pairs
        pages_read = sum(-(-min(S, n + sq - 1) // ps) - l // ps
                         for n, l in zip(lens_list, lo))
        nbytes = (2.0 * 2 * visible_kv * hkv * D + 2.0 * 2 * B * sq * hq * D
                  + 4.0 * B + 4.0 * pages_read)
        bound_ms, bound_by = bound(flops, nbytes)
        line = {"phase": "kernel", "name": "paged_flash_decode",
                "card": card,
                "shape": f"B={B} ps={ps} max_pages={S // ps} Sq={sq} "
                         f"Hq={hq} Hkv={hkv} D={D} window={W} "
                         f"kv_lengths={lens_list}",
                **decode_split(torch, ft, S, B, hkv, sq * (hq // hkv)),
                "max_abs_err": err, "ok": ok, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "dense_flash_decode_ms": dense_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                **rates(flops, ms, bound_ms),
                "device_bound_share": bound_ms / device_ms}
        emit(line)
        if not ok:
            raise AssertionError(f"paged_flash_decode disagrees with its "
                                 f"plain version: {line}")
        worst = max(worst, err)
        if report is None and ps == PAGE_SIZE and sq == 1:
            report = line
        del q, kp, vp, table, lens, o, o_ref
        torch.cuda.empty_cache()
    return dict(report, max_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 2c (partial form): B5 as a context-parallel rank's stripe partial
# ---------------------------------------------------------------------------

# a rank's stripe at cp2 of rows up to 4096 long: a local table of 128
# entries of 16-token pages, local lengths with 0 (a rank holding no page
# of its row), 1, page boundaries, 1000 and the table's end
PARTIAL_LENS = [0, 1, 16, 1000, 17, 64, 1500, 2048]
PARTIAL_LSE_ATOL = 2e-2      # natural log; fp32 sums, P rounded to bf16
PARTIAL_TIMEOUT_S = 300


def check_paged_partial(torch, F, ft, card):
    """B5's partial form, paged_flash_decode(return_lse=True), at B 8, ps
    16, Sq 1, H 32, D 128 over PARTIAL_LENS, against
    paged_flash_decode_reference(return_lse=True) on the same bf16
    inputs: o (fp32) at phase 2's tolerance, lse within PARTIAL_LSE_ATOL,
    the empty rows' o 0 and lse at NEG_INF's depth on both. Times the
    kernel (eager and graph), the plain version and SDPA on the gathered
    dense view; the bound counts each live position's K and V once, q,
    the fp32 o, lse, the lengths and the table entries read."""
    from megatron_tpu_torch.ops.flash.masks import NEG_INF

    B, ps, max_pages, H, D = DECODE_B, PAGE_SIZE, 128, 32, DECODE_D
    S = max_pages * ps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    npl = 1 + B * max_pages
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp, vp = (torch.randn(npl, ps, H, D, generator=gen, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    table = (torch.randperm(npl - 1, generator=gen, device="cuda") + 1
             ).view(B, max_pages).to(torch.int32)
    for b, n in enumerate(PARTIAL_LENS):
        # the engine clamps unallocated entries into the pool (unread)
        table[b, -(-n // ps):] = npl - 1
    table = table.contiguous()
    lens = torch.tensor(PARTIAL_LENS, dtype=torch.int32, device="cuda")

    def run():
        return ft.paged_flash_decode(q, kp, vp, table, lens,
                                     return_lse=True)

    o, lse = run()
    torch.cuda.synchronize()
    ro, rl = ft.paged_flash_decode_reference(q.float(), kp.float(),
                                             vp.float(), table, lens,
                                             return_lse=True)
    err, ok = compare(torch, o, ro)
    live = lens > 0
    lse_err = float((lse[live] - rl[live]).abs().max())
    empty_ok = (not bool(o[~live].any())
                and bool((lse[~live] <= NEG_INF / 2).all())
                and bool((rl[~live] <= NEG_INF / 2).all()))
    ms = cuda_ms(torch, run)
    device_ms = graph_ms(torch, run)
    plain_ms = cuda_ms(torch, lambda: ft.paged_flash_decode_reference(
        q, kp, vp, table, lens, return_lse=True))
    kd = kp[table.long()].reshape(B, S, H, D)
    vd = vp[table.long()].reshape(B, S, H, D)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None].long())
    library_ms = cuda_ms(torch, sdpa(F, q, kd, vd,
                                     attn_mask=mask[:, None, None]))
    del kd, vd
    n_kv = sum(PARTIAL_LENS)
    flops = 4.0 * D * H * n_kv
    nbytes = (2.0 * 2 * n_kv * H * D + 2.0 * B * H * D + 4.0 * B * H * D
              + 4.0 * B * H + 4.0 * B
              + 4.0 * sum(-(-n // ps) for n in PARTIAL_LENS))
    bound_ms, bound_by = bound(flops, nbytes)
    line = {"phase": "kernel", "name": "paged_flash_decode_lse",
            "card": card,
            "shape": f"B={B} ps={ps} max_pages={max_pages} Sq=1 Hq={H} "
                     f"Hkv={H} D={D} local_lengths={PARTIAL_LENS} "
                     "(fp32 o + lse)",
            **decode_split(torch, ft, S, B, H, H // H),
            "max_abs_err": err, "ok": ok, "lse_max_abs_err": lse_err,
            "lse_atol": PARTIAL_LSE_ATOL, "empty_rows_ok": empty_ok,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, **rates(flops, ms, bound_ms),
            "device_bound_share": bound_ms / device_ms}
    emit(line)
    if not (ok and lse_err <= PARTIAL_LSE_ATOL and empty_ok):
        raise AssertionError(f"paged_flash_decode's partial form disagrees "
                             f"with its plain version: {line}")
    return line


def kernel_child(name: str, out: str) -> int:
    """A new kernel form's first launches, in this child process (this
    script's --kernel-child mode; a hung kernel ends at the parent's
    timeout instead of hanging the run): its check, its result as JSON to
    `out`."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, REPO)
    from megatron_tpu_torch.ops.flash import flash_template as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    check = {"paged_partial": check_paged_partial}[name]
    with open(out, "w") as f:
        json.dump(check(torch, F, ft, card_line()), f)
    return 0


def paged_partial(torch, F, ft, card):
    """Phase 2c's partial form, in a child process with a timeout (ROADMAP
    ground rules: a new kernel form's first run); its kernel line is
    printed by the child."""
    import tempfile

    fd, out = tempfile.mkstemp(prefix="smoke_partial_", suffix=".json")
    os.close(fd)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--kernel-child",
             "paged_partial", out], cwd=REPO, capture_output=True,
            text=True, timeout=PARTIAL_TIMEOUT_S)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"partial-form child rc {proc.returncode}:"
                                 f" {proc.stderr[-4000:]}")
        with open(out) as f:
            return json.load(f)
    finally:
        os.remove(out)


# ---------------------------------------------------------------------------
# phase 2b: backward kernels vs the plain backward
# ---------------------------------------------------------------------------


def sdpa_backward(torch, F, q, k, v, do, **kw):
    """The backward of one scaled_dot_product_attention call (dq, dk and
    dv together), as a closure over a forward run once outside the
    timing; the library yardstick, never called by the port."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = sdpa(F, q, k, v, **kw)()
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v), dot,
                                       retain_graph=True)


def compare_rel(got, want, m=None):
    """(max |err|, M, ok, margin) under the backward tolerance, M the
    largest plain magnitude of the tensor unless given; margin is the
    largest err / allowed over the tensor (ok iff margin <= 1)."""
    want = want.float()
    m = float(want.abs().max()) if m is None else m
    err = (got.float() - want).abs()
    allowed = BWD_ATOL_REL * m + BWD_RTOL * want.abs()
    margin = float((err / allowed.clamp_min(1e-30)).max())
    return float(err.max()), m, bool((err <= allowed).all()), margin


# phase 2b: the backward's shapes. The first three are the original ones
# (S 4096 the reported case); then S 1 and the 128-row kv tile's edges, a
# ring stripe, bidirectional, D 64, GQA, a fused QKV buffer, and phase
# 5b's training shapes (Falcon-7B: the dk/dv kernel sums 71 query heads
# into one kv head; GPT-2 1.3B), phase 7's tp2 per-rank shape and phase
# 7e's Falcon-40B rank at tp2 (a group of 16 query heads a kv head)
BWD_CASES = [attn_case(4096), attn_case(4096, hkv=8, window=256),
             attn_case(1000), attn_case(1), attn_case(127), attn_case(129),
             attn_case(Sq=1024, Skv=4096, delta=3072),
             attn_case(2047, causal=False), attn_case(2047, D=64),
             attn_case(2047, hkv=8), attn_case(2047, fused=True),
             attn_case(2048, **FALCON_ATTN), attn_case(1024, **GPT2_ATTN),
             attn_case(2048, **TP2_ATTN), attn_case(8192, hkv=8),
             attn_case(2048, **FALCON40_TP2_ATTN),
             attn_case(4096, **MIXTRAL_TP2_ATTN), attn_case(4096, hkv=8),
             attn_case(1024, **TP2_ATTN), attn_case(1024),
             *CP_ATTN_CASES[1:]]
# the three original cases again, drawn from a second seed
BWD_DRAW2_SEED = SEED + 13


def plain_dq_bf16_ds(torch, q, k, v, do, lse, dsum, c):
    """The plain dq with ds rounded once to bf16 before the ds·k product:
    what that rounding alone does to dq against the fp32 plain version
    (the dq kernel splits ds into a bf16 hi + lo pair instead)."""
    d, g = q.shape[-1], q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    qp = torch.arange(c["Sq"], device="cuda")[:, None] + c["delta"]
    kp = torch.arange(c["Skv"], device="cuda")[None, :]
    mask = (kp <= qp) if c["causal"] else torch.ones_like(kp == qp)
    if c["window"] is not None:
        mask = mask & (kp > qp - c["window"])
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                      v.float().repeat_interleave(g, dim=2))
    ds = (p * (dp - dsum[..., None])).bfloat16().float()
    del p, dp
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale


def check_flash_bwd(torch, F, ft, card):
    """dq and dk/dv at BWD_CASES (draw 1) and at the first three cases
    drawn again from BWD_DRAW2_SEED (draw 2). Bounds: dq does 3 products
    of 2·D FLOPs per visible (q, k) pair and query head (S = q·kᵀ,
    dP = dO·vᵀ, dQ = dS·k), dk/dv 4 (S, dP, dV = Pᵀ·dO, dK = dSᵀ·q); bytes
    are each input read once and each output written once. At S = 1 the
    single key gives p = 1 and dp = dsum, so dq and dk are 0 in exact
    arithmetic and both sides hold only rounding noise: there M is the
    largest plain magnitude of the three gradients (dv = dO), not each
    tensor's own. Each line prints its margin, the largest err / allowed.
    For the three original cases of both draws a "dq_rounding" line holds
    the plain dq with ds rounded once to bf16 against the same gate,
    beside the kernel's: what the kernel's split of ds repairs. Every
    case runs; the phase fails after the last if any
    disagreed."""
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    report, failed = {}, []
    gens = {1: torch.Generator(device="cuda").manual_seed(SEED + 3),
            2: torch.Generator(device="cuda").manual_seed(BWD_DRAW2_SEED)}
    draws = [(1, c) for c in BWD_CASES] + [(2, c) for c in BWD_CASES[:3]]
    for draw, c in draws:
        q, k, v, do = case_inputs(torch, gens[draw], c, with_do=True)
        kw = mask_kw(c)
        o, lse = ft.flash_fwd(q, k, v, **kw)
        dsum = ft._bwd_dsum(o, do)
        dq = ft.flash_bwd_dq(q, k, v, do, lse, dsum, **kw)
        dk, dv = ft.flash_bwd_dkv(q, k, v, do, lse, dsum, **kw)
        torch.cuda.synchronize()
        want = plain_by_heads(
            torch, c, lambda q, o, do, k, v, lse: ft.flash_bwd_reference(
                q.float(), k.float(), v.float(), o, lse, do, **kw),
            (q, o, do), (k, v), (lse,))
        scale_m = (max(float(w.float().abs().max()) for w in want)
                   if c["Sq"] == 1 else None)
        errs = {n: compare_rel(g, w, scale_m)
                for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        if c in BWD_CASES[:3]:
            rounded = plain_dq_bf16_ds(torch, q, k, v, do, lse, dsum, c)
            emit({"phase": "dq_rounding", "card": card,
                  "shape": case_name(c), "draw": draw,
                  "kernel_split_margin": errs["dq"][3],
                  "plain_bf16_ds_margin": compare_rel(rounded, want[0])[3]})
            del rounded
        del want
        ms = {"flash_bwd_dq": cuda_ms(torch, lambda: ft.flash_bwd_dq(
                  q, k, v, do, lse, dsum, **kw)),
              "flash_bwd_dkv": cuda_ms(torch, lambda: ft.flash_bwd_dkv(
                  q, k, v, do, lse, dsum, **kw))}
        device_ms = {
            "flash_bwd_dq": graph_ms(torch, lambda: ft.flash_bwd_dq(
                q, k, v, do, lse, dsum, **kw), calls=5),
            "flash_bwd_dkv": graph_ms(torch, lambda: ft.flash_bwd_dkv(
                q, k, v, do, lse, dsum, **kw), calls=5)}
        # the plain version of both kernels is one function (the CPU path
        # of both wrappers); it computes dq, dk and dv together
        plain_ms = cuda_ms(torch, lambda: plain_by_heads(
            torch, c, lambda q, do, k, v, lse, dsum: ft._bwd_plain(
                q, k, v, do, lse, dsum, c["causal"], c["window"],
                c["delta"]), (q, do), (k, v), (lse, dsum)))
        lib = sdpa_backward(torch, F, q, k, v, do, **sdpa_mask_kw(torch, c))
        library_ms = cuda_ms(torch, lib)
        del lib
        D, hq, hkv = c["D"], c["hq"], c["hkv"]
        pairs = visible_pairs(torch, c)
        stats = 4.0 * 2 * hq * c["Sq"]                  # lse and dsum
        q_bytes, kv_bytes = 2.0 * c["Sq"] * hq * D, 2.0 * c["Skv"] * hkv * D
        work = {
            "flash_bwd_dq": (6.0 * D * hq * pairs,
                             3 * q_bytes + 2 * kv_bytes + stats),
            "flash_bwd_dkv": (8.0 * D * hq * pairs,
                              2 * q_bytes + 4 * kv_bytes + stats)}
        for name, tensors in (("flash_bwd_dq", ("dq",)),
                              ("flash_bwd_dkv", ("dk", "dv"))):
            bound_ms, bound_by = bound(*work[name])
            err = max(errs[t][0] for t in tensors)
            ok = all(errs[t][2] for t in tensors)
            line = {"phase": "kernel", "name": name, "card": card,
                    "shape": case_name(c), "draw": draw, "max_abs_err": err,
                    "max_abs_plain": {t: errs[t][1] for t in tensors},
                    "margin": {t: errs[t][3] for t in tensors},
                    "ok": ok, "ms": ms[name], "device_ms": device_ms[name],
                    "plain_ms": plain_ms,
                    "plain_computes": "dq, dk and dv",
                    "library_ms": library_ms,
                    "library_computes": "dq, dk and dv (SDPA backward)",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    **rates(work[name][0], ms[name], bound_ms)}
            emit(line)
            if not ok:
                failed.append((name, line["shape"], draw))
            worst[name] = max(worst[name], err)
            if c == BWD_CASES[0] and draw == 1:
                report[name] = line
        del q, k, v, do, o, lse, dsum, dq, dk, dv
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"disagreement with the plain backward at "
                             f"{failed}")
    return {n: dict(report[n], max_abs_err=worst[n]) for n in report}


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


def _put(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _metric(text: str, name: str) -> float:
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[1])
    raise KeyError(name)


def _zero_decode_counts(ft):
    for name in ("flash_fwd", "flash_decode", "paged_flash_decode"):
        getattr(ft, name).launches = 0
    for name in ("flash_decode", "paged_flash_decode"):
        getattr(ft, name).launches_by_sq.clear()
        getattr(ft, name).launches_by_form.clear()


def _partial_count(ft) -> int:
    """B5's partial-form launches (a context-parallel rank's decode)."""
    return ft.paged_flash_decode.launches_by_form.get("lse", 0)


def _decode_forms(ft):
    """The decode kernels' launches by query length: "sq1" the plain tick
    and the draft model's steps, "sq<k+1>" the speculative verify."""
    return {name: {f"sq{sq}": n for sq, n in
                   sorted(getattr(ft, name).launches_by_sq.items())}
            for name in ("flash_decode", "paged_flash_decode")}


def _decode_counts(ft):
    return {name: getattr(ft, name).launches
            for name in ("flash_fwd", "flash_decode", "paged_flash_decode")}


def _profiled_decode_launches(torch, ft, fn) -> dict:
    """Run fn under torch.profiler: the decode counters' delta (which a
    graph replay advances by the launches recorded at capture) beside the
    decode kernels the device ran."""
    from torch.profiler import ProfilerActivity, profile

    names = ("flash_decode", "paged_flash_decode")
    c0 = sum(getattr(ft, n).launches for n in names)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "flash_decode_kernel" in e.key)
    return {"counter": sum(getattr(ft, n).launches for n in names) - c0,
            "device_kernels": seen}


def _greedy_traffic(ft, base, eng, prompts):
    """The phase-3 traffic on a running server: the prompts as concurrent
    greedy requests of NEW_TOKENS tokens, then the second again, with
    every decode count set to 0 just before (the main path's run). Each
    answer must be its prompt + NEW_TOKENS tokens and the repeat the same
    text. Returns the generated tokens per prompt, each request's wall,
    the concurrent wall, the launches, prefills and decode ticks of the
    run, and the warnings it raised."""
    results = [None] * len(prompts)

    def one(i):
        t = time.monotonic()
        results[i] = (*_put(base + "/api", {
            "prompts": [" ".join(map(str, prompts[i]))],
            "tokens_to_generate": NEW_TOKENS, "temperature": 0.0}),
            time.monotonic() - t)

    _zero_decode_counts(ft)
    prefills0, ticks0 = eng.stats["admitted"], eng.stats["ticks"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t_conc = time.monotonic()
        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(900)
        conc_s = time.monotonic() - t_conc
        status, repeat = _put(base + "/api", {
            "prompts": [" ".join(map(str, prompts[1]))],
            "tokens_to_generate": NEW_TOKENS, "temperature": 0.0})
    run = {"launches": _decode_counts(ft),
           "prefills": eng.stats["admitted"] - prefills0,
           "ticks": eng.stats["ticks"] - ticks0, "concurrent_wall_s": conc_s,
           "walls": [res and res[2] for res in results], "caught": caught}
    generated = []
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"request {i} failed: {res}")
        toks = [int(t) for t in res[1]["text"][0].split()]
        if toks[:len(prompts[i])] != prompts[i] or \
                len(toks) != len(prompts[i]) + NEW_TOKENS:
            raise AssertionError(
                f"request {i}: {len(toks)} tokens for a "
                f"{len(prompts[i])}-token prompt + {NEW_TOKENS}")
        generated.append(toks[len(prompts[i]):])
    if status != 200 or repeat["text"][0] != results[1][1]["text"][0]:
        raise AssertionError("repeated greedy request changed its text")
    fallbacks = [str(w.message) for w in caught
                 if "falling back" in str(w.message)]
    if fallbacks:
        raise AssertionError(f"dense fallback fired: {fallbacks}")
    return dict(run, generated=generated)


def serve(torch, ft, card):
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg = presets.from_model_name("llama2-7B")
    assert cfg.num_layers == NUM_LAYERS and cfg.attention_impl == "pallas"
    t0 = time.monotonic()
    params = init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    # the null tokenizer's eod id is its vocab_size: 32000 sits outside
    # the 32000-row embedding table, so it is never sampled and never fed
    # (every prompt id below is < 32000)
    tokenizer = NullTokenizer(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()

    ready, handles = threading.Event(), []
    thread = threading.Thread(
        target=run_server, daemon=True, name="smoke-server",
        kwargs=dict(cfg=cfg, params=params, tokenizer=tokenizer,
                    host="127.0.0.1", port=0, engine_slots=8,
                    engine_max_seq_len=2048, device="cuda", ready=ready,
                    service_out=handles))
    thread.start()
    if not ready.wait(300):
        raise RuntimeError("server did not start")
    service, server = handles
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
                   for n in PROMPT_LENS]
        eng = service.engine
        run = _greedy_traffic(ft, base, eng, prompts)
        launches, prefills, ticks = (run["launches"], run["prefills"],
                                     run["ticks"])
        generated = run["generated"]
        want = {"flash_fwd": NUM_LAYERS * prefills,
                "flash_decode": NUM_LAYERS * ticks, "paged_flash_decode": 0}
        if launches != want or prefills != len(prompts) + 1:
            raise AssertionError(f"launches {launches} != {want} "
                                 f"(prefills {prefills}, ticks {ticks})")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        capture_s = eng.capture_seconds
        # after the main path's read: one more request under the profiler
        profiled = _profiled_decode_launches(torch, ft, lambda: _put(
            base + "/api", {"prompts": [" ".join(map(str, prompts[0]))],
                            "tokens_to_generate": 8, "temperature": 0.0}))
    finally:
        server.shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    if profiled["counter"] != profiled["device_kernels"] or \
            not profiled["counter"]:
        raise AssertionError(f"flash_decode counter against the profiler's "
                             f"kernels under graph replay: {profiled}")
    recompiles = _metric(metrics, "engine_decode_recompiles_total")
    if recompiles != 0 or capture_s is None:
        raise AssertionError(f"decode step: {recompiles} captures beyond "
                             f"warm-up, capture {capture_s}")

    del service, server, handles
    torch.cuda.empty_cache()
    tf = teacher_force(torch, dataclasses, cfg, params, prompts, generated)

    ttft = (_metric(metrics, "engine_ttft_seconds_sum")
            / _metric(metrics, "engine_ttft_seconds_count"))
    tpot = (_metric(metrics, "engine_time_per_output_token_seconds_sum")
            / _metric(metrics, "engine_time_per_output_token_seconds_count"))
    line = {"phase": "serving", "card": card, "model": "llama2-7B",
            "layers": NUM_LAYERS, "slots": 8, "max_seq_len": 2048,
            "param_init_s": init_s,
            "requests": [{"prompt_tokens": len(p), "new_tokens": len(g),
                          "wall_s": w}
                         for p, g, w in zip(prompts, generated,
                                            run["walls"])],
            "concurrent_wall_s": run["concurrent_wall_s"],
            "tokens_per_s": (len(prompts) * NEW_TOKENS
                             / run["concurrent_wall_s"]),
            "ttft_mean_s": ttft, "per_token_mean_s": tpot,
            "prefills": prefills, "decode_ticks": ticks,
            "launches": launches, "cuda_graph_capture_s": capture_s,
            "decode_recompiles": recompiles,
            "profiled_decode_launches": profiled,
            "max_memory_allocated_gib": peak_gib, **tf}
    emit(line)
    if tf["teacher_forced_match"] < MATCH_GATE:
        raise AssertionError(
            f"teacher-forced match {tf['teacher_forced_match']:.4f} < "
            f"{MATCH_GATE} (argmax or a near-tie within the plain bf16 "
            "path's own error)")
    return {"launches": launches, "generated": generated}


# ---------------------------------------------------------------------------
# phase 3b: paged serving
# ---------------------------------------------------------------------------


def _check_launches(where, launches, ticks):
    want = {"flash_fwd": 0, "flash_decode": 0,
            "paged_flash_decode": NUM_LAYERS * ticks}
    if launches != want or ticks < 1:
        raise AssertionError(f"{where}: launches {launches} != {want} "
                             f"(decode ticks {ticks})")


def serve_paged(torch, ft, card, dense_tokens):
    """The phase-3 server with kv_paging, then the paged engine under
    pool pressure. dense_tokens: phase 3's generated tokens per prompt
    (None if phase 3 failed), compared for information only."""
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.inference.engine import Request
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg = presets.from_model_name("llama2-7B")
    params = init_params(cfg, SEED, device="cuda")
    tokenizer = NullTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
               for n in PROMPT_LENS]
    # the same draws as phase 3, then two prompts sharing a prefix of
    # the 700-token prompt
    shared = [prompts[2][:SHARED_PREFIX]
              + rng.integers(0, cfg.vocab_size - 1, size=OWN_SUFFIX).tolist()
              for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    ready, handles = threading.Event(), []
    thread = threading.Thread(
        target=run_server, daemon=True, name="smoke-paged-server",
        kwargs=dict(cfg=cfg, params=params, tokenizer=tokenizer,
                    host="127.0.0.1", port=0, engine_slots=8,
                    engine_max_seq_len=2048, device="cuda", ready=ready,
                    service_out=handles, kv_paging=True,
                    page_size=PAGE_SIZE, prefill_chunk=PREFILL_CHUNK))
    thread.start()
    if not ready.wait(300):
        raise RuntimeError("paged server did not start")
    service, server = handles
    base = f"http://127.0.0.1:{server.server_address[1]}"
    eng = service.engine
    seqs = []                      # (prompt, generated) of every request
    try:
        def put_all(batch):
            out = [None] * len(batch)

            def one(i):
                t = time.monotonic()
                status, body = _put(base + "/api", {
                    "prompts": [" ".join(map(str, batch[i]))],
                    "tokens_to_generate": NEW_TOKENS, "temperature": 0.0})
                out[i] = (status, body, time.monotonic() - t)

            workers = [threading.Thread(target=one, args=(i,))
                       for i in range(len(batch))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(900)
            for i, res in enumerate(out):
                if res is None or res[0] != 200:
                    raise AssertionError(f"paged request {i} failed: {res}")
                toks = [int(t) for t in res[1]["text"][0].split()]
                if toks[:len(batch[i])] != batch[i] or \
                        len(toks) != len(batch[i]) + NEW_TOKENS:
                    raise AssertionError(
                        f"paged request {i}: {len(toks)} tokens for a "
                        f"{len(batch[i])}-token prompt + {NEW_TOKENS}")
                seqs.append((batch[i], toks[len(batch[i]):]))
            return out

        # the main path's run: every count starts at 0 here
        _zero_decode_counts(ft)
        ticks0 = eng.stats["ticks"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t_conc = time.monotonic()
            first = put_all(prompts)
            conc_s = time.monotonic() - t_conc
            put_all([prompts[1]])
            put_all(shared)
        launches = _decode_counts(ft)
        ticks = eng.stats["ticks"] - ticks0
        stats = dict(eng.stats)
        capture_s = eng.capture_seconds
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        server.shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("paged server thread did not stop")
    del service, server, handles, eng
    torch.cuda.empty_cache()
    if seqs[4][1] != seqs[1][1]:
        raise AssertionError("repeated greedy request changed its tokens")
    fallbacks = [str(w.message) for w in caught
                 if "falling back" in str(w.message)]
    _check_launches("paged serving", launches, ticks)

    # the paged engine in-process under pool pressure
    pressure = PagedInferenceEngine(
        cfg, params, num_slots=8, max_seq_len=2048, page_size=PAGE_SIZE,
        prefill_chunk=PREFILL_CHUNK, num_pages=PRESSURE_PAGES,
        vocab_size=tokenizer.vocab_size, metrics=MetricsRegistry(),
        device="cuda")
    _zero_decode_counts(ft)
    with warnings.catch_warnings(record=True) as caught2:
        warnings.simplefilter("always")
        t0 = time.monotonic()
        reqs = [pressure.submit(Request(prompt=np.asarray(p, np.int32),
                                        max_new_tokens=NEW_TOKENS))
                for p in prompts]
        pressure.run_until_idle()
        pressure_s = time.monotonic() - t0
    p_launches = _decode_counts(ft)
    p_stats = dict(pressure.stats)
    fallbacks += [str(w.message) for w in caught2
                  if "falling back" in str(w.message)]
    for p, r in zip(prompts, reqs):
        if r.error or len(r.generated) != NEW_TOKENS:
            raise AssertionError(f"pressure run: {len(p)}-token request "
                                 f"{r.error or len(r.generated)}")
        seqs.append((p, list(r.generated)))
    _check_launches("paged engine under pressure", p_launches,
                    p_stats["ticks"])
    del pressure, reqs
    torch.cuda.empty_cache()

    tf = teacher_force(torch, dataclasses, cfg, params,
                       [s[0] for s in seqs], [s[1] for s in seqs])
    same_as_dense = None
    if dense_tokens is not None:
        pairs = [(a, b) for (_, a), b in zip(seqs[:4], dense_tokens)]
        same_as_dense = (sum(x == y for a, b in pairs for x, y in zip(a, b))
                         / sum(len(a) for a, _ in pairs))
    ttft = (_metric(metrics, "engine_ttft_seconds_sum")
            / _metric(metrics, "engine_ttft_seconds_count"))
    tpot = (_metric(metrics, "engine_time_per_output_token_seconds_sum")
            / _metric(metrics, "engine_time_per_output_token_seconds_count"))
    keys = ("prefix_hits", "prefix_misses", "prefix_tokens_saved",
            "prefill_chunks", "prefill_tokens", "preemptions", "ticks",
            "admitted", "retired")
    line = {"phase": "paged_serving", "card": card, "model": "llama2-7B",
            "layers": NUM_LAYERS, "slots": 8, "max_seq_len": 2048,
            "page_size": PAGE_SIZE, "prefill_chunk": PREFILL_CHUNK,
            "pool_pages": _metric(metrics, "engine_pages_total") + 1,
            "requests": [{"prompt_tokens": len(p), "new_tokens": len(g),
                          "wall_s": res[2]}
                         for p, g, res in zip(prompts, [s[1] for s in seqs],
                                              first)],
            "concurrent_wall_s": conc_s,
            "tokens_per_s": len(prompts) * NEW_TOKENS / conc_s,
            "ttft_mean_s": ttft, "per_token_mean_s": tpot,
            "max_memory_allocated_gib": peak_gib,
            "stats": {k: stats[k] for k in keys}, "launches": launches,
            "pressure": {"num_pages": PRESSURE_PAGES, "wall_s": pressure_s,
                         "stats": {k: p_stats[k] for k in keys},
                         "launches": p_launches},
            "share_equal_to_dense_engine_tokens": same_as_dense,
            "cuda_graph_capture_s": capture_s,
            "decode_recompiles": _metric(
                metrics, "engine_decode_recompiles_total"),
            "fallback_warnings": fallbacks, **tf}
    emit(line)
    problems = []
    if line["decode_recompiles"] != 0 or stats["decode_recompiles"] != 0:
        problems.append("decode step captured again after warm-up")
    if stats["prefix_hits"] < 2:
        problems.append(f"prefix hits {stats['prefix_hits']} < 2")
    if p_stats["preemptions"] < 1:
        problems.append("no preemption under the 147-page pool")
    if fallbacks:
        problems.append(f"dense fallback fired: {fallbacks}")
    if tf["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"teacher-forced match "
                        f"{tf['teacher_forced_match']:.4f} < {MATCH_GATE}")
    if problems:
        raise AssertionError("paged serving: " + "; ".join(problems))
    return {n: launches[n] + p_launches[n] for n in launches}


# ---------------------------------------------------------------------------
# phase 3c: speculative serving
# ---------------------------------------------------------------------------


def _spec_want(drafter, paged, draft_layers, prefills, ticks):
    """The launches one speculative run must count: a tick launches the
    verify form (Sq k + 1) once per target layer and, with the model
    drafter, the Sq 1 form once per draft layer for each of its k + 1
    forwards; the dense engine's admissions launch flash_fwd once per
    target and draft layer, the paged engine's chunks none."""
    draft = draft_layers if drafter == "model" else 0
    name = "paged_flash_decode" if paged else "flash_decode"
    forms = {f"sq{SPEC_K + 1}": NUM_LAYERS * ticks}
    if draft:
        forms["sq1"] = (SPEC_K + 1) * draft * ticks
    launches = {"flash_fwd": 0 if paged else (NUM_LAYERS + draft) * prefills,
                "flash_decode": 0, "paged_flash_decode": 0}
    launches[name] = sum(forms.values())
    return launches, {"flash_decode": {}, "paged_flash_decode": {},
                      name: dict(sorted(forms.items()))}


def _spec_server_run(torch, ft, cfg, params, tokenizer, prompts, paged,
                     drafter, draft_layers):
    """One speculative server (run_text_generation_server's flags through
    load_spec): the prompts concurrently, greedy, NEW_TOKENS each.
    Returns the run's record and its generated tokens."""
    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.tools import run_text_generation_server as rts

    argv = ["--serve_speculative", drafter, "--serve_spec_k", str(SPEC_K)]
    if drafter == "model":
        argv += ["--serve_draft_layers", str(draft_layers)]
    speculative = rts.load_spec(rts.parse_args(argv), cfg, params)
    kw = dict(kv_paging=True, page_size=PAGE_SIZE,
              prefill_chunk=PREFILL_CHUNK) if paged else {}
    ready, handles = threading.Event(), []
    thread = threading.Thread(
        target=run_server, daemon=True, name="smoke-spec-server",
        kwargs=dict(cfg=cfg, params=params, tokenizer=tokenizer,
                    host="127.0.0.1", port=0, engine_slots=8,
                    engine_max_seq_len=2048, device="cuda", ready=ready,
                    service_out=handles, speculative=speculative, **kw))
    thread.start()
    if not ready.wait(300):
        raise RuntimeError("speculative server did not start")
    service, server = handles
    base = f"http://127.0.0.1:{server.server_address[1]}"
    eng = service.engine
    results = [None] * len(prompts)
    try:
        def one(i):
            results[i] = _put(base + "/api", {
                "prompts": [" ".join(map(str, prompts[i]))],
                "tokens_to_generate": NEW_TOKENS, "temperature": 0.0})

        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics0 = r.read().decode()
        _zero_decode_counts(ft)
        s0 = dict(eng.stats)
        t0 = time.monotonic()
        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(900)
        wall_s = time.monotonic() - t0
        launches, forms = _decode_counts(ft), _decode_forms(ft)
        st = {k: eng.stats[k] - s0.get(k, 0) for k in
              ("admitted", "ticks", "spec_proposed", "spec_accepted",
               "spec_emitted")}
        recompiles = eng.stats["decode_recompiles"]
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        capture_s = eng.capture_seconds
    finally:
        server.shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("speculative server thread did not stop")

    def accept_le(text, bound):
        return _metric(text, "engine_spec_accept_length_bucket"
                             f'{{le="{bound}"}}')

    # slot-ticks that accepted 0 < a < k drafts (the histogram is
    # cumulative, with bounds at a + 0.5)
    partial = (accept_le(metrics, SPEC_K - 0.5) - accept_le(metrics, 0.5)
               - accept_le(metrics0, SPEC_K - 0.5)
               + accept_le(metrics0, 0.5))
    generated = []
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"{drafter} request {i} failed: {res}")
        toks = [int(t) for t in res[1]["text"][0].split()]
        if toks[:len(prompts[i])] != prompts[i] or \
                len(toks) != len(prompts[i]) + NEW_TOKENS:
            raise AssertionError(f"{drafter} request {i}: {len(toks)} tokens")
        generated.append(toks[len(prompts[i]):])
    want, want_forms = _spec_want(drafter, paged, draft_layers,
                                  st["admitted"], st["ticks"])
    rec = {"engine": "paged" if paged else "dense", "drafter": drafter,
           "draft_layers": draft_layers if drafter == "model" else None,
           "k": SPEC_K, "wall_s": wall_s, **st,
           "accept_rate": st["spec_accepted"] / max(st["spec_proposed"], 1),
           "tokens_per_tick": st["spec_emitted"] / max(st["ticks"], 1),
           # per speculating slot and tick (proposed / k slot-ticks)
           "tokens_per_slot_tick": st["spec_emitted"] * SPEC_K
           / max(st["spec_proposed"], 1),
           "partial_accept_slot_ticks": partial,
           # accepted tokens past a request's end (max_new_tokens in the
           # middle of a speculation), never emitted
           "cut_tokens": st["spec_accepted"] + st["spec_proposed"] // SPEC_K
           - st["spec_emitted"],
           # the process-wide registry holds earlier servers' ticks too
           "tick_mean_ms": 1e3 * (
               (_metric(metrics, "engine_decode_tick_seconds_sum")
                - _metric(metrics0, "engine_decode_tick_seconds_sum"))
               / (_metric(metrics, "engine_decode_tick_seconds_count")
                  - _metric(metrics0, "engine_decode_tick_seconds_count"))),
           "cuda_graph_capture_s": capture_s,
           "decode_recompiles": recompiles,
           "launches": launches, "launches_by_form": forms}
    problems = []
    if launches != want or forms != want_forms:
        problems.append(f"launches {launches} {forms} != {want} "
                        f"{want_forms}")
    if st["admitted"] != len(prompts):
        problems.append(f"admitted {st['admitted']}")
    if rec["decode_recompiles"] != 0:
        problems.append("decode step captured again after warm-up")
    rec["problems"] = problems
    del service, server, handles, eng
    return rec, generated


def _eager_vs_graph(torch, cfg, params, prompts, paged):
    """The n-gram speculative engine in-process, cuda_graph False and
    True, on the same greedy traffic: the same kernels at the same
    shapes, so the tokens must be identical; prints the largest logprob
    difference and each engine's mean tick wall."""
    from megatron_tpu_torch.inference.engine import InferenceEngine, Request
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.inference.speculative import SpecConfig
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    import numpy as np

    out = {}
    for graph in (False, True):
        reg = MetricsRegistry()
        kw = dict(num_slots=8, max_seq_len=2048, vocab_size=cfg.vocab_size,
                  metrics=reg, device="cuda", cuda_graph=graph,
                  speculative=SpecConfig(k=SPEC_K))
        eng = (PagedInferenceEngine(cfg, params, page_size=PAGE_SIZE,
                                    prefill_chunk=PREFILL_CHUNK, **kw)
               if paged else InferenceEngine(cfg, params, **kw))
        reqs = [eng.submit(Request(prompt=np.asarray(p, np.int32),
                                   max_new_tokens=NEW_TOKENS))
                for p in prompts]
        eng.run_until_idle()
        torch.cuda.synchronize()
        if any(r.error for r in reqs):
            raise AssertionError([r.error for r in reqs])
        text = reg.render()
        out[graph] = ([r.generated for r in reqs], [r.logprobs for r in reqs],
                      1e3 * _metric(text, "engine_decode_tick_seconds_sum")
                      / _metric(text, "engine_decode_tick_seconds_count"),
                      eng.stats["ticks"])
        del eng, reqs
        free_cuda(torch)
    same = out[False][0] == out[True][0]
    diff = max(abs(a - b) for la, lb in zip(out[False][1], out[True][1])
               for a, b in zip(la, lb))
    return {"engine": "paged" if paged else "dense", "drafter": "ngram",
            "tokens_identical": same, "max_logprob_diff": diff,
            "eager_tick_mean_ms": out[False][2],
            "graph_tick_mean_ms": out[True][2],
            "ticks": [out[False][3], out[True][3]]}


def serve_speculative(torch, ft, card, dense_tokens):
    """Phase 3c. dense_tokens: phase 3's generated tokens per prompt
    (None if phase 3 failed), compared for information only."""
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg = presets.from_model_name("llama2-7B")
    params = init_params(cfg, SEED, device="cuda")
    tokenizer = NullTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
               for n in PROMPT_LENS]
    pattern = rng.integers(0, cfg.vocab_size - 1, size=SPEC_PATTERN).tolist()
    prompts = prompts[:SPEC_REQUESTS] + [
        pattern * (SPEC_REPEAT // SPEC_PATTERN)]
    torch.cuda.reset_peak_memory_stats()
    runs, seqs, problems = [], {}, []
    for paged in (False, True):
        for drafter, layers in (("ngram", None), ("model", NUM_LAYERS),
                                ("model", SPEC_PARTIAL_LAYERS)):
            rec, gen = _spec_server_run(torch, ft, cfg, params, tokenizer,
                                        prompts, paged, drafter, layers)
            if dense_tokens is not None:
                pairs = list(zip(gen[:SPEC_REQUESTS], dense_tokens))
                rec["share_equal_to_plain_tokens"] = (
                    sum(x == y for a, b in pairs for x, y in zip(a, b))
                    / sum(len(a) for a, _ in pairs))
            runs.append(rec)
            problems += [f"{rec['engine']} {drafter} {layers}: {p}"
                         for p in rec.pop("problems")]
            for p, g in zip(prompts, gen):
                seqs[(tuple(p), tuple(g))] = (p, g)
            # the server's handler closure and the engine hold reference
            # cycles: collect them before the next engine's caches
            free_cuda(torch)
    ab = [_eager_vs_graph(torch, cfg, params, prompts, paged)
          for paged in (False, True)]
    problems += [f"{r['engine']}: graph tokens differ from eager"
                 for r in ab if not r["tokens_identical"]]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tf = teacher_force(torch, dataclasses, cfg, params,
                       [list(p) for p, _ in seqs.values()],
                       [list(g) for _, g in seqs.values()])
    full = [r for r in runs if r["draft_layers"] == NUM_LAYERS]
    emit({"phase": "speculative_serving", "card": card,
          "model": "llama2-7B", "layers": NUM_LAYERS, "slots": 8,
          "max_seq_len": 2048, "k": SPEC_K,
          "prompt_tokens": [len(p) for p in prompts],
          "new_tokens": NEW_TOKENS, "runs": runs, "eager_vs_graph": ab,
          "max_memory_allocated_gib": peak_gib,
          "distinct_sequences": len(seqs), **tf})
    if tf["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"teacher-forced match "
                        f"{tf['teacher_forced_match']:.4f} < {MATCH_GATE}")
    if any(r["accept_rate"] < 0.5 for r in full):
        problems.append("a full-depth draft (the target's own weights) "
                        "accepted under half its drafts")
    for r in runs:
        if r["draft_layers"] == SPEC_PARTIAL_LAYERS and not (
                0 < r["accept_rate"] < 1
                and r["partial_accept_slot_ticks"] > 0):
            problems.append(f"{r['engine']} {SPEC_PARTIAL_LAYERS}-layer "
                            f"draft: no partially accepted tick (accept "
                            f"rate {r['accept_rate']})")
    if problems:
        raise AssertionError("speculative serving: " + "; ".join(problems))
    total = {"flash_fwd": 0, "flash_decode": 0, "paged_flash_decode": 0}
    for r in runs:
        for n in total:
            total[n] += r["launches"][n]
    return total


# ---------------------------------------------------------------------------
# phase 3d: serving control
# ---------------------------------------------------------------------------


def _call(url, body=None, method="PUT", timeout=600):
    """(status, payload, headers) of one JSON request; an HTTP error is a
    result here, not an exception."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode()), \
                dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), dict(e.headers)


def _start_server(cfg, params, tokenizer, **kw):
    """run_server on a thread: (service, server, thread, base url)."""
    from megatron_tpu_torch.inference.server import run_server

    ready, handles = threading.Event(), []
    thread = threading.Thread(
        target=run_server, daemon=True, name="smoke-control-server",
        kwargs=dict(cfg=cfg, params=params, tokenizer=tokenizer,
                    host="127.0.0.1", port=0, device="cuda", ready=ready,
                    service_out=handles, **kw))
    thread.start()
    if not ready.wait(300):
        raise RuntimeError("server did not start")
    service, server = handles
    return service, server, thread, \
        f"http://127.0.0.1:{server.server_address[1]}"


def _stop_server(server, thread):
    server.shutdown()
    thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")


def _traffic(base, prompts, engine=None):
    """The prompts as concurrent greedy requests of one prompt each:
    (results [(status, payload, headers)], wall seconds). With `engine`,
    each request is sent once the previous one is admitted, so the queue
    never holds more than one (a bounded queue takes the traffic whole)
    while the requests still decode together."""
    results = [None] * len(prompts)

    def one(i):
        results[i] = _call(base + "/api", {
            "prompts": [" ".join(map(str, prompts[i]))],
            "tokens_to_generate": NEW_TOKENS, "temperature": 0.0})

    t0 = time.monotonic()
    workers = []
    for i in range(len(prompts)):
        admitted = engine.stats["admitted"] if engine else 0
        workers.append(threading.Thread(target=one, args=(i,)))
        workers[-1].start()
        while engine and engine.stats["admitted"] == admitted and \
                time.monotonic() - t0 < 300:
            time.sleep(0.001)
    for w in workers:
        w.join(900)
    return results, time.monotonic() - t0


def _generated(results, prompts):
    """Each answer's generated tokens; fails unless every answer is a
    200 of prompt + NEW_TOKENS tokens."""
    out = []
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"request {i} failed: {res}")
        toks = [int(t) for t in res[1]["text"][0].split()]
        if toks[:len(prompts[i])] != prompts[i] or \
                len(toks) != len(prompts[i]) + NEW_TOKENS:
            raise AssertionError(f"request {i}: {len(toks)} tokens for a "
                                 f"{len(prompts[i])}-token prompt + "
                                 f"{NEW_TOKENS}")
        out.append(toks[len(prompts[i]):])
    return out


class _Counted:
    """One counted run of a phase-3d path: every decode and forward count
    set to 0 on entry and read on exit (added to `totals`)."""

    def __init__(self, ft, totals):
        self.ft, self.totals = ft, totals

    def __enter__(self):
        _zero_decode_counts(self.ft)
        return self

    def __exit__(self, *exc):
        self.launches = _decode_counts(self.ft)
        for name, n in self.launches.items():
            self.totals[name] = self.totals.get(name, 0) + n
        return False


def _score_plain(torch, dataclasses, cfg, params, tokens):
    """The plain path's teacher-forced logprobs of a padded batch (dense
    attention in bf16), each position's bf16 error band, the largest
    |bf16 - fp32| logit difference there (teacher_force's band), and each
    logprob's own |bf16 - fp32| error: three [B, S-1] CPU tensors."""
    from megatron_tpu_torch.models.language_model import lm_forward

    plain = dataclasses.replace(cfg, attention_impl="xla")
    ref = dataclasses.replace(plain, params_dtype="float32")
    t = torch.tensor(tokens, device="cuda")
    t = torch.where(t >= cfg.vocab_size, 0, t)
    idx = t[:, 1:, None]
    with torch.no_grad():
        lb = lm_forward(plain, params, t[:, :-1]).float()
        p32 = _upcast(params)
        l32 = lm_forward(ref, p32, t[:, :-1])
        del p32
        band = (lb - l32).abs().amax(-1).cpu()
        lp = torch.gather(torch.log_softmax(lb, -1), 2, idx)[..., 0]
        del lb
        lp32 = torch.gather(torch.log_softmax(l32, -1), 2, idx)[..., 0]
        del l32
        lp_err = (lp - lp32).abs().cpu()
        lp = lp.cpu()
    torch.cuda.empty_cache()
    return lp, band, lp_err


def _upcast(tree):
    """An fp32 copy of a parameter tree; a weight-quantized leaf becomes
    its dequantized fp32 weight."""
    import torch

    from megatron_tpu_torch.ops.weight_quant import deq, is_quantized

    return {k: (deq(v, torch.float32) if is_quantized(v) else
                _upcast(v) if isinstance(v, dict) else v.float())
            for k, v in tree.items()}


def _real_positions(torch, lengths, width):
    """[B, width] mask of the scored positions inside each prompt."""
    return (torch.arange(width)[None, :]
            < torch.tensor(lengths)[:, None] - 1)


def _control_one_shot(torch, ft, cfg, params, tokenizer, prompts, totals):
    """(a) one-shot serving, (b) scoring and (c) beam search through an
    engine-less server (engine_slots=0)."""
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.inference.generation import (
        generate_tokens, score_tokens,
    )

    service, server, thread, base = _start_server(
        cfg, params, tokenizer, engine_slots=0)
    rec = {}
    try:
        with _Counted(ft, totals) as run:
            results, wall_s = _traffic(base, prompts)
        generated = _generated(results, prompts)
        rec["one_shot"] = {"wall_s": wall_s, "launches": run.launches}
        if any(run.launches.values()):
            raise AssertionError(f"one-shot launches {run.launches}: the "
                                 "one-shot prefill and decode take the "
                                 "dense path")
        lengths = [len(p) for p in prompts]
        with _Counted(ft, totals) as run:
            t0 = time.monotonic()
            status, body, _ = _call(base + "/api", {
                "prompts": [" ".join(map(str, p)) for p in prompts],
                "tokens_to_generate": 0})
            score_s = time.monotonic() - t0
        if status != 200:
            raise AssertionError(f"scoring: {status} {body}")
        want = {"flash_fwd": NUM_LAYERS, "flash_decode": 0,
                "paged_flash_decode": 0}
        if run.launches != want:
            raise AssertionError(f"scoring launches {run.launches} != "
                                 f"{want} (one scored batch)")
        padded = np.full((len(prompts), max(lengths)), tokenizer.pad,
                         np.int64)
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = p
        plain, band, _ = _score_plain(torch, dataclasses, cfg, params,
                                      padded)
        got = torch.tensor(body["logprobs"])
        real = _real_positions(torch, lengths, padded.shape[1] - 1)
        diff, band = (got - plain).abs()[real], band[real]
        # a logprob is a logit less the log-sum-exp, each off by up to
        # the position's band on a bf16 path
        within = float((diff <= 2 * band).float().mean())
        rec["scoring"] = {"wall_s": score_s, "launches": run.launches,
                          "positions": int(real.sum()),
                          "max_abs_err_vs_plain": float(diff.max()),
                          "mean_abs_err_vs_plain": float(diff.mean()),
                          "share_within_2x_band": within,
                          "band_max": float(band.max())}
        if within < MATCH_GATE:
            raise AssertionError(f"scoring: {rec['scoring']} (gate: "
                                 f"|kernel - plain| <= 2 x the position's "
                                 f"bf16 band at >= {MATCH_GATE})")

        # (c) beam search on the 100-token prompt
        prompt = prompts[1]
        with _Counted(ft, totals) as run:
            t0 = time.monotonic()
            status, body, _ = _call(base + "/api", {
                "prompts": [" ".join(map(str, prompt))],
                "tokens_to_generate": BEAM_TOKENS,
                "beam_width": BEAM_WIDTH})
            beam_s = time.monotonic() - t0
        if status != 200:
            raise AssertionError(f"beam search: {status} {body}")
        scores = body["scores"]
        beams = [[int(t) for t in text.split()] for text in body["text"]]
        greedy = generate_tokens(cfg, params, np.asarray([prompt]),
                                 np.asarray([len(prompt)]), BEAM_TOKENS,
                                 temperature=0.0, vocab_size=tokenizer.vocab_size,
                                 eod=tokenizer.eod)
        p0 = len(prompt) - 1
        greedy_score = float(greedy.logprobs[0, p0:p0 + BEAM_TOKENS].sum()
                             / BEAM_TOKENS)
        width = len(prompt) + BEAM_TOKENS
        body_tokens = np.asarray([b[:width] for b in beams])
        scored = score_tokens(cfg, params, body_tokens)
        rescored = scored[:, p0:p0 + BEAM_TOKENS].sum(1) / BEAM_TOKENS
        scores_np = np.asarray(scores)
        rescore_err = np.abs(rescored - scores_np)
        # each sequence's tolerance comes from its own scored positions: a
        # beam score is the mean of BEAM_TOKENS logprobs; the beam's path
        # and the re-score are two bf16 paths, each taken as far from
        # fp32 as the plain path's logprob there (rows: the beams, then
        # greedy)
        _, _, lp_err = _score_plain(
            torch, dataclasses, cfg, params,
            np.concatenate([body_tokens, greedy.tokens[:1, :width]]))
        tols = 2 * lp_err[:, p0:p0 + BEAM_TOKENS].double().mean(1).numpy()
        beam_tol, greedy_tol = tols[:-1], float(tols[-1])
        # the same readout one position off (the window a cache written
        # at the wrong index would score): how far a position fault lands
        shifted = scored[:, p0 - 1:p0 - 1 + BEAM_TOKENS].sum(1) / BEAM_TOKENS
        rec["beam"] = {"width": BEAM_WIDTH, "new_tokens": BEAM_TOKENS,
                       "wall_s": beam_s, "scores": scores,
                       "greedy_score": greedy_score,
                       "rescored": rescored.tolist(),
                       "rescore_err": rescore_err.tolist(),
                       "tolerance": beam_tol.tolist(),
                       "greedy_tolerance": greedy_tol,
                       "off_by_one_err": np.abs(shifted - scores_np).tolist(),
                       "launches": run.launches}
        if not (len(beams) == BEAM_WIDTH
                and all(b[:len(prompt)] == prompt for b in beams)):
            raise AssertionError("beam search: beams lost their prompt")
        if not scores[0] >= greedy_score - beam_tol[0] - greedy_tol:
            raise AssertionError(f"beam search: best beam {scores[0]} below "
                                 f"the greedy sequence's {greedy_score}")
        if not (rescore_err <= beam_tol).all():
            raise AssertionError(f"beam scores re-score {rescore_err} apart "
                                 f"(tolerances {beam_tol})")
    finally:
        _stop_server(server, thread)
    del service, server
    free_cuda(torch)
    return rec, generated


def _control_lifecycle(torch, ft, cfg, params, tokenizer, prompts,
                       dense_tokens, totals):
    """(d) bounded queue and deadlines, (e) warmup, drain and readmit, on
    one 8-slot engine with max_queue CONTROL_QUEUE. The service is built
    as run_server builds it and served on a thread here, so the probe
    before warmup() is sure to see an unwarmed server."""
    from http.server import ThreadingHTTPServer

    from megatron_tpu_torch.inference.server import (
        GenerationService, make_handler,
    )

    service = GenerationService(cfg, params, tokenizer, engine_slots=8,
                                engine_max_seq_len=2048, device="cuda",
                                engine_max_queue=CONTROL_QUEUE, warmup=True)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    eng = service.engine
    rec = {}
    try:
        # (e) readiness waits for warmup; liveness does not
        r0, h0 = _call(base + "/readyz", method="GET"), \
            _call(base + "/healthz", method="GET")
        t0 = time.monotonic()
        service.warmup()
        warm_s = time.monotonic() - t0
        r1 = _call(base + "/readyz", method="GET")
        rec["warmup"] = {"readyz_before": r0[0], "healthz_before": h0[0],
                         "readyz_after": r1[0], "warmup_s": warm_s}
        if (r0[0], r0[1]["warmed"], h0[0], r1[0]) != (503, False, 200, 200):
            raise AssertionError(f"warmup gate: {rec['warmup']}")

        # (d) CONTROL_BURST concurrent long requests against a queue of
        # CONTROL_QUEUE: the rest answer 503 with Retry-After
        burst = [prompts[-1]] * CONTROL_BURST
        s0 = dict(eng.stats)
        results, _ = _traffic(base, burst)
        codes = [r[0] for r in results]
        ok = [r for r in results if r[0] == 200]
        _generated(ok, burst[:len(ok)])
        full = [r for r in results if r[0] == 503]
        rec["overload"] = {"max_queue": CONTROL_QUEUE,
                           "requests": CONTROL_BURST,
                           "statuses": sorted(codes),
                           "rejected": eng.stats["rejected"] - s0["rejected"]}
        if not full or len(ok) + len(full) != CONTROL_BURST or not all(
                r[2].get("Retry-After") for r in full):
            raise AssertionError(f"overload: {rec['overload']}")

        status, body, _ = _call(base + "/api", {
            "prompts": [" ".join(map(str, prompts[1]))],
            "tokens_to_generate": CONTROL_DEADLINE_TOKENS,
            "temperature": 0.0, "deadline_s": CONTROL_DEADLINE_S})
        rec["deadline"] = {"deadline_s": CONTROL_DEADLINE_S,
                           "status": status, "message": body.get("message"),
                           "timeouts": eng.stats["timeouts"]}
        if status != 504 or body.get("timeout") is not True:
            raise AssertionError(f"deadline: {rec['deadline']}")

        # then the phase-3 traffic: the engine serves on, token for token
        with _Counted(ft, totals) as run:
            s0 = dict(eng.stats)
            results, wall_s = _traffic(base, prompts, engine=eng)
        generated = _generated(results, prompts)
        prefills = eng.stats["admitted"] - s0["admitted"]
        ticks = eng.stats["ticks"] - s0["ticks"]
        want = {"flash_fwd": NUM_LAYERS * prefills,
                "flash_decode": NUM_LAYERS * ticks, "paged_flash_decode": 0}
        rec["after"] = {"wall_s": wall_s, "launches": run.launches,
                        "prefills": prefills, "ticks": ticks,
                        "tokens_equal_phase3": (generated == dense_tokens
                                                if dense_tokens else None)}
        if run.launches != want:
            raise AssertionError(f"launches {run.launches} != {want}")
        if dense_tokens is not None and generated != dense_tokens:
            raise AssertionError("after overload and a deadline the "
                                 "engine's tokens differ from phase 3's")

        # (e) drain, then readmit
        d = _call(base + "/admin/drain", {"timeout_s": 60}, method="POST")
        refused = _call(base + "/api", {"prompts": ["1 2"],
                                        "tokens_to_generate": 2})
        r_drain = _call(base + "/readyz", method="GET")[0]
        h_drain = _call(base + "/healthz", method="GET")[0]
        st = _call(base + "/admin/status", method="GET")[1]
        back = _call(base + "/admin/readmit", {}, method="POST")[0]
        r_back = _call(base + "/readyz", method="GET")[0]
        served = _call(base + "/api", {"prompts": ["1 2"],
                                       "tokens_to_generate": 2,
                                       "temperature": 0.0})[0]
        rec["drain"] = {"drained": d[1].get("drained"),
                        "api_while_draining": refused[0],
                        "retry_after": refused[2].get("Retry-After"),
                        "readyz_draining": r_drain,
                        "healthz_draining": h_drain,
                        "status_draining": st.get("draining"),
                        "readmit": back, "readyz_after": r_back,
                        "api_after": served}
        if (d[0], d[1].get("drained"), refused[0], r_drain, h_drain,
                st.get("draining"), back, r_back, served) != (
                200, True, 503, 503, 200, True, 200, 200, 200) or \
                not refused[2].get("Retry-After"):
            raise AssertionError(f"drain/readmit: {rec['drain']}")
        rec["decode_recompiles"] = eng.stats["decode_recompiles"]
        if rec["decode_recompiles"]:
            raise AssertionError("the decode step was captured again")
    finally:
        server.shutdown()
        thread.join(120)
        server.server_close()
        service.shutdown()
    del service, server, eng
    free_cuda(torch)
    return rec


def _tick_times(torch, cfg, params, paged, int8, card, label="control"):
    """One engine (graph) filled as profile_serving fills it (8 slots of
    5 .. 1500-token prompts, scaled to an absolute model's shorter
    slots), TICK_COUNT decode ticks timed as it times them: (record)."""
    import numpy as np

    from megatron_tpu_torch.tools.profile_serving import (
        _window, decode_ticks, filled_engine,
    )

    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    eng = filled_engine(np, cfg, params, np.random.default_rng(SEED),
                        paged=paged, int8=int8)
    ticks = decode_ticks(eng, TICK_COUNT, paged)
    kv = "int8" if int8 else "bf16"
    wall_ms, kernels = _window(
        torch, f"{label}_{'paged' if paged else 'dense'}_tick_{kv}", ticks,
        card)
    rec = {"engine": "paged" if paged else "dense", "kv": kv,
           "cache_bytes": sum(c.nbytes for c in eng.caches),
           "tick_wall_ms": wall_ms / TICK_COUNT,
           "tick_device_ms": (sum(ms for ms, _ in kernels.values())
                              / TICK_COUNT if kernels else "not measured"),
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30}
    eng.stop()
    del eng
    free_cuda(torch)
    return rec


def _control_int8(torch, ft, cfg, params, tokenizer, prompts, totals, card):
    """(g) the phase-3 traffic through int8 servers on both engines,
    under the teacher-forced gate with the same int8 round trip; then
    each engine's decode tick with int8 and bf16 caches."""
    import dataclasses

    rec, seqs = {"runs": []}, []
    for paged in (False, True):
        kw = dict(kv_paging=True, page_size=PAGE_SIZE,
                  prefill_chunk=PREFILL_CHUNK) if paged else {}
        service, server, thread, base = _start_server(
            cfg, params, tokenizer, engine_slots=8, engine_max_seq_len=2048,
            kv_cache_int8=True, **kw)
        eng = service.engine
        try:
            with _Counted(ft, totals) as run:
                s0 = dict(eng.stats)
                results, wall_s = _traffic(base, prompts)
            generated = _generated(results, prompts)
            prefills = eng.stats["admitted"] - s0["admitted"]
            ticks = eng.stats["ticks"] - s0["ticks"]
            recompiles = eng.stats["decode_recompiles"]
        finally:
            _stop_server(server, thread)
        name = "paged_flash_decode" if paged else "flash_decode"
        want = {"flash_fwd": 0 if paged else NUM_LAYERS * prefills,
                "flash_decode": 0, "paged_flash_decode": 0}
        want[name] = NUM_LAYERS * ticks
        rec["runs"].append({"engine": "paged" if paged else "dense",
                            "wall_s": wall_s, "prefills": prefills,
                            "ticks": ticks, "launches": run.launches,
                            "decode_recompiles": recompiles})
        if run.launches != want or recompiles:
            raise AssertionError(f"int8 {'paged' if paged else 'dense'}: "
                                 f"launches {run.launches} != {want}, "
                                 f"recompiles {recompiles}")
        seqs.append(generated)
        del service, server, eng
        free_cuda(torch)
    rec["dense_vs_paged_share_equal"] = (
        sum(x == y for a, b in zip(*seqs) for x, y in zip(a, b))
        / sum(len(a) for a in seqs[0]))
    rec["ticks"] = [_tick_times(torch, cfg, params, False, int8, card)
                    for int8 in (False, True)]
    CONTROL_TICKS["dense_bf16"] = rec["ticks"][0]
    cut, layers = _first_layers(cfg, params, CONTROL_PAGED_TICK_LAYERS)
    rec["ticks"] += [dict(_tick_times(torch, cut, layers, True, int8, card),
                          layers=CONTROL_PAGED_TICK_LAYERS)
                     for int8 in (False, True)]
    del layers
    tf = teacher_force(torch, dataclasses, cfg, params, prompts * 2,
                       seqs[0] + seqs[1], int8=True)
    rec.update(tf)
    if tf["teacher_forced_match"] < MATCH_GATE:
        raise AssertionError(
            f"int8 teacher-forced match {tf['teacher_forced_match']:.4f} "
            f"< {MATCH_GATE}")
    return rec


def _first_layers(cfg, params, n):
    """(cfg, params) cut to the first n layers: views of the stacked
    [L, ...] leaves, the rest shared."""
    import dataclasses

    return (dataclasses.replace(cfg, num_layers=n).validate(),
            {**params, "layers": {k: _slice_layers(v, n)
                                  for k, v in params["layers"].items()}})


def _slice_layers(tree, n):
    if isinstance(tree, dict):
        return {k: _slice_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _control_reload(torch, ft, tokenizer, prompts, totals):
    """(f) hot reload at Llama-2-7B width cut to RELOAD_LAYERS layers:
    serve seed SEED's weights, reload seed RELOAD_SEED's from a
    params-only checkpoint under replay, then hold the tokens against a
    fresh engine built on those weights; a torn checkpoint answers 409."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from megatron_tpu_torch.inference.engine import InferenceEngine, Request
    from megatron_tpu_torch.inference.fleet.reload import (
        save_params_checkpoint,
    )
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    cfg = dataclasses.replace(presets.from_model_name("llama2-7B"),
                              num_layers=RELOAD_LAYERS).validate()
    old = init_params(cfg, SEED, device="cuda")
    new = init_params(cfg, RELOAD_SEED, device="cuda")
    d = tempfile.mkdtemp(prefix="smoke_reload_")
    rec = {"layers": RELOAD_LAYERS, "cut": f"depth {NUM_LAYERS} -> "
           f"{RELOAD_LAYERS} layers (width unchanged) to keep the "
           "checkpoint small"}
    try:
        t0 = time.monotonic()
        path = save_params_checkpoint(d, 1, new)
        rec["save_s"] = time.monotonic() - t0
        rec["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(path) for f in fs)
        torn = save_params_checkpoint(d, 2, new)
        pt = os.path.join(torn, "state", "params.pt")
        with open(pt, "r+b") as f:
            f.truncate(os.path.getsize(pt) // 2)
        service, server, thread, base = _start_server(
            cfg, old, tokenizer, engine_slots=8, engine_max_seq_len=2048,
            reload_dir=d, weights_version=0)
        eng = service.engine
        try:
            before = _generated(_traffic(base, prompts)[0], prompts)
            t0 = time.monotonic()
            status, body, _ = _call(base + "/admin/reload",
                                    {"iteration": 1}, method="POST")
            rec["reload_wall_s"] = time.monotonic() - t0
            if status != 200 or body.get("version") != 1:
                raise AssertionError(f"reload: {status} {body}")
            with _Counted(ft, totals) as run:
                s0 = dict(eng.stats)
                results, _ = _traffic(base, prompts)
            after = _generated(results, prompts)
            ticks = eng.stats["ticks"] - s0["ticks"]
            prefills = eng.stats["admitted"] - s0["admitted"]
            versions = [r[1].get("weights_version") for r in results]
            torn_status = _call(base + "/admin/reload", {"iteration": 2},
                                method="POST")[0]
            st = dict(eng.stats)
        finally:
            _stop_server(server, thread)
        del service, server, eng
        free_cuda(torch)
        fresh = InferenceEngine(cfg, new, num_slots=8, max_seq_len=2048,
                                metrics=MetricsRegistry(), device="cuda")
        reqs = [fresh.submit(Request(prompt=np.asarray(p, np.int32),
                                     max_new_tokens=NEW_TOKENS))
                for p in prompts]
        fresh.run_until_idle()
        want_tokens = [r.generated for r in reqs]
        del fresh
    finally:
        shutil.rmtree(d, ignore_errors=True)
    want = {"flash_fwd": RELOAD_LAYERS * prefills,
            "flash_decode": RELOAD_LAYERS * ticks, "paged_flash_decode": 0}
    rec.update({"launches": run.launches, "ticks": ticks,
                "weight_reloads": st["weight_reloads"],
                "decode_recompiles": st["decode_recompiles"],
                "weights_version": versions, "torn_status": torn_status,
                "tokens_equal_fresh_engine": after == want_tokens,
                "tokens_changed": after != before})
    if not (after == want_tokens and after != before
            and run.launches == want and st["decode_recompiles"] == 0
            and st["weight_reloads"] == 1 and torn_status == 409
            and versions == [1] * len(prompts)):
        raise AssertionError(f"reload: {rec}")
    return rec


def serve_control(torch, ft, card, dense_tokens):
    """Phase 3d. dense_tokens: phase 3's generated tokens per prompt
    (None if phase 3 failed: then the lifecycle run is not compared)."""
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg = presets.from_model_name("llama2-7B")
    params = init_params(cfg, SEED, device="cuda")
    tokenizer = NullTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
               for n in PROMPT_LENS]
    totals: dict = {}
    torch.cuda.reset_peak_memory_stats()
    one_shot, generated = _control_one_shot(torch, ft, cfg, params,
                                            tokenizer, prompts, totals)
    one_shot["one_shot"].update(teacher_force(
        torch, dataclasses, cfg, params, prompts, generated))
    if dense_tokens is not None:
        one_shot["one_shot"]["share_equal_to_engine_tokens"] = (
            sum(x == y for a, b in zip(generated, dense_tokens)
                for x, y in zip(a, b)) / (len(prompts) * NEW_TOKENS))
    lifecycle = _control_lifecycle(torch, ft, cfg, params, tokenizer,
                                   prompts, dense_tokens, totals)
    int8 = _control_int8(torch, ft, cfg, params, tokenizer, prompts, totals,
                         card)
    del params
    free_cuda(torch)
    reload = _control_reload(torch, ft, tokenizer, prompts, totals)
    emit({"phase": "serving_control", "card": card, "model": "llama2-7B",
          **one_shot, **lifecycle, "int8": int8, "reload": reload,
          "launches": totals})
    if one_shot["one_shot"]["teacher_forced_match"] < MATCH_GATE:
        raise AssertionError("one-shot teacher-forced match "
                             f"{one_shot['one_shot']['teacher_forced_match']}"
                             f" < {MATCH_GATE}")
    return totals


def teacher_force(torch, dataclasses, cfg, params, prompts, generated,
                  int8=False, stream_fp32=False, mesh=None, tp_comm=None,
                  transport=None, vocab=None):
    """Hold the engine's greedy tokens against the plain path.

    Each finished sequence is teacher-forced through lm_forward with the
    dense attention (the plain path) in bf16, and through the same plain
    path in fp32 (weights upcast) as the referee. A position agrees when
    the engine's token is the bf16 plain argmax, or a near-tie: its
    plain logit lies within that position's bf16 error band, the largest
    |bf16 plain - fp32 plain| logit difference there. A random-init 7B
    in bf16 has logit gaps of the order of that band (the bf16 plain
    path's own argmax matches the fp32 one at ~90% of positions), so a
    strict argmax gate would test bf16 rounding, not the engine; the
    strict rates are reported beside the gate. int8=True runs both plain
    passes with the int8 KV round trip the engine made (an int8 cache of
    the sequence's length: K/V quantized, attention over the dequantized
    cache). stream_fp32=True upcasts the referee's weights a layer at a
    time (a model too large for an fp32 copy beside it). mesh, tp_comm:
    run on every rank of a tensor-parallel mesh over this rank's params,
    both plain passes through the same compressed collectives as the
    engine (quant/collectives.py), the function that engine serves (as
    int8=True is for an int8 cache). transport: for each sequence, each
    position's largest logit change made by a lossy transport the engine
    ran and the plain path does not (_transport_error); the engine's
    token and the plain argmax may each move by it, so twice it widens
    that position's near-tie band. teacher_forced_band_max is the largest
    bf16 band, without the transport. vocab: the tokenizer's vocabulary
    when it is smaller than the embedding table (the engine samples only
    below it, inference/sampling.py's clamp): the argmax and the gap are
    taken below it too; the band stays the whole row's error."""
    from megatron_tpu_torch.inference.generation import _init_caches
    from megatron_tpu_torch.models.language_model import lm_forward

    def forward(c, p, seq):
        if mesh is not None:
            return lm_forward(c, p, seq, mesh=mesh, tp_comm=tp_comm)
        if not int8:
            return lm_forward(c, p, seq)
        caches = _init_caches(c, 1, seq.shape[1], device="cuda", int8=True)
        return lm_forward(c, p, seq, kv_caches=caches, cache_index=0)[0]

    plain = dataclasses.replace(cfg, attention_impl="xla")
    ref = dataclasses.replace(plain, params_dtype="float32")
    params32 = None if stream_fp32 else _upcast(params)
    strict = near = plain_vs_fp32 = total = 0
    worst_gap = band_max = 0.0
    misses = []          # the positions outside the near-tie band
    with torch.no_grad():
        for seq_i, (prompt, gen) in enumerate(zip(prompts, generated)):
            seq = torch.tensor([prompt + gen[:-1]], device="cuda")
            p0 = len(prompt) - 1          # logits from the last prompt row
            lb = forward(plain, params, seq)[0, p0:].float()
            l32 = (_fp32_logits_streamed(torch, ref, params, seq)[0, p0:]
                   if stream_fp32 else forward(ref, params32, seq)[0, p0:])
            band = (lb - l32).abs().max(-1).values
            lb, l32 = lb[:, :vocab], l32[:, :vocab]
            tok = torch.tensor(gen, device="cuda")
            gap = lb.max(-1).values - lb.gather(1, tok[:, None])[:, 0]
            band_max = max(band_max, float(band.max()))
            if transport is not None:
                band = band + 2 * torch.tensor(transport[seq_i],
                                               device=band.device)
            strict += int((lb.argmax(-1) == tok).sum())
            near += int((gap <= band).sum())
            misses += [{"sequence": seq_i, "position": j,
                        "gap": float(gap[j]), "band": float(band[j])}
                       for j in (gap > band).nonzero().flatten().tolist()]
            plain_vs_fp32 += int((lb.argmax(-1) == l32.argmax(-1)).sum())
            total += len(gen)
            worst_gap = max(worst_gap, float(gap.max()))
    del params32
    torch.cuda.empty_cache()
    return {"teacher_forced_match": near / total,
            "teacher_forced_strict_argmax": strict / total,
            "plain_bf16_vs_fp32_argmax": plain_vs_fp32 / total,
            "teacher_forced_worst_gap": worst_gap,
            "teacher_forced_band_max": band_max,
            "teacher_forced_positions": total,
            "teacher_forced_misses": misses}


# ---------------------------------------------------------------------------
# phase 3f: the text path (the server's tokenizer flags, the REST client,
# MSDP)
# ---------------------------------------------------------------------------

TEXT_PROMPT_TOKENS = PROMPT_LENS    # phase 3's lengths, in BPE tokens
TEXT_CLI_TOKENS = 16
MSDP_DIALOGUES = 16
MSDP_SAMPLES = 8
MSDP_NEW_TOKENS = 32
# response prompts of random-letter words take ~233 BPE tokens an
# example: 6 examples (~1,400) + the sample (~170) + 32 fit a 2048 slot
MSDP_RESPONSE_EXAMPLES = 6


class _RecordingTokenizer:
    """The served tokenizer, recording every id row the server decodes:
    each request's whole row (prompt + generated; its per-token segments
    are rows of one id and are not kept)."""

    def __init__(self, tok):
        self.tok = tok
        self.rows = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def detokenize(self, ids):
        ids = [int(t) for t in ids]
        if len(ids) > 1:
            with self._lock:
                self.rows.append(ids)
        return self.tok.detokenize(ids)


def write_wow(np, path, words, n=MSDP_DIALOGUES) -> None:
    """n Wizard-of-Wikipedia dialogues (the WoW json the MSDP
    preprocessing reads) from a seed over `words`: three apprentice and
    three wizard turns; a wizard turn copies 12 of its checked sentence's
    14 words (the response-prompt filter's overlap), every third has no
    checked sentence (no_passages_used)."""
    rng = np.random.default_rng(SEED + 21)

    def sentence(k):
        return " ".join(words[int(i)] for i in rng.integers(0, len(words), k))

    data = []
    for d in range(n):
        topic = f"Topic {words[d % 7]}"
        dialog = []
        for t in range(6):
            if t % 2 == 0:
                dialog.append({"speaker": "0_Apprentice",
                               "text": sentence(6) + "?"})
            elif t == 5:
                dialog.append({"speaker": "1_Wizard", "text": sentence(8),
                               "checked_sentence": {},
                               "checked_passage": {}})
            else:
                know = sentence(14)
                dialog.append({
                    "speaker": "1_Wizard",
                    "text": " ".join(know.split()[:12]) + " "
                            + sentence(3) + ".",
                    "checked_sentence": {"s": know + "."},
                    "checked_passage": {"p": topic}})
        data.append({"chosen_topic": topic, "dialog": dialog})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)


def _msdp(np, tmp, words, url) -> dict:
    """MSDP end to end through the CLIs' mains: 16 WoW dialogues through
    msdp_preprocess's process_wow_dataset, get_knwl_gen_prompts (the
    first MSDP_SAMPLES rows against all) and get_resp_gen_prompts; msdp
    prompt-knowledge on the samples through the server
    (--megatron_api_url), prepare_input, prompt-response, then eval-f1
    of both against the references."""
    import contextlib
    import io

    from megatron_tpu_torch.tasks import msdp, msdp_preprocess

    p = lambda name: os.path.join(tmp, name)  # noqa: E731
    write_wow(np, p("wow.json"), words)
    t0 = time.monotonic()
    rows = msdp_preprocess.main([
        "--func", "process_wow_dataset", "--raw_file", p("wow.json"),
        "--processed_file", p("test.tsv"), "--knwl_ref_file",
        p("knwl_ref.txt"), "--resp_ref_file", p("resp_ref.txt")])
    for src, dst in (("test.tsv", "test8.tsv"), ("knwl_ref.txt",
                                                 "knwl_ref8.txt"),
                     ("resp_ref.txt", "resp_ref8.txt")):
        with open(p(src)) as fi, open(p(dst), "w") as fo:
            fo.writelines(fi.readlines()[:MSDP_SAMPLES])
    msdp_preprocess.main([
        "--func", "get_knwl_gen_prompts", "--test_file", p("test8.tsv"),
        "--train_file", p("test.tsv"), "--processed_file",
        p("knwl_prompts.jsonl"), "--data_type", "wow_seen"])
    n_resp = msdp_preprocess.main([
        "--func", "get_resp_gen_prompts", "--train_file", p("test.tsv"),
        "--processed_file", p("resp_prompt.txt")])
    prep_s = time.monotonic() - t0
    api = ["--out_seq_length", str(MSDP_NEW_TOKENS), "--megatron_api_url",
           url]
    t0 = time.monotonic()
    msdp.main(["prompt-knowledge", "--prompt_file", p("knwl_prompts.jsonl"),
               "--sample_input_file", p("test8.tsv"), "--sample_output_file",
               p("knwl_gen.txt"), *api])
    knwl_s = time.monotonic() - t0
    msdp_preprocess.main([
        "--func", "prepare_input", "--test_file", p("test8.tsv"),
        "--knwl_gen_file", p("knwl_gen.txt"), "--processed_file",
        p("resp_input.tsv")])
    t0 = time.monotonic()
    msdp.main(["prompt-response", "--prompt_file", p("resp_prompt.txt"),
               "--sample_input_file", p("resp_input.tsv"),
               "--sample_output_file", p("resp_gen.txt"),
               "--num_prompt_examples", str(MSDP_RESPONSE_EXAMPLES), *api])
    resp_s = time.monotonic() - t0
    scores = {}
    for kind in ("knwl", "resp"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            msdp.main(["eval-f1", "--guess_file", p(f"{kind}_gen.txt"),
                       "--answer_file", p(f"{kind}_ref8.txt")])
        scores[kind] = dict(zip(
            ("precision", "recall", "f1"),
            msdp.evaluate_f1(p(f"{kind}_gen.txt"), p(f"{kind}_ref8.txt"))))
        scores[kind]["printed"] = out.getvalue().strip()
    # counted as eval-f1 reads them: a generated line may hold a byte
    # str.splitlines() would also split at (\x0b, \x85, ...)
    lines = {}
    for k in ("knwl", "resp"):
        with open(p(f"{k}_gen.txt")) as f:
            lines[k] = sum(1 for _ in f)
    return {"rows": rows, "response_prompts": n_resp,
            "samples": MSDP_SAMPLES, "lines": lines,
            "preprocess_s": prep_s, "prompt_knowledge_s": knwl_s,
            "prompt_response_s": resp_s, "f1": scores}


def text_serving(torch, np, ft, card):
    """Phase 3f (the module docstring)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke_text_")
    try:
        return _text_serving(torch, np, ft, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _text_serving(torch, np, ft, card, tmp):
    import dataclasses

    from megatron_tpu_torch.inference.generation import generate_tokens
    from megatron_tpu_torch.tools import run_text_generation_server as rts

    docs = loop_documents(np, LOOP_MERGE_DOCS)
    voc = loop_vocab(np, tmp, docs)
    argv = ["--model_name", "llama2-7B", "--tokenizer_type",
            "GPT2BPETokenizer", "--vocab_file", voc["vocab_file"],
            "--merges_file", voc["merges_file"], "--seed", str(SEED),
            "--host", "127.0.0.1", "--port", "0", "--serve_num_slots", "8",
            "--serve_max_seq_len", "2048", "--device", "cuda"]
    ready, handles = threading.Event(), []
    t0 = time.monotonic()
    thread = threading.Thread(
        target=rts.main, args=(argv,), daemon=True, name="smoke-text-server",
        kwargs=dict(ready=ready, service_out=handles))
    thread.start()
    if not ready.wait(300):
        raise RuntimeError("text server did not start")
    start_s = time.monotonic() - t0
    service, server = handles
    rec = _RecordingTokenizer(service.tokenizer)
    service.tokenizer = rec
    tok, eng, cfg, params = rec.tok, service.engine, service.cfg, \
        service.params
    if tok.vocab_size != voc["vocab_size"]:
        raise AssertionError(f"served vocabulary {tok.vocab_size} != "
                             f"{voc['vocab_size']}")
    address = f"127.0.0.1:{server.server_address[1]}"
    base = "http://" + address
    stream = tok.tokenize(" ".join(docs))
    prompt_ids, prompts = [], []
    for i, n in enumerate(TEXT_PROMPT_TOKENS):
        text = tok.detokenize(stream[i * 2000:i * 2000 + n])
        prompts.append(text)
        prompt_ids.append(tok.tokenize(text))
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        before = r.read().decode()
    results = [None] * len(prompts)

    def one(i):
        t = time.monotonic()
        results[i] = (*_put(base + "/api", {
            "prompts": [prompts[i]], "tokens_to_generate": NEW_TOKENS,
            "temperature": 0.0}), time.monotonic() - t)

    try:
        # the main path's run: every count starts at 0 here
        _zero_decode_counts(ft)
        prefills0, ticks0 = eng.stats["admitted"], eng.stats["ticks"]
        t_conc = time.monotonic()
        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(900)
        conc_s = time.monotonic() - t_conc
        t0 = time.monotonic()
        cli = subprocess.run(
            [sys.executable, "-m", "megatron_tpu_torch.tools."
             "text_generation_cli", address, "--tokens_to_generate",
             str(TEXT_CLI_TOKENS)], input=f"{prompts[0]}\n{prompts[1]}\n",
            cwd=REPO, capture_output=True, text=True, timeout=300)
        cli_s = time.monotonic() - t0
        words = sorted({w.strip(".").lower() for d in docs[:50]
                        for w in d.split()})
        msdp_run = _msdp(np, tmp, words, base + "/api")
        launches = _decode_counts(ft)
        prefills = eng.stats["admitted"] - prefills0
        ticks = eng.stats["ticks"] - ticks0
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            after = r.read().decode()
    finally:
        server.shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("text server thread did not stop")
    del service, server, handles, eng
    torch.cuda.empty_cache()

    problems = []
    for i, res in enumerate(results):
        if res is None or res[0] != 200 or \
                not res[1]["text"][0].startswith(prompts[i]):
            problems.append(f"text request {i}: {res and res[:2]}")
    answers = [ln for ln in cli.stdout.splitlines()
               if ln.startswith("Enter prompt: Megatron-TPU: ")
               or ln.startswith("Megatron-TPU: ")]
    if cli.returncode != 0 or len(answers) != 2 or not all(
            a.split("Megatron-TPU: ", 1)[1].startswith(p)
            for a, p in zip(answers, prompts)):
        problems.append(f"text_generation_cli rc {cli.returncode}: "
                        f"{cli.stdout[-800:]} {cli.stderr[-800:]}")
    if msdp_run["lines"] != {"knwl": MSDP_SAMPLES, "resp": MSDP_SAMPLES}:
        problems.append(f"MSDP output lines {msdp_run['lines']}")
    top_id = max(max(r) for r in rec.rows) if rec.rows else -1
    if not rec.rows or top_id >= tok.vocab_size:
        problems.append(f"generated id {top_id} >= the tokenizer's "
                        f"{tok.vocab_size} ({len(rec.rows)} rows)")
    want = {"flash_fwd": NUM_LAYERS * prefills,
            "flash_decode": NUM_LAYERS * ticks, "paged_flash_decode": 0}
    if launches != want or not ticks:
        problems.append(f"launches {launches} != {want} (prefills "
                        f"{prefills}, ticks {ticks})")
    # the four text requests' rows, held against the plain path and the
    # one-shot loop on the server's weights
    generated = []
    for ids in prompt_ids:
        # the longest: the CLI's rows of the first two prompts are shorter
        rows = [r for r in rec.rows if r[:len(ids)] == ids
                and len(r) <= len(ids) + NEW_TOKENS]
        if not rows:
            raise AssertionError(f"no decoded row for a {len(ids)}-token "
                                 f"prompt; problems so far: {problems}")
        generated.append(max(rows, key=len)[len(ids):])
    tf = teacher_force(torch, dataclasses, cfg, params, prompt_ids,
                       generated, vocab=tok.vocab_size)
    one_shot, agree = [], []
    for ids, gen in zip(prompt_ids, generated):
        out = generate_tokens(cfg, params, np.asarray([ids], np.int32),
                              np.asarray([len(ids)]), NEW_TOKENS, top_k=1,
                              vocab_size=tok.vocab_size, eod=tok.eod,
                              want_logprobs=False)
        o = out.tokens[0, len(ids):int(out.lengths[0])].tolist()
        one_shot.append(o)
        same = 0
        while same < min(len(o), len(gen)) and o[same] == gen[same]:
            same += 1
        agree.append(same)
    if max(max(o) for o in one_shot if o) >= tok.vocab_size:
        problems.append("one-shot id past the tokenizer's vocabulary")
    del params
    torch.cuda.empty_cache()

    def delta(name):
        return _metric(after, name) - _metric(before, name)

    line = {"phase": "text_serving", "card": card, "model": "llama2-7B",
            "layers": NUM_LAYERS, "tokenizer": "GPT2BPETokenizer",
            "vocab_size": tok.vocab_size, "merges": voc["merges"],
            "table_rows": cfg.vocab_size, "server_start_s": start_s,
            "requests": [{"prompt_tokens": len(i), "new_tokens": len(g),
                          "wall_s": r and r[2]}
                         for i, g, r in zip(prompt_ids, generated, results)],
            "concurrent_wall_s": conc_s, "cli_wall_s": cli_s,
            "cli_answers": len(answers),
            "ttft_mean_s": (delta("engine_ttft_seconds_sum")
                            / delta("engine_ttft_seconds_count")),
            "per_token_mean_s": (
                delta("engine_time_per_output_token_seconds_sum")
                / delta("engine_time_per_output_token_seconds_count")),
            "decoded_rows": len(rec.rows), "largest_id": top_id,
            "prefills": prefills, "decode_ticks": ticks,
            "launches": launches, "msdp": msdp_run,
            "one_shot_agree_tokens": agree, **tf}
    emit(line)
    if tf["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"teacher-forced match "
                        f"{tf['teacher_forced_match']:.4f} < {MATCH_GATE}")
    if problems:
        raise AssertionError("text serving: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# phase 4's memory fit and the scale proofs (training/aot.py through
# tools/hbm_check, each in a process of its own on the host's CPU)
# ---------------------------------------------------------------------------

#: phase 4's measured max_memory_allocated must lie in this band of the
#: fit report's per-card bytes (stated before the first run on the card)
FIT_BAND = (0.95, 1.05)
#: the proofs' budget: one H100 80 GB
PROOF_BUDGET_GIB = "80"
MEMORY_FIT: dict = {}


def _fit_runs() -> dict:
    return {
        "phase4": ["--model", "llama2", "--size", "7B", "--num_layers",
                   str(TRAIN_LAYERS), "--seq_length", str(TRAIN_SEQ),
                   "--devices", "1", "--micro_batch_size", str(TRAIN_MICRO),
                   "--num_microbatches", str(TRAIN_GLOBAL // TRAIN_MICRO),
                   "--recompute", "selective", "--json"],
        **{name: ["--proof", name, "--budget_gib", PROOF_BUDGET_GIB]
           for name in ("llama2_7b_dp2tp4", "llama2_70b_dp2tp8pp4")}}


def start_memory_fit() -> None:
    """Start every fit in the background (they trace on the CPU under fake
    tensors, so they overlap the card's phases)."""
    for name, args in _fit_runs().items():
        if name not in MEMORY_FIT:
            MEMORY_FIT[name] = (time.monotonic(), subprocess.Popen(
                [sys.executable, "-m", "megatron_tpu_torch.tools.hbm_check",
                 *args], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))


def memory_fit(name: str, timeout_s: float = 600) -> dict:
    """A fit's result: its rc (0 fits, 1 over budget), its last stdout
    line (JSON for phase 4's, the summary for a proof) and its seconds
    from start to collection."""
    start_memory_fit()
    t0, proc = MEMORY_FIT[name]
    out, err = proc.communicate(timeout=timeout_s)
    if proc.returncode not in (0, 1) or not out.strip():
        raise AssertionError(f"hbm_check {name}: rc {proc.returncode}\n"
                             f"{err[-3000:]}")
    last = out.strip().splitlines()[-1]
    return {"rc": proc.returncode, "seconds": time.monotonic() - t0,
            "out": json.loads(last) if last.startswith("{") else last}


# ---------------------------------------------------------------------------
# phase 4: training through the entry point
# ---------------------------------------------------------------------------


def zipf_tokens(np, rng, n):
    """Zipf-distributed ids folded into the vocab: a skewed unigram a
    model learns within a few steps, unlike uniform noise."""
    return (rng.zipf(ZIPF_A, size=n) - 1) % VOCAB


def write_corpus(np, prefix: str) -> int:
    from megatron_tpu_torch.data.indexed_dataset import (
        MMapIndexedDatasetBuilder,
    )

    rng = np.random.default_rng(SEED)
    builder = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    n_tokens = 0
    for _ in range(CORPUS_DOCS):
        n = int(rng.integers(1024, 3073))
        builder.add_item(zipf_tokens(np, rng, n).astype(np.uint16))
        builder.end_document()
        n_tokens += n
    builder.finalize(prefix + ".idx")
    return n_tokens


def first_loss_expected(cfg) -> float:
    """Cross-entropy of the random init: the LM head's weights (std
    init_method_std) over a unit-RMS final hidden state give logits of
    variance sigma^2 = std^2 * h, and E[logsumexp] of V such logits is
    about ln V + sigma^2 / 2 (10.37 + 0.82 for Llama-2-7B), while the
    target's logit averages 0."""
    sigma2 = cfg.init_method_std ** 2 * cfg.hidden_size
    return math.log(cfg.vocab_size) + sigma2 / 2


def expected_train_launches(n_micro: int, layers: int = TRAIN_LAYERS,
                            steps: int = TRAIN_ITERS,
                            eval_batches: int = (TRAIN_ITERS // EVAL_INTERVAL
                                                 * EVAL_ITERS),
                            recomputed: Optional[int] = None) -> dict:
    """Launch counts of a training run. Every layer of every microbatch
    of every step runs one dq and one dk/dv launch in its backward.
    A layer whose attention is recomputed (every layer under selective
    recompute, whose core attention is checkpointed; the first N under
    block:N) runs its forward twice per microbatch (once in the forward
    pass, once recomputed in the backward); each evaluation batch runs
    one more forward per layer."""
    bwd = layers * n_micro * steps
    recomputed = layers if recomputed is None else recomputed
    return {"flash_fwd": bwd + recomputed * n_micro * steps
            + layers * eval_batches,
            "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd, "flash_decode": 0,
            "paged_flash_decode": 0}


TRAIN_COUNTED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_decode", "paged_flash_decode")


def corpus_prefix() -> str:
    build_dir = os.path.join(REPO, "megatron_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    return os.path.join(build_dir, "smoke_corpus")


def train_argv(prefix, layers=TRAIN_LAYERS, seq=TRAIN_SEQ,
               global_batch=TRAIN_GLOBAL, iters=TRAIN_ITERS,
               eval_interval=EVAL_INTERVAL):
    """Phase 4's command line (phase 7 runs it again under
    torch.distributed.run, and cuts it for its two-rank cases)."""
    return ["--model_name", "llama2-7B", "--num_layers", str(layers),
            "--seq_length", str(seq), "--bf16",
            "--micro_batch_size", str(TRAIN_MICRO),
            "--global_batch_size", str(global_batch),
            "--train_iters", str(iters), "--log_interval", "1",
            "--eval_interval", str(eval_interval),
            "--eval_iters", str(EVAL_ITERS), "--lr", TRAIN_LR,
            "--lr_decay_style", "constant", "--clip_grad", "1.0",
            "--recompute_granularity", "selective",
            "--attention_impl", "pallas", "--data_path", prefix,
            "--split", "90,10,0", "--seed", str(SEED), "--device", "cuda"]


# phase 4's losses and step times, which phase 7a must reproduce
PHASE4: dict = {}


def train(torch, np, ft, card):
    from megatron_tpu_torch.models.params import num_params
    from megatron_tpu_torch.tools import pretrain_gpt

    prefix = corpus_prefix()
    corpus_tokens = write_corpus(np, prefix)
    argv = train_argv(prefix)
    log_lines = []
    # the memory fit of this run's step, computed before it runs
    fit = memory_fit("phase4")
    fit_gib = fit["out"]["per_chip_bytes"] / 2**30

    def log(msg):
        log_lines.append(msg)
        print(msg, flush=True)

    torch.cuda.reset_peak_memory_stats()
    # the main path's run: every count starts at 0 here
    for name in TRAIN_COUNTED:
        getattr(ft, name).launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.monotonic()
        loop = pretrain_gpt.main(argv, log=log)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    launches = {n: getattr(ft, n).launches for n in TRAIN_COUNTED}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    cfg = loop.cfg.model
    hist = loop.history
    losses = [h["lm_loss"] for h in hist]
    steps_s = sorted(h["window_s"] for h in hist[1:])   # step 1 warms up
    step_s = steps_s[len(steps_s) // 2] if steps_s else float("nan")
    tokens_per_step = TRAIN_GLOBAL * TRAIN_SEQ
    tokens_per_s = tokens_per_step / step_s
    model_flops_per_token = 3.0 * cfg.flops_per_token_fwd()
    n_micro = TRAIN_GLOBAL // TRAIN_MICRO
    want = expected_train_launches(n_micro)
    fallbacks = [str(w.message) for w in caught
                 if "falling back" in str(w.message)
                 or "flash_bwd disabled" in str(w.message)]
    line = {"phase": "training", "card": card, "model": "llama2-7B",
            "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "seq_length": cfg.seq_length, "params": num_params(cfg),
            "micro_batch": TRAIN_MICRO, "global_batch": TRAIN_GLOBAL,
            "recompute": loop.cfg.training.recompute_granularity,
            "corpus_tokens": corpus_tokens, "wall_s": wall_s,
            "lr": float(TRAIN_LR), "losses": losses,
            "first_loss_expected": first_loss_expected(cfg),
            "evals": [e["lm_loss"] for e in loop.evals],
            "skipped": [h["skipped"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_times_s": [h["window_s"] for h in hist],
            "step_s_median": step_s, "tokens_per_s": tokens_per_s,
            "model_tflops_per_s": tokens_per_s * model_flops_per_token / 1e12,
            "mfu": tokens_per_s * model_flops_per_token / PEAK_BF16_FLOPS,
            "max_memory_allocated_gib": peak_gib,
            "fit_report_gib": fit_gib,
            "fit_band_gib": [FIT_BAND[0] * fit_gib, FIT_BAND[1] * fit_gib],
            "fit_report": {k: fit["out"][k] for k in (
                "param_bytes", "grad_bytes", "master_bytes", "moment_bytes",
                "batch_bytes", "peak_bytes", "temp_peak_bytes",
                "workspace_bytes", "budget_bytes", "trace_seconds")},
            "fit_process_s": fit["seconds"],
            "launches": launches, "expected_launches": want}
    emit(line)
    PHASE4.update(argv=argv, losses=[r["loss"] for r in loop.step_records],
                  step_s=[r["step_s"] for r in loop.step_records],
                  step_s_median=step_s, launches=launches)
    del loop
    first, last = (losses[0], losses[-1]) if losses else (math.nan,) * 2
    problems = []
    if len(losses) != TRAIN_ITERS or not all(map(math.isfinite, losses)):
        problems.append(f"losses {losses}")
    if any(h["skipped"] for h in hist):
        problems.append("a step was skipped")
    if not abs(first - first_loss_expected(cfg)) <= FIRST_LOSS_WINDOW:
        problems.append(f"first loss {first} not within "
                        f"{FIRST_LOSS_WINDOW} of {first_loss_expected(cfg)}")
    if not first - last >= LOSS_DROP_GATE:
        problems.append(f"loss fell by {first - last}, gate "
                        f"{LOSS_DROP_GATE}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if fallbacks:
        problems.append(f"dense fallback fired: {fallbacks}")
    if len(line["evals"]) != TRAIN_ITERS // EVAL_INTERVAL:
        problems.append(f"evaluations {line['evals']}")
    lo, hi = line["fit_band_gib"]
    if not lo <= peak_gib <= hi:
        problems.append(f"max_memory_allocated {peak_gib:.2f} GiB outside "
                        f"the fit report's band [{lo:.2f}, {hi:.2f}]")
    if problems:
        raise AssertionError("training: " + "; ".join(problems))
    return launches


def memory_proofs(card) -> dict:
    """hbm_check --proof llama2_7b_dp2tp4 and llama2_70b_dp2tp8pp4
    against 80 GiB (started with phase 3f; collected after phase 4c, by
    when their traces are done): each must fit."""
    proofs = {name: memory_fit(name) for name in
              ("llama2_7b_dp2tp4", "llama2_70b_dp2tp8pp4")}
    for name, proof in proofs.items():
        print(f"hbm_check --proof {name}: {proof['out']}", flush=True)
    emit({"phase": "hbm_proofs", "card": card,
          "proofs": {n: {"fits": p["rc"] == 0, "summary": p["out"],
                         "process_s": p["seconds"]}
                     for n, p in proofs.items()}})
    over = [f"{n}: {p['out']}" for n, p in proofs.items() if p["rc"] != 0]
    if over:
        raise AssertionError("over 80 GiB: " + "; ".join(over))
    return proofs


def step_vs_dense(torch, np, ft, card, model="llama2-7B", seq=TRAIN_SEQ,
                  ce_chunk=0):
    """One forward + backward of the same 2-layer model on the same batch
    through the kernels (attention_impl="pallas") and through the dense
    attention with autograd ("xla"). ce_chunk: the kernel run's chunked
    cross-entropy (the dense run keeps the unchunked one)."""
    import dataclasses

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.language_model import lm_loss
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.training.optimizer import (
        global_grad_norm, leaf_paths,
    )

    cfg = dataclasses.replace(presets.from_model_name(model), num_layers=2,
                              seq_length=seq)
    params = init_params(cfg, SEED, device="cuda")
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(SEED + 4)
    text = torch.from_numpy(zipf_tokens(np, rng, seq + 1)
                            .astype(np.int64)[None]).cuda()
    batch = {"tokens": text[:, :-1], "labels": text[:, 1:]}
    runs = {}
    for impl in ("pallas", "xla"):
        before = {n: getattr(ft, n).launches
                  for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        loss, _ = lm_loss(dataclasses.replace(
            cfg, attention_impl=impl,
            ce_chunk_size=ce_chunk if impl == "pallas" else 0),
            params, batch, recompute="selective")
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in leaf_paths(params)}
        for _, p in leaf_paths(params):
            p.grad = None
        ran = {n: getattr(ft, n).launches - before[n] for n in before}
        runs[impl] = (float(loss.detach()), grads,
                      float(global_grad_norm(grads)), ran)
    (lk, gk, nk, ran_k), (ld, gd, nd, ran_d) = runs["pallas"], runs["xla"]
    leaf_err = {n: float((gk[n].float() - gd[n].float()).abs().max())
                / max(float(gd[n].float().abs().max()), 1e-30) for n in gd}
    line = {"phase": "kernel_vs_dense_step", "card": card,
            "model": model, "layers": 2, "seq_length": seq,
            "kernel_ce_chunk_size": ce_chunk,
            "loss_kernels": lk, "loss_dense": ld, "loss_abs_diff": abs(lk - ld),
            "grad_norm_kernels": nk, "grad_norm_dense": nd,
            "grad_norm_rel_diff": abs(nk - nd) / nd,
            "leaf_rel_err": leaf_err,
            "worst_leaf_rel_err": max(leaf_err.values()),
            "kernel_launches": ran_k, "dense_launches": ran_d,
            "gates": {"loss_atol": STEP_LOSS_ATOL,
                      "grad_norm_rtol": STEP_NORM_RTOL,
                      "leaf_rel": STEP_LEAF_TOL}}
    emit(line)
    problems = []
    if not abs(lk - ld) <= STEP_LOSS_ATOL:
        problems.append(f"loss {lk} vs {ld}")
    if not abs(nk - nd) <= STEP_NORM_RTOL * nd:
        problems.append(f"grad norm {nk} vs {nd}")
    bad = {n: e for n, e in leaf_err.items() if not e <= STEP_LEAF_TOL}
    if bad:
        problems.append(f"gradient leaves {bad}")
    if min(ran_k.values()) < 2 or any(ran_d.values()):
        problems.append(f"kernel run launched {ran_k}, dense run {ran_d}")
    if problems:
        raise AssertionError(f"kernel step vs dense step ({model}): "
                             + "; ".join(problems))
    return line


def _fp8_products(torch, card) -> list:
    """Phase 4c(a): the product check; returns its problems."""
    from megatron_tpu_torch.ops.fp8 import fp8_matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    M = TRAIN_MICRO * TRAIN_SEQ
    problems = []
    for site, (K, N) in FP8_PRODUCTS.items():
        x = torch.randn(1, M, K, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = (torch.randn(K, N, generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16)
        g = torch.randn(1, M, N, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for fmt in ("hybrid", "e4m3"):
            res = {}
            for plain in (False, True):
                xs = x.clone().requires_grad_(True)
                ws = w.clone().requires_grad_(True)
                out = fp8_matmul(xs, ws, fmt=fmt, plain=plain)
                out.backward(g)
                res[plain] = (out.detach(), xs.grad, ws.grad)
            errs = {}
            for name, a, b in zip(("out", "dx", "dw"), res[False],
                                  res[True]):
                m = float(b.float().abs().max())
                errs[name] = (float((a.float() - b.float()).abs().max())
                              / max(m, 1e-30))
            del res
            ms = cuda_ms(torch, lambda: fp8_matmul(x, w, fmt=fmt))
            bf16_ms = cuda_ms(torch, lambda: torch.matmul(x, w))
            line = {"phase": "fp8_product", "card": card, "site": site,
                    "shape": f"[{M}, {K}] @ [{K}, {N}]", "format": fmt,
                    "rel_err": errs, "tol": FP8_TOL,
                    "fwd_ms": ms, "bf16_matmul_ms": bf16_ms,
                    "fwd_tflops": 2.0 * M * K * N / ms / 1e9}
            emit(line)
            bad = {n: e for n, e in errs.items() if not e <= FP8_TOL}
            if bad:
                problems.append(f"{site} {fmt}: {bad}")
        del x, w, g
        free_cuda(torch)
    return problems


def _fp8_step_ms(torch, np) -> dict:
    """One forward + backward of the width x FP8_LAYERS on one S
    TRAIN_SEQ row, synchronized, per format (bf16, hybrid, e4m3) on the
    same weights and batch: the median of FP8_TIMED runs after one
    warm-up, in ms."""
    import dataclasses

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.language_model import lm_loss
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.training.optimizer import leaf_paths

    cfg = dataclasses.replace(presets.from_model_name("llama2-7B"),
                              num_layers=FP8_LAYERS, seq_length=TRAIN_SEQ,
                              attention_impl="pallas")
    params = init_params(cfg, SEED, device="cuda")
    for _, p in leaf_paths(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(SEED + 5)
    text = torch.from_numpy(zipf_tokens(np, rng, TRAIN_SEQ + 1)
                            .astype(np.int64)[None]).cuda()
    batch = {"tokens": text[:, :-1], "labels": text[:, 1:]}
    out = {}
    for name in FP8_RUNS:
        c = dataclasses.replace(cfg, fp8_format=None if name == "bf16"
                                else name)
        times = []
        for i in range(FP8_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            loss, _ = lm_loss(c, params, batch, recompute="selective")
            loss.backward()
            torch.cuda.synchronize()
            if i:
                times.append((time.monotonic() - t0) * 1e3)
            for _, p in leaf_paths(params):
                p.grad = None
        out[name] = sorted(times)[len(times) // 2]
    del params
    free_cuda(torch)
    return out


def fp8_training(torch, np, ft, card):
    """Phase 4c. Returns its runs' kernel launches (the fp8 path)."""
    from megatron_tpu_torch.tools import pretrain_gpt

    problems = _fp8_products(torch, card)
    prefix = corpus_prefix()
    if not os.path.exists(prefix + ".idx"):
        write_corpus(np, prefix)
    base = train_argv(prefix, layers=FP8_LAYERS, iters=FP8_STEPS,
                      eval_interval=FP8_STEPS + 1)
    total, runs = {}, {}
    for name, flags in FP8_RUNS.items():
        for n in TRAIN_COUNTED:
            getattr(ft, n).launches = 0
        t0 = time.monotonic()
        loop = pretrain_gpt.main(base + flags, log=lambda m: None)
        torch.cuda.synchronize()
        launches = {n: getattr(ft, n).launches for n in TRAIN_COUNTED}
        want = expected_train_launches(
            TRAIN_GLOBAL // TRAIN_MICRO, layers=FP8_LAYERS, steps=FP8_STEPS,
            eval_batches=len(loop.evals) * EVAL_ITERS)
        if launches != want:
            problems.append(f"{name} launches {launches} != {want}")
        _add_counts(total, launches)
        runs[name] = {"fp8_format": loop.cfg.model.fp8_format,
                      "losses": [r["loss"] for r in loop.step_records],
                      "window_s": [h["window_s"] for h in loop.history],
                      "launches": launches,
                      "wall_s": time.monotonic() - t0}
        del loop
        free_cuda(torch)
    bf = runs["bf16"]["losses"]
    for name in ("hybrid", "e4m3"):
        got = runs[name]["losses"]
        runs[name]["rel_to_bf16"] = [abs(a - b) / b for a, b in zip(got, bf)]
        if runs[name]["fp8_format"] != name:
            problems.append(f"{name}: ran fp8_format "
                            f"{runs[name]['fp8_format']}")
        if len(got) != FP8_STEPS or not all(map(math.isfinite, got)):
            problems.append(f"{name}: losses {got}")
        elif not got[-1] < got[0]:
            problems.append(f"{name}: the loss did not fall: {got}")
        if not max(runs[name]["rel_to_bf16"], default=math.inf) \
                <= FP8_LOSS_RTOL:
            problems.append(f"{name}: {got} vs bf16 {bf}")
    step_ms = _fp8_step_ms(torch, np)
    emit({"phase": "fp8_training", "card": card, "model": "llama2-7B",
          "layers": FP8_LAYERS, "seq_length": TRAIN_SEQ,
          "global_batch": TRAIN_GLOBAL, "steps": FP8_STEPS,
          "loss_rtol": FP8_LOSS_RTOL, "runs": runs,
          "fwd_bwd_ms_one_row": step_ms,
          "fwd_bwd_ratio_to_bf16": {k: v / step_ms["bf16"]
                                    for k, v in step_ms.items()}})
    if problems:
        raise AssertionError("fp8: " + "; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# phase 5: the finetuning path
# ---------------------------------------------------------------------------

# 0.464 B parameters, a 6.5 GB train state; cut from 2 layers (0.667 B,
# 9.3 GB) to keep the script inside its time limit with phases 3e and 5c
FT_LAYERS = 1
FT_STEPS = 4                  # run A; B stops at FT_STEPS // 2, C resumes
FT_CHATS = 16                 # 300 .. 6000 tokens: padded and truncated
FT_MIN_FREE_GB = 40
FT_PROMPT_LENS = (100, 700)
FT_NEW_TOKENS = 16


def hf_llama_dir(torch, out_dir) -> dict:
    """An HF Llama directory at Llama-2-7B width cut to FT_LAYERS layers:
    config.json and pytorch_model.bin, bf16 weights drawn on the card
    from a seeded torch.Generator (normal(0, 0.02), the output-facing
    projections scaled by 1/sqrt(2 L), the norm scales 1 + normal(0,
    0.02)). Returns the state dict, on the CPU."""
    h, f, L = 4096, 11008, FT_LAYERS
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape, std=0.02, mean=0.0):
        t = torch.empty(shape, device="cuda").normal_(mean, std,
                                                      generator=gen)
        return t.to(torch.bfloat16).cpu()

    out_std = 0.02 / math.sqrt(2 * L)
    sd = {"model.embed_tokens.weight": normal(VOCAB, h)}
    for i in range(L):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = normal(h, mean=1.0)
        sd[pre + "post_attention_layernorm.weight"] = normal(h, mean=1.0)
        for n in ("q", "k", "v"):
            sd[pre + f"self_attn.{n}_proj.weight"] = normal(h, h)
        sd[pre + "self_attn.o_proj.weight"] = normal(h, h, std=out_std)
        sd[pre + "mlp.gate_proj.weight"] = normal(f, h)
        sd[pre + "mlp.up_proj.weight"] = normal(f, h)
        sd[pre + "mlp.down_proj.weight"] = normal(h, f, std=out_std)
    sd["model.norm.weight"] = normal(h, mean=1.0)
    sd["lm_head.weight"] = normal(VOCAB, h)
    config = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
              "vocab_size": VOCAB, "hidden_size": h,
              "intermediate_size": f, "num_hidden_layers": L,
              "num_attention_heads": 32, "num_key_value_heads": 32,
              "max_position_embeddings": TRAIN_SEQ, "rms_norm_eps": 1e-5,
              "rope_theta": 10000.0, "tie_word_embeddings": False,
              "hidden_act": "silu", "torch_dtype": "bfloat16"}
    os.makedirs(out_dir)
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2)
    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))
    return sd


def write_chats(np, path) -> list:
    """FT_CHATS conversations of Zipf token ids (as text for the null
    tokenizer), 300 to 6000 tokens each in a seeded order, each a system
    turn, then prompter and assistant twice. Returns their lengths."""
    rng = np.random.default_rng(SEED + 5)
    lengths = rng.permutation(np.linspace(300, 6000, FT_CHATS).astype(int))
    roles = ("system", "prompter", "assistant", "prompter", "assistant")
    with open(path, "w") as fh:
        for n in lengths:
            cuts = np.sort(rng.choice(np.arange(1, n), size=len(roles) - 1,
                                      replace=False))
            parts = np.split(zipf_tokens(np, rng, int(n)), cuts)
            fh.write(json.dumps({"conversation": [
                {"role": r, "text": " ".join(map(str, p.tolist()))}
                for r, p in zip(roles, parts)]}) + "\n")
    return lengths.tolist()


def _state_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(os.path.join(path, "state"))
               for f in fs)


def _first_difference(torch, a, b):
    """The first TrainState tensor where two states differ, or None."""
    from megatron_tpu_torch.training.optimizer import leaf_paths

    for field in ("params", "master", "mu", "nu"):
        for (name, x), (_, y) in zip(leaf_paths(getattr(a, field)),
                                     leaf_paths(getattr(b, field))):
            if not torch.equal(x, y):
                return f"{field}/{name}"
    if not torch.equal(a.step, b.step):
        return "step"
    return None


def _same_state_dict(torch, a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def finetune(torch, np, ft, card):
    """Phase 5 in a temporary directory, removed at the end whatever
    happens; fails at once when the disk cannot hold the checkpoints."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke_finetune_")
    try:
        df = subprocess.run(["df", "-B1", tmp], capture_output=True,
                            text=True, timeout=60)
        free_gb = shutil.disk_usage(tmp).free / 1e9
        emit({"phase": "finetune_disk", "card": card, "dir": tmp,
              "df": df.stdout.strip().splitlines(), "free_gb": free_gb})
        if free_gb < FT_MIN_FREE_GB:
            raise AssertionError(
                f"finetune: {tmp} has {free_gb:.1f} GB free, the phase "
                f"needs {FT_MIN_FREE_GB} GB (up to three 6.5 GB "
                "checkpoints at once, with room)")
        return _finetune(torch, np, ft, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _finetune(torch, np, ft, card, tmp):
    import dataclasses
    import shutil

    from megatron_tpu_torch.data.instruction_dataset import (
        InstructionDataset,
    )
    from megatron_tpu_torch.data.samplers import PretrainingRandomSampler
    from megatron_tpu_torch.tools import (
        hf_to_native, native_to_hf, preprocess_instruct_data,
    )
    from megatron_tpu_torch.tools import finetune as finetune_tool
    from megatron_tpu_torch.training import checkpointing

    d = {n: os.path.join(tmp, n) for n in (
        "hf", "conv", "hf_rt0", "chats", "B", "C", "hf_C", "conv2",
        "hf_C2")}
    problems, line = [], {"phase": "finetune", "card": card,
                          "model": "llama2-7B", "layers": FT_LAYERS,
                          "reduced": f"depth 32 -> {FT_LAYERS} layer(s), "
                                     "cut from 2 for time",
                          "seq_length": TRAIN_SEQ}

    # 1-2: an HF directory -> iteration 0, and straight back out
    t0 = time.monotonic()
    sd = hf_llama_dir(torch, d["hf"])
    line["hf_write_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    hf_to_native.main(["--model", d["hf"], "--output", d["conv"]])
    torch.cuda.synchronize()
    line["convert_s"] = time.monotonic() - t0
    conv_it = checkpointing.checkpoint_dir(d["conv"], 0)
    line["conv_bytes"] = _state_bytes(conv_it)
    t0 = time.monotonic()
    ok, detail = checkpointing.verify_checkpoint(conv_it, deep=True)
    line["crc32_verify_s"] = time.monotonic() - t0
    if not ok:
        problems.append(f"converted checkpoint fails verification: {detail}")
    native_to_hf.main(["--load", d["conv"], "--output", d["hf_rt0"]])
    rt0 = torch.load(os.path.join(d["hf_rt0"], "pytorch_model.bin"),
                     weights_only=True)
    line["export_iter0_bitwise"] = _same_state_dict(torch, rt0, sd)
    if not line["export_iter0_bitwise"]:
        problems.append("native_to_hf of iteration 0 != the HF input")
    del rt0, sd
    shutil.rmtree(d["hf_rt0"])

    # 3: chats -> the -text / -role datasets
    chats = d["chats"] + ".jsonl"
    line["chat_tokens"] = write_chats(np, chats)
    preprocess_instruct_data.main([
        "--input", chats, "--output_prefix", d["chats"], "--tokenizer_type",
        "null", "--vocab_size", str(VOCAB)])
    ds = InstructionDataset(d["chats"], seed=SEED)
    sampler = iter(PretrainingRandomSampler(len(ds), 0, TRAIN_GLOBAL, 0, 1,
                                            seed=SEED))
    seen = [len(ds[i]["text"]) for _ in range(FT_STEPS)
            for i in next(sampler)]
    line["trained_sample_tokens"] = seen
    if not (min(seen) <= TRAIN_SEQ < max(seen)):
        problems.append(f"samples {seen} do not both pad and truncate")

    # 4: A (4 steps), B (2 steps + save), C (resume B to 4 + save)
    common = ["--model_name", "llama2-7B", "--num_layers", str(FT_LAYERS),
              "--seq_length", str(TRAIN_SEQ), "--bf16",
              "--attention_impl", "pallas", "--micro_batch_size",
              str(TRAIN_MICRO), "--global_batch_size", str(TRAIN_GLOBAL),
              "--lr", TRAIN_LR, "--lr_decay_style", "constant",
              "--recompute_granularity", "selective",
              "--scalar_loss_mask", "0.1", "--data_path", d["chats"],
              "--log_interval", "1", "--seed", str(SEED),
              "--device", "cuda"]
    half = FT_STEPS // 2
    runs = {"A": (["--load", d["conv"], "--finetune", "--train_iters",
                   str(FT_STEPS)], FT_STEPS),
            "B": (["--load", d["conv"], "--finetune", "--train_iters",
                   str(half), "--save", d["B"], "--save_interval",
                   str(half)], half),
            "C": (["--load", d["B"], "--train_iters", str(FT_STEPS),
                   "--save", d["C"], "--save_interval", str(half)], half)}
    n_micro = TRAIN_GLOBAL // TRAIN_MICRO
    kept, launches, fallbacks = {}, {}, []
    for name, (argv, steps) in runs.items():
        # the main path's runs: every count starts at 0 here
        for k in TRAIN_COUNTED:
            getattr(ft, k).launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.monotonic()
            loop = finetune_tool.main(common + argv)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        fallbacks += [str(w.message) for w in caught
                      if "falling back" in str(w.message)
                      or "flash_bwd disabled" in str(w.message)]
        launches[name] = {k: getattr(ft, k).launches for k in TRAIN_COUNTED}
        want = expected_train_launches(n_micro, FT_LAYERS, steps, 0)
        if launches[name] != want:
            problems.append(f"run {name}: launches {launches[name]} != "
                            f"{want}")
        hist = loop.history
        line[f"run_{name}"] = {
            "wall_s": wall, "load_s": loop.load_s,
            "iterations": [h["iteration"] for h in hist],
            "losses": [h["lm_loss"] for h in hist],
            "skipped": [h["skipped"] for h in hist],
            "step_times_s": [h["window_s"] for h in hist],
            "saves": list(loop.saves), "launches": launches[name],
            "expected_launches_per_step": expected_train_launches(
                n_micro, FT_LAYERS, 1, 0)}
        if (len(hist) != steps or any(h["skipped"] for h in hist)
                or not all(math.isfinite(h["lm_loss"]) for h in hist)):
            problems.append(f"run {name}: {line[f'run_{name}']}")
        # keep the states and losses only: a loop's step function holds a
        # 2.7 GB gradient buffer
        kept[name] = (loop.state, [h["lm_loss"] for h in hist])
        del loop, hist
        if name == "B":
            shutil.rmtree(d["conv"])
        if name == "C":
            shutil.rmtree(d["B"])
        free_cuda(torch)
    steps_s = sorted(line["run_A"]["step_times_s"][1:])
    line["step_s_median"] = steps_s[len(steps_s) // 2]
    (a_state, a_losses), (c_state, c_losses) = kept["A"], kept["C"]
    line["resume_losses_bitwise"] = a_losses[half:] == c_losses
    line["resume_first_difference"] = _first_difference(torch, a_state,
                                                        c_state)
    line["resume_state_bitwise"] = line["resume_first_difference"] is None
    if not line["resume_losses_bitwise"]:
        problems.append(f"resumed losses {c_losses} != A's "
                        f"{a_losses[half:]}")
    if not line["resume_state_bitwise"]:
        problems.append("resumed state differs from A's first at "
                        f"{line['resume_first_difference']}")
    if fallbacks:
        problems.append(f"dense fallback fired: {fallbacks}")
    c_master = c_state.master
    del kept, a_state, c_state
    free_cuda(torch)

    # 5: serve C through the server entry point
    served = serve_checkpoint(torch, np, ft, d["C"], c_master, dataclasses)
    line["serving"] = served
    problems += served.pop("problems")
    del c_master
    free_cuda(torch)

    # 6: native -> HF -> native -> HF of C is an identity
    t0 = time.monotonic()
    # a finetuned checkpoint records no HF model type: name it
    native_to_hf.main(["--load", d["C"], "--output", d["hf_C"],
                       "--model_type", "llama"])
    line["export_s"] = time.monotonic() - t0
    hf_to_native.main(["--model", d["hf_C"], "--output", d["conv2"]])
    native_to_hf.main(["--load", d["conv2"], "--output", d["hf_C2"]])
    a, b = (torch.load(os.path.join(d[k], "pytorch_model.bin"),
                       weights_only=True) for k in ("hf_C", "hf_C2"))
    line["export_round_trip_bitwise"] = _same_state_dict(torch, a, b)
    if not line["export_round_trip_bitwise"]:
        problems.append("HF -> native -> HF of C is not an identity")
    line["hf_bytes"] = os.path.getsize(os.path.join(d["hf_C"],
                                                    "pytorch_model.bin"))
    emit(line)
    if problems:
        raise AssertionError("finetune: " + "; ".join(problems))
    total = {k: sum(launches[r][k] for r in launches) for k in TRAIN_COUNTED}
    return {k: total[k] + served["launches"][k] for k in TRAIN_COUNTED}


def serve_checkpoint(torch, np, ft, load, master, dataclasses) -> dict:
    """run_text_generation_server --load, in a thread: its weights against
    the checkpoint's masters in bf16, FT_PROMPT_LENS greedy requests of
    FT_NEW_TOKENS tokens, the launch counts and phase 3's teacher-forced
    check."""
    from megatron_tpu_torch.tools import run_text_generation_server as rts
    from megatron_tpu_torch.training.optimizer import leaf_paths

    ready, handles, errors = threading.Event(), [], []

    def run():
        try:
            rts.main(["--load", load, "--tokenizer_type", "null", "--host",
                      "127.0.0.1", "--port", "0", "--serve_num_slots", "2",
                      "--serve_max_seq_len", "2048"],
                     ready=ready, service_out=handles)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            ready.set()

    t0 = time.monotonic()
    thread = threading.Thread(target=run, daemon=True, name="ft-server")
    thread.start()
    if not ready.wait(600) or errors:
        raise RuntimeError(f"server did not start: {errors}")
    out, problems = {"ready_s": time.monotonic() - t0}, []
    service, server = handles
    eng = service.engine
    cfg, params = eng.cfg, eng.params
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        mismatched = [n for (n, p), (_, m) in zip(leaf_paths(params),
                                                  leaf_paths(master))
                      if not torch.equal(p, m.to(p.dtype))]
        out["params_equal_masters_bf16"] = not mismatched
        if mismatched:
            problems.append(f"served params differ from C's masters: "
                            f"{mismatched[:3]}")
        rng = np.random.default_rng(SEED + 6)
        prompts = [rng.integers(0, VOCAB - 1, size=n).tolist()
                   for n in FT_PROMPT_LENS]
        _zero_decode_counts(ft)
        prefills0, ticks0 = eng.stats["admitted"], eng.stats["ticks"]
        generated = []
        t1 = time.monotonic()
        for prompt in prompts:
            status, body = _put(base + "/api", {
                "prompts": [" ".join(map(str, prompt))],
                "tokens_to_generate": FT_NEW_TOKENS, "temperature": 0.0})
            toks = [int(t) for t in body["text"][0].split()]
            if status != 200 or toks[:len(prompt)] != prompt or \
                    len(toks) != len(prompt) + FT_NEW_TOKENS:
                raise AssertionError(f"request of {len(prompt)} tokens: "
                                     f"{status} {len(toks)} tokens")
            generated.append(toks[len(prompt):])
        out["requests_wall_s"] = time.monotonic() - t1
        launches = _decode_counts(ft)
        prefills = eng.stats["admitted"] - prefills0
        ticks = eng.stats["ticks"] - ticks0
        out.update(prefills=prefills, decode_ticks=ticks)
        want = {"flash_fwd": FT_LAYERS * prefills,
                "flash_decode": FT_LAYERS * ticks, "paged_flash_decode": 0}
        if launches != want or prefills != len(prompts) or ticks < 1:
            problems.append(f"server launches {launches} != {want}")
    finally:
        server.shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    tf = teacher_force(torch, dataclasses, cfg, params, prompts, generated)
    out.update(tf)
    if tf["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"teacher-forced match "
                        f"{tf['teacher_forced_match']:.4f} < {MATCH_GATE}")
    out["launches"] = {**{k: 0 for k in TRAIN_COUNTED}, **launches}
    out["problems"] = problems
    return out


# ---------------------------------------------------------------------------
# phase 5b: the Falcon and GPT-2 families
# ---------------------------------------------------------------------------

# served at full width and depth, 8 slots; GPT-2's absolute positions stop
# at 1024, so its slots and prompts are shorter (every prompt + NEW_TOKENS
# fits under 1024)
FAMILY_SERVE = {"falcon-7B": dict(max_seq_len=2048, prompts=PROMPT_LENS),
                "gpt2-1.3B": dict(max_seq_len=1024,
                                  prompts=(5, 100, 500, 900)),
                "mixtral-8x7B": dict(max_seq_len=2048, prompts=PROMPT_LENS)}
# trained through pretrain_gpt: Falcon-7B's width cut to 4 layers (1.12 B
# parameters; full depth is a ~110 GB train state) at its S 2048, under
# selective recompute and under block:2 (--recompute_granularity full
# --recompute_method block --recompute_num_layers 2); GPT-2 1.3B at full
# size and its S 1024. Every run evaluates once, after its last step.
FAMILY_TRAIN = {"falcon-7B": dict(layers=4, seq=2048, steps=4),
                "gpt2-1.3B": dict(layers=None, seq=1024, steps=2)}
FAMILY_BLOCK_LAYERS = 2
# the families train at a tenth of phase 4's lr: with tied embeddings,
# Adam's first lr * sign(g) step moves the rows that feed the input and
# the LM head at once, and at 1e-5 Falcon-7B width's loss rose again from
# its second step (11.79, 9.61, 12.27, 10.56) and GPT-2's at its first
# (11.45, 14.07); at 1e-6 both fell at every one of 8 steps (H100 80GB
# HBM3, 700 W)
FAMILY_LR = "1e-6"
# first loss - last loss >= this: each run must fall. At FAMILY_LR the
# card measured falls of 0.23 nats over 4 steps (Falcon-7B width x 4
# layers) and 0.17 over 2 (GPT-2 1.3B), seed 1234
FAMILY_LOSS_DROP_GATE = 0.1


def _metric_delta(before: str, after: str, name: str) -> float:
    return _metric(after, name) - _metric(before, name)


def _family_serve(torch, ft, card, model, cfg, params, paged):
    """The server on one engine (dense or paged) under _greedy_traffic's
    gates, the family's prompts. Further gates: the launches (dense:
    flash_fwd L x prefills and flash_decode L x ticks; paged:
    paged_flash_decode L x ticks, the chunks take the dense attention)
    and no capture beyond the warm-up one. TTFT and TPOT are this
    server's histogram deltas (the metrics registry is shared in a
    process)."""
    import numpy as np

    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.tokenizer import NullTokenizer

    spec = FAMILY_SERVE[model]
    L = cfg.num_layers
    ready, handles = threading.Event(), []
    thread = threading.Thread(
        target=run_server, daemon=True, name="smoke-family-server",
        kwargs=dict(cfg=cfg, params=params,
                    tokenizer=NullTokenizer(cfg.vocab_size),
                    host="127.0.0.1", port=0, engine_slots=8,
                    engine_max_seq_len=spec["max_seq_len"], device="cuda",
                    kv_paging=paged, page_size=PAGE_SIZE,
                    prefill_chunk=PREFILL_CHUNK, ready=ready,
                    service_out=handles))
    thread.start()
    if not ready.wait(300):
        raise RuntimeError("server did not start")
    service, server = handles
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
                   for n in spec["prompts"]]
        eng = service.engine
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics0 = r.read().decode()
        run = _greedy_traffic(ft, base, eng, prompts)
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        capture_s = eng.capture_seconds
    finally:
        server.shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    launches, prefills, ticks = run["launches"], run["prefills"], run["ticks"]
    problems = []
    want = ({"flash_fwd": 0, "flash_decode": 0,
             "paged_flash_decode": L * ticks} if paged else
            {"flash_fwd": L * prefills, "flash_decode": L * ticks,
             "paged_flash_decode": 0})
    if launches != want or ticks < 1 or prefills != len(prompts) + 1:
        problems.append(f"launches {launches} != {want} (prefills "
                        f"{prefills}, ticks {ticks})")
    recompiles = _metric(metrics, "engine_decode_recompiles_total")
    if recompiles != 0 or capture_s is None:
        problems.append(f"{recompiles} captures beyond warm-up, capture "
                        f"{capture_s}")
    del service, server, handles
    free_cuda(torch)
    hist = {}
    for key, name in (("ttft_mean_s", "engine_ttft_seconds"),
                      ("per_token_mean_s",
                       "engine_time_per_output_token_seconds")):
        n = _metric_delta(metrics0, metrics, name + "_count")
        hist[key] = (_metric_delta(metrics0, metrics, name + "_sum") / n
                     if n else "not measured")
    line = {"phase": "family_serving", "card": card, "model": model,
            "engine": "paged" if paged else "dense",
            "layers": L, "slots": 8, "max_seq_len": spec["max_seq_len"],
            "requests": [{"prompt_tokens": len(p), "wall_s": w}
                         for p, w in zip(prompts, run["walls"])],
            "concurrent_wall_s": run["concurrent_wall_s"],
            "tokens_per_s": (len(prompts) * NEW_TOKENS
                             / run["concurrent_wall_s"]), **hist,
            "prefills": prefills, "decode_ticks": ticks,
            "launches": launches, "cuda_graph_capture_s": capture_s,
            "decode_recompiles": recompiles}
    emit(line)
    if problems:
        raise AssertionError(f"{model} serving ({line['engine']}): "
                             + "; ".join(problems))
    return {"prompts": prompts, "generated": run["generated"],
            "launches": launches}


def _family_train(torch, np, ft, card, model, recompute):
    """pretrain_gpt on the phase-4 corpus: FAMILY_TRAIN[model]'s depth,
    sequence and steps, micro-batch 1, global batch 2, FAMILY_LR constant,
    the flash kernels, one evaluation after the last step. recompute is
    the flag list. Gates: finite losses, no skipped step, a fall of at
    least FAMILY_LOSS_DROP_GATE, the exact launches and no fallback.
    Returns (line, launches)."""
    from megatron_tpu_torch.models.params import num_params
    from megatron_tpu_torch.tools import pretrain_gpt

    spec = FAMILY_TRAIN[model]
    prefix = os.path.join(REPO, "megatron_tpu_torch", "build",
                          "smoke_corpus")
    if not os.path.exists(prefix + ".idx"):
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        write_corpus(np, prefix)
    steps = spec["steps"]
    argv = ["--model_name", model, "--seq_length", str(spec["seq"]),
            "--bf16", "--micro_batch_size", str(TRAIN_MICRO),
            "--global_batch_size", str(TRAIN_GLOBAL),
            "--train_iters", str(steps), "--log_interval", "1",
            "--eval_interval", str(steps), "--eval_iters", "1",
            "--lr", FAMILY_LR, "--lr_decay_style", "constant",
            "--clip_grad", "1.0", *recompute, "--attention_impl", "pallas",
            "--data_path", prefix, "--split", "90,10,0",
            "--seed", str(SEED), "--device", "cuda"]
    if spec["layers"]:
        argv += ["--num_layers", str(spec["layers"])]
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: every count starts at 0 here
    for name in TRAIN_COUNTED:
        getattr(ft, name).launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.monotonic()
        loop = pretrain_gpt.main(argv, log=lambda m: print(m, flush=True))
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    launches = {n: getattr(ft, n).launches for n in TRAIN_COUNTED}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg, policy = loop.cfg.model, loop.cfg.training.recompute_granularity
    hist = loop.history
    losses = [h["lm_loss"] for h in hist]
    steps_s = sorted(h["window_s"] for h in hist[1:])   # step 1 warms up
    step_s = steps_s[len(steps_s) // 2] if steps_s else float("nan")
    tokens_per_s = TRAIN_GLOBAL * cfg.seq_length / step_s
    model_flops_per_token = 3.0 * cfg.flops_per_token_fwd()
    recomputed = (FAMILY_BLOCK_LAYERS if policy.startswith("block:")
                  else cfg.num_layers)
    want = expected_train_launches(TRAIN_GLOBAL // TRAIN_MICRO,
                                   cfg.num_layers, steps, 1, recomputed)
    fallbacks = [str(w.message) for w in caught
                 if "falling back" in str(w.message)
                 or "flash_bwd disabled" in str(w.message)]
    line = {"phase": "family_training", "card": card, "model": model,
            "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "seq_length": cfg.seq_length, "params": num_params(cfg),
            "micro_batch": TRAIN_MICRO, "global_batch": TRAIN_GLOBAL,
            "recompute": policy, "wall_s": wall_s, "lr": float(FAMILY_LR),
            "losses": losses, "first_loss_expected": first_loss_expected(cfg),
            "evals": [e["lm_loss"] for e in loop.evals],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_times_s": [h["window_s"] for h in hist],
            "step_s_median": step_s, "tokens_per_s": tokens_per_s,
            "mfu": tokens_per_s * model_flops_per_token / PEAK_BF16_FLOPS,
            "max_memory_allocated_gib": peak_gib,
            "launches": launches, "expected_launches": want}
    emit(line)
    del loop
    problems = []
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        problems.append(f"losses {losses}")
    elif not losses[0] - losses[-1] >= FAMILY_LOSS_DROP_GATE:
        problems.append(f"loss fell by {losses[0] - losses[-1]}, gate "
                        f"{FAMILY_LOSS_DROP_GATE}")
    if any(h["skipped"] for h in hist):
        problems.append("a step was skipped")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if fallbacks:
        problems.append(f"dense fallback fired: {fallbacks}")
    if problems:
        raise AssertionError(f"{model} training ({policy}): "
                             + "; ".join(problems))
    return line, launches


def _add_counts(total: dict, counts: dict) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def families(torch, np, ft, card):
    """Phase 5b. Falcon-7B at full width and depth served by the dense
    and the paged engine (the phase-3 prompts; the teacher-forced gate on
    both engines' sequences; each engine's graph tick timed over 8 filled
    slots), trained at 4 layers under selective and block:2 recompute,
    and a kernel step against a dense step at 2 layers (the kernel step
    with the chunked cross-entropy over the tied 65024-row LM head);
    GPT-2 1.3B served by the dense engine and trained at full size. Every
    sub-run sets the launch counts to 0 before it; their sum is the
    families path's launches."""
    import dataclasses

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params, num_params

    total, problems = {}, []
    for model, engines in (("falcon-7B", (False, True)),
                           ("gpt2-1.3B", (False,))):
        cfg = presets.from_model_name(model)
        t0 = time.monotonic()
        params = init_params(cfg, SEED, device="cuda")
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        served = []
        for paged in engines:
            run = _family_serve(torch, ft, card, model, cfg, params, paged)
            _add_counts(total, run["launches"])
            served.append(run)
        tf = teacher_force(torch, dataclasses, cfg, params,
                           [p for r in served for p in r["prompts"]],
                           [g for r in served for g in r["generated"]])
        ticks = [_tick_times(torch, cfg, params, paged, False, card,
                             label=model) for paged in engines]
        emit({"phase": "family_serving_gate", "card": card, "model": model,
              "params": num_params(cfg), "param_init_s": init_s,
              "engines": ["paged" if p else "dense" for p in engines],
              "ticks": ticks, **tf})
        if tf["teacher_forced_match"] < MATCH_GATE:
            problems.append(f"{model}: teacher-forced match "
                            f"{tf['teacher_forced_match']:.4f} < "
                            f"{MATCH_GATE}")
        del params, served
        free_cuda(torch)
        runs = [["--recompute_granularity", "selective"]]
        if model.startswith("falcon"):
            runs.append(["--recompute_granularity", "full",
                         "--recompute_method", "block",
                         "--recompute_num_layers",
                         str(FAMILY_BLOCK_LAYERS)])
        peaks = {}
        for recompute in runs:
            line, launches = _family_train(torch, np, ft, card, model,
                                           recompute)
            _add_counts(total, launches)
            peaks[line["recompute"]] = line["max_memory_allocated_gib"]
        emit({"phase": "family_recompute_peaks", "card": card,
              "model": model, "max_memory_allocated_gib": peaks})
        if model.startswith("falcon"):
            free_cuda(torch)
            step_vs_dense(torch, np, ft, card, model=model,
                          seq=FAMILY_TRAIN[model]["seq"], ce_chunk=512)
        free_cuda(torch)
    if problems:
        raise AssertionError("; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# phase 3e: weight-only int8 / fp8 serving
# ---------------------------------------------------------------------------

WEIGHT_QUANT_MODES = ("int8", "fp8")


def weight_quant_serving(torch, ft, card, dense_tokens):
    """Phase 3e. Llama-2-7B at full size through the server on the dense
    engine (phase 3's setup) with int8 and then fp8 weights
    (ops/weight_quant.py, what --weight_int8 / --weight_fp8 build): the
    phase-3 traffic; launches flash_fwd 32 x prefills and flash_decode
    32 x ticks; no capture beyond the warm-up one; the engine's tokens
    under phase 3's teacher-forced gate against the plain path on the
    same quantized weights (the function it serves), and reported
    against the bf16 model under the same gate (not gated: quantization
    moves logits beyond the bf16 band); the weight bytes resident; and
    the graph tick's device time with bf16, int8 and fp8 weights, all in
    this call."""
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.ops.weight_quant import (
        quantize_params_for_serving, weight_bytes,
    )
    from megatron_tpu_torch.tokenizer import NullTokenizer

    cfg = presets.from_model_name("llama2-7B")
    params = init_params(cfg, SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
               for n in PROMPT_LENS]
    # phase 3d's dense bf16 tick, the same engine and fill, this call
    ticks = {"bf16": CONTROL_TICKS.get("dense_bf16") or _tick_times(
        torch, cfg, params, False, False, card, label="weight_bf16")}
    total, problems, runs = {}, [], {}
    for mode in WEIGHT_QUANT_MODES:
        t0 = time.monotonic()
        q = quantize_params_for_serving(params, mode)
        torch.cuda.synchronize()
        quantize_s = time.monotonic() - t0
        service, server, thread, base = _start_server(
            cfg, q, NullTokenizer(cfg.vocab_size), engine_slots=8,
            engine_max_seq_len=2048)
        try:
            eng = service.engine
            run = _greedy_traffic(ft, base, eng, prompts)
            with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                metrics = r.read().decode()
            capture_s, recompiles = (eng.capture_seconds,
                                     eng.stats["decode_recompiles"])
        finally:
            _stop_server(server, thread)
        del service, server, eng
        free_cuda(torch)
        _add_counts(total, run["launches"])
        want = {"flash_fwd": NUM_LAYERS * run["prefills"],
                "flash_decode": NUM_LAYERS * run["ticks"],
                "paged_flash_decode": 0}
        if run["launches"] != want or recompiles or capture_s is None:
            problems.append(f"{mode}: launches {run['launches']} != {want}"
                            f", recompiles {recompiles}, capture "
                            f"{capture_s}")
        tf = teacher_force(torch, dataclasses, cfg, q, prompts,
                           run["generated"])
        vs_bf16 = teacher_force(torch, dataclasses, cfg, params, prompts,
                                run["generated"])
        ticks[mode] = _tick_times(torch, cfg, q, False, False, card,
                                  label=f"weight_{mode}")
        same = (sum(x == y for a, b in zip(run["generated"], dense_tokens)
                    for x, y in zip(a, b))
                / sum(map(len, run["generated"]))
                if dense_tokens else "not measured")
        runs[mode] = {
            "weight_bytes": weight_bytes(q), "quantize_s": quantize_s,
            "prefills": run["prefills"], "decode_ticks": run["ticks"],
            "launches": run["launches"],
            "concurrent_wall_s": run["concurrent_wall_s"],
            "ttft_mean_s": (_metric(metrics, "engine_ttft_seconds_sum")
                            / _metric(metrics, "engine_ttft_seconds_count")),
            "cuda_graph_capture_s": capture_s,
            "teacher_forced_match": tf["teacher_forced_match"],
            "teacher_forced_strict_argmax":
                tf["teacher_forced_strict_argmax"],
            "vs_bf16_teacher_forced_match": vs_bf16["teacher_forced_match"],
            "vs_bf16_strict_argmax": vs_bf16["teacher_forced_strict_argmax"],
            "tokens_equal_to_phase3_share": same}
        if tf["teacher_forced_match"] < MATCH_GATE:
            problems.append(f"{mode}: teacher-forced match "
                            f"{tf['teacher_forced_match']:.4f} < "
                            f"{MATCH_GATE}")
        del q
        free_cuda(torch)
    emit({"phase": "weight_quant_serving", "card": card,
          "model": "llama2-7B", "layers": NUM_LAYERS,
          "bf16_weight_bytes": weight_bytes(params), "runs": runs,
          "ticks": ticks})
    del params
    free_cuda(torch)
    if problems:
        raise AssertionError("weight quant serving: " + "; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# phase 5c: Mixtral
# ---------------------------------------------------------------------------

# served at Mixtral-8x7B's full width cut to 16 of its 32 layers (23.5 B
# parameters, 47.0 GB in bf16; full depth is 93.4 GB, past one card, and
# weight quantization does not cover the experts), with the capacity
# factor an HF conversion sets (E = 8: no (token, choice) is dropped, so
# prefill groups, decode groups and the teacher-forced pass compute one
# function); trained at 2 layers (3.16 B parameters, ~57 GB of train
# state) at the preset's S 8192 and capacity factor 1.25
MIXTRAL = "mixtral-8x7B"
MIXTRAL_SERVE_LAYERS = 16
MIXTRAL_SERVE_CAPACITY = 8.0
# the fp32 routing check: the same width in fp32 (no kernels: they take
# bf16) at 4 layers, 24.3 GB
MIXTRAL_FP32_LAYERS = 4
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_TRAIN_STEPS = 4
MIXTRAL_REDUCED = [
    f"serving depth 32 -> {MIXTRAL_SERVE_LAYERS} layers (93.4 GB of bf16 "
    "weights at full depth; one card has 80 GB)",
    f"serving capacity factor 1.25 -> {MIXTRAL_SERVE_CAPACITY} (the HF "
    "conversion's: dropless, like HF's Mixtral)",
    f"fp32 routing check at {MIXTRAL_FP32_LAYERS} layers with the dense "
    "attention",
    f"training depth 32 -> {MIXTRAL_TRAIN_LAYERS} layers (S 8192, the "
    f"preset's), {MIXTRAL_TRAIN_STEPS} steps"]
# the engine's fp32 tokens against the fp32 plain path's argmax
MIXTRAL_FP32_GATE = 0.99


def _fp32_logits_streamed(torch, cfg32, params, seq):
    """The plain path in fp32 (weights upcast), one layer's upcast at a
    time: an fp32 copy of a model this size would not fit beside it."""
    from megatron_tpu_torch.models.language_model import (
        _layers, embed_tokens, final_hidden_norm, lm_logits,
    )
    from megatron_tpu_torch.models.transformer import block_forward
    from megatron_tpu_torch.ops.rotary import precompute_rope

    x = embed_tokens(cfg32, params, seq)
    rope = precompute_rope(cfg32.head_dim, seq.shape[1], cfg32.rope_theta,
                           cfg32.rope_scaling_factor, device=seq.device)
    for lp in _layers(params["layers"], cfg32.num_layers):
        x, _, _ = block_forward(cfg32, _upcast(lp), x, rope)
    rest = _upcast({k: v for k, v in params.items() if k != "layers"})
    return lm_logits(cfg32, rest, final_hidden_norm(cfg32, rest, x))


def _moe_phase_times(torch, cfg, card):
    """One MoE layer at the training shape ([1, S, h] bf16, Mixtral's
    widths, random weights): the capacity layer's forward, its expert
    products alone on the same [E, C, h] batches, and the dropless
    layer (grouped products), CUDA events; dispatch + combine is the
    difference of the first two."""
    import dataclasses

    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.ops import moe

    one = dataclasses.replace(cfg, num_layers=1)
    p = {k: v[0] for k, v in init_params(one, SEED)["layers"][
        "moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(1, cfg.seq_length, cfg.hidden_size, device="cuda",
                    dtype=torch.bfloat16, generator=gen)
    Sg = moe._group_for(cfg.seq_length, moe.moe_group_size(cfg))
    C = moe.moe_capacity(cfg, Sg)
    G = cfg.seq_length // Sg
    xe = torch.randn(cfg.num_experts, G * C, cfg.hidden_size, device="cuda",
                     dtype=torch.bfloat16, generator=gen)
    drop = dataclasses.replace(cfg, moe_dispatch="dropless")
    with torch.no_grad():
        layer_ms = cuda_ms(torch, lambda: moe.moe_block(cfg, p, x))
        experts_ms = cuda_ms(torch, lambda: moe._expert_mlp(cfg, p, xe))
        dropless_ms = cuda_ms(torch, lambda: moe.moe_block(drop, p, x))
    rec = {"seq": cfg.seq_length, "groups": G, "capacity": C,
           "expert_rows": cfg.num_experts * G * C,
           "routed_rows": cfg.seq_length * cfg.moe_top_k,
           "capacity_layer_ms": layer_ms, "expert_products_ms": experts_ms,
           "dispatch_combine_ms": layer_ms - experts_ms,
           "dropless_layer_ms": dropless_ms}
    del p, x, xe
    free_cuda(torch)
    return rec


def _dropless_vs_capacity(torch, cfg):
    """A small shape on the card: the dropless layer (torch._grouped_mm)
    against the capacity layer at ample capacity, and its gradients
    against the capacity layer's, |a - b| <= 2e-2 * (M + |b|)."""
    import dataclasses

    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.ops import moe

    small = dataclasses.replace(cfg, num_layers=1, hidden_size=512,
                                ffn_hidden_size=1024,
                                num_attention_heads=4, num_kv_heads=1,
                                moe_capacity_factor=8.0)
    p0 = {k: v[0] for k, v in init_params(small, SEED)["layers"][
        "moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x0 = torch.randn(4, 256, 512, device="cuda", dtype=torch.bfloat16,
                     generator=gen)
    outs = []
    for dispatch in ("capacity", "dropless"):
        c = dataclasses.replace(small, moe_dispatch=dispatch)
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        x = x0.clone().requires_grad_(True)
        y, aux = moe.moe_block(c, p, x)
        (y.float().square().sum() + aux).backward()
        outs.append([y.detach(), x.grad] + [p[k].grad for k in sorted(p)])
    worst = 0.0
    for a, b in zip(outs[1], outs[0]):
        a, b = a.float(), b.float()
        allowed = 2e-2 * (b.abs().max() + b.abs())
        worst = max(worst, float(((a - b).abs() / allowed).max()))
    return {"grouped_mm": moe.grouped_mm_available(x0), "worst_margin": worst}


def _mixtral_fp32_routing(torch, card, base):
    """The engines' MoE path against the plain path where bf16 rounding
    cannot flip a routing decision: Mixtral's width at
    MIXTRAL_FP32_LAYERS layers in fp32 with the dense attention (the
    kernels take bf16 only), eager, on the dense and the paged engine,
    the phase-3 prompts x 32 greedy tokens; each token must be the fp32
    plain path's teacher-forced argmax at >= MIXTRAL_FP32_GATE of the
    positions. In bf16 a random-init MoE's top-k routing is not stable
    under rounding: a 1-ulp change of a router input can swap an expert,
    and with it the layer's output, so phase 3's near-tie band (one
    referee's rounding) does not cover another evaluation order's
    routing; the bf16 rate is reported beside this gate."""
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.inference.engine import InferenceEngine, Request
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    cfg = dataclasses.replace(base, num_layers=MIXTRAL_FP32_LAYERS,
                              moe_capacity_factor=MIXTRAL_SERVE_CAPACITY,
                              params_dtype="float32", attention_impl="xla")
    params = init_params(cfg, SEED, device="cuda")
    prompts = mixtral_prompts(np, cfg)
    agree = total = 0
    misses = []
    for paged in (False, True):
        kw = dict(num_slots=8, max_seq_len=2048, vocab_size=cfg.vocab_size,
                  metrics=MetricsRegistry(), cuda_graph=False)
        eng = (PagedInferenceEngine(cfg, params, page_size=PAGE_SIZE,
                                    prefill_chunk=PREFILL_CHUNK, **kw)
               if paged else InferenceEngine(cfg, params, **kw))
        reqs = [eng.submit(Request(prompt=np.asarray(p, np.int32),
                                   max_new_tokens=NEW_TOKENS))
                for p in prompts]
        eng.run_until_idle()
        del eng
        for i, r in enumerate(reqs):
            if r.error is not None or len(r.generated) != NEW_TOKENS:
                raise AssertionError(f"fp32 request {i}: {r.error}")
        rate = _argmax_rate(torch, cfg, params, prompts,
                            [r.generated for r in reqs])
        agree += rate["agree"]
        total += rate["positions"]
        misses += [dict(m, engine="paged" if paged else "dense")
                   for m in rate["misses"]]
    del params
    free_cuda(torch)
    return {"fp32_layers": MIXTRAL_FP32_LAYERS,
            "fp32_teacher_forced_argmax": agree / total,
            "fp32_positions": total, "fp32_misses": misses}


def _argmax_rate(torch, cfg, params, prompts, generated) -> dict:
    """How many generated tokens are the plain path's teacher-forced
    argmax (lm_forward in cfg's dtype over prompt + tokens): agree,
    positions and the missed (sequence, position)s."""
    from megatron_tpu_torch.models.language_model import lm_forward

    agree = total = 0
    misses = []
    with torch.no_grad():
        for i, (prompt, gen) in enumerate(zip(prompts, generated)):
            seq = torch.tensor([prompt + gen[:-1]], device="cuda")
            want = lm_forward(cfg, params, seq)[0, len(prompt) - 1:]
            hit = want.argmax(-1) == torch.tensor(gen, device="cuda")
            agree += int(hit.sum())
            total += len(gen)
            misses += [{"sequence": i, "position": j}
                       for j in (~hit).nonzero().flatten().tolist()]
    return {"agree": agree, "positions": total, "misses": misses}


def mixtral(torch, np, ft, card):
    """Phase 5c. Mixtral-8x7B's width (h 4096, ffn 14336, 8 experts top-2,
    32/8 heads, rope theta 1e6) cut to MIXTRAL_SERVE_LAYERS layers through
    the HTTP server on the dense and the paged engine, each with the
    captured tick (_family_serve's gates: prompt + 32 tokens, exact
    launches, no capture beyond the warm-up one), phase 3's
    teacher-forced near-tie rate on every sequence (the fp32 referee
    upcast a layer at a time; reported) and the dense graph tick's
    device time; the fp32 routing gate (_mixtral_fp32_routing); then a
    dropless case at a small shape against the capacity layer at ample
    capacity, the capacity layer's dispatch/combine time at the training
    shape, and pretrain_gpt at MIXTRAL_TRAIN_LAYERS layers (finite
    losses, no skipped step, a moe aux loss line, exact launches; step
    time and MFU by the config's own FLOPs)."""
    import dataclasses

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params, num_params

    base = presets.from_model_name(MIXTRAL)
    cfg = dataclasses.replace(base, num_layers=MIXTRAL_SERVE_LAYERS,
                              moe_capacity_factor=MIXTRAL_SERVE_CAPACITY)
    total, problems = {}, []
    t0 = time.monotonic()
    params = init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    served = []
    for paged in (False, True):
        run = _family_serve(torch, ft, card, MIXTRAL, cfg, params, paged)
        _add_counts(total, run["launches"])
        served.append(run)
    tf = teacher_force(torch, dataclasses, cfg, params,
                       [p for r in served for p in r["prompts"]],
                       [g for r in served for g in r["generated"]],
                       stream_fp32=True)
    tick = _tick_times(torch, cfg, params, False, False, card,
                       label=MIXTRAL)
    del params, served
    free_cuda(torch)
    fp32 = _mixtral_fp32_routing(torch, card, base)
    emit({"phase": "mixtral_serving_gate", "card": card, "model": MIXTRAL,
          "layers": cfg.num_layers, "params": num_params(cfg),
          "full_depth_params": num_params(base), "reduced": MIXTRAL_REDUCED,
          "moe_capacity_factor": cfg.moe_capacity_factor,
          "param_init_s": init_s, "ticks": [tick], **tf, **fp32})
    if fp32["fp32_teacher_forced_argmax"] < MIXTRAL_FP32_GATE:
        problems.append(f"fp32 teacher-forced argmax "
                        f"{fp32['fp32_teacher_forced_argmax']:.4f} < "
                        f"{MIXTRAL_FP32_GATE}")

    drop = _dropless_vs_capacity(torch, base)
    times = _moe_phase_times(torch, base, card)
    emit({"phase": "mixtral_moe_layer", "card": card, **times,
          "dropless_vs_capacity": drop})
    if not drop["grouped_mm"] or drop["worst_margin"] > 1.0:
        problems.append(f"dropless vs capacity on the card: {drop}")
    line, launches, log_lines = _mixtral_train(torch, np, ft, card)
    _add_counts(total, launches)
    if not any("moe aux loss:" in m for m in log_lines):
        problems.append("no moe aux loss in the training log")
    if problems:
        raise AssertionError("mixtral: " + "; ".join(problems))
    return total


def _mixtral_train(torch, np, ft, card):
    """pretrain_gpt --model_name mixtral-8x7B at MIXTRAL_TRAIN_LAYERS
    layers on the phase-4 corpus, phase 4's flags (selective recompute,
    lr TRAIN_LR constant, micro-batch 1, global batch 2), one evaluation
    after the last step."""
    from megatron_tpu_torch.models.params import num_params
    from megatron_tpu_torch.tools import pretrain_gpt

    prefix = corpus_prefix()
    if not os.path.exists(prefix + ".idx"):
        write_corpus(np, prefix)
    steps = MIXTRAL_TRAIN_STEPS
    # --seq_length 2048 is the flag's default: the preset's 8192 stands
    argv = train_argv(prefix, layers=MIXTRAL_TRAIN_LAYERS, seq=2048,
                      iters=steps, eval_interval=steps)
    argv[argv.index("llama2-7B")] = MIXTRAL
    log_lines = []

    def log(msg):
        log_lines.append(msg)
        print(msg, flush=True)

    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: every count starts at 0 here
    for name in TRAIN_COUNTED:
        getattr(ft, name).launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.monotonic()
        loop = pretrain_gpt.main(argv, log=log)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    launches = {n: getattr(ft, n).launches for n in TRAIN_COUNTED}
    cfg = loop.cfg.model
    hist = loop.history
    losses = [h["lm_loss"] for h in hist]
    steps_s = sorted(h["window_s"] for h in hist[1:])   # step 1 warms up
    step_s = steps_s[len(steps_s) // 2] if steps_s else float("nan")
    tokens_per_s = TRAIN_GLOBAL * cfg.seq_length / step_s
    flops = 3.0 * cfg.flops_per_token_fwd()
    want = expected_train_launches(TRAIN_GLOBAL // TRAIN_MICRO,
                                   cfg.num_layers, steps, 1)
    line = {"phase": "mixtral_training", "card": card, "model": MIXTRAL,
            "layers": cfg.num_layers, "seq_length": cfg.seq_length,
            "params": num_params(cfg), "reduced": MIXTRAL_REDUCED[2],
            "moe_capacity_factor": cfg.moe_capacity_factor,
            "wall_s": wall_s, "lr": float(TRAIN_LR), "losses": losses,
            "moe_aux_losses": [h.get("moe_aux_loss") for h in hist],
            "first_loss_expected": first_loss_expected(cfg),
            "evals": [e["lm_loss"] for e in loop.evals],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_times_s": [h["window_s"] for h in hist],
            "step_s_median": step_s, "tokens_per_s": tokens_per_s,
            "model_tflops_per_s": tokens_per_s * flops / 1e12,
            "mfu": tokens_per_s * flops / PEAK_BF16_FLOPS,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "expected_launches": want}
    emit(line)
    del loop
    free_cuda(torch)
    problems = []
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        problems.append(f"losses {losses}")
    if any(h["skipped"] for h in hist):
        problems.append("a step was skipped")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    fallbacks = [str(w.message) for w in caught
                 if "falling back" in str(w.message)]
    if fallbacks:
        problems.append(f"dense fallback fired: {fallbacks}")
    if problems:
        raise AssertionError("mixtral training: " + "; ".join(problems))
    return line, launches, log_lines


# ---------------------------------------------------------------------------
# phase 6: the loop and the data

LOOP_MODEL = "gpt2-1.3B"      # the JAX `gpt2` preset's full size
LOOP_SEQ = 1024
LOOP_STEPS = 8
LOOP_DOCS = 20000             # 20..200 Zipf-drawn words each
LOOP_LEXICON = 4000
LOOP_MERGES = 400             # counted from the first LOOP_MERGE_DOCS docs
LOOP_MERGE_DOCS = 2000
LOOP_WORKERS = 4
LOOP_PROFILE = (3, 4)         # the --profile window [start, end)
LOOP_FAULT_LAYERS = 2         # phase 6c: GPT-2 width, depth cut for time
LOOP_FAULT_TIMEOUT_S = 420
LOOP_HANG_TIMEOUT_S = 20      # --step_timeout_s of the hang_step run
LOOP_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


# -- phase 5d: the encoder families -------------------------------------------

ENC_DOCS = 256                # 8..16 sentences of 12..40 ids each
ENC_IDS = (1000, 29000)       # below BERT's 30522 and T5's sentinels
ENC_STEPS = 6                 # each entry point's run
ENC_FIT_STEPS = 10            # the fixed batch's run
ENC_LR = "1e-4"
ENC_BAND = 0.05               # |bf16 first-step loss - the fp32 loss|
ENC_MIN_FREE_GB = 12          # BERT-large's checkpoint is ~4.8 GB
ENC_DEVICE = "cuda"
ENC_TOKEN_IDS = ["--cls_token_id", "101", "--sep_token_id", "102",
                 "--pad_token_id", "0"]
BERT_LARGE = ["--num_layers", "24", "--hidden_size", "1024",
              "--num_attention_heads", "16", "--vocab_size", "30592"]
BERT_BASE = ["--num_layers", "12", "--hidden_size", "768",
             "--num_attention_heads", "12", "--vocab_size", "30592"]
T5_BASE = ["--num_layers", "12", "--hidden_size", "768",
           "--num_attention_heads", "12", "--vocab_size", "32128",
           "--seq_length", "512", "--decoder_seq_length", "128",
           "--vocab_extra_ids", "100"]
# (widths, extra flags, global batch, positions a row holds)
ENC_RUNS = {
    "bert": (BERT_LARGE, ["--seq_length", "512", "--mask_token_id", "103"]
             + ENC_TOKEN_IDS, 8, 512),
    "mnli": (BERT_LARGE, ["--task", "MNLI", "--seq_length", "128",
                          "--tokenizer_type", "null", "--head_lr_mult", "10",
                          "--epochs", "1"] + ENC_TOKEN_IDS, 16, 128),
    "race": (BERT_LARGE, ["--task", "RACE", "--seq_length", "512",
                          "--tokenizer_type", "null", "--head_lr_mult", "10",
                          "--epochs", "1"] + ENC_TOKEN_IDS, 4, 4 * 512),
    "t5": (T5_BASE, ["--bos_token_id", "101", "--eos_token_id", "102",
                     "--pad_token_id", "0"], 16, 512 + 128),
    "ict": (BERT_BASE, ["--seq_length", "256", "--ict_head_size", "128",
                        "--retriever_score_scaling"] + ENC_TOKEN_IDS, 32,
            2 * 256),
}


# phase 7i: the encoder families above one rank, in phase 7's launch
# (gloo, one card), at published widths cut to ENC_PAR_LAYERS layers
# (T5: that many in each stack): BERT-large at S 512, global batch 8 at
# tp2 + SP; T5-base (512 + 128, global batch 16, micro-batch 4) through
# the interleaved pp2 ring; ICT's two BERT-base towers at S 256, global
# batch 32 at dp2 + ZeRO-1. Each runs ENC_PAR_STEPS steps held to the
# one-process run of its entry point at the same global microbatches
# (T5's ring: the whole batch, whose loss weighs every target token
# alike) by phase 7's gates; BERT's tp2 state, saved at its end, loads
# at world size 1 bit for bit (each rank's slice crc32 against the
# world-1 load's)
# phase 5d(e): ORQA on the ICT towers at BERT-base width: the index of
# the corpus's blocks, ORQA_QUESTIONS questions, and ORQA_FIT_STEPS
# finetune_orqa steps on one batch of ORQA_BATCH generated DPR rows
ORQA_QUESTIONS = 64
ORQA_BATCH = 32
ORQA_FIT_STEPS = 3
ORQA_LR = "2e-5"
ENC_PAR_LAYERS = 4


def _layers(widths, n):
    """A widths list with its --num_layers set to n."""
    i = widths.index("--num_layers")
    return widths[:i + 1] + [str(n)] + widths[i + 2:]


ENC_PAR_STEPS = 3
ENC_PAR_LR = "1e-5"
ENC_PAR_CASES = {
    # name: (tool, widths + flags, global batch, the ranks' micro-batch,
    #        the one-process micro-batch, topology flags)
    "bert_tp2_sp": ("pretrain_bert", _layers(BERT_LARGE, ENC_PAR_LAYERS) + [
        "--seq_length", "512", "--mask_token_id", "103"], 8, 8, 8,
        ["--tensor_model_parallel_size", "2", "--sequence_parallel"]),
    "t5_pp2": ("pretrain_t5", _layers(T5_BASE, ENC_PAR_LAYERS) + [
        "--bos_token_id", "101", "--eos_token_id", "102"], 16, 4, 16,
        ["--pipeline_model_parallel_size", "2"]),
    "ict_dp2_zero1": ("pretrain_ict", _layers(BERT_BASE, ENC_PAR_LAYERS) + [
        "--seq_length", "256", "--ict_head_size", "128",
        "--retriever_score_scaling"], 32, 16, 32,
        ["--use_distributed_optimizer"]),
}
ENC_PAR_TOOLS = ("pretrain_bert", "pretrain_t5", "pretrain_ict")


def encoder_corpus(np, prefix: str, titles: str) -> dict:
    """A sentence-level corpus (ENC_DOCS documents, one sequence a
    sentence) and one 4..8-id title a document, ids uniform in ENC_IDS."""
    from megatron_tpu_torch.data.indexed_dataset import make_builder

    rng = np.random.default_rng(SEED)
    sents = make_builder(prefix, vocab_size=32128)
    heads = make_builder(titles, vocab_size=32128)
    n = 0
    for _ in range(ENC_DOCS):
        for _ in range(int(rng.integers(8, 17))):
            ids = rng.integers(*ENC_IDS, int(rng.integers(12, 41)))
            sents.add_item(ids)
            n += len(ids)
        sents.end_document()
        heads.add_item(rng.integers(*ENC_IDS, int(rng.integers(4, 9))))
        heads.end_document()
    sents.finalize(prefix + ".idx")
    heads.finalize(titles + ".idx")
    return {"documents": ENC_DOCS, "tokens": n}


def _ids(np, rng, lo, hi) -> str:
    return " ".join(map(str, rng.integers(*ENC_IDS, int(rng.integers(lo,
                                                                      hi)))))


def encoder_task_files(np, tmp) -> dict:
    """MNLI TSVs (64 train, 16 dev rows; premise col 8, hypothesis col 9,
    label last) and RACE dirs (8 train, 2 dev articles of 300..700 ids,
    two questions each, so a 512 window truncates), ids as text for the
    null tokenizer."""
    import json

    rng = np.random.default_rng(SEED + 5)
    labels = ("contradiction", "entailment", "neutral")
    out = {}
    for split, rows in (("train", 64), ("dev", 16)):
        path = os.path.join(tmp, f"mnli_{split}.tsv")
        with open(path, "w") as f:
            f.write("\t".join(f"c{i}" for i in range(12)) + "\n")
            for _ in range(rows):
                row = [""] * 12
                row[8], row[9] = _ids(np, rng, 20, 60), _ids(np, rng, 10, 40)
                row[11] = labels[int(rng.integers(0, 3))]
                f.write("\t".join(row) + "\n")
        out[f"mnli_{split}"] = path
    for split, docs in (("train", 8), ("dev", 2)):
        d = os.path.join(tmp, f"race_{split}")
        os.makedirs(d)
        with open(os.path.join(d, "docs.txt"), "w") as f:
            for _ in range(docs):
                f.write(json.dumps({
                    "article": _ids(np, rng, 300, 700),
                    "questions": [_ids(np, rng, 5, 12) + " _",
                                  _ids(np, rng, 5, 12)],
                    "options": [[_ids(np, rng, 3, 8) for _ in range(4)]
                                for _ in range(2)],
                    "answers": [chr(65 + int(rng.integers(0, 4)))
                                for _ in range(2)]}) + "\n")
        out[f"race_{split}"] = d
    return out


def _fixed_batch_losses(loop, batch) -> list:
    """`loop` trained to its train_iters on one host batch: its losses."""
    def factory(consumed, gbs):
        while True:
            yield batch

    loop.train(factory)
    loop.writer.close()
    return [h["lm_loss"] for h in loop.history]


def _encoder_family(torch, name, argv, run, ref_loop, first_batch, card):
    """One family: its entry point `run(argv)` (the main path; the loop it
    returns), then `ref_loop()`, a TrainLoop with the entry point's hooks
    at the same init and ENC_FIT_STEPS iterations: the fp32 loss of the
    entry point's first batch (`first_batch()`, a host batch) at that
    init upcast, against the entry point's bf16 first-step loss (gate:
    within ENC_BAND), then ENC_FIT_STEPS steps on that one batch (gate:
    the loss falls). Returns (record, problems)."""
    import dataclasses
    import statistics

    from megatron_tpu_torch.training.optimizer import leaf_paths, tree_map

    widths, _, gbs, positions = ENC_RUNS[name]
    problems = []
    cuda = ENC_DEVICE == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    loop = run(argv)
    if cuda:
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    hist = loop.history
    losses = [h["lm_loss"] for h in hist]
    step_s = statistics.median(h["window_s"] for h in hist[1:])
    rec = {"phase": "encoder_family", "card": card, "family": name,
           "widths": " ".join(widths[1::2]), "global_batch": gbs,
           "positions_per_row": positions,
           "params": sum(p.numel() for _, p in
                         leaf_paths(loop.state.params)),
           "wall_s": wall, "losses": losses, "step_ms": step_s * 1e3,
           "tokens_per_s": gbs * positions / step_s,
           "max_memory_allocated_gib": peak}
    del loop, hist
    free_cuda(torch)
    if len(losses) < 2 or not all(math.isfinite(x) for x in losses):
        problems.append(f"{name}: losses {losses}")

    ref = ref_loop()
    batch = first_batch()
    dev = ref.put_batch(batch)
    cfg32 = dataclasses.replace(ref.cfg.model, params_dtype="float32")
    with torch.no_grad():
        p32 = tree_map(lambda t: t.detach().float(), ref.state.params)
        loss32 = float(ref.loss_fn(cfg32, p32, dev)[0])
        loss16 = float(ref.loss_fn(ref.cfg.model, ref.state.params, dev)[0])
        del p32
    free_cuda(torch)
    fit = _fixed_batch_losses(ref, batch)
    del ref, dev
    free_cuda(torch)
    rec.update({"first_loss_bf16": losses[0] if losses else None,
                "ref_first_loss_bf16": loss16, "loss_fp32": loss32,
                "band": ENC_BAND,
                "bf16_minus_fp32": (losses[0] - loss32 if losses
                                    else None),
                "fixed_batch_losses": fit})
    if not losses or not abs(losses[0] - loss32) <= ENC_BAND:
        problems.append(f"{name}: first-step loss {losses[:1]} vs the "
                        f"fp32 loss {loss32} (band {ENC_BAND})")
    if not (len(fit) == ENC_FIT_STEPS
            and all(math.isfinite(x) for x in fit) and fit[-1] < fit[0]):
        problems.append(f"{name}: the fixed batch's losses {fit} do not "
                        "fall")
    emit(rec)
    return rec, problems


def encoder_families(torch, np, ft, card):
    """Phase 5d in a temporary directory, removed at the end."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke_encoder_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        if free_gb < ENC_MIN_FREE_GB:
            raise AssertionError(f"encoder families: {tmp} has {free_gb:.1f}"
                                 f" GB free, the phase needs "
                                 f"{ENC_MIN_FREE_GB} GB")
        return _encoder_families(torch, np, ft, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _encoder_families(torch, np, ft, card, tmp):
    import dataclasses

    from megatron_tpu_torch.arguments import (
        bert_args, ict_args, parse_args, t5_args, task_args,
    )
    from megatron_tpu_torch.data.samplers import PretrainingSampler
    from megatron_tpu_torch.models.bert import bert_loss
    from megatron_tpu_torch.models.t5 import (
        t5_init_params, t5_loss, t5_param_specs,
    )
    from megatron_tpu_torch.tasks import finetune_utils
    from megatron_tpu_torch.tasks import main as tasks_main
    from megatron_tpu_torch.tools import (
        pretrain_bert, pretrain_ict, pretrain_t5,
    )
    from megatron_tpu_torch.training.checkpointing import load_params_only
    from megatron_tpu_torch.training.optimizer import leaf_paths
    from megatron_tpu_torch.training.pretrain import TrainLoop

    for k in TRAIN_COUNTED:
        getattr(ft, k).launches = 0
    sents, titles = os.path.join(tmp, "sents"), os.path.join(tmp, "titles")
    files = encoder_corpus(np, sents, titles)
    files.update(encoder_task_files(np, tmp))
    ck = os.path.join(tmp, "bert")
    emit({"phase": "encoder_data", "card": card, **files})

    def argv(name, extra=()):
        widths, flags, gbs, _ = ENC_RUNS[name]
        return (widths + flags + [
            "--micro_batch_size", str(gbs), "--global_batch_size", str(gbs),
            "--lr", ENC_LR, "--lr_decay_style", "constant",
            "--log_interval", "1", "--seed", str(SEED), "--device",
            ENC_DEVICE] + list(extra))

    def fit_cfg(cfg):
        return dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, train_iters=ENC_FIT_STEPS, save=None))

    records, problems = {}, []

    def family(name, a, run, ref_loop, first_batch):
        try:
            rec, bad = _encoder_family(torch, name, a, run, ref_loop,
                                       first_batch, card)
            records[name] = rec
            problems.extend(bad)
        except Exception as e:  # noqa: BLE001 - gate every family
            traceback.print_exc()
            problems.append(f"{name}: {type(e).__name__}: {e}")
        free_cuda(torch)

    def pretrain_batch(tool, args, cfg, collate=None):
        ds = tool.train_dataset(args, cfg)
        idx = next(iter(PretrainingSampler(len(ds), 0,
                                           cfg.training.global_batch_size,
                                           0, 1)))
        items = [ds[i] for i in idx]
        if collate is not None:
            return collate(items)
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    # (a) BERT-large with the SOP head, saved for (b)
    a = argv("bert", ["--data_path", sents, "--train_iters", str(ENC_STEPS),
                      "--save", ck, "--save_interval", str(ENC_STEPS)])
    args = parse_args(a, bert_args)
    cfg = pretrain_bert.run_config(args)
    family("bert", a, lambda v: pretrain_bert.main(v, log=lambda m: None),
           lambda: TrainLoop(fit_cfg(cfg), log=lambda m: None,
                             device=ENC_DEVICE, loss_fn=bert_loss),
           lambda: pretrain_batch(pretrain_bert, args, cfg))

    # (b) MNLI at S 128 and RACE at S 512 from (a)'s checkpoint
    for name, tr, dv in (("mnli", "mnli_train", "mnli_dev"),
                         ("race", "race_train", "race_dev")):
        a = argv(name, ["--train_data", files[tr], "--valid_data", files[dv],
                        "--pretrained_checkpoint", ck])
        targs = parse_args(a, task_args)
        tcfg = tasks_main.run_config(targs)
        ncls, train_ds, _ = tasks_main.task_datasets(targs, tcfg.model)

        def ref_loop(tcfg=tcfg, ncls=ncls, name=name):
            loop = finetune_utils.finetune_loop(fit_cfg(tcfg), ncls,
                                                pretrained=ck,
                                                log=lambda m: None,
                                                device=ENC_DEVICE)
            enc = {k: loop.state.params[k] for k in finetune_utils.ENCODER}
            saved = load_params_only(ck, enc)
            masters = {k: loop.state.master[k] for k in enc}
            saved32 = load_params_only(ck, masters)
            same = all(torch.equal(x, y) for (_, x), (_, y) in zip(
                leaf_paths(enc), leaf_paths(saved))) and all(
                torch.equal(x, y) for (_, x), (_, y) in zip(
                    leaf_paths(masters), leaf_paths(saved32)))
            records.setdefault(f"{name}_load", {})["encoder_bitwise"] = same
            records[f"{name}_load"]["leaves"] = len(leaf_paths(enc))
            if not same:
                problems.append(f"{name}: the loaded encoder leaves differ "
                                "from (a)'s checkpoint")
            del saved, saved32
            return loop

        family(name, a, lambda v: tasks_main.main(v, log=lambda m: None),
               ref_loop,
               lambda ds=train_ds, gbs=tcfg.training.global_batch_size,
               seed=tcfg.training.seed:
               next(finetune_utils._epoch_iter(ds, 0, gbs, seed)))

    # (c) T5-base
    a = argv("t5", ["--data_path", sents, "--train_iters", str(ENC_STEPS)])
    args5 = parse_args(a, t5_args)
    cfg5 = pretrain_t5.run_config(args5)
    family("t5", a, lambda v: pretrain_t5.main(v, log=lambda m: None),
           lambda: TrainLoop(fit_cfg(cfg5), log=lambda m: None,
                             device=ENC_DEVICE, init_params_fn=t5_init_params,
                             param_specs_fn=t5_param_specs, loss_fn=t5_loss),
           lambda: pretrain_batch(pretrain_t5, args5, cfg5))

    # (d) ICT at BERT-base width, separate towers, saved for (e)
    ck_ict = os.path.join(tmp, "ict")
    a = argv("ict", ["--data_path", sents, "--titles_data_path", titles,
                     "--train_iters", str(ENC_STEPS), "--save", ck_ict])
    argsi = parse_args(a, ict_args)
    cfgi = pretrain_ict.run_config(argsi)
    family("ict", a, lambda v: pretrain_ict.main(v, log=lambda m: None),
           lambda: TrainLoop(fit_cfg(cfgi), log=lambda m: None,
                             device=ENC_DEVICE, **pretrain_ict.loop_hooks(argsi, cfgi)),
           lambda: pretrain_batch(pretrain_ict, argsi, cfgi,
                                  pretrain_ict.collate))

    # (e) ORQA on (d)'s towers
    try:
        records["orqa"] = _orqa(torch, np, card, tmp, sents, titles, ck_ict)
        problems.extend(records["orqa"].pop("problems"))
    except Exception as e:  # noqa: BLE001 - gate every part
        traceback.print_exc()
        problems.append(f"orqa: {type(e).__name__}: {e}")
    free_cuda(torch)

    counts = {k: getattr(ft, k).launches for k in TRAIN_COUNTED}
    emit({"phase": "encoder_families", "card": card,
          "launches": counts, "loads": {k: v for k, v in records.items()
                                        if k.endswith("_load")},
          "note": "B1-B5 launches over the whole phase: these families "
                  "take the dense attention (padding masks; T5's "
                  "impl='xla'), as in the JAX package"})
    if problems:
        raise AssertionError("encoder families: " + "; ".join(problems))
    return counts


def _orqa(torch, np, card, tmp, sents, titles, ck_ict) -> dict:
    """Phase 5d(e): tools/build_retrieval_index over the corpus's blocks
    with (d)'s context tower, tasks.orqa on ORQA_QUESTIONS questions cut
    from the indexed blocks (each answer two of its block's ids), and
    tasks.main RET-FINETUNE-NQ from (d)'s checkpoint: ORQA_FIT_STEPS
    epochs of one global batch of generated DPR rows, so each step sees
    the same batch (its loss must fall). Returns the record, with its
    problems."""
    import json

    from megatron_tpu_torch.data.indexed_dataset import make_dataset
    from megatron_tpu_torch.tasks import main as tasks_main
    from megatron_tpu_torch.tasks import orqa
    from megatron_tpu_torch.tools import build_retrieval_index

    widths, flags, _, _ = ENC_RUNS["ict"]
    common = widths + ["--seq_length", "256", "--ict_head_size", "128",
                       "--seed", str(SEED), "--device", ENC_DEVICE,
                       "--load", ck_ict] + ENC_TOKEN_IDS
    index = os.path.join(tmp, "index")
    rec = {"phase": "orqa", "card": card}
    cuda = ENC_DEVICE == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.monotonic()
    emb, meta = build_retrieval_index.main(
        common + ["--data_path", sents, "--titles_data_path", titles,
                  "--output", index, "--indexer_batch_size", "64"],
        log=lambda m: None)
    sync()
    rec["index_s"] = time.monotonic() - t0
    rec["blocks"], rec["dim"] = int(emb.shape[0]), int(emb.shape[1])
    blocks = make_dataset(sents)
    rng = np.random.default_rng(SEED + 7)
    pick = rng.choice(len(meta), ORQA_QUESTIONS, replace=False)
    qpath = os.path.join(tmp, "questions.tsv")
    with open(qpath, "w") as f:
        for b in pick:
            first = np.asarray(blocks[int(meta[b][0])], np.int64)
            ans = " ".join(map(str, first[1:3]))
            f.write(" ".join(map(str, first)) + "\t" + ans + "\n")
    t0 = time.monotonic()
    rec["retrieval"] = orqa.main(
        common + ["--data_path", sents, "--index_dir", index,
                  "--questions", qpath, "--tokenizer_type", "null",
                  "--topk", "1", "5", "20"], log=lambda m: None)
    rec["evaluate_s"] = time.monotonic() - t0

    def ctx(ids):
        return {"title": _ids(np, rng, 4, 9), "text": ids}

    rows = []
    for _ in range(ORQA_BATCH):
        q = _ids(np, rng, 8, 20)
        rows.append({"question": q + "?", "answers": [q.split()[0]],
                     "positive_ctxs": [ctx(q + " " + _ids(np, rng, 40, 120))],
                     "hard_negative_ctxs": [], "negative_ctxs": []})
    dpr = os.path.join(tmp, "nq.json")
    with open(dpr, "w") as f:
        json.dump(rows, f)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    loop, stats = tasks_main.main(
        [a for a in common if a != "--load" and a != ck_ict]
        + ["--task", "RET-FINETUNE-NQ", "--train_data", dpr,
           "--valid_data", dpr, "--pretrained_checkpoint", ck_ict,
           "--retriever_seq_length", "256", "--retriever_score_scaling",
           "--tokenizer_type", "null", "--epochs", str(ORQA_FIT_STEPS),
           "--global_batch_size", str(ORQA_BATCH), "--micro_batch_size",
           str(ORQA_BATCH), "--lr", ORQA_LR, "--lr_decay_style", "constant",
           "--log_interval", "1", "--val_av_rank_hard_neg", "0",
           "--val_av_rank_other_neg", "0"], log=lambda m: None)
    sync()
    losses = [h["lm_loss"] for h in loop.history]
    rec.update({"finetune_s": time.monotonic() - t0, "losses": losses,
                "step_ms": [h["window_s"] * 1e3 for h in loop.history],
                "eval": stats,
                "max_memory_allocated_gib":
                    (torch.cuda.max_memory_allocated() / 2**30 if cuda
                     else None)})
    del loop
    problems = []
    hits = rec["retrieval"]
    if not (rec["blocks"] > 0 and rec["dim"] == 128
            and 0.0 <= hits["top1"] <= hits["top5"] <= hits["top20"] <= 1.0):
        problems.append(f"orqa: index {emb.shape}, hits {hits}")
    if not (len(losses) == ORQA_FIT_STEPS
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        problems.append(f"orqa: the fixed batch's losses {losses} do not "
                        "fall")
    emit(rec)
    rec["problems"] = problems
    return rec


def loop_documents(np, n: int = LOOP_DOCS) -> list:
    """The first n of phase 6a's seeded documents: LOOP_LEXICON random
    lowercase words drawn by Zipf, a period every twelfth word."""
    rng = np.random.default_rng(SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lexicon = ["".join(rng.choice(letters, int(rng.integers(2, 11))))
               for _ in range(LOOP_LEXICON)]
    docs = []
    for _ in range(n):
        idx = (rng.zipf(ZIPF_A, int(rng.integers(20, 201))) - 1) \
            % LOOP_LEXICON
        words = [lexicon[i] for i in idx]
        for j in range(11, len(words), 12):
            words[j] += "."
        words[0] = words[0].capitalize()
        docs.append(" ".join(words))
    return docs


def loop_vocab(np, out_dir, docs=None) -> dict:
    """Phase 6a's learner: a GPT-2 byte-level vocabulary (256 byte
    symbols, LOOP_MERGES merges counted over the first LOOP_MERGE_DOCS
    documents, <|endoftext|>) written as vocab.json + merges.txt."""
    from megatron_tpu_torch.tokenizer.gpt2_bpe import train_vocab, write_vocab

    docs = docs if docs is not None else loop_documents(np, LOOP_MERGE_DOCS)
    t0 = time.monotonic()
    vocab, merges = train_vocab(docs[:LOOP_MERGE_DOCS], LOOP_MERGES)
    vocab_s = time.monotonic() - t0
    vf = os.path.join(out_dir, "loop_vocab.json")
    mf = os.path.join(out_dir, "loop_merges.txt")
    write_vocab(vocab, merges, vf, mf)
    return {"vocab_file": vf, "merges_file": mf,
            "eod": vocab["<|endoftext|>"], "vocab_size": len(vocab),
            "merges": len(merges), "vocab_s": vocab_s}


def loop_corpus(np, out_dir) -> dict:
    """Phase 6a: a seeded JSONL corpus of Zipf-drawn words, a GPT-2
    byte-level vocabulary learned from it (loop_vocab), and the corpus
    tokenized by `python -m megatron_tpu_torch.tools.preprocess_data`
    with LOOP_WORKERS workers and --append_eod."""
    import re

    docs = loop_documents(np)
    jsonl = os.path.join(out_dir, "loop_corpus.jsonl")
    with open(jsonl, "w", encoding="utf-8") as f:
        for d in docs:
            f.write(json.dumps({"text": d}) + "\n")
    voc = loop_vocab(np, out_dir, docs)
    vf, mf = voc["vocab_file"], voc["merges_file"]
    prefix = os.path.join(out_dir, "loop_corpus")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "megatron_tpu_torch.tools.preprocess_data",
         "--input", jsonl, "--output_prefix", prefix,
         "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file", vf,
         "--merges_file", mf, "--workers", str(LOOP_WORKERS),
         "--append_eod"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    wall_s = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"preprocess_data failed: {proc.stderr[-3000:]}")
    m = re.search(r"(\d+) documents, (\d+) tokens in ([\d.]+) s "
                  r"\((\d+) docs/s, (\d+) tokens/s\)", proc.stderr)
    if m is None or int(m.group(1)) != LOOP_DOCS:
        raise AssertionError(f"preprocess_data summary: {proc.stderr[-800:]}")
    return {"prefix": prefix, **voc,
            "documents": int(m.group(1)), "tokens": int(m.group(2)),
            "tokenize_s": float(m.group(3)), "docs_per_s": int(m.group(4)),
            "tokens_per_s": int(m.group(5)), "preprocess_wall_s": wall_s}


def loop_native_index(np, prefix) -> dict:
    """The native index builder was built (into megatron_tpu_torch/build)
    and answers build_sample_idx; on this corpus it equals the Python
    version."""
    from megatron_tpu_torch.data import helpers
    from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset

    if helpers.native_helpers() is None:
        raise AssertionError("the native dataset helpers did not build")
    lib = helpers.library_path()
    sizes = MMapIndexedDataset(prefix).sizes
    rng = np.random.default_rng(SEED)
    doc_idx = np.concatenate([rng.permutation(len(sizes))
                              for _ in range(2)])
    tokens = int(sizes.sum())
    t0 = time.monotonic()
    native = helpers.build_sample_idx(sizes, doc_idx, LOOP_SEQ, 2, tokens)
    native_s = time.monotonic() - t0
    t0 = time.monotonic()
    plain = helpers.build_sample_idx(sizes, doc_idx, LOOP_SEQ, 2, tokens,
                                     native=False)
    plain_s = time.monotonic() - t0
    if not np.array_equal(native, plain):
        raise AssertionError("native build_sample_idx != its Python version")
    return {"library": os.path.relpath(str(lib), REPO),
            "samples": int(native.shape[0] - 1), "native_s": native_s,
            "python_s": plain_s, "equal": True}


def _trace_card(path) -> dict:
    """The port's trace reader (telemetry/tracing) on a torch.profiler
    Chrome trace: the card's busy union and idle share of the trace's
    window, the union of the host comm.* ranges (parallel/mappings.py)
    over it with each range's summed ms, and whether the training kernels
    are among its kernels."""
    import dataclasses

    from megatron_tpu_torch.telemetry.tracing import analyze_trace

    report = analyze_trace(path)
    names = {o.name for o in report.ops if o.kind == "compute"}
    return {**dataclasses.asdict(report.card),
            "named": {k: any(k in n for n in names) for k in LOOP_KERNELS}}


def trace_report_cli(path, *args, top: int = 12) -> dict:
    """tools/trace_report on a trace, as a user runs it: its text (the
    card's shares, the busy split, the `top` rows of the self-time
    table) and its JSON (every op)."""
    cmd = [sys.executable, "-m", "megatron_tpu_torch.tools.trace_report",
           path, *args]
    text = subprocess.run(cmd + ["--top", str(top)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    js = subprocess.run(cmd + ["--format", "json", "--top", "100000"],
                        cwd=REPO, capture_output=True, text=True,
                        timeout=300)
    if js.returncode not in (0, 1) or not js.stdout.strip():
        raise AssertionError(f"trace_report rc {js.returncode}: "
                             f"{js.stderr[-2000:]}")
    return {"rc": js.returncode, "text": text.stdout,
            "json": json.loads(js.stdout)}


def _loop_argv(data, steps, extra=()):
    return ["--model_name", LOOP_MODEL, "--seq_length", str(LOOP_SEQ),
            "--bf16", "--micro_batch_size", str(TRAIN_MICRO),
            "--global_batch_size", str(TRAIN_GLOBAL),
            "--train_iters", str(steps), "--log_interval", "1",
            "--eval_interval", str(steps), "--eval_iters", "1",
            "--lr", FAMILY_LR, "--lr_decay_style", "constant",
            "--clip_grad", "1.0", "--recompute_granularity", "selective",
            "--attention_impl", "pallas", "--data_path", data["prefix"],
            "--split", "90,10,0", "--seed", str(SEED),
            "--dataloader_type", "cyclic", "--eod_mask_loss",
            "--eod_token_id", str(data["eod"]), "--num_workers", "2",
            "--device", "cuda", *extra]


def _journal(tele) -> list:
    from megatron_tpu_torch.telemetry.journal import read_events

    return read_events(os.path.join(tele, "events.jsonl"))[0]


def _loop_train(torch, ft, card, data, tmp, sync: bool):
    """Phase 6b's run: LOOP_MODEL at full size through pretrain_gpt with
    every loop flag; --no_async_loop when sync. /metrics is scraped once
    mid-run. Returns (line, losses, launches)."""
    from megatron_tpu_torch.data import helpers
    from megatron_tpu_torch.tools import pretrain_gpt

    tag = "sync" if sync else "async"
    tele = os.path.join(tmp, f"tele_{tag}")
    prof = os.path.join(tmp, f"prof_{tag}")
    extra = ["--metrics", "perplexity", "accuracy", "--timing_log_level",
             "2", "--log_params_norm", "--log_memory_to_tensorboard",
             "--telemetry_dir", tele, "--metrics_port", "0",
             "--flight_recorder", "--profile", "--profile_step_start",
             str(LOOP_PROFILE[0]), "--profile_step_end",
             str(LOOP_PROFILE[1]), "--profile_dir", prof]
    if sync:
        extra.append("--no_async_loop")
    scrape = {}

    def log(msg):
        print(msg, flush=True)
        if msg.startswith("telemetry: /metrics listening on port "):
            scrape["port"] = int(msg.rsplit(" ", 1)[1])
        if (msg.startswith(f"iteration {LOOP_STEPS // 2}/")
                and "port" in scrape):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{scrape['port']}/metrics",
                    timeout=30) as r:
                scrape["text"] = r.read().decode()

    from megatron_tpu_torch.telemetry.metrics import default_registry

    # the process-wide registry outlives one run: read deltas
    counted = ("train_steps_total", "train_host_syncs_total")
    before = {k: default_registry().get(k).value()
              if default_registry().get(k) is not None else 0.0
              for k in counted}
    free_cuda(torch)
    native_before = helpers.calls["build_sample_idx", "native"]
    # the main path's run: every count starts at 0 here
    for name in TRAIN_COUNTED:
        getattr(ft, name).launches = 0
    t0 = time.monotonic()
    loop = pretrain_gpt.main(_loop_argv(data, LOOP_STEPS, extra), log=log)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {n: getattr(ft, n).launches for n in TRAIN_COUNTED}
    cfg = loop.cfg.model
    steady = [r for r in loop.step_records if not r["warmup"]]
    step_s = sorted(r["step_s"] for r in steady)[len(steady) // 2]
    tokens_per_s = TRAIN_GLOBAL * LOOP_SEQ / step_s
    mfu = tokens_per_s * 3.0 * cfg.flops_per_token_fwd() / PEAK_BF16_FLOPS
    final = [e for e in _journal(tele)
             if e["kind"] == "goodput" and e.get("final")][-1]
    shares = {k[:-2]: final[k] / final["wall_s"] for k in final
              if k.endswith("_s") and k != "wall_s"}
    if len(loop.profile_traces) != 1:
        raise AssertionError(f"{tag}: traces {loop.profile_traces}")
    trace = _trace_card(loop.profile_traces[0])
    # tools/trace_report on the same trace: its self-time table names the
    # kernels, and its idle share is the one this phase reports
    cli = trace_report_cli(loop.profile_traces[0])
    print(cli["text"], flush=True)
    cli_report = cli["json"]["report"]
    text = scrape.get("text", "")
    line = {"phase": "loop_training", "card": card, "loop": tag,
            "model": LOOP_MODEL, "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "seq_length": cfg.seq_length,
            "steps": LOOP_STEPS, "wall_s": wall_s,
            "losses": [r["loss"] for r in loop.step_records],
            "step_s": [r["step_s"] for r in loop.step_records],
            "step_s_median": step_s, "tokens_per_s": tokens_per_s,
            "mfu": mfu, "device_idle_share": trace["idle_share"],
            "profile_window_ms": trace["window_ms"],
            "data_wait_ms_per_step": 1e3 * sum(
                r["data_wait_s"] for r in steady) / len(steady),
            "data_waits_ms": [1e3 * r["data_wait_s"] for r in steady],
            # the async pop's attribution (training/prefetch.py last_pop:
            # queue fill before the pop, the pop's wait, the worker's pin
            # + issue and landing of that batch); empty for the sync loop
            "prefetch_pops": [r["prefetch"] for r in steady],
            "goodput": final["goodput"], "goodput_shares": shares,
            "host_sync_points": loop.host_sync_points,
            "evals": loop.evals,
            "params_norm": loop.history[-1].get("params_norm"),
            "memory_mb": loop.history[-1].get("memory"),
            "trace_names": trace["named"],
            "trace_report_idle_share": cli_report["card"]["idle_share"],
            "trace_report_top_ops": cli_report["top_ops"][:12],
            "trace_report_steps": cli_report["steps"],
            "metrics_scraped": {k: _metric(text, k) - before[k]
                                for k in counted} if text else None,
            "native_index_calls": helpers.calls[
                "build_sample_idx", "native"] - native_before,
            "launches": launches}
    emit(line)
    problems = []
    losses = line["losses"]
    if len(losses) != LOOP_STEPS or not all(map(math.isfinite, losses)):
        problems.append(f"losses {losses}")
    elif not losses[0] - losses[-1] >= FAMILY_LOSS_DROP_GATE:
        problems.append(f"loss fell by {losses[0] - losses[-1]}")
    if loop.host_sync_points != LOOP_STEPS:
        problems.append(f"host syncs {loop.host_sync_points}")
    if not all(trace["named"].values()):
        problems.append(f"trace names {trace['named']}")
    ops = [o["name"] for o in cli_report["top_ops"]]
    if not all(any(k in n for n in ops) for k in LOOP_KERNELS):
        problems.append(f"trace_report names none of {LOOP_KERNELS}")
    if cli_report["card"]["idle_share"] != trace["idle_share"]:
        problems.append(f"trace_report idle share "
                        f"{cli_report['card']['idle_share']} != "
                        f"{trace['idle_share']}")
    if not text or line["metrics_scraped"]["train_steps_total"] < 1:
        problems.append(f"/metrics mid-run: {line['metrics_scraped']}")
    if line["native_index_calls"] < 1:
        problems.append("the native index builder was not used")
    ev = loop.evals[-1] if loop.evals else {}
    if not {"perplexity", "accuracy"} <= set(ev):
        problems.append(f"eval metrics {ev}")
    want = expected_train_launches(TRAIN_GLOBAL // TRAIN_MICRO,
                                   cfg.num_layers, LOOP_STEPS, 1)
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    del loop
    free_cuda(torch)
    if problems:
        raise AssertionError(f"loop ({tag}): " + "; ".join(problems))
    return line, losses, launches


def _loop_determinism(torch, ft, card, data, tmp) -> dict:
    """Two runs of one step from one state and batch give bitwise-equal
    states: the replay check on every step of a 2-step run at full size
    (the step's state is copied, the step runs again from the copy, and
    the state and metrics are compared bitwise on the card)."""
    from megatron_tpu_torch.tools import pretrain_gpt

    free_cuda(torch)
    t0 = time.monotonic()
    loop = pretrain_gpt.main(_loop_argv(
        data, 2, ["--replay_check_interval", "1"]),
        log=lambda m: print(m, flush=True))
    line = {"phase": "loop_determinism", "card": card, "model": LOOP_MODEL,
            "replayed_steps": loop.replay_checks, "bitwise_equal":
            loop.replay_checks == [1, 2],
            "wall_s": time.monotonic() - t0,
            "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2**30}
    emit(line)
    del loop
    for name in TRAIN_COUNTED:
        getattr(ft, name).launches = 0
    free_cuda(torch)
    if not line["bitwise_equal"]:
        raise AssertionError(f"determinism: {line}")
    return line


def _child(data, tmp, name, fault, extra, steps=LOOP_STEPS):
    """Start one fault run of pretrain_gpt (LOOP_FAULT_LAYERS layers) in
    its own process; its output goes to a file."""
    save = os.path.join(tmp, f"ck_{name}")
    tele = os.path.join(tmp, f"tele_{name}")
    argv = _loop_argv(data, steps, ["--num_layers", str(LOOP_FAULT_LAYERS),
                                    "--save", save, "--load", save,
                                    "--telemetry_dir", tele,
                                    "--keep_latest_k", "2", *extra])
    env = dict(os.environ)
    env.pop("MEGATRON_TPU_FAULT", None)
    if fault:
        env["MEGATRON_TPU_FAULT"] = fault
    out = open(os.path.join(tmp, f"{name}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "megatron_tpu_torch.tools.pretrain_gpt",
         *argv], cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    return {"name": name, "proc": proc, "out": out, "save": save,
            "tele": tele, "fault": fault}


def _loop_ref(data, extra, steps=LOOP_STEPS, log=None):
    from megatron_tpu_torch.tools import pretrain_gpt

    return pretrain_gpt.main(_loop_argv(
        data, steps, ["--num_layers", str(LOOP_FAULT_LAYERS), *extra]),
        log=log or (lambda m: None))


def _same_state(torch, a, b) -> bool:
    from megatron_tpu_torch.training.optimizer import leaf_paths

    return all(torch.equal(x, y) for f in ("params", "master", "mu", "nu")
               if getattr(a, f) is not None
               for (_, x), (_, y) in zip(leaf_paths(getattr(a, f)),
                                         leaf_paths(getattr(b, f))))


def _loop_faults(torch, card, data, tmp) -> dict:
    """Phase 6c: five fault runs in child processes at once (GPT-2 width,
    LOOP_FAULT_LAYERS layers), held against in-process reference runs."""
    from megatron_tpu_torch.training import checkpointing as ckpt

    children = [
        _child(data, tmp, "nan", "nan_loss:3:3",
               ["--rollback_on_divergence", "--divergence_patience", "3",
                "--save_interval", "2"]),
        _child(data, tmp, "preempt", "preempt_at:5",
               ["--exit_signal_handler", "--save_interval", "100"]),
        _child(data, tmp, "hang", "hang_step:4",
               ["--step_timeout_s", str(LOOP_HANG_TIMEOUT_S)]),
        _child(data, tmp, "corrupt", "corrupt_step:2",
               ["--replay_check_interval", "2"]),
        _child(data, tmp, "auto", None,
               ["--save_interval", "auto", "--preempt_save_timeout",
                "0.001", "--save_interval_floor", "2"]),
    ]
    t0 = time.monotonic()
    # the references meanwhile, in this process: an uninterrupted run and
    # one that skips the nan window's iterations outright
    whole = _loop_ref(data, [])
    skip = _loop_ref(data, ["--skip_iters", "3", "4", "5"])
    rcs = {}
    for c in children:
        try:
            rcs[c["name"]] = c["proc"].wait(
                timeout=max(LOOP_FAULT_TIMEOUT_S - (time.monotonic() - t0),
                            1))
        except subprocess.TimeoutExpired:
            c["proc"].kill()
            rcs[c["name"]] = c["proc"].wait()
        c["out"].close()
    children_s = time.monotonic() - t0
    logs = {}
    for c in children:
        with open(os.path.join(tmp, f"{c['name']}.log")) as f:
            logs[c["name"]] = f.read()
    by = {c["name"]: c for c in children}
    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)

    def losses(name):
        return {e["iteration"]: e["loss"] for e in _journal(by[name]["tele"])
                if e["kind"] == "step"}

    want = {r["iteration"]: r["loss"] for r in whole.step_records}
    skipped = {r["iteration"]: r["loss"] for r in skip.step_records}
    # nan: rolls back to 4, fast-forwards 5, and 6..8 equal the run that
    # skipped 3..5 (both train 6..8 from the state after 2)
    nan = losses("nan") if rcs["nan"] == 0 else {}
    check(rcs["nan"] == 0, f"nan rc {rcs['nan']}")
    check("rolled back to checkpoint at iteration 4" in logs["nan"],
          "nan: no rollback to 4")
    check(all(nan.get(i) == skipped.get(i) for i in (6, 7, 8)),
          f"nan: post-rollback {nan} != skip_iters run {skipped}")
    # preempt: a tagged checkpoint at 5, exit 0; the resume equals the
    # uninterrupted run bitwise
    check(rcs["preempt"] == 0, f"preempt rc {rcs['preempt']}")
    pre = [e for e in _journal(by["preempt"]["tele"])
           if e["kind"] == "preemption"]
    check(ckpt.read_tracker(by["preempt"]["save"]) == 5, "preempt tracker")
    check(ckpt.checkpoint_tags(ckpt.checkpoint_dir(by["preempt"]["save"], 5))
          == ("preemption",), "preempt tag")
    resumed = _loop_ref(data, ["--load", by["preempt"]["save"]])
    pre_losses = losses("preempt")
    check(pre_losses == {i: want[i] for i in range(1, 6)},
          f"preempt: first 5 {pre_losses}")
    check([r["loss"] for r in resumed.step_records]
          == [want[i] for i in range(6, LOOP_STEPS + 1)], "resume losses")
    check(_same_state(torch, resumed.state, whole.state), "resume state")
    # hang: exit 70 with a flight bundle
    bundles = os.path.join(by["hang"]["tele"], "flight_bundles")
    n_bundles = len(os.listdir(bundles)) if os.path.isdir(bundles) else 0
    check(rcs["hang"] == 70 and n_bundles == 1,
          f"hang rc {rcs['hang']}, bundles {n_bundles}")
    # corrupt: the replay check at 2 raises SDCError
    check(rcs["corrupt"] != 0 and "SDCError" in logs["corrupt"]
          and "silent data corruption at iteration 2" in logs["corrupt"],
          f"corrupt rc {rcs['corrupt']}")
    # auto: a cadence taken, checkpoints committed at it
    auto_ev = _journal(by["auto"]["tele"])
    retunes = [e for e in auto_ev if e["kind"] == "cadence_retune"]
    commits = [e["iteration"] for e in auto_ev
               if e["kind"] == "checkpoint_commit"]
    check(rcs["auto"] == 0 and retunes and commits,
          f"auto rc {rcs['auto']}, retunes {retunes}, commits {commits}")
    line = {"phase": "loop_faults", "card": card, "model": LOOP_MODEL,
            "layers": LOOP_FAULT_LAYERS, "rcs": rcs,
            "children_wall_s": children_s,
            "nan_post_rollback": [nan.get(i) for i in (6, 7, 8)],
            "skip_iters_ref": [skipped.get(i) for i in (6, 7, 8)],
            "preempt_notice_to_commit_s":
            pre[0]["notice_to_commit_ms"] / 1e3 if pre else None,
            "preempt_save_s": pre[0]["save_latency_ms"] / 1e3
            if pre else None,
            "hang_bundles": n_bundles,
            "auto_interval": retunes[-1]["to_interval"] if retunes else None,
            "auto_commits": commits, "problems": problems}
    emit(line)
    del whole, skip, resumed
    if problems:
        for name, text in logs.items():
            print(f"--- {name} (rc {rcs[name]}) ---\n{text[-3000:]}",
                  flush=True)
        raise AssertionError("loop faults: " + "; ".join(problems))
    return line


def loop_and_data(torch, np, ft, card):
    """Phase 6 in a temporary directory, removed at the end: (a) the
    data, (b) the full-size loop twice (synchronous, then async: bitwise
    equal losses), the determinism check, (c) the faults. Returns the
    launches of (b), the path's main run."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke_loop_")
    try:
        t0 = time.monotonic()
        data = loop_corpus(np, tmp)
        index = loop_native_index(np, data["prefix"])
        emit({"phase": "loop_data", "card": card,
              **{k: v for k, v in data.items()
                 if k not in ("prefix", "vocab_file", "merges_file")},
              "native_index": index, "wall_s": time.monotonic() - t0})
        total = {}
        lines = {}
        for sync in (True, False):
            line, losses, launches = _loop_train(torch, ft, card, data, tmp,
                                                 sync)
            lines[line["loop"]] = line
            _add_counts(total, launches)
        same = lines["sync"]["losses"] == lines["async"]["losses"]
        emit({"phase": "loop_async_vs_sync", "card": card,
              "losses_bitwise_equal": same,
              "step_s_median": {k: v["step_s_median"]
                                for k, v in lines.items()},
              "device_idle_share": {k: v["device_idle_share"]
                                    for k, v in lines.items()},
              "data_wait_ms_per_step": {k: v["data_wait_ms_per_step"]
                                        for k, v in lines.items()}})
        if not same:
            raise AssertionError("async losses != sync losses")
        _loop_determinism(torch, ft, card, data, tmp)
        _loop_faults(torch, card, data, tmp)
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 7: multi-GPU training through torch.distributed.run
# ---------------------------------------------------------------------------


def rank_run(out: str, runs) -> int:
    """One rank of a phase-7 launch (this script's --rank-run mode,
    started by torch.distributed.run): tools/pretrain_gpt's main with
    each argv of `runs` in turn, in one process group (a process's start
    and first step are paid once); each run's kernel launches, losses,
    grad norms, step times, saves, load, peak memory and traces written
    to `out`.rank<RANK>.json."""
    import torch

    sys.path.insert(0, REPO)
    from megatron_tpu_torch.ops.flash import flash_template as ft
    from megatron_tpu_torch.parallel.distributed import (
        destroy_distributed, initialize_distributed,
    )

    rank = int(os.environ["RANK"])
    cuda = torch.cuda.is_available()
    initialize_distributed(_flag_value(runs[0], "--device", "cuda"),
                           _flag_value(runs[0], "--distributed_backend"))
    records = []
    try:
        for flags in runs:
            records.append(_run_record(torch, ft, flags, rank))
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    finally:
        destroy_distributed()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(records, f)
    return 0


def _flag_value(argv, name: str, default=None):
    """The value after the last `name` in argv, or `default`."""
    argv = list(argv)
    at = [i for i, a in enumerate(argv[:-1]) if a == name]
    return argv[at[-1] + 1] if at else default


def _launch(nproc: int, out: str, runs, timeout_s=PAR_TIMEOUT_S,
            mode="--rank-run") -> list:
    """Each argv of `runs` through pretrain_gpt, in turn, on `nproc`
    ranks of one torch.distributed.run launch; returns, per run, the
    ranks' records. With mode "--rank-serve", runs are rank_serve's and
    the ranks' records come back as a list."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
           "--master_port", str(port), os.path.abspath(__file__),
           mode, out, "--", *runs[0],
           *[a for argv in runs[1:] for a in ("--then", *argv)]]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout_s)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(
            f"torch.distributed.run rc {proc.returncode} after {wall:.1f}s"
            f": {' '.join(runs[-1][-6:])}\n{proc.stdout[-3000:]}\n"
            f"{proc.stderr[-6000:]}")
    records = []
    for r in range(nproc):
        with open(f"{out}.rank{r}.json") as f:
            records.append(json.load(f))
    if mode != "--rank-run":
        for rec in records:
            rec["launch_wall_s"] = wall
        return records
    for rank_runs in records:
        for rec in rank_runs:
            rec["launch_wall_s"] = wall
    return [list(per_run) for per_run in zip(*records)]


def _per_rank_launches(case: str, layers: int, n_micro: int,
                       steps: int = PAR_STEPS, evals: int = 1) -> dict:
    """A rank's launches: `steps` steps of `layers` layers over n_micro
    microbatches under selective recompute, and `evals` validation
    batches (the pipeline's forward-only pass runs its microbatches one
    by one)."""
    pipelined = case.startswith("pp")
    return expected_train_launches(
        n_micro, layers=layers, steps=steps,
        eval_batches=evals * (n_micro if pipelined else 1))


class _ByteCount:
    """A write-only sink that counts what torch.save writes into it."""

    def __init__(self):
        self.n = 0

    def write(self, b) -> int:
        self.n += len(b)
        return len(b)

    def flush(self) -> None:
        pass


def _world1_state_bytes(torch, layout) -> int:
    """The bytes a world-1 save's state files (one torch.save per field
    of one tensor per leaf: training/checkpointing.py) take for the
    leaves of a sharded checkpoint's layout.json, serialized into a
    byte counter (uninitialized tensors: the size depends on the names,
    shapes and dtypes only)."""
    total = 0
    for leaves in layout["fields"].values():
        flat = {name: torch.empty(d["shape"],
                                  dtype=getattr(torch, d["dtype"]))
                for name, d in leaves.items()}
        sink = _ByteCount()
        torch.save(flat, sink)
        total += sink.n
        del flat
    return total


def _sharded_checkpoint(torch, np, ft, card, ckpt, resumed, saver,
                        next_loss: float) -> dict:
    """Phase 7c: PAR_SAVE_CASE's checkpoint: its bytes against a world-1
    save's, each rank's save stall, commit or vote and each resume's load
    seconds and bytes read; the step each case resumed into against the
    one-process reference's step PAR_STEPS + 1 (next_loss: what was
    saved, held independently), the PAR_LOAD_CASES' against each other
    and against the one PAR_SAVE_CASE resumed into; and a world-1 server
    (run_text_generation_server --load, which reads it with
    load_params_only) answering one request. resumed: {case: its resumed
    run's records, one a rank}; saver: PAR_SAVE_CASE's. Returns the
    problems found and the server's launches."""
    from megatron_tpu_torch.tools import run_text_generation_server as rts
    from megatron_tpu_torch.training import checkpointing as ckpts

    problems = []
    it = ckpts.read_tracker(ckpt)
    path = ckpts.checkpoint_dir(ckpt, PAR_STEPS)
    ok, detail = ckpts.verify_checkpoint(path, deep=False)
    with open(os.path.join(path, "state", ckpts.LAYOUT)) as f:
        layout = json.load(f)
    sharded = sum(os.path.getsize(os.path.join(path, "state", n))
                  for n in os.listdir(os.path.join(path, "state"))
                  if n.endswith(".pt"))
    world1 = _world1_state_bytes(torch, layout)
    loss = {c: runs[0]["losses"][0] if runs[0]["losses"] else math.nan
            for c, runs in resumed.items()}
    first, second = PAR_LOAD_CASES
    cross_err = abs(loss[first] - loss[second])
    tp_err = abs(loss[first] - loss[PAR_SAVE_CASE])
    ref_err = {c: abs(v - next_loss) for c, v in loss.items()}
    line = {"phase": "parallel_checkpoint", "card": card,
            "saved_by": PAR_SAVE_CASE, "loaded_by": list(resumed),
            "tracker": it, "verified": ok, "detail": detail,
            "layout_world_size": layout["world_size"],
            "state_bytes": sharded, "world1_state_bytes": world1,
            "bytes_ratio": sharded / world1,
            "saves_per_rank": [r["saves"] for r in saver],
            "load_s_per_rank": {c: [r["load_s"] for r in runs]
                                for c, runs in resumed.items()},
            "load_read_bytes_per_rank": {
                c: [r["load_read_bytes"] for r in runs]
                for c, runs in resumed.items()},
            "resumed_iterations": {c: runs[0]["iterations"]
                                   for c, runs in resumed.items()},
            "resumed_losses": loss,
            "resumed_step_s": {c: runs[0]["step_s"]
                               for c, runs in resumed.items()},
            "cross_topology_loss_err": cross_err,
            "cross_topology_loss_atol": PAR_RESUME_ATOL,
            "against_saving_topology_loss_err": tp_err,
            "against_saving_topology_loss_atol": PAR_LOSS_ATOL,
            "one_process_next_loss": next_loss,
            "against_one_process_loss_err": ref_err,
            "against_one_process_loss_atol": PAR_LOSS_ATOL}
    emit(line)
    if it != PAR_STEPS or not ok:
        problems.append(f"checkpoint: tracker {it}, verify {detail}")
    if not abs(sharded - world1) <= 0.01 * world1:
        problems.append(f"checkpoint bytes {sharded} vs world-1 {world1}")
    for c, runs in resumed.items():
        if runs[0]["iterations"] != [PAR_STEPS + 1] or not all(
                r["losses"] == runs[0]["losses"] for r in runs):
            problems.append(f"{c} resumed: {runs[0]['iterations']}")
    if not cross_err <= PAR_RESUME_ATOL:
        problems.append(f"{first} and {second} resumed {cross_err} apart")
    if not tp_err <= PAR_LOSS_ATOL:
        problems.append(f"{first} and {PAR_SAVE_CASE} resumed {tp_err} "
                        "apart")
    for c, err in ref_err.items():
        if not err <= PAR_LOSS_ATOL:
            problems.append(f"{c} resumed {err} from the one-process "
                            f"step {PAR_STEPS + 1}")

    # a world-1 server of the 2-rank checkpoint: one request
    ready, handles, errors = threading.Event(), [], []

    def run():
        try:
            rts.main(["--load", ckpt, "--tokenizer_type", "null", "--host",
                      "127.0.0.1", "--port", "0", "--serve_num_slots", "1",
                      "--serve_max_seq_len", "256"],
                     ready=ready, service_out=handles)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            ready.set()

    thread = threading.Thread(target=run, daemon=True, name="ckpt-server")
    thread.start()
    if not ready.wait(600) or errors:
        raise RuntimeError(f"world-1 server did not start: {errors}")
    service, server = handles
    eng = service.engine
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(0, VOCAB - 1, size=PROMPT_LENS[1]).tolist()
    try:
        _zero_decode_counts(ft)
        prefills0, ticks0 = eng.stats["admitted"], eng.stats["ticks"]
        status, body = _put(f"http://127.0.0.1:{server.server_address[1]}"
                            "/api", {"prompts": [" ".join(map(str, prompt))],
                                     "tokens_to_generate": PAR_SERVE_NEW,
                                     "temperature": 0.0})
        launches = _decode_counts(ft)
        prefills = eng.stats["admitted"] - prefills0
        ticks = eng.stats["ticks"] - ticks0
    finally:
        server.shutdown()
        thread.join(120)
    toks = [int(t) for t in body["text"][0].split()] if status == 200 else []
    want = {"flash_fwd": PAR_LAYERS * prefills,
            "flash_decode": PAR_LAYERS * ticks, "paged_flash_decode": 0}
    emit({"phase": "parallel_checkpoint_served", "card": card,
          "status": status, "tokens": len(toks), "prefills": prefills,
          "decode_ticks": ticks, "launches": launches})
    if status != 200 or toks[:len(prompt)] != prompt or \
            len(toks) != len(prompt) + PAR_SERVE_NEW:
        problems.append(f"world-1 server of the checkpoint: {status}, "
                        f"{len(toks)} tokens")
    if launches != want or prefills != 1:
        problems.append(f"world-1 server launches {launches} != {want}")
    return {"problems": problems,
            "launches": {**{k: 0 for k in TRAIN_COUNTED}, **launches}}


def parallel_training(torch, np, ft, card):
    """Phase 7. Returns the kernel launches summed over every rank of
    every run of the phase (its main path runs in the ranks)."""
    import shutil
    import tempfile

    from megatron_tpu_torch.tools import pretrain_gpt

    if not PHASE4:
        raise AssertionError("phase 7a needs phase 4's run")
    tmp = tempfile.mkdtemp(prefix="smoke_parallel_")
    total: dict = {}
    problems = []
    try:
        # (a) one rank over NCCL: phase 4's run through the parallel code
        recs = _launch(1, os.path.join(tmp, "world1"),
                       [PHASE4["argv"] + ["--distributed_backend", "nccl"]])
        rec = recs[0][0]
        _add_counts(total, rec["launches"])
        steady = sorted(rec["step_s"][1:])
        line = {"phase": "parallel_world1", "card": card,
                "backend": "nccl", "mesh": rec["mesh"],
                "losses": rec["losses"], "phase4_losses": PHASE4["losses"],
                "losses_bitwise_equal": rec["losses"] == PHASE4["losses"],
                "step_s_median": steady[len(steady) // 2],
                "phase4_step_s_median": PHASE4["step_s_median"],
                "launches": rec["launches"],
                "phase4_launches": PHASE4["launches"],
                "wall_s": rec["launch_wall_s"]}
        emit(line)
        if not line["losses_bitwise_equal"]:
            problems.append(f"world 1 losses {rec['losses']} != phase 4's "
                            f"{PHASE4['losses']}")
        if rec["launches"] != PHASE4["launches"]:
            problems.append(f"world 1 launches {rec['launches']} != phase "
                            f"4's {PHASE4['launches']}")

        # (b) two ranks sharing the card over gloo, held to one process
        base = train_argv(corpus_prefix(), layers=PAR_LAYERS, seq=PAR_SEQ,
                          global_batch=PAR_GLOBAL, iters=PAR_STEPS,
                          eval_interval=PAR_STEPS)
        # the reference takes one step more: the step the checkpoint's
        # resumed runs take (7c)
        t0 = time.monotonic()
        ref = pretrain_gpt.main(base + ["--train_iters", str(PAR_STEPS + 1)],
                                log=lambda m: None)
        torch.cuda.synchronize()
        ref_wall = time.monotonic() - t0
        want = {"losses": [r["loss"] for r in ref.step_records][:PAR_STEPS],
                "grad_norms": [h["grad_norm"]
                               for h in ref.history][:PAR_STEPS],
                "evals": [e["lm_loss"] for e in ref.evals
                          if e["iteration"] <= PAR_STEPS],
                "step_s": [r["step_s"] for r in ref.step_records],
                "next_loss": ref.step_records[PAR_STEPS]["loss"]}
        del ref
        free_cuda(torch)
        emit({"phase": "parallel_reference", "card": card,
              "model": "llama2-7B", "layers": PAR_LAYERS,
              "seq_length": PAR_SEQ, "global_batch": PAR_GLOBAL,
              "steps": PAR_STEPS + 1, "wall_s": ref_wall, **want})
        # every case, and each resume from the checkpoint, in one launch
        ckpt = os.path.join(tmp, "ckpt")
        plan = []
        for case, flags in PAR_CASES.items():
            extra = ["--save", ckpt] if case == PAR_SAVE_CASE else []
            plan.append((case, base + flags + extra + [
                "--distributed_backend", "gloo", "--profile",
                "--profile_step_start", str(PAR_PROFILE[0]),
                "--profile_step_end", str(PAR_PROFILE[1]),
                "--profile_dir", os.path.join(tmp, case + "_trace")]))
            if case == PAR_SAVE_CASE or case in PAR_LOAD_CASES:
                plan.append((case + "/resumed", base + flags + [
                    "--train_iters", str(PAR_STEPS + 1), "--load", ckpt,
                    "--distributed_backend", "gloo"]))
        for case, flags in MIXTRAL_PAR_CASES.items():
            plan.append((case, mixtral_par_argv() + flags + [
                "--distributed_backend", "gloo", "--profile",
                "--profile_step_start", str(PAR_PROFILE[0]),
                "--profile_step_end", str(PAR_PROFILE[1]),
                "--profile_dir", os.path.join(tmp, case + "_trace")]))
        # 7g's context-parallel runs, last in the launch
        cp_base = train_argv(corpus_prefix(), layers=CP_LAYERS, seq=CP_SEQ,
                             global_batch=1, iters=CP_STEPS,
                             eval_interval=CP_STEPS)
        for case, flags in CP_CASES.items():
            plan.append((case, cp_base + flags
                         + ["--distributed_backend", "gloo"]))
        # 7i's encoder runs, after 7g's
        enc_data = {"sents": os.path.join(tmp, "enc_sents"),
                    "titles": os.path.join(tmp, "enc_titles"),
                    "bert_ckpt": os.path.join(tmp, "enc_bert_ckpt")}
        encoder_corpus(np, enc_data["sents"], enc_data["titles"])
        for case in ENC_PAR_CASES:
            plan.append(("7i_" + case, enc_par_argv(case, enc_data, tmp,
                                                    ranks=True)))
        # 7j: a comm contract at its pinned geometry, last in the launch
        plan.append((CONTRACT_CASE, contract_argv(tmp)))
        # 7e(c)'s, 7f's, 7g's and 7i's one-process yardsticks, before the
        # ranks take the card
        enc_refs = _enc_par_references(torch, enc_data, tmp, card)
        PARALLEL_LAUNCH["falcon_ref"] = _falcon_reference(torch)
        mixtral_refs = {d: _mixtral_par_reference(torch, pretrain_gpt, d)
                        for d in ("capacity", "dropless")}
        cp_ref = _cp_reference(torch, pretrain_gpt, cp_base, card)
        # phases 7d and 7e run first in the same launch (rank_serve):
        # one launch's start and first steps are paid once
        recs = _launch(2, os.path.join(tmp, "gloo"),
                       [tp_serve_argv(), falcon_train_argv(corpus_prefix(),
                                                           tp=True),
                        *(argv for _, argv in plan)],
                       mode="--rank-serve")
        PARALLEL_LAUNCH["recs"] = recs
        by_run = {name: [dict(rec["runs"][i],
                              launch_wall_s=rec["launch_wall_s"])
                         for rec in recs]
                  for i, (name, _) in enumerate(plan)}
        emit({"phase": "parallel_launch", "card": card,
              "runs": ["7d, 7e (rank_serve)"] + [name for name, _ in plan],
              "serving_part_s": recs[0]["part_s"],
              "wall_s": by_run[plan[0][0]][0]["launch_wall_s"],
              "run_wall_s": {name: recs[0]["wall_s"]
                             for name, recs in by_run.items()}})
        for case in PAR_CASES:
            recs = by_run[case]
            resumed = by_run.get(case + "/resumed")
            r0 = recs[0]
            mesh = r0["mesh"]
            layers = PAR_LAYERS // mesh["pp"]
            n_micro = PAR_GLOBAL // mesh["dp"] // TRAIN_MICRO
            want_launch = _per_rank_launches(case, layers, n_micro)
            launches = {}
            for rec in recs:
                _add_counts(launches, rec["launches"])
                if rec["launches"] != want_launch:
                    problems.append(f"{case} rank {rec['rank']} launches "
                                    f"{rec['launches']} != {want_launch}")
            want_resumed = _per_rank_launches(case, layers, n_micro,
                                              steps=1, evals=0)
            for rec in resumed or []:
                _add_counts(launches, rec["launches"])
                if rec["launches"] != want_resumed:
                    problems.append(
                        f"{case} resumed rank {rec['rank']} launches "
                        f"{rec['launches']} != {want_resumed}")
            _add_counts(total, launches)
            loss_err = max(abs(a - b) for a, b in
                           zip(r0["losses"], want["losses"]))
            norm_err = max(abs(a - b) / abs(b) for a, b in
                           zip(r0["grad_norms"], want["grad_norms"]))
            eval_err = max(abs(a - b) for a, b in
                           zip(r0["evals"], want["evals"]))
            comm = (_trace_card(r0["traces"][0]) if len(r0["traces"]) == 1
                    else None)
            line = {
                "phase": "parallel_gloo", "card": card, "case": case,
                "backend": "gloo (CUDA tensors staged through host memory; "
                           "not NCCL numbers)",
                "mesh": mesh, "seq_length": r0["seq_length"],
                "losses": r0["losses"],
                "grad_norms": r0["grad_norms"], "evals": r0["evals"],
                "ranks_agree": all(
                    (r["losses"], r["grad_norms"], r["evals"])
                    == (r0["losses"], r0["grad_norms"], r0["evals"])
                    for r in recs),
                "loss_err": loss_err, "loss_atol": PAR_LOSS_ATOL,
                "loss_margin": loss_err / PAR_LOSS_ATOL,
                "grad_norm_rel_err": norm_err,
                "grad_norm_rtol": PAR_NORM_RTOL,
                "grad_norm_margin": norm_err / PAR_NORM_RTOL,
                "eval_err": eval_err,
                "step_s": r0["step_s"],
                "single_process_step_s": want["step_s"],
                "comm": comm, "launches": launches,
                "launches_per_rank_expected": want_launch,
                "peak_gib_per_rank": [r["peak_gib"] for r in recs],
                "wall_s": r0["wall_s"]}
            emit(line)
            if not line["ranks_agree"]:
                problems.append(f"{case}: ranks disagree")
            if len(r0["losses"]) != PAR_STEPS or not all(
                    map(math.isfinite, r0["losses"])):
                problems.append(f"{case}: losses {r0['losses']}")
            if not loss_err <= PAR_LOSS_ATOL:
                problems.append(f"{case}: loss off by {loss_err}")
            if not norm_err <= PAR_NORM_RTOL:
                problems.append(f"{case}: grad norm off by {norm_err}")
            if not eval_err <= PAR_LOSS_ATOL:
                problems.append(f"{case}: validation loss off by "
                                f"{eval_err}")
            if comm is None:
                problems.append(f"{case}: traces {r0['traces']}")
        problems += _mixtral_par_gates(card, by_run, mixtral_refs, total)
        problems += _cp_gates(card, by_run, cp_ref)
        problems += _enc_par_gates(torch, card, by_run, enc_refs, enc_data,
                                   total)
        problems += _contract_gate(card, by_run[CONTRACT_CASE])
        saved = _sharded_checkpoint(
            torch, np, ft, card, ckpt,
            {c: by_run[c + "/resumed"]
             for c in (PAR_SAVE_CASE, *PAR_LOAD_CASES)},
            by_run[PAR_SAVE_CASE], want["next_loss"])
        problems += saved["problems"]
        _add_counts(total, saved["launches"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        raise AssertionError("parallel: " + "; ".join(problems))
    return total


def enc_par_argv(case: str, data: dict, tmp: str, ranks: bool) -> list:
    """A phase-7i run: its entry point's name, then its flags, at the
    ranks' topology (with --save for BERT's state, a traced last step and
    gloo) or the one-process reference's micro-batch."""
    tool, flags, gbs, micro, ref_micro, topology = ENC_PAR_CASES[case]
    ids = (["--pad_token_id", "0"] if tool == "pretrain_t5"
           else ENC_TOKEN_IDS)
    # 64 x tp 2 keeps BERT's padded 30592 rows at every topology
    argv = [tool] + flags + ids + [
        "--make_vocab_size_divisible_by", "64",
        "--global_batch_size", str(gbs),
        "--micro_batch_size", str(micro if ranks else ref_micro),
        "--train_iters", str(ENC_PAR_STEPS), "--lr", ENC_PAR_LR,
        "--lr_decay_style", "constant", "--log_interval", "1",
        "--seed", str(SEED), "--data_path", data["sents"],
        "--device", ENC_DEVICE]
    if tool == "pretrain_ict":
        argv += ["--titles_data_path", data["titles"]]
    if not ranks:
        return argv
    if tool == "pretrain_bert":
        argv += ["--save", data["bert_ckpt"]]
    return argv + topology + [
        "--distributed_backend", "gloo", "--profile",
        "--profile_step_start", str(ENC_PAR_STEPS - 1),
        "--profile_step_end", str(ENC_PAR_STEPS),
        "--profile_dir", os.path.join(tmp, case + "_trace")]


#: 7j: the comm contract phase 7's launch holds (analysis/contracts.py;
#: its loop runs TRAIN_WINDOW's two profiled steps)
CONTRACT = "train_tp2_sp"
CONTRACT_RUN = "contract:"
CONTRACT_CASE = "7j_contract"


def contract_argv(tmp) -> list:
    """7j's run: the contract's name and its trace directory (the backend
    flag matters only when it is a launch's first run)."""
    return [CONTRACT_RUN + CONTRACT, os.path.join(tmp, "contract_trace"),
            "--distributed_backend", "gloo"]


def _contract_gate(card, recs) -> list:
    """7j: tools/trace_report --contract on rank 0's trace of the
    contract's window: the comm.* calls of every collective equal the
    golden manifest's per step times the window's steps."""
    from megatron_tpu_torch.analysis import contracts

    r0 = recs[0]
    if len(r0["traces"]) != 1:
        return [f"{CONTRACT_CASE}: traces {r0['traces']}"]
    steps = contracts.TRAIN_WINDOW[1] - contracts.TRAIN_WINDOW[0]
    cli = trace_report_cli(r0["traces"][0], "--contract", CONTRACT,
                           "--executions", str(steps), "--check")
    got = cli["json"]
    contract = got["contract"]
    emit({"phase": "comm_contract", "card": card, "contract": CONTRACT,
          "backend": "gloo (CUDA tensors staged through host memory)",
          "executions": contract["executions"],
          "matches": contract["matches"], "rows": contract["rows"],
          "problems": contract["problems"],
          "steps": got["report"]["steps"], "rc": cli["rc"],
          "card_share": got["report"]["card"],
          "losses": r0["losses"], "wall_s": r0["wall_s"]})
    print(cli["text"], flush=True)
    problems = []
    if cli["rc"] != 0 or not contract["matches"]:
        problems.append(f"{CONTRACT_CASE}: {contract['problems']}")
    if got["report"]["steps"].get("train_step", {}).get("count") != steps:
        problems.append(f"{CONTRACT_CASE}: step markers "
                        f"{got['report']['steps']}")
    return problems


def _enc_par_references(torch, data, tmp, card) -> dict:
    """Phase 7i's one-process runs: each case's entry point at its
    reference micro-batch (losses, grad norms, step times)."""
    import importlib

    refs = {}
    cuda = ENC_DEVICE == "cuda"
    for case in ENC_PAR_CASES:
        argv = enc_par_argv(case, data, tmp, ranks=False)
        tool = importlib.import_module("megatron_tpu_torch.tools." + argv[0])
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        loop = tool.main(argv[1:], log=lambda m: None)
        if cuda:
            torch.cuda.synchronize()
        refs[case] = {"losses": [r["loss"] for r in loop.step_records],
                      "grad_norms": [h["grad_norm"] for h in loop.history],
                      "step_s": [r["step_s"] for r in loop.step_records],
                      "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                   if cuda else None),
                      "wall_s": time.monotonic() - t0}
        del loop
        free_cuda(torch)
    emit({"phase": "encoder_parallel_reference", "card": card, **refs})
    return refs


def _enc_par_gates(torch, card, by_run, refs, data, total) -> list:
    """Phase 7i's gates: each case's losses and grad norms against its
    one-process run (PAR_LOSS_ATOL, PAR_NORM_RTOL), the ranks agreeing,
    B1-B5 launches counted (0 expected: the dense attention), and
    BERT's tp2 state loaded at world size 1 against each rank's slices'
    crc32."""
    problems = []
    for case in ENC_PAR_CASES:
        recs, want = by_run["7i_" + case], refs[case]
        r0 = recs[0]
        launches = {}
        for rec in recs:
            _add_counts(launches, rec["launches"])
        _add_counts(total, launches)
        n = min(len(r0["losses"]), len(want["losses"]))
        loss_err = (max(abs(a - b) for a, b in
                        zip(r0["losses"], want["losses"])) if n else math.inf)
        norm_err = (max(abs(a - b) / abs(b) for a, b in
                        zip(r0["grad_norms"], want["grad_norms"]))
                    if n else math.inf)
        comm = (_trace_card(r0["traces"][0]) if len(r0["traces"]) == 1
                else None)
        line = {"phase": "encoder_parallel", "card": card, "case": case,
                "backend": "gloo (CUDA tensors staged through host memory; "
                           "not NCCL numbers)",
                "mesh": r0["mesh"], "losses": r0["losses"],
                "reference_losses": want["losses"],
                "grad_norms": r0["grad_norms"],
                "reference_grad_norms": want["grad_norms"],
                "ranks_agree": all((r["losses"], r["grad_norms"])
                                   == (r0["losses"], r0["grad_norms"])
                                   for r in recs),
                "loss_err": loss_err, "loss_margin": loss_err / PAR_LOSS_ATOL,
                "grad_norm_rel_err": norm_err,
                "grad_norm_margin": norm_err / PAR_NORM_RTOL,
                "step_s": r0["step_s"],
                "single_process_step_s": want["step_s"],
                "comm": comm, "launches": launches,
                "peak_gib_per_rank": [r["peak_gib"] for r in recs],
                "single_process_peak_gib": want["peak_gib"],
                "wall_s": r0["wall_s"]}
        if case == "bert_tp2_sp":
            line["world1_load"] = _enc_par_load(torch, data, recs)
            if not line["world1_load"]["bitwise"]:
                problems.append(f"7i {case}: the world-1 load differs "
                                f"from the ranks' slices")
        emit(line)
        if len(r0["losses"]) != ENC_PAR_STEPS or not all(
                map(math.isfinite, r0["losses"])):
            problems.append(f"7i {case}: losses {r0['losses']}")
        if not line["ranks_agree"]:
            problems.append(f"7i {case}: ranks disagree")
        if not loss_err <= PAR_LOSS_ATOL:
            problems.append(f"7i {case}: loss off by {loss_err}")
        if not norm_err <= PAR_NORM_RTOL:
            problems.append(f"7i {case}: grad norm off by {norm_err}")
        if comm is None:
            problems.append(f"7i {case}: traces {r0['traces']}")
    return problems


def _enc_par_load(torch, data, recs) -> dict:
    """BERT's tp2 checkpoint loaded by a world-1 TrainLoop: each leaf cut
    as each tensor rank holds it, its crc32 against that rank's."""
    from megatron_tpu_torch.arguments import bert_args, parse_args
    from megatron_tpu_torch.models.bert import bert_loss
    from megatron_tpu_torch.models.params import param_specs
    from megatron_tpu_torch.parallel.mesh import MESH_AXES
    from megatron_tpu_torch.parallel.sharding import shard_leaf
    from megatron_tpu_torch.tools import pretrain_bert
    from megatron_tpu_torch.training.optimizer import leaf_paths
    from megatron_tpu_torch.training.pretrain import TrainLoop

    argv = enc_par_argv("bert_tp2_sp", data, "", ranks=False)[1:]
    cfg = pretrain_bert.run_config(parse_args(
        argv + ["--load", data["bert_ckpt"]], bert_args))
    t0 = time.monotonic()
    loop = TrainLoop(cfg, log=lambda m: None, device=ENC_DEVICE,
                     loss_fn=bert_loss)
    load_s = time.monotonic() - t0
    specs = param_specs(cfg.model)
    sizes = dict.fromkeys(MESH_AXES, 1)
    sizes["tensor"] = len(recs)
    same = loop.iteration == ENC_PAR_STEPS
    for rank, rec in enumerate(recs):
        coords = dict.fromkeys(MESH_AXES, 0)
        coords["tensor"] = rank
        mine = _slice_crcs(torch, {path: shard_leaf(
            t.detach(), specs[path], coords, sizes)
            for path, t in leaf_paths(loop.state.params)})
        same = same and mine == rec["state_crc"]
    out = {"bitwise": same, "iteration": loop.iteration, "load_s": load_s,
           "leaves": len(specs)}
    del loop
    free_cuda(torch)
    return out


def _served(kw, cfg, params, tokenizer, lead, drive):
    """drive(service, base) on rank 0's server (run_server with the
    GenerationService keywords `kw`), the follower loop on the other
    ranks. Returns drive's result on rank 0, None elsewhere."""
    from megatron_tpu_torch.inference.server import (
        GenerationService, run_server,
    )
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    if not lead:
        GenerationService(cfg, params, tokenizer, metrics=MetricsRegistry(),
                          **kw).follow()
        return None
    ready, handles = threading.Event(), []
    thread = threading.Thread(
        target=run_server, daemon=True, name="rank-server",
        kwargs=dict(cfg=cfg, params=params, tokenizer=tokenizer,
                    host="127.0.0.1", port=0, ready=ready,
                    service_out=handles, **kw))
    thread.start()
    if not ready.wait(300):
        raise RuntimeError("rank 0's server did not start")
    service, server = handles
    try:
        return drive(service, f"http://127.0.0.1:{server.server_address[1]}")
    finally:
        server.shutdown()
        thread.join(120)


def _engine_traffic(ft, service, base, prompts) -> dict:
    """_greedy_traffic on a running engine server, with the TTFT, tick
    and per-token means of this run (deltas of the process-wide
    registry) and the engine's counters."""
    def scrape():
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            return r.read().decode()

    before = scrape()
    run = _greedy_traffic(ft, base, service.engine, prompts)
    after = scrape()
    run.pop("caught")

    def mean(name):
        return (_metric_delta(before, after, name + "_sum")
                / _metric_delta(before, after, name + "_count"))

    run.update(ttft_mean_s=mean("engine_ttft_seconds"),
               tick_wall_mean_s=mean("engine_decode_tick_seconds"),
               per_token_mean_s=mean("engine_time_per_output_token_seconds"),
               stats=dict(service.engine.stats))
    return run


def _filled_ticks(torch, eng, ch, lead, lens, vocab, trace, sync) -> dict:
    """TP_TICKS decode ticks of `eng` with one request a slot (prompts of
    `lens` tokens), stepped by rank 0 in this thread, timed and then
    traced (the other ranks follow ch). Rank 0's wall, kernel and copy
    spans and the comm.* share of the traced ticks; {} elsewhere."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from megatron_tpu_torch.inference.engine import Request

    if not lead:
        while True:
            op, payload = ch.recv()
            if op == "stop":
                return {}
            if op == "tick":
                eng.follow(payload)
    fill = np.random.default_rng(SEED + 8)
    for n in lens:
        eng.submit(Request(
            prompt=fill.integers(0, vocab - 1, size=n).astype(np.int32),
            max_new_tokens=TP_SEQ - n - 1))
    while len(eng._decode_rows()) < len(lens):
        eng.step()
    for _ in range(3):
        eng.step()
    sync()
    t1 = time.perf_counter()
    for _ in range(TP_TICKS):
        eng.step()
    sync()
    wall_ms = (time.perf_counter() - t1) * 1e3 / TP_TICKS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TP_TICKS):
            eng.step()
        sync()
    kernel_ms = copy_ms = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if e.key.startswith(("Memcpy", "Memset")):
            copy_ms += ms         # gloo's staging through host memory
        else:
            kernel_ms += ms
    prof.export_chrome_trace(trace)
    ch.stop()
    # the two ranks' contexts take turns on the card, so a kernel's span
    # on rank 0 holds the other rank's turns too: these are spans, not
    # device busy time (no idle share)
    return {"wall_ms": wall_ms,
            "kernel_span_ms_time_sliced": kernel_ms / TP_TICKS,
            "copy_span_ms_time_sliced": copy_ms / TP_TICKS,
            "comm": _trace_card(trace)}


def _run_record(torch, ft, flags, rank, probe=None) -> dict:
    """tools/pretrain_gpt's main with `flags` in this process group: its
    kernel launches, losses, grad norms, evaluations (with --metrics),
    step times, saves, load, peak memory and traces; with `probe`, its
    result on the finished loop under "probe" (after the launches are
    read, so its own do not count)."""
    import importlib

    from megatron_tpu_torch.tools import pretrain_gpt

    tool = pretrain_gpt
    encoder = bool(flags) and flags[0] in ENC_PAR_TOOLS
    if encoder:             # phase 7i's runs name their entry point first
        tool = importlib.import_module("megatron_tpu_torch.tools."
                                       + flags[0])
        flags = flags[1:]
    cuda = torch.cuda.is_available()
    for name in TRAIN_COUNTED:
        getattr(ft, name).launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    if flags and flags[0].startswith(CONTRACT_RUN):
        # a comm contract's run: its loop at the contract's pinned
        # geometry (analysis/contracts.py) with its --profile window
        from megatron_tpu_torch.analysis import contracts

        loop = contracts.run_train(flags[0][len(CONTRACT_RUN):], flags[1],
                                   device="cuda" if cuda else "cpu")
    else:
        loop = tool.main(list(flags), log=lambda m: print(m, flush=True))
    if cuda:
        torch.cuda.synchronize()
    record = {
        "rank": rank, "wall_s": time.monotonic() - t0,
        "iterations": [r["iteration"] for r in loop.step_records],
        "losses": [r["loss"] for r in loop.step_records],
        "step_s": [r["step_s"] for r in loop.step_records],
        "grad_norms": [h["grad_norm"] for h in loop.history],
        "moe_aux_losses": [h.get("moe_aux_loss") for h in loop.history],
        "evals": [e["lm_loss"] for e in loop.evals],
        "eval_metrics": [dict(e) for e in loop.evals],
        "seq_length": loop.cfg.model.seq_length,
        "launches": {n: getattr(ft, n).launches for n in TRAIN_COUNTED},
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda
                     else None),
        "traces": loop.profile_traces, "saves": loop.saves,
        "load_s": loop.load_s, "load_read_bytes": loop.load_read_bytes,
        "mesh": (None if loop.mesh is None else
                 {"world": loop.mesh.world_size, "dp": loop.mesh.dp,
                  "ep": loop.mesh.ep, "pp": loop.mesh.pp,
                  "vpp": loop.mesh.vpp, "cp": loop.mesh.cp,
                  "tp": loop.mesh.tp})}
    if encoder:
        record["state_crc"] = _slice_crcs(torch, loop.state.params)
    if probe is not None:
        record["probe"] = probe(loop)
    return record


def _slice_crcs(torch, params) -> dict:
    """{leaf path: crc32 of its bytes} of a parameter tree (this rank's
    slices)."""
    from megatron_tpu_torch.training.optimizer import leaf_paths

    return {path: zlib.crc32(t.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes()) for path, t in leaf_paths(params)}


def rank_serve(out: str, runs) -> int:
    """One rank of phases 7d, 7e and 7b-7c's two-rank runs (this
    script's --rank-serve mode, started by torch.distributed.run).
    runs[0] is the server's argv at --tensor_model_parallel_size,
    runs[1] 7e(c)'s training run's, runs[2:] phase 7's. In one process
    group, in turn:

      7d  tools/run_text_generation_server's own pieces (the process
          group, the serving mesh, load_model's init at the seed cut to
          this rank's slices), then (1) the engine server on rank 0
          (phase 3's traffic, its /metrics) with the other rank in the
          follower loop, (2) TP_TICKS decode ticks over TP_SLOTS filled
          slots, stepped by rank 0 in this thread, timed and then
          traced, (3) one request through the one-shot server;
      7e  (a) the paged server on the same weights (phase 3b's traffic
          and 147-page pool), then its filled ticks, timed and traced;
          (d) Falcon-40B width x FALCON_SERVE_LAYERS on the dense
          engine server; (b) Llama-2-7B at pp2 (load_model on a pp2
          serving mesh): one generation request and one scored batch
          through the one-shot server, and the request again in this
          thread under the profiler; (c) pretrain_gpt's main with
          runs[1];
      7   pretrain_gpt's main with each of runs[2:] (rank_run's records);
      7h  _long_context_serve: the context-parallel server at cp2 (dense,
          then int8 hops), its filled ticks, and the tp2 engine server
          with int8 TP collectives.

    Each part's kernel launches, walls and rank 0's tokens go to
    `out`.rank<RANK>.json."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, REPO)
    from megatron_tpu_torch.inference.engine import InferenceEngine
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.ops.flash import flash_template as ft
    from megatron_tpu_torch.parallel.distributed import (
        ServingChannel, destroy_distributed, initialize_distributed,
        local_device, serving_mesh,
    )
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.tokenizer import NullTokenizer
    from megatron_tpu_torch.tools import run_text_generation_server as rts

    args = rts.parse_args(list(runs[0]))
    initialize_distributed(args.device, args.distributed_backend)
    try:
        mesh = serving_mesh(args.tensor_model_parallel_size)
        args.device = str(local_device(args.device))
        lead = mesh.rank == 0
        cuda = args.device.startswith("cuda")
        sync = torch.cuda.synchronize if cuda else (lambda: None)

        def free():
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

        t0 = time.monotonic()
        cfg = tp_serve_cfg(dataclasses, presets)
        params = init_params(cfg, args.seed, device=args.device, mesh=mesh)
        sync()
        record = {"rank": mesh.rank, "init_s": time.monotonic() - t0,
                  "tp": mesh.tp, "part_s": {}}
        tokenizer = NullTokenizer(cfg.vocab_size)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
                   for n in PROMPT_LENS]

        def channel(m=mesh):
            return ServingChannel(m.control_group, m.rank)

        def kw(slots, m=mesh, **extra):
            return dict(engine_slots=slots, engine_max_seq_len=TP_SEQ,
                        device=args.device, mesh=m, channel=channel(m),
                        cuda_graph=False, **extra)

        def traffic(service, base):
            return _engine_traffic(ft, base=base, service=service,
                                   prompts=prompts)

        def part(name):
            record["part_s"][name] = time.monotonic() - part.t
            part.t = time.monotonic()

        part.t = time.monotonic()
        # 7d (1) the engine server: the main path's run, counts from 0
        _zero_decode_counts(ft)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        run = _served(kw(TP_SLOTS), cfg, params, tokenizer, lead, traffic)
        record["launches"] = _decode_counts(ft)
        record["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                              if cuda else None)
        if lead:
            run.pop("stats")
            record.update(run)

        # 7d (2) decode ticks over filled slots
        ch = channel()
        eng = InferenceEngine(cfg, params, num_slots=TP_SLOTS,
                              max_seq_len=TP_SEQ, device=args.device,
                              metrics=MetricsRegistry(), cuda_graph=False,
                              mesh=mesh, channel=ch)
        _zero_decode_counts(ft)
        record["tick"] = _filled_ticks(torch, eng, ch, lead, TP_TICK_LENS,
                                       cfg.vocab_size,
                                       f"{out}.tick_trace.json", sync)
        record["tick_launches"] = _decode_counts(ft)
        del eng
        free()

        # 7d (3) one request through the one-shot server
        _zero_decode_counts(ft)

        def one_shot(service, base):
            t = time.monotonic()
            status, body = _put(base + "/api", {
                "prompts": [" ".join(map(str, prompts[1]))],
                "tokens_to_generate": TP_ONE_SHOT_NEW,
                "temperature": 0.0})
            toks = [int(x) for x in body["text"][0].split()]
            if status != 200 or toks[:len(prompts[1])] != prompts[1]:
                raise AssertionError(f"one-shot request: {status}")
            return {"one_shot_generated": toks[len(prompts[1]):],
                    "one_shot_wall_s": time.monotonic() - t}

        record.update(_served(kw(0), cfg, params, tokenizer, lead, one_shot)
                      or {})
        record["one_shot_launches"] = _decode_counts(ft)
        part("7d")

        # 7e(a) the paged engine server on the same weights: phase 3b's
        # traffic over its 147-page pool (preemption), the 100-token
        # prompt's repeat (a prefix hit); counts from 0
        _zero_decode_counts(ft)
        paged_kw = dict(kv_paging=True, page_size=PAGE_SIZE,
                        prefill_chunk=TP_PREFILL_CHUNK,
                        num_pages=PRESSURE_PAGES)
        run = _served(kw(TP_SLOTS, **paged_kw), cfg, params, tokenizer,
                      lead, traffic)
        paged = {"launches": _decode_counts(ft)}
        if lead:
            paged.update(run)
        ch = channel()
        eng = PagedInferenceEngine(
            cfg, params, num_slots=TP_SLOTS, max_seq_len=TP_SEQ,
            page_size=PAGE_SIZE, prefill_chunk=TP_PREFILL_CHUNK,
            device=args.device, metrics=MetricsRegistry(), cuda_graph=False,
            mesh=mesh, channel=ch)
        _zero_decode_counts(ft)
        paged["tick"] = _filled_ticks(torch, eng, ch, lead, PAGED_TICK_LENS,
                                      cfg.vocab_size,
                                      f"{out}.paged_trace.json", sync)
        paged["tick_launches"] = _decode_counts(ft)
        record["paged"] = paged
        del eng, params
        free()
        part("7e_a")

        # 7e(d) Falcon-40B width x FALCON_SERVE_LAYERS on the dense engine
        fcfg = falcon_serve_cfg(dataclasses, presets)
        t1 = time.monotonic()
        fparams = init_params(fcfg, SEED, device=args.device, mesh=mesh)
        sync()
        frng = np.random.default_rng(SEED)
        fprompts = [frng.integers(0, fcfg.vocab_size - 1, size=n).tolist()
                    for n in PROMPT_LENS]
        _zero_decode_counts(ft)
        run = _served(kw(TP_SLOTS), fcfg, fparams,
                      NullTokenizer(fcfg.vocab_size), lead,
                      lambda svc, base: _engine_traffic(ft, svc, base,
                                                        fprompts))
        falcon = {"init_s": time.monotonic() - t1,
                  "launches": _decode_counts(ft)}
        if lead:
            falcon.update(run)
        record["falcon_serve"] = falcon
        del fparams
        free()
        part("7e_d")

        # 7f(d) Mixtral's width x MIXTRAL_PAR_SERVE_LAYERS on the dense
        # engine with the dense attention, in fp32 then bf16
        mixtral = {}
        for dtype in ("float32", "bfloat16"):
            mcfg = mixtral_serve_cfg(dataclasses, presets, dtype)
            t1 = time.monotonic()
            mparams = init_params(mcfg, SEED, device=args.device, mesh=mesh)
            sync()
            _zero_decode_counts(ft)
            run = _served(kw(TP_SLOTS), mcfg, mparams,
                          NullTokenizer(mcfg.vocab_size), lead,
                          lambda svc, base: _engine_traffic(
                              ft, svc, base, mixtral_prompts(np, mcfg)))
            mixtral[dtype] = {"init_s": time.monotonic() - t1,
                              "launches": _decode_counts(ft)}
            if lead:
                mixtral[dtype].update(run)
            del mparams
            free()
        record["mixtral_serve"] = mixtral
        part("7f_d")

        # 7e(b) Llama-2-7B at pp2: the one-shot server through the
        # pipelined forward
        pp_mesh = serving_mesh(1, 2)
        t1 = time.monotonic()
        pparams = init_params(cfg, args.seed, device=args.device,
                              mesh=pp_mesh)
        sync()
        pipe = {"init_s": time.monotonic() - t1,
                "layers_per_stage": cfg.num_layers // pp_mesh.pp}
        gen_req = {"prompts": [" ".join(map(str, prompts[1]))],
                   "tokens_to_generate": NEW_TOKENS, "temperature": 0.0}

        def pipelined(service, base):
            out_ = {}
            _zero_decode_counts(ft)
            t = time.monotonic()
            status, body = _put(base + "/api", gen_req)
            out_["generate_wall_s"] = time.monotonic() - t
            toks = [int(x) for x in body["text"][0].split()]
            if status != 200 or toks[:len(prompts[1])] != prompts[1]:
                raise AssertionError(f"pp2 request: {status} {body}")
            out_["generated"] = toks[len(prompts[1]):]
            out_["generate_launches"] = _decode_counts(ft)
            _zero_decode_counts(ft)
            t = time.monotonic()
            status, body = _put(base + "/api", {
                "prompts": [" ".join(map(str, p)) for p in prompts],
                "tokens_to_generate": 0})
            out_["score_wall_s"] = time.monotonic() - t
            if status != 200:
                raise AssertionError(f"pp2 scoring: {status}")
            out_["logprobs"] = body["logprobs"]
            out_["score_launches"] = _decode_counts(ft)
            # the request again in this thread, traced: the p2p share
            trace = f"{out}.pp_trace.json"
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                service.handle(gen_req)
                sync()
            prof.export_chrome_trace(trace)
            out_["comm"] = _trace_card(trace)
            return out_

        if not lead:
            _zero_decode_counts(ft)
        run = _served(kw(0, m=pp_mesh), cfg, pparams,
                      tokenizer, lead, pipelined)
        if lead:
            pipe.update(run)
        # a follower's counts cover all three calls: the request, the
        # scored batch and the traced request (one-shot: no launch)
        pipe["follower_launches"] = None if lead else _decode_counts(ft)
        record["pipelined"] = pipe
        del pparams
        free()
        part("7e_b")

        # 7e(c) Falcon-40B width trained at tp2 + SP with --metrics
        record["falcon_train"] = _run_record(
            torch, ft, runs[1], mesh.rank,
            probe=lambda loop: _argmax_probe(torch, np, loop))
        free()
        part("7e_c")

        # phase 7's two-rank training runs, in turn
        record["runs"] = []
        for flags in runs[2:]:
            record["runs"].append(_run_record(torch, ft, flags, mesh.rank))
            free()
        part("7")

        # 7h: the context-parallel engine and the compressed collectives
        record["long_context"] = _long_context_serve(
            torch, np, ft, args, cfg, mesh, lead, sync, free, out)
        part("7h")
    finally:
        destroy_distributed()
    with open(f"{out}.rank{record['rank']}.json", "w") as f:
        json.dump(record, f)
    return 0


def cp_serve_cfg(cfg):
    """Phase 7h (a)/(b)'s model: 7d's cut to CP_SERVE_LAYERS."""
    import dataclasses

    return dataclasses.replace(cfg, num_layers=CP_SERVE_LAYERS).validate()


def cp_serve_prompts(np, cfg) -> list:
    """Phase 7h's prompts: phase 3's four (the same seeded draws) and one
    of CP_LONG_PROMPT tokens drawn after them."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
               for n in PROMPT_LENS]
    return prompts + [rng.integers(0, cfg.vocab_size - 1,
                                   size=CP_LONG_PROMPT).tolist()]


def _long_context_serve(torch, np, ft, args, cfg, mesh, lead, sync, free,
                        out) -> dict:
    """Phase 7h on the launch's two ranks: (a)/(b) the context-parallel
    server at cp2 (dense, then int8 hops) on the width's weights, phase
    3's traffic plus the long prompt, each rank's launches and, on rank
    0, the engine's stats with the byte model's prices of a tick and a
    chunk, then (a)'s engine's filled ticks, timed and traced; (c) the
    tp2 dense engine server at the same depth, phase 3's traffic, dense
    and then with int8 TP collectives, and on both ranks the int8
    collectives' logit change on its tokens and phase 3's teacher-forced
    gate through the same collectives."""
    from megatron_tpu_torch.inference.context_parallel import (
        ContextParallelEngine,
    )
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.parallel.distributed import (
        ServingChannel, serving_mesh,
    )
    from megatron_tpu_torch.quant.collectives import (
        cp_ring_comm_bytes, forward_comm_bytes, make_tp_comm,
    )
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
    from megatron_tpu_torch.tokenizer import NullTokenizer

    tokenizer = NullTokenizer(cfg.vocab_size)
    prompts = cp_serve_prompts(np, cfg)
    res = {}
    cp_mesh = serving_mesh(1, 1, 2)
    ccfg = cp_serve_cfg(cfg)
    t0 = time.monotonic()
    params = init_params(ccfg, args.seed, device=args.device, mesh=cp_mesh)
    sync()
    res["init_s"] = time.monotonic() - t0

    def cp_kw(mode):
        return dict(engine_slots=CP_SERVE_SLOTS,
                    engine_max_seq_len=CP_SERVE_SEQ, device=args.device,
                    mesh=cp_mesh, cuda_graph=False, kv_paging=True,
                    page_size=PAGE_SIZE, prefill_chunk=TP_PREFILL_CHUNK,
                    channel=ServingChannel(cp_mesh.control_group,
                                           cp_mesh.rank),
                    cp_serving=True, cp_collectives=mode)

    def cp_drive(service, base):
        run = _engine_traffic(ft, service, base, prompts)
        eng = service.engine
        run["bytes_tick"] = cp_ring_comm_bytes(ccfg, eng.cp_comm,
                                               eng.num_slots, 1)
        run["bytes_chunk"] = cp_ring_comm_bytes(ccfg, eng.cp_comm, 1,
                                                eng.prefill_chunk)
        run["pool_pages_per_rank"] = eng.pool.pages_per_rank
        return run

    for mode in ("dense", "int8"):
        _zero_decode_counts(ft)
        if args.device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        run = _served(cp_kw(mode), ccfg, params, tokenizer, lead, cp_drive)
        res[mode] = {"launches": _decode_counts(ft),
                     "partial_launches": _partial_count(ft),
                     "wall_s": time.monotonic() - t0,
                     "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                  if args.device.startswith("cuda")
                                  else None)}
        if lead:
            res[mode].update(run)
        free()
    ch = ServingChannel(cp_mesh.control_group, cp_mesh.rank)
    eng = ContextParallelEngine(
        ccfg, params, num_slots=CP_SERVE_SLOTS, max_seq_len=CP_SERVE_SEQ,
        page_size=PAGE_SIZE, prefill_chunk=TP_PREFILL_CHUNK,
        device=args.device, metrics=MetricsRegistry(), cuda_graph=False,
        mesh=cp_mesh, channel=ch)
    _zero_decode_counts(ft)
    res["tick"] = _filled_ticks(torch, eng, ch, lead, PAGED_TICK_LENS,
                                ccfg.vocab_size, f"{out}.cp_trace.json", sync)
    res["tick_launches"] = _decode_counts(ft)
    res["tick_partial_launches"] = _partial_count(ft)
    del eng, params
    free()

    # (c) the tp2 engine at ccfg's depth, dense then with int8 TP
    # collectives, phase 3's traffic
    tparams = init_params(ccfg, args.seed, device=args.device, mesh=mesh)
    tprompts = prompts[:len(PROMPT_LENS)]

    def tp_drive(service, base):
        run = _engine_traffic(ft, service, base, tprompts)
        eng = service.engine
        if eng.tp_comm is not None:
            run["bytes_tick"] = forward_comm_bytes(ccfg, eng.tp_comm,
                                                   eng.num_slots, 1)
            run["bytes_prefill"] = [
                forward_comm_bytes(ccfg, eng.tp_comm, 1, eng._bucket(len(p)))
                for p in tprompts + [tprompts[1]]]
        return run

    for mode in ("none", "int8"):
        _zero_decode_counts(ft)
        run = _served(dict(engine_slots=TP_SLOTS, engine_max_seq_len=TP_SEQ,
                           device=args.device, mesh=mesh,
                           channel=ServingChannel(mesh.control_group,
                                                  mesh.rank),
                           cuda_graph=False, compress_collectives=mode),
                      ccfg, tparams, tokenizer, lead, tp_drive)
        key = "tp_int8" if mode == "int8" else "tp_dense"
        res[key] = {"launches": _decode_counts(ft)}
        if lead:
            res[key].update(run)
    # on both ranks, on the int8 engine's tokens: each position's logit
    # change made by the int8 collectives (the first gate's transport
    # band), and phase 3's gate with both plain passes through the same
    # collectives (the second: the compressed function's own)
    import dataclasses

    import torch.distributed as dist

    box = [res["tp_int8"]["generated"] if lead else None]
    dist.broadcast_object_list(box, src=0)
    tp_comm = make_tp_comm(mesh, "int8", cfg=ccfg)
    res["tp_int8"]["transport"] = _transport_error(
        torch, dataclasses, ccfg, tparams, tprompts, box[0], mesh, tp_comm)
    res["tp_int8"]["teacher_forced_compressed"] = teacher_force(
        torch, dataclasses, ccfg, tparams, tprompts, box[0], mesh=mesh,
        tp_comm=tp_comm)
    del tparams
    free()
    return res


def _transport_error(torch, dataclasses, cfg, params, prompts, generated,
                     mesh, tp_comm) -> list:
    """For each teacher-forced sequence (teacher_force's), each position's
    largest |logit| change that tp_comm's collectives make to the plain
    bf16 forward on this rank's params: the same context through the
    same mesh with and without them."""
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.quant.collectives import gather_logits

    plain = dataclasses.replace(cfg, attention_impl="xla")
    out = []
    with torch.no_grad():
        for prompt, gen in zip(prompts, generated):
            seq = torch.tensor([prompt + gen[:-1]], device="cuda")
            p0 = len(prompt) - 1
            lb = gather_logits(lm_forward(plain, params, seq, mesh=mesh),
                               mesh, None)[0, p0:].float()
            lc = lm_forward(plain, params, seq, mesh=mesh,
                            tp_comm=tp_comm)[0, p0:].float()
            out.append((lc - lb).abs().max(-1).values.tolist())
    return out


def mixtral_serve_cfg(dataclasses, presets, dtype: str):
    """Phase 7f(d)'s model: Mixtral's width x MIXTRAL_PAR_SERVE_LAYERS in
    `dtype` with the dense attention, phase 5c's serving capacity."""
    return dataclasses.replace(
        presets.from_model_name(MIXTRAL),
        num_layers=MIXTRAL_PAR_SERVE_LAYERS, params_dtype=dtype,
        attention_impl="xla",
        moe_capacity_factor=MIXTRAL_SERVE_CAPACITY).validate()


def mixtral_prompts(np, cfg) -> list:
    """Phase 3's prompt lengths, drawn from SEED in the model's vocab."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
            for n in PROMPT_LENS]


def falcon_serve_cfg(dataclasses, presets):
    """Phase 7e(d)'s model: Falcon-40B's width, FALCON_SERVE_LAYERS
    layers."""
    return dataclasses.replace(presets.from_model_name(FALCON40),
                               num_layers=FALCON_SERVE_LAYERS).validate()


def falcon_train_argv(prefix, tp: bool):
    """Phase 7e(c)'s run: Falcon-40B's width x FALCON_TRAIN_LAYERS at S
    FALCON_SEQ with --metrics, on phase 4's corpus; tp adds tp2 + SP over
    gloo."""
    argv = train_argv(prefix, layers=FALCON_TRAIN_LAYERS, seq=FALCON_SEQ,
                      global_batch=PAR_GLOBAL, iters=PAR_STEPS,
                      eval_interval=PAR_STEPS)
    argv[argv.index("llama2-7B")] = FALCON40
    argv[argv.index("--lr") + 1] = FAMILY_LR
    argv += ["--metrics", *FALCON_METRICS]
    if tp:
        argv += ["--tensor_model_parallel_size", "2", "--sequence_parallel",
                 "--distributed_backend", "gloo"]
    return argv


def _pp_gates(torch, np, dataclasses, cfg, params, prompts, pipe,
              problems) -> dict:
    """7e(b)'s scored batch against the plain path (phase 3d's scoring
    gate) and its launches."""
    lengths = [len(p) for p in prompts]
    padded = np.full((len(prompts), max(lengths)), cfg.vocab_size, np.int64)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    plain, band, _ = _score_plain(torch, dataclasses, cfg, params, padded)
    got = torch.tensor(pipe["logprobs"])
    real = _real_positions(torch, lengths, padded.shape[1] - 1)
    diff, band = (got - plain).abs()[real], band[real]
    within = float((diff <= 2 * band).float().mean())
    if within < MATCH_GATE:
        problems.append(f"pp2 scores within 2x band {within:.4f} < "
                        f"{MATCH_GATE}")
    return {"positions": int(real.sum()),
            "max_abs_err_vs_plain": float(diff.max()),
            "share_within_2x_band": within}


def tp_serve_cfg(dataclasses, presets):
    """Phases 7d-7e(b)'s model: Llama-2-7B's width x TP_SERVE_LAYERS."""
    return dataclasses.replace(presets.from_model_name("llama2-7B"),
                               num_layers=TP_SERVE_LAYERS).validate()


def tp_serve_argv():
    """Phase 7d's server flags: Llama-2-7B at tp2 over gloo, 8 slots x
    2048 (rank_serve builds tp_serve_cfg's cut of it)."""
    return ["--model_name", "llama2-7B", "--seed", str(SEED),
            "--tensor_model_parallel_size", "2",
            "--distributed_backend", "gloo",
            "--serve_num_slots", str(TP_SLOTS),
            "--serve_max_seq_len", str(TP_SEQ),
            "--tokenizer_type", "null", "--device", "cuda"]


def _argmax_tokens(torch, np, cfg, device):
    """7e(c)'s argmax probe: 1 x FALCON_SEQ ids from the seed."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, FALCON_SEQ))).to(device)


def _argmax_probe(torch, np, loop) -> dict:
    """7e(c)'s predicted ids at Falcon-40B's vocab width, on this rank of
    the tp2 + SP run: the run's model at its seeded init (this rank's
    slices), its logits [1, S, V/tp] over the probe tokens through the
    run's mesh, and the vocab-parallel argmax of them against
    torch.argmax of the logits gathered over the tensor group (the same
    values, so the same ids, ties included), also through the accuracy
    metric with the gathered ids as labels (exactly 1). The ids go to
    the record, held against the one-process plain path by
    _falcon_train_gates."""
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.ops.cross_entropy import vocab_parallel_argmax
    from megatron_tpu_torch.parallel.mappings import all_gather
    from megatron_tpu_torch.training.metrics import (
        finish_metrics, metric_sums,
    )

    cfg, mesh = loop.cfg.model, loop.mesh
    params = init_params(cfg, SEED, device=loop.device, mesh=mesh)
    tokens = _argmax_tokens(torch, np, cfg, loop.device)
    with torch.no_grad():
        local = lm_forward(cfg, params, tokens, mesh=mesh)
        ids = vocab_parallel_argmax(local, mesh)
        whole = all_gather(local, mesh.group("tensor"), dim=-1)
        want = whole.argmax(-1)
        top = whole.max(-1, keepdim=True).values
        half = whole.shape[-1] // 2
        cross = ((whole[..., :half] == top).any(-1)
                 & (whole[..., half:] == top).any(-1))
        acc = finish_metrics(("accuracy",), metric_sums(
            ("accuracy",), ids, want, torch.ones_like(ids),
            torch.zeros(ids.shape, device=ids.device)))["accuracy"]
        out = {"local_shape": list(local.shape),
               "ids_equal_gathered_argmax": bool(torch.equal(ids, want)),
               "accuracy_vs_gathered_argmax": float(acc),
               "tied_positions": int(((whole == top).sum(-1) > 1).sum()),
               "cross_shard_ties": int(cross.sum()),
               "ids": ids[0].tolist()}
    del params, local, whole
    return out


def _argmax_plain(torch, np, dataclasses, cfg) -> dict:
    """7e(c)'s one-process yardstick for the probe's ids: the plain
    path's bf16 logits over the probe tokens at the seeded init (kept on
    the host) and each position's bf16 band, the largest |bf16 plain -
    fp32 plain| logit difference there (phase 3's referee)."""
    from megatron_tpu_torch.models.language_model import lm_forward
    from megatron_tpu_torch.models.params import init_params

    plain = dataclasses.replace(cfg, attention_impl="xla")
    ref = dataclasses.replace(plain, params_dtype="float32")
    params = init_params(cfg, SEED, device="cuda")
    tokens = _argmax_tokens(torch, np, cfg, "cuda")
    with torch.no_grad():
        lb = lm_forward(plain, params, tokens)[0]
        params32 = _upcast(params)
        del params
        l32 = lm_forward(ref, params32, tokens)[0]
        band = (lb.float() - l32).abs().max(-1).values
        out = {"logits": lb.cpu(), "band": band.cpu()}
    del params32, lb, l32
    free_cuda(torch)
    return out


def _falcon_reference(torch) -> dict:
    """7e(c)'s one-process run of the same model, corpus and seed, and
    the argmax probe's plain logits."""
    import dataclasses

    import numpy as np

    from megatron_tpu_torch.tools import pretrain_gpt

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ref = pretrain_gpt.main(falcon_train_argv(corpus_prefix(), tp=False),
                            log=lambda m: None)
    torch.cuda.synchronize()
    out = {"losses": [r["loss"] for r in ref.step_records],
           "grad_norms": [h["grad_norm"] for h in ref.history],
           "evals": [dict(e) for e in ref.evals],
           "step_s": [r["step_s"] for r in ref.step_records],
           "wall_s": time.monotonic() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    cfg = ref.cfg.model
    del ref
    free_cuda(torch)
    out["argmax_plain"] = _argmax_plain(torch, np, dataclasses, cfg)
    return out


def mixtral_par_argv():
    """Phase 7f's training command line: phase 7's, at Mixtral's width,
    MIXTRAL_PAR_LAYERS and S MIXTRAL_PAR_SEQ."""
    argv = train_argv(corpus_prefix(), layers=MIXTRAL_PAR_LAYERS,
                      seq=MIXTRAL_PAR_SEQ, global_batch=PAR_GLOBAL,
                      iters=PAR_STEPS, eval_interval=PAR_STEPS)
    argv[argv.index("llama2-7B")] = MIXTRAL
    return argv


def _mixtral_par_reference(torch, pretrain_gpt, dispatch: str) -> dict:
    """7f's one-process run of one dispatch at micro-batch
    MIXTRAL_PAR_REF_MICRO (the cases' global microbatch)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ref = pretrain_gpt.main(mixtral_par_argv() + [
        "--micro_batch_size", str(MIXTRAL_PAR_REF_MICRO),
        "--moe_dispatch", dispatch], log=lambda m: None)
    torch.cuda.synchronize()
    out = {"losses": [r["loss"] for r in ref.step_records],
           "grad_norms": [h["grad_norm"] for h in ref.history],
           "moe_aux_losses": [h["moe_aux_loss"] for h in ref.history],
           "evals": [e["lm_loss"] for e in ref.evals],
           "step_s": [r["step_s"] for r in ref.step_records],
           "seq_length": ref.cfg.model.seq_length,
           "wall_s": time.monotonic() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del ref
    free_cuda(torch)
    return out


def _mixtral_par_gates(card, by_run, refs, total) -> list:
    """7f (a)-(c): each case's losses, grad norms and validation loss
    within phase 7's tolerances of its dispatch's one-process run, its
    moe_aux_loss beside the one process's (with its margin at
    PAR_LOSS_ATOL), the ranks' agreement, exact launches a rank, the step
    time, peak GiB a rank and the comm.* share of the traced step with
    comm.all_to_all apart. Adds the launches to `total`."""
    problems = []
    gloo = "gloo (CUDA tensors staged through host memory; not NCCL numbers)"
    for case, flags in MIXTRAL_PAR_CASES.items():
        recs = by_run[case]
        r0 = recs[0]
        ref = refs["dropless" if "dropless" in flags else "capacity"]
        micro = (int(flags[flags.index("--micro_batch_size") + 1])
                 if "--micro_batch_size" in flags else TRAIN_MICRO)
        n_micro = PAR_GLOBAL // r0["mesh"]["dp"] // micro
        want = _per_rank_launches(case, MIXTRAL_PAR_LAYERS, n_micro)
        launches = {}
        for rec in recs:
            _add_counts(launches, rec["launches"])
            if rec["launches"] != want:
                problems.append(f"{case} rank {rec['rank']} launches "
                                f"{rec['launches']} != {want}")
        _add_counts(total, launches)
        err = lambda a, b: max(abs(x - y) for x, y in zip(a, b))
        loss_err = err(r0["losses"], ref["losses"])
        aux_err = err(r0["moe_aux_losses"], ref["moe_aux_losses"])
        eval_err = err(r0["evals"], ref["evals"])
        norm_err = max(abs(a - b) / abs(b) for a, b in
                       zip(r0["grad_norms"], ref["grad_norms"]))
        comm = (_trace_card(r0["traces"][0]) if len(r0["traces"]) == 1
                else None)
        line = {"phase": "parallel_mixtral", "card": card, "case": case,
                "model": f"{MIXTRAL} x {MIXTRAL_PAR_LAYERS} layer",
                "reduced": MIXTRAL_PAR_REDUCED[:2],
                "seq_length": r0["seq_length"], "global_batch": PAR_GLOBAL,
                "flags": flags, "backend": gloo, "mesh": r0["mesh"],
                "losses": r0["losses"], "reference_losses": ref["losses"],
                "loss_err": loss_err, "loss_atol": PAR_LOSS_ATOL,
                "loss_margin": loss_err / PAR_LOSS_ATOL,
                "moe_aux_losses": r0["moe_aux_losses"],
                "reference_moe_aux_losses": ref["moe_aux_losses"],
                "moe_aux_err": aux_err,
                "moe_aux_margin": aux_err / PAR_LOSS_ATOL,
                "grad_norms": r0["grad_norms"],
                "reference_grad_norms": ref["grad_norms"],
                "grad_norm_rel_err": norm_err,
                "grad_norm_margin": norm_err / PAR_NORM_RTOL,
                "evals": r0["evals"], "eval_err": eval_err,
                "ranks_agree": all(
                    (r["losses"], r["grad_norms"], r["moe_aux_losses"])
                    == (r0["losses"], r0["grad_norms"], r0["moe_aux_losses"])
                    for r in recs),
                "step_s": r0["step_s"],
                "reference_step_s": ref["step_s"],
                "reference_peak_gib": ref["peak_gib"],
                "comm": comm, "launches": launches,
                "launches_per_rank_expected": want,
                "peak_gib_per_rank": [r["peak_gib"] for r in recs],
                "wall_s": r0["wall_s"]}
        emit(line)
        if not line["ranks_agree"]:
            problems.append(f"{case}: ranks disagree")
        if len(r0["losses"]) != PAR_STEPS or not all(
                map(math.isfinite, r0["losses"] + r0["moe_aux_losses"])):
            problems.append(f"{case}: losses {r0['losses']} aux "
                            f"{r0['moe_aux_losses']}")
        if r0["seq_length"] != ref["seq_length"]:
            problems.append(f"{case}: S {r0['seq_length']} != the "
                            f"reference's {ref['seq_length']}")
        for name, e, tol in (("loss", loss_err, PAR_LOSS_ATOL),
                             ("moe aux loss", aux_err, PAR_LOSS_ATOL),
                             ("validation loss", eval_err, PAR_LOSS_ATOL),
                             ("grad norm", norm_err, PAR_NORM_RTOL)):
            if not e <= tol:
                problems.append(f"{case}: {name} off by {e}")
        if comm is None or ("ep2" in case and "comm.all_to_all"
                            not in comm["comm_ms_by_op"]):
            problems.append(f"{case}: traces {r0['traces']}, comm {comm}")
    return problems


# phase 7's two-rank launch, which phases 7d and 7e share: the ranks'
# records and 7e(c)'s one-process run
PARALLEL_LAUNCH: dict = {}
# phase 7g's kernel launches, summed over its runs' ranks (the context-
# parallel path of the result line)
PARALLEL_CP: dict = {}


def _cp_reference(torch, pretrain_gpt, argv, card) -> dict:
    """7g's one-process run (--attention_impl pallas) at S CP_SEQ."""
    t0 = time.monotonic()
    ref = pretrain_gpt.main(list(argv), log=lambda m: None)
    torch.cuda.synchronize()
    want = {"losses": [r["loss"] for r in ref.step_records],
            "grad_norms": [h["grad_norm"] for h in ref.history],
            "evals": [e["lm_loss"] for e in ref.evals],
            "step_s": [r["step_s"] for r in ref.step_records],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "wall_s": time.monotonic() - t0}
    del ref
    free_cuda(torch)
    emit({"phase": "parallel_cp_reference", "card": card,
          "model": "llama2-7B", "layers": CP_LAYERS, "seq_length": CP_SEQ,
          **want})
    return want


def _cp_gates(card, by_run, want) -> list:
    """7g's cases against the one-process run: losses, grad norms and
    the validation loss within phase 7's gates, the ranks in agreement,
    and each rank's launches equal to the schedule's: the ring runs 2cp
    + 1 = 5 stripe pairs a layer and pass (B1 forward, B2 and B3
    backward), the gathered K/V and Ulysses one launch each."""
    problems = []
    PARALLEL_CP.clear()
    for case in CP_CASES:
        recs = by_run[case]
        r0 = recs[0]
        pairs = 2 * 2 + 1 if case.endswith("ring") else 1
        want_launch = {k: n * pairs for k, n in expected_train_launches(
            1, layers=CP_LAYERS, steps=CP_STEPS,
            eval_batches=len(r0["evals"]) * EVAL_ITERS).items()}
        for rec in recs:
            _add_counts(PARALLEL_CP, rec["launches"])
            if rec["launches"] != want_launch:
                problems.append(f"{case} rank {rec['rank']} launches "
                                f"{rec['launches']} != {want_launch}")
        loss_err = max((abs(a - b) for a, b in
                        zip(r0["losses"], want["losses"])), default=math.inf)
        norm_err = max((abs(a - b) / abs(b) for a, b in
                        zip(r0["grad_norms"], want["grad_norms"])),
                       default=math.inf)
        eval_err = max((abs(a - b) for a, b in
                        zip(r0["evals"], want["evals"])), default=math.inf)
        line = {"phase": "parallel_cp", "card": card, "case": case,
                "backend": "gloo (CUDA tensors staged through host memory; "
                           "not NCCL numbers)",
                "mesh": r0["mesh"], "seq_length": r0["seq_length"],
                "losses": r0["losses"], "grad_norms": r0["grad_norms"],
                "evals": r0["evals"], "reference": want,
                "ranks_agree": all(
                    (r["losses"], r["grad_norms"], r["evals"])
                    == (r0["losses"], r0["grad_norms"], r0["evals"])
                    for r in recs),
                "loss_err": loss_err, "loss_atol": PAR_LOSS_ATOL,
                "grad_norm_rel_err": norm_err,
                "grad_norm_rtol": PAR_NORM_RTOL, "eval_err": eval_err,
                "launches_by_rank": [r["launches"] for r in recs],
                "launches_per_rank_expected": want_launch,
                "step_s": r0["step_s"],
                "peak_gib_per_rank": [r["peak_gib"] for r in recs],
                "wall_s": r0["wall_s"]}
        emit(line)
        if not line["ranks_agree"]:
            problems.append(f"{case}: ranks disagree")
        if len(r0["losses"]) != CP_STEPS or not all(
                map(math.isfinite, r0["losses"])):
            problems.append(f"{case}: losses {r0['losses']}")
        if not loss_err <= PAR_LOSS_ATOL:
            problems.append(f"{case}: loss off by {loss_err}")
        if not norm_err <= PAR_NORM_RTOL:
            problems.append(f"{case}: grad norm off by {norm_err}")
        if not eval_err <= PAR_LOSS_ATOL:
            problems.append(f"{case}: validation loss off by {eval_err}")
    return problems


def parallel_serving(torch, np, ft, card):
    """Phases 7d and 7e, the serving parts of phase 7's launch of two
    gloo ranks sharing the card (rank_serve). 7d: Llama-2-7B's width x
    TP_SERVE_LAYERS served at tp2,
    phase 3's tokens of the tp2 engine and the one-shot request held
    against the one-process plain path by phase 3's teacher-forced gate.
    7e: the paged engine at tp2 (the same gate; B5 launches = layers x
    ticks a rank, B1 = B4 = 0; a preemption and a prefix hit), pp2
    one-shot serving (the gate; the scored batch within phase 3d's
    scoring gate; B1 = a stage's layers a scored batch), Falcon-40B width
    trained at tp2 + SP (losses, grad norms, validation loss and metrics
    against the one-process run of the same model, run first here; B1-B3
    as counted) and served at tp2 (the gate against the plain path; B1,
    B4 counted). Returns the launches summed over the ranks and parts."""
    import dataclasses

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params

    if "recs" not in PARALLEL_LAUNCH:
        raise AssertionError("phases 7d and 7e run in phase 7's launch, "
                             "which did not run")
    recs, ref_rec = PARALLEL_LAUNCH["recs"], PARALLEL_LAUNCH["falcon_ref"]
    problems = []
    r0 = recs[0]
    L = TP_SERVE_LAYERS
    want = {"flash_fwd": L * r0["prefills"], "flash_decode": L * r0["ticks"],
            "paged_flash_decode": 0}
    zero = {k: 0 for k in want}
    pg = r0["paged"]
    want_paged = dict(zero, paged_flash_decode=L * pg["ticks"])
    for rec in recs:
        if rec["launches"] != want:
            problems.append(f"rank {rec['rank']} launches "
                            f"{rec['launches']} != {want}")
        if rec["one_shot_launches"] != zero:
            problems.append(f"rank {rec['rank']} one-shot launches "
                            f"{rec['one_shot_launches']}")
        if rec["paged"]["launches"] != want_paged:
            problems.append(f"rank {rec['rank']} paged launches "
                            f"{rec['paged']['launches']} != {want_paged}")
    if pg["stats"]["preemptions"] < 1:
        problems.append("paged tp2: no preemption under the 147-page pool")
    if pg["stats"]["prefix_hits"] < 1:
        problems.append("paged tp2: no prefix hit")
    cfg = tp_serve_cfg(dataclasses, presets)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size - 1, size=n).tolist()
               for n in PROMPT_LENS]
    pipe = r0["pipelined"]
    params = init_params(cfg, SEED, device="cuda")
    tf = teacher_force(torch, dataclasses, cfg, params,
                       prompts + [prompts[1]],
                       r0["generated"] + [r0["one_shot_generated"]])
    tf_paged = teacher_force(torch, dataclasses, cfg, params, prompts,
                             pg["generated"])
    tf_pipe = teacher_force(torch, dataclasses, cfg, params, [prompts[1]],
                            [pipe["generated"]])
    pipe_score = _pp_gates(torch, np, dataclasses, cfg, params, prompts,
                           pipe, problems)
    del params
    free_cuda(torch)
    fcfg = falcon_serve_cfg(dataclasses, presets)
    frng = np.random.default_rng(SEED)
    fprompts = [frng.integers(0, fcfg.vocab_size - 1, size=n).tolist()
                for n in PROMPT_LENS]
    fs = r0["falcon_serve"]
    fparams = init_params(fcfg, SEED, device="cuda")
    tf_falcon = teacher_force(torch, dataclasses, fcfg, fparams, fprompts,
                              fs["generated"])
    del fparams
    free_cuda(torch)
    gloo = ("gloo (CUDA tensors staged through host memory; not NCCL "
            "numbers)")
    emit({"phase": "parallel_serving", "card": card,
          "model": "llama2-7B", "layers": L, "tp": 2, "backend": gloo,
          "slots": TP_SLOTS, "max_seq_len": TP_SEQ, "tick": "eager",
          "init_s_per_rank": [r["init_s"] for r in recs],
          "requests": [{"prompt_tokens": len(p), "wall_s": w}
                       for p, w in zip(prompts, r0["walls"])],
          "concurrent_wall_s": r0["concurrent_wall_s"],
          "ttft_mean_s": r0["ttft_mean_s"],
          "tick_wall_mean_s": r0["tick_wall_mean_s"],
          "per_token_mean_s": r0["per_token_mean_s"],
          "filled_tick": r0["tick"],
          "one_shot_wall_s": r0["one_shot_wall_s"],
          "prefills": r0["prefills"], "decode_ticks": r0["ticks"],
          "launches_per_rank": [r["launches"] for r in recs],
          "tick_launches_per_rank": [r["tick_launches"] for r in recs],
          "peak_gib_per_rank": [r["peak_gib"] for r in recs],
          "part_s": r0["part_s"], "wall_s": r0["launch_wall_s"], **tf})
    if tf["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"tp2 teacher-forced match "
                        f"{tf['teacher_forced_match']:.4f} < {MATCH_GATE}")
    keys = ("prefix_hits", "prefix_tokens_saved", "prefill_chunks",
            "preemptions", "ticks", "admitted", "retired")
    emit({"phase": "parallel_paged", "card": card, "model": "llama2-7B",
          "layers": L, "tp": 2, "backend": gloo, "slots": TP_SLOTS,
          "page_size": PAGE_SIZE, "prefill_chunk": TP_PREFILL_CHUNK,
          "pool_pages": PRESSURE_PAGES,
          "requests": [{"prompt_tokens": len(p), "wall_s": w}
                       for p, w in zip(prompts, pg["walls"])],
          "concurrent_wall_s": pg["concurrent_wall_s"],
          "ttft_mean_s": pg["ttft_mean_s"],
          "tick_wall_mean_s": pg["tick_wall_mean_s"],
          "per_token_mean_s": pg["per_token_mean_s"],
          "stats": {k: pg["stats"][k] for k in keys},
          "decode_ticks": pg["ticks"], "filled_tick": pg["tick"],
          "launches_per_rank": [r["paged"]["launches"] for r in recs],
          "tick_launches_per_rank": [r["paged"]["tick_launches"]
                                     for r in recs],
          **tf_paged})
    if tf_paged["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"paged tp2 teacher-forced match "
                        f"{tf_paged['teacher_forced_match']:.4f}")
    layers = pipe["layers_per_stage"]
    want_score = dict(zero, flash_fwd=layers)
    if pipe["score_launches"] != want_score:
        problems.append(f"pp2 stage 0 scoring launches "
                        f"{pipe['score_launches']} != {want_score}")
    if pipe["generate_launches"] != zero:
        problems.append(f"pp2 generation launches "
                        f"{pipe['generate_launches']}")
    follower = recs[1]["pipelined"]["follower_launches"]
    if follower != want_score:
        problems.append(f"pp2 stage 1 launches {follower} != {want_score}")
    emit({"phase": "pipelined_serving", "card": card, "model": "llama2-7B",
          "layers": L, "pp": 2, "backend": gloo,
          "layers_per_stage": layers,
          "init_s_per_rank": [r["pipelined"]["init_s"] for r in recs],
          "generate_wall_s": pipe["generate_wall_s"],
          "new_tokens": NEW_TOKENS, "score_wall_s": pipe["score_wall_s"],
          "scored_prompts": PROMPT_LENS, "comm": pipe["comm"],
          "launches": {"stage0_generate": pipe["generate_launches"],
                       "stage0_score": pipe["score_launches"],
                       "stage1_all": follower},
          "scoring": pipe_score, **tf_pipe})
    if tf_pipe["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"pp2 teacher-forced match "
                        f"{tf_pipe['teacher_forced_match']:.4f}")
    FL = FALCON_SERVE_LAYERS
    want_f = {"flash_fwd": FL * fs["prefills"],
              "flash_decode": FL * fs["ticks"], "paged_flash_decode": 0}
    for rec in recs:
        if rec["falcon_serve"]["launches"] != want_f:
            problems.append(f"falcon tp2 rank {rec['rank']} launches "
                            f"{rec['falcon_serve']['launches']} != {want_f}")
    emit({"phase": "parallel_falcon_serve", "card": card,
          "model": f"{FALCON40} x {FL} layers", "tp": 2, "backend": gloo,
          "init_s_per_rank": [r["falcon_serve"]["init_s"] for r in recs],
          "requests": [{"prompt_tokens": len(p), "wall_s": w}
                       for p, w in zip(fprompts, fs["walls"])],
          "ttft_mean_s": fs["ttft_mean_s"],
          "tick_wall_mean_s": fs["tick_wall_mean_s"],
          "prefills": fs["prefills"], "decode_ticks": fs["ticks"],
          "launches_per_rank": [r["falcon_serve"]["launches"]
                                for r in recs], **tf_falcon})
    if tf_falcon["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"falcon tp2 teacher-forced match "
                        f"{tf_falcon['teacher_forced_match']:.4f}")
    problems += _falcon_train_gates(torch, card, recs, ref_rec)
    problems += _mixtral_serve_gate(torch, np, card, recs)
    if problems:
        raise AssertionError("parallel serving: " + "; ".join(problems))
    total: dict = {}
    for rec in recs:
        for counts in (rec["launches"], rec["tick_launches"],
                       rec["one_shot_launches"], rec["paged"]["launches"],
                       rec["paged"]["tick_launches"],
                       rec["falcon_serve"]["launches"],
                       rec["falcon_train"]["launches"],
                       *(r["launches"]
                         for r in rec["mixtral_serve"].values())):
            _add_counts(total, counts)
        _add_counts(total, rec["pipelined"].get("score_launches")
                    or rec["pipelined"]["follower_launches"] or {})
    return total


def long_context_serving(torch, np, ft, card):
    """Phase 7h, the last part of phase 7's launch (rank_serve): (a) the
    context-parallel engine at cp2 (dense ring hops) held to the
    one-process plain path by phase 3's teacher-forced gate, each rank's
    B5 partial-form launches = layers x ticks (B1 = B4 = 0: the chunk's
    partial is the plain stripe path), engine_cp_ring_steps_total =
    layers x (ticks + chunks), the cp byte counters = the byte model's
    prices x ticks and chunks; (b) the same with int8 hops, its tokens by
    the same gate and beside (a)'s; (c) the tp2 engine with int8 TP
    collectives: the gate, B1 = layers x prefills and B4 = layers x
    ticks a rank, engine_comm_*_bytes = the byte model's tick price x
    ticks + each prefill's; (a)'s filled ticks' wall and comm.* share,
    (c)'s tick wall and tokens beside its dense run's. (c) has three
    gates: phase 3's gate against the uncompressed one-process plain
    path with each position's near-tie band widened by twice the int8
    collectives' own logit change there (measured on the ranks,
    _transport_error); that change at most TRANSPORT_BAND_RATIO x the
    largest bf16 band; and phase 3's gate with both plain passes through
    the same int8 collectives (the compressed function's own). Returns the launches by path (cp_serving, compressed_tp_serving),
    summed over the ranks."""
    import dataclasses

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params

    if "recs" not in PARALLEL_LAUNCH:
        raise AssertionError("phase 7h runs in phase 7's launch, which did "
                             "not run")
    recs = PARALLEL_LAUNCH["recs"]
    lc = [r["long_context"] for r in recs]
    cfg = tp_serve_cfg(dataclasses, presets)
    ccfg = cp_serve_cfg(cfg)
    prompts = cp_serve_prompts(np, cfg)
    problems = []
    params = init_params(ccfg, SEED, device="cuda")
    tfs = {m: teacher_force(torch, dataclasses, ccfg, params,
                            prompts, lc[0][m]["generated"])
           for m in ("dense", "int8")}
    tf_tp = teacher_force(torch, dataclasses, ccfg, params,
                          prompts[:len(PROMPT_LENS)],
                          lc[0]["tp_int8"]["generated"],
                          transport=lc[0]["tp_int8"]["transport"])
    del params
    free_cuda(torch)
    gloo = ("gloo (CUDA tensors staged through host memory; not NCCL "
            "numbers)")
    paths = {"cp_serving": {}, "compressed_tp_serving": {}}
    CL = CP_SERVE_LAYERS
    for mode in ("dense", "int8"):
        r0 = lc[0][mode]
        st = r0["stats"]
        ticks, chunks = st["ticks"], st["prefill_chunks"]
        want = {"flash_fwd": 0, "flash_decode": 0,
                "paged_flash_decode": CL * ticks}
        for r, rec in enumerate(lc):
            if rec[mode]["launches"] != want:
                problems.append(f"cp {mode} rank {r} launches "
                                f"{rec[mode]['launches']} != {want}")
            if rec[mode]["partial_launches"] != CL * ticks:
                problems.append(f"cp {mode} rank {r} partial-form launches "
                                f"{rec[mode]['partial_launches']} != "
                                f"{CL * ticks}")
            _add_counts(paths["cp_serving"], dict(
                rec[mode]["launches"],
                paged_flash_decode_lse=rec[mode]["partial_launches"]))
        if st["cp_ring_steps"] != CL * (ticks + chunks):
            problems.append(f"cp {mode}: cp_ring_steps {st['cp_ring_steps']}"
                            f" != {CL} x ({ticks} + {chunks})")
        for kind in ("dense", "compressed"):
            want_b = (ticks * r0["bytes_tick"][kind]
                      + chunks * r0["bytes_chunk"][kind])
            if st[f"cp_comm_{kind}_bytes"] != want_b:
                problems.append(f"cp {mode}: cp_comm_{kind}_bytes "
                                f"{st[f'cp_comm_{kind}_bytes']} != {want_b}")
        same = [a == b for x, y in zip(r0["generated"],
                                       lc[0]["dense"]["generated"])
                for a, b in zip(x, y)]
        line = {"phase": "cp_serving", "card": card, "model": "llama2-7B",
                "layers": CL, "cp": 2, "geometry": "ring (overlapped)",
                "hops": mode, "backend": gloo, "slots": CP_SERVE_SLOTS,
                "max_seq_len": CP_SERVE_SEQ, "page_size": PAGE_SIZE,
                "prefill_chunk": TP_PREFILL_CHUNK,
                "pool_pages_per_rank": r0["pool_pages_per_rank"],
                "requests": [{"prompt_tokens": len(p), "wall_s": w}
                             for p, w in zip(prompts, r0["walls"])],
                "concurrent_wall_s": r0["concurrent_wall_s"],
                "ttft_mean_s": r0["ttft_mean_s"],
                "tick_wall_mean_s": r0["tick_wall_mean_s"],
                "per_token_mean_s": r0["per_token_mean_s"],
                "decode_ticks": ticks, "prefill_chunks": chunks,
                "stats": {k: st[k] for k in (
                    "cp_ring_steps", "cp_comm_dense_bytes",
                    "cp_comm_compressed_bytes", "prefix_hits",
                    "preemptions", "admitted", "retired")},
                "bytes_tick": r0["bytes_tick"],
                "bytes_chunk": r0["bytes_chunk"],
                "launches_per_rank": [rec[mode]["launches"] for rec in lc],
                "partial_launches_per_rank": [rec[mode]["partial_launches"]
                                              for rec in lc],
                "tokens_equal_dense_hops": sum(same) / max(len(same), 1),
                "peak_gib_per_rank": [rec[mode]["peak_gib"] for rec in lc],
                "wall_s": r0["wall_s"], **tfs[mode]}
        if mode == "dense":
            line["filled_tick"] = lc[0]["tick"]
            line["filled_tick_partial_launches_per_rank"] = [
                rec["tick_partial_launches"] for rec in lc]
            for rec in lc:
                _add_counts(paths["cp_serving"], dict(
                    rec["tick_launches"],
                    paged_flash_decode_lse=rec["tick_partial_launches"]))
        emit(line)
        if tfs[mode]["teacher_forced_match"] < MATCH_GATE:
            problems.append(f"cp {mode} teacher-forced match "
                            f"{tfs[mode]['teacher_forced_match']:.4f}")
    t0, td = lc[0]["tp_int8"], lc[0]["tp_dense"]
    st = t0["stats"]
    want = {"flash_fwd": CL * t0["prefills"],
            "flash_decode": CL * t0["ticks"], "paged_flash_decode": 0}
    for r, rec in enumerate(lc):
        if rec["tp_int8"]["launches"] != want:
            problems.append(f"tp int8 rank {r} launches "
                            f"{rec['tp_int8']['launches']} != {want}")
        _add_counts(paths["compressed_tp_serving"],
                    rec["tp_int8"]["launches"])
    for kind in ("dense", "compressed"):
        want_b = (st["ticks"] * t0["bytes_tick"][kind]
                  + sum(b[kind] for b in t0["bytes_prefill"]))
        if st[f"comm_{kind}_bytes"] != want_b:
            problems.append(f"tp int8: comm_{kind}_bytes "
                            f"{st[f'comm_{kind}_bytes']} != {want_b}")
    same = [a == b for x, y in zip(t0["generated"], td["generated"])
            for a, b in zip(x, y)]
    tf_comp = t0["teacher_forced_compressed"]
    transport_max = max(max(t) for t in t0["transport"])
    transport_limit = TRANSPORT_BAND_RATIO * tf_tp["teacher_forced_band_max"]
    emit({"phase": "compressed_tp_serving", "card": card,
          "model": "llama2-7B", "layers": CL, "tp": 2,
          "compress_collectives": "int8", "backend": gloo,
          "requests": [{"prompt_tokens": len(p), "wall_s": w}
                       for p, w in zip(prompts, t0["walls"])],
          "ttft_mean_s": t0["ttft_mean_s"],
          "tick_wall_mean_s": t0["tick_wall_mean_s"],
          "prefills": t0["prefills"], "decode_ticks": t0["ticks"],
          "comm_dense_bytes": st["comm_dense_bytes"],
          "comm_compressed_bytes": st["comm_compressed_bytes"],
          "bytes_tick": t0["bytes_tick"],
          "tick_wall_mean_s_dense": td["tick_wall_mean_s"],
          "ttft_mean_s_dense": td["ttft_mean_s"],
          "tokens_equal_dense": sum(same) / max(len(same), 1),
          "launches_per_rank": [rec["tp_int8"]["launches"] for rec in lc],
          "transport_logit_change_max": transport_max,
          "transport_logit_change_limit": transport_limit,
          **tf_tp, "teacher_forced_compressed": tf_comp})
    if tf_tp["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"tp int8 teacher-forced match against the "
                        f"uncompressed path "
                        f"{tf_tp['teacher_forced_match']:.4f}")
    if transport_max > transport_limit:
        problems.append(f"tp int8: the collectives' logit change "
                        f"{transport_max:.4g} > {TRANSPORT_BAND_RATIO} x "
                        f"the bf16 band {transport_limit:.4g}")
    if tf_comp["teacher_forced_match"] < MATCH_GATE:
        problems.append(f"tp int8 teacher-forced match through the "
                        f"compressed path "
                        f"{tf_comp['teacher_forced_match']:.4f}")
    emit({"phase": "long_context_part_s", "card": card,
          "seconds": recs[0]["part_s"].get("7h"),
          "init_s": lc[0]["init_s"]})
    if problems:
        raise AssertionError("long-context serving: " + "; ".join(problems))
    return paths


def _argmax_gate(torch, recs, plain, problems) -> dict:
    """7e(c)'s predicted ids: on each rank equal to torch.argmax of the
    gathered logits (and the accuracy against them 1), the same on both
    ranks, and against the one-process plain path at phase 3's gate: a
    position agrees when the id is the plain bf16 argmax or a near-tie
    within that position's bf16 band. A random-init model's accuracy on
    real labels is about 0 whatever the argmax does, so this, not the
    accuracy metric, is what holds the argmax at Falcon-40B's vocab
    width on the card."""
    probes = [rec["falcon_train"]["probe"] for rec in recs]
    for rec, p in zip(recs, probes):
        if not (p["ids_equal_gathered_argmax"]
                and p["accuracy_vs_gathered_argmax"] == 1.0):
            problems.append(
                f"falcon training rank {rec['rank']}: vocab-parallel argmax "
                f"!= argmax of the gathered logits "
                f"(accuracy {p['accuracy_vs_gathered_argmax']})")
        if p["ids"] != probes[0]["ids"]:
            problems.append("falcon argmax: ranks disagree")
    lb = plain["logits"].float()
    ids = torch.tensor(probes[0]["ids"])
    gap = lb.max(-1).values - lb.gather(1, ids[:, None])[:, 0]
    match = float((gap <= plain["band"]).float().mean())
    if match < MATCH_GATE:
        problems.append(f"falcon argmax vs one process {match:.4f} < "
                        f"{MATCH_GATE}")
    return {"positions": len(probes[0]["ids"]),
            "local_logits_shape": probes[0]["local_shape"],
            "ids_equal_gathered_argmax": [p["ids_equal_gathered_argmax"]
                                          for p in probes],
            "tied_positions": probes[0]["tied_positions"],
            "cross_shard_ties": probes[0]["cross_shard_ties"],
            "match_vs_one_process": match,
            "strict_match_vs_one_process": float(
                (lb.argmax(-1) == ids).float().mean()),
            "worst_gap": float(gap.max())}


def _mixtral_serve_gate(torch, np, card, recs) -> list:
    """7f(d): the tp2 engine's fp32 tokens against the one-process fp32
    plain path's teacher-forced argmax at MIXTRAL_FP32_GATE (phase 5c's
    gate), the bf16 run's phase-3 near-tie rate beside it (ungated), and
    no kernel launch on either run (the dense attention)."""
    import dataclasses

    from megatron_tpu_torch.models import presets
    from megatron_tpu_torch.models.params import init_params

    problems = []
    runs = recs[0]["mixtral_serve"]
    zero = dict.fromkeys(("flash_fwd", "flash_decode",
                          "paged_flash_decode"), 0)
    for rec in recs:
        for dtype, run in rec["mixtral_serve"].items():
            if run["launches"] != zero:
                problems.append(f"mixtral tp2 {dtype} rank {rec['rank']} "
                                f"launches {run['launches']}")
    rates = {}
    for dtype in ("float32", "bfloat16"):
        cfg = mixtral_serve_cfg(dataclasses, presets, dtype)
        prompts = mixtral_prompts(np, cfg)
        params = init_params(cfg, SEED, device="cuda")
        rates[dtype] = (
            _argmax_rate(torch, cfg, params, prompts,
                         runs[dtype]["generated"]) if dtype == "float32"
            else teacher_force(torch, dataclasses, cfg, params, prompts,
                               runs[dtype]["generated"]))
        del params
        free_cuda(torch)
    fp32 = rates["float32"]
    rate = fp32["agree"] / fp32["positions"]
    emit({"phase": "parallel_mixtral_serve", "card": card,
          "model": f"{MIXTRAL} x {MIXTRAL_PAR_SERVE_LAYERS} layers",
          "reduced": MIXTRAL_PAR_REDUCED[2], "tp": 2, "engine": "dense",
          "attention": "dense (xla)",
          "backend": "gloo (CUDA tensors staged through host memory; not "
                     "NCCL numbers)",
          "init_s_per_rank": {d: [r["mixtral_serve"][d]["init_s"]
                                  for r in recs] for d in runs},
          "ttft_mean_s": {d: r["ttft_mean_s"] for d, r in runs.items()},
          "tick_wall_mean_s": {d: r["tick_wall_mean_s"]
                               for d, r in runs.items()},
          "fp32_teacher_forced_argmax": rate,
          "fp32_gate": MIXTRAL_FP32_GATE,
          "fp32_positions": fp32["positions"], "fp32_misses": fp32["misses"],
          "bf16_ungated": rates["bfloat16"]})
    if rate < MIXTRAL_FP32_GATE:
        problems.append(f"mixtral tp2 fp32 teacher-forced argmax "
                        f"{rate:.4f} < {MIXTRAL_FP32_GATE}")
    return problems


def _falcon_train_gates(torch, card, recs, ref) -> list:
    """7e(c): each rank's losses, grad norms, validation loss and metrics
    against the one-process run (phase 7's tolerances: the bf16 partial
    sums of tp2's row-parallel products; perplexity relative, accuracy
    absolute), the ranks' agreement, each rank's launches, and the
    predicted ids (_argmax_gate)."""
    problems = []
    argmax = _argmax_gate(torch, recs, ref["argmax_plain"], problems)
    r0 = recs[0]["falcon_train"]
    n_micro = PAR_GLOBAL // r0["mesh"]["dp"] // TRAIN_MICRO
    want = _per_rank_launches("tp2_sp", FALCON_TRAIN_LAYERS, n_micro)
    for rec in recs:
        got = rec["falcon_train"]
        if got["launches"] != want:
            problems.append(f"falcon training rank {rec['rank']} launches "
                            f"{got['launches']} != {want}")
        if (got["losses"], got["grad_norms"], got["evals"]) != (
                r0["losses"], r0["grad_norms"], r0["evals"]):
            problems.append("falcon training: ranks disagree")
    loss_err = max(abs(a - b) for a, b in zip(r0["losses"], ref["losses"]))
    norm_err = max(abs(a - b) / abs(b)
                   for a, b in zip(r0["grad_norms"], ref["grad_norms"]))
    metric_err = {}
    for got, exp in zip(r0["eval_metrics"], ref["evals"]):
        for k in ("lm_loss",) + FALCON_METRICS:
            e = abs(got[k] - exp[k])
            if k == "perplexity":
                e /= abs(exp[k])
            metric_err[k] = max(metric_err.get(k, 0.0), e)
    emit({"phase": "parallel_falcon_train", "card": card,
          "model": f"{FALCON40} x {FALCON_TRAIN_LAYERS} layers",
          "seq_length": r0["seq_length"], "global_batch": PAR_GLOBAL,
          "mesh": r0["mesh"], "sequence_parallel": True,
          "backend": "gloo (CUDA tensors staged through host memory; not "
                     "NCCL numbers)",
          "losses": r0["losses"], "reference_losses": ref["losses"],
          "loss_err": loss_err, "loss_atol": PAR_LOSS_ATOL,
          "grad_norms": r0["grad_norms"],
          "reference_grad_norms": ref["grad_norms"],
          "grad_norm_rel_err": norm_err,
          "evals": r0["eval_metrics"], "reference_evals": ref["evals"],
          "metric_err": metric_err, "argmax": argmax,
          "step_s": r0["step_s"],
          "reference_step_s": ref["step_s"],
          "reference_wall_s": ref["wall_s"],
          "reference_peak_gib": ref["peak_gib"],
          "peak_gib_per_rank": [r["falcon_train"]["peak_gib"]
                                for r in recs],
          "launches_per_rank": [r["falcon_train"]["launches"] for r in recs],
          "launches_per_rank_expected": want, "wall_s": r0["wall_s"]})
    if not (len(r0["losses"]) == PAR_STEPS
            and all(map(math.isfinite, r0["losses"]))):
        problems.append(f"falcon training losses {r0['losses']}")
    if not loss_err <= PAR_LOSS_ATOL:
        problems.append(f"falcon training loss off by {loss_err}")
    if not norm_err <= PAR_NORM_RTOL:
        problems.append(f"falcon training grad norm off by {norm_err}")
    if not (metric_err and all(e <= PAR_LOSS_ATOL
                               for e in metric_err.values())):
        problems.append(f"falcon validation metrics off by {metric_err}")
    return problems


def free_cuda(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=()) -> int:
    """argv: empty (every phase; the run that prints the result), or
    `--phases name,name,...` to run only those phases (by the names of
    `seconds_by_phase`), which prints no result and exits 1."""
    only = None
    if list(argv[:1]) == ["--phases"] and len(argv) == 2:
        only = set(argv[1].split(","))
    elif argv:
        print(f"chip_smoke: unknown arguments {list(argv)}", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from megatron_tpu_torch.ops.flash import build
        from megatron_tpu_torch.ops.flash import flash_template as ft
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = card_line()
        emit({"phase": "device", "card": card,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        t0 = time.monotonic()
        built = build.build()
        emit({"phase": "build", "card": card,
              "wall_s": time.monotonic() - t0,
              "kernels": {n: {"seconds": b["seconds"], "ptxas": b["ptxas"]}
                          for n, b in built.items()}})
    except Exception:  # noqa: BLE001 - nothing runs without the kernels
        traceback.print_exc()
        return 1

    failed, results, seconds = [], {}, {}
    t_start = time.monotonic()

    def phase(name, fn, *args):
        if only is not None and name not in only:
            return
        t0 = time.monotonic()
        try:
            results[name] = fn(*args)
        except Exception:  # noqa: BLE001 - any failed phase fails the run
            traceback.print_exc()
            failed.append(name)
        free_cuda(torch)
        seconds[name] = time.monotonic() - t0
        emit({"phase": "seconds", "name": name, "seconds": seconds[name],
              "failed": name in failed})

    phase("flash_fwd", check_flash_fwd, torch, F, ft, card)
    phase("flash_decode", check_flash_decode, torch, F, ft, card)
    phase("paged_flash_decode", check_paged_flash_decode, torch, F, ft, card)
    phase("paged_flash_decode_lse", paged_partial, torch, F, ft, card)
    phase("flash_bwd", check_flash_bwd, torch, F, ft, card)
    phase("serving", serve, torch, ft, card)
    phase("paged_serving", serve_paged, torch, ft, card,
          results.get("serving", {}).get("generated"))
    phase("speculative_serving", serve_speculative, torch, ft, card,
          results.get("serving", {}).get("generated"))
    phase("serving_control", serve_control, torch, ft, card,
          results.get("serving", {}).get("generated"))
    phase("weight_quant", weight_quant_serving, torch, ft, card,
          results.get("serving", {}).get("generated"))
    if only is None or {"text_serving", "training", "memory_proofs"} & only:
        start_memory_fit()
    phase("text_serving", text_serving, torch, np, ft, card)
    phase("training", train, torch, np, ft, card)
    phase("kernel_vs_dense_step", step_vs_dense, torch, np, ft, card)
    phase("fp8_training", fp8_training, torch, np, ft, card)
    phase("memory_proofs", memory_proofs, card)
    phase("finetune", finetune, torch, np, ft, card)
    phase("families", families, torch, np, ft, card)
    phase("mixtral", mixtral, torch, np, ft, card)
    phase("encoder_families", encoder_families, torch, np, ft, card)
    phase("loop", loop_and_data, torch, np, ft, card)
    phase("parallel", parallel_training, torch, np, ft, card)
    phase("parallel_serving", parallel_serving, torch, np, ft, card)
    phase("long_context_serving", long_context_serving, torch, np, ft, card)
    if PARALLEL_LAUNCH.get("recs"):
        # 7h's seconds inside phase 7's launch (rank 0's part)
        seconds["parallel/7h_in_launch"] = PARALLEL_LAUNCH["recs"][0][
            "part_s"].get("7h")
    emit({"phase": "seconds_by_phase", "seconds": seconds,
          "total_s": time.monotonic() - t_start,
          "build_s": t_start - t0})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if only is not None:
        print(f"chip_smoke: ran only {sorted(only)}; no result",
              file=sys.stderr)
        return 1

    paths = {"serving": results["serving"]["launches"],
             "paged_serving": results["paged_serving"],
             "speculative_serving": results["speculative_serving"],
             "serving_control": results["serving_control"],
             "weight_quant": results["weight_quant"],
             "text_serving": results["text_serving"],
             "training": results["training"],
             "fp8_training": results["fp8_training"],
             "finetune": results["finetune"],
             "families": results["families"],
             "mixtral": results["mixtral"],
             "loop": results["loop"],
             "parallel": results["parallel"],
             "context_parallel": PARALLEL_CP,
             "parallel_serving": results["parallel_serving"],
             **results["long_context_serving"]}
    reports = {"flash_fwd": results["flash_fwd"],
               "flash_decode": results["flash_decode"],
               "paged_flash_decode": results["paged_flash_decode"],
               "paged_flash_decode_lse": results["paged_flash_decode_lse"],
               **results["flash_bwd"]}
    kernels = []
    for name, source, line in (("flash_fwd", "flash_fwd.cu", 92),
                               ("flash_decode", "flash_decode.cu", 419),
                               ("paged_flash_decode", "flash_decode.cu", 553),
                               ("paged_flash_decode_lse", "flash_decode.cu",
                                553),
                               ("flash_bwd_dq", "flash_bwd_dq.cu", 197),
                               ("flash_bwd_dkv", "flash_bwd_dkv.cu", 235)):
        rep = reports[name]
        by_path = {path: counts.get(name, 0)
                   for path, counts in paths.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"megatron_tpu_torch/csrc/{source}",
            "replaces": f"{TPU_KERNELS}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "device_ms": rep["device_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "shape": rep["shape"],
            "tflops": rep["tflops"], "bound_share": rep["bound_share"]})
    emit({"kernels": kernels, "card": card})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--kernel-child":
        sys.exit(kernel_child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) > 2 and sys.argv[1] in ("--rank-run", "--rank-serve"):
        rest = sys.argv[3:]
        rest = rest[1:] if rest[:1] == ["--"] else rest
        runs = [[]]
        for a in rest:
            if a == "--then":
                runs.append([])
            else:
                runs[-1].append(a)
        if sys.argv[1] == "--rank-serve":
            sys.exit(rank_serve(sys.argv[2], runs))
        sys.exit(rank_run(sys.argv[2], runs))
    sys.exit(main(sys.argv[1:]))
