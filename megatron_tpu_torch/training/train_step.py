"""The training step: microbatch gradient accumulation + optimizer
(counterpart of megatron_tpu/training/train_step.py).

train_step(state, batch) splits the global batch's leading axis into
microbatches, runs forward and backward on each, accumulates the
gradients in fp32 (the reference's accumulate_allreduce_grads_in_fp32 /
main_grad) in buffers allocated once per step function, averages them
and applies the optimizer. Everything stays on the device: the metrics
are device tensors, and reading them is the caller's one host sync.

Across ranks (a MeshRuntime as `mesh`): the microbatches are this data
rank's rows, and the forward and backward run through the tensor
parallel model code, or with pipeline parallelism through the 1F1B or
interleaved schedule of training/pipeline.py, which calls back after
every microbatch's backward to move the grads into the same fp32
accumulators. After the accumulation, reduce_grads:
  * under sequence parallelism sums over the tensor group the grads of
    the leaves tensor parallelism leaves whole (norm scales and biases,
    row-parallel biases, embed/pos): each rank's backward saw only its
    sequence chunk; at any tp > 1 so for the MoE leaves without a
    tensor axis (the router, the experts' b_out): they sit after the
    block's entry, so each tensor rank holds a partial sum
    (ops/moe.py); the task heads that read the [CLS] row
    (models/params.REPLICATED_HEADS) are whole on every tensor rank and
    are not summed;
  * for a task tree (the TrainLoop hooks') under pipeline parallelism,
    sums over the pipe group every leaf its spec does not cut over
    "pipe": every stage holds it, and each stage's backward holds its
    own uses (T5's embedding on the first stage and its tied logits and
    final norms on the last, training/t5_pipeline.py);
  * with tied embeddings and pp > 1 sums embed/tokens over the
    embedding group (the first stage's copy and the last stage's);
  * under context parallelism sums every leaf over the context group:
    each rank's backward holds its piece of the sequence's share (the
    loss a rank backpropagates is its tokens' part of the sequence's
    mean, models/language_model.loss_mean);
  * averages over the batch ranks: a leaf's gradient is summed over the
    ranks it is replicated on, data x expert (the batch group), or the
    data ranks alone for an expert leaf (each expert rank's backward
    already holds every expert-group rank's rows, brought home by the
    all-to-all), then divided by dp, the number of losses the global
    loss averages; under ZeRO-1 the sum is a reduce-scatter into this
    rank's optimizer shard over the same group.
Dropout (the model config's rates above 0): microbatch i of the step
at state.step trains under the key path RngStreams(seed).dropout(step)
.fold_in(i) (parallel/random.py), the JAX step's; the pipeline takes
the step's key and folds the microbatch in its own way
(training/pipeline.py). Reading the step costs one host read a step
with dropout on; a replayed, rolled-back or resumed step draws the
masks it drew before, as they are functions of the seed and the step.
The loss metric is the mean over the batch ranks of the microbatch
losses (each pipeline stage's share summed over the pipe group: the
last stage's CE and every stage's router loss; each context rank's share
summed over the context group), the same number on every rank; a MoE
model's moe_aux_loss is agreed the same way.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from megatron_tpu_torch.config import (ModelConfig, OptimizerConfig,
                                       TrainingConfig)
from megatron_tpu_torch.models.language_model import lm_forward, lm_loss
from megatron_tpu_torch.models.params import replicated_head
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.parallel.mappings import all_reduce, reduce_scatter
from megatron_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT, AXIS_PIPE, AXIS_TENSOR, BATCH_AXES,
)
from megatron_tpu_torch.parallel.random import RngStreams
from megatron_tpu_torch.parallel.sharding import spec_axes, zero1_axes
from megatron_tpu_torch.training.optimizer import (
    TrainState, nest_paths, leaf_paths, make_optimizer_step, tree_map,
    zero1_layout,
)


def reduce_grads(grads: Any, model_cfg: ModelConfig,
                 opt_cfg: OptimizerConfig, mesh, layout,
                 task: bool = False) -> Any:
    """The cross-rank sums of the accumulated fp32 grads (the module
    docstring). Returns the tree the optimizer takes: whole leaves
    reduced in place, ZeRO-1 leaves as this rank's (new) shards. task:
    the grads are a task tree's (models/params.TaskTree)."""
    zdims = zero1_layout(opt_cfg, mesh, layout)
    out = {}
    for path, g in leaf_paths(grads):
        spec = layout[path][0]
        if mesh.tp > 1 and AXIS_TENSOR not in spec_axes(spec) and (
                (mesh.sequence_parallel and not replicated_head(path))
                or path.startswith("layers/moe/")):
            g.copy_(all_reduce(g, mesh.group("tensor")))
        if task:
            if mesh.pp > 1 and AXIS_PIPE not in spec_axes(spec):
                g.copy_(all_reduce(g, mesh.group(AXIS_PIPE)))
        elif (path == "embed/tokens" and model_cfg.tie_embed_logits
              and mesh.pp > 1):
            g.copy_(all_reduce(g, mesh.embedding_group))
        if mesh.cp > 1:
            g.copy_(all_reduce(g, mesh.group(AXIS_CONTEXT)))
        if mesh.dp > 1:
            axes = zero1_axes(spec)
            if path in zdims:
                g = reduce_scatter(g, mesh.group(axes), zdims[path][0])
            elif mesh.group(axes) is not None:
                g.copy_(all_reduce(g, mesh.group(axes)))
            # every leaf's gradient is the mean of the dp ranks' losses
            g.div_(mesh.dp)
        out[path] = g
    return nest_paths(out)


def agreed_loss(losses, mesh, device) -> torch.Tensor:
    """Mean of the microbatch losses, agreed over every rank: each
    pipeline stage's share (the last stage's CE, every stage's router
    loss) summed over the pipe group and each context rank's over the
    context group, then averaged over the batch ranks."""
    loss = (torch.stack(losses).mean() if losses
            else torch.zeros((), dtype=torch.float32, device=device))
    if mesh is None or mesh.world_size == 1:
        return loss
    if mesh.pp > 1:
        loss = all_reduce(loss, mesh.group("pipe"))
    if mesh.cp > 1:
        loss = all_reduce(loss, mesh.group(AXIS_CONTEXT))
    if mesh.dp > 1:
        loss = all_reduce(loss, mesh.group(BATCH_AXES)) / mesh.dp
    return loss


def make_train_step(
    model_cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    train_cfg: TrainingConfig,
    num_microbatches: int,
    train_iters: Optional[int] = None,
    loss_fn: Optional[Callable] = None,
    mesh=None,
    tree=None,
    pipeline_factory: Optional[Callable] = None,
    mask_source: Optional[Callable] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build train_step(state, batch) -> (state, metrics).

    batch leaves are [num_microbatches * micro_batch, ...]. loss_fn(cfg,
    params, microbatch, mesh=mesh) -> (loss, aux) defaults to lm_loss
    with the configured recompute policy. tree: the state holds a task
    tree (models/params.TaskTree; None: the decoder table).
    pipeline_factory(cfg, mesh, num_microbatches, recompute) at pp > 1
    builds the schedule object (training/pipeline.Pipeline's
    forward_backward and forward_only) that runs a task loss through the
    pipe (T5's, training/t5_pipeline.py); without one a loss_fn at
    pp > 1 is refused, as the JAX loop refuses it. The state's params
    must require grad;
    the state is updated in place and returned. metrics: loss (mean over
    microbatches, a MoE model's router aux loss included), grad_norm, lr,
    skipped, skip_streak (+ loss_scale with an fp16 scaler, and
    moe_aux_loss, the aux part's mean, for a MoE model). mesh: a multi-rank run (the module docstring); the
    batch is then this data rank's rows and state.params its slices.
    With dropout on, loss_fn is called with dropout_key= the
    microbatch's key path (the module docstring), whose masks
    mask_source draws (parallel/random.RngStreams; None: the default
    generator source)."""
    from megatron_tpu_torch.models.params import leaf_layout

    recompute = train_cfg.recompute_granularity
    if (loss_fn is not None and mesh is not None and mesh.pp > 1
            and pipeline_factory is None):
        raise ValueError(TASK_LOSS_PP_REFUSAL)
    loss_fn = loss_fn or (lambda cfg, p, b, mesh=None, dropout_key=None:
                          lm_loss(cfg, p, b, recompute=recompute, mesh=mesh,
                                  dropout_key=dropout_key))
    drop = model_cfg.hidden_dropout > 0 or model_cfg.attention_dropout > 0
    streams = RngStreams(train_cfg.seed, mask_source=mask_source)
    multi = mesh is not None and mesh.world_size > 1
    layout = (leaf_layout(model_cfg, mesh, opt_cfg.use_distributed_optimizer,
                          tree=tree)
              if multi else None)
    opt_apply = make_optimizer_step(opt_cfg,
                                    train_iters or train_cfg.train_iters or 1,
                                    mesh=mesh if multi else None,
                                    layout=layout)
    pipeline = None
    if mesh is not None and mesh.pp > 1:
        from megatron_tpu_torch.training.pipeline import Pipeline

        pipeline = (pipeline_factory or Pipeline)(
            model_cfg, mesh, num_microbatches, recompute)
    acc: Dict[str, Any] = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        n = num_microbatches
        gbs = next(iter(batch.values())).shape[0]
        if gbs % n:
            raise ValueError(f"batch of {gbs} not divisible into {n} "
                             "microbatches")
        mbs = gbs // n
        if not acc:
            # allocated once per step function: with fp32 Adam state this
            # is the largest buffer a step touches besides the state
            acc["tree"] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
        grads = acc["tree"]
        for _, a in leaf_paths(grads):
            a.zero_()
        params = [p for _, p in leaf_paths(state.params)]
        accs = [a for _, a in leaf_paths(grads)]
        scale = state.scaler.scale if state.scaler is not None else None

        @torch.no_grad()
        def accumulate():
            for a, p in zip(accs, params):
                if p.grad is not None:
                    a.add_(p.grad)
                    p.grad = None

        key = streams.dropout(int(state.step)) if drop else None
        if pipeline is not None:
            losses, moe_aux = pipeline.forward_backward(
                state.params, batch, scale, accumulate, dropout_key=key)
        else:
            losses, moe_aux = [], []
            for i in range(n):
                mb = {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
                kw = {} if key is None else {"dropout_key": key.fold_in(i)}
                loss, aux = loss_fn(model_cfg, state.params, mb, mesh=mesh,
                                    **kw)
                (loss * scale if scale is not None else loss).backward()
                accumulate()
                losses.append(loss.detach())
                if "moe_aux_loss" in aux:
                    moe_aux.append(aux["moe_aux_loss"].detach())
        with torch.no_grad():
            # mean over microbatches; scaled grads stay scaled for the
            # optimizer, which unscales them
            for a in accs:
                a.div_(n)
            if multi:
                grads = reduce_grads(grads, model_cfg, opt_cfg, mesh, layout,
                                     task=tree is not None)
        state, metrics = opt_apply(state, grads)
        metrics["loss"] = (agreed_loss(losses, mesh, accs[0].device)
                           if multi else torch.stack(losses).mean())
        if model_cfg.num_experts is not None and (moe_aux or multi):
            # the router's share of the loss, agreed as the loss is
            metrics["moe_aux_loss"] = (
                agreed_loss(moe_aux, mesh, accs[0].device) if multi
                else torch.stack(moe_aux).mean())
        return state, metrics

    return train_step


def make_eval_step(model_cfg: ModelConfig, train_cfg: TrainingConfig,
                   mesh=None):
    """Forward-only LM loss (the JAX package's eval_step):
    eval_step(params, batch) -> {"lm_loss", "ntokens", and each of
    train_cfg.metrics (training/metrics.py)}, device tensors. With a
    multi-rank mesh the same numbers are agreed over every rank: the
    tensor-parallel model (the vocab-parallel CE and argmax), or the
    pipeline's forward-only pass whose last stage computes them, then
    the loss's mean over the data ranks and the metrics' token sums
    over the pipe and data ranks."""
    from megatron_tpu_torch.training.metrics import compute_metrics

    if mesh is not None and mesh.world_size > 1:
        return _parallel_eval_step(model_cfg, train_cfg, mesh)

    @torch.no_grad()
    def eval_step(params: Any, batch: Dict[str, torch.Tensor]):
        logits = lm_forward(model_cfg, params, batch["tokens"],
                            positions=batch.get("position_ids"))
        loss_mask = batch.get("loss_mask")
        if loss_mask is None:
            loss_mask = torch.ones(batch["labels"].shape,
                                   dtype=torch.float32,
                                   device=batch["labels"].device)
        loss, per_token = cross_entropy_loss(logits, batch["labels"],
                                             loss_mask=loss_mask)
        out = {"lm_loss": loss, "ntokens": loss_mask.sum()}
        out.update(compute_metrics(train_cfg.metrics, logits,
                                   batch["labels"], loss_mask, per_token))
        return out

    return eval_step


def make_task_eval_step(model_cfg: ModelConfig, loss_fn: Callable,
                        mesh=None, pipeline_factory: Optional[Callable] = None,
                        micro_batch_size: int = 1):
    """A task model's forward-only loss (the JAX package's task_eval_step):
    eval_step(params, batch) -> {"lm_loss": loss_fn's loss, and every
    other entry of its aux}, device tensors. With a multi-rank mesh each
    number is agreed over every rank as _parallel_eval_step agrees the
    LM loss: the mean over the batch ranks (a pipeline's forward-only
    pass through pipeline_factory's schedule, its loss summed over the
    pipe group first; the pipeline reports the loss alone)."""
    multi = mesh is not None and mesh.world_size > 1
    pipelines: Dict[int, Any] = {}

    @torch.no_grad()
    def eval_step(params: Any, batch: Dict[str, torch.Tensor]):
        if multi and mesh.pp > 1:
            rows = next(iter(batch.values())).shape[0]
            m = max(rows // micro_batch_size, 1)
            if m not in pipelines:
                pipelines[m] = pipeline_factory(model_cfg, mesh, m)
            loss = pipelines[m].forward_only(params, batch)
            dev = next(iter(batch.values())).device
            return {"lm_loss": agreed_loss(
                [] if loss is None else [loss], mesh, dev)}
        loss, aux = loss_fn(model_cfg, params, batch, mesh=mesh)
        out = {"lm_loss": loss}
        out.update({k: v for k, v in aux.items() if k != "loss"})
        if multi:
            out = {k: agreed_loss([v.float()], mesh, v.device)
                   for k, v in out.items()}
        return out

    return eval_step


TASK_LOSS_PP_REFUSAL = (
    "pipeline parallelism drives the built-in LM loss through the pipe "
    "schedule; task losses (BERT/ICT/classification) would silently "
    "train unpipelined — use tensor/data/context parallelism for them, "
    "or supply a pipeline_loss_factory (T5 has one: "
    "training/t5_pipeline.py)")


def _parallel_eval_step(model_cfg: ModelConfig, train_cfg: TrainingConfig,
                        mesh):
    from megatron_tpu_torch.models.language_model import _ce, loss_mean
    from megatron_tpu_torch.ops.cross_entropy import vocab_parallel_argmax
    from megatron_tpu_torch.training.metrics import (
        finish_metrics, metric_sums,
    )

    names = tuple(train_cfg.metrics)
    pipelines: Dict[int, Any] = {}

    @torch.no_grad()
    def eval_step(params: Any, batch: Dict[str, torch.Tensor]):
        rows = batch["tokens"].shape[0]
        loss_mask = batch.get("loss_mask")
        if loss_mask is None:
            loss_mask = torch.ones(batch["labels"].shape,
                                   dtype=torch.float32,
                                   device=batch["labels"].device)
        sums = None
        if mesh.pp > 1:
            from megatron_tpu_torch.training.pipeline import Pipeline

            m = rows // train_cfg.micro_batch_size
            if m not in pipelines:
                pipelines[m] = Pipeline(model_cfg, mesh, m)
            pipe = pipelines[m]
            loss = pipe.forward_only(params, batch, metrics=names)
            losses = [] if loss is None else [loss]
            if names:
                # the last stage's sums; the other stages add zeros
                sums = (pipe.metric_sums if pipe.metric_sums is not None
                        else torch.zeros((len(names), 2),
                                         device=loss_mask.device))
                sums = all_reduce(sums, mesh.group("pipe"))
        elif names:
            logits = lm_forward(model_cfg, params, batch["tokens"],
                                positions=batch.get("position_ids"),
                                mesh=mesh)
            loss, per_token = _ce(logits, batch["labels"], mesh, loss_mask)
            if mesh.cp > 1:
                loss = loss_mean(per_token, loss_mask, mesh)
            losses = [loss]
            sums = metric_sums(names, vocab_parallel_argmax(logits, mesh),
                               batch["labels"], loss_mask, per_token)
        else:
            # the CE alone, as the one-process eval step reports it
            losses = [lm_loss(model_cfg, params,
                              dict(batch, loss_mask=loss_mask),
                              mesh=mesh)[1]["lm_loss"]]
        ntokens = loss_mask.sum()
        if mesh.cp > 1:
            ntokens = all_reduce(ntokens, mesh.group(AXIS_CONTEXT))
            if sums is not None:
                sums = all_reduce(sums, mesh.group(AXIS_CONTEXT))
        if mesh.dp > 1:
            ntokens = all_reduce(ntokens, mesh.group(BATCH_AXES))
            if sums is not None:
                sums = all_reduce(sums, mesh.group(BATCH_AXES))
        out = {"lm_loss": agreed_loss(losses, mesh, loss_mask.device),
               "ntokens": ntokens}
        if names:
            out.update(finish_metrics(names, sums))
        return out

    return eval_step
