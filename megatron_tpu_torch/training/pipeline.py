"""Pipeline parallelism: the 1F1B and interleaved schedules (counterpart
of megatron_tpu/training/pipeline.py).

The JAX package writes the pipeline as a forward program over the "pipe"
mesh axis (microbatches rotate stage to stage with ppermute) and lets
jax.grad derive the backward. PyTorch has no such transform across
processes, so the port writes the schedule, as the reference's
megatron/schedules.py does:

  * each stage holds its [L/pp, ...] layers (models/params.py); with V
    virtual chunks a stage holds chunks c = 0..V-1 of Lv layers, chunk c
    of stage s being virtual stage k = c*pp + s (vpp_place_indices);
  * stage 0's first chunk embeds a microbatch, the last stage's last
    chunk applies the final norm, the LM head and the loss (the mean over
    the microbatch's masked tokens, as lm_loss computes it); every stage
    gets the whole batch (tokens, positions, labels, loss_mask) and reads
    the rows it needs;
  * activations [mbs, S (S/tp under sequence parallelism), h] go forward
    and their gradients backward by send/recv (parallel/mappings.p2p,
    every exchange posted before it is waited on);
  * 1F1B: pp - rank - 1 warm-up forwards, then one forward and one
    backward in turn, then the cool-down backwards (schedules.py:
    forward_backward_pipelining_without_interleaving), so at most pp
    microbatches' activations are alive on a stage;
  * interleaved: the reference's schedule (schedules.py:253-502) over
    M*V virtual microbatches, which needs M % pp == 0 (the JAX rule,
    pipeline.py:206-209);
  * each microbatch's backward is torch.autograd.backward(out, grad),
    the loss scaled by the fp16 loss scale; a MoE stage's layers add
    their router aux loss to the stage's backward (as lm_loss adds it
    to the loss), and each stage reports its share of the microbatch's
    loss (the last stage's CE, every stage's aux), which train_step sums
    over the pipe group; after each backward the
    caller's hook moves the parameter grads into the fp32 accumulators,
    exactly as train_step's per-microbatch loop does;
  * the recompute policies apply inside each chunk (training/
    train_step.py's policy names; block:N counts the chunk's layers);
  * under context parallelism a stage's activations are its context
    piece's (S/cp, or S/(cp*tp) under sequence parallelism), and the
    last stage's loss is the piece's share (language_model.loss_mean).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.language_model import (
    _ce, _layers, context_positions, embed_tokens, final_hidden_norm,
    lm_logits, loss_mean, recompute_granularity, run_layers, token_losses,
)
from megatron_tpu_torch.models.params import vpp_place_indices
from megatron_tpu_torch.models.transformer import block_forward
from megatron_tpu_torch.ops.cross_entropy import vocab_parallel_argmax
from megatron_tpu_torch.ops.rotary import precompute_rope
from megatron_tpu_torch.parallel.mappings import enter_tp, p2p
from megatron_tpu_torch.training.metrics import metric_sums

__all__ = ["Pipeline", "vpp_place_indices"]

_ACT, _GRAD = 1, 2        # p2p tags: activations forward, grads backward


class Pipeline:
    """The schedules of one rank's stage for one microbatch count."""

    #: the batch leaf that gives the microbatch rows and the device
    TOKENS = "tokens"

    def __init__(self, cfg: ModelConfig, mesh, num_microbatches: int,
                 recompute: str = "none"):
        pp, V = mesh.pp, mesh.vpp
        if cfg.num_layers % (pp * V):
            raise ValueError(f"num_layers={cfg.num_layers} not divisible "
                             f"by stages*chunks {pp}*{V}")
        if num_microbatches < 1:
            raise ValueError("need at least one microbatch")
        if V > 1 and num_microbatches % pp:
            raise ValueError(
                "interleaved schedule needs num_microbatches % num_stages "
                f"== 0 (got {num_microbatches} % {pp}; ref "
                "schedules.py:22-29)")
        self.cfg, self.mesh = cfg, mesh
        self.M, self.V, self.pp = num_microbatches, V, pp
        self.Lv = cfg.num_layers // (pp * V)
        self.recompute = recompute
        self.metric_sums: Optional[torch.Tensor] = None

    # -- one chunk ------------------------------------------------------------

    def _first(self, c: int) -> bool:
        return self.mesh.is_first_stage and c == 0

    def _last(self, c: int) -> bool:
        return self.mesh.is_last_stage and c == self.V - 1

    def _forward(self, params, batch, rope, m: int, c: int,
                 x: Optional[torch.Tensor], metrics=()):
        """Chunk c on microbatch m: (its output activation, or on the
        last virtual stage the microbatch's mean CE; the router aux loss
        of its layers, a zero for a dense model). With `metrics` (names
        of training/metrics.py) the last stage computes the logits whole
        (this rank's vocab block) and adds the microbatch's metric sums
        to self.metric_sums."""
        cfg, mesh = self.cfg, self.mesh
        mbs = batch["tokens"].shape[0] // self.M
        mb = {k: v[m * mbs:(m + 1) * mbs] for k, v in batch.items()}
        positions = context_positions(mb["tokens"], mb.get("position_ids"),
                                      mesh)
        if self._first(c):
            x = embed_tokens(cfg, params, mb["tokens"], positions, mesh=mesh)
        lo = c * self.Lv
        chunk = _slice_tree(params["layers"], lo, lo + self.Lv)
        selective = recompute_granularity(self.recompute) == "selective"
        layers = [functools.partial(
            block_forward, cfg, lp, rope=rope, positions=positions,
            recompute_core=selective, mesh=mesh)
            for lp in _layers(chunk, self.Lv)]
        x, aux = run_layers(layers, x, self.recompute)
        if not self._last(c):
            return x, aux
        h = enter_tp(final_hidden_norm(cfg, params, x), mesh)
        lm = mb.get("loss_mask")
        if metrics:
            logits = lm_logits(cfg, params, h)
            per_token = _ce(logits, mb["labels"], mesh)[1]
            sums = metric_sums(metrics, vocab_parallel_argmax(logits, mesh),
                               mb["labels"], lm if lm is not None else
                               torch.ones_like(per_token), per_token)
            self.metric_sums = (sums if self.metric_sums is None
                                else self.metric_sums + sums)
        else:
            per_token = token_losses(cfg, params, h, mb["labels"], mesh)
        if mesh.cp > 1:
            return loss_mean(per_token, lm, mesh), aux
        if lm is None:
            return per_token.mean(), aux
        lm = lm.float()
        return (per_token * lm).sum() / lm.sum().clamp_min(1.0), aux

    def _rope(self, batch):
        cfg = self.cfg
        if cfg.position_embedding_type != "rotary":
            return None
        S = batch["tokens"].shape[1]
        return precompute_rope(cfg.head_dim, max(cfg.seq_length, S),
                               cfg.rope_theta, cfg.rope_scaling_factor,
                               device=batch["tokens"].device)

    def _act_shape(self, batch):
        mbs = batch["tokens"].shape[0] // self.M
        S = batch["tokens"].shape[1]       # this rank's context piece
        if self.mesh.sequence_parallel:
            S //= self.mesh.tp
        return (mbs, S, self.cfg.hidden_size)

    def _exchange(self, batch, send_next=None, send_prev=None,
                  recv_prev=False, recv_next=False):
        """One posted-then-waited p2p round with the neighbor stages
        (a ring: stage pp-1's next is stage 0, for the interleaved
        wrap-around). Returns (from_prev, from_next); received
        activations require grad. The order of the operations is fixed
        (activation then grad, sends then receives) so that at pp 2,
        where both neighbors are one rank, same-peer messages match in
        posting order under NCCL too."""
        mesh = self.mesh
        shape = self._act_shape(batch)
        dt, dev = self.cfg.dtype, batch[self.TOKENS].device
        sends, recvs = [], []
        if send_next is not None:
            sends.append((send_next.detach(), mesh.pipe_next, _ACT))
        if send_prev is not None:
            sends.append((send_prev, mesh.pipe_prev, _GRAD))
        if recv_prev:
            recvs.append((shape, dt, dev, mesh.pipe_prev, _ACT))
        if recv_next:
            recvs.append((shape, dt, dev, mesh.pipe_next, _GRAD))
        got = p2p(sends, recvs)
        from_prev = got.pop(0).requires_grad_(True) if recv_prev else None
        from_next = got.pop(0) if recv_next else None
        return from_prev, from_next

    @staticmethod
    def _backward(x, out, grad, scale, on_backward):
        """out: (activation or loss, router aux loss); the aux joins the
        backward of every stage whose layers route (scaled as the loss
        is)."""
        out, aux = out
        tensors, grads = [out], [grad]
        if grad is None:                      # the loss, with its aux
            tensors = [out + aux]
        elif aux.requires_grad:
            tensors.append(aux)
            grads.append(None)
        if scale is not None:
            tensors = [t * scale if g is None else t
                       for t, g in zip(tensors, grads)]
        torch.autograd.backward(tensors, grads)
        on_backward()
        return x.grad if x is not None else None

    # -- schedules ------------------------------------------------------------

    def forward_backward(self, params, batch: Dict[str, torch.Tensor],
                         scale: Optional[torch.Tensor],
                         on_backward: Callable[[], None]
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Forward and backward of every microbatch through this stage.
        Returns this stage's share of each microbatch's loss (the last
        stage's CE plus the router aux loss of the stage's layers) and
        of its router aux loss, detached: summed over the pipe group
        they are the microbatch's loss and aux loss."""
        rope = self._rope(batch)
        dev = batch[self.TOKENS].device
        losses = [torch.zeros((), device=dev) for _ in range(self.M)]
        auxes = [torch.zeros((), device=dev) for _ in range(self.M)]

        def fwd(m, c, x):
            out, aux = self._forward(params, batch, rope, m, c, x)
            auxes[m] = auxes[m] + aux.detach()
            losses[m] = losses[m] + aux.detach()
            if self._last(c):
                losses[m] = losses[m] + out.detach()
            return out, aux

        def bwd(x, out, grad):
            return self._backward(x, out, grad, scale, on_backward)

        if self.V == 1:
            self._one_f_one_b(batch, fwd, bwd)
        else:
            self._interleaved(batch, fwd, bwd)
        return losses, auxes

    def _one_f_one_b(self, batch, fwd, bwd):
        """schedules.py forward_backward_pipelining_without_interleaving."""
        mesh, M = self.mesh, self.M
        first, last = mesh.is_first_stage, mesh.is_last_stage
        ex = functools.partial(self._exchange, batch)
        warmup = min(self.pp - mesh.pp_rank - 1, M)
        remaining = M - warmup
        inputs, outputs = [], []
        for i in range(warmup):
            x, _ = ex(recv_prev=not first)
            out = fwd(i, 0, x)
            ex(send_next=None if last else out[0])
            inputs.append(x)
            outputs.append(out)
        x = ex(recv_prev=not first)[0] if remaining else None
        for i in range(remaining):
            out = fwd(warmup + i, 0, x)
            _, grad = ex(send_next=None if last else out[0],
                         recv_next=not last)
            inputs.append(x)
            outputs.append(out)
            gin = bwd(inputs.pop(0), outputs.pop(0), grad)
            final = i == remaining - 1
            x, _ = ex(send_prev=None if first else gin,
                      recv_prev=not first and not final)
        for _ in range(warmup):
            _, grad = ex(recv_next=not last)
            gin = bwd(inputs.pop(0), outputs.pop(0), grad)
            ex(send_prev=None if first else gin)

    def _interleaved(self, batch, fwd, bwd):
        """schedules.py forward_backward_pipelining_with_interleaving."""
        mesh, V, pp = self.mesh, self.V, self.pp
        rank = mesh.pp_rank
        n = self.M * V
        ex = functools.partial(self._exchange, batch)
        inputs = [[] for _ in range(V)]
        outputs = [[] for _ in range(V)]
        grads = [[] for _ in range(V)]
        if self.M == pp:
            warmup, all_warmup = n, True
        else:
            warmup = min((pp - rank - 1) * 2 + (V - 1) * pp, n)
            all_warmup = False
        remaining = n - warmup

        def chunk_of(k, forward=True):
            c = (k % (pp * V)) // pp
            return c if forward else V - c - 1

        def micro_of(k):
            return (k // (pp * V)) * pp + k % pp

        def forward_k(k):
            c = chunk_of(k)
            if self._first(c) and len(inputs[c]) == len(outputs[c]):
                inputs[c].append(None)
            out = fwd(micro_of(k), c, inputs[c][-1])
            outputs[c].append(out)
            return out[0]

        def backward_k(k):
            c = chunk_of(k, forward=False)
            if self._last(c) and not grads[c]:
                grads[c].append(None)
            return bwd(inputs[c].pop(0), outputs[c].pop(0), grads[c].pop(0))

        inputs[0].append(ex(recv_prev=not mesh.is_first_stage)[0])
        for k in range(warmup):
            out = forward_k(k)
            nxt = chunk_of(k + 1)
            recv_prev = not (mesh.is_first_stage and nxt == 0)
            if k == n - 1:
                recv_prev = False
            if self._last(chunk_of(k)):
                out = None
            if k == warmup - 1 and not all_warmup:
                x, grad = ex(send_next=out, recv_prev=recv_prev,
                             recv_next=not mesh.is_last_stage)
                grads[V - 1].append(grad)
            else:
                x, _ = ex(send_next=out, recv_prev=recv_prev)
            inputs[nxt].append(x)

        for k in range(remaining):
            fk = k + warmup
            out = forward_k(fk)
            gin = backward_k(k)
            if self._last(chunk_of(fk)):
                out = None
            if self._first(chunk_of(k, forward=False)):
                gin = None
            recv_prev = True
            if mesh.is_first_stage:
                nxt_f = chunk_of(fk - (pp - 1))
                if nxt_f == V - 1:
                    recv_prev = False
                nxt_f += 1
            else:
                nxt_f = chunk_of(fk + 1)
            recv_next = True
            if mesh.is_last_stage:
                nxt_b = chunk_of(k - (pp - 1), forward=False)
                if nxt_b == 0:
                    recv_next = False
                nxt_b -= 1
            else:
                nxt_b = chunk_of(k + 1, forward=False)
            if k == remaining - 1:
                recv_prev = False
            x, grad = ex(send_next=out, send_prev=gin, recv_prev=recv_prev,
                         recv_next=recv_next)
            if recv_prev:
                inputs[nxt_f].append(x)
            if recv_next:
                grads[nxt_b].append(grad)

        if all_warmup:
            grads[V - 1].append(ex(recv_next=not mesh.is_last_stage)[1])
        for k in range(remaining, n):
            gin = backward_k(k)
            if self._first(chunk_of(k, forward=False)):
                gin = None
            nxt_b = chunk_of(k + 1, forward=False)
            recv_next = not (mesh.is_last_stage and nxt_b == V - 1)
            if k == n - 1:
                recv_next = False
            _, grad = ex(send_prev=gin, recv_next=recv_next)
            grads[nxt_b].append(grad)

    @torch.no_grad()
    def forward_only(self, params, batch: Dict[str, torch.Tensor],
                     metrics=()) -> Optional[torch.Tensor]:
        """Every microbatch forward through this stage, virtual stages in
        order (evaluation). Returns the mean of the microbatch losses on
        the last stage, None elsewhere; with `metrics`, self.metric_sums
        then holds their token sums over every microbatch (None
        elsewhere)."""
        rope = self._rope(batch)
        losses = []
        self.metric_sums = None
        for m in range(self.M):
            for c in range(self.V):
                x, _ = self._exchange(batch, recv_prev=not self._first(c))
                out, _ = self._forward(params, batch, rope, m, c, x, metrics)
                if self._last(c):
                    losses.append(out)
                else:
                    self._exchange(batch, send_next=out)
        return torch.stack(losses).mean() if losses else None


def _slice_tree(tree: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    return {k: (_slice_tree(v, lo, hi) if isinstance(v, dict) else v[lo:hi])
            for k, v in tree.items()}
