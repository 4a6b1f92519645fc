"""Mixed-precision optimizer with fp32 master weights (counterpart of
megatron_tpu/training/optimizer.py).

The JAX package's formulas, kept exactly: Adam with bias correction,
eps outside the sqrt, decoupled weight decay added to the update, the
clip coefficient min(1, clip / (norm + 1e-6)), dynamic loss scaling with
hysteresis for fp16, and skip-on-nonfinite as a masked update — all on
the device (torch.where), so a step never syncs the host. torch.optim is
not used: its steps place eps and decay differently.

PyTorch updates in place where JAX returns a new state: each leaf's
master, moments and model-dtype params are overwritten, chunk by chunk
(_CHUNK elements at a time, so the temporaries of the largest stacked
leaf stay a few hundred MB).

Across ranks (a MeshRuntime and models/params.leaf_layout): the grad
norm is one sum of squares over every rank, each element counted once
(a leaf replicated over tensor or data ranks is counted at index 0 of
that axis, a sharded one everywhere), so every rank gets the same norm;
the finite flag and the fp16 scaler's decision come from that norm,
so no rank skips a step another takes (a non-finite value anywhere
makes the global sum non-finite everywhere). With
use_distributed_optimizer (ZeRO-1, the reference's
distrib_optimizer.py) and dp > 1, the fp32 masters and both moments are
this rank's zero1 shard of each leaf (parallel/sharding.zero1_spec: a
cut over the batch ranks, data x expert, of the first unsharded
dimension dp divides; an expert leaf's over the data ranks at dp/ep),
the step's grads arrive reduce-scattered into that shard
(training/train_step.py), Adam runs on the shard with the formula
above, and the updated shards are all-gathered back into the
model-dtype params. A leaf no dimension of which dp divides stays whole
on every data rank (zero1_spec leaves it replicated).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from megatron_tpu_torch.config import OptimizerConfig
from megatron_tpu_torch.parallel.mappings import all_gather, all_reduce
from megatron_tpu_torch.parallel.mesh import BATCH_AXES
from megatron_tpu_torch.parallel.sharding import zero1_axes
from megatron_tpu_torch.training.scheduler import lr_at_step, wd_at_step

_CHUNK = 1 << 26

# Leaf-name test for "is a bias or a norm scale" in models/params.py's
# naming scheme; matmul weights and embeddings never match.
_NO_DECAY_RE = re.compile(r"scale|bias|^b([qkvo]|_\w+)?$|_b$")


@dataclasses.dataclass
class ScalerState:
    scale: torch.Tensor           # f32 scalar
    growth_tracker: torch.Tensor  # i32 consecutive good steps
    hysteresis: torch.Tensor      # i32 remaining tolerated overflows


@dataclasses.dataclass
class TrainState:
    params: Any                   # model-dtype params (what forward reads)
    master: Optional[Any]         # fp32 masters (None when params are fp32)
    mu: Any                       # Adam first moment, fp32
    nu: Any                       # Adam second moment, fp32
    step: torch.Tensor            # i32 scalar, completed optimizer steps
    scaler: Optional[ScalerState]
    # i32 scalar: consecutive skipped (non-finite) updates
    nonfinite_streak: torch.Tensor


def leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(slash-joined path, leaf)] of a nested dict in sorted key order —
    jax.tree.leaves' order for dicts, and the one name derivation for
    both the wd mask and the group mults."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(leaf_paths(v, path))
        else:
            out.append((path, v))
    return out


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _wd_mask(name: str, leaf) -> bool:
    """Whether weight decay applies to a param leaf: biases and all norm
    params are excluded, matmul weights and embeddings decay. By path
    name, not ndim: per-layer norm scales are stacked [L, h]."""
    if _NO_DECAY_RE.search(name.rsplit("/", 1)[-1]):
        return False
    return leaf.dim() >= 2


def leaf_group_mults(cfg: OptimizerConfig, tree: Any):
    """[(lr_mult, wd_mult)] per leaf, in leaf order; first matching
    pattern of cfg.param_group_mults wins."""
    out = []
    for name, _ in leaf_paths(tree):
        lrm = wdm = 1.0
        for pat, lm, wm in cfg.param_group_mults:
            if re.search(pat, name):
                lrm, wdm = float(lm), float(wm)
                break
        out.append((lrm, wdm))
    return out


def zero1_layout(cfg: OptimizerConfig, mesh, layout
                 ) -> Dict[str, Tuple[int, Any]]:
    """{path: (the dimension ZeRO-1 cuts this rank's optimizer state
    along, the axes it cuts over: parallel/sharding.zero1_axes)} for the
    leaves it cuts; {} when ZeRO-1 is off or dp is 1."""
    if (mesh is None or layout is None or mesh.dp == 1
            or not cfg.use_distributed_optimizer):
        return {}
    return {p: (zdim, zero1_axes(spec))
            for p, (spec, zdim, _) in layout.items() if zdim is not None}


def zero1_shard(x: torch.Tensor, mesh, dim: int,
                axes=BATCH_AXES) -> torch.Tensor:
    """This rank's block of x along dim, cut over `axes`' ranks."""
    return x.chunk(mesh.size(axes), dim=dim)[mesh.index(axes)]


def nest_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{slash-joined path: leaf} -> nested dicts (leaf_paths' inverse)."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out


def init_train_state(cfg: OptimizerConfig, params: Any,
                     use_fp16_scaler: bool = False, mesh=None,
                     layout=None) -> TrainState:
    """layout: models/params.leaf_layout for a multi-rank run; with
    ZeRO-1 the masters (always kept then, fp32 params too) and the
    moments are this rank's shards."""
    leaves = [v for _, v in leaf_paths(params)]
    device = leaves[0].device
    zeros = lambda t: tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        t)
    needs_master = cfg.fp32_master_weights and any(
        x.dtype != torch.float32 for x in leaves)
    zdims = zero1_layout(cfg, mesh, layout)
    if zdims:
        master = nest_paths({
            path: (zero1_shard(x.detach().float(), mesh, *zdims[path])
                   if path in zdims else x.detach().float()).clone()
            for path, x in leaf_paths(params)})
    elif needs_master:
        master = tree_map(lambda x: x.detach().float().clone(), params)
    else:
        master = None
    scaler = None
    if use_fp16_scaler:
        init_scale = (cfg.loss_scale if cfg.loss_scale is not None
                      else cfg.initial_loss_scale)
        scaler = ScalerState(
            scale=torch.tensor(init_scale, dtype=torch.float32,
                               device=device),
            growth_tracker=torch.zeros((), dtype=torch.int32, device=device),
            hysteresis=torch.tensor(cfg.hysteresis, dtype=torch.int32,
                                    device=device))
    moments = master if zdims else params
    return TrainState(
        params=params, master=master, mu=zeros(moments), nu=zeros(moments),
        step=torch.zeros((), dtype=torch.int32, device=device),
        scaler=scaler,
        nonfinite_streak=torch.zeros((), dtype=torch.int32, device=device))


def _world(mesh):
    """The group of every rank, or None in a one-rank run."""
    if mesh is None or mesh.world_size == 1:
        return None
    import torch.distributed as dist

    return dist.group.WORLD


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    """A leaf's sum of squares in fp32 by torch.sum's cascade: on the CPU
    torch.linalg.vector_norm of a 3-d fp32 tensor was 1e-3 off at 5.8 M
    elements (an MLP leaf of 4 layers), where XLA's reduction is exact to
    fp32 rounding."""
    return g.float().square().sum()


def global_grad_norm(grads: Any, mesh=None, layout=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf; across ranks, over the
    leaves this rank owns (models/params.leaf_layout), summed over every
    rank."""
    world = _world(mesh)
    if world is None:
        return torch.stack([_sum_sq(g) for _, g in leaf_paths(grads)]
                           ).sum().sqrt()
    sq = [_sum_sq(g) for path, g in leaf_paths(grads) if layout[path][2]]
    local = (torch.stack(sq).sum() if sq else
             torch.zeros((), device=next(iter(leaf_paths(grads)))[1].device))
    return all_reduce(local, world).sqrt()


def count_zeros(grads: Any, mesh=None, layout=None) -> torch.Tensor:
    world = _world(mesh)
    if world is None:
        return sum((g == 0).sum() for _, g in leaf_paths(grads)).float()
    local = sum(((g == 0).sum() for path, g in leaf_paths(grads)
                 if layout[path][2]), torch.zeros(())).float()
    dev = next(iter(leaf_paths(grads)))[1].device
    return all_reduce(local.to(dev), world)


def _update_scaler(cfg: OptimizerConfig, s: ScalerState,
                   found_inf: torch.Tensor) -> ScalerState:
    """DynamicGradScaler: on overflow consume hysteresis then back off 2x;
    after loss_scale_window good steps grow 2x."""
    if cfg.loss_scale is not None:  # constant scaler
        return s
    hy = torch.where(found_inf, (s.hysteresis - 1).clamp_min(0),
                     s.hysteresis)
    do_backoff = found_inf & (hy <= 0)
    new_scale = torch.where(
        do_backoff, (s.scale * 0.5).clamp_min(cfg.min_loss_scale), s.scale)
    tracker = torch.where(found_inf, torch.zeros_like(s.growth_tracker),
                          s.growth_tracker + 1)
    do_growth = ~found_inf & (tracker >= cfg.loss_scale_window)
    new_scale = torch.where(do_growth, new_scale * 2.0, new_scale)
    tracker = torch.where(do_growth, torch.zeros_like(tracker), tracker)
    # the hysteresis budget is restored only on a growth event
    hy = torch.where(do_growth, torch.full_like(hy, cfg.hysteresis), hy)
    return ScalerState(scale=new_scale, growth_tracker=tracker,
                       hysteresis=hy)


def _chunks(*tensors):
    """Matching flat chunks of same-shaped contiguous tensors."""
    flat = [t.view(-1) for t in tensors]
    return zip(*(f.split(_CHUNK) for f in flat))


def _prepare(state: TrainState, grads: Any, mesh=None, layout=None):
    """fp32 unscaled grads (in place when they already are fp32), their
    global norm and the finite flag, as the first half of both steps."""
    inv = (1.0 / state.scaler.scale) if state.scaler is not None else None

    def prep(g):
        g = g.float()
        return g.mul_(inv) if inv is not None else g

    out = tree_map(prep, grads)
    norm = global_grad_norm(out, mesh, layout)
    return out, norm, torch.isfinite(norm)


def _clip(cfg: OptimizerConfig, grads: Any, norm: torch.Tensor) -> None:
    if cfg.clip_grad > 0:
        coef = (cfg.clip_grad / (norm + 1e-6)).clamp_max(1.0)
        for _, g in leaf_paths(grads):
            g.mul_(coef)


def _finish(cfg: OptimizerConfig, state: TrainState, finite: torch.Tensor,
            masters: Any, mesh=None, zdims: Optional[Dict[str, Any]] = None
            ) -> None:
    """Model-dtype params from the masters (a ZeRO-1 shard all-gathered
    over the data ranks in the model dtype), scaler, streak and step."""
    if state.master is not None:
        with torch.no_grad():
            for (path, p), (_, m) in zip(leaf_paths(state.params),
                                         leaf_paths(masters)):
                if zdims and path in zdims:
                    dim, axes = zdims[path]
                    p.copy_(all_gather(m.to(p.dtype), mesh.group(axes), dim))
                else:
                    p.copy_(m)
    if state.scaler is not None:
        state.scaler = _update_scaler(cfg, state.scaler, ~finite)
    state.nonfinite_streak = torch.where(
        finite, torch.zeros_like(state.nonfinite_streak),
        state.nonfinite_streak + 1)
    state.step = torch.where(finite, state.step + 1, state.step)


def make_optimizer_step(cfg: OptimizerConfig, train_iters: int,
                        mesh=None, layout=None):
    """Returns apply(state, grads) -> (state, metrics).

    grads are fp32 *scaled* grads (the loss was multiplied by
    scaler.scale when a scaler is present); they are overwritten. The
    state is updated in place and returned; metrics are device tensors
    (grad_norm, lr, skipped, skip_streak, and loss_scale / num_zeros when
    they apply). mesh, layout: a multi-rank run (the module docstring);
    under ZeRO-1 the grads of the cut leaves are this rank's shards."""
    if cfg.optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
    zdims = zero1_layout(cfg, mesh, layout)

    @torch.no_grad()
    def apply(state: TrainState, grads: Any):
        grads, norm, finite = _prepare(state, grads, mesh, layout)
        _clip(cfg, grads, norm)
        lr = lr_at_step(cfg, state.step, train_iters)
        wd = wd_at_step(cfg, state.step, train_iters)
        masters = state.master if state.master is not None else state.params
        names = leaf_paths(masters)
        mults = (leaf_group_mults(cfg, masters) if cfg.param_group_mults
                 else [(1.0, 1.0)] * len(names))
        if cfg.optimizer == "adam":
            t = (state.step + 1).float()
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for (name, p), (_, m), (_, v), (_, g), (lm, wm) in zip(
                names, leaf_paths(state.mu), leaf_paths(state.nu),
                leaf_paths(grads), mults):
            if cfg.optimizer == "sgd":
                # mu doubles as the momentum buffer; no weight decay
                for mc, gc, pc in _chunks(m, g, p):
                    m1 = cfg.sgd_momentum * mc + gc
                    p1 = pc.float() - (lr * lm) * m1
                    mc.copy_(torch.where(finite, m1, mc))
                    pc.copy_(torch.where(finite, p1, pc.float()))
                continue
            decays = _wd_mask(name, p)
            for mc, vc, gc, pc in _chunks(m, v, g, p):
                m1 = b1 * mc + (1 - b1) * gc
                v1 = b2 * vc + (1 - b2) * gc.square()
                update = (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
                pf = pc.float()
                if decays:
                    update = update + (wd * wm) * pf
                p1 = pf - (lr * lm) * update
                mc.copy_(torch.where(finite, m1, mc))
                vc.copy_(torch.where(finite, v1, vc))
                pc.copy_(torch.where(finite, p1, pf))
        _finish(cfg, state, finite, masters, mesh, zdims)
        metrics = {"grad_norm": norm, "lr": lr,
                   "skipped": (~finite).float(),
                   "skip_streak": state.nonfinite_streak.float()}
        if cfg.log_num_zeros_in_grad:
            metrics["num_zeros"] = count_zeros(grads, mesh, layout)
        if state.scaler is not None:
            metrics["loss_scale"] = state.scaler.scale
        return state, metrics

    return apply
