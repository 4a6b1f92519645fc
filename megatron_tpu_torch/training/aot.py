"""Per-card memory fit of a training step without allocating it
(counterpart of megatron_tpu/training/aot.py).

The JAX package compiles the train step ahead of time over a virtual
mesh and reads XLA's buffer assignment (``memory_analysis()``). The port
has no compiler to ask, so it runs the step: one real train step of one
rank's shard (training/train_step.make_train_step: the microbatch loop,
the backward, the gradient reductions, the optimizer) under
``FakeTensorMode`` — every tensor has its shape, dtype and storage size
but no memory — with a fake process group of the recipe's world size
(torch.distributed's "fake" backend: each collective returns at once),
while a dispatch mode tracks the bytes of every live storage and their
high-water mark.

The report splits the state (params, the fp32 gradient accumulators,
fp32 masters, Adam's two moments, sharded over the data ranks under
ZeRO-1) from the activation/temporary peak above it. What fake tensors
cannot see is added explicitly:

  * the flash kernels run as shape contracts (``_kernel_shapes``): each
    wrapper's outputs allocated as on the card (o, the fp32 lse, the
    fp32 dsum, dq, dk, dv), without the plain version's S x S scores,
    which the card never makes;
  * ``WORKSPACE_BYTES``: cuBLAS's and cuBLASLt's workspaces (PyTorch
    allocates 32 MiB each for Hopper through the caching allocator, so
    they count in ``torch.cuda.max_memory_allocated``).

``max_memory_allocated`` counts allocated blocks, not the caching
allocator's reserved slack; blocks are rounded to 512 B, which the
report neglects. The budget is one H100 80 GB (``H100_BYTES``); on the
card the budget is what ``torch.cuda.get_device_properties(0)`` reports.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

GIB = 1 << 30

#: one H100 80 GB card's memory (nominal)
H100_BYTES = 80 * GIB
#: cuBLAS + cuBLASLt workspaces on Hopper (32 MiB each)
WORKSPACE_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class HbmFitReport:
    """One rank's memory for one train step, in bytes."""

    mesh_shape: Dict[str, int]
    n_params: int             # whole model
    param_bytes: int          # this rank's params (model dtype)
    grad_bytes: int           # fp32 gradient accumulators
    master_bytes: int         # fp32 masters (ZeRO-1: this rank's shard)
    moment_bytes: int         # Adam mu + nu (ZeRO-1: this rank's shard)
    other_state_bytes: int    # step counters, loss scaler
    batch_bytes: int          # the step's batch on this rank
    peak_bytes: int           # live-storage high-water mark of the step
                              # (the state and batch included)
    workspace_bytes: int      # added: cuBLAS/cuBLASLt workspaces
    trace_seconds: float

    @property
    def state_bytes(self) -> int:
        """What the optimizer state holds across steps: params, masters,
        moments and counters (the JAX report's argument bytes less the
        batch's)."""
        return (self.param_bytes + self.master_bytes + self.moment_bytes
                + self.other_state_bytes)

    @property
    def temp_peak_bytes(self) -> int:
        """The activation/temporary peak above the state, the gradient
        accumulators and the batch."""
        return (self.peak_bytes - self.state_bytes - self.grad_bytes
                - self.batch_bytes)

    @property
    def per_chip_bytes(self) -> int:
        return self.peak_bytes + self.workspace_bytes

    def fits(self, budget_bytes: int) -> bool:
        return self.per_chip_bytes <= budget_bytes

    def summary(self, budget_bytes: Optional[int] = None) -> str:
        g = lambda n: f"{n / GIB:.2f}"  # noqa: E731
        s = (f"mesh={self.mesh_shape} params={self.n_params / 1e9:.2f}B "
             f"per_card={g(self.per_chip_bytes)}GiB (state "
             f"{g(self.state_bytes)}: params {g(self.param_bytes)} master "
             f"{g(self.master_bytes)} moments {g(self.moment_bytes)}; "
             f"grads {g(self.grad_bytes)} batch {g(self.batch_bytes)} "
             f"temp peak {g(self.temp_peak_bytes)} workspace "
             f"{g(self.workspace_bytes)}) traced in "
             f"{self.trace_seconds:.1f}s")
        if budget_bytes is not None:
            margin = (budget_bytes - self.per_chip_bytes) / GIB
            s += (f" budget={budget_bytes / GIB:.1f}GiB "
                  f"{'FITS' if self.fits(budget_bytes) else 'OVER'} "
                  f"(margin {margin:+.2f}GiB)")
        return s


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of every storage an op returns while it lives,
    and their high-water mark."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self.track(t)
        return out


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def _nbytes(tree) -> int:
    from megatron_tpu_torch.training.optimizer import leaf_paths

    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.untyped_storage().nbytes()
    return sum(t.untyped_storage().nbytes() for _, t in leaf_paths(tree))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """torch.distributed's fake backend at `world_size` ranks for this
    process (every collective returns at once, data untouched); groups
    asked for on another backend are made on the fake one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("hbm_fit_report needs a process without a "
                           "process group (run it as its own process: "
                           "tools/hbm_check)")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    real_new_group = dist.new_group

    def new_group(*a, **kw):
        kw.pop("backend", None)
        return real_new_group(*a, **kw)

    dist.new_group = new_group
    try:
        yield
    finally:
        dist.new_group = real_new_group
        dist.destroy_process_group()


@contextlib.contextmanager
def _kernel_shapes():
    """The flash kernels' allocations in place of their plain versions
    (ops/flash/flash_template.py: flash_fwd's o and lse, flash_bwd's dsum,
    dq, dk and dv)."""
    from megatron_tpu_torch.ops.flash import flash_template as ft

    def fwd(q, k, v, **_):
        b, sq, hq, _d = q.shape
        return (torch.empty_like(q, memory_format=torch.contiguous_format),
                q.new_empty((b, hq, sq), dtype=torch.float32))

    def bwd(q, k, v, o, lse, do, **_):
        dsum = ft._bwd_dsum(o, do)
        out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                    for t in (q, k, v))
        del dsum
        return out

    saved = ft.flash_fwd, ft.flash_bwd
    ft.flash_fwd, ft.flash_bwd = fwd, bwd
    try:
        yield
    finally:
        ft.flash_fwd, ft.flash_bwd = saved


def hbm_fit_report(model_cfg, parallel_cfg, opt_cfg=None,
                   micro_batch_size: int = 1, num_microbatches: int = 2,
                   recompute: str = "selective", world_size: int = None,
                   rank: int = 0) -> HbmFitReport:
    """Run one train step of rank `rank`'s shard at `world_size` ranks
    (default: the parallel degrees' product, data parallel 1) under fake
    tensors and report its memory. The global batch is micro_batch_size x
    num_microbatches x the data-parallel degree."""
    from megatron_tpu_torch.config import OptimizerConfig, TrainingConfig
    from megatron_tpu_torch.models.params import (
        init_params, leaf_layout, num_params,
    )
    from megatron_tpu_torch.parallel.mesh import MESH_AXES, build_mesh
    from megatron_tpu_torch.training.optimizer import (
        init_train_state, leaf_paths,
    )
    from megatron_tpu_torch.training.train_step import make_train_step
    from torch._subclasses.fake_tensor import FakeTensorMode

    p = parallel_cfg.validate()
    if world_size is None:
        world_size = (p.tensor_parallel * p.pipeline_parallel
                      * p.context_parallel * p.expert_parallel)
    opt_cfg = opt_cfg or OptimizerConfig(lr=1e-4,
                                         use_distributed_optimizer=True)
    t0 = time.perf_counter()
    with fake_world(world_size, rank):
        mesh = build_mesh(p)
        multi = mesh.world_size > 1
        global_batch = micro_batch_size * num_microbatches * mesh.dp
        tcfg = TrainingConfig(micro_batch_size=micro_batch_size,
                              global_batch_size=global_batch,
                              recompute_granularity=recompute, seed=0)
        tracker = LiveBytes()
        with FakeTensorMode(), tracker, _kernel_shapes():
            params = init_params(model_cfg, 0, device="cpu",
                                 mesh=mesh if multi else None)
            for _, leaf in leaf_paths(params):
                leaf.requires_grad_(True)
            layout = (leaf_layout(model_cfg, mesh,
                                  opt_cfg.use_distributed_optimizer)
                      if multi else None)
            state = init_train_state(
                opt_cfg, params,
                use_fp16_scaler=model_cfg.params_dtype == "float16",
                mesh=mesh if multi else None, layout=layout)
            batch = _batch(model_cfg, mesh, micro_batch_size,
                           num_microbatches)
            step = make_train_step(model_cfg, opt_cfg, tcfg,
                                   num_microbatches, train_iters=100,
                                   mesh=mesh if multi else None)
            # the step's high-water mark: init_params builds each whole
            # leaf before cutting this rank's slice, a peak of set-up
            tracker.peak = tracker.current
            step(state, batch)
        param_bytes = _nbytes(state.params)
        report = HbmFitReport(
            mesh_shape={a: mesh.size(a) for a in MESH_AXES},
            n_params=num_params(model_cfg),
            param_bytes=param_bytes,
            grad_bytes=sum(4 * t.numel() for _, t in leaf_paths(state.params)),
            master_bytes=_nbytes(state.master),
            moment_bytes=_nbytes(state.mu) + _nbytes(state.nu),
            other_state_bytes=(_nbytes(state.step)
                               + _nbytes(state.nonfinite_streak)
                               + (_nbytes(dataclasses.asdict(state.scaler))
                                  if state.scaler is not None else 0)),
            batch_bytes=sum(_nbytes(t) for t in batch.values()),
            peak_bytes=tracker.peak, workspace_bytes=WORKSPACE_BYTES,
            trace_seconds=time.perf_counter() - t0)
    return report


def _batch(cfg, mesh, micro_batch_size: int, num_microbatches: int
           ) -> Dict[str, torch.Tensor]:
    """This rank's rows of one step: num_microbatches x micro_batch_size
    sequences of its context piece."""
    rows = micro_batch_size * num_microbatches
    s = cfg.seq_length // mesh.cp
    return {"tokens": torch.zeros((rows, s), dtype=torch.int64),
            "labels": torch.zeros((rows, s), dtype=torch.int64),
            "loss_mask": torch.ones((rows, s), dtype=torch.float32)}


# ---------------------------------------------------------------------------
# the two headline scale proofs (the JAX package's recipes, on H100s)


def llama2_7b_recipe() -> Tuple[Any, Any, Dict[str, Any]]:
    """Llama-2-7B on 8 cards at DP2 x TP4, sequence parallel, selective
    recompute (the reference's 8-GPU recipe,
    docs/guide/getting_started.md:203-206), bf16 params, ZeRO-1."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models import presets

    cfg = presets.llama2(size="7B", seq_length=4096)
    par = ParallelConfig(tensor_parallel=4, sequence_parallel=True)
    kw = dict(micro_batch_size=1, num_microbatches=2, recompute="selective",
              world_size=8)
    return cfg, par, kw


def llama2_70b_recipe() -> Tuple[Any, Any, Dict[str, Any]]:
    """Llama-2-70B 3D: DP2 x TP8 x PP4 over 64 cards, full recompute (the
    reference's headline multi-node scale, README.md:12-13), bf16 params
    (the JAX proof compiles fp32 only to dodge an XLA:CPU bug), ZeRO-1.
    The fit is the first pipeline stage's (rank 0: the embedding, its
    layers and the 1F1B schedule's most microbatches in flight)."""
    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.models import presets

    cfg = presets.llama2(size="70B", seq_length=4096)
    par = ParallelConfig(tensor_parallel=8, pipeline_parallel=4,
                         sequence_parallel=False)
    kw = dict(micro_batch_size=1, num_microbatches=4, recompute="full",
              world_size=64)
    return cfg, par, kw


SCALE_PROOFS = {
    # name -> (recipe fn, memory budget, cards)
    "llama2_7b_dp2tp4": (llama2_7b_recipe, H100_BYTES, 8),
    "llama2_70b_dp2tp8pp4": (llama2_70b_recipe, H100_BYTES, 64),
}


def run_scale_proof(name: str, budget_bytes: Optional[int] = None
                    ) -> HbmFitReport:
    """A proof's report; MemoryError when it does not fit the budget (an
    H100 80 GB unless given)."""
    recipe, budget, _cards = SCALE_PROOFS[name]
    budget = budget_bytes or budget
    cfg, par, kw = recipe()
    report = hbm_fit_report(cfg, par, **kw)
    if not report.fits(budget):
        raise MemoryError(f"{name} does NOT fit one card: "
                          f"{report.summary(budget)}")
    return report
