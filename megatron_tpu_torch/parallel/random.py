"""PRNG policy: named streams and dropout key paths (counterpart of
megatron_tpu/parallel/random.py).

The JAX package derives its keys as values: RngStreams(seed) folds a
stream id (params 0, dropout 1, data 2, sampling 3) and an iteration
into PRNGKey(seed), and every dropout site extends that key with
fold_in and split. Nothing is global state, so a resumed run, a
recomputed forward and a replayed step draw the same masks, and a
checkpoint saves only the seed and the step.

The port keeps that policy with a DropoutKey: an immutable path
(seed, stream, step, folds), whose fold_in(d) and split(n) extend
`folds` exactly where the JAX package extends its key. A site's keep
mask is a pure function of its key path, its shape and its rate, drawn
by a mask source:
  * default_mask_source seeds a torch.Generator on the tensor's device
    from a stable hash of the path (Philox on CUDA, the Mersenne
    twister on the CPU) and keeps u < 1 - rate, u uniform in [0, 1).
    No process-global generator is read or advanced, so activation
    recompute (torch.utils.checkpoint does not restore an explicit
    generator), the pipeline's schedules, the loop's replay and
    rollback draw the same mask again;
  * a caller may inject another source (RngStreams(seed, mask_source=f),
    f(key, shape, rate, device) -> bool tensor); the keys it derives
    carry it. The parity tests inject one that draws the JAX package's
    own jax.random.bernoulli along the same path.

Above one rank a mask is the slice of the one-process (logical) mask
that the rank holds, as GSPMD makes the JAX mask a function of the
logical tensor (keep_mask): a rank draws the whole logical mask and
keeps its block. That costs each rank the random bits of the logical
tensor (dp x at data parallelism, tp x cp x under sequence and context
parallelism), and buys masks that no topology changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional, Sequence, Tuple

import torch

# Stable stream ids (never reorder: checkpoint determinism).
_STREAMS = {
    "params": 0,
    "dropout": 1,
    "data": 2,
    "sampling": 3,
}

#: f(key, shape, rate, device) -> bool keep mask of `shape`
MaskSource = Callable[["DropoutKey", Tuple[int, ...], float, torch.device],
                      torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """A key path: PRNGKey(seed), fold_in(stream), fold_in(step), then
    `folds` in order, each an int (fold_in) or ("split", n, i) (the i-th
    of split(n))."""

    seed: int
    stream: int
    step: int
    folds: Tuple = ()
    source: Optional[MaskSource] = dataclasses.field(
        default=None, compare=False, repr=False)

    def fold_in(self, data: int) -> "DropoutKey":
        return dataclasses.replace(self, folds=self.folds + (int(data),))

    def split(self, n: int) -> Tuple["DropoutKey", ...]:
        return tuple(dataclasses.replace(
            self, folds=self.folds + (("split", int(n), i),))
            for i in range(n))

    def path(self) -> tuple:
        return (self.seed, self.stream, self.step, self.folds)

    def draw(self, shape: Sequence[int], rate, device) -> torch.Tensor:
        """The keep mask of the whole logical tensor."""
        fn = self.source or default_mask_source
        return fn(self, tuple(int(s) for s in shape), rate,
                  torch.device(device))


def path_seed(key: DropoutKey) -> int:
    """A stable 63-bit seed of a key path (the same on every process,
    machine and Python run)."""
    digest = hashlib.blake2b(repr(key.path()).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def default_mask_source(key: DropoutKey, shape: Tuple[int, ...], rate,
                        device: torch.device) -> torch.Tensor:
    """keep = u < 1 - rate, u from a generator on `device` seeded with
    the path's hash."""
    gen = torch.Generator(device=device)
    gen.manual_seed(path_seed(key))
    u = torch.rand(shape, generator=gen, device=device)
    return u < float(1.0 - rate)


@dataclasses.dataclass(frozen=True)
class RngStreams:
    """Named, step-indexed key paths derived from one seed."""

    seed: int
    mask_source: Optional[MaskSource] = dataclasses.field(
        default=None, compare=False, repr=False)

    def step(self, stream: str, iteration: int) -> DropoutKey:
        return DropoutKey(int(self.seed), _STREAMS[stream], int(iteration),
                          source=self.mask_source)

    def dropout(self, iteration: int) -> DropoutKey:
        return self.step("dropout", iteration)


def _local_index(shape, layout: str, mesh):
    """(the logical shape, this rank's index into it) of a local tensor
    of `shape` in `layout`:
      * "hidden" [B, S, ...], the residual stream: rows are this batch
        rank's block of the global microbatch; the sequence is this
        rank's piece, of cp pieces (x tp under sequence parallelism,
        context outer: data/samplers.context_piece);
      * "rows" [B, ...], whole but for the batch rows (the pooled
        [CLS] state, replicated over the tensor ranks);
      * "probs" [B, Hkv, G, Sq, Skv], attention probabilities: the
        batch block and this tensor rank's kv heads."""
    shape = list(shape)
    logical, index = list(shape), [slice(None)] * len(shape)
    dp = mesh.dp
    if dp > 1:
        logical[0] = shape[0] * dp
        index[0] = slice(mesh.dp_rank * shape[0],
                         (mesh.dp_rank + 1) * shape[0])
    if layout == "hidden":
        pieces, piece = mesh.cp, mesh.cp_rank
        if mesh.sequence_parallel and mesh.tp > 1:
            pieces, piece = pieces * mesh.tp, piece * mesh.tp + mesh.tp_rank
        if pieces > 1:
            logical[1] = shape[1] * pieces
            index[1] = slice(piece * shape[1], (piece + 1) * shape[1])
    elif layout == "probs":
        if mesh.tp > 1:
            logical[1] = shape[1] * mesh.tp
            index[1] = slice(mesh.tp_rank * shape[1],
                             (mesh.tp_rank + 1) * shape[1])
    elif layout != "rows":
        raise ValueError(f"unknown mask layout {layout!r}")
    return tuple(logical), tuple(index)


def keep_mask(key: DropoutKey, shape: Sequence[int], rate, device,
              mesh=None, layout: str = "hidden") -> torch.Tensor:
    """The keep mask of a local tensor of `shape`: the logical mask of
    the path (mesh None or one rank: the tensor's own), cut to the block
    this rank holds (_local_index)."""
    if mesh is None or mesh.world_size == 1:
        return key.draw(shape, rate, device)
    logical, index = _local_index(shape, layout, mesh)
    return key.draw(logical, rate, device)[index]


def dropout(x: torch.Tensor, rate, key: Optional[DropoutKey], mesh=None,
            layout: str = "hidden") -> torch.Tensor:
    """The JAX package's _dropout: where(keep, x * inv, 0) with the
    rescale inv = 1 / (1 - rate) cast to x's dtype (a bf16 activation
    stays bf16; rate may be a numpy float32, the LIMA ramp's). No key:
    x unchanged."""
    if key is None:
        return x
    keep = keep_mask(key, x.shape, rate, x.device, mesh, layout)
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype)
    return torch.where(keep, x * inv, torch.zeros_like(x))
