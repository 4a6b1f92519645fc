"""Parameter tree: shapes, initialization and partition specs
(counterpart of megatron_tpu/models/params.py).

The tree keeps the JAX package's flat '/' paths and stacked [L, ...]
layer shapes, nested into plain dicts of tensors, so a JAX parameter
tree converts 1:1 through numpy (params_from_numpy) and both packages
compute the same function. Each path carries the JAX package's
PartitionSpec (parallel/sharding.P). Given a MeshRuntime, init_params
and params_from_numpy return this rank's slice of every leaf by that
spec (parallel/sharding.shard_leaf), as JAX's shard_tree places them,
and under pipeline parallelism only the leaves its stage uses
(stage_holds): its [L/pp, ...] layers (with virtual stages, its chunks
in vpp_place_indices order), the token (and position) embedding on the
first stage, the final norm and the LM head on the last, and with tied
embeddings a copy of embed/tokens on the last stage too.

A MoE model (cfg.num_experts) has layers/moe/{router [L, h, E], w_in
[L, E, h, Fin], w_out [L, E, F, h]} (and b_in/b_out with linear biases)
in place of layers/mlp; its experts are cut over the "expert" axis
(E/ep a rank) and, inside each expert, over "tensor" as the MLP is.
params_from_numpy also takes a weight-quantized JAX tree
(ops/weight_quant.py): its {"q8" | "f8", "s"} leaves keep their int8 /
float8_e4m3fn payloads and fp32 scales.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.ops.activations import mlp_input_width_factor
from megatron_tpu_torch.parallel.mesh import (
    AXIS_EXPERT, AXIS_PIPE, AXIS_TENSOR, MESH_AXES, rank_grid,
)
from megatron_tpu_torch.parallel.sharding import (
    P, Piece, block_pieces, shard_leaf, spec_axes, zero1_axes, zero1_dim,
    zero1_spec,
)

_NORMAL = "normal"          # N(0, init_method_std)
_SCALED = "scaled_normal"   # N(0, std / sqrt(2 * num_layers)) (output-facing)
_ONES = "ones"
_ZEROS = "zeros"


def _defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Flat {'/'-joined path: (shape, partition_spec, init_kind)}, the
    JAX package's table (megatron_tpu/models/params.py:39-125): the
    decoder models (dense and MoE), and BERT's token types and heads."""
    h = cfg.hidden_size
    L = cfg.num_layers
    D = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.n_kv_heads
    F = cfg.ffn_size
    Fin = F * mlp_input_width_factor(cfg.activation)
    V = cfg.vocab_size
    pipe, tensor = AXIS_PIPE, AXIS_TENSOR

    d: Dict[str, Any] = {}
    d["embed/tokens"] = ((V, h), P(tensor, None), _NORMAL)
    if cfg.position_embedding_type == "absolute":
        d["embed/pos"] = ((cfg.max_position_embeddings, h), P(None, None),
                          _NORMAL)
    if cfg.num_tokentypes > 0:
        d["embed/tokentype"] = ((cfg.num_tokentypes, h), P(None, None),
                                _NORMAL)

    ln_bias = cfg.normalization == "layernorm"
    norms = ["layers/ln1"]
    if not cfg.parallel_attn:
        norms.append("layers/ln2")
    if cfg.parallel_layernorm:
        norms.append("layers/ln_mlp")
    for prefix in norms:
        d[f"{prefix}/scale"] = ((L, h), P(pipe, None), _ONES)
        if ln_bias:
            d[f"{prefix}/bias"] = ((L, h), P(pipe, None), _ZEROS)

    d["layers/attn/wq"] = ((L, h, nq * D), P(pipe, None, tensor), _NORMAL)
    d["layers/attn/wk"] = ((L, h, nkv * D), P(pipe, None, tensor), _NORMAL)
    d["layers/attn/wv"] = ((L, h, nkv * D), P(pipe, None, tensor), _NORMAL)
    d["layers/attn/wo"] = ((L, nq * D, h), P(pipe, tensor, None), _SCALED)
    if cfg.use_bias_qkv:
        d["layers/attn/bq"] = ((L, nq * D), P(pipe, tensor), _ZEROS)
        d["layers/attn/bk"] = ((L, nkv * D), P(pipe, tensor), _ZEROS)
        d["layers/attn/bv"] = ((L, nkv * D), P(pipe, tensor), _ZEROS)
    if cfg.use_bias_linear:
        d["layers/attn/bo"] = ((L, h), P(pipe, None), _ZEROS)

    if cfg.num_experts is None:
        d["layers/mlp/w_in"] = ((L, h, Fin), P(pipe, None, tensor), _NORMAL)
        d["layers/mlp/w_out"] = ((L, F, h), P(pipe, tensor, None), _SCALED)
        if cfg.use_bias_linear:
            d["layers/mlp/b_in"] = ((L, Fin), P(pipe, tensor), _ZEROS)
            d["layers/mlp/b_out"] = ((L, h), P(pipe, None), _ZEROS)
    else:
        E, expert = cfg.num_experts, AXIS_EXPERT
        d["layers/moe/router"] = ((L, h, E), P(pipe, None, None), _NORMAL)
        d["layers/moe/w_in"] = ((L, E, h, Fin),
                                P(pipe, expert, None, tensor), _NORMAL)
        d["layers/moe/w_out"] = ((L, E, F, h),
                                 P(pipe, expert, tensor, None), _SCALED)
        if cfg.use_bias_linear:
            d["layers/moe/b_in"] = ((L, E, Fin), P(pipe, expert, tensor),
                                    _ZEROS)
            d["layers/moe/b_out"] = ((L, E, h), P(pipe, expert, None),
                                     _ZEROS)

    if not cfg.use_post_ln:  # post-LN layers carry their own output norm
        d["final_ln/scale"] = ((h,), P(None), _ONES)
        if ln_bias:
            d["final_ln/bias"] = ((h,), P(None), _ZEROS)
    if not cfg.tie_embed_logits:
        d["lm_head/w"] = ((h, V), P(None, tensor), _NORMAL)
    if cfg.bert_binary_head:
        # BERT's MLM transform (dense + gelu + LN) over the tied decoder
        # with an output bias, the pooler and the binary head
        d["mlm_head/dense_w"] = ((h, h), P(None, None), _NORMAL)
        d["mlm_head/dense_b"] = ((h,), P(None), _ZEROS)
        d["mlm_head/norm_scale"] = ((h,), P(None), _ONES)
        d["mlm_head/norm_bias"] = ((h,), P(None), _ZEROS)
        d["mlm_head/bias"] = ((V,), P(tensor), _ZEROS)
        d["pooler/w"] = ((h, h), P(None, None), _NORMAL)
        d["pooler/b"] = ((h,), P(None), _ZEROS)
        d["binary_head/w"] = ((h, 2), P(None, None), _NORMAL)
        d["binary_head/b"] = ((2,), P(None), _ZEROS)
    return d


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, path))
        else:
            flat[path] = v
    return flat


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Flat {path: shape}."""
    return {k: s for k, (s, _, _) in _defs(cfg).items()}


def param_specs(cfg: ModelConfig) -> Dict[str, P]:
    """Flat {path: PartitionSpec}."""
    return {k: spec for k, (_, spec, _) in _defs(cfg).items()}


def num_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for s, _, _ in _defs(cfg).values())


# ---------------------------------------------------------------------------
# per-rank placement
# ---------------------------------------------------------------------------


def vpp_place_indices(L: int, Pn: int, V: int):
    """(place, inverse) permutations for interleaved layer storage (a
    copy of megatron_tpu/training/pipeline.py:135): placed order is
    (stage, chunk slot, layer in chunk), so virtual stage k = c*Pn + s,
    canonical layers [k*Lv, (k+1)*Lv), lands on physical stage s and a
    contiguous cut of the placed layer axis over "pipe" gives each stage
    its V chunks. Identity when V == 1."""
    if L % (Pn * V):
        raise ValueError(
            f"num_layers={L} not divisible by stages*chunks {Pn}*{V}")
    Lv = L // (Pn * V)
    place = np.zeros(L, np.int64)
    for s in range(Pn):
        for c in range(V):
            for j in range(Lv):
                place[(s * V + c) * Lv + j] = ((c * Pn + s) * Lv) + j
    inv = np.empty_like(place)
    inv[place] = np.arange(L, dtype=np.int64)
    return place, inv


def stage_holds(path: str, cfg: ModelConfig, mesh) -> bool:
    """Whether this rank's pipeline stage keeps the leaf at `path`."""
    if mesh is None or mesh.pp == 1 or path.startswith("layers/"):
        return True
    if path == "embed/tokens":
        return mesh.is_first_stage or (cfg.tie_embed_logits
                                       and mesh.is_last_stage)
    if path.startswith("embed/"):
        return mesh.is_first_stage
    return mesh.is_last_stage          # final_ln/*, lm_head/w


def _glu_dim(path: str, cfg: ModelConfig) -> Optional[int]:
    """The dimension of a GLU input projection cut per half
    (parallel/sharding.py)."""
    if cfg.is_glu and path in ("layers/mlp/w_in", "layers/mlp/b_in",
                               "layers/moe/w_in", "layers/moe/b_in"):
        return -1
    return None


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """The divisibility the per-rank slices need (the JAX package's
    rules, its TrainLoop's for the expert axis)."""
    if mesh is None:
        return
    E, ep = cfg.num_experts, mesh.ep
    if E is not None and E % ep:
        raise ValueError(
            f"num_experts={E} must be divisible by expert_parallel={ep} "
            "(experts shard over the dedicated expert axis; dp is "
            "unconstrained)")
    if E is None and ep > 1:
        raise ValueError(
            f"expert_parallel={ep} set but the model has no experts — "
            "use data_parallel instead")
    tp, pp, V = mesh.tp, mesh.pp, mesh.vpp
    if tp > 1:
        if cfg.num_attention_heads % tp or cfg.n_kv_heads % tp:
            raise ValueError(
                f"tensor_parallel={tp} must divide the query heads "
                f"({cfg.num_attention_heads}) and the kv heads "
                f"({cfg.n_kv_heads}): GQA with tp > num_kv_heads is not "
                "supported (the JAX specs cut the kv projection too)")
        if cfg.vocab_size % tp:
            raise ValueError(
                f"vocab_size={cfg.vocab_size} not divisible by "
                f"tensor_parallel={tp}: pad it to make_vocab_size_"
                "divisible_by x tp (models/presets.py)")
        if cfg.ffn_size % tp:
            raise ValueError(f"ffn size {cfg.ffn_size} not divisible by "
                             f"tensor_parallel={tp}")
        if mesh.sequence_parallel and cfg.seq_length % tp:
            raise ValueError(f"sequence parallelism needs seq_length "
                             f"({cfg.seq_length}) divisible by tp={tp}")
    if cfg.num_layers % (pp * V):
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"stages*chunks {pp}*{V}")
    cp = mesh.cp
    if cp > 1:
        if E is not None:
            raise ValueError(
                f"context_parallel={cp} with a MoE model: the router's "
                "statistics and capacity groups over a split sequence are "
                "not ported (ROADMAP.md)")
        if cfg.seq_length % cp:
            raise ValueError(f"context_parallel={cp} must divide "
                             f"seq_length ({cfg.seq_length})")
        if mesh.sequence_parallel and (cfg.seq_length // cp) % tp:
            raise ValueError(
                f"sequence parallelism under context_parallel={cp} needs "
                f"seq_length/cp ({cfg.seq_length // cp}) divisible by "
                f"tp={tp}")
        if cfg.attention_impl == "ulysses":
            from megatron_tpu_torch.ops.ulysses import check_heads

            check_heads(cfg.num_attention_heads // tp,
                        cfg.n_kv_heads // tp, cp)


def shard_params(flat: Dict[str, torch.Tensor], cfg: ModelConfig,
                 mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full flat {path: tensor} tree."""
    check_mesh(cfg, mesh)
    specs = param_specs(cfg)
    sizes = {a: mesh.size(a) for a in MESH_AXES}
    place = None
    if mesh.vpp > 1:
        place = torch.from_numpy(
            vpp_place_indices(cfg.num_layers, mesh.pp, mesh.vpp)[0])
    out = {}
    for path, x in flat.items():
        if not stage_holds(path, cfg, mesh):
            continue
        if place is not None and path.startswith("layers/"):
            x = x[place.to(x.device)]
        glu = _glu_dim(path, cfg)
        if glu is not None and glu < 0:
            glu += x.dim()
        out[path] = shard_leaf(x, specs[path], mesh.coords, sizes,
                               glu_dim=glu)
    return out


#: a task tree (the TrainLoop hooks' trees: T5's stacks, BERT with a
#: task head, the biencoder's towers): {path: (global shape, spec)}.
#: Every pipeline stage holds every leaf of one, cut over "pipe" only
#: where its spec says so (T5's stacked layers under its pipeline).
TaskTree = Dict[str, Tuple[tuple, P]]

#: the heads every tensor rank computes whole from the [CLS] row
#: (models/bert.py pooled, the classification and ict heads): their
#: gradients are whole on every tensor rank, so the tensor group's sum
#: that sequence parallelism gives the other replicated leaves skips them
REPLICATED_HEADS = ("pooler", "binary_head", "classification_head",
                    "ict_head")


def replicated_head(path: str) -> bool:
    return any(part in REPLICATED_HEADS for part in path.split("/"))


def task_tree(params: Dict[str, Any], specs: Dict[str, P]) -> TaskTree:
    """The TaskTree of a whole (unsharded) parameter tree and its flat
    specs."""
    return {path: (tuple(t.shape), P(*specs[path]))
            for path, t in _flatten(params).items()}


def _tables(cfg: ModelConfig, tree: Optional[TaskTree]):
    """({path: shape}, {path: spec}) of the decoder table or a task
    tree."""
    if tree is None:
        return param_shapes(cfg), param_specs(cfg)
    return ({k: s for k, (s, _) in tree.items()},
            {k: spec for k, (_, spec) in tree.items()})


def shard_task_params(params: Dict[str, Any], tree: TaskTree, mesh
                      ) -> Dict[str, Any]:
    """This rank's slices of a whole task tree (shard_leaf by its
    specs)."""
    sizes = {a: mesh.size(a) for a in MESH_AXES}
    return _nest({path: shard_leaf(t.detach(), tree[path][1], mesh.coords,
                                   sizes)
                  for path, t in _flatten(params).items()})


def leaf_layout(cfg: ModelConfig, mesh, zero1: bool,
                tree: Optional[TaskTree] = None
                ) -> Dict[str, Tuple[P, Optional[int], bool]]:
    """{path: (spec, zero1 dim, owner)} for the leaves this rank holds
    (of the decoder table, or of a task tree).

    zero1 dim: the dimension ZeRO-1 cuts this rank's optimizer state
    along (parallel/sharding.zero1_spec on the global shape; None when
    zero1 is off, dp is 1 or no dimension divides). owner: whether this
    rank counts the leaf in a global sum over every rank (the grad
    norm): a leaf replicated over an axis is counted at index 0 of that
    axis only, a sharded one on every rank of the axis, so each element
    is counted once."""
    shapes, specs = _tables(cfg, tree)
    out = {}
    for path in shapes:
        if tree is None and not stage_holds(path, cfg, mesh):
            continue
        spec = specs[path]
        zdim = (zero1_dim(spec, shapes[path], mesh.dp, mesh.ep)
                if zero1 else None)
        owner = True
        # a leaf ZeRO-1 leaves whole is replicated over the data ranks
        # (an expert leaf) or over data x expert (the rest)
        if zdim is None and mesh.index(zero1_axes(spec)) != 0:
            owner = False
        if AXIS_TENSOR not in spec_axes(spec) and mesh.tp_rank != 0:
            owner = False
        if mesh.cp_rank != 0:
            owner = False             # replicated over the context ranks
        if tree is None and path == "embed/tokens" and mesh.pp > 1 and \
                not mesh.is_first_stage:
            owner = False             # the tied copy on the last stage
        if (tree is not None and AXIS_PIPE not in spec_axes(spec)
                and mesh.pp_rank != 0):
            owner = False             # every stage holds a task leaf
        out[path] = (spec, zdim, owner)
    return out


class StatePlacement:
    """Where each rank's TrainState leaves lie in the global tensors: the
    input of the sharded checkpoint layout (training/checkpointing.py).

    For every rank of a topology (not only this one) it gives the
    pieces of a leaf that rank holds (parallel/sharding.block_pieces:
    the spec's cut, the GLU halves, the interleaved layer chunks, and
    for the optimizer state with ZeRO-1 the data ranks' cut of
    zero1_spec), and which rank writes a block: the lowest global rank
    that holds it, so a block replicated over data, tensor or pipeline
    ranks is written once. group: the host-side group the ranks agree
    on a load's iteration over (MeshRuntime.control_group)."""

    OPT_FIELDS = ("master", "mu", "nu")

    def __init__(self, cfg: ModelConfig, parallel, world_size: int,
                 rank: int, zero1: bool, group=None,
                 tree: Optional[TaskTree] = None):
        parallel = parallel.validate()
        grid = rank_grid(parallel, world_size)
        self.cfg, self.parallel = cfg, parallel
        self.world_size, self.rank, self.group = world_size, rank, group
        self.sizes = dict(zip(MESH_AXES, (int(n) for n in grid.shape)))
        self.coords = [dict(zip(MESH_AXES, (int(c) for c in
                                            np.unravel_index(r, grid.shape))))
                       for r in range(world_size)]
        self.dp = self.sizes["data"] * self.sizes[AXIS_EXPERT]
        self.ep = self.sizes[AXIS_EXPERT]
        self.zero1 = bool(zero1) and self.dp > 1
        self.tree = tree
        self.shapes, self.specs = _tables(cfg, tree)
        self._writer: Dict[tuple, int] = {}

    @classmethod
    def of(cls, cfg: ModelConfig, mesh, zero1: bool,
           tree: Optional[TaskTree] = None) -> "StatePlacement":
        return cls(cfg, mesh.parallel, mesh.world_size, mesh.rank, zero1,
                   group=mesh.control_group, tree=tree)

    def _holds(self, path: str, c: Dict[str, int]) -> bool:
        pp = self.sizes[AXIS_PIPE]
        if pp == 1 or self.tree is not None or path.startswith("layers/"):
            return True
        first, last = c[AXIS_PIPE] == 0, c[AXIS_PIPE] == pp - 1
        if path == "embed/tokens":
            return first or (self.cfg.tie_embed_logits and last)
        return first if path.startswith("embed/") else last

    def zero1_dim(self, field: str, path: str) -> Optional[int]:
        """The dimension ZeRO-1 cuts this optimizer-state leaf along."""
        if not self.zero1 or field not in self.OPT_FIELDS:
            return None
        return zero1_dim(self.specs[path], self.shapes[path], self.dp,
                         self.ep)

    def spec(self, field: str, path: str) -> P:
        spec = self.specs[path]
        if self.zero1_dim(field, path) is not None:
            spec = zero1_spec(spec, self.shapes[path], self.dp, self.ep)
        return spec

    def pieces(self, field: str, path: str,
               rank: Optional[int] = None) -> List[Piece]:
        """The pieces of leaf `path` of `field` that `rank` (default:
        this one) holds; [] when its stage does not hold the leaf."""
        c = self.coords[self.rank if rank is None else rank]
        if not self._holds(path, c):
            return []
        shape = self.shapes[path]
        glu = _glu_dim(path, self.cfg)
        if glu is not None and glu < 0:
            glu += len(shape)
        v = self.parallel.virtual_pipeline_parallel or 1
        chunks = ((v, self.sizes[AXIS_PIPE])
                  if v > 1 and self.tree is None
                  and path.startswith("layers/") else None)
        return block_pieces(self.spec(field, path), shape, c, self.sizes,
                            glu_dim=glu, layer_chunks=chunks)

    def writes(self, field: str, path: str, piece: Piece) -> bool:
        """Whether this rank is the lowest rank holding `piece`'s box."""
        key = (field, path, piece[0], piece[2])
        if key not in self._writer:
            self._writer[key] = next(
                r for r in range(self.world_size)
                if any((g, n) == key[2:]
                       for g, _, n in self.pieces(field, path, r)))
        return self._writer[key] == self.rank


def empty_params(cfg: ModelConfig, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 mesh=None) -> Dict[str, Any]:
    """The parameter tree, uninitialized: the target of a checkpoint
    load (training/checkpointing.load_params_only); with a mesh, this
    rank's slices of it."""
    dtype = dtype or cfg.dtype
    if mesh is not None:
        meta = shard_params({path: torch.empty(shape, device="meta")
                             for path, (shape, _, _) in _defs(cfg).items()},
                            cfg, mesh)
        return _nest({path: torch.empty(t.shape, dtype=dtype, device=device)
                      for path, t in sorted(meta.items())})
    return _nest({path: torch.empty(shape, dtype=dtype, device=device)
                  for path, (shape, _, _) in sorted(_defs(cfg).items())})


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                dtype: Optional[torch.dtype] = None,
                mesh=None) -> Dict[str, Any]:
    """Random-init the full parameter tree on `device` (with a mesh:
    this rank's slices of it, the same logical weights at any topology).

    Each tensor draws from its own torch.Generator seeded from the seed
    and a stable hash of its path (the JAX package folds the same hash
    into its key), so adding or removing an optional parameter never
    perturbs the others. The draws differ from jax.random's: parity
    tests share weights through params_from_numpy instead."""
    dtype = dtype or cfg.dtype
    device = torch.device(device)
    scaled_std = (cfg.init_method_std / math.sqrt(2.0 * cfg.num_layers)
                  if cfg.use_scaled_init else cfg.init_method_std)
    flat = {}
    for path, (shape, _, kind) in sorted(_defs(cfg).items()):
        if mesh is not None and not stage_holds(path, cfg, mesh):
            continue
        std = scaled_std if kind == _SCALED else cfg.init_method_std
        flat[path] = init_leaf(path, shape, kind, std, seed, device, dtype)
    if mesh is not None:
        flat = shard_params(flat, cfg, mesh)
    return _nest(flat)


def init_leaf(path: str, shape: tuple, kind: str, std: float, seed: int,
              device, dtype: torch.dtype) -> torch.Tensor:
    """One leaf of init kind `kind` (_ONES, _ZEROS, or a normal of `std`
    drawn from a generator seeded from `seed` and a hash of `path`)."""
    if kind == _ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == _ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(path.encode(), int(seed) & 0xFFFFFFFF))
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, std, generator=gen)


def tree_from_numpy(tree: Dict[str, Any], want: Dict[str, tuple],
                    device="cuda", dtype: torch.dtype = torch.float32
                    ) -> Dict[str, Any]:
    """A JAX parameter tree of numpy arrays -> a nested dict of tensors,
    checked path by path and shape by shape against `want` ({path:
    shape}): the form params_from_numpy takes for the trees the decoder
    table does not describe (models/t5.py, models/biencoder.py)."""
    flat = _flatten(tree)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for path, arr in flat.items():
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(want[path]):
            raise ValueError(f"{path}: shape {a.shape} != {want[path]}")
        out[path] = torch.from_numpy(
            np.ascontiguousarray(a.astype(np.float32))).to(
                device=device, dtype=dtype)
    return _nest(out)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                      dtype: Optional[torch.dtype] = None,
                      mesh=None) -> Dict[str, Any]:
    """A JAX parameter tree, as nested dicts of numpy arrays
    (jax.device_get(params)), -> this package's parameter tree (with a
    mesh: this rank's slices, by the rule of JAX's shard_tree).

    Checks the tree against _defs(cfg) path by path and shape by shape,
    so a mismatched config fails here instead of computing garbage."""
    want = param_shapes(cfg)
    flat = _flatten(tree)
    quant = {}          # weight-quantized leaves: path -> {part: array}
    for path in list(flat):
        head, _, part = path.rpartition("/")
        if part in ("q8", "f8", "s") and head in want:
            quant.setdefault(head, {})[part] = flat.pop(path)
    if quant and mesh is not None:
        raise ValueError("weight-quantized trees are single-card serving "
                         "trees: no mesh")
    flat.update(quant)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"unexpected {extra}")
    dtype = dtype or cfg.dtype
    out = {}
    for path, arr in flat.items():
        if isinstance(arr, dict):
            out[path] = _quantized_leaf(path, arr, want[path], device)
            continue
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(want[path]):
            raise ValueError(f"{path}: shape {a.shape} != {want[path]}")
        if mesh is not None and not stage_holds(path, cfg, mesh):
            continue
        out[path] = torch.from_numpy(
            np.ascontiguousarray(a.astype(np.float32))).to(
                device=device, dtype=dtype)
    if mesh is not None:
        out = shard_params(out, cfg, mesh)
    return _nest(out)


def _quantized_leaf(path: str, leaf: Dict[str, Any], shape: tuple,
                    device) -> Dict[str, torch.Tensor]:
    """A JAX {"q8" | "f8", "s"} leaf as tensors: int8 stays int8, and the
    ml_dtypes float8_e4m3fn payload (numpy has no fp8 type of its own)
    crosses as its bytes (uint8) and is viewed as torch.float8_e4m3fn."""
    kind = "q8" if "q8" in leaf else "f8"
    payload = np.asarray(leaf[kind])
    if tuple(payload.shape) != tuple(shape):
        raise ValueError(f"{path}/{kind}: shape {payload.shape} != {shape}")
    if kind == "q8":
        t = torch.from_numpy(np.ascontiguousarray(payload, np.int8))
    else:
        t = torch.from_numpy(np.ascontiguousarray(payload).view(
            np.uint8)).view(torch.float8_e4m3fn)
    s = torch.from_numpy(np.ascontiguousarray(leaf["s"], np.float32))
    return {kind: t.to(device), "s": s.to(device)}
