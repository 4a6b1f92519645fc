"""Checkpoint save and load, crash-safe (counterpart of
megatron_tpu/training/checkpointing.py).

The JAX package's commit protocol and directory layout, file for file:

  <save>/latest_checkpointed_iteration.txt     the tracker
  <save>/iter_XXXXXXX/meta.json                iteration, consumed
                                               samples, run config
  <save>/iter_XXXXXXX/manifest.json            path -> size + crc32 of
                                               every other file
  <save>/iter_XXXXXXX/state/...                the TrainState

A save is staged into `iter_XXXXXXX.tmp/`; `manifest.json` is written
last, as the commit record; the staging dir is renamed into place with
os.replace and only then is the tracker bumped (itself through a tmp
file + os.replace). A kill at any point leaves a committed checkpoint or
an ignorable `.tmp` dir. Readers verify the manifest, and a resume whose
tracker is garbage or points at a torn checkpoint falls back, with a
warning, to the newest valid one.

Storage is torch.save in place of orbax: one file per TrainState field,
`state/<field>.pt` (params, master, mu, nu, step, scaler,
nonfinite_streak); a field that is None (fp32 runs keep no masters, bf16
runs no loss scaler) has no file. Each file holds a dict {name: tensor}:
a tree's leaf_paths, the scaler's three fields, or {field: tensor} for a
scalar. Every tensor is a contiguous CPU copy of its own, since
torch.save of a view writes the view's whole storage.

A multi-rank run (a StatePlacement, models/params.py) writes the
sharded layout instead, one logical checkpoint that loads at any
topology, as the JAX package's orbax checkpoint does. Each rank writes
`state/<field>.r<rank>.pt`: the blocks of that field it is the lowest
global rank to hold (a block replicated over data, tensor or pipeline
ranks is written once; ZeRO-1's master/mu/nu blocks are cut along their
data dimension; step, scaler and nonfinite_streak are written by rank
0), packed into one storage per dtype, so the bytes on disk are a
world-1 save's. `state/layout.json` records, per leaf of every field,
its global shape, dtype, spec and ZeRO-1 dimension and each block's
file, key and box (global offsets and sizes). A load at any topology
(or of the one-file-per-field layout) copies into each of the rank's
pieces the overlap of every saved block (parallel/sharding
.copy_overlap), reading the files through torch.load(mmap=True), so a
rank's host memory holds its slice, not the model; load_params_only
assembles whole leaves for world-1 readers.

The commit at world size > 1 is the JAX package's shared-directory vote
(shared_write): after a host-side barrier (rank 0 has committed the
previous save and made the staging dir), every rank writes and fsyncs
its files into the shared `iter_XXXXXXX.tmp/` and then a vote file
`votes/r<rank>.json` holding its part of the layout and the size and
crc32 of its files (each rank hashes its own bytes, in parallel); rank
0's finalizer waits for every vote (VOTE_TIMEOUT_S, else the save fails
loudly and leaves an ignorable `.tmp`), writes layout.json, drops the
votes and commits as above, its manifest taking the voted entries. The saver threads call no collective: only save()
itself, on the loop's thread, takes the barrier, and a load agrees on
the iteration by a broadcast from rank 0.

Multi-host (a `coordinator` from training/coordination.py, on each
host's local rank 0): the commit becomes two-phase, and the
coordinator's `commit_barrier` is the step that decides. No tracker
flips until every host has published `staged(iteration, crc)`, so a
death mid-save anywhere in the cluster aborts the commit everywhere
(coordination.CommitAborted, journaled `commit_abort`; the staging dir
stays for the next cleanup). One file per field (a host of world size 1
with its own save dir): each host writes its meta.json and manifest,
votes with the manifest's crc32 and, on agreement, commits its own dir.
The sharded layout: every rank votes as above; a host's leader stages
once its own ranks' votes are down (the crc32 of their entries), and
rank 0's finalizer commits only after the barrier, when every rank of
every host has voted, so the barrier is the cluster-level agreement
over the votes, not a second protocol beside them.

A checkpoint whose state predates a TrainState field (one of the
fields that are never None, say nonfinite_streak) restores exactly the
fields it recorded; the missing ones keep the template's values, with a
warning. A field the dataclass does not know fails hard.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from megatron_tpu_torch.parallel.sharding import copy_overlap
from megatron_tpu_torch.training import resilience
from megatron_tpu_torch.training.optimizer import (
    ScalerState, TrainState, leaf_paths, nest_paths,
)

TRACKER = "latest_checkpointed_iteration.txt"
MANIFEST = "manifest.json"
STAGING_SUFFIX = ".tmp"
DISPLACED_SUFFIX = ".old"
STATE_DIR = "state"
LAYOUT = "layout.json"
LAYOUT_FORMAT = "torch-sharded-1"
VOTES_DIR = "votes"
#: rank 0 waits this long for every rank's vote (the process group's
#: timeout, parallel/distributed.py)
VOTE_TIMEOUT_S = 600.0
#: the TrainState fields that are parameter trees (cut by the placement)
TREE_FIELDS = ("params", "master", "mu", "nu")
CHECKPOINT_VERSION = "torch-1.0"
FIELDS = tuple(f.name for f in dataclasses.fields(TrainState))
#: the TrainState fields a run may hold as None (fp32 runs keep no
#: masters, bf16 runs no loss scaler): a checkpoint without one of them
#: recorded None; without any other field it predates that field
OPTIONAL_FIELDS = ("master", "scaler")
_ITER_RE = re.compile(r"^iter_(\d{7})$")
_STAGING_RE = re.compile(r"^iter_(\d{7})\.tmp$")
_DISPLACED_RE = re.compile(r"^(iter_\d{7})\.old$")


def checkpoint_dir(save: str, iteration: int) -> str:
    return os.path.join(os.path.abspath(save), f"iter_{iteration:07d}")


def _staging_dir(save: str, iteration: int) -> str:
    return checkpoint_dir(save, iteration) + STAGING_SUFFIX


def read_tracker(load: str) -> Optional[int]:
    """Latest committed iteration per the tracker file, or None.

    A tracker truncated to emptiness or garbage by a crash is treated as
    missing (with a warning naming the file), so resume can fall back to
    the newest valid checkpoint."""
    path = os.path.join(load, TRACKER)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        content = f.read().strip()
    try:
        return int(content)
    except ValueError:
        warnings.warn(
            f"checkpoint tracker {path} is unreadable (content "
            f"{content[:50]!r}); treating it as missing so resume can fall "
            "back to the newest valid checkpoint")
        return None


# -- manifest / verification -------------------------------------------------


def _crc32_file(path: str, chunk: int = 1 << 20) -> str:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def compute_manifest(path: str, hashes: bool = True,
                     known: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """{relpath: {size, crc32}} over every file under `path` except the
    manifest itself. known: entries already hashed (another rank's
    files, by that rank), reused while the size on disk matches."""
    files: Dict[str, Any] = {}
    for root, _, names in os.walk(path):
        for name in sorted(names):
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, path)
            if rel == MANIFEST:
                continue
            entry: Dict[str, Any] = {"size": os.path.getsize(fp)}
            if known and known.get(rel, {}).get("size") == entry["size"]:
                entry = dict(known[rel])
            elif hashes:
                entry["crc32"] = _crc32_file(fp)
            files[rel] = entry
    return files


def write_manifest(path: str, iteration: int,
                   tags: Tuple[str, ...] = (),
                   known: Optional[Dict[str, Any]] = None) -> str:
    """Write the commit record, the last file of the staging dir: its
    presence means every byte it lists was on disk when it was made. The
    crc32 pass re-reads every byte just written (but the files in
    `known`, which their writers hashed); on the async path it runs on
    the saver's thread. tags: provenance ("preemption": the checkpoint a
    SIGTERM notice forced, which retention keeps)."""
    man = {"format": 1, "iteration": int(iteration),
           "files": compute_manifest(path, known=known)}
    if tags:
        man["tags"] = sorted(set(tags))
    out = os.path.join(path, MANIFEST)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)
    return out


def verify_checkpoint(path: str, deep: bool = False) -> Tuple[bool, str]:
    """(ok, detail) for one checkpoint dir. Shallow: every manifest entry
    exists with its recorded size. deep=True also checks the crc32s. A
    dir without a manifest passes as "legacy" when it has meta.json and
    state/ (the JAX package's rule)."""
    if not os.path.isdir(path):
        return False, "missing directory"
    if path.rstrip("/").endswith(STAGING_SUFFIX):
        return False, "uncommitted staging dir"
    man_path = os.path.join(path, MANIFEST)
    if not os.path.exists(man_path):
        if (os.path.exists(os.path.join(path, "meta.json"))
                and os.path.isdir(os.path.join(path, STATE_DIR))):
            return True, "legacy checkpoint without manifest (unverified)"
        return False, "no manifest.json and incomplete layout"
    try:
        with open(man_path) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (ValueError, KeyError, OSError) as e:
        return False, f"unreadable manifest: {type(e).__name__}: {e}"
    for rel, info in files.items():
        fp = os.path.join(path, rel)
        if not os.path.exists(fp):
            return False, f"missing file {rel}"
        size = os.path.getsize(fp)
        if size != info["size"]:
            return False, (f"size mismatch for {rel}: manifest "
                           f"{info['size']}, on disk {size}")
        if deep and "crc32" in info:
            crc = _crc32_file(fp)
            if crc != info["crc32"]:
                return False, (f"checksum mismatch for {rel}: manifest "
                               f"{info['crc32']}, on disk {crc}")
    return True, f"{len(files)} files ok" + (" (deep)" if deep else "")


def checkpoint_tags(path: str) -> Tuple[str, ...]:
    """Provenance tags recorded in a checkpoint's manifest (() when the
    manifest is missing or unreadable or carries none)."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            return tuple(json.load(f).get("tags") or ())
    except (OSError, ValueError):
        return ()


def committed_iterations(load: str) -> List[int]:
    """Iterations with a committed (renamed-into-place) dir, sorted."""
    if not os.path.isdir(load):
        return []
    out = []
    for name in os.listdir(load):
        m = _ITER_RE.match(name)
        if m and os.path.isdir(os.path.join(load, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def list_valid_checkpoints(load: str, deep: bool = False) -> List[int]:
    """Sorted iterations whose checkpoint passes verify_checkpoint."""
    return [it for it in committed_iterations(load)
            if verify_checkpoint(checkpoint_dir(load, it), deep=deep)[0]]


def cleanup_staging(save: str, min_age_seconds: float = 0.0) -> List[str]:
    """Remove uncommitted `iter_XXXXXXX.tmp` staging dirs; returns their
    names. The process that owns a save dir calls it when nothing is
    writing there (min_age_seconds 0); min_age_seconds > 0 spares a
    staging dir with a file written within that window, for external
    callers (`checkpoint_util prune`) that may run beside a live run's
    async save. Also repairs a crashed same-iteration re-save: a lone
    `iter_XXXXXXX.old` (the committed old checkpoint, shoved aside by
    _finalize) is renamed back into place."""
    removed = []
    if not os.path.isdir(save):
        return removed
    for name in os.listdir(save):
        m = _DISPLACED_RE.match(name)
        if not m:
            continue
        original = os.path.join(save, m.group(1))
        if os.path.isdir(original):
            shutil.rmtree(os.path.join(save, name), ignore_errors=True)
        else:
            os.replace(os.path.join(save, name), original)
    now = time.time()
    for name in os.listdir(save):
        if not _STAGING_RE.match(name):
            continue
        path = os.path.join(save, name)
        if min_age_seconds > 0:
            newest = max((os.path.getmtime(os.path.join(r, f))
                          for r, _, fs in os.walk(path) for f in fs),
                         default=os.path.getmtime(path))
            if now - newest < min_age_seconds:
                continue  # possibly a live writer's staging dir
        shutil.rmtree(path, ignore_errors=True)
        removed.append(name)
    return removed


def prune_checkpoints(save: str, keep_latest_k: int,
                      dry_run: bool = False) -> List[int]:
    """Delete all but the newest keep_latest_k committed checkpoints.
    Only manifested ones are eligible; the tracker's target is never
    pruned, nor is the newest checkpoint tagged "preemption" (the resume
    anchor a restart after a preemption depends on). Returns the pruned
    iterations (with dry_run, those it would prune, deleting nothing)."""
    if not keep_latest_k or keep_latest_k < 1:
        return []
    committed = [it for it in committed_iterations(save)
                 if os.path.exists(os.path.join(checkpoint_dir(save, it),
                                                MANIFEST))]
    keep = set(committed[-keep_latest_k:])
    tracked = read_tracker(save)
    if tracked is not None:
        keep.add(tracked)
    preempted = [it for it in committed
                 if "preemption" in checkpoint_tags(checkpoint_dir(save, it))]
    if preempted:
        keep.add(preempted[-1])
    pruned = []
    for it in committed:
        if it not in keep:
            if not dry_run:
                shutil.rmtree(checkpoint_dir(save, it), ignore_errors=True)
            pruned.append(it)
    return pruned


def resolve_load_iteration(load: str, iteration: Optional[int] = None,
                           deep: bool = False) -> Tuple[int, Optional[str]]:
    """Which iteration to load: (iteration, fallback_reason or None).

    An explicitly requested iteration is trusted as is. Otherwise the
    tracker's target is verified, and on failure (or a missing or
    garbage tracker) resume falls back to the newest valid checkpoint
    with a loud warning, removing uncommitted staging dirs first. Raises
    FileNotFoundError only when nothing loadable exists."""
    if iteration is not None:
        return iteration, None
    problems = []
    it = read_tracker(load)
    if it is not None:
        ok, detail = verify_checkpoint(checkpoint_dir(load, it), deep=deep)
        if ok:
            return it, None
        problems.append(f"tracker points at iteration {it} but it failed "
                        f"verification ({detail})")
    else:
        problems.append("tracker missing or unreadable")
    stale = cleanup_staging(load)
    if stale:
        problems.append(f"removed uncommitted staging dirs: {stale}")
    valid = list_valid_checkpoints(load, deep=deep)
    if not valid:
        if it is None and not committed_iterations(load):
            raise FileNotFoundError(f"no checkpoint tracker in {load}")
        raise FileNotFoundError(
            f"no valid checkpoint in {load} ({'; '.join(problems)})")
    reason = "; ".join(problems)
    warnings.warn(
        f"checkpoint resume falling back to iteration {valid[-1]} in "
        f"{load}: {reason}")
    return valid[-1], reason


# -- the state on disk -------------------------------------------------------


def _state_fields(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """{field: {name: tensor}} of the TrainState fields that are set, as
    their files hold them."""
    out = {}
    for name in FIELDS:
        value = getattr(state, name)
        if value is None:
            continue
        if isinstance(value, torch.Tensor):
            out[name] = {name: value}
        elif isinstance(value, ScalerState):
            out[name] = {f.name: getattr(value, f.name)
                         for f in dataclasses.fields(value)}
        else:
            out[name] = dict(leaf_paths(value))
    return out


def _to_host(fields: Dict[str, Dict[str, torch.Tensor]],
             buffers: Optional[Dict[Tuple[str, str], torch.Tensor]] = None
             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Contiguous CPU copies of every tensor, landed when this returns.

    From the card the copies go into pinned buffers, taken from and kept
    in `buffers` when it is given (allocating gigabytes of pinned memory
    takes seconds, so a saver reuses them), all issued before one event
    that the host waits on."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    streams = {}
    for field, flat in fields.items():
        host = {}
        for name, t in flat.items():
            buf = buffers.get((field, name)) if buffers is not None else None
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda)
                if buffers is not None:
                    buffers[(field, name)] = buf
            buf.copy_(t.detach(), non_blocking=t.is_cuda)
            if t.is_cuda:
                streams[t.device] = torch.cuda.current_stream(t.device)
            host[name] = buf
        out[field] = host
    for stream in streams.values():
        event = torch.cuda.Event()
        event.record(stream)
        event.synchronize()
    return out


def _write_state(stage: str, host: Dict[str, Dict[str, torch.Tensor]],
                 suffix: str = "") -> int:
    """state/<field><suffix>.pt for each field, each fsynced; returns the
    bytes written."""
    d = os.path.join(stage, STATE_DIR)
    os.makedirs(d, exist_ok=True)
    total = 0
    for field, flat in host.items():
        path = os.path.join(d, field + suffix + ".pt")
        with open(path, "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())
        total += os.path.getsize(path)
    return total


def _saved_fields(path: str) -> Dict[str, str]:
    """{field: file} of a checkpoint's state/ dir. A field this TrainState
    does not know means a newer format, which fails hard."""
    d = os.path.join(path, STATE_DIR)
    files = {n[:-3]: os.path.join(d, n) for n in sorted(os.listdir(d))
             if n.endswith(".pt")}
    unknown = sorted(set(files) - set(FIELDS))
    if unknown:
        raise ValueError(
            f"checkpoint at {path} has unknown TrainState fields {unknown} "
            "— written by a newer version?")
    return files


def _read_field(files: Dict[str, str], field: str
                ) -> Dict[str, torch.Tensor]:
    return torch.load(files[field], map_location="cpu", weights_only=True,
                      mmap=True)


def _whole(name: str, t: torch.Tensor):
    """The one piece of a leaf held whole (a world-1 run)."""
    zero = (0,) * t.dim()
    return [(zero, zero, tuple(t.shape))]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class _Saved:
    """A checkpoint's state/ dir, either layout: the one-file-per-field
    one (each leaf one block at the origin) or the sharded one
    (layout.json). Block tensors are read lazily, through
    torch.load(mmap=True), only when a block overlaps a target piece;
    read_bytes counts the bytes copied out of them."""

    def __init__(self, path: str):
        self.path = path
        layout = os.path.join(path, STATE_DIR, LAYOUT)
        self.layout = None
        if os.path.exists(layout):
            with open(layout) as f:
                self.layout = json.load(f)["fields"]
            unknown = sorted(set(self.layout) - set(FIELDS))
            if unknown:
                raise ValueError(
                    f"checkpoint at {path} has unknown TrainState fields "
                    f"{unknown} — written by a newer version?")
            self.fields = set(self.layout)
        else:
            self.files = _saved_fields(path)
            self.fields = set(self.files)
        self._open: Dict[str, Dict[str, torch.Tensor]] = {}
        self.read_bytes = 0

    def _field(self, field: str) -> Dict[str, torch.Tensor]:
        if field not in self._open:
            self._open[field] = _read_field(self.files, field)
        return self._open[field]

    def _file(self, name: str) -> Dict[str, torch.Tensor]:
        if name not in self._open:
            self._open[name] = torch.load(
                os.path.join(self.path, STATE_DIR, name), map_location="cpu",
                weights_only=True, mmap=True)
        return self._open[name]

    def names(self, field: str) -> set:
        if self.layout is not None:
            return set(self.layout[field])
        return set(self._field(field))

    def shape(self, field: str, name: str) -> Tuple[int, ...]:
        if self.layout is not None:
            return tuple(self.layout[field][name]["shape"])
        return tuple(self._field(field)[name].shape)

    def blocks(self, field: str, name: str) -> List[tuple]:
        """[(global offsets, sizes, () -> tensor)] of a leaf's blocks."""
        if self.layout is None:
            t = self._field(field)[name]
            zero = (0,) * t.dim()
            return [(zero, tuple(t.shape), lambda t=t: t)]
        return [(tuple(b["offsets"]), tuple(b["sizes"]),
                 lambda b=b: self._file(b["file"])[b["key"]])
                for b in self.layout[field][name]["blocks"]]


def _disjoint(a_off, a_n, b_off, b_n) -> bool:
    return any(x + n <= y or y + m <= x
               for x, n, y, m in zip(a_off, a_n, b_off, b_n))


@torch.no_grad()
def _restore(dst: Dict[str, torch.Tensor], saved: _Saved, field: str,
             where: str, pieces=_whole, global_shape=None,
             strict: bool = True) -> None:
    """dst's tensors (this rank's pieces of each leaf, by `pieces(name,
    t)`) take the overlap of every saved block of `field`, in place,
    cast to dst's dtype. Every element of a piece must be covered.
    global_shape(name, t): the leaf's global shape (default t.shape).
    strict: a saved leaf dst lacks is an error too (a whole-tree load;
    a pipeline stage holds only its own leaves)."""
    names = saved.names(field)
    missing = sorted(set(dst) - names)
    extra = sorted(names - set(dst)) if strict else []
    if missing or extra:
        raise ValueError(f"{where}: no data for {missing}, unexpected "
                         f"{extra} — corrupt or structurally incompatible "
                         "checkpoint")
    for name, t in dst.items():
        have = saved.shape(field, name)
        want = (tuple(global_shape(name, t)) if global_shape is not None
                else tuple(t.shape))
        if have != want:
            raise ValueError(f"{where} {name}: shape {have} != {want}")
    for name, t in dst.items():
        blocks = saved.blocks(field, name)
        for g, loc, n in pieces(name, t):
            view = t[tuple(slice(o, o + k) for o, k in zip(loc, n))]
            got = 0
            for b_off, b_n, get in blocks:
                if _disjoint(g, n, b_off, b_n):
                    continue
                src = get()
                c = copy_overlap(view, g, src, b_off)
                got += c
                saved.read_bytes += c * src.element_size()
            if got != view.numel():
                raise ValueError(
                    f"{where} {name}: the checkpoint covers {got} of the "
                    f"{view.numel()} elements of the box at {g} size {n} — "
                    "corrupt or incomplete checkpoint")


# -- the sharded layout: a rank's blocks, its vote, the merged layout -------


def _spec_json(spec) -> list:
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def _sharded_to_host(state: TrainState, placement,
                     buffers: Optional[Dict[tuple, torch.Tensor]] = None):
    """(host, fragment): the blocks this rank writes, as CPU views of one
    buffer per field and dtype ({field: {key: tensor}}, landed when this
    returns; pinned from the card, kept in `buffers` across saves), and
    its part of layout.json ({field: {leaf: description}})."""
    host: Dict[str, Dict[str, torch.Tensor]] = {}
    fragment: Dict[str, Dict[str, Any]] = {}
    streams = {}
    for field, flat in _state_fields(state).items():
        tree = field in TREE_FIELDS
        items, leaves = [], {}
        for name, t in flat.items():
            if tree:
                pieces = placement.pieces(field, name)
                desc = {"shape": list(placement.shapes[name]),
                        "spec": _spec_json(placement.spec(field, name)),
                        "zero1_dim": placement.zero1_dim(field, name)}
                mine = [p for p in pieces
                        if placement.writes(field, name, p)]
            else:
                desc = {"shape": list(t.shape), "spec": [],
                        "zero1_dim": None}
                mine = _whole(name, t) if placement.rank == 0 else []
            if not mine:
                continue
            blocks = []
            for g, loc, n in mine:
                key = f"{name}@{','.join(map(str, g))}"
                view = t.detach()[tuple(slice(o, o + k)
                                        for o, k in zip(loc, n))]
                items.append((key, view))
                blocks.append({"file": f"{field}.r{placement.rank}.pt",
                               "key": key, "offsets": list(g),
                               "sizes": list(n)})
            leaves[name] = dict(desc, dtype=_dtype_name(t.dtype),
                                blocks=blocks)
        if not items:
            continue
        out = {}
        for dtype in sorted({v.dtype for _, v in items}, key=str):
            group = [(k, v) for k, v in items if v.dtype == dtype]
            total = sum(v.numel() for _, v in group)
            cuda = group[0][1].is_cuda
            buf = (buffers.get((field, dtype)) if buffers is not None
                   else None)
            if buf is None or buf.numel() != total:
                buf = torch.empty(total, dtype=dtype, pin_memory=cuda)
                if buffers is not None:
                    buffers[(field, dtype)] = buf
            off = 0
            for k, v in group:
                dst = buf[off:off + v.numel()].view(v.shape)
                dst.copy_(v, non_blocking=v.is_cuda)
                if v.is_cuda:
                    streams[v.device] = torch.cuda.current_stream(v.device)
                out[k] = dst
                off += v.numel()
        host[field] = out
        fragment[field] = leaves
    for stream in streams.values():
        event = torch.cuda.Event()
        event.record(stream)
        event.synchronize()
    return host, fragment


def _write_json(path: str, obj: Any) -> None:
    """obj as JSON, fsynced, put in place by os.replace."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _vote(stage: str, rank: int, fragment: Dict[str, Any]) -> int:
    """This rank's files are durable: its vote, holding its part of the
    layout and its files' manifest entries (each rank hashes its own, in
    parallel, so the commit does not re-read every rank's bytes).
    Returns the bytes of its files."""
    files = {}
    for name in sorted(os.listdir(os.path.join(stage, STATE_DIR))):
        if name.endswith(f".r{rank}.pt"):
            fp = os.path.join(stage, STATE_DIR, name)
            files[os.path.join(STATE_DIR, name)] = {
                "size": os.path.getsize(fp), "crc32": _crc32_file(fp)}
    d = os.path.join(stage, VOTES_DIR)
    os.makedirs(d, exist_ok=True)
    nbytes = sum(e["size"] for e in files.values())
    _write_json(os.path.join(d, f"r{rank}.json"),
                {"rank": rank, "bytes": nbytes, "fragment": fragment,
                 "files": files})
    return nbytes


def _await_votes(stage: str, ranks, timeout_s: float,
                 iteration: int) -> List[Dict[str, Any]]:
    """The votes of `ranks`, or TimeoutError after timeout_s (the staging
    dir stays uncommitted: an ignorable `.tmp`)."""
    d = os.path.join(stage, VOTES_DIR)
    ranks = list(ranks)
    paths = [os.path.join(d, f"r{r}.json") for r in ranks]
    deadline = time.monotonic() + timeout_s
    while True:
        missing = [r for r, p in zip(ranks, paths) if not os.path.exists(p)]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint iteration {iteration}: ranks {missing} did not "
                f"vote within {timeout_s:g}s; {stage} stays uncommitted and "
                "the tracker keeps the previous checkpoint")
        time.sleep(0.02)
    votes = []
    for p in paths:
        with open(p) as f:
            votes.append(json.load(f))
    return votes


def _write_layout(stage: str, votes: List[Dict[str, Any]], placement
                  ) -> None:
    """state/layout.json from every rank's part; the votes go."""
    fields: Dict[str, Dict[str, Any]] = {}
    for vote in votes:
        for field, leaves in vote["fragment"].items():
            dst = fields.setdefault(field, {})
            for name, desc in leaves.items():
                if name in dst:
                    dst[name]["blocks"].extend(desc["blocks"])
                else:
                    dst[name] = desc
    _write_json(os.path.join(stage, STATE_DIR, LAYOUT), {
        "format": LAYOUT_FORMAT, "world_size": placement.world_size,
        "mesh": placement.sizes, "zero1": placement.zero1,
        "fields": fields})
    shutil.rmtree(os.path.join(stage, VOTES_DIR))


def _multi(placement) -> bool:
    return placement is not None and placement.world_size > 1


#: a load's `iteration` when the hosts agreed on none (a fresh start)
NONE_AGREED = -1


def _resolve(load: str, iteration: Optional[int]) -> int:
    if iteration == NONE_AGREED:
        raise FileNotFoundError(
            f"no checkpoint in {load} is valid on every host")
    return resolve_load_iteration(load, iteration)[0]


def _agreed_iteration(load: str, iteration: Optional[int], placement
                      ) -> int:
    """resolve_load_iteration on rank 0, broadcast to every rank over the
    placement's host-side group (without one, each rank resolves alone:
    nothing is writing). NONE_AGREED raises FileNotFoundError on every
    rank."""
    if not _multi(placement) or placement.group is None:
        return _resolve(load, iteration)
    import torch.distributed as dist

    box: List[Any] = [None]
    if placement.rank == 0:
        try:
            box = [_resolve(load, iteration)]
        except FileNotFoundError as e:
            box = [str(e)]
    dist.broadcast_object_list(box, src=0, group=placement.group)
    if isinstance(box[0], str):
        raise FileNotFoundError(box[0])
    return int(box[0])


# -- save --------------------------------------------------------------------


def _finalize(save: str, stage: str, iteration: int, consumed_samples: int,
              config: Optional[Dict[str, Any]], keep_latest_k: Optional[int],
              log=None, stats: Optional[Dict[str, Any]] = None,
              tags: Tuple[str, ...] = (),
              known: Optional[Dict[str, Any]] = None,
              coordinator=None) -> str:
    """Commit a staged checkpoint whose state files are written:
    meta.json -> manifest (the commit record) -> os.replace into place ->
    tracker bump -> retention. `stats` receives the crc32 pass's seconds
    (manifest_s). coordinator (a host's own save dir, the module
    docstring): after the manifest, the cluster's commit barrier with
    the manifest's crc32; coordination.CommitAborted leaves the staging
    dir uncommitted."""
    save = os.path.abspath(save)
    final = checkpoint_dir(save, iteration)
    meta = {
        "iteration": int(iteration),
        "consumed_train_samples": int(consumed_samples),
        "checkpoint_version": CHECKPOINT_VERSION,
        "config": config or {},
    }
    with open(os.path.join(stage, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    # fault injection: a kill here leaves a fully written but UNcommitted
    # staging dir, the case atomic saves exist for
    resilience.maybe_kill("kill_during_save", iteration)
    resilience.maybe_sleep("slow_save")
    t0 = time.perf_counter()
    manifest = write_manifest(stage, iteration, tags=tags, known=known)
    if stats is not None:
        stats["manifest_s"] = time.perf_counter() - t0
    if coordinator is not None and coordinator.num_hosts > 1:
        coordinator.commit_barrier(iteration, crc=_crc32_file(manifest))
    displaced = None
    if os.path.isdir(final):
        # a re-save of the same iteration: never delete the committed dir
        # before the new one is in place. Shove it aside (atomic rename),
        # publish, then delete; a kill between the renames leaves
        # `iter_XXXXXXX.old`, which cleanup_staging renames back.
        displaced = final + DISPLACED_SUFFIX
        shutil.rmtree(displaced, ignore_errors=True)
        os.replace(final, displaced)
    os.replace(stage, final)
    if displaced is not None:
        shutil.rmtree(displaced, ignore_errors=True)
    tracker_tmp = os.path.join(save, TRACKER + ".tmp")
    with open(tracker_tmp, "w") as f:
        f.write(str(iteration))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tracker_tmp, os.path.join(save, TRACKER))
    if keep_latest_k:
        pruned = prune_checkpoints(save, keep_latest_k)
        if pruned and log:
            log(f"pruned checkpoints {pruned} (keep_latest_k={keep_latest_k})")
    if log:
        log(f"saved checkpoint to {final}")
    return final


def save_checkpoint(save: str, state: TrainState, iteration: int,
                    consumed_samples: int = 0,
                    config: Optional[Dict[str, Any]] = None,
                    tags: Tuple[str, ...] = (), coordinator=None) -> str:
    """Synchronous atomic save: stage -> write -> manifest commit ->
    rename -> tracker bump (two-phase with a coordinator). The train
    loop uses AsyncCheckpointSaver; this is the one-shot path for tools
    and tests."""
    stage = _staging_dir(save, iteration)
    shutil.rmtree(stage, ignore_errors=True)
    os.makedirs(stage)
    _write_state(stage, _to_host(_state_fields(state)))
    return _finalize(save, stage, iteration, consumed_samples, config,
                     keep_latest_k=None, tags=tags, coordinator=coordinator)


class AsyncCheckpointSaver:
    """Owner of the train loop's checkpoint writes.

    save() returns once the state is copied to the host (into pinned
    buffers kept across saves), so the next step may update the device
    tensors in place at once; the file writes, manifest, rename, tracker
    bump and pruning run on a thread. A second save() first waits for
    the previous one; wait() and close() are the flush every exit path
    calls. An error on the thread is raised again at the next
    save()/wait()/close(). `history` holds one record per committed
    save: iteration, stall_s (the save() call), commit_s (save() to the
    tracker bump), manifest_s (the crc32 pass) and bytes.

    journal: an event sink (emit/flush; the telemetry journal) that gets
    `checkpoint_begin` and, from the saver's thread, `checkpoint_commit`
    with the commit's seconds, which last_commit_seconds also keeps (the
    sample --save_interval auto's cadence tuner reads).

    placement (a models/params.StatePlacement of world size > 1): every
    rank of the run owns a saver and calls save() at the same iteration;
    each writes its blocks of the sharded layout and votes, and rank 0's
    thread commits once every rank voted (the module docstring). On a
    rank > 0 a history record ends at its vote (voted_s), and `bytes` is
    that rank's; rank 0's also holds vote_wait_s and bytes_all_ranks.
    save() takes one host-side barrier over placement.group (none
    without a group); the thread calls no collective.

    coordinator (a ClusterCoordinator on a host's local rank 0, set per
    save by the train loop; None on the host's other ranks): the commit
    is two-phase (the module docstring). A cluster that cannot agree
    journals `commit_abort` and the error surfaces at the next
    save()/wait(); no tracker flipped anywhere."""

    def __init__(self, save: str, keep_latest_k: Optional[int] = None,
                 log=None, async_save: bool = True, journal=None,
                 placement=None, coordinator=None):
        self.save_dir = os.path.abspath(save)
        self.keep_latest_k = keep_latest_k
        self.log = log or (lambda _m: None)
        self.async_save = async_save
        self.journal = journal
        self.placement = placement if _multi(placement) else None
        self.rank = self.placement.rank if self.placement else 0
        self.coordinator = coordinator
        self.last_commit_seconds: Optional[float] = None
        self.history: List[Dict[str, Any]] = []
        os.makedirs(self.save_dir, exist_ok=True)
        if self.rank == 0:
            stale = cleanup_staging(self.save_dir)
            if stale:
                self.log(f"removed uncommitted checkpoint staging dirs "
                         f"{stale} (previous run died mid-save)")
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_path: Optional[str] = None

    def _barrier(self) -> None:
        if self.placement is not None and self.placement.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.placement.group)

    def save(self, state: TrainState, iteration: int,
             consumed_samples: int = 0,
             config: Optional[Dict[str, Any]] = None,
             tags: Tuple[str, ...] = ()) -> None:
        t_begin = time.perf_counter()
        self.wait()  # at most one checkpoint in flight
        if self.journal is not None:
            self.journal.emit("checkpoint_begin", iteration=iteration,
                              async_save=self.async_save)
        stage = _staging_dir(self.save_dir, iteration)
        if self.rank == 0:
            shutil.rmtree(stage, ignore_errors=True)
            os.makedirs(stage)
        # the previous save is committed and the staging dir is fresh
        # before any rank writes into it
        self._barrier()
        fragment = None
        if self.placement is not None:
            host, fragment = _sharded_to_host(state, self.placement,
                                              self._buffers)
        else:
            host = _to_host(_state_fields(state), self._buffers)
        stats: Dict[str, Any] = {
            "iteration": iteration,
            "stall_s": time.perf_counter() - t_begin}

        coordinator = self.coordinator

        def finish():
            from megatron_tpu_torch.training.coordination import (
                CommitAborted,
            )

            try:
                known = None      # manifest entries the ranks hashed
                if self.placement is None:
                    stats["bytes"] = _write_state(stage, host)
                else:
                    _write_state(stage, host, f".r{self.rank}")
                    if self.rank != 0:
                        # a rank that dies here never votes: rank 0's
                        # commit times out and nothing is committed
                        resilience.maybe_kill("kill_during_save", iteration)
                    stats["bytes"] = _vote(stage, self.rank, fragment)
                    if coordinator is not None:
                        self._stage_host(coordinator, stage, iteration)
                    if self.rank != 0:
                        stats["voted_s"] = time.perf_counter() - t_begin
                        self._last_path = checkpoint_dir(self.save_dir,
                                                         iteration)
                        self.history.append(stats)
                        return
                    t_vote = time.perf_counter()
                    votes = _await_votes(
                        stage, range(self.placement.world_size),
                        VOTE_TIMEOUT_S, iteration)
                    stats["vote_wait_s"] = time.perf_counter() - t_vote
                    stats["bytes_all_ranks"] = sum(v["bytes"] for v in votes)
                    known = {rel: e for v in votes
                             for rel, e in v["files"].items()}
                    _write_layout(stage, votes, self.placement)
                self._last_path = _finalize(
                    self.save_dir, stage, iteration, consumed_samples,
                    config, self.keep_latest_k, self.log, stats=stats,
                    tags=tags, known=known,
                    coordinator=(coordinator if self.placement is None
                                 else None))
                stats["commit_s"] = time.perf_counter() - t_begin
                self.last_commit_seconds = round(stats["commit_s"], 4)
                self.history.append(stats)
                if self.journal is not None:
                    self.journal.emit(
                        "checkpoint_commit", iteration=iteration,
                        path=self._last_path, async_save=self.async_save,
                        seconds=self.last_commit_seconds)
            except CommitAborted as e:
                # the cluster could not agree: no tracker flipped here
                # (nor, by the same protocol, anywhere else)
                self.log(f"checkpoint commit ABORTED at iteration "
                         f"{iteration}: {e}")
                if self.journal is not None:
                    self.journal.emit(
                        "commit_abort", iteration=iteration, reason=str(e),
                        host=getattr(coordinator, "host", None))
                    try:
                        self.journal.flush()
                    except OSError:
                        pass
                self._error = e
            except BaseException as e:  # noqa: BLE001 - raised at wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(
                target=finish, name=f"ckpt-finalize-{iteration}",
                daemon=True)
            self._thread.start()
        else:
            finish()
            self._raise_pending()

    def _stage_host(self, coordinator, stage: str, iteration: int) -> None:
        """A host leader's phase 1 in the sharded layout: once its own
        ranks (this rank and the LOCAL_WORLD_SIZE - 1 after it, as
        torch.distributed.run numbers them) have voted, publish
        staged(iteration, crc32 of their files' entries) and wait for
        every host's (coordination.CommitAborted when they cannot
        agree)."""
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        ranks = range(self.rank,
                      min(self.rank + local, self.placement.world_size))
        votes = _await_votes(stage, ranks, VOTE_TIMEOUT_S, iteration)
        entries = json.dumps([v["files"] for v in votes], sort_keys=True)
        coordinator.commit_barrier(
            iteration, crc=f"{zlib.crc32(entries.encode()) & 0xFFFFFFFF:08x}")

    def wait(self) -> Optional[str]:
        """Block until the in-flight save (if any) is committed (on a rank
        > 0 of a sharded save: until its vote is down); raise any error
        of its thread. Returns the last committed path."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        self._raise_pending()
        return self._last_path

    def close(self) -> Optional[str]:
        """Flush, and free the pinned host buffers."""
        try:
            return self.wait()
        finally:
            self._buffers.clear()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def saved_run_config(load: str, iteration: Optional[int] = None
                     ) -> Dict[str, Any]:
    """The run config recorded in the checkpoint a resume from `load`
    would read ({} when none was recorded)."""
    it, _ = resolve_load_iteration(load, iteration)
    with open(os.path.join(checkpoint_dir(load, it), "meta.json")) as f:
        return json.load(f).get("config") or {}


# -- load --------------------------------------------------------------------


def load_checkpoint(
    load: str,
    state_template: TrainState,
    iteration: Optional[int] = None,
    finetune: bool = False,
    no_load_optim: bool = False,
    config: Optional[Dict[str, Any]] = None,
    placement=None,
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[TrainState, int, int]:
    """Restore (state, iteration, consumed_samples) into state_template.

    The template (typically the freshly initialized TrainState) gives
    structure, shapes, dtypes and devices; its tensors take the saved
    values in place and it is returned. With iteration None the
    tracker's target is verified first and a torn newest checkpoint
    falls back to the newest valid one (resolve_load_iteration).

    finetune: the weights only; iteration, consumed samples, step and
    optimizer state start fresh (returns iteration 0). no_load_optim:
    the weights, step and iteration, with fresh moments, scaler and
    streak. In both the fp32 masters come from the checkpoint's masters
    when it has them, else from its params. (The JAX package takes the
    template's masters there, which in a bf16 run are the random
    init's, so its first update would drop the loaded weights.)

    config: the current RunConfig.to_dict(); when given (and not
    finetuning) an architecture mismatch with the saved config raises
    before anything is read.

    placement (models/params.StatePlacement): the template holds this
    rank's slices of a multi-rank topology, filled from a checkpoint of
    either layout saved at any topology; rank 0 picks the iteration
    for every rank. stats receives read_bytes, the bytes this rank
    copied out of the checkpoint's blocks."""
    it = _agreed_iteration(load, iteration, placement)
    path = checkpoint_dir(load, it)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if config is not None and not finetune:
        check_config_compatibility(meta.get("config", {}), config)
    saved = _Saved(path)
    files = saved.fields
    weights_only = finetune or no_load_optim
    want = _state_fields(state_template)
    # fields the checkpoint predates: restored from nothing, the template
    # keeps them (a field of OPTIONAL_FIELDS it lacks was None)
    predates = [f for f in FIELDS
                if f not in files and f not in OPTIONAL_FIELDS]
    if predates and not finetune:
        warnings.warn(
            f"checkpoint at {path} predates TrainState fields {predates}; "
            "filling them from the fresh template")

    def restore(dst_field: str, src_field: str) -> None:
        kw = {}
        if placement is not None and dst_field in TREE_FIELDS:
            kw = dict(pieces=lambda n, _t: placement.pieces(dst_field, n),
                      global_shape=lambda n, _t: placement.shapes[n],
                      strict=False)
        _restore(want[dst_field], saved, src_field, f"{path} {src_field}",
                 **kw)

    if "master" in files and "master" not in want:
        # a mixed-precision checkpoint read by a run that keeps no
        # masters (fp32 params): the masters are the truth for params
        restore("params", "master")
    else:
        restore("params", "params")
    if "master" in want:
        if "master" in files:
            restore("master", "master")
        elif weights_only:
            # the masters are the loaded params, as the run holds them
            restore("master", "params")
            with torch.no_grad():
                for (_, m), (_, p) in zip(leaf_paths(state_template.master),
                                          leaf_paths(state_template.params)):
                    m.copy_(m.to(p.dtype))
        else:
            raise ValueError(
                f"checkpoint at {path} has no fp32 masters, which this run "
                "keeps: a full resume needs them (--finetune or "
                "--no_load_optim rebuild them from the params)")
    fields = ([] if finetune else ["step"] if no_load_optim
              else [f for f in FIELDS if f not in ("params", "master")])
    for field in [f for f in fields if f not in predates]:
        if (field in files) != (field in want):
            raise ValueError(
                f"checkpoint at {path} {'has' if field in files else 'lacks'}"
                f" the TrainState field {field!r} and this run "
                f"{'does not keep' if field in files else 'keeps'} one "
                "(a different precision policy?)")
        if field in want:
            restore(field, field)
    if stats is not None:
        stats["read_bytes"] = saved.read_bytes
    if finetune:
        return state_template, 0, 0
    return (state_template, int(meta["iteration"]),
            int(meta["consumed_train_samples"]))


def read_state(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """{field: {name: whole tensor}} of one checkpoint dir's state, either
    layout, assembled on the CPU (checkpoint_util's copy and cast: no
    model is built, so any tree reads)."""
    saved = _Saved(path)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for field in sorted(saved.fields, key=FIELDS.index):
        dtypes = ({n: getattr(torch, d["dtype"])
                   for n, d in saved.layout[field].items()}
                  if saved.layout is not None else None)
        flat = {}
        for name in sorted(saved.names(field)):
            dtype = (dtypes[name] if dtypes is not None
                     else saved._field(field)[name].dtype)
            flat[name] = torch.empty(saved.shape(field, name), dtype=dtype)
        _restore(flat, saved, field, f"{path} {field}")
        out[field] = flat
    return out


def state_from_fields(fields: Dict[str, Dict[str, torch.Tensor]]
                      ) -> TrainState:
    """The TrainState read_state's fields hold (a field the checkpoint
    lacks is None)."""
    def tree(field):
        flat = fields.get(field)
        return None if flat is None else nest_paths(flat)

    scaler = fields.get("scaler")
    return TrainState(
        params=tree("params"), master=tree("master"), mu=tree("mu"),
        nu=tree("nu"),
        step=fields["step"]["step"] if "step" in fields else None,
        scaler=ScalerState(**scaler) if scaler is not None else None,
        nonfinite_streak=(fields["nonfinite_streak"]["nonfinite_streak"]
                          if "nonfinite_streak" in fields else None))


def _map_tree(fn, tree: Any, prefix: str = "") -> Any:
    """fn(path, leaf) over a nested dict, with leaf_paths' path names."""
    return {k: (_map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                if isinstance(v, dict)
                else fn(f"{prefix}/{k}" if prefix else str(k), v))
            for k, v in tree.items()}


def load_params_only(load: str, params_template: Any,
                     iteration: Optional[int] = None, placement=None
                     ) -> Any:
    """Just the model params (serving, export), as a new tree on each
    template leaf's device and dtype, without reading the moments, from
    a checkpoint of either layout saved at any topology (whole leaves;
    with a placement, this rank's slices).

    Prefers the fp32 masters. Whether the checkpoint has them is decided
    from its own state/ files, never by catching a failed read, so a
    corrupt master file raises instead of falling back to the params."""
    it = _agreed_iteration(load, iteration, placement)
    path = checkpoint_dir(load, it)
    saved = _Saved(path)
    key = "master" if "master" in saved.fields else "params"
    want = dict(leaf_paths(params_template))
    missing = sorted(set(want) - saved.names(key))
    if missing:
        raise ValueError(
            f"checkpoint at {path} has no data for {len(missing)} "
            f"requested '{key}' arrays (first: {missing[:3]}) — corrupt or "
            "structurally incompatible checkpoint")
    out = {name: torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for name, t in want.items()}
    kw = {}
    if placement is not None:
        kw = dict(pieces=lambda n, _t: placement.pieces("params", n),
                  global_shape=lambda n, _t: placement.shapes[n])
    _restore(out, saved, key, f"{path} {key}", strict=False, **kw)
    return _map_tree(lambda name, _t: out[name], params_template)


def saved_param_names(load: str, iteration: Optional[int] = None) -> set:
    """The '/'-joined parameter leaf names of the checkpoint a load from
    `load` reads (its masters' when it has them)."""
    it, _ = resolve_load_iteration(load, iteration)
    saved = _Saved(checkpoint_dir(load, it))
    return saved.names("master" if "master" in saved.fields else "params")


#: shape-defining keys: a mismatch would also fail the restore, but with
#: an opaque shape error instead of this check's message
SHAPE_KEYS = ("num_layers", "encoder_num_layers", "decoder_num_layers",
              "hidden_size", "num_attention_heads", "num_kv_heads",
              "ffn_hidden_size", "vocab_size")

#: same-shape drift keys: a mismatch restores cleanly and then trains a
#: different model (same weights, different forward function)
DRIFT_KEYS = ("normalization", "activation", "position_embedding_type",
              "rope_theta", "rope_scaling_factor", "sliding_window_size",
              "tie_embed_logits", "parallel_attn", "parallel_layernorm",
              "use_post_ln", "apply_residual_post_ln", "attn_mask_type",
              "use_bias_linear", "use_bias_qkv", "layernorm_epsilon",
              "num_experts", "moe_top_k", "moe_renorm_gates",
              "moe_dispatch", "moe_capacity_factor", "moe_group_size")


def check_config_compatibility(saved: Dict[str, Any],
                               current: Dict[str, Any]) -> None:
    """Architecture keys must match to resume: shape keys and same-shape
    behavior keys, every mismatch reported at once."""
    saved_model = saved.get("model", {})
    current_model = current.get("model", {})
    if not saved_model or not current_model:
        return
    bad = [f"  {k}: checkpoint={saved_model.get(k)!r} "
           f"current={current_model.get(k)!r}"
           for k in SHAPE_KEYS + DRIFT_KEYS
           if k in saved_model and k in current_model
           and saved_model.get(k) != current_model.get(k)]
    if bad:
        raise ValueError(
            "checkpoint/config architecture mismatch — resuming would "
            "train a different model than the one saved (pass "
            "finetune=True to adopt the weights under the new config "
            "deliberately):\n" + "\n".join(bad))
