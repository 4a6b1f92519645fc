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

Not ported (ROADMAP.md): the multi-host two-phase commit (the JAX
`coordinator`), orbax's sharded layout, and the restore of a checkpoint
that predates a TrainState field.
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

from megatron_tpu_torch.training import resilience
from megatron_tpu_torch.training.optimizer import (
    ScalerState, TrainState, leaf_paths,
)

TRACKER = "latest_checkpointed_iteration.txt"
MANIFEST = "manifest.json"
STAGING_SUFFIX = ".tmp"
DISPLACED_SUFFIX = ".old"
STATE_DIR = "state"
CHECKPOINT_VERSION = "torch-1.0"
FIELDS = tuple(f.name for f in dataclasses.fields(TrainState))
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


def compute_manifest(path: str, hashes: bool = True) -> Dict[str, Any]:
    """{relpath: {size, crc32}} over every file under `path` except the
    manifest itself."""
    files: Dict[str, Any] = {}
    for root, _, names in os.walk(path):
        for name in sorted(names):
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, path)
            if rel == MANIFEST:
                continue
            entry: Dict[str, Any] = {"size": os.path.getsize(fp)}
            if hashes:
                entry["crc32"] = _crc32_file(fp)
            files[rel] = entry
    return files


def write_manifest(path: str, iteration: int,
                   tags: Tuple[str, ...] = ()) -> str:
    """Write the commit record, the last file of the staging dir: its
    presence means every byte it lists was on disk when it was made. The
    crc32 pass re-reads every byte just written; on the async path it
    runs on the saver's thread. tags: provenance ("preemption": the
    checkpoint a SIGTERM notice forced, which retention keeps)."""
    man = {"format": 1, "iteration": int(iteration),
           "files": compute_manifest(path)}
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


def cleanup_staging(save: str) -> List[str]:
    """Remove uncommitted `iter_XXXXXXX.tmp` staging dirs; returns their
    names. The process that owns a save dir calls it when nothing is
    writing there. Also repairs a crashed same-iteration re-save: a lone
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
    for name in os.listdir(save):
        if _STAGING_RE.match(name):
            shutil.rmtree(os.path.join(save, name), ignore_errors=True)
            removed.append(name)
    return removed


def prune_checkpoints(save: str, keep_latest_k: int) -> List[int]:
    """Delete all but the newest keep_latest_k committed checkpoints.
    Only manifested ones are eligible; the tracker's target is never
    pruned, nor is the newest checkpoint tagged "preemption" (the resume
    anchor a restart after a preemption depends on). Returns the pruned
    iterations."""
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


def _write_state(stage: str, host: Dict[str, Dict[str, torch.Tensor]]
                 ) -> int:
    """state/<field>.pt for each field, each fsynced; returns the bytes
    written."""
    d = os.path.join(stage, STATE_DIR)
    os.makedirs(d, exist_ok=True)
    total = 0
    for field, flat in host.items():
        path = os.path.join(d, field + ".pt")
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


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               where: str) -> None:
    """dst's tensors take src's values in place (cast to dst's dtype)."""
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise ValueError(f"{where}: no data for {missing}, unexpected "
                         f"{extra} — corrupt or structurally incompatible "
                         "checkpoint")
    for name, t in dst.items():
        if tuple(src[name].shape) != tuple(t.shape):
            raise ValueError(f"{where} {name}: shape "
                             f"{tuple(src[name].shape)} != {tuple(t.shape)}")
    with torch.no_grad():
        for name, t in dst.items():
            t.copy_(src[name])


# -- save --------------------------------------------------------------------


def _finalize(save: str, stage: str, iteration: int, consumed_samples: int,
              config: Optional[Dict[str, Any]], keep_latest_k: Optional[int],
              log=None, stats: Optional[Dict[str, Any]] = None,
              tags: Tuple[str, ...] = ()) -> str:
    """Commit a staged checkpoint whose state files are written:
    meta.json -> manifest (the commit record) -> os.replace into place ->
    tracker bump -> retention. `stats` receives the crc32 pass's seconds
    (manifest_s)."""
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
    write_manifest(stage, iteration, tags=tags)
    if stats is not None:
        stats["manifest_s"] = time.perf_counter() - t0
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
                    config: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save: stage -> write -> manifest commit ->
    rename -> tracker bump. The train loop uses AsyncCheckpointSaver;
    this is the one-shot path for tools and tests."""
    stage = _staging_dir(save, iteration)
    shutil.rmtree(stage, ignore_errors=True)
    os.makedirs(stage)
    _write_state(stage, _to_host(_state_fields(state)))
    return _finalize(save, stage, iteration, consumed_samples, config,
                     keep_latest_k=None)


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
    sample --save_interval auto's cadence tuner reads)."""

    def __init__(self, save: str, keep_latest_k: Optional[int] = None,
                 log=None, async_save: bool = True, journal=None):
        self.save_dir = os.path.abspath(save)
        self.keep_latest_k = keep_latest_k
        self.log = log or (lambda _m: None)
        self.async_save = async_save
        self.journal = journal
        self.last_commit_seconds: Optional[float] = None
        self.history: List[Dict[str, Any]] = []
        os.makedirs(self.save_dir, exist_ok=True)
        stale = cleanup_staging(self.save_dir)
        if stale:
            self.log(f"removed uncommitted checkpoint staging dirs {stale} "
                     "(previous run died mid-save)")
        self._buffers: Dict[Tuple[str, str], torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_path: Optional[str] = None

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
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
        host = _to_host(_state_fields(state), self._buffers)
        stats: Dict[str, Any] = {
            "iteration": iteration,
            "stall_s": time.perf_counter() - t_begin}

        def finish():
            try:
                stats["bytes"] = _write_state(stage, host)
                self._last_path = _finalize(
                    self.save_dir, stage, iteration, consumed_samples,
                    config, self.keep_latest_k, self.log, stats=stats,
                    tags=tags)
                stats["commit_s"] = time.perf_counter() - t_begin
                self.last_commit_seconds = round(stats["commit_s"], 4)
                self.history.append(stats)
                if self.journal is not None:
                    self.journal.emit(
                        "checkpoint_commit", iteration=iteration,
                        path=self._last_path, async_save=self.async_save,
                        seconds=self.last_commit_seconds)
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

    def wait(self) -> Optional[str]:
        """Block until the in-flight save (if any) is committed; raise any
        error of its thread. Returns the last committed path."""
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
    before anything is read."""
    it, _ = resolve_load_iteration(load, iteration)
    path = checkpoint_dir(load, it)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if config is not None and not finetune:
        check_config_compatibility(meta.get("config", {}), config)
    files = _saved_fields(path)
    weights_only = finetune or no_load_optim
    want = _state_fields(state_template)
    if "master" in files and "master" not in want:
        # a mixed-precision checkpoint read by a run that keeps no
        # masters (fp32 params): the masters are the truth for params
        _copy_into(want["params"], _read_field(files, "master"),
                   f"{path} master")
    else:
        _copy_into(want["params"], _read_field(files, "params"),
                   f"{path} params")
    if "master" in want:
        if "master" in files:
            _copy_into(want["master"], _read_field(files, "master"),
                       f"{path} master")
        elif weights_only:
            _copy_into(want["master"], want["params"], f"{path} params")
        else:
            raise ValueError(
                f"checkpoint at {path} has no fp32 masters, which this run "
                "keeps: a full resume needs them (--finetune or "
                "--no_load_optim rebuild them from the params)")
    restore = ([] if finetune else ["step"] if no_load_optim
               else [f for f in FIELDS if f not in ("params", "master")])
    for field in restore:
        if (field in files) != (field in want):
            raise ValueError(
                f"checkpoint at {path} {'has' if field in files else 'lacks'}"
                f" the TrainState field {field!r} and this run "
                f"{'does not keep' if field in files else 'keeps'} one "
                "(a different precision policy?)")
        if field in want:
            _copy_into(want[field], _read_field(files, field),
                       f"{path} {field}")
    if finetune:
        return state_template, 0, 0
    return (state_template, int(meta["iteration"]),
            int(meta["consumed_train_samples"]))


def _map_tree(fn, tree: Any, prefix: str = "") -> Any:
    """fn(path, leaf) over a nested dict, with leaf_paths' path names."""
    return {k: (_map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                if isinstance(v, dict)
                else fn(f"{prefix}/{k}" if prefix else str(k), v))
            for k, v in tree.items()}


def load_params_only(load: str, params_template: Any,
                     iteration: Optional[int] = None) -> Any:
    """Just the model params (serving, export), as a new tree on each
    template leaf's device and dtype, without reading the moments.

    Prefers the fp32 masters. Whether the checkpoint has them is decided
    from its own state/ files, never by catching a failed read, so a
    corrupt master file raises instead of falling back to the params."""
    it, _ = resolve_load_iteration(load, iteration)
    path = checkpoint_dir(load, it)
    files = _saved_fields(path)
    key = "master" if "master" in files else "params"
    saved = _read_field(files, key)
    want = dict(leaf_paths(params_template))
    missing = sorted(set(want) - set(saved))
    if missing:
        raise ValueError(
            f"checkpoint at {path} has no data for {len(missing)} "
            f"requested '{key}' arrays (first: {missing[:3]}) — corrupt or "
            "structurally incompatible checkpoint")

    def take(name, t):
        if tuple(saved[name].shape) != tuple(t.shape):
            raise ValueError(f"{path} {key}/{name}: shape "
                             f"{tuple(saved[name].shape)} != "
                             f"{tuple(t.shape)}")
        return saved[name].to(device=t.device, dtype=t.dtype)

    return _map_tree(take, params_template)


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
