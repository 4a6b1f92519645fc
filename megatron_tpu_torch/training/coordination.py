"""Cross-process agreement seam for multi-host training (counterpart of
megatron_tpu/training/coordination.py; the same protocols, record keys
and JSON fields, so a JAX coordinator and this one read each other's
records on one directory).

A host is one node of the cluster: one process at world size 1 per
node, or the ranks torch.distributed.run starts on one node. Anything
one host decides alone (drain on SIGTERM, abort on a hang verdict,
commit a checkpoint) would leave its peers wedged inside the next
collective, so those decisions route through here:

  * **signal agreement**: a host that receives a preemption notice
    publishes it; every host reads the cluster-wide union each loop
    pass, agrees on a common exit iteration, and takes the same
    expedited drain + checkpoint path (pretrain.py). The journal's
    `preemption` event records which host the notice landed on
    (`notice_host`).
  * **coordinated abort**: the hang watchdog and the loop's crash path
    publish a poison record before exiting, and a missing heartbeat
    marks a SIGKILLed peer; every host polls between steps and from a
    bounded sideband thread, so peers exit
    `resilience.PEER_ABORT_EXIT_CODE` with a journaled
    `peer_abort{host, cause}` within `--peer_death_timeout_s` instead of
    hanging in a collective until the scheduler's timeout kill.
  * **two-phase checkpoint commit**: each host publishes
    `staged(iteration, crc)` once its bytes are durable; only the
    agreement of all hosts lets a tracker flip (checkpointing._finalize),
    so a mid-save death can never leave the cluster half-committed.
    Resume runs the inverse: hosts agree on the newest checkpoint valid
    everywhere (`agree_resume_iteration`).
  * **restart barrier**: on startup hosts rendezvous and verify they
    agree on the topology (`topology_barrier`) before the loop's first
    collective, and a host-count change is a journaled `elastic_resume`.

Two interchangeable backends, selected by `for_training`:

  * `FileBackend`: records are files under a shared `--coordination_dir`
    (atomic tmp + os.replace writes). Works between plain processes on
    one machine and on any shared filesystem.
  * `StoreBackend`: the process group's c10d store (the TCPStore that
    torch.distributed.run or init_process_group set up), for a run whose
    hosts share one process group. The store has no prefix listing, but
    every record the coordinator reads by prefix is keyed
    `<prefix>/<host>`, so a prefix is read as its num_hosts keys
    (`check`, then `get`). A deleted record is an empty value, never a
    removed key, so a `check` that saw a key is never followed by a
    blocking `get` of a key that vanished.

Staleness: every record carries the publishing host's per-boot nonce and
is believed only if it matches that host's current `boot/<host>` record,
so a crashed-and-restarted host's old SIGTERM/abort records are dead on
arrival (the file backend's directory outlives processes; the store gets
the same filtering for uniformity).

Host identity: MEGATRON_TPU_COORD_HOST / MEGATRON_TPU_COORD_NUM_HOSTS
when set (plain processes that pretend to be hosts), else the
launcher's node rank and node count (GROUP_RANK / GROUP_WORLD_SIZE under
torch.distributed.run). Within a host the coordinator lives on local
rank 0 (LOCAL_RANK); the host's other ranks learn each agreement through
the train loop's MAX-reduce of its flags. A single-host run gets no
coordinator at all: `for_training` returns None and every call site
keeps its single-host behavior.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

COORD_HOST_ENV = "MEGATRON_TPU_COORD_HOST"
COORD_NUM_HOSTS_ENV = "MEGATRON_TPU_COORD_NUM_HOSTS"
#: startup rendezvous bound (topology barrier + resume agreement): hosts
#: may be seconds apart in interpreter and import time, so this is much
#: larger than the steady-state peer-death timeout
STARTUP_TIMEOUT_ENV = "MEGATRON_TPU_COORD_STARTUP_TIMEOUT_S"
DEFAULT_STARTUP_TIMEOUT_S = 300.0
#: torch.distributed.run's node rank and node count
NODE_RANK_ENV = "GROUP_RANK"
NUM_NODES_ENV = "GROUP_WORLD_SIZE"


class CoordinationError(RuntimeError):
    """A coordination protocol failed to reach agreement (timeout,
    topology mismatch, no common valid checkpoint)."""


class CommitAborted(RuntimeError):
    """Two-phase checkpoint commit aborted: not every host staged inside
    the window (peer death, timeout). The tracker was not flipped and
    the staging dir is left for cleanup."""


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class FileBackend:
    """Records as files under a shared directory.

    Keys are slash paths ("sig/0"); each maps to a file whose write is
    atomic (tmp + os.replace), so a reader never sees a torn value."""

    name = "file"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        parts = [p for p in key.split("/") if p]
        return os.path.join(self.root, *parts)

    def put(self, key: str, value: str) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get_all(self, prefix: str) -> Dict[str, str]:
        """{suffix: value} for every record under prefix/."""
        base = self._path(prefix)
        if not os.path.isdir(base):
            return {}
        out: Dict[str, str] = {}
        for name in os.listdir(base):
            if name.endswith(".tmp"):
                continue
            fp = os.path.join(base, name)
            if not os.path.isfile(fp):
                continue
            try:
                with open(fp, encoding="utf-8") as f:
                    out[name] = f.read()
            except OSError:
                continue  # racing a concurrent replace; next poll sees it
        return out

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass


class StoreBackend:
    """The process group's c10d store (torch.distributed's TCPStore).

    Lives as long as the process group's store, which is the right
    lifetime for agreement records. All keys ride under one namespace
    so they never collide with torch's own use of the store. Reads go
    through `check` (non-blocking) before `get` (which blocks on a
    missing key)."""

    name = "store"

    def __init__(self, num_hosts: int, store=None,
                 namespace: str = "megatron_tpu_coord"):
        if store is None:
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()):
                raise CoordinationError(
                    "torch.distributed is not initialized: the store "
                    "coordination backend needs the process group's store")
            # no public accessor for the default group's store
            store = dist.distributed_c10d._get_default_store()
        self._store = store
        self.num_hosts = int(num_hosts)
        self._ns = namespace.rstrip("/")

    def _key(self, key: str) -> str:
        return f"{self._ns}/{key}"

    def put(self, key: str, value: str) -> None:
        self._store.set(self._key(key), value)

    def get_all(self, prefix: str) -> Dict[str, str]:
        """{host: value} of the records `prefix/<host>` that are set and
        not deleted."""
        prefix = prefix.rstrip("/")
        out: Dict[str, str] = {}
        for h in range(self.num_hosts):
            key = self._key(f"{prefix}/{h}")
            if not self._store.check([key]):
                continue
            value = self._store.get(key).decode("utf-8")
            if value:
                out[str(h)] = value
        return out

    def delete(self, key: str) -> None:
        self._store.set(self._key(key), "")


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------


class ClusterCoordinator:
    """The four agreement protocols over a backend.

    One instance per host; `host` in [0, num_hosts). All waits are
    bounded polls: a protocol that cannot complete reports why (peer
    abort seen, peer heartbeat stale, timeout) instead of hanging."""

    def __init__(self, backend, host: int, num_hosts: int,
                 peer_death_timeout_s: float = 60.0,
                 log: Callable[[str], None] = None,
                 poll_s: Optional[float] = None):
        if num_hosts < 2:
            raise ValueError(
                f"ClusterCoordinator needs num_hosts >= 2 (got {num_hosts});"
                " single-process runs use no coordinator at all")
        if not (0 <= host < num_hosts):
            raise ValueError(f"host {host} outside [0, {num_hosts})")
        self.backend = backend
        self.host = int(host)
        self.num_hosts = int(num_hosts)
        self.peer_death_timeout_s = float(peer_death_timeout_s)
        self.log = log or (lambda _m: None)
        self.poll_s = (float(poll_s) if poll_s
                       else max(0.05, min(1.0,
                                          self.peer_death_timeout_s / 5
                                          or 0.5)))
        self.boot = uuid.uuid4().hex
        # wipe own previous-incarnation records BEFORE publishing the new
        # boot nonce (file backend: the dir outlives processes)
        for kind in ("sig", "abort", "hb", "preempt_ack", "resume", "topo"):
            self.backend.delete(f"{kind}/{self.host}")
        self.backend.put(f"boot/{self.host}", self.boot)
        self._hb_n = 0
        self._signals_published: Tuple[str, ...] = ()
        # peer heartbeat staleness: host -> (last value, local monotonic
        # time the value last CHANGED); wall clocks are never compared
        # across hosts. _peer_seen: peers that have ever heartbeat (until
        # then the staleness threshold is startup-grade)
        self._peer_hb: Dict[int, Tuple[str, float]] = {}
        self._peer_seen: set = set()
        self._watchdog: Optional[_SidebandWatchdog] = None
        # per-iteration commit ATTEMPT counter: a re-save of the same
        # iteration in one incarnation must never be satisfied by the
        # previous attempt's leftover votes (commit_barrier)
        self._commit_attempts: Dict[int, int] = {}
        # sideband-maintained snapshots the train loop reads instead of
        # hitting the backend every step
        self._sig_cache: Optional[Dict[int, Dict[str, Any]]] = None
        self._ack_cache: Optional[Dict[int, Dict[str, Any]]] = None

    # -- record plumbing ----------------------------------------------------

    def _put(self, key: str, **fields: Any) -> None:
        rec = dict(fields)
        rec["boot"] = self.boot
        rec["host"] = self.host
        self.backend.put(key, json.dumps(rec, separators=(",", ":")))

    def _fresh(self, prefix: str) -> Dict[int, Dict[str, Any]]:
        """{host: record} under prefix, keeping only records whose boot
        nonce matches the publisher's current boot record."""
        boots = self.backend.get_all("boot")
        out: Dict[int, Dict[str, Any]] = {}
        for name, raw in self.backend.get_all(prefix).items():
            try:
                rec = json.loads(raw)
                h = int(rec.get("host", name))
            except (ValueError, TypeError):
                continue
            if boots.get(str(h)) != rec.get("boot"):
                continue
            out[h] = rec
        return out

    def _wait_all(self, prefix: str, timeout_s: float,
                  what: str) -> Dict[int, Dict[str, Any]]:
        """Poll until every host has a fresh record under prefix.

        Aborts on evidence: a peer's poison record or a heartbeat stale
        past peer_death_timeout_s ends the wait at once with the cause,
        while a peer that is slow but alive (still heartbeating through
        its sideband thread) extends the wait up to `timeout_s`."""
        deadline = time.monotonic() + timeout_s
        while True:
            recs = self._fresh(prefix)
            if len(recs) >= self.num_hosts:
                return recs
            abort = self.peer_abort()
            if abort is not None:
                raise CoordinationError(
                    f"{what}: peer host {abort['host']} aborted "
                    f"({abort.get('cause')}) while waiting for "
                    f"{self.num_hosts - len(recs)} host(s)")
            dead = self.dead_peer()
            if dead is not None and dead not in recs:
                raise CoordinationError(
                    f"{what}: peer host {dead} stopped heartbeating "
                    f"(peer_death_timeout_s={self.peer_death_timeout_s:g})"
                    f" before contributing")
            if time.monotonic() >= deadline:
                missing = sorted(set(range(self.num_hosts)) - set(recs))
                raise CoordinationError(
                    f"{what}: hosts {missing} missing after {timeout_s:.1f}s"
                    f" (have {sorted(recs)})")
            time.sleep(self.poll_s)

    # -- protocol 4: startup/topology barrier --------------------------------

    def topology_barrier(self, timeout_s: Optional[float] = None
                         ) -> Dict[int, Dict[str, Any]]:
        """Rendezvous all hosts and verify they agree on num_hosts; a
        disagreement is a loud CoordinationError. Returns the per-host
        records."""
        timeout_s = timeout_s if timeout_s is not None else startup_timeout_s()
        self._put(f"topo/{self.host}", num_hosts=self.num_hosts,
                  backend=self.backend.name)
        recs = self._wait_all("topo", timeout_s, "topology barrier")
        sizes = {h: r.get("num_hosts") for h, r in recs.items()}
        if set(sizes.values()) != {self.num_hosts}:
            raise CoordinationError(
                f"topology disagreement: per-host num_hosts {sizes} — "
                "every host must be launched with the same world size")
        return recs

    # -- protocol 1: signal agreement ---------------------------------------

    def publish_signals(self, names: Sequence[str]) -> None:
        """Publish the signals this host's handler received (idempotent
        per set of names)."""
        names = tuple(names)
        if names == self._signals_published:
            return
        self._signals_published = names
        self._put(f"sig/{self.host}", signals=list(names), ts=time.time())

    def cluster_signals(self, cached: bool = False
                        ) -> Dict[int, Dict[str, Any]]:
        """Fresh signal records from every host that received one ({}
        when no notice anywhere). cached=True serves the sideband
        thread's last snapshot when one is maintained, bounding the
        notice's propagation at poll_s without a backend read a step."""
        if cached and self._watchdog is not None and self._sig_cache is not None:
            return self._sig_cache
        out = self._fresh("sig")
        self._sig_cache = out
        return out

    def notice_host(self) -> Optional[int]:
        """The host whose notice landed first (earliest publish stamp,
        then the lower host id)."""
        sigs = self.cluster_signals()
        if not sigs:
            return None
        return min(sigs, key=lambda h: (sigs[h].get("ts", 0.0), h))

    def exit_pending(self, cached: bool = False) -> bool:
        """True once any host has published an exit ack: a peer began
        draining, so the train loop joins the exit agreement."""
        if cached and self._watchdog is not None and self._ack_cache is not None:
            return bool(self._ack_cache)
        recs = self._fresh("preempt_ack")
        self._ack_cache = recs
        return bool(recs)

    def ack_exit(self, iteration: int) -> None:
        """Publish this host's exit ack without waiting (the completion
        path: a notice published a moment later still resolves every
        peer's agreement)."""
        self._put(f"preempt_ack/{self.host}", iteration=int(iteration))

    def agree_exit_iteration(self, iteration: int,
                             timeout_s: Optional[float] = None
                             ) -> Tuple[int, Optional[int]]:
        """All hosts ack the cluster exit with their current iteration;
        the agreed exit and save boundary is the max (hosts behind it
        keep stepping). Returns (target_iteration, notice_host)."""
        timeout_s = (timeout_s if timeout_s is not None
                     else startup_timeout_s())
        self.ack_exit(iteration)
        recs = self._wait_all("preempt_ack", timeout_s, "exit agreement")
        target = max(int(r.get("iteration", iteration))
                     for r in recs.values())
        return target, self.notice_host()

    # -- protocol 2: coordinated abort + liveness ----------------------------

    def publish_abort(self, cause: str, **detail: Any) -> None:
        """Poison record: this host is about to die deliberately. Peers
        abort instead of blocking in the next collective forever."""
        try:
            self._put(f"abort/{self.host}", cause=str(cause),
                      ts=time.time(), **detail)
        except Exception as e:  # noqa: BLE001 - the local abort must
            # proceed even when the shared medium is the thing that died
            self.log(f"coordination: abort publish failed ({e})")

    def heartbeat(self) -> None:
        """Liveness beat, published by the sideband thread (process
        liveness, not step progress)."""
        self._hb_n += 1
        self._put(f"hb/{self.host}", n=self._hb_n)

    def peer_abort(self) -> Optional[Dict[str, Any]]:
        """The first fresh poison record from a different host, or None."""
        for h, rec in sorted(self._fresh("abort").items()):
            if h != self.host:
                return rec
        return None

    def dead_peer(self) -> Optional[int]:
        """A peer whose heartbeat value has not changed for
        peer_death_timeout_s (local monotonic time), or None. A peer
        that has never heartbeat is judged against the startup-grade
        window (its process may still be booting)."""
        if self.peer_death_timeout_s <= 0:
            return None
        now = time.monotonic()
        hbs = self._fresh("hb")
        for h in range(self.num_hosts):
            if h == self.host:
                continue
            rec = hbs.get(h)
            val = json.dumps(rec, sort_keys=True) if rec is not None else ""
            if rec is not None:
                self._peer_seen.add(h)
            seen = self._peer_hb.get(h)
            if seen is None or seen[0] != val:
                self._peer_hb[h] = (val, now)
                continue
            limit = (self.peer_death_timeout_s if h in self._peer_seen
                     else max(startup_timeout_s(),
                              self.peer_death_timeout_s))
            if now - seen[1] >= limit:
                return h
        return None

    def check_peers(self) -> Optional[Dict[str, Any]]:
        """One liveness pass: a fresh peer poison record wins (it names
        its cause); else a stale heartbeat is cause="peer_death". None
        while the cluster is healthy."""
        abort = self.peer_abort()
        if abort is not None:
            return abort
        dead = self.dead_peer()
        if dead is not None:
            return {"host": dead, "cause": "peer_death",
                    "detail": f"no heartbeat from host {dead} for "
                              f"{self.peer_death_timeout_s:.1f}s"}
        return None

    # -- protocol 3: two-phase checkpoint commit -----------------------------

    def commit_barrier(self, iteration: int, crc: str,
                       timeout_s: Optional[float] = None) -> None:
        """Publish staged(iteration, crc), meaning every byte this host
        owes the checkpoint is durable, then wait for every host's.
        Returning means the cluster agreed; CommitAborted means the
        caller must not flip its tracker. Votes are keyed by a local
        per-iteration attempt counter, so a re-save of one iteration
        waits for this attempt's votes; coordinated saves are
        iteration-deterministic and an aborted commit aborts everywhere,
        so the counters stay aligned. The deadline is startup-grade: the
        wait ends early on evidence."""
        timeout_s = (timeout_s if timeout_s is not None
                     else startup_timeout_s())
        it = int(iteration)
        attempt = self._commit_attempts.get(it, 0)
        self._commit_attempts[it] = attempt + 1
        self._put(f"commit/{it}/{attempt}/{self.host}",
                  iteration=it, crc=str(crc), attempt=attempt)
        try:
            self._wait_all(f"commit/{it}/{attempt}", timeout_s,
                           f"checkpoint commit @ iteration {it} "
                           f"(attempt {attempt})")
        except CoordinationError as e:
            raise CommitAborted(str(e)) from e

    def agree_resume_iteration(self, valid: Sequence[int],
                               timeout_s: Optional[float] = None
                               ) -> Optional[int]:
        """Each host publishes the checkpoint iterations it holds valid;
        the agreed resume point is the newest valid on every host (None
        when the intersection is empty: a fresh start everywhere)."""
        timeout_s = timeout_s if timeout_s is not None else startup_timeout_s()
        self._put(f"resume/{self.host}", valid=sorted(int(v) for v in valid))
        recs = self._wait_all("resume", timeout_s, "resume agreement")
        common = None
        for rec in recs.values():
            have = set(int(v) for v in rec.get("valid", ()))
            common = have if common is None else (common & have)
        if not common:
            return None
        return max(common)

    # -- host->host data ----------------------------------------------------

    def broadcast(self, obj: Any, root: int = 0, key: str = "bcast",
                  timeout_s: Optional[float] = None) -> Any:
        """One JSON-able value from `root` to every host. One-shot per key
        per incarnation: give each call site its own key."""
        timeout_s = (timeout_s if timeout_s is not None
                     else max(self.peer_death_timeout_s, 10.0))
        if self.host == root:
            self._put(f"{key}/{root}", value=obj)
            return obj
        deadline = time.monotonic() + timeout_s
        while True:
            recs = self._fresh(key)
            if root in recs:
                return recs[root].get("value")
            if time.monotonic() >= deadline:
                raise CoordinationError(
                    f"broadcast '{key}': nothing from host {root} after "
                    f"{timeout_s:.1f}s")
            time.sleep(self.poll_s)

    def publish_value(self, key: str, value: Any) -> None:
        """Non-blocking single-writer record; peers read the latest with
        read_value()."""
        self._put(f"{key}/{self.host}", value=value)

    def read_value(self, key: str, host: int = 0) -> Optional[Any]:
        rec = self._fresh(key).get(host)
        return None if rec is None else rec.get("value")

    # -- sideband watchdog ---------------------------------------------------

    def start_heartbeats(self) -> None:
        """Start the publish-only sideband (one immediate heartbeat, then
        one per poll_s), so the startup barriers can judge this host
        alive long before the loop's first step."""
        self.heartbeat()
        if self._watchdog is None:
            self._watchdog = _SidebandWatchdog(self, on_peer_abort=None)
            self._watchdog.start()

    def sideband_armed(self) -> bool:
        """True while the sideband runs with a peer-verdict callback (the
        loop then skips its inline per-step liveness poll)."""
        wd = self._watchdog
        return (wd is not None and wd.on_peer_abort is not None
                and not wd.fired)

    def start_watchdog(self, on_peer_abort: Callable[[Dict[str, Any]], None]
                       ) -> "_SidebandWatchdog":
        """Arm the peer-verdict callback on the sideband thread: a peer's
        poison record or death is acted on even while this host is
        blocked inside a collective. The callback runs on the sideband
        thread and is expected not to return (the loop's handler
        journals `peer_abort` and os._exits)."""
        if self._watchdog is None:
            self._watchdog = _SidebandWatchdog(self, on_peer_abort)
            self._watchdog.start()
        else:
            self._watchdog.on_peer_abort = on_peer_abort
        return self._watchdog

    def stop_watchdog(self) -> None:
        """Disarm verdicts and stop heartbeating (on the way out)."""
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    def close(self) -> None:
        self.stop_watchdog()


class _SidebandWatchdog:
    """Daemon thread: heartbeat publishing plus, once `on_peer_abort` is
    armed, peer-death/abort polling; bounded work per tick."""

    def __init__(self, coord: ClusterCoordinator,
                 on_peer_abort: Optional[Callable[[Dict[str, Any]], None]]):
        self.coord = coord
        self.on_peer_abort = on_peer_abort
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="coord-sideband", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.coord.poll_s * 4 + 5)

    def _run(self) -> None:
        while not self._stop.wait(self.coord.poll_s):
            try:
                self.coord.heartbeat()
                # refresh the snapshots the train loop reads
                self.coord.cluster_signals()
                self.coord.exit_pending()
                cb = self.on_peer_abort
                verdict = self.coord.check_peers() if cb else None
            except Exception as e:  # noqa: BLE001 - a flaky shared medium
                # must not kill liveness; the next tick retries
                self.coord.log(f"coordination sideband: poll failed ({e})")
                continue
            if verdict is not None:
                self._stop.set()
                self.fired = True
                cb(verdict)
                return


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def startup_timeout_s() -> float:
    try:
        return float(os.environ.get(STARTUP_TIMEOUT_ENV, "") or
                     DEFAULT_STARTUP_TIMEOUT_S)
    except ValueError:
        return DEFAULT_STARTUP_TIMEOUT_S


def resolve_host_identity() -> Tuple[int, int]:
    """(host, num_hosts): the MEGATRON_TPU_COORD_* overrides, else the
    launcher's node rank and node count, else (0, 1)."""
    env_host = os.environ.get(COORD_HOST_ENV)
    env_n = os.environ.get(COORD_NUM_HOSTS_ENV)
    if env_host is not None or env_n is not None:
        if env_host is None or env_n is None:
            raise ValueError(
                f"{COORD_HOST_ENV} and {COORD_NUM_HOSTS_ENV} must be set "
                "together")
        return int(env_host), int(env_n)
    return (int(os.environ.get(NODE_RANK_ENV, 0)),
            int(os.environ.get(NUM_NODES_ENV, 1)))


def local_rank() -> int:
    """This process's rank within its host (torch.distributed.run's
    LOCAL_RANK; 0 for a plain process)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def for_training(tcfg, log: Callable[[str], None] = print
                 ) -> Optional[ClusterCoordinator]:
    """The coordinator a TrainingConfig implies on this process, or None
    (a single-host run, or a rank other than its host's local rank 0).

    `--coordination_dir` selects the file backend; otherwise a
    multi-host run needs an initialized process group and takes its
    store."""
    host, num_hosts = resolve_host_identity()
    if num_hosts < 2 or local_rank() != 0:
        return None
    coord_dir = getattr(tcfg, "coordination_dir", None)
    if coord_dir:
        backend = FileBackend(coord_dir)
    else:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"{num_hosts} hosts but torch.distributed is not "
                "initialized and no --coordination_dir is set — the store "
                "backend needs the process group, the file backend a "
                "shared directory")
        backend = StoreBackend(num_hosts)
    coord = ClusterCoordinator(
        backend, host, num_hosts,
        peer_death_timeout_s=getattr(tcfg, "peer_death_timeout_s", 60.0),
        log=log)
    coord.start_heartbeats()
    log(f"coordination: host {host}/{num_hosts} on the {backend.name} "
        f"backend (peer_death_timeout_s="
        f"{coord.peer_death_timeout_s:g})")
    return coord
