"""Replica router: health-aware least-loaded front door over N replicas
(counterpart of megatron_tpu/inference/fleet/router.py, host code that
the port keeps as its own copy).

One process is a single point of failure and a single jit queue; the fleet
story routes every client request through this router instead:

  * dispatch picks the READY replica with the lowest load score — busy
    slots + queue depth from the replica's own Prometheus gauges (scraped
    by a background prober), plus the router's live count of requests it
    has in flight there (the gauges go stale between scrapes; the local
    count covers the gap);
  * a failed attempt (connect error, timeout, HTTP 5xx) fails over to a
    different replica with bounded backoff — a SIGKILLed or hung replica
    costs the affected clients ONE retry, never a lost request;
  * per-replica circuit breaker: `breaker_failures` consecutive failures
    open the breaker for an exponentially growing window (capped), so a
    dead replica stops eating attempt budget; when the window expires the
    next dispatch is the half-open trial — success closes the breaker,
    failure re-opens it wider. The prober's consecutive /readyz successes
    also close it (a restarted replica is readmitted without burning a
    client request as the trial);
  * 503s (replica queue full / draining) are routed around WITHOUT
    breaker penalty — an overloaded replica is healthy, just busy;
  * HTTP 4xx pass through untouched (a malformed request fails the same
    on every replica — retrying would just triple the error rate).

Rolling weight update (docs/serving.md): one replica at a time — stop
routing to it, POST /admin/drain (in-flight requests finish), POST
/admin/reload (manifest-verified params swap, fleet/reload.py), POST
/admin/readmit, wait for /readyz, restore routing. Zero dropped requests
and zero decode-step recompiles, by construction and by test
(tests/test_fleet.py).

Retry honesty (docs/serving.md): greedy requests and requests carrying a
`random_seed` are deterministic in (prompt, knobs, seed), so a failover
retry recomputes the identical response the dead replica would have.
Sampled requests WITHOUT an explicit seed fall back to the server-side
default chain — a retry replays that chain, but across mixed weight
versions (mid rolling update) the replay is not guaranteed to match what
the dead replica would have emitted, so the router journals
`serve_retry_resampled` whenever such a request succeeds only after a
mid-flight replica failure. Handoff drains (drain_replica / SIGTERM with
peers) avoid the retry entirely: the PRNG chain migrates with the request
(fleet/migration.py) and the continuation is token-identical.

Global admission (fleet-wide): with `global_max_queue` set, dispatch
rejects up front when the whole fleet's queue depth (scraped load +
router-local in-flight counts) is at the bound — an honest fast 503 with
a fleet-derived Retry-After (queue depth / drain ETA, fleet_retry_after)
instead of burning an attempt sweep to discover that every replica is
individually full.

Pure host code: no torch import anywhere in the router.
"""

from __future__ import annotations

import json
import math
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from megatron_tpu_torch.inference.fleet import scrape
from megatron_tpu_torch.inference.fleet.migration import (
    PrefixDirectory, replicate_prefix,
)
from megatron_tpu_torch.telemetry import journal as _journal
from megatron_tpu_torch.telemetry.metrics import (
    MetricsRegistry, default_registry,
)

#: floor/legacy Retry-After on router-level 503 — dispatch now derives the
#: real hint from fleet state (fleet_retry_after); this constant survives
#: as the minimum and for callers that imported it
ROUTER_RETRY_AFTER_SECONDS = 1


def fleet_retry_after(queue_depth: float, routable: int,
                      per_replica_rps: float = 2.0,
                      drain_eta_s: Optional[float] = None,
                      min_s: int = ROUTER_RETRY_AFTER_SECONDS,
                      max_s: int = 60) -> int:
    """Honest Retry-After from fleet state: the seconds until the fleet
    can plausibly absorb one more request.

    With routable replicas, that is the time to work off the current
    fleet-wide queue depth at the fleet's aggregate service rate
    (`routable * per_replica_rps`). With NONE routable (every replica
    draining or dead), it is the drain ETA when the caller knows one,
    else the cap. Clamped to [min_s, max_s] — a Retry-After of 0 invites
    an immediate re-hit and one beyond the cap parks clients longer than
    any breaker/drain in this stack lasts."""
    if routable < 1:
        eta = max_s if drain_eta_s is None else drain_eta_s
    else:
        eta = queue_depth / (routable * max(per_replica_rps, 1e-6))
    return int(max(min_s, min(max_s, math.ceil(eta))))


class NoReplicaAvailableError(RuntimeError):
    """Every replica is breaker-open or unreachable."""


class ReplicaState:
    """Router-side view of one replica (all mutation under the router
    lock; the prober and dispatch threads both write here)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        # prober-owned
        self.alive = True         # /readyz answered at all
        self.ready = True         # /readyz said ok (optimistic at start:
        #                           the first probe corrects within one
        #                           interval; pessimistic-start would
        #                           blackhole traffic until the prober ran)
        self.ready_streak = 0     # consecutive successful probes
        self.load = 0.0           # scraped slots_active + queue_depth
        self.last_probe: Optional[float] = None
        # dispatch-owned
        self.outstanding = 0      # router requests in flight RIGHT NOW
        self.failures = 0         # consecutive dispatch failures
        self.breaker_opens = 0    # times opened since last success
        self.breaker_open_until = 0.0
        # rolling-update ownership: excluded from dispatch while True
        self.updating = False

    def breaker_open(self, now: float) -> bool:
        return self.breaker_open_until > now

    def snapshot(self) -> Dict[str, Any]:
        return {"url": self.url, "alive": self.alive, "ready": self.ready,
                "load": self.load, "outstanding": self.outstanding,
                "failures": self.failures,
                "breaker_open_until": self.breaker_open_until,
                "updating": self.updating}


class ReplicaRouter:
    """Dispatch + health logic (RouterServer wraps it in HTTP)."""

    def __init__(self, urls: List[str],
                 request_timeout: float = 60.0,
                 probe_interval: float = 0.5,
                 probe_timeout: float = 2.0,
                 max_attempts: Optional[int] = None,
                 retry_backoff_s: float = 0.05,
                 breaker_failures: int = 3,
                 breaker_base_s: float = 0.5,
                 breaker_max_s: float = 15.0,
                 readmit_streak: int = 2,
                 metrics: Optional[MetricsRegistry] = None,
                 global_max_queue: Optional[int] = None,
                 service_rate_rps: float = 2.0):
        """global_max_queue: fleet-wide admission bound — dispatch answers
        503 + fleet-derived Retry-After once the summed queue depth
        (scraped replica load + router in-flight) reaches it, replacing
        per-replica 503 discovery. service_rate_rps: assumed per-replica
        completion rate feeding the Retry-After math (fleet_retry_after);
        calibrate from the SLO harness, not precision-critical — it only
        shapes the backoff hint."""
        if not urls:
            raise ValueError("router needs at least one replica URL")
        self.replicas = [ReplicaState(u) for u in urls]
        self.global_max_queue = (int(global_max_queue)
                                 if global_max_queue is not None else None)
        self.service_rate_rps = float(service_rate_rps)
        #: fleet-level prefix directory: which replicas hold which
        #: registered prefixes (register_prefix fills it)
        self.prefix_directory = PrefixDirectory()
        self.request_timeout = float(request_timeout)
        self.probe_interval = float(probe_interval)
        self.probe_timeout = float(probe_timeout)
        # default attempt budget: every replica once, plus one half-open
        # retry — bounded, so a client never waits on an unbounded loop
        self.max_attempts = (int(max_attempts) if max_attempts
                             else len(urls) + 1)
        self.retry_backoff_s = float(retry_backoff_s)
        self.breaker_failures = int(breaker_failures)
        self.breaker_base_s = float(breaker_base_s)
        self.breaker_max_s = float(breaker_max_s)
        self.readmit_streak = int(readmit_streak)
        self._lock = threading.Lock()
        self._prober: Optional[threading.Thread] = None
        self._stop = threading.Event()

        m = metrics if metrics is not None else default_registry()
        self.metrics = m
        self._m_requests = m.counter("router_requests_total",
                                     "routed requests by outcome",
                                     label_names=("status",))
        self._m_retries = m.counter(
            "router_retries_total",
            "dispatch attempts beyond the first, per request")
        self._m_failovers = m.counter(
            "router_failovers_total",
            "requests that succeeded on a different replica after a "
            "failed attempt")
        self._m_breaker = m.counter(
            "router_breaker_opens_total",
            "circuit-breaker openings across the fleet")
        self._m_ready = m.gauge("router_replicas_ready",
                                "replicas currently routable")
        self._m_dispatch = m.histogram(
            "router_dispatch_seconds",
            "front-door request wall time (retries included)")
        self._m_admission = m.counter(
            "router_admission_rejected_total",
            "requests rejected by the fleet-wide admission bound")
        self._m_ready.set(len(self.replicas))

    # ----- health / probing ------------------------------------------------

    def start(self) -> "ReplicaRouter":
        """Spawn the background prober (idempotent)."""
        if self._prober is None:
            self._stop.clear()
            self._prober = threading.Thread(target=self._probe_loop,
                                            daemon=True,
                                            name="router-prober")
            self._prober.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5)
            self._prober = None

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(self.probe_interval)

    def probe_once(self) -> None:
        """One probe round: /readyz + /metrics gauges for every replica
        (also callable directly from tests — no thread needed)."""
        for rep in self.replicas:
            ready, alive = False, False
            load = float("inf")
            try:
                with urllib.request.urlopen(rep.url + "/readyz",
                                            timeout=self.probe_timeout) as r:
                    alive = True
                    ready = r.status == 200
            except urllib.error.HTTPError as e:
                alive = True          # it answered; 503 = not ready
                ready = e.code == 200
            except (OSError, urllib.error.URLError):
                pass
            if ready:
                try:
                    load = scrape.replica_load(
                        scrape.scrape(rep.url + "/metrics",
                                      timeout=self.probe_timeout))
                except (OSError, urllib.error.URLError, ValueError):
                    load = 0.0        # ready but metrics raced — don't
                    #                   penalize below scraped replicas
            with self._lock:
                was_ready = rep.ready
                rep.alive = alive
                rep.ready = ready
                rep.load = load if ready else float("inf")
                rep.last_probe = time.monotonic()
                rep.ready_streak = rep.ready_streak + 1 if ready else 0
                if (ready and rep.ready_streak >= self.readmit_streak
                        and rep.breaker_open(time.monotonic())):
                    # a restarted replica proves itself via consecutive
                    # readiness probes — readmit without burning a client
                    # request as the half-open trial
                    rep.breaker_open_until = 0.0
                    rep.failures = 0
                    rep.breaker_opens = 0
                    self._journal("replica_readmitted", replica=rep.url)
                if was_ready != ready:
                    self._journal("replica_ready_change", replica=rep.url,
                                  ready=ready)
            self._m_ready.set(self._num_routable())

    def _num_routable(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(1 for r in self.replicas
                       if r.ready and not r.breaker_open(now)
                       and not r.updating)

    # ----- dispatch --------------------------------------------------------

    def _pick(self, exclude: set) -> Optional[ReplicaState]:
        """Least-loaded routable replica not in `exclude`; falls back to
        breaker-closed-but-unready ones (probe lag at startup, or a fleet
        whose probes fail while requests would succeed), then None."""
        now = time.monotonic()
        with self._lock:
            open_ok = [r for r in self.replicas
                       if r not in exclude and not r.updating
                       and not r.breaker_open(now)]
            ready = [r for r in open_ok if r.ready]
            pool = ready or open_ok
            if not pool:
                return None
            return min(pool, key=lambda r: (r.load + r.outstanding,
                                            r.outstanding))

    def _post(self, url: str, body: bytes, timeout: float,
              content_type: str = "application/json"
              ) -> Tuple[int, Dict[str, str], bytes]:
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": content_type})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            # non-2xx WITH a response (4xx/5xx): the transport worked
            return e.code, dict(e.headers or {}), e.read()

    def _record_failure(self, rep: ReplicaState, reason: str) -> None:
        with self._lock:
            rep.failures += 1
            if rep.failures >= self.breaker_failures:
                backoff = min(self.breaker_base_s * (2 ** rep.breaker_opens),
                              self.breaker_max_s)
                rep.breaker_open_until = time.monotonic() + backoff
                rep.breaker_opens += 1
                rep.failures = 0   # the half-open trial starts a new streak
                rep.ready_streak = 0
                self._m_breaker.inc()
                self._journal("replica_breaker_open", replica=rep.url,
                              backoff_s=round(backoff, 3), reason=reason)
        self._m_ready.set(self._num_routable())

    def _record_success(self, rep: ReplicaState) -> None:
        with self._lock:
            rep.failures = 0
            rep.breaker_opens = 0
            rep.breaker_open_until = 0.0

    def _fleet_queue_depth(self) -> float:
        """Fleet-wide queued+running work: the scraped per-replica load
        (busy slots + queue depth) plus the router's own in-flight counts
        (the gauges go stale between scrapes). An unreachable replica
        (load inf) contributes nothing — it holds no work we can count."""
        with self._lock:
            return sum((0.0 if r.load == float("inf") else r.load)
                       + r.outstanding for r in self.replicas)

    def _retry_after(self, depth: Optional[float] = None) -> int:
        if depth is None:
            depth = self._fleet_queue_depth()
        return fleet_retry_after(depth, self._num_routable(),
                                 per_replica_rps=self.service_rate_rps)

    def dispatch(self, body: bytes,
                 timeout: Optional[float] = None
                 ) -> Tuple[int, Dict[str, str], bytes]:
        """Route one /api request; returns (status, headers, body). Every
        failure path is bounded: at most max_attempts tries, each capped
        by request_timeout, with retry_backoff_s between full sweeps.
        With global_max_queue set, a fleet at the bound is rejected here
        (503 + fleet-derived Retry-After) before any attempt is spent."""
        t0 = time.monotonic()
        if self.global_max_queue is not None:
            depth = self._fleet_queue_depth()
            if depth >= self.global_max_queue:
                retry_after = self._retry_after(depth)
                self._m_admission.inc()
                self._m_requests.inc(status="503")
                self._journal("serve_admission", accepted=False,
                              queue_depth=round(depth, 1),
                              bound=self.global_max_queue,
                              retry_after_s=retry_after)
                return (503, {"Retry-After": str(retry_after)},
                        json.dumps({
                            "message": "fleet at admission bound "
                                       f"(queue depth {depth:.0f} >= "
                                       f"{self.global_max_queue}); retry "
                                       f"after {retry_after}s"}).encode())
        deadline = t0 + (timeout if timeout is not None
                         else self.request_timeout * self.max_attempts)
        tried: set = set()
        attempts = 0
        failed_mid_flight = False
        last: Tuple[int, Dict[str, str], bytes] = (
            503, {}, json.dumps({"message": "no replica available"}).encode())
        while attempts < self.max_attempts and time.monotonic() < deadline:
            rep = self._pick(tried)
            if rep is None and tried:
                # full sweep failed: back off once, then allow re-trying
                # replicas we already hit (their breaker may have closed,
                # or the 503 was momentary)
                time.sleep(self.retry_backoff_s)
                tried = set()
                rep = self._pick(tried)
            if rep is None:
                break
            attempts += 1
            if attempts > 1:
                self._m_retries.inc()
            with self._lock:
                rep.outstanding += 1
            try:
                status, headers, rbody = self._post(
                    rep.url + "/api", body,
                    timeout=min(self.request_timeout,
                                max(deadline - time.monotonic(), 0.001)))
            except (socket.timeout, TimeoutError, ConnectionError, OSError,
                    urllib.error.URLError) as e:
                self._record_failure(rep, f"{type(e).__name__}: {e}")
                tried.add(rep)
                failed_mid_flight = True
                last = (502, {}, json.dumps(
                    {"message": f"replica {rep.url} failed: {e}"}).encode())
                continue
            finally:
                with self._lock:
                    rep.outstanding = max(0, rep.outstanding - 1)
            if status == 503:
                # queue-full/draining: healthy, just busy — no breaker
                # penalty, try the next-least-loaded replica (MUST be
                # checked before the 5xx arm below, or every overloaded
                # reply would count toward opening the breaker)
                tried.add(rep)
                last = (status, headers, rbody)
                continue
            if status >= 500 and status != 504:
                # replica-side internal failure: penalize + fail over.
                # 504 is excluded: an expired request deadline means the
                # client's budget is already spent — retrying would double
                # the wasted compute, and deadline expiries on a healthy
                # replica must not open its breaker
                self._record_failure(rep, f"http {status}")
                tried.add(rep)
                failed_mid_flight = True
                last = (status, headers, rbody)
                continue
            # success or pass-through client error (4xx, 504 deadline)
            self._record_success(rep)
            wall = time.monotonic() - t0
            self._m_requests.inc(status=str(status))
            self._m_dispatch.observe(wall)
            if attempts > 1:
                self._m_failovers.inc()
            if status == 200 and failed_mid_flight:
                # retry honesty: a replica may have died MID-generation
                # and this success is a from-scratch re-run elsewhere —
                # flag the re-runs whose sampling the client did not pin
                self._maybe_journal_resample(body, rep, attempts)
            self._journal("serve_route", replica=rep.url, status=status,
                          attempts=attempts, wall_s=round(wall, 6))
            return status, headers, rbody
        # attempt budget or deadline exhausted
        status, headers, rbody = last
        if status == 503:
            # the honest hint: derived from live fleet state at give-up
            # time, not whatever constant the last replica answered with
            headers = dict(headers)
            headers["Retry-After"] = str(self._retry_after())
        wall = time.monotonic() - t0
        self._m_requests.inc(status=str(status))
        self._m_dispatch.observe(wall)
        self._journal("serve_route", replica=None, status=status,
                      attempts=attempts, wall_s=round(wall, 6),
                      exhausted=True)
        return status, headers, rbody

    def _maybe_journal_resample(self, request_body: bytes, rep,
                                attempts: int) -> None:
        """Journal `serve_retry_resampled` when a request that succeeded
        only after a mid-flight replica failure was sampled WITHOUT an
        explicit random_seed (docs/serving.md "Retry honesty"): greedy
        and client-seeded requests replay deterministically on the
        retry, unseeded sampled ones replay the server-default chain —
        honest under one weight version, not across a mid-update mix."""
        try:
            req = json.loads(request_body or b"{}")
        except ValueError:
            return
        if not isinstance(req, dict):
            return
        try:
            temperature = float(req.get("temperature", 1.0))
            n = int(req.get("tokens_to_generate", 64))
        except (TypeError, ValueError):
            return
        if temperature <= 0.0 or n <= 0 or "random_seed" in req:
            return
        self._journal("serve_retry_resampled", replica=rep.url,
                      attempts=attempts, seeded=False)

    # ----- rolling weight update ------------------------------------------

    def _admin(self, rep: ReplicaState, path: str, payload: Dict[str, Any],
               timeout: float) -> Tuple[int, Dict[str, Any]]:
        """Admin POST that NEVER raises: transport failures return status
        0, so rolling_update's cleanup (readmit + `updating = False`)
        always runs — an unreachable replica must not stay excluded from
        dispatch forever because its update turn threw."""
        try:
            status, _, body = self._post(rep.url + path,
                                         json.dumps(payload).encode(),
                                         timeout=timeout)
        except (OSError, urllib.error.URLError) as e:
            return 0, {"message": f"{type(e).__name__}: {e}"}
        try:
            return status, json.loads(body or b"{}")
        except ValueError:
            return status, {"message": body.decode("utf-8", "replace")}

    def drain_replica(self, url: str, handoff: bool = True,
                      timeout: float = 60.0) -> Dict[str, Any]:
        """Drain ONE replica with live-request handoff: stop routing to
        it, then POST /admin/drain naming the other replicas as handoff
        peers — its in-flight and queued requests MIGRATE to them
        (fleet/migration.py) instead of being waited out or failed. The
        pre-SIGTERM step for scale-down/preemption: after this returns
        drained=True the replica holds zero client state and can be
        killed without a single failed request. handoff=False falls back
        to the classic wait-for-idle drain."""
        target = url.rstrip("/")
        rep = next((r for r in self.replicas if r.url == target), None)
        if rep is None:
            raise ValueError(f"unknown replica {url!r}")
        peers = ([r.url for r in self.replicas if r is not rep]
                 if handoff else [])
        with self._lock:
            rep.updating = True   # unroute while the drain runs
        try:
            payload: Dict[str, Any] = {"timeout_s": timeout}
            if peers:
                payload["handoff"] = peers
            status, resp = self._admin(rep, "/admin/drain", payload,
                                       timeout=timeout + self.probe_timeout)
            self._journal("fleet_drain", replica=rep.url, status=status,
                          handoff_peers=len(peers),
                          drained=bool(resp.get("drained")))
            return {"replica": rep.url, "status": status,
                    "drained": bool(resp.get("drained")),
                    "handoff": peers, "response": resp}
        finally:
            # routing resumes only when the replica's own /readyz does
            # (it answers 503 while draining) — clearing the flag just
            # returns ownership to the prober
            with self._lock:
                rep.updating = False

    def register_prefix(self, tokens: List[int],
                        timeout: float = 60.0) -> Dict[str, Any]:
        """Fleet-wide prefix (system prompt) registration: prime ONE
        replica's radix cache with a real prefill, then fan its pages out
        to every other replica via page export
        (migration.replicate_prefix) — the prefix becomes a radix hit
        FLEET-WIDE for the cost of one prefill plus N-1 page transfers,
        and the prefix_directory records who holds it."""
        toks = [int(t) for t in tokens]
        if not toks:
            raise ValueError("tokens: non-empty int list required")
        rep = self._pick(set())
        if rep is None:
            raise NoReplicaAvailableError(
                "no routable replica to prime the prefix on")
        status, resp = self._admin(rep, "/admin/register_prefix",
                                   {"tokens": toks}, timeout=timeout)
        if status != 200:
            raise RuntimeError(
                f"prefix prime on {rep.url} failed (http {status}): "
                f"{resp.get('message', resp)}")
        self.prefix_directory.register(toks, rep.url)
        dests = [r.url for r in self.replicas if r is not rep]
        fanout = replicate_prefix(rep.url, dests, toks, timeout=timeout)
        for entry in fanout["replicated"]:
            if entry["status"] == 200:
                self.prefix_directory.register(toks, entry["url"])
        locations = self.prefix_directory.locations(toks)
        self._journal("fleet_prefix_register", tokens=len(toks),
                      primary=rep.url, pages=resp.get("pages"),
                      locations=len(locations),
                      wire_bytes=fanout["bytes"])
        return {"primary": rep.url, "pages": resp.get("pages"),
                "replicated": fanout["replicated"],
                "locations": locations, "wire_bytes": fanout["bytes"]}

    def rolling_update(self, load: Optional[str] = None,
                       iteration: Optional[int] = None,
                       drain_timeout: float = 60.0,
                       reload_timeout: float = 300.0,
                       ready_timeout: float = 60.0,
                       handoff: bool = False) -> List[Dict[str, Any]]:
        """Ship new weights across the fleet under live traffic, one
        replica at a time: unroute -> drain (in-flight requests finish on
        the old weights) -> reload (manifest-verified swap) -> readmit ->
        wait ready -> reroute. A request is therefore always served END TO
        END by one weight version. Stops at the first failing replica
        (readmitting it with its old weights) so a bad checkpoint can't
        take the whole fleet down; the survivors keep serving.

        handoff=True migrates each replica's in-flight requests to its
        peers during the drain instead of waiting them out — faster
        update turns under long-decode traffic, at the cost of those
        requests finishing on the OLD weights of a peer (which the
        one-version-per-request claim already allows: the whole request
        completes on whichever replica finishes it).

        Returns one result dict per replica attempted."""
        results: List[Dict[str, Any]] = []
        for rep in self.replicas:
            out: Dict[str, Any] = {"replica": rep.url}
            with self._lock:
                rep.updating = True
            self._journal("rolling_update_step", replica=rep.url,
                          phase="drain")
            try:
                drain_payload: Dict[str, Any] = {"timeout_s": drain_timeout}
                if handoff:
                    drain_payload["handoff"] = [
                        r.url for r in self.replicas if r is not rep]
                status, resp = self._admin(
                    rep, "/admin/drain", drain_payload,
                    timeout=drain_timeout + self.probe_timeout)
                out["drain"] = resp
                if status != 200 or not resp.get("drained"):
                    out["error"] = f"drain failed (http {status}): {resp}"
                    break
                self._journal("rolling_update_step", replica=rep.url,
                              phase="reload")
                payload: Dict[str, Any] = {}
                if load is not None:
                    payload["load"] = load
                if iteration is not None:
                    payload["iteration"] = iteration
                status, resp = self._admin(rep, "/admin/reload", payload,
                                           timeout=reload_timeout)
                out["reload"] = resp
                if status != 200:
                    out["error"] = f"reload failed (http {status}): {resp}"
                    break
                out["version"] = resp.get("version")
            finally:
                # ALWAYS readmit — a failed reload leaves the replica
                # serving its old weights, which beats serving nothing
                status, resp = self._admin(rep, "/admin/readmit", {},
                                           timeout=self.probe_timeout + 5)
                out["readmit"] = resp
                ok = self._wait_replica_ready(rep, ready_timeout)
                out["ready"] = ok
                with self._lock:
                    rep.updating = False
                self._journal("rolling_update_step", replica=rep.url,
                              phase="done", ok="error" not in out)
                results.append(out)
        return results

    def _wait_replica_ready(self, rep: ReplicaState,
                            timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(rep.url + "/readyz",
                                            timeout=self.probe_timeout) as r:
                    if r.status == 200:
                        return True
            except urllib.error.HTTPError:
                pass
            except (OSError, urllib.error.URLError):
                pass
            time.sleep(0.05)
        return False

    # ----- misc ------------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            reps = [dict(r.snapshot(), breaker_open=r.breaker_open(now))
                    for r in self.replicas]
        return {"replicas": reps, "routable": self._num_routable(),
                "queue_depth": round(self._fleet_queue_depth(), 1),
                "global_max_queue": self.global_max_queue,
                "retry_after_s": self._retry_after(),
                "prefixes": self.prefix_directory.snapshot()}

    def _journal(self, kind: str, **fields) -> None:
        j = _journal.get_global_journal()
        if j is not None:
            j.emit(kind, **fields)


def make_router_handler(router: ReplicaRouter):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: Dict[str, Any], headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _proxy(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            status, headers, rbody = router.dispatch(body)
            self.send_response(status)
            self.send_header("Content-Type",
                             headers.get("Content-Type", "application/json"))
            self.send_header("Content-Length", str(len(rbody)))
            if "Retry-After" in headers:
                self.send_header("Retry-After", headers["Retry-After"])
            self.end_headers()
            self.wfile.write(rbody)

        def _handle_post(self):
            path = self.path.split("?", 1)[0]
            if path == "/api":
                self._proxy()
                return
            if path in ("/fleet/rolling_update", "/fleet/drain",
                        "/fleet/register_prefix"):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    self._reply(400, {"message": "body must be JSON"})
                    return
                if path == "/fleet/rolling_update":
                    results = router.rolling_update(
                        load=req.get("load"),
                        iteration=req.get("iteration"),
                        drain_timeout=float(req.get("drain_timeout", 60.0)),
                        handoff=bool(req.get("handoff", False)))
                    ok = all("error" not in r for r in results)
                    self._reply(200 if ok else 500, {"results": results})
                    return
                try:
                    if path == "/fleet/drain":
                        self._reply(200, router.drain_replica(
                            str(req.get("url", "")),
                            handoff=bool(req.get("handoff", True)),
                            timeout=float(req.get("timeout_s", 60.0))))
                    else:
                        self._reply(200, router.register_prefix(
                            req.get("tokens") or [],
                            timeout=float(req.get("timeout_s", 60.0))))
                except NoReplicaAvailableError as e:
                    self._reply(503, {"message": str(e)})
                except ValueError as e:
                    self._reply(400, {"message": str(e)})
                except RuntimeError as e:
                    self._reply(502, {"message": str(e)})
                return
            self._reply(404, {"message": "POST serves /api, /fleet/"
                                         "rolling_update, /fleet/drain "
                                         "and /fleet/register_prefix"})

        do_POST = _handle_post
        do_PUT = _handle_post

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                from megatron_tpu_torch.telemetry.http import (
                    PROMETHEUS_CONTENT_TYPE,
                )

                body = router.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/healthz":
                self._reply(200, {"ok": True, "role": "router"})
            elif path == "/readyz":
                routable = router._num_routable()
                self._reply(200 if routable else 503,
                            {"ok": bool(routable), "routable": routable})
            elif path == "/fleet/status":
                self._reply(200, router.status())
            else:
                self._reply(404, {"message": "GET serves /metrics, "
                                             "/healthz, /readyz, "
                                             "/fleet/status"})

        def log_message(self, *a):  # quiet, like the replica servers
            pass

    return Handler


class RouterServer:
    """HTTP front door owning a ReplicaRouter + its serve thread."""

    def __init__(self, urls: List[str], host: str = "127.0.0.1",
                 port: int = 0, **router_kw):
        self.router = ReplicaRouter(urls, **router_kw)
        self._server = ThreadingHTTPServer(
            (host, port), make_router_handler(self.router))
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"router-:{self.port}")

    def start(self) -> "RouterServer":
        self.router.start()
        self._thread.start()
        return self

    def close(self) -> None:
        self.router.close()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)
