"""Replica lifecycle: a subprocess handle and the replica entry point
(counterpart of megatron_tpu/inference/fleet/replica.py).

`ReplicaProcess` is the manager-side handle the fleet tests and the chip
check use: spawn a real OS process serving the generation API
(`python -m megatron_tpu_torch.inference.fleet.replica`), learn its
bound port through a port file (port 0 = ephemeral), wait for readiness,
SIGKILL/SIGTERM it, and respawn it on the SAME port so the router's
replica URL stays valid across a restart.

The child takes one JSON spec (--spec or --spec-file):

  {"preset": "tiny", "cfg": {"vocab_size": 65, "seq_length": 64},
   "model_name": null, "overrides": {"num_layers": 4},
   "seed": 0, "engine_slots": 2, "port": 0, "device": "cpu",
   "port_file": "/tmp/r0.port", "warmup": true,
   "load": "ckpts", "request_timeout": 30.0, "drain_timeout": 5.0,
   "peers": ["http://127.0.0.1:PORT"], "kv_paging": false}

and builds a torch engine through the port's presets: random weights
from "seed" (the same seed gives every replica the same weights, so a
failover retry is token-identical), or the committed checkpoint under
"load" (inference/fleet/reload.py; a test hands a JAX and a port replica
the same parameters through params_from_numpy and a params-only
checkpoint). It serves on "device" ("cuda" unless the spec asks for the
CPU) and reports its flash kernels' launches under /admin/status's
"kernel_launches". Real deployments serve through
tools/run_text_generation_server.py.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional


class ReplicaProcess:
    """Spawn/monitor/kill one replica subprocess."""

    def __init__(self, spec: Dict[str, Any],
                 env: Optional[Dict[str, str]] = None,
                 python: str = sys.executable,
                 log_path: Optional[str] = None):
        self.spec = dict(spec)
        self.env = env
        self.python = python
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = self.spec.get("port") or None
        port_file = self.spec.get("port_file")
        if not port_file:
            raise ValueError("spec needs a port_file so the parent can "
                             "learn the bound port")
        self.port_file = port_file

    @property
    def url(self) -> str:
        if self.port is None:
            raise RuntimeError("replica has no port yet (spawn + "
                               "wait_ready first)")
        host = self.spec.get("host", "127.0.0.1")
        return f"http://{host}:{self.port}"

    def spawn(self) -> "ReplicaProcess":
        """Start the subprocess; on respawn after a kill, rebind the SAME
        port the first run resolved, so the router's URL stays stable."""
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError("replica already running")
        spec = dict(self.spec)
        if self.port is not None:
            spec["port"] = self.port
        if os.path.exists(self.port_file):
            os.unlink(self.port_file)
        env = dict(os.environ if self.env is None else self.env)
        log = (open(self.log_path, "ab") if self.log_path
               else subprocess.DEVNULL)
        try:
            self.proc = subprocess.Popen(
                [self.python, "-m",
                 "megatron_tpu_torch.inference.fleet.replica",
                 "--spec", json.dumps(spec)],
                stdout=log, stderr=log, env=env)
        finally:
            if log is not subprocess.DEVNULL:
                log.close()
        return self

    def wait_port(self, timeout: float = 120.0) -> int:
        """Block until the child publishes its bound port (or dies)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica exited rc={self.proc.returncode} before "
                    f"publishing a port (log: {self.log_path})")
            try:
                with open(self.port_file) as f:
                    self.port = int(json.load(f)["port"])
                return self.port
            except (OSError, ValueError, KeyError):
                time.sleep(0.05)
        raise TimeoutError(f"replica did not publish a port within "
                           f"{timeout}s (log: {self.log_path})")

    def wait_ready(self, timeout: float = 120.0) -> None:
        """Block until /readyz answers 200 (includes warmup compile)."""
        if self.port is None:
            self.wait_port(timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica exited rc={self.proc.returncode} before "
                    f"ready (log: {self.log_path})")
            try:
                with urllib.request.urlopen(self.url + "/readyz",
                                            timeout=2) as r:
                    if r.status == 200:
                        return
            except urllib.error.HTTPError:
                pass
            except (OSError, urllib.error.URLError):
                pass
            time.sleep(0.1)
        raise TimeoutError(f"replica at {self.url} not ready within "
                           f"{timeout}s (log: {self.log_path})")

    def kill(self) -> None:
        """SIGKILL — the unmaskable death the chaos tests need."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def terminate(self) -> None:
        """SIGTERM — the graceful-drain path."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        if self.proc is None:
            return None
        return self.proc.wait(timeout=timeout)

    def poll(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    def close(self) -> None:
        self.kill()


# ---------------------------------------------------------------------------
# child entry point


def spec_config(spec: Dict[str, Any]):
    """The model config of a replica spec: "preset" with its "cfg"
    keywords, or a "model_name" such as llama2-7B, then the spec's
    "overrides" (num_layers, say)."""
    import dataclasses

    from megatron_tpu_torch.models import presets

    if spec.get("model_name"):
        cfg = presets.from_model_name(spec["model_name"])
    else:
        cfg = presets.PRESETS[spec.get("preset", "tiny")](
            **spec.get("cfg", {}))
    if spec.get("overrides"):
        cfg = dataclasses.replace(cfg, **spec["overrides"]).validate()
    return cfg


def _build_and_serve(spec: Dict[str, Any]) -> None:
    """Runs in the replica subprocess: build the model of the spec
    (spec_config), load committed weights when asked, serve until
    signalled."""
    import torch

    from megatron_tpu_torch.inference.server import run_server
    from megatron_tpu_torch.inference.speculative import SpecConfig
    from megatron_tpu_torch.models.params import init_params
    from megatron_tpu_torch.tokenizer.tokenizer import NullTokenizer

    # host work of a replica is a request's bookkeeping: one intra-op
    # thread, so several replicas on one host do not oversubscribe it
    torch.set_num_threads(1)
    if spec.get("telemetry_dir"):
        from megatron_tpu_torch.telemetry.journal import (
            EventJournal, set_global_journal,
        )

        os.makedirs(spec["telemetry_dir"], exist_ok=True)
        set_global_journal(EventJournal(
            os.path.join(spec["telemetry_dir"], "events.jsonl")))

    device = spec.get("device", "cuda")
    cfg = spec_config(spec)
    tokenizer = NullTokenizer(int(spec.get("null_vocab",
                                           cfg.vocab_size - 1)))
    params = init_params(cfg, int(spec.get("seed", 0)), device=device)
    weights_version = None
    if spec.get("load"):
        from megatron_tpu_torch.inference.fleet.reload import (
            load_verified_params,
        )

        params, weights_version = load_verified_params(
            spec["load"], params, iteration=spec.get("iteration"))
        print(f"replica loaded weights iter {weights_version} "
              f"from {spec['load']}", flush=True)
    speculative = None
    if spec.get("speculative"):
        speculative = SpecConfig(k=int(spec.get("spec_k", 4)),
                                 drafter=spec["speculative"])

    run_server(
        cfg, params, tokenizer,
        host=spec.get("host", "127.0.0.1"),
        port=int(spec.get("port", 0)),
        device=device,
        engine_slots=int(spec.get("engine_slots", 2)),
        engine_max_seq_len=spec.get("max_seq_len"),
        engine_max_queue=spec.get("max_queue"),
        kv_cache_int8=bool(spec.get("kv_cache_int8", False)),
        kv_paging=bool(spec.get("kv_paging", False)),
        page_size=int(spec.get("page_size", 16)),
        prefill_chunk=int(spec.get("prefill_chunk", 32)),
        num_pages=spec.get("num_pages"),
        request_timeout=spec.get("request_timeout"),
        drain_timeout=float(spec.get("drain_timeout", 30.0)),
        warmup=bool(spec.get("warmup", True)),
        speculative=speculative,
        port_file=spec.get("port_file"),
        reload_dir=spec.get("reload_dir") or spec.get("load"),
        weights_version=weights_version,
        # handoff peers (base URLs): a SIGTERM drain migrates the
        # requests in flight and queued to them instead of failing them
        peers=spec.get("peers"),
        profile_dir=spec.get("profile_dir"),
    )


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="serving replica (fleet subprocess entry)")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--spec", help="replica spec as one JSON object")
    g.add_argument("--spec-file", help="path to a JSON spec file")
    args = ap.parse_args(argv)
    if args.spec_file:
        with open(args.spec_file) as f:
            spec = json.load(f)
    else:
        spec = json.loads(args.spec)
    _build_and_serve(spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
