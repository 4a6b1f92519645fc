"""Serving fleet control plane (counterpart of megatron_tpu/inference/
fleet/), host code around the port's replicas:

  * router.py    health-aware least-loaded front door over N replicas,
                 with a per-replica circuit breaker, bounded retry and
                 failover, rolling weight updates and handoff drains;
  * replica.py   the subprocess replica handle and the `python -m
                 megatron_tpu_torch.inference.fleet.replica` entry point,
                 which builds a torch engine;
  * migration.py the KV-state migration wire format (the JAX package's
                 bytes), the HTTP client half of request and prefix
                 handoff, and the fleet-level PrefixDirectory;
  * reload.py    manifest-verified committed-checkpoint param loads
                 behind POST /admin/reload;
  * scrape.py    Prometheus text-format parsing for the router's prober.

Not ported yet: slo.py and tools/slo_harness.py (ROADMAP.md item 12b).
"""

from megatron_tpu_torch.inference.fleet.migration import (  # noqa: F401
    MigrationIntegrityError, PrefixDirectory, pack_state, replicate_prefix,
    unpack_state,
)
from megatron_tpu_torch.inference.fleet.reload import (  # noqa: F401
    load_verified_params, save_params_checkpoint,
)
from megatron_tpu_torch.inference.fleet.replica import (  # noqa: F401
    ReplicaProcess,
)
from megatron_tpu_torch.inference.fleet.router import (  # noqa: F401
    ReplicaRouter, RouterServer, fleet_retry_after,
)

__all__ = [
    "ReplicaRouter",
    "RouterServer",
    "ReplicaProcess",
    "MigrationIntegrityError",
    "PrefixDirectory",
    "fleet_retry_after",
    "load_verified_params",
    "pack_state",
    "replicate_prefix",
    "save_params_checkpoint",
    "unpack_state",
]
