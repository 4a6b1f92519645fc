"""Per-collective compression policy, stdlib only (counterpart of
megatron_tpu/quant/policy.py, copied: the port imports nothing of the
JAX package).

Which collective SITES run compressed is a measurement-driven choice:
compressing a collective whose time is hidden under compute buys nothing
and costs quantization error. A trace gives each collective kind's
EXPOSED fraction (the Flash Communication number), and
``policy_from_exposure`` turns those fractions into a site policy:

  * ``attn_out`` / ``mlp_out``: the row-parallel output reductions
    (all-reduce), compressed when the all-reduce exposed fraction
    clears the threshold;
  * ``logits``: the vocab-parallel logits gather (all-gather);
  * ``cp_ring``: the context-parallel ring-attention hop
    (collective-permute, inference/context_parallel/);
  * ``cp_a2a``: the 2d CP geometry's intra-subgroup head scatter and
    gather legs (all-to-all), measured apart from the ring's hop
    because the two run on different fabric tiers.

A policy file is JSON ``{"sites": {site: bool}}``
(megatron_tpu_torch/tools/trace_report.py --emit-comm-policy writes one
from a trace); serving loads it with ``--serve_comm_policy``. With
no policy every site compresses (the static worst case).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional

#: the compressible collective sites in the serving forward
#: (models/transformer.py attention_block + mlp_block, models/
#: language_model.py lm_logits, inference/context_parallel/ring_kv.py)
#: and the HLO collective kind each one runs as — the join key between
#: trace exposure and site policy.
SITE_COLLECTIVES: Dict[str, str] = {
    "attn_out": "all-reduce",
    "mlp_out": "all-reduce",
    "logits": "all-gather",
    "cp_ring": "collective-permute",
    "cp_a2a": "all-to-all",
}

#: the subset of sites living inside the TENSOR-parallel comm plan
#: (TpComm): "cp_ring" / "cp_a2a" belong to the context-parallel
#: transport (CpComm) and must never reach TpComm's width validation.
TP_SITES = ("attn_out", "mlp_out", "logits")

#: the context-parallel transport's sites (CpComm): the ring hop and,
#: under the 2d geometry, the intra-subgroup head all-to-all legs.
CP_SITES = ("cp_ring", "cp_a2a")

#: no-measurement default: compress everything (the static Flash-
#: Communication stance; a trace-derived policy prunes hidden ones)
DEFAULT_SITES: Dict[str, bool] = {s: True for s in SITE_COLLECTIVES}


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """site name -> compress? plus where the decision came from."""

    sites: Mapping[str, bool]
    source: str = "default"
    threshold: Optional[float] = None

    def enabled(self, site: str) -> bool:
        return bool(self.sites.get(site, False))

    def enabled_sites(self) -> tuple:
        return tuple(s for s in SITE_COLLECTIVES if self.enabled(s))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"sites": dict(self.sites),
                               "source": self.source}
        if self.threshold is not None:
            out["threshold"] = self.threshold
        return out


def default_policy() -> CommPolicy:
    return CommPolicy(sites=dict(DEFAULT_SITES))


def _validate_sites(sites: Mapping[str, Any], where: str) -> Dict[str, bool]:
    unknown = sorted(set(sites) - set(SITE_COLLECTIVES))
    if unknown:
        raise ValueError(
            f"{where}: unknown collective site(s) {unknown} "
            f"(known: {sorted(SITE_COLLECTIVES)})")
    out = dict(DEFAULT_SITES)
    for k, v in sites.items():
        if not isinstance(v, bool):
            raise ValueError(f"{where}: site {k!r} must map to a JSON "
                             f"boolean, got {v!r}")
        out[k] = v
    return out


def policy_from_exposure(exposed_frac_by_op: Mapping[str, float],
                         threshold: float = 0.25,
                         source: str = "trace") -> CommPolicy:
    """Derive the site policy from measured per-collective exposed
    fractions (trace_report's per-op ``exposed_frac``): a site compresses
    when its collective kind's exposed fraction >= threshold — i.e. the
    collective actually costs wall time that compute does not hide. An
    op kind absent from the trace (it never ran, or was fully hidden at
    0 exposure) maps to not-compressed."""
    sites = {site: float(exposed_frac_by_op.get(op, 0.0)) >= threshold
             for site, op in SITE_COLLECTIVES.items()}
    return CommPolicy(sites=sites, source=source, threshold=threshold)


def load_policy(path: str) -> CommPolicy:
    """Read a policy JSON ({"sites": {...}}, as --emit-comm-policy
    writes). Unknown sites are a loud error — a typo'd site name must
    not silently leave the real one at its default."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    if not isinstance(raw, dict) or "sites" not in raw:
        raise ValueError(f"{path}: expected a JSON object with a "
                         "'sites' mapping")
    return CommPolicy(
        sites=_validate_sites(raw["sites"], path),
        source=str(raw.get("source", f"file:{path}")),
        threshold=raw.get("threshold"))


def resolve_policy(policy) -> CommPolicy:
    """Normalize the engine-facing knob: None (defaults), a CommPolicy,
    a {site: bool} dict, or a path to a policy JSON."""
    if policy is None:
        return default_policy()
    if isinstance(policy, CommPolicy):
        return policy
    if isinstance(policy, dict):
        return CommPolicy(sites=_validate_sites(policy, "comm_policy"),
                          source="dict")
    if isinstance(policy, str):
        return load_policy(policy)
    raise TypeError(f"comm_policy: expected None, CommPolicy, dict, or "
                    f"path, got {type(policy).__name__}")
