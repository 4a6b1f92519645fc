"""Serving fleet control plane (counterpart of
megatron_tpu/inference/fleet/). Ported: reload.py, the manifest-verified
weight loads behind POST /admin/reload. The router, replica specs, SLO
harness and KV migration are not ported yet."""
