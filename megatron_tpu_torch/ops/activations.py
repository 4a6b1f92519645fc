"""Activation functions, including the GLU family
(counterpart of megatron_tpu/ops/activations.py).

GLU convention: the MLP in-projection packs [gate; up] along the last
dim, and glu(x) = act(gate) * up.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from megatron_tpu_torch.config import GLU_ACTIVATIONS


def apply_activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="none")
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "squared_relu":
        r = F.relu(x)
        return r * r
    if name in GLU_ACTIVATIONS:
        gate, up = x.chunk(2, dim=-1)
        if name == "swiglu":
            return F.silu(gate) * up
        if name == "geglu":
            return F.gelu(gate, approximate="none") * up
        if name == "reglu":
            return F.relu(gate) * up
        return gate * up                                 # liglu
    raise ValueError(f"unknown activation {name!r}")


def mlp_input_width_factor(name: str) -> int:
    """GLU activations need a 2x-wide in-projection."""
    return 2 if name in GLU_ACTIVATIONS else 1
