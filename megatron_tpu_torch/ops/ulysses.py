"""Ulysses (all-to-all) context parallelism (counterpart of
megatron_tpu/ops/ulysses.py).

The sequence stays sharded over the context ranks everywhere except
inside attention: one all-to-all over the context group scatters the
heads and gathers the sequence, [B, S/cp, H, D] -> [B, S, H/cp, D], for
q, k and v; each rank runs the model's own full-sequence attention on
its heads (flash_mha: the flash_fwd kernel forward, flash_bwd_dq and
flash_bwd_dkv backward), and the inverse all-to-all brings the output
back to [B, S/cp, H, D]. The exchanges are parallel/mappings.exchange,
whose backward is the mirrored all-to-all. Query head chunk j maps onto
kv head chunk j, so GQA keeps its grouping. cp must divide both local
head counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from megatron_tpu_torch.parallel.mappings import exchange


def check_heads(hq: int, hkv: int, cp: int) -> None:
    """The JAX package's refusal: the heads are what is scattered."""
    if cp > 1 and (hq % cp or hkv % cp):
        raise ValueError(
            f"ulysses context parallelism scatters heads over the context "
            f"axis: cp={cp} must divide both query heads ({hq}) and kv "
            f"heads ({hkv}) — use ring attention for this head layout")


def _scatter_heads(x: torch.Tensor, group, cp: int) -> torch.Tensor:
    """[B, s, H, D] -> [B, cp*s, H/cp, D]: head chunk j to context rank
    j, the pieces of the sequence concatenated in rank order."""
    b, s, h, d = x.shape
    rows = x.reshape(b, s, cp, h // cp, d).permute(2, 0, 1, 3, 4)
    got = exchange(rows, group, [1] * cp, [1] * cp)
    return got.permute(1, 0, 2, 3, 4).reshape(b, cp * s, h // cp, d)


def _gather_heads(x: torch.Tensor, group, cp: int) -> torch.Tensor:
    """The inverse: [B, S, H/cp, D] -> [B, S/cp, H, D]."""
    b, n, h, d = x.shape
    s = n // cp
    rows = x.reshape(b, cp, s, h, d).permute(1, 0, 2, 3, 4)
    got = exchange(rows, group, [1] * cp, [1] * cp)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s, cp * h, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, mask_type: str = "causal",
                      sliding_window: Optional[int] = None) -> torch.Tensor:
    """Exact attention of this rank's piece [B, S/cp, H, D] of the
    sequence over the whole sequence, by the two all-to-alls."""
    from megatron_tpu_torch.ops.attention import attention

    cp, group = mesh.cp, mesh.group("context")
    check_heads(q.shape[2], k.shape[2], cp)
    qg, kg, vg = (_scatter_heads(t, group, cp) for t in (q, k, v))
    out = attention(qg, kg, vg, mask_type=mask_type,
                    sliding_window=sliding_window, impl="pallas")
    return _gather_heads(out, group, cp)
