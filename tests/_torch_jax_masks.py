"""The JAX package's dropout masks along the port's key paths, for the
dropout parity tests (tests/test_torch_dropout.py and the multi-rank
cases).

A port DropoutKey (megatron_tpu_torch/parallel/random.py) is the path
PRNGKey(seed) -> fold_in(stream) -> fold_in(step) -> folds, each fold an
int (fold_in) or ("split", n, i); jax_key replays it with jax.random,
which is the key the JAX package itself derives at the same site, and
jax_mask_source draws jax.random.bernoulli(key, 1 - rate, shape) from it:
injected into the port, the port draws the JAX package's own masks.

Spawned gloo ranks do not import JAX, so mask_table precomputes the
masks of a list of (key, shape, rate) in the parent and table_source
serves them by path in a rank.
"""

import jax
import numpy as np
import torch


def jax_key(key):
    k = jax.random.fold_in(jax.random.PRNGKey(key.seed), key.stream)
    k = jax.random.fold_in(k, key.step)
    for f in key.folds:
        if isinstance(f, tuple):
            _, n, i = f
            k = jax.random.split(k, n)[i]
        else:
            k = jax.random.fold_in(k, f)
    return k


def jax_keep(key, shape, rate):
    return np.array(jax.random.bernoulli(jax_key(key), 1.0 - rate,
                                         tuple(shape)))


def jax_mask_source(key, shape, rate, device):
    return torch.from_numpy(jax_keep(key, shape, rate)).to(device)


def mask_table(sites):
    """{repr(key.path()): keep} for sites [(key, shape, rate)]."""
    return {repr(key.path()): jax_keep(key, shape, rate)
            for key, shape, rate in sites}
