"""Helpers the encoder-family parity tests share (test_torch_bert.py,
test_torch_t5.py, test_torch_ict.py, test_torch_tasks.py): gradients of a
port loss as a tree, the per-leaf gradient gate, batch casts and the
sentence-level corpora the datasets read."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from megatron_tpu_torch.data.indexed_dataset import make_builder
from megatron_tpu_torch.training.optimizer import leaf_paths, nest_paths


def grads(loss_fn, params):
    """(loss, aux, the gradient tree) of loss_fn(params) -> (loss, aux);
    a leaf the loss never reads gets zeros."""
    leaves = leaf_paths(params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss, aux = loss_fn(params)
    gs = torch.autograd.grad(loss, [p for _, p in leaves], allow_unused=True)
    return loss, aux, nest_paths({k: torch.zeros_like(p) if g is None else g
                                  for (k, p), g in zip(leaves, gs)})


def jax_reference(forward, loss, params, batch):
    """(forward(params, batch), (loss, aux), grads of the loss) of the JAX
    functions, under one jit: one compile for the forward and the
    gradient, at XLA's backend optimization level 0 (the same fp32
    arithmetic; the compile takes about a third of the time)."""
    def both(p, b):
        return forward(p, b), jax.value_and_grad(
            lambda q: loss(q, b), has_aux=True)(p)

    compiled = jax.jit(both).lower(params, batch).compile(
        {"xla_backend_optimization_level": 0})
    out, (value, grads_) = compiled(params, batch)
    return out, value, grads_


def assert_grads_close(tgrads, jgrads, rel=1e-4):
    """Every leaf within rel of that leaf's norm (the JAX gradient's). A
    leaf whose gradient is zero in exact arithmetic (the attention's key
    bias, which the softmax ignores; in the in-batch softmax the context
    tower's output bias, a constant shift of each query's scores) holds
    rounding noise alone, so a leaf's norm is floored at 1e-3 of the
    whole gradient's norm."""
    flat_j = dict(leaf_paths(jax.tree.map(np.asarray, jgrads)))
    flat_t = dict(leaf_paths(tgrads))
    assert set(flat_j) == set(flat_t)
    total = float(np.sqrt(sum(np.square(g).sum() for g in flat_j.values())))
    for k, jg in flat_j.items():
        tg = flat_t[k].detach().numpy()
        scale = max(float(np.linalg.norm(jg)), 1e-3 * total)
        assert float(np.linalg.norm(tg - jg)) <= rel * scale, k


def assert_aux_close(taux, jaux, rtol=1e-5):
    """The same aux keys, each value within rtol."""
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=rtol, err_msg=k)


def jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                           else v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def sentence_corpus(prefix, n_docs=10, vocab=200, seed=0, lo=4, hi=12):
    """A sentence-level corpus: docs of 3-6 sentences of lo..hi-1 ids."""
    builder = make_builder(prefix, vocab_size=vocab)
    rng = np.random.default_rng(seed)
    for _ in range(n_docs):
        for _ in range(rng.integers(3, 7)):
            builder.add_item(rng.integers(10, vocab, rng.integers(lo, hi)))
        builder.end_document()
    builder.finalize(prefix + ".idx")
    return prefix


def titles_corpus(prefix, n_docs=10, vocab=200, seed=1):
    """One 3-id title per document."""
    builder = make_builder(prefix, vocab_size=vocab)
    rng = np.random.default_rng(seed)
    for _ in range(n_docs):
        builder.add_item(rng.integers(10, vocab, 3))
        builder.end_document()
    builder.finalize(prefix + ".idx")
    return prefix
