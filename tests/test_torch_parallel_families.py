"""Falcon's parallel attention, the post-LN block and --metrics at more
than one rank, on 4 gloo processes (the CPU).

The models are the JAX topology matrix's tiny one (4 layers, h 32, 4
heads over 2 kv heads, ffn 64, vocab 128, S 32, fp32; full recompute)
in three forms:

  * falcon40: Falcon-40B's block (parallel attention with its own MLP
    layernorm, layernorm, exact gelu, tied embeddings);
  * post_ln: the post-LN block (layernorm), and post_ln_res the same
    with the residual taken after the layernorm
    (apply_residual_connection_post_layernorm).

Each form trains two steps at tp2 + SP (dp 2) and at tp2 x pp2 with
ZeRO-1, held to the port's one-process step with PR 11's tolerances
(losses 1e-4, grad norms a relative 1e-4, final parameters 1e-5): the
parallel block reduces its two row-parallel branches in one collective,
so its partial sums add in another order than one process's. Each form
also runs the JAX jitted step on the fake tp2 + SP mesh from the same
weights (losses 1e-4, grad norms a relative 1e-4).

--metrics (perplexity, accuracy, instruct_accuracy, count_loss_mask)
over a loss mask of 0, 0.5 and 1 weights at tp2 (dp 2) and pp2 (dp 2)
equals the one-process eval step within 1e-5, and the vocab-parallel
argmax resolves ties across and inside the two vocab shards to
torch.argmax's lowest index.

One spawn for the file; the JAX steps compile while the ranks run.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import _torch_families_worker as F
import _torch_parallel_worker as W
from megatron_tpu.config import (
    ModelConfig, OptimizerConfig, ParallelConfig, TrainingConfig,
)
from megatron_tpu.models.params import param_specs
from megatron_tpu.parallel.mesh import build_mesh
from megatron_tpu.parallel.sharding import shard_tree
from megatron_tpu.training.optimizer import (
    init_train_state, train_state_specs,
)
from megatron_tpu.training.train_step import make_train_step
from megatron_tpu_torch.training.train_step import make_eval_step

FORMS = {
    "falcon40": dict(W.MATRIX_MODEL, parallel_attn=True,
                     parallel_layernorm=True, normalization="layernorm",
                     activation="gelu", tie_embed_logits=True),
    "post_ln": dict(W.MATRIX_MODEL, use_post_ln=True,
                    normalization="layernorm"),
    "post_ln_res": dict(W.MATRIX_MODEL, use_post_ln=True,
                        normalization="layernorm",
                        apply_residual_post_ln=True),
}
TOPOLOGIES = {
    "tp2_sp": dict(parallel=dict(tensor_parallel=2, sequence_parallel=True)),
    "tp2_pp2_zero1": dict(parallel=dict(tensor_parallel=2,
                                        pipeline_parallel=2), zero1=True),
}
CASES = {f"{form}_{topo}": dict(case, model=model)
         for form, model in FORMS.items()
         for topo, case in TOPOLOGIES.items()}
EVAL_CASES = {
    "tp2": dict(parallel=dict(tensor_parallel=2)),
    "pp2": dict(parallel=dict(pipeline_parallel=2)),
}


def _jax_steps(model_kw: dict):
    """Two JAX jitted steps at tp2 + SP on the fake 8-device mesh (dp
    4), from the port's weights of the form."""
    case = dict(model=model_kw)
    model = ModelConfig(**model_kw).validate()
    rt = build_mesh(ParallelConfig(tensor_parallel=2,
                                   sequence_parallel=True))
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    train = TrainingConfig(micro_batch_size=1, global_batch_size=8,
                           train_iters=2, recompute_granularity="full")
    tree = {}
    for path, v in W.flat_numpy(W.full_params(
            W.configs(case)[0])).items():
        node = tree
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = jnp.asarray(v)
    params = shard_tree(rt, tree, param_specs(model))
    step = make_train_step(model, opt, train,
                           num_microbatches=8 // rt.dp, train_iters=2)
    state = init_train_state(opt, params)
    specs = train_state_specs(param_specs(model), params, rt.dp,
                              zero1=False, ep=1)
    shardings = jax.tree.map(lambda s: NamedSharding(rt.mesh, s), specs,
                             is_leaf=lambda s: isinstance(s, JP))
    batch = {k: jnp.asarray(v) for k, v in W.make_batch(model_kw).items()}
    losses, norms = [], []
    with jax.sharding.set_mesh(rt.mesh):
        state = jax.device_put(state, shardings)
        jstep = jax.jit(step, in_shardings=(shardings, None),
                        out_shardings=(shardings, None))
        for _ in range(2):
            state, m = jstep(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}


@pytest.fixture(scope="module")
def runs():
    jobs = [(name, "train", case) for name, case in CASES.items()]
    jobs += [(f"eval_{name}", "call", ("_torch_families_worker:eval_job",
                                       {"case": case}))
             for name, case in EVAL_CASES.items()]
    jobs.append(("argmax", "call", ("_torch_families_worker:argmax_job",
                                    {})))
    world = W.World(4, jobs)
    # compiles while the ranks train
    jax_out = {form: _jax_steps(model) for form, model in FORMS.items()}
    return world.results(), jax_out


@pytest.mark.parametrize("name", list(CASES))
def test_families_at_tp2_equal_the_single_process_step(runs, name):
    W.check_against_single_process(runs[0][name], CASES[name])


@pytest.mark.parametrize("form", list(FORMS))
def test_families_at_tp2_sp_equal_the_jax_jitted_step(runs, form):
    got, want = runs[0][f"{form}_tp2_sp"], runs[1][form]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-4)


@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_metrics_across_ranks_equal_one_process(runs, name):
    got = runs[0][f"eval_{name}"]
    case = EVAL_CASES[name]
    model, train, _ = F.eval_configs(case)
    batch = F.eval_batch(W.MATRIX_MODEL)
    want = make_eval_step(model, train)(
        W.full_params(model), {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert got["ranks_agree"]
    # lm_loss across ranks is the mean of per-rank (and per-microbatch)
    # means, which the uneven loss mask moves; perplexity is the
    # batch's masked mean
    for key in ("ntokens",) + F.METRICS:
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_vocab_parallel_argmax_breaks_ties_as_torch_argmax(runs):
    got = runs[0]["argmax"]
    assert got["ids_equal"], (got["ids"], got["want"])
    assert got["accuracy"] == got["accuracy_one_process"]
