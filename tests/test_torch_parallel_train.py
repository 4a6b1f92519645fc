"""The port's parallel training step on 8 gloo processes (the CPU) held
to its single-process step, tp2 x pp2 and tp2 x cp2 + SP with ZeRO-1
held directly to the JAX jitted step on the fake 8-device mesh, and
pp2 x cp2 x tp2 to MULTICHIP_r05's recorded JAX dry run.

The cases are the JAX topology matrix's seven combinations
(tests/_parallel_matrix_cases.py: tp2_sp, cp2, pp2, pp2_vpp2, tp2_pp2,
tp2_cp2_sp, tp2_pp2_cp2_sp; its attention_impl "xla", so context
parallelism all-gathers K/V) with ZeRO-1 off and on, on its tiny model
(4 layers, h 32, 4 heads over 2 kv heads, ffn 64, vocab 128, S 32,
global batch 8, micro-batch 1, fp32, full recompute) over the same 8
ranks, so data parallelism takes the rest (dp 4; 2 for tp2_pp2 and
tp2_cp2_sp, 1 for tp2_pp2_cp2_sp) as on the JAX mesh.
Each case takes two steps: losses within 1e-4 and grad norms within a
relative 1e-4 of the single-process step (test_torch_train.py's
tolerances), every rank reporting the same numbers, and the final
parameters, put back together from every rank's slices, within 1e-5.
tests/test_torch_parallel_models.py runs the other models and policies.

One spawn for the file; the JAX step compiles while the ranks run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import _torch_cp_worker as CPW
import _torch_parallel_worker as W
from megatron_tpu.config import (
    ModelConfig, OptimizerConfig, ParallelConfig, TrainingConfig,
)
from megatron_tpu.models.params import init_params, param_specs
from megatron_tpu.parallel.mesh import build_mesh
from megatron_tpu.parallel.sharding import shard_tree
from megatron_tpu.training.optimizer import (
    init_train_state, train_state_specs,
)
from megatron_tpu.training.pipeline import make_pipeline_loss_fn
from megatron_tpu.training.train_step import make_train_step

COMBOS = {
    "tp2_sp": dict(tensor_parallel=2, sequence_parallel=True),
    "cp2": dict(context_parallel=2),
    "pp2": dict(pipeline_parallel=2),
    "pp2_vpp2": dict(pipeline_parallel=2, virtual_pipeline_parallel=2),
    "tp2_pp2": dict(tensor_parallel=2, pipeline_parallel=2),
    "tp2_cp2_sp": dict(tensor_parallel=2, context_parallel=2,
                       sequence_parallel=True),
    "tp2_pp2_cp2_sp": dict(tensor_parallel=2, pipeline_parallel=2,
                           context_parallel=2, sequence_parallel=True),
}
CASES = {f"{name}_zero1_{'on' if z else 'off'}": dict(parallel=kw, zero1=z)
         for name, kw in COMBOS.items() for z in (False, True)}
JAX_CASES = ("tp2_pp2_zero1_on", "tp2_cp2_sp_zero1_on")


def _jax_steps(name):
    """A case with ZeRO-1 (dp 2): the JAX jitted train step on the fake
    mesh (through make_pipeline_loss_fn at pp > 1), from the port's
    weights."""
    case = CASES[name]
    model = ModelConfig(**W.MATRIX_MODEL).validate()
    rt = build_mesh(ParallelConfig(**case["parallel"]))
    assert rt.dp == 2
    opt = OptimizerConfig(lr=1e-3, lr_decay_style="constant",
                          use_distributed_optimizer=True)
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
    n_micro = 8 // rt.dp
    pp = case["parallel"].get("pipeline_parallel", 1)
    loss_fn = (make_pipeline_loss_fn(model, rt.mesh, pp, n_micro,
                                     recompute="full") if pp > 1 else None)
    step = make_train_step(model, opt, train, num_microbatches=n_micro,
                           train_iters=2, pipeline_loss_fn=loss_fn)
    state = init_train_state(opt, params)
    specs = train_state_specs(param_specs(model), params, rt.dp, zero1=True,
                              ep=1)
    shardings = jax.tree.map(lambda s: NamedSharding(rt.mesh, s), specs,
                             is_leaf=lambda s: isinstance(s, JP))
    batch = {k: jnp.asarray(v) for k, v in W.make_batch(
        W.MATRIX_MODEL).items()}
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


def _multichip_params(path):
    """The JAX tiny Llama's init (PRNGKey 0), saved as flat numpy paths
    for the ranks (which do not import JAX)."""
    jcfg = ModelConfig(**CPW.MULTICHIP_MODEL).validate()
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            name = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                flat[name] = np.asarray(v)

    walk(jax.device_get(init_params(jcfg, jax.random.PRNGKey(0))))
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multichip") / "params.npz")
    _multichip_params(path)
    world = W.World(8, [(name, "train", case)
                        for name, case in CASES.items()]
                    + [("multichip", "call", ("_torch_cp_worker:multichip_job",
                                              {"params_path": path}))])
    # the JAX steps compile while the ranks train
    jax_result = {name: _jax_steps(name) for name in JAX_CASES}
    return world.results(), jax_result


@pytest.mark.parametrize("name", list(CASES))
def test_parallel_steps_equal_the_single_process_step(runs, name):
    W.check_against_single_process(runs[0][name], CASES[name])


def _check_jax(runs, name):
    got, want = runs[0][name], runs[1][name]
    assert got["dp"] == 2
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-4)


def test_tp2_pp2_zero1_equals_the_jax_jitted_step(runs):
    _check_jax(runs, "tp2_pp2_zero1_on")


def test_tp2_cp2_sp_zero1_equals_the_jax_jitted_step(runs):
    """Context parallelism (all-gathered K/V, the JAX matrix's "xla")
    under tp2 + SP against GSPMD's step."""
    _check_jax(runs, "tp2_cp2_sp_zero1_on")


def test_pp2_cp2_tp2_step_reproduces_the_multichip_dry_run(runs):
    """MULTICHIP_r05.json's JAX dry run (__graft_entry__.dryrun_multichip
    (8): pipe2 x context2 x tensor2 + SP, ZeRO-1, two virtual chunks,
    the tiny Llama at S 64 in fp32 from PRNGKey 0) printed loss=10.4983
    grad_norm=12.0853; the port's step at the same topology on the same
    weights and batch gives both to the printed 4 decimals (atol 1e-4)."""
    got = runs[0]["multichip"]
    np.testing.assert_allclose(got["loss"], 10.4983, atol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], 12.0853, atol=1e-4)
