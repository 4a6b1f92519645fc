"""MoE above one rank: the port on gloo ranks (the CPU) against its
one-process path and the JAX package on the 8-device CPU mesh.

Two spawns for the file, started at once (tests/_torch_moe_worker.py):
four ranks run the layer cases, the training cases and the checkpoint
save; two ranks serve. Held, in fp32:

  * one MoE layer (tests/test_moe.py's _moe_cfg, its seed-5 weights) at
    tp2 (dp 2), tp2 + SP, ep2 (data 2 x expert 2) and ep2 x tp2, both
    dispatches: y, the aux loss and the gradients of router, w_in, w_out
    and x against the JAX moe_block on ParallelConfig(expert_parallel=2,
    tensor_parallel=2) (test_moe_dropless_ep_matches_single_group's
    tolerances: y rtol 2e-5 / atol 2e-6, aux rtol 1e-5, gradients rtol
    5e-4 / atol 5e-6). The gradients are reduced as the training step
    reduces them, so the router's is the global loss's at every
    topology (its statistics averaged over the batch ranks, its aux
    term counted once over the tensor ranks);
  * dropless at ep2 with the router saturated toward one rank: exact
    at the default receive buffer (JAX's moe_block_dropless), and at
    moe_ep_buffer_factor 1 the same greedy source-order drops as the
    JAX shard_map form on the same partition of the rows;
  * a tiny 4-layer MoE trained 2 steps at tp2_sp, pp2, pp2_vpp2,
    dp4_zero1, ep2_zero1 and ep2_tp2 (capacity, and dropless at the two
    expert-parallel ones; ep2_tp2 with linear biases too): losses 1e-4, moe_aux_loss rtol 1e-5, grad
    norms rtol 1e-4, the first step's router gradient (rtol 5e-4 / atol
    5e-6) and the final parameters (1e-5) against one process at a
    micro-batch of dp rows (a rank's i-th microbatch is its part of the
    global i-th, data/samplers.rank_rows); the tp2_sp loss and aux
    against the JAX lm_loss on the tp2 mesh per global microbatch (rel
    1e-5) and the pp2 loss against JAX's pipelined loss (rel 1e-5);
  * a state saved at ep2 x tp2 with ZeRO-1 loads bitwise at world 1,
    tp2, dp2 with ZeRO-1 and ep2 with ZeRO-1;
  * a tiny MoE served at tp2 (one-shot, the dense engine, the paged
    engine over a pool that preempts) and at pp2 (one-shot), both
    dispatches, equal to one process token for token (logprobs 1e-5);
  * the refusals that remain are JAX's: E % ep, ep without experts,
    and --weight_int8 with MoE.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_moe_worker as M
import _torch_ckpt_worker as C
import _torch_parallel_worker as W
import _torch_pp_serving_worker as P
import _torch_tp_serving_worker as S
from megatron_tpu.config import ParallelConfig as JParallel
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_loss as j_lm_loss
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.models.params import param_specs as j_param_specs
from megatron_tpu.ops import moe as jmoe
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.parallel.sharding import shard_tree
from megatron_tpu.training.pipeline import make_pipeline_loss_fn
from megatron_tpu_torch.config import ParallelConfig
from megatron_tpu_torch.inference import generation as tg
from megatron_tpu_torch.inference.engine import InferenceEngine
from megatron_tpu_torch.inference.paging import PagedInferenceEngine
from megatron_tpu_torch.models.params import (
    StatePlacement, check_mesh, init_params,
)
from megatron_tpu_torch.parallel.mesh import build_mesh
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry
from megatron_tpu_torch.training import checkpointing as ckpt

BLOCK_TOPOLOGIES = {
    "tp2": dict(tensor_parallel=2),
    "tp2_sp": dict(tensor_parallel=2, sequence_parallel=True),
    "ep2": dict(expert_parallel=2),
    "ep2_tp2": dict(expert_parallel=2, tensor_parallel=2),
}
BLOCK_CASES = {f"{d}_{t}": (d, t, "default")
               for d in ("capacity", "dropless") for t in BLOCK_TOPOLOGIES}
BLOCK_CASES["imbalance"] = ("dropless", "ep2", "imbalance")
BLOCK_CASES["buffer"] = ("dropless", "ep2", "buffer")
TRAIN_CASES = {
    "tp2_sp": dict(parallel=dict(tensor_parallel=2, sequence_parallel=True)),
    "pp2": dict(parallel=dict(pipeline_parallel=2)),
    "pp2_vpp2": dict(parallel=dict(pipeline_parallel=2,
                                   virtual_pipeline_parallel=2)),
    "dp4_zero1": dict(zero1=True),
    "ep2_zero1": dict(parallel=dict(expert_parallel=2), zero1=True),
    "ep2_tp2": dict(parallel=dict(expert_parallel=2, tensor_parallel=2)),
    "ep2_zero1_dropless": dict(parallel=dict(expert_parallel=2), zero1=True,
                               model=dict(moe_dispatch="dropless")),
    "ep2_tp2_dropless": dict(parallel=dict(expert_parallel=2,
                                           tensor_parallel=2),
                             model=dict(moe_dispatch="dropless")),
    # the experts' biases: b_out added once over the tensor ranks
    "ep2_tp2_bias": dict(parallel=dict(expert_parallel=2, tensor_parallel=2),
                         model=dict(use_bias_linear=True)),
}
# name -> (ParallelConfig kwargs, world size, ZeRO-1)
LOAD_TOPOLOGIES = {
    "tp2": (dict(tensor_parallel=2), 2, False),
    "dp2_zero1": ({}, 2, True),
    "ep2_zero1": (dict(expert_parallel=2), 2, True),
    "ep2_tp2_zero1": (M.SAVE_PARALLEL, 4, True),
}
DISPATCHES = ("capacity", "dropless")
JAX_EP_MESH = dict(expert_parallel=2, tensor_parallel=2)
# the JAX function does not depend on the topology: one computation per
# dispatch serves every default case
JAX_BLOCKS = ("capacity_tp2", "dropless_tp2", "imbalance", "buffer")


def _jax_layer(dispatch, variant):
    """(JAX cfg, layer-0 moe weights as numpy) of tests/test_moe.py's
    seed-5 case. The saturated variants' router sends every token to
    expert 0 or 1, both on expert rank 0 (as the JAX test's does, without
    its ties among the other experts: torch.topk and lax.top_k need not
    break a tie alike)."""
    jcfg = j_presets.tiny(**dict(M.MOE_KW, moe_dispatch=dispatch,
                                 **M.VARIANTS[variant]))
    p = j_init_params(jcfg, jax.random.PRNGKey(5))
    w = {k: np.asarray(v[0]) for k, v in p["layers"]["moe"].items()}
    if variant != "default":
        router = np.zeros_like(w["router"])
        router[:, 0], router[:, 1] = 10.0, -10.0
        w["router"] = router
    return jcfg, w


def _layer_input():
    rng = np.random.default_rng(3)
    return rng.standard_normal((4, 16, 32)).astype(np.float32)


def _jax_block(dispatch, variant):
    """y, aux and the gradients of sum(y^2) + aux: on the JAX EP mesh,
    or (the imbalance case) through the single-group dropless form."""
    jcfg, w = _jax_layer(dispatch, variant)
    fn = (jmoe.moe_block_dropless if variant == "imbalance"
          else jmoe.moe_block)

    def loss(p, x):
        y, aux = fn(jcfg, p, x)
        return jnp.sum(jnp.square(y)) + aux, (y, aux)

    p = {k: jnp.asarray(v) for k, v in w.items()}
    x = jnp.asarray(_layer_input())
    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    if variant == "imbalance":
        (_, (y, aux)), (gp, gx) = grad(p, x)
    else:
        rt = j_build_mesh(JParallel(**JAX_EP_MESH))
        with jax.sharding.set_mesh(rt.mesh):
            (_, (y, aux)), (gp, gx) = grad(p, x)
    return {"y": np.asarray(y), "aux": float(aux), "x_grad": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()}}


def _j_tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def _jax_train_losses():
    """(mean over the global microbatches of the JAX lm_loss on the tp2
    mesh and of its moe_aux_loss; the JAX pipelined loss at pp2), from
    the training cases' starting weights and batch."""
    jcfg = j_presets.tiny(**M.TRAIN_MODEL)
    tree = _j_tree(W.flat_numpy(init_params(M.train_model(), W.SEED,
                                            device="cpu")))
    batch = {k: jnp.asarray(v) for k, v in M.train_batch().items()}
    rt = j_build_mesh(JParallel(tensor_parallel=2))
    sharded = shard_tree(rt, tree, j_param_specs(jcfg))
    step = jax.jit(lambda p, b: j_lm_loss(jcfg, p, b))
    losses, auxes = [], []
    with jax.sharding.set_mesh(rt.mesh):
        for i in range(0, M.GLOBAL, 2):       # tp2_sp's dp is 2
            loss, aux = step(sharded, {k: v[i:i + 2]
                                       for k, v in batch.items()})
            losses.append(float(loss))
            auxes.append(float(aux["moe_aux_loss"]))
    rt = j_build_mesh(JParallel(pipeline_parallel=2))
    loss_fn = make_pipeline_loss_fn(jcfg, rt.mesh, 2, M.GLOBAL // 2)
    with jax.sharding.set_mesh(rt.mesh):
        pipelined = float(jax.jit(loss_fn)(tree, batch)[0])
    return {"tp2_loss": float(np.mean(losses)),
            "tp2_aux": float(np.mean(auxes)), "pp2_loss": pipelined}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("moe_ckpt"))
    x = _layer_input()
    jobs = []
    for name, (dispatch, topo, variant) in BLOCK_CASES.items():
        jobs.append((f"block_{name}", "call", (
            "_torch_moe_worker:block_job",
            dict(parallel=BLOCK_TOPOLOGIES[topo], dispatch=dispatch,
                 variant=variant, weights=_jax_layer(dispatch, variant)[1],
                 x=x))))
    jobs += [(f"train_{name}", "call", ("_torch_moe_worker:train_job",
                                        {"case": case}))
             for name, case in TRAIN_CASES.items()]
    jobs.append(("save", "call", ("_torch_moe_worker:save_job",
                                  {"out_dir": out_dir})))
    four = W.World(4, jobs)
    two = W.World(2, [(f"serve_{d}", "call", ("_torch_moe_worker:serve_job",
                                              {"dispatch": d}))
                      for d in DISPATCHES])
    # the JAX references compile while the ranks run
    jax_out = {name: _jax_block(*BLOCK_CASES[name][::2])
               for name in JAX_BLOCKS}
    jax_out["train"] = _jax_train_losses()
    return {**four.results(), **two.results()}, jax_out, out_dir


def _block_want(jax_out, name):
    """Every default case of a dispatch holds the one JAX computation."""
    dispatch, _, variant = BLOCK_CASES[name]
    return jax_out[f"{dispatch}_tp2" if variant == "default" else name]


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_moe_block_across_ranks_equals_jax(runs, name):
    got, want = runs[0][f"block_{name}"], _block_want(runs[1], name)
    assert got["ranks_agree"]
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
    for key in ("router", "w_in", "w_out"):
        np.testing.assert_allclose(got["grads"][key], want["grads"][key],
                                   rtol=5e-4, atol=5e-6, err_msg=key)
    np.testing.assert_allclose(got["x_grad"], want["x_grad"], rtol=5e-4,
                               atol=5e-6)


def test_buffer_factor_drops_rows_greedily(runs):
    """At moe_ep_buffer_factor 1 the saturated router overflows the hot
    rank's buffer: some tokens pass with a zero output (top-1), and the
    kept ones equal the dropless layer's."""
    got = runs[0]["block_buffer"]["y"].reshape(-1, 32)
    full = _block_want(runs[1], "imbalance")["y"].reshape(-1, 32)
    zero = np.all(np.isclose(got, 0.0, atol=1e-7), -1)
    assert 0 < zero.sum() < len(zero)
    np.testing.assert_allclose(got[~zero], full[~zero], rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_moe_training_across_ranks_equals_one_process(runs, name):
    got, case = runs[0][f"train_{name}"], TRAIN_CASES[name]
    assert got["ranks_agree"]
    losses, auxes, norms, grads, state = M.run_steps(case, micro=got["dp"])
    np.testing.assert_allclose(got["losses"], losses, atol=1e-4)
    np.testing.assert_allclose(got["moe_aux_losses"], auxes, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-4)
    np.testing.assert_allclose(got["router_grad"],
                               grads["layers/moe/router"].numpy(),
                               rtol=5e-4, atol=5e-6)
    for path, x in W.flat_numpy(state.params).items():
        np.testing.assert_allclose(got["params"][path], x, atol=1e-5,
                                   err_msg=path)


def test_moe_training_across_ranks_equals_the_jax_mesh(runs):
    want = runs[1]["train"]
    tp2 = runs[0]["train_tp2_sp"]
    assert tp2["losses"][0] == pytest.approx(want["tp2_loss"], rel=1e-5)
    assert tp2["moe_aux_losses"][0] == pytest.approx(want["tp2_aux"],
                                                     rel=1e-5)
    assert runs[0]["train_pp2"]["losses"][0] == pytest.approx(
        want["pp2_loss"], rel=1e-5)


@pytest.fixture(scope="module")
def saved_state():
    return M.one_process_state()


@pytest.mark.parametrize("topology", ["world1"] + list(LOAD_TOPOLOGIES))
def test_expert_axis_checkpoint_loads_bitwise(runs, saved_state, topology):
    out_dir = runs[2]
    cfg, full = saved_state
    _, fresh = M.one_process_state(seed=9, steps=0)
    path = os.path.join(out_dir, "sharded")
    if topology == "world1":
        got, it, _ = ckpt.load_checkpoint(path, fresh)
        assert it == M.STEPS
        _assert_bitwise(got, full, topology)
        return
    kw, size, zero1 = LOAD_TOPOLOGIES[topology]
    par = ParallelConfig(**kw)
    for r in range(size):
        mesh = build_mesh(par, world_size=size, rank=r)
        got, _, _ = ckpt.load_checkpoint(
            path, C.slice_state(fresh, cfg, mesh, zero1),
            placement=StatePlacement.of(cfg, mesh, zero1))
        _assert_bitwise(got, C.slice_state(full, cfg, mesh, zero1),
                        f"{topology} rank {r}")


def _assert_bitwise(got, want, where):
    a, b = ckpt._state_fields(got), ckpt._state_fields(want)
    assert set(a) == set(b), where
    for field in a:
        assert set(a[field]) == set(b[field]), (where, field)
        for name, t in a[field].items():
            assert torch.equal(t, b[field][name]), (where, field, name)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_served_across_ranks_equals_one_process(runs, dispatch):
    got = runs[0][f"serve_{dispatch}"]
    cfg = M.serve_cfg(dispatch)
    params = init_params(cfg, M.SERVE_SEED, device="cpu")
    assert got["tp2_agree"] and got["pp2_agree"]
    one = tg.generate_tokens(cfg, params, S.PROMPTS, S.LENGTHS, S.NEW,
                             temperature=0.0, vocab_size=S.VOCAB)
    eng = InferenceEngine(cfg, params, num_slots=2, max_seq_len=64,
                          vocab_size=S.VOCAB, device="cpu",
                          metrics=MetricsRegistry())
    paged = PagedInferenceEngine(cfg, params, vocab_size=S.VOCAB,
                                 device="cpu", metrics=MetricsRegistry(),
                                 **P.PAGED)
    for key, want in (("tp2_generate", one), ("pp2_generate", one),
                      ("engine", eng.generate(S.PROMPTS, S.LENGTHS, S.NEW)),
                      ("paged", paged.generate(*P.PAIR, P.PAIR_NEW))):
        np.testing.assert_array_equal(got[key]["tokens"], want.tokens,
                                      err_msg=key)
        np.testing.assert_allclose(got[key]["logprobs"], want.logprobs,
                                   atol=1e-5, err_msg=key)
    assert paged.stats["preemptions"] >= 1


def test_the_remaining_refusals_are_the_jax_packages():
    from megatron_tpu_torch.tools import run_text_generation_server as rts

    cfg = M.train_model()
    with pytest.raises(ValueError, match="divisible by expert_parallel=2"):
        check_mesh(dataclasses.replace(cfg, num_experts=3),
                   build_mesh(ParallelConfig(expert_parallel=2),
                              world_size=2, rank=0))
    with pytest.raises(ValueError, match="no experts"):
        check_mesh(dataclasses.replace(cfg, num_experts=None),
                   build_mesh(ParallelConfig(expert_parallel=2),
                              world_size=2, rank=0))
    args = rts.parse_args(["--weight_int8", "--device", "cpu"])
    with pytest.raises(SystemExit, match="MoE"):
        rts.weight_quant_mode(args, cfg)
