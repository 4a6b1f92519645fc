"""The port's parallel building blocks against the JAX package, on the
CPU.

Single-process units: ParallelConfig's fields and defaults, zero1_spec
and zero1_spec_tree, vpp_place_indices, the rank layout (rank r sits at
JAX device r's mesh position), host_batch_slice (rank r loads the rows
JAX places on device r) and the per-rank parameter slices (shard_leaf
gives rank r the shard JAX's shard_tree puts on device r, except the
GLU input projection, cut per half by design; unshard inverts it for
every path of the Llama, Falcon and GPT-2 tiny trees), the CLI's
distributed flags and the refusals.

Two gloo processes (one spawn for the file, tests/_torch_parallel_worker
.py): each autograd collective's forward and backward at tp2 against
the unsharded math, both branches of the plain collectives (gloo's
composed reduce-scatter and host path, and the native *_single
collectives) and a two-way p2p, the vocab-parallel cross-entropy with
label smoothing and z_loss against cross_entropy_loss, and two training
cases held to the port's single-process step: dp2 with ZeRO-1, and a
tied-embedding GPT-2 at pp2 (the embedding group's gradient sum); tp2 +
SP and dp2 + ZeRO-1 at dropout 0.1 against one process with the default
mask source, and pp2 at dropout 0.1 against the JAX pipeline with the
JAX masks injected; a
posted send that its caller overwrites before the wait arrives as
posted; and the sharded layout's two-phase commit with a coordinator
on each rank (both hosts stage, rank 0 commits; a poisoned peer aborts
the next commit, journaled, the tracker unmoved).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import os

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import _torch_parallel_worker as W
from megatron_tpu import config as jconfig
from megatron_tpu.arguments import args_to_run_config as j_args_to_run_config
from megatron_tpu.arguments import parse_args as j_parse_args
from megatron_tpu.models import params as jparams
from megatron_tpu.parallel import mesh as jmesh
from megatron_tpu.parallel import sharding as jsharding
from megatron_tpu.training import pipeline as jpipeline
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.arguments import args_to_run_config, parse_args
from megatron_tpu_torch.models import params as tparams
from megatron_tpu_torch.parallel import sharding as tsharding
from megatron_tpu_torch.parallel.distributed import host_batch_slice
from megatron_tpu_torch.parallel.mesh import build_mesh, rank_grid

TOPOLOGIES = [
    dict(tensor_parallel=2),
    dict(pipeline_parallel=2),
    dict(tensor_parallel=2, pipeline_parallel=2),
    dict(pipeline_parallel=2, virtual_pipeline_parallel=2),
    dict(),
]


def _jp(spec):
    return JP(*spec)


def _tp(spec):
    return tsharding.P(*spec)


def test_parallel_config_fields_and_defaults_match_jax():
    tf = {f.name: f.default for f in dataclasses.fields(
        tconfig.ParallelConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(
        jconfig.ParallelConfig)}
    assert tf == jf
    for kw in TOPOLOGIES + [dict(tensor_parallel=1, sequence_parallel=True),
                            dict(tensor_parallel=2, sequence_parallel=True)]:
        t = tconfig.ParallelConfig(**kw).validate()
        j = jconfig.ParallelConfig(**kw).validate()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for n in (4, 8):
            assert (t.derive_data_parallel(n)
                    == j.derive_data_parallel(n))
    for bad in (dict(tensor_parallel=0),
                dict(virtual_pipeline_parallel=2),
                dict(pipeline_parallel=2, virtual_pipeline_parallel=1)):
        with pytest.raises(ValueError):
            tconfig.ParallelConfig(**bad).validate()
        with pytest.raises(ValueError):
            jconfig.ParallelConfig(**bad).validate()
    with pytest.raises(ValueError, match="not divisible"):
        tconfig.ParallelConfig(tensor_parallel=3).derive_data_parallel(8)
    assert "use_distributed_optimizer" in {
        f.name for f in dataclasses.fields(tconfig.OptimizerConfig)}


@pytest.mark.parametrize("dp,ep", [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2)])
def test_zero1_spec_matches_jax(dp, ep):
    cases = [((), (8, 16)), (("tensor", None), (128, 32)),
             (("pipe", None, "tensor"), (4, 32, 64)),
             (("pipe", "tensor", None), (4, 64, 32)),
             ((None,), (32,)), ((None,), (6,)), ((None, None), (3, 5)),
             (("data", None), (8, 8)), (("pipe", "expert", None), (4, 8, 16)),
             ((("data", "expert"), None), (8, 4))]
    for spec, shape in cases:
        want = jsharding.zero1_spec(_jp(spec), shape, dp, ep)
        got = tsharding.zero1_spec(_tp(spec), shape, dp, ep)
        assert tuple(got) == tuple(want), (spec, shape)
        dim = tsharding.zero1_dim(_tp(spec), shape, dp, ep)
        changed = [i for i, (a, b) in enumerate(
            zip(tuple(want) + (None,) * 4, tuple(spec) + (None,) * 4))
            if a != b]
        assert dim == (changed[0] if changed else None)


def test_zero1_spec_tree_matches_jax_on_the_param_trees():
    for cfg_kw in (W.MATRIX_MODEL, W.GPT2_MODEL):
        tcfg = tconfig.ModelConfig(**cfg_kw).validate()
        jcfg = jconfig.ModelConfig(**cfg_kw).validate()
        tspecs = tparams.param_specs(tcfg)
        jspecs = jparams.param_specs(jcfg)
        shapes = tparams.param_shapes(tcfg)
        for dp in (2, 4):
            got = tsharding.zero1_spec_tree(tspecs, shapes, dp)
            want = jsharding.zero1_spec_tree(
                jspecs, jparams.param_shapes(jcfg), dp)
            for path in shapes:
                node = want
                for k in path.split("/"):
                    node = node[k]
                assert tuple(got[path]) == tuple(node), path


@pytest.mark.parametrize("L,Pn,V", [(4, 2, 1), (4, 2, 2), (8, 2, 2),
                                    (12, 3, 2), (8, 4, 2)])
def test_vpp_place_indices_matches_jax(L, Pn, V):
    tp_, ti = tparams.vpp_place_indices(L, Pn, V)
    jp_, ji = jpipeline.vpp_place_indices(L, Pn, V)
    np.testing.assert_array_equal(tp_, jp_)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("kw", TOPOLOGIES, ids=str)
def test_rank_layout_and_batch_rows_match_the_jax_mesh(kw):
    par = tconfig.ParallelConfig(**kw)
    rt = jmesh.build_mesh(jconfig.ParallelConfig(**kw))
    ids = np.vectorize(lambda d: d.id)(rt.mesh.devices)
    grid = rank_grid(par, 8)
    np.testing.assert_array_equal(grid, ids)
    rows = 16
    index = NamedSharding(rt.mesh, JP(jsharding.BATCH_AXES)
                          ).devices_indices_map((rows,))
    for rank in range(8):
        mesh = build_mesh(par, world_size=8, rank=rank)
        dev = next(d for d in index if d.id == rank)
        sl = index[dev][0]
        want = (sl.start or 0, rows if sl.stop is None else sl.stop)
        assert host_batch_slice(mesh, rows) == want
        assert mesh.coords == dict(zip(jmesh.MESH_AXES, np.unravel_index(
            rank, grid.shape)))


FAMILIES = {
    "llama": W.MATRIX_MODEL,
    "falcon": dict(W.MATRIX_MODEL, num_kv_heads=1, parallel_attn=True,
                   parallel_layernorm=True, normalization="layernorm",
                   activation="gelu", tie_embed_logits=True),
    "gpt2": W.GPT2_MODEL,
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shard_leaf_unshard_round_trip(family):
    """Every path of param_specs, cut for each rank of tp2 x pp2 (vpp 2)
    and put back together, is the tensor it was cut from."""
    cfg = tconfig.ModelConfig(**FAMILIES[family]).validate()
    full = {k: torch.from_numpy(v) for k, v in
            W.flat_numpy(W.full_params(cfg)).items()}
    par = tconfig.ParallelConfig(tensor_parallel=2, pipeline_parallel=2,
                                 virtual_pipeline_parallel=2)
    meshes = [build_mesh(par, world_size=8, rank=r) for r in range(8)]
    per_rank = []
    for m in meshes:
        # the per-rank cut by spec (stage_holds and the Falcon tp refusal
        # are exercised by the training tests)
        sizes = {a: m.size(a) for a in jmesh.MESH_AXES}
        per_rank.append({
            p: tsharding.shard_leaf(
                x, tparams.param_specs(cfg)[p], m.coords, sizes,
                glu_dim=(x.dim() - 1 if tparams._glu_dim(p, cfg) else None)
            ).numpy() for p, x in full.items()})
    sizes = {a: meshes[0].size(a) for a in jmesh.MESH_AXES}
    grid = rank_grid(par, 8)
    for path, spec in tparams.param_specs(cfg).items():
        def at(coords, path=path):
            r = int(grid[tuple(coords[a] for a in jmesh.MESH_AXES)])
            return torch.from_numpy(per_rank[r][path])

        glu = tparams._glu_dim(path, cfg)
        back = tsharding.unshard(
            at, spec, sizes, glu_dim=None if glu is None else len(spec) - 1)
        np.testing.assert_array_equal(back.numpy(), full[path].numpy(),
                                      err_msg=path)


def test_rank_slices_are_the_jax_device_shards():
    """Rank r's slice of each leaf is JAX device r's shard under
    shard_tree at tp2 x pp2 (dp 2), the GLU input projection excepted:
    the port cuts it per half, so rank r holds block r of the gate and
    block r of the up projection."""
    cfg_kw = W.MATRIX_MODEL
    tcfg = tconfig.ModelConfig(**cfg_kw).validate()
    jcfg = jconfig.ModelConfig(**cfg_kw).validate()
    flat = W.flat_numpy(W.full_params(tcfg))
    par_kw = dict(tensor_parallel=2, pipeline_parallel=2)
    rt = jmesh.build_mesh(jconfig.ParallelConfig(**par_kw))
    jtree = {}
    for path, v in flat.items():
        node = jtree
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    sharded = jsharding.shard_tree(rt, jtree, jparams.param_specs(jcfg))
    par = tconfig.ParallelConfig(**par_kw)
    for rank in range(8):
        mesh = build_mesh(par, world_size=8, rank=rank)
        mine = tparams.shard_params(
            {k: torch.from_numpy(v) for k, v in flat.items()}, tcfg, mesh)
        for path, x in mine.items():
            node = sharded
            for k in path.split("/"):
                node = node[k]
            shard = next(s for s in node.addressable_shards
                         if s.device.id == rank)
            want = np.asarray(shard.data)
            if path == "layers/mlp/w_in":
                full = flat[path][shard.index[:2]]
                gate, up = np.split(full, 2, axis=-1)
                want = np.concatenate(
                    [np.split(gate, 2, axis=-1)[mesh.tp_rank],
                     np.split(up, 2, axis=-1)[mesh.tp_rank]], axis=-1)
            np.testing.assert_array_equal(x.numpy(), want,
                                          err_msg=f"{path} rank {rank}")


def test_distributed_flags_map_as_the_jax_cli_maps_them():
    # a 32-layer preset both CLIs build alike (the JAX CLI's tiny preset
    # keeps its depth where the port's --num_layers overrides it)
    base = ["--model_name", "llama2-7B", "--fp32"]
    for extra in (["--tensor_model_parallel_size", "2",
                   "--sequence_parallel"],
                  ["--pipeline_model_parallel_size", "2",
                   "--num_layers_per_virtual_pipeline_stage", "8"],
                  ["--pipeline_model_parallel_size", "2",
                   "--num_layers_per_virtual_pipeline_stage", "16"],
                  ["--use_distributed_optimizer"]):
        t = args_to_run_config(parse_args(base + extra))
        j = j_args_to_run_config(j_parse_args(base + extra))
        assert dataclasses.asdict(t.parallel) == dataclasses.asdict(
            j.parallel), extra
        assert (t.optimizer.use_distributed_optimizer
                == j.optimizer.use_distributed_optimizer)
    # context parallelism is ported: the flag and the schemes' names map
    # as the JAX CLI maps them
    extra = ["--context_parallel_size", "2", "--attention_impl", "ring"]
    t = args_to_run_config(parse_args(base + extra))
    j = j_args_to_run_config(j_parse_args(base + extra))
    assert dataclasses.asdict(t.parallel) == dataclasses.asdict(j.parallel)
    assert t.parallel.context_parallel == 2
    assert t.model.attention_impl == j.model.attention_impl == "ring"
    # expert parallelism is ported: the flag maps as the JAX CLI maps it
    extra = ["--expert_model_parallel_size", "2"]
    t = args_to_run_config(parse_args(base + extra))
    j = j_args_to_run_config(j_parse_args(base + extra))
    assert dataclasses.asdict(t.parallel) == dataclasses.asdict(j.parallel)
    assert t.parallel.expert_parallel == 2
    with pytest.raises(ValueError, match="not divisible"):
        args_to_run_config(parse_args(
            base + ["--pipeline_model_parallel_size", "2",
                    "--num_layers_per_virtual_pipeline_stage", "5"]))


def test_refusals_name_what_is_missing():
    from megatron_tpu_torch.training.pretrain import TrainLoop, pretrain

    cfg = tconfig.ModelConfig(**W.MATRIX_MODEL).validate()
    tp4 = build_mesh(tconfig.ParallelConfig(tensor_parallel=4),
                     world_size=4, rank=0)
    with pytest.raises(ValueError, match="kv heads"):
        tparams.check_mesh(cfg, tp4)
    falcon = tconfig.ModelConfig(**FAMILIES["falcon"]).validate()
    tp2 = build_mesh(tconfig.ParallelConfig(tensor_parallel=2),
                     world_size=2, rank=0)
    # Falcon's parallel block shards at tp2 (tests/test_torch_parallel_
    # families.py); Falcon-7B's single kv head does not, as in JAX
    tparams.check_mesh(dataclasses.replace(falcon, num_kv_heads=2), tp2)
    with pytest.raises(ValueError, match="kv heads"):
        tparams.check_mesh(dataclasses.replace(falcon, num_kv_heads=1), tp2)
    # MoE above world size 1 is ported; what stays refused is the JAX
    # package's expert-axis rule: the experts must divide ep
    moe = dataclasses.replace(cfg, num_experts=3, moe_top_k=2).validate()
    ep2 = tconfig.ParallelConfig(expert_parallel=2)
    run = tconfig.RunConfig(
        model=moe, parallel=ep2,
        training=tconfig.TrainingConfig(
            micro_batch_size=1, global_batch_size=2, train_iters=1,
            save="/nonexistent"))
    with pytest.raises(ValueError, match="expert_parallel=2"):
        TrainLoop(run, log=lambda s: None, device="cpu",
                  mesh=build_mesh(ep2, world_size=2, rank=0))
    with pytest.raises(ValueError, match="torch.distributed.run"):
        pretrain(run, lambda c, g: iter(()), device="cpu")


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------

TRAIN_CASES = {
    "dp2_zero1": dict(parallel={}, zero1=True),
    "gpt2_tied_pp2": dict(parallel=dict(pipeline_parallel=2),
                          model=W.GPT2_MODEL),
    # dropout 0.1 (and the LIMA ramp): a rank draws its block of the
    # one-process mask with the default source: the tensor ranks the
    # same hidden mask (sequence pieces under SP) and their kv heads'
    # attention mask; the data ranks their rows of the global
    # microbatch (two rows, one a rank)
    "tp2_sp_dropout": dict(parallel=dict(tensor_parallel=2,
                                         sequence_parallel=True),
                           model=W.DROPOUT_MODEL),
    "dp2_zero1_dropout": dict(parallel={}, zero1=True, rank_rows=True,
                              one_micro=2, model=W.DROPOUT_MODEL),
}
# pp2 at dropout 0.1 with the JAX package's masks along the JAX
# pipeline's key paths: two microbatches of four rows, as
# make_pipeline_loss_fn runs them
PP2_DROPOUT = dict(parallel=dict(pipeline_parallel=2), micro=4,
                   model=W.DROPOUT_MODEL)


def _pp2_mask_sites(model):
    """Every (key, shape, rate) the port's pp2 pipeline draws in the
    case's steps: microbatch m embeds under fold_in(0xE0B).fold_in(m),
    layer l draws under fold_in(m).fold_in(l).split(3): the attention
    probabilities', then the two hidden sites'."""
    from megatron_tpu_torch.models.language_model import _layer_dropout_rates
    from megatron_tpu_torch.parallel.random import RngStreams

    cfg = tconfig.ModelConfig(**model).validate()
    mbs, S, h = PP2_DROPOUT["micro"], cfg.seq_length, cfg.hidden_size
    nkv = cfg.n_kv_heads
    probs = (mbs, nkv, cfg.num_attention_heads // nkv, S, S)
    rates = _layer_dropout_rates(cfg)
    sites = []
    for step in range(W.STEPS):
        key = RngStreams(tconfig.TrainingConfig().seed).dropout(step)
        for m in range(W.GLOBAL_BATCH // mbs):
            sites.append((key.fold_in(0xE0B).fold_in(m), (mbs, S, h),
                          cfg.hidden_dropout))
            for layer in range(cfg.num_layers):
                k_attn, k1, k2 = key.fold_in(m).fold_in(layer).split(3)
                sites += [(k_attn, probs, cfg.attention_dropout),
                          (k1, (mbs, S, h), rates[layer]),
                          (k2, (mbs, S, h), rates[layer])]
    return sites


def _jax_pp2_dropout_steps():
    """The JAX jitted train step through make_pipeline_loss_fn on the
    fake mesh (pipe 2), its own dropout keys, from the port's weights."""
    import jax
    import jax.numpy as jnp

    from megatron_tpu.training.optimizer import init_train_state
    from megatron_tpu.training.train_step import make_train_step as j_step

    model = jconfig.ModelConfig(**W.DROPOUT_MODEL).validate()
    rt = jmesh.build_mesh(jconfig.ParallelConfig(pipeline_parallel=2))
    opt = jconfig.OptimizerConfig(lr=1e-3, lr_decay_style="constant")
    train = jconfig.TrainingConfig(micro_batch_size=1, global_batch_size=8,
                                   train_iters=W.STEPS,
                                   recompute_granularity="full")
    tree = {}
    for path, v in W.flat_numpy(W.full_params(
            W.configs(PP2_DROPOUT)[0])).items():
        node = tree
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = jnp.asarray(v)
    params = jsharding.shard_tree(rt, tree, jparams.param_specs(model))
    n_micro = W.GLOBAL_BATCH // PP2_DROPOUT["micro"]
    loss_fn = jpipeline.make_pipeline_loss_fn(model, rt.mesh, 2, n_micro,
                                              recompute="full")
    step = j_step(model, opt, train, num_microbatches=n_micro,
                  train_iters=W.STEPS, pipeline_loss_fn=loss_fn)
    state = init_train_state(opt, params)
    batch = {k: jnp.asarray(v) for k, v in W.make_batch(
        W.DROPOUT_MODEL).items()}
    losses, norms = [], []
    with jax.sharding.set_mesh(rt.mesh):
        jstep = jax.jit(step).lower(state, batch).compile(
            {"xla_backend_optimization_level": 0})
        for _ in range(W.STEPS):
            state, m = jstep(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from _torch_jax_masks import mask_table

    table = str(tmp_path_factory.mktemp("masks") / "pp2.npz")
    np.savez(table, **mask_table(_pp2_mask_sites(W.DROPOUT_MODEL)))
    jobs = [("mappings", "mappings", None), ("comm", "comm", None),
            ("cross_entropy", "cross_entropy", None),
            ("p2p_snapshot", "p2p_snapshot", None),
            ("coordinated_save", "coordinated_save",
             str(tmp_path_factory.mktemp("coordinated")))]
    jobs += [(name, "train", case) for name, case in TRAIN_CASES.items()]
    jobs.append(("pp2_dropout", "train", dict(PP2_DROPOUT,
                                              mask_table=table)))
    jobs.append(("live_contract", "call",
                 ("_torch_tracing_worker:live_contract", {})))
    world = W.World(2, jobs)
    jax_ref = _jax_pp2_dropout_steps()      # while the ranks run
    return dict(world.results(), jax_pp2_dropout=jax_ref)


def test_sharded_save_commits_two_phase_over_hosts(world2):
    """The sharded layout at tp2 with a coordinator on each rank (each its
    own host): both hosts stage, rank 0 commits; when host 1 has
    published a poison record and stages nothing, rank 0's commit aborts
    (journaled `commit_abort`), the tracker keeps the first save and the
    second stays an uncommitted staging dir."""
    from megatron_tpu_torch.training import checkpointing as ckpt

    got = world2["coordinated_save"]
    save = got["save"]
    assert got["staged_3"] == [0, 1]
    assert ckpt.read_tracker(save) == 3
    path = ckpt.checkpoint_dir(save, 3)
    assert ckpt.verify_checkpoint(path, deep=True)[0]
    assert os.path.exists(os.path.join(path, ckpt.STATE_DIR, ckpt.LAYOUT))
    assert got["aborted"]
    aborts = [e for e in got["events"] if e["kind"] == "commit_abort"]
    assert len(aborts) == 1 and aborts[0]["iteration"] == 5
    assert aborts[0]["host"] == 0 and "test" in aborts[0]["reason"]
    assert ckpt.committed_iterations(save) == [3]
    assert os.path.isdir(ckpt.checkpoint_dir(save, 5) + ckpt.STAGING_SUFFIX)


def test_p2p_send_is_a_snapshot_taken_at_posting(world2):
    """A send posted by p2p_start and overwritten before its wait, its
    peer's receive posted late: the bytes that arrive are the posted
    ones, not the overwrite."""
    assert world2["p2p_snapshot"] is True


@pytest.mark.parametrize("name", ["copy_to_tp", "reduce_from_tp",
                                  "scatter_to_sp", "gather_from_sp",
                                  "reduce_scatter_to_sp", "identity_at_tp1"])
def test_mapping_forward_and_backward_at_tp2(world2, name):
    assert world2["mappings"][name] < 1e-6


def test_comm_branches_gloo_and_native(world2):
    out = world2["comm"]
    assert out.pop("routes_gloo") is True
    assert any(k.startswith("reduce_scatter_gloo") for k in out)
    for k, v in out.items():
        assert v < 1e-6, k


@pytest.mark.parametrize("variant", ["ls0.0_z0.0", "ls0.1_z0.001"])
def test_vocab_parallel_cross_entropy_matches_plain(world2, variant):
    assert world2["cross_entropy"][variant] < 1e-5


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_two_rank_training_equals_the_single_process_step(world2, name):
    W.check_against_single_process(world2[name], TRAIN_CASES[name])


def test_pp2_dropout_equals_the_jax_pipeline(world2):
    """pp2 with hidden and attention dropout 0.1 and the LIMA ramp, fed
    the JAX package's masks along the JAX pipeline's key paths (which
    differ from its one-device paths at the embedding): the two steps'
    losses within 1e-4 and grad norms within 1e-4 relative of the JAX
    jitted step through make_pipeline_loss_fn."""
    got, want = world2["pp2_dropout"], world2["jax_pp2_dropout"]
    assert got["ranks_agree"]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-4)


def test_live_profile_window_holds_the_tp2_sp_contract(world2):
    """The port's counterpart of the JAX live-capture tests: a real
    --profile window over two steps of the tp2 + SP loop (gloo), read by
    the port's trace reader, shows two train_step markers with the same
    comm.* calls each and, over the window, twice the train_tp2_sp
    manifest's counts."""
    from megatron_tpu_torch.analysis import contracts

    out = world2["live_contract"]
    want = {op: v["count"] for op, v in contracts.load_manifest(
        "train_tp2_sp")["comm"]["collectives"].items()}
    assert out["markers"] == 2
    assert out["per_step"][0] == out["per_step"][1]
    assert out["counts"] == {op: 2 * n for op, n in want.items()}
    for key in ("inferred", "given"):
        assert out[key]["matches"], out[key]["problems"]
        assert out[key]["executions"] == 2
