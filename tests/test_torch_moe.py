"""The port's MoE layer and Mixtral vs the JAX package, on the CPU in fp32.

The single-device cases of tests/test_moe.py, each on the port and, where
the JAX function computes the same thing, held against it on the same
numpy inputs: topk_dispatch's slots, weights and overflow drops; one
expert equals the dense MLP; the block against HF's MixtralSparseMoeBlock
(random init, built in code); lm_loss with its router aux loss and every
gradient leaf of a 2-layer Mixtral-shaped model against the JAX lm_loss;
training learns; dropless against capacity at ample capacity and keeping
the tokens the capacity path drops; the group-size rule, grouping and
per-group capacity; the capacity formula; the CLI knobs; generation
against teacher forcing on both engines; lm_forward against a random
MixtralForCausalLM; mixtral HF -> native -> HF; the MoE drift keys of a
checkpoint; and the refusals (expert parallelism, MoE above world size 1,
return_moe_aux with caches). Tolerances are stated per test: 1e-4 on
losses and logits through two fp32 layers (the frameworks sum in
different orders), 1e-5 on gradients, as tests/test_torch_train.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.language_model import lm_loss as j_lm_loss
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.ops import moe as jmoe
from megatron_tpu_torch import arguments
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.language_model import lm_forward, lm_loss
from megatron_tpu_torch.models.params import (
    check_mesh, init_params, num_params, param_shapes, params_from_numpy,
)
from megatron_tpu_torch.models.transformer import mlp_block
from megatron_tpu_torch.ops import moe
from megatron_tpu_torch.training import optimizer as topt

KW = dict(vocab_size=96, seq_length=16, hidden_size=32,
          num_attention_heads=4, num_kv_heads=2, ffn_hidden_size=48,
          num_experts=4, moe_top_k=2, moe_capacity_factor=2.0,
          params_dtype="float32")


def _cfgs(**kw):
    """(JAX cfg, port cfg) of the JAX tests' _moe_cfg."""
    base = dict(KW, **kw)
    return (j_presets.tiny(**base),
            presets.tiny(**base, attention_impl="pallas"))


def _layer0(tree):
    return {k: (_layer0(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


def _models(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_topk_dispatch_slots_and_weights():
    gates = np.asarray([[0.7, 0.2, 0.1],
                        [0.6, 0.3, 0.1],
                        [0.1, 0.8, 0.1]], np.float32)
    combine, dispatch, top1 = moe.topk_dispatch(_t(gates), top_k=1,
                                                capacity=2, renorm=True)
    assert combine[0, 0, 0] == pytest.approx(1.0)
    assert combine[1, 0, 1] == pytest.approx(1.0)
    assert combine[2, 1, 0] == pytest.approx(1.0)
    np.testing.assert_array_equal(top1.numpy().argmax(1), [0, 0, 1])
    assert dispatch.sum(0).max() <= 1
    # random gates, top-2 with overflow: the JAX tensors exactly
    g = torch.softmax(torch.from_numpy(np.random.default_rng(0).normal(
        size=(24, 4)).astype(np.float32)), -1)
    for renorm in (True, False):
        got = moe.topk_dispatch(g, 2, 5, renorm)
        want = jmoe.topk_dispatch(jnp.asarray(g.numpy()), 2, 5, renorm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-6, atol=1e-7)


def test_topk_dispatch_capacity_overflow_drops():
    gates = _t(np.asarray([[0.9, 0.1], [0.8, 0.2], [0.7, 0.3]], np.float32))
    combine, dispatch, _ = moe.topk_dispatch(gates, top_k=1, capacity=2,
                                             renorm=False)
    assert dispatch[2].sum() == 0 and combine[2].sum() == 0
    assert combine[0, 0, 0] == pytest.approx(0.9)


def test_single_expert_matches_dense_mlp():
    """E=1 top-1 at ample capacity is the dense MLP (atol 1e-6)."""
    _, cfg = _cfgs(num_experts=1, moe_top_k=1, moe_capacity_factor=4.0)
    _, dense = _cfgs(num_experts=None)
    r = np.random.default_rng(0)
    w_in = torch.from_numpy(r.normal(0, 0.02, (32, 2 * cfg.ffn_size))
                            .astype(np.float32))
    w_out = torch.from_numpy(r.normal(0, 0.02, (cfg.ffn_size, 32))
                             .astype(np.float32))
    x = torch.from_numpy(r.normal(0, 1, (2, 16, 32)).astype(np.float32))
    y, aux = moe.moe_block(cfg, {"router": torch.zeros(32, 1),
                                 "w_in": w_in[None], "w_out": w_out[None]},
                           x)
    want = mlp_block(dense, {"w_in": w_in, "w_out": w_out}, x)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    assert float(aux) == pytest.approx(cfg.moe_aux_loss_coeff, rel=1e-5)


@pytest.mark.parametrize("dispatch", ["capacity", "dropless"])
@pytest.mark.parametrize("kw", [
    dict(),                                                # ample
    dict(moe_capacity_factor=0.5),                         # overflow drops
    dict(moe_capacity_factor=1.0, moe_group_size=4),       # per group
    dict(moe_top_k=1, moe_renorm_gates=False, moe_z_loss_coeff=1e-3),
])
def test_moe_block_matches_jax(dispatch, kw):
    """The block's output and aux loss against the JAX block on the same
    layer weights and input, forward and gradients (atol 1e-5): the
    gather form of the capacity path keeps the einsum form's slots."""
    jcfg, jparams, tcfg, tparams = _models(seed=5, moe_dispatch=dispatch,
                                           **kw)
    jp = _layer0(jax.device_get(jparams["layers"]["moe"]))
    tp = {k: v.requires_grad_(True) for k, v in
          _layer0(tparams["layers"]["moe"]).items()}
    x = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(
        np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_block(jcfg, p, x)
        return jnp.sum(jnp.square(y)) + aux, (y, aux)

    (jl, (jy, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = moe.moe_block(tcfg, tp, tx)
    ((ty ** 2).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=1e-5, rtol=1e-4)
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_moe_block_matches_hf_mixtral():
    """Against HF's dropless MixtralSparseMoeBlock at ample capacity, on
    both dispatch paths (rtol 2e-4, atol 2e-5, as the JAX test)."""
    from transformers.models.mixtral.configuration_mixtral import (
        MixtralConfig,
    )
    from transformers.models.mixtral.modeling_mixtral import (
        MixtralSparseMoeBlock,
    )

    E, H, F, k = 4, 32, 48, 2
    torch.manual_seed(0)
    hf = MixtralSparseMoeBlock(MixtralConfig(
        hidden_size=H, intermediate_size=F, num_local_experts=E,
        num_experts_per_tok=k)).eval()
    p = {"router": hf.gate.weight.detach().t(),
         "w_in": torch.stack([torch.cat([ex.w1.weight.t(), ex.w3.weight.t()],
                                        -1) for ex in hf.experts]).detach(),
         "w_out": torch.stack([ex.w2.weight.t()
                               for ex in hf.experts]).detach()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 16, H)).astype(np.float32))
    with torch.no_grad():
        want = hf(x)[0]
        for dispatch in ("capacity", "dropless"):
            _, cfg = _cfgs(num_experts=E, moe_top_k=k, ffn_hidden_size=F,
                           moe_capacity_factor=float(E),
                           moe_dispatch=dispatch)
            y, _ = moe.moe_block(cfg, p, x)
            torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-5)


def test_moe_dropless_matches_capacity_at_ample_capacity():
    """Ample capacity drops nothing, so both paths give the same output,
    aux loss and gradients (rtol 5e-4, atol 5e-6: summation orders)."""
    _, cap = _cfgs(moe_capacity_factor=8.0)
    drop = dataclasses.replace(cap, moe_dispatch="dropless")
    tparams = init_params(cap, 5, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, 32)).astype(np.float32))
    outs = []
    for cfg in (cap, drop):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in
             _layer0(tparams["layers"]["moe"]).items()}
        y, aux = moe.moe_block(cfg, p, x)
        ((y ** 2).sum() + aux).backward()
        outs.append((y.detach(), aux.detach(), {k: v.grad for k, v in
                                                p.items()}))
    (y0, a0, g0), (y1, a1, g1) = outs
    torch.testing.assert_close(y1, y0, rtol=2e-5, atol=2e-6)
    assert float(a1) == pytest.approx(float(a0), rel=1e-5)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=5e-4, atol=5e-6)


def test_moe_dropless_keeps_overflow_tokens():
    _, cap = _cfgs(num_experts=2, moe_top_k=1, moe_capacity_factor=0.25,
                   moe_renorm_gates=False)
    drop = dataclasses.replace(cap, moe_dispatch="dropless")
    p = _layer0(init_params(cap, 5, device="cpu")["layers"]["moe"])
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 16, 32)).astype(np.float32))
    y_cap, _ = moe.moe_block(cap, p, x)
    y_drop, _ = moe.moe_block(drop, p, x)
    cap_zero = (y_cap[0].abs() <= 1e-7).all(-1)
    assert cap_zero.sum() > 0, "the case needs overflow drops"
    assert not (y_drop[0].abs() <= 1e-7).all(-1).any()
    kept = ~cap_zero
    torch.testing.assert_close(y_drop[0][kept], y_cap[0][kept], rtol=2e-5,
                               atol=2e-6)


# ---------------------------------------------------------------------------
# groups and capacity
# ---------------------------------------------------------------------------


def test_moe_group_size_rule():
    def gs(**kw):
        return moe.moe_group_size(_cfgs(**kw)[1])

    assert gs(seq_length=16) == 16
    assert gs(seq_length=8192) == 2048
    assert gs(seq_length=3000) == 1500
    assert gs(seq_length=16, moe_group_size=8) == 8
    with pytest.raises(ValueError, match="moe_group_size"):
        _cfgs(seq_length=16, moe_group_size=6)
    assert gs(seq_length=2053) == 2053
    assert moe._group_for(2500, 2048) == 1250
    for s, t in ((2500, 2048), (2053, 2048), (1, 2048), (4096, 512)):
        assert moe._group_for(s, t) == jmoe._group_for(s, t)


def test_moe_grouped_matches_whole_batch_with_ample_capacity():
    _, small = _cfgs(moe_capacity_factor=4.0, moe_group_size=4)
    row = dataclasses.replace(small, moe_group_size=16)
    p = _layer0(init_params(small, 0, device="cpu")["layers"]["moe"])
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 16, 32)).astype(np.float32))
    y_small, aux_small = moe.moe_block(small, p, x)
    y_row, aux_row = moe.moe_block(row, p, x)
    torch.testing.assert_close(y_small, y_row, rtol=1e-5, atol=1e-6)
    assert float(aux_small) == pytest.approx(float(aux_row), rel=1e-6)


def test_moe_capacity_is_per_group():
    _, cfg = _cfgs(num_experts=2, moe_top_k=1, moe_capacity_factor=0.51,
                   moe_group_size=4, seq_length=8, hidden_size=4,
                   vocab_size=32, num_attention_heads=2, num_kv_heads=1)
    p = {"router": torch.tensor([[5.0, -5.0]] * 4),
         "w_in": torch.full((2, 4, 2 * cfg.ffn_size), 0.1),
         "w_out": torch.full((2, cfg.ffn_size, 4), 0.1)}
    y, _ = moe.moe_block(cfg, p, torch.ones(1, 8, 4))
    kept = (y[0].abs().sum(1) > 0).tolist()
    assert kept == [True, True, False, False, True, True, False, False]


def test_moe_capacity_formula_and_decode_groups():
    """The formula, and the S = 1 decode call: groups of one token,
    C = top_k, no drop (the runtime S picks Sg)."""
    for kw, n, want in ((dict(moe_capacity_factor=1.0), 64, 32),
                        (dict(moe_capacity_factor=0.01), 64, 2),
                        (dict(num_experts=3, moe_top_k=1,
                              moe_capacity_factor=1.0), 100, 34)):
        jcfg, tcfg = _cfgs(**kw)
        assert moe.moe_capacity(tcfg, n) == jmoe.moe_capacity(jcfg, n) \
            == want
    _, cfg = _cfgs(moe_capacity_factor=1.25, seq_length=8192)
    assert moe._group_for(1, moe.moe_group_size(cfg)) == 1
    assert moe.moe_capacity(cfg, 1) == cfg.moe_top_k


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["capacity", "dropless"])
def test_mixtral_lm_loss_and_grads_match_jax(dispatch):
    """A 2-layer Mixtral-shaped model (GQA, 4 experts, top-2): lm_loss with
    its aux loss, and every gradient leaf, against the JAX lm_loss (loss
    atol 1e-4, grads atol 1e-5)."""
    jcfg, jparams, tcfg, _ = _models(moe_dispatch=dispatch,
                                     rope_theta=1e6)
    r = np.random.default_rng(1)
    text = r.integers(0, 96, size=(2, 17))
    batch = {"tokens": text[:, :-1], "labels": text[:, 1:],
             "loss_mask": (r.random((2, 16)) > 0.2).astype(np.float32)}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: j_lm_loss(jcfg, p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(jparams)
    params = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    for _, leaf in topt.leaf_paths(params):
        leaf.requires_grad_(True)
    tl, aux = lm_loss(tcfg, params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-4)
    np.testing.assert_allclose(float(aux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), rtol=1e-5)
    assert float(tl) == pytest.approx(
        float(aux["lm_loss"]) + float(aux["moe_aux_loss"]), rel=1e-6)
    tg = dict(topt.leaf_paths(topt.tree_map(lambda p: p.grad, params)))
    jgf = dict(topt.leaf_paths(jax.device_get(jg)))
    assert tg.keys() == jgf.keys()
    for k in tg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jgf[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    assert float(tg["layers/moe/router"].abs().sum()) > 0


def test_mixtral_preset_tree_and_flops_match_jax():
    jcfg, tcfg = j_presets.mixtral(), presets.from_model_name("mixtral-8x7B")
    for f in ("num_experts", "moe_top_k", "moe_renorm_gates", "rope_theta",
              "moe_capacity_factor", "moe_group_size", "moe_dispatch",
              "sliding_window_size", "n_kv_heads", "ffn_size"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.flops_per_token_fwd() == jcfg.flops_per_token_fwd()
    assert tcfg.flops_per_token_fwd(1000) == jcfg.flops_per_token_fwd(1000)
    from megatron_tpu.models.params import num_params as j_num_params
    from megatron_tpu.models.params import param_shapes as j_param_shapes
    assert num_params(tcfg) == j_num_params(jcfg)
    want = dict(topt.leaf_paths(j_param_shapes(dataclasses.replace(
        jcfg, num_layers=2))))
    got = param_shapes(dataclasses.replace(tcfg, num_layers=2))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    # the ModelConfig MoE fields carry the JAX names and defaults
    from megatron_tpu.config import ModelConfig as JModelConfig
    from megatron_tpu_torch.config import ModelConfig
    jd = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    for f in dataclasses.fields(ModelConfig):
        if f.name.startswith(("moe_", "num_experts")):
            assert f.default == jd[f.name], f.name


def test_moe_training_learns():
    """30 Adam steps at lr 5e-3 on one batch take the loss below 0.7 x its
    start (the JAX test's gate), through make_train_step, whose metrics
    carry the router's moe_aux_loss."""
    from megatron_tpu_torch.config import OptimizerConfig, TrainingConfig
    from megatron_tpu_torch.training.train_step import make_train_step

    _, cfg = _cfgs()
    opt = OptimizerConfig(lr=5e-3, lr_decay_style="constant")
    tcfg = TrainingConfig(micro_batch_size=4, global_batch_size=4, seed=0)
    params = init_params(cfg, 0, device="cpu")
    for _, leaf in topt.leaf_paths(params):
        leaf.requires_grad_(True)
    state = topt.init_train_state(opt, params)
    step = make_train_step(cfg, opt, tcfg, num_microbatches=1,
                           train_iters=50)
    toks = np.random.default_rng(0).integers(0, 96, (4, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.ones(4, 16)}
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        assert float(metrics["moe_aux_loss"]) > 0
    assert losses[-1] < losses[0] * 0.7


def test_moe_cli_knobs_override_preset_and_refusals():
    base = ["--model_name", "mixtral", "--micro_batch_size", "1",
            "--global_batch_size", "1"]

    def model(extra=()):
        return arguments.args_to_run_config(
            arguments.parse_args(base + list(extra))).model

    m = model()
    assert (m.num_experts, m.moe_top_k, m.rope_theta) == (8, 2, 1e6)
    m = model(["--moe_aux_loss_coeff", "0.0", "--no_moe_renorm_gates",
               "--moe_dispatch", "dropless"])
    assert m.moe_aux_loss_coeff == 0.0 and m.moe_renorm_gates is False
    assert m.moe_dispatch == "dropless" and m.num_experts == 8
    with pytest.raises(ValueError, match="7b"):
        model(["--expert_model_parallel_size", "2"])
    # MoE above world size 1: the aux loss needs global statistics
    with pytest.raises(ValueError, match="world size 2"):
        check_mesh(_cfgs()[1], types.SimpleNamespace(world_size=2))


def test_return_moe_aux_with_caches_is_refused():
    _, cfg = _cfgs()
    params = init_params(cfg, 0, device="cpu")
    caches = tuple(torch.zeros(2, 1, 8, 2, 8) for _ in range(2))
    with pytest.raises(ValueError, match="ambiguous"):
        lm_forward(cfg, params, torch.zeros(1, 1, dtype=torch.long),
                   kv_caches=caches, cache_index=0, return_moe_aux=True)


@pytest.mark.parametrize("paged", [False, True])
def test_moe_generation_matches_teacher_forcing(paged):
    """Greedy tokens from the engine (dense slots or paged pools; S = 1
    decode groups) equal the argmax of full teacher-forced forwards, as
    the JAX test holds its generate_tokens."""
    from megatron_tpu_torch.inference.engine import InferenceEngine
    from megatron_tpu_torch.inference.paging import PagedInferenceEngine
    from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

    _, cfg = _cfgs(seq_length=32)
    params = init_params(cfg, 2, device="cpu")
    # a registry of its own: the process-wide one is read by other tests
    kw = dict(vocab_size=96, device="cpu", metrics=MetricsRegistry())
    if paged:
        eng = PagedInferenceEngine(cfg, params, num_slots=2, max_seq_len=32,
                                   page_size=8, prefill_chunk=4, **kw)
    else:
        eng = InferenceEngine(cfg, params, num_slots=2, max_seq_len=32,
                              **kw)
    out = eng.generate(np.asarray([[5, 9, 11, 1], [7, 3, 2, 30]], np.int32),
                       np.asarray([4, 4], np.int32), max_new_tokens=5,
                       temperature=0.0, eod=-1)
    with torch.no_grad():
        for row in range(2):
            toks = np.asarray(out.tokens)[row]
            for t in range(4, 9):
                logits = lm_forward(cfg, params,
                                    torch.from_numpy(toks[None, :t]).long())
                assert int(logits[0, -1].argmax()) == toks[t]


def test_checkpoint_refuses_moe_drift():
    """A checkpoint saved with one moe_* value (or as a dense model) and
    resumed with another is refused, naming the key (the JAX drift keys,
    megatron_tpu/training/checkpointing.py:864-870)."""
    from megatron_tpu.training.checkpointing import DRIFT_KEYS as J_DRIFT
    from megatron_tpu_torch.training import checkpointing as ckpt

    assert set(J_DRIFT) <= set(ckpt.DRIFT_KEYS)
    _, cfg = _cfgs()
    saved = {"model": dataclasses.asdict(cfg)}
    ckpt.check_config_compatibility(saved, {"model": dataclasses.asdict(cfg)})
    for change in (dict(moe_top_k=1), dict(moe_dispatch="dropless"),
                   dict(moe_capacity_factor=1.0), dict(moe_group_size=8),
                   dict(moe_renorm_gates=False), dict(num_experts=None)):
        other = dataclasses.replace(cfg, **change)
        with pytest.raises(ValueError, match=next(iter(change))):
            ckpt.check_config_compatibility(
                saved, {"model": dataclasses.asdict(other)})


def test_pretrain_gpt_trains_moe_and_logs_the_aux_loss(tmp_path):
    """pretrain_gpt with --num_experts on the tiny preset, in process on
    the CPU: finite losses, each log line carrying the router's moe aux
    loss, which the step records keep too."""
    from megatron_tpu_torch.data.indexed_dataset import (
        MMapIndexedDatasetBuilder,
    )
    from megatron_tpu_torch.tools import pretrain_gpt

    prefix = str(tmp_path / "corpus")
    r = np.random.default_rng(0)
    b = MMapIndexedDatasetBuilder(prefix + ".bin", dtype=np.uint16)
    for _ in range(48):
        b.add_item(r.integers(1, 90, size=int(r.integers(10, 70))))
        b.end_document()
    b.finalize(prefix + ".idx")
    lines = []
    loop = pretrain_gpt.main(
        ["--model_name", "tiny", "--fp32", "--num_layers", "2",
         "--num_experts", "4", "--moe_top_k", "2", "--seq_length", "32",
         "--micro_batch_size", "2", "--global_batch_size", "4",
         "--train_iters", "3", "--log_interval", "1", "--eval_interval",
         "3", "--eval_iters", "1", "--lr", "1e-3", "--attention_impl",
         "pallas", "--data_path", prefix, "--split", "90,10,0",
         "--device", "cpu"], log=lines.append)
    assert loop.cfg.model.num_experts == 4
    steps = [ln for ln in lines if ln.startswith("iteration")]
    assert len(steps) == 3 and all("| moe aux loss: " in ln for ln in steps)
    aux = [h["moe_aux_loss"] for h in loop.history]
    assert all(np.isfinite(a) and a > 0 for a in aux)
    assert all(np.isfinite(h["lm_loss"]) for h in loop.history)


def test_dropless_tick_runs_eagerly_only_with_a_reason():
    """An engine captures a dropless MoE tick only where the grouped
    products keep their spans on the device (bf16 torch._grouped_mm);
    otherwise it names why it runs eagerly. Capacity and dense models
    always capture, and nothing swaps dropless for capacity."""
    from megatron_tpu_torch.inference.engine import _uncapturable

    _, cap = _cfgs()
    drop = dataclasses.replace(cap, moe_dispatch="dropless")
    bf16 = dataclasses.replace(drop, params_dtype="bfloat16")
    assert _uncapturable([cap]) is None
    assert _uncapturable([_cfgs(num_experts=None)[1]]) is None
    assert "dropless" in _uncapturable([drop])
    assert _uncapturable([cap, drop]) is not None
    assert (_uncapturable([bf16]) is None) == hasattr(torch, "_grouped_mm")
