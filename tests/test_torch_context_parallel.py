"""The port's context parallelism (megatron_tpu_torch/ops/ring_attention.py,
ops/ulysses.py, the dispatch in ops/attention.py and the loss, data and
gradient plumbing) held against the JAX package on the CPU.

* The one-process emulated ring (every virtual rank's schedule over the
  same stripes, the kernels' plain versions per stripe pair) against
  JAX's ring_attention_sharded on the fake 8-device mesh, with its flash
  inner in interpret mode and with its einsum ring: zig-zag causal, a
  window of 6, GQA, and the contiguous ring (S % 2cp != 0); values and
  gradients at tests/test_ring_attention.py's tolerances (values rtol
  2e-4 atol 2e-5, gradients rtol 5e-4 atol 5e-5).
* One spawn of 4 gloo ranks: the real ring (p2p around the context
  group, the zig-zag all-to-alls) and Ulysses against JAX's
  ring_attention_sharded / ulysses_attention_sharded, values and
  gradients at the same tolerances (Ulysses at tests/test_ulysses.py's
  2e-4); and the JAX matrix's tiny model trained two steps at cp2 with
  --attention_impl pallas, ring and ulysses, at cp4 with the ring and a
  window, and with fp8 products (hybrid) at tp2 x cp2 + SP, each equal
  to the one-process step at the parallel matrix's tolerances (losses
  1e-4, grad norms relative 1e-4, parameters 1e-5; the lr for the fp8
  case), and
  fp8_matmul's column- and row-parallel products at tp2 x cp2 against
  the whole product (each operand's amax reduced over its ranks; 1e-5).
* The pure pieces: the ring's schedule (uniform work, deltas), the
  zig-zag exchange plan, a rank's rows and piece of the sequence, the
  flags, and Ulysses' refusal of indivisible heads (the JAX message).
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cp_worker as CPW
import _torch_parallel_worker as W
from megatron_tpu.config import ParallelConfig as JParallel
from megatron_tpu.ops.ring_attention import ring_attention_sharded
from megatron_tpu.ops.ulysses import ulysses_attention_sharded
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu_torch import arguments
from megatron_tpu_torch.config import ParallelConfig
from megatron_tpu_torch.data.samplers import context_piece, rank_rows
from megatron_tpu_torch.ops import ring_attention as ra
from megatron_tpu_torch.ops.ulysses import check_heads
from megatron_tpu_torch.parallel.mesh import build_mesh

VAL_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def _jax_ref(case, inner=None):
    """JAX's sharded scheme on the fake mesh: (out, dq, dk, dv) of
    sum(out * g)."""
    q, k, v, g = (jnp.asarray(a) for a in CPW.qkv(case))
    rt = j_build_mesh(JParallel(context_parallel=case["cp"]))
    kw = dict(mask_type=case.get("mask", "causal"),
              sliding_window=case.get("window"))
    if case["impl"] == "ring":
        def fn(q, k, v):
            return ring_attention_sharded(q, k, v, rt.mesh, inner_impl=inner,
                                          **kw)
    else:
        def fn(q, k, v):
            return ulysses_attention_sharded(q, k, v, rt.mesh, **kw)

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * g), out

    with jax.sharding.set_mesh(rt.mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _check(got, want, val_tol=VAL_TOL, grad_tol=GRAD_TOL):
    np.testing.assert_allclose(got[0], want[0], **val_tol)
    for name, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **grad_tol)


# ---------------------------------------------------------------------------
# the emulated ring against the JAX rings
# ---------------------------------------------------------------------------

EMULATED = {
    "zigzag_cp2": dict(cp=2, s=32, hq=4, hkv=2, inner="flash"),
    "zigzag_cp4": dict(cp=4, s=32, hq=4, hkv=2, inner="flash"),
    "zigzag_cp4_window6": dict(cp=4, s=32, hq=2, hkv=1, window=6,
                               inner="flash"),
    "zigzag_cp4_window6_einsum": dict(cp=4, s=32, hq=4, hkv=2, window=6,
                                      inner="einsum"),
    "zigzag_cp2_gqa4_einsum": dict(cp=2, s=32, hq=8, hkv=2,
                                   inner="einsum"),
    "contiguous_cp4": dict(cp=4, s=36, hq=4, hkv=2, inner="flash"),
    "contiguous_cp2_einsum": dict(cp=2, s=30, hq=4, hkv=2, inner="einsum"),
}


@pytest.mark.parametrize("name", list(EMULATED))
def test_emulated_ring_matches_the_jax_ring(name):
    case = dict(EMULATED[name], b=2, d=16, impl="ring")
    want = _jax_ref(case, inner=case["inner"])
    q, k, v, g = (torch.from_numpy(a) for a in CPW.qkv(case))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ra.ring_attention_emulated(q, k, v, case["cp"],
                                     sliding_window=case.get("window"))
    out.backward(g)
    _check([t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)],
           want)


# ---------------------------------------------------------------------------
# the real schemes and the model on 4 gloo ranks
# ---------------------------------------------------------------------------

RANKS = {
    "ring_cp2_gqa": dict(cp=2, s=32, hq=4, hkv=2, impl="ring"),
    "ring_cp4_window6": dict(cp=4, s=32, hq=2, hkv=1, window=6,
                             impl="ring"),
    "ring_cp4_contiguous": dict(cp=4, s=36, hq=4, hkv=2, impl="ring"),
    "ring_cp2_bidirectional": dict(cp=2, s=32, hq=4, hkv=2, impl="ring",
                                   mask="bidirectional"),
    "ulysses_cp2_window8": dict(cp=2, s=32, hq=8, hkv=4, window=8,
                                impl="ulysses"),
    "ulysses_cp4": dict(cp=4, s=32, hq=8, hkv=4, impl="ulysses"),
}
RANKS = {k: dict(v, b=2, d=16) for k, v in RANKS.items()}
TRAIN = {
    f"cp2_{impl}": dict(parallel=dict(context_parallel=2),
                        model=dict(W.MATRIX_MODEL, attention_impl=impl))
    for impl in ("pallas", "ring", "ulysses")}
TRAIN["cp4_ring_window6_zero1"] = dict(
    parallel=dict(context_parallel=4), zero1=True,
    model=dict(W.MATRIX_MODEL, attention_impl="ring", sliding_window_size=6))
# fp8 products at tp2 x cp2 + SP: each amax max-reduced over the ranks
# that shard its operand gives the one-process scales (fp8_job holds the
# products themselves). Parameters within the lr, 1e-3 (1e-4 measured on
# 2 of 2048 elements): a row-parallel sum in another order can round an
# element to the other side of an fp8 step, and Adam's normalized step
# turns a gradient that differs near zero into up to lr of movement
TRAIN["tp2_cp2_sp_ring_fp8_hybrid"] = dict(
    parallel=dict(tensor_parallel=2, context_parallel=2,
                  sequence_parallel=True), params_atol=1e-3,
    model=dict(W.MATRIX_MODEL, attention_impl="ring", fp8_format="hybrid"))


@pytest.fixture(scope="module")
def ranks():
    world = W.World(4, [("attention", "call",
                         ("_torch_cp_worker:attention_job",
                          {"cases": RANKS})),
                        ("fp8", "call", ("_torch_cp_worker:fp8_job", {}))]
                    + [(name, "train", case) for name, case in TRAIN.items()])
    want = {name: _jax_ref(case, inner="einsum") for name, case in
            RANKS.items()}          # compiles while the ranks run
    return world.results(), want


@pytest.mark.parametrize("name", list(RANKS))
def test_real_ring_and_ulysses_match_jax(ranks, name):
    got, want = ranks[0]["attention"][name], ranks[1][name]
    if RANKS[name]["impl"] == "ulysses":
        tol = dict(rtol=2e-4, atol=2e-4)
        _check(got, want, tol, tol)
    else:
        _check(got, want)


@pytest.mark.parametrize("name", list(TRAIN))
def test_cp_training_equals_the_single_process_step(ranks, name):
    W.check_against_single_process(ranks[0][name], TRAIN[name])


def test_fp8_products_agree_their_scales_across_tp2_cp2(ranks):
    for rank, errs in enumerate(ranks[0]["fp8"]):
        for kind, err in errs.items():
            assert err <= 1e-5, (rank, kind, err)


# ---------------------------------------------------------------------------
# the pure pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cp", [2, 3, 4])
def test_zigzag_schedule_is_uniform_and_causal(cp):
    """Every rank runs 2cp + 1 stripe pairs over its ring (the zig-zag
    balance), every delta is >= 0, and the live pairs cover each causal
    (query stripe, key stripe) pair exactly once."""
    c = 8
    seen = set()
    for my in range(cp):
        hops = ra.ring_schedule(my, cp, c, None, zigzag=True)
        assert [src for src, _ in hops] == [(my - r) % cp for r in range(cp)]
        live = [(src, p) for src, pairs in hops for p in pairs if p.live]
        assert len(live) == 2 * cp + 1
        mine = (my, 2 * cp - 1 - my)
        for src, p in live:
            theirs = (src, 2 * cp - 1 - src)
            qs, ks = mine[p.q_part], theirs[p.k_part]
            assert p.delta == (qs - ks) * c >= 0
            seen.add((qs, ks))
    assert seen == {(a, b) for a in range(2 * cp) for b in range(a + 1)}


def test_window_prunes_the_ring():
    """A window of one stripe leaves each query stripe its own and the
    one before: the far hops run nothing."""
    cp, c = 4, 8
    for my in range(cp):
        hops = ra.ring_schedule(my, cp, c, c, zigzag=True)
        live = sum(p.live for _, pairs in hops for p in pairs)
        assert live <= 4


@pytest.mark.parametrize("cp", [2, 3, 4])
def test_restripe_plan_deals_the_zigzag_stripes(cp):
    """Playing the all-to-all of restripe_plan: each rank ends up with
    stripes (r, 2cp-1-r), and the inverse plan brings back (2r, 2r+1)."""
    def play(held, to_zigzag):
        plans = ra.restripe_plan(cp, to_zigzag)
        inbox = [[] for _ in range(cp)]
        for r, (send, counts, _, _) in enumerate(plans):
            rows = [held[r][i] for i in send]
            for j in range(cp):
                inbox[j].append(rows[:counts[j]])
                rows = rows[counts[j]:]
        out = []
        for r, (_, _, recv, order) in enumerate(plans):
            got = [s for src in range(cp) for s in inbox[r][src]]
            assert [len(inbox[r][src]) for src in range(cp)] == recv
            out.append([got[i] for i in order])
        return out

    zig = play([[2 * r, 2 * r + 1] for r in range(cp)], True)
    assert zig == [[r, 2 * cp - 1 - r] for r in range(cp)]
    assert play(zig, False) == [[2 * r, 2 * r + 1] for r in range(cp)]


def test_rank_rows_give_each_context_rank_its_piece():
    """dp2 x cp2 x tp2 (8 ranks, no process group): a rank's rows are its
    batch rank's block of each microbatch, the same on both context
    ranks, and its columns its contiguous piece of the sequence."""
    par = ParallelConfig(context_parallel=2, tensor_parallel=2,
                         sequence_parallel=True)
    batch = {"tokens": np.arange(4 * 8).reshape(4, 8),
             "position_ids": np.tile(np.arange(8), (4, 1))}
    for rank in range(8):
        mesh = build_mesh(par, world_size=8, rank=rank)
        got = next(rank_rows(iter([batch]), mesh, micro_batch=1))
        c, d = mesh.cp_rank, mesh.dp_rank
        rows = [d, 2 + d]                       # microbatches of 2 rows
        np.testing.assert_array_equal(
            got["tokens"], batch["tokens"][rows][:, 4 * c:4 * c + 4])
        np.testing.assert_array_equal(got["position_ids"][0],
                                      np.arange(4 * c, 4 * c + 4))
    one = build_mesh(ParallelConfig(), world_size=1, rank=0)
    assert context_piece(batch, one) is batch


@pytest.mark.parametrize("impl", ["xla", "pallas", "ring", "ulysses"])
def test_cp_flags_reach_the_parallel_config(impl):
    args = arguments.parse_args(
        ["--model_name", "tiny", "--seq_length", "64",
         "--context_parallel_size", "2", "--attention_impl", impl])
    cfg = arguments.args_to_run_config(args)
    assert cfg.parallel.context_parallel == 2
    assert cfg.model.attention_impl == impl


def test_uneven_sequence_is_refused():
    args = arguments.parse_args(
        ["--model_name", "tiny", "--seq_length", "66",
         "--context_parallel_size", "4"])
    with pytest.raises(ValueError, match="must divide the sequence"):
        arguments.args_to_run_config(args)


def test_ulysses_refuses_indivisible_heads_as_jax():
    """cp must divide both head counts; the port raises the JAX
    package's message before any exchange."""
    case = dict(cp=4, s=32, hq=6, hkv=2, b=1, d=8, impl="ulysses")
    with pytest.raises(ValueError) as want:
        _jax_ref(case)
    with pytest.raises(ValueError) as got:
        check_heads(6, 2, 4)
    assert str(got.value) == str(want.value)
    check_heads(8, 4, 4)
