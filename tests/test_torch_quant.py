"""The port's compressed-collective units (megatron_tpu_torch/quant/)
against the JAX package's (megatron_tpu/quant/), in one process:

  * the primitives: int8 payloads and scales bitwise equal to JAX's on the
    same fp32 input, fp8 bytes bitwise equal to ml_dtypes' cast (JAX's),
    the dequantized values equal, the worst-case bound equal and holding
    elementwise on random and adversarial inputs;
  * the site policy: defaults, derivation from exposure, load and
    validation, as the JAX module's;
  * the plans: make_tp_comm / make_cp_comm refuse what JAX's refuse, and
    the byte models (forward_comm_bytes, cp_ring_comm_bytes,
    wire_bytes_per_call) give JAX's numbers on the same geometry.

The collectives themselves run on gloo ranks in
tests/test_torch_cp_serving.py and tests/test_torch_tp_serving.py.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from megatron_tpu.analysis.taxonomy import (
    wire_bytes_per_call as j_wire_bytes,
)
from megatron_tpu.config import ModelConfig as JModelConfig
from megatron_tpu.config import ParallelConfig as JParallel
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.quant import collectives as jc
from megatron_tpu.quant import policy as jpol
from megatron_tpu.quant import primitives as jp
from megatron_tpu_torch.config import ModelConfig, ParallelConfig
from megatron_tpu_torch.inference.engine import InferenceEngine
from megatron_tpu_torch.inference.speculative import SpecConfig
from megatron_tpu_torch.parallel.mesh import build_mesh
from megatron_tpu_torch.quant import collectives as qc
from megatron_tpu_torch.quant import policy as qpol
from megatron_tpu_torch.quant import primitives as qp
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry

QCFG = dict(num_layers=4, hidden_size=32, num_attention_heads=4,
            num_kv_heads=2, ffn_hidden_size=64, vocab_size=128,
            seq_length=32, params_dtype="float32")


def cfgs(**over):
    kw = dict(QCFG, **over)
    return JModelConfig(**kw).validate(), ModelConfig(**kw).validate()


def mesh(tp=1, cp=1):
    """A rank-0 view of a tp x cp serving mesh without a process group
    (plans and byte models only)."""
    return build_mesh(ParallelConfig(tensor_parallel=tp, context_parallel=cp),
                      world_size=tp * cp, rank=0)


def j_mesh(tp=1, cp=1):
    return j_build_mesh(JParallel(tensor_parallel=tp, context_parallel=cp),
                        devices=jax.devices()[:tp * cp]).mesh


def adversarial():
    rng = np.random.default_rng(0)
    yield rng.normal(size=(4, 3, 64)).astype(np.float32)
    x = rng.normal(size=(2, 64)).astype(np.float32)
    x[:, ::16] *= 1e4                      # one outlier a chunk
    yield x
    yield np.zeros((2, 32), np.float32)
    yield np.full((1, 16), -3.7e3, np.float32)
    yield np.linspace(-1e-6, 1e-6, 32, dtype=np.float32)[None]
    # ties at half a level and values in fp8's subnormal range
    s = np.float32(127.0) / np.float32(3.0)
    yield (np.arange(-64, 64, dtype=np.float32)[None] + 0.5) / s
    yield np.geomspace(1e-12, 1.0, 64, dtype=np.float32)[None] * np.where(
        np.arange(64) % 2, 1, -1).astype(np.float32)


def test_effective_chunk_equals_jax():
    for w in range(1, 70):
        for c in (1, 3, 8, 16, 32, 100):
            assert qp.effective_chunk(w, c) == jp.effective_chunk(w, c)
    with pytest.raises(ValueError):
        qp.effective_chunk(0, 8)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("chunk", [8, 32])
def test_primitives_bitwise_equal_jax(mode, chunk):
    """Payload bytes and scales bitwise equal to JAX's; fp8 also to
    ml_dtypes' round-to-nearest-even cast of x / scale; dequantized
    values equal."""
    for x in adversarial():
        c = qp.effective_chunk(x.shape[-1], chunk)
        jq, js = jp.quantize_chunked(jnp.asarray(x), c, mode)
        q, s = qp.quantize_chunked(torch.from_numpy(x), c, mode)
        want_bytes = np.asarray(jq).view(np.uint8)
        np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                      want_bytes)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        if mode == "fp8":
            scaled = (x.reshape(*x.shape[:-1], -1, c)
                      / np.asarray(js)[..., None]).astype(np.float32)
            np.testing.assert_array_equal(
                q.view(torch.uint8).numpy(),
                scaled.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
                .reshape(x.shape))
        np.testing.assert_array_equal(
            qp.dequantize_chunked(q, s).numpy(),
            np.asarray(jp.dequantize_chunked(jq, js)))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_error_bound_equals_jax_and_holds(mode):
    for x in adversarial():
        c = qp.effective_chunk(x.shape[-1], 8)
        xt = torch.from_numpy(x)
        bound = qp.quantization_error_bound(xt, c, mode).numpy()
        np.testing.assert_array_equal(bound, np.asarray(
            jp.quantization_error_bound(jnp.asarray(x), c, mode)))
        q, s = qp.quantize_chunked(xt, c, mode)
        err = np.abs(qp.dequantize_chunked(q, s).numpy() - x)
        assert (err <= bound + 1e-12).all()


def test_quantize_rejects_bad_mode_and_chunk():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        qp.quantize_chunked(x, 8, "int4")
    with pytest.raises(ValueError, match="does not divide"):
        qp.quantize_chunked(x, 3, "int8")
    with pytest.raises(ValueError, match="unknown quantization mode"):
        qp.quantization_error_bound(x, 8, "int4")
    assert qp.fp8_supported()


def test_wire_bytes_model_equals_jax():
    for prim in ("psum", "pmax", "all_gather", "all_to_all",
                 "psum_scatter", "reduce_scatter", "ppermute", "other"):
        for n in (0, 1, 2, 3, 4, 8):
            for payload in (0, 7, 1000, 4096):
                assert qc.wire_bytes_per_call(prim, payload, n) == \
                    j_wire_bytes(prim, payload, n)


def test_policy_defaults_derivation_and_load(tmp_path):
    assert qpol.SITE_COLLECTIVES == jpol.SITE_COLLECTIVES
    assert qpol.TP_SITES == jpol.TP_SITES and qpol.CP_SITES == jpol.CP_SITES
    assert (qpol.default_policy().to_dict()
            == jpol.default_policy().to_dict())
    for exposure in ({"all-reduce": 0.8, "all-gather": 0.1},
                     {"all-to-all": 0.5, "collective-permute": 0.1}, {},
                     {"collective-permute": 0.25}):
        for thr in (0.1, 0.25, 0.6):
            assert (qpol.policy_from_exposure(exposure, thr).to_dict()
                    == jpol.policy_from_exposure(exposure, thr).to_dict())
    p = tmp_path / "pol.json"
    p.write_text(json.dumps({"sites": {"logits": False},
                             "source": "trace:x", "threshold": 0.3}))
    assert (qpol.load_policy(str(p)).to_dict()
            == jpol.load_policy(str(p)).to_dict())
    assert not qpol.resolve_policy(str(p)).enabled("logits")
    for bad, match in (({"sites": {"logitz": True}},
                        "unknown collective site"),
                       ({"sites": {"logits": "yes"}}, "JSON boolean"),
                       ({"logits": True}, "'sites' mapping")):
        p.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=match):
            qpol.load_policy(str(p))
    with pytest.raises(TypeError):
        qpol.resolve_policy(42)
    assert not qpol.resolve_policy({"mlp_out": False}).enabled("mlp_out")


def test_make_tp_comm_refuses_what_jax_refuses():
    tp2 = mesh(tp=2)
    _, cfg = cfgs()
    assert qc.make_tp_comm(None, "int8") is None
    assert qc.make_tp_comm(tp2, "none") is None
    with pytest.raises(ValueError, match="must be one of"):
        qc.make_tp_comm(tp2, "int4")
    with pytest.warns(UserWarning, match="trivial tensor axis"):
        assert qc.make_tp_comm(mesh(), "int8") is None
    with pytest.raises(ValueError, match="vocab size.*logits"):
        qc.make_tp_comm(tp2, "int8", cfg=cfgs(vocab_size=127)[1])
    with pytest.raises(ValueError, match="MoE"):
        qc.make_tp_comm(tp2, "int8",
                        cfg=cfgs(num_experts=4, moe_top_k=2)[1])
    with pytest.raises(ValueError, match="comm chunk"):
        qc.make_tp_comm(tp2, "int8", chunk=0)
    tpc = qc.make_tp_comm(tp2, "int8", cfg=cfgs(vocab_size=127)[1],
                          policy={"logits": False, "cp_ring": True})
    assert tpc.sites == frozenset({"attn_out", "mlp_out"})
    with pytest.raises(ValueError, match="hidden size.*mlp_out"):
        qc.make_tp_comm(mesh(tp=3), "int8",
                        cfg=cfgs(ffn_hidden_size=48, vocab_size=129)[1],
                        policy={"attn_out": False, "logits": False})
    assert qc.make_tp_comm(tp2, "fp8", cfg=cfg).compresses()
    assert not qc.make_tp_comm(tp2, "dense", cfg=cfg).compresses()


def test_make_cp_comm_validation():
    cp4 = mesh(cp=4)
    _, cfg = cfgs()
    with pytest.raises(ValueError, match="geometry must be one of"):
        qc.make_cp_comm(cp4, "dense", cfg=cfg, geometry="3d")
    with pytest.raises(ValueError, match="subgroup .cp_head. >= 2"):
        qc.make_cp_comm(cp4, "dense", cfg=cfg, geometry="2d", subgroup=0)
    with pytest.raises(ValueError, match="does not divide"):
        qc.make_cp_comm(cp4, "dense", cfg=cfg, geometry="2d", subgroup=3)
    with pytest.raises(ValueError, match="head count"):
        qc.make_cp_comm(cp4, "dense", geometry="2d", subgroup=4,
                        cfg=cfgs(num_attention_heads=2, num_kv_heads=2)[1])
    with pytest.raises(ValueError, match="takes no subgroup"):
        qc.make_cp_comm(cp4, "dense", cfg=cfg, subgroup=2)
    two_d = qc.make_cp_comm(cp4, "dense", cfg=cfg, geometry="2d",
                            subgroup=2)
    assert two_d.seq_groups() == 2 and two_d.ring_hops() == 1
    flat = qc.make_cp_comm(cp4, "dense", cfg=cfg)
    assert flat.subgroup == 1 and flat.ring_hops() == 3
    assert qc.make_cp_comm(mesh(), "int8", cfg=cfg) is None
    assert qc.make_cp_comm(cp4, "none", cfg=cfg) is None
    gated = qc.make_cp_comm(mesh(cp=2), "int8", cfg=cfg,
                            policy={"cp_ring": False})
    assert not gated.compresses() and gated.wire_mode() == "dense"


TP_CASES = [("dense", None), ("int8", None), ("fp8", None),
            ("int8", {"logits": False}), ("fp8", {"attn_out": False}),
            ("int8", {"mlp_out": False, "logits": False})]


@pytest.mark.parametrize("mode,policy", TP_CASES)
def test_forward_comm_bytes_equal_jax(mode, policy):
    jcfg, cfg = cfgs()
    for tp in (2, 4):
        for chunk in (32, 12):
            jt = jc.make_tp_comm(j_mesh(tp=tp), mode, cfg=jcfg,
                                 policy=policy, chunk=chunk)
            tpc = qc.make_tp_comm(mesh(tp=tp), mode, cfg=cfg, policy=policy,
                                  chunk=chunk)
            assert tpc.sites == jt.sites
            for batch, seq in ((8, 1), (1, 32), (4, 7)):
                assert (qc.forward_comm_bytes(cfg, tpc, batch, seq)
                        == jc.forward_comm_bytes(jcfg, jt, batch, seq))
    assert qc.forward_comm_bytes(cfg, None, 8, 1) == {"dense": 0,
                                                      "compressed": 0}


CP_CASES = [(2, "dense", "ring", 0, None), (2, "int8", "ring", 0, None),
            (2, "fp8", "ring", 0, None),
            (2, "int8", "ring", 0, {"cp_ring": False}),
            (4, "dense", "ring", 0, None), (4, "dense", "2d", 2, None),
            (4, "int8", "2d", 2, None), (4, "int8", "2d", 2,
                                         {"cp_a2a": False})]


@pytest.mark.parametrize("cp,mode,geometry,subgroup,policy", CP_CASES)
def test_cp_ring_comm_bytes_equal_jax(cp, mode, geometry, subgroup, policy):
    jcfg, cfg = cfgs()
    jcp = jc.make_cp_comm(j_mesh(cp=cp), mode, cfg=jcfg, policy=policy,
                          geometry=geometry, subgroup=subgroup)
    cpc = qc.make_cp_comm(mesh(cp=cp), mode, cfg=cfg, policy=policy,
                          geometry=geometry, subgroup=subgroup)
    for name in ("compresses", "wire_mode", "a2a_compresses",
                 "a2a_wire_mode", "seq_groups", "ring_hops"):
        assert getattr(cpc, name)() == getattr(jcp, name)()
    for batch, seq in ((2, 1), (1, 8), (8, 1)):
        assert (qc.cp_ring_comm_bytes(cfg, cpc, batch, seq)
                == jc.cp_ring_comm_bytes(jcfg, jcp, batch, seq))


def test_engines_refuse_compression_with_speculation():
    """As the JAX engine: compress_collectives with speculative decoding
    is refused (at tp > 1 speculation is refused outright first)."""
    _, cfg = cfgs()
    with pytest.raises(ValueError, match="speculative"):
        InferenceEngine(cfg, {}, num_slots=2, max_seq_len=32, device="cpu",
                        metrics=MetricsRegistry(), mesh=mesh(tp=2),
                        channel=object(), cuda_graph=False,
                        compress_collectives="int8",
                        speculative=SpecConfig(k=2, drafter="ngram"))
