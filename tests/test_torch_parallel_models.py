"""More of the port's parallel training on 4 gloo processes (the CPU),
each case held to the port's single-process step as in
tests/test_torch_parallel_train.py (losses within 1e-4, grad norms
within a relative 1e-4, the same numbers on every rank, the final
parameters within 1e-5):

  * tp2 x pp2 with ZeRO-1 under selective and no recompute (the JAX
    matrix's recompute test, tests/_parallel_matrix_cases.py);
  * pure data parallelism over all 4 ranks with ZeRO-1;
  * a GPT-2-style model (biases, absolute positions, layernorm, GELU,
    tied embeddings) at tp2 with sequence parallelism, where the
    leaves tensor parallelism leaves whole (norms, row-parallel biases,
    embed/pos) take their gradient sums over the tensor group, and at
    tp2 x pp2, where the tied embedding's two copies (first and last
    stage) take theirs over the embedding group.

Four ranks (dp 2 at tp2, 1 at tp2 x pp2) keep the spawn light; the
8-rank topologies are tests/test_torch_parallel_train.py's.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import pytest

import _torch_parallel_worker as W

TP2_PP2 = dict(tensor_parallel=2, pipeline_parallel=2)
CASES = {
    "tp2_pp2_zero1_selective": dict(parallel=TP2_PP2, zero1=True,
                                    recompute="selective"),
    "tp2_pp2_zero1_none": dict(parallel=TP2_PP2, zero1=True,
                               recompute="none"),
    "dp4_zero1": dict(parallel={}, zero1=True),
    "gpt2_tp2_sp": dict(parallel=dict(tensor_parallel=2,
                                      sequence_parallel=True),
                        model=W.GPT2_MODEL),
    "gpt2_tp2_pp2_tied": dict(parallel=TP2_PP2, model=W.GPT2_MODEL),
}


@pytest.fixture(scope="module")
def results():
    return W.World(4, [(name, "train", case)
                       for name, case in CASES.items()]).results()


@pytest.mark.parametrize("name", list(CASES))
def test_parallel_steps_equal_the_single_process_step(results, name):
    W.check_against_single_process(results[name], CASES[name])
