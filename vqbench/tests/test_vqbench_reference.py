"""The benchmark's plain reference (``vqbench/reference/vq_plain.py``) against
the program at tiny shapes on the CPU: ``MeshExecutor.run`` (the launcher's
executor; on the CPU every kernel is its plain version) and the reference
get the same inputs and round lengths and must agree on both traffic
mixes.  The control (the reference with its products in TF32) must fail
the cells' limits at a size the CPU holds."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from vqbench import check, generator, harness  # noqa: E402
from vqbench.reference import vq_plain  # noqa: E402

TINY = dict(kappa=16, d=8, points_per_worker=400, job_points=200, n_eval=40)


@pytest.fixture(autouse=True)
def _one_thread():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)


def _bench(cell: str, seed: int, **sizes):
    plan = generator.shrink(harness.load_cell(cell).plan, **{**TINY, **sizes})
    return harness.Bench(plan, seed, torch.device("cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
@pytest.mark.parametrize("cell", ["sift1m.sync_delta",
                                  "dbpedia3072.async_delta",
                                  "dbpedia3072.sync_delta"])
def test_reference_matches_the_mesh_executor(cell, seed):
    bench = _bench(cell, seed)
    for job in (0, 1):
        w, curve = bench.run_job(job)
        w_ref, c_ref = check.reference(bench.plan, bench.inputs, job)
        assert curve.shape == c_ref.shape
        torch.testing.assert_close(curve, c_ref, rtol=1e-6, atol=0.0)
        torch.testing.assert_close(w, w_ref, rtol=1e-6, atol=1e-7)
        numbers = check.compare(bench.plan, bench.inputs, job, (w, curve),
                                (w_ref, c_ref))
        for name in check.NUMBERS + check.WIDEST:
            assert numbers[name] <= 1e-6, (name, numbers)


@pytest.mark.parametrize("cell", ["sift1m.sync_delta",
                                  "dbpedia3072.async_delta"])
def test_reference_at_a_wider_shape(cell):
    bench = _bench(cell, 5, kappa=64, d=48, job_points=100,
                   points_per_worker=200, n_eval=60)
    w, curve = bench.run_job(1)
    w_ref, c_ref = check.reference(bench.plan, bench.inputs, 1)
    torch.testing.assert_close(curve, c_ref, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(w, w_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("precision", ["tf32", "tf32_steps"])
@pytest.mark.parametrize("cell", ["sift1m.sync_delta",
                                  "dbpedia3072.async_delta"])
def test_control_fails_the_cells_limits(cell, precision):
    """TF32 in the reference's products (in steps and eval, or in the steps
    alone), put in the program's place, reads over the cell's limits (at
    width 128 and kappa 512 on the CPU)."""
    bench = _bench(cell, 11, kappa=512, d=128, job_points=400,
                   points_per_worker=400, n_eval=200)
    ref = check.reference(bench.plan, bench.inputs, 0)
    control = check.reference(bench.plan, bench.inputs, 0, precision)
    numbers = check.combine([check.compare(bench.plan, bench.inputs, 0,
                                           control, ref)])
    limits = harness.load_cell(cell).cell["limits"]
    assert not check.judge(numbers, limits), numbers


def test_round_tf32_keeps_ten_mantissa_bits_nearest():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10 + 2**-12,
                      -3.14159265, 0.0, 1e-30], dtype=torch.float32)
    r = vq_plain.round_tf32(x)
    assert bool((r.view(torch.int32) & 0x1FFF == 0).all())
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert float(r[0]) == 1.0
    assert float(r[1]) == 1.0 + 2**-9
    assert float(r[2]) == 1.0 + 2**-10
    assert abs(float(r[3]) + 3.14159265) <= 3.14159265 * 2**-11


def test_completion_mask_marks_the_cumulative_ticks():
    lengths = torch.tensor([[10, 12, 10, 11], [15, 10, 10, 10]],
                           dtype=torch.int32)
    mask = vq_plain.completion_mask(lengths, 40)
    assert mask.shape == (40, 2)
    assert torch.nonzero(mask[:, 0]).flatten().tolist() == [10, 22, 32]
    assert torch.nonzero(mask[:, 1]).flatten().tolist() == [15, 25, 35]


def test_generator_draws_the_same_inputs_from_a_seed():
    plan = generator.shrink(harness.load_cell("dbpedia3072.async_delta").plan,
                            **TINY)
    a = generator.make_inputs(plan, 2**31 + 3, torch.device("cpu"))
    b = generator.make_inputs(plan, 2**31 + 3, torch.device("cpu"))
    c = generator.make_inputs(plan, 2**31 + 4, torch.device("cpu"))
    assert torch.equal(a.stream, b.stream)
    assert torch.equal(a.w0_rows, b.w0_rows)
    assert torch.equal(a.lengths, b.lengths)
    assert not torch.equal(a.stream, c.stream)
    assert a.stream.shape == c.stream.shape
    assert bool((a.lengths >= plan.tau).all())
    # a shard's starting codebook: kappa distinct points of the stream
    for s in range(plan.shards):
        assert len(set(a.w0_rows[s].tolist())) == plan.kappa
