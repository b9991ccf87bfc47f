"""The port's ``comm.sweep`` at the ``BENCH_hier.json`` and
``BENCH_adapt.json`` configurations: the byte figures those files record
are shape arithmetic, so the port's sweeps give them exactly on their own
numpy-made data.  The dynamic cells' bytes depend on the data through the
trigger count, so they are held to the merge and probe prices per window
(tests/test_torch_adapt.py holds them on the reference's own data).
"""

import json
from pathlib import Path

import pytest
import torch

from repro_torch.comm import sweep

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _bench(name):
    return [r for r in json.loads((REPO / name).read_text())["results"]
            if r.get("kind") == "cell"]


@pytest.fixture(scope="module")
def hier_cells():
    return sweep.run_hier_cells(n=200, device="cpu")


@pytest.mark.parametrize("variant", sweep.HIER_VARIANTS)
@pytest.mark.parametrize("scheme", sweep.SCHEMES)
def test_hier_cells_match_bench_hier_bytes(hier_cells, scheme, variant):
    want = next(c for c in _bench("BENCH_hier.json")
                if c["scheme"] == scheme and c["variant"] == variant)
    got = next(c for c in hier_cells
               if c["scheme"] == scheme and c["variant"] == variant)
    for key in ("hosts", "workers_per_host", "m", "n", "d", "kappa", "tau",
                "tier1_frac", "merge_wire_bytes", "tier0_wire_bytes",
                "tier1_wire_bytes"):
        assert got[key] == want[key], key
    if variant == "hier_dense":
        assert got["bitmatch_flat"] is True


def test_hier_summaries(hier_cells):
    # 10,240 / 640 dense over sparse tier-1 bytes (delta), 102,400 / 6,400
    # (eq. 9)
    assert sweep.hier_inter_reduction(hier_cells) == 16.0
    assert set(sweep.hier_wall_parity(hier_cells)) == set(sweep.SCHEMES)


def test_adapt_cells_match_bench_adapt_bytes():
    cells = sweep.run_adapt_cells(device="cpu")
    bench = _bench("BENCH_adapt.json")
    for got in cells:
        want = next(c for c in bench if c["merge"] == got["merge"]
                    and c["quant"] == got["quant"])
        for key in ("m", "n", "d", "kappa", "tau", "thresh", "max_stale",
                    "n_windows"):
            assert got[key] == want[key], key
        if got["merge"] == "fixed":
            for key in ("merge_wire_bytes", "probe_wire_bytes",
                        "total_wire_bytes", "n_triggered"):
                assert got[key] == want[key], key
        else:
            per_merge = want["merge_wire_bytes"] // want["n_triggered"]
            assert got["merge_wire_bytes"] == got["n_triggered"] * per_merge
            assert got["probe_wire_bytes"] == want["probe_wire_bytes"]
            assert 0 < got["n_triggered"] < got["n_windows"]
    assert sweep.adapt_dynamic_wire_ok(cells)
    assert sweep.adapt_bitmatch(device="cpu")


def test_fixed_tau_legs_and_comm_cells():
    legs = sweep.run_fixed_tau_legs(device="cpu")
    assert [leg["total_wire_bytes"] for leg in legs] == [
        leg["total_wire_bytes"] for leg in
        (c for c in json.loads((REPO / "BENCH_adapt.json").read_text())
         ["results"] if c.get("kind") == "fixed_leg")]
    assert sweep.best_fixed_leg(legs) in legs
    cells = sweep.run_comm_cells(n=200, device="cpu")
    comm = json.loads((REPO / "BENCH_comm.json").read_text())["results"]
    for got in cells:
        want = [c for c in comm if c.get("scheme") == got["scheme"]
                and c.get("transport") == got["transport"]
                and c.get("n") == got["n"]]
        assert want and got["merge_wire_bytes"] == want[0][
            "merge_wire_bytes"]
