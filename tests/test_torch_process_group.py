"""One worker a process: the port's process-group world, its group ring and
dense transports, and the group builders, held against the stacked
transports and the reference's device meshes.

One 4-rank gloo world (``process_group.spawn`` on a ``FileStore``, the
CPU) runs every collective once (``_torch_worlds.transports_and_groups``);
a second, of 2 ranks, fails on purpose.  Inputs are made with numpy from a
seed.  The group ring must equal ``ring_all_reduce_plain`` of the stacked
rows bit for bit (it keeps the chunking and the fold order); the group
``xla`` sum and mean the stacked ones at ``rtol=1e-6`` (gloo sums in its
own order); records field for field.  The rank layouts of
``Topology.make_groups`` must be the device grids of the reference's
``make_mesh`` for the same shapes.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_worlds as worlds
from repro.topology import Topology as JTopology
from repro_torch import comm
from repro_torch.comm import ring
from repro_torch.distributed import process_group
from repro_torch.topology import Topology, production_grid

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-6


def _inputs():
    rng = np.random.default_rng(24)
    f32 = np.float32
    return {"x1000": rng.standard_normal((4, 1000)).astype(f32),
            "x1280": rng.standard_normal((4, 1280)).astype(f32),
            "x3": rng.standard_normal((3, 1000)).astype(f32),
            "mask": np.array([1, 0, 1, 1], f32),
            "mask3": np.array([0, 1, 1], f32)}


@pytest.fixture(scope="module")
def world():
    xs = _inputs()
    return xs, process_group.spawn(worlds.transports_and_groups, 4, xs,
                                   device="cpu")


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("name", ["x1000", "x1280"])
@pytest.mark.parametrize("masked", [False, True])
def test_group_ring_equals_plain_bitwise(world, name, masked):
    xs, outs = world
    x = torch.from_numpy(xs[name])
    want = ring.ring_all_reduce_plain(
        x, torch.from_numpy(xs["mask"]) if masked else None).numpy()
    key = f"ring_{name}" + ("_masked" if masked else "")
    for r in range(4):
        np.testing.assert_array_equal(_bits(outs[r][key]), _bits(want))


@pytest.mark.parametrize("masked", [False, True])
def test_group_ring_of_three_ranks_equals_plain_bitwise(world, masked):
    xs, outs = world
    want = ring.ring_all_reduce_plain(
        torch.from_numpy(xs["x3"]),
        torch.from_numpy(xs["mask3"]) if masked else None).numpy()
    key = "ring3_masked" if masked else "ring3"
    for r in range(3):
        np.testing.assert_array_equal(_bits(outs[r][key]), _bits(want))
    assert key not in outs[3]


@pytest.mark.parametrize("name,stacked", [("xla", comm.XlaTransport),
                                          ("ringtr", comm.RingTransport)])
def test_group_transport_equals_stacked(world, name, stacked):
    xs, outs = world
    x = torch.from_numpy(xs["x1000"])
    mask = torch.from_numpy(xs["mask"])
    tr = stacked()
    want = {"sum": tr.all_reduce(x)[0], "mean": tr.all_reduce(x,
                                                              op="mean")[0],
            "masked": tr.masked_all_reduce(x, mask)[0]}
    pair, _ = tr.all_reduce((x, x[:, :7] * 2.0), tag="eval")
    for r in range(4):
        for op, w in want.items():
            got = outs[r][f"{name}_{op}"]
            if name == "ringtr":      # the ring keeps the fold: bit for bit
                np.testing.assert_array_equal(_bits(got), _bits(w))
            else:
                np.testing.assert_allclose(got, w.numpy(), rtol=RTOL,
                                           atol=1e-6)
        for got, w in zip(outs[r][f"{name}_tuple"], pair, strict=True):
            np.testing.assert_allclose(got, w.numpy(), rtol=RTOL, atol=1e-6)
        # the records equal the stacked run's, field for field
        assert outs[r][f"{name}_records"] == tr.log.records
    # every rank got the same bits
    for op in want:
        for r in range(1, 4):
            np.testing.assert_array_equal(outs[r][f"{name}_{op}"],
                                          outs[0][f"{name}_{op}"])


def test_quantized_over_group_equals_stacked(world):
    xs, outs = world
    x = torch.from_numpy(xs["x1000"])
    quant = comm.get_transport("quant", inner="xla", mode="int8")
    want, state = quant.all_reduce(x, state=quant.init_state(x))
    for r in range(4):
        np.testing.assert_allclose(outs[r]["quant"], want.numpy(),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_array_equal(outs[r]["quant_residual"][0],
                                      state[r].numpy())
        assert outs[r]["quant_records"] == quant.log.records


def _ref_grid(hosts, wph, model=None):
    mesh = JTopology.simulate(hosts, wph).make_mesh(model=model)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    return ids, tuple(mesh.axis_names)


@pytest.mark.parametrize("hosts,wph,model", [
    (1, 4, None), (2, 2, None), (2, 4, None), (1, 4, 2), (2, 4, 2)])
def test_rank_grid_is_the_reference_device_grid(hosts, wph, model):
    ids, axes = _ref_grid(hosts, wph, model)
    grid, ours = Topology.simulate(hosts, wph).rank_grid(model=model)
    np.testing.assert_array_equal(grid, ids)
    assert ours == axes


@pytest.mark.parametrize("key,hosts,wph,model", [
    ("groups_flat", 1, 4, None), ("groups_2x2", 2, 2, None),
    ("groups_model2", 1, 4, 2), ("worker_groups", 1, 4, None),
    ("host_groups", 1, 4, 2)])
def test_make_groups_gives_each_rank_its_reference_axes(world, key, hosts,
                                                       wph, model):
    _, outs = world
    ids, axes = _ref_grid(hosts, wph, model)
    for r in range(4):
        got = outs[r][key]
        assert got["axes"] == axes and got["shape"] == ids.shape
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert got["coords"] == where
        for a in range(ids.ndim):
            idx = list(where)
            idx[a] = slice(None)
            line = tuple(int(i) for i in ids[tuple(idx)])
            assert got["members"][a] == line == got["dist"][a]


def test_partial_grids_leave_the_other_ranks_out(world):
    _, outs = world
    for r in range(4):
        small = outs[r]["host_groups_small"]
        assert small["shape"] == (1, 1)
        assert small["dist"] == (((0,), (0,)) if r == 0 else (None, None))
        built = outs[r]["build_groups"]       # RemeshPlan(data=1, model=2)
        assert built["axes"] == ("data", "model")
        assert built["dist"][1] == ((0, 1) if r < 2 else None)


def test_detect_is_flat_on_one_machine(world):
    _, outs = world
    assert {o["detect"] for o in outs} == {"1x4"}


def test_production_layout():
    grid, axes = production_grid()
    ids, jaxes = ((np.arange(256).reshape(16, 16)), ("data", "model"))
    np.testing.assert_array_equal(grid, ids)
    assert axes == jaxes
    grid, axes = production_grid(multi_pod=True)
    assert axes == ("pod", "data", "model") and grid.shape == (2, 16, 16)
    np.testing.assert_array_equal(grid.reshape(-1), np.arange(512))
    # rank 300 is pod 1, data row 2, model column 12
    assert tuple(np.argwhere(grid == 300)[0]) == (1, 2, 12)


def test_production_groups_name_the_world_they_need(world):
    _, outs = world
    assert all("needs a world of 256 ranks, this one has 4"
               in o["production_error"] for o in outs)


def test_collectives(world):
    _, outs = world
    want = np.array([[r, 5.0 - r] for r in range(4)], np.float32)
    for o in outs:
        np.testing.assert_array_equal(o["gather"], want)
        np.testing.assert_array_equal(o["min"], [0.0, 2.0])


def test_spawn_names_the_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        process_group.spawn(worlds.fail_on_rank_one, 2, device="cpu")
    assert "deliberate failure" in str(e.value)


@pytest.mark.parametrize("dev,local,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 8, 8, "nccl"),
    ("cuda", 8, 1, "gloo"), ("cuda", 4, 2, "gloo")])
def test_backend_choice(dev, local, cards, want):
    assert process_group.choose_backend(
        torch.device(dev), local_world_size=local, device_count=cards) == want


def test_no_rank_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        process_group.init(rank=0, world_size=1)
    assert not process_group.in_world()


def _new_group_callers():
    """Port modules whose code calls ``new_group``."""
    out = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and (getattr(node.func, "attr", None) == "new_group"
                         or getattr(node.func, "id", None) == "new_group")):
                out.append(path.relative_to(REPO).as_posix())
    return sorted(set(out))


def test_only_topology_builds_process_groups():
    # the reference pins its one Mesh constructor the same way
    # (tests/test_topology.py); here the one dist.new_group caller is
    # topology/topology.py's grid_groups
    assert _new_group_callers() == ["src/repro_torch/topology/topology.py"]
