"""The roofline's LM half (``distributed.roofline``) held against the
reference's, and the dry run's LM cells.

  * ``layer_flops_token``, ``cell_flops``, ``cell_bytes`` and
    ``replication_waste`` == the reference's exactly for every config x
    cell x layout, and ``roofline_terms``' FLOP and byte fields too; the
    time terms differ by the rates only (the H100's, none a TPU's);
  * the four properties of ``tests/test_analysis.py:74-98`` on the port's
    constants;
  * with no lowered program the collective term is ``None``, marked "not
    lowered", and the dominant term and the MFU bound come from the other
    two;
  * ``dryrun --all --device cpu``: exit 0, 80 records, the skips
    ``cell_applicable``'s, no error, every record with the reference's
    keys and a lowered collective term taken into the dominant term;
    ``--multi-pod --merge``, ``--quantized`` and the prefill cell's cache
    specs.
"""

import json

import pytest

from repro.configs import registry as jreg
from repro.distributed import roofline as jroofline
from repro_torch.configs import registry
from repro_torch.distributed import roofline
from repro_torch.launch import dryrun

MESHES = (False, True)


def _cell(name):
    return next(s for s in registry.SHAPES if s.name == name)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_lm_counts_equal_the_reference(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    for cell, jcell in zip(registry.SHAPES, jreg.SHAPES):
        for ctx in (1, 2048, cell.seq_len // 2, cell.seq_len):
            for dec in (False, True):
                assert roofline.layer_flops_token(cfg, ctx, dec) == \
                    jroofline.layer_flops_token(jcfg, ctx, dec)
        assert roofline.cell_flops(cfg, cell) == jroofline.cell_flops(
            jcfg, jcell)
        for mp in MESHES:
            mesh, jmesh = roofline.mesh_shape(mp), jroofline.mesh_shape(mp)
            assert (mesh.pod, mesh.data, mesh.model) == (
                jmesh.pod, jmesh.data, jmesh.model)
            assert roofline.replication_waste(cfg, mesh) == \
                jroofline.replication_waste(jcfg, jmesh)
            for sp in (True, False):
                assert roofline.cell_bytes(cfg, cell, mesh,
                                           seq_parallel=sp) == \
                    jroofline.cell_bytes(jcfg, jcell, jmesh, seq_parallel=sp)
            got = roofline.roofline_terms(cfg, cell, mesh, 1e9)
            want = jroofline.roofline_terms(jcfg, jcell, jmesh, 1e9)
            for key in ("device_flops", "device_bytes", "bytes_detail",
                        "model_flops", "useful_ratio", "replication_waste"):
                assert got[key] == want[key], key
            assert got["t_compute"] == got["device_flops"] / 989e12
            assert got["t_memory"] == got["device_bytes"] / 3.35e12
            assert got["t_collective"] == 1e9 / 450e9
    assert roofline.uses_fsdp_name(cfg) == jroofline.uses_fsdp_name(jcfg)


def test_constants_are_one_h100s():
    assert roofline.BF16_PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    assert roofline.PEAK_FLOPS == 67e12     # the VQ half's f32 rate
    assert {roofline.BF16_PEAK_FLOPS, roofline.HBM_BW,
            roofline.NVLINK_BW}.isdisjoint(
        {jroofline.PEAK_FLOPS, jroofline.HBM_BW, jroofline.ICI_BW})


# the four properties of tests/test_analysis.py:74-98, on the H100's rates

def test_model_flops_scale():
    fl = roofline.cell_flops(registry.get_config("granite_8b"),
                             _cell("train_4k"))
    assert fl["model_flops"] < fl["total"] < 4 * fl["model_flops"]


def test_decode_is_memory_bound_in_model():
    terms = roofline.roofline_terms(registry.get_config("granite_8b"),
                                    _cell("decode_32k"),
                                    roofline.mesh_shape(False), 1e6)
    assert terms["dominant"] == "memory"


def test_replication_waste_for_nondivisible_heads():
    mesh = roofline.mesh_shape(False)
    assert roofline.replication_waste(registry.get_config("starcoder2_7b"),
                                      mesh) > 2.0
    assert roofline.replication_waste(registry.get_config("granite_8b"),
                                      mesh) == 1.0


def test_multipod_halves_per_device_flops():
    cfg, c = registry.get_config("granite_8b"), _cell("train_4k")
    t1 = roofline.roofline_terms(cfg, c, roofline.mesh_shape(False), 0.0)
    t2 = roofline.roofline_terms(cfg, c, roofline.mesh_shape(True), 0.0)
    assert t2["t_compute"] == pytest.approx(t1["t_compute"] / 2, rel=1e-6)


def test_collective_term_not_lowered():
    cfg, c = registry.get_config("granite_8b"), _cell("train_4k")
    terms = roofline.roofline_terms(cfg, c, roofline.mesh_shape(False), None)
    assert terms["t_collective"] is None
    assert terms["collective_note"] == "not lowered"
    assert terms["dominant"] == max(("compute", "memory"),
                                    key=lambda k: terms[f"t_{k}"])
    assert terms["step_time_bound_s"] == max(terms["t_compute"],
                                             terms["t_memory"])
    lowered = roofline.roofline_terms(cfg, c, roofline.mesh_shape(False),
                                      0.0)
    assert lowered["collective_note"] == "lowered"
    assert lowered["mfu_bound"] == terms["mfu_bound"]


# ---------------------------------------------------------------------------
# the dry run's LM cells
# ---------------------------------------------------------------------------

KEYS = {"arch", "shape", "mesh", "merge", "status", "reason", "roofline",
        "memory", "collectives"}
#: the reference's ``analyze_collectives`` keys (its ``tpu_adjusted_bytes``
#: corrects an XLA:CPU promotion the port does not have)
COLL_KEYS = {"total_bytes", "bytes_by_kind", "count_by_kind", "loops",
             "in_loop_bytes", "top_ops"}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry") / "lm.json"
    code = dryrun.main(["--all", "--device", "cpu", "--out", str(out)])
    return code, json.loads(out.read_text())


def test_all_cells_exit_0_with_80_records(sweep):
    code, recs = sweep
    assert code == 0 and len(recs) == 80
    skips = 2 * sum(not registry.cell_applicable(registry.get_config(a), c)[0]
                    for a in registry.ARCH_IDS for c in registry.SHAPES)
    assert sum(r["status"] == "skipped" for r in recs) == skips == 16
    assert not any(r["status"] == "error" for r in recs)
    assert {(r["arch"], r["shape"], r["mesh"]) for r in recs} == {
        (a, c.name, m) for a in registry.ARCH_IDS for c in registry.SHAPES
        for m in ("16x16", "2x16x16")}


def test_records_hold_the_references_keys(sweep):
    _, recs = sweep
    for r in recs:
        if r["status"] == "skipped":
            assert r["reason"] and "roofline" not in r
            continue
        assert KEYS <= set(r), r["arch"]
        assert r["merge"] == "none"
        t = r["roofline"]
        # the placed step lowered on meta shards (distributed.hlo_analysis)
        coll = r["collectives"]
        assert set(coll) == COLL_KEYS
        assert t["collective_note"] == "lowered"
        assert t["t_collective"] == coll["total_bytes"] / roofline.NVLINK_BW
        assert coll["total_bytes"] > 0
        assert t["dominant"] == max(("compute", "memory", "collective"),
                                    key=lambda k: t[f"t_{k}"])
        assert r["memory"]["argument_bytes"] > 0


def test_argument_bytes_shrink_with_the_second_pod(sweep):
    _, recs = sweep
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs
          if r["status"] == "ok"}
    for (arch, shape, mesh), r in by.items():
        if mesh != "16x16" or shape == "long_500k":
            continue
        two = by[(arch, shape, "2x16x16")]
        # the params' placement ignores 'pod'; the batch and the cache
        # split over it
        assert two["memory"]["argument_bytes"] <= r["memory"][
            "argument_bytes"]


def test_window_quantized_and_prefill_cells(tmp_path, capsys):
    out = str(tmp_path / "x.json")
    assert dryrun.main(["--arch", "moonshot_v1_16b_a3b", "--shape",
                        "train_4k", "--multi-pod", "--merge", "async_delta",
                        "--tau", "10", "--out", out]) == 0
    assert dryrun.main(["--arch", "moonshot_v1_16b_a3b", "--shape",
                        "train_4k", "--multi-pod", "--out", out]) == 0
    assert dryrun.main(["--arch", "granite_8b", "--shape", "decode_32k",
                        "--quantized", "--out", out]) == 0
    assert dryrun.main(["--arch", "granite_8b", "--shape", "decode_32k",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "granite_8b", "--shape", "prefill_32k",
                        "--both-meshes", "--out", out]) == 0
    recs = json.loads(open(out).read())
    assert len(recs) == 6            # merged by key
    win = next(r for r in recs if r["merge"] == "async_delta")
    step = next(r for r in recs if r["shape"] == "train_4k"
                and r["merge"] == "none")
    assert win["per_step_divisor"] == 10 and step["per_step_divisor"] == 1
    # the window's state adds the f32 delta_prev; its batch holds tau steps
    w, s = win["memory"]["argument_detail"], step["memory"][
        "argument_detail"]
    assert w["state"] > s["state"] and w["batch"] == 10 * s["batch"]
    q = next(r for r in recs if r.get("quantized"))
    plain = next(r for r in recs if r["shape"] == "decode_32k"
                 and not r.get("quantized"))
    assert q["memory"]["argument_bytes"] < plain["memory"]["argument_bytes"]
    pre = next(r for r in recs if r["shape"] == "prefill_32k")
    assert pre["cache_specs"]["k"] == [None, "data", "model", None, None]
    assert "OK   granite_8b x prefill_32k [2x16x16" in capsys.readouterr().out
