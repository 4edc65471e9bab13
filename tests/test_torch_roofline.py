"""The port's roofline (``repro_torch.analysis.roofline``) against the
reference's (``repro.analysis.roofline``): ``model_flops_for`` on all 40
cells exactly, the 40 / 31 cell matrix and its SKIP reasons,
``collective_seconds`` on the same dict and link parameters, and a
report's terms checked by hand from the port's H100 ``HW``."""
import pytest

from repro import config as rc
from repro.analysis import roofline as rr
from repro_torch import config as pc
from repro_torch.analysis import cost
from repro_torch.analysis import roofline as pr

CELLS = [(a, s) for a in rc.ASSIGNED_ARCHS for s in rc.SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(arch, shape):
    assert pr.model_flops_for(pc.get_arch(arch), pc.SHAPES[shape]) == \
        rr.model_flops_for(rc.get_arch(arch), rc.SHAPES[shape])


def test_cell_matrix_and_skip_reasons_equal_reference():
    port = {(a, s): pc.cell_applicable(pc.get_arch(a), pc.SHAPES[s])
            for a, s in CELLS}
    ref = {(a, s): rc.cell_applicable(rc.get_arch(a), rc.SHAPES[s])
           for a, s in CELLS}
    assert port == ref
    assert len(port) == 40 and sum(ok for ok, _ in port.values()) == 31
    assert all(reason for ok, reason in port.values() if not ok)


def test_collective_seconds_equal_reference():
    colls = {"all-gather": dict(count=3, bytes=262144.0),
             "all-reduce": dict(count=2, bytes=4194304.0),
             "reduce-scatter": dict(count=1, bytes=4194304.0),
             "all-to-all": dict(count=4, bytes=32768.0)}
    for link_bw, links in ((50e9, 4), (25e9, 18)):
        assert pr.collective_seconds(colls, link_bw, links) == \
            rr.collective_seconds(colls, link_bw, links)
    # the defaults are the H100's NVLink 4: 18 links of 25 GB/s
    assert pr.collective_seconds(colls) == \
        rr.collective_seconds(colls, link_bw=25e9, links=18)


def test_report_terms_by_hand():
    rec = cost.Recorder()
    rec.flops, rec.transcendentals = 4.0e12, 1.0e9
    rec.total_write = 1.0e10
    rec.by_kind.update({"aten.mm": 6.0e9, "aten.add": 4.0e9})
    rec.coll = {"all-reduce": dict(count=1, bytes=9.0e9),
                "all-gather": dict(count=2, bytes=4.5e9)}
    rec.arg_bytes, rec.out_bytes, rec.temp_bytes = 7, 5, 3
    arch, shape = pc.get_arch("qwen1.5-0.5b"), pc.SHAPES["train_4k"]
    r = pr.build_report(arch, shape, "16x16", 256, rec)
    assert r.t_compute == 4.0e12 / 989e12
    assert r.t_memory == 2.0e10 / 3.35e12
    assert r.t_collective == (2 * 9.0e9 + 4.5e9) / (25e9 * 18)
    assert r.bottleneck == "collective"
    assert r.step_time == r.t_collective
    mf = 6.0 * arch.active_param_count() * 256 * 4096
    assert r.model_flops_global == mf
    assert r.useful_flops_ratio == mf / (4.0e12 * 256)
    assert r.mfu == mf / (256 * 989e12 * r.step_time)
    assert r.hbm_by_kind == {"aten.mm": 6.0e9, "aten.add": 4.0e9}
    assert (r.arg_bytes, r.out_bytes, r.temp_bytes) == (7, 5, 3)
    d = r.to_dict()
    assert set(d) >= set(rr.RooflineReport.__dataclass_fields__) | {
        "t_compute", "t_memory", "t_collective", "bottleneck", "step_time",
        "useful_flops_ratio", "mfu"}
    assert pr.hbm_bytes_estimate(rec) == dict(total_write=1.0e10, rw=2.0e10,
                                              by_kind=r.hbm_by_kind)
    assert pr.collectives(rec) == rec.coll
