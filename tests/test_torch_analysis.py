"""The port's copy of ``repro.analysis`` against the original:
``tests/test_analysis.py``'s five CPU cases on both, with the roofline's
NVIDIA H100 SXM constants in the port's."""
import json

import pytest

from repro.analysis import corrected as ref_corrected
from repro.analysis import roofline as ref_roofline
from repro.analysis.hlo import collective_bytes as ref_collective_bytes
from repro.config import LM_SHAPES as REF_SHAPES
from repro.config import get_arch as ref_arch
from repro.config import list_archs as ref_list_archs
from repro_torch.analysis import corrected, report, roofline
from repro_torch.analysis.hlo import collective_bytes
from repro_torch.config import LM_SHAPES, get_arch, list_archs

HLO = """
  %x = f32[128,256]{1,0} parameter(0)
  %ar = f32[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[512,256]{1,0} all-gather(%x), replica_groups=[2,4]<=[8], dimensions={0}
  %rs = f32[32,256]{1,0} reduce-scatter(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = bf16[64]{0} collective-permute(%y), source_target_pairs={{0,1}}
  %aa = s32[16,4]{1,0} all-to-all(%z), replica_groups={{0,1}}
  %s = f32[8]{0} all-gather-start(%x), replica_groups={{0,1}}
  %d = f32[8]{0} all-gather-done(%s)
"""


def test_hlo_parser_matches_repro():
    got = collective_bytes(HLO)
    assert got == ref_collective_bytes(HLO)
    assert got["all-reduce"] == 128 * 256 * 4
    assert got["all-gather"] == 512 * 256 * 4 // 4 + 8 * 4 // 2  # the done is not counted
    assert got["reduce-scatter"] == 32 * 256 * 4 * 4
    assert got["total"] == sum(v for k, v in got.items() if k != "total")


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9


def test_roofline_terms_and_bottleneck_on_h100():
    r = roofline.Roofline(
        arch="a", shape="s", mesh="m", chips=256,
        hlo_flops=989e12,  # exactly 1 second of compute
        hlo_bytes=3.35e12 * 2,  # 2 seconds of HBM
        collective={"total": int(450e9 * 3)},  # 3 seconds of NVLink
        model_flops_total=989e12 * 256 * 0.5,
    ).finish()
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(3.0)
    assert r.bottleneck == "collective"
    assert r.roofline_fraction() == pytest.approx(0.5 / 3.0)
    # repro's terms over the same numbers, rescaled by the two tables' rates
    ref = ref_roofline.Roofline(arch="a", shape="s", mesh="m", chips=256,
                                hlo_flops=989e12, hlo_bytes=3.35e12 * 2,
                                collective={"total": int(450e9 * 3)},
                                model_flops_total=989e12 * 256 * 0.5).finish()
    assert r.t_compute * roofline.PEAK_FLOPS == pytest.approx(
        ref.t_compute * ref_roofline.PEAK_FLOPS)
    assert r.useful_flops_ratio == ref.useful_flops_ratio
    assert r.to_dict().keys() == ref.to_dict().keys()


@pytest.mark.parametrize("shape", list(LM_SHAPES))
def test_model_flops_match_repro(shape):
    assert list_archs(include_tiny=True) == ref_list_archs(include_tiny=True)
    for name in list_archs(include_tiny=True):
        assert roofline.model_flops(get_arch(name), LM_SHAPES[shape]) == \
            ref_roofline.model_flops(ref_arch(name), REF_SHAPES[shape])
    cfg = get_arch("gemma3-1b")
    tr = roofline.model_flops(cfg, LM_SHAPES["train_4k"])
    assert tr > roofline.model_flops(cfg, LM_SHAPES["prefill_32k"]) > \
        roofline.model_flops(cfg, LM_SHAPES["decode_32k"]) > 0
    assert tr >= 6 * cfg.active_param_count() * 256 * 4096


def test_two_point_and_analytic_flops_match_repro():
    for a, b, n in (({"flops": 10.0}, {"flops": 14.0}, 10), ({"flops": 10.0}, {"flops": 8.0}, 50),
                    ({"x": 1.0, "y": 3.0}, {"x": 2.0}, 7)):
        assert corrected.two_point(a, b, n) == ref_corrected.two_point(a, b, n)
    assert corrected.two_point({"flops": 10.0}, {"flops": 14.0}, 10)["flops"] == 46.0
    assert corrected.two_point({"flops": 10.0}, {"flops": 8.0}, 50)["flops"] == 10.0
    for name in ("xlstm-125m", "tiny-xlstm"):
        for shape in LM_SHAPES:
            assert corrected.xlstm_analytic_flops(get_arch(name), LM_SHAPES[shape]) == \
                ref_corrected.xlstm_analytic_flops(ref_arch(name), REF_SHAPES[shape])
    assert corrected.reduced_arch(get_arch("gemma3-1b"), 2).num_layers == 2


def test_report_tables(tmp_path):
    rec = roofline.Roofline(arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=2e12,
                            hlo_bytes=1e10, collective={"total": 5_000_000},
                            model_flops_total=1e14).finish().to_dict()
    rec.update(status="ok", roofline_fraction=0.5, peak_memory_bytes=3.2e9)
    bad = {"arch": "b", "shape": "s", "mesh": "16x16", "status": "skipped", "reason": "why"}
    path = tmp_path / "d.json"
    path.write_text(json.dumps([rec, bad]))
    table = report.dryrun_table(str(path)).splitlines()
    assert table[2].split(" | ")[4:] == ["2000.000", "10.000", "5.000", "3.2 |"]
    assert "skipped: why" in table[3]
    (tmp_path / "c.json").write_text(json.dumps([rec]))
    assert "| a | s |" in report.roofline_table(str(tmp_path / "c.json"))
    assert report.perf_table(str(tmp_path / "missing.json")) == "(pending)"
