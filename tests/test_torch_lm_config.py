"""The port's copy of the LM configuration system
(``repro_torch.config``, ``repro_torch.configs``) against the reference's:
every registered arch and the BSS-2 shim field for field
(``dataclasses.asdict``), ``reduced()`` too, the derived sizes
(``vocab_padded``, ``param_count``, ``active_param_count``),
``cell_applicable`` over ``SHAPES``, ``MeshConfig`` and the registry."""
import dataclasses

import pytest

from repro import config as rc
from repro_torch import config as pc

NAMES = rc.list_archs()


def test_registry_names_equal():
    assert pc.list_archs() == NAMES
    assert len(NAMES) == 11 and "bss2" in NAMES
    assert pc.ASSIGNED_ARCHS == rc.ASSIGNED_ARCHS
    assert pc.FAMILIES == rc.FAMILIES
    with pytest.raises(KeyError, match="unknown arch"):
        pc.get_arch("no-such-arch")


@pytest.mark.parametrize("name", NAMES)
def test_arch_equal_field_for_field(name):
    ref, port = rc.get_arch(name), pc.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.vocab_padded == ref.vocab_padded
    assert port.vocab_padded % 128 == 0
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert (port.attention_free, port.is_encoder_only, port.sub_quadratic) \
        == (ref.attention_free, ref.is_encoder_only, ref.sub_quadratic)
    if name != "bss2":
        r, p = ref.reduced(), port.reduced()
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.param_count() == r.param_count()
        assert p.vocab_padded == r.vocab_padded


@pytest.mark.parametrize("name", NAMES)
def test_cell_applicable_over_shapes(name):
    assert sorted(pc.SHAPES) == sorted(rc.SHAPES)
    for s in rc.SHAPES:
        assert dataclasses.asdict(pc.SHAPES[s]) == dataclasses.asdict(
            rc.SHAPES[s])
        assert dataclasses.asdict(pc.SHAPES[s].reduced()) == \
            dataclasses.asdict(rc.SHAPES[s].reduced())
        assert pc.cell_applicable(pc.get_arch(name), pc.SHAPES[s]) == \
            rc.cell_applicable(rc.get_arch(name), rc.SHAPES[s])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_config(multi_pod):
    r, p = rc.MeshConfig(multi_pod), pc.MeshConfig(multi_pod)
    assert (p.shape, p.axes, p.n_devices, p.data_axes) == \
        (r.shape, r.axes, r.n_devices, r.data_axes)


def test_no_tpu_hardware_model():
    """The port's hardware model is the H100 SXM5 80 GB of NVIDIA's data
    sheet (bf16 dense peak, fp32, HBM3, NVLink 4), and none of the
    reference's TPU v5e numbers (197e12 FLOP/s, 819e9 B/s, 50e9 B/s a
    link) is in it."""
    hw = pc.HW
    assert isinstance(hw, pc.HardwareConfig)
    assert hw.peak_flops_bf16 == 989e12      # dense: the sheet quotes 1,979 sparse
    assert hw.peak_flops_fp32 == 67e12
    assert hw.hbm_bw == 3.35e12
    assert hw.hbm_bytes == 80e9
    assert (hw.link_bw, hw.links) == (25e9, 18)
    assert 2 * hw.link_bw * hw.links == 900e9
    values = set(dataclasses.astuple(hw))
    assert not values & {197e12, 819e9, 50e9, 16 * 2**30}


def test_full_width_serving_sizes():
    """The sizes path G states: qwen1.5-0.5b's padded vocab and parameter
    count, mamba2-130m's and hymba-1.5b's."""
    q = pc.get_arch("qwen1.5-0.5b")
    assert (q.n_layers, q.d_model, q.vocab_padded) == (24, 1024, 151936)
    assert q.param_count() == 463986688
    assert round(pc.get_arch("mamba2-130m").param_count() / 1e9, 3) == 0.129
    assert round(pc.get_arch("hymba-1.5b").param_count() / 1e9, 3) == 1.588
