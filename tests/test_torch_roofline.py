"""The port's roofline (`repro_torch.runtime.roofline`) against the
reference's (`repro.runtime.roofline`, which imports no JAX): the same
model FLOPs and ring-buffer traffic formulas, divided by the H100's
figures instead of the TPU's."""
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores
torch.set_num_threads(1)

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.runtime import roofline as ref  # noqa: E402
from repro_torch.configs.registry import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.runtime import roofline as rl  # noqa: E402


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference(arch, shape):
    for n_dev in (1, 256, 512):
        assert rl.model_flops(get_config(arch), SHAPES[shape], n_dev) == ref.model_flops(
            ref_get_config(arch), REF_SHAPES[shape], n_dev)


@pytest.mark.parametrize("lanes", [1, 1024, 65536])
@pytest.mark.parametrize("state_bytes", [4, 2])
def test_sim_step_traffic_bytes_equal_the_reference(lanes, state_bytes):
    """At the c3 defaults (ctx_len 64): the same bytes and ratio; the
    times divide by the H100's HBM rate."""
    got = rl.sim_step_traffic(64, lanes, state_dtype_bytes=state_bytes)
    want = ref.sim_step_traffic(64, lanes, state_dtype_bytes=state_bytes)
    for k in ("roll_bytes_per_step", "ring_bytes_per_step", "ratio"):
        assert got[k] == want[k], k
    assert got["ring_memory_s"] == want["ring_bytes_per_step"] / 3.35e12
    assert got["roll_memory_s"] == want["roll_bytes_per_step"] / 3.35e12


def test_the_h100_figures():
    assert (rl.PEAK_FLOPS, rl.PEAK_FLOPS_F32, rl.HBM_BW, rl.NVLINK_BW) == (
        989.4e12, 67e12, 3.35e12, 450e9)
    assert rl.peak_for("float32") == rl.PEAK_FLOPS_F32
    assert rl.peak_for("bfloat16") == rl.PEAK_FLOPS


@pytest.mark.parametrize("which, dominant", [(0, "compute"), (1, "memory"), (2, "collective")])
def test_terms_dominant_bound_and_fraction(which, dominant):
    """One second of each resource, then the one term doubled: it
    dominates, bounds the step at 2 s, and the fraction is 2 / 4."""
    base = [rl.PEAK_FLOPS, rl.HBM_BW, rl.NVLINK_BW]
    base[which] *= 2
    t = rl.roofline(*base)
    assert (t.compute_s, t.memory_s, t.collective_s)[which] == pytest.approx(2.0)
    assert t.dominant == dominant
    assert t.bound_s == pytest.approx(2.0) and t.serial_s == pytest.approx(4.0)
    assert t.roofline_fraction() == pytest.approx(0.5)
    d = t.to_dict()
    assert d.keys() == ref.roofline(1.0, 1.0, 1.0).to_dict().keys()
    assert d["dominant"] == dominant and d["bound_s"] == t.bound_s


def test_an_f32_cell_divides_by_the_f32_peak():
    f32 = rl.roofline(67e12, 0.0, 0.0, peak_flops=rl.peak_for("float32"))
    bf16 = rl.roofline(67e12, 0.0, 0.0)
    assert f32.compute_s == pytest.approx(1.0)
    assert bf16.compute_s == pytest.approx(67e12 / 989.4e12)
    assert rl.roofline(0.0, 0.0, 0.0).roofline_fraction() == 0.0
