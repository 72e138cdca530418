"""The mixes give the lane and instruction counts their files state, from
the seed alone, and the pool is the frozen DES's."""
import numpy as np
import pytest

from simbench import manifest, traffic
from simbench.des.workloads import SIM_BENCHMARKS

PROGRAMS = list(SIM_BENCHMARKS)
BIG = 2**31 + 12345


@pytest.mark.parametrize("mix,lanes,instructions,jobs", [
    ("sweep", 8192, 4_194_304, 32),
])
def test_calls_have_the_stated_sizes(mix, lanes, instructions, jobs):
    m = traffic.load_mix(manifest.mix_path(mix))
    for seed in (0, BIG, -7):
        for client, index in ((0, 0), (1, 5), (0, -1)):
            call = traffic.call_jobs(m, PROGRAMS, seed, client, index)
            assert len(call) == jobs
            assert sum(j.lanes for j in call) == lanes
            assert sum(j.instructions for j in call) == instructions
            assert all(j.instructions // j.lanes == m["chunk"] for j in call)
            assert all(j.offset % m["offset_step"] == 0 and
                       j.offset + j.instructions <= m["pool_instructions"] for j in call)
            assert len({j.workload for j in call}) == m["workloads_per_call"]


def test_a_seed_fixes_its_calls_and_seeds_differ():
    m = traffic.load_mix(manifest.mix_path("sweep"))
    a = traffic.call_jobs(m, PROGRAMS, BIG, 1, 3)
    assert a == traffic.call_jobs(m, PROGRAMS, BIG, 1, 3)
    assert a != traffic.call_jobs(m, PROGRAMS, BIG + 1, 1, 3)
    assert a != traffic.call_jobs(m, PROGRAMS, BIG, 0, 3)
    widths = sorted(j.retire_width for j in a)
    assert widths == sorted(m["retire_widths"] * m["workloads_per_call"])


def test_the_pool_holds_each_program_at_the_asked_length(tiny_pool):
    n = 4096
    pool = traffic.load_pool(PROGRAMS, n, workers=1, directory=tiny_pool)
    assert sorted(pool) == sorted(PROGRAMS)
    for arrays in pool.values():
        assert {k: (len(a), a.dtype) for k, a in arrays.items()} == {
            k: (n, np.dtype(dt)) for k, dt in traffic.KEYS.items()}
        assert np.array_equal(arrays["is_store"], arrays["feat"][:, 7] == 1.0)


def test_the_frozen_des_matches_the_ports():
    from repro_torch.core.features import trace_arrays as port_arrays
    from repro_torch.des.o3 import O3Config as PC, O3Simulator as PS
    from repro_torch.des.workloads import get_benchmark as port_bench
    from simbench.des.o3 import O3Config, O3Simulator
    from simbench.des.workloads import get_benchmark
    from simbench.features import trace_arrays

    for name in ("sim_phased", "sim_chase_mid"):
        ours = trace_arrays(O3Simulator(O3Config()).run(get_benchmark(name, 1500)))
        theirs = port_arrays(PS(PC()).run(port_bench(name, 1500)))
        assert all(np.array_equal(ours[k], theirs[k]) for k in ours)


def test_the_lane_sweep_at_the_mix_lanes_is_the_mix():
    """`simbench.lanes` splits the same jobs at the mix's sub-trace length:
    at the mix's own lanes it gives the mix's sizes."""
    from simbench import lanes

    m = traffic.load_mix(manifest.mix_path("sweep"))
    n = m["workloads_per_call"] * len(m["retire_widths"]) * m["lanes_per_job"]
    got = lanes.override("c3-sweep", n, m["clients"])
    assert {k: m[k] for k in got if k != "check_calls"} == \
        {k: v for k, v in got.items() if k != "check_calls"}
    with pytest.raises(ValueError):
        lanes.override("c3-sweep", n + 1, 2)
