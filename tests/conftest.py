"""Shared fixtures. NOTE: no XLA_FLAGS here — tests run on the real single
CPU device; only launch/dryrun.py forces 512 virtual devices."""
import numpy as np
import pytest

from repro.des.o3 import O3Config, O3Simulator
from repro.des.workloads import get_benchmark


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA GPU and nvcc (hand-written kernels of repro_torch); "
        "skips without one",
    )


def synth_arrays(T, seed):
    """A tiny synthetic trace-arrays dict (teacher-forced label replay) —
    the serving tests' fast-tier workload; the machinery under test is
    identical for predictor models."""
    from repro.core import features as F

    rng = np.random.default_rng(seed)
    is_store = rng.random(T) < 0.3
    feat = rng.random((T, F.STATIC_END)).astype(np.float32)
    feat[:, 7] = is_store  # Op.STORE one-hot column must agree with is_store
    return {
        "feat": feat,
        "addr": rng.integers(0, 50, (T, F.N_ADDR_KEYS)).astype(np.int32),
        "is_store": is_store,
        "labels": np.stack([
            rng.integers(0, 4, T),
            rng.integers(1, 12, T),
            rng.integers(1, 6, T),
        ], axis=1).astype(np.float32),
    }


@pytest.fixture(scope="session")
def small_o3():
    return O3Config()


@pytest.fixture(scope="session")
def small_trace(small_o3):
    """A 6k-instruction mixed trace through the DES (session-cached)."""
    sim = O3Simulator(small_o3)
    return sim.run(get_benchmark("mlb_mixed", 6000))


@pytest.fixture(scope="session")
def loop_trace(small_o3):
    sim = O3Simulator(small_o3)
    return sim.run(get_benchmark("sim_loop", 4000))
