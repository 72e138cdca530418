"""Shared fixtures of the benchmark's own tests: a cut-down pool and mixes,
so a whole run fits on the CPU in seconds. Card tests carry the ``cuda``
marker and skip, inside a fixture, where there is no card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the mixes at a cut size: the same shape of traffic, fewer and shorter jobs
TINY = {
    "sweep": {"pool_instructions": 4096, "workloads_per_call": 2, "retire_widths": [2, 8],
              "job_instructions": 1024, "lanes_per_job": 8, "chunk": 128, "warmup_calls": 1,
              "trace_calls": 1, "check_calls": 2},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA GPU and nvcc; skips without one")


@pytest.fixture(scope="session")
def pool_dir(tmp_path_factory):
    """A pool of the nine programs at the cut size, made once."""
    from simbench import traffic
    from simbench.des.workloads import SIM_BENCHMARKS

    d = tmp_path_factory.mktemp("pool")
    traffic.load_pool(list(SIM_BENCHMARKS), TINY["sweep"]["pool_instructions"], workers=1,
                      directory=d)
    return d


@pytest.fixture
def tiny_pool(pool_dir, monkeypatch):
    from simbench import traffic

    monkeypatch.setattr(traffic, "POOL_DIR", pool_dir)
    return pool_dir


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card tests run on the card")
    return torch
