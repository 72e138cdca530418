"""The port's teacher-forced dataset (`repro_torch.core.dataset`) against
the reference's (`repro.core.dataset`): on the same DES traces, X (float16)
and Y (float32) are bit-identical, through the lane split, the chunking,
the CRC32 dedup, the seeded permutation and the 90/5/5 split."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from repro.core import dataset as ref  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro.des.workloads import get_benchmark  # noqa: E402
from repro_torch.core import dataset as port  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402

CTX = 16
BENCHES = [("mlb_mixed", 2600), ("sim_loop", 1800)]


@pytest.fixture(scope="module")
def traces():
    sim = O3Simulator(O3Config())
    return [sim.run(get_benchmark(n, s)) for n, s in BENCHES]


def _bit_identical(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_lanes,chunk", [(8, 2048), (4, 128)])
@pytest.mark.parametrize("layout", ["ring", "roll"])
def test_teacher_forced_samples_bit_identical(traces, n_lanes, chunk, layout):
    """(8, 2048): one chunk of a short trace; (4, 128): several chunks,
    the state carried from one to the next."""
    kw = dict(ctx_len=CTX, layout=layout)
    X, Y = ref.teacher_forced_samples(traces[0], RefSimConfig(**kw), n_lanes=n_lanes, chunk=chunk)
    PX, PY = port.teacher_forced_samples(traces[0], SimConfig(**kw), n_lanes=n_lanes, chunk=chunk,
                                         device="cpu")
    assert X.dtype == np.float16 and X.shape[1:] == (CTX + 1, 50)
    _bit_identical(PX, X)
    _bit_identical(PY, Y)
    assert X[:, 1:].any()  # the queue rows were filled, not only the current row


@pytest.mark.parametrize("do_dedup,seed", [(True, 0), (True, 3), (False, 0)])
def test_build_dataset_bit_identical(traces, do_dedup, seed):
    want = ref.build_dataset(traces, RefSimConfig(ctx_len=CTX), seed=seed, do_dedup=do_dedup)
    got = port.build_dataset(traces, SimConfig(ctx_len=CTX), seed=seed, do_dedup=do_dedup,
                             device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        _bit_identical(got[k], want[k])
    n = sum(len(got[k]) for k in ("train_x", "val_x", "test_x"))
    assert len(got["val_x"]) == len(got["test_x"]) == max(n // 20, 1)


def test_dedup_drops_repeats_like_the_reference():
    rng = np.random.default_rng(0)
    X = rng.random((40, 5, 50)).astype(np.float16)
    Y = rng.integers(0, 4, (40, 3)).astype(np.float32)
    X[10:20], Y[10:20] = X[:10], Y[:10]  # exact repeats go
    Y[20] += 1.0  # the same x with another y stays
    X[20] = X[0]
    got, want = port.dedup(X, Y), ref.dedup(X, Y)
    for g, w in zip(got, want):
        _bit_identical(g, w)
    assert len(got[0]) == 30


@pytest.mark.parametrize("window", [1, 8, CTX])
def test_ithemal_samples_bit_identical(traces, window):
    X, Y = ref.ithemal_samples(traces[1], window)
    PX, PY = port.ithemal_samples(traces[1], window)
    _bit_identical(PX, X)
    _bit_identical(PY, Y)
