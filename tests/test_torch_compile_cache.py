"""The port's program cache (`repro_torch.serving.compile_cache`): the
reference's `CompileCache` semantics and key completeness, held to the
reference's own tests (`tests/test_serve.py`,
`tests/test_cache_key_completeness.py`) on the port's configs and key.
Runs on the CPU: the cache is framework-free, and a CPU program is the
eager chunk function under the same key and counters."""
import dataclasses
import threading
import time

import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from repro.analysis import key_irrelevant_fields  # noqa: E402
from repro.serving.compile_cache import ExecutableKey as RefExecutableKey  # noqa: E402
from repro.serving.compile_cache import chunk_bucket as ref_chunk_bucket  # noqa: E402
from repro.serving.compile_cache import lane_bucket as ref_lane_bucket  # noqa: E402
from repro_torch.core.predictor import PredictorConfig  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.compile_cache import (  # noqa: E402
    CompileCache,
    ExecutableKey,
    chunk_bucket,
    global_cache,
    lane_bucket,
)
from repro_torch.serving.faults import FaultInjected, FaultPlan, FaultSpec  # noqa: E402

# field -> replacement value, where the default can't just be bumped (as
# the reference's completeness test)
_PERTURB = {
    "kind": "rb7",
    "output": "reg",
    "layout": "roll",
    "state_dtype": "bfloat16",
    "compute_dtype": "bfloat16",
    "channels": (32, 128, 128),
}
WAIT = 30  # seconds any thread or future of these tests may take


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear()
    yield
    faults.clear()


def _perturbed(cfg, field: dataclasses.Field):
    cur = getattr(cfg, field.name)
    if field.name in _PERTURB:
        new = _PERTURB[field.name]
    elif isinstance(cur, bool):
        new = not cur
    elif isinstance(cur, int):
        new = cur + 1
    elif isinstance(cur, float):
        new = cur * 2 + 1
    elif isinstance(cur, tuple):
        new = cur + cur[-1:]
    else:
        raise AssertionError(f"no perturbation strategy for {type(cfg).__name__}.{field.name}")
    assert new != cur
    return dataclasses.replace(cfg, **{field.name: new})


def _base_key(**overrides):
    kw = dict(predictor=PredictorConfig(), sim_cfg=SimConfig(), n_lanes=8, chunk=256,
              mesh=None, use_kernel=False)
    kw.update(overrides)
    return ExecutableKey(**kw)


def _config_cases():
    for cls, key_field in ((SimConfig, "sim_cfg"), (PredictorConfig, "predictor")):
        for f in dataclasses.fields(cls):
            yield pytest.param(cls, key_field, f, id=f"{cls.__name__}.{f.name}")


# ------------------------------------------------------------------ the key


def test_key_is_field_identical_to_the_reference():
    """The lint reads whichever ExecutableKey it meets first: the two keys
    must carry the same fields, annotations and defaults."""
    def fields(cls):
        return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]

    assert fields(ExecutableKey) == fields(RefExecutableKey)
    assert _base_key().describe() == "c3/ctx64/ring/L8/T256"
    assert _base_key(predictor=None).describe() == "teacher-forced/ctx64/ring/L8/T256"
    assert _base_key(use_kernel=True).describe() == "c3/ctx64/ring/L8/T256/kernel"


def test_buckets_equal_the_reference():
    for n in (1, 2, 3, 5, 8, 9, 64, 1000):
        assert lane_bucket(n) == ref_lane_bucket(n)
        for cap in (1, 256, 1024):
            assert chunk_bucket(n, cap) == ref_chunk_bucket(n, cap)
    with pytest.raises(ValueError):
        lane_bucket(0)
    with pytest.raises(ValueError):
        chunk_bucket(0, 8)


@pytest.mark.parametrize("cls,key_field,field", _config_cases())
def test_each_config_field_mints_a_distinct_key(cls, key_field, field):
    base = _base_key()
    pert = _base_key(**{key_field: _perturbed(getattr(base, key_field), field)})
    assert pert != base and len({base, pert}) == 2


@pytest.mark.parametrize("cls,key_field,field", _config_cases())
def test_each_config_field_causes_a_cache_miss(cls, key_field, field):
    cache = CompileCache()
    built = []

    def builder():
        built.append(1)
        return lambda *a: None

    base = _base_key()
    pert = _base_key(**{key_field: _perturbed(getattr(base, key_field), field)})
    cache.get(base, builder)
    cache.get(pert, builder)
    cache.get(base, builder)  # and the base entry is still a hit
    assert len(built) == 2
    assert (cache.counters()["misses"], cache.counters()["hits"]) == (2, 1)


def test_no_field_is_exempt():
    """Every field of the port's configs is key-relevant, as in the
    reference (no ``# cache-key: irrelevant`` marker)."""
    assert key_irrelevant_fields(SimConfig) == set()
    assert key_irrelevant_fields(PredictorConfig) == set()


def test_engine_scalars_mint_distinct_keys():
    base = _base_key()
    assert _base_key(n_lanes=16) != base
    assert _base_key(chunk=512) != base
    assert _base_key(use_kernel=True) != base
    assert _base_key(predictor=None) != base


# ---------------------------------------------------------------- the cache


def test_cache_counts_hits_and_misses():
    cache = CompileCache()
    calls = []
    key_a = ("a",)  # the cache is shape-agnostic about its keys

    def build():
        calls.append(1)
        return lambda: "exe"

    assert cache.get(key_a, build) is cache.get(key_a, build)
    assert len(calls) == 1
    st = cache.stats()
    assert (st["hits"], st["misses"], st["n_executables"]) == (1, 1, 1)
    before = cache.counters()
    cache.get(key_a, build)
    assert cache.delta_since(before) == {"hits": 1, "misses": 0, "compile_seconds": 0.0}
    cache.clear()
    assert cache.stats()["n_executables"] == 0 and cache.counters()["hits"] == 0


def test_per_key_stats_describe_the_key():
    cache = CompileCache()
    key = _base_key()
    cache.get(key, lambda: object())
    cache.get(key, lambda: object())
    per = cache.stats()["executables"]
    assert list(per) == [key.describe()] and per[key.describe()]["hits"] == 1
    assert per[key.describe()]["compile_seconds"] >= 0.0


def test_concurrent_same_key_callers_build_once():
    cache = CompileCache()
    calls, gate = [], threading.Event()

    def build():
        calls.append(1)
        gate.wait(WAIT)  # hold the build until every caller has arrived
        return object()

    got = []
    threads = [threading.Thread(target=lambda: got.append(cache.get("k", build))) for _ in range(8)]
    for t in threads:
        t.start()
    deadline = time.time() + WAIT
    while len(calls) == 0 and time.time() < deadline:
        time.sleep(0.001)
    time.sleep(0.05)  # the other seven are waiting on the owner's future
    gate.set()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 8 and len({id(g) for g in got}) == 1
    st = cache.stats()
    assert (st["misses"], st["hits"]) == (1, 7)


def test_other_keys_build_while_one_builds():
    """The lock is never held across a build: a slow build of one key
    does not block a build, or a hit, of another."""
    cache = CompileCache()
    cache.get("hot", object)
    gate, started = threading.Event(), threading.Event()

    def slow():
        started.set()
        gate.wait(WAIT)
        return object()

    t = threading.Thread(target=lambda: cache.get("slow", slow))
    t.start()
    assert started.wait(WAIT)
    cache.get("hot", object)  # a hit, while "slow" builds
    cache.get("other", object)  # another key builds
    gate.set()
    t.join(WAIT)
    assert not t.is_alive()
    assert cache.counters()["misses"] == 3 and cache.counters()["hits"] == 1


def test_failing_builder_does_not_poison_its_key():
    cache = CompileCache()

    def bad():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.get("k", bad)
    assert cache.stats()["misses"] == 0 and cache.stats()["n_executables"] == 0
    exe = cache.get("k", object)  # the next get retries the build
    assert cache.get("k", object) is exe
    assert (cache.stats()["misses"], cache.stats()["hits"]) == (1, 1)


def test_waiters_see_the_owners_failure():
    cache = CompileCache()
    gate, started = threading.Event(), threading.Event()
    errors = []

    def bad():
        started.set()
        gate.wait(WAIT)
        raise RuntimeError("boom")

    def call():
        try:
            cache.get("k", bad)
        except RuntimeError as e:
            errors.append(str(e))

    owner = threading.Thread(target=call)
    owner.start()
    assert started.wait(WAIT)
    waiter = threading.Thread(target=call)
    waiter.start()
    time.sleep(0.05)
    gate.set()
    owner.join(WAIT)
    waiter.join(WAIT)
    assert not owner.is_alive() and not waiter.is_alive()
    assert errors == ["boom", "boom"]
    assert cache.stats()["n_executables"] == 0


def test_clear_during_a_build_keeps_the_stale_build_out():
    cache = CompileCache()
    gate, started = threading.Event(), threading.Event()
    got = []

    def slow():
        started.set()
        gate.wait(WAIT)
        return "stale"

    t = threading.Thread(target=lambda: got.append(cache.get("k", slow)))
    t.start()
    assert started.wait(WAIT)
    cache.clear()
    gate.set()
    t.join(WAIT)
    assert not t.is_alive()
    assert got == ["stale"]  # the caller still gets its program
    st = cache.stats()
    assert (st["n_executables"], st["misses"], st["compile_seconds"]) == (0, 0, 0.0)
    assert cache.get("k", lambda: "fresh") == "fresh"


def test_compile_fault_site_meters_real_builds_only():
    """The port's own `faults`: an injected compile failure is a failed
    build (not counted, key clean); hits never reach the site."""
    plan = FaultPlan(5, {"compile": FaultSpec(fail_once=1)})
    faults.install(plan)
    cache = CompileCache()
    with pytest.raises(FaultInjected):
        cache.get("k", object)
    exe = cache.get("k", object)
    assert cache.get("k", object) is exe
    assert plan.snapshot()["sites"]["compile"] == {"arrivals": 2, "fails": 1, "delays": 0,
                                                   "corruptions": 0}
    assert (cache.stats()["misses"], cache.stats()["hits"]) == (1, 1)


def test_one_global_cache_per_device():
    assert global_cache("cpu") is global_cache(torch.device("cpu"))
    assert isinstance(global_cache("cpu"), CompileCache)
