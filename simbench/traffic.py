"""The benchmark's one traffic generator, driven by a mix's data file
(``simbench/mixes/<traffic>.json``), and the pool of traces it draws from.

A mix names:

- ``pool_instructions``: the length of each pooled trace, one per program
  of the DES's ``SIM_BENCHMARKS``;
- ``clients``: client threads that each call the engine in a closed loop;
- ``workloads_per_call``: distinct pooled programs in one call;
- ``retire_widths``: the design points each of them is simulated at;
- ``job_instructions``: each job's window of its trace, starting at a
  multiple of ``offset_step``;
- ``lanes_per_job``: the sub-traces each job is split into, and ``chunk``,
  the engine's streaming chunk;
- ``warmup_calls``, ``trace_calls`` (calls a client makes before the
  window, and in a traced window) and ``check_calls`` (calls of the window
  that the reference checks).

A call's jobs are its programs × retire widths in an order drawn from the
seed, each with its own window offset. Every seed gives the same sizes;
the programs, their order and the offsets vary. The pool is made once per
checkout by the frozen DES copy (`simbench.des`) and kept under
``simbench/.pool/`` (git-ignored).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import shutil
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent
POOL_DIR = HERE / ".pool"
KEYS = {"feat": np.float32, "addr": np.int32, "is_store": np.bool_, "labels": np.float32}
MIX_KEYS = ("pool_instructions", "clients", "workloads_per_call", "retire_widths",
            "job_instructions", "lanes_per_job", "chunk", "offset_step", "warmup_calls",
            "trace_calls", "check_calls")


@dataclasses.dataclass(frozen=True)
class Job:
    workload: str
    retire_width: int
    offset: int
    instructions: int
    lanes: int


def load_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise ValueError(f"{path}: the mix lacks {missing}")
    if mix["job_instructions"] % mix["lanes_per_job"]:
        raise ValueError(f"{path}: a job's instructions do not split into its lanes")
    if mix["job_instructions"] > mix["pool_instructions"]:
        raise ValueError(f"{path}: a job is longer than a pooled trace")
    return mix


def seed_words(seed: int) -> List[int]:
    """A seed of any size or sign as non-negative 32-bit words."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def call_jobs(mix: dict, programs: List[str], seed: int, client: int, index: int) -> List[Job]:
    """The jobs of call ``index`` of ``client`` (index < 0: its warm-up
    calls), a function of the seed and these two numbers alone."""
    rng = np.random.default_rng(seed_words(seed) + [client, index + (1 << 20)])
    chosen = rng.choice(len(programs), size=mix["workloads_per_call"], replace=False)
    slots = (mix["pool_instructions"] - mix["job_instructions"]) // mix["offset_step"] + 1
    jobs = [(programs[p], int(w)) for p in chosen for w in mix["retire_widths"]]
    order = rng.permutation(len(jobs))
    offsets = rng.integers(0, slots, size=len(jobs)) * mix["offset_step"]
    return [Job(jobs[i][0], jobs[i][1], int(o), mix["job_instructions"], mix["lanes_per_job"])
            for i, o in zip(order, offsets)]


def job_arrays(pool: Dict[str, dict], job: Job) -> dict:
    """The job's window of its pooled trace (views, no copy)."""
    lo, hi = job.offset, job.offset + job.instructions
    return {k: v[lo:hi] for k, v in pool[job.workload].items()}


# -- the pool ---------------------------------------------------------------

def _make_trace(name: str, n: int, directory: str) -> str:
    """Run the frozen DES on one program and store its arrays (one ``.npy``
    a key) under the pool; returns the directory."""
    from simbench.des.o3 import O3Config, O3Simulator
    from simbench.des.workloads import get_benchmark
    from simbench.features import trace_arrays

    # a few programs come out a little short of the length asked for (the
    # phased one joins parts of n // k instructions): ask for more, keep n
    arrays = trace_arrays(O3Simulator(O3Config()).run(get_benchmark(name, n + 1024)))
    if len(arrays["feat"]) < n:
        raise RuntimeError(f"the DES gave {len(arrays['feat'])} instructions of {name}, not {n}")
    final = Path(directory) / f"{name}-{n}"
    tmp = final.with_name(final.name + f".part{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for k, dt in KEYS.items():
        np.save(tmp / f"{k}.npy", np.ascontiguousarray(arrays[k][:n], dtype=dt))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return str(final)


def _load_trace(name: str, n: int, directory: Path):
    d = directory / f"{name}-{n}"
    try:
        arrays = {k: np.load(d / f"{k}.npy") for k in KEYS}
    except (OSError, ValueError):
        return None
    if any(len(a) != n or a.dtype != KEYS[k] for k, a in arrays.items()):
        return None
    return arrays


def load_pool(programs: List[str], n: int, workers: int = 8,
              directory: Path = None) -> Dict[str, dict]:
    """The pooled trace arrays of ``programs`` at ``n`` instructions each,
    read from ``directory`` (default ``simbench/.pool/``) into memory, the
    missing ones made first by the DES in up to ``workers`` processes
    (spawned, joined)."""
    directory = Path(directory or POOL_DIR)
    pool = {name: _load_trace(name, n, directory) for name in programs}
    todo = [name for name, a in pool.items() if a is None]
    if todo:
        directory.mkdir(parents=True, exist_ok=True)
        if workers > 1 and len(todo) > 1:
            ctx = multiprocessing.get_context("spawn")
            with concurrent.futures.ProcessPoolExecutor(min(workers, len(todo)),
                                                        mp_context=ctx) as ex:
                for f in [ex.submit(_make_trace, name, n, str(directory)) for name in todo]:
                    f.result()
        else:
            for name in todo:
                _make_trace(name, n, str(directory))
        for name in todo:
            pool[name] = _load_trace(name, n, directory)
            if pool[name] is None:
                raise RuntimeError(f"the pooled trace {name} at {n} instructions did not load")
    return pool
