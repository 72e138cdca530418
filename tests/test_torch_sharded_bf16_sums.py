"""Where the sharded hybrid's bf16 logits drift from one rank's (ROADMAP
F11), on the CPU: two gloo ranks of a spawned world, a (data 1, model 2)
mesh, recurrentgemma-2b reduced in its own dtype (bf16), a sharded
prefill and its first decode step against the same on one rank.

Every reduction the two ranks run (each ``_c10d_functional``
``all_reduce`` and ``reduce_scatter_tensor``: DTensor's ``Partial →
Replicate`` and ``Partial → Shard``) goes through a checking impl that
gathers both ranks' bf16 parts and sums them twice: in bf16, as gloo and
the peer buffers do, and in f32 rounded once to bf16. At two ranks the
two sums are the same bits at every element: a bf16 sum of two bf16
values is their exact sum rounded once. So the drift is not in how the
parts are summed but in each rank's part itself, a GEMM's half
contraction rounded to bf16 before the sum, where one rank rounds the
whole contraction once; summing in f32 cannot remove it. The drift of
the logits is printed (``-s``) beside the count of reductions checked.
"""
import faulthandler
import multiprocessing
import os
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six xdist workers share eight cores
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402

ARCH, B, T, WORLD, TIMEOUT_S = "recurrentgemma-2b", 4, 12, 2, 300


def _gathered(tensor, group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = _resolve_process_group(group_name)
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return parts, dist.get_rank(group)


class _Sums:
    """Checking impls of the two reductions: the bf16 sum in rank order
    (returned) against the f32 sum rounded once."""

    def __init__(self):
        self.calls = self.elements = self.differ = 0
        self.kinds = {"all_reduce": 0, "reduce_scatter_tensor": 0}

    def _both(self, parts, kind):
        self.kinds[kind] += 1
        bf16 = parts[0].clone()
        for part in parts[1:]:
            bf16.add_(part)
        f32 = torch.stack([p.float() for p in parts]).sum(0).to(parts[0].dtype)
        self.calls += 1
        self.elements += bf16.numel()
        self.differ += int((bf16.view(torch.int16) != f32.view(torch.int16)).sum())
        return bf16

    def all_reduce(self, tensor, reduce_op, group_name):
        if reduce_op != "sum":
            raise NotImplementedError(reduce_op)
        parts, _ = _gathered(tensor, group_name)
        return self._both(parts, "all_reduce")

    def reduce_scatter(self, tensor, reduce_op, group_size, group_name):
        if reduce_op != "sum":
            raise NotImplementedError(reduce_op)
        parts, rank = _gathered(tensor, group_name)
        n = tensor.shape[0] // group_size
        return self._both([p[rank * n:(rank + 1) * n] for p in parts], "reduce_scatter_tensor")


def _first_step(model, params, tokens, constrain=None):
    """The prefill's greedy tokens and the first decode step's logits."""
    logits, state = model.prefill(params, {"tokens": tokens}, constrain=constrain)
    first = sh.argmax_last(logits[:, -1])
    lg, _ = model.decode_step(params, model.rehome_state(state, T + 1), first, constrain=constrain)
    lg = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
    return sh.local(first).numpy(), lg.float().numpy()


def _rank(rank, init, queue):
    faulthandler.enable(all_threads=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT_S))
    out = {}
    try:
        sums = _Sums()
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_reduce", sums.all_reduce, "CPU")
        lib.impl("reduce_scatter_tensor", sums.reduce_scatter, "CPU")
        cfg = reduced(registry.ARCHS[ARCH])
        model = build_model(cfg)
        plain = model.init(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (B, T))
                                  .astype(np.int32))
        mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), "cpu")
        rules = sh.rules_for(cfg, "decode")
        params = sh.shard_tree(plain, model.param_specs(), rules, mesh)
        with torch.no_grad():
            out["two"] = _first_step(model, params, tokens, sh.make_constrain(mesh, rules))
            out["one"] = _first_step(model, plain, tokens)
        out["dtype"] = str(cfg.dtype)
        out["sums"] = (sums.calls, sums.elements, sums.differ)
        out["kinds"] = dict(sums.kinds)
    except BaseException as e:  # the fixture reports it
        out = {"error": repr(e)}
        raise
    finally:
        dist.destroy_process_group()
        queue.put((rank, out))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("bf16_sums")
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_rank, args=(r, f"file://{work}/store", queue), daemon=True)
                 for r in range(WORLD)]
        for p in procs:
            p.start()
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    try:
        got = dict(queue.get(timeout=TIMEOUT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(TIMEOUT_S)
            if p.is_alive():
                p.kill()
    for rank in sorted(got):
        assert "error" not in got[rank], (rank, got[rank].get("error"))
    assert all(p.exitcode == 0 for p in procs)
    return got


def test_two_ranks_sum_their_bf16_parts_as_f32_would(ranks):
    """Every reduction of the bf16 prefill and decode step: the f32 sum
    rounded once equals the bf16 sum, at every element, on both ranks."""
    for rank, got in ranks.items():
        calls, elements, differ = got["sums"]
        assert got["dtype"] == "bfloat16"
        assert calls > 0 and elements > 0
        assert differ == 0, (rank, calls, elements, differ)


def test_the_drift_is_the_ranks_bf16_parts(ranks):
    """The two ranks' greedy tokens equal one rank's; their first-step
    logits drift from one rank's by bf16 rounding (printed as a share of
    max |logit|), the same on both ranks."""
    (first1, one), (first2, two) = ranks[0]["one"], ranks[0]["two"]
    np.testing.assert_array_equal(ranks[1]["two"][1], two)
    np.testing.assert_array_equal(first1, first2)
    drift = float(np.abs(two - one).max()) / float(np.abs(one).max())
    calls, elements, _ = ranks[0]["sums"]
    print(f"\n{ARCH} reduced, bf16, (1, 2) mesh vs one rank: first-step logits {100 * drift:.3f}% "
          f"of max |logit| {float(np.abs(one).max()):.4f}; {calls} reductions a rank "
          f"({ranks[0]['kinds']}; {elements} elements) summed identically in bf16 and in f32")
    assert 0 < drift < 0.5
