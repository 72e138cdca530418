"""Multi-pod dry run — the port of ``repro.launch.dryrun``: every (arch ×
shape × mesh) cell at the reference's world of 512 ranks, recorded as
JSON for the roofline report, without a cluster and without allocating.

Where the reference compiles each cell for 512 virtual XLA devices and
reads the compiled HLO, the port traces it: the process is rank 0 of a
``"fake"`` process group of 512 (or 2 × 256) ranks on a ``FakeStore``
(collectives return at once and move nothing), builds
``launch/mesh.py::make_production_mesh`` on it, places the params, the
optimizer state and the decode state as DTensors of fake local shards
(``FakeTensorMode``: shapes only) and runs the port's own step once under
`runtime.opcount.OpCounter`, which counts rank 0's FLOPs, bytes and
collectives. The record has the reference's file name and keys;
``compile_seconds`` holds the trace's seconds and ``cost_analysis_raw``
the counter's raw totals. Each cell starts its group and destroys it on
the way out, so cells run one after another in one process.

The steps are the port's: train is ``make_train_step`` (f32 masters, the
rule table's ``constrain``, ``grad_shardings`` and ``layer_specs``, Adam
state placed by ``adam_state_specs``) on the whole global batch as plain
tensors (every rank of the port's launcher holds it; the first
``constrain`` keeps each rank's part); prefill is ``model.prefill``;
decode is ``model.decode_step`` on the state placed by
``specs.decode_state_axes`` with the tokens plain. The plain paths run,
as in the reference (``use_kernel`` off); a kernel's region counts the
same work. The roofline divides by the H100's figures
(`runtime.roofline`), the f32 peak for a cell computing in f32.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
      [--device cpu] [--out artifacts/dryrun_torch]

``--all`` sweeps every LM arch × shape and, beyond the reference's sweep
(which runs SimNet's cells by name only), every ``simnet-c3`` cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.runtime import opcount
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.roofline import model_flops, peak_for, roofline
from repro_torch.training.optimizer import AdamConfig, adam_init, adam_state_specs
from repro_torch.training.train_loop import make_train_step

DEVICE_KINDS = ("cuda", "cpu")


def _mode_for(shape):
    if shape.kind == "train":
        return "train"
    if shape.kind == "prefill":
        return "prefill"
    return "decode_long" if shape.name == "long_500k" else "decode"


# --- the paper's own architecture: SimNet parallel simulation cells -------
SIMNET_SHAPES = {
    # lanes = sub-traces resident per step (paper Fig. 8 x-axis), chunk =
    # instructions advanced per call
    "simulate_64k": (65536, 64),
    "simulate_256k": (262144, 32),
}
SIMNET_ARCHS = ("simnet-c3",)


def _mesh_name(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


@contextlib.contextmanager
def fake_world(multi_pod: bool, device_type: str):
    """This process as rank 0 of a ``"fake"`` group spanning the production
    mesh (16 × 16 ranks, or 2 × 16 × 16 with ``multi_pod``: the
    reference's 512 devices), and the mesh; the group ends on the way
    out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own process group: end this process's "
                           "group first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    finally:
        dist.destroy_process_group()


def placed(meta: torch.Tensor, sharding, mode, device):
    """A DTensor of ``meta``'s shape and dtype placed by ``sharding`` ((mesh,
    placements), `runtime.sharding.place`'s even rule), its local shard a
    fake tensor of ``mode`` on ``device``."""
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding
    placements = sh.even_placements(meta.shape, mesh, placements)
    local, _ = sh.local_shape_and_offset(meta.shape, mesh, placements)
    with mode:
        shard = torch.empty(local, dtype=meta.dtype, device=device)
    return DTensor.from_local(shard, mesh, placements, shape=meta.shape, stride=meta.stride(),
                              run_check=False)


def plain(meta: torch.Tensor, mode, device):
    """A fake tensor of ``meta``'s shape and dtype (the same on every rank)."""
    with mode:
        return torch.zeros(meta.shape, dtype=meta.dtype, device=device)


def lower_simnet_cell(arch: str, shape_name: str, *, multi_pod: bool, device_type: str = "cuda"):
    from repro_torch.core.predictor import PredictorConfig, init_predictor
    from repro_torch.serving.simnet_engine import SimNetEngine

    kind = arch.split("-", 1)[1]  # "simnet-c3" -> "c3"
    pcfg = PredictorConfig(kind=kind, ctx_len=64)
    lanes, chunk = SIMNET_SHAPES[shape_name]
    with fake_world(multi_pod, device_type) as mesh:
        params = init_predictor(torch.Generator().manual_seed(0), pcfg, device=device_type)
        engine = SimNetEngine(params, pcfg, mesh=mesh, device=device_type)
        res = engine.lower(lanes, chunk)
        n_dev = mesh.size()
    terms = roofline(res["flops"], res["bytes_accessed"], res["collectives"]["total_bytes"],
                     peak_flops=peak_for(pcfg.compute_dtype))
    return {
        "arch": arch, "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "n_devices": int(n_dev),
        "mode": "simulate", "status": "ok",
        "compile_seconds": res["trace_seconds"],
        "instructions_per_call": lanes * chunk,
        "lanes_per_device": res["n_lanes"],
        "memory_analysis": {k: res["memory_analysis"][k]
                            for k in ("argument_bytes", "temp_bytes", "peak_live_bytes_est")},
        "collectives": res["collectives"],
        "op_histogram": res["op_histogram"],
        "dot_flops_by_shape": res["dot_flops_by_shape"],
        "roofline": terms.to_dict(),
        "useful_flops_ratio": None,
        "model_flops": {},
    }


def _step(model, cfg, shape, mode_name, mesh, mode, device):
    """(the step, its arguments) of a cell: params, state and batch as
    DTensors / plain fake tensors."""
    rules = sh.rules_for(cfg, mode_name)
    constrain = sh.make_constrain(mesh, rules)
    train = shape.kind == "train"
    pshapes, pspecs = specs_lib.param_shapes_and_specs(model, masters=train)
    bf16_params = cfg.param_dtype == "bfloat16"
    if bf16_params:
        # bf16 stored params (fp32 master in the optimizer): FSDP gathers
        # and weight-gradient reductions move half the bytes
        pshapes = tree_map(lambda s: s.to(torch.bfloat16) if s.dtype == torch.float32 else s,
                           pshapes)
    p_sh = sh.spec_tree_to_shardings(pspecs, rules, mesh)
    params = tree_map(lambda s, ps: placed(s, ps, mode, device), pshapes, p_sh)
    if train:
        opt_shapes = adam_init(pshapes, keep_master=bf16_params)
        opt_sh = sh.spec_tree_to_shardings(adam_state_specs(pspecs, keep_master=bf16_params),
                                           rules, mesh)
        opt = tree_map(lambda s, ps: placed(s, ps, mode, device), opt_shapes, opt_sh)
        bshapes, _ = specs_lib.batch_specs(cfg, shape)
        batch = {k: plain(v, mode, device) for k, v in bshapes.items()}
        step = make_train_step(model, AdamConfig(), constrain=constrain,
                               accum_steps=cfg.accum_steps, grad_shardings=p_sh,
                               layer_specs=model.layer_specs())
        return step, (params, opt, batch)
    if shape.kind == "prefill":
        bshapes, _ = specs_lib.batch_specs(cfg, shape)
        batch = {k: plain(v, mode, device) for k, v in bshapes.items()}
        return (lambda p, b: model.prefill(p, b, constrain=constrain)), (params, batch)
    state_shapes = specs_lib.decode_state_specs(cfg, shape)
    state_axes = specs_lib.decode_state_axes(cfg, state_shapes)
    state = tree_map(lambda s, ps: placed(s, ps, mode, device), state_shapes,
                     sh.spec_tree_to_shardings(state_axes, rules, mesh))
    tok_shape, _ = specs_lib.decode_token_specs(cfg, shape)
    token = plain(tok_shape, mode, device)
    return (lambda p, s, t: model.decode_step(p, s, t, constrain=constrain)), (params, state, token)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, overrides=None,
               device_type: str = "cuda"):
    """Build and trace one cell. Returns the result record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    model = build_model(cfg)
    mode_name = _mode_for(shape)
    with fake_world(multi_pod, device_type) as mesh:
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        step, args = _step(model, cfg, shape, mode_name, mesh, fake, device_type)
        analysis = opcount.analyze(step, *args, fake_mode=fake)
        n_dev = mesh.size()
    del analysis["out"]
    coll = analysis["collectives"]
    flops_dev, bytes_dev = analysis["flops"], analysis["bytes_accessed"]
    terms = roofline(flops_dev, bytes_dev, coll["total_bytes"], peak_flops=peak_for(cfg.dtype))
    mf = model_flops(cfg, shape, n_dev)
    useful = mf["model_flops_per_device"] / flops_dev if flops_dev else 0.0
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "n_devices": int(n_dev),
        "mode": mode_name,
        "status": "ok",
        "compile_seconds": analysis["trace_seconds"],
        "cost_analysis_raw": {"flops": flops_dev, "bytes accessed": bytes_dev,
                              "ops": float(analysis["n_ops"])},
        "memory_analysis": analysis["memory_analysis"],
        "collectives": coll,
        "op_histogram": analysis["op_histogram"],
        "dot_flops_by_shape": analysis["dot_flops_by_shape"],
        "roofline": terms.to_dict(),
        "model_flops": mf,
        "useful_flops_ratio": useful,
        "overrides": overrides or {},
    }


def run_cell(arch, shape_name, multi_pod, out_dir: Path, overrides=None, tag="",
             device_type: str = "cuda"):
    name = f"{arch}__{shape_name}__{'multipod' if multi_pod else 'pod'}{tag}.json"
    out_path = out_dir / name
    if arch.startswith("simnet-"):
        try:
            rec = lower_simnet_cell(arch, shape_name, multi_pod=multi_pod,
                                    device_type=device_type)
            r = rec["roofline"]
            print(f"[ok] {arch} × {shape_name} × {rec['mesh']}: dominant={r['dominant']}",
                  flush=True)
        # per-cell survey: one arch×shape failing must not sink the sweep
        except Exception as e:  # repro-lint: disable=hygiene-broad-except — survey cell records FAIL + traceback
            rec = {"arch": arch, "shape": shape_name, "status": f"FAIL: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"[FAIL] {arch} × {shape_name}: {e}", flush=True)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec
    if not shape_applicable(arch, shape_name):
        rec = {
            "arch": arch, "shape": shape_name,
            "mesh": _mesh_name(multi_pod),
            "status": "SKIP(full-attention)",
            "note": "long_500k requires a sub-quadratic mechanism; see DESIGN.md",
        }
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[skip] {arch} × {shape_name}", flush=True)
        return rec
    try:
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod, overrides=overrides,
                         device_type=device_type)
        r = rec["roofline"]
        print(
            f"[ok] {arch} × {shape_name} × {rec['mesh']}: "
            f"compute {r['compute_s']:.3e}s memory {r['memory_s']:.3e}s "
            f"collective {r['collective_s']:.3e}s dominant={r['dominant']} "
            f"(trace {rec['compile_seconds']:.0f}s)", flush=True
        )
    # per-cell survey: one arch×shape failing must not sink the sweep
    except Exception as e:  # repro-lint: disable=hygiene-broad-except — survey cell records FAIL + traceback
        rec = {
            "arch": arch, "shape": shape_name,
            "mesh": _mesh_name(multi_pod),
            "status": f"FAIL: {type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print(f"[FAIL] {arch} × {shape_name}: {e}", flush=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--device", choices=DEVICE_KINDS, default="cuda",
                    help="the device of the fake tensors")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.arch:
        cells = [(args.arch, args.shape)] if args.shape else [
            (args.arch, s) for s in (SIMNET_SHAPES if args.arch in SIMNET_ARCHS else SHAPES)]
    else:
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in list_archs() for s in shapes]
        if args.all and not args.shape:
            cells += [(a, s) for a in SIMNET_ARCHS for s in SIMNET_SHAPES]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    t0 = time.perf_counter()
    for arch, shape_name in cells:
        for mp in meshes:
            rec = run_cell(arch, shape_name, mp, out_dir, device_type=args.device)
            if str(rec.get("status", "")).startswith("FAIL"):
                n_fail += 1
    print(f"done; {n_fail} failures ({time.perf_counter() - t0:.1f} s)")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
