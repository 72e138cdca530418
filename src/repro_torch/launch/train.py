"""Fault-tolerant training launcher — the port of ``repro.launch.train``.

Ties together: arch config → model (f32 masters) → train step → data
pipeline → checkpoint/restart → straggler monitor, on one device
(``device``, default ``cuda``; asking for ``cuda`` without a GPU raises).
The reference's mesh (``model_axis``, sharded params and optimizer state)
comes with the LM half of the port's mesh (ROADMAP.md Queue 1 item
12a-LM): ``model_axis`` other than 1 raises ``NotImplementedError`` until
then.

A checkpoint holds ``{"params", "opt"}`` in the reference's format; a run
resumes from the newest one in ``ckpt_dir``, whichever package wrote it
(the reference's stacked layers or the port's per-layer lists). As in the
reference, the token loader starts at data step 0 on every run, so a run
resumed at step k trains on batches 0, 1, ... again.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import DEVICE_KINDS, DeviceLike, resolve_device
from repro_torch._tree import tree_map
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.data.pipeline import TokenLoader
from repro_torch.models.registry import build_model
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.training.optimizer import AdamConfig, adam_init
from repro_torch.training.train_loop import make_train_step


def extras_for(cfg, n_patches=8):
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = lambda b, s: np.random.default_rng(0).standard_normal(
            (b, cfg.enc_seq, cfg.d_model), dtype=np.float32
        )
    if cfg.frontend == "vision_stub":
        extras["patches"] = lambda b, s: np.random.default_rng(0).standard_normal(
            (b, n_patches, cfg.frontend_dim), dtype=np.float32
        )
        def mrope(b, s):
            pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
            return np.broadcast_to(pos[None], (3, b, s)).copy()
        extras["mrope_positions"] = mrope
    return extras


def restore_state(mgr: CheckpointManager, model, device, like):
    """The newest checkpoint of ``mgr`` as (params, opt state, step) on
    ``device``, in the structure of ``like`` (the model's params): f32
    masters, Adam's ``m`` and ``v`` in the params' structure, its
    ``step``. Takes the port's per-layer lists and the reference's stacked
    or ``layer_i`` blocks."""
    state, step = mgr.restore()

    def masters(tree):
        return tree_map(lambda _, r: r, like, model.params_from_numpy(tree, device, masters=True))

    opt = {"m": masters(state["opt"]["m"]), "v": masters(state["opt"]["v"]),
           "step": torch.from_numpy(np.asarray(state["opt"]["step"])).to(device)}
    return masters(state["params"]), opt, step


def train(
    arch: str,
    *,
    reduced: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir=None,
    ckpt_every: int = 25,
    model_axis: int = 1,
    accum_steps=None,
    log_every: int = 10,
    device: DeviceLike = None,
):
    """Returns the reference's ``{"losses", "final_loss", "monitor"}``
    and, the port's own, ``"metrics"`` (each step's metrics as floats),
    ``"params"`` and ``"opt"`` (the final masters and Adam state)."""
    if model_axis != 1:
        raise NotImplementedError("model_axis > 1 needs the LM half of the port's device mesh "
                                  "(ROADMAP.md Queue 1 item 12a-LM)")
    dev = resolve_device(device)
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    if accum_steps is not None:
        cfg = dataclasses.replace(cfg, accum_steps=accum_steps)
    model = build_model(cfg)

    params = model.init(torch.Generator(dev).manual_seed(0), device=dev, masters=True)
    opt = adam_init(params)
    acfg = AdamConfig(lr=lr, warmup_steps=max(steps // 10, 1), decay_steps=steps)
    step_fn = make_train_step(model, acfg, accum_steps=cfg.accum_steps)

    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        params, opt, start_step = restore_state(mgr, model, dev, params)
        print(f"[train] restored step {start_step} from {ckpt_dir}")

    loader = TokenLoader(cfg.vocab, batch, seq, extras=extras_for(cfg))
    monitor = StragglerMonitor()
    losses, history = [], []
    try:
        for step in range(start_step, steps):
            b = next(loader)
            t0 = time.perf_counter()
            b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            params, opt, metrics = step_fn(params, opt, b)
            history.append({k: float(v) for k, v in metrics.items()})  # waits for the step
            dt = time.perf_counter() - t0
            monitor.record(step, dt)
            losses.append(history[-1]["loss"])
            if log_every and step % log_every == 0:
                print(
                    f"[train] step {step} loss {losses[-1]:.4f} "
                    f"grad_norm {history[-1]['grad_norm']:.3f} {dt*1000:.0f}ms"
                )
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt})
        if mgr:
            mgr.save(steps, {"params": params, "opt": opt})
            mgr.wait()
    finally:
        loader.close()
    return {"losses": losses, "final_loss": losses[-1], "monitor": monitor,
            "metrics": history, "params": params, "opt": opt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", choices=DEVICE_KINDS, default="cuda")
    args = ap.parse_args(argv)
    res = train(
        args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir, model_axis=args.model_axis,
        device=args.device,
    )
    print(f"final loss: {res['final_loss']:.4f}")


if __name__ == "__main__":
    main()
