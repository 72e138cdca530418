"""Train an LM from the assigned-architecture pool end to end on the
PyTorch port: the counterpart of ``examples/train_lm.py``, with the same
flags plus ``--device``.

Default: a ~100M-param tinyllama-family config for a configurable number
of steps on the synthetic corpus, with checkpointing and restart
(``repro_torch.launch.train``). ``--tiny`` runs the arch's reduced config
(minutes on a CPU); the ~100M config is the same code.

  PYTHONPATH=src python examples/train_lm_torch.py --tiny --steps 20 --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300          # ~100M, on the card
"""
import argparse
import dataclasses

from repro_torch._device import DEVICE_KINDS
from repro_torch.configs.registry import get_config
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_lm")
    ap.add_argument("--device", choices=DEVICE_KINDS, default="cuda")
    args = ap.parse_args(argv)

    if args.tiny:
        res = train(args.arch, reduced=True, steps=args.steps, batch=4, seq=64,
                    ckpt_dir=args.ckpt_dir, log_every=10, device=args.device)
    else:
        # ~100M: full family structure, narrowed (12L × 768d, vocab 32000)
        import repro_torch.configs.registry as reg

        base = get_config(args.arch)
        cfg100 = dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab=32000, accum_steps=1,
        )
        n = cfg100.n_params()
        print(f"~100M config: {n/1e6:.0f}M params")
        reg.ARCHS["lm-100m"] = cfg100
        res = train("lm-100m", reduced=False, steps=args.steps, batch=args.batch,
                    seq=args.seq, ckpt_dir=args.ckpt_dir, log_every=10, device=args.device)
    print(f"final loss {res['final_loss']:.4f}; "
          f"mean step time {res['monitor'].mean_step_time*1000:.0f}ms")


if __name__ == "__main__":
    main()
