"""Batched LM serving on the PyTorch port (prefill → decode): the port's
counterpart of ``examples/serve_lm.py``, with the same flags plus
``--device`` and ``--use-kernel``.

  PYTHONPATH=src python examples/serve_lm_torch.py --arch recurrentgemma-2b
  PYTHONPATH=src python examples/serve_lm_torch.py --arch mixtral-8x7b --device cpu

The config is the arch's reduced one (``reduced()``), the weights random
from a seed. ``--use-kernel`` routes every attention layer's decode
through the flash-decode kernel (on the card; CPU tensors take its plain
version). Without a GPU, ``--device cuda`` (the default) raises.
"""
import argparse

import torch

from repro_torch._device import DEVICE_KINDS, resolve_device
from repro_torch.configs.registry import get_reduced_config
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import DecodeEngine, lm_decoder


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", choices=DEVICE_KINDS, default="cuda")
    ap.add_argument("--use-kernel", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)

    g = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=g,
                            device=device, dtype=torch.int32)
    batch = {"tokens": prompts}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((args.batch, cfg.enc_seq, cfg.d_model), generator=g,
                                      device=device)
    print(f"prefill {args.batch}×{args.prompt_len} ({cfg.name}, reduced config, {device})…")
    with torch.no_grad():
        logits, state = model.prefill(params, batch)
    # prefill state is sized to the prompt; re-home it into a longer cache
    full = model.rehome_state(state, args.prompt_len + args.gen)

    engine = DecodeEngine(lm_decoder(model, use_kernel=args.use_kernel), params)
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    tokens, _, tps = engine.generate(full, first, args.gen)
    print(f"generated {tokens.shape[0]} tokens × {tokens.shape[1]} requests "
          f"at {tps:.0f} tok/s ({device})")
    print("first request:", tokens[:, 0].tolist())


if __name__ == "__main__":
    main()
