"""The predictor's weights, made on the device from the seed: every weight
matrix drawn in one call of a generator on the card (a standard normal
folded into ±2, scaled by 1 / sqrt(fan-in), as the paper's models are
initialised), biases zero, float32 (the type they are served in). Both the
program and the reference get these tensors.

Then one correction, so that every seed gives a predictor of the same
kind: each class logit of the hybrid head is standardised over a
calibration batch (the reference's predictions on the first 64 steps of
16 lanes of each pooled program): its column of the last layer's weights
and its bias are shifted and scaled so that the logit has mean 0 and
standard deviation 1 there; twice, the second time on the predictions of
the once-corrected weights. The regression outputs are left as drawn.
Without it some seeds' heads put nearly every instruction in one class by
a wide margin: such a predictor decides nothing near a tie, and no check
of its answers could tell float32 from a lower precision. With it the
classes follow the input, as a trained head's do, on every seed.
"""
from __future__ import annotations

import math

import torch

from simbench import reference as R
from simbench.traffic import seed_words

CALIBRATION = {"lanes": 16, "steps": 64, "rounds": 2}


def make_weights(cfg: dict, seed: int, device, sim: dict, pool: dict) -> dict:
    shapes = R.param_shapes(cfg)
    leaves = []  # (path, shape)

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), v))

    walk(shapes, ())
    mats = [(p, s) for p, s in leaves if p[-1] == "w"]
    g = torch.Generator(device=device)
    lo, hi = seed_words(seed)
    g.manual_seed((lo | hi << 32) & ((1 << 63) - 1))
    flat = torch.randn(sum(math.prod(s) for _, s in mats), generator=g, device=device)
    flat = torch.fmod(flat, 2.0)
    out, at = {}, 0
    for path, shape in leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path[-1] == "w":
            n = math.prod(shape)
            node["w"] = (flat[at:at + n].reshape(shape) / math.sqrt(shape[0])).contiguous()
            at += n
        else:
            node[path[-1]] = torch.zeros(shape, dtype=torch.float32, device=device)
    for _ in range(CALIBRATION["rounds"]):
        _standardise_classes(out, cfg, sim, pool, device)
    return out


def class_logits(params, cfg, sim, pool, device) -> torch.Tensor:
    """(predictions, heads, classes): the class logits the reference
    predicts over the calibration batch."""
    n = CALIBRATION["lanes"] * CALIBRATION["steps"]
    jobs = [{"arrays": {k: v[:n] for k, v in arrays.items()}, "retire_width": sim["retire_width"],
             "lanes": CALIBRATION["lanes"]} for arrays in pool.values()]
    raws = []
    R.simulate(jobs, params, cfg, sim, device, raws=raws)
    k = cfg["n_classes"]
    return torch.cat(raws).reshape(-1, R.N_HEADS, k + 1)[..., :k]


def _standardise_classes(params, cfg, sim, pool, device) -> None:
    logits = class_logits(params, cfg, sim, pool, device)
    mean, std = logits.mean(0), logits.std(0)
    k = cfg["n_classes"]
    w = params["fc1"]["w"].view(-1, R.N_HEADS, k + 1)[..., :k]
    b = params["fc1"]["b"].view(R.N_HEADS, k + 1)[:, :k]
    w /= std
    b -= mean
    b /= std
