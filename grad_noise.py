#!/usr/bin/env python3
"""Reads how far the small float32 train step's gradients on one NVIDIA GPU
lie from the same step on the CPU, over several seeds, for svg, det and
GroupNorm cells with heatmaps (tests/torch_train_small.py:small_steps):
the float32 noise that GRAD_TOL_DEVICES must stand above, and what planted
faults read against it.

    python3 grad_noise.py [--seeds 8] [--out readings.json]

For each variant and seed, the worst gradient leaf's |x - cpu| / |cpu|
(norms) and its name, where x is:
  * gpu            the step on the card, TF32 off (what train_step_parity
                   holds to GRAD_TOL_DEVICES);
  * cpu_no_onednn  the step on the CPU with oneDNN's convolutions off: the
                   same function summed in another order on one device;
  * gpu_tf32       planted: the step on the card with TF32 on;
  * gpu_detached_var, gpu_detached_mean (GroupNorm variants) planted:
                   GroupNorm's variance or mean detached in the backward
                   pass, TF32 off.
Prints the card's name and power limit and one line per variant and kind;
writes every reading as JSON to --out, if given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_train_small import (  # noqa: E402
    GRAD_TOL_DEVICES,
    detached_group_statistics,
    grad_errors,
    small_steps,
)
from torch_variant_cases import TRAIN_VARIANTS  # noqa: E402

VARIANTS = dict(svg={}, **TRAIN_VARIANTS)


def tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def grads(dev, seed, variant):
    (_, g, *_), _ = small_steps(dev, seed, **variant)
    return g


def readings(variant, seed):
    """{kind: (worst leaf, its error)} for one variant and seed."""
    want = grads("cpu", seed, variant)
    runs = {}
    tf32(False)
    runs["gpu"] = grads("cuda", seed, variant)
    with torch.backends.mkldnn.flags(enabled=False):
        runs["cpu_no_onednn"] = grads("cpu", seed, variant)
    tf32(True)
    runs["gpu_tf32"] = grads("cuda", seed, variant)
    tf32(False)
    if variant.get("lstm_group_norm"):
        for stat in ("var", "mean"):
            with detached_group_statistics((stat,)):
                runs[f"gpu_detached_{stat}"] = grads("cuda", seed, variant)
    out = {}
    for kind, got in runs.items():
        errs = grad_errors(got, want)
        leaf = max(errs, key=errs.get)
        out[kind] = (leaf, errs[leaf])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_noise: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "limit": GRAD_TOL_DEVICES, "readings": {}}
    for name, variant in VARIANTS.items():
        per_seed = [readings(variant, s) for s in range(args.seeds)]
        result["readings"][name] = per_seed
        for kind in per_seed[0]:
            vals = [r[kind][1] for r in per_seed]
            worst = max(range(len(vals)), key=vals.__getitem__)
            print(f"{name} {kind}: max {max(vals):.4g} (seed {worst}, "
                  f"{per_seed[worst][kind][0]}), min {min(vals):.4g}; by "
                  "seed " + ", ".join(f"{v:.3g}" for v in vals), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
