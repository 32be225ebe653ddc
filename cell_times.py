#!/usr/bin/env python3
"""Times the bf16 wgmma/TMA ConvLSTM-cell kernel of the checkout it runs in,
on one NVIDIA GPU, at the shapes of the trainer's eval epoch, the planner
and the plan server: B = 16, 100, 200 and 400 (6x8 maps, Cx = C = 256),
k = 5 and 3.

    python3 cell_times.py [--save FILE] [--bits FILE]

The inputs (seed 7) and the CUDA-event timing are chip_smoke.py's, imported
from the same checkout. A copy of this script run from the root of another
checkout (say the parent commit, unpacked by `git archive`) times that
checkout's kernel on the same inputs, so two versions of the kernel are
compared in one call in turns: parent, change, change, parent. Each launch
is first held to the plain version (1e-2 absolute and relative) and must
take the wgmma/TMA kernel. `--save FILE` writes each shape's h' and c' to
FILE (torch.save); `--bits FILE` fails unless they equal those in FILE bit
for bit. Prints the card's name and power limit, then one JSON line
{"card": ..., "cell_ms": {"B=16 k=5": [ms, ms, ms], ...}, "bits": ...}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

import chip_smoke as smoke
from robot_aware_control_tpu_torch.ops import kernels

SHAPES = [(B, 6, 8, 256, 256, k) for B in (16, 100, 200, 400) for k in (5, 3)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", help="write the outputs to this file")
    ap.add_argument("--bits", help="compare the outputs with this file")
    args_ = ap.parse_args()
    if not torch.cuda.is_available():
        print("cell_times: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(card)
    times, outputs = {}, {}
    for shape in SHAPES:
        key = f"B={shape[0]} k={shape[-1]}"
        args = smoke.cell_inputs(*shape, torch.bfloat16, dev, 7)
        before = kernels.launches["conv_lstm_cell_sm90"]
        got = kernels.conv_lstm_cell(*args)
        if kernels.launches["conv_lstm_cell_sm90"] != before + 1:
            raise AssertionError(f"{shape} does not take the wgmma/TMA kernel")
        for g, w in zip(got, kernels.conv_lstm_cell_plain(*args)):
            torch.testing.assert_close(g.float(), w.float(), rtol=1e-2,
                                       atol=1e-2)
        outputs[key] = [t.cpu() for t in got]
        run = lambda: kernels.conv_lstm_cell(*args)
        times[key] = [smoke.cuda_ms(run) for _ in range(3)]
    bits = None
    if args_.bits:
        want = torch.load(args_.bits)
        differ = {key: [int((a.view(torch.int16) != b.view(torch.int16)).sum())
                        for a, b in zip(outputs[key], want[key])]
                  for key in outputs}
        bits = {"compared_with": args_.bits, "elements_differ": differ}
        if any(v for d in differ.values() for v in d):
            print(json.dumps({"card": card, "cell_ms": times, "bits": bits}))
            raise AssertionError(f"outputs differ from {args_.bits}: {differ}")
    if args_.save:
        torch.save(outputs, args_.save)
    print(json.dumps({"card": card, "cell_ms": times, "bits": bits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
