#!/usr/bin/env python3
"""How many digits the zoo's ResNet50 keeps in float32 training: the
port's two Sgd steps in float32 against the same two steps in float64,
from one set of weights and one batch.

    python3 tools/resnet_precision.py [--size 96] [--batch 4] \\
        [--lr 1e-2 1e-3 1e-4] [--device cpu]

Prints, for each learning rate, both runs' losses, their relative
differences, and the largest difference of BatchNormalization's running
statistics after the steps relative to each tensor's largest magnitude.
The configuration is the JAX package's (sigmoid convolutions, the global
default activation, before 53 batch normalizations); a large difference
at the second step with a small one at the first says the backward, not
the forward, loses the digits.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeplearning4j_tpu_torch import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.updaters import Sgd  # noqa: E402
from deeplearning4j_tpu_torch.zoo import ResNet50  # noqa: E402


def two_steps(base, conf, dtype, x, y, device):
    net = ComputationGraph(conf, device=device).set_params(
        {n: {k: v.to(dtype) for k, v in p.items()}
         for n, p in base.items()})
    losses = []
    for _ in range(2):
        net.fit([torch.tensor(x, dtype=dtype, device=device)],
                [torch.tensor(y, dtype=dtype, device=device)])
        losses.append(net.get_score())
    return losses, net.state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-2, 1e-3, 1e-4])
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    r = np.random.RandomState(4)
    x = r.rand(a.batch, a.size, a.size, 3)
    y = np.eye(1000)[r.randint(0, 1000, a.batch)]
    base = None
    for lr in a.lr:
        zoo = ResNet50(num_classes=1000, input_shape=(a.size, a.size, 3),
                       updater=Sgd(lr))
        if base is None:
            base = ComputationGraph(zoo.conf(), device=a.device).init().params
        runs = {}
        for name, dtype in (("float32", torch.float32),
                            ("float64", torch.float64)):
            conf = zoo.conf()
            conf.global_conf.dtype = name
            runs[name] = two_steps(base, conf, dtype, x, y, a.device)
        (l32, s32), (l64, s64) = runs["float32"], runs["float64"]
        rel = [abs(p - q) / abs(q) for p, q in zip(l32, l64)]
        state = max(float((s32[n][k].double() - s64[n][k]).abs().max()
                          / s64[n][k].abs().max())
                    for n in s64 for k in s64[n])
        print(f"size {a.size}, batch {a.batch}, lr {lr}: float32 losses "
              f"{l32}, float64 {l64}; relative difference {rel}; running "
              f"statistics {state:.3g} of each tensor's largest", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
