"""Numeric gradient checking.

Counterpart of deeplearning4j_tpu/util/gradient_check.py
(``gradient_check_fn``, ``gradient_check_network``; parity:
GradientCheckUtil.java:57): the autograd gradient against central finite
differences, element by element, on up to ``max_checks_per_array``
elements of each parameter tensor chosen with a seeded
``np.random.RandomState``, as in JAX.

Checks run in float64, as the JAX checker's do (it enables x64; central
differences at eps ~1e-6 drown in float32 rounding): every floating
parameter is copied to a float64 tensor on its own device, so a network
on the card is checked on the card and one on the CPU on the CPU. No CUDA
kernel takes float64 (the LSTM layers' screens send it to their own
loops), so the check holds the plain versions' autograd -- the oracle
each CUDA kernel is held against -- against finite differences.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.exec.executor import _leaves, _rebuild
from deeplearning4j_tpu_torch.nn.layers.base import map_tree


def _to64(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.to(torch.float64) if t.is_floating_point() else t


def gradient_check_fn(loss_fn, params, eps=1e-6, max_rel_error=1e-3,
                      min_abs_error=1e-8, max_checks_per_array=25, seed=0,
                      verbose=False):
    """Check d loss_fn / d params via central differences, in float64 on
    the parameters' device.

    loss_fn: params tree (dicts / lists of tensors) -> 0-dim tensor. Must
    be pure (no draws, no state written).
    Returns (n_failures, n_checked, max_rel_err_seen).
    """
    params = map_tree(_to64, params)
    leaves = _leaves(params, [])
    live = [t.clone().requires_grad_(t.is_floating_point()) for t in leaves]
    with torch.enable_grad():
        loss = loss_fn(_rebuild(params, iter(live)))
        wrt = [t for t in live if t.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for t in live:
        g = next(got) if t.requires_grad else None
        grads.append(torch.zeros_like(t) if g is None else g)
    rng = np.random.RandomState(seed)

    failures = 0
    checked = 0
    worst = 0.0
    with torch.no_grad():
        for li, (leaf, gleaf) in enumerate(zip(leaves, grads)):
            if not leaf.is_floating_point():
                continue
            arr = leaf.clone()
            flat = arr.view(-1)
            ganalytic = gleaf.reshape(-1).cpu().numpy()
            n = flat.numel()
            idxs = (np.arange(n) if n <= max_checks_per_array
                    else rng.choice(n, max_checks_per_array, replace=False))
            probe = list(leaves)
            probe[li] = arr
            for i in idxs:
                orig = float(flat[i])
                flat[i] = orig + eps
                plus = float(loss_fn(_rebuild(params, iter(probe))))
                flat[i] = orig - eps
                minus = float(loss_fn(_rebuild(params, iter(probe))))
                flat[i] = orig
                numeric = (plus - minus) / (2 * eps)
                analytic = float(ganalytic[i])
                denom = abs(numeric) + abs(analytic)
                abs_err = abs(numeric - analytic)
                rel = abs_err / denom if denom > 0 else 0.0
                checked += 1
                if rel > max_rel_error and abs_err > min_abs_error:
                    failures += 1
                    if verbose:
                        print(f"  leaf {li} idx {i}: analytic={analytic:.3e} "
                              f"numeric={numeric:.3e} rel={rel:.3e}")
                worst = max(worst, rel if abs_err > min_abs_error else 0.0)
    return failures, checked, worst


def gradient_check_network(net, x, y, eps=1e-5, max_rel_error=1e-3,
                           min_abs_error=1e-7, max_checks_per_array=20,
                           verbose=False):
    """Gradient-check a MultiLayerNetwork's full loss (l1/l2 included)
    with respect to all its parameters (parity:
    GradientCheckUtil.checkGradients), in float64 on the network's
    device."""
    x = torch.as_tensor(np.asarray(x), device=net.device)
    x = x if x.dtype == torch.int32 else x.to(torch.float64)
    y = torch.as_tensor(np.asarray(y), device=net.device).to(torch.float64)

    def loss_fn(params):
        loss, _ = net._loss(params, x, y)
        return loss

    return gradient_check_fn(loss_fn, net.params, eps, max_rel_error,
                             min_abs_error, max_checks_per_array, 0, verbose)
