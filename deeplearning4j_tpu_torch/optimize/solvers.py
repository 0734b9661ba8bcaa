"""Second-order / line-search solvers.

Counterpart of deeplearning4j_tpu/optimize/solvers.py: the Armijo
``BackTrackLineSearch``, ``LineGradientDescent``, ``ConjugateGradient``
(Polak-Ribiere+), ``LBFGS`` (two-loop recursion, m=4) and the ``Solver``
facade, whose ``"sgd"`` delegates to the network's own ``fit``. They are
full-batch methods driven from the host, with the JAX package's loop,
defaults, failure contract and convergence test.

The parameters are one flat float vector (``ravel_params``: every tensor
of the per-layer dicts in order, the counterpart of ``ravel_pytree``),
unravelled into views of that vector for the loss. Value and gradient are
the container's ``_loss(params, x, y, mask_l, None, mask_f)`` -- no
dropout, no weight noise, the layer state written nowhere -- and
``torch.autograd.grad`` of it with respect to the vector: on the card
each probe is one eager forward and backward (on the TextGenerationLSTM
recipe net one K4-train and two K3). The direction algebra (the two-loop
recursion, the Polak-Ribiere beta) stays on the device; the line search's
tests read scalars on the host, as in JAX.

The JAX solver ends with ``net.params = unravel(x)``. The port's
parameters are updated in place (the fused update's flat buffers, which
captured steps and serving engines read by address), so the result is
copied INTO the network's tensors and ``_params_version`` is bumped: a
later ``fit`` starts from it, an engine that follows the network sees
it, and the updater state is kept, as JAX keeps it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def ravel_params(params) -> Tuple[torch.Tensor, List, callable]:
    """(flat vector, layout, unravel): the flat float32 (or the params'
    dtype) vector of every tensor of the per-layer dicts ``params`` in
    order, the layout ``[(layer, key, shape, numel)]`` and ``unravel(v)``,
    the per-layer dicts of views of ``v``."""
    layout = [(i, k, tuple(t.shape), t.numel())
              for i, p in enumerate(params) for k, t in p.items()]
    flat = (torch.cat([params[i][k].detach().reshape(-1)
                       for i, k, _, _ in layout]) if layout else
            torch.zeros(0))

    def unravel(v):
        out = [{} for _ in params]
        off = 0
        for i, k, shape, n in layout:
            out[i][k] = v[off:off + n].view(shape)
            off += n
        return out
    return flat, layout, unravel


class BackTrackLineSearch:
    """Armijo backtracking line search (parity:
    optimize/solvers/BackTrackLineSearch.java -- same defaults: c1-style
    sufficient-decrease test, step halving, maxIterations=5)."""

    def __init__(self, c1: float = 1e-4, rho: float = 0.5,
                 max_iterations: int = 5, initial_step: float = 1.0):
        self.c1 = c1
        self.rho = rho
        self.max_iterations = max_iterations
        self.initial_step = initial_step

    def optimize(self, vg, x, f0, g0, direction):
        """Returns (step, f_new, x_new, g_new). vg: vector -> (value,
        gradient)."""
        slope = float(torch.dot(g0, direction))
        if slope >= 0:          # not a descent direction -- reset handled above
            direction = -g0
            slope = float(torch.dot(g0, direction))
        alpha = self.initial_step
        best = None
        for _ in range(self.max_iterations):
            x_new = x + alpha * direction
            f_new, g_new = vg(x_new)
            f_new = float(f_new)
            if np.isfinite(f_new) and f_new <= f0 + self.c1 * alpha * slope:
                return alpha, f_new, x_new, g_new
            if np.isfinite(f_new) and (best is None or f_new < best[1]):
                best = (alpha, f_new, x_new, g_new)
            alpha *= self.rho
        # no probe satisfied Armijo: only accept a finite, strictly
        # improving fallback -- otherwise signal failure with step 0 (the
        # reference's BackTrackLineSearch failure contract)
        if best is not None and best[1] < f0:
            return best
        return (0.0, f0, x, g0)


class BaseSolver:
    """Shared full-batch iteration loop (parity: BaseOptimizer.java:171
    gradientAndScore + the optimize() template)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-5,
                 line_search: Optional[BackTrackLineSearch] = None):
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.line_search = line_search or BackTrackLineSearch()
        self.score_history = []

    def _setup(self, net, ds):
        x = net._as_input(ds.features)
        y = net._as_input(ds.labels)
        mf = None if ds.features_mask is None \
            else net._as_input(ds.features_mask)
        ml = None if ds.labels_mask is None else net._as_input(ds.labels_mask)
        flat0, layout, unravel = ravel_params(net.params)

        def vg(vec):
            with torch.enable_grad():
                v = vec.detach().requires_grad_(True)
                loss, _ = net._loss(unravel(v), x, y, ml, None, mf)
                (g,) = torch.autograd.grad(loss, v)
            return loss.detach(), g

        return flat0, layout, unravel, vg

    def optimize(self, net, ds):
        """Full-batch optimization of net's loss on ds; updates the net's
        parameters in place (module docstring). Returns True if converged
        by tolerance (parity: the boolean from ConjugateGradient /
        LBFGS.optimize)."""
        xv, layout, unravel, vg = self._setup(net, ds)
        f, g = vg(xv)
        f = float(f)
        self.score_history = [f]
        state = self._init_state(xv, g)
        converged = False
        for it in range(self.max_iterations):
            direction, state = self._direction(xv, g, state)
            step, f_new, x_new, g_new = self.line_search.optimize(
                vg, xv, f, g, direction)
            if step == 0.0:
                break
            state = self._post_step(state, xv, g, x_new, g_new)
            xv, g = x_new, g_new
            old_f, f = f, f_new
            self.score_history.append(f)
            net._score = f
            for lst in net.listeners:
                lst.iteration_done(net, it, net.epoch)
            if abs(old_f - f) < self.tolerance * max(1.0, abs(old_f)):
                converged = True
                break
        with torch.no_grad():
            for (i, k, _, _), t in zip(
                    layout, (t for p in unravel(xv) for t in p.values())):
                net.params[i][k].copy_(t)
        net._params_version += 1
        return converged

    # hooks ----------------------------------------------------------------
    def _init_state(self, x, g):
        return None

    def _direction(self, x, g, state):
        raise NotImplementedError

    def _post_step(self, state, x_old, g_old, x_new, g_new):
        return state


def _floor(t, eps=1e-30):
    return torch.clamp(t, min=eps)


class LineGradientDescent(BaseSolver):
    """Steepest descent + line search (parity:
    optimize/solvers/LineGradientDescent.java)."""

    def _direction(self, x, g, state):
        return -g, state


class ConjugateGradient(BaseSolver):
    """Nonlinear CG, Polak-Ribiere with automatic restart (parity:
    optimize/solvers/ConjugateGradient.java)."""

    def _init_state(self, x, g):
        return {"g_prev": g, "d_prev": -g, "first": True}

    def _direction(self, x, g, state):
        if state["first"]:
            state = dict(state, first=False)
            return -g, state
        gp = state["g_prev"]
        beta = float(torch.dot(g, g - gp) / _floor(torch.dot(gp, gp)))
        beta = max(beta, 0.0)    # PR+ restart
        d = -g + beta * state["d_prev"]
        return d, state

    def _post_step(self, state, x_old, g_old, x_new, g_new):
        # recompute direction next call from the new gradient
        d_prev = x_new - x_old   # direction actually taken (scaled)
        return {"g_prev": g_old, "d_prev": d_prev, "first": False}


class LBFGS(BaseSolver):
    """Limited-memory BFGS, two-loop recursion (parity:
    optimize/solvers/LBFGS.java -- same default memory m=4)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-5,
                 m: int = 4, line_search: Optional[BackTrackLineSearch] = None):
        super().__init__(max_iterations, tolerance, line_search)
        self.m = m

    def _init_state(self, x, g):
        return {"s": [], "y": []}

    def _direction(self, x, g, state):
        s_list, y_list = state["s"], state["y"]
        q = g
        alphas = []
        for s, y in zip(reversed(s_list), reversed(y_list)):
            rho = 1.0 / _floor(torch.dot(y, s))
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if y_list:
            y_last, s_last = y_list[-1], s_list[-1]
            gamma = torch.dot(s_last, y_last) / _floor(
                torch.dot(y_last, y_last))
            q = q * gamma
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return -q, state

    def _post_step(self, state, x_old, g_old, x_new, g_new):
        s = x_new - x_old
        y = g_new - g_old
        if float(torch.dot(s, y)) > 1e-10:   # curvature condition
            state["s"].append(s)
            state["y"].append(y)
            if len(state["s"]) > self.m:
                state["s"].pop(0)
                state["y"].pop(0)
        return state


_ALGOS = {
    "sgd": None,  # handled by the containers' captured minibatch step
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


class Solver:
    """Facade selecting the optimization algorithm (parity:
    optimize/Solver.java:43 .Builder). ``sgd`` delegates to the network's
    own minibatch train step; the others run full-batch on the given data."""

    def __init__(self, net, algorithm: str = "sgd", **kwargs):
        if algorithm not in _ALGOS:
            raise ValueError(
                f"unknown algorithm '{algorithm}'; one of {sorted(_ALGOS)}")
        self.net = net
        self.algorithm = algorithm
        self.kwargs = kwargs

    def optimize(self, ds):
        if self.algorithm == "sgd":
            self.net.fit(ds)
            return True
        solver = _ALGOS[self.algorithm](**self.kwargs)
        return solver.optimize(self.net, ds)
