"""Fused optimizer update: one flat update per group of layers instead of
one updater chain per parameter tensor.

Counterpart of deeplearning4j_tpu/nn/fused_update.py (``FusedUpdate``,
``build_fused_update``, ``fused_update_enabled`` / ``set_fused_update``,
the same ``DL4JTPU_FUSED_UPDATE`` switch). Members (layers, or graph nodes)
that share an updater configuration and a dtype form a group; the group's
transform runs once over its members' parameters raveled into one vector.
Every shipped updater stage is elementwise, so the fused math is bitwise
the per-member loop's: concatenation commutes with elementwise operations.
A chain that reduces across parameters (``ClipByGlobalNorm``) would not
commute; the caller marks such members with a ``None`` group key and they
keep per-member math, as do members whose tensors mix dtypes. Members
without parameters pass through.

Where the JAX package concatenates the leaves inside every traced step,
here the concatenation is the storage: ``build_fused_update`` copies each
group's parameters into one flat buffer, and each parameter-shaped state
slot (``.mu``, ``.nu``, ``.trace``, ...) into one flat buffer per slot,
and rebinds the members' per-layer dicts to views into those buffers. The
rest of the package, and the checkpoint, keep seeing per-layer dicts under
the same keys (``0/.mu/W``, ``1/.count``; a wrapper's nested parameters
as path keys, ``0/.mu/fwd/W``); the update writes in place into
the flat buffers, the counterpart of donation, so a captured CUDA graph of
a step keeps its addresses. A group's update is a fixed number of
launches, whatever the number of layers: one ``torch.cat`` of the
gradients, the transform's elementwise operations, and one copy back per
buffer; constraints then apply per layer on the views, as in JAX.

The counts stay int32 scalars on the host, one per member, equal within a
group (the first member's is read, as in JAX). ``stage`` computes the
count-derived scalars of every group and fallback member on the host and
copies them into one small device buffer in one copy; ``apply`` (the
device half, which a graph can replay) reads them from 0-dim views of that
buffer; ``advance`` adds one to the counts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.updaters import Transform

_OVERRIDE: Optional[bool] = None


def fused_update_enabled() -> bool:
    """Fused updates are on by default; ``DL4JTPU_FUSED_UPDATE=0`` (env)
    or ``set_fused_update(False)`` selects the per-layer loop. Read when a
    container builds its optimizer: call ``_build_optimizer()`` (or
    ``init``/``set_params``) after toggling."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    return os.environ.get("DL4JTPU_FUSED_UPDATE", "1").lower() not in (
        "0", "false", "off", "no")


def set_fused_update(flag: Optional[bool]) -> None:
    """Process-wide override (None restores the env default); rebuild the
    optimizers after."""
    global _OVERRIDE
    _OVERRIDE = flag


def _split_key(key: str, names) -> Tuple[str, Optional[str]]:
    """A state key as (slot path, parameter name): ``0/.mu/W`` ->
    (``0/.mu``, ``W``), ``0/.mu/fwd/W`` -> (``0/.mu``, ``fwd/W``) for a
    wrapper's path-keyed parameter; a scalar slot such as ``0/.count`` ->
    (key, None)."""
    for name in sorted(names, key=len, reverse=True):
        if key.endswith("/" + name) and len(key) > len(name) + 1:
            return key[:-len(name) - 1], name
    return key, None


@dataclass
class _Group:
    """Members fused into one flat transform (same updater config+dtype)."""
    transform: Transform
    members: List[Any]                   # member keys, in build order
    dtype: torch.dtype
    flat: torch.Tensor                   # the members' parameters, raveled
    slots: Dict[str, torch.Tensor]       # slot path -> flat state buffer
    layout: List[Tuple[Any, str]]        # (member, parameter) in flat order
    counts: List[str]                    # the scalar slots (counts)
    sc: List[torch.Tensor]               # its scalars, views of the buffer


@dataclass
class FusedUpdate:
    """Grouped, in-place update plan for one model's parameters and
    updater state (dicts keyed like the build-time dicts, whose inner
    dicts it rebound to views)."""
    groups: List[_Group]
    fallback: List[Any]                  # keys updated with per-member math
    passthrough: List[Any]               # empty-params keys (left as they are)
    transforms: Dict[Any, Transform]
    constraints: Dict[Any, Callable]
    scalars: torch.Tensor                # the staged count-derived scalars
    fallback_sc: Dict[Any, List[torch.Tensor]]

    @property
    def fused_keys(self) -> List[Any]:
        return [k for g in self.groups for k in g.members]

    # ---------------------------------------------------------- host halves
    def stage(self, opt_state: Dict) -> None:
        """Copy the next update's scalars into the device buffer -- every
        group's (from its first member's counts), then every fallback
        member's -- in one copy, from pinned memory and without a host
        sync on the card."""
        vals = [v for g in self.groups
                for v in g.transform.scalars(opt_state[g.members[0]])]
        for k in self.fallback:
            vals += self.transforms[k].scalars(opt_state[k])
        if not vals:
            return
        host = torch.tensor(vals, dtype=torch.float32)
        if self.scalars.is_cuda:
            self.scalars[:len(vals)].copy_(host.pin_memory(),
                                           non_blocking=True)
        else:
            self.scalars[:len(vals)].copy_(host)

    def advance(self, opt_state: Dict) -> None:
        """After an update: every member's counts one more (host only)."""
        for g in self.groups:
            new = g.transform.advance(opt_state[g.members[0]])
            for k in g.members:
                for c in g.counts:
                    opt_state[k][c] = new[c].clone()
        for k in self.fallback:
            opt_state[k].update(self.transforms[k].advance(opt_state[k]))

    # ------------------------------------------------------------ device half
    @torch.no_grad()
    def apply(self, params: Dict, opt_state: Dict, grads: Dict) -> None:
        """The update, in place into the parameters and state, reading the
        staged scalars: what a captured step replays."""
        for k in self.fallback:
            p, o = params[k], opt_state[k]
            u, slots = self.transforms[k].apply(grads[k], o, p,
                                                self.fallback_sc[k])
            _write(p, self.constraints[k](
                {n: (v + u[n]).to(v.dtype) for n, v in p.items()}))
            _write(o, slots)
        for g in self.groups:
            self._apply_group(g, params, grads)

    def _apply_group(self, g: _Group, params: Dict, grads: Dict) -> None:
        parts = [grads[k][n].reshape(-1) for k, n in g.layout]
        gf = torch.cat(parts) if len(parts) > 1 else parts[0]
        state = {f"{path}/flat": buf for path, buf in g.slots.items()}
        u, new = g.transform.apply({"flat": gf}, state, {"flat": g.flat},
                                   g.sc)
        g.flat.copy_((g.flat + u["flat"]).to(g.dtype))
        for path, buf in g.slots.items():
            buf.copy_(new[f"{path}/flat"])
        for k in g.members:
            _write(params[k], self.constraints[k](params[k]))


def _write(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    """Copy each tensor of ``src`` into ``dst``'s tensor of that key, in
    place, unless it already is that tensor."""
    for n, t in src.items():
        if t is not dst[n]:
            dst[n].copy_(t)


def _identity(p):
    return p


def _flatten_into(tensors: List[torch.Tensor], dtype, device
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One flat buffer holding ``tensors`` in order, and a view of it shaped
    like each."""
    total = sum(t.numel() for t in tensors)
    flat = torch.empty(total, dtype=dtype, device=device)
    views, off = [], 0
    for t in tensors:
        n = t.numel()
        v = flat[off:off + n].view(t.shape)
        v.copy_(t)
        views.append(v)
        off += n
    return flat, views


def build_fused_update(params: Dict, opt_state: Dict, transforms: Dict,
                       group_keys: Dict, constraints: Optional[Dict] = None
                       ) -> FusedUpdate:
    """Group members by (group key, dtype) into a :class:`FusedUpdate`.

    ``params`` / ``opt_state`` / ``transforms`` / ``group_keys`` are dicts
    over the same member keys; each params and opt_state value is a dict
    of tensors (``transforms[k].init`` of the params). ``group_keys[k]`` is
    any hashable describing the updater configuration (the containers use
    the updater's sorted-JSON dict): members fuse only when the key and
    every parameter's dtype match. ``None`` marks a member non-fusable
    (cross-leaf clipping); members without parameters or without a
    transform (a frozen layer) pass through.

    Each group's parameters and parameter-shaped state move into flat
    buffers, and the entries of ``params[k]`` / ``opt_state[k]`` become
    views of them (the dicts are modified in place, so a container's lists
    and dicts of them see the views)."""
    constraints = constraints or {}
    buckets: Dict[Tuple, List[Any]] = {}
    fallback: List[Any] = []
    passthrough: List[Any] = []
    device = None
    for k, p in params.items():
        if not p or transforms.get(k) is None:
            passthrough.append(k)
            continue
        device = device or next(iter(p.values())).device
        gk = group_keys.get(k)
        dtypes = {v.dtype for v in p.values()}
        if gk is None or len(dtypes) != 1:
            fallback.append(k)
            continue
        buckets.setdefault((gk, next(iter(dtypes))), []).append(k)

    n_sc = (sum(transforms[m[0]].n_scalars for m in buckets.values())
            + sum(transforms[k].n_scalars for k in fallback))
    scalars = torch.zeros(max(n_sc, 1), dtype=torch.float32,
                          device=device or torch.device("cpu"))
    views = [scalars[j] for j in range(n_sc)]
    groups = []
    for (_, dtype), members in buckets.items():
        t = transforms[members[0]]
        layout = [(k, n) for k in members for n in params[k]]
        flat, pviews = _flatten_into([params[k][n] for k, n in layout],
                                     dtype, device)
        for (k, n), v in zip(layout, pviews):
            params[k][n] = v
        paths, counts = [], []
        for key in opt_state[members[0]]:
            path, name = _split_key(key, params[members[0]])
            if name is None:
                counts.append(key)
            elif path not in paths:
                paths.append(path)
        slots = {}
        for path in paths:
            buf, sviews = _flatten_into(
                [opt_state[k][f"{path}/{n}"] for k, n in layout], dtype,
                device)
            for (k, n), v in zip(layout, sviews):
                opt_state[k][f"{path}/{n}"] = v
            slots[path] = buf
        groups.append(_Group(t, members, dtype, flat, slots, layout, counts,
                             views[:t.n_scalars]))
        views = views[t.n_scalars:]
    fallback_sc = {}
    for k in fallback:
        n = transforms[k].n_scalars
        fallback_sc[k], views = views[:n], views[n:]
    return FusedUpdate(groups=groups, fallback=fallback,
                       passthrough=passthrough, transforms=dict(transforms),
                       constraints={k: constraints.get(k, _identity)
                                    for k in params},
                       scalars=scalars, fallback_sc=fallback_sc)
