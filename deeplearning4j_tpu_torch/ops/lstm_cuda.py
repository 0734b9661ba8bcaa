"""Fused LSTM kernels for Hopper, their plain PyTorch versions and their
autograd.

Counterpart of deeplearning4j_tpu/ops/lstm_pallas.py:

- ``fused_lstm_sequence`` (K1, csrc/lstm_fwd.cu) replaces
  ``_fwd_inference_kernel``: one LSTM over precomputed gate inputs.
- ``fused_lstm_sequence_train`` (K2, csrc/lstm_fwd.cu, training mode)
  replaces ``_fwd_kernel``: the same, plus the reserve space. Both on
  thread-block clusters that all-gather h through distributed shared
  memory where RW's columns fit (csrc/lstm_fwd_cluster.cuh, the same
  kernel template as K4's with one layer), else grid-wide.
- ``fused_lstm_backward`` (K3, csrc/lstm_bwd.cu) replaces ``_bwd_kernel``:
  the reverse-time backward over the reserve space, on thread-block
  clusters (csrc/lstm_cluster.cuh) where RW's slices fit, else grid-wide.
- ``fused_lstm2_sequence`` (K4, csrc/lstm2_fwd.cu) replaces
  ``_fwd2_kernel`` with ``save_reserve=False``: two stacked LSTMs on a
  wavefront; ``fused_lstm2_sequence_train`` (K4-train) with
  ``save_reserve=True``, its layer-2 reserves already unshifted. Both on
  thread-block clusters that all-gather h through distributed shared
  memory where the weights' columns fit, else grid-wide.
- ``FusedLSTM`` and ``FusedLSTM2`` are the ``torch.autograd.Function``s of
  ``_fused_fwd``/``_fused_bwd`` and ``_fused2_fwd``/``_fused2_bwd``: under
  grad the forward runs K2 (K4-train) and keeps the reserves, the backward
  runs K3 (twice for the pair) and leaves the weight gradients to batched
  ``torch.matmul``s. ``lstm_sequence``/``lstm2_sequence`` pick them when
  autograd is recording, else the inference kernels K1/K4.
- ``has_plan(entry, B, H, dtype, device)`` asks a kernel's C plan query
  whether it launches at a shape: the shape half of the layers' screens.

All keep the JAX package's contract: IFOG gate order,
``z = gate_in_t + h_{t-1} @ RW``, cell math in float32, float32 or bfloat16
streams (for bfloat16, h -- and in the backward dz -- is rounded to
bfloat16 before the product and the sum stays float32), outputs and
reserves in the stream dtype, dh0/dc0 of the backward in float32. The input
projection ``x @ W + b`` stays outside, as a ``torch.matmul`` in the layer.

On a CUDA tensor a wrapper launches its kernel or raises (for a shape
without a launch plan too); on a CPU tensor it
runs the plain version beside it, a Python time loop over the same float32
math. The kernels are built and loaded by ``ops/build.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import build

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_PTRS, _PLAN = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
# what every entry point reports of its launch: its route (the cluster
# kernel or the grid-wide one), its cluster plan and its grid
_PLAN_KEYS = ("route", "cluster_size", "clusters", "rows_per_cluster",
              "units_per_block", "unit_blocks", "batch_blocks", "threads",
              "k_slice", "shared_bytes")
_ROUTES = {1: "cluster", 0: "grid"}
# entry point -> (source stem, argtypes); every entry returns an int error
# code; the kernels' entries end with (device, stream, plan_out), their
# plan queries (``*_plan``: the same route choice, nothing launched) with
# (dtype, device, plan_out)
ENTRIES = {
    "lstm_fwd": ("lstm_fwd", [_VP] * 7 + [_INT] * 5 + [_VP, _PLAN]),
    "lstm_fwd_train": ("lstm_fwd", [_VP] * 7 + [_PTRS] + [_INT] * 5
                       + [_VP, _PLAN]),
    "lstm2_fwd": ("lstm2_fwd", [_PTRS] * 2 + [_VP] * 3 + [_INT] * 5
                  + [_VP, _PLAN]),
    "lstm2_fwd_train": ("lstm2_fwd", [_PTRS] * 3 + [_VP] * 2 + [_INT] * 5
                        + [_VP, _PLAN]),
    "lstm_bwd": ("lstm_bwd", [_PTRS] * 2 + [_VP] + [_INT] * 5 + [_VP, _PLAN]),
    "lstm_fwd_plan": ("lstm_fwd", [_INT] * 5 + [_PLAN]),
    "lstm2_fwd_plan": ("lstm2_fwd", [_INT] * 5 + [_PLAN]),
    "lstm_bwd_plan": ("lstm_bwd", [_INT] * 4 + [_PLAN]),
}
# kernel entry -> (its plan query, the query's leading arguments)
_QUERIES = {"lstm_fwd": ("lstm_fwd_plan", (0,)),
            "lstm_fwd_train": ("lstm_fwd_plan", (1,)),
            "lstm2_fwd": ("lstm2_fwd_plan", (0,)),
            "lstm2_fwd_train": ("lstm2_fwd_plan", (1,)),
            "lstm_bwd": ("lstm_bwd_plan", ())}
_ERR_NO_PLAN = -2                    # lstm::ERR_NO_PLAN (lstm_common.cuh)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAST_PLAN: Dict[str, dict] = {}
_HAS_PLAN: Dict[tuple, bool] = {}


def _lib(stem: str) -> ctypes.CDLL:
    return build.load(stem, {e: v[1] for e, v in ENTRIES.items()
                             if v[0] == stem}, "lstm_error")


def last_plan(name: str) -> dict:
    """Plan of the kernel's latest launch: its route ("cluster" or "grid"),
    on the cluster route the cluster size, the clusters and the batch rows
    each owns; units per block, blocks across units and batch, threads,
    depth of a staged slice of the contraction (grid route), shared
    bytes."""
    return dict(_LAST_PLAN.get(name, {}))


def has_plan(entry: str, B: int, H: int, dtype, device) -> bool:
    """Whether the kernel ``entry`` (a key of ``_QUERIES``) launches at
    batch B and hidden size H in ``dtype`` on ``device``, for any T: on the
    card its C plan query runs the route choice the launch runs, once per
    (entry, B, H, dtype, device) -- the answer is kept, since the host
    bounds every step. False only where the query answers that no launch
    plan fits; a failed build or any CUDA error raises. On the CPU the
    plain version takes every shape: True."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {dev}")
    key = (entry, B, H, dtype, dev.index or 0)
    hit = _HAS_PLAN.get(key)
    if hit is None:
        query, lead = _QUERIES[entry]
        lib = _lib(ENTRIES[entry][0])
        plan = (ctypes.c_int * len(_PLAN_KEYS))()
        rc = getattr(lib, query)(*lead, B, H, _DTYPE_CODE[dtype],
                                 dev.index or 0, plan)
        if rc not in (0, _ERR_NO_PLAN):
            raise RuntimeError(f"{query} failed: "
                               f"{lib.lstm_error(rc).decode()}")
        hit = _HAS_PLAN[key] = rc == 0
    return hit


def _check(name, dtype, device, **tensors):
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: stream dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, streams are {dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _launch(entry: str, *args) -> None:
    """Launch one kernel entry point on the current stream; raise on any
    error it returns, else count the launch."""
    lib = _lib(ENTRIES[entry][0])
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = getattr(lib, entry)(*args, plan)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel failed: "
                           f"{lib.lstm_error(rc).decode()}")
    _LAST_PLAN[entry] = dict(zip(_PLAN_KEYS, plan), route=_ROUTES[plan[0]])
    ops.count_launch(entry)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _tail(dt, dev):
    """The (dtype, device, stream) arguments every entry point ends with."""
    return (_DTYPE_CODE[dt], dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)


def _on_device(name, dev):
    """True for CUDA tensors (launch), False for CPU ones (plain version)."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


# ------------------------------------------------------------ plain math

def _cell_train(z, c, H):
    """Float32 cell math (lstm_pallas._cell_math): sigmoid over [i|f|o],
    tanh over g. Returns (h, c, tanh(c), gates)."""
    sp = torch.sigmoid(z[:, :3 * H])
    g = torch.tanh(z[:, 3 * H:])
    c = sp[:, H:2 * H] * c + sp[:, :H] * g
    tc = torch.tanh(c)
    return sp[:, 2 * H:3 * H] * tc, c, tc, torch.cat([sp, g], dim=-1)


def _gate_product(h, w, dt):
    """h @ W with h rounded to the stream dtype and a float32 sum (the
    products of two bfloat16 values are exact in float32)."""
    return h.to(dt).float() @ w.float()


def lstm_sequence_train_plain(gate_in, rw, h0, c0) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K2 (``_scan_fwd(save_reserve=True)``).
    Returns (hs, tc, cprev, gates, cT) in the stream dtype."""
    dt, H = gate_in.dtype, h0.shape[-1]
    T, B = gate_in.shape[:2]
    h, c = h0.float(), c0.float()
    kw = {"dtype": dt, "device": gate_in.device}
    hs, tcs, cprev = (torch.empty((T, B, H), **kw) for _ in range(3))
    gates = torch.empty((T, B, 4 * H), **kw)
    for t in range(T):
        cprev[t] = c.to(dt)
        h, c, tc, g = _cell_train(gate_in[t].float()
                                  + _gate_product(h, rw, dt), c, H)
        hs[t], tcs[t], gates[t] = h.to(dt), tc.to(dt), g.to(dt)
    return hs, tcs, cprev, gates, c.to(dt)


def lstm_backward_plain(gates, tc, cprev, rw, dhs, dcT
                        ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K3 (``_scan_bwd``). Returns dz (T, B, 4H) in
    the stream dtype and dh0, dc0 (B, H) in float32."""
    T, B, G = gates.shape
    H, dt = G // 4, gates.dtype
    rwt = rw.float().t()
    dz = torch.empty_like(gates)
    dh_rec = torch.zeros((B, H), dtype=torch.float32, device=gates.device)
    dc = dcT.float()
    for t in reversed(range(T)):
        gt = gates[t].float()
        i, f, o, g = (gt[:, k * H:(k + 1) * H] for k in range(4))
        tct, cp = tc[t].float(), cprev[t].float()
        dh = dhs[t].float() + dh_rec
        do = dh * tct
        dc = dc + dh * o * (1.0 - tct * tct)
        di, dg, df = dc * g, dc * i, dc * cp
        dz[t] = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                           do * o * (1.0 - o), dg * (1.0 - g * g)], dim=-1)
        dh_rec = dz[t].float() @ rwt
        dc = dc * f
    return dz, dh_rec, dc


def lstm2_sequence_train_plain(gate_in1, rw1, w2, b2, rw2, h01, c01, h02,
                               c02) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K4-train (``_fused2_fwd``'s forward, layer-2
    reserves unshifted). Returns (hs2, h1T, c1T, c2T, hs1, tc1, cp1, g1,
    tc2, cp2, g2) in the stream dtype."""
    dt, H = gate_in1.dtype, h01.shape[-1]
    T, B = gate_in1.shape[:2]
    h1, c1, h2, c2 = h01.float(), c01.float(), h02.float(), c02.float()
    b2f = b2.float()
    kw = {"dtype": dt, "device": gate_in1.device}
    hs2, hs1, tc1, cp1, tc2, cp2 = (torch.empty((T, B, H), **kw)
                                    for _ in range(6))
    g1, g2 = (torch.empty((T, B, 4 * H), **kw) for _ in range(2))
    for t in range(T):
        cp1[t] = c1.to(dt)
        h1, c1, tc, g = _cell_train(gate_in1[t].float()
                                    + _gate_product(h1, rw1, dt), c1, H)
        hs1[t], tc1[t], g1[t] = h1.to(dt), tc.to(dt), g.to(dt)
        z2 = _gate_product(h1, w2, dt) + b2f + _gate_product(h2, rw2, dt)
        cp2[t] = c2.to(dt)
        h2, c2, tc, g = _cell_train(z2, c2, H)
        hs2[t], tc2[t], g2[t] = h2.to(dt), tc.to(dt), g.to(dt)
    return (hs2, h1.to(dt), c1.to(dt), c2.to(dt), hs1, tc1, cp1, g1, tc2,
            cp2, g2)


def lstm_sequence_plain(gate_in, rw, h0, c0) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K1: K2's function without the reserves."""
    hs, _, _, _, cT = lstm_sequence_train_plain(gate_in, rw, h0, c0)
    return hs, cT


def lstm2_sequence_plain(gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K4: K4-train's function without the
    reserves. Returns (hs2, h1T, c1T, c2T)."""
    return lstm2_sequence_train_plain(gate_in1, rw1, w2, b2, rw2, h01, c01,
                                      h02, c02)[:4]


# --------------------------------------------------------------- wrappers

def _check_k1(name, gate_in, rw, h0, c0):
    T, B, G = gate_in.shape
    H = G // 4
    if G != 4 * H or T < 1 or tuple(rw.shape) != (H, G) \
            or tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
        raise ValueError(f"{name}: bad shapes gate_in "
                         f"{tuple(gate_in.shape)}, rw {tuple(rw.shape)}, h0 "
                         f"{tuple(h0.shape)}, c0 {tuple(c0.shape)}")
    _check(name, gate_in.dtype, gate_in.device, gate_in=gate_in, rw=rw, h0=h0,
           c0=c0)
    return T, B, H


def fused_lstm_sequence(gate_in, rw, h0, c0) -> Tuple[torch.Tensor, ...]:
    """One LSTM over precomputed gate inputs (K1).

    gate_in: (T, B, 4H) = x @ W + b, IFOG order; rw: (H, 4H); h0, c0:
    (B, H); one stream dtype, float32 or bfloat16. Returns (hs, c_last):
    hs (T, B, H) and the final cell state (B, H).

    On the card the kernel picks its route by shape: thread-block clusters
    that keep each block's columns of RW in shared memory and all-gather h
    through distributed shared memory where those columns fit, else the
    grid-wide kernel; ``last_plan("lstm_fwd")`` names the route taken."""
    T, B, H = _check_k1("fused_lstm_sequence", gate_in, rw, h0, c0)
    dev, dt = gate_in.device, gate_in.dtype
    if not _on_device("fused_lstm_sequence", dev):
        return lstm_sequence_plain(gate_in, rw, h0, c0)
    hs = torch.empty((T, B, H), dtype=dt, device=dev)
    cT = torch.empty((B, H), dtype=dt, device=dev)
    c_s = torch.empty((B, H), dtype=torch.float32, device=dev)
    _launch("lstm_fwd", gate_in.data_ptr(), rw.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), hs.data_ptr(), cT.data_ptr(), c_s.data_ptr(), T, B,
            H, *_tail(dt, dev))
    return hs, cT


def fused_lstm_sequence_train(gate_in, rw, h0, c0
                              ) -> Tuple[torch.Tensor, ...]:
    """K1's function plus the reserve space (K2), as
    ``_fwd_call(save_reserve=True)``: returns (hs, tc, cprev, gates, cT),
    tc and cprev (T, B, H), gates (T, B, 4H) post-activation. Routes as
    K1's (``last_plan("lstm_fwd_train")``)."""
    T, B, H = _check_k1("fused_lstm_sequence_train", gate_in, rw, h0, c0)
    dev, dt = gate_in.device, gate_in.dtype
    if not _on_device("fused_lstm_sequence_train", dev):
        return lstm_sequence_train_plain(gate_in, rw, h0, c0)
    hs, tc, cprev = (torch.empty((T, B, H), dtype=dt, device=dev)
                     for _ in range(3))
    gates = torch.empty((T, B, 4 * H), dtype=dt, device=dev)
    cT = torch.empty((B, H), dtype=dt, device=dev)
    c_s = torch.empty((B, H), dtype=torch.float32, device=dev)
    _launch("lstm_fwd_train", gate_in.data_ptr(), rw.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), hs.data_ptr(), cT.data_ptr(),
            c_s.data_ptr(), _ptrs([gates, tc, cprev]), T, B, H,
            *_tail(dt, dev))
    return hs, tc, cprev, gates, cT


def fused_lstm_backward(gates, tc, cprev, rw, dhs, dcT
                        ) -> Tuple[torch.Tensor, ...]:
    """Reverse-time LSTM backward over the reserve space (K3), as
    ``_bwd_call``: returns dz (T, B, 4H) in the stream dtype and dh0, dc0
    (B, H) in float32.

    On the card the kernel picks its route by shape: thread-block clusters
    exchanging partial products through distributed shared memory where a
    block's slice of RW fits its shared memory, else the grid-wide kernel;
    ``last_plan("lstm_bwd")`` names the route taken."""
    T, B, G = gates.shape
    H = G // 4
    state = {"tc": tc, "cprev": cprev, "dhs": dhs}
    if G != 4 * H or T < 1 or tuple(rw.shape) != (H, G) \
            or any(tuple(v.shape) != (T, B, H) for v in state.values()) \
            or tuple(dcT.shape) != (B, H):
        raise ValueError(f"fused_lstm_backward: bad shapes gates "
                         f"{tuple(gates.shape)}, rw {tuple(rw.shape)}, "
                         f"{ {k: tuple(v.shape) for k, v in state.items()} }, "
                         f"dcT {tuple(dcT.shape)}")
    dev, dt = gates.device, gates.dtype
    _check("fused_lstm_backward", dt, dev, gates=gates, rw=rw, dcT=dcT,
           **state)
    if not _on_device("fused_lstm_backward", dev):
        return lstm_backward_plain(gates, tc, cprev, rw, dhs, dcT)
    dz = torch.empty((T, B, G), dtype=dt, device=dev)
    dh0, dc0, dc_s = (torch.empty((B, H), dtype=torch.float32, device=dev)
                      for _ in range(3))
    _launch("lstm_bwd", _ptrs([gates, tc, cprev, rw, dhs, dcT]),
            _ptrs([dz, dh0, dc0]), dc_s.data_ptr(), T, B, H, *_tail(dt, dev))
    return dz, dh0, dc0


def _check_k4(name, gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02):
    T, B, G = gate_in1.shape
    H = G // 4
    mats = {"rw1": rw1, "w2": w2, "rw2": rw2}
    carries = {"h01": h01, "c01": c01, "h02": h02, "c02": c02}
    if G != 4 * H or T < 1 or tuple(b2.shape) != (G,) \
            or any(tuple(m.shape) != (H, G) for m in mats.values()) \
            or any(tuple(c.shape) != (B, H) for c in carries.values()):
        raise ValueError(f"{name}: bad shapes gate_in1 "
                         f"{tuple(gate_in1.shape)}, b2 {tuple(b2.shape)}, "
                         f"{ {k: tuple(v.shape) for k, v in mats.items()} }, "
                         f"{ {k: tuple(v.shape) for k, v in carries.items()} }")
    _check(name, gate_in1.dtype, gate_in1.device, gate_in1=gate_in1, b2=b2,
           **mats, **carries)
    return T, B, H


def fused_lstm2_sequence(gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02
                         ) -> Tuple[torch.Tensor, ...]:
    """Two stacked LSTMs over precomputed layer-1 gate inputs (K4).

    gate_in1: (T, B, 4H) = x @ W1 + b1; rw1, w2, rw2: (H, 4H); b2: (4H,);
    four (B, H) carries. Returns (hs2, h1T, c1T, c2T): the layer-2 hidden
    sequence (T, B, H) and the final states (h2T = hs2[-1]).

    On the card the kernel picks its route by shape: thread-block clusters
    that keep each block's columns of RW1, W2 and RW2 in shared memory and
    all-gather h through distributed shared memory where those columns fit,
    else the grid-wide kernel; ``last_plan("lstm2_fwd")`` names the route
    taken."""
    args = (gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02)
    T, B, H = _check_k4("fused_lstm2_sequence", *args)
    dev, dt = gate_in1.device, gate_in1.dtype
    if not _on_device("fused_lstm2_sequence", dev):
        return lstm2_sequence_plain(*args)
    hs2 = torch.empty((T, B, H), dtype=dt, device=dev)
    finals = [torch.empty((B, H), dtype=dt, device=dev) for _ in range(3)]
    h1buf = torch.empty((2, B, H), dtype=dt, device=dev)
    c_s = [torch.empty((B, H), dtype=torch.float32, device=dev)
           for _ in range(2)]
    outs = [hs2] + finals
    _launch("lstm2_fwd", _ptrs(args), _ptrs(outs), h1buf.data_ptr(),
            c_s[0].data_ptr(), c_s[1].data_ptr(), T, B, H, *_tail(dt, dev))
    return tuple(outs)


def fused_lstm2_sequence_train(gate_in1, rw1, w2, b2, rw2, h01, c01, h02,
                               c02) -> Tuple[torch.Tensor, ...]:
    """K4's function plus both layers' reserve space (K4-train). Returns
    (hs2, h1T, c1T, c2T, hs1, tc1, cp1, g1, tc2, cp2, g2), every stream
    indexed by unshifted time. Routes as K4's
    (``last_plan("lstm2_fwd_train")``)."""
    args = (gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02)
    T, B, H = _check_k4("fused_lstm2_sequence_train", *args)
    dev, dt = gate_in1.device, gate_in1.dtype
    if not _on_device("fused_lstm2_sequence_train", dev):
        return lstm2_sequence_train_plain(*args)
    kw = {"dtype": dt, "device": dev}
    hs2, hs1, tc1, cp1, tc2, cp2 = (torch.empty((T, B, H), **kw)
                                    for _ in range(6))
    g1, g2 = (torch.empty((T, B, 4 * H), **kw) for _ in range(2))
    finals = [torch.empty((B, H), **kw) for _ in range(3)]
    c_s = [torch.empty((B, H), dtype=torch.float32, device=dev)
           for _ in range(2)]
    outs = [hs2] + finals
    res = [hs1, tc1, cp1, g1, tc2, cp2, g2]
    _launch("lstm2_fwd_train", _ptrs(args), _ptrs(outs), _ptrs(res),
            c_s[0].data_ptr(), c_s[1].data_ptr(), T, B, H, *_tail(dt, dev))
    return tuple(outs + res)


# --------------------------------------------------------------- autograd

def _weight_grad(hs, dz, h0):
    """dRW = sum_t h_{t-1}^T dz_t in float32, h_{t-1} as slices of hs plus
    the h0 term (``_fused_bwd``: no shifted copy of hs)."""
    H, G = hs.shape[-1], dz.shape[-1]
    return (hs[:-1].reshape(-1, H).float().t() @ dz[1:].reshape(-1, G).float()
            + h0.float().t() @ dz[0].float())


class FusedLSTM(torch.autograd.Function):
    """``fused_lstm_sequence`` with its backward: K2 forward keeping the
    reserves, K3 backward, weight gradient as a batched matmul."""

    @staticmethod
    def forward(ctx, gate_in, rw, h0, c0):
        hs, tc, cprev, gates, cT = fused_lstm_sequence_train(gate_in, rw, h0,
                                                             c0)
        ctx.save_for_backward(rw, h0, hs, tc, cprev, gates)
        return hs, cT

    @staticmethod
    def backward(ctx, dhs, dcT):
        rw, h0, hs, tc, cprev, gates = ctx.saved_tensors
        dt = gates.dtype
        dz, dh0, dc0 = fused_lstm_backward(
            gates, tc, cprev, rw, dhs.to(dt).contiguous(),
            dcT.to(dt).contiguous())
        return (dz, _weight_grad(hs, dz, h0).to(rw.dtype), dh0.to(dt),
                dc0.to(dt))


class FusedLSTM2(torch.autograd.Function):
    """``fused_lstm2_sequence`` with its backward (``_fused2_bwd``): K4-train
    forward; K3 on layer 2, ``dh1 = dz2 @ W2^T`` (+ dh1T on the last step),
    K3 on layer 1, then the weight gradients as batched matmuls."""

    @staticmethod
    def forward(ctx, gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02):
        (hs2, h1T, c1T, c2T, hs1, tc1, cp1, g1, tc2, cp2,
         g2) = fused_lstm2_sequence_train(gate_in1, rw1, w2, b2, rw2, h01,
                                          c01, h02, c02)
        ctx.save_for_backward(rw1, w2, rw2, h01, h02, hs1, tc1, cp1, g1, hs2,
                              tc2, cp2, g2)
        return hs2, h1T, c1T, c2T

    @staticmethod
    def backward(ctx, dhs2, dh1T, dc1T, dc2T):
        (rw1, w2, rw2, h01, h02, hs1, tc1, cp1, g1, hs2, tc2, cp2,
         g2) = ctx.saved_tensors
        dt, G = g1.dtype, g1.shape[-1]
        dz2, dh02, dc02 = fused_lstm_backward(
            g2, tc2, cp2, rw2, dhs2.to(dt).contiguous(),
            dc2T.to(dt).contiguous())
        dh1 = dz2.float() @ w2.float().t()
        dh1[-1] += dh1T.float()
        dz1, dh01, dc01 = fused_lstm_backward(
            g1, tc1, cp1, rw1, dh1.to(dt).contiguous(),
            dc1T.to(dt).contiguous())
        H = hs1.shape[-1]
        dw2 = hs1.reshape(-1, H).float().t() @ dz2.reshape(-1, G).float()
        db2 = dz2.float().sum(dim=(0, 1))
        return (dz1, _weight_grad(hs1, dz1, h01).to(rw1.dtype),
                dw2.to(w2.dtype), db2.to(dt),
                _weight_grad(hs2, dz2, h02).to(rw2.dtype), dh01.to(dt),
                dc01.to(dt), dh02.to(dt), dc02.to(dt))


def autograd_records(*tensors) -> bool:
    """Whether autograd records an operation on these tensors: the
    condition under which the layers run the training kernels (K2, K4-train
    and K3) instead of the inference ones (K1, K4)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_sequence(gate_in, rw, h0, c0) -> Tuple[torch.Tensor, ...]:
    """``fused_lstm_sequence`` for the layers: through ``FusedLSTM`` (K2 +
    K3) when autograd records, else the inference kernel K1."""
    if autograd_records(gate_in, rw, h0, c0):
        return FusedLSTM.apply(gate_in, rw, h0, c0)
    return fused_lstm_sequence(gate_in, rw, h0, c0)


def lstm2_sequence(gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02
                   ) -> Tuple[torch.Tensor, ...]:
    """``fused_lstm2_sequence`` for the layers: through ``FusedLSTM2``
    (K4-train + K3) when autograd records, else the inference kernel K4."""
    args = (gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02)
    if autograd_records(*args):
        return FusedLSTM2.apply(*args)
    return fused_lstm2_sequence(*args)
