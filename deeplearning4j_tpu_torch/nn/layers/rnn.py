"""Recurrent layers: LSTM, GravesLSTM, SimpleRnn, the wrappers
Bidirectional, GravesBidirectionalLSTM and LastTimeStep, RnnOutputLayer
and RnnLossLayer.

Counterpart of deeplearning4j_tpu/nn/layers/rnn.py. The input-to-gate
projection for the whole sequence is one (B*T, C) x (C, 4H)
``torch.matmul`` outside the time loop; the loop itself is the fused
kernel whenever the layer's configuration is the one the kernel computes,
no feature mask is given, and, on the card, every kernel the path launches
has a launch plan at the layer's batch and width: ``ops.lstm_sequence``
(``ops.lstm2_sequence`` for two stacked layers), which runs the inference
kernel K1 (K4) under ``no_grad`` and the training kernels K2 (K4-train)
with the backward K3 when autograd records. Other configurations, masked
batches and shapes without a plan run the layer's own ``_cell`` loop,
which autograd differentiates; a pair the wavefront kernel does not take
runs as two single layers, each screened again, as the JAX package's pair
does. GravesLSTM (peepholes) and SimpleRnn always run their own loop, as
in the JAX package. A mask blends each step: where it is 0 the carry
stays what it was. Parameter keys: ``W`` input weights, ``RW`` recurrent
weights, ``b`` bias, gate order IFOG; GravesLSTM adds ``pW``; a
Bidirectional layer's are ``{"fwd": {...}, "bwd": {...}}``.

Dropout acts on a layer's input at train time (``Layer.maybe_dropout``),
except in ``apply_with_carry`` (truncated BPTT's chunks, ``rnn_time_step``),
which drops nothing, as the JAX layer's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.dropout import SameDraws
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (register_layer,
                                                     require_dims, Layer)
from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import lstm_cuda

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the kernels a single layer (a pair) launches, by whether autograd records
_SINGLE_KERNELS = {False: ("lstm_fwd",), True: ("lstm_fwd_train", "lstm_bwd")}
_PAIR_KERNELS = {False: ("lstm2_fwd",), True: ("lstm2_fwd_train", "lstm_bwd")}


def _kernels_take(entries, B, H, dt, device) -> bool:
    """The shape half of the screens: every kernel of ``entries`` has a
    launch plan at (B, H) in dt on ``device`` (always on the CPU, whose
    plain versions take every shape)."""
    return all(lstm_cuda.has_plan(e, B, H, dt, device) for e in entries)


def _gate_inputs(params, x, dt):
    """x @ W + b for the whole sequence, time-major: (T, B, 4H) in dt."""
    B, T, _ = x.shape
    gate_in = x.reshape(B * T, -1) @ params["W"] + params["b"]
    return gate_in.reshape(B, T, -1).transpose(0, 1).to(dt).contiguous()


@register_layer
@dataclass
class LSTM(Layer):
    """Standard LSTM (no peepholes). Gate order [i, f, o, g]."""
    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.size or input_type.flat_size()

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in, n_out=self.n_out)
        H = self.n_out
        b = torch.zeros((4 * H,), dtype=dtype, device=device)
        b[H:2 * H] = self.forget_gate_bias_init
        return {
            "W": init_weights(gen, (self.n_in, 4 * H),
                              self.weight_init or "xavier", self.dist, dtype,
                              fan_in=self.n_in, fan_out=H, device=device),
            "RW": init_weights(gen, (H, 4 * H), self.weight_init or "xavier",
                               self.dist, dtype, fan_in=H, fan_out=H,
                               device=device),
            "b": b,
        }

    def _cell(self, params, gate_in_t, h, c, mask_t=None):
        """One step of the layer's own math (any activations); ``mask_t``
        (B,) blends the new carry with the old."""
        H = self.n_out
        act = get_activation(self.activation or "tanh")
        gact = get_activation(self.gate_activation)
        z = gate_in_t + h @ params["RW"]
        i = gact(z[:, 0 * H:1 * H])
        f = gact(z[:, 1 * H:2 * H])
        o = gact(z[:, 2 * H:3 * H])
        g = act(z[:, 3 * H:4 * H])
        c_new = f * c + i * g
        h_new = o * act(c_new)
        return _blend(h_new, c_new, h, c, mask_t)

    def fused_supported(self, dt, batch, device, recording,
                        mask=None) -> bool:
        """The configuration the fused kernel computes (the cuDNN-parity
        screen of the JAX package): plain LSTM, sigmoid gates, tanh cell,
        float32 or bfloat16, no feature mask; and its shape half: on the
        card, a launch plan at this batch and width for every kernel the
        path launches (K1, or K2 and K3 when autograd is ``recording``).
        Anything else runs the layer's own loop."""
        return (mask is None and type(self) is LSTM
                and self.gate_activation == "sigmoid"
                and (self.activation or "tanh") == "tanh"
                and dt in _KERNEL_DTYPES
                and _kernels_take(_SINGLE_KERNELS[recording], batch,
                                  self.n_out, dt, device))

    def _scan(self, params, x, mask, h0, c0):
        dt = h0.dtype
        gate_in = _gate_inputs(params, x, dt)
        rw, h0, c0 = params["RW"].to(dt).contiguous(), h0.contiguous(), \
            c0.contiguous()
        if self.fused_supported(
                dt, x.shape[0], x.device,
                lstm_cuda.autograd_records(gate_in, rw, h0, c0), mask):
            hs, c_last = ops.lstm_sequence(gate_in, rw, h0, c0)
            return hs.transpose(0, 1), (hs[-1], c_last)
        h, c, hs = h0, c0, []
        for t in range(gate_in.shape[0]):
            h, c = self._cell(params, gate_in[t], h, c,
                              None if mask is None else mask[:, t])
            hs.append(h)
        return torch.stack(hs, dim=1), (h, c)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        return self.apply_with_carry(params, x, mask=mask)[0]

    def apply_with_carry(self, params, x, carry=None, mask=None):
        """Run from a carried state (parity: rnnTimeStep, and the chunks of
        truncated BPTT), with no dropout: returns (y, (h, c))."""
        if carry is None:
            dt = torch.promote_types(x.dtype, params["W"].dtype)
            z = torch.zeros((x.shape[0], self.n_out), dtype=dt,
                            device=x.device)
            carry = (z, z)
        return self._scan(params, x, mask, carry[0], carry[1])

    # ---- incremental decode ----------------------------------------------
    def init_decode_state(self, params, batch, max_len=0,
                          dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())

    def decode_step(self, params, dstate, x, pos=None):
        """One plain cell step on x (B, 1, C)."""
        h, c = dstate
        gate_in = x[:, 0, :] @ params["W"] + params["b"]
        h, c = self._cell(params, gate_in, h, c)
        return h[:, None, :], (h, c)


def _blend(h_new, c_new, h, c, mask_t):
    """The step's carry where ``mask_t`` (B,) is 1, the old one where it
    is 0, pinned to the carry's dtype after the blend (a float32 mask
    must not promote a bfloat16 carry)."""
    if mask_t is not None:
        m = mask_t[:, None]
        h_new = m * h_new + (1 - m) * h
        c_new = m * c_new + (1 - m) * c
    return h_new.to(h.dtype), c_new.to(c.dtype)


def lstm_pair_fusable(l1, l2, p1, p2, x, mask=None) -> bool:
    """True when two consecutive LSTM layers run as ONE wavefront kernel
    (ops.fused_lstm2_sequence): both pass their own fused screen with the
    promoted dtype (so no feature mask), equal widths, nothing sits
    between the layers (no dropout on layer 2 -- an ``IDropout`` object is
    truthy and blocks too, as in the JAX package -- and no weight noise on
    either), and on the card the wavefront kernels the path launches (K4,
    or K4-train and K3 when autograd records) have a launch plan at this
    batch and width. Otherwise the caller runs the two layers one by
    one."""
    if mask is not None:
        return False
    if not (type(l1) is LSTM and type(l2) is LSTM
            and l1.n_out == l2.n_out and l2.n_in == l1.n_out
            and not l2.dropout
            and l1.weight_noise is None and l2.weight_noise is None):
        return False
    dt = torch.promote_types(torch.promote_types(x.dtype, p1["W"].dtype),
                             p2["W"].dtype)
    B, dev = x.shape[0], x.device
    rec = lstm_cuda.autograd_records(
        x, *(p[k] for p in (p1, p2) for k in ("W", "RW", "b")))
    return (l1.fused_supported(dt, B, dev, rec)
            and l2.fused_supported(dt, B, dev, rec)
            and _kernels_take(_PAIR_KERNELS[rec], B, l1.n_out, dt, dev))


def apply_lstm_pair(l1, l2, p1, p2, x, *, train=False, gen=None):
    """Run two fusable stacked LSTMs through the wavefront kernel, layer
    1's dropout on ``x``; returns the layer-2 hidden sequence (B, T, H)."""
    x = l1.maybe_dropout(x, train=train, gen=gen)
    dt = torch.promote_types(torch.promote_types(x.dtype, p1["W"].dtype),
                             p2["W"].dtype)
    gate_in1 = _gate_inputs(p1, x, dt)
    z = torch.zeros((x.shape[0], l1.n_out), dtype=dt, device=x.device)
    hs2, _, _, _ = ops.lstm2_sequence(
        gate_in1, p1["RW"].to(dt).contiguous(), p2["W"].to(dt).contiguous(),
        p2["b"].to(dt).contiguous(), p2["RW"].to(dt).contiguous(), z, z, z, z)
    return hs2.transpose(0, 1)


@register_layer
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013; parity:
    nn/conf/layers/GravesLSTM.java). Peephole weights ``pW`` (3H,): the
    input and forget gates see c_{t-1}, the output gate c_t. Always its
    own loop."""

    def init(self, gen, dtype=torch.float32, device=None):
        p = super().init(gen, dtype, device)
        p["pW"] = torch.zeros((3 * self.n_out,), dtype=dtype, device=device)
        return p

    def _cell(self, params, gate_in_t, h, c, mask_t=None):
        H = self.n_out
        act = get_activation(self.activation or "tanh")
        gact = get_activation(self.gate_activation)
        pw = params["pW"]
        z = gate_in_t + h @ params["RW"]
        i = gact(z[:, 0 * H:1 * H] + c * pw[0 * H:1 * H])
        f = gact(z[:, 1 * H:2 * H] + c * pw[1 * H:2 * H])
        g = act(z[:, 3 * H:4 * H])
        c_new = f * c + i * g
        o = gact(z[:, 2 * H:3 * H] + c_new * pw[2 * H:3 * H])
        h_new = o * act(c_new)
        return _blend(h_new, c_new, h, c, mask_t)


@register_layer
@dataclass
class SimpleRnn(Layer):
    """Vanilla RNN: h_t = act(x_t W + h_{t-1} RW + b), its own loop. Like
    the JAX layer it has a decode step but no carried ``apply_with_carry``,
    so ``rnn_time_step`` runs each call from a zero state."""
    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.size or input_type.flat_size()

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in, n_out=self.n_out)
        wi = self.weight_init or "xavier"
        return {
            "W": init_weights(gen, (self.n_in, self.n_out), wi, self.dist,
                              dtype, device=device),
            "RW": init_weights(gen, (self.n_out, self.n_out), wi, self.dist,
                               dtype, device=device),
            "b": torch.zeros((self.n_out,), dtype=dtype, device=device),
        }

    def _step(self, params, g, h, mask_t=None):
        h_new = get_activation(self.activation or "tanh")(g + h @ params["RW"])
        if mask_t is not None:
            m = mask_t[:, None]
            h_new = m * h_new + (1 - m) * h
        return h_new.to(h.dtype)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        B, T, _ = x.shape
        gate_in = (x.reshape(B * T, -1) @ params["W"]
                   + params["b"]).reshape(B, T, -1)
        h = torch.zeros((B, self.n_out),
                        dtype=torch.promote_types(x.dtype, params["W"].dtype),
                        device=x.device)
        hs = []
        for t in range(T):
            h = self._step(params, gate_in[:, t], h,
                           None if mask is None else mask[:, t])
            hs.append(h)
        return torch.stack(hs, dim=1)

    def init_decode_state(self, params, batch, max_len=0,
                          dtype=torch.float32, device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def decode_step(self, params, dstate, x, pos=None):
        h = self._step(params, x[:, 0, :] @ params["W"] + params["b"], dstate)
        return h[:, None, :], h


@register_layer
@dataclass
class Bidirectional(Layer):
    """Bidirectional wrapper (parity: nn/conf/layers/recurrent/
    Bidirectional): the wrapped layer over the sequence and, with its own
    parameters, over the time-reversed sequence; mode concat | add | mul |
    ave. Both directions get the same dropout draw, as the JAX layer
    passes both the same key."""
    fwd: Optional[Layer] = None
    mode: str = "concat"

    def set_n_in(self, input_type):
        self.fwd.set_n_in(input_type)

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        if self.fwd is not None:
            self.fwd.apply_defaults(defaults)

    def output_type(self, input_type):
        ot = self.fwd.output_type(input_type)
        if self.mode == "concat":
            return InputType.recurrent(ot.size * 2, ot.timeseries_length)
        return ot

    def init(self, gen, dtype=torch.float32, device=None):
        return {"fwd": self.fwd.init(gen, dtype, device),
                "bwd": self.fwd.init(gen, dtype, device)}

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        same = SameDraws(gen) if train and gen is not None else gen
        yf = self.fwd.apply(params["fwd"], x, train=train, gen=same,
                            mask=mask)
        if isinstance(same, SameDraws):
            same.replay()
        xr = torch.flip(x, (1,))
        mr = None if mask is None else torch.flip(mask, (1,))
        yb = torch.flip(self.fwd.apply(params["bwd"], xr, train=train,
                                       gen=same, mask=mr), (1,))
        if self.mode == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.mode == "add":
            return yf + yb
        if self.mode == "mul":
            return yf * yb
        if self.mode == "ave":
            return 0.5 * (yf + yb)
        raise ValueError(self.mode)

    def decode_step(self, params, dstate, x, pos=None):
        raise ValueError(
            "Bidirectional layers consume the whole sequence (the backward "
            "direction reads future tokens) and cannot decode incrementally")


@register_layer
@dataclass
class GravesBidirectionalLSTM(Layer):
    """Legacy bidirectional Graves LSTM (parity: nn/conf/layers/
    GravesBidirectionalLSTM.java): a Bidirectional GravesLSTM in "add"
    mode. The inner layer takes only the activation and initialisation,
    as in the JAX package, so this layer drops nothing."""
    n_in: int = 0
    n_out: int = 0

    def __post_init__(self):
        self._bi = None

    def _build(self):
        if self._bi is None:
            inner = GravesLSTM(n_in=self.n_in, n_out=self.n_out,
                               activation=self.activation,
                               weight_init=self.weight_init, dist=self.dist)
            self._bi = Bidirectional(fwd=inner, mode="add")
        return self._bi

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.size or input_type.flat_size()

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def init(self, gen, dtype=torch.float32, device=None):
        return self._build().init(gen, dtype, device)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return self._build().apply(params, x, train=train, gen=gen, mask=mask)

    def decode_step(self, params, dstate, x, pos=None):
        return self._build().decode_step(params, dstate, x, pos)


@register_layer
@dataclass
class LastTimeStep(Layer):
    """Wrapper: the wrapped recurrent layer's output at the last step, or
    with a mask at each row's last set step (0 for an all-zero row)."""
    fwd: Optional[Layer] = None

    def set_n_in(self, input_type):
        self.fwd.set_n_in(input_type)

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        if self.fwd is not None:
            self.fwd.apply_defaults(defaults)

    def output_type(self, input_type):
        return InputType.feed_forward(self.fwd.output_type(input_type).size)

    def init(self, gen, dtype=torch.float32, device=None):
        return self.fwd.init(gen, dtype, device)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        y = self.fwd.apply(params, x, train=train, gen=gen, mask=mask)
        if mask is None:
            return y[:, -1, :]
        T = mask.shape[1]
        setm = mask > 0
        idx = T - 1 - torch.flip(setm, (1,)).to(torch.int32).argmax(dim=1)
        idx = torch.where(setm.any(dim=1), idx, torch.zeros_like(idx))
        return y[torch.arange(y.shape[0], device=y.device), idx, :]

    def decode_step(self, params, dstate, x, pos=None):
        raise ValueError(
            "LastTimeStep collapses the time axis; it has no per-token "
            "incremental form")


@register_layer
@dataclass
class RnnOutputLayer(OutputLayer):
    """Time-distributed output layer over (B, T, C)."""

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self.activation or "softmax")(y)


@register_layer
@dataclass
class RnnLossLayer(Layer):
    """Parameterless time-distributed loss over (B, T, C)."""
    loss: str = "mcxent"

    def has_params(self):
        return False

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return get_activation(self.activation or "identity")(x)

    def compute_score(self, params, x, labels, mask=None, *, train=False,
                      gen=None):
        B, T = x.shape[0], x.shape[1]
        return get_loss(self.loss)(
            labels.reshape(B * T, -1), x.reshape(B * T, -1),
            self.activation or "identity",
            None if mask is None else mask.reshape(B * T))
