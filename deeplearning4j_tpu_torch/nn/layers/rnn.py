"""Recurrent layers: LSTM, RnnOutputLayer and RnnLossLayer.

Counterpart of deeplearning4j_tpu/nn/layers/rnn.py. The input-to-gate
projection for the whole sequence is one (B*T, C) x (C, 4H)
``torch.matmul`` outside the time loop; the loop itself is the fused
kernel whenever the layer's configuration is the one the kernel computes
and, on the card, every kernel the path launches has a launch plan at the
layer's batch and width: ``ops.lstm_sequence`` (``ops.lstm2_sequence`` for
two stacked layers), which runs the inference kernel K1 (K4) under
``no_grad`` and the training kernels K2 (K4-train) with the backward K3
when autograd records. Other configurations and shapes run the layer's own
``_cell`` loop, which autograd differentiates; a pair the wavefront kernel
does not take runs as two single layers, each screened again, as the JAX
package's pair does. Parameter keys: ``W`` input weights, ``RW`` recurrent
weights, ``b`` bias, gate order IFOG.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.nn.activations import get_activation
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

    def _cell(self, params, gate_in_t, h, c):
        """One step of the layer's own math (any activations)."""
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
        return h_new.to(h.dtype), c_new.to(c.dtype)

    def fused_supported(self, dt, batch, device, recording) -> bool:
        """The configuration the fused kernel computes (the cuDNN-parity
        screen of the JAX package): plain LSTM, sigmoid gates, tanh cell,
        float32 or bfloat16; and its shape half: on the card, a launch plan
        at this batch and width for every kernel the path launches (K1, or
        K2 and K3 when autograd is ``recording``). Anything else runs the
        layer's own loop."""
        return (type(self) is LSTM and self.gate_activation == "sigmoid"
                and (self.activation or "tanh") == "tanh"
                and dt in _KERNEL_DTYPES
                and _kernels_take(_SINGLE_KERNELS[recording], batch,
                                  self.n_out, dt, device))

    def _scan(self, params, x, h0, c0):
        dt = h0.dtype
        gate_in = _gate_inputs(params, x, dt)
        rw, h0, c0 = params["RW"].to(dt).contiguous(), h0.contiguous(), \
            c0.contiguous()
        if self.fused_supported(
                dt, x.shape[0], x.device,
                lstm_cuda.autograd_records(gate_in, rw, h0, c0)):
            hs, c_last = ops.lstm_sequence(gate_in, rw, h0, c0)
            return hs.transpose(0, 1), (hs[-1], c_last)
        h, c, hs = h0, c0, []
        for t in range(gate_in.shape[0]):
            h, c = self._cell(params, gate_in[t], h, c)
            hs.append(h)
        return torch.stack(hs, dim=1), (h, c)

    def apply(self, params, x):
        return self.apply_with_carry(params, x)[0]

    def apply_with_carry(self, params, x, carry=None):
        """Run from a carried state (parity: rnnTimeStep, and the chunks of
        truncated BPTT): returns (y, (h, c))."""
        if carry is None:
            dt = torch.promote_types(x.dtype, params["W"].dtype)
            z = torch.zeros((x.shape[0], self.n_out), dtype=dt,
                            device=x.device)
            carry = (z, z)
        return self._scan(params, x, carry[0], carry[1])

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


def lstm_pair_fusable(l1, l2, p1, p2, x) -> bool:
    """True when two consecutive LSTM layers run as ONE wavefront kernel
    (ops.fused_lstm2_sequence): both pass their own fused screen with the
    promoted dtype, equal widths, nothing sits between the layers, and on
    the card the wavefront kernels the path launches (K4, or K4-train and
    K3 when autograd records) have a launch plan at this batch and width.
    Otherwise the caller runs the two layers one by one."""
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


def apply_lstm_pair(l1, l2, p1, p2, x):
    """Run two fusable stacked LSTMs through the wavefront kernel; returns
    the layer-2 hidden sequence (B, T, H)."""
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
class RnnOutputLayer(OutputLayer):
    """Time-distributed output layer over (B, T, C)."""

    def output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def apply(self, params, x):
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

    def apply(self, params, x):
        return get_activation(self.activation or "identity")(x)

    def compute_score(self, params, x, labels, mask=None):
        B, T = x.shape[0], x.shape[1]
        return get_loss(self.loss)(
            labels.reshape(B * T, -1), x.reshape(B * T, -1),
            self.activation or "identity",
            None if mask is None else mask.reshape(B * T))
