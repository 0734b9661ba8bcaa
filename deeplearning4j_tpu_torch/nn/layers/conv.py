"""Convolutional, pooling and normalization layers.

Counterpart of deeplearning4j_tpu/nn/layers/conv.py: the same sixteen
classes, fields, parameter keys and JSON. The public layout stays the JAX
package's: activations NHWC (``(B, T, C)`` for the 1-D layers) and
kernels HWIO (``(k, in, out)`` in 1-D), as the checkpoint zips hold them.
Inside, cuDNN (through ``torch.nn.functional``) gets an NCHW view of the
channels-last activation (``permute``, no copy) and an OIHW view of the
kernel. The JAX package computes these layers with XLA
(``lax.conv_general_dilated``, ``lax.reduce_window``, plain ``jnp``), not
with Pallas, so no hand-written kernel stands behind them here either.

Numbers follow the JAX package:

- ``same`` padding is XLA's: ``total = max((ceil(n / s) - 1) * s +
  (k - 1) * d + 1 - n, 0)`` split ``total // 2`` before and the rest
  after, asymmetric at even totals; an asymmetric pad is applied with
  ``F.pad`` before the call (max pooling pads with -inf).
- Average pooling divides by the window (``avg_count_includes_padding``,
  the default) or by the count of real positions in it.
- ``Deconvolution2D`` is ``lax.conv_transpose`` as the JAX layer calls it:
  the input dilated by the stride, padded, and correlated with the HWIO
  kernel unflipped.
- ``BatchNormalization`` normalises with the biased batch variance and
  ``rsqrt(var + eps)``; its running statistics are state
  (``init_state``), updated ``new = decay * old + (1 - decay) * batch``
  with the same biased variance, written in place under ``train`` when
  the container passes the state, and cast to the activation's dtype in
  inference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (InputType,
                                                     conv_output_size)
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, as_pair,
                                                     register_layer,
                                                     require_dims)
from deeplearning4j_tpu_torch.nn.weights import init_weights


def same_pads(n: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def _pads(mode, spatial, kernel, stride, padding, dilation):
    """Per-axis (before, after) pads of a window op over ``spatial``."""
    if mode == "same":
        return tuple(same_pads(n, k, s, d) for n, k, s, d in
                     zip(spatial, kernel, stride, dilation))
    return tuple((p, p) for p in padding)


def _nchw(x):
    """The NCHW view of an NHWC tensor (channels-last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _oihw(w):
    """The OIHW view of an HWIO kernel."""
    return w.permute(3, 2, 0, 1)


def _pad_nchw(x, pads, value=0.0):
    """``x`` (N, C, H, W) padded by ((top, bottom), (left, right))."""
    (t, b), (l, r) = pads
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


def _conv2d(x, w, bias, stride, pads, dilation, groups=1):
    """NHWC ``x`` correlated with HWIO ``w``: symmetric pads go to cuDNN,
    asymmetric ones through ``F.pad`` first."""
    xn = _nchw(x)
    (t, b), (l, r) = pads
    if t == b and l == r:
        pad = (t, l)
    else:
        xn, pad = _pad_nchw(xn, pads), (0, 0)
    return _nhwc(F.conv2d(xn, _oihw(w), bias, tuple(stride), pad,
                          tuple(dilation), groups))


@register_layer
@dataclass
class ConvolutionLayer(Layer):
    """2-D convolution. Input / kernel: NHWC / HWIO."""
    n_in: int = 0                  # input channels
    n_out: int = 0                 # output channels
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"   # 'truncate' | 'same'
    has_bias: bool = True

    def __post_init__(self):
        self.kernel_size = as_pair(self.kernel_size)
        self.stride = as_pair(self.stride)
        self.padding = as_pair(self.padding)
        self.dilation = as_pair(self.dilation)

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.channels

    def output_type(self, input_type):
        h = conv_output_size(input_type.height, self.kernel_size[0],
                             self.stride[0], self.padding[0],
                             self.dilation[0], self.convolution_mode)
        w = conv_output_size(input_type.width, self.kernel_size[1],
                             self.stride[1], self.padding[1],
                             self.dilation[1], self.convolution_mode)
        return InputType.convolutional(h, w, self.n_out)

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in, n_out=self.n_out)
        kh, kw = self.kernel_size
        p = {"W": init_weights(gen, (kh, kw, self.n_in, self.n_out),
                               self.weight_init or "xavier", self.dist, dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0),
                                dtype=dtype, device=device)
        return p

    def _window_pads(self, x):
        return _pads(self.convolution_mode, x.shape[1:3], self.kernel_size,
                     self.stride, self.padding, self.dilation)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        y = _conv2d(x, params["W"], params["b"] if self.has_bias else None,
                    self.stride, self._window_pads(x), self.dilation)
        return get_activation(self.activation or "identity")(y)


@register_layer
@dataclass
class Convolution1DLayer(Layer):
    """1-D (temporal) convolution over (B, T, C), kernel (k, in, out)."""
    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.size

    def output_type(self, input_type):
        t = input_type.timeseries_length
        if t > 0:
            t = conv_output_size(t, self.kernel_size, self.stride,
                                 self.padding, self.dilation,
                                 self.convolution_mode)
        return InputType.recurrent(self.n_out, t)

    def init(self, gen, dtype=torch.float32, device=None):
        p = {"W": init_weights(gen, (self.kernel_size, self.n_in, self.n_out),
                               self.weight_init or "xavier", self.dist, dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        # (B, T, C) as NHWC with H = 1, the kernel as (1, k, in, out)
        pads = ((0, 0),) + _pads(self.convolution_mode, x.shape[1:2],
                                 (self.kernel_size,), (self.stride,),
                                 (self.padding,), (self.dilation,))
        y = _conv2d(x[:, None], params["W"][None],
                    params["b"] if self.has_bias else None,
                    (1, self.stride), pads, (1, self.dilation))
        return get_activation(self.activation or "identity")(y[:, 0])


@register_layer
@dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """Depthwise then pointwise convolution: ``dW`` (kh, kw, 1, in x
    depth_multiplier), ``pW`` (1, 1, in x depth_multiplier, out)."""
    depth_multiplier: int = 1

    def init(self, gen, dtype=torch.float32, device=None):
        kh, kw = self.kernel_size
        mid = self.n_in * self.depth_multiplier
        wi = self.weight_init or "xavier"
        p = {"dW": init_weights(gen, (kh, kw, 1, mid), wi, self.dist, dtype,
                                fan_in=kh * kw,
                                fan_out=kh * kw * self.depth_multiplier,
                                device=device),
             "pW": init_weights(gen, (1, 1, mid, self.n_out), wi, self.dist,
                                dtype, device=device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        y = _conv2d(x, params["dW"], None, self.stride,
                    self._window_pads(x), self.dilation, groups=self.n_in)
        y = _conv2d(y, params["pW"], params["b"] if self.has_bias else None,
                    (1, 1), ((0, 0), (0, 0)), (1, 1))
        return get_activation(self.activation or "identity")(y)


@register_layer
@dataclass
class DepthwiseConvolution2D(ConvolutionLayer):
    """Per-channel convolution: ``W`` (kh, kw, 1, in x depth_multiplier)."""
    depth_multiplier: int = 1

    def output_type(self, input_type):
        ot = super().output_type(input_type)
        return InputType.convolutional(ot.height, ot.width,
                                       self.n_in * self.depth_multiplier)

    def init(self, gen, dtype=torch.float32, device=None):
        kh, kw = self.kernel_size
        mid = self.n_in * self.depth_multiplier
        p = {"W": init_weights(gen, (kh, kw, 1, mid),
                               self.weight_init or "xavier", self.dist, dtype,
                               fan_in=kh * kw,
                               fan_out=kh * kw * self.depth_multiplier,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.full((mid,), float(self.bias_init or 0.0),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        y = _conv2d(x, params["W"], params["b"] if self.has_bias else None,
                    self.stride, self._window_pads(x), self.dilation,
                    groups=self.n_in)
        return get_activation(self.activation or "identity")(y)


def _transpose_pads(k: int, s: int):
    """``lax.conv_transpose``'s (before, after) pads for 'SAME'."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


@register_layer
@dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution, as ``lax.conv_transpose(x, W, stride,
    pads)`` with the JAX layer's pads: ``k - 1 - p`` each side in
    'truncate' mode, the SAME rule of ``lax.conv_transpose`` in 'same'."""

    def output_type(self, input_type):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        if self.convolution_mode == "same":
            h, w = input_type.height * sh, input_type.width * sw
        else:
            h = sh * (input_type.height - 1) + kh - 2 * self.padding[0]
            w = sw * (input_type.width - 1) + kw - 2 * self.padding[1]
        return InputType.convolutional(h, w, self.n_out)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        if self.convolution_mode == "same":
            pads = (_transpose_pads(kh, sh), _transpose_pads(kw, sw))
        else:
            ph, pw = self.padding
            pads = ((kh - 1 - ph,) * 2, (kw - 1 - pw,) * 2)
        B, H, W, C = x.shape
        xn = _nchw(x)
        if sh > 1 or sw > 1:     # the input dilated by the stride
            d = xn.new_zeros((B, C, (H - 1) * sh + 1, (W - 1) * sw + 1))
            d[:, :, ::sh, ::sw] = xn
            xn = d
        (t, b), (l, r) = pads    # a negative pad crops
        xn = F.pad(xn, (l, r, t, b))
        y = _nhwc(F.conv2d(xn, _oihw(params["W"]),
                           params["b"] if self.has_bias else None))
        return get_activation(self.activation or "identity")(y)


def _pool(x, kind, kernel, stride, pads, pnorm=2, count_pad=True):
    """Pooling of NHWC ``x`` over ``kernel`` windows with per-axis pads:
    'max' pads with -inf; 'sum', 'avg' and 'pnorm' sum the window (zeros
    in the padding), 'avg' divides by the window or, without
    ``count_pad``, by its real positions."""
    xn = _nchw(x)
    kernel, stride = tuple(kernel), tuple(stride)
    (t, b), (l, r) = pads
    if kind == "max":
        if t == b and l == r and 2 * t <= kernel[0] and 2 * l <= kernel[1]:
            y = F.max_pool2d(xn, kernel, stride, (t, l))
        else:
            y = F.max_pool2d(_pad_nchw(xn, pads, float("-inf")), kernel,
                             stride)
        return _nhwc(y)
    if kind not in ("avg", "sum", "pnorm"):
        raise ValueError(kind)

    def window_sum(a):
        return F.avg_pool2d(_pad_nchw(a, pads), kernel, stride,
                            divisor_override=1)
    if kind == "pnorm":
        p = float(pnorm)
        return _nhwc(window_sum(xn.abs() ** p) ** (1.0 / p))
    y = window_sum(xn)
    if kind == "avg":
        if count_pad:
            y = y / (kernel[0] * kernel[1])
        else:
            ones = xn.new_ones((1, 1) + tuple(xn.shape[2:]))
            y = y / window_sum(ones)
    return _nhwc(y)


@register_layer
@dataclass
class SubsamplingLayer(Layer):
    """Pooling: 'max', 'avg', 'sum' or 'pnorm' over NHWC."""
    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2
    # the avg divisor at padded edges: True = the window (the reference's),
    # False = its real positions (Keras / TF)
    avg_count_includes_padding: bool = True

    def __post_init__(self):
        self.kernel_size = as_pair(self.kernel_size)
        self.stride = as_pair(self.stride)
        self.padding = as_pair(self.padding)

    def has_params(self):
        return False

    def output_type(self, input_type):
        h = conv_output_size(input_type.height, self.kernel_size[0],
                             self.stride[0], self.padding[0], 1,
                             self.convolution_mode)
        w = conv_output_size(input_type.width, self.kernel_size[1],
                             self.stride[1], self.padding[1], 1,
                             self.convolution_mode)
        return InputType.convolutional(h, w, input_type.channels)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        pads = _pads(self.convolution_mode, x.shape[1:3], self.kernel_size,
                     self.stride, self.padding, (1, 1))
        return _pool(x, self.pooling_type, self.kernel_size, self.stride,
                     pads, self.pnorm, self.avg_count_includes_padding)


@register_layer
@dataclass
class Subsampling1DLayer(Layer):
    """Pooling over the time axis of (B, T, C): 'max', 'avg' or 'sum'."""
    pooling_type: str = "max"
    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = "truncate"
    avg_count_includes_padding: bool = True

    def has_params(self):
        return False

    def output_type(self, input_type):
        t = input_type.timeseries_length
        if t > 0:
            t = conv_output_size(t, self.kernel_size, self.stride,
                                 self.padding, 1, self.convolution_mode)
        return InputType.recurrent(input_type.size, t)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        kind = "max" if self.pooling_type == "max" else (
            "avg" if self.pooling_type == "avg" else "sum")
        pads = ((0, 0),) + _pads(self.convolution_mode, x.shape[1:2],
                                 (self.kernel_size,), (self.stride,),
                                 (self.padding,), (1,))
        y = _pool(x[:, None], kind, (1, self.kernel_size), (1, self.stride),
                  pads, count_pad=self.avg_count_includes_padding)
        return y[:, 0]


@register_layer
@dataclass
class Upsampling2D(Layer):
    size: Tuple[int, int] = (2, 2)

    def __post_init__(self):
        self.size = as_pair(self.size)

    def has_params(self):
        return False

    def output_type(self, input_type):
        return InputType.convolutional(input_type.height * self.size[0],
                                       input_type.width * self.size[1],
                                       input_type.channels)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return x.repeat_interleave(self.size[0], dim=1) \
            .repeat_interleave(self.size[1], dim=2)


@register_layer
@dataclass
class Upsampling1D(Layer):
    size: int = 2

    def has_params(self):
        return False

    def output_type(self, input_type):
        t = input_type.timeseries_length
        return InputType.recurrent(input_type.size,
                                   t * self.size if t > 0 else t)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return x.repeat_interleave(self.size, dim=1)


@register_layer
@dataclass
class ZeroPaddingLayer(Layer):
    padding: Tuple[int, int, int, int] = (0, 0, 0, 0)  # top, bottom, left, right

    def __post_init__(self):
        p = self.padding
        if isinstance(p, int):
            p = (p, p, p, p)
        elif len(p) == 2:
            p = (p[0], p[0], p[1], p[1])
        self.padding = tuple(p)

    def has_params(self):
        return False

    def output_type(self, input_type):
        t, b, l, r = self.padding
        return InputType.convolutional(input_type.height + t + b,
                                       input_type.width + l + r,
                                       input_type.channels)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        t, b, l, r = self.padding
        return F.pad(x, (0, 0, l, r, t, b))


@register_layer
@dataclass
class ZeroPadding1DLayer(Layer):
    padding: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.padding = as_pair(self.padding)

    def has_params(self):
        return False

    def output_type(self, input_type):
        t = input_type.timeseries_length
        extra = self.padding[0] + self.padding[1]
        return InputType.recurrent(input_type.size,
                                   t + extra if t > 0 else t)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        l, r = self.padding
        return F.pad(x, (0, 0, l, r))


@register_layer
@dataclass
class Cropping2D(Layer):
    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def __post_init__(self):
        c = self.cropping
        if isinstance(c, int):
            c = (c, c, c, c)
        elif len(c) == 2:
            c = (c[0], c[0], c[1], c[1])
        self.cropping = tuple(c)

    def has_params(self):
        return False

    def output_type(self, input_type):
        t, b, l, r = self.cropping
        return InputType.convolutional(input_type.height - t - b,
                                       input_type.width - l - r,
                                       input_type.channels)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        t, b, l, r = self.cropping
        H, W = x.shape[1], x.shape[2]
        return x[:, t:H - b, l:W - r, :]


@register_layer
@dataclass
class BatchNormalization(Layer):
    """Batch normalization over every axis but the last, with running
    statistics as state (module docstring)."""
    n_in: int = 0
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = (input_type.channels if input_type.kind == "cnn"
                         else input_type.size if input_type.kind == "rnn"
                         else input_type.flat_size())

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in)
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.ones((self.n_in,), dtype=dtype, device=device),
                "beta": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def init_state(self, dtype=torch.float32, device=None):
        return {"mean": torch.zeros((self.n_in,), dtype=dtype, device=device),
                "var": torch.ones((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x, *, train=False, gen=None, mask=None,
              state=None):
        dims = tuple(range(x.ndim - 1))
        if train:
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, correction=0)
            if state is not None:
                with torch.no_grad():
                    for k, batch in (("mean", mean), ("var", var)):
                        state[k].copy_(self.decay * state[k]
                                       + (1 - self.decay) * batch.detach())
        else:
            mean = state["mean"].to(x.dtype)
            var = state["var"].to(x.dtype)
        xn = (x - mean) * torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            xn = xn * params["gamma"] + params["beta"]
        return get_activation(self.activation or "identity")(xn)


@register_layer
@dataclass
class LocalResponseNormalization(Layer):
    """Local response normalization across channels:
    ``x / (k + alpha * sum of x**2 over n channels) ** beta``."""
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75
    n: int = 5

    def has_params(self):
        return False

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        half = self.n // 2
        C = x.shape[-1]
        sq = (x ** 2).reshape(-1, 1, C)
        ones = x.new_ones((1, 1, self.n))
        win = F.conv1d(sq, ones, padding=half).reshape(x.shape[:-1] + (-1,))
        return x / (self.k + self.alpha * win) ** self.beta


@register_layer
@dataclass
class SpaceToDepthLayer(Layer):
    block_size: int = 2

    def has_params(self):
        return False

    def output_type(self, input_type):
        b = self.block_size
        return InputType.convolutional(input_type.height // b,
                                       input_type.width // b,
                                       input_type.channels * b * b)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        B, H, W, C = x.shape
        b = self.block_size
        y = x.reshape(B, H // b, b, W // b, b, C)
        return y.permute(0, 1, 3, 2, 4, 5).reshape(B, H // b, W // b,
                                                   b * b * C)


@register_layer
@dataclass
class SpaceToBatchLayer(Layer):
    block_size: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.block_size = as_pair(self.block_size)

    def has_params(self):
        return False

    def output_type(self, input_type):
        bh, bw = self.block_size
        return InputType.convolutional(input_type.height // bh,
                                       input_type.width // bw,
                                       input_type.channels)

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        B, H, W, C = x.shape
        bh, bw = self.block_size
        y = x.reshape(B, H // bh, bh, W // bw, bw, C)
        return y.permute(2, 4, 0, 1, 3, 5).reshape(B * bh * bw, H // bh,
                                                   W // bw, C)
