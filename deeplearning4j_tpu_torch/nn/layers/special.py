"""Special layers: global pooling, the autoencoders, the center-loss and
YOLOv2 heads, and the frozen-layer wrapper.

Counterpart of deeplearning4j_tpu/nn/layers/special.py, layer for layer
(parity surface: the reference's GlobalPoolingLayer, AutoEncoder,
VariationalAutoencoder, CenterLossOutputLayer, Yolo2OutputLayer and
FrozenLayer). The autoencoders' ``compute_score`` is their
self-supervised loss, which ``MultiLayerNetwork.pretrain`` descends
(nn/layers/pretrain.py); their random numbers (the denoising keep mask,
the reparameterisation noise) come through the draw seam of nn/dropout.py.
The VAE keeps its encoder and decoder stacks as lists of dicts (``enc``,
``dec``), which the containers hold under path keys (``enc/0/W``), as the
JAX package's checkpoints do.

A ``FrozenLayer`` runs its inner layer in inference mode on detached
parameters: no gradient reaches them, the containers give it no updater
(and so no updater state in a zip), and it writes no layer state -- a
frozen BatchNormalization reads the network's running statistics, also
where the container writes nobody's (``frozen``; models/).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.dropout import draw
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, map_tree,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.weights import init_weights


@register_layer
@dataclass
class GlobalPoolingLayer(Layer):
    """Pool over time, (B, T, C) -> (B, C), or space, (B, H, W, C) -> (B,
    C): 'max', 'avg', 'sum' or 'pnorm'. A sequence's (B, T) mask drops
    its padded steps (an all-zero row: -inf under 'max', 0 otherwise)."""
    pooling_type: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True

    def has_params(self):
        return False

    def output_type(self, input_type):
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        if x.ndim not in (3, 4):
            return x
        dims = (1,) if x.ndim == 3 else (1, 2)
        kind = self.pooling_type
        if mask is not None and x.ndim == 3:
            m = mask[..., None].to(x.dtype)
            if kind == "max":
                return torch.where(m > 0, x, float("-inf")).amax(dim=1)
            if kind == "sum":
                return (x * m).sum(dim=1)
            if kind == "avg":
                return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
            p = float(self.pnorm)
            return (x.abs() ** p * m).sum(dim=1) ** (1.0 / p)
        if kind == "max":
            return x.amax(dim=dims)
        if kind == "sum":
            return x.sum(dim=dims)
        if kind == "avg":
            return x.mean(dim=dims)
        p = float(self.pnorm)
        return (x.abs() ** p).sum(dim=dims) ** (1.0 / p)


def _weights(layer, gen, shape, dtype, device):
    return init_weights(gen, shape, layer.weight_init or "xavier",
                        layer.dist, dtype, device=device)


def _mean_over_rows(per_ex, mask):
    """The mean of the (B,) per-example terms, over the rows a (B,) mask
    keeps when one is given."""
    if mask is None:
        return per_ex.mean()
    m = mask.reshape(per_ex.shape[0]).to(per_ex.dtype)
    return (per_ex * m).sum() / torch.clamp(m.sum(), min=1.0)


@register_layer
@dataclass
class AutoEncoder(Layer):
    """Denoising autoencoder with tied weights: ``apply`` is the encoding
    act(x W + b); ``compute_score`` corrupts the input (each element kept
    with probability 1 - ``corruption_level``, a Bernoulli drawn through
    the seam, at train time with a generator) and scores the
    reconstruction act(h W^T + vb) against the clean input."""
    n_in: int = 0
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, dtype=torch.float32, device=None):
        return {"W": _weights(self, gen, (self.n_in, self.n_out), dtype,
                              device),
                "b": torch.zeros((self.n_out,), dtype=dtype, device=device),
                "vb": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def _encode(self, params, x):
        return get_activation(self.activation or "sigmoid")(
            x @ params["W"] + params["b"])

    def _decode(self, params, h):
        return get_activation(self.activation or "sigmoid")(
            h @ params["W"].T + params["vb"])

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return self._encode(params, x)

    def compute_score(self, params, x, labels=None, mask=None, *,
                      train=False, gen=None):
        xc = x
        if train and gen is not None and self.corruption_level > 0:
            keep = draw("uniform", x.shape, x.dtype, x.device, gen) \
                < 1.0 - self.corruption_level
            xc = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
        recon = self._decode(params, self._encode(params, xc))
        return get_loss(self.loss)(x, recon, "identity", mask)


@register_layer
@dataclass
class VariationalAutoencoder(Layer):
    """Variational autoencoder with a Gaussian q(z|x): ``apply`` gives the
    latent mean, ``reconstruct`` the decoded mean, ``generate`` the
    decoding of given latents, and ``compute_score`` the negative ELBO
    (reconstruction by ``recon``: 'bernoulli' on logits, or 'gaussian' /
    'mse' as half the squared error; plus the KL term) with z = mean +
    exp(logvar / 2) * eps, eps drawn through the seam at train time with a
    generator (0 otherwise)."""
    n_in: int = 0
    n_out: int = 0                        # latent size nZ
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    recon: str = "bernoulli"
    pzx_activation: str = "identity"
    num_samples: int = 1

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, dtype=torch.float32, device=None):
        def dense(n_in, n_out):
            return (_weights(self, gen, (n_in, n_out), dtype, device),
                    torch.zeros((n_out,), dtype=dtype, device=device))
        p = {"enc": [], "dec": []}
        width = self.n_in
        for h in self.encoder_layer_sizes:
            w, b = dense(width, h)
            p["enc"].append({"W": w, "b": b})
            width = h
        p["zW_mean"], p["zb_mean"] = dense(width, self.n_out)
        p["zW_logvar"], p["zb_logvar"] = dense(width, self.n_out)
        width = self.n_out
        for h in self.decoder_layer_sizes:
            w, b = dense(width, h)
            p["dec"].append({"W": w, "b": b})
            width = h
        p["xW"], p["xb"] = dense(width, self.n_in)
        return p

    def _encode(self, params, x):
        act = get_activation(self.activation or "tanh")
        h = x
        for lp in params.get("enc", ()):
            h = act(h @ lp["W"] + lp["b"])
        mean = get_activation(self.pzx_activation)(
            h @ params["zW_mean"] + params["zb_mean"])
        return mean, h @ params["zW_logvar"] + params["zb_logvar"]

    def _decode(self, params, z):
        act = get_activation(self.activation or "tanh")
        h = z
        for lp in params.get("dec", ()):
            h = act(h @ lp["W"] + lp["b"])
        return h @ params["xW"] + params["xb"]

    def _output(self, logits):
        return torch.sigmoid(logits) if self.recon == "bernoulli" else logits

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return self._encode(params, x)[0]

    def reconstruct(self, params, x):
        return self._output(self._decode(params, self._encode(params, x)[0]))

    def generate(self, params, z):
        return self._output(self._decode(params, z))

    def compute_score(self, params, x, labels=None, mask=None, *,
                      train=False, gen=None):
        mean, logvar = self._encode(params, x)
        if train and gen is not None:
            eps = draw("normal", mean.shape, mean.dtype, mean.device, gen)
        else:
            eps = torch.zeros_like(mean)
        logits = self._decode(params, mean + torch.exp(0.5 * logvar) * eps)
        if self.recon == "bernoulli":
            xc = torch.clamp(x, 0.0, 1.0)
            rec = (torch.clamp(logits, min=0) - logits * xc
                   + torch.log1p(torch.exp(-logits.abs()))).sum(dim=-1)
        else:
            rec = 0.5 * ((x - logits) ** 2).sum(dim=-1)
        kl = -0.5 * (1 + logvar - mean ** 2 - torch.exp(logvar)).sum(dim=-1)
        return _mean_over_rows(rec + kl, mask)


@register_layer
@dataclass
class CenterLossOutputLayer(OutputLayer):
    """Softmax output plus center loss: the base loss (without
    ``centers``) + ``lambda_`` x the mean of 0.5 ||x - c_y||^2, y the
    label's argmax. ``centers`` (n_out, n_in) start at zero and are
    trained by the updater through that term; ``alpha`` is kept for the
    configuration and unused, as in the JAX package."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def init(self, gen, dtype=torch.float32, device=None):
        p = super().init(gen, dtype, device)
        p["centers"] = torch.zeros((self.n_out, self.n_in), dtype=dtype,
                                   device=device)
        return p

    def compute_score(self, params, x, labels, mask=None, *, train=False,
                      gen=None):
        base = super().compute_score(
            {k: v for k, v in params.items() if k != "centers"}, x, labels,
            mask, train=train, gen=gen)
        # c_y as a one-hot product: its backward is a GEMM, where an
        # indexed gather's would add rows of one class atomically (in no
        # fixed order on the card)
        onehot = torch.nn.functional.one_hot(labels.argmax(dim=-1),
                                             self.n_out).to(x.dtype)
        per_ex = 0.5 * ((x - onehot @ params["centers"]) ** 2).sum(dim=-1)
        return base + self.lambda_ * _mean_over_rows(per_ex, mask)


@register_layer
@dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 detection loss over NHWC activations (B, H, W, A*(5+C)), A
    anchors, with labels of the same layout: per anchor [tx, ty, tw, th,
    obj, class one-hot]. Sigmoid xy and objectness; coordinates weighted
    by ``lambda_coord`` in object cells, no-object confidence by
    ``lambda_no_obj``, softmax class loss in object cells; the mean over
    examples (over the rows a (B,) mask keeps)."""
    anchors: Tuple[Tuple[float, float], ...] = ((1.0, 1.0),)
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5
    n_classes: int = 0

    def __post_init__(self):
        # JSON delivers lists; the canonical form keeps round trips equal
        self.anchors = tuple(tuple(float(v) for v in a) for a in self.anchors)

    def has_params(self):
        return False

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return x

    def _split(self, x):
        B, H, W, _ = x.shape
        x = x.reshape(B, H, W, len(self.anchors), 5 + self.n_classes)
        return (torch.sigmoid(x[..., 0:2]), x[..., 2:4],
                torch.sigmoid(x[..., 4]), x[..., 5:])

    def compute_score(self, params, x, labels, mask=None, *, train=False,
                      gen=None):
        pxy, pwh, pobj, pcls = self._split(x)
        B, H, W, _ = labels.shape
        lab = labels.reshape(B, H, W, len(self.anchors), 5 + self.n_classes)
        txy, twh, tobj, tcls = (lab[..., 0:2], lab[..., 2:4], lab[..., 4],
                                lab[..., 5:])
        cells = (1, 2, 3)
        coord = (((pxy - txy) ** 2).sum(-1) + ((pwh - twh) ** 2).sum(-1))
        coord = (coord * tobj).sum(cells)
        obj_loss = (tobj * (pobj - 1.0) ** 2).sum(cells)
        noobj_loss = ((1 - tobj) * pobj ** 2).sum(cells)
        logp = torch.log_softmax(pcls, dim=-1)
        cls_loss = ((-(tcls * logp).sum(-1)) * tobj).sum(cells)
        per_ex = (self.lambda_coord * coord + obj_loss
                  + self.lambda_no_obj * noobj_loss + cls_loss)
        if mask is not None:
            return _mean_over_rows(per_ex, mask)
        return per_ex.sum() / B


@register_layer
@dataclass
class FrozenLayer(Layer):
    """The inner layer with its parameters frozen (module docstring). The
    wrapper's own hyperparameters stay unset: the network's defaults reach
    the inner layer only, so a frozen layer adds no l1/l2."""
    inner: Optional[Layer] = None

    # read by the containers: no updater, and the network's own state read
    # where the container writes none
    frozen = True

    def set_n_in(self, input_type):
        self.inner.set_n_in(input_type)

    def apply_defaults(self, defaults):
        if self.inner is not None:
            self.inner.apply_defaults(defaults)

    def validate(self):
        self.inner.validate()

    def output_type(self, input_type):
        return self.inner.output_type(input_type)

    def init(self, gen, dtype=torch.float32, device=None):
        return self.inner.init(gen, dtype, device)

    def init_state(self, dtype=torch.float32, device=None):
        return self.inner.init_state(dtype, device)

    def has_params(self):
        return self.inner.has_params()

    def draws_noise(self):
        return False        # the inner layer runs in inference mode

    def apply(self, params, x, *, train=False, gen=None, mask=None,
              state=None):
        kw = {} if state is None else {"state": state}
        return self.inner.apply(map_tree(torch.Tensor.detach, params), x,
                                train=False, gen=gen, mask=mask, **kw)

    def compute_score(self, params, x, labels, mask=None, *, train=False,
                      gen=None):
        return self.inner.compute_score(map_tree(torch.Tensor.detach,
                                                 params), x, labels, mask,
                                        train=False, gen=gen)
