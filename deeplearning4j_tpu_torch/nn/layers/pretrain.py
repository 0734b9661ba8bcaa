"""Unsupervised layerwise pretraining: the RBM and the pretrain steps.

Counterpart of deeplearning4j_tpu/nn/layers/pretrain.py (parity surface:
the reference's RBM and MultiLayerNetwork.pretrain). A layer is
pretrainable if ``get_pretrain_step`` finds a step for it: the RBM's own
contrastive divergence (CD is not the gradient of a loss), or plain SGD on
the self-supervised ``compute_score`` of an AutoEncoder or a
VariationalAutoencoder. A step is ``step(params, x, gen, lr) ->
(new_params, loss)`` over the layer's parameters as the containers hold
them (a flat path-keyed dict, ``enc/0/W``), eager, its random numbers
drawn from ``gen`` through the seam of nn/dropout.py in the JAX step's
order.

Parameter keys follow the reference's PretrainParamInitializer: ``W``
(n_in, n_out), ``b`` the hidden bias, ``vb`` the visible bias.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.dropout import draw
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, nest_params,
                                                     register_layer,
                                                     require_dims)
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _sample(p, gen):
    """A Bernoulli sample of probabilities ``p`` (uniform < p, in p's
    dtype, as ``jax.random.bernoulli`` draws it)."""
    u = draw("uniform", p.shape, p.dtype, p.device, gen)
    return (u < p).to(p.dtype)


@register_layer
@dataclass
class RBM(Layer):
    """Bernoulli-Bernoulli restricted Boltzmann machine (a Gaussian
    visible layer with ``visible_unit='gaussian'``). As a feed-forward
    layer ``apply`` is the propagation up, act(x W + b), sigmoid unless an
    activation is set; ``pretrain_step`` is one CD-k update."""
    n_in: int = 0
    n_out: int = 0
    k: int = 1                      # CD-k Gibbs steps
    visible_unit: str = "binary"    # binary | gaussian

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in, n_out=self.n_out)
        return {"W": init_weights(gen, (self.n_in, self.n_out),
                                  self.weight_init or "xavier", self.dist,
                                  dtype, device=device),
                "b": torch.zeros((self.n_out,), dtype=dtype, device=device),
                "vb": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        return get_activation(self.activation or "sigmoid")(
            x @ params["W"] + params["b"])

    def _prop_up(self, params, v):
        return torch.sigmoid(v @ params["W"] + params["b"])

    def _prop_down(self, params, h):
        pre = h @ params["W"].T + params["vb"]
        return pre if self.visible_unit == "gaussian" else torch.sigmoid(pre)

    @torch.no_grad()
    def pretrain_step(self, params, x, gen, lr):
        """One CD-k update on a batch: k - 1 full Gibbs steps (a hidden
        sample, the visible mean, sampled for binary units, the hidden
        mean), then the k-th hidden sample and the negative phase. Returns
        (new parameters, the mean squared reconstruction error of the
        positive phase's hidden means)."""
        B = x.shape[0]
        h0 = self._prop_up(params, x)
        h = h0
        for _ in range(self.k - 1):
            v = self._prop_down(params, _sample(h, gen))
            if self.visible_unit == "binary":
                v = _sample(v, gen)
            h = self._prop_up(params, v)
        vk = self._prop_down(params, _sample(h, gen))
        hk = self._prop_up(params, vk)
        new = {"W": params["W"] + lr * ((x.T @ h0 - vk.T @ hk) / B),
               "b": params["b"] + lr * (h0 - hk).mean(dim=0),
               "vb": params["vb"] + lr * (x - vk).mean(dim=0)}
        recon = torch.mean((x - self._prop_down(params, h0)) ** 2)
        return new, recon


def make_gradient_pretrain_step(layer):
    """The pretrain step of a layer with a self-supervised
    ``compute_score`` (AutoEncoder, VariationalAutoencoder): one plain SGD
    step on that loss at train time, its draws from ``gen``."""

    def step(params, x, gen, lr):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = layer.compute_score(nest_params(leaves), x, None, None,
                                       train=True, gen=gen)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        new = {k: (v - lr * g if g is not None else v).detach()
               for (k, v), g in zip(leaves.items(), grads)}
        return new, loss.detach()

    return step


def get_pretrain_step(layer):
    """The pretrain step of ``layer``, or None when it has none."""
    if hasattr(layer, "pretrain_step"):
        return layer.pretrain_step
    if type(layer).__name__ in ("AutoEncoder", "VariationalAutoencoder"):
        return make_gradient_pretrain_step(layer)
    return None
