"""Transfer learning.

Counterpart of deeplearning4j_tpu/transferlearning/transfer.py:
``TransferLearning.Builder`` (``set_feature_extractor``'s freeze point,
``n_out_replace``, ``remove_output_layer``, ``remove_layers_from_output``,
``add_layer``), ``FineTuneConfiguration`` (hyperparameter overrides) and
``TransferLearningHelper`` (``featurize``: the frozen front run once;
``fit_featurized``: the tail trained alone).

Freezing wraps a layer in ``FrozenLayer`` (nn/layers/special.py: its
inner layer runs in inference mode on detached parameters, and it gets no
updater). Where the JAX package shares the source network's immutable
arrays, the port clones them: a network's parameters are updated in place
(the fused update's flat buffers, nn/fused_update.py, rebind each layer's
dict to views of the buffers), so a shared dict would let a fine-tune of
the new network write into the source network. The helper's tail network
likewise trains its own copies, and ``fit_featurized`` copies them back
INTO the full network's tensors and bumps its ``_params_version``, so the
full network's captured steps and its serving engine see them.

A layer the builder adds or re-initializes (``n_out_replace``) takes the
parameters ``init()`` of the new configuration gives it: every layer's
``init`` drawn in order from one ``torch.Generator`` seeded with the
configuration's seed. The JAX package splits a ``PRNGKey`` per layer, so
the draws differ; the same rule of "the network's seed" holds.

On the TextGenerationLSTM recipe net with layer 0 frozen, a train step
runs the frozen LSTM through K1 (inference mode) and the live LSTM
through K2 and K3 (the pair screen, ``lstm_pair_fusable``, fuses only two
plain LSTMs); ``featurize`` runs K1 alone and ``fit_featurized`` K2 and K3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    DTYPES, MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import flatten_params
from deeplearning4j_tpu_torch.nn.layers.special import FrozenLayer
from deeplearning4j_tpu_torch.nn.updaters import Updater

__all__ = ["TransferLearning", "FineTuneConfiguration",
           "TransferLearningHelper"]


def _cloned(tree):
    return [{k: v.detach().clone() for k, v in p.items()} for p in tree]


@dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides applied to every retained layer
    (parity: FineTuneConfiguration.java)."""
    updater: Optional[Updater] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    activation: Optional[str] = None
    seed: Optional[int] = None

    def apply(self, conf: MultiLayerConfiguration):
        g = conf.global_conf
        if self.updater is not None:
            g.updater = self.updater
        if self.l1 is not None:
            g.l1 = self.l1
        if self.l2 is not None:
            g.l2 = self.l2
        if self.seed is not None:
            g.seed = self.seed
        for l in conf.layers:
            if self.updater is not None and l.updater is not None:
                l.updater = self.updater
            if self.l1 is not None:
                l.l1 = self.l1
            if self.l2 is not None:
                l.l2 = self.l2
            if self.dropout is not None and l.dropout is not None:
                l.dropout = self.dropout


class TransferLearning:
    """Namespace matching the reference API: TransferLearning.Builder(net)."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._conf = MultiLayerConfiguration.from_json(net.conf.to_json())
            self._freeze_until: Optional[int] = None
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._removed_from_end = 0
            self._added: List = []
            self._nout_replaced = {}

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_index: int):
            """Freeze layers [0, layer_index] (parity: setFeatureExtractor)."""
            self._freeze_until = layer_index
            return self

        def remove_output_layer(self):
            self._removed_from_end += 1
            return self

        def remove_layers_from_output(self, n: int):
            self._removed_from_end += n
            return self

        def add_layer(self, layer):
            self._added.append(layer)
            return self

        def n_out_replace(self, layer_index: int, n_out: int,
                          weight_init: str = "xavier"):
            """Re-initialize layer at index with a new n_out (parity:
            nOutReplace -- also fixes the following layer's n_in)."""
            self._nout_replaced[layer_index] = (n_out, weight_init)
            return self

        def build(self) -> MultiLayerNetwork:
            conf = self._conf
            layers = conf.layers
            src = self._net
            params = _cloned(src.params)
            state = list(src.state)

            # remove tail layers
            for _ in range(self._removed_from_end):
                layers.pop()
                params.pop()
                state.pop()

            # replace n_out (and downstream n_in)
            reinit = set()
            for idx, (n_out, winit) in self._nout_replaced.items():
                layers[idx].n_out = n_out
                layers[idx].weight_init = winit
                reinit.add(idx)
                if idx + 1 < len(layers) and hasattr(layers[idx + 1], "n_in"):
                    layers[idx + 1].n_in = n_out
                    reinit.add(idx + 1)

            # append new layers (shape-infer their n_in from predecessor)
            it = None
            if conf.input_type is not None:
                it = conf.input_type
                for l in layers:
                    it = l.output_type(it)
            for l in self._added:
                l.apply_defaults(conf.global_conf.defaults_dict())
                if it is not None:
                    l.set_n_in(it)
                    it = l.output_type(it)
                layers.append(l)
                params.append(None)  # init below
                state.append(None)

            # freeze front
            if self._freeze_until is not None:
                for i in range(min(self._freeze_until + 1, len(layers))):
                    if not isinstance(layers[i], FrozenLayer):
                        layers[i] = FrozenLayer(inner=layers[i])

            if self._fine_tune is not None:
                self._fine_tune.apply(conf)

            conf._finalized = True
            net = MultiLayerNetwork(conf, device=src.device)
            gc = conf.global_conf
            gen = torch.Generator().manual_seed(gc.seed)
            dtype = DTYPES[gc.dtype]
            fresh = [flatten_params(l.init(gen, dtype)) for l in layers]
            new_params, new_state = [], []
            for i, l in enumerate(layers):
                keep = params[i] is not None and i not in reinit
                new_params.append(params[i] if keep else fresh[i])
                new_state.append(state[i] if keep and state[i] is not None
                                 else l.init_state(dtype, src.device))
            return net.set_params(new_params, new_state)


class TransferLearningHelper:
    """Featurization helper (parity: TransferLearningHelper.java): run the
    frozen front once per dataset, train only the unfrozen tail on the
    cached features (module docstring: the tail trains its own copies,
    written back into the full network by copy)."""

    def __init__(self, net: MultiLayerNetwork,
                 frozen_until: Optional[int] = None):
        if frozen_until is None:
            # infer: leading FrozenLayer prefix
            frozen_until = -1
            for i, l in enumerate(net.layers):
                if isinstance(l, FrozenLayer):
                    frozen_until = i
                else:
                    break
        self.frozen_until = frozen_until
        self.full_net = net
        # tail network over the unfrozen suffix
        conf = MultiLayerConfiguration.from_json(net.conf.to_json())
        tail_layers = conf.layers[frozen_until + 1:]
        tail_conf = MultiLayerConfiguration(
            global_conf=conf.global_conf, layers=tail_layers,
            input_type=None, backprop_type=conf.backprop_type,
            tbptt_fwd_length=conf.tbptt_fwd_length,
            tbptt_back_length=conf.tbptt_back_length)
        tail_conf._finalized = True
        self.unfrozen = MultiLayerNetwork(tail_conf, device=net.device)
        self.unfrozen.set_params(_cloned(net.params[frozen_until + 1:]),
                                 net.state[frozen_until + 1:])

    @torch.no_grad()
    def featurize(self, ds: DataSet) -> DataSet:
        """The frozen front's activations of ``ds.features`` (inference
        mode), as host arrays, with ``ds``'s labels and masks."""
        net = self.full_net
        act, _ = net._forward(net.params, net._as_input(ds.features),
                              upto=self.frozen_until + 1)
        return DataSet(act.float().cpu().numpy(), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def fit_featurized(self, ds: DataSet):
        self.unfrozen.fit(ds)
        # write the trained tail into the full net's own tensors
        full = self.full_net.params
        with torch.no_grad():
            for i, p in enumerate(self.unfrozen.params):
                for k, v in p.items():
                    full[self.frozen_until + 1 + i][k].copy_(v)
        self.full_net._params_version += 1
        return self

    def unfrozen_mln(self) -> MultiLayerNetwork:
        return self.unfrozen
