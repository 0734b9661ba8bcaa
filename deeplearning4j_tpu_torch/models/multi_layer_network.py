"""MultiLayerNetwork -- the sequential container, inference only.

Counterpart of deeplearning4j_tpu/models/multi_layer_network.py: ``init``,
the forward with stacked-LSTM pair fusion, ``output``, ``rnn_time_step`` /
``rnn_clear_previous_state``, ``init_decode_state`` / ``decode_step``,
``save`` and ``load``. Parameters are a list of per-layer dicts of tensors
on the network's device, under the JAX package's keys.

The network runs on CUDA unless constructed with ``device="cpu"``; without
a card and without that argument, construction raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.rnn import (apply_lstm_pair,
                                                    lstm_pair_fusable)
from deeplearning4j_tpu_torch.ops import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def params_from_numpy(arrays: List[Dict[str, np.ndarray]], device=None
                      ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer dicts of numpy arrays (e.g. the JAX package's params read
    back with ``np.asarray``) -> the port's parameters on ``device``."""
    dev = resolve_device(device)
    return [{k: torch.from_numpy(np.array(v)).to(dev) for k, v in p.items()}
            for p in arrays]


def _cast_floats(params, dtype):
    return [{k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in p.items()} for p in params]


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        conf.finalize()
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.params: Optional[List[Dict[str, torch.Tensor]]] = None
        self._rnn_carries = None      # stored state for rnn_time_step
        self._serving = None          # bucketed inference engine (lazy)

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None):
        """Initialize parameters from ``seed`` (default: the configuration's)
        on a CPU ``torch.Generator``, so a seed gives the same weights on
        every device."""
        gc = self.conf.global_conf
        gen = torch.Generator().manual_seed(gc.seed if seed is None else seed)
        dtype = DTYPES[gc.dtype]
        self.params = [{k: v.to(self.device) for k, v in
                        l.init(gen, dtype).items()} for l in self.layers]
        self._serving = None
        return self

    def set_params(self, params: List[Dict[str, torch.Tensor]]):
        self.params = [{k: v.to(self.device) for k, v in p.items()}
                       for p in params]
        return self

    def _as_input(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x)).to(self.device)

    # ----------------------------------------------------------- forward core
    def _forward(self, params, x, carries=None):
        """Forward through every layer. Returns (act, new_carries).
        Consecutive stacked LSTMs fuse into ONE wavefront kernel; the
        stateful-carry path (rnn_time_step) stays per layer."""
        gc = self.conf.global_conf
        if gc.compute_dtype:
            cdt = DTYPES[gc.compute_dtype]
            x = x.to(cdt)
            params = _cast_floats(params, cdt)
        n = len(self.layers)
        new_carries = list(carries) if carries is not None else None
        i = 0
        while i < n:
            l = self.layers[i]
            if (new_carries is None and i + 1 < n and x.ndim == 3
                    and lstm_pair_fusable(l, self.layers[i + 1], params[i],
                                          params[i + 1], x)):
                x = apply_lstm_pair(l, self.layers[i + 1], params[i],
                                    params[i + 1], x)
                i += 2
                continue
            if new_carries is not None and hasattr(l, "apply_with_carry"):
                x, new_carries[i] = l.apply_with_carry(params[i], x,
                                                       new_carries[i])
            else:
                x = l.apply(params[i], x)
            i += 1
        return x, new_carries

    # ------------------------------------------------------------- inference
    def serving_engine(self, **kw):
        """The shape-bucketed inference engine for this net (lazy; keyword
        args are honored on first construction only)."""
        if self._serving is None:
            from deeplearning4j_tpu_torch.serving.engine import \
                InferenceEngine
            self._serving = InferenceEngine(self, **kw)
        return self._serving

    @torch.no_grad()
    def output(self, x, bucketed: bool = True) -> torch.Tensor:
        """Forward pass to network output (parity: output). The default
        pads the batch up to a power-of-two bucket and slices the pad rows
        off (serving/engine.py); ``bucketed=False`` runs the exact shape."""
        x = self._as_input(x)
        if bucketed:
            return self.serving_engine().predict(x)
        return self._forward(self.params, x)[0]

    @torch.no_grad()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful single/multi-step inference (parity: rnnTimeStep)."""
        x = self._as_input(x)
        if x.ndim == 2:
            x = x[:, None, :]
        if self._rnn_carries is None:
            self._rnn_carries = [None] * len(self.layers)
        act, self._rnn_carries = self._forward(self.params, x,
                                               carries=self._rnn_carries)
        return act

    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    # --------------------------------------------------- incremental decode
    def init_decode_state(self, batch: int):
        """Per-layer decode state for ``batch`` concurrent streams: the
        (h, c) carry of each recurrent layer, None for the others."""
        gc = self.conf.global_conf
        dt = DTYPES[gc.compute_dtype or gc.dtype]
        return [l.init_decode_state(p, batch, dt, self.device)
                for l, p in zip(self.layers, self.params)]

    @torch.no_grad()
    def decode_step(self, params, dstate, x_t):
        """One-token step through the stack: ``x_t`` (B, 1, F). Returns
        (y, new_dstate)."""
        gc = self.conf.global_conf
        if gc.compute_dtype:
            cdt = DTYPES[gc.compute_dtype]
            x_t = x_t.to(cdt)
            params = _cast_floats(params, cdt)
        x = x_t
        new_d = list(dstate)
        for i, l in enumerate(self.layers):
            x, new_d[i] = l.decode_step(params[i], dstate[i], x)
        return x, new_d

    # ------------------------------------------------------------- utilities
    def save(self, path):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(self, path)

    @staticmethod
    def load(path, device=None) -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.util.model_serializer import \
            restore_multi_layer_network
        return restore_multi_layer_network(path, device=device)
