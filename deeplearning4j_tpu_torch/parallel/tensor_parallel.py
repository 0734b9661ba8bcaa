"""Tensor parallelism: a container's layers computed on model shards.

The port's counterpart of what GSPMD does with the JAX executor's
``param_spec`` placement (deeplearning4j_tpu/exec/executor.py:57-77 and
the 2-D mesh of deeplearning4j_tpu/parallel/wrapper.py): where XLA places
each weight leaf by its spec and inserts the collectives, this module
splits every leaf the spec splits into ``m`` shards on the mesh's
``model`` slots (``Executor.put_params``'s rule) and each shard computes
with its own shard:

- Dense and output layers: a column-split ``W`` gives the shard's slice
  of the output features; a row-split ``W`` gives a partial sum over the
  shard's slice of the input, and the partial sums are added in shard
  order. A column-split layer that feeds a row-split one passes its
  activation on split, with no exchange (Megatron's pair, ``ff1`` ->
  ``ff2``); everywhere else a split activation is gathered (concatenated
  in shard order).
- ``MultiHeadAttention``: ``Wq`` / ``Wk`` / ``Wv`` are column-split on
  head boundaries, so each shard holds H/m whole heads and attends over
  them through ``scaled_dot_product_attention`` -- K5 on the card, and K6
  + K7 under autograd (``ops.flash_attention``); ``Wo`` is row-split and
  the shards' outputs are summed. A head count the model size does not
  divide would put ``param_spec``'s split inside a head: it raises
  ``ValueError`` when the form is built.
- ``ConvolutionLayer``: the kernel's output channels (its last dim) are
  column-split; the shards' cuDNN outputs are concatenated.
- Any other split leaf is gathered at use, as GSPMD does for a
  non-contracting use: TinyTransformer's positional table (its row-shape
  rule splits it over positions), an LSTM's kernels.

Training: gradients reach each shard through autograd; each shard's
gradients and updater state stay split, and the update is the JAX
per-leaf path (``fused=False``, deeplearning4j_tpu/parallel/wrapper.py:
140-146): each member's updater chain over its leaves, a split leaf's
shards as leaves of their own (``W@0``, ``W@1``, ...; the state keys
follow, ``0/.mu/W@0``). Every stage the updaters have is elementwise, and
a norm over a member (``ClipByGlobalNorm``, the per-layer gradient
normalizations) sums over all its shards, so the update is the unsplit
one. An updater-state leaf is split as its own parameter is (by path):
the JAX executor co-shards it with the first parameter of its shape,
harmless under GSPMD but wrong for an explicit split.

Serving (the bucketed engine's forward and the decode engine's programs,
serving/engine.py and serving/decode.py) runs the same form without its
training state (``train=False``) over an engine-owned shard set
(``split``): the forward through ``TPLayer.apply``, and every decode
method of an attention layer once a shard over that shard's H/m heads
(``_Heads``): its KV cache is split on whole heads, (B, C, H/m, Dh) a
shard dense and (num_blocks, block_size, H/m, Dh) a shard paged, each a
list in shard order under the layer's own keys, so K8 / K9 run over each
shard's heads beside its column shards of ``Wq`` / ``Wk`` / ``Wv``; the
shards' ``Wo`` partials are summed in shard order. A layer with no split
of its own decodes through ``TPLayer.apply`` where its decode method is
``Layer``'s (dense layers: column or row split), else through its own
method over gathered parameters (the positional table, an LSTM).
Speculation (``tree_chunk`` / ``tree_commit``) over head shards is not
ported (ROADMAP item 7).

The shards of one rank live on its card (exec/mesh.py: the model axis
lies within one rank's slots). They are resident: the captured gradient
and update programs (parallel/wrapper.py) read them by address, and the
update writes them in place. ``store`` writes the gathered, full
parameters and updater state back into the container.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.exec.executor import (gather_leaf, split_dim,
                                                    split_leaf, tree_specs)
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.fused_update import _split_key
from deeplearning4j_tpu_torch.nn.layers.attention import (
    MultiHeadAttention, scaled_dot_product_attention)
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.conv import ConvolutionLayer, _conv2d
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.layers.rnn import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.updaters import normalize_layer_grad

_DENSE = (DenseLayer, OutputLayer, RnnOutputLayer)
_NOT_ELEMENTWISE = ("softmax", "logsoftmax")
_SEP = "@"


class Shards:
    """One parameter split over the model axis: its shards in shard order
    and the dim they split."""

    def __init__(self, parts: List[torch.Tensor], dim: int):
        self.parts, self.dim = list(parts), dim

    def full(self) -> torch.Tensor:
        return torch.cat(self.parts, self.dim)


class Split:
    """An activation split over its last (feature) dim, one part a
    shard."""

    def __init__(self, parts: List[torch.Tensor]):
        self.parts = list(parts)

    @property
    def ndim(self) -> int:       # the containers' loops read it
        return self.parts[0].ndim


def gather(x):
    """A split activation concatenated in shard order; anything else as
    it is."""
    return torch.cat(x.parts, -1) if isinstance(x, Split) else x


def full_params(p: Dict) -> Dict:
    """A layer's parameters with every split leaf gathered."""
    return {k: v.full() if isinstance(v, Shards) else v for k, v in p.items()}


def _is_col(W) -> bool:
    return isinstance(W, Shards) and W.dim == W.parts[0].ndim - 1


def _is_row(W) -> bool:
    return isinstance(W, Shards) and W.dim == 0 and W.parts[0].ndim == 2


def _bias_part(b, s: int, m: int):
    return None if b is None else b.chunk(m, -1)[s]


class _Heads(MultiHeadAttention):
    """One model shard's heads of a MultiHeadAttention: H/m heads over
    its column shards of ``Wq`` / ``Wk`` / ``Wv`` (and ``bq`` / ``bk`` /
    ``bv``) and its row shard of ``Wo``, without the output bias, which
    is added once after the shards' partial sums. Every decode method is
    MultiHeadAttention's own, over the shard's cache or pool."""

    def _project_out(self, params, o, B, T, dt):
        return o.reshape(B, T, self.n_out).to(dt) @ params["Wo"]


def heads_of(layer: MultiHeadAttention, m: int) -> _Heads:
    """The per-shard layer of ``layer`` split over ``m`` model shards."""
    kw = {f.name: getattr(layer, f.name) for f in dataclasses.fields(layer)}
    kw.update(n_out=(layer.n_out or layer.n_in) // m,
              n_heads=layer.n_heads // m)
    return _Heads(**kw)


class TPLayer:
    """A layer of the tensor-parallel form: ``apply`` and
    ``compute_score`` on model shards (``Shards`` leaves, ``Split``
    activations); every other attribute is the layer's own. With
    ``emit_split`` a column-split dense layer hands its activation on
    split (its consumers are row-split)."""

    def __init__(self, layer, m: int, emit_split: bool = False,
                 heads: Optional[_Heads] = None):
        self.inner, self.m, self.emit_split = layer, m, emit_split
        # an attention layer whose Wq / Wk / Wv split on head boundaries:
        # the layer one shard's heads decode through
        self.heads = heads

    def __getattr__(self, name):
        if name in ("inner", "heads"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    def reg_loss(self, params):
        return self.inner.reg_loss(full_params(params))

    def _input(self, x, train, gen):
        """The layer's dropout on its (gathered) input."""
        return self.inner.maybe_dropout(gather(x), train=train, gen=gen)

    # ---------------------------------------------------------------- dense
    def _dense_pre(self, p, x, train, gen):
        """The dense pre-activation on shards: a Split for a column-split
        ``W``, the summed partials for a row-split one."""
        inner, m = self.inner, self.m
        W, b = p["W"], (p.get("b") if inner.has_bias else None)
        if not (isinstance(x, Split) and _is_row(W)
                and not (train and gen is not None and inner.dropout)):
            x = self._input(x, train, gen)
            if x.ndim >= 4 or (x.ndim == 3 and x.shape[-1] != inner.n_in):
                x = x.reshape(x.shape[0], -1)  # implicit CNN->FF flatten
        if _is_col(W):
            return Split([x @ w + (0 if b is None else _bias_part(b, s, m))
                          for s, w in enumerate(W.parts)])
        if _is_row(W):
            xs = x.parts if isinstance(x, Split) else \
                torch.split(x, [w.shape[0] for w in W.parts], dim=-1)
            y = xs[0] @ W.parts[0]
            for xp, w in zip(xs[1:], W.parts[1:]):
                y = y + xp @ w
            return y if b is None else y + b
        y = x @ (W.full() if isinstance(W, Shards) else W)
        return y if b is None else y + b

    def _dense(self, p, x, train, gen):
        act = get_activation(self.inner.activation or "identity")
        pre = self._dense_pre(p, x, train, gen)
        if isinstance(pre, Split) and self.emit_split:
            return Split([act(q) for q in pre.parts])
        return act(gather(pre))

    # ------------------------------------------------------------ attention
    def _attention(self, p, x, train, gen, mask):
        inner, m = self.inner, self.m
        x = self._input(x, train, gen)
        B, T, _ = x.shape
        H, Dh = inner.n_heads // m, inner.head_dim
        out = None
        for s in range(m):
            q, k, v = (x @ p[n].parts[s] for n in ("Wq", "Wk", "Wv"))
            if inner.has_bias:
                q = q + _bias_part(p["bq"], s, m)
                k = k + _bias_part(p["bk"], s, m)
                v = v + _bias_part(p["bv"], s, m)
            o = scaled_dot_product_attention(
                q.reshape(B, T, H, Dh), k.reshape(B, T, H, Dh),
                v.reshape(B, T, H, Dh), causal=inner.causal, mask=mask,
                train=train)
            part = o.reshape(B, T, H * Dh).to(q.dtype) @ p["Wo"].parts[s]
            out = part if out is None else out + part
        return out + p["bo"] if inner.has_bias else out

    # -------------------------------------------------------------- conv
    def _conv(self, p, x, train, gen):
        inner, m = self.inner, self.m
        x = self._input(x, train, gen)
        act = get_activation(inner.activation or "identity")
        b = p.get("b") if inner.has_bias else None
        pads = inner._window_pads(x)
        return torch.cat([act(_conv2d(x, w, _bias_part(b, s, m), inner.stride,
                                      pads, inner.dilation))
                          for s, w in enumerate(p["W"].parts)], dim=-1)

    def apply(self, params, x, *, train=False, gen=None, mask=None, **kw):
        inner, t = self.inner, type(self.inner)
        W = params.get("W")
        if t in _DENSE and isinstance(W, Shards) and W.parts[0].ndim == 2:
            return self._dense(params, x, train, gen)
        if t is MultiHeadAttention and isinstance(params.get("Wq"), Shards):
            return self._attention(params, x, train, gen, mask)
        if t is ConvolutionLayer and _is_col(W) and W.parts[0].ndim == 4:
            return self._conv(params, x, train, gen)
        return inner.apply(full_params(params), gather(x), train=train,
                           gen=gen, mask=mask, **kw)

    def compute_score(self, params, x, labels, mask=None, *, train=False,
                      gen=None):
        inner = self.inner
        W = params.get("W")
        if not (type(inner) in (OutputLayer, RnnOutputLayer)
                and isinstance(W, Shards) and W.parts[0].ndim == 2):
            return inner.compute_score(full_params(params), gather(x),
                                       labels, mask, train=train, gen=gen)
        pre = gather(self._dense_pre(params, x, train, gen))
        if pre.ndim == 3:  # (B, T, C) time-distributed loss
            B, T, C = pre.shape
            pre = pre.reshape(B * T, C)
            labels = labels.reshape(B * T, -1)
            if mask is not None:
                mask = mask.reshape(B * T)
        return get_loss(inner.loss)(labels, pre, inner.activation or "softmax",
                                    mask)


    # ---------------------------------------------------------- decoding
    def _shard_params(self, p, s: int) -> Dict:
        """Shard ``s``'s parameters of a head-split attention layer."""
        out = {n: p[n].parts[s] for n in ("Wq", "Wk", "Wv", "Wo")}
        if self.inner.has_bias:
            for n in ("bq", "bk", "bv"):
                out[n] = _bias_part(p[n], s, self.m)
        return out

    def _over_heads(self, name, params, dstate, x, *args, **kw):
        """``name`` once a shard, over the shard's heads and its own
        decode state; the outputs summed in shard order, then ``bo``."""
        x = gather(x)
        y, states, rest = None, {}, ()
        for s in range(self.m):
            out = getattr(self.heads, name)(
                self._shard_params(params, s),
                {k: v[s] for k, v in dstate.items()}, x, *args, **kw)
            y = out[0] if y is None else y + out[0]
            for k, v in out[1].items():
                states.setdefault(k, []).append(v)
            rest = out[2:]
        if self.inner.has_bias:
            y = y + params["bo"]
        return (y, states) + tuple(rest)

    def _decode(self, name, params, dstate, x, *args, **kw):
        """A decode method: over head shards, through ``apply`` on shards
        where the method is ``Layer``'s own, else the layer's own method
        over the gathered parameters and input."""
        if self.heads is not None:
            return self._over_heads(name, params, dstate, x, *args, **kw)
        base = getattr(Layer, name)
        if getattr(type(self.inner), name) is base:
            return base(self, params, dstate, x, *args, **kw)
        return getattr(self.inner, name)(full_params(params), dstate,
                                         gather(x), *args, **kw)

    def decode_step(self, params, dstate, x, pos=None):
        return self._decode("decode_step", params, dstate, x, pos)

    def decode_step_paged(self, params, dstate, x, pos, block_tables):
        return self._decode("decode_step_paged", params, dstate, x, pos,
                            block_tables)

    def _decode_one(self, params, dstate, x, pos, block_tables):
        return Layer._decode_one(self, params, dstate, x, pos, block_tables)

    def prefill_chunk(self, params, dstate, x, start, n, block_tables=None,
                      carry_stack=False):
        return self._decode("prefill_chunk", params, dstate, x, start, n,
                            block_tables=block_tables,
                            carry_stack=carry_stack)

    def tree_chunk(self, params, dstate, x, pos0, tree, n,
                   block_tables=None):
        if self.heads is not None:
            raise NotImplementedError(
                "speculative decoding over attention head shards is not "
                "ported (ROADMAP item 7)")
        return self._decode("tree_chunk", params, dstate, x, pos0, tree, n,
                            block_tables=block_tables)

    def tree_commit(self, params, dstate, kv_window, path, pos0, commit_n,
                    block_tables=None):
        if self.heads is not None:
            raise NotImplementedError(
                "speculative decoding over attention head shards is not "
                "ported (ROADMAP item 7)")
        return self.inner.tree_commit(params, dstate, kv_window, path, pos0,
                                      commit_n, block_tables=block_tables)

    def _state_over_heads(self, name, *args):
        parts = [getattr(self.heads, name)(None, *args)
                 for _ in range(self.m)]
        return {k: [p[k] for p in parts] for k in parts[0]}

    def init_decode_state(self, params, batch, max_len=0,
                          dtype=torch.float32, device=None):
        """A head-split attention layer's cache as its shards' caches
        ((B, C, H/m, Dh) each, a list in shard order under ``k`` / ``v``);
        any other layer's own state."""
        if self.heads is not None:
            return self._state_over_heads("init_decode_state", batch,
                                          max_len, dtype, device)
        return self.inner.init_decode_state(full_params(params), batch,
                                            max_len, dtype, device)

    def init_paged_decode_state(self, params, batch, max_len, num_blocks,
                                block_size, dtype=torch.float32,
                                device=None):
        """The pool split on its head dim, one (num_blocks, block_size,
        H/m, Dh) pool a shard under ``pk`` / ``pv``."""
        if self.heads is not None:
            return self._state_over_heads(
                "init_paged_decode_state", batch, max_len, num_blocks,
                block_size, dtype, device)
        return self.inner.init_paged_decode_state(
            full_params(params), batch, max_len, num_blocks, block_size,
            dtype, device)


def _members(tree):
    return list(tree.items()) if isinstance(tree, dict) \
        else list(enumerate(tree))


def _normalize(g: Dict, kind, thr) -> Dict:
    """A member's gradient normalization over its shard leaves: norms per
    member sum over every shard; the per-parameter kinds group a leaf's
    shards back together."""
    if not g or not kind or kind == "None":
        return g
    if kind not in ("ClipL2PerParamType", "RenormalizeL2PerParamType"):
        return normalize_layer_grad(g, kind, thr)
    groups: Dict[str, List[str]] = {}
    for k in g:
        groups.setdefault(k.split(_SEP)[0], []).append(k)
    out = {}
    for ks in groups.values():
        norm = torch.sqrt(sum((g[k] ** 2).sum() for k in ks))
        floor = torch.clamp(norm, min=1e-12)
        sc = torch.clamp(thr / floor, max=1.0) if kind.startswith("Clip") \
            else 1.0 / floor
        out.update({k: g[k] * sc for k in ks})
    return out


class TensorParallel:
    """The tensor-parallel form of a MultiLayerNetwork or ComputationGraph
    over ``model_size`` model shards: the spec of every leaf, the resident
    shards of the split ones (the others are the container's own
    tensors), the updater state split by path, and a copy of the
    container whose layers are ``TPLayer``s. ``train=False`` (the serving
    engines) builds the specs and the copy only: an engine keeps its own
    shard set (``split``) and reads it through ``view``."""

    def __init__(self, model, model_size: int, axis: str = "model",
                 train: bool = True):
        self.model, self.m, self.axis = model, int(model_size), axis
        self.graph = isinstance(model.params, dict)
        gc = model.conf.global_conf
        if gc.compute_dtype or (train
                                and model._compute_dtype(True) is not None):
            raise NotImplementedError(
                "tensor parallelism computes in the parameters' dtype; a "
                "compute dtype or the bf16 train-precision policy is not "
                "taken (ROADMAP item 7)")
        self.layers = dict(self._layers())
        for key, layer in self.layers.items():
            if train and (layer.weight_noise is not None
                          or layer.constraints):
                raise NotImplementedError(
                    f"layer {key!r}: weight noise and constraints are not "
                    "taken under tensor parallelism (ROADMAP item 7)")
        self.specs = dict(_members(tree_specs(model.params, self.m, axis)))
        for mk, layer in self.layers.items():
            sp = self.specs.get(mk, {})
            if (type(layer) is MultiHeadAttention and sp.get("Wq")
                    and layer.n_heads % self.m):
                raise ValueError(
                    f"layer {mk!r}: {layer.n_heads} heads do not divide over "
                    f"{self.m} model shards; param_spec's split of Wq / Wk / "
                    "Wv would fall inside a head")
        self.shadow = self._shadow()
        self.params: Dict = {}
        self.opt: Dict = {}
        self._scalars: Optional[torch.Tensor] = None
        self._built = False
        if train:
            self.load()

    # ------------------------------------------------------------- layout
    def _layers(self):
        if self.graph:
            return [(n, self.model.conf.nodes[n].layer)
                    for n in self.model.conf.layer_nodes()]
        return list(enumerate(self.model.layers))

    def _split(self, mk, k) -> Optional[int]:
        return split_dim(self.specs[mk][k])

    def _row_consumer(self, layer, mk) -> bool:
        """Whether ``layer`` (member ``mk``) takes a split input: a dense
        layer with a row-split ``W`` and no dropout."""
        return (type(layer) in _DENSE and self._split(mk, "W") == 0
                and not layer.dropout and layer.weight_noise is None
                and self.specs[mk]["W"] and len(self.specs[mk]["W"]) == 2)

    def _emits_split(self, mk, layer, consumers) -> bool:
        act = (layer.activation or "identity").lower()
        return (type(layer) is DenseLayer and self.specs.get(mk)
                and self._split(mk, "W") == len(self.specs[mk]["W"]) - 1
                and len(self.specs[mk]["W"]) == 2
                and act not in _NOT_ELEMENTWISE and consumers
                and all(c is not None and self._row_consumer(*c)
                        for c in consumers))

    def _heads(self, mk, layer) -> Optional[_Heads]:
        """The per-shard layer of a head-split attention member."""
        if type(layer) is MultiHeadAttention \
                and split_dim(self.specs.get(mk, {}).get("Wq", ())) \
                is not None:
            return heads_of(layer, self.m)
        return None

    def _shadow(self):
        """A shallow copy of the container whose layers are ``TPLayer``s."""
        model = self.model
        shadow = copy.copy(model)
        if not self.graph:
            L = model.layers
            shadow.layers = [TPLayer(l, self.m, self._emits_split(
                i, l, [(L[i + 1], i + 1)] if i + 1 < len(L) else []),
                self._heads(i, l)) for i, l in enumerate(L)]
            return shadow
        conf = model.conf
        consumers: Dict[str, list] = {}
        for name, node in conf.nodes.items():
            for i in node.inputs:
                consumers.setdefault(i, []).append(
                    (node.layer, name) if node.kind == "layer" else None)
        outs = set(conf.network_outputs)
        nodes = {}
        for name, node in conf.nodes.items():
            if node.kind == "layer":
                node = copy.copy(node)
                node.layer = TPLayer(node.layer, self.m, name not in outs
                                     and self._emits_split(
                                         name, conf.nodes[name].layer,
                                         consumers.get(name, [])),
                                     self._heads(name, node.layer))
            nodes[name] = node
        shadow.conf = copy.copy(conf)
        shadow.conf.nodes = nodes
        return shadow

    # ------------------------------------------------------- model <-> shards
    def _leaves(self):
        """(updater state?, the container's dict, the shards' dict, key,
        shard key stem, spec) of every parameter and updater-state leaf;
        a state leaf takes its own parameter's spec (by path)."""
        opts = dict(_members(self.model.opt_state))
        for mk, p in _members(self.model.params):
            mine = self.params.setdefault(mk, {})
            for k in p:
                yield False, p, mine, k, k, self.specs[mk][k]
            mine, names = self.opt.setdefault(mk, {}), list(p)
            for ok in list(opts[mk]):
                slot, name = _split_key(ok, names)
                yield (True, opts[mk], mine, ok, f"{slot}/{name}",
                       () if name is None else self.specs[mk][name])

    @torch.no_grad()
    def load(self) -> None:
        """The container's parameters and updater state split into the
        resident shards by ``exec.executor.split_leaf`` (copied in place
        once built); unsplit leaves are the container's own tensors."""
        for _, own, mine, k, stem, spec in self._leaves():
            if split_dim(spec) is None:
                mine[k] = own[k]
                continue
            for s, c in enumerate(split_leaf(own[k], spec, self.m)):
                key = f"{stem}{_SEP}{s}"
                if self._built:
                    mine[key].copy_(c)
                else:
                    mine[key] = c
        self._built = True
        self.version = self.model._params_version

    @torch.no_grad()
    def store(self) -> None:
        """The gathered parameters and updater state (and the counts)
        written into the container's own tensors: ``load``'s inverse, by
        ``exec.executor.gather_leaf``."""
        for opt, own, mine, k, stem, spec in self._leaves():
            if split_dim(spec) is not None:
                own[k].copy_(gather_leaf(
                    [mine[f"{stem}{_SEP}{s}"] for s in range(self.m)], spec))
            elif opt:       # the container's own tensor, or a new count
                own[k] = mine[k]
        self.model._params_version += 1
        self.version = self.model._params_version

    @torch.no_grad()
    def split(self, tree, into: Optional[Dict] = None) -> Dict:
        """A parameter tree in the container's structure (its own, or a
        swap candidate) as leaves keyed like ``params`` -- each split leaf
        as its shards (``W@0``, ``W@1``, ...), the others cloned -- or,
        with ``into``, copied into those leaves in place."""
        out = {} if into is None else into
        for mk, p in _members(tree):
            d = out.setdefault(mk, {})
            for k, v in p.items():
                spec = self.specs[mk][k]
                if split_dim(spec) is None:
                    parts = {k: v}
                else:
                    parts = {f"{k}{_SEP}{s}": c for s, c in
                             enumerate(split_leaf(v, spec, self.m))}
                for key, c in parts.items():
                    if into is None:
                        d[key] = c.detach().clone() if c is v else c
                    else:
                        d[key].copy_(c)
        return out

    def sync(self) -> None:
        """Reload the shards when the container's parameters moved since
        the last ``load`` / ``store``."""
        if self.model._params_version != self.version:
            self.load()

    # ----------------------------------------------------------- training
    def view(self, leaves):
        """The container-shaped parameters over ``leaves``: a split leaf as
        ``Shards`` of its shard leaves."""
        out = {}
        for mk, p in _members(self.model.params):
            d = {}
            for k in p:
                dim = self._split(mk, k)
                d[k] = leaves[mk][k] if dim is None else Shards(
                    [leaves[mk][f"{k}{_SEP}{s}"] for s in range(self.m)], dim)
            out[mk] = d
        return out if self.graph else [out[i] for i in range(len(out))]

    def gradients(self, loss_of, scale=None):
        """(loss, gradients keyed like ``self.params``): ``loss_of(net,
        params)`` is the container's loss through the tensor-parallel
        copy ``net`` at the shard view ``params``; ``scale`` multiplies
        the loss before the backward."""
        leaves = {mk: {k: v.detach().requires_grad_(v.is_floating_point())
                       for k, v in p.items()}
                  for mk, p in self.params.items()}
        with torch.enable_grad():
            loss = loss_of(self.shadow, self.view(leaves))
            if scale is not None:
                loss = loss * scale
            flat = [v for p in leaves.values() for v in p.values()]
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(got)
        grads = {}
        for mk, p in leaves.items():
            grads[mk] = {}
            for k, v in p.items():
                g = next(it)
                grads[mk][k] = torch.zeros_like(v) if g is None else g
        return loss.detach(), grads

    def _transforms(self):
        t = self.model._transforms
        return [(mk, t[mk]) for mk, _ in _members(self.model.params)
                if t[mk] is not None]

    def stage(self) -> None:
        """The next update's count-derived scalars, computed on the host
        and copied into one device buffer the update reads."""
        vals = [v for mk, t in self._transforms()
                for v in t.scalars(self.opt[mk])]
        dev = next(v for p in self.params.values() for v in p.values()).device
        if self._scalars is None:        # resident: the update reads it
            self._scalars = torch.zeros(max(1, len(vals)),
                                        dtype=torch.float32, device=dev)
        if vals:
            self._scalars.copy_(torch.tensor(vals, dtype=torch.float32))

    def advance(self) -> None:
        for mk, t in self._transforms():
            self.opt[mk] = t.advance(self.opt[mk])

    @torch.no_grad()
    def apply_updates(self, grads) -> None:
        """The per-leaf update (the device half; capturable): each
        member's normalization and updater chain over its shard leaves,
        written in place."""
        gc = self.model.conf.global_conf
        kind, thr = gc.gradient_normalization, \
            gc.gradient_normalization_threshold
        j = 0
        for mk, t in self._transforms():
            sc = [self._scalars[j + i] for i in range(t.n_scalars)]
            j += t.n_scalars
            g = _normalize(grads[mk], kind, thr)
            p = self.params[mk]
            u, slots = t.apply(g, self.opt[mk], p, sc)
            for k, v in p.items():
                v.copy_(v + u[k])
            for k, v in slots.items():
                self.opt[mk][k].copy_(v)
