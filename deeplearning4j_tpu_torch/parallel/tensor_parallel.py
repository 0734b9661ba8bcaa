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
Speculation's ``tree_chunk`` runs once a shard too, each over its heads,
its cache and its own window of the nodes' K/V (the extra outputs come
back as lists in shard order), and ``tree_commit`` writes each shard's
window into that shard's cache. An int8 / fp8 set is the whole float32
tree quantized first (one scale a last-axis channel of the WHOLE weight),
then split: a column split cuts codes and scales alike, a row split cuts
the codes and gives every shard the whole scale (``split``); a shard is
never quantized on its own.

Training policies, as the one-slot step has them: a compute dtype (the
model's, or the bf16 train-precision policy) casts the float32 shards to
compute-dtype copies at use (``Shards.to``), the masters stay float32,
and a product over shards sums its partials in float32 and rounds once,
as one product does (a row split's output, a column split's input
gradient: ``_ColProducts``); weight noise is drawn on each weight's full
shape from the step's generator, in the one-slot step's order, then
split (``_ShardNoise``); a constraint runs after the update over each
member's shards, the norm of a leaf split on a dim it reduces over
summed from the shards' squares (``_constrain``).

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
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, map_tree,
                                                     rescaled_by_norm)
from deeplearning4j_tpu_torch.nn.layers.conv import ConvolutionLayer, _conv2d
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.layers.rnn import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.updaters import normalize_layer_grad
from deeplearning4j_tpu_torch.quant.qtensor import QTensor

_DENSE = (DenseLayer, OutputLayer, RnnOutputLayer)
_NOT_ELEMENTWISE = ("softmax", "logsoftmax")
_SEP = "@"
_NARROW = (torch.bfloat16, torch.float16)


class Shards:
    """One parameter split over the model axis: its shards in shard order
    and the dim they split."""

    def __init__(self, parts: List[torch.Tensor], dim: int):
        self.parts, self.dim = list(parts), dim

    def full(self) -> torch.Tensor:
        return torch.cat(self.parts, self.dim)

    def is_floating_point(self) -> bool:
        return self.parts[0].is_floating_point()

    def to(self, dtype) -> "Shards":
        """Each shard cast (a compute-dtype copy; autograd reaches the
        float32 shards through it)."""
        return Shards([p.to(dtype) for p in self.parts], self.dim)

    def like(self, full: torch.Tensor) -> "Shards":
        """``full`` (this leaf's whole shape) split as this leaf is."""
        sizes = [p.shape[self.dim] for p in self.parts]
        return Shards(list(torch.split(full, sizes, self.dim)), self.dim)


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
    """A layer's parameters with every split leaf gathered (nested dicts
    too)."""
    return {k: v.full() if isinstance(v, Shards)
            else full_params(v) if isinstance(v, dict) else v
            for k, v in p.items()}


def split_parts(leaf, spec, m: int) -> list:
    """``leaf`` (a tensor or a ``QTensor`` of the whole weight) as its
    ``m`` shards by ``spec`` (``split_leaf``'s contiguous copies). A
    QTensor's codes split as the weight; its scale (one a last-axis
    channel) splits with a column split and is whole in every shard with
    a row split."""
    if not isinstance(leaf, QTensor):
        return split_leaf(leaf, spec, m)
    dim = split_dim(spec)
    codes = split_leaf(leaf.codes, spec, m)
    scales = (split_leaf(leaf.scale, spec, m) if leaf.scale.shape[dim] > 1
              else [leaf.scale.clone() for _ in range(m)])
    return [QTensor(c, sc) for c, sc in zip(codes, scales)]


def gather_parts(parts, spec):
    """``split_parts``' inverse: the whole leaf from its shards."""
    if not isinstance(parts[0], QTensor):
        return gather_leaf(parts, spec)
    dim = split_dim(spec)
    scale = parts[0].scale if parts[0].scale.shape[dim] == 1 else \
        gather_leaf([p.scale for p in parts], spec)
    return QTensor(gather_leaf([p.codes for p in parts], spec), scale)


class _ShardNoise:
    """A layer's weight noise over its shard leaves: the noise of each
    split leaf drawn on the full weight's shape from the step's generator,
    in the one-slot step's order (the layer's own ``apply`` over the
    gathered leaves), then split as the leaf is; gradients reach the
    shards through the gather."""

    def __init__(self, noise):
        self.noise = noise

    def apply(self, params: Dict, gen) -> Dict:
        full = self.noise.apply(full_params(params), gen)
        return {k: v.like(full[k]) if isinstance(v, Shards) else full[k]
                for k, v in params.items()}


def _is_col(W) -> bool:
    return isinstance(W, Shards) and W.dim == W.parts[0].ndim - 1


def _is_row(W) -> bool:
    return isinstance(W, Shards) and W.dim == 0 and W.parts[0].ndim == 2


def _row_sum(xs, ws):
    """The row-split product: each shard's input slice times its weight
    rows, summed in shard order. In bfloat16 / float16 the partials are
    taken and summed in float32 and rounded once, as one product over
    every row accumulates in float32 and rounds once."""
    dt = ws[0].dtype
    wide = dt in _NARROW
    y = None
    for xp, w in zip(xs, ws):
        t = xp.float() @ w.float() if wide else xp @ w
        y = t if y is None else y + t
    return y.to(dt) if wide else y


class _ColProducts(torch.autograd.Function):
    """``x`` times each column shard of a bfloat16 / float16 weight. The
    input's gradient is the shards' partials taken and summed in float32
    and rounded once, as one product over every column accumulates in
    float32 and rounds once (autograd would round each partial and sum in
    the narrow type)."""

    @staticmethod
    def forward(ctx, x, *ws):
        ctx.save_for_backward(x, *ws)
        return tuple(x @ w for w in ws)

    @staticmethod
    def backward(ctx, *gys):
        x, *ws = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        dx, dws = None, []
        for g, w in zip(gys, ws):
            g2 = g.reshape(-1, g.shape[-1])
            t = g2.float() @ w.float().T
            dx = t if dx is None else dx + t
            dws.append(x2.T @ g2)
        return (dx.to(x.dtype).reshape(x.shape), *dws)


def _col_products(x, ws) -> List[torch.Tensor]:
    """``x @ w`` for each column shard ``w`` in shard order."""
    if ws[0].dtype in _NARROW and torch.is_grad_enabled():
        return list(_ColProducts.apply(x, *ws))
    return [x @ w for w in ws]


def _bias_part(b, s: int, m: int):
    return None if b is None else b.chunk(m, -1)[s]


class _Heads(MultiHeadAttention):
    """One model shard's heads of a MultiHeadAttention: H/m heads over
    its column shards of ``Wq`` / ``Wk`` / ``Wv`` (and ``bq`` / ``bk`` /
    ``bv``) and its row shard of ``Wo``, without the output bias, which
    is added once after the shards' partial sums. Every decode method is
    MultiHeadAttention's own, over the shard's cache or pool."""

    def _project_out(self, params, o, B, T, dt):
        o = o.reshape(B, T, self.n_out).to(dt)
        if dt in _NARROW:     # a float32 partial: the shards' sum rounds once
            return o.float() @ params["Wo"].float()
        return o @ params["Wo"]


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
        attr = getattr(self.inner, name)
        if name == "apply_with_carry":
            # a recurrent layer's carried run (truncated BPTT) over its
            # gathered parameters and input
            return lambda params, x, carry=None, mask=None: attr(
                full_params(params), gather(x), carry, mask=mask)
        return attr

    @property
    def weight_noise(self):
        wn = self.inner.weight_noise
        return None if wn is None else _ShardNoise(wn)

    def reg_loss(self, params):
        return self.inner.reg_loss(full_params(params))

    def _input(self, x, train, gen):
        """The layer's dropout on its (gathered) input."""
        return self.inner.maybe_dropout(gather(x), train=train, gen=gen)

    # ---------------------------------------------------------------- dense
    def _dense_pre(self, p, x, train, gen, promote=False):
        """The dense pre-activation on shards: a Split for a column-split
        ``W``, the summed partials for a row-split one. ``promote``: a
        lower-precision input meets the weights in the wider type, as the
        output layers' ``compute_score`` has it."""
        inner, m = self.inner, self.m
        W, b = p["W"], (p.get("b") if inner.has_bias else None)
        if not (isinstance(x, Split) and _is_row(W)
                and not (train and gen is not None and inner.dropout)):
            x = self._input(x, train, gen)
            if x.ndim >= 4 or (x.ndim == 3 and x.shape[-1] != inner.n_in):
                x = x.reshape(x.shape[0], -1)  # implicit CNN->FF flatten
        if promote:
            wdt = (W.parts[0] if isinstance(W, Shards) else W).dtype
            x = (Split([q.to(torch.promote_types(q.dtype, wdt))
                        for q in x.parts]) if isinstance(x, Split)
                 else x.to(torch.promote_types(x.dtype, wdt)))
        if _is_col(W):
            return Split([y + (0 if b is None else _bias_part(b, s, m))
                          for s, y in enumerate(_col_products(x, W.parts))])
        if _is_row(W):
            xs = x.parts if isinstance(x, Split) else \
                torch.split(x, [w.shape[0] for w in W.parts], dim=-1)
            y = _row_sum(xs, W.parts)
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
        qs, ks, vs = (_col_products(x, p[n].parts)
                      for n in ("Wq", "Wk", "Wv"))
        os = []
        for s in range(m):
            q, k, v = qs[s], ks[s], vs[s]
            if inner.has_bias:
                q = q + _bias_part(p["bq"], s, m)
                k = k + _bias_part(p["bk"], s, m)
                v = v + _bias_part(p["bv"], s, m)
            o = scaled_dot_product_attention(
                q.reshape(B, T, H, Dh), k.reshape(B, T, H, Dh),
                v.reshape(B, T, H, Dh), causal=inner.causal, mask=mask,
                train=train)
            os.append(o.reshape(B, T, H * Dh).to(q.dtype))
        out = _row_sum(os, p["Wo"].parts)
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
        pre = gather(self._dense_pre(params, x, train, gen, promote=True))
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
        decode state; the outputs summed in shard order, then ``bo``; any
        further output (``tree_chunk``'s K/V window) as a list in shard
        order, None where no shard has one."""
        x = gather(x)
        y, states, rest = None, {}, []
        for s in range(self.m):
            out = getattr(self.heads, name)(
                self._shard_params(params, s),
                {k: v[s] for k, v in dstate.items()}, x, *args, **kw)
            y = out[0] if y is None else y + out[0]
            for k, v in out[1].items():
                states.setdefault(k, []).append(v)
            rest.append(out[2:])
        if x.dtype in _NARROW:
            y = y.to(x.dtype)
        if self.inner.has_bias:
            y = y + params["bo"]
        extra = tuple(None if all(r[i] is None for r in rest)
                      else [r[i] for r in rest] for i in range(len(rest[0])))
        return (y, states) + extra

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
        """A verify's scoring: over head shards, each shard's K8 over its
        heads of the nodes' effective caches; the window a list of the
        shards' ``{"k", "v"}`` (B, N, H/m, Dh)."""
        return self._decode("tree_chunk", params, dstate, x, pos0, tree, n,
                            block_tables=block_tables)

    def tree_commit(self, params, dstate, kv_window, path, pos0, commit_n,
                    block_tables=None):
        """The accepted path's K/V written into each shard's cache from
        that shard's window."""
        if self.heads is None:
            return self.inner.tree_commit(params, dstate, kv_window, path,
                                          pos0, commit_n,
                                          block_tables=block_tables)
        outs = [self.heads.tree_commit(
            None, {k: v[s] for k, v in dstate.items()}, kv_window[s], path,
            pos0, commit_n, block_tables=block_tables)
            for s in range(self.m)]
        return {k: [o[k] for o in outs] for k in outs[0]}

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


def _copy_leaf(dst, src) -> None:
    """``src`` into ``dst`` in place (a QTensor by its codes and scale)."""
    if isinstance(dst, QTensor):
        dst.codes.copy_(src.codes)
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


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


def _undivided_heads(layers, specs, m: int):
    """The first ``(member, layer)`` of attention whose head count the
    model axis does not divide while ``param_spec`` splits its ``Wq``;
    None when there is none."""
    for mk, layer in layers.items():
        if (type(layer) is MultiHeadAttention
                and specs.get(mk, {}).get("Wq") and layer.n_heads % m):
            return mk, layer
    return None


def _container_layers(model):
    """``[(member, layer)]``: a graph's layer nodes, or an MLN's layers."""
    if isinstance(model.params, dict):
        return [(n, model.conf.nodes[n].layer)
                for n in model.conf.layer_nodes()]
    return list(enumerate(model.layers))


def heads_divide(model, m: int, axis: str = "model") -> bool:
    """Whether ``model``'s tensor-parallel form over ``m`` shards can be
    built: every head-split attention layer's heads divide over them."""
    specs = dict(_members(tree_specs(model.params, m, axis)))
    return _undivided_heads(dict(_container_layers(model)), specs,
                            m) is None


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
        self.layers = dict(_container_layers(model))
        self.specs = dict(_members(tree_specs(model.params, self.m, axis)))
        bad = _undivided_heads(self.layers, self.specs, self.m)
        if bad:
            mk, layer = bad
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
        """A parameter tree in the container's structure (its own, a swap
        candidate, an int8 / fp8 tree quantized whole, or a subset of its
        members keyed by member) as leaves keyed like ``params`` -- each
        split leaf as its shards (``W@0``, ``W@1``, ...; ``split_parts``),
        the others cloned -- or, with ``into``, copied into those leaves
        in place."""
        out = {} if into is None else into
        for mk, p in _members(tree):
            d = out.setdefault(mk, {})
            for k, v in p.items():
                spec = self.specs[mk][k]
                if split_dim(spec) is None:
                    parts = {k: v}
                else:
                    parts = {f"{k}{_SEP}{s}": c for s, c in
                             enumerate(split_parts(v, spec, self.m))}
                for key, c in parts.items():
                    if into is not None:
                        _copy_leaf(d[key], c)
                    elif c is not v:
                        d[key] = c
                    else:
                        d[key] = (QTensor(c.codes.clone(), c.scale.clone())
                                  if isinstance(c, QTensor)
                                  else c.detach().clone())
        return out

    def gather(self, leaves) -> Dict:
        """``split``'s inverse: the leaves keyed like ``params`` (a set's
        shards, float or quantized) as whole leaves by member, in the
        container's keys."""
        out = {}
        for mk, p in _members(self.model.params):
            if mk not in leaves:
                continue
            out[mk] = {k: leaves[mk][k] if self._split(mk, k) is None
                       else gather_parts([leaves[mk][f"{k}{_SEP}{s}"]
                                          for s in range(self.m)],
                                         self.specs[mk][k])
                       for k in p}
        return out

    def sync(self) -> None:
        """Reload the shards when the container's parameters moved since
        the last ``load`` / ``store``."""
        if self.model._params_version != self.version:
            self.load()

    # ----------------------------------------------------------- training
    def view(self, leaves):
        """The container-shaped parameters over ``leaves`` (every member,
        or a subset: a MultiLayerNetwork's in member order): a split leaf
        as ``Shards`` of its shard leaves."""
        out = {}
        for mk, p in _members(self.model.params):
            if mk not in leaves:
                continue
            d = {}
            for k in p:
                dim = self._split(mk, k)
                d[k] = leaves[mk][k] if dim is None else Shards(
                    [leaves[mk][f"{k}{_SEP}{s}"] for s in range(self.m)], dim)
            out[mk] = d
        return out if self.graph else [out[i] for i in sorted(out)]

    def gradients(self, loss_of, scale=None):
        """(loss, gradients keyed like ``self.params``, new carries):
        ``loss_of(net, params)`` is the container's (loss, new carries)
        through the tensor-parallel copy ``net`` at the shard view
        ``params``; ``scale`` multiplies the loss before the backward.
        The carries come back detached."""
        leaves = {mk: {k: v.detach().requires_grad_(v.is_floating_point())
                       for k, v in p.items()}
                  for mk, p in self.params.items()}
        with torch.enable_grad():
            loss, carries = loss_of(self.shadow, self.view(leaves))
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
        return loss.detach(), grads, map_tree(lambda t: t.detach(), carries)

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
            self._constrain(mk)

    def _constrain(self, mk) -> None:
        """The member's constraints (``Layer.apply_constraints``) after
        its update, in place over its shards: elementwise ones shard by
        shard; a norm over every axis but the last from the squared norms
        of each shard, summed over the shards where the leaf is split on
        an axis the norm spans (a row split), each shard's own where the
        split is the last axis (a column split)."""
        layer, p = self.layers[mk], self.params[mk]
        if not layer.constraints:
            return
        kind = layer.constraints[0]
        for k in dict(_members(self.model.params))[mk]:
            if k.startswith("b") or "/" in k:
                continue
            dim = self._split(mk, k)
            if dim is None:
                p[k].copy_(layer.apply_constraints({k: p[k]})[k])
                continue
            parts = [p[f"{k}{_SEP}{s}"] for s in range(self.m)]
            if kind == "nonneg":
                for v in parts:
                    v.clamp_(min=0.0)
                continue
            axes = tuple(range(parts[0].ndim - 1))
            sq = [(v ** 2).sum(dim=axes, keepdim=True) for v in parts]
            if dim != parts[0].ndim - 1:
                total = sq[0]
                for q in sq[1:]:
                    total = total + q
                sq = [total] * self.m
            for v, q in zip(parts, sq):
                v.copy_(rescaled_by_norm(layer.constraints, v,
                                         torch.sqrt(q)))
