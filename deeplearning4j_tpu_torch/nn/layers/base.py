"""Layer base protocol, registry and JSON serde.

Counterpart of deeplearning4j_tpu/nn/layers/base.py. A layer is a
dataclass holding its configuration; its parameters are a plain dict of
tensors under the JAX package's keys (``W``, ``RW``, ``b``), so a
checkpoint's arrays load into either package. A layer's updater is an
``nn.updaters.Updater`` (the JSON's dict is read into one); its dropout a
float drop probability or an ``nn.dropout.IDropout``, its weight noise an
``nn.weightnoise.IWeightNoise`` (the JSON's ``@dropout`` / ``@noise``
dicts are read into them).

A wrapper's parameters nest (Bidirectional: ``{"fwd": {...}, "bwd":
{...}}``; the VAE's stacks are lists, ``{"enc": [{...}, ...]}``), as in
the JAX package. The containers keep every layer's parameters as one flat
dict keyed by path (``fwd/W``, ``enc/0/W``: the JAX package's checkpoint
and optax key paths), which the updaters, the fused update and the
checkpoint walk as they walk a plain layer's; ``flatten_params`` /
``nest_params`` convert, and a layer's ``init`` and ``apply`` see the
nested form.

Protocol:
- ``set_n_in(input_type)`` -- infer input width.
- ``output_type(input_type)`` -- shape inference.
- ``init(gen, dtype, device)`` -- parameter dict ({} if parameterless).
- ``init_state(dtype, device)`` -- the non-trainable state, a dict of
  tensors ({} when the layer keeps none; BatchNormalization's running
  mean and variance).
- ``apply(params, x, *, train=False, gen=None, mask=None[, state=None])``
  -- the forward: ``train`` and a ``torch.Generator`` (where the JAX
  package takes ``rng``) switch on the layer's dropout; ``mask`` is the
  (B, T) feature mask of a sequence input. A layer with state takes
  ``state`` (the containers pass it to such layers only): it reads it,
  and under ``train`` writes its new value into the tensors it was given,
  in place (where the JAX layer returns it); given ``state=None`` under
  ``train`` it writes nothing.
- ``reg_loss(params)`` / ``apply_constraints(params)`` -- training.
- ``init_decode_state`` / ``decode_step`` -- one token at a time, and
  their paged forms (``init_paged_decode_state`` / ``decode_step_paged``).
- ``prefill_chunk`` -- a chunk of prompt positions in one call;
  ``tree_chunk`` / ``tree_commit`` -- score a speculation token tree, then
  write the accepted path's positional state (``positional_state_keys``
  names a layer's position-indexed decode-state keys).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.dropout import IDropout, apply_dropout
from deeplearning4j_tpu_torch.nn.updaters import Updater
from deeplearning4j_tpu_torch.nn.weightnoise import IWeightNoise

LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def map_tree(fn, tree, *rest):
    """``fn`` over the tensor leaves of a tree of dicts, lists and tuples
    (None passes through), with the matching leaves of ``rest`` as extra
    arguments."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def copy_into(dst, src):
    """Copy every tensor leaf of ``src`` into the matching leaf of ``dst``
    in place, skipping a leaf that already is ``dst``'s (state written in
    place, such as a KV cache): a program's new carries land in the
    resident state it read. Returns ``dst``."""
    def put(d, s):
        if s is not d:
            d.copy_(s)
        return d
    map_tree(put, dst, src)
    return dst


def where_rows(keep, new, old):
    """``new`` where the (B,) mask ``keep`` holds, else ``old``."""
    return torch.where(keep.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


# fields every layer may inherit from the global configuration
INHERITABLE = ("activation", "weight_init", "updater", "l1", "l2", "dropout",
               "bias_init", "dist", "weight_noise")


@dataclass
class Layer:
    """Base layer config. ``None`` hyperparameters inherit the network-level
    defaults at build time."""
    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[tuple] = None            # for weight_init='distribution'
    bias_init: Optional[float] = None
    updater: Optional[Updater] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[Any] = None            # drop probability or IDropout
    weight_noise: Optional[Any] = None       # IWeightNoise
    constraints: Optional[tuple] = None

    # a frozen layer (special.FrozenLayer) gets no updater and writes no
    # state; the containers read this
    frozen = False

    # ---- config protocol -------------------------------------------------
    def apply_defaults(self, defaults: Dict[str, Any]):
        for f in INHERITABLE:
            if hasattr(self, f) and getattr(self, f) is None and f in defaults:
                setattr(self, f, defaults[f])

    def validate(self) -> None:
        """Fail fast on an unknown activation or loss name at build time."""
        from deeplearning4j_tpu_torch.nn.activations import get_activation
        if getattr(self, "activation", None) is not None:
            get_activation(self.activation)
        if getattr(self, "loss", None) is not None:
            from deeplearning4j_tpu_torch.nn.losses import get_loss
            get_loss(self.loss)

    def set_n_in(self, input_type: InputType) -> None:
        pass

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    # ---- runtime protocol ------------------------------------------------
    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, dtype=torch.float32, device=None
                   ) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        raise NotImplementedError

    def has_params(self) -> bool:
        return True

    def draws_noise(self) -> bool:
        """Whether the layer, or a layer it wraps, draws random numbers at
        train time (a dropout or a weight noise configured)."""
        d = self.dropout
        if (isinstance(d, IDropout) or (d is not None and d > 0.0)
                or self.weight_noise is not None):
            return True
        return any(isinstance(getattr(self, f.name), Layer)
                   and getattr(self, f.name).draws_noise()
                   for f in dataclasses.fields(self))

    def maybe_dropout(self, x, *, train, gen):
        """The layer's dropout on its input activations, at train time
        with a generator only (the reference applies it before the
        layer's own math)."""
        if not train or gen is None:
            return x
        return apply_dropout(self.dropout, x, gen)

    # ---- training ---------------------------------------------------------
    def reg_loss(self, params):
        """l1/l2 penalty the container adds to the loss over a layer's
        (path-keyed) parameters; biases and normalisation parameters are
        exempt, as in the reference."""
        l1 = self.l1 or 0.0
        l2 = self.l2 or 0.0
        if (l1 == 0.0 and l2 == 0.0) or not params:
            return 0.0
        total = 0.0
        for k, v in params.items():
            # the first element of a path key decides, as the JAX package
            # tests the top-level key (a nested ``bwd`` is exempt whole)
            top = k.split("/")[0]
            if top.startswith("b") or top in ("beta", "gamma", "mean", "var"):
                continue
            # |v| as where(v >= 0, v, -v): its gradient at exactly 0 is
            # 1, as jnp.abs's is (torch's abs gives 0 there)
            total = (total + l1 * torch.where(v >= 0, v, -v).sum()
                     + 0.5 * l2 * (v ** 2).sum())
        return total

    def apply_constraints(self, params):
        """Post-update parameter constraints (parity: nn/conf/constraint/*):
        ('maxnorm', m), ('unitnorm',), ('nonneg',), ('minmaxnorm', lo, hi),
        over every axis but the last; biases are exempt, and so are nested
        parameters (path keys), as in the JAX package."""
        if not self.constraints or not params:
            return params
        kind = self.constraints[0]
        arg = self.constraints[1] if len(self.constraints) > 1 else 1.0
        out = dict(params)
        for k, v in params.items():
            if k.startswith("b") or "/" in k:
                continue
            if kind == "nonneg":
                out[k] = torch.clamp(v, min=0.0)
                continue
            axes = tuple(range(v.ndim - 1))
            n = torch.sqrt((v ** 2).sum(dim=axes, keepdim=True))
            if kind == "maxnorm":
                out[k] = v * torch.clamp(n, 0, arg) / torch.clamp(n, min=1e-8)
            elif kind == "unitnorm":
                out[k] = v / torch.clamp(n, min=1e-8)
            elif kind == "minmaxnorm":
                lo, hi = self.constraints[1], self.constraints[2]
                out[k] = v * torch.clamp(n, lo, hi) / torch.clamp(n, min=1e-8)
        return out

    # ---- incremental decode protocol --------------------------------------
    def init_decode_state(self, params, batch: int, max_len: int = 0,
                          dtype=torch.float32, device=None):
        """Per-slot decode state for ``batch`` streams (None = stateless).
        Recurrent layers return their (h, c) carry; attention a KV cache of
        ``max_len`` positions."""
        return None

    def decode_step(self, params, dstate, x, pos=None):
        """One token step on ``x`` (B, 1, F) at positions ``pos`` (B,);
        returns (y, new_dstate)."""
        return self.apply(params, x), dstate

    # ---- paged decode protocol (serving/kv/): layers without a KV cache
    # keep their per-slot state and ignore the page tables
    def init_paged_decode_state(self, params, batch: int, max_len: int,
                                num_blocks: int, block_size: int,
                                dtype=torch.float32, device=None):
        return self.init_decode_state(params, batch, max_len, dtype, device)

    def decode_step_paged(self, params, dstate, x, pos, block_tables):
        return self.decode_step(params, dstate, x, pos)

    # decode-state dict keys indexed by token position (attention's KV
    # caches): speculative rewind leaves them in place and restores only
    # the other leaves, the recurrent carries, from snapshots
    positional_state_keys = ()

    def _decode_one(self, params, dstate, x, pos, block_tables):
        if block_tables is None:
            return self.decode_step(params, dstate, x, pos)
        return self.decode_step_paged(params, dstate, x, pos, block_tables)

    def prefill_chunk(self, params, dstate, x, start, n, block_tables=None,
                      carry_stack=False):
        """Advance prompt positions ``start .. start+K-1`` in one call:
        ``x`` (B, K, F), ``start`` and ``n`` (B,) (rows t >= n[b] are
        padding: their state is not advanced and their outputs are
        garbage). Returns ``(y, new_dstate)``, y (B, K, F_out); with
        ``carry_stack`` also the carry after every position stacked along
        a leading (K, ...) axis (None for a layer without a carry).

        A stateless layer applies the whole chunk; a stateful one steps
        ``decode_step`` through it, each row frozen past its count: the
        trajectory of a token-at-a-time prefill."""
        if dstate is None:
            y = self.apply(params, x)
            return (y, dstate, None) if carry_stack else (y, dstate)
        K = x.shape[1]
        ys, snaps, d = [], [], dstate
        for t in range(K):
            y, nd = self._decode_one(params, d, x[:, t:t + 1], start + t,
                                     block_tables)
            live = t < n
            d = map_tree(lambda a, b: where_rows(live, a, b), nd, d)
            ys.append(y[:, 0])
            snaps.append(d)
        y = torch.stack(ys, dim=1)
        if not carry_stack:
            return y, d
        return y, d, map_tree(lambda *s: torch.stack(s), *snaps)

    def tree_chunk(self, params, dstate, x, pos0, tree, n,
                   block_tables=None):
        """Score the N nodes of a speculation token tree
        (``serving.spec.tree.TreeSpec``) in one call: ``x`` (B, N, F) in
        tree order, node i at position ``pos0 + tree.depth[i]`` seeing its
        own root-path only; ``n`` (B,) the emit budget. Returns ``(y,
        dstate, carry_stack, kv_window)``: outputs (B, N, F_out), the
        state unchanged, the carry after each node stacked along a leading
        (N, ...) axis (None without a carry) and the nodes' fresh K/V rows
        (attention only, else None).

        A stateless layer applies the nodes; a stateful one steps
        ``decode_step`` over them, each node from its parent's carry."""
        if dstate is None:
            return self.apply(params, x), dstate, None, None
        snaps, ys = [], []
        for i in range(x.shape[1]):
            par = int(tree.parent[i])
            y, nd = self._decode_one(
                params, dstate if par < 0 else snaps[par], x[:, i:i + 1],
                pos0 + int(tree.depth[i]), block_tables)
            snaps.append(nd)
            ys.append(y[:, 0])
        return (torch.stack(ys, dim=1), dstate,
                map_tree(lambda *s: torch.stack(s), *snaps), None)

    def tree_commit(self, params, dstate, kv_window, path, pos0, commit_n,
                    block_tables=None):
        """Write the accepted root-path's positional state: ``path`` (B,
        D+1) the accepted node at each depth, ``commit_n`` (B,) the depths
        to write (0 = an inert row). A no-op here: carries roll back
        through the snapshot stack instead (serving/spec/rewind.py)."""
        return dstate

    # ---- serde -----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (Layer, Updater, IDropout, IWeightNoise)):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        d["@type"] = type(self).__name__
        return d

    @classmethod
    def _from_dict_fields(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            if k == "updater" and isinstance(v, dict):
                v = Updater.from_dict(v)
            elif isinstance(v, dict) and "@noise" in v:
                v = IWeightNoise.from_dict(v)
            elif isinstance(v, dict) and "@dropout" in v:
                v = IDropout.from_dict(v)
            elif isinstance(v, dict) and "@type" in v:
                v = layer_from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)


def layer_from_dict(d: Dict[str, Any]) -> Layer:
    kind = d["@type"]
    if kind not in LAYER_REGISTRY:
        raise ValueError(f"layer type {kind!r} is not ported yet "
                         f"(ported: {sorted(LAYER_REGISTRY)})")
    return LAYER_REGISTRY[kind]._from_dict_fields(d)


def flatten_params(params, prefix: str = "") -> Dict:
    """A (possibly nested) parameter tree as one flat dict keyed by path,
    in the nested order: ``{"fwd": {"W": w}}`` -> ``{"fwd/W": w}``, and a
    list by index, ``{"enc": [{"W": w}]}`` -> ``{"enc/0/W": w}`` (the JAX
    package's checkpoint and optax key paths)."""
    out = {}
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _lists(tree):
    """Every dict of ``tree`` whose keys are 0..n-1 as a list."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _lists(v) for k, v in tree.items()}
    if tree and set(tree) == {str(i) for i in range(len(tree))}:
        return [tree[str(i)] for i in range(len(tree))]
    return tree


def nest_params(flat: Dict[str, Any]) -> Dict:
    """The inverse of ``flatten_params`` (an index path segment rebuilds
    a list); a dict without path keys is returned as it is."""
    if not any("/" in k for k in flat):
        return flat
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return {k: _lists(v) for k, v in out.items()}


def require_dims(layer, **dims):
    """Validate that inferred/declared dims are set before init."""
    for k, v in dims.items():
        if not v or v <= 0:
            raise ValueError(
                f"{type(layer).__name__}: {k}={v} is not set. Provide "
                f"set_input_type(...) on the ListBuilder or set {k} "
                f"explicitly on the layer.")


def as_pair(v):
    """An int-or-pair hyperparameter as a 2-tuple."""
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)
