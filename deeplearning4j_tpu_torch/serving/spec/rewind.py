"""Carry and positional decode state, for speculative rewind.

Counterpart of deeplearning4j_tpu/serving/spec/rewind.py. A draft or
verify advances decode state by several positions, then rolls back to the
accepted prefix:

- positional leaves (attention KV caches: dense ``k``/``v``, paged
  ``pk``/``pv``, the layer's ``positional_state_keys``) are written at
  explicit positions and read through a causal mask, so rejected rows
  stay where they are and are rewritten before any query reaches them;
- carry leaves (recurrent (h, c)) depend on every earlier token, so they
  are snapshotted at every position and restored to the snapshot after
  the last accepted token.

The helpers walk a model's decode state (a list for a MultiLayerNetwork,
a dict by node name for a ComputationGraph) with the owning layer in
hand. Inside a program the result is written into the resident state
(``into``): new carries and stacks are copied into its tensors, which a
captured graph reads and writes by address; positional leaves are the
resident ones already.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers.base import copy_into, map_tree


def layer_entries(model):
    """``[(key, layer)]``: ``key`` indexes the model's decode state
    (layer index, or layer-node name for a graph)."""
    if hasattr(model.conf, "network_inputs"):
        return [(n, model.conf.nodes[n].layer)
                for n in model.conf.topological_order
                if model.conf.nodes[n].kind == "layer"]
    return list(enumerate(model.layers))


def _map_sub(sub, pos_keys, on_carry, on_positional, rest):
    """One layer's decode state: dict entries under ``pos_keys`` are
    positional, every other leaf (tuples of carries, bare tensors) a
    carry."""
    if sub is None:
        return None
    if isinstance(sub, dict):
        return {k: map_tree(on_positional if k in pos_keys else on_carry,
                             v, *[r[k] for r in rest])
                for k, v in sub.items()}
    return map_tree(on_carry, sub, *rest)


def map_state(model, dstate, on_carry, on_positional, rest=(), into=None):
    """``dstate`` rebuilt with ``on_carry`` over carry leaves and
    ``on_positional`` over positional ones; the matching leaves of the
    ``rest`` trees ride along as extra arguments. With ``into`` (a state
    of the same structure) the result is copied into it in place, and
    ``into`` returned."""
    out = dict(dstate) if isinstance(dstate, dict) else list(dstate)
    for key, layer in layer_entries(model):
        pos_keys = frozenset(getattr(layer, "positional_state_keys", ()))
        out[key] = _map_sub(dstate[key], pos_keys, on_carry, on_positional,
                            [r[key] for r in rest])
    return out if into is None else copy_into(into, out)


def rewound_state(model, new_d, stacks, idx, rows):
    """Post-verify state: positional leaves pass through; a layer that
    returned a carry snapshot stack (K, B, ...) is rolled back to
    ``stack[idx, rows]`` (the carry after each row's last emitted
    token). The verify program copies the state it ends with (after the
    commit and the freeze) into the resident one."""
    out = dict(new_d) if isinstance(new_d, dict) else list(new_d)
    for key, _layer in layer_entries(model):
        st = stacks[key]
        if st is not None:
            out[key] = map_tree(lambda s: s[idx, rows], st)
    return out
