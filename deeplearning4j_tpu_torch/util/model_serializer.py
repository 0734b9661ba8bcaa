"""Model persistence: the JAX package's zip checkpoint, read and written.

Counterpart of deeplearning4j_tpu/util/model_serializer.py for
MultiLayerNetworks and ComputationGraphs. The zip holds ``meta.json`` (the
kind, and the ``iteration``, ``epoch`` and ``epoch_batch`` counters),
``configuration.json``, ``coefficients.npz`` (one array per parameter
under keys like ``0/RW`` -- layer index / parameter name, a wrapper's
nested parameters by path, ``0/fwd/RW`` -- or, for a graph,
``b0_attn/Wq`` -- node name / parameter name), ``modelState.npz`` (the
layer state, BatchNormalization's running statistics, under the same
keys: ``1/mean``, ``stem_bn/var``), when saved ``updaterState.npz`` (the
updater state under the JAX package's optax key paths, e.g.
``0/0/.mu/W`` -- layer index or node name / chain index / field /
parameter), and, when given, ``normalizer.json`` (data/normalizers.py's
document; ``restore_normalizer`` reads it). Arrays go
through numpy, so a zip written by either package loads, and resumes
training, in the other. Writing to a path is atomic and durable: staged to
a temp file, fsynced, renamed over the destination, and the directory
fsynced so the rename survives a crash. ``restore_into`` loads a zip into
an existing network in place (``fit(resume_from=)``), the state copied
into the network's own tensors; ``read_meta`` reads the counters alone;
``guess_model`` restores whichever container a zip holds;
``load_weights`` reads only the arrays, shaped as a model's trees, for a
serving engine's hot swap.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
import zlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.errors import (CorruptCheckpointError,
                                                       WeightSwapError)

CONFIG_NAME = "configuration.json"
COEFF_NAME = "coefficients.npz"
STATE_NAME = "modelState.npz"
UPDATER_NAME = "updaterState.npz"
NORMALIZER_NAME = "normalizer.json"
META_NAME = "meta.json"


def _read_member(z: zipfile.ZipFile, path, name: str) -> bytes:
    try:
        return z.read(name)
    except KeyError as e:
        raise CorruptCheckpointError(path, member=name,
                                     detail="member missing") from e
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError) as e:
        raise CorruptCheckpointError(path, member=name, detail=str(e)) from e


def _loadz(z: zipfile.ZipFile, path, name: str) -> dict:
    raw = _read_member(z, path, name)
    try:
        data = np.load(io.BytesIO(raw), allow_pickle=False)
        return {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, ValueError, zlib.error, EOFError, OSError) as e:
        raise CorruptCheckpointError(path, member=name, detail=str(e)) from e


def _savez(z: zipfile.ZipFile, name: str, arrays: dict):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    z.writestr(name, buf.getvalue())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        raise TypeError("bfloat16 parameters have no numpy dtype; save the "
                        "float32 parameters instead")
    return t.numpy()


def _items(per_layer):
    """(key, dict) pairs of a network's per-layer tree: list index for a
    MultiLayerNetwork, node name for a ComputationGraph."""
    return (per_layer.items() if isinstance(per_layer, dict)
            else enumerate(per_layer))


def _flatten(per_layer) -> dict:
    return {f"{i}/{k}": _to_numpy(v)
            for i, p in _items(per_layer) for k, v in p.items()}


def _kind(model) -> str:
    return ("ComputationGraph" if hasattr(model.conf, "network_inputs")
            else "MultiLayerNetwork")


def write_model(model, path, save_updater=True, normalizer=None):
    """Write ``model`` (a MultiLayerNetwork or a ComputationGraph) to a
    checkpoint zip, with its updater state unless ``save_updater`` is
    False, and ``normalizer`` when given."""
    flat = _flatten(model.params)
    path = os.fspath(path)
    tmp = os.path.join(os.path.dirname(os.path.abspath(path)),
                       f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as fh:
            with zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED) as z:
                z.writestr(META_NAME, json.dumps({
                    "format": "deeplearning4j_tpu/model/v1",
                    "kind": _kind(model),
                    "iteration": int(model.iteration),
                    "epoch": int(model.epoch),
                    "epoch_batch": int(model._epoch_batch)}))
                z.writestr(CONFIG_NAME, model.conf.to_json())
                _savez(z, COEFF_NAME, flat)
                _savez(z, STATE_NAME, _flatten(model.state or {}))
                if save_updater and model.opt_state is not None:
                    _savez(z, UPDATER_NAME, _flatten(model.opt_state))
                if normalizer is not None:
                    z.writestr(NORMALIZER_NAME,
                               json.dumps(normalizer.to_dict()))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:        # make the rename itself durable; best effort on odd FSes
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _fill(path, member, flat, templates):
    """Arrays of ``flat`` shaped and typed like ``templates`` (per-layer
    dicts in a list, or by node name), keyed ``layer/key``; a missing or
    misshapen array raises."""
    out = {}
    for i, tmpl in _items(templates):
        p = {}
        for k, t in tmpl.items():
            key = f"{i}/{k}"
            if key not in flat:
                raise CorruptCheckpointError(path, member=member,
                                             detail=f"missing array {key!r}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise CorruptCheckpointError(
                    path, member=member,
                    detail=f"{key!r} has shape {arr.shape}, the "
                           f"configuration needs {tuple(t.shape)}")
            p[k] = torch.as_tensor(arr).to(device=t.device, dtype=t.dtype)
        out[i] = p
    return out if isinstance(templates, dict) else list(out.values())


def _open_zip(path) -> zipfile.ZipFile:
    try:
        return zipfile.ZipFile(path, "r")
    except zipfile.BadZipFile as e:
        raise CorruptCheckpointError(path, detail=str(e)) from e


def _read_meta(z: zipfile.ZipFile, path) -> dict:
    try:
        return json.loads(_read_member(z, path, META_NAME))
    except json.JSONDecodeError as e:
        raise CorruptCheckpointError(path, member=META_NAME,
                                     detail=str(e)) from e


def read_meta(path) -> dict:
    """A checkpoint's metadata (kind, iteration, epoch, epoch_batch)
    without loading any tensor."""
    with _open_zip(path) as z:
        return _read_meta(z, path)


def _set_counters(model, meta):
    model.iteration = int(meta.get("iteration", 0))
    model.epoch = int(meta.get("epoch", 0))
    model._epoch_batch = int(meta.get("epoch_batch", 0))


def _copy_into(dst_tree, src_tree):
    """Copy every tensor of ``src_tree`` into the same key of ``dst_tree``
    in place: a fused update's per-layer dicts view its flat buffers, which
    captured graphs read by address."""
    for (_, dst), (_, src) in zip(_items(dst_tree), _items(src_tree)):
        for k, v in src.items():
            dst[k].copy_(v)


def restore_into(model, path, load_updater=True):
    """Load a checkpoint's parameters, counters and (when the zip has it
    and ``load_updater``) updater state into ``model``, an existing
    network of the zip's kind, in place: every tensor is copied into the
    network's own, so its fused update and captured graphs keep their
    buffers, and the host-side updater counts (which stage Adam's bias
    correction) follow the zip's. The zip's configuration is not read.
    Returns ``model``."""
    kind = type(model).__name__
    with _open_zip(path) as z:
        meta = _read_meta(z, path)
        if meta.get("kind") != kind:
            raise ValueError(f"Expected {kind}, zip holds {meta.get('kind')}")
        flat = _loadz(z, path, COEFF_NAME)
        st = _loadz(z, path, STATE_NAME)
        upd = (_loadz(z, path, UPDATER_NAME)
               if load_updater and UPDATER_NAME in z.namelist() else None)
    if model.params is None:
        model.init()
    params = _fill(path, COEFF_NAME, flat, model.params)
    state = _fill(path, STATE_NAME, st, model.state)
    opt = None if upd is None else _fill(path, UPDATER_NAME, upd,
                                         model.opt_state)
    with torch.no_grad():
        _copy_into(model.params, params)
        _copy_into(model.state, state)
        model._params_version += 1
        if opt is not None:
            _copy_into(model.opt_state, opt)
    _set_counters(model, meta)
    return model


def _unflatten_into(templates, flat):
    """``flat``'s arrays (keyed ``layer/key``) in the structure of
    ``templates`` (per-layer dicts in a list, or by node name); a missing
    key raises KeyError."""
    out = {i: {k: flat[f"{i}/{k}"] for k in tmpl}
           for i, tmpl in _items(templates or [])}
    return out if isinstance(templates, dict) else list(out.values())


def load_weights(model, path):
    """The ``(params, state)`` arrays of a checkpoint zip, as numpy arrays
    in ``model``'s tree structure: the hot-swap loader (JAX
    ``util/model_serializer.load_weights``). The zip's configuration is
    ignored, only the flattened array paths matter; counters, updater
    state and the model itself are untouched. Arrays that do not cover
    the model's structure raise ``WeightSwapError``; the serving engines
    check shapes and dtypes before they swap."""
    with _open_zip(path) as z:
        flat = _loadz(z, path, COEFF_NAME)
        st = _loadz(z, path, STATE_NAME)
    try:
        params = _unflatten_into(model.params, flat)
        state = _unflatten_into(model.state, st)
    except KeyError as e:
        raise WeightSwapError(
            f"checkpoint {os.fspath(path)} is not swap-compatible with "
            "the serving model", [str(e.args[0])]) from e
    return params, state


def _restore(path, device, load_updater, kind):
    """Build the network the zip describes on ``device`` and load its
    parameters, state, counters and (when the zip has it and
    ``load_updater``) updater state. Every array the configuration needs
    must be present with the shape the configuration gives it."""
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.base import flatten_params
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        DTYPES, MultiLayerNetwork, load_state)
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration)
    with _open_zip(path) as z:
        meta = _read_meta(z, path)
        if meta.get("kind") != kind:
            raise ValueError(f"Expected {kind}, zip holds {meta.get('kind')}")
        conf_json = _read_member(z, path, CONFIG_NAME).decode()
        flat = _loadz(z, path, COEFF_NAME)
        st = _loadz(z, path, STATE_NAME)
        upd = (_loadz(z, path, UPDATER_NAME)
               if load_updater and UPDATER_NAME in z.namelist() else None)
    gen = torch.Generator().manual_seed(0)
    if kind == "ComputationGraph":
        conf = ComputationGraphConfiguration.from_json(conf_json)
        model = ComputationGraph(conf, device=device)
        dtype = DTYPES[conf.global_conf.dtype]
        templates = {n: flatten_params(conf.nodes[n].layer.init(gen, dtype))
                     for n in conf.layer_nodes()}
    else:
        conf = MultiLayerConfiguration.from_json(conf_json)
        model = MultiLayerNetwork(conf, device=device)
        dtype = DTYPES[conf.global_conf.dtype]
        templates = [flatten_params(l.init(gen, dtype))
                     for l in model.layers]
    model.set_params(_fill(path, COEFF_NAME, flat, templates))
    load_state(model.state, _fill(path, STATE_NAME, st, model.state))
    if upd is not None:
        _copy_into(model.opt_state, _fill(path, UPDATER_NAME, upd,
                                          model.opt_state))
    _set_counters(model, meta)
    return model


def restore_multi_layer_network(path, load_updater=True, *, device=None):
    """The MultiLayerNetwork a checkpoint zip holds, on ``device``."""
    return _restore(path, device, load_updater, "MultiLayerNetwork")


def restore_computation_graph(path, load_updater=True, *, device=None):
    """The ComputationGraph a checkpoint zip holds, on ``device``."""
    return _restore(path, device, load_updater, "ComputationGraph")


def guess_model(path, load_updater=True, *, device=None):
    """The network a checkpoint zip holds, of the kind its ``meta.json``
    names, on ``device``."""
    kind = read_meta(path).get("kind")
    if kind not in ("MultiLayerNetwork", "ComputationGraph"):
        raise CorruptCheckpointError(path, member=META_NAME,
                                     detail=f"unknown kind {kind!r}")
    return _restore(path, device, load_updater, kind)


def restore_normalizer(path):
    """The normalizer a checkpoint zip holds (data/normalizers.py), or
    None."""
    from deeplearning4j_tpu_torch.data.normalizers import Normalizer
    with _open_zip(path) as z:
        if NORMALIZER_NAME not in z.namelist():
            return None
        return Normalizer.from_dict(
            json.loads(_read_member(z, path, NORMALIZER_NAME)))
