"""The port's mesh: a grid of slots over the process group.

Counterpart of deeplearning4j_tpu/exec/mesh.py: the axis names
``DATA_AXIS`` / ``MODEL_AXIS``, ``build_mesh``, ``default_mesh`` /
``set_default_mesh``, the ``DL4JTPU_MESH`` parser with the JAX package's
errors, ``host_device_env`` and the ``dl4jtpu_mesh_*`` gauges.

Where a JAX mesh is a grid of devices, the port's is a grid of SLOTS: a
slot is a (rank, device) pair, one data-parallel replica's place. PyTorch
runs one process per device, so the slots of one rank share that rank's
device, and a ``devices`` list may repeat it: eight slots on one card, or
on the CPU, are the counterpart of the JAX package's eight forced host
devices. A list that names two different cards raises (start one process
per device instead). ``devices`` are each rank's: the mesh repeats them
for every rank of the group (parallel/distributed.py), rank-major.

Axes: ``data`` (batch rows; parallel/wrapper.py) and ``model`` (Megatron
tensor parallelism by the executor's ``param_spec``; parallel/
tensor_parallel.py), and JAX's one-axis meshes for the other modes:
``("seq",)`` (ring attention, parallel/sequence_parallel.py), ``("pipe",)``
(GPipe, parallel/pipeline.py) and ``("expert",)`` (parallel/
expert_parallel.py). Every axis but ``data`` lies within one rank's slots:
its slots share that rank's card and their exchanges are tensor sums,
concatenations and copies in slot order. A mesh that puts such an axis
across ranks raises ``ValueError`` (ROADMAP item 7: model-parallel axes
across ranks wait).

``DL4JTPU_MESH`` shapes the default mesh without code changes:

    DL4JTPU_MESH=off            # one slot
    DL4JTPU_MESH=data=4,model=2 # explicit axis sizes (the product must
                                # divide the slots available)
    DL4JTPU_MESH=model=2        # data axis absorbs the rest

The slots available are the world size times ``DL4JTPU_SLOTS`` (slots a
rank, default 1) on the process's device; ``host_device_env`` composes
that count into a subprocess's environment.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLOTS_ENV = "DL4JTPU_SLOTS"

_default_mesh: Optional["Mesh"] = None


class Slot(NamedTuple):
    """One replica's place: the rank that runs it and that rank's
    device."""
    rank: int
    device: torch.device


class Mesh:
    """Slots on a named grid (``axis_names``, ``shape``), rank-major. Read
    like a JAX mesh: ``shape[axis]``, ``axis_names``, ``devices`` (an
    array of slots), ``size``."""

    def __init__(self, slots: List[Slot], axis_names=(DATA_AXIS, MODEL_AXIS),
                 shape=None):
        axis_names = tuple(axis_names)
        if shape is None:
            shape = (len(slots),) + (1,) * (len(axis_names) - 1)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names) or int(np.prod(shape)) != len(slots):
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(slots)} slots over axes {axis_names}")
        arr = np.empty(len(slots), dtype=object)
        arr[:] = [Slot(int(s[0]), torch.device(s[1])) for s in slots]
        self.devices = arr.reshape(shape)
        ranks = np.vectorize(lambda s: s.rank, otypes=[int])(self.devices)
        for k, (name, size) in enumerate(zip(axis_names, shape)):
            if name != DATA_AXIS and size > 1 and not (
                    ranks == ranks.take([0], axis=k)).all():
                raise ValueError(
                    f"the {name!r} axis of mesh {dict(zip(axis_names, shape))}"
                    " spans ranks; a model-parallel axis lies within one "
                    "rank's slots (ROADMAP item 7: model-parallel axes "
                    "across ranks)")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> List[Slot]:
        return list(self.devices.reshape(-1))

    def axis_slots(self, axis: str) -> List[Slot]:
        """The slots along ``axis`` (the other axes at index 0), in axis
        order."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, no {axis!r}")
        k = self.axis_names.index(axis)
        arr = np.moveaxis(self.devices, k, 0)
        return list(arr.reshape(arr.shape[0], -1)[:, 0])

    def local_slots(self, rank: int) -> List[Slot]:
        """The slots rank ``rank`` runs, in mesh order."""
        return [s for s in self.slots if s.rank == rank]

    @property
    def ranks(self) -> List[int]:
        return sorted({s.rank for s in self.slots})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks})"


def _as_device(d) -> torch.device:
    return torch.device(d) if not isinstance(d, torch.device) else d


def _local_devices(devices=None) -> List[torch.device]:
    """Each rank's slot devices: ``devices``, else ``DL4JTPU_SLOTS`` slots
    on the process's device. Two different cards raise."""
    if devices is None:
        from deeplearning4j_tpu_torch.parallel.distributed import \
            process_device
        devices = [process_device()] * max(1, int(os.environ.get(
            SLOTS_ENV, "1") or 1))
    devs = [_as_device(d) for d in devices]
    cards = {(d.index or 0) for d in devs if d.type == "cuda"}
    types = {d.type for d in devs}
    if len(cards) > 1 or len(types) > 1:
        raise ValueError(
            f"the slots of one process span {sorted(map(str, set(devs)))}; "
            "PyTorch runs one process per device: start one process per "
            "device (parallel.distributed.initialize) and give each its own")
    return devs


def build_mesh(devices=None, model_parallel: int = 1) -> Mesh:
    """A 2-D ``(data, model)`` mesh: every rank of the group times each of
    ``devices`` (this rank's slot devices; default: one slot, or
    ``DL4JTPU_SLOTS``, on the process's device). ``model_parallel`` must
    divide the slots, and each rank's slots hold whole rows of the model
    axis."""
    from deeplearning4j_tpu_torch.parallel.distributed import topology
    m = max(1, int(model_parallel))
    devs = _local_devices(devices)
    _, world = topology()
    slots = [Slot(r, d) for r in range(world) for d in devs]
    if len(slots) % m:
        raise ValueError(
            f"model_parallel={m} does not divide {len(slots)} devices")
    return Mesh(slots, (DATA_AXIS, MODEL_AXIS), (len(slots) // m, m))


def _publish_gauges(mesh: Mesh) -> None:
    from deeplearning4j_tpu_torch.monitor.metrics import get_registry
    reg = get_registry()
    reg.gauge(
        "dl4jtpu_mesh_devices",
        "Devices in the execution mesh (1 = single-device special case)."
    ).set(mesh.size)
    ax = reg.gauge(
        "dl4jtpu_mesh_axis_size",
        "Size of each named mesh axis (batch shards over 'data', "
        "Megatron TP over 'model').", ("axis",))
    for name in mesh.axis_names:
        ax.labels(axis=name).set(mesh.shape[name])


def _mesh_from_env(spec: str, devices=None) -> Mesh:
    """The mesh ``DL4JTPU_MESH=spec`` asks for, over the slots available
    (the world times ``devices``)."""
    spec = spec.strip().lower()
    full = build_mesh(devices)
    if spec in ("off", "1", "single", "none"):
        return Mesh(full.slots[:1], (DATA_AXIS, MODEL_AXIS), (1, 1))
    sizes = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        sizes[k.strip()] = int(v)
    n = full.size
    model = sizes.get(MODEL_AXIS, 1)
    data = sizes.get(DATA_AXIS, max(1, n // max(1, model)))
    want = data * model
    if want > n or n % want:
        raise ValueError(
            f"DL4JTPU_MESH={spec!r} needs {want} devices, have {n}")
    return Mesh(full.slots[:want], (DATA_AXIS, MODEL_AXIS), (data, model))


def default_mesh() -> Mesh:
    """The process-wide mesh: every slot available, pure DP, unless
    ``DL4JTPU_MESH`` or ``set_default_mesh`` says otherwise."""
    global _default_mesh
    if _default_mesh is None:
        env = os.environ.get("DL4JTPU_MESH", "").strip()
        _default_mesh = _mesh_from_env(env) if env else build_mesh()
        _publish_gauges(_default_mesh)
    return _default_mesh


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """Override (or with None, reset) the process default mesh. Drops
    the cached default executor, as the JAX package does, so that a
    container or engine bound after this sees the new mesh; one bound
    before keeps its executor."""
    global _default_mesh
    _default_mesh = mesh
    if mesh is not None:
        _publish_gauges(mesh)
    from deeplearning4j_tpu_torch.exec import executor as _ex
    _ex.set_executor(None)


def host_device_env(n: int = 8, base=None) -> dict:
    """Environment for a SUBPROCESS whose default mesh holds ``n`` slots a
    rank (``DL4JTPU_SLOTS``); the current process is untouched."""
    env = dict(os.environ if base is None else base)
    env[SLOTS_ENV] = str(int(n))
    return env
