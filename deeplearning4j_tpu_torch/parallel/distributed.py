"""Multi-process initialization, the process topology and the rank's
share of a global batch.

Counterpart of deeplearning4j_tpu/parallel/distributed.py. Where the JAX
package forms its multi-host runtime with ``jax.distributed.initialize``,
here ``initialize`` forms a ``torch.distributed`` process group: one
process per device (PyTorch's rule), NCCL when the process's device is a
card and gloo on the CPU. Nothing falls back: on a card the backend is
NCCL unless the caller names another (``backend="gloo"``, as two ranks
sharing one card must, since NCCL refuses two ranks on one device).

``initialize`` reads the JAX package's environment when its arguments are
omitted: ``COORDINATOR_ADDRESS`` (``host:port``), ``NUM_PROCESSES`` /
``PROCESS_ID``, and the elastic cluster's ``DL4JTPU_RANK`` /
``DL4JTPU_WORLD``. With a rank and a world but no coordinator it only
records the topology (the JAX package's loopback fallback), so
``local_batch_slice`` still shards. It is idempotent.

The group gets a companion gloo group for host-side collectives
(``host_group``): the data-parallel step exchanges its small host counts
there without a device synchronization (parallel/wrapper.py). Under a
gloo default group the two are the same group.

``StaleGenerationError``, ``set_topology`` / ``topology``,
``set_generation`` / ``generation`` / ``fence`` and ``local_batch_slice``
are the JAX package's, over ``torch.distributed``'s rank and world.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize", "pod_mesh", "local_batch_slice",
           "set_topology", "topology", "set_generation", "generation",
           "fence", "StaleGenerationError"]


class StaleGenerationError(RuntimeError):
    """A contribution stamped with a membership generation that has since
    been superseded (a worker evicted, a replacement joined)."""


# the elastic override of (rank, world), and the committed generation
_rank: Optional[int] = None
_world: Optional[int] = None
_generation: int = 0
# the device the group was formed for, and the host-side gloo group
_device: Optional[torch.device] = None
_host_group = None


def set_topology(rank: Optional[int], world: Optional[int]) -> None:
    """Pin this process's (rank, world) for ``local_batch_slice`` when the
    cluster membership is managed by a coordinator rather than by
    ``torch.distributed``. ``(None, None)`` reverts to the group's."""
    global _rank, _world
    _rank, _world = rank, world


def topology() -> Tuple[int, int]:
    """Effective (rank, world): the override when set, else the process
    group's (a single process: (0, 1))."""
    if _rank is not None and _world is not None:
        return _rank, _world
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def set_generation(gen: int) -> None:
    """Record the committed membership generation this process trains in."""
    global _generation
    _generation = int(gen)


def generation() -> int:
    return _generation


def fence(gen: int) -> None:
    """Raise unless ``gen`` is the current generation: the guard every
    gradient contribution passes before leaving this process."""
    if int(gen) != _generation:
        raise StaleGenerationError(
            f"contribution carries generation {gen}, membership is at "
            f"{_generation}")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               generation: Optional[int] = None, *,
               backend: Optional[str] = None, device=None):
    """Form the process group (module docstring): ``coordinator_address``
    ``host:port`` (default ``COORDINATOR_ADDRESS``), ``num_processes`` and
    ``process_id`` (default ``NUM_PROCESSES`` / ``PROCESS_ID``, then
    ``DL4JTPU_WORLD`` / ``DL4JTPU_RANK``). ``backend``: None picks NCCL
    for a card and gloo for the CPU; ``device``: this process's device
    (default: the card; ``"cpu"`` for the CPU). ``generation`` stamps the
    committed membership generation (see ``fence``)."""
    global _device, _host_group
    if generation is not None:
        set_generation(generation)
    if process_id is None:
        process_id = _env_int("PROCESS_ID")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("DL4JTPU_RANK")
    if num_processes is None:
        num_processes = _env_int("DL4JTPU_WORLD")
    if dist.is_initialized():
        return
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not address:
        if process_id is not None and num_processes is not None:
            set_topology(process_id, num_processes)
        return
    if process_id is None or num_processes is None:
        raise ValueError(
            "initialize needs the process count and this process's id "
            "(arguments, NUM_PROCESSES / PROCESS_ID or DL4JTPU_WORLD / "
            "DL4JTPU_RANK) besides the coordinator address")
    from deeplearning4j_tpu_torch.ops import resolve_device
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    init = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _device = dev
    _host_group = (dist.new_group(backend="gloo") if backend != "gloo"
                   else dist.group.WORLD)


def host_group():
    """The gloo group host tensors are reduced over (None before
    ``initialize`` formed a group)."""
    return _host_group if dist.is_initialized() else None


def process_device() -> torch.device:
    """The device ``initialize`` formed the group for, else the card."""
    from deeplearning4j_tpu_torch.ops import resolve_device
    return _device if _device is not None else resolve_device()


def shutdown() -> None:
    """Destroy the process group (and its host group)."""
    global _device, _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _device, _host_group = None, None


def pod_mesh(axes=("data",), shape=None):
    """The mesh over every rank of the group, one slot a rank on its
    device (exec/mesh.py). ``shape``: optional sizes matching ``axes``,
    e.g. ``axes=('data', 'model')``, ``shape=(4, 1)``."""
    from deeplearning4j_tpu_torch.exec.mesh import Mesh, Slot
    _, world = topology()
    dev = process_device()
    slots = [Slot(r, dev) for r in range(world)]
    if shape is None:
        shape = (len(slots),) + (1,) * (len(axes) - 1)
    return Mesh(slots, tuple(axes), tuple(shape))


def local_batch_slice(global_batch: int, rank: Optional[int] = None,
                      world: Optional[int] = None) -> slice:
    """This process's slice of a globally sharded batch. ``rank`` /
    ``world`` override the ambient topology. Ragged worlds: the first
    ``global_batch % world`` ranks take one extra row, so every row is
    owned exactly once."""
    if rank is None or world is None:
        rank, world = topology()
    base, rem = divmod(int(global_batch), int(world))
    start = rank * base + min(rank, rem)
    return slice(start, start + base + (1 if rank < rem else 0))
