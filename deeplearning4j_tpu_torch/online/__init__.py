"""Online learning loop: stream-fed fine-tuning with shadow-evaluated
hot-swap deployments and instant rollback.

Counterpart of deeplearning4j_tpu/online/, the same loop:

    Kafka topic -> NDArrayPubSubRoute -> OnlineTrainer (guarded fine-tune,
    atomic checkpoints) -> PromotionGate (held-out eval + mirrored live
    traffic vs the incumbent) -> Deployer (pin -> swap every serving
    target in place, capturing nothing -> unpin superseded) ->
    post-promotion regression watch -> automatic rollback to the pinned
    incumbent.

Module map:

- ``stream``  -- DriftingProblem: the deterministic synthetic task whose
  label boundary drifts by phase (the JAX package's numpy draws).
- ``trainer`` -- BatchGuard (NaN / loss-spike quarantine) + OnlineTrainer
  (bounded rounds off a streaming iterator, each batch the container's
  captured train step, crash-safe checkpoints, stall-degraded health).
- ``gate``    -- TrafficMirror (bounded tap of live /predict traffic) +
  PromotionGate (candidate vs incumbent on the eval set, shadow
  disagreement on mirrored traffic).
- ``deploy``  -- swap targets (in-process engine / server, HTTP admin
  endpoint) + Deployer (pin choreography, atomic intent file, crash
  recovery mid-promotion, monotonic model versions, rollback).
- ``service`` -- OnlineLearningService: one ``step()`` = train round ->
  gate -> promote -> regression watch -> rollback; ``health_info`` plugs
  into InferenceServer's ``health_hook``.
"""

from deeplearning4j_tpu_torch.online.stream import DriftingProblem
from deeplearning4j_tpu_torch.online.trainer import BatchGuard, OnlineTrainer
from deeplearning4j_tpu_torch.online.gate import (GateDecision, PromotionGate,
                                            TrafficMirror)
from deeplearning4j_tpu_torch.online.deploy import (Deployer, EngineTarget,
                                              HttpTarget, ServerTarget)
from deeplearning4j_tpu_torch.online.service import OnlineLearningService

__all__ = [
    "DriftingProblem",
    "BatchGuard", "OnlineTrainer",
    "GateDecision", "PromotionGate", "TrafficMirror",
    "Deployer", "EngineTarget", "HttpTarget", "ServerTarget",
    "OnlineLearningService",
]
