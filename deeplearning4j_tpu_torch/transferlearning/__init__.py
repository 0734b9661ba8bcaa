"""Transfer learning (see transfer.py)."""

from deeplearning4j_tpu_torch.transferlearning.transfer import (  # noqa: F401
    FineTuneConfiguration, TransferLearning, TransferLearningHelper)

__all__ = ["TransferLearning", "FineTuneConfiguration", "TransferLearningHelper"]
