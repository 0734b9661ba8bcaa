"""Training observability: the stats storage and ``StatsListener``
(storage.py, stats_listener.py). The web UI server, its components, the
remote router and the convolutional listener are not ported yet."""

from deeplearning4j_tpu_torch.ui.stats_listener import \
    StatsListener  # noqa: F401
from deeplearning4j_tpu_torch.ui.storage import (  # noqa: F401
    FileStatsStorage, InMemoryStatsStorage, StatsReport, StatsStorage)

__all__ = ["StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
           "StatsReport", "StatsListener"]
