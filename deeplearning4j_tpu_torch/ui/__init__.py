"""Training observability: the stats storage and its remote router
(storage.py), ``StatsListener``, the async ``WebReporter`` (remote.py),
the web ``UIServer`` (server.py), the component library (components.py)
and ``ConvolutionalIterationListener``. Counterpart of
deeplearning4j_tpu/ui/."""

from deeplearning4j_tpu_torch.ui.storage import (  # noqa: F401
    FileStatsStorage, InMemoryStatsStorage, RemoteUIStatsStorageRouter,
    StatsReport, StatsStorage)
from deeplearning4j_tpu_torch.ui.stats_listener import \
    StatsListener  # noqa: F401
from deeplearning4j_tpu_torch.ui.conv_listener import \
    ConvolutionalIterationListener  # noqa: F401
from deeplearning4j_tpu_torch.ui.server import UIServer  # noqa: F401
from deeplearning4j_tpu_torch.ui.remote import WebReporter  # noqa: F401
from deeplearning4j_tpu_torch.ui import components  # noqa: F401

__all__ = [
    "StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
    "RemoteUIStatsStorageRouter", "WebReporter", "StatsReport",
    "StatsListener", "ConvolutionalIterationListener", "UIServer",
    "components",
]
