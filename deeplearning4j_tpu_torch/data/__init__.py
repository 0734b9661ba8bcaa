"""In-memory datasets and their batch iterators."""

from deeplearning4j_tpu_torch.data.dataset import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.data.iterators import (  # noqa: F401
    DataSetIterator, ListDataSetIterator)
