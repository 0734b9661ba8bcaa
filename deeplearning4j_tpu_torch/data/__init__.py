"""In-memory datasets, their batch iterators, the standard datasets'
fetchers and the normalizers."""

from deeplearning4j_tpu_torch.data.dataset import (  # noqa: F401
    DataSet, MultiDataSet)
from deeplearning4j_tpu_torch.data.iterators import (  # noqa: F401
    DataSetIterator, ListDataSetIterator, resolve_pre_processor)
