"""In-memory datasets, their batch iterators and the iterator wrappers,
the standard datasets' fetchers and the normalizers."""

from deeplearning4j_tpu_torch.data.dataset import (  # noqa: F401
    DataSet, MultiDataSet)
from deeplearning4j_tpu_torch.data.iterators import (  # noqa: F401
    AsyncDataSetIterator, AsyncMultiDataSetIterator, DataSetIterator,
    ExistingDataSetIterator, InequalityHandling, JointParallelDataSetIterator,
    ListDataSetIterator, MultipleEpochsIterator, resolve_pre_processor)
from deeplearning4j_tpu_torch.data.normalizers import (  # noqa: F401
    ImagePreProcessingScaler, NormalizerMinMaxScaler, NormalizerStandardize)
from deeplearning4j_tpu_torch.data.prefetcher import (  # noqa: F401
    DevicePrefetcher)
