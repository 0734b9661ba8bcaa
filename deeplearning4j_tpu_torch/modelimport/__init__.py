"""Keras HDF5 model import (counterpart of deeplearning4j_tpu/modelimport;
parity: the reference's deeplearning4j-modelimport/).

Imports Keras 1.x / 2.x models saved with ``model.save()`` (config and
weights in one HDF5), or a config JSON with a weights HDF5, into a
:class:`MultiLayerNetwork` (Sequential) or a :class:`ComputationGraph`
(functional Model) on the card unless ``device=`` says otherwise.
"""

from deeplearning4j_tpu_torch.modelimport.keras_import import (
    KerasModelImport,
    import_keras_sequential_model_and_weights,
    import_keras_model_and_weights,
    InvalidKerasConfigurationException,
    UnsupportedKerasConfigurationException,
)

__all__ = [
    "KerasModelImport",
    "import_keras_sequential_model_and_weights",
    "import_keras_model_and_weights",
    "InvalidKerasConfigurationException",
    "UnsupportedKerasConfigurationException",
]
