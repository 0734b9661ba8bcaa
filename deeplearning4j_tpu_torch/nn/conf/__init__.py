from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: F401
    GlobalConf, MultiLayerConfiguration, NeuralNetConfiguration,
    updater_dict)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
