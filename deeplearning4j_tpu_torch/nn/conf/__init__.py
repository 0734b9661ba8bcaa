from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: F401
    GlobalConf, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (  # noqa: F401
    ComputationGraphConfiguration, ElementWiseVertex, GraphBuilder)
