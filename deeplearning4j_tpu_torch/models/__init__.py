from deeplearning4j_tpu_torch.models.multi_layer_network import (  # noqa: F401
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.models.computation_graph import (  # noqa: F401
    ComputationGraph)
