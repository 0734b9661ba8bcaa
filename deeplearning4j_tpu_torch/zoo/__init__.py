from deeplearning4j_tpu_torch.zoo.simple import (  # noqa: F401
    TextGenerationLSTM, TinyTransformer)
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel  # noqa: F401
