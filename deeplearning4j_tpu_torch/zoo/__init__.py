from deeplearning4j_tpu_torch.zoo.simple import TextGenerationLSTM  # noqa: F401
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel  # noqa: F401
