from deeplearning4j_tpu_torch.zoo.resnet import (  # noqa: F401
    ResNet50, ResNet50Cifar)
from deeplearning4j_tpu_torch.zoo.simple import (  # noqa: F401
    VGG16, VGG19, AlexNet, Darknet19, LeNet, SimpleCNN, TextGenerationLSTM,
    TinyTransformer)
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel  # noqa: F401
