from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    LAYER_REGISTRY, Layer, layer_from_dict, register_layer)
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    DenseLayer, DropoutLayer, LossLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.layers.rnn import (  # noqa: F401
    LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM, LastTimeStep,
    RnnLossLayer, RnnOutputLayer, SimpleRnn, apply_lstm_pair,
    lstm_pair_fusable)
from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    LayerNormalization, MultiHeadAttention, PositionalEmbedding)
