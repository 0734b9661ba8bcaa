from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    LAYER_REGISTRY, Layer, layer_from_dict, register_layer)
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    ActivationLayer, DenseLayer, DropoutLayer, ElementWiseMultiplicationLayer,
    EmbeddingLayer, EmbeddingSequenceLayer, FlattenLayer, LossLayer,
    OutputLayer, PReLULayer, ReshapeLayer)
from deeplearning4j_tpu_torch.nn.layers.conv import (  # noqa: F401
    BatchNormalization, Convolution1DLayer, ConvolutionLayer, Cropping2D,
    Deconvolution2D, DepthwiseConvolution2D, LocalResponseNormalization,
    SeparableConvolution2D, SpaceToBatchLayer, SpaceToDepthLayer,
    Subsampling1DLayer, SubsamplingLayer, Upsampling1D, Upsampling2D,
    ZeroPadding1DLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.layers.special import (  # noqa: F401
    GlobalPoolingLayer)
from deeplearning4j_tpu_torch.nn.layers.rnn import (  # noqa: F401
    LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM, LastTimeStep,
    RnnLossLayer, RnnOutputLayer, SimpleRnn, apply_lstm_pair,
    lstm_pair_fusable)
from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    LayerNormalization, MultiHeadAttention, PositionalEmbedding)
