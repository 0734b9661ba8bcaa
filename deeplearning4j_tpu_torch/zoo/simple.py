"""Sequential zoo models and the char-level LMs: LeNet, SimpleCNN,
AlexNet, VGG16, VGG19, Darknet19, TextGenerationLSTM and TinyTransformer.

Counterpart of deeplearning4j_tpu/zoo/simple.py, layer for layer (parity
surface: the reference's zoo/model/*.java; NHWC), and the JAX package's
own TinyTransformer.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM, BatchNormalization, ConvolutionLayer, DenseLayer, DropoutLayer,
    GlobalPoolingLayer, LayerNormalization, LocalResponseNormalization,
    MultiHeadAttention, OutputLayer, PositionalEmbedding, RnnOutputLayer,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class LeNet(ZooModel):
    name = "lenet"
    default_input_shape = (28, 28, 1)

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater(Adam(1e-3)))
                .weight_init("xavier")
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=5, stride=1,
                                        activation="relu"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                        stride=2))
                .layer(ConvolutionLayer(n_out=50, kernel_size=5, stride=1,
                                        activation="relu"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                        stride=2))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    name = "simplecnn"
    default_input_shape = (48, 48, 3)

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater(Adam(1e-3)))
             .activation("relu")
             .weight_init("relu")
             .list())
        for n_out, pool in [(16, False), (16, True), (32, False), (32, True),
                            (64, False), (64, True)]:
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=3, padding=1))
            b.layer(BatchNormalization())
            if pool:
                b.layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                         stride=2))
        b.layer(DropoutLayer(dropout=0.5))
        b.layer(GlobalPoolingLayer(pooling_type="avg"))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent"))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


class AlexNet(ZooModel):
    name = "alexnet"
    default_input_shape = (224, 224, 3)

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater(Nesterovs(1e-2, momentum=0.9)))
                .weight_init("distribution").dist("normal", 0.0, 0.01)
                .activation("relu")
                .l2(5e-4)
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=11, stride=4,
                                        padding=2))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=3,
                                        stride=2))
                .layer(ConvolutionLayer(n_out=256, kernel_size=5, padding=2,
                                        bias_init=1.0))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=3,
                                        stride=2))
                .layer(ConvolutionLayer(n_out=384, kernel_size=3, padding=1))
                .layer(ConvolutionLayer(n_out=384, kernel_size=3, padding=1,
                                        bias_init=1.0))
                .layer(ConvolutionLayer(n_out=256, kernel_size=3, padding=1,
                                        bias_init=1.0))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=3,
                                        stride=2))
                .layer(DenseLayer(n_out=4096, bias_init=1.0, dropout=0.5))
                .layer(DenseLayer(n_out=4096, bias_init=1.0, dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


def _vgg_blocks(b, cfg):
    for item in cfg:
        if item == "M":
            b.layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                     stride=2))
        else:
            b.layer(ConvolutionLayer(n_out=item, kernel_size=3, padding=1,
                                     activation="relu"))
    return b


class VGG16(ZooModel):
    name = "vgg16"
    default_input_shape = (224, 224, 3)
    _cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater(Nesterovs(1e-2, momentum=0.9)))
             .weight_init("relu")
             .list())
        _vgg_blocks(b, self._cfg)
        b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
        b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent"))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


class VGG19(VGG16):
    name = "vgg19"
    _cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class Darknet19(ZooModel):
    name = "darknet19"
    default_input_shape = (224, 224, 3)

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater(Adam(1e-3)))
             .weight_init("relu")
             .list())

        def conv_bn(n_out, k):
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=k,
                                     padding=k // 2, has_bias=False))
            b.layer(BatchNormalization(activation="leakyrelu"))

        conv_bn(32, 3)
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=2, stride=2))
        conv_bn(64, 3)
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=2, stride=2))
        for ns in [(128, 64, 128), (256, 128, 256)]:
            conv_bn(ns[0], 3)
            conv_bn(ns[1], 1)
            conv_bn(ns[2], 3)
            b.layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                     stride=2))
        for ns in [(512, 256, 512, 256, 512), (1024, 512, 1024, 512, 1024)]:
            for i, n in enumerate(ns):
                conv_bn(n, 3 if i % 2 == 0 else 1)
            if ns[0] == 512:
                b.layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                         stride=2))
        b.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=1))
        b.layer(GlobalPoolingLayer(pooling_type="avg"))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent", has_bias=True,
                            n_in=self.num_classes))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


class TextGenerationLSTM(ZooModel):
    """Two LSTM(256) layers and a softmax RnnOutputLayer over the vocab."""
    name = "textgenlstm"
    default_input_shape = (77,)  # vocab size

    def __init__(self, total_unique_characters: int = 77, seed: int = 123,
                 **kwargs):
        total_unique_characters = kwargs.pop("num_classes",
                                             total_unique_characters)
        kwargs.pop("input_shape", None)
        super().__init__(num_classes=total_unique_characters, seed=seed,
                         input_shape=(total_unique_characters,), **kwargs)

    def conf(self):
        vocab = self.input_shape[0]
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater(Adam(1e-3)))
                .weight_init("xavier")
                .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0)
                .list()
                .layer(LSTM(n_out=256, activation="tanh"))
                .layer(LSTM(n_out=256, activation="tanh"))
                .layer(RnnOutputLayer(n_out=vocab, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(InputType.recurrent(vocab))
                .build())


class TinyTransformer(ZooModel):
    """Decoder-only char-level transformer: a one-hot token embedding, a
    learned positional embedding, ``n_layers`` pre-LN blocks of causal
    MultiHeadAttention and a GELU FFN of width 4 x d_model with residual
    adds, a final LayerNormalization and a softmax output over the vocab.
    A ComputationGraph."""
    name = "tinytransformer"
    default_input_shape = (64,)    # vocab size

    def __init__(self, vocab_size: int = 64, n_layers: int = 2,
                 d_model: int = 128, n_heads: int = 4, max_len: int = 512,
                 seed: int = 123, **kwargs):
        vocab_size = kwargs.pop("num_classes", vocab_size)
        kwargs.pop("input_shape", None)
        super().__init__(num_classes=vocab_size, seed=seed,
                         input_shape=(vocab_size,), **kwargs)
        self.n_layers = n_layers
        self.d_model = d_model
        self.n_heads = n_heads
        self.max_len = max_len

    def conf(self):
        vocab = self.input_shape[0]
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater(Adam(3e-4)))
             .weight_init("xavier")
             .graph_builder()
             .add_inputs("tokens")
             .set_input_types(InputType.recurrent(vocab)))
        g.add_layer("embed", DenseLayer(n_out=self.d_model,
                                        activation="identity"), "tokens")
        g.add_layer("pos", PositionalEmbedding(max_len=self.max_len), "embed")
        prev = "pos"
        for i in range(self.n_layers):
            g.add_layer(f"b{i}_ln1", LayerNormalization(), prev)
            g.add_layer(f"b{i}_attn",
                        MultiHeadAttention(n_out=self.d_model,
                                           n_heads=self.n_heads, causal=True),
                        f"b{i}_ln1")
            g.add_vertex(f"b{i}_res1", ElementWiseVertex(op="add"),
                         f"b{i}_attn", prev)
            g.add_layer(f"b{i}_ln2", LayerNormalization(), f"b{i}_res1")
            g.add_layer(f"b{i}_ff1", DenseLayer(n_out=4 * self.d_model,
                                                activation="gelu"),
                        f"b{i}_ln2")
            g.add_layer(f"b{i}_ff2", DenseLayer(n_out=self.d_model,
                                                activation="identity"),
                        f"b{i}_ff1")
            g.add_vertex(f"b{i}_res2", ElementWiseVertex(op="add"),
                         f"b{i}_ff2", f"b{i}_res1")
            prev = f"b{i}_res2"
        g.add_layer("ln_f", LayerNormalization(), prev)
        g.add_layer("out", RnnOutputLayer(n_out=vocab, activation="softmax",
                                          loss="mcxent"), "ln_f")
        return g.set_outputs("out").build()
