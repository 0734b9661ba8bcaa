"""The Inception family as ComputationGraphs: GoogLeNet,
InceptionResNetV1 and FaceNetNN4Small2.

Counterpart of deeplearning4j_tpu/zoo/inception.py, node for node (parity
surface: the reference's zoo/model/GoogLeNet.java, InceptionResNetV1.java
and FaceNetNN4Small2.java; NHWC). The two face-embedding nets end in a
128-wide bottleneck, an L2-normalized ``embeddings`` vertex and a
center-loss softmax head.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (ElementWiseVertex,
                                                         L2NormalizeVertex,
                                                         MergeVertex,
                                                         ScaleVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, CenterLossOutputLayer,
    ConvolutionLayer, DenseLayer, DropoutLayer, GlobalPoolingLayer,
    LocalResponseNormalization, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class GoogLeNet(ZooModel):
    name = "googlenet"
    default_input_shape = (224, 224, 3)

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater(Nesterovs(1e-2, momentum=0.9)))
             .weight_init("relu")
             .activation("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))

        def inception(name, inp, c1, c3r, c3, c5r, c5, pp):
            g.add_layer(f"{name}_1x1", ConvolutionLayer(n_out=c1, kernel_size=1), inp)
            g.add_layer(f"{name}_3x3r", ConvolutionLayer(n_out=c3r, kernel_size=1), inp)
            g.add_layer(f"{name}_3x3", ConvolutionLayer(n_out=c3, kernel_size=3,
                                                        padding=1), f"{name}_3x3r")
            g.add_layer(f"{name}_5x5r", ConvolutionLayer(n_out=c5r, kernel_size=1), inp)
            g.add_layer(f"{name}_5x5", ConvolutionLayer(n_out=c5, kernel_size=5,
                                                        padding=2), f"{name}_5x5r")
            g.add_layer(f"{name}_pool",
                        SubsamplingLayer(pooling_type="max", kernel_size=3,
                                         stride=1, padding=1), inp)
            g.add_layer(f"{name}_poolproj", ConvolutionLayer(n_out=pp,
                                                             kernel_size=1),
                        f"{name}_pool")
            g.add_vertex(f"{name}", MergeVertex(), f"{name}_1x1", f"{name}_3x3",
                         f"{name}_5x5", f"{name}_poolproj")
            return name

        g.add_layer("stem_conv", ConvolutionLayer(n_out=64, kernel_size=7,
                                                  stride=2, padding=3), "input")
        g.add_layer("stem_pool", SubsamplingLayer(pooling_type="max",
                                                  kernel_size=3, stride=2,
                                                  padding=1), "stem_conv")
        g.add_layer("stem_lrn", LocalResponseNormalization(), "stem_pool")
        g.add_layer("stem_conv2", ConvolutionLayer(n_out=64, kernel_size=1),
                    "stem_lrn")
        g.add_layer("stem_conv3", ConvolutionLayer(n_out=192, kernel_size=3,
                                                   padding=1), "stem_conv2")
        g.add_layer("stem_lrn2", LocalResponseNormalization(), "stem_conv3")
        g.add_layer("stem_pool2", SubsamplingLayer(pooling_type="max",
                                                   kernel_size=3, stride=2,
                                                   padding=1), "stem_lrn2")
        x = inception("3a", "stem_pool2", 64, 96, 128, 16, 32, 32)
        x = inception("3b", x, 128, 128, 192, 32, 96, 64)
        g.add_layer("pool3", SubsamplingLayer(pooling_type="max", kernel_size=3,
                                              stride=2, padding=1), x)
        x = inception("4a", "pool3", 192, 96, 208, 16, 48, 64)
        x = inception("4b", x, 160, 112, 224, 24, 64, 64)
        x = inception("4c", x, 128, 128, 256, 24, 64, 64)
        x = inception("4d", x, 112, 144, 288, 32, 64, 64)
        x = inception("4e", x, 256, 160, 320, 32, 128, 128)
        g.add_layer("pool4", SubsamplingLayer(pooling_type="max", kernel_size=3,
                                              stride=2, padding=1), x)
        x = inception("5a", "pool4", 256, 160, 320, 32, 128, 128)
        x = inception("5b", x, 384, 192, 384, 48, 128, 128)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("dropout", DropoutLayer(dropout=0.4), "avgpool")
        g.add_layer("fc", OutputLayer(n_out=self.num_classes,
                                      activation="softmax", loss="mcxent",
                                      n_in=1024), "dropout")
        g.set_outputs("fc")
        return g.build()


class InceptionResNetV1(ZooModel):
    name = "inception_resnet_v1"
    default_input_shape = (160, 160, 3)

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater(Adam(1e-3)))
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, stride=1, pad=0, act="relu"):
            g.add_layer(f"{name}_c", ConvolutionLayer(n_out=n_out, kernel_size=k,
                                                      stride=stride, padding=pad,
                                                      has_bias=False), inp)
            g.add_layer(f"{name}_bn", BatchNormalization(activation=act),
                        f"{name}_c")
            return f"{name}_bn"

        def block35(name, inp, scale=0.17):
            """Inception-ResNet-A (35x35)."""
            b0 = conv_bn(f"{name}_b0", inp, 32, 1)
            b1 = conv_bn(f"{name}_b1a", inp, 32, 1)
            b1 = conv_bn(f"{name}_b1b", b1, 32, 3, pad=1)
            b2 = conv_bn(f"{name}_b2a", inp, 32, 1)
            b2 = conv_bn(f"{name}_b2b", b2, 32, 3, pad=1)
            b2 = conv_bn(f"{name}_b2c", b2, 32, 3, pad=1)
            g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1, b2)
            up = conv_bn(f"{name}_up", f"{name}_cat", 256, 1, act="identity")
            g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), up)
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                         f"{name}_scale")
            g.add_layer(f"{name}", ActivationLayer(activation="relu"),
                        f"{name}_add")
            return name

        def block17(name, inp, scale=0.10):
            """Inception-ResNet-B (17x17)."""
            b0 = conv_bn(f"{name}_b0", inp, 128, 1)
            b1 = conv_bn(f"{name}_b1a", inp, 128, 1)
            b1 = conv_bn(f"{name}_b1b", b1, 128, (1, 7), pad=(0, 3))
            b1 = conv_bn(f"{name}_b1c", b1, 128, (7, 1), pad=(3, 0))
            g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1)
            up = conv_bn(f"{name}_up", f"{name}_cat", 896, 1, act="identity")
            g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), up)
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                         f"{name}_scale")
            g.add_layer(f"{name}", ActivationLayer(activation="relu"),
                        f"{name}_add")
            return name

        def block8(name, inp, scale=0.20, act=True):
            """Inception-ResNet-C (8x8)."""
            b0 = conv_bn(f"{name}_b0", inp, 192, 1)
            b1 = conv_bn(f"{name}_b1a", inp, 192, 1)
            b1 = conv_bn(f"{name}_b1b", b1, 192, (1, 3), pad=(0, 1))
            b1 = conv_bn(f"{name}_b1c", b1, 192, (3, 1), pad=(1, 0))
            g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1)
            up = conv_bn(f"{name}_up", f"{name}_cat", 1792, 1, act="identity")
            g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), up)
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                         f"{name}_scale")
            if act:
                g.add_layer(f"{name}", ActivationLayer(activation="relu"),
                            f"{name}_add")
                return name
            return f"{name}_add"

        # stem
        x = conv_bn("stem1", "input", 32, 3, stride=2)
        x = conv_bn("stem2", x, 32, 3)
        x = conv_bn("stem3", x, 64, 3, pad=1)
        g.add_layer("stem_pool", SubsamplingLayer(pooling_type="max",
                                                  kernel_size=3, stride=2), x)
        x = conv_bn("stem4", "stem_pool", 80, 1)
        x = conv_bn("stem5", x, 192, 3)
        x = conv_bn("stem6", x, 256, 3, stride=2)
        for i in range(5):
            x = block35(f"a{i}", x)
        # reduction A
        ra0 = conv_bn("redA_b0", x, 384, 3, stride=2)
        ra1 = conv_bn("redA_b1a", x, 192, 1)
        ra1 = conv_bn("redA_b1b", ra1, 192, 3, pad=1)
        ra1 = conv_bn("redA_b1c", ra1, 256, 3, stride=2)
        g.add_layer("redA_pool", SubsamplingLayer(pooling_type="max",
                                                  kernel_size=3, stride=2), x)
        g.add_vertex("redA", MergeVertex(), ra0, ra1, "redA_pool")
        x = "redA"
        for i in range(10):
            x = block17(f"b{i}", x)
        # reduction B
        rb0 = conv_bn("redB_b0a", x, 256, 1)
        rb0 = conv_bn("redB_b0b", rb0, 384, 3, stride=2)
        rb1 = conv_bn("redB_b1a", x, 256, 1)
        rb1 = conv_bn("redB_b1b", rb1, 256, 3, stride=2)
        rb2 = conv_bn("redB_b2a", x, 256, 1)
        rb2 = conv_bn("redB_b2b", rb2, 256, 3, pad=1)
        rb2 = conv_bn("redB_b2c", rb2, 256, 3, stride=2)
        g.add_layer("redB_pool", SubsamplingLayer(pooling_type="max",
                                                  kernel_size=3, stride=2), x)
        g.add_vertex("redB", MergeVertex(), rb0, rb1, rb2, "redB_pool")
        x = "redB"
        for i in range(5):
            x = block8(f"c{i}", x)
        x = block8("c5", x, scale=1.0, act=False)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("dropout", DropoutLayer(dropout=0.2), "avgpool")
        g.add_layer("bottleneck", DenseLayer(n_out=128, activation="identity",
                                             n_in=1792), "dropout")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", CenterLossOutputLayer(
            n_out=self.num_classes, n_in=128, activation="softmax",
            loss="mcxent"), "embeddings")
        g.set_outputs("out")
        return g.build()


class FaceNetNN4Small2(ZooModel):
    """NN4-small2 face embedding net (parity: zoo/model/FaceNetNN4Small2.java).
    Output: 128-d L2-normalized embedding + center-loss softmax head."""
    name = "facenet_nn4_small2"
    default_input_shape = (96, 96, 3)

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater(Adam(1e-3)))
             .weight_init("relu")
             .activation("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, stride=1, pad=0):
            g.add_layer(f"{name}_c", ConvolutionLayer(n_out=n_out, kernel_size=k,
                                                      stride=stride, padding=pad,
                                                      has_bias=False), inp)
            g.add_layer(f"{name}_bn", BatchNormalization(activation="relu"),
                        f"{name}_c")
            return f"{name}_bn"

        def inception(name, inp, c1, c3r, c3, c5r, c5, pp, pool_type="max"):
            branches = []
            if c1:
                branches.append(conv_bn(f"{name}_1x1", inp, c1, 1))
            b3 = conv_bn(f"{name}_3x3r", inp, c3r, 1)
            branches.append(conv_bn(f"{name}_3x3", b3, c3, 3, pad=1))
            if c5:
                b5 = conv_bn(f"{name}_5x5r", inp, c5r, 1)
                branches.append(conv_bn(f"{name}_5x5", b5, c5, 5, pad=2))
            g.add_layer(f"{name}_pool",
                        SubsamplingLayer(pooling_type=pool_type, kernel_size=3,
                                         stride=1, padding=1), inp)
            if pp:
                branches.append(conv_bn(f"{name}_pp", f"{name}_pool", pp, 1))
            else:
                branches.append(f"{name}_pool")
            g.add_vertex(name, MergeVertex(), *branches)
            return name

        x = conv_bn("stem1", "input", 64, 7, stride=2, pad=3)
        g.add_layer("pool1", SubsamplingLayer(pooling_type="max", kernel_size=3,
                                              stride=2, padding=1), x)
        x = conv_bn("stem2", "pool1", 64, 1)
        x = conv_bn("stem3", x, 192, 3, pad=1)
        g.add_layer("pool2", SubsamplingLayer(pooling_type="max", kernel_size=3,
                                              stride=2, padding=1), x)
        x = inception("3a", "pool2", 64, 96, 128, 16, 32, 32)
        x = inception("3b", x, 64, 96, 128, 32, 64, 64, pool_type="pnorm")
        x = inception("3c", x, 0, 128, 256, 32, 64, 0)
        g.add_layer("pool3", SubsamplingLayer(pooling_type="max", kernel_size=3,
                                              stride=2, padding=1), x)
        x = inception("4a", "pool3", 256, 96, 192, 32, 64, 128,
                      pool_type="pnorm")
        x = inception("4e", x, 0, 160, 256, 64, 128, 0)
        g.add_layer("pool4", SubsamplingLayer(pooling_type="max", kernel_size=3,
                                              stride=2, padding=1), x)
        x = inception("5a", "pool4", 256, 96, 384, 0, 0, 96, pool_type="pnorm")
        x = inception("5b", x, 256, 96, 384, 0, 0, 96)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("bottleneck", DenseLayer(n_out=128, activation="identity"),
                    "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("lossLayer", CenterLossOutputLayer(
            n_out=self.num_classes, n_in=128, activation="softmax",
            loss="mcxent"), "embeddings")
        g.set_outputs("lossLayer")
        return g.build()
