"""ResNet50 as a ComputationGraph.

Counterpart of deeplearning4j_tpu/zoo/resnet.py, node for node (parity
surface: the reference's zoo/model/ResNet50.java): bottleneck residual
blocks with identity or projection shortcuts joined by an
ElementWiseVertex add, BatchNormalization after every convolution (the
convolutions feeding one carry no bias), NHWC.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class ResNet50(ZooModel):
    name = "resnet50"
    default_input_shape = (224, 224, 3)

    def conf(self):
        h, w, c = self.input_shape
        # width_mult scales every filter count, rounded to a multiple of 8
        # (at least 8); 1.0 is the reference's architecture
        wm = float(self.kwargs.get("width_mult", 1.0))

        def _w(f):
            return max(8, int(round(f * wm / 8)) * 8) if wm != 1.0 else f
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater(Nesterovs(1e-1, momentum=0.9)))
             .weight_init("relu")
             .l2(1e-4)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, stride=1, pad=0, act=True):
            g.add_layer(f"{name}_conv",
                        ConvolutionLayer(n_out=n_out, kernel_size=k,
                                         stride=stride, padding=pad,
                                         has_bias=False), inp)
            g.add_layer(f"{name}_bn",
                        BatchNormalization(
                            activation="relu" if act else "identity"),
                        f"{name}_conv")
            return f"{name}_bn"

        def bottleneck(name, inp, filters, stride=1, project=False):
            f1, f2, f3 = filters
            x = conv_bn(f"{name}_a", inp, f1, 1, stride=stride)
            x = conv_bn(f"{name}_b", x, f2, 3, pad=1)
            x = conv_bn(f"{name}_c", x, f3, 1, act=False)
            sc = (conv_bn(f"{name}_sc", inp, f3, 1, stride=stride, act=False)
                  if project else inp)
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
            g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                        f"{name}_add")
            return f"{name}_out"

        x = conv_bn("stem", "input", _w(64), 7, stride=2, pad=3)
        g.add_layer("stem_pool",
                    SubsamplingLayer(pooling_type="max", kernel_size=3,
                                     stride=2, padding=1), x)
        x = "stem_pool"
        stages = [
            ("res2", (_w(64), _w(64), _w(256)), 3, 1),
            ("res3", (_w(128), _w(128), _w(512)), 4, 2),
            ("res4", (_w(256), _w(256), _w(1024)), 6, 2),
            ("res5", (_w(512), _w(512), _w(2048)), 3, 2),
        ]
        for sname, filters, blocks, stride in stages:
            x = bottleneck(f"{sname}_0", x, filters, stride=stride,
                           project=True)
            for i in range(1, blocks):
                x = bottleneck(f"{sname}_{i}", x, filters)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("fc", OutputLayer(n_out=self.num_classes,
                                      activation="softmax", loss="mcxent",
                                      n_in=_w(2048)), "avgpool")
        g.set_outputs("fc")
        return g.build()


class ResNet50Cifar(ResNet50):
    """ResNet50 at width_mult 0.25 on 32 x 32 x 3, the bundled
    ``resnet50_cifar10.zip``'s configuration."""
    name = "resnet50_cifar10"
    default_input_shape = (32, 32, 3)

    def __init__(self, num_classes: int = 10, seed: int = 123, **kwargs):
        kwargs.setdefault("width_mult", 0.25)
        super().__init__(num_classes=num_classes, seed=seed, **kwargs)
