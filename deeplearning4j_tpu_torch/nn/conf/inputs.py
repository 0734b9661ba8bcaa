"""Input types and shape inference.

Counterpart of deeplearning4j_tpu/nn/conf/inputs.py (parity surface: the
reference's InputType). The dict form is the same, so one configuration
JSON describes a network in both packages. Convolutional shapes keep the
JAX package's channels-last order.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class InputType:
    kind: str  # 'ff' | 'rnn' | 'cnn' | 'cnn_flat' | 'cnn3d'
    size: int = 0          # ff: feature count
    timeseries_length: int = -1  # rnn: -1 = variable
    height: int = 0
    width: int = 0
    channels: int = 0
    depth: int = 0         # cnn3d

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=size)

    @staticmethod
    def recurrent(size: int, timeseries_length: int = -1) -> "InputType":
        return InputType(kind="rnn", size=size, timeseries_length=timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn", height=height, width=width, channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn_flat", height=height, width=width, channels=channels)

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn3d", depth=depth, height=height, width=width,
                         channels=channels)

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return self.size
        if self.kind in ("cnn", "cnn_flat"):
            return self.height * self.width * self.channels
        if self.kind == "cnn3d":
            return self.depth * self.height * self.width * self.channels
        raise ValueError(self.kind)

    def batch_shape(self, batch: int = 1):
        """Concrete array shape for one minibatch (NHWC for cnn, (B,T,C) for rnn)."""
        if self.kind in ("ff", "cnn_flat"):
            return (batch, self.flat_size())
        if self.kind == "rnn":
            t = self.timeseries_length if self.timeseries_length > 0 else 8
            return (batch, t, self.size)
        if self.kind == "cnn":
            return (batch, self.height, self.width, self.channels)
        if self.kind == "cnn3d":
            return (batch, self.depth, self.height, self.width, self.channels)
        raise ValueError(self.kind)

    def to_dict(self):
        return asdict(self)

    @staticmethod
    def from_dict(d):
        return InputType(**d)
