"""Sequential zoo models: TextGenerationLSTM.

Counterpart of deeplearning4j_tpu/zoo/simple.py (only the char-level LM is
ported so far; parity surface: the reference's
zoo/model/TextGenerationLSTM.java).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


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
                .updater(Adam(1e-3))
                .weight_init("xavier")
                .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0)
                .list()
                .layer(LSTM(n_out=256, activation="tanh"))
                .layer(LSTM(n_out=256, activation="tanh"))
                .layer(RnnOutputLayer(n_out=vocab, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(InputType.recurrent(vocab))
                .build())
