"""Zoo models: TextGenerationLSTM and TinyTransformer.

Counterpart of deeplearning4j_tpu/zoo/simple.py (the two char-level LMs
are ported so far; parity surface: the reference's
zoo/model/TextGenerationLSTM.java, and the JAX package's own
TinyTransformer).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.layers import (LSTM, DenseLayer,
                                                LayerNormalization,
                                                MultiHeadAttention,
                                                PositionalEmbedding,
                                                RnnOutputLayer)
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
             .updater(Adam(3e-4))
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
