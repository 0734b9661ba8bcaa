"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, and it does not fall back to the CPU when the card is missing."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "deeplearning4j_tpu_torch",
    "deeplearning4j_tpu_torch.ops",
    "deeplearning4j_tpu_torch.ops.build",
    "deeplearning4j_tpu_torch.ops.lstm_cuda",
    "deeplearning4j_tpu_torch.ops.attention_cuda",
    "deeplearning4j_tpu_torch.ops.decode_cuda",
    "deeplearning4j_tpu_torch.nn.activations",
    "deeplearning4j_tpu_torch.nn.weights",
    "deeplearning4j_tpu_torch.nn.losses",
    "deeplearning4j_tpu_torch.nn.updaters",
    "deeplearning4j_tpu_torch.nn.conf",
    "deeplearning4j_tpu_torch.nn.layers",
    "deeplearning4j_tpu_torch.nn.layers.attention",
    "deeplearning4j_tpu_torch.nn.conf.graph_conf",
    "deeplearning4j_tpu_torch.models.multi_layer_network",
    "deeplearning4j_tpu_torch.models.computation_graph",
    "deeplearning4j_tpu_torch.util.model_serializer",
    "deeplearning4j_tpu_torch.data",
    "deeplearning4j_tpu_torch.data.dataset",
    "deeplearning4j_tpu_torch.data.iterators",
    "deeplearning4j_tpu_torch.eval",
    "deeplearning4j_tpu_torch.eval.evaluation",
    "deeplearning4j_tpu_torch.zoo",
    "deeplearning4j_tpu_torch.zoo.corpus",
    "deeplearning4j_tpu_torch.serving",
    "deeplearning4j_tpu_torch.serving.kv",
    "deeplearning4j_tpu_torch.serving.decode",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'deeplearning4j_tpu'\n"
        "             or m.startswith('deeplearning4j_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_cuda_is_refused_not_replaced():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from deeplearning4j_tpu_torch import MultiLayerNetwork, ops
    from deeplearning4j_tpu_torch.zoo import (TextGenerationLSTM,
                                              TinyTransformer)
    conf = TextGenerationLSTM(total_unique_characters=9).conf()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextGenerationLSTM(total_unique_characters=51).init_pretrained()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TinyTransformer(vocab_size=9, d_model=16, max_len=8).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.resolve_device("cuda:0")
    assert ops.resolve_device("cpu").type == "cpu"
