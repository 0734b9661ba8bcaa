"""Boundaries of the PyTorch port: none of its modules imports anything of
JAX or of the JAX package, every kernel source is built, and it does not
fall back to the CPU when the card is missing."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "deeplearning4j_tpu_torch").rglob("*.py"))


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


def test_every_module_is_checked_and_every_kernel_source_built():
    from deeplearning4j_tpu_torch.ops import build
    for m in ("deeplearning4j_tpu_torch", "deeplearning4j_tpu_torch.ops",
              "deeplearning4j_tpu_torch.ops.attention_cuda",
              "deeplearning4j_tpu_torch.models.computation_graph",
              "deeplearning4j_tpu_torch.data.dataset",
              "deeplearning4j_tpu_torch.exec.mesh",
              "deeplearning4j_tpu_torch.parallel.wrapper",
              "deeplearning4j_tpu_torch.parallel.distributed",
              "deeplearning4j_tpu_torch.scaleout.training_master",
              "deeplearning4j_tpu_torch.exec.elastic",
              "deeplearning4j_tpu_torch.exec.comms",
              "deeplearning4j_tpu_torch.exec.worker",
              "deeplearning4j_tpu_torch.exec.cluster"):
        assert m in PORT_MODULES
    assert sorted(build.SOURCES) == sorted(
        p.name for p in build.CSRC.glob("*.cu"))
    assert "flash_attn_bwd.cu" in build.SOURCES


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
