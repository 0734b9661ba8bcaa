"""The port's CUDA kernels (K1 csrc/lstm_fwd.cu, K4 csrc/lstm2_fwd.cu)
against their plain PyTorch versions on the card.

Marked ``cuda``: they skip without a card, since a CUDA kernel has no CPU
mode. On a machine with one (and ``nvcc``) they run with the usual
``python -m pytest tests/test_torch_kernels_cuda.py``; this file imports no
JAX, so it runs where only the port is installed. Tolerances as in
chip_smoke.py: float32 1e-4, bfloat16 3e-2 on every output.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import lstm_cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
K1 = ("gate_in", "rw1", "h01", "c01")
K4 = ("gate_in", "rw1", "w2", "b2", "rw2", "h01", "c01", "h02", "c02")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(T, B, H, dtype, device, seed=0):
    r = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(H)
    shapes = {"gate_in": ((T, B, 4 * H), 0.5), "rw1": ((H, 4 * H), s),
              "w2": ((H, 4 * H), s), "b2": ((4 * H,), 0.1),
              "rw2": ((H, 4 * H), s), "h01": ((B, H), 0.5),
              "c01": ((B, H), 0.5), "h02": ((B, H), 0.5), "c02": ((B, H), 0.5)}
    return {k: torch.tensor(r.randn(*shp) * sc, dtype=torch.float32)
            .to(dtype).to(device) for k, (shp, sc) in shapes.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm2_fwd"])
@pytest.mark.parametrize("T,B,H", [(64, 40, 256), (7, 15, 40), (5, 70, 300)])
def test_kernel_matches_plain_on_the_card(kernel, dtype, T, B, H,
                                          cuda_device):
    """Serving widths (T=64, H=256, a batch that splits across blocks) and
    ragged ones (H not a multiple of the unit slice, B not of the row
    pass)."""
    c = _case(T, B, H, dtype, cuda_device)
    if kernel == "lstm_fwd":
        args = [c[k] for k in K1]
        wrapper, plain = ops.fused_lstm_sequence, lstm_cuda.lstm_sequence_plain
    else:
        args = [c[k] for k in K4]
        wrapper, plain = (ops.fused_lstm2_sequence,
                          lstm_cuda.lstm2_sequence_plain)
    before = ops.launch_counts().get(kernel, 0)
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()[kernel] == before + 1
    want = plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda_device):
    c = _case(3, 2, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_lstm_sequence(c["gate_in"].transpose(0, 1).contiguous()
                                .transpose(0, 1), c["rw1"], c["h01"],
                                c["c01"])
    with pytest.raises(ValueError, match="cpu"):
        ops.fused_lstm_sequence(c["gate_in"], c["rw1"].cpu(), c["h01"],
                                c["c01"])
