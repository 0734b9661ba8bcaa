#!/usr/bin/env python3
"""Time the LSTM and flash decode kernels of one or more checkouts of this
repository on one card, every checkout with the same timers: those of this
checkout's ``chip_smoke.py``.

    python3 tools/compare_trees.py ROOT [ROOT ...] \\
        --case lstm_fwd_train:16:32:256:float32 \\
        --case flash_decode:8:512:mid [--case ...] \\
        [--probe k12:1054:1058] [--tbptt-profile]

Each ROOT (a checkout, for example a ``git archive`` of another commit
unpacked into a git-ignored directory) runs in a process of its own, in the
order given; give them as parent, change, change, parent (and again) so the
card's drift shows. That process imports the ROOT's
``deeplearning4j_tpu_torch`` (it runs from the ROOT) and this checkout's
``chip_smoke.py`` (loaded by path), so a kernel of any commit is timed and
checked by the same ``chip_smoke.kernel_case``: ``ms`` the device time of
one call (calls replayed from a CUDA graph), ``call_ms`` the time of a call
launched from the host, ``plain_ms`` and ``library_ms`` beside them, the
result held against the plain version (f32 1e-4, bf16 3e-2) and repeated
bit for bit.

``--case KERNEL:T:B:H:DTYPE`` names a ``chip_smoke.KERNELS`` kernel and its
shape; ``--case flash_decode:B:C:POS[:DH[:HEADS]]`` (or
``flash_decode_paged``, pages of 16 rows) a decode step of B streams over a
capacity of C at positions POS -- ``last``, ``spread``, ``mid`` or a comma
list (``chip_smoke.decode_positions``) -- head dim DH (32) and HEADS heads
(4), timed by ``chip_smoke.attn_kernel_case``: ``ms`` by graph replay,
``call_ms``, ``plain_ms``, ``library_ms`` (SDPA), the result held against
the plain version (1e-4) and repeated bit for bit over 20 launches. A case
given twice is timed twice. ``--probe NAME:LO:HI`` calls
``chip_smoke.<NAME>_hidden_sizes(LO, HI)`` (``k3``, ``k4`` or ``k12``): the
hidden sizes in [LO, HI] the kernels take. ``--tbptt-profile`` profiles ten
batches of the LSTM model's truncated BPTT with ``chip_smoke.tbptt_net`` and
``chip_smoke.profile_tbptt``, as ``chip_smoke.py``'s train (c) does.

Prints one JSON line per case, probe and profile, each with its root, its
position in the order and the card's ``nvidia-smi`` name and power limit,
and writes them all to ``chiprun_out/compare_trees.json`` under this
script's checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# run from a ROOT: that ROOT's package, this checkout's chip_smoke
CHILD = r"""
import importlib.util, json, sys
import torch
smoke, cases, probes, tbptt = json.loads(sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from deeplearning4j_tpu_torch.ops import build
card = cs.card_line()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_kernels()


def emit(row):
    row["card"] = card
    print("ROW " + json.dumps(row), flush=True)


for case in cases:
    if case[0].startswith("flash_decode"):
        kernel, B, C, pos, dh, heads = case
        emit(cs.attn_kernel_case(kernel, B, C, pos=cs.decode_positions(
            pos, B, C), seed=1, dh=dh, heads=heads))
    else:
        emit(cs.kernel_case(*case))
for name, lo, hi in probes:
    emit({"probe": name, "lo": lo, "hi": hi,
          "took": getattr(cs, name + "_hidden_sizes")(lo, hi)})
if tbptt:
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    (xtr, ytr), _, vocab = corpus_windows(stride=8)
    net = cs.tbptt_net(TextGenerationLSTM(total_unique_characters=len(vocab)))
    emit({"tbptt_profile": cs.profile_tbptt(net, xtr, ytr, 32)})
"""


def spec(text, types):
    parts = text.split(":")
    if len(parts) != len(types):
        raise argparse.ArgumentTypeError(f"{text!r}: want {len(types)} "
                                         "fields separated by ':'")
    return [t(p) for t, p in zip(types, parts)]


def case(text):
    """An LSTM case (KERNEL:T:B:H:DTYPE) or a decode case
    (flash_decode[_paged]:B:C:POS[:DH[:HEADS]])."""
    if not text.startswith("flash_decode"):
        return spec(text, (str, int, int, int, str))
    parts = text.split(":")
    if not 4 <= len(parts) <= 6:
        raise argparse.ArgumentTypeError(f"{text!r}: want KERNEL:B:C:POS"
                                         "[:DH[:HEADS]]")
    return ([parts[0], int(parts[1]), int(parts[2]), parts[3]]
            + [int(p) for p in parts[4:]] + [32, 4][len(parts) - 4:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--case", action="append", default=[], type=case,
                    metavar="KERNEL:T:B:H:DTYPE or DECODE:B:C:POS[:DH[:HEADS]]")
    ap.add_argument("--probe", action="append", default=[],
                    type=lambda s: spec(s, (str, int, int)),
                    metavar="NAME:LO:HI")
    ap.add_argument("--tbptt-profile", action="store_true")
    args = ap.parse_args()
    job = json.dumps([str(HERE / "chip_smoke.py"), args.case, args.probe,
                      args.tbptt_profile])
    rows = []
    for order, root in enumerate(args.roots):
        root = root.resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD, job], cwd=root,
                              capture_output=True, text=True, timeout=1800)
        for line in proc.stdout.splitlines():
            if line.startswith("ROW "):
                row = json.loads(line[4:])
                row.update(root=str(root), order=order)
                rows.append(row)
                print(json.dumps(row), flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "compare_trees.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
