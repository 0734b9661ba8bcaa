#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (the serving precisions) alone on the
card, from the root of a checkout, its kernels built first:

    python3 tools/precision_phase.py [label]

Prints one JSON line, ``P15 {...}``: the label, the phase's seconds and
its parts' (LSTM, decode, HTTP), and the tokens/s of each decode run. To
compare two trees on one card, run it from both checkouts in one call,
in the order parent, change, change, parent.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path.cwd()))


def main() -> None:
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import build
    build.build_kernels()
    res = cs.serving_precision_phase(cs.card_line())
    runs = {k: v["tokens_per_s"] for k, v in res["decode"].items()
            if isinstance(v, dict) and "tokens_per_s" in v}
    print("P15 " + json.dumps({
        "label": sys.argv[1] if len(sys.argv) > 1 else "",
        "card": res["card"], "seconds": res["seconds"],
        "lstm_s": res["lstm_part_s"], "decode_s": res["decode_part_s"],
        "http_s": res["http_part_s"], "tokens_per_s": runs}))


if __name__ == "__main__":
    main()
