#!/usr/bin/env python3
"""Probe which call sizes give a row other bits on the card than a 256-row
call, for the engine's per-row estimate math and the synthetic CE.

    python3 batch_bits.py

For the first block's pinv, the bordered pinv update and e_q, called
directly with no padding (``repro_torch.testing.estimate_state_calls(raw=
True)``), then as the engine calls them, and for ``SyntheticCE.score_pairs``,
a batch of 256 rows is computed in calls of n rows for every n in
``testing.BATCH_BITS_ROWS`` (1-64, 100, 128, 200) and held to one 256-row
call.  Prints one JSON line: the card's name and power limit, and for each
call the sizes at which any entry differs.  Needs one CUDA card.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("batch_bits: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import testing

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    calls = {f"raw {k}": v for k, v in testing.estimate_state_calls(dev, raw=True).items()}
    calls.update({f"engine {k}": v for k, v in testing.estimate_state_calls(dev).items()})
    calls["synthetic score_pairs"] = testing.synthetic_pair_call(dev)
    out = {"card": card.strip(), "batch": 256, "sizes": list(testing.BATCH_BITS_ROWS)}
    for name, (fn, xs) in calls.items():
        out[name] = [n for n in testing.BATCH_BITS_ROWS if testing.rows_differing(fn, xs, n)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
