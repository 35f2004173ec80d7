"""Digests of the codes and scores that chip_smoke.py's STL-16f and
STL-128f generation recipes give (full width, random weights from seed 0,
sampling seed 0, codes only: vqgan=None), with the package and the
chip_smoke.py of the directory it runs from, so that two trees'
generation can be compared bit for bit on one card.

    cd <tree> && python3 <this repo>/scripts/codes_digest.py

Prints the card's name and power limit, then one JSON line per recipe:
the sha256 of the code maps and of the scores, their shapes, and the
K1-K9 launch counts of the call.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def main() -> int:
    if not torch.cuda.is_available():
        print("codes_digest: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mebt_tpu_torch.cli.common import random_mebt
    from mebt_tpu_torch.models.mebt import MeBTConfig
    from mebt_tpu_torch.sampler.generation import bidirect_generate

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for config, widths, batch, recipe in (("stl_16f", cs.STL16, cs.BATCH, cs.RECIPE),
                                          ("stl_128f", cs.STL128, cs.BATCH128, cs.RECIPE128)):
        model = random_mebt(MeBTConfig(dtype=torch.bfloat16, **widths), 0, dev)
        res, launches, wall = cs.counted(lambda: bidirect_generate(model, None, 0, batch, **recipe))
        codes, score = np.ascontiguousarray(res.code_maps), np.ascontiguousarray(res.score)
        print(json.dumps(dict(
            config=config, tree=os.getcwd(), batch=batch, code_maps=list(codes.shape),
            codes_sha256=hashlib.sha256(codes.tobytes()).hexdigest(),
            scores_sha256=hashlib.sha256(score.tobytes()).hexdigest(),
            launches=dict(zip(cs.KERNELS, launches)), wall_s=wall)), flush=True)
        del model, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
