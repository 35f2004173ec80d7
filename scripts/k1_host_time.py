"""Host time of K1 calls on one CUDA card: the bf16 `smallq_attention` at
chip_smoke.py's 16f latent_enc, 128f bootstrap lt2l and 128f lt2l shapes,
timed three ways after 20 warm calls: the CUDA-event median of 50 single
calls, the host's enqueue time a call over 500 calls in a row, and the
wall a call of those 500 once the card has finished (the larger of host
and device time). Run it from the root of each tree to compare, in turns:

    python3 scripts/k1_host_time.py <label>

Prints one JSON line: the label and, per shape, events_ms, enqueue_ms and
loop_ms.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from mebt_tpu_torch.ops import attention_cuda as ac  # noqa: E402

# (case, batch, keys, leading keys always live): 16 heads, 256 queries of 64
SHAPES = (("latent_enc", 16, 1024, 0), ("bootstrap", 2, 264, 256), ("lt2l_128f", 2, 8448, 256))


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_host_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    out = {}
    for case, B, NK, ones in SHAPES:
        q, k, v = (torch.randn(B, 16, n, 64, device=dev, generator=gen, dtype=torch.bfloat16)
                   for n in (256, NK, NK))
        mask = torch.rand(B, NK, device=dev, generator=gen) < 0.5
        mask[:, :ones] = True

        def fn():
            return ac.smallq_attention(q, k, v, mask)

        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(50):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[case] = dict(events_ms=float(np.median([s.elapsed_time(e) for s, e in pairs])),
                         enqueue_ms=(t1 - t0) / 500 * 1e3, loop_ms=(t2 - t0) / 500 * 1e3)
    print(sys.argv[1] if len(sys.argv) > 1 else "run", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
