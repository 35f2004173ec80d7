"""tests/test_fvd_closure.py on the port, on the CPU through the plain
paths: the same synthetic rolling-pattern videos, a tiny VQGAN trained
200 steps, a tiny MeBT (4 layers, 2 heads, 64 wide) trained on its
frozen codes with the fused step, 8-step bidirect sampling, and a fixed
seeded I3D; the trained model's FVD against held-out videos must be
below half the untrained model's (the original's bar). The loop is
chip_smoke.py:closure_loop, which the card's `closure16` phase runs at
one head of 64.

The MeBT trains 4000 steps, the original 400: after 400 steps neither
package meets the bar on the CPU (the original's trained FVD is above
its untrained one; the port's loop reaches 0.85 of it, 0.30 after 2000
and 0.06 after 4000).

The JAX original passes its already-uint8 samples through a float-to-
uint8 conversion that maps 0 to 128 and every other value to 255; the
port's samples go to the I3D as they are."""

import numpy as np
import pytest
import torch

from chip_smoke import closure_loop

pytestmark = pytest.mark.slow  # the whole train -> sample -> FVD loop, minutes


def test_train_sample_fvd_loop_moves_the_metric():
    torch.set_num_threads(1)
    res = closure_loop(torch.device("cpu"), n_head=2)
    print({k: v for k, v in res.items()})
    assert res["vqgan_recon_last"] < 0.5 * res["vqgan_recon_first"], res
    assert np.isfinite(res["mebt_loss_last"]) and res["mebt_loss_last"] < res["mebt_loss_first"]
    assert res["fvd_trained"] < 0.5 * res["fvd_untrained"], res
