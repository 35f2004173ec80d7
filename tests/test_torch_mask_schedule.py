"""The port's copy of the decode plans and segment DP equals the JAX
package's, for the STL 16f and 128f configs (exact equality: the DP
decides every bucket shape)."""

import numpy as np
import pytest

from mebt_tpu.config import load_configs
from mebt_tpu.models.mebt import MeBTConfig as JaxMeBTConfig
from mebt_tpu.sampler import mask_schedule as jms
from mebt_tpu.sampler.decode import _ctx_weight as jax_ctx_weight
from mebt_tpu_torch.models.mebt import MeBTConfig
from mebt_tpu_torch.sampler import mask_schedule as tms
from mebt_tpu_torch.sampler.decode import _ctx_weight

# (config, MaskGIT steps, bootstrap steps) of the STL sampling recipes
RECIPES = [("configs/stl/mebt_16f.yaml", 32, 0), ("configs/stl/mebt_128f.yaml", 32, 64)]


def _configs(path):
    cfg = load_configs([path])
    params = cfg.model.params.to_dict()
    shape = tuple(cfg.model.mask.params.shape)
    return (
        JaxMeBTConfig.from_config(params, mask_shape=shape),
        MeBTConfig.from_config(params, mask_shape=shape),
    )


def _assert_plans_equal(a, b):
    assert a.n_steps == b.n_steps and a.n_ctx_init == b.n_ctx_init
    for f in ("do_step", "n_new", "n_contexts", "t", "ctemp_scale"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("path,n_steps,n_boot", RECIPES)
def test_plans_and_segments_match(path, n_steps, n_boot):
    jcfg, tcfg = _configs(path)
    N = tcfg.seq_len
    assert _ctx_weight(tcfg) == jax_ctx_weight(jcfg)
    if n_boot:
        _assert_plans_equal(
            tms.bootstrap_plan(N, n_boot), jms.bootstrap_plan(N, n_boot)
        )
    for sched in ("cosine", "linear", "square"):
        for ctemp in ("linear", "cosine"):
            tp = tms.maskgit_plan(N, n_steps, sched, ctemp, n_ctx_init=n_boot)
            jp = jms.maskgit_plan(N, n_steps, sched, ctemp, n_ctx_init=n_boot)
            _assert_plans_equal(tp, jp)
            w = _ctx_weight(tcfg)
            assert tms.plan_segments_joint(tp, N, ctx_weight=w) == \
                jms.plan_segments_joint(jp, N, ctx_weight=w)
            assert tms.plan_segments(tp, N) == jms.plan_segments(jp, N)


def test_skip_steps_and_edit_plan_match():
    # many steps over a short canvas produce skipped steps
    _assert_plans_equal(tms.maskgit_plan(64, 100), jms.maskgit_plan(64, 100))
    _assert_plans_equal(
        tms.maskgit_plan(1024, 16, n_ctx_init=768, edit_N=256),
        jms.maskgit_plan(1024, 16, n_ctx_init=768, edit_N=256),
    )
