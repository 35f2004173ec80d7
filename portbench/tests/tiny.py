"""A tiny generation cell on the CPU, where the program runs its plain
versions: what the harness's CPU tests drive."""

from __future__ import annotations

import copy

import torch

from portbench.manifest import Cell

CFG = dict(name="tiny", vocab_size=64, block_size=32, n_layer=4, n_head=4, n_embd=32, sos_emb=8,
           mode=["latent_enc", "latent_self", "latent_dec", "lt2l"], latent_shape=[2, 4, 4],
           vqgan=dict(embedding_dim=8, n_codes=64, n_hiddens=8, downsample=[4, 4, 4]),
           embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1, avg_loss=True, mask_method="mlm",
           mask_schedule="linear", t_range=[0.0, 1.0], mask_budget=24, mask_max_token=24,
           t_prior="gaussian2", exact_lr=1e-3, sequence_length=8, resolution=16)
MIX = dict(driver="generate", batch=3, total_length=8, step_size=8, context_size=4,
           vid_n_steps=6, schedule="cosine", vid_c_temp=4.0, ctemp_schedule="linear",
           temperature=1.0, top_k=None, bootstrap=0, trace_batches=2,
           check_rows=2, check_videos=1)
# set between the tiny program's readings on the CPU (sample_gap at most
# 3.4e-4, promote_gap and promote_miscount 0) and the float8 control's
# with the bootstrap mix (sample_gap 7e-3 to 1.2e-2); the CPU has no
# TF32, so the pixels' control reads 0 there and their limit only
# catches a fault
LIMITS = dict(sample_gap=0.003, promote_gap=0.01, promote_miscount=0, pixel_excess=0.05)


def cell(seed: int = 5, **mix) -> Cell:
    m = dict(copy.deepcopy(MIX), **mix)
    limits = dict(LIMITS)
    return Cell(name="tiny.gen", config_name="tiny", traffic="tiny", chips=1,
                cfg=copy.deepcopy(CFG), mix=m, limits=limits, end_to_end=[], per_layer=[],
                seed=seed, seconds=0.0, device=torch.device("cpu"))


TRAIN_MIX = dict(driver="train", batch=3, pool_batches=4, num_workers=1, log_every=50,
                 trace_steps=2, calibration_steps=2, start_step=30001)
# loose: the tiny model in bf16 on the CPU against float32 (the program
# reads at most 0.013, its tail 7e-4); each fault reads 0.1 and more in
# one of them
TRAIN_LIMITS = dict(loss_gap=0.02, grad_gap=0.05, change_gap=0.05, tail_loss_gap=0.01,
                    tail_change_gap=0.05)


def train_cell(seed: int = 5, **mix) -> Cell:
    return Cell(name="tiny.train", config_name="tiny", traffic="tiny", chips=1,
                cfg=copy.deepcopy(CFG), mix=dict(TRAIN_MIX, **mix), limits=dict(TRAIN_LIMITS),
                end_to_end=[], per_layer=[], seed=seed, seconds=0.0, device=torch.device("cpu"))
