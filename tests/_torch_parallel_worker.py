"""One rank of the port's parallel CPU tests:

    python tests/_torch_parallel_worker.py JOB PORT RANK WORLD

joins a gloo group of WORLD ranks at localhost:PORT, builds the mesh
and the whole model of JOB (a torch.save'd dict: `mesh` make_mesh's
arguments, `config` MeBTConfig's, `state` the whole state dict, `tasks`
a list of (name, kind, arguments)), runs each task and saves
{name: result} beside JOB as rank<RANK>.pt. Whole-batch inputs are cut
to this rank's rows (and span) here, as a caller of the port does."""

import os
import sys

import torch
import torch.distributed as dist


def task_mesh(model, mesh):
    """Per axis: the global ranks of its members (all_gather), the rank
    at its index 0 (broadcast) and its largest rank (all_reduce MAX)."""
    from mebt_tpu_torch.parallel.mesh import all_gather, all_reduce, broadcast

    out = {}
    for axis in mesh.shape:
        r = torch.tensor([dist.get_rank()])
        out[axis] = dict(members=all_gather(r, mesh, axis).tolist(),
                         first=broadcast(r.clone(), mesh, axis, src=0).item(),
                         top=all_reduce(r.clone(), mesh, axis, "max").item())
    return out


def task_forward(model, mesh, codes, ctx, tgt):
    from mebt_tpu_torch.models.mebt import on_mesh
    from mebt_tpu_torch.parallel.mesh import batch_rows

    rows = batch_rows(codes.shape[0], mesh)
    return on_mesh(model, mesh)(codes[rows], ctx[rows], tgt[rows])


def task_decode(model, mesh, seed, B, plan, codes=None, ctx_mask=None, **kw):
    from mebt_tpu_torch.models.mebt import on_mesh
    from mebt_tpu_torch.parallel.mesh import batch_rows
    from mebt_tpu_torch.sampler.decode import maskgit_sample

    rows = batch_rows(B, mesh)
    st = maskgit_sample(on_mesh(model, mesh), seed, B, plan,
                        codes=None if codes is None else codes[rows],
                        ctx_mask=None if ctx_mask is None else ctx_mask[rows], **kw)
    return dict(codes=st.codes, ctx_mask=st.ctx_mask, chosen_prob=st.chosen_prob)


def task_dnr(model, mesh, seed, codes, ctx_mask=None, **kw):
    from mebt_tpu_torch.models.mebt import on_mesh
    from mebt_tpu_torch.parallel.mesh import batch_rows
    from mebt_tpu_torch.sampler.decode import draft_and_revise

    rows = batch_rows(codes.shape[0], mesh)
    return draft_and_revise(on_mesh(model, mesh), seed, codes[rows],
                            ctx_mask=None if ctx_mask is None else ctx_mask[rows], **kw)


def task_generate(model, mesh, vqgan_config, vqgan_state, seed, batch_size, **kw):
    from mebt_tpu_torch.models.mebt import on_mesh
    from mebt_tpu_torch.models.vqgan import VQGAN, VQGANConfig
    from mebt_tpu_torch.sampler.generation import bidirect_generate

    vqgan = VQGAN(VQGANConfig(**vqgan_config))
    vqgan.load_state_dict(vqgan_state)
    res = bidirect_generate(on_mesh(model, mesh), vqgan.eval(), seed, batch_size, **kw)
    return dict(samples=res.samples, code_maps=res.code_maps, score=res.score)


def task_head(model, mesh, x, w, seed, temperature, k=None):
    """The sharded head's wrapper (its plain path on the CPU) on this
    rank's rows of x and vocabulary rows of w."""
    from mebt_tpu_torch.ops.head_sample import head_sample, head_topk_sample
    from mebt_tpu_torch.parallel.mesh import batch_rows

    rows = batch_rows(x.shape[0], mesh)
    n = w.shape[0] // mesh.size("model")
    w_l = w[mesh.index("model") * n:(mesh.index("model") + 1) * n]
    kw = dict(mesh=mesh, row_offset=rows.start)
    if k is None:
        return head_sample(x[rows], w_l, seed, temperature, **kw)
    return head_topk_sample(x[rows], w_l, seed, k, temperature, **kw)


def task_sp_forward(model, mesh, codes, ctx, tgt):
    from mebt_tpu_torch.parallel.sp import canvas_block, sp_forward

    return sp_forward(model, *(canvas_block(t, mesh) for t in (codes, ctx, tgt)), mesh)


def task_sp_decode(model, mesh, seed, B, plan, **kw):
    from mebt_tpu_torch.parallel.sp import sp_maskgit_sample

    promoted = []
    codes, ctx, chosen = sp_maskgit_sample(model, seed, B, plan, mesh, promoted=promoted, **kw)
    return dict(codes=codes, ctx_mask=ctx, chosen_prob=chosen, promoted=promoted)


def task_sp_refusals(model, mesh, config, state, codes, ctx, tgt, plan):
    """The messages of what sequence parallelism refuses: an entp
    decode, and a forward through a maskgit block."""
    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
    from mebt_tpu_torch.parallel.sp import canvas_block, sp_forward, sp_maskgit_sample

    out = {}
    try:
        sp_maskgit_sample(model, 0, codes.shape[0], plan, mesh, strategy="entp")
    except NotImplementedError as e:
        out["entp"] = str(e)
    m2 = MeBT(MeBTConfig(**config))
    m2.load_state_dict(state)
    try:
        sp_forward(m2.eval(), *(canvas_block(t, mesh) for t in (codes, ctx, tgt)), mesh)
    except NotImplementedError as e:
        out["maskgit"] = str(e)
    return out


# -- training (tests/test_torch_parallel_train_tp.py, _zero1.py, _sp_train.py,
# _pp.py). A batch is a whole batch dict (codes, ctx_mask, tgt_mask,
# seq_len, masked_weight); each rank cuts its rows (and span). Gradients
# and parameters come back whole, gathered over the axes that shard them.

JOB = {}


def _rebuilt(**overrides):
    """The job's model with config overrides (dropout rates), same weights."""
    from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig

    m = MeBT(MeBTConfig(**dict(JOB["config"], **overrides)))
    m.load_state_dict(JOB["state"])
    return m


def _rows(batch, mesh):
    from mebt_tpu_torch.parallel.mesh import batch_rows

    rows = batch_rows(batch["codes"].shape[0], mesh)
    return {k: v[rows] if torch.is_tensor(v) else v for k, v in batch.items()}, rows


def _drop(drop, B, rows):
    from mebt_tpu_torch.models.transformer import DropoutState

    if drop is None:
        return None
    return DropoutState(torch.Generator().manual_seed(drop["gen"]), drop["seed"], batch=B,
                        row0=rows.start)


def _whole(named, mesh, stage=None):
    from mebt_tpu_torch.parallel.mesh import gather_state_dict
    from mebt_tpu_torch.parallel.pp import from_pp_params

    named = {n: t.detach() for n, t in named.items()}
    return gather_state_dict(named, mesh) if stage is None else from_pp_params(stage, mesh, named)


def _grads(model):
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in model.named_parameters()}


def task_loss_grads(model, mesh, batch, avg_loss=1.0, label_smoothing=0.0, drop=None,
                    rates=None):
    """One forward and backward of this rank's rows through the mesh
    model (vocab-parallel loss), the gradients summed over `data`: the
    whole loss, this rank's share and the whole gradients."""
    from mebt_tpu_torch.models.mebt import mlm_loss, on_mesh
    from mebt_tpu_torch.parallel.mesh import all_reduce_grads

    m = on_mesh(_rebuilt(**(rates or {})), mesh).train()
    b, rows = _rows(batch, mesh)
    B = batch["codes"].shape[0]
    with torch.enable_grad():
        logits = m(b["codes"], b["ctx_mask"], b["tgt_mask"], drop=_drop(drop, B, rows),
                   vocab_shard=True)
        loss, metrics = mlm_loss(logits, b["codes"], b["tgt_mask"], b["seq_len"],
                                 b["masked_weight"], avg_loss=avg_loss,
                                 label_smoothing=label_smoothing, mesh=mesh, batch=B)
        loss.backward()
    all_reduce_grads(list(m.parameters()), mesh, ("data",))
    return dict(loss=float(metrics["loss"]), share=float(loss),
                acc1=float(metrics["acc1"]), grads=_whole(_grads(m), mesh))


def task_train_steps(model, mesh, batches, lr, opt_kw=None, zero1=False):
    """make_train_step + the mesh optimizer over `batches` (dropouts 0):
    each step's whole loss, the whole parameters after, the moments'
    element count on this rank and the whole optimizer state."""
    from mebt_tpu_torch.models.mebt import on_mesh
    from mebt_tpu_torch.train import train_state as ts

    m = on_mesh(_rebuilt(), mesh).train()
    opt = ts.make_optimizer(m, lr, **(opt_kw or {}), mesh=mesh, zero1=zero1)
    state = ts.TrainState.create(m, opt, seed=0)
    step_fn = ts.make_train_step(m)
    losses = []
    with torch.enable_grad():
        for batch in batches:
            state, metrics = step_fn(state, _rows(batch, mesh)[0])
            losses.append(float(metrics["loss"]))
    moments = sum(st["exp_avg"].numel() for st in opt.adamw.state.values())
    return dict(losses=losses, params=_whole(dict(m.named_parameters()), mesh),
                moments=moments, zero=sorted(opt.zero), opt=opt.whole_state_dict())


class _RowsLoader:
    """Each rank's rows of a list of whole batches (codes, indices)."""

    def __init__(self, batches, mesh):
        from mebt_tpu_torch.parallel.mesh import batch_rows

        rows = batch_rows(batches[0]["codes"].shape[0], mesh)
        self.batches = [{k: v[rows] for k, v in b.items()} for b in batches]

    def set_epoch(self, e):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def task_fit(model, mesh, config, batches, steps, logdir, eval_batch, save=False):
    """MeBTTrainer.fit on the mesh (exp.model_parallel from the mesh) over
    this rank's rows of `batches`: the whole parameters after and the
    eval metrics of `eval_batch`; with `save` the trainer's checkpoint is
    written and read back onto the mesh, and each rank reports whether
    its parameters and moments came back bit for bit."""
    import functools

    from mebt_tpu_torch.train import trainer
    from mebt_tpu_torch.utils.metrics import MetricsLogger

    # metrics.jsonl only: importing TensorBoard takes seconds
    trainer.MetricsLogger = functools.partial(MetricsLogger, use_tensorboard=False)
    tr = trainer.MeBTTrainer(config, os.path.join(logdir, "logs"), seed=0,
                             compute_dtype=torch.float32, device="cpu", mesh=mesh)
    with torch.enable_grad():
        state = tr.fit(_RowsLoader(batches, mesh), max_steps=steps, log_every=1,
                       final_checkpoint=save)
    b, _ = _rows(tr.prepare_val_batch(eval_batch, __import__("numpy").random.default_rng(9)),
                 mesh)
    out = dict(params=_whole(dict(state.model.named_parameters()), mesh),
               eval=tr._eval_step(state, b), step=state.step)
    if save:
        fresh = tr.restore(tr.init_state(), os.path.join(logdir, "logs", "checkpoints",
                                                         f"{state.step}.pt"))
        out["restored_params"] = all(
            torch.equal(a, b) for a, b in zip(state.model.parameters(), fresh.model.parameters()))
        got, want = fresh.optimizer.adamw.state, state.optimizer.adamw.state
        out["restored_moments"] = all(
            torch.equal(got[pa][k], want[pb][k])
            for pa, pb in zip(fresh.optimizer.adamw.param_groups[0]["params"]
                              + fresh.optimizer.adamw.param_groups[1]["params"],
                              state.optimizer.adamw.param_groups[0]["params"]
                              + state.optimizer.adamw.param_groups[1]["params"])
            for k in ("exp_avg", "exp_avg_sq"))
        out["moments"] = sum(st["exp_avg"].numel() for st in want.values())
        out["whole_opt"] = state.optimizer.whole_state_dict()
    tr.logger.close()
    return out


def task_collective_grads(model, mesh, x):
    """Gradients of each collective over `model`: the input x_r = (r + 1) x
    on rank r, the loss sum(w * out) with w from the rank's index; the
    test derives each from the forward's definition."""
    from mebt_tpu_torch.parallel.mesh import all_gather, all_reduce, copy_to

    r = mesh.index("model")
    out = {}
    cases = {
        "sum_identity": lambda t: all_reduce(t, mesh, "model"),
        "sum_sum": lambda t: all_reduce(t, mesh, "model", grad="sum"),
        "copy_to": lambda t: copy_to(t, mesh, "model"),
        "gather": lambda t: all_gather(t, mesh, "model", dim=1),
    }
    with torch.enable_grad():
        for name, fn in cases.items():
            t = ((r + 1) * x).requires_grad_(True)
            y = fn(t)
            w = torch.arange(y.numel(), dtype=y.dtype).view_as(y) + 10.0 * r
            (w * y).sum().backward()
            out[name] = dict(value=y.detach(), grad=t.grad)
    return out


def task_sp_loss_grads(model, mesh, batch, avg_loss=1.0, label_smoothing=0.0, drop=None,
                       rates=None):
    """sp_loss_fn on this rank's block of `batch`: the whole loss and
    the gradients summed over data and seq."""
    from mebt_tpu_torch.parallel.mesh import all_reduce_grads
    from mebt_tpu_torch.parallel.sp import SP_GRAD_AXES, canvas_block, sp_loss_fn, sp_model

    m = sp_model(_rebuilt(**(rates or {})), mesh).train()
    B = batch["codes"].shape[0]
    b = {k: canvas_block(v, mesh) if torch.is_tensor(v) else v for k, v in batch.items()}
    d = None
    if drop is not None:
        from mebt_tpu_torch.models.transformer import DropoutState

        d = DropoutState(torch.Generator().manual_seed(drop["gen"]), drop["seed"])
    with torch.enable_grad():
        loss, metrics = sp_loss_fn(m, mesh, avg_loss, label_smoothing)(b, B, d)
        loss.backward()
    all_reduce_grads(list(m.parameters()), mesh, SP_GRAD_AXES)
    return dict(loss=float(metrics["loss"]), grads=_grads(m))


def task_sp_dropout(model, mesh, codes, ctx, tgt, rate, drop):
    """The SP forward with embedding and residual dropout at `rate`: the
    latents after every block (the seq ranks of a row must agree) and
    this block's logits; then the refusal of attention dropout."""
    from mebt_tpu_torch.models.transformer import DropoutState
    from mebt_tpu_torch.parallel.sp import canvas_block, sp_drop_rows, sp_forward, sp_model

    m = sp_model(_rebuilt(embd_pdrop=rate, resid_pdrop=rate), mesh).train()
    latents = []
    hooks = [blk.register_forward_hook(lambda mod, inp, res: latents.append(res[0].detach()))
             for blk in m.transformer.blocks]
    d = sp_drop_rows(DropoutState(torch.Generator().manual_seed(drop["gen"]), drop["seed"]),
                     codes.shape[0], codes.shape[1], mesh)
    logits = sp_forward(m, *(canvas_block(t, mesh) for t in (codes, ctx, tgt)), mesh, d)
    for h in hooks:
        h.remove()
    out = dict(latents=latents, logits=logits)
    a = sp_model(_rebuilt(attn_pdrop=rate), mesh).train()
    try:
        sp_forward(a, *(canvas_block(t, mesh) for t in (codes, ctx, tgt)), mesh, d)
    except NotImplementedError as e:
        out["attn_refused"] = str(e)
    return out


def task_pp(model, mesh, batch, n_micro, lr=None, opt_kw=None, zero1=False, remat=False,
            avg_loss=1.0, label_smoothing=0.0, rates=None, drop=None):
    """The pipeline on this rank's rows of `batch`: pp_logits (gathered
    over the vocabulary), then pp_loss_fn's loss and backward (the
    gradients summed over data); with `lr` one AdamW step after. The
    stage's block and moment counts, whole logits rows, gradients and
    parameters."""
    from mebt_tpu_torch.models.transformer import DropoutState
    from mebt_tpu_torch.parallel.mesh import all_reduce_grads
    from mebt_tpu_torch.parallel.pp import from_pp_params, pp_logits, pp_loss_fn, to_pp_params
    from mebt_tpu_torch.train import train_state as ts

    whole = _rebuilt(**(rates or {}))
    stage = to_pp_params(whole, mesh).train()
    b, _ = _rows(batch, mesh)
    out = dict(blocks=len(stage.transformer.blocks), stage=stage.pp_stage,
               n_params=sum(p.numel() for p in stage.parameters()),
               n_whole=sum(p.numel() for p in whole.parameters()))
    with torch.no_grad():
        out["logits"] = pp_logits(stage, b["codes"], b["ctx_mask"], b["tgt_mask"], mesh, n_micro)
    opt = None
    if lr is not None:
        opt = ts.make_optimizer(stage, lr, **(opt_kw or {}), mesh=mesh, zero1=zero1)
    with torch.enable_grad():
        d = None if drop is None else DropoutState(
            torch.Generator().manual_seed(drop["gen"]), drop["seed"])
        loss, metrics = pp_loss_fn(stage, mesh, n_micro, avg_loss, label_smoothing, remat)(b, d)
        loss.backward()
    out["loss"] = float(metrics["loss"])
    if opt is None:
        all_reduce_grads(list(stage.parameters()), mesh, ("data",))
        out["grads"] = _whole(_grads(stage), mesh, stage)
    else:
        out["grad_norm"] = float(opt.step())
        out["moments"] = sum(st["exp_avg"].numel() for st in opt.adamw.state.values())
        out["params"] = from_pp_params(stage, mesh)
    return out


TASKS = {k[len("task_"):]: v for k, v in globals().items() if k.startswith("task_")}


def main():
    path, port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    job = torch.load(path, weights_only=False)
    JOB.update(job)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
        from mebt_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(**job["mesh"])
        model = MeBT(MeBTConfig(**job["config"]))
        model.load_state_dict(job["state"])
        model.eval()
        out = {"coords": dict(mesh.coords)}
        with torch.no_grad():  # the training tasks turn gradients on themselves
            for name, kind, args in job["tasks"]:
                out[name] = TASKS[kind](model, mesh, **args)
        torch.save(out, os.path.join(os.path.dirname(path), f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
