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


TASKS = {k[len("task_"):]: v for k, v in globals().items() if k.startswith("task_")}


def main():
    path, port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    job = torch.load(path, weights_only=False)
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
        with torch.no_grad():
            for name, kind, args in job["tasks"]:
                out[name] = TASKS[kind](model, mesh, **args)
        torch.save(out, os.path.join(os.path.dirname(path), f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
