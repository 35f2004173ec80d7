"""Parallelism on torch.distributed (mebt_tpu/parallel): the (data,
model[, seq][, pipe]) mesh, parameter sharding, ZeRO-1 and the axis
collectives with their gradients (mesh.py), sequence parallelism over
the token canvas for the decode and training (sp.py), and the GPipe
pipeline over the blocks (pp.py)."""
