"""The parallel decode on torch.distributed (mebt_tpu/parallel): the
(data, model[, seq]) mesh, parameter sharding and axis collectives
(mesh.py), and sequence parallelism over the token canvas (sp.py)."""
