"""Parallelism of the port (ROADMAP.md A.7a): the mesh of one process per
device (``mesh``), the collectives with JAX's transposes
(``collectives``), sharding rules (``sharding``), the bootstrap from the
torchrun env (``distributed``), ring attention on the flash kernels
(``ring_attention``), the pipeline (``pipeline``), MoE (``moe``), the
composed dp x fsdp x tp x pp step (``composite``), its communication model
(``comm``) and a local multi-process launcher (``launch``)."""
