"""Training across processes on ``torch.distributed``: the mesh and batch
placement (``mesh``), tensor-parallel sharding rules (``sharding``),
process setup (``multiprocess``), context-parallel attention
(``context_parallel``) and the multi-process dry run (``dryrun``)."""
