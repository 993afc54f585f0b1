"""Tensor- and data-parallel serving on torch.distributed: the mesh and its
sharding rules (``mesh``), the collectives the model calls (``collectives``),
process-group set-up (``multihost``), lockstep serving across processes
(``lockstep``) and the multi-process dry run (``dryrun``)."""
