"""repro_torch.dist — the distribution layer on ``torch.distributed``.

The reference's ``repro.dist`` without ``partitioning`` (the LM stack's
sharding rules), as SPMD code: every rank of a mesh calls the same
function with the same replicated inputs.

Modules
-------
checkpoint    atomic manifest-based save / load_latest / retention in the
              reference's on-disk format, plus the Lanczos callback
compression   error-feedback int8 compression of tensor trees
straggler     per-host step-time monitor and microbatch rebalance plans
elastic       ``plan_remesh``: the mesh after device churn
mesh          ``make_mesh`` and ``Tiling``, one rank's (rows x 'model')
              view of a mesh and its collectives
sharded_la    the distributed products, the band sweep and the blocked
              Cholesky and triangular solves on row blocks
eigensolver   ``solve_ke_distributed`` and ``solve_tt_distributed``
launcher      ``run_local``: a world of local ranks (gloo on the CPU, NCCL
              on the cards) around one SPMD function
"""
from . import (checkpoint, compression, elastic, launcher, sharded_la,
               straggler)
from .eigensolver import solve_ke_distributed, solve_tt_distributed
from .mesh import make_mesh

__all__ = [
    "checkpoint", "compression", "elastic", "launcher", "sharded_la",
    "straggler", "solve_ke_distributed", "solve_tt_distributed",
    "make_mesh",
]
