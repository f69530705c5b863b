"""Multi-card uno_tpu_torch on torch.distributed: the counterpart of
uno_tpu.parallel.  A process group (`make_group`, one card a rank, NCCL;
Gloo on the CPU) takes the place of the device mesh: the instance-sharded
batch (`solve_batch_sharded`), the block-cyclic distributed dense LDL^T
behind ldlt_backend="distributed" (`make_dist_ldlt`), the Schur-complement
KKT of block-arrow systems (`parallel.schur`) and the dry run
(`parallel.dryrun`, also under torchrun)."""

from uno_tpu_torch.parallel.group import Group, make_group, subgroup
from uno_tpu_torch.parallel.sharding import (build_sharded_batch_ipm,
                                             solve_batch_sharded)
from uno_tpu_torch.parallel.dist_ldlt import cyclic_permutation, make_dist_ldlt

__all__ = ["Group", "make_group", "subgroup", "build_sharded_batch_ipm", "solve_batch_sharded",
           "make_dist_ldlt", "cyclic_permutation"]
