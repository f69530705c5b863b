"""uno_tpu_torch: the PyTorch and CUDA port of uno_tpu, for one NVIDIA H100.

It solves smooth nonconvex NLPs
    min f(x)  s.t.  cL <= c(x) <= cU,  xL <= x <= xU
with the `ipopt` preset's primal-dual interior-point method or the fused
SQP presets (`filtersqp`, `funnelsqp`, `filterslp`, `byrd`), one instance
(`solve`) or a batch of instances of one problem (`solve_batch`); AMPL
models come in through `io.read_nl` and `python -m uno_tpu_torch`.  The
batch is an explicit leading axis with per-instance RUNNING masks;
derivatives come from torch.func in float64; the KKT factorization is an
unpivoted LDL^T whose pivot signs give the inertia, a hand-written CUDA
kernel on the card (linalg/cuda_ldlt.py, csrc/ldlt.cu).

Over several cards (uno_tpu.parallel's counterpart, torch.distributed:
NCCL on the cards, Gloo on the CPU): `parallel.make_group` gives the
process group; `parallel.solve_batch_sharded` splits a batch over its
ranks; `solve(..., ldlt_backend="distributed", group=...)` splits one
instance's KKT factorization over them (parallel/dist_ldlt.py, its panels
on the csrc/dist_ldlt.cu kernel); `solve_structured_ipm` solves two-stage
scenario NLPs (`ScenarioNLP`) through the Schur-complement KKT
(parallel/schur.py), on one card or with the scenarios split over a group;
`python -m uno_tpu_torch.parallel.dryrun` (or under torchrun) drives all of
it once.

Entry points run on the card ("cuda") unless the caller passes
device="cpu"; with no card they raise.  The package imports torch and
numpy only, never jax or uno_tpu.
"""

from uno_tpu_torch.options import Options, preset
from uno_tpu_torch.model.nlp import NLP, nlp_from_functions
from uno_tpu_torch.solvers.ipm import (ALGORITHMIC_ERROR, ALMOST_OPTIMAL,
                                       INFEASIBLE_STATIONARY, MAX_ITERATIONS,
                                       OPTIMAL, RUNNING, STATUS_NAMES,
                                       TIME_LIMIT, UNBOUNDED, Result)
from uno_tpu_torch.solvers.batch import BatchResult, solve_batch
from uno_tpu_torch.api import solve
from uno_tpu_torch.parallel import make_group, solve_batch_sharded
from uno_tpu_torch.solvers.structured import ScenarioNLP, solve_structured_ipm

__version__ = "0.1.0"

__all__ = ["Options", "preset", "NLP", "nlp_from_functions", "solve",
           "solve_batch", "make_group", "solve_batch_sharded", "ScenarioNLP",
           "solve_structured_ipm", "Result", "BatchResult", "STATUS_NAMES", "RUNNING",
           "OPTIMAL", "ALMOST_OPTIMAL", "INFEASIBLE_STATIONARY", "UNBOUNDED",
           "ALGORITHMIC_ERROR", "MAX_ITERATIONS", "TIME_LIMIT", "__version__"]
