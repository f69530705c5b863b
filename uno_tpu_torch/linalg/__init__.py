from uno_tpu_torch.linalg.ldlt import (LDLT, ldlt_factor, ldlt_factor_blocked,
                                       ldlt_factor_unrolled, ldlt_solve,
                                       ldlt_refine)

__all__ = ["LDLT", "ldlt_factor", "ldlt_factor_blocked", "ldlt_factor_unrolled",
           "ldlt_solve", "ldlt_refine"]
