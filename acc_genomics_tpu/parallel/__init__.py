from acc_genomics_tpu.parallel.mesh import make_mesh  # noqa: F401
from acc_genomics_tpu.parallel.sharded import (  # noqa: F401
    pairhmm_forward_dp,
    pairhmm_forward_dpsp,
)
