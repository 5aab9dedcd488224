from flamo_tpu_torch.ops import linop
from flamo_tpu_torch.ops.fdn_kernels import (dense_solve, fdn_solve, fdn_tf,
                                             fdn_tf_mse)
from flamo_tpu_torch.ops.solve import (closed_loop_solve, gauss_solve,
                                       gauss_solve_cached)
