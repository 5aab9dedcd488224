from flamo_tpu_torch.optimize.loss import (masked_mse_loss, mse_evs,
                                           mse_loss, sparsity_loss)
from flamo_tpu_torch.optimize.utils import generate_partitions
