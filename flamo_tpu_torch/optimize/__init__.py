from flamo_tpu_torch.optimize.dataset import (
    Dataset, DatasetColorless, get_dataloader, load_dataset, split_dataset,
    stack_loader,
)
from flamo_tpu_torch.optimize.loss import (
    AveragePower, edc_loss, edr_loss, masked_mse_loss, mel_mss_loss, mse_evs,
    mse_loss, mss_loss, sparsity_loss,
)
from flamo_tpu_torch.optimize.trainer import (Trainer, load_model_state,
                                              save_model_state)
from flamo_tpu_torch.optimize.utils import generate_partitions
