"""The multi-device layer (counterpart of ``flamo_tpu/parallel``): bin
sharding, data parallelism, multi-seed ensembles and the fused kernels
under sharding, over ``torch.distributed`` process groups
(:func:`~flamo_tpu_torch.parallel.launch.spawn` starts them)."""

from flamo_tpu_torch.parallel.mesh import (
    get_mesh, get_mesh_2d, shard_spectrum, replicate, bin_sharded_forward,
)
from flamo_tpu_torch.parallel.dp import make_dp_train_step, shard_batch
from flamo_tpu_torch.parallel.ensemble import MultiSeedEnsemble
from flamo_tpu_torch.parallel.fused import (
    bins_sharded_fused_loss, make_bins_sharded_fused_step,
    bins_sharded_attenuated_loss, make_bins_sharded_attenuated_step,
    make_bins_sharded_aa_taps_step, make_bins_sharded_evs_step,
    seed_bins_sharded_fused_loss, make_seed_bins_sharded_fused_step,
    masked_sharded_sfdn_loss, make_masked_sharded_sfdn_step,
)

__all__ = [
    "get_mesh", "get_mesh_2d", "shard_spectrum", "replicate",
    "bin_sharded_forward", "make_dp_train_step", "shard_batch",
    "MultiSeedEnsemble", "bins_sharded_fused_loss",
    "make_bins_sharded_fused_step", "bins_sharded_attenuated_loss",
    "make_bins_sharded_attenuated_step", "make_bins_sharded_aa_taps_step",
    "make_bins_sharded_evs_step", "seed_bins_sharded_fused_loss",
    "make_seed_bins_sharded_fused_step", "masked_sharded_sfdn_loss",
    "make_masked_sharded_sfdn_step",
]
