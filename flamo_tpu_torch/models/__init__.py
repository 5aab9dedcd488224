from flamo_tpu_torch.models.active_acoustics import (
    ActiveAcoustics, aa_dft_basis, aa_evs_fit, aa_evs_train_step,
    aa_fused_operands, aa_fused_step, aa_fused_taps_step,
    aa_hoisted_room_step, build_active_acoustics, gain_before_instability,
    gain_before_instability_diff, open_loop_eigenvalues, open_loop_matrix,
)
from flamo_tpu_torch.models.attenuated_fdn import (
    attenuated_loss, attenuated_loss_fused_step, attenuated_train_step,
    build_attenuated_fdn, extract_attenuated_operands,
)
from flamo_tpu_torch.models.colorless_fdn import (
    build_colorless_fdn, colorless_fit, colorless_freq_response_fused,
    colorless_loss, colorless_loss_fused_step, colorless_loss_fused_tf,
    colorless_train_step, extract_siso_tf_operands,
)
from flamo_tpu_torch.models.scattering_fdn import (
    DEFAULT_SFDN_DELAYS, build_colorless_sfdn, sfdn_fit, sfdn_masked_est,
    sfdn_masked_loss, sfdn_masked_train_step, sfdn_train_step,
)
