#!/usr/bin/env python3
"""Drive flamo_tpu_torch's colorless-, attenuated- and scattering-FDN
paths, its active-acoustics path, its phase-2 micro-benchmark, its
Trainer path, its e8_fdn example path, its filter zoo, its accurate
GEQ, velvet-noise and tutorial paths, its reverb domain, its
multi-device layer, its QR eigensolver, its solves past 16 channels and
its fused-tf, fused-response and attenuated fused steps past 16 channels
and its active-acoustics magnitude steps past 8 microphones on one CUDA
card.

Run from the root of the repository:

    python3 chip_smoke.py [--ptxas]

Phases, in order; any failure raises and exits non-zero without a result:

1. device and build: needs CUDA, prints the card's name and power limit,
   compiles the hand-written kernels of flamo_tpu_torch/csrc (nvcc,
   sm_90a, one process per library, all at once) and, beside them,
   controls/fdn_kernels_prev/fdn_kernels.cu, the K1-K3 and K6 kernels
   before K6's, K1's and K2's redesign, controls/fdn_tf_prev/
   fdn_kernels.cu, K3f and K3b before theirs (N = 3, 5 and 6; the
   package's fdn_kernels too at N = 3 and 5), controls/sos_kernels_prev/
   sos_kernels.cu, K4f and K4b before theirs, controls/aa_kernels_prev/
   aa_kernels.cu, K8 and K9 before K9 'highest''s, and
   controls/phase2_micro_prev/phase2_micro.cu, K10's four variants before
   their redesign (phase 5's controls), and prints the build time and
   each library's own seconds; with --ptxas
   it compiles them all with nvcc's register report (written to
   build/ptxas_smoke.txt) and prints the registers, spills and
   register-bound warps an SM of each K1, K2, K3f, K3b, K4f, K4b, K5, K6,
   K7, K9 and K10 instantiation, the previous libraries' too;
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (M = 48001 bins, N = 6, |D| = 0.85, orthogonal U; K2
   also equal to the previous K2 bit for bit, both ways, on those
   operands and on k2_systems (random, pivoting at every step, tied
   pivots, a cycle) at M = 33, 4097 and 48001, the exact tied ones also to
   the plain version, each set's pivot-vote share printed; K3f and K3b
   equal to the previous K3f and K3b bit for bit on the main path's
   operands and on k3_systems (k2_systems with gains b and c) at the same
   bin counts and N = 3, 5 and 6, each set also within VAL_TOL/GRAD_TOL of
   the plain version, the exact tied systems' y to the plain version on
   the CPU bit for bit, each set's pivot-vote share printed, and K1's four
   variants (whose cotangents share fdn_ge.cuh with K3b's) equal to that
   library's K1 bit for bit; K = 12
   sections of P = 3 taps, random well-conditioned ones and those of the
   attenuated FDN's GEQ, and K4f/K4b also at 25 channels, on random taps
   and on a 5 x 5 GEQ's, K4b launched twice with equal results; K6 on
   dense systems at M = 48001 and at the
   masked step's P = 2000 bins, random well-conditioned ones and the
   scattering FDN's own loop matrices, and 2000 tied-pivot systems, whose
   exact ones must equal the plain version bit for bit; K1's training
   variant launched twice with equal results); the Durand-Kerner roots K7 at
   B = 1601 polynomials of degree 4 and 8, the active-acoustics steps K8
   (pivot on and off) and K9 (pivot on and off, bin offset 0 and 24000;
   its tensor-core kernel at precision 'high' and 'default', its FP32
   kernel at 'highest', each against the plain version of its precision,
   'default''s tap cotangent held to 1.5 times the plain version's own
   spread and, elementwise, to twice one TF32 pass's forward-error bound
   on its operands' magnitudes, 'high' and 'default' equal to the
   previous library's bit for
   bit, and each TF32 mode's distance from 'highest' printed) at
   M = 48001, N = 4 microphones, L = 13 loudspeakers, 100 taps, on the
   magnitude rig's own rows; K5 in all eight (pivot, with_dbar,
   fuse_taps) variants, its training variant launched twice with equal
   results, and K7's bit-identity with its plain version printed; the
   four variants of the phase-2
   micro-benchmark K10 at its published sizes (nfft = 96000, P = 3, K = 12, N = 6, 48128 bins), on
   its own operands (t of ones) and on a seeded random t, each variant's
   previous kernel's distance from the plain version printed;
3. the colorless slice at full width: build_colorless_fdn(nfft=96000) on
   the card; the graph loss through K2 against the 'ge' solve, the fused
   frequency response (K3f) against Shell.get_freq_response, the
   gradients of the fused-tf loss (K3b) against the graph gradients;
   FUSED_TF_STEPS Adam steps of colorless_train_step(fused_tf=True) from
   the graph model's weights (K3f and K3b once each a step, checked; its
   first loss equals the graph loss to 1e-4, its loss falls) and
   FUSED_EVALS calls of colorless_freq_response_fused under no_grad (K3f
   once a call, checked; the response equals get_freq_response to 1e-5),
   both timed, after a warm-up; and colorless_fit (K1, no pivot) for
   FIT_STEPS steps, timed; K1-K3 must have been launched in this phase;
4. the attenuated slice at full width: build_attenuated_fdn(nfft=96000,
   octave_interval=1, cache_delays=True) on the card; the graph loss and
   gradients of the 'xla'/'ge' route (plain cascade and elimination)
   against the 'pallas'/'pallas' route (K4f + K2, backward K4b + K2
   transposed) and the fused step (K5), then ATT_STEPS Adam steps of
   attenuated_train_step(fused_step=True) (K5, no pivot) and
   ATT_GRAPH_STEPS of attenuated_train_step on the 'pallas'/'pallas' model
   (bench.py's mode='pallas': K4f, K2, K2 transposed and K4b once each a
   step, checked; its first loss equals the graph loss to 1e-5, its loss
   falls), both timed; K2's pivot-vote share on the graph step's own
   operands, forward and transposed, is printed; K2, K4f, K4b and K5
   must have been launched in this phase;
4b. the scattering slice at full width: build_colorless_sfdn(nfft=96000,
   solve_method='pallas') on the card; the graph loss and gradients
   through K6 against the 'ge' route at the same mask, the masked loss
   through K6 (the loop solved at the mask's 2000 bins only) against the
   graph loss and against 'ge_cached', then sfdn_fit(masked=True,
   solve_method='pallas') for SFDN_FIT_STEPS steps and sfdn_train_step
   (the graph step) for SFDN_GRAPH_STEPS steps, both timed; K6 must have
   been launched forward and transposed at both shapes in this phase;
4c. the active-acoustics magnitude path at full width:
   build_active_acoustics(4 x 13, 15000-tap WGN room, 100-tap mixer,
   nfft=96000, solve_method='ge_cached') on the card; the graph loss, then
   AA_K9_STEPS Adam steps of aa_fused_taps_step (K9) at each precision
   (the default 'high' and 'default' on the tensor-core kernel, 'highest'
   on the FP32 one) and AA_K8_STEPS of aa_fused_step (K8) from the same
   weights, timed: each first loss equals the graph loss (1e-4; 1e-3
   for 'default') and its plain version's (1e-5), each loss falls, one
   launch of the run's kernel per step;
4d. the active-acoustics eigenvalue path at full width:
   ActiveAcoustics(1, 4, 13, 1, FIR_order=100, rir_length=15000,
   wgn_RT=1.0, room_t60=0.5, nfft=96000) on the card (its constructor's
   GBI runs torch.linalg.eigvals on (48001, 4, 4)); mse_evs on the F_MM
   graph at the first of its 1601-bin partitions, then aa_evs_fit over the
   same partitions for AA_EVS_STEPS steps, timed: the first loss equals
   mse_evs's, the quarter means fall, K7 once per step; K7 against its
   plain version on the char-polys the first step handed it;
4e. the phase-2 micro-benchmark: bench_phase2_micro.run for each of the
   four K10 variants on the card (best of three windows of 50 calls, CUDA
   events), its lines printed; each variant's value must equal its phase-2
   kernel value on the same operands, and its kernel must have been
   launched in the run;
4f. the Trainer path (the paved road): the e8 colorless flow through
   load_dataset and Trainer (fused gate to K1, one epoch, fit_scan), the
   attenuated Trainer through K5, the scattering Trainer's masked step
   against its K6 graph route, the graph route through K2 and a
   checkpoint round trip;
4g. the e8_fdn path: flamo_tpu_torch/examples/e8_fdn.py's 'fdn' and
   'direct' models at full width (nfft=96000, delays 593..1699, 30 dB
   alias decay undone by iFFTAntiAlias, the direct one a Parallel beside
   a clip-mapped gain), each built on 'xla'/'ge' and on 'pallas'/'pallas'
   from one seed: the 'pallas' build's first loss (mss_loss + sparsity)
   equals the 'xla' build's to 1e-5 and its gradients to 3e-4 of the max
   (K4f, K4b once and K2 twice); one epoch of Trainer.train(scan=True) on
   the 'pallas' model (16 items, batches of 2, split 0.8: 6 train and 2
   valid steps), K4f once a step, K4b and K2 transposed once a train
   step, K2 once a step, exactly, no fused path taken, the loss falling,
   its IRs finite and written to build/e8_fdn/; then E8_STEPS timed
   Trainer.fit_scan steps a scenario (CUDA events, after 3);
4h. the filter zoo: the e7 examples' scenarios (ZOO: e7_biquad's 2 x 1
   two-section highpass Biquad and its 2-channel parallelBiquad, e7_peq's
   2 x 1 six-band PEQ and parallelPEQ in both designs, e7_svf's 2 x 1
   four-section SVF and parallelSVF) at nfft=96000, each built on 'xla'
   and 'pallas' from one seed: the 'pallas' build's first loss (PlainMSE
   on the |.| Shell against the example's target) equals the 'xla'
   build's to 1e-5 and its gradient to 1e-4 of the max (K4f and K4b
   once); one epoch of the e7 Trainer (16 items, batches of 2, split
   0.8: 6 train and 2 valid steps), K4f once a step and K4b once a train
   step, exactly, no fused path, the loss falling; ZOO_STEPS
   Trainer.fit_scan steps, then ZOO_STEPS timed (CUDA events), K4f and
   K4b once each a step; e10's three response paths at nfft=96000 within
   5e-3 of each other (the probe batched by torch.func.vmap); and
   ZOO_NN_STEPS Adam steps of e7_biquad_nn's MLP on a 'pallas' Biquad
   through ext_param, K4f and K4b once each a step, the loss falling;
4i. the accurate GEQ, velvet noise and the tutorial examples at nfft=96000:
   e7_geq's 'geq' (a 2 x 1 GEQ) and 'parallel_geq' (2 channels), octave
   bands, 30 dB alias decay, trained toward the example's accurate-GEQ
   target, as phase 4h's scenarios (GEQ_ZOO: first loss 1e-5, gradient
   1e-4 of the max; one epoch with K4f once a step
   and K4b once a train step; ZOO_STEPS fit_scan steps); e7_geq's
   'accurate_geq' and 'accurate_parallel_geq' (the non-trainable
   AccurateGEQ assigned the target gains) on 'xla' and 'pallas' from one
   seed: |response()| of the routes within 1e-4 of the max (else each
   held to a float64 evaluation of the same taps, 'pallas' within 2x
   'xla''s distance), each route within the example's own 1e-2 gate of
   its float64 numpy design, K4f twice (the response and the check) and
   K4b never; e4_recursion_nn's comb_nn (delays 151, 211, 239, 317, a
   4 x 4 one-section LossyBiquad in the feedback, MLP hidden (128, 64),
   16 items in batches of 4, each item through the comb in turn) on
   'xla'/'ge' and 'pallas' (K4, K6) from one seed: first loss 1e-5, MLP
   gradients 3e-4 of the max, one epoch with K4f, K4b, K6 and K6
   transposed once each an item, the loss over the targets falling, then
   COMB_STEPS timed steps (CUDA events, after 3); gains_nn's GAINS_STEPS
   Adam steps (its loop, delays against a parallelGain, declines the
   FDN split: K6 once each way a step, never K2); e6's two IRs (alias
   decay 0 and 30 dB) on 'pallas' (K2 once each) against 'ge' within
   1e-5 of the max, and the example's pre-onset energy check; a velvet
   scattering loop (parallelDelay(8) against VelvetNoiseMatrix((4, 8,
   8))) on 'pallas' (K6 once) against 'ge' within 1e-5 of the max;
4j. the reverb domain at nfft=96000: HomogeneousFDN at its config's
   defaults (N = 6, delays drawn from SEED in 20-50 ms) on 'pallas' (K2)
   against 'ge', |H| within 1e-5 of the max, normalize_energy's own check
   passing on both; e8_fdn's accurate_geq scenario on 'pallas' through
   the example (its attenuation's |H| within 1e-4 of the max of an 'xla'
   build's, else the float64 rule; RT MSE below 0.01); e8_fdn's
   delay_scaled FDN (N = 4, 30 dB) with each of the four attenuations
   built on 'xla' and 'pallas' from one seed: first loss within 1e-5, one
   epoch of Trainer.fit_scan_epochs on 'pallas' (K2 once and once
   transposed a step, the accurate GEQ K4f twice a step), the loss
   falling, then DS_STEPS timed fit_scan steps of the 'geq' model; e9's
   profile and surface on 'pallas' against 'ge' within 1e-5 of the max
   (K2 once a scanned point); the delay-scaled accurate GEQ at 1/3 and 1
   octave on HomogeneousFDN's delays through K4f (once), finite at every
   bin and within 5e-3 of the max of a float64 evaluation of its taps,
   against its plain version at the GEQ bound;
4k. the multi-device layer at nfft=96000 (flamo_tpu_torch/parallel,
   flamo_tpu_torch/scripts/shard_smoke.py, started in a child process):
   the card's compute mode printed (Exclusive_Process cannot hold two
   ranks: the phase fails), then two gloo ranks on cuda:0 run each
   sharded step for 3 steps in lockstep with the unsharded step of the
   same model from one seed: the colorless FDN on K1, the attenuated FDN
   on K5 and the 4 x 13 active-acoustics rig on K9 'high' (both with the
   block's first bin as bin_offset, nonzero on rank 1), its eigenvalue
   step on K7 over 1601-bin partitions (phase 4d's rig, its gain before
   instability handed over) and .multi, the scattering FDN's masked step
   on 2000 bins through K6 both ways, make_dp_train_step on the colorless
   model with a batch of 4, bin_sharded_forward on 'pallas' (K2) with
   shard_spectrum, and a 4-seed MultiSeedEnsemble on a 2-rank 'seed'
   mesh (10 steps, vmap); four ranks run make_seed_bins_sharded_fused_step
   on a 2 x 2 mesh.  Gates (the JAX package's tests/test_parallel.py):
   loss 1e-5 relative (evs 1e-4), parameters after the steps and the
   first step's gradients 1e-5 of the max on K1, 1e-4 on K5, K9 and K7,
   allclose(1e-4, 1e-6) for dp and the masked step, the forward 1e-5,
   parameters identical across ranks, each rank's kernel launched once a
   step (K6 once each way), the ensemble's losses falling and each member
   within 1e-5 of its run alone; the ms a step of each sharded and
   unsharded step (CUDA events, ranks sharing the card: not scaling
   figures) printed.  Then eigvals_qr and eigvals_qr_grad at 1600 x 16 x
   16 and 16 x 64 x 64 complex64 against torch.linalg.eigvals (sets 1e-4;
   a sorted-magnitude MSE's loss 1e-4 and gradient 5e-3 of the max), each
   call's ms printed beside the library's;
4l. K1, K2 and K6 past 16 channels (flamo_tpu_torch/csrc/fdn_loop.cu, one
   warp a bin, N at run time): each looped kernel against its plain
   version at M = 48001 for N = 17, 32 and 64 (K2 and K6 both ways, K1's
   four variants; K2 also on k2_systems, pivoting at every step, tied and
   cyclic, the tied systems whose elimination leaves a diagonal equal bit
   for bit), and against the unrolled kernels at N = 16 on the same
   operands (that library built on a thread beside phases 1-4k), the gaps
   printed; K2 looped runs on fdn_reg.cu's register-resident kernel from
   17 to 64 channels (a bin's rows in registers) and on fdn_loop.cu's
   above, so K2 is also held so at 33, 48 and 65 channels (at 65, on the
   shared-memory kernel, a k2_systems result past float32 is held to a
   complex128 solve, k2_twin_check), every launch on the kernel of its
   size's range (reg_launch_check); HomogeneousFDN at 32 and 64 channels
   (nfft=96000, delays drawn from SEED in 20-50 ms) on 'pallas' (K2 looped) against 'ge': |H|
   1e-5 of the max, then LOOP_STEPS Adam steps of mse(model(impulse), a
   decaying noise IR) in lockstep (losses 1e-5, first gradients 1e-4);
   a 32-channel colorless FDN: colorless_fit (K1 looped) against its
   graph loss on 'ge' (1e-4), and the Trainer's gate taking
   colorless_fused_step; a 32-channel loop whose feedforward is
   Series(parallelDelay, Matrix) on 'pallas' (K6 looped both ways)
   against 'ge' in lockstep; every launch counted exactly;
4m. K3f, K3b and K5 past 16 channels (the same looped library), at 32
   and 64 channels (nfft=96000, delays hfdn_delays(N), 967..2411): the
   colorless FDN's fused response (K3f looped) against
   get_freq_response (1e-5 of the max) and LOOP_STEPS Adam steps of
   colorless_train_step(fused_tf=True) (K3f and K3b looped once each a
   step) in lockstep with its graph step on 'ge'; the attenuated FDN's
   LOOP_STEPS steps of attenuated_train_step(fused_step=True) (K5 looped,
   no pivot) in lockstep with its graph step on 'ge', then a Trainer
   whose gate takes attenuated_fused_step (K5 once) and
   TFSOS_TRAINER_STEPS fit_scan steps (K5 once a step); the fused routes
   held to the graph at phases 3's and 4's gates (losses 1e-4, first
   gradients 5e-3 of the max); one K5 call at 64 channels on the
   attenuated FDN with a 1/3-octave GEQ (K = 30, four bins a block of
   the register-resident kernel) against its plain version; every launch
   counted exactly, K3f, K3b and K5 on fdn_reg.cu's kernels at 32 and 64
   (their shared-memory keys never counted, reg_launch_check);
4n. K8 and K9 past 8 microphones (flamo_tpu_torch/csrc/aa_loop.cu, one
   warp a bin, N at run time): phase 4c's rig (13 loudspeakers,
   15000-tap rooms, a 100-tap mixer, nfft=96000, 'ge_cached') at 16 and
   32 microphones, the graph loss, then AA_LOOP_STEPS Adam steps (lr
   1e-4) from the same weights through K9 looped at 'high', 'default' and 'highest' and
   through K8 looped: each first loss against its plain version (1e-5)
   and the graph (phase 4c's STEP_GRAPH_TOL; 'default' also no farther
   than its plain version, plus 1e-5), the losses falling, the
   looped kernel launched once a step and the unrolled ones never; at 16
   microphones one K9 'high' call at bin_offset 24000 against its plain
   version;
5. timing of each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, beside the kernel's bound (for
   K10 also the work of its passes counted as K5's distinct sections; K9
   at each precision, its FP32 and tensor-core kernels in the same run),
   and K5's training variant and K7 against their aims, with K7's
   time at 0 and 1 iterations (its fixed cost and an iteration's); K1-K4
   and K6 also on one bin or row (``floor_ms``: one block and one bin's
   chain, the least a launch of that kernel takes), and K1 (all four
   variants), K3b, K4f, K4b and K6 (both shapes, each way) beside the
   previous libraries' kernels on the same operands (``previous_ms``;
   previous, new, new, previous, each pair averaged), K4f, K4b, K6 at
   P = 2000 and K1 against their aims and K6 at M = 48001 against 1.05x
   the previous kernel; K9 'highest', K2 both ways (also on the graph
   step's own operands), K3f and K3b beside the previous libraries' in
   turns, and on one tile of 64 bins or one bin, the previous kernels'
   too, their aims printed and each held to PREVIOUS_GATE = 1.05x its
   previous kernel; K10's four variants likewise, beside the previous
   library's kernels and on one bin, with each K10 kernel's registers and
   local (spill) bytes read from the card;
5l. each looped kernel's device and call ms at M = 48001, its plain
   version's (CUDA events), torch.linalg.solve's on the same systems (K2,
   K6) and its bound, at 32 and 64 channels (K1's four variants too);
   K2 (fdn_reg.cu) beside fdn_loop.cu's shared-memory K2 in turns
   (previous_ms), with the warps resident on an SM of both
   (cudaOccupancyMaxActiveBlocksPerMultiprocessor), held to
   PREVIOUS_GATE; after phase 5, whose traces came back one launch short
   once 10-30 ms kernels had been traced;
5m. the looped K3f, K3b and K5 against their plain versions at
   M = 48001 for N = 17, 32 and 64 (values 1e-5, cotangents 1e-4 of the
   max; K5 in its four fused variants, without fused taps through K4b,
   and at bin_offset 24001 both ways), K3f's y on the exact tied systems
   of k3_systems bit for bit, K3f and K3b on the others, and against the
   unrolled kernels at N = 16 (fdn_kernels and sos_kernels at 16 built on
   a thread beside phases 1-4k), the gaps printed; K3f and K3b also so at
   33, 48 and 65 channels (k3_loop_checks), and K5 in all eight variants,
   at bin_offset 24001 and at K = 30 for N = 17, 32, 33, 48, 64
   (fdn_reg.cu) and 65 (fdn_loop.cu), reg_k5_checks, every launch on the
   kernel of its size's range (reg_launch_check); then each looped
   kernel's device and call ms, its plain version's (CUDA events) and its
   bound at 32 and 64 channels (K5 the training variant: no pivot, no
   D_bar, fused taps, K = 12, P = 3), each beside fdn_loop.cu's
   shared-memory kernel in turns, with both kernels' resident warps, held
   to PREVIOUS_GATE;
5n. the looped K8 and K9 on the rigs' own rows at M = 48001 for 9, 16 and
   32 microphones against their plain versions (both pivot modes, K9 at
   every precision: the loss 1e-5, S and the tap cotangent 1e-4 of the
   max, 'default''s tap cotangent by phase 2's one-pass TF32 bounds),
   and against the unrolled kernels at 8 microphones, the gaps printed;
   then each looped kernel's device and call ms, its plain version's
   (CUDA events) and its bound at 16 and 32 microphones (the no-pivot
   variant the fused steps run);
6. torch.profiler traces of a few training steps of each path (and of a
   few fused responses): the device's busy and idle share and the
   kernels that take its time (for the attenuated graph step and the
   e8_fdn steps also K4f's, K4b's and K2's share and the cuBLAS GEMMs',
   for an e7 step K4f's and K4b's,
   for the fused-tf step K3f's and K3b's, for the fused response K3f's,
   for the comb_nn step K4f's, K4b's and K6's, for the delay_scaled step
   K2's, for the K9 steps K9's), and the MSS loss alone, its GEMMs named;
7. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` as
   the last line.

``ms``, ``plain_ms`` and ``library_ms`` are all device time per call from
torch.profiler: the sum over every operation the call runs on the card;
K7's library call (torch.linalg.eigvals, mostly off the device) is timed
by CUDA events only (``library_ms_by``).  Where the profiler came back
without a kernel in every one of its traces, ``ms`` is that call's time
by CUDA events and ``ms_by`` says so (beside a previous kernel, both are
then timed so).
The whole call, host side included (checks, allocation, launches, the
partials sum), is timed with CUDA events beside each of them as
``call_ms``, ``plain_call_ms`` and ``library_call_ms``.  ``launches``
counts each kernel's launches on the main paths, the counts set to 0 just
before each run and read just after it: K1 in the timed colorless_fit, K5
in the timed attenuated steps, K6 in the timed sfdn_train_step (M = 48001,
the rows without a suffix) and sfdn_fit(masked=True) (P = 2000, the
``@P2000`` rows), K9 and K8 in the timed active-acoustics magnitude steps
and K7 in the timed aa_evs_fit, each once per step (K6 once each way; K9
at each precision in its own run: ``aa_taps_tf_mse`` is the FP32 kernel
at 'highest', ``aa_taps_tf_mse_tc_high`` and ``aa_taps_tf_mse_tc_default``
the tensor-core kernel at 3 and 1 TF32 passes); K4f and K4b in the
timed graph steps of phase 4 (once each per step), K2 there (twice per
step) and in the graph-route calls of phases 3 and 4, all three also in
phase 4g's epochs and timed steps (K4f once a step, K4b once a train
step, K2 once a step and once more a train step), K4f and K4b also in
phase 4h's epochs, fit_scan steps, timed steps and ext_param steps (K4f
once a step, K4b once a train step), and all of them in phase 4i: K4f
and K4b in e7_geq's epochs and fit_scan steps as in phase 4h, K4f twice
an accurate scenario on 'pallas' and K4b never there, K4f, K4b, K6 and
K6 transposed once each an item of comb_nn's epoch and timed steps, K6
once each way a gains_nn step, K2 once an e6 IR and K6 once for the
velvet loop; K2 and K4f in phase 4j: K2 three times for HomogeneousFDN,
once a first loss and twice a train step of delay_scaled, once a
scanned point of e9 and once for the accurate scenario's IR, K4f twice
for the accurate scenario, twice a step of the delay_scaled accurate
GEQ and once a 1/3- or 1-octave response; K1, K2, K5, K6 (at the masked
step's rows), K7 and K9 'high' in phase 4k, summed over the ranks: once a
rank and a lockstep step (K6 once each way), K2 once a rank for the
sharded forward and K7 twice a rank for .multi; K3f and K3b in
phase 3's timed fused-tf steps (once each per step) and K3f also in its
timed fused responses (once per call); the K10 variants in phase 4e's
bench_phase2_micro.run (151 calls each); the looped kernels in phase 4l's
paths, a row for each channel count (``<kernel>@N32``, ``@N64``): K2
looped once for each HomogeneousFDN's response and once each way an Adam
step, K1 looped once a colorless_fit step, once in the Trainer's gate and
once a fit_scan step, K6 looped once each way a step of the dense loop
(K6's and K1's times at 64 channels, where no path runs them, under
``at_n64``); K3f, K3b and K5 looped in phase 4m's paths, a row for each
channel count: K3f looped once for the fused response and once a
fused-tf step, K3b looped once a fused-tf step, K5 looped once an
attenuated fused step, once in the Trainer's gate and once a fit_scan
step, and at 64 channels once more for the 1/3-octave call; K8 and K9
looped in phase 4n's steps, a row for each microphone count
(``<kernel>_loop@N16``, ``@N32``), once a step.  ``trace_retries``
counts a row's profiler traces that were taken again because they held
none of its kernel.

TF32 is off throughout: expm's matmuls and the references stay float32.
Only K9's tensor-core kernel uses TF32, inside the kernel, for its own two
contractions at precision 'high' and 'default'.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from flamo_tpu_torch.auxiliary.config import HomogeneousFDNConfig
from flamo_tpu_torch.auxiliary.reverb import (HomogeneousFDN,
                                              coprime_delay_lengths,
                                              parallelFDNAccurateGEQ)
from flamo_tpu_torch.convert import jax_named_tensors, load_jax_scattering
from flamo_tpu_torch.core import masked_optimizer
from flamo_tpu_torch.examples import (e4_recursion_nn, e6_anti_aliasing,
                                      e7_biquad, e7_biquad_nn, e7_geq,
                                      e7_peq, e7_svf, e8_fdn, e9_loss_profile,
                                      e10_probe)
from flamo_tpu_torch.examples._common import (PlainMSE, filter_shell,
                                              filter_trainer)
from flamo_tpu_torch.functional import (charpoly, eigvals_qr,
                                        eigvals_qr_grad, expm_skew)
from flamo_tpu_torch.models import (ActiveAcoustics, aa_dft_basis,
                                    aa_evs_fit, aa_evs_train_step,
                                    aa_fused_operands,
                                    aa_fused_step, aa_fused_taps_step,
                                    attenuated_loss, build_active_acoustics,
                                    attenuated_loss_fused_step,
                                    attenuated_train_step,
                                    build_attenuated_fdn, build_colorless_fdn,
                                    build_colorless_sfdn, colorless_fit,
                                    colorless_freq_response_fused,
                                    colorless_loss, colorless_loss_fused_tf,
                                    colorless_train_step,
                                    extract_attenuated_operands, sfdn_fit,
                                    sfdn_masked_loss, sfdn_masked_train_step,
                                    sfdn_train_step)
from flamo_tpu_torch.models.active_acoustics import _mixer_taps
from flamo_tpu_torch.ops import aa_kernels as ak
from flamo_tpu_torch.ops import cuda_build
from flamo_tpu_torch.ops import eig_kernels as ek
from flamo_tpu_torch.ops import fdn_kernels as fk
from flamo_tpu_torch.ops import phase2_micro as pm
from flamo_tpu_torch.ops import sos_kernels as sk
# the colorless objective's (1, M, 1) impulse and flat target on the
# model's device
from flamo_tpu_torch.models.colorless_fdn import (
    extract_siso_tf_operands, impulse_pair as colorless_pair)
from flamo_tpu_torch.optimize import (Dataset, DatasetColorless, Trainer,
                                      load_dataset, load_model_state,
                                      masked_mse_loss, mse_evs, mse_loss,
                                      mss_loss, save_model_state,
                                      sparsity_loss, stack_loader)
from flamo_tpu_torch.processor import dsp, system
from flamo_tpu_torch.scripts import bench_phase2_micro as p2bench
from flamo_tpu_torch.scripts import shard_smoke
from flamo_tpu_torch.utils import set_seed

M_MAIN, N_MAIN, NFFT = 48001, 6, 96000
K_MAIN, P_MAIN = 12, 3  # GEQ sections (octave bands + 3) and SOS taps
SEED = 0
# with --ptxas the libraries are built with nvcc's register report here
PTXAS_LOG = Path("build/ptxas_smoke.txt")
FIT_STEPS = 100
ATT_STEPS = 100
ATT_GRAPH_STEPS = 100  # the graph step through K4 and K2
ATT_LR = 1e-4
GEQ25 = (5, 5)  # a full GEQ whose 25 channels fold into K4's channel axis
SFDN_SAMPLES = 2000  # bins per masked step (the masked_mse mask)
SFDN_FIT_STEPS = 200
SFDN_GRAPH_STEPS = 20
# the active-acoustics rig (bench.py's): 4 mics x 13 loudspeakers, a
# 15000-tap room, a 100-tap mixer; the eigenvalue step reads 1601 bins
AA_N, AA_L, AA_ORDER, AA_RIR = 4, 13, 100, 15000
AA_LR = 1e-3
AA_K9_STEPS, AA_K8_STEPS, AA_EVS_STEPS = 100, 50, 100
AA_ITER_NUM, AA_TARGET = 30, 0.3
AA_OFFSET = 24000  # K9 on bins 24000.. as a shard at its global bins
DK_B, DK_ITERS = 1601, 96
# the aims of the kernels redesigned last (device ms, printed, not gated)
# and the gate against the previous kernel in the same call
K9_HIGHEST_AIM, K2_AIM, PREVIOUS_GATE = 0.100, 0.0038, 1.05
K3F_AIM, K3B_AIM = 0.0040, 0.0050
# K10's variants and their aims (device ms), and ps's stretch
K10_AIMS = {"full": 0.005, "noreduce": 0.0040, "lanered": 0.0050,
            "ps": 0.010}
K10_PS_STRETCH = 0.005
K2_RAGGED = (33, 4097, M_MAIN)  # phase 2's bin counts for K2's and K3's
K3_NS = (3, 5, N_MAIN)  # K3's channel counts in phase 2: odd N moves float2s
# phase 3's timed fused-tf steps and fused responses
FUSED_TF_STEPS, FUSED_EVALS = 100, 200
# phase 4f, the paved road: the e8 dataset's size, fit_scan's steps and
# chunk, the attenuated Trainer's steps, the scattering lockstep's steps,
# the graph route's steps, and the timed Trainer.train_step calls
PAVED_EXPAND, PAVED_SCAN_STEPS, PAVED_SCAN_CALL = 64, 100, 50
PAVED_ATT_STEPS, PAVED_SFDN_STEPS, PAVED_GRAPH_STEPS = 50, 5, 20
PAVED_TRAIN_STEPS = 100
# phase 4g, the e8_fdn path: the example's dataset (expand, batch, split)
# and the timed Trainer.fit_scan steps a scenario
E8_EXPAND, E8_BATCH, E8_SPLIT, E8_STEPS = 16, 2, 0.8, 20
# the 'pallas' route's first loss against the 'xla' route's, as phase 4's
# graph routes; its gradients relative to the max: the 12-section octave
# cascade in float32 puts K4 and the plain cascade 5e-5-6e-5 of the max
# apart on the GEQ gains on the H100 (the other leaves ~1e-7)
E8_LOSS_TOL, E8_GRAD_TOL = 1e-5, 3e-4
# phase 4h, the filter zoo: the e7 examples' dataset (expand, batch,
# split), the timed Trainer.fit_scan steps a scenario and e7_biquad_nn's
# ext_param steps; the 'pallas' route against 'xla' from one seed as
# tests/test_ops.py holds the JAX package's two routes: first loss 1e-5
# relative, gradients 1e-4 of the max
ZOO_EXPAND, ZOO_BATCH, ZOO_SPLIT, ZOO_STEPS, ZOO_NN_STEPS = 16, 2, 0.8, 20, 20
ZOO_LOSS_TOL, ZOO_GRAD_TOL = 1e-5, 1e-4
# The PEQ's 'svf' design is ill-conditioned in float32: its 20 Hz shelf
# puts a double pole within tan(pi 20 / 48000) = 1.3e-3 of z = 1, where
# A(z) cancels to ~1e-5 of its taps, so float32's rounding near DC moves
# the loss by ~5e-4 and the gradient by ~1.2e-3 of its max from a float64
# twin (the plain cascade at nfft = 96000, on the CPU), and K4 and the
# plain cascade round there differently (the first loss 4.2e-5 apart on
# the H100).  Those scenarios are held to the float64 twin instead: the
# 'pallas' build's distance from it (loss and gradient) at most
# ZOO_ILL_FACTOR times the 'xla' build's own.
ZOO_ILL = ("peq_svf", "parallel_peq_svf")
ZOO_ILL_FACTOR = 2.0
# scenario: (example, its scenario function, that function's arguments,
# the example's learning rate); e7_biquad's and e7_svf's two scenarios,
# e7_peq's two in both designs
ZOO = {
    "biquad": (e7_biquad, "scenario_biquad", {}, 1e-2),
    "parallel_biquad": (e7_biquad, "scenario_parallel_biquad", {}, 1e-2),
    **{f"{s}_{d}": (e7_peq, f"scenario_{s}", {"design": d}, 1e-2)
       for s in ("peq", "parallel_peq") for d in ("biquad", "svf")},
    "svf": (e7_svf, "scenario_svf", {}, 5e-2),
    "parallel_svf": (e7_svf, "scenario_parallel_svf", {}, 5e-2),
}
# phase 4i, the accurate GEQ, velvet noise and the tutorial examples:
# e7_geq's two trained scenarios run as phase 4h's (zoo_scenario) and
# with its gates; the accurate designs' |H| on 'pallas' against 'xla' by
# e8_fdn's rule, check_accurate_routes (1e-4 of the max, else both held
# to a float64 evaluation of the same taps, 'pallas' within 2x the 'xla'
# distance, as ZOO_ILL) and each route within the example's own
# ACCURATE_TOL of its target; e4_recursion_nn's comb_nn (COMB_ITEMS items
# in batches of COMB_BATCH, each item through K4f and K6 in turn) first
# loss 1e-5 and MLP gradients 3e-4 of the max, one epoch, COMB_STEPS
# timed steps; gains_nn's GAINS_STEPS Adam steps; e6's two IRs and a
# velvet scattering loop on 'pallas' against 'ge' at 1e-5 of the max
GEQ_ZOO = {
    "geq": (e7_geq, "scenario_geq", {}, 5e-2),
    "parallel_geq": (e7_geq, "scenario_parallel_geq", {}, 5e-2),
}
ACC_ROUTE_TOL = e8_fdn.ACC_ROUTE_TOL
COMB_ITEMS, COMB_BATCH, COMB_STEPS = 16, 4, 20
COMB_LOSS_TOL, COMB_GRAD_TOL = 1e-5, 3e-4
GAINS_STEPS = 10
E6_TOL, VELVET_TOL = 1e-5, 1e-5
VELVET_N, VELVET_STAGES, VELVET_MAX_DELAY = 8, 4, 2000
# phase 4j, the reverb domain: HomogeneousFDNConfig's defaults (N = 6,
# nfft = 96000) with delays drawn from SEED in 20-50 ms; its 'pallas'
# response (K2) against 'ge', e9's scans likewise, the e8_fdn
# delay_scaled models' first losses on 'pallas' against 'xla', each at
# 1e-5 of the max; DS_EPOCH_EXPAND items in batches of E8_BATCH for one
# fit_scan_epochs epoch, DS_STEPS timed steps; the delay-scaled accurate
# GEQ at 1/3 octave (30 sections) on those delays through K4f against its
# plain version at the GEQ bound, finite at every bin
HFDN_TOL, E9_TOL, DS_LOSS_TOL = 1e-5, 1e-5, 1e-5
DS_EPOCH_EXPAND, DS_STEPS = 16, 20
K6 = ("dense_solve", "dense_solve_transposed")  # launches counted apart
# phase 4k, the multi-device layer: flamo_tpu_torch.scripts.shard_smoke's
# families, two gloo ranks on cuda:0 (four for seeds x bins), started by a
# child process, so that the ranks re-import that module and not this
# script; SHARD_TIMEOUT seconds a group, SHARD_COLLECTIVE a collective.
# Then the QR eigensolver at bench.py's evs_grad_n16 shape (1600 x 16 x 16)
# and at N = 64 on a batch of 16, against torch.linalg.eigvals as sets and
# through a sorted-magnitude MSE (tests/test_functional.py:622-645)
SHARD_TIMEOUT, SHARD_COLLECTIVE = 300.0, 60.0
SHARD_OUT = Path("build/shard_smoke.json")
QR_SHAPES = ((1600, 16), (16, 64))
QR_SET_TOL, QR_LOSS_TOL, QR_GRAD_TOL = 1e-4, 1e-4, 5e-3
# phase 4l, K1, K2 and K6 past 16 channels (fdn_loop.cu): the looped
# kernels against their plain versions at M_MAIN bins for each of LOOP_NS
# channels (VAL_TOL, GRAD_TOL) and against the unrolled kernels at 16;
# HomogeneousFDN at LOOP_HFDN_NS channels, a colorless FDN and a loop with
# a non-diagonal feedforward (K6) at LOOP_N, each LOOP_STEPS Adam steps at
# LOOP_LR in lockstep with the same model on 'ge' (the plain elimination
# on the card): losses LOOP_LOSS_TOL relative (float32 rounding of two
# pivoted eliminations), colorless_fit's against its graph loss
# FUSED_LOSS_TOL (as phase 3), first gradients GRAD_TOL of the max, |H|
# HFDN_TOL of the max
LOOP_NS = (17, 32, 64)
LOOP_HFDN_NS = (32, 64)
LOOP_N = 32
LOOP_STEPS, LOOP_LR = 3, 1e-3
LOOP_LOSS_TOL = 1e-5
# phase 4m, K3f, K3b and K5 past 16 channels (fdn_loop.cu): at each of
# TFSOS_NS channels (delays hfdn_delays(N)) the colorless FDN's fused-tf
# step and fused response and the attenuated FDN's fused step, LOOP_STEPS
# steps each in lockstep with the same model's graph step on 'ge' (the
# plain elimination and cascade on the card), and the attenuated
# Trainer's gate taking attenuated_fused_step, then TFSOS_TRAINER_STEPS
# fit_scan steps; one K5 call at TFSOS_NS[-1] channels on the attenuated
# FDN with a 1/3-octave GEQ (THIRD_K sections, the shared-memory extreme).
# The fused routes against the graph at phases 3's and 4's gates:
# FUSED_LOSS_TOL on the losses, FUSED_GRAD_TOL on the first gradients
# (phase 4's, the octave GEQ's float32 conditioning).  Phase 5m holds the
# looped K3f, K3b and K5 to their plain versions at M_MAIN bins for each
# of LOOP_NS channels (values VAL_TOL, cotangents GRAD_TOL), K5 also at
# TFSOS_OFFSET, and to the unrolled kernels at 16, then times them at
# TFSOS_NS.
TFSOS_NS = (32, 64)
TFSOS_TRAINER_STEPS = 2
THIRD_K = 30
TFSOS_OFFSET = 24001
# the register-resident K2, K3f, K3b and K5 (fdn_reg.cu, 17..64
# channels): phases 4l and 5m hold them to their plain versions at M_MAIN
# bins at each of REG_NS channels (at LOOP_NS through loop_kernel_checks
# and tfsos_kernel_checks), the last the first count above their range,
# where the shared-memory kernels take over: K2 both ways on
# loop_operands and k2_systems, K3f and K3b on tfsos_operands and
# k3_systems, K5 in all eight variants, at TFSOS_OFFSET and at THIRD_K
# sections; phases 5l and 5m time them at 32 and 64 channels beside the
# shared-memory kernels in turns, each held to PREVIOUS_GATE
REG_NS = (17, 32, 33, 48, 64, 65)
# calls a trace of these kernels and of the previous ones beside them
# (0.5-39 ms a call: 50 took 4 traces each, the profiler a launch short)
REG_REPS = 10
# phase 4n, K8 and K9 past 8 microphones (aa_loop.cu): phase 4c's rig at
# each of AA_LOOP_NS microphones, AA_LOOP_STEPS Adam steps a kernel and
# precision; phase 5n holds the looped kernels to their plain versions on
# the rigs' own rows at AA_LOOP_CHECK_NS microphones, and to the unrolled
# ones at 8
AA_LOOP_NS = (16, 32)
AA_LOOP_CHECK_NS = (9, 16, 32)
AA_LOOP_STEPS = 3
# Adam at AA_LR overshoots the wider rigs (at 32 microphones the second
# loss read 3.2x the first on the H100): they train at shard_smoke's
# aa_lr, which its lockstep takes for the 4-microphone rig's overshoot
AA_LOOP_LR = 1e-4
# At 16 and 32 microphones the rig's loop A = I - H G is ill-conditioned
# at its initial mixer (a loss of 280 against the flat target 1, 41.3 at
# 4 microphones), and float32 rounding alone moves the loss by up to
# 4.2e-5 of itself: the plain version's own distance from a float64 twin
# of the same function (NVIDIA H100 80GB HBM3, 700.00 W), past
# AA_LOSS_TOL.  So phases 4n and 5n hold each looped kernel to the float64
# twin of its function, within AA_LOSS_TOL (the loss) or AA_GRAD_TOL of
# the max (S, the tap cotangent), or within AA_TWIN_FACTOR times the plain
# versions' own distance from it (both eliminations), whichever is
# larger: phase 4h's rule for the ill-conditioned PEQ (ZOO_ILL_FACTOR).
AA_TWIN_FACTOR = ZOO_ILL_FACTOR
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 CUDA-core FLOP/s,
# dense TF32 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
# K9's launch counts and kernels-line rows: the FP32 kernel at 'highest',
# the tensor-core kernel at 'high' (3 TF32 passes) and 'default' (1)
K9_ROWS = {"highest": "aa_taps_tf_mse", "high": "aa_taps_tf_mse_tc_high",
           "default": "aa_taps_tf_mse_tc_default"}
SOURCES = {
    "fdn_tf_mse": "flamo_tpu_torch/csrc/fdn_kernels.cu",
    "fdn_solve": "flamo_tpu_torch/csrc/fdn_kernels.cu",
    "fdn_tf_fwd": "flamo_tpu_torch/csrc/fdn_kernels.cu",
    "fdn_tf_bwd": "flamo_tpu_torch/csrc/fdn_kernels.cu",
    "sos_cascade_fwd": "flamo_tpu_torch/csrc/sos_cascade.cu",
    "sos_cascade_bwd": "flamo_tpu_torch/csrc/sos_cascade.cu",
    "fdn_sos_tf_mse": "flamo_tpu_torch/csrc/sos_kernels.cu",
    "dense_solve": "flamo_tpu_torch/csrc/fdn_kernels.cu",
    "dense_solve_transposed": "flamo_tpu_torch/csrc/fdn_kernels.cu",
    "dk_roots": "flamo_tpu_torch/csrc/eig_kernels.cu",
    "aa_tf_mse": "flamo_tpu_torch/csrc/aa_kernels.cu",
    "aa_taps_tf_mse": "flamo_tpu_torch/csrc/aa_kernels.cu",
    "aa_taps_tf_mse_tc": "flamo_tpu_torch/csrc/aa_kernels.cu",
    **{f"phase2_{v}": "flamo_tpu_torch/csrc/phase2_micro.cu"
       for v in pm.VARIANTS},
    **{name: "flamo_tpu_torch/csrc/fdn_loop.cu" for name in (
        "dense_solve_loop", "dense_solve_loop_transposed",
        "fdn_tf_mse_loop")},
    # K2, K3f, K3b and K5 looped on the register-resident core at 17..64
    # channels
    **{name: "flamo_tpu_torch/csrc/fdn_reg.cu" for name in (
        "fdn_solve_loop", "fdn_solve_loop_transposed", "fdn_tf_fwd_loop",
        "fdn_tf_bwd_loop", "fdn_sos_tf_mse_loop")},
    **{f"{name}_loop": "flamo_tpu_torch/csrc/aa_loop.cu"
       for name in ("aa_tf_mse", *K9_ROWS.values())},
}
REPLACES = {
    "fdn_tf_mse": "flamo_tpu/ops/pallas_solve.py:719",
    "fdn_solve": "flamo_tpu/ops/pallas_solve.py:277",
    "fdn_tf_fwd": "flamo_tpu/ops/pallas_solve.py:451",
    "fdn_tf_bwd": "flamo_tpu/ops/pallas_solve.py:474",
    "sos_cascade_fwd": "flamo_tpu/ops/pallas_solve.py:940",
    "sos_cascade_bwd": "flamo_tpu/ops/pallas_solve.py:957",
    "fdn_sos_tf_mse": "flamo_tpu/ops/pallas_solve.py:1376",
    # K6's one pallas_call, run on A in the forward and on A^T in the VJP
    "dense_solve": "flamo_tpu/ops/pallas_solve.py:161",
    "dense_solve_transposed": "flamo_tpu/ops/pallas_solve.py:161",
    "dk_roots": "flamo_tpu/ops/pallas_eig.py:118",
    "aa_tf_mse": "flamo_tpu/ops/pallas_solve.py:1602",
    "aa_taps_tf_mse": "flamo_tpu/ops/pallas_solve.py:1820",
    # the same pallas_call at precision 'high' and 'default'
    "aa_taps_tf_mse_tc": "flamo_tpu/ops/pallas_solve.py:1820",
    # the micro-benchmark's one pallas_call, one variant of _kernel each
    **{f"phase2_{v}": "scripts/bench_phase2_micro.py:149"
       for v in pm.VARIANTS},
    # the looped kernels replace the same pallas_calls past 16 channels
    "fdn_solve_loop": "flamo_tpu/ops/pallas_solve.py:277",
    "fdn_solve_loop_transposed": "flamo_tpu/ops/pallas_solve.py:277",
    "dense_solve_loop": "flamo_tpu/ops/pallas_solve.py:161",
    "dense_solve_loop_transposed": "flamo_tpu/ops/pallas_solve.py:161",
    "fdn_tf_mse_loop": "flamo_tpu/ops/pallas_solve.py:719",
    "fdn_tf_fwd_loop": "flamo_tpu/ops/pallas_solve.py:451",
    "fdn_tf_bwd_loop": "flamo_tpu/ops/pallas_solve.py:474",
    "fdn_sos_tf_mse_loop": "flamo_tpu/ops/pallas_solve.py:1376",
    "aa_tf_mse_loop": "flamo_tpu/ops/pallas_solve.py:1602",
    **{f"{name}_loop": "flamo_tpu/ops/pallas_solve.py:1820"
       for name in K9_ROWS.values()},
}
# kernel vs plain version on the same inputs.  Per-bin values (tf, y, the
# loss, H) differ only by rounding (FMA contraction, division order, the
# kernels' (2 pi / nfft) m phase against the plain 2 pi m / nfft): 1e-5 of
# the max.  Sums over 48001 bins (U/b/c and tap cotangents) are reduced in
# another order (block trees vs torch.sum): 1e-4 of the max, as are per-bin
# cotangents, which pass through a second elimination.  Those hold for
# well-conditioned taps (poles of radius <= 0.6, numerators near the
# denominators).  The 12-section GEQ cascade is ill-conditioned near DC in
# float32, so on a GEQ's taps the bounds are the JAX package's for its two
# GEQ backends (tests/test_ops.py): 5e-3 on values, 1e-3 on gradients, and
# for K5 its fused-vs-graph bounds: 1e-4 on the loss, 5e-3 on cotangents.
VAL_TOL = 1e-5
GRAD_TOL = 1e-4
GEQ_VAL_TOL, GEQ_GRAD_TOL = 5e-3, 1e-3
FUSED_LOSS_TOL, FUSED_GRAD_TOL = 1e-4, 5e-3
# The scattering FDN's loop I - diag(D) S is close to singular (|D| =
# gamma^m just under 1 against a paraunitary S), so K6 and its plain
# version, whose eliminations differ only by rounding, are held there to
# the JAX package's bound for K6 against its reference (tests/test_ops.py:
# 1e-4 on values) and for K6's gradients (1e-3).  The graph loss of the
# 'pallas' and 'ge' routes differs by the solve only, and so does the
# masked loss of 'pallas' and 'ge_cached': rtol 1e-5, as the JAX package's
# masked-vs-graph lockstep (tests/test_models.py).  The two routes differ
# in their phases: the graph route's delay phase w m, up to 6.6e3 rad at
# nfft = 96000, is a float32 product with up to 2^-24 x 6.6e3 = 3.9e-4 rad
# of rounding, which the near-singular loop amplifies; the masked route
# takes exact integer phases mod nfft (response_at), but rounds a float32
# DFT contraction over ~1.5k taps.  The masked-vs-graph gap (1.12e-4 on
# the H100 at seed 0) is held to 1e-3.  The same losses in float64 (a
# float64 twin of the model, plain solves) agree to 1e-7; each float32
# route's distance to them is printed, not bounded: it measures float32
# itself at this size (~8e-4 on the H100), not the port.
SFDN_VAL_TOL, SFDN_GRAD_TOL = 1e-4, 1e-3
SFDN_LOSS_TOL, SFDN_ROUTE_LOSS_TOL, SFDN_F64_TOL = 1e-5, 1e-3, 1e-7
# K7 against its plain version: the JAX package's kernel-vs-scan bound,
# 1e-4 max abs on the roots (tests/test_ops.py); the library is built
# without FMA contraction and repeats the plain version's arithmetic, so
# the two should agree exactly.  K8 and K9 against their plain versions:
# 1e-5 of the loss (per-bin values, rounding only) and 1e-4 of the max on
# the S rows and the tap cotangent (a second solve; K9's sums over 48001
# bins in another order).  The fused losses against the module graph's,
# and the eigenvalue step's first loss against mse_evs on the F_MM graph:
# 1e-4, the JAX package's bounds (tests/test_ops.py, tests/test_models.py).
# K9's tensor-core kernel is held to the plain version of its precision
# (the same TF32 splits in float32 matmuls) at the same bounds, except
# 'default''s tap cotangent: one TF32 pass rounds S to 11 bits, so the
# plain version differs from itself by more than 1e-4 (2.65e-4 at the
# rig's size, NVIDIA H100 80GB HBM3, 700.00 W) between its two
# eliminations, whose S differ by float32 rounding alone.  That spread is
# measured in the same call, and the kernel's distance must stay under
# DEFAULT_SPREAD_FACTOR of it: 1.0-1.04x when the kernel is right, 2x with
# two k-steps summed in the tensor cores, 150x for the FP32 result.
DK_TOL, AA_LOSS_TOL, AA_GRAD_TOL, AA_GRAPH_TOL = 1e-4, 1e-5, 1e-4, 1e-4
DEFAULT_SPREAD_FACTOR = 1.5
# The fused steps' first losses against the module graph's (FP32): 1e-4,
# and for K9 'default' 1e-3, twice its measured 4.8e-4 (one TF32 rounding
# of G moves the loss by about 2^-11; the H100 above); each is also held
# to the plain version of its precision on the same weights at 1e-5.
STEP_GRAPH_TOL = {"aa_taps_tf_mse": AA_GRAPH_TOL, "aa_tf_mse": AA_GRAPH_TOL,
                  "aa_taps_tf_mse_tc_high": AA_GRAPH_TOL,
                  "aa_taps_tf_mse_tc_default": 1e-3}
# K10 against its plain version: each result is a float32 sum over 48128
# bins and 144 section passes (~7e6 terms of both signs, some large where
# a section's response is small), reduced in another order (warp trees,
# per-warp running sums and torch.sum against torch.sum per section), so
# the gap is held to 1e-5 of the sum of the terms' magnitudes, which the
# plain version computes beside the result; the plain version itself is
# within 1.3e-7 of that scale of a float64 loop on the CPU.  Phase 4e's
# run repeats phase 2's launch on the same operands: its value must be
# identical (no atomics).
P2_TOL = 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def reset_counts() -> None:
    """Set the launch counts of K1-K3, K6 (fk), K4, K5 (sk) and K8, K9 (ak)
    to 0."""
    fk.reset_launch_counts()
    sk.reset_launch_counts()
    ak.reset_launch_counts()


def nonzero_counts() -> dict:
    """The nonzero launch counts of K1-K3, K6 (fk), K4, K5 (sk) and K8, K9
    (ak)."""
    return {k: v for k, v in {**fk.LAUNCHES, **sk.LAUNCHES,
                              **ak.LAUNCHES}.items() if v}


def check_counts(what: str, got: dict, want: dict) -> None:
    """Fail unless ``got`` is ``want``'s nonzero counts, exactly."""
    want = {k: v for k, v in want.items() if v}
    check(got == want, f"{what} should launch {want}, not {got}")


def add_counts(total: dict, counts: dict) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the kernels before their redesign, built in phase 1 beside the package's
# and timed in phase 5 as the control: fdn_kernels.cu before K6's and
# K1's (its K2 is the K2 before its redesign), fdn_kernels.cu before K3f's
# and K3b's, K4f/K4b before theirs, and aa_kernels.cu before K9
# 'highest''s
# ---------------------------------------------------------------------------
CONTROLS = Path(__file__).resolve().parent / "controls"
PREVIOUS_SRC = {"fdn": CONTROLS / "fdn_kernels_prev" / "fdn_kernels.cu",
                "tf": CONTROLS / "fdn_tf_prev" / "fdn_kernels.cu",
                "sos": CONTROLS / "sos_kernels_prev" / "sos_kernels.cu",
                "aa": CONTROLS / "aa_kernels_prev" / "aa_kernels.cu",
                "p2": CONTROLS / "phase2_micro_prev" / "phase2_micro.cu"}
# phase 1's builds: (library, N); the K10 control takes every size
PREVIOUS_BUILDS = (("fdn", N_MAIN), ("sos", N_MAIN), ("aa", AA_N),
                   *(("tf", n) for n in K3_NS), ("p2", 1))


def previous_so(key: str, n: int) -> Path:
    return (cuda_build.BUILD_DIR.parent / "controls"
            / f"lib{PREVIOUS_SRC[key].parent.name}-n{n}.so")


class Previous:
    """The previous libraries' K1, K2 and K6 (fdn_kernels_prev), K3f and
    K3b (fdn_tf_prev), K4f, K4b (sos_kernels_prev), K8, K9
    (aa_kernels_prev) and K10's four variants (phase2_micro_prev, every
    size), each for one N (channels, or microphones): the same
    C entry points as the package's before the redesigns, launched on
    operands the package's wrappers have checked, outputs allocated here,
    nothing counted."""

    def __init__(self, procs: dict, log: Path | None = None):
        self.libs = {}
        for (key, n), proc in procs.items():
            out, _ = proc.communicate()
            check(proc.returncode == 0,
                  f"nvcc failed for {PREVIOUS_SRC[key]} N = {n}:\n{out}")
            if log is not None:
                with log.open("a") as f:
                    f.write(f"# previous {PREVIOUS_SRC[key].parent.name} "
                            f"N = {n}\n"
                            f"{out}")
            lib = ctypes.CDLL(str(previous_so(key, n)))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            if key in ("fdn", "tf"):
                lib.fdn_tf_mse_launch.argtypes = [I] * 3 + [P] * 8 + [F, I, P]
                lib.fdn_dense_solve_launch.argtypes = [I, I, P, P, P, I, P]
                lib.fdn_solve_launch.argtypes = [I, I, P, P, P, P, I, P]
                if key == "tf":
                    lib.fdn_tf_fwd_launch.argtypes = [I] + [P] * 6 + [I, P]
                    lib.fdn_tf_bwd_launch.argtypes = [I] + [P] * 8 + [I, P]
            elif key == "p2":
                lib.p2_launch.argtypes = [I] + [P] * 3 + [I] * 4 + [F, P]
            elif key == "sos":
                lib.sos_cascade_fwd_launch.argtypes = [P] * 3 + [I] * 4 + [
                    F, F, P]
                lib.sos_cascade_bwd_launch.argtypes = [P] * 4 + [I] * 4 + [
                    F, F, P]
            else:
                lib.aa_taps_grid.argtypes = [I] * 6
                lib.aa_taps_tf_mse_launch.argtypes = ([I] * 3 + [P] * 8
                                                      + [F] + [I] * 5
                                                      + [F, I, P])
            self.libs[key, n] = lib
        self.lib = self.libs.get(("fdn", N_MAIN))
        self.sos = self.libs.get(("sos", N_MAIN))

    @staticmethod
    def start(ptxas: bool = False, targets=PREVIOUS_BUILDS) -> dict:
        """One nvcc a (library, N) of ``targets``, all started at once."""
        procs = {}
        for key, n in targets:
            so = previous_so(key, n)
            so.parent.mkdir(parents=True, exist_ok=True)
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                   f"-DFDN_N={n}", "-o", str(so), str(PREVIOUS_SRC[key])]
            if ptxas:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs[key, n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)
        return procs

    @staticmethod
    def _stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def phase2(self, variant: str, t, c, nfft: int):
        """The previous K10 kernel of ``variant``: one thread a bin over
        every one of the 2 K N passes, its rows summed as the package's."""
        lib = self.libs["p2", 1]
        M = t.shape[1]
        rows = -(-M // lib.p2_threads_per_block())
        partials = torch.empty((rows, 3), dtype=torch.float32,
                               device=t.device)
        check(lib.p2_launch(pm.VARIANTS.index(variant), t.data_ptr(),
                            c.data_ptr(), partials.data_ptr(), M,
                            *c.shape, 2.0 * math.pi / nfft,
                            self._stream()) == 0, "previous K10 launch")
        return torch.sum(partials, dim=0)

    def dense_solve(self, A, B, transpose: bool):
        Y = torch.empty_like(B)
        check(self.lib.fdn_dense_solve_launch(
            N_MAIN, int(transpose), A.data_ptr(), B.data_ptr(), Y.data_ptr(),
            B.shape[0], self._stream()) == 0, "previous K6 launch")
        return Y

    def fdn_solve(self, D, U, B, transpose: bool = False):
        """The previous K2 (its library for D's channel count)."""
        N = D.shape[1]
        Y = torch.empty_like(B)
        check(self.libs["fdn", N].fdn_solve_launch(
            N, int(transpose), D.data_ptr(), U.data_ptr(), B.data_ptr(),
            Y.data_ptr(), D.shape[0], self._stream()) == 0,
            "previous K2 launch")
        return Y

    def aa_taps(self, hr, hi, tw, rr, ri, t, N: int, L: int, nfft: int,
                pivot: bool = False, precision: str = "high",
                bin_offset: int = 0):
        """The previous K9 at ``precision`` (its FP32 kernel at 'highest',
        its tensor-core kernel at 'high' and 'default') and the sums of
        its loss row and partials, as its wrapper took them: (loss, tb)."""
        lib, passes = self.libs["aa", N], ak.PASSES[precision]
        M, order = hr.shape[1], tw.shape[0]
        grid = lib.aa_taps_grid(N, int(pivot), passes, order, L, M)
        check(grid > 0, f"previous K9 grid: {grid}")
        loss_row = torch.empty((M,), device="cuda")
        partials = torch.empty((grid, order, L * N), device="cuda")
        check(lib.aa_taps_tf_mse_launch(
            N, int(pivot), passes, hr.data_ptr(), hi.data_ptr(),
            tw.data_ptr(), rr.data_ptr(), ri.data_ptr(), t.data_ptr(),
            loss_row.data_ptr(), partials.data_ptr(), 2.0 / (M * N), L, M,
            order, nfft, bin_offset % nfft, 2.0 * math.pi / nfft, grid,
            self._stream()) == 0, "previous K9 launch")
        return torch.sum(loss_row) / (M * N), torch.sum(partials, dim=0)

    def tf_mse(self, D, U, b, c, X, t, with_dbar: bool, pivot: bool,
               key: str = "fdn"):
        """The previous K1 (before its redesign; with key 'tf', the K1
        beside the previous K3f and K3b) and its partials summed as its
        wrapper summed them: (loss, D_bar or None, U_bar, b_bar, c_bar)."""
        M = D.shape[0]
        D_bar = torch.empty_like(D)
        partials = torch.empty((-(-M // 128), N_MAIN * N_MAIN + 2 * N_MAIN
                                + 1), device="cuda")
        check(self.libs[key, N_MAIN].fdn_tf_mse_launch(
            N_MAIN, int(pivot), int(with_dbar), D.data_ptr(), U.data_ptr(),
            b.data_ptr(), c.data_ptr(), X.data_ptr(), t.data_ptr(),
            D_bar.data_ptr(), partials.data_ptr(), 2.0 / M, M,
            self._stream()) == 0, "previous K1 launch")
        U_bar, b_bar, c_bar, sq = fk._sum_partials(partials, N_MAIN)
        return (sq / M, D_bar if with_dbar else None, U_bar, b_bar, c_bar)

    def tf_fwd(self, D, U, b, c):
        """The previous K3f (its library for D's channel count): (tf, y)."""
        M, N = D.shape
        tf = torch.empty((M,), dtype=D.dtype, device=D.device)
        Y = torch.empty_like(D)
        check(self.libs["tf", N].fdn_tf_fwd_launch(
            N, D.data_ptr(), U.data_ptr(), b.data_ptr(), c.data_ptr(),
            tf.data_ptr(), Y.data_ptr(), M, self._stream()) == 0,
            "previous K3f launch")
        return tf, Y

    def tf_bwd(self, D, U, b, c, y, tf_bar):
        """The previous K3b (its library for D's channel count) and its
        partials summed as its wrapper summed them: (D_bar, U_bar, b_bar,
        c_bar)."""
        M, N = D.shape
        D_bar = torch.empty_like(D)
        partials = torch.empty((-(-M // 128), N * N + 2 * N + 1),
                               device=D.device)
        check(self.libs["tf", N].fdn_tf_bwd_launch(
            N, D.data_ptr(), U.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), tf_bar.data_ptr(), D_bar.data_ptr(),
            partials.data_ptr(), M, self._stream()) == 0,
            "previous K3b launch")
        return (D_bar, *fk._sum_partials(partials, N)[:3])

    def sos_fwd(self, b, a, nfft: int):
        """The previous K4f: H (nfft // 2 + 1, N_MAIN)."""
        P, K, N = b.shape
        M = nfft // 2 + 1
        H = torch.empty((M, N), dtype=torch.complex64, device="cuda")
        check(self.sos.sos_cascade_fwd_launch(
            b.data_ptr(), a.data_ptr(), H.data_ptr(), M, N, K, P,
            2 * math.pi / nfft, 0.0, self._stream()) == 0,
            "previous K4f launch")
        return H

    def sos_bwd(self, b, a, g, nfft: int):
        """The previous K4b and the sum of its partials rows, as its
        wrapper took them: (b_bar, a_bar)."""
        P, K, N = b.shape
        M = g.shape[0]
        partials = torch.empty((-(-M // 128), N, 2 * P * K), device="cuda")
        check(self.sos.sos_cascade_bwd_launch(
            b.data_ptr(), a.data_ptr(), g.data_ptr(), partials.data_ptr(), M,
            N, K, P, 2 * math.pi / nfft, 0.0, self._stream()) == 0,
            "previous K4b launch")
        s = torch.sum(partials, dim=0).reshape(N, 2, P, K).permute(1, 2, 3, 0)
        return s[0].contiguous(), s[1].contiguous()


# ---------------------------------------------------------------------------
# operation and byte counts of each kernel at (M, N), for the bounds
# ---------------------------------------------------------------------------
CMUL, CSUB, CABS2, CRECIP, CDIV = 6, 2, 3, 6, 12


def _flops_assemble(N):
    return 2 * N * N + N


def _flops_back(N):
    return sum((N - 1 - i) * (CMUL + CSUB) + CDIV for i in range(N))


def _flops_ge(N, pivot: bool):
    f = 0
    for k in range(N):
        rows = N - 1 - k
        if pivot:  # |a|^2 of the candidates and one compare each
            f += (rows + 1) * CABS2 + rows
        f += CRECIP + rows * (CMUL + rows * (CMUL + CSUB) + CMUL + CSUB)
    return f + _flops_back(N)


def _flops_transpose_from_factors(N):
    fwd = sum(i * (CMUL + CSUB) + CDIV for i in range(N))
    return fwd + sum((N - 1 - i) * (CMUL + CSUB) for i in range(N))


def _flops_cotangents(N, with_dbar: bool):
    per_i = CMUL + CMUL + 3 + N * 3          # bb, bbD, Re(tb y), Re(bbD y)
    if with_dbar:
        per_i += 4 * N + 1 + CMUL            # U y, + b, the D_bar product
    return N * per_i + (N * N + 2 * N + 1)   # + one add per partial


PHASOR = 4  # the angle (a multiply and an add), its sine and its cosine


def _flops_horner(P):
    return (P - 1) * (CMUL + 1)


def _flops_cascade(K, P):
    """One channel's guarded cascade: 2 K Horners, 2 K products, the
    guarded ratio."""
    return K * (2 * _flops_horner(P) + 2 * CMUL) + CABS2 + 1 + 8


def _flops_tap_sums(K, P):
    """One channel's tap cotangents from t: per section (both parts) the
    guarded quotient and P powers, each added to its sum.  The section
    responses are those of the cascade, counted there (the kernels
    recompute them, which is their choice, not work the function needs)."""
    return 2 * K * (CABS2 + 1 + 8 + P * (CMUL + 1))


def _flops_aa_bin(N, L, pivot):
    """One bin of K8: H G as L rank-1 updates, A = I - H G, the solve,
    the loss and w, the adjoint solve, and the S numbers."""
    adjoint = (_flops_ge(N, True) if pivot
               else _flops_transpose_from_factors(N))
    return (8 * L * N * N + 2 * N * N + _flops_ge(N, pivot) + 11 * N
            + adjoint + L * N * (CMUL + 2) + L * N * CMUL)


def _flops_phase2(variant: str, K: int, N: int, P: int,
                  k5_sections: bool = False) -> int:
    """FLOPs per bin of a K10 variant: the phasor and z^2 once.

    What the function needs: the passes s % K, s % N repeat with period
    lcm(K, N), each repeat giving a bit-identical q, so it needs lcm(K, N)
    passes (12 of 144 at K = 12, N = 6), and ps's two passes over k are
    identical, so it needs one.  Its three sums are linear in q, so a bin
    needs Q = sum q = tn sum conj(sec) / |sec|^2 (per pass the Horner sum,
    |sec|^2, the reciprocal, its conjugate product and the add), and once
    tn times that sum, the repeat count's scaling and the projections
    Re Q, Re(Q z), Re(Q z^2), each added to its sum.  ``ps`` per channel:
    each section's response once, the prefix and suffix products, the
    sum of pre_k suf_{k+1}, the product's reciprocal times that sum.

    With ``k5_sections`` every pass is counted as a distinct section
    instead, as K5's tap phase has 2 K N of them, each with its own three
    sums: per pass the Horner sum, the guarded quotient q and the
    projections Re(q z), Re(q z^2) (3 each), each of the 3 terms added to
    its sum; ``ps`` per channel each section's response once, the prefix
    and suffix products, the product's quotient and, for both passes over
    k, pre_k suf_{k+1}, q and the same projections."""
    per_bin = PHASOR + CMUL
    if k5_sections:
        sums = 2 * 3 + 3
        if variant == "ps":
            per_channel = (K * (_flops_horner(P) + 2 * CMUL) + CABS2 + 1 + 8
                           + 2 * K * (2 * CMUL + sums))
            return per_bin + N * per_channel
        return per_bin + 2 * K * N * (_flops_horner(P) + CABS2 + 1 + 8
                                      + sums)
    once = CMUL + 2 + 2 * 3 + 3
    if variant == "ps":
        per_channel = (K * (_flops_horner(P) + 3 * CMUL + 2) + CABS2 + 1 + 2
                       + CMUL + 2)
        return per_bin + N * per_channel + once
    return (per_bin + math.lcm(K, N) * (_flops_horner(P) + CABS2 + 1 + 2 + 2)
            + once)


def kernel_work(name: str, M: int, N: int, pivot=False, with_dbar=False,
                K=K_MAIN, P=P_MAIN, fuse_taps=True, L=AA_L, order=AA_ORDER,
                k5_sections=False):
    """(bytes moved once, FLOPs) of one launch.  For K7 M counts the
    polynomials and N is their degree; for K10 M counts the bins, and
    ``k5_sections`` counts its passes as K5's distinct sections."""
    if name.startswith("phase2_"):  # reads t and c, writes the partials
        variant = name.removeprefix("phase2_")
        return (8 * M + 4 * P * K * N + 4 * 3 * (-(-M // 128)),
                M * _flops_phase2(variant, K, N, P, k5_sections))
    if name == "dk_roots":
        # per slot and iteration: Horner 8N, the product 8(N-1), |d|^2,
        # the reciprocal, the quotient and the update 14
        return 16 * N * M, M * (DK_ITERS * N * (16 * N + 6) + 7 * N)
    if name == "aa_tf_mse":  # reads H, G, r, t; writes S and the loss row
        return (4 * M * (4 * N * L + 3 * N + 2 * L * N + 1),
                M * _flops_aa_bin(N, L, pivot))
    if name == "aa_taps_tf_mse":  # reads H, r, t, tw; writes loss, tb
        return (4 * M * (2 * N * L + 3 * N + 1) + 2 * 4 * order * L * N,
                M * (_flops_aa_bin(N, L, pivot) + PHASOR * order
                     + 2 * 4 * order * L * N))
    if name == "aa_taps_tf_mse_tc":  # the contractions: tensor_flops
        return (4 * M * (2 * N * L + 3 * N + 1) + 2 * 4 * order * L * N,
                M * (_flops_aa_bin(N, L, pivot) + PHASOR * order))
    cplx_mn, cplx_m, real_m = 8 * M * N, 8 * M, 4 * M
    small = 4 * (N * N + 2 * N)
    partials = 4 * (-(-M // 128)) * (N * N + 2 * N + 1)
    taps = 2 * 4 * P * K * N
    if name == "sos_cascade_fwd":
        return taps + cplx_mn, M * (PHASOR + N * _flops_cascade(K, P))
    if name == "sos_cascade_bwd":
        tap_partials = 4 * (-(-M // 128)) * N * 2 * P * K
        return (taps + cplx_mn + tap_partials,
                M * (PHASOR + N * (_flops_cascade(K, P) + CMUL
                                   + _flops_tap_sums(K, P))))
    if name == "fdn_sos_tf_mse":
        adjoint = (_flops_assemble(N) + _flops_ge(N, True) if pivot
                   else _flops_transpose_from_factors(N))
        per_i = (4 * CMUL + 4 * N + 2 * (CMUL + 1) + N * (CMUL + 1)
                 + (CMUL + 2 if with_dbar else 0) + (CMUL if fuse_taps else 0))
        flops = (PHASOR + N * (_flops_cascade(K, P) + CMUL)
                 + _flops_assemble(N) + 2 * N + _flops_ge(N, pivot) + 4 * N
                 + 22 + adjoint + N * per_i + 1
                 + (N * _flops_tap_sums(K, P) if fuse_taps else 0))
        nv = N * N + 2 * N + 1 + (2 * P * K * N if fuse_taps else 0)
        nbytes = (cplx_mn + cplx_m + real_m + taps + small
                  + 4 * (-(-M // 128)) * nv + (cplx_mn if with_dbar else 0)
                  + (0 if fuse_taps else cplx_mn))
        return nbytes, M * flops
    if name.startswith("dense_solve"):  # A (M, N, N), B and y (M, N)
        return (cplx_mn * N + 2 * cplx_mn, M * _flops_ge(N, True))
    if name == "fdn_solve":
        return (2 * cplx_mn + 4 * N * N + cplx_mn,
                M * (_flops_assemble(N) + _flops_ge(N, True)))
    if name == "fdn_tf_fwd":
        return (cplx_mn + small + cplx_m + cplx_mn,
                M * (_flops_assemble(N) + 2 * N + _flops_ge(N, True) + 4 * N))
    if name == "fdn_tf_bwd":
        return (2 * cplx_mn + small + cplx_m + cplx_mn + partials,
                M * (_flops_assemble(N) + _flops_ge(N, True)
                     + _flops_cotangents(N, True)))
    adjoint = (_flops_assemble(N) + _flops_ge(N, True) if pivot
               else _flops_transpose_from_factors(N))
    flops = (_flops_assemble(N) + 2 * N + _flops_ge(N, pivot) + 4 * N + 22
             + adjoint + _flops_cotangents(N, with_dbar))
    return (cplx_mn + small + cplx_m + real_m + partials
            + (cplx_mn if with_dbar else 0), M * flops)


def tensor_flops(M: int, N: int, passes: int = 0, L=AA_L, order=AA_ORDER,
                 **_) -> int:
    """TF32 tensor-core FLOPs of one launch of K9's tensor-core kernel: its
    two real contractions (re and im, order x L N each way) per bin, once
    per pass (3 for 'high', 1 for 'default'; 0 for the other kernels)."""
    return passes * M * 2 * 4 * order * L * N


def bound(name: str, M: int, N: int, passes: int = 0,
          **kw) -> tuple[float, str]:
    """The least time of one launch: the larger of its bytes over the HBM
    rate and its operations over their peak rates, FP32 on the CUDA cores
    and TF32 on the tensor cores taken apart (separate pipes)."""
    nbytes, flops = kernel_work(name, M, N, **kw)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / PEAK_FP32,
                tensor_flops(M, N, passes, **kw) / PEAK_TF32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _device_events(prof) -> list:
    """Averaged profiler events that ran on the card (kernels, copies).
    User annotations (``Optimizer.step#Adam.step``) also appear on the
    device timeline, spanning the kernels launched inside them; they are
    left out so that no device time is counted twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation
            and e.self_device_time_total > 0]


TRACE_RETRIES = [0]  # traces taken again by device_ms, over the whole run
EVENT_TIMED: list = []  # what device_ms timed by CUDA events instead
TRACES = 4  # traces device_ms takes before it times by CUDA events


def device_ms(fn, kernel: str | None = None, reps: int = 50) -> float:
    """Mean device time per call of the device operations whose name holds
    ``kernel`` (all of them when None), from a torch.profiler trace of
    ``reps`` calls of ``fn``.  On the H100 the profiler has come back
    without any kernel of a trace that launched them, and with 49 of a
    named kernel's 50 launches: such a trace (none, or fewer launches of
    the kernel than calls) is taken again, up to TRACES in all, and
    counted in TRACE_RETRIES.  A named kernel is launched once a call, so
    a trace kept with fewer launches is read per launch it holds.  When
    every trace came back without it, the call is timed by CUDA events
    (``time_ms``: the whole of ``fn``, the launches' host time included)
    and named in EVENT_TIMED."""
    fn()
    torch.cuda.synchronize()
    us, n = 0.0, 0
    for attempt in range(TRACES):
        if attempt:
            TRACE_RETRIES[0] += 1
            time.sleep(0.2)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in _device_events(prof)
               if kernel is None or kernel in e.key]
        us = sum(e.self_device_time_total for e in ops)
        n = sum(e.count for e in ops)
        if us > 0 and (kernel is None or n >= reps):
            break
        seen = sorted({e.key[:40] for e in _device_events(prof)})
        last = attempt == TRACES - 1
        print(f"  the profiler saw {n} launches and {us:.1f} us of device "
              f"time for {kernel or fn} in {reps} calls (and "
              f"{len(seen)} device operations in all: {seen[:4]}); "
              + ("tracing again" if not last else "read per launch"
                 if us > 0 else "timed by CUDA events"))
    if us > 0:
        return us / (reps if kernel is None else min(n, reps)) / 1e3
    EVENT_TIMED.append(kernel or getattr(fn, "__name__", "fn"))
    return time_ms(fn, reps)


def timed(run):
    """(result of ``run()``, its seconds by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()

    def run():  # each result dropped at once, as a caller's loop would
        for _ in range(reps):
            fn()

    _, seconds = timed(run)
    return seconds * 1e3 / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build(ptxas: bool = False) -> str:
    check(torch.cuda.is_available(), "no CUDA device: this script needs one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    targets = (*(("fdn_kernels", n) for n in K3_NS),
               ("fdn_loop", 1), ("sos_kernels", N_MAIN),
               ("sos_cascade", 1), ("aa_kernels", AA_N),
               ("aa_kernels", ak.MAX_N), ("aa_loop", 1), ("eig_kernels", AA_N),
               ("eig_kernels", 8), ("phase2_micro", 1))
    log = PTXAS_LOG if ptxas else None
    t0 = time.perf_counter()
    # the unrolled kernels at 16 channels, which phases 4l and 5m hold the
    # looped ones to, compile for minutes: beside phases 1-4k, one core
    # each
    unrolled16 = BackgroundBuild([("fdn_kernels", fk.MAX_N),
                                  ("sos_kernels", fk.MAX_N)])
    unrolled16.start()
    try:
        previous_build = Previous.start(ptxas)
        seconds = cuda_build.build(targets, ptxas_log=log)
        previous = Previous(previous_build, log)
    except BaseException:
        unrolled16.join()
        raise
    seconds[("previous controls", N_MAIN)] = time.perf_counter() - t0
    names = [cuda_build.library_path(n, lib).name for lib, n in targets]
    for lib, n in targets:
        cuda_build.load(n, lib)
    controls = " and ".join(
        f"{previous_so(key, n).name} from "
        f"{PREVIOUS_SRC[key].relative_to(CONTROLS.parent)}"
        for key, n in PREVIOUS_BUILDS)
    print(f"phase 1 build: {max(seconds.values()):.1f} s, "
          f"{len(names) + len(PREVIOUS_BUILDS)} libraries in parallel "
          f"({', '.join(names)}, and {controls}, phase 5's controls; "
          f"{cuda_build.threads_per_block(N_MAIN)} threads/block for K1-K3)")
    print("  each library's seconds (its nvcc beside the others): "
          + ", ".join(f"{lib} N={n} {s:.1f}"
                      for (lib, n), s in seconds.items()))
    if ptxas:
        print_ptxas(log.read_text())
    return card, previous, unrolled16


class BackgroundBuild(threading.Thread):
    """cuda_build.build of ``targets`` on a thread; ``wait()`` joins it and
    raises its failure or returns its seconds."""

    def __init__(self, targets):
        super().__init__(daemon=True)
        self.targets, self.seconds, self.error = targets, None, None

    def run(self):
        try:
            self.seconds = cuda_build.build(self.targets)
        except BaseException as e:  # raised again by wait()
            self.error = e

    def wait(self) -> dict:
        self.join()
        if self.error is not None:
            raise self.error
        return self.seconds


def print_ptxas(report: str) -> None:
    """Registers and spills of the K1, K2, K3f, K3b, K4f, K4b, K5, K6, K7,
    K9 and K10 instantiations (K10's at P = 3) from nvcc's
    -Xptxas -v report (the previous libraries' tagged as such), with the
    warps an SM that the registers allow."""
    name, spills, tag, k4 = None, "", "", {}
    for line in report.splitlines():
        if line.startswith("# "):
            tag = "previous " if line.startswith("# previous") else ""
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
        elif "spill stores" in line:
            spills = line.split(",", 1)[1].strip()
        used = re.search(r"Used (\d+) registers", line)
        which = name and re.search(
            r"(fdn_sos_tf_mse|dk_roots|fdn_tf_mse|fdn_tf_fwd|fdn_tf_bwd|"
            r"dense_solve|"
            r"fdn_solve|ge_loop_solve|ge_loop_dense|ge_loop_tf_mse|"
            r"ge_loop_tf_fwd|ge_loop_tf_bwd|reg_tf_fwd|reg_tf_bwd|"
            r"reg_solve|reg_sos_tf_mse|ge_loop_sos_tf_mse|"
            r"aa_taps_tf_mse_tc|aa_taps_tf_mse|sos_cascade_fwd|"
            r"sos_cascade_bwd|phase2_full|phase2_ps|phase2_noreduce|"
            r"phase2_lanered)_kernel", name)
        if not (used and which):
            continue
        kernel = which.group(0)
        targs = re.findall(r"L[ib](\d+)E", name)
        regs = int(used.group(1))
        if kernel.startswith("phase2") and targs and targs != [str(P_MAIN)]:
            continue  # K10's copies for the other P
        if kernel.startswith("sos_cascade") and targs:
            # K4's 64 copies a kernel: the main path's, and the most
            # registers and any spill over all of them
            k4.setdefault(kernel, []).append((regs, spills))
            if targs != [str(N_MAIN), str(P_MAIN)]:
                continue
        # a block's warps; K6's blocks are one warp, the previous ones
        # four; K9's eight, the previous FP32 one's two; the looped
        # kernels' up to eight (fewer at large N: their shared memory)
        # fdn_reg.cu's: K2 and K3f 4 warps a block, K3b and K5 8 at H = 1
        # and 16 at H = 2
        warps = {"dk_roots_kernel": 2, "ge_loop_solve_kernel": 8,
                 "ge_loop_dense_kernel": 8, "ge_loop_tf_mse_kernel": 8,
                 "ge_loop_tf_fwd_kernel": 8, "ge_loop_tf_bwd_kernel": 8,
                 "ge_loop_sos_tf_mse_kernel": 8,
                 **dict.fromkeys(("reg_sos_tf_mse_kernel",
                                  "reg_tf_bwd_kernel"),
                                 8 if targs[:1] == ["1"] else 16),
                 "dense_solve_kernel": 4 if tag else 1,
                 "aa_taps_tf_mse_kernel": 2 if tag else 8,
                 "aa_taps_tf_mse_tc_kernel": 8}.get(kernel, 4)
        per_warp = -(-regs * 32 // 256) * 256  # allocated per warp, in 256s
        blocks = min(65536 // (per_warp * warps), 64 // warps, 32)
        print(f"  ptxas {tag}{kernel}<{', '.join(targs)}>: {regs} registers, "
              f"{spills}; {blocks * warps} warps an SM by registers")
    for kernel, copies in k4.items():
        spilled = [sp for _, sp in copies if not sp.startswith("0 bytes spill "
                                                                "stores")]
        print(f"  ptxas {kernel}, all {len(copies)} <NC, P> copies: at most "
              f"{max(r for r, _ in copies)} registers, "
              f"{len(spilled)} with spills")


def _stable_taps(rng, P: int, K: int, N: int, device="cuda"):
    """Well-conditioned SOS taps: poles of radius 0.2-0.6, numerators close
    to the denominators (each section's response near 1)."""
    r = rng.uniform(0.2, 0.6, (K, N))
    th = rng.uniform(0, np.pi, (K, N))
    a = np.stack([np.ones((K, N)), -2 * r * np.cos(th), r * r])
    b = a + 0.02 * rng.normal(size=(P, K, N))
    return (torch.tensor(b.astype(np.float32), device=device),
            torch.tensor(a.astype(np.float32), device=device))


def main_path_operands(M: int, N: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    D = (0.85 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N))))
    U = expm_skew(torch.tensor(rng.normal(size=(N, N)), dtype=torch.float32))
    bt, at = _stable_taps(rng, P_MAIN, K_MAIN, N)
    # the taps of the attenuated FDN that phase 4 trains, at its first step
    att = att_model(seed).get_core().feedback_loop.feedback.attenuation
    with torch.no_grad():
        geq_bt, geq_at = att.sos_taps(att.map(att.param))
    # K4 at 25 channels: random taps and a full 5 x 5 GEQ's
    rng25 = np.random.default_rng(seed + 5)
    bt25, at25 = _stable_taps(rng25, P_MAIN, K_MAIN, 25)
    geq25_bt, geq25_at = geq25_taps(geq25(seed))
    return dict(
        bt=bt, at=at, geq_bt=geq_bt.contiguous(), geq_at=geq_at.contiguous(),
        bt25=bt25, at25=at25, geq25_bt=geq25_bt, geq25_at=geq25_at,
        g25=torch.tensor((rng25.normal(size=(M, 25)) + 1j * rng25.normal(
            size=(M, 25))).astype(np.complex64), device="cuda"),
        g=torch.tensor((rng.normal(size=(M, N)) + 1j * rng.normal(
            size=(M, N))).astype(np.complex64), device="cuda"),
        D=torch.tensor(D.astype(np.complex64), device="cuda"),
        U=U.cuda(),
        b=torch.tensor(rng.normal(size=N).astype(np.float32), device="cuda"),
        c=torch.tensor(rng.normal(size=N).astype(np.float32), device="cuda"),
        B=torch.tensor((rng.normal(size=(M, N)) + 1j * rng.normal(
            size=(M, N))).astype(np.complex64), device="cuda"),
        X=torch.tensor((rng.normal(size=M) + 1j * rng.normal(size=M))
                       .astype(np.complex64), device="cuda"),
        t=torch.tensor(rng.uniform(size=M).astype(np.float32), device="cuda"),
        tf_bar=torch.tensor((rng.normal(size=M) + 1j * rng.normal(size=M))
                            .astype(np.complex64), device="cuda"),
    )


def third_octave_taps(seed: int = SEED, device="cuda"):
    """The (3, 30, 6) taps of a 1/3-octave delay-scaled accurate GEQ on
    HomogeneousFDN's delays (phase 4j's), its RT60s drawn from ``seed``,
    as its response hands them to K4."""
    m = parallelFDNAccurateGEQ(
        octave_interval=3, nfft=NFFT, fs=48000, delays=hfdn_delays(),
        device=device, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        b, a = m.sos_taps(None)
    return b.contiguous(), a.contiguous()


def geq25(seed: int = SEED):
    """A full GEQ of GEQ25 = (5, 5) channels on the 'pallas' backend: its
    25 channels fold into K4's channel axis (dsp._guarded_cascade)."""
    return dsp.GEQ(size=GEQ25, nfft=NFFT, cascade_backend="pallas",
                   device="cuda",
                   generator=torch.Generator().manual_seed(seed))


def geq25_taps(geq):
    """A GEQ's (P, K, 25) taps, as its response hands them to K4."""
    with torch.no_grad():
        b, a = geq.sos_taps(geq.map(geq.param))
    return (b.reshape(*b.shape[:2], -1).contiguous(),
            a.reshape(*a.shape[:2], -1).contiguous())


def sfdn_model(seed: int = SEED):
    return build_colorless_sfdn(nfft=NFFT, solve_method="pallas",
                                device="cuda",
                                generator=torch.Generator().manual_seed(seed))


def sfdn_masks(seed: int = SEED):
    """The masked_mse mask schedule of sfdn_fit(generator=seed)."""
    return masked_mse_loss(nfft=NFFT, n_samples=SFDN_SAMPLES,
                           generator=torch.Generator().manual_seed(seed),
                           device="cuda")


def sfdn_pair():
    """sfdn_fit's impulse input and flat target, both (1, M, 1)."""
    M = NFFT // 2 + 1
    x = torch.zeros((1, M, 1), device="cuda")
    x[:, 0, :] = 1.0
    return x, torch.ones((1, M, 1), device="cuda")


def sfdn_loop_systems(model, bins=None):
    """The scattering FDN's closed-loop systems for the impulse input:
    A = I - diag(D) S (rows, N, N) and B = D g_in (rows, N), at every bin
    from the modules' responses (the graph step's K6 operands), or at
    ``bins`` from their response_at (the masked step's)."""
    core = model.get_core()
    loop = core.feedback_loop
    with torch.no_grad():
        if bins is None:
            S, D = loop.feedback.response(), loop.feedforward.response()
        else:
            S = loop.feedback.response_at(bins)
            D = loop.feedforward.response_at(bins)
        gi = core.input_gain.response()[:, 0]
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return ((eye - D[:, :, None] * S).contiguous(),
            (D * gi[None]).contiguous())


def sfdn_model_f64(model):
    """A float64 twin of the scattering FDN ``model`` on the plain 'ge'
    solve: its weights and its scattering shifts copied."""
    m64 = build_colorless_sfdn(nfft=NFFT, dtype=torch.float64, device="cuda",
                               generator=torch.Generator().manual_seed(SEED))
    m64.load_state_dict(model.state_dict())
    mapping = model.get_core().feedback_loop.feedback.map_filter
    return load_jax_scattering(m64, mapping.shifts, mapping.m_L, mapping.m_R)


def random_dense(rng, rows: int, N: int):
    """Random well-conditioned systems: I plus a normal complex matrix of
    norm ~0.5, and a normal rhs."""
    A = (np.eye(N) + (rng.normal(size=(rows, N, N))
                      + 1j * rng.normal(size=(rows, N, N)))
         / (4 * np.sqrt(N)))
    B = rng.normal(size=(rows, N)) + 1j * rng.normal(size=(rows, N))
    return (torch.tensor(A.astype(np.complex64), device="cuda"),
            torch.tensor(B.astype(np.complex64), device="cuda"))


def tied_pivot_systems(rng, rows: int, N: int):
    """(A (rows, N, N), B (rows, N), exact (rows,)) in numpy complex128:
    systems whose pivot columns tie in |a|.  The exact ones, lower- and
    upper-triangular matrices of ones with rows scaled by powers of i and
    scaled permutations, tie at every step one of the two ways with unit
    multipliers: the first maximal row keeps every operation exact, so a
    right kernel equals its plain version bit for bit, and any other rule
    rounds their rhs (magnitudes 1 and 2^27) another way.  The others, sign
    matrices (condition number below 50) and DFT matrices times a unit
    phase, tie up to rounding; their rhs is normal."""
    low = np.tril(np.ones((N, N)))
    k = np.arange(N)
    dft = np.exp(-2j * np.pi * np.outer(k, k) / N)
    mats, exact = [], []
    while len(mats) < rows:
        rot = 1j ** rng.integers(0, 4, size=(N, 1))
        perm = np.zeros((N, N), complex)
        perm[np.arange(N), rng.permutation(N)] = 2.0 * 1j ** rng.integers(
            0, 4, N)
        while True:
            signs = rng.choice([-1.0, 1.0], size=(N, N)).astype(complex)
            if np.linalg.cond(signs) < 50:
                break
        mats += [rot * low, rot * low.T, perm, signs,
                 dft * np.exp(1j * rng.uniform(0, 2 * np.pi))]
        exact += [True, True, True, False, False]
    exact = np.array(exact[:rows])
    scale = np.where(rng.random((rows, N)) < 0.5, 1.0, 2.0 ** 27)
    B_exact = (scale * 1j ** rng.integers(0, 4, size=(rows, N))
               * (rng.integers(1, 8, size=(rows, N)) + 0.25))
    B_normal = rng.normal(size=(rows, N)) + 1j * rng.normal(size=(rows, N))
    return (np.stack(mats[:rows]), np.where(exact[:, None], B_exact, B_normal),
            exact)


def k2_systems(rng, M: int, N: int, transpose: bool = False) -> dict:
    """K2's systems (I - diag(D) U) y = B, or their transposes, as numpy
    (D (M, N) complex, U (N, N) real, B (M, N) complex, exact (M,) bool),
    by label.  'random': |D| = 0.85 with random phases, an orthogonal U.
    'pivoting': every bin pivots off row k at every step k < N - 1 (D of
    modulus 3 with random phases against U, a cyclic shift, down for the
    forward system and up for the transposed one, plus normal noise of
    0.05).  'tied lower' and 'tied upper': D of powers of i and U minus
    the ones below or above the diagonal, a unit triangle whose pivot
    columns tie in |a| at every step of the forward or of the transposed
    system: the first maximal row must be taken, which keeps every
    operation exact (unit multipliers), and their rhs of magnitudes 1 and
    2^27 round another way under any other rule; every system of these
    two is exact.  'cycle': D of powers of i and U minus a cyclic shift
    by one with entries 1 and 2 in turn (0 at N = 1): each column ties,
    or calls for the row twice the size, and the fill-in is not exact."""
    def rhs_exact():
        scale = np.where(rng.random((M, N)) < 0.5, 1.0, 2.0 ** 27)
        return (scale * 1j ** rng.integers(0, 4, size=(M, N))
                * (rng.integers(1, 8, size=(M, N)) + 0.25))

    def normal(shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    units = 1j ** rng.integers(0, 4, size=(M, N))
    cycle = -np.roll(np.eye(N), 1, axis=1) * np.where(np.arange(N) % 2,
                                                      2.0, 1.0)[:, None]
    none, every = np.zeros(M, bool), np.ones(M, bool)
    if N == 1:  # no off-diagonal: A = 1
        cycle = np.zeros((1, 1))
    return {
        "random": (0.85 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N))),
                   np.linalg.qr(rng.normal(size=(N, N)))[0], normal((M, N)),
                   none),
        "pivoting": (3.0 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N))),
                     np.roll(np.eye(N), -1 if transpose else 1, axis=0)
                     + 0.05 * rng.normal(size=(N, N)), normal((M, N)),
                     none),
        "tied lower": (units, -np.tril(np.ones((N, N)), -1), rhs_exact(),
                       every),
        "tied upper": (units, -np.triu(np.ones((N, N)), 1), rhs_exact(),
                       every),
        "cycle": (units, cycle, rhs_exact(), none),
    }


def k2_tensors(system, device="cuda"):
    """(D, U, B) of a k2_systems entry as complex64/float32 tensors."""
    D, U, B, _ = system
    return (torch.tensor(D.astype(np.complex64), device=device),
            torch.tensor(U.astype(np.float32), device=device),
            torch.tensor(B.astype(np.complex64), device=device))


def k3_systems(rng, M: int, N: int, transpose: bool = False) -> dict:
    """K3's operands by label, as numpy (D (M, N) complex, U (N, N) real,
    b (N,), c (N,) real, tf_bar (M,) complex, exact (M,) bool): D, U and
    exact are k2_systems(rng, M, N, transpose)'s, whose elimination K3f
    runs (transpose False) or K3b (True).  On the exact tied systems b
    and c are real of magnitudes 1 and 2^27 (times a whole number plus
    0.25, signs random): D (powers of i) times b is exact, and the
    elimination of D b (K3f) or of c (K3b) rounds another way under any
    other pivot rule.  Elsewhere b and c are normal; tf_bar is normal."""
    systems = k2_systems(rng, M, N, transpose)

    def gains():
        scale = np.where(rng.random(N) < 0.5, 1.0, 2.0 ** 27)
        return (scale * rng.choice([-1.0, 1.0], N)
                * (rng.integers(1, 8, N) + 0.25))

    out = {}
    for label, (D, U, _, exact) in systems.items():
        b, c = ((gains(), gains()) if exact.all()
                else (rng.normal(size=N), rng.normal(size=N)))
        tf_bar = rng.normal(size=M) + 1j * rng.normal(size=M)
        out[label] = (D, U, b, c, tf_bar, exact)
    return out


def k3_tensors(system, device="cuda"):
    """(D, U, b, c, tf_bar) of a k3_systems entry as complex64/float32
    tensors."""
    D, U, b, c, tf_bar, _ = system
    return (torch.tensor(D.astype(np.complex64), device=device),
            torch.tensor(U.astype(np.float32), device=device),
            torch.tensor(b.astype(np.float32), device=device),
            torch.tensor(c.astype(np.float32), device=device),
            torch.tensor(tf_bar.astype(np.complex64), device=device))


def pivot_vote_share(A) -> tuple[float, float]:
    """(bins, warps): the share of the elimination steps k < N - 1 of the
    systems A (M, N, N) at which a bin pivots off row k, and at which some
    bin of a warp of 32 consecutive bins does, so that K2's warp runs its
    selects (ge_pivot_voted).  The elimination is repeated on the device
    in float32 with the kernel's rule, the first row of largest |a|^2."""
    M, N = A.shape[0], A.shape[-1]
    if N == 1:
        return 0.0, 0.0
    A = A.to(torch.complex64).clone()
    idx = torch.arange(M, device=A.device)
    need = torch.zeros((M, N - 1), dtype=torch.bool, device=A.device)
    for k in range(N - 1):
        col = A[:, k:, k]
        piv = torch.argmax(col.real * col.real + col.imag * col.imag,
                           dim=1) + k
        need[:, k] = piv != k
        rk, rp = A[idx, k].clone(), A[idx, piv].clone()
        A[idx, k], A[idx, piv] = rp, rk
        f = A[:, k + 1:, k] / A[:, k, k][:, None]
        A[:, k + 1:, :] -= f[:, :, None] * A[:, k, None, :]
    pad = -M % 32
    warps = torch.nn.functional.pad(need, (0, 0, 0, pad)).reshape(
        -1, 32, N - 1).any(dim=1)
    return float(need.float().mean()), float(warps.float().mean())


def dense_operands(seed: int = SEED) -> dict:
    """K6's operands at the scattering slice's two shapes: the loop
    systems of its model at every bin and at the first mask's bins, and
    random ones of the same shapes."""
    rng = np.random.default_rng(seed + 1)
    model = sfdn_model(seed)
    mask = sfdn_masks(seed).masks_for_cycle(0)[0]
    return {"M": dict(model=sfdn_loop_systems(model),
                      random=random_dense(rng, M_MAIN, N_MAIN)),
            "P": dict(model=sfdn_loop_systems(model, mask),
                      random=random_dense(rng, SFDN_SAMPLES, N_MAIN))}


def tied_operands(seed: int = SEED):
    """The tied-pivot batch at the masked step's row count, on the card,
    and the mask of its exact systems (on the CPU)."""
    A, B, exact = tied_pivot_systems(np.random.default_rng(seed + 4),
                                     SFDN_SAMPLES, N_MAIN)
    return (torch.tensor(A.astype(np.complex64), device="cuda"),
            torch.tensor(B.astype(np.complex64), device="cuda"),
            torch.from_numpy(exact))


def compare(label, got, ref, tol) -> float:
    err, rel = rel_err(got, ref)
    print(f"  {label}: max abs err {err:.3e}, rel {rel:.3e} (tol {tol:g})")
    check(rel < tol, f"{label}: relative error {rel:.3e} >= {tol:g}")
    return err


def phase_kernels(o, previous) -> dict:
    """Each kernel against its plain version; returns the max abs error of
    each kernel's main-path variant."""
    print(f"phase 2 kernels vs plain versions at M={M_MAIN}, N={N_MAIN}")
    D, U, b, c, B, X, t = (o[k] for k in "DUbcBXt")
    errs = {}
    e = [compare(f"K2 fdn_solve transpose={tr}",
                 fk.fdn_solve_kernel(D, U, B, tr),
                 fk.fdn_solve_plain(D, U, B, tr), VAL_TOL)
         for tr in (False, True)]
    errs["fdn_solve"] = max(e)
    k2_versus_previous(D, U, B, previous)
    tf, y = fk.fdn_tf_fwd_kernel(D, U, b, c)
    tfp, yp = fk.fdn_tf_fwd_plain(D, U, b, c)
    errs["fdn_tf_fwd"] = max(compare("K3f tf", tf, tfp, VAL_TOL),
                             compare("K3f y", y, yp, VAL_TOL))
    got = fk.fdn_tf_bwd_kernel(D, U, b, c, yp, o["tf_bar"])
    ref = fk.fdn_tf_bwd_plain(D, U, b, c, yp, o["tf_bar"])
    errs["fdn_tf_bwd"] = max(
        compare(f"K3b {n}", g, r, GRAD_TOL)
        for n, g, r in zip(("D_bar", "U_bar", "b_bar", "c_bar"), got, ref))
    k3_versus_previous(D, U, b, c, o["tf_bar"], previous)
    for pivot in (True, False):
        for with_dbar in (True, False):
            got = fk.fdn_tf_mse_kernel(D, U, b, c, X, t, with_dbar, pivot)
            ref = fk.fdn_tf_mse_plain(D, U, b, c, X, t, with_dbar, pivot)
            tag = f"K1 pivot={pivot} with_dbar={with_dbar}"
            e = [compare(f"{tag} loss", got[0], ref[0], VAL_TOL)]
            for n, g, r in zip(("D_bar", "U_bar", "b_bar", "c_bar"),
                               got[1:], ref[1:]):
                if r is None:
                    check(g is None, f"{tag}: D_bar should be absent")
                    continue
                e.append(compare(f"{tag} {n}", g, r, GRAD_TOL))
            # K1's cotangents share fdn_ge.cuh with K3b's: its bits stay
            same = all(g is r if r is None else torch.equal(g, r)
                       for g, r in zip(got, previous.tf_mse(
                           D, U, b, c, X, t, with_dbar, pivot, "tf")))
            print(f"  {tag}: equal to the K1 of controls/fdn_tf_prev bit "
                  f"for bit: {same}")
            check(same, f"{tag}: not the bits of controls/fdn_tf_prev's K1")
            if not pivot and not with_dbar:  # the variant colorless_fit runs
                errs["fdn_tf_mse"] = max(e)
                again = fk.fdn_tf_mse_kernel(D, U, b, c, X, t, with_dbar,
                                             pivot)
                same = all(torch.equal(g, a) for g, a in zip(got, again)
                           if g is not None)
                print(f"  {tag}: a second launch gives the same loss and "
                      f"cotangents: {same}")
                check(same, f"{tag}: two launches differ")

    print(f"  SOS kernels at K={K_MAIN}, P={P_MAIN}")
    for label, bt, at, g, vtol, gtol in (
            ("random taps", o["bt"], o["at"], o["g"], VAL_TOL, GRAD_TOL),
            ("GEQ taps", o["geq_bt"], o["geq_at"], o["g"], GEQ_VAL_TOL,
             GEQ_GRAD_TOL),
            ("random taps, 25 channels", o["bt25"], o["at25"], o["g25"],
             VAL_TOL, GRAD_TOL),
            (f"{GEQ25[0]} x {GEQ25[1]} GEQ's taps, 25 channels",
             o["geq25_bt"], o["geq25_at"], o["g25"], GEQ_VAL_TOL,
             GEQ_GRAD_TOL)):
        e_f = compare(f"K4f sos_cascade_fwd ({label})",
                      sk.sos_cascade_fwd_kernel(bt, at, NFFT),
                      sk.sos_cascade_fwd_plain(bt, at, NFFT), vtol)
        got = sk.sos_cascade_bwd_kernel(bt, at, g, NFFT)
        ref = sk.sos_cascade_bwd_plain(bt, at, g, NFFT)
        e_b = max(compare(f"K4b sos_cascade_bwd {n} ({label})", g_, r_, gtol)
                  for n, g_, r_ in zip(("b_bar", "a_bar"), got, ref))
        if label == "GEQ taps":  # the attenuated FDN's own taps
            errs["sos_cascade_fwd"], errs["sos_cascade_bwd"] = e_f, e_b
            again = sk.sos_cascade_bwd_kernel(bt, at, g, NFFT)
            same = all(torch.equal(g_, a_) for g_, a_ in zip(got, again))
            print(f"  K4b ({label}): a second launch gives the same tap "
                  f"cotangents: {same}")
            check(same, "K4b: two launches differ")
    U6 = 0.6 * U  # a loop gain well below 1 with |Gam| near 1
    names = ("D_bar", "bt_bar", "at_bar", "U_bar", "b_bar", "c_bar")
    for pivot, fuse_taps in itertools.product((True, False), repeat=2):
        for with_dbar in (True, False):
            args = (D, o["bt"], o["at"], U6, b, c, X, t, NFFT, with_dbar,
                    pivot, fuse_taps)
            got = sk.fdn_sos_tf_mse_kernel(*args)
            ref = sk.fdn_sos_tf_mse_plain(*args)
            tag = (f"K5 pivot={pivot} fuse_taps={fuse_taps} "
                   f"with_dbar={with_dbar}")
            e = [compare(f"{tag} loss", got[0], ref[0], VAL_TOL)]
            for n, g_, r_ in zip(names, got[1:], ref[1:]):
                if r_ is None:
                    check(g_ is None, f"{tag}: D_bar should be absent")
                    continue
                e.append(compare(f"{tag} {n}", g_, r_, GRAD_TOL))
            if fuse_taps and not pivot and not with_dbar:  # the training one
                errs["fdn_sos_tf_mse"] = max(e)
                again = sk.fdn_sos_tf_mse_kernel(*args)
                same = all(torch.equal(g_, a_) for g_, a_ in zip(got, again)
                           if g_ is not None)
                print(f"  {tag}: a second launch gives the same loss and "
                      f"cotangents: {same}")
                check(same, f"{tag}: two launches differ")
    args = (D, o["geq_bt"], o["geq_at"], U6, b, c, X, t, NFFT)
    got = sk.fdn_sos_tf_mse_kernel(*args)
    ref = sk.fdn_sos_tf_mse_plain(*args)
    compare("K5 (GEQ taps) loss", got[0], ref[0], FUSED_LOSS_TOL)
    for n, g_, r_ in zip(names[1:], got[2:], ref[2:]):
        compare(f"K5 (GEQ taps) {n}", g_, r_, FUSED_GRAD_TOL)
    # the 1/3-octave accurate GEQ's 30 sections, whose unscaled running
    # products underflow float32 near DC: K4f, K4b and K5 rescale them
    # after each section, as their plain versions do; every result finite
    bt3, at3 = third_octave_taps()
    label = f"1/3-octave accurate GEQ's taps, K={bt3.shape[1]}"
    H3 = sk.sos_cascade_fwd_kernel(bt3, at3, NFFT)
    check(bool(torch.isfinite(H3).all()), f"K4f ({label}): not finite")
    compare(f"K4f sos_cascade_fwd ({label})", H3,
            sk.sos_cascade_fwd_plain(bt3, at3, NFFT), GEQ_VAL_TOL)
    got = sk.sos_cascade_bwd_kernel(bt3, at3, o["g"], NFFT)
    ref = sk.sos_cascade_bwd_plain(bt3, at3, o["g"], NFFT)
    for n, g_, r_ in zip(("b_bar", "a_bar"), got, ref):
        check(bool(torch.isfinite(g_).all()), f"K4b {n} ({label}): not "
              "finite")
        compare(f"K4b sos_cascade_bwd {n} ({label})", g_, r_, GEQ_GRAD_TOL)
    for fuse_taps in (True, False):
        args = (D, bt3, at3, U6, b, c, X, t, NFFT, False, False, fuse_taps)
        got = sk.fdn_sos_tf_mse_kernel(*args)
        ref = sk.fdn_sos_tf_mse_plain(*args)
        tag = f"K5 fuse_taps={fuse_taps} ({label})"
        check(all(bool(torch.isfinite(g_).all()) for g_ in got
                  if g_ is not None), f"{tag}: not finite")
        compare(f"{tag} loss", got[0], ref[0], FUSED_LOSS_TOL)
        for n, g_, r_ in zip(names[1:], got[2:], ref[2:]):
            compare(f"{tag} {n}", g_, r_, FUSED_GRAD_TOL)

    print(f"  K6 dense_solve at M={M_MAIN} and P={SFDN_SAMPLES}, N={N_MAIN}")
    for shape, systems in o["dense"].items():
        for label, tol in (("random", VAL_TOL), ("model", SFDN_VAL_TOL)):
            A, B = systems[label]
            for tr in (False, True):
                name = "dense_solve_transposed" if tr else "dense_solve"
                e = compare(f"K6 {name} {shape}={A.shape[0]} ({label})",
                            fk.dense_solve_kernel(A, B, tr),
                            fk.dense_solve_plain(A, B, tr), tol)
                if label == "model":  # the systems the slice solves
                    errs[dense_row(name, shape)] = e
    A, B, exact = o["tied"]
    for tr in (False, True):
        name = "dense_solve_transposed" if tr else "dense_solve"
        got = fk.dense_solve_kernel(A, B, tr)
        compare(f"K6 {name} tied pivots ({A.shape[0]} rows)", got,
                fk.dense_solve_plain(A, B, tr), VAL_TOL)
        # the exact systems against the plain version on the CPU, to the bit
        ref = fk.dense_solve_plain(A.cpu(), B.cpu(), tr)
        same = torch.equal(got.cpu()[exact], ref[exact])
        print(f"  K6 {name} on the {int(exact.sum())} exact tied systems: "
              f"equal to the plain version bit for bit: {same}")
        check(same, f"K6 {name}: another pivot than the first maximal row")
    torch.cuda.synchronize()
    return errs


def k2_versus_previous(D, U, B, previous) -> None:
    """K2 against the previous K2, bit for bit, both ways: on the main
    path's operands and on k2_systems at ragged bin counts, whose exact
    tied systems must also equal the plain version on the CPU bit for
    bit; the pivot-vote share of each set at M_MAIN is printed."""
    rng = np.random.default_rng(SEED + 6)
    for tr in (False, True):
        same = torch.equal(fk.fdn_solve_kernel(D, U, B, tr),
                           previous.fdn_solve(D, U, B, tr))
        bins, warps = pivot_vote_share(fk._loop_matrix(D, U, tr))
        print(f"  K2 transpose={tr} on the main path's operands: equal to "
              f"the previous K2 bit for bit: {same}; pivot-vote share: bins "
              f"{bins:.4f}, warps {warps:.4f}")
        check(same, f"K2 transpose={tr}: not the previous kernel's bits")
        for M in K2_RAGGED:
            for label, system in k2_systems(rng, M, N_MAIN, tr).items():
                Dk, Uk, Bk = k2_tensors(system)
                got = fk.fdn_solve_kernel(Dk, Uk, Bk, tr)
                same = torch.equal(got, previous.fdn_solve(Dk, Uk, Bk, tr))
                exact = torch.from_numpy(system[3])
                if exact.any():
                    ref = fk.fdn_solve_plain(Dk.cpu(), Uk.cpu(), Bk.cpu(), tr)
                    same_plain = torch.equal(got.cpu()[exact], ref[exact])
                else:
                    same_plain = True
                rel = rel_err(got, fk.fdn_solve_plain(Dk, Uk, Bk, tr))[1]
                if M == M_MAIN:
                    bins, warps = pivot_vote_share(fk._loop_matrix(Dk, Uk,
                                                                   tr))
                    print(f"  K2 transpose={tr} on {label} systems (M={M}): "
                          f"bit-identical to the previous K2 {same}, exact "
                          f"ones to the plain version {same_plain}, rel "
                          f"{rel:.3e} (tol {VAL_TOL:g}); pivot-vote share: "
                          f"bins {bins:.4f}, warps {warps:.4f}")
                check(same and same_plain and rel < VAL_TOL,
                      f"K2 transpose={tr} on {label} systems at M={M}: "
                      f"previous {same}, plain {same_plain}, rel {rel:.3e}")


def k3_versus_previous(D, U, b, c, tf_bar, previous) -> None:
    """K3f and K3b against the previous K3f and K3b (controls/fdn_tf_prev)
    bit for bit: on the main path's operands, and on k3_systems at ragged
    bin counts and N = 3, 5 and 6 (odd N moves float2 rows), where each
    is also held to its plain version (VAL_TOL on tf and y, GRAD_TOL on
    the cotangents) and K3f's y on the exact tied systems to the plain
    version on the CPU bit for bit; the pivot-vote share of each set at
    M_MAIN, N_MAIN is printed (K3f's forward elimination, K3b's
    transposed one)."""
    tf, y = fk.fdn_tf_fwd_kernel(D, U, b, c)
    same_f = all(torch.equal(g, r) for g, r in
                 zip((tf, y), previous.tf_fwd(D, U, b, c)))
    got = fk.fdn_tf_bwd_kernel(D, U, b, c, y, tf_bar)
    same_b = all(torch.equal(g, r) for g, r in
                 zip(got, previous.tf_bwd(D, U, b, c, y, tf_bar)))
    shares = [pivot_vote_share(fk._loop_matrix(D, U, tr))
              for tr in (False, True)]
    print(f"  K3f and K3b on the main path's operands: equal to the previous "
          f"K3f {same_f}, K3b {same_b} bit for bit; pivot-vote share of "
          f"warps: K3f {shares[0][1]:.4f}, K3b {shares[1][1]:.4f}")
    check(same_f and same_b, "K3f/K3b: not the previous kernels' bits on the "
          "main path's operands")
    rng = np.random.default_rng(SEED + 7)
    for N in K3_NS:
        for M in K2_RAGGED:
            for tr in (False, True):
                name = "K3b" if tr else "K3f"
                for label, system in k3_systems(rng, M, N, tr).items():
                    Dk, Uk, bk, ck, tbk = k3_tensors(system)
                    tf, y = fk.fdn_tf_fwd_kernel(Dk, Uk, bk, ck)
                    tfp, yp = fk.fdn_tf_fwd_plain(Dk, Uk, bk, ck)
                    if tr:
                        got = fk.fdn_tf_bwd_kernel(Dk, Uk, bk, ck, yp, tbk)
                        ref = previous.tf_bwd(Dk, Uk, bk, ck, yp, tbk)
                        plain = fk.fdn_tf_bwd_plain(Dk, Uk, bk, ck, yp, tbk)
                        tol = GRAD_TOL
                    else:
                        got, ref, plain = ((tf, y), previous.tf_fwd(
                            Dk, Uk, bk, ck), (tfp, yp))
                        tol = VAL_TOL
                    same = all(torch.equal(g, r) for g, r in zip(got, ref))
                    rel = max(rel_err(g, r)[1] for g, r in zip(got, plain))
                    exact = torch.from_numpy(system[5])
                    same_plain = True
                    if exact.any() and not tr:
                        y_cpu = fk.fdn_tf_fwd_plain(Dk.cpu(), Uk.cpu(),
                                                    bk.cpu(), ck.cpu())[1]
                        same_plain = torch.equal(y.cpu()[exact],
                                                 y_cpu[exact])
                    if M == M_MAIN and N == N_MAIN:
                        bins, warps = pivot_vote_share(fk._loop_matrix(
                            Dk, Uk, tr))
                        print(f"  {name} on {label} systems (M={M}, N={N}): "
                              f"bit-identical to the previous {name} {same}"
                              + ("" if tr else f", exact ones' y to the "
                                 f"plain version {same_plain}")
                              + f", rel {rel:.3e} (tol {tol:g}); pivot-vote "
                              f"share: bins {bins:.4f}, warps {warps:.4f}")
                    check(same and same_plain and rel < tol,
                          f"{name} on {label} systems at M={M}, N={N}: "
                          f"previous {same}, plain {same_plain}, rel "
                          f"{rel:.3e}")
    print(f"  K3f and K3b at M = {', '.join(map(str, K2_RAGGED))} and N = "
          f"{', '.join(map(str, K3_NS))} on every set: bit-identical to "
          f"the previous kernels, within tolerance of the plain versions")


def dense_row(name: str, shape: str) -> str:
    """K6's row name at the graph step's shape (M) or the masked step's
    (P)."""
    return name if shape == "M" else f"{name}@P{SFDN_SAMPLES}"


def aa_rig(seed: int = SEED, n_mics: int = AA_N, nfft: int = NFFT,
           device="cuda", rir_length: int = AA_RIR):
    """The active-acoustics magnitude rig at full width on the card (phase
    4n: at more microphones)."""
    return build_active_acoustics(
        n_mics=n_mics, n_loudspeakers=AA_L, rir_length=rir_length,
        fir_order=AA_ORDER, nfft=nfft, t60=0.5, solve_method="ge_cached",
        device=device, generator=torch.Generator().manual_seed(seed))


def aa_pair(n_mics: int = AA_N, nfft: int = NFFT, device="cuda"):
    """The rig's impulses on every loudspeaker (1, nfft, L) and the flat
    target (1, M, N)."""
    x = torch.zeros((1, nfft, AA_L), device=device)
    x[:, 0, :] = 1.0
    return x, torch.ones((1, nfft // 2 + 1, n_mics), device=device)


def aa_kernel_operands(model) -> dict:
    """K8's and K9's operands on the rig's own rows at its initial mixer:
    the room rows, rhs and targets, the envelope-folded taps and the
    mixer response rows from the DFT basis."""
    fb = model.get_core().feedback
    order, _, n_mics = fb.param.shape
    o = aa_fused_operands(model, *aa_pair(n_mics, model.nfft,
                                          fb.param.device))
    with torch.no_grad():
        tw = _mixer_taps(fb).contiguous()
        er, ei = (torch.from_numpy(b).to(fb.param.device)
                  for b in aa_dft_basis(order, model.nfft))
        o.update(tw=tw, gr=(tw.T @ er).contiguous(),
                 gi=(tw.T @ ei).contiguous())
    return o


def random_charpolys(rng, N: int, B: int):
    """Coefficient rows (N, B) on the card of the characteristic
    polynomials of B random complex N x N matrices, centred and scaled as
    eigvals_dk does (random coefficients of degree 8 include polynomials
    on which the Durand-Kerner iteration overflows, in the JAX package's
    iteration as in the port's)."""
    A = torch.tensor((rng.normal(size=(B, N, N)) + 1j * rng.normal(
        size=(B, N, N))).astype(np.complex64), device="cuda")
    eye = torch.eye(N, dtype=A.dtype, device="cuda")
    Bm = A - torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)[:, None, None] * eye
    s = torch.sqrt(torch.sum(torch.abs(Bm) ** 2, dim=(-2, -1)) / N)
    c = charpoly(Bm / s[:, None, None]).T
    return torch.real(c).contiguous(), torch.imag(c).contiguous()


def tf32_pass_bound(rows9, pivot, off, N=AA_N, L=AA_L, nfft=NFFT):
    """Elementwise forward-error bound of one TF32 pass of K9 'default''s
    tap contraction ``tb = P2 S2^T`` (order, L N), over n = 2M terms of
    the powers P2 = [Pr, Pi] and the S rows S2 = [Sr, -Si]: each operand
    rounded to TF32 (relative 2^-11 each, so a product within 2^-10 +
    2^-22, a worst case), then accumulated in float32 with the
    probabilistic term sqrt(n) u, u = 2^-24 (Higham and Mary, 2019, at
    lambda = 1; the worst case n u would let operands rounded 8x more
    coarsely, to bfloat16, pass at M = 48001), so |fl(tb) - tb| <=
    (2^-10 + 2^-22 + sqrt(n) u) (|P2| |S2|^T).  The kernel and its plain
    version each lie within that of the exact product of their own
    operands; their S differ by float32 rounding (~1e-6 relative), so the
    two lie within twice the bound, computed here from the plain
    version's operands (the powers are the same integer-phase ones; S is
    the plain version's, with the 'default' mixer response)."""
    hr, hi, tw, rr, ri, t = rows9
    M = hr.shape[-1]
    Pr, Pi = ak.dft_powers(tw.shape[0], M, nfft, off, hr.device)
    P2 = torch.cat([Pr, Pi], dim=1)
    G2 = ak._tf32_matmul(tw.T, P2, "default")
    _, Sr, Si = ak.aa_tf_mse_plain(hr, hi, G2[:, :M], G2[:, M:], rr, ri, t,
                                   N, L, pivot)
    factor = 2.0 ** -10 + 2.0 ** -22 + math.sqrt(2 * M) * 2.0 ** -24
    mag = (P2.double().abs()
           @ torch.cat([Sr, -Si], dim=1).double().abs().T)
    return 2 * factor * mag


def default_cotangent_gap(tag, got, ref, rows9, pivot, off) -> float:
    """K9 'default''s tap cotangent against its plain version, held to
    two bounds.  (1) DEFAULT_SPREAD_FACTOR times the plain version's own
    spread: the same function through the other elimination (pivot
    against no pivot), whose S differs from this one by float32 rounding
    alone.  One TF32 pass rounds every S value to 11 bits, so a rounding
    difference of ~1e-6 in S moves a term by 2^-11 where it crosses a
    rounding boundary; the spread measures that, and it exceeds
    AA_GRAD_TOL at the rig's size.  (2) Elementwise, twice the forward
    error of one TF32 pass (``tf32_pass_bound``), which rests on the
    operands' magnitudes and not on the plain version's noise
    (tf32_bound_gap)."""
    other = ak.aa_taps_tf_mse_plain(*rows9, AA_N, AA_L, NFFT, not pivot, off,
                                    "default")
    err, rel = rel_err(got, ref)
    spread = rel_err(other[1], ref)[1]
    tol = DEFAULT_SPREAD_FACTOR * spread
    print(f"  {tag} tap cotangent: max abs err {err:.3e}, rel {rel:.3e} "
          f"(tol {tol:.3e}: {DEFAULT_SPREAD_FACTOR:g} x the plain version's "
          f"own pivot spread {spread:.3e}; {rel / max(spread, 1e-30):.3f} x)")
    check(rel < tol, f"{tag} tap cotangent: relative error {rel:.3e} >= "
          f"{tol:.3e}")
    tf32_bound_gap(tag, got, ref, rows9, pivot, off)
    return err


def tf32_bound_gap(tag, got, ref, rows9, pivot, off, N=AA_N,
                   nfft=NFFT) -> None:
    """K9 'default''s tap cotangent against its plain version ``ref``,
    elementwise, within twice the forward error of one TF32 pass
    (``tf32_pass_bound``)."""
    bound = tf32_pass_bound(rows9, pivot, off, N, nfft=nfft)
    ratio = float(((got - ref).double().abs() / bound).max())
    print(f"  {tag} tap cotangent against twice one TF32 pass's forward "
          f"error bound, elementwise: max |kernel - plain| / bound "
          f"{ratio:.3e} (tol 1; the bound's max {float(bound.max()):.3e} "
          f"against the cotangent's max {float(ref.abs().max()):.3e})")
    check(ratio <= 1.0, f"{tag} tap cotangent: outside the TF32 forward "
          f"error bound ({ratio:.3e} of it)")


def phase_kernels_aa(o, errs: dict, previous) -> None:
    """K7, K8 and K9 against their plain versions, and K9's tensor-core
    kernel against the previous library's, bit for bit; adds each
    kernel's max abs error on its main-path variant to ``errs``."""
    print(f"  K7 dk_roots at B={DK_B}, degrees 4 and 8, on the char-polys of "
          "random centred and scaled complex matrices (what eigvals_dk and "
          "the eigenvalue step hand it)")
    rng = np.random.default_rng(SEED + 2)
    e = []
    for N in (AA_N, 8):
        cr, ci = random_charpolys(rng, N, DK_B)
        zr, zi = ek.dk_roots_rows(cr, ci)
        pr, pi = ek.dk_roots_rows_plain(cr, ci)
        err = max(float((zr - pr).abs().max()), float((zi - pi).abs().max()))
        print(f"  K7 N={N}: max abs err {err:.3e} (tol {DK_TOL:g}), "
              f"bit-identical {torch.equal(zr, pr) and torch.equal(zi, pi)}")
        check(err < DK_TOL, f"K7 N={N}: max abs error {err:.3e}")
        e.append(err)
    errs["dk_roots"] = max(e)
    print(f"  K8 aa_tf_mse and K9 aa_taps_tf_mse at M={M_MAIN}, N={AA_N}, "
          f"L={AA_L}, order={AA_ORDER} on the rig's rows")
    rows8 = [o[k] for k in ("hr", "hi", "gr", "gi", "rr", "ri", "t")]
    for pivot in (True, False):
        got = ak.aa_tf_mse_kernel(*rows8, AA_N, AA_L, pivot)
        ref = ak.aa_tf_mse_plain(*rows8, AA_N, AA_L, pivot)
        e = [compare(f"K8 pivot={pivot} loss", got[0], ref[0], AA_LOSS_TOL)]
        e += [compare(f"K8 pivot={pivot} {n}", g, r, AA_GRAD_TOL)
              for n, g, r in zip(("S re", "S im"), got[1:], ref[1:])]
        if not pivot:  # the variant aa_fused_step runs
            errs["aa_tf_mse"] = max(e)
    for pivot, off in ((False, 0), (True, 0), (False, AA_OFFSET)):
        rows9 = [o[k][:, off:].contiguous() for k in ("hr", "hi")] + [o["tw"]]
        rows9 += [o[k][:, off:].contiguous() for k in ("rr", "ri", "t")]
        got = {}
        for precision, row in K9_ROWS.items():
            got[precision] = ak.aa_taps_tf_mse_kernel(
                *rows9, AA_N, AA_L, NFFT, pivot, precision, off)
            ref = ak.aa_taps_tf_mse_plain(*rows9, AA_N, AA_L, NFFT, pivot,
                                          off, precision)
            tag = (f"K9 {precision} pivot={pivot} bin_offset={off} "
                   f"(M={rows9[0].shape[1]})")
            e = [compare(f"{tag} loss", got[precision][0], ref[0],
                         AA_LOSS_TOL)]
            if precision == "default":
                e.append(default_cotangent_gap(tag, got[precision][1], ref[1],
                                               rows9, pivot, off))
            else:
                e.append(compare(f"{tag} tap cotangent", got[precision][1],
                                 ref[1], AA_GRAD_TOL))
            if not pivot and off == 0:  # the variant aa_fused_taps_step runs
                errs[row] = max(e)
            if precision != "highest":  # the tensor-core kernel, unchanged
                old = previous.aa_taps(*rows9, AA_N, AA_L, NFFT, pivot,
                                       precision, off)
                same = all(torch.equal(g, r)
                           for g, r in zip(got[precision], old))
                print(f"  {tag}: equal to the previous library's bit for "
                      f"bit: {same}")
                check(same, f"{tag}: not the previous library's bits")
        for precision in ("high", "default"):  # printed, not bounded
            (l_tc, tb_tc), (l_32, tb_32) = got[precision], got["highest"]
            print(f"  K9 {precision} vs highest, pivot={pivot} bin_offset="
                  f"{off}: loss rel {float(abs(l_tc - l_32) / l_32):.3e}, "
                  f"tap cotangent rel {rel_err(tb_tc, tb_32)[1]:.3e}")
    torch.cuda.synchronize()


def phase_kernels_p2(errs: dict, previous) -> dict:
    """The four K10 variants against their plain versions at the
    micro-benchmark's sizes, on its operands and on a seeded random t,
    each beside the previous library's kernel (its distance from the
    plain version printed); adds each
    variant's max abs error to ``errs`` and returns its kernel value on
    the benchmark's operands."""
    t1, c = p2bench.inputs("cuda")
    tr = torch.tensor(np.random.default_rng(SEED + 3).normal(
        size=tuple(t1.shape)).astype(np.float32), device="cuda")
    print(f"  K10 phase2_micro at nfft={p2bench.NFFT}, P={p2bench.P}, "
          f"K={p2bench.K}, N={p2bench.N}, {t1.shape[1]} bins")
    values = {}
    for v in pm.VARIANTS:
        e = []
        for label, t in (("t of ones", t1), ("random t", tr)):
            got = pm.phase2_micro(v, t, c, p2bench.NFFT)
            ref = pm.phase2_micro_plain(v, t, c, p2bench.NFFT)
            scale = pm.phase2_micro_plain(v, t, c, p2bench.NFFT,
                                          magnitude=True)
            err = (got - ref).abs()
            rel = float((err / scale.clamp_min(1e-30)).max())
            print(f"  K10 {v} ({label}): kernel {got.tolist()}, plain "
                  f"{ref.tolist()}, max abs err {float(err.max()):.3e}, "
                  f"{rel:.3e} of the terms' magnitudes (tol {P2_TOL:g})")
            check(rel <= P2_TOL, f"K10 {v} ({label}): {rel:.3e} > {P2_TOL}")
            old = previous.phase2(v, t, c, p2bench.NFFT)
            old_rel = float(((old - ref).abs()
                             / scale.clamp_min(1e-30)).max())
            print(f"  K10 {v} ({label}): the previous kernel "
                  f"{old.tolist()}, {old_rel:.3e} of the terms' magnitudes "
                  "from the plain version")
            e.append(float(err.max()))
            if label == "t of ones":
                values[v] = got
        errs[f"phase2_{v}"] = max(e)
    torch.cuda.synchronize()
    return values


def phase_micro(card: str, values: dict) -> dict:
    """The micro-benchmark path: bench_phase2_micro.run for each K10
    variant on the card.  Returns each row's launches in the run."""
    print(f"phase 4e the phase-2 micro-benchmark: bench_phase2_micro.run "
          f"on {card}")
    launches = {}
    for v in pm.VARIANTS:
        pm.reset_launch_counts()
        value, _ = p2bench.run(v)
        counts = dict(pm.LAUNCHES)
        launches[f"phase2_{v}"] = counts[v]
        check(counts == {k: (counts[v] if k == v else 0) for k in counts}
              and counts[v] > 0, f"run({v!r}) should launch its kernel "
              f"and no other: {counts}")
        check(torch.equal(value, values[v]), f"run({v!r}) gave "
              f"{value.tolist()}, phase 2's kernel {values[v].tolist()}")
    print(f"  launches in the runs: {launches}")
    return launches


def grads_of(model):
    named = jax_named_tensors(model)
    return {k: v.grad.detach().clone() for k, v in named.items()
            if v.requires_grad}


def loss_and_grads(model, loss_fn, x, t):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, x, t)
    loss.backward()
    return float(loss.detach()), grads_of(model)


def fused_tf_steps(model):
    """``run(n)``: n Adam steps of colorless_train_step(model,
    fused_tf=True) (K3f forward, K3b backward) on the impulse -> flat pair;
    returns their losses, on the device."""
    step, _ = colorless_train_step(model, fused_tf=True)
    x, t = colorless_pair(model)
    return lambda n: [step(x, t) for _ in range(n)]


def fused_evals(model):
    """``run(n)``: n calls of colorless_freq_response_fused(model) (K3f)
    under no_grad, each result dropped but the last, which it returns."""
    def run(n):
        H = None
        with torch.no_grad():
            for _ in range(n):
                H = colorless_freq_response_fused(model)
        return H

    return run


def phase_slice(card: str) -> tuple:
    """The colorless slice: the graph routes, the fused response and the
    fused-tf loss agree; FUSED_TF_STEPS fused-tf steps and FUSED_EVALS
    fused responses, then FIT_STEPS colorless_fit steps, each timed.
    Returns the launch counts of this phase and the untraced ms per fit
    step, per fused-tf step and per fused response."""
    print(f"phase 3 the slice: build_colorless_fdn(nfft={NFFT}) on cuda")
    model = colorless_model(SEED)
    model_k2 = build_colorless_fdn(nfft=NFFT, solve_method="pallas",
                                   device="cuda",
                                   generator=torch.Generator().manual_seed(1))
    model_k2.load_state_dict(model.state_dict())
    x, t = colorless_pair(model)

    reset_counts()
    l_ge, g_ge = loss_and_grads(model, colorless_loss, x, t)
    l_k2, g_k2 = loss_and_grads(model_k2, colorless_loss, x, t)
    print(f"  graph loss: ge {l_ge:.7f}, pallas (K2) {l_k2:.7f}")
    check(np.isfinite(l_ge) and abs(l_k2 - l_ge) / l_ge < 1e-5,
          "K2 graph loss differs from the 'ge' graph loss")
    for k in g_ge:
        compare(f"K2 graph grad {k}", g_k2[k], g_ge[k], 1e-4)

    with torch.no_grad():
        H_graph = model.get_freq_response()
        H_fused = colorless_freq_response_fused(model)
    check(H_fused.shape == H_graph.shape == (1, NFFT // 2 + 1, 1),
          "response shapes")
    compare("K3f fused response vs get_freq_response", H_fused, H_graph,
            1e-5)

    l_tf, g_tf = loss_and_grads(model, colorless_loss_fused_tf, x, t)
    print(f"  fused-tf loss (K3f/K3b) {l_tf:.7f}")
    check(abs(l_tf - l_ge) / l_ge < 1e-4, "fused-tf loss differs")
    for k in g_ge:
        compare(f"K3b fused-tf grad {k}", g_tf[k], g_ge[k], 5e-3)
    launches = {"fdn_solve": fk.LAUNCHES["fdn_solve"]}

    # the fused-tf step: a warm-up on a copy, then the timed steps from the
    # graph model's weights
    fused_tf_steps(colorless_model(2))(10)
    model_tf = colorless_model(1)
    model_tf.load_state_dict(model.state_dict())
    run = fused_tf_steps(model_tf)
    reset_counts()
    losses, seconds = timed(lambda: run(FUSED_TF_STEPS))
    counts = {k: v for k, v in fk.LAUNCHES.items() if v}
    print(f"  launches in the timed fused-tf steps: {counts}")
    check(counts == {"fdn_tf_fwd": FUSED_TF_STEPS,
                     "fdn_tf_bwd": FUSED_TF_STEPS},
          f"the fused-tf step should launch K3f and K3b once each per step: "
          f"{counts}")
    launches.update(counts)
    hist = torch.stack(losses).cpu().numpy()
    tf_ms = seconds * 1e3 / FUSED_TF_STEPS
    rel = abs(hist[0] - l_ge) / l_ge
    print(f"  colorless_train_step(fused_tf=True) (K3f, backward K3b): loss "
          f"{hist[0]:.7f} -> {hist[-1]:.7f} over {FUSED_TF_STEPS} steps, "
          f"first loss vs the graph loss rel {rel:.3e} (tol 1e-04); "
          f"{FUSED_TF_STEPS / seconds:.1f} steps/s ({tf_ms:.4f} ms/step, "
          f"CUDA events, after a 10-step warm-up) on {card}")
    check(bool(np.isfinite(hist).all()), "fused-tf step loss is not finite")
    check(rel < 1e-4, "first fused-tf step loss differs from the graph loss")
    check(hist[-1] < hist[0], "the fused-tf steps' loss did not fall")

    # the fused response (the JAX bench's secondary metric): a warm-up,
    # then FUSED_EVALS timed calls on the graph model
    run = fused_evals(model)
    run(10)
    reset_counts()
    H_fused, seconds = timed(lambda: run(FUSED_EVALS))
    counts = {k: v for k, v in fk.LAUNCHES.items() if v}
    check(counts == {"fdn_tf_fwd": FUSED_EVALS},
          f"the fused response should launch K3f once per call: {counts}")
    launches["fdn_tf_fwd"] += counts["fdn_tf_fwd"]
    compare(f"K3f fused response (the last of {FUSED_EVALS}) vs "
            f"get_freq_response", H_fused, H_graph, 1e-5)
    eval_ms = seconds * 1e3 / FUSED_EVALS
    print(f"  colorless_freq_response_fused (K3f, no_grad): "
          f"{FUSED_EVALS / seconds:.1f} evals/s ({eval_ms:.4f} ms/eval, "
          f"CUDA events, {FUSED_EVALS} calls after 10) on {card}")

    # colorless_fit: a short warm-up on a copy, then the timed run
    colorless_fit(colorless_model(2), n_steps=10)
    reset_counts()
    (model, hist), seconds = timed(lambda: colorless_fit(model,
                                                         n_steps=FIT_STEPS))
    launches["fdn_tf_mse"] = fk.LAUNCHES["fdn_tf_mse"]
    check(hist.shape == (FIT_STEPS,) and bool(np.isfinite(hist).all()),
          "colorless_fit loss history is not finite")
    print(f"  colorless_fit (K1, no pivot): loss {hist[0]:.7f} -> "
          f"{hist[-1]:.7f} over {FIT_STEPS} steps")
    check(abs(hist[0] - l_ge) / l_ge < 1e-4,
          "first fit loss differs from the graph loss")
    check(hist[-1] < hist[0], "colorless_fit loss did not decrease")
    print(f"  colorless_fit: {FIT_STEPS / seconds:.1f} steps/s "
          f"({seconds * 1e3 / FIT_STEPS:.4f} ms/step, CUDA events, after "
          f"a 10-step warm-up) on {card}")
    print(f"  launches in phase 3 (K2 in the graph calls, K3f and K3b in the "
          f"timed fused-tf steps and K3f in the timed fused responses, K1 in "
          f"the timed fit): {launches}")
    check(launches["fdn_tf_mse"] == FIT_STEPS,
          "colorless_fit should launch K1 once per step")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return launches, seconds * 1e3 / FIT_STEPS, tf_ms, eval_ms


def time_impulse_pair(nfft: int, device="cuda"):
    """The time-domain impulse input (1, nfft, 1) and the flat target
    (1, M, 1); ``colorless_pair`` gives the (1, M, 1) spectral pair."""
    x = torch.zeros((1, nfft, 1), device=device)
    x[:, 0, :] = 1.0
    return x, torch.ones((1, nfft // 2 + 1, 1), device=device)


def att_model(seed: int = SEED, **routes):
    return build_attenuated_fdn(
        nfft=NFFT, octave_interval=1, cache_delays=True, device="cuda",
        generator=torch.Generator().manual_seed(seed), **routes)


def phase_attenuated(card: str):
    """The attenuated slice: the graph routes and the fused step agree,
    then ATT_STEPS Adam steps through K5 and ATT_GRAPH_STEPS graph steps
    through K4 and K2.  Returns the launch counts of this phase, the
    untraced ms per fused and per graph training step, and K2's operands
    in the graph step with their pivot-vote shares ({"forward" or
    "transposed": (D, U, B, (bins, warps))})."""
    print(f"phase 4 the attenuated slice: build_attenuated_fdn(nfft={NFFT}, "
          f"octave_interval=1, cache_delays=True) on cuda")
    model = att_model()
    model_k = att_model(seed=1, solve_method="pallas",
                        cascade_backend="pallas")
    model_k.load_state_dict(model.state_dict())
    x, t = time_impulse_pair(NFFT)

    reset_counts()
    l_ge, g_ge = loss_and_grads(model, attenuated_loss, x, t)
    # K2's operands in the graph loss, as the first timed graph step sees
    # them: its pivot-vote share, forward and transposed
    kernel, seen = fk.fdn_solve_kernel, []

    def keep(D, U, B, transpose=False):
        seen.append((D.detach().clone(), U.detach().clone(),
                     B.detach().clone(), transpose))
        return kernel(D, U, B, transpose)

    fk.fdn_solve_kernel = keep
    try:
        l_k, g_k = loss_and_grads(model_k, attenuated_loss, x, t)
    finally:
        fk.fdn_solve_kernel = kernel
    order = [tr for *_, tr in seen]
    check(order == [False, True], "the graph loss should run K2 forward, "
          f"then transposed (transpose flags {order})")
    k2_graph = {"transposed" if tr else "forward": (
        Dg, Ug, Bg, pivot_vote_share(fk._loop_matrix(Dg, Ug, tr)))
        for Dg, Ug, Bg, tr in seen}
    print(f"  K2 pivot-vote share on the graph step's own operands "
          f"(M={seen[0][0].shape[0]}, N={seen[0][0].shape[1]}; the share of "
          f"the steps k < N - 1 at which a bin, and a warp of 32, pivots): "
          + "; ".join(f"{k} bins {v[3][0]:.4f}, warps {v[3][1]:.4f}"
                      for k, v in k2_graph.items()))
    l_f, g_f = loss_and_grads(model, attenuated_loss_fused_step, x, t)
    print(f"  loss: graph xla/ge {l_ge:.7f}, graph pallas/pallas (K4f + K2) "
          f"{l_k:.7f}, fused step (K5) {l_f:.7f}")
    check(np.isfinite(l_ge), "the attenuated graph loss is not finite")
    for label, loss, grads in (("K4 + K2 graph", l_k, g_k),
                               ("K5 fused step", l_f, g_f)):
        check(abs(loss - l_ge) / l_ge < FUSED_LOSS_TOL,
              f"{label} loss differs from the xla/ge graph loss")
        for k in g_ge:
            compare(f"{label} grad {k}", grads[k], g_ge[k], FUSED_GRAD_TOL)

    launches = {"fdn_solve": fk.LAUNCHES["fdn_solve"]}

    # training through K5: a short warm-up on a copy, then the timed run
    warm = att_model(seed=2)
    step, _ = attenuated_train_step(warm, lr=ATT_LR, fused_step=True)
    for _ in range(10):
        step(x, t)
    step, _ = attenuated_train_step(model, lr=ATT_LR, fused_step=True,
                                    step_pivot=False)
    reset_counts()
    losses, seconds = timed(lambda: [step(x, t) for _ in range(ATT_STEPS)])
    per_step = {k: v / ATT_STEPS
                for k, v in {**fk.LAUNCHES, **sk.LAUNCHES}.items()}
    print(f"  launches per training step: {per_step}")
    launches["fdn_sos_tf_mse"] = sk.LAUNCHES["fdn_sos_tf_mse"]
    check(launches["fdn_sos_tf_mse"] == ATT_STEPS,
          "attenuated_train_step should launch K5 once per step")
    hist = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(hist).all()), "attenuated training loss is not "
          "finite")
    print(f"  attenuated_train_step (K5, no pivot, lr {ATT_LR:g}): loss "
          f"{hist[0]:.7f} -> {hist[-1]:.7f} over {ATT_STEPS} steps")
    check(abs(hist[0] - l_f) / l_f < 1e-5,
          "first training loss differs from the fused-step loss")
    check(hist[-1] < hist[0], "attenuated training loss did not decrease")
    print(f"  attenuated_train_step: {ATT_STEPS / seconds:.1f} steps/s "
          f"({seconds * 1e3 / ATT_STEPS:.4f} ms/step, CUDA events, after a "
          f"10-step warm-up) on {card}")
    step_ms = seconds * 1e3 / ATT_STEPS

    # the graph step through K4 and K2 (bench.py's mode='pallas'): a
    # warm-up on a copy, then the timed steps from model_k's weights
    warm = att_model(seed=2, solve_method="pallas", cascade_backend="pallas")
    step, _ = attenuated_train_step(warm, lr=ATT_LR)
    for _ in range(10):
        step(x, t)
    step, _ = attenuated_train_step(model_k, lr=ATT_LR)
    reset_counts()
    losses, seconds = timed(lambda: [step(x, t)
                                      for _ in range(ATT_GRAPH_STEPS)])
    counts = nonzero_counts()
    want = {"fdn_solve": 2 * ATT_GRAPH_STEPS,
            "sos_cascade_fwd": ATT_GRAPH_STEPS,
            "sos_cascade_bwd": ATT_GRAPH_STEPS}
    print(f"  launches in the timed graph steps: {counts}")
    check(counts == want, "the graph step should launch K4f, K4b once and "
          f"K2 twice (forward, transposed) per step: {counts}")
    launches["fdn_solve"] += counts["fdn_solve"]
    launches["sos_cascade_fwd"] = counts["sos_cascade_fwd"]
    launches["sos_cascade_bwd"] = counts["sos_cascade_bwd"]
    hist = torch.stack(losses).cpu().numpy()
    graph_ms = seconds * 1e3 / ATT_GRAPH_STEPS
    rel = abs(hist[0] - l_k) / l_k
    print(f"  attenuated_train_step (graph, K4f + K2, backward K4b + K2 "
          f"transposed, lr {ATT_LR:g}): loss {hist[0]:.7f} -> {hist[-1]:.7f} "
          f"over {ATT_GRAPH_STEPS} steps, first loss vs the pallas/pallas "
          f"graph loss rel {rel:.3e} (tol 1e-05), {graph_ms:.4f} ms/step "
          f"(CUDA events, after a 10-step warm-up) on {card}")
    check(bool(np.isfinite(hist).all()), "graph step loss is not finite")
    check(rel < 1e-5, "first graph step loss differs from the graph loss")
    check(hist[-1] < hist[0], "the graph steps' loss did not fall")
    print(f"  launches in phase 4 (K2 in the graph calls and the timed "
          f"graph steps, K4 in the timed graph steps, K5 in the timed fused "
          f"steps): {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the attenuated path")
    return launches, step_ms, graph_ms, k2_graph


def _k6_counts() -> dict:
    return {k: fk.LAUNCHES[k] for k in K6}


def quarter_means(hist) -> tuple[float, float]:
    """The mean loss of a history's first and last quarter: each
    scattering step reads another mask, so single steps are noisy, and
    the loss falls when the second mean is below the first."""
    q = max(1, len(hist) // 4)
    return float(np.mean(hist[:q])), float(np.mean(hist[-q:]))


def phase_scattering(card: str):
    """The scattering slice: the graph route through K6 against 'ge', the
    masked step through K6 against the graph loss and 'ge_cached', then
    SFDN_FIT_STEPS masked steps (sfdn_fit) and SFDN_GRAPH_STEPS graph
    steps.  Returns K6's launches at each shape ({row: n}) and the
    untraced ms per masked step."""
    print(f"phase 4b the scattering slice: build_colorless_sfdn(nfft={NFFT}, "
          f"solve_method='pallas') on cuda")
    model = sfdn_model()
    loop = model.get_core().feedback_loop
    mapping = loop.feedback.map_filter
    print(f"  scattering feedback: {mapping.n_stages} stages, FIR of "
          f"{mapping.output_length} taps (shifts {mapping.shifts}, m_L "
          f"{mapping.m_L}, m_R {mapping.m_R})")
    x, t = sfdn_pair()
    ml, sparsity = sfdn_masks(), sparsity_loss()
    mask = ml.masks_for_cycle(0)[0]

    def graph_loss(m, x, t):  # sfdn_train_step's objective at step 0
        est = m(x)
        return ml(est, t, step=0) + 0.2 * sparsity(est, t, m)

    def masked_loss(method):
        return lambda m, x, t: sfdn_masked_loss(m, m.input_layer(x), t, mask,
                                                solve_method=method)

    # the graph route: K6 on the (1, M, N, N) loop and its transpose
    reset_counts()
    l_k6, g_k6 = loss_and_grads(model, graph_loss, x, t)
    check(_k6_counts() == {"dense_solve": 1, "dense_solve_transposed": 1},
          f"the graph step should launch K6 once each way: {fk.LAUNCHES}")
    loop.solve_method = "ge"
    l_ge, g_ge = loss_and_grads(model, graph_loss, x, t)
    loop.solve_method = "pallas"
    print(f"  graph loss at mask 0: pallas (K6) {l_k6:.7f}, ge {l_ge:.7f}")
    check(np.isfinite(l_ge) and abs(l_k6 - l_ge) / l_ge < SFDN_LOSS_TOL,
          "K6 graph loss differs from the 'ge' graph loss")
    for k in g_ge:
        compare(f"K6 graph grad {k}", g_k6[k], g_ge[k], SFDN_GRAD_TOL)

    # the graph step: a warm-up on a copy, then the timed steps from the
    # same initial weights and masks as above
    step, _ = sfdn_train_step(sfdn_model(seed=2), n_samples=SFDN_SAMPLES,
                              generator=torch.Generator().manual_seed(2))
    for i in range(3):
        step(x, t, i)
    step, _ = sfdn_train_step(sfdn_model(), n_samples=SFDN_SAMPLES,
                              generator=torch.Generator().manual_seed(SEED))
    reset_counts()
    losses, seconds = timed(lambda: [step(x, t, i)
                                      for i in range(SFDN_GRAPH_STEPS)])
    launches = {dense_row(k, "M"): n for k, n in _k6_counts().items()}
    hist = torch.stack(losses).cpu().numpy()
    first, last = quarter_means(hist)
    print(f"  sfdn_train_step (graph, K6 at M={NFFT // 2 + 1}): loss "
          f"{hist[0]:.7f} -> {hist[-1]:.7f} (quarter means {first:.7f} -> "
          f"{last:.7f}) over {SFDN_GRAPH_STEPS} steps, "
          f"{seconds * 1e3 / SFDN_GRAPH_STEPS:.4f} ms/step (CUDA events, "
          f"after a 3-step warm-up) on {card}")
    check(bool(np.isfinite(hist).all()), "graph step loss is not finite")
    check(abs(hist[0] - l_k6) / l_k6 < SFDN_LOSS_TOL,
          "first graph step loss differs from the graph loss")
    check(last < first, "the graph steps' loss did not fall")

    # the masked route: K6 on the (1, P, N, N) loop at the mask's bins
    l_m, g_m = loss_and_grads(model, masked_loss("pallas"), x, t)
    l_mc, g_mc = loss_and_grads(model, masked_loss("ge_cached"), x, t)
    print(f"  masked loss at mask 0: pallas (K6) {l_m:.7f}, ge_cached "
          f"{l_mc:.7f}")
    check(abs(l_m - l_mc) / l_mc < SFDN_LOSS_TOL,
          "K6 masked loss differs from the 'ge_cached' masked loss")
    for k in g_mc:
        compare(f"K6 masked grad {k} vs ge_cached", g_m[k], g_mc[k],
                SFDN_GRAD_TOL)

    # both routes against the same losses in float64 (plain solves)
    m64 = sfdn_model_f64(model)
    x64, t64 = x.double(), t.double()
    l64_graph, g64 = loss_and_grads(m64, graph_loss, x64, t64)
    with torch.no_grad():
        l64_masked = float(masked_loss("ge")(m64, x64, t64))
    gaps = {"masked vs graph": (l_m, l_k6, SFDN_ROUTE_LOSS_TOL),
            "float64 masked vs graph": (l64_masked, l64_graph, SFDN_F64_TOL),
            "masked vs float64": (l_m, l64_masked, None),
            "graph vs float64": (l_k6, l64_graph, None)}
    print(f"  float64 loss at mask 0: graph {l64_graph:.10f}, masked "
          f"{l64_masked:.10f}")
    for label, (got, ref, tol) in gaps.items():
        rel = abs(got - ref) / ref
        print(f"  loss {label}: rel {rel:.3e}"
              + ("" if tol is None else f" (tol {tol:g})"))
        check(tol is None or rel < tol, f"loss {label}: {rel:.3e} >= {tol}")
    for k in g64:
        for label, g in (("graph", g_k6), ("masked", g_m)):
            err, rel = rel_err(g[k], g64[k].float())
            print(f"  {label} grad {k} vs float64: max abs err {err:.3e}, "
                  f"rel {rel:.3e}")

    # the masked step through sfdn_fit, likewise
    sfdn_fit(sfdn_model(seed=2), n_steps=10, n_samples=SFDN_SAMPLES,
             masked=True, solve_method="pallas",
             generator=torch.Generator().manual_seed(2))
    reset_counts()
    (_, hist), seconds = timed(lambda: sfdn_fit(
        model, n_steps=SFDN_FIT_STEPS, n_samples=SFDN_SAMPLES, masked=True,
        solve_method="pallas", generator=torch.Generator().manual_seed(SEED),
        steps_per_call=SFDN_FIT_STEPS))
    launches.update({dense_row(k, "P"): n for k, n in _k6_counts().items()})
    masked_ms = seconds * 1e3 / SFDN_FIT_STEPS
    first, last = quarter_means(hist)
    print(f"  sfdn_fit(masked=True, 'pallas', K6 at P={SFDN_SAMPLES}): loss "
          f"{hist[0]:.7f} -> {hist[-1]:.7f} (quarter means {first:.7f} -> "
          f"{last:.7f}) over {SFDN_FIT_STEPS} steps, {masked_ms:.4f} "
          f"ms/step (CUDA events, after a 10-step warm-up) on {card}")
    check(hist.shape == (SFDN_FIT_STEPS,) and bool(np.isfinite(hist).all()),
          "sfdn_fit loss history is not finite")
    check(abs(hist[0] - l_m) / l_m < SFDN_LOSS_TOL,
          "first sfdn_fit loss differs from the masked loss")
    check(last < first, "the sfdn_fit loss did not fall")
    print(f"  K6 launches in the timed runs of phase 4b: {launches}")
    for name in K6:  # one each way per step, at the step's own shape
        check(launches[dense_row(name, "M")] == SFDN_GRAPH_STEPS,
              f"sfdn_train_step should launch {name} once per step")
        check(launches[dense_row(name, "P")] == SFDN_FIT_STEPS,
              f"sfdn_fit(masked=True) should launch {name} once per step")
    return launches, masked_ms


def phase_aa_magnitude(card: str, model):
    """The active-acoustics magnitude slice: the graph loss, then
    AA_K9_STEPS steps through K9 and AA_K8_STEPS through K8 from the same
    weights.  Returns the launches of the timed runs and the untraced
    ms/step of each."""
    print(f"phase 4c active acoustics, magnitude: build_active_acoustics("
          f"{AA_N} x {AA_L}, rir_length={AA_RIR}, fir_order={AA_ORDER}, "
          f"nfft={NFFT}, solve_method='ge_cached') on cuda")
    x, t = aa_pair()
    with torch.no_grad():
        l_graph = float(torch.mean((torch.abs(model(x)) - t) ** 2))
    print(f"  graph loss (ge_cached): {l_graph:.7f}")
    check(np.isfinite(l_graph), "the graph loss is not finite")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    # each kernel's first loss in its plain version on the same weights
    o = aa_kernel_operands(model)
    plain = {K9_ROWS[p]: float(ak.aa_taps_tf_mse_plain(
        *(o[k] for k in ("hr", "hi", "tw", "rr", "ri", "t")), AA_N, AA_L,
        NFFT, precision=p)[0]) for p in K9_ROWS}
    plain["aa_tf_mse"] = float(ak.aa_tf_mse_plain(
        *(o[k] for k in ("hr", "hi", "gr", "gi", "rr", "ri", "t")), AA_N,
        AA_L)[0])
    launches, step_ms = {}, {}
    runs = [(K9_ROWS[p], k9_build(p), AA_K9_STEPS)
            for p in ("high", "default", "highest")]
    for name, build, steps in runs + [("aa_tf_mse", aa_fused_step,
                                       AA_K8_STEPS)]:
        model.load_state_dict(state)
        step, _ = build(model, x, t, lr=AA_LR)
        ak.reset_launch_counts()
        losses, seconds = timed(lambda: [step() for _ in range(steps)])
        counts = dict(ak.LAUNCHES)
        launches[name] = counts[name]
        hist = torch.stack(losses).cpu().numpy()
        rel = abs(hist[0] - l_graph) / l_graph
        rel_plain = abs(hist[0] - plain[name]) / plain[name]
        step_ms[name] = seconds * 1e3 / steps
        print(f"  {build.__name__} ({name}, no pivot, lr {AA_LR:g}): loss "
              f"{hist[0]:.7f} -> {hist[-1]:.7f} over {steps} steps, first "
              f"loss vs graph rel {rel:.3e} (tol {STEP_GRAPH_TOL[name]:g}), "
              f"vs plain rel {rel_plain:.3e} (tol {AA_LOSS_TOL:g}), "
              f"{step_ms[name]:.4f} ms/step (CUDA events, no warm-up) on "
              f"{card}; launches {counts}")
        check(bool(np.isfinite(hist).all()), f"{name} loss is not finite")
        check(rel < STEP_GRAPH_TOL[name],
              f"{name}: first loss differs from the graph loss")
        check(rel_plain < AA_LOSS_TOL,
              f"{name}: first loss differs from its plain version's")
        check(hist[-1] < hist[0], f"{name}: the loss did not fall")
        check(counts == {k: (steps if k == name else 0) for k in counts},
              f"{name}'s steps should launch its kernel once per step")
    model.load_state_dict(state)
    return launches, step_ms


def k9_build(precision: str):
    """aa_fused_taps_step at ``precision``; the default is 'high'."""
    def build(model, x, t, lr):
        return aa_fused_taps_step(model, x, t, lr=lr, precision=precision)
    build.__name__ = f"aa_fused_taps_step(precision={precision!r})"
    return build


def phase_aa_evs(card: str):
    """The active-acoustics eigenvalue slice: ActiveAcoustics at full
    width, mse_evs on the F_MM graph at the first partition, then
    aa_evs_fit over the same partitions.  Returns the rig, K7's launches,
    the untraced ms/step, the coefficient rows of the first step and K7's
    error on them against its plain version."""
    print(f"phase 4d active acoustics, eigenvalues: ActiveAcoustics(1, "
          f"{AA_N}, {AA_L}, 1, FIR_order={AA_ORDER}, rir_length={AA_RIR}, "
          f"wgn_RT=1.0, room_t60=0.5, nfft={NFFT}) on cuda")
    M = NFFT // 2 + 1
    t0 = time.perf_counter()
    aa = ActiveAcoustics(n_S=1, n_M=AA_N, n_L=AA_L, n_A=1, nfft=NFFT,
                         FIR_order=AA_ORDER, rir_length=AA_RIR, wgn_RT=1.0,
                         room_t60=0.5, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"  built in {time.perf_counter() - t0:.1f} s with its GBI "
          f"(torch.linalg.eigvals on ({M}, {AA_N}, {AA_N})): G = "
          f"{float(aa.G.param[0]):.6f}")
    tg = torch.full((M, AA_N), AA_TARGET, device="cuda")
    crit = mse_evs(iter_num=AA_ITER_NUM, freq_points=M,
                   generator=torch.Generator().manual_seed(SEED),
                   device="cuda")
    x = torch.zeros((1, NFFT, AA_N), device="cuda")
    x[:, 0, :] = 1.0
    with torch.no_grad():
        l_ref = float(crit(aa(x), tg[None], step=0))
    # the coefficient rows of the first step, kept as K7 receives them
    first, kernel = [], ek.dk_roots_rows

    def keep_first(cr, ci, iters=DK_ITERS):
        if not first:
            first.append((cr.detach().clone(), ci.detach().clone()))
        return kernel(cr, ci, iters)

    ek.dk_roots_rows = keep_first
    try:
        ek.reset_launch_counts()
        (_, hist), seconds = timed(lambda: aa_evs_fit(
            aa, tg, n_steps=AA_EVS_STEPS, lr=AA_LR, masks=crit.mask_indices))
        launches = ek.LAUNCHES["dk_roots"]
    finally:
        ek.dk_roots_rows = kernel
    step_ms = seconds * 1e3 / AA_EVS_STEPS
    q0, q1 = quarter_means(hist)
    rel = abs(hist[0] - l_ref) / l_ref
    n_bins = crit.mask_indices.shape[1]
    print(f"  mse_evs on the F_MM graph at partition 0 ({n_bins} bins, "
          f"{crit.n_masks} partitions): {l_ref:.7f}; "
          f"aa_evs_fit (K7, lr {AA_LR:g}): loss {hist[0]:.7f} -> "
          f"{hist[-1]:.7f} (quarter means {q0:.7f} -> {q1:.7f}) over "
          f"{AA_EVS_STEPS} steps, first loss rel {rel:.3e} (tol "
          f"{AA_GRAPH_TOL:g}), {step_ms:.4f} ms/step (CUDA events) on "
          f"{card}; K7 launches {launches}")
    check(hist.shape == (AA_EVS_STEPS,) and bool(np.isfinite(hist).all()),
          "aa_evs_fit loss history is not finite")
    check(rel < AA_GRAPH_TOL, "the first eigenvalue step's loss differs "
          "from mse_evs on the graph")
    check(q1 < q0, "the aa_evs_fit loss did not fall")
    check(launches == AA_EVS_STEPS, "aa_evs_fit should launch K7 once per "
          "step")
    cr, ci = first[0]
    zr, zi = ek.dk_roots_rows(cr, ci)
    pr, pi = ek.dk_roots_rows_plain(cr, ci)
    err = max(float((zr - pr).abs().max()), float((zi - pi).abs().max()))
    print(f"  K7 on the rig's centred and scaled char-polys of step 0 "
          f"({tuple(cr.shape)}): max abs err {err:.3e} (tol {DK_TOL:g}), "
          f"bit-identical {torch.equal(zr, pr) and torch.equal(zi, pi)}")
    check(err < DK_TOL, f"K7 on the rig's char-polys: {err:.3e}")
    return aa, launches, step_ms, (cr, ci), err


def paved_trainer(model, fused: str = "auto", mse=None, sparsity=True,
                  lr: float = 1e-3) -> Trainer:
    """The e8 colorless example's Trainer: ``mse`` (default mse_loss) and,
    with ``sparsity``, 0.2 x sparsity_loss; one epoch, no checkpoints."""
    tr = Trainer(model, max_epochs=1, lr=lr, log=False, fused=fused)
    tr.register_criterion(mse_loss(nfft=NFFT) if mse is None else mse, 1)
    if sparsity:
        tr.register_criterion(sparsity_loss(), 0.2, requires_model=True)
    return tr


def gated_trainer(model, x, t, name: str, **kw) -> Trainer:
    """``paved_trainer(model, **kw)`` with its dispatch gate run on (x, t);
    checks that it took the fused path ``name``."""
    tr = paved_trainer(model, **kw)
    tr._maybe_gate_fused(x, t)
    check(tr.fused_path == name,
          f"Trainer's fused_path is {tr.fused_path!r}, not {name!r}")
    return tr


def colorless_plain_total(model, x, t) -> float:
    """The colorless Trainer's fused objective through K1's plain version
    (no pivot) on the model's current weights: mse + 0.2 sparsity."""
    with torch.no_grad():
        D, U, b, c = extract_siso_tf_operands(model)
        X = torch.fft.rfft(x[0, :, 0], n=model.nfft)
        mse = fk.fdn_tf_mse_plain(D.contiguous(), U, b, c, X, t[0, :, 0],
                                  False, False)[0]
        return float(mse + 0.2 * sparsity_loss()(None, None, model))


def att_abs_model(seed: int = SEED):
    """The attenuated FDN with an |.| output layer, so that mse_loss is its
    magnitude objective (the fused step's)."""
    m = att_model(seed=seed)
    return system.Shell(core=m.core, input_layer=m.input_layer,
                        output_layer=dsp.Transform(torch.abs))


def counted(mod, run):
    """(run(), the launches of ``mod``'s kernels in it, nonzero ones)."""
    mod.reset_launch_counts()
    out = run()
    return out, {k: v for k, v in mod.LAUNCHES.items() if v}


def trainer_steps():
    """``run(n)``: n Trainer.train_step calls of a gated colorless Trainer
    (colorless_fused_step: K1) on the impulse -> flat pair."""
    model = colorless_model(3)
    x, t = colorless_pair(model)
    tr = gated_trainer(model, x, t, "colorless_fused_step")
    return lambda n: [tr.train_step((x, t)) for _ in range(n)]


def phase_paved_road(card: str):
    """The Trainer path at full width, the e8 flow: the fused dispatch on
    the colorless, attenuated and scattering FDNs, fit_scan, the graph
    route through K2 and a checkpoint round trip.  Returns the launch
    counts of its runs and the untraced ms per Trainer.train_step."""
    M = NFFT // 2 + 1
    print(f"phase 4f the paved road: DatasetColorless(expand={PAVED_EXPAND})"
          f" -> load_dataset(batch_size=1, split=0.8, seed=0) -> Trainer("
          f"fused='auto') with mse + 0.2 sparsity, nfft={NFFT}, on cuda")
    launches = {}

    # 1. colorless, the e8 flow: one epoch, then fit_scan
    model = colorless_model(SEED)
    tl, vl = load_dataset(DatasetColorless((1, M, 1), (1, M, 1),
                                           expand=PAVED_EXPAND,
                                           device="cuda"),
                          batch_size=1, split=0.8, seed=0)
    x, t = next(iter(tl))
    (tr, gate) = counted(fk, lambda: gated_trainer(
        model, x, t, "colorless_fused_step"))
    print(f"  gate: fused_path {tr.fused_path!r} (its parity test launched "
          f"{gate})")
    n_train, n_valid = len(tl), len(vl)
    _, counts = counted(fk, lambda: tr.train(tl, vl))
    k1 = gate.get("fdn_tf_mse", 0) + counts.get("fdn_tf_mse", 0)
    print(f"  Trainer.train, one epoch of {n_train} train and {n_valid} "
          f"valid steps: loss {tr.train_loss[-1]:.7f} (train), "
          f"{tr.valid_loss[-1]:.7f} (valid); launches {counts}")
    check(counts == {"fdn_tf_mse": n_train + n_valid},
          "Trainer.train should launch K1 once per train and valid step")
    check(bool(np.isfinite(tr.train_loss + tr.valid_loss).all()),
          "Trainer.train's losses are not finite")
    x, t = colorless_pair(model)
    plain = colorless_plain_total(model, x, t)
    (hist, seconds), counts = counted(fk, lambda: timed(lambda: tr.fit_scan(
        x, t, n_steps=PAVED_SCAN_STEPS, steps_per_call=PAVED_SCAN_CALL)))
    scan_ms = seconds * 1e3 / PAVED_SCAN_STEPS
    rel = abs(float(hist[0]) - plain) / plain
    print(f"  Trainer.fit_scan({PAVED_SCAN_STEPS}, steps_per_call="
          f"{PAVED_SCAN_CALL}): loss {hist[0]:.7f} -> {hist[-1]:.7f}, first "
          f"loss vs K1's plain version rel {rel:.3e} (tol 1e-05); "
          f"{scan_ms:.4f} ms/step (CUDA events) on {card}; launches {counts}")
    check(hist.shape == (PAVED_SCAN_STEPS,) and bool(np.isfinite(hist).all()),
          "fit_scan should return one finite loss per step")
    check(counts == {"fdn_tf_mse": PAVED_SCAN_STEPS},
          "fit_scan should launch K1 once per step")
    check(rel < 1e-5, "fit_scan's first loss differs from K1's plain version")
    check(hist[-1] < hist[0], "fit_scan's loss did not fall")
    launches["fdn_tf_mse"] = k1 + counts["fdn_tf_mse"]

    # the ms a step of Trainer.train_step, fit_scan and colorless_fit in
    # turns, each after a warm-up
    run = trainer_steps()
    run(10)
    _, seconds = timed(lambda: run(PAVED_TRAIN_STEPS))
    train_step_ms = seconds * 1e3 / PAVED_TRAIN_STEPS
    colorless_fit(colorless_model(2), n_steps=10)
    fit_model = colorless_model(3)
    _, seconds = timed(lambda: colorless_fit(fit_model, n_steps=FIT_STEPS))
    fit_ms = seconds * 1e3 / FIT_STEPS
    print(f"  ms a step on {card} (CUDA events, after warm-ups): "
          f"Trainer.train_step (colorless_fused_step, K1; a host copy of the "
          f"loss and of each criterion a step) {train_step_ms:.4f}, "
          f"Trainer.fit_scan {scan_ms:.4f}, colorless_fit {fit_ms:.4f}; "
          f"train_step / colorless_fit {train_step_ms / fit_ms:.3f}, "
          f"fit_scan / colorless_fit {scan_ms / fit_ms:.3f}")

    # 2. the attenuated FDN: mse through K5
    model = att_abs_model()
    x, t = time_impulse_pair(NFFT)
    tr = gated_trainer(model, x, t, "attenuated_fused_step", sparsity=False,
                       lr=ATT_LR)
    hist, counts = counted(sk, lambda: tr.fit_scan(
        x, t, n_steps=PAVED_ATT_STEPS, steps_per_call=PAVED_SCAN_CALL))
    print(f"  attenuated Trainer.fit_scan({PAVED_ATT_STEPS}) "
          f"({tr.fused_path}, K5): loss {hist[0]:.7f} -> {hist[-1]:.7f}; "
          f"launches {counts}")
    check(counts == {"fdn_sos_tf_mse": PAVED_ATT_STEPS},
          "the attenuated Trainer should launch K5 once per step")
    check(bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
          "the attenuated Trainer's loss is not finite or did not fall")
    launches["fdn_sos_tf_mse"] = PAVED_ATT_STEPS

    # 3. the scattering FDN: the masked step against the graph route
    x, t = sfdn_pair()
    hists = {}
    for fused in ("auto", "off"):
        model = sfdn_model(seed=3)
        tr = paved_trainer(model, fused=fused, mse=masked_mse_loss(
            nfft=NFFT, n_samples=SFDN_SAMPLES, device="cuda",
            generator=torch.Generator().manual_seed(SEED)))
        hists[fused] = tr.fit_scan(x, t, n_steps=PAVED_SFDN_STEPS,
                                   steps_per_call=PAVED_SFDN_STEPS)
        check(tr.fused_path == ("sfdn_masked_step" if fused == "auto"
                                else None),
              f"the scattering Trainer (fused={fused!r}) took "
              f"{tr.fused_path!r}")
    gap = float(np.max(np.abs(hists["auto"] - hists["off"])
                       / np.abs(hists["off"])))
    print(f"  scattering Trainer: sfdn_masked_step {hists['auto'].tolist()}"
          f", fused='off' (K6) {hists['off'].tolist()}, max rel gap "
          f"{gap:.3e} (tol 2e-03)")
    check(gap < 2e-3, "the masked step's losses differ from the graph's")

    # 4. the graph route: fused='off' on the colorless model through K2
    def graph_model(seed: int):
        return build_colorless_fdn(
            nfft=NFFT, solve_method="pallas", device="cuda",
            generator=torch.Generator().manual_seed(seed))

    model = graph_model(3)
    x, t = colorless_pair(model)
    tr = paved_trainer(model, fused="off")
    tr.fit_scan(x, t, n_steps=3)
    (hist, seconds), counts = counted(fk, lambda: timed(lambda: tr.fit_scan(
        x, t, n_steps=PAVED_GRAPH_STEPS, steps_per_call=PAVED_GRAPH_STEPS)))
    graph_ms = seconds * 1e3 / PAVED_GRAPH_STEPS
    print(f"  graph route Trainer.fit_scan({PAVED_GRAPH_STEPS}) (fused='off',"
          f" solve_method='pallas'): loss {hist[0]:.7f} -> {hist[-1]:.7f}, "
          f"{graph_ms:.4f} ms/step (CUDA events) on {card}; launches {counts}")
    check(counts == {"fdn_solve": 2 * PAVED_GRAPH_STEPS},
          "the graph route should launch K2 twice a step (forward and "
          "transposed)")
    check(bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
          "the graph route's loss is not finite or did not fall")
    launches["fdn_solve"] = 2 * PAVED_GRAPH_STEPS

    # 5. a checkpoint round trip: bit for bit
    path = Path("build/paved_road/ckpt.pkl")
    path.parent.mkdir(parents=True, exist_ok=True)
    save_model_state(model, str(path))
    restored = load_model_state(graph_model(4), str(path))
    with torch.no_grad():
        same = torch.equal(restored.get_freq_response(),
                           model.get_freq_response())
    print(f"  checkpoint round trip ({path}): response equal bit for bit: "
          f"{same}")
    check(same, "the restored model's response differs from the saved one")
    return launches, train_step_ms


E8_ARGS = SimpleNamespace(nfft=NFFT, samplerate=48000, rir=None)


def e8_target():
    """The e8_fdn example's target: a WGN reverb (t60 0.25 s) from seed
    SEED, (1, NFFT, 1) on the card."""
    set_seed(SEED)
    return e8_fdn._target_rir(E8_ARGS, NFFT, torch.device("cuda"))


def e8_model(scenario: str, backend: str, seed: int = SEED):
    """The example's model of ``scenario`` on ``backend``, at full width
    on the card, its weights from ``seed``."""
    set_seed(seed)
    return e8_fdn._build_reference_fdn(
        E8_ARGS, len(e8_fdn.DELAYS), e8_fdn.DELAYS, e8_fdn.ALIAS_DB,
        direct=scenario == "direct", backend=backend, device="cuda")


def e8_trainer(model, lr: float = 1e-3) -> Trainer:
    """The example's Trainer: mss_loss(256, 512, 1024) + sparsity_loss,
    one epoch, no checkpoints."""
    tr = Trainer(model, max_epochs=1, lr=lr, log=False)
    tr.register_criterion(mss_loss(nfft=e8_fdn.MSS_NFFT), 1)
    tr.register_criterion(sparsity_loss(), 1, requires_model=True)
    return tr


def e8_loaders(target):
    x = torch.zeros((1, NFFT, 1), device="cuda")
    x[:, 0, :] = 1.0
    ds = Dataset(input=x, target=target, expand=E8_EXPAND, device="cuda")
    return load_dataset(ds, batch_size=E8_BATCH, split=E8_SPLIT, seed=SEED)


def phase_e8(card: str):
    """The e8_fdn path at full width: for the 'fdn' and 'direct'
    scenarios, the 'pallas' build's first loss and gradients against the
    'xla' build's from the same seed, one epoch of Trainer.train(scan=True)
    on the 'pallas' model with exact K4f/K4b/K2 counts, its IRs, and
    E8_STEPS timed Trainer.fit_scan steps.  Returns the launch counts of
    the epochs and the timed steps, and the untraced ms a step of each
    scenario."""
    print(f"phase 4g the e8_fdn path: examples/e8_fdn.py's fdn and direct "
          f"models (nfft={NFFT}, delays {e8_fdn.DELAYS}, orthogonal mixing, "
          f"sigmoid-dB octave parallelGEQ, alias decay {e8_fdn.ALIAS_DB} dB, "
          f"iFFTAntiAlias) on cuda, mss_loss({e8_fdn.MSS_NFFT}) + "
          "sparsity_loss against a WGN-reverb target")
    target = e8_target()
    launches, step_ms = {}, {}
    out_dir = Path("build/e8_fdn")
    out_dir.mkdir(parents=True, exist_ok=True)

    def first(model):
        return loss_and_grads(model, lambda m, x, t: e8_fdn.first_loss(m, t),
                              None, target)

    for scenario in ("fdn", "direct"):
        mx, mk = e8_model(scenario, "xla"), e8_model(scenario, "pallas")
        check(all(torch.equal(a, b) for a, b in zip(
            mx.state_dict().values(), mk.state_dict().values())),
            "the two builds of one seed hold different weights")
        l_x, g_x = first(mx)
        reset_counts()
        l_k, g_k = first(mk)
        counts = nonzero_counts()
        want = {"fdn_solve": 2, "sos_cascade_fwd": 1, "sos_cascade_bwd": 1}
        check(counts == want, f"{scenario}: the first loss and its gradients "
              f"should launch K4f, K4b once and K2 twice: {counts}")
        rel = abs(l_k - l_x) / l_x
        print(f"  {scenario}: first loss xla/ge {l_x:.8f}, pallas/pallas "
              f"(K4f + K2) {l_k:.8f}, rel {rel:.3e} (tol {E8_LOSS_TOL:g})")
        check(np.isfinite(l_x) and rel < E8_LOSS_TOL,
              f"{scenario}: the pallas route's first loss differs")
        for k in g_x:
            compare(f"{scenario} grad {k}", g_k[k], g_x[k], E8_GRAD_TOL)

        tl, vl = e8_loaders(target)
        tr = e8_trainer(mk)
        e8_fdn._save_ir(mk, str(out_dir / f"ir_init_{scenario}.wav"), 48000)
        reset_counts()
        _, seconds = timed(lambda: tr.train(tl, vl, scan=True))
        counts = nonzero_counts()
        n_train, n_valid = len(tl), len(vl)
        want = {"fdn_solve": 2 * n_train + n_valid,
                "sos_cascade_fwd": n_train + n_valid,
                "sos_cascade_bwd": n_train}
        check(tr.fused_path is None, f"{scenario}: the Trainer took the "
              f"fused path {tr.fused_path!r} for mss_loss")
        check(counts == want, f"{scenario}: one epoch of {n_train} train and "
              f"{n_valid} valid steps should launch K4f once a step, K4b "
              f"and K2 transposed once a train step, K2 once a step: "
              f"{counts}, not {want}")
        steps = (np.asarray(tr.train_loss_log["mss_loss"])
                 + np.asarray(tr.train_loss_log["sparsity_loss"]))
        print(f"  {scenario}: Trainer.train(scan=True), one epoch of "
              f"{n_train} train and {n_valid} valid batches of {E8_BATCH} "
              f"in {seconds:.2f} s: step losses {steps[0]:.7f} -> "
              f"{steps[-1]:.7f}, valid {tr.valid_loss[-1]:.7f}; launches "
              f"{counts}")
        check(bool(np.isfinite(steps).all()) and steps[-1] < steps[0],
              f"{scenario}: the epoch's loss is not finite or did not fall")
        add_counts(launches, counts)
        ir = e8_fdn._save_ir(tr.net, str(out_dir / f"ir_optim_{scenario}.wav"),
                             48000)
        print(f"  {scenario}: IRs {ir.shape[0]} samples, finite, written to "
              f"{out_dir}/ir_init_{scenario}.wav and ir_optim_{scenario}.wav")

        # the ms a step: Trainer.fit_scan on the first train batch
        bx, bt = next(iter(tl))
        tr.fit_scan(bx, bt, n_steps=3, steps_per_call=3)
        reset_counts()
        hist, seconds = timed(lambda: tr.fit_scan(
            bx, bt, n_steps=E8_STEPS, steps_per_call=E8_STEPS))
        counts = nonzero_counts()
        check(counts == {"fdn_solve": 2 * E8_STEPS,
                         "sos_cascade_fwd": E8_STEPS,
                         "sos_cascade_bwd": E8_STEPS},
              f"{scenario}: a timed step should launch K4f, K4b once and K2 "
              f"twice: {counts}")
        check(bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
              f"{scenario}: the timed steps' loss is not finite or did not "
              "fall")
        add_counts(launches, counts)
        step_ms[scenario] = seconds * 1e3 / E8_STEPS
    print(f"  e8_fdn graph step (Trainer.fit_scan, batch {E8_BATCH}, "
          f"{E8_STEPS} steps after 3, CUDA events) on {card}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in step_ms.items()))
    print(f"  launches in phase 4g (the epochs and the timed steps): "
          f"{launches}")
    return launches, step_ms


def e8_steps(scenario: str):
    """``run(n)``: n Trainer.fit_scan steps of the e8_fdn 'pallas' model on
    the first batch of its loader."""
    target = e8_target()
    tr = e8_trainer(e8_model(scenario, "pallas", seed=3))
    bx, bt = next(iter(e8_loaders(target)[0]))
    return lambda n: tr.fit_scan(bx, bt, n_steps=n, steps_per_call=n)


def mss_steps():
    """``run(n)``: n forward and backward passes of the MSS loss alone on
    a fixed estimate of the e8 'fdn' model, to set against the e8 step's
    busy time."""
    t = e8_target().expand(E8_BATCH, -1, -1)
    x = torch.zeros((E8_BATCH, NFFT, 1), device="cuda")
    x[:, 0, :] = 1.0
    with torch.no_grad():
        est = e8_model("fdn", "pallas", seed=3)(x)
    est.requires_grad_(True)
    mss = mss_loss(nfft=e8_fdn.MSS_NFFT)

    def run(n):
        for _ in range(n):
            mss(est, t).backward()

    return run


# ---------------------------------------------------------------------------
# phase 4h, the filter zoo
# ---------------------------------------------------------------------------
def zoo_args(nfft: int = NFFT, lr: float = 1e-2) -> SimpleNamespace:
    """The e7 examples' arguments at ``nfft``: their dataset (expand 16,
    batches of 2, split 0.8), one epoch, no train_dir."""
    return SimpleNamespace(nfft=nfft, samplerate=48000, seed=SEED,
                           num=ZOO_EXPAND, batch_size=ZOO_BATCH,
                           split=ZOO_SPLIT, max_epochs=1, lr=lr,
                           train_dir=None)


def zoo_filter(name: str, backend: str, nfft: int = NFFT, device="cuda"):
    """(args, filter, target magnitude, input channels) of the e7
    scenario ``name`` on ``backend``, its weights and target from SEED:
    the 'xla' and 'pallas' builds of one name hold the same weights.  The
    SVF families take the route as their attribute."""
    example, make, kw, lr = {**ZOO, **GEQ_ZOO}[name]
    args = zoo_args(nfft, lr)
    set_seed(SEED)
    if example is e7_svf:
        filt, target, in_ch, _ = getattr(example, make)(args, device)
        filt.cascade_backend = backend
    else:
        filt, target, in_ch, _ = getattr(example, make)(
            args, device, cascade_backend=backend, **kw)
    return args, filt, target, in_ch


def zoo_first(filt, target, in_ch: int):
    """(the Trainer's first loss, the gradient of the filter's param): the
    e7 Shell on an impulse in each input channel, PlainMSE."""
    model = filter_shell(filt, filt.nfft)
    x = torch.zeros((1, filt.nfft, in_ch), device=filt.param.device)
    x[:, 0, :] = 1.0
    loss = PlainMSE()(model(x), target)
    (g,) = torch.autograd.grad(loss, filt.param)
    return float(loss.detach()), g


def zoo_f64_first(name: str, filt, target, in_ch: int):
    """The first loss and gradient of a float64 twin of the PEQ ``filt``
    (the same raw params, the plain cascade)."""
    twin = type(filt)(size=filt.size[2:], n_bands=filt.n_bands,
                      design=filt.design, nfft=filt.nfft, fs=filt.fs,
                      requires_grad=True, dtype=torch.float64,
                      device=filt.param.device)
    twin.assign_value(filt.param.detach().double())
    return zoo_first(twin, target.double(), in_ch)


def zoo_scenario(name: str, nfft: int = NFFT, device="cuda") -> dict:
    """One e7 scenario: the 'pallas' build's first loss and gradient
    against the 'xla' build's (K4f and K4b once), one epoch of the e7
    Trainer (filter_trainer: PlainMSE, so the fused gate finds no
    candidate) on the 'pallas' filter with K4f once a step and K4b once a
    train step, exactly, and a falling loss, and ZOO_STEPS
    Trainer.fit_scan steps on its first batch (K4f and K4b once each a
    step).  Returns what it measured; nothing is timed here."""
    _, fx, tx, in_ch = zoo_filter(name, "xla", nfft, device)
    args, fk_, tk_, _ = zoo_filter(name, "pallas", nfft, device)
    check(torch.equal(fx.param, fk_.param) and torch.equal(tx, tk_),
          f"{name}: the two builds of one seed differ")
    l_x, g_x = zoo_first(fx, tx, in_ch)
    reset_counts()
    l_k, g_k = zoo_first(fk_, tk_, in_ch)
    check_counts(f"{name}: the first loss and its gradient",
                 nonzero_counts(), {"sos_cascade_fwd": 1,
                                    "sos_cascade_bwd": 1})
    rel = abs(l_k - l_x) / abs(l_x)
    grad_err = float(torch.max(torch.abs(g_k - g_x))
                     / torch.max(torch.abs(g_x)))
    check(np.isfinite(l_x) and np.isfinite(l_k), f"{name}: a first loss "
          "is not finite")
    f64 = None
    if name in ZOO_ILL:
        l_64, g_64 = zoo_f64_first(name, fx, tx, in_ch)
        scale = torch.max(torch.abs(g_64))
        f64 = {f"{r} {q}": v for r, (loss, g) in
               (("xla", (l_x, g_x)), ("pallas", (l_k, g_k)))
               for q, v in (("loss", abs(loss - l_64) / l_64),
                            ("grad", float(torch.max(torch.abs(
                                g.double() - g_64)) / scale)))}
        for q in ("loss", "grad"):
            check(f64[f"pallas {q}"] <= ZOO_ILL_FACTOR * f64[f"xla {q}"],
                  f"{name}: the pallas {q} is {f64[f'pallas {q}']:.3e} "
                  f"from the float64 twin, more than {ZOO_ILL_FACTOR:g}x "
                  f"the xla route's {f64[f'xla {q}']:.3e}")
    else:
        check(rel < ZOO_LOSS_TOL, f"{name}: first loss xla {l_x:.8g}, "
              f"pallas {l_k:.8g}, rel {rel:.3e} (tol {ZOO_LOSS_TOL:g})")
        check(grad_err < ZOO_GRAD_TOL, f"{name}: the pallas gradient is "
              f"{grad_err:.3e} of the max from xla's (tol {ZOO_GRAD_TOL:g})")
    tr, tl, vl = filter_trainer(args, fk_, tk_, in_ch, log=False)
    reset_counts()
    tr.train(tl, vl)
    epoch_counts = nonzero_counts()
    n_train, n_valid = len(tl), len(vl)
    check_counts(f"{name}: one epoch of {n_train} train and {n_valid} "
                 "valid steps", epoch_counts,
                 {"sos_cascade_fwd": n_train + n_valid,
                  "sos_cascade_bwd": n_train})
    check(tr.fused_path is None, f"{name}: the Trainer took the fused path "
          f"{tr.fused_path!r} for PlainMSE")
    steps = np.asarray(tr.train_loss_log["PlainMSE"])
    check(bool(np.isfinite(steps).all()) and steps[-1] < steps[0],
          f"{name}: the epoch's loss is not finite or did not fall: "
          f"{steps}")
    bx, bt = next(iter(tl))
    reset_counts()
    hist = tr.fit_scan(bx, bt, n_steps=ZOO_STEPS, steps_per_call=ZOO_STEPS)
    step_counts = nonzero_counts()
    check_counts(f"{name}: {ZOO_STEPS} fit_scan steps", step_counts,
                 {"sos_cascade_fwd": ZOO_STEPS, "sos_cascade_bwd": ZOO_STEPS})
    check(bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
          f"{name}: the fit_scan steps' loss is not finite or did not fall")
    return dict(loss_xla=l_x, loss_pallas=l_k, rel=rel, grad_err=grad_err,
                f64=f64, epoch_counts=epoch_counts, n_train=n_train,
                n_valid=n_valid, steps=steps, step_counts=step_counts,
                trainer=tr, batch=(bx, bt))


def zoo_nn(nfft: int = NFFT, device="cuda", steps: int = ZOO_NN_STEPS):
    """e7_biquad_nn on a 'pallas' Biquad: ``steps`` Adam steps of the MLP
    whose output reaches the Biquad through ext_param, K4f and K4b once
    each a step, and a falling loss.  Returns the step losses and the K4
    launches."""
    set_seed(SEED)
    shell, x, target = e7_biquad_nn.build(
        SimpleNamespace(nfft=nfft, samplerate=48000), device,
        cascade_backend="pallas")
    params = e7_biquad_nn.init_mlp(torch.Generator().manual_seed(SEED),
                                   device=device)
    cond = torch.tensor([[0.5]], device=device)
    reset_counts()
    losses = e7_biquad_nn.fit(shell, x, target, params, cond, steps=steps)
    counts = nonzero_counts()
    check_counts(f"e7_biquad_nn: {steps} ext_param steps", counts,
                 {"sos_cascade_fwd": steps, "sos_cascade_bwd": steps})
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          "e7_biquad_nn: the loss is not finite or did not fall")
    return losses, counts


def phase_zoo(card: str):
    """The filter zoo at full width: each e7 scenario of ZOO on 'xla' and
    'pallas' (K4f/K4b, :func:`zoo_scenario`) with its step timed by CUDA
    events, e10's three response paths, and e7_biquad_nn's ext_param
    steps through K4.  Returns the launch counts of the epochs, the timed
    steps and the ext_param steps, and the ms a step of each scenario."""
    print(f"phase 4h the filter zoo: the e7 scenarios (nfft={NFFT}, each "
          f"example's widths and learning rate, {ZOO_EXPAND} items in "
          f"batches of {ZOO_BATCH}, split {ZOO_SPLIT}), PlainMSE against "
          "their targets, 'xla' against 'pallas' (K4f, K4b)")
    launches = {"sos_cascade_fwd": 0, "sos_cascade_bwd": 0}
    step_ms = {}
    for name in ZOO:
        r = zoo_scenario(name)
        n_train, n_valid = r["n_train"], r["n_valid"]
        for counts in (r["epoch_counts"], r["step_counts"]):
            add_counts(launches, counts)
        tr, (bx, bt) = r["trainer"], r["batch"]
        reset_counts()
        _, seconds = timed(lambda: tr.fit_scan(
            bx, bt, n_steps=ZOO_STEPS, steps_per_call=ZOO_STEPS))
        counts = nonzero_counts()
        check_counts(f"{name}: {ZOO_STEPS} timed fit_scan steps", counts,
                     {"sos_cascade_fwd": ZOO_STEPS,
                      "sos_cascade_bwd": ZOO_STEPS})
        add_counts(launches, counts)
        step_ms[name] = seconds * 1e3 / ZOO_STEPS
        gate = (f"tols {ZOO_LOSS_TOL:g} and {ZOO_GRAD_TOL:g}"
                if r["f64"] is None else
                "from the float64 twin: " + ", ".join(
                    f"{k} {v:.3e}" for k, v in r["f64"].items())
                + f", pallas within {ZOO_ILL_FACTOR:g}x xla")
        print(f"  {name}: first loss xla {r['loss_xla']:.8f}, pallas "
              f"{r['loss_pallas']:.8f}, rel {r['rel']:.3e}; gradient "
              f"{r['grad_err']:.3e} of the max ({gate}); one epoch "
              f"({n_train} train, {n_valid} valid steps) launches "
              f"{r['epoch_counts']}, step losses {r['steps'][0]:.7g} -> "
              f"{r['steps'][-1]:.7g}; "
              f"{step_ms[name]:.4f} ms a fit_scan step (CUDA events, "
              f"{ZOO_STEPS} steps after {ZOO_STEPS})")
    errors = e10_probe.path_errors(*e10_probe.response_paths(
        *e10_paths_model(), 48000))
    print(f"  e10 at nfft={NFFT}: " + ", ".join(
        f"|{k}| {v:.3e}" for k, v in errors.items())
        + f" (tol {e10_probe.TOL:g})")
    check(all(v < e10_probe.TOL for v in errors.values()),
          f"e10's three response paths differ: {errors}")
    losses, counts = zoo_nn()
    print(f"  e7_biquad_nn on a 'pallas' Biquad (ext_param, nfft={NFFT}): "
          f"{ZOO_NN_STEPS} Adam steps, loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}, launches {counts}")
    add_counts(launches, counts)
    print(f"  e7 fit_scan step on {card}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in step_ms.items()))
    print(f"  launches in phase 4h: {launches}")
    return launches, step_ms


def e10_paths_model(nfft: int = NFFT, device="cuda"):
    set_seed(SEED)
    return e10_probe.build(nfft, device)


def zoo_steps(name: str):
    """``run(n)``: n Trainer.fit_scan steps of the e7 scenario ``name`` on
    'pallas', on the first batch of its loader."""
    args, filt, target, in_ch = zoo_filter(name, "pallas")
    tr, tl, _ = filter_trainer(args, filt, target, in_ch, log=False)
    bx, bt = next(iter(tl))
    return lambda n: tr.fit_scan(bx, bt, n_steps=n, steps_per_call=n)


# ---------------------------------------------------------------------------
# phase 4i, the accurate GEQ, velvet noise and the tutorial examples
# ---------------------------------------------------------------------------
def accurate_scenario(parallel: bool, nfft: int = NFFT,
                      device="cuda") -> dict:
    """e7_geq's accurate scenario (the MIMO 2 x 1 AccurateGEQ or the
    2-channel parallelAccurateGEQ) built on 'xla' and 'pallas' from SEED:
    |response()| of the two routes, K4f once and K4b never for the
    'pallas' one, the routes 1e-4 of the max apart (else each held to a
    float64 evaluation of the same taps, 'pallas' within twice 'xla''s
    distance: e8_fdn.check_accurate_routes), and each within the
    example's ACCURATE_TOL
    of its designed target through ``accurate_error`` (K4f once more)."""
    args = zoo_args(nfft)
    out = {}
    for be in ("xla", "pallas"):
        set_seed(SEED)
        filt, target, _, tag = e7_geq.scenario_accurate(
            args, device, parallel, cascade_backend=be)
        check(not filt.trainable and not filt.sos_b.requires_grad,
              f"{tag}: the accurate GEQ holds a trainable tensor")
        reset_counts()
        with torch.no_grad():
            H = filt.response().abs()
        err, rng, _ = e7_geq.accurate_error(filt, target)
        counts = nonzero_counts()
        check_counts(f"{tag} ({be}): a response and the example's check",
                     counts, {"sos_cascade_fwd": 2 * (be == "pallas")})
        check(err < e7_geq.ACCURATE_TOL * max(rng, 1.0),
              f"{tag} ({be}): the design is {err:.3e} from its target "
              f"(range {rng:.3f})")
        out[be] = dict(filt=filt, H=H, err=err, rng=rng, counts=counts)
    routes = e8_fdn.check_accurate_routes(
        out["pallas"]["H"], out["xla"]["H"], out["xla"]["filt"])
    return dict(tag=tag, out=out, **routes)


def comb_args(nfft: int = NFFT) -> SimpleNamespace:
    return SimpleNamespace(nfft=nfft, samplerate=48000, seed=SEED,
                           num=COMB_ITEMS, batch_size=COMB_BATCH, lr=1e-3)


def comb_loss_grads(shell, imp, params, targets):
    """(loss, {leaf index: grad}) of e4_recursion_nn's comb loss on one
    batch; the last layer's unused LayerNorm leaves get none."""
    leaves = e4_recursion_nn.mlp_leaves(params)
    loss = e4_recursion_nn.comb_loss(shell, imp, params, targets)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), {i: g for i, g in enumerate(grads)
                                  if g is not None}


def comb_scenario(nfft: int = NFFT, device="cuda") -> dict:
    """comb_nn on 'xla' (plain cascade, 'ge') and 'pallas' (K4, K6) from
    SEED: the same MLP weights; the first loss and MLP gradients on the
    first batch of the 'xla' targets (each item once through K4f, K4b, K6
    and K6 transposed), one epoch of Adam over the 'xla' targets on
    'pallas' (the same per item), the loss over all targets falling.
    Returns what it measured and the 'pallas' state for timing."""
    args = comb_args(nfft)
    sx, ix, tx, px = e4_recursion_nn.comb_setup(args, device, "xla")
    sp, ip, _, pp = e4_recursion_nn.comb_setup(args, device, "pallas")
    check(all(torch.equal(a, b) for a, b in zip(
        e4_recursion_nn.mlp_leaves(px), e4_recursion_nn.mlp_leaves(pp))),
        "comb_nn: the two builds of one seed hold different MLP weights")
    batch = tx[:COMB_BATCH]
    l_x, g_x = comb_loss_grads(sx, ix, px, batch)
    reset_counts()
    l_k, g_k = comb_loss_grads(sp, ip, pp, batch)
    n = COMB_BATCH
    per_item = {"sos_cascade_fwd": 1, "sos_cascade_bwd": 1,
                "dense_solve": 1, "dense_solve_transposed": 1}
    check_counts("comb_nn's first loss and gradients", nonzero_counts(),
                 {k: n * v for k, v in per_item.items()})
    rel = abs(l_k - l_x) / abs(l_x)
    check(np.isfinite(l_x) and rel < COMB_LOSS_TOL,
          f"comb_nn: first loss xla {l_x:.8g}, pallas {l_k:.8g}, rel "
          f"{rel:.3e} (tol {COMB_LOSS_TOL:g})")
    grad_err = max(rel_err(g_k[i], g_x[i])[1] for i in g_x)
    check(grad_err < COMB_GRAD_TOL, f"comb_nn: the MLP gradients are "
          f"{grad_err:.3e} of the max apart (tol {COMB_GRAD_TOL:g})")
    before = e4_recursion_nn.dataset_loss(sp, ip, pp, tx)
    reset_counts()
    steps = e4_recursion_nn.comb_fit(sp, ip, pp, tx, args.lr, 1, n)
    epoch_counts = nonzero_counts()
    n_steps = COMB_ITEMS // n
    check_counts(f"comb_nn's epoch of {n_steps} steps of {n} items",
                 epoch_counts, {k: COMB_ITEMS * v for k, v in
                                per_item.items()})
    after = e4_recursion_nn.dataset_loss(sp, ip, pp, tx)
    check(bool(np.isfinite(steps).all()) and after < before,
          f"comb_nn: the loss over the targets did not fall: {before:.7g} "
          f"-> {after:.7g}")
    return dict(loss_xla=l_x, loss_pallas=l_k, rel=rel, grad_err=grad_err,
                before=before, after=after, steps=steps,
                epoch_counts=epoch_counts, state=(sp, ip, pp, tx))


def comb_step_runner(state, lr: float = 1e-3):
    """``run(k)``: k Adam steps of comb_nn on the first batch."""
    shell, imp, params, targets = state
    batch = targets[:COMB_BATCH]
    opt = torch.optim.Adam(e4_recursion_nn.mlp_leaves(params), lr=lr)

    def run(k):
        for _ in range(k):
            opt.zero_grad(set_to_none=True)
            e4_recursion_nn.comb_loss(shell, imp, params, batch).backward()
            opt.step()

    return run


def gains_scenario(nfft: int = NFFT, device="cuda",
                   steps: int = GAINS_STEPS) -> dict:
    """gains_nn on 'pallas': its loop, delays against a parallelGain, is
    not an FDN loop with a flat feedback (the split declines), so it goes
    to K6, once each way a step, and never to K2; the loss falls."""
    args = comb_args(nfft)
    shell, x, params, cond = e4_recursion_nn.gains_setup(args, device,
                                                         "pallas")
    reset_counts()
    losses = e4_recursion_nn.gains_fit(shell, x, params, cond, steps)
    counts = nonzero_counts()
    check_counts(f"gains_nn's {steps} steps", counts,
                 {"dense_solve": steps, "dense_solve_transposed": steps})
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"gains_nn: the loss did not fall: {losses}")
    return dict(losses=losses, counts=counts)


def e6_scenario(nfft: int = NFFT, device="cuda") -> dict:
    """e6's two IRs (alias decay 0 and 30 dB) on 'pallas' (K2 once each,
    through the diagonal / flat split) against 'ge', and the example's
    pre-onset energy check on the 'pallas' IRs."""
    reset_counts()
    irs = e6_anti_aliasing.impulse_responses(nfft, SEED, device, "pallas")
    counts = nonzero_counts()
    check_counts("e6's two IRs", counts, {"fdn_solve": 2})
    ref = e6_anti_aliasing.impulse_responses(nfft, SEED, device, "ge")
    errs = {db: rel_err(irs[db], ref[db])[1] for db in irs}
    check(all(v < E6_TOL for v in errs.values()),
          f"e6: the 'pallas' IRs differ from 'ge': {errs}")
    energy = {db: e6_anti_aliasing.pre_onset_energy(irs[db]) for db in irs}
    check(energy[30.0] < energy[0.0], f"e6: the 30 dB envelope did not "
          f"lower the pre-onset energy: {energy}")
    for db, ir in irs.items():
        check(bool(torch.isfinite(ir).all()), f"e6: the {db} dB IR is not "
              "finite")
    return dict(errs=errs, energy=energy, counts=counts)


def velvet_loop(solve_method: str, nfft: int = NFFT, device="cuda"):
    """Recursion(parallelDelay(VELVET_N), VelvetNoiseMatrix((VELVET_STAGES,
    VELVET_N, VELVET_N))), both drawn from SEED."""
    delays = dsp.parallelDelay(size=(VELVET_N,), max_len=VELVET_MAX_DELAY,
                               isint=True, nfft=nfft, device=device,
                               generator=torch.Generator().manual_seed(SEED))
    vm = dsp.VelvetNoiseMatrix(size=(VELVET_STAGES, VELVET_N, VELVET_N),
                               nfft=nfft, device=device,
                               generator=torch.Generator().manual_seed(SEED))
    return system.Recursion(fF=delays, fB=vm, solve_method=solve_method)


def velvet_scenario(nfft: int = NFFT, device="cuda") -> dict:
    """The velvet scattering loop's output for a seeded white input on
    'pallas' (K6 once, forward) against 'ge'."""
    x = torch.randn((1, nfft, VELVET_N),
                    generator=torch.Generator().manual_seed(SEED))
    X = torch.fft.rfft(x.to(device), dim=1)
    loop = velvet_loop("pallas", nfft, device)
    reset_counts()
    with torch.no_grad():
        y = loop(X)
    counts = nonzero_counts()
    check_counts("the velvet loop", counts, {"dense_solve": 1})
    with torch.no_grad():
        ref = velvet_loop("ge", nfft, device)(X)
    _, err = rel_err(y, ref)
    check(bool(torch.isfinite(y).all()) and err < VELVET_TOL,
          f"the velvet loop's 'pallas' output is {err:.3e} of the max from "
          f"'ge' (tol {VELVET_TOL:g})")
    return dict(err=err, counts=counts,
                taps=loop.feedback.map_filter.output_length)


def phase_accurate_velvet(card: str):
    """The accurate GEQ, velvet noise and the tutorial examples at full
    width: e7_geq's four scenarios, e4_recursion_nn's comb_nn (timed) and
    gains_nn, e6's IRs and a velvet scattering loop, each on 'pallas'
    against 'xla'/'ge' with exact launch counts.  Returns the launch
    counts and the ms a comb_nn step."""
    print(f"phase 4i the accurate GEQ, velvet noise and the tutorial "
          f"examples (nfft={NFFT}, each example's widths), 'pallas' (K4f, "
          "K4b, K6, K2) against 'xla'/'ge'")
    launches = {}
    for name in GEQ_ZOO:
        r = zoo_scenario(name)
        for counts in (r["epoch_counts"], r["step_counts"]):
            add_counts(launches, counts)
        print(f"  e7_geq {name}: first loss xla {r['loss_xla']:.8f}, pallas "
              f"{r['loss_pallas']:.8f}, rel {r['rel']:.3e} (tol "
              f"{ZOO_LOSS_TOL:g}); gradient {r['grad_err']:.3e} of the max "
              f"(tol {ZOO_GRAD_TOL:g}); one epoch ({r['n_train']} train, "
              f"{r['n_valid']} valid steps) launches {r['epoch_counts']}, "
              f"step losses {r['steps'][0]:.7g} -> {r['steps'][-1]:.7g}; "
              f"{ZOO_STEPS} fit_scan steps launch {r['step_counts']}")
    for parallel in (False, True):
        a = accurate_scenario(parallel)
        for be in ("xla", "pallas"):
            add_counts(launches, a["out"][be]["counts"])
        f64 = ("" if a["f64"] is None else
               "; from the float64 taps " + ", ".join(
                   f"{k} {v:.3e}" for k, v in a["f64"].items()))
        print(f"  e7_geq {a['tag']}: |H| pallas against xla {a['gap']:.3e} "
              f"of the max (tol {ACC_ROUTE_TOL:g}){f64}; the example's "
              "check " + ", ".join(
                  f"{be} {a['out'][be]['err']:.3e}" for be in a["out"])
              + f" (tol {e7_geq.ACCURATE_TOL:g} x "
              f"{max(a['out']['xla']['rng'], 1.0):.3f}); launches "
              f"{a['out']['pallas']['counts']} (K4b none: not trainable)")
    c = comb_scenario()
    add_counts(launches, c["epoch_counts"])
    print(f"  e4_recursion_nn comb_nn (delays {e4_recursion_nn.DELAYS}, 4 x 4 "
          f"LossyBiquad, MLP {e4_recursion_nn.HIDDEN}, {COMB_ITEMS} items in "
          f"batches of {COMB_BATCH}, an item at a time): first loss xla "
          f"{c['loss_xla']:.8f}, pallas {c['loss_pallas']:.8f}, rel "
          f"{c['rel']:.3e} (tol {COMB_LOSS_TOL:g}); MLP gradients "
          f"{c['grad_err']:.3e} of the max (tol {COMB_GRAD_TOL:g}); one "
          f"epoch launches {c['epoch_counts']}, loss over the targets "
          f"{c['before']:.7g} -> {c['after']:.7g}")
    run = comb_step_runner(c["state"])
    run(3)
    reset_counts()
    _, seconds = timed(lambda: run(COMB_STEPS))
    counts = nonzero_counts()
    check_counts(f"{COMB_STEPS} timed comb_nn steps", counts,
                 {k: COMB_STEPS * COMB_BATCH for k in
                  ("sos_cascade_fwd", "sos_cascade_bwd", "dense_solve",
                   "dense_solve_transposed")})
    add_counts(launches, counts)
    comb_ms = seconds * 1e3 / COMB_STEPS
    print(f"  comb_nn step (batch {COMB_BATCH}, {COMB_STEPS} steps after 3, "
          f"CUDA events) on {card}: {comb_ms:.4f} ms")
    g = gains_scenario()
    add_counts(launches, g["counts"])
    print(f"  e4_recursion_nn gains_nn: {GAINS_STEPS} Adam steps, loss "
          f"{g['losses'][0]:.6g} -> {g['losses'][-1]:.6g}; its loop (delays "
          f"against a parallelGain) takes K6, not K2: launches "
          f"{g['counts']}")
    e = e6_scenario()
    add_counts(launches, e["counts"])
    print(f"  e6 at nfft={NFFT}: 'pallas' (K2) IRs against 'ge' " + ", ".join(
        f"{db:g} dB {v:.3e}" for db, v in e["errs"].items())
        + f" of the max (tol {E6_TOL:g}); pre-onset energy "
        + ", ".join(f"{db:g} dB {v:.6g}" for db, v in e["energy"].items())
        + f"; launches {e['counts']}")
    v = velvet_scenario()
    add_counts(launches, v["counts"])
    print(f"  velvet loop (parallelDelay({VELVET_N}), VelvetNoiseMatrix("
          f"{VELVET_STAGES}, {VELVET_N}, {VELVET_N}), {v['taps']} taps): "
          f"'pallas' (K6) against 'ge' {v['err']:.3e} of the max (tol "
          f"{VELVET_TOL:g}); launches {v['counts']}")
    print(f"  launches in phase 4i: {launches}")
    return launches, comb_ms


def comb_steps():
    """``run(n)``: n comb_nn steps on 'pallas' (for the trace)."""
    shell, imp, targets, params = e4_recursion_nn.comb_setup(
        comb_args(), "cuda", "pallas")
    return comb_step_runner((shell, imp, params, targets))


# ---------------------------------------------------------------------------
# phase 4j, the reverb domain
# ---------------------------------------------------------------------------
def reverb_counts() -> dict:
    """The nonzero launch counts, K2's transposed launches (a part of
    fdn_solve's) also apart."""
    counts = nonzero_counts()
    if fk.K2_TRANSPOSED[0]:
        counts["fdn_solve transposed"] = fk.K2_TRANSPOSED[0]
    return counts


def hfdn_delays(N: int = 6) -> list:
    """HomogeneousFDNConfig's delay range (20-50 ms at 48 kHz), drawn from
    SEED."""
    return coprime_delay_lengths(N, [20.0, 50.0], 48000,
                                 rng=np.random.default_rng(SEED))


def homogeneous_scenario(nfft: int = NFFT, device="cuda") -> dict:
    """HomogeneousFDN at its defaults (N = 6, 20-50 ms delays, 0 dB alias
    decay) on 'ge' and 'pallas' from SEED: |H| (K2 once) within HFDN_TOL
    of the max, normalize_energy on both (its own 1e-4 check; K2 twice
    more) and the normalized gains within HFDN_TOL."""
    delays = hfdn_delays()
    fdns = {}
    for method in ("ge", "pallas"):
        cfg = HomogeneousFDNConfig(nfft=nfft, delays=delays, device=device,
                                   solve_method=method)
        fdns[method] = HomogeneousFDN(
            cfg, generator=torch.Generator().manual_seed(SEED))
    H = {m: f.model.get_freq_response().abs() for m, f in fdns.items()
         if m == "ge"}
    reset_counts()
    H["pallas"] = fdns["pallas"].model.get_freq_response().abs()
    fdns["pallas"].normalize_energy()
    counts = reverb_counts()
    check_counts("HomogeneousFDN's response and normalize_energy", counts,
                 {"fdn_solve": 3})
    fdns["ge"].normalize_energy()
    _, err = rel_err(H["pallas"], H["ge"])
    check(err < HFDN_TOL, f"HomogeneousFDN: |H| on 'pallas' is {err:.3e} of "
          f"the max from 'ge' (tol {HFDN_TOL:g})")
    raw = {m: f.get_raw_parameters() for m, f in fdns.items()}
    gain_err = max(float(np.max(np.abs(raw["pallas"][k] - raw["ge"][k]))
                         / np.max(np.abs(raw["ge"][k]))) for k in ("B", "C"))
    check(gain_err < HFDN_TOL, f"HomogeneousFDN: the normalized gains are "
          f"{gain_err:.3e} of the max apart (tol {HFDN_TOL:g})")
    return dict(delays=delays, err=err, gain_err=gain_err, counts=counts)


def accurate_fdn_scenario(nfft: int = NFFT, device="cuda") -> dict:
    """e8_fdn's accurate_geq scenario on 'pallas' through the example's own
    function (the attenuation's |H| against an 'xla' build, the RT gate),
    with its launches: K4f for the attenuation's response and the IR's
    loop, K2 once for the IR."""
    out_dir = Path("build/e8_fdn_reverb")
    out_dir.mkdir(parents=True, exist_ok=True)
    args = SimpleNamespace(nfft=nfft, samplerate=48000, device=device,
                           backend="pallas", seed=SEED,
                           train_dir=str(out_dir))
    reset_counts()
    r = e8_fdn.example_fdn_accurate_geq(args)
    counts = reverb_counts()
    check_counts("e8_fdn's accurate_geq scenario", counts,
                 {"sos_cascade_fwd": 2, "fdn_solve": 1})
    return dict(r, counts=counts)


def ds_args(nfft: int = NFFT, attenuation: str = "geq") -> SimpleNamespace:
    return SimpleNamespace(nfft=nfft, samplerate=48000, rir=None,
                           attenuation=attenuation, num=DS_EPOCH_EXPAND,
                           batch_size=E8_BATCH, split=E8_SPLIT, lr=1e-3,
                           max_epochs=1, train_dir=None, seed=SEED)


def ds_model(attenuation: str, backend: str, seed: int = SEED,
             nfft: int = NFFT, device="cuda"):
    set_seed(seed)
    return e8_fdn.build_delay_scaled(ds_args(nfft, attenuation), attenuation,
                                     backend, device)


def ds_per_step(attenuation: str, train: bool = True) -> dict:
    """A delay_scaled step's launches: K2 once (and once transposed in a
    train step); K4f twice for the accurate GEQ, which sits in the loop's
    feedforward Series, whose response the Recursion takes once for its
    input and once for the loop matrix; no K4b (the accurate GEQ does not
    train, and the trainable families have no kernel route)."""
    want = {"fdn_solve": 1 + train, "fdn_solve transposed": int(train)}
    if attenuation == "accurate_geq":
        want["sos_cascade_fwd"] = 2
    return want


def delay_scaled_scenario(attenuation: str, nfft: int = NFFT,
                          device="cuda") -> dict:
    """e8_fdn's delay_scaled FDN with ``attenuation`` built on 'xla' and
    'pallas' from SEED: the first loss (mss_loss + 0.2 sparsity_loss)
    within DS_LOSS_TOL; one epoch of Trainer.fit_scan_epochs on 'pallas',
    exact launches, the loss falling.  Returns what it measured and the
    Trainer and first batch for timing."""
    set_seed(SEED)
    target = e8_fdn._target_rir(ds_args(nfft), nfft, torch.device(device))
    mx, mk = (ds_model(attenuation, be, nfft=nfft, device=device)
              for be in ("xla", "pallas"))
    check(all(torch.equal(a, b) for a, b in zip(
        mx.state_dict().values(), mk.state_dict().values())),
        f"delay_scaled {attenuation}: the two builds of one seed differ")
    with torch.no_grad():
        l_x = float(e8_fdn.first_loss(mx, target, 48000, e8_fdn.DS_SPARSITY))
        reset_counts()
        l_k = float(e8_fdn.first_loss(mk, target, 48000, e8_fdn.DS_SPARSITY))
    first_counts = reverb_counts()
    check_counts(f"delay_scaled {attenuation}'s first loss", first_counts,
                 ds_per_step(attenuation, train=False))
    rel = abs(l_k - l_x) / abs(l_x)
    check(np.isfinite(l_x) and rel < DS_LOSS_TOL,
          f"delay_scaled {attenuation}: first loss xla {l_x:.8g}, pallas "
          f"{l_k:.8g}, rel {rel:.3e} (tol {DS_LOSS_TOL:g})")
    args = ds_args(nfft, attenuation)
    tr, tl, _ = e8_fdn.delay_scaled_trainer(args, mk, target, log=False)
    bx, bt = stack_loader(tl)
    reset_counts()
    hist = tr.fit_scan_epochs(bx, bt, n_epochs=1)
    counts = reverb_counts()
    S = bx.shape[0]
    check_counts(f"delay_scaled {attenuation}: an epoch of {S} steps", counts,
                 {k: S * v for k, v in ds_per_step(attenuation).items()})
    check(bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
          f"delay_scaled {attenuation}: the epoch's loss is not finite or "
          f"did not fall: {hist}")
    return dict(loss_xla=l_x, loss_pallas=l_k, rel=rel, hist=hist,
                first_counts=first_counts, counts=counts, trainer=tr,
                batch=(bx[0], bt[0]))


def e9_scenario(nfft: int = NFFT, device="cuda") -> dict:
    """e9's profile (2 runs x 9 steps) and surface (4 x 4) on 'pallas' (K2
    once a scanned point) against 'ge' within E9_TOL of the max."""
    losses = {}
    for be in ("xla", "pallas"):
        model = e9_loss_profile.build_model(nfft, be, device, SEED)
        reset_counts()
        losses[be] = e9_loss_profile.scans(model, nfft, SEED)[:2]
        counts = reverb_counts()
    check_counts("e9's scans", counts, {"fdn_solve": 2 * 9 + 4 * 4})
    gaps = [e9_loss_profile.route_gap(k, x)
            for k, x in zip(losses["pallas"], losses["xla"])]
    check(max(gaps) < E9_TOL and all(np.isfinite(v).all() for v in
                                     losses["pallas"]),
          f"e9: the 'pallas' scans are {gaps} of the max from 'ge' (tol "
          f"{E9_TOL:g})")
    return dict(gaps=gaps, counts=counts, loss=losses["pallas"])


def third_octave_scenario(nfft: int = NFFT, device="cuda") -> dict:
    """The delay-scaled accurate GEQ at 1/3 octave (30 sections) on
    HomogeneousFDN's delays, its RT60s drawn from SEED, on 'pallas': its
    response (K4f once) finite at every bin and within the GEQ bound of a
    float64 evaluation of its taps; then, apart from the counted run, K4f
    against its plain version on its taps at the GEQ bound, both finite,
    the plain version's distance from float64 printed; the same for the
    octave design on those delays."""
    out = {}
    for interval in (3, 1):
        m = parallelFDNAccurateGEQ(
            octave_interval=interval, nfft=nfft, fs=48000,
            delays=hfdn_delays(), cascade_backend="pallas", device=device,
            generator=torch.Generator().manual_seed(SEED))
        reset_counts()
        with torch.no_grad():
            H = m.response()
        counts = reverb_counts()
        check_counts(f"the 1/{interval}-octave accurate GEQ's response",
                     counts, {"sos_cascade_fwd": 1})
        check(bool(torch.isfinite(H).all()), f"1/{interval} octave: K4f's "
              "response is not finite at every bin")
        with torch.no_grad():
            b, a = m.sos_taps(None)
            plain = sk.sos_cascade_fwd_plain(b, a, nfft)
            ref = e8_fdn.accurate_f64(m)
        check(bool(torch.isfinite(plain).all()), f"1/{interval} octave: the "
              "plain version is not finite at every bin")
        err = compare(f"K4f sos_cascade_fwd (1/{interval}-octave accurate "
                      f"GEQ, {b.shape[1]} sections, delays "
                      f"{min(m.delays)}-{max(m.delays)})", H, plain,
                      GEQ_VAL_TOL)
        f64 = {k: rel_err(v.abs().double(), ref)[1]
               for k, v in (("kernel", H), ("plain", plain))}
        check(f64["kernel"] < GEQ_VAL_TOL, f"1/{interval} octave: K4f is "
              f"{f64['kernel']:.3e} of the max from a float64 evaluation of "
              f"its taps (tol {GEQ_VAL_TOL:g})")
        out[interval] = dict(err=err, f64=f64, counts=counts,
                             sections=b.shape[1])
    return out


def phase_reverb(card: str):
    """The reverb domain at full width: HomogeneousFDN, e8_fdn's
    accurate_geq and delay_scaled (the four attenuations) scenarios, e9's
    scans and the 1/3-octave accurate GEQ, each on 'pallas' against
    'xla'/'ge' with exact launch counts; DS_STEPS timed delay_scaled
    steps.  Returns the launch counts (K2's transposed ones inside
    fdn_solve's) and the ms a delay_scaled step."""
    print(f"phase 4j the reverb domain (nfft={NFFT}): HomogeneousFDN, "
          "e8_fdn's accurate_geq and delay_scaled, e9, the 1/3-octave "
          "accurate GEQ, 'pallas' (K2, K4f) against 'xla'/'ge'")
    launches, k2t = {}, 0

    def add(counts):
        nonlocal k2t
        counts = dict(counts)
        k2t += counts.pop("fdn_solve transposed", 0)
        add_counts(launches, counts)

    h = homogeneous_scenario()
    add(h["counts"])
    print(f"  HomogeneousFDN (N=6, delays {h['delays']}): |H| pallas against "
          f"ge {h['err']:.3e} of the max (tol {HFDN_TOL:g}); normalize_energy "
          f"passed on both, gains {h['gain_err']:.3e} apart; launches "
          f"{h['counts']}")
    a = accurate_fdn_scenario()
    add(a["counts"])
    routes = a["routes"]
    f64 = ("" if routes["f64"] is None else "; from the float64 taps "
           + ", ".join(f"{k} {v:.3e}" for k, v in routes["f64"].items()))
    print(f"  e8_fdn accurate_geq: |H| pallas against xla {routes['gap']:.3e} "
          f"of the max (tol {e8_fdn.ACC_ROUTE_TOL:g}){f64}; RT MSE "
          f"{a['rt_mse']:.6g} (tol {e8_fdn.RT_MSE_TOL:g}); launches "
          f"{a['counts']}")
    ds = {}
    for att in e8_fdn.ATTENUATIONS:
        ds[att] = r = delay_scaled_scenario(att)
        add(r["first_counts"])
        add(r["counts"])
        print(f"  delay_scaled {att}: first loss xla {r['loss_xla']:.8f}, "
              f"pallas {r['loss_pallas']:.8f}, rel {r['rel']:.3e} (tol "
              f"{DS_LOSS_TOL:g}); fit_scan_epochs, {len(r['hist'])} steps: "
              f"{r['hist'][0]:.7g} -> {r['hist'][-1]:.7g}; launches "
              f"{r['counts']}")
    tr, (bx, bt) = ds["geq"]["trainer"], ds["geq"]["batch"]
    tr.fit_scan(bx, bt, n_steps=3, steps_per_call=3)
    reset_counts()
    hist, seconds = timed(lambda: tr.fit_scan(bx, bt, n_steps=DS_STEPS,
                                              steps_per_call=DS_STEPS))
    counts = reverb_counts()
    check_counts(f"{DS_STEPS} timed delay_scaled steps", counts,
                 {k: DS_STEPS * v for k, v in ds_per_step("geq").items()})
    check(bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
          "delay_scaled: the timed steps' loss is not finite or did not fall")
    add(counts)
    ds_ms = seconds * 1e3 / DS_STEPS
    print(f"  delay_scaled geq step (Trainer.fit_scan, batch {E8_BATCH}, "
          f"{DS_STEPS} steps after 3, CUDA events) on {card}: {ds_ms:.4f} ms")
    e = e9_scenario()
    add(e["counts"])
    print(f"  e9 (N=4, delays {e9_loss_profile.DELAYS}): profile and surface "
          f"pallas against ge {e['gaps'][0]:.3e}, {e['gaps'][1]:.3e} of the "
          f"max (tol {E9_TOL:g}); launches {e['counts']}")
    t = third_octave_scenario()
    for interval, r in t.items():
        add(r["counts"])
        print(f"  1/{interval}-octave accurate GEQ ({r['sections']} sections):"
              f" finite at every bin; K4f {r['f64']['kernel']:.3e} and plain "
              f"{r['f64']['plain']:.3e} of the max from a float64 "
              f"evaluation of the taps; launches {r['counts']}")
    print(f"  launches in phase 4j: {launches}, of them K2 transposed {k2t}")
    return launches, k2t, ds_ms


def ds_steps():
    """``run(n)``: n Trainer.fit_scan steps of the delay_scaled 'geq'
    model on 'pallas' (for the trace)."""
    r = delay_scaled_scenario("geq")
    tr, (bx, bt) = r["trainer"], r["batch"]
    return lambda n: tr.fit_scan(bx, bt, n_steps=n, steps_per_call=n)


# ---------------------------------------------------------------------------
# phase 4k, the multi-device layer and the QR eigensolver
# ---------------------------------------------------------------------------
def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def shard_cfg(gain=None, nfft: int = NFFT, device="cuda") -> dict:
    """shard_smoke's full-width configuration, the eigenvalue rig's gain
    before instability given (phase 4d's, the same rig from SEED)."""
    return {**shard_smoke.FULL, "nfft": nfft, "device": device,
            "evs": {**shard_smoke.FULL["evs"], "gain": gain}}


def report_families(out: dict, cfg: dict, card: str) -> dict:
    """Hold the ranks' results to shard_smoke's gates (the launches too,
    on the card), print each family's numbers, and return the launches
    over the ranks by kernels-line row (K6's at the masked step's rows)."""
    on_card = torch.device(cfg["device"]).type == "cuda"
    ranks = out["two"] + out["four"]
    totals = shard_smoke.check_families(ranks, cfg, on_card=on_card)
    label = (f"{len(out['two'])} ranks sharing one card ({card})" if on_card
             else f"{len(out['two'])} ranks on the CPU")

    def line(name, rs, extra="", allclose=False):
        ms = ", ".join(f"{r['ms']:.4f}" for r in rs if r.get("ms"))
        ref = ", ".join(f"{r['ref_ms']:.4f}" for r in rs if r.get("ref_ms"))
        gaps = (f"parameters {max(r['allclose_ratio'] for r in rs):.3g} "
                f"x allclose({shard_smoke.RTOL:g}, {shard_smoke.ATOL:g})"
                if allclose else
                f"parameters {max(r['param_gap'] for r in rs):.3e} and "
                f"first gradients {max(r['grad_gap'] for r in rs):.3e} of "
                "the max")
        print(f"  {name}: {len(rs[0]['losses'])} steps, losses "
              f"{rs[0]['losses'][0]:.7g} -> {rs[0]['losses'][-1]:.7g}, "
              f"loss {max(r['loss_rel'] for r in rs):.3e} from the "
              f"unsharded step, {gaps}, across ranks "
              f"{max(r['spread'] for r in rs):g}; blocks "
              f"{[tuple(r['block']) for r in rs]}; a rank's launches a "
              f"step {rs[0]['counts'][0]}{extra}"
              + (f"; ms a step (CUDA events, {cfg['time_steps']} after "
                 f"{cfg['warm']}, {label}): sharded {ms}, unsharded {ref}"
                 if ms else ""))

    two = out["two"]
    line("make_bins_sharded_fused_step (K1)",
         [r["colorless"]["fused"] for r in two])
    fwd = [r["colorless"]["forward"] for r in two]
    print(f"  bin_sharded_forward ('pallas', K2 {fwd[0]['counts']} a rank): "
          f"{max(f['rel'] for f in fwd):.3e} of the max from the unsharded "
          f"forward; shard_spectrum's blocks equal: "
          f"{all(f['spectrum_equal'] for f in fwd)}"
          + (f"; ms a call: sharded {fwd[0]['ms']:.4f}, unsharded "
             f"{fwd[0]['ref_ms']:.4f}" if fwd[0].get("ms") else ""))
    line(f"make_dp_train_step (batch {cfg['dp_batch']}, 'ge')",
         [r["colorless"]["dp"] for r in two],
         f"; a ragged batch: {two[0]['colorless']['dp']['ragged']!r}",
         allclose=True)
    line("make_bins_sharded_attenuated_step (K5)",
         [r["attenuated"] for r in two])
    line(f"make_bins_sharded_aa_taps_step (K9 'high', lr "
         f"{cfg['aa_lr']:g})", [r["aa_taps"] for r in two])
    evs = [r["evs"] for r in two]
    line(f"make_bins_sharded_evs_step (K7, partitions "
         f"{evs[0]['partitions']})", evs,
         f"; .multi(3, 2): loss {max(e['multi']['loss_rel'] for e in evs):.3e}"
         f" from the unsharded, launches {evs[0]['multi']['counts']}")
    line(f"make_masked_sharded_sfdn_step ({cfg['sfdn']['n_samples']} bins, "
         f"'{cfg['sfdn']['solve_method']}')", [r["masked"] for r in two],
         allclose=True)
    ens = [r["ensemble"] for r in two]
    e0 = np.asarray(ens[0]["losses"])
    print(f"  MultiSeedEnsemble ({cfg['ens']['n_seeds']} seeds on a "
          f"{len(two)}-rank 'seed' mesh, vmap over 'ge', "
          f"{cfg['ens']['steps']} steps, lr {cfg['ens']['lr']:g}): mean loss "
          f"{e0[0].mean():.6g} -> {e0[-1].mean():.6g}, members "
          f"{max(max(e['member_rel']) for e in ens):.3e} (losses) and "
          f"{max(max(e['member_gap']) for e in ens):.3e} (parameters) from "
          f"their single runs, best seed {ens[0]['best_index']}; fit "
          f"{max(e['fit_seconds'] for e in ens):.2f} s")
    line(f"make_seed_bins_sharded_fused_step (K1, 2 x "
         f"{len(out['four']) // 2} seed x bins mesh)",
         [r["seed_bins"] for r in out["four"]])
    print(f"  groups: {out['two_seconds']:.1f} s ({len(two)} ranks) and "
          f"{out['four_seconds']:.1f} s ({len(out['four'])} ranks), start-up "
          "included; launches over the ranks: " + str(totals))
    rows = {name: dense_row(name, "P") for name in K6}
    return {rows.get(k, k): v for k, v in totals.items()}


def match_sets(a, b) -> float:
    """Greedy max abs distance between the eigenvalue sets of each row,
    over the row's largest |b| (tests/test_functional.py's _match_sets)."""
    a = np.asarray(a).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b).reshape(-1, np.shape(b)[-1])
    worst = 0.0
    for ra, rb in zip(a, b):
        pool = list(rb)
        row = 0.0
        for z in ra:
            j = int(np.argmin(np.abs(np.array(pool) - z)))
            row = max(row, abs(pool.pop(j) - z))
        worst = max(worst, row / max(1e-30, np.abs(rb).max()))
    return worst


def call_ms(fn):
    """``(fn(), ms)``: one call, by CUDA events on the card (the host
    clock on the CPU)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def qr_scenario(B: int, N: int, device="cuda", seed: int = SEED) -> dict:
    """eigvals_qr and eigvals_qr_grad on B seeded N x N complex64
    matrices against torch.linalg.eigvals (values as sets, and a
    sorted-magnitude MSE's loss and gradient), each call timed once."""
    rng = np.random.default_rng(seed)
    A = torch.tensor((rng.normal(size=(B, N, N)) + 1j * rng.normal(
        size=(B, N, N))).astype(np.complex64), device=device)
    t = torch.tensor(rng.uniform(size=(B, N)).astype(np.float32),
                     device=device)

    def value_and_grad(eig):
        X = A.clone().requires_grad_()
        m = torch.sort(torch.abs(eig(X)), dim=-1).values
        loss = torch.mean((m - t) ** 2)
        loss.backward()
        return loss.detach(), X.grad

    z, qr_ms = call_ms(lambda: eigvals_qr(A))
    zl, lib_ms = call_ms(lambda: torch.linalg.eigvals(A))
    (lq, gq), qr_grad_ms = call_ms(lambda: value_and_grad(eigvals_qr_grad))
    (ll, gl), lib_grad_ms = call_ms(
        lambda: value_and_grad(torch.linalg.eigvals))
    return dict(set_err=match_sets(z.cpu().numpy(), zl.cpu().numpy()),
                loss_rel=float((lq - ll).abs() / ll.abs()),
                grad_rel=float((gq - gl).abs().max() / gl.abs().max()),
                qr_ms=qr_ms, lib_ms=lib_ms, qr_grad_ms=qr_grad_ms,
                lib_grad_ms=lib_grad_ms)


def phase_multi_device(card: str, aa) -> dict:
    """The multi-device layer at full width (shard_smoke's families on two
    and four gloo ranks sharing the card) and the QR eigensolver.  Returns
    the ranks' launches by kernels-line row."""
    print(f"phase 4k the multi-device layer (nfft={NFFT}): each sharded "
          "step in lockstep with its unsharded step, gloo ranks on cuda:0; "
          "the QR eigensolver against torch.linalg.eigvals")
    mode = compute_mode()
    print(f"  compute mode: {mode}")
    check(not mode.startswith("Exclusive"), f"the card's compute mode is "
          f"{mode}: it cannot hold two ranks, and phase 4k needs them")
    gain = float(aa.G.param[0])
    SHARD_OUT.parent.mkdir(parents=True, exist_ok=True)
    SHARD_OUT.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "flamo_tpu_torch.scripts.shard_smoke",
           "--gain", repr(gain), "--timeout", str(SHARD_TIMEOUT),
           "--collective-timeout", str(SHARD_COLLECTIVE), "--out",
           str(SHARD_OUT)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=2 * SHARD_TIMEOUT + 120)
    check(r.returncode == 0, f"the ranks failed (exit {r.returncode}):\n"
          f"{r.stdout[-4000:]}\n{r.stderr[-12000:]}")
    print(f"  the families' child process: {time.perf_counter() - t0:.1f} s")
    launches = report_families(json.loads(SHARD_OUT.read_text()),
                               shard_cfg(gain), card)
    for B, N in QR_SHAPES:
        q = qr_scenario(B, N)
        print(f"  eigvals_qr ({B} x {N} x {N} complex64): {q['set_err']:.3e} "
              f"of the max from torch.linalg.eigvals as sets (tol "
              f"{QR_SET_TOL:g}); sorted-magnitude MSE through "
              f"eigvals_qr_grad: loss {q['loss_rel']:.3e} (tol "
              f"{QR_LOSS_TOL:g}), gradient {q['grad_rel']:.3e} of the max "
              f"(tol {QR_GRAD_TOL:g}); ms a call (CUDA events, one call) on "
              f"{card}: eigvals_qr {q['qr_ms']:.1f}, torch.linalg.eigvals "
              f"{q['lib_ms']:.1f}; loss and gradient through "
              f"eigvals_qr_grad {q['qr_grad_ms']:.1f}, through "
              f"torch.linalg.eigvals {q['lib_grad_ms']:.1f}")
        check(q["set_err"] < QR_SET_TOL and q["loss_rel"] < QR_LOSS_TOL
              and q["grad_rel"] < QR_GRAD_TOL,
              f"the QR eigensolver at {B} x {N} x {N}: {q}")
    return launches


# ---------------------------------------------------------------------------
# phase 4l, K1, K2 and K6 past 16 channels (fdn_loop.cu)
# ---------------------------------------------------------------------------
def loop_operands(M: int, N: int, seed: int = SEED, device="cuda",
                  dense: bool = True) -> dict:
    """Operands of the looped kernels at N channels: D of modulus 0.85 with
    random phases, an orthogonal U, gains b and c, a rhs B, K1's X and t,
    and with ``dense`` well-conditioned dense systems A (I plus a normal
    matrix of norm ~0.5) for K6, drawn last (1.6 GB at M_MAIN and 64
    channels)."""
    rng = np.random.default_rng(seed + N)

    def cplx(shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    host = dict(
        D=0.85 * np.exp(1j * rng.uniform(0, 2 * np.pi, (M, N))),
        U=np.linalg.qr(rng.normal(size=(N, N)))[0],
        b=rng.normal(size=N), c=rng.normal(size=N), B=cplx((M, N)),
        X=cplx(M), t=rng.uniform(size=M))
    o = {k: torch.tensor(v.astype(np.complex64 if np.iscomplexobj(v)
                                  else np.float32), device=device)
         for k, v in host.items()}
    if dense:
        o["A"] = (torch.eye(N, dtype=torch.complex64, device=device)
                  + torch.tensor(cplx((M, N, N)).astype(np.complex64),
                                 device=device) / (4 * np.sqrt(N)))
    return o


def k2_twin_check(label: str, y, ref, system, tr: bool, device) -> None:
    """K2's result ``y`` on a k2_systems ``system`` that lies VAL_TOL or
    more from the plain version's ``ref``, held to a complex128 solve of
    the same float32 operands (phase 4n's rule for a system past float32):
    the plain version must itself lie VAL_TOL or more from it, and the
    kernel within AA_TWIN_FACTOR times the plain version's distance."""
    Ds, Us, Bs = k2_tensors(system, device)
    A = fk._loop_matrix(Ds.to(torch.complex128), Us.double(), tr)
    twin = torch.linalg.solve(A, Bs.to(torch.complex128)[..., None])[..., 0]
    plain_gap = rel_err(ref.to(twin.dtype), twin)[1]
    gap = rel_err(y.to(twin.dtype), twin)[1]
    print(f"  {label}: {rel_err(y, ref)[1]:.3e} of the max from the plain "
          f"version, past float32: the plain version {plain_gap:.3e} from "
          f"a complex128 solve, the kernel {gap:.3e} (at most "
          f"{AA_TWIN_FACTOR:g}x the plain version's)")
    check(plain_gap >= VAL_TOL and gap <= AA_TWIN_FACTOR * plain_gap,
          f"{label}: the kernel {gap:.3e} and the plain version "
          f"{plain_gap:.3e} from a complex128 solve")


def k2_loop_checks(N: int, M: int = M_MAIN, device="cuda",
                   o=None, twin: bool = False) -> tuple:
    """K2 looped (both ways) against its plain version on loop_operands
    (``o``, made when None; VAL_TOL) and on k2_systems: pivoting at every
    step, tied pivots and the cycle at VAL_TOL; where the eliminated system
    is diagonal (the tied lower forward and tied upper transposed systems,
    exact), bit for bit, which only the first-maximal-row pivot rule
    gives.  With ``twin`` (the first count above the register-resident
    kernels' range) a k2_systems result VAL_TOL or more from the plain
    version goes to k2_twin_check: at 65 channels the tied lower system's
    transposed solution grows as 2^N, and the plain version's own float32
    solve lies 3.5e-4 of the max from a complex128 one (2000 bins, on a
    CPU).  Returns the max abs error of each direction's kernels-line row
    and the tied systems' count."""
    o = loop_operands(M, N, device=device, dense=False) if o is None else o
    D, U, B = (o[k] for k in "DUB")
    errs = {}
    for tr in (False, True):
        sfx = "_transposed" if tr else ""
        errs[f"fdn_solve_loop{sfx}"] = compare(
            f"K2 looped{sfx.replace('_', ' ')} N={N}",
            fk.fdn_solve_loop_kernel(D, U, B, tr),
            fk.fdn_solve_plain(D, U, B, tr), VAL_TOL)
    tied = 0
    for tr in (False, True):
        systems = k2_systems(np.random.default_rng(SEED + N + tr), M, N, tr)
        for label, system in systems.items():
            Ds, Us, Bs = k2_tensors(system, device)
            y = fk.fdn_solve_loop_kernel(Ds, Us, Bs, tr)
            ref = fk.fdn_solve_plain(Ds, Us, Bs, tr)
            tag = f"K2 looped N={N} {label}{' transposed' if tr else ''}"
            if twin and rel_err(y, ref)[1] >= VAL_TOL:
                k2_twin_check(tag, y, ref, system, tr, device)
            else:
                compare(tag, y, ref, VAL_TOL)
            if label == ("tied upper" if tr else "tied lower"):
                check(torch.equal(y, ref), f"K2 looped N={N} {label}: the "
                      "exact diagonal systems differ from the plain version "
                      "in their bits (another pivot rule)")
                tied += len(y)
    return errs, tied


def loop_kernel_checks(N: int, M: int = M_MAIN, device="cuda") -> dict:
    """K2 looped (both ways, k2_loop_checks), K6 looped (both ways) and K1
    looped (its four variants) against their plain versions on
    loop_operands (values VAL_TOL, cotangents GRAD_TOL of the max).
    Returns the max abs error of each kernels-line row's kernel and the
    tied systems' count."""
    o = loop_operands(M, N, device=device)
    D, U, b, c, B, X, t, A = (o[k] for k in "DUbcBXtA")
    errs, tied = k2_loop_checks(N, M, device, o)
    for tr in (False, True):
        sfx = "_transposed" if tr else ""
        errs[f"dense_solve_loop{sfx}"] = compare(
            f"K6 looped{sfx.replace('_', ' ')} N={N}",
            fk.dense_solve_loop_kernel(A, B, tr),
            fk.dense_solve_plain(A, B, tr), VAL_TOL)
    errs["fdn_tf_mse_loop"] = 0.0
    for pivot, with_dbar in itertools.product((True, False), repeat=2):
        got = fk.fdn_tf_mse_loop_kernel(D, U, b, c, X, t, with_dbar, pivot)
        ref = fk.fdn_tf_mse_plain(D, U, b, c, X, t, with_dbar, pivot)
        tag = f"K1 looped N={N} pivot={pivot} with_dbar={with_dbar}"
        errs["fdn_tf_mse_loop"] = max(
            errs["fdn_tf_mse_loop"],
            compare(f"{tag} loss", got[0], ref[0], VAL_TOL),
            *(compare(f"{tag} {name}", g, r, GRAD_TOL)
              for name, g, r in zip(("D_bar", "U_bar", "b_bar", "c_bar"),
                                    got[1:], ref[1:]) if r is not None))
        check((got[1] is None) == (not with_dbar), f"{tag}: D_bar")
    return errs, tied


REG_KEYS = ("fdn_solve_loop", "fdn_solve_loop_transposed", "fdn_tf_fwd_loop",
            "fdn_tf_bwd_loop", "fdn_sos_tf_mse_loop")


def reg_launch_check(what: str, N: int, device: str,
                     counts: dict | None = None) -> None:
    """On the card: the launches since the last reset_counts (or
    ``counts``) went to the register-resident K2, K3f, K3b and K5
    (REG_KEYS) at REG_MIN_N..REG_MAX_N channels and to the shared-memory
    kernels (their "_smem" keys) above."""
    if device == "cpu":
        return
    counts = nonzero_counts() if counts is None else counts
    smem = sorted(k for k in counts if k.endswith(("_smem",
                                                   "_smem_transposed")))
    reg = sorted(k for k in counts if k in REG_KEYS)
    above = N > fk.REG_MAX_N
    check(bool(smem) == above and bool(reg) != above,
          f"{what} N={N}: launches {counts}; the register-resident kernels "
          f"take {fk.REG_MIN_N}..{fk.REG_MAX_N} channels")


def loop_versus_unrolled(M: int = M_MAIN, device="cuda") -> dict:
    """At N = 16 both kernels run: the looped K2, K6 (both ways) and K1
    (four variants) against the unrolled ones on the same operands, their
    gaps by kernel (values VAL_TOL, cotangents GRAD_TOL of the max)."""
    N = fk.MAX_N
    o = loop_operands(M, N, device=device)
    D, U, b, c, B, X, t, A = (o[k] for k in "DUbcBXtA")
    gaps = {}
    for tr in (False, True):
        tag = " transposed" if tr else ""
        gaps[f"K2{tag}"] = compare(
            f"K2 looped against unrolled N={N}{tag}",
            fk.fdn_solve_loop_kernel(D, U, B, tr),
            fk.fdn_solve_kernel(D, U, B, tr), VAL_TOL)
        gaps[f"K6{tag}"] = compare(
            f"K6 looped against unrolled N={N}{tag}",
            fk.dense_solve_loop_kernel(A, B, tr),
            fk.dense_solve_kernel(A, B, tr), VAL_TOL)
    for pivot, with_dbar in itertools.product((True, False), repeat=2):
        got = fk.fdn_tf_mse_loop_kernel(D, U, b, c, X, t, with_dbar, pivot)
        ref = fk.fdn_tf_mse_kernel(D, U, b, c, X, t, with_dbar, pivot)
        tag = f"K1 pivot={pivot} with_dbar={with_dbar}"
        gaps[tag] = max(
            compare(f"{tag} looped against unrolled N={N} loss", got[0],
                    ref[0], VAL_TOL),
            *(compare(f"{tag} looped against unrolled N={N} {name}", g, r,
                      GRAD_TOL)
              for name, g, r in zip(("D_bar", "U_bar", "b_bar", "c_bar"),
                                    got[1:], ref[1:]) if r is not None))
    return gaps


def step_lockstep(steps: dict, models: dict, x, t, n: int):
    """``n`` calls of each ``steps[route](x, t)`` (a train step that leaves
    its gradients on ``models[route]``), the launches counted apart for
    each route: the loss histories, the first gradients and the launches,
    by route."""
    hist, grads, counts = {}, {}, {}
    for route, step in steps.items():
        reset_counts()
        losses = []
        for i in range(n):
            losses.append(step(x, t))
            if i == 0:
                grads[route] = {k: p.grad.detach().clone() for k, p in
                                models[route].named_parameters()
                                if p.requires_grad}
        counts[route] = nonzero_counts()
        hist[route] = torch.stack(losses).cpu().numpy()
    return hist, grads, counts


def adam_lockstep(models: dict, loss_fn, steps: int, lr: float = LOOP_LR):
    """``steps`` Adam steps of each model on ``loss_fn(model)`` (the 'pallas'
    model's launches counted apart): the loss histories, the first
    gradients and the 'pallas' model's launches."""
    def adam_step(model):
        opt = masked_optimizer(model, lr=lr)

        def step(*_):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model)
            loss.backward()
            opt.step()
            return loss.detach()
        return step

    hist, grads, counts = step_lockstep(
        {route: adam_step(model) for route, model in models.items()},
        models, None, None, steps)
    return hist, grads, counts["pallas"]


def check_lockstep(what: str, hist: dict, grads: dict, loss_tol: float,
                   grad_tol: float = GRAD_TOL, key: str = "pallas"):
    """The ``key`` route's losses within ``loss_tol`` (relative) of 'ge''s
    at every step, each first gradient ``grad_tol`` of its max, the losses
    finite and falling.  Returns (loss gap, gradient gap)."""
    rel = float(np.max(np.abs(hist[key] - hist["ge"])
                       / np.abs(hist["ge"])))
    check(bool(np.isfinite(hist[key]).all()) and rel < loss_tol,
          f"{what}: losses {hist[key]} on {key!r} against "
          f"{hist['ge']} on 'ge', rel {rel:.3e} (tol {loss_tol:g})")
    check(hist[key][-1] < hist[key][0],
          f"{what}: the loss did not fall: {hist[key]}")
    gerr = max(rel_err(grads[key][k], g)[1]
               for k, g in grads["ge"].items())
    check(gerr < grad_tol, f"{what}: first gradients {gerr:.3e} of the max "
          f"apart (tol {grad_tol:g})")
    return rel, gerr


def decaying_target(nfft: int, device) -> torch.Tensor:
    """A seeded noise IR decaying over ~0.1 s: (1, nfft, 1)."""
    rng = np.random.default_rng(SEED)
    return torch.tensor((rng.normal(size=(1, nfft, 1))
                         * np.exp(-np.arange(nfft) / 4800.0)[None, :, None])
                        .astype(np.float32), device=device)


def hfdn_loop_scenario(N: int, nfft: int = NFFT, device="cuda",
                       steps: int = LOOP_STEPS) -> dict:
    """HomogeneousFDNConfig(N) at nfft (its delays hfdn_delays(N)) on
    'pallas' (K2 looped above 16 channels) and 'ge' from one seed: |H|
    within HFDN_TOL of the max (K2 once), then ``steps`` Adam steps of
    mse(model(impulse), a decaying noise IR) in lockstep (K2 and K2
    transposed once each a step)."""
    delays = hfdn_delays(N)
    fdns = {m: HomogeneousFDN(HomogeneousFDNConfig(
        N=N, nfft=nfft, delays=delays, device=device, solve_method=m),
        generator=torch.Generator().manual_seed(SEED))
        for m in ("ge", "pallas")}
    check(all(torch.equal(a, b) for a, b in zip(
        fdns["ge"].model.state_dict().values(),
        fdns["pallas"].model.state_dict().values())),
        f"HomogeneousFDN N={N}: the two builds of one seed differ")
    with torch.no_grad():
        H_ge = fdns["ge"].model.get_freq_response(identity=False).abs()
        reset_counts()
        H = fdns["pallas"].model.get_freq_response(identity=False).abs()
    resp_counts = nonzero_counts()
    check_counts(f"HomogeneousFDN N={N}'s response", resp_counts,
                 {"fdn_solve_loop": 1})
    _, err = rel_err(H, H_ge)
    check(bool(torch.isfinite(H).all()) and err < HFDN_TOL,
          f"HomogeneousFDN N={N}: |H| on 'pallas' {err:.3e} of the max from "
          f"'ge' (tol {HFDN_TOL:g})")
    x = torch.zeros((1, nfft, 1), device=device)
    x[:, 0, :] = 1.0
    target = decaying_target(nfft, device)
    hist, grads, counts = adam_lockstep(
        {m: f.model for m, f in fdns.items()},
        lambda m: mse_loss()(m(x), target), steps)
    check_counts(f"HomogeneousFDN N={N}: {steps} Adam steps", counts,
                 {"fdn_solve_loop": steps,
                  "fdn_solve_loop_transposed": steps})
    rel, gerr = check_lockstep(f"HomogeneousFDN N={N}", hist, grads,
                               LOOP_LOSS_TOL)
    return dict(N=N, delays=delays, err=err, hist=hist, rel=rel,
                grad_err=gerr, counts={"fdn_solve_loop": 1 + steps,
                        "fdn_solve_loop_transposed": steps})


def colorless_loop_scenario(N: int = LOOP_N, nfft: int = NFFT, device="cuda",
                            steps: int = LOOP_STEPS) -> dict:
    """A colorless FDN of N channels (build_colorless_fdn, delays
    hfdn_delays(N)): ``steps`` colorless_fit steps (K1 looped, no pivot,
    once a step) in lockstep with its graph loss on 'ge' (FUSED_LOSS_TOL,
    as phase 3's first loss), then a Trainer whose fused gate takes
    colorless_fused_step and fit_scan's 2 steps (K1 looped once in the
    gate, once a step)."""
    delays = hfdn_delays(N)

    def build():
        return build_colorless_fdn(nfft=nfft, delays=delays, device=device,
                                   generator=torch.Generator().manual_seed(
                                       SEED))

    mk, mg = build(), build()
    x, t = colorless_pair(mk)
    reset_counts()
    _, hist_k = colorless_fit(mk, n_steps=steps)
    counts = nonzero_counts()
    check_counts(f"colorless_fit N={N}", counts, {"fdn_tf_mse_loop": steps})
    step, _ = colorless_train_step(mg)
    hist_g = np.array([float(step(x, t)) for _ in range(steps)])
    rel = float(np.max(np.abs(hist_k - hist_g) / hist_g))
    check(bool(np.isfinite(hist_k).all()) and rel < FUSED_LOSS_TOL
          and hist_k[-1] < hist_k[0],
          f"colorless N={N}: colorless_fit {hist_k} against the graph "
          f"{hist_g}, rel {rel:.3e} (tol {FUSED_LOSS_TOL:g})")
    mt = build()
    reset_counts()
    tr = gated_trainer(mt, x, t, "colorless_fused_step",
                       mse=mse_loss(nfft=nfft),
                       fused="auto" if device == "cuda" else "force")
    hist_tr = tr.fit_scan(x, t, n_steps=2, steps_per_call=2)
    tr_counts = nonzero_counts()
    check_counts(f"the Trainer's fused path N={N}", tr_counts,
                 {"fdn_tf_mse_loop": 3})
    check(bool(np.isfinite(hist_tr).all()) and abs(hist_tr[0] - hist_g[0])
          / hist_g[0] < FUSED_LOSS_TOL, f"the Trainer N={N}: {hist_tr}")
    return dict(N=N, delays=delays, hist=hist_k, hist_graph=hist_g, rel=rel,
                trainer=hist_tr,
                counts={"fdn_tf_mse_loop": steps + 3})


def dense_loop_model(N: int, method: str, nfft: int = NFFT, device="cuda"):
    """Shell(FFT -> [Gain(N,1), Recursion(Series(parallelDelay, orthogonal
    Matrix), orthogonal Matrix), Gain(1,N)] -> abs): a loop whose
    feedforward is not diagonal, so 'pallas' solves the materialized
    I - F B on K6 (looped above 16 channels).  Weights from SEED."""
    g = torch.Generator().manual_seed(SEED)
    common = dict(nfft=nfft, alias_decay_db=30.0, generator=g,
                  device=device)
    delays = hfdn_delays(N)
    dl = dsp.parallelDelay(size=(N,), max_len=int(max(delays)), isint=True,
                           requires_grad=False, **common)
    dl.assign_value(dl.sample2s(torch.tensor(delays, dtype=torch.float32)))
    ff = system.Series({"delays": dl, "mixing": dsp.Matrix(
        size=(N, N), matrix_type="orthogonal", requires_grad=True,
        **common)})
    loop = system.Recursion(fF=ff, fB=dsp.Matrix(
        size=(N, N), matrix_type="orthogonal", requires_grad=True, **common),
        solve_method=method)
    core = system.Series({
        "input_gain": dsp.Gain(size=(N, 1), requires_grad=True, **common),
        "feedback_loop": loop,
        "output_gain": dsp.Gain(size=(1, N), requires_grad=True, **common)})
    return system.Shell(core=core, input_layer=dsp.FFT(nfft),
                        output_layer=dsp.Transform(torch.abs))


def dense_loop_scenario(N: int = LOOP_N, nfft: int = NFFT, device="cuda",
                        steps: int = LOOP_STEPS) -> dict:
    """dense_loop_model on 'pallas' and 'ge': ``steps`` Adam steps of
    mse(|H|, 1) in lockstep (K6 and K6 transposed once each a step)."""
    models = {m: dense_loop_model(N, m, nfft, device)
              for m in ("ge", "pallas")}
    x, t = colorless_pair(models["ge"])
    hist, grads, counts = adam_lockstep(
        models, lambda m: mse_loss()(m(x), t), steps)
    check_counts(f"the dense loop N={N}: {steps} Adam steps", counts,
                 {"dense_solve_loop": steps,
                  "dense_solve_loop_transposed": steps})
    rel, gerr = check_lockstep(f"the dense loop N={N}", hist, grads,
                               LOOP_LOSS_TOL)
    return dict(N=N, hist=hist, rel=rel, grad_err=gerr, counts=counts)


def loop_row(name: str, N: int) -> str:
    return f"{name}@N{N}"


def loop_timing(card: str, launches: dict, errs: dict) -> list:
    """The looped kernels' kernels-line rows at M_MAIN bins: K2 both ways
    at each of LOOP_HFDN_NS, K6 both ways and K1 (the no-pivot variant
    colorless_fit runs) at LOOP_N, each with its device and call ms, its
    plain version's, torch.linalg.solve's on the same systems (K2, K6)
    and its bound; K6's and K1's times at 64 channels (K1's four
    variants at both) in ``at_n64``."""
    rows = []
    for N in (*LOOP_HFDN_NS, *((64,) if 64 not in LOOP_HFDN_NS else ())):
        o = loop_operands(M_MAIN, N)
        D, U, b, c, B, X, t, A = (o[k] for k in "DUbcBXtA")
        A_loop = fk._loop_matrix(D, U)
        At_loop = A_loop.transpose(1, 2)
        for tr in (False, True):
            name = "fdn_solve_loop" + ("_transposed" if tr else "")
            rows.append(timing_row(
                name, loop_row(name, N), M_MAIN,
                lambda tr=tr: fk.fdn_solve_loop_kernel(D, U, B, tr),
                lambda tr=tr: fk.fdn_solve_plain(D, U, B, tr),
                lambda Al=(At_loop if tr else A_loop): torch.linalg.solve(
                    Al, B[..., None]),
                {}, launches, errs, N=N, plain_reps=1, lib_reps=5,
                kernel="reg_solve_kernel", work="fdn_solve",
                plain_events=True,
                previous=lambda tr=tr: fk.fdn_solve_loop_smem_kernel(
                    D, U, B, tr),
                previous_kernel="ge_loop_solve_kernel", reps=REG_REPS))
            reg_occupancy(rows[-1], N, tr)
        dense, k1 = [], []
        for name in ("dense_solve_loop", "dense_solve_loop_transposed",
                     "fdn_tf_mse_loop"):  # not on the path at 64 channels
            launches.setdefault(loop_row(name, N), 0)
        for tr in (False, True):
            name = "dense_solve_loop" + ("_transposed" if tr else "")
            dense.append(timing_row(
                name, loop_row(name, N), M_MAIN,
                lambda tr=tr: fk.dense_solve_loop_kernel(A, B, tr),
                lambda tr=tr: fk.dense_solve_plain(A, B, tr),
                lambda At=(A.transpose(1, 2) if tr else A):
                torch.linalg.solve(At, B[..., None]),
                {}, launches, errs, N=N, plain_reps=1, lib_reps=5,
                kernel="ge_loop_dense_kernel", work="dense_solve",
                plain_events=True))
        k1.append(timing_row(
            "fdn_tf_mse_loop", loop_row("fdn_tf_mse_loop", N), M_MAIN,
            lambda: fk.fdn_tf_mse_loop_kernel(D, U, b, c, X, t, False, False),
            lambda: fk.fdn_tf_mse_plain(D, U, b, c, X, t, False, False),
            None, dict(pivot=False, with_dbar=False), launches, errs, N=N,
            plain_reps=1, kernel="ge_loop_tf_mse_kernel", work="fdn_tf_mse",
            plain_events=True))
        for pivot, with_dbar in itertools.product((True, False), repeat=2):
            ms = device_ms(lambda: fk.fdn_tf_mse_loop_kernel(
                D, U, b, c, X, t, with_dbar, pivot), "ge_loop_tf_mse_kernel")
            bms, bby = bound("fdn_tf_mse", M_MAIN, N, pivot=pivot,
                             with_dbar=with_dbar)
            k1[0].setdefault("variants_ms", {})[
                f"pivot={pivot} with_dbar={with_dbar}"] = ms
            print(f"  fdn_tf_mse_loop N={N} pivot={pivot} with_dbar="
                  f"{with_dbar}: kernel {ms:.6f} ms, bound {bms:.6f} ms "
                  f"({bby}), {ms / bms:.1f}x")
        if N == LOOP_N:
            rows += dense + k1
        else:
            for r in dense + k1:
                by_name = {x["name"].split("@")[0]: x for x in rows
                           if x["name"].endswith(f"@N{LOOP_N}")}
                base = by_name[r["name"].split("@")[0]]
                base["at_n64"] = {k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "call_ms", "max_abs_err", *(("variants_ms",) if
                                                "variants_ms" in r else ()))}
        del o, D, U, b, c, B, X, t, A, A_loop, At_loop
        torch.cuda.empty_cache()
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.6f} ms against its bound "
              f"{r['bound_ms']:.6f} ({r['bound_by']}): "
              f"{r['ms'] / r['bound_ms']:.1f}x; library "
              + ("n/a" if r["library_ms"] is None else
                 f"{r['library_ms']:.4f} ms ({r['library_ms'] / r['ms']:.2f}"
                 "x the kernel)")
              + f"; launches {r['launches']} on {card}")
    reg_gate(rows)
    return rows


def reg_occupancy(row: dict, N: int, transpose: bool = False) -> None:
    """Add to a register-resident kernel's row (K2's, K3f's, K3b's, or K5's
    training variant at K_MAIN sections of P_MAIN taps) the warps resident
    on an SM, as cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them,
    of its block and of the shared-memory kernel's block at the same
    sizes."""
    lib = cuda_build.load(1, fk.LOOP_LIB)
    name = row["name"].split("@")[0]
    if name.startswith("fdn_solve_loop"):
        new = lib.fl_reg_solve_resident_warps(N)
        old = lib.fl_solve_resident_warps(N, int(transpose))
    elif name == "fdn_tf_fwd_loop":
        new = lib.fl_reg_tf_fwd_resident_warps(N)
        old = lib.fl_tf_resident_warps(0, N)
    elif name == "fdn_tf_bwd_loop":
        new = lib.fl_reg_tf_bwd_resident_warps(N)
        old = lib.fl_tf_resident_warps(1, N)
    else:
        new = lib.fl_reg_sos_resident_warps(0, 1, N, K_MAIN, P_MAIN)
        old = lib.fl_sos_resident_warps(0, 0, 1, N, K_MAIN, P_MAIN)
    check(new > 0 and old > 0, f"{row['name']}: resident warps {new}, "
          f"previous {old}")
    row.update(resident_warps=new, previous_resident_warps=old)


def reg_gate(rows: list) -> None:
    """The register-resident kernels' rows (those timed beside the
    shared-memory kernel): each printed with its resident warps, and each
    device time held to PREVIOUS_GATE times the shared-memory kernel's in
    the same call."""
    timed = [r for r in rows if "previous_ms" in r]
    for r in timed:
        print(f"  {r['name']} (fdn_reg.cu): {r['ms']:.6f} ms against the "
              f"shared-memory kernel's {r['previous_ms']:.6f} "
              f"({r['ms'] / r['previous_ms']:.3f}x, at most "
              f"{PREVIOUS_GATE}x); bound {r['bound_ms']:.6f} "
              f"({r['ms'] / r['bound_ms']:.1f}x); warps resident on an SM "
              f"{r['resident_warps']} (previous "
              f"{r['previous_resident_warps']})")
    for r in timed:
        check(r["ms"] <= PREVIOUS_GATE * r["previous_ms"],
              f"{r['name']}: {r['ms']:.6f} ms is more than {PREVIOUS_GATE} "
              f"x the shared-memory kernel's {r['previous_ms']:.6f}")


def loop_paths(nfft: int = NFFT, device="cuda", ns=LOOP_HFDN_NS,
               n: int = LOOP_N) -> dict:
    """Phase 4l's paths: HomogeneousFDN at each of ``ns`` channels, the
    colorless FDN and the dense loop at ``n``."""
    return dict(hfdn=[hfdn_loop_scenario(N, nfft, device) for N in ns],
                colorless=colorless_loop_scenario(n, nfft, device),
                dense=dense_loop_scenario(n, nfft, device))


def loop_report(paths: dict) -> dict:
    """Print phase 4l's paths; returns their launches by kernels-line row
    (the kernel at the path's channel count)."""
    launches = {}

    def add(r):
        for k, v in r["counts"].items():
            launches[loop_row(k, r["N"])] = v

    for h in paths["hfdn"]:
        add(h)
        print(f"  HomogeneousFDN N={h['N']} (delays {min(h['delays'])}.."
              f"{max(h['delays'])}): |H| pallas against ge {h['err']:.3e} of "
              f"the max (tol {HFDN_TOL:g}); {len(h['hist']['ge'])} Adam steps "
              f"{h['hist']['pallas']} against ge {h['hist']['ge']}, rel "
              f"{h['rel']:.3e} (tol {LOOP_LOSS_TOL:g}), first gradients "
              f"{h['grad_err']:.3e} of the max; launches {h['counts']}")
    col = paths["colorless"]
    add(col)
    print(f"  colorless FDN N={col['N']}: colorless_fit {col['hist']} "
          f"against the graph on ge {col['hist_graph']}, rel {col['rel']:.3e} "
          f"(tol {FUSED_LOSS_TOL:g}); the Trainer's gate took "
          f"colorless_fused_step, fit_scan {col['trainer']}; launches "
          f"{col['counts']}")
    den = paths["dense"]
    add(den)
    print(f"  dense loop N={den['N']} (K6): {len(den['hist']['ge'])} Adam "
          f"steps {den['hist']['pallas']} against ge {den['hist']['ge']}, rel "
          f"{den['rel']:.3e} (tol {LOOP_LOSS_TOL:g}), first gradients "
          f"{den['grad_err']:.3e}; launches {den['counts']}")
    print(f"  launches in phase 4l: {launches}")
    return launches


def phase_loop(card: str, unrolled16: BackgroundBuild) -> tuple:
    """K1, K2 and K6 past 16 channels: the looped kernels against their
    plain versions at M_MAIN bins for each of LOOP_NS channels and
    against the unrolled kernels at 16; HomogeneousFDN at LOOP_HFDN_NS
    channels, the colorless FDN and the dense loop at LOOP_N, in lockstep
    with 'ge', with exact launch counts.  Returns the launches and the
    errors by kernels-line row, for loop_timing (run after phase 5: its
    traces of 10-30 ms kernels came back one launch short, and so did
    every trace after them in the same run)."""
    print(f"phase 4l K1, K2 and K6 past 16 channels (fdn_loop.cu, one warp a "
          f"bin; K2 on fdn_reg.cu from {fk.REG_MIN_N} to {fk.REG_MAX_N}; "
          f"M={M_MAIN}, nfft={NFFT})")
    errs = {}
    for N in LOOP_NS:
        reset_counts()
        e, tied = loop_kernel_checks(N)
        reg_launch_check("K2", N, "cuda")
        errs.update({loop_row(k, N): v for k, v in e.items()})
        print(f"  N={N}: the looped kernels held to their plain versions; "
              f"{tied} exact tied systems equal bit for bit")
    for N in (n for n in REG_NS if n not in LOOP_NS):
        reset_counts()
        e, tied = k2_loop_checks(N, twin=N > fk.REG_MAX_N)
        reg_launch_check("K2", N, "cuda")
        errs.update({loop_row(k, N): v for k, v in e.items()})
        print(f"  N={N}: K2 looped held to its plain version both ways on "
              + ("the register-resident kernel" if N <= fk.REG_MAX_N else
                 "the shared-memory kernel, above the register-resident "
                 "one's range")
              + f"; {tied} exact tied systems equal bit for bit")
    t0 = time.perf_counter()
    built = unrolled16.wait()
    print(f"  the unrolled library at N={fk.MAX_N}, built beside phases 1-4k:"
          f" {max(built.values(), default=0.0):.1f} s of nvcc; phase 4l "
          f"waited {time.perf_counter() - t0:.1f} s for it")
    gaps = loop_versus_unrolled()
    print("  looped against unrolled at N=16 (max abs): " + ", ".join(
        f"{k} {v:.3e}" for k, v in gaps.items()))
    return loop_report(loop_paths()), errs


# ---------------------------------------------------------------------------
# phase 4m, K3f, K3b and K5 past 16 channels (fdn_loop.cu)
# ---------------------------------------------------------------------------
def colorless_tf_scenario(N: int, nfft: int = NFFT, device="cuda",
                          steps: int = LOOP_STEPS) -> dict:
    """A colorless FDN of N channels (build_colorless_fdn, delays
    hfdn_delays(N)), two builds from one seed: the fused response
    (colorless_freq_response_fused, K3f once) against get_freq_response
    (VAL_TOL of the max), then ``steps`` Adam steps of
    colorless_train_step(fused_tf=True) (K3f and K3b once each a step) in
    lockstep with colorless_train_step on the graph ('ge'); on the card
    every launch on the register-resident kernels up to REG_MAX_N
    channels (reg_launch_check)."""
    delays = hfdn_delays(N)
    models = {route: build_colorless_fdn(
        nfft=nfft, delays=delays, device=device,
        generator=torch.Generator().manual_seed(SEED))
        for route in ("ge", "fused")}
    x, t = colorless_pair(models["ge"])
    with torch.no_grad():
        H_graph = models["ge"].get_freq_response()
        reset_counts()
        H = colorless_freq_response_fused(models["fused"])
    check_counts(f"the fused response N={N}", nonzero_counts(),
                 {"fdn_tf_fwd_loop": 1})
    reg_launch_check("the fused response", N, device)
    _, resp_err = rel_err(H, H_graph)
    check(bool(torch.isfinite(H).all()) and resp_err < VAL_TOL,
          f"the fused response N={N}: {resp_err:.3e} of the max from "
          f"get_freq_response (tol {VAL_TOL:g})")
    hist, grads, counts = step_lockstep(
        {"ge": colorless_train_step(models["ge"])[0],
         "fused": colorless_train_step(models["fused"], fused_tf=True)[0]},
        models, x, t, steps)
    check_counts(f"the fused-tf step N={N}: {steps} steps", counts["fused"],
                 {"fdn_tf_fwd_loop": steps, "fdn_tf_bwd_loop": steps})
    reg_launch_check("the fused-tf step", N, device, counts["fused"])
    check_counts(f"the graph step N={N}", counts["ge"], {})
    rel, gerr = check_lockstep(f"colorless fused-tf N={N}", hist, grads,
                               FUSED_LOSS_TOL, FUSED_GRAD_TOL, key="fused")
    return dict(N=N, delays=delays, resp_err=resp_err, hist=hist, rel=rel,
                grad_err=gerr, counts={"fdn_tf_fwd_loop": 1 + steps,
                                       "fdn_tf_bwd_loop": steps})


def att_loop_model(N: int, nfft: int = NFFT, device="cuda",
                   octave_interval: int = 1):
    """The attenuated FDN (octave GEQ unless ``octave_interval``) of N
    channels, delays hfdn_delays(N), weights from SEED."""
    return build_attenuated_fdn(
        nfft=nfft, delays=hfdn_delays(N), octave_interval=octave_interval,
        cache_delays=True, device=device,
        generator=torch.Generator().manual_seed(SEED))


def attenuated_loop_scenario(N: int, nfft: int = NFFT, device="cuda",
                             steps: int = LOOP_STEPS,
                             trainer_steps: int = TFSOS_TRAINER_STEPS
                             ) -> dict:
    """The attenuated FDN of N channels (att_loop_model): ``steps`` Adam
    steps of attenuated_train_step(fused_step=True) (K5, no pivot, once a
    step) in lockstep with attenuated_train_step on the graph ('ge', the
    plain cascade), then the Trainer on the same model with an |.|
    output: its gate takes attenuated_fused_step (K5 once) and
    ``trainer_steps`` fit_scan steps (K5 once a step), the first loss the
    graph's."""
    models = {route: att_loop_model(N, nfft, device)
              for route in ("ge", "fused")}
    x, t = time_impulse_pair(nfft, device)
    hist, grads, counts = step_lockstep(
        {"ge": attenuated_train_step(models["ge"], lr=ATT_LR)[0],
         "fused": attenuated_train_step(models["fused"], lr=ATT_LR,
                                        fused_step=True)[0]},
        models, x, t, steps)
    check_counts(f"the attenuated fused step N={N}: {steps} steps",
                 counts["fused"], {"fdn_sos_tf_mse_loop": steps})
    check_counts(f"the attenuated graph step N={N}", counts["ge"], {})
    rel, gerr = check_lockstep(f"attenuated fused step N={N}", hist, grads,
                               FUSED_LOSS_TOL, FUSED_GRAD_TOL, key="fused")
    m = att_loop_model(N, nfft, device)
    model = system.Shell(core=m.core, input_layer=m.input_layer,
                         output_layer=dsp.Transform(torch.abs))
    reset_counts()
    tr = gated_trainer(model, x, t, "attenuated_fused_step", sparsity=False,
                       lr=ATT_LR, mse=mse_loss(nfft=nfft),
                       fused="auto" if device == "cuda" else "force")
    hist_tr = tr.fit_scan(x, t, n_steps=trainer_steps,
                          steps_per_call=trainer_steps)
    check_counts(f"the attenuated Trainer N={N}", nonzero_counts(),
                 {"fdn_sos_tf_mse_loop": 1 + trainer_steps})
    tr_rel = abs(hist_tr[0] - hist["ge"][0]) / hist["ge"][0]
    check(bool(np.isfinite(hist_tr).all()) and tr_rel < FUSED_LOSS_TOL,
          f"the attenuated Trainer N={N}: {hist_tr} against the graph's "
          f"first loss {hist['ge'][0]}, rel {tr_rel:.3e}")
    return dict(N=N, hist=hist, rel=rel, grad_err=gerr, trainer=hist_tr,
                trainer_rel=tr_rel,
                counts={"fdn_sos_tf_mse_loop": steps + 1 + trainer_steps})


def third_octave_loop_check(N: int = TFSOS_NS[-1], nfft: int = NFFT,
                            device="cuda") -> dict:
    """One K5 call on the attenuated FDN of N channels with a 1/3-octave
    GEQ (THIRD_K sections of P_MAIN taps, fused tap sums: the largest
    shared memory of the paths, one warp a block at 64 channels), its
    impulse -> flat operands, against the plain version at the GEQ taps'
    bounds (FUSED_LOSS_TOL, FUSED_GRAD_TOL of the max), every result
    finite."""
    model = att_loop_model(N, nfft, device, octave_interval=3)
    x, t = time_impulse_pair(nfft, device)
    with torch.no_grad():
        D, bt, at, U, b, c = extract_attenuated_operands(model)
        X = torch.fft.rfft(x[0, :, 0], n=nfft)
        args = (D.contiguous(), bt.contiguous(), at.contiguous(), U, b, c,
                X, t[0, :, 0], nfft)
        check(tuple(bt.shape) == (P_MAIN, THIRD_K, N),
              f"the 1/3-octave GEQ's taps are {tuple(bt.shape)}")
        reset_counts()
        got = sk.fdn_sos_tf_mse_kernel(*args)
        counts = nonzero_counts()
        ref = sk.fdn_sos_tf_mse_plain(*args)
    check_counts(f"K5 on the 1/3-octave GEQ N={N}", counts,
                 {"fdn_sos_tf_mse_loop": 1})
    check(all(bool(torch.isfinite(g).all()) for g in got if g is not None),
          f"K5 on the 1/3-octave GEQ N={N}: not finite")
    errs = [compare(f"K5 looped, 1/3-octave GEQ (K={THIRD_K}) N={N} loss",
                    got[0], ref[0], FUSED_LOSS_TOL)]
    for name, g, r in zip(("bt_bar", "at_bar", "U_bar", "b_bar", "c_bar"),
                          got[2:], ref[2:]):
        errs.append(compare(f"K5 looped, 1/3-octave GEQ N={N} {name}", g, r,
                            FUSED_GRAD_TOL))
    return dict(N=N, K=THIRD_K, err=max(errs),
                warps=sk.loop_tf_mse_warps(N, THIRD_K, P_MAIN, True),
                bins=sk.reg_tf_mse_bins(N, THIRD_K, P_MAIN, True),
                counts=counts)


def tfsos_paths(nfft: int = NFFT, device="cuda", ns=TFSOS_NS) -> dict:
    """Phase 4m's paths at each of ``ns`` channels, and the 1/3-octave K5
    call at the last."""
    return dict(colorless=[colorless_tf_scenario(N, nfft, device)
                           for N in ns],
                attenuated=[attenuated_loop_scenario(N, nfft, device)
                            for N in ns],
                third=third_octave_loop_check(ns[-1], nfft, device))


def tfsos_report(paths: dict) -> dict:
    """Print phase 4m's paths; returns their launches by kernels-line row
    (the kernel at the path's channel count)."""
    launches = {}

    def add(r):
        for k, v in r["counts"].items():
            row = loop_row(k, r["N"])
            launches[row] = launches.get(row, 0) + v

    for r in paths["colorless"]:
        add(r)
        print(f"  colorless FDN N={r['N']} (delays {min(r['delays'])}.."
              f"{max(r['delays'])}): the fused response {r['resp_err']:.3e} "
              f"of the max from get_freq_response (tol {VAL_TOL:g}); "
              f"{len(r['hist']['ge'])} fused-tf steps {r['hist']['fused']} "
              f"against the graph on ge {r['hist']['ge']}, rel "
              f"{r['rel']:.3e} (tol {FUSED_LOSS_TOL:g}), first gradients "
              f"{r['grad_err']:.3e} of the max (tol {FUSED_GRAD_TOL:g}); "
              f"launches {r['counts']}")
    for r in paths["attenuated"]:
        add(r)
        print(f"  attenuated FDN N={r['N']}: {len(r['hist']['ge'])} fused "
              f"steps {r['hist']['fused']} against the graph on ge "
              f"{r['hist']['ge']}, rel {r['rel']:.3e} (tol "
              f"{FUSED_LOSS_TOL:g}), first gradients {r['grad_err']:.3e} of "
              f"the max (tol {FUSED_GRAD_TOL:g}); the Trainer's gate took "
              f"attenuated_fused_step, fit_scan {r['trainer']} (first loss "
              f"rel {r['trainer_rel']:.3e}); launches {r['counts']}")
    third = paths["third"]
    add(third)
    print(f"  K5 looped on the 1/3-octave GEQ (K={third['K']}) N="
          f"{third['N']}: {third['bins']} bin(s) a block of the "
          f"register-resident kernel (the shared-memory kernel's "
          f"{third['warps']} warp(s)), max abs err {third['err']:.3e} "
          "against the plain version")
    print(f"  launches in phase 4m: {launches}")
    return launches


def phase_tfsos() -> dict:
    """K3f, K3b and K5 past 16 channels on the slice's paths at
    TFSOS_NS channels, full width, with exact launch counts; returns the
    launches by kernels-line row."""
    print(f"phase 4m K3f, K3b and K5 past 16 channels (fdn_reg.cu from "
          f"{fk.REG_MIN_N} to {fk.REG_MAX_N}, fdn_loop.cu above; "
          f"nfft={NFFT}, N in {TFSOS_NS})")
    return tfsos_report(tfsos_paths())


# ---------------------------------------------------------------------------
# phase 5m, the looped K3f, K3b and K5 against their plain versions and the
# unrolled kernels, then their times
# ---------------------------------------------------------------------------
def tfsos_operands(M: int, N: int, device="cuda") -> dict:
    """loop_operands with K5's: stable taps (K_MAIN sections of P_MAIN)
    and 0.6 U (a loop gain well below 1 with |Gam| near 1), and K3b's
    cotangent of tf."""
    o = loop_operands(M, N, device=device, dense=False)
    bt, at = _stable_taps(np.random.default_rng(SEED + 100 + N), P_MAIN,
                          K_MAIN, N, device)
    o.update(bt=bt, at=at, U6=0.6 * o["U"], tb=o["B"][:, 0].contiguous())
    return o


def k5_loop_args(o) -> tuple:
    """K5's operands on tfsos_operands, its M rows the whole rfft grid of
    2 (M - 1) points."""
    return (o["D"], o["bt"], o["at"], o["U6"], o["b"], o["c"], o["X"],
            o["t"], 2 * (len(o["D"]) - 1))


K5_NAMES = ("loss", "D_bar", "bt_bar", "at_bar", "U_bar", "b_bar", "c_bar")


def k5_compare(tag: str, got, ref) -> float:
    """K5's results against a reference: the loss VAL_TOL, the cotangents
    GRAD_TOL of the max; D_bar present in both or neither."""
    errs = [compare(f"{tag} loss", got[0], ref[0], VAL_TOL)]
    for name, g, r in zip(K5_NAMES[1:], got[1:], ref[1:]):
        check((g is None) == (r is None), f"{tag}: {name}")
        if r is not None:
            errs.append(compare(f"{tag} {name}", g, r, GRAD_TOL))
    return max(errs)


K5_VARIANTS = (*((pivot, with_dbar, True) for pivot, with_dbar in
                 itertools.product((True, False), repeat=2)),
               (False, False, False))
# all eight (pivot, with_dbar, fuse_taps), and those K5_VARIANTS leaves out
K5_ALL = tuple(itertools.product((True, False), repeat=3))
K5_REST = tuple(v for v in K5_ALL if v not in K5_VARIANTS)


def k3_loop_checks(N: int, M: int = M_MAIN, device="cuda",
                   o=None) -> tuple:
    """K3f looped (tf and y VAL_TOL of the max) and K3b looped (cotangents
    GRAD_TOL) against their plain versions on tfsos_operands (``o``, made
    when None); K3f's y on the exact tied systems of k3_systems bit for
    bit (a diagonal left by the elimination, as K2 looped's), K3f and K3b
    there and on the pivoting, cyclic and random systems at
    VAL_TOL/GRAD_TOL (K3b's results that overflow float32 left out).
    Returns the max abs error of each kernels-line kernel and the tied
    systems' count."""
    o = tfsos_operands(M, N, device) if o is None else o
    D, U, b, c = (o[k] for k in "DUbc")
    tf, y = fk.fdn_tf_fwd_loop_kernel(D, U, b, c)
    tf_r, y_r = fk.fdn_tf_fwd_plain(D, U, b, c)
    errs = {"fdn_tf_fwd_loop": max(
        compare(f"K3f looped N={N} tf", tf, tf_r, VAL_TOL),
        compare(f"K3f looped N={N} y", y, y_r, VAL_TOL))}
    errs["fdn_tf_bwd_loop"] = max(
        compare(f"K3b looped N={N} {name}", g, r, GRAD_TOL)
        for name, g, r in zip(K5_NAMES[1:2] + K5_NAMES[4:],
                              fk.fdn_tf_bwd_loop_kernel(D, U, b, c, y,
                                                        o["tb"]),
                              fk.fdn_tf_bwd_plain(D, U, b, c, y, o["tb"])))
    tied = 0
    for tr in (False, True):
        systems = k3_systems(np.random.default_rng(SEED + N + tr), M, N, tr)
        for label, system in systems.items():
            Ds, Us, bs, cs, tbs = k3_tensors(system, device)
            tag = f"N={N} {label}{' transposed' if tr else ''}"
            if not tr:
                tf_k, y_k = fk.fdn_tf_fwd_loop_kernel(Ds, Us, bs, cs)
                _, y_p = fk.fdn_tf_fwd_plain(Ds, Us, bs, cs)
                compare(f"K3f looped {tag} y", y_k, y_p, VAL_TOL)
                if label == "tied lower":
                    check(torch.equal(y_k, y_p), f"K3f looped {tag}: the "
                          "exact diagonal systems' y differs from the plain "
                          "version in its bits (another pivot rule)")
                    tied += len(y_k)
            else:
                _, y_s = fk.fdn_tf_fwd_plain(Ds, Us, bs, cs)
                for name, g, r in zip(
                        K5_NAMES[1:2] + K5_NAMES[4:],
                        fk.fdn_tf_bwd_loop_kernel(Ds, Us, bs, cs, y_s, tbs),
                        fk.fdn_tf_bwd_plain(Ds, Us, bs, cs, y_s, tbs)):
                    if bool(torch.isfinite(r).all()):
                        compare(f"K3b looped {tag} {name}", g, r, GRAD_TOL)
    return errs, tied


def tfsos_kernel_checks(N: int, M: int = M_MAIN, device="cuda",
                        offset: int = TFSOS_OFFSET) -> tuple:
    """K3f and K3b looped (k3_loop_checks) and K5 looped (K5_VARIANTS, and
    the training variant in both fuse_taps modes on the last M - offset
    rows at bin_offset ``offset``) against their plain versions on
    tfsos_operands.  Returns the max abs error of each kernels-line
    kernel and the tied systems' count."""
    o = tfsos_operands(M, N, device)
    b, c = o["b"], o["c"]
    errs, tied = k3_loop_checks(N, M, device, o)
    errs["fdn_sos_tf_mse_loop"] = 0.0
    for pivot, with_dbar, fuse_taps in K5_VARIANTS:
        args = (*k5_loop_args(o), with_dbar, pivot, fuse_taps)
        errs["fdn_sos_tf_mse_loop"] = max(
            errs["fdn_sos_tf_mse_loop"],
            k5_compare(f"K5 looped N={N} pivot={pivot} with_dbar="
                       f"{with_dbar} fuse_taps={fuse_taps}",
                       sk.fdn_sos_tf_mse_loop_kernel(*args),
                       sk.fdn_sos_tf_mse_plain(*args)))
    for fuse_taps in (True, False):
        sl = {k: o[k][offset:] for k in "DXt"}
        args = (sl["D"], o["bt"], o["at"], o["U6"], b, c, sl["X"], sl["t"],
                2 * (M - 1), False, False, fuse_taps, offset)
        k5_compare(f"K5 looped N={N} bin_offset={offset} ({M - offset} rows) "
                   f"fuse_taps={fuse_taps}",
                   sk.fdn_sos_tf_mse_loop_kernel(*args),
                   sk.fdn_sos_tf_mse_plain(*args))
    return errs, tied


def reg_k5_checks(N: int, M: int = M_MAIN, device="cuda",
                  offset: int = TFSOS_OFFSET, variants=K5_ALL,
                  at_offset: bool = True) -> float:
    """K5 looped in ``variants`` against its plain version on
    tfsos_operands (k5_compare: loss VAL_TOL, cotangents GRAD_TOL of the
    max); with ``at_offset`` the training variant in both fuse_taps modes
    on the last M - offset rows at bin_offset ``offset``; the training
    variant on THIRD_K sections of stable taps; every launch on the
    register-resident kernel up to REG_MAX_N channels and on the
    shared-memory one above (reg_launch_check).  Returns the max abs
    error."""
    o = tfsos_operands(M, N, device)
    b, c = o["b"], o["c"]
    reset_counts()
    err = 0.0
    for pivot, with_dbar, fuse_taps in variants:
        args = (*k5_loop_args(o), with_dbar, pivot, fuse_taps)
        err = max(err, k5_compare(
            f"K5 looped N={N} pivot={pivot} with_dbar={with_dbar} "
            f"fuse_taps={fuse_taps}", sk.fdn_sos_tf_mse_loop_kernel(*args),
            sk.fdn_sos_tf_mse_plain(*args)))
    for fuse_taps in (True, False) if at_offset else ():
        sl = {k: o[k][offset:] for k in "DXt"}
        args = (sl["D"], o["bt"], o["at"], o["U6"], b, c, sl["X"], sl["t"],
                2 * (M - 1), False, False, fuse_taps, offset)
        err = max(err, k5_compare(
            f"K5 looped N={N} bin_offset={offset} ({M - offset} rows) "
            f"fuse_taps={fuse_taps}", sk.fdn_sos_tf_mse_loop_kernel(*args),
            sk.fdn_sos_tf_mse_plain(*args)))
    bt, at = _stable_taps(np.random.default_rng(SEED + 200 + N), P_MAIN,
                          THIRD_K, N, device)
    args = (o["D"], bt, at, o["U6"], b, c, o["X"], o["t"], 2 * (M - 1))
    err = max(err, k5_compare(f"K5 looped N={N} K={THIRD_K}",
                              sk.fdn_sos_tf_mse_loop_kernel(*args),
                              sk.fdn_sos_tf_mse_plain(*args)))
    reg_launch_check("K5", N, device)
    return err


def tfsos_versus_unrolled(M: int = M_MAIN, device="cuda") -> dict:
    """At N = 16 both kernels run: the looped K3f, K3b and K5 (K5_VARIANTS)
    against the unrolled ones on the same operands, their gaps by kernel
    (values VAL_TOL, cotangents GRAD_TOL of the max)."""
    N = fk.MAX_N
    o = tfsos_operands(M, N, device)
    D, U, b, c = (o[k] for k in "DUbc")
    tf, y = fk.fdn_tf_fwd_loop_kernel(D, U, b, c)
    tf_u, y_u = fk.fdn_tf_fwd_kernel(D, U, b, c)
    gaps = {"K3f": max(
        compare(f"K3f looped against unrolled N={N} tf", tf, tf_u, VAL_TOL),
        compare(f"K3f looped against unrolled N={N} y", y, y_u, VAL_TOL))}
    gaps["K3b"] = max(
        compare(f"K3b looped against unrolled N={N} {name}", g, r, GRAD_TOL)
        for name, g, r in zip(K5_NAMES[1:2] + K5_NAMES[4:],
                              fk.fdn_tf_bwd_loop_kernel(D, U, b, c, y,
                                                        o["tb"]),
                              fk.fdn_tf_bwd_kernel(D, U, b, c, y, o["tb"])))
    for pivot, with_dbar, fuse_taps in K5_VARIANTS:
        args = (*k5_loop_args(o), with_dbar, pivot, fuse_taps)
        tag = f"K5 pivot={pivot} with_dbar={with_dbar} fuse_taps={fuse_taps}"
        gaps[tag] = k5_compare(f"{tag} looped against unrolled N={N}",
                               sk.fdn_sos_tf_mse_loop_kernel(*args),
                               sk.fdn_sos_tf_mse_kernel(*args))
    return gaps


def tfsos_timing(card: str, launches: dict, errs: dict) -> list:
    """The looped K3f, K3b and K5 (the training variant: no pivot, no
    D_bar, fused taps, K_MAIN sections of P_MAIN taps) at M_MAIN bins and
    each of TFSOS_NS channels: device and call ms, the plain version's
    (CUDA events), the bound and the launches on phase 4m's paths, each
    beside fdn_loop.cu's shared-memory kernel in turns (REG_REPS calls),
    with both kernels' resident warps, held to PREVIOUS_GATE; no single
    PyTorch call computes them."""
    rows = []
    for N in TFSOS_NS:
        o = tfsos_operands(M_MAIN, N)
        D, U, b, c = (o[k] for k in "DUbc")
        _, y = fk.fdn_tf_fwd_loop_kernel(D, U, b, c)
        args = k5_loop_args(o)
        for name, kern, plain, previous, kernel, previous_kernel in (
                ("fdn_tf_fwd_loop",
                 lambda: fk.fdn_tf_fwd_loop_kernel(D, U, b, c),
                 lambda: fk.fdn_tf_fwd_plain(D, U, b, c),
                 lambda: fk.fdn_tf_fwd_loop_smem_kernel(D, U, b, c),
                 "reg_tf_fwd_kernel", "ge_loop_tf_fwd_kernel"),
                ("fdn_tf_bwd_loop",
                 lambda: fk.fdn_tf_bwd_loop_kernel(D, U, b, c, y, o["tb"]),
                 lambda: fk.fdn_tf_bwd_plain(D, U, b, c, y, o["tb"]),
                 lambda: fk.fdn_tf_bwd_loop_smem_kernel(D, U, b, c, y,
                                                        o["tb"]),
                 "reg_tf_bwd_kernel", "ge_loop_tf_bwd_kernel"),
                ("fdn_sos_tf_mse_loop",
                 lambda: sk.fdn_sos_tf_mse_loop_kernel(*args),
                 lambda: sk.fdn_sos_tf_mse_plain(*args),
                 lambda: sk.fdn_sos_tf_mse_loop_smem_kernel(*args),
                 "reg_sos_tf_mse_kernel", "ge_loop_sos_tf_mse_kernel")):
            rows.append(timing_row(
                name, loop_row(name, N), M_MAIN, kern, plain, None, {},
                launches, errs, N=N, plain_reps=1, kernel=kernel,
                work=name.removesuffix("_loop"), plain_events=True,
                previous=previous, previous_kernel=previous_kernel,
                reps=REG_REPS))
            reg_occupancy(rows[-1], N)
        del o, D, U, b, c, y, args
        torch.cuda.empty_cache()
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.6f} ms against its bound "
              f"{r['bound_ms']:.6f} ({r['bound_by']}): "
              f"{r['ms'] / r['bound_ms']:.1f}x; launches {r['launches']} on "
              f"{card}")
    reg_gate(rows)
    return rows


def phase_tfsos_kernels(card: str, launches: dict,
                        unrolled16: BackgroundBuild) -> list:
    """Phase 5m: the looped K3f, K3b and K5 against their plain versions at
    M_MAIN bins for each of REG_NS channels (K5's training variants at
    LOOP_NS) and against the unrolled kernels at 16 (those libraries built
    on a thread beside the earlier phases), every launch on the kernel of
    its size's range (reg_launch_check), then their kernels-line rows."""
    print(f"phase 5m the looped K3f, K3b and K5 at M={M_MAIN} on {card}")
    errs = {}
    for N in LOOP_NS:
        reset_counts()
        e, tied = tfsos_kernel_checks(N)
        reg_launch_check("K3f, K3b, K5", N, "cuda")
        errs.update({loop_row(k, N): v for k, v in e.items()})
        print(f"  N={N}: the looped K3f, K3b and K5 held to their plain "
              f"versions; {tied} exact tied systems' y equal bit for bit")
    for N in (n for n in REG_NS if n not in LOOP_NS):
        reset_counts()
        e, tied = k3_loop_checks(N)
        reg_launch_check("K3f, K3b", N, "cuda")
        errs.update({loop_row(k, N): v for k, v in e.items()})
        print(f"  N={N}: K3f and K3b looped held to their plain versions on "
              + ("the register-resident kernels" if N <= fk.REG_MAX_N else
                 "the shared-memory kernels, above the register-resident "
                 "ones' range")
              + f"; {tied} exact tied systems' y equal bit for bit")
    for N in REG_NS:
        row = loop_row("fdn_sos_tf_mse_loop", N)
        errs[row] = max(errs.get(row, 0.0), reg_k5_checks(
            N, variants=K5_REST if N in LOOP_NS else K5_ALL,
            at_offset=N not in LOOP_NS))
        print(f"  N={N}: K5 looped in all eight variants, at bin_offset "
              f"{TFSOS_OFFSET} and at K={THIRD_K}, held to its plain version "
              + ("on the register-resident kernel" if N <= fk.REG_MAX_N
                 else "on the shared-memory kernel, above the "
                 "register-resident one's range"))
    unrolled16.wait()
    gaps = tfsos_versus_unrolled()
    print("  looped against unrolled at N=16 (max abs): " + ", ".join(
        f"{k} {v:.3e}" for k, v in gaps.items()))
    return tfsos_timing(card, launches, errs)


# ---------------------------------------------------------------------------
# phase 4n, K8 and K9 past 8 microphones (aa_loop.cu)
# ---------------------------------------------------------------------------
def aa_loop_runs() -> list:
    """(launch key, step builder) of phase 4n's runs: K9 looped at 'high',
    'default' and 'highest', then K8 looped."""
    return ([(f"{K9_ROWS[p]}_loop", k9_build(p))
             for p in ("high", "default", "highest")]
            + [("aa_tf_mse_loop", aa_fused_step)])


def aa_loop_rows(o) -> tuple:
    """K8's and K9's operand rows from aa_kernel_operands."""
    return ([o[k] for k in ("hr", "hi", "gr", "gi", "rr", "ri", "t")],
            [o[k] for k in ("hr", "hi", "tw", "rr", "ri", "t")])


def aa_loop_scenario(N: int, nfft: int = NFFT, device="cuda",
                     steps: int = AA_LOOP_STEPS, rir_length: int = AA_RIR,
                     offset: int | None = None) -> dict:
    """Phase 4c's rig at N microphones (aa_rig): the graph loss
    (ge_cached), then ``steps`` Adam steps from the same weights through
    each of aa_loop_runs, each first loss against the float64 twin of its
    function on the same weights (AA_LOSS_TOL or AA_TWIN_FACTOR times the
    plain versions' own distance from it) and the graph (STEP_GRAPH_TOL of
    its kernel; for K9 'default' at least the twin's own distance from the
    graph plus that noise: one TF32 pass of G moves the function by
    3.4e-2 of the loss at 16 microphones), the loss falling, its looped
    kernel launched once a step and nothing else; with ``offset`` one K9
    'high' call on the rows from that bin on, at that bin_offset, held as
    phase 5n holds its calls (aa_loop_result_gap)."""
    model = aa_rig(n_mics=N, nfft=nfft, device=device, rir_length=rir_length)
    x, t = aa_pair(N, nfft, device)
    with torch.no_grad():
        l_graph = float(torch.mean((torch.abs(model(x)) - t) ** 2))
    check(np.isfinite(l_graph), f"the graph loss at N={N} is not finite")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rows8, rows9 = aa_loop_rows(aa_kernel_operands(model))
    # each run's first loss in its plain version (both eliminations) and
    # in the float64 twin of its function, on the same weights
    plain, twin = {}, {}
    with torch.no_grad():
        for name, precision in aa_loop_kernels():
            fn = aa_loop_calls(rows8, rows9, N, nfft, precision)[1]
            plain[name] = [float(fn(pivot)[0]) for pivot in (False, True)]
            twin[name] = float(aa_twin(rows8, rows9, N, nfft, precision)[0])
    runs = {}
    for name, build in aa_loop_runs():
        model.load_state_dict(state)
        step, _ = build(model, x, t, lr=AA_LOOP_LR)
        reset_counts()
        hist = np.array([float(step()) for _ in range(steps)])
        counts = nonzero_counts()
        what = f"{build.__name__} N={N}"
        check_counts(f"{what}: {steps} steps", counts, {name: steps})
        rel = abs(hist[0] - l_graph) / l_graph
        rel_plain = abs(hist[0] - plain[name][0]) / plain[name][0]
        own = max(abs(x - twin[name]) / twin[name] for x in plain[name])
        noise = max(AA_LOSS_TOL, AA_TWIN_FACTOR * own)
        rel_twin = abs(hist[0] - twin[name]) / twin[name]
        twin_graph = abs(twin[name] - l_graph) / l_graph
        tol = STEP_GRAPH_TOL[name.removesuffix("_loop")]
        if name == "aa_taps_tf_mse_tc_default_loop":
            # one TF32 pass of G moves the function itself away from the
            # FP32 graph at this loop's conditioning
            tol = max(tol, twin_graph + noise)
        check(bool(np.isfinite(hist).all()), f"{what}: a loss is not finite")
        check(rel_twin <= noise, f"{what}: first loss {hist[0]} against the "
              f"float64 twin's {twin[name]}, rel {rel_twin:.3e} (tol "
              f"{noise:.3e}: the larger of {AA_LOSS_TOL:g} and "
              f"{AA_TWIN_FACTOR:g} x the plain versions' own {own:.3e})")
        check(rel < tol, f"{what}: first loss {hist[0]} against the graph's "
              f"{l_graph}, rel {rel:.3e} (tol {tol:g}; the twin "
              f"{twin_graph:.3e} from it)")
        check(hist[-1] < hist[0], f"{what}: the loss did not fall: {hist}")
        runs[name] = dict(hist=hist, rel=rel, rel_plain=rel_plain, tol=tol,
                          rel_twin=rel_twin, noise=noise,
                          twin_graph=twin_graph)
    model.load_state_dict(state)
    offset_err = None
    if offset is not None:
        rows = [r if r is rows9[2] else r[:, offset:].contiguous()
                for r in rows9]
        offset_err = aa_loop_result_gap(
            f"K9 looped high N={N} bin_offset={offset}", N,
            ak.aa_taps_tf_mse_kernel(*rows, N, AA_L, nfft, False, "high",
                                     offset),
            [ak.aa_taps_tf_mse_plain(*rows, N, AA_L, nfft, pivot, offset,
                                     "high") for pivot in (False, True)],
            aa_twin(None, rows, N, nfft, "high", offset), rows, False,
            "high", nfft)
    return dict(N=N, graph=l_graph, runs=runs, offset=offset,
                offset_err=offset_err,
                counts={name: steps for name in runs})


def aa_loop_paths(nfft: int = NFFT, device="cuda", ns=AA_LOOP_NS,
                  rir_length: int = AA_RIR, offset: int = AA_OFFSET) -> list:
    """Phase 4n's rigs at each of ``ns`` microphones, the bin-offset call
    at the first."""
    return [aa_loop_scenario(N, nfft, device, rir_length=rir_length,
                             offset=offset if i == 0 else None)
            for i, N in enumerate(ns)]


def aa_loop_report(paths: list) -> dict:
    """Print phase 4n's runs; returns their launches by kernels-line row
    (the kernel at the rig's microphone count)."""
    launches = {}
    for r in paths:
        for name, run in r["runs"].items():
            row = loop_row(name, r["N"])
            launches[row] = launches.get(row, 0) + r["counts"][name]
            print(f"  N={r['N']} {row}: losses {run['hist']} (graph "
                  f"{r['graph']:.7f}), first loss vs graph rel "
                  f"{run['rel']:.3e} (tol {run['tol']:g}; the float64 twin "
                  f"{run['twin_graph']:.3e}), vs the twin "
                  f"{run['rel_twin']:.3e} (tol {run['noise']:.3e}), vs plain "
                  f"{run['rel_plain']:.3e}")
        if r["offset_err"] is not None:
            print(f"  N={r['N']} K9 looped 'high' at bin_offset "
                  f"{r['offset']}: max abs err {r['offset_err']:.3e} against "
                  "the plain version")
    print(f"  launches in phase 4n: {launches}")
    return launches


def phase_aa_loop() -> dict:
    """K8 and K9 past 8 microphones on phase 4c's rig at AA_LOOP_NS
    microphones, full width, exact launch counts; returns the launches by
    kernels-line row."""
    print(f"phase 4n K8 and K9 past 8 microphones (aa_loop.cu, one warp a "
          f"bin): build_active_acoustics(N x {AA_L}, rir_length={AA_RIR}, "
          f"fir_order={AA_ORDER}, nfft={NFFT}, solve_method='ge_cached'), "
          f"N in {AA_LOOP_NS}, {AA_LOOP_STEPS} Adam steps a kernel at lr "
          f"{AA_LOOP_LR:g}")
    return aa_loop_report(aa_loop_paths())


# ---------------------------------------------------------------------------
# phase 5n, the looped K8 and K9 against their plain versions and the
# unrolled kernels, then their times
# ---------------------------------------------------------------------------
def aa_twin(rows8, rows9, N: int, nfft: int, precision: str | None = None,
            off: int = 0) -> tuple:
    """The float64 twin of K8's function (``precision`` None, at rows8's
    G) or of K9's at ``precision`` (G from the precision's split TF32
    operands, or FP32's, summed in float64) on the same rows: the loss
    and, for K8, the S rows (Sr, Si), for K9 the tap cotangent ('default':
    from the TF32 powers and S unrounded, so that the kernel and the
    plain version each carry their own one-pass rounding of S); the
    eliminations pivoted, in complex128."""
    hr, hi, rr, ri, t = (rows9[i].double() for i in (0, 1, 3, 4, 5))
    if precision is None:
        loss, Sr, Si = ak.aa_tf_mse_plain(hr, hi, rows8[2].double(),
                                          rows8[3].double(), rr, ri, t, N,
                                          AA_L, True)
        return loss, (Sr, Si)
    tw, M = rows9[2], hr.shape[-1]
    P2 = torch.cat(ak.dft_powers(tw.shape[0], M, nfft, off, tw.device), 1)
    if precision == "highest":
        G = tw.T.double() @ P2.double()
    else:
        ah, bh = ak.tf32_round(tw.T), ak.tf32_round(P2)
        G = ah.double() @ bh.double()
        if precision == "high":
            G += (ah.double() @ ak.tf32_round(P2 - bh).double()
                  + ak.tf32_round(tw.T - ah).double() @ bh.double())
    loss, Sr, Si = ak.aa_tf_mse_plain(hr, hi, G[:, :M], G[:, M:], rr, ri, t,
                                      N, AA_L, True)
    P2 = ak.tf32_round(P2) if precision == "default" else P2
    return loss, P2.double() @ torch.cat([Sr, -Si], 1).T


def aa_twin_gap(tag: str, got, plains: list, twin, tol: float) -> float:
    """A looped kernel's result against the float64 twin of its function:
    within ``tol`` of the twin's max or within AA_TWIN_FACTOR times the
    plain versions' (``plains``) own distance from it, whichever is
    larger.  Returns the max abs error against the first plain version."""
    err, rel = rel_err(got, plains[0])
    own = max(rel_err(x.double(), twin)[1] for x in plains)
    bound = max(tol, AA_TWIN_FACTOR * own)
    rel_twin = rel_err(got.double(), twin)[1]
    print(f"  {tag}: rel {rel:.3e} from the plain version, {rel_twin:.3e} "
          f"from the float64 twin (tol {bound:.3e}: the larger of {tol:g} "
          f"and {AA_TWIN_FACTOR:g} x the plain versions' own {own:.3e})")
    check(rel_twin <= bound, f"{tag}: {rel_twin:.3e} of the max from the "
          f"float64 twin, past {bound:.3e}")
    return err


def aa_loop_result_gap(tag: str, N: int, got, plains: list, twin, rows9,
                       pivot: bool, precision: str | None, nfft: int) -> float:
    """K8's (``precision`` None) or K9's results, each held by
    aa_twin_gap (the loss at AA_LOSS_TOL, the S rows and the tap cotangent
    at AA_GRAD_TOL), K9 'default''s tap cotangent also elementwise within
    the TF32 pass bound of the first plain version (tf32_bound_gap).  The
    pivot spread that phase 2 holds 'default' to leaves out G's own
    float32 rounding, which this loop's conditioning amplifies (the
    kernel read 4.3 times that spread at 9 microphones on the H100)."""
    errs = [aa_twin_gap(f"{tag} loss", got[0], [p[0] for p in plains],
                        twin[0], AA_LOSS_TOL)]
    if precision is None:
        errs += [aa_twin_gap(f"{tag} {name}", got[i],
                             [p[i] for p in plains], twin[1][i - 1],
                             AA_GRAD_TOL)
                 for i, name in ((1, "S re"), (2, "S im"))]
    else:
        errs.append(aa_twin_gap(f"{tag} tap cotangent", got[1],
                                [p[1] for p in plains], twin[1],
                                AA_GRAD_TOL))
        if precision == "default":
            tf32_bound_gap(tag, got[1], plains[0][1], rows9, pivot, 0, N,
                           nfft)
    return max(errs)


def aa_loop_kernel_checks(N: int, nfft: int = NFFT, device="cuda",
                          rir_length: int = AA_RIR) -> dict:
    """The looped K8 and K9 on the rows of phase 4n's rig at N microphones
    (its initial mixer), both pivot modes, K9 at every precision, held by
    aa_loop_result_gap to the float64 twin of each function (the plain
    versions of both eliminations setting the float32 noise).  Returns the
    max abs error against the plain version of each kernels-line row (the
    no-pivot variant the steps run)."""
    rows8, rows9 = aa_loop_rows(aa_kernel_operands(aa_rig(
        n_mics=N, nfft=nfft, device=device, rir_length=rir_length)))
    errs = {}
    for row, precision in aa_loop_kernels():
        kern, plain = aa_loop_calls(rows8, rows9, N, nfft, precision)
        plains = {pivot: plain(pivot) for pivot in (False, True)}
        twin = aa_twin(rows8, rows9, N, nfft, precision)
        for pivot in (False, True):
            e = aa_loop_result_gap(
                f"{aa_loop_label(precision)} looped N={N} pivot={pivot}", N,
                kern(pivot), [plains[pivot], plains[not pivot]], twin, rows9,
                pivot, precision, nfft)
            if not pivot:
                errs[loop_row(row, N)] = e
        del plains, twin
    return errs


def aa_loop_kernels() -> list:
    """(kernels-line name, K9 precision or None for K8) of the looped
    kernels."""
    return [("aa_tf_mse_loop", None)] + [(f"{row}_loop", p)
                                         for p, row in K9_ROWS.items()]


def aa_loop_label(precision: str | None) -> str:
    return "K8" if precision is None else f"K9 {precision}"


def aa_loop_calls(rows8, rows9, N: int, nfft: int, precision: str | None,
                  looped: bool = True) -> tuple:
    """(kernel(pivot), plain(pivot)) of K8 (``precision`` None) or K9 at
    ``precision`` on the rows: the looped kernel, or with ``looped``
    False the wrapper (the unrolled kernel up to 8 microphones)."""
    if precision is None:
        fn = ak.aa_tf_mse_loop_kernel if looped else ak.aa_tf_mse_kernel
        return (lambda pivot: fn(*rows8, N, AA_L, pivot),
                lambda pivot: ak.aa_tf_mse_plain(*rows8, N, AA_L, pivot))
    fn = (ak.aa_taps_tf_mse_loop_kernel if looped
          else ak.aa_taps_tf_mse_kernel)
    return (lambda pivot: fn(*rows9, N, AA_L, nfft, pivot, precision),
            lambda pivot: ak.aa_taps_tf_mse_plain(*rows9, N, AA_L, nfft,
                                                  pivot, 0, precision))


def aa_loop_versus_unrolled(nfft: int = NFFT, device="cuda",
                            rir_length: int = AA_RIR) -> dict:
    """At 8 microphones both designs run: the looped K8 and K9 (every
    precision, no pivot) against the unrolled kernels on the rows of the
    rig at 8 microphones, their gaps (relative to the loss and to the
    rows' max) printed and returned by kernel; the looped results held as
    in aa_loop_kernel_checks."""
    N = ak.MAX_N
    rows8, rows9 = aa_loop_rows(aa_kernel_operands(aa_rig(
        n_mics=N, nfft=nfft, device=device, rir_length=rir_length)))
    gaps = {}
    for _, precision in aa_loop_kernels():
        kern, plain = aa_loop_calls(rows8, rows9, N, nfft, precision)
        looped = kern(False)
        unrolled = aa_loop_calls(rows8, rows9, N, nfft, precision,
                                 looped=False)[0](False)
        tag = aa_loop_label(precision)
        aa_loop_result_gap(f"{tag} looped N={N}", N, looped,
                           [plain(False), plain(True)],
                           aa_twin(rows8, rows9, N, nfft, precision), rows9,
                           False, precision, nfft)
        loss_gap = rel_err(looped[0], unrolled[0])[1]
        row_gap = max(rel_err(g, r)[1] for g, r in zip(looped[1:],
                                                        unrolled[1:]))
        print(f"  {tag} looped against unrolled N={N}: loss rel "
              f"{loss_gap:.3e}, rows {row_gap:.3e} of the max")
        gaps[tag] = max(loss_gap, row_gap)
    return gaps


def aa_loop_timing(card: str, launches: dict, errs: dict) -> list:
    """The looped K8 and K9 (no pivot, K9 at every precision) on the rigs'
    rows at M_MAIN bins and each of AA_LOOP_NS microphones: device and
    call ms, the plain version's (CUDA events), the bound and the
    launches on phase 4n's steps; no single PyTorch call computes them."""
    rows = []
    for N in AA_LOOP_NS:
        r8, r9 = aa_loop_rows(aa_kernel_operands(aa_rig(n_mics=N)))
        for name, precision in aa_loop_kernels():
            kern, plain = aa_loop_calls(r8, r9, N, NFFT, precision)
            passes = 0 if precision is None else ak.PASSES[precision]
            work = ("aa_tf_mse" if precision is None else
                    "aa_taps_tf_mse_tc" if passes else "aa_taps_tf_mse")
            rows.append(timing_row(
                name, loop_row(name, N), M_MAIN, lambda: kern(False),
                lambda: plain(False), None, {"passes": passes}, launches,
                errs, N=N, plain_reps=1,
                kernel=f"{work.replace('aa_', 'aa_loop_', 1)}_kernel",
                work=work, plain_events=True))
        del r8, r9
        torch.cuda.empty_cache()
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.6f} ms against its bound "
              f"{r['bound_ms']:.6f} ({r['bound_by']}): "
              f"{r['ms'] / r['bound_ms']:.1f}x; launches {r['launches']} on "
              f"{card}")
    return rows


def phase_aa_loop_kernels(card: str, launches: dict) -> list:
    """Phase 5n: the looped K8 and K9 against their plain versions on the
    rigs' rows at M_MAIN bins for each of AA_LOOP_CHECK_NS microphones and
    against the unrolled kernels at 8, then their kernels-line rows."""
    print(f"phase 5n the looped K8 and K9 at M={M_MAIN} on {card}")
    errs = {}
    for N in AA_LOOP_CHECK_NS:
        errs.update(aa_loop_kernel_checks(N))
        print(f"  N={N}: the looped K8 and K9 held to their plain versions")
    gaps = aa_loop_versus_unrolled()
    print(f"  looped against unrolled at N={ak.MAX_N} (relative): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    return aa_loop_timing(card, launches, errs)


def phase_timing(o, launches, errs, card, previous) -> list:
    print(f"phase 5 timing at M={M_MAIN}, N={N_MAIN} on {card}")
    D, U, b, c, B, X, t = (o[k] for k in "DUbcBXt")
    _, y = fk.fdn_tf_fwd_kernel(D, U, b, c)
    # the same kernels on one bin (one block, one bin's chain: the floor)
    # and the previous libraries' K1, K2, K3f and K3b on the same operands
    D1, B1, X1, t1 = (o[k][:1].contiguous() for k in "DBXt")
    y1, tb1 = y[:1].contiguous(), o["tf_bar"][:1].contiguous()
    floors = {
        "fdn_tf_mse": lambda: fk.fdn_tf_mse_kernel(D1, U, b, c, X1, t1,
                                                   False, False),
        "fdn_solve": lambda: fk.fdn_solve_kernel(D1, U, B1),
        "fdn_tf_fwd": lambda: fk.fdn_tf_fwd_kernel(D1, U, b, c),
        "fdn_tf_bwd": lambda: fk.fdn_tf_bwd_kernel(D1, U, b, c, y1, tb1),
    }
    gb, ga, g = o["geq_bt"], o["geq_at"], o["g"]
    g1 = g[:1].contiguous()
    floors.update({  # K4 on one bin (nfft = 1: M = 1)
        "sos_cascade_fwd": lambda: sk.sos_cascade_fwd_kernel(gb, ga, 1),
        "sos_cascade_bwd": lambda: sk.sos_cascade_bwd_kernel(gb, ga, g1,
                                                             NFFT),
    })
    previous_runs = {
        "fdn_solve": lambda: previous.fdn_solve(D, U, B),
        "fdn_tf_mse": lambda: previous.tf_mse(D, U, b, c, X, t, False, False),
        "fdn_tf_fwd": lambda: previous.tf_fwd(D, U, b, c),
        "fdn_tf_bwd": lambda: previous.tf_bwd(D, U, b, c, y, o["tf_bar"]),
        "sos_cascade_fwd": lambda: previous.sos_fwd(gb, ga, NFFT),
        "sos_cascade_bwd": lambda: previous.sos_bwd(gb, ga, g, NFFT),
    }
    A = (torch.eye(N_MAIN, dtype=torch.complex64, device="cuda")[None]
         - D[:, :, None] * U[None].to(torch.complex64))
    runs = {
        "fdn_tf_mse": (lambda: fk.fdn_tf_mse_kernel(D, U, b, c, X, t,
                                                    False, False),
                       lambda: fk.fdn_tf_mse_plain(D, U, b, c, X, t,
                                                   False, False),
                       None, dict(pivot=False, with_dbar=False)),
        "fdn_solve": (lambda: fk.fdn_solve_kernel(D, U, B),
                      lambda: fk.fdn_solve_plain(D, U, B),
                      lambda: torch.linalg.solve(A, B[..., None]), {}),
        "fdn_tf_fwd": (lambda: fk.fdn_tf_fwd_kernel(D, U, b, c),
                       lambda: fk.fdn_tf_fwd_plain(D, U, b, c), None, {}),
        "fdn_tf_bwd": (lambda: fk.fdn_tf_bwd_kernel(D, U, b, c, y,
                                                    o["tf_bar"]),
                       lambda: fk.fdn_tf_bwd_plain(D, U, b, c, y,
                                                   o["tf_bar"]), None, {}),
    }
    # the SOS kernels on the attenuated path's taps and variants
    U6 = 0.6 * U
    k5 = (D, gb, ga, U6, b, c, X, t, NFFT)
    runs.update({
        "sos_cascade_fwd": (lambda: sk.sos_cascade_fwd_kernel(gb, ga, NFFT),
                            lambda: sk.sos_cascade_fwd_plain(gb, ga, NFFT),
                            None, {}),
        "sos_cascade_bwd": (lambda: sk.sos_cascade_bwd_kernel(gb, ga, g,
                                                              NFFT),
                            lambda: sk.sos_cascade_bwd_plain(gb, ga, g,
                                                             NFFT),
                            None, {}),
        "fdn_sos_tf_mse": (lambda: sk.fdn_sos_tf_mse_kernel(*k5),
                           lambda: sk.fdn_sos_tf_mse_plain(*k5), None, {}),
    })
    rows = [timing_row(name, name, M_MAIN, *run, launches, errs,
                       floor=floors.get(name),
                       previous=previous_runs.get(name))
            for name, run in runs.items()]
    # the previous K3f's and K3b's floors, beside the new ones
    by = {r["name"]: r for r in rows}
    by["fdn_tf_fwd"]["previous_floor_ms"] = device_ms(
        lambda: previous.tf_fwd(D1, U, b, c), "fdn_tf_fwd_kernel")
    by["fdn_tf_bwd"]["previous_floor_ms"] = device_ms(
        lambda: previous.tf_bwd(D1, U, b, c, y1, tb1), "fdn_tf_bwd_kernel")
    # K6 on the scattering slice's own loop systems, at the graph step's
    # M bins and at the masked step's P; torch.linalg.solve computes the
    # same function in one call
    for shape, systems in o["dense"].items():
        As, Bs = systems["model"]
        for name in K6:
            tr = name == "dense_solve_transposed"
            At = As.transpose(-1, -2) if tr else As
            A1, B1 = As[:1].contiguous(), Bs[:1].contiguous()
            rows.append(timing_row(
                name, dense_row(name, shape), As.shape[0],
                lambda As=As, Bs=Bs, tr=tr: fk.dense_solve_kernel(As, Bs, tr),
                lambda As=As, Bs=Bs, tr=tr: fk.dense_solve_plain(As, Bs, tr),
                lambda At=At, Bs=Bs: torch.linalg.solve(At, Bs[..., None]),
                {}, launches, errs,
                floor=lambda A1=A1, B1=B1, tr=tr: fk.dense_solve_kernel(
                    A1, B1, tr),
                previous=lambda As=As, Bs=Bs, tr=tr: previous.dense_solve(
                    As, Bs, tr)))
    # K2 transposed (its gradient's launch) beside the previous K2, and
    # both directions' floors, the previous kernel's too; added to K2's row
    k2 = next(r for r in rows if r["name"] == "fdn_solve")
    ms_t, prev_t = versus_previous(
        lambda: fk.fdn_solve_kernel(D, U, B, True),
        lambda: previous.fdn_solve(D, U, B, True), "fdn_solve_kernel")
    D1, B1 = D[:1].contiguous(), B[:1].contiguous()
    k2.update(
        transposed_ms=ms_t, transposed_previous_ms=prev_t,
        transposed_floor_ms=device_ms(
            lambda: fk.fdn_solve_kernel(D1, U, B1, True), "fdn_solve_kernel"),
        previous_floor_ms=device_ms(lambda: previous.fdn_solve(D1, U, B1),
                                    "fdn_solve_kernel"),
        transposed_previous_floor_ms=device_ms(
            lambda: previous.fdn_solve(D1, U, B1, True), "fdn_solve_kernel"),
        vote_share={k: {"bins": v[3][0], "warps": v[3][1]}
                    for k, v in o["k2_graph"].items()})
    # and on the graph step's own operands (phase 4), where fewer warps
    # pivot than on the random ones above
    for key, (Dg, Ug, Bg, share) in o["k2_graph"].items():
        tr = key == "transposed"
        ms_g, prev_g = versus_previous(
            lambda: fk.fdn_solve_kernel(Dg, Ug, Bg, tr),
            lambda: previous.fdn_solve(Dg, Ug, Bg, tr), "fdn_solve_kernel")
        k2[f"graph_{key}_ms"], k2[f"graph_{key}_previous_ms"] = ms_g, prev_g
        print(f"  fdn_solve {key} on the graph step's own operands (pivot-"
              f"vote share: warps {share[1]:.4f}): kernel {ms_g:.6f} "
              f"ms, previous {prev_g:.6f} ({ms_g / prev_g:.3f}x)")
    for pivot in (True, False):
        for with_dbar in (True, False):
            ms_v, prev_v = versus_previous(
                lambda: fk.fdn_tf_mse_kernel(D, U, b, c, X, t, with_dbar,
                                             pivot),
                lambda: previous.tf_mse(D, U, b, c, X, t, with_dbar, pivot),
                "fdn_tf_mse_kernel")
            bms, by = bound("fdn_tf_mse", M_MAIN, N_MAIN, pivot=pivot,
                            with_dbar=with_dbar)
            print(f"  fdn_tf_mse pivot={pivot} with_dbar={with_dbar}: "
                  f"kernel {ms_v:.6f} ms, previous {prev_v:.6f} "
                  f"({ms_v / prev_v:.3f}x), bound {bms:.5f} ms ({by})")
    for pivot, fuse_taps in ((True, False), (False, False), (True, True),
                             (False, True)):
        for with_dbar in (True, False):
            run = (lambda: sk.fdn_sos_tf_mse_kernel(
                *k5, with_dbar=with_dbar, pivot=pivot, fuse_taps=fuse_taps))
            ms_v = device_ms(run, "fdn_sos_tf_mse_kernel")
            ms_all = device_ms(run) if not fuse_taps else ms_v
            bms, by = bound("fdn_sos_tf_mse", M_MAIN, N_MAIN, pivot=pivot,
                            with_dbar=with_dbar, fuse_taps=fuse_taps)
            extra = ("" if fuse_taps else
                     f", with K4b and the sums {ms_all:.4f} ms")
            print(f"  fdn_sos_tf_mse pivot={pivot} fuse_taps={fuse_taps} "
                  f"with_dbar={with_dbar}: kernel {ms_v:.4f} ms{extra}, "
                  f"bound {bms:.5f} ms ({by})")
    # K10 on the micro-benchmark's operands; no PyTorch call computes it.
    # each variant beside its previous kernel and on one bin (its floor:
    # the pass groups or ps's channels, a block each, one bin's chain)
    t, c = p2bench.inputs("cuda")
    nfft = p2bench.NFFT
    t_one = t[:, :1].contiguous()
    p2_rows = []
    for v in pm.VARIANTS:
        p2_rows.append(timing_row(
            f"phase2_{v}", f"phase2_{v}", t.shape[1],
            lambda v=v: pm.phase2_micro(v, t, c, nfft),
            lambda v=v: pm.phase2_micro_plain(v, t, c, nfft), None,
            dict(K=p2bench.K, P=p2bench.P), launches, errs, N=p2bench.N,
            plain_reps=2,
            floor=lambda v=v: pm.phase2_micro(v, t_one, c, nfft),
            previous=lambda v=v: previous.phase2(v, t, c, nfft)))
        row = p2_rows[-1]
        row["registers"], row["local_bytes"] = pm.kernel_attributes(
            v, p2bench.P)
        row["previous_floor_ms"] = device_ms(
            lambda v=v: previous.phase2(v, t_one, c, nfft),
            f"phase2_{v}_kernel")
    print("  K10 registers a thread (local bytes a thread: stack and spills) "
          "at P = "
          f"{p2bench.P}: " + ", ".join(
              f"{r['name']} {r['registers']} ({r['local_bytes']})"
              for r in p2_rows))
    ms = {r["name"]: r["ms"] for r in rows + p2_rows}
    print(f"  K10 beside K5 and K4b in this call (device ms): "
          + ", ".join(f"{v} {ms[f'phase2_{v}']:.6f}" for v in pm.VARIANTS)
          + f"; full - noreduce {ms['phase2_full'] - ms['phase2_noreduce']:.6f}"
          f", lanered - noreduce "
          f"{ms['phase2_lanered'] - ms['phase2_noreduce']:.6f}; K5 "
          f"{ms['fdn_sos_tf_mse']:.6f}, K4b {ms['sos_cascade_bwd']:.6f}")
    # the kernels' own work, every pass a distinct section as in K5's tap
    # phase; bound_ms counts only the distinct passes the function needs
    for r in p2_rows:
        k5ms, k5by = bound(r["name"], t.shape[1], p2bench.N, K=p2bench.K,
                           P=p2bench.P, k5_sections=True)
        r["k5_section_bound_ms"] = k5ms
        print(f"  {r['name']}: bound_ms {r['bound_ms']:.6f} (distinct "
              f"passes, kernel at {r['ms'] / r['bound_ms']:.1f}x); with "
              f"every pass a K5 section {k5ms:.6f} ms ({k5by}), kernel at "
              f"{r['ms'] / k5ms:.2f}x")
    rows += p2_rows
    # K7 on the eigenvalue step's char-polys (torch.linalg.eigvals of their
    # companion matrices computes the same roots in one call), K8 and K9
    # on the magnitude rig's rows, in the variants the trainers run; last,
    # since the library call's trace is timed by CUDA events only
    cr, ci = o["dk_rows"]
    coef = torch.complex(cr, ci).T  # (B, N)
    comp = torch.zeros((coef.shape[0], AA_N, AA_N), dtype=coef.dtype,
                       device="cuda")
    comp[:, 0, :] = -coef
    comp[:, 1:, :-1] = torch.eye(AA_N - 1, dtype=coef.dtype, device="cuda")
    a = o["aa"]
    r8 = [a[k] for k in ("hr", "hi", "gr", "gi", "rr", "ri", "t")]
    r9 = [a[k] for k in ("hr", "hi", "tw", "rr", "ri", "t")]
    rows += [
        timing_row("dk_roots", "dk_roots", cr.shape[1],
                   lambda: ek.dk_roots_rows(cr, ci),
                   lambda: ek.dk_roots_rows_plain(cr, ci),
                   lambda: torch.linalg.eigvals(comp), {}, launches, errs,
                   N=AA_N, plain_reps=2, lib_reps=3, lib_events=True),
        timing_row("aa_tf_mse", "aa_tf_mse", M_MAIN,
                   lambda: ak.aa_tf_mse_kernel(*r8, AA_N, AA_L),
                   lambda: ak.aa_tf_mse_plain(*r8, AA_N, AA_L), None, {},
                   launches, errs, N=AA_N),
    ]
    # K9 at each precision, the FP32 kernel first, it beside the previous
    # FP32 kernel and on one tile of 64 bins (its floor); no PyTorch call
    # computes it
    r9_tile = [x if x is a["tw"] else x[:, :64].contiguous() for x in r9]
    for p, row in K9_ROWS.items():
        fp32 = not ak.PASSES[p]
        rows.append(timing_row(
            "aa_taps_tf_mse_tc" if ak.PASSES[p] else "aa_taps_tf_mse", row,
            M_MAIN,
            lambda p=p: ak.aa_taps_tf_mse_kernel(*r9, AA_N, AA_L, NFFT,
                                                 precision=p),
            lambda p=p: ak.aa_taps_tf_mse_plain(*r9, AA_N, AA_L, NFFT,
                                                precision=p),
            None, {"passes": ak.PASSES[p]}, launches, errs, N=AA_N,
            floor=(lambda: ak.aa_taps_tf_mse_kernel(
                *r9_tile, AA_N, AA_L, NFFT, precision="highest"))
            if fp32 else None,
            previous=(lambda: previous.aa_taps(
                *r9, AA_N, AA_L, NFFT, precision="highest"))
            if fp32 else None))
        if fp32:
            rows[-1]["previous_floor_ms"] = device_ms(
                lambda: previous.aa_taps(*r9_tile, AA_N, AA_L, NFFT,
                                         precision="highest"),
                "aa_taps_tf_mse_kernel")
    # K7's fixed cost (loads, start circle, stores) and its time per
    # Durand-Kerner iteration
    k7 = {n: device_ms(lambda n=n: ek.dk_roots_rows(cr, ci, n),
                       "dk_roots_kernel") for n in (0, 1)}
    k7_ms = next(r["ms"] for r in rows if r["name"] == "dk_roots")
    print(f"  dk_roots at 0 and 1 iterations: {k7[0]:.6f}, {k7[1]:.6f} ms; "
          f"{(k7_ms - k7[0]) / DK_ITERS * 1e6:.1f} ns an iteration over "
          f"{DK_ITERS}")
    k9 = {r["name"]: r["ms"] for r in rows}
    k9 = {p: k9[row] for p, row in K9_ROWS.items()}
    print("  K9 in this call (device ms): "
          + ", ".join(f"{p} {ms:.6f}" for p, ms in k9.items())
          + f"; FP32 / TF32x3 {k9['highest'] / k9['high']:.2f}x")
    by = {r["name"]: r for r in rows}
    redesigned_last(by)
    print("  K6 and K1 beside the previous kernels in this call (device ms; "
          "previous each side of the new, averaged): " + "; ".join(
              f"{n} {by[n]['ms']:.6f} against {by[n]['previous_ms']:.6f} "
              f"({by[n]['ms'] / by[n]['previous_ms']:.3f}x), floor "
              f"{by[n]['floor_ms']:.6f}, bound {by[n]['bound_ms']:.6f}"
              for n in ("dense_solve@P2000", "dense_solve_transposed@P2000",
                        "dense_solve", "dense_solve_transposed",
                        "fdn_tf_mse")))
    for n in ("dense_solve@P2000", "dense_solve_transposed@P2000"):
        aim = max(0.0022, by[n]["floor_ms"] + 0.0005)
        print(f"  {n}: {by[n]['ms']:.6f} ms against the aim {aim:.6f} "
              f"(0.0022, or the floor + 0.0005 when that is larger): "
              f"{'met' if by[n]['ms'] <= aim else 'missed'}")
    for n in ("dense_solve", "dense_solve_transposed"):
        ratio = by[n]["ms"] / by[n]["previous_ms"]
        print(f"  {n} at M={M_MAIN}: {ratio:.3f}x the previous kernel "
              f"(at most 1.05x: {'held' if ratio <= 1.05 else 'exceeded'})")
    print(f"  fdn_tf_mse: {by['fdn_tf_mse']['ms']:.6f} ms against the aim "
          f"0.0040: {'met' if by['fdn_tf_mse']['ms'] <= 0.004 else 'missed'}")
    for n, label, aim in (("sos_cascade_fwd", "K4f", 0.0070),
                          ("sos_cascade_bwd", "K4b", 0.020)):
        r = by[n]
        ratio = r["ms"] / r["previous_ms"]
        print(f"  {label} {n}: {r['ms']:.6f} ms against the aim {aim:.4f}: "
              f"{'met' if r['ms'] <= aim else 'missed'}; previous "
              f"{r['previous_ms']:.6f} ({ratio:.3f}x: "
              f"{'at most' if ratio <= 1 else 'above'} the previous kernel), "
              f"floor (M=1) {r['floor_ms']:.6f}, bound {r['bound_ms']:.6f} "
              f"({r['ms'] / r['bound_ms']:.1f}x), launches {r['launches']}")
    print("  the kernels redesigned in earlier slices, in this call (device "
          "ms): "
          + "; ".join(f"{label} {by[n]['ms']:.6f} (aim {aim}, "
                      f"{by[n]['ms'] / by[n]['bound_ms']:.1f}x its bound "
                      f"{by[n]['bound_ms']:.6f})"
                      for label, n, aim in (
                          ("K5 training variant", "fdn_sos_tf_mse", 0.035),
                          ("K7", "dk_roots", 0.012)))
          + "; controls on the old code: the previous libraries' K1, K2, "
          "K3f, K3b, K6, K4f, K4b, K9 and K10 (previous_ms above)")
    return rows


def redesigned_last(by: dict) -> None:
    """K9 'highest', K2 both ways, K3f, K3b and K10's four variants beside
    their previous kernels in this call: their aims printed, and each held
    to PREVIOUS_GATE times the previous kernel's time."""
    r9, r2 = by[K9_ROWS["highest"]], by["fdn_solve"]
    cases = [("K9 'highest' aa_taps_tf_mse", r9["ms"], r9["previous_ms"],
              r9["floor_ms"], r9["previous_floor_ms"], r9["bound_ms"],
              K9_HIGHEST_AIM),
             ("K2 fdn_solve", r2["ms"], r2["previous_ms"], r2["floor_ms"],
              r2["previous_floor_ms"], r2["bound_ms"], K2_AIM),
             ("K2 fdn_solve transposed", r2["transposed_ms"],
              r2["transposed_previous_ms"], r2["transposed_floor_ms"],
              r2["transposed_previous_floor_ms"], r2["bound_ms"], K2_AIM)]
    cases += [(f"{label} {n}", by[n]["ms"], by[n]["previous_ms"],
               by[n]["floor_ms"], by[n]["previous_floor_ms"],
               by[n]["bound_ms"], aim)
              for label, n, aim in (("K3f", "fdn_tf_fwd", K3F_AIM),
                                    ("K3b", "fdn_tf_bwd", K3B_AIM),
                                    *((f"K10 {v}", f"phase2_{v}", aim)
                                      for v, aim in K10_AIMS.items()))]
    for label, ms, prev, floor, prev_floor, bms, aim in cases:
        ratio = ms / prev
        print(f"  {label}: {ms:.6f} ms against the aim {aim:.4f}: "
              f"{'met' if ms <= aim else 'missed'}; previous {prev:.6f} "
              f"({ratio:.3f}x, at most {PREVIOUS_GATE}x: "
              f"{'held' if ratio <= PREVIOUS_GATE else 'exceeded'}); floor "
              f"{floor:.6f} (previous {prev_floor:.6f}); bound {bms:.6f} "
              f"({ms / bms:.1f}x)")
    ps = by["phase2_ps"]["ms"]
    print(f"  K10 ps {ps:.6f} ms against its stretch aim "
          f"{K10_PS_STRETCH:.4f} (twice 0.002492, its bound with the "
          f"projections counted a pass): "
          f"{'met' if ps <= K10_PS_STRETCH else 'missed'}")
    print(f"  K9 'highest' {r9['ms']:.6f} ms against 'high' (the tensor-core "
          f"kernel, 3 TF32 passes) {by[K9_ROWS['high']]['ms']:.6f} in this "
          f"call: {r9['ms'] / by[K9_ROWS['high']]['ms']:.3f}x")
    for label, ms, prev, *_ in cases:
        check(ms <= PREVIOUS_GATE * prev, f"{label}: {ms:.6f} ms is more "
              f"than {PREVIOUS_GATE} x the previous kernel's {prev:.6f}")


def versus_previous(kern, previous, kernel: str,
                    previous_kernel: str | None = None,
                    reps: int = 50) -> tuple[float, float]:
    """Device ms of ``kern`` and of the previous library's ``previous``
    (its device kernel named ``previous_kernel``, default ``kernel``) in
    turns, previous, new, new, previous, ``reps`` calls each; each pair
    averaged.  When
    device_ms had to time any of the four by CUDA events, all four are
    timed so, so that the two are read on one clock."""
    timed_before = len(EVENT_TIMED)
    pk = previous_kernel or kernel
    p1, k1, k2, p2 = (device_ms(f, name, reps) for f, name in (
        (previous, pk), (kern, kernel), (kern, kernel), (previous, pk)))
    if len(EVENT_TIMED) > timed_before:
        print(f"  {kernel}: the new and previous kernels both timed by "
              "CUDA events, previous, new, new, previous")
        EVENT_TIMED.append(f"{kernel} beside its previous kernel")
        p1, k1, k2, p2 = (time_ms(f, reps)
                          for f in (previous, kern, kern, previous))
    return (k1 + k2) / 2, (p1 + p2) / 2


def timing_row(name, row, M, kern, plain, lib, kw, launches, errs,
               N=N_MAIN, plain_reps=5, lib_reps=20,
               lib_events=False, floor=None, previous=None, kernel=None,
               work=None, plain_events=False,
               previous_kernel=None, reps: int = 50) -> dict:
    """The kernels-line row ``row`` of kernel ``name`` at M rows and N
    channels: device and call times of the kernel, its plain version and
    the library call (None when there is none), its bound, launches and
    error; with ``floor`` the kernel's time on one bin, row or tile, with
    ``previous`` the previous library's beside it.  ``plain_reps``/``lib_reps`` calls are traced and timed (fewer
    for calls that issue thousands of operations: K7's plain version
    runs ~7,000 small kernels).  With ``lib_events`` the library call is
    timed by CUDA events only, and ``library_ms`` is that call time:
    torch.linalg.eigvals on the card takes ~0.8 s a call, mostly off the
    device, and after a profiler trace of it later traces came back
    empty or partial.  ``kernel`` names the device kernel the profiler
    reads (default ``<name>_kernel``), ``work`` the function whose bound
    kernel_work gives (default ``name``); with ``plain_events`` the plain
    version is timed by CUDA events only (the looped kernels' plain
    versions issue ~20,000 device operations a call at 64 channels);
    ``previous_kernel`` names the previous kernel's device kernel where
    it differs; ``reps`` calls are traced for the kernel's (and the
    previous kernel's) device time."""
    retries, timed_before = TRACE_RETRIES[0], len(EVENT_TIMED)
    kernel = kernel or f"{name.removesuffix('_transposed')}_kernel"
    if previous is None:
        ms, previous_ms = device_ms(kern, kernel, reps), None
    else:
        ms, previous_ms = versus_previous(kern, previous, kernel,
                                          previous_kernel, reps)
    ms_by = ("cuda_events" if len(EVENT_TIMED) > timed_before
             else "profiler")
    floor_ms = None if floor is None else device_ms(floor, kernel)
    call_ms = time_ms(kern, reps=200)
    plain_call_ms = time_ms(plain, reps=plain_reps, warmup=1)
    plain_ms = (plain_call_ms if plain_events
                else device_ms(plain, reps=plain_reps))
    library_ms = library_call_ms = None
    if lib is not None:
        library_call_ms = time_ms(lib, reps=lib_reps,
                                  warmup=min(3, lib_reps))
        library_ms = (library_call_ms if lib_events
                      else device_ms(lib, reps=lib_reps))
    bound_ms, bound_by = bound(work or name, M, N, **kw)
    retries = TRACE_RETRIES[0] - retries
    lib_txt = ("n/a" if library_ms is None else
               f"{library_ms:.4f} (call {library_call_ms:.4f})")
    extra = ("" if floor_ms is None else f", floor {floor_ms:.6f}") + (
        "" if previous_ms is None else f", previous {previous_ms:.6f}")
    print(f"  {row} (M={M}): device ms (call ms): kernel {ms:.6f} "
          f"({call_ms:.4f}), plain {plain_ms:.4f} ({plain_call_ms:.3f}), "
          f"library {lib_txt}; bound {bound_ms:.6f} ({bound_by}){extra}"
          + (f"; {retries} trace(s) taken again" if retries else "")
          + ("; kernel timed by CUDA events" if ms_by != "profiler" else ""))
    extra_keys = {k: v for k, v in (("floor_ms", floor_ms),
                                    ("previous_ms", previous_ms))
                  if v is not None}
    return {"name": row, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[row],
            "max_abs_err": errs[row], "ms": ms, "ms_by": ms_by,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "call_ms": call_ms,
            "plain_call_ms": plain_call_ms,
            "plain_ms_by": "cuda_events" if plain_events else "profiler",
            "library_call_ms": library_call_ms, "rows": M,
            "library_ms_by": (None if lib is None else
                              "cuda_events" if lib_events else "profiler"),
            "trace_retries": retries, **extra_keys}


def phase_trace(card: str, label: str, run_steps, step_ms: float,
                steps: int = 10, share: tuple = ()) -> None:
    """Where a training step's time goes: a torch.profiler trace of the
    card's operations in ``run_steps(steps)``, the device's busy time per
    step, its idle share against the traced wall time (the profiler slows
    the host) and against ``step_ms``, the untraced step time, and the
    kernels that take the most device time.  The host's operations are
    not traced: nothing here reads them, and with them the trace's
    post-processing took most of this phase's time.  ``share`` names
    kernels (parts of their names) whose device time is printed with its
    share of the busy time, and which the trace must hold.  The cuBLAS
    GEMMs' time (the MSS loss's DFT products, expm's) is printed
    together."""
    run_steps(3)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(TRACES):  # a trace may come back empty
        if attempt:
            TRACE_RETRIES[0] += 1
            time.sleep(0.2)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_steps(steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = _device_events(prof)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        if busy_ms > 0 and all(any(n in e.key for e in events)
                               for n in share):
            break
        print(f"  the profiler saw {len(events)} device operations in "
              f"{steps} {label} steps"
              + (", none of them " + "/".join(share) if share else "")
              + ("; tracing again" if attempt < TRACES - 1 else ""))
    if busy_ms == 0:
        print(f"phase 6 trace of {steps} {label} steps on {card}: not "
              f"measured, the profiler saw no device time in {TRACES} "
              "traces")
        return
    n_kernels = sum(e.count for e in events)
    print(f"phase 6 trace of {steps} {label} steps on {card}: wall "
          f"{wall_ms / steps:.4f} ms/step (profiler on), device busy "
          f"{busy_ms / steps:.4f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.4f} (traced), "
          f"{1 - busy_ms / steps / step_ms:.4f} (against the untraced "
          f"{step_ms:.4f} ms/step), {n_kernels / steps:.1f} device ops/step")
    for name in share:
        ms = sum(e.self_device_time_total for e in events
                 if name in e.key) / 1e3
        ops = sum(e.count for e in events if name in e.key)
        print(f"  {name}: {ms / steps:.4f} ms/step x{ops / steps:g}, "
              f"{ms / busy_ms:.4f} of the busy time")
    gemm = [e for e in events if "gemm" in e.key]
    ms = sum(e.self_device_time_total for e in gemm) / 1e3
    print(f"  cuBLAS GEMMs: {ms / steps:.4f} ms/step "
          f"x{sum(e.count for e in gemm) / steps:g}, "
          f"{ms / busy_ms:.4f} of the busy time")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:8]:
        print(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
              f"x{e.count / steps:g} {e.key[:90]}")


def aa_magnitude_steps(model, build):
    x, t = aa_pair()
    step, _ = build(model, x, t, lr=AA_LR)
    return lambda n: [step() for _ in range(n)]


def aa_evs_steps(aa):
    tg = torch.full((NFFT // 2 + 1, AA_N), AA_TARGET, device="cuda")
    step, _ = aa_evs_train_step(
        aa, tg, lr=AA_LR, iter_num=AA_ITER_NUM,
        generator=torch.Generator().manual_seed(SEED))
    i = itertools.count()
    return lambda n: [step(next(i)) for _ in range(n)]


def colorless_model(seed: int):
    return build_colorless_fdn(nfft=NFFT, device="cuda",
                               generator=torch.Generator().manual_seed(seed))


def colorless_steps():
    model = colorless_model(3)
    return lambda n: colorless_fit(model, n_steps=n)


def attenuated_steps():
    step, _ = attenuated_train_step(att_model(seed=3), lr=ATT_LR,
                                    fused_step=True)
    x, t = time_impulse_pair(NFFT)
    return lambda n: [step(x, t) for _ in range(n)]


def attenuated_graph_steps():
    step, _ = attenuated_train_step(
        att_model(seed=3, solve_method="pallas", cascade_backend="pallas"),
        lr=ATT_LR)
    x, t = time_impulse_pair(NFFT)
    return lambda n: [step(x, t) for _ in range(n)]


def sfdn_masked_steps():
    step, _ = sfdn_masked_train_step(sfdn_model(seed=3),
                                     n_samples=SFDN_SAMPLES,
                                     solve_method="pallas")
    x, t = sfdn_pair()
    i = itertools.count()
    return lambda n: [step(x, t, next(i)) for _ in range(n)]


def main() -> int:
    t0 = time.perf_counter()
    marks = [t0]

    def seconds_since_last() -> float:
        marks.append(time.perf_counter())
        return round(marks[-1] - marks[-2], 1)

    took = {}
    card, previous, unrolled16 = phase_build(ptxas="--ptxas" in sys.argv[1:])
    try:
        return run_phases(card, previous, unrolled16, t0, took,
                          seconds_since_last)
    finally:
        unrolled16.join()  # no nvcc left running, whatever failed


def run_phases(card, previous, unrolled16, t0, took,
               seconds_since_last) -> int:
    took["1 build"] = seconds_since_last()
    o = main_path_operands(M_MAIN, N_MAIN)
    o["dense"] = dense_operands()
    o["tied"] = tied_operands()
    rig = aa_rig()
    o["aa"] = aa_kernel_operands(rig)
    errs = phase_kernels(o, previous)
    phase_kernels_aa(o["aa"], errs, previous)
    p2_values = phase_kernels_p2(errs, previous)
    took["2 kernels"] = seconds_since_last()
    launches, step_ms, fused_tf_ms, fused_eval_ms = phase_slice(card)
    took["3 colorless"] = seconds_since_last()
    att_launches, att_step_ms, att_graph_ms, o["k2_graph"] = (
        phase_attenuated(card))
    took["4 attenuated"] = seconds_since_last()
    add_counts(launches, att_launches)
    sfdn_launches, sfdn_masked_ms = phase_scattering(card)
    took["4b scattering"] = seconds_since_last()
    launches.update(sfdn_launches)
    aa_launches, aa_step_ms = phase_aa_magnitude(card, rig)
    took["4c aa magnitude"] = seconds_since_last()
    launches.update(aa_launches)
    aa, launches["dk_roots"], evs_ms, o["dk_rows"], dk_err = phase_aa_evs(
        card)
    errs["dk_roots"] = max(errs["dk_roots"], dk_err)
    took["4d aa eigenvalues"] = seconds_since_last()
    launches.update(phase_micro(card, p2_values))
    took["4e micro-benchmark"] = seconds_since_last()
    paved_launches, train_step_ms = phase_paved_road(card)
    took["4f paved road"] = seconds_since_last()
    add_counts(launches, paved_launches)
    e8_launches, e8_ms = phase_e8(card)
    took["4g e8_fdn"] = seconds_since_last()
    add_counts(launches, e8_launches)
    zoo_launches, zoo_ms = phase_zoo(card)
    took["4h filter zoo"] = seconds_since_last()
    add_counts(launches, zoo_launches)
    slice_launches, comb_ms = phase_accurate_velvet(card)
    took["4i accurate GEQ, velvet, tutorials"] = seconds_since_last()
    add_counts(launches, slice_launches)
    reverb_launches, _, ds_ms = phase_reverb(card)
    took["4j reverb"] = seconds_since_last()
    add_counts(launches, reverb_launches)
    add_counts(launches, phase_multi_device(card, aa))
    took["4k multi-device, QR eigensolver"] = seconds_since_last()
    loop_launches, loop_errs = phase_loop(card, unrolled16)
    took["4l past 16 channels"] = seconds_since_last()
    tfsos_launches = phase_tfsos()
    took["4m K3f, K3b, K5 past 16 channels"] = seconds_since_last()
    aa_loop_launches = phase_aa_loop()
    took["4n K8, K9 past 8 microphones"] = seconds_since_last()
    rows = phase_timing(o, launches, errs, card, previous)
    took["5 timing"] = seconds_since_last()
    print(f"phase 5l timing of the looped kernels at M={M_MAIN} on {card}")
    rows += loop_timing(card, loop_launches, loop_errs)
    took["5l timing past 16 channels"] = seconds_since_last()
    rows += phase_tfsos_kernels(card, tfsos_launches, unrolled16)
    took["5m K3f, K3b, K5 past 16 channels"] = seconds_since_last()
    rows += phase_aa_loop_kernels(card, aa_loop_launches)
    took["5n K8, K9 past 8 microphones"] = seconds_since_last()
    phase_trace(card, "colorless_fit", colorless_steps(), step_ms)
    phase_trace(card, "Trainer.train_step (colorless_fused_step: K1)",
                trainer_steps(), train_step_ms, share=("fdn_tf_mse",))
    phase_trace(card, "colorless_train_step (fused_tf: K3f, K3b)",
                fused_tf_steps(colorless_model(3)), fused_tf_ms,
                share=("fdn_tf_fwd", "fdn_tf_bwd"))
    phase_trace(card, "colorless_freq_response_fused (K3f; a call a step)",
                fused_evals(colorless_model(3)), fused_eval_ms,
                share=("fdn_tf_fwd",))
    phase_trace(card, "attenuated_train_step (K5)", attenuated_steps(),
                att_step_ms)
    phase_trace(card, "attenuated_train_step (graph: K4f, K4b, K2)",
                attenuated_graph_steps(), att_graph_ms,
                share=("sos_cascade_fwd", "sos_cascade_bwd", "fdn_solve"))
    phase_trace(card, "sfdn masked (K6)", sfdn_masked_steps(),
                sfdn_masked_ms)
    for scenario in ("fdn", "direct"):
        phase_trace(card, f"e8_fdn {scenario} Trainer.fit_scan (K4f, K4b, "
                    f"K2; mss_loss + sparsity_loss)", e8_steps(scenario),
                    e8_ms[scenario],
                    share=("sos_cascade_fwd", "sos_cascade_bwd",
                           "fdn_solve"))
    phase_trace(card, "e7 peq_biquad Trainer.fit_scan (K4f, K4b; PlainMSE)",
                zoo_steps("peq_biquad"), zoo_ms["peq_biquad"],
                share=("sos_cascade_fwd", "sos_cascade_bwd"))
    phase_trace(card, "e4_recursion_nn comb_nn step (a batch of "
                f"{COMB_BATCH}: K4f, K4b, K6 and K6 transposed once each an "
                "item)", comb_steps(), comb_ms,
                share=("sos_cascade_fwd", "sos_cascade_bwd", "dense_solve"))
    phase_trace(card, "e8_fdn delay_scaled geq Trainer.fit_scan (K2; "
                "parallelFDNGEQ on the plain cascade)", ds_steps(), ds_ms,
                share=("fdn_solve",))
    mss = mss_steps()
    phase_trace(card, f"mss_loss({e8_fdn.MSS_NFFT}) alone, forward and "
                f"backward on a ({E8_BATCH}, {NFFT}, 1) estimate", mss,
                time_ms(lambda: mss(1), reps=10))
    for p in ("high", "highest"):  # the tensor-core K9, then the FP32 one
        phase_trace(card, f"aa_fused_taps_step (K9, {p})",
                    aa_magnitude_steps(rig, k9_build(p)),
                    aa_step_ms[K9_ROWS[p]],
                    share=("aa_taps_tf_mse_tc_kernel" if ak.PASSES[p]
                           else "aa_taps_tf_mse_kernel",))
    phase_trace(card, "aa_fused_step (K8)",
                aa_magnitude_steps(rig, aa_fused_step),
                aa_step_ms["aa_tf_mse"])
    phase_trace(card, "aa_evs_train_step (K7)", aa_evs_steps(aa), evs_ms)
    took["6 traces"] = seconds_since_last()
    print(f"seconds per phase: {took}; traces taken again: "
          f"{TRACE_RETRIES[0]}; timed by CUDA events after {TRACES} empty "
          f"traces: {EVENT_TIMED or 'none'}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
