#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``sup3r_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. environment and build: the card's name and power limit (as
   ``nvidia-smi`` gives them), then every CUDA kernel built from
   ``sup3r_tpu_torch/csrc/`` (into ``build/kernels/``) and the native
   host helpers from ``sup3r_tpu_torch/_native/chunk_prep.cpp`` (into
   ``build/native/``; whether this run built them, and in how many s);
2. each kernel against its plain PyTorch version on the card (TF32 off),
   at every shape the flagship's serving path gives it and at ragged
   ones; tolerance max|kernel - plain| <= 1e-5 * max|plain| (fp32
   accumulation order; ``reflect_conv`` runs 3xTF32 on the tensor cores,
   whose split drops ~2^-22 relative per product). ``small_reflect_conv``
   also at the shipped 8 -> 1 and 8 -> 3 tails and at the edges of its
   tiling, at the WithObs tail's ci 12 and at the batch-1 tail of a
   CondMom forward-pass chunk (``SMALL_CHECKS``);
   ``reflect_conv``'s 2D path at the eight
   block shapes of the Sup3rCC chain's step 0 (``CHAIN_2D_SHAPES``: ci 7
   / 64 / 65, co 64 / 1600 / 6, 14 x 14 and 70 x 70, batch = time 6)
   and at ragged 2D shapes (``RAGGED_2D_CHECKS``); then (2b) both
   routes of a fused block at ``BODY_ROUTE_SHAPES`` (the benchmark's
   node cell's four body shapes, the main path's, the chains' 2D, t = 6
   and tail blocks, a chain chunk at the example's (5, 5, 3) chunks, and
   shapes past the shipped generators): ``reflect_conv`` held to its
   plain version, the kernel on weights packed once and the library
   route (reflect pad, cuDNN, LeakyReLU) each timed twice in turns, and
   every shape ``models/fuse.py::body_kernel_wins`` sends to the kernel
   faster there; then (2c) both routes of a fused 3D block's weight
   gradient at ``WGRAD_ROUTE_SHAPES`` (the train cell's five blocks, phase
   7's, the WithObs tail, the SolarCC member's, and shapes past the
   shipped generators): ``reflect_conv_wgrad`` (dy's packing, the GEMM
   and the reduction) and the library route (reflect pad, cuDNN's fp32
   ``conv3d_weight``, TF32 off) each held to a float64 weight gradient
   (largest error over max |dW|), the kernel bit-equal on a second call,
   each timed twice in turns (CUDA events), and every shape
   ``ops/conv_ad.py::wgrad_kernel_wins`` sends to the kernel faster
   there and within ``WGRAD_ERR_RATIO`` times cuDNN's error. Every
   training path after it holds ``reflect_conv_wgrad``'s launches to the
   fused blocks' weight gradients that gate passes (``GATED``,
   ``check_wgrad``);
3. the main path: the flagship ``spatiotemporal/gen_3x_4x_2f`` generator
   at full width (64 filters, 16 residual blocks, seeded random
   weights) serves 3 requests of ``Sup3rGan.generate`` on a
   (16, 20, 20, 24, 2) low-res batch; the output must be finite, of
   shape (16, 60, 60, 96, 2), ``small_reflect_conv`` must launch
   once per request and ``reflect_conv`` 36 times (every body block at
   these shapes is the gate's). The same requests with every body block
   forced onto cuDNN: timed, and within 1e-5 of the default route's
   largest magnitude. On a small input the served output is held against
   the port's unfused generator on the CPU (rtol 1e-4 of the output's
   max, the repository's fp32 parity bar);
4. the opt-in kernel path (``inference_pallas=True``): 3 more requests,
   ``reflect_conv`` launching 36 times per request, output equal to
   phase 3's within the parity bar (two fp32-accurate routes through
   37 layers);
5. one request of each path under ``torch.profiler`` (device-busy
   time, idle share, the kernels that take the time), then the
   ``kernels`` line: each kernel's time at its main-path shape
   beside its bound on this card, its plain version's time and one
   cuDNN convolution's time (a yardstick the port never calls).
   ``ms`` times the wrapper (CUDA events, weight packing and launch
   included), ``launch_ms`` the launch alone on weights packed once
   (CUDA events), ``kernel_ms`` the kernel alone (torch.profiler device
   events of its name; ``launch_ms``, and ``kernel_ms_by`` says
   ``cuda_events``, where three profiler sessions lost launches),
   ``share_of_bound`` is bound_ms / kernel_ms.
   ``reflect_conv`` also at each of its four main-path shapes and
   (``chain_2d_shapes``) at the chain's eight 2D shapes with their
   calls in phase 10's last opt-in pass (``library_ms`` there is one
   ``F.conv2d`` on a
   4-sided reflect pad; the bound counts 9 taps), ``small_reflect_conv``
   at the 8 -> 1, 2 and 3 tails. ``reflect_conv_wgrad``'s record, last,
   has phase 2c's times, bound and errors at the train cell's five
   blocks (``train_cell_shapes``; ``plain_ms`` is the library route,
   the body's at the top level) and its launches per step of every
   training path.
6. the chunked forward pass (printed before the ``kernels`` line): a
   NetCDF3 input of (64, 64, 40) low-res cells written with the port's
   helper, the full-width flagship saved and loaded through
   ``ForwardPassStrategy`` (chunks of (16, 16, 20), pads 2, so 32 chunks
   of (20, 20, 24) padded in 2 device batches of 16), ``ForwardPass.run``
   to NetCDF output: one warm-up pass, then 3 timed passes on each route
   (wall seconds, HR voxels/s, the prep / dispatch / drain split, the
   fetched MB, the kernels' launches: ``small_reflect_conv`` once per
   dispatch, ``reflect_conv`` 36 times per dispatch on the opt-in route
   and once per block the gate sends it on the default route). Every
   output file is read back (finite, the full (192, 192,
   160) domain tiled); on a small domain the card's per-chunk outputs
   equal the port's CPU forward pass and the batched ones the serial
   ones (the parity bar); one dispatched batch's device pack agrees
   with the host transform within one storage quantum and its stats
   with ``_output_check``.

7. training (printed before the ``kernels`` line): the gradients of
   ``small_reflect_conv``'s Function at the 8 -> 1, 2, 3 training tails
   (alpha None and 0.2) and of ``reflect_conv_ad``'s against autograd of
   their plain compositions (TF32 off; 1e-5 of the plain gradients'
   largest magnitude); one full-width flagship step at batch 2 on the
   card against the port's CPU step from the same weights, batch and
   optimizer state, for the three gating cases (losses, updated weights
   and Adam moments within 1e-4 of each tensor's largest magnitude);
   bench.py's training cell (batch 16, LR (12, 12, 12, 2), HR (36, 36,
   48, 2), Adam lr 1e-4, both networks): median step ms over 12 steps
   after 3 warm-ups (host clock, loss fetch included), HR voxels/s,
   launches per step (``small_reflect_conv`` 1, ``reflect_conv`` 0),
   peak memory; the device time of each phase of a step (CUDA events),
   one profiled step (idle share, top kernels), the small kernel's two
   cuDNN backward convs and the pads and halo folds of a step; and
   ``Sup3rGan.train`` over a ``BatchHandler`` of fake data (2 epochs of
   4 batches, validation, checkpoint reloaded, ``generate`` of the
   reloaded model).
8. fast and 'custom' serving (printed before the ``kernels`` line): the
   full-width flagship on phase 3's input in fast mode (the subpixel
   tail and a bf16 body on cuDNN): 5 timed requests after a warm-up, HR
   voxels/s, ``fast_max_rel_err`` against the exact output (<= 0.04 of
   its largest magnitude, docs/PERFORMANCE.md), one profiled request
   (busy, idle, the device-to-host copy), no kernel launched; the
   'custom' mode (the subpixel tail in float32, the body on
   ``reflect_conv``): within 1e-4 of exact, 36 ``reflect_conv`` launches
   per request; fast mode with ``inference_pallas=True`` refused for the
   fp32-only kernel; phase 6's forward-pass cell with
   ``inference_mode='fast'``: 3 timed passes, each stitched output
   within 0.05 of the exact pass on the data scale.
9. training modes (printed before the ``kernels`` line): phase 7's cell
   with ``train_dtype='bfloat16'`` (median step ms, HR voxels/s, peak
   memory, the device ms of each phase, one profiled step, the ratio to
   the float32 step; no kernel launched: both take float32 only);
   tests/training/test_bf16_train.py's small fixture trained in float32
   and in bf16 on the card (losses within rtol 0.05 / atol 0.02, the
   first kernel within 0.01, float32 master weights and moments); the
   cell with ``train_remat=True`` (step ms, peak memory,
   ``small_reflect_conv`` twice per step, gradients within 1e-5 of the
   plain step's largest magnitude); the memory each mode's forward keeps
   and the peak of each part of a step; and ``Sup3rGan.train`` in bf16 over
   a ``DualBatchHandler`` of paired NetCDF3 files (``DataHandler`` ->
   ``DualRasterizer``), 2 epochs of 4 batches of 16 (s per batch,
   starvation rate).
10. the Sup3rCC wind chain (printed before the ``kernels`` line): a
   ``MultiStepGan`` of ``sup3rcc/gen_wind_5x_1x_6f`` (5x spatial, 4D,
   topography as an input channel and through its Sup3rConcat layer)
   and ``sup3rcc/gen_wind_1x_24x_6f`` (24x ``depth_to_time``, 5D), both
   at full width from seed 0, saved and loaded through
   ``ForwardPassStrategy(model_class='MultiStepGan',
   exo_handler_kwargs={'topography': ...})`` over a daily NetCDF3 input
   of (30, 30, 8) low-res cells with six features and a NetCDF3
   topography source: chunks (10, 10, 4), pads 2 / 1, so 18 chunks
   padded to (14, 14, 6), run chunk by chunk (a chain has no
   ``fetch=``). The cold exo rasterization, then 3 timed passes to
   NetCDF on each route (wall s, HR voxels/s over the (150, 150, 192)
   HR domain, the stage split, the wrappers' launch counts, the 2D and
   3D ``reflect_conv`` launches apart: the gate's blocks on the default
   route, 38 2D and 36 3D per chunk on the opt-in route, as counted from
   the fused
   networks; the last opt-in pass also hooks every fused block and
   checks each 2D call's shape against ``CHAIN_2D_SHAPES`` and the calls
   of each rank against the wrapper's count), one profiled pass per
   route; every file read back (finite, the full domain, six features),
   the routes within the parity bar of each other, one chunk of a small
   domain on the card within the parity bar of the port's CPU chain,
   and a test-sized 5D topography GAN through the device-batched exo
   path equal to its chunk-by-chunk run (each feature held to 1e-4 of
   its own largest magnitude).
11. the Sup3rCC solar chain and SolarCC training (printed before the
   ``kernels`` line): a ``SolarMultiStepGan`` of phase 10's spatial wind
   member, ``generator_cc_spatial(1, 5, with_topography=False)`` for
   clearsky_ratio and a ``SolarCC`` on ``sup3rcc/gen_solar_1x_8x_1f`` (64
   filters, 16 residual blocks, 8x ``depth_to_time``) served at 24x, all
   at full width from seed 0, through ``ForwardPassStrategy(model_class=
   'SolarMultiStepGan')`` over phase 10's domain with clearsky_ratio in
   [0, 1] beside the six features: 18 chunks chunk by chunk, HR (150, 150,
   192) of clearsky_ratio to NetCDF. 3 timed passes and one profiled pass
   per route (wall s, HR voxels/s, busy / idle, D2H ms); the wrappers'
   launches by rank (the gate's blocks on the default route; 76 2D and
   36 3D blocks
   per chunk on the opt-in route), equal to the hooked block calls of the
   last opt-in pass, by shape (``CHAIN_2D_SHAPES``, ``SOLAR_2D_SHAPES``,
   ``SOLAR_3D_SHAPES``); the routes, and one chunk of a small domain
   against the port's CPU chain, within 1e-4 of max. Then SolarCC
   training with ``spatiotemporal/disc_test``: a batch 2 step on the card
   against the CPU's for the three gates (as phase 7), the timed cell
   (batch 8 of LR (20, 20, 9, 3) -> HR (20, 20, 72, 1) from
   ``default_rng(1)``: median step ms of 12 after 3 warm-ups, launches,
   the step's peak, one profiled step) and ``SolarCC.train`` over a
   ``BatchHandlerCC`` of ``DataHandlerH5SolarCC`` data from NetCDF3
   files, 2 epochs of 4 batches of 8 with validation (s per batch,
   starvation), the checkpoint reloaded at 24x. After the phase, each new
   ``reflect_conv`` shape (``SOLAR_NEW_SHAPES``) is held to its plain
   version (1e-5 of max) and timed for the ``kernels`` line
   (``solar_chain_shapes``).

12. the Sup3rCC trh chain, observations and data-centric training
   (printed before the ``kernels`` line): a ``MultiStepSurfaceMetGan`` of
   the physics ``SurfaceSpatialMetModel`` (5x; temperature and relative
   humidity) and ``sup3rcc/gen_trh_1x_24x_2f`` (64 filters, 16 residual
   blocks, 32 x 24 channels before ``depth_to_time``) at full width from
   seed 0, through ``ForwardPassStrategy(model_class=
   'MultiStepSurfaceMetGan')`` over phase 10's domain with a smooth
   NetCDF3 topography: the surface step on the whole domain against its
   float64 version on the CPU (1e-5 of each field's max) and its device
   ms a padded chunk, 3 timed passes and one profiled pass per route,
   launches equal to the temporal member's hooked block calls by shape
   (``TRH_3D_SHAPES``; the gate's on the default route, 36 a chunk
   opt-in), the
   routes and a chunk against the port's CPU chain within 1e-4 of each
   feature's max. Then ``Sup3rGanWithObs`` on the flagship with
   ``Sup3rConcatObs`` for u and v before its tail (12 -> 2 on
   ``small_reflect_conv``): the kernel's gradients at ci 12, a batch 2
   card step against the CPU's (three gates, float64 conditioning), the
   training cell timed and profiled, ``generate`` with observation
   rasters and a ForwardPass whose ``ObsRasterizer`` reads a NetCDF3
   station grid; and ``Sup3rGanDC.train`` over a ``BatchHandlerDC`` (4 x
   2 bins, 2 epochs of 4 batches of 16): s per batch, starvation, the bin
   weights a probability vector off uniform. After the phase, the trh
   chain's new ``reflect_conv`` shapes (``TRH_NEW_SHAPES``) and the ci 12
   tail are held to their plain versions and timed for the ``kernels``
   line (``trh_chain_shapes``, ``obs_shape``).

13. the conditional-moment family, training sessions and the reference
   import (printed before the ``kernels`` line): the flagship generator
   as a ``Sup3rCondMom`` (64 filters, 16 residual blocks, seed 0). One
   Mom1 step at batch 2 on the card against the port's CPU step (Adam
   epsilon 1; the loss within 1e-4, weights, mu and nu as phase 7 holds
   them, against the fp32 conditioning a float64 step shows); the Mom1
   training cell (phase 7's batch from ``default_rng(1)`` with a mask of
   s_padding 1 and t_padding 1): median step ms of 12 after 3 warm-ups,
   launches per step (``small_reflect_conv`` 1), the step's peak, one
   profiled step (idle share); ``Sup3rCondMom.train`` over a
   ``BatchHandlerMom1`` of fake (72, 72, 240) u/v data through a
   ``TrainingSession`` with ``tensorboard_log=True`` (2 epochs of 4
   batches of 16, validation; without the tensorboard package it warns
   and finishes): s per batch, starvation; a ``BatchHandlerMom2`` whose
   producer thread runs that model on the card for the targets: its
   loop's s per batch and starvation, and 4 batches' targets against
   ``(hr - mom1.generate(lr))^2`` on the card (1e-5 of max: TF32 stayed
   off in the producer thread), then 3 times one step of that model
   queued behind a sleep and followed at once by its ``batch_output`` on
   its side stream, held to its ``generate`` (the side stream waited for
   the new weights); the Mom1
   checkpoint through the chunked ``ForwardPass(model_class=
   'Sup3rCondMom')`` on phase 6's cell chunk by chunk (3 timed passes, HR
   voxels/s, ``small_reflect_conv`` once a chunk, every file read back;
   the last pass hooks the tail's calls by shape, all at
   ``COND_FWP_TAIL_SHAPE``, and holds its first full-size chunk to the
   port's CPU ``generate`` at 1e-4 of max) and a small domain against the
   port's CPU pass (1e-4); phase 7's flagship exported with
   ``export_reference_gan`` and read back with
   ``load_reference_gan(device='cuda')`` (one request within 1e-6); and
   ``Sup3rGan.train(tensorboard_profile=True)`` over phase 7's loop (the
   trace file's size, the profiled epoch's seconds against an
   unprofiled one's). After the phase, ``small_reflect_conv`` is held to
   its plain version and timed at ``COND_FWP_TAIL_SHAPE`` for the
   ``kernels`` line (``cond_mom_fwp_shape``).

14. streaming input and the GCM handler (printed before the ``kernels``
   line), on the flagship at full width from seed 0: bench.py's
   end-to-end cell (bench.py:104-128) in the card's I/O form (``io``:
   NetCDF3 in, NetCDF out), a (40, 40, 40) u / v domain, chunks (16, 16,
   20), pads 2, device batch 8 (18 chunks; batches group chunks of one
   padded shape, so 4 dispatches). On each
   route the eager pass and the ``chunked_io`` pass of the same strategy,
   3 timed each after a warm-up (wall s, HR voxels/s, the strategy
   timer's prep s per chunk, launches as phase 6 counts them), the
   ``chunked_io`` output equal to the eager one within 1e-6 of max, one
   profiled ``chunked_io`` pass (idle share); a chunk of the card's pass
   against the port's CPU pass (1e-4 of max); the native pad
   (``_native.reflect_pad_4d``, the pass's ``pad_source_data``) bit-equal
   to ``np.pad`` on every chunk of the cell, with the chunk prep's ms a
   chunk (read + pad) with each pad (``native_pad``). The same geometry through
   ``DataHandlerNCforCCwithPowerLaw`` (hourly NetCDF3 uas / vas, u_100m /
   v_100m by the power law) with ``chunked_io`` on the default route: 3
   timed passes and a chunk against the CPU. Phase 7's training cell fed
   by a ``BatchHandler`` over ``DataHandler(mode='lazy')`` on a NetCDF3
   (72, 72, 240) u / v file, 2 epochs of 4 batches, then over eager
   handlers (s per batch, starvation), after the first lazy batch is held
   to the eager one (single-threaded, same seed: HR bit-equal, LR within
   an ulp). After the phase, every kernel shape the last timed
   ``chunked_io`` pass of each route gave (read by hooks, their count
   equal to the wrappers' launches) is held to its plain version (1e-5
   of max), and the most-called one of each kernel is timed for the
   ``kernels`` line (``chunked_io_shape``).

15. bias correction (printed before the ``kernels`` line). (a) Seeded
   synthetic NetCDF3 calibration data, daily for 10 years: u / v and a
   precipitation-like ``pr`` with dry days on phase 14's (40, 40) LR grid
   (history and a shifted future) and a baseline on an (80, 80) grid over
   the same area, read through ``LoaderNC`` and the flat gid adapter.
   ``QuantileDeltaMappingCorrection`` of u and of v and ``PresRat`` of pr
   (101 quantiles, 24 day-of-year windows, the defaults), each run on the
   card (``run(use_device=True)``: the batched ``torch.nanquantile`` and,
   for PresRat, the batched QDM of the future series) and, but for v,
   on the host (``run(use_device=False)``) in the same process: wall s
   of each and of the percentiles alone, every output raster of the
   card against the host's (rtol 2e-4 / atol 2e-2, the JAX package's
   bar, tests/bias/test_qdm_device.py:64) and their NaN masks equal; the
   card's rasters are written as NetCDF3 factor files. (b) Phase 14's cell with
   ``bias_correct_method='local_qdm_bc'`` on both wind features: the
   corrected first chunk equal to ``local_qdm_bc`` of the raw chunk, then
   eager and ``chunked_io`` on both routes, 3 timed passes each after a
   warm-up (wall s, HR voxels/s and prep s a chunk beside phase 14's
   uncorrected passes), ``chunked_io`` equal to eager (1e-6 of max), a
   chunk against the port's CPU pass with the correction (1e-4 of max),
   then one ``local_presrat_bc`` pass on the default route. (c) The
   flagship as a ``Sup3rCondMom`` trained with phase 13's Mom1 loop (2
   epochs of 4 batches of 16) over a ``BatchHandlerMom1`` of
   ``DataHandlerNCforCCwithPowerLaw`` handlers of hourly NetCDF3 uas / vas
   ((40, 40, 240) and (40, 40, 96)), each corrected in place by
   ``qdm_bc`` from (a)'s files (held to ``local_qdm_bc`` of the raw
   fields, 1e-5 of max): s per batch and starvation beside phase 13's
   loop. After the phase, every kernel shape the last ``chunked_io`` pass
   of each route and the training loop gave (the recorded wrapper calls,
   their count equal to the launches) is held to its plain version (1e-5
   of max); the ``kernels`` line gives their launches
   (``launches_per_bias_corrected_chunked_io_pass``,
   ``launches_per_bias_fed_train_loop``) and the shapes checked.

16. the production pipeline (printed before the ``kernels`` line):
   phase 14's cell run as a user runs it, ``sup3r_tpu_torch/cli.py -c
   config_pipeline.json pipeline --monitor`` from a run directory outside
   the repo with no ``PYTHONPATH``: forward-pass (``chunked_io``, NetCDF
   out, two nodes, a log file each, no device named: the card),
   data-collect (``CollectorNC`` to one file) and qa (ws / wd errors, no
   export: the card's machine has no h5py). Every job must end
   ``successful``; each node's log must show ``small_reflect_conv``
   launched once per dispatch of its chunks; the collected u / v must
   equal an in-process ``ForwardPass.run`` of the same two-node strategy
   on the card (1e-6 of max; its launches as phase 14 counts them), one
   chunk must be within 1e-4 of max of the port's CPU pass, and the QA
   on the card within 1e-5 of each error's max of the QA on the CPU. A
   second ``pipeline --monitor`` must start no node (status and node
   logs untouched, each step ``already successful``). Printed: each
   step's wall s, the rerun's, each node's start-up s (process start to
   its strategy ready) and the CLI pass's HR voxels/s beside phase 14's
   in-process pass. Then ``estimate_flops`` of one flagship ``generate``
   at phase 3's shape on the card and on the CPU, equal, with the
   TFLOP/s it implies at phase 3's median request time.
17. the mesh slice (``sup3r_tpu_torch.parallel``; printed before the
   ``kernels`` line). (a) A world of one over NCCL in this process
   (``init_multihost`` on a FileStore under ``build/``): the training
   cell's step (batch 16, fp32 and bf16, Adam epsilon 1) from one init
   with and without ``attach_mesh(get_mesh())``, losses and params
   within 1e-6 relative, then the step ms each way; the all-reduce of
   both networks' gradients by CUDA events; phase 14's cell by default,
   with ``use_mesh=True`` (equal) and ``use_mesh='spatial'`` (within
   1e-4), the pass seconds and launches of each (the sharded body convs
   run on cuDNN; below the shard-aligned gate, as a world of one is, the
   tail gathers its input and launches ``small_reflect_conv`` once a
   dispatch, the JAX package's route). (b) Two ranks on the
   card over gloo, each a process of its own (this script with
   ``--mesh-rank``; NCCL cannot put two ranks on one device, so gloo
   takes the collectives' tensors through host memory): the DP step on
   8 rows each against (a)'s unmeshed fp32 step (rtol 2e-4, atol 1e-6,
   the JAX package's bar), the same losses on both ranks; phase 14's
   cell with ``use_mesh='spatial'`` (a chunk's 20 padded rows split 10 /
   10) against the default pass (1e-4), the halo bytes the ranks sent
   against ``estimate_halo_bytes`` (within a factor of 5), and each rank
   gathering the tail's input over the two ranks and launching
   ``small_reflect_conv`` on the whole (8, 8, 60 or 36, ., 96) tensor once
   a dispatch (its wrapper's calls recorded by shape); step ms, pass s
   and each rank's launches per step and pass. After the phase the
   kernel is held to its plain version at every gathered shape and timed
   at the most-called one (``mesh_spatial_gathered_shape``).
18. dp x sp training (``attach_mesh(get_mesh_2d(dp, sp))``; printed
   before the ``kernels`` line). First ``reflect_conv_halo``'s gradients
   over blocks of s1 rows of a flagship body block (each block's halo
   rows its neighbours' rows, so autograd hands their gradients back)
   against ``reflect_conv_ad``'s (1e-5 of max). Then four ranks share
   the card over gloo (this script with ``--mesh2d-rank``), on a 2 x 2
   mesh (8 samples and 18 HR rows a rank) and a 1 x 4 mesh (16 samples
   and 9 HR rows a rank; the shard-aligned formulation engaged by the
   width gate). On each,
   three gated steps ('both', 'gen', 'disc') of the training cell from
   phase 7's init (Adam epsilon 1) on the rank's block, each held to the
   unmeshed step on the card from the same start: every rank's losses
   and updated params at rtol 2e-4, atol 1e-6; the halo and row bytes
   each rank sent, forward and backward, equal to
   ``expected_exchange_bytes``; the launches of the JAX package's
   route: at 2 x 2 (below the gate) each rank gathers the HR tail's
   input over ``space`` and launches ``small_reflect_conv`` once a step
   on the whole (8, 8, 36, 36, 48) tensor, as the reference step
   launches it once, while at 1 x 4 the shard-aligned blocks bypass the
   kernel and run on cuDNN; every rank issues its exchanges in one
   order. Printed: the maximum relative errors, a
   rank's step ms and the gradient all-reduce's ms and bytes (through
   host memory: one card allows no speed-up claim).
19. a forward-pass CLI node as a group of ranks (printed before the
   ``kernels`` line): phase 16's cell through ``sup3r_tpu_torch/cli.py
   -c config_pipeline.json pipeline --monitor`` from a run directory
   outside the repo, its forward-pass node two ranks sharing the card
   over gloo (``execution_control``: ``ranks_per_node`` 2), once with
   ``use_mesh=True`` and once with 'spatial': one status entry for the
   node, successful; the launcher's log and each rank's of their own;
   each rank's ``Node summary`` (start-up s, run s, launches:
   ``small_reflect_conv`` once a dispatch of its share, the gathered
   tail under 'spatial'); the group's wall s; the chunk files against
   phase 16's collected one-process output (1e-6 of max under True, 1e-4
   under 'spatial'); after the True run, a rerun that starts nothing.
20. the last names of the port (printed before the ``kernels`` line):
   phase 14's cell with ``device_batch_size='auto'`` under a memory
   budget too small for one padded chunk (``SUP3R_TPU_HBM_GB``) in this
   process, a world of one: the plan (1, 'spatial') as the JAX package's
   fallback; ``small_reflect_conv`` on each dispatch's gathered tail, every
   launch of a first, checked pass held to its plain version on its own
   inputs; then the default pass and the 'auto' pass timed warm, the
   latter held to the former (1e-4, phase 17a's bar), next to the card's
   name and power limit. ``ops.interp.bilinear_resize`` on
   the card against its CPU result (1e-6 of max), and the flagship
   generator through ``save_network_params`` -> ``load_network_params``
   into a model drawn from another seed: parameters bit-equal, the
   generator's output unchanged.

Before the ``kernels`` line, ``phase_seconds`` gives the seconds each
phase took. The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
import warnings
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from sup3r_tpu_torch.bias import (
    PresRat,
    QuantileDeltaMappingCorrection,
    local_qdm_bc,
    qdm_bc,
)
from sup3r_tpu_torch.bias.transforms import get_date_range_kwargs
from sup3r_tpu_torch.configs import generator_cc_spatial, get_config
from sup3r_tpu_torch.models import (
    MultiStepGan,
    SolarCC,
    Sup3rCondMom,
    Sup3rGan,
    Sup3rGanDC,
    Sup3rGanWithObs,
    SurfaceSpatialMetModel,
)
from sup3r_tpu_torch import _native
from sup3r_tpu_torch.models import fuse as fuse_module
from sup3r_tpu_torch.models.fuse import FusedReflectConv
from sup3r_tpu_torch.ops import build
from sup3r_tpu_torch.ops import kernels as kernels_module
from sup3r_tpu_torch.ops.output_pack import (
    fetch_stats,
    pack_chunks,
    pack_plan,
    theta_for,
)
from sup3r_tpu_torch.parallel import (
    get_mesh,
    get_mesh_2d,
    init_multihost,
    shard_batch_spatial,
)
from sup3r_tpu_torch.parallel import mesh as mesh_module
from sup3r_tpu_torch.parallel.mesh import all_reduce_
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.pipeline.memory import estimate_halo_bytes
from sup3r_tpu_torch.postprocessing import OutputHandlerH5, OutputHandlerNC
from sup3r_tpu_torch.postprocessing.writers import write_nc_file
from sup3r_tpu_torch.preprocessing import LoaderNC
from sup3r_tpu_torch.qa import Sup3rQa
from sup3r_tpu_torch.models.gan import relativistic_disc_loss
from sup3r_tpu_torch.models.abstract import AbstractSingleModel
from sup3r_tpu_torch.models.weights import params_from_jax, params_to_jax
from sup3r_tpu_torch.ops.interp import bilinear_resize
from sup3r_tpu_torch.ops.conv_ad import reflect_conv_ad, reflect_conv_halo
from sup3r_tpu_torch.models.utilities import TrainingSession
from sup3r_tpu_torch.preprocessing import (
    BatchHandler,
    BatchHandlerCC,
    BatchHandlerDC,
    BatchHandlerMom1,
    BatchHandlerMom2,
    ConditionalBatch,
    DataHandler,
    DataHandlerH5SolarCC,
    DataHandlerNCforCCwithPowerLaw,
    DualBatchHandler,
    DualRasterizer,
    Sampler,
    SingleBatchQueue,
)
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, get_dset_attrs
from sup3r_tpu_torch.utilities.test_helpers import (
    expected_exchange_bytes,
    make_fake_dset,
    make_fake_nc_file,
    make_fake_topo_nc_file,
    rank_results,
    run_rank_scenarios,
    spawn_ranks,
    write_nc_factor_file,
)
from sup3r_tpu_torch.ops.kernels import (
    _fold_reflect_halos,
    body_kernel_wins,
    pack_weights,
    reflect_conv_cf,
    reflect_conv_n_tile,
    reflect_conv_packed,
    reflect_conv_reference,
    reflect_conv_wgrad,
    reflect_conv_wgrad_reference,
    small_conv_pack_weights,
    small_reflect_conv_cf,
    small_reflect_conv_packed,
    wgrad_kernel_wins,
)
from sup3r_tpu_torch.utilities import Timer, exact_fp32
from sup3r_tpu_torch.utilities.flops import estimate_flops
from sup3r_tpu_torch.utilities.port import (
    export_reference_gan,
    load_reference_gan,
)
from portbench.reference.peaks import bound, peaks

REPLACES = {
    'small_reflect_conv': 'sup3r_tpu/ops/pallas_kernels.py:206',
    'reflect_conv': 'sup3r_tpu/ops/pallas_kernels.py:87',
    'reflect_conv_wgrad': 'none: the JAX package leaves the weight '
                          'gradient to XLA (sup3r_tpu/ops/conv_ad.py:15)',
}
SOURCES = {
    'small_reflect_conv': 'sup3r_tpu_torch/csrc/small_reflect_conv.cu',
    'reflect_conv': 'sup3r_tpu_torch/csrc/reflect_conv.cu',
    'reflect_conv_wgrad': 'sup3r_tpu_torch/csrc/reflect_conv_wgrad.cu',
}
#: each kernel's CUDA function name (held by its device events)
KERNEL_NAMES = {
    'small_reflect_conv': 'small_reflect_conv_kernel',
    'reflect_conv': 'reflect_conv_tc_kernel',
}
#: each kernel's wrapper
KERNEL_FNS = {
    'small_reflect_conv': small_reflect_conv_cf,
    'reflect_conv': reflect_conv_cf,
}
KERNEL_RTOL = 1e-5
PARITY_RTOL = 1e-4
LR_SHAPE = (16, 20, 20, 24, 2)
HR_SHAPE = (16, 60, 60, 96, 2)
N_REQUESTS = 3
#: fused blocks of the flagship that are not its 8 -> 2 tail
N_BODY_BLOCKS = 36
#: the flagship's fused blocks on the opt-in route: (input shape, co,
#: LeakyReLU alpha, launches per request)
BODY_SHAPES = (((16, 2, 20, 20, 24), 64, 0.2, 1),
               ((16, 64, 20, 20, 48), 64, 0.2, 1),
               ((16, 64, 20, 20, 96), 64, 0.2, 33),
               ((16, 64, 20, 20, 96), 72, 0.2, 1))
#: the HR tail's input; the flagship's tail goes to 2 channels, the
#: shipped gen_3x_4x_1f's to 1, gen_4x_24x_3f's to 3
TAIL_SHAPE = (16, 8, 60, 60, 96)
#: the tail's input in phase 13's chunk-by-chunk forward pass: one
#: chunk of phase 6's cell, (16, 16, 20) padded by 2 on each side, at
#: 3x / 4x
COND_FWP_TAIL_SHAPE = (1, 8, 60, 60, 96)
#: ``small_reflect_conv`` checks beyond the three tails without
#: LeakyReLU: (x shape, co, alpha). The kernel tiles (h, w, t) by (6, 10,
#: 32) at co <= 2 (4 and 2 rows at co = 3, 4), 4 t per thread, tensor
#: copies only for T % 4 == 0
SMALL_CHECKS = (
    (TAIL_SHAPE, 2, 0.2), (TAIL_SHAPE, 1, 0.2), (TAIL_SHAPE, 3, 0.2),
    ((2, 8, 12, 10, 33), 2, 0.2),    # T = 33: no tensor copies, ragged t
    ((2, 8, 2, 2, 40), 2, None),     # H = W = 2, the smallest that reflects
    ((1, 8, 20, 30, 64), 3, 0.2),    # B = 1
    ((2, 1, 13, 11, 40), 32, None),  # ci = 1, co = 32: eight groups
    ((2, 32, 13, 11, 40), 1, 0.2),   # ci = 32, co = 1
    ((2, 8, 13, 17, 64), 2, None),   # (H, W) the tile does not divide
    ((2, 4, 7, 5, 9), 5, 0.2),       # ragged everywhere, ci * co = 20
    ((16, 12, 36, 36, 48), 2, None),  # the WithObs training tail, ci 12
    (COND_FWP_TAIL_SHAPE, 2, None),  # a CondMom forward-pass chunk's tail
)
#: the fused blocks whose route ``FusedReflectConv`` chooses by shape,
#: timed on both routes (``body_route_check``): (x shape, co, alpha)
BODY_ROUTE_SHAPES = (
    # the benchmark's node cell: padded chunks (20, 20, 56), batches of 8
    ((8, 2, 20, 20, 56), 64, 0.2),
    ((8, 64, 20, 20, 112), 64, 0.2),
    ((8, 64, 20, 20, 224), 64, 0.2),
    ((8, 64, 20, 20, 224), 64, None),
    ((8, 64, 20, 20, 224), 72, 0.2),
    # phase 3's requests, phase 6 / 14's batches, a chunk-by-chunk pass
    ((16, 2, 20, 20, 24), 64, 0.2),
    ((16, 64, 20, 20, 48), 64, 0.2),
    ((16, 64, 20, 20, 96), 64, 0.2),
    ((16, 64, 20, 20, 96), 72, 0.2),
    ((8, 64, 20, 20, 96), 64, None),
    ((1, 64, 20, 20, 96), 64, 0.2),
    ((1, 2, 20, 20, 24), 64, 0.2),
    # phase 7's validation batches (LR (12, 12, 12))
    ((16, 2, 12, 12, 12), 64, 0.2),
    ((16, 64, 12, 12, 24), 64, 0.2),
    ((16, 64, 12, 12, 48), 72, 0.2),
    # the temporal members of the solar and trh chains: t = 6, the
    # blocks before depth_to_time, the narrow tails
    ((1, 3, 70, 70, 6), 64, 0.2),
    ((1, 2, 70, 70, 6), 64, 0.2),
    ((1, 64, 70, 70, 6), 64, 0.2),
    ((1, 64, 70, 70, 6), 512, 0.2),
    ((1, 64, 70, 70, 6), 768, 0.2),
    ((1, 64, 70, 70, 48), 1, None),
    ((1, 32, 70, 70, 144), 2, None),
    # the spatial members' 2D blocks (phase 10's chunk)
    ((6, 7, 14, 14), 64, 0.2),
    ((6, 1, 14, 14), 64, 0.2),
    ((6, 64, 14, 14), 64, 0.2),
    ((6, 64, 14, 14), 1600, 0.2),
    ((6, 65, 70, 70), 64, 0.2),
    ((6, 64, 70, 70), 64, 0.2),
    ((6, 64, 70, 70), 6, None),
    ((6, 64, 70, 70), 1, None),
    # one chunk of the Sup3rCC wind chain at the example's (5, 5, 3)
    # chunks padded by 1: (7, 7, 5)
    ((5, 7, 7, 7), 64, 0.2),
    ((5, 64, 7, 7), 64, 0.2),
    ((5, 64, 7, 7), 1600, 0.2),
    ((5, 65, 35, 35), 64, 0.2),
    ((5, 64, 35, 35), 64, 0.2),
    ((5, 64, 35, 35), 6, None),
    ((1, 6, 35, 35, 5), 64, 0.2),
    ((1, 64, 35, 35, 5), 64, 0.2),
    ((1, 64, 35, 35, 5), 768, 0.2),
    ((1, 32, 35, 35, 120), 6, None),
    # beyond the shipped generators: the smallest dims that reflect, wide
    # inputs and outputs, large batches, long and short last dims
    ((1, 64, 2, 2, 2), 64, 0.2),
    ((4, 64, 3, 3, 3), 64, None),
    ((8, 64, 4, 4, 4), 64, 0.2),
    ((2, 64, 2, 2), 64, 0.2),
    ((16, 8, 2, 2, 40), 8, None),
    ((8, 128, 20, 20, 56), 64, 0.2),
    ((8, 256, 20, 20, 56), 64, 0.2),
    ((1, 512, 12, 12, 12), 64, 0.2),
    ((1, 1024, 8, 8, 8), 64, None),
    ((4, 64, 20, 20, 56), 2048, 0.2),
    ((1, 64, 10, 10, 10), 4096, None),
    ((32, 64, 20, 20, 56), 64, 0.2),
    ((256, 64, 14, 14), 64, 0.2),
    ((1, 64, 8, 8, 1024), 64, 0.2),
    ((2, 64, 9, 11, 13), 64, None),
    ((1, 64, 100, 100, 2), 64, 0.2),
    ((1, 64, 100, 2, 100), 64, 0.2),
)


#: the benchmark's train cell's fused generator blocks, batch 16 of HR
#: (72, 72, 72): the flagship's head, its two body lengths, the block
#: before the expansion and the HR tail: (x shape, co)
TRAIN_CELL_BLOCKS = (
    ((16, 2, 24, 24, 18), 64),
    ((16, 64, 24, 24, 36), 64),
    ((16, 64, 24, 24, 72), 64),
    ((16, 64, 24, 24, 72), 72),
    ((16, 8, 72, 72, 72), 2),
)
#: the fused 3D blocks whose weight gradient ``reflect_conv_backward``
#: routes by shape, timed on both routes (``wgrad_route_check``): (x
#: shape, co)
WGRAD_ROUTE_SHAPES = TRAIN_CELL_BLOCKS + (
    # phase 7's step (bench.py's cell; the CondMom, WithObs and DC steps
    # train the flagship at these shapes), and its batch-2 card check
    ((16, 2, 12, 12, 12), 64),
    ((16, 64, 12, 12, 24), 64),
    ((16, 64, 12, 12, 48), 64),
    ((16, 64, 12, 12, 48), 72),
    ((16, 8, 36, 36, 48), 2),
    ((16, 12, 36, 36, 48), 2),
    ((2, 64, 12, 12, 48), 64),
    ((2, 8, 36, 36, 48), 2),
    # the SolarCC temporal member's step (phase 11): batch 8 of LR
    # (20, 20, 9), 64 x 8 channels before depth_to_time, its 64 -> 1 tail
    ((8, 3, 20, 20, 9), 64),
    ((8, 64, 20, 20, 9), 64),
    ((8, 64, 20, 20, 9), 512),
    ((8, 64, 20, 20, 72), 1),
    # beyond the shipped generators: the smallest dims that reflect,
    # ragged dims, a t past one tile, wider channels, and few input
    # channels on both sides of the gate's cut (16,384 cells)
    ((1, 64, 2, 2, 2), 64),
    ((2, 64, 9, 11, 13), 64),
    ((3, 5, 7, 9, 11), 6),
    ((4, 32, 10, 10, 130), 16),
    ((2, 128, 16, 16, 16), 128),
    ((3, 8, 20, 20, 9), 2),
    ((3, 4, 16, 16, 16), 32),
    ((4, 3, 16, 16, 16), 6),
    ((4, 8, 16, 16, 16), 2),
)
#: the kernel's largest error over max |dW| may be this many times cuDNN
#: fp32's (both against float64)
WGRAD_ERR_RATIO = 2.0


def wgrad_float64(x, dy):
    """dW of the reflect-pad-1 k3 3D conv in float64, one GEMM a tap."""
    xp = F.pad(x.double(), (1,) * 6, mode='reflect')
    n, ci, s0, s1, s2 = x.shape
    co = dy.shape[1]
    d = dy.double().transpose(0, 1).reshape(co, -1)
    dw = torch.empty((co, ci, 3, 3, 3), dtype=torch.float64,
                     device=x.device)
    for a in range(3):
        for b in range(3):
            for c in range(3):
                xs = xp[:, :, a:a + s0, b:b + s1, c:c + s2]
                dw[:, :, a, b, c] = d @ xs.transpose(0, 1).reshape(
                    ci, -1).T
    return dw


def wgrad_route_check(gen):
    """Each of ``WGRAD_ROUTE_SHAPES`` on both routes of a fused block's
    weight gradient on the card: the kernel (``reflect_conv_wgrad``:
    packing, GEMM and reduction) and the library route (reflect pad, then
    cuDNN's fp32 ``conv3d_weight``, TF32 off), each held to a float64
    ``wgrad_float64`` (largest error over max |dW|), the kernel finite and
    bit-equal on a second call, each timed twice in turns (CUDA events),
    with the gate's choice (``wgrad_kernel_wins``). Returns the
    records."""
    records = []
    for x_shape, co in WGRAD_ROUTE_SHAPES:
        x = torch.randn(x_shape, device='cuda', generator=gen)
        dy = torch.randn((x_shape[0], co) + x_shape[2:], device='cuda',
                         generator=gen)
        with exact_fp32():
            ref = wgrad_float64(x, dy)
            got = reflect_conv_wgrad(x, dy)
            again = reflect_conv_wgrad(x, dy)
            lib = reflect_conv_wgrad_reference(x, dy)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            err = (got.double() - ref).abs().max().item() / scale
            lib_err = (lib.double() - ref).abs().max().item() / scale
            times = [route_ms(f) for f in (
                lambda: reflect_conv_wgrad(x, dy),
                lambda: reflect_conv_wgrad_reference(x, dy),
                lambda: reflect_conv_wgrad_reference(x, dy),
                lambda: reflect_conv_wgrad(x, dy))]
        kernel_ms = (times[0] + times[3]) / 2
        library_ms = (times[1] + times[2]) / 2
        bound_ms, bound_by, _ = bound(torch.cuda.get_device_name(0),
                                      (x_shape[0], co) + x_shape[2:],
                                      x_shape[1], co * x_shape[1] * 27)
        rec = {'shape': list(x_shape), 'co': co, 'kernel_ms': kernel_ms,
               'library_ms': library_ms,
               'kernel_runs_ms': [times[0], times[3]],
               'library_runs_ms': [times[1], times[2]],
               'speedup': library_ms / kernel_ms, 'bound_ms': bound_ms,
               'bound_by': bound_by, 'share_of_bound': bound_ms / kernel_ms,
               'rel_err': err, 'library_rel_err': lib_err,
               'err_ratio': err / lib_err if lib_err else None,
               'deterministic': bool(torch.equal(got, again)),
               'finite': bool(torch.isfinite(got).all()),
               'accurate': err <= WGRAD_ERR_RATIO * lib_err,
               'gate': ('reflect_conv_wgrad' if wgrad_kernel_wins(x, dy)
                        else 'cudnn')}
        emit(phase='wgrad_route', **rec)
        if not (rec['finite'] and rec['deterministic']):
            raise AssertionError(f'reflect_conv_wgrad at {x_shape} -> {co}: '
                                 f'finite {rec["finite"]}, bit-equal on a '
                                 f'second call {rec["deterministic"]}')
        records.append(rec)
    return records


def check_wgrad_gate(records):
    """Every timed shape the gate (``wgrad_kernel_wins``) sends to the
    kernel was faster there and within ``WGRAD_ERR_RATIO`` times cuDNN's
    error; prints the gate's choices."""
    wrong = [r for r in records if r['gate'] != 'cudnn'
             and not (r['speedup'] > 1 and r['accurate'])]
    emit(phase='wgrad_route_gate', shapes=len(records),
         to_kernel=sum(r['gate'] != 'cudnn' for r in records),
         kept_on_cudnn=[[r['shape'], r['co'], r['speedup'], r['err_ratio']]
                        for r in records if r['gate'] == 'cudnn'],
         wrong=[[r['shape'], r['co'], r['speedup'], r['err_ratio']]
                for r in wrong], ok=not wrong)
    if wrong:
        raise AssertionError(f'the wgrad gate sends {len(wrong)} shapes to '
                             f'a kernel slower or less accurate than cuDNN '
                             f'there: {wrong}')


def emit(**record):
    print(json.dumps(record), flush=True)


def on_card(shape, dtype=torch.float32):
    """A stand-in for a tensor of ``shape`` on the card: what the kernel
    rules (``ops/kernels.py``) and ``FusedReflectConv.route`` read of
    it."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                           is_cuda=True)


def takes_small(lyr):
    """Whether a fused block's route is the small kernel's on a float32
    input on the card."""
    x = on_card((1, lyr.weight.shape[1]) + (2,) * lyr.n_spatial)
    with torch.no_grad():
        return lyr.route(x, {}) == 'small'


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, kname, iters, attempts=3):
    """Device time of one launch of kernel ``kname`` alone, without the
    wrapper's host work and weight packing: the mean of its own device
    events under ``torch.profiler`` over ``iters`` calls of ``fn``
    (after one warm-up call). The profiler can lose a session's device
    events; None after ``attempts`` sessions that miss a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and KERNEL_NAMES[kname] in e.key]
        launches = sum(e.count for e in events)
        total = sum(e.self_device_time_total for e in events)
        if launches == iters and total > 0:
            return total / 1e3 / iters
        print(f'{kname}: profiler session {attempt + 1} saw {launches} '
              f'launches of {iters}', file=sys.stderr, flush=True)
    return None


def conv_inputs(gen, x_shape, co, scale=1.0):
    """Seeded input, weight and bias on the card; weights scaled by
    1/sqrt(fan-in) so the outputs stay O(1)."""
    ci, n_spatial = x_shape[1], len(x_shape) - 2
    x = torch.randn(x_shape, device='cuda', generator=gen) * scale
    w = torch.randn((co, ci) + (3,) * n_spatial, device='cuda',
                    generator=gen) / np.sqrt(ci * 3 ** n_spatial)
    b = torch.randn((co,), device='cuda', generator=gen) * 0.1
    return x, w, b


def check_kernel(name, fn, x, w, b, alpha):
    """Kernel vs plain on the same inputs; returns max |diff|."""
    with torch.inference_mode(), exact_fp32():
        got = fn(x, w, b, alpha)
        want = reflect_conv_reference(x, w, b, alpha)
        torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
    emit(phase='kernel_check', kernel=name, shape=list(x.shape),
         co=w.shape[0], alpha=alpha, max_abs_err=err, max_abs_plain=scale,
         tol=KERNEL_RTOL * scale, ok=ok)
    if not ok:
        raise AssertionError(f'{name} disagrees with its plain version at '
                             f'{tuple(x.shape)}: {err} > '
                             f'{KERNEL_RTOL} * {scale}')
    return err


def route_ms(fn):
    """``cuda_ms`` of ``fn`` over about 60 ms of calls (10 to 300)."""
    est = cuda_ms(fn, 3)
    return cuda_ms(fn, int(min(300, max(10, 60 / max(est, 1e-3)))))


def body_route_check(gen):
    """Each of ``BODY_ROUTE_SHAPES`` on both of a fused block's routes on
    the card: ``reflect_conv`` held to its plain version (1e-5 of max),
    then the kernel on weights packed once (the block's cache) against
    the library route (``reflect_conv_ad``: reflect pad, cuDNN's fp32
    conv, LeakyReLU), each timed twice in turns (CUDA events). Returns
    the records."""
    records = []
    for x_shape, co, alpha in BODY_ROUTE_SHAPES:
        x, w, b = conv_inputs(gen, x_shape, co)
        err = check_kernel('reflect_conv', reflect_conv_cf, x, w, b, alpha)
        n_spatial = x.ndim - 2
        n_tile = reflect_conv_n_tile(co)
        with torch.inference_mode(), exact_fp32():
            packed = pack_weights(w, n_tile)

            def kernel():
                reflect_conv_packed(x, packed, b, co, n_tile, alpha)

            def library():
                reflect_conv_ad(x, w, b, n_spatial, alpha)

            times = [route_ms(f) for f in (kernel, library, library, kernel)]
            pack_ms = route_ms(lambda: pack_weights(w, n_tile))
        kernel_ms = (times[0] + times[3]) / 2
        library_ms = (times[1] + times[2]) / 2
        bound_ms, _, _ = bound(torch.cuda.get_device_name(0), x_shape, co,
                               w.numel())
        rec = {'shape': list(x_shape), 'co': co, 'alpha': alpha,
               'kernel_ms': kernel_ms, 'library_ms': library_ms,
               'kernel_runs_ms': [times[0], times[3]],
               'library_runs_ms': [times[1], times[2]],
               'speedup': library_ms / kernel_ms, 'pack_ms': pack_ms,
               'bound_ms': bound_ms, 'share_of_bound': bound_ms / kernel_ms,
               'max_abs_err': err}
        emit(phase='body_route', **rec)
        records.append(rec)
    return records


def check_gate(records):
    """Every timed shape the gate (``body_kernel_wins``) sends to the
    kernel was faster there; prints the gate's choices."""
    wrong = []
    for rec in records:
        rec['gate'] = ('reflect_conv' if body_kernel_wins(
            on_card(rec['shape'])) else 'cudnn')
        if rec['gate'] == 'reflect_conv' and rec['speedup'] <= 1:
            wrong.append(rec)
    emit(phase='body_route_gate', shapes=len(records),
         to_kernel=sum(r['gate'] == 'reflect_conv' for r in records),
         kept_on_cudnn=[[r['shape'], r['co'], r['speedup']]
                        for r in records if r['gate'] == 'cudnn'],
         slower_on_kernel=[[r['shape'], r['co'], r['speedup']]
                           for r in wrong], ok=not wrong)
    if wrong:
        raise AssertionError(f'the gate sends {len(wrong)} shapes to a '
                             f'slower kernel: {wrong}')


@contextlib.contextmanager
def library_route():
    """Every fused block the small kernel does not take on cuDNN, as
    ``inference_pallas = False`` ran them before the gate: the body rule
    (``kernels.body_kernel_wins``) declines every shape."""
    real = kernels_module.body_kernel_wins
    kernels_module.body_kernel_wins = lambda x: False
    try:
        yield
    finally:
        kernels_module.body_kernel_wins = real


def flagship(device):
    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'),
                     meta={'lr_features': ['u_100m', 'v_100m'],
                           'hr_out_features': ['u_100m', 'v_100m']},
                     means={'u_100m': 0.5, 'v_100m': 0.5},
                     stdevs={'u_100m': 0.3, 'v_100m': 0.3}, device=device)
    model.init_weights((1,) + LR_SHAPE[1:], (1,) + HR_SHAPE[1:], seed=0)
    return model


def serve(model, lr, phase, n=N_REQUESTS):
    """``n`` timed generate calls; returns the last output and the
    per-request host times (ms)."""
    times = []
    out = None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(lr)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if out.shape != HR_SHAPE or not np.isfinite(out).all():
        raise AssertionError(f'{phase}: output {out.shape} not finite '
                             f'{HR_SHAPE}')
    return out, times


def profile_request(model, lr):
    """One request under ``torch.profiler``: device-busy and idle share
    of the wall time, the kernels and copies that took the most device
    time (device-side events only: a CPU op's device time is its
    kernels'), and the fp32 operations of the request's fused convs
    (2 * taps * ci per output value, counted by forward hooks)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flops = []

    def count(module, args, out):
        w = module.weight
        flops.append(2 * out.numel() * w[0].numel())

    hooks = [m.register_forward_hook(count)
             for m in model._get_fused_apply().layers
             if isinstance(m, FusedReflectConv)]
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.generate(lr)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for h in hooks:
            h.remove()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    d2h_ms = sum(e.self_device_time_total for e in events
                 if 'DtoH' in e.key) / 1e3
    top = [{'name': e.key[:90], 'calls': e.count,
            'device_ms': e.self_device_time_total / 1e3}
           for e in events[:8]]
    return wall_ms, busy_ms, top, sum(flops), d2h_ms


#: the forward-pass phase: low-res domain (s1, s2, t), chunk shape, pads,
#: device batch and timed passes per route
FWP_DOMAIN = (64, 64, 40)
FWP_CHUNK = (16, 16, 20)
FWP_PAD = 2
FWP_BATCH = 16
N_FWP_PASSES = 3
FWP_FEATURES = ['u_100m', 'v_100m']


class RecordedForwardPass(ForwardPass):
    """``ForwardPass`` that keeps its last instance, so a run through the
    ``ForwardPass.run`` entry point can report its timer and stats."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        type(self).last = self


def fwp_strategy(input_file, model_dir, out_pattern, device='cuda',
                 **kwargs):
    kw = dict(file_paths=input_file,
              model_kwargs={'model_dir': model_dir, 'device': device},
              fwp_chunk_shape=FWP_CHUNK, spatial_pad=FWP_PAD,
              temporal_pad=FWP_PAD, device_batch_size=FWP_BATCH,
              out_pattern=out_pattern)
    kw.update(kwargs)
    return ForwardPassStrategy(**kw)


def check_fwp_files(strategy, out_dir, keep=False, domain=FWP_DOMAIN,
                    features=FWP_FEATURES):
    """Read every chunk file back through ``LoaderNC`` and tile the
    high-res domain; it must be finite and complete, with every feature.
    Returns the tiled domain's shape, and with ``keep`` the tiled array
    too."""
    slicer, s_en, t_en = (strategy.fwp_slicer, strategy.s_enhance,
                          strategy.t_enhance)
    shape = (domain[0] * s_en, domain[1] * s_en, domain[2] * t_en,
             len(features))
    full = np.full(shape, np.nan, np.float32)
    for idx, path in enumerate(strategy.out_files):
        if not os.path.exists(path):
            raise AssertionError(f'forward pass: {path} was not written')
        data = LoaderNC(path).data
        s_idx, t_idx = slicer.get_chunk_indices(idx)
        s_hr = slicer.s_hr_slices[s_idx]
        t_lr = slicer.t_lr_slices[t_idx]
        full[s_hr[0], s_hr[1], t_lr.start * t_en:t_lr.stop * t_en] = \
            np.stack([data[f] for f in features], axis=-1)
    if not np.isfinite(full).all():
        raise AssertionError('forward pass: the stitched output is not '
                             f'finite and complete at {shape}')
    shutil.rmtree(out_dir)
    return (list(shape[:-1]), full) if keep else list(shape[:-1])


def check_fwp_launches(route, launches, n_dispatch):
    """``small_reflect_conv`` once per dispatch on both routes,
    ``reflect_conv`` 36 times per dispatch on the opt-in route and once
    for each block the gate sent to it on the default route
    (``GATED``)."""
    want = {'small_reflect_conv': n_dispatch,
            'reflect_conv': (N_BODY_BLOCKS * n_dispatch
                             if route == 'opt_in' else gated()),
            'reflect_conv_wgrad': 0}
    if launches != want:
        raise AssertionError(f'forward pass ({route}): launches '
                             f'{launches}, expected {want}')


def fwp_pass(input_file, model_dir, out_dir, route, index):
    """One timed ``ForwardPass.run`` to NetCDF chunk files; the wall
    time includes planning (input read, strategy) and every drain."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strategy = fwp_strategy(input_file, model_dir,
                            os.path.join(out_dir, 'chunk_{file_id}.nc'))
    plan_s = time.perf_counter() - t0
    RecordedForwardPass.run(strategy, 0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    fwp = RecordedForwardPass.last
    n_dispatch = -(-strategy.fwp_slicer.n_chunks // FWP_BATCH)
    check_fwp_launches(route, launches, n_dispatch)
    hr_shape = check_fwp_files(strategy, out_dir)
    hr_voxels = int(np.prod(hr_shape))
    emit(phase='forward_pass', route=route, pass_index=index,
         chunks=strategy.fwp_slicer.n_chunks, dispatches=n_dispatch,
         hr_shape=hr_shape, wall_s=wall_s, plan_s=plan_s,
         hr_voxels_per_s=hr_voxels / wall_s, timer_s=fwp.timer.log,
         stats=fwp.stats, launches=launches)
    return wall_s, launches


def fwp_profiled_pass(make_strategy, out_dir, route,
                      phase='forward_pass_profile'):
    """One more pass (planning included) under ``torch.profiler``: the
    device-busy time (the sum of the device events of kernels and copies,
    on all streams) against the wall time, so the device's idle share,
    and the kernels and copies that take the most device time.
    ``make_strategy(out_pattern)`` builds the pass's strategy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ForwardPass.run(make_strategy(
            os.path.join(out_dir, 'chunk_{file_id}.nc')), 0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    shutil.rmtree(out_dir)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    emit(phase=phase, route=route, wall_ms=wall_ms,
         device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
         d2h_ms=sum(e.self_device_time_total for e in events
                    if 'DtoH' in e.key) / 1e3,
         top_device=[{'name': e.key[:90], 'calls': e.count,
                      'device_ms': e.self_device_time_total / 1e3}
                     for e in events[:8]])


def fwp_drain_breakdown(input_file, model_dir, tmp, repeats=10):
    """Host cost of the drain's stages for one chunk of this run's
    output shape (ms per chunk, host clock): the output check, the
    NetCDF writer's transform (limits; u/v kept) and its file write."""
    strategy = fwp_strategy(input_file, model_dir, None)
    chunk = strategy.init_chunk(0)
    s1, s2 = chunk.hr_lat_lon.shape[:2]
    data = (np.random.default_rng(3).standard_normal(
        (s1, s2, len(chunk.hr_times), len(FWP_FEATURES))) * 0.3
        + 0.5).astype(np.float32)
    out_file = os.path.join(tmp, 'breakdown.nc')
    stages = {
        'output_check': lambda: ForwardPass._output_check(data),
        'transform': lambda: OutputHandlerNC._transform_output(
            data.copy(), list(FWP_FEATURES), chunk.hr_lat_lon,
            invert_uv=False),
        'nc_write': lambda: write_nc_file(
            out_file, chunk.hr_times, chunk.hr_lat_lon[..., 0],
            chunk.hr_lat_lon[..., 1],
            {f: np.transpose(data[..., i], (2, 0, 1))
             for i, f in enumerate(FWP_FEATURES)}, meta_attr='{}'),
    }
    ms = {}
    for stage, fn in stages.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        ms[stage] = 1e3 * (time.perf_counter() - t0) / repeats
    emit(phase='forward_pass_drain_breakdown',
         chunk_hr_shape=list(data.shape), ms_per_chunk=ms,
         mb_per_file=os.path.getsize(out_file) / 2 ** 20)


def fwp_reference_checks(model_dir, tmp):
    """On a small domain: the card's per-chunk outputs against the
    port's CPU forward pass, and batched against serial on the card."""
    small = make_fake_nc_file(
        os.path.join(tmp, 'small.nc'), (8, 8, 12), FWP_FEATURES,
        data={f: np.random.default_rng(i + 5).standard_normal(
            (12, 8, 8)) * 0.3 + 0.5 for i, f in enumerate(FWP_FEATURES)})
    kw = dict(fwp_chunk_shape=(4, 4, 6), spatial_pad=1, temporal_pad=1)
    card = ForwardPass.run(fwp_strategy(small, model_dir, None,
                                        device_batch_size=4, **kw), 0)
    serial = ForwardPass.run(fwp_strategy(small, model_dir, None,
                                          device_batch_size=1, **kw), 0)
    cpu = ForwardPass.run(fwp_strategy(small, model_dir, None,
                                       device='cpu', device_batch_size=4,
                                       **kw), 0)
    for against, ref in (('cpu', cpu), ('serial', serial)):
        scale = max(float(np.abs(v).max()) for v in ref.values())
        err = max(float(np.abs(card[i] - ref[i]).max()) for i in ref)
        tol = PARITY_RTOL * scale
        ok = sorted(card) == sorted(ref) and err <= tol
        emit(phase='forward_pass_check', against=against,
             chunks=len(ref), chunk_hr_shape=list(ref[0].shape),
             max_abs_err=err, tol=tol, ok=ok)
        if not ok:
            raise AssertionError(f'forward pass: card vs {against} '
                                 f'{err} > {tol}')


def fwp_pack_check(input_file, model_dir):
    """One dispatched batch's cropped outputs packed on the card
    (``pack_chunks``, the H5 drain's device stage) against the host
    transform plus ``round(x * scale)``; the stats against
    ``_output_check``."""
    strategy = fwp_strategy(input_file, model_dir, None)
    fwp = ForwardPass(strategy, 0)
    batch = [fwp.get_input_chunk(i) for i in range(FWP_BATCH)]
    out, _, _ = fwp._dispatch_chunk_batch(batch)
    names, pairs, quant = pack_plan(FWP_FEATURES, True)
    crops = [out[i][c.hr_crop_slice] for i, c in enumerate(batch)]
    invert_lat = bool(batch[0].hr_lat_lon[-1, 0, 0]
                      > batch[0].hr_lat_lon[0, 0, 0])
    thetas = torch.as_tensor(np.stack(
        [theta_for(c.hr_lat_lon, invert_lat) for c in batch]),
        device=out.device)
    packed, stats = pack_chunks(torch.stack(crops), thetas, pairs, quant,
                                invert_lat)
    stats = fetch_stats(stats)
    packed = [p.cpu().numpy() for p in packed]
    worst = 0
    for j, (chunk, crop) in enumerate(zip(batch, crops)):
        host = crop.cpu().numpy().copy()
        ForwardPass._output_check(host)
        flat = host.reshape(-1, host.shape[-1])
        if (stats['nan_any'][j] != np.isnan(host).any()
                or list(stats['ch_const'][j]) != [
                    bool(flat[:, i].std() == 0)
                    for i in range(flat.shape[1])]
                or not np.array_equal(stats['ch_first'][j], flat[0])):
            raise AssertionError(f'pack stats of chunk {j} disagree with '
                                 '_output_check')
        data, feats = OutputHandlerH5._transform_output(
            host, list(FWP_FEATURES), chunk.hr_lat_lon, invert_uv=True)
        s1, s2, t = data.shape[:3]
        for i, name in enumerate(feats):
            attrs, dtype = get_dset_attrs(name)
            want = np.round(data[..., i].reshape(s1 * s2, t).T
                            * attrs['scale_factor']).astype(dtype)
            diff = packed[i][j].astype(np.int64) - want.astype(np.int64)
            worst = max(worst, int(np.abs(diff).max()))
    emit(phase='forward_pass_pack_check', chunks=len(batch),
         features=list(names), max_quantum_diff=worst, tol=1,
         ok=worst <= 1)
    if worst > 1:
        raise AssertionError(f'device pack differs from the host '
                             f'transform by {worst} storage quanta')


def forward_pass_phase(name):
    """Phase 6: the chunked forward pass on both routes; returns the
    kernels' launches per pass on each route."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_fwp_')
    try:
        rng = np.random.default_rng(0)
        s1, s2, t = FWP_DOMAIN
        input_file = make_fake_nc_file(
            os.path.join(tmp, 'input.nc'), FWP_DOMAIN, FWP_FEATURES,
            data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
                  for f in FWP_FEATURES})
        model = flagship('cuda')
        model.meta.update(
            input_resolution={'spatial': '12km', 'temporal': '60min'})
        model_dir = os.path.join(tmp, 'model')
        model.save(model_dir)
        del model
        auto = fwp_strategy(input_file, model_dir, None,
                            device_batch_size='auto')
        ForwardPass(auto, 0)
        emit(phase='forward_pass_auto_batch',
             padded_chunk=[c + 2 * FWP_PAD for c in FWP_CHUNK],
             device_batch_size=auto.device_batch_size,
             free_gb=torch.cuda.mem_get_info()[0] / 1e9)
        served = auto.get_model()
        served.inference_pallas = False
        with Timer() as warm:
            ForwardPass.run(fwp_strategy(
                input_file, model_dir,
                os.path.join(tmp, 'warm', 'chunk_{file_id}.nc')), 0)
        emit(phase='forward_pass_warm_up', wall_s=warm.elapsed)
        per_pass = {}
        for route, pallas in (('default', False), ('opt_in', True)):
            served.inference_pallas = pallas
            walls = []
            for i in range(N_FWP_PASSES):
                wall, launches = fwp_pass(
                    input_file, model_dir,
                    os.path.join(tmp, f'{route}_{i}'), route, i)
                walls.append(wall)
            per_pass[route] = launches
            emit(phase='forward_pass_route', route=route, wall_s=walls,
                 hr_voxels_per_s=int(np.prod(FWP_DOMAIN)) * 9 * 4 / float(
                     np.median(walls)), nvidia_smi=name)
            fwp_profiled_pass(
                lambda out: fwp_strategy(input_file, model_dir, out),
                os.path.join(tmp, f'{route}_profiled'), route)
        served.inference_pallas = False
        fwp_drain_breakdown(input_file, model_dir, tmp)
        fwp_reference_checks(model_dir, tmp)
        fwp_pack_check(input_file, model_dir)
        return per_pass
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the training cell (bench.py's): batch, LR and HR shapes, Adam lr, the
#: adversarial weight; warm-up and timed steps
TRAIN_BATCH = 16
TRAIN_LR = (12, 12, 12, 2)
TRAIN_HR = (36, 36, 48, 2)
TRAIN_LR_RATE = 1e-4
W_ADV = 1e-3
N_WARM_STEPS = 3
N_TRAIN_STEPS = 12
#: the HR tail's input in a train step
TRAIN_TAIL_SHAPE = (TRAIN_BATCH, 8) + TRAIN_HR[:3]
#: the card-vs-CPU step: batch 2; Adam with epsilon 1 so that an update
#: is smooth in its gradient (with 1e-8 it is sign(g), which turns a
#: gradient entry within rounding of zero into a full +-lr either way)
CHECK_BATCH = 2
CHECK_OPT = {'name': 'Adam', 'learning_rate': TRAIN_LR_RATE, 'epsilon': 1.0}
GATES = {'both': (True, True), 'gen': (True, False), 'disc': (False, True)}


def train_model(device, optimizer=None):
    """The full-width flagship with the test discriminator, initialized
    for the training cell from seed 0."""
    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'),
                     optimizer=optimizer, learning_rate=TRAIN_LR_RATE,
                     device=device)
    model.init_weights((1,) + TRAIN_LR, (1,) + TRAIN_HR, seed=0)
    return model


def leaky(x, alpha):
    """jax.nn.leaky_relu, whose gradient at 0 is 1."""
    return x if alpha is None else torch.where(x >= 0, x, alpha * x)


def grad_check(name, fn, x, w, b, alpha, dy):
    """(dx, dw, db) of ``fn`` against autograd of the plain composition
    (F.pad + cuDNN, TF32 off) on the same inputs."""
    n = x.ndim - 2
    conv = F.conv3d if n == 3 else F.conv2d
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    plain = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    with exact_fp32():
        got = torch.autograd.grad(fn(*leaves, alpha), leaves, dy)
        ref = leaky(conv(F.pad(plain[0], (1,) * 2 * n, mode='reflect'),
                         plain[1], plain[2]), alpha)
        want = torch.autograd.grad(ref, plain, dy)
    errs = {}
    ok = True
    for key, g, r in zip(('dx', 'dw', 'db'), got, want):
        err = (g - r).abs().max().item()
        tol = KERNEL_RTOL * r.abs().max().item()
        errs[key] = err
        ok = ok and bool(torch.isfinite(g).all()) and err <= tol
    emit(phase='kernel_grad_check', kernel=name, shape=list(x.shape),
         co=w.shape[0], alpha=alpha, max_abs_err=errs, ok=ok)
    if not ok:
        raise AssertionError(f'{name} gradients disagree with autograd of '
                             f'the plain composition: {errs}')
    return max(errs.values())


def kernel_grad_checks(gen):
    """Phase 7a: both Functions' gradients on the card."""
    worst = {}
    for co in (2, 1, 3):
        for alpha in (None, 0.2):
            x, w, b = conv_inputs(gen, TRAIN_TAIL_SHAPE, co)
            dy = torch.randn(x.shape[:1] + (co,) + x.shape[2:],
                             device='cuda', generator=gen)
            err = grad_check('small_reflect_conv', small_reflect_conv_cf,
                             x, w, b, alpha, dy)
            worst['small_reflect_conv'] = max(
                worst.get('small_reflect_conv', 0), err)
    for x_shape, co, alpha in (((TRAIN_BATCH, 64, 12, 12, 48), 64, 0.2),
                               ((TRAIN_BATCH, 2, 12, 12, 12), 64, 0.2),
                               ((TRAIN_BATCH, 64, 12, 12, 48), 72, None)):
        x, w, b = conv_inputs(gen, x_shape, co)
        dy = torch.randn(x.shape[:1] + (co,) + x.shape[2:], device='cuda',
                         generator=gen)
        err = grad_check('reflect_conv_ad',
                         lambda xx, ww, bb, a: reflect_conv_ad(
                             xx, ww, bb, 3, a), x, w, b, alpha, dy)
        worst['reflect_conv_ad'] = max(worst.get('reflect_conv_ad', 0), err)
    return worst


def train_batch(n, seed=1):
    """bench.py's training batch: U(0, 1) LR and HR of batch ``n``."""
    rng = np.random.default_rng(seed)
    lr = rng.random((n,) + TRAIN_LR).astype(np.float32)
    hr = rng.random((n,) + TRAIN_HR).astype(np.float32)
    return lr, hr


def step_grads(model, lr, hr):
    """Both losses' gradients (the generator's, the discriminator's) at
    one batch, computed as ``Sup3rGan._train_step`` computes them, in the
    model's dtype (under ``torch.utils.checkpoint`` with
    ``train_remat``)."""
    gen_apply = model._maybe_remat(model._train_gen_net().apply)
    dtype = model.gen_params[0].dtype
    lr = torch.as_tensor(lr, dtype=dtype, device=model.device)
    hr = torch.as_tensor(hr, dtype=dtype, device=model.device)
    with exact_fp32():
        out = gen_apply(lr, {})
        d_true, d_gen = model._disc.apply(hr), model._disc.apply(out)
        gen_loss = (model.loss_fun(out, hr)
                    + W_ADV * relativistic_disc_loss(d_gen, d_true))
        disc_loss = relativistic_disc_loss(d_true, d_gen)
        return (torch.autograd.grad(gen_loss, model.gen_params,
                                    retain_graph=True),
                torch.autograd.grad(disc_loss, model.disc_params))


def rel_err(got, want, skip_last=False):
    """Largest per-tensor max|got - want| / max|want| over two tensor
    lists (on the CPU, in float64)."""
    pairs = list(zip(got, want))[:-1 if skip_last else None]
    out = 0.0
    for a, b in pairs:
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        scale = b.abs().max().item()
        out = max(out, (a - b).abs().max().item() / (scale or 1.0))
    return out


def step_check(phase, make_model, lr, hr, exact_grads, **record):
    """One step of ``make_model(device)`` on the card against the port's
    CPU step from the same weights, batch, state and step counter, for
    the three gating cases. Losses within 1e-4; weights and Adam moments
    within 1e-4 of each tensor's largest magnitude, or within the step's
    fp32 conditioning where that is wider: at initialization the
    discriminator's outputs are ~1e-3 of its activations, so its
    gradients carry fp32 rounding of ~1e-3 of their size on any device.
    That conditioning is measured against a float64 step on the card
    (``exact_grads(model, lr, hr)``: both losses' gradients of the first
    step): the card's gradients (from its Adam moments, mu = 0.1 g after
    one step) must be as close to float64 as the CPU's are (within 2x, or
    1e-4)."""
    card, cpu = make_model('cuda'), make_model('cpu')
    start = [params_to_jax(card._gen), params_to_jax(card._disc)]
    ref = make_model('cuda')
    ref._gen.double()
    ref._disc.double()
    exact = exact_grads(ref, lr, hr)
    del ref
    tols, worst = {}, 0.0
    for gate, (do_gen, do_disc) in GATES.items():
        for model in (card, cpu):
            params_from_jax(model._gen, start[0])
            params_from_jax(model._disc, start[1])
            model._gen_opt_state = model._gen_tx.init(model.gen_params)
            model._disc_opt_state = model._disc_tx.init(model.disc_params)
            model._step_counter = 0
        got = card.run_gradient_descent(lr, hr, W_ADV, do_gen, do_disc)
        want = cpu.run_gradient_descent(lr, hr, W_ADV, do_gen, do_disc)
        errs = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
        ok = all(v <= PARITY_RTOL for v in errs.values())
        conditioning = {}
        for i, tag in enumerate(('_gen', '_disc')):
            states = [getattr(m, tag + '_opt_state') for m in (card, cpu)]
            if gate == 'both':
                # fp32 against float64: the CPU's, then the card's
                e_cpu, e_card = (
                    rel_err([m / 0.1 for m in st['mu']], exact[i],
                            skip_last=tag == '_disc') for st in states)
                tols[tag] = max(PARITY_RTOL, 2 * (e_cpu + e_card))
                conditioning[tag] = {'cpu_vs_float64': e_cpu,
                                     'card_vs_float64': e_card}
                ok = ok and e_card <= max(PARITY_RTOL, 2 * e_cpu)
            nets = [getattr(m, tag) for m in (card, cpu)]
            skip = tag == '_disc'
            errs[f'param{tag}'] = rel_err(*[list(n.parameters())
                                            for n in nets], skip)
            for key in ('mu', 'nu'):
                errs[f'{key}{tag}'] = rel_err(*[st[key] for st in states],
                                              skip)
            # nu is quadratic in the gradient: twice its relative error
            ok = (ok and errs[f'param{tag}'] <= tols[tag]
                  and errs[f'mu{tag}'] <= tols[tag]
                  and errs[f'nu{tag}'] <= 2 * tols[tag])
        worst = max(worst, max(errs.values()))
        emit(phase=phase, gate=gate, **record, losses_card=got, rel_err=errs,
             loss_tol=PARITY_RTOL,
             tol={k.strip('_'): v for k, v in tols.items()},
             fp32_conditioning=conditioning or None, ok=ok)
        if not ok:
            raise AssertionError(f'{phase} ({gate}): card vs CPU {errs}')
    return worst


def train_check():
    """Phase 7b: ``step_check`` of one flagship step at batch 2."""
    lr, hr = train_batch(CHECK_BATCH, seed=2)
    return step_check('train_check', lambda d: train_model(d, CHECK_OPT),
                      lr, hr, step_grads, batch=CHECK_BATCH)


def train_step_phase(name, model, phase='train_step',
                     want=(('small_reflect_conv', 1), ('reflect_conv', 0)),
                     label='spatiotemporal/gen_3x_4x_2f'):
    """Phase 7c: bench.py's cell, timed (in the model's ``train_dtype``
    and ``train_remat``); ``want`` the launches per step. Returns the
    batch, the median step ms, the launches per step and the peak
    device memory: absolute, and above what was allocated before the
    steps (the script's earlier phases hold some memory too)."""
    lr_np, hr_np = train_batch(TRAIN_BATCH)
    lr = torch.as_tensor(lr_np, device='cuda')
    hr = torch.as_tensor(hr_np, device='cuda')
    for _ in range(N_WARM_STEPS):
        model.run_gradient_descent(lr, hr, W_ADV, True, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    times, losses = [], None
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses = model.run_gradient_descent(lr, hr, W_ADV, True, True)
        times.append(1e3 * (time.perf_counter() - t0))
    # the fused blocks' weight gradients the gate sent to the kernel
    want = dict(want, reflect_conv_wgrad=wgrad_gated(
        model.train_remat) / N_TRAIN_STEPS)
    per_step = {k: v / N_TRAIN_STEPS for k, v in launch_counts().items()}
    ok = per_step == want and all(
        np.isfinite(v) for v in losses.values())
    median = float(np.median(times))
    peak = torch.cuda.max_memory_allocated()
    memory = {'peak_gb': peak / 1e9, 'step_peak_gb': (peak - before) / 1e9}
    emit(phase=phase, model=label,
         train_dtype=model.train_dtype, train_remat=model.train_remat,
         disc='spatiotemporal/disc_test', batch=TRAIN_BATCH,
         lr_shape=list(TRAIN_LR), hr_shape=list(TRAIN_HR),
         steps=N_TRAIN_STEPS, step_ms=times, median_step_ms=median,
         spread_ms=[float(np.min(times)), float(np.max(times))],
         hr_voxels_per_s=TRAIN_BATCH * int(np.prod(TRAIN_HR[:3]))
         / (median / 1e3), launches_per_step=per_step, losses=losses,
         peak_device_gb=memory['peak_gb'],
         allocated_before_gb=before / 1e9,
         step_peak_gb=memory['step_peak_gb'], nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'{phase}: launches per step {per_step}, '
                             f'expected {want}; losses {losses}')
    return lr, hr, median, per_step, memory


def train_phase_times(model, lr, hr):
    """Device time of each phase of one step, from CUDA events between
    the phases of a step built from the model's own calls (those of
    ``Sup3rGan._train_step``, both networks trained). The generator's
    backward runs through the discriminator to its input."""
    net = model._train_gen_net()
    cast = model._train_cast()
    gen_p, disc_p = model.gen_params, model.disc_params
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    with exact_fp32():
        events[0].record()
        out = net.apply(cast(lr), {}).float()
        events[1].record()
        d_true = model._disc.apply(cast(hr)).float()
        d_gen = model._disc.apply(cast(out)).float()
        gen_loss = (model.loss_fun(out, hr)
                    + W_ADV * relativistic_disc_loss(d_gen, d_true))
        disc_loss = relativistic_disc_loss(d_true, d_gen)
        events[2].record()
        gen_grads = torch.autograd.grad(gen_loss, gen_p, retain_graph=True)
        events[3].record()
        disc_grads = torch.autograd.grad(disc_loss, disc_p)
        events[4].record()
        model._gen_tx.update(gen_p, gen_grads, model._gen_opt_state)
        model._disc_tx.update(disc_p, disc_grads, model._disc_opt_state)
        events[5].record()
    torch.cuda.synchronize()
    names = ('gen_forward', 'disc_forward_and_losses',
             'gen_backward_through_disc', 'disc_backward',
             'optimizer_updates')
    return {k: a.elapsed_time(b)
            for k, a, b in zip(names, events[:-1], events[1:])}


def pads_and_folds_ms(model, lr):
    """Device ms per step of the fused blocks' reflect pads (one in the
    forward, and one in the wgrad of the backward where cuDNN takes it:
    ``reflect_conv_wgrad`` reads the input unpadded) and halo folds (one
    per block that needs its input's gradient), each timed alone (CUDA
    events) at the input shapes a step gives the blocks."""
    shapes = []

    def hook(module, args):
        shapes.append((tuple(args[0].shape), module.weight.shape[0]))

    net = model._train_gen_net()
    hooks = [m.register_forward_pre_hook(hook) for m in net.layers
             if isinstance(m, FusedReflectConv)]
    try:
        with torch.no_grad(), exact_fp32():
            net.apply(lr, {})
    finally:
        for h in hooks:
            h.remove()
    pads = folds = 0.0
    for i, (shape, co) in enumerate(shapes):
        x = torch.empty(shape, device='cuda')
        padded = torch.empty(shape[:2] + tuple(d + 2 for d in shape[2:]),
                             device='cuda')
        dy = torch.empty((shape[0], co) + shape[2:], device='cuda')
        n_pads = 1 if wgrad_kernel_wins(x, dy) else 2
        pads += n_pads * cuda_ms(
            lambda: F.pad(x, (1,) * 6, mode='reflect'), 5)
        if i:  # the first block's input (the LR batch) needs no gradient
            folds += cuda_ms(lambda: _fold_reflect_halos(padded, 3), 5)
    return pads, folds, len(shapes)


def tail_backward_ms():
    """The small kernel's backward convs at the training tail (co 2,
    alpha None), each timed alone (CUDA events, TF32 off): the
    full-padding dgrad with the flipped kernel, cuDNN's wgrad on the
    padded input and the ``reflect_conv_wgrad`` kernel that takes its
    place."""
    gen = torch.Generator(device='cuda').manual_seed(5)
    x, w, _ = conv_inputs(gen, TRAIN_TAIL_SHAPE, 2)
    dy = torch.randn((TRAIN_BATCH, 2) + TRAIN_TAIL_SHAPE[2:],
                     device='cuda', generator=gen)
    xp = F.pad(x, (1,) * 6, mode='reflect')
    kf = w.flip([2, 3, 4]).transpose(0, 1)
    with exact_fp32():
        dgrad = cuda_ms(lambda: F.conv3d(dy, kf, padding=2), 20)
        wgrad = cuda_ms(lambda: torch.nn.grad.conv3d_weight(
            xp, w.shape, dy), 20)
        kernel = cuda_ms(lambda: reflect_conv_wgrad(x, dy), 20)
    return {'dgrad_ms': dgrad, 'wgrad_ms': wgrad, 'wgrad_kernel_ms': kernel}


def train_profile(model, lr, hr, step=None):
    """One step (``step()``, else a GAN step on (lr, hr)) under
    ``torch.profiler``: device-busy ms against the wall time (idle
    share), the small kernel's device time and the kernels that take the
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if step is None:
            model.run_gradient_descent(lr, hr, W_ADV, True, True)
        else:
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    small = sum(e.self_device_time_total for e in events
                if KERNEL_NAMES['small_reflect_conv'] in e.key) / 1e3
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'idle_share': 1 - busy_ms / wall_ms,
            'small_reflect_conv_ms': small,
            'top_device': [{'name': e.key[:90], 'calls': e.count,
                            'device_ms': e.self_device_time_total / 1e3}
                           for e in events[:10]]}


def train_loop(step_ms):
    """Phase 7e: ``Sup3rGan.train`` over a ``BatchHandler`` of fake
    hourly u/v data: 2 epochs of 4 batches of 16, validation, the last
    checkpoint reloaded and served."""
    features = ['u_100m', 'v_100m']
    tmp = tempfile.mkdtemp(prefix='chip_smoke_train_')
    try:
        handler = BatchHandler(
            [make_fake_dset((72, 72, 240), features)],
            [make_fake_dset((72, 72, 96), features)],
            batch_size=TRAIN_BATCH, n_batches=4, s_enhance=3, t_enhance=4,
            sample_shape=TRAIN_HR[:3])
        model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                         get_config('spatiotemporal/disc_test'),
                         learning_rate=TRAIN_LR_RATE)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train(handler, input_resolution={'spatial': '3km',
                                               'temporal': '60min'},
                    n_epoch=2, weight_gen_advers=W_ADV,
                    out_dir=os.path.join(tmp, 'gan_{epoch}'))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        # the tail launches once per forward: 8 train batches and 8
        # validation batches (4 of each per epoch); the validation
        # batches' body blocks (no gradients) are the gate's, the train
        # batches' weight gradients the wgrad gate's
        launches = launch_counts()
        want_body, want_wgrad = gated(), wgrad_gated()
        t0 = time.perf_counter()
        model.calc_val_loss(handler, W_ADV)
        val_s = time.perf_counter() - t0
        handler.stop()
        history = model.history
        ok = (len(history) == 2 and all(
            c in history and np.isfinite(history[c]).all()
            for c in ('train_loss_gen', 'train_loss_disc', 'val_loss_gen',
                      'val_loss_disc')))
        loaded = Sup3rGan.load(os.path.join(tmp, 'gan_1'))
        lr = np.random.default_rng(3).standard_normal(
            (1,) + TRAIN_LR).astype(np.float32) * 0.3 + 0.5
        out = loaded.generate(lr)
        ok = (ok and out.shape == (1, 36, 36, 48, 2)
              and bool(np.isfinite(out).all())
              and len(loaded.history) == 2
              and loaded._gen_opt_state['count']
              == model._gen_opt_state['count'])
        ok = ok and launches == {'small_reflect_conv': 16,
                                 'reflect_conv': want_body,
                                 'reflect_conv_wgrad': want_wgrad}
        # the epochs' seconds from the history (init and the checkpoint
        # save fall outside them); a batch's share without validation
        epoch_s = np.diff([0.0] + list(history['elapsed_time']))
        emit(phase='train_loop', epochs=2, batches_per_epoch=4,
             batch=TRAIN_BATCH, wall_s=wall_s, epoch_s=list(epoch_s),
             validation_s_per_epoch=val_s,
             s_per_batch=float(np.mean(epoch_s - val_s)) / 4,
             bare_step_s=step_ms / 1e3,
             update_fractions={k: list(history[f'train_{k}_train_frac'])
                               for k in ('gen', 'disc')},
             starvation_rate=handler._queue.starvation_rate,
             history={c: list(history[c]) for c in history.columns},
             launches=launches, gated=want_body, wgrad_gated=want_wgrad,
             reloaded_generate_shape=list(out.shape), ok=ok)
        if not ok:
            raise AssertionError('train loop: history, launches, reload or '
                                 'generate failed')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def training_phase(name, gen):
    """Phase 7: training on the card; returns what the kernels line
    reports of it."""
    grad_errs = kernel_grad_checks(gen)
    check_err = train_check()
    model = train_model('cuda')
    lr, hr, step_ms, per_step, memory = train_step_phase(name, model)
    phases = train_phase_times(model, lr, hr)
    pads, folds, blocks = pads_and_folds_ms(model, lr)
    backward = tail_backward_ms()
    profile_rec = train_profile(model, lr, hr)
    emit(phase='train_profile', phase_device_ms=phases,
         pads_ms_per_step=pads, folds_ms_per_step=folds,
         fused_blocks=blocks, small_reflect_conv_backward=backward,
         **profile_rec)
    del model
    train_loop(step_ms)
    return {'fp32': {'step_ms': step_ms, **memory},
            'launches_per_train_step': per_step['small_reflect_conv'],
            'wgrad_launches_per_train_step': per_step['reflect_conv_wgrad'],
            'train_backward_library_ms': backward,
            'grad_max_abs_err': grad_errs['small_reflect_conv'],
            'train_check_rel_err': check_err,
            'train_kernel_ms': profile_rec['small_reflect_conv_ms']}


#: phase 8: timed fast requests, and the budgets: fast mode within 0.04
#: of the exact output's largest magnitude (docs/PERFORMANCE.md "Fast
#: inference mode"), the fast forward pass within 0.05 on the data scale
#: (tests/forward_pass/test_fast_mode.py)
N_FAST_REQUESTS = 5
FAST_BUDGET = 0.04
FWP_FAST_BUDGET = 0.05


#: the fused blocks the body rule (``kernels.body_kernel_wins``) sent to
#: ``reflect_conv`` (the default 'body' route) since ``zero_counts``, in
#: all and by spatial rank, and the fused blocks' forwards with gradients
#: whose weight gradient ``wgrad_kernel_wins`` sends to
#: ``reflect_conv_wgrad``: ``tally_gated``, a forward pre-hook on every
#: module, counts them in this process (registered where the script
#: starts, in the parent and in every rank)
GATED = Counter()


def wgrad_block(module, x, ctx):
    """What ``wgrad_kernel_wins`` reads of the input whose weight
    gradient a fused block's forward leaves to ``reflect_conv_backward``
    (a float32 3D block on the card with gradients on, on the routes that
    share that backward: the library route and the small kernel, on the
    gathered tensor where a shard gathers the small kernel's input), or
    None: the sharded and shard-aligned formulations have backwards of
    their own."""
    if not (torch.is_grad_enabled() and x.is_cuda
            and x.dtype == torch.float32 and module.n_spatial == 3
            and module.weight.requires_grad):
        return None
    route = module.route(x, ctx)
    if route not in ('small', 'gather_small', 'library') or (
            route == 'library' and module.shard_aligned):
        return None
    shape = tuple(x.shape)
    if route == 'gather_small':
        shape = shape[:2] + (ctx['s1'],) + shape[3:]
    return on_card(shape, x.dtype)


def tally_gated(module, args):
    if not isinstance(module, FusedReflectConv):
        return
    x, ctx = args
    # the 'body' route by the rule, not by ``use_pallas`` alone
    if module.route(x, ctx) == 'body' and kernels_module.body_kernel_wins(x):
        GATED['reflect_conv'] += 1
        GATED[f'reflect_conv_{module.n_spatial}d'] += 1
    block = wgrad_block(module, x, ctx)
    # dy, the block's output gradient, is in its input's dtype
    if block is not None and wgrad_kernel_wins(block, block):
        GATED['reflect_conv_wgrad'] += 1


def gated():
    """The blocks the gate sent to ``reflect_conv`` since
    ``zero_counts``."""
    return GATED['reflect_conv']


def wgrad_gated(recomputed=False):
    """The fused blocks' weight gradients the gate sends to
    ``reflect_conv_wgrad`` since ``zero_counts``: one a forward with
    gradients through such a block, each of whose outputs is
    differentiated once; with ``recomputed`` (``train_remat``), each
    block's forward ran twice, the second time in the backward."""
    n = GATED['reflect_conv_wgrad']
    return n // 2 if recomputed else n


def check_wgrad(where, launches, recomputed=False):
    """``reflect_conv_wgrad`` launched once for each weight gradient the
    gate sent it since ``zero_counts`` (``wgrad_gated``)."""
    want = wgrad_gated(recomputed)
    if launches['reflect_conv_wgrad'] != want:
        raise AssertionError(f'{where}: reflect_conv_wgrad launched '
                             f'{launches["reflect_conv_wgrad"]} times; the '
                             f'gate sent it {want} weight gradients')


def launch_counts():
    return {'small_reflect_conv': small_reflect_conv_cf.launches,
            'reflect_conv': reflect_conv_cf.launches,
            'reflect_conv_wgrad': reflect_conv_wgrad.launches}


def zero_counts():
    small_reflect_conv_cf.launches = reflect_conv_cf.launches = 0
    reflect_conv_wgrad.launches = 0
    reflect_conv_cf.launches_by_rank.update({2: 0, 3: 0})
    GATED.clear()


def chain_counts():
    """``launch_counts`` with ``reflect_conv``'s count split by the
    wrapper into 2D and 3D launches."""
    by_rank = reflect_conv_cf.launches_by_rank
    return {**launch_counts(), 'reflect_conv_2d': by_rank[2],
            'reflect_conv_3d': by_rank[3]}


def feature_errs(got, ref):
    """Per feature (the last axis): the largest |got - ref| and its bar,
    PARITY_RTOL x the feature's largest |ref|; and whether all pass."""
    ref = np.asarray(ref)
    ref = ref.reshape(-1, ref.shape[-1])
    errs = np.abs(np.asarray(got).reshape(ref.shape) - ref).max(axis=0)
    tols = PARITY_RTOL * np.abs(ref).max(axis=0)
    return errs.tolist(), tols.tolist(), bool((errs <= tols).all())


def fast_forward_pass(name):
    """Phase 8d: the forward-pass cell of phase 6 in fast mode: one exact
    pass, a warm-up, then 3 timed fast passes, each stitched output
    within 0.05 of the exact pass on the data scale, no kernel
    launched."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_fast_fwp_')
    try:
        rng = np.random.default_rng(0)
        s1, s2, t = FWP_DOMAIN
        input_file = make_fake_nc_file(
            os.path.join(tmp, 'input.nc'), FWP_DOMAIN, FWP_FEATURES,
            data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
                  for f in FWP_FEATURES})
        model = flagship('cuda')
        model.meta.update(
            input_resolution={'spatial': '12km', 'temporal': '60min'})
        model_dir = os.path.join(tmp, 'model')
        model.save(model_dir)
        del model

        def run(mode, out_dir):
            strategy = fwp_strategy(
                input_file, model_dir,
                os.path.join(out_dir, 'chunk_{file_id}.nc'),
                inference_mode=mode)
            RecordedForwardPass.run(strategy, 0)
            torch.cuda.synchronize()
            return strategy

        strategy = run('exact', os.path.join(tmp, 'exact'))
        _, exact = check_fwp_files(strategy, os.path.join(tmp, 'exact'),
                                   keep=True)
        run('fast', os.path.join(tmp, 'warm'))
        shutil.rmtree(os.path.join(tmp, 'warm'))
        tol = FWP_FAST_BUDGET * max(1.0, float(np.abs(exact).max()))
        walls, errs = [], []
        for i in range(N_FWP_PASSES):
            out_dir = os.path.join(tmp, f'fast_{i}')
            zero_counts()
            t0 = time.perf_counter()
            strategy = run('fast', out_dir)
            wall_s = time.perf_counter() - t0
            launches = launch_counts()
            hr_shape, full = check_fwp_files(strategy, out_dir, keep=True)
            err = float(np.abs(full - exact).max())
            ok = err <= tol and launches == {'small_reflect_conv': 0,
                                             'reflect_conv': 0,
                                             'reflect_conv_wgrad': 0}
            walls.append(wall_s)
            errs.append(err)
            emit(phase='fast_forward_pass', pass_index=i,
                 chunks=strategy.fwp_slicer.n_chunks, hr_shape=hr_shape,
                 wall_s=wall_s,
                 hr_voxels_per_s=int(np.prod(hr_shape)) / wall_s,
                 timer_s=RecordedForwardPass.last.timer.log,
                 max_abs_err_vs_exact=err, tol=tol, launches=launches,
                 ok=ok)
            if not ok:
                raise AssertionError(f'fast forward pass {i}: error {err} '
                                     f'(tol {tol}), launches {launches}')
        emit(phase='fast_forward_pass_route', wall_s=walls,
             hr_voxels_per_s=int(np.prod(FWP_DOMAIN)) * 9 * 4 / float(
                 np.median(walls)), max_abs_err_vs_exact=max(errs),
             tol=tol, nvidia_smi=name)
        return float(np.median(walls))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fast_serving_phase(name):
    """Phase 8: fast mode, the 'custom' mode and their refusal on the
    flagship at full width; returns the launches per request of each."""
    model = flagship('cuda')
    lr = np.random.default_rng(0).standard_normal(LR_SHAPE).astype(
        np.float32) * 0.3 + 0.5
    exact = model.generate(lr)
    scale = float(np.abs(exact).max())
    hr_voxels = int(np.prod(HR_SHAPE[:-1]))
    per_request = {}

    # 8a. fast mode: the subpixel tail and a bf16 body on cuDNN
    model.inference_mode = 'fast'
    model.generate(lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    out, times = serve(model, lr, 'fast mode', N_FAST_REQUESTS)
    per_request['fast'] = {k: v / N_FAST_REQUESTS
                           for k, v in launch_counts().items()}
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    err = float(np.abs(out - exact).max()) / scale
    wall_ms, busy_ms, top, _, d2h_ms = profile_request(model, lr)
    median = float(np.median(times))
    ok = err <= FAST_BUDGET and per_request['fast'] == {
        'small_reflect_conv': 0, 'reflect_conv': 0, 'reflect_conv_wgrad': 0}
    emit(phase='fast_serving', mode=model.inference_mode,
         lr_shape=list(LR_SHAPE), hr_shape=list(out.shape),
         requests=N_FAST_REQUESTS, request_ms=times,
         median_request_ms=median,
         hr_voxels_per_s=hr_voxels / (median / 1e3),
         fast_max_rel_err=err, tol=FAST_BUDGET,
         launches_per_request=per_request['fast'],
         allocated_before_gb=before / 1e9, request_peak_gb=peak_gb,
         profile={'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
                  'idle_share': 1 - busy_ms / wall_ms, 'd2h_ms': d2h_ms,
                  'top_device': top},
         nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'fast mode: max rel err {err} (budget '
                             f'{FAST_BUDGET}), launches '
                             f'{per_request["fast"]}')

    # 8b. 'custom': the subpixel tail in float32, the body on reflect_conv
    model.inference_mode = 'exact'
    model.inference_subpixel_tail = True
    model.inference_pallas = True
    zero_counts()
    out, times = serve(model, lr, 'custom mode')
    per_request['custom'] = {k: v / N_REQUESTS
                             for k, v in launch_counts().items()}
    err = float(np.abs(out - exact).max()) / scale
    ok = err <= PARITY_RTOL and per_request['custom'] == {
        'small_reflect_conv': 0, 'reflect_conv': N_BODY_BLOCKS,
        'reflect_conv_wgrad': 0}
    emit(phase='custom_serving', mode=model.inference_mode,
         inference_subpixel_tail=True, inference_dtype=None,
         inference_pallas=True, request_ms=times,
         hr_voxels_per_s=hr_voxels / (float(np.median(times)) / 1e3),
         max_rel_err_vs_exact=err, tol=PARITY_RTOL,
         launches_per_request=per_request['custom'], ok=ok)
    if not ok:
        raise AssertionError(f'custom mode: max rel err {err}, launches '
                             f'{per_request["custom"]}')

    # 8c. fast mode with inference_pallas: refused, as the JAX package's
    # Pallas kernel refuses bf16
    model.inference_mode = 'fast'
    zero_counts()
    try:
        model.generate(lr)
        message = None
    except ValueError as exc:
        message = str(exc)
    ok = (message is not None and 'float32 only' in message
          and launch_counts()['reflect_conv'] == 0)
    emit(phase='fast_pallas_refused', raised=message is not None,
         message=(message or '')[:160], ok=ok)
    if not ok:
        raise AssertionError('fast mode with inference_pallas=True was not '
                             f'refused for its fp32-only kernel: {message}')
    del model, out, exact

    # 8d. the forward-pass cell in fast mode
    fast_forward_pass(name)
    return per_request


#: phase 9: test_bf16_train.py's small fixture (the JAX package's bars:
#: losses within rtol 0.05 / atol 0.02, the first kernel within 0.01)
BF16_GEN = [
    {'class': 'FlexiblePadding',
     'paddings': [[0, 0], [1, 1], [1, 1], [1, 1], [0, 0]],
     'mode': 'REFLECT'},
    {'class': 'Conv3D', 'filters': 8, 'kernel_size': 3, 'strides': 1},
    {'class': 'LeakyReLU', 'alpha': 0.2},
    {'class': 'SpatioTemporalExpansion', 'spatial_mult': 2,
     'temporal_mult': 2, 'temporal_method': 'nearest'},
    {'class': 'Conv3D', 'filters': 2, 'kernel_size': 3, 'strides': 1,
     'padding': 'same'}]
BF16_DISC = [{'class': 'Conv3D', 'filters': 4, 'kernel_size': 3,
              'strides': 2, 'padding': 'same'},
             {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
REMAT_RTOL = 1e-5


def bf16_trajectory_check():
    """Phase 9b: the small fixture trained 2 epochs in float32 and in
    bf16 on the card, from the same data, weights and batches."""
    features = ['u_100m', 'v_100m']
    runs = {}
    for dtype in (None, 'bfloat16'):
        RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
            77).bit_generator.state
        handler = BatchHandler(
            [make_fake_dset((16, 16, 40), features)], batch_size=4,
            n_batches=3, s_enhance=2, t_enhance=2, sample_shape=(8, 8, 4),
            max_workers=1)
        model = Sup3rGan(BF16_GEN, BF16_DISC, learning_rate=1e-3)
        model.train_dtype = dtype
        model.init_weights((1, 4, 4, 2, 2), (1, 8, 8, 4, 2), seed=5)
        model.train(handler, input_resolution={'spatial': '30km',
                                               'temporal': '60min'},
                    n_epoch=2, out_dir=None)
        handler.stop()
        kernel = next(p for p in params_to_jax(model._gen)
                      if 'kernel' in p)['kernel']
        runs[dtype] = ({c: np.asarray(model.history[c], float)
                        for c in ('train_loss_gen', 'train_loss_disc')},
                       kernel, model)
    (h32, w32, _), (h16, w16, m16) = runs[None], runs['bfloat16']
    loss_err = {c: float(np.max(np.abs(h16[c] - h32[c])
                                - 0.05 * np.abs(h32[c])))
                for c in h32}
    weight_err = float(np.abs(w16 - w32).max())
    fp32_state = all(t.dtype == torch.float32 for t in (
        *m16.gen_params, *m16.disc_params, *m16._gen_opt_state['mu'],
        *m16._gen_opt_state['nu'], *m16._disc_opt_state['mu'],
        *m16._disc_opt_state['nu']))
    ok = (all(np.isfinite(v).all() for v in (*h16.values(),
                                             *h32.values()))
          and all(v <= 0.02 for v in loss_err.values())
          and weight_err <= 0.01 and not np.array_equal(w16, w32)
          and fp32_state)
    emit(phase='train_bf16_vs_fp32',
         losses_fp32={c: v.tolist() for c, v in h32.items()},
         losses_bf16={c: v.tolist() for c, v in h16.items()},
         loss_excess_over_rtol=loss_err, loss_atol=0.02,
         kernel_max_abs_diff=weight_err, kernel_atol=0.01,
         float32_master_weights_and_moments=fp32_state, ok=ok)
    if not ok:
        raise AssertionError('bf16 training does not track float32 on the '
                             f'card: losses {loss_err}, kernel '
                             f'{weight_err}, fp32 state {fp32_state}')


def remat_cell(name, fp32):
    """Phase 9c: the training cell with ``train_remat``: timed, peak
    memory, ``small_reflect_conv`` launched twice per step (the
    recomputed forward is the kernel's), gradients within 1e-5 of the
    plain step's largest magnitude."""
    model = train_model('cuda')
    model.train_remat = True
    lr, hr, median, per_step, memory = train_step_phase(
        name, model, phase='train_step_remat',
        want=(('small_reflect_conv', 2), ('reflect_conv', 0)))
    zero_counts()
    remat = step_grads(model, lr, hr)
    launches_remat = launch_counts()
    check_wgrad('remat gradients', launches_remat, recomputed=True)
    model.train_remat = False
    zero_counts()
    plain = step_grads(model, lr, hr)
    launches_plain = launch_counts()
    check_wgrad('plain gradients', launches_plain)
    errs = {'gen': rel_err(remat[0], plain[0]),
            'disc': rel_err(remat[1], plain[1])}
    ok = (max(errs.values()) <= REMAT_RTOL
          and launches_remat['small_reflect_conv'] == 2
          and launches_plain['small_reflect_conv'] == 1)
    emit(phase='train_remat_check', median_step_ms=median,
         fp32_step_ms=fp32['step_ms'], step_ratio=median / fp32['step_ms'],
         step_peak_gb=memory['step_peak_gb'],
         fp32_step_peak_gb=fp32['step_peak_gb'],
         grad_rel_err=errs, tol=REMAT_RTOL,
         launches_grads_remat=launches_remat,
         launches_grads_plain=launches_plain, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'remat step: gradients {errs}, launches '
                             f'{launches_remat} / {launches_plain}')
    return per_step


def dual_train_loop(name):
    """Phase 9d: ``Sup3rGan.train`` in bf16 over a ``DualBatchHandler``
    of paired NetCDF3 data: an hourly (72, 72, 240) HR file and a 4-hourly
    (24, 24, 60) LR file on a wider grid, read by ``DataHandler`` and
    regridded by ``DualRasterizer``; 2 epochs of 4 batches of 16, HR
    samples (36, 36, 48), LR (12, 12, 12)."""
    features = ['u_100m', 'v_100m']
    tmp = tempfile.mkdtemp(prefix='chip_smoke_dual_')
    try:
        hr_file = make_fake_nc_file(os.path.join(tmp, 'hr.nc'),
                                    (72, 72, 240), features)
        lr_file = make_fake_nc_file(
            os.path.join(tmp, 'lr.nc'), (24, 24, 60), features,
            freq=np.timedelta64(4, 'h'), lat_range=(40.05, 38.95),
            lon_range=(-105.55, -104.25))
        t0 = time.perf_counter()
        dual = DualRasterizer((DataHandler(lr_file, features=features).data,
                               DataHandler(hr_file, features=features).data),
                              s_enhance=3, t_enhance=4)
        handler = DualBatchHandler(
            [dual], batch_size=TRAIN_BATCH, n_batches=4, s_enhance=3,
            t_enhance=4, sample_shape=TRAIN_HR[:3])
        setup_s = time.perf_counter() - t0
        model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                         get_config('spatiotemporal/disc_test'),
                         learning_rate=TRAIN_LR_RATE)
        model.train_dtype = 'bfloat16'
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train(handler, input_resolution={'spatial': '3km',
                                               'temporal': '60min'},
                    n_epoch=2, weight_gen_advers=W_ADV, out_dir=None)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        history = model.history
        epoch_s = np.diff([0.0] + list(history['elapsed_time']))
        ok = (len(history) == 2 and all(
            np.isfinite(history[c]).all()
            for c in ('train_loss_gen', 'train_loss_disc'))
            and launches == {'small_reflect_conv': 0, 'reflect_conv': 0,
                             'reflect_conv_wgrad': 0}
            and dual.lr_data.shape == (24, 24, 60, 2)
            and not np.isnan(dual.lr_data.data).any())
        emit(phase='train_loop_dual_bf16', epochs=2, batches_per_epoch=4,
             batch=TRAIN_BATCH, lr_sample=list(handler.lr_shape),
             hr_sample=list(handler.hr_shape), setup_s=setup_s,
             wall_s=wall_s, epoch_s=list(epoch_s),
             s_per_batch=float(np.mean(epoch_s)) / 4,
             starvation_rate=handler._queue.starvation_rate,
             history={c: list(history[c]) for c in history.columns},
             launches=launches, nvidia_smi=name, ok=ok)
        if not ok:
            raise AssertionError('dual bf16 train loop: history, launches '
                                 'or regrid failed')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def step_memory(model, lr, hr):
    """Device memory (GB above what was allocated before the step) of
    one step's parts, built as ``step_grads`` builds them: what the
    forward keeps for the backward, and the peak of the forward, of the
    generator's backward (through the discriminator) and of the
    discriminator's backward."""
    gen_apply = model._maybe_remat(model._train_gen_net().apply)
    cast = model._train_cast()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = {}

    def mark(key):
        torch.cuda.synchronize()
        out[key] = (torch.cuda.max_memory_allocated() - base) / 1e9
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    with exact_fp32():
        gen = gen_apply(cast(lr), {}).float()
        d_true = model._disc.apply(cast(hr)).float()
        d_gen = model._disc.apply(cast(gen)).float()
        gen_loss = (model.loss_fun(gen, hr)
                    + W_ADV * relativistic_disc_loss(d_gen, d_true))
        disc_loss = relativistic_disc_loss(d_true, d_gen)
        mark('forward_peak_gb')
        out['forward_kept_gb'] = (torch.cuda.memory_allocated() - base) / 1e9
        torch.autograd.grad(gen_loss, model.gen_params, retain_graph=True)
        mark('gen_backward_peak_gb')
        torch.autograd.grad(disc_loss, model.disc_params)
        mark('disc_backward_peak_gb')
    return out


def training_modes_phase(name, fp32):
    """Phase 9: bf16 and remat training and the paired feed; returns the
    launches per step of each mode."""
    # 9a. the training cell in bf16
    model = train_model('cuda')
    model.train_dtype = 'bfloat16'
    lr, hr, median, per_bf16, step_mem = train_step_phase(
        name, model, phase='train_step_bf16',
        want=(('small_reflect_conv', 0), ('reflect_conv', 0)))
    phases = train_phase_times(model, lr, hr)
    profile_rec = train_profile(model, lr, hr)
    memory = {'bfloat16': step_memory(model, lr, hr)}
    emit(phase='train_bf16_profile', median_step_ms=median,
         fp32_step_ms=fp32['step_ms'], speedup=fp32['step_ms'] / median,
         step_peak_gb=step_mem['step_peak_gb'],
         fp32_step_peak_gb=fp32['step_peak_gb'],
         phase_device_ms=phases, nvidia_smi=name, **profile_rec)
    del model
    for remat in (False, True):
        model = train_model('cuda')
        model.train_remat = remat
        memory['remat' if remat else 'float32'] = step_memory(model, lr, hr)
        del model
    emit(phase='train_memory', batch=TRAIN_BATCH, gb=memory,
         nvidia_smi=name)
    # 9b-d
    bf16_trajectory_check()
    per_remat = remat_cell(name, fp32)
    dual_train_loop(name)
    return {'bf16': per_bf16, 'remat': per_remat}


#: phase 10, the Sup3rCC wind chain: daily low-res domain (s1, s2, t),
#: chunk shape and pads (18 chunks, each padded to (14, 14, 6) LR), the
#: six wind / surface features, the topography source's grid (finer than
#: the 5x HR grid's 150 x 150) and the timed passes per route
CHAIN_DOMAIN = (30, 30, 8)
CHAIN_CHUNK = (10, 10, 4)
CHAIN_S_PAD = 2
CHAIN_T_PAD = 1
CHAIN_FEATURES = ['u_10m', 'v_10m', 'u_100m', 'v_100m', 'temperature_2m',
                  'relativehumidity_2m']
CHAIN_TOPO_GRID = (180, 180)
CHAIN_LAT = (40.0, 39.0)
CHAIN_LON = (-105.5, -104.3)
N_CHAIN_PASSES = 3
#: the chain's output stats: outputs of the random networks land inside
#: each feature's physical limits, so the writer keeps them as they are
CHAIN_MEANS = {'u_10m': 0.0, 'v_10m': 0.0, 'u_100m': 0.0, 'v_100m': 0.0,
               'temperature_2m': 10.0, 'relativehumidity_2m': 50.0,
               'topography': 500.0}
CHAIN_STDEVS = {'u_10m': 0.5, 'v_10m': 0.5, 'u_100m': 0.5, 'v_100m': 0.5,
                'temperature_2m': 0.5, 'relativehumidity_2m': 0.2,
                'topography': 300.0}
#: ``reflect_conv``'s 2D main-path blocks in one chunk of step 0 (input
#: shape (batch = time, ci, h, w), co, LeakyReLU alpha, launches per
#: chunk on the opt-in route); phase 10 asserts them against the fused
#: blocks' calls in a whole opt-in pass
CHAIN_2D_SHAPES = (((6, 7, 14, 14), 64, 0.2, 1),
                   ((6, 64, 14, 14), 64, 0.2, 8),
                   ((6, 64, 14, 14), 64, None, 9),
                   ((6, 64, 14, 14), 1600, 0.2, 1),
                   ((6, 65, 70, 70), 64, 0.2, 1),
                   ((6, 64, 70, 70), 64, 0.2, 8),
                   ((6, 64, 70, 70), 64, None, 9),
                   ((6, 64, 70, 70), 6, None, 1))
#: ragged 2D checks of ``reflect_conv`` (x shape, co, alpha): a last N
#: tile with 2 channels, ci neither a whole K chunk nor above one, the
#: smallest input that reflects, widths the kernel's tile does not divide
RAGGED_2D_CHECKS = (((3, 9, 13, 11), 130, 0.2),
                    ((1, 3, 2, 2), 5, None),
                    ((5, 65, 17, 23), 1600, None),
                    ((2, 1, 31, 7), 72, 0.2))


class ChainForwardPass(RecordedForwardPass):
    """``RecordedForwardPass`` that counts its chunk-by-chunk runs and its
    batched dispatches, and times a chunk run's stages:
    ``run_generator`` (the chain on the device and its fetch),
    ``_output_check`` and ``_write`` (transform + NetCDF)."""

    def __init__(self, *args, **kwargs):
        self.chunk_runs = self.dispatches = 0
        super().__init__(*args, **kwargs)

    def run_chunk(self, *args, **kwargs):
        self.chunk_runs += 1
        return super().run_chunk(*args, **kwargs)

    def run_generator(self, *args, **kwargs):
        return self.timer(ForwardPass.run_generator)(*args, **kwargs)

    def _output_check(self, *args, **kwargs):
        return self.timer(ForwardPass._output_check)(*args, **kwargs)

    def _write(self, *args, **kwargs):
        return self.timer(super()._write)(*args, **kwargs)

    def _dispatch_chunk_batch(self, batch):
        out = super()._dispatch_chunk_batch(batch)
        self.dispatches += out is not None
        return out


def chain_inputs(tmp, domain=CHAIN_DOMAIN, seed=0):
    """A daily NetCDF3 input of ``domain`` low-res cells with the six
    features (drawn at the chain's norm stats), and a NetCDF3 topography
    source over the same extent on a grid finer than the HR grid."""
    rng = np.random.default_rng(seed)
    s1, s2, t = domain
    data = {f: rng.standard_normal((t, s1, s2)) * CHAIN_STDEVS[f]
            + CHAIN_MEANS[f] for f in CHAIN_FEATURES}
    input_file = make_fake_nc_file(
        os.path.join(tmp, f'daily_{s1}x{s2}x{t}.nc'), domain, CHAIN_FEATURES,
        freq='D', lat_range=CHAIN_LAT, lon_range=CHAIN_LON, data=data)
    topo = make_fake_topo_nc_file(
        os.path.join(tmp, 'topography.nc'), CHAIN_TOPO_GRID,
        lat_range=(CHAIN_LAT[0] + 0.05, CHAIN_LAT[1] - 0.05),
        lon_range=(CHAIN_LON[0] - 0.05, CHAIN_LON[1] + 0.05),
        data=rng.random(CHAIN_TOPO_GRID) * 2000)
    return input_file, topo


def chain_members(device):
    """The Sup3rCC wind chain at full width from seed 0: step 0
    ``sup3rcc/gen_wind_5x_1x_6f`` (topography as an input channel and
    through its Sup3rConcat layer), step 1 ``sup3rcc/gen_wind_1x_24x_6f``."""
    disc = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    res = {'spatial': '100km', 'temporal': '1440min'}
    spatial = Sup3rGan(
        get_config('sup3rcc/gen_wind_5x_1x_6f'), disc,
        meta={'lr_features': CHAIN_FEATURES + ['topography'],
              'hr_out_features': list(CHAIN_FEATURES),
              's_enhance': 5, 't_enhance': 1, 'input_resolution': res},
        means=CHAIN_MEANS, stdevs=CHAIN_STDEVS, device=device)
    spatial.init_weights((1, 4, 4, 7), (1, 20, 20, 6), seed=0)
    temporal = Sup3rGan(
        get_config('sup3rcc/gen_wind_1x_24x_6f'), disc,
        meta={'lr_features': list(CHAIN_FEATURES),
              'hr_out_features': list(CHAIN_FEATURES),
              's_enhance': 1, 't_enhance': 24, 'input_resolution': res},
        means=CHAIN_MEANS, stdevs=CHAIN_STDEVS, device=device)
    temporal.init_weights((1, 4, 4, 2, 6), (1, 4, 4, 48, 6), seed=0)
    return spatial, temporal


def chain_strategy(input_file, model_dirs, topo, out_pattern,
                   device='cuda', **kwargs):
    """The chain's strategy; its topography cache lives beside the
    source (one cold rasterization for all passes)."""
    kw = dict(file_paths=input_file, model_class='MultiStepGan',
              model_kwargs={'model_dirs': model_dirs, 'device': device},
              fwp_chunk_shape=CHAIN_CHUNK, spatial_pad=CHAIN_S_PAD,
              temporal_pad=CHAIN_T_PAD, device_batch_size=6,
              exo_handler_kwargs={'topography': {
                  'source_file': topo, 'cache_dir': os.path.join(
                      os.path.dirname(topo), 'exo_cache')}},
              out_pattern=out_pattern)
    kw.update(kwargs)
    return ForwardPassStrategy(**kw)


def chain_fused_calls(members):
    """Forward pre-hooks on every fused block of the members' serving
    networks; returns (calls, remove): ``calls`` collects (n_spatial,
    input shape, co, alpha) of each block call."""
    calls, hooks = [], []
    for member in members:
        for lyr in member._get_fused_apply().layers:
            if isinstance(lyr, FusedReflectConv):
                hooks.append(lyr.register_forward_pre_hook(
                    lambda m, args: calls.append(
                        (m.n_spatial, tuple(args[0].shape),
                         m.conv.bias.shape[0], m.alpha))))

    def remove():
        for h in hooks:
            h.remove()

    return calls, remove


def chain_pass(make_strategy, out_dir, route, index, want,
               features=CHAIN_FEATURES, phase='chain_pass'):
    """One timed ``ForwardPass.run`` of a chain to NetCDF (the strategy
    from ``make_strategy(out_pattern)``); checks the wrappers' launch
    counts against ``want`` (on the default route, ``reflect_conv``'s
    against the blocks the gate sent to it) and returns (wall s, tiled
    output, launch counts)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strategy = make_strategy(os.path.join(out_dir, 'chunk_{file_id}.nc'))
    plan_s = time.perf_counter() - t0
    ChainForwardPass.run(strategy, 0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = chain_counts()
    want = {**want, 'reflect_conv_wgrad': 0}
    if route == 'default':
        want = {**want, **{k: GATED[k] for k in (
            'reflect_conv', 'reflect_conv_2d', 'reflect_conv_3d')}}
    fwp = ChainForwardPass.last
    _, full = check_fwp_files(strategy, out_dir, keep=True,
                              domain=CHAIN_DOMAIN, features=features)
    n_chunks = strategy.fwp_slicer.n_chunks
    ok = (launches == want and fwp.chunk_runs == n_chunks
          and fwp.dispatches == 0)
    emit(phase=phase, route=route, pass_index=index, chunks=n_chunks,
         chunk_runs=fwp.chunk_runs, batched_dispatches=fwp.dispatches,
         hr_shape=list(full.shape), wall_s=wall_s, plan_s=plan_s,
         hr_voxels_per_s=int(np.prod(full.shape[:3])) / wall_s,
         timer_s=fwp.timer.log, launches=launches, expected=want, ok=ok)
    if not ok:
        raise AssertionError(
            f'{phase} ({route}): launches {launches} (expected {want}), '
            f'{fwp.chunk_runs} chunk runs and {fwp.dispatches} batched '
            f'dispatches for {n_chunks} chunks')
    return wall_s, full, launches


def chain_cpu_check(make_strategy, small, topo, members,
                    features=CHAIN_FEATURES, phase='chain_cpu_check'):
    """One chunk of a small (4, 4, 2) domain (``small``, ``topo``): the
    card's chain output on both routes against the port's CPU chain (the
    parity bar). ``make_strategy(input, topo, out, device=, **kw)`` builds
    the strategy, ``members(chain)`` lists the members a route sets."""
    kw = dict(fwp_chunk_shape=(4, 4, 2), spatial_pad=0, temporal_pad=0,
              device_batch_size=1)
    cpu = ForwardPass.run(make_strategy(small, topo, None, device='cpu',
                                        **kw), 0)
    strategy = make_strategy(small, topo, None, **kw)
    chain = strategy.get_model()
    errs, ok = {}, bool(np.isfinite(cpu[0]).all())
    for route, pallas in (('default', False), ('opt_in', True)):
        for m in members(chain):
            m.inference_pallas = pallas
        card = ForwardPass.run(strategy, 0)
        errs[route], tols, ok_route = feature_errs(card[0], cpu[0])
        ok = ok and ok_route
    for m in members(chain):
        m.inference_pallas = False
    emit(phase=phase, chunk_hr_shape=list(cpu[0].shape), features=features,
         max_abs_err=errs, tol=tols, ok=ok)
    if not ok:
        raise AssertionError(f'{phase}: card vs CPU {errs} > {tols}')


def exo_batched_check(tmp):
    """A test-sized 5D Sup3rGan with a Sup3rConcat topography layer
    (tests/forward_pass/test_batched_fwp.py's) through the device-batched
    exo path on the card, against its chunk-by-chunk run."""
    features = ['u_100m', 'v_100m']
    gen = [{'class': 'Conv3D', 'filters': 8, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'},
           {'class': 'SpatioTemporalExpansion', 'spatial_mult': 2},
           {'class': 'Sup3rConcat', 'name': 'topography'},
           {'class': 'Conv3D', 'filters': 2, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'}]
    model = Sup3rGan(gen, [{'class': 'Flatten'},
                           {'class': 'Dense', 'units': 1}],
                     meta={'lr_features': features,
                           'hr_out_features': features,
                           's_enhance': 2, 't_enhance': 1,
                           'input_resolution': {'spatial': '12km',
                                                'temporal': '60min'}},
                     means={'u_100m': 0.1, 'v_100m': 0.1,
                            'topography': 500.0},
                     stdevs={'u_100m': 0.9, 'v_100m': 0.9,
                             'topography': 300.0}, device='cuda')
    model.init_weights((1, 6, 6, 4, 2), (1, 12, 12, 4, 2), seed=0)
    model_dir = os.path.join(tmp, 'st_topo')
    model.save(model_dir)
    input_file = make_fake_nc_file(os.path.join(tmp, 'st_in.nc'),
                                   (12, 12, 4), ['u100', 'v100'],
                                   lat_range=CHAIN_LAT, lon_range=CHAIN_LON)
    topo = os.path.join(tmp, 'topography.nc')
    outs, runs = {}, {}
    for batch in (4, 1):
        strategy = ForwardPassStrategy(
            file_paths=input_file,
            model_kwargs={'model_dir': model_dir, 'device': 'cuda'},
            fwp_chunk_shape=(4, 6, 4), spatial_pad=1, temporal_pad=0,
            exo_handler_kwargs={'topography': {
                'source_file': topo,
                'cache_dir': os.path.join(tmp, 'exo_cache')}},
            out_pattern=None, device_batch_size=batch)
        outs[batch] = ChainForwardPass.run(strategy, 0)
        fwp = ChainForwardPass.last
        runs[batch] = {'batched_dispatches': fwp.dispatches,
                       'chunk_runs': fwp.chunk_runs}
    ok = sorted(outs[4]) == sorted(outs[1])
    err, tol, ok_err = feature_errs(
        np.stack([outs[4][i] for i in sorted(outs[4])]) if ok else 0.0,
        np.stack([outs[1][i] for i in sorted(outs[1])]))
    ok = ok and ok_err and runs[4] == {'batched_dispatches': 2,
                                       'chunk_runs': 0}
    emit(phase='exo_batched_check', chunks=len(outs[1]), runs=runs,
         features=features, max_abs_err=err, tol=tol, ok=ok)
    if not ok:
        raise AssertionError(f'batched exo vs chunk by chunk: {err} > {tol} '
                             f'or runs {runs}')


def chain_phase(name):
    """Phase 10: the Sup3rCC wind chain with topography through the
    chunked ForwardPass on both routes; returns the wrappers' launch
    counts of each route's last pass and the 2D block calls of the last
    opt-in pass by (input shape, co, alpha)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_chain_')
    try:
        input_file, topo = chain_inputs(tmp)
        spatial, temporal = chain_members('cuda')
        MultiStepGan([spatial, temporal]).save(os.path.join(tmp, 'chain'))
        del spatial, temporal
        dirs = [os.path.join(tmp, 'chain', f'model_step_{i}') for i in (0, 1)]
        # the cold pass: the strategy rasterizes topography onto both
        # steps' grids and writes the cache
        with Timer() as cold:
            strategy = chain_strategy(input_file, dirs, topo, None)
        with Timer() as warm:
            chain_strategy(input_file, dirs, topo, None)
        steps = strategy.exo_data['topography']['steps']
        emit(phase='chain_exo', cold_s=cold.elapsed, cached_s=warm.elapsed,
             steps=[{k: v for k, v in s.items() if k != 'data'}
                    | {'shape': list(s['data'].shape)} for s in steps],
             chunks=strategy.fwp_slicer.n_chunks,
             padded_lr_chunk=[c + 2 * p for c, p in zip(
                 CHAIN_CHUNK, (CHAIN_S_PAD, CHAIN_S_PAD, CHAIN_T_PAD))])
        chain = strategy.get_model()
        n_chunks = strategy.fwp_slicer.n_chunks
        # launches per chunk on the opt-in route, counted from the fused
        # networks: every fused block the small kernel does not take
        blocks = [lyr.n_spatial for m in chain.models
                  for lyr in m._get_fused_apply().layers
                  if isinstance(lyr, FusedReflectConv)
                  and not takes_small(lyr)]
        per_chunk = {'2d': blocks.count(2), '3d': blocks.count(3)}
        want = {'default': dict.fromkeys(
                    ('small_reflect_conv', 'reflect_conv', 'reflect_conv_2d',
                     'reflect_conv_3d'), 0),
                'opt_in': {'small_reflect_conv': 0,
                           'reflect_conv': n_chunks * (per_chunk['2d']
                                                       + per_chunk['3d']),
                           'reflect_conv_2d': n_chunks * per_chunk['2d'],
                           'reflect_conv_3d': n_chunks * per_chunk['3d']}}
        want_2d = Counter({(x, co, alpha): k * n_chunks
                           for x, co, alpha, k in CHAIN_2D_SHAPES})
        ChainForwardPass.run(chain_strategy(
            input_file, dirs, topo,
            os.path.join(tmp, 'warm', 'chunk_{file_id}.nc')), 0)
        shutil.rmtree(os.path.join(tmp, 'warm'))
        walls, outs, launches = {}, {}, {}
        for route, pallas in (('default', False), ('opt_in', True)):
            for m in chain.models:
                m.inference_pallas = pallas
            walls[route] = []
            for i in range(N_CHAIN_PASSES):
                # the last opt-in pass also hooks every fused block call
                calls, remove = (chain_fused_calls(chain.models)
                                 if pallas and i == N_CHAIN_PASSES - 1
                                 else ([], lambda: None))
                try:
                    wall, outs[route], launches[route] = chain_pass(
                        lambda out: chain_strategy(input_file, dirs, topo,
                                                   out),
                        os.path.join(tmp, f'{route}_{i}'), route, i,
                        want[route])
                finally:
                    remove()
                walls[route].append(wall)
            if pallas:
                calls_2d = Counter(c[1:] for c in calls if c[0] == 2)
                n3d = sum(c[0] == 3 for c in calls)
                ok = (calls_2d == want_2d
                      and sum(calls_2d.values())
                      == launches[route]['reflect_conv_2d']
                      and n3d == launches[route]['reflect_conv_3d'])
                emit(phase='chain_blocks', per_chunk=per_chunk,
                     calls_2d=sum(calls_2d.values()), calls_3d=n3d,
                     calls_2d_by_shape=[[list(x), co, alpha, n] for
                                        (x, co, alpha), n in calls_2d.items()],
                     launches=launches[route], ok=ok)
                if not ok:
                    raise AssertionError(
                        f'chain blocks: 2D calls {dict(calls_2d)} (expected '
                        f'{dict(want_2d)}), {n3d} 3D calls, launches '
                        f'{launches[route]}')
            emit(phase='chain_route', route=route, wall_s=walls[route],
                 hr_voxels_per_s=int(np.prod(CHAIN_DOMAIN)) * 25 * 24
                 / float(np.median(walls[route])), nvidia_smi=name)
            fwp_profiled_pass(
                lambda out: chain_strategy(input_file, dirs, topo, out),
                os.path.join(tmp, f'{route}_profiled'), route,
                phase='chain_profile')
        for m in chain.models:
            m.inference_pallas = False
        errs, tols, ok = feature_errs(outs['opt_in'], outs['default'])
        emit(phase='chain_routes_agree', features=CHAIN_FEATURES,
             max_abs_err=errs, tol=tols, ok=ok)
        if not ok:
            raise AssertionError(f'chain: routes differ by {errs} > {tols}')
        os.makedirs(os.path.join(tmp, 'small'))
        chain_cpu_check(
            lambda small, topo, out, **kw: chain_strategy(
                small, dirs, topo, out, **kw),
            *chain_inputs(os.path.join(tmp, 'small'), (4, 4, 2), seed=1),
            lambda chain: chain.models)
        exo_batched_check(tmp)
        return launches, calls_2d
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 11, the Sup3rCC solar chain: phase 10's domain, chunks and pads
#: with clearsky_ratio beside the six wind features; the temporal member's
#: lr features; the clearsky ratio's stats
SOLAR_FEATURES = ['clearsky_ratio'] + CHAIN_FEATURES
SOLAR_T_FEATURES = ['clearsky_ratio', 'u_100m', 'v_100m']
SOLAR_MEANS = {**CHAIN_MEANS, 'clearsky_ratio': 0.5}
SOLAR_STDEVS = {**CHAIN_STDEVS, 'clearsky_ratio': 0.25}
#: ``reflect_conv``'s blocks in one chunk of the solar members that phase
#: 10 does not give it: the spatial solar member's 2D blocks with their
#: launches per chunk (its first block takes clearsky_ratio alone, no
#: Sup3rConcat after the expansion, a 64 -> 1 tail), and the temporal
#: SolarCC's 3D blocks (3 input channels at t = 6, the 64 -> 512 block
#: before ``depth_to_time``, the 64 -> 1 tail at t = 48); phase 11 asserts
#: them against the fused blocks' calls
SOLAR_2D_SHAPES = (((6, 1, 14, 14), 64, 0.2, 1),
                   ((6, 64, 14, 14), 64, 0.2, 8),
                   ((6, 64, 14, 14), 64, None, 9),
                   ((6, 64, 14, 14), 1600, 0.2, 1),
                   ((6, 64, 70, 70), 64, 0.2, 9),
                   ((6, 64, 70, 70), 64, None, 9),
                   ((6, 64, 70, 70), 1, None, 1))
SOLAR_3D_SHAPES = (((1, 3, 70, 70, 6), 64, 0.2, 1),
                   ((1, 64, 70, 70, 6), 64, 0.2, 17),
                   ((1, 64, 70, 70, 6), 64, None, 16),
                   ((1, 64, 70, 70, 6), 512, 0.2, 1),
                   ((1, 64, 70, 70, 48), 1, None, 1))
#: the new shapes among them, held to the plain version and timed
SOLAR_NEW_SHAPES = (SOLAR_2D_SHAPES[0], SOLAR_2D_SHAPES[6]) + SOLAR_3D_SHAPES
#: the SolarCC training cell: batch, LR and HR (three days of daylight
#: windows at 8x), the card-vs-CPU check's batch and grid
SOLAR_TRAIN_BATCH = 8
SOLAR_TRAIN_LR = (20, 20, 9, 3)
SOLAR_TRAIN_HR = (20, 20, 72, 1)
SOLAR_CHECK_GRID = (12, 12)
#: the temporal member's tail conv is drawn at this fraction of its seeded
#: scale, so the random chain's clearsky ratio lands inside its physical
#: range (0, 1): the writer NN-fills values outside it, a step that two
#: routes within rounding of each other would take differently
SOLAR_TAIL_SCALE = 0.02


def solar_inputs(tmp, domain=CHAIN_DOMAIN, seed=0):
    """Phase 10's inputs with clearsky_ratio in [0, 1] beside the six wind
    features."""
    rng = np.random.default_rng(seed)
    s1, s2, t = domain
    data = {f: rng.standard_normal((t, s1, s2)) * CHAIN_STDEVS[f]
            + CHAIN_MEANS[f] for f in CHAIN_FEATURES}
    data['clearsky_ratio'] = rng.random((t, s1, s2))
    input_file = make_fake_nc_file(
        os.path.join(tmp, f'solar_daily_{s1}x{s2}x{t}.nc'), domain,
        SOLAR_FEATURES, freq='D', lat_range=CHAIN_LAT, lon_range=CHAIN_LON,
        data=data)
    topo = make_fake_topo_nc_file(
        os.path.join(tmp, 'topography.nc'), CHAIN_TOPO_GRID,
        lat_range=(CHAIN_LAT[0] + 0.05, CHAIN_LAT[1] - 0.05),
        lon_range=(CHAIN_LON[0] - 0.05, CHAIN_LON[1] + 0.05),
        data=rng.random(CHAIN_TOPO_GRID) * 2000)
    return input_file, topo


def solar_temporal(device, lr_shape=(1, 4, 4, 3, 3), hr_shape=(1, 4, 4, 24, 1),
                   optimizer=None):
    """The temporal member: ``SolarCC`` on ``sup3rcc/gen_solar_1x_8x_1f``
    (64 filters, 16 residual blocks, 64 x 8 channels before
    ``depth_to_time``) with ``spatiotemporal/disc_test``, from seed 0, its
    tail conv scaled by ``SOLAR_TAIL_SCALE``."""
    model = SolarCC(
        get_config('sup3rcc/gen_solar_1x_8x_1f'),
        get_config('spatiotemporal/disc_test'), optimizer=optimizer,
        learning_rate=TRAIN_LR_RATE,
        meta={'lr_features': list(SOLAR_T_FEATURES),
              'hr_out_features': ['clearsky_ratio'], 's_enhance': 1,
              't_enhance': 8,
              'input_resolution': {'spatial': '4km', 'temporal': '1440min'}},
        means={f: SOLAR_MEANS[f] for f in SOLAR_T_FEATURES},
        stdevs={f: SOLAR_STDEVS[f] for f in SOLAR_T_FEATURES}, device=device)
    model.init_weights(lr_shape, hr_shape, seed=0)
    tail = [lyr for lyr in model._gen.layers if hasattr(lyr, 'weight')][-1]
    with torch.no_grad():
        for p in tail.parameters():
            p.mul_(SOLAR_TAIL_SCALE)
    return model


def solar_members(tmp):
    """Saves the three groups at full width from seed 0: phase 10's
    spatial wind member, ``generator_cc_spatial(1, 5,
    with_topography=False)`` for clearsky_ratio and the temporal SolarCC;
    returns their directories."""
    wind, _ = chain_members('cuda')
    solar = Sup3rGan(
        generator_cc_spatial(1, 5, with_topography=False),
        [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}],
        meta={'lr_features': ['clearsky_ratio'],
              'hr_out_features': ['clearsky_ratio'], 's_enhance': 5,
              't_enhance': 1,
              'input_resolution': {'spatial': '100km', 'temporal': '1440min'}},
        means={'clearsky_ratio': SOLAR_MEANS['clearsky_ratio']},
        stdevs={'clearsky_ratio': SOLAR_STDEVS['clearsky_ratio']},
        device='cuda')
    solar.init_weights((1, 4, 4, 1), (1, 20, 20, 1), seed=0)
    dirs = {}
    for name, model in (('spatial_solar', solar), ('spatial_wind', wind),
                        ('temporal_solar', solar_temporal('cuda'))):
        dirs[name] = [os.path.join(tmp, name)]
        model.save(dirs[name][0])
    return dirs


def solar_strategy(input_file, dirs, topo, out_pattern, device='cuda',
                   **kwargs):
    """The solar chain's strategy (``SolarMultiStepGan`` with the serving
    ``t_enhance`` of 24); its topography cache beside the source."""
    kw = dict(file_paths=input_file, model_class='SolarMultiStepGan',
              model_kwargs={
                  **{f'{k}_model_dirs': v for k, v in dirs.items()},
                  't_enhance': 24, 'device': device},
              fwp_chunk_shape=CHAIN_CHUNK, spatial_pad=CHAIN_S_PAD,
              temporal_pad=CHAIN_T_PAD,
              exo_handler_kwargs={'topography': {
                  'source_file': topo, 'cache_dir': os.path.join(
                      os.path.dirname(topo), 'exo_cache')}},
              out_pattern=out_pattern)
    kw.update(kwargs)
    return ForwardPassStrategy(**kw)


def set_route(chain, pallas):
    for m in chain.all_models:
        m.inference_pallas = pallas


def solar_step_grads(model, lr, hr, step):
    """Both losses' gradients at one batch, computed as
    ``SolarCC._train_step`` computes them at step ``step`` (the same
    window draws), in the model's dtype."""
    dtype = model.gen_params[0].dtype
    lr = torch.as_tensor(lr, dtype=dtype, device=model.device)
    hr = torch.as_tensor(hr, dtype=dtype, device=model.device)
    model._step_counter = step
    n_days = hr.shape[3] // 24
    with exact_fp32():
        out = model._train_gen_net().apply(lr, {})
        starts = model.draw_window_starts(n_days, out.shape[3],
                                          model._window_generator(0))
        d_true = model._disc.apply(model.true_windows(hr))
        d_gen = model._disc.apply(model.gen_windows(out, starts))
        gen_loss = (model.content_loss(out, hr)
                    + W_ADV * relativistic_disc_loss(d_gen, d_true))
        disc_starts = model.draw_window_starts(n_days, out.shape[3],
                                               model._window_generator(1))
        disc_loss = relativistic_disc_loss(d_true, model._disc.apply(
            model.gen_windows(out.detach(), disc_starts)))
        return (torch.autograd.grad(gen_loss, model.gen_params),
                torch.autograd.grad(disc_loss, model.disc_params))


def solar_train_check():
    """Phase 11f: ``step_check`` of one full-width SolarCC step at batch 2
    on a 12 x 12 grid (the card and the CPU draw the same windows: both
    are at step 1)."""
    s1, s2 = SOLAR_CHECK_GRID
    rng = np.random.default_rng(2)
    lr = rng.random((2, s1, s2) + SOLAR_TRAIN_LR[2:]).astype(np.float32)
    hr = rng.random((2, s1, s2) + SOLAR_TRAIN_HR[2:]).astype(np.float32)
    shapes = ((1, s1, s2) + SOLAR_TRAIN_LR[2:],
              (1, s1, s2) + SOLAR_TRAIN_HR[2:])
    return step_check(
        'solar_cc_train_check',
        lambda d: solar_temporal(d, *shapes, optimizer=CHECK_OPT), lr, hr,
        lambda m, a, b: solar_step_grads(m, a, b, 1), batch=2,
        lr_shape=list(shapes[0][1:]), hr_shape=list(shapes[1][1:]))


def solar_train_step(name):
    """Phase 11g: the SolarCC training cell, timed: median step ms over 12
    steps after 3 warm-ups (host clock, loss fetch included), launches per
    step (none: both tails have ci * co = 64), the step's peak memory
    above what was allocated before, and one profiled step."""
    model = solar_temporal('cuda', (1,) + SOLAR_TRAIN_LR,
                           (1,) + SOLAR_TRAIN_HR)
    rng = np.random.default_rng(1)
    lr = torch.as_tensor(rng.random((SOLAR_TRAIN_BATCH,) + SOLAR_TRAIN_LR),
                         dtype=torch.float32, device='cuda')
    hr = torch.as_tensor(rng.random((SOLAR_TRAIN_BATCH,) + SOLAR_TRAIN_HR),
                         dtype=torch.float32, device='cuda')
    for _ in range(N_WARM_STEPS):
        model.run_gradient_descent(lr, hr, W_ADV, True, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    times, losses = [], None
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses = model.run_gradient_descent(lr, hr, W_ADV, True, True)
        times.append(1e3 * (time.perf_counter() - t0))
    per_step = {k: v / N_TRAIN_STEPS for k, v in launch_counts().items()}
    wgrad = wgrad_gated() / N_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(times))
    profile_rec = train_profile(model, lr, hr)
    ok = (per_step == {'small_reflect_conv': 0, 'reflect_conv': 0,
                       'reflect_conv_wgrad': wgrad}
          and all(np.isfinite(v) for v in losses.values()))
    emit(phase='solar_cc_train_step', model='sup3rcc/gen_solar_1x_8x_1f',
         disc='spatiotemporal/disc_test', batch=SOLAR_TRAIN_BATCH,
         lr_shape=list(SOLAR_TRAIN_LR), hr_shape=list(SOLAR_TRAIN_HR),
         steps=N_TRAIN_STEPS, step_ms=times, median_step_ms=median,
         hr_voxels_per_s=SOLAR_TRAIN_BATCH * int(np.prod(SOLAR_TRAIN_HR[:3]))
         / (median / 1e3), launches_per_step=per_step, losses=losses,
         peak_device_gb=peak / 1e9, step_peak_gb=(peak - before) / 1e9,
         nvidia_smi=name, ok=ok, **profile_rec)
    if not ok:
        raise AssertionError(f'SolarCC step: launches per step {per_step}; '
                             f'losses {losses}')
    return median, per_step


def nsrdb_nc(path, shape, seed):
    """A NetCDF3 file of hourly ghi and clearsky_ghi: a clear-sky diurnal
    cycle (zero at night, so the hourly clearsky_ratio is NaN there) and
    ghi a random fraction of it."""
    s1, s2, t = shape
    rng = np.random.default_rng(seed)
    hours = np.arange(t) % 24
    cs = np.clip(np.sin(np.pi * (hours - 6) / 12), 0, None) * 1000
    cs = np.broadcast_to(cs[:, None, None], (t, s1, s2)) * (
        0.9 + 0.1 * rng.random((1, s1, s2)))
    ghi = cs * (0.2 + 0.8 * rng.random((t, s1, s2)))
    return make_fake_nc_file(path, shape, ['ghi', 'clearsky_ghi'],
                             start='2023-06-01', lat_range=CHAIN_LAT,
                             lon_range=CHAIN_LON,
                             data={'ghi': ghi, 'clearsky_ghi': cs})


def solar_train_loop(step_ms):
    """Phase 11h: ``SolarCC.train`` over a ``BatchHandlerCC`` of
    ``DataHandlerH5SolarCC`` data from NetCDF3 files (ghi and clearsky_ghi
    as LR-only features): 2 epochs of 4 batches of 8, validation, the
    last checkpoint reloaded with the serving ``t_enhance`` of 24."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_solar_train_')
    try:
        feats = ['clearsky_ratio', 'ghi', 'clearsky_ghi']
        train = DataHandlerH5SolarCC(nsrdb_nc(
            os.path.join(tmp, 'nsrdb_train.nc'), (40, 40, 24 * 20), 3),
            features=feats)
        val = DataHandlerH5SolarCC(nsrdb_nc(
            os.path.join(tmp, 'nsrdb_val.nc'), (24, 24, 24 * 12), 4),
            features=feats)
        handler = BatchHandlerCC(
            [train], [val], batch_size=SOLAR_TRAIN_BATCH, n_batches=4,
            s_enhance=1, t_enhance=8, sample_shape=SOLAR_TRAIN_HR[:3],
            feature_sets={'lr_only_features': ['ghi', 'clearsky_ghi']})
        model = solar_temporal('cuda', (1,) + SOLAR_TRAIN_LR,
                               (1,) + SOLAR_TRAIN_HR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train(handler, input_resolution={'spatial': '4km',
                                               'temporal': '1440min'},
                    n_epoch=2, weight_gen_advers=W_ADV,
                    out_dir=os.path.join(tmp, 'scc_{epoch}'))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.calc_val_loss(handler, W_ADV)
        val_s = time.perf_counter() - t0
        handler.stop()
        history = model.history
        loaded = SolarCC.load(os.path.join(tmp, 'scc_1'), t_enhance=24)
        lr = np.random.default_rng(3).random(
            (1, 20, 20, 3, 3)).astype(np.float32)
        out = loaded.generate(lr)
        ok = (len(history) == 2
              and all(c in history and np.isfinite(history[c]).all()
                      for c in ('train_loss_gen', 'train_loss_disc',
                                'val_loss_gen', 'val_loss_disc'))
              and handler.lr_shape == SOLAR_TRAIN_LR
              and handler.hr_shape == SOLAR_TRAIN_HR
              and loaded.meta['class'] == 'SolarCC'
              and out.shape == (1, 20, 20, 72, 1)
              and bool(np.isfinite(out).all()))
        epoch_s = np.diff([0.0] + list(history['elapsed_time']))
        emit(phase='solar_cc_train_loop', epochs=2, batches_per_epoch=4,
             batch=SOLAR_TRAIN_BATCH, lr_shape=list(handler.lr_shape),
             hr_shape=list(handler.hr_shape), wall_s=wall_s,
             epoch_s=list(epoch_s), validation_s_per_epoch=val_s,
             s_per_batch=float(np.mean(epoch_s - val_s)) / 4,
             bare_step_s=step_ms / 1e3,
             starvation_rate=handler._queue.starvation_rate,
             history={c: list(history[c]) for c in history.columns},
             reloaded_generate_shape=list(out.shape), ok=ok)
        if not ok:
            raise AssertionError('SolarCC train loop: history, shapes, '
                                 'reload or generate failed')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def solar_phase(name):
    """Phase 11: the Sup3rCC solar chain through the chunked ForwardPass
    on both routes, then SolarCC training; returns the wrappers' launch
    counts of each route's last pass, the block calls of the last opt-in
    pass by (rank, input shape, co, alpha), and the launches per SolarCC
    step."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_solar_')
    try:
        input_file, topo = solar_inputs(tmp)
        dirs = solar_members(tmp)
        strategy = solar_strategy(input_file, dirs, topo, None)
        chain = strategy.get_model()
        n_chunks = strategy.fwp_slicer.n_chunks
        # launches per chunk on the opt-in route, counted from the fused
        # networks of all three groups: every fused block the small
        # kernel does not take
        blocks = [lyr.n_spatial for m in chain.all_models
                  for lyr in m._get_fused_apply().layers
                  if isinstance(lyr, FusedReflectConv)
                  and not takes_small(lyr)]
        per_chunk = {'2d': blocks.count(2), '3d': blocks.count(3)}
        want = {'default': dict.fromkeys(
                    ('small_reflect_conv', 'reflect_conv', 'reflect_conv_2d',
                     'reflect_conv_3d'), 0),
                'opt_in': {'small_reflect_conv': 0,
                           'reflect_conv': n_chunks * len(blocks),
                           'reflect_conv_2d': n_chunks * per_chunk['2d'],
                           'reflect_conv_3d': n_chunks * per_chunk['3d']}}
        want_calls = Counter({(2, x, co, a): k * n_chunks
                              for x, co, a, k in CHAIN_2D_SHAPES})
        for x, co, a, k in SOLAR_2D_SHAPES:
            want_calls[(2, x, co, a)] += k * n_chunks
        for x, co, a, k in SOLAR_3D_SHAPES:
            want_calls[(3, x, co, a)] += k * n_chunks
        emit(phase='solar_chain_setup', chunks=n_chunks,
             padded_lr_chunk=[c + 2 * p for c, p in zip(
                 CHAIN_CHUNK, (CHAIN_S_PAD, CHAIN_S_PAD, CHAIN_T_PAD))],
             members={k: [type(m).__name__ for m in g.models]
                      for k, g in zip(dirs, chain.groups)},
             t_enhance=chain.t_enhance, s_enhance=chain.s_enhance,
             blocks_per_chunk=per_chunk)
        ChainForwardPass.run(solar_strategy(
            input_file, dirs, topo,
            os.path.join(tmp, 'warm', 'chunk_{file_id}.nc')), 0)
        shutil.rmtree(os.path.join(tmp, 'warm'))
        walls, outs, launches = {}, {}, {}
        calls = []
        for route, pallas in (('default', False), ('opt_in', True)):
            set_route(chain, pallas)
            walls[route] = []
            for i in range(N_CHAIN_PASSES):
                hooked, remove = (chain_fused_calls(chain.all_models)
                                  if pallas and i == N_CHAIN_PASSES - 1
                                  else ([], lambda: None))
                try:
                    wall, outs[route], launches[route] = chain_pass(
                        lambda out: solar_strategy(input_file, dirs, topo,
                                                   out),
                        os.path.join(tmp, f'{route}_{i}'), route, i,
                        want[route], features=['clearsky_ratio'],
                        phase='solar_chain_pass')
                finally:
                    remove()
                calls = hooked or calls
                walls[route].append(wall)
            emit(phase='solar_chain_route', route=route, wall_s=walls[route],
                 hr_voxels_per_s=int(np.prod(CHAIN_DOMAIN)) * 25 * 24
                 / float(np.median(walls[route])), nvidia_smi=name)
            fwp_profiled_pass(
                lambda out: solar_strategy(input_file, dirs, topo, out),
                os.path.join(tmp, f'{route}_profiled'), route,
                phase='solar_chain_profile')
        set_route(chain, False)
        got_calls = Counter(calls)
        ok = (got_calls == want_calls
              and sum(n for k, n in got_calls.items() if k[0] == 2)
              == launches['opt_in']['reflect_conv_2d']
              and sum(n for k, n in got_calls.items() if k[0] == 3)
              == launches['opt_in']['reflect_conv_3d'])
        emit(phase='solar_chain_blocks', per_chunk=per_chunk,
             calls_by_shape=[[rank, list(x), co, a, n] for
                             (rank, x, co, a), n in got_calls.items()],
             launches=launches['opt_in'], ok=ok)
        if not ok:
            raise AssertionError(
                f'solar chain blocks: calls {dict(got_calls)} (expected '
                f'{dict(want_calls)}), launches {launches["opt_in"]}')
        errs, tols, ok = feature_errs(outs['opt_in'], outs['default'])
        emit(phase='solar_chain_routes_agree', features=['clearsky_ratio'],
             max_abs_err=errs, tol=tols, ok=ok)
        if not ok:
            raise AssertionError(f'solar chain: routes differ by {errs} > '
                                 f'{tols}')
        os.makedirs(os.path.join(tmp, 'small'))
        chain_cpu_check(
            lambda small, topo, out, **kw: solar_strategy(
                small, dirs, topo, out, **kw),
            *solar_inputs(os.path.join(tmp, 'small'), (4, 4, 2), seed=1),
            lambda chain: chain.all_models, features=['clearsky_ratio'],
            phase='solar_chain_cpu_check')
        del chain, strategy
        check_err = solar_train_check()
        step_ms, per_step = solar_train_step(name)
        solar_train_loop(step_ms)
        return launches, got_calls, per_step, check_err
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 12, the Sup3rCC trh chain: phase 10's domain, chunks and pads with
#: temperature and relative humidity (their stats and the LR data as the
#: wind chain's, so the random chain's output stays inside both features'
#: limits), a smooth topography (a mountain range's relief: the lapse
#: rate and the RH regression then move the fields by O(1) of their
#: stats)
TRH_FEATURES = ['temperature_2m', 'relativehumidity_2m']
TRH_MEANS = {f: CHAIN_MEANS[f] for f in TRH_FEATURES}
TRH_STDEVS = {f: CHAIN_STDEVS[f] for f in TRH_FEATURES}
#: the temporal member's 3D blocks in one chunk on the opt-in route (input
#: shape, co, alpha, launches per chunk): 2 input channels at t = 6, the
#: body, the 64 -> 768 block before ``depth_to_time`` and the narrow 32 ->
#: 2 tail at t = 144 (ci * co = 64, so not the small kernel's)
TRH_3D_SHAPES = (((1, 2, 70, 70, 6), 64, 0.2, 1),
                 ((1, 64, 70, 70, 6), 64, 0.2, 17),
                 ((1, 64, 70, 70, 6), 64, None, 16),
                 ((1, 64, 70, 70, 6), 768, 0.2, 1),
                 ((1, 32, 70, 70, 144), 2, None, 1))
#: the shapes no earlier phase gives ``reflect_conv``, held to the plain
#: version and timed for the kernels line
TRH_NEW_SHAPES = (TRH_3D_SHAPES[0], TRH_3D_SHAPES[4])
#: the WithObs cell: two ``Sup3rConcatObs`` before the flagship's tail make
#: it 12 -> 2 (``small_reflect_conv`` at a new input width)
OBS_FEATURES = ['u_100m', 'v_100m']
OBS_FRAC = {'spatial_frac': [0.2, 0.4]}
OBS_TAIL_SHAPE = (TRAIN_BATCH, 12) + TRAIN_HR[:3]
#: the DC cell: fake hourly u/v train and val sets, 4 x 2 bins, 2 epochs
DC_DATA = (72, 72, 240)
DC_BINS = (4, 2)


def trh_inputs(tmp, domain=CHAIN_DOMAIN, seed=0):
    """A daily NetCDF3 input of ``domain`` low-res cells of temperature and
    relative humidity, and a smooth NetCDF3 topography over the same
    extent on a grid finer than the HR grid."""
    rng = np.random.default_rng(seed)
    s1, s2, t = domain
    data = {f: rng.standard_normal((t, s1, s2)) * TRH_STDEVS[f]
            + TRH_MEANS[f] for f in TRH_FEATURES}
    input_file = make_fake_nc_file(
        os.path.join(tmp, f'trh_daily_{s1}x{s2}x{t}.nc'), domain,
        TRH_FEATURES, freq='D', lat_range=CHAIN_LAT, lon_range=CHAIN_LON,
        data=data)
    yy, xx = np.meshgrid(*(np.linspace(0, 1, n) for n in CHAIN_TOPO_GRID),
                         indexing='ij')
    relief = 800 + 300 * np.sin(2 * np.pi * (xx + 2 * yy)) * np.cos(
        np.pi * xx)
    topo = make_fake_topo_nc_file(
        os.path.join(tmp, 'trh_topography.nc'), CHAIN_TOPO_GRID,
        lat_range=(CHAIN_LAT[0] + 0.05, CHAIN_LAT[1] - 0.05),
        lon_range=(CHAIN_LON[0] - 0.05, CHAIN_LON[1] + 0.05), data=relief)
    return input_file, topo


def trh_members(tmp):
    """Saves the trh chain at full width from seed 0: the physics
    ``SurfaceSpatialMetModel`` (5x) and ``sup3rcc/gen_trh_1x_24x_2f`` (64
    filters, 16 residual blocks, 32 x 24 channels before
    ``depth_to_time``, ``t_roll`` 12); returns the strategy's
    ``model_kwargs`` without the device."""
    surface_dir = os.path.join(tmp, 'trh_surface')
    temporal_dir = os.path.join(tmp, 'trh_temporal')
    SurfaceSpatialMetModel(TRH_FEATURES, s_enhance=5,
                           device='cuda').save(surface_dir)
    temporal = Sup3rGan(
        get_config('sup3rcc/gen_trh_1x_24x_2f'),
        [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}],
        meta={'lr_features': list(TRH_FEATURES),
              'hr_out_features': list(TRH_FEATURES), 's_enhance': 1,
              't_enhance': 24,
              'input_resolution': {'spatial': '4km', 'temporal': '1440min'}},
        means=TRH_MEANS, stdevs=TRH_STDEVS, device='cuda')
    temporal.init_weights((1, 4, 4, 2, 2), (1, 4, 4, 48, 2), seed=0)
    temporal.save(temporal_dir)
    return {'surface_model_kwargs': {'model_dir': surface_dir},
            'temporal_model_kwargs': {'model_dirs': [temporal_dir]}}


def trh_strategy(input_file, model_kwargs, topo, out_pattern, device='cuda',
                 **kwargs):
    """The trh chain's strategy; its topography cache beside the source."""
    kw = dict(file_paths=input_file, model_class='MultiStepSurfaceMetGan',
              model_kwargs={**model_kwargs, 'device': device},
              fwp_chunk_shape=CHAIN_CHUNK, spatial_pad=CHAIN_S_PAD,
              temporal_pad=CHAIN_T_PAD,
              exo_handler_kwargs={'topography': {
                  'source_file': topo, 'cache_dir': os.path.join(
                      os.path.dirname(topo), 'exo_cache')}},
              out_pattern=out_pattern)
    kw.update(kwargs)
    return ForwardPassStrategy(**kw)


def surface_check(strategy, input_file):
    """The card's surface step on the whole low-res domain against its
    float64 version on the CPU (1e-5 of each field's largest magnitude),
    and its device ms on one padded chunk (CUDA events)."""
    surface = strategy.get_model().models[0]
    data = LoaderNC(input_file).data
    lr = np.stack([data[f] for f in TRH_FEATURES], -1).transpose(2, 0, 1, 3)
    exo = strategy.exo_data.get_model_step_exo(0)
    got = surface.generate(lr, exogenous_data=exo)
    ref = SurfaceSpatialMetModel.load(
        strategy.model_kwargs['surface_model_kwargs']['model_dir'],
        device='cpu')
    ref.dtype = torch.float64
    want = ref.generate(lr, exogenous_data=exo, fetch=False).numpy()
    errs = np.abs(got - want).reshape(-1, 2).max(axis=0)
    tols = KERNEL_RTOL * np.abs(want).reshape(-1, 2).max(axis=0)
    ok = bool(np.isfinite(got).all() and (errs <= tols).all())
    pad = [c + 2 * p for c, p in zip(CHAIN_CHUNK, (CHAIN_S_PAD, CHAIN_S_PAD,
                                                   CHAIN_T_PAD))]
    chunk = torch.as_tensor(lr[:pad[2], :pad[0], :pad[1]], device='cuda')
    steps = [dict(s) for s in exo['topography']['steps']]
    steps[0]['data'] = steps[0]['data'][:pad[0], :pad[1]]
    steps[1]['data'] = steps[1]['data'][:pad[0] * 5, :pad[1] * 5]
    chunk_exo = {'topography': {'steps': steps}}
    chunk_ms = cuda_ms(lambda: surface.generate(
        chunk, exogenous_data=chunk_exo, fetch=False), 20)
    emit(phase='trh_surface_check', lr_shape=list(lr.shape),
         hr_shape=list(got.shape), features=TRH_FEATURES,
         max_abs_err_vs_float64=errs.tolist(), tol=tols.tolist(),
         padded_chunk=list(chunk.shape), chunk_device_ms=chunk_ms, ok=ok)
    if not ok:
        raise AssertionError(f'surface step vs float64: {errs} > {tols}')


def trh_phase(name):
    """Phase 12a: the Sup3rCC trh chain through the chunked ForwardPass on
    both routes; returns the wrappers' launch counts of each route's last
    pass and the temporal member's block calls of the last opt-in pass by
    (input shape, co, alpha)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_trh_')
    try:
        input_file, topo = trh_inputs(tmp)
        model_kwargs = trh_members(tmp)

        def make(out, **kw):
            return trh_strategy(input_file, model_kwargs, topo, out, **kw)

        strategy = make(None)
        chain = strategy.get_model()
        temporal = chain.models[1:]
        n_chunks = strategy.fwp_slicer.n_chunks
        blocks = [lyr.n_spatial for m in temporal
                  for lyr in m._get_fused_apply().layers
                  if isinstance(lyr, FusedReflectConv)
                  and not takes_small(lyr)]
        per_chunk = {'2d': blocks.count(2), '3d': blocks.count(3)}
        want = {'default': dict.fromkeys(
                    ('small_reflect_conv', 'reflect_conv', 'reflect_conv_2d',
                     'reflect_conv_3d'), 0),
                'opt_in': {'small_reflect_conv': 0,
                           'reflect_conv': n_chunks * len(blocks),
                           'reflect_conv_2d': n_chunks * per_chunk['2d'],
                           'reflect_conv_3d': n_chunks * per_chunk['3d']}}
        want_calls = Counter({(x, co, a): k * n_chunks
                              for x, co, a, k in TRH_3D_SHAPES})
        steps = strategy.exo_data['topography']['steps']
        emit(phase='trh_chain_setup', chunks=n_chunks,
             members=[type(m).__name__ for m in chain.models],
             s_enhance=chain.s_enhance, t_enhance=chain.t_enhance,
             exo_steps=[{k: v for k, v in s.items() if k != 'data'}
                        | {'shape': list(s['data'].shape)} for s in steps],
             blocks_per_chunk=per_chunk)
        surface_check(strategy, input_file)
        ChainForwardPass.run(make(os.path.join(tmp, 'warm',
                                               'chunk_{file_id}.nc')), 0)
        shutil.rmtree(os.path.join(tmp, 'warm'))
        walls, outs, launches, calls = {}, {}, {}, []
        for route, pallas in (('default', False), ('opt_in', True)):
            for m in temporal:
                m.inference_pallas = pallas
            walls[route] = []
            for i in range(N_CHAIN_PASSES):
                hooked, remove = (chain_fused_calls(temporal)
                                  if pallas and i == N_CHAIN_PASSES - 1
                                  else ([], lambda: None))
                try:
                    wall, outs[route], launches[route] = chain_pass(
                        make, os.path.join(tmp, f'{route}_{i}'), route, i,
                        want[route], features=TRH_FEATURES,
                        phase='trh_chain_pass')
                finally:
                    remove()
                calls = hooked or calls
                walls[route].append(wall)
            emit(phase='trh_chain_route', route=route, wall_s=walls[route],
                 median_s=float(np.median(walls[route])),
                 hr_voxels_per_s=int(np.prod(CHAIN_DOMAIN)) * 25 * 24
                 / float(np.median(walls[route])), nvidia_smi=name)
            fwp_profiled_pass(make, os.path.join(tmp, f'{route}_profiled'),
                              route, phase='trh_chain_profile')
        for m in temporal:
            m.inference_pallas = False
        got_calls = Counter((x, co, a) for _, x, co, a in calls)
        ok = (got_calls == want_calls and all(c[0] == 3 for c in calls)
              and len(calls) == launches['opt_in']['reflect_conv_3d'])
        emit(phase='trh_chain_blocks', per_chunk=per_chunk,
             calls_by_shape=[[list(x), co, a, n]
                             for (x, co, a), n in got_calls.items()],
             launches=launches['opt_in'], ok=ok)
        if not ok:
            raise AssertionError(
                f'trh chain blocks: calls {dict(got_calls)} (expected '
                f'{dict(want_calls)}), launches {launches["opt_in"]}')
        errs, tols, ok = feature_errs(outs['opt_in'], outs['default'])
        emit(phase='trh_chain_routes_agree', features=TRH_FEATURES,
             max_abs_err=errs, tol=tols, ok=ok)
        if not ok:
            raise AssertionError(f'trh chain: routes differ by {errs} > '
                                 f'{tols}')
        os.makedirs(os.path.join(tmp, 'small'))
        chain_cpu_check(
            lambda small, topo, out, **kw: trh_strategy(
                small, model_kwargs, topo, out, **kw),
            *trh_inputs(os.path.join(tmp, 'small'), (4, 4, 2), seed=1),
            lambda chain: chain.models[1:], features=TRH_FEATURES,
            phase='trh_chain_cpu_check')
        return launches, got_calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def with_obs_gen():
    """The flagship with ``Sup3rConcatObs`` for u and v after its last
    LeakyReLU, before its tail conv (tests/training/test_model_family.py's
    placement): the tail takes 8 + 2 x 2 = 12 channels."""
    layers = list(get_config('spatiotemporal/gen_3x_4x_2f')['hidden_layers'])
    last = max(i for i, lyr in enumerate(layers)
               if lyr.get('class') == 'LeakyReLU')
    obs = [{'class': 'Sup3rConcatObs', 'name': f'{f}_obs'}
           for f in OBS_FEATURES]
    return {'hidden_layers': layers[:last + 1] + obs + layers[last + 1:]}


def obs_model(device, optimizer=None):
    """The WithObs cell's model from seed 0: the flagship with the
    observation layers, ``spatiotemporal/disc_test``, Adam lr 1e-4, the
    observed fraction drawn in [0.2, 0.4], obs loss weight 0.5."""
    model = Sup3rGanWithObs(
        with_obs_gen(), get_config('spatiotemporal/disc_test'),
        optimizer=optimizer, learning_rate=TRAIN_LR_RATE,
        onshore_obs_frac=OBS_FRAC, loss_obs_weight=0.5,
        meta={'lr_features': OBS_FEATURES, 'hr_out_features': OBS_FEATURES},
        device=device)
    model.init_weights((1,) + TRAIN_LR, (1,) + TRAIN_HR, seed=0)
    return model


def obs_step_grads(model, lr, hr):
    """Both losses' gradients of a WithObs model's first step (the mask of
    step 1), computed as ``Sup3rGan._train_step`` computes them, in the
    model's dtype."""
    dtype = model.gen_params[0].dtype
    lr = torch.as_tensor(lr, dtype=dtype, device=model.device)
    hr = torch.as_tensor(hr, dtype=dtype, device=model.device)
    exo, not_obs = model._obs_exo(hr, torch.Generator().manual_seed(1))
    with exact_fp32():
        out = model._train_gen_net().apply(lr, exo)
        d_true, d_gen = model._disc.apply(hr), model._disc.apply(out)
        extra, _ = model._extra_gen_loss(out, hr, not_obs)
        gen_loss = (model.loss_fun(out, hr) + extra
                    + W_ADV * relativistic_disc_loss(d_gen, d_true))
        disc_loss = relativistic_disc_loss(d_true, d_gen)
        return (torch.autograd.grad(gen_loss, model.gen_params,
                                    retain_graph=True),
                torch.autograd.grad(disc_loss, model.disc_params))


def obs_fwp_check(model, tmp):
    """A short ForwardPass of the WithObs model whose ``ObsRasterizer``
    reads a NetCDF3 gridded observation file that is NaN away from a few
    stations: rasters sparse, outputs finite and tiled, the tail on
    ``small_reflect_conv`` once per dispatch."""
    model_dir = os.path.join(tmp, 'obs_gan')
    model.set_norm_stats({f: 0.5 for f in OBS_FEATURES},
                         {f: 0.3 for f in OBS_FEATURES})
    model.save(model_dir)
    domain = (20, 20, 12)
    rng = np.random.default_rng(7)
    input_file = make_fake_nc_file(os.path.join(tmp, 'obs_in.nc'), domain,
                                   OBS_FEATURES, freq='4h',
                                   lat_range=CHAIN_LAT, lon_range=CHAIN_LON)
    hr = (60, 60, 48)
    stations = rng.random(hr[:2]) < 0.02
    obs = {f: np.where(stations[None], 0.5 + 0.3 * rng.standard_normal(
        (hr[2],) + hr[:2]), np.nan) for f in OBS_FEATURES}
    obs_file = make_fake_nc_file(os.path.join(tmp, 'stations.nc'), hr,
                                 OBS_FEATURES, lat_range=CHAIN_LAT,
                                 lon_range=CHAIN_LON, data=obs)
    zero_counts()
    strategy = ForwardPassStrategy(
        file_paths=input_file, model_class='Sup3rGanWithObs',
        model_kwargs={'model_dir': model_dir, 'device': 'cuda'},
        fwp_chunk_shape=(10, 10, 12), spatial_pad=2, temporal_pad=0,
        device_batch_size=4,
        exo_handler_kwargs={f'{f}_obs': {
            'source_file': obs_file,
            'cache_dir': os.path.join(tmp, 'obs_cache')}
            for f in OBS_FEATURES},
        out_pattern=None)
    outs = ChainForwardPass.run(strategy, 0)
    fwp = ChainForwardPass.last
    raster = strategy.exo_data['u_100m_obs']['steps'][0]['data']
    launches = launch_counts()
    observed = float(np.isfinite(raster).mean())
    ok = (len(outs) == 4 and all(np.isfinite(o).all() and o.shape == (
        30, 30, 48, 2) for o in outs.values()) and 0 < observed < 0.5
        and launches == {'small_reflect_conv': fwp.dispatches + fwp.chunk_runs,
                         'reflect_conv': gated(), 'reflect_conv_wgrad': 0})
    emit(phase='obs_forward_pass', chunks=len(outs),
         raster_shape=list(raster.shape), observed_share=observed,
         batched_dispatches=fwp.dispatches, chunk_runs=fwp.chunk_runs,
         launches=launches, ok=ok)
    if not ok:
        raise AssertionError(f'obs forward pass: {len(outs)} chunks, '
                             f'observed {observed}, launches {launches}')


def obs_phase(name, gen):
    """Phase 12b: ``Sup3rGanWithObs`` on the flagship (12 -> 2 tail):
    ``small_reflect_conv``'s gradients at ci 12, the card step against the
    CPU's, the timed and profiled cell, ``generate`` with observation
    rasters and a short ForwardPass with an ObsRasterizer. Returns the
    launches per step and the gradient check's largest error."""
    x, w, b = conv_inputs(gen, OBS_TAIL_SHAPE, 2)
    dy = torch.randn((TRAIN_BATCH, 2) + OBS_TAIL_SHAPE[2:], device='cuda',
                     generator=gen)
    grad_err = grad_check('small_reflect_conv', small_reflect_conv_cf, x, w,
                          b, None, dy)
    lr, hr = train_batch(CHECK_BATCH, seed=2)
    check_err = step_check('obs_train_check',
                           lambda d: obs_model(d, CHECK_OPT), lr, hr,
                           obs_step_grads, batch=CHECK_BATCH)
    model = obs_model('cuda')
    lr, hr, step_ms, per_step, memory = train_step_phase(
        name, model, phase='obs_train_step',
        label='spatiotemporal/gen_3x_4x_2f with Sup3rConcatObs (u, v)')
    losses = model.run_gradient_descent(lr, hr, W_ADV, True, True)
    emit(phase='obs_train_profile', obs_frac=losses['obs_frac'],
         loss_obs=losses['loss_obs'], loss_non_obs=losses['loss_non_obs'],
         **train_profile(model, lr, hr))
    ok = OBS_FRAC['spatial_frac'][0] - 0.05 <= losses['obs_frac'] <= (
        OBS_FRAC['spatial_frac'][1] + 0.05)
    rng = np.random.default_rng(3)
    low = rng.standard_normal((1,) + TRAIN_LR).astype(np.float32)
    rasters = {}
    for f in OBS_FEATURES:
        raster = rng.standard_normal((1,) + TRAIN_HR[:3] + (1,))
        raster[:, rng.random(TRAIN_HR[:2]) > 0.3] = np.nan
        rasters[f'{f}_obs'] = raster.astype(np.float32)
    zero_counts()
    out = model.generate(low, exogenous_data=rasters)
    launches = launch_counts()
    ok = (ok and out.shape == (1,) + TRAIN_HR and bool(np.isfinite(
        out).all()) and launches == {'small_reflect_conv': 1,
                                     'reflect_conv': gated(),
                                     'reflect_conv_wgrad': 0})
    emit(phase='obs_generate', hr_shape=list(out.shape), launches=launches,
         obs_frac=losses['obs_frac'], ok=ok)
    if not ok:
        raise AssertionError(f'WithObs: obs_frac {losses["obs_frac"]}, '
                             f'generate {out.shape}, launches {launches}')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_obs_')
    try:
        obs_fwp_check(model, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {'step_ms': step_ms, 'per_step': per_step, 'memory': memory,
            'grad_max_abs_err': grad_err, 'train_check_rel_err': check_err}


def dc_phase(name):
    """Phase 12c: ``Sup3rGanDC.train`` over a ``BatchHandlerDC`` of fake
    (72, 72, 240) u/v train and validation sets: the flagship with
    ``spatiotemporal/disc_test``, batch 16, 4 x 2 bins, 2 epochs of 4
    batches. Returns the launches per train step (validation apart)."""
    n_s, n_t = DC_BINS
    handler = BatchHandlerDC(
        [make_fake_dset(DC_DATA, OBS_FEATURES)],
        [make_fake_dset(DC_DATA, OBS_FEATURES)], batch_size=TRAIN_BATCH,
        n_batches=4, s_enhance=3, t_enhance=4, sample_shape=TRAIN_HR[:3],
        n_space_bins=n_s, n_time_bins=n_t)
    model = Sup3rGanDC(get_config('spatiotemporal/gen_3x_4x_2f'),
                       get_config('spatiotemporal/disc_test'),
                       learning_rate=TRAIN_LR_RATE, device='cuda')
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train(handler, input_resolution={'spatial': '3km',
                                           'temporal': '60min'},
                n_epoch=2, weight_gen_advers=W_ADV, out_dir=None)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    body, wgrad = gated(), wgrad_gated()
    # one more validation pass alone: its seconds come off each epoch's
    t0 = time.perf_counter()
    model.calc_val_loss(handler, W_ADV)
    val_s = time.perf_counter() - t0
    handler.stop()
    s_w = np.asarray(handler.spatial_weights)
    t_w = np.asarray(handler.temporal_weights)
    history = model.history
    # a tail launch per train batch and per validation batch (one per bin)
    n_val = n_s * n_t
    ok = (len(history) == 2 and np.isfinite(history['val_loss_gen']).all()
          and launches == {'small_reflect_conv': 2 * (4 + n_val),
                           'reflect_conv': body, 'reflect_conv_wgrad': wgrad}
          and abs(s_w.sum() - 1) < 1e-5 and abs(t_w.sum() - 1) < 1e-5
          and (s_w >= 0).all() and (t_w >= 0).all()
          and not np.allclose(s_w, 1 / n_s) and not np.allclose(t_w, 1 / n_t))
    epoch_s = np.diff([0.0] + list(history['elapsed_time']))
    emit(phase='dc_train_loop', epochs=2, batches_per_epoch=4,
         val_batches_per_epoch=n_val, batch=TRAIN_BATCH, bins=list(DC_BINS),
         wall_s=wall_s, epoch_s=list(epoch_s), validation_s_per_epoch=val_s,
         s_per_batch=float(np.mean(epoch_s - val_s)) / 4,
         starvation_rate=handler._queue.starvation_rate,
         val_starvation_rate=handler.val_data.starvation_rate,
         spatial_weights=s_w.tolist(), temporal_weights=t_w.tolist(),
         history={c: list(history[c]) for c in history.columns},
         launches=launches, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'DC loop: weights {s_w} / {t_w}, launches '
                             f'{launches}, history {len(history)}')
    # the validation batches' launches come off: per train step
    return {k: (v - 2 * n_val * (k == 'small_reflect_conv')) / 8
            for k, v in launches.items()}

#: phase 13: the conditional-moment family. The Mom1 cell is phase 7's
#: batch with a mask of s_padding 1, t_padding 1 (the target is the HR
#: batch); the loops run over fake (72, 72, 240) u/v data
COND_PADDING = {'s_padding': 1, 't_padding': 1}
COND_DATA = (72, 72, 240)


def cond_mom_model(device, optimizer=None):
    """The full-width flagship generator as a ``Sup3rCondMom``,
    initialized for the training cell from seed 0."""
    model = Sup3rCondMom(get_config('spatiotemporal/gen_3x_4x_2f'),
                         optimizer=optimizer, learning_rate=TRAIN_LR_RATE,
                         device=device)
    model.init_weights((1,) + TRAIN_LR, seed=0)
    return model


def cond_batch(n, seed=1):
    """Phase 7's batch as a Mom1 ``ConditionalBatch``: the target is the
    HR batch, the mask zero on the padding."""
    lr, hr = train_batch(n, seed)
    mask = np.zeros_like(hr)
    mask[:, 1:-1, 1:-1, 1:-1] = 1.0
    return ConditionalBatch(lr, hr, hr, mask)


def cond_handler(cls, **kwargs):
    """A conditional handler over fake u/v train and validation data: 4
    batches of 16 per epoch, phase 7's shapes."""
    return cls([make_fake_dset(COND_DATA, FWP_FEATURES)],
               [make_fake_dset((72, 72, 96), FWP_FEATURES)],
               batch_size=TRAIN_BATCH, n_batches=4, s_enhance=3,
               t_enhance=4, sample_shape=TRAIN_HR[:3],
               queue_kwargs={**COND_PADDING, **kwargs})


def cond_grads(model, batch):
    """The masked loss's gradients at one batch, computed as
    ``Sup3rCondMom._train_step`` computes them, in the model's dtype."""
    dtype = model.gen_params[0].dtype
    lr, _, target, mask = (torch.as_tensor(a, dtype=dtype,
                                           device=model.device)
                           for a in batch)
    with exact_fp32():
        out = model._train_gen_net().apply(lr, {})
        loss = model.loss_fun(out * mask, target * mask)
        return torch.autograd.grad(loss, model.gen_params)


def cond_step_check():
    """Phase 13a: one Mom1 step at batch 2 on the card against the port's
    CPU step from the same weights and batch (Adam epsilon 1): the loss
    within 1e-4; the weights and mu within 1e-4 of each tensor's largest
    magnitude, or within the step's fp32 conditioning where that is
    wider, nu within twice that (quadratic in the gradient). The
    conditioning is measured as ``step_check`` measures it: both
    devices' gradients (mu / 0.1 after one step) against a float64 step
    on the card, the card's within 2x the CPU's (or 1e-4)."""
    batch = cond_batch(CHECK_BATCH, seed=2)
    ref = cond_mom_model('cuda')
    ref._gen.double()
    exact = cond_grads(ref, batch)
    del ref
    card, cpu = (cond_mom_model(d, CHECK_OPT) for d in ('cuda', 'cpu'))
    got, want = (m.run_gradient_descent(batch) for m in (card, cpu))
    e_cpu, e_card = (rel_err([mu / 0.1 for mu in m._gen_opt_state['mu']],
                             exact) for m in (cpu, card))
    tol = max(PARITY_RTOL, 2 * (e_cpu + e_card))
    errs = {'loss_gen': abs(got['loss_gen'] - want['loss_gen'])
            / abs(want['loss_gen'])}
    errs['param'] = rel_err(list(card._gen.parameters()),
                            list(cpu._gen.parameters()))
    for key in ('mu', 'nu'):
        errs[key] = rel_err(card._gen_opt_state[key],
                            cpu._gen_opt_state[key])
    ok = bool(errs['loss_gen'] <= PARITY_RTOL
              and e_card <= max(PARITY_RTOL, 2 * e_cpu)
              and errs['param'] <= tol and errs['mu'] <= tol
              and errs['nu'] <= 2 * tol)
    emit(phase='cond_mom_train_check', batch=CHECK_BATCH, losses_card=got,
         rel_err=errs, loss_tol=PARITY_RTOL, tol=tol,
         fp32_conditioning={'cpu_vs_float64': e_cpu,
                            'card_vs_float64': e_card}, ok=ok)
    if not ok:
        raise AssertionError(f'cond mom step: card vs CPU {errs}')
    return max(errs.values())


def cond_step_cell(name):
    """Phase 13b: the Mom1 training cell, timed (median of 12 steps after
    3 warm-ups, host clock, loss fetch included), its launches, the
    step's peak memory and one profiled step."""
    model = cond_mom_model('cuda')
    batch = ConditionalBatch(*[torch.as_tensor(a, device='cuda')
                               for a in cond_batch(TRAIN_BATCH)])
    for _ in range(N_WARM_STEPS):
        model.run_gradient_descent(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    times = []
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses = model.run_gradient_descent(batch)
        times.append(1e3 * (time.perf_counter() - t0))
    per_step = {k: v / N_TRAIN_STEPS for k, v in launch_counts().items()}
    wgrad = wgrad_gated() / N_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(times))
    prof = train_profile(model, None, None,
                         step=lambda: model.run_gradient_descent(batch))
    ok = bool(per_step == {'small_reflect_conv': 1, 'reflect_conv': 0,
                           'reflect_conv_wgrad': wgrad}
              and np.isfinite(losses['loss_gen']))
    emit(phase='cond_mom_train_step', model='spatiotemporal/gen_3x_4x_2f',
         queue='QueueMom1', padding=COND_PADDING, batch=TRAIN_BATCH,
         lr_shape=list(TRAIN_LR), hr_shape=list(TRAIN_HR),
         steps=N_TRAIN_STEPS, step_ms=times, median_step_ms=median,
         spread_ms=[float(np.min(times)), float(np.max(times))],
         hr_voxels_per_s=TRAIN_BATCH * int(np.prod(TRAIN_HR[:3]))
         / (median / 1e3), launches_per_step=per_step, losses=losses,
         peak_device_gb=peak / 1e9, step_peak_gb=(peak - before) / 1e9,
         nvidia_smi=name, ok=ok, **prof)
    if not ok:
        raise AssertionError(f'cond mom cell: launches {per_step}, '
                             f'losses {losses}')
    return per_step


def epoch_split(history, val_s, n_batches=4):
    """(epoch seconds, s per batch without validation) of a history."""
    epoch_s = np.diff([0.0] + list(history['elapsed_time']))
    return list(epoch_s), float(np.mean(epoch_s - val_s)) / n_batches


def cond_mom1_loop(name, tmp):
    """Phase 13c: ``Sup3rCondMom.train`` of the flagship over a
    ``BatchHandlerMom1`` through a ``TrainingSession`` with
    ``tensorboard_log=True`` (2 epochs of 4 batches of 16, validation,
    checkpoints): without the tensorboard package it warns and goes on.
    Returns the trained model, its last checkpoint and the loop's s per
    batch and starvation rate."""
    handler = cond_handler(BatchHandlerMom1)
    model = Sup3rCondMom(get_config('spatiotemporal/gen_3x_4x_2f'),
                         learning_rate=TRAIN_LR_RATE)
    out_dir = os.path.join(tmp, 'runs', 'mom1_{epoch}')
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        TrainingSession(handler, model, input_resolution={
            'spatial': '3km', 'temporal': '60min'}, n_epoch=2,
            out_dir=out_dir, tensorboard_log=True).run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    body, wgrad = gated(), wgrad_gated()
    t0 = time.perf_counter()
    model.calc_val_loss(handler)
    val_s = time.perf_counter() - t0
    handler.stop()
    tb_warned = any('tensorboard' in str(w.message) for w in caught)
    events = glob.glob(os.path.join(tmp, 'runs', 'logs', 'events.*'))
    history = model.history
    epoch_s, per_batch = epoch_split(history, val_s)
    loaded = Sup3rCondMom.load(out_dir.format(epoch=1))
    ok = bool(len(history) == 2 and all(
        np.isfinite(history[c]).all()
        for c in ('train_loss_gen', 'val_loss_gen'))
        and launches == {'small_reflect_conv': 16, 'reflect_conv': body,
                         'reflect_conv_wgrad': wgrad}
        and (tb_warned or len(events) == 1)
        and loaded._gen_opt_state['count'] == 8)
    emit(phase='cond_mom1_loop', epochs=2, batches_per_epoch=4,
         batch=TRAIN_BATCH, wall_s=wall_s, epoch_s=epoch_s,
         validation_s_per_epoch=val_s, s_per_batch=per_batch,
         starvation_rate=handler._queue.starvation_rate,
         tensorboard=('warned: not importable' if tb_warned
                      else f'{len(events)} event files'),
         history={c: list(history[c]) for c in history.columns},
         launches=launches, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError('cond mom1 loop: history, launches, '
                             'tensorboard or checkpoint failed')
    return model, out_dir.format(epoch=1), {
        's_per_batch': per_batch,
        'starvation_rate': handler._queue.starvation_rate}


def cond_mom2_loop(name, mom1):
    """Phase 13d: ``Sup3rCondMom.train`` over a ``BatchHandlerMom2``
    whose producer thread runs ``mom1`` (the full-width flagship) on the
    card for each batch's target (2 epochs of 4 batches); then 4 more
    batches stepped by hand while each target is held to ``(hr -
    mom1.generate(lr))^2`` on the card (1e-5 of its largest magnitude;
    TF32 would miss by ~1e-3): the producer's model and the step ran in
    exact fp32 side by side."""
    handler = cond_handler(BatchHandlerMom2, lower_models={1: mom1})
    model = Sup3rCondMom(get_config('spatiotemporal/gen_3x_4x_2f'),
                         learning_rate=TRAIN_LR_RATE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train(handler, input_resolution={'spatial': '3km',
                                           'temporal': '60min'},
                n_epoch=2, out_dir=None)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.calc_val_loss(handler)
    val_s = time.perf_counter() - t0
    starvation = handler._queue.starvation_rate
    epoch_s, per_batch = epoch_split(model.history, val_s)
    errs = []
    try:
        for batch in handler:
            model.run_gradient_descent(batch)
            want = (batch.high_res - torch.as_tensor(mom1.generate(
                batch.low_res, norm_in=False, un_norm_out=False),
                device='cuda')) ** 2
            errs.append(float((batch.output - want).abs().max())
                        / float(want.abs().max()))
    finally:
        handler.stop()
    rewrite_err = batch_output_after_step(mom1)
    ok = bool(len(errs) == 4 and max(errs) <= KERNEL_RTOL
              and rewrite_err <= KERNEL_RTOL
              and np.isfinite(model.history['val_loss_gen']).all())
    emit(phase='cond_mom2_loop', epochs=2, batches_per_epoch=4,
         batch=TRAIN_BATCH, wall_s=wall_s, epoch_s=epoch_s,
         validation_s_per_epoch=val_s, s_per_batch=per_batch,
         starvation_rate=starvation,
         target_rel_err_vs_generate=errs, tol=KERNEL_RTOL,
         batch_output_after_step_rel_err=rewrite_err,
         history={c: list(model.history[c])
                  for c in model.history.columns}, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'cond mom2 targets {errs}, batch_output '
                             f'after a step {rewrite_err} or history '
                             f'failed')
    return max(errs)


def batch_output_after_step(mom1, n=3):
    """``n`` times: one train step of ``mom1`` queued behind ~0.3 s of
    sleep on the current stream, then at once its ``batch_output`` (on
    its side stream) on phase 7's batch, against its ``generate`` (on
    the step's stream) after the step: the side stream must wait for the
    step's weight updates, or it reads the old weights (errors of
    0.7-3.7 on the card without the wait). Returns the largest error
    relative to the output's largest magnitude."""
    batch = cond_batch(TRAIN_BATCH)
    errs = []
    for _ in range(n):
        torch.cuda.synchronize()
        torch.cuda._sleep(500_000_000)
        mom1._train_step(*(mom1._place_batch(a) for a in batch))
        got = mom1.batch_output(batch.low_res, batch.high_res)
        want = mom1.generate(batch.low_res, norm_in=False,
                             un_norm_out=False)
        errs.append(float(np.abs(got - want).max())
                    / float(np.abs(want).max()))
    return max(errs)


def small_tail_calls(net):
    """Forward pre-hooks on the fused blocks of ``net`` that
    ``small_reflect_conv`` takes on the card; returns (calls, remove):
    ``calls`` counts each call by (input shape, co, alpha)."""
    calls = Counter()

    def hook(m, args):
        if m.route(*args) == 'small':
            calls[(tuple(args[0].shape), m.conv.bias.shape[0],
                   m.alpha)] += 1

    hooks = [lyr.register_forward_pre_hook(hook) for lyr in net.layers
             if isinstance(lyr, FusedReflectConv)]

    def remove():
        for h in hooks:
            h.remove()

    return calls, remove


def capture_first_generate(model):
    """Wrap ``model.generate`` to keep its first call's arguments and
    output; returns (captured, restore)."""
    captured = []

    def generate(low_res, *args, **kwargs):
        out = type(model).generate(model, low_res, *args, **kwargs)
        if not captured:
            lr = (low_res.cpu().numpy() if torch.is_tensor(low_res)
                  else np.array(low_res))
            captured.append((lr, args, kwargs, out.copy()))
        return out

    model.generate = generate
    return captured, lambda: delattr(model, 'generate')


def cond_fwp(name, tmp, model_dir):
    """Phase 13e: the Mom1 checkpoint through the chunked ForwardPass on
    phase 6's cell, chunk by chunk: a warm-up, 3 timed passes to NetCDF
    (wall s, HR voxels/s, ``small_reflect_conv`` once per chunk), every
    file read back. The last pass hooks the tail's calls by shape (each
    at ``COND_FWP_TAIL_SHAPE``, as many as the launches) and holds its
    first full-size chunk to the port's CPU ``generate`` of the same
    checkpoint (1e-4 of max); on a small domain every chunk against the
    port's CPU pass (1e-4 of max). Returns the launches per pass and the
    tail's calls by shape."""
    rng = np.random.default_rng(0)
    s1, s2, t = FWP_DOMAIN
    input_file = make_fake_nc_file(
        os.path.join(tmp, 'cond_input.nc'), FWP_DOMAIN, FWP_FEATURES,
        data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
              for f in FWP_FEATURES})

    def strategy(path, out_pattern, device='cuda', **kwargs):
        kw = dict(file_paths=path, model_class='Sup3rCondMom',
                  model_kwargs={'model_dir': model_dir, 'device': device},
                  fwp_chunk_shape=FWP_CHUNK, spatial_pad=FWP_PAD,
                  temporal_pad=FWP_PAD, out_pattern=out_pattern)
        return ForwardPassStrategy(**{**kw, **kwargs})

    ForwardPass.run(strategy(input_file, os.path.join(
        tmp, 'cond_warm', 'chunk_{file_id}.nc')), 0)
    walls, launches = [], None
    for i in range(N_FWP_PASSES):
        out_dir = os.path.join(tmp, f'cond_fwp_{i}')
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = strategy(input_file, os.path.join(out_dir, 'chunk_{file_id}.nc'))
        last = i == N_FWP_PASSES - 1
        if last:
            model = st.get_model()
            calls, remove = small_tail_calls(model._train_gen_net())
            captured, restore = capture_first_generate(model)
        try:
            RecordedForwardPass.run(st, 0)
            torch.cuda.synchronize()
        finally:
            if last:
                remove()
                restore()
        walls.append(time.perf_counter() - t0)
        launches = launch_counts()
        n_chunks = st.fwp_slicer.n_chunks
        hr_shape = check_fwp_files(st, out_dir)
        want = {'small_reflect_conv': n_chunks, 'reflect_conv': gated(),
                'reflect_conv_wgrad': 0}
        if launches != want:
            raise AssertionError(f'cond mom forward pass: launches '
                                 f'{launches} for {n_chunks} chunks, '
                                 f'expected {want}')
        emit(phase='cond_mom_forward_pass', pass_index=i, chunks=n_chunks,
             hr_shape=hr_shape, wall_s=walls[-1],
             hr_voxels_per_s=int(np.prod(hr_shape)) / walls[-1],
             timer_s=RecordedForwardPass.last.timer.log, launches=launches)
    want_calls = {(COND_FWP_TAIL_SHAPE, 2, None): n_chunks}
    lr, args, kwargs, got = captured[0]
    want = Sup3rCondMom.load(model_dir, device='cpu').generate(
        lr, *args, **kwargs)
    chunk_err = float(np.abs(got - want).max())
    chunk_tol = PARITY_RTOL * float(np.abs(want).max())
    ok = bool(dict(calls) == want_calls and got.shape == want.shape
              and np.isfinite(got).all() and chunk_err <= chunk_tol)
    emit(phase='cond_mom_forward_pass_chunk', lr_shape=list(lr.shape),
         hr_shape=list(got.shape), max_abs_err=chunk_err, tol=chunk_tol,
         calls_by_shape=[[list(x), co, a, n]
                         for (x, co, a), n in calls.items()], ok=ok)
    if not ok:
        raise AssertionError(f'cond mom forward pass: tail calls '
                             f'{dict(calls)} (want {want_calls}), chunk '
                             f'vs CPU {chunk_err} > {chunk_tol}')
    small = make_fake_nc_file(
        os.path.join(tmp, 'cond_small.nc'), (8, 8, 12), FWP_FEATURES,
        data={f: np.random.default_rng(i + 5).standard_normal(
            (12, 8, 8)) * 0.3 + 0.5 for i, f in enumerate(FWP_FEATURES)})
    kw = dict(fwp_chunk_shape=(4, 4, 6), spatial_pad=1, temporal_pad=1)
    card = ForwardPass.run(strategy(small, None, **kw), 0)
    cpu = ForwardPass.run(strategy(small, None, device='cpu', **kw), 0)
    scale = max(float(np.abs(v).max()) for v in cpu.values())
    err = max(float(np.abs(card[i] - cpu[i]).max()) for i in cpu)
    ok = bool(sorted(card) == sorted(cpu) and err <= PARITY_RTOL * scale)
    emit(phase='cond_mom_forward_pass_route', wall_s=walls,
         hr_voxels_per_s=int(np.prod(FWP_DOMAIN)) * 9 * 4 / float(
             np.median(walls)), launches_per_pass=launches,
         cpu_check={'chunks': len(cpu), 'max_abs_err': err,
                    'tol': PARITY_RTOL * scale}, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'cond mom forward pass: card vs CPU {err}')
    return launches, dict(calls)


def reference_import_check(name, tmp):
    """Phase 13f: phase 7's flagship ``Sup3rGan`` exported with
    ``export_reference_gan`` and read back with ``load_reference_gan(...,
    device='cuda')``: one request (phase 3's input) equal to the
    original's within 1e-6 of max."""
    model = train_model('cuda')
    ref_dir = os.path.join(tmp, 'reference')
    export_reference_gan(model, ref_dir)
    loaded = load_reference_gan(ref_dir, lr_shape=(1,) + TRAIN_LR,
                                hr_shape=(1,) + TRAIN_HR, device='cuda')
    lr = np.random.default_rng(0).standard_normal(LR_SHAPE).astype(
        np.float32) * 0.3 + 0.5
    want = model.generate(lr)
    got = loaded.generate(lr)
    err = float(np.abs(got - want).max())
    tol = 1e-6 * float(np.abs(want).max())
    ok = bool(got.shape == HR_SHAPE and err <= tol)
    emit(phase='reference_import', files=sorted(os.listdir(ref_dir)),
         shape=list(got.shape), max_abs_err=err, tol=tol, ok=ok)
    if not ok:
        raise AssertionError(f'reference import: {err} > {tol}')


def profiled_epoch(name, tmp):
    """Phase 13g: ``Sup3rGan.train(tensorboard_profile=True)`` over phase
    7's loop: one warm epoch, then a call of 2 epochs whose first is
    recorded by ``torch.profiler``; the trace file's size and the
    profiled epoch's seconds against the unprofiled one's."""
    handler = BatchHandler(
        [make_fake_dset(COND_DATA, FWP_FEATURES)],
        [make_fake_dset((72, 72, 96), FWP_FEATURES)],
        batch_size=TRAIN_BATCH, n_batches=4, s_enhance=3, t_enhance=4,
        sample_shape=TRAIN_HR[:3])
    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'),
                     learning_rate=TRAIN_LR_RATE)
    res = {'spatial': '3km', 'temporal': '60min'}
    out_dir = os.path.join(tmp, 'profiled', 'gan_{epoch}')
    model.train(handler, input_resolution=res, n_epoch=1,
                weight_gen_advers=W_ADV, out_dir=None)
    model.train(handler, input_resolution=res, n_epoch=2,
                weight_gen_advers=W_ADV, out_dir=out_dir,
                tensorboard_profile=True)
    traces = glob.glob(os.path.join(tmp, 'profiled', 'profile',
                                    '*.pt.trace.json'))
    epoch_s = np.diff(list(model.history['elapsed_time']))
    # elapsed_time restarts with each call: epochs 1 and 2 are the
    # second call's first (profiled) and second
    profiled_s = float(model.history['elapsed_time'][1])
    plain_s = float(epoch_s[-1])
    ok = len(traces) == 1 and len(model.history) == 3
    emit(phase='profiled_epoch', trace_files=len(traces),
         trace_mb=(os.path.getsize(traces[0]) / 2 ** 20 if traces else None),
         profiled_epoch_s=profiled_s, unprofiled_epoch_s=plain_s,
         overhead=profiled_s / plain_s - 1, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'tensorboard_profile wrote {traces}')


def cond_mom_phase(name):
    """Phase 13: the conditional-moment family on the card; returns the
    launches per Mom1 train step and per forward pass, and the Mom1
    loop's s per batch."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_cond_')
    try:
        check_err = cond_step_check()
        per_step = cond_step_cell(name)
        mom1, mom1_dir, mom1_loop = cond_mom1_loop(name, tmp)
        target_err = cond_mom2_loop(name, mom1)
        per_pass, fwp_calls = cond_fwp(name, tmp, mom1_dir)
        reference_import_check(name, tmp)
        profiled_epoch(name, tmp)
        return {'per_step': per_step, 'per_pass': per_pass,
                'fwp_calls': fwp_calls, 'mom1_loop': mom1_loop,
                'train_check_rel_err': check_err,
                'mom2_target_rel_err': target_err}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 14: bench.py's end-to-end cell (bench.py:104-128) in the card's
#: I/O form (NetCDF3 in, NetCDF out; bench.py writes NetCDF4 in and H5
#: out): a (40, 40, 40) LR domain, chunks (16, 16, 20), pads 2, device
#: batch 8, so 18 chunks; batches group chunks of one padded shape (the
#: domain's edge chunks are narrower), so 4 dispatches
STREAM_DOMAIN = (40, 40, 40)
STREAM_CHUNK = (16, 16, 20)
STREAM_PAD = 2
STREAM_BATCH = 8
STREAM_IO = 'netcdf3_in_netcdf_out'
#: the lazy-fed training cell's NetCDF3 u / v files (train, validation)
LAZY_TRAIN_DOMAIN = (72, 72, 240)
LAZY_VAL_DOMAIN = (72, 72, 96)


def stream_strategy(input_file, model_dir, out_pattern, device='cuda',
                    **kwargs):
    kw = dict(file_paths=input_file,
              model_kwargs={'model_dir': model_dir, 'device': device},
              fwp_chunk_shape=STREAM_CHUNK, spatial_pad=STREAM_PAD,
              temporal_pad=STREAM_PAD, device_batch_size=STREAM_BATCH,
              out_pattern=out_pattern)
    kw.update(kwargs)
    return ForwardPassStrategy(**kw)


def fused_calls(model):
    """Forward pre-hooks on the fused blocks of ``model``'s serving
    network (for the route its flags select); returns (calls, remove):
    ``calls`` counts each block call by (kernel, input shape, co, alpha),
    the kernel being the one the block launches on the card
    ('small_reflect_conv', 'reflect_conv' or 'cudnn')."""
    calls = Counter()

    def hook(m, args):
        x = args[0]
        kname = {'small': 'small_reflect_conv',
                 'gather_small': 'small_reflect_conv',
                 'body': 'reflect_conv'}.get(m.route(*args), 'cudnn')
        calls[(kname, tuple(x.shape), m.conv.bias.shape[0], m.alpha)] += 1

    hooks = [lyr.register_forward_pre_hook(hook)
             for lyr in model._get_fused_apply().layers
             if isinstance(lyr, FusedReflectConv)]

    def remove():
        for h in hooks:
            h.remove()

    return calls, remove


def stream_dispatches(strategy):
    """The device batches of a pass over ``strategy``: chunks group by
    their padded shape, ``STREAM_BATCH`` to a batch."""
    fwp = ForwardPass(strategy, 0)
    shapes = Counter(fwp.get_input_chunk(i).input_data.shape
                     for i in range(strategy.fwp_slicer.n_chunks))
    return sum(-(-n // STREAM_BATCH) for n in shapes.values())


def stream_pass(make_strategy, out_dir, route, mode, index, n_dispatch,
                hook=False, phase='streaming_pass'):
    """One timed ``ForwardPass.run`` of phase 14's cell to NetCDF (the
    wall time includes planning); returns (wall_s, launches, stitched
    HR domain, prep s per chunk, fused calls or None)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strategy = make_strategy(os.path.join(out_dir, 'chunk_{file_id}.nc'))
    calls = remove = None
    if hook:
        calls, remove = fused_calls(strategy.get_model())
    try:
        RecordedForwardPass.run(strategy, 0)
        torch.cuda.synchronize()
    finally:
        if remove is not None:
            remove()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    n_chunks = strategy.fwp_slicer.n_chunks
    check_fwp_launches(route, launches, n_dispatch)
    hr_shape, full = check_fwp_files(strategy, out_dir, keep=True,
                                     domain=STREAM_DOMAIN)
    prep_s = strategy.timer.log.get('prep_chunk_data', 0.0) / n_chunks
    emit(phase=phase, io=STREAM_IO, route=route, mode=mode,
         pass_index=index, chunks=n_chunks, dispatches=n_dispatch,
         hr_shape=hr_shape, wall_s=wall_s,
         hr_voxels_per_s=int(np.prod(hr_shape)) / wall_s,
         prep_s_per_chunk=prep_s, timer_s=RecordedForwardPass.last.timer.log,
         launches=launches)
    return wall_s, launches, full, prep_s, calls


def stream_cpu_chunk_check(make_strategy, what, index=0,
                           phase='streaming_cpu_check'):
    """One chunk of the card's pass (serial ``run_chunk``) against the
    port's CPU pass of the same strategy (1e-4 of max)."""
    outs = []
    for device in ('cuda', 'cpu'):
        fwp = ForwardPass(make_strategy(device), 0)
        _, out = fwp.run_chunk(fwp.get_input_chunk(index))
        outs.append(out)
    got, want = outs
    err = float(np.abs(got - want).max())
    tol = PARITY_RTOL * float(np.abs(want).max())
    ok = bool(got.shape == want.shape and np.isfinite(got).all()
              and err <= tol)
    emit(phase=phase, io=STREAM_IO, what=what,
         chunk=index, hr_shape=list(got.shape), max_abs_err=err, tol=tol,
         ok=ok)
    if not ok:
        raise AssertionError(f'{what}: chunk {index} on the card vs the '
                             f'CPU {err} > {tol}')


def stream_passes(name, tmp, model_dir, native):
    """Phase 14a: the cell's eager and chunked_io passes on both routes
    (3 timed each after a warm-up), chunked_io equal to eager (1e-6 of
    max), one profiled chunked_io pass per route, a chunk against the
    CPU. Returns per route the launches per pass and the fused calls of
    the last chunked_io pass, and the wall s and prep s a chunk of each
    mode's timed passes."""
    rng = np.random.default_rng(0)
    s1, s2, t = STREAM_DOMAIN
    input_file = make_fake_nc_file(
        os.path.join(tmp, 'stream.nc'), STREAM_DOMAIN, FWP_FEATURES,
        data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
              for f in FWP_FEATURES})

    def make(mode, **kwargs):
        return lambda out: stream_strategy(
            input_file, model_dir, out, chunked_io=mode == 'chunked_io',
            **kwargs)

    eager = make('eager')(None)
    served = eager.get_model()
    n_dispatch = stream_dispatches(eager)
    out = {}
    for route, pallas in (('default', False), ('opt_in', True)):
        served.inference_pallas = pallas
        for mode in ('eager', 'chunked_io'):
            ForwardPass.run(make(mode)(os.path.join(
                tmp, f'stream_warm_{route}_{mode}', 'chunk_{file_id}.nc')),
                0)
        rec = {}
        for mode in ('eager', 'chunked_io'):
            walls, preps = [], []
            for i in range(N_FWP_PASSES):
                wall, launches, full, prep, calls = stream_pass(
                    make(mode), os.path.join(tmp, f'{route}_{mode}_{i}'),
                    route, mode, i, n_dispatch,
                    hook=mode == 'chunked_io' and i == N_FWP_PASSES - 1)
                walls.append(wall)
                preps.append(prep)
            rec[mode] = dict(wall_s=walls, prep_s_per_chunk=preps,
                             launches=launches, full=full, calls=calls)
        err = float(np.abs(rec['chunked_io']['full']
                           - rec['eager']['full']).max())
        tol = 1e-6 * float(np.abs(rec['eager']['full']).max())
        hr_voxels = int(np.prod(rec['eager']['full'].shape[:-1]))
        emit(phase='streaming_route', io=STREAM_IO, route=route,
             **{f'{m}_wall_s': rec[m]['wall_s'] for m in rec},
             **{f'{m}_hr_voxels_per_s': hr_voxels / float(
                 np.median(rec[m]['wall_s'])) for m in rec},
             **{f'{m}_prep_s_per_chunk': rec[m]['prep_s_per_chunk']
                for m in rec},
             launches_per_pass={m: rec[m]['launches'] for m in rec},
             chunked_io_vs_eager_max_abs_err=err, tol=tol,
             nvidia_smi=name, ok=err <= tol)
        if not err <= tol:
            raise AssertionError(f'streaming ({route}): chunked_io differs '
                                 f'from the eager pass by {err} > {tol}')
        fwp_profiled_pass(make('chunked_io'),
                          os.path.join(tmp, f'{route}_stream_profiled'),
                          route, phase='streaming_profile')
        out[route] = {'launches': rec['chunked_io']['launches'],
                      'calls': rec['chunked_io']['calls'],
                      'wall_s': {m: rec[m]['wall_s'] for m in rec},
                      'prep_s_per_chunk': {
                          m: rec[m]['prep_s_per_chunk'] for m in rec}}
    served.inference_pallas = False
    stream_cpu_chunk_check(
        lambda device: stream_strategy(input_file, model_dir, None,
                                       device=device, chunked_io=True),
        'chunked_io pass')
    native_pad_check(name, eager, native)
    return out


def native_pad_check(name, strategy, native, repeats=5):
    """Phase 14: every chunk of the cell read (``init_chunk``) and padded
    by ``_native.reflect_pad_4d`` and by ``np.pad`` (the median of
    ``repeats`` each): bit-equal, with the prep ms a chunk (read + pad)
    each way, beside phase 1's build of the library (``native``)."""
    read_ms, native_ms, numpy_ms, equal = [], [], [], True
    for i in range(strategy.fwp_slicer.n_chunks):
        t0 = time.perf_counter()
        chunk = strategy.init_chunk(i)
        read_ms.append(1e3 * (time.perf_counter() - t0))
        arr, pads = chunk.input_data, chunk.pad_width
        for fn, times in (
                (_native.reflect_pad_4d, native_ms),
                (lambda a, p: np.pad(a, (*p, (0, 0)), mode='reflect'),
                 numpy_ms)):
            runs = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                out = fn(arr, pads)
                runs.append(1e3 * (time.perf_counter() - t0))
            times.append(float(np.median(runs)))
            if fn is _native.reflect_pad_4d:
                padded = out
        equal = equal and bool(padded.dtype == out.dtype and np.array_equal(
            padded, out))
    read = float(np.median(read_ms))
    emit(phase='native_pad', io=STREAM_IO, chunks=len(read_ms),
         chunk_dtype=str(arr.dtype), padded_shape=list(padded.shape),
         read_ms_per_chunk=read,
         native_pad_ms_per_chunk=float(np.median(native_ms)),
         numpy_pad_ms_per_chunk=float(np.median(numpy_ms)),
         prep_ms_per_chunk_native=read + float(np.median(native_ms)),
         prep_ms_per_chunk_numpy=read + float(np.median(numpy_ms)),
         native_built=native['built'], native_build_s=native['build_s'],
         bit_equal=equal,
         nvidia_smi=name, ok=equal)
    if not equal:
        raise AssertionError('native pad: differs from np.pad on a chunk of '
                             'the cell')


def gcm_pass(name, tmp, model_dir):
    """Phase 14b: the cell's geometry through
    ``DataHandlerNCforCCwithPowerLaw`` with chunked_io on the default
    route: hourly NetCDF3 uas / vas, u_100m / v_100m by the power law; 3
    timed passes after a warm-up and a chunk against the CPU."""
    rng = np.random.default_rng(1)
    s1, s2, t = STREAM_DOMAIN
    # the power law scales by (100 / 10) ** 0.2: keep the derived winds
    # on the model's normalization scale
    gcm_file = make_fake_nc_file(
        os.path.join(tmp, 'gcm.nc'), STREAM_DOMAIN, ['uas', 'vas'],
        data={f: (rng.standard_normal((t, s1, s2)) * 0.3 + 0.5) / 10 ** 0.2
              for f in ('uas', 'vas')})

    def make(out, device='cuda'):
        return stream_strategy(
            gcm_file, model_dir, out, device=device, chunked_io=True,
            input_handler_name='DataHandlerNCforCCwithPowerLaw')

    ForwardPass.run(make(os.path.join(tmp, 'gcm_warm',
                                      'chunk_{file_id}.nc')), 0)
    n_dispatch = stream_dispatches(make(None))
    walls = []
    for i in range(N_FWP_PASSES):
        wall, launches, _, prep, _ = stream_pass(
            make, os.path.join(tmp, f'gcm_{i}'), 'default', 'gcm_chunked_io',
            i, n_dispatch)
        walls.append(wall)
    emit(phase='streaming_gcm', io=STREAM_IO,
         handler='DataHandlerNCforCCwithPowerLaw', wall_s=walls,
         hr_voxels_per_s=int(np.prod(STREAM_DOMAIN)) * 9 * 4 / float(
             np.median(walls)), launches_per_pass=launches,
         nvidia_smi=name)
    stream_cpu_chunk_check(lambda device: make(None, device=device),
                           'GCM chunked_io pass')
    return launches


def lazy_feed_check(train_file):
    """The first batch of a queue over the lazy handler against one over
    the eager handler on the same file and seed (single-threaded): the
    HR batch bit-equal, the coarsened LR within an ulp (the stacked
    samples' layout sets the average's summation order)."""
    batches = []
    for mode in ('lazy', 'eager'):
        handler = DataHandler(train_file, features=FWP_FEATURES, mode=mode)
        queue = SingleBatchQueue(
            [Sampler(handler.data, TRAIN_HR[:3])], batch_size=TRAIN_BATCH,
            s_enhance=3, t_enhance=4, mode=mode)
        RANDOM_GENERATOR.bit_generator.state = np.random.default_rng(
            11).bit_generator.state
        batches.append(queue.post_proc(queue.sample_batch()))
    (lr, hr), (lr_e, hr_e) = batches
    hr_equal = bool(np.array_equal(hr, hr_e))
    lr_err = float(np.abs(lr - lr_e).max())
    lr_tol = 1e-6 * float(np.abs(lr_e).max())
    ok = hr_equal and lr_err <= lr_tol and hr.shape == (
        (TRAIN_BATCH,) + TRAIN_HR)
    emit(phase='lazy_feed_check', hr_bit_equal=hr_equal,
         lr_max_abs_err=lr_err, lr_tol=lr_tol, ok=ok)
    if not ok:
        raise AssertionError(f'lazy feed: first batch differs from the '
                             f'eager feed (hr equal {hr_equal}, lr '
                             f'{lr_err} > {lr_tol})')


def lazy_train_loops(name, tmp):
    """Phase 14c: phase 7's training cell fed by a ``BatchHandler`` over
    ``DataHandler(mode='lazy')`` on a NetCDF3 (72, 72, 240) u / v file,
    2 epochs of 4 batches with validation, then the same over eager
    handlers: s per batch and starvation for each feed."""
    rng = np.random.default_rng(2)
    files = {}
    for split, domain in (('train', LAZY_TRAIN_DOMAIN),
                          ('val', LAZY_VAL_DOMAIN)):
        s1, s2, t = domain
        files[split] = make_fake_nc_file(
            os.path.join(tmp, f'lazy_{split}.nc'), domain, FWP_FEATURES,
            data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
                  for f in FWP_FEATURES})
    lazy_feed_check(files['train'])
    out = {}
    for mode in ('lazy', 'eager'):
        handlers = {k: DataHandler(v, features=FWP_FEATURES, mode=mode)
                    for k, v in files.items()}
        handler = BatchHandler(
            [handlers['train']], [handlers['val']], batch_size=TRAIN_BATCH,
            n_batches=4, s_enhance=3, t_enhance=4,
            sample_shape=TRAIN_HR[:3], mode=mode)
        model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                         get_config('spatiotemporal/disc_test'),
                         learning_rate=TRAIN_LR_RATE)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train(handler, input_resolution={'spatial': '3km',
                                               'temporal': '60min'},
                    n_epoch=2, weight_gen_advers=W_ADV,
                    out_dir=os.path.join(tmp, f'lazy_{mode}_{{epoch}}'))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        body, wgrad = gated(), wgrad_gated()
        t0 = time.perf_counter()
        model.calc_val_loss(handler, W_ADV)
        val_s = time.perf_counter() - t0
        handler.stop()
        history = model.history
        epoch_s = np.diff([0.0] + list(history['elapsed_time']))
        ok = (len(history) == 2 and all(
            np.isfinite(history[c]).all()
            for c in ('train_loss_gen', 'val_loss_gen'))
            and launches == {'small_reflect_conv': 16, 'reflect_conv': body,
                             'reflect_conv_wgrad': wgrad})
        out[mode] = float(np.mean(epoch_s - val_s)) / 4
        emit(phase='lazy_train_loop', feed=mode, io='netcdf3',
             domain=list(LAZY_TRAIN_DOMAIN), epochs=2, batches_per_epoch=4,
             batch=TRAIN_BATCH, wall_s=wall_s, epoch_s=list(epoch_s),
             validation_s_per_epoch=val_s, s_per_batch=out[mode],
             starvation_rate=handler._queue.starvation_rate,
             means=handler.means, launches=launches, nvidia_smi=name,
             ok=ok)
        if not ok:
            raise AssertionError(f'{mode}-fed train loop: history or '
                                 f'launches {launches} failed')
        del model
    return out


def streaming_phase(name, native):
    """Phase 14: streaming input (chunked_io, mode='lazy') and the GCM
    handler on the flagship at full width. Returns the launches and
    fused calls per route of the chunked_io pass and the GCM pass's
    launches."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_stream_')
    try:
        model = flagship('cuda')
        model.meta.update(
            input_resolution={'spatial': '12km', 'temporal': '60min'})
        model_dir = os.path.join(tmp, 'model')
        model.save(model_dir)
        del model
        per_route = stream_passes(name, tmp, model_dir, native)
        gcm = gcm_pass(name, tmp, model_dir)
        lazy_train_loops(name, tmp)
        return per_route, gcm
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 15: bias correction. Calibration data, daily for 10 years: u /
#: v and a precipitation-like pr with dry days on phase 14's (40, 40) LR
#: grid (history from 2000, future from 2050) and a baseline on an (80,
#: 80) grid over the same area and years; QDM and PresRat at their
#: defaults (101 quantiles, 24 day-of-year windows). The card's
#: calibration is held to the host's at the JAX package's own bar
#: (tests/bias/test_qdm_device.py:64)
BIAS_DAYS = 3650
BIAS_BASE_GRID = (80, 80)
BIAS_NQ = 101
BIAS_NT = 24
BIAS_RTOL, BIAS_ATOL = 2e-4, 2e-2
#: the corrected training feed: hourly NetCDF3 uas / vas on the LR grid
BIAS_GCM_TRAIN = (40, 40, 240)
BIAS_GCM_VAL = (40, 40, 96)


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def bias_series(rng, grid, kind, scale=1.0, shift=0.0, p_dry=0.0):
    """(t, s1, s2) float32 daily fields of ``BIAS_DAYS`` with a seasonal
    cycle: a wind component about 0.5, or (``kind='pr'``) gamma amounts
    with a fraction ``p_dry`` of dry (zero) days."""
    shape = (BIAS_DAYS,) + tuple(grid)
    season = np.sin(2 * np.pi * np.arange(BIAS_DAYS) / 365.25).astype(
        np.float32)[:, None, None]
    if kind == 'pr':
        wet = rng.gamma(0.8, 0.6, shape).astype(np.float32) * (
            1 + 0.3 * season)
        return np.where(rng.random(shape, dtype=np.float32) < p_dry, 0,
                        scale * wet).astype(np.float32)
    noise = rng.standard_normal(shape, dtype=np.float32)
    return (scale * (0.5 + 0.15 * season + 0.3 * noise) + shift).astype(
        np.float32)


def bias_inputs(tmp, seed=3):
    """Phase 15's NetCDF3 calibration files: {'wind' | 'pr': {'base' |
    'hist' | 'fut': path}}. The history is biased (wind scaled 1.1 and
    shifted 0.15; pr wetter), the future shifted again (a trend)."""
    rng = np.random.default_rng(seed)
    lr_grid = STREAM_DOMAIN[:2]
    out = {'wind': {}, 'pr': {}}
    for key, grid, start, wind_kw, pr_kw in (
            ('base', BIAS_BASE_GRID, '2000-01-01', {}, {'p_dry': 0.4}),
            ('hist', lr_grid, '2000-01-01', {'scale': 1.1, 'shift': 0.15},
             {'p_dry': 0.25}),
            ('fut', lr_grid, '2050-01-01', {'scale': 1.1, 'shift': 0.3},
             {'p_dry': 0.3, 'scale': 1.15})):
        shape = tuple(grid) + (BIAS_DAYS,)
        out['wind'][key] = make_fake_nc_file(
            os.path.join(tmp, f'{key}_wind.nc'), shape, FWP_FEATURES,
            start=start, freq='D',
            data={f: bias_series(rng, grid, 'wind', **wind_kw)
                  for f in FWP_FEATURES})
        out['pr'][key] = make_fake_nc_file(
            os.path.join(tmp, f'{key}_pr.nc'), shape, ['pr'], start=start,
            freq='D', data={'pr': bias_series(rng, grid, 'pr', **pr_kw)})
    return out


def bias_calibration(name, tmp, files, feature, cls=None, device='cuda',
                     host=True):
    """Phase 15a: one calibration from NetCDF3 files (the baseline
    through ``LoaderNC`` and the flat gid adapter), ``run(use_device=
    True)`` on ``device`` then (``host``) ``run(use_device=False)`` on
    the host in the same process: wall s of each, and of the batched
    percentiles alone; every output raster of the device path against
    the host's (rtol 2e-4 / atol 2e-2, NaN masks equal). Writes the
    device path's rasters as a NetCDF3 factor file; returns its path."""
    cls = cls or QuantileDeltaMappingCorrection
    calc = cls(files['base'], files['hist'], files['fut'], feature,
               feature, base_handler='LoaderNC', n_quantiles=BIAS_NQ,
               n_time_steps=BIAS_NT, device=device)
    outs, wall_s, percentile_s = {}, {}, {}
    arr = calc.bias_dh.data[feature]
    for path, use_device in (('device', True), ('host', False))[:1 + host]:
        sync(device)
        t0 = time.perf_counter()
        outs[path] = calc.run(use_device=use_device)
        sync(device)
        wall_s[path] = time.perf_counter() - t0
        t0 = time.perf_counter()
        calc._windowed_params_raster(arr, calc.bias_time_index,
                                     use_device=use_device)
        sync(device)
        percentile_s[path] = time.perf_counter() - t0
    errs, bar_share, nan_equal, n_nan = {}, {}, {}, {}
    for key, want in outs.get('host', {}).items():
        got = outs['device'][key]
        nan_equal[key] = bool(np.array_equal(np.isnan(got), np.isnan(want)))
        n_nan[key] = int(np.isnan(want).sum())
        fin = np.isfinite(want) & np.isfinite(got)
        diff = np.abs(got[fin].astype(np.float64) - want[fin])
        errs[key] = float(diff.max()) if diff.size else 0.0
        bar_share[key] = float((diff / (BIAS_ATOL + BIAS_RTOL * np.abs(
            want[fin]))).max()) if diff.size else 0.0
    ok = bool(all(nan_equal.values())
              and max(bar_share.values(), default=0) <= 1)
    emit(phase='bias_calibration', calibration=cls.__name__,
         feature=feature, device=str(calc.device),
         bias_grid=list(arr.shape[:2]), base_grid=list(BIAS_BASE_GRID),
         days=BIAS_DAYS, n_quantiles=BIAS_NQ, n_time_steps=BIAS_NT,
         wall_s=wall_s, percentile_s=percentile_s, max_abs_err=errs,
         rtol=BIAS_RTOL, atol=BIAS_ATOL, share_of_bar=bar_share,
         nan_masks_equal=nan_equal, nan_count=n_nan, nvidia_smi=name,
         ok=ok)
    if not ok:
        raise AssertionError(f'{cls.__name__} {feature}: the device path '
                             f'differs from the host (share of bar '
                             f'{bar_share}, NaN masks equal {nan_equal})')
    return write_nc_factor_file(
        os.path.join(tmp, f'factors_{feature}.nc'), calc.bias_dh.lat_lon,
        outs['device'], calc.factor_cfg())


@contextlib.contextmanager
def kernel_calls():
    """Record each call the fused blocks make of the kernels' wrappers by
    (kernel, input shape, co, alpha) while the block runs; on the card
    each call is one launch."""
    calls = Counter()
    small, packed = (fuse_module.small_reflect_conv_cf,
                     kernels_module.reflect_conv_packed)

    def small_call(x, weight, bias, alpha=None):
        calls[('small_reflect_conv', tuple(x.shape), weight.shape[0],
               alpha)] += 1
        return small(x, weight, bias, alpha)

    def packed_call(x, weights, bias, co, n_tile, alpha=None):
        calls[('reflect_conv', tuple(x.shape), co, alpha)] += 1
        return packed(x, weights, bias, co, n_tile, alpha)

    fuse_module.small_reflect_conv_cf = small_call
    kernels_module.reflect_conv_packed = packed_call
    try:
        yield calls
    finally:
        fuse_module.small_reflect_conv_cf = small
        kernels_module.reflect_conv_packed = packed


def bias_kwargs(fps):
    """``local_qdm_bc`` kwargs of both wind features (absolute QDM: the
    components are signed)."""
    return {f: {'bias_fp': fps[f], 'base_dset': f, 'relative': False}
            for f in FWP_FEATURES}


def bias_chunk_check(input_file, model_dir, fps):
    """The corrected input of the cell's first chunk is the raw chunk
    through ``local_qdm_bc`` with the chunk's own window and stamps (the
    strategy windows the factor file by ``lr_padded_slice``)."""
    raw = stream_strategy(input_file, model_dir, None)
    corr = stream_strategy(input_file, model_dir, None,
                           bias_correct_method='local_qdm_bc',
                           bias_correct_kwargs=bias_kwargs(fps))
    got, _ = corr.prep_chunk_data(0)
    data, _ = raw.prep_chunk_data(0)
    s_idx, t_idx = raw.fwp_slicer.get_chunk_indices(0)
    pad = raw.fwp_slicer.s_lr_pad_slices[s_idx]
    ti = raw.input_handler.time_index[raw.fwp_slicer.t_lr_pad_slices[t_idx]]
    errs, shifts = {}, {}
    for i, f in enumerate(FWP_FEATURES):
        want = local_qdm_bc(data[..., i], raw.input_handler.lat_lon, f, f,
                            fps[f], get_date_range_kwargs(ti),
                            lr_padded_slice=pad, relative=False)
        errs[f] = float(np.abs(got[..., i] - want).max())
        shifts[f] = [float(np.mean(got[..., i] - data[..., i])),
                     float(np.abs(got[..., i] - data[..., i]).max())]
    ok = bool(max(errs.values()) == 0 and all(
        v[1] > 0.01 for v in shifts.values()))
    emit(phase='bias_chunk_check', chunk_shape=list(got.shape),
         max_abs_err=errs, correction_mean_and_max=shifts, ok=ok)
    if not ok:
        raise AssertionError(f'bias-corrected chunk: {errs}, {shifts}')


def bias_passes(name, tmp, model_dir, fps, pr_fp, uncorrected):
    """Phase 15b: phase 14's cell with ``local_qdm_bc`` on both wind
    features from part (a)'s files: eager and chunked_io on both routes,
    3 timed passes each after a warm-up (wall s, HR voxels/s and prep s
    a chunk beside phase 14's uncorrected passes of the same strategy),
    chunked_io equal to eager (1e-6 of max), a chunk against the port's
    CPU pass with the correction (1e-4 of max); then one
    ``local_presrat_bc`` pass on the default route. Returns per route
    the launches per pass and the kernel calls of the last timed
    chunked_io pass."""
    rng = np.random.default_rng(0)
    s1, s2, t = STREAM_DOMAIN
    input_file = make_fake_nc_file(
        os.path.join(tmp, 'stream.nc'), STREAM_DOMAIN, FWP_FEATURES,
        data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
              for f in FWP_FEATURES})
    bias_chunk_check(input_file, model_dir, fps)
    bc = dict(bias_correct_method='local_qdm_bc',
              bias_correct_kwargs=bias_kwargs(fps))

    def make(mode, **kwargs):
        return lambda out: stream_strategy(
            input_file, model_dir, out, chunked_io=mode == 'chunked_io',
            **{**bc, **kwargs})

    eager = make('eager')(None)
    served = eager.get_model()
    n_dispatch = stream_dispatches(eager)
    out = {}
    for route, pallas in (('default', False), ('opt_in', True)):
        served.inference_pallas = pallas
        for mode in ('eager', 'chunked_io'):
            ForwardPass.run(make(mode)(os.path.join(
                tmp, f'bias_warm_{route}_{mode}', 'chunk_{file_id}.nc')), 0)
        rec = {}
        for mode in ('eager', 'chunked_io'):
            walls, preps = [], []
            for i in range(N_FWP_PASSES):
                with kernel_calls() as calls:
                    wall, launches, full, prep, _ = stream_pass(
                        make(mode), os.path.join(tmp, f'bias_{route}_{mode}'
                                                      f'_{i}'),
                        route, mode, i, n_dispatch, phase='bias_pass')
                walls.append(wall)
                preps.append(prep)
            # the launches and kernel calls are those of the last pass
            rec[mode] = dict(wall_s=walls, prep_s_per_chunk=preps,
                             launches=launches, full=full, calls=calls)
        err = float(np.abs(rec['chunked_io']['full']
                           - rec['eager']['full']).max())
        tol = 1e-6 * float(np.abs(rec['eager']['full']).max())
        hr_voxels = int(np.prod(rec['eager']['full'].shape[:-1]))
        plain = uncorrected[route]
        emit(phase='bias_route', io=STREAM_IO, route=route,
             correction='local_qdm_bc',
             **{f'{m}_wall_s': rec[m]['wall_s'] for m in rec},
             **{f'{m}_hr_voxels_per_s': hr_voxels / float(
                 np.median(rec[m]['wall_s'])) for m in rec},
             **{f'{m}_prep_s_per_chunk': rec[m]['prep_s_per_chunk']
                for m in rec},
             uncorrected_wall_s=plain['wall_s'],
             uncorrected_prep_s_per_chunk=plain['prep_s_per_chunk'],
             wall_ratio_to_uncorrected={m: float(
                 np.median(rec[m]['wall_s']) / np.median(
                     plain['wall_s'][m])) for m in rec},
             launches_per_pass={m: rec[m]['launches'] for m in rec},
             chunked_io_vs_eager_max_abs_err=err, tol=tol,
             nvidia_smi=name, ok=err <= tol)
        if not err <= tol:
            raise AssertionError(f'bias ({route}): chunked_io differs from '
                                 f'the eager pass by {err} > {tol}')
        out[route] = {'launches': rec['chunked_io']['launches'],
                      'calls': rec['chunked_io']['calls']}
    served.inference_pallas = False
    stream_cpu_chunk_check(
        lambda device: stream_strategy(input_file, model_dir, None,
                                       device=device, chunked_io=True, **bc),
        'bias-corrected chunked_io pass', phase='bias_cpu_check')
    # pr's factors on the u channel: an absolute QDM keeps the mapped
    # winds in range, then tau zeroes and K scales them
    presrat = {'u_100m': {'bias_fp': pr_fp, 'base_dset': 'pr',
                          'feature_name': 'pr', 'relative': False}}
    wall, launches, _, prep, _ = stream_pass(
        make('eager', bias_correct_method='local_presrat_bc',
             bias_correct_kwargs=presrat),
        os.path.join(tmp, 'bias_presrat'), 'default', 'eager', 0,
        n_dispatch, phase='bias_presrat_pass')
    return out


def bias_train_loop(name, tmp, fps, phase13):
    """Phase 15c: the flagship as a ``Sup3rCondMom`` trained with phase
    13's Mom1 loop (2 epochs of 4 batches of 16, validation) over a
    ``BatchHandlerMom1`` of ``DataHandlerNCforCCwithPowerLaw`` data on
    hourly NetCDF3 uas / vas, each handler corrected in place by
    ``qdm_bc`` with part (a)'s files first (held to ``local_qdm_bc`` of
    the raw fields, 1e-5 of max): s per batch and starvation beside
    phase 13's loop. Returns the kernel calls of the loop."""
    rng = np.random.default_rng(4)
    handlers, errs, shifts = {}, {}, {}
    for split, domain in (('train', BIAS_GCM_TRAIN), ('val', BIAS_GCM_VAL)):
        s1, s2, t = domain
        path = make_fake_nc_file(
            os.path.join(tmp, f'gcm_{split}.nc'), domain, ['uas', 'vas'],
            data={f: (rng.standard_normal((t, s1, s2)) * 0.3 + 0.5)
                  / 10 ** 0.2 for f in ('uas', 'vas')})
        handler = DataHandlerNCforCCwithPowerLaw(path, features=FWP_FEATURES)
        raw = {f: np.array(handler.data[f]) for f in FWP_FEATURES}
        done = []
        for f in FWP_FEATURES:
            done += qdm_bc(handler, fps[f], f, relative=False)
        if done != FWP_FEATURES:
            raise AssertionError(f'qdm_bc corrected {done}')
        kws = get_date_range_kwargs(handler.time_index)
        for f in FWP_FEATURES:
            want = local_qdm_bc(raw[f], np.asarray(handler.lat_lon), f, f,
                                fps[f], kws, relative=False)
            got = np.asarray(handler.data[f])
            errs[f'{split}_{f}'] = float(np.abs(got - want).max()) / float(
                np.abs(want).max())
            shifts[f'{split}_{f}'] = float(np.mean(got - raw[f]))
        handlers[split] = handler
    ok = max(errs.values()) <= 1e-5
    emit(phase='bias_feed_check', handler='DataHandlerNCforCCwithPowerLaw',
         domains={'train': list(BIAS_GCM_TRAIN), 'val': list(BIAS_GCM_VAL)},
         rel_err=errs, mean_correction=shifts, tol=1e-5, ok=ok)
    if not ok:
        raise AssertionError(f'qdm_bc feed: {errs}')
    handler = BatchHandlerMom1(
        [handlers['train']], [handlers['val']], batch_size=TRAIN_BATCH,
        n_batches=4, s_enhance=3, t_enhance=4, sample_shape=TRAIN_HR[:3],
        queue_kwargs=dict(COND_PADDING))
    model = Sup3rCondMom(get_config('spatiotemporal/gen_3x_4x_2f'),
                         learning_rate=TRAIN_LR_RATE)
    zero_counts()
    with kernel_calls() as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train(handler, input_resolution={'spatial': '3km',
                                               'temporal': '60min'},
                    n_epoch=2, out_dir=os.path.join(tmp, 'bias_mom1_{epoch}'))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = launch_counts()
    body, wgrad = gated(), wgrad_gated()
    t0 = time.perf_counter()
    model.calc_val_loss(handler)
    val_s = time.perf_counter() - t0
    handler.stop()
    history = model.history
    epoch_s, per_batch = epoch_split(history, val_s)
    hooked = Counter()
    for (kname, _, _, _), n in calls.items():
        hooked[kname] += n
    ok = bool(len(history) == 2 and all(
        np.isfinite(history[c]).all()
        for c in ('train_loss_gen', 'val_loss_gen'))
        and launches == {'small_reflect_conv': 16, 'reflect_conv': body,
                         'reflect_conv_wgrad': wgrad}
        and dict(hooked) == {k: v for k, v in launches.items()
                             if v and k != 'reflect_conv_wgrad'})
    emit(phase='bias_train_loop', feed='BatchHandlerMom1 over '
         'DataHandlerNCforCCwithPowerLaw corrected by qdm_bc', epochs=2,
         batches_per_epoch=4, batch=TRAIN_BATCH, wall_s=wall_s,
         epoch_s=epoch_s, validation_s_per_epoch=val_s,
         s_per_batch=per_batch, starvation_rate=handler._queue.starvation_rate,
         uncorrected_phase13=phase13, launches=launches,
         calls_by_shape=[[k, list(x), co, a, n]
                         for (k, x, co, a), n in calls.items()],
         history={c: list(history[c]) for c in history.columns},
         nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'bias-fed train loop: history, launches '
                             f'{launches} or calls {dict(hooked)} failed')
    return calls


def bias_phase(name, stream_routes, phase13):
    """Phase 15: bias correction on the card. Returns per route the
    launches and kernel calls of the corrected chunked_io pass, and the
    kernel calls of the corrected training loop."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_bias_')
    try:
        files = bias_inputs(tmp)
        # v is the same calibration as u on other data: the card alone
        fps = {f: bias_calibration(name, tmp, files['wind'], f,
                                   host=f == 'u_100m')
               for f in FWP_FEATURES}
        pr_fp = bias_calibration(name, tmp, files['pr'], 'pr', cls=PresRat)
        model = flagship('cuda')
        model.meta.update(
            input_resolution={'spatial': '12km', 'temporal': '60min'})
        model_dir = os.path.join(tmp, 'model')
        model.save(model_dir)
        del model
        per_route = bias_passes(name, tmp, model_dir, fps, pr_fp,
                                stream_routes)
        train_calls = bias_train_loop(name, tmp, fps, phase13)
        return per_route, train_calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 16: the production pipeline through the port's command line on
#: phase 14's cell, the forward pass split over two nodes
PIPE_NODES = 2
PIPE_TIMEOUT_S = 600
ROOT = os.path.dirname(os.path.abspath(__file__))


def node_dispatches(strategy, node):
    """The device batches of one node's chunks (``stream_dispatches``'s
    count for the node's share)."""
    fwp = ForwardPass(strategy, node)
    shapes = Counter(fwp.get_input_chunk(int(i)).input_data.shape
                     for i in strategy.node_chunks[node])
    return sum(-(-n // STREAM_BATCH) for n in shapes.values())


def run_cli(run_dir, *args):
    """``sup3r_tpu_torch/cli.py`` as a user runs it from ``run_dir``,
    with no ``PYTHONPATH``: the nodes find the port by themselves.
    Returns (wall s, stderr); a non-zero exit raises."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'sup3r_tpu_torch', 'cli.py'),
         *args], cwd=run_dir, env=env, capture_output=True, text=True,
        timeout=PIPE_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f'cli {args} exited {proc.returncode}:\n'
                             f'{proc.stderr[-4000:]}')
    return wall_s, proc.stderr


def step_walls(stderr):
    """{step module: s} from the pipeline's ``finished in`` lines."""
    out = {}
    for line in stderr.splitlines():
        if 'finished in' in line and 'Pipeline step' in line:
            key = line.split('"')[1].split('#')[0]
            out[key] = float(line.rsplit('finished in ', 1)[1].split()[0])
    return out


def pipeline_configs(run_dir, input_file, model_dir):
    """The four configs of the run: forward-pass (chunked_io, NetCDF out,
    two nodes, a log file each), data-collect (``CollectorNC`` to one
    file), qa (no ``qa_fp``: the card's machine has no h5py) and the
    pipeline. No config names a device: nodes take the card."""
    cfgs = {
        'config_fwp.json': {
            'file_paths': input_file, 'model_kwargs': {'model_dir': model_dir},
            'fwp_chunk_shape': list(STREAM_CHUNK), 'spatial_pad': STREAM_PAD,
            'temporal_pad': STREAM_PAD, 'device_batch_size': STREAM_BATCH,
            'chunked_io': True, 'max_nodes': PIPE_NODES,
            'out_pattern': './out/chunk_{file_id}.nc',
            'log_file': './logs/fwp_{node_index}.log',
            'execution_control': {'option': 'local'}},
        'config_collect.json': {'file_paths': './out/chunk_*.nc',
                                'out_file': './collected.nc'},
        'config_qa.json': {'source_file_paths': input_file,
                           'out_file_path': './collected.nc',
                           's_enhance': 3, 't_enhance': 4,
                           'features': FWP_FEATURES,
                           'temporal_coarsening_method': 'average'},
        'config_pipeline.json': {'pipeline': [
            {'forward-pass': 'config_fwp.json'},
            {'data-collect': 'config_collect.json'},
            {'qa': 'config_qa.json'}]}}
    for name, cfg in cfgs.items():
        with open(os.path.join(run_dir, name), 'w') as f:
            json.dump(cfg, f)
    return os.path.join(run_dir, 'config_pipeline.json')


def node_summaries(run_dir):
    """The ``Node summary`` line of each forward-pass node's log."""
    out = []
    for i in range(PIPE_NODES):
        with open(os.path.join(run_dir, 'logs', f'fwp_{i}.log')) as f:
            line = next(x for x in f if 'Node summary' in x)
        out.append(json.loads(line.split('Node summary: ', 1)[1]))
    return out


def read_collected(path):
    data = LoaderNC(path).data
    return np.stack([data[f] for f in FWP_FEATURES], axis=-1)


def pipeline_flops(name, request_ms):
    """``estimate_flops`` of one flagship ``generate`` at phase 3's
    shape on the card and on the CPU (the same weights): the counts must
    be equal (the card's fused tail reports its kernel's convolution)."""
    lr = np.random.default_rng(0).standard_normal(LR_SHAPE).astype(
        np.float32) * 0.3 + 0.5
    counts = {}
    for device in ('cuda', 'cpu'):
        model = flagship(device)
        zero_counts()
        counts[device] = estimate_flops(model.generate, lr)
        launches = launch_counts()
        if device == 'cuda' and launches['small_reflect_conv'] != 1:
            raise AssertionError(f'flops: the card generate launched '
                                 f'{launches}')
        del model
    ok = counts['cuda'] == counts['cpu'] > 0
    emit(phase='pipeline_flops', lr_shape=list(LR_SHAPE),
         flops=counts['cuda'], cpu_flops=counts['cpu'],
         median_request_ms=request_ms,
         implied_tflops=counts['cuda'] / (request_ms / 1e3) / 1e12,
         nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'flops: card {counts["cuda"]} vs CPU '
                             f'{counts["cpu"]}')
    return counts['cuda']


def pipeline_phase(name, stream_routes, request_ms):
    """Phase 16: phase 14's cell through the port's command line
    (forward-pass on two nodes, data-collect, qa; then a rerun), held to
    an in-process pass on the card and to the CPU. Returns the kernels'
    launches of the CLI nodes and of the in-process pass."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_pipeline_')
    try:
        rng = np.random.default_rng(0)
        s1, s2, t = STREAM_DOMAIN
        input_file = make_fake_nc_file(
            os.path.join(tmp, 'stream.nc'), STREAM_DOMAIN, FWP_FEATURES,
            data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
                  for f in FWP_FEATURES})
        model = flagship('cuda')
        model.meta.update(
            input_resolution={'spatial': '12km', 'temporal': '60min'})
        model_dir = os.path.join(tmp, 'model')
        model.save(model_dir)
        del model
        run_dir = os.path.join(tmp, 'run')
        os.makedirs(run_dir)
        pipe_fp = pipeline_configs(run_dir, input_file, model_dir)
        torch.cuda.empty_cache()

        # the run, then a rerun that must start no node
        wall_s, stderr = run_cli(run_dir, '-c', pipe_fp, 'pipeline',
                                 '--monitor')
        walls = step_walls(stderr)
        status_fp = os.path.join(run_dir, '.status.json')
        with open(status_fp) as f:
            status = json.load(f)
        jobs = {j: rec for k, v in status.items() if not k.startswith('__')
                for j, rec in v.items()}
        if len(jobs) != PIPE_NODES + 2 or any(
                r['job_status'] != 'successful' for r in jobs.values()):
            raise AssertionError(f'pipeline: jobs {jobs}')
        nodes = node_summaries(run_dir)
        logs = sorted(glob.glob(os.path.join(run_dir, 'logs', '*')))
        stamps = {p: os.path.getmtime(p) for p in logs}
        rerun_s, rerun_err = run_cli(run_dir, '-c', pipe_fp, 'pipeline',
                                     '--monitor')
        with open(status_fp) as f:
            rerun_ok = (json.load(f) == status
                        and rerun_err.count('already successful') == 3
                        and {p: os.path.getmtime(p) for p in glob.glob(
                            os.path.join(run_dir, 'logs', '*'))} == stamps)
        if not rerun_ok:
            raise AssertionError(f'pipeline rerun started work:\n'
                                 f'{rerun_err[-3000:]}')

        # the same strategy in-process on the card: equal output, and
        # the small kernel once per dispatch in every node
        def make(out, device='cuda', max_nodes=PIPE_NODES):
            return stream_strategy(input_file, model_dir, out,
                                   device=device, chunked_io=True,
                                   max_nodes=max_nodes)

        plan = make(None)
        per_node = [node_dispatches(plan, i) for i in range(PIPE_NODES)]
        out_dir = os.path.join(tmp, 'in_process')
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strategy = make(os.path.join(out_dir, 'chunk_{file_id}.nc'))
        # the blocks the gate sends to reflect_conv in each node's share
        per_node_gated = []
        for i in range(PIPE_NODES):
            before = gated()
            ForwardPass.run(strategy, i)
            per_node_gated.append(gated() - before)
        torch.cuda.synchronize()
        in_process_s = time.perf_counter() - t0
        launches = launch_counts()
        check_fwp_launches('default', launches, sum(per_node))
        for i, node in enumerate(nodes):
            want = {'small_reflect_conv': per_node[i],
                    'reflect_conv': per_node_gated[i]}
            if node['launches'] != want or not per_node[i]:
                raise AssertionError(f'pipeline node {i}: launches '
                                     f'{node["launches"]}, expected {want}')
        hr_shape, full = check_fwp_files(strategy, out_dir, keep=True,
                                         domain=STREAM_DOMAIN)
        collected = read_collected(os.path.join(run_dir, 'collected.nc'))
        err = float(np.abs(collected - full).max())
        tol = 1e-6 * float(np.abs(full).max())

        # one chunk of the collected file against the port's CPU pass
        cpu = make(None, device='cpu', max_nodes=1)
        _, want = ForwardPass(cpu, 0).run_chunk(
            ForwardPass(cpu, 0).get_input_chunk(0))
        s_idx, t_idx = cpu.fwp_slicer.get_chunk_indices(0)
        s_hr = cpu.fwp_slicer.s_hr_slices[s_idx]
        t_lr = cpu.fwp_slicer.t_lr_slices[t_idx]
        got = collected[s_hr[0], s_hr[1], t_lr.start * 4:t_lr.stop * 4]
        cpu_err = float(np.abs(got - want).max())
        cpu_tol = PARITY_RTOL * float(np.abs(want).max())

        # QA of the collected file on the card against the CPU
        qa = {}
        for device in ('cuda', 'cpu'):
            t0 = time.perf_counter()
            qa[device] = Sup3rQa(input_file, os.path.join(
                run_dir, 'collected.nc'), s_enhance=3, t_enhance=4,
                features=FWP_FEATURES, device=device).run()
            qa[f'{device}_s'] = time.perf_counter() - t0
        qa_errs = {k: float(np.abs(qa['cuda'][k] - v).max())
                   / max(float(np.abs(v).max()), 1e-30)
                   for k, v in qa['cpu'].items()}
        hr_voxels = int(np.prod(hr_shape))
        phase14 = float(np.median(
            stream_routes['default']['wall_s']['chunked_io']))
        ok = (err <= tol and cpu_err <= cpu_tol and got.shape == want.shape
              and max(qa_errs.values()) <= 1e-5
              and set(walls) == {'forward-pass', 'data-collect', 'qa'})
        emit(phase='pipeline', io=STREAM_IO, nodes=PIPE_NODES,
             pipeline_wall_s=wall_s, step_wall_s=walls, rerun_wall_s=rerun_s,
             node_startup_s=[n['startup_s'] for n in nodes],
             node_import_s=[n['import_s'] for n in nodes],
             node_run_s=[n['run_s'] for n in nodes],
             node_launches=[n['launches'] for n in nodes],
             node_dispatches=per_node, hr_shape=hr_shape,
             cli_fwp_hr_voxels_per_s=hr_voxels / walls.get(
                 'forward-pass', float('nan')),
             in_process_two_node_s=in_process_s,
             in_process_hr_voxels_per_s=hr_voxels / in_process_s,
             phase14_chunked_io_median_s=phase14,
             phase14_hr_voxels_per_s=hr_voxels / phase14,
             in_process_launches=launches,
             collected_vs_in_process_max_abs_err=err, tol=tol,
             cpu_chunk_max_abs_err=cpu_err, cpu_tol=cpu_tol,
             qa_card_vs_cpu_rel_err=qa_errs, qa_card_s=qa['cuda_s'],
             qa_cpu_s=qa['cpu_s'], nvidia_smi=name, ok=ok)
        if not ok:
            raise AssertionError(
                f'pipeline: collected vs in-process {err} > {tol}, chunk vs '
                f'CPU {cpu_err} > {cpu_tol}, QA {qa_errs} or steps {walls}')
        flops = pipeline_flops(name, request_ms)
        return {'nodes': [n['launches'] for n in nodes],
                'in_process': launches, 'flops': flops,
                'collected': collected}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 17: the mesh slice (``sup3r_tpu_torch.parallel``, one process
#: per device). (a) a world of one over NCCL in this process: the
#: training cell's step with and without ``attach_mesh`` (fp32 and bf16),
#: the all-reduce of its gradients, and phase 14's cell with ``use_mesh``
#: True and 'spatial'; (b) two ranks on the one card over gloo (NCCL
#: cannot put two ranks on one device), each a process of its own
#: (``spawn_ranks``: this script with ``--mesh-rank``): the data-parallel
#: step and phase 14's cell split 10 / 10 rows a chunk
MESH_RANKS = 2
MESH_RANK_TIMEOUT_S = 420
MESH_TIMED_STEPS = 4
MESH_TIMED_PASSES = 2
MESH_EQUAL_RTOL = 1e-6
MESH_STEP_RTOL, MESH_STEP_ATOL = 2e-4, 1e-6
MESH_SPATIAL_ATOL = 1e-4
#: the HR tail's input in a rank's step of (b): 8 of the cell's 16 rows
MESH_TAIL_SHAPE = (TRAIN_BATCH // MESH_RANKS, 8) + TRAIN_HR[:3]
#: the padded LR rows of phase 14's chunks (interior 16 + 4, edge 8 + 4):
#: the spatial pass's gathered tail holds 3 x one of them
MESH_GATHERED_ROWS = (STREAM_CHUNK[0] + 2 * STREAM_PAD,
                      STREAM_DOMAIN[0] % STREAM_CHUNK[0] + 2 * STREAM_PAD)


def mesh_step(model, lr, hr):
    """One timed step of the training cell (the losses' fetch waits for
    the device); returns (losses, launches, ms)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = model.run_gradient_descent(lr, hr, W_ADV, True, True)
    ms = 1e3 * (time.perf_counter() - t0)
    launches = launch_counts()
    check_wgrad('mesh step', launches)
    return losses, launches, ms


def step_params(model):
    return [p.detach().clone() for p in (*model.gen_params,
                                         *model.disc_params)]


def mesh_step_pair(name, mesh, dtype):
    """Phase 17a: the flagship's step at the training cell (Adam epsilon
    1, as phase 7's checks) from one init, without a mesh and with the
    world-of-one mesh attached: losses and params within 1e-6 relative;
    then the step ms each way. Returns the unmeshed step's losses and
    params (fp32: phase 17b's reference) and the meshed launches."""
    lr_np, hr_np = train_batch(TRAIN_BATCH)
    lr, hr = (torch.as_tensor(a, device='cuda') for a in (lr_np, hr_np))
    got, times = {}, {}
    for label in ('plain', 'mesh'):
        model = train_model('cuda', CHECK_OPT)
        model.train_dtype = dtype
        if label == 'mesh':
            model.attach_mesh(mesh)
        losses, launches, _ = mesh_step(model, lr, hr)
        got[label] = (losses, step_params(model), launches)
        times[label] = [mesh_step(model, lr, hr)[2]
                        for _ in range(MESH_TIMED_STEPS)]
        del model
    (l_plain, p_plain, _), (l_mesh, p_mesh, launches) = (got['plain'],
                                                         got['mesh'])
    loss_err = max(abs(l_mesh[k] - l_plain[k]) / abs(l_plain[k])
                   for k in l_plain)
    param_err = rel_err(p_mesh, p_plain)
    # a bf16 tail is never the fp32-only small kernel's
    ok = bool(loss_err <= MESH_EQUAL_RTOL and param_err <= MESH_EQUAL_RTOL
              and launches['small_reflect_conv'] == (0 if dtype else 1))
    emit(phase='mesh_world_of_one_step', train_dtype=dtype,
         backend=mesh.backend,
         batch=TRAIN_BATCH, lr_shape=list(TRAIN_LR), hr_shape=list(TRAIN_HR),
         losses=l_mesh, loss_rel_err=loss_err, param_rel_err=param_err,
         tol=MESH_EQUAL_RTOL, step_ms=times['mesh'],
         plain_step_ms=times['plain'],
         median_step_ms=float(np.median(times['mesh'])),
         plain_median_step_ms=float(np.median(times['plain'])),
         launches_per_step=launches, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'mesh step ({dtype}): {loss_err} / '
                             f'{param_err} vs the unmeshed step, launches '
                             f'{launches}')
    return l_plain, p_plain, launches


def mesh_allreduce_ms(name, mesh, iters=20):
    """Phase 17a: the step's gradient all-reduce (both networks' grads,
    one flat buffer) by CUDA events, on the world-of-one NCCL mesh."""
    model = train_model('cuda')
    grads = [torch.randn_like(p) for p in (*model.gen_params,
                                           *model.disc_params)]
    del model
    all_reduce_(mesh, grads)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        all_reduce_(mesh, grads)
    end.record()
    torch.cuda.synchronize()
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    ms = start.elapsed_time(end) / iters
    emit(phase='mesh_allreduce', backend=mesh.backend, ranks=mesh.size,
         bytes=nbytes, tensors=len(grads), ms=ms, nvidia_smi=name)
    return ms


def mesh_pass(make_strategy, out_dir):
    """One timed ``ForwardPass.run`` of phase 14's cell to NetCDF;
    returns (wall s, launches, the strategy, the pass's mesh
    counters)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strategy = make_strategy(os.path.join(out_dir, 'chunk_{file_id}.nc'))
    RecordedForwardPass.run(strategy, 0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    mesh = RecordedForwardPass.last.mesh
    counters = dict(mesh.counters) if mesh is not None else {}
    return wall_s, launches, strategy, counters


def stitched(strategy, out_dir):
    return check_fwp_files(strategy, out_dir, keep=True,
                           domain=STREAM_DOMAIN)[1]


def mesh_cell(tmp):
    """Phase 14's cell: the flagship saved, the (40, 40, 40) NetCDF3
    input drawn as phase 14 draws it."""
    model = flagship('cuda')
    model.meta.update(
        input_resolution={'spatial': '12km', 'temporal': '60min'})
    model_dir = os.path.join(tmp, 'model')
    model.save(model_dir)
    rng = np.random.default_rng(0)
    s1, s2, t = STREAM_DOMAIN
    input_file = make_fake_nc_file(
        os.path.join(tmp, 'stream.nc'), STREAM_DOMAIN, FWP_FEATURES,
        data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
              for f in FWP_FEATURES})
    return model, model_dir, input_file


def mesh_halo_estimate(model, strategy, ranks):
    """``estimate_halo_bytes`` summed over a pass's dispatches: each
    batch of same-shaped padded chunks is one generator application on
    ``STREAM_BATCH`` chunks (partial batches are padded)."""
    fwp = ForwardPass(strategy, 0)
    shapes = Counter(fwp.get_input_chunk(i).input_data.shape
                     for i in range(strategy.fwp_slicer.n_chunks))
    return sum(-(-n // STREAM_BATCH) * STREAM_BATCH * estimate_halo_bytes(
        model, shape, ranks) for shape, n in shapes.items())


def mesh_world_of_one_passes(name, tmp, model_dir, input_file):
    """Phase 17a: phase 14's cell by default, with use_mesh=True and with
    use_mesh='spatial' on the world of one (a warm-up, then timed
    passes): True equal to the default, 'spatial' within 1e-4."""
    def make(use_mesh):
        return lambda out: stream_strategy(input_file, model_dir, out,
                                           use_mesh=use_mesh)

    n_dispatch = stream_dispatches(make(False)(None))
    rec = {}
    for mode in (False, True, 'spatial'):
        mesh_pass(make(mode), os.path.join(tmp, f'warm_{mode}'))
        walls = []
        for i in range(MESH_TIMED_PASSES):
            out_dir = os.path.join(tmp, f'pass_{mode}_{i}')
            wall, launches, strategy, _ = mesh_pass(make(mode), out_dir)
            walls.append(wall)
        rec[mode] = dict(wall_s=walls, launches=launches, gated=gated(),
                         full=stitched(strategy, out_dir))
    # a world of one is below the shard-aligned gate: the spatial pass
    # gathers the tail's input over its one rank and launches the kernel
    want = {False: n_dispatch, True: n_dispatch, 'spatial': n_dispatch}
    errs = {str(mode): float(np.abs(rec[mode]['full']
                                    - rec[False]['full']).max())
            for mode in (True, 'spatial')}
    ok = bool(errs['True'] == 0.0 and errs['spatial'] <= MESH_SPATIAL_ATOL
              and all(rec[m]['launches']['small_reflect_conv'] == want[m]
                      and rec[m]['launches']['reflect_conv']
                      == rec[m]['gated'] for m in rec)
              and rec['spatial']['gated'] == 0)
    emit(phase='mesh_world_of_one_pass', io=STREAM_IO,
         backend=dist.get_backend(), dispatches=n_dispatch,
         wall_s={str(m): rec[m]['wall_s'] for m in rec},
         launches_per_pass={str(m): rec[m]['launches'] for m in rec},
         max_abs_err_vs_default=errs, tol=MESH_SPATIAL_ATOL,
         nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'mesh passes (world of one): errors {errs}, '
                             f'launches {[rec[m]["launches"] for m in rec]}')
    return rec


def mesh_rank_step(rank, world, out):
    """Phase 17b, in a rank: the fp32 step of phase 17a on this rank's
    rows of the training cell's batch, then timed steps."""
    model = train_model('cuda', CHECK_OPT)
    model.attach_mesh(get_mesh())
    lr_np, hr_np = train_batch(TRAIN_BATCH)
    n = TRAIN_BATCH // world
    lr, hr = (torch.as_tensor(a[rank * n:(rank + 1) * n], device='cuda')
              for a in (lr_np, hr_np))
    model._mesh.reset_counters()
    losses, launches, _ = mesh_step(model, lr, hr)
    counters = dict(model._mesh.counters)
    params = [p.cpu().numpy() for p in step_params(model)]
    times = [mesh_step(model, lr, hr)[2] for _ in range(MESH_TIMED_STEPS)]
    return {'losses': losses, 'launches': launches, 'params': params,
            'step_ms': times, 'counters': counters,
            'device': torch.cuda.get_device_name(0)}


def mesh_rank_pass(rank, world, out):
    """Phase 17b, in a rank: phase 14's cell with use_mesh='spatial' over
    the ranks (a warm-up, then timed passes to a directory every rank
    writes its chunks to); the launches and halo counters of the last,
    and the shapes the kernel's wrapper took in it (the gathered tail:
    below the shard-aligned gate)."""
    with open(os.path.join(out, 'cell.json')) as f:
        cell = json.load(f)
    calls = Counter()
    launch = fuse_module.small_reflect_conv_cf

    def recorded(x, weight, bias, alpha=None):
        calls[(tuple(x.shape), weight.shape[0], alpha)] += 1
        return launch(x, weight, bias, alpha)

    fuse_module.small_reflect_conv_cf = recorded
    walls = []
    try:
        for i in range(1 + MESH_TIMED_PASSES):
            calls.clear()
            wall, launches, _, counters = mesh_pass(
                lambda o: stream_strategy(cell['input_file'],
                                          cell['model_dir'], o,
                                          use_mesh='spatial'),
                os.path.join(out, f'spatial_{i}'))
            walls.append(wall)
    finally:
        fuse_module.small_reflect_conv_cf = launch
    return {'wall_s': walls[1:], 'launches': launches, 'counters': counters,
            'calls': dict(calls)}


MESH_RANK_SCENARIOS = {'step': mesh_rank_step, 'pass': mesh_rank_pass}


def mesh_two_ranks(name, tmp, cell, ref_step, default_full):
    """Phase 17b: two ranks on the card over gloo, each its own process:
    the DP step against phase 17a's unmeshed step (rtol 2e-4, atol
    1e-6), the spatial pass against the default pass (1e-4), the halo
    bytes the ranks sent against ``estimate_halo_bytes``."""
    model, model_dir, input_file = cell
    run_dir = os.path.join(tmp, 'ranks')
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, 'cell.json'), 'w') as f:
        json.dump({'model_dir': model_dir, 'input_file': input_file}, f)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks([sys.executable, os.path.abspath(__file__), '--mesh-rank',
                 run_dir], MESH_RANKS, run_dir, timeout=MESH_RANK_TIMEOUT_S,
                attempts=1)
    spawn_s = time.perf_counter() - t0
    ranks = rank_results(run_dir, MESH_RANKS)
    for res in ranks:
        for key in MESH_RANK_SCENARIOS:
            if 'error' in res[key]:
                raise AssertionError(f'mesh rank {key}: {res[key]["error"]}')
    steps = [res['step'] for res in ranks]
    l_ref, p_ref = ref_step
    loss_err = max(abs(steps[0]['losses'][k] - l_ref[k]) for k in l_ref)
    # every rank the same losses; losses and params within the bar
    step_ok = all(s['losses'] == steps[0]['losses'] for s in steps) and all(
        np.isclose(steps[0]['losses'][k], l_ref[k], rtol=MESH_STEP_RTOL,
                   atol=MESH_STEP_ATOL) for k in l_ref)
    param_err = 0.0
    for got, want in zip(steps[0]['params'], p_ref):
        want = want.cpu().numpy()
        param_err = max(param_err, float(np.abs(got - want).max()))
        step_ok = step_ok and np.allclose(got, want, rtol=MESH_STEP_RTOL,
                                          atol=MESH_STEP_ATOL)
    emit(phase='mesh_two_ranks_step', backend='gloo', ranks=MESH_RANKS,
         devices=[s['device'] for s in steps], batch_per_rank=TRAIN_BATCH
         // MESH_RANKS, losses=steps[0]['losses'],
         max_abs_loss_err=loss_err, max_abs_param_err=param_err,
         rtol=MESH_STEP_RTOL, atol=MESH_STEP_ATOL,
         step_ms=[s['step_ms'] for s in steps],
         launches_per_step=[s['launches'] for s in steps],
         collective_bytes=[s['counters'] for s in steps],
         spawn_s=spawn_s, nvidia_smi=name, ok=step_ok)
    if not step_ok:
        raise AssertionError(f'two-rank DP step vs the unmeshed step: loss '
                             f'{loss_err}, params {param_err}')
    passes = [res['pass'] for res in ranks]
    strategy = stream_strategy(input_file, model_dir, os.path.join(
        run_dir, f'spatial_{MESH_TIMED_PASSES}', 'chunk_{file_id}.nc'))
    n_dispatch = stream_dispatches(strategy)
    full = stitched(strategy, os.path.dirname(strategy.out_pattern))
    err = float(np.abs(full - default_full).max())
    sent = [p['counters'].get('halo_bytes', 0) for p in passes]
    estimate = mesh_halo_estimate(model, strategy, MESH_RANKS)
    ratio = sum(sent) / estimate
    # below the shard-aligned gate every rank gathers the tail's input
    # (all the HR rows: 3 x the padded LR rows) and launches the small
    # kernel on it once a dispatch
    whole = [3 * rows for rows in MESH_GATHERED_ROWS]
    route_ok = all(
        p['launches']['small_reflect_conv'] == n_dispatch
        and sum(p['calls'].values()) == n_dispatch
        and all(x_shape[2] in whole for x_shape, _, _ in p['calls'])
        for p in passes)
    pass_ok = bool(err <= MESH_SPATIAL_ATOL and 0.2 < ratio < 5 and all(
        p['launches']['reflect_conv'] == 0 for p in passes) and route_ok)
    emit(phase='mesh_two_ranks_pass', io=STREAM_IO, backend='gloo',
         ranks=MESH_RANKS, use_mesh='spatial',
         padded_rows_per_rank=(STREAM_CHUNK[0] + 2 * STREAM_PAD)
         // MESH_RANKS, wall_s=[p['wall_s'] for p in passes],
         launches_per_pass=[p['launches'] for p in passes],
         halo_bytes_sent=sent, halo_ops=[p['counters'].get('halo_ops', 0)
                                         for p in passes],
         gather_bytes=[p['counters'].get('gather_bytes', 0)
                       for p in passes],
         halo_bytes_estimate=estimate, halo_ratio=ratio,
         rows_bytes=[p['counters'].get('rows_bytes', 0) for p in passes],
         dispatches=n_dispatch,
         gathered_tail_calls=[[[list(k[0]), k[1], k[2], v]
                               for k, v in p['calls'].items()]
                              for p in passes],
         max_abs_err_vs_default=err, tol=MESH_SPATIAL_ATOL,
         nvidia_smi=name, ok=pass_ok)
    if not pass_ok:
        raise AssertionError(
            f'two-rank spatial pass: error {err}, halo ratio {ratio}, '
            f'launches {[p["launches"] for p in passes]} and wrapper calls '
            f'{[p["calls"] for p in passes]} for {n_dispatch} dispatches')
    return steps, passes


def mesh_phase(name):
    """Phase 17: the mesh slice, (a) then (b). Returns the launches of
    the meshed paths for the ``kernels`` line and the small kernel's
    calls by shape in each rank's spatial pass of (b)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_mesh_')
    store = os.path.join(ROOT, 'build', f'mesh_store_{os.getpid()}')
    os.makedirs(os.path.dirname(store), exist_ok=True)
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    try:
        init_multihost(f'file://{store}', 1, 0)
        mesh = get_mesh()
        ref_step, launches = None, {}
        for dtype in (None, 'bfloat16'):
            l_plain, p_plain, per_step = mesh_step_pair(name, mesh, dtype)
            launches[f'mesh_{dtype or "fp32"}_train_step'] = per_step
            if dtype is None:
                ref_step = (l_plain, p_plain)
        mesh_allreduce_ms(name, mesh)
        cell = mesh_cell(tmp)
        rec = mesh_world_of_one_passes(name, tmp, *cell[1:])
        for mode in (True, 'spatial'):
            launches[f'world_of_one_{mode}_pass'] = rec[mode]['launches']
        dist.destroy_process_group()
        steps, passes = mesh_two_ranks(name, tmp, cell, ref_step,
                                       rec[False]['full'])
        launches['two_rank_train_step'] = [s['launches'] for s in steps]
        launches['two_rank_spatial_pass'] = [p['launches'] for p in passes]
        return launches, [p['calls'] for p in passes]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        if os.path.exists(store):
            os.remove(store)


#: phase 18: dp x sp training. Four ranks share the card over gloo (this
#: script with ``--mesh2d-rank``); on each mesh three gated steps of the
#: training cell from phase 7's init, held to the unmeshed step on the
#: card from the same start
MESH2D_RANKS = 4
MESH2D_MESHES = ((2, 2), (1, 4))
MESH2D_TIMED_STEPS = 2
MESH2D_RANK_TIMEOUT_S = 600
#: the halo conv's gradient check: a flagship body block's input (LR s1
#: 12 rows as four ranks hold it)
HALO_GRAD_SHAPE = (4, 64, 12, 12, 48)
HALO_GRAD_BLOCKS = (3, 3, 3, 3)


def halo_grad_check(name):
    """Phase 18: ``reflect_conv_halo`` on blocks of s1 rows, each block's
    halo rows slices of its neighbours' (so autograd hands their
    gradients back to their owners, as the halo exchange's backward
    does across ranks): dx, dw and db against ``reflect_conv_ad``'s on
    the card, within 1e-5 of each gradient's max (phase 7's bar for the
    unsharded block)."""
    gen = torch.Generator(device='cuda').manual_seed(18)
    c = HALO_GRAD_SHAPE[1]
    x = torch.randn(HALO_GRAD_SHAPE, generator=gen, device='cuda')
    w = 0.05 * torch.randn((c, c, 3, 3, 3), generator=gen, device='cuda')
    b = 0.1 * torch.randn(c, generator=gen, device='cuda')
    dy = torch.randn(HALO_GRAD_SHAPE, generator=gen, device='cuda')

    def grads(fn):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        with exact_fp32():
            (fn(xs, ws, bs) * dy).sum().backward()
        return [xs.grad, ws.grad, bs.grad]

    def blocks(xs, ws, bs):
        parts = list(xs.split(list(HALO_GRAD_BLOCKS), dim=2))
        return torch.cat([reflect_conv_halo(
            part, ws, bs, 3, 0.2,
            None if i == 0 else parts[i - 1][:, :, -1:],
            None if i == len(parts) - 1 else parts[i + 1][:, :, :1])
            for i, part in enumerate(parts)], dim=2)

    want = grads(lambda xs, ws, bs: reflect_conv_ad(xs, ws, bs, 3, 0.2))
    errs = {k: float((g - r).abs().max() / r.abs().max())
            for k, g, r in zip(('dx', 'dw', 'db'), grads(blocks), want)}
    ok = all(e <= KERNEL_RTOL for e in errs.values())
    emit(phase='mesh2d_halo_grad_check', shape=list(HALO_GRAD_SHAPE),
         blocks=list(HALO_GRAD_BLOCKS), rel_err_to_max=errs,
         tol=KERNEL_RTOL, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'reflect_conv_halo gradients: {errs}')
    return errs


@contextlib.contextmanager
def exchange_log():
    """[(kind, thread name)] of the halo and row exchanges this process
    issues inside the block, in order (the backward's run in autograd's
    device thread while the calling thread waits in
    ``torch.autograd.grad``)."""
    log, inner = [], mesh_module._exchange

    def exchange(mesh, group, sends, recvs, like, kind):
        log.append((kind, threading.current_thread().name))
        return inner(mesh, group, sends, recvs, like, kind)

    mesh_module._exchange = exchange
    try:
        yield log
    finally:
        mesh_module._exchange = inner


def flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in (
        *model.gen_params, *model.disc_params)]).cpu().numpy()


def step_errors(model, losses, ref):
    """(loss rel errors, max param error relative to each param's
    largest magnitude (at least atol / rtol: a param near 0 everywhere,
    as the last bias is, has no relative error of its own), the worst
    |got - want| / (atol + rtol |want|), ok) of a step against the
    reference's losses and flat params."""
    loss_err = {k: abs(losses[k] - ref['losses'][k]) / abs(ref['losses'][k])
                for k in ref['losses']}
    got, want = flat_params(model), ref['params']
    diff = np.abs(got - want)
    bar = float(np.max(diff / (MESH_STEP_ATOL + MESH_STEP_RTOL
                               * np.abs(want))))
    rel, start = 0.0, 0
    for p in (*model.gen_params, *model.disc_params):
        n = p.numel()
        rel = max(rel, float(diff[start:start + n].max()
                             / max(np.abs(want[start:start + n]).max(),
                                   MESH_STEP_ATOL / MESH_STEP_RTOL)))
        start += n
    ok = bar <= 1 and all(
        np.isclose(losses[k], ref['losses'][k], rtol=MESH_STEP_RTOL,
                   atol=MESH_STEP_ATOL) for k in ref['losses'])
    return loss_err, rel, bar, bool(ok)


def mesh2d_rank_steps(rank, world, out):
    """Phase 18, in a rank: on each mesh, the gated steps of the training
    cell from phase 7's init on this rank's block, each against the
    unmeshed step (saved by the parent) and its exchanged bytes against
    the analytic count; then timed steps and the gradient reductions."""
    lr_np, hr_np = train_batch(TRAIN_BATCH)
    res = {}
    for dp, sp in MESH2D_MESHES:
        mesh = get_mesh_2d(dp, sp)
        model = train_model('cuda', CHECK_OPT)
        model.attach_mesh(mesh)
        lr, hr = shard_batch_spatial(mesh, lr_np, hr_np)
        steps = {}
        for gate, (do_gen, do_disc) in GATES.items():
            mesh.reset_counters()
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with exchange_log() as log:
                losses = model.run_gradient_descent(lr, hr, W_ADV, do_gen,
                                                    do_disc)
            ms = 1e3 * (time.perf_counter() - t0)
            launches = launch_counts()
            check_wgrad(f'{dp} x {sp} mesh, {gate} step', launches)
            counters = dict(mesh.counters)
            with open(os.path.join(out, f'ref_{gate}.json')) as f:
                ref = {'losses': json.load(f),
                       'params': np.load(os.path.join(out,
                                                      f'ref_{gate}.npy'))}
            loss_err, rel, bar, ok = step_errors(model, losses, ref)
            want = expected_exchange_bytes(
                model, lr_np.shape, hr_np.shape, dp, sp,
                mesh.axis_index('space'), do_gen, do_disc)
            steps[gate] = {
                'losses': losses, 'loss_rel_err': loss_err,
                'param_rel_err': rel, 'bar_ratio': bar, 'ok': ok,
                'ms': ms, 'launches': launches, 'counters': counters,
                'want_bytes': want, 'order': [k for k, _ in log],
                'threads': sorted({t for _, t in log})}
        timed = [mesh_step(model, lr, hr)[2]
                 for _ in range(MESH2D_TIMED_STEPS)]
        grads = ([torch.randn_like(p) for p in model.gen_params],
                 [torch.randn_like(p) for p in model.disc_params])
        mesh.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._reduce_grads(grads[0], model.generator)
        model._reduce_grads(grads[1], model.discriminator)
        torch.cuda.synchronize()
        res[f'{dp}x{sp}'] = {
            'coords': mesh.coords, 'aligned': model._auto_shard_aligned(),
            'block': [list(lr.shape), list(hr.shape)], 'steps': steps,
            'step_ms': timed,
            'allreduce_ms': 1e3 * (time.perf_counter() - t0),
            'allreduce_bytes': mesh.counters['allreduce_bytes'],
            'allreduce_ops': mesh.counters['allreduce_ops'],
            'device': torch.cuda.get_device_name(0)}
        del model, grads
        torch.cuda.empty_cache()
    return res


MESH2D_RANK_SCENARIOS = {'steps': mesh2d_rank_steps}


def mesh2d_phase(name):
    """Phase 18: the halo conv's gradient check, the unmeshed reference
    steps (saved for the ranks), then four ranks on the 2 x 2 and 1 x 4
    meshes. Returns the launches for the ``kernels`` line."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_mesh2d_')
    try:
        halo_grad_check(name)
        model = train_model('cuda', CHECK_OPT)
        lr_np, hr_np = train_batch(TRAIN_BATCH)
        lr, hr = (torch.as_tensor(a, device='cuda') for a in (lr_np, hr_np))
        ref_launches, ref_ms = {}, {}
        for gate, (do_gen, do_disc) in GATES.items():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = model.run_gradient_descent(lr, hr, W_ADV, do_gen,
                                                do_disc)
            ref_ms[gate] = 1e3 * (time.perf_counter() - t0)
            ref_launches[gate] = launch_counts()
            check_wgrad(f'unmeshed {gate} step', ref_launches[gate])
            np.save(os.path.join(tmp, f'ref_{gate}.npy'), flat_params(model))
            with open(os.path.join(tmp, f'ref_{gate}.json'), 'w') as f:
                json.dump(losses, f)
        del model, lr, hr
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_ranks([sys.executable, os.path.abspath(__file__),
                     '--mesh2d-rank', tmp], MESH2D_RANKS, tmp,
                    timeout=MESH2D_RANK_TIMEOUT_S, attempts=1)
        spawn_s = time.perf_counter() - t0
        ranks = rank_results(tmp, MESH2D_RANKS)
        for res in ranks:
            if 'error' in res['steps']:
                raise AssertionError(f'mesh2d rank: {res["steps"]["error"]}')
        launches = {'mesh2d_reference_train_step': ref_launches['both']}
        failed = []
        for dp, sp in MESH2D_MESHES:
            key = f'{dp}x{sp}'
            per_rank = [res['steps'][key] for res in ranks]
            checks = {}
            for gate in GATES:
                steps = [r['steps'][gate] for r in per_rank]
                checks[gate] = {
                    'same_losses': all(s['losses'] == steps[0]['losses']
                                       for s in steps),
                    'same_exchange_order': all(
                        s['order'] == steps[0]['order'] for s in steps),
                    'exchanges': len(steps[0]['order']),
                    'threads': steps[0]['threads'],
                    'within_bar': all(s['ok'] for s in steps),
                    'bytes': all(
                        s['counters'].get('halo_bytes', 0)
                        == s['want_bytes']['halo'] > 0
                        and s['counters'].get('rows_bytes', 0)
                        == s['want_bytes']['rows'] for s in steps),
                    # below the gate the small kernel's launches are
                    # the reference step's; at it, none on a block. No
                    # sharded block takes reflect_conv, which the
                    # reference's generator does in its 'disc' step
                    # (run without gradients)
                    'launches_of_the_route': all(
                        s['launches'] == (
                            {k: 0 for k in s['launches']} if sp >= 4
                            else {**ref_launches[gate], 'reflect_conv': 0,
                                  'reflect_conv_wgrad': s['launches'][
                                      'reflect_conv_wgrad']})
                        for s in steps),
                    'reference_launches': ref_launches[gate]}
            ok = all(c['same_losses'] and c['same_exchange_order']
                     and c['within_bar'] and c['bytes']
                     and c['launches_of_the_route']
                     for c in checks.values()) and all(
                r['aligned'] == (sp >= 4) for r in per_rank) and (
                ref_launches['both']['small_reflect_conv'] == 1)
            emit(phase='mesh2d_steps', mesh=key, backend='gloo',
                 ranks=MESH2D_RANKS,
                 devices=sorted({r['device'] for r in per_rank}),
                 shard_aligned=per_rank[0]['aligned'],
                 rank_block_lr_hr=per_rank[0]['block'],
                 losses={g: per_rank[0]['steps'][g]['losses']
                         for g in GATES},
                 max_loss_rel_err={g: max(max(r['steps'][g][
                     'loss_rel_err'].values()) for r in per_rank)
                     for g in GATES},
                 max_param_rel_err={g: max(r['steps'][g]['param_rel_err']
                                           for r in per_rank)
                                    for g in GATES},
                 max_bar_ratio={g: max(r['steps'][g]['bar_ratio']
                                       for r in per_rank) for g in GATES},
                 rtol=MESH_STEP_RTOL, atol=MESH_STEP_ATOL,
                 exchange_bytes={g: [[r['steps'][g]['counters'].get(
                     f'{k}_bytes', 0) for k in ('halo', 'rows')]
                     for r in per_rank] for g in GATES},
                 expected_exchange_bytes={g: [[r['steps'][g]['want_bytes'][
                     k] for k in ('halo', 'rows')] for r in per_rank]
                     for g in GATES},
                 collective_bytes_both=[r['steps']['both']['counters']
                                        for r in per_rank],
                 checked_step_ms={g: [r['steps'][g]['ms'] for r in per_rank]
                                  for g in GATES},
                 rank0_step_ms=per_rank[0]['step_ms'],
                 reference_step_ms=ref_ms,
                 grad_allreduce_ms=[r['allreduce_ms'] for r in per_rank],
                 grad_allreduce_bytes=per_rank[0]['allreduce_bytes'],
                 grad_allreduce_ops=per_rank[0]['allreduce_ops'],
                 launches_per_rank_step={g: [r['steps'][g]['launches']
                                             for r in per_rank]
                                         for g in GATES},
                 checks=checks, spawn_s=spawn_s, nvidia_smi=name, ok=ok)
            if not ok:
                failed.append(key)
            launches[f'mesh2d_{key}_train_step'] = [
                r['steps']['both']['launches'] for r in per_rank]
        if failed:
            raise AssertionError(f'dp x sp steps failed on {failed}')
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 19: phase 16's pipeline from outside the repo with its
#: forward-pass node run as a group of ranks (``ranks_per_node``): two
#: ranks sharing the card over gloo, under use_mesh True and 'spatial'
GROUP_RANKS = 2
GROUP_TIMEOUT_S = 300
GROUP_TOL = {True: 1e-6, 'spatial': 1e-4}


def flagship_gated(n, s1, s2, t):
    """How many of the flagship's 36 body blocks the gate sends to
    ``reflect_conv`` in a batch of ``n`` LR chunks of (s1, s2, t): the
    2 -> 64 block at t, the 64 -> 64 block at 2t, 34 blocks at 4t."""
    shapes = ([(n, 2, s1, s2, t), (n, 64, s1, s2, 2 * t)]
              + [(n, 64, s1, s2, 4 * t)] * (N_BODY_BLOCKS - 2))
    return sum(body_kernel_wins(on_card(shape)) for shape in shapes)


def group_dispatches(strategy, use_mesh):
    """Each rank's device batches in the group's pass: its share of the
    chunks (every n-th) in batches of ``STREAM_BATCH / n`` under True,
    every chunk in batches of ``STREAM_BATCH`` under 'spatial'; and the
    body blocks the gate sends to ``reflect_conv`` in them (none on a
    spatial mesh, whose blocks are sharded)."""
    fwp = ForwardPass(strategy, 0)
    shapes = [fwp.get_input_chunk(int(i)).input_data.shape
              for i in strategy.node_chunks[0]]
    if use_mesh == 'spatial':
        counts = Counter(shapes)
        return [sum(-(-n // STREAM_BATCH) for n in counts.values())] * (
            GROUP_RANKS), [0] * GROUP_RANKS
    batch = -(-STREAM_BATCH // GROUP_RANKS)
    dispatches, body = [], []
    for r in range(GROUP_RANKS):
        counts = Counter(shapes[r::GROUP_RANKS])
        dispatches.append(sum(-(-n // batch) for n in counts.values()))
        body.append(sum(
            (n // batch) * flagship_gated(batch, *shape[:3])
            + (flagship_gated(n % batch, *shape[:3]) if n % batch else 0)
            for shape, n in counts.items()))
    return dispatches, body


def pipeline_group_run(tmp, input_file, model_dir, use_mesh, rerun):
    """One group pipeline, and with ``rerun`` a second run that must
    start nothing (see ``pipeline_group_phase``). Returns the run
    directory and what the phase prints."""
    run_dir = os.path.join(tmp, f'run_{use_mesh}')
    os.makedirs(run_dir)
    cfg = {'file_paths': input_file, 'model_kwargs': {'model_dir': model_dir},
           'fwp_chunk_shape': list(STREAM_CHUNK), 'spatial_pad': STREAM_PAD,
           'temporal_pad': STREAM_PAD, 'device_batch_size': STREAM_BATCH,
           'chunked_io': True, 'use_mesh': use_mesh,
           'out_pattern': './out/chunk_{file_id}.nc',
           'log_file': './logs/fwp_{node_index}.log',
           'execution_control': {'option': 'local',
                                 'ranks_per_node': GROUP_RANKS,
                                 'ranks_timeout': GROUP_TIMEOUT_S}}
    with open(os.path.join(run_dir, 'config_fwp.json'), 'w') as f:
        json.dump(cfg, f)
    pipe_fp = os.path.join(run_dir, 'config_pipeline.json')
    with open(pipe_fp, 'w') as f:
        json.dump({'pipeline': [{'forward-pass': 'config_fwp.json'}]}, f)
    wall_s, stderr = run_cli(run_dir, '-c', pipe_fp, 'pipeline',
                             '--monitor')
    step_s = step_walls(stderr).get('forward-pass')
    status_fp = os.path.join(run_dir, '.status.json')
    with open(status_fp) as f:
        status = json.load(f)
    entries = {k: {j: r['job_status'] for j, r in v.items()}
               for k, v in status.items() if not k.startswith('__')}
    status_ok = len(entries) == 1 and [
        list(v.values()) for v in entries.values()] == [['successful']]
    logs = sorted(glob.glob(os.path.join(run_dir, 'logs', '*')))
    with open(os.path.join(run_dir, 'logs', 'fwp_0.log')) as f:
        group = json.loads(next(x for x in f if 'Group summary' in x).split(
            'Group summary: ', 1)[1])
    ranks = []
    for r in range(GROUP_RANKS):
        with open(os.path.join(run_dir, 'logs', f'fwp_0_rank{r}.log')) as f:
            ranks.append(json.loads(next(
                x for x in f if 'Node summary' in x).split(
                    'Node summary: ', 1)[1]))
    rerun_s = rerun_ok = None
    if rerun:
        stamps = {p: os.path.getmtime(p) for p in logs}
        rerun_s, rerun_err = run_cli(run_dir, '-c', pipe_fp, 'pipeline',
                                     '--monitor')
        with open(status_fp) as f:
            rerun_ok = (json.load(f) == status
                        and rerun_err.count('already successful') == 1
                        and {p: os.path.getmtime(p) for p in glob.glob(
                            os.path.join(run_dir, 'logs', '*'))} == stamps)
    return run_dir, {
        'wall_s': wall_s, 'step_s': step_s, 'rerun_s': rerun_s,
        'status': entries, 'status_ok': status_ok, 'rerun_ok': rerun_ok,
        'logs': [os.path.basename(p) for p in logs], 'group': group,
        'ranks': ranks}


def pipeline_group_phase(name, one_process):
    """Phase 19: phase 14's cell through ``sup3r_tpu_torch/cli.py ...
    pipeline --monitor`` from a run directory outside the repo, its
    forward-pass node a group of two ranks sharing the card over gloo
    (``execution_control``: ``ranks_per_node`` 2), under use_mesh True and
    'spatial': one status entry for the node, successful; the launcher's
    and each rank's log files of their own; each rank's ``Node summary``
    (start-up s, run s, launches: the small kernel once a dispatch of its
    share); the chunk files stitched against phase 16's collected
    one-process output (1e-6 of max under True, 1e-4 under 'spatial');
    after the True run a rerun that starts nothing. Returns each rank's
    launches for the ``kernels`` line."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_group_')
    try:
        rng = np.random.default_rng(0)
        s1, s2, t = STREAM_DOMAIN
        input_file = make_fake_nc_file(
            os.path.join(tmp, 'stream.nc'), STREAM_DOMAIN, FWP_FEATURES,
            data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
                  for f in FWP_FEATURES})
        model = flagship('cuda')
        model.meta.update(
            input_resolution={'spatial': '12km', 'temporal': '60min'})
        model_dir = os.path.join(tmp, 'model')
        model.save(model_dir)
        del model
        torch.cuda.empty_cache()
        launches = {}
        for use_mesh in (True, 'spatial'):
            plan = stream_strategy(input_file, model_dir, None,
                                   chunked_io=True)
            want, want_body = group_dispatches(plan, use_mesh)
            run_dir, rec = pipeline_group_run(tmp, input_file, model_dir,
                                              use_mesh, rerun=use_mesh is True)
            strategy = stream_strategy(
                input_file, model_dir,
                os.path.join(run_dir, 'out', 'chunk_{file_id}.nc'),
                chunked_io=True)
            full = stitched(strategy, os.path.join(run_dir, 'out'))
            err = float(np.abs(full - one_process).max())
            tol = GROUP_TOL[use_mesh] * float(np.abs(one_process).max())
            got = [r['launches'] for r in rec['ranks']]
            launches_ok = got == [{'small_reflect_conv': n, 'reflect_conv': k}
                                  for n, k in zip(want, want_body)]
            ok = bool(
                err <= tol and launches_ok and rec['status_ok']
                and rec['rerun_ok'] is not False
                and rec['group']['exit_codes'] == [0] * GROUP_RANKS
                and [r['backend'] for r in rec['ranks']] == [
                    'gloo'] * GROUP_RANKS
                and [(r['rank'], r['ranks']) for r in rec['ranks']] == [
                    (i, GROUP_RANKS) for i in range(GROUP_RANKS)]
                and rec['logs'] == ['fwp_0.log'] + [
                    f'fwp_0_rank{i}.log' for i in range(GROUP_RANKS)])
            emit(phase='pipeline_group', io=STREAM_IO, use_mesh=use_mesh,
                 ranks=GROUP_RANKS,
                 backend=[r['backend'] for r in rec['ranks']],
                 pipeline_wall_s=rec['wall_s'], step_wall_s=rec['step_s'],
                 group_wall_s=rec['group']['wall_s'],
                 rerun_wall_s=rec['rerun_s'],
                 rank_startup_s=[r['startup_s'] for r in rec['ranks']],
                 rank_import_s=[r['import_s'] for r in rec['ranks']],
                 rank_run_s=[r['run_s'] for r in rec['ranks']],
                 rank_launches=got, rank_dispatches=want,
                 status_entries=rec['status'], log_files=rec['logs'],
                 rerun_started_nothing=rec['rerun_ok'],
                 max_abs_err_vs_one_process=err, tol=tol,
                 nvidia_smi=name, ok=ok)
            if not ok:
                raise AssertionError(
                    f'pipeline group ({use_mesh}): error {err} > {tol}, '
                    f'launches {got} vs {want}, record {rec}')
            launches[f'cli_group_{use_mesh}_node'] = got
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 20: a memory budget (GiB) too small for one padded chunk of
#: phase 14's cell, the bilinear resize's input and output grid, and the
#: small input the reloaded generator serves
AUTO_HBM_GB = '0.02'
RESIZE_SHAPE = STREAM_DOMAIN + (2,)
RESIZE_OUT = (120, 120)
RESIZE_RTOL = 1e-6
RELOAD_LR = (2,) + LR_SHAPE[1:]


@contextlib.contextmanager
def checked_small_launches():
    """Hold each call the fused blocks make of ``small_reflect_conv_cf``
    to ``reflect_conv_reference`` on the same inputs (the reference is
    plain PyTorch and counts no launch); yields the list of ((x shape,
    co, alpha), max abs err, max abs plain) per call."""
    from sup3r_tpu_torch.models import fuse

    original = fuse.small_reflect_conv_cf
    errs = []

    def call(x, weight, bias, alpha=None):
        got = original(x, weight, bias, alpha)
        with exact_fp32():
            want = reflect_conv_reference(x, weight, bias, alpha)
        errs.append(((tuple(x.shape), weight.shape[0], alpha),
                     (got - want).abs().max().item(),
                     want.abs().max().item()))
        return got

    fuse.small_reflect_conv_cf = call
    try:
        yield errs
    finally:
        fuse.small_reflect_conv_cf = original


@contextlib.contextmanager
def hbm_budget(gb):
    """``SUP3R_TPU_HBM_GB`` set to ``gb`` for the block."""
    old = os.environ.get('SUP3R_TPU_HBM_GB')
    os.environ['SUP3R_TPU_HBM_GB'] = gb
    try:
        yield
    finally:
        if old is None:
            os.environ.pop('SUP3R_TPU_HBM_GB')
        else:
            os.environ['SUP3R_TPU_HBM_GB'] = old


def auto_fallback_pass(name, tmp, model_dir, input_file):
    """Phase 20a: the 'auto' pass of phase 14's cell under
    ``AUTO_HBM_GB``, first checked (each small-kernel launch against its
    plain version; the model's first pass), then the default pass and
    the 'auto' pass again, both timed warm. Returns the timed 'auto'
    pass's launches and, per (x shape, co, alpha), the checked pass's
    calls and largest error."""
    def make(out):
        return stream_strategy(input_file, model_dir, out,
                               device_batch_size='auto')

    with hbm_budget(AUTO_HBM_GB), checked_small_launches() as errs:
        checked_wall, checked, _, _ = mesh_pass(
            make, os.path.join(tmp, 'auto_checked'))
    default_dir = os.path.join(tmp, 'default')
    wall_default, _, strategy, _ = mesh_pass(
        lambda out: stream_strategy(input_file, model_dir, out),
        default_dir)
    default_full = stitched(strategy, default_dir)
    out_dir = os.path.join(tmp, 'auto')
    with hbm_budget(AUTO_HBM_GB):
        wall, launches, strategy, counters = mesh_pass(make, out_dir)
    plan = (strategy.device_batch_size, strategy.use_mesh)
    n_dispatch = strategy.fwp_slicer.n_chunks
    err = float(np.abs(stitched(strategy, out_dir) - default_full).max())
    kernel_err = max(e for _, e, _ in errs)
    kernel_ok = all(e <= KERNEL_RTOL * scale for _, e, scale in errs)
    by_shape = {}
    for key, e, _ in errs:
        n, worst = by_shape.get(key, (0, 0.0))
        by_shape[key] = (n + 1, max(worst, e))
    want = {'small_reflect_conv': n_dispatch, 'reflect_conv': 0,
            'reflect_conv_wgrad': 0}
    ok = bool(plan == (1, 'spatial') and launches == want
              and checked == want and len(errs) == n_dispatch
              and kernel_ok and err <= MESH_SPATIAL_ATOL)
    emit(phase='auto_fallback_pass', io=STREAM_IO, hbm_gb=AUTO_HBM_GB,
         plan=list(plan), mesh_size=RecordedForwardPass.last.mesh.size,
         dispatches=n_dispatch, wall_s=wall, default_wall_s=wall_default,
         checked_pass_wall_s=checked_wall, launches=launches,
         checked_launches=len(errs),
         launches_by_shape=[[list(x), co, a, n, e]
                            for (x, co, a), (n, e) in by_shape.items()],
         kernel_max_abs_err=kernel_err, kernel_rtol=KERNEL_RTOL,
         max_abs_err_vs_default=err, tol=MESH_SPATIAL_ATOL,
         mesh_counters=counters, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(
            f'auto fallback: plan {plan}, launches {launches} / {checked} '
            f'vs {want}, kernel errors {errs}, error {err}')
    return launches, by_shape


def resize_check(name):
    """Phase 20b: ``bilinear_resize`` on the card against the CPU."""
    arr = torch.as_tensor(np.random.default_rng(4).random(
        RESIZE_SHAPE, dtype=np.float32))
    got = bilinear_resize(arr.to('cuda'), *RESIZE_OUT)
    torch.cuda.synchronize()
    want = bilinear_resize(arr, *RESIZE_OUT)
    err = (got.cpu() - want).abs().max().item()
    tol = RESIZE_RTOL * want.abs().max().item()
    ok = bool(got.is_cuda and tuple(got.shape) == tuple(want.shape)
              and err <= tol)
    emit(phase='bilinear_resize_check', shape=list(RESIZE_SHAPE),
         out_shape=list(got.shape), max_abs_err=err, tol=tol,
         nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'bilinear_resize on the card: {err} > {tol}')


def network_params_round_trip(name, model, tmp):
    """Phase 20c: the flagship generator through ``save_network_params``
    and ``load_network_params`` into a model drawn from another seed."""
    fp = os.path.join(tmp, 'model_gen.msgpack')
    AbstractSingleModel.save_network_params(model.generator, fp)
    fresh = flagship('cuda')
    fresh.init_weights((1,) + LR_SHAPE[1:], (1,) + HR_SHAPE[1:], seed=1)
    lr = np.random.default_rng(2).standard_normal(RELOAD_LR).astype(
        np.float32) * 0.3 + 0.5
    want = model.generate(lr)
    before = float(np.abs(fresh.generate(lr) - want).max())
    params_from_jax(fresh.generator, AbstractSingleModel.load_network_params(
        fresh.generator, fp))
    same = all(torch.equal(a, b) for a, b in zip(
        fresh.generator_weights, model.generator_weights))
    err = float(np.abs(fresh.generate(lr) - want).max())
    ok = bool(same and err == 0.0 and before > 0.0
              and all(p.is_cuda for p in fresh.generator_weights))
    emit(phase='network_params_round_trip', file_bytes=os.path.getsize(fp),
         tensors=len(model.generator_weights), bit_equal=same,
         lr_shape=list(RELOAD_LR), max_abs_err_before_load=before,
         max_abs_err=err, nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'network params round trip: bit-equal {same}, '
                             f'output error {err} (before the load '
                             f'{before})')


def last_names_phase(name):
    """Phase 20: the 'auto' fallback in a world of one,
    ``bilinear_resize`` and the network params round trip. Returns the
    fallback pass's launches and its kernel shapes for the ``kernels``
    line."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_last_')
    try:
        model, model_dir, input_file = mesh_cell(tmp)
        launches, by_shape = auto_fallback_pass(name, tmp, model_dir,
                                                input_file)
        resize_check(name)
        network_params_round_trip(name, model, tmp)
        return launches, by_shape
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device: '
                         'torch.cuda.is_available() is False')
    # seconds of each phase, printed before the kernels line
    seconds, last = {}, [time.perf_counter()]

    def mark(phase):
        now = time.perf_counter()
        seconds[phase] = now - last[0]
        last[0] = now

    # 1. environment and build
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    timer = Timer()
    with timer:
        build.build_all()
    native = {'built': not os.path.exists(_native.library_path())}
    t0 = time.perf_counter()
    native['lib'] = _native.build()
    native['build_s'] = time.perf_counter() - t0
    emit(phase='build', device=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=timer.elapsed,
         build_dir=str(build.build_dir()), native=native)

    mark('1_build')
    # 2. kernel vs plain
    gen = torch.Generator(device='cuda').manual_seed(0)
    tails = {co: conv_inputs(gen, TAIL_SHAPE, co) for co in (2, 1, 3)}
    body_inputs = [conv_inputs(gen, x_shape, co)
                   for x_shape, co, _, _ in BODY_SHAPES]
    body_errs = [check_kernel('reflect_conv', reflect_conv_cf, *inputs,
                              alpha)
                 for inputs, (_, _, alpha, _) in zip(body_inputs,
                                                     BODY_SHAPES)]
    tail_errs = {co: check_kernel('small_reflect_conv',
                                  small_reflect_conv_cf, *inputs, None)
                 for co, inputs in tails.items()}
    errs = {'small_reflect_conv': tail_errs[2], 'reflect_conv': body_errs[2]}
    for x_shape, co, alpha in SMALL_CHECKS:
        inputs = (tails[co] if x_shape == TAIL_SHAPE
                  else conv_inputs(gen, x_shape, co))
        check_kernel('small_reflect_conv', small_reflect_conv_cf, *inputs,
                     alpha)
    check_kernel('reflect_conv', reflect_conv_cf,
                 *conv_inputs(gen, (16, 64, 60, 60), 64), None)
    check_kernel('reflect_conv', reflect_conv_cf,
                 *conv_inputs(gen, (2, 5, 3, 7, 33), 70), 0.2)
    # the 2D path: the Sup3rCC chain's step 0 blocks, then ragged shapes
    chain_inputs_2d = [conv_inputs(gen, x_shape, co)
                       for x_shape, co, _, _ in CHAIN_2D_SHAPES]
    chain_errs_2d = [check_kernel('reflect_conv', reflect_conv_cf, *inputs,
                                  alpha)
                     for inputs, (_, _, alpha, _) in zip(chain_inputs_2d,
                                                         CHAIN_2D_SHAPES)]
    for x_shape, co, alpha in RAGGED_2D_CHECKS:
        check_kernel('reflect_conv', reflect_conv_cf,
                     *conv_inputs(gen, x_shape, co), alpha)
    mark('2_kernel_checks')
    # 2b. both routes of a fused block, and the gate between them (on a
    # generator of its own: the later phases draw what they drew before)
    check_gate(body_route_check(
        torch.Generator(device='cuda').manual_seed(22)))
    mark('2b_body_routes')
    # 2c. both routes of a fused block's weight gradient, and the gate
    wgrad_records = wgrad_route_check(
        torch.Generator(device='cuda').manual_seed(25))
    check_wgrad_gate(wgrad_records)
    mark('2c_wgrad_routes')
    # 3. the main path
    model = flagship('cuda')
    lr = np.random.default_rng(0).standard_normal(LR_SHAPE).astype(
        np.float32) * 0.3 + 0.5
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out, times = serve(model, lr, 'main path')
    launches = {'small_reflect_conv': small_reflect_conv_cf.launches,
                'reflect_conv_wgrad': reflect_conv_wgrad.launches}
    if launches['small_reflect_conv'] != N_REQUESTS or (
            reflect_conv_cf.launches != N_BODY_BLOCKS * N_REQUESTS
            or gated() != reflect_conv_cf.launches
            or launches['reflect_conv_wgrad']):
        raise AssertionError(
            f'main path launches: small_reflect_conv '
            f'{small_reflect_conv_cf.launches}, reflect_conv '
            f'{reflect_conv_cf.launches} (gated {gated()}), '
            f'reflect_conv_wgrad {launches["reflect_conv_wgrad"]}; '
            f'expected {N_REQUESTS}, {N_BODY_BLOCKS * N_REQUESTS} and 0')
    hr_voxels = int(np.prod(HR_SHAPE[:-1]))
    emit(phase='main_path', model='spatiotemporal/gen_3x_4x_2f',
         filters=64, n_resblocks=16, lr_shape=list(LR_SHAPE),
         hr_shape=list(out.shape), requests=N_REQUESTS, request_ms=times,
         hr_voxels_per_s=hr_voxels / (float(np.median(times)) / 1e3),
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches={'small_reflect_conv': small_reflect_conv_cf.launches,
                   'reflect_conv': reflect_conv_cf.launches})
    # the same requests with every body block forced onto cuDNN
    with library_route():
        zero_counts()
        out_c, times_c = serve(model, lr, 'library route')
        library_launches = launch_counts()
    err = float(np.abs(out - out_c).max())
    tol = KERNEL_RTOL * float(np.abs(out_c).max())
    ok = err <= tol and library_launches == {
        'small_reflect_conv': N_REQUESTS, 'reflect_conv': 0,
        'reflect_conv_wgrad': 0}
    emit(phase='main_path_library_route', request_ms=times_c,
         hr_voxels_per_s=hr_voxels / (float(np.median(times_c)) / 1e3),
         default_route_speedup=float(np.median(times_c) / np.median(times)),
         launches=library_launches, max_abs_err_vs_default=err, tol=tol,
         ok=ok)
    if not ok:
        raise AssertionError(f'default route differs from the library '
                             f'route by {err} > {tol}, or launches '
                             f'{library_launches}')

    # the served output against the port's unfused generator on the CPU
    small = np.random.default_rng(1).standard_normal(
        (2, 8, 8, 6, 2)).astype(np.float32) * 0.3 + 0.5
    ref_model = flagship('cpu')
    ref_model.inference_fuse = False
    ref = ref_model.generate(small)
    tol = PARITY_RTOL * float(np.abs(ref).max())
    for pallas in (False, True):
        model.inference_pallas = pallas
        err = float(np.abs(model.generate(small) - ref).max())
        emit(phase='reference_check', inference_pallas=pallas,
             shape=list(small.shape), max_abs_err=err, tol=tol,
             ok=err <= tol)
        if not err <= tol:
            raise AssertionError(f'served output differs from the CPU '
                                 f'reference by {err} > {tol}')

    # 4. the opt-in kernel path
    model.inference_pallas = True
    zero_counts()
    out_k, times_k = serve(model, lr, 'kernel path')
    launches['reflect_conv'] = reflect_conv_cf.launches
    if (reflect_conv_cf.launches != N_BODY_BLOCKS * N_REQUESTS
            or small_reflect_conv_cf.launches != N_REQUESTS):
        raise AssertionError(
            f'kernel path launches: reflect_conv '
            f'{reflect_conv_cf.launches}, small_reflect_conv '
            f'{small_reflect_conv_cf.launches}; expected '
            f'{N_BODY_BLOCKS * N_REQUESTS} and {N_REQUESTS}')
    err = float(np.abs(out_k - out).max())
    tol = PARITY_RTOL * float(np.abs(out).max())
    emit(phase='kernel_path', inference_pallas=True, requests=N_REQUESTS,
         request_ms=times_k, hr_voxels_per_s=hr_voxels / (
             float(np.median(times_k)) / 1e3),
         launches={'small_reflect_conv': small_reflect_conv_cf.launches,
                   'reflect_conv': reflect_conv_cf.launches},
         max_abs_err_vs_main_path=err, tol=tol, ok=err <= tol)
    if not err <= tol:
        raise AssertionError(f'inference_pallas output differs from the '
                             f'main path by {err} > {tol}')
    for pallas in (False, True):
        model.inference_pallas = pallas
        wall_ms, busy_ms, top, flops, d2h_ms = profile_request(model, lr)
        emit(phase='profile', inference_pallas=pallas, wall_ms=wall_ms,
             device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
             d2h_ms=d2h_ms,
             conv_gflop=flops / 1e9,
             conv_fp32_bound_ms=1e3 * flops / peaks(name)[1],
             conv_tf32x3_bound_ms=1e3 * 3 * flops / peaks(name)[2],
             top_device=top)
    del model, out, out_k

    mark('3_4_serving_and_profiles')
    # 5. the kernels line, at the main-path shapes
    def timing(kname, fn, x, w, b, alpha):
        co = w.shape[0]
        with torch.inference_mode(), exact_fp32():
            ms = cuda_ms(lambda: fn(x, w, b, alpha), 20)
            if kname == 'small_reflect_conv':
                packed = small_conv_pack_weights(w)

                def bare():
                    small_reflect_conv_packed(x, packed, b, co, alpha)
            else:
                n_tile = reflect_conv_n_tile(co)
                packed = pack_weights(w, n_tile)

                def bare():
                    reflect_conv_packed(x, packed, b, co, n_tile, alpha)
            launch_ms = cuda_ms(bare, 20)
            kernel_ms = kernel_device_ms(lambda: fn(x, w, b, alpha), kname,
                                         20)
            kernel_ms_by = 'profiler'
            if kernel_ms is None:
                kernel_ms, kernel_ms_by = launch_ms, 'cuda_events'
            plain_ms = cuda_ms(
                lambda: reflect_conv_reference(x, w, b, alpha), 20)
            n_spatial = x.ndim - 2
            xp = F.pad(x, (1,) * (2 * n_spatial), mode='reflect')
            conv = F.conv3d if n_spatial == 3 else F.conv2d
            library_ms = cuda_ms(lambda: conv(xp, w, b), 20)
        bound_ms, bound_by, peak = bound(name, tuple(x.shape), w.shape[0],
                                         w.numel())
        return {'shape': list(x.shape), 'co': w.shape[0], 'alpha': alpha,
                'ms': ms, 'launch_ms': launch_ms, 'kernel_ms': kernel_ms,
                'kernel_ms_by': kernel_ms_by, 'plain_ms': plain_ms,
                'bound_ms': bound_ms, 'bound_by': bound_by,
                'bound_peak': peak, 'share_of_bound': bound_ms / kernel_ms,
                'library_ms': library_ms}

    body_times = [timing('reflect_conv', reflect_conv_cf, *inputs, alpha)
                  for inputs, (_, _, alpha, _) in zip(body_inputs,
                                                      BODY_SHAPES)]
    shapes = [dict(t, launches_per_request=shape[3], max_abs_err=err)
              for t, shape, err in zip(body_times, BODY_SHAPES, body_errs)]

    def record(kname, times, **extra):
        return {'name': kname, 'route': 'cuda', 'source': SOURCES[kname],
                'replaces': REPLACES[kname], 'launches': launches[kname],
                'launches_per_request': launches[kname] // N_REQUESTS,
                'max_abs_err': errs[kname], **times, **extra}

    tail_times = {co: dict(timing('small_reflect_conv',
                                  small_reflect_conv_cf, *inputs, None),
                           max_abs_err=tail_errs[co])
                  for co, inputs in tails.items()}
    mark('5_kernel_timings')
    # 6. the chunked forward pass
    fwp_launches = forward_pass_phase(smi)
    mark('6_forward_pass')
    # 7. training
    train = training_phase(smi, gen)
    mark('7_training')
    # 8. fast and 'custom' serving
    per_request = fast_serving_phase(smi)
    mark('8_fast_serving')
    # 9. bf16 and remat training, the paired feed
    per_step = training_modes_phase(smi, train['fp32'])
    mark('9_training_modes')
    # 10. the Sup3rCC wind chain with topography
    per_chain, calls_2d = chain_phase(smi)
    mark('10_chain')
    chain_times = [dict(timing('reflect_conv', reflect_conv_cf, *inputs,
                               alpha), max_abs_err=err,
                        launches_per_opt_in_chain_pass=calls_2d[
                            (x_shape, co, alpha)])
                   for inputs, (x_shape, co, alpha, _), err in zip(
                       chain_inputs_2d, CHAIN_2D_SHAPES, chain_errs_2d)]
    train_tail = timing('small_reflect_conv', small_reflect_conv_cf,
                        *conv_inputs(gen, TRAIN_TAIL_SHAPE, 2), None)
    mark('5_kernel_timings_of_phases_7_10')
    # 11. the Sup3rCC solar chain, SolarCC training
    per_solar, solar_calls, per_solar_step, solar_check_err = solar_phase(
        smi)
    mark('11_solar')
    solar_times = []
    for x_shape, co, alpha, _ in SOLAR_NEW_SHAPES:
        inputs = conv_inputs(gen, x_shape, co)
        err = check_kernel('reflect_conv', reflect_conv_cf, *inputs, alpha)
        solar_times.append(dict(
            timing('reflect_conv', reflect_conv_cf, *inputs, alpha),
            max_abs_err=err, launches_per_opt_in_solar_chain_pass=solar_calls[
                (len(x_shape) - 2, x_shape, co, alpha)]))
    mark('11_kernel_checks_and_timings')
    # 12. the Sup3rCC trh chain, WithObs and DC training
    per_trh, trh_calls = trh_phase(smi)
    mark('12a_trh_chain')
    obs = obs_phase(smi, gen)
    mark('12b_with_obs')
    per_dc_step = dc_phase(smi)
    mark('12c_dc')
    trh_times = []
    for x_shape, co, alpha, _ in TRH_NEW_SHAPES:
        inputs = conv_inputs(gen, x_shape, co)
        err = check_kernel('reflect_conv', reflect_conv_cf, *inputs, alpha)
        trh_times.append(dict(
            timing('reflect_conv', reflect_conv_cf, *inputs, alpha),
            max_abs_err=err,
            launches_per_opt_in_trh_chain_pass=trh_calls[(x_shape, co,
                                                          alpha)]))
    obs_inputs = conv_inputs(gen, OBS_TAIL_SHAPE, 2)
    obs_tail = dict(
        timing('small_reflect_conv', small_reflect_conv_cf, *obs_inputs,
               None),
        max_abs_err=check_kernel('small_reflect_conv', small_reflect_conv_cf,
                                 *obs_inputs, None),
        grad_max_abs_err=obs['grad_max_abs_err'],
        launches_per_obs_train_step=obs['per_step']['small_reflect_conv'])
    mark('12_kernel_checks_and_timings')
    # 13. the conditional-moment family, TrainingSession, profiling and
    # the reference import
    cond = cond_mom_phase(smi)
    mark('13_cond_mom')
    cond_inputs = conv_inputs(gen, COND_FWP_TAIL_SHAPE, 2)
    cond_tail = dict(
        timing('small_reflect_conv', small_reflect_conv_cf, *cond_inputs,
               None),
        max_abs_err=check_kernel('small_reflect_conv', small_reflect_conv_cf,
                                 *cond_inputs, None),
        launches_per_cond_mom_fwp_pass=cond['fwp_calls'][
            (COND_FWP_TAIL_SHAPE, 2, None)])
    mark('13_kernel_checks_and_timings')
    # 14. streaming input (chunked_io, mode='lazy') and the GCM handler
    stream_routes, gcm_launches = streaming_phase(smi, native)
    mark('14_streaming')
    # the kernels at the shapes the chunked_io pass gave them (read from
    # the hooks of its last timed pass on each route): each distinct
    # shape held to its plain version, the most-called one timed
    stream_shapes = {}
    for route, rec in stream_routes.items():
        hooked = Counter()
        for (kname, x_shape, co, alpha), n in rec['calls'].items():
            if kname == 'cudnn':
                continue
            hooked[kname] += n
            key = (x_shape, co, alpha)
            if key not in stream_shapes.setdefault(kname, {}):
                err = check_kernel(kname, KERNEL_FNS[kname],
                                   *conv_inputs(gen, x_shape, co), alpha)
                stream_shapes[kname][key] = {'max_abs_err': err,
                                             'calls': {}}
            stream_shapes[kname][key]['calls'][route] = n
        want = {k: v for k, v in rec['launches'].items() if v}
        if dict(hooked) != want:
            raise AssertionError(f'streaming ({route}): hooked kernel calls '
                                 f'{dict(hooked)} vs launches {want}')
    stream_times = {}
    for kname, by_shape in stream_shapes.items():
        (x_shape, co, alpha), rec = max(
            by_shape.items(), key=lambda kv: sum(kv[1]['calls'].values()))
        stream_times[kname] = dict(
            timing(kname, KERNEL_FNS[kname],
                   *conv_inputs(gen, x_shape, co), alpha),
            max_abs_err=rec['max_abs_err'],
            calls_per_chunked_io_pass=rec['calls'],
            shapes_checked=[[list(x), c, a, r['max_abs_err'], r['calls']]
                            for (x, c, a), r in by_shape.items()])
    mark('14_kernel_checks_and_timings')
    # 15. bias correction: calibration on the card, the corrected forward
    # pass and the corrected training feed
    bias_routes, bias_train_calls = bias_phase(smi, stream_routes,
                                               cond['mom1_loop'])
    mark('15_bias')
    # every kernel shape the corrected paths gave (read by the recorded
    # wrapper calls of the last chunked_io pass of each route and of the
    # training loop, their count equal to the launches) against its plain
    # version
    bias_shapes = {}
    bias_train_launches = Counter()
    for what, calls, pass_launches in (
            [(f'{r}_chunked_io_pass', v['calls'], v['launches'])
             for r, v in bias_routes.items()]
            + [('train_loop', bias_train_calls, None)]):
        hooked = Counter()
        for (kname, x_shape, co, alpha), n in calls.items():
            hooked[kname] += n
            key = (x_shape, co, alpha)
            if key not in bias_shapes.setdefault(kname, {}):
                err = check_kernel(kname, KERNEL_FNS[kname],
                                   *conv_inputs(gen, x_shape, co), alpha)
                bias_shapes[kname][key] = {'max_abs_err': err, 'calls': {}}
            bias_shapes[kname][key]['calls'][what] = n
        if pass_launches is None:
            bias_train_launches = hooked
        elif dict(hooked) != {k: v for k, v in pass_launches.items() if v}:
            raise AssertionError(f'bias ({what}): kernel calls '
                                 f'{dict(hooked)} vs launches '
                                 f'{pass_launches}')

    def bias_record(kname):
        return {
            'launches_per_bias_corrected_chunked_io_pass': {
                r: v['launches'][kname] for r, v in bias_routes.items()},
            'launches_per_bias_fed_train_loop': bias_train_launches.get(
                kname, 0),
            'bias_shapes_checked': [
                [list(x), c, a, r['max_abs_err'], r['calls']]
                for (x, c, a), r in bias_shapes.get(kname, {}).items()]}

    mark('15_kernel_checks')
    # 16. the production pipeline through the command line
    pipe = pipeline_phase(smi, stream_routes, float(np.median(times)))
    mark('16_pipeline')
    # 17. the mesh slice: a world of one over NCCL, two ranks over gloo
    mesh_launches, gathered_calls = mesh_phase(smi)
    mark('17_mesh')
    # the small kernel at the tail shape of a rank's step in (b)
    mesh_inputs = conv_inputs(gen, MESH_TAIL_SHAPE, 2)
    mesh_tail = dict(
        timing('small_reflect_conv', small_reflect_conv_cf, *mesh_inputs,
               None),
        max_abs_err=check_kernel('small_reflect_conv', small_reflect_conv_cf,
                                 *mesh_inputs, None),
        launches_per_rank_train_step=[
            c['small_reflect_conv']
            for c in mesh_launches['two_rank_train_step']])
    # the small kernel at the gathered tail shapes of (b)'s spatial pass,
    # each held to its plain version
    by_shape = Counter()
    for calls in gathered_calls:
        by_shape.update(calls)
    gathered_checked = [
        [list(x_shape), co, alpha, check_kernel(
            'small_reflect_conv', small_reflect_conv_cf,
            *conv_inputs(gen, x_shape, co), alpha), n]
        for (x_shape, co, alpha), n in by_shape.items()]
    # the most-called shape, the largest of a tie
    (x_shape, co, alpha), _ = max(
        by_shape.items(), key=lambda kv: (kv[1], int(np.prod(kv[0][0]))))
    mesh_gathered = dict(
        timing('small_reflect_conv', small_reflect_conv_cf,
               *conv_inputs(gen, x_shape, co), alpha),
        max_abs_err=max(c[3] for c in gathered_checked),
        launches_per_rank_spatial_pass=[
            c['small_reflect_conv']
            for c in mesh_launches['two_rank_spatial_pass']],
        shapes_checked=gathered_checked)
    mark('17_kernel_checks_and_timings')
    # 18. dp x sp training: four ranks on the 2 x 2 and 1 x 4 meshes
    mesh_launches.update(mesh2d_phase(smi))
    mark('18_mesh2d')
    # 19. phase 16's pipeline with its forward-pass node run as a group of
    # ranks
    mesh_launches.update(pipeline_group_phase(smi, pipe['collected']))
    mark('19_pipeline_group')
    # 20. the world-of-one 'auto' fallback, bilinear_resize, the network
    # params round trip
    mesh_launches['world_of_one_auto_fallback_pass'], auto_shapes = (
        last_names_phase(smi))
    mark('20_last_names')
    # the small kernel at each of the fallback pass's batch-1 tail shapes
    auto_fallback = [
        dict(timing('small_reflect_conv', small_reflect_conv_cf,
                    *conv_inputs(gen, x_shape, co), alpha),
             max_abs_err=err, launches_per_pass=n)
        for (x_shape, co, alpha), (n, err) in auto_shapes.items()]
    mark('20_kernel_timings')
    emit(phase='phase_seconds', seconds=seconds,
         total_s=sum(seconds.values()))

    def per_fwp_pass(kname):
        return {route: counts[kname]
                for route, counts in fwp_launches.items()}

    def per_chain_pass(per_route, kname):
        return {route: {k: v for k, v in counts.items()
                        if k.startswith(kname)}
                for route, counts in per_route.items()}

    def per_cli_pipeline(kname):
        return {'launches_per_cli_pipeline_node': [
            n[kname] for n in pipe['nodes']],
            'launches_per_in_process_two_node_pass': pipe['in_process'][
                kname]}

    def per_mesh(kname):
        """Phases 17 to 20's launches: per step or pass, per rank in
        17b, 18 and 19."""
        return {'launches_in_mesh_paths': {
            path: ([c[kname] for c in counts] if isinstance(counts, list)
                   else counts[kname])
            for path, counts in mesh_launches.items()}}

    def per_mode(kname):
        return {'launches_per_fast_request': per_request['fast'][kname],
                'launches_per_custom_request': per_request['custom'][kname],
                'launches_per_bf16_train_step': per_step['bf16'][kname],
                'launches_per_remat_train_step': per_step['remat'][kname]}

    kernels = [record('small_reflect_conv', tail_times[2],
                      tails=list(tail_times.values()),
                      launches_per_fwp_pass=per_fwp_pass(
                          'small_reflect_conv'),
                      launches_per_chain_pass=per_chain_pass(
                          per_chain, 'small_reflect_conv'),
                      launches_per_solar_chain_pass=per_chain_pass(
                          per_solar, 'small_reflect_conv'),
                      launches_per_solar_cc_train_step=per_solar_step[
                          'small_reflect_conv'],
                      launches_per_train_step=train[
                          'launches_per_train_step'],
                      **per_mode('small_reflect_conv'),
                      launches_per_trh_chain_pass=per_chain_pass(
                          per_trh, 'small_reflect_conv'),
                      launches_per_obs_train_step=obs['per_step'][
                          'small_reflect_conv'],
                      launches_per_dc_train_step=per_dc_step[
                          'small_reflect_conv'],
                      launches_per_cond_mom_train_step=cond['per_step'][
                          'small_reflect_conv'],
                      launches_per_cond_mom_fwp_pass=cond['per_pass'][
                          'small_reflect_conv'],
                      cond_mom_train_check_rel_err=cond[
                          'train_check_rel_err'],
                      cond_mom2_target_rel_err=cond['mom2_target_rel_err'],
                      cond_mom_fwp_shape=cond_tail,
                      launches_per_chunked_io_pass={
                          r: v['launches']['small_reflect_conv']
                          for r, v in stream_routes.items()},
                      launches_per_gcm_chunked_io_pass=gcm_launches[
                          'small_reflect_conv'],
                      chunked_io_shape=stream_times['small_reflect_conv'],
                      **bias_record('small_reflect_conv'),
                      **per_cli_pipeline('small_reflect_conv'),
                      **per_mesh('small_reflect_conv'),
                      mesh_rank_train_shape=mesh_tail,
                      mesh_spatial_gathered_shape=mesh_gathered,
                      auto_fallback_shapes=auto_fallback,
                      obs_shape=obs_tail,
                      obs_train_check_rel_err=obs['train_check_rel_err'],
                      train_shape=dict(
                          train_tail,
                          backward_library_ms=train[
                              'train_backward_library_ms'],
                          grad_max_abs_err=train['grad_max_abs_err'])),
               record('reflect_conv', body_times[2],
                      main_path_shapes=shapes,
                      launches_per_fwp_pass=per_fwp_pass('reflect_conv'),
                      launches_per_chain_pass=per_chain_pass(per_chain,
                                                              'reflect_conv'),
                      chain_2d_shapes=chain_times,
                      launches_per_solar_chain_pass=per_chain_pass(
                          per_solar, 'reflect_conv'),
                      solar_chain_shapes=solar_times,
                      launches_per_solar_cc_train_step=per_solar_step[
                          'reflect_conv'],
                      solar_cc_train_check_rel_err=solar_check_err,
                      launches_per_trh_chain_pass=per_chain_pass(
                          per_trh, 'reflect_conv'),
                      trh_chain_shapes=trh_times,
                      launches_per_obs_train_step=obs['per_step'][
                          'reflect_conv'],
                      launches_per_dc_train_step=per_dc_step[
                          'reflect_conv'],
                      launches_per_cond_mom_train_step=cond['per_step'][
                          'reflect_conv'],
                      launches_per_cond_mom_fwp_pass=cond['per_pass'][
                          'reflect_conv'],
                      launches_per_chunked_io_pass={
                          r: v['launches']['reflect_conv']
                          for r, v in stream_routes.items()},
                      launches_per_gcm_chunked_io_pass=gcm_launches[
                          'reflect_conv'],
                      chunked_io_shape=stream_times['reflect_conv'],
                      **bias_record('reflect_conv'),
                      **per_cli_pipeline('reflect_conv'),
                      **per_mesh('reflect_conv'),
                      launches_per_train_step=0,
                      **per_mode('reflect_conv'))]

    def wgrad_of(counts):
        """A path's weight-gradient launches; None where it counts none
        (the pipeline group's ranks report the forward kernels only)."""
        if isinstance(counts, list):
            return [c.get('reflect_conv_wgrad') for c in counts]
        return counts.get('reflect_conv_wgrad')

    # the weight-gradient kernel: phase 2c's times, bound and errors at
    # the train cell's five blocks (the body first), its launches on
    # every training path
    train_cell = [r for r in wgrad_records
                  if (tuple(r['shape']), r['co']) in TRAIN_CELL_BLOCKS]
    body = next(r for r in train_cell
                if (tuple(r['shape']), r['co']) == TRAIN_CELL_BLOCKS[2])
    kernels.append({
        'name': 'reflect_conv_wgrad', 'route': 'cuda',
        'source': SOURCES['reflect_conv_wgrad'],
        'replaces': REPLACES['reflect_conv_wgrad'],
        'launches': launches['reflect_conv_wgrad'],
        'launches_per_request': launches['reflect_conv_wgrad'] // N_REQUESTS,
        'shape': body['shape'], 'co': body['co'],
        'kernel_ms': body['kernel_ms'], 'kernel_ms_by': 'cuda_events',
        'plain_ms': body['library_ms'], 'library_ms': body['library_ms'],
        'bound_ms': body['bound_ms'], 'bound_by': body['bound_by'],
        'share_of_bound': body['share_of_bound'],
        'max_rel_err': body['rel_err'],
        'library_max_rel_err': body['library_rel_err'],
        'train_cell_shapes': train_cell,
        'launches_per_train_step': train['wgrad_launches_per_train_step'],
        'launches_per_bf16_train_step': per_step['bf16'][
            'reflect_conv_wgrad'],
        'launches_per_remat_train_step': per_step['remat'][
            'reflect_conv_wgrad'],
        'launches_per_solar_cc_train_step': per_solar_step[
            'reflect_conv_wgrad'],
        'launches_per_obs_train_step': obs['per_step']['reflect_conv_wgrad'],
        'launches_per_dc_train_step': per_dc_step['reflect_conv_wgrad'],
        'launches_per_cond_mom_train_step': cond['per_step'][
            'reflect_conv_wgrad'],
        'launches_in_mesh_paths': {path: wgrad_of(counts)
                                   for path, counts in mesh_launches.items()},
        'small_reflect_conv_backward_ms': train['train_backward_library_ms']})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    torch.nn.modules.module.register_module_forward_pre_hook(tally_gated)
    if sys.argv[1:2] == ['--mesh-rank']:
        # a rank of phase 17b (spawn_ranks: out_dir rank world store)
        sys.exit(run_rank_scenarios(MESH_RANK_SCENARIOS, *sys.argv[2:]))
    if sys.argv[1:2] == ['--mesh2d-rank']:
        # a rank of phase 18
        sys.exit(run_rank_scenarios(MESH2D_RANK_SCENARIOS, *sys.argv[2:]))
    sys.exit(main())
