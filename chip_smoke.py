"""Drive the PyTorch port (``enf_pde_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, one line each, flushed as they go. The YAMLs' ``pallas`` decodes with K1's and K2's
bf16 programs on the card (bf16 operands, f32 sums: JAX's ``compute_dtype=bfloat16``, what its
kernel runs on the TPU), so the main paths (forecasts, training runs, the steps of the
later phases) run those; the phases that hold a kernel path to eager or to the plain version
at 1e-5 (6, 17, 22 and 26's steps, 27) run the strict-f32 programs (``pallas_interpret``,
``F32_KERNELS``), and every K1 / K2 check at a shape calls the f32 program unless it says bf16:

1. build: compile every CUDA kernel with plain ``nvcc``, one process per source, all
   started together (the build's seconds, the compiler's register/spill report, the
   card's name and power limit);
2. kernel K1 (``fused_decode_fwd``) against its plain PyTorch version at the full
   Navier-Stokes width, batch 8 x 4096 points, with and without the fused tail, and
   with the tail at the rollout decode's shape (80 frames x 512 points) and at a
   ragged 8 x 1000 (not a multiple of K1's 32-point tile);
3. the Navier-Stokes forecast end to end at full width with seeded random weights:
   ``Forecaster.forecast`` of 8 smooth periodic 64x64 frames for 20 frames
   (3-step latent fit, 19 Euler steps of the PONITA ODE, decode of 160 frames x
   4096 points through K1's bf16 program), the launch count of K1 in that run, the output's
   shape and finiteness, the decoded field against the plain bf16 decode of the same
   latents (phase 35's gates), and the time of the call and of each stage (median of 5 warm
   repeats);
4. K1 at the forecast's launch shape (160 frames x 512 points) against its plain
   version, and its time there and at the rollout decode's shape (80 x 512), its
   shared weights split once as the forecast decode splits them, beside the plain
   version's and the card's bounds for the same work (f32 on the CUDA cores, 3xTF32 on
   the tensor cores, bytes), with the design's L2 weight bytes per point; and the
   decode's PyTorch prologue (weight fold, K1's weight split, geometry);
5. kernel K2 (``fused_decode_bwd``) against its plain version (autograd over the
   plain decode) at the ode step's decode shape, 80 frames x 512 points at full
   width, with and without weight gradients and with and without the tail, every
   gradient tensor; its time beside the plain version's and the bound;
6. one ode step's and one dual step's loss and gradients with the rollout decode on
   the kernels' f32 programs (K1 + K2) against the same step with the eager decoder, from the
   same state and draws;
7. data: ``get_dataloader`` for ``navier_stokes`` at the full protocol (64x64, viscosity
   1e-3, dt 1e-3, 30 time units of burn-in, 20 frames: 50,000 solver steps a block of
   16) with 16 training and 8 test signals, generated on the card into a fresh
   ``chiprun_out/ns_data/`` (one block per split); seconds per block and solver steps
   per second, the batch shape [8, 20, 64, 64, 1], finiteness and each frame's mean
   near zero; and one seed's initial field built from the same CPU-drawn coefficients
   on the CPU and on the card, then 1,000 solver steps from it on each, held within
   rel-L2 1e-4;
8. the training path end to end through the CLI's ``run_experiment``, at full width on
   that data (two batches of 8; the 8 test signals validate): 3 epochs with the phases
   overridden to epoch 1 nef, 2 dual, 3 ode, validation, dp validation and the
   equivariance check at epoch 3, a checkpoint after every epoch keeping 2; finite
   losses, ``equivariance_err_translation`` finite, the checkpoints of epochs 2 and 3,
   K1 and K2 launch counts of that run; the checkpoint of epoch 3 restored into a
   freshly built trainer equals the live modules, state and generator bit for bit;
   each step kind's median warm time over 5 repeats on a batch of the generated data,
   and the peak memory;
9. resume: ``run_experiment`` again with ``logging.resume`` and the ode window and
   ``num_epochs`` moved to 4; it starts at epoch 4, takes an ode epoch, launches K1 and
   K2, and its config check names ``training.ode.train_until_epoch``;

then, for each SE(2) planar experiment (``diffusion_plane``: 4 latents of 16; then
``cahn_hilliard``: 9 latents of 32, PONITA hidden 128 / basis 128, kernel_size 0.2; both
``ponita`` invariants, decoder hidden 64, 2 heads):

10. K1 against its plain version at the config's widths (I = 2, hid = hidm = D = 64,
    H = 2), with and without the tail, at the forecast's and validation's launch shape
    (160 frames x the config's chunk, 1024 / 2048 points), at 160 x 512 and 80 x 512, and
    for ``diffusion_plane`` at z = 5 and z = 1 (groups of one latent) at a ragged 8 x 1000;
    ms per launch, the plain version's ms, the 3xTF32 bound and K1's shared memory (the
    Python mirror of its ``layout`` held equal to the built library's);
11. data: ``get_dataloader`` generates the dataset on the card into a fresh
    ``chiprun_out/<name>_data/``, removed after phase 12 (``diffusion_plane``: one block
    of 32 per split, the analytic heat kernel, one trajectory held against the CPU's
    within rel-L2 1e-5;
    ``cahn_hilliard``: 8 + 8 trajectories of 60,000 IMEX steps, the first 100 steps of one
    field held against the CPU's within 1e-4, every frame's mean against its initial
    field's within 1e-5, and the median |c| of the last frames above 0.8);
12. training through ``run_experiment`` at full width on that data (``diffusion_plane``:
    16 + 8 signals, 3 epochs nef, dual, ode; ``cahn_hilliard``: 8 + 8, 2 epochs nef,
    dual), validation with the dp variants and the equivariance check, whose translation
    and rotation errors must be at f32 rounding (<= 1e-4), K1's launches against the
    loop's arithmetic (the training steps decode eagerly: neither YAML sets
    ``ode_backend``), each step kind's warm median; then ``Forecaster.forecast`` of 8
    generated test frames for 20 frames as in phase 3, through K1;

13. K1 past four latents at the Navier-Stokes width (I = 4, hid = hidm = D = 128, H = 2),
    which the earlier two-pass layout refused: z = 5, 8, 9 and 16 at a ragged
    8 x 1000, and ``shallow_water``'s decode widths (latent_dim 32, z = 8) at its launch
    shape 160 x 2048, against the plain version with and without the tail, with times,
    bounds and shared memory as in phase 10;

then the heat equation on the sphere, ``diff_sphere`` at its full published width (decoder
hidden 16, 2 heads, 18 latents of 4 on a polar grid, ``polar_periodic``: I = 1, no window;
PONITA 3 layers, hidden 32, basis 32; 2048 sampled points of the 128 x 64 grid, batch 2):

14. K1 at its widths as in phase 10, at 160 x 2048 (the forecast's and validation's
    launch, latent groups 4, 4, 4, 4, 2), 160 x 512, 80 x 512 and at z = 2 and z = 8 at a
    ragged 8 x 1000;
15. data: ``get_dataloader`` generates one block of 16 trajectories per split on the card
    into a fresh ``chiprun_out/diff_sphere_data/`` (removed after phase 16); trajectory 0
    against the CPU's generation within rel-L2 1e-5, and the area-weighted mean of every
    frame against its initial frame's within 1e-5;
16. training through ``run_experiment`` on 16 + 8 signals for 3 epochs (nef, dual, ode),
    validation with the dp variants, the sphere equivariance check (longitude and rotation
    errors at f32 rounding, <= 1e-4), K1's launches against the loop's arithmetic, each step
    kind's warm median; then ``Forecaster.forecast`` of 8 generated test frames for 20
    frames through K1, with its stages.

then the Galewsky-jet shallow water on the sphere, ``shallow_water`` at its full published
width (decoder hidden 128, 2 heads, 8 latents of 32 on a polar grid, ``latitude_periodic``:
I = 4, window on; three output channels (h, u_phi, u_theta); PONITA 3 layers, hidden 256,
basis 128; batch 1, 2048 sampled points of the 96 x 48 grid; ``ode_backend: pallas``):

17. K1 against its plain version at its widths, with and without the tail, at 160 x 2048
    (the forecast's launch), 14 x 2048 (validation's), 14 x 512 and a ragged 8 x 1000, with
    times, bounds and shared memory as in phase 10; K2 against its plain version at the ode
    step's decode shape (10 frames x 2048 points) in all four modes, its time beside the
    bound; one ode and one dual step on K1 + K2 against the eager decoder, as in phase 6;
18. data: ``get_dataloader`` for ``shallow_water_low_res`` generates one block of 4
    trajectories per split on the card (192 x 96, lmax 64, 20 records of 150 steps of
    400 s) into a fresh ``chiprun_out/shallow_water_data/`` (removed after phase 19):
    seconds per block, solver steps per second, the batch shape [1, 14, 96, 48, 3],
    finiteness, the JAX package's physical bounds, the area-weighted mean of h of every
    recorded frame against the first's (within 1e-6 of max |h|), and seed 0's initial
    state and first record built on the CPU and on the card within rel-L2 1e-4 (h, u_phi,
    and u_theta's error against the velocity's norm: u_theta alone is printed too);
19. training through ``run_experiment`` on 4 + 4 signals for 3 epochs (nef, dual, ode),
    validation with the dp variants, the longitude equivariance check (<= 1e-4, and no
    rotation error: the geometry claims none), then the zero-shot super-resolution eval on
    the 192 x 96 test split (``superres_mse_in_t`` / ``out_t``, once more timed), K1's and
    K2's launches against the loop's arithmetic (the ode and dual steps launch each once,
    validation K1 3 times, the super-resolution eval 9 times a batch), each step kind's
    warm median; then ``Forecaster.forecast`` of 8 generated first frames for 20 frames
    through K1, with its stages.

then the paper's two baselines on phase 7's Navier-Stokes data (16 + 8 signals):

20. K1 against its plain version, with times, bounds and shared memory as in phase 10, at
    ``navier_stokes_nonmaml``'s validation decode (NS width, 160 x 2048) and a ragged
    8 x 1000, and at NS width with I = 2 (``abs_pos``, ``rel_pos``) and I = 1
    (``norm_rel_pos``) at 160 x 512; K2 at I = 2 (``abs_pos``) and I = 1 (``norm_rel_pos``)
    at the ode step's 80 x 512 in all four modes, its time with and without weight
    gradients beside the bound;
21. ``navier_stokes_nonmaml`` (autodecoding) at its full published width (decoder hidden
    128, 2 heads, 4 latents of 16; PONITA 3 x 128, basis 64; batch 8, 2048 points) through
    ``run_experiment``: epochs nef, nef, ode and the final validation (stored-code rollout,
    then 2-epoch re-fits of both splits at 4 dropout shares); the metric keys exactly the
    JAX loop's (beside the port's data-path record), every value finite, K1's launches
    against the arithmetic (2 chunks per validation batch, 2 + 4 x (1 + 2) batches: 28),
    the peak memory; a codes-only step
    leaves the decoder bit for bit; each step kind's warm median;
22. ``navier_stokes nef.invariant_type=abs_pos`` (the non-equivariant ablation) through
    ``run_experiment`` for 3 epochs (nef, dual, ode): no equivariance key, K1 and K2 launches
    against the loop's arithmetic, step medians; the kernel-backend ode and dual steps against
    the eager ones at I = 2 (the key bias's gradient, 0 by structure there, held to rounding
    of the step's gradient norm instead); one full-width ode step with ``node.name=mlp``:
    a finite loss, a moved ODE, K1 and K2 once each (counted apart from the abs_pos run's
    launches, which the kernels line reports).

then convection in the solid ball, ``ihc`` at its full published width (decoder hidden 32,
3 heads, 25 latents of 32 with Fibonacci Euler-angle poses, the ``ball`` invariant: I = 5,
window size 1.0; PONITA 3 layers, hidden 128, basis 64; batch 1, 2048 sampled points of
the 48 x 24 x 24 ball grid):

23. K1 against its plain version at its widths (the mixer's odd third head; the width class
    32: z = 25 in seven latent groups of 4 and 3), with and without the tail, at the forecast's
    launch (160 x 2048), validation's (14 x 2048), validation's padded last chunk (1,024 grid
    points and 1,024 zeros), a ragged 8 x 1000, and at 8 x 1000 with z = 1 and z = 5 (one
    past the class's largest group of 4), with times, bounds, shared memory, width class and
    blocks an SM as in phase 10;
24. the Boussinesq ball solver on the card (float64): (a) seed 0 at full size (lmax 23,
    nmax 24), its state after 200 steps against the port's CPU solver within rel-L2 1e-8;
    (b) the conduction limit (buoyancy 0): from ``BallModes``' seeded modal field, the frames
    equal its closed-form frames within rel-L2 2e-3;
    (c) ``get_dataloader`` for ``ihc`` generates 2 + 2 trajectories at the full protocol
    (one batched block of 2 per split, each trajectory on its own CFL steps, 20 frames from
    t = 2 to 5.8) into a fresh ``chiprun_out/ihc_data/`` (removed after phase 25): seconds
    a block, steps per trajectory and per second, the dt range, the batch shape
    [1, 14, 48, 24, 24, 1], finiteness, the physical range and the perturbation energy off
    1 - r^2 grown from the first frame to the last;
25. training through ``run_experiment`` on 2 + 2 signals for 3 epochs (nef, dual, ode),
    validation with the dp variants and the ball's equivariance check (its rotation error
    with the window, which reads Euler angles as sphere angles, finite; the trained decoder
    without the window on fitted latents, <= 1e-4), K1's launches against the loop's
    arithmetic (14 chunks per validation batch), each step kind's warm median; then
    ``Forecaster.forecast`` of 8 generated frames (the first two of each trajectory) for
    20 frames through K1, with its stages.

then the rest of the decoder family at the Navier-Stokes width (phase 7's data is kept for
phase 28 and removed after it):

26. the decoder with 2 latent self-attention blocks (``nef.num_layers=2``, seeded random
    weights): K1 on the folded, attended latents against the eager decoder at 160 x 512 and
    a ragged 8 x 1000 (rel-L2 <= 1e-5), K1's time at 160 x 512 beside phase 4's, the fold's
    time with the blocks; the ode and dual steps on K1 + K2 against the eager ones (rel-L2
    <= 1e-5) with the cotangent 0 at the points within 1e-6 of an RFF ReLU's kink, as K2's
    check in phase 5, the same points on both sides (printed beside, with no gate: how many
    points that stops, the whole steps' errors, and each f32 step's distance from the step
    in float64 with the whole cotangent and with those points stopped: a few such points
    move the ODE's gradient by about the gate); the same numbers, with no gate, on a second
    draw of weights, frames and masks;
27. second order through K1 and K2 (their f32 programs: ``nef.backend=pallas_interpret``) at ``num_layers`` 0 and 2: the
    nef step on the kernels against the same step on the eager decoder from the same state,
    frames and masks (loss within 1e-5 relative, every gradient tensor within rel-L2 1e-4;
    both steps' distances from the eager step in float64 printed beside),
    ``Forecaster.fit`` on the kernels against the eager fit (fitted latents within 1e-4), the
    launches of each (a nef step: K + 1 K1 and 2K + 1 K2; a fit: K and K), warm medians of
    both on both backends, one nef step under ``utils.profiling.trace`` (its ten costliest
    device operations and the card's busy share of the traced window), and K1 and K2 at the
    nef step's 16 x 512 and the fit's 8 x 512 against their plain versions, timed;
28. the slice end to end: ``run_experiment`` for ``navier_stokes nef.num_layers=2
    nef.backend=pallas`` on phase 7's data for 3 epochs (nef, dual, ode) with validation, the
    dp variants and the equivariance check: the run record's backends (kernel for training,
    evaluation and the ode decode), finite metrics, K1's and K2's launches against the
    loop's arithmetic; then ``Forecaster.from_checkpoint`` on its log directory (fit on the
    eager decoder, decode on K1, as JAX's default ``backend='pallas'``) forecasts 8 test
    frames for 20 frames bit for bit as a ``Forecaster`` built from the run's final state,
    with its stages;
29. the other options on the eager path: one nef and one ode step with
    ``nef.embedding_type=ffn`` and ``=polynomial`` (multipliers 2: degree 2), whose backends
    resolve to eager with no K1 or K2 launch, finite losses; the ``EquivariantTransformer``
    (hidden 128, 2 heads, 2 layers, with and without global pooling) on phase 28's fitted
    latents, card against CPU within rel-L2 1e-5;

then the last modules at the Navier-Stokes width (phase 7's data is removed after phase 32):

30. the solvers: the ode and dual steps with the training rollout rematerialized (the
    default, JAX's) and stored, at the YAML's 10 frames and at 50 (``LONG_HORIZON``, the
    YAML's out horizon, on smooth synthetic trajectories): losses and every gradient within
    rel-L2 1e-6 of each other, warm medians and peak memory both ways, K1 and K2 launches
    at the 50-frame rollout's 400 x 512, and both kernels held against their plain versions
    and timed there;
31. multi-process on the card: (a) an NCCL world of 1 in this process: the nef, ode and
    dual steps through the data mesh, the coordinate-sharded validation and the forecast
    decode bit for bit the paths without a mesh; (b) a gloo world of 2 spawned with both
    ranks on the one card, on phase 7's first batch of 8: each rank's steps within rel-L2
    1e-6 of this process's mean over the two halves of the batch, and within 1e-5 of the
    whole batch's or as close as those halves come; (c) the coordinate-sharded validation
    and forecast bit for bit; (d) parameters, optimizer states and generators equal on both
    ranks after three steps; (e) each rank's K1 / K2 launches by shape and warm step
    medians, and K1 and K2 held and timed at a rank's 40 x 512; (f) the fit CLI for 2
    epochs on phase 7's data under ``python -m torch.distributed.run --standalone
    --nproc_per_node=1`` and without it, side by side: equal metrics;
32. the native prefetcher: its g++ build's seconds, phase 7's batches through the train
    loader's ``batch_fetch`` bit for bit ``np.load``'s, ms a batch both ways, and one
    ``run_experiment`` epoch with ``dataset.device_cache=false`` (the run record says
    ``prefetcher``; the probe batch and each training batch go through it);
33. the split-DFT Navier-Stokes solver: 1,000 steps of a block of 16 fields, split against
    ``torch.fft`` within rel-L2 1e-4, and µs a step both ways;

then K2 at the widths the other configs give it:

34. for ``diffusion_plane``, ``cahn_hilliard``, ``diff_sphere`` and ``ihc`` at full width
    with ``nef.backend=pallas`` (which no YAML sets, and which sends the nef step and the fits
    through K1 and K2): one nef step and one fit through the trainer on a seeded random
    trajectory (finite loss, gradients and latents; K2's launches by shape and weight-gradient
    mode: the nef step's K inner steps and the fit's K steps ask for none, the nef step's other
    K + 1 launches for them), then K2 against its plain version in all four modes with the kinks
    stopped at the nef step's and the fit's shapes, one launch repeated bit for bit, timed.

then the bf16 programs:

35. K1's and K2's bf16 programs against the plain bf16 version at every launch shape the paths
    above give them (``BF16_K1_SHAPES``, ``BF16_K2_SHAPES``: the forecasts', validations' and
    steps' of every config, 400 x 512 included, the narrow configs' nef steps and fits in both
    weight-gradient modes, which K2's narrow design takes; beside them K1's wide instantiation,
    hidm = D = 256, and K2's class design at width class 64, one head of NS width, which no path
    gives; each K2 line names its design, as the kernels line does),
    with the gates ``bf16_gates`` (rel-L2 to the plain bf16 version at most 0.35 of the bf16
    function's own distance from f32, the distance to the plain f32 version within 0.9-1.1 of
    it, and K1's outputs within 5e-2 of f32; K2 with the cotangent 0 within 2^-8 of an RFF
    ReLU's kink, the whole cotangent's numbers beside, two launches bit for bit, dinv ... dc the
    same bits with and without weight gradients), each timed beside the f32 program at the same
    shape, the plain bf16 version and the bf16 bound (operations at 989 TFLOP/s, or bytes); the
    Navier-Stokes ode, dual and validation steps and the 8 x 20 forecast in both modes (the
    forecasts' rel-L2); one nef step with ``nef.backend=pallas`` in bf16 against the same step
    through the plain bf16 composition, with the same gates;

then the repo's trained models:

36. the four trained JAX runs of ``results/ckpt``, exported as numpy files under ``weights/``
    (``tools/export_jax_checkpoint.py``: parameters and JAX's own outputs for seeded inputs) and
    served by ``Forecaster.from_jax_export`` (``ns8192_s0``, ``diff_plane_full_s0``,
    ``sw_full_s1``, ``ihc_full_s0``): (a) two seeded latent sets decoded on the whole grid eagerly
    and by K1's f32 program, each within rel-L2 1e-5 of JAX's f32 decode, and by its bf16 program,
    held with phase 35's gates against the plain bf16 and f32 versions on the same trained inputs,
    its distances from JAX's bf16 and f32 decodes printed beside JAX's own gap; (b) the forecast of
    the two JAX fields with JAX's inner-loop masks on ``xla`` within 1e-3 of JAX's, and on
    ``pallas`` held with phase 35's gates against the plain bf16 decode of its rollout; (c) the
    validation (``val_step``) on the test trajectories generated on the card by phases 7 (8 NS
    signals), 18 (4 of shallow water) and 24 (2 of ``ihc``), kept on the host, and on 32 of
    ``diffusion_plane`` generated here: in-t MSE within 2x of the run's recorded
    ``val_mse_in_t`` where the split has 8 signals or more (NS, ``diffusion_plane``), printed
    beside it for the others. Each run counted (K1's launches zeroed just before it, held to the
    decode's chunks) and timed warm; K1's f32 program timed at the decode's launch shape and its
    bf16 program (``k1_bf16_check``) at validation's, on the trained weights;
37. two of them trained on from their exports' optimizer states (``weights/<run>/opt_state.npz``):
    ``ns8192_s0`` and ``sw_full_s1``, whose ode steps decode on K1 + K2 (``nef.ode_backend: pallas``):
    (a) the export written as the port's checkpoint (``convert.write_resume_checkpoint``) and
    ``run_experiment`` with ``logging.resume=true`` at the run's own config and widths for 2 more ode
    epochs (31-32, 1501-1502) on the test split phase 7 / 18 kept (8 / 4 signals as both splits; the
    reductions printed), every K1 and K2 launch counted by program and shape, the optimizers' counts
    (the ODE's grown by the ode steps, the others kept) and the global step continued from JAX's record,
    the in-t MSE beside the run's record (NS gated at 2x); (b) the restored state's own ode step at
    80 x 512 (NS) and 10 x 2048 (SW): its K1 and K2 launch (the restored latents' rollout, the step's
    cotangent) held by ``k1_bf16_check`` and ``k2_bf16_check`` without and with weight gradients, timed;
    (c) 8 ode and 8 dual steps from the restored state on three backends (bf16 kernels, f32 kernels,
    eager) with the same draws: the losses and the largest relative drift from eager beside JAX's TPU
    record (``results/r4/ode_backend_check_*.json``, copied), the f32 kernels gated at it; the bf16
    kernels' first-step loss held by phase 35's gates in scalar form against the plain bf16 and f32
    compositions on the CPU or, where right evaluations of the bf16 function leave those too (SW), by
    their spread (``first_loss_gates``); (d) the first ode step with the restored against fresh optimizer states:
    the two ODE updates' rel-L2 and the losses after. The phase is held to 60 s.

Every K2 phase (5, 17, 20, 27, 30, 31, 34) repeats one launch with the tail and weight
gradients and requires the same bits (and the same bits of the six latent gradients without
weight gradients), and prints, on each ``[timing]`` line, K2's scratch
bytes a launch, its blocks an SM, grid and shared memory, the library's layout held equal to
the Python mirrors ``k2_smem_bytes`` and ``k2_scratch_bytes``.

Then one line ``{"kernels": [...]}``: each program of K1 and K2 (``fused_decode_fwd`` and
``fused_decode_bwd``, the f32 programs; ``..._bf16``, the bf16 ones) at each shape it was held and
timed at, with its launches at that shape (and mode) on the paths the script drove
(``PATH_LAUNCHES``: forecasts, training runs and steps, never a check or a timing): the bf16
programs at phase 35's shapes with phase 35's numbers (``f32_ms``: the f32 program at the same
shape), the f32 programs at the shapes of the phases that ran ``pallas_interpret`` (phases 4, 5,
17, 20 and 27's numbers); ``bound_ms`` is that of the program's route (3xTF32 or bf16 on the tensor
cores, or bytes where they take longer); then K1's two programs on each trained run of phase 36,
with every launch of its decode, forecast and validation (``launches_by_shape``), timed at one of
those shapes; then the bf16 K1 and K2 (without weight gradients: its ode epochs take no dual step) on
each run phase 37 resumes, with the launches of its ``run_experiment``, timed at its ode step.
Last, ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when there is no CUDA device or any phase fails.
Every f32 check: rel-L2 <= 1e-5 against the plain version (K2 reduces its sums
deterministically, in another order than autograd: no atomics); every bf16 check: phase 35's gates.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
import types
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import Config, load_experiment_config
from enf_pde_tpu_torch.convert import load_jax_export, load_opt_state, write_resume_checkpoint
from enf_pde_tpu_torch.data import get_dataloader, planar_coords
from enf_pde_tpu_torch.data import native_loader
from enf_pde_tpu_torch.data.ball_convection import BallConvectionSolver, BallOutputGrid
from enf_pde_tpu_torch.data.cache import TrajectoryCache
from enf_pde_tpu_torch.data.ihc import BallModes, full_size_solver
from enf_pde_tpu_torch.data.registry import dataset_spec
from enf_pde_tpu_torch.data.sphere_harmonics import SphereGrid
from enf_pde_tpu_torch.data.cahn_hilliard import cahn_hilliard_rollout, initial_fields
from enf_pde_tpu_torch.data.diffusion_plane import generate_diffusion_trajectories
from enf_pde_tpu_torch.data.diffusion_sphere import generate_sphere_diffusion_trajectories
from enf_pde_tpu_torch.data.navier_stokes import (
    GaussianRF2D,
    default_forcing,
    navier_stokes_rollout,
    navier_stokes_rollout_split,
)
from enf_pde_tpu_torch.data.shallow_water import (
    STEPS_PER_RECORD,
    ShallowWaterSolver,
    SWUnits,
    galewsky_state,
    sw_grid,
)
from enf_pde_tpu_torch.experiments.fit import run_experiment, super_resolution_eval
from enf_pde_tpu_torch.geometry.invariants import get_ca_invariant, get_sa_invariant
from enf_pde_tpu_torch.inference import Forecaster
from enf_pde_tpu_torch.models.decoder import decode_chunked, decode_trajectories
from enf_pde_tpu_torch.models.latents import latents_to_pose
from enf_pde_tpu_torch.models.transformer import EquivariantTransformer
from enf_pde_tpu_torch.ops import cuda_lib
from enf_pde_tpu_torch.ops import fused_decode as fused_decode_module
from enf_pde_tpu_torch.ops.fused_decode import (
    BWD_KERNEL_SOURCE,
    BWD_KERNEL_SOURCE_BF16,
    KERNEL_SOURCE,
    KERNEL_SOURCE_BF16,
    decode_bwd_flops_per_point,
    decode_flops_per_point,
    fused_decode_bwd,
    fused_decode_bwd_plain,
    fused_decode_fwd,
    fused_decode_plain,
    k1_constants,
    k1_library_plan,
    k1_library_smem_bytes,
    k1_logits_floats,
    k1_occupancy,
    k1_plan,
    k1_operands,
    k1_smem_bytes,
    k1_width_class,
    k2_narrow_design,
    k2_occupancy,
    k2_w128_design,
    k2_scratch_bytes,
    k2_smem_bytes,
    shared_weights,
)
from enf_pde_tpu_torch.ops.layers import reset_parameters
from enf_pde_tpu_torch.parallel.mesh import make_mesh, shard_batch
from enf_pde_tpu_torch.train import steps as train_steps
from enf_pde_tpu_torch.train.inner_loop import make_inner_loop, make_train_inner_loop
from enf_pde_tpu_torch.train.logging import MetricLogger
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer
from enf_pde_tpu_torch.utils.equivariance import equivariance_errors
from enf_pde_tpu_torch.utils.profiling import trace

SEED = 0
REL_L2_TOL = 1e-5  # f32 kernel vs f32 plain version: only the order of the sums differs
GRID = 64
NUM_SIGNALS = 8
NUM_FRAMES = 20
WARM_REPEATS = 5
TRAIN_SIGNALS = 16   # training trajectories, two batches of 8
VAL_SIGNALS = 8
TRAIN_FRAMES = 20
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
LOG_DIR = OUT_DIR / "chip_smoke_train"
DATA_DIR = OUT_DIR / "ns_data"
NS_VISC, NS_DT, BURN_IN = 1e-3, 1e-3, 30.0  # generate_ns_trajectories' protocol
MEAN_TOL = 1e-3  # |spatial mean| of a frame; fields are O(1), the mean is 0 up to rounding
SOLVER_TOL = 1e-4  # rel-L2, card vs CPU solver (cuFFT vs pocketfft rounding)
# A ReLU pre-activation this close to 0, as a share of the sum of its terms' magnitudes, may
# round to either side in f32 or 3xTF32, whose rounding of a 128-term sum is of the order of
# 1e-8 of it (the kinks that split K2 from its plain version on the card sat at 1.8e-9 and
# 4.7e-9, ``tools/k2_compare.py --f64``).
TIE_MARGIN = 1e-6
CH_BULK_MIN = 0.8  # median |c| of a Cahn-Hilliard trajectory's last frame: phases near +-1
SW_SIGNALS = 4  # shallow-water trajectories a split: one block (batch_size_gen)
SW_FRAMES = 20  # generate_sw_trajectories' protocol: 20 records of STEPS_PER_RECORD steps of 400 s
IHC_SIGNALS = 2  # ball-convection trajectories a split: one batched block (batch_size_gen)
BALL_STEPS = 200  # solver steps of seed 0 held card against CPU
BALL_TOL = 1e-8  # rel-L2 of those float64 states (cuFFT / cuBLAS / cuSOLVER vs the CPU's rounding)
SA_LAYERS = 2  # nef.num_layers of the self-attention phases (26-28)
# The nef step and the fit on the kernels against eager: K2's 3xTF32 values enter three inner
# steps and a second-order outer gradient, which the first-order checks' 1e-5 does not cover.
NEF_TOL = 1e-4
# Output channels of each config's data, where not 1 (``prepare`` sets ``nef.num_out`` from it).
NUM_OUT = {"shallow_water": 3}
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 on the CUDA cores, the kernels' operand type
PEAK_TF32_FLOPS = 495e12  # tensor cores; K1's and K2's 3xTF32 products issue three per product
PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 operands: the bf16 programs' products
BF16 = torch.bfloat16
# The kernels' strict-f32 programs (3xTF32; the config's ``pallas_interpret``): the phases that hold
# a kernel path to eager or to the plain version at 1e-5 run there. ``kernel`` (the YAMLs' ``pallas``)
# decodes with bf16 operands on the card, as the JAX kernel does on its chip.
F32_KERNELS = "kernel_f32"
# Phase 35's gates of a bf16 program against the plain bf16 version (two right bf16 functions differ
# by chaotic roundings, so the gates are relative to the bf16 function's own distance from f32,
# gap = rel-L2(plain16, plain32)): rel-L2(kernel16, plain16) <= BF16_NEAR gap, rel-L2(kernel16,
# plain32) / gap in [BF16_LO, BF16_HI], and for K1's outputs rel-L2(kernel16, plain32) <= BF16_ABS
# (the JAX kernel's own record on its chip is 1.1e-2 at Navier-Stokes width) wherever the bf16
# function itself lies within it: at `diff_sphere`'s width (hid 16) the plain bf16 decode of a
# forecast's latents lies 6.9e-2 from f32 (PERF.md §6, an H100), and there the ratio gates hold K1.
BF16_NEAR, BF16_LO, BF16_HI, BF16_ABS = 0.35, 0.9, 1.1, 5e-2
# K2's bf16 checks stop the cotangent where an RFF ReLU lies this close to its kink, on every side.
# The bf16 products are exact and summed in f32, so two right bf16 programs' pre-activations differ
# by f32 rounding of their sums, as in f32: TIE_MARGIN. (2^-8 of the terms' magnitudes stopped
# every point at NS width; stopping at 1e-6 or 1e-5 moved no gate's number by more than its
# spread on an H100, PERF.md §6: the bf16 programs' distance from the plain bf16 version is their
# roundings', not the kinks'.)
BF16_TIE_MARGIN = TIE_MARGIN
# Where two right evaluations of the bf16 function lie farther apart than BF16_NEAR of its gap (the
# nef step, second order through three bf16 inner steps; K1 at many latents), the kernels are held
# to the exact bf16 function x16 (the plain bf16 composition with the same roundings and float64
# sums) beside witnesses, more right evaluations of it (the plain bf16 composition on the card, and
# on the CPU: f32 sums in other orders, other sin / exp / rsqrt): with gap = rel-L2(x16, plain32),
# the kernels' rel-L2 to x16 may be WITNESS_FACTOR times the farthest witness's on any draw, and
# their ratio rel-L2(., plain32) / gap may leave 1 by WITNESS_FACTOR times the witnesses' (or by
# BF16_NEAR and BF16_HI - 1, where wider). The nef step runs NEF_WITNESS_SEEDS draws.
NEF_WITNESS_SEEDS = 3
WITNESS_FACTOR = 1.5
# Phases 30-33.
REMAT_TOL = 1e-6  # rel-L2, a step with the rollout rematerialized against it stored
LONG_HORIZON = 50  # navier_stokes.yaml's traj_len_out_horizon: the rollout remat is for
WORLD = 2  # ranks of the gloo world on the one card
WORLD_TOL = 1e-6  # rel-L2, a rank's step against this process's on the same rows: f32 rounding of a mean
WORLD_DIR = OUT_DIR / "world"
SPLIT_STEPS = 1000  # Navier-Stokes steps held split against complex
SPLIT_TOL = 1e-4  # their rel-L2 (f32 matmul DFT against cuFFT, after 1,000 steps)
# Phase 36: the repo's trained JAX runs, exported by tools/export_jax_checkpoint.py under weights/.
TRAINED_RUNS = ("ns8192_s0", "diff_plane_full_s0", "sw_full_s1", "ihc_full_s0")
WEIGHTS_DIR = Path(__file__).resolve().parent / "weights"
TRAINED_TOL = 1e-5  # rel-L2 of eager and the f32 K1 against JAX's f32 decode (the CPU's worst: 4.9e-6)
# rel-L2 of the xla forecast against JAX's: the fit, the rollout and the decode compound the sum
# orders (the CPU's worst: 5.1e-6, tests/test_torch_trained_export.py).
TRAINED_FORECAST_TOL = 1e-3
# The in-t validation MSE within this factor of the run's record (its last validation over its own
# test split), where the test trajectories number MSE_GATED_SIGNALS or more; else printed beside it.
MSE_FACTOR, MSE_GATED_SIGNALS = 2.0, 8
# The earlier phases' test trajectories, kept on the host for phases 36 and 37 (the data directories are
# removed after their phases): dataset name -> [n, frames, *spatial, channels] as the loader yields them;
# RAW_SPLITS: dataset name -> (its cache's directory name, the trajectories as the solver wrote them) of
# the splits phase 37 trains on.
TEST_SPLITS = {}
RAW_SPLITS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float = REL_L2_TOL) -> float:
    """Fail unless ``out`` matches ``ref`` within rel-L2 ``tol``; return the max abs error."""
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite values")
    rel = rel_l2(out, ref)
    err = float((out - ref).abs().max())
    log(f"[check] {name}: rel_l2 {rel:.3e} max_abs_err {err:.3e} (tol rel_l2 {tol:g})")
    if not rel <= tol:
        raise AssertionError(f"{name}: rel_l2 {rel:.3e} > {tol:g}")
    return err


def sync_time(fn):
    """(result, seconds) of ``fn()`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def smooth_frames(n: int, size: int, seed: int) -> np.ndarray:
    """``n`` smooth periodic fields on a size x size torus grid, [n, size, size, 1]."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2 * np.pi, size, endpoint=False)
    X, Y = np.meshgrid(ang, ang, indexing="ij")
    frames = np.zeros((n, size, size), dtype=np.float64)
    for i in range(n):
        for kx in range(0, 5):
            for ky in range(-4, 5):
                if kx == 0 and ky <= 0:
                    continue
                amp = rng.standard_normal() / (kx * kx + ky * ky)
                frames[i] += amp * np.cos(kx * X + ky * Y + rng.uniform(0, 2 * np.pi))
        frames[i] /= np.abs(frames[i]).max()
    return frames[..., None].astype(np.float32)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def smooth_trajectories(n: int, frames: int, size: int, seed: int) -> np.ndarray:
    """``n`` smooth periodic fields drifting in time, [n, frames, size, size, 1]."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2 * np.pi, size, endpoint=False)
    X, Y = np.meshgrid(ang, ang, indexing="ij")
    out = np.zeros((n, frames, size, size), dtype=np.float64)
    ts = np.arange(frames)[:, None, None]
    for i in range(n):
        for kx in range(0, 5):
            for ky in range(-4, 5):
                if kx == 0 and ky <= 0:
                    continue
                amp = rng.standard_normal() / (kx * kx + ky * ky)
                phase, omega = rng.uniform(0, 2 * np.pi), rng.uniform(-0.2, 0.2)
                out[i] += amp * np.cos(kx * X + ky * Y + phase + omega * ts)
        out[i] /= np.abs(out[i]).max()
    return out[..., None].astype(np.float32)


def grad_errors(got, want):
    """``(worst rel-L2, its tensor's name, max abs error, tensors compared)`` of every
    gradient tensor of ``got`` against ``want`` (nested sequences or dicts of tensors,
    None where there is no gradient)."""
    def flat(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{prefix}{k}.")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                yield from flat(v, f"{prefix}{i}.")
        else:
            yield prefix.rstrip("."), x
    worst, worst_name, err, n = 0.0, "", 0.0, 0
    for (name, g), (_, w) in zip(flat(got), flat(want), strict=True):
        if w is None:
            if g is not None:
                raise AssertionError(f"{name}: a gradient where the plain version has none")
            continue
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite")
        ref = float(torch.linalg.vector_norm(w))
        diff = float(torch.linalg.vector_norm(g - w))
        rel = diff / ref if ref > 0 else (0.0 if diff == 0 else float("inf"))
        err = max(err, float((g - w).abs().max()))
        n += 1
        if rel >= worst:
            worst, worst_name = rel, name
    return worst, worst_name, err, n


def check_grads(label: str, got, want, tol: float = REL_L2_TOL) -> float:
    """Hold every gradient tensor of ``got`` against ``want`` within rel-L2 ``tol`` (see
    ``grad_errors``); one line; returns the max abs error."""
    worst, worst_name, err, n = grad_errors(got, want)
    log(f"[check] {label}: {n} tensors, worst rel_l2 {worst:.3e} ({worst_name}), max_abs_err "
        f"{err:.3e} (tol rel_l2 {tol:g} each)")
    if not worst <= tol:
        raise AssertionError(f"{label}: {worst_name} rel_l2 {worst:.3e} > {tol:g}")
    return err


def config_coords(cfg) -> np.ndarray:
    """The decode grid of a config's dataset, as its registry entry gives it."""
    return dataset_spec(cfg.dataset.name, device="cpu").coords


def shape_config(name: str, *overrides: str):
    """Experiment ``name``'s config with ``nef.num_out`` as its data sets it (three
    channels for shallow water; the YAML says 1, and ``prepare`` fills in the data's)."""
    return load_experiment_config(name, [f"nef.num_out={NUM_OUT.get(name, 1)}", *overrides])


def sphere_trajectories(n: int, frames: int, nphi: int, ntheta: int, channels: int, seed: int) -> np.ndarray:
    """``n`` smooth fields on a (phi, theta) grid drifting in longitude, [n, frames, nphi,
    ntheta, channels]."""
    rng = np.random.default_rng(seed)
    phi = np.linspace(0.0, 2 * np.pi, nphi, endpoint=False)[:, None]
    theta = np.linspace(0.0, np.pi, ntheta + 2)[None, 1:-1]
    out = np.zeros((n, frames, nphi, ntheta, channels))
    ts = np.arange(frames)[:, None, None]
    for i in range(n):
        for c in range(channels):
            for m in range(4):
                amp, ph, om = rng.standard_normal(), rng.uniform(0, 2 * np.pi), rng.uniform(-0.2, 0.2)
                out[i, ..., c] += amp * np.cos(m * phi + ph + om * ts) * np.sin(theta) ** m
        out[i] /= np.abs(out[i]).max()
    return out.astype(np.float32)


def decode_inputs(cfg, coords: np.ndarray, dev, b: int, M: int, seed: int, gen=None):
    """The kernels' inputs at full width for ``b`` frames of seeded random latents decoded
    at ``M`` coordinates drawn from ``coords`` (all of them, in order, when ``M`` is their
    number): ``(inv, wb, A, ab, G, c, ws, tws)`` with the tail."""
    decoder, x, p, a, w = random_decode(cfg, coords, dev, b, M, seed, gen)
    with torch.no_grad():
        return decoder.kernel_inputs(x, p, a, w)


def random_decode(cfg, coords: np.ndarray, dev, b: int, M: int, seed: int, gen=None):
    """A decoder of ``cfg`` with seeded random weights and ``(x, p, a, w)``: ``b`` frames of
    seeded random latents and ``M`` coordinates drawn from ``coords`` (all of them, in
    order, when ``M`` is their number)."""
    decoder, _ = build_models(cfg)
    reset_parameters(decoder, torch.Generator().manual_seed(SEED))
    decoder.to(dev)
    gen = gen or torch.Generator().manual_seed(seed)
    Z = cfg.nef.num_latents
    idx = torch.randperm(coords.shape[0], generator=gen)[:M] if M < coords.shape[0] else torch.arange(M)
    x = torch.from_numpy(coords)[idx][None].expand(b, -1, -1).to(dev)
    if decoder.cross_attn_invariant.num_z_pos_dims == 4:  # the ball: Euler angles and a radius
        p = torch.rand(b, Z, 4, generator=gen) * torch.tensor([2 * math.pi] * 3 + [1.0])
    else:
        p = torch.rand(b, Z, 2, generator=gen) * 2 - 1
    if decoder.cross_attn_invariant.num_z_ori_dims:  # SE(2) poses carry an angle
        p = torch.cat([p, (torch.rand(b, Z, 1, generator=gen) * 2 - 1) * math.pi], dim=-1)
    p = p.to(dev)
    a = (1 + 0.5 * torch.randn(b, Z, cfg.nef.latent_dim, generator=gen)).to(dev)
    w = torch.full((b, Z, 1), 1.0, device=dev)
    return decoder, x, p, a, w


def k2_inputs(cfg, coords: np.ndarray, dev, b=None):
    """K2's inputs at the ode step's decode shape (batch x ``traj_len_train`` frames x
    ``max_num_sampled_points``, full width: 80 x 512 for Navier-Stokes, 10 x 2048 for
    shallow water), or ``b`` frames of that many points, and a cotangent for each mode:
    ``(args, {with_tail: g})``."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    gen = torch.Generator().manual_seed(SEED + 2)
    b = b or cfg.dataset.batch_size * cfg.dataset.traj_len_train
    M = cfg.training.max_num_sampled_points
    args = decode_inputs(cfg, coords, dev, b, M, SEED + 2, gen)
    g = {tail: torch.randn(b, M, cfg.nef.num_out if tail else H * D, generator=gen).to(dev)
         for tail in (True, False)}
    return args, g


def k1_l2_bytes_per_point(args, tile: int = 32) -> float:
    """Weight bytes K1 streams from L2 per tile of ``tile`` decoded points, per point: q_w1,
    v_w1 and fw once per latent group and m_w2 once per pair of latents and pair of heads,
    pre-split (8 bytes an element), where the width class streams them (128, or a ring);
    none where they are resident (loaded once per persistent block); G and A once per latent
    and the tail once, in f32."""
    inv, ws, tws = args[0], args[6], args[7]
    Z, (hid, H), (hidm, D) = inv.shape[1], args[2].shape[2:], ws[8].shape
    k, wn = k1_constants(), k1_width_class(hid, hidm, D)
    split = 0
    if wn == k["WG_N"] or not k[f"RES{wn}"]:
        zg = k["ZG"] if wn == k["WG_N"] else k[f"ZG{wn}"]
        split = -(-Z // zg) * sum(ws[i].numel() for i in (1, 4, 6)) + -(-Z // 2) * -(-H // 2) * ws[8].numel()
    per_latent = args[4][0, 0].numel() + args[2][0, 0].numel()
    tail = sum(t.numel() for t in tws if t.dim() == 2)
    return (8 * split + 4 * (Z * per_latent + tail)) / tile


def k1_bf16_l2_bytes_per_point(args, tile: int, wn: int) -> float:
    """Weight bytes the bf16 program at width class ``wn`` reads from L2 per work item of ``tile`` points,
    per point: each latent's G (bf16, a ``wn``-column slab a head), A and c (f32), and at the class 128 its
    q_w1, v_w1 and fw (bf16, 128-column slabs; resident at the narrow classes); the tail's blocked weights
    (``wn``-column slabs) and h_w3 once; m_w2 none (resident in a persistent block)."""
    inv, ws, tws = args[0], args[6], args[7]
    Z, (hid, H), hidm = inv.shape[1], args[2].shape[2:], ws[8].shape[0]
    slab = 2 * wn  # bytes of a bf16 row of a wn-column slab
    per_latent = (3 * hid * slab if wn == 128 else 0) + H * hid * slab + 4 * (hid * H + H * hidm)
    tail = sum(t.shape[0] * -(-t.shape[1] // wn) * slab for t in tws[0:10:2]) + 4 * tws[10].numel() if tws else 0
    return (Z * per_latent + tail) / tile


def k1_bounds(cfg, args, out) -> dict:
    """The least times of K1's work on the card: f32 on the CUDA cores by operations,
    3xTF32 on the tensor cores (3 products per product), and by bytes; ``bound_ms`` is
    the route K1 takes, the larger of the 3xTF32 and the bytes bound. And the design's
    L2 weight bytes per point."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    inv, ws, tws = args[0], args[6], args[7]
    B, Zl, C, I = inv.shape
    hid, hidm = ws[1].shape[0], ws[8].shape[0]
    flops = decode_flops_per_point(H, D, hid, hidm, Zl, I, cfg.nef.num_out) * B * C
    moved = nbytes(args[:6]) + nbytes(ws) + nbytes(tws) + nbytes([out])
    b_bytes, b_tc = moved / PEAK_BYTES_PER_S * 1e3, 3 * flops / PEAK_TF32_FLOPS * 1e3
    return dict(flops=flops, moved=moved, bytes_ms=b_bytes, f32_ms=flops / PEAK_F32_FLOPS * 1e3,
                tc_ms=b_tc, bound_ms=max(b_bytes, b_tc),
                bound_by="bytes" if b_bytes >= b_tc else "operations",
                l2_per_point=k1_l2_bytes_per_point(args))


def k1_class_note(args, num_heads: int, head_dim: int, num_out: int) -> str:
    """K1's width class and blocks an SM for a launch of ``args`` (the built library's)."""
    inv, ws = args[0], args[6]
    B, Z, C, I = inv.shape
    wn, per_sm = k1_occupancy([B, Z, C, I, ws[1].shape[0], num_heads, head_dim, ws[8].shape[0], num_out,
                               int(len(args[7]) > 0)])
    return f"width class {wn}, {per_sm} blocks an SM"


def relu_margins(args) -> torch.Tensor:
    """[b, z, c]: over the units of the query and value RFF nets' ReLUs, the least
    |pre-activation| as a share of the sum of its terms' magnitudes, in f64 from the f32
    inputs ``args`` (K1's and K2's)."""
    inv, ws = args[0].double(), args[6]
    out = torch.full(inv.shape[:3], float("inf"), dtype=torch.float64, device=inv.device)
    for coeff, w1, b1 in ((ws[0], ws[1], ws[2]), (ws[3], ws[4], ws[5])):
        proj = 2 * math.pi * (inv @ coeff.double())
        feats = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        pre = feats @ w1.double() + b1.double()
        scale = feats.abs() @ w1.double().abs() + b1.double().abs()
        out = torch.minimum(out, (pre.abs() / scale).amin(dim=-1))
        del proj, feats, pre, scale
    return out


def relu_ties(args, margin: float = TIE_MARGIN) -> torch.Tensor:
    """[b, c] bool: the points at which some latent's RFF ReLU has a pre-activation within
    ``margin`` of its terms' summed magnitude from 0 (``relu_margins``). There the
    derivative jumps, and f32 sums in either order may round the pre-activation to either
    side, so two right f32 VJPs differ by a whole unit's share."""
    return (relu_margins(args) < margin).any(dim=1)


def k2_check(cfg, args, g, bwd=fused_decode_bwd) -> float:
    """K2 (``bwd``) against its plain version in all four modes; the max abs error. The
    cotangent is zero at the points ``relu_ties`` finds, where the VJP is not determined
    to f32 rounding; the errors with the whole cotangent are printed beside."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    errs = []
    B, C = args[0].shape[0], args[0].shape[2]
    keep = ~relu_ties(args)
    for tail in (True, False):
        kargs = args if tail else (*args[:7], ())
        for wg in (False, True):
            label = f"K2 {'tail' if tail else 'no-tail'} {'with' if wg else 'without'} weight grads b={B} c={C}"
            whole = grad_errors(bwd(*kargs, g[tail], H, D, wg), fused_decode_bwd_plain(*kargs, g[tail], H, D, wg))
            log(f"[check] {label}, the whole cotangent: worst rel_l2 {whole[0]:.3e} ({whole[1]}); "
                f"{int((~keep).sum())} of {keep.numel()} points are within {TIE_MARGIN:g} of a ReLU's kink")
            gk = g[tail] * keep[..., None]
            errs.append(check_grads(f"{label}, cotangent 0 at those points",
                                    bwd(*kargs, gk, H, D, wg), fused_decode_bwd_plain(*kargs, gk, H, D, wg)))
    torch.cuda.synchronize()
    return max(errs)


def k2_bounds(cfg, args, g, wg: bool) -> dict:
    """The least times of K2's work on the card (tail mode): f32 on the CUDA cores by
    operations, 3xTF32 on the tensor cores (3 products per product), and by bytes;
    ``bound_ms`` is the route K2 takes, the larger of the 3xTF32 and the bytes bound."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    inv, ws, tws = args[0], args[6], args[7]
    B, Zl, C, I = inv.shape
    hid, hidm = ws[1].shape[0], ws[8].shape[0]
    out = fused_decode_bwd_plain(*args, g, H, D, wg)
    grads = [t for t in (*out[:6], *out[6], *out[7]) if t is not None]
    flops = decode_bwd_flops_per_point(H, D, hid, hidm, Zl, I, cfg.nef.num_out, wg) * B * C
    moved = nbytes(args[:6]) + nbytes(ws) + nbytes(tws) + nbytes([g]) + nbytes(grads)
    b_bytes, b_tc = moved / PEAK_BYTES_PER_S * 1e3, 3 * flops / PEAK_TF32_FLOPS * 1e3
    return dict(flops=flops, moved=moved, bytes_ms=b_bytes, f32_ms=flops / PEAK_F32_FLOPS * 1e3,
                tc_ms=b_tc, bound_ms=max(b_bytes, b_tc),
                bound_by="bytes" if b_bytes >= b_tc else "operations")


def k2_layout(args, num_heads: int, head_dim: int, num_out: int, wg: bool, dtype=torch.float32) -> dict:
    """The built K2 library's layout of a tail launch of ``args`` (shared memory, blocks an SM,
    grid, row slots, scratch bytes) for the program of ``dtype``, held equal to the Python mirrors
    ``k2_smem_bytes`` and ``k2_scratch_bytes`` (at the library's blocks an SM and this card's SMs);
    with the items a block takes (the bf16 narrow design's items are (b, z, tile)) and the design."""
    inv, ws = args[0], args[6]
    B, Z, C, I = inv.shape
    hid, hidm = ws[1].shape[0], ws[8].shape[0]
    src = BWD_KERNEL_SOURCE_BF16 if dtype == BF16 else BWD_KERNEL_SOURCE
    lay = k2_occupancy([B, Z, C, I, hid, num_heads, head_dim, hidm, num_out, 1, int(wg)], src)
    narrow = dtype == BF16 and k2_narrow_design(hid, hidm, head_dim)
    lay["ipb"] = -(-B * (Z if narrow else 1) * -(-C // 64) // lay["grid"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mirror = (k2_smem_bytes(Z, I, hid, num_heads, head_dim, hidm, dtype),
              k2_scratch_bytes(B, Z, C, I, hid, num_heads, head_dim, hidm, num_out, True, wg, lay["per_sm"], sms,
                               compute_dtype=dtype))
    if mirror != (lay["smem"], lay["scratch"]):
        raise AssertionError(f"K2's layout {lay} differs from its Python mirror (smem, scratch) {mirror}")
    lay["w128"] = dtype == BF16 and k2_w128_design(Z, hid, num_heads, head_dim, hidm)
    lay["design"] = "the W128 design" if lay["w128"] else "the narrow design" if narrow else "the class design"
    return lay


def k2_repeat_check(cfg, args, g) -> None:
    """Two K2 launches with the tail and weight gradients on the same inputs: equal bit for bit
    (its partials are reduced in a fixed order, with no atomics); and a launch without weight
    gradients gives the same bits of dinv, dwb, dA, dab, dG and dc (the partition of the work, and
    so the order of every sum, does not depend on the flag)."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    a = [t for t in grad_list(fused_decode_bwd(*args, g, H, D, True)) if t is not None]
    b = [t for t in grad_list(fused_decode_bwd(*args, g, H, D, True)) if t is not None]
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("two K2 launches on the same inputs differ")
    c = fused_decode_bwd(*args, g, H, D, False)[:6]
    if not all(torch.equal(x, y) for x, y in zip(a[:6], c)):
        raise AssertionError("K2's latent gradients differ with and without weight gradients")
    log(f"[check] K2 b={args[0].shape[0]} c={args[0].shape[2]}: two launches equal bit for bit ({len(a)} tensors); "
        "without weight gradients the same bits of the six latent gradients")


def grad_list(x):
    return [v for t in x for v in (t if isinstance(t, tuple) else (t,))]


def k2_phase(cfg, coords: np.ndarray, dev, b=None) -> dict:
    """5 / 17 / 20 / 27 / 30 / 31 / 34. K2 against its plain version at the ode step's decode
    shape (or at ``b`` frames of it), one launch repeated bit for bit; its timing beside its
    scratch bytes per launch and blocks an SM (the library's, held equal to the mirrors)."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    args, g = k2_inputs(cfg, coords, dev, b)
    max_err = k2_check(cfg, args, g)
    k2_repeat_check(cfg, args, g[True])
    B, Zl, C = args[0].shape[:3]
    timing = {}
    for wg in (False, True):
        lay = k2_layout(args, H, D, cfg.nef.num_out, wg)
        k_ms = cuda_ms(lambda: fused_decode_bwd(*args, g[True], H, D, wg), iters=10)
        p_ms = cuda_ms(lambda: fused_decode_bwd_plain(*args, g[True], H, D, wg), iters=3, warmup=1)
        bd = k2_bounds(cfg, args, g[True], wg)
        timing[wg] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                          scratch_bytes=lay["scratch"], blocks_per_sm=lay["per_sm"])
        log(f"[timing] K2 {'with' if wg else 'without'} weight grads, tail, b={B} z={Zl} c={C}: "
            f"{k_ms:.4f} ms ({bd['flops'] / k_ms / 1e9:.2f} TFLOP/s); plain {p_ms:.4f} ms; bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} (f32 CUDA cores {bd['f32_ms']:.4f} ms, "
            f"3xTF32 tensor cores {bd['tc_ms']:.4f} ms, bytes {bd['bytes_ms']:.4f} ms: "
            f"{bd['flops'] / 1e9:.3f} GFLOP, {bd['moved'] / 1e6:.3f} MB); scratch {lay['scratch'] / 1e6:.1f} MB "
            f"a launch, {lay['per_sm']} blocks an SM, grid {lay['grid']}, {lay['smem']} B shared")
    return {"max_abs_err": max_err, "timing": timing}


def make_trainer(cfg, coords: np.ndarray, seed: int = SEED) -> MetaSGDTrainer:
    decoder, ode_model = build_models(cfg)
    return MetaSGDTrainer(cfg, decoder, ode_model, coords, seed=seed, device="cuda")


class TieStop(torch.nn.Module):
    """``decoder`` with the cotangent 0 at the points where an RFF ReLU of its kernel inputs
    lies within TIE_MARGIN of its kink (``relu_ties``): the values are the decoder's, the
    gradient there is none. There two right f32 VJPs differ by a unit's whole share, as in
    ``k2_check``. The first wrapper finds the points of each decode and keeps them in
    ``masks``; a wrapper given ``masks`` stops the same points in the same order of decodes,
    so every side of a step check (kernels, eager, float64) drops the same terms."""

    def __init__(self, decoder, masks=None):
        super().__init__()
        self.decoder = decoder
        self.replay = masks is not None
        self.masks = list(masks) if self.replay else []
        self.calls = 0

    def forward(self, x, p, a, w, backend="eager"):
        out = self.decoder(x, p, a, w, backend=backend)
        if self.replay:
            stop = self.masks[self.calls]
        else:
            with torch.no_grad():
                stop = relu_ties(self.decoder.kernel_inputs(x, p, a, w))
            self.masks.append(stop)
        self.calls += 1
        keep = (~stop)[..., None].to(out.dtype)
        return out * keep + out.detach() * (1 - keep)


def step_parity_phase(cfg, coords: np.ndarray, traj: np.ndarray, dev, zero_by_structure=(),
                      ties: bool = False, seed: int = SEED, gate: bool = True) -> float:
    """6 / 17 / 22 / 26. ode and dual step on K1 + K2 (their f32 programs, F32_KERNELS) against the eager decoder, on
    trajectories ``traj`` [batch, frames, *grid, channels]: loss and gradients, from the
    weights of ``seed`` and its masks. ``ties`` holds the gradients with the cotangent 0 at
    the points near an RFF ReLU's kink (``TieStop``: the same points on every side; their
    number printed) and prints beside, with no gate, the whole steps' errors and each f32
    step's distance from the step in float64, with the whole cotangent and with those points
    stopped: behind the self-attention stack (phase 26) a few such points move the ODE's
    gradient by about the gate. ``zero_by_structure`` names decoder gradients that are 0 in
    exact arithmetic (``abs_pos``: the key bias, whose term q . b is the same for every
    latent and cancels in the softmax). Their relative error is rounding over rounding;
    instead both sides must lie below 1e-6 of the step's whole gradient norm, and they leave
    the relative check. ``gate=False`` prints the checks' errors and holds them to nothing:
    a witness draw. Returns the worst max abs error of the checks (0 with no gate)."""
    trainer = make_trainer(cfg, coords, seed)
    state = trainer.init_state()
    traj = torch.from_numpy(traj).to(dev)
    gen = torch.Generator().manual_seed(seed + 5)
    N, M, K = coords.shape[0], cfg.training.max_num_sampled_points, cfg.meta.num_inner_steps
    masks = torch.stack([torch.randperm(N, generator=gen)[:M] for _ in range(K + 1)])
    ode_masks = torch.stack([torch.randperm(N, generator=gen)[:M]
                             for _ in range(cfg.dataset.traj_len_train)])
    decoder = trainer.decoder

    def both(fn):
        """(kernel's, eager's) (loss, gradients) of step ``fn``."""
        out = []
        for backend in (F32_KERNELS, "eager"):
            trainer.ode_backend = backend
            k1, k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
            with on_path():
                out.append(fn(state, traj, masks=masks, ode_masks=ode_masks))
                torch.cuda.synchronize()
            if backend == F32_KERNELS and (fused_decode_fwd.launches - k1, fused_decode_bwd.launches - k2) != (1, 1):
                raise AssertionError("a step on the kernel backend did not launch K1 and K2 once each")
        trainer.ode_backend = F32_KERNELS
        return out

    def from_f64(tag, kind, grads_k, grads_e, stop=None):
        _, grads_64 = f64_step(trainer, kind, state, traj, stop=stop, masks=masks, ode_masks=ode_masks)
        log(f"[check] {kind} step {tag}, against the step in float64 (seed {seed}, no gate): kernels "
            + ", eager decoder ".join("worst rel_l2 {:.3e} ({})".format(*grad_errors(g, grads_64)[:2])
                                      for g in (grads_k, grads_e)))

    errs = []
    for kind, fn in (("ode", trainer.ode_grads), ("dual", trainer.dual_grads)):
        (loss_k, grads_k), (loss_e, grads_e) = both(fn)
        label = ""
        if ties:
            worst, name, _, n = grad_errors(grads_k, grads_e)
            log(f"[check] {kind} step gradients, kernels vs eager decoder, the whole cotangent (seed {seed}): "
                f"{n} tensors, worst rel_l2 {worst:.3e} ({name})")
            from_f64("the whole cotangent", kind, grads_k, grads_e)
            trainer.decoder = stop = TieStop(decoder)
            _, grads_k = fn(state, traj, masks=masks, ode_masks=ode_masks)
            trainer.ode_backend = "eager"
            trainer.decoder = replay = TieStop(decoder, stop.masks)
            _, grads_e = fn(state, traj, masks=masks, ode_masks=ode_masks)
            trainer.decoder, trainer.ode_backend = decoder, F32_KERNELS
            if replay.calls != len(stop.masks):
                raise AssertionError(f"the eager step decoded {replay.calls} times, the kernels' {len(stop.masks)}")
            label = f", cotangent 0 within {TIE_MARGIN:g} of a ReLU's kink"
            log(f"[check] {kind} step (seed {seed}): the cotangent is 0 at "
                f"{[int(m.sum()) for m in stop.masks]} of {[m.numel() for m in stop.masks]} points of its decodes")
            from_f64("with those points' cotangent 0 on every side", kind, grads_k, grads_e, stop.masks)
        if not gate:
            worst, name, _, n = grad_errors(grads_k, grads_e)
            log(f"[check] {kind} step, kernels vs eager decoder{label} (seed {seed}, no gate): loss rel "
                f"{abs(float(loss_k) - float(loss_e)) / abs(float(loss_e)):.3e}, {n} gradient tensors, worst "
                f"rel_l2 {worst:.3e} ({name})")
            continue
        errs.append(check_close(f"{kind} step loss, kernels vs eager decoder", loss_k, loss_e))
        scale = math.sqrt(sum(float(v.square().sum()) for group in grads_e.values() for v in group.values()))
        for name in (n for n in zero_by_structure if n in grads_e.get("nef", {})):
            norms = [float(torch.linalg.vector_norm(g["nef"].pop(name))) for g in (grads_k, grads_e)]
            log(f"[check] {kind} step gradient of {name}, 0 by structure: norm {norms[0]:.3e} on the "
                f"kernels, {norms[1]:.3e} eager, against the step's gradient norm {scale:.3e} (tol 1e-6 of it)")
            if not max(norms) <= 1e-6 * scale:
                raise AssertionError(f"{kind} step: {name} is not 0 to rounding: {norms} vs {scale:.3e}")
        errs.append(check_grads(f"{kind} step gradients, kernels vs eager decoder{label}", grads_k, grads_e))
    return max(errs, default=0.0)


def fresh_dir(path: Path) -> Path:
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def data_phase(dev) -> dict:
    """7. Navier-Stokes trajectories generated on the card by ``get_dataloader``."""
    cfg = load_experiment_config("navier_stokes", [f"dataset.path={fresh_dir(DATA_DIR)}",
                                                   f"dataset.num_signals_train={TRAIN_SIGNALS}",
                                                   f"dataset.num_signals_test={VAL_SIGNALS}"])
    train, test = get_dataloader(cfg.dataset, device="cuda")
    steps = int(BURN_IN / NS_DT) + TRAIN_FRAMES * int(1.0 / NS_DT)  # generate_ns_trajectories
    block_s = {}
    for name, ldr in (("train", train), ("test", test)):
        block_s[name] = sync_time(ldr.ensure_all)[1]
    files = sorted(p.name for p in DATA_DIR.rglob("traj_*.npz"))
    log(f"[data] {len(files)} trajectories in 2 blocks of 16 on {torch.cuda.get_device_name(0)}: "
        + ", ".join(f"{n} {v:.2f} s ({steps / v:.0f} solver steps/s)" for n, v in block_s.items())
        + f"; {steps} steps a block")
    if len(files) != 32:
        raise AssertionError(f"expected 32 cached trajectories (2 aligned blocks of 16), found {len(files)}")
    worst_mean = 0.0
    for name, ldr in (("train", train), ("test", test)):
        batch = next(iter(ldr))[0]
        if batch.shape != (8, TRAIN_FRAMES, GRID, GRID, 1) or not np.isfinite(batch).all():
            raise AssertionError(f"{name} batch shape {batch.shape} or non-finite values")
        worst_mean = max(worst_mean, float(np.abs(batch.mean(axis=(2, 3, 4))).max()))
        log(f"[data] {name} batch {tuple(batch.shape)}: |w| max {np.abs(batch).max():.3f}, "
            f"std {batch.std():.3f}")
    log(f"[data] largest |spatial mean| of a frame {worst_mean:.3e} (tol {MEAN_TOL:g}; forcing and "
        f"initial field have zero mean)")
    if not worst_mean <= MEAN_TOL:
        raise AssertionError(f"a frame's spatial mean {worst_mean:.3e} > {MEAN_TOL:g}")

    sampler = GaussianRF2D(GRID)
    coeff = sampler.coefficients(SEED)
    if not torch.equal(coeff, sampler.coefficients(SEED)):
        raise AssertionError("the seed's coefficients are not reproducible")
    w_cpu, w_gpu = sampler.field(coeff[None]), sampler.field(coeff[None].to(dev))
    field_rel = rel_l2(w_gpu.cpu(), w_cpu)
    runs = [navier_stokes_rollout(w0, default_forcing(GRID, w0.device), NS_VISC, NS_DT, 1, 1000)[1]
            for w0 in (w_cpu, w_cpu.to(dev))]
    solver_rel = rel_l2(runs[1].cpu(), runs[0])
    log(f"[data] seed {SEED}: coefficients drawn on the CPU, initial field card vs CPU rel_l2 "
        f"{field_rel:.3e}; 1000 solver steps card vs CPU rel_l2 {solver_rel:.3e} (tol {SOLVER_TOL:g})")
    if not (field_rel <= SOLVER_TOL and solver_rel <= SOLVER_TOL):
        raise AssertionError(f"card and CPU solvers disagree: {field_rel:.3e}, {solver_rel:.3e}")
    keep_test_split("navier_stokes", DATA_DIR, VAL_SIGNALS, raw=True)
    return {"block_s": block_s, "steps": steps}


def train_overrides(*extra: str, log_dir: Path = LOG_DIR) -> list:
    """The training phase's overrides of the navier_stokes config (full width)."""
    return [f"dataset.path={DATA_DIR}", f"dataset.num_signals_train={TRAIN_SIGNALS}",
            f"dataset.num_signals_test={VAL_SIGNALS}", f"logging.log_dir={log_dir}",
            "training.num_epochs=3", "training.nef.train_from_epoch=0",
            "training.nef.train_until_epoch=2", "training.ode.train_from_epoch=1",
            "training.ode.train_until_epoch=3", "test.test_interval=3", "test.test_dp_interval=3",
            "test.test_equiv_at_epoch=0", "logging.log_every_n_steps=1",
            "logging.checkpoint_every_n_epochs=1", "logging.keep_n_checkpoints=2", *extra]


def read_metrics() -> list:
    return [json.loads(ln) for ln in (LOG_DIR / "metrics.jsonl").read_text().splitlines()]


def check_restore(loop, state) -> None:
    """The latest checkpoint restored into a freshly built trainer equals the live one."""
    live = loop.trainer
    decoder, ode_model = build_models(live.cfg)
    fresh = MetaSGDTrainer(live.cfg, decoder, ode_model, live.coords.cpu().numpy(), seed=SEED + 9,
                           device="cuda")
    restored, _ = loop.checkpoints.restore(fresh)

    def tensors(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from tensors(v, f"{prefix}{k}.")
        else:
            yield prefix.rstrip("."), x

    pairs = [(f"nef.{k}", v, fresh.decoder.state_dict()[k]) for k, v in live.decoder.state_dict().items()]
    pairs += [(f"ode.{k}", v, fresh.ode_model.state_dict()[k]) for k, v in live.ode_model.state_dict().items()]
    got = dict(tensors(restored))
    pairs += [(k, v, got.pop(k)) for k, v in tensors(state)]
    pairs.append(("generator", live.generator.get_state(), fresh.generator.get_state()))
    bad = [k for k, a, b in pairs if not (torch.equal(a, b) if torch.is_tensor(a) else a == b)]
    log(f"[resume] epoch {loop.checkpoints.latest_epoch()} restored into a fresh trainer: "
        f"{len(pairs)} tensors and counts, {len(bad)} differ")
    if bad or got:
        raise AssertionError(f"restore differs at {bad[:5]}, extra {sorted(got)[:5]}")


def train_phase() -> dict:
    """8. ``run_experiment`` for 3 epochs (nef, dual, ode) at full width on the generated data."""
    cfg = load_experiment_config("navier_stokes", train_overrides())
    fresh_dir(LOG_DIR)
    torch.cuda.reset_peak_memory_stats()
    fused_decode_fwd.launches = fused_decode_bwd.launches = 0
    with on_path():
        (loop, state), run_s = sync_time(lambda: run_experiment(cfg, device="cuda"))
    k1, k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer = loop.trainer
    records = read_metrics()
    epochs = [r for r in records if "train_mse_epoch" in r]
    phases = [r["phase"] for r in epochs]
    val_rec = next(r for r in records if "val_mse_in_t" in r)
    dp_rec = next(r for r in records if "val_mse_in_t_dp5" in r)
    eqv = next((r["equivariance_err_translation"] for r in records
                if "equivariance_err_translation" in r), None)
    values = [r["train_mse_epoch"] for r in epochs] + [v for r in (val_rec, dp_rec)
                                                       for k, v in r.items() if "mse" in k]
    epoch_mse = ", ".join(f"{r['train_mse_epoch']:.4e}" for r in epochs)
    saved = loop.checkpoints.all_epochs()
    log(f"[train] run_experiment(3 epochs) in {run_s:.2f} s (data read, build and first calls "
        f"included): phases {phases}, train_mse_epoch [{epoch_mse}], val_mse_in_t "
        f"{val_rec['val_mse_in_t']:.4e} out_t {val_rec['val_mse_out_t']:.4e}, dp5 in_t "
        f"{dp_rec['val_mse_in_t_dp5']:.4e}; equivariance_err_translation {eqv}; checkpoints "
        f"{saved}; K1 launches {k1}, K2 launches {k2}; peak memory {peak:.2f} GiB")
    if phases != ["nef", "nef+ode", "ode"]:
        raise AssertionError(f"phases {phases} != nef, nef+ode, ode")
    if not all(np.isfinite(v) for v in values):
        raise AssertionError(f"non-finite training or validation metrics: {values}")
    if eqv is None or not np.isfinite(eqv):
        raise AssertionError(f"equivariance_err_translation not logged or not finite: {eqv}")
    if saved != [2, 3]:
        raise AssertionError(f"checkpoints {saved} != [2, 3]")
    n_train, n_val = len(loop.train_loader), len(loop.val_loader)
    val_steps = (n_val + n_train) * (1 + 3)  # val + 3 dp variants, over val and train loaders
    decodes_per_val = -(-(trainer.coords.shape[0]) // cfg.training.max_num_sampled_points)
    expect = (2 * n_train + val_steps * decodes_per_val, 2 * n_train)  # the equivariance fit is eager
    if (k1, k2) != expect or k2 == 0:
        raise AssertionError(f"K1/K2 launches {(k1, k2)} != expected {expect}")
    check_restore(loop, state)

    medians = step_medians(trainer, state, next(iter(loop.train_loader))[0], "train")
    log(f"[train] peak memory of the run and the timed steps: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"k1": k1, "k2": k2, "medians": medians}


def step_medians(trainer, state, traj, tag: str) -> dict:
    """Each step kind's median warm time in ms over WARM_REPEATS calls on one batch."""
    medians = {}
    for name, fn in (("nef", trainer.nef_train_step), ("dual", trainer.dual_train_step),
                     ("ode", trainer.ode_train_step), ("val", trainer.val_step)):
        samples = [sync_time(lambda: fn(state, traj))[1] * 1e3 for _ in range(WARM_REPEATS)]
        medians[name] = statistics.median(samples)
        log(f"[{tag}] {name} step on generated data {tuple(traj.shape)} (warm, median of "
            f"{WARM_REPEATS}): {medians[name]:.2f} ms (samples {', '.join(f'{v:.2f}' for v in samples)})")
    return medians


def resume_phase() -> dict:
    """9. Resume from the epoch-3 checkpoint with the ode window moved to epoch 4."""
    cfg = load_experiment_config("navier_stokes", train_overrides(
        "logging.resume=true", "training.ode.train_until_epoch=4", "training.num_epochs=4"))
    before = len(read_metrics())
    fused_decode_fwd.launches = fused_decode_bwd.launches = 0
    with on_path():
        (loop, _), run_s = sync_time(lambda: run_experiment(cfg, device="cuda"))
    k1, k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
    records = read_metrics()[before:]
    resumed = next((r for r in records if "resumed_from_epoch" in r), {})
    epochs = [(r["epoch"], r["phase"]) for r in records if "train_mse_epoch" in r]
    log(f"[resume] run_experiment(num_epochs=4, resume) in {run_s:.2f} s: resumed from epoch "
        f"{resumed.get('resumed_from_epoch')}, epochs {epochs}, config differs at "
        f"{resumed.get('resumed_config_differs')}; checkpoints {loop.checkpoints.all_epochs()}; "
        f"K1 launches {k1}, K2 launches {k2}")
    if epochs != [(4, "ode")]:
        raise AssertionError(f"the resumed run trained {epochs}, not one ode epoch 4")
    if "training.ode.train_until_epoch" not in resumed.get("resumed_config_differs", []):
        raise AssertionError("the resumed config check did not name training.ode.train_until_epoch")
    if k1 == 0 or k2 == 0:
        raise AssertionError(f"the resumed ode epoch launched K1 {k1} and K2 {k2} times")
    return {"k1": k1, "k2": k2}


def forecast_phase(cfg, coords: np.ndarray, frames, tag: str) -> dict:
    """``Forecaster.forecast`` of ``frames`` for NUM_FRAMES frames at full width with seeded
    random weights: K1's launches in the first call against the decode's chunks, the
    output's shape and finiteness, the median of warm calls and of each stage, and the
    decoded field against the plain decode of the same latents."""
    fc, init_s = sync_time(lambda: Forecaster(cfg, coords, device="cuda"))
    log(f"[{tag}] Forecaster built on {fc.device} (random weights, seed {SEED}) in {init_s:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    fused_decode_fwd.launches = 0
    with on_path():
        out, fc_s = sync_time(lambda: fc.forecast(frames, num_frames=NUM_FRAMES))
    launches = fused_decode_fwd.launches
    chunk = cfg.training.max_num_sampled_points
    expect_launches = -(-coords.shape[0] // chunk)  # one launch per chunk of the 160-frame decode
    expect = (len(frames), NUM_FRAMES, coords.shape[0], cfg.nef.num_out)
    log(f"[{tag}] forecast({len(frames)} frames, num_frames={NUM_FRAMES}) -> {tuple(out.shape)} in "
        f"{fc_s:.3f} s (first call); K1 launches {launches} (expected {expect_launches}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if tuple(out.shape) != expect:
        raise AssertionError(f"forecast shape {tuple(out.shape)} != {expect}")
    if not torch.isfinite(out).all():
        raise AssertionError("forecast has non-finite values")
    if launches != expect_launches:
        raise AssertionError(f"the forecast launched K1 {launches} times, not {expect_launches}")

    # Warm repeats: the whole call, then the path stage by stage; medians are reported
    # because the host-bound fit and rollout vary from call to call.
    totals = [sync_time(lambda: fc.forecast(frames, num_frames=NUM_FRAMES))[1] * 1e3
              for _ in range(WARM_REPEATS)]
    log(f"[{tag}] warm forecast x{WARM_REPEATS}: median {statistics.median(totals):.2f} ms "
        f"(samples {', '.join(f'{v:.2f}' for v in totals)} ms)")
    stages = {"fit": [], "rollout": [], "decode": []}
    for _ in range(WARM_REPEATS):
        fitted, fit_s = sync_time(lambda: fc.fit(frames))
        traj, roll_s = sync_time(lambda: fc.rollout(fitted, NUM_FRAMES))
        field, dec_s = sync_time(lambda: fc.decode(traj))
        for name, sec in (("fit", fit_s), ("rollout", roll_s), ("decode", dec_s)):
            stages[name].append(sec * 1e3)
    log(f"[{tag}] stages (warm, median of {WARM_REPEATS}): " + " | ".join(
        f"{n} {statistics.median(v):.2f} ms (samples {', '.join(f'{x:.2f}' for x in v)})"
        for n, v in stages.items()))
    dec = fc.trainer.decoder
    pb, tb = traj[0].shape[:2]
    flat = [t.reshape(pb * tb, *t.shape[2:]) for t in traj]
    xs = fc.trainer.coords[None].expand(pb * tb, -1, -1)
    with torch.no_grad():
        folded = dec.fold(*flat)
    plain = {dt: plain_decode(dec, fc.trainer.coords, flat, chunk, dt).reshape(field.shape)
             for dt in (BF16, torch.float32)}
    # The forecast decodes on the YAML's pallas: K1's bf16 program, held as phase 35 holds it.
    err = bf16_gates(f"{tag} forecast decode (bf16) vs plain decode", field, plain[BF16], plain[torch.float32],
                     absolute=True)["max_abs_err"]
    return dict(fc=fc, launches=launches, max_abs_err=err, dec=dec, flat=flat, xs=xs, folded=folded,
                chunk=chunk)


def k1_shapes_phase(tag: str, shapes: list, dev) -> dict:
    """K1 against its plain version, with and without the tail, at each ``(cfg, b, M)`` of
    ``shapes`` (the config's widths and latents, ``b`` frames of seeded random latents,
    ``M`` coordinates of its grid), or ``(cfg, b, M, coords, name)`` to decode all ``M`` of
    ``coords``; per shape ms per launch, the plain version's ms, the bounds, and the shared
    memory of ``k1_smem_bytes`` held equal to the built library's ``layout``, and its width
    class (``k1_width_class``, held equal to the library's) and blocks an SM
    (``k1_occupancy``). Returns the worst max abs error and each shape's numbers (its own
    worst error among them), keyed by ``(z, b, c)`` (and ``name``)."""
    errs, timing = [], {}
    for i, (c, b, M, *own) in enumerate(shapes):
        H, D = c.nef.num_heads, c.nef.num_hidden
        args = decode_inputs(c, own[0] if own else config_coords(c), dev, b, M, SEED + 11 + i)
        B, Zl, C, I = args[0].shape
        hid, hidm = args[6][1].shape[0], args[6][8].shape[0]
        label = f"K1 {tag} z={Zl} b={B} c={C} I={I} H={H} hid={hid}" + (f" ({own[1]})" if own else "")
        smem = k1_smem_bytes(Zl, I, hid, H, D, hidm)
        dims = [B, Zl, C, I, hid, H, D, hidm, c.nef.num_out, 1]
        lib_smem = k1_library_smem_bytes(dims)
        if lib_smem != smem:
            raise AssertionError(f"{label}: k1_smem_bytes {smem} != the library's layout {lib_smem}")
        wn, per_sm = k1_occupancy(dims)
        if wn != k1_width_class(hid, hidm, D) or per_sm < 1:
            raise AssertionError(f"{label}: the library's width class {wn} ({per_sm} blocks an SM) != "
                                 f"k1_width_class {k1_width_class(hid, hidm, D)}")
        with torch.no_grad():
            out_k = fused_decode_fwd(*args, num_heads=H, head_dim=D)
            no_tail = (*args[:7], ())
            shape_errs = [
                check_close(f"{label} tail", out_k, fused_decode_plain(*args, num_heads=H, head_dim=D)),
                check_close(f"{label} no-tail", fused_decode_fwd(*no_tail, num_heads=H, head_dim=D),
                            fused_decode_plain(*no_tail, num_heads=H, head_dim=D))]
            errs += shape_errs
            split = shared_weights(args[6])  # once per fold, as the decode splits
            k_ms = cuda_ms(lambda: fused_decode_fwd(*args, num_heads=H, head_dim=D, split=split), iters=20)
            p_ms = cuda_ms(lambda: fused_decode_plain(*args, num_heads=H, head_dim=D), iters=3, warmup=1)
        bd = k1_bounds(c, args, out_k)
        timing[(Zl, B, C, *own[1:])] = dict(ms=k_ms, plain_ms=p_ms, smem=smem, max_abs_err=max(shape_errs),
                                            width_class=wn, blocks_per_sm=per_sm, **bd)
        log(f"[timing] {label}: {k_ms:.4f} ms ({bd['flops'] / k_ms / 1e9:.2f} TFLOP/s); plain "
            f"{p_ms:.4f} ms; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} (3xTF32 tensor cores "
            f"{bd['tc_ms']:.4f} ms, f32 CUDA cores {bd['f32_ms']:.4f} ms, bytes {bd['bytes_ms']:.4f} ms: "
            f"{bd['flops'] / 1e9:.3f} GFLOP); shared memory {smem} B of 232448 (the library's layout agrees); "
            f"width class {wn}, {per_sm} blocks an SM")
        del args, out_k
    torch.cuda.synchronize()
    return {"max_abs_err": max(errs), "timing": timing}


def k1_config_phase(name: str, dev, ragged_latents=()) -> dict:
    """10 / 14. K1 at a config's widths: at the forecast's and validation's launch shape
    (160 frames x the config's chunk), at 160 x 512 and 80 x 512, and at each of
    ``ragged_latents`` latents at a ragged 8 x 1000; the kernels-line numbers of the first."""
    cfg = load_experiment_config(name)
    b_main, chunk = NUM_SIGNALS * NUM_FRAMES, cfg.training.max_num_sampled_points
    shapes = [(cfg, b_main, chunk), (cfg, b_main, 512), (cfg, b_main // 2, 512)]
    shapes += [(load_experiment_config(name, [f"nef.num_latents={z}"]), NUM_SIGNALS, 1000) for z in ragged_latents]
    res = k1_shapes_phase(name, shapes, dev)
    main = res["timing"][(cfg.nef.num_latents, b_main, chunk)]
    return {"max_abs_err": res["max_abs_err"], "shape": f"{name} b={b_main} z={cfg.nef.num_latents} c={chunk}",
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def k1_repair_phase(dev) -> dict:
    """13. K1 past four latents at Navier-Stokes width (I = 4, hid = hidm = D = 128, H = 2),
    which the earlier two-pass layout refused: z = 5, 8, 9 and 16 at a ragged 8 x 1000, and
    shallow_water's decode widths (latent_dim 32, z = 8) at its launch shape 160 x 2048,
    seeded random weights; against the plain version, with times, bounds, shared memory."""
    ns = lambda *over: load_experiment_config("navier_stokes", list(over))  # noqa: E731
    shapes = [(ns(f"nef.num_latents={z}"), NUM_SIGNALS, 1000) for z in (5, 8, 9, 16)]
    shapes.append((ns("nef.num_latents=8", "nef.latent_dim=32"), NUM_SIGNALS * NUM_FRAMES, 2048))
    res = k1_shapes_phase("navier_stokes width", shapes, dev)
    return {"max_abs_err": res["max_abs_err"], "shallow_water": res["timing"][(8, NUM_SIGNALS * NUM_FRAMES, 2048)]}


def planar_data_phase(name: str, n_train: int, n_test: int, dev) -> Path:
    """11/12 a. ``get_dataloader`` generates the planar dataset on the card into a fresh
    ``chiprun_out/<name>_data/`` (one aligned block per split); seconds per block, batch
    shapes, finiteness, and the physics checks: for diffusion_plane one whole trajectory
    against the CPU's; for cahn_hilliard the first 100 solver steps of one field against
    the CPU's, every frame's mean against its initial field's (mass), and |c| near 1."""
    path = fresh_dir(OUT_DIR / f"{name}_data")
    cfg = load_experiment_config(name, [f"dataset.path={path}", f"dataset.num_signals_train={n_train}",
                                        f"dataset.num_signals_test={n_test}"])
    train, test = get_dataloader(cfg.dataset, device="cuda")
    block_s = {}
    for split, ldr in (("train", train), ("test", test)):
        block_s[split] = sync_time(ldr.ensure_all)[1]
    files = {split: sorted((path / name / split).glob("traj_*.npz")) for split in ("train", "test")}
    log(f"[{name}] data on {torch.cuda.get_device_name(0)}: " + ", ".join(
        f"{split} {len(files[split])} trajectories in {block_s[split]:.2f} s" for split in files))
    for split, ldr in (("train", train), ("test", test)):
        batch = next(iter(ldr))[0]
        if batch.shape != (8, TRAIN_FRAMES, GRID, GRID, 1) or not np.isfinite(batch).all():
            raise AssertionError(f"{name} {split} batch shape {batch.shape} or non-finite values")
        log(f"[{name}] {split} batch {tuple(batch.shape)}: |u| max {np.abs(batch).max():.4f}, "
            f"mean {batch.mean():.4f}, std {batch.std():.4f}")
    first = np.load(files["train"][0])["data"]
    if name == "diffusion_plane":
        cpu = generate_diffusion_trajectories([0], device="cpu")[0]
        rel = rel_l2(torch.from_numpy(first), torch.from_numpy(cpu))
        log(f"[{name}] trajectory 0 (20 frames) card vs CPU rel_l2 {rel:.3e} (tol 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"diffusion trajectory card vs CPU rel_l2 {rel:.3e}")
        return path
    c0 = initial_fields([0], device="cpu")
    runs = [cahn_hilliard_rollout(c.clone(), 1e-2, 2, 100)[:, 1] for c in (c0, c0.to(dev))]
    rel = rel_l2(runs[1].cpu(), runs[0])
    ids = [int(f.stem.split("_")[1]) for f in files["train"]]
    trajs = np.stack([np.load(f)["data"] for f in files["train"]])[..., 0]
    drift = float(np.abs(trajs.mean(axis=(2, 3)) - initial_fields(ids, device="cpu").mean(dim=(1, 2)).numpy()[:, None]).max())
    bulk = float(np.median(np.abs(trajs[:, -1])))
    log(f"[{name}] field 0: 100 solver steps card vs CPU rel_l2 {rel:.3e} (tol {SOLVER_TOL:g}); "
        f"largest |frame mean - initial mean| over {len(ids)} trajectories x 20 frames {drift:.3e} "
        f"(tol 1e-5; 60,000 steps a trajectory); median |c| of the last frames {bulk:.4f}")
    if not (rel <= SOLVER_TOL and drift <= 1e-5 and bulk > CH_BULK_MIN):
        raise AssertionError(f"cahn_hilliard checks failed: {rel:.3e}, {drift:.3e}, {bulk:.4f}")
    return path


def config_train_phase(name: str, data: Path, overrides: list, phases: list, coords: np.ndarray,
                       eqv_kinds=("translation", "rotation"), eqv_exact: bool = True,
                       frames_per_traj: int = 1) -> dict:
    """12 / 16 / 19 / 22 / 25. ``run_experiment`` at the config's full width on the generated
    data, the phases overridden to ``phases``; finite metrics, exactly the equivariance
    errors ``eqv_kinds`` (SE(2): translation and rotation; S^2: longitude, and rotation for
    the SO(3) invariant; none for ``abs_pos``; the ball's rotation), at f32 rounding unless
    ``eqv_exact`` is off (the ball's window is not rotation-equivariant: its error need only
    be finite), the launches of K1 and K2 against the loop's
    arithmetic (the ode and dual steps launch each once where the YAML sets
    ``ode_backend: pallas``; validation launches K1 once a chunk; a ``shallow_water_low_res``
    run ends with the super-resolution eval, once a chunk of the 192 x 96 grid for each
    test batch), step medians. Returns the loop, its state, the launches, the medians and
    NUM_SIGNALS frames: the first ``frames_per_traj`` of each test, then training signal."""
    log_dir = fresh_dir(OUT_DIR / f"{name}_train")
    cfg = load_experiment_config(name, [f"dataset.path={data}", f"logging.log_dir={log_dir}",
                                        "test.test_equiv_at_epoch=0", "logging.log_every_n_steps=1",
                                        "logging.checkpoint_every_n_epochs=1", *overrides])
    fused_decode_fwd.launches = fused_decode_bwd.launches = 0
    with on_path():
        (loop, state), run_s = sync_time(lambda: run_experiment(cfg, device="cuda"))
    k1, k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "train_mse_epoch" in r]
    val = next(r for r in records if "val_mse_in_t" in r)
    eqv = next((r for r in records if any(k.startswith("equivariance_err_") for k in r)), {})
    values = [v for r in records for k, v in r.items() if "mse" in k]
    n_train, n_val = len(loop.train_loader), len(loop.val_loader)
    chunk = cfg.training.max_num_sampled_points
    kernel_steps = n_train * sum(r["phase"] != "nef" for r in epochs) if cfg.nef.get("ode_backend") == "pallas" else 0
    superres = cfg.dataset.name == "shallow_water_low_res"
    sr_k1 = n_val * -(-dataset_spec("shallow_water", device="cpu").coords.shape[0] // chunk) if superres else 0
    expect = (kernel_steps + (n_val + n_train) * (1 + 3) * -(-coords.shape[0] // chunk) + sr_k1, kernel_steps)
    sr = next((r for r in records if "superres_mse_in_t" in r), {})
    epoch_mse = ", ".join(f"{r['train_mse_epoch']:.4e}" for r in epochs)
    log(f"[{name}] run_experiment({cfg.training.num_epochs} epochs) in {run_s:.2f} s: phases "
        f"{[r['phase'] for r in epochs]}, train_mse_epoch [{epoch_mse}], "
        f"val_mse_in_t {val['val_mse_in_t']:.4e} out_t {val['val_mse_out_t']:.4e}; equivariance_err "
        + (" ".join(f"{k} {eqv.get(f'equivariance_err_{k}')}" for k in eqv_kinds) or "none claimed, none logged")
        + "; "
        + (f"superres_mse_in_t {sr.get('superres_mse_in_t')} out_t {sr.get('superres_mse_out_t')}; "
           if superres else "")
        + f"K1 launches {k1}, K2 launches {k2} (expected {expect}: {kernel_steps} ode/dual steps, "
        f"{(n_val + n_train) * 4} validation steps, {sr_k1} super-resolution chunks); checkpoints "
        f"{loop.checkpoints.all_epochs()}")
    if [r["phase"] for r in epochs] != phases:
        raise AssertionError(f"phases {[r['phase'] for r in epochs]} != {phases}")
    if not all(np.isfinite(v) for v in values):
        raise AssertionError(f"non-finite training or validation metrics: {values}")
    errs = [eqv.get(f"equivariance_err_{k}") for k in eqv_kinds]
    if not all(e is not None and np.isfinite(e) and (e <= 1e-4 or not eqv_exact) for e in errs):
        raise AssertionError(f"equivariance errors {errs} not logged, not finite or above 1e-4")
    if {k for k in eqv if k.startswith("equivariance_err_")} != {f"equivariance_err_{k}" for k in eqv_kinds}:
        raise AssertionError(f"equivariance errors {sorted(eqv)} are not exactly {eqv_kinds}")
    if superres and not all(np.isfinite(sr.get(k, np.nan)) for k in ("superres_mse_in_t", "superres_mse_out_t")):
        raise AssertionError(f"super-resolution metrics not logged or not finite: {sr}")
    if (k1, k2) != expect:
        raise AssertionError(f"K1/K2 launches {(k1, k2)} != expected {expect}")
    if superres:  # once more, timed: the same draws (keyed by batch index), so the same numbers
        sr_logger = MetricLogger(str(log_dir / "superres_repeat"))
        try:
            again, sr_s = sync_time(lambda: super_resolution_eval(cfg, state, loop.trainer.decoder,
                                                                  loop.trainer.ode_model, sr_logger,
                                                                  device="cuda"))
        finally:
            sr_logger.close()
        log(f"[{name}] super-resolution eval again: {sr_s * 1e3:.2f} ms for {n_val} test batches "
            f"({sr_k1} K1 launches); {again} (logged {sr['superres_mse_in_t']}, {sr['superres_mse_out_t']})")
        logged = (sr["superres_mse_in_t"], sr["superres_mse_out_t"])
        if not all(abs(x - y) <= REL_L2_TOL * abs(y) for x, y in zip(again, logged)):
            raise AssertionError(f"the super-resolution eval is not a function of the state: {again} vs {logged}")
    medians = step_medians(loop.trainer, state, next(iter(loop.train_loader))[0], name)
    frames = torch.cat([torch.as_tensor(batch[0])[:, :frames_per_traj].flatten(0, 1)
                        for ldr in (loop.val_loader, loop.train_loader) for batch in ldr])[:NUM_SIGNALS]
    return {"loop": loop, "state": state, "k1": k1, "k2": k2, "medians": medians, "frames": frames}


def planar_phase(name: str, dev, n_train: int, n_test: int, overrides: list, phases: list) -> dict:
    """10-12 for one planar config: K1 at its widths, its data on the card, training, and
    the forecast; the K1 entry of the kernels line for this config."""
    k1 = k1_config_phase(name, dev, ragged_latents=(5, 1) if name == "diffusion_plane" else ())
    coords = planar_coords(GRID, GRID)
    data = planar_data_phase(name, n_train, n_test, dev)
    train = config_train_phase(name, data, overrides, phases, coords)
    cfg = load_experiment_config(name)
    fc = forecast_phase(cfg, coords, train["frames"], name)
    shutil.rmtree(data)  # the generated data is not kept: the output directory stays small
    torch.cuda.empty_cache()
    return {**k1, "launches": train["k1"] + fc["launches"],
            "max_abs_err": max(k1["max_abs_err"], fc["max_abs_err"])}


def sphere_data_phase(dev) -> Path:
    """15. ``get_dataloader`` generates ``diff_sphere`` on the card into a fresh
    ``chiprun_out/diff_sphere_data/``, one block of 16 trajectories per split (the heat
    equation on the 128 x 64 sphere grid, exact in the harmonic basis); seconds per block,
    trajectory 0 against the CPU's generation within rel-L2 1e-5, and the area-weighted
    mean of every frame of the training block against its initial frame's within 1e-5."""
    name = "diff_sphere"
    path = fresh_dir(OUT_DIR / f"{name}_data")
    cfg = load_experiment_config(name, [f"dataset.path={path}", f"dataset.num_signals_train={TRAIN_SIGNALS}",
                                        f"dataset.num_signals_test={VAL_SIGNALS}"])
    train, test = get_dataloader(cfg.dataset, device="cuda")
    block_s = {split: sync_time(ldr.ensure_all)[1] for split, ldr in (("train", train), ("test", test))}
    files = {split: sorted((path / name / split).glob("traj_*.npz")) for split in ("train", "test")}
    log(f"[{name}] data on {torch.cuda.get_device_name(0)}: " + ", ".join(
        f"{split} {len(files[split])} trajectories in {block_s[split]:.2f} s" for split in files))
    trajs = np.stack([np.load(f)["data"] for f in files["train"]])[..., 0]
    if [len(f) for f in files.values()] != [16, 16] or trajs.shape != (16, TRAIN_FRAMES, 128, 64) \
            or not np.isfinite(trajs).all():
        raise AssertionError(f"{name}: {[len(f) for f in files.values()]} files, shape {trajs.shape} or non-finite")
    cpu = generate_sphere_diffusion_trajectories([0], device="cpu")[0, ..., 0]
    rel = rel_l2(torch.from_numpy(trajs[0]), torch.from_numpy(cpu))
    means = (trajs * SphereGrid(128, 64, device="cpu").w).sum(axis=-1).mean(axis=-1) / 2  # area means
    drift = float(np.abs(means - means[:, :1]).max())
    log(f"[{name}] trajectory 0 (20 frames) card vs CPU rel_l2 {rel:.3e} (tol 1e-5); largest |frame mean - "
        f"initial mean| over 16 trajectories x 20 frames {drift:.3e} (tol 1e-5; initial means "
        f"{means[:, 0].min():.4f}-{means[:, 0].max():.4f}); |u| max {np.abs(trajs).max():.4f}")
    if not (rel <= 1e-5 and drift <= 1e-5):
        raise AssertionError(f"diff_sphere data checks failed: {rel:.3e}, {drift:.3e}")
    return path


def sphere_phase(dev) -> dict:
    """14-16 for ``diff_sphere``: K1 at its widths, its data on the card, training with the
    sphere equivariance check, and the forecast; the K1 entry of the kernels line."""
    name = "diff_sphere"
    k1 = k1_config_phase(name, dev, ragged_latents=(2, 8))
    cfg = load_experiment_config(name)
    coords = config_coords(cfg)
    data = sphere_data_phase(dev)
    train = config_train_phase(name, data, [
        f"dataset.num_signals_train={TRAIN_SIGNALS}", f"dataset.num_signals_test={VAL_SIGNALS}",
        "training.num_epochs=3", "training.nef.train_until_epoch=2", "training.ode.train_from_epoch=1",
        "training.ode.train_until_epoch=3", "test.test_interval=3", "test.test_dp_interval=3"],
        ["nef", "nef+ode", "ode"], coords, eqv_kinds=("longitude", "rotation"))
    fc = forecast_phase(cfg, coords, train["frames"], name)
    shutil.rmtree(data)  # the generated data is not kept: the output directory stays small
    torch.cuda.empty_cache()
    return {**k1, "launches": train["k1"] + fc["launches"],
            "max_abs_err": max(k1["max_abs_err"], fc["max_abs_err"])}


def sw_kernel_phase(dev) -> dict:
    """17. K1 and K2 at ``shallow_water``'s widths (I = 4, hid = hidm = D = 128, H = 2, z = 8,
    num_out = 3; seeded random weights) against their plain versions: K1 with and without
    the tail at the forecast's launch (160 x 2048), validation's (14 x 2048), a last chunk's
    512 points and a ragged 8 x 1000; K2 at the ode step's decode (10 x 2048) in all four
    modes; then one ode and one dual step with the rollout decode on K1 + K2 against the
    eager decoder. Returns the kernels-line numbers."""
    cfg = shape_config("shallow_water")
    chunk, coords = cfg.training.max_num_sampled_points, config_coords(cfg)
    b_fc = NUM_SIGNALS * NUM_FRAMES
    b_val = cfg.dataset.batch_size * (cfg.dataset.traj_len_train + cfg.dataset.traj_len_out_horizon)
    k1 = k1_shapes_phase("shallow_water", [(cfg, b_fc, chunk), (cfg, b_val, chunk), (cfg, b_val, 512),
                                           (cfg, NUM_SIGNALS, 1000)], dev)
    k2 = k2_phase(cfg, coords, dev)
    traj = sphere_trajectories(cfg.dataset.batch_size, b_val, 96, 48, NUM_OUT["shallow_water"], SEED + 3)
    step_err = step_parity_phase(cfg, coords, traj, dev)
    main = k1["timing"][(cfg.nef.num_latents, b_fc, chunk)]
    return {"k1": {"shape": f"shallow_water b={b_fc} z={cfg.nef.num_latents} c={chunk}",
                   **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
            "k1_err": max(k1["max_abs_err"], step_err), "k2": k2}


def sw_data_phase(dev) -> Path:
    """18. ``get_dataloader`` for ``shallow_water_low_res`` generates one block of 4 Galewsky
    jets per split on the card (192 x 96, lmax 64, 20 records x 150 steps of 400 s) into a
    fresh ``chiprun_out/shallow_water_data/`` (removed after phase 19): seconds per block,
    solver steps per second, the batch shape, finiteness and the JAX package's physical
    bounds (|u_phi| < 3 u_max, |h| < 1e4 m), the area-weighted mean of h in every recorded
    frame against the first's (within 1e-6 of max |h|); and one seed's initial state and
    first record (150 steps) built on the CPU and on the card, held within rel-L2 1e-4."""
    path = fresh_dir(OUT_DIR / "shallow_water_data")
    cfg = load_experiment_config("shallow_water", [f"dataset.path={path}", f"dataset.num_signals_train={SW_SIGNALS}",
                                                   f"dataset.num_signals_test={SW_SIGNALS}"])
    train, test = get_dataloader(cfg.dataset, device="cuda")
    block_s = {split: sync_time(ldr.ensure_all)[1] for split, ldr in (("train", train), ("test", test))}
    files = [f for split in ("train", "test") for f in sorted((path / "shallow_water" / split).glob("traj_*.npz"))]
    steps = SW_FRAMES * STEPS_PER_RECORD
    log(f"[shallow_water] data on {torch.cuda.get_device_name(0)}: " + ", ".join(
        f"{split} one block of {SW_SIGNALS} in {sec:.2f} s ({steps / sec:.1f} solver steps/s of the block)"
        for split, sec in block_s.items()) + f"; {steps} steps a block")
    raw = np.stack([np.load(f)["data"] for f in files])  # [8, 20, 192, 96, 3], the shared full-res cache
    batch = next(iter(train))[0]
    if raw.shape != (2 * SW_SIGNALS, SW_FRAMES, 192, 96, 3) or batch.shape != (1, 14, 96, 48, 3) \
            or not (np.isfinite(raw).all() and np.isfinite(batch).all()):
        raise AssertionError(f"shallow_water data shape {raw.shape}, batch {batch.shape} or non-finite values")
    units, h_max = SWUnits(), float(np.abs(raw[..., 0]).max())
    u_max = float(np.abs(raw[..., 1]).max())
    mass = (raw[..., 0] * sw_grid(device="cpu").w).sum(axis=-1).mean(axis=-1)  # area means of h, [8, 20]
    drift = float(np.abs(mass - mass[:, :1]).max())
    log(f"[shallow_water] batch {tuple(batch.shape)}; over {len(files)} trajectories: max |u_phi| {u_max:.4e} "
        f"(3 u_max = {3 * units.umax:.4e}), max |h| {h_max:.4e} (1e4 m = {1e4 * units.meter:.4e}), max "
        f"|u_theta| {float(np.abs(raw[..., 2]).max()):.4e}; largest |area mean of h - first frame's| "
        f"{drift:.3e} (tol 1e-6 max |h| = {1e-6 * h_max:.3e})")
    if not (u_max < 3 * units.umax and h_max < 1e4 * units.meter and drift <= 1e-6 * h_max):
        raise AssertionError(f"shallow_water physics checks failed: {u_max:.4e}, {h_max:.4e}, {drift:.3e}")

    # One seed on the CPU and on the card: the state, then its first record. u_theta is about
    # 1/150 of u_phi; its error is also given against the velocity field's norm.
    runs = {}
    for name in ("cpu", "cuda"):
        grid = sw_grid(device=name)
        state = galewsky_state(grid, SEED)
        record = ShallowWaterSolver(grid).rollout(state, units.timestep / 3, 1, STEPS_PER_RECORD)
        runs[name] = ([x.cpu() for x in state], [x[0].cpu() for x in record])
    (s_cpu, r_cpu), (s_gpu, r_gpu) = runs["cpu"], runs["cuda"]
    state_rel = [rel_l2(s_gpu[i], s_cpu[i]) for i in (0, 2)]  # zeta, h (delta is 0)
    rec_rel = [rel_l2(g, c) for g, c in zip(r_gpu, r_cpu)]
    vel = torch.stack(r_cpu[1:])
    ut_vs_vel = float(torch.linalg.vector_norm(r_gpu[2] - r_cpu[2]) / torch.linalg.vector_norm(vel))
    block_rel = [rel_l2(torch.from_numpy(raw[0, 0, ..., c]), r_cpu[c]) for c in range(3)]
    log(f"[shallow_water] seed {SEED}: state card vs CPU rel_l2 zeta {state_rel[0]:.3e} h {state_rel[1]:.3e}; "
        f"first record ({STEPS_PER_RECORD} steps) card vs CPU rel_l2 h {rec_rel[0]:.3e} u_phi {rec_rel[1]:.3e} "
        f"u_theta {rec_rel[2]:.3e} (against |(u_phi, u_theta)| {ut_vs_vel:.3e}); the generated block's frame 0 "
        f"vs the CPU: h {block_rel[0]:.3e} u_phi {block_rel[1]:.3e} u_theta {block_rel[2]:.3e} (tol {SOLVER_TOL:g} "
        f"each; u_theta against the velocity's norm)")
    if not max(*state_rel, rec_rel[0], rec_rel[1], ut_vs_vel, block_rel[0], block_rel[1]) <= SOLVER_TOL:
        raise AssertionError(f"card and CPU shallow-water solvers disagree: {state_rel}, {rec_rel}, {block_rel}")
    return path


def sw_phase(dev) -> dict:
    """17-19 for ``shallow_water``: K1 and K2 at its widths and the kernel-backend steps,
    its data on the card, training through ``run_experiment`` with the longitude
    equivariance check and the super-resolution eval, and the forecast; the kernels-line
    entries of K1 and K2 at its shapes."""
    name = "shallow_water"
    kernels = sw_kernel_phase(dev)
    torch.cuda.empty_cache()
    data = sw_data_phase(dev)
    cfg = shape_config(name)
    coords = config_coords(cfg)
    train = config_train_phase(name, data, [
        f"dataset.num_signals_train={SW_SIGNALS}", f"dataset.num_signals_test={SW_SIGNALS}",
        "training.num_epochs=3", "training.nef.train_until_epoch=2", "training.ode.train_from_epoch=1",
        "training.ode.train_until_epoch=3", "test.test_interval=3", "test.test_dp_interval=3"],
        ["nef", "nef+ode", "ode"], coords, eqv_kinds=("longitude",))
    fc = forecast_phase(cfg, coords, train["frames"], name)
    keep_test_split(name, data, SW_SIGNALS, raw=True)
    shutil.rmtree(data)  # the generated data is not kept: the output directory stays small
    torch.cuda.empty_cache()
    k2 = kernels["k2"]
    for wg, step in ((False, "ode"), (True, "dual")):
        k_ms, step_ms = k2["timing"][wg]["ms"], train["medians"][step]
        log(f"[timing] {name}: K2 {'with' if wg else 'without'} weight grads {k_ms:.4f} ms is "
            f"{100 * k_ms / step_ms:.1f} % of the {step} step's median {step_ms:.2f} ms")
    return {"k1": {**kernels["k1"], "launches": train["k1"] + fc["launches"],
                   "max_abs_err": max(kernels["k1_err"], fc["max_abs_err"])},
            "k2": {"launches": train["k2"], "max_abs_err": k2["max_abs_err"], "timing": k2["timing"]}}


def nonmaml_overrides(log_dir: Path) -> list:
    """Phase 21's overrides of ``navier_stokes_nonmaml``: phase 7's data, epochs nef, nef,
    ode, and one validation at epoch 3 (the final one: both splits re-fitted for 2 epochs
    at every dropout share)."""
    return [f"dataset.path={DATA_DIR}", f"dataset.num_signals_train={TRAIN_SIGNALS}",
            f"dataset.num_signals_test={VAL_SIGNALS}", f"logging.log_dir={log_dir}",
            "training.num_epochs=3", "training.nef.train_until_epoch=2", "training.ode.train_from_epoch=2",
            "training.ode.train_until_epoch=3", "test.test_interval=3", "test.refit_epochs=2",
            "logging.log_every_n_steps=1"]


def ablation_kernel_phase(dev) -> dict:
    """20. K1 and K2 at the shapes the baselines add, against their plain versions, with
    times, bounds and shared memory: K1 at ``navier_stokes_nonmaml``'s validation decode
    (NS width, 160 x 2048) and a ragged 8 x 1000; K1 at I = 2 (``abs_pos``, ``rel_pos``) and
    at I = 1 (``norm_rel_pos``) at NS width, 160 x 512; K2 at I = 2 (``abs_pos``) and at I = 1
    (``norm_rel_pos``) at the ode step's 80 x 512, all four modes, timed with and without
    weight gradients."""
    t0 = time.perf_counter()
    b_val = NUM_SIGNALS * NUM_FRAMES  # 8 signals x 20 frames
    nonmaml = load_experiment_config("navier_stokes_nonmaml")
    chunk = nonmaml.training.max_num_sampled_points
    res = {"nonmaml": k1_shapes_phase("navier_stokes_nonmaml", [(nonmaml, b_val, chunk),
                                                                (nonmaml, NUM_SIGNALS, 1000)], dev)}
    for inv, k2_key in (("abs_pos", "k2"), ("norm_rel_pos", "k2_i1")):
        cfg = load_experiment_config("navier_stokes", [f"nef.invariant_type={inv}"])
        res[inv] = k1_shapes_phase(f"navier_stokes {inv}", [(cfg, b_val, 512)], dev)
        log(f"[phase 20] K2 at navier_stokes {inv}'s ode step")
        res[k2_key] = k2_phase(cfg, planar_coords(GRID, GRID), dev)
    torch.cuda.empty_cache()
    log(f"[phase 20] K1 and K2 at the baselines' shapes in {time.perf_counter() - t0:.2f} s")
    return res


def nonmaml_phase(dev) -> dict:
    """21. ``navier_stokes_nonmaml`` (autodecoding) at its full published width through
    ``run_experiment`` on phase 7's data: its metric keys exactly the JAX loop's (beside
    the port's data-path record), every value finite, K1's launches against the arithmetic (validation only: the training steps
    decode eagerly), the peak memory; then a codes-only step that leaves the decoder bit for
    bit, and each step kind's warm median."""
    t0 = time.perf_counter()
    log_dir = fresh_dir(OUT_DIR / "navier_stokes_nonmaml_train")
    cfg = load_experiment_config("navier_stokes_nonmaml", nonmaml_overrides(log_dir))
    torch.cuda.reset_peak_memory_stats()
    fused_decode_fwd.launches = fused_decode_bwd.launches = 0
    with on_path():
        (loop, state), run_s = sync_time(lambda: run_experiment(cfg, device="cuda"))
    k1, k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer = loop.trainer
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    # The port's run record names the data path first; the JAX loop logs no such record.
    keys = set().union(*records) - {"t", "step", "train_data_path", "val_data_path"}
    tags = ("", "_dp0.05", "_dp0.1", "_dp0.5")
    want = {"train_backend", "eval_backend", "mse_step", "epoch", "train_mse_epoch",
            "train_mse_in_t_sc", "train_mse_out_t_sc"}
    want |= {f"{s}_mse_{io}_t{tag}" for s in ("val", "train") for io in ("in", "out") for tag in tags}
    epochs = [r for r in records if "train_mse_epoch" in r]
    val = next(r for r in records if "val_mse_in_t" in r)
    values = [v for r in records for k, v in r.items() if "mse" in k]
    n_train, n_val = TRAIN_SIGNALS // cfg.dataset.batch_size, VAL_SIGNALS // cfg.dataset.batch_size
    chunks = -(-trainer.coords.shape[0] // cfg.training.max_num_sampled_points)
    # Stored-code rollout of the train split, then at each of 4 dropout shares the test
    # and train splits re-fitted (eager codes-only steps) and rolled out.
    expect = chunks * (n_train + 4 * (n_val + n_train))
    epoch_mse = ", ".join(f"{r['train_mse_epoch']:.4e}" for r in epochs)
    log(f"[navier_stokes_nonmaml] run_experiment(3 epochs) in {run_s:.2f} s: train_mse_epoch "
        f"[{epoch_mse}], final validation "
        + ", ".join(f"{k} {val[k]:.4e}" for k in sorted(val) if "mse" in k)
        + f"; K1 launches {k1} (expected {expect}: {chunks} chunks x ({n_train} + 4 x ({n_val} + {n_train})) "
        f"validation batches), K2 {k2}; peak memory {peak:.2f} GiB")
    if keys != want:
        raise AssertionError(f"metric keys differ from the JAX loop's: extra {sorted(keys - want)}, "
                             f"missing {sorted(want - keys)}")
    if [r["epoch"] for r in epochs] != [1, 2, 3] or not all(np.isfinite(v) for v in values):
        raise AssertionError(f"epochs {[r['epoch'] for r in epochs]} or non-finite metrics {values}")
    if (k1, k2) != (expect, 0):
        raise AssertionError(f"K1/K2 launches {(k1, k2)} != expected {(expect, 0)}")

    train, _ = get_dataloader(cfg.dataset, device="cuda")
    traj, _, idx = next(iter(train))
    traj = torch.as_tensor(traj, device=dev)
    before = {k: v.clone() for k, v in trainer.decoder.state_dict().items()}
    table = {k: v.clone() for k, v in state["autodecoder"].items()}
    trainer.codes_only_step(state, traj, idx)
    torch.cuda.synchronize()
    same = all(torch.equal(v, trainer.decoder.state_dict()[k]) for k, v in before.items())
    moved = float(max((state["autodecoder"][k] - v).abs().max() for k, v in table.items()))
    log(f"[navier_stokes_nonmaml] codes-only step: decoder bit for bit {same} ({len(before)} tensors), "
        f"table moved by up to {moved:.3e}")
    if not same or not moved > 0:
        raise AssertionError(f"the codes-only step moved the decoder ({not same}) or not the table ({moved})")
    torch.cuda.reset_peak_memory_stats()
    medians = {}
    for name, fn in (("nef", trainer.nef_train_step), ("codes-only", trainer.codes_only_step),
                     ("ode", trainer.ode_train_step), ("val", trainer.val_step)):
        samples = [sync_time(lambda: fn(state, traj, idx))[1] * 1e3 for _ in range(WARM_REPEATS)]
        medians[name] = statistics.median(samples)
        log(f"[navier_stokes_nonmaml] {name} step on generated data {tuple(traj.shape)} (warm, median of "
            f"{WARM_REPEATS}): {medians[name]:.2f} ms (samples {', '.join(f'{v:.2f}' for v in samples)})")
    log(f"[navier_stokes_nonmaml] peak memory of the timed steps {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del loop, trainer, state, traj
    torch.cuda.empty_cache()
    log(f"[phase 21] navier_stokes_nonmaml in {time.perf_counter() - t0:.2f} s")
    return {"k1": k1, "medians": medians}


def abs_pos_phase(dev) -> dict:
    """22. ``navier_stokes nef.invariant_type=abs_pos`` (the non-equivariant ablation) at full
    width through ``run_experiment`` on phase 7's data: 3 epochs (nef, dual, ode), no
    equivariance key, K1's and K2's launches against the loop's arithmetic; the
    kernel-backend ode and dual steps against the eager ones at I = 2; one ode step with
    ``node.name=mlp``: a finite loss and a moved ODE, K1 and K2 launched once each."""
    t0 = time.perf_counter()
    coords = planar_coords(GRID, GRID)
    train = config_train_phase("navier_stokes", DATA_DIR, [
        "nef.invariant_type=abs_pos", f"dataset.num_signals_train={TRAIN_SIGNALS}",
        f"dataset.num_signals_test={VAL_SIGNALS}", "training.num_epochs=3", "training.nef.train_until_epoch=2",
        "training.ode.train_from_epoch=1", "training.ode.train_until_epoch=3", "test.test_interval=3",
        "test.test_dp_interval=3"], ["nef", "nef+ode", "ode"], coords, eqv_kinds=())
    shutil.rmtree(OUT_DIR / "navier_stokes_train" / "checkpoints")  # phase 8 checks them; keep the output small
    torch.cuda.empty_cache()
    cfg = load_experiment_config("navier_stokes", ["nef.invariant_type=abs_pos"])
    step_err = step_parity_phase(cfg, coords, smooth_trajectories(NUM_SIGNALS, TRAIN_FRAMES, GRID, SEED + 3), dev,
                                 zero_by_structure=("cross_attention_block.attn.a_to_k.bias",))

    mlp_cfg = load_experiment_config("navier_stokes", ["nef.invariant_type=abs_pos", "node.name=mlp"])
    trainer = make_trainer(mlp_cfg, coords)
    state = trainer.init_state()
    traj = torch.from_numpy(smooth_trajectories(NUM_SIGNALS, TRAIN_FRAMES, GRID, SEED + 4)).to(dev)
    before = {k: v.clone() for k, v in trainer.ode_model.state_dict().items()}
    fused_decode_fwd.launches = fused_decode_bwd.launches = 0
    with on_path():
        (loss, state), step_s = sync_time(lambda: trainer.ode_train_step(state, traj))
    k1, k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
    moved = float(max((trainer.ode_model.state_dict()[k] - v).abs().max() for k, v in before.items()))
    log(f"[navier_stokes abs_pos] one full-width ode step with node.name=mlp ({type(trainer.ode_model).__name__}, "
        f"{sum(v.numel() for v in before.values())} parameters) in {step_s * 1e3:.2f} ms (first call): loss "
        f"{float(loss):.4e}, parameters moved by up to {moved:.3e}; K1 launches {k1}, K2 launches {k2}")
    if not (np.isfinite(float(loss)) and moved > 0 and (k1, k2) == (1, 1)):
        raise AssertionError(f"the mlp ode step: loss {float(loss)}, moved {moved}, launches {(k1, k2)}")
    del trainer, state, traj
    torch.cuda.empty_cache()
    log(f"[phase 22] navier_stokes abs_pos in {time.perf_counter() - t0:.2f} s")
    # The kernels line counts the abs_pos run's launches alone: the mlp step's are logged above.
    return {"k1": train["k1"], "k2": train["k2"], "step_err": step_err}


def ihc_kernel_phase(dev) -> dict:
    """23. K1 at ``ihc``'s widths (I = 5, hid = hidm = D = 32, H = 3: the mixer's odd head;
    the width class 32: z = 25 in seven latent groups, four of 4 and three of 3; num_out = 1;
    seeded random weights) against its plain version, with and without the tail, at the
    forecast's launch (160 x 2048), validation's (14 x 2048), validation's padded last chunk
    (the grid's last 1,024 points and 1,024 padded ones), a ragged 8 x 1000, and at 8 x 1000
    with z = 1 and with one latent past the class's largest group (z = ZG32 + 1 = 5: groups
    of 2 and 3);
    times, bounds, shared memory, width class and blocks an SM."""
    cfg = load_experiment_config("ihc")
    chunk, coords = cfg.training.max_num_sampled_points, config_coords(cfg)
    b_fc = NUM_SIGNALS * NUM_FRAMES
    b_val = cfg.dataset.batch_size * (cfg.dataset.traj_len_train + cfg.dataset.traj_len_out_horizon)
    last = coords.shape[0] % chunk
    padded = np.concatenate([coords[-last:], np.zeros((chunk - last, 3), np.float32)])
    # One latent, and one past the class's largest group: groups spread evenly (5 = 2 + 3).
    ragged = [load_experiment_config("ihc", [f"nef.num_latents={z}"]) for z in (1, k1_constants()["ZG32"] + 1)]
    res = k1_shapes_phase("ihc", [(cfg, b_fc, chunk), (cfg, b_val, chunk),
                                  (cfg, b_val, chunk, padded, "padded last chunk"), (cfg, NUM_SIGNALS, 1000),
                                  *((r, NUM_SIGNALS, 1000) for r in ragged)], dev)
    main = res["timing"][(cfg.nef.num_latents, b_fc, chunk)]
    return {"shape": f"ihc b={b_fc} z={cfg.nef.num_latents} c={chunk}", "max_abs_err": res["max_abs_err"],
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def ball_states_phase() -> None:
    """24 a / b. The ball solver on the card: (a) seed 0 at full size (lmax 23, nmax 24),
    its temperature, poloidal and toroidal coefficients after BALL_STEPS steps against the
    port's CPU solver (float64, rel-L2 BALL_TOL each); (b) the conduction limit (buoyancy 0,
    lmax 5, nmax 12): BallModes' seeded modal field on the conductive profile; the frames at
    t = 5, 10, 15 equal BallModes' closed-form frames, the perturbation to rel-L2 2e-3."""
    t0 = time.perf_counter()

    class Stop(Exception):
        """Ends a run after BALL_STEPS steps, from ``on_step``."""

    runs = {}
    for name in ("cuda", "cpu"):
        solver = BallConvectionSolver(device=name)
        got = {}

        def on_step(step, t, dt, _, *state, got=got):
            if step == BALL_STEPS:
                got.update(state=[x.cpu() for x in state], t=t[0], dt=dt[0])
                raise Stop

        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            solver.simulate([SEED], on_step=on_step)
        except Stop:
            pass
        runs[name] = (got, time.perf_counter() - start)
    (gpu, gpu_s), (cpu, cpu_s) = runs["cuda"], runs["cpu"]
    rels = [rel_l2(g, c) for g, c in zip(gpu["state"], cpu["state"])]
    log(f"[ihc] seed {SEED} at lmax 23 / nmax 24: state after {BALL_STEPS} steps (t {gpu['t']:.4f}, dt "
        f"{gpu['dt']:.3e}) card vs CPU rel_l2 T {rels[0]:.3e} W {rels[1]:.3e} Z {rels[2]:.3e} (tol {BALL_TOL:g}); "
        f"the {BALL_STEPS} steps took {gpu_s:.2f} s on the card (set-up included), {cpu_s:.2f} s on the host CPU")
    if not (max(rels) <= BALL_TOL and math.isclose(gpu["t"], cpu["t"], rel_tol=1e-9)
            and math.isclose(gpu["dt"], cpu["dt"], rel_tol=1e-9)):
        raise AssertionError(f"card and CPU ball solvers disagree: {rels}, {gpu['t']} {cpu['t']}")

    s = BallConvectionSolver(lmax=5, nmax=12, buoyancy=0.0, device="cuda")
    modes = BallModes(nphi=16, ntheta=8, nr=8, lmax=4, nmax=3)
    coeffs, times = modes.sample_ic_coeffs(SEED), 5.0 * np.arange(1, 4)
    out = BallOutputGrid(s, nphi=16, ntheta=8, nr=8)
    frames, sec = sync_time(lambda: s.simulate([0], stop_time=20.0, record_interval=5.0, t_start_record=5.0,
                                               num_frames=3, out_grid=out, ic=modes.conduction_state(s, coeffs)))
    frames, want, base = frames[0].cpu().numpy(), modes.frames(coeffs, times), 1.0 - out.r**2
    errs = [float(np.linalg.norm(f - w) / np.linalg.norm(w - base)) for f, w in zip(frames, want)]
    log(f"[ihc] conduction limit on the card (lmax 5, nmax 12, {s.last_run[0][0]} steps in {sec:.2f} s): BallModes' "
        f"seeded field (l <= 4, 3 radial modes) at t = 5 / 10 / 15, its perturbation's norm "
        + " / ".join(f"{np.linalg.norm(w - base):.6f}" for w in want) + "; the solver's frames against BallModes' "
        f"rel_l2 " + ", ".join(f"{e:.3e}" for e in errs) + " (tol 2e-3)")
    if not max(errs) <= 2e-3:
        raise AssertionError(f"conduction frames off by {errs}")
    log(f"[phase 24 a, b] {time.perf_counter() - t0:.2f} s")


def ihc_data_phase(dev) -> Path:
    """24 c. ``get_dataloader`` for ``ihc`` generates IHC_SIGNALS + IHC_SIGNALS trajectories
    at the full protocol (Rayleigh 1e6, lmax 23, nmax 24, CFL-adaptive SBDF2, 20 frames from
    t = 2 to 5.8) on the card, one batched block of 2 per split, into a fresh
    ``chiprun_out/ihc_data/`` (removed after phase 25): seconds a block, steps per
    trajectory, steps per second, the dt range; a batch of shape [1, 14, 48, 24, 24, 1],
    finite, within the JAX package's physical range (-1, 2); and convection: the
    perturbation energy off 1 - r^2 grows from the first recorded frame to the last."""
    path = fresh_dir(OUT_DIR / "ihc_data")
    cfg = load_experiment_config("ihc", [f"dataset.path={path}", f"dataset.num_signals_train={IHC_SIGNALS}",
                                         f"dataset.num_signals_test={IHC_SIGNALS}"])
    train, test = get_dataloader(cfg.dataset, device="cuda")
    block_s, blocks = {}, []
    for split, ldr in (("train", train), ("test", test)):
        block_s[split] = sync_time(ldr.ensure_all)[1]
        run = full_size_solver("cuda").last_run  # the spec's solver: each trajectory's steps, dt range
        blocks.append(([steps for steps, _, _ in run], min(lo for _, lo, _ in run), max(hi for _, _, hi in run)))
    for (split, sec), (steps, lo, hi) in zip(block_s.items(), blocks):
        log(f"[ihc] data on {torch.cuda.get_device_name(0)}: {split} block of {len(steps)} in {sec:.2f} s, steps "
            f"per trajectory {steps} ({max(steps) / sec:.1f} steps/s of the block; the slower trajectory sets "
            f"it), dt {lo:.3e} - {hi:.3e}")
    files = [f for split in ("train", "test") for f in sorted((path / "ihc_convection" / split).glob("traj_*.npz"))]
    raw = np.stack([np.load(f)["data"] for f in files])  # [4, 20, 48, 24, 24, 1]
    batch = next(iter(train))[0]
    if raw.shape != (2 * IHC_SIGNALS, 20, 48, 24, 24, 1) or batch.shape != (1, 14, 48, 24, 24, 1) \
            or not (np.isfinite(raw).all() and np.isfinite(batch).all()):
        raise AssertionError(f"ihc data shape {raw.shape}, batch {batch.shape} or non-finite values")
    r = np.linspace(0, 1, 24)
    energy = ((raw[..., 0] - (1 - r**2)) ** 2).mean(axis=(2, 3, 4))  # [4, 20]
    log(f"[ihc] batch {tuple(batch.shape)}; over {len(files)} trajectories T in [{raw.min():.4f}, {raw.max():.4f}]; "
        f"perturbation energy off 1 - r^2 at t = 2.0 / 5.8: " + ", ".join(
            f"{a:.3e} / {b:.3e}" for a, b in energy[:, [0, -1]]))
    if not (raw.min() > -1.0 and raw.max() < 2.0 and (energy[:, -1] > energy[:, 0]).all()):
        raise AssertionError(f"ihc physics checks failed: range {raw.min()}, {raw.max()}, energy {energy[:, [0, -1]]}")
    return path


def ihc_phase(dev) -> dict:
    """23-25 for ``ihc``: K1 at its widths, the ball solver on the card and its data, then
    training through ``run_experiment`` with the ball's equivariance check (windowed: finite;
    the trained decoder without its window: at f32 rounding), and the forecast; the K1
    entry of the kernels line."""
    t0 = time.perf_counter()
    name = "ihc"
    k1 = ihc_kernel_phase(dev)
    torch.cuda.empty_cache()
    ball_states_phase()
    data = ihc_data_phase(dev)
    log(f"[phase 23, 24] {time.perf_counter() - t0:.2f} s")
    cfg = load_experiment_config(name)
    coords = config_coords(cfg)
    train = config_train_phase(name, data, [
        f"dataset.num_signals_train={IHC_SIGNALS}", f"dataset.num_signals_test={IHC_SIGNALS}",
        "training.num_epochs=3", "training.nef.train_until_epoch=2", "training.ode.train_from_epoch=1",
        "training.ode.train_until_epoch=3", "test.test_interval=3", "test.test_dp_interval=3"],
        ["nef", "nef+ode", "ode"], coords, eqv_kinds=("rotation",), eqv_exact=False, frames_per_traj=2)
    # The check again on the trained decoder's weights without the window: exact to rounding.
    loop, state = train.pop("loop"), train.pop("state")
    trainer = loop.trainer
    plain_cfg = load_experiment_config(name, ["nef.use_gaussian_window=false"])
    decoder = build_models(plain_cfg)[0].to(dev)
    decoder.load_state_dict(trainer.decoder.state_dict())
    frames = torch.as_tensor(next(iter(loop.val_loader))[0], device=dev)[:, 0]
    p, a, w = latents_to_pose(trainer.fit_latents(state, frames, generator=torch.Generator().manual_seed(SEED)))
    xs = trainer.coords[None, :512].expand(p.shape[0], 512, 3)
    errs = {tag: equivariance_errors(dec, xs, p, a, w, invariant=dec.cross_attn_invariant, coordinate_system="ball")
            for tag, dec in (("window", trainer.decoder), ("no window", decoder))}
    log(f"[ihc] ball equivariance of the trained decoder on fitted latents: rotation error with the window "
        f"{errs['window']['rotation']:.3e} (the Euler-window quirk), without it {errs['no window']['rotation']:.3e} "
        f"(tol 1e-4)")
    if not (np.isfinite(errs["window"]["rotation"]) and errs["no window"]["rotation"] <= 1e-4):
        raise AssertionError(f"ball equivariance errors {errs}")
    del loop, state, trainer, decoder
    fc = forecast_phase(cfg, coords, train["frames"], name)
    keep_test_split(name, data, IHC_SIGNALS)
    shutil.rmtree(data)  # the generated data is not kept: the output directory stays small
    torch.cuda.empty_cache()
    log(f"[phase 23-25] ihc in {time.perf_counter() - t0:.2f} s")
    return {**k1, "launches": train["k1"] + fc["launches"], "max_abs_err": max(k1["max_abs_err"], fc["max_abs_err"])}


def sa_config(*overrides: str):
    """``navier_stokes`` at its full width with the latent self-attention stack."""
    return load_experiment_config("navier_stokes", [f"nef.num_layers={SA_LAYERS}", *overrides])


def attention_phase(dev) -> dict:
    """26. The decoder with SA_LAYERS latent self-attention blocks at NS width (seeded random
    weights): K1 on the folded, attended latents against the eager decoder at 160 x 512 and a
    ragged 8 x 1000, K1's time at 160 x 512 and the fold's (stem, blocks, weight folds); then
    the ode and dual steps on K1 + K2 against the eager ones with the cotangent 0 at the
    points near an RFF ReLU's kink (``step_parity_phase`` with ``ties``), and the same
    numbers with no gate on a second draw. The kernels-line error is K1's against its plain
    version at 160 x 512."""
    t0 = time.perf_counter()
    cfg = sa_config()
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    coords = planar_coords(GRID, GRID)
    errs, res = [], {}
    for b, M in ((NUM_SIGNALS * NUM_FRAMES, 512), (NUM_SIGNALS, 1000)):
        decoder, x, p, a, w = random_decode(cfg, coords, dev, b, M, SEED + 20 + b)
        with torch.no_grad():
            args = decoder.kernel_inputs(x, p, a, w)
            out_k = fused_decode_fwd(*args, num_heads=H, head_dim=D)
            eager = decoder(x, p, a, w)
            check_close(f"K1 behind {SA_LAYERS} self-attention blocks b={b} c={M} vs the eager decoder", out_k, eager)
            errs.append(check_close(f"K1 behind {SA_LAYERS} self-attention blocks b={b} c={M} vs its plain version",
                                    out_k, fused_decode_plain(*args, num_heads=H, head_dim=D)))
            if b == NUM_SIGNALS * NUM_FRAMES:
                split = shared_weights(args[6])
                k_ms = cuda_ms(lambda: fused_decode_fwd(*args, num_heads=H, head_dim=D, split=split), iters=20)
                p_ms = cuda_ms(lambda: fused_decode_plain(*args, num_heads=H, head_dim=D), iters=3, warmup=1)
                fold_ms = cuda_ms(lambda: decoder.fold(p, a, w), iters=5, warmup=1)
                bd = k1_bounds(cfg, args, out_k)
                res = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                           max_abs_err=errs[-1])
                log(f"[timing] K1 behind the self-attention stack b={b} z={cfg.nef.num_latents} c={M}: {k_ms:.4f} ms "
                    f"(phase 4 times this shape without the stack); plain {p_ms:.4f} ms; bound {bd['bound_ms']:.4f} ms "
                    f"by {bd['bound_by']}; the fold with {SA_LAYERS} blocks {fold_ms:.4f} ms a decode; "
                    f"{k1_class_note(args, H, D, cfg.nef.num_out)}")
        del decoder, args, out_k, eager
    for seed in (SEED, SEED + 40):  # the gate's draw, and a witness draw of weights, frames and masks
        step_parity_phase(cfg, coords, smooth_trajectories(NUM_SIGNALS, TRAIN_FRAMES, GRID, seed + 3), dev,
                          ties=True, seed=seed, gate=seed == SEED)
    torch.cuda.empty_cache()
    log(f"[phase 26] self-attention decoder in {time.perf_counter() - t0:.2f} s")
    return res


def reset_launches() -> None:
    """Every launch count to 0: K1's and K2's totals and their tallies by program (compute dtype
    and shape). Never inside ``on_path``, which diffs the tallies around its run."""
    for kernel in (fused_decode_fwd, fused_decode_bwd):
        kernel.launches = 0
        kernel.launches_by_program.clear()


def launches_of(fn):
    """(fn's result, its K1 launches, its K2 launches), synchronised; a path's run (``on_path``)."""
    k1, k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
    with on_path():
        out = fn()
        torch.cuda.synchronize()
    return out, fused_decode_fwd.launches - k1, fused_decode_bwd.launches - k2


# The launches of the paths the script drives (a forecast, a training run, a step: not a kernel
# held against its plain version or timed), by (kernel, compute dtype, b, z, c, I[, weight
# grads]): the kernels line's counts, diffed from ``launches_by_program`` around each run.
PATH_LAUNCHES = Counter()


@contextlib.contextmanager
def on_path():
    """Counts the K1 and K2 launches of the enclosed run into PATH_LAUNCHES."""
    before = [Counter(k.launches_by_program) for k in (fused_decode_fwd, fused_decode_bwd)]
    try:
        yield
    finally:
        for name, k, b in zip(("K1", "K2"), (fused_decode_fwd, fused_decode_bwd), before):
            for key, n in (k.launches_by_program - b).items():
                PATH_LAUNCHES[(name, *key)] += n


def device_summary(prof, trace_file: Path, top: int = 10) -> str:
    """The ``top`` device operations (kernels, copies) by device time (``key_averages``), and the
    share of the traced window (first to last event) in which some kernel, copy or set
    ran on the card (the union of their intervals in the Chrome trace)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # The device's own entries (kernels, copies), not the host operations that launched them.
    ops = sorted((e for e in prof.key_averages() if dev_us(e) > 0 and str(e.device_type).endswith("CUDA")),
                 key=dev_us, reverse=True)
    events = json.loads(trace_file.read_text())["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in timed
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    start, end = min(e["ts"] for e in timed), max(e["ts"] + e["dur"] for e in timed)
    busy, cur = 0.0, None
    for lo, hi in device:
        if cur is None or lo > cur[1]:
            busy += cur[1] - cur[0] if cur else 0.0
            cur = [lo, hi]
        else:
            cur[1] = max(cur[1], hi)
    busy += cur[1] - cur[0] if cur else 0.0
    lines = [f"{dev_us(e) / 1e3:.3f} ms x{e.count} {e.key[:90]}" for e in ops[:top]]
    return (f"device busy {busy / 1e3:.3f} of {(end - start) / 1e3:.3f} ms traced "
            f"({100 * busy / (end - start):.1f} %), {len(device)} device activities; top {top} by device time: "
            + " | ".join(lines))


def f64_trainer(trainer) -> MetaSGDTrainer:
    """A float64 copy of ``trainer`` on the eager decoder: its weights (the decoder's and the
    ODE's), its coordinates, and inner loops that decode eagerly. Phase 27 prints both f32
    nef steps' distances from it: which side f32 rounding moves."""
    cfg = trainer.cfg
    ref = MetaSGDTrainer(cfg, *build_models(cfg), trainer.coords.cpu().numpy(), seed=SEED, device=trainer.device)
    ref.decoder.load_state_dict(trainer.decoder.state_dict())
    ref.ode_model.load_state_dict(trainer.ode_model.state_dict())
    ref.decoder.double()
    ref.ode_model.double()
    ref.coords = ref.coords.double()
    ref.train_backend = ref.eval_backend = ref.ode_backend = "eager"

    def fit_decode(x, p, a, window):  # reads ref.decoder at each call, as the trainer's own does
        return ref.decoder(x, p, a, window)

    ref.inner_loop = make_inner_loop(fit_decode, ref.coords, ref.inner_cfg)
    ref.train_inner_loop = make_train_inner_loop(fit_decode, ref.coords, ref.inner_cfg)
    return ref


def f64_step(trainer, kind: str, state, traj, stop=None, **draws):
    """``kind``'s (``nef``, ``ode``, ``dual``) loss and gradients on ``f64_trainer(trainer)``
    from ``state`` and the same draws, cast back to f32; ``stop``, a ``TieStop``'s masks,
    stops the cotangent at the same points of the step's decodes."""
    ref = f64_trainer(trainer)
    if stop is not None:
        ref.decoder = TieStop(ref.decoder, stop)
    state64 = {g: {k: v.double() for k, v in state[g].items()} for g in ("autodecoder", "meta_sgd_lrs")}
    loss, grads = getattr(ref, f"{kind}_grads")(state64, traj.double(), **draws)
    if stop is not None and ref.decoder.calls != len(stop):
        raise AssertionError(f"the float64 step decoded {ref.decoder.calls} times, the f32 step {len(stop)}")
    return loss.float(), {g: {k: v.float() for k, v in d.items()} for g, d in grads.items()}


def second_order_phase(dev) -> dict:
    """27. Second order through K1 and K2 (their f32 programs: ``nef.backend=pallas_interpret``) at num_layers 0 and
    SA_LAYERS, NS width, seeded random weights: the nef step on the kernels against the same
    step on the eager decoder from the same state, frames and masks (loss rel 1e-5, every
    gradient tensor rel-L2 NEF_TOL), and both against the eager step in float64
    (``f64_step``: which side f32 rounding moves); ``Forecaster.fit`` on the kernels against the eager fit
    (fitted latents rel-L2 NEF_TOL); the launches of each; warm medians of both on both
    backends; one nef step under ``utils.profiling.trace``; K1 and K2 at the nef step's
    16 x 512 and the fit's 8 x 512 against their plain versions, timed (the kernels line's
    errors and times at those shapes, by ``b``)."""
    t0 = time.perf_counter()
    coords = planar_coords(GRID, GRID)
    traj = torch.from_numpy(smooth_trajectories(NUM_SIGNALS, TRAIN_FRAMES, GRID, SEED + 3)).to(dev)
    frames = smooth_frames(NUM_SIGNALS, GRID, SEED)
    N = coords.shape[0]
    out = {"launches": {}}
    for layers in (0, SA_LAYERS):
        cfg = load_experiment_config("navier_stokes", [f"nef.num_layers={layers}", "nef.backend=pallas_interpret",
                                                        "nef.eval_backend=pallas_interpret",
                                                        "nef.ode_backend=pallas_interpret"])
        K, M = cfg.meta.num_inner_steps, cfg.training.max_num_sampled_points
        trainer = make_trainer(cfg, coords)
        if (trainer.train_backend, trainer.eval_backend, trainer.ode_backend) != (F32_KERNELS,) * 3:
            raise AssertionError(f"nef.backend=pallas_interpret resolved to {trainer.train_backend}")
        state = trainer.init_state()
        gen = torch.Generator().manual_seed(SEED + 30 + layers)
        masks = torch.stack([torch.randperm(N, generator=gen)[:M] for _ in range(K + 1)])
        frame_idx = torch.randperm(cfg.dataset.traj_len_train, generator=gen)[:cfg.training.nef.fit_on_num_steps]
        tag = f"num_layers={layers}"
        grads = {}
        for backend in (F32_KERNELS, "eager"):
            trainer.train_backend = backend
            grads[backend], k1, k2 = launches_of(lambda: trainer.nef_grads(state, traj, frame_idx=frame_idx,
                                                                             masks=masks))
            if backend == F32_KERNELS:
                out["launches"][f"nef {tag}"] = (k1, k2)
        trainer.train_backend = F32_KERNELS
        (loss_k, grads_k), (loss_e, grads_e) = grads[F32_KERNELS], grads["eager"]
        # Which side f32 rounding moves: both against the eager step in float64 (no gate).
        loss_64, grads_64 = f64_step(trainer, "nef", state, traj, frame_idx=frame_idx, masks=masks)
        for label, (loss, g) in (("eager decoder in f32", grads["eager"]), ("kernels", grads[F32_KERNELS])):
            worst, name, _, n = grad_errors(g, grads_64)
            log(f"[second order] nef step {tag} on the {label} against the eager decoder in float64: loss "
                f"rel {abs(float(loss) - float(loss_64)) / abs(float(loss_64)):.3e}, {n} gradient tensors, worst "
                f"rel_l2 {worst:.3e} ({name})")
        check_close(f"nef step loss {tag}, kernels vs eager decoder", loss_k, loss_e)
        check_grads(f"nef step gradients {tag}, kernels vs eager decoder", grads_k, grads_e, NEF_TOL)
        nef_launches = out["launches"][f"nef {tag}"]
        # K + 1 decodes on K1; K2 gives the K inner gradients (with a graph), the query
        # decode's VJP, and the first-order VJP of each inner decode's output, on which the
        # inner loss's cotangent depends.
        if nef_launches != (K + 1, 2 * K + 1):
            raise AssertionError(f"nef step {tag} launched (K1, K2) {nef_launches}, not {(K + 1, 2 * K + 1)}")

        fc = Forecaster(cfg, coords, device="cuda")
        fit_masks = masks[:K]
        fits = {}
        for backend in (F32_KERNELS, "eager"):
            fc.trainer.train_backend = backend
            fits[backend], k1, k2 = launches_of(lambda: fc.fit(frames, masks=fit_masks))
            if backend == F32_KERNELS:
                out["launches"][f"fit {tag}"] = (k1, k2)
        for name in fits["eager"]:
            check_close(f"fit {tag} {name}, kernels vs eager decoder", fits[F32_KERNELS][name], fits["eager"][name],
                        NEF_TOL)
        if out["launches"][f"fit {tag}"] != (K, K):
            raise AssertionError(f"the fit {tag} launched {out['launches'][f'fit {tag}']}, not {(K, K)}")
        log(f"[second order] {tag}: launches (K1, K2) of one nef step {nef_launches}, of one fit "
            f"{out['launches'][f'fit {tag}']} at {K} inner steps")

        medians = {}
        for backend in (F32_KERNELS, "eager"):
            trainer.train_backend = fc.trainer.train_backend = backend
            for name, fn in (("nef step", lambda: trainer.nef_train_step(state, traj)),
                             ("fit", lambda: fc.fit(frames))):
                samples = [sync_time(fn)[1] * 1e3 for _ in range(WARM_REPEATS)]
                medians[(name, backend)] = statistics.median(samples)
                log(f"[second order] {tag} {name} on {backend} (warm, median of {WARM_REPEATS}): "
                    f"{medians[(name, backend)]:.2f} ms (samples {', '.join(f'{v:.2f}' for v in samples)})")
        trainer.train_backend = fc.trainer.train_backend = F32_KERNELS
        out[f"medians {tag}"] = medians
        if layers == SA_LAYERS:
            trace_dir = fresh_dir(OUT_DIR / "trace_nef_step")
            with trace(str(trace_dir)) as prof:
                trainer.nef_train_step(state, traj)
            trace_file = trace_dir / "trace.json"
            log(f"[trace] one nef step ({tag}, kernels; trace {trace_file.stat().st_size / 1e6:.1f} MB, not kept): "
                + device_summary(prof, trace_file))
            shutil.rmtree(trace_dir)
        del trainer, state, fc, grads, fits
        torch.cuda.empty_cache()

    cfg = sa_config()
    b_nef = cfg.dataset.batch_size * cfg.training.nef.fit_on_num_steps
    k1 = k1_shapes_phase("nef step and fit", [(cfg, b_nef, 512), (cfg, NUM_SIGNALS, 512)], dev)
    log(f"[phase 27] K2 at the nef step's b={b_nef} x 512 and the fit's b={NUM_SIGNALS} x 512")
    k2 = {b: k2_phase(cfg, coords, dev, b=b) for b in (b_nef, NUM_SIGNALS)}
    for b, r in k2.items():
        log(f"[timing] K2 at b={b} c=512: with weight gradients {r['timing'][True]['ms']:.4f} ms, without "
            f"{r['timing'][False]['ms']:.4f} ms: the inner steps' VJPs take the weight gradients, which only "
            f"the double backward's graph reads (it takes them from the plain composition)")
    torch.cuda.empty_cache()
    log(f"[phase 27] second order through K1 and K2 in {time.perf_counter() - t0:.2f} s")
    k1 = {b: {k: k1["timing"][(cfg.nef.num_latents, b, 512)][k]
              for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")} for b in (b_nef, NUM_SIGNALS)}
    return {**out, "k1": k1, "k2": k2, "b_nef": b_nef}


def sa_train_phase(dev) -> dict:
    """28. ``run_experiment`` for ``navier_stokes nef.num_layers=SA_LAYERS nef.backend=pallas``
    on phase 7's data for 3 epochs (nef, dual, ode), validation with the dp variants and the
    equivariance check: the record's backends, finite metrics, K1's and K2's launches against
    the loop's arithmetic; then ``Forecaster.from_checkpoint`` on its log directory against a
    ``Forecaster`` built from the run's final state (same seed, ``backend='pallas'``): the
    same forecast of NUM_SIGNALS test frames for NUM_FRAMES frames bit for bit; its stages.
    Returns the launches of the run and the forecast, in all and by shape (the kernels line's
    counts for this slice's shapes)."""
    t0 = time.perf_counter()
    log_dir = fresh_dir(OUT_DIR / "navier_stokes_attention_train")
    over = [f"nef.num_layers={SA_LAYERS}", "nef.backend=pallas"]
    cfg = load_experiment_config("navier_stokes", train_overrides(*over, log_dir=log_dir))
    coords = planar_coords(GRID, GRID)
    reset_launches()
    with on_path():
        (loop, state), run_s = sync_time(lambda: run_experiment(cfg, device="cuda"))
    k1, k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
    k1_shapes, k2_shapes = Counter(fused_decode_fwd.launches_by_program), Counter(fused_decode_bwd.launches_by_program)
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    rec = next(r for r in records if "train_backend" in r)
    backends = tuple(rec[k] for k in ("train_backend", "eval_backend", "ode_backend"))
    epochs = [r for r in records if "train_mse_epoch" in r]
    values = [v for r in records for k, v in r.items() if "mse" in k or k.startswith("equivariance_err_")]
    K, M = cfg.meta.num_inner_steps, cfg.training.max_num_sampled_points
    n_train, n_val = len(loop.train_loader), len(loop.val_loader)
    val_steps, chunks = (n_val + n_train) * (1 + 3), -(-coords.shape[0] // M)
    # Epochs nef, dual, ode: K + 1 decodes a step; K2 2K + 1 times a second-order step
    # (nef, dual) and K + 1 times an ode step; a validation step fits (K + K) and decodes
    # in chunks; the equivariance check fits once (its decodes are eager).
    expect = (n_train * 3 * (K + 1) + val_steps * (K + chunks) + K,
              n_train * (2 * (2 * K + 1) + K + 1) + val_steps * K + K)
    epoch_mse = ", ".join(f"{r['train_mse_epoch']:.4e}" for r in epochs)
    log(f"[attention] run_experiment(3 epochs, navier_stokes {' '.join(over)}) in {run_s:.2f} s: phases "
        f"{[r['phase'] for r in epochs]}, train_mse_epoch [{epoch_mse}]; "
        f"record backends {backends}; K1 launches {k1}, K2 launches {k2} (expected {expect}); by (dtype, b, z, c, I): "
        f"K1 {dict(sorted(k1_shapes.items(), key=str))}, K2 (and weight gradients) {dict(sorted(k2_shapes.items(), key=str))}")
    if backends != ("kernel",) * 3:
        raise AssertionError(f"the run record gives backends {backends}")
    if [r["phase"] for r in epochs] != ["nef", "nef+ode", "ode"] or not all(np.isfinite(v) for v in values):
        raise AssertionError(f"phases {[r['phase'] for r in epochs]} or non-finite metrics {values}")
    if (k1, k2) != expect:
        raise AssertionError(f"K1/K2 launches {(k1, k2)} != expected {expect}")

    fc_cfg = load_experiment_config("navier_stokes", over)
    served, build_s = sync_time(lambda: Forecaster.from_checkpoint(str(log_dir), fc_cfg, coords))
    params = {"nef": loop.trainer.decoder.state_dict(), "ode": loop.trainer.ode_model.state_dict(),
              "autodecoder": state["autodecoder"], "meta_sgd_lrs": state["meta_sgd_lrs"]}
    built = Forecaster(fc_cfg, coords, params=params, device="cuda", backend="pallas")
    frames = torch.as_tensor(next(iter(loop.val_loader))[0], device=dev)[:NUM_SIGNALS, 0]
    reset_launches()
    with on_path():
        got, fc_s = sync_time(lambda: served.forecast(frames, num_frames=NUM_FRAMES))
    fc_k1, fc_k2 = fused_decode_fwd.launches, fused_decode_bwd.launches
    k1_shapes += fused_decode_fwd.launches_by_program
    want = built.forecast(frames, num_frames=NUM_FRAMES)
    same = torch.equal(got, want)
    stages = {"fit": [], "rollout": [], "decode": []}
    for _ in range(WARM_REPEATS):
        fitted, fit_s = sync_time(lambda: served.fit(frames))
        traj, roll_s = sync_time(lambda: served.rollout(fitted, NUM_FRAMES))
        _, dec_s = sync_time(lambda: served.decode(traj))
        for name, sec in (("fit", fit_s), ("rollout", roll_s), ("decode", dec_s)):
            stages[name].append(sec * 1e3)
    log(f"[attention] Forecaster.from_checkpoint({log_dir.name}, epoch {loop.checkpoints.latest_epoch()}) built in "
        f"{build_s:.3f} s; backends fit {served.trainer.train_backend}, decode {served.trainer.eval_backend}; "
        f"forecast {tuple(got.shape)} in {fc_s:.3f} s (first call), K1 {fc_k1}, K2 {fc_k2}; equal bit for bit to "
        f"the Forecaster built from the run's final state: {same}; stages (warm, median of {WARM_REPEATS}): "
        + " | ".join(f"{n} {statistics.median(v):.2f} ms" for n, v in stages.items()))
    if not same or not torch.isfinite(got).all() or got.shape != (NUM_SIGNALS, NUM_FRAMES, coords.shape[0], 1):
        raise AssertionError(f"the served forecast differs from the built one or is malformed: {tuple(got.shape)}")
    if (fc_k1, fc_k2) != (chunks, 0):
        raise AssertionError(f"the served forecast launched {(fc_k1, fc_k2)}, not {(chunks, 0)}")
    p, a, w = latents_to_pose(served.fit(frames))
    del loop, state, served, built
    shutil.rmtree(log_dir / "checkpoints")  # served above; what comes back stays under its 64 MiB
    torch.cuda.empty_cache()
    log(f"[phase 28] the slice end to end in {time.perf_counter() - t0:.2f} s")
    return {"k1": k1 + fc_k1, "k2": k2, "k1_shapes": k1_shapes, "k2_shapes": k2_shapes, "latents": (p, a, w)}


def options_phase(dev, latents) -> None:
    """29. The other options on the eager path, NS width: one nef and one ode step with
    ``nef.embedding_type=ffn`` and ``=polynomial`` (degree 2), whose backends resolve to
    eager (no K1 or K2 launch) and whose losses are finite; the ``EquivariantTransformer``
    (hid 128, 2 heads, 2 layers, with and without global pooling) on phase 28's fitted
    latents, card against CPU within rel-L2 REL_L2_TOL."""
    t0 = time.perf_counter()
    coords = planar_coords(GRID, GRID)
    traj = torch.from_numpy(smooth_trajectories(NUM_SIGNALS, TRAIN_FRAMES, GRID, SEED + 4)).to(dev)
    for kind, extra in (("ffn", ()), ("polynomial", ("nef.embedding_freq_multiplier_invariant=2",
                                                     "nef.embedding_freq_multiplier_value=2"))):
        cfg = load_experiment_config("navier_stokes", [f"nef.embedding_type={kind}", "nef.backend=pallas", *extra])
        trainer = make_trainer(cfg, coords)
        backends = (trainer.train_backend, trainer.eval_backend, trainer.ode_backend)
        state = trainer.init_state()
        ((loss_n, state), k1n, k2n), nef_s = sync_time(lambda: launches_of(lambda: trainer.nef_train_step(state, traj)))
        ((loss_o, state), k1o, k2o), ode_s = sync_time(lambda: launches_of(lambda: trainer.ode_train_step(state, traj)))
        log(f"[options] embedding_type={kind} {' '.join(extra)}: backends {backends}; nef step loss "
            f"{float(loss_n):.4e} in {nef_s * 1e3:.2f} ms, ode step loss {float(loss_o):.4e} in {ode_s * 1e3:.2f} ms "
            f"(first calls); K1 / K2 launches {k1n + k1o} / {k2n + k2o}")
        if backends != ("eager",) * 3 or not (np.isfinite(float(loss_n)) and np.isfinite(float(loss_o))) \
                or (k1n, k2n, k1o, k2o) != (0, 0, 0, 0):
            raise AssertionError(f"{kind}: backends {backends}, losses {float(loss_n)}, {float(loss_o)}, "
                                 f"launches {(k1n, k2n, k1o, k2o)}")
        del trainer, state
    cfg = load_experiment_config("navier_stokes")
    for pooling in (False, True):
        tr = EquivariantTransformer(num_hidden=cfg.nef.num_hidden, num_heads=cfg.nef.num_heads, num_layers=2,
                                    num_out=cfg.nef.latent_dim, latent_dim=cfg.nef.latent_dim,
                                    self_attn_invariant=get_sa_invariant(cfg.nef), embedding_type="rff",
                                    embedding_freq_multiplier=(cfg.nef.embedding_freq_multiplier_invariant,
                                                               cfg.nef.embedding_freq_multiplier_value),
                                    condition_value_transform=True, global_pooling=pooling)
        reset_parameters(tr, torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            on_cpu = tr(tuple(x.cpu() for x in latents))
            on_card = tr.to(dev)(latents)
        check_close(f"EquivariantTransformer global_pooling={pooling} {tuple(on_card.shape)} card vs CPU",
                    on_card.cpu(), on_cpu)
    log(f"[phase 29] the other options in {time.perf_counter() - t0:.2f} s")


# ----------------------------------------------------------------- phases 30-33


@contextlib.contextmanager
def rollout_remat(on: bool):
    """The training rollout rematerialized (``on``, the default) or stored: the solver call
    of ``train.steps.latent_rollout`` with its ``remat`` turned off when not ``on``."""
    real = train_steps.solve_latent_ode
    train_steps.solve_latent_ode = lambda *a, **kw: real(*a, **{**kw, "remat": on and kw["remat"]})
    try:
        yield
    finally:
        train_steps.solve_latent_ode = real


def step_draws(cfg, seed: int) -> dict:
    """A step's draws for a batch of ``cfg``: the nef step's frames [fit_on_num_steps], the
    inner-loop masks [K + 1, M] and the rollout's subsets [T, M]."""
    gen = torch.Generator().manual_seed(seed)
    N, M, T = GRID * GRID, cfg.training.max_num_sampled_points, cfg.dataset.traj_len_train
    return {"frame_idx": torch.randperm(T, generator=gen)[:cfg.training.nef.fit_on_num_steps],
            "masks": torch.stack([torch.randperm(N, generator=gen)[:M] for _ in range(cfg.meta.num_inner_steps + 1)]),
            "ode_masks": torch.stack([torch.randperm(N, generator=gen)[:M] for _ in range(T)])}


def step_grads(trainer, state, traj, draws) -> dict:
    """{kind: (loss, grads)} of the nef, ode and dual steps from one state, ``draws`` handed in."""
    return {"nef": trainer.nef_grads(state, traj, draws["frame_idx"], draws["masks"]),
            "ode": trainer.ode_grads(state, traj, draws["masks"], draws["ode_masks"]),
            "dual": trainer.dual_grads(state, traj, draws["masks"], draws["ode_masks"])}


def solvers_phase(dev) -> dict:
    """30. The ode and dual steps at full width with the rollout rematerialized (JAX's
    default) and stored, at the training horizon and at 50 frames: losses and gradients,
    warm medians, peak memory; the kernels' launches by shape."""
    coords = planar_coords(GRID, GRID)
    reset_launches()
    peaks = {}
    for extra in ([], [f"dataset.traj_len_train={LONG_HORIZON}"]):
        cfg = load_experiment_config("navier_stokes", extra)
        T = cfg.dataset.traj_len_train
        trainer = make_trainer(cfg, coords)
        state = trainer.init_state()
        traj = torch.from_numpy(smooth_trajectories(NUM_SIGNALS, T, GRID, SEED + 30)).to(dev)
        draws = step_draws(cfg, SEED + 31)
        for kind in ("ode", "dual"):
            fn = getattr(trainer, f"{kind}_grads")
            res = {}
            for on in (True, False):
                with rollout_remat(on):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    with on_path():
                        loss, grads = fn(state, traj, draws["masks"], draws["ode_masks"])
                        torch.cuda.synchronize()
                    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
                    samples = [sync_time(lambda: fn(state, traj, draws["masks"], draws["ode_masks"]))[1] * 1e3
                               for _ in range(WARM_REPEATS)]
                res[on] = (loss, grads, peak, statistics.median(samples))
            label = f"[solvers] {kind} step T={T} b={NUM_SIGNALS}"
            loss_rel = abs(float(res[True][0]) / float(res[False][0]) - 1)
            check_grads(f"{label}, remat on against off (loss rel {loss_rel:.3e})", res[True][1], res[False][1],
                        tol=REMAT_TOL)
            if not loss_rel <= REMAT_TOL:
                raise AssertionError(f"{label}: remat moved the loss by {loss_rel:.3e}")
            log(f"{label}: remat on {res[True][3]:.2f} ms, peak {res[True][2]:.1f} MiB above the state; "
                f"off {res[False][3]:.2f} ms, peak {res[False][2]:.1f} MiB (warm medians of {WARM_REPEATS})")
            peaks[(kind, T)] = {on: res[on][2:] for on in res}
        del trainer, state, traj
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    b, I = NUM_SIGNALS * LONG_HORIZON, get_ca_invariant(cfg.nef).dim
    k1 = fused_decode_fwd.launches_by_program[(BF16, b, 4, 512, I)]  # the YAML's pallas on the card: bf16
    k2 = {wg: fused_decode_bwd.launches_by_program[(BF16, b, 4, 512, I, wg)] for wg in (False, True)}
    log(f"[solvers] launches of the bf16 programs at T={LONG_HORIZON} (b={b} z=4 c=512): K1 {k1}, K2 without weight "
        f"gradients {k2[False]}, with {k2[True]}")
    if not (k1 and k2[False] and k2[True]):
        raise AssertionError("phase 30 launched K1 or K2 no time at the 50-frame rollout's shape")
    cfg = load_experiment_config("navier_stokes")
    return {"peaks": peaks, "b": b, "k1_launches": k1, "k2_launches": k2,
            "k1": k1_shapes_phase("rollout T=50", [(cfg, b, 512)], dev), "k2": k2_phase(cfg, coords, dev, b=b)}


# The configs whose decode widths K2 first met through ``nef.backend: pallas`` (phase 34).
K2_CONFIGS = ("diffusion_plane", "cahn_hilliard", "diff_sphere", "ihc")


def all_finite(x) -> bool:
    if isinstance(x, dict):
        return all(all_finite(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return all(all_finite(v) for v in x)
    return bool(torch.isfinite(x).all()) if torch.is_tensor(x) else True


def k2_configs_phase(dev) -> dict:
    """34. K2 at the narrow configs' widths through ``nef.backend=pallas`` (no YAML sets it):
    for each of ``K2_CONFIGS`` at full width with seeded random weights, one nef step
    (``nef_grads``) and one fit (``fit_latents``) on a seeded random trajectory, K2's launches
    counted by shape (finite loss and gradients); then K2 against its plain version in all four
    modes with the kinks stopped, one launch repeated bit for bit, and timed, at the nef step's
    (batch x ``fit_on_num_steps`` frames) and the fit's (batch frames) x
    ``max_num_sampled_points``."""
    t0 = time.perf_counter()
    res = {}
    for name in K2_CONFIGS:
        cfg = shape_config(name, "nef.backend=pallas")
        coords = config_coords(cfg)
        trainer = make_trainer(cfg, coords)
        state = trainer.init_state()
        gen = torch.Generator().manual_seed(SEED + 40)
        traj = (0.5 * torch.randn(cfg.dataset.batch_size, cfg.dataset.traj_len_train, coords.shape[0],
                                  cfg.nef.num_out, generator=gen)).to(dev)
        reset_launches()
        (loss, grads), _, k2_nef = launches_of(lambda: trainer.nef_grads(state, traj))
        nef_shapes = Counter(fused_decode_bwd.launches_by_program)
        fit, _, k2_fit = launches_of(lambda: trainer.fit_latents(state, traj[:, 0]))
        shapes = Counter(fused_decode_bwd.launches_by_program)
        log(f"[phase 34] {name} (nef.backend=pallas): nef step loss {float(loss):.4e}, K2 launches {k2_nef}; fit "
            f"K2 launches {k2_fit}; by (dtype, b, z, c, I, weight grads): {dict(sorted(shapes.items(), key=str))}")
        if not (all_finite((loss, grads, fit)) and k2_nef and k2_fit):
            raise AssertionError(f"{name}: the nef step or the fit on the kernels is not finite or launched no K2")
        # K2 is asked for weight gradients only where something reads them: the nef step's K inner steps
        # (latent_grads_only) and the fit's K steps (the decoder frozen) take none, the outer backward through each
        # inner step and the query decode take them.
        K = cfg.meta.num_inner_steps
        split = {wg: sum(v for k, v in nef_shapes.items() if k[-1] == wg) for wg in (False, True)}
        fit_split = {wg: sum(v for k, v in (shapes - nef_shapes).items() if k[-1] == wg) for wg in (False, True)}
        log(f"[phase 34] {name}: K2 launches without / with weight gradients: nef step {split[False]} / {split[True]} "
            f"(K = {K} inner steps), fit {fit_split[False]} / {fit_split[True]}")
        if split != {False: K, True: K + 1} or fit_split != {False: K, True: 0}:
            raise AssertionError(f"{name}: K2's weight-gradient split {split} (nef step), {fit_split} (fit); want "
                                 f"{K} / {K + 1} and {K} / 0")
        Z, M = cfg.nef.num_latents, cfg.training.max_num_sampled_points
        b_nef = cfg.dataset.batch_size * cfg.training.nef.fit_on_num_steps
        out = {"shapes": shapes, "Z": Z, "M": M, "b_nef": b_nef, "b_fit": cfg.dataset.batch_size}
        del trainer, state, traj, grads, fit
        torch.cuda.empty_cache()
        for what in ("b_nef", "b_fit"):
            log(f"[phase 34] K2 at {name}'s {'nef step' if what == 'b_nef' else 'fit'}: b={out[what]} z={Z} c={M}")
            out[what.replace("b_", "k2_")] = k2_phase(cfg, coords, dev, b=out[what])
        res[name] = out
        torch.cuda.empty_cache()
    log(f"[phase 34] K2 at {len(K2_CONFIGS)} configs' nef steps and fits in {time.perf_counter() - t0:.2f} s")
    return res


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def world1_phase(dev, traj: torch.Tensor, frames: np.ndarray) -> None:
    """31 (a). A world of 1 over NCCL: the steps through the data mesh, the coordinate-sharded
    validation and the forecast decode, each bit for bit the path without a mesh."""
    cfg = load_experiment_config("navier_stokes")
    coords = planar_coords(GRID, GRID)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh("cuda")
        plain, meshed = make_trainer(cfg, coords), MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=SEED,
                                                                  device="cuda", mesh=mesh)
        draws = step_draws(cfg, SEED + 40)
        want, got = (step_grads(tr, tr.init_state(), traj, draws) for tr in (plain, meshed))
        sharded = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=SEED, device="cuda", coord_mesh=mesh)
        val = [tr.val_step(tr.init_state(), traj, batch_idx=3) for tr in (plain, sharded)]
        fc = [Forecaster(cfg, coords, device="cuda", coord_mesh=m).forecast(frames, NUM_FRAMES) for m in (None, mesh)]
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    same = {kind: float(got[kind][0]) == float(want[kind][0]) and grad_errors(got[kind][1], want[kind][1])[2] == 0
            for kind in want}
    same["val"] = all(torch.equal(a, b) for a, b in zip(*val))
    same["forecast"] = torch.equal(*fc)
    log(f"[world] NCCL world of 1: bit for bit the single-process path: {same}")
    if not all(same.values()):
        raise AssertionError(f"the NCCL world of 1 differs from the single-process path: {same}")


def world_rank(rank: int, payload_file: str, out_dir: str) -> None:
    """31 (b)-(e), one rank of the gloo world on the one card: the steps on its rows with the
    payload's draws, their warm medians, the coordinate-sharded validation and forecast,
    three steps with the generator's draws, each part's K1 / K2 launches by program (compute
    dtype and shape, as this rank's wrappers counted them)."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank, world_size=WORLD)
    try:
        for src in (KERNEL_SOURCE, BWD_KERNEL_SOURCE, KERNEL_SOURCE_BF16, BWD_KERNEL_SOURCE_BF16):
            cuda_lib.load(src)  # built by the parent: the cached libraries
        pl = torch.load(payload_file, weights_only=False)
        cfg = load_experiment_config("navier_stokes")
        coords = planar_coords(GRID, GRID)
        mesh = make_mesh("cuda")
        trainer = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=SEED, device="cuda", mesh=mesh)
        state = trainer.init_state()
        x = shard_batch(pl["traj"], mesh)
        reset_launches()
        grads = step_grads(trainer, state, x, pl["draws"])
        torch.cuda.synchronize()
        step_launches = (Counter(fused_decode_fwd.launches_by_program), Counter(fused_decode_bwd.launches_by_program))
        medians = {}
        for kind, (fn, args) in {"nef": (trainer.nef_grads, ("frame_idx", "masks")),
                                 "ode": (trainer.ode_grads, ("masks", "ode_masks")),
                                 "dual": (trainer.dual_grads, ("masks", "ode_masks"))}.items():
            samples = [sync_time(lambda: fn(state, x, *(pl["draws"][a] for a in args)))[1] * 1e3 for _ in range(3)]
            medians[kind] = statistics.median(samples)
        sharded = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=SEED, device="cuda", coord_mesh=mesh)
        reset_launches()
        val = sharded.val_step(sharded.init_state(), pl["traj"].to("cuda"), batch_idx=3)
        forecast = Forecaster(cfg, coords, device="cuda").forecast(pl["frames"], NUM_FRAMES)
        torch.cuda.synchronize()
        decode_launches = Counter(fused_decode_fwd.launches_by_program)
        for step in (trainer.nef_train_step, trainer.ode_train_step, trainer.dual_train_step):
            step(state, x)
        after = {f"nef.{k}": v for k, v in trainer.nef_group().items()}
        after.update({f"ode.{k}": v for k, v in trainer.ode_group().items()})
        after.update({f"{g}.{k}": v for g in ("autodecoder", "meta_sgd_lrs") for k, v in state[g].items()})
        after.update({f"opt.{g}.{part}.{k}": v for g, opt in state["opt"].items()
                      for part in ("mu", "nu") for k, v in opt.get(part, {}).items()})
        after["generator"] = trainer.generator.get_state()
        cpu = lambda t: t.detach().cpu() if torch.is_tensor(t) else t  # noqa: E731
        torch.save({"grads": {k: (cpu(l), {g: {n: cpu(v) for n, v in gs.items()} for g, gs in gr.items()})
                              for k, (l, gr) in grads.items()},
                    "medians": medians, "step_launches": step_launches, "decode_launches": decode_launches,
                    "val": [cpu(v) for v in val], "forecast": cpu(forecast),
                    "after": {k: cpu(v) for k, v in after.items()}},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def world_phase(dev, traj: torch.Tensor, frames: np.ndarray) -> dict:
    """31 (b)-(e). A world of 2 over gloo with both ranks on the one card, against this
    process: the steps within rel-L2 1e-6 of the mean of this process's steps on the two
    halves of the batch (the ranks' rows), and within 1e-5 of the step on the whole batch,
    or as close to it as those halves come (cuBLAS rounds a product by its shape); the
    sharded decodes bit for bit; the parameters equal across the ranks after three steps;
    each rank's launches."""
    cfg = load_experiment_config("navier_stokes")
    coords = planar_coords(GRID, GRID)
    draws = step_draws(cfg, SEED + 41)
    run_dir = fresh_dir(WORLD_DIR)
    torch.save({"traj": traj.cpu(), "frames": frames, "draws": draws}, run_dir / "payload.pt")
    _, spawn_s = sync_time(lambda: mp.spawn(world_rank, args=(str(run_dir / "payload.pt"), str(run_dir)),
                                            nprocs=WORLD, join=True))
    ranks = [torch.load(run_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    shutil.rmtree(run_dir)
    trainer = make_trainer(cfg, coords)
    state = trainer.init_state()
    cpu = lambda gr: {g: {n: v.cpu() for n, v in gs.items()} for g, gs in gr.items()}  # noqa: E731
    whole = {k: (float(loss), cpu(gr)) for k, (loss, gr) in step_grads(trainer, state, traj, draws).items()}
    rows = NUM_SIGNALS // WORLD
    halves = [step_grads(trainer, state, traj[r * rows:(r + 1) * rows], draws) for r in range(WORLD)]
    mean = {k: (float(sum(h[k][0] for h in halves) / WORLD),
                {g: {n: sum(h[k][1][g][n] for h in halves).cpu() / WORLD for n in gs}
                 for g, gs in halves[0][k][1].items()}) for k in whole}
    want_val = trainer.val_step(state, traj, batch_idx=3)
    want_fc = Forecaster(cfg, coords, device="cuda", coord_mesh=None).forecast(frames, NUM_FRAMES)
    errs = []
    for r, res in enumerate(ranks):
        for kind in whole:
            loss, grads = res["grads"][kind]
            label = f"[world] rank {r} of {WORLD} (gloo, one card), {kind} step on its {rows} rows"
            loss_rel = abs(float(loss) / mean[kind][0] - 1)
            errs.append(check_grads(f"{label} against this process's mean over the halves (loss rel "
                                    f"{loss_rel:.3e})", grads, mean[kind][1], tol=WORLD_TOL))
            to_whole, halves_to_whole = grad_errors(grads, whole[kind][1]), grad_errors(mean[kind][1], whole[kind][1])
            loss_whole = abs(float(loss) / whole[kind][0] - 1)
            log(f"{label} against this process on all {NUM_SIGNALS}: worst rel_l2 {to_whole[0]:.3e} "
                f"({to_whole[1]}), loss rel {loss_whole:.3e}; the halves' mean in this process: "
                f"{halves_to_whole[0]:.3e} ({halves_to_whole[1]}) (tol {REL_L2_TOL:g}, or the halves' own)")
            if not (loss_rel <= WORLD_TOL and loss_whole <= REL_L2_TOL
                    and to_whole[0] <= max(REL_L2_TOL, halves_to_whole[0] + WORLD_TOL)):
                raise AssertionError(f"{label}: loss {loss_rel:.3e} / {loss_whole:.3e}, whole batch "
                                     f"{to_whole[0]:.3e} ({to_whole[1]})")
        same = (all(torch.equal(a, b.cpu()) for a, b in zip(res["val"], want_val)),
                torch.equal(res["forecast"], want_fc.cpu()))
        log(f"[world] rank {r}: coordinate-sharded validation and forecast bit for bit this process's: "
            f"{same}; step medians (warm, 3) " + ", ".join(f"{k} {v:.2f} ms" for k, v in res["medians"].items())
            + f"; K1 launches by (dtype, b, z, c, I): steps {dict(res['step_launches'][0])}, decodes "
            f"{dict(res['decode_launches'])}; K2 by (dtype, b, z, c, I, weight grads): {dict(res['step_launches'][1])}")
        if not all(same):
            raise AssertionError(f"rank {r}: the sharded decodes differ from the unsharded ones: {same}")
    first = ranks[0]["after"]
    differ = [k for k in first if not torch.equal(first[k], ranks[1]["after"][k])]
    log(f"[world] after three steps {len(first)} tensors (parameters, optimizer states, generator), "
        f"{len(differ)} differ between the ranks; the world's spawn and run took {spawn_s:.1f} s")
    if differ or len(first) < 40:
        raise AssertionError(f"the ranks' states differ at {differ[:5]}")
    b, I = NUM_SIGNALS // WORLD * cfg.dataset.traj_len_train, get_ca_invariant(cfg.nef).dim
    # The ranks ran the YAML's pallas: the bf16 programs, as their own counters say.
    k1 = sum(res["step_launches"][0][(BF16, b, 4, 512, I)] for res in ranks)
    k2 = {wg: sum(res["step_launches"][1][(BF16, b, 4, 512, I, wg)] for res in ranks) for wg in (False, True)}
    dec = sum(res["decode_launches"][(BF16, NUM_SIGNALS * NUM_FRAMES, 4, 512, I)] for res in ranks)
    for res in ranks:  # the ranks' paths ran in their own processes: their counters, key for key
        for key, n in (res["step_launches"][0] + res["decode_launches"]).items():
            PATH_LAUNCHES[("K1", *key)] += n
        for key, n in res["step_launches"][1].items():
            PATH_LAUNCHES[("K2", *key)] += n
    if not (k1 and k2[False] and k2[True] and dec):
        raise AssertionError(f"the world launched K1 or K2 no time at its shapes: {k1}, {k2}, {dec}")
    return {"b": b, "k1_launches": k1, "k2_launches": k2, "decode_launches": dec, "max_abs_err": max(errs),
            "medians": [res["medians"] for res in ranks],
            "k1": k1_shapes_phase(f"world={WORLD} step", [(cfg, b, 512)], dev), "k2": k2_phase(cfg, coords, dev, b=b)}


def torchrun_phase() -> None:
    """31 (f). The fit CLI under ``torchrun --standalone --nproc_per_node=1`` (an NCCL world
    of 1) for 2 epochs on phase 7's data, and without it: the same metrics."""
    root = Path(__file__).resolve().parent
    over = train_overrides("training.num_epochs=2", "logging.checkpoint=false", "test.test_interval=2",
                           "test.test_dp_interval=1000", "test.test_equiv_at_epoch=1000")
    cmds = {"torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1"],
            "plain": [sys.executable]}
    procs = {}
    for name, prefix in cmds.items():
        log_dir = fresh_dir(OUT_DIR / f"cli_{name}")
        procs[name] = subprocess.Popen(
            [*prefix, "-m", "enf_pde_tpu_torch.experiments.fit", "navier_stokes",
             *(o for o in over if not o.startswith("logging.log_dir=")), f"logging.log_dir={log_dir}"],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    outs = {name: proc.communicate(timeout=600)[0] for name, proc in procs.items()}
    took = time.perf_counter() - t0
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"the fit CLI ({name}) exited {proc.returncode}:\n{outs[name][-3000:]}")
    metrics = {}
    for name in cmds:
        records = [json.loads(ln) for ln in (OUT_DIR / f"cli_{name}" / "metrics.jsonl").read_text().splitlines()]
        metrics[name] = [{k: v for k, v in r.items() if "mse" in k or k in ("epoch", "phase")}
                         for r in records if any("mse" in k for k in r)]
        shutil.rmtree(OUT_DIR / f"cli_{name}")
    log(f"[world] fit CLI for 2 epochs under torchrun (NCCL world of 1) and without, run side by side in "
        f"{took:.1f} s: {len(metrics['torchrun'])} metric records each, equal: "
        f"{metrics['torchrun'] == metrics['plain']}; torchrun's last: {metrics['torchrun'][-1]}")
    if metrics["torchrun"] != metrics["plain"] or not metrics["plain"]:
        raise AssertionError(f"torchrun's metrics {metrics['torchrun']} != {metrics['plain']}")


def multi_process_phase(dev) -> dict:
    """31. Multi-process on the card: (a) an NCCL world of 1, (b)-(e) a gloo world of 2 on the
    one card, (f) the fit CLI under torchrun."""
    cfg = load_experiment_config("navier_stokes", [f"dataset.path={DATA_DIR}"])
    traj = torch.as_tensor(next(iter(get_dataloader(cfg.dataset, device="cuda")[0]))[0], device=dev)
    frames = smooth_frames(NUM_SIGNALS, GRID, SEED + 42)
    world1_phase(dev, traj, frames)
    result = world_phase(dev, traj, frames)
    torchrun_phase()
    return result


def prefetcher_phase(dev) -> dict:
    """32. The native prefetcher: its g++ build, the batches it reads against ``np.load``'s,
    ms a batch both ways, and one epoch of ``run_experiment`` with the device cache off."""
    lib = native_loader.build_library()
    lib.unlink()  # time a build from the source, as a fresh checkout's first batch takes it
    _, build_s = sync_time(native_loader.build_library)
    log_dir = OUT_DIR / "prefetch_run"
    cfg = load_experiment_config("navier_stokes", train_overrides(
        "dataset.device_cache=false", "training.num_epochs=1", "test.test_interval=1000",
        "test.test_dp_interval=1000", "test.test_equiv_at_epoch=1000", "logging.checkpoint=false",
        log_dir=log_dir))
    train, _ = get_dataloader(cfg.dataset, device="cuda")
    cache = TrajectoryCache(str(DATA_DIR / "navier_stokes" / "train"), None)
    order = np.arange(TRAIN_SIGNALS).reshape(-1, NUM_SIGNALS)
    got = [train.batch_fetch(ids) for ids in order]  # the first builds the prefetcher
    want = [np.stack([np.load(cache.path(int(i)))["data"] for i in ids]) for ids in order]
    same = all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
    ms = {}
    for name, fn in (("prefetcher", lambda ids: train.batch_fetch(ids)),
                     ("np.load", lambda ids: np.stack([np.load(cache.path(int(i)))["data"] for i in ids]))):
        samples = []
        for _ in range(WARM_REPEATS):
            for ids in order:
                t0 = time.perf_counter()
                fn(ids)
                samples.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(samples)
    log(f"[prefetch] g++ build {build_s:.2f} s; {len(order)} batches of {NUM_SIGNALS} {tuple(got[0].shape[1:])} "
        f"through batch_fetch bit for bit np.load's: {same}; per batch (median of {WARM_REPEATS * len(order)}, "
        f"files in the page cache): prefetcher {ms['prefetcher']:.3f} ms, np.load of the npz {ms['np.load']:.3f} ms")
    if not same:
        raise AssertionError("the prefetcher's batches differ from np.load's")
    reads = []
    real = native_loader.NativePrefetcher.load_batch
    native_loader.NativePrefetcher.load_batch = lambda self, paths, shape: reads.append(len(paths)) or real(
        self, paths, shape)
    try:
        fresh_dir(log_dir)
        loop, _ = run_experiment(cfg, device="cuda")
    finally:
        native_loader.NativePrefetcher.load_batch = real
    record = json.loads((log_dir / "metrics.jsonl").read_text().splitlines()[0])
    shutil.rmtree(log_dir)
    log(f"[prefetch] run_experiment(1 epoch, dataset.device_cache=false): run record {record}; "
        f"{len(reads)} batches of {sorted(set(reads))} through the prefetcher: the probe batch and "
        f"{len(loop.train_loader)} training batches")
    if record.get("train_data_path") != "prefetcher" or len(reads) != 1 + len(loop.train_loader):
        raise AssertionError(f"the epoch did not read its batches through the prefetcher: {record}, {reads}")
    return {"build_s": build_s, "ms": ms}


def split_fft_phase(dev) -> dict:
    """33. The split-DFT Navier-Stokes path: 1,000 steps of a block of 16 fields on the card,
    split against ``torch.fft``, and µs a step both ways."""
    w0 = GaussianRF2D(GRID).sample_split(range(16), dev)
    f = default_forcing(GRID, dev)
    out, us = {}, {}
    for name, rollout in (("split", navier_stokes_rollout_split), ("torch.fft", navier_stokes_rollout)):
        rollout(w0, f, NS_VISC, NS_DT, 1, 10)  # warm
        (_, out[name]), secs = sync_time(lambda: rollout(w0, f, NS_VISC, NS_DT, 1, SPLIT_STEPS))
        us[name] = secs / SPLIT_STEPS * 1e6
    rel = rel_l2(out["split"], out["torch.fft"])
    log(f"[splitfft] {SPLIT_STEPS} steps of 16 x {GRID} x {GRID}: split against torch.fft rel_l2 {rel:.3e} "
        f"(tol {SPLIT_TOL:g}); {us['split']:.1f} µs a step split, {us['torch.fft']:.1f} µs with torch.fft")
    if not rel <= SPLIT_TOL or not torch.isfinite(out["split"]).all():
        raise AssertionError(f"the split rollout differs from the complex one: rel_l2 {rel:.3e}")
    return {"rel": rel, "us": us}


def flat_tensors(x, prefix=""):
    """(name, tensor) of nested dicts and sequences of tensors, None skipped."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from flat_tensors(v, f"{prefix}{k}.")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from flat_tensors(v, f"{prefix}{i}.")
    elif x is not None:
        yield prefix.rstrip("."), x


def bf16_gates(label: str, got, plain16, plain32, absolute: bool, groups=None) -> dict:
    """Phase 35's gates of ``got`` (a bf16 program's outputs or gradients) against the plain bf16
    version ``plain16`` and the plain f32 version ``plain32``, per gradient group: with gap =
    rel-L2(plain16, plain32), rel-L2(got, plain16) <= BF16_NEAR gap and rel-L2(got, plain32) / gap
    in [BF16_LO, BF16_HI]; with ``absolute``, rel-L2(got, plain32) <= BF16_ABS. A group is a tensor
    (nested as ``grad_errors`` takes them), or the concatenation of the tensors whose names
    ``groups(name)`` maps to one group (K2's weight gradients, a step's optimizer groups); each
    tensor's own numbers are printed beside, with no gate. A group that no bf16 rounding reaches
    (gap 0: the head's bias) is held to the plain version at REL_L2_TOL. One line; the worst of
    each number and the max abs error against plain16."""
    worst = {"near": 0.0, "ratio_lo": math.inf, "ratio_hi": 0.0, "d32": 0.0, "max_abs_err": 0.0, "n": 0}
    bad, cat, per = [], {}, []
    for (name, g), (_, w16), (_, w32) in zip(flat_tensors(got), flat_tensors(plain16), flat_tensors(plain32),
                                             strict=True):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label} {name}: non-finite values")
        worst["max_abs_err"] = max(worst["max_abs_err"], float((g - w16).abs().max()))
        gap = rel_l2(w16, w32) if w32.any() else 0.0
        if gap > 0:
            per.append(f"{name} {rel_l2(g, w16) / gap:.2f}")
        key = groups(name) if groups else name
        parts = cat.setdefault(key, ([], [], []))
        for lst, t in zip(parts, (g, w16, w32)):
            lst.append(t.detach().reshape(-1).float())
    for name, parts in cat.items():
        g, w16, w32 = (torch.cat(lst) for lst in parts)
        gap, near, d32 = rel_l2(w16, w32) if w32.any() else 0.0, rel_l2(g, w16) if w16.any() else 0.0, 0.0
        worst["n"] += 1
        if gap == 0:
            if not near <= REL_L2_TOL:
                bad.append(f"{name} rel_l2 {near:.3e} where plain16 = plain32")
            continue
        d32 = rel_l2(g, w32)
        ratio = d32 / gap
        worst.update(near=max(worst["near"], near / gap), ratio_lo=min(worst["ratio_lo"], ratio),
                     ratio_hi=max(worst["ratio_hi"], ratio), d32=max(worst["d32"], d32))
        if absolute and gap > BF16_ABS:
            log(f"[bf16] {label} {name}: the bf16 function itself lies {gap:.3e} from f32, past {BF16_ABS:g}: "
                "held by the ratio gates")
        if not (near <= BF16_NEAR * gap and BF16_LO <= ratio <= BF16_HI
                and (not absolute or d32 <= BF16_ABS or gap > BF16_ABS)):
            bad.append(f"{name} gap {gap:.3e}, rel_l2 to plain16 {near:.3e} ({near / gap:.3f} gap), to plain32 "
                       f"{d32:.3e} ({ratio:.3f} gap)")
    log(f"[bf16] {label}: {worst['n']} groups; worst rel_l2 to plain16 {worst['near']:.3f} gap (gate {BF16_NEAR}), "
        f"rel_l2 to plain32 {worst['ratio_lo']:.3f} .. {worst['ratio_hi']:.3f} gap (gate [{BF16_LO}, {BF16_HI}]), "
        f"at most {worst['d32']:.3e}{f' (gate {BF16_ABS:g})' if absolute else ''}; max_abs_err {worst['max_abs_err']:.3e}"
        + (f"; each tensor's rel_l2 to plain16 in gaps (no gate): {', '.join(per)}" if groups else ""))
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    return worst


# The f32 instructions of K1 bf16's elementwise work, counted from its code (`features64`, `fast_sincos`, `gelu_sig`,
# `quad_norm`, the softmax): an RFF projection I fmas and fast_sincos's 25 operations (sin and cos both); gelu 18 (the
# cubic, the exponential, the quotient); a LayerNorm 4 an element (two sums, subtract, scale); the softmax 20 a
# weight (max, exponential, sum, divide, round). One issues per CUDA core per clock: PEAK_F32_FLOPS / 2 a second.
K1_OPS_PROJECTION, K1_OPS_GELU, K1_OPS_LN, K1_OPS_SOFTMAX = 25, 18, 4, 20


def k1_elementwise_ms(args, num_heads: int, head_dim: int) -> float:
    """The least time of K1 bf16's elementwise work on the CUDA cores (its CUDA-core bound, beside the products'
    bound): per point and latent the features of both chains (hid / 2 projections each), gelu and the LayerNorm of
    fw's (hid) and G's (H hidm) outputs, the softmax's H weights; per point the tail's gelu (p_w1, p_w2: H D; h_w1,
    h_w2: hid) and p_w1's LayerNorm (H D)."""
    inv, ws, tws = args[0], args[6], args[7]
    B, Z, C, I = inv.shape
    hid, hidm, H, HD = ws[1].shape[0], ws[8].shape[0], num_heads, num_heads * head_dim
    chain = hid + H * hidm
    per_latent = hid * (I + K1_OPS_PROJECTION) + (K1_OPS_GELU + K1_OPS_LN) * chain + K1_OPS_SOFTMAX * H
    tail = K1_OPS_GELU * (2 * HD + 2 * hid) + K1_OPS_LN * HD if tws else 0
    return B * C * (Z * per_latent + tail) / (PEAK_F32_FLOPS / 2) * 1e3


def bf16_bound(flops: int, moved: int) -> dict:
    """The least time of a bf16 program's work: its products at the bf16 tensor-core rate, or bytes."""
    b_bytes, b_tc = moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return dict(bound_ms=max(b_bytes, b_tc), bound_by="bytes" if b_bytes >= b_tc else "operations")


def k1_bf16_check(cfg, args, label: str, witness: bool = False) -> dict:
    """K1's bf16 program against the plain bf16 version at ``args`` (with and without the tail,
    phase 35's gates; with ``witness``, ``witness_gates`` against the exact bf16 function beside
    the plain bf16 version), then timed beside the f32 program and the plain bf16 version, each program
    with its shared weights laid out once (as the forecast decode lays them out). Two launches give the
    same bits. Its shared memory (``k1_smem_bytes``) is held equal to the built library's ``layout``, its
    plan (tile and grid: ``k1_library_plan``) to ``k1_plan``; its design, whether every latent's logits
    lie there or in global memory (``k1_logits_floats``), its blocks an SM and its L2 weight bytes a point
    are printed."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    B, Z, C, I = args[0].shape
    hid, hidm = args[6][1].shape[0], args[6][8].shape[0]
    smem = k1_smem_bytes(Z, I, hid, H, D, hidm, BF16)
    lib_smem = k1_library_smem_bytes([B, Z, C, I, hid, H, D, hidm, cfg.nef.num_out, 1], BF16)
    if lib_smem != smem:
        raise AssertionError(f"K1 bf16 {label}: k1_smem_bytes {smem} != the library's layout {lib_smem}")
    n_lg = k1_logits_floats(B, Z, C, I, hid, H, D, hidm, BF16, torch.cuda.get_device_properties(0).multi_processor_count)
    errs = []
    with torch.no_grad():
        for tail in (True, False):
            kargs = args if tail else (*args[:7], ())
            got = fused_decode_fwd(*kargs, num_heads=H, head_dim=D, compute_dtype=BF16)
            tag = f"K1 {label} {'tail' if tail else 'no-tail'}"
            if not torch.equal(got, fused_decode_fwd(*kargs, num_heads=H, head_dim=D, compute_dtype=BF16)):
                raise AssertionError(f"{tag}: two launches on the same inputs differ")
            if witness:
                sides = {"kernel": got, **plain_sides(kargs, H, D, cpu=False)}
                witness_gates(tag, [sides], lambda name: "out")
                errs.append({"max_abs_err": float((got - sides["plain16"]).abs().max())})
                del sides
                continue
            p16 = fused_decode_plain(*kargs, num_heads=H, head_dim=D, compute_dtype=BF16)
            p32 = fused_decode_plain(*kargs, num_heads=H, head_dim=D)
            errs.append(bf16_gates(tag, got, p16, p32, absolute=True))
        w16, w32 = k1_operands(args[4], args[6], args[7], H, BF16), shared_weights(args[6])  # once, as a decode
        ms16 = cuda_ms(lambda: fused_decode_fwd(*args, num_heads=H, head_dim=D, split=w16, compute_dtype=BF16), iters=10)
        ms32 = cuda_ms(lambda: fused_decode_fwd(*args, num_heads=H, head_dim=D, split=w32), iters=10)
        p_ms = cuda_ms(lambda: fused_decode_plain(*args, num_heads=H, head_dim=D, compute_dtype=BF16), iters=3, warmup=1)
        bd = k1_bounds(cfg, args, got)
    bound = bf16_bound(bd["flops"], bd["moved"])
    plan = k1_library_plan([B, Z, C, I, hid, H, D, hidm, cfg.nef.num_out, 1], KERNEL_SOURCE_BF16)
    mirror = k1_plan(B, Z, C, I, hid, H, D, hidm, BF16, torch.cuda.get_device_properties(0).multi_processor_count)
    if (plan["tile"], plan["grid"]) != (mirror[0], mirror[2]):
        raise AssertionError(f"K1 bf16 {label}: the library plans tile {plan['tile']}, grid {plan['grid']}; k1_plan {mirror}")
    l2 = k1_bf16_l2_bytes_per_point(args, plan["tile"], plan["cls"])
    core_ms = k1_elementwise_ms(args, H, D)
    design = ("the narrow design (a latent a warpgroup)" if plan["cls"] < 128 else
              "the class-128 design" + (" (WIDE128)" if max(hidm, D) > 128 else ""))
    log(f"[timing] K1 bf16 {label}: {ms16:.4f} ms (f32 program {ms32:.4f} ms); plain bf16 {p_ms:.4f} ms; bound "
        f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (bf16 tensor cores {bd['flops'] / PEAK_BF16_FLOPS * 1e3:.4f} "
        f"ms, bytes {bd['bytes_ms']:.4f} ms; the f32 program's 3xTF32 bound {bd['bound_ms']:.4f} ms); "
        f"{ms16 / bound['bound_ms']:.1f}x its bound; the elementwise work's CUDA-core bound {core_ms:.4f} ms "
        f"({ms16 / core_ms:.1f}x); shared memory {smem} B (the library's layout agrees), the "
        f"logits in {f'global memory ({4 * n_lg / 1e6:.1f} MB)' if n_lg else 'shared memory'}; {design}, width "
        f"class {plan['cls']}, tile {plan['tile']}, {plan['per_sm']} blocks an SM, grid {plan['grid']}, L2 weight "
        f"bytes per point {l2 / 1e3:.1f} KB; two launches bit for bit")
    return dict(ms=ms16, f32_ms=ms32, plain_ms=p_ms, max_abs_err=max(e["max_abs_err"] for e in errs), cuda_core_ms=core_ms,
                **bound)


def k2_bf16_check(cfg, args, g, wgs, label: str) -> dict:
    """K2's bf16 program against the plain bf16 version (tail mode, ``wgs`` weight-gradient modes;
    phase 35's gates per gradient tensor) with the cotangent 0 where an RFF ReLU lies within
    BF16_TIE_MARGIN of its kink (the number of such points and the whole cotangent's numbers
    printed beside); two launches bit for bit, and dinv ... dc the same bits with and without weight
    gradients; timed beside the f32 program and the plain bf16 version, with the launch's plan (its
    design, shared memory, blocks an SM, grid, items a block, scratch bytes: ``k2_layout``)."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    keep = ~relu_ties(args, BF16_TIE_MARGIN)
    gk = g * keep[..., None]
    out, first6 = {}, {}
    for wg in wgs:
        mode = f"{label} {'with' if wg else 'without'} weight grads"
        whole = [fn(*args, g, H, D, wg, compute_dtype=dt) for fn, dt in
                 ((fused_decode_bwd, BF16), (fused_decode_bwd_plain, BF16), (fused_decode_bwd_plain, torch.float32))]
        near, ratio = [], []
        for (_, a), (_, b), (_, c) in zip(*(flat_tensors(w) for w in whole)):
            gap = rel_l2(b, c) if c.any() else 0.0
            if gap > 0:
                near.append(rel_l2(a, b) / gap)
                ratio.append(rel_l2(a, c) / gap)
        log(f"[bf16] K2 {mode}, the whole cotangent (no gate): worst rel_l2 to plain16 {max(near):.3f} gap, to plain32 "
            f"{min(ratio):.3f} .. {max(ratio):.3f} gap; {int((~keep).sum())} of {keep.numel()} points lie within "
            f"{BF16_TIE_MARGIN:g} of a ReLU's kink")
        del whole
        got = fused_decode_bwd(*args, gk, H, D, wg, compute_dtype=BF16)
        again = fused_decode_bwd(*args, gk, H, D, wg, compute_dtype=BF16)
        if not all(torch.equal(x, y) for (_, x), (_, y) in zip(flat_tensors(got), flat_tensors(again))):
            raise AssertionError(f"K2 bf16 {mode}: two launches on the same inputs differ")
        worst = bf16_gates(f"K2 {mode}, cotangent 0 at those points", got,
                           fused_decode_bwd_plain(*args, gk, H, D, wg, compute_dtype=BF16),
                           fused_decode_bwd_plain(*args, gk, H, D, wg), absolute=False, groups=K2_GROUPS)
        first6[wg] = got[:6]
        del got, again
        ms16 = cuda_ms(lambda: fused_decode_bwd(*args, g, H, D, wg, compute_dtype=BF16), iters=5)
        ms32 = cuda_ms(lambda: fused_decode_bwd(*args, g, H, D, wg), iters=5)
        p_ms = cuda_ms(lambda: fused_decode_bwd_plain(*args, g, H, D, wg, compute_dtype=BF16), iters=2, warmup=1)
        bd = k2_bounds(cfg, args, g, wg)
        bound = bf16_bound(bd["flops"], bd["moved"])
        lay = k2_layout(args, H, D, cfg.nef.num_out, wg, BF16)
        log(f"[timing] K2 bf16 {mode}: {ms16:.4f} ms (f32 program {ms32:.4f} ms); plain bf16 {p_ms:.4f} ms; bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (the f32 program's 3xTF32 bound {bd['bound_ms']:.4f} "
            f"ms); {ms16 / bound['bound_ms']:.1f}x its bound; {lay['design']}, "
            f"{lay['smem']} B shared, {lay['per_sm']} blocks an SM, grid {lay['grid']}, {lay['ipb']} items a block, "
            f"scratch {lay['scratch'] / 1e6:.1f} MB")
        out[wg] = dict(ms=ms16, f32_ms=ms32, plain_ms=p_ms, max_abs_err=worst["max_abs_err"], design=lay["design"], **bound)
        torch.cuda.empty_cache()
    # dinv ... dc the same bits with and without weight gradients (the order of every sum does not depend on them):
    # the gated launches' outputs, and a launch in the mode ``wgs`` leaves out.
    without, with_w = (first6[wg] if wg in first6 else fused_decode_bwd(*args, gk, H, D, wg, compute_dtype=BF16)[:6]
                       for wg in (False, True))
    if not all(torch.equal(x, y) for x, y in zip(without, with_w)):
        raise AssertionError(f"K2 bf16 {label}: dinv ... dc differ with and without weight gradients")
    log(f"[bf16] K2 {label}: two launches bit for bit; dinv ... dc the same bits with and without weight gradients")
    return out


def K2_GROUPS(name: str) -> str:
    """K2's gradient groups: dinv, dwb, dA, dab, dG, dc (the first six outputs), and the weights."""
    first = name.split(".")[0]
    return ("dinv", "dwb", "dA", "dab", "dG", "dc")[int(first)] if int(first) < 6 else "weights"


class PlainDecode(torch.nn.Module):
    """``decoder`` whose kernel backends decode through the plain composition at ``dtype`` (autograd to
    any order): the reference of a step on the kernels. ``device`` and ``sums`` move the composition's
    inputs to that device and float type (the CPU; float64: the same bf16 roundings with exact sums)
    and its output back."""

    def __init__(self, decoder, dtype, device=None, sums=torch.float32):
        super().__init__()
        self.decoder, self.dtype, self.device, self.sums = decoder, dtype, device, sums

    def forward(self, x, p, a, w, backend="eager"):
        d = self.decoder
        if backend == "eager":
            return d(x, p, a, w)
        move = lambda t: t.to(device=self.device or t.device, dtype=self.sums)  # noqa: E731
        inv, wb, A, ab, G, c, ws, tws = d.kernel_inputs(x, p, a, w)
        args = (*(move(t) for t in (inv, wb, A, ab, G, c)), [move(t) for t in ws], [move(t) for t in tws])
        out = fused_decode_plain(*args, d.num_heads, d.num_hidden, self.dtype)
        return out.to(device=x.device, dtype=torch.float32)


def witness_gates(label: str, draws: list, groups, ungated=()) -> dict:
    """The gates of a bf16 program's results against right evaluations of the same bf16 function
    (WITNESS_FACTOR's comment). ``draws``: per draw, {side: nested tensors} with the sides
    ``kernel``, ``x16``, ``plain32`` and the witnesses (every other key); ``groups(name)`` maps a
    tensor's name (``flat_tensors``) to its group. Prints each draw's and group's distances, in
    gaps, to x16, to plain32 and to plain16 where there is one; raises past the gates, which hold
    every group but those in ``ungated`` (printed with their verdict). Returns the readings by
    (draw, group, side): (to x16, to plain32) in gaps."""
    rows, bad = {}, []
    witnesses = [k for k in draws[0] if k not in ("kernel", "x16", "plain32")]
    names = sorted({groups(n) for n, _ in flat_tensors(draws[0]["kernel"])}, key=str)
    for d, sides in enumerate(draws):
        flat = {}
        for tag, val in sides.items():
            parts = {}
            for n, t in flat_tensors(val):
                parts.setdefault(groups(n), []).append(t.detach().reshape(-1).double().cpu())
            flat[tag] = {g: torch.cat(v) for g, v in parts.items()}
        for g in names:
            gap = rel_l2(flat["x16"][g], flat["plain32"][g])
            if gap == 0:  # no bf16 rounding reaches it: held as the f32 programs are
                near = rel_l2(flat["kernel"][g], flat["x16"][g]) if flat["x16"][g].any() else 0.0
                if not near <= REL_L2_TOL:
                    bad.append(f"draw {d} {g}: rel_l2 {near:.3e} where x16 = plain32")
                continue
            for tag in ["kernel", *witnesses]:
                rows[(d, g, tag)] = (rel_l2(flat[tag][g], flat["x16"][g]) / gap,
                                     rel_l2(flat[tag][g], flat["plain32"][g]) / gap)
            to16 = {tag: rel_l2(flat[tag][g], flat["plain16"][g]) / rel_l2(flat["plain16"][g], flat["plain32"][g])
                    for tag in ["kernel", *witnesses] if "plain16" in flat and tag != "plain16"}
            log(f"[witness] {label} draw {d} {g}: gap {gap:.3e}; to x16 / to plain32 in gaps: "
                + "; ".join(f"{t} {rows[(d, g, t)][0]:.3f} / {rows[(d, g, t)][1]:.3f}" for t in ["kernel", *witnesses])
                + (("; to plain16 in its gap: " + ", ".join(f"{t} {v:.3f}" for t, v in to16.items())) if to16 else ""))
    for g in names:
        keys = [(d, g) for d in range(len(draws)) if (d, g, "kernel") in rows]
        if not keys:
            continue
        w_near = max(rows[(*k, t)][0] for k in keys for t in witnesses)
        w_dev = max(abs(rows[(*k, t)][1] - 1) for k in keys for t in witnesses)
        k_near = max(rows[(*k, "kernel")][0] for k in keys)
        k_dev = max(abs(rows[(*k, "kernel")][1] - 1) for k in keys)
        near_gate, dev_gate = max(BF16_NEAR, WITNESS_FACTOR * w_near), max(BF16_HI - 1, WITNESS_FACTOR * w_dev)
        held = k_near <= near_gate and k_dev <= dev_gate
        log(f"[witness] {label} {g} over {len(keys)} draws: the kernels {k_near:.3f} of the gap from x16 (gate "
            f"{near_gate:.3f}; the witnesses' farthest {w_near:.3f}), their ratio to plain32 within {k_dev:.3f} of 1 "
            f"(gate {dev_gate:.3f}; the witnesses' {w_dev:.3f})"
            + (f"; no gate here: {'within' if held else 'past'} it" if g in ungated else ""))
        if g not in ungated and not held:
            bad.append(f"{g}: {k_near:.3f} of the gap from x16 (gate {near_gate:.3f}), ratio off 1 by {k_dev:.3f} "
                       f"(gate {dev_gate:.3f})")
    if bad:
        raise AssertionError(f"{label}: past the right bf16 evaluations' spread: " + "; ".join(bad))
    return rows


def plain_sides(args, H: int, D: int, fn=fused_decode_plain, g=None, wg: bool = False, cpu: bool = True) -> dict:
    """``fn`` (the plain forward, or the plain VJP of cotangent ``g`` with weight gradients ``wg``)
    at ``args``: the witnesses ``plain16`` (and, with ``cpu``, ``cpu16``: on the CPU), the exact bf16
    function ``x16`` (float64 sums) and ``plain32``, each on the card and in f32."""
    pre, post = ((g,), (wg,)) if g is not None else ((), ())

    def moved(device=None, dtype=torch.float32):
        mv = lambda t: t.to(device=device or t.device, dtype=dtype)  # noqa: E731
        return (*(mv(t) for t in args[:6]), [mv(t) for t in args[6]], [mv(t) for t in args[7]], *(mv(t) for t in pre))

    def back(x):
        if isinstance(x, (tuple, list)):
            return type(x)(back(v) for v in x)
        return None if x is None else x.to(device=args[0].device, dtype=torch.float32)
    out = {"plain16": fn(*args, *pre, H, D, *post, compute_dtype=BF16)}
    if cpu:
        out["cpu16"] = back(fn(*moved("cpu"), H, D, *post, compute_dtype=BF16))
    out["x16"] = back(fn(*moved(None, torch.float64), H, D, *post, compute_dtype=BF16))
    out["plain32"] = fn(*args, *pre, H, D, *post)
    return out


def nef_witness(cfg, coords: np.ndarray, traj: torch.Tensor) -> dict:
    """Phase 35's nef step with ``nef.backend=pallas``, second order through K1 and K2 in bf16, on
    NEF_WITNESS_SEEDS draws (trainer seed and the step's frames and points). Each side's step: the
    kernels, the witnesses (the plain bf16 composition on the card, ``plain16``, and on the CPU,
    ``cpu16``), the exact bf16 function ``x16`` and ``plain32``. Phase 35's gates against plain16
    are printed with their verdict for every draw; every gradient group (the decoder's, the inits',
    the learning rates') is held by ``witness_gates``. The loss, a scalar whose bf16 gap is 2-8e-4
    of it, is printed beside them and held within BF16_ABS of plain32 (PERF.md §6, §7: the kernels'
    loss lies farther from x16 than the witnesses' on an H100). First, K1 and K2 at the step's
    decode shape, held the same way with the same witnesses: at first order the kernels lie as far
    from x16 as the witnesses do. Returns the readings."""
    label = "nef step (nef.backend=pallas, second order through K1 and K2 in bf16)"
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    K, M, N = cfg.meta.num_inner_steps, cfg.training.max_num_sampled_points, coords.shape[0]
    b_nef = cfg.dataset.batch_size * cfg.training.nef.fit_on_num_steps
    first, second = [], []
    for s in range(NEF_WITNESS_SEEDS):
        args = decode_inputs(cfg, coords, traj.device, b_nef, M, SEED + 90 + s)
        g = torch.randn(b_nef, M, cfg.nef.num_out, generator=torch.Generator().manual_seed(SEED + 95 + s)).to(traj.device)
        with torch.no_grad():
            fwd = {"kernel": fused_decode_fwd(*args, H, D, compute_dtype=BF16), **plain_sides(args, H, D)}
        bwd = {"kernel": fused_decode_bwd(*args, g, H, D, True, compute_dtype=BF16),
               **plain_sides(args, H, D, fused_decode_bwd_plain, g, True)}
        first.append((fwd, bwd))
    witness_gates(f"K1 at the nef step's {b_nef} x {M}", [f for f, _ in first], lambda name: "out")
    witness_gates(f"K2 at the nef step's {b_nef} x {M}, with weight grads", [b for _, b in first], K2_GROUPS)
    del first
    sides = {"kernel": None, "plain16": dict(dtype=BF16), "cpu16": dict(dtype=BF16, device="cpu"),
             "x16": dict(dtype=BF16, sums=torch.float64), "plain32": dict(dtype=torch.float32)}
    plain16_fail = []
    for s in range(NEF_WITNESS_SEEDS):
        trainer = make_trainer(cfg, coords, seed=SEED + s)
        state = trainer.init_state()
        gen = torch.Generator().manual_seed(SEED + 60 + s)
        masks = torch.stack([torch.randperm(N, generator=gen)[:M] for _ in range(K + 1)])
        frame_idx = torch.randperm(cfg.dataset.traj_len_train, generator=gen)[:cfg.training.nef.fit_on_num_steps]
        decoder, steps = trainer.decoder, {}
        for tag, kw in sides.items():
            trainer.decoder = decoder if kw is None else PlainDecode(decoder, **kw)
            t0 = time.perf_counter()
            with on_path() if kw is None else contextlib.nullcontext():
                steps[tag] = trainer.nef_grads(state, traj, frame_idx=frame_idx, masks=masks)
                torch.cuda.synchronize()
            if s == 0:
                log(f"[bf16] {label}: the {tag} step in {time.perf_counter() - t0:.2f} s")
        trainer.decoder = decoder
        try:
            bf16_gates(f"{label} draw {s} (phase 35's gates against plain16, printed)", *(
                steps[t] for t in ("kernel", "plain16", "plain32")), absolute=False,
                groups=lambda name: "loss" if name == "0" else name.split(".")[1])
        except AssertionError as e:
            plain16_fail.append(s)
            log(f"[bf16] {label} draw {s}: past phase 35's gates against plain16 (held by the witnesses): {e}")
        second.append(steps)
        del trainer, state
        torch.cuda.empty_cache()
    log(f"[witness] {label}: phase 35's gates against plain16 failed on draws {plain16_fail or 'none'} of "
        f"{NEF_WITNESS_SEEDS}")
    rows = witness_gates(label, second, lambda name: "loss" if name == "0" else name.split(".")[1], ungated=("loss",))
    for d, steps in enumerate(second):
        loss, ref = float(steps["kernel"][0]), float(steps["plain32"][0])
        if not (math.isfinite(loss) and abs(loss / ref - 1) <= BF16_ABS):
            raise AssertionError(f"{label} draw {d}: the loss {loss:.6e} is not finite or lies past {BF16_ABS:g} of "
                                 f"plain32's {ref:.6e}")
    return {"rows": rows, "plain16_fail": plain16_fail}


# Phase 35's launch shapes: (config, overrides, b, c, label) of K1 on the paths the script drives,
# and (config, overrides, b, c, weight-gradient modes, label) of K2.
SA_OVER = (f"nef.num_layers={SA_LAYERS}", "nef.backend=pallas")
BF16_K1_SHAPES = (
    ("navier_stokes", (), NUM_SIGNALS * NUM_FRAMES, 512, "forecast and validation"),
    ("navier_stokes", (), NUM_SIGNALS * 10, 512, "ode and dual steps"),
    ("navier_stokes", (), NUM_SIGNALS * LONG_HORIZON, 512, f"rollout T={LONG_HORIZON}"),
    ("navier_stokes", (), NUM_SIGNALS // WORLD * 10, 512, f"world={WORLD} rank's steps"),
    ("navier_stokes", SA_OVER, 16, 512, "nef step"),
    ("navier_stokes", SA_OVER, NUM_SIGNALS, 512, "fit"),
    ("navier_stokes_nonmaml", (), NUM_SIGNALS * NUM_FRAMES, 2048, "validation"),
    ("navier_stokes", ("nef.invariant_type=abs_pos",), NUM_SIGNALS * NUM_FRAMES, 512, "validation"),
    ("navier_stokes", ("nef.invariant_type=abs_pos",), NUM_SIGNALS * 10, 512, "ode and dual steps"),
    ("diffusion_plane", (), NUM_SIGNALS * NUM_FRAMES, 1024, "forecast and validation"),
    ("cahn_hilliard", (), NUM_SIGNALS * NUM_FRAMES, 2048, "forecast and validation"),
    ("diff_sphere", (), NUM_SIGNALS * NUM_FRAMES, 2048, "forecast"),
    ("diff_sphere", (), 40, 2048, "validation"),
    ("shallow_water", (), NUM_SIGNALS * NUM_FRAMES, 2048, "forecast"),
    ("shallow_water", (), 14, 2048, "validation"),
    ("shallow_water", (), 10, 2048, "ode and dual steps"),
    ("ihc", (), NUM_SIGNALS * NUM_FRAMES, 2048, "forecast"),
    ("ihc", (), 14, 2048, "validation"),
)
BF16_K2_SHAPES = (
    ("navier_stokes", (), NUM_SIGNALS * 10, 512, (False, True), "ode / dual step"),
    ("navier_stokes", (), NUM_SIGNALS * LONG_HORIZON, 512, (False, True), f"rollout T={LONG_HORIZON} ode / dual step"),
    ("navier_stokes", (), NUM_SIGNALS // WORLD * 10, 512, (False, True), f"world={WORLD} rank's ode / dual step"),
    ("navier_stokes", SA_OVER, 16, 512, (True,), "nef step"),
    ("navier_stokes", SA_OVER, NUM_SIGNALS, 512, (True, False), "fit"),
    ("navier_stokes", ("nef.invariant_type=abs_pos",), NUM_SIGNALS * 10, 512, (False, True), "ode / dual step"),
    # One head at NS width: the class design at width class 64 (no YAML sets it; the W128 design takes two heads).
    ("navier_stokes", ("nef.num_heads=1",), NUM_SIGNALS * 10, 512, (False, True), "ode / dual step's shape"),
    ("shallow_water", (), 10, 2048, (False, True), "ode / dual step"),
    ("diffusion_plane", ("nef.backend=pallas",), 32, 1024, (True, False), "nef step"),
    ("diffusion_plane", ("nef.backend=pallas",), 8, 1024, (True, False), "fit"),
    ("cahn_hilliard", ("nef.backend=pallas",), 24, 2048, (True, False), "nef step"),
    ("cahn_hilliard", ("nef.backend=pallas",), 8, 2048, (True, False), "fit"),
    ("diff_sphere", ("nef.backend=pallas",), 8, 2048, (True, False), "nef step"),
    ("diff_sphere", ("nef.backend=pallas",), 2, 2048, (True, False), "fit"),
    ("ihc", ("nef.backend=pallas",), 2, 2048, (True, False), "nef step"),
    ("ihc", ("nef.backend=pallas",), 1, 2048, (True, False), "fit"),
)


# K1's bf16 program past the latents whose logits fit shared memory (z = 52 at NS width): the logits
# in global memory, at every width class the configs take; held by `witness_gates` (two right bf16
# evaluations lie 0.36 of the gap apart at NS width with 64 latents, PERF.md §6) and timed.
BF16_K1_MANY_LATENTS = (
    ("navier_stokes", ("nef.num_latents=64",), NUM_SIGNALS, 1000),
    ("diffusion_plane", ("nef.num_latents=600",), NUM_SIGNALS, 1000),
    ("diff_sphere", ("nef.num_latents=1000",), NUM_SIGNALS, 1000),
)


def k1_wide_inputs(dev, b: int, c: int, seed: int):
    """(cfg, args) of K1 at hid 128, one head, hidm = D = 256: the NS decoder's inputs at two heads with
    their G and c read as one head of 256 columns, A and ab cut to one head, m_w2 [256, 256] and m_b2
    drawn anew (seeded; m_w2 at the NS weight's scale over twice the rows). No shipped decoder has this
    shape (each has hidm = D = hid); the bf16 K1's class 128 takes it in its wide instantiation. ``cfg``
    holds what the checks read of it (nef.num_heads, num_hidden, num_out)."""
    cfg = shape_config("navier_stokes")
    inv, wb, A, ab, G, c_, ws, tws = decode_inputs(cfg, config_coords(cfg), dev, b, c, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    m_w2, m_b2 = ws[8], ws[9]
    ws = list(ws)
    ws[8] = (torch.randn(256, 256, generator=gen) * float(m_w2.std()) * math.sqrt(0.5)).to(dev)
    ws[9] = (torch.randn(256, generator=gen) * float(m_b2.std())).to(dev)
    wide = types.SimpleNamespace(nef=types.SimpleNamespace(num_heads=1, num_hidden=256, num_out=cfg.nef.num_out))
    return wide, (inv, wb, A[..., :1].contiguous(), ab[..., :1].contiguous(), G, c_, ws, tws)


def bf16_phase(dev) -> dict:
    """35. The bf16 programs of K1 and K2 (the YAMLs' ``pallas`` on the card, JAX's
    ``compute_dtype=bfloat16``): each held against the plain bf16 version with phase 35's gates
    (``bf16_gates``) at every launch shape the script's paths give it (BF16_K1_SHAPES,
    BF16_K2_SHAPES, which also holds K2's class design at width class 64; K1's wide instantiation,
    ``k1_wide_inputs``), timed beside the f32 program and the plain bf16 version with the bf16 bound;
    K1's bf16 program past the latents whose logits fit shared memory (BF16_K1_MANY_LATENTS);
    the Navier-Stokes ode, dual and validation steps and the 8 x 20 forecast in both modes (the
    forecast's rel-L2 between them); the nef step with ``nef.backend=pallas`` in bf16 beside the
    exact bf16 function and its witnesses (``nef_witness``). Returns the timings by (kernel,
    config, overrides, b, c[, weight grads]), the medians, the forecasts' distance and the
    witnesses' readings."""
    t0 = time.perf_counter()
    res = {}
    for i, (name, over, b, c, label) in enumerate(BF16_K1_SHAPES):
        cfg = shape_config(name, *over)
        args = decode_inputs(cfg, config_coords(cfg), dev, b, c, SEED + 50 + i)
        res[("K1", name, over, b, c)] = k1_bf16_check(cfg, args, f"{name} {' '.join(over)} {label} b={b} c={c}")
        del args
        torch.cuda.empty_cache()
    for i, (name, over, b, c) in enumerate(BF16_K1_MANY_LATENTS):
        cfg = shape_config(name, *over)
        args = decode_inputs(cfg, config_coords(cfg), dev, b, c, SEED + 70 + i)
        k1_bf16_check(cfg, args, f"{name} {' '.join(over)} (many latents) b={b} c={c}", witness=True)
        del args
        torch.cuda.empty_cache()
    wcfg, args = k1_wide_inputs(dev, NUM_SIGNALS * 10, 512, SEED + 75)
    k1_wide = k1_bf16_check(wcfg, args, f"navier_stokes widths, one head, hidm = D = 256 (the class 128's wide "
                                         f"instantiation; no decoder reaches it) b={NUM_SIGNALS * 10} c=512")
    del args
    torch.cuda.empty_cache()
    for i, (name, over, b, c, wgs, label) in enumerate(BF16_K2_SHAPES):
        cfg = shape_config(name, *over)
        coords = config_coords(cfg)
        args = decode_inputs(cfg, coords, dev, b, c, SEED + 80 + i)
        gen = torch.Generator().manual_seed(SEED + 81 + i)
        g = torch.randn(b, c, cfg.nef.num_out, generator=gen).to(dev)
        for wg, r in k2_bf16_check(cfg, args, g, wgs, f"{name} {' '.join(over)} {label} b={b} c={c}").items():
            res[("K2", name, over, b, c, wg)] = r
        del args, g
        torch.cuda.empty_cache()
    log(f"[phase 35] K1 at {len(BF16_K1_SHAPES)} and K2 at {len(BF16_K2_SHAPES)} launch shapes in "
        f"{time.perf_counter() - t0:.2f} s")

    # The Navier-Stokes steps and forecast in both modes.
    cfg = load_experiment_config("navier_stokes")
    coords = planar_coords(GRID, GRID)
    traj = torch.from_numpy(smooth_trajectories(NUM_SIGNALS, TRAIN_FRAMES, GRID, SEED + 3)).to(dev)
    frames = smooth_frames(NUM_SIGNALS, GRID, SEED)
    fields, medians = {}, {}
    for backend in ("kernel", F32_KERNELS):
        trainer = make_trainer(cfg, coords)
        trainer.ode_backend = trainer.eval_backend = backend
        state = trainer.init_state()
        with on_path():
            for fn in (trainer.ode_train_step, trainer.dual_train_step, trainer.val_step):
                fn(state, traj)
            torch.cuda.synchronize()
        medians[backend] = {}
        for step, fn in (("ode", trainer.ode_train_step), ("dual", trainer.dual_train_step), ("val", trainer.val_step)):
            medians[backend][step] = statistics.median(sync_time(lambda: fn(state, traj))[1] * 1e3
                                                       for _ in range(WARM_REPEATS))
        fc = Forecaster(cfg, coords, device="cuda", backend="pallas" if backend == "kernel" else "pallas_interpret")
        with on_path():
            fields[backend] = fc.forecast(frames, num_frames=NUM_FRAMES)
        medians[backend]["forecast"] = statistics.median(
            sync_time(lambda: fc.forecast(frames, num_frames=NUM_FRAMES))[1] * 1e3 for _ in range(WARM_REPEATS))
        del trainer, state, fc
    fc_rel = rel_l2(fields["kernel"], fields[F32_KERNELS])
    log(f"[bf16] navier_stokes in bf16 (pallas) against f32 (pallas_interpret), warm medians of {WARM_REPEATS}: "
        + "; ".join(f"{k} {medians['kernel'][k]:.2f} / {medians[F32_KERNELS][k]:.2f} ms" for k in medians["kernel"])
        + f"; the 8 x {NUM_FRAMES} forecasts' rel_l2 {fc_rel:.3e}")
    if not (torch.isfinite(fields["kernel"]).all() and fc_rel <= BF16_ABS):
        raise AssertionError(f"the bf16 forecast is not finite or lies {fc_rel:.3e} from the f32 one")

    # The nef step on the kernels in bf16 against the plain bf16 composition, and its witnesses.
    witness = nef_witness(load_experiment_config("navier_stokes", ["nef.backend=pallas"]), coords, traj)
    log(f"[phase 35] bf16 programs in {time.perf_counter() - t0:.2f} s")
    return {"timing": res, "medians": medians, "forecast_rel": fc_rel, "witness": witness, "k1_wide": k1_wide}


# ----------------------------------------------------------------- phase 36


def keep_test_split(name: str, path: Path, n: int, raw: bool = False) -> None:
    """Keep the ``n`` test trajectories of experiment ``name`` that a data phase generated under
    ``path``, as its test loader yields them (frames cut, pooled to the dataset's grid), on the
    host in TEST_SPLITS under the dataset's name: phase 36 validates the trained runs on them
    after the data directories are gone. With ``raw``, also the cache's files as the solver wrote
    them (RAW_SPLITS): phase 37 writes them into a cache of its own and trains on them."""
    cfg = load_experiment_config(name, [f"dataset.path={path}", f"dataset.num_signals_test={n}",
                                        "dataset.batch_size=1"])
    _, test = get_dataloader(cfg.dataset, device="cpu")
    TEST_SPLITS[cfg.dataset.name] = np.concatenate([np.asarray(batch[0]) for batch in test])
    if raw:
        cache_name = dataset_spec(cfg.dataset.name, cfg.dataset, device="cpu").cache_name
        cache = TrajectoryCache(str(path / cache_name / "test"), None)
        RAW_SPLITS[cfg.dataset.name] = (cache_name, np.stack([cache.get(i) for i in range(n)]))


def trained_test_split(dataset: str, n: int, dev) -> np.ndarray:
    """The test trajectories phase 36 validates a run of ``dataset`` on: those an earlier phase kept
    (TEST_SPLITS), or else the run's own ``n`` generated on the card into a fresh directory, removed
    after (``diffusion_plane``'s 32: its phase generated 8, in under a second)."""
    kept = TEST_SPLITS.get(dataset)
    if kept is not None:
        return kept
    path = fresh_dir(OUT_DIR / f"trained_{dataset}_data")
    cfg = load_experiment_config(dataset, [f"dataset.path={path}", f"dataset.num_signals_test={n}",
                                           "dataset.batch_size=1"])
    _, test = get_dataloader(cfg.dataset, device=str(dev))
    gen_s = sync_time(test.ensure_all)[1]
    split = np.concatenate([np.asarray(batch[0]) for batch in test])
    shutil.rmtree(path)
    log(f"[phase 36] {dataset}: {n} test trajectories generated on the card in {gen_s:.2f} s "
        "(no earlier phase kept its test split)")
    return split


def repeated_frames(traj, b: int) -> list:
    """The frames of latent trajectories (p, a, w), each [n, T, ...], flattened and repeated to ``b``."""
    flat = [t.reshape(-1, *t.shape[2:]) for t in traj]
    reps = -(-b // flat[0].shape[0])
    return [t.repeat(reps, *([1] * (t.dim() - 1)))[:b] for t in flat]


def plain_decode(dec, coords: torch.Tensor, frames, chunk: int, dtype, sums=torch.float32) -> torch.Tensor:
    """K1's plain version decoding latent frames ``(p, a, w)`` [b, ...] at every point of ``coords``
    in chunks of ``chunk``, with ``dtype``'s roundings and its inputs (so its sums) in ``sums``
    (float64: the exact function of those roundings); [b, points, out] in f32."""
    folded = [[t.to(sums) for t in f] if isinstance(f, (list, tuple)) else f.to(sums) for f in dec.fold(*frames)]

    def apply(xc, pp, aa, ww):
        geometry = [t.to(sums) for t in dec.kernel_geometry(xc, pp, ww)]
        return fused_decode_plain(*geometry, *folded, num_heads=dec.num_heads, head_dim=dec.num_hidden,
                                  compute_dtype=dtype).float()
    with torch.no_grad():
        return decode_chunked(apply, coords[None].expand(frames[0].shape[0], -1, -1), *frames, chunk_size=chunk)


def k1_f32_timing(cfg, args, label: str) -> dict:
    """K1's f32 program at ``args`` against its plain version (REL_L2_TOL), timed beside it and the
    3xTF32 bound, its shared weights split once as a decode splits them."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    with torch.no_grad():
        got = fused_decode_fwd(*args, num_heads=H, head_dim=D)
        err = check_close(f"K1 {label}", got, fused_decode_plain(*args, num_heads=H, head_dim=D))
        split = shared_weights(args[6])
        ms = cuda_ms(lambda: fused_decode_fwd(*args, num_heads=H, head_dim=D, split=split), iters=20)
        p_ms = cuda_ms(lambda: fused_decode_plain(*args, num_heads=H, head_dim=D), iters=3, warmup=1)
    bd = k1_bounds(cfg, args, got)
    log(f"[timing] K1 {label}: {ms:.4f} ms; plain {p_ms:.4f} ms; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
        f"(3xTF32 tensor cores {bd['tc_ms']:.4f} ms, bytes {bd['bytes_ms']:.4f} ms)")
    return dict(ms=ms, plain_ms=p_ms, max_abs_err=err, **bd)


def trained_run_phase(run: str, dev) -> dict:
    """36 for one trained JAX run, served from ``weights/<run>`` by ``Forecaster.from_jax_export``
    (the fit on the eager decoder, the decode on K1's bf16 program; a second one on ``xla``):
    (a) the two reference latent sets decoded eagerly, by the f32 K1 and by the bf16 K1: eager and the
    f32 K1 within TRAINED_TOL of JAX's f32 decode, the bf16 K1 against the plain bf16 and f32
    versions on the same inputs with phase 35's gates, and its distances from JAX's bf16 and f32
    decodes printed beside JAX's own bf16-f32 gap; (b) the forecast from the reference fields with
    JAX's masks on ``xla`` within TRAINED_FORECAST_TOL of JAX's, and on ``pallas`` held with phase
    35's gates against the plain bf16 decode of the same rollout; (c) validation (``val_step``)
    on the test trajectories the earlier phases generated on the card, its in-t MSE within
    MSE_FACTOR of the run's record where the split has MSE_GATED_SIGNALS signals or more. Every
    run counted with K1's launches zeroed just before it (``launches_by_program``, held to the
    decode's chunks) and timed warm (median of WARM_REPEATS); K1's f32 program timed at the
    decode's launch shape and its bf16 program (``k1_bf16_check``) at validation's, on the
    trained weights and rolled-out latents. Returns the kernels line's two entries."""
    t0 = time.perf_counter()
    path = WEIGHTS_DIR / run
    with np.load(path / "reference.npz", allow_pickle=False) as f:
        ref = {k: f[k] for k in f.files}
    fc, load_s = sync_time(lambda: Forecaster.from_jax_export(path))
    fc_xla = Forecaster.from_jax_export(path, backend="xla")
    cfg, record, coords = fc.cfg, fc.record, fc.trainer.coords
    dec = fc.trainer.decoder
    H, D, chunk, Z = cfg.nef.num_heads, cfg.nef.num_hidden, cfg.training.max_num_sampled_points, cfg.nef.num_latents
    I, n_chunks = get_ca_invariant(cfg.nef).dim, -(-coords.shape[0] // chunk)
    tag = f"trained {run}"
    log(f"[{tag}] {cfg.dataset.name} epoch {record['epoch']}: Forecaster.from_jax_export in {load_s:.3f} s on "
        f"{fc.device} (H={H}, hid={D}, z={Z}, I={I}, {coords.shape[0]} points in {n_chunks} chunks of {chunk})")
    launches, medians = Counter(), {}

    def counted(name: str, fn, b: int, dtype, runs: int = 1):
        """``fn()`` with K1's counts set to 0 just before it and read just after (``runs`` x the decode's
        chunks at ``(dtype, b, Z, chunk, I)``, no K2), then its warm median."""
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = Counter(fused_decode_fwd.launches_by_program)
        want = Counter({(dtype, b, Z, chunk, I): runs * n_chunks} if dtype is not None else {})
        if got != want or fused_decode_bwd.launches:
            raise AssertionError(f"{tag} {name}: K1 launched {dict(got)} (expected {dict(want)}), K2 "
                                 f"{fused_decode_bwd.launches} times")
        launches.update(got)
        medians[name] = statistics.median(sync_time(fn)[1] * 1e3 for _ in range(WARM_REPEATS))
        return out

    # (a) The two reference latent sets on the whole grid.
    traj = tuple(torch.from_numpy(ref[k]).to(dev)[:, None] for k in ("p", "a", "window"))
    j32, j16 = (torch.from_numpy(ref[k]).to(dev) for k in ("decode_f32", "decode_bf16"))
    got = {backend: counted(f"decode {backend}", lambda: decode_trajectories(dec, backend, coords, traj, chunk)[:, 0],
                            2, dtype)
           for backend, dtype in (("eager", None), (F32_KERNELS, torch.float32), ("kernel", BF16))}
    flat = [t[:, 0] for t in traj]
    plain = {dt: plain_decode(dec, coords, flat, chunk, dt) for dt in (BF16, torch.float32)}
    x16 = plain_decode(dec, coords, flat, chunk, BF16, sums=torch.float64)
    errs = {b: rel_l2(got[b], j32) for b in ("eager", F32_KERNELS)}
    log(f"[{tag}] (a) decode of 2 x {coords.shape[0]} points against JAX's f32: eager {errs['eager']:.3e}, f32 K1 "
        f"{errs[F32_KERNELS]:.3e} (tol {TRAINED_TOL:g}); bf16 K1 to JAX's bf16 {rel_l2(got['kernel'], j16):.3e}, to "
        f"JAX's f32 {rel_l2(got['kernel'], j32):.3e}, JAX's own bf16-f32 gap {rel_l2(j16, j32):.3e} (the TPU record at "
        "random weights, 1.115e-2, results/r3/pallas_parity_tpu.txt; no gate); warm medians " + ", ".join(
            f"{b} {medians[f'decode {b}']:.3f} ms" for b in got))
    if max(errs.values()) > TRAINED_TOL:
        raise AssertionError(f"{tag}: the port's f32 decode lies {errs} from JAX's")
    gates = bf16_gates(f"{tag} decode (bf16 K1) vs plain decode", got["kernel"], plain[BF16], plain[torch.float32],
                       absolute=True)
    x_gap = rel_l2(x16, plain[torch.float32])
    log(f"[{tag}] (a) against the exact bf16 function (the plain bf16 version with float64 sums; its gap from f32 "
        f"{x_gap:.3e}), in gaps: bf16 K1 {rel_l2(got['kernel'], x16) / x_gap:.3f}, plain bf16 "
        f"{rel_l2(plain[BF16], x16) / x_gap:.3f}, JAX's bf16 {rel_l2(j16, x16) / x_gap:.3f} (no gate)")

    # (b) The forecast from the reference fields, with JAX's inner-loop masks.
    frames, masks = torch.from_numpy(ref["decode_f32"]).to(dev), ref["forecast_masks"]
    T = ref["forecast"].shape[1]
    want = torch.from_numpy(ref["forecast"]).to(dev)
    xla = counted("forecast xla", lambda: fc_xla.forecast(frames, num_frames=T, masks=masks), 0, None)
    pallas = counted("forecast pallas", lambda: fc.forecast(frames, num_frames=T, masks=masks), 2 * T, BF16)
    # The same path stage by stage, to hold its decode against the plain decode of its rollout.
    roll = fc.rollout(fc.fit(frames, masks=masks), T)
    field = counted("forecast pallas decode", lambda: fc.decode(roll), 2 * T, BF16)
    fl = [t.reshape(2 * T, *t.shape[2:]) for t in roll]
    plain = {dt: plain_decode(dec, coords, fl, chunk, dt).reshape(field.shape) for dt in (BF16, torch.float32)}
    fc_err = rel_l2(xla, want)
    log(f"[{tag}] (b) forecast of 2 fields x {T} frames: xla against JAX's {fc_err:.3e} (tol {TRAINED_FORECAST_TOL:g}); "
        f"pallas (bf16 K1) against JAX's {rel_l2(pallas, want):.3e} (against its stages' decode "
        f"{rel_l2(pallas, field):.3e}); warm medians xla "
        f"{medians['forecast xla']:.2f} ms, pallas {medians['forecast pallas']:.2f} ms (its decode "
        f"{medians['forecast pallas decode']:.2f} ms)")
    if not fc_err <= TRAINED_FORECAST_TOL:
        raise AssertionError(f"{tag}: the xla forecast lies {fc_err:.3e} from JAX's")
    fc_gates = bf16_gates(f"{tag} forecast decode (bf16 K1) vs plain decode", field, plain[BF16], plain[torch.float32],
                          absolute=True)

    # (c) Validation on the test trajectories generated on the card.
    split = trained_test_split(cfg.dataset.name, cfg.dataset.num_signals_test, dev)
    bs = min(cfg.dataset.batch_size, len(split))
    batches = [torch.from_numpy(split[i:i + bs]).to(dev) for i in range(0, len(split) - bs + 1, bs)]
    t_total = min(cfg.dataset.traj_len_train + cfg.dataset.traj_len_out_horizon, split.shape[1])

    def validate():
        return [fc.trainer.val_step(fc.state, b, batch_idx=i) for i, b in enumerate(batches)]

    per = [tuple(float(v) for v in mse) for mse in counted("validation", validate, bs * t_total, BF16, len(batches))]
    mse_in, mse_out = (statistics.fmean(v[k] for v in per) for k in (0, 1))
    rec_in, rec_out = record["metrics"]["val_mse_in_t"], record["metrics"]["val_mse_out_t"]
    gated = len(split) >= MSE_GATED_SIGNALS
    log(f"[{tag}] (c) validation on {len(split)} test trajectories generated on the card ({len(batches)} batches of "
        f"{bs}, {t_total} frames): in-t MSE {mse_in:.4e} (the run's record {rec_in:.4e} over "
        f"{cfg.dataset.num_signals_test} signals, ratio {mse_in / rec_in:.3f}"
        f"{f', gate 1/{MSE_FACTOR:g} .. {MSE_FACTOR:g}' if gated else ', not gated: fewer than 8 signals'}), out-t "
        f"{mse_out:.4e} (record {rec_out:.4e}); per batch in-t " + ", ".join(f"{v[0]:.3e}" for v in per)
        + f"; warm median {medians['validation']:.2f} ms")
    if gated and not 1 / MSE_FACTOR <= mse_in / rec_in <= MSE_FACTOR:
        raise AssertionError(f"{tag}: in-t MSE {mse_in:.4e} is not within {MSE_FACTOR:g}x of the record {rec_in:.4e}")

    # K1 at this run's launch shapes, on its trained weights and rolled-out latents.
    b_val = bs * t_total
    with torch.no_grad():
        xs = coords[None, :chunk]
        f32 = k1_f32_timing(cfg, dec.kernel_inputs(xs.expand(2, -1, -1), *flat), f"{tag} decode b=2 z={Z} c={chunk}")
        val = k1_bf16_check(cfg, dec.kernel_inputs(xs.expand(b_val, -1, -1), *repeated_frames(roll, b_val)),
                            f"{tag} validation b={b_val} z={Z} c={chunk}")
    val["max_abs_err"] = max(val["max_abs_err"], gates["max_abs_err"], fc_gates["max_abs_err"])
    log(f"[phase 36] {run} in {time.perf_counter() - t0:.2f} s; K1 launches " + ", ".join(
        f"{'bf16' if k[0] == BF16 else 'f32'} b={k[1]} z={k[2]} c={k[3]} I={k[4]}: {n}" for k, n in launches.items()))
    entries = []
    for dtype, nums, shape in ((BF16, val, f"validation b={b_val}"), (torch.float32, f32, "decode b=2")):
        by_shape = {f"b={k[1]} z={k[2]} c={k[3]} I={k[4]}": n for k, n in launches.items() if k[0] == dtype}
        entries.append({
            "name": "fused_decode_fwd" + ("_bf16" if dtype == BF16 else ""),
            "shape": f"{run} trained weights ({cfg.dataset.name}), timed at the {shape} z={Z} c={chunk} I={I}",
            "route": "cuda", "source": f"enf_pde_tpu_torch/csrc/{KERNEL_SOURCE_BF16 if dtype == BF16 else KERNEL_SOURCE}",
            "replaces": "enf_pde_tpu/ops/pallas_decode.py:548", "launches": sum(by_shape.values()),
            "launches_by_shape": by_shape, "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
            "library_ms": None, **({"f32_ms": nums["f32_ms"]} if dtype == BF16 else {})})
    del fc, fc_xla
    torch.cuda.empty_cache()
    return {"entries": entries, "mse_in": mse_in, "record_in": rec_in, "medians": medians}


def trained_phase(dev) -> dict:
    """36. The repo's four trained JAX runs (``weights/``, exported by ``tools/export_jax_checkpoint.py``
    from ``results/ckpt``) served on the card: ``trained_run_phase`` for each of TRAINED_RUNS."""
    t0 = time.perf_counter()
    res = {run: trained_run_phase(run, dev) for run in TRAINED_RUNS}
    log(f"[phase 36] {len(res)} trained runs in {time.perf_counter() - t0:.2f} s: in-t MSE / record " + ", ".join(
        f"{run} {r['mse_in']:.4e} / {r['record_in']:.4e}" for run, r in res.items()))
    return res


# ----------------------------------------------------------------- phase 37


# Phase 37: the trained runs that train on through the kernels (``nef.ode_backend: pallas``), resumed on
# the card from their exports (``weights/<run>/opt_state.npz``) for RESUME_EPOCHS epochs.
RESUME_RUNS = ("ns8192_s0", "sw_full_s1")
RESUME_EPOCHS = 2
RESUME_BUDGET_S = 60.0  # the whole phase on the card
DRIFT_STEPS = 8  # tools/ode_backend_check.py's k
# JAX's TPU record of its ode / dual steps on the Pallas kernel against XLA, DRIFT_STEPS steps from a fresh
# ``init_state`` on real data (results/r4/ode_backend_check_navier_stokes.json and
# results/r4/ode_backend_check_sw.json, copied: the card's copy has no results/): the per-step losses and
# the largest relative drift, |pallas - xla| / |xla|. Phase 37 gates the f32 kernels' drift from eager at
# these numbers from the trained state, a start of its own.
JAX_DRIFT_RECORD = {
    "ns8192_s0": {
        "config": "navier_stokes",
        "ode": {"xla": [0.883548, 0.8799, 0.878842, 0.880476, 0.870376, 0.861238, 0.852777, 0.860164],
                "pallas": [0.883527, 0.879836, 0.878773, 0.880432, 0.870316, 0.861129, 0.852723, 0.860091],
                "max_rel_drift": 0.00013},
        "dual": {"xla": [0.883548, 0.795239, 0.756342, 0.762352, 0.700391, 0.729195, 0.762227, 0.735852],
                 "pallas": [0.883527, 0.795483, 0.756715, 0.765438, 0.695761, 0.719807, 0.750507, 0.738926],
                 "max_rel_drift": 0.01538}},
    "sw_full_s1": {
        "config": "shallow_water",
        "ode": {"xla": [0.024083, 0.018202, 0.013833, 0.011025, 0.009148, 0.008081, 0.00751, 0.007005],
                "pallas": [0.023959, 0.018087, 0.013747, 0.010958, 0.009113, 0.008044, 0.007468, 0.006963],
                "max_rel_drift": 0.00634},
        "dual": {"xla": [0.024083, 0.008508, 0.004614, 0.003227, 0.002529, 0.001566, 0.001128, 0.001145],
                 "pallas": [0.023959, 0.008438, 0.00456, 0.003229, 0.002512, 0.001543, 0.001108, 0.001148],
                 "max_rel_drift": 0.01751}},
}
# The drift check's sides and their ode backends: on the card ``pallas`` is K1 + K2's bf16 programs,
# ``pallas_interpret`` their f32 programs (``tools/resume_rehearsal.py`` runs the same check on the CPU,
# where the kernel backends run the plain compositions, ``kernel`` at bf16 there).
DRIFT_SIDES = {"pallas": "kernel", "pallas_interpret": F32_KERNELS, "eager": "eager"}
# Right evaluations of the first ode step's loss beside cpu16 and plain16: the plain bf16 composition on the card with
# the K terms of every product summed in a seeded order (``permuted_sums``). A small residual's loss moves by a chance
# projection of its decode's roundings: at shallow water 32 such orders lay up to 5.26 gaps from the exact bf16
# function (median 1.28) on an H100, each 0.30-0.32 gap from it as a tensor (PERF.md §6), so the spread wants many.
LOSS_WITNESSES = 32


class CaptureDecode(torch.nn.Module):
    """``decoder`` keeping, at its last decode on a kernel backend, the kernel inputs (``args``) and the
    cotangent that the step's backward hands its output (``g``): a step's own launch of K1 and K2."""

    def __init__(self, decoder):
        super().__init__()
        self.decoder, self.args, self.g = decoder, None, None

    def forward(self, x, p, a, w, backend="eager"):
        out = self.decoder(x, p, a, w, backend=backend)
        if backend != "eager":
            with torch.no_grad():
                self.args = self.decoder.kernel_inputs(x, p, a, w)
            if out.requires_grad:
                out.register_hook(lambda g: setattr(self, "g", g.detach()))
        return out


def snapshot(trainer, state) -> tuple:
    """What a step changes: the modules' tensors, the state and the training generator."""
    return ({k: v.clone() for k, v in trainer.decoder.state_dict().items()},
            {k: v.clone() for k, v in trainer.ode_model.state_dict().items()},
            copy.deepcopy(state), trainer.generator.get_state())


def restored(trainer, snap) -> dict:
    """``snap`` put back into ``trainer``; returns a copy of its state."""
    nef, ode, state, gen = snap
    trainer.decoder.load_state_dict(nef)
    trainer.ode_model.load_state_dict(ode)
    trainer.generator.set_state(gen)
    return copy.deepcopy(state)


def resume_draws(cfg, num_coords: int, n: int, seed: int) -> list:
    """``n`` steps' draws: the inner-loop masks [K + 1, M] and the rollout's subsets [T, M]."""
    gen = torch.Generator().manual_seed(seed)
    M, K, T = cfg.training.max_num_sampled_points, cfg.meta.num_inner_steps, cfg.dataset.traj_len_train
    return [{"masks": torch.stack([torch.randperm(num_coords, generator=gen)[:M] for _ in range(K + 1)]),
             "ode_masks": torch.stack([torch.randperm(num_coords, generator=gen)[:M] for _ in range(T)])}
            for _ in range(n)]


def ode_loss(trainer, state, traj, draws) -> float:
    """The ode step's loss at ``state`` on ``draws`` (no update)."""
    with train_steps.frozen(trainer.decoder):
        return float(trainer._ode_loss(state["meta_sgd_lrs"], state["autodecoder"], traj, second_order=False,
                                       **draws).detach())


def drift_check(run: str, trainer, state, traj, draws) -> dict:
    """37 (c): from ``state``, DRIFT_STEPS ode steps and DRIFT_STEPS dual steps on ``draws`` on each of
    DRIFT_SIDES (each from the same state, modules and generator): the per-step losses
    and each side's largest relative drift from eager, |side - eager| / |eager|, printed beside JAX's TPU
    record (JAX_DRIFT_RECORD: its kernel against XLA, from a fresh state); ``pallas_interpret`` (the f32
    kernels) gated at the record's drift, ``pallas`` printed. Returns the losses and the drifts by kind
    and side."""
    record, snap = JAX_DRIFT_RECORD[run], snapshot(trainer, state)
    backend0 = trainer.ode_backend
    losses, drifts = {}, {}
    for kind in ("ode", "dual"):
        losses[kind] = {}
        for side, backend in DRIFT_SIDES.items():
            st = restored(trainer, snap)
            trainer.ode_backend = backend
            step = getattr(trainer, f"{kind}_train_step")
            losses[kind][side] = [float(step(st, traj, **d)[0]) for d in draws]
        trainer.ode_backend = backend0
        eager = losses[kind]["eager"]
        drifts[kind] = {side: max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, eager))
                        for side, got in losses[kind].items() if side != "eager"}
        jax = record[kind]
        log(f"[phase 37] {run} (c) {DRIFT_STEPS} {kind} steps from the restored state, losses: " + "; ".join(
            f"{side} [{', '.join(f'{v:.6e}' for v in got)}]" for side, got in losses[kind].items())
            + "; largest relative drift from eager: " + ", ".join(f"{s} {v:.3e}" for s, v in drifts[kind].items())
            + f" (JAX's TPU record, {record['config']}, its kernel against XLA from a fresh init_state on real data: "
            f"{jax['max_rel_drift']:g}; its losses xla [{', '.join(f'{v:g}' for v in jax['xla'])}], pallas "
            f"[{', '.join(f'{v:g}' for v in jax['pallas'])}], results/r4/ode_backend_check_{record['config'].replace('shallow_water', 'sw')}.json)")
        f32 = drifts[kind].get("pallas_interpret")
        if f32 is not None and not f32 <= jax["max_rel_drift"]:
            raise AssertionError(f"{run}: the f32 kernels' {kind} drift from eager {f32:.3e} is past JAX's TPU "
                                 f"record {jax['max_rel_drift']:g}")
    restored(trainer, snap)
    return {"losses": losses, "drifts": drifts}


def permuted_sums(seed: int):
    """``fused_decode._mm`` with the K terms of every product summed in a seeded order (a permutation of K): a right
    evaluation of the same bf16 function with other f32 roundings (LOSS_WITNESSES)."""
    gen = torch.Generator().manual_seed(seed)

    def mm(x, w, bf16):
        perm = torch.randperm(w.shape[-2], generator=gen).to(w.device)
        xb, wb = (fused_decode_module._b16(x), fused_decode_module._b16(w)) if bf16 else (x, w)
        return xb[..., perm] @ wb[..., perm, :]
    return mm


def rollout_targets(traj, ode_masks) -> torch.Tensor:
    """``rollout_loss``'s targets: ``traj`` [b, >= T, *grid, C] (the ode step's first T frames) at each frame's subset
    ``ode_masks`` [T, M] -> [b T, M, C]."""
    m = torch.as_tensor(ode_masks, dtype=torch.long).to(traj.device)
    (T, M), b, C = m.shape, traj.shape[0], traj.shape[-1]
    return traj[:, :T].reshape(b, T, -1, C)[:, torch.arange(T, device=traj.device)[:, None], m].reshape(b * T, M, C)


def first_loss_sides(args, ys, H: int, D: int, kernel=None) -> tuple:
    """The first ode step's loss, ``rollout_loss``'s mean((o - ys)^2) taken in float64, for each side's decode o of
    the step's own K1 inputs ``args`` and targets ``ys``: ``kernel`` (K1 bf16's output, where given), the right bf16
    evaluations ``plain16`` and ``cpu16`` (``plain_sides``) and ``perm<s>``, the plain bf16 composition on ``args``'
    device with permuted sums (``permuted_sums``, LOSS_WITNESSES seeds), the exact bf16 function ``x16`` and the
    plain f32 composition on the CPU, ``cpu32``. Returns (losses, each side's decode's distance from x16 as a tensor
    in gaps, |o - x16| / |x16 - cpu32|)."""
    with torch.no_grad():
        sides = plain_sides(args, H, D)
        cpu = [[w.cpu() for w in t] if isinstance(t, (list, tuple)) else t.cpu() for t in args]
        outs = {"x16": sides["x16"].double(), "cpu32": fused_decode_plain(*cpu, H, D).double().to(ys.device),
                "plain16": sides["plain16"], "cpu16": sides["cpu16"]}
        del sides
        for seed in range(LOSS_WITNESSES):
            with mock.patch.object(fused_decode_module, "_mm", permuted_sums(seed)):
                outs[f"perm{seed}"] = fused_decode_plain(*args, H, D, compute_dtype=BF16)
        if kernel is not None:
            outs["kernel"] = kernel
        x16, y = outs["x16"], ys.double()
        gap = float((x16 - outs["cpu32"]).norm())
        losses = {n: float(((o.double() - y) ** 2).mean()) for n, o in outs.items()}
        dists = {n: float((o.double() - x16).norm()) / gap for n, o in outs.items() if n != "x16"}
    return losses, dists


def first_loss_gates(label: str, loss: dict, dist: dict) -> dict:
    """The bf16 kernels' first-step loss ``loss["kernel"]`` (``first_loss_sides``) against the same loss through the
    plain bf16 and f32 compositions on the CPU (``cpu16``, ``cpu32``): phase 35's gates in scalar form (``bf16_gates``).
    Beside it each side's distance from the exact bf16 function ``x16`` in gaps (|x16 - cpu32| / |cpu32|), and its
    decode's as a tensor (``dist``). Where the right evaluations (every side but the kernels, x16 and cpu32) themselves
    lie farther than BF16_NEAR of the gap from x16, the scalar gates cannot tell right from wrong (a small residual's
    loss moves by a chance projection of its decode's roundings), and the kernels are held as ``witness_gates`` holds
    them: within WITNESS_FACTOR times the farthest right evaluation's distance from x16. Returns the readings."""
    k, x16, p32 = loss["kernel"], loss["x16"], loss["cpu32"]
    gap = abs(x16 - p32) / abs(p32)
    signed = {n: (v - x16) / abs(p32) / gap for n, v in loss.items() if n not in ("x16", "cpu32")}
    right = [n for n in signed if n != "kernel"]
    perms = sorted(abs(signed[n]) for n in right if n.startswith("perm"))
    spread = max(abs(signed[n]) for n in right)
    log(f"[phase 37] {label}: kernels {k:.9e}, cpu16 {loss['cpu16']:.9e}, plain16 {loss['plain16']:.9e}, x16 {x16:.9e}, "
        f"cpu32 {p32:.9e}; the bf16 gap {gap:.3e} of the loss; from x16 in gaps (signed): kernels {signed['kernel']:+.3f}, "
        f"cpu16 {signed['cpu16']:+.3f}, plain16 {signed['plain16']:+.3f}, {len(perms)} permuted sums' median "
        f"{perms[len(perms) // 2]:.3f} and farthest {perms[-1]:.3f}; the decodes from x16 as tensors in their gap: kernels "
        f"{dist['kernel']:.3f}, the right evaluations {min(dist[n] for n in right):.3f} .. {max(dist[n] for n in right):.3f}")
    as_t = lambda v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
    try:
        worst = bf16_gates(f"{label} against the plain compositions on the CPU (phase 35's gates, scalar)", as_t(k),
                           as_t(loss["cpu16"]), as_t(p32), absolute=False)
        held = "phase 35's gates"
    except AssertionError as e:
        gate = WITNESS_FACTOR * spread
        if spread <= BF16_NEAR or not abs(signed["kernel"]) <= gate:
            raise AssertionError(f"{label}: {abs(signed['kernel']):.3f} of the gap from x16, past phase 35's scalar gates "
                                 f"({e}) and past {WITNESS_FACTOR:g} x the right evaluations' farthest ({spread:.3f})")
        worst, held = None, (f"the right evaluations' spread: {abs(signed['kernel']):.3f} of the gap from x16, within "
                             f"{WITNESS_FACTOR:g} x the farthest of {len(right)} ({spread:.3f}, gate {gate:.3f}); past "
                             f"phase 35's scalar gates, which the right evaluations leave too ({e})")
    log(f"[phase 37] {label}: held by {held}")
    return {"gap": gap, "signed": signed, "dist": dist, "spread": spread, "worst": worst, "held": held}


def restored_vs_fresh(run: str, trainer, state, traj, draws) -> dict:
    """37 (d): the first ode step from ``state`` once with its restored optimizer states and once with
    fresh ones (``Adam.init``), the same draws: the rel-L2 between the two ODE updates and each one's
    loss after (the same draws again)."""
    snap, out = snapshot(trainer, state), {}
    for label in ("restored", "fresh"):
        st = restored(trainer, snap)
        if label == "fresh":
            st["opt"]["ode"] = trainer.opts["ode"].init(trainer.ode_group())
        before = torch.cat([v.detach().reshape(-1).double() for v in trainer.ode_group().values()])
        loss, st = trainer.ode_train_step(st, traj, **draws)
        after = torch.cat([v.detach().reshape(-1).double() for v in trainer.ode_group().values()])
        out[label] = {"update": after - before, "loss": float(loss), "after": ode_loss(trainer, st, traj, draws)}
    restored(trainer, snap)
    rel = rel_l2(out["fresh"]["update"], out["restored"]["update"])
    ratio = float(out["fresh"]["update"].norm() / out["restored"]["update"].norm())
    log(f"[phase 37] {run} (d) the first ode step with restored against fresh optimizer states: the ODE's updates "
        f"lie {rel:.3e} apart (rel-L2 to the restored one; the fresh one {ratio:.2f}x its norm); loss {out['restored']['loss']:.6e} "
        f"before, after {out['restored']['after']:.6e} (restored) / {out['fresh']['after']:.6e} (fresh)")
    return {"rel": rel, "ratio": ratio, "after": {k: v["after"] for k, v in out.items()}, "before": out["restored"]["loss"]}


def resume_data(run: str, cfg) -> tuple:
    """A cache directory holding the test split an earlier phase kept (RAW_SPLITS, as the solver wrote it)
    as both the train and the test split of ``cfg``'s dataset; returns (directory, number of signals)."""
    cache_name, raw = RAW_SPLITS[cfg.dataset.name]
    path = fresh_dir(OUT_DIR / f"resume_{run}_data")
    for split in ("train", "test"):
        cache = TrajectoryCache(str(path / cache_name / split), None)
        for i, traj in enumerate(raw):
            cache.write(i, traj)
    return path, len(raw)


def resume_run_phase(run: str, dev) -> dict:
    """37 for one trained run (RESUME_RUNS) whose ode steps decode on the kernels (``nef.ode_backend:
    pallas``): (a) its export written as the port's checkpoint (``convert.write_resume_checkpoint``) and
    trained on by ``run_experiment`` with ``logging.resume=true`` for RESUME_EPOCHS ode epochs at its own
    config and widths, on an earlier phase's test split (both splits; each reduction printed), K1's and
    K2's launches counted by program and shape (zeroed just before), the optimizers' counts and the global
    step continued, the in-t MSE beside the record (gated at MSE_FACTOR where the split has
    MSE_GATED_SIGNALS); (b) from the restored state (the export in a fresh trainer, ``load_state`` with
    its optimizer states) one ode step's own K1 and K2 launch (its rollout of the restored latents, its
    cotangent): K2 bf16 without and with weight gradients (``k2_bf16_check``) and K1 bf16
    (``k1_bf16_check``), timed; (c) ``drift_check`` and the first-step loss of the bf16 kernels against the
    plain bf16 and f32 compositions on the CPU (phase 35's gates in scalar form); (d)
    ``restored_vs_fresh``. Returns the kernels line's entries and the phase's numbers."""
    t0 = time.perf_counter()
    path = WEIGHTS_DIR / run
    cfg0, params, record = load_jax_export(path)
    opt0, step0, _ = load_opt_state(path, cfg0)
    epoch = record["epoch"]
    tag = f"resumed {run}"

    # (a) run_experiment with logging.resume from the export's checkpoint.
    data, n = resume_data(run, cfg0)
    log_dir = fresh_dir(OUT_DIR / f"resume_{run}")
    write_resume_checkpoint(path, log_dir)
    reductions = {"dataset.num_signals_train": n, "dataset.num_signals_test": n,
                  "training.num_epochs": epoch + RESUME_EPOCHS, "test.test_interval": RESUME_EPOCHS}
    if cfg0.get_path("logging.visualize_every_n_epochs", 0):
        reductions["logging.visualize_every_n_epochs"] = 0  # the card's Python has no matplotlib
    log(f"[phase 37] {run}: the run's config at its own widths, cut: " + ", ".join(
        f"{k} {cfg0.get_path(k)} -> {v}" for k, v in reductions.items())
        + f" (the {n} test trajectories an earlier phase generated on the card, as both splits; validation at the "
        "last epoch)")
    cfg = Config(cfg0.to_dict())  # a copy: cfg0 builds the trainer of (b)
    for k, v in {**reductions, "dataset.path": str(data), "logging.log_dir": str(log_dir),
                 "logging.resume": True}.items():
        cfg.set_path(k, v)
    reset_launches()
    (loop, state), run_s = sync_time(lambda: run_experiment(cfg, device=str(dev)))
    k1, k2 = Counter(fused_decode_fwd.launches_by_program), Counter(fused_decode_bwd.launches_by_program)
    records = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
    resumed = next((r for r in records if "resumed_from_epoch" in r), {})
    epochs = [(int(r["epoch"]), r["phase"]) for r in records if "train_mse_epoch" in r]
    steps = len(loop.train_loader) * RESUME_EPOCHS
    counts = {g: (opt0[g]["count"], state["opt"][g]["count"]) for g in opt0}
    val = next(r for r in records if "val_mse_in_t" in r)
    rec_in = record["metrics"]["val_mse_in_t"]
    ratio = val["val_mse_in_t"] / rec_in
    gated = n >= MSE_GATED_SIGNALS
    log(f"[phase 37] {run}: resumed from epoch {int(resumed.get('resumed_from_epoch', -1))} through run_experiment in "
        f"{run_s:.2f} s (config differs at {resumed.get('resumed_config_differs')}); epochs {epochs}; global step "
        f"{step0} -> {loop.global_step}; optimizer counts before -> after: " + ", ".join(
            f"{g} {a} -> {b}" for g, (a, b) in counts.items()) + f"; in-t MSE {val['val_mse_in_t']:.4e} at epoch "
        f"{int(val['epoch'])} (the run's record {rec_in:.4e}, ratio {ratio:.3f}"
        + (f", gate 1/{MSE_FACTOR:g} .. {MSE_FACTOR:g}" if gated else ", not gated: fewer than 8 signals")
        + f"), out-t {val['val_mse_out_t']:.4e} (record {record['metrics']['val_mse_out_t']:.4e}); K1 launches "
        + ", ".join(f"{'bf16' if k[0] == BF16 else 'f32'} b={k[1]} z={k[2]} c={k[3]} I={k[4]}: {v}" for k, v in k1.items())
        + "; K2 " + ", ".join(f"{'bf16' if k[0] == BF16 else 'f32'} b={k[1]} z={k[2]} c={k[3]} I={k[4]} "
                              f"{'with' if k[5] else 'without'} weight grads: {v}" for k, v in k2.items()))
    if resumed.get("resumed_from_epoch") != epoch or epochs != [(epoch + e, "ode") for e in range(1, RESUME_EPOCHS + 1)]:
        raise AssertionError(f"{tag}: resumed from {resumed.get('resumed_from_epoch')} and trained {epochs}, not "
                             f"{RESUME_EPOCHS} ode epochs from {epoch + 1}")
    want = {g: (a, a + steps if g == "ode" else a) for g, (a, _) in counts.items()}
    if counts != want or loop.global_step != step0 + steps:
        raise AssertionError(f"{tag}: counts {counts} (expected {want}), global step {loop.global_step} "
                             f"(expected {step0 + steps})")
    b_ode = cfg.dataset.batch_size * cfg.dataset.traj_len_train
    ode_key = (BF16, b_ode, cfg.nef.num_latents, cfg.training.max_num_sampled_points, get_ca_invariant(cfg.nef).dim)
    if k2 != Counter({(*ode_key, False): steps}) or k1[ode_key] < steps or any(k[0] != BF16 for k in k1):
        raise AssertionError(f"{tag}: K1 {dict(k1)}, K2 {dict(k2)}: not the bf16 programs, one K1 and one K2 "
                             f"(without weight grads) an ode step at {ode_key}")
    if not math.isfinite(val["val_mse_in_t"]) or (gated and not 1 / MSE_FACTOR <= ratio <= MSE_FACTOR):
        raise AssertionError(f"{tag}: in-t MSE {val['val_mse_in_t']:.4e} is not within {MSE_FACTOR:g}x of the record "
                             f"{rec_in:.4e}")
    coords = loop.trainer.coords
    del loop, state
    shutil.rmtree(data)
    shutil.rmtree(log_dir)  # about 10 / 20 MB of checkpoint: the output directory stays small

    # (b) The restored state's ode step, its own K1 and K2 launch held and timed at the trained weights.
    trainer = MetaSGDTrainer(cfg0, *build_models(cfg0), coords, seed=cfg0.seed, device=str(dev))
    state = trainer.load_state(params, opt0)
    traj = torch.from_numpy(TEST_SPLITS[cfg0.dataset.name][:cfg0.dataset.batch_size]).to(dev)
    draws = resume_draws(cfg0, coords.shape[0], DRIFT_STEPS, SEED + 37)
    decoder, capture = trainer.decoder, CaptureDecode(trainer.decoder)
    trainer.decoder = capture
    trainer.ode_grads(state, traj, **draws[0])
    trainer.decoder = decoder
    args, g = capture.args, capture.g
    B, Z, C, I = args[0].shape
    label = f"{tag} ode step b={B} z={Z} c={C} I={I}"
    k1_nums = k1_bf16_check(cfg0, args, label)
    k2_nums = k2_bf16_check(cfg0, args, g, (False, True), f"{label} (its own cotangent)")
    del g, capture
    torch.cuda.empty_cache()

    # (c) The drift check, and the bf16 kernels' first-step loss against the plain compositions on the CPU and
    # more right bf16 evaluations, each through the step's own decode inputs (its loss: their decode's MSE).
    drift = drift_check(run, trainer, state, traj, draws)
    H, D = cfg0.nef.num_heads, cfg0.nef.num_hidden
    with torch.no_grad():
        first, dist = first_loss_sides(args, rollout_targets(traj, draws[0]["ode_masks"]), H, D,
                                       kernel=fused_decode_fwd(*args, num_heads=H, head_dim=D, compute_dtype=BF16))
    step_loss = drift["losses"]["ode"]["pallas"][0]
    if not abs(first["kernel"] / step_loss - 1) <= REL_L2_TOL:
        raise AssertionError(f"{tag}: the MSE of K1's decode at the captured inputs {first['kernel']:.9e} is not the "
                             f"ode step's loss {step_loss:.9e}")
    gates = first_loss_gates(f"{tag} first ode step's loss (bf16 K1 + K2)", first, dist)
    del args
    torch.cuda.empty_cache()

    # (d) Restored against fresh optimizer states.
    fresh = restored_vs_fresh(run, trainer, state, traj, draws[0])
    del trainer, state
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    log(f"[phase 37] {run} in {phase_s:.2f} s")
    entries = []
    # The resumed run_experiment's programs: K1 and K2 without weight gradients (its ode epochs take no dual step;
    # K2 with weight gradients is held and timed in (b) and printed there).
    for kernel, nums, tally, mode in (("K1", k1_nums, k1, ""), ("K2", k2_nums[False], k2, " without weight gradients")):
        by_shape = {f"b={k[1]} z={k[2]} c={k[3]} I={k[4]}" + (f" {'with' if k[5] else 'without'} weight grads" if kernel == "K2" else ""): v
                    for k, v in tally.items() if k[0] == BF16}
        launches = sum(by_shape.values())
        entries.append({
            "name": ("fused_decode_fwd" if kernel == "K1" else "fused_decode_bwd") + "_bf16",
            "shape": f"{run} resumed ({cfg0.dataset.name}) by run_experiment, timed at its ode step b={B} z={Z} c={C} "
                     f"I={I}{mode}",
            "route": "cuda", "source": f"enf_pde_tpu_torch/csrc/{KERNEL_SOURCE_BF16 if kernel == 'K1' else BWD_KERNEL_SOURCE_BF16}",
            "replaces": "enf_pde_tpu/ops/pallas_decode.py:" + ("548" if kernel == "K1" else "635"), "launches": launches,
            "launches_by_shape": by_shape, "max_abs_err": nums["max_abs_err"], "ms": nums["ms"], "plain_ms": nums["plain_ms"],
            "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"], "library_ms": None, "f32_ms": nums["f32_ms"],
            **({"design": nums["design"]} if "design" in nums else {})})
    return {"entries": entries, "epoch": epoch, "mse_in": val["val_mse_in_t"], "record_in": rec_in, "counts": counts,
            "drifts": drift["drifts"], "first": first, "gates": gates, "fresh": fresh,
            "seconds": phase_s}


def resume_phase_trained(dev) -> dict:
    """37. The trained runs of RESUME_RUNS trained on from their exports on the card (``resume_run_phase``),
    in at most RESUME_BUDGET_S."""
    t0 = time.perf_counter()
    res = {run: resume_run_phase(run, dev) for run in RESUME_RUNS}
    total = time.perf_counter() - t0
    log(f"[phase 37] {len(res)} runs resumed in {total:.2f} s (budget {RESUME_BUDGET_S:g} s): resumed from epoch "
        + " / ".join(str(r["epoch"]) for r in res.values())
        + "; in-t MSE / record " + ", ".join(f"{run} {r['mse_in']:.4e} / {r['record_in']:.4e}" for run, r in res.items()))
    if total > RESUME_BUDGET_S:
        raise AssertionError(f"phase 37 took {total:.2f} s, past its {RESUME_BUDGET_S:g} s")
    return res


def kernels_line(cfg, k1_timing, k2, sw, ablation, second, bf16, trained, resumed) -> list:
    """The kernels line: each program of K1 and K2 at the shapes it was held and timed at, with its
    launches at that shape (and mode) in the paths the script drove (PATH_LAUNCHES): the bf16
    programs on the YAMLs' ``pallas`` paths (phase 35's numbers), the f32 programs on the phases that
    ran ``pallas_interpret`` (6, 17, 22, 26, 27, 35; phases 4, 5, 17, 20 and 27's numbers); then K1's
    two programs on each trained run's paths (phase 36's entries: every launch of its decode, forecast
    and validation, by shape, timed at one of them); then the bf16 programs on each resumed run's path
    (phase 37's entries: K1's and K2's launches of its ``run_experiment``, by shape, timed at its ode
    step's shape). Fails unless every program
    was launched on a path and every listed entry has launches."""
    Zn, In = cfg.nef.num_latents, get_ca_invariant(cfg.nef).dim
    f32 = torch.float32
    entries = []

    def entry(kernel, dtype, shape, key, nums):
        bf = dtype == BF16
        src = (KERNEL_SOURCE_BF16 if bf else KERNEL_SOURCE) if kernel == "K1" else (
            BWD_KERNEL_SOURCE_BF16 if bf else BWD_KERNEL_SOURCE)
        launches = PATH_LAUNCHES[(kernel, dtype, *key)]
        if not launches:
            log(f"[kernels] {kernel} {'bf16' if bf else 'f32'} at {shape}: no launch on a path; not listed")
            return
        entries.append({
            "name": ("fused_decode_fwd" if kernel == "K1" else "fused_decode_bwd") + ("_bf16" if bf else ""),
            "shape": shape, "route": "cuda", "source": f"enf_pde_tpu_torch/csrc/{src}",
            "replaces": "enf_pde_tpu/ops/pallas_decode.py:" + ("548" if kernel == "K1" else "635"),
            "launches": launches, "max_abs_err": nums["max_abs_err"], "ms": nums["ms"], "plain_ms": nums["plain_ms"],
            "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"], "library_ms": None,
            **({"f32_ms": nums["f32_ms"]} if bf else {}), **({"design": nums["design"]} if "design" in nums else {})})

    b_fc, b_ode = NUM_SIGNALS * NUM_FRAMES, NUM_SIGNALS * cfg.dataset.traj_len_train
    ns = f"navier_stokes z={Zn} c=512"
    entry("K1", f32, f"{ns} b={b_fc} (pallas_interpret forecast and validation)", (b_fc, Zn, 512, In),
          k1_timing["forecast"])
    entry("K1", f32, f"{ns} b={b_ode} (pallas_interpret ode and dual steps)", (b_ode, Zn, 512, In),
          k1_timing["rollout"])
    for b in (second["b_nef"], NUM_SIGNALS):
        entry("K1", f32, f"navier_stokes num_layers={SA_LAYERS} z={Zn} c=512 b={b} (pallas_interpret nef step or fit)",
              (b, Zn, 512, In), second["k1"][b])
    for wg in (False, True):
        mode = f"{'with' if wg else 'without'} weight gradients"
        entry("K2", f32, f"{ns} b={b_ode} {mode}", (b_ode, Zn, 512, In, wg), {**k2["timing"][wg], "max_abs_err": k2["max_abs_err"]})
        entry("K2", f32, f"shallow_water b=10 z=8 c=2048 {mode}", (10, 8, 2048, 4, wg),
              {**sw["k2"]["timing"][wg], "max_abs_err": sw["k2"]["max_abs_err"]})
        entry("K2", f32, f"navier_stokes abs_pos b={b_ode} z={Zn} c=512 I=2 {mode}", (b_ode, Zn, 512, 2, wg),
              {**ablation["k2"]["timing"][wg], "max_abs_err": ablation["k2"]["max_abs_err"]})
    for b, wg in ((second["b_nef"], True), (NUM_SIGNALS, True), (NUM_SIGNALS, False)):
        entry("K2", f32, f"navier_stokes num_layers={SA_LAYERS} b={b} z={Zn} c=512 {'with' if wg else 'without'} "
                         "weight gradients", (b, Zn, 512, In, wg),
              {**second["k2"][b]["timing"][wg], "max_abs_err": second["k2"][b]["max_abs_err"]})
    for key, nums in bf16["timing"].items():
        kernel, name, over, b, c, *wg = key
        ccfg = shape_config(name, *over)
        Z, I = ccfg.nef.num_latents, get_ca_invariant(ccfg.nef).dim
        mode = f" {'with' if wg[0] else 'without'} weight gradients" if wg else ""
        entry(kernel, BF16, f"{name} {' '.join(over)} b={b} z={Z} c={c} I={I}{mode}".replace("  ", " "),
              (b, Z, c, I, *wg), nums)
    # Phases 36's and 37's entries, counted there.
    counted = [e for phase in (trained, resumed) for run in phase.values() for e in run["entries"]]
    entries += counted
    for kernel in ("K1", "K2"):
        name = "fused_decode_fwd" if kernel == "K1" else "fused_decode_bwd"
        for dtype in (BF16, f32):
            n = sum(v for k, v in PATH_LAUNCHES.items() if k[:2] == (kernel, dtype)) + sum(
                e["launches"] for e in counted if e["name"] == name + ("_bf16" if dtype == BF16 else ""))
            listed = sum(e["launches"] for e in entries if e["name"].startswith(
                "fused_decode_fwd" if kernel == "K1" else "fused_decode_bwd") and e["name"].endswith("_bf16") == (dtype == BF16))
            log(f"[kernels] {kernel} {'bf16' if dtype == BF16 else 'f32'}: {n} launches on the paths, {listed} at the "
                "listed shapes")
            if not listed:
                raise AssertionError(f"{kernel}'s {'bf16' if dtype == BF16 else 'f32'} program was launched no time "
                                     "at a listed shape on the paths")
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card.",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. Build: one nvcc per source, all started together.
    t0 = time.perf_counter()
    sources = (KERNEL_SOURCE, BWD_KERNEL_SOURCE, KERNEL_SOURCE_BF16, BWD_KERNEL_SOURCE_BF16)

    def timed_build(src):
        t = time.perf_counter()
        return cuda_lib.build(src), time.perf_counter() - t
    with ThreadPoolExecutor(len(sources)) as pool:
        lib_paths, nvcc_s = zip(*pool.map(timed_build, sources))
    for src in sources:
        cuda_lib.load(src)
    build_s = time.perf_counter() - t0
    for src, lib_path in zip(sources, lib_paths):
        ptxas = lib_path.with_name(lib_path.name.replace(".so", ".ptxas.txt"))
        # Registers and spills of every instantiation, and any wgmma that ptxas serialized (C7510, C7512, C7520).
        report = [ln.strip() for ln in ptxas.read_text().splitlines()
                  if any(w in ln for w in ("Used ", "spill", "C7510", "C7512", "C7520"))] if ptxas.exists() else []
        log(f"[build] {src} with nvcc -> {lib_path.name} in {nvcc_s[sources.index(src)]:.2f} s")
        for ln in report:
            log(f"[build] ptxas: {ln}")
    log(f"[build] {len(sources)} sources in {build_s:.2f} s")
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    cfg = load_experiment_config("navier_stokes")
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    coords = planar_coords(GRID, GRID)
    max_errs = []

    # 2. K1 against its plain version at full width: b=8, C=4096 with and without the tail;
    # the rollout decode shape b=80, c=512 and a ragged b=8, C=1000 with it.
    decoder, _ = build_models(cfg)
    reset_parameters(decoder, torch.Generator().manual_seed(SEED))
    decoder.to(dev)
    gen = torch.Generator().manual_seed(SEED + 1)
    b, Z = NUM_SIGNALS, cfg.nef.num_latents
    x = torch.from_numpy(coords)[None].expand(b, -1, -1).to(dev)
    p = (torch.rand(b, Z, 2, generator=gen) * 2 - 1).to(dev)
    a = (1 + 0.5 * torch.randn(b, Z, cfg.nef.latent_dim, generator=gen)).to(dev)
    w = torch.full((b, Z, 1), 1.0, device=dev)
    with torch.no_grad():
        args = decoder.kernel_inputs(x, p, a, w)
        out_k = fused_decode_fwd(*args, num_heads=H, head_dim=D)
        out_p = fused_decode_plain(*args, num_heads=H, head_dim=D)
        max_errs.append(check_close("K1 tail b=8 C=4096", out_k, out_p))
        no_tail = (*args[:7], ())
        out_k = fused_decode_fwd(*no_tail, num_heads=H, head_dim=D)
        out_p = fused_decode_plain(*no_tail, num_heads=H, head_dim=D)
        max_errs.append(check_close("K1 no-tail b=8 C=4096", out_k, out_p))
        rollout_args = decode_inputs(cfg, coords, dev, NUM_SIGNALS * cfg.dataset.traj_len_train,
                                     cfg.training.max_num_sampled_points, SEED + 6)
        ragged_args = decode_inputs(cfg, coords, dev, NUM_SIGNALS, 1000, SEED + 7)
        for label, kargs in (("b=80 c=512", rollout_args), ("b=8 C=1000 (ragged)", ragged_args)):
            max_errs.append(check_close(f"K1 tail {label}", fused_decode_fwd(*kargs, num_heads=H, head_dim=D),
                                        fused_decode_plain(*kargs, num_heads=H, head_dim=D)))
    torch.cuda.synchronize()
    del decoder, args, out_k, out_p, ragged_args

    # 3. The forecast end to end, at full width.
    ns_fc = forecast_phase(cfg, coords, smooth_frames(NUM_SIGNALS, GRID, SEED), "forecast")
    launches = ns_fc["launches"]
    dec, flat, xs, folded, chunk = (ns_fc[k] for k in ("dec", "flat", "xs", "folded", "chunk"))

    # 4. K1 at the forecast's launch shape and the rollout decode's: kernel against plain,
    # times, bounds; and the decode's PyTorch prologue (one weight fold per decode,
    # geometry per chunk).
    with torch.no_grad():
        fold_ms = cuda_ms(lambda: dec.fold(*flat), iters=5, warmup=1)
        split_ms = cuda_ms(lambda: shared_weights(folded[4]), iters=5, warmup=1)
        geom_ms = cuda_ms(lambda: dec.kernel_geometry(xs[:, :chunk], flat[0], flat[2]), iters=20)
        args = (*dec.kernel_geometry(xs[:, :chunk], flat[0], flat[2]), *folded)
        out_k = fused_decode_fwd(*args, num_heads=H, head_dim=D)
        max_errs.append(check_close("K1 tail b=160 c=512 (forecast launch shape)", out_k,
                                    fused_decode_plain(*args, num_heads=H, head_dim=D)))
        k1_timing = {}
        for label, kargs in (("forecast", args), ("rollout", rollout_args)):
            split = shared_weights(kargs[6])  # once per fold, as the forecast decode splits
            k_ms = cuda_ms(lambda: fused_decode_fwd(*kargs, num_heads=H, head_dim=D, split=split), iters=20)
            p_ms = cuda_ms(lambda: fused_decode_plain(*kargs, num_heads=H, head_dim=D), iters=5, warmup=1)
            bd = k1_bounds(cfg, kargs, out_k if label == "forecast" else
                           fused_decode_fwd(*kargs, num_heads=H, head_dim=D))
            k1_timing[label] = dict(ms=k_ms, plain_ms=p_ms, **bd)
            B, Zl, C = kargs[0].shape[:3]
            log(f"[timing] K1 at the {label} launch shape b={B} z={Zl} c={C}: {k_ms:.4f} ms "
                f"({bd['flops'] / k_ms / 1e9:.2f} TFLOP/s); plain {p_ms:.4f} ms; bound "
                f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} (f32 CUDA cores {bd['f32_ms']:.4f} ms, "
                f"3xTF32 tensor cores {bd['tc_ms']:.4f} ms, bytes {bd['bytes_ms']:.4f} ms: "
                f"{bd['flops'] / 1e9:.3f} GFLOP, {bd['moved'] / 1e6:.3f} MB); L2 weight bytes "
                f"per point {bd['l2_per_point'] / 1e3:.1f} KB; {k1_class_note(kargs, H, D, cfg.nef.num_out)}")
    log(f"[timing] decode prologue: weight fold {fold_ms:.4f} ms and split {split_ms:.4f} ms per decode, geometry "
        f"{geom_ms:.4f} ms per chunk x {launches} chunks; forecast decode total at K1's time "
        f"{k1_timing['forecast']['ms'] * launches:.3f} ms")
    for t in k1_timing.values():  # the f32 program's checks at Navier-Stokes width (phases 2 and 4)
        t["max_abs_err"] = max(max_errs)

    # 5-9. The training path: K2, the kernel-backend steps, the data, run_experiment, resume.
    del args, out_k, folded, flat, xs, ns_fc, rollout_args
    torch.cuda.empty_cache()
    k2 = k2_phase(cfg, coords, dev)
    max_errs.append(step_parity_phase(
        cfg, coords, smooth_trajectories(NUM_SIGNALS, TRAIN_FRAMES, GRID, SEED + 3), dev))
    torch.cuda.empty_cache()
    data_phase(dev)
    train = train_phase()
    resume = resume_phase()
    for wg, step in ((False, "ode"), (True, "dual")):
        k_ms, step_ms = k2["timing"][wg]["ms"], train["medians"][step]
        log(f"[timing] K2 {'with' if wg else 'without'} weight grads {k_ms:.4f} ms is "
            f"{100 * k_ms / step_ms:.1f} % of the {step} step's median {step_ms:.2f} ms")
    torch.cuda.empty_cache()

    # 10-12. The SE(2) planar experiments: K1 at their widths, data, training, forecast.
    planar = [
        planar_phase("diffusion_plane", dev, n_train=TRAIN_SIGNALS, n_test=VAL_SIGNALS, phases=[
            "nef", "nef+ode", "ode"], overrides=[
            f"dataset.num_signals_train={TRAIN_SIGNALS}", f"dataset.num_signals_test={VAL_SIGNALS}",
            "training.num_epochs=3", "training.nef.train_until_epoch=2", "training.ode.train_from_epoch=1",
            "training.ode.train_until_epoch=3", "test.test_interval=3", "test.test_dp_interval=3"]),
        planar_phase("cahn_hilliard", dev, n_train=NUM_SIGNALS, n_test=NUM_SIGNALS, phases=[
            "nef", "nef+ode"], overrides=[
            f"dataset.num_signals_train={NUM_SIGNALS}", f"dataset.num_signals_test={NUM_SIGNALS}",
            "training.num_epochs=2", "training.nef.train_until_epoch=2", "training.ode.train_from_epoch=1",
            "training.ode.train_until_epoch=2", "test.test_interval=2", "test.test_dp_interval=2"]),
    ]
    # 13. K1 past four latents at Navier-Stokes width, and at shallow_water's decode shape.
    repair = k1_repair_phase(dev)
    sw = repair["shallow_water"]
    log(f"[timing] K1 at shallow_water's decode shape (navier_stokes width, latent_dim 32, z=8, "
        f"160 x 2048): {sw['ms']:.4f} ms, plain {sw['plain_ms']:.4f} ms, bound {sw['bound_ms']:.4f} ms, "
        f"shared memory {sw['smem']} B; width class {sw['width_class']}, {sw['blocks_per_sm']} blocks an SM")
    torch.cuda.empty_cache()
    # 14-16. The heat equation on S^2: K1 at its widths, data, training, forecast.
    sphere = sphere_phase(dev)
    torch.cuda.empty_cache()
    # 17-19. Shallow water on S^2: K1 and K2 at its widths, data, training, super-resolution, forecast.
    sw = sw_phase(dev)
    for wg in (False, True):
        log(f"[timing] K2 {'with' if wg else 'without'} weight grads at shallow_water's ode shape "
            f"{sw['k2']['timing'][wg]['ms']:.4f} ms (bound {sw['k2']['timing'][wg]['bound_ms']:.4f}) against "
            f"{k2['timing'][wg]['ms']:.4f} ms at navier_stokes's (bound {k2['timing'][wg]['bound_ms']:.4f})")
    torch.cuda.empty_cache()
    # 20-22. The paper's baselines on phase 7's data: K1 and K2 at their shapes,
    # autodecoding (navier_stokes_nonmaml), and the non-equivariant abs_pos with the MLP ODE.
    ablation = ablation_kernel_phase(dev)
    nonmaml = nonmaml_phase(dev)
    abs_pos = abs_pos_phase(dev)
    # 23-25. Convection in the ball: K1 at its widths, the solver and its data on the card,
    # training with the ball equivariance check, the forecast.
    ihc = ihc_phase(dev)
    # 26-29. The rest of the decoder family: the self-attention stack behind K1 and K2, second
    # order through them, the slice end to end on phase 7's data (kept until here), the
    # ffn / polynomial embeddings and the transformer.
    attention = attention_phase(dev)
    second = second_order_phase(dev)
    sa_run = sa_train_phase(dev)
    options_phase(dev, sa_run["latents"])
    torch.cuda.empty_cache()
    # 30-33. The last modules: the solvers' remat, the multi-process paths, the prefetcher
    # (31 and 32 read phase 7's data) and the split-DFT solver.
    solvers = solvers_phase(dev)
    multi = multi_process_phase(dev)
    prefetcher_phase(dev)
    shutil.rmtree(DATA_DIR)  # phase 32 was its last reader: the output directory stays small
    split_fft_phase(dev)
    # 34. K2 at the narrow configs' widths through nef.backend=pallas.
    k2_configs_phase(dev)
    # 35. The bf16 programs at every launch shape of the paths above; the steps and forecast in both modes.
    bf16 = bf16_phase(dev)
    # 36. The repo's trained JAX runs served on the card: decode, forecast and validation on K1.
    trained = trained_phase(dev)
    # 37. Two of them trained on from their exports' optimizer states: run_experiment with resume, K1 + K2 bf16.
    resumed = resume_phase_trained(dev)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    kernels = kernels_line(cfg, k1_timing, k2, sw, ablation, second, bf16, trained, resumed)
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
