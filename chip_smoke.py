#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``pypmc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the fifteen CUDA kernels from ``pypmc_tpu_torch/csrc`` (one
   ``nvcc`` a source, all at once: the thirteen Pallas kernels',
   ``solve_dofs``, the dof bisection of the JAX package's PMC step, and
   ``draw_proposal_inputs``, the ``jax.random`` draws of its ``propose_T``,
   whose four instantiations must not spill) and ``fused_draw_transform``
   and ``fused_draw_transform_rng``, ``propose_T``'s draw and transform in
   one launch, each launcher's shared memory (and the
   chunked kernels' components a chunk, the statistics kernels' tile, the
   plan of the register pass of ``fused_vb_estep``, ``fused_is_pmc_step``
   and ``fused_pmc_stats``, the plans of the three draws ``fused_transform``,
   ``fused_transform_rng`` and ``fused_propose_logq``, the fused draws'
   and the pool's variant) against ``ops/_build.py``'s formula, the
   registers of the K-blocked statistics pass's, the step's first pass's
   and the dense register kernel's DMAX 8 and 16 instantiations (the last
   also its blocks an SM at K=10, D=10: at least 3), of every record
   instantiation of ``fused_logq``'s, ``fused_rho``'s, ``fused_maha``'s and
   the three draws' kernels and the fused draws' (DMAX 8 to 64) and of the
   pool's two variants (DMAX 8 to 64), which must not spill (nor, the record
   kernels, keep a stack frame), and the record kernels' blocks an SM at
   K=32, D=40 and K=200, D=10, the draws' at the flagship and at D=40
   (``fused_transform`` K=32, ``fused_transform_rng`` K=11,
   ``fused_propose_logq`` K=9 with a 2-component target, the fused draws
   at K=32 and K=11; at least 16 warps); the tiled kernels of
   ``fused_maha``, ``fused_logq``, ``fused_rho`` and ``fused_transform``,
   the bucket pass, the moves into and out of bucket order and the drawn
   products of ``fused_transform_rng`` and ``fused_propose_logq`` (no
   spill), their blocks an SM (the drawn products' at least 2 with row
   tile 0's panels past D=128), their election and the bucket pass's plan
   and scratch layout against ``_build``; the Gram pass
   of ``fused_pmc_stats``, ``fused_is_pmc_step`` and ``fused_vb_estep``
   (``gram_stats_kernel``, a mode each, two instantiations a mode, no
   spill; its plan and blocks an SM at ``GRAM_SHAPES``); ``fused_maha``'s
   tensor-core kernel (``maha_mma_kernel``, D padded to 8 from 8 to 64:
   registers, no spill; its plan against ``_build.mma_plan`` to D=64 at K
   to 2,040, two blocks an SM at ``MAHA_TIME_SHAPES``' largest K), its
   tensor-core kernel past D=64 (``maha_mma_tiled_kernel`` and
   ``mma_split_kernel``: registers, no spill, one block of 8 warps an SM;
   its plan and split operand against ``_build.mma_tiled_plan`` and
   ``mma_scratch_floats``), ``fused_logq``'s and ``fused_rho``'s on the
   same walk (``logq_mma_tiled_kernel``, ``rho_mma_tiled_kernel``: no
   spill, one block an SM) and the three rows'
   election against ``_build.eval_variant``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the flagship shapes (K=10, D=10, N=2^20; K_target=2) and at the edges
   (K=1, D=1, D=7, D=32, odd N, a dead component, zero weights, Gaussian
   and Student-t, lower and upper ``fused_maha`` operands, each through
   its record and tensor-core kernels (the tiled one below D=65 at
   ``MAHA_TILED_SEED``'s case), equal on a second run, and
   at the JAX rule's largest K at D=17, 20 and 64, ``MAHA_CASES``; the
   tensor-core kernels' NaNs and infinities the FP32 arithmetic's, to D=200, the tiled
   kernel's past D=64 too; ``evaluation_nonfinite_case``: every kernel of
   ``fused_logq`` and ``fused_rho`` at D=20, 40, 96 and 200 gives the plain
   version's NaN, +inf and -inf on particles with an infinite, a NaN and a
   1e20 coordinate), and past the
   register kernels (D=40 and D=128, the looped instantiation) and past
   shared memory (operands read from device memory, or, by ``fused_logq``
   and ``fused_maha``, streamed in chunks: K=60, D=32 and K=1, D=128), at
   the pipeline's K=32, D=40, at the K=200, D=10 log-likelihood, and at
   D=33 and D=64, the lower end of the DMAX 40 record kernel and the upper
   end of the DMAX 64 one; the statistics kernels at K=120, D=1, where
   their tile is 64 particles; the six kernels past D=128 at (K=1,
   D=129), (K=2, D=200) and (K=1, D=1000); the four tiled kernels past D=64
   (``TILED_CASES``: K=1 and the JAX rule's largest K at D=65, 96, 128,
   129 and 200, K=1 at D=1000 and 2040): each against its float64 plain
   version, counted as tiled (``fused_maha``, ``fused_logq`` and
   ``fused_rho`` as their tensor-core kernels, ``fused_maha`` with lower,
   upper and full operands, the tiled kernels forced beside them), equal on
   a second run, ``fused_rho``'s log q ``fused_logq``'s bit for bit on each
   kernel, ``fused_transform``'s tiled pair equal to
   its looped kernel bit for bit to D=128 (components drawn by weight, a
   dead component's bucket empty) and its bucket pass's positions,
   permutation and tiles equal to ``_build.transform_tiles``' (also at
   ``BUCKET_CASES``, to N=2^22, latents outside [0, K) left out); the drawn
   products of
   ``fused_propose_logq`` and ``fused_transform_rng`` (``DRAWN_CASES``:
   K=1 and the rule's largest K + Kt at D=65, 96, 128, 129, K=1 at D=200
   and 248): counted as tiled, x and latent equal to the looped kernel's
   bit for bit to D=128, the seed from a tensor the words by value's, log
   q and log p within float32 tolerance of float64 and ``fused_logq``'s bit
   for bit, their samples in distribution;
   ``fused_vb_estep`` and ``fused_is_pmc_step`` at the edges of their
   register pass's plan (K=16 and 17 at D=10, D=11 and 16, K=128 at D=1,
   and K=137 at D=1 on the entry table), each where the register pass is
   elected also through its entry-table pass (the step: the same particles
   and weights bit for bit, a Student-t target's too), and
   ``fused_vb_estep`` on a NaN and an infinite coordinate (the register
   pass at K=10, D=10 and the Gram pass at K=4, D=20, each beside the
   entry table);
   ``fused_pmc_stats`` on both passes where the register pass is elected
   (a second run equal, a dead component's statistics 0) and on a NaN
   coordinate or weight (NaN where the plain version's are; also on the
   Gram pass at K=4, D=20); ``fused_pmc_stats``, ``fused_is_pmc_step`` and
   ``fused_vb_estep`` past D=16 on the Gram pass (``GRAM_CASES``: K D <=
   128 from (7, 17) to (1, 128), N=1024, 1025 and 2^20, one and two target
   components, Gaussian and Student-t, dof_stats on and off, and (6, 20)
   at 10^7, ``fused_vb_estep`` to 2^20 on the proposal's VB operands with a
   third of the weights 0): counted as gram, against the float64 plain
   version, a second run equal, the entry table forced beside it, the
   step's x and latent the entry table's bit for bit and, to D=64, its w
   ``fused_is_pmc_step_blocked``'s bit for bit.
   ``fused_transform`` on given
   normals, components and scales (K=10, D=10, N=2^22; K=16 and K=32,
   D=40), its record kernel equal to the looped kernel bit for bit (K=32,
   D=40, N=2^20, Gaussian and Student-t scales; the flagship; D=1, 33 and
   64; K=40, D=40 with the records read from device memory);
   ``fused_propose_logq``'s and ``fused_transform_rng``'s record kernels
   equal to their looped kernels bit for bit on every output, the outputs
   that differ counted (the flagship, Gaussian and Student-t, without a
   target, a dead component, odd N, D=1, 7, 33, 40, 62 and 64, the records
   read from device memory; ``DRAW_VARIANT_CASES``,
   ``TRANSFORM_RNG_VARIANT_CASES``).  The random
   kernels are checked on their own samples: the plain
   version recomputes every deterministic output from them, and the
   samples' moments, component frequencies, seed determinism and dead
   components are tested.  ``fused_mcmc_pool``, each check with either
   variant forced (a thread a chain, a warp a chain): its invariants (last
   point = final state, final log-density = the float64 plain log-density
   there, a NaN chain never moves; also at the pipeline's C=32, D=40, 400
   steps), its pooled moments and acceptance against the plain pool, and at
   the pipeline's D=40 with a full proposal factor a chain its whitened
   steps against the plain pool's, with the faults the checks must catch
   planted in the plain pool; over one step the two variants' proposals,
   accept decisions and points agree.  A per-point target that
   reaches ``fused_logq``, mapped with ``torch.func.vmap``, is one launch.
   ``solve_dofs`` at K=10, 200 and 400, in float32 and float64, on
   constants with a NaN, both infinities and one past each clamp: against
   its plain version in its dtype (the roots equal bit for bit counted;
   the clamped, NaN and infinite entries equal) and in float64 (each root
   within ``DOF_ULPS`` ulps of the float64 condition's zero); its warp
   kernel (the default), its serial kernel (``variant="serial"``) and the
   plain version in the same dtype equal bit for bit at 0, 1, 5, 7 and 100
   steps.  Each kernel that draws from a seed (``fused_propose_logq``,
   ``fused_transform_rng``, ``fused_is_pmc_step``,
   ``fused_is_pmc_step_blocked``, ``draw_proposal_inputs`` in float32 and
   float64; every variant that draws) with its two words in a tensor on
   the card against the words by value, every output bit for bit; one
   launch of ``fused_is_pmc_step``, ``fused_transform_rng`` and
   ``draw_proposal_inputs`` each captured as a CUDA graph, replayed with two
   seeds in its tensor, draws each seed's particles.
   ``draw_proposal_inputs`` against its plain version in distribution
   (``DRAW_CASES``: the pipeline's K=32, D=40 Student-t draw, K=1, dead
   components, float32 and float64): both draws' components against the
   weights (a dead one never drawn), their normals' moments and a KS test
   against the normal law, ``dof / scale^2`` against the chi-square law,
   each other's frequencies and (two-sample KS) normals and chi-squares;
   without normals the same components.  ``fused_draw_transform`` and
   ``fused_draw_transform_rng`` (``FUSED_DRAW_CASES``: ``DRAW_CASES``'
   shapes in float32, D=8, 16, 40 and 64, the records staged and read from
   device memory, Gaussian and Student-t, dead components) each equal to
   the two launches it replaces (``draw_proposal_inputs``, then
   ``fused_transform`` or ``fused_transform_rng``) bit for bit, xT and
   latent, the seed by value and by pointer, and on its own draws beside
   its plain version's; a graph of one launch replayed with two seeds draws
   each seed's two launches' particles;
4. slice: ``pmc_run_sharded`` at the ``examples/pmc_large_scale.py``
   configuration (10^7 particles a step, 10 steps), then 2 steps with
   ``weight_clip=True``, with the kernels' launch counts read around the
   two runs (every ``fused_is_pmc_step`` and ``fused_pmc_stats`` launch on
   its register pass, every ``fused_propose_logq`` launch on its record
   kernel, one ``solve_dofs`` launch a Student-t update); then the step
   with the dofs solved by the host loop of before (the plain version on
   the card) and by ``solve_dofs``, in turns: host ms, device ms and
   launches a step;
   scan: ``pmc_run_sharded(scan_steps=True)`` against ``scan_steps=False``
   in turns (loop, scan, scan, loop, after the scan's warm-up and capture)
   at the slice, its ``--components 200`` (the K-blocked step), the slice
   at 2^16 particles, ``examples/pmc_sharded.py``'s configuration (1001
   particles), a D=40 step of 1000 particles past ``fused_propose_logq``'s
   rule, the D=40 pipeline's PMC stage (K=32 Student-t, 2^20 particles,
   10 steps; ``pmc_stage_problem``), the 2^16 slice in float64 and the
   wide path's D=200 step (``WIDE_PATH``: ``fused_rho`` and
   ``fused_transform`` tiled): every
   run bit for bit the first loop's, the launches equal, the steps replayed
   as CUDA graphs with no fallback and no warning; host ms a step both ways,
   device ms a step (torch.profiler) and the peak memory of the loop, the
   capture and a replay;
5. vb: ``GaussianInference`` at the ``benchmarks/vb_step.py``
   configuration (N=2^22, K=10, D=10, float32) for 50 iterations with
   pruning (every ``fused_vb_estep`` launch on its register pass), one
   iteration against its float64 plain version, with the launch counts read
   around the run;
6. gate: the size gate routes as the JAX package does.  A K=30, D=10
   Student-t ``pmc_update`` (K*D > 128) runs its unfused path through
   ``fused_rho`` and ``fused_maha`` and matches the float64 update, and a
   forced ``fused="dense"`` raises; a D=40 ``mixture_logpdf_T`` runs
   ``fused_logq`` and a K=400, D=10 one its unfused path, each against
   float64; a K=400 update of 2^22 particles, where the JAX package elects
   its K-blocked kernel, runs ``fused_pmc_stats_blocked``; float64
   CUDA tensors through ``pmc_update``, ``GaussianInference``,
   ``pmc_run_sharded`` and the chain pool (``sample_adaptive_chains``)
   take the unfused path, every refusal counted, each against the same
   call in float64 on the CPU to 1e-10 (``float64_entry_points``);
   blocked: the three K-blocked kernels against their float64 plain
   versions (K=400, D=2; K=200, D=10; a ragged last chunk; K=96, D=40; K=3,
   D=128 with the operands in device memory; D=14 in three row bands), the
   dense and K-blocked twins
   at K=12, D=10 (the same particles from the same seed words), then the
   large-mixture path through the entry points with the launch counts read
   around each: ``benchmarks/blocked_stats.py``'s K=400, D=2 updates of
   2^23 particles (Gaussian and Student-t) against the unfused update,
   ``benchmarks/vb_step.py --components 400 --dim 2`` (N=2^22), and
   ``examples/pmc_large_scale.py --components 200`` (D=10, 10^7 particles
   a step, 10 steps), its step also with the dofs by the host loop and by
   ``solve_dofs``, in turns;
7. routes: ``propose_logq_T`` with a 2-component target draws at D=40
   through ``fused_draw_transform_rng`` at K=11 and
   ``fused_draw_transform`` at K=16 (one launch each) and on the tensor
   path below 1024 particles (after one ``draw_proposal_inputs`` launch),
   at D=80 through ``draw_proposal_inputs`` and ``fused_transform_rng`` at
   K=4 (its drawn product), ``fused_transform`` at K=16 (its tiled pair); a per-point target
   through ``fused_maha`` and one through ``fused_rho``, mapped over 2^16
   points with ``torch.func.vmap``: one launch each, no warning, equal to
   the batched call;
   wide: ``pmc_run_sharded`` at ``WIDE_PATH`` (D=200, K=4, Kt=2, 2^16
   particles, 5 steps): every ``fused_logq``, ``fused_rho`` and
   ``fused_transform`` launch tiled, each step's log q, log p and
   responsibilities against float64, ms a step and the step's device time
   by kernel; a ``GaussianInference`` fit at D=200 (one tiled
   ``fused_maha`` an iteration, its first against float64 on the CPU);
   wide_is: (a) ``ImportanceSampler.run`` of one Student-t (dof 5) at
   D=200, 2^20 particles, against ``WIDE_PATH``'s target (log q against
   float64, ms a run, device ms and row 5's share in a fresh process,
   ``chip_smoke.py --wide-is-profile``), (b) ``pmc_run_sharded`` at D=96,
   K=3 Student-t, Kt=1, 2^16, 5 steps, as phase scan's cases (with and
   without ``scan_steps=True``, bit for bit), (c)
   ``MixtureDensity.propose`` of a K=1 Student-t at D=200 and a K=2
   Gaussian at D=128, 2^20 draws; every ``fused_propose_logq`` and
   ``fused_transform_rng`` launch tiled;
   wide_pmc: PMC past D=16 on the Gram pass (``WIDE_PMC``): (a)
   ``pmc_run_sharded`` with one Student-t (dof 5) at D=128 against one
   Gaussian component (the JAX rule's largest target there), (b) six at
   D=20 against a two-component target, 2^20 particles, 5 steps, each with
   and without ``scan_steps=True`` (bit for bit, replayed; host and device
   ms a step, each kernel's share), every step's ``fused_is_pmc_step``
   launch counted gram and no plain route; (c) an
   ``ImportanceSampler.run`` of 2^20 at D=128 on a per-point callable
   target, then ``PMC(...).run(1)``, its ``fused_pmc_stats`` launch gram
   and its update against the unfused one in float64;
   wide_vb: ``GaussianInference(...).run`` past D=16 on the Gram pass
   (``WIDE_VB``): (a) ``benchmarks/vb_step.py --dim 20 --components 6``'s
   data and (b) its ``--dim 40 --components 3``, 2^22 points, 10
   iterations, prune off; (c) wide_pmc (c)'s importance samples and weights
   at D=128 into a fit seeded by its proposal, 5 iterations, as the
   pipeline's ``is1_vb2``; each fit's first iteration against the float64
   plain version, every ``fused_vb_estep`` launch gram and no plain route,
   its operands held in float32; host and device ms an iteration, the busy
   share, the launches;
8. mcmc: ``sample_adaptive_chains`` at ``benchmarks/mcmc_chains.py``'s
   fused configuration (C=16384, D=10, 500 steps x 4 cycles), chain-steps
   a second, and the pool's variant the entry point elects there;
9. pipeline: ``pipeline.integrate`` at ``benchmarks/accuracy_highdim.py
   --dim 40 --is-samples 4194304`` (evidence error under 1%, ESS above
   0.15, one ``fused_mcmc_pool`` launch a cycle, the pool's variant it
   elects, the PMC draws through ``fused_draw_transform`` with no
   ``fused_transform`` or ``draw_proposal_inputs`` launch, every
   ``fused_propose_logq`` launch on its record kernel, every
   ``fused_maha`` launch on the kernel it elects at D=40, counted by
   variant), VB1's and VB2's
   iterations (the profiled rerun's
   with the VB E-step's route before the float32 stopping rule's repair)
   and the
   callable-target run of ``tests/test_pipeline_api.py``;
10. parallel: the particle mesh over ``torch.distributed``, in rank
    processes (``chip_smoke.py --parallel-worker``) that load the kernels
    the build phase built: (a) one rank on the card in a one-rank NCCL
    group, (b) two ranks sharing the card over gloo, each rank under a
    time limit (both killed when one runs out).  Each rank drives, between
    a reset and a read of its launch counts, ``pmc_run_sharded(mesh=)`` at
    the slice's configuration (then 2 ``weight_clip`` steps; (b) also a
    total of 10^7 + 1), ``ParallelSampler`` with the adapted flagship
    proposal (4 runs of 2^22 particles in all, 2 left on the device, then
    ``evidence_stats`` and ``gather``), ``GaussianInference(mesh=)`` at
    the vb phase's configuration, rank-0-only checkpoints and
    ``integrate(mesh=)`` at the pipeline phase's configuration (evidence
    error under 1%, ESS above 0.15); rows 1, 5, 7, 8 and 9 must launch on
    every rank, with every tensor handed to a kernel on cuda:0.  The PMC
    run again with ``scan_steps=True``, twice, bit for bit the loop's: (a)
    its CUDA graphs replayed or the fallback's cause printed, (b) the
    counted fallback with one warning on each rank, alike.  (a) equals
    ``mesh=None`` bit for bit (the PMC run, VB) and traces one step with
    ``profiling.trace`` (its ``pmc_step`` range and ``dense_reg_kernel``);
    (b) holds the all-reduced float64 update of two halves to one rank's
    (1e-12), VB to one rank on all the data (N_comp to 1e-5, the bound to
    1e-6), and the two ranks' results to equal sha256 digests.  It prints
    each rank's ms a PMC step, a ``ParallelSampler.run`` and a VB
    iteration and the gather's seconds (host clock, ``profiling.timed``);
11. examples: first the chain loops of ``markov_chain.py``, ``r_group.py``
    and ``uniting_markov_chains_and_variational_bayes.py`` at a shortened N
    as CUDA graphs (``sampler._scan``) and as the eager loop, in turns:
    the same outputs bit for bit, the same launches, us a chain-step each;
    then every file of ``examples_torch/`` at the published size of
    its ``examples/`` counterpart, through its ``main()`` in a temporary
    working directory, between a reset and a read of the launch counts
    (``pmc_large_scale.py`` at 10^7 particles, K=10 and ``--components
    200``; ``pmc_sharded.py``; ``pmc.py``; ``integrate_evidence.py`` at
    D=20; ``uniting_markov_chains_and_variational_bayes.py``;
    ``variational.py``; ``mixture_reduction.py``; ``r_group.py``;
    ``markov_chain.py``), each held to the expectations its JAX
    counterpart prints, each dispatch of its path at its shapes to the
    size gate (the kernel launched where the gate elects it, the plain
    route counted where it refuses), every tensor a kernel took on cuda:0,
    and the first launch of each shape (its arguments kept, at most 2^20
    particles) run again against the float64 plain version on the same
    inputs (the draws on their own particles, and their record kernel
    against the looped one bit for bit); ``variational.py`` and
    ``mixture_reduction.py`` also against the same runs in float64 on the
    CPU (the same survivors and steps, parameters and VBMerge's bound
    within ``TOL["vb"]``); the chains of the three examples above replayed
    as CUDA graphs (no fallback; ``r_group.py`` one ``fused_logq`` launch
    a chain-step), ``variational.py`` converged (and its fit with the
    route before the repair printed beside); then ``launch_2proc.py --particles 100000 --steps
    3``, two gloo ranks sharing the card, with equal digests.  Each
    example's output goes to ``build/examples/``; the phase prints a
    line an example (wall seconds, launches, key numbers);
12. times: each kernel and its plain version, with CUDA events, beside
    the least time the card could take (``bound``), the entry-table pass
    of ``fused_vb_estep``, ``fused_is_pmc_step`` and ``fused_pmc_stats``
    beside their elected one, the three draws' looped kernels beside their
    record kernels, ``fused_maha``, ``fused_logq``, ``fused_rho`` and the
    draws also at the shapes the main paths give them (K=32, D=40, N=2^20;
    K=200, D=10, N=10^7; ``fused_propose_logq`` K=9, D=40 with a
    2-component target and ``fused_transform_rng`` K=11, D=40 at N=2^20),
    the pool's two variants
    at the pipeline's shape (C=32, D=40, a 2-component target, 400 steps),
    the mcmc phase's (both variants on each side of the cut-offs of their
    election, ``POOL_SWEEP``: ``chip_smoke.py --pool-sweep``), the six
    kernels past D=128 at K=1, D=200, N=2^16, the four tiled kernels at
    ``TILED_SHAPES`` (K=1 and the rule's largest K at D=65, 96, 128 and
    200, the wide path's K=4 at D=200), each held to its float64 plain
    version, and ``fused_logq``'s and ``fused_rho``'s tensor-core and tiled
    kernels timed there (in turns with their plain versions and
    ``torch.bmm``, and in CUDA graphs; ``fused_maha``'s and
    ``fused_transform``'s, and its looped kernel and bucket pass:
    ``chip_smoke.py --tiled-times`` runs all four alone, ``--elected-times
    DIR`` times the kernels a checkout elects there, such as an earlier
    commit's, ``--transform-split`` fused_transform's pair with its moves
    left out), and the device time of each launch of the K-blocked kernels
    (torch.profiler, in a fresh process: ``chip_smoke.py
    --blocked-splits``), the first launch also beside its bound;
    ``solve_dofs``'s warp and serial kernels (CUDA events, and device time
    by torch.profiler in that fresh process) and its plain version at K=10,
    200 and 400; ``fused_transform_rng`` with its seed from a tensor;
    ``draw_proposal_inputs`` at K=32, D=40, N=2^20 (Student-t, float32 and
    float64, and the components only) beside its plain version; the two
    fused draws at K=32 and K=11, D=40, N=2^20 and K=10, D=10, N=2^22, each
    in turns with the two launches it replaces (the SASS instructions of
    the DMAX 40 record draws and of ``draw_kernel``, ``cuobjdump``, as an
    issue floor, and from them the draw's floor a normal at K=1, D=200:
    ``chip_smoke.py --draw-floor``).  Each part prints its seconds
    (``times part``); ``--moved-times`` runs the timings the default run
    leaves to these flags, each with its seconds.
    ``chip_smoke.py --drawn-times`` times the drawn products at
    ``DRAWN_SHAPES`` beside the looped kernels, the composition of other
    rows' launches and the plain versions and the ``torch.bmm`` yardsticks
    of rows 1-3 and 6 at their first shapes (``--library-times K,Kt,D,N
    ...`` the yardsticks alone at the shapes given); ``chip_smoke.py
    --gram-times`` times rows 7-9 at ``GRAM_TIME_SHAPES`` (the Gram pass,
    the entry table and the plain version in turns, beside the bound;
    phase times holds them to float64 there);
    ``--elected-times DIR [drawn]`` the kernels a checkout elects there;
    ``chip_smoke.py --maha-times`` times ``fused_maha``'s tensor-core,
    record and tiled kernels, ``torch.bmm`` and the plain version in turns
    at ``MAHA_TIME_SHAPES`` (each DMAX bucket of the record instantiations
    at K=1 and the JAX rule's largest K, and the pipeline's K=32 at D=40;
    also in CUDA graphs, device times) beside both bounds, and counts the
    tensor-core kernel's SASS (phase times runs K=32, D=40), then, past
    D=64, its tensor-core and tiled kernels and ``torch.bmm``, device
    times, at ``MAHA_WIDE_SHAPES`` (``TILED_SHAPES`` and K=1 at D=1,000
    and 2,040; ``--maha-times wide`` these alone);
    ``--parent-draws DIR`` holds the drawn products to the kernels DIR
    elects past D=128 (an earlier commit's warp kernels) bit for bit,
    ``--parent-tiled DIR`` the tiled kernels of rows 1-3, forced, to DIR's
    bit for bit on finite particles, ``--nonfinite DIR`` reports
    ``evaluation_nonfinite_case`` in DIR's checkout, and ``--wide-times
    DIR`` prints the wide paths' device ms there (a fresh process).

Each phase from kernels on prints its seconds (host clock) when it ends.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

import contextlib
import copy
import ctypes
import json
import math
import re
import subprocess
import sys
import time

import numpy as np

N_FLAGSHIP = 1 << 20
N_ODD = 1_000_003
N_WIDE = 100_003        # the wide cases: a plain version's (K, D, N) float64 grows with K D
N_SLICE = 10_000_000
STEPS = 10
N_PLAIN_MAX = 1 << 22   # a plain version's (K D, N) intermediates grow with N
N_BENCH = 1 << 26       # bench.py's batch for the propose step
SOURCES = {
    "fused_logq": ("pypmc_tpu_torch/csrc/logq.cu", "pypmc_tpu/ops/pallas_kernels.py:788"),
    "fused_propose_logq": ("pypmc_tpu_torch/csrc/propose_logq.cu",
                           "pypmc_tpu/ops/pallas_kernels.py:924"),
    "fused_pmc_stats": ("pypmc_tpu_torch/csrc/pmc_stats.cu",
                        "pypmc_tpu/ops/pallas_kernels.py:1150"),
    "fused_is_pmc_step": ("pypmc_tpu_torch/csrc/is_pmc_step.cu",
                          "pypmc_tpu/ops/pallas_kernels.py:1336"),
    "fused_maha": ("pypmc_tpu_torch/csrc/maha.cu", "pypmc_tpu/ops/pallas_kernels.py:858"),
    "fused_rho": ("pypmc_tpu_torch/csrc/rho.cu", "pypmc_tpu/ops/pallas_kernels.py:826"),
    "fused_vb_estep": ("pypmc_tpu_torch/csrc/vb_estep.cu",
                       "pypmc_tpu/ops/pallas_kernels.py:1493"),
    "fused_transform": ("pypmc_tpu_torch/csrc/transform.cu",
                        "pypmc_tpu/ops/pallas_kernels.py:1014"),
    "fused_transform_rng": ("pypmc_tpu_torch/csrc/transform.cu",
                            "pypmc_tpu/ops/pallas_kernels.py:881"),
    "fused_mcmc_pool": ("pypmc_tpu_torch/csrc/mcmc_pool.cu",
                        "pypmc_tpu/ops/pallas_kernels.py:2293"),
    "fused_pmc_stats_blocked": ("pypmc_tpu_torch/csrc/pmc_stats_blocked.cu",
                                "pypmc_tpu/ops/pallas_kernels.py:1779"),
    "fused_vb_estep_blocked": ("pypmc_tpu_torch/csrc/vb_estep_blocked.cu",
                               "pypmc_tpu/ops/pallas_kernels.py:1889"),
    "fused_is_pmc_step_blocked": ("pypmc_tpu_torch/csrc/is_pmc_step_blocked.cu",
                                  "pypmc_tpu/ops/pallas_kernels.py:2067"),
    # no Pallas kernel: the lax.fori_loop of the JAX package's _solve_dofs
    "solve_dofs": ("pypmc_tpu_torch/csrc/solve_dofs.cu", "pypmc_tpu/mix_adapt/pmc.py:349"),
    # no Pallas kernel: jax.random in the JAX package's propose_T
    "draw_proposal_inputs": ("pypmc_tpu_torch/csrc/draw.cu", "pypmc_tpu/density/core.py:293"),
    # propose_T's draw and transform in one launch (D <= 64): jax.random
    # there, then the transform of pallas_kernels.py:1014 or :881
    "fused_draw_transform": ("pypmc_tpu_torch/csrc/draw.cu", "pypmc_tpu/density/core.py:293"),
    "fused_draw_transform_rng": ("pypmc_tpu_torch/csrc/draw.cu",
                                 "pypmc_tpu/density/core.py:293"),
}
# the Pallas kernel each fused draw also takes the place of
FUSES = {"fused_draw_transform": "pypmc_tpu/ops/pallas_kernels.py:1014",
         "fused_draw_transform_rng": "pypmc_tpu/ops/pallas_kernels.py:881"}
# |kernel - plain| <= ATOL + RTOL * max|plain| per output; the plain
# version runs in float64 on the kernel's float32 inputs, so the bound is
# the kernel's own float32 rounding.  "maha": D-term FP32 dot products,
# ~D eps of the distance; "rho": exp of a log-density difference good to
# "log"'s 2e-3 at the far tail; "vb": a VB iteration's statistics, means,
# scatter matrices and bound, float32 particle work reduced in float64,
# and the same for the converged fits and reductions of
# examples_torch/variational.py and mixture_reduction.py against their
# float64 runs on the CPU; "f64": a float64 entry point on the card (the
# unfused path, float64 tensor code and the float64 kernels) against the
# same call in float64 on the CPU, summed in another order
TOL = {"log": (2e-3, 1e-5), "w": (0.0, 1e-3), "stats": (1e-6, 1e-4),
       "update": (1e-4, 1e-3), "dof": (0.0, 1e-2), "maha": (1e-5, 1e-5),
       "rho": (2e-3, 0.0), "vb": (0.0, 1e-5), "pool": (1e-3, 0.0), "f64": (0.0, 1e-10)}
# Where an example hands a statistics kernel inputs that float32 cannot
# resolve as the cases' can (examples_torch/variational.py's first VB
# E-step: const = -2.95e5 for every component, so log rho keeps ~0.03 of
# absolute rounding), the plain version run in float32 on the same inputs
# is itself off by more than TOL: the kernel, whose sums run in another
# order, may be off by F32_ERRORS times as much (phase examples' replays)
F32_ERRORS = 4.0
VB_N, VB_K, VB_D, VB_ITERS = 1 << 22, 10, 10, 50


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def kernel_launches(counts):
    """The launches and plain routes of a launch_counts() dict, without its
    variant counts (each launch of a kernel with two variants counts once
    more under its variant)."""
    return sum(n for name, n in counts.items() if not name.startswith("variant:"))


def sync(device):
    """Bring a fault of a launch to light where it happened."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


# --------------------------------------------------------------------- #
# problem construction                                                  #
# --------------------------------------------------------------------- #

def random_mixture(rng, K, D, student_t, dead=False, spread=2.0):
    """(means, covs, weights, dofs) as float32 numpy arrays."""
    means = rng.normal(0, spread, (K, D))
    a = rng.normal(0, 0.3, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    w = w / w.sum()
    dofs = rng.uniform(6.0, 12.0, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(np.float32)
    return cast(means), cast(covs), cast(w), cast(dofs)


def make_params(arrs, device):
    import torch
    from pypmc_tpu_torch.density import core

    means, covs, w, dofs = arrs
    params, valid = core.make_mixture(
        torch.tensor(means, device=device), torch.tensor(covs, device=device),
        torch.tensor(w, device=device),
        None if dofs is None else torch.tensor(dofs, device=device))
    require(bool(valid.all()), "test mixture is not positive definite")
    return params


def flagship_problem(device, K=10):
    """The examples/pmc_large_scale.py configuration in float32 (its
    ``--components`` is K)."""
    D = 10
    rng = np.random.default_rng(0)
    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0]).astype(np.float32)
    t_covs = np.array([np.eye(D) * 0.8, np.eye(D) * 1.2]).astype(np.float32)
    means = rng.normal(1.5, 3.0, size=(K, D)).astype(np.float32)
    covs = np.array([np.eye(D) * 6.0] * K).astype(np.float32)
    dofs = np.full((K,), 8.0, dtype=np.float32)
    target = make_params((t_means, t_covs, np.array([0.3, 0.7], np.float32), None), device)
    params = make_params((means, covs, np.full((K,), 1.0 / K, np.float32), dofs), device)
    return params, target, t_means


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions                         #
# --------------------------------------------------------------------- #

def compare(name, got, ref, kind, report, ref32=None):
    """|got - ref| <= atol + rtol * max|ref|; records and prints the error.
    With ``ref32``, the plain version's float32 outputs on the same inputs,
    the bound also admits F32_ERRORS times that version's own error."""
    import torch

    atol, rtol = TOL[kind]
    got = got.double()
    require(bool(torch.isfinite(got).all()), "%s: non-finite kernel output" % name)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    bound = atol + rtol * scale
    if ref32 is not None:
        bound += F32_ERRORS * float((ref32.double() - ref).abs().max())
    print("  %-34s max_abs_err %.3e  tol %.3e" % (name, err, bound))
    report.append({"output": name, "max_abs_err": err, "tol": bound})
    require(err <= bound, "%s: error %.3e above tolerance %.3e" % (name, err, bound))


def mixture_moments(arrs):
    """Mean and covariance of a Gaussian / Student-t mixture."""
    means, covs, w, dofs = [None if a is None else a.astype(np.float64) for a in arrs]
    scale = np.ones_like(w) if dofs is None else dofs / (dofs - 2.0)
    mean = w @ means
    second = np.einsum("k,kij->ij", w, covs * scale[:, None, None]
                       + np.einsum("ki,kj->kij", means, means))
    return mean, second - np.outer(mean, mean)


def check_samples(name, xT, latent, arrs, report):
    """Moments against the mixture's (6 sigma Monte Carlo bounds on the
    mean and on every entry of the covariance), component frequencies
    against the weights (chi-square test), and no draw of a dead
    component."""
    from scipy import stats as st

    x = xT.double().cpu().numpy()
    lat = latent.cpu().numpy()
    w = arrs[2].astype(np.float64)
    K, N = len(w), x.shape[1]
    counts = np.bincount(lat, minlength=K)
    require(counts.shape[0] == K, "%s: latent outside [0, K)" % name)
    require(np.all(counts[w == 0] == 0), "%s: a dead component was drawn" % name)
    live = w > 0
    if live.sum() > 1:
        chi2 = float(np.sum((counts[live] - N * w[live]) ** 2 / (N * w[live])))
        p = float(st.chi2.sf(chi2, live.sum() - 1))
        print("  %-34s chi2 %.2f  p %.3g" % (name + " latent", chi2, p))
        require(p > 1e-6, "%s: component frequencies off (p=%.3g)" % (name, p))
    mean, cov = mixture_moments(arrs)
    m = x.mean(axis=1)
    xc = x - m[:, None]
    se_m = np.sqrt(np.sum(xc * xc, axis=1) / N / N)
    c = xc @ xc.T / N
    # the standard error of each product's mean, one matrix product for
    # all D x D entries: sqrt((E[x_i^2 x_j^2] - c_ij^2) / N)
    sq = xc * xc
    se_c = np.sqrt(np.maximum(sq @ sq.T / N - c * c, 0.0) / N)
    del sq
    zm = float(np.max(np.abs(m - mean) / se_m))
    zc = float(np.max(np.abs(c - cov) / se_c))
    print("  %-34s mean %.2f sigma  cov %.2f sigma" % (name + " moments", zm, zc))
    require(zm < 6 and zc < 6, "%s: sample moments off (%.2f, %.2f sigma)" % (name, zm, zc))
    worst = int(np.argmax(np.abs(m - mean) / se_m))
    report.append({"output": name + " moments", "mean_sigma": zm, "cov_sigma": zc,
                   "statistical": True, "max_abs_err": float(abs(m - mean)[worst]),
                   "tol": float(6 * se_m[worst])})


def check_stats(prefix, got, ref, n, report, ref32=None):
    """The statistics per particle (divided by N), so that the bounds do
    not grow with N; ``ref32`` as in :func:`compare`."""
    for key in ("s0", "s0c", "sd", "g", "sw", "t1"):
        compare("%s %s/N" % (prefix, key), got[key] / n, ref[key] / n, "stats", report,
                None if ref32 is None else ref32[key] / n)


def case_mixtures(case, device):
    """``(arrs, tarrs, params, target, ops, tops, ops64, tops64, tag)`` of
    a kernel case: the proposal and target mixtures, their packed operands
    and those cast to float64."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dead, seed = case
    rng = np.random.default_rng(seed)
    arrs = random_mixture(rng, K, D, student, dead)
    tarrs = random_mixture(rng, Kt, D, t_student, spread=1.0)
    if D > 32:
        # a target near the proposal, so that log p - log q stays within
        # float32's exponent range in many dimensions
        tarrs = (arrs[0][:Kt] + 0.1, arrs[1][:Kt] * 1.2, np.full(Kt, 1.0 / Kt, np.float32),
                 None if not t_student else np.full(Kt, 10.0, np.float32))
    params, target = make_params(arrs, device), make_params(tarrs, device)
    ops, tops = core._kernel_operands(params), core._kernel_operands(target)
    ops64 = k.MixtureOperands(ops.packed.to(torch.float64), K, D, student)
    tops64 = k.MixtureOperands(tops.packed.to(torch.float64), Kt, D, t_student)
    tag = "K=%d Kt=%d D=%d N=%d %s%s" % (K, Kt, D, N, "t" if student else "gauss",
                                         " dead" if dead else "")
    return arrs, tarrs, params, target, ops, tops, ops64, tops64, tag


def kernel_case(case, device, report):
    """Run all four kernels on one mixture configuration; where
    fused_is_pmc_step's plan is its register pass, its entry-table pass
    too."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dead, seed = case
    arrs, _, _, _, ops, tops, ops64, tops64, tag = case_mixtures(case, device)
    print("case", tag)

    # fused_propose_logq: its own samples, recomputed by the plain version
    seed_a, seed_b = (seed, 11), (seed, 12)
    xT, lat, log_q, log_p = k.fused_propose_logq(seed_a, ops, N, tops)
    sync(device)
    x64 = xT.double()
    compare("fused_propose_logq log_q", log_q, k.plain_logq(x64, ops64), "log", report)
    compare("fused_propose_logq log_p", log_p, k.plain_logq(x64, tops64), "log", report)
    check_samples("fused_propose_logq", xT, lat, arrs, report)
    again = k.fused_propose_logq(seed_a, ops, N, tops)
    require(all(bool(torch.equal(a, b)) for a, b in zip((xT, lat, log_q, log_p), again)),
            "fused_propose_logq: one seed gave two outputs")
    other = k.fused_propose_logq(seed_b, ops, N, tops)[0]
    require(not bool(torch.equal(other, xT)), "fused_propose_logq: two seeds, one output")
    del again, other

    # fused_logq on the same points
    compare("fused_logq", k.fused_logq(xT, ops), k.plain_logq(x64, ops64), "log", report)

    # fused_pmc_stats on identical inputs: the elected pass, and where that
    # is the register pass the entry table too
    w = torch.exp(log_p - log_q)
    dof_stats = student
    pmc_stats_case(xT, w, ops, ops64, dof_stats, dead, "fused_pmc_stats", report)
    del w, x64, xT, lat, log_q, log_p

    # fused_is_pmc_step: its own samples, recomputed by the plain version
    xT, lat, w, got = k.fused_is_pmc_step(seed_a, ops, tops, N, dof_stats)
    sync(device)
    x64 = xT.double()
    w_ref = torch.exp(k.plain_logq(x64, tops64) - k.plain_logq(x64, ops64))
    compare("fused_is_pmc_step w", w, w_ref, "w", report)
    ref = k.plain_pmc_stats(x64, w_ref, ops64, dof_stats, n_sw=3)
    check_stats("fused_is_pmc_step", got, ref, N, report)
    check_samples("fused_is_pmc_step", xT, lat, arrs, report)
    again = k.fused_is_pmc_step(seed_a, ops, tops, N, dof_stats)
    require(all(bool(torch.equal(a, b)) for a, b in zip((xT, lat, w), again[:3]))
            and all(bool(torch.equal(got[key], again[3][key])) for key in got),
            "fused_is_pmc_step: one seed gave two outputs")
    plan = _build.dense_plan("fused_is_pmc_step", K, D, Kt)
    print("  fused_is_pmc_step pass %s: %d columns, %d slices, %d groups, %d B" % plan)
    if plan[0] != "table":
        # the entry-table pass from the same seed words: the same particles
        # bit for bit, and the same weights (log p on records in the register
        # pass, by mixture_logpdf in the entry table: the same arithmetic, a
        # Student-t target's too; the Gram route's: step_weights_case's);
        # statistics within the same tolerance
        table = k.fused_is_pmc_step(seed_a, ops, tops, N, dof_stats, variant="table")
        same = ("x", "latent", "w") if plan[0] == "reg" else ("x", "latent")
        differ = [name for name, a, b in zip(same, (xT, lat, w), table)
                  if not bool(torch.equal(a, b))]
        require(not differ, "fused_is_pmc_step: the %s and the entry-table pass differ "
                "in %s (w by up to %.3e)" % (plan[0], differ, float((w - table[2]).abs().max())))
        if plan[0] == "gram":
            step_weights_case("fused_is_pmc_step", w, table[2], D, t_student)
        check_stats("fused_is_pmc_step table", table[3], ref, N, report)
        del table
    require(not bool(torch.equal(k.fused_is_pmc_step(seed_b, ops, tops, N, dof_stats)[0], xT)),
            "fused_is_pmc_step: two seeds, one output")


def pmc_stats_case(xT, w, ops, ops64, dof_stats, dead, label, report):
    """fused_pmc_stats on given particles and weights against its float64
    plain version, on the pass its plan elects and, where that is the
    register or the Gram pass, on the entry table: the same statistics on a
    second run, every statistic of a dead component exactly 0."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N = ops.K, ops.dim, xT.shape[1]
    ref = k.plain_pmc_stats(xT.double(), w.double(), ops64, dof_stats)
    plan = _build.dense_plan("fused_pmc_stats", K, D)
    print("  fused_pmc_stats pass %s: %d columns, %d slices, %d groups, %d B" % plan)
    for variant in (plan[0], "table") if plan[0] != "table" else ("table",):
        got = k.fused_pmc_stats(xT, w, ops, dof_stats, variant=variant)
        tag = label if variant == plan[0] else "%s %s" % (label, variant)
        check_stats(tag, got, ref, N, report)
        again = k.fused_pmc_stats(xT, w, ops, dof_stats, variant=variant)
        require(all(bool(torch.equal(got[key], again[key])) for key in got),
                "%s: one input gave two outputs" % tag)
        if dead:
            require(all(bool((got[key][K // 2] == 0).all())
                        for key in ("s0", "s0c", "sd", "g", "t1")),
                    "%s: a dead component's statistics are not 0" % tag)


def pmc_stats_weighted_case(case, device, report):
    """pmc_stats_case on particles drawn from the mixture and random
    weights (a third of them 0)."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N, student, dof_stats, dead, seed = case
    rng = np.random.default_rng(seed)
    ops = core._kernel_operands(make_params(random_mixture(rng, K, D, student, dead), device))
    ops64 = k.MixtureOperands(ops.packed.double(), K, D, student)
    print("case fused_pmc_stats K=%d D=%d N=%d %s%s%s" % (
        K, D, N, "t" if student else "gauss", " dof_stats" if dof_stats else "",
        " dead" if dead else ""))
    xT = k.fused_propose_logq((seed, 22), ops, N)[0]
    w = torch.tensor(rng.exponential(1.0, N), dtype=torch.float32, device=device)
    w[::3] = 0.0
    pmc_stats_case(xT, w, ops, ops64, dof_stats, dead, "fused_pmc_stats", report)


# K, D, N, Student-t, dof_stats, dead component, seed: fused_pmc_stats on
# both passes, Student-t with and without dof_stats, at the edges of the
# register pass's plan (two groups, three row bands, eight groups at D=1;
# K=137 at D=1 and D=20 on the entry table alone)
PMC_STATS_CASES = [
    (10, 10, N_FLAGSHIP, True, True, False, 61),
    (10, 10, N_ODD, True, False, True, 62),
    (10, 10, N_ODD, False, False, True, 63),
    (17, 10, N_WIDE, True, True, False, 64),
    (11, 11, N_WIDE, False, False, True, 65),
    (128, 1, N_WIDE, True, True, True, 66),
    (137, 1, N_WIDE, False, False, False, 67),
    (3, 20, N_WIDE, True, True, False, 68),
]


KERNEL_CASES = [
    # K, Kt, D, N, Student-t proposal, Student-t target, dead component, seed
    (10, 2, 10, N_FLAGSHIP, True, False, False, 1),
    (10, 2, 10, N_ODD, False, True, True, 2),
    (1, 1, 1, N_ODD, True, False, False, 3),
    (1, 2, 5, N_ODD, False, False, False, 4),
    (4, 2, 7, N_ODD, True, True, True, 5),
    (3, 1, 1, N_FLAGSHIP, False, True, False, 6),
    (2, 2, 40, N_WIDE, False, True, False, 7),
    # the statistics kernels' operands in device memory
    (1, 1, 128, N_WIDE, False, False, False, 8),
    # the statistics kernels' 64-particle tile (D=1, K >= 109)
    (120, 2, 1, N_ODD, True, False, False, 9),
    (120, 2, 1, N_ODD, False, True, True, 10),
    # fused_is_pmc_step's register pass: the last K of one group of
    # components and the first of two (D=10), three row bands (D=11, D=16:
    # two and three groups), K=128 at D=1 (eight groups); K=137 at D=1, the
    # first shape at D <= 16 past its shared memory, takes the entry table
    (16, 2, 10, N_ODD, True, False, True, 26),
    (17, 2, 10, N_ODD, False, True, False, 27),
    (11, 2, 11, N_ODD, True, True, True, 28),
    (8, 2, 16, N_ODD, True, False, False, 29),
    (128, 2, 1, N_ODD, True, False, True, 30),
    (137, 2, 1, N_WIDE, False, False, False, 31),
]


def vb_operands(params):
    """The operands the VB E-step would give this mixture: the upper
    triangular ``A_k = chol(Sigma_k^{-1})^T`` (``|A_k (x - mu_k)|^2`` is the
    Mahalanobis distance), the means, and ``const_k = log w_k - log det
    Sigma_k / 2``, all float32.  As in the VB E-step, const is finite: a
    dead component's weight counts as 1e-3."""
    import torch

    A = torch.linalg.cholesky(params.inv_sigma.double()).transpose(1, 2)
    const = (torch.log(params.weights.double().clamp_min(1e-3))
             - 0.5 * params.log_det.double())
    return A.float().contiguous(), params.means.float(), const.float()


def eval_case(case, device, report):
    """fused_maha (lower and upper operands), fused_rho, fused_logq and
    fused_vb_estep on one configuration against their float64 plain
    versions; where fused_vb_estep's tile is past shared memory, its
    wrapper must raise."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N, student, dead, zero_w, seed = case
    rng = np.random.default_rng(seed)
    arrs = random_mixture(rng, K, D, student, dead)
    params = make_params(arrs, device)
    ops = core._kernel_operands(params)
    ops64 = k.MixtureOperands(ops.packed.double(), K, D, student)
    print("case K=%d D=%d N=%d %s%s%s" % (K, D, N, "t" if student else "gauss",
                                         " dead" if dead else "", " zero-w" if zero_w else ""))
    xT = k.fused_propose_logq((seed, 21), ops, N)[0]
    x64 = xT.double()
    A, m, const = vb_operands(params)
    for tag, a in (("lower", params.inv_chol), ("upper", A)):
        part = torch.tril(a, -1) if tag == "upper" else torch.triu(a, 1)
        require(bool((part == 0).all()), "fused_maha operand not " + tag)
        maha_variants_check("fused_maha " + tag, xT, a, m,
                            k.plain_maha(x64, a.double(), m.double()), report,
                            tiled=seed == MAHA_TILED_SEED)

    rho, log_q = k.fused_rho(xT, ops)
    rho_ref, log_q_ref = k.plain_rho(x64, ops64)
    compare("fused_rho rho", rho, rho_ref, "rho", report)
    compare("fused_rho log_q", log_q, log_q_ref, "log", report)
    if dead:
        require(bool((rho[K // 2] == 0).all()), "fused_rho: a dead component's rho is not 0")
    compare("fused_logq", k.fused_logq(xT, ops), log_q_ref, "log", report)
    del rho, log_q, rho_ref, log_q_ref

    w = torch.tensor(np.abs(rng.normal(1.0, 0.2, N)), dtype=torch.float32, device=device)
    if zero_w:
        w[::3] = 0.0
    reason = _build.limit_reason("fused_vb_estep", K, D)
    if reason is not None:
        try:
            k.fused_vb_estep(xT, w, A, m, const)
        except ValueError:
            print("  fused_vb_estep raises: %s" % reason)
            return
        raise SmokeFailure("fused_vb_estep ran past its limit: %s" % reason)
    vb_stats_case(xT, w, A, m, const, "fused_vb_estep", report)


# the EVAL_CASES entry (by its seed) at which phase kernels also checks
# fused_maha's tiled kernel forced below D = 65, where it is a yardstick
# only: the pipeline's D=40 VB mixture
MAHA_TILED_SEED = 20


def maha_variants_check(label, xT, a, m, ref, report, tiled=True):
    """fused_maha's elected kernel (as ``label``) and each of its kernels at
    D forced (the record, the tensor-core and, where ``tiled``, the tiled
    kernel to D = 64; the tiled past it) against ``ref``, float64, with
    TOL["maha"]; each forced kernel equal on a second run (the elected
    call is the second run of the kernel it elects)."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    D = a.shape[-1]
    elected = k.fused_maha(xT, a, m)
    compare(label, elected, ref, "maha", report)
    for v in k._eval_variants("fused_maha", D):
        if v == "tiled" and D < _build.TILED_D_MIN and not tiled:
            continue
        got = k.fused_maha(xT, a, m, variant=v)
        compare("%s %s" % (label, v), got, ref, "maha", report)
        again = elected if v == _build.eval_variant("fused_maha", D) else k.fused_maha(
            xT, a, m, variant=v)
        require(bool(torch.equal(got, again)), "%s %s: one input gave two outputs" % (label, v))


def maha_case(case, device, report):
    """fused_maha at the JAX rule's largest K where the tensor-core kernel's
    DMAX 32 and 64 instantiations take it (D=17, 20 and 64): lower and
    upper operands of a Student-t mixture with a dead component, ragged N,
    each kernel against float64 (maha_variants_check)."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N, seed = case
    params = make_params(random_mixture(np.random.default_rng(seed), K, D, True, True), device)
    xT = mixture_particles(core._kernel_operands(params), N, seed, device)
    A, m, _ = vb_operands(params)
    print("case fused_maha K=%d D=%d N=%d t dead" % (K, D, N))
    chunks = k._chunks(K, D, N)
    for tag, a in (("lower", params.inv_chol), ("upper", A)):
        ref = torch.cat([k.plain_maha(xT.double(), a[k0:k1].double(), m[k0:k1].double())
                         for k0, k1 in chunks])
        maha_variants_check("fused_maha %s K=%d D=%d" % (tag, K, D), xT, a, m, ref, report)


# (K, D, N, seed) of maha_case: the rule's largest K at D=17, 20 and 64
MAHA_CASES = [(225, 17, N_WIDE, 41), (193, 20, N_WIDE, 42), (62, 64, N_WIDE, 43)]


def fp32_maha_terms(xT, a, m):
    """|a_k (x_n - m_k)|^2 of the particles xT (D, n) in float32, each term
    a_k[i][j] (x_j - m_k[j]) formed on its own (0 x inf = NaN, as the record
    kernel's FMAs give it) and summed: the NaNs and infinities of the FP32
    arithmetic, for the few particles of a non-finite check; (K, n)."""
    y = (a[:, :, :, None] * (xT[None] - m[:, :, None])[:, None]).sum(2)
    return (y * y).sum(1)


def maha_nonfinite_case(device, report):
    """fused_maha's tensor-core kernels on particles with a NaN, a +inf and a
    -inf coordinate, lower, upper and full operands at D=20 and 40 and, past
    D = 64, at D=96 and 200: NaN and infinite exactly where the FP32
    arithmetic's are (a value that is not finite is recomputed in the
    record kernel's FP32 arithmetic): the record kernel's outputs to D = 64
    and, at every D, fp32_maha_terms on the four particles; the finite
    outputs within TOL["maha"] of float64.  Past D = 64 the tiled kernel,
    forced, is held to the FP32 terms too: its rows padded to 128 are left
    out of the squares (they added fmaf(0, inf, s) = NaN, so that a particle
    whose every row is infinite was NaN there, +inf in the FP32
    arithmetic)."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    for K, D in ((4, 20), (3, 40), (2, 96), (1, 200)):
        rng = np.random.default_rng(K + D)
        params = make_params(random_mixture(rng, K, D, False), device)
        xT = mixture_particles(core._kernel_operands(params), 4099, K + D, device)
        xT[3, 7] = float("nan")
        xT[0, 11] = float("inf")
        xT[D - 1, 13] = -float("inf")
        xT[5, 17] = float("inf")
        finite = torch.isfinite(xT).all(0)
        bad = (~finite).nonzero().flatten()
        require(bad.tolist() == [7, 11, 13, 17], "the non-finite particles are %s" % bad.tolist())
        A, m, _ = vb_operands(params)
        full = torch.tensor(rng.normal(0, 1, (K, D, D)), dtype=torch.float32, device=device)
        for tag, a in (("lower", params.inv_chol), ("upper", A), ("full", full)):
            label = "fused_maha non-finite %s K=%d D=%d" % (tag, K, D)
            mma = k.fused_maha(xT, a, m, variant="mma")
            terms = fp32_maha_terms(xT[:, bad], a, m)
            fp32 = [("the FP32 terms'", mma[:, bad], terms)]
            if D <= 64:
                fp32.append(("the record kernel's", mma, k.fused_maha(xT, a, m, variant="rec")))
            for what, f in (("NaN", torch.isnan), ("+inf", lambda t: t == float("inf"))):
                for whose, got, want in fp32:
                    require(bool(torch.equal(f(got), f(want))),
                            "%s: the tensor-core kernel's %s differ from %s: %s, %s"
                            % (label, what, whose, got[:, :4].tolist() if got is mma else
                               got.tolist(), want[:, :4].tolist() if want.shape == mma.shape
                               else want.tolist()))
            require(bool(torch.isfinite(mma[:, finite]).all()),
                    "%s: a finite particle's output is not finite" % label)
            ref = k.plain_maha(xT[:, finite].double(), a.double(), m.double())
            compare(label, mma[:, finite], ref, "maha", report)
            line = "  %s: NaN at %d outputs, +inf at %d, as %s" % (
                label, int(torch.isnan(mma).sum()), int((mma == float("inf")).sum()),
                " and ".join(whose for whose, _, _ in fp32))
            if D > 64:
                tiled = k.fused_maha(xT, a, m, variant="tiled")
                line += "; the tiled kernel: NaN at %d, +inf at %d (%s at the four)" % (
                    int(torch.isnan(tiled).sum()), int((tiled == float("inf")).sum()),
                    tiled[:, bad].tolist())
                for what, f in (("NaN", torch.isnan), ("+inf", lambda t: t == float("inf"))):
                    require(bool(torch.equal(f(tiled[:, bad]), f(terms))),
                            "%s: the tiled kernel's %s differ from the FP32 terms': %s, %s"
                            % (label, what, tiled[:, bad].tolist(), terms.tolist()))
            print(line)


# the shapes (K, D) of evaluation_nonfinite_case: the record kernels' D = 20
# and 40, the tensor-core kernels' D = 96 and 200
EVAL_NONFINITE_SHAPES = [(3, 20), (3, 40), (2, 96), (1, 200)]
# the particles (column, coordinate, value) it plants: +inf at coordinate 0,
# +inf at a middle one, -inf at the last, a NaN, and 1e20, whose squared
# distance overflows float32
EVAL_NONFINITE = lambda D: [(7, 0, float("inf")), (11, D // 2, float("inf")),
                            (13, D - 1, -float("inf")), (17, 3, float("nan")), (19, 1, 1e20)]


def eval_variant_calls(k, xT, ops):
    """``[(label, fused_logq call, fused_rho call or None)]``: the kernels
    the package imported elects for fused_logq and fused_rho at ops' D, and
    the tiled kernels forced (fused_rho's where its wrapper takes a
    ``variant``; in an earlier checkout it elected the tiled kernel past D =
    64 and had no variant)."""
    import inspect

    calls = [("elected", lambda: k.fused_logq(xT, ops), lambda: k.fused_rho(xT, ops))]
    rho_variant = "variant" in inspect.signature(k.fused_rho).parameters
    calls.append(("tiled", lambda: k.fused_logq(xT, ops, variant="tiled"),
                  (lambda: k.fused_rho(xT, ops, variant="tiled")) if rho_variant else None))
    return calls


def evaluation_nonfinite_case(device, report, strict=True):
    """fused_logq and fused_rho on particles with EVAL_NONFINITE's
    coordinates, a Gaussian mixture and a Student-t one with a dead
    component, at EVAL_NONFINITE_SHAPES: each kernel of the shape (the
    elected one: the record kernel to D = 64, the tensor-core kernel past it;
    the tiled kernel forced, at every D) gives exactly the float32 plain
    version's NaN, +inf and -inf at every output (log q; rho and its log q),
    the XLA path's rule (a -inf component adds nothing to the log-sum-exp,
    0 x inf = NaN above U's diagonal); its finite outputs within TOL "log"
    and "rho" of float64 where the float32 plain version's are finite.
    Returns the mismatches, ``[(label, output, what)]``; strict: fails on
    the first."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    bad_out = []
    for K, D in EVAL_NONFINITE_SHAPES:
        for student in (False, True):
            rng = np.random.default_rng(K + D + student)
            params = make_params(random_mixture(rng, K, D, student, K > 1), device)
            ops = core._kernel_operands(params)
            ops64 = k.MixtureOperands(ops.packed.double(), K, D, student)
            xT = mixture_particles(ops, 4099, K + D, device)
            for col, j, v in EVAL_NONFINITE(D):
                xT[j, col] = v
            f = ops.fields()
            require(bool((torch.triu(f["U"], diagonal=1) == 0).all()),
                    "U's upper triangle holds a nonzero (K=%d, D=%d)" % (K, D))
            lq32 = k.plain_logq(xT, ops)
            rho32, rq32 = k.plain_rho(xT, ops)
            x64 = xT.double()
            lq64 = k.plain_logq(x64, ops64)
            rho64, _ = k.plain_rho(x64, ops64)
            tag = "K=%d D=%d%s" % (K, D, " t" if student else "")
            cols = [c for c, _, _ in EVAL_NONFINITE(D)]
            for label, logq_call, rho_call in eval_variant_calls(k, xT, ops):
                outs = [("log_q", logq_call(), lq32, lq64, "log")]
                if rho_call is not None:
                    rho, rq = rho_call()
                    outs += [("rho", rho, rho32, rho64, "rho"), ("rho log_q", rq, rq32, lq64, "log")]
                for out, got, want, ref, kind in outs:
                    name = "non-finite %s %s %s" % (tag, label, out)
                    for what, test in (("NaN", torch.isnan), ("+inf", lambda t: t == float("inf")),
                                       ("-inf", lambda t: t == -float("inf"))):
                        if not bool(torch.equal(test(got), test(want))):
                            bad_out.append((name, what, got[..., cols].tolist(),
                                            want[..., cols].tolist()))
                            print("  %s: its %s differ from the plain version's: %s, plain %s"
                                  % bad_out[-1])
                            require(not strict, "%s: its %s differ from the plain version's: "
                                    "%s, plain %s" % bad_out[-1])
                    keep = torch.isfinite(want) & torch.isfinite(ref)
                    if bool(torch.isfinite(got[keep]).all()):
                        compare(name, got[keep], ref[keep], kind, report)
                    else:
                        bad_out.append((name, "finite", "", ""))
                        require(not strict, "%s: a finite output of the plain version is not "
                                "finite here" % name)
                print("  non-finite %s %s: %s" % (tag, label, ", ".join(
                    "%s %s" % (out, got[..., cols].tolist() if got.dim() == 1 else
                               got[:, cols].tolist()) for out, got, _, _, _ in outs[:2])))
    return bad_out


def vb_stats_case(xT, w, A, m, const, label, report):
    """fused_vb_estep on given particles, weights and operands against its
    float64 plain version, on the pass its plan elects and, where that is
    the register or the Gram pass, on the entry table: the same statistics
    on a second run."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N = A.shape[0], A.shape[1], xT.shape[1]
    ref = k.plain_vb_estep(xT.double(), w.double(), A.double(), m.double(), const.double())
    plan = _build.dense_plan("fused_vb_estep", K, D)
    print("  fused_vb_estep pass %s: %d columns, %d slices, %d groups, %d B" % plan)
    for variant in (plan[0], "table") if plan[0] != "table" else ("table",):
        got = k.fused_vb_estep(xT, w, A, m, const, variant=variant)
        tag = label if variant == plan[0] else "%s %s" % (label, variant)
        for name, g, r in zip(("N_comp", "sd", "g", "log_q_Z"), got, ref):
            compare("%s %s/N" % (tag, name), g / N, r / N, "stats", report)
        again = k.fused_vb_estep(xT, w, A, m, const, variant=variant)
        require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                "%s: one input gave two outputs" % tag)


EVAL_CASES = [
    # K, D, N, Student-t, dead component, zero weights, seed
    (10, 10, N_FLAGSHIP, True, False, False, 11),
    (10, 10, N_ODD, False, True, True, 12),
    (1, 1, N_ODD, True, False, True, 13),
    (4, 7, N_ODD, True, True, False, 14),
    (3, 32, N_ODD, False, False, True, 15),
    (2, 40, N_WIDE, True, False, True, 16),
    # operands in device memory: every evaluation kernel at K=60, D=32
    # (fused_vb_estep's tile does not fit: it raises), fused_vb_estep at
    # K=1, D=128
    (60, 32, N_WIDE, False, True, False, 17),
    (1, 128, N_WIDE, False, False, True, 18),
    # the pipeline's VB and PMC mixtures at D=40 (32 long patches):
    # fused_maha's and fused_logq's records stream in chunks
    (32, 40, N_WIDE, True, False, False, 20),
    # the K=200 step's log-likelihood; the lower end of the DMAX 40 record
    # kernel, the upper end of the DMAX 64 one
    (200, 10, N_WIDE, True, False, False, 21),
    (5, 64, N_WIDE, False, True, True, 22),
    (3, 33, N_WIDE, True, False, False, 23),
    # fused_vb_estep's 64-particle tile
    (120, 1, N_ODD, True, False, True, 24),
    (120, 1, N_ODD, False, True, False, 25),
    # fused_vb_estep's register pass at the edges of its plan (as
    # KERNEL_CASES'); K=137 at D=1 takes the entry table
    (16, 10, N_ODD, False, False, True, 32),
    (17, 10, N_ODD, False, True, False, 33),
    (11, 11, N_ODD, True, False, True, 34),
    (8, 16, N_ODD, False, True, True, 35),
    (128, 1, N_ODD, True, False, True, 36),
    (137, 1, N_WIDE, False, False, True, 37),
]


# (K, D, the NaN's coordinate) of the non-finite cases: the register pass's
# K=10, D=10 and the Gram pass's K=4, D=20, its NaN in the second of the
# 8-row blocks the pass whitens (in fused_pmc_stats rows 8-10 of it must stay
# finite)
NONFINITE_SHAPES = [(10, 10, 3), (4, 20, 11)]


def vb_nonfinite_case(device, report):
    """fused_vb_estep, the plan's pass and the entry table, at
    NONFINITE_SHAPES on particles of which one has a NaN coordinate and one
    an infinite one (4 coordinates further on): where its float64 plain
    version's statistics are NaN, so are the kernel's.  The register and
    Gram passes' projections skip A's lower triangle, whose FMAs add exact
    zeros for a finite x but NaN (0 x inf) for this one."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    N = 4099
    for K, D, j_nan in NONFINITE_SHAPES:
        rng = np.random.default_rng(38 + D - 10)
        A, m, const = vb_operands(make_params(random_mixture(rng, K, D, False), device))
        xT = torch.tensor(rng.normal(0, 2, (D, N)), dtype=torch.float32, device=device)
        xT[j_nan, 17] = float("nan")
        xT[j_nan + 4, 1000] = float("inf")
        w = torch.ones((N,), dtype=torch.float32, device=device)
        ref = k.plain_vb_estep(xT.double(), w.double(), A.double(), m.double(), const.double())
        passes = (_build.dense_plan("fused_vb_estep", K, D)[0], "table")
        for variant in passes:
            got = k.fused_vb_estep(xT, w, A, m, const, variant=variant)
            for name, g, r in zip(("N_comp", "sd", "g", "log_q_Z"), got, ref):
                require(bool(torch.equal(torch.isnan(g), torch.isnan(r))),
                        "fused_vb_estep %s K=%d D=%d: %s NaN where the plain version's is "
                        "not, or the other way" % (variant, K, D, name))
        print("  fused_vb_estep K=%d D=%d, a NaN and an infinite coordinate: NaN where the "
              "plain version's statistics are (%d of %d entries), passes %s"
              % (K, D, sum(int(torch.isnan(r).sum()) for r in ref), sum(r.numel() for r in ref),
                 "/".join(passes)))


def pmc_stats_nonfinite_case(device, report):
    """fused_pmc_stats, each pass, Gaussian and Student-t with dof_stats,
    on particles of which one has a NaN coordinate, then on weights of
    which one is NaN: where its float64 plain version's statistics are NaN,
    so are the kernel's, and nowhere else (N = 4,099, a tail past a
    multiple of 64), at NONFINITE_SHAPES.  One exception, stated: the
    kernels whiten with the lower triangle of U alone, so a NaN in
    coordinate j leaves the whitened coordinates i < j finite, where the
    plain version's matrix product adds 0 x NaN from U's upper zeros; a
    dead component's responsibility is exactly 0, so where its c = w rho
    gamma is 0 (not NaN: a Gaussian) its sd_i and g_ij are finite in the
    kernels for i, j < j_nan and NaN in the plain version.  Those entries
    are expected finite."""
    for shape in NONFINITE_SHAPES:
        _pmc_stats_nonfinite(device, *shape)


def _pmc_stats_nonfinite(device, K, D, j_nan):
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.density import core

    N, dead = 4099, K // 2
    passes = (_build.dense_plan("fused_pmc_stats", K, D)[0], "table")
    for student in (False, True):
        rng = np.random.default_rng(39 + student + 2 * (D - 10))
        ops = core._kernel_operands(make_params(random_mixture(rng, K, D, student, True), device))
        ops64 = k.MixtureOperands(ops.packed.double(), K, D, student)
        for fault in ("coordinate", "weight"):
            xT = torch.tensor(rng.normal(0, 2, (D, N)), dtype=torch.float32, device=device)
            w = torch.tensor(rng.exponential(1.0, N), dtype=torch.float32, device=device)
            if fault == "coordinate":
                xT[j_nan, 17] = float("nan")
            else:
                w[1000] = float("nan")
            ref = k.plain_pmc_stats(xT.double(), w.double(), ops64, student)
            want = {key: torch.isnan(r) for key, r in ref.items()}
            if not bool(want["s0c"][dead]):
                reach = torch.arange(D, device=device) >= j_nan
                want["sd"][dead] = reach
                want["g"][dead] = reach[:, None] | reach[None, :]
            for variant in passes:
                got = k.fused_pmc_stats(xT, w, ops, student, variant=variant)
                for key in ref:
                    require(bool(torch.equal(torch.isnan(got[key]), want[key])),
                            "fused_pmc_stats %s K=%d D=%d, a NaN %s (%s): %s NaN where the "
                            "plain version's is not, or the other way"
                            % (variant, K, D, fault, "t" if student else "gauss", key))
            print("  fused_pmc_stats K=%d D=%d, a NaN %s (%s): NaN where the plain version's "
                  "statistics are (%d of %d entries; %d finite in a dead component), passes %s"
                  % (K, D, fault, "t" if student else "gauss",
                     sum(int(m.sum()) for m in want.values()),
                     sum(r.numel() for r in ref.values()),
                     sum(int(torch.isnan(r).sum()) for r in ref.values())
                     - sum(int(m.sum()) for m in want.values()), "/".join(passes)))


# (K, D) of the Gram statistics pass (csrc/gram_stats.cuh) the checks and
# times walk: the JAX rule's reach past D = 16 (K D <= 128), from its most
# components at D = 17 to one component at D = 128
GRAM_SHAPES = [(7, 17), (6, 20), (4, 32), (3, 40), (2, 64), (1, 65), (1, 96), (1, 128)]
# K, Kt, D, N, Student-t proposal, Student-t target, dof_stats, seed: each
# shape at N = 1024 and 1025 (the rule's fewest particles; a ragged last
# tile) and at 2^20, with one and two target components, Gaussian and
# Student-t proposals and targets, dof_stats on and off; and the K=6, D=20
# case at 10^7
GRAM_CASES = [c for i, (K, D) in enumerate(GRAM_SHAPES) for c in (
    (K, 1, D, 1024, True, True, False, 300 + 4 * i),
    (K, 2, D, 1025, False, False, True, 301 + 4 * i),
    (K, 2, D, N_FLAGSHIP, False, True, False, 302 + 4 * i),
    (K, 1, D, N_FLAGSHIP, True, False, True, 303 + 4 * i))] + [
    (6, 2, 20, N_SLICE, True, False, True, 340)]
# w of the Gram route against the entry table's for a Student-t target up to
# D = 64: log p by records_logpdf against mixture_logpdf, within this
# relative slack (a Gaussian target's: bit for bit)
STEP_W_SLACK = 2.0 ** -20


def step_weights_case(label, w, w_table, D, t_student):
    """The Gram route's weights against the entry table's from the same
    seed words: to D = 64 (both on fused_propose_logq's record arithmetic
    and mixture_logpdf's) bit for bit for a Gaussian target, within
    STEP_W_SLACK relative for a Student-t one; past it the tiled fused_logq's
    log q and log p, held to float64 by the caller."""
    import torch
    from pypmc_tpu_torch.ops import _build

    if D > _build._REC_D_MAX:
        return
    if not t_student:
        require(bool(torch.equal(w, w_table)), "%s: the Gram route's w differs from the entry "
                "table's (a Gaussian target, D=%d) by up to %.3e"
                % (label, D, float((w - w_table).abs().max())))
        return
    rel = float(((w.double() - w_table.double()).abs()
                 / w_table.double().abs().clamp_min(1e-30)).max())
    require(rel <= STEP_W_SLACK, "%s: the Gram route's w %.3e relative from the entry table's "
            "(a Student-t target, D=%d), past %.3e" % (label, rel, D, STEP_W_SLACK))


def gram_mixtures(case, device):
    """``(ops, tops, ops64, tops64, tag, params)`` of a Gram case: a
    K-component proposal (spread 0.5; a dead component at K // 2 where K >
    1; ``params`` its mixture parameters) and Kt target components near its
    live ones (means + 0.1, covariances 1.2 times), weights 1 / Kt, dof 10
    where Student-t, float32 and float64."""
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dof_stats, seed = case
    arrs = random_mixture(np.random.default_rng(seed), K, D, student, K > 1, spread=0.5)
    live = np.flatnonzero(arrs[2] > 0)
    pick = live[np.arange(Kt) % len(live)]
    tarrs = (arrs[0][pick] + 0.1, arrs[1][pick] * 1.2, np.full(Kt, 1.0 / Kt, np.float32),
             np.full(Kt, 10.0, np.float32) if t_student else None)
    params = make_params(arrs, device)
    ops = core._kernel_operands(params)
    tops = core._kernel_operands(make_params(tarrs, device))
    ops64 = k.MixtureOperands(ops.packed.double(), K, D, student)
    tops64 = k.MixtureOperands(tops.packed.double(), Kt, D, t_student)
    tag = "K=%d Kt=%d D=%d N=%d %s proposal, %s target, dof_stats %s" % (
        K, Kt, D, N, "t" if student else "gauss", "t" if t_student else "gauss", dof_stats)
    return ops, tops, ops64, tops64, tag, params


def gram_case(case, device, report):
    """The Gram pass at one GRAM_CASES entry, the three kernels elected there
    and counted ``=gram``: fused_pmc_stats on fused_propose_logq's particles
    and weights against its float64 plain version, a second run equal, a
    dead component's statistics 0, the forced entry table within the same
    tolerance; to N = 2^20 fused_vb_estep on the same particles, a third of
    their weights 0, and the proposal's VB operands, the same checks
    (vb_stats_case); fused_is_pmc_step from one seed: x and latent the entry
    table's bit for bit, w as step_weights_case holds it and, to D = 64,
    fused_is_pmc_step_blocked's (whose first launch takes the same draw) bit
    for bit, past it within TOL["w"] of float64, its statistics against the
    float64 plain version on its own particles, a second run equal in every
    output."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dof_stats, seed = case
    ops, tops, ops64, tops64, tag, params = gram_mixtures(case, device)
    print("case gram", tag)
    for name in _build._DENSE:
        require(_build.dense_plan(name, K, D, Kt)[0] == "gram",
                "%s at K=%d, D=%d: the plan is %s" % (name, K, D, _build.dense_plan(name, K, D, Kt)))
    k.reset_launch_counts()
    xT, _, log_q, log_p = k.fused_propose_logq((seed, 1), ops, N, tops)
    w = torch.exp(log_p - log_q)
    del log_q, log_p
    pmc_stats_case(xT, w, ops, ops64, dof_stats, K > 1, "gram fused_pmc_stats", report)
    vb_runs = 0
    if N <= N_FLAGSHIP:
        # fused_vb_estep on the proposal's VB operands, a third of the
        # weights 0
        w[::3] = 0.0
        vb_stats_case(xT, w, *vb_operands(params), "gram fused_vb_estep", report)
        vb_runs = 2
    del xT, w
    seed_a = (seed, 2)
    xT, lat, w, got = k.fused_is_pmc_step(seed_a, ops, tops, N, dof_stats)
    sync(device)
    x64 = xT.double()
    w_ref = torch.exp(k.plain_logq(x64, tops64) - k.plain_logq(x64, ops64))
    compare("gram fused_is_pmc_step w", w, w_ref, "w", report)
    ref = k.plain_pmc_stats(x64, w_ref, ops64, dof_stats, n_sw=3)
    del x64, w_ref
    check_stats("gram fused_is_pmc_step", got, ref, N, report)
    again = k.fused_is_pmc_step(seed_a, ops, tops, N, dof_stats)
    require(all(bool(torch.equal(a, b)) for a, b in zip((xT, lat, w), again[:3]))
            and all(bool(torch.equal(got[key], again[3][key])) for key in got),
            "gram fused_is_pmc_step: one seed gave two outputs")
    del again
    table = k.fused_is_pmc_step(seed_a, ops, tops, N, dof_stats, variant="table")
    differ = [name for name, a, b in zip(("x", "latent"), (xT, lat), table)
              if not bool(torch.equal(a, b))]
    require(not differ, "gram fused_is_pmc_step: the Gram route and the entry table drew "
            "different %s" % differ)
    step_weights_case("gram fused_is_pmc_step", w, table[2], D, t_student)
    check_stats("gram fused_is_pmc_step table", table[3], ref, N, report)
    del table
    if D > _build._REC_D_MAX:
        # the Gram route's draw is fused_propose_logq's tiled route on the
        # same seed: its x and latent, and so its log q and log p, which
        # are fused_logq's bit for bit on them (its elected kernel)
        px, plat, plq, plp = k.fused_propose_logq(seed_a, ops, N, tops)
        require(bool(torch.equal(px, xT) and torch.equal(plat, lat)),
                "gram fused_is_pmc_step: its draw is not fused_propose_logq's")
        require(bool(torch.equal(plq, k.fused_logq(xT, ops))
                     and torch.equal(plp, k.fused_logq(xT, tops))),
                "gram fused_is_pmc_step D=%d: log q or log p is not fused_logq's bit for bit" % D)
        differ = int((torch.exp(plp - plq) != w).sum())
        print("  gram fused_is_pmc_step D=%d: x, latent, log q and log p fused_propose_logq's "
              "and fused_logq's (%s) bit for bit; w and exp(log p - log q) differ at %d of %d"
              % (D, _build.eval_variant("fused_logq", D), differ, N))
        del px, plat, plq, plp
    if D <= _build._REC_D_MAX:
        blocked = k.fused_is_pmc_step_blocked(seed_a, ops, tops, N, dof_stats)
        differ = [name for name, a, b in zip(("x", "latent", "w"), (xT, lat, w), blocked)
                  if not bool(torch.equal(a, b))]
        require(not differ, "gram fused_is_pmc_step: the Gram route and "
                "fused_is_pmc_step_blocked differ in %s (w by up to %.3e)"
                % (differ, float((w - blocked[2]).abs().max())))
        del blocked
    counts = k.launch_counts()
    for name, runs in (("fused_pmc_stats", 2), ("fused_is_pmc_step", 2),
                       ("fused_vb_estep", vb_runs)):
        require(counts["variant:%s=gram" % name] == runs, "gram %s: %d launches counted =gram, "
                "%d expected" % (name, counts["variant:%s=gram" % name], runs))
    print("  gram: x and latent the entry table's bit for bit; w %s; two runs equal"
          % ("fused_is_pmc_step_blocked's bit for bit" if D <= _build._REC_D_MAX
             else "within TOL['w'] of float64"))


def component_draw(params, n, seed):
    """``n`` components drawn as ``propose_T`` draws them: one uniform a
    particle against the tail-sum thresholds."""
    import torch
    from pypmc_tpu_torch.density import core

    gen = torch.Generator(device=params.device).manual_seed(seed)
    u = torch.rand(n, generator=gen, dtype=params.means.dtype, device=params.device)
    cumw = core._cumulative_weights(params.weights)
    return torch.sum(u[None, :] >= cumw[:-1, None], dim=0, dtype=torch.int32)


def transform_case(case, device, report):
    """fused_transform against its float64 plain version on the same
    normals, components and scales (a Student-t scale sqrt(dof / chi2)),
    the launch counted under the kernel its plan elects; where that is the
    record kernel (D <= 64), the looped kernel too, which must give the
    same output bit for bit."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.ops.random import student_t_scale

    K, D, N, student, seed = case
    rng = np.random.default_rng(seed)
    arrs = random_mixture(rng, K, D, student)
    params = make_params(arrs, device)
    ops = core._kernel_operands(params)
    ops64 = k.MixtureOperands(ops.packed.double(), K, D, student)
    plan = _build.transform_plan(K, D)
    print("case fused_transform K=%d D=%d N=%d %s: the %s kernel, records staged %s, %d floats "
          "a record, %d threads, %d B" % ((K, D, N, "t" if student else "gauss") + plan))
    gen = torch.Generator(device=device).manual_seed(seed)
    zT = torch.randn((D, N), generator=gen, device=device)
    latent = torch.randint(0, K, (N,), generator=gen, device=device, dtype=torch.int32)
    scale = (student_t_scale(gen, params.dof[latent.long()], (N,)) if student
             else torch.rand((N,), generator=gen, device=device) + 0.5)
    k.reset_launch_counts()
    got = k.fused_transform(zT, latent, scale, ops)
    sync(device)
    require(k.launch_counts()["variant:fused_transform=" + plan[0]] == 1,
            "fused_transform: the launch did not take the %s kernel" % plan[0])
    ref = k.plain_transform(zT.double(), latent, scale.double(), ops64)
    compare("fused_transform", got, ref, "log", report)
    require(bool(torch.equal(got, k.fused_transform(zT, latent, scale, ops))),
            "fused_transform: one input gave two outputs")
    if plan[0] == "rec":
        differ = int((got != k.fused_transform(zT, latent, scale, ops, variant="looped")).sum())
        print("  fused_transform rec vs looped: %d of %d outputs differ" % (differ, D * N))
        require(differ == 0, "fused_transform: the record and the looped kernel differ in %d "
                "outputs" % differ)


def check_components(name, xT, latent, arrs):
    """The sample mean of each component's particles against its mean, to 6
    Monte Carlo sigma: each particle came from the component it names."""
    x = xT.double().cpu().numpy()
    lat = latent.cpu().numpy()
    means, covs, w, dofs = arrs
    worst = 0.0
    for kk in np.flatnonzero(w > 0):
        sel = x[:, lat == kk]
        if sel.shape[1] < 100:
            continue
        var = np.diag(covs[kk]).astype(np.float64)
        if dofs is not None:
            var = var * dofs[kk] / (dofs[kk] - 2.0)
        z = np.abs(sel.mean(axis=1) - means[kk]) / np.sqrt(var / sel.shape[1])
        worst = max(worst, float(z.max()))
    print("  %-34s worst component mean %.2f sigma" % (name + " per component", worst))
    require(worst < 6, "%s: a component's particles are off its mean (%.2f sigma)"
            % (name, worst))


def transform_rng_case(case, device, report):
    """fused_transform_rng on its own draws: the components' frequencies
    (chi-square against the weights), the mixture's moments and each
    component's mean; one seed gives one output, two seeds two."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N, student, dead, seed = case
    rng = np.random.default_rng(seed)
    arrs = random_mixture(rng, K, D, student, dead)
    params = make_params(arrs, device)
    ops = core._kernel_operands(params)
    print("case fused_transform_rng K=%d D=%d N=%d %s%s" % (
        K, D, N, "t" if student else "gauss", " dead" if dead else ""))
    latent = component_draw(params, N, seed)
    xT = k.fused_transform_rng((seed, 31), latent, ops)
    sync(device)
    check_samples("fused_transform_rng", xT, latent, arrs, report)
    check_components("fused_transform_rng", xT, latent, arrs)
    require(bool(torch.equal(xT, k.fused_transform_rng((seed, 31), latent, ops))),
            "fused_transform_rng: one seed gave two outputs")
    require(not bool(torch.equal(xT, k.fused_transform_rng((seed, 32), latent, ops))),
            "fused_transform_rng: two seeds, one output")


def draw_variants_case(case, device, report):
    """fused_propose_logq's record kernel against its looped kernel on one
    configuration (Kt=0: no target): the launch counted under the kernel its
    plan elects (the record kernel, its records staged or, where they pass
    half an SM, read from device memory, as the case says), and all four
    outputs equal bit for bit; the number of outputs that differ is printed
    and must be 0."""
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dead, staged, seed = case
    ops, tops = case_mixtures((K, max(Kt, 1), D, N, student, t_student, dead, seed), device)[4:6]
    tops = tops if Kt else None
    plan = _build.propose_plan(K, Kt, D)
    tag = "K=%d Kt=%d D=%d N=%d %s%s" % (K, Kt, D, N, "t" if student else "gauss",
                                         " dead" if dead else "")
    print("case fused_propose_logq rec vs looped %s: records staged %s, %d B"
          % (tag, plan[1], plan[4]))
    require(plan[:2] == ("rec", staged), "fused_propose_logq at %s: the plan is %s" % (tag, plan))
    k.reset_launch_counts()
    rec = k.fused_propose_logq((seed, 11), ops, N, tops)
    sync(device)
    require(k.launch_counts()["variant:fused_propose_logq=rec"] == 1,
            "fused_propose_logq: the launch did not take the record kernel")
    looped = k.fused_propose_logq((seed, 11), ops, N, tops, variant="looped")
    differ = sum(int((a != b).sum()) for a, b in zip(rec, looped))
    total = sum(a.numel() for a in rec)
    print("  fused_propose_logq rec vs looped: %d of %d outputs differ" % (differ, total))
    require(differ == 0, "fused_propose_logq: the record and the looped kernel differ in %d "
            "outputs" % differ)
    report.append({"output": "fused_propose_logq rec vs looped", "differ": differ})


def transform_rng_variants_case(case, device, report):
    """fused_transform_rng's record kernel against its looped kernel on one
    configuration, as draw_variants_case: the same components (drawn as
    propose_T draws them), the output equal bit for bit."""
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N, student, dead, staged, seed = case
    arrs = random_mixture(np.random.default_rng(seed), K, D, student, dead)
    params = make_params(arrs, device)
    ops = core._kernel_operands(params)
    plan = _build.transform_plan(K, D, rng=True)
    print("case fused_transform_rng rec vs looped K=%d D=%d N=%d %s%s: records staged %s, %d B"
          % (K, D, N, "t" if student else "gauss", " dead" if dead else "", plan[1], plan[4]))
    require(plan[:2] == ("rec", staged), "fused_transform_rng at K=%d, D=%d: the plan is %s"
            % (K, D, plan))
    latent = component_draw(params, N, seed)
    k.reset_launch_counts()
    rec = k.fused_transform_rng((seed, 31), latent, ops)
    sync(device)
    require(k.launch_counts()["variant:fused_transform_rng=rec"] == 1,
            "fused_transform_rng: the launch did not take the record kernel")
    differ = int((rec != k.fused_transform_rng((seed, 31), latent, ops, variant="looped")).sum())
    print("  fused_transform_rng rec vs looped: %d of %d outputs differ" % (differ, rec.numel()))
    require(differ == 0, "fused_transform_rng: the record and the looped kernel differ in %d "
            "outputs" % differ)
    report.append({"output": "fused_transform_rng rec vs looped", "differ": differ})


def bimodal_target(D, device):
    """tests/test_rng_kernels.py's pool target: two Gaussians 0.5/0.5 at 0
    and 4 in every coordinate, covariance 0.5 I."""
    tm = np.zeros((2, D), np.float32)
    tm[1] += 4.0
    tc = np.array([np.eye(D) * 0.5] * 2, np.float32)
    return make_params((tm, tc, np.array([0.5, 0.5], np.float32), None), device)


def pool_inputs(tparams, starts, chol_scale, nan_chain=None):
    """``(x0T, e0, cholr)`` of a pool with identical diagonal proposals;
    chain ``nan_chain``'s Cholesky factor is NaN."""
    import torch
    from pypmc_tpu_torch.density import core

    C, D = starts.shape
    device = tparams.device
    x0T = torch.tensor(starts.T.copy(), device=device)
    chols = np.array([np.eye(D, dtype=np.float32) * chol_scale] * C)
    if nan_chain is not None:
        chols[nan_chain] = np.nan
    cholr = torch.tensor(chols.transpose(1, 2, 0).reshape(D * D, C).copy(), device=device)
    return x0T, core.mixture_logpdf_T(tparams, x0T), cholr


POOL_VARIANTS = ("thread", "warp")


def pool_variants(D):
    """The variants of fused_mcmc_pool that take dimension D."""
    from pypmc_tpu_torch.ops import _build

    return POOL_VARIANTS if D <= _build._POOL_WARP_D_MAX else POOL_VARIANTS[:1]


def pool_case(case, device, report, variant):
    """fused_mcmc_pool's invariants with ``variant`` forced: the last point
    is the final state, ef is fused_logq(xf) to 1e-3, a chain with a NaN
    Cholesky counts every step as NaN, accepts none and never moves; one
    seed gives one output, two seeds two."""
    import functools
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    C, D, steps, dof, seed = case
    print("case fused_mcmc_pool C=%d D=%d steps=%d %s, a %s a chain" % (
        C, D, steps, "t(%g)" % dof if dof else "gauss", variant))
    pool = functools.partial(k.fused_mcmc_pool, variant=variant)
    tparams = bimodal_target(D, device)
    tops = core._kernel_operands(tparams)
    starts = np.random.default_rng(seed).normal(2, 1, (C, D)).astype(np.float32)
    nan_chain = C // 3
    x0T, e0, cholr = pool_inputs(tparams, starts, 1.2 / math.sqrt(D), nan_chain)
    points, acc, nans, xf, ef = pool((seed, 5), x0T, e0, cholr, dof, tops, steps)
    sync(device)
    require(tuple(points.shape) == (steps, D, C), "fused_mcmc_pool: points of shape %s"
            % (tuple(points.shape),))
    require(bool(torch.equal(points[-1], xf)), "fused_mcmc_pool: last point != final state")
    tops64 = k.MixtureOperands(tops.packed.double(), tops.K, tops.dim, tops.student_t)
    compare("fused_mcmc_pool ef " + variant, ef, k.plain_logq(xf.double(), tops64), "pool",
            report)
    others = torch.arange(C, device=device) != nan_chain
    require(int(nans[nan_chain]) == steps and int(acc[nan_chain]) == 0,
            "fused_mcmc_pool: the NaN chain counted %d NaNs, %d accepts"
            % (int(nans[nan_chain]), int(acc[nan_chain])))
    require(bool((points[:, :, nan_chain] == x0T[:, nan_chain]).all()),
            "fused_mcmc_pool: the NaN chain moved")
    require(bool((nans[others] == 0).all()) and bool(torch.isfinite(points[:, :, others]).all()),
            "fused_mcmc_pool: NaN outside the NaN chain")
    rate = float(acc[others].double().mean()) / steps
    print("  %-34s mean acceptance %.3f" % ("fused_mcmc_pool", rate))
    require(0.0 < rate < 1.0, "fused_mcmc_pool: acceptance %.3f" % rate)
    again = pool((seed, 5), x0T, e0, cholr, dof, tops, steps)
    require(all(bool(torch.equal(a, b)) for a, b in zip((points, acc, nans, xf, ef), again)),
            "fused_mcmc_pool: one seed gave two outputs")
    other = pool((seed, 6), x0T, e0, cholr, dof, tops, steps)[0]
    require(not bool(torch.equal(other, points)), "fused_mcmc_pool: two seeds, one output")


POOL_MOMENT_TOL, POOL_ACCEPT_TOL, POOL_WALK_TOL = 0.25, 0.01, 0.05


def pool_distribution_case(case, device, report):
    """fused_mcmc_pool, each variant, against its plain version (another
    random stream) on tests/test_rng_kernels.py's bimodal target from
    starts at both modes: pooled post-burn-in means and standard deviations
    within 0.25 (tests/test_rng_kernels.py:352-375) and mean acceptance
    within POOL_ACCEPT_TOL.  The acceptance sees the Student-t proposal's
    scale, which the moments do not: the plain pool run without it must
    differ by more than the limit."""
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    C, D, steps, dof, seed = case
    tparams = bimodal_target(D, device)
    tops = core._kernel_operands(tparams)
    rng = np.random.default_rng(seed)
    starts = np.concatenate([rng.normal(0, 0.5, (C // 2, D)),
                             rng.normal(4, 0.5, (C - C // 2, D))]).astype(np.float32)
    x0T, e0, cholr = pool_inputs(tparams, starts, 1.2 / math.sqrt(D))
    out = {"kernel " + v: k.fused_mcmc_pool((seed, 7), x0T, e0, cholr, dof, tops, steps,
                                            variant=v) for v in POOL_VARIANTS}
    out["plain"] = k.plain_mcmc_pool((seed, 7), x0T, e0, cholr, dof, tops, steps)
    if dof is not None:
        out["plain without the scale"] = k.plain_mcmc_pool((seed, 8), x0T, e0, cholr, None,
                                                           tops, steps)
    sync(device)
    stats = {}
    for name, (points, acc, _, _, _) in out.items():
        x = points[steps // 2:].permute(0, 2, 1).reshape(-1, D).double().cpu().numpy()
        a = acc.double().cpu().numpy() / steps
        stats[name] = (x.mean(axis=0), x.std(axis=0), float(a.mean()),
                       float(a.std() / math.sqrt(C)))
    for v in POOL_VARIANTS:
        kern = stats["kernel " + v]
        dm = float(np.abs(kern[0] - stats["plain"][0]).max())
        ds = float(np.abs(kern[1] - stats["plain"][1]).max())
        da = abs(kern[2] - stats["plain"][2])
        # one sigma of the difference of two pools' mean acceptance
        sigma = math.hypot(kern[3], stats["plain"][3])
        label = "D=%d %s, a %s a chain" % (D, "t(%g)" % dof if dof else "gauss", v)
        print("  %-34s mean %.4f  std %.4f  acceptance %.4f = %.1f sigma (kernel %.4f)" % (
            "fused_mcmc_pool vs plain " + label, dm, ds, da, da / sigma, kern[2]))
        report.append({"output": "fused_mcmc_pool acceptance " + label, "statistical": True,
                       "max_abs_err": da, "tol": POOL_ACCEPT_TOL, "sigma": sigma,
                       "mean": dm, "std": ds})
        require(dm < POOL_MOMENT_TOL and ds < POOL_MOMENT_TOL and da < POOL_ACCEPT_TOL,
                "fused_mcmc_pool (%s): moments off the plain pool (%.3f, %.3f, %.4f)"
                % (v, dm, ds, da))
    if dof is not None:
        fault = abs(stats["kernel warp"][2] - stats["plain without the scale"][2])
        print("  %-34s acceptance %.4f" % ("planted fault: no Student-t scale", fault))
        require(fault > POOL_ACCEPT_TOL, "the acceptance check cannot see a pool without "
                "the Student-t scale (%.4f)" % fault)


def walk_inputs(C, D, seed, device, Kt=2):
    """A pool at the pipeline's shape whose target is nearly flat on the
    scale of a step: a Kt-component Gaussian target of standard deviation
    1000 (means 0 to 1 along every axis; weights 0.35/0.65 at Kt=2, else
    equal), starts near 0, and a random full lower-triangular proposal
    factor a chain, the Cholesky factor of I + 4 A A^T / D with A standard
    normal.  Returns ``(tops, x0T, e0, L (C, D, D))``."""
    import torch
    from pypmc_tpu_torch.density import core

    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (C, D, D))
    L = np.linalg.cholesky(np.eye(D)[None] + 4 * a @ a.transpose(0, 2, 1) / D)
    tm = np.repeat(np.linspace(0.0, 1.0, Kt)[:, None], D, axis=1).astype(np.float32)
    tc = np.array([np.eye(D) * 1e6] * Kt, np.float32)
    w = np.array([0.35, 0.65] if Kt == 2 else np.full(Kt, 1.0 / Kt), np.float32)
    tparams = make_params((tm, tc, w, None), device)
    x0T = torch.tensor(rng.normal(0, 1, (D, C)), dtype=torch.float32, device=device)
    return (core._kernel_operands(tparams), x0T, core.mixture_logpdf_T(tparams, x0T),
            torch.tensor(L, dtype=torch.float32, device=device))


def whitened_step_cov(points, x0T, L):
    """``(S (D, D), moves)``: the second moment of ``L_c^-1 (x_t - x_{t-1})``
    over every step that moved, in float64."""
    import torch

    x = torch.cat([x0T[None], points]).double()
    steps = (x[1:] - x[:-1]).permute(2, 1, 0)                    # (C, D, n)
    w = torch.linalg.solve_triangular(L.double(), steps, upper=False)
    moved = (steps != 0).any(dim=1)                              # (C, n)
    w = w.permute(0, 2, 1)[moved]
    return w.T @ w / w.shape[0], int(moved.sum())


def pool_walk_case(case, device, report):
    """fused_mcmc_pool, each variant, against its plain version at the
    pipeline's pool shape (D=40, a 2-component target) with a full proposal
    factor L_c a chain.  On a nearly flat target almost every proposal is
    accepted, so a chain's moves are its proposals, and L_c^-1 times a move
    has second moment s I: s = 1 for a Gaussian proposal, dof / (dof - 2)
    for Student-t.  The kernel's and the plain pool's moment are held to s I
    and to each other within POOL_WALK_TOL s.  The
    plain pool run with L_c transposed, with its diagonal alone and without
    the Student-t scale -- the faults this check is there to catch -- must
    each miss s I by more than the limit."""
    import functools
    import torch
    from pypmc_tpu_torch.ops import kernels as k

    C, D, steps, dof, seed = case
    tops, x0T, e0, L = walk_inputs(C, D, seed, device)
    s = 1.0 if dof is None else dof / (dof - 2.0)
    eye = torch.eye(D, dtype=torch.float64, device=device)
    as_cholr = lambda m: m.permute(1, 2, 0).reshape(D * D, C).contiguous()
    runs = {"kernel " + v: (functools.partial(k.fused_mcmc_pool, variant=v), L, dof)
            for v in POOL_VARIANTS}
    runs.update({"plain": (k.plain_mcmc_pool, L, dof),
            "planted fault: L transposed": (k.plain_mcmc_pool, L.transpose(1, 2), dof),
            "planted fault: diagonal of L": (k.plain_mcmc_pool, torch.diag_embed(
                torch.diagonal(L, dim1=1, dim2=2)), dof)})
    if dof is not None:
        runs["planted fault: no Student-t scale"] = (k.plain_mcmc_pool, L, None)
    label = "D=%d %s" % (D, "t(%g)" % dof if dof else "gauss")
    print("case fused_mcmc_pool walk C=%d %s steps=%d, full L a chain" % (C, label, steps))
    moments = {}
    for name, (pool, chol, dof_run) in runs.items():
        points, acc, nans, _, _ = pool((seed, 9), x0T, e0, as_cholr(chol), dof_run, tops, steps)
        moments[name], moves = whitened_step_cov(points, x0T, L)
        off = float((moments[name] - s * eye).abs().max()) / s
        print("  %-34s |S - sI|/s %.4f  acceptance %.5f  %d moves" % (
            name, off, float(acc.double().mean()) / steps, moves))
        require(int(nans.sum()) == 0, "fused_mcmc_pool walk: NaN proposals in " + name)
        if name.startswith("planted"):
            require(off > POOL_WALK_TOL, "the walk check cannot see a pool with " + name)
        else:
            require(off < POOL_WALK_TOL, "fused_mcmc_pool walk: %s's step moment is off "
                    "s I by %.4f s" % (name, off))
    for v in POOL_VARIANTS:
        diff = float((moments["kernel " + v] - moments["plain"]).abs().max())
        print("  %-34s |S_kernel - S_plain|/s %.4f" % ("fused_mcmc_pool %s vs plain" % v,
                                                       diff / s))
        report.append({"output": "fused_mcmc_pool walk vs plain %s, a %s a chain" % (label, v),
                       "statistical": True, "max_abs_err": diff, "tol": POOL_WALK_TOL * s})
        require(diff < POOL_WALK_TOL * s, "fused_mcmc_pool walk (%s): the kernel's step "
                "moment is off the plain pool's by %.4f s" % (v, diff / s))


def pool_agreement_case(case, device, report):
    """The two variants of fused_mcmc_pool over one step on the same
    inputs (walk_inputs: a nearly flat target, so that nearly every
    proposal is accepted and the points are the proposals): the same
    accept decisions and NaN counts, and the points and final log-densities
    to float32 rounding.  They draw the same Philox stream; only the order
    of the target's sums of squares differs (a warp reduction).  A target
    whose records pass shared memory takes both variants' device-memory
    paths (the looped thread kernel, the warp kernel's unstaged one)."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    C, D, Kt, dof, seed = case
    tops, x0T, e0, L = walk_inputs(C, D, seed, device, Kt)
    cholr = L.permute(1, 2, 0).reshape(D * D, C).contiguous()
    out = {v: k.fused_mcmc_pool((seed, 3), x0T, e0, cholr, dof, tops, 1, variant=v)
           for v in POOL_VARIANTS}
    sync(device)
    staged = _build.pool_smem_bytes(Kt, D, "warp") > 4 * 3 * (D + 8)
    label = "C=%d D=%d Kt=%d %s, one step%s" % (C, D, Kt, "t(%g)" % dof if dof else "gauss",
                                                  "" if staged else ", operands in device memory")
    print("case fused_mcmc_pool thread vs warp " + label)
    (pt, at, nt, xt, et), (pw, aw, nw, xw, ew) = out["thread"], out["warp"]
    require(bool(torch.equal(at, aw)) and bool(torch.equal(nt, nw)),
            "fused_mcmc_pool: the variants' accept decisions differ over one step")
    print("  %-34s %d of %d accepted by both" % ("accept decisions", int(at.sum()), C))
    compare("fused_mcmc_pool warp vs thread points " + label, pw, pt.double(), "maha", report)
    compare("fused_mcmc_pool warp vs thread ef " + label, ew, et.double(), "log", report)
    require(bool(torch.equal(pt[-1], xt)) and bool(torch.equal(pw[-1], xw)),
            "fused_mcmc_pool: last point != final state")


def wide_case(case, device, report):
    """The six kernels with a warp-a-particle path past D=128 at one
    shape: fused_propose_logq (with a target) on its own samples, as
    kernel_case checks it; fused_maha (lower and upper), fused_rho and
    fused_logq against their float64 plain versions (eval_case; there
    fused_vb_estep, whose limit is D=128, must raise); fused_transform on
    given normals (transform_case) and fused_transform_rng on its own
    samples (transform_rng_case)."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dead, seed = case
    arrs, _, _, _, ops, tops, ops64, tops64, tag = case_mixtures(case, device)
    print("case wide", tag)
    xT, lat, log_q, log_p = k.fused_propose_logq((seed, 11), ops, N, tops)
    sync(device)
    x64 = xT.double()
    compare("fused_propose_logq log_q", log_q, k.plain_logq(x64, ops64), "log", report)
    compare("fused_propose_logq log_p", log_p, k.plain_logq(x64, tops64), "log", report)
    check_samples("fused_propose_logq", xT, lat, arrs, report)
    again = k.fused_propose_logq((seed, 11), ops, N, tops)
    require(all(bool(torch.equal(a, b)) for a, b in zip((xT, lat, log_q, log_p), again)),
            "fused_propose_logq: one seed gave two outputs")
    require(not bool(torch.equal(k.fused_propose_logq((seed, 12), ops, N, tops)[0], xT)),
            "fused_propose_logq: two seeds, one output")
    del again, x64
    eval_case((K, D, N, student, dead, False, seed), device, report)
    transform_case((K, D, N, student, seed), device, report)
    transform_rng_case((K, D, N, student, dead, seed), device, report)


# past the thread kernels' D=128: K, Kt, D, N, Student-t proposal, Student-t
# target, dead component, seed
WIDE_CASES = [
    (1, 1, 129, 4099, True, False, False, 101),
    (2, 2, 200, 4099, False, True, False, 102),
    (1, 1, 1000, 4099, False, False, False, 103),
]


def mixture_particles(ops, N, seed, device, spread=1.5):
    """N particles from the live components of a packed mixture, each
    ``mu_k + spread L_k z`` with z standard normal (torch.Generator on the
    card, ``seed``), components drawn by weight."""
    import torch

    f = ops.fields()
    gen = torch.Generator(device=device).manual_seed(seed)
    comp = torch.multinomial(f["weights"], N, replacement=True, generator=gen)
    z = torch.randn((ops.dim, N), generator=gen, device=device)
    xT = torch.empty_like(z)
    for kk in range(ops.K):
        idx = torch.nonzero(comp == kk).squeeze(1)
        if idx.numel():
            xT[:, idx] = f["mu"][kk][:, None] + spread * (f["L"][kk] @ z[:, idx])
    return xT


def tiled_case(case, device, report):
    """fused_maha on lower (U = L^{-1}), upper (the VB E-step's) and full
    operands (maha_wide_check), fused_logq and fused_rho on a Gaussian
    mixture and on a Student-t one with a dead component (K > 1), and
    fused_transform on each, past the record kernels' D = 64.  fused_logq
    and fused_rho through the kernel the wrapper elects (the tensor-core
    kernel, counted as ``variant:...=mma``) and the tiled kernel forced
    (``=tiled``), each against its float64 plain version on the same
    particles (TOL "log", "rho"), equal on a second run; fused_rho's log q
    equal to fused_logq's bit for bit on the same kernel, a dead
    component's rho exactly 0.  fused_transform (transform_tiled_case) on
    components drawn by weight (a dead component's bucket empty)."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N, seed = case
    rng = np.random.default_rng(seed)
    label = "tiled K=%d D=%d N=%d" % (K, D, N)
    print("case " + label)
    for student, dead in ((False, False), (True, K > 1)):
        params = make_params(random_mixture(rng, K, D, student, dead), device)
        ops = core._kernel_operands(params)
        ops64 = k.MixtureOperands(ops.packed.double(), K, D, student)
        xT = mixture_particles(ops, N, seed, device)
        x64 = xT.double()
        tag = "%s t" % label if student else label
        rho_ref, lq_ref = k.plain_rho(x64, ops64)
        if not student:
            maha_wide_check(params, xT, x64, label, rng, report)
        elected = _build.eval_variant("fused_logq", D)
        require(elected == _build.eval_variant("fused_rho", D) == "mma",
                "%s: fused_logq and fused_rho elect %s past D = 64" % (tag, elected))
        for variant in (None, "tiled"):
            want = variant or elected
            vtag = "%s %s" % (tag, want)
            k.reset_launch_counts()
            got = k.fused_logq(xT, ops, variant=variant)
            counts = k.launch_counts()
            require(counts["variant:fused_logq=%s" % want] == counts["fused_logq"] == 1,
                    "%s fused_logq: the launch was not the %s kernel: %s"
                    % (vtag, want, {n: c for n, c in counts.items() if c}))
            compare("%s fused_logq" % vtag, got, lq_ref, "log", report)
            require(bool(torch.equal(got, k.fused_logq(xT, ops, variant=variant))),
                    "%s fused_logq: one input gave two outputs" % vtag)
            k.reset_launch_counts()
            rho, log_q = k.fused_rho(xT, ops, variant=variant)
            counts = k.launch_counts()
            require(counts["variant:fused_rho=%s" % want] == counts["fused_rho"] == 1,
                    "%s fused_rho: the launch was not the %s kernel: %s"
                    % (vtag, want, {n: c for n, c in counts.items() if c}))
            compare("%s fused_rho rho" % vtag, rho, rho_ref, "rho", report)
            compare("%s fused_rho log_q" % vtag, log_q, lq_ref, "log", report)
            require(bool(torch.equal(log_q, got)),
                    "%s: fused_rho's log q is not fused_logq's bit for bit" % vtag)
            if dead:
                require(bool((rho[K // 2] == 0).all()),
                        "%s: a dead component's rho is not 0" % vtag)
            again = k.fused_rho(xT, ops, variant=variant)
            require(bool(torch.equal(rho, again[0]) and torch.equal(log_q, again[1])),
                    "%s fused_rho: one input gave two outputs" % vtag)
            del got, rho, log_q, again
        del xT, x64, rho_ref, lq_ref
        transform_tiled_case(params, tag, seed, N, device, report)
        torch.cuda.empty_cache()


def maha_wide_check(params, xT, x64, label, rng, report):
    """fused_maha past D = 64 on particles xT (x64 their float64 copy) of
    the Gaussian mixture ``params``: its lower (U = L^{-1}), upper (the VB
    E-step's) and full operands (normal entries over sqrt(D), drawn from
    ``rng``), each through the wrapper's elected kernel (the tensor-core
    kernel, counted as ``variant:fused_maha=mma``) and each kernel forced
    (maha_variants_check: the tiled kernel and the tensor-core one) against
    the float64 plain version with TOL["maha"], equal on a second run; the
    tensor-core kernel also against the tiled kernel, within the same
    tolerance of each other."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    from pypmc_tpu_torch.density import core

    K, D, N = params.means.shape[0], params.dim, xT.shape[1]
    A, m, _ = vb_operands(params)
    f = core._kernel_operands(params).fields()
    full = torch.tensor(rng.normal(0, 1, (K, D, D)) / np.sqrt(D), dtype=torch.float32,
                        device=xT.device)
    elected = _build.eval_variant("fused_maha", D)
    for side, a, mm in (("lower", f["U"], f["mu"]), ("upper", A, m), ("full", full, m)):
        tag = "fused_maha %s %s" % (side, label)
        k.reset_launch_counts()
        got = k.fused_maha(xT, a, mm)
        counts = k.launch_counts()
        require(counts["variant:fused_maha=" + elected] == counts["fused_maha"] == 1,
                "%s: the elected launch was not the %s kernel: %s"
                % (tag, elected, {n: c for n, c in counts.items() if c}))
        ref = torch.cat([k.plain_maha(x64, a[k0:k1].double(), mm[k0:k1].double())
                         for k0, k1 in k._chunks(K, D, N)])
        maha_variants_check(tag, xT, a, mm, ref, report)
        compare("%s %s vs tiled" % (tag, elected), got,
                k.fused_maha(xT, a, mm, variant="tiled").double(), "maha", [])
        del got, ref


# maha_wide_case's shapes beside TILED_CASES: N a multiple of 4 (the
# tensor-core kernel's 16-byte x copies; also from an unaligned xT, its
# 4-byte ones) and the last particle tile partial: K, D, N, seed
MAHA_WIDE_CASES = [(3, 96, 4100, 215), (19, 200, 20_012, 216)]


def maha_wide_case(case, device, report):
    """maha_wide_check at one TILED_CASES shape (K, D, N, seed) on its own
    Gaussian mixture and N particles from it."""
    from pypmc_tpu_torch.density import core

    K, D, N, seed = case
    rng = np.random.default_rng(seed + 500)
    params = make_params(random_mixture(rng, K, D, False), device)
    xT = mixture_particles(core._kernel_operands(params), N, seed, device)
    print("case fused_maha past D = 64 K=%d D=%d N=%d" % (K, D, N))
    maha_wide_check(params, xT, xT.double(), "K=%d D=%d N=%d" % (K, D, N), rng, report)
    if N % 4 == 0:
        # the same particles 4 bytes past a 16-byte boundary take the 4-byte
        # copies: the same outputs bit for bit
        import torch
        from pypmc_tpu_torch.ops import kernels as k

        off = torch.empty(D * N + 1, device=device)[1:].view(D, N)
        off.copy_(xT)
        A, m, _ = vb_operands(params)
        require(bool(torch.equal(k.fused_maha(off, A, m), k.fused_maha(xT, A, m))),
                "fused_maha K=%d D=%d N=%d: an unaligned xT gave other outputs" % (K, D, N))


def transform_tiled_case(params, tag, seed, N, device, report):
    """fused_transform past D = 64 on N normals, components drawn by weight
    (component_draw) and scales (a Student-t mixture's sqrt(dof / chi2),
    else uniform in [0.5, 1.5)): the bucket pass's perm, slots and pos equal
    to ``_build.transform_tiles``' on the same components; the elected launch
    counted under its variant; the tiled pair (forced where the looped kernel
    is elected) to D = 128 equal to the looped kernel bit for bit and past it
    within TOL "log" of its float64 plain version; equal on a second run."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.ops.random import student_t_scale

    ops = core._kernel_operands(params)
    K, D = ops.K, ops.dim
    gen = torch.Generator(device=device).manual_seed(seed)
    zT = torch.randn((D, N), generator=gen, device=device)
    latent = component_draw(params, N, seed)
    scale = (student_t_scale(gen, params.dof[latent.long()], (N,)) if ops.student_t
             else torch.rand((N,), generator=gen, device=device) + 0.5)
    got_layout = [t.cpu().numpy() for t in k._transform_buckets(latent, K)]
    want_layout = _build.transform_tiles(latent.cpu().numpy(), K)
    want_slots = want_layout[1]
    require(all(np.array_equal(a, b) for a, b in zip(got_layout, want_layout)),
            "%s: the bucket pass's perm, slots and pos differ from _build.transform_tiles'" % tag)
    empty = K - len(set(want_slots[want_slots[:, 0] >= 0, 0].tolist()))
    elected = k._elect("fused_transform", K, D, None)
    k.reset_launch_counts()
    got = k.fused_transform(zT, latent, scale, ops)
    counts = k.launch_counts()
    require(counts["variant:fused_transform=" + elected] == counts["fused_transform"] == 1,
            "%s fused_transform: the launch was not the %s kernel: %s"
            % (tag, elected, {n: c for n, c in counts.items() if c}))
    if elected != "tiled":
        got = k.fused_transform(zT, latent, scale, ops, variant="tiled")
    ref = k.plain_transform(zT.double(), latent, scale.double(),
                            k.MixtureOperands(ops.packed.double(), K, D, ops.student_t))
    compare("%s fused_transform (%d of %d buckets empty)" % (tag, empty, K), got, ref, "log",
            report)
    if D <= _build._THREAD_D_MAX:
        differ = int((got != k.fused_transform(zT, latent, scale, ops, variant="looped")).sum())
        print("  %s fused_transform tiled vs looped: %d of %d outputs differ" % (tag, differ, D * N))
        require(differ == 0, "%s fused_transform: the tiled pair and the looped kernel differ in "
                "%d outputs" % (tag, differ))
    require(bool(torch.equal(got, k.fused_transform(zT, latent, scale, ops, variant="tiled"))),
            "%s fused_transform: one input gave two outputs" % tag)


def bucket_case(case, device):
    """The bucket pass on the card at one (K, N): components drawn uniformly
    (numpy, seed), every 97th outside [0, K) (left out), its perm, slots and
    pos equal to ``_build.transform_tiles``' bit for bit and to a second
    run's; fused_transform's moves into and out of bucket order held by the
    tiled pair on the same components (all valid) against the looped kernel
    at D = 65, bit for bit."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, N, seed = case
    rng = np.random.default_rng(seed)
    lat = rng.integers(0, K, N).astype(np.int32)
    lat[::97] = K
    latent = torch.as_tensor(lat, device=device)
    want = _build.transform_tiles(lat, K)
    got = [t.cpu().numpy() for t in k._transform_buckets(latent, K)]
    again = [t.cpu().numpy() for t in k._transform_buckets(latent, K)]
    differ = [int((a != b).sum()) for a, b in zip(got, want)]
    print("  bucket pass K=%d N=%d (%d blocks): perm, slots, pos %s entries differ from "
          "_build.transform_tiles'" % (K, N, _build.transform_bucket_blocks(N), differ))
    require(sum(differ) == 0, "the bucket pass at K=%d N=%d differs from its mirror: %s"
            % (K, N, differ))
    require(all(np.array_equal(a, b) for a, b in zip(got, again)),
            "the bucket pass at K=%d N=%d: one input gave two layouts" % (K, N))
    if N > 1 << 18:
        return
    D = 65
    params = make_params(random_mixture(rng, K, D, False), device)
    ops = core._kernel_operands(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    zT = torch.randn((D, N), generator=gen, device=device)
    scale = torch.rand((N,), generator=gen, device=device) + 0.5
    latent = torch.as_tensor(lat % K, device=device)
    x = k.fused_transform(zT, latent, scale, ops, variant="tiled")
    differ = int((x != k.fused_transform(zT, latent, scale, ops, variant="looped")).sum())
    require(differ == 0, "fused_transform at K=%d D=%d N=%d: the tiled pair and the looped "
            "kernel differ in %d outputs" % (K, D, N, differ))


# the bucket pass at the edges of its runs (one particle; 512, a run; one
# past it; 2^16, 128 blocks; 2^20 + 3, nine particles a thread, 456
# blocks; 2^22, 512 blocks of 32 a thread), the JAX rule's largest K past D
# = 64 among them: K, N, seed
BUCKET_CASES = [(2, 1, 401), (3, 512, 402), (60, 513, 403), (19, 65536, 404),
                (60, 65537, 405), (4, (1 << 20) + 3, 406), (7, 1 << 22, 407)]


# past the record kernels' D = 64, the tiled kernels of fused_maha,
# fused_logq, fused_rho and fused_transform: K = 1 and the JAX rule's largest
# K at D = 65, 96, 128, 129, 200, and K = 1 at D = 1,000 and 2,040 (the rule's
# reach); N ragged: K, D, N, seed
TILED_CASES = [
    (1, 65, 4099, 201), (60, 65, N_WIDE, 202), (1, 96, N_WIDE, 203), (41, 96, 4099, 204),
    (1, 128, 4099, 205), (30, 128, N_WIDE, 206), (1, 129, N_WIDE, 207), (30, 129, 4099, 208),
    (1, 200, 4099, 209), (19, 200, N_WIDE, 210), (1, 1000, N_WIDE, 211), (1, 2040, 4099, 212),
]


def drawn_case(case, device, report):
    """fused_propose_logq and fused_transform_rng past the record kernels'
    D = 64 on their drawn tiled products, at one shape (Kt = 0: no target):
    each launch counted as ``variant:...=tiled``; to D = 128 x and latent
    (fused_transform_rng: x) equal to the looped kernel's bit for bit (the
    same Philox words, Box-Muller, chi-square and FMA order), and every
    output with the seed words read from a tensor on the card equal to the
    words by value; log q and log p within TOL "log" of their float64 plain
    versions on the same particles and equal to fused_logq's bit for bit
    (the tiled route evaluates with its kernel); the samples' moments and
    components (check_samples), each component's particles about its mean,
    equal on a second run, another seed another draw."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dead, seed = case
    arrs, _, params, _, ops, tops, ops64, tops64, tag = case_mixtures(
        (K, max(Kt, 1), D, N, student, t_student, dead, seed), device)
    tops, tops64 = (tops, tops64) if Kt else (None, None)
    tag = "drawn " + tag.replace("Kt=%d" % max(Kt, 1), "Kt=%d" % Kt)
    print("case " + tag)
    words = torch.tensor((seed, 11), dtype=torch.int64, device=device)
    k.reset_launch_counts()
    out = k.fused_propose_logq((seed, 11), ops, N, tops)
    counts = k.launch_counts()
    require(counts["variant:fused_propose_logq=tiled"] == counts["fused_propose_logq"] == 1
            and counts["fused_logq"] == 0,
            "%s: fused_propose_logq did not take its tiled route: %s"
            % (tag, {n: c for n, c in counts.items() if c}))
    xT, lat, log_q = out[:3]
    x64 = xT.double()
    compare("fused_propose_logq %s log_q" % tag, log_q, k.plain_logq(x64, ops64), "log", report)
    require(bool(torch.equal(log_q, k.fused_logq(xT, ops))),
            "%s: log q is not fused_logq's bit for bit" % tag)
    if Kt:
        compare("fused_propose_logq %s log_p" % tag, out[3], k.plain_logq(x64, tops64), "log",
                report)
        require(bool(torch.equal(out[3], k.fused_logq(xT, tops))),
                "%s: log p is not fused_logq's bit for bit" % tag)
    del x64
    check_samples("fused_propose_logq %s" % tag, xT, lat, arrs, report)
    check_components("fused_propose_logq %s" % tag, xT, lat, arrs)
    again = k.fused_propose_logq((seed, 11), ops, N, tops)
    require(all(bool(torch.equal(a, b)) for a, b in zip(out, again)),
            "%s: one seed gave two outputs" % tag)
    by_pointer = k.fused_propose_logq(words, ops, N, tops)
    require(all(bool(torch.equal(a, b)) for a, b in zip(out, by_pointer)),
            "%s: the seed from a tensor drew other outputs than the words by value" % tag)
    require(not bool(torch.equal(k.fused_propose_logq((seed, 12), ops, N, tops)[0], xT)),
            "%s: two seeds, one output" % tag)
    del again, by_pointer
    if D <= _build._THREAD_D_MAX:
        looped = k.fused_propose_logq((seed, 11), ops, N, tops, variant="looped")
        differ = int((looped[0] != xT).sum()) + int((looped[1] != lat).sum())
        print("  %s fused_propose_logq tiled vs looped: %d of %d x and latent differ"
              % (tag, differ, xT.numel() + lat.numel()))
        require(differ == 0, "%s: the tiled route and the looped kernel draw %d different x or "
                "latent" % (tag, differ))
        report.append({"output": "fused_propose_logq tiled vs looped %s" % tag, "differ": differ})
        del looped
    latent = component_draw(params, N, seed)
    k.reset_launch_counts()
    x = k.fused_transform_rng((seed, 31), latent, ops)
    counts = k.launch_counts()
    require(counts["variant:fused_transform_rng=tiled"] == counts["fused_transform_rng"] == 1,
            "%s: fused_transform_rng did not take its drawn product: %s"
            % (tag, {n: c for n, c in counts.items() if c}))
    check_samples("fused_transform_rng %s" % tag, x, latent, arrs, report)
    require(bool(torch.equal(x, k.fused_transform_rng((seed, 31), latent, ops))),
            "%s fused_transform_rng: one seed gave two outputs" % tag)
    words[1] = 31
    require(bool(torch.equal(x, k.fused_transform_rng(words, latent, ops))),
            "%s fused_transform_rng: the seed from a tensor drew another x" % tag)
    if D <= _build._THREAD_D_MAX:
        differ = int((x != k.fused_transform_rng((seed, 31), latent, ops, variant="looped")).sum())
        print("  %s fused_transform_rng tiled vs looped: %d of %d outputs differ"
              % (tag, differ, x.numel()))
        require(differ == 0, "%s: fused_transform_rng's drawn product and looped kernel differ "
                "in %d outputs" % (tag, differ))
        report.append({"output": "fused_transform_rng tiled vs looped %s" % tag, "differ": differ})
    del x, xT, out
    torch.cuda.empty_cache()


# past the record kernels' D = 64, the drawn tiled products of
# fused_propose_logq and fused_transform_rng at K = 1 and the JAX rule's
# largest K + Kt (6 at D = 65, 4 at 96, 2 at 128 and 129, 1 from 200 to its
# reach, 248): K, Kt, D, N, Student-t proposal, Student-t target, dead
# component, seed
DRAWN_CASES = [
    (1, 0, 65, 4099, True, False, False, 301), (4, 2, 65, N_WIDE, True, True, True, 302),
    (1, 0, 96, N_WIDE, False, False, False, 303), (3, 1, 96, 4099, True, False, True, 304),
    (1, 1, 128, 4099, True, True, False, 305), (2, 0, 128, N_WIDE, False, False, False, 306),
    (1, 1, 129, N_WIDE, True, False, False, 307), (2, 0, 129, 4099, True, False, False, 308),
    (1, 0, 200, N_WIDE, True, False, False, 309), (1, 0, 248, 4099, False, False, False, 310),
]


def vmap_case(device, report):
    """A per-point target that reaches fused_logq (``evaluate_fn`` of a
    K=2, D=40 mixture), mapped with torch.func.vmap as the samplers map
    per-point targets: one launch for the whole block, against the float64
    log-density."""
    import torch
    from pypmc_tpu_torch.density import core, create_gaussian_mixture
    from pypmc_tpu_torch.ops import kernels as k

    rng = np.random.default_rng(19)
    mix = create_gaussian_mixture(*random_mixture(rng, 2, 40, False)[:3])
    x = torch.tensor(rng.normal(0, 2, (4096, 40)), dtype=torch.float32, device=device)
    point = mix.evaluate_fn(device=device)
    k.reset_launch_counts()
    got = torch.func.vmap(point)(x)
    sync(device)
    launches = k.launch_counts()["fused_logq"]
    require(launches == 1, "fused_logq under vmap: %d launches for one block" % launches)
    compare("fused_logq under vmap", got.cpu(), core.mixture_logpdf_T(
        mix.stacked_params(dtype=torch.float64, device="cpu"), x.T.cpu().double()), "log", report)


def weights_of(cumw):
    """The weights the tail-sum thresholds ``cumw`` draw, float64 numpy."""
    c = cumw.double().cpu().numpy()
    return np.diff(np.concatenate([[0.0], c]))


def check_draw(name, latent, zT, scale, cumw, dof, report, sub=1 << 20):
    """A draw of ``draw_proposal_inputs`` (the kernel's or the plain
    version's) on its own: every component in [0, K), a dead one never
    drawn, the frequencies against the weights (chi-square, p > 1e-6, from
    1000 particles); the normals' mean and variance, coordinate by
    coordinate, within 6 standard errors of 0 and 1, and a KS test of at
    most ``sub`` of them against the normal law; for a Student-t mixture
    ``dof / scale^2`` chi-square with the component's dof (KS of its
    probability transform), for a Gaussian one every scale 1.  Returns the
    frequencies and the probability transforms of the normals' and the
    chi-squares' subsamples."""
    import torch
    from scipy import stats as st

    w = weights_of(cumw)
    K, N = len(w), latent.shape[0]
    lat = latent.cpu().numpy()
    counts = np.bincount(lat, minlength=K)
    require(lat.min() >= 0 and counts.shape[0] == K, "%s: a component outside [0, K)" % name)
    require(np.all(counts[w == 0] == 0), "%s: a dead component was drawn" % name)
    live = w > 0
    if live.sum() > 1 and N >= 1000:
        p = float(st.chisquare(counts[live], N * w[live] / w[live].sum()).pvalue)
        require(p > 1e-6, "%s: component frequencies off (p=%.3g)" % (name, p))
    out = {"freq": counts / N}
    if zT is None:
        return out
    z = zT.double()
    zm = float((z.mean(dim=1).abs() * N ** 0.5).max())
    zv = float(((z.var(dim=1) - 1).abs() * (N / 2) ** 0.5).max())
    require(zm < 6 and zv < 6, "%s: normals' mean %.2f, variance %.2f sigma off" % (name, zm, zv))
    cols = max(1, sub // z.shape[0])
    u = st.norm.cdf(z[:, :cols].cpu().numpy().ravel())
    p_z = float(st.kstest(u, "uniform").pvalue)
    require(p_z > 1e-6, "%s: normals not normal (KS p=%.3g)" % (name, p_z))
    out["z"] = u
    report.append({"output": name + " normals mean", "statistical": True,
                   "max_abs_err": zm / N ** 0.5, "tol": 6 / N ** 0.5})
    if dof is None:
        require(bool(torch.all(scale == 1)), "%s: a Gaussian scale is not 1" % name)
        print("  %-34s components, normals: mean %.2f, variance %.2f sigma, KS p %.3g"
              % (name, zm, zv, p_z))
        return out
    nu = dof.double()[latent.long()]
    chi2 = (nu / scale.double() ** 2)[:sub].cpu().numpy()
    u = st.chi2.cdf(chi2, nu[:sub].cpu().numpy())
    p_s = float(st.kstest(u, "uniform").pvalue)
    require(p_s > 1e-6, "%s: dof / scale^2 not chi-square (KS p=%.3g)" % (name, p_s))
    out["chi2"] = u
    print("  %-34s components, normals: mean %.2f, variance %.2f sigma, KS p %.3g; "
          "dof / scale^2 KS p %.3g" % (name, zm, zv, p_z, p_s))
    return out


def draw_case(case, device, report):
    """draw_proposal_inputs against its plain version in distribution, in
    the case's dtype: both draws on their own (:func:`check_draw`), then
    each other's (the frequencies within 6 standard errors of their
    difference, a two-sample KS of the normals' and the chi-squares'
    probability transforms); without normals the same components; one seed
    one draw, two seeds two."""
    import torch
    from scipy import stats as st
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N, student, dead, dtype, seed = case
    means, covs, w, dofs = random_mixture(np.random.default_rng(seed), K, D, student, dead)
    if dead and K > 2:
        w = w.copy()
        w[-1] = 0.0      # a dead trailing component too
        w = (w / w.sum()).astype(np.float32)
    params = make_params((means, covs, w, dofs), device).to(dtype=getattr(torch, dtype))
    cumw = core._cumulative_weights(params.weights).contiguous()
    dof = None if params.dof is None else params.dof.contiguous()
    tag = "draw_proposal_inputs K=%d D=%d N=%d %s%s %s" % (
        K, D, N, "t" if student else "gauss", " dead" if dead else "", dtype)
    print("case " + tag)
    k.reset_launch_counts()
    got = k.draw_proposal_inputs((seed, 5), cumw, dof, N, D, True)
    sync(device)
    require(k.launch_counts()["draw_proposal_inputs"] == 1, "%s: no one launch" % tag)
    require(got[0].dtype == torch.int32 and got[1].dtype == got[2].dtype == params.means.dtype
            and tuple(got[1].shape) == (D, N) and tuple(got[2].shape) == (N,),
            "%s: outputs %s" % (tag, [(t.dtype, tuple(t.shape)) for t in got]))
    ref = k.plain_draw_proposal_inputs((seed, 5), cumw, dof, N, D, True)
    a = check_draw("draw_proposal_inputs", *got, cumw, dof, report)
    b = check_draw("  its plain version", *ref, cumw, dof, [])
    se = np.sqrt(2 * weights_of(cumw) * (1 - weights_of(cumw)) / N)
    diff = np.abs(a["freq"] - b["freq"])
    worst = int(np.argmax(diff - 6 * se))
    require(np.all(diff <= 6 * se), "%s: frequencies %s against the plain version's %s"
            % (tag, a["freq"], b["freq"]))
    if se[worst] > 0:    # K=1: nothing to compare
        report.append({"output": "draw_proposal_inputs frequencies vs plain " + tag,
                       "statistical": True, "max_abs_err": float(diff[worst]),
                       "tol": float(6 * se[worst])})
    for key in ("z", "chi2"):
        if key in a:
            p = float(st.ks_2samp(a[key], b[key]).pvalue)
            print("  %-34s two-sample KS against the plain version's: p %.3g"
                  % ("draw_proposal_inputs " + key, p))
            require(p > 1e-6, "%s: %s against the plain version's, KS p=%.3g" % (tag, key, p))
    only = k.draw_proposal_inputs((seed, 5), cumw, dof, N, D, False)
    require(only[1] is None and only[2] is None and bool(torch.equal(only[0], got[0])),
            "%s: without normals, other components" % tag)
    again = k.draw_proposal_inputs((seed, 5), cumw, dof, N, D, True)
    other = k.draw_proposal_inputs((seed, 6), cumw, dof, N, D, True)
    require(all(bool(torch.equal(x, y)) for x, y in zip(got, again)),
            "%s: one seed gave two draws" % tag)
    require(not bool(torch.equal(got[1], other[1])), "%s: two seeds, one draw" % tag)


# K, D, N, Student-t, dead components, dtype, seed
DRAW_CASES = [
    (32, 40, N_FLAGSHIP, True, False, "float32", 121),    # the pipeline's PMC proposal
    (12, 40, N_WIDE, False, True, "float32", 122),
    (10, 10, N_FLAGSHIP, True, True, "float64", 123),
    (1, 40, N_WIDE, True, False, "float64", 124),
    (1, 7, N_ODD, False, False, "float32", 125),
    (5, 3, N_ODD, False, True, "float64", 126),
]
# propose_T's draw and transform in one launch, each form against the two
# launches it replaces, bit for bit (csrc/draw.cu draw_transform_rec_kernel)
FUSED_DRAWS = ("fused_draw_transform", "fused_draw_transform_rng")


def two_launch_draw(name, ops, seed, n):
    """The two launches ``name`` (one of FUSED_DRAWS) replaces, as propose_T
    made them: draw_proposal_inputs on the mixture's thresholds and dofs,
    then fused_transform on its normals and scales, or fused_transform_rng
    keyed by the words with bit 0 of the second flipped (a seed tensor is
    flipped on the card) -> ``(xT, latent)``."""
    from pypmc_tpu_torch import _rng
    from pypmc_tpu_torch.ops import kernels as k

    f = ops.fields()
    dof = f["dof"] if ops.student_t else None
    if name == "fused_draw_transform":
        latent, zT, scale = k.draw_proposal_inputs(seed, f["cumw"], dof, n, ops.dim, True)
        return k.fused_transform(zT, latent, scale, ops), latent
    latent = k.draw_proposal_inputs(seed, f["cumw"], dof, n, ops.dim, False)[0]
    return k.fused_transform_rng(_rng.flip_bit(seed, 0), latent, ops), latent


def fused_draw_case(case, device, report):
    """Both fused forms on one mixture: each launch (one, counted) equal bit
    for bit, xT and latent, to the two launches it replaces
    (:func:`two_launch_draw`), with the seed by value and by pointer, on the
    plan's records (staged, or read from device memory); each on its own
    draws (moments, component frequencies, each component's mean, no dead
    component drawn; the first SAMPLE_N particles) beside its plain
    version's, the two versions' frequencies within 6 standard errors of
    each other; one seed one draw, two seeds two."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N, student, dead, seed = case
    arrs = random_mixture(np.random.default_rng(seed), K, D, student, dead)
    if dead and K > 2:
        w = arrs[2].copy()
        w[-1] = 0.0      # a dead trailing component too
        arrs = (arrs[0], arrs[1], (w / w.sum()).astype(np.float32), arrs[3])
    params = make_params(arrs, device)
    ops = core._kernel_operands(params)
    require(bool(torch.equal(ops.fields()["cumw"], core._cumulative_weights(params.weights))),
            "the packed thresholds are not propose_T's")
    plan = _build.draw_transform_plan(K, D)
    words = {"value": (seed, 5),
             "pointer": torch.tensor((seed, 5), dtype=torch.int64, device=device)}
    for name in FUSED_DRAWS:
        fn = getattr(k, name)
        tag = "%s K=%d D=%d N=%d %s%s" % (name, K, D, N, "t" if student else "gauss",
                                          " dead" if dead else "")
        print("case %s: records staged %s, %d B" % (tag, plan[1], plan[4]))
        got = {}
        for form, seed_words in words.items():
            k.reset_launch_counts()
            got[form] = fn(seed_words, ops, N)
            sync(device)
            launched = {c: v for c, v in k.launch_counts().items() if v}
            require(launched == {name: 1}, "%s: launches %s" % (tag, launched))
            ref = two_launch_draw(name, ops, seed_words, N)
            sync(device)
            differ = sum(int((a != b).sum()) for a, b in zip(got[form], ref))
            err = float((got[form][0] - ref[0]).abs().max())
            print("  %-34s %d of %d outputs differ from the two launches (seed by %s)"
                  % (name, differ, (D + 1) * N, form))
            require(differ == 0, "%s: %d outputs differ from the two launches (seed by %s)"
                    % (tag, differ, form))
            report.append({"output": "%s vs two launches %s, seed by %s" % (name, tag, form),
                           "max_abs_err": err, "tol": 0.0, "differ": differ})
        n = min(N, SAMPLE_N)
        xT, latent = got["value"][0][:, :n], got["value"][1][:n]
        check_samples(name, xT, latent, arrs, report)
        check_components(name, xT, latent, arrs)
        plain = getattr(k, "plain_" + name[len("fused_"):])((seed, 5), ops, n)
        check_samples("  its plain version", *plain, arrs, [])
        w = arrs[2].astype(np.float64)
        freq = [np.bincount(t.cpu().numpy(), minlength=K) / n for t in (latent, plain[1])]
        se = np.sqrt(2 * w * (1 - w) / n)
        require(np.all(np.abs(freq[0] - freq[1]) <= 6 * se + 1e-12),
                "%s: frequencies %s against the plain version's %s" % (tag, freq[0], freq[1]))
        again, other = fn((seed, 5), ops, N), fn((seed, 6), ops, N)
        require(all(bool(torch.equal(a, b)) for a, b in zip(got["value"], again)),
                "%s: one seed gave two draws" % tag)
        require(not bool(torch.equal(got["value"][0], other[0])), "%s: two seeds, one draw" % tag)
        del got, again, other, plain
    torch.cuda.empty_cache()


# the particles of a fused case's draw held to the mixture in distribution
SAMPLE_N = 1 << 18
# K, D, N, Student-t, dead components (a trailing one too), seed: DRAW_CASES'
# shapes in float32, then D = 8, 16, 40 and 64, the records staged (K=32 at
# D=40: the pipeline's PMC proposal; K=4 at D=64) and read from device
# memory (K=40 at D=40, K=14 at D=64)
FUSED_DRAW_CASES = [
    (32, 40, N_FLAGSHIP, True, False, 141),
    (12, 40, N_WIDE, False, True, 142),
    (10, 10, N_FLAGSHIP, True, True, 143),
    (1, 40, N_WIDE, True, False, 144),
    (1, 7, N_ODD, False, False, 145),
    (5, 3, N_ODD, False, True, 146),
    (8, 8, N_WIDE, True, True, 147),
    (6, 16, N_WIDE, False, False, 148),
    (32, 40, N_WIDE, False, True, 149),
    (40, 40, N_WIDE, True, False, 150),
    (40, 40, N_WIDE, False, True, 151),
    (4, 64, N_WIDE, True, False, 152),
    (14, 64, N_WIDE, False, True, 153),
]
TRANSFORM_CASES = [
    # K, D, N, Student-t, seed
    (10, 10, N_PLAIN_MAX, True, 41),
    (16, 40, N_WIDE, False, 42),
    (3, 1, N_ODD, True, 43),
    (32, 40, N_WIDE, True, 44),          # the pipeline's PMC proposal
    # the pipeline's draws of 2^20 from it, Gaussian and Student-t scales;
    # N past a multiple of the block; the DMAX 40 record kernel's lower end
    # and the DMAX 64 one; the records past half an SM (device memory)
    (32, 40, N_FLAGSHIP, False, 45),
    (32, 40, N_FLAGSHIP, True, 46),
    (10, 10, N_ODD, True, 47),
    (3, 33, N_WIDE, False, 48),
    (5, 64, N_WIDE, True, 49),
    (40, 40, N_WIDE, True, 50),
]
TRANSFORM_RNG_CASES = [
    # K, D, N, Student-t, dead component, seed
    (10, 10, N_FLAGSHIP, True, False, 51),
    (10, 10, N_ODD, False, True, 52),
    (11, 40, N_WIDE, True, False, 53),
]
# the draws' record kernels against their looped kernels, bit for bit:
# K, Kt (0: no target), D, N, Student-t proposal, Student-t target, dead
# component, records staged (the plan's), seed
DRAW_VARIANT_CASES = [
    (10, 2, 10, N_FLAGSHIP, True, False, False, True, 111),     # the flagship
    (10, 2, 10, N_FLAGSHIP, False, False, False, True, 112),
    (10, 0, 10, N_FLAGSHIP, True, False, False, True, 113),     # no target
    (10, 2, 10, N_ODD, True, True, True, True, 114),            # a dead component, odd N
    (3, 2, 1, N_ODD, True, False, False, True, 115),
    (4, 2, 7, N_ODD, False, True, False, True, 116),
    (3, 2, 33, N_WIDE, True, False, False, True, 117),          # DMAX 40's lower end
    (9, 2, 40, N_FLAGSHIP, True, False, False, True, 118),      # the widest K the rule admits
    (9, 2, 40, N_WIDE, False, True, False, True, 119),
    (7, 0, 62, N_WIDE, True, False, False, True, 120),          # the rule's largest records
    (4, 2, 62, N_WIDE, True, False, False, True, 121),
    (4, 2, 64, N_WIDE, False, True, False, True, 122),          # DMAX 64's upper end
    (40, 2, 40, N_WIDE, True, False, False, False, 123),        # records in device memory
    (200, 2, 10, N_WIDE, True, False, True, False, 124),        # past the rule: device memory
]
# K, D, N, Student-t, dead component, records staged, seed
TRANSFORM_RNG_VARIANT_CASES = [
    (10, 10, N_FLAGSHIP, True, False, True, 131),
    (10, 10, N_ODD, False, True, True, 132),
    (11, 40, N_FLAGSHIP, True, False, True, 133),                 # the route
    (11, 40, N_WIDE, False, False, True, 134),
    (3, 1, N_ODD, True, False, True, 135),
    (3, 33, N_WIDE, False, False, True, 136),
    (4, 64, N_WIDE, True, False, True, 137),
    (40, 64, N_WIDE, True, False, False, 138),                    # records in device memory
]
POOL_CASES = [
    # C, D, steps, Student-t proposal dof (None: Gaussian), seed
    (200, 2, 64, None, 61),
    (130, 2, 32, 3.0, 62),
    (257, 10, 50, None, 63),
    (96, 40, 40, None, 64),
    # the pipeline's pool: 32 chains, D=40, 400 steps
    (32, 40, 400, None, 65),
    (32, 40, 400, 5.0, 66),
    # past the warp variant's D=64: the looped thread kernel alone
    (64, 70, 20, None, 60),
]
# the two variants over one step: C, D, Kt, Student-t proposal dof, seed;
# the last two with the target's records past shared memory
POOL_AGREEMENT_CASES = [(32, 40, 2, None, 67), (32, 40, 2, 5.0, 68), (96, 17, 2, None, 69),
                        (64, 64, 30, None, 70), (40, 24, 200, 5.0, 71)]
# the pooled mean moves with the chains that hop between the modes: 4096
# chains put the difference of two pools' means at ~0.04 (one sigma), that
# of their mean acceptance at ~0.0008
POOL_DISTRIBUTION_CASES = [(4096, 2, 200, None, 71), (4096, 2, 200, 5.0, 72)]
# the pipeline's pool shape; 2050 chains x 200 steps put the noise of the
# whitened step moment near 0.01 s at its largest entry
POOL_WALK_CASES = [(2050, 40, 200, None, 81), (2050, 40, 200, 5.0, 82)]


def phase_kernels(device, cases, eval_cases):
    import torch
    from pypmc_tpu_torch.ops import kernels as k

    report = []
    for case in cases:
        kernel_case(case, device, report)
        torch.cuda.empty_cache()
    for case in eval_cases:
        eval_case(case, device, report)
        torch.cuda.empty_cache()
    for case in MAHA_CASES:
        maha_case(case, device, report)
        torch.cuda.empty_cache()
    maha_nonfinite_case(device, report)
    evaluation_nonfinite_case(device, report)
    vb_nonfinite_case(device, report)
    for case in PMC_STATS_CASES:
        pmc_stats_weighted_case(case, device, report)
    pmc_stats_nonfinite_case(device, report)
    for case in GRAM_CASES:
        gram_case(case, device, report)
        torch.cuda.empty_cache()
    for case in TRANSFORM_CASES:
        transform_case(case, device, report)
        torch.cuda.empty_cache()
    for case in TRANSFORM_RNG_CASES:
        transform_rng_case(case, device, report)
    for case in DRAW_VARIANT_CASES:
        draw_variants_case(case, device, report)
    for case in TRANSFORM_RNG_VARIANT_CASES:
        transform_rng_variants_case(case, device, report)
    torch.cuda.empty_cache()
    for case in POOL_CASES:
        for variant in pool_variants(case[1]):
            pool_case(case, device, report, variant)
    for case in POOL_AGREEMENT_CASES:
        pool_agreement_case(case, device, report)
    for case in POOL_DISTRIBUTION_CASES:
        pool_distribution_case(case, device, report)
    for case in POOL_WALK_CASES:
        pool_walk_case(case, device, report)
    for case in WIDE_CASES:
        wide_case(case, device, report)
        torch.cuda.empty_cache()
    for case in TILED_CASES:
        tiled_case(case, device, report)
    for case in MAHA_WIDE_CASES:
        maha_wide_case(case, device, report)
    for case in BUCKET_CASES:
        bucket_case(case, device)
    torch.cuda.empty_cache()
    for case in DRAWN_CASES:
        drawn_case(case, device, report)
    vmap_case(device, report)
    torch.cuda.empty_cache()
    for K in SOLVE_DOFS_K:
        for dtype in (torch.float32, torch.float64):
            solve_dofs_case(K, dtype, device, report)
            solve_dofs_variants_case(K, dtype, device)
    for case in SEED_POINTER_CASES:
        seed_pointer_case(case, device)
        torch.cuda.empty_cache()
    for case in REPLAY_CASES:
        seed_replay_case(device, case)
    for case in DRAW_CASES:
        draw_case(case, device, report)
        torch.cuda.empty_cache()
    for case in FUSED_DRAW_CASES:
        fused_draw_case(case, device, report)
    # a CUDA tensor of another dtype never reaches a plain version
    params, _, _ = flagship_problem(device)
    from pypmc_tpu_torch.density import core
    ops = core._kernel_operands(params)
    ops64 = k.MixtureOperands(ops.packed.double(), ops.K, ops.dim, ops.student_t)
    try:
        k.fused_logq(torch.zeros((10, 256), dtype=torch.float64, device=device), ops64)
    except TypeError:
        print("  float64 CUDA input to fused_logq raises TypeError: ok")
    else:
        raise SmokeFailure("fused_logq accepted a float64 CUDA tensor")
    return report


# --------------------------------------------------------------------- #
# the dof solve (csrc/solve_dofs.cu) and the chains' CUDA graphs        #
# --------------------------------------------------------------------- #

SOLVE_DOFS_K = (10, 200, 400)
DOF_STEPS, MINDOF, MAXDOF = 100, 1e-5, 1e3
# a root the kernel and its plain version reach by different last steps
# (their conditions round apart near 0) holds when the float64 condition
# there is within DOF_ULPS ulps of the kernel's dtype of the condition's
# terms |const| + |log(nu / 2)| + |digamma(nu / 2)|, beside the bracket's
# resolution (2 ulps of the root times the condition's slope)
DOF_ULPS = 8.0
# the serial-latency model of one bisection step (no profiler sees inside
# a kernel here): clocks of a condition's dependent chain (two logs, the
# asymptotic series' divisions and FMAs) and of each unit of nu / 2 below
# 10 (a division and an add), at the card's largest SM clock
DOF_CONDITION_CLOCKS, DOF_UNIT_CLOCKS = 200, 40


def dof_problem(K, seed, device, dtype):
    """``(const, old_dofs)`` of K components: constants as PMC updates give
    them (their roots log-uniform in [1, 300] dofs) after a NaN, +inf, -inf
    and a constant past each clamp (0.5 > 0: maxdof; -3e5 < -2e5: mindof),
    as many of those as K holds."""
    import torch
    from scipy.special import digamma

    rng = np.random.default_rng(seed)
    nu = np.exp(rng.uniform(0.0, np.log(300.0), K))
    c = digamma(nu / 2) - np.log(nu / 2)
    c[:min(K, 5)] = np.array([np.nan, np.inf, -np.inf, 0.5, -3e5])[:min(K, 5)]
    old = rng.uniform(2.0, 30.0, K)
    return (torch.tensor(c, dtype=dtype, device=device),
            torch.tensor(old, dtype=dtype, device=device))


def dof_condition64(c, nu):
    """``(const + log(nu / 2) - digamma(nu / 2), the sum of its terms'
    magnitudes)`` in float64."""
    from scipy.special import digamma

    x = nu / 2
    return c + np.log(x) - digamma(x), np.abs(c) + np.abs(np.log(x)) + np.abs(digamma(x))


def solve_dofs_check(label, const, old, steps, mindof, maxdof, report):
    """Kernel ``solve_dofs`` on ``(const, old)`` against its plain version:
    in the same dtype on the card (the roots equal bit for bit counted;
    every clamped, NaN and infinite entry equal, a NaN's within an ulp of
    mindof) and against the float64 plain version, each root within
    DOF_ULPS of the float64 condition's zero (module note) or equal to the
    float64 root in the kernel's dtype.  Records the worst root's |float64
    condition| against its tolerance."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k

    got = k.solve_dofs(const, old, steps, mindof, maxdof)
    same = k.plain_solve_dofs(const, old, steps, mindof, maxdof)
    ref64 = k.plain_solve_dofs(const.double(), old.double(), steps, mindof, maxdof)
    sync(const.device)
    g, r, c = (t.double().cpu().numpy() for t in (got, same, const))
    r64 = ref64.cpu().numpy()
    dtype = np.float32 if const.dtype == torch.float32 else np.float64
    lo, hi = dtype(mindof), dtype(maxdof)
    special = ~np.isfinite(c) | (r == lo) | (r == hi) | (np.abs(r - lo) <= np.spacing(lo))
    require(np.array_equal(g[special], r[special], equal_nan=True),
            "%s: clamped, NaN or infinite entries differ: %s vs %s"
            % (label, g[special], r[special]))
    nan = np.isnan(c)
    require(steps < 60 or np.all(np.abs(g[nan] - lo) <= np.spacing(lo)),
            "%s: a NaN const gave %s, not mindof" % (label, g[nan]))
    regular = ~special
    residual, terms = dof_condition64(c[regular], g[regular])
    slope = np.abs(dof_condition64(c[regular], g[regular] * (1 + 1e-6))[0]
                   - dof_condition64(c[regular], g[regular] * (1 - 1e-6))[0]) / (2e-6 * g[regular])
    eps = np.finfo(dtype).eps
    allowed = DOF_ULPS * eps * terms + 2 * np.spacing(g[regular].astype(dtype)) * slope
    as_ref = g[regular] == r64[regular].astype(dtype)
    ratio = np.where(as_ref, 0.0, np.abs(residual) / allowed)
    worst = int(np.argmax(ratio)) if ratio.size else None
    err, tol = ((float(abs(residual[worst])), float(allowed[worst])) if worst is not None
                else (0.0, 1.0))
    equal = int((g == r).sum())
    print("  %-34s %d of %d roots equal the %s plain version's bit for bit, %d the float64 "
          "one's; |float64 condition| at the worst root %.3e, tol %.3e"
          % (label, equal, len(g), const.dtype, int(as_ref.sum()), err, tol))
    report.append({"output": label, "max_abs_err": err, "tol": tol})
    require(not ratio.size or ratio.max() <= 1.0,
            "%s: %d roots off the float64 condition's zero (worst %.3e, tol %.3e)"
            % (label, int((ratio > 1).sum()), err, tol))


def solve_dofs_case(K, dtype, device, report):
    solve_dofs_check("solve_dofs K=%d %s" % (K, str(dtype).split(".")[-1]),
                     *dof_problem(K, K, device, dtype), DOF_STEPS, MINDOF, MAXDOF, report)


# the bisection steps the kernels are held at: no step, a short last
# round of the warp kernel (1, 7), one whole round (5), the PMC default
DOF_STEPS_CASES = (0, 1, 5, 7, 100)


def solve_dofs_variants_case(K, dtype, device):
    """The warp kernel (the default), the serial kernel (``variant=
    "serial"``, PR 14's) and the plain version in the same dtype, on the
    card, on :func:`dof_problem`'s constants (a NaN, both infinities, one
    past each clamp) at every ``DOF_STEPS_CASES`` entry: equal bit for
    bit."""
    from pypmc_tpu_torch.ops import kernels as k

    const, old = dof_problem(K, K + 1, device, dtype)
    for steps in DOF_STEPS_CASES:
        warp = k.solve_dofs(const, old, steps, MINDOF, MAXDOF)
        serial = k.solve_dofs(const, old, steps, MINDOF, MAXDOF, variant="serial")
        plain = k.plain_solve_dofs(const, old, steps, MINDOF, MAXDOF)
        sync(device)
        differ = [int((a != b).sum()) for a, b in ((warp, plain), (serial, warp))]
        require(differ == [0, 0],
                "solve_dofs K=%d %s steps=%d: %d roots of the warp kernel differ from the "
                "plain version's, %d of the serial kernel from the warp kernel's"
                % (K, dtype, steps, differ[0], differ[1]))
    print("  solve_dofs K=%d %s: the warp kernel = the serial kernel = the plain version, bit "
          "for bit, at steps %s" % (K, str(dtype).split(".")[-1], list(DOF_STEPS_CASES)))


# (kernel, K, D, Kt, N, variant): each seeded kernel's launches with the
# words in a tensor against the words by value; every kernel variant that
# draws (the draws' record, looped and warp kernels, the step's three passes,
# the K-blocked step's two first launches, the proposal inputs' draw in
# float32 and, variant "float64", in float64)
SEED_POINTER_CASES = [
    ("fused_propose_logq", 10, 10, 2, N_FLAGSHIP, None),
    ("fused_propose_logq", 10, 10, 2, N_FLAGSHIP, "looped"),
    ("fused_propose_logq", 1, 200, 0, 1 << 16, None),
    ("fused_is_pmc_step", 10, 10, 2, N_FLAGSHIP, "reg"),
    ("fused_is_pmc_step", 10, 10, 2, N_FLAGSHIP, "table"),
    ("fused_is_pmc_step", 3, 40, 2, 1 << 18, "gram"),        # the record draw, then the pass
    ("fused_is_pmc_step", 1, 128, 1, 1 << 18, "gram"),       # the drawn product and fused_logq
    ("fused_is_pmc_step_blocked", 200, 10, 2, 1 << 18, None),
    ("fused_is_pmc_step_blocked", 96, 40, 2, 1 << 16, None),
    ("fused_transform_rng", 10, 10, 0, N_FLAGSHIP, None),
    ("fused_transform_rng", 10, 10, 0, N_FLAGSHIP, "looped"),
    ("fused_transform_rng", 11, 40, 0, N_FLAGSHIP, None),
    ("fused_transform_rng", 40, 40, 0, 1 << 16, None),      # records in device memory
    ("fused_transform_rng", 1, 200, 0, 1 << 16, None),
    ("draw_proposal_inputs", 32, 40, 0, N_FLAGSHIP, None),
    ("draw_proposal_inputs", 10, 10, 0, N_FLAGSHIP, "float64"),
    ("fused_draw_transform", 32, 40, 0, N_FLAGSHIP, None),
    ("fused_draw_transform", 40, 40, 0, 1 << 16, None),       # records in device memory
    ("fused_draw_transform_rng", 11, 40, 0, N_FLAGSHIP, None),
    ("fused_draw_transform_rng", 10, 10, 0, N_FLAGSHIP, None),
]
# one launch captured as a CUDA graph and replayed with two seeds in its
# tensor: a step's (the register pass's, and the Gram route's composition
# past D = 64), the two launches of propose_T's routes past D = 64 and its
# one launch to D = 64 (each replay against that seed's two launches)
REPLAY_CASES = [("fused_is_pmc_step", 10, 10, 2, N_FLAGSHIP, None),
                ("fused_is_pmc_step", 1, 128, 1, 1 << 18, None),
                ("fused_transform_rng", 11, 40, 0, N_FLAGSHIP, None),
                ("draw_proposal_inputs", 32, 40, 0, N_FLAGSHIP, None),
                ("fused_draw_transform", 32, 40, 0, N_FLAGSHIP, None),
                ("fused_draw_transform_rng", 11, 40, 0, N_FLAGSHIP, None)]
SEED_WORDS = (0x9E3779B9, 0x7F4A7C15)


def tensors_of(value):
    """The tensors of a kernel's outputs (tuples and dicts of them)."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return [t for key in sorted(value) for t in tensors_of(value[key])]
    return [t for v in value for t in tensors_of(v)]


def seeded_call(case, device, two_launches=False):
    """``call``: ``call(seed)`` launches ``case``'s kernel on a seeded
    Student-t proposal (and a Gaussian target); for the fused draws with
    ``two_launches``, the two launches they replace instead."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    kernel, K, D, Kt, N, variant = case
    rng = np.random.default_rng(K * 1000 + D)
    params = make_params(random_mixture(rng, K, D, True), device)
    ops = core._kernel_operands(params)
    tops = (core._kernel_operands(make_params(random_mixture(rng, Kt, D, False), device))
            if Kt else None)
    kw = {} if variant is None else {"variant": variant}
    fn = getattr(k, kernel)
    if kernel == "draw_proposal_inputs":
        p = params.to(dtype=getattr(torch, variant or "float32"))
        cumw = core._cumulative_weights(p.weights).contiguous()
        return lambda seed: fn(seed, cumw, p.dof.contiguous(), N, D, True)
    if kernel == "fused_transform_rng":
        latent = component_draw(params, N, K)
        return lambda seed: fn(seed, latent, ops, **kw)
    if kernel == "fused_propose_logq":
        return lambda seed: fn(seed, ops, N, tops, **kw)
    if kernel in FUSED_DRAWS:
        if two_launches:
            return lambda seed: two_launch_draw(kernel, ops, seed, N)
        return lambda seed: fn(seed, ops, N)
    return lambda seed: fn(seed, ops, tops, N, True, **kw)


def seed_pointer_case(case, device):
    """``case``'s kernel with its seed words in a 2-word int64 tensor on the
    card (read inside the kernel) against the same words by value: every
    output equal bit for bit."""
    import torch

    call = seeded_call(case, device)
    by_value = tensors_of(call(SEED_WORDS))
    by_pointer = tensors_of(call(torch.tensor(SEED_WORDS, dtype=torch.int64, device=device)))
    sync(device)
    differ = sum(int(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).sum())
                 if a.is_floating_point() else int((a != b).sum())
                 for a, b in zip(by_value, by_pointer))
    label = "%s K=%d D=%d Kt=%d N=%d %s" % (case[:5] + (case[5] or "elected",))
    print("  %-56s seed by pointer: %d of %d outputs differ from the seed by value"
          % (label, differ, sum(t.numel() for t in by_value)))
    require(differ == 0, "%s: the seed by pointer and by value differ" % label)


def seed_replay_case(device, case=REPLAY_CASES[0]):
    """One launch of ``case``'s kernel with its seed in a tensor, captured
    as a CUDA graph and replayed twice with other words in the tensor: each
    replay draws what the launch with those words by value draws (a fused
    draw: the two launches it replaces), and the two replays draw different
    particles."""
    import torch

    call = seeded_call(case, device)
    reference = seeded_call(case, device, two_launches=True)
    table = torch.tensor((1, 2), dtype=torch.int64, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        call(table)   # the warm-up a capture asks for
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tensors_of(call(table))
    drawn = []
    for words in ((11, 12), (13, 14)):
        table.copy_(torch.tensor(words, dtype=torch.int64))
        graph.replay()
        ref = tensors_of(reference(words))
        sync(device)
        require(all(torch.equal(a, b) for a, b in zip(out[:3], ref[:3])),
                "a replay with the words %s does not draw their particles" % (words,))
        drawn.append(out[0].clone())
    require(not torch.equal(drawn[0], drawn[1]), "two replays drew the same particles")
    print("  %s as a CUDA graph, its seed in a tensor: two replays with two seeds drew those "
          "seeds' particles (launched by value%s), and not the same ones"
          % (case[0], ", the two launches it replaces" if case[0] in FUSED_DRAWS else ""))
    del graph


def max_sm_clock_ghz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) / 1e3


def solve_dofs_work(const, steps=DOF_STEPS, clock_ghz=None):
    """``(bytes, FP operations, serial-latency ms)`` of one solve of
    ``const`` (float32), counted on this data by a float64 replica of the
    bisection: 3 values a component moved; a condition's ~26 operations
    plus 3 for each unit of nu / 2 below 10 (the digamma's recurrence), and
    2 for each midpoint; the slowest component's chain of conditions at
    DOF_CONDITION_CLOCKS + DOF_UNIT_CLOCKS a unit (model), None without a
    clock."""
    c = const.double().cpu().numpy()
    K = len(c)

    def units(nu):
        x = nu / 2
        return np.where(x < 10, np.ceil(10 - x), 0.0)

    lo, hi = np.full(K, MINDOF), np.full(K, MAXDOF)
    u = units(lo) + units(hi)
    chain = 2 * DOF_CONDITION_CLOCKS + DOF_UNIT_CLOCKS * u
    ops = 2 * 26 * K + 3 * u.sum()
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        um = units(mid)
        ops += K * (26 + 2) + 3 * um.sum()
        chain += DOF_CONDITION_CLOCKS + DOF_UNIT_CLOCKS * um
        go = dof_condition64(c, mid)[0] > 0
        lo, hi = np.where(go, mid, lo), np.where(go, hi, mid)
    serial = None if clock_ghz is None else float(chain.max()) / (clock_ghz * 1e6)
    return 3 * 4 * K, float(ops), serial


@contextlib.contextmanager
def host_dof_loop(k):
    """The body of a ``with`` block with the dofs solved as before the
    kernel: its plain version, ~13 launches a bisection step on the card."""
    kernel = k.solve_dofs
    k.solve_dofs = k.plain_solve_dofs
    try:
        yield
    finally:
        k.solve_dofs = kernel


def dofs_before_after(device, K):
    """The K-component slice step (10^7 particles, Student-t) with the dof
    bisection as the host loop it was (the plain version on the card) and
    as kernel solve_dofs, in turns (loop, kernel, kernel, loop): host ms a
    step (10 steps, synchronized), then device ms and launches a step
    (torch.profiler); solve_dofs launched once a step."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.parallel import pmc_run_sharded

    params, target, _ = flagship_problem(device, K)
    host = {"host loop": [], "kernel": []}
    for label in ("host loop", "kernel", "kernel", "host loop"):
        with host_dof_loop(k) if label == "host loop" else contextlib.nullcontext():
            pmc_run_sharded(target, params, N_SLICE, 1, key=100)   # warm-up
            torch.cuda.synchronize()
            k.reset_launch_counts()
            t0 = time.perf_counter()
            pmc_run_sharded(target, params, N_SLICE, STEPS, key=len(host[label]))
            torch.cuda.synchronize()
            host[label].append((time.perf_counter() - t0) / STEPS * 1e3)
            launched = k.launch_counts()["solve_dofs"]
        require(launched == (0 if label == "host loop" else STEPS),
                "K=%d %s: solve_dofs launched %d times in %d steps" % (K, label, launched, STEPS))
    out = {}
    for label in ("host loop", "kernel"):
        with host_dof_loop(k) if label == "host loop" else contextlib.nullcontext():
            print("  K=%d step, dofs by the %s: host %s ms a step (10 steps each, synchronized)"
                  % (K, label, np.round(host[label], 3).tolist()))
            busy, launches = profile_slice(device, min(host[label]), K=K)
        out[label] = {"host_ms": host[label], "device_ms": busy, "launches": launches}
    print("  K=%d step: %+.0f launches a step, host %.3f -> %.3f ms (the best of two), device "
          "%.3f -> %.3f ms" % (K, out["kernel"]["launches"] - out["host loop"]["launches"],
                               min(host["host loop"]), min(host["kernel"]),
                               out["host loop"]["device_ms"], out["kernel"]["device_ms"]))
    return out


@contextlib.contextmanager
def eager_scans():
    """The body of a ``with`` block with every chain's scan running its
    chunks eagerly, as the per-step loop did (no CUDA graph)."""
    from pypmc_tpu_torch.sampler import _scan

    card = _scan.Scan._card

    class Eager(card):
        @staticmethod
        def serves(device):
            return False

    _scan.Scan._card = Eager
    try:
        yield
    finally:
        _scan.Scan._card = card


def chain_runs(device):
    """The examples' three chain loops at a shortened N, ``{name: (run,
    steps)}``: ``run()`` returns the outputs to compare.  markov_chain.py's
    adaptive chain (Student-t proposal, a Python target: 1000 burn-in
    steps, 3 runs of 500 adapted); r_group.py's two first chains (its
    mixture's ``evaluate_fn()``, one fused_logq launch a step: 100 + 2 x
    500); uniting...py's tensor pool (10 chains, its Student-t mixture's
    per-point ``evaluate_fn()`` mapped with torch.func.vmap: 3 cycles of 500
    steps)."""
    import torch

    import pypmc_tpu_torch as pt

    mc_ex, rg_ex = example_module("markov_chain"), example_module("r_group")
    un_ex = example_module("uniting_markov_chains_and_variational_bayes")
    dtype = pt.working_dtype(device)
    inv = torch.tensor(np.linalg.inv(mc_ex.target_sigma), dtype=dtype, device=device)
    mean = torch.tensor(mc_ex.target_mean, dtype=dtype, device=device)

    def log_target(x):
        diff = x - mean
        return -0.5 * diff @ inv @ diff

    def markov():
        mc = pt.sampler.AdaptiveMarkovChain(
            log_target, pt.density.LocalStudentT(mc_ex.prop_sigma, mc_ex.prop_dof),
            mc_ex.start, save_target_values=True, rng=0, device=device)
        accepts = [mc.run(1000)]
        for _ in range(3):
            accepts.append(mc.run(500))
            mc.adapt()
        return accepts, mc.samples[:], mc.target_values[:]

    mixture = pt.density.create_gaussian_mixture(
        [rg_ex.mean0, rg_ex.mean1], [rg_ex.covariance0, rg_ex.covariance1],
        rg_ex.component_weights)

    def r_group():
        out = []
        for seed, start in enumerate([np.array([4.999, 0.0]), np.array([-4.0001, 0.999])]):
            mc = pt.sampler.AdaptiveMarkovChain(
                mixture.evaluate_fn(device=device),
                pt.density.LocalStudentT(rg_ex.prop_sigma, rg_ex.prop_dof), start,
                save_target_values=True, rng=seed, device=device)
            out.append(mc.run(100))
            for _ in range(2):
                out.append(mc.run(500))
                mc.adapt()
            out += [mc.samples[:], mc.target_values[:]]
        return out

    t_mixture = pt.density.create_t_mixture(
        [un_ex.mean0, un_ex.mean1, un_ex.mean2],
        [un_ex.covariance0, un_ex.covariance1, un_ex.covariance2], [13, 17, 5],
        un_ex.component_weights)

    def uniting():
        starts = np.random.default_rng(2024).uniform(-10, 10, size=(10, un_ex.dim))
        samples, rates = pt.sampler.sample_adaptive_chains(
            t_mixture.evaluate_fn(device=device), starts, np.eye(un_ex.dim) * 2.38**2 / un_ex.dim,
            n_steps=500, n_adapt_cycles=3, key=2024, device=device)
        return samples.cpu().numpy(), rates.cpu().numpy()

    return {"markov_chain.py": (markov, 2500), "r_group.py": (r_group, 2 * 1100),
            "uniting...py": (uniting, 10 * 1500)}


def chain_graph_cases(device):
    """Each of :func:`chain_runs` as CUDA graphs and in the eager loop, in
    turns (graph, eager, graph): bit for bit the same outputs; the graph
    runs replayed (no fallback), launching as many kernels as the eager
    run (r_group.py: one fused_logq a step and one a chain's start); the
    host clock of each (synchronized), us a chain-step."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.sampler import _scan

    def same(a, b):
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return np.array_equal(np.asarray(a), np.asarray(b))

    for name, (run, steps) in chain_runs(device).items():
        outs, secs, launches = {}, {"graph": [], "eager": []}, {}
        for mode in ("graph", "eager", "graph"):
            with eager_scans() if mode == "eager" else contextlib.nullcontext():
                k.reset_launch_counts()
                _scan.reset_counts()
                t0 = time.perf_counter()
                out = run()
                sync(device)
                secs[mode].append(time.perf_counter() - t0)
                scans = dict(_scan.counts)
            launches[mode] = {n: c for n, c in k.launch_counts().items() if c}
            require(same(outs.setdefault(mode, out), out), "%s: two %s runs differ" % (name, mode))
            if mode == "graph":
                require(scans["replays"] > 0 and scans["fallbacks"] == 0
                        and scans["uncapturable"] == 0,
                        "%s: the chains did not run as CUDA graphs: %s" % (name, scans))
        require(same(outs["graph"], outs["eager"]),
                "%s: the CUDA graphs' run differs from the eager loop" % name)
        require(launches["graph"] == launches["eager"],
                "%s: launches %s as graphs, %s eagerly" % (name, launches["graph"],
                                                            launches["eager"]))
        if name == "r_group.py":
            require(launches["graph"].get("fused_logq") == steps + 2,
                    "r_group.py: %s fused_logq launches for %d steps of 2 chains"
                    % (launches["graph"].get("fused_logq"), steps))
        print("  %-16s %5d chain-steps: graphs %s s, eager loop %s s (%.1f and %.1f us a step, "
              "the best), equal bit for bit; scans %s; launches %s"
              % (name, steps, np.round(secs["graph"], 3).tolist(),
                 np.round(secs["eager"], 3).tolist(), min(secs["graph"]) / steps * 1e6,
                 min(secs["eager"]) / steps * 1e6, json.dumps(scans),
                 json.dumps(launches["graph"])))


@contextlib.contextmanager
def scan_warnings():
    """The body of a ``with`` block whose warnings from ``sampler._scan``
    are kept in the handler it yields (``.messages``), on every rank: the
    logger takes warnings for the block, where ``tools.log_to_stdout`` has
    a group's other ranks log only errors."""
    import logging

    from pypmc_tpu_torch.sampler import _scan

    class Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    handler, log = Warnings(), logging.getLogger(_scan.__name__)
    level = log.level
    log.setLevel(logging.WARNING)
    log.addHandler(handler)
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def uncapturable_case(device):
    """Two chains whose target no CUDA graph can hold -- one returns a
    Python float, one calls ``.item()`` and builds a tensor from it -- each
    runs (2 chunks past its warm-up) with one warning naming the cause, the
    scans' counts saying so, and the outputs of the eager loop bit for
    bit."""
    import torch

    import pypmc_tpu_torch as pt
    from pypmc_tpu_torch.sampler import _scan

    mean = torch.tensor([1.0, -1.0], dtype=pt.working_dtype(device), device=device)

    def as_float(x):
        return float(-0.5 * torch.sum((x - mean) ** 2))

    def via_item(x):
        return torch.tensor(-0.5 * torch.sum((x - mean) ** 2).item(), device=x.device)

    for target in (as_float, via_item):
        outs = []
        for mode in ("graph", "eager"):
            with scan_warnings() as handler, \
                    eager_scans() if mode == "eager" else contextlib.nullcontext():
                _scan.reset_counts()
                mc = pt.sampler.MarkovChain(target, pt.density.LocalGauss(np.eye(2) * 0.5),
                                            np.zeros(2), rng=3, device=device)
                outs.append((mc.run(3 * _scan.CHUNK), mc.samples[:]))
                scans = dict(_scan.counts)
            if mode == "graph":
                require(len(handler.messages) == 1 and scans["uncapturable"] == 1
                        and scans["fallbacks"] == 2 and scans["replays"] == 0,
                        "%s: %s, warnings %s" % (target.__name__, scans, handler.messages))
                print("  uncapturable target %s: scans %s; %s"
                      % (target.__name__, json.dumps(scans), handler.messages[0][:200]))
        require(outs[0][0] == outs[1][0] and np.array_equal(outs[0][1], outs[1][1]),
                "%s: the fallback differs from the eager loop" % target.__name__)


# --------------------------------------------------------------------- #
# phase scan: pmc_run_sharded(scan_steps=True), CUDA graphs of PMC steps #
# --------------------------------------------------------------------- #

def sharded_example_problem(device):
    """``examples_torch/pmc_sharded.py``'s mixtures (its target, two
    Gaussians, and its poor initial proposal of three) in the card's
    working dtype, and its particles a step for one rank."""
    import pypmc_tpu_torch as pt

    ex = example_module("pmc_sharded")
    with pt.using_device(device):
        target = pt.density.create_gaussian_mixture(
            [ex.mean0, ex.mean1], [ex.covariance0, ex.covariance1],
            ex.component_weights).stacked_params()
        params = pt.density.create_gaussian_mixture(
            [np.array([4.0, 0.0]), np.array([-5.0, 0.0]), np.array([0.0, 0.0])],
            [np.eye(2)] * 3).stacked_params()
    return params, target, 1001   # its n_dev (1000 // n_dev + 1) n_dev at one rank


def pmc_stage_problem(device):
    """The D=40 pipeline's PMC stage (``benchmarks/accuracy_highdim.py``
    ``run_pipeline``: ``pmc_dof`` 8, ``n_is1`` 2^20 particles, ``pmc_steps``
    10) at the K=32 its VB2 mixture has: a Student-t proposal of 32
    components, 16 about each of ``make_target(40)``'s two modes (each mean
    the mode's plus noise of 0.3, its covariance the mode's doubled, the
    weights the modes' 0.35/0.65 split evenly), and that target."""
    import torch
    from pypmc_tpu_torch.density import core

    target = highdim_target(40).stacked_params(dtype=torch.float32, device=device)
    rng = np.random.default_rng(32)
    t_means, t_covs = target.means.cpu().numpy(), target.cov.cpu().numpy()
    which = np.arange(32) % 2
    means = (t_means[which] + rng.normal(0, 0.3, (32, 40))).astype(np.float32)
    covs = (2.0 * t_covs[which]).astype(np.float32)
    w = np.where(which == 0, 0.35, 0.65).astype(np.float32) / 16
    params = make_params((means, covs, w, np.full(32, 8.0, np.float32)), device)
    return params, target


def scan_problems(device):
    """``[(label, params, target, particles, steps)]``: the slice, its
    ``--components 200`` (the K-blocked step), the slice at 2^16 particles,
    ``pmc_sharded.py`` (1001 particles: the draw of fused_propose_logq and
    the unfused update), a D=40 step of 1000 particles past
    fused_propose_logq's rule (the draw of draw_proposal_inputs and the
    tensor transform), the D=40 pipeline's PMC stage (K=32 Student-t,
    2^20 particles: fused_draw_transform, the unfused update), the slice at
    2^16 particles in float64 (every gate refuses; draw_proposal_inputs'
    float64 draw, the tensor transform) and WIDE_PATH's PMC run (D=200:
    draw_proposal_inputs and fused_transform's tiled pair, the unfused
    update through fused_rho's tiled kernel)."""
    import torch

    params, target, _ = flagship_problem(device)
    blocked, blocked_target, _ = flagship_problem(device, K=200)
    sharded, sharded_target, n_sharded = sharded_example_problem(device)
    rng = np.random.default_rng(40)
    wide = make_params(random_mixture(rng, 12, 40, False), device)
    wide_target = make_params(random_mixture(rng, 2, 40, False), device)
    stage, stage_target = pmc_stage_problem(device)
    wide_params, wide_path_target = wide_path_problem(device)
    return [("slice", params, target, N_SLICE, STEPS),
            ("--components 200", blocked, blocked_target, N_SLICE, STEPS),
            ("2^16 particles", params, target, 1 << 16, STEPS),
            ("pmc_sharded.py", sharded, sharded_target, n_sharded, STEPS),
            ("K=12, D=40, 1000 particles", wide, wide_target, 1000, 4),
            ("K=32 t, D=40, 2^20 (PMC stage)", stage, stage_target, N_FLAGSHIP, STEPS),
            ("float64, 2^16 particles", params.to(dtype=torch.float64),
             target.to(dtype=torch.float64), 1 << 16, STEPS),
            ("WIDE_PATH D=200 K=4, 2^16", wide_params, wide_path_target, WIDE_PATH["n"],
             WIDE_PATH["steps"])]


def scan_case(device, label, params, target, n, steps):
    """``pmc_run_sharded(scan_steps=True)`` against ``scan_steps=False`` at
    one configuration: two untimed scan runs (the warm-up chunk, then the
    graph's capture and a replay), then in turns loop, scan, scan, loop,
    each timed (host clock, synchronized) with its launch counts and peak
    memory; every run bit for bit the first loop's, the launches of the two
    ways equal; the scan's graphs replayed with no fallback and no warning;
    then one profiled run each way (device ms a step); last the memory the
    card keeps reserved after them (``memory_reserved``), then after
    ``empty_cache()`` with the scan still kept, then after
    ``clear_step_cache()`` and ``empty_cache()``.  Returns the launch
    counts of a loop run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.parallel import pmc_run_sharded
    from pypmc_tpu_torch.parallel.sampler import clear_step_cache
    from pypmc_tpu_torch.sampler import _scan

    def run(scan):
        out, stats = pmc_run_sharded(target, params, n, steps, key=7, scan_steps=scan)
        fields = [f for f in (out.means, out.cov, out.weights, out.dof) if f is not None]
        return digest(*fields, *stats)

    clear_step_cache()
    torch.cuda.empty_cache()
    _scan.reset_counts()
    peak, host, launches, digests = {}, {}, {}, []
    with scan_warnings() as warned:
        for mode in ("warm-up", "capture", "loop", "scan", "scan", "loop"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k.reset_launch_counts()
            t0 = time.perf_counter()
            digests.append(run(mode != "loop"))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak[mode] = max(peak.get(mode, 0), torch.cuda.max_memory_allocated())
            host.setdefault(mode, []).append(seconds / steps * 1e3)
            if mode in ("loop", "scan"):
                launches[mode] = {c: v for c, v in k.launch_counts().items() if v}
        scans = dict(_scan.counts)
    require(len(set(digests)) == 1, "scan %s: the runs differ: %s" % (label, digests))
    require(launches["loop"] == launches["scan"], "scan %s: launches %s with the loop, %s "
            "with the scan" % (label, launches["loop"], launches["scan"]))
    require(scans["replays"] > 0 and scans["fallbacks"] == 0 and scans["uncapturable"] == 0
            and not warned.messages, "scan %s: the steps did not replay as CUDA graphs: %s "
            "%s" % (label, scans, warned.messages))
    require(peak["capture"] <= 2 * peak["loop"] + (256 << 20),
            "scan %s: capturing %d steps took %d MiB at peak, the loop %d MiB"
            % (label, steps, peak["capture"] >> 20, peak["loop"] >> 20))
    device_ms, by_kernel = {}, {}
    for mode in ("loop", "scan"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(mode == "scan")
            torch.cuda.synchronize()
        by_kernel[mode] = device_rows(prof, steps)
        device_ms[mode] = sum(r[0] for r in by_kernel[mode])
    torch.cuda.synchronize()
    reserved = [torch.cuda.memory_reserved()]
    torch.cuda.empty_cache()
    reserved.append(torch.cuda.memory_reserved())
    clear_step_cache()
    torch.cuda.empty_cache()
    reserved.append(torch.cuda.memory_reserved())
    print("  scan %-27s %s particles, %d steps: equal bit for bit, launches equal; host %s ms a "
          "step by the loop, %s by the scan (synchronized); device %.3f / %.3f ms a step "
          "(profiler); peak %d MiB loop, %d capture, %d replay; scans %s%s"
          % (label, n, steps, np.round(host["loop"], 3).tolist(),
             np.round(host["scan"], 3).tolist(), device_ms["loop"], device_ms["scan"],
             peak["loop"] >> 20, peak["capture"] >> 20, peak["scan"] >> 20, json.dumps(scans),
             "; ..." + warned.messages[0][-200:] if warned.messages else ""))
    print("    a new configuration's first call (its warm-up chunk) %.3f ms a step, its "
          "second (the capture) %.3f (synchronized)" % (host["warm-up"][0], host["capture"][0]))
    print("    device ms a step by kernel, the loop's largest (share of the step): %s"
          % "; ".join("%.3f (%.1f%%) x %g %s" % (ms, 100 * ms / device_ms["loop"], n, name[:70])
                      for ms, n, name in by_kernel["loop"][:6]))
    print("    reserved %d MiB after the runs, %d after empty_cache() with the scan kept, %d "
          "after clear_step_cache() and empty_cache(): the kept scan held %d MiB"
          % (reserved[0] >> 20, reserved[1] >> 20, reserved[2] >> 20,
             (reserved[1] - reserved[2]) >> 20))
    return launches["loop"]


def phase_scan(device):
    """``scan_case`` at each of :func:`scan_problems`; returns the launch
    counts of one loop run of each, summed."""
    import torch

    totals = {}
    for problem in scan_problems(device):
        for name, c in scan_case(device, *problem).items():
            totals[name] = totals.get(name, 0) + c
        torch.cuda.empty_cache()
    return totals


# the steps a chain's CUDA graph may take (sampler._scan.CHUNK), timed by
# chip_smoke.py --chunk-sweep, CHUNK_PASSES timed passes after a warm-up
CHUNK_SWEEP, CHUNK_PASSES = (8, 16, 32, 64, 125), 2


def chunk_sweep(device):
    """markov_chain.py, r_group.py and uniting...py at their published
    sizes with each CHUNK_SWEEP length of a chain's graph: wall seconds of
    each (host clock, synchronized) and us a chain-step of the first two,
    one value a timed pass; returns ``{length: {example: [values]}}``."""
    import io

    from pypmc_tpu_torch.sampler import _scan

    chunk, out = _scan.CHUNK, {}
    names = ("markov_chain", "r_group", "uniting_markov_chains_and_variational_bayes")
    try:
        for timed in range(-1, CHUNK_PASSES):     # pass -1 compiles and warms up
            for C in CHUNK_SWEEP:
                _scan.CHUNK = C
                row = out.setdefault(C, {})
                for name in names:
                    with temporary_working_directory(), contextlib.redirect_stdout(io.StringIO()):
                        t0 = time.perf_counter()
                        res = example_module(name).main(["--device", str(device)])
                        sync(device)
                        seconds = time.perf_counter() - t0
                    if timed < 0:
                        continue
                    row.setdefault(name, []).append(seconds)
                    if "us_per_step" in res:
                        row.setdefault(name + " us/step", []).append(res["us_per_step"])
    finally:
        _scan.CHUNK = chunk
    for C, row in out.items():
        print("  chunk %4d steps: %s" % (C, json.dumps(
            {n: [round(v, 3) for v in vs] for n, vs in row.items()})))
    return out


@contextlib.contextmanager
def min_n(k, n):
    """The body of a ``with`` block with the one-pass VB E-step's particle
    rule at ``n`` (``kernels._MIN_N``; 0 is the route before the float32
    stopping rule's repair)."""
    old = k._MIN_N
    k._MIN_N = n
    try:
        yield
    finally:
        k._MIN_N = old


@contextlib.contextmanager
def vb_runs(record):
    """The body of a ``with`` block with every ``GaussianInference.run``
    recorded as ``(N, D, K at the end, iterations or None, the cap)``."""
    from pypmc_tpu_torch.mix_adapt import variational as v

    run = v.GaussianInference.run

    def recorded(self, iterations=1000, *args, **kwargs):
        out = run(self, iterations, *args, **kwargs)
        record.append((self.N, self.dim, self.K, out, iterations))
        return out

    v.GaussianInference.run = recorded
    try:
        yield
    finally:
        v.GaussianInference.run = run


# --------------------------------------------------------------------- #
# phase 4: the slice                                                    #
# --------------------------------------------------------------------- #

def slice_reference(device, report):
    """One step of the slice on the card against the unfused update in
    float64 on the CPU, on the step's own samples and weights."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.mix_adapt.pmc import pmc_step_mixture_target, pmc_update

    params, target, _ = flagship_problem(device)
    result, xT, w, _, _ = pmc_step_mixture_target(params, target, 5, 1 << 18)
    p64, t64 = params.to("cpu", torch.float64), target.to("cpu", torch.float64)
    x64 = xT.cpu().double()
    w64 = torch.exp(core.mixture_logpdf_T(t64, x64) - core.mixture_logpdf_T(p64, x64))
    compare("slice step w", w.cpu(), w64, "w", report)
    ref = pmc_update(p64, x64, w64, transposed=True, fused="off").params
    got = result.params.to("cpu")
    for f in ("means", "cov", "weights"):
        compare("slice step " + f, getattr(got, f), getattr(ref, f), "update", report)
    compare("slice step dof", got.dof, ref.dof, "dof", report)


def phase_slice(device):
    import torch
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.parallel import pmc_run_sharded

    params, target, t_means = flagship_problem(device)
    # warm-up (not counted, not timed): first-use allocations
    pmc_run_sharded(target, params, N_SLICE, 1, key=100)
    torch.cuda.synchronize()

    k.reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = pmc_run_sharded(target, params, N_SLICE, STEPS, key=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out_c, stats_c = pmc_run_sharded(target, params, N_SLICE, 2, key=1, weight_clip=True)
    torch.cuda.synchronize()
    counts = k.launch_counts()

    s = {f: getattr(stats, f).double().cpu().numpy() for f in stats._fields}
    sc = {f: getattr(stats_c, f).double().cpu().numpy() for f in stats_c._fields}
    for i in range(STEPS):
        print("  step %2d  ess %.4f  perplexity %.4f  evidence %.6f  loglik %.4f"
              % (i + 1, s["ess"][i], s["perplexity"][i], s["evidence"][i],
                 s["log_likelihood"][i]))
    print("  weight_clip run: ess %s  evidence %s" % (np.round(sc["ess"], 4),
                                                      np.round(sc["evidence"], 6)))
    w = out.weights.double().cpu().numpy()
    mu = out.means.double().cpu().numpy()
    masses = [float(w[np.linalg.norm(mu - t_means[j], axis=1) < 3].sum()) for j in (0, 1)]
    print("  mode masses %s (target [0.3, 0.7])" % np.round(masses, 4))
    print("  launch counts %s" % json.dumps(counts))
    print("  10 steps of %d particles: %.1f ms a step (host clock, synchronized)"
          % (N_SLICE, dt / STEPS * 1e3))

    finite = all(np.isfinite(v).all() for d in (s, sc) for v in d.values())
    finite = finite and all(bool(torch.isfinite(t).all()) for t in
                            (out.means, out.cov, out.weights, out.dof))
    require(finite, "slice: NaN or inf in the statistics or the mixture")
    ev_err = np.abs(s["evidence"][1:] - 1.0)
    require(np.all(ev_err < 0.01), "slice: evidence off by %s" % ev_err)
    # the clipped run has only 2 steps from the wide initial proposal, where
    # the ESS is still small: hold its evidence to 5 Monte Carlo sigma
    sigma = sc["evidence"] * np.sqrt((1.0 / sc["ess"] - 1.0) / N_SLICE)
    require(np.all(np.abs(sc["evidence"] - 1.0) < 5 * sigma + 1e-3),
            "slice: clipped-run evidence %s off by more than 5 sigma %s"
            % (sc["evidence"], sigma))
    require(s["ess"][-1] >= 0.8, "slice: last-step ESS %.4f < 0.8" % s["ess"][-1])
    require(abs(masses[0] - 0.3) < 0.05 and abs(masses[1] - 0.7) < 0.05,
            "slice: mode masses %s" % masses)
    require(counts["fused_is_pmc_step"] == STEPS, "slice: fused_is_pmc_step launches")
    require(counts["solve_dofs"] == STEPS + 2,
            "slice: %d solve_dofs launches for %d Student-t updates"
            % (counts["solve_dofs"], STEPS + 2))
    variants = {n: c for n, c in counts.items() if n.startswith("variant:")}
    print("  statistics passes %s" % json.dumps(variants))
    require(counts["variant:fused_is_pmc_step=reg"] == STEPS,
            "slice: %d of %d fused_is_pmc_step launches took the register pass"
            % (counts["variant:fused_is_pmc_step=reg"], STEPS))
    require(counts["fused_logq"] >= STEPS, "slice: fused_logq launches")
    require(counts["fused_propose_logq"] >= 2, "slice: fused_propose_logq launches")
    require(counts["variant:fused_propose_logq=rec"] == counts["fused_propose_logq"],
            "slice: %d of %d fused_propose_logq launches took the record kernel"
            % (counts["variant:fused_propose_logq=rec"], counts["fused_propose_logq"]))
    require(counts["fused_pmc_stats"] >= 2, "slice: fused_pmc_stats launches")
    require(counts["variant:fused_pmc_stats=reg"] == counts["fused_pmc_stats"],
            "slice: %d of %d fused_pmc_stats launches took the register pass"
            % (counts["variant:fused_pmc_stats=reg"], counts["fused_pmc_stats"]))
    return counts, dt / STEPS * 1e3, out


# the package's named ranges (pypmc_tpu_torch.profiling.annotate): a trace
# projects each onto the device's timeline, where it spans kernels that
# have rows of their own
RANGES = ("mcmc", "vb1", "is1_vb2", "pmc", "is2_combine", "pmc_step")


def device_rows(prof, per):
    """``(device ms, launches, name)`` by kernel or copy from a
    torch.profiler run, divided by ``per`` (the steps or iterations
    profiled), largest first.  Only the device's own events count: an
    operator's row carries the time of the kernels it launched, and a
    named range's the time of the kernels inside it, which have rows of
    their own."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False) or e.key in RANGES:
            continue
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3 / per, e.count / per, e.key))
    require(rows, "the profiler recorded no device event")
    return sorted(rows, reverse=True)


def profile_slice(device, step_ms, steps=2, K=10):
    """Device time of the slice's steps (a K-component proposal) by kernel
    (torch.profiler), and its share of the unprofiled step time; returns
    ``(device ms, launches)`` a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pypmc_tpu_torch.parallel import pmc_run_sharded

    params, target, _ = flagship_problem(device, K)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pmc_run_sharded(target, params, N_SLICE, steps, key=3)
        torch.cuda.synchronize()
    rows = device_rows(prof, steps)
    busy = sum(r[0] for r in rows)
    print("  device time a step %.3f ms = %.1f%% of the %.1f ms step; %d launches a step"
          % (busy, 100 * busy / step_ms, step_ms, sum(r[1] for r in rows)))
    for ms, count, key in rows[:8]:
        print("    %8.3f ms  %5.0f x  %s" % (ms, count, key[:90]))
    return busy, sum(r[1] for r in rows)


# --------------------------------------------------------------------- #
# phase 5: variational Bayes                                            #
# --------------------------------------------------------------------- #

def vb_problem(device, n=VB_N, K=VB_K, D=VB_D):
    """benchmarks/vb_step.py's data in float32 on the card: seed 0, K
    centers N(0, 4^2) in D dimensions, uniform labels, unit noise, weights
    |N(1, 0.2^2)|."""
    import torch

    rng = np.random.default_rng(0)
    centers = rng.normal(0, 4, size=(K, D))
    lab = rng.integers(0, K, size=n)
    data = (centers[lab] + rng.normal(0, 1, size=(n, D))).astype(np.float32)
    weights = np.abs(rng.normal(1, 0.2, size=n)).astype(np.float32)
    return torch.tensor(data, device=device), torch.tensor(weights, device=device)


def vb_reference(vb, report, name="fused_vb_estep"):
    """One _update_with_bound iteration of ``vb`` (on a shallow copy, so
    ``vb`` keeps its state) against the same iteration with the float64
    plain version of its E-step kernel ``name`` on the card, on the
    kernel's float32 operands."""
    from pypmc_tpu_torch.mix_adapt import variational as V
    from pypmc_tpu_torch.ops import kernels as k

    it = copy.copy(vb)
    bound = it._update_with_bound()
    hyper = V._vb_m_step(vb.N_comp, vb.x_mean_comp, vb.S, *vb._prior()[:5])
    e_lnlam, e_lnpi, A, const = V._vb_whitening(vb.dim, *hyper)
    A32, m32 = A.float().double(), hyper[3].float().double()
    plain = getattr(k, "plain_" + name[len("fused_"):])
    stats = plain(vb._data_T.double(), vb.weights.double(), A32, m32, const.float().double())
    e = V._vb_unwhiten(A32, m32, stats, e_lnlam, e_lnpi)
    ref_bound = V._vb_bound(vb.weights, e, *hyper, *vb._prior())
    compare(name + " iteration N_comp/N", it.N_comp / vb.N, e.N_comp / vb.N, "vb", report)
    compare(name + " iteration x_mean", it.x_mean_comp, e.x_mean_comp, "vb", report)
    compare(name + " iteration S", it.S, e.S, "vb", report)
    compare(name + " iteration bound", ref_bound.new_tensor(bound), ref_bound, "vb", report)


def instrumented_run(vb, name, kernel="fused_vb_estep", **run_kwargs):
    """``vb.run(**run_kwargs)`` with every iteration's host time, bound and
    K recorded and every E-step a prune triggers counted, between a reset
    and a read of the launch counts.  Checks that the E-step ``kernel``
    launched once per iteration plus once per such E-step, and that the
    bound is finite and, while K is unchanged, drops by no more than 1e-5
    relative.  Returns ``(converged, record, prune E-steps, counts)``."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k

    record, prune_e_steps = [], []
    update, e_step = vb._update_with_bound, vb.E_step

    def timed_update():
        t0 = time.perf_counter()
        bound = update()
        record.append((time.perf_counter() - t0, bound, vb.K))
        return bound

    def counted_e_step():
        prune_e_steps.append(vb.K)
        e_step()

    vb._update_with_bound, vb.E_step = timed_update, counted_e_step
    k.reset_launch_counts()
    try:
        converged = vb.run(**run_kwargs)
        torch.cuda.synchronize()
    finally:
        counts = k.launch_counts()
        del vb._update_with_bound, vb.E_step
    bounds = [r[1] for r in record]
    require(all(np.isfinite(bounds)), "%s: a bound is not finite" % name)
    require(counts[kernel] == len(record) + len(prune_e_steps),
            "%s: %s launched %d times for %d iterations and %d prune E-steps"
            % (name, kernel, counts[kernel], len(record), len(prune_e_steps)))
    for (_, b0, k0), (_, b1, k1) in zip(record, record[1:]):
        require(k0 != k1 or b1 >= b0 - 1e-5 * abs(b0),
                "%s: the bound dropped from %.10g to %.10g at K=%d" % (name, b0, b1, k1))
    per_it = {n: round(c / len(record), 3) for n, c in counts.items() if c}
    print("  %s: %d iterations (converged: %s), K %d -> %d, final bound %.10g; "
          "%d E-steps after a prune; launches an iteration %s"
          % (name, len(record), converged, record[0][2], vb.K, bounds[-1],
             len(prune_e_steps), json.dumps(per_it)))
    return converged, record, prune_e_steps, counts


def phase_vb(device, report):
    """GaussianInference at benchmarks/vb_step.py's configuration; returns
    the launch counts of the run, the median iteration ms and the device
    busy percentage."""
    import torch
    from pypmc_tpu_torch.mix_adapt import GaussianInference

    data, w = vb_problem(device)
    vb = GaussianInference(data, components=VB_K, weights=w, nu=VB_D + 1.0)
    del data
    torch.cuda.synchronize()
    print("  data and weights on the card: %.1f MB" % (
        (vb._data_T.numel() + vb.weights.numel()) * 4 / 1e6))
    vb_reference(vb, report)
    _, record, _, counts = instrumented_run(vb, "vb_step.py configuration",
                                            iterations=VB_ITERS, prune=1.0)
    print("  statistics passes %s" % json.dumps(
        {n: c for n, c in counts.items() if n.startswith("variant:fused_vb_estep")}))
    require(counts["variant:fused_vb_estep=reg"] == counts["fused_vb_estep"],
            "vb: %d of %d fused_vb_estep launches took the register pass"
            % (counts["variant:fused_vb_estep=reg"], counts["fused_vb_estep"]))
    ms = [r[0] * 1e3 for r in record]
    print("  iteration ms (host clock): first %.3f, median of the rest %.3f"
          % (ms[0], float(np.median(ms[1:]))))
    for f in ("N_comp", "x_mean_comp", "S", "alpha", "W"):
        require(bool(torch.isfinite(getattr(vb, f)).all()), "vb: %s not finite" % f)
    mix = vb.make_mixture()
    require(len(mix) >= 1, "vb: no component in the final mixture")
    busy = profiled_iterations(vb)
    del vb
    torch.cuda.empty_cache()
    return counts, float(np.median(ms[1:])), busy


def profiled_iterations(vb, label="profiled iteration", n=2):
    """``n`` further iterations of ``vb`` under torch.profiler: prints the
    device and host ms an iteration, the busy share, the launches and the
    largest device rows; returns the busy percentage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            vb._update_with_bound()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = device_rows(prof, n)
    busy = sum(r[0] for r in rows)
    print("  %s: device %.3f ms of %.3f ms host (%.1f%% busy), %d launches"
          % (label, busy, host_ms, 100 * busy / host_ms, sum(r[1] for r in rows)))
    for t, c, key in rows[:6]:
        print("    %8.3f ms  %5.0f x  %s" % (t, c, key[:90]))
    return 100 * busy / host_ms


# examples/variational.py's mixture at sizes that take the one-pass E-step:
# every float32 fit on the card converges, to the two components of the
# float64 fit of the same points on the CPU (weights and means to 3e-5, as
# tests/test_torch_vb_float32.py holds the CPU's float32 fits)
VB32_SIZES, VB32_SEEDS, VB32_ITERATIONS, VB32_TOL = (2048, 4096), range(1, 14), 3000, 3e-5


def vb_float32_fits(device):
    """The float32 VB fits of VB32_SIZES x VB32_SEEDS on the card, each
    against the float64 fit of its points on the CPU; returns ``{n:
    [iterations]}``."""
    import torch

    import pypmc_tpu_torch as pt

    ex = example_module("variational")
    mix = pt.density.create_gaussian_mixture(
        [ex.mean0, ex.mean1], [ex.covariance0, ex.covariance1], ex.component_weights)
    out, t0 = {}, time.perf_counter()
    for n in VB32_SIZES:
        for seed in VB32_SEEDS:
            with pt.using_device(device):
                data = mix.propose(n, rng=seed)
                vb, it = ex.fit(data, 20, VB32_ITERATIONS)
            require(vb._data_T.dtype == torch.float32 and vb._data_T.device == device,
                    "vb float32: the data is %s on %s" % (vb._data_T.dtype, vb._data_T.device))
            require(vb._fused_eligible() == "dense", "vb float32: n=%d took %s"
                    % (n, vb._fused_eligible()))
            with pt.using_device("cpu"):
                ref, ref_it = ex.fit(data, 20, VB32_ITERATIONS)
            require(it is not None, "vb float32: n=%d seed %d did not converge in %d "
                    "iterations (float64 on the CPU: %s)" % (n, seed, VB32_ITERATIONS, ref_it))
            got, want = vb.make_mixture(), ref.make_mixture()
            require(len(got) == len(want) == 2, "vb float32: n=%d seed %d kept %d components "
                    "(float64: %d)" % (n, seed, len(got), len(want)))
            og, ow = np.argsort(got.weights), np.argsort(want.weights)
            werr = float(np.max(np.abs(np.asarray(got.weights)[og]
                                       / np.asarray(want.weights)[ow] - 1)))
            merr = max(float(np.max(np.abs(np.asarray(got.components[a].mu)
                                           - np.asarray(want.components[b].mu))
                                    / np.maximum(np.abs(np.asarray(want.components[b].mu)), 1)))
                       for a, b in zip(og, ow))
            require(werr <= VB32_TOL and merr <= VB32_TOL,
                    "vb float32: n=%d seed %d weights %.3g, means %.3g from float64 (limit %g)"
                    % (n, seed, werr, merr, VB32_TOL))
            out.setdefault(n, []).append(it)
    print("  float32 fits of examples/variational.py's mixture (one-pass E-step, %d seeds; "
          "%.1f s with the float64 CPU fits): all converged, iterations %s"
          % (len(VB32_SEEDS), time.perf_counter() - t0, json.dumps(out)))
    return out


# --------------------------------------------------------------------- #
# phase 6: the size gate                                                #
# --------------------------------------------------------------------- #

def phase_gate(device, report):
    """The size gate routes as the JAX package does: K*D > 128 takes the
    unfused update, through fused_rho and fused_maha, and a forced dense
    update raises; D=40 runs fused_logq; K=400, D=10 takes the unfused
    log-density; a K=400 update of 2^22 particles, where the JAX package
    elects its K-blocked kernel, runs fused_pmc_stats_blocked once."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.mix_adapt.pmc import pmc_update
    from pypmc_tpu_torch.ops import kernels as k

    K, D, N = 30, 10, 1 << 18
    rng = np.random.default_rng(30)
    arrs = random_mixture(rng, K, D, True)
    params = make_params(arrs, device)
    require(not k.fits("fused_pmc_stats", K, D), "gate: K=30, D=10 fits fused_pmc_stats")
    xT = k.fused_propose_logq((30, 1), core._kernel_operands(params), N)[0]
    w = torch.tensor(rng.exponential(1.0, N), dtype=torch.float32, device=device)

    k.reset_launch_counts()
    got = pmc_update(params, xT, w, transposed=True)
    sync(device)
    counts = k.launch_counts()
    print("  K=30 D=10 Student-t pmc_update(fused='auto'): launches %s"
          % json.dumps({n: c for n, c in counts.items() if c}))
    require(counts["plain:fused_pmc_stats"] == 1 and counts["fused_pmc_stats"] == 0
            and counts["fused_rho"] == 1 and counts["fused_maha"] == 1,
            "gate: pmc_update did not take the unfused path through fused_rho and fused_maha")
    ref = pmc_update(params.to("cpu", torch.float64), xT.cpu().double(), w.cpu().double(),
                     transposed=True, fused="off")
    compare("fused_rho gate rho", got.rho.cpu(), ref.rho, "rho", report)
    for f in ("means", "cov", "weights"):
        compare("gate update " + f, getattr(got.params, f).cpu(), getattr(ref.params, f),
                "update", report)
    compare("gate update dof", got.params.dof.cpu(), ref.params.dof, "dof", report)
    try:
        pmc_update(params, xT, w, transposed=True, fused="dense")
    except ValueError as e:
        require("K*D <= 128" in str(e), "gate: forced dense raised without the rule: %s" % e)
        print("  forced fused='dense' raises: %s" % e)
    else:
        raise SmokeFailure("gate: a forced dense update past K*D <= 128 ran")
    del got, ref, xT, w

    for K2, D2, route in ((2, 40, "fused_logq"), (400, 10, "plain:fused_logq")):
        p2 = make_params(random_mixture(rng, K2, D2, False), device)
        x2 = torch.tensor(rng.normal(0, 2, (D2, 1 << 16)), dtype=torch.float32, device=device)
        k.reset_launch_counts()
        lq = core.mixture_logpdf_T(p2, x2)
        sync(device)
        c2 = k.launch_counts()
        require(c2[route] == 1 and kernel_launches(c2) == 1,
                "gate: K=%d, D=%d mixture_logpdf_T did not take %s: %s" % (K2, D2, route, c2))
        compare("fused_logq gate K=%d D=%d" % (K2, D2) if route == "fused_logq"
                else "gate K=%d D=%d unfused log q" % (K2, D2), lq.cpu(),
                core.mixture_logpdf_T(p2.to("cpu", torch.float64), x2.cpu().double()),
                "log", report)
        print("  K=%d D=%d mixture_logpdf_T: route %s" % (K2, D2, route))
        counts = {n: counts[n] + c2[n] for n in counts}

    p400 = make_params(random_mixture(rng, 400, 2, False), device)
    x400 = k.fused_propose_logq((400, 1), core._kernel_operands(p400), 1 << 22)[0]
    require(k.elects_blocked("fused_pmc_stats", 400, 2, 1 << 22), "gate: no blocked election")
    k.reset_launch_counts()
    got = pmc_update(p400, x400, transposed=True)
    sync(device)
    c3 = k.launch_counts()
    print("  K=400 D=2 N=2^22 pmc_update: launches %s"
          % json.dumps({n: c for n, c in c3.items() if c}))
    require(c3["fused_pmc_stats_blocked"] == 1 and kernel_launches(c3) == 1,
            "gate: the K=400 update did not run fused_pmc_stats_blocked alone: %s" % c3)
    require(bool(torch.isfinite(got.params.means).all()), "gate: K=400 update not finite")
    del got, x400
    torch.cuda.empty_cache()
    c4 = float64_entry_points(device, report)
    return {n: counts[n] + c3[n] + c4[n] for n in counts}


F64_N = 1 << 20


@contextlib.contextmanager
def cpu_routes_as_the_card(k):
    """Within the block the gates of ``k`` (the module) decide CPU tensors
    as they decide the card's, so that a float64 reference on the CPU runs
    the card's unfused routes (on the CPU the decision is the shape's, and
    a one-pass route there sums other terms in another order)."""
    import torch

    decide = k._card_dtype

    def as_the_card(like):
        if like is None:
            return None
        return like.dtype if isinstance(like, torch.Tensor) else like[1]

    k._card_dtype = as_the_card
    try:
        yield
    finally:
        k._card_dtype = decide


def float64_entry_points(device, report):
    """Float64 CUDA tensors through the entry points, where the JAX package
    sends every array that is not float32 to XLA: the gates send them to
    the unfused path (each refusal counted as ``plain:<kernel>``), which
    runs float64 tensor code and the float64 kernels (``solve_dofs``,
    ``draw_proposal_inputs``), each against the same call in float64 on the
    CPU, its routes decided as the card's (``cpu_routes_as_the_card``;
    ``TOL["f64"]``): ``pmc_update`` on fixed samples (the flagship
    K=10 Student-t mixture, D=10, 2^18 particles); one ``GaussianInference``
    iteration (2^16 points, K=5); a ``pmc_run_sharded`` run of 3 steps of
    2^20 particles (mode masses within 0.05 of [0.3, 0.7]; its third step's
    update against the CPU's update of that step's particles); a chain pool
    of 64 chains, 2 cycles of 200 steps through ``sample_adaptive_chains``
    (the tensor pool), and one cycle's steps on fixed random inputs against
    the CPU's.  Returns the launch counts of the entry points' runs."""
    import functools

    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.mix_adapt import variational
    from pypmc_tpu_torch.mix_adapt.pmc import pmc_update
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.parallel import pmc_run_sharded
    from pypmc_tpu_torch.sampler import _scan, markov_chain
    from pypmc_tpu_torch.sampler._target import batched_target, evaluate_target

    f64, cpu = torch.float64, torch.device("cpu")
    params, target, t_means = flagship_problem(device)
    p64, t64 = params.to(dtype=f64), target.to(dtype=f64)
    rng = np.random.default_rng(64)
    total = {}

    def run(label, fn, want):
        k.reset_launch_counts()
        out = fn()
        sync(device)
        counts = k.launch_counts()
        launched = {n: c for n, c in counts.items() if c and not n.startswith("variant:")}
        print("  float64 %s: launches %s" % (label, json.dumps(launched)))
        require(launched == want, "float64 %s: launches %s, not %s" % (label, launched, want))
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        return out

    def close(label, got, ref):
        compare("float64 " + label, torch.as_tensor(got).double().cpu(),
                torch.as_tensor(ref).double(), "f64", report)

    xT = torch.tensor(rng.normal(1.5, 3.0, (10, 1 << 18)), dtype=f64, device=device)
    w = torch.tensor(rng.exponential(1.0, 1 << 18), dtype=f64, device=device)
    got = run("pmc_update K=10 D=10 Student-t", lambda: pmc_update(p64, xT, w, transposed=True),
              {"plain:fused_pmc_stats": 1, "plain:fused_rho": 1, "plain:fused_maha": 1,
               "solve_dofs": 1})
    with cpu_routes_as_the_card(k):
        ref = pmc_update(p64.to(cpu), xT.cpu(), w.cpu(), transposed=True)
    for f in ("means", "cov", "weights", "dof"):
        close("pmc_update " + f, getattr(got.params, f), getattr(ref.params, f))

    centers = rng.normal(0, 4, (5, 4))
    data = torch.tensor(rng.normal(0, 1, (1 << 16, 4)) + centers[rng.integers(0, 5, 1 << 16)],
                        dtype=f64, device=device)
    prior = dict(components=5, alpha0=np.full(5, 1.0), beta0=np.ones(5), nu0=np.full(5, 6.0),
                 m0=centers + rng.normal(0, 0.5, (5, 4)), W0=np.array([np.eye(4)] * 5))

    def vb_iteration(d):
        vb = variational.GaussianInference(d, **prior)
        vb.update()
        return vb

    vb = run("GaussianInference, an iteration, N=2^16 K=5 D=4", lambda: vb_iteration(data),
             {"plain:fused_vb_estep": 2, "plain:fused_maha": 2})
    with cpu_routes_as_the_card(k):
        vb_ref = vb_iteration(data.cpu())
    for f in ("alpha", "beta", "nu", "m", "W"):
        close("GaussianInference " + f, variational._host(getattr(vb, f)),
              variational._host(getattr(vb_ref, f)))

    out, stats = run("pmc_run_sharded, 3 steps of 2^20", lambda: pmc_run_sharded(
        t64, p64, F64_N, 3, key=5), {"draw_proposal_inputs": 3, "solve_dofs": 3,
                                     "plain:fused_is_pmc_step": 3,
                                     "plain:fused_propose_logq": 3,
                                     "plain:fused_transform_rng": 3,
                                     "plain:fused_transform": 3, "plain:fused_logq": 9,
                                     "plain:fused_pmc_stats": 3, "plain:fused_rho": 3,
                                     "plain:fused_maha": 3})
    masses = mode_masses(out, t_means)
    print("  float64 pmc_run_sharded: mode masses %s, ESS %s"
          % (np.round(masses, 4).tolist(), np.round(stats.ess.cpu().numpy(), 4).tolist()))
    require(all(abs(m - t) < 0.05 for m, t in zip(masses, (0.3, 0.7))),
            "float64 pmc_run_sharded: mode masses %s" % masses)
    p2 = pmc_run_sharded(t64, p64, F64_N, 2, key=5)[0]
    p3, _, xT3, w3 = pmc_run_sharded(t64, p2, F64_N, 1, key=6, return_final_samples=True)
    with cpu_routes_as_the_card(k):
        ref = pmc_update(p2.to(cpu), xT3.cpu(), w3.cpu(), rb=True, dof_solver_steps=DOF_STEPS,
                         transposed=True)
    for f in ("means", "cov", "weights", "dof"):
        close("pmc_run_sharded step " + f, getattr(p3, f), getattr(ref.params, f))
    del out, p2, p3, xT3, w3

    C, D, n = 64, 10, 200
    starts = torch.tensor(t_means[rng.integers(0, 2, C)] + rng.normal(0, 0.5, (C, D)),
                          dtype=f64, device=device)
    samples, rates = run("sample_adaptive_chains, 64 chains, 2 x 200 steps",
                         lambda: markov_chain.sample_adaptive_chains(
                             t64, starts, np.eye(D) * 0.5, n, 2, key=3),
                         {"plain:fused_mcmc_pool": 1, "plain:fused_logq": 1 + 2 * n})
    require(samples.dtype == f64 and bool(torch.isfinite(samples).all())
            and bool(((rates > 0) & (rates < 1)).all()),
            "float64 sample_adaptive_chains: rates %s" % rates.cpu().numpy())
    z = torch.tensor(rng.normal(0, 0.7, (n, C, D)), dtype=f64)
    log_u = torch.tensor(np.log(rng.uniform(size=(n, C))), dtype=f64)
    chols = torch.linalg.cholesky(torch.eye(D, dtype=f64) * 0.5).expand(C, D, D).contiguous()

    def cycle(dev):
        mt = t64.to(dev)
        pool_target = batched_target(lambda x: core.mixture_logpdf(mt, x))
        current = starts.to(dev)
        points = torch.empty((n, C, D), dtype=f64, device=dev)
        carry = (current, evaluate_target(pool_target, current),
                 torch.zeros((C,), dtype=f64, device=dev),
                 torch.zeros((), dtype=torch.int64, device=dev))
        scan = _scan.Scan(functools.partial(markov_chain._pool_steps,
                                            functools.partial(evaluate_target, pool_target)))
        out = scan.run((z.to(dev), log_u.to(dev)), (points,), carry, (chols.to(dev),))
        return points, out[1], out[2]

    with cpu_routes_as_the_card(k):
        on_the_cpu = cycle(cpu)
    for label, got, ref in zip(("points", "final log-densities", "accepts"), cycle(device),
                               on_the_cpu):
        close("chain pool cycle " + label, got, ref)
    return total


# --------------------------------------------------------------------- #
# phase blocked: the large-mixture path                                 #
# --------------------------------------------------------------------- #

BLOCKED_CASES = [
    # K, Kt, D, N, Student-t proposal, Student-t target, dead component, seed
    (400, 2, 2, N_PLAIN_MAX, True, False, False, 91),   # the mixture-reduction scale
    (200, 2, 10, N_FLAGSHIP, True, False, True, 92),    # the large-scale step's proposal
    (21, 2, 10, N_ODD, False, True, True, 93),          # a ragged last chunk, odd N
    (96, 2, 40, N_WIDE, False, False, False, 94),       # two components a chunk
    (3, 1, 128, N_WIDE, False, False, False, 95),       # operands in device memory
    (10, 2, 14, N_WIDE, True, True, False, 97),         # three row bands, a ragged chunk
]
BLOCKED_N, BLOCKED_VB_ITERS = 1 << 23, 5


def blocked_case(case, device, report):
    """The three K-blocked kernels on one configuration against their
    float64 plain versions: the statistics on fused_propose_logq's draws
    and weights, the VB E-step on the same points, and the step on its own
    samples, which must be fused_propose_logq's from the same seed words."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dead, seed = case
    arrs, _, params, _, ops, tops, ops64, tops64, tag = case_mixtures(case, device)
    kc, staged, _ = _build.blocked_plan("fused_pmc_stats_blocked", K, D)
    lib = _build.load()
    per_sm = {name: getattr(lib, "pmc_%s_per_sm" % name[len("fused_"):])(K, D)
              for name in _build.BLOCKED}
    draw = lib.pmc_step_draw_per_sm(K, Kt, D)
    print("case blocked %s: %d components a chunk, operands in %s memory; statistics-pass "
          "blocks of 4 warps an SM %s; the step's first pass %s"
          % (tag, kc, "shared" if staged else "device", per_sm,
             "%d blocks of 8 warps an SM" % draw if draw else "fused_propose_logq's kernel"))
    require(min(per_sm.values()) >= 1 and draw >= 0, "blocked %s: a pass fits no SM" % tag)
    if (K, D) == (200, 10):
        require(draw * 8 >= 16, "blocked %s: the step's first pass runs %d warps an SM"
                % (tag, draw * 8))
    seed_a, seed_b = (seed, 11), (seed, 12)
    xT, lat, log_q, log_p = k.fused_propose_logq(seed_a, ops, N, tops)
    w = torch.exp(log_p - log_q)
    x64, w64 = xT.double(), w.double()
    got = k.fused_pmc_stats_blocked(xT, w, ops, student)
    sync(device)
    check_stats("fused_pmc_stats_blocked", got, k.plain_pmc_stats_blocked(x64, w64, ops64, student),
                N, report)
    require(bool(torch.equal(got["g"], k.fused_pmc_stats_blocked(xT, w, ops, student)["g"])),
            "fused_pmc_stats_blocked: one input gave two outputs")
    if dead:
        require(float(got["s0"][K // 2]) == 0.0, "fused_pmc_stats_blocked: a dead component counted")
    A, m, const = vb_operands(params)
    got = k.fused_vb_estep_blocked(xT, w, A, m, const)
    ref = k.plain_vb_estep_blocked(x64, w64, A.double(), m.double(), const.double())
    for name, g, r in zip(("N_comp", "sd", "g", "log_q_Z"), got, ref):
        compare("fused_vb_estep_blocked %s/N" % name, g / N, r / N, "stats", report)
    del got, ref, log_q, log_p, w, w64

    xs, ls, ws, st = k.fused_is_pmc_step_blocked(seed_a, ops, tops, N, student)
    sync(device)
    require(bool(torch.equal(xs, xT)) and bool(torch.equal(ls, lat)),
            "fused_is_pmc_step_blocked: not fused_propose_logq's particles from one seed")
    w_ref = torch.exp(k.plain_logq_blocked(x64, tops64) - k.plain_logq_blocked(x64, ops64))
    compare("fused_is_pmc_step_blocked w", ws, w_ref, "w", report)
    check_stats("fused_is_pmc_step_blocked", st,
                k.plain_pmc_stats_blocked(x64, w_ref, ops64, student, n_sw=3), N, report)
    check_samples("fused_is_pmc_step_blocked", xs, ls, arrs, report)
    again = k.fused_is_pmc_step_blocked(seed_a, ops, tops, N, student)
    require(bool(torch.equal(again[2], ws)) and bool(torch.equal(again[3]["g"], st["g"])),
            "fused_is_pmc_step_blocked: one seed gave two outputs")
    require(not bool(torch.equal(k.fused_is_pmc_step_blocked(seed_b, ops, tops, N, student)[0],
                                 xs)), "fused_is_pmc_step_blocked: two seeds, one output")


def twin_case(device, report):
    """K=12, D=10, Kt=2 (K*D = 120: the dense and the K-blocked kernels
    both take it).  The two steps from the same seed words (the dense one
    on both its passes) draw the same particles and weights, bit for bit
    (a Gaussian target), and their statistics agree; so do the two
    statistics kernels and the two VB E-steps on those particles, and
    pmc_step_mixture_target and pmc_update forced to each route."""
    import torch
    from pypmc_tpu_torch.mix_adapt.pmc import pmc_step_mixture_target, pmc_update
    from pypmc_tpu_torch.ops import kernels as k

    case = (12, 2, 10, N_FLAGSHIP, True, False, True, 96)
    N = case[3]
    _, _, params, target, ops, tops, _, _, tag = case_mixtures(case, device)
    print("case twins", tag)
    xd, ld, wd, sd = k.fused_is_pmc_step((96, 1), ops, tops, N, True)
    xb, lb, wb, sb = k.fused_is_pmc_step_blocked((96, 1), ops, tops, N, True)
    xt, lt, wt, _ = k.fused_is_pmc_step((96, 1), ops, tops, N, True, variant="table")
    sync(device)
    require(all(bool(torch.equal(a, b)) for a, b in ((xd, xb), (ld, lb), (wd, wb))),
            "twins: the dense and the K-blocked step drew different particles or weights")
    require(all(bool(torch.equal(a, b)) for a, b in ((xd, xt), (ld, lt), (wd, wt))),
            "twins: the dense step's register and entry-table passes drew different "
            "particles or weights")
    print("  dense (both passes) and K-blocked steps: the same %d particles and weights" % N)
    dd = lambda st: {key: v.double() for key, v in st.items()}
    compare("twin: fused_is_pmc_step_blocked w", wb, wd.double(), "w", report)
    check_stats("twin: fused_is_pmc_step_blocked", sb, dd(sd), N, report)
    check_stats("twin: fused_pmc_stats_blocked", k.fused_pmc_stats_blocked(xd, wd, ops, True),
                dd(k.fused_pmc_stats(xd, wd, ops, True)), N, report)
    A, m, const = vb_operands(params)
    for name, b, d in zip(("N_comp", "sd", "g", "log_q_Z"),
                          k.fused_vb_estep_blocked(xd, wd, A, m, const),
                          k.fused_vb_estep(xd, wd, A, m, const)):
        compare("twin: fused_vb_estep_blocked %s/N" % name, b / N, d.double() / N, "stats", report)
    steps = {mode: pmc_step_mixture_target(params, target, 97, N, fused=mode)
             for mode in ("dense", "blocked")}
    require(bool(torch.equal(steps["dense"][1], steps["blocked"][1])),
            "twins: the forced dense and blocked pmc_step_mixture_target drew different particles")
    updates = {mode: pmc_update(params, xd, wd, transposed=True, fused=mode).params
               for mode in ("dense", "blocked")}
    for name, pair in (("step", {mode: r[0].params for mode, r in steps.items()}),
                       ("update", updates)):
        for f in ("means", "cov", "weights"):
            compare("twin: %s %s" % (name, f), getattr(pair["blocked"], f),
                    getattr(pair["dense"], f).double(), "update", report)
        compare("twin: %s dof" % name, pair["blocked"].dof, pair["dense"].dof.double(), "dof",
                report)


def blocked_stats_problem(device, student_t, n):
    """benchmarks/blocked_stats.py's K=400, D=2 case in float32: means
    N(0, 3/sqrt(D)), covariances I + A A^T with A ~ N(0, 0.1), equal
    weights, dof 8 for Student-t (seed 0); n samples drawn from the mixture
    and weights |N(1, 0.2)|."""
    import torch
    from pypmc_tpu_torch.density import core

    K, D = 400, 2
    rng = np.random.default_rng(0)
    means = rng.normal(0, 3.0 / np.sqrt(D), size=(K, D)).astype(np.float32)
    a = rng.normal(0, 0.1, size=(K, D, D))
    covs = (np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)).astype(np.float32)
    dofs = np.full((K,), 8.0, np.float32) if student_t else None
    params = make_params((means, covs, np.full((K,), 1.0 / K, np.float32), dofs), device)
    xT = core.propose_T(params, 1, n)[0]
    gen = torch.Generator(device=device).manual_seed(2)
    w = (torch.randn(n, generator=gen, device=device) * 0.2 + 1.0).abs()
    return params, xT, w


def blocked_update(device, report):
    """The K=400, D=2 pmc_update of 2^23 particles, Gaussian and
    Student-t: one fused_pmc_stats_blocked launch each and no plain route,
    against the unfused update (fused="off") on the same tensors.  The
    unfused update keeps (K, N) float32 matrices, 13.4 GB each at 2^23: a
    Gaussian update's two fit the card, a Student-t update's with the dof
    condition about seven do not, so that one is compared at 2^22."""
    import torch
    from pypmc_tpu_torch.mix_adapt.pmc import pmc_update
    from pypmc_tpu_torch.ops import kernels as k

    counts = None
    for student_t in (False, True):
        label = "t" if student_t else "gauss"
        params, xT, w = blocked_stats_problem(device, student_t, BLOCKED_N)
        torch.cuda.synchronize()
        k.reset_launch_counts()
        t0 = time.perf_counter()
        got = pmc_update(params, xT, w, transposed=True)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        c = k.launch_counts()
        require(c["fused_pmc_stats_blocked"] == 1 and c["solve_dofs"] == student_t
                and kernel_launches(c) == 1 + student_t,
                "blocked %s: the K=400 update launched %s" % (label, c))
        counts = c if counts is None else {n: counts[n] + c[n] for n in counts}
        n_cmp = BLOCKED_N // 2 if student_t else BLOCKED_N
        xT, w = xT[:, :n_cmp].contiguous(), w[:n_cmp].contiguous()
        ms = {}
        for mode in ("auto", "off"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pmc_update(params, xT, w, transposed=True, fused=mode)
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) * 1e3
            if mode == "auto":
                got = out.params
            else:
                ref = out.params
            del out
            torch.cuda.empty_cache()
        print("  K=400 D=2 %s pmc_update: N=2^23 %.1f ms (first call, host clock); N=%d "
              "K-blocked %.1f ms, unfused (fused='off') %.1f ms" % (label, first_ms, n_cmp,
                                                                  ms["auto"], ms["off"]))
        for f in ("means", "cov", "weights"):
            compare("blocked update %s %s" % (label, f), getattr(got, f), getattr(ref, f).double(),
                    "update", report)
        if student_t:
            compare("blocked update t dof", got.dof, ref.dof.double(), "dof", report)
        del params, xT, w, got, ref
        torch.cuda.empty_cache()
    return counts


def blocked_vb(device, report):
    """benchmarks/vb_step.py --components 400 --dim 2 (N=2^22, nu = D + 1)
    in float32: one iteration against its float64 plain version, then
    BLOCKED_VB_ITERS iterations without pruning, one fused_vb_estep_blocked
    launch each, the bound finite and not dropping."""
    import torch
    from pypmc_tpu_torch.mix_adapt import GaussianInference

    K, D = 400, 2
    data, w = vb_problem(device, VB_N, K, D)
    vb = GaussianInference(data, components=K, weights=w, nu=D + 1.0)
    del data
    require(vb._fused_eligible() == "blocked", "blocked vb: the E-step is not K-blocked")
    vb_reference(vb, report, "fused_vb_estep_blocked")
    _, record, _, counts = instrumented_run(
        vb, "vb_step.py --components 400 --dim 2", kernel="fused_vb_estep_blocked",
        iterations=BLOCKED_VB_ITERS, prune=0.0)
    ms = [r[0] * 1e3 for r in record]
    print("  iteration ms (host clock): first %.3f, median of the rest %.3f"
          % (ms[0], float(np.median(ms[1:]))))
    del vb
    torch.cuda.empty_cache()
    return counts


def blocked_slice(device):
    """examples/pmc_large_scale.py --components 200: pmc_run_sharded with a
    K=200 Student-t proposal, 10^7 particles a step, 10 steps; one
    fused_is_pmc_step_blocked launch a step, the evidence within 1% of 1
    after step 1 and the mode masses within 0.05 of [0.3, 0.7]."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.parallel import pmc_run_sharded

    params, target, t_means = flagship_problem(device, K=200)
    pmc_run_sharded(target, params, N_SLICE, 1, key=100)      # warm-up
    torch.cuda.synchronize()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = pmc_run_sharded(target, params, N_SLICE, STEPS, key=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = k.launch_counts()
    s = {f: getattr(stats, f).double().cpu().numpy() for f in stats._fields}
    for i in range(STEPS):
        print("  step %2d  ess %.4f  perplexity %.4f  evidence %.6f"
              % (i + 1, s["ess"][i], s["perplexity"][i], s["evidence"][i]))
    w = out.weights.double().cpu().numpy()
    mu = out.means.double().cpu().numpy()
    masses = [float(w[np.linalg.norm(mu - t_means[j], axis=1) < 3].sum()) for j in (0, 1)]
    print("  K=200: %d live components, mode masses %s (target [0.3, 0.7]); launches %s"
          % (int((w > 0).sum()), np.round(masses, 4),
             json.dumps({n: c for n, c in counts.items() if c})))
    print("  10 steps of %d particles: %.1f ms a step (host clock, synchronized)"
          % (N_SLICE, dt / STEPS * 1e3))
    require(all(np.isfinite(v).all() for v in s.values()), "blocked slice: not finite")
    ev_err = np.abs(s["evidence"][1:] - 1.0)
    require(np.all(ev_err < 0.01), "blocked slice: evidence off by %s" % ev_err)
    require(abs(masses[0] - 0.3) < 0.05 and abs(masses[1] - 0.7) < 0.05,
            "blocked slice: mode masses %s" % masses)
    require(counts["solve_dofs"] == STEPS, "blocked slice: %d solve_dofs launches for %d steps"
            % (counts["solve_dofs"], STEPS))
    require(counts["fused_is_pmc_step_blocked"] == STEPS and counts["plain:fused_is_pmc_step"] == 0,
            "blocked slice: %d fused_is_pmc_step_blocked launches for %d steps"
            % (counts["fused_is_pmc_step_blocked"], STEPS))
    return counts, dt / STEPS * 1e3


def phase_blocked(device, report):
    """The K-blocked kernels against their plain versions and their dense
    twins, then the three large-mixture configurations with the launch
    counts read around each; returns the summed counts of the three
    configurations and the K=200 step ms."""
    import torch

    for case in BLOCKED_CASES:
        blocked_case(case, device, report)
        torch.cuda.empty_cache()
    twin_case(device, report)
    torch.cuda.empty_cache()
    update = blocked_update(device, report)
    vb = blocked_vb(device, report)
    step, step_ms = blocked_slice(device)
    dofs_before_after(device, 200)
    torch.cuda.empty_cache()
    return {n: update[n] + vb[n] + step[n] for n in update}, step_ms


# --------------------------------------------------------------------- #
# phase 7: the transform routes                                         #
# --------------------------------------------------------------------- #

ROUTE_N = 1 << 18


def phase_routes(device, report):
    """propose_logq_T against a 2-component target, past
    fused_propose_logq's rule (K + 2 >= 13 components refuse its 1024-lane
    tile at D=40, K + 2 >= 6 at D=80): at D=40 K=11 draws through
    fused_draw_transform_rng, K=16 through fused_draw_transform (one launch
    each: the draw and the transform), fewer than 1024 particles on the
    tensor path after draw_proposal_inputs; at D=80 (2^16 particles), past
    the record kernels, K=4 through draw_proposal_inputs and
    fused_transform_rng, K=16 through draw_proposal_inputs and
    fused_transform (Student-t scale drawn outside, clamped),
    fused_transform_rng on its drawn product, fused_transform on the kernel
    its plan elects there (the tiled pair).  Each draw's
    samples are checked against its mixture and each log-density against
    float64."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    rng = np.random.default_rng(80)
    total = None
    for D, K, n, route, variant in ((40, 11, ROUTE_N, "fused_draw_transform_rng", None),
                                    (40, 16, ROUTE_N, "fused_draw_transform", None),
                                    (40, 11, 1000, "tensor", None),
                                    (80, 4, 1 << 16, "fused_transform_rng",
                                     _build.transform_plan(4, 80, rng=True)[0]),
                                    (80, 16, 1 << 16, "fused_transform",
                                     _build.transform_plan(16, 80)[0])):
        target = make_params(random_mixture(rng, 2, D, False), device)
        t64 = target.to("cpu", torch.float64)
        arrs = random_mixture(rng, K, D, True, spread=3.0)
        params = make_params(arrs, device)
        k.reset_launch_counts()
        xT, lat, log_q, log_p = core.propose_logq_T(params, K, n, target)
        sync(device)
        counts = k.launch_counts()
        launched = {name: c for name, c in counts.items() if c and not name.startswith("variant:")}
        print("  K=%d D=%d n=%d Student-t: launches %s" % (K, D, n, json.dumps(launched)))
        if variant is not None:
            require(counts["variant:%s=%s" % (route, variant)] == 1,
                    "routes: K=%d D=%d's %s launch did not take the %s kernel"
                    % (K, D, route, variant))
        refused = {"plain:fused_propose_logq": 1, "fused_logq": 2}
        if route in ("fused_draw_transform", "fused_transform", "tensor"):
            refused["plain:fused_transform_rng"] = 1
        if route == "tensor":
            refused["plain:fused_transform"] = 1
        if route in ("fused_transform", "fused_transform_rng", "tensor"):
            refused["draw_proposal_inputs"] = 1
        want = dict(refused, **({} if route == "tensor" else {route: 1}))
        require(launched == want, "routes: K=%d D=%d n=%d took %s, not the %s route"
                % (K, D, n, launched, route))
        x64 = xT.cpu().double()
        compare("routes K=%d D=%d log q" % (K, D), log_q.cpu(),
                core.mixture_logpdf_T(params.to("cpu", torch.float64), x64), "log", report)
        compare("routes K=%d D=%d log p" % (K, D), log_p.cpu(), core.mixture_logpdf_T(t64, x64),
                "log", report)
        if n >= 1 << 16:
            check_samples(route + " K=%d" % K, xT, lat, arrs, report)
            check_components(route + " K=%d" % K, xT, lat, arrs)
        total = counts if total is None else {c: total[c] + counts[c] for c in total}
    counts = per_point_routes(device, report)
    return {c: total[c] + counts[c] for c in total}


def per_point_routes(device, report):
    """A per-point target that reaches fused_maha (``density.core
    .mahalanobis_all_T`` of its point) and one that reaches fused_rho
    (``mix_adapt.pmc.calculate_rho_rb_T``), on the pipeline's K=32, D=40
    mixture, each mapped over 2^16 points as the samplers map a per-point
    target (``sampler._target.map_points``): one launch for the block, no
    warning, equal bit for bit to the batched call on the block.  Returns
    the launch counts of the two maps."""
    import logging

    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.mix_adapt.pmc import calculate_rho_rb_T
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.sampler import _target

    rng = np.random.default_rng(82)
    params = make_params(random_mixture(rng, 32, 40, True), device)
    x = torch.tensor(rng.normal(0, 2, (1 << 16, 40)), dtype=torch.float32, device=device)
    cases = [("fused_maha", lambda p: -0.5 * core.mahalanobis_all_T(params, p[:, None])[:, 0].min(),
              lambda xT: -0.5 * core.mahalanobis_all_T(params, xT).min(dim=0).values),
             ("fused_rho", lambda p: torch.log(calculate_rho_rb_T(params, p[:, None])[:, 0].max()),
              lambda xT: torch.log(calculate_rho_rb_T(params, xT).max(dim=0).values))]
    log = logging.getLogger(_target.__name__)
    total = None
    for kernel, point, block in cases:
        handler = logging.Handler(logging.WARNING)
        messages = []
        handler.emit = lambda record: messages.append(record.getMessage())
        log.addHandler(handler)
        try:
            k.reset_launch_counts()
            got = _target.map_points(point, x)
            sync(device)
            counts = k.launch_counts()
        finally:
            log.removeHandler(handler)
        launched = {n: c for n, c in counts.items() if c and not n.startswith("variant:")}
        print("  a per-point target through %s over %d points: launches %s, warnings %d"
              % (kernel, x.shape[0], json.dumps(launched), len(messages)))
        require(launched == {kernel: 1} and not messages,
                "%s: a per-point target took %s launches, warnings %s" % (kernel, launched,
                                                                          messages))
        want = block(x.T.contiguous())
        require(bool(torch.equal(got, want)), "%s: the per-point target differs from the "
                "batched call by %.3e" % (kernel, float((got - want).abs().max())))
        total = counts if total is None else {c: total[c] + counts[c] for c in total}
    return total


# --------------------------------------------------------------------- #
# phase 8: the chain pool                                               #
# --------------------------------------------------------------------- #

MCMC_C, MCMC_D, MCMC_STEPS, MCMC_CYCLES = 16384, 10, 500, 4


# the wide path (phase wide): D, a Kt=2 Gaussian-mixture target and a K=4
# Gaussian proposal near it, particles a PMC step, steps; VB's points,
# components and iterations
WIDE_PATH = dict(D=200, K=4, Kt=2, n=1 << 16, steps=5, vb_n=1 << 16, vb_iters=10)


def wide_path_problem(device, D=None):
    """WIDE_PATH's mixtures: ``(params, target)``, a Kt=2 Gaussian-mixture
    target (weights 0.3/0.7, covariances 0.8 I and 1.2 I) and a K=4
    Gaussian proposal near its modes, equal weights, in float32; at
    WIDE_PATH's D unless ``D`` is given."""
    K, Kt = WIDE_PATH["K"], WIDE_PATH["Kt"]
    D = D or WIDE_PATH["D"]
    rng = np.random.default_rng(200)
    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 2.0]).astype(np.float32)
    t_covs = np.array([np.eye(D) * 0.8, np.eye(D) * 1.2], np.float32)
    target = make_params((t_means, t_covs, np.array([0.3, 0.7], np.float32), None), device)
    means = t_means[np.arange(K) % Kt] + rng.normal(0, 0.05, (K, D)).astype(np.float32)
    params = make_params((means, t_covs[np.arange(K) % Kt], np.full(K, 1.0 / K, np.float32),
                          None), device)
    return params, target


def recorded_launches(k, name):
    """Patch ``k``'s launch operator of ``name`` (``"logq"``, ``"rho"`` or
    ``"maha"``) so that every launch's arguments and output (a tuple of
    outputs for fused_rho) are kept, as clones, in the list returned; and a
    function that undoes it."""
    attr = "_%s_launch" % name
    launch, kept = getattr(k, attr), []

    def recording(*args):
        out = launch(*args)
        kept.append(tuple(a.detach().clone() if hasattr(a, "detach") else a for a in args)
                    + (tuple(o.detach().clone() for o in out) if isinstance(out, tuple)
                       else out.detach().clone(),))
        return out

    setattr(k, attr, recording)
    return kept, lambda: setattr(k, attr, launch)


# the wide PMC step's device rows (ms a step, launches a step, kernel), as
# phase_wide last profiled them
wide_step_rows = []


def phase_wide(device, report):
    """The wide path through the port's entry points, past D = 128 where
    fused_transform takes its tiled pair and fused_logq, fused_rho and
    fused_maha their tensor-core kernels: ``parallel.pmc_run_sharded`` at
    WIDE_PATH (its steps draw by ``propose_T`` past fused_propose_logq's
    rule, draw_proposal_inputs then
    fused_transform, so each step's log q, log p and log-likelihood are
    fused_logq launches, and its unfused update a fused_rho launch), every
    fused_logq and fused_rho launch of the run held to its float64 plain
    version on the same particles, every fused_logq and fused_rho launch
    on the kernel elected, every fused_transform launch tiled; a
    ``GaussianInference`` fit at WIDE_PATH's VB size (the unfused E-step, one
    fused_maha launch an iteration, each on the kernel fused_maha elects),
    its first iteration's bilinear term
    held to the same term in float64 on the CPU.  Each prints ms a step or
    iteration (host clock, synchronized), device ms (torch.profiler) and the
    variant counts; returns the launch counts of the two runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pypmc_tpu_torch.mix_adapt import GaussianInference
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.parallel import pmc_run_sharded

    D, K, Kt, n, steps = (WIDE_PATH[f] for f in ("D", "K", "Kt", "n", "steps"))
    params, target = wide_path_problem(device)
    kept, undo = recorded_launches(k, "logq")
    kept_rho, undo_rho = recorded_launches(k, "rho")
    k.reset_launch_counts()
    try:
        out, stats = pmc_run_sharded(target, params, n, steps, key=3)
        sync(device)
    finally:
        pmc_counts = k.launch_counts()
        undo()
        undo_rho()
    require(len(kept) == pmc_counts["fused_logq"] >= 2 * steps,
            "wide pmc: %d fused_logq launches kept of %d for %d steps"
            % (len(kept), pmc_counts["fused_logq"], steps))
    for name, least in (("fused_logq", 2 * steps), ("fused_rho", steps),
                        ("fused_transform", steps)):
        want = "tiled" if name == "fused_transform" else _build.eval_variant(name, D)
        require(pmc_counts["variant:%s=%s" % (name, want)] == pmc_counts[name] >= least,
                "wide pmc: %d of %d %s launches took the %s kernel, for %d steps"
                % (pmc_counts["variant:%s=%s" % (name, want)], pmc_counts[name], name, want,
                   steps))
    require(len(kept_rho) == pmc_counts["fused_rho"],
            "wide pmc: %d fused_rho launches kept of %d" % (len(kept_rho), pmc_counts["fused_rho"]))
    # each step's responsibilities against their float64 plain version,
    # where float32 resolves the proposal's log q (as the log q held below)
    for i, (xT, packed, Kl, student_t, (rho, log_q)) in enumerate(kept_rho):
        rho_ref, lq_ref = k.plain_rho(xT.double(),
                                      k.MixtureOperands(packed.double(), Kl, D, student_t))
        held = torch.isfinite(lq_ref) & (lq_ref.abs() < 1e30)
        require(i >= 1 or bool(held.all()), "wide pmc: the first step's log q is not finite "
                "in float64")
        if bool(held.any()):
            name = "wide pmc step %d fused_rho (K=%d, %d of %d held)" % (
                i + 1, Kl, int(held.sum()), held.numel())
            compare(name + " rho", rho[:, held], rho_ref[:, held], "rho", report)
            compare(name + " log_q", log_q[held], lq_ref[held], "log", report)
    del kept_rho
    # a step's launches: log q of its proposal, log p, and the log-likelihood
    # of the updated mixture, which PMC in D = 200 from 2^16 particles may
    # leave ill-conditioned (components of weight 0, or covariances so
    # narrow that float32 cannot resolve U_k (x - m_k)): each step's log q
    # and log p are held to their float64 plain versions where float32
    # resolves them (finite, |log q| < 1e30; everywhere in the first step),
    # the log-likelihood's errors printed
    for i, (xT, packed, Kl, student_t, got) in enumerate(kept):
        ref = k.plain_logq(xT.double(), k.MixtureOperands(packed.double(), Kl, D, student_t))
        held = torch.isfinite(ref) & (ref.abs() < 1e30)
        require(i >= 2 or bool(held.all()), "wide pmc: the first step's log densities are not "
                "finite in float64")
        name = "wide pmc step %d %s (K=%d, %d of %d held)" % (
            i // 3 + 1, ("log q", "log p", "log-likelihood")[i % 3], Kl, int(held.sum()),
            held.numel())
        if i % 3 == 2:
            print("  %s: max |kernel - float64| %.3e" % (
                name, float((got[held].double() - ref[held]).abs().max())))
        elif bool(held.any()):
            compare(name, got[held], ref[held], "log", report)
    del kept
    t0 = time.perf_counter()
    pmc_run_sharded(target, params, n, steps, key=4)
    sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pmc_run_sharded(target, params, n, steps, key=5)
        sync(device)
    rows = device_rows(prof, steps)
    wide_step_rows[:] = rows
    print("  pmc_run_sharded D=%d K=%d Kt=%d n=%d: %.3f ms a step (host), device %.3f ms a "
          "step; ess %s, weights %s; launches %s" % (
              D, K, Kt, n, step_ms, sum(r[0] for r in rows),
              np.array2string(stats.ess.cpu().numpy(), precision=4),
              np.array2string(out.weights.cpu().numpy(), precision=4),
              json.dumps({c: v for c, v in pmc_counts.items() if v})))
    for t, c, key in [r for i, r in enumerate(rows) if i < 6 or "pmc::" in r[2]]:
        print("    %8.3f ms  %5.1f x  %s" % (t, c, key[:90]))
    del out, stats, prof
    torch.cuda.empty_cache()

    data, w = vb_problem(device, WIDE_PATH["vb_n"], K, D)
    vb = GaussianInference(data, components=K, weights=w, nu=D + 1.0)
    del data
    kept, undo = recorded_launches(k, "maha")
    k.reset_launch_counts()
    ms = []
    try:
        for _ in range(WIDE_PATH["vb_iters"]):
            t0 = time.perf_counter()
            vb._update_with_bound()
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        vb_counts = k.launch_counts()
        undo()
    require(vb_counts["fused_maha"] == vb_counts["variant:fused_maha=" + k._elect(
                "fused_maha", K, D, None)] == WIDE_PATH["vb_iters"] == len(kept),
            "wide vb: fused_maha launches %s for %d iterations"
            % ({c: v for c, v in vb_counts.items() if "maha" in c and v}, WIDE_PATH["vb_iters"]))
    xT, a, m, got = kept[0]
    ref = k.plain_maha(xT.cpu().double(), a.cpu().double(), m.cpu().double())
    compare("wide vb iteration 1 bilinear term (CPU float64)", got, ref.to(device), "maha", report)
    del kept, xT, a, m, got, ref
    for f in ("N_comp", "x_mean_comp", "S", "alpha", "W"):
        require(bool(torch.isfinite(getattr(vb, f)).all()), "wide vb: %s not finite" % f)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vb._update_with_bound()
        vb._update_with_bound()
        sync(device)
    rows = device_rows(prof, 2)
    print("  GaussianInference D=%d K=%d N=%d: %.3f ms an iteration (host, median of %d), device "
          "%.3f ms an iteration; launches %s" % (
              D, K, WIDE_PATH["vb_n"], float(np.median(ms)), len(ms), sum(r[0] for r in rows),
              json.dumps({c: v for c, v in vb_counts.items() if v})))
    for t, c, key in rows[:4]:
        print("    %8.3f ms  %5.1f x  %s" % (t, c, key[:90]))
    del vb, prof
    torch.cuda.empty_cache()
    return {c: pmc_counts[c] + vb_counts[c] for c in pmc_counts}


# the wide importance-sampling path (phase wide_is): (a) one Student-t
# proposal (dof 5) at D=200 against WIDE_PATH's target, n_is1 = 2^20
# particles a run, timed runs; (b) pmc_run_sharded at D=96, a K=3 Student-t
# proposal, a Kt=1 Gaussian target, 2^16 particles, steps; (c) propose of a
# K=1 Student-t at D=200 and a K=2 Gaussian at D=128, draws
WIDE_IS = dict(D=200, dof=5.0, n=1 << 20, runs=5, pmc_D=96, pmc_K=3, pmc_n=1 << 16,
               pmc_steps=5, propose_n=1 << 20)


def wide_is_problem(device):
    """``(proposal, target)``: (a)'s MixtureDensity of one Student-t (dof 5)
    centred between WIDE_PATH's target's modes, covariance 1.5 I, and that
    target (wide_path_problem's Kt=2 Gaussian mixture, MixtureParams)."""
    from pypmc_tpu_torch.density.mixture import MixtureDensity

    D = WIDE_IS["D"]
    _, target = wide_path_problem(device)
    mean = target.means.mean(dim=0).cpu().numpy()[None].astype(np.float32)
    params = make_params((mean, np.eye(D, dtype=np.float32)[None] * 1.5,
                          np.ones(1, np.float32), np.full(1, WIDE_IS["dof"], np.float32)),
                         device)
    return MixtureDensity.from_params(params), target


def wide_pmc_problem(device):
    """(b)'s mixtures: a K=3 Student-t proposal (seed 96) and a Kt=1 Gaussian
    target near its first component, in float32 at D=96."""
    D, K = WIDE_IS["pmc_D"], WIDE_IS["pmc_K"]
    arrs = random_mixture(np.random.default_rng(D), K, D, True, spread=0.5)
    tarrs = (arrs[0][:1] + 0.1, arrs[1][:1] * 1.2, np.ones(1, np.float32), None)
    return make_params(arrs, device), make_params(tarrs, device)


def wide_is_profile(device):
    """``{"run_ms", "row5_ms", "rows"}``: device ms (torch.profiler) of one
    ImportanceSampler.run of (a) and of its proposal's propose_logq_T alone
    (row 5's share of the run), the run's kernels (ms, launches, name); run
    in a fresh process (``chip_smoke.py --wide-is-profile``), after a
    warm-up run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.sampler import ImportanceSampler

    proposal, target = wide_is_problem(device)
    from pypmc_tpu_torch.density.mixture import MixtureDensity
    target_fn = MixtureDensity.from_params(target).evaluate_fn(batched=True, device=device)
    sampler = ImportanceSampler(target_fn, proposal, rng=11, device=device)
    params = proposal.stacked_params(device=device)
    sampler.run(WIDE_IS["n"], to_host=False)
    core.propose_logq_T(params, 3, WIDE_IS["n"])
    sync(device)
    sampler.clear()
    out = {}
    for key, call in (("run", lambda: sampler.run(WIDE_IS["n"], to_host=False)),
                      ("row5", lambda: core.propose_logq_T(params, 5, WIDE_IS["n"]))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            sync(device)
        rows = device_rows(prof, 1)
        out[key + "_ms"] = sum(r[0] for r in rows)
        out[key + "_rows"] = [[t, c, name[:90]] for t, c, name in rows[:6]]
        sampler.clear()
    return out


def phase_wide_is(device, report):
    """The wide importance-sampling path through the port's entry points,
    where fused_propose_logq and fused_transform_rng take their drawn tiled
    products: (a) ``ImportanceSampler.run`` of WIDE_IS's D=200 Student-t
    proposal against WIDE_PATH's target (a batched target: one fused_logq
    launch a run), its log q held to float64 on the same particles, ms a run
    (host clock, synchronized, the median of WIDE_IS["runs"]), device ms and
    row 5's share of it (torch.profiler, in a fresh process); (b)
    ``pmc_run_sharded`` at D=96 (K=3 Student-t, Kt=1, 2^16) with and without
    ``scan_steps=True`` (scan_case: bit for bit, replayed); (c)
    ``MixtureDensity.propose`` of a K=1 Student-t at D=200 and of a K=2
    Gaussian at D=128, 2^20 draws (row 4's route: draw_proposal_inputs for
    the components, then fused_transform_rng), each component's particles
    about its mean, ms a call (host clock, the copy to the host included).
    Every row 4 and row 5 launch of (a)-(c) must be tiled.  Returns the
    launch counts of (a)-(c)."""
    import torch

    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.density.mixture import MixtureDensity
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.sampler import ImportanceSampler

    totals = {}

    def add(counts):
        for name, c in counts.items():
            totals[name] = totals.get(name, 0) + c

    def require_tiled(label, counts, name, least):
        tiled, launched = counts.get("variant:%s=tiled" % name, 0), counts.get(name, 0)
        require(tiled == launched >= least, "wide_is %s: %d of %d %s launches took the tiled "
                "kernel" % (label, tiled, launched, name))

    # (a) ImportanceSampler.run at D=200
    D, n = WIDE_IS["D"], WIDE_IS["n"]
    proposal, target = wide_is_problem(device)
    target_fn = MixtureDensity.from_params(target).evaluate_fn(batched=True, device=device)
    sampler = ImportanceSampler(target_fn, proposal, rng=7, device=device)
    kept, propose_logq_T = [], core.propose_logq_T

    def recording(*args, **kwargs):
        out = propose_logq_T(*args, **kwargs)
        kept.append(out)
        return out

    k.reset_launch_counts()
    core.propose_logq_T = recording
    try:
        sampler.run(n, to_host=False)
        sync(device)
    finally:
        core.propose_logq_T = propose_logq_T
    counts = k.launch_counts()
    require(len(kept) == 1, "wide_is (a): %d proposals recorded" % len(kept))
    require_tiled("(a)", counts, "fused_propose_logq", 1)
    require(counts["fused_logq"] == 1
            and counts["variant:fused_logq=%s" % _build.eval_variant("fused_logq", D)] == 1,
            "wide_is (a): the target took %s" % {c: v for c, v in counts.items() if v})
    xT, latent, log_q = kept[0]
    params = proposal.stacked_params(device=device)
    ops64 = k.MixtureOperands(core._kernel_operands(params).packed.double(), 1, D, True)
    compare("wide_is (a) D=%d log q" % D, log_q, k.plain_logq(xT.double(), ops64), "log", report)
    samples_T, weights = sampler.device_runs[0]
    require(tuple(samples_T.shape) == (D, n) and bool(torch.isfinite(samples_T).all())
            and bool(torch.isfinite(weights).all()) and bool((weights >= 0).all()),
            "wide_is (a): the run's samples or weights are not finite")
    del kept, xT, latent, log_q, samples_T, weights
    sampler.clear()
    add(counts)
    ms = []
    for _ in range(WIDE_IS["runs"]):
        sync(device)
        t0 = time.perf_counter()
        sampler.run(n, to_host=False)
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        sampler.clear()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, __file__, "--wide-is-profile"], capture_output=True,
                          text=True, timeout=600)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("WIDE_IS_PROFILE ")]
    require(proc.returncode == 0 and line, "wide_is (a): the profile's process failed: %s"
            % (proc.stdout[-2000:] + proc.stderr[-2000:]))
    prof = json.loads(line[0].split(" ", 1)[1])
    print("  wide_is (a) ImportanceSampler.run D=%d K=1 t (dof %g), N=%d, Kt=2 target: %.3f ms "
          "a run (host, median of %d: %s), device %.3f ms (fresh process), row 5 %.3f ms of it "
          "(%.1f%%); launches %s" % (
              D, WIDE_IS["dof"], n, float(np.median(ms)), len(ms), np.round(ms, 3).tolist(),
              prof["run_ms"], prof["row5_ms"], 100 * prof["row5_ms"] / prof["run_ms"],
              json.dumps({c: v for c, v in counts.items() if v})))
    for t, c, name in prof["run_rows"]:
        print("    %8.3f ms  %5.1f x  %s" % (t, c, name))

    # (b) pmc_run_sharded at D=96, K + Kt = 4: row 5 with a target
    pparams, ptarget = wide_pmc_problem(device)
    counts = scan_case(device, "wide_is (b) D=%d K=%d t, Kt=1" % (WIDE_IS["pmc_D"],
                                                                   WIDE_IS["pmc_K"]),
                       pparams, ptarget, WIDE_IS["pmc_n"], WIDE_IS["pmc_steps"])
    require_tiled("(b)", counts, "fused_propose_logq", WIDE_IS["pmc_steps"])
    add(counts)
    torch.cuda.empty_cache()

    # (c) MixtureDensity.propose: row 4's route
    for K, Dc, student, seed in ((1, 200, True, 401), (2, 128, False, 402)):
        arrs = random_mixture(np.random.default_rng(seed), K, Dc, student)
        mixture = MixtureDensity.from_params(make_params(arrs, device))
        N = WIDE_IS["propose_n"]
        k.reset_launch_counts()
        x, latent = mixture.propose(N, rng=seed, trace=True, shuffle=False, device=device)
        counts = k.launch_counts()
        require_tiled("(c) K=%d D=%d" % (K, Dc), counts, "fused_transform_rng", 1)
        require(x.shape == (N, Dc) and np.isfinite(x).all(), "wide_is (c): bad draws")
        check_components("wide_is (c) propose K=%d D=%d" % (K, Dc),
                         torch.tensor(x.T.copy()), torch.tensor(latent), arrs)
        add(counts)
        del x, latent
        ms = []
        for i in range(3):
            sync(device)
            t0 = time.perf_counter()
            mixture.propose(N, rng=seed + i + 1, device=device)
            ms.append((time.perf_counter() - t0) * 1e3)
        print("  wide_is (c) MixtureDensity.propose K=%d D=%d %s N=%d: %s ms a call (host, the "
              "copy to the host included); variant %s" % (
                  K, Dc, "t" if student else "gauss", N, np.round(ms, 3).tolist(),
                  _build.draw_plan("fused_transform_rng", K, Dc)[0]))
        torch.cuda.empty_cache()
    return totals


# the wide PMC path past D = 16, where fused_is_pmc_step and fused_pmc_stats
# take the Gram pass: (a) one Student-t proposal at D=128 (the rule admits
# the step there with one target component: with two its VMEM fit at a
# 1024-particle tile fails, 6.39 MB of 6 MB) and (b) six at D=20 (K D =
# 120), each against a target of phase wide's construction, 2^20
# particles, 5 steps; (c) an ImportanceSampler.run of 2^20 at D=128 on a
# per-point callable target, then one PMC update of its proposal
WIDE_PMC = dict(D=128, Kt=1, small_D=20, small_K=6, small_Kt=2, dof=5.0, n=1 << 20, steps=5)


def wide_pmc_problems(device):
    """``[(label, proposal, target)]`` of (a) and (b): (a) one Student-t
    (dof 5) at the D=128 target's heavier mode + 0.05, covariance 1.5 I,
    against that mode alone (covariance 1.2 I; wide_path_problem at D=128);
    (b) six Student-t components at D=20 near the two modes of
    wide_path_problem at D=20 (three each, + N(0, 0.3)), covariance 1.5 I,
    equal weights, against that Kt=2 target."""
    rng = np.random.default_rng(128)
    D, dof = WIDE_PMC["D"], WIDE_PMC["dof"]
    _, wide = wide_path_problem(device, D)
    mode = wide.means[1].cpu().numpy()[None].astype(np.float32)
    target = make_params((mode, np.eye(D, dtype=np.float32)[None] * 1.2,
                          np.ones(1, np.float32), None), device)
    params = make_params((mode + 0.05, np.eye(D, dtype=np.float32)[None] * 1.5,
                          np.ones(1, np.float32), np.full(1, dof, np.float32)), device)
    Ds, Ks = WIDE_PMC["small_D"], WIDE_PMC["small_K"]
    _, small = wide_path_problem(device, Ds)
    t_means = small.means.cpu().numpy()
    means = (t_means[np.arange(Ks) % 2] + rng.normal(0, 0.3, (Ks, Ds))).astype(np.float32)
    sparams = make_params((means, np.tile(np.eye(Ds, dtype=np.float32) * 1.5, (Ks, 1, 1)),
                           np.full(Ks, 1.0 / Ks, np.float32), np.full(Ks, dof, np.float32)),
                          device)
    return [("wide_pmc (a) D=%d K=1 t, Kt=1" % D, params, target),
            ("wide_pmc (b) D=%d K=%d t, Kt=2" % (Ds, Ks), sparams, small)]


def wide_is_sampler(device, params, target):
    """``(proposal, sampler)`` of phase wide_pmc (c): an
    ImportanceSampler (rng 13) of wide_pmc_problems (a)'s proposal on a
    per-point callable target, the log-density of (a)'s target."""
    import torch
    from pypmc_tpu_torch.density.mixture import MixtureDensity
    from pypmc_tpu_torch.sampler import ImportanceSampler

    D = WIDE_PMC["D"]
    proposal = MixtureDensity.from_params(params)
    mu, prec = target.means[0], torch.linalg.inv(target.cov[0])
    log_norm = -0.5 * (D * math.log(2 * math.pi) + float(torch.logdet(target.cov[0])))

    def log_target(x):
        d = x - mu.to(x.dtype)
        return log_norm - 0.5 * (d @ (prec.to(x.dtype) @ d))

    return proposal, ImportanceSampler(log_target, proposal, rng=13, device=device)


def phase_wide_pmc(device, report):
    """PMC past D = 16 through the port's entry points, where
    fused_is_pmc_step and fused_pmc_stats take the Gram pass: (a) and (b)
    of wide_pmc_problems by ``pmc_run_sharded`` at 2^20 particles, 5 steps,
    with and without ``scan_steps=True`` (scan_case: bit for bit, replayed;
    host and device ms a step, launches, each kernel's share), every step's
    fused_is_pmc_step launch counted =gram and no plain: route; (c) an
    ``ImportanceSampler.run`` of 2^20 at D=128 of (a)'s proposal on a
    per-point callable target (the log-density of (a)'s target, mapped with
    vmap), then ``PMC(...).run(1)`` on its samples and weights: its one
    fused_pmc_stats launch counted =gram, the updated proposal against the
    unfused update (fused="off") in float64 on the same samples.  Returns
    the launch counts of (a)-(c)."""
    import torch

    from pypmc_tpu_torch.mix_adapt import PMC
    from pypmc_tpu_torch.mix_adapt.pmc import pmc_update
    from pypmc_tpu_torch.ops import kernels as k

    totals = {}

    def add(counts):
        for name, c in counts.items():
            totals[name] = totals.get(name, 0) + c

    def require_gram(label, counts, name, least):
        gram, launched = counts.get("variant:%s=gram" % name, 0), counts.get(name, 0)
        plain = {c: v for c, v in counts.items() if c.startswith("plain:") and v}
        require(gram == launched >= least and not plain, "%s: %d of %d %s launches took the "
                "Gram pass; plain routes %s" % (label, gram, launched, name, plain))

    problems = wide_pmc_problems(device)
    for label, params, target in problems:
        counts = scan_case(device, label, params, target, WIDE_PMC["n"], WIDE_PMC["steps"])
        require_gram(label, counts, "fused_is_pmc_step", WIDE_PMC["steps"])
        add(counts)
        torch.cuda.empty_cache()

    # (c) a generic target: importance sampling, then one PMC update
    _, params, target = problems[0]
    proposal, sampler = wide_is_sampler(device, params, target)
    D, n = WIDE_PMC["D"], WIDE_PMC["n"]
    ms = []
    for i in range(3):
        sampler.clear()
        k.reset_launch_counts()
        sync(device)
        t0 = time.perf_counter()
        sampler.run(n, to_host=False)
        samples_T, weights = sampler.device_runs[0]
        pmc = PMC(samples_T.T, proposal, weights=weights, device=device)
        pmc.run(1)
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = k.launch_counts()
    require_gram("wide_pmc (c)", counts, "fused_pmc_stats", 1)
    add(counts)
    got = pmc.density.stacked_params(device=device)
    require(bool(torch.isfinite(weights).all()) and bool((weights >= 0).all()),
            "wide_pmc (c): the run's weights are not finite")
    ref = pmc_update(params.to(dtype=torch.float64),
                     samples_T.double(), weights.double(), transposed=True, fused="off").params
    for f in ("means", "cov", "weights"):
        compare("wide_pmc (c) update %s" % f, getattr(got, f), getattr(ref, f).double(),
                "update", report)
    compare("wide_pmc (c) update dof", got.dof, ref.dof.double(), "dof", report)
    print("  wide_pmc (c) ImportanceSampler.run D=%d K=1 t (dof %g), N=%d, a per-point target, "
          "then PMC.run(1): %s ms (host, synchronized); launches %s"
          % (D, WIDE_PMC["dof"], n, np.round(ms, 3).tolist(),
             json.dumps({c: v for c, v in counts.items() if v})))
    del sampler, pmc, samples_T, weights
    torch.cuda.empty_cache()
    return totals


# the wide VB path past D = 16, where fused_vb_estep takes the Gram pass
# (K D <= 128 from 1024 points, the JAX rule's one-pass reach): (a)
# benchmarks/vb_step.py --dim 20 --components 6's data and (b) its --dim 40
# --components 3 (2^22 points, 10 iterations, prune off); (c) the pipeline's
# is1_vb2 at D=128: phase wide_pmc (c)'s importance samples and weights
# (2^20, one Student-t proposal) into GaussianInference seeded by that
# proposal, 5 iterations
WIDE_VB = dict(n=1 << 22, iterations=10, shapes=((6, 20), (3, 40)), is_iterations=5)


def phase_wide_vb(device, report):
    """GaussianInference(...).run past D = 16 through its normal entry point,
    float32 on the card, (a)-(c) of WIDE_VB: each fit's first iteration held
    to the float64 plain version on the kernel's operands (vb_reference),
    every fused_vb_estep launch of its run counted =gram and no plain:
    route, the kernel's operands held in float32 (variational
    _held_operands), host and device ms an iteration, the busy share and
    the launches.  Returns the launch counts of (a)-(c), (c)'s importance
    sampling run included."""
    import torch
    from pypmc_tpu_torch.mix_adapt import GaussianInference
    from pypmc_tpu_torch.ops import kernels as k

    totals = {}

    def add(counts):
        for name, c in counts.items():
            totals[name] = totals.get(name, 0) + c

    def fit(label, vb, iterations):
        require(k._elect("fused_vb_estep", vb.K, vb.dim, None) == "gram",
                "%s: the plan at K=%d, D=%d is not the Gram pass" % (label, vb.K, vb.dim))
        vb_reference(vb, report)
        _, record, _, counts = instrumented_run(vb, label, iterations=iterations, prune=0)
        gram, launched = counts["variant:fused_vb_estep=gram"], counts["fused_vb_estep"]
        plain = {c: v for c, v in counts.items() if c.startswith("plain:") and v}
        require(gram == launched == len(record) and not plain,
                "%s: %d of %d fused_vb_estep launches took the Gram pass; plain routes %s"
                % (label, gram, launched, plain))
        held = vb._held()
        require(held is not None and all(v.dtype == torch.float32 for v in held),
                "%s: the E-step's operands are not held in float32" % label)
        ms = [r[0] * 1e3 for r in record]
        print("  %s: iteration ms (host clock): first %.3f, median of the rest %.3f"
              % (label, ms[0], float(np.median(ms[1:] or ms))))
        profiled_iterations(vb, label + ", profiled iteration")
        add(counts)

    for tag, (K, D) in zip("ab", WIDE_VB["shapes"]):
        data, w = vb_problem(device, n=WIDE_VB["n"], K=K, D=D)
        vb = GaussianInference(data, components=K, weights=w, nu=D + 1.0)
        del data, w
        fit("wide_vb (%s) vb_step.py --dim %d --components %d, N=%d" % (tag, D, K, WIDE_VB["n"]),
            vb, WIDE_VB["iterations"])
        del vb
        torch.cuda.empty_cache()

    # (c) importance samples of one Student-t at D=128 (wide_pmc (c)), then VB
    # seeded by the proposal, as the pipeline's is1_vb2
    _, params, target = wide_pmc_problems(device)[0]
    proposal, sampler = wide_is_sampler(device, params, target)
    k.reset_launch_counts()
    sampler.run(WIDE_PMC["n"], to_host=False)
    sync(device)
    add(k.launch_counts())
    samples_T, weights = sampler.device_runs[0]
    require(bool(torch.isfinite(weights).all()), "wide_vb (c): the run's weights are not finite")
    vb = GaussianInference(samples_T.T, initial_guess=proposal, weights=weights)
    del sampler, samples_T, weights
    fit("wide_vb (c) is1_vb2 D=%d K=1, N=%d" % (WIDE_PMC["D"], WIDE_PMC["n"]), vb,
        WIDE_VB["is_iterations"])
    del vb
    torch.cuda.empty_cache()
    return totals


# D > 128 shapes (K, Kt, D, N) at which the drawn products are held to the
# parent commit's warp kernels bit for bit (``--parent-draws``)
PARENT_DRAW_SHAPES = [(1, 1, 129, 20_003), (2, 0, 129, 20_003), (1, 1, 200, 20_003),
                      (1, 0, 248, 20_003), (1, 0, 1000, 4_099)]
# fused_transform's tiled pair past D = 128 against the parent's (TILED_CASES'
# shapes there, and the wide path's K = 4 at D = 200): K, Kt, D, N
PARENT_TRANSFORM_SHAPES = [(1, 0, 129, N_WIDE), (30, 0, 129, 4099), (1, 0, 200, 4099),
                           (19, 0, 200, N_WIDE), (4, 0, 200, N_WIDE), (1, 0, 1000, N_WIDE),
                           (3, 0, 2040, 4099)]


def draw_outputs(device):
    """``{shape: (xT, latent, log_q, log_p, x of fused_transform_rng)}`` on the
    host, of the package imported, at PARENT_DRAW_SHAPES on drawn_inputs
    (seed words (7, 1) and (7, 3)); ``{"transform " + shape: x}`` of
    fused_transform at PARENT_TRANSFORM_SHAPES on tiled_inputs."""
    from pypmc_tpu_torch.ops import kernels as k

    out = {}
    for shape in PARENT_DRAW_SHAPES:
        a = drawn_inputs(device, shape)
        prop = k.fused_propose_logq((7, 1), a["ops"], shape[3], a["tops"])
        x = k.fused_transform_rng((7, 3), a["latent"], a["ops"])
        out["%d,%d,%d,%d" % shape] = [t.cpu() for t in prop] + [None] * (4 - len(prop)) + [x.cpu()]
    for shape in PARENT_TRANSFORM_SHAPES:
        a = tiled_inputs(device, shape)
        out["transform %d,%d,%d,%d" % shape] = k.fused_transform(
            a["zT"], a["latent"], a["scale"], a["ops"]).cpu()
    return out


def parent_draws(device, parent):
    """The drawn products against the kernels the checkout ``parent`` elects
    at PARENT_DRAW_SHAPES, and fused_transform at PARENT_TRANSFORM_SHAPES,
    the parent's outputs made in a child process (``--draw-outputs``): x and
    latent equal bit for bit, log q and log p within TOL "log" of each
    other; the counts of outputs that differ printed."""
    import torch

    path = "build/parent_draws.pt"
    proc = subprocess.run([sys.executable, __file__, "--draw-outputs", parent, path],
                          capture_output=True, text=True, timeout=900)
    require(proc.returncode == 0, "the parent's draws failed: %s"
            % (proc.stdout[-2000:] + proc.stderr[-2000:]))
    theirs, ours = torch.load(path), draw_outputs(device)
    for key, mine in ours.items():
        other = theirs[key]
        if key.startswith("transform "):
            differ = int((mine != other).sum())
            print("  parent fused_transform K,Kt,D,N=%s: %d of %d x differ"
                  % (key.split()[1], differ, mine.numel()))
            require(differ == 0, "fused_transform differs from the parent's kernels at %s in %d "
                    "outputs" % (key, differ))
            continue
        differ = [int((a != b).sum()) for a, b in ((mine[0], other[0]), (mine[1], other[1]),
                                                   (mine[4], other[4]))]
        print("  parent draws K,Kt,D,N=%s: x %d, latent %d, fused_transform_rng x %d of %d, %d, "
              "%d differ" % (key, *differ, mine[0].numel(), mine[1].numel(), mine[4].numel()))
        for i, out in ((2, "log q"), (3, "log p")):
            if mine[i] is not None:
                compare("parent draws %s %s" % (key, out), mine[i], other[i].double(), "log", [])
        require(sum(differ) == 0, "the drawn products differ from the parent's kernels at %s: %s"
                % (key, differ))


# the shapes (K, D, N) at which --parent-tiled holds the forced tiled
# kernels of fused_logq, fused_rho and fused_maha to an earlier checkout's
PARENT_TILED_SHAPES = [(1, 65, 4099), (60, 65, N_WIDE), (41, 96, 4099), (1, 200, N_WIDE),
                       (19, 200, 4099), (4, 200, N_WIDE)]


def tiled_outputs(device):
    """``{shape: (log q, rho, rho's log q, maha)}`` on the host of the
    package imported, its tiled kernels forced (fused_rho's elected where
    its wrapper takes no ``variant``: the tiled kernel in an earlier
    checkout past D = 64), at PARENT_TILED_SHAPES on a Student-t mixture
    with a dead component and particles from it (finite)."""
    import inspect

    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    out = {}
    rho_variant = "variant" in inspect.signature(k.fused_rho).parameters
    for K, D, N in PARENT_TILED_SHAPES:
        rng = np.random.default_rng(K + D)
        params = make_params(random_mixture(rng, K, D, True, K > 1), device)
        ops = core._kernel_operands(params)
        xT = mixture_particles(ops, N, K + D, device)
        rho, rq = (k.fused_rho(xT, ops, variant="tiled") if rho_variant
                   else k.fused_rho(xT, ops))
        maha = k.fused_maha(xT, params.inv_chol, params.means, variant="tiled")
        out["%d,%d,%d" % (K, D, N)] = [t.cpu() for t in (
            k.fused_logq(xT, ops, variant="tiled"), rho, rq, maha)]
    return out


def parent_tiled(device, parent):
    """The tiled kernels of fused_logq, fused_rho and fused_maha, forced,
    against the checkout ``parent``'s at PARENT_TILED_SHAPES (its outputs
    made in a child process, ``--tiled-outputs``): every finite output
    equal bit for bit (the padded rows left out of the squares add +0 on a
    finite particle); the outputs that differ counted."""
    import torch

    path = "build/parent_tiled.pt"
    proc = subprocess.run([sys.executable, __file__, "--tiled-outputs", parent, path],
                          capture_output=True, text=True, timeout=900)
    require(proc.returncode == 0, "the parent's tiled kernels failed: %s"
            % (proc.stdout[-2000:] + proc.stderr[-2000:]))
    theirs, ours = torch.load(path), tiled_outputs(device)
    for key, mine in ours.items():
        differ = [int((a != b).sum()) for a, b in zip(mine, theirs[key])]
        print("  parent tiled K,D,N=%s: log q %d, rho %d, rho's log q %d, maha %d differ"
              % (key, *differ))
        require(sum(differ) == 0, "the tiled kernels differ from the parent's at %s: %s"
                % (key, differ))


def wide_times(device):
    """``{path: (device ms, rows)}`` of the wide paths, a fresh process
    (``--wide-times DIR``, the package at DIR imported; torch.profiler,
    after a warm-up): the wide PMC step at WIDE_PATH (D=200, K=4, Kt=2,
    2^16, a step of 5), the wide IS run (wide_is_profile: 2^20 at D=200) and
    the wide PMC step at D=128, K=1 (wide_pmc_problems (a), 2^20, a step of
    5)."""
    from torch.profiler import ProfilerActivity, profile

    from pypmc_tpu_torch.parallel import pmc_run_sharded

    out = {}
    for label, (params, target), n in (
            ("pmc D=200 K=4", wide_path_problem(device), WIDE_PATH["n"]),
            ("pmc D=128 K=1", wide_pmc_problems(device)[0][1:], WIDE_PMC["n"])):
        steps = 5
        pmc_run_sharded(target, params, n, 1, key=4)
        sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pmc_run_sharded(target, params, n, steps, key=5)
            sync(device)
        rows = device_rows(prof, steps)
        out[label] = (sum(r[0] for r in rows), [[t, c, name[:90]] for t, c, name in rows[:6]])
    prof = wide_is_profile(device)
    out["is D=200"] = (prof["run_ms"], prof["run_rows"])
    for label, (ms, rows) in out.items():
        print("  wide %s: %.4f device ms" % (label, ms))
        for t, c, name in rows:
            print("    %8.4f ms  %5.1f x  %s" % (t, c, name))
    return out


def mcmc_problem(device):
    """benchmarks/mcmc_chains.py's fused configuration: its quadratic
    target (seed 3) as a 1-component Gaussian mixture in float32, C=16384
    starts N(0, 1) (seed 0), sigma0 = 2.38^2 / D I."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 0.3, size=(MCMC_D, MCMC_D))
    cov = np.eye(MCMC_D) + a @ a.T
    target = make_params((np.zeros((1, MCMC_D), np.float32), cov[None].astype(np.float32),
                          np.ones(1, np.float32), None), device)
    starts = np.random.default_rng(0).normal(0, 1, size=(MCMC_C, MCMC_D)).astype(np.float32)
    return target, starts, np.eye(MCMC_D, dtype=np.float32) * 2.38 ** 2 / MCMC_D, cov


def report_pool_variant(phase, counts, launches, C, D):
    """Print the pool's variant the entry point elected for C chains in D
    dimensions (launch_counts' variant counts); every launch took the one
    ops/_build.py pool_variant names."""
    from pypmc_tpu_torch.ops import _build

    elected = _build.pool_variant(C, D)
    got = {v: counts["variant:fused_mcmc_pool=" + v] for v in POOL_VARIANTS}
    print("  %s: C=%d D=%d elects a %s a chain; launches by variant %s"
          % (phase, C, D, elected, json.dumps(got)))
    require(got[elected] == launches,
            "%s: %d of %d pool launches took the elected variant (%s)"
            % (phase, got[elected], launches, elected))


def phase_mcmc(device):
    """sample_adaptive_chains at that configuration, 500 steps x 4 cycles:
    one warm-up, then three runs with distinct seeds, each between a reset
    and a read of the launch counts (one fused_mcmc_pool launch a cycle);
    chain-steps a second on the host clock, synchronized; the pooled
    second half against the target's covariance."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.sampler import sample_adaptive_chains

    target, starts, sigma0, cov = mcmc_problem(device)

    def run(key):
        return sample_adaptive_chains(target, starts, sigma0, MCMC_STEPS, MCMC_CYCLES, key=key)

    run(100)
    torch.cuda.synchronize()
    times, counts = [], None
    for rep in range(3):
        k.reset_launch_counts()
        t0 = time.perf_counter()
        samples, rates = run(rep)
        rate = float(rates[:, -1].mean())           # synchronizes
        times.append(time.perf_counter() - t0)
        c = k.launch_counts()
        # the starts' log-densities are one fused_logq
        require(c["fused_mcmc_pool"] == MCMC_CYCLES and c["fused_logq"] == 1
                and kernel_launches(c) == MCMC_CYCLES + 1,
                "mcmc: launches %s, not one fused_mcmc_pool a cycle" % c)
        counts = c if counts is None else {n: counts[n] + c[n] for n in counts}
    steps = MCMC_C * MCMC_STEPS * MCMC_CYCLES
    x = samples[:, MCMC_STEPS * MCMC_CYCLES // 2:].reshape(-1, MCMC_D).double()
    xc = x - x.mean(dim=0)
    err = float(((xc.T @ xc / x.shape[0]).cpu() - torch.tensor(cov)).abs().max())
    mean_err = float(x.mean(dim=0).abs().max())
    print("  C=%d D=%d %d steps x %d cycles: %s s (host clock, synchronized); %.4g "
          "chain-steps/s at the median; last-cycle acceptance %.3f; pooled second half: "
          "mean off by %.4f, covariance by %.4f"
          % (MCMC_C, MCMC_D, MCMC_STEPS, MCMC_CYCLES, ", ".join("%.4f" % t for t in times),
             steps / float(np.median(times)), rate, mean_err, err))
    print("  launches a run %s" % json.dumps({n: c // 3 for n, c in counts.items() if c}))
    report_pool_variant("mcmc", counts, 3 * MCMC_CYCLES, MCMC_C, MCMC_D)
    require(0.1 < rate < 0.6, "mcmc: acceptance %.3f" % rate)
    require(mean_err < 0.05 and err < 0.05 * float(np.abs(cov).max()),
            "mcmc: pooled moments off the target (%.4f, %.4f)" % (mean_err, err))
    return counts, steps / float(np.median(times))


# --------------------------------------------------------------------- #
# phase 9: the one-call pipeline                                        #
# --------------------------------------------------------------------- #

def highdim_target(dim, seed=7, separation=6.0):
    """benchmarks/accuracy_highdim.py make_target: a bimodal D-dimensional
    Gaussian mixture (weights 0.35/0.65), anisotropic rotated covariances,
    modes ``separation`` apart along a random direction; evidence 1."""
    from pypmc_tpu_torch.density import create_gaussian_mixture

    rng = np.random.default_rng(seed)
    direction = rng.normal(size=dim)
    direction /= np.linalg.norm(direction)
    means = np.stack([np.zeros(dim), separation * direction])
    covs = []
    for _ in range(2):
        a = rng.normal(0, 0.15 / np.sqrt(dim), size=(dim, dim))
        covs.append(np.eye(dim) * rng.uniform(0.5, 1.0) + a @ a.T)
    return create_gaussian_mixture(means, np.array(covs), np.array([0.35, 0.65]))


def highdim_starts(target, n_chains=32, seed=2024):
    """The benchmark's overdispersed starts: mode centers plus 4x-inflated
    mode noise."""
    from pypmc_tpu_torch.density import recover_gaussian_mixture

    rng = np.random.default_rng(seed)
    which = rng.integers(0, 2, n_chains)
    m, c, _ = recover_gaussian_mixture(target)
    return np.stack([rng.multivariate_normal(m[k], 4.0 * c[k]) for k in which])


PIPELINE = dict(dim=40, mcmc_steps=400, mcmc_cycles=12, thin=5, K_g=1, inflate=2.0,
                pmc_steps=10, pmc_dof=8.0, n_is1=1 << 20, n_is2=1 << 22)


def phase_pipeline(device):
    """integrate at benchmarks/accuracy_highdim.py --dim 40 --is-samples
    4194304, between a reset and a read of the launch counts: evidence
    error under 1%, ESS above 0.15 (tests/test_highdim_pipeline.py:71-80),
    one fused_mcmc_pool launch a cycle; then tests/test_pipeline_api.py's
    callable-target run on the card."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.pipeline import integrate
    from pypmc_tpu_torch.density import create_gaussian_mixture

    cfg = dict(PIPELINE)
    dim = cfg.pop("dim")
    target = highdim_target(dim)
    starts = highdim_starts(target)
    k.reset_launch_counts()
    vb = {"after": [], "before": []}
    t0 = time.perf_counter()
    with vb_runs(vb["after"]):
        r = integrate(target, dim, starts, key=2024, **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = k.launch_counts()
    err = abs(r.evidence - 1.0) * 100.0
    d = r.details
    print("  D=%d: evidence %.6f +- %.6f (error %.4f%%), perplexity %.4f, ESS %.4f, "
          "%d samples, %.1f s" % (dim, r.evidence, r.uncertainty, err, r.perplexity, r.ess,
                                   r.n_samples, wall))
    print("  K: patches %d, VB1 %d, VB2 %d, final %d; last-cycle acceptance %.3f"
          % (d["patches_K"], d["vb1_K"], d["vb2_K"], d["final_K"],
             float(np.mean(d["accept_rates"]))))
    print("  stage seconds: %s" % json.dumps({n: round(v, 4) for n, v in d.items()
                                              if n.endswith("_s")}))
    print("  PMC perplexity curve %s" % np.round(d["pmc_perplexity_curve"], 4).tolist())
    print("  launch counts %s" % json.dumps({n: c for n, c in counts.items() if c}))
    require(np.isfinite([r.evidence, r.uncertainty, r.ess]).all(), "pipeline: not finite")
    require(err < 1.0, "pipeline: evidence error %.4f%% >= 1%%" % err)
    require(r.ess > 0.15, "pipeline: ESS %.4f <= 0.15" % r.ess)
    require(r.samples.shape == (r.n_samples, dim), "pipeline: samples of shape %s"
            % (r.samples.shape,))
    require(counts["fused_mcmc_pool"] == cfg["mcmc_cycles"],
            "pipeline: %d fused_mcmc_pool launches for %d cycles"
            % (counts["fused_mcmc_pool"], cfg["mcmc_cycles"]))
    report_pool_variant("pipeline", counts, cfg["mcmc_cycles"], len(starts), dim)
    for name in ("fused_propose_logq", "fused_logq"):
        require(counts[name] > 0, "pipeline: %s not launched" % name)
    # the VB E-steps take the JAX package's route: fused_vb_estep where
    # K*D <= 128, else the unfused E-step through fused_maha (one long patch
    # a chain at D=40: K=32)
    vb_route = "fused_vb_estep" if k.fits("fused_vb_estep", d["vb1_K"], dim) else "fused_maha"
    require(counts[vb_route] > 0, "pipeline: VB1 at K=%d, D=%d did not run %s"
            % (d["vb1_K"], dim, vb_route))
    print("  VB1 at K=%d, D=%d: E-steps through %s" % (d["vb1_K"], dim, vb_route))
    # fused_maha's launches (the unfused E-steps) all on the kernel it
    # elects at D=40
    elected = k._elect("fused_maha", d["vb1_K"], dim, None)
    print("  fused_maha: %d launches, %s (elected at D=%d: %s)"
          % (counts["fused_maha"], ", ".join("variant:fused_maha=%s %d" % (v, counts[
              "variant:fused_maha=" + v]) for v in k._variant_names("fused_maha")), dim, elected))
    require(counts["variant:fused_maha=" + elected] == counts["fused_maha"],
            "pipeline: %d of %d fused_maha launches took the elected %s kernel"
            % (counts["variant:fused_maha=" + elected], counts["fused_maha"], elected))
    # the PMC draws at K=31-32, D=40: the draw and fused_transform's route in
    # one launch, and no launch of the two it replaces
    require(counts["fused_draw_transform"] > 0 and counts["fused_transform"] == 0
            and counts["draw_proposal_inputs"] == 0,
            "pipeline: %d fused_draw_transform launches, %d fused_transform, %d "
            "draw_proposal_inputs" % (counts["fused_draw_transform"], counts["fused_transform"],
                                      counts["draw_proposal_inputs"]))
    print("  fused_draw_transform: %d launches (the PMC draws), no fused_transform or "
          "draw_proposal_inputs launch" % counts["fused_draw_transform"])
    require(counts["variant:fused_propose_logq=rec"] == counts["fused_propose_logq"],
            "pipeline: %d of %d fused_propose_logq launches took the record kernel"
            % (counts["variant:fused_propose_logq=rec"], counts["fused_propose_logq"]))
    print("  fused_propose_logq: %d launches, all on the record kernel"
          % counts["fused_propose_logq"])

    # where the device time of the run goes: the same run again, profiled
    from torch.profiler import ProfilerActivity, profile

    # (with the VB E-step's route as before the float32 stopping rule's
    # repair: the one-pass E-step at any N)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            min_n(k, 0), vb_runs(vb["before"]):
        t0 = time.perf_counter()
        integrate(target, dim, starts, key=2024, **cfg)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    for when, runs in (("after", vb["after"]), ("before", vb["before"])):
        require(len(runs) == 2, "pipeline: %d VB runs, not VB1 and VB2" % len(runs))
        print("  VB1, VB2 %s the float32 stopping rule's repair: %s"
              % (when, "; ".join("N=%d D=%d K=%d %s" % (
                  n, d, kk, "converged after %d iterations" % it if it is not None
                  else "not converged in %d iterations" % cap) for n, d, kk, it, cap in runs)))
    rows = device_rows(prof, 1)
    busy = sum(r[0] for r in rows) / 1e3
    print("  profiled run: device %.3f s of %.3f s host (%.1f%% busy), %d launches"
          % (busy, host_s, 100 * busy / host_s, sum(r[1] for r in rows)))
    # the twelve largest rows, then the port's own kernels below them
    for i, (ms, count, key) in enumerate(rows):
        if i < 12 or "pmc::" in key:
            print("    %9.3f ms  %6.0f x  %s" % (ms, count, key[:90]))

    # tests/test_pipeline_api.py:40-47: a per-point callable target
    means = np.stack([np.zeros(2), np.full(2, 3.0)])
    fn = create_gaussian_mixture(means, np.array([np.eye(2) * 0.7] * 2),
                                 np.array([0.4, 0.6])).evaluate_fn()
    srng = np.random.default_rng(0)
    cstarts = np.vstack([srng.normal(0, 1.5, (6, 2)), srng.normal(3, 1.5, (6, 2))])
    t0 = time.perf_counter()
    rc = integrate(fn, 2, cstarts, key=0, mcmc_steps=200, mcmc_cycles=5, n_is1=1 << 13,
                   n_is2=1 << 14, pmc_steps=2)
    print("  callable target (D=2): evidence %.5f +- %.5f, %.1f s"
          % (rc.evidence, rc.uncertainty, time.perf_counter() - t0))
    require(abs(rc.evidence - 1.0) < 0.05, "pipeline: callable-target evidence %.5f"
            % rc.evidence)
    return counts, {"evidence": r.evidence, "error_pct": err, "ess": r.ess, "wall_s": wall}


# --------------------------------------------------------------------- #
# phase 10: parallel -- the particle mesh over torch.distributed         #
# --------------------------------------------------------------------- #

# the rows of the main-path kernels every rank must launch: fused_logq (1),
# fused_propose_logq (5), fused_pmc_stats (7), fused_is_pmc_step (8),
# fused_vb_estep (9)
PARALLEL_ROWS = ("fused_logq", "fused_propose_logq", "fused_pmc_stats", "fused_is_pmc_step",
                 "fused_vb_estep")
PARALLEL_RUNS = 4               # ParallelSampler runs, 2^22 particles each in all
PARALLEL_TIMEOUT = {1: 300, 2: 420}   # seconds a rank may take, by world size


def digest(*tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def watch_kernel_devices(k):
    """Wrap every kernel wrapper of ``k`` (the module) so that the devices
    of the tensors handed to it are recorded; returns the set they go to."""
    import torch

    seen = set()

    def walk(a, depth=0):
        if isinstance(a, torch.Tensor):
            seen.add(str(a.device))
        elif isinstance(a, (tuple, list)) and depth < 3:
            for b in a:
                walk(b, depth + 1)
        elif hasattr(a, "__dict__") and depth < 3 and not callable(a):
            for b in vars(a).values():
                walk(b, depth + 1)

    import functools

    wrappers = []
    for fn in k._WRAPPERS:
        @functools.wraps(fn)
        def wrapped(*args, _fn=fn, **kwargs):
            walk(args)
            walk(tuple(kwargs.values()))
            return _fn(*args, **kwargs)
        # a wrapper counts its launches on the module's name for it: the
        # counts are read from the functions that now hold those names
        setattr(k, fn.__name__, wrapped)
        wrappers.append(wrapped)
    k._WRAPPERS = tuple(wrappers)
    return seen


def host_t_mixture(params):
    from pypmc_tpu_torch.density import create_t_mixture

    h = {f: getattr(params, f).double().cpu().numpy() for f in ("means", "cov", "dof", "weights")}
    return create_t_mixture(h["means"], h["cov"], h["dof"], h["weights"] / h["weights"].sum())


def mode_masses(params, t_means):
    w = params.weights.double().cpu().numpy()
    mu = params.means.double().cpu().numpy()
    return [float(w[np.linalg.norm(mu - t_means[j], axis=1) < 3].sum()) for j in (0, 1)]


def trace_one_step(mesh, params, target, tries=3):
    """One PMC step of the mesh run under ``profiling.trace``: the Chrome
    trace must hold the step's range and its fused_is_pmc_step kernel (the
    register pass, ``dense_reg_kernel``).  The profiler may drop a run's
    kernel events; the step is traced again, up to ``tries`` times."""
    import glob
    import os
    import tempfile

    from pypmc_tpu_torch import profiling
    from pypmc_tpu_torch.parallel import pmc_run_sharded

    for attempt in range(1, tries + 1):
        with tempfile.TemporaryDirectory(prefix="pypmc_trace_") as logdir:
            with profiling.trace(logdir):
                pmc_run_sharded(target, params, N_SLICE, 1, mesh, key=50 + attempt)
            (path,) = glob.glob(os.path.join(logdir, "trace_*.json"))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        ranges = [e for e in events if e.get("name") == "pmc_step"]
        kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                          and "dense_reg_kernel" in e.get("name", "")})
        print("  trace (run %d): %d events, %d pmc_step ranges, step kernels %s"
              % (attempt, len(events), len(ranges), kernels))
        require(ranges, "parallel: the trace holds no pmc_step range")
        if kernels:
            return kernels
    raise SmokeFailure("parallel: %d traces of a PMC step recorded no dense_reg_kernel"
                       % tries)


def timed_vb_run(vb, profiling):
    """``vb.run(VB_ITERS, prune=1.0)`` with each iteration's milliseconds
    (host clock, the card synchronized around each: ``profiling.timed``)."""
    record = []
    update = vb._update_with_bound

    def timed_update():
        with profiling.timed("iteration", record):
            return update()

    vb._update_with_bound = timed_update
    try:
        vb.run(VB_ITERS, prune=1.0)
    finally:
        del vb._update_with_bound
    return [sec * 1e3 for _, sec in record]


def parallel_worker(rank, world, port, backend, shared):
    """One rank of the parallel phase (``chip_smoke.py --parallel-worker``):
    joins the group, drives the mesh path between a reset and a read of the
    launch counts, checks its results and prints them as one JSON line."""
    import os

    import torch

    torch.cuda.set_device(0)
    import pypmc_tpu_torch  # noqa: F401
    from pypmc_tpu_torch import checkpoint, profiling
    from pypmc_tpu_torch.mix_adapt import GaussianInference
    from pypmc_tpu_torch.mix_adapt.pmc import pmc_update
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.parallel import (ParallelSampler, distributed_initialize,
                                          particle_mesh, pmc_run_sharded, run_is_step_sharded)
    from pypmc_tpu_torch.pipeline import integrate

    require("jax" not in sys.modules, "rank %d imported jax" % rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    _build.load()
    require(not _build.build_info["built"], "rank %d built the kernels again" % rank)
    distributed_initialize("localhost:%d" % port, world, rank, backend=backend)
    mesh = particle_mesh()
    require((mesh.size, mesh.rank, mesh.device) == (world, rank, device),
            "rank %d: mesh %r" % (rank, mesh))
    res = {"rank": rank, "world": world, "backend": torch.distributed.get_backend()}
    times = []

    params, target, t_means = flagship_problem(device)
    pmc_run_sharded(target, params, N_SLICE, 1, mesh, key=100)   # warm-up, not counted
    seen = watch_kernel_devices(k)
    k.reset_launch_counts()

    # the K=10 PMC slice on the mesh: 10 steps, then 2 weight_clip steps
    with profiling.timed("pmc_step", times):
        out, stats = pmc_run_sharded(target, params, N_SLICE, STEPS, mesh, key=0)
    out_c, stats_c = pmc_run_sharded(target, params, N_SLICE, 2, mesh, key=1, weight_clip=True)
    if world > 1:
        # a total the ranks do not divide: each draws one more
        xs = run_is_step_sharded(params, target, 3, N_SLICE + 1, mesh)[0]
        out_odd, stats_odd = pmc_run_sharded(target, params, N_SLICE + 1, 1, mesh, key=2)
        require(xs.shape == (10, N_SLICE // world + 1), "parallel: shard of %s" % (xs.shape,))
        require(bool(torch.isfinite(out_odd.means).all() and torch.isfinite(stats_odd.ess).all()),
                "parallel: the non-divisible run is not finite")
        del xs
    masses = mode_masses(out, t_means)
    s = {f: getattr(stats, f).double().cpu().numpy() for f in stats._fields}
    require(all(np.isfinite(v).all() for v in s.values()), "parallel: PMC stats not finite")
    require(np.all(np.abs(s["evidence"][1:] - 1.0) < 0.01),
            "parallel: PMC evidence %s" % s["evidence"])
    require(abs(masses[0] - 0.3) < 0.05 and abs(masses[1] - 0.7) < 0.05,
            "parallel: mode masses %s" % masses)
    res.update(pmc_digest=digest(out.means, out.cov, out.weights, out.dof, *stats,
                                 out_c.means, out_c.cov, out_c.weights, *stats_c),
               masses=masses, ess=float(s["ess"][-1]))
    res["scan"] = mesh_scan(mesh, params, target, out, stats)

    # ParallelSampler with the adapted flagship proposal: N a rank a run
    n_rank = (1 << 22) // world
    ps = ParallelSampler(target, host_t_mixture(out), mesh=mesh, rng=5, save_target_values=True)
    for i in range(PARALLEL_RUNS):
        with profiling.timed("sampler_run", times):
            ps.run(n_rank, to_host=i % 2 == 0)   # runs 2 and 4 stay on the device
    sum_w, sum_w2, n_ev = ps.evidence_stats()
    with profiling.timed("gather", times):
        flushed = ps.gather()
    w_all = ps.weights[:][:, 0]
    evidence = sum_w / n_ev
    # runs 1-3 went to the host with run 3's gather; run 4 was pending
    require(flushed == 1 and n_ev == PARALLEL_RUNS * n_rank * world
            and ps.samples[:].shape == (n_ev, 10) and len(w_all) == n_ev,
            "parallel: ParallelSampler holds %s samples, %d in evidence_stats"
            % (ps.samples[:].shape, n_ev))
    require(abs(evidence - 1.0) < 0.01, "parallel: ParallelSampler evidence %.6f" % evidence)
    require(np.isclose(sum_w, w_all.sum(), rtol=1e-4) and np.isfinite(ps.target_values[:]).all(),
            "parallel: gathered weights disagree with evidence_stats")
    res.update(evidence=evidence, gather_digest=digest(
        torch.from_numpy(ps.samples[:]), torch.from_numpy(ps.weights[:]),
        torch.from_numpy(ps.target_values[:])))
    del ps, w_all
    torch.cuda.empty_cache()

    # GaussianInference(mesh=) at benchmarks/vb_step.py's configuration
    data, w = vb_problem(device)
    vb = GaussianInference(data, components=VB_K, weights=w, nu=VB_D + 1.0, mesh=mesh)
    vb_ms = timed_vb_run(vb, profiling)
    vb_iters = len(vb_ms)
    times.append(("vb_iteration", float(np.median(vb_ms[1:])) / 1e3))
    vb_state = {"bound": vb.likelihood_bound(), "N_comp": vb.N_comp.cpu().numpy(),
                "K": vb.K}
    res.update(vb_digest=digest(vb.m, vb.W, vb.alpha, vb.N_comp), vb_K=vb.K,
               vb_iterations=vb_iters)
    del vb
    torch.cuda.empty_cache()

    # checkpoints: both ranks save to the same paths; rank 0's files only
    gate = os.path.join(shared, "gate.npz")
    checkpoint.atomic_savez(gate, marker=np.array([float(rank)]))
    checkpoint.save_mixture(os.path.join(shared, "adapted.npz"), out)
    mesh.barrier()
    with np.load(gate) as f:
        writer = int(f["marker"][0])
    require(writer == 0 and checkpoint.is_primary_process() == (rank == 0),
            "parallel: rank %d wrote a checkpoint" % writer)

    # integrate(mesh=) at benchmarks/accuracy_highdim.py --dim 40 --is-samples 4194304
    cfg = dict(PIPELINE)
    dim = cfg.pop("dim")
    tgt = highdim_target(dim)
    t0 = time.perf_counter()
    r = integrate(tgt, dim, highdim_starts(tgt), key=2024, mesh=mesh,
                  checkpoint_dir=os.path.join(shared, "run") if world > 1 else None, **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = abs(r.evidence - 1.0) * 100.0
    require(err < 1.0, "parallel: integrate evidence error %.4f%% >= 1%%" % err)
    require(r.ess > 0.15, "parallel: integrate ESS %.4f <= 0.15" % r.ess)
    res.update(integrate={"evidence": r.evidence, "error_pct": err, "ess": r.ess, "wall_s": wall,
                          "K": [r.details[n] for n in ("patches_K", "vb1_K", "vb2_K", "final_K")],
                          "stages": {n: v for n, v in r.details.items() if n.endswith("_s")}},
               integrate_digest=digest(torch.tensor([r.evidence, r.ess]),
                                       torch.from_numpy(np.asarray(r.weights))))
    torch.cuda.synchronize()
    counts = k.launch_counts()
    res["counts"] = {n: c for n, c in counts.items() if c}
    res["devices"] = sorted(seen)
    for name in PARALLEL_ROWS:
        require(counts[name] > 0, "parallel: rank %d launched no %s" % (rank, name))
    require(seen == {"cuda:0"}, "parallel: rank %d handed kernels tensors on %s" % (rank, seen))
    # one all-reduce of the step's largest statistic (g: K D^2 float64), alone
    g = torch.zeros(VB_K * VB_D * VB_D, dtype=torch.float64, device=device)
    mesh.reduce(g)
    with profiling.timed("all_reduce", times):
        for _ in range(50):
            mesh.reduce(g)
    times[-1] = ("all_reduce", times[-1][1] / 50)

    if world == 1:
        # the one-rank mesh in a group draws and adapts what no mesh does, bit for bit
        with profiling.timed("pmc_step_no_mesh", times):
            ref, ref_stats = pmc_run_sharded(target, params, N_SLICE, STEPS, None, key=0)
        ref_c, ref_stats_c = pmc_run_sharded(target, params, N_SLICE, 2, None, key=1,
                                             weight_clip=True)
        same = digest(ref.means, ref.cov, ref.weights, ref.dof, *ref_stats, ref_c.means,
                      ref_c.cov, ref_c.weights, *ref_stats_c) == res["pmc_digest"]
        require(same, "parallel: pmc_run_sharded(mesh=) differs from mesh=None")
        vb_ref = GaussianInference(data, components=VB_K, weights=w, nu=VB_D + 1.0)
        times.append(("vb_iteration_no_mesh",
                      float(np.median(timed_vb_run(vb_ref, profiling)[1:])) / 1e3))
        require(digest(vb_ref.m, vb_ref.W, vb_ref.alpha, vb_ref.N_comp) == res["vb_digest"]
                and vb_ref.likelihood_bound() == vb_state["bound"],
                "parallel: GaussianInference(mesh=) differs from mesh=None")
        res["bit_identical"] = True
        del vb_ref
        res["trace_kernels"] = trace_one_step(mesh, params, target)
    else:
        # the update with its sums over the ranks' halves of float64
        # particles (the plain versions, on the CPU) against one update of
        # all of them
        rng = np.random.default_rng(0)
        p64 = params.to("cpu", torch.float64)
        x = torch.from_numpy(rng.normal(1.5, 3.0, size=(1 << 16, 10)))
        wt = torch.from_numpy(np.abs(rng.normal(1.0, 0.2, size=1 << 16)))
        half = slice(rank * (1 << 15), (rank + 1) * (1 << 15))
        got = pmc_update(p64, x[half], wt[half], reduce=mesh.reduce).params
        one = pmc_update(p64, x, wt).params
        gap = max(float((getattr(got, f) - getattr(one, f)).abs().max())
                  for f in ("means", "cov", "weights", "dof"))
        require(gap <= 1e-12, "parallel: the all-reduced float64 update is %.3g off" % gap)
        res["pmc_update_gap"] = gap
        # one rank on all the data (float32 sums in another order; both
        # ranks run it at once on the shared card)
        vb_ref = GaussianInference(data, components=VB_K, weights=w, nu=VB_D + 1.0)
        times.append(("vb_iteration_no_mesh",
                      float(np.median(timed_vb_run(vb_ref, profiling)[1:])) / 1e3))
        n_gap = float(np.max(np.abs(vb_state["N_comp"] - vb_ref.N_comp.cpu().numpy())
                             / np.abs(vb_ref.N_comp.cpu().numpy())))
        b_gap = abs(vb_state["bound"] - vb_ref.likelihood_bound()) / abs(vb_ref.likelihood_bound())
        res.update(vb_N_comp_rel_gap=n_gap, vb_bound_rel_gap=b_gap)
        require(vb_state["K"] == vb_ref.K and n_gap <= 1e-5 and b_gap <= 1e-6,
                "parallel: VB on the mesh vs one rank: K %d/%d, N_comp %.3g, bound %.3g"
                % (vb_state["K"], vb_ref.K, n_gap, b_gap))
        del vb_ref
    res["times"] = times
    torch.distributed.destroy_process_group()
    print("PARALLEL_RESULT " + json.dumps(res), flush=True)
    return 0


def mesh_scan(mesh, params, target, out, stats):
    """The slice's steps with ``scan_steps=True`` on the mesh, twice (the
    warm-up chunk, then a capture and its replay), each bit for bit the
    loop's ``(out, stats)``; returns the scans' counts and warnings."""
    from pypmc_tpu_torch.parallel import pmc_run_sharded
    from pypmc_tpu_torch.parallel.sampler import clear_step_cache
    from pypmc_tpu_torch.sampler import _scan

    want = digest(out.means, out.cov, out.weights, out.dof, *stats)
    _scan.reset_counts()
    with scan_warnings() as warned:
        for _ in range(2):
            got, got_stats = pmc_run_sharded(target, params, N_SLICE, STEPS, mesh, key=0,
                                             scan_steps=True)
            require(digest(got.means, got.cov, got.weights, got.dof, *got_stats) == want,
                    "parallel: rank %d: pmc_run_sharded(scan_steps=True) differs from the loop"
                    % mesh.rank)
    clear_step_cache()
    return {"counts": dict(_scan.counts), "warnings": warned.messages}


def spawn_ranks(world, backend):
    """Run ``world`` ranks of :func:`parallel_worker` on card 0, each under
    its own time limit; kill every rank when one runs out, and fail unless
    every rank exits 0.  Returns the ranks' results; a failing rank's output
    ends the failure's message."""
    import os
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix="pypmc_parallel_") as shared:
        procs = [subprocess.Popen([sys.executable, script, "--parallel-worker", str(r),
                                  str(world), str(port), backend, shared],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        deadline = time.monotonic() + PARALLEL_TIMEOUT[world]
        outs, timed_out = [], False
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                timed_out = True
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
            outs.append(out)
        for q in procs:
            q.wait()
        run_dir = os.path.join(shared, "run")
        files = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else None
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [l for l in out.splitlines() if l.startswith("PARALLEL_RESULT ")]
        require(not timed_out, "parallel: %d ranks (%s) did not end within %d s; rank %d:\n%s"
                % (world, backend, PARALLEL_TIMEOUT[world], r, out[-2000:]))
        require(p.returncode == 0 and lines, "parallel: rank %d of %d (%s) exited %s:\n%s"
                % (r, world, backend, p.returncode, out[-3000:]))
        results.append(json.loads(lines[0][len("PARALLEL_RESULT "):]))
    if world > 1:
        results[0]["checkpoint_files"] = files
    return results


def phase_parallel(card):
    """(a) one process on the card in a one-rank NCCL group, (b) two ranks
    sharing card 0 over gloo; returns the launch counts summed over the
    ranks of both."""
    import torch

    torch.cuda.empty_cache()
    totals = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        results = spawn_ranks(world, backend)
        print("  (%s) %d rank%s over %s on cuda:0, %.1f s with the processes' start"
              % ("a" if world == 1 else "b", world, "s" if world > 1 else "", backend,
                 time.perf_counter() - t0))
        for res in results:
            t = {}
            for label, sec in res["times"]:
                t.setdefault(label, []).append(sec)
            print("  rank %d (%s): PMC %.3f ms a step, ParallelSampler.run %s ms, gather "
                  "%.3f s, VB %.3f ms an iteration (median after the first of %d; K=%d) [%s]"
                  % (res["rank"], res["backend"], t["pmc_step"][0] * 1e3 / STEPS,
                     [round(x * 1e3, 3) for x in t["sampler_run"]], t["gather"][0],
                     t["vb_iteration"][0] * 1e3, res["vb_iterations"], res["vb_K"], card))
            extra = ["%s %.3f ms" % (label, t[label][0] * 1e3 / (STEPS if "pmc" in label else 1))
                     for label in ("pmc_step_no_mesh", "vb_iteration_no_mesh", "all_reduce")
                     if label in t]
            print("    without the mesh (the same rank, after the run): %s" % "; ".join(extra))
            print("    PMC ESS %.4f, mode masses %s; sampler evidence %.6f; integrate D=40 %s"
                  % (res["ess"], np.round(res["masses"], 4).tolist(), res["evidence"],
                     json.dumps(res["integrate"])))
            print("    launch counts %s; kernels' tensors on %s"
                  % (json.dumps(res["counts"]), res["devices"]))
            scan = res["scan"]
            print("    scan_steps=True equal to the loop bit for bit, twice; scans %s%s"
                  % (json.dumps(scan["counts"]),
                     "; ..." + scan["warnings"][0][-220:] if scan["warnings"] else ""))
            if world > 1:
                require(scan["counts"]["uncapturable"] == 1 and scan["counts"]["replays"] == 0
                        and scan["counts"]["fallbacks"] > 0 and len(scan["warnings"]) == 1,
                        "parallel: rank %d's gloo scan did not fall back once, counted: %s"
                        % (res["rank"], scan))
            for key in ("pmc_update_gap", "vb_N_comp_rel_gap", "vb_bound_rel_gap",
                        "trace_kernels", "checkpoint_files"):
                if key in res:
                    print("    %s: %s" % (key, res[key]))
            for n, c in res["counts"].items():
                totals[n] = totals.get(n, 0) + c
        if world > 1:
            for key in ("pmc_digest", "gather_digest", "vb_digest", "integrate_digest"):
                require(len({res[key] for res in results}) == 1,
                        "parallel: the ranks' %s differ" % key)
            require(results[0]["scan"]["counts"] == results[1]["scan"]["counts"],
                    "parallel: the ranks' scans differ: %s" % [r["scan"] for r in results])
            print("  both ranks: the same adapted mixture, gathered runs, VB posterior and "
                  "integrate weights (sha256 %s)" % results[0]["pmc_digest"][:16])
            require(results[0].get("checkpoint_files") == [
                "mcmc.npz", "refined_mixture.npz", "vb1.npz", "vb1_mixture.npz"],
                "parallel: integrate's checkpoint files %s" % results[0].get("checkpoint_files"))
        else:
            require(results[0].get("bit_identical"), "parallel: (a) not bit-identical")
            print("  (a) pmc_run_sharded and GaussianInference with mesh=particle_mesh() equal "
                  "mesh=None bit for bit")
    return totals


# --------------------------------------------------------------------- #
# phase examples: examples_torch/ at the JAX examples' sizes            #
# --------------------------------------------------------------------- #

# the in-process runs: each example with the main() arguments beyond its
# defaults, which are the JAX examples' published sizes
EXAMPLE_RUNS = [("pmc_large_scale", []), ("pmc_large_scale", ["--components", "200"]),
                ("pmc_sharded", []), ("pmc", []), ("integrate_evidence", []),
                ("uniting_markov_chains_and_variational_bayes", []), ("variational", []),
                ("mixture_reduction", []), ("r_group", []), ("markov_chain", [])]
# the examples whose chains must run as CUDA graphs (sampler._scan)
GRAPH_EXAMPLES = ("markov_chain", "r_group", "uniting_markov_chains_and_variational_bayes")
# launch_2proc.py's arguments (Makefile's run-example-2proc)
EXAMPLE_2PROC = ["--particles", "100000", "--steps", "3"]
EXAMPLE_2PROC_TIMEOUT = 300     # seconds a rank may take


def example_module(name):
    """``examples_torch/<name>.py`` beside this script, as a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch",
                        name + ".py")
    spec = importlib.util.spec_from_file_location("examples_torch_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def temporary_working_directory():
    """The body of a ``with`` block in a fresh temporary directory (the
    examples write their plots to the working directory)."""
    import os
    import tempfile

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="pypmc_example_") as wd:
        os.chdir(wd)
        try:
            yield wd
        finally:
            os.chdir(cwd)


def record_launches(k, calls):
    """Patch ``k`` (the module) so that the arguments of the first launch
    of each shape are kept in ``calls``, ``{(kernel, shapes): arguments}``,
    as clones: ``fused_logq`` at its launch, where a call mapped with
    ``torch.func.vmap`` arrives with the batch folded into the particles,
    every other kernel at its wrapper.  Returns a function that undoes it."""
    import functools
    import inspect

    import torch

    def shape(v):
        if isinstance(v, torch.Tensor):
            return tuple(v.shape)
        if isinstance(v, k.MixtureOperands):
            return (v.K, v.dim, bool(v.student_t))
        return v

    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.detach().clone()
        if isinstance(v, k.MixtureOperands):
            return k.MixtureOperands(v.packed.detach().clone(), v.K, v.dim, v.student_t)
        return v

    def keep(name, arguments):
        if any(isinstance(v, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(v)
               for v in arguments.values()):
            return    # a call mapped with torch.func.vmap: fused_logq is kept at its launch
        key = (name,) + tuple((n, shape(v)) for n, v in arguments.items() if n != "seed")
        if key not in calls:
            calls[key] = {n: clone(v) for n, v in arguments.items()}

    launch = k._logq_launch

    def logq_launch(xT, packed, K, student_t):
        if not torch._C._functorch.is_functorch_wrapped_tensor(xT):
            keep("fused_logq", {"xT": xT, "ops": k.MixtureOperands(packed, K, xT.shape[0],
                                                                   student_t)})
        return launch(xT, packed, K, student_t)

    wrappers = k._WRAPPERS
    recorded = []
    for fn in wrappers:
        if fn.__name__ == "fused_logq":
            recorded.append(fn)
            continue
        signature = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*args, _fn=fn, _signature=signature, **kwargs):
            bound = _signature.bind(*args, **kwargs)
            bound.apply_defaults()
            keep(_fn.__name__, bound.arguments)
            return _fn(*args, **kwargs)
        # the launches count on the function that holds the module's name
        setattr(k, fn.__name__, wrapped)
        recorded.append(wrapped)
    k._WRAPPERS, k._logq_launch = tuple(recorded), logq_launch

    def undo():
        for fn in wrappers:
            setattr(k, fn.__name__, fn)
        k._WRAPPERS, k._logq_launch = wrappers, launch
    return undo


# the particles of an example's launch that replay_launch runs again
REPLAY_N = N_FLAGSHIP


def replay_launch(k, name, a, label, report):
    """Kernel ``name`` on an example's launch arguments ``a`` again, on at
    most REPLAY_N particles, against its float64 plain version on the same
    inputs (a draw: on its own particles, and the record kernel against the
    looped kernel bit for bit where the record kernel is elected; the pool:
    its final log-densities, and the last point its final state).  The
    statistics also admit F32_ERRORS times the float32 plain version's own
    error on the same inputs."""
    import torch
    from pypmc_tpu_torch.ops import _build

    def wide(ops):
        return None if ops is None else k.MixtureOperands(ops.packed.double(), ops.K, ops.dim,
                                                          ops.student_t)

    fn = getattr(k, name)
    plain = getattr(k, "plain_" + name[len("fused_"):], None)
    if "xT" in a:
        xT = a["xT"][:, :REPLAY_N].contiguous()
        x64, N = xT.double(), xT.shape[1]
    if "w" in a:
        w = a["w"][:REPLAY_N].contiguous()
    if name == "fused_logq":
        compare(label, fn(xT, a["ops"]), plain(x64, wide(a["ops"])), "log", report)
    elif name == "fused_maha":
        compare(label, fn(xT, a["a"], a["m"]), plain(x64, a["a"].double(), a["m"].double()),
                "maha", report)
    elif name == "fused_rho":
        for out, got, ref in zip(("rho", "log_q"), fn(xT, a["ops"]), plain(x64, wide(a["ops"]))):
            compare("%s %s" % (label, out), got, ref, "rho" if out == "rho" else "log", report)
    elif name in ("fused_vb_estep", "fused_vb_estep_blocked"):
        ops = (a["a"], a["m"], a["const"])
        got = fn(xT, w, *ops)
        ref = plain(x64, w.double(), *(t.double() for t in ops))
        ref32 = plain(xT, w, *ops)
        for out, g, r, r32 in zip(("N_comp", "sd", "g", "log_q_Z"), got, ref, ref32):
            compare("%s %s/N" % (label, out), g / N, r / N, "stats", report, r32 / N)
    elif name in ("fused_pmc_stats", "fused_pmc_stats_blocked"):
        check_stats(label, fn(xT, w, a["ops"], a["dof_stats"]),
                    plain(x64, w.double(), wide(a["ops"]), a["dof_stats"]), N, report,
                    plain(xT, w, a["ops"], a["dof_stats"]))
    elif name == "fused_propose_logq":
        ops, target, n = a["ops"], a["target"], min(a["n"], REPLAY_N)
        out = fn(a["seed"], ops, n, target)
        x64 = out[0].double()
        compare(label + " log_q", out[2], k.plain_logq(x64, wide(ops)), "log", report)
        if target is not None:
            compare(label + " log_p", out[3], k.plain_logq(x64, wide(target)), "log", report)
        if _build.propose_plan(ops.K, 0 if target is None else target.K, ops.dim)[0] == "rec":
            looped = fn(a["seed"], ops, n, target, variant="looped")
            differ = sum(int((p != q).sum()) for p, q in zip(out, looped))
            print("  %-34s %d of %d outputs differ" % (label + " rec vs looped", differ,
                                                       sum(t.numel() for t in out)))
            require(differ == 0, "%s: the record and the looped kernel differ in %d outputs"
                    % (label, differ))
    elif name in ("fused_is_pmc_step", "fused_is_pmc_step_blocked"):
        ops, target, n = a["ops"], a["target"], min(a["n"], REPLAY_N)
        xT, _, w, got = fn(a["seed"], ops, target, n, a["dof_stats"])
        x64 = xT.double()
        # the chunked plain versions: K reaches 200
        w_ref = torch.exp(k.plain_logq_blocked(x64, wide(target))
                          - k.plain_logq_blocked(x64, wide(ops)))
        compare(label + " w", w, w_ref, "w", report)
        check_stats(label, got, k.plain_pmc_stats_blocked(x64, w_ref, wide(ops),
                                                          a["dof_stats"], n_sw=3), n, report,
                    k.plain_pmc_stats_blocked(xT, w_ref.float(), ops, a["dof_stats"], n_sw=3))
    elif name == "solve_dofs":
        solve_dofs_check(label, a["const"], a["old_dofs"], a["steps"], a["mindof"], a["maxdof"],
                         report)
    elif name == "fused_transform":
        n = min(a["zT"].shape[1], REPLAY_N)
        zT, lat, sc = (a["zT"][:, :n].contiguous(), a["latent"][:n].contiguous(),
                       a["scale"][:n].contiguous())
        compare(label, fn(zT, lat, sc, a["ops"]),
                k.plain_transform(zT.double(), lat, sc.double(), wide(a["ops"])), "log", report)
    elif name == "fused_transform_rng":
        lat = a["latent"][:REPLAY_N].contiguous()
        out = fn(a["seed"], lat, a["ops"])
        require(bool(torch.isfinite(out).all()), "%s: non-finite particles" % label)
        if _build.transform_plan(a["ops"].K, a["ops"].dim, rng=True)[0] == "rec":
            differ = int((out != fn(a["seed"], lat, a["ops"], variant="looped")).sum())
            require(differ == 0, "%s: the record and the looped kernel differ in %d outputs"
                    % (label, differ))
    elif name == "draw_proposal_inputs":
        check_draw(label, *fn(a["seed"], a["cumw"], a["dof"], min(a["n"], REPLAY_N), a["D"],
                              a["normals"]), a["cumw"], a["dof"], report)
    elif name in FUSED_DRAWS:
        n = min(a["n"], REPLAY_N)
        out = fn(a["seed"], a["ops"], n)
        require(bool(torch.isfinite(out[0]).all()), "%s: non-finite particles" % label)
        differ = sum(int((p != q).sum()) for p, q in zip(out, two_launch_draw(name, a["ops"],
                                                                              a["seed"], n)))
        print("  %-34s %d of %d outputs differ from the two launches"
              % (label, differ, sum(t.numel() for t in out)))
        require(differ == 0, "%s: %d outputs differ from the two launches" % (label, differ))
    elif name == "fused_mcmc_pool":
        points, _, _, xf, ef = fn(a["seed"], a["x0T"], a["e0"], a["cholr"], a["dof_prop"],
                                  a["target"], a["n_steps"])
        require(bool(torch.equal(points[-1], xf)), "%s: last point != final state" % label)
        compare(label + " ef", ef, k.plain_logq(xf.double(), wide(a["target"])), "pool",
                report)
    else:
        raise SmokeFailure("%s: no replay of %s" % (label, name))


def describe_launch(key):
    """``K=.. Kt=.. D=.. N=..`` of a launch :func:`record_launches` kept."""
    shapes = dict(key[1:])
    if key[0] == "solve_dofs":
        return "K=%d steps=%d" % (shapes["const"][0], shapes["steps"])
    if key[0] == "draw_proposal_inputs":
        return "K=%d D=%d N=%d%s" % (shapes["cumw"][0], shapes["D"], shapes["n"],
                                     " normals" if shapes["normals"] else "")
    ops, target = shapes.get("ops"), shapes.get("target")
    # a mixture's shape is (K, D, Student-t); fused_maha's and the VB
    # E-step's operand a is (K, D, D)
    K, D = (ops or shapes.get("a") or (None, target[1]))[:2]
    parts = [] if K is None else ["K=%d" % K]
    if target:
        parts.append("Kt=%d" % target[0])
    parts.append("D=%d" % D)
    if "xT" in shapes:
        parts.append("N=%d" % shapes["xT"][1])
    elif "x0T" in shapes:
        parts.append("C=%d steps=%d" % (shapes["x0T"][1], shapes["n_steps"]))
    elif "latent" in shapes:
        parts.append("N=%d" % shapes["latent"][0])
    else:
        parts.append("N=%d" % shapes["n"])
    return " ".join(parts)


def run_example(k, name, argv, device, log_dir):
    """``main(argv + ["--device", device])`` of ``examples_torch/<name>.py``
    in a temporary working directory, its output written to ``log_dir``,
    between a reset and a read of the launch counts, with the devices of
    every kernel's tensors recorded and the arguments of a launch of each
    shape kept.  Returns ``(result, counts, seconds, devices, launches,
    scans)``, ``launches`` as :func:`record_launches` keeps them, ``scans``
    the chains' scan counts (``sampler._scan.counts``)."""
    import logging
    import os

    from pypmc_tpu_torch.sampler import _scan

    module = example_module(name)
    tag = "_".join([name] + [a.lstrip("-") for a in argv])
    names, wrappers = {fn.__name__: fn for fn in k._WRAPPERS}, k._WRAPPERS
    # float32 VB bounds drop at rounding level once converged, and run()
    # logs each drop: into the example's log, not stderr
    vb_log = logging.getLogger("pypmc_tpu_torch.mix_adapt.variational")
    launches = {}
    with open(os.path.join(log_dir, tag + ".log"), "w") as log:
        handler = logging.StreamHandler(log)
        vb_log.addHandler(handler)
        vb_log.propagate = False
        seen = watch_kernel_devices(k)
        undo = record_launches(k, launches)
        try:
            with temporary_working_directory(), contextlib.redirect_stdout(log):
                k.reset_launch_counts()
                _scan.reset_counts()
                t0 = time.perf_counter()
                result = module.main(argv + ["--device", str(device)])
                sync(device)
                seconds = time.perf_counter() - t0
                counts = k.launch_counts()
                scans = dict(_scan.counts)
        finally:
            undo()
            for fname, fn in names.items():
                setattr(k, fname, fn)
            k._WRAPPERS = wrappers
            vb_log.removeHandler(handler)
            vb_log.propagate = True
    return result, counts, seconds, seen, launches, scans


def gate_elects(k, kernel, K, D, Kt, rule):
    """Whether the size gate sends a (K, D) mixture (Kt target components)
    to ``kernel``: a K-blocked kernel where its dense twin's dispatch
    elects it for ``rule["n"]`` particles, any other where it fits."""
    if kernel.endswith("_blocked"):
        return k.elects_blocked(kernel[:-len("_blocked")], K, D, rule["n"], Kt)
    return k.fits(kernel, K, D, Kt, **rule)


def example_expectations(name, argv, out):
    """The expectations the JAX example prints, as checks on ``out``, the
    example's result; returns the key numbers to print and the dispatches
    of the example's path at its shapes, ``(kernel, K, D, Kt, rule)``: each
    must launch its kernel where the size gate elects it, and count its
    plain route where the gate refuses it."""
    from pypmc_tpu_torch.ops import kernels as k

    if name in ("pmc_large_scale", "pmc_sharded"):
        require(np.all(np.abs(np.array(out["masses"]) - [0.3, 0.7]) < 0.05),
                "%s %s: mode masses %s" % (name, argv, out["masses"]))
        numbers = "mode masses %s, ESS per step %s" % (
            np.round(out["masses"], 4).tolist(), np.round(out["ess"], 4).tolist())
        if name == "pmc_sharded":
            # 1001 particles a step: below 1024 the step draws with
            # fused_propose_logq and updates unfused (fused_rho), as the JAX
            # package's does
            n = out["n_total"] // out["ranks"]
            return numbers, [("fused_is_pmc_step", 3, 2, 2, {"n": n}),
                             ("fused_propose_logq", 3, 2, 2, {}),
                             ("fused_pmc_stats", 3, 2, 0, {"n": n}),
                             ("fused_rho", 3, 2, 0, {}), ("fused_logq", 3, 2, 0, {})]
        K = out["components"]
        numbers += ", step %.3f ms (median of %s ms, host clock, synchronized), digest %s" % (
            out["step_ms"], np.round(out["per_step_ms"], 3).tolist(), out["digest"])
        if k.fits("fused_is_pmc_step", K, 10, 2):
            step = ("fused_is_pmc_step", K, 10, 2, {})
        else:
            step = ("fused_is_pmc_step_blocked", K, 10, 2, {"n": out["n_total"]})
        return numbers, [step, ("fused_logq", K, 10, 0, {})]
    if name == "pmc":
        w = out["weights"]
        require(abs(w[0] - 0.3) < 0.05 and abs(w[1] - 0.7) < 0.05 and w[2] == 0.0,
                "pmc.py: final weights %s" % w)
        # each update on one run's 1000 samples: below 1024 the unfused
        # update (fused_rho), as the JAX package's
        return ("final weights %s" % np.round(w, 4).tolist(),
                [("fused_propose_logq", 3, 2, 0, {}), ("fused_logq", 2, 2, 0, {}),
                 ("fused_pmc_stats", 3, 2, 0, {"n": 1000}), ("fused_rho", 3, 2, 0, {})])
    if name == "integrate_evidence":
        require(abs(out["evidence"] - 1.0) < 0.01, "integrate_evidence.py: %s" % out)
        return ("evidence %.6f +- %.6f, ESS %.4f, final K %d, total %.2f s"
                % (out["evidence"], out["uncertainty"], out["ess"], out["K"], out["total_s"]),
                [("fused_mcmc_pool", 2, out["dim"], 0, {"n_steps": 300, "student_t": False}),
                 ("fused_logq", 2, out["dim"], 0, {}),
                 ("fused_propose_logq", out["K"], out["dim"], 0, {}),
                 ("fused_vb_estep", out["K"], out["dim"], 0, {}),
                 ("fused_pmc_stats", out["K"], out["dim"], 0, {})])
    if name == "uniting_markov_chains_and_variational_bayes":
        require(abs(out["integral"] - 1.0) < 0.01, "uniting: %s" % out)
        # VB on 10 chains x 19 cycles x 500 steps thinned by 100 (950 points)
        # and on 1000 importance samples: below the one-pass E-step's 1024
        return ("integral %.6f +- %.6f, perplexity %.4f, ESS %.4f, K %d/%d/%d (patches, VB, "
                "VB2), acceptance %.3f" % (out["integral"], out["uncertainty"],
                                           out["perplexity"], out["ess"], out["long_patches"],
                                           out["vb_K"], out["vb2_K"], out["accept_rate"]),
                [("fused_logq", 3, 2, 0, {}),
                 ("fused_vb_estep", out["long_patches"], 2, 0, {"n": 950}),
                 ("fused_vb_estep", out["vb_K"], 2, 0, {"n": 1000}),
                 ("fused_maha", out["long_patches"], 2, 0, {}),
                 ("fused_propose_logq", out["vb_K"], 2, 0, {}),
                 ("fused_propose_logq", out["vb2_K"], 2, 0, {})])
    if name == "variational":
        # 500 points: the E-step's statistics are direct sums over the data
        # (the JAX package's one-pass E-step runs from 1024), so the float32
        # fit repeats its bound exactly at its fixed point and converges
        require(len(out["mixture"]) == 2 and out["converged"] is not None,
                "variational.py: %d components (converged: %s)"
                % (len(out["mixture"]), out["converged"]))
        return ("converged after %s iterations, weights %s"
                % (out["converged"], np.round(np.sort(out["mixture"].weights), 4).tolist()),
                [("fused_vb_estep", 20, 2, 0, {"n": 500}), ("fused_maha", 20, 2, 0, {})])
    if name == "mixture_reduction":
        require(len(out["hierarchical"]) == 10 and out["hierarchical_steps"] is not None,
                "mixture_reduction.py: Hierarchical kept %d components"
                % len(out["hierarchical"]))
        return ("Hierarchical %s steps, %d components; VBMerge converged after %s, %d remain"
                % (out["hierarchical_steps"], len(out["hierarchical"]), out["vb_converged"],
                   len(out["vb_mixture"])), [("fused_maha", 10, 2, 0, {})])
    if name == "r_group":
        require(out["groups"] == [[0, 1], [2, 3, 4]], "r_group.py: groups %s" % out["groups"])
        return ("groups %s, %d long patches, %d chain steps, %.1f us a step (host clock)"
                % (out["groups"], len(out["mixture"]), out["chain_steps"], out["us_per_step"]),
                [("fused_logq", 2, 2, 0, {})])
    if name == "markov_chain":
        require(np.all(np.abs(np.array(out["mean"]) - [4.3, 1.1]) < 0.05),
                "markov_chain.py: sample mean %s" % out["mean"])
        return ("sample mean %s, acceptance %.4f, %d chain steps, %.1f us a step (host clock)"
                % (np.round(out["mean"], 4).tolist(), out["accept_rate"], out["chain_steps"],
                   out["us_per_step"]), [])
    raise ValueError(name)


def compare_mixtures(label, got, ref, report):
    """Two host mixtures: the same number of components, and their weights,
    means and covariances within TOL["vb"]."""
    import torch

    require(len(got) == len(ref), "%s: %d components, the float64 CPU run %d"
            % (label, len(got), len(ref)))
    compare(label + " weights", torch.tensor(np.asarray(got.weights)),
            torch.tensor(np.asarray(ref.weights)), "vb", report)
    for f in ("mu", "sigma"):
        compare("%s %s" % (label, f), torch.tensor(np.stack([getattr(c, f) for c in got.components])),
                torch.tensor(np.stack([getattr(c, f) for c in ref.components])), "vb", report)


def examples_on_the_cpu(results, report):
    """Examples 7-8 are deterministic given their inputs: the variational
    fit of the card's data and the reductions of numpy's 400 components run
    again in float64 on the CPU (the plain versions), and the card's
    survivors, steps and parameters must agree with them."""
    import io

    import torch

    import pypmc_tpu_torch

    card = results["variational"]
    with pypmc_tpu_torch.using_device("cpu"), temporary_working_directory(), \
            contextlib.redirect_stdout(io.StringIO()):
        vb, converged = example_module("variational").fit(card["data"], 20, 100)
        reduction = example_module("mixture_reduction").main(["--device", "cpu"])
    compare_mixtures("examples/variational.py card vs CPU", card["mixture"], vb.make_mixture(),
                     report)
    card = results["mixture_reduction"]
    for steps in ("hierarchical_steps", "vb_converged"):
        require(card[steps] is not None and card[steps] == reduction[steps],
                "mixture_reduction.py: %s %s, %s on the CPU"
                % (steps, card[steps], reduction[steps]))
    compare_mixtures("examples/mixture_reduction.py Hierarchical card vs CPU",
                     card["hierarchical"], reduction["hierarchical"], report)
    compare_mixtures("examples/mixture_reduction.py VBMerge card vs CPU", card["vb_mixture"],
                     reduction["vb_mixture"], report)
    compare("examples/mixture_reduction.py VBMerge card vs CPU bound",
            torch.tensor(card["vb_bound"], dtype=torch.float64),
            torch.tensor(reduction["vb_bound"], dtype=torch.float64), "vb", report)
    print("  float64 CPU runs: variational.py %d components (converged after %s; the card's "
          "after %s), Hierarchical %s steps, VBMerge %d components (converged after %s); card "
          "and CPU agree (|card - CPU| <= %g + %g max|CPU|)"
          % (len(vb.make_mixture()), converged, results["variational"]["converged"],
             reduction["hierarchical_steps"], len(reduction["vb_mixture"]),
             reduction["vb_converged"], *TOL["vb"]))


def two_process_example(device, log_dir):
    """examples_torch/launch_2proc.py: two gloo ranks of pmc_large_scale.py
    sharing the card, each under a time limit; both must exit 0 with the
    same digest, on ``device``, with the step kernels launched.  Returns
    the launcher's result, the two ranks' launch counts summed and the
    seconds."""
    import os

    launcher = example_module("launch_2proc")
    launcher.TIMEOUT = EXAMPLE_2PROC_TIMEOUT
    t0 = time.perf_counter()
    with open(os.path.join(log_dir, "launch_2proc.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        out = launcher.main(EXAMPLE_2PROC + ["--device", str(device)])
    seconds = time.perf_counter() - t0
    require(out["ok"], "launch_2proc.py failed (return codes %s):\n%s"
            % (out["returncodes"], "\n".join(o[-2000:] for o in out["outputs"])))
    counts = {}
    for rank, text in enumerate(out["outputs"]):
        lines = dict(l.split(": ", 1) for l in text.splitlines()
                     if l.startswith(("mesh: ", "kernel launches: ")))
        require(lines.get("mesh", "").startswith("2 rank(s) on %s;" % device),
                "launch_2proc.py: rank %d ran on %s" % (rank, lines.get("mesh")))
        launched = json.loads(lines["kernel launches"])
        require(launched.get("fused_is_pmc_step", 0) > 0 and launched.get("fused_logq", 0) > 0,
                "launch_2proc.py: rank %d launched %s" % (rank, launched))
        for n, c in launched.items():
            counts[n] = counts.get(n, 0) + c
    return out, counts, seconds


def phase_examples(device, report, log_dir="build/examples"):
    """Every example of ``examples_torch/`` at the JAX examples' published
    sizes on the card, through its ``main()`` (launch_2proc.py's ranks as
    processes of their own): each example's expectations, the kernels the
    size gate elects at its shapes launched, every tensor a kernel took on
    ``device``, the first launch of each shape again against the plain
    version; examples 7-8 also against their float64 CPU runs.  Prints a
    line an example; returns the launch counts summed over the examples."""
    import io
    import logging
    import os

    import torch
    from pypmc_tpu_torch.ops import kernels as k

    os.makedirs(log_dir, exist_ok=True)
    chain_graph_cases(device)
    uncapturable_case(device)
    totals, results = {}, {}
    for name, argv in EXAMPLE_RUNS:
        torch.cuda.empty_cache()
        out, counts, seconds, seen, launches, scans = run_example(k, name, argv, device,
                                                                  log_dir)
        results[name if not argv else "%s %s" % (name, " ".join(argv))] = out
        numbers, elected = example_expectations(name, argv, out)
        launched = {n: c for n, c in counts.items() if c and not n.startswith("variant:")}
        title = " ".join([name + ".py"] + argv)
        print("  %s: %.2f s; %s; launches %s" % (title, seconds, numbers, json.dumps(launched)))
        if name in GRAPH_EXAMPLES:
            print("    chain scans %s" % json.dumps(scans))
            require(scans["replays"] > 0 and scans["fallbacks"] == 0
                    and scans["uncapturable"] == 0,
                    "%s: the chains did not run as CUDA graphs: %s" % (name, scans))
        if name == "r_group":
            # a launch a chain-step and one a chain's start, 5 chains
            require(counts["fused_logq"] == out["chain_steps"] + 5,
                    "r_group.py: %d fused_logq launches for %d chain-steps of 5 chains"
                    % (counts["fused_logq"], out["chain_steps"]))
        if name == "pmc_large_scale":
            require(counts["solve_dofs"] == counts["fused_is_pmc_step"]
                    + counts["fused_is_pmc_step_blocked"],
                    "%s: %d solve_dofs launches for %d Student-t steps"
                    % (title, counts["solve_dofs"], counts["fused_is_pmc_step"]
                       + counts["fused_is_pmc_step_blocked"]))
        # a launch of each shape again, against the plain version
        for key, arguments in launches.items():
            replay_launch(k, key[0], arguments, "%s %s %s" % (key[0], title,
                                                               describe_launch(key)), report)
        del launches
        for kernel, K, D, Kt, rule in elected:
            if gate_elects(k, kernel, K, D, Kt, rule):
                require(counts[kernel] > 0, "%s %s: %s (elected at K=%d, D=%d, Kt=%d) was not "
                        "launched: %s" % (name, argv, kernel, K, D, Kt, launched))
            else:
                # a K-blocked kernel's refusal counts on its dense twin's route
                require(counts["plain:" + kernel.replace("_blocked", "")] > 0,
                        "%s %s: the gate refuses %s at K=%d, D=%d, Kt=%d, and no plain "
                        "route was counted: %s" % (name, argv, kernel, K, D, Kt, launched))
        require(seen <= {str(device)}
                and bool(seen) == any(counts[fn.__name__] for fn in k._WRAPPERS),
                "%s: kernels took tensors on %s" % (name, sorted(seen)))
        for n, c in counts.items():
            totals[n] = totals.get(n, 0) + c
    examples_on_the_cpu(results, report)
    # (its run logs each drop of the bound; not to stderr)
    vb_log = logging.getLogger("pypmc_tpu_torch.mix_adapt.variational")
    level = vb_log.level
    vb_log.setLevel(logging.ERROR)
    try:
        with min_n(k, 0), contextlib.redirect_stdout(io.StringIO()):
            _, before = example_module("variational").fit(results["variational"]["data"], 20,
                                                          100)
    finally:
        vb_log.setLevel(level)
    print("  variational.py converged after %s iterations; with the route before the float32 "
          "stopping rule's repair (the one-pass E-step below 1024 points): %s"
          % (results["variational"]["converged"], before))

    torch.cuda.empty_cache()
    out, counts, seconds = two_process_example(device, log_dir)
    print("  launch_2proc.py %s: %.2f s with the processes' start; both ranks %s; launches "
          "of the two ranks %s" % (" ".join(EXAMPLE_2PROC), seconds, out["digests"][0],
                                   json.dumps(counts)))
    for n, c in counts.items():
        totals[n] = totals.get(n, 0) + c
    return totals


# --------------------------------------------------------------------- #
# phase 12: times                                                       #
# --------------------------------------------------------------------- #

def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds of fn(i) over ``reps`` calls, CUDA events; each
    call gets its own index (distinct seeds)."""
    import torch

    for i in range(warmup):
        fn(10_000 + i)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def blocked_splits():
    """``[[kernel, N, {launch: device ms}], ...]``: :func:`launch_split` of
    the three K-blocked kernels at phase times' shapes (the K=400, D=2
    Student-t statistics and VB E-step at N=2^22, the K=200, D=10 step at
    2^22 and 10^7), and of solve_dofs' two kernels at ``SOLVE_DOFS_K`` (as
    ``["solve_dofs_<variant>", K, ...]``, 20 launches a profiled run)."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    device = torch.device("cuda", 0)
    bparams, bx, bw = blocked_stats_problem(device, True, N_PLAIN_MAX)
    bops = core._kernel_operands(bparams)
    vdata, vw = vb_problem(device, N_PLAIN_MAX, 400, 2)
    vx = vdata.T.contiguous()
    A4, m4, c4 = vb_operands(make_params(random_mixture(np.random.default_rng(4), 400, 2, False),
                                         device))
    sparams, starget, _ = flagship_problem(device, K=200)
    sops, stops = core._kernel_operands(sparams), core._kernel_operands(starget)
    out = [["fused_pmc_stats_blocked", N_PLAIN_MAX, launch_split(
                "fused_pmc_stats_blocked K=400 D=2 N=%d" % N_PLAIN_MAX,
                lambda i: k.fused_pmc_stats_blocked(bx, bw, bops, True),
                ("logq_kernel<", "blocked_reg_stats_kernel<", "reduce_partials<"))],
           ["fused_vb_estep_blocked", N_PLAIN_MAX, launch_split(
                "fused_vb_estep_blocked K=400 D=2 N=%d" % N_PLAIN_MAX,
                lambda i: k.fused_vb_estep_blocked(vx, vw, A4, m4, c4),
                ("vb_lse_kernel<", "blocked_reg_stats_kernel<", "reduce_partials<"))]]
    for n in (N_PLAIN_MAX, N_SLICE):
        out.append(["fused_is_pmc_step_blocked", n, launch_split(
            "fused_is_pmc_step_blocked K=200 D=10 N=%d" % n,
            lambda i: k.fused_is_pmc_step_blocked((i, 5), sops, stops, n, True),
            ("step_draw_kernel<", "blocked_reg_stats_kernel<", "reduce_partials<"))])
    for K in SOLVE_DOFS_K:
        c, old = dof_problem(K, K, device, torch.float32)
        for variant in ("warp", "serial"):
            out.append(["solve_dofs_" + variant, K, launch_split(
                "solve_dofs %s K=%d" % (variant, K),
                lambda i: k.solve_dofs(c, old, DOF_STEPS, MINDOF, MAXDOF, variant),
                ("solve_dofs_%s_kernel<" % variant,), reps=20)])
    return out


def blocked_splits_in_a_fresh_process(timeout=600):
    """:func:`blocked_splits` in a new process (``chip_smoke.py
    --blocked-splits``), whose profiler no earlier session has used: in the
    script's own process, after the phases before it, the profiler has
    dropped the first launch of ``fused_pmc_stats_blocked`` from every
    retry.  Its lines are printed here."""
    import os

    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--blocked-splits"],
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith("  launches of "):
            print(line)
    found = [l for l in lines if l.startswith("BLOCKED_SPLITS ")]
    require(proc.returncode == 0 and found, "the K-blocked launch splits failed (exit %s):\n%s"
            % (proc.returncode, (proc.stdout + proc.stderr)[-3000:]))
    return json.loads(found[0][len("BLOCKED_SPLITS "):])


def launch_split(label, fn, expect, reps=3, tries=4):
    """Device time of each launch of one kernel call (torch.profiler device
    events, a call's mean over ``reps`` after a warm-up): the K-blocked
    kernels' first pass, statistics pass and reduction.  The profiler may
    drop a kernel's events from a run; the run is profiled again, up to
    ``tries`` times, until every kernel named in ``expect`` (prefixes) has
    a row, and fails if one never does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(100)
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        split = {}
        # a launch's mean over the events recorded
        for ms, count, key in device_rows(prof, reps):
            key = key.replace("(anonymous namespace)::", "").replace("void ", "")
            if "pmc::" in key:
                split[key.split("(")[0].replace("pmc::", "")] = ms / count
        missing = [e for e in expect if not any(key.startswith(e) for key in split)]
        print("  launches of %s (profiled run %d): %s%s"
              % (label, attempt, "; ".join("%s %.3f ms" % kv for kv in split.items()),
                 "; no event of %s" % ", ".join(missing) if missing else ""))
        if not missing:
            return split
    raise SmokeFailure("%s: the profiler recorded no event of %s in %d runs"
                       % (label, ", ".join(missing), tries))


def phase_times(device, report):
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    params, target, _ = flagship_problem(device)
    ops, tops = core._kernel_operands(params), core._kernel_operands(target)
    times = {}
    clock = [time.perf_counter()]

    def part(title):
        """Print the seconds since the last part's end."""
        now = time.perf_counter()
        print("  times part %s: %.1f s" % (title, now - clock[0]))
        clock[0] = now

    def pair(name, kernel, plain, sizes):
        for n in sizes:
            times[(name, n, "cuda")] = cuda_ms(lambda i: kernel(i, n))
        times[(name, N_PLAIN_MAX, "plain")] = cuda_ms(lambda i: plain(i, N_PLAIN_MAX), reps=3, warmup=1)

    xs, ws = {}, {}
    for n in (N_PLAIN_MAX, N_SLICE):
        xs[n], _, log_q, log_p = k.fused_propose_logq((7, 7), ops, n, tops)
        ws[n] = torch.exp(log_p - log_q)
    pair("fused_logq", lambda i, n: k.fused_logq(xs[n], ops),
         lambda i, n: k.plain_logq(xs[n], ops), (N_PLAIN_MAX, N_SLICE))
    pair("fused_pmc_stats", lambda i, n: k.fused_pmc_stats(xs[n], ws[n], ops, True),
         lambda i, n: k.plain_pmc_stats(xs[n], ws[n], ops, True), (N_PLAIN_MAX, N_SLICE))
    A, m, const = vb_operands(params)
    pair("fused_maha", lambda i, n: k.fused_maha(xs[n], A, m),
         lambda i, n: k.plain_maha(xs[n], A, m), (N_PLAIN_MAX, N_SLICE))
    pair("fused_rho", lambda i, n: k.fused_rho(xs[n], ops),
         lambda i, n: k.plain_rho(xs[n], ops), (N_PLAIN_MAX, N_SLICE))
    pair("fused_vb_estep", lambda i, n: k.fused_vb_estep(xs[n], ws[n], A, m, const),
         lambda i, n: k.plain_vb_estep(xs[n], ws[n], A, m, const), (N_PLAIN_MAX, N_SLICE))
    # the entry-table pass at the same shapes: the yardstick of the election
    for n in (N_PLAIN_MAX, N_SLICE):
        times[("fused_vb_estep", n, "table")] = cuda_ms(
            lambda i: k.fused_vb_estep(xs[n], ws[n], A, m, const, variant="table"))
        times[("fused_pmc_stats", n, "table")] = cuda_ms(
            lambda i: k.fused_pmc_stats(xs[n], ws[n], ops, True, variant="table"))
    del xs, ws, log_q, log_p
    torch.cuda.empty_cache()
    part("flagship evaluations and statistics")
    # fused_maha and fused_logq at the shapes the main paths give them, each
    # also held to its plain version there
    for name, shapes in MAIN_SHAPES.items():
        for shape in shapes:
            for route, ms in main_shape_ms(device, name, shape, report).items():
                times[(name, shape, route)] = ms
            torch.cuda.empty_cache()
    for shape in POOL_SHAPES:
        for route, ms in pool_shape_ms(device, shape).items():
            times[("fused_mcmc_pool", shape, route)] = ms
    part("main shapes and pools")
    for name, (ms, plain_ms) in wide_shape_ms(device).items():
        times[(name, WIDE_SHAPE, "cuda")], times[(name, WIDE_SHAPE, "plain")] = ms, plain_ms
    torch.cuda.empty_cache()
    part("wide shape")
    # past D = 64 every TILED_TIMED kernel held to float64; fused_logq's and
    # fused_rho's kernels timed (the others' A/Bs: --tiled-times)
    for shape in TILED_SHAPES:
        for (name, route), ms in tiled_shape_ms(device, shape, TILED_DEFAULT).items():
            times[(name, shape, route)] = ms
        torch.cuda.empty_cache()
    part("tiled shapes")
    pair("fused_propose_logq", lambda i, n: k.fused_propose_logq((i, 1), ops, n, tops),
         lambda i, n: k.plain_propose_logq((i, 1), ops, n, tops),
         (N_PLAIN_MAX, N_SLICE, N_BENCH))
    times[("fused_propose_logq", N_PLAIN_MAX, "looped")] = cuda_ms(
        lambda i: k.fused_propose_logq((i, 1), ops, N_PLAIN_MAX, tops, variant="looped"))
    torch.cuda.empty_cache()
    pair("fused_is_pmc_step", lambda i, n: k.fused_is_pmc_step((i, 2), ops, tops, n, True),
         lambda i, n: k.plain_is_pmc_step((i, 2), ops, tops, n, True),
         (N_PLAIN_MAX, N_SLICE))
    for n in (N_PLAIN_MAX, N_SLICE):
        times[("fused_is_pmc_step", n, "table")] = cuda_ms(
            lambda i: k.fused_is_pmc_step((i, 2), ops, tops, n, True, variant="table"))
    for name in _build._DENSE:
        for n in (N_PLAIN_MAX, N_SLICE):
            print("  %s K=10 D=10 N=%d: the %s pass (elected) %.3f ms, the entry table %.3f ms, "
                  "bound %.3f ms" % (name, n, _build.dense_plan(name, 10, 10, 2)[0],
                                     times[(name, n, "cuda")], times[(name, n, "table")],
                                     bound(name, (10, 2, 10, n))[1]))
    torch.cuda.empty_cache()
    part("flagship draws and step")
    # rows 7-9 past D = 16: the Gram pass held to float64 (its times beside
    # the entry table's: --gram-times)
    for shape in GRAM_TIME_SHAPES:
        times.update(table_shape_ms(device, shape, timed=False))
        torch.cuda.empty_cache()
    part("gram shapes (checks)")

    # the transforms on the flagship proposal: normals, components and
    # Student-t scales as propose_T draws them
    gen = torch.Generator(device=device).manual_seed(9)
    latent = component_draw(params, N_PLAIN_MAX, 9)
    zT = torch.randn((params.dim, N_PLAIN_MAX), generator=gen, device=device)
    from pypmc_tpu_torch.ops.random import student_t_scale
    scale = student_t_scale(gen, params.dof[latent.long()], (N_PLAIN_MAX,))
    pair("fused_transform", lambda i, n: k.fused_transform(zT, latent, scale, ops),
         lambda i, n: k.plain_transform(zT, latent, scale, ops), (N_PLAIN_MAX,))
    times[("fused_transform", N_PLAIN_MAX, "looped")] = cuda_ms(
        lambda i: k.fused_transform(zT, latent, scale, ops, variant="looped"))
    print("  fused_transform K=10 D=10 N=%d: the %s kernel (elected) %.3f ms, the looped "
          "kernel %.3f ms, bound %.3f ms"
          % (N_PLAIN_MAX, _build.transform_plan(10, 10)[0],
             times[("fused_transform", N_PLAIN_MAX, "cuda")],
             times[("fused_transform", N_PLAIN_MAX, "looped")],
             bound("fused_transform", (10, 0, 10, N_PLAIN_MAX))[1]))
    pair("fused_transform_rng", lambda i, n: k.fused_transform_rng((i, 3), latent, ops),
         lambda i, n: k.plain_transform_rng((i, 3), latent, ops), (N_PLAIN_MAX,))
    times[("fused_transform_rng", N_PLAIN_MAX, "looped")] = cuda_ms(
        lambda i: k.fused_transform_rng((i, 3), latent, ops, variant="looped"))
    # the words from a seed tensor on the card, as a replayed step gives them
    seed_row = torch.tensor((1, 3), dtype=torch.int64, device=device)
    times[("fused_transform_rng", N_PLAIN_MAX, "pointer")] = cuda_ms(
        lambda i: k.fused_transform_rng(seed_row, latent, ops))
    for name in ("fused_propose_logq", "fused_transform_rng"):
        print("  %s K=10 Kt=2 D=10 N=%d: the %s kernel (elected) %.3f ms, the looped kernel "
              "%.3f ms, bound %.3f ms"
              % (name, N_PLAIN_MAX, _build.draw_plan(name, 10, 10, 2)[0],
                 times[(name, N_PLAIN_MAX, "cuda")], times[(name, N_PLAIN_MAX, "looped")],
                 bound(name, (10, 2, 10, N_PLAIN_MAX))[1]))
    del zT, latent, scale
    torch.cuda.empty_cache()
    part("transforms")

    # the pool at benchmarks/mcmc_chains.py's fused configuration, one cycle
    ptarget, starts, sigma0, _ = mcmc_problem(device)
    pops = core._kernel_operands(ptarget)
    x0T = torch.tensor(starts.T.copy(), device=device)
    e0 = k.fused_logq(x0T, pops)
    chol = torch.linalg.cholesky(torch.tensor(sigma0, device=device))
    cholr = chol.reshape(-1, 1).expand(-1, MCMC_C).contiguous()
    times[("fused_mcmc_pool", MCMC_C, "cuda")] = cuda_ms(
        lambda i: k.fused_mcmc_pool((i, 4), x0T, e0, cholr, None, pops, MCMC_STEPS), reps=5)
    times[("fused_mcmc_pool", MCMC_C, "plain")] = cuda_ms(
        lambda i: k.plain_mcmc_pool((i, 4), x0T, e0, cholr, None, pops, MCMC_STEPS),
        reps=2, warmup=1)
    del x0T, e0, cholr
    torch.cuda.empty_cache()

    # the K-blocked kernels at their slice shapes (kernel_work): the K=400,
    # D=2 Student-t statistics and VB E-step, the K=200, D=10 step
    bparams, bx, bw = blocked_stats_problem(device, True, N_PLAIN_MAX)
    bops = core._kernel_operands(bparams)
    pair("fused_pmc_stats_blocked", lambda i, n: k.fused_pmc_stats_blocked(bx, bw, bops, True),
         lambda i, n: k.plain_pmc_stats_blocked(bx, bw, bops, True), (N_PLAIN_MAX,))
    vdata, vw = vb_problem(device, N_PLAIN_MAX, 400, 2)
    vx = vdata.T.contiguous()
    A4, m4, c4 = vb_operands(make_params(random_mixture(np.random.default_rng(4), 400, 2, False),
                                         device))
    pair("fused_vb_estep_blocked", lambda i, n: k.fused_vb_estep_blocked(vx, vw, A4, m4, c4),
         lambda i, n: k.plain_vb_estep_blocked(vx, vw, A4, m4, c4), (N_PLAIN_MAX,))
    del bx, bw, vdata, vx, vw
    torch.cuda.empty_cache()
    sparams, starget, _ = flagship_problem(device, K=200)
    sops, stops = core._kernel_operands(sparams), core._kernel_operands(starget)
    pair("fused_is_pmc_step_blocked",
         lambda i, n: k.fused_is_pmc_step_blocked((i, 2), sops, stops, n, True),
         lambda i, n: k.plain_is_pmc_step_blocked((i, 2), sops, stops, n, True),
         (N_PLAIN_MAX, N_SLICE))
    del sops, stops
    torch.cuda.empty_cache()
    part("pool and K-blocked kernels")
    for K in SOLVE_DOFS_K:
        c, old = dof_problem(K, K, device, torch.float32)
        for variant, route in (("warp", "cuda"), ("serial", "serial")):
            times[("solve_dofs", K, route)] = cuda_ms(
                lambda i: k.solve_dofs(c, old, DOF_STEPS, MINDOF, MAXDOF, variant), reps=50)
        times[("solve_dofs", K, "plain")] = cuda_ms(
            lambda i: k.plain_solve_dofs(c, old, DOF_STEPS, MINDOF, MAXDOF), reps=5)
        serial = solve_dofs_work(c, DOF_STEPS, max_sm_clock_ghz())[2]
        print("  solve_dofs K=%d: serial-latency model (not measured; %d clocks a condition, "
              "%d a unit of nu/2 below 10, at the largest SM clock) %.4f ms"
              % (K, DOF_CONDITION_CLOCKS, DOF_UNIT_CLOCKS, serial))
    for name, n, split in blocked_splits_in_a_fresh_process():
        if name.startswith("solve_dofs_"):
            # solve_dofs' device time a launch, by variant
            route = "device" if name == "solve_dofs_warp" else "serial_device"
            times[("solve_dofs", n, route)] = list(split.values())[0]
            continue
        times[(name, n, "split")] = split
    part("solve_dofs and launch splits")
    times.update(draw_times(device))
    times.update(fused_draw_times(device))
    part("draws")
    for (name, n, route), ms in times.items():
        if route != "split":
            size = (bound(name, n)[0] if isinstance(n, tuple)
                    else ("K=%d" if name == "solve_dofs" else "N=%d") % n)
            print("  %-25s %-6s %-30s %9.3f ms" % (name, route, size, ms))
    return times


# the shape (K, Kt, D, N) the main path gives draw_proposal_inputs: the D=40
# pipeline's PMC draws (K=32 Student-t, n_is1 = 2^20 particles)
DRAW_SHAPE = (32, 0, 40, N_FLAGSHIP)


def draw_times(device):
    """draw_proposal_inputs at DRAW_SHAPE (pmc_stage_problem's proposal),
    CUDA events: the kernel with the normals and scales (``cuda``, float32;
    ``cuda64``, float64), with the components only (``components``), and
    its plain version, the eager torch.rand, torch.randn and chi-square the
    kernel replaced (``plain``, ``plain64``)."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    K, _, D, N = DRAW_SHAPE
    params, _ = pmc_stage_problem(device)
    times = {}
    for dtype, suffix in ((torch.float32, ""), (torch.float64, "64")):
        p = params.to(dtype=dtype)
        cumw, dof = core._cumulative_weights(p.weights).contiguous(), p.dof.contiguous()
        times[("draw_proposal_inputs", DRAW_SHAPE, "cuda" + suffix)] = cuda_ms(
            lambda i: k.draw_proposal_inputs((i, 5), cumw, dof, N, D, True), reps=20)
        times[("draw_proposal_inputs", DRAW_SHAPE, "plain" + suffix)] = cuda_ms(
            lambda i: k.plain_draw_proposal_inputs((i, 5), cumw, dof, N, D, True), reps=5)
        if not suffix:
            times[("draw_proposal_inputs", DRAW_SHAPE, "components")] = cuda_ms(
                lambda i: k.draw_proposal_inputs((i, 5), cumw, dof, N, D, False), reps=20)
    torch.cuda.empty_cache()
    return times


def draw_entry(src, replaces, checks, counts, example_counts, times):
    """The kernels JSON's entry of draw_proposal_inputs: its times at
    DRAW_SHAPE (:func:`draw_times`), float32 the main one, beside the bytes
    it writes over the memory rate (float64: twice the normals' and
    scales' bytes)."""
    name = "draw_proposal_inputs"
    shape, bound_ms, bound_by = bound(name, DRAW_SHAPE)
    K, _, D, N = DRAW_SHAPE
    worst = max(checks, key=lambda r: r["max_abs_err"] / r["tol"])
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": worst["max_abs_err"],
            "ms": times[(name, DRAW_SHAPE, "cuda")], "plain_ms": times[(name, DRAW_SHAPE, "plain")],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape + " Student-t float32, normals and scales",
            "max_abs_err_tol": worst["tol"], "max_abs_err_output": worst["output"],
            "launches_examples": example_counts.get(name, 0),
            "shapes": [{"shape": shape + " float64", "ms": times[(name, DRAW_SHAPE, "cuda64")],
                        "plain_ms": times[(name, DRAW_SHAPE, "plain64")],
                        "bound_ms": (4 + 8 * (D + 1)) * N / PEAK_BYTES * 1e3},
                       {"shape": shape + " the components only",
                        "ms": times[(name, DRAW_SHAPE, "components")],
                        "bound_ms": (4 * N + 4 * K) / PEAK_BYTES * 1e3}]}


# the shapes (K, Kt, D, N) of the fused draws' routes: fused_draw_transform
# at the D=40 pipeline's PMC draws (DRAW_SHAPE), fused_draw_transform_rng at
# the flagship's K=10 Student-t proposal, D=10, 2^22 particles; both are
# timed at these and at the routes' K=11, D=40, 2^20
FUSED_DRAW_SHAPES = {"fused_draw_transform": DRAW_SHAPE,
                     "fused_draw_transform_rng": (10, 0, 10, N_PLAIN_MAX)}
FUSED_TIME_SHAPES = (DRAW_SHAPE, (11, 0, 40, N_FLAGSHIP), (10, 0, 10, N_PLAIN_MAX))


def fused_draw_times(device):
    """Both fused draws at the FUSED_TIME_SHAPES (the D=40 pipeline's K=32
    Student-t proposal, a K=11 Student-t one at D=40, the flagship's), CUDA
    events, in turns (one launch, two launches, one launch), each beside the
    two launches it replaces (``two``: draw_proposal_inputs, then
    fused_transform or fused_transform_rng), with the seed words read from a
    tensor (``pointer``), and at its own shape its plain version."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    problems = {DRAW_SHAPE: pmc_stage_problem(device)[0],
                FUSED_TIME_SHAPES[1]: make_params(random_mixture(
                    np.random.default_rng(51), 11, 40, True), device),
                FUSED_TIME_SHAPES[2]: flagship_problem(device)[0]}
    seed_row = torch.tensor((1, 5), dtype=torch.int64, device=device)
    times = {}
    for shape, params in problems.items():
        N = shape[3]
        ops = core._kernel_operands(params)
        for name in FUSED_DRAWS:
            fn = getattr(k, name)
            times[(name, shape, "cuda")] = cuda_ms(lambda i: fn((i, 5), ops, N), reps=20)
            times[(name, shape, "two")] = cuda_ms(
                lambda i: two_launch_draw(name, ops, (i, 5), N), reps=20)
            times[(name, shape, "cuda")] = (times[(name, shape, "cuda")] + cuda_ms(
                lambda i: fn((i, 5), ops, N), reps=20)) / 2       # kernel, two, kernel
            times[(name, shape, "pointer")] = cuda_ms(lambda i: fn(seed_row, ops, N), reps=20)
            if shape == FUSED_DRAW_SHAPES[name]:
                plain = getattr(k, "plain_" + name[len("fused_"):])
                times[(name, shape, "plain")] = cuda_ms(lambda i: plain((i, 5), ops, N), reps=3,
                                                        warmup=1)
            print("  %s %s: %.4f ms one launch (%.4f seed by pointer), %.4f ms the two launches "
                  "it replaces, bound %.4f ms" % (name, bound(name, shape)[0],
                                                  times[(name, shape, "cuda")],
                                                  times[(name, shape, "pointer")],
                                                  times[(name, shape, "two")],
                                                  bound(name, shape)[1]))
        torch.cuda.empty_cache()
    return times


# the instantiations whose SASS sets an issue floor (fused_draw_floor): a
# mangled-name part each, by (row, shape); the records staged, the seed by
# value, at D = DMAX = 40, where a particle runs the whole unrolled code
FLOOR_KERNELS = {
    ("fused_draw_transform", DRAW_SHAPE): "25draw_transform_rec_kernelILi40ELb1ELb0ELb0E",
    ("fused_draw_transform_rng", FUSED_TIME_SHAPES[1]):
        "25draw_transform_rec_kernelILi40ELb1ELb0ELb1E",
    ("fused_transform", DRAW_SHAPE): "20transform_rec_kernelILi40ELb1E",
    ("fused_transform_rng", FUSED_TIME_SHAPES[1]): "24transform_rng_rec_kernelILi40ELb1ELb0E",
    ("fused_propose_logq", (9, 2, 40, N_FLAGSHIP)): "23propose_logq_rec_kernelILi40ELb1ELb0E",
    ("draw_proposal_inputs", DRAW_SHAPE): "11draw_kernelIfLb0E",
}


def sass_instructions(parts):
    """``{part: instructions}``: the SASS instructions (NOPs not counted) of
    the one kernel of the built library whose mangled name holds each part
    (``cuobjdump -sass``).  A kernel's code is counted once: a loop's body
    once, whatever its trips."""
    return {part: sum(ops.values()) for part, ops in sass_opcodes(parts).items()}


def sass_opcodes(parts):
    """``{part: {opcode: instructions}}``, as :func:`sass_instructions`
    counts them."""
    import shutil

    from pypmc_tpu_torch.ops import _build

    path = _build.build_info["path"]
    log = _build.build_info.get("log") or open(path[:-len(".so")] + ".log").read()
    entries = set(re.findall(r"Compiling entry function '([^']+)'", log))
    names = {}
    for part in parts:
        hits = sorted(e for e in entries if part in e)
        require(len(hits) == 1, "sass: %d kernels named like %s" % (len(hits), part))
        names[hits[0]] = part
    # the whole library's SASS, streamed: cuobjdump's --function did not
    # match these kernels' names
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    t0 = time.perf_counter()
    counts, current = {}, None
    with subprocess.Popen([cuobjdump, "-sass", path], stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            head = "Function : " in line and re.match(r"\s*Function : (\S+)", line)
            if head:
                current = names.get(head.group(1))
                if current is not None:
                    counts[current] = {}
                continue
            if current is None:
                continue
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(\S+)", line)
            if op and op.group(1) != "NOP":
                name = op.group(1).rstrip(";").split(".")[0]
                counts[current][name] = counts[current].get(name, 0) + 1
    require(proc.returncode == 0 and len(counts) == len(parts),
            "sass: cuobjdump exit %s, counted %s of %s" % (proc.returncode, sorted(counts), parts))
    print("  sass: %d kernels counted in %.1f s" % (len(counts), time.perf_counter() - t0))
    return counts


def fused_draw_floor(device):
    """``{(row, shape): (SASS instructions, issue floor ms)}`` of the
    FLOOR_KERNELS instantiations: a warp issues one instruction for its 32
    particles, an SM 4 a clock at the card's largest SM clock, so that the
    least time for N particles is N / 32 x instructions / (4 x SMs x
    clock).  At D = DMAX the record kernels' particle bodies are unrolled
    and run whole (their counts are near a particle's; the thresholds'
    compare loop and the chi-square's rounds counted once); draw_kernel's
    normals loop and fused_propose_logq's loop over the components are
    counted once, so theirs are lower bounds of a particle's.  Below DMAX
    (D=10 on the DMAX 16 code) a particle skips rows of the code: no floor
    is taken there."""
    import torch

    counts = sass_instructions(list(FLOOR_KERNELS.values()))
    clock = max_sm_clock_ghz() * 1e9
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for key, part in FLOOR_KERNELS.items():
        N = key[1][3]
        floor = N / 32 * counts[part] / (4 * n_sm * clock) * 1e3
        out[key] = (counts[part], floor)
        print("  issue floor %-24s %-26s %6d SASS instructions (%s): %.4f ms at %d SMs x %.3f GHz"
              % (key[0], bound(key[0], key[1])[0], counts[part], part, floor, n_sm, clock / 1e9))
    # the draw's floor past D = 64: the record draw's instructions a normal
    # at D = DMAX = 40 (fused_transform_rng's record kernel less
    # fused_transform's, which loads z: its normals and chi-square), for the
    # D normals of each of WIDE_SHAPE's particles
    per_normal = (counts[FLOOR_KERNELS[("fused_transform_rng", FUSED_TIME_SHAPES[1])]]
                  - counts[FLOOR_KERNELS[("fused_transform", DRAW_SHAPE)]]) / 40
    D, N = WIDE_SHAPE[2], WIDE_SHAPE[3]
    floor = N / 32 * D * per_normal / (4 * n_sm * clock) * 1e3
    out[("drawn", WIDE_SHAPE)] = (per_normal, floor)
    print("  issue floor of the draw at %s: %.1f SASS instructions a normal (the record "
          "draws' at D=40), %.4f ms" % (bound("fused_transform_rng", WIDE_SHAPE)[0], per_normal,
                                         floor))
    return out


def fused_draw_entry(name, src, replaces, checks, counts, example_counts, times, floors):
    """The kernels JSON's entry of a fused draw: at its FUSED_DRAW_SHAPES
    shape and at the other FUSED_TIME_SHAPES, its time beside the two launches it replaces
    (``two_launch_ms``, the same call), its bytes bound and its issue floor
    (fused_draw_floor); max_abs_err the largest |fused - two launches| of
    the bit-equality checks (0 where they hold)."""
    own = FUSED_DRAW_SHAPES[name]
    bits = [r for r in checks if "differ" in r]
    require(bits, "%s: no check against the two launches" % name)
    worst = max(bits, key=lambda r: r["max_abs_err"])

    def row(shape):
        sh, bound_ms, bound_by = bound(name, shape)
        out = {"shape": sh + " Student-t", "ms": times[(name, shape, "cuda")],
               "two_launch_ms": times[(name, shape, "two")],
               "pointer_ms": times[(name, shape, "pointer")], "bound_ms": bound_ms,
               "bound_by": bound_by}
        if (name, shape) in floors:
            out.update(sass_instructions=floors[(name, shape)][0],
                       issue_floor_ms=floors[(name, shape)][1])
        return out

    main = row(own)
    return dict(main, name=name, route="cuda", source=src, replaces=replaces, fuses=FUSES[name],
                launches=counts[name], max_abs_err=worst["max_abs_err"],
                plain_ms=times[(name, own, "plain")], library_ms=None,
                max_abs_err_tol=0.0, max_abs_err_output=worst["output"],
                bit_checks=len(bits), launches_examples=example_counts.get(name, 0),
                shapes=[row(sh) for sh in FUSED_TIME_SHAPES if sh != own])


def draw_rows(device, reps=20):
    """``{row: (ms, {kernel: device ms})}``: CUDA events over ``reps``
    calls, and each kernel's device time a launch (launch_split), of the
    elected kernels of the two random draws at phase times' shapes (the flagship K=10 Student-t proposal with
    its 2-component target at D=10, N=2^22; fused_propose_logq at K=9, D=40
    and fused_transform_rng at K=11, D=40, N=2^20) and of the kernels that
    share their draw or evaluation code at the flagship (fused_logq,
    fused_is_pmc_step, fused_is_pmc_step_blocked at K=200) and of
    fused_transform there and at K=32, D=40, N=2^20.  It calls no
    ``variant=``, so that a run against another version of the package can
    time the same rows: load this file by its path with that version first
    on ``sys.path``, and run the two versions in turns in one call."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.ops.random import student_t_scale

    params, target, _ = flagship_problem(device)
    ops, tops = core._kernel_operands(params), core._kernel_operands(target)
    n = N_PLAIN_MAX
    latent = component_draw(params, n, 9)
    gen = torch.Generator(device=device).manual_seed(9)
    zT = torch.randn((params.dim, n), generator=gen, device=device)
    scale = student_t_scale(gen, params.dof[latent.long()], (n,))
    xT = k.fused_propose_logq((7, 7), ops, n, tops)[0]
    rows = {"fused_propose_logq K=10 Kt=2 D=10": lambda i: k.fused_propose_logq((i, 1), ops, n,
                                                                               tops),
            "fused_transform_rng K=10 D=10": lambda i: k.fused_transform_rng((i, 3), latent, ops),
            "fused_logq K=10 D=10": lambda i: k.fused_logq(xT, ops),
            "fused_is_pmc_step K=10 Kt=2 D=10": lambda i: k.fused_is_pmc_step((i, 2), ops, tops,
                                                                              n, True),
            "fused_transform K=10 D=10": lambda i: k.fused_transform(zT, latent, scale, ops)}
    timed = lambda name, fn: (cuda_ms(fn, reps=reps), launch_split(name, fn, ()))
    out = {name: timed(name, fn) for name, fn in rows.items()}
    del xT, latent, zT, scale
    K, _, D, N = MAIN_SHAPES["fused_transform"][0]
    tparams = make_params(random_mixture(np.random.default_rng(K + D), K, D, True), device)
    tops32 = core._kernel_operands(tparams)
    tlatent = component_draw(tparams, N, K + D)
    tz = torch.randn((D, N), generator=gen, device=device)
    tscale = student_t_scale(gen, tparams.dof[tlatent.long()], (N,))
    out["fused_transform K=%d D=%d" % (K, D)] = timed(
        "fused_transform", lambda i: k.fused_transform(tz, tlatent, tscale, tops32))
    del tz, tlatent, tscale
    sparams, starget, _ = flagship_problem(device, K=200)
    sops, stops = core._kernel_operands(sparams), core._kernel_operands(starget)
    out["fused_is_pmc_step_blocked K=200 Kt=2 D=10"] = timed(
        "fused_is_pmc_step_blocked", lambda i: k.fused_is_pmc_step_blocked((i, 2), sops, stops, n,
                                                                          True))
    for name, (K, Kt, D, N) in (("fused_propose_logq", MAIN_SHAPES["fused_propose_logq"][0]),
                                ("fused_transform_rng", MAIN_SHAPES["fused_transform_rng"][0])):
        arrs = random_mixture(np.random.default_rng(K + D), K, D, True)
        wparams = make_params(arrs, device)
        wops = core._kernel_operands(wparams)
        if Kt:
            wtops = core._kernel_operands(make_params(
                (arrs[0][:Kt] + 0.1, arrs[1][:Kt] * 1.2, np.full(Kt, 1.0 / Kt, np.float32), None),
                device))
            fn = lambda i: k.fused_propose_logq((i, 1), wops, N, wtops)
        else:
            wlatent = component_draw(wparams, N, K + D)
            fn = lambda i: k.fused_transform_rng((i, 3), wlatent, wops)
        out["%s K=%d Kt=%d D=%d" % (name, K, Kt, D)] = timed(name, fn)
    torch.cuda.empty_cache()
    return out


# the shapes (K, Kt, D, N) the main paths give fused_maha, fused_logq,
# fused_rho and the draws: the D=40 pipeline's VB2 and PMC mixtures
# (K=31-32) at n_is1 = 2^20 particles (fused_rho: its PMC updates,
# mix_adapt/pmc.py; fused_transform: its draws), its K=2 target at 2^22,
# the K=200 step's log-likelihood of the updated mixture at 10^7
# particles; fused_propose_logq at the widest K the rule admits at D=40
# with a 2-component target, fused_transform_rng at the routes' K=11, D=40
MAIN_SHAPES = {"fused_maha": [(32, 0, 40, N_FLAGSHIP)],
               "fused_logq": [(32, 0, 40, N_FLAGSHIP), (2, 0, 40, N_PLAIN_MAX),
                              (200, 0, 10, N_SLICE)],
               "fused_rho": [(32, 0, 40, N_FLAGSHIP)],
               "fused_transform": [(32, 0, 40, N_FLAGSHIP)],
               "fused_propose_logq": [(9, 2, 40, N_FLAGSHIP)],
               "fused_transform_rng": [(11, 0, 40, N_FLAGSHIP)]}
# the pool's shapes (C, Kt, D, steps): the D=40 pipeline's (32 chains, the
# 2-component target, 400 steps a cycle) and the mcmc phase's
POOL_SHAPES = [(32, 2, 40, 400), (16384, 1, 10, 500)]
# the shapes (C, Kt, D, steps) at which both variants are timed on each
# side of pool_variant's cut-offs (csrc/mcmc_pool.cu pool_warp_chains, placed
# by pool_sweep.py's grid): highdim_target, 100 steps
POOL_SWEEP = [(C, 2, D, 100) for C, D in ((32, 8), (1024, 8), (4096, 16), (8192, 16),
                                          (8192, 32), (16384, 32), (32768, 40), (65536, 40),
                                          (65536, 64))]
# the shape (K, Kt, D, N) that times the warp-a-particle kernels past D=128
WIDE_SHAPE = (1, 1, 200, 1 << 16)


def plain_rho_chunked(xT, ops):
    """plain_rho streamed over the component chunks of kernels._chunks: log
    q first (plain_logq_blocked), then each chunk's responsibilities."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k

    f = ops.fields()
    log_q = k.plain_logq_blocked(xT, ops)
    rho = []
    for k0, k1 in k._chunks(ops.K, ops.dim, xT.shape[1]):
        fc = k._slice(f, k0, k1)
        _, _, ind = k._component_logpdfs_T(xT, fc, ops.dim, ops.student_t)
        rho.append(k._rho_from_logpdfs(ind, fc["weights"][:, None], log_q)[0])
    return torch.cat(rho), log_q


def main_shape_ms(device, name, shape, report):
    """``{"cuda": kernel ms, "plain": plain ms}`` of ``name`` at ``shape``
    (fused_maha's: maha_shape_ms), CUDA events, on a random mixture and
    particles drawn from it; Student-t as the
    proposals, Gaussian at K=2 as the pipeline's target; fused_rho's
    references streamed as plain_rho_chunked.  Past N_PLAIN_MAX the plain
    version timed is plain_logq streamed over component chunks (its (K, D,
    N) intermediate would not fit the card).  The kernel's output is held to
    its plain version in float64, streamed over component chunks, with the
    tolerance of eval_case; fused_transform's also to its looped kernel, bit
    for bit, whose time is ``"looped"``.  The two random draws are held to
    their looped kernels bit for bit (fused_propose_logq's log-densities also
    to the float64 plain versions, against a target near the proposal)."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    if name == "fused_maha":
        return maha_shape_ms(device, shape, report)
    K, Kt, D, N = shape
    arrs = random_mixture(np.random.default_rng(K + D), K, D, K > 2)
    params = make_params(arrs, device)
    ops = core._kernel_operands(params)
    xT = k.fused_propose_logq((K, D), ops, N)[0]
    x64 = xT.double()
    label = "%s K=%d D=%d N=%d" % (name, K, D, N)
    if name == "fused_rho":
        kernel, plain = (lambda i: k.fused_rho(xT, ops)), (lambda i: k.plain_rho(xT, ops))
        rho, log_q = kernel(0)
        ops64 = k.MixtureOperands(ops.packed.double(), K, D, ops.student_t)
        rho_ref, log_q_ref = plain_rho_chunked(x64, ops64)
        compare(label + " rho", rho, rho_ref, "rho", report)
        compare(label + " log_q", log_q, log_q_ref, "log", report)
        del rho, log_q, rho_ref, log_q_ref
    elif name == "fused_transform":
        from pypmc_tpu_torch.ops.random import student_t_scale

        gen = torch.Generator(device=device).manual_seed(K + D)
        zT = torch.randn((D, N), generator=gen, device=device)
        latent = component_draw(params, N, K + D)
        scale = student_t_scale(gen, params.dof[latent.long()], (N,))
        kernel = lambda i: k.fused_transform(zT, latent, scale, ops)
        plain = lambda i: k.plain_transform(zT, latent, scale, ops)
        looped = lambda i: k.fused_transform(zT, latent, scale, ops, variant="looped")
        ops64 = k.MixtureOperands(ops.packed.double(), K, D, ops.student_t)
        got = kernel(0)
        compare(label, got, k.plain_transform(zT.double(), latent, scale.double(), ops64),
                "log", report)
        require(bool(torch.equal(got, looped(0))),
                "%s: the elected and the looped kernel differ" % label)
        del got
        ms, looped_ms = cuda_ms(kernel), cuda_ms(looped)
        print("  %s: the %s kernel %.3f ms, the looped kernel %.3f ms (equal bit for bit)"
              % (label, k._elect("fused_transform", K, D, None), ms, looped_ms))
        return {"cuda": ms, "looped": looped_ms, "plain": cuda_ms(plain, reps=3, warmup=1)}
    elif name in ("fused_propose_logq", "fused_transform_rng"):
        if name == "fused_propose_logq":
            target = make_params((arrs[0][:Kt] + 0.1, arrs[1][:Kt] * 1.2,
                                  np.full(Kt, 1.0 / Kt, np.float32), None), device)
            tops = core._kernel_operands(target)
            call = lambda i, v=None: k.fused_propose_logq((i, 1), ops, N, tops, variant=v)
            plain = lambda i: k.plain_propose_logq((i, 1), ops, N, tops)
        else:
            latent = component_draw(params, N, K + D)
            call = lambda i, v=None: k.fused_transform_rng((i, 3), latent, ops, variant=v)
            plain = lambda i: k.plain_transform_rng((i, 3), latent, ops)
        got, looped = call(0), call(0, "looped")
        got, looped = (got, looped) if isinstance(got, tuple) else ((got,), (looped,))
        differ = sum(int((a != b).sum()) for a, b in zip(got, looped))
        print("  %s: the %s kernel against the looped kernel, %d outputs differ"
              % (label, k._elect(name, K, D, None, Kt), differ))
        require(differ == 0, "%s: the elected and the looped kernel differ" % label)
        if name == "fused_propose_logq":
            ops64 = k.MixtureOperands(ops.packed.double(), K, D, ops.student_t)
            tops64 = k.MixtureOperands(tops.packed.double(), Kt, D, False)
            x64 = got[0].double()
            compare(label + " log_q", got[2], k.plain_logq_blocked(x64, ops64), "log", report)
            compare(label + " log_p", got[3], k.plain_logq_blocked(x64, tops64), "log", report)
        del got, looped, x64
        torch.cuda.empty_cache()
        return {"cuda": cuda_ms(call), "looped": cuda_ms(lambda i: call(i, "looped")),
                "plain": cuda_ms(plain, reps=3, warmup=1)}
    else:
        kernel = lambda i: k.fused_logq(xT, ops)
        plain_logq = k.plain_logq if N <= N_PLAIN_MAX else k.plain_logq_blocked
        plain = lambda i: plain_logq(xT, ops)
        ops64 = k.MixtureOperands(ops.packed.double(), K, D, ops.student_t)
        compare(label, kernel(0), k.plain_logq_blocked(x64, ops64), "log", report)
    del x64
    torch.cuda.empty_cache()
    return {"cuda": cuda_ms(kernel), "plain": cuda_ms(plain, reps=3, warmup=1)}


def pool_shape_ms(device, shape, plain=True):
    """``{variant: ms, "plain": ms}`` of one fused_mcmc_pool launch at
    ``shape`` (C, Kt, D, steps), CUDA events: Kt=2 on highdim_target with
    highdim_starts and a proposal factor 2.38 / sqrt(D) I (the pipeline's
    cycle's first), Kt=1 on the mcmc phase's mcmc_problem; each variant
    forced, and (``plain``) the plain pool."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    C, Kt, D, steps = shape
    if Kt == 1:
        target, starts, sigma0, _ = mcmc_problem(device)
        chol = torch.linalg.cholesky(torch.tensor(sigma0, device=device))
    else:
        mix = highdim_target(D)
        target = mix.stacked_params(dtype=torch.float32, device=device)
        starts = highdim_starts(mix, n_chains=C).astype(np.float32)
        chol = torch.eye(D, device=device) * (2.38 / math.sqrt(D))
    tops = core._kernel_operands(target)
    require(tops.K == Kt, "pool shape: a %d-component target, not %d" % (tops.K, Kt))
    x0T = torch.tensor(starts.T.copy(), device=device)
    e0 = k.fused_logq(x0T, tops)
    cholr = chol.reshape(-1, 1).expand(-1, C).contiguous()
    out = {v: cuda_ms(lambda i: k.fused_mcmc_pool((i, 4), x0T, e0, cholr, None, tops, steps,
                                                  variant=v), reps=5)
           for v in POOL_VARIANTS}
    if plain:
        out["plain"] = cuda_ms(lambda i: k.plain_mcmc_pool((i, 4), x0T, e0, cholr, None, tops,
                                                           steps), reps=2, warmup=1)
    return out


def pool_sweep_ms(device):
    """``{(shape, variant): ms}``: both pool variants at POOL_SWEEP
    (chip_smoke.py --pool-sweep; the grid that placed the cut-offs is
    pool_sweep.py's)."""
    from pypmc_tpu_torch.ops import _build

    out = {}
    for shape in POOL_SWEEP:
        ms = pool_shape_ms(device, shape, plain=False)
        out.update({(shape, v): t for v, t in ms.items()})
        print("  pool C=%5d D=%d Kt=2 %d steps: thread %.4f ms, warp %.4f ms, elected %s"
              % (shape[0], shape[2], shape[3], ms["thread"], ms["warp"],
                 _build.pool_variant(shape[0], shape[2])))
    return out


def wide_shape_ms(device):
    """``{kernel: (ms, plain ms)}`` of the six kernels past D=128 (all on the
    tiled engine) at WIDE_SHAPE (K=1, D=200, N=2^16; a 1-component target), CUDA events,
    on particles drawn from a random Student-t mixture; fused_maha on its
    VB upper operands, fused_transform on standard normals and the
    mixture's Student-t scales."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.ops.random import student_t_scale

    K, Kt, D, N = WIDE_SHAPE
    rng = np.random.default_rng(D)
    params = make_params(random_mixture(rng, K, D, True), device)
    target = make_params(random_mixture(rng, Kt, D, False), device)
    ops, tops = core._kernel_operands(params), core._kernel_operands(target)
    xT = k.fused_propose_logq((1, D), ops, N)[0]
    A, m, _ = vb_operands(params)
    gen = torch.Generator(device=device).manual_seed(D)
    zT = torch.randn((D, N), generator=gen, device=device)
    latent = torch.zeros((N,), dtype=torch.int32, device=device)
    scale = student_t_scale(gen, params.dof[latent.long()], (N,))
    calls = {
        "fused_logq": (lambda i: k.fused_logq(xT, ops), lambda i: k.plain_logq(xT, ops)),
        "fused_rho": (lambda i: k.fused_rho(xT, ops), lambda i: k.plain_rho(xT, ops)),
        "fused_maha": (lambda i: k.fused_maha(xT, A, m), lambda i: k.plain_maha(xT, A, m)),
        "fused_transform": (lambda i: k.fused_transform(zT, latent, scale, ops),
                            lambda i: k.plain_transform(zT, latent, scale, ops)),
        "fused_transform_rng": (lambda i: k.fused_transform_rng((i, 3), latent, ops),
                                lambda i: k.plain_transform_rng((i, 3), latent, ops)),
        "fused_propose_logq": (lambda i: k.fused_propose_logq((i, 1), ops, N, tops),
                               lambda i: k.plain_propose_logq((i, 1), ops, N, tops)),
    }
    return {name: (cuda_ms(kernel), cuda_ms(plain, reps=3, warmup=1))
            for name, (kernel, plain) in calls.items()}


# the shapes (K, Kt, D, N) at which the tiled kernels of fused_maha,
# fused_logq, fused_rho and fused_transform are timed: K = 1 and the JAX
# rule's largest K at D = 65, 96 and 128 (where they replaced the looped
# kernels) and at D = 200, and the wide path's K = 4 at D = 200
TILED_SHAPES = [(K, 0, D, 1 << 16) for K, D in ((1, 65), (60, 65), (1, 96), (41, 96), (1, 128),
                                               (30, 128), (1, 200), (19, 200), (4, 200))]
TILED_TIMED = ("fused_maha", "fused_logq", "fused_rho", "fused_transform")
# the ones phase times times there (--tiled-times: all of TILED_TIMED)
TILED_DEFAULT = ("fused_logq", "fused_rho")


def tiled_inputs(device, shape):
    """The inputs the tiled kernels are timed on at ``shape`` (K, Kt, D, N):
    a random Student-t mixture (seed K + D) and its packed operands, N
    particles from it (mixture_particles), the VB E-step's upper operands of
    it; for fused_transform N standard normals, components drawn by weight
    (component_draw) and the mixture's Student-t scales.  Only the package's
    public layout is read, so that an earlier checkout's kernels can be
    timed on the same inputs (``--elected-times``)."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops.random import student_t_scale

    K, _, D, N = shape
    params = make_params(random_mixture(np.random.default_rng(K + D), K, D, True), device)
    ops = core._kernel_operands(params)
    A, m, _ = vb_operands(params)
    gen = torch.Generator(device=device).manual_seed(K + D)
    zT = torch.randn((D, N), generator=gen, device=device)
    latent = component_draw(params, N, K + D)
    return dict(params=params, ops=ops, xT=mixture_particles(ops, N, K + D, device), A=A, m=m,
                zT=zT, latent=latent,
                scale=student_t_scale(gen, params.dof[latent.long()], (N,)))


def tiled_calls(k, a):
    """``{name: (kernel call, plain call)}`` of the wrappers of TILED_TIMED on
    tiled_inputs ``a``, each call taking the index cuda_ms hands it."""
    xT, ops = a["xT"], a["ops"]
    tr = (a["zT"], a["latent"], a["scale"], ops)
    return {"fused_maha": (lambda i: k.fused_maha(xT, a["A"], a["m"]),
                           lambda i: k.plain_maha(xT, a["A"], a["m"])),
            "fused_logq": (lambda i: k.fused_logq(xT, ops), lambda i: k.plain_logq(xT, ops)),
            "fused_rho": (lambda i: k.fused_rho(xT, ops), lambda i: k.plain_rho(xT, ops)),
            "fused_transform": (lambda i: k.fused_transform(*tr),
                                lambda i: k.plain_transform(*tr))}


def elected_ms(device, shape):
    """``{name: ms}`` of the kernel each wrapper of TILED_TIMED elects at
    ``shape`` in the package imported, CUDA events on tiled_inputs, and
    "fused_transform device", its device ms (graph_ms): in an earlier
    checkout, the kernels the tiled ones replaced or redesigned."""
    from pypmc_tpu_torch.ops import kernels as k

    calls = tiled_calls(k, tiled_inputs(device, shape))
    out = {name: cuda_ms(calls[name][0]) for name in TILED_TIMED}
    out["fused_transform device"] = graph_ms(calls["fused_transform"][0])
    return out


# the shapes (K, Kt, D, N) at which the drawn tiled products of
# fused_propose_logq and fused_transform_rng (its K the shape's) are timed:
# K = 1 and the JAX rule's largest K + Kt at D = 65, 96, 128 and 129, and at
# D = 200 (K = 1, with and without a 1-component target: the rule admits
# none there, WIDE_SHAPE has one) and 248, the rule's reach
DRAWN_SHAPES = [(K, Kt, D, 1 << 16) for K, Kt, D in (
    (1, 0, 65), (4, 2, 65), (1, 0, 96), (3, 1, 96), (1, 0, 128), (1, 1, 128), (1, 0, 129),
    (1, 1, 129), (1, 0, 200), (1, 1, 200), (1, 0, 248))]
DRAWN_TIMED = ("fused_propose_logq", "fused_transform_rng")


def drawn_inputs(device, shape):
    """The inputs the draws are timed on at ``shape`` (K, Kt, D, N): a
    random Student-t mixture (seed K + D) and, with Kt, a Gaussian target
    near it, their packed operands, and N components drawn by weight
    (component_draw, fused_transform_rng's).  Only the package's public
    layout is read (``--elected-times``)."""
    from pypmc_tpu_torch.density import core

    K, Kt, D, N = shape
    arrs = random_mixture(np.random.default_rng(K + D), K, D, True)
    params = make_params(arrs, device)
    target = None
    if Kt:
        tarrs = (arrs[0][:Kt] + 0.1, arrs[1][:Kt] * 1.2, np.full(Kt, 1.0 / Kt, np.float32), None)
        target = core._kernel_operands(make_params(tarrs, device))
    return dict(params=params, ops=core._kernel_operands(params), tops=target,
                latent=component_draw(params, N, K + D))


def drawn_calls(k, a, N):
    """``{name: (kernel call, plain call)}`` of DRAWN_TIMED's wrappers on
    drawn_inputs ``a``, the seed words (i, 1) and (i, 3) of the index cuda_ms
    hands each call."""
    ops, tops, latent = a["ops"], a["tops"], a["latent"]
    return {"fused_propose_logq": (lambda i: k.fused_propose_logq((i, 1), ops, N, tops),
                                   lambda i: k.plain_propose_logq((i, 1), ops, N, tops)),
            "fused_transform_rng": (lambda i: k.fused_transform_rng((i, 3), latent, ops),
                                    lambda i: k.plain_transform_rng((i, 3), latent, ops))}


def drawn_elected_ms(device, shape):
    """``{name: ms}`` of the kernel each wrapper of DRAWN_TIMED elects at
    ``shape`` in the package imported, CUDA events on drawn_inputs, and
    ``"<name> device"``, its device ms (graph_ms): in an earlier checkout,
    the kernels the drawn products replaced or redesigned."""
    from pypmc_tpu_torch.ops import kernels as k

    calls = drawn_calls(k, drawn_inputs(device, shape), shape[3])
    out = {name: cuda_ms(calls[name][0]) for name in DRAWN_TIMED}
    out.update({name + " device": graph_ms(calls[name][0]) for name in DRAWN_TIMED})
    return out


def drawn_shape_ms(device, shape):
    """``{(kernel, route): ms}`` at ``shape`` (K, Kt, D, N) for the wrappers
    of DRAWN_TIMED on drawn_inputs, CUDA events, in turns (tiled, looped,
    composition, plain, plain, composition, looped, tiled; each the mean of
    its two turns): "tiled", the drawn product (fused_propose_logq's whole
    tiled route), also "cuda" where elected; "looped", the looped kernel to
    D = 128; "plain", the plain version; "composition", the launches of
    other rows that compute the same: draw_proposal_inputs (the normals and
    scales, written to device memory), fused_transform's tiled pair on them
    and, fused_propose_logq's, fused_logq's tiled kernel for log q (and log
    p); and "device" and "looped_device", the tiled route's and the looped
    kernel's device time (graph_ms: no host gaps)."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N = shape
    a = drawn_inputs(device, shape)
    ops, tops, latent = a["ops"], a["tops"], a["latent"]
    f = ops.fields()
    calls = drawn_calls(k, a, N)

    def composition(name, i):
        lat, zT, scale = k.draw_proposal_inputs((i, 5), f["cumw"], f["dof"], N, D, True)
        if name == "fused_transform_rng":
            return k.fused_transform(zT, latent, scale, ops, variant="tiled")
        xT = k.fused_transform(zT, lat, scale, ops, variant="tiled")
        return (xT, lat, k.fused_logq(xT, ops, variant="tiled")) + (
            () if tops is None else (k.fused_logq(xT, tops, variant="tiled"),))

    label = "K=%d Kt=%d D=%d N=%d" % shape
    out = {}
    for name in DRAWN_TIMED:
        elected = k._elect(name, K, D, None, Kt)
        tiled = (lambda i, name=name: k.fused_propose_logq((i, 1), ops, N, tops, variant="tiled")
                 if name == "fused_propose_logq"
                 else k.fused_transform_rng((i, 3), latent, ops, variant="tiled"))
        fns = {"tiled": tiled, "composition": lambda i, name=name: composition(name, i),
               "plain": calls[name][1]}
        order = ("tiled", "composition", "plain", "plain", "composition", "tiled")
        if D <= _build._THREAD_D_MAX:
            fns["looped"] = (
                lambda i, name=name: k.fused_propose_logq((i, 1), ops, N, tops, variant="looped")
                if name == "fused_propose_logq"
                else k.fused_transform_rng((i, 3), latent, ops, variant="looped"))
            order = ("tiled", "looped", "composition", "plain", "plain", "composition",
                     "looped", "tiled")
        ms = {route: [] for route in fns}
        for route in order:
            ms[route].append(cuda_ms(fns[route], **({"reps": 3, "warmup": 1}
                                                    if route == "plain" else {})))
        out.update({(name, route): sum(t) / 2 for route, t in ms.items()})
        out[(name, "cuda")] = out[(name, elected)]
        out[(name, "device")] = graph_ms(tiled)
        if "looped" in fns:
            out[(name, "looped_device")] = graph_ms(fns["looped"])
        fns.clear()
        torch.cuda.empty_cache()
        print("  %s %s: tiled %s ms (device %.4f), looped %s (device %s), composition %s, plain "
              "%s, bound %.4f ms; elected %s"
              % (name, label, " / ".join("%.4f" % t for t in ms["tiled"]), out[(name, "device")],
                 " / ".join("%.4f" % t for t in ms.get("looped", [])) or "-",
                 "%.4f" % out[(name, "looped_device")] if (name, "looped_device") in out else "-",
                 " / ".join("%.4f" % t for t in ms["composition"]),
                 " / ".join("%.4f" % t for t in ms["plain"]), bound(name, shape)[1], elected))
    return out


# the shapes (K, Kt, D, N) of the library yardsticks of rows 1-3 and 6 at
# their first shapes (the flagship's K=10, D=10, N=2^22; the D=40
# pipeline's K=32 at 2^20)
LIBRARY_SHAPES = [(10, 2, 10, N_PLAIN_MAX), (32, 0, 40, N_FLAGSHIP)]
# rows 7-9 past D = 16, timed at every GRAM_SHAPES entry: a one-component
# target, 2^20 particles
GRAM_TIME_SHAPES = [(K, 1, D, N_FLAGSHIP) for K, D in GRAM_SHAPES]


def library_shape_ms(device, shape):
    """``{(kernel, route): ms}`` at ``shape``: "library", one FP32
    ``torch.bmm`` computing the product of fused_maha (the VB operands),
    fused_logq and fused_rho (U on the pre-centred (K, D, N) operand) and
    fused_transform (L on normals pre-bucketed into (K, D, N / K)), beside
    "cuda", the elected kernel, in turns (kernel, library, library,
    kernel); a random Student-t mixture (seed K + D) and N particles from
    it."""
    import torch
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.ops.random import student_t_scale

    require(not torch.backends.cuda.matmul.allow_tf32, "the library yardstick must run in FP32")
    K, _, D, N = shape
    params = make_params(random_mixture(np.random.default_rng(K + D), K, D, True), device)
    from pypmc_tpu_torch.density import core
    ops = core._kernel_operands(params)
    f = ops.fields()
    xT = mixture_particles(ops, N, K + D, device)
    A, m, _ = vb_operands(params)
    gen = torch.Generator(device=device).manual_seed(K + D)
    zT = torch.randn((D, N), generator=gen, device=device)
    latent = component_draw(params, N, K + D)
    scale = student_t_scale(gen, params.dof[latent.long()], (N,))
    out = {}
    for name in ("fused_maha", "fused_logq", "fused_rho", "fused_transform"):
        if name == "fused_transform":
            zb = torch.randn((K, D, N // K), device=device)
            Lk = f["L"].contiguous()
            library, kernel = (lambda i: torch.bmm(Lk, zb),
                               lambda i: k.fused_transform(zT, latent, scale, ops))
        else:
            am = (A, m) if name == "fused_maha" else (f["U"], f["mu"])
            xc = (xT[None] - am[1][:, :, None]).contiguous()
            library = lambda i, am=am, xc=xc: torch.bmm(am[0], xc)
            kernel = {"fused_maha": lambda i: k.fused_maha(xT, A, m),
                      "fused_logq": lambda i: k.fused_logq(xT, ops),
                      "fused_rho": lambda i: k.fused_rho(xT, ops)}[name]
        ms = {"cuda": [], "library": []}
        for route in ("cuda", "library", "library", "cuda"):
            ms[route].append(cuda_ms(kernel if route == "cuda" else library))
        out.update({(name, route): sum(t) / 2 for route, t in ms.items()})
        print("  %s K=%d D=%d N=%d: kernel %s ms, torch.bmm %s ms"
              % (name, K, D, N, " / ".join("%.3f" % t for t in ms["cuda"]),
                 " / ".join("%.3f" % t for t in ms["library"])))
        del library, kernel
        torch.cuda.empty_cache()
    return out


def table_shape_ms(device, shape, timed=True):
    """``{(kernel, shape, route): ms}`` of fused_pmc_stats, fused_is_pmc_step
    and fused_vb_estep at ``shape`` (K, Kt, D, N) ({} where not ``timed``:
    the checks alone), a K-component Student-t
    proposal and a Kt-component Gaussian target near it (gram_mixtures;
    fused_vb_estep on the proposal's vb_operands, the same particles and
    weights): "cuda" the elected pass (the Gram pass past D = 16), "table"
    the entry table forced, "plain" the plain version, CUDA events in turns
    (cuda, table, plain, plain, table, cuda; each the mean of its two
    turns); the elected statistics held to the float64 plain version
    first."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N = shape
    ops, tops, ops64, _, _, params = gram_mixtures((K, Kt, D, N, True, False, True, K + D),
                                                   device)
    xT, _, log_q, log_p = k.fused_propose_logq((7, 7), ops, N, tops)
    w = torch.exp(log_p - log_q)
    del log_q, log_p
    check_stats("fused_pmc_stats K=%d D=%d" % (K, D), k.fused_pmc_stats(xT, w, ops, True),
                k.plain_pmc_stats(xT.double(), w.double(), ops64, True), N, [])
    A, m, const = vb_operands(params)
    ref = k.plain_vb_estep(xT.double(), w.double(), A.double(), m.double(), const.double())
    for name, g, r in zip(("N_comp", "sd", "g", "log_q_Z"), k.fused_vb_estep(xT, w, A, m, const),
                          ref):
        compare("fused_vb_estep K=%d D=%d %s/N" % (K, D, name), g / N, r / N, "stats", [])
    del ref
    if not timed:
        return {}
    calls = {"fused_pmc_stats": (lambda i: k.fused_pmc_stats(xT, w, ops, True),
                                 lambda i: k.fused_pmc_stats(xT, w, ops, True, variant="table"),
                                 lambda i: k.plain_pmc_stats(xT, w, ops, True)),
             "fused_is_pmc_step": (
                 lambda i: k.fused_is_pmc_step((i, 2), ops, tops, N, True),
                 lambda i: k.fused_is_pmc_step((i, 2), ops, tops, N, True, variant="table"),
                 lambda i: k.plain_is_pmc_step((i, 2), ops, tops, N, True)),
             "fused_vb_estep": (lambda i: k.fused_vb_estep(xT, w, A, m, const),
                                lambda i: k.fused_vb_estep(xT, w, A, m, const, variant="table"),
                                lambda i: k.plain_vb_estep(xT, w, A, m, const))}
    out = {}
    for name, (kernel, table, plain) in calls.items():
        ms = {"cuda": [], "table": [], "plain": []}
        fns = {"cuda": kernel, "table": table, "plain": plain}
        for route in ("cuda", "table", "plain", "plain", "table", "cuda"):
            ms[route].append(cuda_ms(fns[route], reps=3 if route == "plain" else 5, warmup=1))
        out.update({(name, shape, route): sum(t) / 2 for route, t in ms.items()})
        cuda = out[(name, shape, "cuda")]
        print("  %s K=%d Kt=%d D=%d N=%d: the %s pass %s ms, the entry table %s ms, plain %s "
              "ms, bound %.4f ms (%.1f%% of it)"
              % (name, K, Kt, D, N, _build.dense_plan(name, K, D, Kt)[0],
                 " / ".join("%.3f" % t for t in ms["cuda"]),
                 " / ".join("%.3f" % t for t in ms["table"]),
                 " / ".join("%.3f" % t for t in ms["plain"]), bound(name, shape)[1],
                 100 * bound(name, shape)[1] / cuda))
    return out


def graph_ms(fn, reps=20, replays=3):
    """Device milliseconds of fn(i) with no host gaps: ``reps`` calls
    captured in one CUDA graph (after a warm-up call on a side stream),
    replayed ``replays`` times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(10_000)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (reps * replays)


def tiled_shape_ms(device, shape, timed=TILED_TIMED):
    """``{(kernel, route): ms}`` at ``shape`` (K, Kt, D, N) for the wrappers
    of TILED_TIMED on tiled_inputs (fused_maha on the VB E-step's upper
    operands; each held to its float64 plain version, the wrappers not in
    ``timed`` then left untimed), CUDA events, in turns (mma, tiled, looped,
    library, plain, plain, library, looped, tiled, mma; each the mean of its
    two turns): "mma", the evaluations' tensor-core kernel, the one fused_maha,
    fused_logq and fused_rho elect, beside the tiled kernel forced (and both
    kernels' and torch.bmm's device times in turns, "<route>_device");
    "tiled", the tiled kernel (fused_transform's pair
    forced where its plan elects the looped kernel; each timed kernel held
    to the float64 plain version first); "cuda", the elected kernel's;
    "looped", fused_transform's looped kernel
    to D = 128; "plain", the plain version; "library", one PyTorch call in
    full FP32 (allow_tf32 False), a yardstick the port never calls:
    ``torch.bmm(a, xc)`` on the pre-centred (K, D, N) operand for the
    evaluations (fused_rho's a = U, as fused_logq's), ``torch.bmm(L, Zb)``
    for fused_transform, on normals pre-bucketed into a (K, D, N / K)
    operand, the product alone; and fused_transform's device times
    (graph_ms, no host gaps): "bucket", the bucket pass alone (0 at K = 1,
    where the pair is one launch), "product", the pair's less the bucket
    pass's (the moves into and out of bucket order and the product), and
    "library_device", torch.bmm's."""
    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    require(not torch.backends.cuda.matmul.allow_tf32, "the library yardstick must run in FP32")
    K, _, D, N = shape
    a = tiled_inputs(device, shape)
    ops, xT, f = a["ops"], a["xT"], a["ops"].fields()
    ops64 = k.MixtureOperands(ops.packed.double(), K, D, True)
    x64 = xT.double()
    tr = (a["zT"], a["latent"], a["scale"])
    calls = tiled_calls(k, a)
    label = "K=%d D=%d N=%d" % (K, D, N)
    refs = {"fused_maha": lambda: k.plain_maha(x64, a["A"].double(), a["m"].double()),
            "fused_logq": lambda: k.plain_logq(x64, ops64),
            "fused_rho": lambda: k.plain_rho(x64, ops64)[0],
            "fused_transform": lambda: k.plain_transform(tr[0].double(), tr[1], tr[2].double(),
                                                         ops64)}
    out = {}
    forced = {"fused_maha": lambda i: k.fused_maha(xT, a["A"], a["m"], variant="tiled"),
              "fused_logq": lambda i: k.fused_logq(xT, ops, variant="tiled"),
              "fused_rho": lambda i: k.fused_rho(xT, ops, variant="tiled")}
    for name in TILED_TIMED:
        elected = k._elect(name, K, D, None)
        call, plain = calls[name]
        fns = {}
        if name == "fused_transform":
            call = lambda i: k.fused_transform(*tr, ops, variant="tiled")
            kind = "log"
        else:
            require(elected == "mma", "%s %s: not the tensor-core kernel" % (name, label))
            kind = {"fused_maha": "maha", "fused_logq": "log", "fused_rho": "rho"}[name]
            # the tensor-core kernel elected, the tiled kernel forced beside it
            fns["mma"], call = call, forced[name]
        for route, fn in list(fns.items()) + [("tiled", call)]:
            got = fn(0)
            compare("%s %s %s" % (name, route, label), got[0] if name == "fused_rho" else got,
                    refs[name](), kind, [])
            del got
        torch.cuda.empty_cache()
        if name not in timed:
            continue
        if name == "fused_transform":
            Lk = f["L"].contiguous()
            zb = torch.randn((K, D, N // K), device=device)
            library = lambda i: torch.bmm(Lk, zb)
        else:
            am = {"fused_maha": (a["A"], a["m"])}.get(name, (f["U"], f["mu"]))
            xc = (xT[None] - am[1][:, :, None]).contiguous()
            library = lambda i, am=am, xc=xc: torch.bmm(am[0], xc)
        fns.update({"tiled": call, "library": library, "plain": plain})
        order = tuple(fns) + tuple(fns)[::-1]
        if name == "fused_transform" and D <= _build._THREAD_D_MAX:
            fns["looped"] = lambda i: k.fused_transform(*tr, ops, variant="looped")
            order = ("tiled", "looped", "library", "plain", "plain", "library", "looped", "tiled")
        ms = {route: [] for route in fns}
        for route in order:
            ms[route].append(cuda_ms(fns[route], **({"reps": 3, "warmup": 1}
                                                    if route == "plain" else {})))
        out.update({(name, route): sum(t) / 2 for route, t in ms.items()})
        out[(name, "cuda")] = out[(name, elected)]
        extra = ""
        if name != "fused_transform":
            # device times with no host gaps (graph_ms), in turns
            dev = {}
            for route in ("mma", "tiled", "library", "library", "tiled", "mma"):
                dev.setdefault(route, []).append(graph_ms(fns[route]))
            out.update({(name, route + "_device"): sum(t) / 2 for route, t in dev.items()})
            extra = (", mma %s ms; device: mma %.4f ms, tiled %.4f ms, bmm %.4f ms; tensor-core "
                     "bound %.4f ms; elected %s" % (
                         " / ".join("%.3f" % t for t in ms["mma"]), out[(name, "mma_device")],
                         out[(name, "tiled_device")], out[(name, "library_device")],
                         bound_tc(name, shape)[1], elected))
            if name == "fused_rho":
                # the tiled launches of fused_logq and fused_rho, forced, hold
                # the same log q bit for bit, and so do the tensor-core ones
                for route in ("mma", "tiled"):
                    v = route
                    require(bool(torch.equal(k.fused_rho(xT, ops, variant=v)[1],
                                             k.fused_logq(xT, ops, variant=v))),
                            "%s %s: fused_rho's log q is not fused_logq's" % (label, route))
        fns.clear()
        torch.cuda.empty_cache()
        if name == "fused_transform":
            out[(name, "bucket")] = (graph_ms(lambda i: k._transform_buckets(tr[1], K))
                                     if K > 1 else 0.0)
            out[(name, "product")] = graph_ms(call) - out[(name, "bucket")]
            out[(name, "library_device")] = graph_ms(library)
            extra = (", device: bucket pass %.4f ms, the rest (moves and product) %.4f ms, "
                     "bmm %.4f ms; elected %s%s" % (
                         out[(name, "bucket")], out[(name, "product")],
                         out[(name, "library_device")], elected,
                         ", looped %s ms" % " / ".join("%.3f" % t for t in ms["looped"])
                         if "looped" in ms else ""))
        print("  %s %s: tiled %s ms, plain %s ms, library (bmm) %s ms, bound %.3f ms%s"
              % (name, label, *(" / ".join("%.3f" % t for t in ms[route])
                                for route in ("tiled", "plain", "library")),
                 bound(name, shape)[1], extra))
    return out


# fused_transform's pair with parts of its data movement left out, built
# from csrc/transform.cu with the PMC_TRANSFORM_OFF mask (0 in the
# library): 1 the move of z and the scales into bucket order, 2 the move of
# x out of it (the product then reads and stores in bucket order whatever
# is there); the outputs of a variant with a part left out are wrong by
# design and not checked
TRANSFORM_OFF = {"all": 0, "no move in": 1, "no move out": 2, "neither": 3}
# the shapes of the split: the JAX rule's largest K at D = 65, 96, 128 and
# 200, the wide path's K = 4 at D = 200, and K = 1 at D = 65 and 200
SPLIT_SHAPES = [(K, 0, D, 1 << 16) for K, D in ((60, 65), (1, 65), (41, 96), (30, 128),
                                               (19, 200), (4, 200), (1, 200))]


def transform_split(device, out_dir="build/transform_split"):
    """``{"K,D": {variant: device ms}}``: fused_transform's tiled pair (the
    variant's launches through pmc_fused_transform, variant 2) built with
    each TRANSFORM_OFF mask, one nvcc a mask, all at once, on tiled_inputs
    at SPLIT_SHAPES, in turns (all, each variant, then in reverse; the
    mean of the two), device ms in CUDA graphs (graph_ms); "bucket" the
    bucket pass alone (the library's)."""
    import shutil
    from pathlib import Path

    import torch
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    out = Path(out_dir)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    paths = {name: out / ("lib_%d.so" % mask) for name, mask in TRANSFORM_OFF.items()}
    log, rc = _build._run_all(
        [[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-DPMC_TRANSFORM_OFF=%d" % mask, "-o",
          str(paths[name]), str(_build.CSRC / "transform.cu")]
         for name, mask in TRANSFORM_OFF.items()])
    require(rc == 0, "transform_split: nvcc failed:\n%s" % log[-4000:])
    fns = {}
    for name, path in paths.items():
        fn = getattr(ctypes.CDLL(str(path)), "pmc_fused_transform")
        fn.argtypes, fn.restype = _build.signatures()["pmc_fused_transform"], ctypes.c_int
        fns[name] = fn
    result = {}
    for shape in SPLIT_SHAPES:
        K, _, D, N = shape
        a = tiled_inputs(device, shape)
        ops = a["ops"]
        zT, latent, scale = a["zT"], a["latent"], a["scale"]
        operands = k._transform_operands(ops)
        scratch = k._draw_scratch("tiled", N, K, D, device)
        n_blocks = k._draw_blocks("fused_transform", device, N, K, D, "tiled")
        xT = k._transform_output(D, N, K, "tiled", device)

        def call(fn):
            err = fn(zT.data_ptr(), latent.data_ptr(), scale.data_ptr(), operands.data_ptr(),
                     None if scratch is None else scratch.data_ptr(), xT.data_ptr(), N, K, D,
                     2, n_blocks, torch.cuda.current_stream(device).cuda_stream)
            require(err == 0, "transform_split: CUDA error %d" % err)

        call(fns["all"])
        want = k.fused_transform(zT, latent, scale, ops, variant="tiled")
        require(bool(torch.equal(xT, want)), "transform_split: the whole pair's build differs "
                "from the library's at K=%d D=%d" % (K, D))
        ms = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                ms[name].append(graph_ms(lambda i, fn=fns[name]: call(fn)))
        row = {name: sum(t) / len(t) for name, t in ms.items()}
        row["bucket"] = graph_ms(lambda i: k._transform_buckets(latent, K)) if K > 1 else 0.0
        result["%d,%d" % (K, D)] = row
        print("  fused_transform K=%d D=%d N=%d: device ms %s" % (
            K, D, N, ", ".join("%s %.4f" % (name, v) for name, v in row.items())), flush=True)
        del a, zT, latent, scale, operands, scratch, xT, want
        torch.cuda.empty_cache()
    return result


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes a second
# and FP32 operations a second outside the tensor cores.
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12
PEAK_TF32 = 495e12   # dense TF32 on the tensor cores


# fused_maha's three kernels to D = 64 (the election of csrc/mma.cuh
# kMahaMmaDMin), timed at each record instantiation's DMAX bucket (8, 16,
# 32, 40, 64) at K=1 and the JAX rule's largest K (454, 240, 225 at D=17,
# 193 at D=20, 123, 98, 62), and at the D=40 pipeline's K=32; 2^20
# particles
MAHA_TIME_SHAPES = [(K, 0, D, N_FLAGSHIP) for K, D in (
    (1, 8), (454, 8), (1, 16), (240, 16), (1, 17), (225, 17), (1, 20), (193, 20), (1, 32),
    (123, 32), (1, 40), (32, 40), (98, 40), (1, 64), (62, 64))]
MAHA_VARIANTS = ("mma", "rec", "tiled")
# the tensor-core kernel's instantiations, by the mangled spelling of D
# padded to 8 (csrc/mma.cuh dispatch_mma)
MAHA_MMA_KERNELS = ["15maha_mma_kernelILi%dEE" % d for d in range(8, 65, 8)]


def maha_shape_ms(device, shape, report):
    """``{route: ms}`` of fused_maha at ``shape`` (K, Kt, D <= 64, N) on a
    random Student-t mixture (seed K + D), N particles from it
    (mixture_particles) and the VB E-step's upper operands of it
    (vb_operands): "mma", "rec" and "tiled", fused_maha's three kernels
    forced, each held first to the float64 plain version (over component
    chunks) with TOL["maha"] and equal on a second run; "library", one FP32
    ``torch.bmm`` of the pre-centred (K, D, N) operand (the product alone,
    never called by the port); "plain", plain_maha over the component chunks
    of kernels._chunks; CUDA events in turns (mma, rec, tiled, library,
    plain, plain, library, tiled, rec, mma), each the mean of its two turns;
    "cuda", the elected kernel's; "<route>_device", the same kernels and
    the library call in CUDA graphs (graph_ms), in turns."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    require(not torch.backends.cuda.matmul.allow_tf32, "the library yardstick must run in FP32")
    K, _, D, N = shape
    params = make_params(random_mixture(np.random.default_rng(K + D), K, D, True), device)
    xT = mixture_particles(core._kernel_operands(params), N, K + D, device)
    A, m, _ = vb_operands(params)
    chunks = k._chunks(K, D, N)
    label = "fused_maha K=%d D=%d N=%d" % (K, D, N)
    ref = torch.cat([k.plain_maha(xT.double(), A[k0:k1].double(), m[k0:k1].double())
                     for k0, k1 in chunks])
    fns = {v: (lambda i, v=v: k.fused_maha(xT, A, m, variant=v)) for v in MAHA_VARIANTS}
    for v, fn in fns.items():
        got = fn(0)
        compare("%s %s" % (label, v), got, ref, "maha", report)
        require(bool(torch.equal(got, fn(1))), "%s %s: one input gave two outputs" % (label, v))
        del got
    del ref
    torch.cuda.empty_cache()
    xc = (xT[None] - m[:, :, None]).contiguous()
    fns["library"] = lambda i: torch.bmm(A, xc)
    fns["plain"] = lambda i: torch.cat([k.plain_maha(xT, A[k0:k1], m[k0:k1]) for k0, k1 in chunks])
    ms = {route: [] for route in fns}
    for route in MAHA_VARIANTS + ("library", "plain", "plain", "library") + MAHA_VARIANTS[::-1]:
        reps = {"plain": 3, "library": 5}.get(route, 10)
        ms[route].append(cuda_ms(fns[route], reps=reps, warmup=1))
    # device times with no host gaps (graph_ms): at K=1 a launch's host
    # side is longer than its kernel
    for route in MAHA_VARIANTS + ("library", "library") + MAHA_VARIANTS[::-1]:
        ms.setdefault(route + "_device", []).append(graph_ms(fns[route]))
    del xc, fns
    torch.cuda.empty_cache()
    out = {route: sum(t) / 2 for route, t in ms.items()}
    elected = _build.eval_variant("fused_maha", D)
    out["cuda"] = out[elected]
    print("  %s: %s; bound FP32 %.4f ms, tensor-core %.4f ms; elected %s"
          % (label, ", ".join("%s %s ms" % (route, " / ".join("%.4f" % t for t in ts))
                              for route, ts in ms.items()),
             bound("fused_maha", shape)[1], bound_tc("fused_maha", shape)[1], elected))
    return out


# fused_maha past D = 64, timed by --maha-times: TILED_SHAPES, and K = 1 at
# D = 1,000 and 2,040 (the rule's reach at K = 1), 2^16 particles
MAHA_WIDE_SHAPES = TILED_SHAPES + [(1, 0, 1000, 1 << 16), (1, 0, 2040, 1 << 16)]


def maha_wide_ms(device, shape, report):
    """``{route: ms}`` of fused_maha at ``shape`` (K, Kt, D > 64, N): each of
    its kernels at D forced (``kernels._eval_variants``: the tiled kernel
    and the tensor-core one), held first to the float64 plain version (over
    component chunks) with TOL["maha"] and equal on a second run, and one
    FP32 ``torch.bmm`` of the pre-centred (K, D, N) operand ("library", the
    product alone, never called by the port); device ms in CUDA graphs
    (graph_ms), in turns (kernels, library, library, kernels reversed), each
    the mean of its two turns; "cuda" the elected kernel's.  The inputs are
    maha_shape_ms': a random Student-t mixture (seed K + D), N particles from
    it, the VB E-step's upper operands of it."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    require(not torch.backends.cuda.matmul.allow_tf32, "the library yardstick must run in FP32")
    K, _, D, N = shape
    params = make_params(random_mixture(np.random.default_rng(K + D), K, D, True), device)
    xT = mixture_particles(core._kernel_operands(params), N, K + D, device)
    A, m, _ = vb_operands(params)
    chunks = k._chunks(K, D, N)
    label = "fused_maha K=%d D=%d N=%d" % (K, D, N)
    ref = torch.cat([k.plain_maha(xT.double(), A[k0:k1].double(), m[k0:k1].double())
                     for k0, k1 in chunks])
    variants = k._eval_variants("fused_maha", D)
    fns = {v: (lambda i, v=v: k.fused_maha(xT, A, m, variant=v)) for v in variants}
    for v, fn in fns.items():
        got = fn(0)
        compare("%s %s" % (label, v), got, ref, "maha", report)
        require(bool(torch.equal(got, fn(1))), "%s %s: one input gave two outputs" % (label, v))
        del got
    del ref
    torch.cuda.empty_cache()
    xc = (xT[None] - m[:, :, None]).contiguous()
    fns["library"] = lambda i: torch.bmm(A, xc)
    ms = {}
    for route in variants + ("library", "library") + variants[::-1]:
        ms.setdefault(route, []).append(graph_ms(fns[route], reps=5 if D > 200 else 20))
    del xc, fns
    torch.cuda.empty_cache()
    out = {route: sum(t) / 2 for route, t in ms.items()}
    elected = _build.eval_variant("fused_maha", D)
    out["cuda"] = out[elected]
    print("  %s, device ms: %s; bound FP32 %.4f ms, tensor-core %.4f ms; elected %s"
          % (label, ", ".join("%s %s" % (route, " / ".join("%.4f" % t for t in ts))
                              for route, ts in ms.items()),
             bound("fused_maha", shape)[1], bound_tc("fused_maha", shape)[1], elected))
    return out


# fused_maha's tensor-core kernel past D = 64 with parts left out, built
# from csrc/maha.cu with the PMC_MAHA_OFF mask (csrc/mma_tiled.cuh MahaOff;
# 0 in the library): 1 the x words' split, 2 the two small products, 4 the
# step buffers' copies past the first steps, 8 every product; the outputs
# of a variant with a part left out are wrong by design
MAHA_OFF = {"all": 0, "no split": 1, "big only": 2, "no copies": 4, "no mma": 8,
            "big only, no split": 3}
# the shapes (K, Kt, D, N) of --maha-split: the wide VB path's D=200 at
# K=1 and the rule's largest K, and the rule's largest K at D=65 and 128
MAHA_SPLIT_SHAPES = [(K, 0, D, 1 << 16) for K, D in ((1, 200), (19, 200), (60, 65), (30, 128))]


def maha_split(device, out_dir="build/maha_split", csrc=None):
    """``{"K,D": {variant: device ms}}``: fused_maha's tensor-core kernel
    past D = 64 (its launches through pmc_fused_maha, variant 3: the split
    of A, then the kernel) built with each MAHA_OFF mask, one nvcc a mask,
    all at once, on maha_wide_ms' inputs at MAHA_SPLIT_SHAPES, in turns
    (all, each variant, then in reverse; the mean of the two), device ms in
    CUDA graphs (graph_ms); the whole kernel's build held to the float64
    plain version first.  Needs no library build: ~1 min of nvcc.  ``csrc``:
    the sources' directory (by default the package's; another checkout's
    ``pypmc_tpu_torch/csrc`` to time its kernel on the same inputs)."""
    import shutil
    from pathlib import Path

    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    out = Path(out_dir)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    paths = {name: out / ("lib_%d.so" % mask) for name, mask in MAHA_OFF.items()}
    log, rc = _build._run_all(
        [[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-DPMC_MAHA_OFF=%d" % mask, "-o",
          str(paths[name]), str(Path(csrc or _build.CSRC) / "maha.cu")]
         for name, mask in MAHA_OFF.items()])
    require(rc == 0, "maha_split: nvcc failed:\n%s" % log[-4000:])
    for part in log.split("Compiling entry function '")[1:]:
        if "21maha_mma_tiled_kernel" in part.split("'", 1)[0]:
            spill = re.search(r"(\d+) bytes spill stores", part)
            print("  ptxas maha_mma_tiled_kernel: %s, %s bytes of spill stores" % (
                re.search(r"Used \d+ registers", part).group(0), spill.group(1) if spill else 0))
    fns = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.pmc_fused_maha
        fn.argtypes, fn.restype = _build.signatures()["pmc_fused_maha"], ctypes.c_int
        lib.pmc_maha_per_sm.argtypes = [ctypes.c_int] * 3
        fns[name] = (fn, lib.pmc_maha_per_sm)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    result = {}
    for shape in MAHA_SPLIT_SHAPES:
        K, _, D, N = shape
        params = make_params(random_mixture(np.random.default_rng(K + D), K, D, True), device)
        xT = mixture_particles(core._kernel_operands(params), N, K + D, device)
        A, m, _ = vb_operands(params)
        ops = torch.cat([A.reshape(-1), m.reshape(-1)])
        scratch = torch.empty(_build.mma_scratch_floats(K, D), device=device)
        got = torch.empty((K, N), device=device)

        def call(name):
            fn, per_sm = fns[name]
            n_blocks = max(1, min(-(-N // _build.mma_tiled_plan()[0]), per_sm(K, D, 3) * n_sm))
            err = fn(xT.data_ptr(), ops.data_ptr(), scratch.data_ptr(), got.data_ptr(), N, K, D,
                     3, n_blocks, torch.cuda.current_stream(device).cuda_stream)
            require(err == 0, "maha_split: CUDA error %d" % err)

        call("all")
        compare("fused_maha split build K=%d D=%d" % (K, D), got, torch.cat(
            [k.plain_maha(xT.double(), A[k0:k1].double(), m[k0:k1].double())
             for k0, k1 in k._chunks(K, D, N)]), "maha", [])
        ms = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                ms[name].append(graph_ms(lambda i, name=name: call(name)))
        row = {name: sum(t) / len(t) for name, t in ms.items()}
        result["%d,%d" % (K, D)] = row
        print("  fused_maha K=%d D=%d N=%d: device ms %s; tensor-core bound %.4f ms" % (
            K, D, N, ", ".join("%s %.4f" % kv for kv in row.items()),
            bound_tc("fused_maha", shape)[1]), flush=True)
        del xT, A, m, ops, scratch, got
        torch.cuda.empty_cache()
    return result


def maha_sass():
    """``{Dp: (SASS instructions, HMMA instructions)}`` of the tensor-core
    kernel's instantiations (sass_opcodes; a loop's body once), and the
    opcodes of the D=40 one."""
    ops = sass_opcodes(MAHA_MMA_KERNELS)
    out = {}
    for part, counts in ops.items():
        dp = int(re.search(r"ILi(\d+)E", part).group(1))
        out[dp] = (sum(counts.values()), counts.get("HMMA", 0))
        print("  sass maha_mma_kernel<%d>: %d instructions, %d HMMA" % ((dp,) + out[dp]))
        if dp == 40:
            print("    opcodes: %s" % ", ".join(
                "%s %d" % kv for kv in sorted(counts.items(), key=lambda kv: -kv[1])[:24]))
    return out


# the slice shapes of the K-blocked kernels (K, Kt, D) in phase times
BLOCKED_SHAPES = {"fused_pmc_stats_blocked": (400, 0, 2), "fused_vb_estep_blocked": (400, 0, 2),
                  "fused_is_pmc_step_blocked": (200, 2, 10)}


# the K-blocked statistics kernels' first launch: kernel_work's name for
# its work (log q, fused_logq's; the VB E-step's log-sum-exp, the
# projections of fused_maha with one float a particle out) and its kernel's
# name in launch_split
FIRST_LAUNCH = {"fused_pmc_stats_blocked": ("fused_logq", "logq_kernel<"),
                "fused_vb_estep_blocked": ("vb_lse", "vb_lse_kernel<")}


def kernel_work(name, shape=None):
    """``(shape, bytes, operations, exps)`` of one call of ``name`` at
    ``shape`` (K, Kt, D, N), by default the one phase times gives it: each
    input read once and each output written once, the FP32 operations of the
    arithmetic (an FMA counts two; the random numbers' integer and
    transcendental work is not counted) and, for the K-blocked kernels, the
    exps a (particle, component) pair needs (the log-sum-exp's and the
    responsibility's; None elsewhere).  The flagship: a K=10 Student-t
    proposal, a Kt=2 target, D=10, N=2^22; the K-blocked kernels:
    BLOCKED_SHAPES at N=2^22; the pool: its shape is (C, Kt, D, steps), by
    default benchmarks/mcmc_chains.py's C=16384, D=10, a 1-component target,
    500 steps."""
    if name == "fused_mcmc_pool":
        C, Kt, D, n = shape or (MCMC_C, 1, MCMC_D, MCMC_STEPS)
        ev = Kt * (D * (D + 1) + 2 * D)
        # points out; x0, xf, cholr, e0, ef, accepts, NaN counts
        return ("C=%d D=%d Kt=%d %d steps" % (C, D, Kt, n),
                4 * (n * D * C + (2 * D + D * D + 4) * C), n * C * (D * (D + 1) + D + ev), None)
    K, Kt, D, N = shape or BLOCKED_SHAPES.get(name, (10, 2, 10)) + (N_PLAIN_MAX,)
    ev = lambda k: k * (D * (D + 1) + 2 * D)        # component log-densities a particle
    draw = D * (D + 1) + 2 * D                      # mu + scale * (L z)
    stats = K * (D * (D + 1) + 2 * D)               # sd and the lower Gram blocks
    dense = K * (2 * D * D + 3 * D)                 # a (x - m), full matrices
    upper = K * (D * (D + 1) + 3 * D)               # the same, a upper triangular
    work = {
        "fused_logq": (4 * (D + 1) * N, N * ev(K)),
        "fused_rho": (4 * (D + K + 1) * N, N * ev(K)),
        "fused_maha": (4 * (D + K) * N, N * dense),
        "vb_lse": (4 * (D + 1) * N, N * dense),
        "fused_pmc_stats": (4 * (D + 1) * N, N * (ev(K) + stats)),
        "fused_vb_estep": (4 * (D + 1) * N, N * (upper + stats)),
        "fused_propose_logq": (4 * (D + 3) * N, N * (draw + ev(K) + ev(Kt))),
        "fused_is_pmc_step": (4 * (D + 2) * N, N * (draw + ev(K) + ev(Kt) + stats)),
        "fused_transform": (4 * (2 * D + 2) * N, N * draw),
        "fused_transform_rng": (4 * (D + 1) * N, N * draw),
        "fused_pmc_stats_blocked": (4 * (D + 1) * N, N * (ev(K) + stats)),
        "fused_vb_estep_blocked": (4 * (D + 1) * N, N * (dense + stats)),
        "fused_is_pmc_step_blocked": (4 * (D + 2) * N, N * (draw + ev(K) + ev(Kt) + stats)),
        # reads the K thresholds and dofs, writes the component, D normals
        # and the scale; the K - 1 compares, ~2 operations a normal and ~20
        # for the chi-square
        "draw_proposal_inputs": ((4 + 4 * (D + 1)) * N + 8 * K, N * (K - 1 + 2 * D + 20)),
        # reads the K draw records, thresholds and dofs, writes the
        # component and x; the transform's operations (the draw's integer
        # and transcendental work is the issue floor's, fused_draw_floor)
        "fused_draw_transform": (4 * (D + 1) * N + 4 * K * (D + D * (D + 1) // 2 + 2), N * draw),
        "fused_draw_transform_rng": (4 * (D + 1) * N + 4 * K * (D + D * (D + 1) // 2 + 2),
                                     N * draw),
    }
    exps = 2 * K * N if name in BLOCKED_SHAPES else None
    return ("K=%d Kt=%d D=%d N=%d" % (K, Kt, D, N),) + work[name] + (exps,)


def bound(name, shape=None):
    """``(shape, least ms, "bytes" or "operations")``: the larger of the
    bytes over the memory rate and the operations over the FP32 rate."""
    shape, nbytes, ops, _ = kernel_work(name, shape)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return shape, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_tc(name, shape=None):
    """A tensor-core route's :func:`bound`: the larger of its bytes over the
    memory rate and its TF32 operations over the dense TF32 rate, the three
    split products (hi hi, hi lo, lo hi) of 2 K D^2 N each for fused_maha's
    general A, of 2 K D (D + 1) / 2 N each for fused_logq's and fused_rho's
    triangular U, at D: the zero products of D's padding to the mma depth
    of 8 (and of the blocks on U's diagonal) are a cost of the kernel, not
    work the function needs (fused_maha at K=32, D=40, 2^20: 322 GFLOP, 0.65
    ms; fused_logq at K=19, D=200, 2^16: 150 GFLOP, 0.30 ms)."""
    require(name in ("fused_maha", "fused_logq", "fused_rho"),
            "%s has no tensor-core route" % name)
    shape_s, nbytes, _, _ = kernel_work(name, shape)
    K, _, D, N = shape or (10, 2, 10, N_PLAIN_MAX)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    pairs = D * D if name == "fused_maha" else D * (D + 1) // 2
    t_ops = 3 * 2 * K * pairs * N / PEAK_TF32 * 1e3
    return shape_s, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def eval_bound(name, shape=None):
    """fused_maha's, fused_logq's or fused_rho's bound at ``shape`` for the
    kernel it elects there: :func:`bound_tc` where that is a tensor-core
    kernel, else :func:`bound`."""
    from pypmc_tpu_torch.ops import _build

    D = (shape or (10, 2, 10, N_PLAIN_MAX))[2]
    return (bound_tc if _build.eval_variant(name, D) == "mma" else bound)(name, shape)


def maha_bound(shape=None):
    """fused_maha's :func:`eval_bound`."""
    return eval_bound("fused_maha", shape)


def solve_dofs_entry(src, replaces, checks, counts, example_counts, times):
    """The kernels JSON's entry of solve_dofs: its times at SOLVE_DOFS_K
    (K=10 the main one) and its bound from :func:`solve_dofs_work` on the
    timed constants."""
    import torch

    rows = []
    for K in SOLVE_DOFS_K:
        nbytes, ops, _ = solve_dofs_work(dof_problem(K, K, "cpu", torch.float32)[0], DOF_STEPS)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
        rows.append({"shape": "K=%d steps=%d float32" % (K, DOF_STEPS),
                     "ms": times[("solve_dofs", K, "cuda")],
                     "device_ms": times[("solve_dofs", K, "device")],
                     "serial_ms": times[("solve_dofs", K, "serial")],
                     "serial_device_ms": times[("solve_dofs", K, "serial_device")],
                     "plain_ms": times[("solve_dofs", K, "plain")],
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    worst = max(checks, key=lambda r: r["max_abs_err"] / r["tol"])
    main, shapes = rows[0], rows[1:]
    return {"name": "solve_dofs", "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts["solve_dofs"], "max_abs_err": worst["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "shape": main["shape"],
            "variant": "warp", "device_ms": main["device_ms"], "serial_ms": main["serial_ms"],
            "serial_device_ms": main["serial_device_ms"],
            "max_abs_err_tol": worst["tol"],
            "max_abs_err_output": worst["output"],
            "launches_examples": example_counts.get("solve_dofs", 0), "shapes": shapes}


# the kernels that must not spill, with the largest DMAX checked: the
# K-blocked statistics pass's register accumulation and the step's first
# pass (DMAX 8 and 16), every record instantiation of fused_logq's,
# fused_rho's and fused_maha's kernels (DMAX 8 to 64), which must keep no
# local array either, and both variants of the pool up to DMAX 64 (the
# thread variant's record instantiations, DMAX 8/16/32/40/64; the warp
# variant's DMAX 32 and 64, with the rows of L in registers and without)
REGISTER_KERNELS = {"blocked_reg_stats_kernel": 16, "step_draw_kernel": 16, "dense_reg_kernel": 16,
                    "logq_kernel": 64, "maha_kernel": 64, "rho_kernel": 64,
                    "transform_rec_kernel": 64, "transform_rng_rec_kernel": 64,
                    "propose_logq_rec_kernel": 64, "mcmc_pool_kernel": 64,
                    "mcmc_pool_warp_kernel": 64, "draw_transform_rec_kernel": 64}
# the draws' record kernels (DMAX 8 to 64, records staged or not: two
# instantiations a DMAX) keep z and x in registers: no spill and no stack
# frame, as the record kernels of the evaluations
DRAW_RECORD_KERNELS = ("transform_rec_kernel", "transform_rng_rec_kernel",
                       "propose_logq_rec_kernel", "draw_transform_rec_kernel")
RECORD_KERNELS = ("logq_kernel", "maha_kernel", "rho_kernel") + DRAW_RECORD_KERNELS


def register_kernels(log):
    """``(kernel, registers, spill-store bytes, stack-frame bytes)`` of each
    instantiation of REGISTER_KERNELS up to its DMAX in a ``ptxas -v`` log."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        # the mangled name spells each identifier with its length first
        base = next((k for k in REGISTER_KERNELS if "%d%sI" % (len(k), k) in name), None)
        dmax = re.search(r"ILi(\d+)E", name)
        if base is None or dmax is None or int(dmax.group(1)) > REGISTER_KERNELS[base]:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        stack = re.search(r"(\d+) bytes stack frame", part)
        args = name[name.index(base) + len(base):].split("EEv")[0] + "E"
        out.append(("%s<%s>" % (base, ", ".join(re.findall(r"L[ib](\d+)E", args))),
                    int(regs.group(1)) if regs else -1, int(spill.group(1)) if spill else 0,
                    int(stack.group(1)) if stack else 0))
    # DMAX 8 and 16 of the first two and of the dense register kernel's
    # three modes, 8, 16, 32, 40 and 64 of the record kernels (twice for
    # the draws': records staged or not) and the thread pool, 32 and 64
    # twice of the warp pool
    require(len(out) >= (2 * 2 + 2 * 3 + 5 * (len(RECORD_KERNELS) + len(DRAW_RECORD_KERNELS))
                         + 5 + 2 * 2),
            "ptxas reported %d register kernels" % len(out))
    return out


# the draws' plan codes (csrc/common.cuh DrawPlan, csrc/tiled.cuh
# kDrawTiled)
DRAW_PLAN_CODES = ("looped", "rec", "tiled")
# the dense statistics kernels' passes (csrc/reg_stats.cuh DensePass)
DENSE_PASSES = ("table", "reg", "gram")


# the Gram pass's modes (csrc/gram_stats.cuh DenseMode) by their codes
GRAM_MODES = ("step", "vb", "stats")
GRAM_INSTANTIATIONS = ["gram_stats_kernel<%s, %d>" % (mode, minb)
                       for mode in GRAM_MODES for minb in (1, 2)]


def gram_kernels(log):
    """``(kernel, registers, spill-store bytes, stack-frame bytes)`` of the
    Gram pass's six instantiations (fused_is_pmc_step's step mode,
    fused_vb_estep's VB mode, fused_pmc_stats' statistics mode; each for
    one block an SM and, capped at 128 registers, two) in a ``ptxas -v``
    log; fails unless all are there."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        if "17gram_stats_kernelI" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        stack = re.search(r"(\d+) bytes stack frame", part)
        args = re.match(r"Li(\d+)ELi(\d+)E", name.split("17gram_stats_kernelI", 1)[1])
        out.append(("gram_stats_kernel<%s, %s>" % (GRAM_MODES[int(args.group(1))], args.group(2))
                    if args else name,
                    int(regs.group(1)) if regs else -1, int(spill.group(1)) if spill else 0,
                    int(stack.group(1)) if stack else 0))
    require(sorted(n for n, _, _, _ in out) == sorted(GRAM_INSTANTIATIONS),
            "ptxas reported the Gram pass's kernels %s" % [n for n, _, _, _ in out])
    return out
# the tiled engine's kernels (csrc/tiled.cuh), by their names' mangled
# spelling: the evaluations', fused_transform's product (two: ParticleTiles
# at K = 1, RunTiles), the bucket pass's two kernels (two each: the
# components given, GivenLatents, and drawn, DrawnLatents), the order of
# the moves into and out of bucket order (rank: transform.cu's and
# propose_logq.cu's) and the moves (in, and out in both), and the drawn
# products of fused_transform_rng and fused_propose_logq (eight: OFF 0 and
# 1, the seed by value and by pointer, RunTiles and ParticleTiles); and
# fused_maha's tensor-core kernel past D = 64 and its split of A
# (csrc/mma_tiled.cuh, maha.cu)
TILED_KERNELS = ("maha_tiled_kernel", "logq_tiled_kernel", "rho_tiled_kernel",
                 "transform_tiled_kernel", "bucket_count_kernel", "bucket_scatter_kernel",
                 "bucket_rank_kernel", "bucket_permute_kernel", "draw_tiled_kernel",
                 "maha_mma_tiled_kernel", "logq_mma_tiled_kernel", "rho_mma_tiled_kernel",
                 "mma_split_kernel")
# mma_split_kernel: <false> in maha.cu, <true> in logq.cu and in rho.cu
TILED_INSTANTIATIONS = {"transform_tiled_kernel": 2, "bucket_count_kernel": 2,
                        "bucket_scatter_kernel": 2, "bucket_rank_kernel": 2,
                        "bucket_permute_kernel": 3, "draw_tiled_kernel": 8,
                        "mma_split_kernel": 3}


def tiled_kernels(log):
    """``(kernel, registers, spill-store bytes, stack-frame bytes)`` of each
    instantiation of TILED_KERNELS in a ``ptxas -v`` log (a template's
    arguments in its name); fails unless each has its
    TILED_INSTANTIATIONS (one by default)."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        base = next((k for k in TILED_KERNELS if "%d%s" % (len(k), k) in name), None)
        if base is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        stack = re.search(r"(\d+) bytes stack frame", part)
        args = name.split(base, 1)[1]
        label = base + ("<%s>" % args[1:].split("Ev")[0] if args.startswith("I") else "")
        out.append((label, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else 0, int(stack.group(1)) if stack else 0))
    found = {k: sum(1 for n, _, _, _ in out if n.split("<")[0] == k) for k in TILED_KERNELS}
    require(found == {k: TILED_INSTANTIATIONS.get(k, 1) for k in TILED_KERNELS},
            "ptxas reported the tiled kernels %s" % [n for n, _, _, _ in out])
    return out


def mma_kernels(log):
    """``(kernel, registers, spill-store bytes, stack-frame bytes)`` of the
    tensor-core kernel's instantiations (MAHA_MMA_KERNELS) in a ``ptxas -v``
    log; fails unless all eight are there."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        hit = next((k for k in MAHA_MMA_KERNELS if name.startswith("_ZN3pmc" + k)), None)
        if hit is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        stack = re.search(r"(\d+) bytes stack frame", part)
        out.append(("maha_mma_kernel<%s>" % re.search(r"ILi(\d+)E", hit).group(1),
                    int(regs.group(1)) if regs else -1, int(spill.group(1)) if spill else 0,
                    int(stack.group(1)) if stack else 0))
    require(len(out) == len(MAHA_MMA_KERNELS),
            "ptxas reported the tensor-core kernels %s" % [n for n, _, _, _ in out])
    return out


def phase_build():
    """Build the kernel library (or load it, built), and hold the
    launchers' formulas and the ptxas report to what ops/_build.py and the
    register lists state; the library."""
    from pypmc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load()
    print("phase build: %.1f s (%s, %s)" % (time.perf_counter() - t0,
                                            _build.build_info.get("path"),
                                            "built" if _build.build_info.get("built") else "cached"))
    log = _build.build_info.get("log") or open(
        _build.build_info["path"][:-len(".so")] + ".log").read()
    secs = sorted(((float(t), name) for name, t in re.findall(
        r"-c -o \S+/(\w+)\.o \S+\n\[([\d.]+) s\]", log)), reverse=True)
    if secs:
        print("  nvcc seconds a source, slowest first: %s"
              % ", ".join("%s %.1f" % (name, t) for t, name in secs))
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
    if regs:
        print("  ptxas: %d kernels, %d-%d registers a thread, %d bytes of spill stores"
              % (len(regs), min(regs), max(regs), spills))
    for kernel, reg_count, spilled, stack in register_kernels(log):
        print("  ptxas %-44s %3d registers, %d bytes of spill stores, %d bytes of stack frame"
              % (kernel, reg_count, spilled, stack))
        require(spilled == 0, "%s spills %d bytes" % (kernel, spilled))
        require(stack == 0 or not kernel.startswith(RECORD_KERNELS),
                "%s keeps a %d-byte stack frame" % (kernel, stack))
    # the proposal inputs' draw: float and double, the seed by value and by
    # pointer
    draws = [(name, part) for name, part in (
        (p.split("'", 1)[0], p) for p in log.split("Compiling entry function '")[1:])
        if "11draw_kernelI" in name]
    require(len(draws) == 4, "ptxas reported %d draw_kernel instantiations" % len(draws))
    for name, part in draws:
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        spilled = int(spill.group(1)) if spill else 0
        print("  ptxas draw_kernel<%s, %s> %3d registers, %d bytes of spill stores"
              % ("double" if "draw_kernelIdL" in name else "float",
                 "pointer" if name.split("draw_kernelI", 1)[1][1:].startswith("Lb1") else "value",
                 int(regs.group(1)) if regs else -1, spilled))
        require(spilled == 0, "draw_kernel spills %d bytes" % spilled)
    # operands staged in shared memory, and (K=60, D=32; K=1, D=128) not;
    # the statistics kernels' 64-particle tile (K=120, D=1); the warp
    # kernels' slices (D=200)
    for K, Kt, D in ((10, 2, 10), (1, 1, 1), (4, 2, 7), (3, 1, 32), (30, 2, 10),
                     (2, 2, 40), (32, 2, 40), (60, 2, 32), (1, 1, 128), (400, 2, 2), (200, 2, 10),
                     (96, 2, 40), (12, 2, 10), (3, 1, 128), (21, 2, 10), (20, 2, 12), (8, 1, 16),
                     (5, 1, 1), (600, 2, 10), (5, 1, 64), (3, 1, 33), (4, 1, 128), (120, 2, 1),
                     (1, 1, 200), (2, 2, 1000), (16, 2, 10), (17, 2, 10), (11, 2, 11),
                     (8, 2, 16), (1, 1, 16), (2, 2, 16), (128, 2, 1), (136, 2, 1), (137, 2, 1),
                     (137, 0, 1), (40, 2, 9), (30, 2, 10), (4, 2, 4), (9, 2, 40), (11, 0, 40),
                     (40, 2, 40), (7, 0, 62), (4, 2, 62), (4, 2, 64), (40, 0, 64), (10, 0, 10),
                     (7, 2, 17), (6, 2, 20), (4, 1, 32), (2, 2, 64), (1, 2, 65), (1, 2, 96),
                     (1, 2, 128), (8, 2, 17), (2, 2, 65)):
        draw_smem = {}
        for kernel, ask in (("fused_transform", lambda out: lib.pmc_transform_plan(K, D, 0, out)),
                            ("fused_transform_rng",
                             lambda out: lib.pmc_transform_plan(K, D, 1, out)),
                            ("fused_propose_logq", lambda out: lib.pmc_propose_plan(K, Kt, D, out))):
            plan = (ctypes.c_int * 4)()
            draw_smem[kernel] = ask(plan)
            got = (DRAW_PLAN_CODES[plan[0]], bool(plan[1]), plan[2], plan[3], draw_smem[kernel])
            want = _build.draw_plan(kernel, K, D, Kt)
            require(got == want, "plan differs from the kernel's (%s, K=%d, Kt=%d, D=%d): %s, %s"
                    % (kernel, K, Kt, D, got, want))
        plan = (ctypes.c_int * 4)()
        smem = lib.pmc_draw_transform_plan(K, D, plan)
        got = (DRAW_PLAN_CODES[plan[0]], bool(plan[1]), plan[2], plan[3], smem)
        require(got == _build.draw_transform_plan(K, D),
                "plan differs from the kernel's (the fused draws, K=%d, D=%d): %s, %s"
                % (K, D, got, _build.draw_transform_plan(K, D)))
        launchers = [("fused_logq", lib.pmc_logq_smem_bytes(K, D)),
                     ("fused_propose_logq", draw_smem["fused_propose_logq"]),
                     ("fused_pmc_stats", lib.pmc_pmc_stats_smem_bytes(K, D)),
                     ("fused_is_pmc_step", lib.pmc_is_pmc_step_smem_bytes(K, Kt, D)),
                     ("fused_maha", lib.pmc_maha_smem_bytes(K, D)),
                     ("fused_rho", lib.pmc_rho_smem_bytes(K, D)),
                     ("fused_vb_estep", lib.pmc_vb_estep_smem_bytes(K, D)),
                     ("fused_transform", draw_smem["fused_transform"]),
                     ("fused_transform_rng", draw_smem["fused_transform_rng"]),
                     ("fused_mcmc_pool", lib.pmc_mcmc_pool_smem_bytes(K, D, 0)),
                     ("fused_pmc_stats_blocked", lib.pmc_pmc_stats_blocked_smem_bytes(K, D)),
                     ("fused_vb_estep_blocked", lib.pmc_vb_estep_blocked_smem_bytes(K, D)),
                     ("fused_is_pmc_step_blocked",
                      lib.pmc_is_pmc_step_blocked_smem_bytes(K, Kt, D))]
        for kernel, c in launchers:
            require(c == _build.smem_bytes(kernel, K, D, Kt),
                    "shared-memory formula differs from the kernel's (%s)" % kernel)
        for code, variant in enumerate(POOL_VARIANTS):
            require(lib.pmc_mcmc_pool_smem_bytes(K, D, code) == _build.pool_smem_bytes(K, D, variant),
                    "shared-memory formula differs from the kernel's (the %s pool)" % variant)
        require(lib.pmc_stats_tile(K, D) == _build.stats_tile(K, D),
                "tile formula differs from the kernel's (the statistics kernels)")
        for kernel, is_step in (("fused_pmc_stats", 0), ("fused_is_pmc_step", 1)):
            require(lib.pmc_stats_smem_bytes(K, Kt, D, is_step)
                    == _build._table_bytes(kernel, K, D, Kt),
                    "shared-memory formula differs from the kernel's (%s's entry table)"
                    % kernel)
        for kernel, mode in (("fused_is_pmc_step", 0), ("fused_vb_estep", 1),
                             ("fused_pmc_stats", 2)):
            out = (ctypes.c_int * 4)()
            smem = lib.pmc_dense_plan(K, Kt, D, mode, out)
            got = (DENSE_PASSES[out[0]], out[1], out[2], out[3], smem)
            require(got == _build.dense_plan(kernel, K, D, Kt),
                    "plan differs from the kernel's (%s, K=%d, D=%d): %s, %s"
                    % (kernel, K, D, got, _build.dense_plan(kernel, K, D, Kt)))
        for kernel, vb in (("fused_pmc_stats_blocked", 0), ("fused_vb_estep_blocked", 1)):
            require(lib.pmc_blocked_chunk(K, D, vb) == _build.blocked_plan(kernel, K, D)[0],
                    "chunk formula differs from the kernel's (%s)" % kernel)
        require(lib.pmc_step_draw_smem_bytes(K, Kt, D) == _build.draw_smem_bytes(K, Kt, D),
                "shared-memory formula differs from the kernel's (the step's first launch)")
        for code, kernel in enumerate(("fused_logq", "fused_maha", "fused_rho")):
            require(lib.pmc_eval_chunk(K, D, code) == _build.eval_plan(kernel, K, D)[0],
                    "chunk formula differs from the kernel's (%s)" % kernel)
        require(lib.pmc_rho_per_sm(K, D, -1) > 0, "fused_rho at K=%d, D=%d fits no block" % (K, D))
    for C in (1, 32, 4096, 4097, 8192, 8193, 32768, 32769, 1 << 20):
        for D in (1, 8, 9, 16, 17, 32, 33, 40, 41, 64, 65, 128):
            require(POOL_VARIANTS[lib.pmc_mcmc_pool_variant(C, D)] == _build.pool_variant(C, D),
                    "the pool's election differs from the kernel's (C=%d, D=%d)" % (C, D))
    # the dense register kernels' occupancy at the slices' K=10, D=10
    for kernel, per_sm in (("fused_is_pmc_step", lib.pmc_is_pmc_step_per_sm(10, 2, 10)),
                           ("fused_vb_estep", lib.pmc_vb_estep_per_sm(10, 10)),
                           ("fused_pmc_stats", lib.pmc_pmc_stats_per_sm(10, 10))):
        plan = _build.dense_plan(kernel, 10, 10, 2)
        print("  %s K=10 D=10: the %s pass, %d blocks of %d threads an SM (%d warps), %d slices, "
              "%d B of shared memory a block" % (kernel, plan[0], per_sm, _build.THREADS,
                                                 per_sm * _build.THREADS // 32, plan[2], plan[4]))
        require(plan[0] == "reg" and per_sm >= 3,
                "%s at K=10, D=10: the %s pass, %d blocks an SM" % (kernel, plan[0], per_sm))
    # the Gram pass of fused_pmc_stats, fused_is_pmc_step and
    # fused_vb_estep: registers, spills (none), and blocks an SM at
    # GRAM_SHAPES
    for name, regs, spilled, stack in gram_kernels(log):
        print("  ptxas %-44s %3d registers, %d bytes of spill stores, %d bytes of stack frame"
              % (name, regs, spilled, stack))
        require(spilled == 0, "%s spills %d bytes" % (name, spilled))
    for K, D in GRAM_SHAPES:
        for kernel, per_sm in (("fused_pmc_stats", lib.pmc_pmc_stats_per_sm(K, D)),
                               ("fused_is_pmc_step", lib.pmc_is_pmc_step_per_sm(K, 2, D)),
                               ("fused_vb_estep", lib.pmc_vb_estep_per_sm(K, D))):
            plan = _build.dense_plan(kernel, K, D, 2)
            print("  %s K=%d D=%d: the %s pass, %d blocks of %d threads an SM (%d warps), %d "
                  "slices of %d 8 x 8 blocks, %d B of shared memory a block"
                  % (kernel, K, D, plan[0], per_sm, _build._GRAM_THREADS,
                     per_sm * _build._GRAM_THREADS // 32, plan[2], plan[3], plan[4]))
            # two blocks an SM where two blocks' shared memory fits (the
            # instantiation capped at 128 registers), else one
            want = 2 if plan[4] <= _build._HALF_SMEM else 1
            require(plan[0] == "gram" and per_sm >= want,
                    "%s at K=%d, D=%d: the %s pass, %d blocks an SM (%d wanted)"
                    % (kernel, K, D, plan[0], per_sm, want))
    # fused_logq's, fused_maha's and fused_rho's election past D = 64 (the
    # tensor-core kernels) and the tiled plan; fused_maha's tensor-core
    # kernel from D = 9 to 64 (csrc/mma.cuh kMahaMmaDMin) and its plan
    for D in range(1, 301):
        require(("looped", "rec", "tiled", "mma")[lib.pmc_eval_variant(D)]
                == _build.eval_variant("fused_logq", D) == _build.eval_variant("fused_rho", D),
                "the election differs from the kernel's (fused_logq, fused_rho, D=%d)" % D)
        require(("looped", "rec", "tiled", "mma")[lib.pmc_maha_variant(D)]
                == _build.eval_variant("fused_maha", D),
                "the election differs from the kernel's (fused_maha, D=%d)" % D)
    for D in range(1, 65):
        for K in (1, 2, 3, 31, 32, 62, 98, 123, 193, 225, 240, 454, 2040):
            out = (ctypes.c_int * 5)()
            smem = lib.pmc_maha_mma_plan(K, D, out)
            got = tuple(out) + (smem,)
            want = _build.mma_plan(K, D)
            require(got == want and smem <= _build._HALF_SMEM,
                    "the tensor-core plan differs from the kernel's (K=%d, D=%d): %s, %s"
                    % (K, D, got, want))
    mma = mma_kernels(log)
    for name, regs, spilled, stack in mma:
        print("  ptxas %-44s %3d registers, %d bytes of spill stores, %d bytes of stack frame"
              % (name, regs, spilled, stack))
    for name, regs, spilled, stack in mma:
        require(spilled == 0, "%s spills %d bytes" % (name, spilled))
    for K, D in ((1, 8), (454, 8), (240, 16), (225, 17), (32, 40), (98, 40), (62, 64)):
        per_sm = lib.pmc_maha_per_sm(K, D, 3)
        kc, n_chunks, x_buffers, tile, _, smem = _build.mma_plan(K, D)
        print("  fused_maha K=%d D=%d: the tensor-core kernel, %d blocks of %d threads an SM, "
              "%d particles a tile, %d x tiles, %d components a chunk x %d chunks, %d B of shared "
              "memory a block" % (K, D, per_sm, _build.eval_threads(D, "mma"), tile, x_buffers,
                                  kc, n_chunks, smem))
        require(per_sm >= 2,
                "fused_maha's tensor-core kernel at K=%d, D=%d: %d blocks an SM" % (K, D, per_sm))
    plan = (ctypes.c_int * 4)()
    smem = lib.pmc_tiled_plan(plan)
    require(tuple(plan) + (smem,) == _build.tiled_plan(),
            "the tiled plan differs from the kernel's: %s, %s"
            % (tuple(plan) + (smem,), _build.tiled_plan()))
    # the tiled kernels, the bucket pass and the moves: registers, spills
    # (none), stack frames
    for name, regs, spilled, stack in tiled_kernels(log):
        print("  ptxas %-44s %3d registers, %d bytes of spill stores, %d bytes of stack frame"
              % (name, regs, spilled, stack))
        require(spilled == 0, "%s spills %d bytes" % (name, spilled))
    # fused_maha's tensor-core kernel past D = 64: its plan and its split
    # operand's size against _build's
    mt = (ctypes.c_int * 5)()
    mt_smem = lib.pmc_maha_mma_tiled_plan(mt)
    require(tuple(mt) + (mt_smem,) == _build.mma_tiled_plan(),
            "the tensor-core plan past D = 64 differs from the kernel's: %s, %s"
            % (tuple(mt) + (mt_smem,), _build.mma_tiled_plan()))
    for K, D in ((1, 65), (60, 65), (41, 96), (30, 129), (19, 200), (1, 1000), (1, 2040),
                 (3, 4096)):
        require(lib.pmc_maha_mma_scratch_floats(K, D) == _build.mma_scratch_floats(K, D),
                "the split operand's size differs from the kernel's (K=%d, D=%d)" % (K, D))
    for K, D in ((1, 65), (60, 65), (1, 200), (4, 200), (19, 200), (1, 2040)):
        for kernel, variant, per_sm in (
                ("fused_maha", _build.eval_variant("fused_maha", D), lib.pmc_maha_per_sm(K, D, -1)),
                ("fused_maha", "tiled", lib.pmc_maha_per_sm(K, D, 2)),
                ("fused_logq", _build.eval_variant("fused_logq", D), lib.pmc_logq_per_sm(K, D, -1)),
                ("fused_logq", "tiled", lib.pmc_logq_per_sm(K, D, 2)),
                ("fused_rho", _build.eval_variant("fused_rho", D), lib.pmc_rho_per_sm(K, D, -1)),
                ("fused_rho", "tiled", lib.pmc_rho_per_sm(K, D, 2))):
            threads = _build.eval_threads(D, variant)
            print("  %s K=%d D=%d: the %s kernel, %d blocks of %d threads an SM (%d warps), "
                  "%d B of shared memory a block"
                  % (kernel, K, D, variant, per_sm, threads, per_sm * threads // 32,
                     _build.eval_plan(kernel, K, D, variant)[2]))
            # the tensor-core kernel: one block of 8 warps an SM (its 128
            # accumulators a thread)
            require(per_sm >= (1 if variant == "mma" else 2),
                    "%s at K=%d, D=%d: %d blocks an SM" % (kernel, K, D, per_sm))
    per_sm = lib.pmc_transform_tiled_per_sm()
    print("  fused_transform from D=%d: the tiled kernel, %d blocks of %d threads an SM (%d "
          "warps), %d B of shared memory a block"
          % (_build.TRANSFORM_TILED_D_MIN, per_sm, plan[3], per_sm * plan[3] // 32, smem))
    require(per_sm >= 2, "fused_transform's tiled kernel: %d blocks an SM" % per_sm)
    # the drawn products from DRAW_TILED_D_MIN, their shared memory growing
    # past D = 128 by row tile 0's panels
    for D in (65, 128, 129, 200, 2040):
        drawn = lib.pmc_draw_tiled_per_sm(D)
        print("  fused_transform_rng and fused_propose_logq D=%d: the drawn product, %d blocks of "
              "%d threads an SM, %d B of shared memory a block"
              % (D, drawn, plan[3], _build.draw_tiled_smem(D)))
        require(drawn >= 2, "the drawn product at D=%d: %d blocks an SM" % (D, drawn))
    for K in (1, 4, 19, 60, 1000):
        out = (ctypes.c_int * 3)()
        bsmem = lib.pmc_transform_bucket_plan(K, out)
        got = (out[0], out[1], out[2], bsmem)
        require(got == _build.transform_bucket_plan(K),
                "the bucket plan differs from the kernel's (K=%d): %s, %s"
                % (K, got, _build.transform_bucket_plan(K)))
    # the bucket pass's scratch and fused_transform's pair's
    for N, K, D in ((1, 2, 65), (4099, 60, 65), (1 << 16, 19, 200), (N_WIDE, 30, 129),
                    (1 << 20, 4, 200), ((1 << 20) + 3, 7, 96), (1 << 24, 3, 65)):
        out = (ctypes.c_longlong * 7)()
        lib.pmc_transform_layout(N, K, D, out)
        require(tuple(out) == _build.transform_layout(N, K, D),
                "the bucket layout differs from the kernel's (N=%d, K=%d, D=%d): %s, %s"
                % (N, K, D, tuple(out), _build.transform_layout(N, K, D)))
    # the record kernels' occupancy where the main paths run them (fused_maha's
    # tensor-core kernel's, where it is elected, above)
    for K, D in ((32, 40), (200, 10)):
        for kernel, per_sm in (("fused_maha", lib.pmc_maha_per_sm(K, D, 1)),
                               ("fused_logq", lib.pmc_logq_per_sm(K, D, -1)),
                               ("fused_rho", lib.pmc_rho_per_sm(K, D, -1))):
            warps = per_sm * _build.EVAL_THREADS // 32
            kc, buffers, smem = _build.eval_plan(kernel, K, D, "rec")
            print("  %s K=%d D=%d: the record kernel (%s elected), %d blocks of %d threads an SM "
                  "(%d warps), %d components a chunk x %d buffers, %d B of shared memory a block"
                  % (kernel, K, D, _build.eval_variant(kernel, D), per_sm, _build.EVAL_THREADS,
                     warps, kc, buffers, smem))
            require(warps >= 16, "%s at K=%d, D=%d: %d warps an SM" % (kernel, K, D, warps))
    # the draws' record kernels where the main paths run them, their records
    # staged: fused_transform at the D=40 pipeline's K=32 (two blocks an SM)
    # and the flagship; fused_transform_rng at the flagship and the K=11,
    # D=40 route; fused_propose_logq at the flagship (K=10, Kt=2) and the
    # widest K the rule admits at D=40 (K=9, Kt=2); the fused draws where
    # propose_T takes them for those two transforms
    for kernel, K, Kt, D, per_sm in (
            ("fused_transform", 32, 0, 40, lib.pmc_transform_per_sm(32, 40, 0)),
            ("fused_transform", 10, 0, 10, lib.pmc_transform_per_sm(10, 10, 0)),
            ("fused_transform_rng", 10, 0, 10, lib.pmc_transform_per_sm(10, 10, 1)),
            ("fused_transform_rng", 11, 0, 40, lib.pmc_transform_per_sm(11, 40, 1)),
            ("fused_propose_logq", 10, 2, 10, lib.pmc_propose_per_sm(10, 2, 10)),
            ("fused_propose_logq", 9, 2, 40, lib.pmc_propose_per_sm(9, 2, 40)),
            ("fused_draw_transform", 32, 0, 40, lib.pmc_draw_transform_per_sm(32, 40, 0)),
            ("fused_draw_transform", 10, 0, 10, lib.pmc_draw_transform_per_sm(10, 10, 0)),
            ("fused_draw_transform_rng", 10, 0, 10, lib.pmc_draw_transform_per_sm(10, 10, 1)),
            ("fused_draw_transform_rng", 11, 0, 40, lib.pmc_draw_transform_per_sm(11, 40, 1))):
        plan = (_build.draw_transform_plan(K, D) if kernel in FUSED_DRAWS
                else _build.draw_plan(kernel, K, D, Kt))
        print("  %s K=%d Kt=%d D=%d: the %s kernel, %d blocks of %d threads an SM (%d warps), "
              "draw records of %d floats staged %s, %d B of shared memory a block"
              % (kernel, K, Kt, D, plan[0], per_sm, plan[3], per_sm * plan[3] // 32, plan[2],
                 plan[1], plan[4]))
        require(plan[0] == "rec" and plan[1] and per_sm * plan[3] // 32 >= 16,
                "%s at K=%d, D=%d: %s, %d blocks an SM" % (kernel, K, D, plan, per_sm))

    return lib


# --------------------------------------------------------------------- #

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        import pypmc_tpu_torch  # noqa: F401
        from pypmc_tpu_torch.ops import _build
        from pypmc_tpu_torch.ops import kernels as k
    except ImportError as e:
        print("chip_smoke: the package is not beside this script: %s" % e, file=sys.stderr)
        return 2
    require("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print("phase device: %s | torch %s cuda %s | %s" % (card, torch.__version__,
                                                          torch.version.cuda, name))

    phase_build()

    clock = []

    def phase(title):
        """Print the last phase's seconds (host clock) and the next one's title."""
        now = time.perf_counter()
        if clock:
            print("  phase %s: %.1f s" % (clock[0], now - clock[1]))
        clock[:] = [title.split()[0], now]
        if title != "end":
            print("phase %s:" % title)

    phase("kernels")
    report = phase_kernels(device, KERNEL_CASES, EVAL_CASES)

    phase("slice")
    slice_reference(device, report)
    counts, step_ms, out = phase_slice(device)
    require(tuple(out.means.shape) == (10, 10) and tuple(out.cov.shape) == (10, 10, 10),
            "slice: adapted mixture of the wrong shape")
    dofs_before_after(device, 10)
    del out
    torch.cuda.empty_cache()

    phase("scan")
    scan_counts = phase_scan(device)

    phase("vb")
    vb_counts, vb_ms, vb_busy = phase_vb(device, report)
    vb_float32_fits(device)
    phase("gate")
    gate_counts = phase_gate(device, report)
    torch.cuda.empty_cache()
    phase("blocked")
    blocked_counts, _ = phase_blocked(device, report)
    torch.cuda.empty_cache()
    phase("routes")
    route_counts = phase_routes(device, report)
    phase("wide")
    wide_counts = phase_wide(device, report)
    phase("wide_is")
    wide_is_counts = phase_wide_is(device, report)
    phase("wide_pmc")
    wide_pmc_counts = phase_wide_pmc(device, report)
    phase("wide_vb")
    wide_vb_counts = phase_wide_vb(device, report)
    phase("mcmc")
    mcmc_counts, _ = phase_mcmc(device)
    torch.cuda.empty_cache()
    phase("pipeline")
    pipe_counts, _ = phase_pipeline(device)
    torch.cuda.empty_cache()
    phase("parallel")
    parallel_counts = phase_parallel(card)
    phase("examples")
    example_counts = phase_examples(device, report)
    torch.cuda.empty_cache()
    # every path was driven with the counts set to 0 just before it
    counts = {n: sum(c.get(n, 0) for c in (counts, scan_counts, vb_counts, gate_counts,
                                           blocked_counts, route_counts, wide_counts,
                                           wide_is_counts, wide_pmc_counts, wide_vb_counts,
                                           mcmc_counts,
                                           pipe_counts,
                                           parallel_counts,
                                           example_counts))
              for n in counts}
    for kname in SOURCES:
        require(counts[kname] > 0, "%s was launched by no path" % kname)
    require(wide_counts["variant:fused_maha=mma"] > 0,
            "fused_maha's tensor-core kernel past D = 64 was launched by no path")
    for kname in ("fused_logq", "fused_rho"):
        require(wide_counts["variant:%s=mma" % kname] > 0,
                "%s's tensor-core kernel past D = 64 was launched by no path" % kname)

    phase("times (%s)" % card)
    times = phase_times(device, report)
    floors = {}   # the SASS issue floors: --draw-floor
    phase("end")

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        checks = [r for r in report if "max_abs_err" in r and (
            r["output"] == kname or r["output"].startswith(kname + " "))]
        require(checks, "%s: no check against its plain version" % kname)
        if kname == "solve_dofs":
            kernels.append(solve_dofs_entry(src, replaces, checks, counts, example_counts, times))
            continue
        # the SASS issue floors of its instantiations at the shapes FLOOR_KERNELS names
        issue_floors = [{"shape": bound(row, sh)[0], "sass_instructions": c, "issue_floor_ms": f}
                        for (row, sh), (c, f) in floors.items() if row == kname]
        if kname in FUSED_DRAWS:
            kernels.append(fused_draw_entry(kname, src, replaces, checks, counts, example_counts,
                                            times, floors))
            continue
        if kname == "draw_proposal_inputs":
            kernels.append(dict(draw_entry(src, replaces, checks, counts, example_counts, times),
                                issue_floors=issue_floors))
            continue
        # the kernel-vs-plain comparison on the same inputs; for the pool,
        # whose points are a random walk, the kernel's and the plain pool's
        # whitened step moments; a check against the known distribution only
        # where the output is random numbers and nothing else
        if kname == "fused_mcmc_pool":
            checks = [r for r in checks if r["output"].startswith(kname + " walk vs plain")]
        else:
            checks = [r for r in checks if not r.get("statistical")] or checks
        worst = max(checks, key=lambda r: r["max_abs_err"] / r["tol"])
        n = MCMC_C if kname == "fused_mcmc_pool" else N_PLAIN_MAX
        shape, bound_ms, bound_by = maha_bound() if kname == "fused_maha" else bound(kname)
        exps = kernel_work(kname)[3]
        entry = {
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[kname], "max_abs_err": worst["max_abs_err"],
            "ms": times[(kname, n, "cuda")], "plain_ms": times[(kname, n, "plain")],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "shape": shape,
            "max_abs_err_tol": worst["tol"], "max_abs_err_output": worst["output"],
            "launches_examples": example_counts.get(kname, 0),
        }
        if (kname, N_SLICE, "cuda") in times:
            entry.update(ms_slice_n=times[(kname, N_SLICE, "cuda")], slice_n=N_SLICE)
        if (kname, n, "table") in times:
            # the register pass's two kernels: the pass elected at the
            # shape, and the entry-table pass's times there
            entry.update(variant=_build.dense_plan(kname, 10, 10, 2)[0],
                         table_ms=times[(kname, n, "table")],
                         table_ms_slice_n=times[(kname, N_SLICE, "table")])
        for sn in (n, N_SLICE):
            if (kname, sn, "split") in times:
                entry["launch_ms" if sn == n else "launch_ms_slice_n"] = times[(kname, sn, "split")]
        if exps is not None:
            entry["exps"] = exps
        shapes = MAIN_SHAPES.get(kname, []) + ([WIDE_SHAPE] if kname in _build.WIDE else [])
        shapes += TILED_SHAPES if kname in _build.TILED else []
        shapes += GRAM_TIME_SHAPES if kname in _build._DENSE else []
        # the shapes this run timed (the A/Bs of earlier PRs behind flags)
        shapes = [sh for sh in shapes if (kname, sh, "cuda") in times]
        extra = {"looped": "looped_ms", "tiled": "tiled_ms", "library": "library_ms",
                 "bucket": "bucket_device_ms", "product": "product_device_ms",
                 "table": "table_ms", "mma": "mma_ms", "rec": "rec_ms",
                 **{v + "_device": v + "_device_ms" for v in MAHA_VARIANTS + ("library",)}}
        entry["shapes"] = [dict({"shape": bound(kname, sh)[0], "ms": times[(kname, sh, "cuda")],
                                 "plain_ms": times[(kname, sh, "plain")],
                                 "bound_ms": bound(kname, sh)[1]},
                                **{key: times[(kname, sh, route)] for route, key in extra.items()
                                   if (kname, sh, route) in times})
                           for sh in shapes]
        if kname in _build.TILED:
            entry["tiled_d_min"] = (_build.TRANSFORM_TILED_D_MIN if kname == "fused_transform"
                                    else _build.TILED_D_MIN)
        if kname == "fused_maha":
            # the kernel elected at each shape; where it is the tensor-core
            # kernel, bound_ms is its tensor-core bound, the FP32 one beside
            entry.update(variant=_build.eval_variant(kname, 10), bound_fp32_ms=bound(kname)[1],
                         launches_mma=counts["variant:fused_maha=mma"],
                         mma_d_min=_build.MAHA_MMA_D_MIN)
            # past D = 64 the paneled tensor-core kernel (and its split of
            # A, one launch before each): its launches on the wide paths,
            # which run fused_maha only past D = 64
            entry["mma_tiled_kernel"] = {
                "name": "maha_mma_tiled_kernel, mma_split_kernel<false>",
                "source": "pypmc_tpu_torch/csrc/mma_tiled.cuh",
                "launches": sum(c["variant:fused_maha=mma"] for c in (wide_counts,
                                                                      wide_is_counts))}
        if kname in ("fused_logq", "fused_rho"):
            # past D = 64 the paneled tensor-core kernel on U's lower
            # triangle (and its split of U, one launch before each): its
            # launches on the main paths
            entry["mma_tiled_kernel"] = {
                "name": "%s_mma_tiled_kernel, mma_split_kernel<true>" % kname[len("fused_"):],
                "source": "pypmc_tpu_torch/csrc/mma_tiled.cuh",
                "launches": counts["variant:%s=mma" % kname]}
        if kname in ("fused_maha", "fused_logq", "fused_rho"):
            for sh, row in zip(shapes, entry["shapes"]):
                row.update(variant=_build.eval_variant(kname, sh[2]),
                           bound_ms=eval_bound(kname, sh)[1], bound_fp32_ms=bound(kname, sh)[1])
        if kname in _build._DENSE:
            # past D = 16 the Gram pass: its launches on the main paths
            entry["launches_gram"] = counts["variant:%s=gram" % kname]
        if kname == "fused_transform":
            # at K > 1 the tiled pair's bucket pass and moves, one each a
            # tiled launch; the bucket pass's device time is the shapes'
            # bucket_device_ms
            entry["bucket_kernel"] = {"name": "bucket_count_kernel, bucket_scatter_kernel, "
                                              "bucket_rank_kernel, bucket_permute_kernel",
                                      "source": "pypmc_tpu_torch/csrc/tiled.cuh",
                                      "launches": counts["variant:fused_transform=tiled"]}
        if (kname, n, "looped") in times:
            # a draw kernel's elected kernel at the shape, and the looped
            # kernel's time there
            entry.update(variant=_build.draw_plan(kname, 10, 10, 2)[0],
                         looped_ms=times[(kname, n, "looped")])
        if (kname, n, "pointer") in times:
            # its seed words read from a tensor on the card
            entry["pointer_ms"] = times[(kname, n, "pointer")]
        if kname in DRAWN_TIMED:
            # past D = 64 the drawn product: the draw's issue floor at
            # WIDE_SHAPE beside its time there, and its launches
            if ("drawn", WIDE_SHAPE) in floors:
                per_normal, floor = floors[("drawn", WIDE_SHAPE)]
                entry["shapes"][-1].update(draw_issue_floor_ms=floor,
                                           draw_sass_a_normal=per_normal)
            entry.update(tiled_d_min=_build.DRAW_TILED_D_MIN,
                         launches_tiled=counts["variant:%s=tiled" % kname])
        if kname in FIRST_LAUNCH:
            # the first launch alone: its device time beside its bound
            work, kernel = FIRST_LAUNCH[kname]
            sh = BLOCKED_SHAPES[kname] + (N_PLAIN_MAX,)
            first = [ms for key, ms in entry["launch_ms"].items() if key.startswith(kernel)]
            require(len(first) == 1, "%s: no one first launch in %s" % (kname, entry["launch_ms"]))
            entry["shapes"].append({"shape": "first launch %s %s" % (kernel.rstrip("<"),
                                                                   bound(work, sh)[0]),
                                    "launch_ms": first[0], "bound_ms": bound(work, sh)[1]})
        if kname == "fused_mcmc_pool":
            entry["shapes"] = [dict({"shape": bound(kname, sh)[0], "bound_ms": bound(kname, sh)[1],
                                     "plain_ms": times.get((kname, sh, "plain")),
                                     "elected": _build.pool_variant(sh[0], sh[2])},
                                    **{"ms_" + v: times[(kname, sh, v)] for v in POOL_VARIANTS})
                               for sh in POOL_SHAPES + POOL_SWEEP
                               if (kname, sh, "thread") in times]
        if not entry["shapes"]:
            del entry["shapes"]
        if issue_floors:
            entry["issue_floors"] = issue_floors
        kernels.append(entry)
    print("ms and plain_ms at the shape given, ms_slice_n at N=%d; max_abs_err is |kernel - "
          "plain| of the kernel's check nearest its tolerance (for fused_transform_rng, a "
          "sample mean against the mixture's; for fused_mcmc_pool, the kernel's and the plain "
          "pool's whitened step moments at D=40); bound_ms from bytes over %.3g B/s and FP32 "
          "operations over %.3g op/s (exps: the K-blocked kernels' exps, not in the bound; "
          "launch_ms: their launches' device times, torch.profiler; shapes: fused_maha, "
          "fused_logq, fused_rho and the draws at the main paths' shapes, plain_ms past N=%d "
          "the plain "
          "version streamed over component chunks; the six kernels past D=128 at K=1, "
          "D=200, N=2^16 (the draws' draw_issue_floor_ms there: N / 32 x D x "
          "draw_sass_a_normal, the record draws' SASS instructions a normal at D=40, over "
          "4 x SMs x the largest SM clock; launches_tiled their drawn products' launches); "
          "fused_maha, fused_logq, fused_rho and fused_transform past D=64 at TILED_SHAPES "
          "(N=2^16): ms the elected kernel's, tiled_ms the tiled kernel's, "
          "library_ms one torch.bmm of the pre-centred operand (fused_transform: of L on "
          "pre-bucketed normals; the product alone, FP32, never called by the port), "
          "fused_transform's device times in CUDA graphs (bucket_device_ms its bucket pass, 0 "
          "at K=1, product_device_ms the rest: the moves into and out of bucket order and the "
          "product; library_device_ms torch.bmm's), fused_maha at K=32, D=40, 2^20 also mma_ms, rec_ms and tiled_ms, "
          "its three kernels forced, and their and torch.bmm's device times in CUDA graphs "
          "(*_device_ms; variant: the one it elects; bound_ms the tensor-core bound, "
          "three split TF32 products at D (not padded) over %.3g op/s, where that is the "
          "tensor-core kernel, bound_fp32_ms the FP32 one; launches_mma its launches; past D=64 "
          "at TILED_SHAPES mma_ms the tensor-core kernel's, elected, tiled_ms the tiled kernel's, "
          "forced, *_device_ms both kernels' and torch.bmm's device times; mma_tiled_kernel: the "
          "paneled tensor-core kernel past D=64, its launches on the wide paths); fused_pmc_stats, fused_is_pmc_step and fused_vb_estep at GRAM_TIME_SHAPES "
          "(K D <= 128, "
          "D = 17-128, a one-component target, N=2^20): ms the Gram pass's, table_ms the "
          "entry table's, launches_gram the Gram pass's launches; "
          "the K-blocked statistics kernels' first launch, launch_ms, beside its "
          "bound; the pool's two variants, ms_thread and ms_warp, at the pipeline's and the "
          "mcmc phase's shapes and at POOL_SWEEP's, plain_ms null there; variant: the pass "
          "fused_vb_estep, fused_is_pmc_step and fused_pmc_stats elect at K=10, D=10, table_ms "
          "and table_ms_slice_n their entry-table pass there, and the kernel the three draws "
          "elect there, looped_ms their looped kernels there and at the shapes; "
          "launches_examples: the launches of phase examples, counted in launches); "
          "solve_dofs at K=10, 100 bisection steps, float32 (shapes: K=200, 400), ms its warp "
          "kernel's, the default (CUDA events, back to back; device_ms by torch.profiler), "
          "serial_ms and serial_device_ms the serial kernel's (variant='serial'), its "
          "max_abs_err the |float64 condition| at its worst root against that root's "
          "tolerance, bound_ms its bytes and FP operations on this data (its serial-latency "
          "model is in phase times); pointer_ms: fused_transform_rng with its seed words "
          "read from a tensor on the card; draw_proposal_inputs at K=32, D=40, N=2^20, "
          "Student-t, float32 (shapes: float64, and the components only), plain_ms its plain "
          "version (torch.rand, torch.randn and the chi-square, which it replaced on the "
          "card), its max_abs_err a frequency's difference from the plain version's or a "
          "normals' mean, against 6 standard errors; fused_draw_transform (at K=32, D=40, "
          "N=2^20, Student-t) and fused_draw_transform_rng (at K=10, D=10, N=2^22): "
          "two_launch_ms the two launches each replaces (draw_proposal_inputs, then "
          "fused_transform or fused_transform_rng), timed in turns with it, max_abs_err the "
          "largest |one launch - two launches| of bit_checks bit-equality checks, "
          "issue_floor_ms N / 32 warps x sass_instructions / (4 x SMs x the largest SM clock) "
          "(issue_floors: the same for the record kernels and draw_kernel it replaces, a loop's "
          "body counted once); "
          "library_ms null: no one PyTorch call computes these functions"
          % (N_SLICE, PEAK_BYTES, PEAK_FP32, N_PLAIN_MAX, PEAK_TF32))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--chunk-sweep"]:
            import torch

            print(card_line())
            phase_build()
            chunk_sweep(torch.device("cuda", 0))
            sys.exit(0)
        if sys.argv[1:2] == ["--elected-times"]:
            # the kernels TILED_TIMED's wrappers elect at TILED_SHAPES in the
            # checkout at sys.argv[2] (an earlier commit unpacked under a
            # directory .gitignore lists, or "."), its library built there
            sys.path.insert(0, sys.argv[2])
            import torch

            print(card_line())
            dev = torch.device("cuda", 0)
            if sys.argv[3:4] != ["drawn"]:
                print("ELECTED_MS " + json.dumps(
                    {"%d,%d" % (sh[0], sh[2]): elected_ms(dev, sh) for sh in TILED_SHAPES}),
                    flush=True)
            # the kernels DRAWN_TIMED's wrappers elect at DRAWN_SHAPES
            print("DRAWN_ELECTED_MS " + json.dumps(
                {"%d,%d,%d" % sh[:3]: drawn_elected_ms(dev, sh) for sh in DRAWN_SHAPES}),
                flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--drawn-times"]:
            # phase build, then drawn_shape_ms at DRAWN_SHAPES and the library
            # yardsticks at LIBRARY_SHAPES
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            print(card_line())
            phase_build()
            dev = torch.device("cuda", 0)
            print("DRAWN_MS " + json.dumps(
                {"%d,%d,%d" % sh[:3]: {"%s %s" % key: ms for key, ms
                                       in drawn_shape_ms(dev, sh).items()}
                 for sh in DRAWN_SHAPES}), flush=True)
            print("LIBRARY_MS " + json.dumps(
                {"%d,%d" % (sh[0], sh[2]): {"%s %s" % key: ms for key, ms
                                             in library_shape_ms(dev, sh).items()}
                 for sh in LIBRARY_SHAPES}), flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--library-times"]:
            # phase build, then the library yardsticks at the shapes given
            # as K,Kt,D,N
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            print(card_line())
            phase_build()
            dev = torch.device("cuda", 0)
            shapes = [tuple(int(v) for v in arg.split(",")) for arg in sys.argv[2:]]
            print("LIBRARY_MS " + json.dumps(
                {"%d,%d,%d" % (sh[0], sh[2], sh[3]): {"%s %s" % key: ms for key, ms
                                                      in library_shape_ms(dev, sh).items()}
                 for sh in shapes}), flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--gram-times"]:
            # phase build, then rows 7-9 at GRAM_TIME_SHAPES (the Gram pass,
            # the entry table, the plain version)
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            print(card_line())
            phase_build()
            dev = torch.device("cuda", 0)
            print("GRAM_MS " + json.dumps(
                {"%d,%d" % (sh[0], sh[2]): {"%s %s" % (key[0], key[2]): ms for key, ms
                                             in table_shape_ms(dev, sh).items()}
                 for sh in GRAM_TIME_SHAPES}), flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--maha-times"]:
            # phase build, then fused_maha's three kernels, torch.bmm and
            # the plain version at MAHA_TIME_SHAPES, and the tensor-core
            # kernel's SASS; then (alone with "wide") its kernels and
            # torch.bmm past D = 64 at MAHA_WIDE_SHAPES, device times
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            print(card_line())
            phase_build()
            dev = torch.device("cuda", 0)
            if sys.argv[2:3] != ["wide"]:
                print("MAHA_SASS " + json.dumps(maha_sass()), flush=True)
                print("MAHA_MS " + json.dumps(
                    {"%d,%d" % (sh[0], sh[2]): maha_shape_ms(dev, sh, [])
                     for sh in MAHA_TIME_SHAPES}), flush=True)
            print("MAHA_WIDE_MS " + json.dumps(
                {"%d,%d" % (sh[0], sh[2]): maha_wide_ms(dev, sh, []) for sh in MAHA_WIDE_SHAPES}),
                flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--tiled-times"]:
            # phase build, then tiled_shape_ms at TILED_SHAPES, every
            # TILED_TIMED kernel timed
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            print(card_line())
            phase_build()
            dev = torch.device("cuda", 0)
            print("TILED_MS " + json.dumps(
                {"%d,%d" % (sh[0], sh[2]): {"%s %s" % key: ms for key, ms
                                             in tiled_shape_ms(dev, sh).items()}
                 for sh in TILED_SHAPES}), flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--maha-split"]:
            # fused_maha's tensor-core kernel past D = 64 with parts left out
            import torch

            print(card_line())
            src = sys.argv[2] if len(sys.argv) > 2 else None
            out_dir = "build/maha_split" + ("_" + re.sub(r"\W", "_", src) if src else "")
            print("MAHA_SPLIT " + json.dumps(maha_split(torch.device("cuda", 0), out_dir, src)),
                  flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--transform-split"]:
            # fused_transform's pair with parts of its data movement left out
            import torch

            print(card_line())
            print("TRANSFORM_SPLIT " + json.dumps(transform_split(torch.device("cuda", 0))),
                  flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--wide-is-profile"]:
            import torch

            print("WIDE_IS_PROFILE " + json.dumps(wide_is_profile(torch.device("cuda", 0))),
                  flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--draw-outputs"]:
            # the draws of the checkout at sys.argv[2] (an earlier commit),
            # saved to sys.argv[3]
            sys.path.insert(0, sys.argv[2])
            import torch

            torch.save(draw_outputs(torch.device("cuda", 0)), sys.argv[3])
            sys.exit(0)
        if sys.argv[1:2] == ["--parent-draws"]:
            # the drawn products against the checkout at sys.argv[2]'s kernels
            import torch

            print(card_line())
            phase_build()
            parent_draws(torch.device("cuda", 0), sys.argv[2])
            sys.exit(0)
        if sys.argv[1:2] == ["--pool-sweep"]:
            # both pool variants at POOL_SWEEP
            import torch

            print(card_line())
            phase_build()
            pool_sweep_ms(torch.device("cuda", 0))
            sys.exit(0)
        if sys.argv[1:2] == ["--draw-floor"]:
            # the SASS issue floors of the record draws (FLOOR_KERNELS)
            import torch

            print(card_line())
            phase_build()
            fused_draw_floor(torch.device("cuda", 0))
            sys.exit(0)
        if sys.argv[1:2] == ["--moved-times"]:
            # the timings phase times leaves to the flags, each part's seconds
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            print(card_line())
            phase_build()
            dev = torch.device("cuda", 0)
            for title, fn in (
                    ("pool sweep", lambda: pool_sweep_ms(dev)),
                    ("gram shapes' times", lambda: [table_shape_ms(dev, sh)
                                                    for sh in GRAM_TIME_SHAPES]),
                    ("tiled shapes' fused_maha and fused_transform times",
                     lambda: [tiled_shape_ms(dev, sh, ("fused_maha", "fused_transform"))
                              for sh in TILED_SHAPES]),
                    ("draw floor", lambda: fused_draw_floor(dev))):
                t0 = time.perf_counter()
                fn()
                torch.cuda.empty_cache()
                print("MOVED %s: %.1f s" % (title, time.perf_counter() - t0), flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--nonfinite"]:
            # evaluation_nonfinite_case in the checkout at sys.argv[2] (an
            # earlier commit, or "."), reporting rather than failing
            sys.path.insert(0, sys.argv[2])
            import torch

            print(card_line())
            bad = evaluation_nonfinite_case(torch.device("cuda", 0), [], strict=False)
            print("NONFINITE " + json.dumps({"checkout": sys.argv[2], "mismatches": len(bad),
                                             "outputs": sorted({b[0] for b in bad})}), flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--tiled-outputs"]:
            # the forced tiled kernels' outputs of the checkout at
            # sys.argv[2], saved to sys.argv[3]
            sys.path.insert(0, sys.argv[2])
            import torch

            torch.save(tiled_outputs(torch.device("cuda", 0)), sys.argv[3])
            sys.exit(0)
        if sys.argv[1:2] == ["--parent-tiled"]:
            # the forced tiled kernels against the checkout at sys.argv[2]'s
            import torch

            print(card_line())
            phase_build()
            parent_tiled(torch.device("cuda", 0), sys.argv[2])
            sys.exit(0)
        if sys.argv[1:2] == ["--wide-times"]:
            # the wide paths' device ms in the checkout at sys.argv[2]
            sys.path.insert(0, sys.argv[2])
            import torch

            print(card_line())
            print("WIDE_TIMES %s " % sys.argv[2] + json.dumps(
                {key: ms for key, (ms, _) in wide_times(torch.device("cuda", 0)).items()}),
                flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--blocked-splits"]:
            print("BLOCKED_SPLITS " + json.dumps(blocked_splits()), flush=True)
            sys.exit(0)
        if sys.argv[1:2] == ["--parallel-worker"]:
            rank, world, port, backend, shared = sys.argv[2:7]
            sys.exit(parallel_worker(int(rank), int(world), int(port), backend, shared))
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
