#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``treeqp_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device and build: requires CUDA, prints the card's name and power limit
   (nvidia-smi), builds the kernels of ``treeqp_tpu_torch/csrc/`` into
   ``build/`` (one nvcc per source, in parallel) and prints the build time
   and each kernel's registers and spills;
2. the first eighteen kernels against their plain PyTorch twins on the card,
   with each one's median time from CUDA events, its bound (the least
   time the card could take: the bytes it must move over the memory rate,
   or its operations over the FP32 / FP64 peak, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time:
   the factor and solve kernels of the f64 phase on the operands of its
   first factorization and solve, the coarse phase's kernels (chain_eval,
   crown_eval, chain_blocks_factor_lanes, newton_iter in both modes) on the
   operands of its first iteration, the high-precision phase's f64 kernels
   (chain_eval_df, crown_eval_df, chain_apply_df, crown_apply_df,
   df_reduce_flat) at its first point on the bench path (the coarse
   phase's last duals), all on the headline instance (quadcopter, md=4,
   Nr=4, Nh=20: 256 scenarios, 4437 nodes), with df_reduce_flat also held
   bit for bit at the edges of its two levels (n in REDUCE_EDGES) and
   timed, with ``torch.sum``, alone and in a CUDA graph on both vectors,
   chain_eval also held against its twin at the chain evaluation kernel's
   edges (EVAL_DF_EDGES, the seeded data in f32; EVAL_RTOL, the active sets
   equal), crown_eval_df and crown_apply_df bit for bit and crown_eval
   (f32, EVAL_RTOL, the active sets equal) at the crown kernels'
   edges (CROWN_EVAL_EDGES: seeded crowns, ``crown_eval_operands``, and
   seeded directions, ``crown_apply_operands``), all five timed in a CUDA
   graph too;
   and the generic-tree solver's
   tree-Cholesky kernels (chain_factor, chain_solve_bwd, chain_forward,
   crown_factor, crown_solve) on each of the three instances of section 5
   and on the general C/D tree of section 6 (the pruned tree's timed), at
   the cold start of the headline trees and two iterations into the
   asymmetric tree's solve, with the two sweeps also timed (kernel, plain
   twin, bound, library call, and kernel and library call in a CUDA graph)
   on each split-path tree, chain_factor timed the same way on each
   split-path tree and on sdunes' operands (section 8) beside its library
   call (``torch.linalg.cholesky_ex`` of each chain as one matrix), and
   the sweeps and chain_factor held against their twins at the edges of
   their shared-memory ring (S=5, L in 1, 2, 17, n in 1, 5, 6, 8, 16; and
   chain_factor at S=4, L=130, n=16); and the general stage
   QPs' ADMM identification (admm_identify) at the first cold stage solve of the general C/D
   headline (all 4437 nodes; timed) and of its mixed instance (its 1478
   general nodes), with the working sets it seeds held equal; and
   chain_blocks_factor, chain_blocks_factor_lanes and admm_identify at
   their kernels' edges (BLOCK_EDGES, ADMM_EDGES: one step, chains past
   the 4-stage ring, nx 1, 5, 16; nz 1 and 16, ng = nz, the 32-lane form,
   f64) on seeded operands, and the three timed in a CUDA graph too;
   crown_blocks_factor and crown_factor on seeded operands, and
   crown_solve on the twin's factors with a seeded right-hand side
   (``crown_rhs``), at the multistage crowns of the headline, of sdunes'
   bootstrap (spring_mass_chain(4,4,4,20), G = 32) and of
   quadcopter(4,5,20) (timed in a CUDA graph) and at their kernels' edges
   (CROWN_EDGES: G = 2, 48, 64, a zero block whose pivots floor, reg 0 and
   > 0); rows 8-10 beside
   their library calls, ``torch.linalg.cholesky_ex`` of the crown as one
   dense matrix (``crown_matrix``: the groups deepest level first, W_g on
   the diagonal, Ut_g in the parent's slot rows) and
   ``torch.cholesky_solve`` with the twin's factors as one dense lower
   factor, kernel and library call also in a CUDA graph; system_solve
   beside its library call, ``torch.cholesky_solve`` with the whole tree's
   stored factors as one dense lower f32 factor (``system_matrix``:
   [26616]^2 at the headline), and on seeded factors at SYSTEM_SHAPES
   (``system_operands``; graph times printed); chain_blocks_factor and
   chain_blocks_factor_lanes beside ``torch.linalg.cholesky_ex`` of each
   chain's equilibrated blocks as one matrix (``ck.chain_blocks``,
   ``chain_blocks_matrix``), kernel and library call in a CUDA graph;
3. the main paths on that instance, each certified by the KKT oracle
   (< 1e-8) and compared with the same solve through the plain twins on
   the CPU: the one-phase solve (slice 1), the two-phase solve (coarse f32
   phase, then the f64 phase) and the bench path (bench.py's options: the
   coarse f32 phase, then the high-precision phase of ms_df64), with cold
   and warm requests of perturbed instances; and, on the bench path, the
   factorizations of one cold solve and the handover of the coarse phase's
   last factorization, counted;
4. more requests: two-phase requests with two-norm termination (the coarse
   phase's per-kernel loop), each certified; and the two-phase and bench
   solves of the 1024-scenario tree quadcopter(4,5,20), whose 1365-node
   crown the TPU kernels could not hold;
5. the generic-tree solver ``tdunes_solve`` at generic_bench's speed
   options (slice 4) on the headline tree pruned to 128 scenarios (the
   fault-tolerance example's pruned controller: 2257 nodes, 2129
   lambda-groups; the split path), cold and warm requests, each with
   stationarity < 1e-8 and KKT < 1e-6, the first held against the CPU
   plain path; the crown path on the asymmetric thesis-class tree of
   benchmarks/generic_bench.py, also held against the CPU plain path; and
   ``tdunes_solve`` on the unpruned headline tree (split path, 256 chains)
   against ``tdunes_ms_solve`` at bench options;
6. ``tdunes_solve`` on general C/D trees (slice 5) at general_cd_bench's
   tdunes options (``models.GENERAL_CD_OPTS``), on the bench's tree
   spring_mass_chain(4,4,4,20) (256 scenarios, 4437 nodes) with a row
   -0.6 <= sum x + 0.5 u <= 0.6 on every node (stage solver qpgen): a cold
   solve and a warm MPC chain of four requests (b + 1e-6 (k + 1), each from
   the previous solve's duals and working sets), and with the row on every
   third node (stage solver mixed) cold; each request with status 0 and
   KKT < 1e-8, its iterations, ADMM launches and time printed; the cold
   qpgen solve of the same plant at the depth Nr=2 (16 scenarios, 309
   nodes: the full tree takes ~6 minutes on the CPU) held against the same
   solve through the plain twins on the CPU (the same iterations, x and u
   within 1e-9);
7. the interior-point engine (slice 6) at ``models.IPM_OPTS``: its five
   Riccati kernels (ric_chain_factor, ric_chain_bwd, ric_chain_fwd,
   crown_ric_factor, crown_ric_solve) held against their twins on the
   operands of the first f32 iteration of each path (captured from a
   one-iteration solve), timed on path A (chain kernels) and B (crown
   kernels); then path A, ``ipm_ms_solve`` on general_cd_bench's ipm_ms
   tree (spring_mass_chain(4,4,4,20) with a row on every node: dense chain
   Riccati, the crown through the plain f32 recursion), and path B, the
   same tree box-only (ipm_bench's ms_f32_pallas mode: the crown through
   the crown kernels), each cold and through a warm chain of four requests
   b + 1e-6 (k + 1) from the previous solve; path C, ``ipm_solve`` on the
   box-only tree whole (4437 nodes, 21 stages) and on
   spring_mass_chain(4,4,3,7) (341 nodes), the f32 phase through the crown
   kernels; every request with status 0, max(res4) < tol and KKT < 1e-8,
   its iterations (f32 + f64), Riccati launches and time printed; path
   A's cold solve held against the same solve through the plain twins on
   the CPU at full depth (iterations within one, x and u within 1e-7);
   path B's crown kernels beside their library calls,
   ``torch.linalg.ldl_factor_ex`` of the crown's dense KKT matrix
   (``ric_crown_matrix``: the Hessians, the dynamics rows and their
   transposes; indefinite, so no Cholesky applies) and ``ldl_solve`` with
   its factors (its distance to the twin's dz, dlam printed), and both
   crown kernels in a CUDA graph on paths B and C; crown_ric_factor, and
   crown_ric_solve on the twin's factors, held against their twins at
   CROWN_RIC_EDGES (seeded whole trees, ``ric_crown_operands``);
   ric_chain_bwd, and ric_chain_fwd on its outputs, held against their
   twins at RIC_EDGES (both hbar forms, seeded right-hand sides
   ``ric_rhs``); ric_chain_factor and crown_ric_factor at nz = 33 (past
   the kernels' 32) refused before any launch, naming the bound; path
   A's chain kernels beside theirs, ``ldl_factor_ex`` of each chain's KKT
   matrix (``ric_chain_matrix``, batched [256, 272, 272]) for
   ric_chain_factor and ``ldl_solve`` with its factors
   (``ric_chain_vector``'s right-hand side) for ric_chain_bwd and
   ric_chain_fwd together, beside the two kernels' sum; the three chain
   kernels also in a CUDA graph (the LDL calls alone: cuSOLVER's sytrf
   fails under graph capture);
8. sdunes (slice 7) at ``models.SDUNES_OPTS`` on sdunes_bench's tree (B's
   box-only spring_mass_chain(4,4,4,20): 256 scenarios, Jay P=255, b=4):
   chain_full_solve_mat (m=5 and m=1) held against its twin, with
   chain_factor, on the operands of the first final-phase iteration of
   the cold solve (captured from it), timed alone and in a CUDA graph
   beside its library call (``torch.cholesky_solve`` with each chain's
   factor as one lower matrix, alone: batched, it runs MAGMA, which aborts
   under graph capture), and at its kernel's edges (FULL_EDGES, seeded
   by ``full_operands``); jay_cr_solve against its twin at the
   solve's first iteration, and at the first final-phase iteration (where
   the Jay system is near singular) both f32 solves held to a backward
   error below 1e-5, with their distances to the f64 solve printed; and
   jay_cr_solve once more on a seeded system at P=1023, b=16 with the
   on-the-fly shift and one exactly singular block (``jay_operands``), and
   at its kernel's edges (every P of JAY_PS, b of JAY_BS and shift mode of
   JAY_MODES, with and without the singular block), against its twin;
   both Jay shapes beside the library call, ``torch.linalg.solve_ex`` of
   the dense f32 Jay matrix with the shift by the kernel's rule
   (``jay_matrix``), kernel and library call also in a CUDA graph; the cold
   ``sdunes_solve``; the bench's
   sdunes_boot requests (stage 0's state bounds scaled by 1 + 0.02
   sin(1 + 1.7(k+1)); a ``tdunes_ms_solve`` bootstrap at
   ``models.SDUNES_BOOT_OPTS``, ``merge_output``, ``scenario_duals_from_tree``
   with the tree solution, then ``sdunes_solve``) and sdunes_boot_df64's
   (the same with ``df64_phase=True``), each certified (status 0, error
   < 1e-8, port-oracle KKT < 1e-8 through ``scenario_output``) with its
   iterations, bootstrap iterations, launches and time printed; the
   sdunes_f32 mode (f32 data, cold, tol 1e-3: finite iterates, its ms an
   iteration beside ``tdunes_ms_solve``'s all-f32 loop's); and a cold solve
   at Nr=3 held against the CPU plain path (iterations within one; x and
   u within 1e-7, at the same iteration count when the counts differ);
9. the cyclic-reduction chain sweeps (slice 8; no solver calls them):
   chain_cr_precompute, chain_solve_bwd_cr and chain_forward_cr held
   against their twins (factors 1e-5, solves 1e-4 relative) and the CR pair
   against the serial kernels (2e-4 relative) at the three shapes of
   scripts/prof_torch_chain_cr.py (S=256, L=16, n=8 from that script's
   seed; the pruned tree's chain factors of section 5; sdunes' of section
   8, S=256, L=20, n=8) and at S=4, L=130, n=16 (a chain of three rounds
   of lane groups, in shared memory), with the serial sweeps timed at each
   as in section 2 (kernel, plain twin, bound, library call, and in a CUDA
   graph) and the precompute in a CUDA graph; all three kernels also held
   to their twins and the CR pair to the serial kernels at ``CR_EDGES``
   (seeded by ``cr_operands``; S=2, L=240, n=16 the sweeps'
   global-scratch path), the precompute timed there in a CUDA graph, every
   shape's sweep launch (threads, shared memory) held to
   ``chain_cr.sweep_launch`` and precompute launch (threads, shared memory)
   to ``chain_cr.precompute_launch``; the
   three timed at the pruned tree's shape, all three also in a CUDA graph
   (the precompute's other shapes in its row's description), beside the
   library call (batched ``torch.linalg.solve_triangular`` on each
   chain's factor as one matrix, also timed beside chain_solve_bwd and
   chain_forward), then that script's loop of CR and serial pairs as their
   path;
10. the MPC re-embedding path (slice 8) on section 5's pruned tree at
   ``models.GENERIC_SPEED_OPTS``, along the closed loop of
   ``benchmarks/closed_loop.py`` (``closed_loop_mpc`` with tdunes, warm
   starts and no IPM bootstrap): ``set_x0`` then ``eliminate_x0`` keeping
   the originals, a cold solve, then four steps, each applying the
   solution's first control to the quadcopter's nonlinear plant
   (``BenchmarkModel.simulate``, RK4 at the true mass) and re-embedding the
   next state through ``EliminatedTreeQP.set_x0``, warm-started from the
   previous duals; each request's data equal to elimination from scratch
   (the root's state bounds aside), status 0 (the stalled steps counted),
   KKT < 1e-8 on the eliminated problem, x[1:] and u within 1e-6 of the
   solve without elimination, its iterations, launches and time printed;
   and the instance rebuilt through the three LTV setters from flat
   arrays, every field equal;
11. the JAX package's default solver options (slice 23): path G,
   ``tdunes_solve`` on section 6's two general C/D trees at the depth Nr=3
   (64 scenarios, 1173 nodes; at the full depth both packages stall at
   these options) at general_cd_bench's CPU options
   (``models.GENERAL_CD_CPU_OPTS``: f64 factors, the plain tree Cholesky
   with the on-the-fly Levenberg-Marquardt shift, no coarse phase), each a
   cold request and a warm chain of four (b + 1e-6 (k + 1) from the
   previous duals and working sets); path B, the bench path (bench.py's options)
   with ``reg_type="on_the_fly"`` on the headline tree, cold and warm
   requests, its iterations beside section 3's; paths P, the portable
   backend (``chain_backend="xla"``): ``tdunes_solve`` on section 5's
   pruned tree at generic_bench.speed_opts(on_tpu=False),
   ``tdunes_ms_solve`` on scen1024_bench's spring_mass_chain(4,4,5,20) at
   its CPU options and ``sdunes_solve`` on section 8's tree at
   sdunes_bench._sdunes_opts(on_tpu=False); every request certified
   (status 0, stationarity below tol, KKT < 1e-8) with its iterations and
   time printed; and the MPC state of tests/test_torch_qp_mpc.py that
   stalls both packages (quadcopter(2,2,6) pruned to 3 scenarios, x0 +
   0.05 N(0, I)) at ``models.GENERIC_SPEED_OPTS`` with reg_type "always"
   and "on_the_fly", on the card and on the CPU, the two held to the same
   status and iterations;
12. the surfaces (slice 24), every instance written with the port's
   ``tree_qp_to_json``: (a) ``interfaces.cli.solve_request`` in process on
   the card, each request certified (status 0, KKT < 1e-8, the expected
   dispatch) and held against the solver called directly with the options
   the CLI builds (iterations equal, x and u within SURF_GAP): the headline
   tree with clipping (tdunes_ms) cold and warm (the cold response's
   ``init.lam0_tree``, x0 scaled as section 3 scales it), section 7's
   box-only tree through hpipm (hpipm_ms) and ipm with ``multistage:
   false``, section 11's general C/D tree (Nr=CD_DEF_NR; stage solver
   qpgen) cold and warm, section 8's tree through sdunes; each request's
   iterations, solver_time, interface_time and JSON size printed; (b) the
   server (``--serve``, no ``--device``) as a child process: its handshake,
   the headline and general C/D requests cold and N_SERVE_REPEATS times
   more, each response held to (a)'s, the child on the card by its own
   /proc entry (a /dev/nvidia* file open or libcuda mapped) and by
   nvidia-smi (its pid among the compute apps, or, where nvidia-smi reports
   pids of another namespace, one compute app more than before it started),
   ``quit`` and exit 0, no compute app left of it, each request's wall
   time from write to response printed; (c) the one-shot file mode (``python3 -m
   treeqp_tpu_torch.interfaces.cli qp.json -o out.json``) on
   spring_mass_chain(1,2,1,4); (d) ``treeqp_cpp_demo`` built by the port's
   Makefile (target ``demo``) and run on that tree with (c)'s solution as
   xopt / uopt, N_DEMO_WARM warm solves on the card; (e) ``utils.profiling.profile_ms_phases`` on the
   headline at bench.py's options, its phase iterations within one of
   section 3's cold bench-path solve, and ``profile_tdunes_ops`` on section
   5's pruned tree at ``models.GENERIC_SPEED_OPTS``;
13. the multi-device solve: the chain-side kernels of the
   three sharded paths (chain_blocks_factor, chain_solve_bwd,
   chain_forward; ric_chain_factor with dense hbar, ric_chain_bwd,
   ric_chain_fwd; chain_factor, chain_full_solve_mat) held against their
   twins at the ranks' local chain counts (SHARD_S_LOCAL: the headline's
   256 chains over 2 and 4 ranks; the crown side is replicated at the
   shapes of sections 2, 7 and 8); then ``parallel.shard_solver``'s
   ``tdunes_ms_solve_shmap`` on the headline at bench.py's options (under
   an axis: no fused iteration, df64 phase or fused system solve),
   ``ipm_ms_solve_shmap`` on section 6's general C/D tree at path A's
   options and ``sdunes_solve_shmap`` on section 8's tree cold and from
   the bootstrap's duals, over groups of 1, 2 and 4 ranks that share the
   card (``launcher.run_ranks`` of ``timed_shard_cases``: spawned ranks,
   gloo, the collectives staged through host memory), each certified by
   both oracles (the port's ``max_kkt_residual`` and ``kkt_numpy``,
   < 1e-8), x, u, lam within SHARD_GAP of the 1-rank group's and its
   iterations equal to that group's (the psums' partial sums and the
   batched PyTorch ops round by the ranks' chain count, and two of these
   solves stop where such bits decide: IPM path A within one iteration,
   x, u, lam compared at equal counts only; cold sdunes at any count, its
   converged solution held), the cold sdunes solve of every group
   engaging the stall escalation and the bootstrapped one not
   (``info["stall_boosts"]``), the 1-rank
   group's IPM and cold sdunes solves the one-device solves of sections 7
   and 8 (the same iterations, x, u, lam within SHARD_GAP), the
   replicated outputs equal on every rank, the
   collective bytes per iteration printed (tdunes_ms' per f32 iteration
   beside the model's ``sharding.model_bytes_per_iter``, at most twice
   it), wall (tdunes_ms also profiled device) time, and each rank's
   launches (tdunes_ms rows chain_blocks_factor,
   crown_blocks_factor, chain_solve_bwd, chain_forward and crown_solve,
   ipm_ms the three chain Riccati kernels, sdunes chain_factor,
   chain_full_solve_mat and jay_cr_solve, each on every rank, and no
   other); last the witness that the cold sdunes count follows rounding
   on one device too: section 8's cold solve with Qd scaled by 1 + k 2^-52
   (SHARD_WITNESS_ULPS), each count printed; and IPM path A on 4 ranks
   again with max_iter the 1-rank group's count, its x, u, lam held within
   SHARD_GAP of that group's at the same count. A failure in any rank
   exits non-zero;
14. the examples and the model families (slice 26): ``examples_torch/``'s
   thesis_example and spring_mass through their ``main(device="cuda")``
   (the latter on a data.c / x0.txt that ``write_spring_mass_data``
   writes in the reference's format under build/: spring_mass_chain(2, 3,
   2, 10)'s realizations behind a nominal one), each passing its own
   asserts on the card; then ``models.crane`` and ``models.linear_chain``
   at FAMILY_SHAPE (md=4, Nr=4, Nh=50: the reference grid's largest tree,
   12117 nodes, 256 scenarios, chains of L=46 nodes below the crown's
   leaves, 47 with their roots; nx=4, nu=1 and nx=8, nu=3): on the
   crane, chain_blocks_factor_lanes, crown_blocks_factor,
   newton_iter (iter mode; the active sets equal away from a bound),
   chain_eval_df (bit for bit) and chain_apply_df against their twins on
   the operands of their first calls in a cold solve; on each tree
   ``tdunes_ms_solve`` at bench.py's options cold and FAMILY_STEPS
   closed-loop steps (``family_ms_loop``: the first control to the plant,
   the next state on the root, warm from the last duals), ``ipm_ms_solve``
   at ``IPM_OPTS["box"]`` and ``sdunes_solve`` at ``SDUNES_OPTS`` warm from
   the IPM's duals, each certified (status 0, the port's KKT < 1e-8), the
   three solutions' x and u within MPC_GAP, iterations, ms, the rows
   launched and the cold and last warm tdunes_ms solves' device time
   against wall time (torch.profiler) printed;
15. the reference's largest linear chain: ``models.linear_chain``
   at LC8 (nm=8, nu_count=7 at FAMILY_SHAPE: nx=16, nu=7, nz=23, the
   first instance past the Riccati kernels' 16-row instantiations; 12117
   nodes, crown groups G = 64) through ``tdunes_ms_solve`` at bench.py's
   options cold and FAMILY_STEPS closed-loop steps, ``ipm_ms_solve`` and
   ``ipm_solve`` (the whole tree) at ``IPM_OPTS["box"]`` with the five
   Riccati twins counted (none may run on either), and ``sdunes_solve``
   warm from the IPM's duals, each certified, the four solutions' x and u
   within MPC_GAP; then the five Riccati kernels against their twins on
   the operands of each IPM's first f32 iteration (the chain kernels and
   the 341-node crown from ipm_ms, the crown kernels on the whole tree from
   ipm_solve), each timed alone and in a CUDA graph beside its plain twin,
   its bound and its ``ldl_*`` yardstick (none for the 12117-node crown).

The kernel launch counts are set to 0 before each path (one-phase,
two-phase, bench, bench handover, two-norm, 1024 scenarios, generic split,
generic crown, generic cross-check, general C/D qpgen, general C/D mixed,
IPM paths A, B and C; the sdunes cold solve, each boot request's
bootstrap and its sdunes solve apart, sdunes_f32, tdunes_ms_f32; the CR
loop; the MPC re-embedding path; G qpgen, G mixed, bench on-the-fly, P
generic, P multistage, P sdunes; the seven in-process requests and the
two profilers of section 12; in each rank, every sharded solve of
section 13; the two examples; each family's tdunes_ms, ipm_ms and sdunes
paths; section 15's tdunes_ms, ipm_ms, ipm and sdunes paths) and read
after it; every kernel must launch
on a path that runs it, the multistage paths launch none of the generic
solver's kernels, the generic split path none of the multistage solver's, the crown path only
crown_factor and crown_solve, no path before section 6 launches
admm_identify, and the general C/D paths launch it and the five generic
kernels and none of the multistage solver's; no path before section 7
launches an IPM kernel, the IPM paths launch none of the dual Newton's,
path A no crown-Riccati kernel and path C no chain-Riccati kernel; no path
before section 8 launches chain_full_solve_mat or jay_cr_solve, and each
sdunes solve launches chain_factor once an iteration and both of them once
a coarse iteration and 1 + its refinement steps times a final iteration,
and no other kernel; no path but section 9's launches a CR kernel, and the
MPC path launches the five generic kernels and no other; the G paths
launch admm_identify and no other kernel, the bench on-the-fly path the
chain kernels of the coarse loop (chain_eval, crown_eval,
chain_blocks_factor_lanes), the chain sweeps chain_solve_bwd and
chain_forward, the five kernels of the high-precision phase and no other,
and the P paths no kernel; section 12's general C/D requests launch
admm_identify and no other kernel, its other requests none,
profile_ms_phases the coarse loop's and the high-precision phase's
kernels (and chain_factor, its factorization's chain Cholesky) and no
other, profile_tdunes_ops the five generic kernels and no other; the
examples launch none; the families' tdunes_ms paths launch the bench
path's kernels (newton_iter, chain_blocks_factor_lanes,
crown_blocks_factor, system_solve and the high-precision phase's five)
and none of the generic, IPM, sdunes or CR kernels, their ipm_ms paths
the five Riccati kernels and none of the dual Newton's, their sdunes paths
chain_factor, chain_full_solve_mat and jay_cr_solve and none of the
multistage solver's; section 15's paths as the families', its ipm path
the two crown Riccati kernels and no other, its sdunes path no
jay_cr_solve (Jay blocks of Nr nu = 28, past the kernel's 16). Prints
the JSON summary of all 28 kernels (rows chain_factor, chain_solve_bwd,
chain_forward, crown_factor, crown_solve, crown_blocks_factor,
df_reduce_flat, chain_blocks_factor, chain_blocks_factor_lanes,
system_solve, jay_cr_solve, chain_solve_bwd_cr and chain_forward_cr also
with ``graph_ms`` and ``library_graph_ms``: kernel and library call in a
CUDA graph; chain_cr_precompute,
admm_identify, chain_full_solve_mat, the five Riccati kernels, chain_eval,
chain_eval_df, chain_apply_df and crown_eval_df with ``graph_ms``), then the
device JSON as the last line.
Imports nothing of JAX.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-8
MD, NR, NH = 4, 4, 20
N_REQUESTS = 8          # two-phase cold and warm requests each
N_REQUESTS_1P = 4       # one-phase (slice 1) cold and warm requests each
N_REQUESTS_2N = 2       # two-phase two-norm requests, cold then warm
N_REQUESTS_B = 8        # bench-path cold and warm requests each
PERT = 0.02
SLICE_OPTS = dict(stage_solver="clipping", tol=TOL, max_iter=120,
                  factor_dtype="float32", refine_steps=2,
                  refine_safeguard=False, chain_backend="pallas",
                  reg_type="always", reg_value=1e-6, f32_phase_tol=0.0,
                  df64_phase=False)
# the main path of bench.py without its df64 phase
TWO_PHASE_OPTS = {**SLICE_OPTS, "f32_phase_tol": 1e-4, "f32_patience": 3}
# bench.py's options (bench_opts(on_tpu=True)): the high-precision phase is
# solvers/ms_df64.py's
BENCH_OPTS = {**TWO_PHASE_OPTS, "df64_phase": True}
# f32 kernels against f32 plain twins that sum in another order: factors
# to 1e-5 and solves to 1e-4 relative (tests/test_fused_eval.py,
# tests/test_crown_kernels.py use the same bounds); the evaluations sum in
# the twins' order without FMA contraction, so 1e-5 is a loose bound there
# and their active sets (Qinv or 0) must agree exactly
FACTOR_RTOL = 1e-5
SOLVE_RTOL = 1e-4
EVAL_RTOL = 1e-5
# at the trial point of newton_iter's "iter" mode the direction differs by
# the solve's rounding, so an active-set bit is held equal only where the
# twin's clipping input is this far from its bound (relative to max(1, |bound|))
TRIAL_MARGIN = 1e-4
# the f64 evaluations, the crown's Hessian action and the reduction
# reproduce their twins bit for bit; the chains' Hessian action to 1e-12
# relative
BIT_EXACT = 0.0
DF_RTOL = 1e-12
# df_reduce_flat's edges: the one-block form up to 4096 values, then one
# cluster (columns of 4, 32, 64 and 1024 values); their data's seed
REDUCE_EDGES = (0, 1, 2, 3, 4095, 4096, 4097, 50000, 65537, 2 ** 20 + 3)
# chain_eval_df / chain_apply_df's edges (S, L, nx, nu): chains of one node
# (no kid term, row 0 only), nx = nu = 1, the spring-mass df64 shape, nz =
# 32 (two column chunks), a chain longer than a block, S no multiple of 8
# chains, quadcopter(4,5,20)'s chains, and a long chain at nz = 32 whose
# tiles exceed a block's shared memory (read from global memory)
EVAL_DF_EDGES = ((5, 1, 6, 4), (5, 7, 1, 1), (5, 7, 8, 1), (5, 7, 16, 16), (3, 130, 6, 4),
                 (257, 16, 6, 4), (1024, 15, 6, 4), (2, 130, 16, 16))
EVAL_DF_SEED = 180
# the lane-group crown kernels' edges (a group of 8 or 16 lanes a node, one
# cluster): crown_eval_df and crown_apply_df held bit for bit, crown_eval
# (f32) to EVAL_RTOL against the twins on seeded crowns of
# the multistage tree (md, Nr) with nx states and nu inputs
# (crown_eval_operands): a root-only crown, nx = nu = 1 (8 lanes), nz = 32
# (two columns a lane), one node with 40 kids, a deep crown of two kids a
# node (511 nodes) and quadcopter(4,5,20)'s 1365-node crown
CROWN_EVAL_EDGES = ((4, 0, 6, 4), (3, 3, 1, 1), (3, 2, 16, 16), (40, 1, 6, 4), (2, 8, 6, 4),
                    (4, 5, 6, 4))
CROWN_EVAL_SEED = 190
REDUCE_SEED = 18
# the generic-tree solver (models.GENERIC_SPEED_OPTS) on the headline tree
# pruned to GEN_SCEN scenarios; KKT bar of the reference's per-MPC-step check
GEN_SCEN = 128
N_REQUESTS_G = 4        # generic cold and warm requests each
GENERIC_KKT = 1e-6
# the general C/D trees (models.GENERAL_CD_OPTS): warm MPC requests of the
# qpgen chain, b + CD_DB (k + 1); the card and the CPU plain path agree on
# x and u to CD_GAP with the same iterations
N_REQUESTS_CD = 4
CD_DB = 1e-6
CD_GAP = 1e-9
CD_CPU_NR = 2  # the depth of that comparison: 16 scenarios, 309 nodes
# admm_identify repeats its twin's order of operations without FMA
# contraction: held to 1e-6 x max(1, max|lm|), the seeded working sets
# exactly
ADMM_RTOL = 1e-6
# the chain block factors' and admm_identify's kernel edges (one
# instantiation per nx / nz, a 4-stage ring of the steps' sources, 16 or 32
# lanes a node), held against the twins on seeded operands: (S, L, nx, nz)
# and (N, ng, nz), the last one also in f64
BLOCK_EDGES = ((5, 1, 6, 10), (5, 7, 1, 2), (5, 7, 5, 6), (5, 7, 16, 20), (4, 130, 16, 20))
ADMM_EDGES = ((37, 1, 1), (37, 16, 16), (37, 9, 9), (37, 17, 9), (37, 32, 16))
# newton_iter's kernel edges (one cluster of 8 blocks of 512 threads, 8 or
# 16 lanes a chain), held against the twin in both modes at the coarse
# phase's first iteration: (model, its arguments); more chains than the
# cluster's sweep groups at a small depth (quadcopter: 1024 chains of L =
# 3, a 1365-node crown), nx = 16 (the 16-lane sweeps, crown groups of 32
# rows, a warp's), three chains of nx = 8, and crown groups of 48 rows
# (nx = 16, 3 kids: the crown solved in one block)
ITER_EDGES = (("quadcopter", (4, 5, 8)), ("spring_mass_chain", (8, 2, 2, 6)),
              ("spring_mass_chain", (4, 3, 1, 5)), ("spring_mass_chain", (8, 3, 1, 4)))
# ric_chain_factor's kernel edges (8, 16 or 32 lanes a chain, one
# instantiation per nz up to 16 and one for 16 < nz <= 32, a 3-stage ring),
# held against the twin on seeded operands with diagonal and dense hbar:
# (S, L, nx, nz): one stage, nz 8 and 9 on either side of the lane switch,
# nz = 16 with nx = 15, nz = 2, a long chain; S = 5 is no multiple of the
# chains a warp holds; then the wide instantiation: nz = 17 (the first
# past 16), nz = 23 in one stage with nx = 22, with the reference's largest
# linear chain's nx = 16 and at its chain length L = 46, with nx = 2 (a
# wide nu), nz = 32 with nx = 31 and with nx = 4 in two stages (fewer than
# the rings hold)
RIC_EDGES = ((5, 1, 8, 9), (5, 7, 7, 8), (5, 7, 8, 9), (5, 7, 15, 16), (5, 7, 1, 2),
             (4, 40, 8, 9), (5, 7, 16, 17), (5, 1, 22, 23), (5, 7, 16, 23), (3, 46, 16, 23),
             (5, 7, 2, 23), (5, 7, 31, 32), (5, 2, 4, 32))
RIC_REG = 1e-8  # the Levenberg-Marquardt shift of Muu at those edges
# crown_ric_factor's and crown_ric_solve's kernel edges (a group of 8, 16
# or 32 lanes a single-kid run, one instantiation per nz up to 16 and one
# for 16 < nz <= 32, one block or one cluster), held against the twins on
# seeded operands of whole multistage trees (ric_crown_operands): (md, Nr,
# Nh, nx, nu, reg): nz = 2, nz = 16 with nx = 8 and with nx = 15, a
# 1024-node level (more runs than the cluster's groups), a deep tree of
# single-kid runs, a chain (the root's only kid), reg > 0; then the wide
# instantiation: nz = 17, nz = 23 with nx = 22 and with nx = 2, nz = 32
# with nx = 31, a 64-run phase at nz = 23 with reg > 0 (past one block's
# 32 runs: the cluster, a group a warp), a deep tree of single-kid runs and
# a chain at nz = 23, and 256-run phases at nz = 32 (the cluster's groups
# striding over them)
CROWN_RIC_EDGES = ((3, 2, 3, 1, 1, 0.0), (3, 2, 3, 8, 8, 0.0), (3, 2, 3, 15, 1, 0.0),
                   (4, 5, 5, 8, 1, 0.0), (2, 2, 12, 4, 2, 0.0), (2, 0, 6, 4, 1, 0.0),
                   (3, 2, 4, 6, 3, 1e-3), (3, 2, 3, 16, 1, 0.0), (3, 2, 3, 22, 1, 0.0),
                   (3, 2, 3, 2, 21, 0.0), (3, 2, 3, 31, 1, 0.0), (4, 3, 5, 16, 7, 1e-3),
                   (2, 2, 12, 16, 7, 0.0), (2, 0, 6, 8, 15, 0.0), (4, 4, 5, 4, 28, 0.0))
# chain_full_solve_mat's kernel edges (a group of 8 or 16 lanes a chain and
# column, a 3-stage ring), held against the twin on seeded factors
# (full_operands): (S, L, n, m) with n 1, 8, 9, 16 (either side of the lane
# switch), L 1, 2 (shorter than the ring), 20 and 40, m 1, 5, 17; S = 5 is
# no multiple of the groups a warp holds
FULL_EDGES = tuple((5, L, n, m) for n in (1, 8, 9, 16) for L in (1, 2, 20, 40)
                   for m in (1, 5, 17))
# crown_factor's and crown_blocks_factor's kernel edges (a warp a group, one
# or two rows a lane), held against the twins on seeded operands on the
# crown of the multistage tree (md, Nr) with nx states: (md, Nr, nx, reg,
# zero): G = 2 (nxm 1, 2 kids), G = 48 and G = 64 (nxm 16; two rows a
# lane), a zero block on the deepest level when ``zero`` (its pivots floor
# at 1e-8: reg = 0), reg 0 and > 0
CROWN_EDGES = ((2, 3, 1, 0.0, False), (3, 3, 16, 1e-6, False), (4, 3, 16, 0.0, False),
               (4, 3, 16, 1e-6, False), (4, 3, 6, 0.0, True))
CROWN_REG = 1e-6  # the shift of the seeded operands at the solvers' shapes
# the bound of a kernel: H100 SXM data-sheet rates (FP32 outside the
# tensor cores, FP64, HBM3)
PEAK_FLOPS = {False: 67e12, True: 34e12}
PEAK_BYTES = 3.35e12
# sdunes (models.SDUNES_OPTS, sdunes_bench's modes): boot requests, their
# high-precision-phase twins, sdunes_f32 requests (its tol), the depth of
# the card-vs-CPU comparison (64 scenarios: ~3 s on the CPU), and the Jay
# system held beyond the TPU kernel's caps (P, b) with its seed
N_REQUESTS_SD = 4
N_REQUESTS_SD_DF = 2
N_REQUESTS_F32 = 2
SD_F32_TOL = 1e-3
SD_CPU_NR = 3
JAY_BIG = (1023, 16)
JAY_SEED = 1039
# jay_cr_solve's kernel edges (a group of 4, 8 or 16 lanes a block system,
# the operands in shared memory or past it in global scratch), held against
# the twin on seeded systems (jay_operands) in its three shift modes, none
# (reg_tol None: no shift), always (-1) and on the fly (1e-6): P and b
JAY_PS = (1, 2, 3, 7, 64, 65, 100, 255, 256, 300, 1023)
JAY_BS = (1, 3, 4, 8, 16)
JAY_MODES = (None, -1.0, 1e-6)
# system_solve's shapes (one cluster: lane groups a chain, a warp a crown
# group, block 0 past 32 rows), on seeded factors of the multistage tree
# (md, Nr, Nh) with nx states (system_operands): the headline, sdunes'
# bootstrap crown (G = 32), 1024 scenarios, crown groups of 48 rows, and
# three chains of one node (fewer than a warp's lane groups)
SYSTEM_SHAPES = (("headline", (4, 4, 20, 6)), ("bootstrap", (4, 4, 20, 8)),
                 ("1024 scenarios", (4, 5, 20, 6)), ("G = 48", (3, 3, 6, 16)),
                 ("S = 3, L = 1", (3, 1, 2, 5)))
# an f32 solve that is backward stable: ||J x - r|| over (||J|| ||x|| + ||r||)
JAY_BACKWARD = 1e-5
# the cyclic-reduction chain sweeps (slice 8): the CR pair held against the
# serial kernels to the 2e-4 of tests/test_chain_cr.py (absolute there, on
# O(1) data: here times max(1, max|serial|)); the right-hand sides' seed;
# solve pairs a shape on their path
CR_PAIR_RTOL = 2e-4
CR_SEED = 8
CR_LOOP = 4
# the CR kernels' edges (S, L, n), seeded by cr_operands: one node; two
# nodes of one row; an odd n, whose chains (and the precompute's node
# blocks) start off 16 bytes (4-byte copies), and L no power of two; 16
# lanes a node and L no power of two; a chain past the 227 KB of shared
# memory one sweep block may take (the global scratch). The precompute's
# blocks cross chain boundaries at each. Held to the twins (FACTOR_RTOL,
# SOLVE_RTOL) and the serial kernels (CR_PAIR_RTOL)
CR_EDGES = ((3, 1, 6), (5, 2, 1), (5, 17, 5), (3, 33, 16), (2, 240, 16))
# the MPC re-embedding path (slice 8) on the pruned headline tree: warm
# requests follow the closed loop (the plant driven by each solution's first
# control); x[1:] and u within MPC_GAP of the solve without the elimination
N_REQUESTS_MPC = 4
MPC_GAP = 1e-6
# section 11 (the JAX package's default options): the benches' CPU options
# (on_tpu=False) run the portable backend, chain_backend "xla":
# generic_bench.speed_opts(on_tpu=False), scen1024_bench.py:43-50 and
# sdunes_bench._sdunes_opts(on_tpu=False)
GENERIC_CPU_OPTS = dict(stage_solver="clipping", tol=TOL, max_iter=120, factor_dtype="same",
                        refine_steps=0, refine_safeguard=False, chain_backend="xla",
                        reg_type="on_the_fly", reg_value=1e-6, f32_phase_tol=0.0,
                        df64_phase=False)
SCEN1024_CPU_OPTS = {**GENERIC_CPU_OPTS, "max_iter": 150}
SCEN1024 = (4, 4, 5, 20)  # scen1024_bench's spring_mass_chain: 1024 scenarios
SDUNES_CPU_OPTS = dict(tol=TOL, max_iter=150, factor_dtype="same", refine_steps=0,
                       f32_phase_tol=0.0, chain_backend="xla", reg_type="always",
                       reg_value=1e-6)
# bench.py's options with the JAX package's default regularization
BENCH_OTF_OPTS = {**BENCH_OPTS, "reg_type": "on_the_fly"}
N_REQUESTS_DEF = 4  # general C/D warm requests at the CPU options
# the depth of those requests: 64 scenarios, 1173 nodes. At Nr=4 (4437
# nodes) the CPU options stall at max_iter in both packages (the JAX
# package on the CPU: status 1 after 150 iterations, error 0.51)
CD_DEF_NR = 3
# section 12 (the surfaces): the headline's request options (clipping: the
# multistage dispatch), the general C/D request's (GENERAL_CD_CPU_OPTS'
# maxit and tol), the demo's (treeqp_cpp_demo.cpp) for the one-shot file
# mode, the server's repeats of each request after the cold one, the
# demo's warm solves, where the section writes its files, and the gap of
# x and u between a request and its direct call
SURF_HEAD_OPTS = dict(solver="tdunes", clipping=True)
SURF_CD_OPTS = dict(solver="tdunes", maxit=150, stationarityTolerance=2.5e-9)
SURF_DEMO_OPTS = dict(solver="tdunes", maxit=200, stationarityTolerance=1e-12)
N_SERVE_REPEATS = 3
N_DEMO_WARM = 20
SURF_DIR = ROOT / "build" / "treeqp_tpu_torch" / "surfaces"
SURF_GAP = 1e-7
# section 13 (the multi-device solve): the group sizes on the one card, the
# gaps allowed against the 1-rank group, the timed repeats of the tdunes_ms solve,
# the ranks' local chain counts at which the chain kernels are held to
# their twins, the seed of those operands, and the ulps by which the
# one-device witness scales sdunes' Qd
SHARD_WORLDS = (1, 2, 4)
SHARD_GAP = dict(x=1e-7, u=1e-7, lam=1e-6)
SHARD_REPEATS = 2
SHARD_S_LOCAL = (128, 64)
SHARD_SEED = 250
SHARD_WITNESS_ULPS = (1, 2, 4)
# section 14 (the examples and the model families): the reference grid's
# largest tree (experiment_grid.FULL_GRID's crane point, md=4, Nr=4, Nh=50:
# 12117 nodes, 256 scenarios, chains of L = Nh - Nr = 46 nodes below the
# crown's 256 leaves), the crane at its widths and the linear chain at its
# generator's (nm=4, nu_count=3), and the closed-loop steps after the cold
# solve
FAMILIES = ("crane", "linear_chain")
FAMILY_SHAPE = dict(md=4, Nr=4, Nh=50)
# the spring constant of the written spring-mass instance's nominal
# realization, spring_mass_chain's default k_nominal
SPRING_K = 2.0
FAMILY_STEPS = 3
# section 15: the reference's largest linear chain (treeqp_performance_plot's
# nm = 8, nu = 7: nx = 16, nz = 23) on the reference grid's largest tree,
# the first instance past the Riccati kernels' 16-row instantiations; its
# chain kernels' library yardsticks are timed on the calls that check them
# (cuSOLVER's sytrf runs matrix by matrix: seconds at 256 chains of
# [1794]^2)
LC8 = dict(nm=8, nu_count=7, **FAMILY_SHAPE)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(torch, fn, calls=20, reps=5):
    """Median milliseconds a call of fn() takes on the card alone: ``calls``
    calls captured in one CUDA graph, its replays timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    return cuda_ms(torch, g.replay, reps) / calls


def compare(torch, name, got, ref, rtol):
    """Max abs difference over paired outputs; fails above
    rtol * max(1, max|ref|) for any output."""
    worst = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"{name}: output shape {tuple(g.shape)} vs {tuple(r.shape)} "
                 f"or not finite")
        err = float((g - r).abs().max())
        bound = rtol * max(1.0, float(r.abs().max()))
        if not err <= bound:
            fail(f"{name}: kernel differs from its plain twin by {err:.3e} "
                 f"> {bound:.3e}")
        worst = max(worst, err)
    return worst


def bit_exact(torch, name, got, ref):
    """compare() at BIT_EXACT, and every output's bits (the sign of a zero
    too) equal to the twin's."""
    err = compare(torch, name, got, ref, BIT_EXACT)
    for g, r in zip(got, ref):
        if not torch.equal(g.view(torch.int64), r.view(torch.int64)):
            fail(f"{name}: kernel differs from its plain twin in the bits")
    return err


def compare_sets(torch, name, got, ref, keys, near=None):
    """Active-set outputs (Qinv or 0) bit for bit; ``near`` maps a key to a
    mask of components exempt from the check. Returns the count exempted."""
    exempt = 0
    for k in keys:
        ok = got[k] == ref[k]
        if near is not None:
            exempt += int((~ok & near[k]).sum())
            ok = ok | near[k]
        if not bool(ok.all()):
            fail(f"{name}: active set {k} differs from the twin's in "
                 f"{int((~ok).sum())} components")
    return exempt


def near_bound(torch, vU, lo, hi, mask):
    """Components whose clipping input lies within TRIAL_MARGIN of a bound."""
    near = torch.zeros_like(vU, dtype=torch.bool)
    for b in (lo, hi):
        near |= (vU - b).abs() < TRIAL_MARGIN * b.abs().clamp(min=1.0)
    return near & (mask > 0)


def nbytes(torch, *objs):
    """Bytes of every tensor in ``objs`` (tuples, lists and dicts walked),
    each counted once: a tensor met twice (an input that a kernel hands
    back among its outputs) moves once."""
    seen = {}

    def walk(o):
        if isinstance(o, torch.Tensor):
            key = (o.data_ptr(), o.dtype, tuple(o.shape))
            seen[key] = o.numel() * o.element_size()
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
    for o in objs:
        walk(o)
    return sum(seen.values())


# operation counts of the dense block routines (an FMA counts two)
def kkt_numpy(qp, out):
    """The max-norm KKT residual of ``out`` on the host in numpy, a second
    oracle beside the port's ``max_kkt_residual`` (the same families and
    conventions, core/kkt.py, written apart from it)."""
    import numpy as np
    h = lambda t: t.detach().cpu().double().numpy()
    topo = qp.topo
    xm, um, cm = (np.asarray(m, dtype=float) for m in (topo.x_mask, topo.u_mask, topo.c_mask))
    nr = np.asarray(topo.nonroot_x_mask, dtype=float)
    par = np.asarray(topo.parent_np)
    kid = np.nonzero(par >= 0)[0]
    Q, R, S, C, D, A, B = (h(getattr(qp, f)) for f in ("Q", "R", "S", "C", "D", "A", "B"))
    x, u, lam = h(out.x) * xm, h(out.u) * um, h(out.lam) * nr
    mux, muu, mud = h(out.mu_x) * xm, h(out.mu_u) * um, h(out.mu_d) * cm
    mv = lambda M, v: np.einsum("nij,nj->ni", M, v)
    mtv = lambda M, v: np.einsum("nji,nj->ni", M, v)
    stx = mv(Q, x) + h(qp.q) + mtv(S, u) + mux + mtv(C, mud) - lam
    stu = mv(R, u) + h(qp.r) + mv(S, x) + muu + mtv(D, mud)
    np.add.at(stx, par[kid], mtv(A[kid], lam[kid]))
    np.add.at(stu, par[kid], mtv(B[kid], lam[kid]))
    dyn = np.zeros_like(x)
    dyn[kid] = mv(A[kid], x[par[kid]]) + mv(B[kid], u[par[kid]]) + h(qp.b)[kid] - x[kid]
    parts = [stx * xm, stu * um, dyn * nr]
    for z, lo, hi, mu, m in ((x, qp.xmin, qp.xmax, mux, xm), (u, qp.umin, qp.umax, muu, um),
                             (mv(C, x) + mv(D, u), qp.dmin, qp.dmax, mud, cm)):
        lo, hi = h(lo), h(hi)
        parts.append((np.maximum(z - hi, 0.0) + np.maximum(lo - z, 0.0)) * m)
        parts.append(np.where(mu > 0, mu * (z - hi), mu * (lo - z)) * m)
    return float(max(np.abs(v).max() for v in parts))


def kernel_wrappers():
    """{name: wrapper} of every CUDA kernel wrapper of the port (each counts
    its launches in its ``launches`` attribute)."""
    from treeqp_tpu_torch.ops import (chain_cr, chain_kernels, crown_kernels, crown_riccati,
                                      df_eval_kernels, df_reduce, iter_kernel, jay_kernel,
                                      qpgen_lanes, riccati_kernels, system_kernels)
    out = {}
    for mod in (chain_kernels, crown_kernels, system_kernels, iter_kernel, df_eval_kernels,
                df_reduce, qpgen_lanes, riccati_kernels, crown_riccati, jay_kernel, chain_cr):
        for v in vars(mod).values():
            if callable(v) and hasattr(v, "launches"):
                out[v.__name__] = v
    return out


def timed_shard_cases(mesh, cases, timing):
    """Section 13's rank function (``launcher.run_ranks`` spawns it on
    every rank): each ``ShardCase`` solved on ``mesh`` with every kernel's
    launch count set to 0 just before the solve and read just after, then
    ``repeats`` more solves timed on the host clock and, with ``profile``,
    one under torch.profiler for its device kernel time (``timing``: a
    (repeats, profile) pair per case). Returns per case dict(out=the
    solver's outputs on the CPU, launches, wall_s, walls_s, device_ms or
    None)."""
    import torch
    from treeqp_tpu_torch.parallel.shard_solver import cpu_outputs, rank_call
    wrappers = kernel_wrappers()
    res = []
    for case, (repeats, profile) in zip(cases, timing):
        call = rank_call(case, mesh)
        for f in wrappers.values():
            f.launches = 0
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        launches = {n: f.launches for n, f in wrappers.items()}
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize(mesh.device)
            walls.append(time.perf_counter() - t0)
        dev_ms = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as trace
            with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize(mesh.device)
            dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        res.append(dict(out=cpu_outputs(out), launches=launches, wall_s=wall, walls_s=walls,
                        device_ms=dev_ms))
    return res


def sharded_solves(torch, card, runs, worlds, paths=None):
    """Section 13's solves: each run of ``runs`` (dict(name, case: a
    ShardCase, qp: the whole tree on the CPU for both oracles, needs:
    kernels every rank must launch, allowed: the kernels it may launch,
    model: the communication model's bytes per f32 iteration or None,
    repeats / profile: the timed repeats and whether to profile one solve
    (default 0 / False), iter_slack: how far its iterations may lie from
    the reference group's (default 0, None: any), converged: whether its
    x, u, lam are held to the reference group's at any count, escalates:
    True / False where every group's solve must / must not engage sdunes'
    stall escalation (``info["stall_boosts"]``), one_device: the one-device
    solve of the same route (its TreeQPOut) or None, worlds: the group
    sizes it runs in (default all of ``worlds``), capped_by: the name of an
    earlier run whose reference-group iterations become this run's
    max_iter and whose reference-group solution it is held to at that
    count) over groups of each size of ``worlds`` (the first, one rank, is
    the reference group), all runs of a size in one group on the card
    (``launcher.run_ranks`` of ``timed_shard_cases``). Each is certified
    (status 0, both oracles' KKT < TOL; a capped run stops at its cap and
    is held by its gaps instead), takes the reference group's iterations
    within ``iter_slack``, has x, u, lam within SHARD_GAP of that group's
    (at the same count, or with ``converged``) and the escalation
    ``escalates`` asks for; the
    reference group takes ``one_device``'s iterations with x, u, lam within
    SHARD_GAP of its (on one rank every collective is the identity); its
    kernel launches on every rank are held to ``needs`` / ``allowed`` and
    recorded in ``paths``, and it is printed: iterations, KKT, gaps,
    collective bytes beside the model, wall (median of the timed repeats)
    and the profiled device time where the run asks for it, the launches of
    each rank. Returns {(name, world): summary}."""
    from treeqp_tpu_torch import merge_output
    from treeqp_tpu_torch.solvers import sdunes as sd
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.parallel.launcher import run_ranks
    from treeqp_tpu_torch.parallel.shard_solver import merge_ranks

    def tree_out(run, r):
        if "sol" in r:
            return sd.scenario_output(run["case"].data, r["sol"], r["lam"], r["mu"], r["info"])
        return merge_output(run["case"].data, r["crown"], r["chain"], r["info"])

    def case_of(run):
        if "capped_by" not in run:
            return run["case"]
        cap = ref[run["capped_by"]][0]
        return dataclasses.replace(run["case"], opts=dataclasses.replace(run["case"].opts,
                                                                         max_iter=cap))

    ref, summary = {}, {}
    for world in worlds:
        todo = [run for run in runs if world in run.get("worlds", worlds)]
        cases = [case_of(run) for run in todo]
        timing = [(run.get("repeats", 0), run.get("profile", False)) for run in todo]
        t0 = time.perf_counter()
        per_rank = run_ranks(world, timed_shard_cases, cases, timing)
        res = merge_ranks(cases, [[c["out"] for c in pr] for pr in per_rank])
        print(f"sharded group of {world} rank(s) on the card: {len(todo)} runs in "
              f"{time.perf_counter() - t0:.1f} s with the spawn")
        for i, (run, r) in enumerate(zip(todo, res)):
            for key in ("launches", "wall_s", "walls_s", "device_ms"):
                r[key] = [pr[i][key] for pr in per_rank]
            name, info = run["name"], r["info"]
            capped = "capped_by" in run
            ref_name = run["capped_by"] if capped else name
            out = tree_out(run, r)
            kkt, kkt_np = max_kkt_residual(run["qp"], out), kkt_numpy(run["qp"], out)
            what = f"sharded {name}, {world} rank(s)"
            if not capped and (info["status"] != 0 or not kkt < TOL or not kkt_np < TOL):
                fail(f"{what}: status {info['status']} KKT {kkt} (port) {kkt_np} (numpy)")
            if world == worlds[0]:
                ref[name] = (info["iter"], out)
                one = run.get("one_device")
                if one is not None:
                    gaps1 = {f: float((getattr(out, f) - getattr(one, f).cpu()).abs().max())
                             for f in ("x", "u", "lam")}
                    print(f"{what} against the one-device solve: iter {info['iter']} and "
                          f"{one.info['iter']}, " + ", ".join(f"|d{f}| {v:.2e}"
                                                         for f, v in gaps1.items()))
                    if info["iter"] != one.info["iter"] or any(
                            gaps1[f] > SHARD_GAP[f] for f in gaps1):
                        fail(f"{what}: not the one-device solve")
            ref_iter, ref_out = ref[ref_name]
            gaps = {f: float((getattr(out, f) - getattr(ref_out, f)).abs().max())
                    for f in ("x", "u", "lam")}
            same = info["iter"] == ref_iter
            slack = run.get("iter_slack", 0)
            if (slack is not None and abs(info["iter"] - ref_iter) > slack) or (
                    (same or run.get("converged")) and any(
                        gaps[f] > SHARD_GAP[f] for f in gaps)):
                fail(f"{what}: iter {info['iter']} gaps {gaps} against {worlds[0]} rank(s)' "
                     f"{ref_iter} iterations")
            if "escalates" in run and (info["stall_boosts"] > 0) != run["escalates"]:
                fail(f"{what}: the stall escalation engaged at {info['stall_boosts']} "
                     f"iterations, expected " + ("some" if run["escalates"] else "none"))
            comm = r["comm"][0]
            if any(c != comm for c in r["comm"]):
                fail(f"{what}: the ranks counted different collectives {r['comm']}")
            line = (f"{what}: status {info['status']}, iter {info['iter']}"
                    + (f" (max_iter {ref_iter}, {ref_name}'s at {worlds[0]} rank(s))"
                       if capped else "")
                    + (f" ({info['iter_f32']} f32)" if "iter_f32" in info else "")
                    + (f", the stall escalation engaged at {info['stall_boosts']} iterations"
                       if "stall_boosts" in info else "")
                    + f", KKT {kkt:.2e} (port oracle) {kkt_np:.2e} (numpy oracle); against "
                    f"{worlds[0]} rank(s): "
                    + ("the same iterations, " if same else f"{ref_iter} iterations, ")
                    + ", ".join(f"|d{f}| {v:.2e}" for f, v in gaps.items())
                    + ("" if same or run.get("converged") else " (not held: other counts)")
                    + f"; collectives {comm['calls']} calls, {comm['bytes']} bytes a solve, "
                    f"{comm['bytes_per_iter']:.0f} an iteration, largest {comm['max_call']}")
            if run["model"] is not None:
                per_f32 = comm["bytes_per_iter_f32"]
                line += (f", {per_f32:.0f} an f32 iteration beside the model's {run['model']} "
                         f"({per_f32 / run['model']:.2f}x)")
                if not 0 < per_f32 <= 2 * run["model"]:
                    fail(f"{what}: {per_f32} collective bytes an f32 iteration, more than "
                         f"twice the model's {run['model']}")
            walls = [statistics.median(w or [w0]) * 1e3
                     for w, w0 in zip(r["walls_s"], r["wall_s"])]
            dev_ms = [d for d in r["device_ms"] if d is not None]
            line += (f"; wall {max(walls):.1f} ms (slowest rank, "
                     + (f"median of {len(r['walls_s'][0])} repeats; first solve "
                        f"{max(r['wall_s']) * 1e3:.1f} ms), " if r["walls_s"][0]
                        else "the counted solve's), ")
                     + (f"device kernels {max(dev_ms):.1f} ms (busiest rank, profiled)"
                        if dev_ms else "device time not measured") + f" on {card}")
            print(line)
            for rank, launches in enumerate(r["launches"]):
                got = {k: v for k, v in launches.items() if v}
                print(f"  rank {rank}: launches {got}")
                missing = [k for k in run["needs"] if not launches[k]]
                extra = [k for k in got if k not in run["allowed"]]
                if missing or extra:
                    fail(f"{what}, rank {rank}: did not launch {missing}, launched {extra}")
                if paths is not None:
                    paths[f"{what}, rank {rank}"] = launches
            summary[(name, world)] = dict(iter=info["iter"], comm=comm, wall_ms=max(walls),
                                          device_ms=max(dev_ms) if dev_ms else None)
    return summary


def chol_ops(n):
    return n ** 3 / 3


def trsm_ops(m, n):
    return m * n * n


def syrk_ops(m, k):
    return 2 * m * m * k


def chain_blocks_matrix(torch, Wc, Utc):
    """Each chain's blocks Wc, Utc [S, L, n, n] as one symmetric [L n, L n]
    matrix with the block order reversed (Wc_{L-1-k} on the diagonal,
    Utc_{L-k} below it and its transpose above): the matrix whose Cholesky
    factor holds chain_factor's Ls and CUs_1 .. CUs_{L-1}."""
    S, L, n, _ = Wc.shape
    M = torch.zeros((S, L * n, L * n), dtype=Wc.dtype, device=Wc.device)
    for k in range(L):
        M[:, k * n:(k + 1) * n, k * n:(k + 1) * n] = Wc[:, L - 1 - k]
        if k:
            M[:, k * n:(k + 1) * n, (k - 1) * n:k * n] = Utc[:, L - k]
            M[:, (k - 1) * n:k * n, k * n:(k + 1) * n] = Utc[:, L - k].mT
    return M


def chain_factor_matrix(torch, Ls, CUs):
    """chain_factor's factors Ls, CUs [S, L, n, n] of chains without a
    parent coupling (CUs_0 = 0) as each chain's lower [L n, L n] Cholesky
    factor, the block order reversed (Ls_{L-1-k} on the diagonal, CUs_{L-k}
    below it): chain_full_solve_mat(Ls, CUs, rhs) solves with its product,
    as torch.cholesky_solve does."""
    S, L, n, _ = Ls.shape
    F = torch.zeros((S, L * n, L * n), dtype=Ls.dtype, device=Ls.device)
    for k in range(L):
        F[:, k * n:(k + 1) * n, k * n:(k + 1) * n] = Ls[:, L - 1 - k]
        if k:
            F[:, k * n:(k + 1) * n, (k - 1) * n:k * n] = CUs[:, L - k]
    return F


def block_operands(torch, S, L, nx, nz, seed, dev):
    """Seeded operands of both chain block factors, one chain system:
    (ABt, ztp, qtc, s_root) and (ABt, qt, rt, ztp_root, s_root), with
    ztp_j = (qt, rt)_{j-1} (the root's at j = 0) and qtc = qt as in a dual
    Hessian. [A B] 0.3 N(0, 1), the x masked inverses in [1, 2], the u and
    root ones in [0.1, 1.1] with a third zero (clipped bounds): f32 factors
    within 1e-6 of f64 ones at every edge, so FACTOR_RTOL holds."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def masked(*shape):
        v = rng.uniform(0.1, 1.1, shape)
        v[rng.random(shape) < 1 / 3] = 0.0
        return v
    f32 = dict(dtype=torch.float32, device=dev)
    ABt = torch.tensor(0.3 * rng.standard_normal((S, L, nx, nz)), **f32)
    qt = torch.tensor(rng.uniform(1.0, 2.0, (S, L, nx)), **f32)
    rt = torch.tensor(masked(S, L, nz - nx), **f32)
    root = torch.tensor(masked(S, nz), **f32)
    s_root = torch.tensor(rng.uniform(0.5, 2.0, (S, nx)), **f32)
    ztp = torch.cat([root[:, None], torch.cat([qt, rt], dim=-1)[:, :-1]], dim=1).contiguous()
    return (ABt, ztp, qt, s_root), (ABt, qt, rt, root, s_root)


def cr_operands(torch, S, L, n, seed, dev):
    """Seeded chain factors and right-hand sides of the CR sweeps, (Ls,
    CUs, res, droot): the blocks W = A A' + 3 I, Ut = 0.3 N of
    tests/test_torch_chain_cr.py, factored by chain_factor's twin."""
    import numpy as np
    from treeqp_tpu_torch.ops import chain_kernels as ck
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    A = rng.standard_normal((S, L, n, n))
    Wc = torch.tensor(A @ A.transpose(0, 1, 3, 2) + 3.0 * np.eye(n), **f32)
    Utc = torch.tensor(0.3 * rng.standard_normal((S, L, n, n)), **f32)
    Ls, CUs, _ = ck.chain_factor_ref(Wc, Utc)
    return (Ls, CUs, torch.tensor(rng.standard_normal((S, L, n)), **f32),
            torch.tensor(rng.standard_normal((S, n)), **f32))


def admm_operands(torch, N, ng, nz, dtype, seed, dev):
    """Seeded ADMM operands (G, L, rho, lo, hi, h, z0): L the f64 Cholesky
    factor of H + G' diag(rho) G, bounds that clip."""
    import numpy as np
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((N, ng, nz))
    M = rng.standard_normal((N, nz, nz))
    rho = rng.uniform(0.5, 5.0, (N, ng))
    K = M @ M.transpose(0, 2, 1) + nz * np.eye(nz) + G.transpose(0, 2, 1) @ (rho[..., None] * G)
    ops = (G, np.linalg.cholesky(K), rho, -0.3 - rng.uniform(0.0, 1.0, (N, ng)),
           0.3 + rng.uniform(0.0, 1.0, (N, ng)), 3.0 * rng.standard_normal((N, nz)),
           rng.standard_normal((N, nz)))
    return tuple(torch.tensor(a, dtype=dtype, device=dev) for a in ops)


def eval_df_operands(torch, S, L, nx, nu, seed, dev):
    """Seeded operands of chain_eval_df and chain_apply_df at (S, L, nx,
    nu): ``chain_eval_df_data`` of random A, B, q, r, b, positive Qd, Rd and
    bounds that clip about a third of the clipping inputs at the dual point
    lam (f64), and an f32 direction d."""
    import numpy as np
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    g = lambda *sh: torch.tensor(rng.standard_normal((S, L) + sh), **f64)
    pos = lambda n: torch.tensor(0.5 + rng.random((S, L, n)), **f64)
    A, B = g(nx, nx) / math.sqrt(nx), g(nx, nu) / math.sqrt(nu)
    q, r, b, Qd, Rd, lam = g(nx), g(nu), g(nx), pos(nx), pos(nu), g(nx)
    wide = lambda n: torch.full((S, L, n), 1e30, **f64)
    unc = dek.chain_eval_df_ref(dek.chain_eval_df_data(
        A, B, q, r, Qd, Rd, -wide(nx), wide(nx), -wide(nu), wide(nu), b), lam)
    # each bound |v| (0.5 + 1.5 U) on either side: v clips where its side's
    # factor is below 1, a third of the time
    side = lambda v: v.abs() * torch.tensor(0.5 + 1.5 * rng.random(v.shape), **f64)
    xU, uU = unc["xUnc"], unc["uUnc"]
    data = dek.chain_eval_df_data(A, B, q, r, Qd, Rd, -side(xU), side(xU), -side(uU),
                                  side(uU), b)
    d = torch.tensor(rng.standard_normal((S, L, nx)), dtype=torch.float32, device=dev)
    return data, lam, d


def crown_eval_operands(torch, md, Nr, nx, nu, seed, dev):
    """Seeded operands of crown_eval_df on the crown of the multistage tree
    (md, Nr) with nx states and nu inputs: (data, lam, extra, prep), data
    ``crown_eval_df_data`` of random A, B, q, r, b, positive diagonal Q, R
    and bounds that clip about a third of the clipping inputs at the dual
    point lam, extra N(0, 1) on every node (f64)."""
    import numpy as np
    from types import SimpleNamespace
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    from treeqp_tpu_torch.utils.tree import TreeStructure
    prep = td._get_prep(tm._ms_meta(TreeStructure.multistage(md, Nr, Nr + 2, nx, nu)).crown_topo)
    Nn = len(prep.par)
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    g = lambda *sh: torch.tensor(rng.standard_normal((Nn,) + sh), **f64)
    diag = lambda n: torch.diag_embed(torch.tensor(0.5 + rng.random((Nn, n)), **f64))
    qp = SimpleNamespace(A=g(nx, nx) / math.sqrt(nx), B=g(nx, nu) / math.sqrt(nu), q=g(nx),
                         r=g(nu), b=g(nx), Q=diag(nx), R=diag(nu))
    lam, extra = g(nx), g(nx + nu)
    masks = prep.masks(torch.float64, dev)
    wide = lambda n: torch.full((Nn, n), 1e30, **f64)
    qp.xmin, qp.xmax, qp.umin, qp.umax = -wide(nx), wide(nx), -wide(nu), wide(nu)
    unc = dek.crown_eval_df_ref(dek.crown_eval_df_data(qp, prep, *masks), lam, extra, prep)
    # each bound |v| (0.5 + 1.5 U) on either side, as eval_df_operands
    side = lambda v: v.abs() * torch.tensor(0.5 + 1.5 * rng.random(v.shape), **f64)
    qp.xmin, qp.xmax = -side(unc["xUnc"]), side(unc["xUnc"])
    qp.umin, qp.umax = -side(unc["uUnc"]), side(unc["uUnc"])
    return dek.crown_eval_df_data(qp, prep, *masks), lam, extra, prep


def crown_apply_operands(torch, md, Nr, nx, nu, seed, dev):
    """Seeded operands of crown_apply_df on crown_eval_operands' crown:
    (data, qtilde, rtilde, d, extra, prep), the masked inverses those of the
    twin's evaluation at that dual point, d an f32 N(0, 1) direction masked
    by nrxm, extra (f64, N(0, 1) on every node) the chains' contribution."""
    import numpy as np
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    data, lam, extra, prep = crown_eval_operands(torch, md, Nr, nx, nu, seed, dev)
    ev = dek.crown_eval_df_ref(data, lam, extra, prep)
    rng = np.random.default_rng([seed, 1])
    d = (torch.tensor(rng.standard_normal(lam.shape), dtype=torch.float32, device=dev)
         * data["nrxm"].float())
    return data, ev["qtilde"], ev["rtilde"], d, extra, prep


def iter_edge_qp(name, args):
    """The multistage QP of an ITER_EDGES entry, on the CPU."""
    from treeqp_tpu_torch import models
    m = getattr(models, name)(*args, device="cpu")
    return m.qp if hasattr(m, "qp") else m[0]


def iter_operands(torch, qp, dev):
    """newton_iter's arguments in both modes at the coarse phase's first
    iteration of the multistage QP ``qp`` (f32 data, duals 0): the eval
    mode's, then the iter mode's, with the residuals and the active set of
    the twin's evaluation there and ``_ms_factorize``'s factors of that set
    (two-phase options)."""
    from treeqp_tpu_torch.ops import iter_kernel as ik
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    ms32 = tm.split_multistage(qp).to(dev).to(dtype=torch.float32)
    meta = ms32.meta
    prep = td._get_prep(meta.crown_topo)
    data_ch, data_cr = tm._eval_data(ms32, prep)
    state = dict(lam_cr=torch.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm),
                                    dtype=torch.float32, device=dev),
                 lam_ch=torch.zeros_like(ms32.q))
    ev = ik.newton_iter_ref(data_ch, data_cr, None, state, prep, meta.root_ids, mode="eval")
    fact = tm._ms_factorize(ms32, ev["qtilde"], ev["rtilde"], ev["qt"], ev["rt"],
                            td.TdunesOpts(**TWO_PHASE_OPTS), prep, tm._solve_ctx(ms32, prep),
                            lanes=True)
    istate = dict(state, res_cr=ev["res2_cr"], res_ch=ev["res2_ch"])
    return ((data_ch, data_cr, None, state, prep, meta.root_ids),
            (data_ch, data_cr, fact, istate, prep, meta.root_ids))


def ric_operands(torch, S, L, nx, nz, dense, seed, dev):
    """Seeded ric_chain_factor operands (hbar, AB): AB 0.5 N(0, 1) /
    sqrt(nz), hbar diagonal in [1, 2], or dense B B' / nz plus that
    diagonal (B N(0, 1)): every stage's Muu well conditioned and W bounded
    along any L, so FACTOR_RTOL holds."""
    import numpy as np
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    AB = torch.tensor(0.5 * rng.standard_normal((S, L, nx, nz)) / np.sqrt(nz), **f32)
    hb = rng.uniform(1.0, 2.0, (S, L, nz))
    if dense:
        B = rng.standard_normal((S, L, nz, nz))
        hb = B @ np.swapaxes(B, -1, -2) / nz + hb[..., None] * np.eye(nz)
    return torch.tensor(hb, **f32), AB


def ric_rhs(torch, S, L, nx, nz, seed, dev):
    """Seeded right-hand sides of the chain Riccati sweeps (rg [S, L, nz],
    rb [S, L, nx], z_root [S, nz]), N(0, 1) f32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    return tuple(torch.tensor(rng.standard_normal(sh), **f32)
                 for sh in ((S, L, nz), (S, L, nx), (S, nz)))


def full_operands(torch, S, L, n, m, seed, dev):
    """Seeded chain_full_solve_mat operands (Ls, CUs, rhs): the twin's
    chain_factor of SPD blocks W = B B' / n + 4 I (B N(0, 1)) coupled by Ut
    0.3 N(0, 1) with Ut_0 = 0 (self-contained chains, the form of
    tests/test_torch_sdunes_kernels.py's), and rhs [S, L, n, m] N(0, 1)."""
    import numpy as np
    from treeqp_tpu_torch.ops import chain_kernels as ck
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    B = rng.standard_normal((S, L, n, n))
    W = B @ np.swapaxes(B, -1, -2) / n + 4.0 * np.eye(n)
    Ut = 0.3 * rng.standard_normal((S, L, n, n))
    Ut[:, 0] = 0.0
    Ls, CUs, _ = ck.chain_factor_ref(torch.tensor(W, **f32), torch.tensor(Ut, **f32))
    return Ls, CUs, torch.tensor(rng.standard_normal((S, L, n, m)), **f32)


def crown_prep(md, Nr, nx):
    """The crown of the multistage tree (md, Nr) with nx states (its
    tdunes prep, on the CPU): the groups of crown_blocks_factor."""
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    from treeqp_tpu_torch.utils.tree import TreeStructure
    return td._get_prep(tm._ms_meta(TreeStructure.multistage(md, Nr, Nr + 2, nx, 1)).crown_topo)


def crown_operands(torch, sched, nz, seed, dev, zero=False):
    """Seeded operands of both crown factor kernels on the schedule
    ``sched``: crown_blocks_factor's (ABk, ztp, dvals, sW, sUt, Wadd), and
    the blocks (W, Ut) its build makes of them (crown_kernels._crown_blocks)
    for crown_factor. [A B] 0.3 N(0, 1), ztp in [0.1, 1.1] with a third
    zero, dvals in [1, 2], sW in [0.8, 1.25], sUt in [0.05, 0.1], Wadd
    -0.05 C C' / G (C N(0, 1)): every block and its Schur complement
    positive definite with room, so FACTOR_RTOL holds. With ``zero`` the
    first group of the deepest level has zero blocks (its pivots are the
    shift, floored at 1e-8)."""
    import numpy as np
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    rng = np.random.default_rng(seed)
    NpG, K, n, G = sched.NpG, sched.K, sched.nxm, sched.G
    ABk = 0.3 * rng.standard_normal((NpG, K, n, nz))
    ztp = rng.uniform(0.1, 1.1, (NpG, nz))
    ztp[rng.random((NpG, nz)) < 1 / 3] = 0.0
    dvals = rng.uniform(1.0, 2.0, (NpG, G))
    sW = rng.uniform(0.8, 1.25, (NpG, G))
    sUt = rng.uniform(0.05, 0.1, (NpG, n))
    C = rng.standard_normal((NpG, G, G))
    Wadd = -0.05 * C @ C.transpose(0, 2, 1) / G
    if zero and sched.n_lev:
        g = int(sched.lev_child[0])
        ABk[g], dvals[g], Wadd[g] = 0.0, 0.0, 0.0
    args = tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in (ABk, ztp, dvals, sW, sUt, Wadd))
    return args, ckr._crown_blocks(*args)


def crown_rhs(torch, sched, seed, dev):
    """A seeded crown_solve right-hand side [NpG, G], N(0, 1) f32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((sched.NpG, sched.G)), dtype=torch.float32,
                        device=dev)


def crown_matrix(torch, W, Ut, sched, reg=0.0, factor=False):
    """The crown's groups as one dense [NpG G, NpG G] matrix, the groups in
    the schedule's order (the deepest level first, the root group last):
    W_g + reg I on the diagonal, Ut_g in its parent's slot rows and the
    columns of g, and its transpose beside it; with ``factor`` (CholW,
    CholUt given) the lower factor alone. The Cholesky factor of the first
    holds crown_factor's CholW_g on its diagonal and CholUt_g below it, and
    torch.cholesky_solve with it solves as crown_solve does (``crown_vector``
    orders the right-hand side)."""
    NpG, K, n, G = sched.NpG, sched.K, sched.nxm, sched.G
    pos = crown_order(torch, sched, W.device)
    M = torch.zeros((NpG * G, NpG * G), dtype=W.dtype, device=W.device)
    M.view(NpG, G, NpG, G)[pos, :, pos, :] = W
    if reg:
        M.diagonal().add_(reg)
    g, d, s = (torch.as_tensor(a, dtype=torch.long, device=W.device)
               for a in (sched.lev_child, sched.lev_parent, sched.lev_slot))
    M.view(NpG, K, n, NpG, G)[pos[d], s, :, pos[g], :] = Ut[g]
    if not factor:
        M.view(NpG, G, NpG, K, n)[pos[g], :, pos[d], s, :] = Ut[g].transpose(1, 2)
    return M


def crown_order(torch, sched, dev):
    """Each group's place in crown_matrix's order."""
    import numpy as np
    pos = np.empty(sched.NpG, np.int64)
    pos[np.concatenate([sched.lev_child, [0]])] = np.arange(sched.NpG)
    return torch.as_tensor(pos, device=dev)


def crown_vector(torch, v, sched, back=False):
    """A group-major [NpG, G] vector in crown_matrix's order as [NpG G, 1];
    with ``back`` the reverse."""
    pos = crown_order(torch, sched, v.device)
    if back:
        return v.view(sched.NpG, sched.G)[pos]
    out = torch.empty_like(v)
    out[pos] = v
    return out.reshape(-1, 1)


def system_operands(torch, md, Nr, Nh, nx, seed, dev):
    """Seeded operands of system_solve on the multistage tree (md, Nr, Nh)
    with nx states: (Ls, CUs, CholW, CholUt, rg, rch, prep, root_ids). The
    factors are lower triangular with diagonals in [1, 2] and entries 0.3
    N(0, 1) / sqrt(rows) below; the couplings 0.3 N(0, 1) / sqrt(rows); the
    right-hand sides N(0, 1)."""
    import numpy as np
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    from treeqp_tpu_torch.utils.tree import TreeStructure
    meta = tm._ms_meta(TreeStructure.multistage(md, Nr, Nh, nx, 1))
    prep = td._get_prep(meta.crown_topo)
    sched = ckr._get_sched(prep)
    rng = np.random.default_rng(seed)
    S, L, n, NpG, G = meta.S, meta.L, nx, sched.NpG, sched.G

    def lower(shape, m):
        F = np.tril(0.3 * rng.standard_normal(shape + (m, m)) / np.sqrt(m), -1)
        return F + np.eye(m) * rng.uniform(1.0, 2.0, shape + (m, 1))
    ops = (lower((S, L), n), 0.3 * rng.standard_normal((S, L, n, n)) / np.sqrt(n),
           lower((NpG,), G), 0.3 * rng.standard_normal((NpG, n, G)) / np.sqrt(G),
           rng.standard_normal((NpG, G)), rng.standard_normal((S, L, n)))
    return (*(torch.tensor(a, dtype=torch.float32, device=dev) for a in ops), prep,
            meta.root_ids)


def system_matrix(torch, Ls, CUs, CholW, CholUt, prep, root_ids):
    """The Newton system's stored factors as one dense lower factor of the
    whole tree, [S L n + NpG G]^2: each chain's factor in its reversed
    block order (``chain_factor_matrix``), the chains one after another,
    then the crown's (``crown_matrix``), with CUs_0 of chain s in the rows
    of its root's (group, slot) and the columns of its node 0.
    torch.cholesky_solve with it solves as system_solve does
    (``system_vector`` orders the right-hand sides)."""
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import system_kernels as sk
    S, L, n, _ = Ls.shape
    sched = ckr._get_sched(prep)
    Ln, Nc, G = L * n, S * L * n, sched.G
    dev = Ls.device
    F = torch.zeros((Nc + sched.NpG * G,) * 2, dtype=Ls.dtype, device=dev)
    s = torch.arange(S, device=dev)
    F[:Nc, :Nc].view(S, Ln, S, Ln)[s, :, s, :] = chain_factor_matrix(torch, Ls, CUs)
    F[Nc:, Nc:] = crown_matrix(torch, CholW, CholUt, sched, factor=True)
    ids = {k: v.long() for k, v in sk.ms_sched(prep, root_ids, dev).items()}
    r = torch.arange(n, device=dev)
    rows = Nc + crown_order(torch, sched, dev)[ids["g_of"]] * G + ids["slot"] * n
    cols = s * Ln + (L - 1) * n
    F[(rows[:, None] + r)[:, :, None], (cols[:, None] + r)[:, None, :]] = CUs[:, 0]
    return F


def system_vector(torch, rg, rch, prep, x=None):
    """The right-hand sides (rg [NpG, G], rch [S, L, n]) in system_matrix's
    order as [N, 1]; with ``x`` [N, 1] given, its parts (dg, dch) back."""
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    sched = ckr._get_sched(prep)
    S, L, n = rch.shape
    if x is None:
        return torch.cat([rch.flip(1).reshape(-1, 1), crown_vector(torch, rg, sched)])
    Nc = S * L * n
    return (crown_vector(torch, x[Nc:].reshape(-1), sched, back=True),
            x[:Nc].reshape(S, L, n).flip(1))


def jay_operands(torch, P, b, seed, dev, singular=False):
    """A seeded SPD Jay system [diag, off, rhs, shift]: diag A A' + 3 b I
    (A N(0, 1)), off 0.3 N(0, 1), rhs N(0, 1), the shift 1e-2 on every
    row; with ``singular`` the block of the first odd index past P / 2 (one
    the first level eliminates, as it is given) has row and column 0 zero,
    its couplings too, so that its pivot turns the shift on."""
    import numpy as np
    rng = np.random.default_rng(seed)
    A_ = rng.normal(size=(P, b, b))
    dg = A_ @ A_.transpose(0, 2, 1) + 3.0 * b * np.eye(b)
    of = 0.3 * rng.normal(size=(P - 1, b, b))
    r = rng.normal(size=(P, b))
    mid = P // 2 | 1
    if singular and mid < P:
        dg[mid, 0, :] = dg[mid, :, 0] = of[mid - 1, 0, :] = 0.0
        if mid < P - 1:
            of[mid, :, 0] = 0.0
    out = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (dg, of, r)]
    return out + [torch.full((P, b), 1e-2, dtype=torch.float32, device=dev)]


def jay_matrix(torch, diag, off, shift=None, reg_tol=-1.0, dtype=None):
    """The Jay system as one dense [P b, P b] matrix (in ``dtype``, the
    operands' by default), the shift on the diagonal by the kernel's rule:
    on every block (reg_tol < 0), or on the fly on the blocks whose own
    factor fails the pivot test, which is the kernel's rule where such a
    block is eliminated as it is given (an odd index, as jay_operands'
    singular block)."""
    from treeqp_tpu_torch.ops import jay_kernel as jk
    P, b = diag.shape[0], diag.shape[-1]
    dtype = dtype or diag.dtype
    M = torch.zeros((P * b, P * b), dtype=dtype, device=diag.device)
    M4 = M.view(P, b, P, b)
    i = torch.arange(P, device=diag.device)
    M4[i, :, i, :] = diag.to(dtype)
    if P > 1:
        M4[i[1:], :, i[:-1], :] = off.to(dtype)
        M4[i[:-1], :, i[1:], :] = off.to(dtype).transpose(1, 2)
    if shift is not None:
        add = shift.to(dtype)
        if reg_tol >= 0:
            on = (jk._chol(diag, shift, reg_tol) != jk._chol(diag, None, reg_tol)).flatten(1)
            add = add * on.any(1, keepdim=True)
        M.diagonal().add_(add.reshape(-1))
    return M


def ric_crown_matrix(torch, hbar, AB, Wsum0, prep, nx, reg=0.0):
    """The system crown_ric_factor factors, as one dense symmetric KKT
    matrix [Nc nz + (Nc - 1) nx]^2: node n's Hessian diag(hbar_n) + Wsum0_n
    (+ reg on its inputs' block) on the diagonal of the primal block, and
    for each node n > 0 the dynamics row x_n = AB_n z_parent + rb_n (-I at
    x_n, AB_n at its parent's z) with its transpose. It is indefinite: its
    symmetric factorization is torch.linalg.ldl_factor_ex, and ldl_solve
    with ``ric_crown_vector``'s right-hand side gives crown_ric_solve's dz
    and dlam (the dynamics multipliers; the root's is 0)."""
    from treeqp_tpu_torch.ops import crown_riccati as crk
    Nc, nz = hbar.shape
    Nz = Nc * nz
    dev = hbar.device
    par = torch.as_tensor(crk._get_sched(prep).par, dtype=torch.long, device=dev)
    M = torch.zeros((Nz + (Nc - 1) * nx,) * 2, dtype=hbar.dtype, device=dev)
    H = Wsum0 + torch.diag_embed(hbar)
    H[:, nx:, nx:] += reg * torch.eye(nz - nx, dtype=hbar.dtype, device=dev)
    i = torch.arange(Nc, device=dev)
    M[:Nz, :Nz].view(Nc, nz, Nc, nz)[i, :, i, :] = H
    n, a = i[1:], torch.arange(nx, device=dev)
    E = M[Nz:, :Nz].view(Nc - 1, nx, Nc, nz)
    E[n - 1, :, par[n], :] = AB[1:]
    E[(n - 1)[:, None], a, n[:, None], a] = -1.0
    M[:Nz, Nz:] = M[Nz:, :Nz].T
    return M


def ric_crown_operands(torch, md, Nr, Nh, nx, nu, seed, dev):
    """Seeded operands of the crown Riccati kernels on the whole multistage
    tree (md, Nr, Nh) with nx states and nu inputs: (hbar, AB, Wsum0, rg,
    rb, wsum0, prep). hbar in [1, 2], AB 0.3 N(0, 1) / sqrt(nz), at the
    leaves Wsum0 an SPD term B B' / (2 nz) and wsum0 N(0, 1) (zero
    elsewhere, as the chains' terms are), rg and rb N(0, 1): every stage's
    Muu well conditioned and W bounded along any depth, so FACTOR_RTOL
    holds."""
    import numpy as np
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.utils.tree import TreeStructure
    topo = TreeStructure.multistage(md, Nr, Nh, nx, nu)
    prep = ipm._get_ipm_prep(topo)
    rng = np.random.default_rng(seed)
    Nc, nz = topo.Nn, nx + nu
    leaf = (np.asarray(topo.nkids) == 0)[:, None, None]
    B = rng.standard_normal((Nc, nz, nz))
    ops = (rng.uniform(1.0, 2.0, (Nc, nz)), 0.3 * rng.standard_normal((Nc, nx, nz)) / np.sqrt(nz),
           leaf * (B @ B.transpose(0, 2, 1)) / (2 * nz), rng.standard_normal((Nc, nz)),
           rng.standard_normal((Nc, nx)), leaf[:, :, 0] * rng.standard_normal((Nc, nz)))
    return (*(torch.tensor(a, dtype=torch.float32, device=dev) for a in ops), prep)


def ric_crown_vector(torch, rg, rb, wsum0, x=None):
    """crown_ric_solve's right-hand sides in ric_crown_matrix's order as
    [N, 1] (-(rg + wsum0), then -rb of the nodes past the root); with ``x``
    [N, 1] given, its parts (dz [Nc, nz], dlam [Nc, nx]) back."""
    Nc, nz = rg.shape
    if x is None:
        return torch.cat([-(rg + wsum0).reshape(-1), -rb[1:].reshape(-1)])[:, None]
    nx = rb.shape[1]
    return (x[:Nc * nz].reshape(Nc, nz),
            torch.cat([torch.zeros_like(rb[:1]), x[Nc * nz:].reshape(Nc - 1, nx)]))


def ric_chain_matrix(torch, hbar, AB, reg=0.0):
    """The systems ric_chain_factor factors, each chain's as one dense
    symmetric KKT matrix, batched [S, L nz + L nx, L nz + L nx]: the stage
    Hessians hbar_j (diagonal [S, L, nz] or dense [S, L, nz, nz]; + reg on
    the inputs' block) on the diagonal of the primal block z_0 .. z_{L-1},
    then for each stage the dynamics row x_j = AB_j z_{j-1} + rb_j (-I at
    x_j, AB_j at z_{j-1}) and its transpose; stage 0's row couples to the
    crown's z_root, which goes into the right-hand side
    (``ric_chain_vector``). It is indefinite: its symmetric factorization is
    torch.linalg.ldl_factor_ex, and ldl_solve with ric_chain_vector's
    right-hand side gives ric_chain_bwd followed by ric_chain_fwd: dz and
    dlam (the dynamics multipliers)."""
    S, L, nx, nz = AB.shape
    Nz, dev = L * nz, AB.device
    H = hbar if hbar.dim() == 4 else torch.diag_embed(hbar)
    H = H.clone()
    H[..., nx:, nx:] += reg * torch.eye(nz - nx, dtype=AB.dtype, device=dev)
    M = torch.zeros((S, Nz + L * nx, Nz + L * nx), dtype=AB.dtype, device=dev)
    j = torch.arange(L, device=dev)
    M[:, :Nz, :Nz].view(S, L, nz, L, nz)[:, j, :, j, :] = H.transpose(0, 1)
    E = M[:, Nz:, :Nz].view(S, L, nx, L, nz)
    E[:, j[1:], :, j[1:] - 1, :] = AB[:, 1:].transpose(0, 1)
    a = torch.arange(nx, device=dev)
    E[:, j[:, None], a, j[:, None], a] = -1.0
    M[:, :Nz, Nz:] = M[:, Nz:, :Nz].mT
    return M


def ric_chain_vector(torch, rg, rb, z_root, AB, x=None):
    """The chain sweeps' right-hand sides in ric_chain_matrix's order as
    [S, N, 1] (-rg, then -rb with stage 0's AB_0 z_root added to its rb_0);
    with ``x`` [S, N, 1] given, its parts (dz [S, L, nz], dlam [S, L, nx])
    back."""
    S, L, nz = rg.shape
    nx = rb.shape[2]
    if x is None:
        rb0 = rb.clone()
        rb0[:, 0] += (AB[:, 0] @ z_root[:, :, None])[..., 0]
        return torch.cat([-rg.reshape(S, -1), -rb0.reshape(S, -1)], dim=1)[:, :, None]
    return x[:, :L * nz].reshape(S, L, nz), x[:, L * nz:].reshape(S, L, nx)


def ric_chain_ldl(torch, hbar, AB, reg, rg, rb, z_root, first_ms=None):
    """The library calls of rows 22-24 on one set of chain operands:
    (ldl_factor_ex of ``ric_chain_matrix``, ldl_solve with its factors and
    ``ric_chain_vector``'s right-hand side) as calls without arguments,
    ldl_factor_ex's largest info, and the solve's largest distance to the
    twins' ric_chain_fwd after ric_chain_bwd. With a dict ``first_ms``,
    the CUDA-event ms of these first two calls go into it ("factor",
    "solve"): at shapes where a call takes seconds, that is its timing."""
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    M = ric_chain_matrix(torch, hbar, AB, reg)
    v = ric_chain_vector(torch, rg, rb, z_root, AB)
    fact = rk.ric_chain_factor_ref(hbar, AB, reg)[0]
    p, k, _ = rk.ric_chain_bwd_ref(fact, rg, rb)

    def call(key, fn):
        if first_ms is None:
            return fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        res = fn()
        b.record()
        b.synchronize()
        first_ms[key] = a.elapsed_time(b)
        return res
    LD, piv, info = call("factor", lambda: torch.linalg.ldl_factor_ex(M))
    got = ric_chain_vector(torch, rg, rb, z_root, AB,
                           x=call("solve", lambda: torch.linalg.ldl_solve(LD, piv, v)))
    err = max(float((a - b).abs().max())
              for a, b in zip(got, rk.ric_chain_fwd_ref(fact, p, k, rb, z_root)))
    return (lambda: torch.linalg.ldl_factor_ex(M), lambda: torch.linalg.ldl_solve(LD, piv, v),
            int(info.abs().max()), err)


def profiled(torch, fn):
    """(wall ms, device kernel ms, kernel launches) of one synchronized fn()
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, sum(e.time_range.elapsed_us() for e in kern) / 1e3, len(kern)


def write_c_arrays(path, scalars, arrays):
    """Write ``int name = v;`` and ``double name[] = {...};`` declarations
    (the code-generated data.c format), each double with 17 significant
    digits so that ``ref_data.parse_c_arrays`` reads back the same
    numbers."""
    import numpy as np
    lines = [f"int {k} = {int(v)};" for k, v in scalars.items()]
    for k, v in arrays.items():
        vals = ", ".join(f"{x:.17g}" for x in np.asarray(v, np.float64).reshape(-1))
        lines.append(f"double {k}[] = {{{vals}}};")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_spring_mass_data(data_dir):
    """Write an instance in the format of the reference's spring_mass_utils
    (data.c and x0.txt, what ``models.spring_mass_qp`` reads): the default
    ``spring_mass_chain``'s realizations (k = SPRING_K -+ 1) behind a
    nominal one at SPRING_K (the realization spring_mass_qp drops), its
    weights, bounds and x0; data.c's shapes, md=3, Nr=2, Nh=10, NX=4, NU=1.
    Returns the directory."""
    import numpy as np
    from treeqp_tpu_torch.models import spring_mass_chain, spring_mass_dynamics
    from treeqp_tpu_torch.utils.printing import write_vector_txt
    nm, nx, nu = 2, 4, 1
    x0 = spring_mass_chain(device="cpu")[1]
    ks = np.linspace(SPRING_K - 1.0, SPRING_K + 1.0, 3)
    AB = [spring_mass_dynamics(nm, k, 0.1) for k in (SPRING_K, *ks)]
    col = lambda M: M.T.ravel()  # column-major, as data.c stores matrices
    dQ = np.ones(nx)
    dQ[:nm] = 10.0
    xmax = np.full(nx, 1e12)
    xmax[:nm] = 1.2
    write_c_arrays(os.path.join(data_dir, "data.c"), dict(Nh=10, Nr=2, md=3, NX=nx, NU=nu),
                   dict(A=np.concatenate([col(a) for a, _ in AB]),
                        B=np.concatenate([col(b) for _, b in AB]),
                        b=np.zeros(len(AB) * nx), dQ=dQ, q=np.zeros(nx), dP=10.0 * dQ,
                        p=np.zeros(nx), dR=0.1 * np.ones(nu), r=np.zeros(nu),
                        xmin=np.full(nx, -1e12), xmax=xmax, umin=-np.ones(nu),
                        umax=np.ones(nu)))
    write_vector_txt(x0, os.path.join(data_dir, "x0.txt"))
    return data_dir


def family_model(name, device="cpu"):
    """``models.crane`` or ``models.linear_chain`` at FAMILY_SHAPE (the
    generator's default widths), made on ``device``."""
    from treeqp_tpu_torch import models
    return getattr(models, name)(**FAMILY_SHAPE, device=device)


def family_ms_loop(torch, model, qp, ms, opts, steps, what):
    """``tdunes_ms_solve`` on (qp, ms) cold, then ``steps`` closed-loop
    steps as the MPC path takes them: the first control of the last
    solution to the model's plant (``BenchmarkModel.simulate``), the next
    state set on the root (the crown's root bound rows), the solve warm from
    the last duals. Each solve certified: status 0, stationarity below TOL,
    the port's KKT < TOL. Returns one dict a solve (iter, iter_f32, kkt,
    ms: host milliseconds of the synchronized solve, out: its TreeQPOut,
    args: the solve's (ms, lam0_crown, lam0_chain))."""
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    rows, x, start, nu0 = [], model.x0, (None, None), qp.topo.nu[0]
    for k in range(steps + 1):
        if k:
            x = model.simulate(x, rows[-1]["out"].u[0, :nu0].cpu().numpy())
            qp, ms = qp.set_x0(x), dataclasses.replace(ms, crown=ms.crown.set_x0(x))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cro, cho, info = tm.tdunes_ms_solve(ms, *start, opts)
        out = tm.merge_output(ms, cro, cho, info)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        kkt = max_kkt_residual(qp, out)
        step = "cold solve" if k == 0 else f"closed-loop step {k} (warm)"
        if info["status"] != 0 or not info["error"] < TOL or not kkt < TOL:
            fail(f"{what} {step}: status {info['status']} error {info['error']} kkt {kkt}")
        rows.append(dict(iter=info["iter"], iter_f32=info["iter_f32"], kkt=kkt, ms=t_ms,
                         out=out, args=(ms, *start)))
        start = (cro["lam"], cho["lam"])
    return rows


def family_ipm(torch, qp, ms, opts, what):
    """``ipm_ms_solve`` on (qp, ms), or ``ipm_solve`` on the whole tree qp
    where ms is None, certified (status 0, the port's KKT < TOL). Returns
    (out, iterations, kkt, host ms)."""
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.solvers import ipm_multistage as ims
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if ms is None:
        out = ipm.ipm_solve(qp, opts)
        info = out.info
    else:
        cro, cho, info = ims.ipm_ms_solve(ms, opts)
        out = tm.merge_output(ms, cro, cho, info)
    torch.cuda.synchronize()
    t_ms = (time.perf_counter() - t0) * 1e3
    kkt = max_kkt_residual(qp, out)
    if info["status"] != 0 or not kkt < TOL:
        fail(f"{what}: status {info['status']} kkt {kkt}")
    return out, info["iter"], kkt, t_ms


def family_sdunes(torch, qp, start, opts, what):
    """``sdunes_solve`` on the scenario form of ``qp``, warm from the
    scenario duals of the tree solution ``start`` (``scenario_duals_from_tree``),
    certified (status 0, the port's KKT < TOL). Returns (out, iterations,
    kkt, host ms)."""
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.solvers import sdunes as sd
    sqp = sd.scenario_data(qp)
    lam0, mu0 = sd.scenario_duals_from_tree(sqp, start.lam, start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, lam, mu, info = sd.sdunes_solve(sqp, lam0, mu0, opts)
    out = sd.scenario_output(sqp, sol, lam, mu, info)
    torch.cuda.synchronize()
    t_ms = (time.perf_counter() - t0) * 1e3
    kkt = max_kkt_residual(qp, out)
    if info["status"] != 0 or not kkt < TOL:
        fail(f"{what}: status {info['status']} kkt {kkt}")
    return out, info["iter"], kkt, t_ms


def perturbed(qp, ms, fac):
    """Scale the pinned initial state (the root's bound rows) by ``fac``:
    the closed-loop MPC variation of bench.py."""
    def scale(q):
        xmin, xmax = q.xmin.clone(), q.xmax.clone()
        xmin[0] *= fac
        xmax[0] *= fac
        return q.replace(xmin=xmin, xmax=xmax)
    return scale(qp), None if ms is None else dataclasses.replace(ms, crown=scale(ms.crown))


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "treeqp_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: treeqp_tpu_torch/ not found next to this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    import treeqp_tpu_torch  # noqa: F401  (pins full-precision f32)
    from treeqp_tpu_torch.core.kkt import max_kkt_residual
    from treeqp_tpu_torch.core.qp_data import QP_FIELDS
    from treeqp_tpu_torch.models import (GENERAL_CD_CPU_OPTS, GENERAL_CD_OPTS,
                                         GENERIC_SPEED_OPTS, IPM_OPTS,
                                         SDUNES_BOOT_OPTS, SDUNES_OPTS, asym_tree,
                                         general_cd, pruned, quadcopter, spring_mass_chain)
    from treeqp_tpu_torch.ops import _build
    from treeqp_tpu_torch.ops import chain_cr as ccr
    from treeqp_tpu_torch.ops import chain_kernels as ck
    from treeqp_tpu_torch.ops import crown_kernels as ckr
    from treeqp_tpu_torch.ops import crown_riccati as crk
    from treeqp_tpu_torch.ops import df_eval_kernels as dek
    from treeqp_tpu_torch.ops import df_reduce as dr
    from treeqp_tpu_torch.ops import iter_kernel as ik
    from treeqp_tpu_torch.ops import jay_kernel as jk
    from treeqp_tpu_torch.ops import qpgen_lanes as ql
    from treeqp_tpu_torch.ops import riccati_kernels as rk
    from treeqp_tpu_torch.ops import system_kernels as sk
    from treeqp_tpu_torch.solvers import ipm
    from treeqp_tpu_torch.solvers import ipm_multistage as ims
    from treeqp_tpu_torch.solvers import ms_df64 as md
    from treeqp_tpu_torch.solvers import sdunes as sd
    from treeqp_tpu_torch.solvers import tdunes as td
    from treeqp_tpu_torch.solvers import tdunes_multistage as tm
    assert "jax" not in sys.modules

    # ---- 1. device and build
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    libpath = _build.build()
    _build.lib()
    t_build = time.perf_counter() - t_start
    print(f"build: {t_build:.1f} s -> {libpath.relative_to(ROOT)}")
    for line in Path(str(libpath) + ".ptxas.txt").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernels against their plain twins, main-path shapes
    opts = td.TdunesOpts(**SLICE_OPTS)
    opts2 = td.TdunesOpts(**TWO_PHASE_OPTS)
    optsb = td.TdunesOpts(**BENCH_OPTS)
    # the coarse phase's options inside the two-phase solve
    opts_coarse = dataclasses.replace(optsb, refine_steps=0, tol=optsb.f32_phase_tol,
                                      ls_batch=4)
    quad = quadcopter(MD, NR, NH, device="cpu")
    qp_cpu = quad.qp
    ms_cpu = tm.split_multistage(qp_cpu)
    ms = ms_cpu.to(dev)
    meta = ms.meta
    print(f"instance: quadcopter({MD},{NR},{NH}): {meta.full_topo.Nn} nodes, "
          f"S={meta.S} L={meta.L} nx={meta.nx} nu={meta.nu}, crown "
          f"{meta.crown_topo.Nn} nodes")
    prep = td._get_prep(meta.crown_topo)
    ctx = tm._solve_ctx(ms, prep)
    crown_data = td._stage_data(ms.crown, opts, prep)
    lam_cr = torch.zeros((meta.crown_topo.Nn, meta.crown_topo.nxm),
                         dtype=torch.float64, device=dev)
    lam_ch = torch.zeros_like(ms.q)
    cr, ch = tm._ms_stage_solve(ms, crown_data, lam_cr, lam_ch, opts, prep,
                                ctx["rid"])
    inp = tm._factor_inputs(cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"],
                            prep, ctx)
    reg = opts.reg_value
    results = []

    def measure(fn, ref_fn, inputs, ops, fp64=False, lib_fn=None):
        """A kernel's times (kernel, plain twin, the library call if any)
        and its bound from this run's operands: the bytes of ``inputs`` and
        of fn()'s outputs, each moved once, and ``ops`` operations at the
        FP32 (FP64 with ``fp64``) peak."""
        moved = nbytes(torch, inputs, fn())
        t_bytes, t_ops = moved / PEAK_BYTES, ops / PEAK_FLOPS[fp64]
        return dict(
            ms=cuda_ms(torch, fn, 50), plain_ms=cuda_ms(torch, ref_fn, 5),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if lib_fn is None else cuda_ms(torch, lib_fn, 50),
            moved=moved)

    def record(name, source, replaces, err, fn, ref_fn, shapes, inputs, ops,
               fp64=False, lib_fn=None, m=None):
        """One kernel's line of the JSON summary (see ``measure``); ``m``
        is a measurement already taken on these operands, if any."""
        m = dict(m or measure(fn, ref_fn, inputs, ops, fp64, lib_fn))
        moved = m.pop("moved")
        results.append(dict(
            name=name, route="cuda", source=f"treeqp_tpu_torch/csrc/{source}",
            replaces=replaces, max_abs_err=err, **m,
            shapes=f"{shapes}; {moved} B, {ops:.4g} {'FP64' if fp64 else 'FP32'} ops"))

    def crown_ops(sched, factor, nz=None):
        """Operations of a crown factor (with the block build of each
        group when ``nz`` is given) or solve on ``sched``."""
        G, n, nlev = sched.G, sched.nxm, len(sched.lev_child)
        if not factor:
            return nlev * (2 * G * G + 4 * n * G) + 2 * G * G
        ops = nlev * (chol_ops(G) + trsm_ops(n, G) + syrk_ops(n, G)) + chol_ops(G)
        if nz is not None:
            ops += sched.NpG * (2 * G * G * nz + 3 * G * G + 3 * n * G)
        return ops

    # operation counts of the multistage kernels at the headline shapes
    S_, L_, nx_, nz_ = meta.S, meta.L, meta.nx, meta.nx + meta.nu
    Nc_ = meta.crown_topo.Nn

    def chain_factor_ops(shape, build=False):
        S, L, nx = shape[:3]
        per = nx * nx + chol_ops(nx) + trsm_ops(nx, nx) + syrk_ops(nx, nx)
        if build:
            per += 2 * nx * nx * shape[3] + 4 * nx * nx
        return S * L * per

    system_ops = S_ * L_ * 6 * nx_ * nx_ + crown_ops(ckr._get_sched(prep), False)
    chain_eval_ops = S_ * L_ * (4 * nx_ * nz_ + 12 * nz_)
    crown_eval_ops = Nc_ * (4 * nx_ * nz_ + 12 * nz_)
    chain_apply_ops = S_ * L_ * (4 * nx_ * nz_ + 4 * nz_)
    crown_apply_ops = Nc_ * (4 * nx_ * nz_ + 4 * nz_)

    def record_graph(name, source, replaces, err, fn, ref_fn, shapes, inputs, ops, fp64=False,
                     lib_fn=None, lib_note=""):
        """record() with the kernel's time in a CUDA graph (``graph_ms``),
        and the library call's (``library_graph_ms``) where there is one."""
        m = measure(fn, ref_fn, inputs, ops, fp64, lib_fn)
        m.update(graph_ms=graph_ms(torch, fn))
        lib = ""
        if lib_fn is not None:
            m.update(library_graph_ms=graph_ms(torch, lib_fn))
            lib = (f"; library call {m['library_ms']:.4f} ms alone, {m['library_graph_ms']:.4f} "
                   f"ms in a CUDA graph ({lib_note})")
        print(f"{name} ({shapes}): kernel {m['ms']:.4f} ms alone, {m['graph_ms']:.4f} ms in a "
              f"CUDA graph{lib} on {card}")
        record(name, source, replaces, err, fn, ref_fn, shapes, inputs, ops, fp64, m=m)

    def blocks_library(W, Ut):
        """The library call of the chain block factors: cholesky_ex of each
        chain's equilibrated blocks as one [L n, L n] matrix (the form of
        chain_factor's), and its distance to the twin's factors."""
        M = chain_blocks_matrix(torch, W, Ut)
        chol = lambda: torch.linalg.cholesky_ex(M).L
        Ls_t, CUs_t, _ = ck.chain_factor_ref(W, Ut)
        err_ = float((chol() - chain_factor_matrix(torch, Ls_t, CUs_t)).abs().max())
        return chol, (f"cholesky_ex of the [{M.shape[1]}]^2 chain matrices, |diff| to the "
                      f"twin's factors {err_:.3e}")

    c_ref = ck.chain_blocks_factor_ref(*inp["chain"])
    c_got = ck.chain_blocks_factor(*inp["chain"])
    torch.cuda.synchronize()
    lib_cbf, note_cbf = blocks_library(*ck.chain_blocks(*inp["chain"])[:2])
    record_graph("chain_blocks_factor", "chain_blocks_factor.cu",
                 "treeqp_tpu/ops/chain_kernels.py:311",
                 compare(torch, "chain_blocks_factor", c_got, c_ref, FACTOR_RTOL),
                 lambda: ck.chain_blocks_factor(*inp["chain"]),
                 lambda: ck.chain_blocks_factor_ref(*inp["chain"]),
                 f"ABt {tuple(inp['chain'][0].shape)}", inp["chain"],
                 chain_factor_ops(inp["chain"][0].shape, build=True), lib_fn=lib_cbf,
                 lib_note=note_cbf)

    Ls, CUs, schur0, sc = c_ref
    Wadd = -tm._schur_scatter(schur0, ctx["g_of"], ctx["slot"], prep, prep.nxm)
    cargs = (*inp["crown"], Wadd, prep)
    w_ref = ckr.crown_blocks_factor_ref(*cargs, reg=reg)
    w_got = ckr.crown_blocks_factor(*cargs, reg=reg)
    torch.cuda.synchronize()
    sched_h = ckr._get_sched(prep)

    def crown_library(W, Ut, sched, reg_, ref):
        """The library call of the crown factor kernels: cholesky_ex of the
        crown as one dense matrix (crown_matrix, W_g + reg_ I on its
        diagonal); its distance to the twin's factors ``ref`` (placed as
        the dense lower factor) and its info (0: positive definite)."""
        M = crown_matrix(torch, W, Ut, sched, reg=reg_)
        chol = lambda: torch.linalg.cholesky_ex(M).L
        Lf, info = torch.linalg.cholesky_ex(M)
        return chol, float((Lf - crown_matrix(torch, *ref, sched, factor=True)).abs().max()), \
            int(info)

    def crown_times(name, fn, ref_fn, inputs, ops, lib_fn, lib_err, shapes):
        """measure() with the library call, and kernel and library call in a
        CUDA graph; printed."""
        m = measure(fn, ref_fn, inputs, ops, lib_fn=lib_fn)
        m.update(graph_ms=graph_ms(torch, fn), library_graph_ms=graph_ms(torch, lib_fn))
        print(f"{name} ({shapes}): kernel {m['ms']:.4f} ms alone, {m['graph_ms']:.4f} ms in a "
              f"CUDA graph; library call {m['library_ms']:.4f} / {m['library_graph_ms']:.4f} ms "
              f"({lib_err}); plain twin {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms "
              f"({m['bound_by']}) on {card}")
        return m

    chol_h, lib_err_h, info_h = crown_library(*ckr._crown_blocks(*cargs[:-1]), sched_h, reg, w_ref)
    shapes_h = f"CholW {tuple(w_ref[0].shape)}"
    m_cbf = crown_times(
        "crown_blocks_factor", lambda: ckr.crown_blocks_factor(*cargs, reg=reg),
        lambda: ckr.crown_blocks_factor_ref(*cargs, reg=reg), (cargs[:-1], sched_h.on(dev)),
        crown_ops(sched_h, True, nz=inp["crown"][0].shape[-1]), chol_h,
        f"cholesky_ex of the [{sched_h.NpG * sched_h.G}]^2 crown matrix, |diff| to the twin's "
        f"factors {lib_err_h:.3e}, info {info_h}", shapes_h)
    # both crown factor kernels, and crown_solve on the twin's factors with
    # a seeded right-hand side, against their twins at the multistage
    # crowns of the solvers' paths (the headline, sdunes' bootstrap, 1024
    # scenarios; timed) and at their kernels' edges, on seeded operands;
    # the generic solver's crowns follow in its tree checks below
    crown_errs = {}
    for k, (what, tree, nz_e, reg_e, zero) in enumerate(
            [("headline", (4, 4, 6), 10, CROWN_REG, False),
             ("bootstrap", (4, 4, 8), 9, CROWN_REG, False),
             ("1024 scenarios", (4, 5, 6), 10, CROWN_REG, False)]
            + [(f"edge md={e[0]}, Nr={e[1]}, nx={e[2]}", e[:3], e[2] + 2, e[3], e[4])
               for e in CROWN_EDGES]):
        p_e = crown_prep(*tree)
        s_e = ckr._get_sched(p_e)
        bargs, (W_e, Ut_e) = crown_operands(torch, s_e, nz_e, 30 + k, dev, zero=zero)
        fns = {"crown_factor": (lambda: ckr.crown_factor(W_e, Ut_e, p_e, reg=reg_e),
                                lambda: ckr.crown_factor_ref(W_e, Ut_e, p_e, reg=reg_e)),
               "crown_blocks_factor": (
                   lambda: ckr.crown_blocks_factor(*bargs, p_e, reg=reg_e),
                   lambda: ckr.crown_blocks_factor_ref(*bargs, p_e, reg=reg_e))}
        times = []
        for name, (fn, ref_fn) in fns.items():
            got = fn()
            torch.cuda.synchronize()
            crown_errs[what, name] = compare(torch, f"{name} ({what}, G={s_e.G}, reg={reg_e:g})",
                                             got, ref_fn(), FACTOR_RTOL)
            if k < 3:
                times.append(f"{name} {graph_ms(torch, fn):.4f}")
        fac_e = ckr.crown_factor_ref(W_e, Ut_e, p_e, reg=reg_e)
        rg_e = crown_rhs(torch, s_e, 60 + k, dev)
        solve_e = lambda: ckr.crown_solve(*fac_e, rg_e, p_e)
        got = solve_e()
        torch.cuda.synchronize()
        crown_errs[what, "crown_solve"] = compare(
            torch, f"crown_solve ({what}, G={s_e.G}, launch {ckr._solve_launch(s_e)})", [got],
            [ckr.crown_solve_ref(*fac_e, rg_e, p_e)], SOLVE_RTOL)
        if k < 3:
            times.append(f"crown_solve {graph_ms(torch, solve_e):.4f}")
        if times:
            print(f"crown kernels ({what}: NpG={s_e.NpG}, G={s_e.G}; seeded): "
                  f"{', '.join(times)} ms in a CUDA graph on {card}")
    crown_solve_err = max(v for (w, n), v in crown_errs.items() if n == "crown_solve")
    print(f"crown_factor, crown_blocks_factor, crown_solve at the multistage crowns and at their "
          f"kernels' edges {CROWN_EDGES} (md, Nr, nx, reg, zero block): max |diff| to the twins "
          f"{max(v for (w, n), v in crown_errs.items() if n != 'crown_solve'):.3e} (factors), "
          f"{crown_solve_err:.3e} (crown_solve)")
    record("crown_blocks_factor", "crown_blocks_factor.cu",
           "treeqp_tpu/ops/crown_kernels.py:332",
           compare(torch, "crown_blocks_factor", w_got, w_ref, FACTOR_RTOL),
           lambda: ckr.crown_blocks_factor(*cargs, reg=reg),
           lambda: ckr.crown_blocks_factor_ref(*cargs, reg=reg),
           f"{shapes_h}; cholesky_ex |diff| to the twin's factors {lib_err_h:.3e}; seeded at "
           "the bootstrap's and the 1024-scenario crowns and the edges, max |diff| "
           f"{max(v for (w, n), v in crown_errs.items() if n == 'crown_blocks_factor'):.3e}",
           (cargs[:-1], sched_h.on(dev)),
           crown_ops(sched_h, True, nz=inp["crown"][0].shape[-1]), m=m_cbf)

    CholW, CholUt = w_ref
    res_cr = td._dual_residual(ms.crown, cr, prep)
    res_ch = tm._chain_residual(ms, ch, cr["x"], cr["u"], ctx["rid"])
    rg = td._nodes_to_group_mm(res_cr * inp["s_node"], prep)
    rch = res_ch * sc
    sargs = (Ls, CUs, CholW, CholUt, rg, rch, prep, meta.root_ids)
    s_ref = sk.system_solve_ref(*sargs)
    s_got = sk.system_solve(*sargs)
    torch.cuda.synchronize()
    err_s = compare(torch, "system_solve", s_got, s_ref, SOLVE_RTOL)
    # the library call: cholesky_solve with the whole tree's stored factors
    # as one dense lower f32 factor (system_matrix, ~2.8 GB at the headline)
    F_s = system_matrix(torch, Ls, CUs, CholW, CholUt, prep, meta.root_ids)
    v_s = system_vector(torch, rg.float(), rch.float(), prep)
    lib_s = lambda: torch.cholesky_solve(v_s, F_s)
    err_ls = compare(torch, "system_solve's library call (cholesky_solve)",
                     system_vector(torch, rg, rch, prep, x=lib_s()), s_ref, SOLVE_RTOL)
    # system_solve at its kernel's shapes (seeded factors): the bootstrap's
    # G = 32, 1024 scenarios, G = 48 (block 0's crown), three chains of one
    # node; graph times printed
    sys_errs = []
    for k, (what, shape) in enumerate(SYSTEM_SHAPES):
        so = system_operands(torch, *shape, k, dev)
        fn_e = lambda: sk.system_solve(*so)
        sys_errs.append(compare(torch, f"system_solve ({what})", fn_e(),
                                sk.system_solve_ref(*so), SOLVE_RTOL))
        print(f"system_solve ({what}, seeded): {graph_ms(torch, fn_e):.4f} ms in a CUDA graph, "
              f"|diff| to the twin {sys_errs[-1]:.3e} on {card}")
    record_graph("system_solve", "system_solve.cu", "treeqp_tpu/ops/system_kernels.py:74",
                 err_s, lambda: sk.system_solve(*sargs), lambda: sk.system_solve_ref(*sargs),
                 f"rch {tuple(rch.shape)}, rg {tuple(rg.shape)}; at {len(SYSTEM_SHAPES)} "
                 f"seeded shapes max |diff| {max(sys_errs):.3e}",
                 (sargs[:6], ckr._get_sched(prep).on(dev), sk.ms_sched(prep, meta.root_ids, dev)),
                 system_ops, lib_fn=lib_s,
                 lib_note=f"cholesky_solve with the [{F_s.shape[0]}]^2 dense factor, |diff| to "
                          f"the twin {err_ls:.3e}")
    del F_s, lib_s
    torch.cuda.empty_cache()

    # the coarse phase's first iteration: f32 data, duals 0
    ms32 = ms.to(dtype=torch.float32)
    data_ch, data_cr = tm._eval_data(ms32, prep)
    ctx32 = tm._solve_ctx(ms32, prep)
    lam_cr32 = lam_cr.to(torch.float32)
    lam_ch32 = lam_ch.to(torch.float32)
    floats = lambda o, keys: [o[k] for k in keys]
    e_ref = ck.chain_eval_ref(data_ch, lam_ch32)
    e_got = ck.chain_eval(data_ch, lam_ch32)
    torch.cuda.synchronize()
    keys = ("x", "u", "xUnc", "uUnc", "res_part", "cqr", "fch")
    err = compare(torch, "chain_eval", floats(e_got, keys), floats(e_ref, keys), EVAL_RTOL)
    compare_sets(torch, "chain_eval", e_got, e_ref, ("qt", "rt"))
    # and at the chain evaluation kernel's edges (EVAL_DF_EDGES), on the
    # seeded data in f32
    ce_edge_err = 0.0
    for k, shape in enumerate(EVAL_DF_EDGES):
        de, lam_e, _ = eval_df_operands(torch, *shape, EVAL_DF_SEED + k, dev)
        de = {key: v.float() for key, v in de.items()}
        ce_ref = ck.chain_eval_ref(de, lam_e.float())
        ce_got = ck.chain_eval(de, lam_e.float())
        torch.cuda.synchronize()
        what = f"chain_eval (S, L, nx, nu = {shape})"
        ce_edge_err = max(ce_edge_err, compare(torch, what, floats(ce_got, keys),
                                               floats(ce_ref, keys), EVAL_RTOL))
        compare_sets(torch, what, ce_got, ce_ref, ("qt", "rt"))
    print(f"chain_eval at its kernel's edges {EVAL_DF_EDGES} (S, L, nx, nu; f32): max |diff| "
          f"to the twin {ce_edge_err:.3e}, active sets equal")
    record_graph("chain_eval", "chain_eval.cu", "treeqp_tpu/ops/chain_kernels.py:402",
                 max(err, ce_edge_err), lambda: ck.chain_eval(data_ch, lam_ch32),
                 lambda: ck.chain_eval_ref(data_ch, lam_ch32),
                 f"ABt {tuple(data_ch['ABt'].shape)}, launch "
                 f"{ck.chain_node_launch(S_, L_, nx_, nz_ - nx_, 4)}; edges {EVAL_DF_EDGES} max "
                 f"|diff| {ce_edge_err:.3e}", (data_ch, lam_ch32), chain_eval_ops)

    extra = torch.zeros_like(data_cr["ABt"][:, 0])
    extra[ctx["rid"]] = e_ref["cqr"]
    r_ref = ckr.crown_eval_ref(data_cr, lam_cr32, extra, prep)
    r_got = ckr.crown_eval(data_cr, lam_cr32, extra, prep)
    torch.cuda.synchronize()
    keys = ("x", "u", "xUnc", "uUnc", "res", "fcr")
    err = compare(torch, "crown_eval", floats(r_got, keys), floats(r_ref, keys), EVAL_RTOL)
    compare_sets(torch, "crown_eval", r_got, r_ref, ("qtilde", "rtilde"))
    # and at its kernel's edges (CROWN_EVAL_EDGES), the seeded crowns in f32
    cr_edge_err = 0.0
    for k, edge in enumerate(CROWN_EVAL_EDGES):
        de, lam_e, extra_e, prep_e = crown_eval_operands(torch, *edge, CROWN_EVAL_SEED + k, dev)
        ce_args = ({key: v.float() for key, v in de.items()}, lam_e.float(), extra_e.float(),
                   prep_e)
        Nn_e = de["ABt"].shape[0]
        what = (f"crown_eval (md, Nr, nx, nu = {edge}: {Nn_e} nodes, launch "
                f"{ckr._crown_eval_launch(Nn_e, *edge[2:])})")
        ce_got, ce_ref = ckr.crown_eval(*ce_args), ckr.crown_eval_ref(*ce_args)
        cr_edge_err = max(cr_edge_err, compare(torch, what, floats(ce_got, keys),
                                               floats(ce_ref, keys), EVAL_RTOL))
        compare_sets(torch, what, ce_got, ce_ref, ("qtilde", "rtilde"))
    print(f"crown_eval at its kernel's edges {CROWN_EVAL_EDGES} (md, Nr, nx, nu; f32): max "
          f"|diff| to the twin {cr_edge_err:.3e}, active sets equal")
    Nc_e = data_cr["ABt"].shape[0]
    record_graph("crown_eval", "crown_eval.cu", "treeqp_tpu/ops/crown_kernels.py:466",
                 max(err, cr_edge_err), lambda: ckr.crown_eval(data_cr, lam_cr32, extra, prep),
                 lambda: ckr.crown_eval_ref(data_cr, lam_cr32, extra, prep),
                 f"ABt {tuple(data_cr['ABt'].shape)}, launch "
                 f"{ckr._crown_eval_launch(Nc_e, nx_, nz_ - nx_)}; edges {CROWN_EVAL_EDGES} max "
                 f"|diff| {cr_edge_err:.3e}",
                 (data_cr, lam_cr32, extra, ckr.eval_sched(prep, dev)), crown_eval_ops)

    largs = tm._factor_inputs(r_ref["qtilde"], r_ref["rtilde"], e_ref["qt"],
                              e_ref["rt"], prep, ctx32, lanes=True)["chain"]
    l_ref = ck.chain_blocks_factor_lanes_ref(*largs)
    l_got = ck.chain_blocks_factor_lanes(*largs)
    torch.cuda.synchronize()
    ABl, qtl, rtl, ztpl, sl = largs
    lib_cbl, note_cbl = blocks_library(
        *ck.chain_blocks(ABl, ck.lanes_ztp(qtl, rtl, ztpl), qtl, sl)[:2])
    record_graph("chain_blocks_factor_lanes", "chain_blocks_factor.cu",
                 "treeqp_tpu/ops/chain_kernels.py:534",
                 compare(torch, "chain_blocks_factor_lanes", l_got, l_ref, FACTOR_RTOL),
                 lambda: ck.chain_blocks_factor_lanes(*largs),
                 lambda: ck.chain_blocks_factor_lanes_ref(*largs),
                 f"ABt {tuple(largs[0].shape)}", largs,
                 chain_factor_ops(largs[0].shape, build=True), lib_fn=lib_cbl,
                 lib_note=note_cbl)
    # both forms at their kernel's edges, kernel against twin
    edge_err = 0.0
    for k, (S_e, L_e, nx_e, nz_e) in enumerate(BLOCK_EDGES):
        st_e, la_e = block_operands(torch, S_e, L_e, nx_e, nz_e, k, dev)
        what = f"at S={S_e}, L={L_e}, nx={nx_e}, nz={nz_e}"
        edge_err = max(edge_err,
                       compare(torch, f"chain_blocks_factor {what}", ck.chain_blocks_factor(*st_e),
                               ck.chain_blocks_factor_ref(*st_e), FACTOR_RTOL),
                       compare(torch, f"chain_blocks_factor_lanes {what}",
                               ck.chain_blocks_factor_lanes(*la_e),
                               ck.chain_blocks_factor_lanes_ref(*la_e), FACTOR_RTOL))
    print(f"chain_blocks_factor(_lanes) at their kernel's edges {BLOCK_EDGES} (S, L, nx, nz): "
          f"max |diff| to the twins {edge_err:.3e}")

    iter_keys = ("dcr", "dch", "lam2_cr", "lam2_ch", "res2_cr", "res2_ch", "x",
                 "u", "cx", "cu", "xUnc", "uUnc", "cxUnc", "cuUnc")
    part_keys = ("f1p", "dotp", "errp")
    set_keys = ("qt", "rt", "qtilde", "rtilde")

    def iter_outputs(o):
        return [o[k] for k in iter_keys] + [p for k in part_keys for p in o[k]]

    state = dict(lam_cr=lam_cr32, lam_ch=lam_ch32)
    iargs = (data_ch, data_cr, None, state, prep, meta.root_ids)
    v_ref = ik.newton_iter_ref(*iargs, mode="eval")
    v_got = ik.newton_iter(*iargs, mode="eval")
    torch.cuda.synchronize()
    err_eval = compare(torch, "newton_iter(eval)", iter_outputs(v_got),
                       iter_outputs(v_ref), EVAL_RTOL)
    compare_sets(torch, "newton_iter(eval)", v_got, v_ref, set_keys)
    ms_eval = cuda_ms(torch, lambda: ik.newton_iter(*iargs, mode="eval"), 50)
    fact = tm._ms_factorize(ms32, v_ref["qtilde"], v_ref["rtilde"], v_ref["qt"],
                            v_ref["rt"], td.TdunesOpts(**TWO_PHASE_OPTS), prep,
                            ctx32, lanes=True)
    state = dict(state, res_cr=v_ref["res2_cr"], res_ch=v_ref["res2_ch"])
    iargs = (data_ch, data_cr, fact, state, prep, meta.root_ids)
    i_ref = ik.newton_iter_ref(*iargs, mode="iter")
    i_got = ik.newton_iter(*iargs, mode="iter")
    torch.cuda.synchronize()
    err = compare(torch, "newton_iter(iter)", iter_outputs(i_got), iter_outputs(i_ref),
                  SOLVE_RTOL)
    near = dict(
        qt=near_bound(torch, i_ref["xUnc"], data_ch["xmin"], data_ch["xmax"],
                      torch.ones_like(data_ch["xmin"])),
        rt=near_bound(torch, i_ref["uUnc"], data_ch["umin"], data_ch["umax"],
                      torch.ones_like(data_ch["umin"])),
        qtilde=near_bound(torch, i_ref["cxUnc"], data_cr["xmin"], data_cr["xmax"],
                          data_cr["xm"]),
        rtilde=near_bound(torch, i_ref["cuUnc"], data_cr["umin"], data_cr["umax"],
                          data_cr["um"]))
    exempt = compare_sets(torch, "newton_iter(iter)", i_got, i_ref, set_keys, near)

    def check_iter(what, ev_args, it_args):
        """newton_iter in both modes against its twin (eval to EVAL_RTOL
        with the active sets equal, iter to SOLVE_RTOL with those bits held
        away from a bound); returns (max |diff|, bits exempted)."""
        e_got = ik.newton_iter(*ev_args, mode="eval")
        e_ref = ik.newton_iter_ref(*ev_args, mode="eval")
        torch.cuda.synchronize()
        worst = compare(torch, f"newton_iter(eval) {what}", iter_outputs(e_got),
                        iter_outputs(e_ref), EVAL_RTOL)
        compare_sets(torch, f"newton_iter(eval) {what}", e_got, e_ref, set_keys)
        t_got = ik.newton_iter(*it_args, mode="iter")
        t_ref = ik.newton_iter_ref(*it_args, mode="iter")
        torch.cuda.synchronize()
        worst = max(worst, compare(torch, f"newton_iter(iter) {what}", iter_outputs(t_got),
                                   iter_outputs(t_ref), SOLVE_RTOL))
        dc, dr = it_args[0], it_args[1]
        near_e = dict(
            qt=near_bound(torch, t_ref["xUnc"], dc["xmin"], dc["xmax"],
                          torch.ones_like(dc["xmin"])),
            rt=near_bound(torch, t_ref["uUnc"], dc["umin"], dc["umax"],
                          torch.ones_like(dc["umin"])),
            qtilde=near_bound(torch, t_ref["cxUnc"], dr["xmin"], dr["xmax"], dr["xm"]),
            rtilde=near_bound(torch, t_ref["cuUnc"], dr["umin"], dr["umax"], dr["um"]))
        return worst, compare_sets(torch, f"newton_iter(iter) {what}", t_got, t_ref,
                                   set_keys, near_e)

    # the kernel's edges (ITER_EDGES), both modes
    iter_edge_err, iter_edge_exempt = 0.0, 0
    for model, margs in ITER_EDGES:
        e, x = check_iter(f"{model}{margs}", *iter_operands(torch, iter_edge_qp(model, margs),
                                                            dev))
        iter_edge_err, iter_edge_exempt = max(iter_edge_err, e), iter_edge_exempt + x
    print(f"newton_iter at its kernel's edges {ITER_EDGES} (both modes): max |diff| to the "
          f"twin {iter_edge_err:.3e}, iter-mode active-set bits exempt near a bound "
          f"{iter_edge_exempt}")
    m_iter = measure(lambda: ik.newton_iter(*iargs, mode="iter"),
                     lambda: ik.newton_iter_ref(*iargs, mode="iter"),
                     (data_ch, data_cr, fact, state, ik.iter_sched(prep, meta.root_ids, dev)),
                     system_ops + chain_eval_ops + crown_eval_ops)
    m_iter.update(graph_ms=graph_ms(torch, lambda: ik.newton_iter(*iargs, mode="iter")))
    g_eval = graph_ms(torch, lambda: ik.newton_iter(*iargs[:2], None,
                                                    dict(lam_cr=lam_cr32, lam_ch=lam_ch32),
                                                    *iargs[4:], mode="eval"))
    print(f"newton_iter (S={meta.S}, L={meta.L}): iter {m_iter['ms']:.4f} ms alone, "
          f"{m_iter['graph_ms']:.4f} ms in a CUDA graph; eval {ms_eval:.4f} ms alone, "
          f"{g_eval:.4f} ms in a CUDA graph on {card}")
    record("newton_iter", "newton_iter.cu", "treeqp_tpu/ops/iter_kernel.py:79",
           max(err, err_eval, iter_edge_err), lambda: ik.newton_iter(*iargs, mode="iter"),
           lambda: ik.newton_iter_ref(*iargs, mode="iter"),
           f"S={meta.S} L={meta.L} crown {data_cr['ABt'].shape[0]} nodes; mode eval "
           f"{ms_eval:.4f} ms (graph {g_eval:.4f} ms), max |diff| {err_eval:.3e}; iter-mode "
           f"active-set bits exempt near a bound: {exempt}; edges {ITER_EDGES} max |diff| "
           f"{iter_edge_err:.3e}",
           (data_ch, data_cr, fact, state, ik.iter_sched(prep, meta.root_ids, dev)),
           system_ops + chain_eval_ops + crown_eval_ops, m=m_iter)

    # the high-precision phase's kernels at its first point on the bench
    # path: the duals the coarse phase ends with
    lam_cr_h, lam_ch_h, it_h, _ = tm._ms_newton_loop_mega(
        ms32, lam_cr32, lam_ch32, opts_coarse, 0, patience=optsb.f32_patience)
    dd = md.make_dd(ms, prep)
    lam_crd = lam_cr_h.double() * dd["cr"]["nrxm"]
    lam_chd = lam_ch_h.double()
    keys = ("x", "u", "qt", "rt", "xUnc", "uUnc", "res_part", "cqr", "fch")
    akeys = ("xl", "ul", "res_part", "cqr")
    # both chain kernels at their edges (EVAL_DF_EDGES), on seeded data:
    # chain_eval_df bit for bit, chain_apply_df to DF_RTOL
    ev_edge_err = ap_edge_err = 0.0
    for k, (S_e, L_e, nx_e, nu_e) in enumerate(EVAL_DF_EDGES):
        de, lam_e, d_e = eval_df_operands(torch, S_e, L_e, nx_e, nu_e, EVAL_DF_SEED + k, dev)
        what = f"(S={S_e}, L={L_e}, nx={nx_e}, nu={nu_e})"
        e_ref = dek.chain_eval_df_ref(de, lam_e)
        e_got = dek.chain_eval_df(de, lam_e)
        a_ref = dek.chain_apply_df_ref(de, e_ref["qt"], e_ref["rt"], d_e)
        a_got = dek.chain_apply_df(de, e_ref["qt"], e_ref["rt"], d_e)
        torch.cuda.synchronize()
        ev_edge_err = max(ev_edge_err, bit_exact(torch, f"chain_eval_df {what}",
                                                 floats(e_got, keys), floats(e_ref, keys)))
        ap_edge_err = max(ap_edge_err, compare(torch, f"chain_apply_df {what}",
                                               floats(a_got, akeys), floats(a_ref, akeys),
                                               DF_RTOL))
    print(f"chain_eval_df, chain_apply_df at their kernels' edges {EVAL_DF_EDGES} (S, L, nx, "
          f"nu): max |diff| to the twins {ev_edge_err:.3e} (bit for bit) / {ap_edge_err:.3e}")
    ch_ref = dek.chain_eval_df_ref(dd["ch"], lam_chd)
    ch_got = dek.chain_eval_df(dd["ch"], lam_chd)
    torch.cuda.synchronize()
    record_graph("chain_eval_df", "chain_eval_df.cu", "treeqp_tpu/ops/df_eval_kernels.py:93",
                 max(bit_exact(torch, "chain_eval_df", floats(ch_got, keys),
                               floats(ch_ref, keys)), ev_edge_err),
                 lambda: dek.chain_eval_df(dd["ch"], lam_chd),
                 lambda: dek.chain_eval_df_ref(dd["ch"], lam_chd),
                 f"ABt {tuple(dd['ch']['ABt'].shape)} f64, after {it_h} coarse iterations, "
                 f"launch {ck.chain_node_launch(S_, L_, nx_, nz_ - nx_, 8)}; edges {EVAL_DF_EDGES} "
                 f"bit for bit", (dd["ch"], lam_chd), chain_eval_ops, fp64=True)
    extra = md._root_extra(dd, ch_ref["cqr"])
    keys = ("x", "u", "qtilde", "rtilde", "xUnc", "uUnc", "res", "fcr")
    cr_ref = dek.crown_eval_df_ref(dd["cr"], lam_crd, extra, prep)
    cr_got = dek.crown_eval_df(dd["cr"], lam_crd, extra, prep)
    torch.cuda.synchronize()
    cr_err = bit_exact(torch, "crown_eval_df", floats(cr_got, keys), floats(cr_ref, keys))
    # and at its kernel's edges (CROWN_EVAL_EDGES), on seeded crowns
    for k, edge in enumerate(CROWN_EVAL_EDGES):
        ce_args = crown_eval_operands(torch, *edge, CROWN_EVAL_SEED + k, dev)
        Nn_e = ce_args[0]["ABt"].shape[0]
        cr_err = max(cr_err, bit_exact(
            torch, f"crown_eval_df (md, Nr, nx, nu = {edge}: {Nn_e} nodes, launch "
                   f"{ckr._crown_eval_launch(Nn_e, *edge[2:])})",
            floats(dek.crown_eval_df(*ce_args), keys),
            floats(dek.crown_eval_df_ref(*ce_args), keys)))
    print(f"crown_eval_df at its kernel's edges {CROWN_EVAL_EDGES} (md, Nr, nx, nu): bit for "
          "bit the twin")
    Nc_d = dd["cr"]["ABt"].shape[0]
    record_graph("crown_eval_df", "crown_eval_df.cu", "treeqp_tpu/ops/df_eval_kernels.py:399",
                 cr_err, lambda: dek.crown_eval_df(dd["cr"], lam_crd, extra, prep),
                 lambda: dek.crown_eval_df_ref(dd["cr"], lam_crd, extra, prep),
                 f"ABt {tuple(dd['cr']['ABt'].shape)} f64, launch "
                 f"{ckr._crown_eval_launch(Nc_d, nx_, nz_ - nx_)}; edges {CROWN_EVAL_EDGES} "
                 "bit for bit", (dd["cr"], lam_crd, extra, ckr.eval_sched(prep, dev)),
                 crown_eval_ops, fp64=True)
    # an f32 direction on the path: the dual gradient there
    res_crd, res_chd = md.df_residuals(dd, cr_ref, ch_ref)
    dcr, dch = res_crd.float(), res_chd.float()
    aargs = (dd["ch"], ch_ref["qt"], ch_ref["rt"], dch)
    a_ref = dek.chain_apply_df_ref(*aargs)
    a_got = dek.chain_apply_df(*aargs)
    torch.cuda.synchronize()
    record_graph("chain_apply_df", "chain_apply_df.cu", "treeqp_tpu/ops/df_eval_kernels.py:237",
                 max(compare(torch, "chain_apply_df", floats(a_got, akeys),
                             floats(a_ref, akeys), DF_RTOL), ap_edge_err),
                 lambda: dek.chain_apply_df(*aargs), lambda: dek.chain_apply_df_ref(*aargs),
                 f"d {tuple(dch.shape)} f32, launch "
                 f"{ck.chain_node_launch(S_, L_, nx_, nz_ - nx_, 8, apply=True)}; edges "
                 f"{EVAL_DF_EDGES} max |diff| {ap_edge_err:.3e}", aargs, chain_apply_ops,
                 fp64=True)
    cargs = (dd["cr"], cr_ref["qtilde"], cr_ref["rtilde"], dcr,
             md._root_extra(dd, a_ref["cqr"]), prep)
    keys = ("xl", "ul", "res")
    c_ref = dek.crown_apply_df_ref(*cargs)
    c_got = dek.crown_apply_df(*cargs)
    torch.cuda.synchronize()
    ca_err = bit_exact(torch, "crown_apply_df", floats(c_got, keys), floats(c_ref, keys))
    # and at its kernel's edges (CROWN_EVAL_EDGES), on seeded crowns and
    # directions
    ca_edge_err = 0.0
    for k, edge in enumerate(CROWN_EVAL_EDGES):
        ca_args = crown_apply_operands(torch, *edge, CROWN_EVAL_SEED + k, dev)
        Nn_e = ca_args[0]["ABt"].shape[0]
        ca_edge_err = max(ca_edge_err, bit_exact(
            torch, f"crown_apply_df (md, Nr, nx, nu = {edge}: {Nn_e} nodes, launch "
                   f"{ckr._crown_eval_launch(Nn_e, *edge[2:])})",
            floats(dek.crown_apply_df(*ca_args), keys),
            floats(dek.crown_apply_df_ref(*ca_args), keys)))
    print(f"crown_apply_df at its kernel's edges {CROWN_EVAL_EDGES} (md, Nr, nx, nu): bit for "
          "bit the twin")
    record_graph("crown_apply_df", "crown_apply_df.cu", "treeqp_tpu/ops/df_eval_kernels.py:555",
                 max(ca_err, ca_edge_err), lambda: dek.crown_apply_df(*cargs),
                 lambda: dek.crown_apply_df_ref(*cargs),
                 f"d {tuple(dcr.shape)} f32, launch "
                 f"{ckr._crown_eval_launch(Nc_d, nx_, nz_ - nx_)}; edges {CROWN_EVAL_EDGES} "
                 "bit for bit", (cargs[:-1], ckr.eval_sched(prep, dev)),
                 crown_apply_ops, fp64=True)
    # the phase's two reductions: the dual value's partials and the
    # directional derivative's terms
    fx = torch.cat([cr_ref["fcr"], ch_ref["fch"]])
    gx = torch.cat([(res_crd * dcr).reshape(-1), (res_chd * dch).reshape(-1)])
    r_got = [dr.df_reduce_flat(fx), dr.df_reduce_flat(gx)]
    r_ref = [dr.df_reduce_flat_ref(fx), dr.df_reduce_flat_ref(gx)]
    torch.cuda.synchronize()
    err_r = bit_exact(torch, "df_reduce_flat", r_got, r_ref)
    # and at the edges of its forms (REDUCE_EDGES), on seeded data
    red_rng = np.random.default_rng(REDUCE_SEED)
    for n_r in REDUCE_EDGES:
        x_r = torch.tensor(red_rng.standard_normal(n_r) * 10.0 ** red_rng.integers(-3, 4, n_r),
                           dtype=torch.float64, device=dev)
        err_r = max(err_r, bit_exact(torch, f"df_reduce_flat (n={n_r})",
                                     [dr.df_reduce_flat(x_r)], [dr.df_reduce_flat_ref(x_r)]))
    red = lambda: dr.df_reduce_flat(gx)
    red_lib = lambda: torch.sum(gx)
    m_red = measure(red, lambda: dr.df_reduce_flat_ref(gx), gx, gx.numel(), True, red_lib)
    m_red.update(graph_ms=graph_ms(torch, red), library_graph_ms=graph_ms(torch, red_lib))
    fx_alone = cuda_ms(torch, lambda: dr.df_reduce_flat(fx), 50)
    fx_graph = graph_ms(torch, lambda: dr.df_reduce_flat(fx))
    fx_lib = cuda_ms(torch, lambda: torch.sum(fx), 50)
    fx_lib_graph = graph_ms(torch, lambda: torch.sum(fx))
    print(f"df_reduce_flat (gx, n={gx.numel()}): kernel {m_red['ms']:.4f} ms alone, "
          f"{m_red['graph_ms']:.4f} ms in a CUDA graph; torch.sum {m_red['library_ms']:.4f} / "
          f"{m_red['library_graph_ms']:.4f} ms; (fx, n={fx.numel()}): kernel {fx_alone:.4f} / "
          f"{fx_graph:.4f} ms, torch.sum {fx_lib:.4f} / {fx_lib_graph:.4f} ms; bit for bit the "
          f"twin at n in {REDUCE_EDGES} on {card}")
    record("df_reduce_flat", "df_reduce.cu", "treeqp_tpu/ops/df_reduce.py:72", err_r,
           red, lambda: dr.df_reduce_flat_ref(gx),
           f"n {gx.numel()} (the dual value's: {fx.numel()}, {fx_alone:.4f} ms, "
           f"{fx_graph:.4f} ms in a graph); edges n in {REDUCE_EDGES} bit for bit",
           gx, gx.numel(), fp64=True, m=m_red)
    # the generic-tree solver's tree-Cholesky kernels on each of its paths'
    # instances: the headline tree pruned to GEN_SCEN scenarios (split path;
    # timed) and the unpruned headline tree (split path, 256 chains) at their
    # cold start (zero duals), the asymmetric tree (crown path) two
    # iterations on
    optsg = td.TdunesOpts(**GENERIC_SPEED_OPTS)
    qg_cpu = pruned(qp_cpu, GEN_SCEN)
    qg = qg_cpu.to(dev)
    prepg = td._get_prep(qg.topo)
    split = td._split_sched(prepg)
    if split is None:
        fail("the pruned instance has no split schedule")
    print(f"generic instance: quadcopter({MD},{NR},{NH}) pruned to {GEN_SCEN} "
          f"scenarios: {qg.topo.Nn} nodes, {prepg.NpG} lambda-groups of dim "
          f"{prepg.G}, split into {len(split[0])} chain levels of {split[0][0][1]} "
          f"chains and {len(split[1])} crown levels")
    qa = asym_tree(device=dev)
    if td._split_sched(td._get_prep(qa.topo)) is not None:
        fail("the asymmetric tree has a split schedule")
    qp = qp_cpu.to(dev)
    # the general C/D trees of general_cd_bench (section 6)
    qc_cpu = general_cd("qpgen", device="cpu")
    qm_cpu = general_cd("mixed", device="cpu")
    qc, qm = qc_cpu.to(dev), qm_cpu.to(dev)
    optsc = td.TdunesOpts(**GENERAL_CD_OPTS)
    optsm = dataclasses.replace(optsc, stage_solver="mixed")
    # the options tdunes_solve derives from the data, for the calls below
    # that skip it
    optsc_d = dataclasses.replace(optsc, h_diag=True)
    optsm_d = dataclasses.replace(optsm, h_diag=True,
                                  node_solver=td.clipping_applicable_nodes(qm_cpu))
    print(f"general C/D instance: spring_mass_chain(4,4,4,20) with rows: {qc.topo.Nn} "
          f"nodes, nx={qc.topo.nxm} nu={qc.topo.num}, a row on every node (qpgen) or on "
          f"{qm.topo.Nn - sum(optsm_d.node_solver)} nodes (mixed), "
          f"{td._get_prep(qc.topo).NpG} lambda-groups of dim {td._get_prep(qc.topo).G}")

    def tree_chol_checks(q, tag, it, o=optsg):
        """Each tree-Cholesky kernel tdunes_solve launches on q, held against
        its twin on the operands at the dual point of the it-th iterate of
        the one-phase solve (0: the cold start; run through the plain twins
        on the CPU), in the order of _tree_chol_factor and _tree_chol_solve.
        Returns record()'s arguments by kernel name."""
        p = td._get_prep(q.topo)
        regg = o.reg_value
        lam = torch.zeros((q.topo.Nn, q.topo.nxm), dtype=torch.float64, device=dev)
        if it:
            o_it = dataclasses.replace(o, f32_phase_tol=0.0, max_iter=it)
            lam = td.tdunes_solve(q.to("cpu"), None, o_it).lam.to(dev)
        data = td._stage_data(q, o, p)
        sol = td._stage_solve(q, lam, data, o, p)
        sW, W, Ut = td._equilibrate(*td._build_dual_hessian(q, sol, data, o, p), p)
        rg = (td._nodes_to_group_mm(td._dual_residual(q, sol, p), p) * sW).float()
        out = {}

        def check(name, source, replaces, fn, ref_fn, rtol, shapes, inputs, ops):
            ref, got = ref_fn(), fn()
            torch.cuda.synchronize()
            many = isinstance(ref, tuple)
            err = compare(torch, f"{name} ({tag})", got if many else [got],
                          ref if many else [ref], rtol)
            out[name] = (name, source, f"treeqp_tpu/ops/{replaces}", err, fn, ref_fn,
                         shapes, inputs, ops)
            return ref

        split_q = td._split_sched(p)
        levels, Wcr, Utcr, rcr = None, W, Ut, rg
        if split_q is not None:
            sp = td._split_index(p, split_q, dev)
            n, K, Nc = p.nxm, p.K, sp["Nc"]
            Wc = (W[sp["chain"], :n, :n]
                  + regg * torch.eye(n, dtype=torch.float32, device=dev)).contiguous()
            Utc = Ut[sp["chain"], :, :n].contiguous()
            Ls, CUs, schur = check(
                "chain_factor", "chain_factor.cu", "chain_kernels.py:127",
                lambda: ck.chain_factor(Wc, Utc), lambda: ck.chain_factor_ref(Wc, Utc),
                FACTOR_RTOL, f"Wc {tuple(Wc.shape)}", (Wc, Utc), chain_factor_ops(Wc.shape))
            rch = rg[sp["chain"], :n].contiguous()
            sweep_ops = Wc.shape[0] * Wc.shape[1] * (3 * n * n + n)
            ys, radd = check(
                "chain_solve_bwd", "chain_sweeps.cu", "chain_kernels.py:175",
                lambda: ck.chain_solve_bwd(Ls, CUs, rch),
                lambda: ck.chain_solve_bwd_ref(Ls, CUs, rch), SOLVE_RTOL,
                f"res {tuple(rch.shape)}", (Ls, CUs, rch), sweep_ops)
            # the crown: the groups 0..Nc-1, with the chains' Schur blocks and
            # right-hand-side updates
            levels, Wcr, Utcr, rcr = sp["crown"], W[:Nc].clone(), Ut[:Nc], rg[:Nc].clone()
            Wcr.view(Nc, K, n, K, n)[sp["dad"], sp["slot"], :, sp["slot"], :] -= schur
            rcr.view(Nc, K, n)[sp["dad"], sp["slot"]] -= radd
        sched = ckr._get_sched(p, levels)
        crown_meta[tag] = (sched, regg)
        CholW, CholUt = check(
            "crown_factor", "crown_factor.cu", "crown_kernels.py:241",
            lambda: ckr.crown_factor(Wcr, Utcr, p, reg=regg, levels=levels),
            lambda: ckr.crown_factor_ref(Wcr, Utcr, p, reg=regg, levels=levels),
            FACTOR_RTOL, f"W {tuple(Wcr.shape)}, {sched.n_lev} levels",
            (Wcr, Utcr, sched.on(dev)), crown_ops(sched, True))
        dcr = check(
            "crown_solve", "crown_solve.cu", "crown_kernels.py:280",
            lambda: ckr.crown_solve(CholW, CholUt, rcr, p, levels=levels),
            lambda: ckr.crown_solve_ref(CholW, CholUt, rcr, p, levels=levels),
            SOLVE_RTOL, f"rg {tuple(rcr.shape)}", (CholW, CholUt, rcr, sched.on(dev)),
            crown_ops(sched, False))
        if split_q is not None:
            droot = dcr.view(Nc, K, n)[sp["dad"], sp["slot"]].contiguous()
            check("chain_forward", "chain_sweeps.cu", "chain_kernels.py:207",
                  lambda: ck.chain_forward(Ls, CUs, ys, droot),
                  lambda: ck.chain_forward_ref(Ls, CUs, ys, droot), SOLVE_RTOL,
                  f"ys {tuple(ys.shape)}", (Ls, CUs, ys, droot), sweep_ops)
        return out

    # the asymmetric tree's cold start is ill-conditioned (its root block's
    # Schur complement cancels: a 1-ulp rsqrt difference shows as ~1e-5 in
    # its factor, tests/test_torch_generic_kernels.py), so its kernels are
    # held against their twins two iterations on; the general C/D tree's
    # blocks are the dense-P ones, W = Cf P Cf' (G = 32)
    crown_meta = {}  # the crown's schedule and shift of each tree
    checks = {tag: tree_chol_checks(q, tag, it, o) for tag, q, it, o in (
        ("pruned", qg, 0, optsg), ("asymmetric", qa, 2, optsg), ("unpruned", qp, 0, optsg),
        ("general C/D", qc, 0, optsc_d))}
    def chain_matrix(Ls, CUs):
        """Each chain's factor as one [L n, L n] matrix, lower triangular
        with its blocks in reversed order: Ls_{L-1-k} on the diagonal, CUs_{L-k}
        below it. The backward sweep solves it, the forward sweep its
        transpose: the library call beside the sweep kernels."""
        S, L, n, _ = Ls.shape
        T = torch.zeros((S, L * n, L * n), dtype=Ls.dtype, device=Ls.device)
        for k in range(L):
            T[:, k * n:(k + 1) * n, k * n:(k + 1) * n] = Ls[:, L - 1 - k]
            if k:
                T[:, k * n:(k + 1) * n, (k - 1) * n:k * n] = CUs[:, L - k]
        return T

    rev = lambda v: v.flip(1).reshape(v.shape[0], -1, 1).contiguous()
    _mv_t = lambda M, v: torch.einsum("sij,si->sj", M, v)  # M' v per chain

    def sweep_library(Ls, CUs, res, ys, droot):
        """The library calls of the backward and forward sweeps on these
        operands (batched torch.linalg.solve_triangular on chain_matrix and
        its transpose, the root term folded into the right-hand side
        beforehand), and the larger of their distances to the serial
        twins."""
        T = chain_matrix(Ls, CUs)
        Tt = T.mT.contiguous()
        rb = rev(res)
        rhs = ys.clone()
        rhs[:, 0] -= _mv_t(CUs[:, 0], droot)
        rf = rev(rhs)
        bwd = lambda: torch.linalg.solve_triangular(T, rb, upper=False)
        fwd = lambda: torch.linalg.solve_triangular(Tt, rf, upper=True)
        unrev = lambda v: v.reshape(ys.shape).flip(1)
        err = max(float((unrev(bwd()) - ck.chain_solve_bwd_ref(Ls, CUs, res)[0]).abs().max()),
                  float((unrev(fwd()) - ck.chain_forward_ref(Ls, CUs, ys, droot)).abs().max()))
        return bwd, fwd, err

    def factor_library(Wc, Utc, need_pd=True):
        """The library call of chain_factor on these operands:
        torch.linalg.cholesky_ex of each chain's blocks as one [L n, L n]
        matrix in chain_matrix's reversed block order (Wc_{L-1-k} on the
        diagonal, Utc_{L-k} and its transpose beside it), whose factor holds
        Ls and CUs_1 .. CUs_{L-1} (CUs_0 and schur0 couple the chain to the
        crown, outside the matrix); its distance to the twin's blocks; and
        the count of chain matrices that are not positive definite (a
        failure when ``need_pd``)."""
        M = chain_blocks_matrix(torch, Wc, Utc)
        chol = lambda: torch.linalg.cholesky_ex(M).L
        bad = int((torch.linalg.cholesky_ex(M).info != 0).sum())
        if bad and need_pd:
            fail("chain_factor's library call: the chain matrix is not positive definite")
        Ls, CUs, _ = ck.chain_factor_ref(Wc, Utc)
        return chol, float((chol() - chain_matrix(Ls, CUs)).abs().max()), bad

    def factor_times(tag, Wc, Utc):
        """chain_factor on these operands: measure() with cholesky_ex as the
        library call, and kernel and library call in a CUDA graph; printed."""
        fn = lambda: ck.chain_factor(Wc, Utc)
        chol, lib_err, bad = factor_library(Wc, Utc, need_pd=tag == "pruned")
        m = measure(fn, lambda: ck.chain_factor_ref(Wc, Utc), (Wc, Utc),
                    chain_factor_ops(Wc.shape), lib_fn=chol)
        m.update(graph_ms=graph_ms(torch, fn), library_graph_ms=graph_ms(torch, chol))
        print(f"chain_factor ({tag}, Wc {tuple(Wc.shape)}): kernel {m['ms']:.4f} ms alone, "
              f"{m['graph_ms']:.4f} ms in a CUDA graph; cholesky_ex {m['library_ms']:.4f} / "
              f"{m['library_graph_ms']:.4f} ms (|diff| to the twin's blocks {lib_err:.3e}, "
              f"{bad} of {Wc.shape[0]} chain matrices not positive definite); "
              f"plain twin {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms "
              f"({m['bound_by']}) on {card}")
        return m, lib_err

    # the sweeps on every tree they are held on: kernel, plain twin, bound
    # and library call (the pruned tree's in the JSON summary)
    sweep_times, sweep_lib_errs = {}, {}
    for tag, c in checks.items():
        if "chain_solve_bwd" not in c:
            continue
        Ls_t, CUs_t, rch_t = c["chain_solve_bwd"][7]
        ys_t, droot_t = c["chain_forward"][7][2:]
        lb, lf, le = sweep_library(Ls_t, CUs_t, rch_t, ys_t, droot_t)
        for name, lib_fn in (("chain_solve_bwd", lb), ("chain_forward", lf)):
            _, _, _, err, fn, ref_fn, shapes, inputs, ops = c[name]
            m = sweep_times[tag, name] = measure(fn, ref_fn, inputs, ops, lib_fn=lib_fn)
            m.update(graph_ms=graph_ms(torch, fn), library_graph_ms=graph_ms(torch, lib_fn))
            sweep_lib_errs[tag, name] = le
            print(f"sweep {name} ({tag}, {shapes}, Ls {tuple(Ls_t.shape)}): kernel "
                  f"{m['ms']:.4f} ms, plain twin {m['plain_ms']:.4f} ms, bound "
                  f"{m['bound_ms']:.6f} ms ({m['bound_by']}), library call (solve_triangular) "
                  f"{m['library_ms']:.4f} ms (|diff| {le:.3e}); in a CUDA graph (the card's "
                  f"time, no host launch) kernel {m['graph_ms']:.4f} ms, library call "
                  f"{m['library_graph_ms']:.4f} ms; |diff| to the twin {err:.3e} on {card}")

    def sweep_others(name):
        return "".join(
            f"; {tag}: {m['ms']:.4f} / {m['plain_ms']:.4f} / {m['bound_ms']:.6f} / "
            f"{m['library_ms']:.4f} ms"
            for (tag, k), m in sweep_times.items() if k == name and tag != "pruned")

    Ls_g, CUs_g = checks["pruned"]["chain_solve_bwd"][7][:2]
    # chain_factor on every split-path tree (the pruned tree's in the JSON)
    factor_m = {tag: factor_times(tag, *c["chain_factor"][7])
                for tag, c in checks.items() if "chain_factor" in c}
    chol_err = factor_m["pruned"][1]
    # crown_factor and crown_solve on the pruned tree's crown beside their
    # library calls: cholesky_ex of the crown as one dense matrix, and
    # cholesky_solve with the twin's factors as one dense lower factor
    sched_p, reg_p = crown_meta["pruned"]
    c_p = checks["pruned"]
    chol_p, lib8_err, info8 = crown_library(*c_p["crown_factor"][7][:2], sched_p, reg_p,
                                            c_p["crown_solve"][7][:2])
    F_p = crown_matrix(torch, *c_p["crown_solve"][7][:2], sched_p, factor=True)
    v_p = crown_vector(torch, c_p["crown_solve"][7][2], sched_p)
    solve_p = lambda: torch.cholesky_solve(v_p, F_p)
    lib9_err = float((crown_vector(torch, solve_p().view(-1), sched_p, back=True)
                      - c_p["crown_solve"][5]()).abs().max())
    crown_m, crown_lib = {}, {
        "crown_factor": (chol_p, f"the library call (cholesky_ex of the crown matrix, info "
                                 f"{info8}) |diff| to the twin's factors {lib8_err:.3e}"),
        "crown_solve": (solve_p, f"the library call (cholesky_solve with the twin's factors as "
                                 f"one matrix) |diff| to the twin {lib9_err:.3e}")}
    for name, (lib_fn, note) in crown_lib.items():
        _, _, _, _, fn, ref_fn, shapes, inputs, ops = c_p[name]
        crown_m[name] = crown_times(name, fn, ref_fn, inputs, ops, lib_fn, note,
                                    f"pruned, {shapes}")
    # crown_solve on every generic crown, in a CUDA graph
    for tag, c in checks.items():
        sched_t = crown_meta[tag][0]
        print(f"crown_solve ({tag}: NpG={sched_t.NpG}, G={sched_t.G}, {sched_t.n_lev} levels, "
              f"launch {ckr._solve_launch(sched_t)}): {graph_ms(torch, c['crown_solve'][4]):.4f} "
              f"ms in a CUDA graph on {card}")
    for name, source, replaces, _, fn, ref_fn, shapes, inputs, ops in checks["pruned"].values():
        errs = {tag: c[name][3] for tag, c in checks.items() if name in c}
        lib = ""
        if ("pruned", name) in sweep_times:
            lib = (f"; the library call (solve_triangular) |diff| "
                   f"{sweep_lib_errs['pruned', name]:.3e}; kernel / plain / bound / library "
                   f"on the other trees{sweep_others(name)}")
        elif name == "chain_factor":
            lib = f"; the library call (cholesky_ex) |diff| to Ls, CUs_1.. {chol_err:.3e}"
        elif name in crown_lib:
            lib = f"; {crown_lib[name][1]}"
        if name == "crown_solve":
            errs["seeded multistage crowns and edges"] = crown_solve_err
        m = (factor_m["pruned"][0] if name == "chain_factor"
             else crown_m.get(name, sweep_times.get(("pruned", name))))
        record(name, source, replaces, max(errs.values()), fn, ref_fn,
               f"{shapes}; max |diff| "
               + ", ".join(f"{tag} {e:.3e}" for tag, e in errs.items()) + lib,
               inputs, ops, m=m)

    # the ring of the sweep kernels at its edges: chains shorter than, as
    # long as and longer than the ring, odd n (4-byte copies) and even n
    # (16-byte copies), and a chain count that fills no group of chains a
    # block, on seeded blocks built as tests/test_torch_chain_cr.py's
    # blocks() builds them
    edge_rng = np.random.default_rng(0)
    edge_err = cf_err = 0.0
    for L_e in (1, 2, 17):
        for n_e in (1, 5, 6, 8, 16):
            A_e = edge_rng.standard_normal((5, L_e, n_e, n_e))
            Wc_e = torch.tensor(A_e @ A_e.transpose(0, 1, 3, 2) + 3.0 * np.eye(n_e),
                                dtype=torch.float32, device=dev)
            Ut_e = torch.tensor(0.3 * edge_rng.standard_normal((5, L_e, n_e, n_e)),
                                dtype=torch.float32, device=dev)
            Ls_e, CUs_e, schur_e = ck.chain_factor_ref(Wc_e, Ut_e)
            cf_err = max(cf_err, compare(torch, f"chain_factor at S=5, L={L_e}, n={n_e}",
                                         ck.chain_factor(Wc_e, Ut_e), (Ls_e, CUs_e, schur_e),
                                         FACTOR_RTOL))
            r_e = torch.tensor(edge_rng.standard_normal((5, L_e, n_e)),
                               dtype=torch.float32, device=dev)
            d_e = torch.tensor(edge_rng.standard_normal((5, n_e)),
                               dtype=torch.float32, device=dev)
            ys_e, radd_e = ck.chain_solve_bwd_ref(Ls_e, CUs_e, r_e)
            got = [*ck.chain_solve_bwd(Ls_e, CUs_e, r_e),
                   ck.chain_forward(Ls_e, CUs_e, ys_e, d_e)]
            torch.cuda.synchronize()
            edge_err = max(edge_err, compare(
                torch, f"serial sweeps at S=5, L={L_e}, n={n_e}", got,
                [ys_e, radd_e, ck.chain_forward_ref(Ls_e, CUs_e, ys_e, d_e)], SOLVE_RTOL))
    # and chain_factor on a chain much longer than its ring, of the widest
    # blocks it takes
    A_e = edge_rng.standard_normal((4, 130, 16, 16))
    Wc_e = torch.tensor(A_e @ A_e.transpose(0, 1, 3, 2) + 3.0 * np.eye(16),
                        dtype=torch.float32, device=dev)
    Ut_e = torch.tensor(0.3 * edge_rng.standard_normal((4, 130, 16, 16)),
                        dtype=torch.float32, device=dev)
    cf_err = max(cf_err, compare(torch, "chain_factor at S=4, L=130, n=16",
                                 ck.chain_factor(Wc_e, Ut_e), ck.chain_factor_ref(Wc_e, Ut_e),
                                 FACTOR_RTOL))
    print(f"serial sweeps at the ring's edges (S=5, L in (1, 2, 17), n in (1, 5, 6, 8, 16)): "
          f"max |diff| to the twins {edge_err:.3e}; chain_factor there and at S=4, L=130, "
          f"n=16: {cf_err:.3e}")

    def admm_check(q, o, tag, lam):
        """admm_identify against its twin at a cold stage solve of q's
        coarse phase (f32 data) at the duals lam, on the general nodes; the
        working sets both seed must be equal. Returns (operands, max |diff|,
        operations, description, active rows)."""
        q = q.to(dtype=torch.float32)
        p = td._get_prep(q.topo)
        data = td._stage_data(q, o, p)
        hmod = torch.cat(td._modified_gradient(q, lam.to(q.dtype), p), dim=1)
        d = data.get("gen", data)
        if "idx" in d:
            hmod = hmod[d["idx"]]
        lo_c, hi_c, m_eq = td._general_bounds(d["lo"], d["hi"], d["m_lo"], d["m_hi"])
        args = td._admm_operands(hmod, d["Hinv"], d["G"], lo_c, hi_c, d["rho_row"],
                                 d["L_admm"])
        ref = ql.admm_identify_ref(*args, o.qpgen_iters)
        got = ql.admm_identify(*args, o.qpgen_iters)
        torch.cuda.synchronize()
        err = compare(torch, f"admm_identify ({tag})", [got], [ref], ADMM_RTOL)
        sets = [td._admm_working_sets(lm, d["rho_row"], d["m_lo"], d["m_hi"], m_eq)
                for lm in (got, ref)]
        for a, b in zip(*sets):
            if not torch.equal(a, b):
                fail(f"admm_identify ({tag}): the working sets it seeds differ from the "
                     f"twin's in {int((a != b).sum())} rows")
        N, ng, nz = args[0].shape
        it = o.qpgen_iters
        ops = N * (2 * ng * nz + 2 * ng + it * (4 * ng * nz + 2 * nz * nz + 6 * ng + nz))
        n_act = int(sum(m.sum() for m in sets[1]))
        bits = float((got == ref).float().mean())
        return args, err, ops, (f"G {tuple(args[0].shape)} f32, {it} iterations, {n_act} "
                                f"active rows, {100 * bits:.1f}% of lm bit-equal"), n_act

    # the first cold stage solve (duals 0: nothing active yet; timed) and
    # the cold stage solve at the end of the coarse phase (rows active)
    it_a = optsc.qpgen_iters
    checks_a = {}
    for tag, q, o_solve, o in (("qpgen", qc, optsc, optsc_d), ("mixed", qm, optsm, optsm_d)):
        zero = torch.zeros((q.topo.Nn, q.topo.nxm), dtype=torch.float64, device=dev)
        lam_c = td.tdunes_solve(q, None, dataclasses.replace(o_solve, max_iter=5)).lam
        checks_a[tag] = [admm_check(q, o, f"{tag}, {what}", lam)
                         for what, lam in (("duals 0", zero), ("coarse end", lam_c))]
        if checks_a[tag][1][4] <= 0:
            fail(f"admm_identify ({tag}): no active row at the coarse phase's end")
    ac, am = checks_a["qpgen"][0], checks_a["mixed"][0]
    errs_a = {f"{tag} {i}": c[1] for tag, cs in checks_a.items() for i, c in enumerate(cs)}
    # the f64 instantiation (qpgen_factor_dtype="same" on f64 data) on the
    # same operands
    a64 = [a.double() for a in checks_a["qpgen"][1][0]]
    got64, ref64 = ql.admm_identify(*a64, it_a), ql.admm_identify_ref(*a64, it_a)
    torch.cuda.synchronize()
    errs_a["qpgen f64"] = compare(torch, "admm_identify (f64)", [got64], [ref64], ADMM_RTOL)
    # at the kernel's edges, f32 and f64, on seeded operands
    for k, (N_e, ng_e, nz_e) in enumerate(ADMM_EDGES):
        f64_too = k >= len(ADMM_EDGES) - 2
        for dt_e in (torch.float32, torch.float64) if f64_too else (torch.float32,):
            a_e = admm_operands(torch, N_e, ng_e, nz_e, dt_e, k, dev)
            errs_a[f"edge {k} {dt_e}"] = compare(
                torch, f"admm_identify at N={N_e}, ng={ng_e}, nz={nz_e}, {dt_e}",
                [ql.admm_identify(*a_e, it_a)], [ql.admm_identify_ref(*a_e, it_a)], ADMM_RTOL)
    print(f"admm_identify at its kernel's edges {ADMM_EDGES} (N, ng, nz; the last two also "
          f"in f64): max |diff| to the twin "
          f"{max(v for t, v in errs_a.items() if t.startswith('edge')):.3e}")
    record_graph("admm_identify", "admm_identify.cu", "treeqp_tpu/ops/qpgen_lanes.py:189",
                 max(errs_a.values()), lambda: ql.admm_identify(*ac[0], it_a),
                 lambda: ql.admm_identify_ref(*ac[0], it_a),
                 f"{ac[3]}; mixed subset {am[3]}, "
                 f"{cuda_ms(torch, lambda: ql.admm_identify(*am[0], it_a), 20):.4f} ms; at the "
                 f"coarse phase's end: qpgen {checks_a['qpgen'][1][3]}, mixed "
                 f"{checks_a['mixed'][1][3]}; max |diff| {max(errs_a.values()):.3e}",
                 ac[0], ac[2])

    for r in results:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), library call "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
              f"max |diff| {r['max_abs_err']:.3e} [{r['shapes']}] on {card}")

    # ---- 3. main paths on the card, certified and held against the CPU
    ms_kernels = (ck.chain_blocks_factor, ckr.crown_blocks_factor, sk.system_solve,
                  ck.chain_eval, ckr.crown_eval, ck.chain_blocks_factor_lanes,
                  ik.newton_iter, dek.chain_eval_df, dek.crown_eval_df,
                  dek.chain_apply_df, dek.crown_apply_df, dr.df_reduce_flat)
    generic_kernels = (ck.chain_factor, ck.chain_solve_bwd, ck.chain_forward,
                       ckr.crown_factor, ckr.crown_solve)
    ipm_kernels = (rk.ric_chain_factor, rk.ric_chain_bwd, rk.ric_chain_fwd,
                   crk.crown_ric_factor, crk.crown_ric_solve)
    sd_kernels = (ck.chain_full_solve_mat, jk.jay_cr_solve)
    cr_kernels = (ccr.chain_cr_precompute, ccr.chain_solve_bwd_cr, ccr.chain_forward_cr)
    kernels = (ms_kernels + generic_kernels + (ql.admm_identify,) + ipm_kernels + sd_kernels
               + cr_kernels)
    ms_names = tuple(k.__name__ for k in ms_kernels)
    generic_names = tuple(k.__name__ for k in generic_kernels)
    admm_name = ("admm_identify",)
    ipm_names = tuple(k.__name__ for k in ipm_kernels)
    sd_names = tuple(k.__name__ for k in sd_kernels)
    cr_names = tuple(k.__name__ for k in cr_kernels)
    df_kernels = ("chain_eval_df", "crown_eval_df", "chain_apply_df",
                  "crown_apply_df", "df_reduce_flat")
    paths = {}

    def drive(path, needs, fn, forbid=generic_names + admm_name, ipm_path=False,
              sd_path=False, cr_path=False):
        """Run one main path with every launch count set to 0 just before
        it; read the counts just after. Each kernel in ``needs`` must have
        launched, none in ``forbid``, none of the IPM's Riccati kernels
        unless ``ipm_path``, none of sdunes' two unless ``sd_path`` and none
        of the CR sweeps unless ``cr_path`` (no solver calls them)."""
        if not ipm_path:
            forbid = tuple(forbid) + ipm_names
        if not sd_path:
            forbid = tuple(forbid) + sd_names
        if not cr_path:
            forbid = tuple(forbid) + cr_names
        for fn_k in kernels:
            fn_k.launches = 0
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        paths[path] = {fn_k.__name__: fn_k.launches for fn_k in kernels}
        print(f"launches on the {path} path: {paths[path]}")
        for k in needs:
            if paths[path][k] <= 0:
                fail(f"{k} was not launched by the {path} path")
        for k in forbid:
            if paths[path][k] != 0:
                fail(f"{k} was launched by the {path} path")
        return out

    facs = [1.0 + PERT * math.sin(1.0 + 1.7 * (k + 1.0)) for k in range(N_REQUESTS)]
    insts = [perturbed(qp, ms, f) for f in facs]

    def certified(qp_k, ms_k, start, o, what):
        cro_k, cho_k, info_k = tm.tdunes_ms_solve(ms_k, *start, o)
        out_k = tm.merge_output(ms_k, cro_k, cho_k, info_k)
        kkt_k = max_kkt_residual(qp_k, out_k)
        if info_k["status"] != td.TDUNES_OPTIMAL or not info_k["error"] < TOL \
                or not kkt_k < TOL:
            fail(f"{what}: status {info_k['status']} error {info_k['error']} kkt {kkt_k}")
        if tuple(out_k.x.shape) != (ms_k.meta.full_topo.Nn, ms_k.meta.full_topo.nxm) \
                or not torch.isfinite(out_k.lam).all():
            fail(f"{what}: output of the wrong shape or not finite")
        return cro_k, cho_k, info_k, out_k, kkt_k

    def requests(o, n, modes, lam0, what):
        """Solve the first n perturbed instances in each mode (cold: zero
        duals; warm: the previous request's), each certified; returns
        {mode: (ms per solve, iterations, coarse iterations)}."""
        timing = {}
        for mode in modes:
            iters, coarse = [], []
            prev = lam0 or (None, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k, (qp_k, ms_k) in enumerate(insts[:n]):
                start = prev if mode == "warm" else (None, None)
                cro_k, cho_k, info_k, _, _ = certified(qp_k, ms_k, start, o,
                                                       f"{what} {mode} request {k}")
                iters.append(info_k["iter"])
                coarse.append(info_k["iter_f32"])
                prev = (cro_k["lam"], cho_k["lam"])
            torch.cuda.synchronize()
            timing[mode] = ((time.perf_counter() - t0) / n * 1e3, iters, coarse)
            print(f"requests {what} {mode}: iters {iters} (coarse {coarse}), "
                  f"{timing[mode][0]:.1f} ms/solve incl. KKT check on {card}")
        return timing

    def headline(o, what, same_iters=False):
        """The cold headline solve on the card, certified, and held against
        the same solve through the plain twins on the CPU: iteration counts
        within one (equal with ``same_iters``), the solutions within the
        slice tolerances."""
        t0 = time.perf_counter()
        cro, cho, info, out, kkt = certified(qp, ms, (None, None), o, what)
        t_solve = time.perf_counter() - t0
        print(f"{what}: iter {info['iter']} (coarse {info['iter_f32']}) status "
              f"{info['status']} error {info['error']:.3e} kkt {kkt:.3e} in "
              f"{t_solve * 1e3:.1f} ms (first solve, includes warm-up) on {card}")
        # the same solve through the plain twins on the CPU
        cro_c, cho_c, info_c = tm.tdunes_ms_solve(ms_cpu, None, None, o)
        out_c = tm.merge_output(ms_cpu, cro_c, cho_c, info_c)
        gaps = {f: float((getattr(out, f).cpu() - getattr(out_c, f)).abs().max())
                for f in ("x", "u", "lam")}
        print(f"{what}, card vs CPU plain path: iter {info['iter']} vs "
              f"{info_c['iter']}, coarse {info['iter_f32']} vs {info_c['iter_f32']}, "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
        slack = 0 if same_iters else 1
        if abs(info["iter"] - info_c["iter"]) > slack \
                or abs(info["iter_f32"] - info_c["iter_f32"]) > slack \
                or gaps["x"] > 1e-7 or gaps["u"] > 1e-7 or gaps["lam"] > 1e-6:
            fail(f"{what}: card and CPU solves disagree: {gaps}")
        return cro, cho, info

    # one-phase (slice 1): f64 loop, f32 factors, two refinement steps
    def one_phase():
        cro, cho, _ = headline(opts, "one-phase headline solve")
        return requests(opts, N_REQUESTS_1P, ("cold", "warm"),
                        (cro["lam"], cho["lam"]), "one-phase")
    t1 = drive("one-phase", ("chain_blocks_factor", "crown_blocks_factor",
                             "system_solve"), one_phase)

    # two-phase: coarse f32 phase on newton_iter, then the f64 loop
    def two_phase():
        cro, cho, info = headline(opts2, "two-phase headline solve")
        if info["iter_f32"] < 1:
            fail("two-phase headline solve ran no coarse iteration")
        return requests(opts2, N_REQUESTS, ("cold", "warm"),
                        (cro["lam"], cho["lam"]), "two-phase")
    t2 = drive("two-phase", ("newton_iter", "chain_blocks_factor_lanes",
                             "crown_blocks_factor", "system_solve",
                             "chain_blocks_factor"), two_phase)

    # the bench path: bench.py's options, the coarse phase then ms_df64's
    bench_head = {}  # the cold headline solve's info, for section 12's profiler

    def bench_path():
        cro, cho, info = headline(optsb, "bench-path headline solve", same_iters=True)
        bench_head.update(info)
        if info["iter_f32"] < 1 or info["iter"] <= info["iter_f32"]:
            fail(f"bench-path headline solve: phases {info}")
        return requests(optsb, N_REQUESTS_B, ("cold", "warm"),
                        (cro["lam"], cho["lam"]), "bench-path")
    tb = drive("bench", ("newton_iter", "chain_blocks_factor_lanes",
                         "crown_blocks_factor", "system_solve") + df_kernels, bench_path)

    # factorizations of one cold bench solve, and the handover: the
    # high-precision phase from the coarse phase's last duals with and
    # without the coarse phase's last factorization
    def handover():
        facs = (ck.chain_blocks_factor, ck.chain_blocks_factor_lanes)
        count = lambda: sum(k.launches for k in facs)
        _, _, info = tm.tdunes_ms_solve(ms, None, None, optsb)
        n_solve = count()
        z_cr = torch.zeros_like(lam_cr32)
        lam_cr, lam_ch, it0, ho = tm._ms_newton_loop_mega(
            ms32, z_cr, torch.zeros_like(lam_ch32), opts_coarse, 0,
            patience=optsb.f32_patience)
        n0 = count()
        cr, ch = md.df_stage_solve(dd, prep, lam_cr.double() * dd["cr"]["nrxm"],
                                   lam_ch.double())
        same = tm._pattern_equal((cr["qtilde"], cr["rtilde"], ch["qt"], ch["rt"]), ho[1])
        out_h = md.ms_newton_loop_df(ms, lam_cr.double(), lam_ch.double(), optsb, it0,
                                     handover=ho)
        n1 = count()
        out_n = md.ms_newton_loop_df(ms, lam_cr.double(), lam_ch.double(), optsb, it0)
        n2 = count()
        print(f"bench cold solve: {n_solve} factorizations ({info['iter']} iter, "
              f"{info['iter_f32']} coarse); the coarse phase {n0 - n_solve}, the "
              f"high-precision phase {n1 - n0} with the handover vs {n2 - n1} "
              f"without (patterns equal at the handover: {same}; iterations "
              f"{out_h[2]} vs {out_n[2]})")
        if same and n1 - n0 != n2 - n1 - 1:
            fail("the handover did not save the phase's first factorization")
        return dict(solve=n_solve, coarse=n0 - n_solve, df_handover=n1 - n0,
                    df_without=n2 - n1, pattern_equal=same)
    drive("bench handover", ("chain_blocks_factor_lanes",) + df_kernels, handover)

    # ---- 4. more requests
    # two-norm termination: the coarse phase's per-kernel loop
    opts2n = td.TdunesOpts(**{**TWO_PHASE_OPTS, "termination": "twonorm"})
    drive("two-phase two-norm", ("chain_eval", "crown_eval",
                                 "chain_blocks_factor_lanes"),
          lambda: requests(opts2n, N_REQUESTS_2N, ("cold", "warm"), None,
                           "two-phase two-norm"))
    print("per solve, one-phase vs two-phase vs bench path (ms incl. KKT check; "
          f"mean iterations, coarse share) on {card}:")
    for mode in ("cold", "warm"):
        (a, ia, _), (b, ib, cb), (c, ic, cc) = t1[mode], t2[mode], tb[mode]
        print(f"  {mode}: {a:.1f} ms ({statistics.mean(ia):.2f} iter) vs "
              f"{b:.1f} ms ({statistics.mean(ib):.2f} iter, "
              f"{statistics.mean(cb):.2f} coarse) vs {c:.1f} ms "
              f"({statistics.mean(ic):.2f} iter, {statistics.mean(cc):.2f} coarse)")

    # the 1024-scenario tree (1365-node crown): both coarse loops launch
    qp5_cpu = quadcopter(MD, 5, NH, device="cpu").qp
    qp5 = qp5_cpu.to(dev)
    ms5 = tm.split_multistage(qp5)

    def big():
        for o, what in ((opts2, "infnorm"), (opts2n, "two-norm"), (optsb, "bench")):
            t0 = time.perf_counter()
            _, _, info5, _, kkt5 = certified(qp5, ms5, (None, None), o,
                                             f"quadcopter({MD},5,{NH}) {what}")
            print(f"quadcopter({MD},5,{NH}) two-phase {what}: S={ms5.meta.S}, "
                  f"crown {ms5.meta.crown_topo.Nn} nodes, iter {info5['iter']} "
                  f"(coarse {info5['iter_f32']}) kkt {kkt5:.3e} in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first solve) on {card}")
    drive("1024-scenario", ("newton_iter", "crown_eval", "chain_eval") + df_kernels, big)

    # ---- 5. the generic-tree solver (slice 4)
    gfacs = [1.0 + PERT * math.sin(1.0 + 1.7 * (k + 1.0)) for k in range(N_REQUESTS_G)]
    ginsts = [perturbed(qg, None, f)[0] for f in gfacs]

    def g_certified(qp_k, lam0, what):
        """One tdunes_solve request, certified: OPTIMAL, stationarity
        < 1e-8, the port's KKT < GENERIC_KKT, finite output of the right
        shape. Returns (out, kkt, ms, factorizations)."""
        n0 = ckr.crown_factor.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = td.tdunes_solve(qp_k, lam0, optsg)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        kkt_k = max_kkt_residual(qp_k, out_k)
        info_k = out_k.info
        if info_k["status"] != td.TDUNES_OPTIMAL or not info_k["error"] < TOL \
                or not kkt_k < GENERIC_KKT:
            fail(f"{what}: status {info_k['status']} error {info_k['error']} kkt {kkt_k}")
        if tuple(out_k.x.shape) != (qp_k.topo.Nn, qp_k.topo.nxm) \
                or not torch.isfinite(out_k.lam).all():
            fail(f"{what}: output of the wrong shape or not finite")
        return out_k, kkt_k, t_ms, ckr.crown_factor.launches - n0

    def g_headline(q, q_cpu, what):
        """The first cold solve of q, certified, and held against the same
        solve through the plain twins on the CPU: iterations within one,
        x and u within 1e-7, lambda within 1e-6."""
        out, kkt, t_ms, nf = g_certified(q, None, what)
        info = out.info
        out_c = td.tdunes_solve(q_cpu, None, optsg)
        gaps = {f: float((getattr(out, f).cpu() - getattr(out_c, f)).abs().max())
                for f in ("x", "u", "lam")}
        print(f"{what} ({q.topo.Nn} nodes): iter {info['iter']} ({info['iter_f32']} "
              f"coarse + {info['iter'] - info['iter_f32']} final), error "
              f"{info['error']:.3e}, kkt {kkt:.3e}, {nf} factorizations, {t_ms:.1f} ms "
              f"(first solve); card vs CPU plain path: iter {info['iter']} vs "
              f"{out_c.info['iter']}, "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()) + f" on {card}")
        if abs(info["iter"] - out_c.info["iter"]) > 1 or gaps["x"] > 1e-7 \
                or gaps["u"] > 1e-7 or gaps["lam"] > 1e-6:
            fail(f"{what}: card and CPU solves disagree: {gaps}")
        return out

    def generic_split():
        out = g_headline(qg, qg_cpu, "generic headline solve")
        timing = {}
        for mode in ("cold", "warm"):
            prev, rows = out.lam, []
            for k, qp_k in enumerate(ginsts):
                o_k, kkt_k, t_k, nf_k = g_certified(
                    qp_k, prev if mode == "warm" else None, f"generic {mode} request {k}")
                rows.append((o_k.info["iter"], o_k.info["iter_f32"], t_k, nf_k, kkt_k))
                prev = o_k.lam
            timing[mode] = rows
            print(f"requests generic {mode}: iters {[r[0] for r in rows]} (coarse "
                  f"{[r[1] for r in rows]}), factorizations {[r[3] for r in rows]}, "
                  f"{statistics.mean(r[2] for r in rows):.1f} ms/solve (median "
                  f"{statistics.median(r[2] for r in rows):.1f}), max kkt "
                  f"{max(r[4] for r in rows):.3e} on {card}")
        return timing
    drive("generic split", generic_names, generic_split, forbid=ms_names + admm_name)

    # the crown path: the asymmetric thesis-class tree has no split schedule
    drive("generic crown", ("crown_factor", "crown_solve"),
          lambda: g_headline(qa, asym_tree(device="cpu"), "asymmetric tree"),
          forbid=ms_names + admm_name + ("chain_factor", "chain_solve_bwd", "chain_forward"))

    # tdunes_solve on the unpruned headline tree (split path, 256 chains)
    # against tdunes_ms_solve at bench options, on the same card
    def cross_check():
        out_g, kkt_g, t_g, _ = g_certified(qp, None, "generic solve of the headline tree")
        cro, cho, info = tm.tdunes_ms_solve(ms, None, None, optsb)
        out_m = tm.merge_output(ms, cro, cho, info)
        gaps = {f: float((getattr(out_g, f) - getattr(out_m, f)).abs().max())
                for f in ("x", "u", "lam")}
        print(f"headline tree, tdunes_solve vs tdunes_ms_solve (bench options): iter "
              f"{out_g.info['iter']} vs {info['iter']}, kkt {kkt_g:.3e} vs "
              f"{max_kkt_residual(qp, out_m):.3e}, "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items())
              + f", {t_g:.1f} ms on {card}")
        if gaps["x"] > 1e-7 or gaps["u"] > 1e-7:
            fail(f"tdunes_solve and tdunes_ms_solve disagree on the headline tree: {gaps}")
    drive("generic cross-check", generic_names + ("newton_iter",), cross_check,
          forbid=admm_name)

    # ---- 6. general C/D trees (slice 5)
    def c_certified(q, lam0, ws0, o, what):
        """One general C/D request, certified: OPTIMAL, stationarity below
        the options' tol, the port's KKT < 1e-8, finite output of the right
        shape. Returns (out, kkt, ms, factorizations, ADMM launches)."""
        nf0, na0 = ckr.crown_factor.launches, ql.admm_identify.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = td.tdunes_solve(q, lam0, o, stage_ws=ws0)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        kkt_k = max_kkt_residual(q, out_k)
        info_k = out_k.info
        if info_k["status"] != td.TDUNES_OPTIMAL or not info_k["error"] < o.tol \
                or not kkt_k < TOL:
            fail(f"{what}: status {info_k['status']} error {info_k['error']} kkt {kkt_k}")
        if tuple(out_k.x.shape) != (q.topo.Nn, q.topo.nxm) \
                or tuple(out_k.mu_d.shape) != (q.topo.Nn, q.topo.ncm) \
                or not all(bool(torch.isfinite(v).all()) for v in
                           (out_k.x, out_k.u, out_k.lam, out_k.mu_d)):
            fail(f"{what}: output of the wrong shape or not finite")
        return (out_k, kkt_k, t_ms, ckr.crown_factor.launches - nf0,
                ql.admm_identify.launches - na0)

    def c_line(what, out, kkt, t_ms, nf, na):
        info = out.info
        return (f"{what}: iter {info['iter']} ({info['iter_f32']} coarse + "
                f"{info['iter'] - info['iter_f32']} final), error {info['error']:.3e}, kkt "
                f"{kkt:.3e}, qpgen_res {info['qpgen_res']:.2e}, max |mu_d| "
                f"{float(out.mu_d.abs().max()):.3e}, {nf} factorizations, {na} ADMM "
                f"launches, {t_ms:.1f} ms")

    def general_qpgen():
        first = c_certified(qc, None, None, optsc, "general C/D qpgen cold solve")
        print(c_line(f"general C/D qpgen cold solve ({qc.topo.Nn} nodes)", *first)
              + f" (first solve, includes warm-up) on {card}")
        again = c_certified(qc, None, None, optsc, "general C/D qpgen cold solve (again)")
        print(c_line("general C/D qpgen cold solve (again)", *again) + f" on {card}")
        prev, rows = first[0], []
        for k in range(N_REQUESTS_CD):
            q_k = qc.replace(b=qc.b + CD_DB * (k + 1))
            r = c_certified(q_k, prev.lam, prev.info["qpgen_ws"], optsc,
                            f"general C/D qpgen warm request {k}")
            print(c_line(f"general C/D qpgen warm request {k} (b + {CD_DB * (k + 1):g})", *r)
                  + f" on {card}")
            rows.append(r)
            prev = r[0]
        print(f"requests general C/D qpgen warm: iters {[r[0].info['iter'] for r in rows]}, "
              f"ADMM launches {[r[4] for r in rows]}, "
              f"{statistics.mean(r[2] for r in rows):.1f} ms/solve (cold "
              f"{again[2]:.1f} ms), max kkt {max(r[1] for r in rows):.3e} on {card}")
        return first[0]
    out_qc = drive("general C/D qpgen", generic_names + admm_name, general_qpgen,
                   forbid=ms_names)

    def general_mixed():
        first = c_certified(qm, None, None, optsm, "general C/D mixed cold solve")
        print(c_line(f"general C/D mixed cold solve ({qm.topo.Nn} nodes)", *first)
              + f" (first solve) on {card}")
        again = c_certified(qm, None, None, optsm, "general C/D mixed cold solve (again)")
        print(c_line("general C/D mixed cold solve (again)", *again) + f" on {card}")
        return first[0]
    drive("general C/D mixed", generic_names + admm_name, general_mixed, forbid=ms_names)

    # the cold qpgen solve through the plain twins on the CPU, at the depth
    # CD_CPU_NR (the full tree takes ~6 minutes on the CPU)
    qs_cpu = general_cd("qpgen", Nr=CD_CPU_NR, device="cpu")
    out_s = c_certified(qs_cpu.to(dev), None, None, optsc, "general C/D qpgen, reduced")[0]
    t0 = time.perf_counter()
    out_cpu = td.tdunes_solve(qs_cpu, None, optsc)
    t_cpu = time.perf_counter() - t0
    gaps = {f: float((getattr(out_s, f).cpu() - getattr(out_cpu, f)).abs().max())
            for f in ("x", "u", "lam", "mu_d")}
    ic, ip = out_s.info, out_cpu.info
    print(f"general C/D qpgen cold solve at Nr={CD_CPU_NR} ({qs_cpu.topo.Nn} nodes), card vs "
          f"CPU plain path ({t_cpu:.1f} s on the CPU): iter {ic['iter']} vs {ip['iter']}, "
          f"coarse {ic['iter_f32']} vs {ip['iter_f32']}, "
          + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    if ic["iter"] != ip["iter"] or ic["iter_f32"] != ip["iter_f32"] \
            or gaps["x"] > CD_GAP or gaps["u"] > CD_GAP:
        fail(f"general C/D qpgen: card and CPU solves disagree: {gaps}")

    # ---- 7. the interior-point engine (slice 6)
    f32 = torch.float32
    opts_ipm = {k: ipm.IpmOpts(**v) for k, v in IPM_OPTS.items()}
    qa_cpu = general_cd("qpgen", device="cpu")        # path A: a row on every node
    qb_cpu = spring_mass_chain(4, 4, 4, 20, device="cpu")[0]  # B and C: box-only
    qc2_cpu = spring_mass_chain(4, 4, 3, 7, device="cpu")[0]  # C within the TPU caps
    msa_cpu, msb_cpu = tm.split_multistage(qa_cpu), tm.split_multistage(qb_cpu)
    qa, qb, qc2 = qa_cpu.to(dev), qb_cpu.to(dev), qc2_cpu.to(dev)
    msa, msb = msa_cpu.to(dev), msb_cpu.to(dev)
    print(f"IPM instances: A general_cd qpgen ({qa.topo.Nn} nodes, S={msa.meta.S} "
          f"L={msa.meta.L}, crown {msa.meta.crown_topo.Nn} nodes, nx={qa.topo.nxm} "
          f"nu={qa.topo.num}); B box-only spring_mass_chain(4,4,4,20) ({qb.topo.Nn} nodes); "
          f"C the same tree whole and spring_mass_chain(4,4,3,7) ({qc2.topo.Nn} nodes, "
          f"{qc2.topo.Nh + 1} stages)")

    def capture(wrappers, fn):
        """Run fn() with the wrappers ``names`` of each ``(mod, names)`` in
        ``wrappers`` recording the operands of every call; returns ({name:
        [(args, kwargs), ...]}, fn()'s result). A wrapper adds one to the
        count of the name its module binds, which during the capture is the
        stand-in: so each stand-in carries a count, and the kernels' own
        counts do not move (``drive`` sets them to 0 before each main path
        in any case)."""
        got, orig = {}, {(mod, n): getattr(mod, n) for mod, names in wrappers for n in names}

        def stand_in(mod, n):
            def w(*a, **k):
                got.setdefault(n, []).append((a, k))
                return orig[mod, n](*a, **k)
            w.launches = 0
            return w
        for mod, n in orig:
            setattr(mod, n, stand_in(mod, n))
        try:
            res = fn()
        finally:
            for (mod, n), f in orig.items():
                setattr(mod, n, f)
        return got, res

    def first_iteration(fn, key):
        """The operands each IPM kernel takes at the first f32 iteration of
        the solve fn(opts) of path ``key``."""
        one = ipm.IpmOpts(**{**IPM_OPTS[key], "max_iter": 1})
        got, _ = capture(((rk, ipm_names[:3]), (crk, ipm_names[3:])), lambda: fn(one))
        return {n: calls[0] for n, calls in got.items()}

    def stage_ops(nx, nz, part):
        """Operations of one Riccati stage (an FMA counts two)."""
        nu = nz - nx
        if part == "factor":
            return (chol_ops(nu) + 2 * nu * nu * nx + 2 * nx * nu * nx + 2 * nx * nx * nz
                    + 2 * nz * nz * nx + nz * nz)
        if part == "bwd":
            return 2 * nu * nu + 2 * nx * nu + 2 * nx * nx + 2 * nx * nz + nz
        return 2 * nx * nz + 2 * nu * nx + 2 * nx * nx

    ops_at = {
        "A": first_iteration(lambda o: ims.ipm_ms_solve(msa, o), "cd"),
        "B": first_iteration(lambda o: ims.ipm_ms_solve(msb, o), "box"),
        "C4437": first_iteration(lambda o: ipm.ipm_solve(qb, o), "cd"),
        f"C{qc2.topo.Nn}": first_iteration(lambda o: ipm.ipm_solve(qc2, o), "cd")}
    ipm_checks, ric_library = {}, {}

    def ipm_check(name, path, fn, ref_fn, rtol, shapes, inputs, ops):
        ref, got = ref_fn(), fn()
        torch.cuda.synchronize()
        if isinstance(ref, tuple) and isinstance(ref[0], dict):
            got = [got[0][k] for k in ("P", "Luu", "K", "Mxu")] + list(got[1:])
            ref = [ref[0][k] for k in ("P", "Luu", "K", "Mxu")] + list(ref[1:])
        elif isinstance(ref, dict):
            got, ref = ([d[k] for k in ("P", "Luu", "K", "Mxu")] for d in (got, ref))
        err = compare(torch, f"{name} (path {path})", got, ref, rtol)
        ipm_checks.setdefault(name, {})[path] = (err, fn, ref_fn, shapes, inputs, ops)

    for path, got in ops_at.items():
        if "ric_chain_factor" in got:
            (hbar, AB), kw = got["ric_chain_factor"]
            S_, L_, nx_, nz_ = AB.shape
            ipm_check("ric_chain_factor", path,
                      lambda hbar=hbar, AB=AB, kw=kw: rk.ric_chain_factor(hbar, AB, **kw),
                      lambda hbar=hbar, AB=AB, kw=kw: rk.ric_chain_factor_ref(hbar, AB, **kw),
                      FACTOR_RTOL, f"hbar {tuple(hbar.shape)}", (hbar, AB),
                      S_ * L_ * stage_ops(nx_, nz_, "factor"))
            (fact, rg, rb), _ = got["ric_chain_bwd"]
            rg, rb = rg.to(f32).contiguous(), rb.to(f32).contiguous()
            ipm_check("ric_chain_bwd", path,
                      lambda fact=fact, rg=rg, rb=rb: rk.ric_chain_bwd(fact, rg, rb),
                      lambda fact=fact, rg=rg, rb=rb: rk.ric_chain_bwd_ref(fact, rg, rb),
                      SOLVE_RTOL, f"rg {tuple(rg.shape)}",
                      ([fact[k] for k in ("P", "Luu", "Mxu", "AB")], rg, rb),
                      S_ * L_ * stage_ops(nx_, nz_, "bwd"))
            (fact, p, k, rb, zr), _ = got["ric_chain_fwd"]
            rb, zr = rb.to(f32).contiguous(), zr.to(f32).contiguous()
            ipm_check("ric_chain_fwd", path,
                      lambda a=(fact, p, k, rb, zr): rk.ric_chain_fwd(*a),
                      lambda a=(fact, p, k, rb, zr): rk.ric_chain_fwd_ref(*a),
                      SOLVE_RTOL, f"rb {tuple(rb.shape)}",
                      ([fact[k] for k in ("P", "K", "AB")], p, k, rb, zr),
                      S_ * L_ * stage_ops(nx_, nz_, "fwd"))
        if "crown_ric_factor" in got:
            (hbar, AB, W0, prep_c, nx_), kw = got["crown_ric_factor"]
            Nc_c, nz_ = hbar.shape
            sched_c = crk._get_sched(prep_c)
            ipm_check("crown_ric_factor", path,
                      lambda a=(hbar, AB, W0, prep_c, nx_), kw=kw: crk.crown_ric_factor(*a, **kw),
                      lambda a=(hbar, AB, W0, prep_c, nx_), kw=kw:
                      crk.crown_ric_factor_ref(*a, **kw),
                      FACTOR_RTOL, f"hbar {tuple(hbar.shape)}, {sched_c.n_lev} levels, "
                      f"{sched_c.n_ph} phases of runs",
                      (hbar, AB, W0, [sched_c.on(dev)[k] for k in (
                          "kid_ptr", "kid_idx", "ph_ptr", "run_ptr", "run_node")]),
                      Nc_c * (stage_ops(nx_, nz_, "factor") + nz_ * nz_))
            (fact, rg, rb, w0, prep_c), _ = got["crown_ric_solve"]
            rg, rb, w0 = (v.to(f32).contiguous() for v in (rg, rb, w0))
            if path == "B":
                # the library calls: ldl_factor_ex of the crown's KKT matrix
                # (ric_crown_matrix) and ldl_solve with its factors
                M_r = ric_crown_matrix(torch, hbar, AB, W0, prep_c, nx_, kw.get("reg", 0.0))
                LD_r, piv_r, info_r = torch.linalg.ldl_factor_ex(M_r)
                v_r = ric_crown_vector(torch, rg, rb, w0)
                lib_r = torch.linalg.ldl_solve(LD_r, piv_r, v_r)
                ref_r = crk.crown_ric_solve_ref(crk.crown_ric_factor_ref(hbar, AB, W0, prep_c,
                                                                         nx_, **kw),
                                                rg, rb, w0, prep_c)
                err_r = max(float((a - b_).abs().max()) for a, b_ in zip(
                    ric_crown_vector(torch, rg, rb, w0, x=lib_r), ref_r))
                ric_library = {
                    "crown_ric_factor": (lambda: torch.linalg.ldl_factor_ex(M_r),
                                         f"ldl_factor_ex of the [{M_r.shape[0]}]^2 KKT matrix, "
                                         f"info {int(info_r)}"),
                    "crown_ric_solve": (lambda: torch.linalg.ldl_solve(LD_r, piv_r, v_r),
                                        f"ldl_solve with its factors, |diff| to the twin "
                                        f"{err_r:.3e}")}
            ipm_check("crown_ric_solve", path,
                      lambda a=(fact, rg, rb, w0, prep_c): crk.crown_ric_solve(*a),
                      lambda a=(fact, rg, rb, w0, prep_c): crk.crown_ric_solve_ref(*a),
                      SOLVE_RTOL, f"rg {tuple(rg.shape)}",
                      ([fact[k] for k in ("P", "Luu", "K", "Mxu", "AB")], rg, rb, w0,
                       [sched_c.on(dev)[k] for k in ("kid_ptr", "kid_idx", "par", "ph_ptr",
                                                     "run_ptr", "run_node")]),
                      Nc_c * (stage_ops(nx_, nz_, "bwd") + stage_ops(nx_, nz_, "fwd") + nz_)
                      + chol_ops(nx_) + 4 * nx_ * nx_)
    # ric_chain_factor at its kernel's edges (RIC_EDGES), both hbar forms
    ric_edge_err = 0.0
    for k, (S_e, L_e, nx_e, nz_e) in enumerate(RIC_EDGES):
        for dense in (False, True):
            hbar_e, AB_e = ric_operands(torch, S_e, L_e, nx_e, nz_e, dense, k, dev)
            got_f, got_w = rk.ric_chain_factor(hbar_e, AB_e, reg=RIC_REG)
            ref_f, ref_w = rk.ric_chain_factor_ref(hbar_e, AB_e, reg=RIC_REG)
            torch.cuda.synchronize()
            pick = lambda f, w: [f[q] for q in ("P", "Luu", "K", "Mxu")] + [w]
            ric_edge_err = max(ric_edge_err, compare(
                torch, f"ric_chain_factor at S={S_e}, L={L_e}, nx={nx_e}, nz={nz_e}, "
                f"{'dense' if dense else 'diagonal'} hbar", pick(got_f, got_w),
                pick(ref_f, ref_w), FACTOR_RTOL))
    print(f"ric_chain_factor at its kernel's edges {RIC_EDGES} (S, L, nx, nz; diagonal and "
          f"dense hbar): max |diff| to the twin {ric_edge_err:.3e}")
    # ric_chain_bwd, and ric_chain_fwd on its outputs, at the same edges on
    # the twin's factors and seeded right-hand sides (ric_rhs)
    ric_sweep_err = {"ric_chain_bwd": 0.0, "ric_chain_fwd": 0.0}
    for k, (S_e, L_e, nx_e, nz_e) in enumerate(RIC_EDGES):
        for dense in (False, True):
            hbar_e, AB_e = ric_operands(torch, S_e, L_e, nx_e, nz_e, dense, k, dev)
            rg_e, rb_e, zr_e = ric_rhs(torch, S_e, L_e, nx_e, nz_e, 50 + k, dev)
            fact_e, _ = rk.ric_chain_factor_ref(hbar_e, AB_e, reg=RIC_REG)
            bwd_e = rk.ric_chain_bwd_ref(fact_e, rg_e, rb_e)
            what = (f"at S={S_e}, L={L_e}, nx={nx_e}, nz={nz_e}, "
                    f"{'dense' if dense else 'diagonal'} hbar")
            got_b = rk.ric_chain_bwd(fact_e, rg_e, rb_e)
            got_f = rk.ric_chain_fwd(fact_e, got_b[0], got_b[1], rb_e, zr_e)
            torch.cuda.synchronize()
            for name, got_, ref_ in (
                    ("ric_chain_bwd", got_b, bwd_e),
                    ("ric_chain_fwd", got_f, rk.ric_chain_fwd_ref(fact_e, *bwd_e[:2], rb_e,
                                                                  zr_e))):
                ric_sweep_err[name] = max(ric_sweep_err[name], compare(
                    torch, f"{name} {what}", got_, ref_, SOLVE_RTOL))
    print(f"ric_chain_bwd, ric_chain_fwd at {RIC_EDGES} (both hbar forms): max |diff| to the "
          f"twins {ric_sweep_err['ric_chain_bwd']:.3e}, {ric_sweep_err['ric_chain_fwd']:.3e}")
    # crown_ric_factor, and crown_ric_solve on the twin's factors, at their
    # kernels' edges (CROWN_RIC_EDGES) on seeded whole trees
    crown_edge_err = {"crown_ric_factor": 0.0, "crown_ric_solve": 0.0}
    for k, (md_e, Nr_e, Nh_e, nx_e, nu_e, reg_e) in enumerate(CROWN_RIC_EDGES):
        hb_e, AB_e, W0_e, rg_e, rb_e, w0_e, prep_e = ric_crown_operands(
            torch, md_e, Nr_e, Nh_e, nx_e, nu_e, 60 + k, dev)
        ref_f = crk.crown_ric_factor_ref(hb_e, AB_e, W0_e, prep_e, nx_e, reg_e)
        got_f = crk.crown_ric_factor(hb_e, AB_e, W0_e, prep_e, nx_e, reg_e)
        got_s = crk.crown_ric_solve(ref_f, rg_e, rb_e, w0_e, prep_e)
        torch.cuda.synchronize()
        what = (f"at md={md_e}, Nr={Nr_e}, Nh={Nh_e}, nx={nx_e}, nu={nu_e}, reg={reg_e} "
                f"({prep_e.topo.Nn} nodes, launch "
                f"{crk._ric_launch(crk._get_sched(prep_e), nx_e + nu_e)})")
        pick = lambda f: [f[q] for q in ("P", "Luu", "K", "Mxu")]
        for name, got_, ref_, rtol in (
                ("crown_ric_factor", pick(got_f), pick(ref_f), FACTOR_RTOL),
                ("crown_ric_solve", got_s, crk.crown_ric_solve_ref(ref_f, rg_e, rb_e, w0_e,
                                                                   prep_e), SOLVE_RTOL)):
            crown_edge_err[name] = max(crown_edge_err[name], compare(
                torch, f"{name} {what}", got_, ref_, rtol))
    print(f"crown_ric_factor, crown_ric_solve at their kernels' edges {CROWN_RIC_EDGES} (md, "
          f"Nr, Nh, nx, nu, reg): max |diff| to the twins "
          f"{crown_edge_err['crown_ric_factor']:.3e}, {crown_edge_err['crown_ric_solve']:.3e}")
    # past the kernels' widest stage (nz = 33) both wrappers raise before
    # any launch, naming the bound, and fall back to no twin
    hb_33, AB_33 = ric_operands(torch, 2, 2, 32, 33, False, 0, dev)
    crown_33 = ric_crown_operands(torch, 2, 1, 2, 32, 1, 0, dev)
    before_33 = (rk.ric_chain_factor.launches, crk.crown_ric_factor.launches)
    for name, fn in (("ric_chain_factor", lambda: rk.ric_chain_factor(hb_33, AB_33)),
                     ("crown_ric_factor", lambda: crk.crown_ric_factor(
                         *crown_33[:3], crown_33[6], 32))):
        try:
            fn()
            fail(f"{name} took nz = 33, past its kernel's 32")
        except ValueError as e:
            if "nz <= 32" not in str(e):
                fail(f"{name} at nz = 33 raised without naming the bound: {e}")
    if (rk.ric_chain_factor.launches, crk.crown_ric_factor.launches) != before_33:
        fail("a Riccati wrapper launched its kernel at nz = 33")
    print("ric_chain_factor, crown_ric_factor at nz = 33: refused before any launch, naming "
          "nz <= 32")
    # the library calls of rows 22-24 at path A: ldl_factor_ex of each
    # chain's KKT matrix (ric_chain_matrix) for ric_chain_factor, and
    # ldl_solve with its factors for ric_chain_bwd and ric_chain_fwd
    # together (one solve computes what the two sweeps compute)
    (hbar, AB), kw = ops_at["A"]["ric_chain_factor"]
    (_, rg_a, rb_a), _ = ops_at["A"]["ric_chain_bwd"]
    lib_fac, lib_sol, info_c, err_c = ric_chain_ldl(
        torch, hbar, AB, kw.get("reg", 0.0), rg_a.to(f32).contiguous(),
        rb_a.to(f32).contiguous(), ops_at["A"]["ric_chain_fwd"][0][4].to(f32).contiguous())
    # (alone only: cuSOLVER's sytrf fails under CUDA graph capture)
    ric_chain_lib = {"factor": cuda_ms(torch, lib_fac, 10), "solve": cuda_ms(torch, lib_sol, 10)}
    print(f"rows 22-24's library calls (path A, {AB.shape[0]} chains' "
          f"[{AB.shape[1] * (AB.shape[2] + AB.shape[3])}]^2 KKT matrices): ldl_factor_ex "
          f"{ric_chain_lib['factor']:.4f} ms alone (info max {info_c}); ldl_solve (for bwd + "
          f"fwd) {ric_chain_lib['solve']:.4f} ms alone, |diff| to "
          f"ric_chain_fwd_ref(ric_chain_bwd_ref) {err_c:.3e} on {card}")
    del lib_fac, lib_sol
    # timed at path A (the chain kernels: the dense headline) and path B
    # (the crown kernels: the 341-node crown with the chains' terms); the
    # other paths' differences and times go into the shapes note
    for name, timed in (("ric_chain_factor", "A"), ("ric_chain_bwd", "A"),
                        ("ric_chain_fwd", "A"), ("crown_ric_factor", "B"),
                        ("crown_ric_solve", "B")):
        runs = ipm_checks[name]
        err, fn, ref_fn, shapes, inputs, ops = runs[timed]
        others = ", ".join(
            f"path {p} {r[3]}: |diff| {r[0]:.3e}, {cuda_ms(torch, r[1], 20):.4f} ms alone, "
            f"{graph_ms(torch, r[1]):.4f} ms in a CUDA graph" for p, r in runs.items()
            if p != timed)
        source = "ric_chain.cu" if name.startswith("ric") else "crown_ric.cu"
        replaces = {"ric_chain_factor": "riccati_kernels.py:84",
                    "ric_chain_bwd": "riccati_kernels.py:150",
                    "ric_chain_fwd": "riccati_kernels.py:193",
                    "crown_ric_factor": "crown_riccati.py:98",
                    "crown_ric_solve": "crown_riccati.py:170"}[name]
        m = None
        note = ""
        if name.startswith("ric_chain"):
            lib_t = ric_chain_lib["factor" if name == "ric_chain_factor" else "solve"]
            m = measure(fn, ref_fn, inputs, ops)
            m.update(graph_ms=graph_ms(torch, fn), library_ms=lib_t)
            note = (f"; {m['graph_ms']:.4f} ms in a CUDA graph; library call "
                    + ("ldl_factor_ex of the chains' KKT matrices" if name == "ric_chain_factor"
                       else "ldl_solve with its factors, for bwd + fwd")
                    + f" {lib_t:.4f} ms alone")
            if name != "ric_chain_factor":
                note += (f"; edges {RIC_EDGES} max |diff| {ric_sweep_err[name]:.3e}")
                err = max(err, ric_sweep_err[name])
            print(f"{name} (path {timed} {shapes}): {m['ms']:.4f} ms alone, "
                  f"{m['graph_ms']:.4f} ms in a CUDA graph on {card}")
        if name in ric_library:
            lib_fn, lib_note = ric_library[name]
            m = measure(fn, ref_fn, inputs, ops, lib_fn=lib_fn)
            m.update(graph_ms=graph_ms(torch, fn))
            note = (f"; {m['graph_ms']:.4f} ms in a CUDA graph; library call "
                    f"{m['library_ms']:.4f} ms ({lib_note}); edges {CROWN_RIC_EDGES} max |diff| "
                    f"{crown_edge_err[name]:.3e}")
            err = max(err, crown_edge_err[name])
            print(f"{name} (path {timed} {shapes}): {m['ms']:.4f} ms alone, {m['graph_ms']:.4f} "
                  f"ms in a CUDA graph; library call {m['library_ms']:.4f} ms ({lib_note}); "
                  f"{others} on {card}")
        if name == "ric_chain_factor":
            note += f"; edges {RIC_EDGES} max |diff| {ric_edge_err:.3e}"
            err = max(err, ric_edge_err)
        edge = {"ric_chain_factor": ric_edge_err, **ric_sweep_err, **crown_edge_err}.get(name)
        record(name, source, f"treeqp_tpu/ops/{replaces}",
               max([r[0] for r in runs.values()] + ([] if edge is None else [edge])),
               fn, ref_fn, f"path {timed} {shapes}, |diff| {err:.3e}; {others}{note}", inputs,
               ops, m=m)
    rb_, rf_ = (next(r for r in results if r["name"] == n)
                for n in ("ric_chain_bwd", "ric_chain_fwd"))
    print(f"ldl_solve (rows 23-24's library call) {ric_chain_lib['solve']:.4f} ms alone; "
          f"ric_chain_bwd + ric_chain_fwd {rb_['ms'] + rf_['ms']:.4f} ms alone, "
          f"{rb_['graph_ms'] + rf_['graph_ms']:.4f} ms in a CUDA graph on {card}")
    for r in results[-5:]:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library call {lib}, "
              f"max |diff| {r['max_abs_err']:.3e} [{r['shapes']}] on {card}")

    ipm_launches = lambda: sum(k.launches for k in ipm_kernels)

    def i_certified(q, ms_q, o, ws, what):
        """One IPM request, certified: status 0, max(res4) < tol, the port's
        KKT < 1e-8, finite output of the right shape. Returns (out, the
        (crown, chain) pair or None, kkt, ms, IPM kernel launches)."""
        n0 = ipm_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if ms_q is None:
            out, pair = ipm.ipm_solve(q, o, ws=ws), None
        else:
            pair = ims.ipm_ms_solve(ms_q, o, ws=ws)
            out = tm.merge_output(ms_q, *pair)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        kkt = max_kkt_residual(q, out)
        info = out.info
        if info["status"] != ipm.IPM_OPTIMAL or not float(info["res4"].max()) < o.tol \
                or not kkt < TOL:
            fail(f"{what}: status {info['status']} res4 {info['res4'].tolist()} kkt {kkt}")
        if tuple(out.x.shape) != (q.topo.Nn, q.topo.nxm) or not all(
                bool(torch.isfinite(v).all()) for v in (out.x, out.u, out.lam, out.mu_d)):
            fail(f"{what}: output of the wrong shape or not finite")
        n = ipm_launches() - n0
        print(f"{what} ({q.topo.Nn} nodes): iter {info['iter']} ({info['iter_f32']} f32 + "
              f"{info['iter'] - info['iter_f32']} f64), max res4 "
              f"{float(info['res4'].max()):.3e}, kkt {kkt:.3e}, max |mu_d| "
              f"{float(out.mu_d.abs().max()):.3e}, {n} Riccati kernel launches, "
              f"{t_ms:.1f} ms on {card}")
        return out, pair, kkt, t_ms, n

    def shifted(q, ms_q, db):
        """The next MPC request: b + db on every edge, in both layouts."""
        bump = lambda x: x.replace(b=x.b + db)
        return bump(q), dataclasses.replace(ms_q, b=ms_q.b + db, crown=bump(ms_q.crown))

    def ms_path(tag, q, ms_q, o):
        first = i_certified(q, ms_q, o, None, f"IPM {tag} cold solve (first)")
        again = i_certified(q, ms_q, o, None, f"IPM {tag} cold solve (again)")
        prev, rows = first[1][:2], []
        for k in range(N_REQUESTS_CD):
            q_k, ms_k = shifted(q, ms_q, CD_DB * (k + 1))
            r = i_certified(q_k, ms_k, o, prev, f"IPM {tag} warm request {k} "
                            f"(b + {CD_DB * (k + 1):g})")
            rows.append(r)
            prev = r[1][:2]
        print(f"requests IPM {tag} warm: iters {[r[0].info['iter'] for r in rows]}, "
              f"{statistics.mean(r[3] for r in rows):.1f} ms/request (cold "
              f"{again[3]:.1f} ms), max kkt {max(r[2] for r in rows):.3e} on {card}")
        return first[0]

    tdunes_names = ms_names + generic_names + admm_name
    out_a = drive("IPM general C/D (A)", ipm_names[:3],
                  lambda: ms_path("A general C/D", qa, msa, opts_ipm["cd"]),
                  forbid=tdunes_names + ipm_names[3:], ipm_path=True)
    drive("IPM box-only multistage (B)", ipm_names,
          lambda: ms_path("B box-only", qb, msb, opts_ipm["box"]),
          forbid=tdunes_names, ipm_path=True)

    def generic_path():
        for q in (qb, qc2):
            for k in range(2):
                i_certified(q, None, opts_ipm["cd"], None,
                            f"IPM C generic tree cold solve ({'first' if k == 0 else 'again'})")
    drive("IPM generic tree (C)", ipm_names[3:], generic_path,
          forbid=tdunes_names + ipm_names[:3], ipm_path=True)

    # path A's cold solve through the plain twins on the CPU, at full depth:
    # iterations within one; x and u within 1e-7 at the same iteration
    # count. (On this tree one iteration past tol still moves x by ~6e-6
    # and u by ~8e-5, in JAX's solve too: tests/test_torch_ipm_ms.py::
    # test_general_cd_headline_ends_one_step_apart. So when the counts
    # differ by one, the longer solve is rerun stopped at the shorter one's
    # count and the two are compared there.)
    def solve_a(ms_q, **kw):
        pair = ims.ipm_ms_solve(ms_q, dataclasses.replace(opts_ipm["cd"], **kw))
        return tm.merge_output(ms_q, *pair)

    t0 = time.perf_counter()
    out_ac = solve_a(msa_cpu)
    t_cpu = time.perf_counter() - t0
    ia, ic = out_a.info, out_ac.info
    gap = lambda a, b: {f: float((getattr(a, f).cpu() - getattr(b, f)).abs().max())
                        for f in ("x", "u", "lam", "mu_d")}
    gaps = gap(out_a, out_ac)
    print(f"IPM A cold solve, card vs CPU plain path ({t_cpu:.1f} s on the CPU): iter "
          f"{ia['iter']} vs {ic['iter']} (f32 {ia['iter_f32']} vs {ic['iter_f32']}), "
          + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    n_eq = min(ia["iter"], ic["iter"])
    if ia["iter"] != ic["iter"]:
        card_n = out_a if ia["iter"] == n_eq else solve_a(msa, max_iter=n_eq)
        cpu_n = out_ac if ic["iter"] == n_eq else solve_a(msa_cpu, max_iter=n_eq)
        gaps = gap(card_n, cpu_n)
        print(f"IPM A, card vs CPU plain path, both stopped at {n_eq} iterations: "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    if abs(ia["iter"] - ic["iter"]) > 1 or gaps["x"] > 1e-7 or gaps["u"] > 1e-7:
        fail(f"IPM path A: card and CPU solves disagree at {n_eq} iterations: {gaps}")

    # ---- 8. sdunes (slice 7): sdunes_bench's three modes on its tree, the
    # box-only spring_mass_chain(4,4,4,20) of path B
    opts_sd = sd.SdunesOpts(**SDUNES_OPTS)
    opts_sd_df = dataclasses.replace(opts_sd, df64_phase=True)
    opts_boot = td.TdunesOpts(**SDUNES_BOOT_OPTS)
    opts_sd_f32 = dataclasses.replace(opts_sd, tol=SD_F32_TOL, max_iter=80, f32_phase_tol=0.0)
    opts_ms_f32 = dataclasses.replace(opts_boot, tol=SD_F32_TOL, max_iter=80, f32_phase_tol=0.0,
                                      df64_phase=False, refine_steps=0)
    sqp = sd.scenario_data(qb)
    sm = sqp.meta
    nl = sm.Nr * sm.nu
    print(f"sdunes instance: spring_mass_chain(4,4,4,20): {sm.Ns} scenarios, Nh={sm.Nh}, "
          f"nx={sm.nx} nu={sm.nu}, {sum(sm.common) * sm.nu} coupling multipliers, Jay "
          f"P={sm.Ns - 1} b={nl}")
    sd_three = ("chain_factor",) + sd_names
    sd_forbid = ms_names + tuple(n for n in generic_names if n != "chain_factor") + admm_name

    def sd_counts():
        return {k.__name__: k.launches for k in kernels if k.__name__ in sd_three}

    def sd_launch_rule(info, o, what, got):
        """Each Newton step factors once; the coarse phase solves once, the
        final phase 1 + its refinement steps times, through both kernels."""
        r = max(o.refine_steps, 1) if o.df64_phase else o.refine_steps
        c, n = info["iter_f32"], info["iter"]
        want = dict(chain_factor=n, chain_full_solve_mat=c + (n - c) * (1 + r))
        want["jay_cr_solve"] = want["chain_full_solve_mat"]
        if got != want:
            fail(f"{what}: launches {got}, expected {want} ({c} coarse + {n - c} final "
                 f"iterations)")
        return got

    def sd_solve(sq, lam0, mu0, o, q_tree, what, certify=True):
        """One sdunes request: (TreeQPOut, info, kkt, ms), its kernel launches
        held to the rule above. Certified unless ``certify`` is False: status
        0, error < 1e-8, port-oracle KKT < 1e-8 through scenario_output;
        finite iterates of the right shape always."""
        n0 = sd_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol, lam, mu, info = sd.sdunes_solve(sq, lam0, mu0, o)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        n1 = sd_counts()
        info["launches"] = sd_launch_rule(info, o, what, {k: n1[k] - n0[k] for k in n1})
        if tuple(sol["x"].shape) != (sm.Ns, sm.Nh + 1, sm.nx) or not all(
                bool(torch.isfinite(v).all()) for v in (sol["x"], sol["u"], lam, mu)):
            fail(f"{what}: iterates of the wrong shape or not finite")
        out, kkt = None, float("nan")
        if certify:
            out = sd.scenario_output(sq, sol, lam, mu, info)
            kkt = max_kkt_residual(q_tree, out)
            if info["status"] != td.TDUNES_OPTIMAL or not info["error"] < TOL \
                    or not kkt < TOL:
                fail(f"{what}: status {info['status']} error {info['error']} kkt {kkt}")
        return out, info, kkt, t_ms

    def sd_instance(fac):
        """sdunes_bench's request: stage 0's state bounds scaled by ``fac``
        in the scenario data, the crown and the tree (the KKT oracle's)."""
        q_k, ms_k = perturbed(qb, msb, fac)
        return sqp.replace(xmin=q_k.xmin[paths_t], xmax=q_k.xmax[paths_t]), q_k, ms_k

    paths_t = torch.as_tensor(sm.paths, device=dev)

    # the kernels against their twins on the operands of the first
    # final-phase iteration of the cold headline solve
    calls, (_, _, _, info_c0) = capture(((ck, sd_three[:2]), (jk, sd_names[1:])),
                                        lambda: sd.sdunes_solve(sqp, None, None, opts_sd))
    c0 = info_c0["iter_f32"]
    if info_c0["iter"] <= c0:
        fail(f"cold sdunes solve ran no final iteration: {info_c0}")
    (Wc, Ut), _ = calls["chain_factor"][c0]
    err_cf = compare(torch, "chain_factor (sdunes)", ck.chain_factor(Wc, Ut),
                     ck.chain_factor_ref(Wc, Ut), FACTOR_RTOL)
    factor_times("sdunes", Wc, Ut)
    (Ls5, CUs5, r5), _ = calls["chain_full_solve_mat"][c0]
    (_, _, r1), _ = calls["chain_full_solve_mat"][c0 + 1]
    if r5.shape[-1] != 1 + nl or r1.shape[-1] != 1:
        fail(f"chain_full_solve_mat: right-hand sides {r5.shape[-1]} and {r1.shape[-1]}")
    errs_fs = {m: compare(torch, f"chain_full_solve_mat (m={m})",
                          [ck.chain_full_solve_mat(Ls5, CUs5, r)],
                          [ck.chain_full_solve_mat_ref(Ls5, CUs5, r)], SOLVE_RTOL)
               for m, r in ((1 + nl, r5), (1, r1))}
    S_s, L_s, n_s, _ = Ls5.shape
    # the library call: torch.cholesky_solve with each chain's factor as one
    # lower [L n, L n] matrix, the right-hand sides in its block order
    F5 = chain_factor_matrix(torch, Ls5, CUs5)
    B5 = torch.flip(r5, (1,)).reshape(S_s, L_s * n_s, -1).contiguous()
    lib_z = torch.flip(torch.cholesky_solve(B5, F5).reshape(r5.shape), (1,))
    err_lib = float((lib_z - ck.chain_full_solve_mat(Ls5, CUs5, r5)).abs().max())
    # the kernel's edges (FULL_EDGES) on seeded factors
    err_fe = 0.0
    for k, (S_e, L_e, n_e, m_e) in enumerate(FULL_EDGES):
        Ls_e, CUs_e, r_e = full_operands(torch, S_e, L_e, n_e, m_e, 60 + k, dev)
        err_fe = max(err_fe, compare(
            torch, f"chain_full_solve_mat at S={S_e}, L={L_e}, n={n_e}, m={m_e}",
            [ck.chain_full_solve_mat(Ls_e, CUs_e, r_e)],
            [ck.chain_full_solve_mat_ref(Ls_e, CUs_e, r_e)], SOLVE_RTOL))
    print(f"chain_full_solve_mat at its kernel's edges ({len(FULL_EDGES)} shapes (S, L, n, m): "
          f"n 1, 8, 9, 16; L 1, 2, 20, 40; m 1, 5, 17; S = 5): max |diff| to the twin "
          f"{err_fe:.3e}")
    full1 = lambda: ck.chain_full_solve_mat(Ls5, CUs5, r1)
    fs_lib = lambda: torch.cholesky_solve(B5, F5)
    m_fs = measure(lambda: ck.chain_full_solve_mat(Ls5, CUs5, r5),
                   lambda: ck.chain_full_solve_mat_ref(Ls5, CUs5, r5), (Ls5, CUs5, r5),
                   S_s * (1 + nl) * L_s * 6 * n_s * n_s, lib_fn=fs_lib)
    # (batched cholesky_solve runs MAGMA, which aborts under graph capture)
    m_fs.update(graph_ms=graph_ms(torch, lambda: ck.chain_full_solve_mat(Ls5, CUs5, r5)))
    ms1, g1 = cuda_ms(torch, full1, 20), graph_ms(torch, full1)
    print(f"chain_full_solve_mat (Ls {tuple(Ls5.shape)}): m={1 + nl} {m_fs['ms']:.4f} ms alone, "
          f"{m_fs['graph_ms']:.4f} ms in a CUDA graph; m=1 {ms1:.4f} ms alone, {g1:.4f} ms in a "
          f"CUDA graph; library call cholesky_solve (m={1 + nl}) {m_fs['library_ms']:.4f} ms "
          f"alone on {card}")
    record("chain_full_solve_mat", "chain_full_solve.cu", "treeqp_tpu/ops/chain_kernels.py:261",
           max(*errs_fs.values(), err_fe), None, None,
           f"Ls {tuple(Ls5.shape)}, m={1 + nl} (the iteration's first solve; after {c0} coarse "
           f"iterations), {m_fs['graph_ms']:.4f} ms in a CUDA graph; m=1 {ms1:.4f} ms alone, "
           f"{g1:.4f} ms in a CUDA graph, |diff| {errs_fs[1]:.3e}; edges FULL_EDGES max |diff| "
           f"{err_fe:.3e}; chain_factor there |diff| {err_cf:.3e}; library "
           f"call cholesky_solve of the [L n, L n] factor, |diff| to the kernel {err_lib:.3e}",
           (Ls5, CUs5, r5), S_s * (1 + nl) * L_s * 6 * n_s * n_s, m=m_fs)
    # the Jay system: held to its twin at the cold start (the first coarse
    # iteration); at the first final-phase iteration it is near singular
    # (clipped couplings; only the 1e-6 shift holds it), where an f32
    # solve's forward error is set by the conditioning and not by the
    # kernel, so there both f32 solves are held to a backward error below
    # JAY_BACKWARD against the system in f64, with their distances to the
    # f64 solve printed
    (dg0, of0, rj0), kw0 = calls["jay_cr_solve"][0]
    err_j = compare(torch, "jay_cr_solve (cold start)", [jk.jay_cr_solve(dg0, of0, rj0, **kw0)],
                    [jk.jay_cr_solve_ref(dg0, of0, rj0, **kw0)], SOLVE_RTOL)
    (dg, of, rj), kw = calls["jay_cr_solve"][c0]

    def jay_dense(dg_, of_, sh_):
        """The shifted block-tridiagonal system as one dense f64 matrix."""
        P_, b_ = dg_.shape[0], dg_.shape[-1]
        M = torch.block_diag(*dg_.double()) + torch.diag(sh_.double().reshape(-1))
        for i in range(P_ - 1):
            M[(i + 1) * b_:(i + 2) * b_, i * b_:(i + 1) * b_] = of_[i].double()
            M[i * b_:(i + 1) * b_, (i + 1) * b_:(i + 2) * b_] = of_[i].double().T
        return M
    M_j, r_j = jay_dense(dg, of, kw["shift"]), rj.double().reshape(-1)
    x_j64 = torch.linalg.solve(M_j, r_j)
    ev_j = torch.linalg.eigvalsh(M_j)
    jay_fe = {}
    for tag, x_ in (("kernel", jk.jay_cr_solve(dg, of, rj, **kw)),
                    ("twin", jk.jay_cr_solve_ref(dg, of, rj, **kw))):
        x_ = x_.double().reshape(-1)
        eta = float((M_j @ x_ - r_j).abs().max()
                    / (M_j.abs().sum(1).max() * x_.abs().max() + r_j.abs().max()))
        jay_fe[tag] = f"{float((x_ - x_j64).abs().max()):.3e} (backward error {eta:.3e})"
        if not torch.isfinite(x_).all() or not eta <= JAY_BACKWARD:
            fail(f"jay_cr_solve ({tag}) at the first final-phase iteration: backward error "
                 f"{eta:.3e} > {JAY_BACKWARD:g}")
    print(f"jay_cr_solve at the first final-phase iteration: condition {float(ev_j[-1] / ev_j[0]):.3e}"
          f" (f64 eigenvalues of the equilibrated, shifted system), max|x| "
          f"{float(x_j64.abs().max()):.3e}; distance to the f64 solve: kernel "
          f"{jay_fe['kernel']}, twin {jay_fe['twin']}")
    # beyond the TPU kernel's caps: a seeded SPD system at P = 1023, b = 16
    # with one exactly singular block (its pivot turns the shift on)
    P_b, b_b = JAY_BIG
    jb = jay_operands(torch, P_b, b_b, JAY_SEED, dev, singular=True)
    x_b, x_bref = jk.jay_cr_solve(*jb, 1e-6), jk.jay_cr_solve_ref(*jb, 1e-6)
    err_jb = compare(torch, f"jay_cr_solve (P={P_b}, b={b_b})", [x_b], [x_bref], SOLVE_RTOL)
    if not float(x_b[P_b // 2 | 1].abs().max()) > 0.0:
        fail("jay_cr_solve: the singular block's shift did not act")
    # the kernel's edges (JAY_PS x JAY_BS, each shift mode, with and without
    # the singular block; operands in shared memory or global scratch)
    jay_edge_err, n_edges = 0.0, 0
    for P_e in JAY_PS:
        for b_e in JAY_BS:
            for sing in (False, True):
                for tol_e in JAY_MODES:
                    if sing and (tol_e is None or P_e < 2):
                        continue  # singular without a shift: no solution to hold
                    je = jay_operands(torch, P_e, b_e, P_e * b_e, dev, singular=sing)
                    if tol_e is None:
                        je[3] = None
                    tol_e = -1.0 if tol_e is None else tol_e
                    jay_edge_err = max(jay_edge_err, compare(
                        torch, f"jay_cr_solve (P={P_e}, b={b_e}, reg_tol={tol_e}, singular "
                        f"{sing})", [jk.jay_cr_solve(*je, tol_e)],
                        [jk.jay_cr_solve_ref(*je, tol_e)], SOLVE_RTOL))
                    n_edges += 1
    print(f"jay_cr_solve at {n_edges} edge systems (P in {JAY_PS}, b in {JAY_BS}, three shift "
          f"modes, a singular block): max |diff| to the twin {jay_edge_err:.3e}")
    # the library call: linalg.solve_ex (linalg.solve without its error
    # check's host sync) of the dense f32 Jay matrix, the shift by the
    # kernel's rule, at both shapes
    M_j32 = jay_matrix(torch, dg, of, kw["shift"], kw["reg_tol"])
    r_j32 = rj.reshape(-1, 1)
    lib_j = lambda: torch.linalg.solve_ex(M_j32, r_j32)[0]
    M_b32, r_b32 = jay_matrix(torch, jb[0], jb[1], jb[3], 1e-6), jb[2].reshape(-1, 1)
    lib_jb = lambda: torch.linalg.solve_ex(M_b32, r_b32)[0]
    err_lj0 = compare(torch, "jay_cr_solve's library call at the cold start",
                      [torch.linalg.solve_ex(jay_matrix(torch, dg0, of0, kw0["shift"],
                                                        kw0["reg_tol"]),
                                             rj0.reshape(-1, 1))[0].reshape(rj0.shape)],
                      [jk.jay_cr_solve_ref(dg0, of0, rj0, **kw0)], SOLVE_RTOL)
    err_ljb = compare(torch, f"jay_cr_solve's library call (P={P_b}, b={b_b})",
                      [lib_jb().reshape(P_b, b_b)], [x_bref], SOLVE_RTOL)
    jay_big = dict(ms=cuda_ms(torch, lambda: jk.jay_cr_solve(*jb, 1e-6), 20),
                   graph_ms=graph_ms(torch, lambda: jk.jay_cr_solve(*jb, 1e-6)),
                   library_ms=cuda_ms(torch, lib_jb, 5), library_graph_ms=graph_ms(
                       torch, lib_jb, calls=2, reps=3))
    print(f"jay_cr_solve (P={P_b}, b={b_b}, on the fly, a singular block): kernel "
          f"{jay_big['ms']:.4f} ms alone, {jay_big['graph_ms']:.4f} ms in a CUDA graph; library "
          f"call (linalg.solve_ex of the [{P_b * b_b}]^2 matrix) {jay_big['library_ms']:.4f} ms "
          f"alone, {jay_big['library_graph_ms']:.4f} ms in a CUDA graph (|diff| to the twin "
          f"{err_ljb:.3e}) on {card}")
    del M_b32, lib_jb

    def jay_ops(P, b):
        """Operations of the cyclic reduction: per level each eliminated
        block's factor and 2b + 1 solves, each updated block's three block
        products and two block-vector products; the root; the back
        substitution."""
        ops, h = 0, 1
        while h < P:
            n_odd, n_even = len(range(h, P, 2 * h)), len(range(0, P, 2 * h))
            ops += n_odd * (chol_ops(b) + (2 * b + 1) * 2 * b * b + 4 * b * b)
            ops += n_even * (6 * b ** 3 + 4 * b * b)
            h *= 2
        return ops + chol_ops(b) + 2 * b * b

    record_graph("jay_cr_solve", "jay_cr.cu", "treeqp_tpu/ops/jay_kernel.py:89",
                 max(err_j, err_jb, jay_edge_err),
                 lambda: jk.jay_cr_solve(dg, of, rj, **kw),
                 lambda: jk.jay_cr_solve_ref(dg, of, rj, **kw),
                 f"P={dg.shape[0]} b={dg.shape[-1]}, shift always, |diff| {err_j:.3e} at the "
                 f"cold start; P={P_b} b={b_b} on the fly with a singular block: "
                 f"{jay_big['ms']:.4f} ms alone, {jay_big['graph_ms']:.4f} ms in a CUDA graph, "
                 f"library call {jay_big['library_ms']:.4f} / {jay_big['library_graph_ms']:.4f} "
                 f"ms, |diff| {err_jb:.3e}, bound "
                 f"{max(nbytes(torch, jb, x_b) / PEAK_BYTES, jay_ops(P_b, b_b) / PEAK_FLOPS[False]) * 1e3:.6f} ms; "
                 f"{n_edges} edge systems max |diff| {jay_edge_err:.3e}",
                 (dg, of, rj, kw["shift"]), jay_ops(dg.shape[0], dg.shape[-1]), lib_fn=lib_j,
                 lib_note=f"linalg.solve_ex of the [{rj.numel()}]^2 matrix, |diff| to the twin "
                          f"{err_lj0:.3e} at the cold start")
    for r in results[-2:]:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library call {lib}, "
              f"max |diff| {r['max_abs_err']:.3e} [{r['shapes']}] on {card}")

    def sd_line(what, info, kkt, t_ms, launches, extra=""):
        c = info["iter_f32"]
        print(f"{what}: iter {info['iter']} ({c} coarse + {info['iter'] - c} final), status "
              f"{info['status']}, error {info['error']:.3e}, kkt {kkt:.3e}, launches "
              f"{launches}, {t_ms:.1f} ms{extra} on {card}")

    # the cold headline solve (the card's first sdunes solve ran in the capture)
    def sd_cold():
        out, info, kkt, t_ms = sd_solve(sqp, None, None, opts_sd, qb, "sdunes cold solve")
        sd_line("sdunes cold solve", info, kkt, t_ms, info["launches"],
                f", {t_ms / info['iter']:.2f} ms an iteration")
        return out
    out_sd_cold = drive("sdunes cold", sd_three, sd_cold, forbid=sd_forbid, sd_path=True)

    # sdunes_boot (and _df64): each request bootstraps through
    # tdunes_ms_solve at tol 1e-4, merge_output and the exact scenario duals
    # of the tree solution, then sdunes_solve from them
    def boot_request(mode, k, o):
        sq_k, q_k, ms_k = sd_instance(facs[k])

        def bootstrap():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cro, cho, binfo = tm.tdunes_ms_solve(ms_k, None, None, opts_boot)
            lam0, mu0 = sd.scenario_duals_from_tree(
                sq_k, None, tm.merge_output(ms_k, cro, cho, binfo))
            torch.cuda.synchronize()
            return lam0, mu0, binfo, (time.perf_counter() - t0) * 1e3
        lam0, mu0, binfo, t_b = drive(f"{mode} request {k} bootstrap", ("newton_iter",),
                                      bootstrap)
        if binfo["status"] != td.TDUNES_OPTIMAL or not binfo["error"] < opts_boot.tol:
            fail(f"{mode} request {k}: bootstrap {binfo}")

        def solve():
            _, info, kkt, t_ms = sd_solve(sq_k, lam0, mu0, o, q_k, f"{mode} request {k}")
            sd_line(f"{mode} request {k} (fac {facs[k]:.6f})", info, kkt, t_ms,
                    info["launches"],
                    f"; bootstrap {binfo['iter']} iterations ({binfo['iter_f32']} coarse) "
                    f"{t_b:.1f} ms, request {t_b + t_ms:.1f} ms")
            return info, t_b + t_ms
        return drive(f"{mode} request {k}", (), solve, forbid=sd_forbid, sd_path=True)

    sd_modes = {}
    for mode, o, n in (("sdunes_boot", opts_sd, N_REQUESTS_SD),
                       ("sdunes_boot_df64", opts_sd_df, N_REQUESTS_SD_DF)):
        sd_modes[mode] = [boot_request(mode, k, o) for k in range(n)]

    # sdunes_f32: f32 data, cold, tol 1e-3, no coarse phase (the bench
    # asserts nothing here); beside it tdunes_ms_solve's all-f32 loop
    def f32_requests():
        rows = []
        for k in range(N_REQUESTS_F32):
            sq_k = sd_instance(facs[k])[0].to(dtype=f32)
            _, info, _, t_ms = sd_solve(sq_k, None, None, opts_sd_f32, None,
                                        f"sdunes_f32 request {k}", certify=False)
            sd_line(f"sdunes_f32 request {k}", info, float("nan"), t_ms, info["launches"],
                    f", {t_ms / max(info['iter'], 1):.3f} ms an iteration")
            rows.append((info["iter"], t_ms))
        return rows
    rows_sd32 = drive("sdunes_f32", sd_three, f32_requests, forbid=sd_forbid, sd_path=True)
    ms32b = msb.to(dtype=f32)

    def ms_f32_requests():
        rows = []
        for k in range(N_REQUESTS_F32):
            ms_k = perturbed(qb, ms32b, facs[k])[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cro, _, info = tm.tdunes_ms_solve(ms_k, None, None, opts_ms_f32)
            torch.cuda.synchronize()
            t_ms = (time.perf_counter() - t0) * 1e3
            if not bool(torch.isfinite(cro["lam"]).all()):
                fail(f"tdunes_ms_f32 request {k}: not finite")
            print(f"tdunes_ms_f32 request {k}: iter {info['iter']}, status {info['status']}, "
                  f"error {info['error']:.3e}, {t_ms:.1f} ms, "
                  f"{t_ms / max(info['iter'], 1):.3f} ms an iteration on {card}")
            rows.append((info["iter"], t_ms))
        return rows
    rows_ms32 = drive("tdunes_ms_f32", ("chain_eval", "chain_blocks_factor_lanes", "system_solve"),
                      ms_f32_requests)
    per_it = lambda rows: sum(t for _, t in rows) / max(sum(i for i, _ in rows), 1)
    print(f"f32 loop ms an iteration (sdunes_bench's f32_phase_ms_per_iter): sdunes "
          f"{per_it(rows_sd32):.3f}, tdunes_ms {per_it(rows_ms32):.3f}, ratio "
          f"{per_it(rows_sd32) / per_it(rows_ms32):.2f} on {card}")
    for mode, rows in sd_modes.items():
        print(f"requests {mode}: iters {[i['iter'] for i, _ in rows]}, "
              f"{statistics.mean(t for _, t in rows):.1f} ms a request (bootstrap included) "
              f"on {card}")

    # the card against the CPU plain path: a cold solve at Nr = SD_CPU_NR
    qs_cpu = spring_mass_chain(4, 4, SD_CPU_NR, 20, device="cpu")[0]
    sqs_cpu = sd.scenario_data(qs_cpu)
    sqs = sqs_cpu.to(device=dev)

    def solve_at(sq, q, n=None):
        o = opts_sd if n is None else dataclasses.replace(opts_sd, max_iter=n)
        sol, lam, mu, info = sd.sdunes_solve(sq, None, None, o)
        return sd.scenario_output(sq, sol, lam, mu, info), info
    out_sg, info_sg = solve_at(sqs, qs_cpu)
    t0 = time.perf_counter()
    out_sc, info_sc = solve_at(sqs_cpu, qs_cpu)
    t_cpu = time.perf_counter() - t0
    gaps = gap(out_sg, out_sc)
    print(f"sdunes cold solve at Nr={SD_CPU_NR} ({sqs.meta.Ns} scenarios), card vs CPU plain "
          f"path ({t_cpu:.1f} s on the CPU): iter {info_sg['iter']} vs {info_sc['iter']} "
          f"(coarse {info_sg['iter_f32']} vs {info_sc['iter_f32']}), "
          + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    n_eq = min(info_sg["iter"], info_sc["iter"])
    if info_sg["iter"] != info_sc["iter"]:
        card_n = out_sg if info_sg["iter"] == n_eq else solve_at(sqs, qs_cpu, n_eq)[0]
        cpu_n = out_sc if info_sc["iter"] == n_eq else solve_at(sqs_cpu, qs_cpu, n_eq)[0]
        gaps = gap(card_n, cpu_n)
        print(f"sdunes at Nr={SD_CPU_NR}, card vs CPU plain path, both stopped at {n_eq} "
              f"iterations: " + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()))
    if abs(info_sg["iter"] - info_sc["iter"]) > 1 or gaps["x"] > 1e-7 or gaps["u"] > 1e-7:
        fail(f"sdunes at Nr={SD_CPU_NR}: card and CPU solves disagree at {n_eq} iterations: "
             f"{gaps}")

    t_slice8 = time.perf_counter()

    # ---- 9. the cyclic-reduction chain sweeps (slice 8). No solver calls
    # them: their path is the accept/reject loop of
    # scripts/prof_torch_chain_cr.py, at its three shapes: the JAX script's
    # factors (S=256, L=16, n=8, seed 0), the pruned tree's chain factors of
    # section 5 and sdunes' of section 8 (S=256, L=20, n=8), each with a
    # seeded right-hand side
    rng = np.random.default_rng(0)
    A_r = rng.standard_normal((256, 16, 8, 8))
    Wc_r = torch.tensor(A_r @ A_r.transpose(0, 1, 3, 2) + 3.0 * np.eye(8), dtype=f32, device=dev)
    Ut_r = torch.tensor(0.3 * rng.standard_normal((256, 16, 8, 8)), dtype=f32, device=dev)
    # and a long chain of the widest blocks the kernels take, whose sweep
    # buffers exceed a block's shared memory (the global-scratch path)
    A_l = rng.standard_normal((4, 130, 16, 16))
    Wc_l = torch.tensor(A_l @ A_l.transpose(0, 1, 3, 2) + 3.0 * np.eye(16), dtype=f32, device=dev)
    Ut_l = torch.tensor(0.3 * rng.standard_normal((4, 130, 16, 16)), dtype=f32, device=dev)
    rng = np.random.default_rng(CR_SEED)
    cr_in = {}
    for tag, (Ls_, CUs_) in (("random", ck.chain_factor_ref(Wc_r, Ut_r)[:2]),
                             ("pruned", (Ls_g, CUs_g)), ("sdunes", (Ls5, CUs5)),
                             ("long", ck.chain_factor_ref(Wc_l, Ut_l)[:2])):
        S_, L_, n_ = Ls_.shape[:3]
        cr_in[tag] = (Ls_, CUs_,
                      torch.tensor(rng.standard_normal((S_, L_, n_)), dtype=f32, device=dev),
                      torch.tensor(rng.standard_normal((S_, n_)), dtype=f32, device=dev))

    def cr_ops(L, n, part):
        """Operations of one chain: the precompute's 2 n triangular solves
        a node, or a sweep's L triangular solves, the doubling levels (a
        pair with its partner inside the chain: a matvec, and a product of
        blocks below the last level) and the root term."""
        if part == "pre":
            return L * n * 2 * n * n
        ops, h = L * n * n + 2 * n * n, 1
        while h < L:
            ops += (L - h) * n * (2 * n + (2 * n * n if 2 * h < L else 0))
            h *= 2
        return ops

    cr_rows = {}
    for tag, (Ls_, CUs_, res_, dr_) in cr_in.items():
        S_, L_, n_ = Ls_.shape[:3]
        Ab_ref, Bf_ref = ccr.chain_cr_precompute_ref(Ls_, CUs_)
        ys_ref, radd_ref = ccr.chain_solve_bwd_cr_ref(Ls_, CUs_, Ab_ref, res_)
        d_ref = ccr.chain_forward_cr_ref(Ls_, CUs_, Bf_ref, ys_ref, dr_)
        cr_rows[tag] = dict(
            pre=compare(torch, f"chain_cr_precompute ({tag})",
                        ccr.chain_cr_precompute(Ls_, CUs_), (Ab_ref, Bf_ref), FACTOR_RTOL),
            bwd=compare(torch, f"chain_solve_bwd_cr ({tag})",
                        ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab_ref, res_), (ys_ref, radd_ref),
                        SOLVE_RTOL),
            fwd=compare(torch, f"chain_forward_cr ({tag})",
                        [ccr.chain_forward_cr(Ls_, CUs_, Bf_ref, ys_ref, dr_)], [d_ref],
                        SOLVE_RTOL))
        # the CR pair of kernels against the serial pair on the same factors
        ys_s, radd_s = ck.chain_solve_bwd(Ls_, CUs_, res_)
        Ab, Bf = ccr.chain_cr_precompute(Ls_, CUs_)
        ys_c, radd_c = ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, res_)
        got = [ys_c, radd_c, ccr.chain_forward_cr(Ls_, CUs_, Bf, ys_c, dr_)]
        ref = [ys_s, radd_s, ck.chain_forward(Ls_, CUs_, ys_s, dr_)]
        torch.cuda.synchronize()
        cr_rows[tag]["pair"] = compare(torch, f"CR pair vs serial kernels ({tag})", got, ref,
                                       CR_PAIR_RTOL)
        # the serial sweeps at this shape: kernel, plain twin, bound, library
        # call, and kernel and library call in a CUDA graph
        lb, lf, le = sweep_library(Ls_, CUs_, res_, ys_s, dr_)
        serial = {}
        for name, fn, ref_fn, inputs, lib_fn in (
                ("chain_solve_bwd", lambda: ck.chain_solve_bwd(Ls_, CUs_, res_),
                 lambda: ck.chain_solve_bwd_ref(Ls_, CUs_, res_), (Ls_, CUs_, res_), lb),
                ("chain_forward", lambda: ck.chain_forward(Ls_, CUs_, ys_s, dr_),
                 lambda: ck.chain_forward_ref(Ls_, CUs_, ys_s, dr_), (Ls_, CUs_, ys_s, dr_),
                 lf)):
            m = serial[name] = measure(fn, ref_fn, inputs, S_ * L_ * (3 * n_ * n_ + n_),
                                       lib_fn=lib_fn)
            print(f"sweep {name} ({tag}: S={S_} L={L_} n={n_}): kernel {m['ms']:.4f} ms, "
                  f"plain twin {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms "
                  f"({m['bound_by']}), library call (solve_triangular) {m['library_ms']:.4f} ms "
                  f"(|diff| {le:.3e}); in a CUDA graph kernel {graph_ms(torch, fn):.4f} ms, "
                  f"library call {graph_ms(torch, lib_fn):.4f} ms on {card}")
        cr_rows[tag]["ms"] = {
            "pre": cuda_ms(torch, lambda: ccr.chain_cr_precompute(Ls_, CUs_), 20),
            "pre_graph": graph_ms(torch, lambda: ccr.chain_cr_precompute(Ls_, CUs_)),
            "bwd": cuda_ms(torch, lambda: ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, res_), 20),
            "fwd": cuda_ms(torch, lambda: ccr.chain_forward_cr(Ls_, CUs_, Bf, ys_c, dr_), 20),
            "sbwd": serial["chain_solve_bwd"]["ms"], "sfwd": serial["chain_forward"]["ms"]}
        c = cr_rows[tag]
        print(f"CR sweeps ({tag}: S={S_} L={L_} n={n_}): precompute {c['ms']['pre']:.4f} ms "
              f"({c['ms']['pre_graph']:.4f} in a CUDA graph, launch "
              f"{ccr.precompute_launch(n_)}), bwd {c['ms']['bwd']:.4f}, fwd "
              f"{c['ms']['fwd']:.4f} (serial bwd "
              f"{c['ms']['sbwd']:.4f}, fwd {c['ms']['sfwd']:.4f}, pair "
              f"{c['ms']['sbwd'] + c['ms']['sfwd']:.4f}); |diff| to the twins "
              f"{c['pre']:.3e} / {c['bwd']:.3e} / {c['fwd']:.3e}, CR pair vs serial kernels "
              f"{c['pair']:.3e} (max |dl| "
              f"{float(ref[2].abs().max()):.3e}) on {card}")

    # the three kernels at their edges: against their twins, the CR pair
    # against the serial kernels; and the launch of every shape here
    # (threads, shared memory) against ops/chain_cr.py's sweep_launch, which
    # sizes the scratch, and precompute_launch
    edge_err = dict(pre=0.0, bwd=0.0, fwd=0.0, pair=0.0)
    for k, (S_, L_, n_) in enumerate(CR_EDGES):
        Ls_, CUs_, res_, dr_ = cr_operands(torch, S_, L_, n_, CR_SEED + k, dev)
        what = f"S={S_} L={L_} n={n_}"
        Ab, Bf = ccr.chain_cr_precompute(Ls_, CUs_)
        e_pre = compare(torch, f"chain_cr_precompute ({what})", [Ab, Bf],
                        ccr.chain_cr_precompute_ref(Ls_, CUs_), FACTOR_RTOL)
        ys_r, radd_r = ccr.chain_solve_bwd_cr_ref(Ls_, CUs_, Ab, res_)
        ys_c, radd_c = ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, res_)
        d_c = ccr.chain_forward_cr(Ls_, CUs_, Bf, ys_c, dr_)
        e_b = compare(torch, f"chain_solve_bwd_cr ({what})", [ys_c, radd_c], [ys_r, radd_r],
                      SOLVE_RTOL)
        e_f = compare(torch, f"chain_forward_cr ({what})",
                      [ccr.chain_forward_cr(Ls_, CUs_, Bf, ys_r, dr_)],
                      [ccr.chain_forward_cr_ref(Ls_, CUs_, Bf, ys_r, dr_)], SOLVE_RTOL)
        ys_s, radd_s = ck.chain_solve_bwd(Ls_, CUs_, res_)
        d_s = ck.chain_forward(Ls_, CUs_, ys_s, dr_)
        torch.cuda.synchronize()
        e_p = compare(torch, f"CR pair vs serial kernels ({what})", [ys_c, radd_c, d_c],
                      [ys_s, radd_s, d_s], CR_PAIR_RTOL)
        for key, e in (("pre", e_pre), ("bwd", e_b), ("fwd", e_f), ("pair", e_p)):
            edge_err[key] = max(edge_err[key], e)
        print(f"CR kernels ({what}; precompute launch {ccr.precompute_launch(n_)}, "
              f"sweeps {ccr.sweep_launch(L_, n_)}): |diff| to the twins {e_pre:.3e} / {e_b:.3e} / "
              f"{e_f:.3e}, CR pair vs serial kernels {e_p:.3e}; precompute "
              f"{graph_ms(torch, lambda: ccr.chain_cr_precompute(Ls_, CUs_)):.4f} ms in a CUDA "
              f"graph on {card}")
    for L_, n_ in sorted({(L_, n_) for _, L_, n_ in CR_EDGES}
                         | {tuple(v[0].shape[1:3]) for v in cr_in.values()}):
        threads, smem, scratch = ccr.sweep_launch(L_, n_)
        got = _build.int_array((0, 0))
        _build.lib().tq_chain_cr_sweep_launch(L_, n_, got)
        if got[0] != threads or (got[1] != smem if smem else got[1] <= 227 * 1024):
            fail(f"CR sweeps (L={L_}, n={n_}): the kernel launches {got[0]} threads with "
                 f"{got[1]} B of shared memory, sweep_launch says {threads}, {smem} B, "
                 f"scratch {scratch}")
    for n_ in sorted({n_ for _, _, n_ in CR_EDGES} | {v[0].shape[2] for v in cr_in.values()}):
        got = _build.int_array((0, 0))
        _build.lib().tq_chain_cr_precompute_launch(n_, got)
        if (got[0], got[1]) != ccr.precompute_launch(n_):
            fail(f"chain_cr_precompute (n={n_}): the kernel launches {got[0]} threads with "
                 f"{got[1]} B of shared memory; precompute_launch says "
                 f"{ccr.precompute_launch(n_)}")

    # the JSON rows at the pruned tree's shape (rows 2 and 3's), the other
    # shapes in their descriptions
    Ls_, CUs_, res_, dr_ = cr_in["pruned"]
    S_, L_, n_ = Ls_.shape[:3]
    Ab, Bf = ccr.chain_cr_precompute_ref(Ls_, CUs_)
    ys_p = ccr.chain_solve_bwd_cr_ref(Ls_, CUs_, Ab, res_)[0]
    lib_bwd, lib_fwd, lib_err = sweep_library(Ls_, CUs_, res_, ys_p, dr_)
    others = lambda part: "; ".join(
        f"{tag} {cr_rows[tag]['ms'][part]:.4f} ms"
        + (f" ({cr_rows[tag]['ms']['pre_graph']:.4f} in a graph)" if part == "pre" else "")
        + f" (|diff| {cr_rows[tag][part]:.3e}, CR pair vs serial {cr_rows[tag]['pair']:.3e})"
        for tag in ("random", "sdunes", "long"))
    edges = lambda part: (f"CR_EDGES |diff| {edge_err[part]:.3e} (CR pair vs serial "
                          f"{edge_err['pair']:.3e})")
    record_graph("chain_cr_precompute", "chain_cr.cu", "treeqp_tpu/ops/chain_cr.py:68",
                 max([r["pre"] for r in cr_rows.values()] + [edge_err["pre"]]),
                 lambda: ccr.chain_cr_precompute(Ls_, CUs_),
                 lambda: ccr.chain_cr_precompute_ref(Ls_, CUs_),
                 f"Ls {tuple(Ls_.shape)}; {others('pre')}; {edges('pre')}", (Ls_, CUs_),
                 S_ * cr_ops(L_, n_, "pre"))
    lib_note = "batched solve_triangular on each chain's [L n]^2 factor"
    record_graph("chain_solve_bwd_cr", "chain_cr.cu", "treeqp_tpu/ops/chain_cr.py:132",
                 max([r["bwd"] for r in cr_rows.values()] + [edge_err["bwd"]]),
                 lambda: ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, res_),
                 lambda: ccr.chain_solve_bwd_cr_ref(Ls_, CUs_, Ab, res_),
                 f"res {tuple(res_.shape)}; {others('bwd')}; {edges('bwd')}; the library call "
                 f"|diff| {lib_err:.3e}",
                 (Ls_, Ab, res_, CUs_[:, 0]), S_ * cr_ops(L_, n_, "sweep"), lib_fn=lib_bwd,
                 lib_note=lib_note)
    record_graph("chain_forward_cr", "chain_cr.cu", "treeqp_tpu/ops/chain_cr.py:168",
                 max([r["fwd"] for r in cr_rows.values()] + [edge_err["fwd"]]),
                 lambda: ccr.chain_forward_cr(Ls_, CUs_, Bf, ys_p, dr_),
                 lambda: ccr.chain_forward_cr_ref(Ls_, CUs_, Bf, ys_p, dr_),
                 f"ys {tuple(ys_p.shape)}; {others('fwd')}; {edges('fwd')}",
                 (Ls_, Bf, ys_p, dr_), S_ * cr_ops(L_, n_, "sweep"), lib_fn=lib_fwd,
                 lib_note=lib_note)
    for r in results[-3:]:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library call "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
              f"max |diff| {r['max_abs_err']:.3e} [{r['shapes']}] on {card}")

    def cr_loop():
        """scripts/prof_torch_chain_cr.py's loop, CR_LOOP pairs a shape: the
        CR operands once, then backward + forward pairs with the
        right-hand side varied each step, CR and serial."""
        for Ls_, CUs_, res_, dr_ in cr_in.values():
            Ab, Bf = ccr.chain_cr_precompute(Ls_, CUs_)
            for k in range(CR_LOOP):
                r = res_ * (1.0 + 2e-4 * k)
                ys, radd = ccr.chain_solve_bwd_cr(Ls_, CUs_, Ab, r)
                d_c = ccr.chain_forward_cr(Ls_, CUs_, Bf, ys, dr_ + radd)
                ys, radd = ck.chain_solve_bwd(Ls_, CUs_, r)
                d_s = ck.chain_forward(Ls_, CUs_, ys, dr_ + radd)
                compare(torch, "CR pair vs serial kernels (loop)", [d_c], [d_s], CR_PAIR_RTOL)
    drive("CR sweeps", cr_names + ("chain_solve_bwd", "chain_forward"), cr_loop,
          forbid=ms_names + admm_name + ("chain_factor", "crown_factor", "crown_solve"),
          cr_path=True)

    # ---- 10. the MPC re-embedding path (slice 8): the pruned headline tree
    # of section 5 with its root state folded in once (set_x0, then
    # eliminate_x0 keeping the originals), one cold solve and the closed
    # loop's steps, each re-embedding the plant's next state through
    # EliminatedTreeQP.set_x0
    x0_g = qg.xmin[0].cpu().numpy()
    root_x = torch.zeros_like(qg.xmin, dtype=torch.bool)
    root_x[0] = True

    def same_data(a, b):
        """Every field equal, the root's state bounds aside (the nx[0] = 0
        topology leaves them out; re-embedding keeps the first x0's)."""
        bad = [f for f in QP_FIELDS if not torch.equal(
            *(getattr(q, f).masked_fill(root_x, 0.0) if f in ("xmin", "xmax")
              else getattr(q, f) for q in (a, b)))]
        return a.topo == b.topo and not bad, bad

    def mpc_request(el, x, lam0, what):
        """One request: (re-embedding and) solve of the eliminated problem,
        certified and held to the un-eliminated solve and to elimination
        from scratch. Returns (the eliminated QP, out, ms, launches)."""
        n0 = {k.__name__: k.launches for k in generic_kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if lam0 is not None:
            el = el.set_x0(x)
        out = td.tdunes_solve(el.qp, lam0, optsg)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t0) * 1e3
        launches = {k.__name__: k.launches - n0[k.__name__] for k in generic_kernels}
        ok, bad = same_data(el.qp, qg.set_x0(x).eliminate_x0())
        if not ok:
            fail(f"{what}: the re-embedded data differ from elimination from scratch in {bad}")
        kkt = max_kkt_residual(el.qp, out)
        if out.info["status"] != td.TDUNES_OPTIMAL:
            print(f"{what}: stalled, status {out.info['status']} after "
                  f"{out.info['iter']} iterations, kkt {kkt:.3e}, state {x}")
            return el, out, t_ms, launches
        if not kkt < TOL:
            fail(f"{what}: status 0 but kkt {kkt}")
        full = td.tdunes_solve(qg.set_x0(x), None, optsg)
        gaps = {"x[1:]": float((out.x[1:] - full.x[1:]).abs().max()),
                "u": float((out.u - full.u).abs().max())}
        if max(gaps.values()) > MPC_GAP:
            fail(f"{what}: the eliminated and the full solve differ: {gaps}")
        print(f"{what}: iter {out.info['iter']} ({out.info['iter_f32']} coarse), kkt "
              f"{kkt:.3e}, {t_ms:.1f} ms, launches {launches}; the solve without "
              f"elimination: iter {full.info['iter']}, "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items()) + f" on {card}")
        return el, out, t_ms, launches

    def mpc_path():
        el = qg.set_x0(x0_g).eliminate_x0(keep_originals=True)
        if el.qp.topo.nx[0] != 0 or len(el.kids0) != len(qg.topo.kids[0]):
            fail(f"eliminate_x0: root nx {el.qp.topo.nx[0]}, {len(el.kids0)} kids kept")
        x, lam, rows, nu0 = x0_g, None, [], qg.topo.nu[0]
        for k in range(N_REQUESTS_MPC + 1):
            what = "MPC cold request" if lam is None else f"MPC warm request {k - 1}"
            el, out, t_ms, _ = mpc_request(el, x, lam, what)
            rows.append((out.info["iter"], t_ms, out.info["status"], x))
            # closed_loop_mpc: the first control to the plant, the duals kept
            x, lam = quad.simulate(x, out.u[0, :nu0].cpu().numpy()), out.lam
        return rows
    rows_mpc = drive("MPC re-embedding", generic_names, mpc_path, forbid=ms_names + admm_name)
    stalled = sum(st != td.TDUNES_OPTIMAL for _, _, st, _ in rows_mpc)
    print(f"MPC re-embedding on quadcopter({MD},{NR},{NH}) pruned to {GEN_SCEN} scenarios, "
          f"the closed loop's states {[np.round(x, 4).tolist() for *_, x in rows_mpc]}: "
          f"iterations {[r[0] for r in rows_mpc]}, ms a request "
          f"{[round(r[1], 2) for r in rows_mpc]} (re-embedding and solve), "
          f"{stalled} of {len(rows_mpc)} stalled, on {card}")
    if stalled:
        fail(f"{stalled} MPC requests stalled")
    # the LTV setters rebuild the instance from flat arrays, bit for bit
    nxg, nug = qg.topo.nx, qg.topo.nu
    host = {f: getattr(qg, f).cpu().numpy() for f in QP_FIELDS}
    par = qg.topo.parent
    col = lambda M: M.T.ravel()  # column-major
    cat = lambda parts: np.concatenate([np.ravel(p) for p in parts])
    rebuilt = qg.set_ltv_dynamics(
        cat(col(host["A"][c, :nxg[c], :nxg[par[c]]]) for c in range(1, qg.topo.Nn)),
        cat(col(host["B"][c, :nxg[c], :nug[par[c]]]) for c in range(1, qg.topo.Nn)),
        cat(host["b"][c, :nxg[c]] for c in range(1, qg.topo.Nn)))
    nodes = range(qg.topo.Nn)
    rebuilt = rebuilt.set_ltv_objective_diag(
        cat(np.diag(host["Q"][i])[:nxg[i]] for i in nodes),
        cat(np.diag(host["R"][i])[:nug[i]] for i in nodes),
        cat(host["q"][i, :nxg[i]] for i in nodes), cat(host["r"][i, :nug[i]] for i in nodes))
    rebuilt = rebuilt.set_ltv_bounds(*(
        cat(host[f][i, :(nxg if f[0] == "x" else nug)[i]] for i in nodes)
        for f in ("xmin", "xmax", "umin", "umax")))
    bad = [f for f in QP_FIELDS if not torch.equal(getattr(rebuilt, f), getattr(qg, f))]
    if bad:
        fail(f"the LTV setters did not rebuild {bad}")
    print(f"LTV setters: A, B, b, Q, R, q, r and the bounds of the {qg.topo.Nn}-node tree "
          f"rebuilt from flat arrays, every field equal")
    print(f"sections 9-10 (slice 8): {time.perf_counter() - t_slice8:.1f} s on {card}")

    # ---- 11. the JAX package's default solver options (slice 23): general
    # C/D at general_cd_bench's CPU options (path G), the bench path with
    # the on-the-fly shift (path B), each solver on the portable backend
    # (paths P: no kernel), and the open MPC question of section 10
    t_slice23 = time.perf_counter()
    all_names = tuple(k.__name__ for k in kernels)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def g_request(q, lam0, ws0, o, what):
        """One tdunes_solve request, certified: status 0, stationarity below
        the options' tol, KKT < 1e-8, finite output of the right shape."""
        n0 = {k.__name__: k.launches for k in kernels}
        out, t_ms = timed(lambda: td.tdunes_solve(q, lam0, o, stage_ws=ws0))
        kkt, info = max_kkt_residual(q, out), out.info
        if info["status"] != td.TDUNES_OPTIMAL or not info["error"] < o.tol or not kkt < TOL:
            fail(f"{what}: status {info['status']} error {info['error']} kkt {kkt}")
        if tuple(out.x.shape) != (q.topo.Nn, q.topo.nxm) or not all(
                bool(torch.isfinite(v).all()) for v in (out.x, out.u, out.lam, out.mu_d)):
            fail(f"{what}: output of the wrong shape or not finite")
        launched = {k.__name__: k.launches - n0[k.__name__] for k in kernels
                    if k.launches > n0[k.__name__]}
        print(f"{what}: iter {info['iter']}, error {info['error']:.3e}, kkt {kkt:.3e}, "
              f"{t_ms:.1f} ms, launches {launched} on {card}")
        return out, t_ms

    optsgc = td.TdunesOpts(**GENERAL_CD_CPU_OPTS)

    def general_cpu_opts(q, o, mode):
        """A cold request and a warm chain of N_REQUESTS_DEF requests (b +
        1e-6 (k + 1), from the previous duals and working sets)."""
        first, t_cold = g_request(q, None, None, o, f"G {mode} cold request")
        prev, rows = first, []
        for k in range(N_REQUESTS_DEF):
            prev, t_ms = g_request(q.replace(b=q.b + CD_DB * (k + 1)), prev.lam,
                                   prev.info["qpgen_ws"], o, f"G {mode} warm request {k}")
            rows.append((prev.info["iter"], t_ms))
        print(f"G {mode} ({q.topo.Nn} nodes) at general_cd_bench's CPU options: cold "
              f"{first.info['iter']} iterations, {t_cold:.1f} ms; warm iterations "
              f"{[r[0] for r in rows]}, ms {[round(r[1], 1) for r in rows]} on {card}")
        return first
    for mode in ("qpgen", "mixed"):
        q_def = general_cd(mode, Nr=CD_DEF_NR, device=dev)
        drive(f"G {mode}", admm_name,
              lambda: general_cpu_opts(q_def, dataclasses.replace(optsgc, stage_solver=mode),
                                       mode),
              forbid=tuple(n for n in all_names if n != "admm_identify"))

    # B: bench.py's options with reg_type "on_the_fly": the chain kernels,
    # the crown's plain tree Cholesky, the three-call solve, the coarse
    # phase's per-kernel loop and ms_df64's kernels
    optsbo = td.TdunesOpts(**BENCH_OTF_OPTS)
    b_needs = ("chain_eval", "crown_eval", "chain_blocks_factor_lanes", "chain_solve_bwd",
               "chain_forward") + df_kernels
    tbo = drive("bench on-the-fly", b_needs,
                lambda: requests(optsbo, 2, ("cold", "warm"), None, "bench-path on-the-fly"),
                forbid=tuple(n for n in all_names if n not in b_needs))
    print(f"B: bench path with reg_type on_the_fly, iterations cold {tbo['cold'][1]} "
          f"(coarse {tbo['cold'][2]}), warm {tbo['warm'][1]} (coarse {tbo['warm'][2]}); at "
          f"reg_type always (section 3) cold {tb['cold'][1][:2]} (coarse "
          f"{tb['cold'][2][:2]}), warm {tb['warm'][1][:2]}; {tbo['cold'][0]:.1f} vs "
          f"{tb['cold'][0]:.1f} ms a cold request on {card}")

    # P: the portable backend, no kernel launch; each the plain baseline of
    # its solver, certified
    optsp = td.TdunesOpts(**GENERIC_CPU_OPTS)

    def p_generic():
        g_request(qg, None, None, optsp, "P tdunes_solve (first, warm-up)")
        return g_request(qg, None, None, optsp,
                         f"P tdunes_solve, quadcopter({MD},{NR},{NH}) pruned to {GEN_SCEN} "
                         f"scenarios, generic_bench's CPU options")
    drive("P generic", (), p_generic, forbid=all_names)

    q1k_cpu = spring_mass_chain(*SCEN1024, device="cpu")[0]
    q1k, ms1k = q1k_cpu.to(dev), tm.split_multistage(q1k_cpu).to(dev)
    opts1k = td.TdunesOpts(**SCEN1024_CPU_OPTS)

    def p_multistage():
        for what in ("first, warm-up", "again"):
            (cro, cho, info), t_ms = timed(lambda: tm.tdunes_ms_solve(ms1k, None, None, opts1k))
            out = tm.merge_output(ms1k, cro, cho, info)
            kkt = max_kkt_residual(q1k, out)
            if info["status"] != td.TDUNES_OPTIMAL or not info["error"] < TOL \
                    or not kkt < TOL or not bool(torch.isfinite(out.lam).all()):
                fail(f"P tdunes_ms_solve: status {info['status']} error {info['error']} "
                     f"kkt {kkt}")
            print(f"P tdunes_ms_solve ({what}), spring_mass_chain{SCEN1024} "
                  f"({q1k.topo.Nn} nodes), scen1024_bench's CPU options: iter "
                  f"{info['iter']}, kkt {kkt:.3e}, {t_ms:.1f} ms on {card}")
        return info
    drive("P multistage", (), p_multistage, forbid=all_names)
    optssp = sd.SdunesOpts(**SDUNES_CPU_OPTS)

    def p_sdunes():
        for what in ("first, warm-up", "again"):
            (sol, lam, mu, info), t_ms = timed(lambda: sd.sdunes_solve(sqp, None, None, optssp))
            out = sd.scenario_output(sqp, sol, lam, mu, info)
            kkt = max_kkt_residual(qb, out)
            if info["status"] != td.TDUNES_OPTIMAL or not info["error"] < TOL \
                    or not kkt < TOL:
                fail(f"P sdunes_solve: status {info['status']} error {info['error']} "
                     f"kkt {kkt}")
            print(f"P sdunes_solve ({what}), box-only spring_mass_chain(4,4,4,20), "
                  f"sdunes_bench's CPU options: iter {info['iter']}, kkt {kkt:.3e}, "
                  f"{t_ms:.1f} ms on {card}")
        return info
    drive("P sdunes", (), p_sdunes, forbid=all_names)

    # the open MPC question: the state that stalls both packages at reg_type
    # "always" (tests/test_torch_qp_mpc.py), with the on-the-fly shift, on
    # the card and through the plain path on the CPU
    q_mpc_cpu = pruned(quadcopter(2, 2, 6, device="cpu").qp, 3)
    x_mpc = quadcopter(2, 2, 6, device="cpu").x0
    rng_mpc = np.random.default_rng(0)
    x_mpc = [x_mpc + 0.05 * rng_mpc.standard_normal(x_mpc.shape) for _ in range(2)][1]
    q_mpc_cpu = q_mpc_cpu.set_x0(x_mpc)
    q_mpc = q_mpc_cpu.to(dev)
    for reg in ("always", "on_the_fly"):
        o = td.TdunesOpts(**{**GENERIC_SPEED_OPTS, "reg_type": reg})
        out, t_ms = timed(lambda: td.tdunes_solve(q_mpc, None, o))
        out_c = td.tdunes_solve(q_mpc_cpu, None, o)
        kkt, kkt_c = max_kkt_residual(q_mpc, out), max_kkt_residual(q_mpc_cpu, out_c)
        print(f"MPC jump state (quadcopter(2,2,6) pruned to 3, x0 + 0.05 N(0, I), seed 0, "
              f"second draw), reg_type {reg}: card status {out.info['status']} iter "
              f"{out.info['iter']} kkt {kkt:.3e} ({t_ms:.1f} ms), CPU status "
              f"{out_c.info['status']} iter {out_c.info['iter']} kkt {kkt_c:.3e} on {card}")
        if not math.isfinite(kkt) or (out.info["status"], out.info["iter"]) != (
                out_c.info["status"], out_c.info["iter"]):
            fail(f"MPC jump state, reg_type {reg}: the card and the CPU disagree")
    print(f"section 11 (slice 23): {time.perf_counter() - t_slice23:.1f} s on {card}")

    # ---- 12. the surfaces (slice 24): the JSON front-end in process, the
    # solve server and the one-shot file mode as child processes, the C++
    # demo, the profiler
    t_slice24 = time.perf_counter()
    from treeqp_tpu_torch.core.json_io import load_tree_qp_json, tree_qp_to_json
    from treeqp_tpu_torch.interfaces import cli
    from treeqp_tpu_torch.utils import profiling
    SURF_DIR.mkdir(parents=True, exist_ok=True)

    def surface_request(name, j, init, expect, direct, needs=()):
        """(a) One in-process ``solve_request`` on the card, its launches
        counted (``needs`` and no other kernel), certified (status 0, KKT <
        1e-8, the expected dispatch) and held against ``direct(qp)``, the
        solver called directly on the same data with the options the CLI
        builds: iterations equal, x and u within SURF_GAP."""
        resp = drive(f"S {name}", needs, lambda: cli.solve_request(j, init, device=dev),
                     forbid=tuple(n for n in all_names if n not in needs))
        info = resp["info"]
        if info["solver"] != expect or info["status"] != 0 or not info["kkt_tol"] < TOL:
            fail(f"S {name}: {info}")
        qpd, _ = load_tree_qp_json(j, device=dev)
        if init and "x0" in init:
            qpd = qpd.set_x0(np.asarray(init["x0"], dtype=np.float64))
        out = direct(qpd)
        gap = 0.0
        for k in ("x", "u"):
            h = getattr(out, k).cpu().numpy()
            dk = [h[i, :n] for i, n in enumerate(getattr(qpd.topo, "n" + k))]
            gap = max(gap, float(np.abs(np.concatenate([nd[k] for nd in resp["nodes"]])
                                        - np.concatenate(dk)).max()))
        if out.info["iter"] != info["num_iter"] or not gap <= SURF_GAP:
            fail(f"S {name}: {info['num_iter']} iterations against the direct call's "
                 f"{out.info['iter']}, max |dx|, |du| {gap:.3e}")
        mb = len(json.dumps(j)) / 1e6
        print(f"S {name}: {info['solver']}, iter {info['num_iter']}, kkt {info['kkt_tol']:.3e}, "
              f"solver_time {info['solver_time'] * 1e3:.2f} ms, interface_time "
              f"{info['interface_time'] * 1e3:.2f} ms, JSON {mb:.2f} MB; the direct call "
              f"{out.info['iter']} iterations, max |dx|, |du| {gap:.2e} on {card}")
        return resp

    def ms_direct(solve):
        def run(q):
            msd = tm.split_multistage(q)
            return tm.merge_output(msd, *solve(msd))
        return run

    # the headline tree, clipping: tdunes_ms, cold, then warm from the
    # response's duals at x0 scaled as section 3 scales it
    j_head = tree_qp_to_json(qp, options=SURF_HEAD_OPTS)
    o_head = td.TdunesOpts(stage_solver="clipping")
    head = surface_request("headline cold", j_head, None, "tdunes_ms",
                           ms_direct(lambda m: tm.tdunes_ms_solve(m, None, None, o_head)))
    init_head = dict(x0=(facs[0] * quad.x0).tolist(), lam0_tree=head["init"]["lam0_tree"])

    def head_warm(q):
        msd = tm.split_multistage(q)
        lam0 = torch.as_tensor(cli._lam_tree_to_nodes(
            np.asarray(init_head["lam0_tree"]), q.topo), device=dev)
        return tm.merge_output(msd, *tm.tdunes_ms_solve(msd, *tm.split_duals(msd, lam0), o_head))
    surface_request("headline warm", j_head, init_head, "tdunes_ms", head_warm)
    # section 7's box-only tree through the IPM family
    o_ipm = ipm.IpmOpts()
    surface_request("box-only hpipm", tree_qp_to_json(qb, options=dict(solver="hpipm")), None,
                    "hpipm_ms", ms_direct(lambda m: ims.ipm_ms_solve(m, o_ipm)))
    surface_request("box-only ipm", tree_qp_to_json(
        qb, options=dict(solver="ipm", multistage=False)), None, "ipm",
        lambda q: ipm.ipm_solve(q, o_ipm))
    # section 11's general C/D tree: the stage solver resolves to qpgen
    q_surf_cd = general_cd("qpgen", Nr=CD_DEF_NR, device=dev)
    j_cd = tree_qp_to_json(q_surf_cd, options=SURF_CD_OPTS)
    o_cd = td.TdunesOpts(max_iter=150, tol=2.5e-9, stage_solver="qpgen")
    if cli._pick_stage_solver(q_surf_cd, SURF_CD_OPTS) != "qpgen":
        fail("the general C/D request does not resolve to the qpgen stage solver")
    cd = surface_request("general C/D cold", j_cd, None, "tdunes",
                         lambda q: td.tdunes_solve(q, None, o_cd), needs=admm_name)
    init_cd = dict(lam0_tree=cd["init"]["lam0_tree"])
    surface_request("general C/D warm", j_cd, init_cd, "tdunes", lambda q: td.tdunes_solve(
        q, torch.as_tensor(cli._lam_tree_to_nodes(np.asarray(init_cd["lam0_tree"]), q.topo),
                           device=dev), o_cd), needs=admm_name)
    # section 8's tree through sdunes
    def sd_direct(q):
        sq = sd.scenario_data(q)
        return sd.scenario_output(sq, *sd.sdunes_solve(sq, None, None, sd.SdunesOpts()))
    surface_request("box-only sdunes", tree_qp_to_json(qb, options=dict(solver="sdunes")),
                    None, "sdunes", sd_direct)

    # (b) the solve server as a child process on the card (no --device)
    def compute_apps():
        return subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.split()

    def on_card(pid):
        """The child's own witness: its open files include a /dev/nvidia*
        device, or its memory maps list libcuda."""
        fds = Path(f"/proc/{pid}/fd")
        devs = set()
        for fd in fds.iterdir():
            try:
                devs.add(os.readlink(fd))
            except OSError:
                pass
        nv = sorted(d for d in devs if d.startswith("/dev/nvidia"))
        cuda = "libcuda" in Path(f"/proc/{pid}/maps").read_text()
        return nv, cuda

    def serve_child():
        """The headline and general C/D requests, each cold and then
        N_SERVE_REPEATS times more, through one server child; each response
        held to (a)'s, the child seen on the card, quit, exit 0. The child is
        on the card when its own /proc entry shows a /dev/nvidia* file or
        libcuda mapped, and nvidia-smi lists it: by its pid, or, where
        nvidia-smi reports pids of another namespace (every process as pid
        1), as one compute app more than before it started, gone once it has
        quit."""
        apps0 = compute_apps()
        err_log = SURF_DIR / "serve.stderr.txt"
        with open(err_log, "w") as err:
            child = subprocess.Popen([sys.executable, "-m", "treeqp_tpu_torch.interfaces.cli",
                                      "--serve"], cwd=ROOT, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            t0 = time.perf_counter()
            hello = child.stdout.readline()
            if json.loads(hello or "null") != {"ready": True}:
                fail(f"server handshake {hello!r}; stderr: {err_log.read_text()[-2000:]}")
            print(f"server: handshake after {time.perf_counter() - t0:.2f} s on {card}")
            seen = False
            for name, j, ref in (("headline", j_head, head), ("general C/D", j_cd, cd)):
                walls = []
                for k in range(1 + N_SERVE_REPEATS):
                    t0 = time.perf_counter()
                    child.stdin.write(json.dumps(dict(qp=j)) + "\n")
                    child.stdin.flush()
                    line = child.stdout.readline()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    resp = json.loads(line or "null")
                    if not isinstance(resp, dict) or "error" in resp:
                        fail(f"server {name} request {k}: {line[:500]!r}; stderr: "
                             f"{err_log.read_text()[-2000:]}")
                    gap = float(np.abs(np.concatenate([nd["x"] for nd in resp["nodes"]])
                                       - np.concatenate([nd["x"] for nd in ref["nodes"]])).max())
                    if resp["info"]["num_iter"] != ref["info"]["num_iter"] or not gap <= SURF_GAP:
                        fail(f"server {name} request {k}: {resp['info']['num_iter']} iterations "
                             f"against {ref['info']['num_iter']} in process, max |dx| {gap:.3e}")
                    if not seen:
                        apps = compute_apps()
                        nv, cuda = on_card(child.pid)
                        print(f"nvidia-smi compute apps {apps} (before the server {apps0}), "
                              f"server pid {child.pid}; its /dev/nvidia files {nv}, "
                              f"libcuda mapped: {cuda}")
                        if not (nv or cuda):
                            fail(f"the server child {child.pid} holds no /dev/nvidia* file "
                                 f"and maps no libcuda")
                        if str(child.pid) not in apps and not (
                                str(child.pid) not in apps0 and len(apps) == len(apps0) + 1):
                            fail(f"the server child {child.pid} is not on the card ({apps})")
                        seen = True
                print(f"server {name}: iter {resp['info']['num_iter']}, wall from write to "
                      f"response {[round(w, 1) for w in walls]} ms (cold, then "
                      f"{N_SERVE_REPEATS} repeats), solver_time "
                      f"{resp['info']['solver_time'] * 1e3:.2f} ms, interface_time "
                      f"{resp['info']['interface_time'] * 1e3:.2f} ms on {card}")
            child.stdin.write(json.dumps({"cmd": "quit"}) + "\n")
            child.stdin.flush()
            rc = child.wait(timeout=60)
            if rc != 0:
                fail(f"the server exited {rc}: {err_log.read_text()[-2000:]}")
            apps = compute_apps()
            print(f"server quit, exit 0; nvidia-smi compute apps {apps}")
            if len(apps) != len(apps0):
                fail(f"a compute app outlived the server: {apps} against {apps0}")
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    serve_child()

    # (c) the one-shot file mode on a small tree, (d) the C++ demo on it
    q_small = spring_mass_chain(1, 2, 1, 4, device="cpu")[0]
    j_small = tree_qp_to_json(q_small, options=SURF_DEMO_OPTS)
    (SURF_DIR / "small.json").write_text(json.dumps(j_small))
    t0 = time.perf_counter()
    res = subprocess.run(["python3", "-m", "treeqp_tpu_torch.interfaces.cli",
                          str(SURF_DIR / "small.json"), "-o", str(SURF_DIR / "small_out.json")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"one-shot file mode exited {res.returncode}: {res.stderr[-2000:]}")
    small = json.loads((SURF_DIR / "small_out.json").read_text())
    if (small["info"]["status"] != 0 or small["info"]["solver"] != "tdunes"
            or len(small["nodes"]) != q_small.topo.Nn or len(small["edges"]) != q_small.topo.Nn - 1
            or not {"x", "u", "mu_x", "mu_u", "mu_d"} <= set(small["nodes"][0])):
        fail(f"one-shot file mode wrote {small['info']}")
    print(f"one-shot file mode: {res.stdout.strip()} ({time.perf_counter() - t0:.1f} s with "
          f"the process start) on {card}")
    demo = ROOT / "build" / "treeqp_tpu_torch" / "treeqp_cpp_demo"
    subprocess.run(["make", "-C", str(ROOT / "treeqp_tpu_torch" / "interfaces" / "cpp"),
                    f"BUILD={demo.parent}", "demo"], check=True, timeout=300)
    j_demo = {k: v for k, v in j_small.items() if k != "options"}
    for nd, sol in zip(j_demo["nodes"], small["nodes"]):
        nd["xopt"], nd["uopt"] = sol["x"], sol["u"]
    (SURF_DIR / "demo.json").write_text(json.dumps(j_demo))
    t0 = time.perf_counter()
    res = subprocess.run([str(demo), str(SURF_DIR / "demo.json"), str(N_DEMO_WARM), "cuda"],
                         cwd=ROOT, env=dict(os.environ, TREEQP_ROOT=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"treeqp_cpp_demo exited {res.returncode}: {res.stdout} {res.stderr[-2000:]}")
    for line in res.stdout.splitlines():
        print(f"treeqp_cpp_demo: {line}")
    print(f"treeqp_cpp_demo: {time.perf_counter() - t0:.1f} s with the server start on {card}")

    # (e) the profiler: profile_ms_phases on the headline at bench.py's
    # options, profile_tdunes_ops on section 5's pruned tree
    prof_needs = ("chain_eval", "crown_eval", "chain_blocks_factor_lanes",
                  "crown_blocks_factor", "system_solve") + df_kernels
    prof = drive("S profile_ms_phases", prof_needs,
                 lambda: profiling.profile_ms_phases(ms, optsb),
                 forbid=tuple(n for n in all_names if n not in prof_needs + ("chain_factor",)))
    if not all(v > 0 for v in prof.values()):
        fail(f"profile_ms_phases: {prof}")
    hi_iters = bench_head["iter"] - bench_head["iter_f32"]
    if abs(prof["f32_phase_iters"] - bench_head["iter_f32"]) > 1 \
            or abs(prof["df64_phase_iters"] - hi_iters) > 1:
        fail(f"profile_ms_phases' phases {prof} against the bench solve's {bench_head}")
    print(f"profile_ms_phases (headline, bench.py's options): "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" if isinstance(v, float) else f"{k} {v}"
                      for k, v in prof.items())
          + f"; the bench solve's phases {bench_head['iter_f32']} + {hi_iters} on {card}")
    prof_g = drive("S profile_tdunes_ops", generic_names,
                   lambda: profiling.profile_tdunes_ops(qg, optsg),
                   forbid=tuple(n for n in all_names if n not in generic_names))
    if not all(v > 0 for v in prof_g.values()):
        fail(f"profile_tdunes_ops: {prof_g}")
    print(f"profile_tdunes_ops (pruned, GENERIC_SPEED_OPTS): "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in prof_g.items()) + f" on {card}")
    print(f"section 12 (slice 24): {time.perf_counter() - t_slice24:.1f} s on {card}")

    # ---- 13. the multi-device solve: the chain-side kernels of
    # the three sharded paths at the ranks' local chain counts against their
    # twins (the crown side is replicated at the shapes of sections 2, 7 and
    # 8), then tdunes_ms, ipm_ms and sdunes over groups of 1, 2 and 4 ranks
    # that share the card (gloo)
    t_shard = time.perf_counter()
    from treeqp_tpu_torch.parallel.shard_solver import ShardCase
    from treeqp_tpu_torch.parallel.sharding import model_bytes_per_iter
    sm_a = msa.meta
    nz_a = sm_a.nx + sm_a.nu
    errs_l = {}
    for k, S_l in enumerate(SHARD_S_LOCAL):
        rng_l = np.random.default_rng(SHARD_SEED + k)
        g32 = lambda *sh: torch.tensor(rng_l.standard_normal(sh), dtype=f32, device=dev)
        blk = block_operands(torch, S_l, meta.L, meta.nx, meta.nx + meta.nu, SHARD_SEED + k,
                             dev)[0]
        got_b, ref_b = ck.chain_blocks_factor(*blk), ck.chain_blocks_factor_ref(*blk)
        res_l, droot_l = g32(S_l, meta.L, meta.nx), g32(S_l, meta.nx)
        got_s = ck.chain_solve_bwd(got_b[0], got_b[1], res_l)
        ref_s = ck.chain_solve_bwd_ref(got_b[0], got_b[1], res_l)
        got_f = ck.chain_forward(got_b[0], got_b[1], got_s[0], droot_l)
        ref_f = ck.chain_forward_ref(got_b[0], got_b[1], got_s[0], droot_l)
        hbar_l, AB_l = ric_operands(torch, S_l, sm_a.L, sm_a.nx, nz_a, True, SHARD_SEED + k, dev)
        got_r, w_r = rk.ric_chain_factor(hbar_l, AB_l, reg=RIC_REG)
        ref_r, wref_r = rk.ric_chain_factor_ref(hbar_l, AB_l, reg=RIC_REG)
        rg_l, rb_l, zr_l = ric_rhs(torch, S_l, sm_a.L, sm_a.nx, nz_a, SHARD_SEED + k, dev)
        got_rb = rk.ric_chain_bwd(ref_r, rg_l, rb_l)
        ref_rb = rk.ric_chain_bwd_ref(ref_r, rg_l, rb_l)
        got_rf = rk.ric_chain_fwd(ref_r, ref_rb[0], ref_rb[1], rb_l, zr_l)
        ref_rf = rk.ric_chain_fwd_ref(ref_r, ref_rb[0], ref_rb[1], rb_l, zr_l)
        Ls_l, CUs_l, rhs_l = full_operands(torch, S_l, sm.Nh, sm.nx, 1 + nl, SHARD_SEED + k, dev)
        got_m = ck.chain_full_solve_mat(Ls_l, CUs_l, rhs_l)
        ref_m = ck.chain_full_solve_mat_ref(Ls_l, CUs_l, rhs_l)
        Bw = rng_l.standard_normal((S_l, sm.Nh, sm.nx, sm.nx))
        Wc_l = torch.tensor(Bw @ np.swapaxes(Bw, -1, -2) / sm.nx + 4.0 * np.eye(sm.nx),
                            dtype=f32, device=dev)
        Ut_l = 0.3 * g32(S_l, sm.Nh, sm.nx, sm.nx)
        got_c, ref_c = ck.chain_factor(Wc_l, Ut_l), ck.chain_factor_ref(Wc_l, Ut_l)
        torch.cuda.synchronize()
        pick = lambda f, w: [f[q] for q in ("P", "Luu", "K", "Mxu")] + [w]
        for name, got_k, ref_k, rtol in (
                ("chain_blocks_factor", got_b, ref_b, FACTOR_RTOL),
                ("chain_solve_bwd", got_s, ref_s, SOLVE_RTOL),
                ("chain_forward", [got_f], [ref_f], SOLVE_RTOL),
                ("ric_chain_factor", pick(got_r, w_r), pick(ref_r, wref_r), FACTOR_RTOL),
                ("ric_chain_bwd", got_rb, ref_rb, SOLVE_RTOL),
                ("ric_chain_fwd", got_rf, ref_rf, SOLVE_RTOL),
                ("chain_full_solve_mat", [got_m], [ref_m], SOLVE_RTOL),
                ("chain_factor", got_c, ref_c, FACTOR_RTOL)):
            errs_l[(name, S_l)] = compare(torch, f"{name} at S={S_l} chains (a rank's share)",
                                          got_k, ref_k, rtol)
    print(f"chain-side kernels at the ranks' local chain counts S in {SHARD_S_LOCAL} (headline "
          f"L={meta.L}, nx={meta.nx}; IPM path A L={sm_a.L}, nz={nz_a}, dense hbar; sdunes "
          f"Nh={sm.Nh}, n={sm.nx}, m={1 + nl}), max |diff| to the twin: "
          + ", ".join(f"{n} S={S_l} {e:.2e}" for (n, S_l), e in errs_l.items()))

    # sdunes_boot's duals for the unperturbed tree, from the one-device
    # bootstrap on the card
    cro_bt, cho_bt, info_bt = tm.tdunes_ms_solve(msb, None, None, opts_boot)
    if info_bt["status"] != td.TDUNES_OPTIMAL:
        fail(f"sharded sdunes: the bootstrap ended {info_bt}")
    boot_duals = tuple(v.cpu() for v in sd.scenario_duals_from_tree(
        sqp, None, tm.merge_output(msb, cro_bt, cho_bt, info_bt)))
    ms_need = ("chain_blocks_factor", "crown_blocks_factor", "chain_solve_bwd",
               "chain_forward", "crown_solve")
    ipm_need = ("ric_chain_factor", "ric_chain_bwd", "ric_chain_fwd")
    sd_need = ("chain_factor", "chain_full_solve_mat", "jay_cr_solve")
    sqp_cpu = sd.scenario_data(qb_cpu)
    # the device time of the tdunes_ms run only: a trace of the IPM's and
    # sdunes' ~10^5 launches a solve takes minutes. One rank is the
    # one-device solve of sections 7 and 8; on more, the psums' partial
    # sums and the batched PyTorch ops round by the ranks' chain counts,
    # and two of these solves stop where such bits decide. IPM path A's
    # res4 crosses tol at its 28th / 29th iteration (section 7; one step
    # moves u by ~8e-5), so its groups may lie one step apart and are
    # compared only at the same count; the cold sdunes depth follows the
    # rounding of its first iterates (the witness below), so its groups
    # are held to the same converged solution and to the stall escalation
    # of a cold start (JAX's zero-filling wrapper would turn it off), not
    # to the same count
    shard_runs = [
        dict(name="tdunes_ms (headline, bench.py's options)", qp=qp_cpu,
             case=ShardCase("tdunes_ms", ms_cpu, optsb), repeats=SHARD_REPEATS, profile=True,
             needs=ms_need, allowed=ms_need,
             model=model_bytes_per_iter(meta.S, meta.nx, meta.nu)),
        dict(name="ipm_ms (general C/D, path A's options)", qp=qa_cpu,
             case=ShardCase("ipm_ms", msa_cpu, opts_ipm["cd"]), needs=ipm_need,
             allowed=ipm_need, model=None, iter_slack=1, one_device=out_a),
        dict(name="sdunes cold", qp=qb_cpu, case=ShardCase("sdunes", sqp_cpu, opts_sd),
             needs=sd_need, allowed=sd_need, model=None, iter_slack=None, converged=True,
             escalates=True, one_device=out_sd_cold),
        dict(name="sdunes bootstrapped", qp=qb_cpu,
             case=ShardCase("sdunes", sqp_cpu, opts_sd, start=boot_duals), needs=sd_need,
             allowed=sd_need, model=None, escalates=False),
        # path A on the most ranks held to the 1-rank solve at an equal
        # count: max_iter set to the 1-rank group's iterations
        dict(name="ipm_ms (path A, the 1-rank count)", qp=qa_cpu,
             case=ShardCase("ipm_ms", msa_cpu, opts_ipm["cd"]), needs=ipm_need,
             allowed=ipm_need, model=None, worlds=SHARD_WORLDS[-1:],
             capped_by="ipm_ms (general C/D, path A's options)")]
    sharded_solves(torch, card, shard_runs, SHARD_WORLDS, paths=paths)

    # the witness that the cold sdunes count follows rounding on one device
    # too: the one-device cold solve of the same tree with its stage
    # weights Qd scaled by 1 + k 2^-52 (k ulps; the tree's q, r and b are 0)
    counts = [(0, out_sd_cold.info["iter"], out_sd_cold.info["stall_boosts"])]
    for k in SHARD_WITNESS_ULPS:
        sqp_k = sqp.replace(Qd=sqp.Qd * (1.0 + k * 2.0 ** -52))
        info_k = sd.sdunes_solve(sqp_k, None, None, opts_sd)[3]
        if info_k["status"] != td.TDUNES_OPTIMAL or info_k["stall_boosts"] <= 0:
            fail(f"sdunes cold, Qd scaled by 1 + {k} 2^-52: {info_k}")
        counts.append((k, info_k["iter"], info_k["stall_boosts"]))
    print("sdunes cold on one device, Qd scaled by 1 + k 2^-52: " + ", ".join(
        f"k={k}: {it} iterations (escalation at {nb})" for k, it, nb in counts) + f" on {card}")
    print(f"section 13 (the multi-device solve): {time.perf_counter() - t_shard:.1f} s on {card}")

    # ---- 14. the examples and the model families (slice 26): both examples
    # through their main(device="cuda") on the card (their options route to
    # the plain paths: no kernel may launch), then the crane and the linear
    # chain at the reference grid's largest tree on the kernel options:
    # tdunes_ms cold and along the closed loop, ipm_ms, and sdunes warm from
    # the IPM's duals, the three solutions held together
    t_slice26 = time.perf_counter()
    import importlib.util
    import tempfile

    def example(name):
        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    ex_dir = ROOT / "build" / "treeqp_tpu_torch"
    ex_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ex_dir) as sm_dir:
        write_spring_mass_data(sm_dir)  # data.c / x0.txt in the reference's format
        for name, kw in (("thesis_example", {}), ("spring_mass", dict(data_dir=sm_dir))):
            t0 = time.perf_counter()
            res = drive(f"{name} example", (), lambda: example(name).main(device="cuda", **kw),
                        forbid=all_names)
            off = [k for k, o in res.items() if o.x.device.type != "cuda"]
            if off:
                fail(f"{name} example: {off} solved off the card")
            print(f"{name} example on the card: " + ", ".join(
                f"{k} {o.info['iter']} iterations" for k, o in res.items())
                + f", its asserts passed, no kernel launched, in "
                f"{time.perf_counter() - t0:.1f} s on {card}")

    opts_fam_ipm = ipm.IpmOpts(**IPM_OPTS["box"])
    fam_ms_needs = ("newton_iter", "chain_blocks_factor_lanes", "crown_blocks_factor",
                    "system_solve") + df_kernels

    def ran(path):
        return [n for n in all_names if paths[path][n]]

    def family_checks(qf, msf):
        """The five kernels of the bench path held against their twins on
        the operands of their first calls in a cold solve of this tree
        (newton_iter's first "iter" mode call; the high-precision phase's
        first point for chain_eval_df and chain_apply_df)."""
        got, _ = capture(((ck, ("chain_blocks_factor_lanes",)), (ckr, ("crown_blocks_factor",)),
                          (ik, ("newton_iter",)), (dek, ("chain_eval_df", "chain_apply_df"))),
                         lambda: tm.tdunes_ms_solve(msf, None, None, optsb))
        firsts = {n: calls[0] for n, calls in got.items() if n != "newton_iter"}
        firsts["newton_iter"] = next(c for c in got.get("newton_iter", [])
                                     if c[1].get("mode", "iter") == "iter")
        if set(firsts) != {"chain_blocks_factor_lanes", "crown_blocks_factor", "newton_iter",
                           "chain_eval_df", "chain_apply_df"}:
            fail(f"family kernel checks: captured only {sorted(firsts)}")
        errs = {}
        for name, mod, rtol in (("chain_blocks_factor_lanes", ck, FACTOR_RTOL),
                                ("crown_blocks_factor", ckr, FACTOR_RTOL)):
            a, k = firsts[name]
            errs[name] = compare(torch, f"{name} (crane)", getattr(mod, name)(*a, **k),
                                 getattr(mod, name + "_ref")(*a, **k), rtol)
        a, k = firsts["newton_iter"]
        i_got, i_ref = ik.newton_iter(*a, **k), ik.newton_iter_ref(*a, **k)
        torch.cuda.synchronize()
        errs["newton_iter"] = compare(torch, "newton_iter(iter) (crane)", iter_outputs(i_got),
                                      iter_outputs(i_ref), SOLVE_RTOL)
        dch_, dcr_ = a[0], a[1]
        near_ = dict(
            qt=near_bound(torch, i_ref["xUnc"], dch_["xmin"], dch_["xmax"],
                          torch.ones_like(dch_["xmin"])),
            rt=near_bound(torch, i_ref["uUnc"], dch_["umin"], dch_["umax"],
                          torch.ones_like(dch_["umin"])),
            qtilde=near_bound(torch, i_ref["cxUnc"], dcr_["xmin"], dcr_["xmax"], dcr_["xm"]),
            rtilde=near_bound(torch, i_ref["cuUnc"], dcr_["umin"], dcr_["umax"], dcr_["um"]))
        exempt_ = compare_sets(torch, "newton_iter(iter) (crane)", i_got, i_ref, set_keys, near_)
        ekeys = ("x", "u", "qt", "rt", "xUnc", "uUnc", "res_part", "cqr", "fch")
        a, k = firsts["chain_eval_df"]
        errs["chain_eval_df"] = bit_exact(
            torch, "chain_eval_df (crane)", floats(dek.chain_eval_df(*a, **k), ekeys),
            floats(dek.chain_eval_df_ref(*a, **k), ekeys))
        akeys_ = ("xl", "ul", "res_part", "cqr")
        a, k = firsts["chain_apply_df"]
        errs["chain_apply_df"] = compare(
            torch, "chain_apply_df (crane)", floats(dek.chain_apply_df(*a, **k), akeys_),
            floats(dek.chain_apply_df_ref(*a, **k), akeys_), DF_RTOL)
        m_ = msf.meta
        print(f"crane kernels against their twins at its shapes (S={m_.S}, L={m_.L}, "
              f"nx={m_.nx}, nu={m_.nu}, crown {m_.crown_topo.Nn} nodes; chain_node_launch "
              f"{ck.chain_node_launch(m_.S, m_.L, m_.nx, m_.nu, 8)}): max |diff| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (FACTOR_RTOL, SOLVE_RTOL, bit for bit, DF_RTOL); newton_iter's active sets "
              f"equal ({exempt_} components exempt near a bound) on {card}")

    for fam in FAMILIES:
        model = family_model(fam)
        qf, msf = model.qp.to(dev), tm.split_multistage(model.qp).to(dev)
        mf = msf.meta
        print(f"{fam}{tuple(FAMILY_SHAPE.values())}: {qf.topo.Nn} nodes, S={mf.S} L={mf.L} "
              f"nx={mf.nx} nu={mf.nu}, crown {mf.crown_topo.Nn} nodes, x0 {model.x0.tolist()}")
        if (qf.topo.Nn, mf.S, mf.L) != (12117, 256, 46):
            fail(f"{fam}: not the reference grid's largest tree")
        if fam == "crane":
            family_checks(qf, msf)
        loop = drive(f"{fam} tdunes_ms", fam_ms_needs, lambda: family_ms_loop(
            torch, model, qf, msf, optsb, FAMILY_STEPS, f"{fam} tdunes_ms"))
        walls = {}
        for what, r in (("cold", loop[0]), ("warm", loop[-1])):
            walls[what] = profiled(torch, lambda: tm.tdunes_ms_solve(*r["args"], optsb))
        out_i, it_i, kkt_i, t_i = drive(
            f"{fam} ipm_ms", ipm_names, lambda: family_ipm(torch, qf, msf, opts_fam_ipm,
                                                           f"{fam} ipm_ms"),
            forbid=tdunes_names, ipm_path=True)
        out_s, it_s, kkt_s, t_s = drive(
            f"{fam} sdunes", sd_three, lambda: family_sdunes(torch, qf, out_i, opts_sd,
                                                             f"{fam} sdunes"),
            forbid=sd_forbid, sd_path=True)
        cold = loop[0]["out"]
        gaps = {f"{n} {f}": float((getattr(o, f) - getattr(cold, f)).abs().max())
                for n, o in (("ipm_ms", out_i), ("sdunes", out_s)) for f in ("x", "u")}
        if max(gaps.values()) > MPC_GAP:
            fail(f"{fam}: the three solvers disagree: {gaps}")
        line = (f"{fam} tdunes_ms at bench.py's options: cold iter {loop[0]['iter']} "
                f"({loop[0]['iter_f32']} coarse) {loop[0]['ms']:.1f} ms, closed-loop steps "
                + ", ".join(f"iter {r['iter']} ({r['iter_f32']} coarse) {r['ms']:.1f} ms"
                            for r in loop[1:])
                + f", KKT <= {max(r['kkt'] for r in loop):.2e}; profiled cold / warm: wall "
                f"{walls['cold'][0]:.1f} / {walls['warm'][0]:.1f} ms, device kernels "
                f"{walls['cold'][1]:.2f} / {walls['warm'][1]:.2f} ms (busy "
                f"{100 * walls['cold'][1] / walls['cold'][0]:.1f} / "
                f"{100 * walls['warm'][1] / walls['warm'][0]:.1f}%); launched "
                f"{ran(f'{fam} tdunes_ms')}; "
                f"ipm_ms iter {it_i} KKT {kkt_i:.2e} {t_i:.1f} ms, launched "
                f"{ran(f'{fam} ipm_ms')}; sdunes warm from the IPM's duals iter {it_s} "
                f"KKT {kkt_s:.2e} {t_s:.1f} ms, launched {ran(f'{fam} sdunes')}; against the "
                f"cold tdunes_ms solve " + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps.items())
                + f" on {card}")
        print(line)
    print(f"section 14 (slice 26): {time.perf_counter() - t_slice26:.1f} s on {card}")

    # ---- 15. the reference's largest linear chain: LC8 at the
    # reference grid's largest tree, nz = 23, through every solver: the
    # multistage IPM on the chain Riccati kernels' 32-lane instantiation, the
    # tree IPM on the crown Riccati kernels' (no plain twin may run on
    # either), tdunes_ms cold and along the closed loop (the crown's groups
    # 4 x 16 = 64 rows wide), sdunes warm from the IPM; then the five
    # Riccati kernels against their twins and timed at the instance's shapes
    t_lc8 = time.perf_counter()
    from treeqp_tpu_torch import models as tmodels
    lc8 = tmodels.linear_chain(**LC8, device="cpu")
    ql8, ms8 = lc8.qp.to(dev), tm.split_multistage(lc8.qp).to(dev)
    m8 = ms8.meta
    prep8 = td._get_prep(m8.crown_topo)
    G8 = ckr._get_sched(prep8).G
    print(f"linear_chain{tuple(LC8.values())}: {ql8.topo.Nn} nodes, S={m8.S} L={m8.L} "
          f"nx={m8.nx} nu={m8.nu} (nz={m8.nx + m8.nu}), crown {m8.crown_topo.Nn} nodes of "
          f"groups G={G8} (crown_solve_core on one block past 32), iter_supported "
          f"{ik.iter_supported(prep8, m8, optsb)}, chain_eval_df launch "
          f"{ck.chain_node_launch(m8.S, m8.L, m8.nx, m8.nu, 8)}, chain_apply_df launch "
          f"{ck.chain_node_launch(m8.S, m8.L, m8.nx, m8.nu, 8, apply=True)} (chains, blocks, "
          f"threads, staged, shared bytes)")
    if (ql8.topo.Nn, m8.S, m8.L, m8.nx, m8.nu, m8.crown_topo.Nn) != (12117, 256, 46, 16, 7, 341):
        fail("linear_chain(nm=8, nu_count=7): not the reference's largest linear chain on the "
             "reference grid's largest tree")
    if not ik.iter_supported(prep8, m8, optsb):
        fail("linear_chain(nm=8, nu_count=7): the fused iteration does not apply")
    twin_fns = ((rk, ("ric_chain_factor_ref", "ric_chain_bwd_ref", "ric_chain_fwd_ref")),
                (crk, ("crown_ric_factor_ref", "crown_ric_solve_ref")))

    def no_twins(what, fn):
        """fn() with the five Riccati twins recording their calls (capture);
        fails if any ran."""
        calls, res = capture(twin_fns, fn)
        if calls:
            fail(f"{what}: plain Riccati twins ran: { {n: len(c) for n, c in calls.items()} }")
        return res

    loop8 = drive("lc8 tdunes_ms", fam_ms_needs, lambda: family_ms_loop(
        torch, lc8, ql8, ms8, optsb, FAMILY_STEPS, "lc8 tdunes_ms"))
    walls8 = {what: profiled(torch, lambda r=r: tm.tdunes_ms_solve(*r["args"], optsb))
              for what, r in (("cold", loop8[0]), ("warm", loop8[-1]))}
    ipm8 = {}
    for key, ms_arg, needs, forbid in (
            ("ipm_ms", ms8, ipm_names, tdunes_names),
            ("ipm", None, ipm_names[3:], tdunes_names + ipm_names[:3])):
        ipm8[key] = drive(f"lc8 {key}", needs, lambda ms_arg=ms_arg, key=key: no_twins(
            f"lc8 {key}", lambda: family_ipm(torch, ql8, ms_arg, opts_fam_ipm, f"lc8 {key}")),
            forbid=forbid, ipm_path=True)
        ipm8[key] = ipm8[key] + (profiled(torch, lambda ms_arg=ms_arg: family_ipm(
            torch, ql8, ms_arg, opts_fam_ipm, f"lc8 {key} (profiled)")),)
    # sdunes' Jay blocks are Nr nu = 28 wide here, past jay_cr_solve's 16:
    # the plain cyclic reduction (ops/tridiag.py) solves them, as the JAX
    # package's XLA one does past its kernel's 8, and the kernel may not run
    jay8 = jk.jay_supported(m8.S - 1, LC8["Nr"] * m8.nu)
    sd8 = drive("lc8 sdunes", sd_three if jay8 else sd_three[:2], lambda: family_sdunes(
        torch, ql8, ipm8["ipm_ms"][0], opts_sd, "lc8 sdunes"),
        forbid=sd_forbid + (() if jay8 else ("jay_cr_solve",)), sd_path=True)
    cold8 = loop8[0]["out"]
    gaps8 = {f"{n} {f}": float((getattr(o, f) - getattr(cold8, f)).abs().max())
             for n, o in (("ipm_ms", ipm8["ipm_ms"][0]), ("ipm", ipm8["ipm"][0]),
                          ("sdunes", sd8[0])) for f in ("x", "u")}
    if max(gaps8.values()) > MPC_GAP:
        fail(f"linear_chain(nm=8, nu_count=7): the four solvers disagree: {gaps8}")
    print(f"lc8 tdunes_ms at bench.py's options: cold iter {loop8[0]['iter']} "
          f"({loop8[0]['iter_f32']} coarse) {loop8[0]['ms']:.1f} ms, closed-loop steps "
          + ", ".join(f"iter {r['iter']} ({r['iter_f32']} coarse) {r['ms']:.1f} ms"
                      for r in loop8[1:])
          + f", KKT <= {max(r['kkt'] for r in loop8):.2e}; profiled cold / warm: wall "
          f"{walls8['cold'][0]:.1f} / {walls8['warm'][0]:.1f} ms, device kernels "
          f"{walls8['cold'][1]:.2f} / {walls8['warm'][1]:.2f} ms ({walls8['cold'][2]} / "
          f"{walls8['warm'][2]} launches); launched {ran('lc8 tdunes_ms')} on {card}")
    for key, (out_, it_, kkt_, t_, prof_) in ipm8.items():
        print(f"lc8 {key} at IPM_OPTS['box']: iter {it_} ({out_.info['iter_f32']} f32), KKT "
              f"{kkt_:.2e}, {t_:.1f} ms; profiled: wall {prof_[0]:.1f} ms, device kernels "
              f"{prof_[1]:.2f} ms ({prof_[2]} launches); launched {ran(f'lc8 {key}')}; no "
              f"plain Riccati twin ran on {card}")
    print(f"lc8 sdunes warm from the IPM's duals: iter {sd8[1]} KKT {sd8[2]:.2e} "
          f"{sd8[3]:.1f} ms, launched {ran('lc8 sdunes')} (Jay blocks of "
          f"{LC8['Nr'] * m8.nu}: jay_cr_solve {'taken' if jay8 else 'past its 16'}); against "
          f"the cold tdunes_ms solve "
          + ", ".join(f"|d{k}| {v:.2e}" for k, v in gaps8.items()) + f" on {card}")

    # the five Riccati kernels on the operands of their first f32 iteration
    # on this tree: the chain kernels and the crown kernels on the 341-node
    # crown (ipm_ms), the crown kernels on the whole 12117-node tree (ipm)
    one8 = ipm.IpmOpts(**{**IPM_OPTS["box"], "max_iter": 1})
    got8 = {}
    for key, fn in (("ipm_ms", lambda: ims.ipm_ms_solve(ms8, one8)),
                    ("ipm", lambda: ipm.ipm_solve(ql8, one8))):
        calls8, _ = capture(((rk, ipm_names[:3]), (crk, ipm_names[3:])), fn)
        got8[key] = {n: c[0] for n, c in calls8.items()}
    (hb8, AB8), kw8 = got8["ipm_ms"]["ric_chain_factor"]
    reg8 = kw8.get("reg", 0.0)
    (fact8, rg8, rb8), _ = got8["ipm_ms"]["ric_chain_bwd"]
    (_, p8, k8, rbf8, zr8), _ = got8["ipm_ms"]["ric_chain_fwd"]
    rg8, rb8, rbf8, zr8 = (v.to(f32).contiguous() for v in (rg8, rb8, rbf8, zr8))
    S8, L8, nx8, nz8 = AB8.shape
    lib8 = {}
    _, _, info8, err8 = ric_chain_ldl(torch, hb8, AB8, reg8, rg8, rb8, zr8, first_ms=lib8)
    rows8 = [("ric_chain_factor", lambda: rk.ric_chain_factor(hb8, AB8, **kw8),
              lambda: rk.ric_chain_factor_ref(hb8, AB8, **kw8), FACTOR_RTOL, (hb8, AB8),
              S8 * L8 * stage_ops(nx8, nz8, "factor"), lib8["factor"],
              f"ldl_factor_ex of the {S8} chains' [{L8 * (nx8 + nz8)}]^2 KKT matrices, info "
              f"max {info8}"),
             ("ric_chain_bwd", lambda: rk.ric_chain_bwd(fact8, rg8, rb8),
              lambda: rk.ric_chain_bwd_ref(fact8, rg8, rb8), SOLVE_RTOL,
              ([fact8[k] for k in ("P", "Luu", "Mxu", "AB")], rg8, rb8),
              S8 * L8 * stage_ops(nx8, nz8, "bwd"), lib8["solve"],
              f"ldl_solve with its factors, for bwd + fwd, |diff| to the twins {err8:.3e}"),
             ("ric_chain_fwd", lambda: rk.ric_chain_fwd(fact8, p8, k8, rbf8, zr8),
              lambda: rk.ric_chain_fwd_ref(fact8, p8, k8, rbf8, zr8), SOLVE_RTOL,
              ([fact8[k] for k in ("P", "K", "AB")], p8, k8, rbf8, zr8),
              S8 * L8 * stage_ops(nx8, nz8, "fwd"), lib8["solve"],
              "ldl_solve with its factors, for bwd + fwd")]
    for key in ("ipm_ms", "ipm"):
        (hbc, ABc, W0c, prepc, nxc), kwc = got8[key]["crown_ric_factor"]
        (factc, rgc, rbc, w0c, _), _ = got8[key]["crown_ric_solve"]
        rgc, rbc, w0c = (v.to(f32).contiguous() for v in (rgc, rbc, w0c))
        schedc = crk._get_sched(prepc)
        Ncc, nzc = hbc.shape
        lib_fc = lib_sc = None
        lib_note = (f"none: the dense KKT matrix of {Ncc} nodes would hold "
                    f"{(Ncc * nzc + (Ncc - 1) * nxc) ** 2 * 4 / 1e9:.0f} GB")
        if key == "ipm_ms":
            M_c = ric_crown_matrix(torch, hbc, ABc, W0c, prepc, nxc, kwc.get("reg", 0.0))
            LD_c, piv_c, info_c8 = torch.linalg.ldl_factor_ex(M_c)
            v_c = ric_crown_vector(torch, rgc, rbc, w0c)
            lib_fc = cuda_ms(torch, lambda: torch.linalg.ldl_factor_ex(M_c), 1)
            lib_sc = cuda_ms(torch, lambda: torch.linalg.ldl_solve(LD_c, piv_c, v_c), 1)
            lib_note = (f"ldl_factor_ex / ldl_solve of the [{M_c.shape[0]}]^2 KKT matrix, "
                        f"info {int(info_c8)}")
            del M_c, LD_c
        where = f"{key}: {Ncc} nodes, {schedc.n_ph} phases of runs, launch " \
                f"{crk._ric_launch(schedc, nzc)}"
        rows8 += [
            ("crown_ric_factor", lambda a=(hbc, ABc, W0c, prepc, nxc), k=kwc:
             crk.crown_ric_factor(*a, **k),
             lambda a=(hbc, ABc, W0c, prepc, nxc), k=kwc: crk.crown_ric_factor_ref(*a, **k),
             FACTOR_RTOL, (hbc, ABc, W0c, [schedc.on(dev)[q] for q in (
                 "kid_ptr", "kid_idx", "ph_ptr", "run_ptr", "run_node")]),
             Ncc * (stage_ops(nxc, nzc, "factor") + nzc * nzc), lib_fc, f"{where}; {lib_note}"),
            ("crown_ric_solve", lambda a=(factc, rgc, rbc, w0c, prepc):
             crk.crown_ric_solve(*a),
             lambda a=(factc, rgc, rbc, w0c, prepc): crk.crown_ric_solve_ref(*a),
             SOLVE_RTOL, ([factc[q] for q in ("P", "Luu", "K", "Mxu", "AB")], rgc, rbc, w0c,
                          [schedc.on(dev)[q] for q in ("kid_ptr", "kid_idx", "par", "ph_ptr",
                                                       "run_ptr", "run_node")]),
             Ncc * (stage_ops(nxc, nzc, "bwd") + stage_ops(nxc, nzc, "fwd") + nzc)
             + chol_ops(nxc) + 4 * nxc * nxc, lib_sc, f"{where}; {lib_note}")]
    pick8 = lambda r: ([r[0][q] for q in ("P", "Luu", "K", "Mxu")] + list(r[1:])
                       if isinstance(r, tuple) and isinstance(r[0], dict) else
                       [r[q] for q in ("P", "Luu", "K", "Mxu")] if isinstance(r, dict) else r)
    for name, fn, ref_fn, rtol, inputs, ops_, lib_t, note in rows8:
        err_ = compare(torch, f"{name} (lc8, nz={nz8})", pick8(fn()), pick8(ref_fn()), rtol)
        t_alone, t_graph = cuda_ms(torch, fn, 20), graph_ms(torch, fn)
        t_plain = cuda_ms(torch, ref_fn, 2)
        moved = nbytes(torch, inputs, fn())
        t_bytes, t_ops = moved / PEAK_BYTES, ops_ / PEAK_FLOPS[False]
        lib_s = "none" if lib_t is None else f"{lib_t:.4f} ms alone"
        print(f"{name} at nz={nz8} (lc8; {note}): {t_alone:.4f} ms alone, {t_graph:.4f} ms in "
              f"a CUDA graph, plain twin {t_plain:.4f} ms, bound "
              f"{max(t_bytes, t_ops) * 1e3:.6f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}: {moved} B, {ops_:.4g} FP32 "
              f"ops), library call {lib_s}, max |diff| to the twin "
              f"{err_:.3e}, launches on the lc8 paths "
              f"{sum(paths[p_][name] for p_ in paths if p_.startswith('lc8'))} on {card}")
    print(f"section 15 (the largest linear chain): {time.perf_counter() - t_lc8:.1f} s on {card}")

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          f"(build {t_build:.1f} s) on {card}")
    for r in results:
        r["launches"] = sum(p[r["name"]] for p in paths.values())
        del r["shapes"]
        if r["launches"] <= 0:
            fail(f"{r['name']} was not launched by any main path")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
