#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--n N] [--path-n N] [--m M]
                          [--fit-ntoa N] [--fit-ndmx K] [--stream-ntoa N]
                          [--pta-ntoa N] [--pta-nfreq F] [--baseline-src CU]

Phases, each fatal on failure:

1. build the z2_harmonics CUDA kernel with nvcc (into build/) and print
   ptxas's registers and spills for every instantiation (a spill fails);
2. hold the kernel against its plain PyTorch version on the card, in
   float32 and float64, at N in {1, 1000, 8209, N} and m in {1, 2, 20,
   32, 33, 129}, with rtol 5e-4 and atol 5e-3*sqrt(N); float64 and mixed
   float32/float64 inputs (and a misaligned slice) must give bitwise the
   result of the kernel on the inputs cast to float32, two launches
   must be bitwise equal, zero-weight rows at the ragged edge must be
   inert, and the error against the float64 plain version at the main
   shape must be at most 0.05;
3. the double-double phase on the GPU must equal the port's CPU phase on
   the first 65,536 photons (integer part exactly, fraction to 1e-11);
4. run the photonphase path end to end on the GPU through the port's CLI
   (par file -> barycentred FITS events -> double-double phase -> weighted
   H-test) at --path-n photons (default 1,048,576) and m harmonics
   (default 20), from a seeded, J0030+0451-like isolated millisecond
   pulsar: the phases must cluster at the injected peak, H must agree
   with H from the float64 plain version, and the kernel must have been
   launched;
5. time the kernel with float32 inputs (the TPU kernel's contract) and
   with float64 inputs (what the H-test hands it), the two float32 casts
   the float64 read saves, and the plain version, each launch between
   its own CUDA events with the L2 flushed before it and the device
   held asleep while the host enqueues them (see cuda_ms); with
   --baseline-src, also a kernel built from that source with the
   earlier, float32-only launch signature, timed the same way;
6. the GLS timing fit (the main path; it runs no hand-written kernel):
   fit-build: bench.build_problem()'s model and TOAs (10,000 TOAs, 40
     free parameters + Offset, 30 red-noise Fourier modes, ECORR on
     2,500 four-TOA epochs; the recipe copied here) built by the port;
   fit-step: the fit step on the GPU against the same step on the CPU
     (dparams within 1e-6 sigma, cov diagonal within 1e-8 relative,
     chi2 within 1e-10 relative, residuals within 1e-12 s), two GPU
     steps bitwise equal; the step with the reference's hybrid Jacobian
     split (hybrid_jac=True: closed-form columns for the linear
     parameters) against it on the GPU, to the same limits;
   fit-time: 20 GPU steps on the host clock and between CUDA events,
     and one torch.profiler window (device-busy share, launches per
     step, device time by stage and by operation), for the step and
     for the hybrid step;
   fit-downhill: DownhillGLSFitter to convergence on the GPU and on the
     CPU, the same optimum (parameters within 1e-6 sigma, chi2 within
     1e-10 relative plus the change the residual difference explains);
   pintempo: the CLI on tests/datafile/NGC6440E.{par,tim} on the GPU
     and on the CPU, the same fitted F0 (1e-6 sigma), within 3 sigma of
     the par file's;
7. the binary path (it runs no hand-written kernel either):
   binary-build: BASELINE config 2 (bench.config2_b1855like, recipe
     copied): a B1855+09-like ELL1 binary, 5,000 TOAs in four-TOA
     clusters at 1400/430 MHz, 26 free parameters (astrometry, F0/F1,
     the orbit, 12 DMX), EFAC/EQUAD/ECORR, 20 red-noise modes, simulated
     by the port from seed 2;
   binary-step: as fit-step and fit-time, on that model; then the same
     checks and timings for its DD twin (the orbit as DD: kepler_E in the
     step);
   binary-downhill: DownhillGLSFitter from PB, A1, TASC and EPS1 moved
     3 sigma, on the GPU and the CPU (fit-downhill's limits), every
     fitted parameter within 3 sigma of the simulated truth;
   binary-zoo: each of the 10 binary models on a J1012+5307-like par at
     10,000 TOAs: GPU delay vs CPU within 1e-12 s, GPU design matrix
     vs CPU within 1e-10 of each column's largest entry;
   fullcov: BASELINE config 4 (bench.config4_j0613like_fullcov, 2,000
     TOAs, 15 red-noise modes, seed 4): the dense full-covariance solve
     on the GPU against the CPU's (1e-8) and against the GPU Woodbury
     solve (rtol 1e-6), both timed as cuda_ms times the kernel;
8. the wideband path (no hand-written kernel either):
   wideband-config3: BASELINE config 3 (bench.config3_j1713like_wideband,
     recipe copied), a J1713+0747-like ELL1 binary, 2,000 TOAs at
     1400/2100 MHz over MJD 53000-56000, 10 free DMX windows, DMEFAC and
     DMEQUAD on backend X, -pp_dm measurements (sigma 1e-4) drawn from
     default_rng(3) after the MJDs, F0 moved by 5e-11 Hz: the stacked
     [time; DM] step (build_fit_step(wideband=True)) on the GPU against
     the CPU (fit-step's limits, chi2 held as the binary steps hold it),
     two GPU steps bitwise equal, the hybrid step against it, timed and
     profiled as fit-time (the DM rows' jacfwd is the
     fit_step.dm_jacobian span); then the model's par and the TOAs as a
     .tim, read back by get_model_and_toas (on the default device, the
     GPU, and on the CPU), Fitter.auto's WidebandDownhillFitter to
     convergence on each, one optimum;
   wideband-twin: the fit path's problem (10,000 TOAs, ECORR on 2,500
     epochs, 30 red-noise modes) plus DMEFAC/DMEQUAD, a free DMJUMP, FD1
     and an FD jump free, PLDMNoise (30 modes) and -pp_dm measurements
     drawn from the model DM and the scaled sigma (2e-4, default_rng(17),
     bench_stress.attach_wideband_dm): its step on the GPU against the
     CPU, timed and profiled;
   dd-sum: ops.dd.dd_sum on the card, on tests/test_torch_dd.py's 400
     values of +-1e10 and on 1,048,576 such values, within 1e-28 of
     sum |x| of the exact sum;
9. the device downhill fit and the streaming GLS (no hand-written kernel
   either):
   nu-inf: tests/datafile/NGC6440E.par without its TZRFRQ line (the TZR
     TOA at an infinite frequency) with NGC6440E.tim: the design matrix on
     the GPU is finite and Fitter.auto's fit on the GPU reaches the CPU
     fit's F0 (1e-6 sigma);
   device-fit: BASELINE's stress problem (bench_stress.build_stress_
     problem, recipe copied): 10,000 TOAs in four-TOA clusters over 5
     receivers with their own EFAC/EQUAD/ECORR, JUMPs and FD jumps, an
     ELL1 binary, 100 DMX, 30 red-noise and 30 DM-noise modes, 124 free
     parameters, F0 moved 3e-11 Hz and JUMP1 2e-7 s; after a warm-up fit
     on a copy, DeviceDownhillGLSFitter.fit_toas(maxiter=12) one step a
     trial and with whole_fit=True, each against DownhillGLSFitter on the
     GPU (parameters within 1e-6 sigma, chi2 within 1e-6 relative of the
     step's chi2 at the host optimum), F0 within 5 sigma of the truth;
   device-fit-wideband: the same without DM noise and with bench_stress.
     attach_wideband_dm's DM measurements, DeviceDownhillGLSFitter(
     wideband=True) against WidebandDownhillFitter, the same limits;
   graph-step: the fit cell's step and config 3's wideband step each
     captured into a torch.cuda.CUDAGraph ((th, tl) copied into static
     buffers before each replay): replayed outputs bitwise equal to the
     eager step's at the entry point and one step on; replay and eager
     step timed on the host clock and between CUDA events;
   stream-ecorr: the fit cell streamed in chunks of 4,096 (boundaries
     between epochs) and of 4,094 (boundaries inside epochs): each pass
     on the GPU against the dense GPU step and against the same pass on
     the CPU (1e-6 sigma, chi2 1e-8 relative);
   stream: bench.build_problem_streaming's model (no ECORR, 15 red-noise
     modes, 28 DMX) at --stream-ntoa TOAs (default 200,000, where
     Fitter.auto streams on its own): Fitter.auto's StreamingGLSFitter on
     the GPU, one accumulate + solve pass in chunks of
     config.stream_chunk(N) timed twice, held to the dense GPU step
     (1e-6 sigma, chi2 1e-8 relative, CG ok; bench.py:1520's limits), the
     peak device memory of each, then a fit to convergence;
10. the pulsar array (no hand-written kernel either):
   pta-build: BASELINE config 5 (bench_pta.build_pulsar, recipe copied):
     67 pulsars of --pta-ntoa TOAs (default 100) over MJD 54000-56000, a
     third of them ELL1 binaries, F0 moved 1e-10 Hz, simulated by the
     port; each pulsar's linearized problem built on the GPU;
   pta-solve: the stacked batch's pta_solve on the GPU against the CPU
     and against pta_solve_np (dparams 1e-8 relative, atol 1e-15; cov
     diagonal, chi2 and chi2r 1e-8; tests/test_pta.py:93's limits), two
     GPU solves bitwise equal, timed between CUDA events;
   pta-noise: tests/test_pta.py's trio (an EFAC/ECORR pulsar on
     clustered TOAs among them), the same checks;
   pta-fit: fit_pta(maxiter=2) on the GPU, F0 within 5 sigma of the
     truth for every pulsar; its wall, device solve and build_problem
     seconds and TOAs/s;
   gwb: GWBLikelihood over the 67 problems at --pta-nfreq frequencies
     (default 14): the blocks against gwb_blocks_np and bench_pta.py's 8 x
     8 (log10 A, gamma) grid against the numpy outer stage, within 1e-9
     relative (tests/test_gwb.py:235), log L spread over the grid > 1;
     block assembly, sweep and one chunk timed, peak device memory;
   posterior: sample_problems over the 67 problems, 32 walkers, 600
     steps, seed k for pulsar k: after 200 steps every chain's mean within
     0.5 sigma of the GLS dparams, std ratio in (0.5, 2), acceptance in
     (0.1, 0.95) (tests/test_sampling.py:387's limits); chunk=16
     bitwise the default chunking;
11. the rest of the timing-model zoo (no hand-written kernel but K1
   either):
   zoo-msp: a NANOGrav-15-yr-style J1713+0747-like DD binary (ZOO_MSP_PAR),
     10,000 TOAs in four-TOA clusters over MJD 53000-59000 rotating over
     five receivers at gbt (820/1400 MHz) and arecibo (430/1400/2300 MHz),
     EFAC/EQUAD/ECORR per receiver, red (30 modes), chromatic (30,
     TNCHROMIDX 4 frozen) and solar-wind (10) noise, the troposphere,
     NE_SW free, 16 SWX windows about the solar conjunctions, DMWaveX at
     40 and CMWaveX at 20 frequencies, CM/CM1, FD1-FD3, a JUMP per
     receiver but one: 159 free parameters, simulated from seed 11; the
     step on the GPU against the CPU and the hybrid step against it
     (fit-step's limits, chi2 held as the binary steps hold it), timed
     and profiled as fit-time, then DownhillGLSFitter from F0, PB, A1,
     NE_SW and CM 3 sigma off on the GPU and the CPU (fit-downhill's
     limits), every parameter within 5 sigma of the truth;
   zoo-msp-wb: BASELINE config 3 (wideband-config3's build) plus 8 SWX
     windows and DMWaveX at 10 frequencies, without and then with NE_SW
     free: each stacked step on the GPU against the CPU, timed and
     profiled (the fit_step.dm_jacobian span before and after
     astrometry's tangents join the DM rows), the model DM on the GPU
     against the CPU's within 1e-12 pc/cm^3;
   zoo-young: a Vela-like glitching pulsar, 3,000 parkes TOAs at 1400
     and 3100 MHz over MJD 55000-59000, two glitches, a spindown piece,
     WaveX at 30 frequencies (k/T, k = 25..54), four CMX windows,
     EFAC/EQUAD (81 free): as
     zoo-msp, from F0, F1, GLF0_1 and GLPH_2 3 sigma off;
   zoo-photon: --path-n barycentred photons drawn pulsed (the J0030
     path's profile) under a glitch + WAVE1-WAVE10 + 40-node IFUNC
     ephemeris of that pulsar, written as FITS events: the GPU phase
     against the CPU's as in 3, photonphase on the GPU through the
     kernel as in 4, and H at least half the J0030 path's;
   zoo-sweep: each of the 14 zoo components alone on the fit path's
     pulsar at 10,000 gbt/arecibo TOAs, then SWM 1 with SWP free, then
     DMWaveX + NE_SW + SWX without TZRFRQ with every tenth TOA
     barycentred: GPU delay vs CPU within 1e-12 s, phase with equal pulse
     numbers and fractions within F0 x 1e-12 s, design matrix finite and
     within 1e-10 of each column's largest entry;
12. the Bayesian path on the fit cell (no hand-written kernel either;
   K1's launches on it are read and must stay 0):
   bayes-batch: BayesianTiming.lnlikelihood_batch at 88 walker points
     (init_walkers, default_rng(7), the parameters' uncertainties the fit
     step's sigmas) on the GPU against the CPU's and against three scalar
     calls, 1e-10 relative;
   bayes-noise: SampledNoiseLikelihood (ECORR1.log10, PLRedNoise.log10_A,
     .gamma) at eta0 against the fixed-noise BayesianTiming, at eta0 +
     (0.1, 0.3, -0.4) against a BayesianTiming rebuilt there, 1e-9;
   bayes-chain: DeviceEnsembleSampler over the 43 dimensions, 88 walkers,
     32 steps: scan and host_loop bitwise equal;
   bayes-time: MCMCFitter(sample_noise=True), a chain of 64 steps timed
     (steps/s, walker-steps/s, peak device memory), the launches of one
     lnpost_batch of 44 walkers and a profiled chain step (device busy,
     idle share);
   bayes-moments: tests/test_sampling.py's 60-TOA pulsar simulated and
     WLS-fitted on the GPU, 32 walkers x 600 steps: after 200 the F0/F1
     means within 0.5 sigma of the fit, std ratios in (0.5, 2),
     acceptance in (0.1, 0.95);
   bayes-grid: grid_chisq over (F0, F1), 8 x 8 nodes at +-3.5 sigma about
     the fit, maxiter 2, in chunks of config.grid_chunk nodes: minimum at
     the node nearest the fit, four nodes against the CPU within
     chi2_tol, its wall, chunk and peak device memory;
13. photon sampling on --path-n photons of the photon path's recipe,
   each moved by one Newton step onto PAR's own phase (the model delays
   barycentred photons by the Sun's Shapiro delay, which the recipe's
   spin-down leaves out), PAR with F0 and F1 free; K1's launches are
   read for each check, and must be 2 in event-optimize, 1 in each run
   of fermiphase, 0 elsewhere:
   photon-templates: each of the 7 primitives, a three-primitive mixed
     template and an LCEnergyTemplate with nonzero slopes, the pdf on the
     card against the CPU at the path's phases (energies log-uniform over
     0.1-10 keV) within 1e-12 of its largest value; LCTemplate.random on
     the card gives the CPU's draws;
   photon-lcfit: LCFitter from event_optimize's seed template on the
     first 262,144 photons (background logit held), card vs CPU: logL
     1e-9 relative, theta within 1e-2 of its Hessian error, the loc's and
     width's theta_err 1e-4 relative; at full width on the card the
     peak's loc within 3 errors of 0.3 and its width within 20 % of 0.01
     (iterations, wall, ms a value-and-gradient call); LCEnergyFitter
     card vs CPU on 65,536 photons (logL 1e-9, theta 1e-2 of its Hessian
     errors, the logits relative to the background's);
   photon-batch: PhotonMCMCFitter._photon_lnlike_batch at 16 walker
     points, card vs CPU on the first 65,536 photons within 1e-9
     relative, the vmapped device core bitwise the host _lp_batch at full
     width; one half-ensemble timed, profiled (launches, busy ms, idle
     share) and its peak device memory;
   photon-chain: scan and host_loop bitwise over 16 steps of 32 walkers;
     F1 frozen, F0 started 3 sigma off (sigma from the curvature of the
     photon log-likelihood on the card), 32 walkers x 200 steps from a 1
     sigma spread: the median within 5 sigma of the truth, acceptance in
     (0.1, 0.95) (steps/s, walker-steps/s);
   event-optimize: the CLI at full width on the card (32 walkers x 100
     steps): return code 0, a (100, 32, 2) chain, a par file get_model
     reads, both H values within phase 4's limit of the float64 plain H
     (ingest, template, MCMC and H-test seconds);
   composite: CompositeMCMCFitter on 500 gbt 1400 MHz TOAs simulated by
     the port plus the first 262,144 photons, F0 free, 8 walkers x 60
     steps (tests/test_mcmc.py:188's shape): _lp_batch card vs CPU at 8
     points within 1e-9 relative, F0 within 5 of its errors of the truth;
   fermiphase: a Fermi-LAT-like barycentred FT1 file of 262,144 photons
     (Fermi's MJDREF, TELESCOP GLAST, MODEL_WEIGHT): fermiphase and
     photonphase --mission fermi --weightcol MODEL_WEIGHT give bitwise
     the same phases and H, within phase 4's limit of the plain H;
   toa-io: get_TOAs(NGC6440E.tim, usecache=True) twice on the card, the
     second from the cache, bitwise the same batch; write_TOA_file read
     back within 1e-16 d of the TDBs;
14. the dispatch runtime (pint_tpu_torch.runtime) on the fit cell at full
   width; after each earlier phase the global supervisor's snapshot is
   printed, and any failover, timeout, breaker rejection or lost device
   there fails the smoke (g):
   runtime-hang (a): Fault(match="gls.fit", kind="hang") of RT_HANG_S
     against a RT_DEADLINE_S deadline on that key, into
     DeviceDownhillGLSFitter on the card: the fit fails over to
     DownhillGLSFitter on the CPU, bitwise fit-downhill's CPU fit (chi2,
     values, uncertainties, covariance), in less wall than the hang,
     with timeouts, failovers and abandoned workers counted;
   runtime-sticky (b): a child process (this script, --sticky-child)
     fits the same cell with DeviceDownhillGLSFitter on the card, its
     first gls.fit_step dispatch triggering a real device-side assert (an
     out-of-range CUDA index read with .item()): the fit finishes on the
     CPU bitwise fit-downhill's CPU fit, the cuda:0 breaker is latched
     LOST, a later dispatch on the card short-circuits without calling
     its function (cooldown 0), and the counters label the episode;
   runtime-breaker (c): two injected transient errors at gls.solve are
     retried and the solve equals the unfaulted one bitwise; errors past
     breaker_threshold trip the breaker, a flight dump is written, the
     solve fails over to the numpy mirror of the CPU pass (bitwise), a
     later dispatch short-circuits to its fallback and Fitter.auto gives
     the host fitter on a CPU model;
   runtime-nan (d): Fault(match="gls.fit", kind="nan"): the device fit
     fails over to DownhillGLSFitter on the card, bitwise fit-downhill's
     GPU fit;
   runtime-gwb (e): config 5's GWB likelihood on the card, every sweep
     chunk after the first hanging: each completes by the numpy mirror,
     the sweep within 1e-9 of the CPU sweep, labelled host-failover;
   runtime-chain (e): the bayes-moments pulsar's chain (32 x 200, chunks
     of RT_CHAIN_CHUNK) on the card with every chunk from chunk 2 on
     failing: it continues on the CPU posterior from the carried state,
     and its positions equal an all-CPU chain's bitwise;
   runtime-cost (f): the fit step, a Bayesian chain step and a photon
     half-ensemble each supervised and with guard=False: median ms,
     launches (device kernels, equal in both) and idle share; whether the
     profiler sees the fit_step.* spans of a guarded step;
   runtime-deadlines: each dispatch key's largest wall against its
     deadline on the card, and the measured CUDA round trip;
   runtime-crossover: WLS and GLS solves (one supervised pass each) on
     the card and on the CPU at 62 (NGC6440E), 1,000 and 10,000 TOAs;
   config3-16-digit: BASELINE config 3 written by TOAs.write_TOA_file (16
     digits of the day fraction), fitted by Fitter.auto on the card and
     on the CPU with every downhill decision logged (proposed step,
     trial chi2, accepted halving): the first decision that differs, and
     the largest difference of one step in sigma;
15. the host API of the core classes, polycos, UNITS TCB, binaryconvert
   and the native MJD parser (no hand-written kernel: K1 launches 0
   times here):
   polycos-binary: one day of polycos at gbt (60-minute blocks, 12
     coefficients, 1400 MHz: 24 blocks, 576 nodes in one phase call on
     the card) from BASELINE config 2's ELL1 model: the polyco phase at
     200 seeded epochs against model.phase on the card (1e-6 turns mod
     1, tests/test_polycos.py's folding limit), eval_spin_freq against
     d_phase_d_toa on the card (1e-9 relative), the coefficients against
     the same generation on the CPU (1e-6 turns at the block edge), the
     TEMPO file read back (5e-6 turns); one generation profiled;
   polycos-fit: the same on the fit cell's isolated model;
   host-api: on the fit cell, d_phase_d_toa on the card against the CPU
     (1e-12 relative), timed and profiled; d_phase_d_param of F0, F1
     and DMX_0001 against F0 x the card's design columns (1e-13 of the
     column); every other epoch selected, pulse-numbered and fitted by
     DownhillGLSFitter(track_mode="use_pulse_numbers") on the card and
     on the CPU (fit-downhill's limits); ecorr_average over the 2,500
     ECORR epochs, card against CPU; as_ECL -> as_ICRS keeping the
     card's phase (2e-9 s); calculate_random_models(100) after the
     card's fit, card against CPU on the same fitted state and generator
     (1e-12 s), timed;
   tcb: the fit cell written as UNITS TCB and read back by get_model
     (converted by default): its phase on the card against the
     original's, within what test_tcb_conversion_roundtrip's F0 limit
     allows over the span; allow_tcb=False raises;
   binaryconvert: config 2's ELL1 model to ELL1H, DD, DDS and DDH: each
     converted model's delay on the card against the CPU's (1e-12 s)
     and, less the means, against the ELL1 model's (1e-12 s for ELL1H,
     tests/test_binary_zoo.py's 2e-9 s scaled by this orbit's x e^2 for
     the eccentric ones);
   mjdparse: the native parser builds, and parses the fit cell's .tim
     (written by TOAs.write_TOA_file) bitwise as the Python parser does,
     both timed;
   its `host_api` JSON line holds the times, errors and counts;
16. the numerical-health, performance-attribution and SLO planes and TOA
   padding (no hand-written kernel: K1's analytic cost feeds the perf
   plane's roofline only), each fatal, on phases 6, 9 and 12's problems
   at full width, with $PINT_TPU_HEALTH=1, $PINT_TPU_SHADOW_RATE=1 and
   $PINT_TPU_PERF=1 (the compile ledger is persisted from the start of
   the run, so it holds every phase's dispatch keys):
   health-taps (a): the fit cell's step built with health=True and with
     it off: outputs 0-3 bitwise, the health vector the host's own
     reductions of the outputs (nonfinite 0; max |r|/sigma and chi2
     within 1e-12 relative), the disarmed step FIT_STEP_LAUNCHES (1,849)
     launches, the armed step's extra launches, and ten disarmed/armed
     pairs timed in turns;
   health-shadow (b): GLSFitter on the fit cell: each Cholesky solve
     replayed on the numpy mirror in the background, the drift within
     1e-5 sigma, /healthz (default_health) ok;
   health-device-fit, health-stream, health-chain (c): phase 9's stress
     problem refitted armed, one step a trial and whole_fit=True, bitwise
     phase 9's parameters with fit.device verdicts ok; the streaming fit
     at phase 9's 200,000 TOAs armed (worst chunk rescale, CG effort,
     the shadow's drift within the band); one chain chunk of phase 12's
     88 walkers (a posterior.chunk verdict);
   health-incidents (d): Fault(match="gls.fit", kind="nan") around the
     device fit: exactly one numerics:nonfinite dump, the failover
     bitwise phase 6's card fit; a float32 Gram forced into the shadowed
     GLS solve: numerics:drift;
   padding (e): the fit cell padded to 10,240 TOAs against the unpadded
     step on the card (fit-step's limits on the valid rows), both timed;
   perf (f): the guarded fit step's queue_wait + host_assembly +
     device_wall + collect against its wall; every dispatch key with its
     first-call wall in the ledger; roofline_block("z2_harmonics") at
     phase 5's float64-input time against phase 5's share of bound (0.1
     %); a 2 s profiler window over fit steps (window.json and a device
     trace); one auto window on a forced breaker-open;
   slo (g): SLOWatchdog(default_specs()) over armed fit steps fires no
     burn; a synthetic burn fires one slo_burn dump and one cross-linked
     window;
   its `health_perf` JSON line holds the numbers;
17. serving (pint_tpu_torch.serve; no hand-written kernel: K1 launches
   0 times here), each part fatal, on the cells above at full width;
   after each fault-free part the engine's supervisor counts no
   failover, timeout or breaker rejection and every unit ran on the
   device pool:
   (a) bench_serve's workload (build_workload(64, BENCH_SIZES,
     prebuild=True): six pulsars in buckets 64/128/256, polyco reads and
     residual requests) on the card sequential, coalesced and threaded
     with the pipelined drain, each twice: the modes within
     tests/test_serve.py's 1e-9 of one another, the card within 1e-8 of
     a CPU engine and of the host oracles (pta_solve_np, abs_phase),
     compile_count equal to the classes; requests/s, occupancy, padded
     waste, p50/p99, launches a dispatch and the idle share of one
     profiled coalesced pass;
   (b) the fit cell (10,000 TOAs, bucket 16,384) and the stress problem
     (124 free), four FitStepRequests of each, coalesced, against
     pta_solve of each problem alone on the card and pta_solve_np
     (dparams 1e-6 sigma, cov diagonal 1e-8, chi2 1e-10); dispatch ms
     and peak device memory, F's bytes reckoned first;
   (c) the fit cell without its ECORR line (the append path refuses
     ECORR) and with its DMX windows frozen (the first 8,000 TOAs in
     time order never see the last windows): a cold build of those
     TOAs, then four appends of 500, each against a cold streaming
     solve of all the TOAs so far
     (1e-7 sigma, chi2r 1e-8: tests/test_streaming_gls.py's); CG
     iterations;
   (d) phase 15's day of polycos from config 2 at gbt, 100,000 MJDs
     over its segments as PhasePredictRequests: against
     PolycoEntry.abs_phase (1e-9 turns) and model.phase (1e-6 turns);
   (e) config 5's 67 pulsars as PosteriorRequests (32 walkers x 600
     steps, seed k): bitwise sample_problems' chains at the served class;
     a GWBRequest at config 5 (14 frequencies, 8 x 8 grid): bitwise
     gwb_sweep_driver on its likelihood;
   (f) the device breaker open: every unit demoted to the host pool;
     the card hanging from the third unit on (1 s deadlines): every
     future completes, each failed-over request bitwise the host pool's
     result; a tenant over quota, an expired deadline and a graceful
     stop each shed with their label;
   (g) the engine killed mid-journal and restarted warm (AotStore):
     the replay bitwise an uninterrupted engine with no new class (its
     restored classes, hits and the first batch's ms cold against
     warm); a two-worker FleetFront losing a worker re-homes its
     unacknowledged admits, none lost;
   (h) pint_serve --demo 64 on the card, then a stdin JSONL session on
     NGC6440E (fit_step, residuals, phase, posterior, stats) with
     --journal and --metrics-port 0: /metrics and /healthz scraped,
     SIGTERM, one result line a request, the serve_session snapshot
     last;
   its `serve` JSON line holds the numbers;
18. pintk, the scripts and the analysis plane (no hand-written kernel:
   K1 launches 0 times here), each part fatal, after phase 17:
   (a) pintk on the fit cell (its par and its TOAs written as a .tim):
     Pulsar on the card against Pulsar on the CPU — the fit (auto:
     downhill GLS) at fit-downhill's limits; then on both select a
     quarter of the span, jump it, fit, unjump, delete 100 TOAs, undo,
     fit (each fit held to the CPU's, each step's counts equal);
     random_models(100) on the card, timed; plot_data postfit within
     1e-12 s of the CPU's and its axes within 1e-12 relative; pulse
     numbers equal;
   (b) the scripts on the card against --device cpu, to
     tests/test_torch_scripts.py's limits: pintbary at 100,000 MJDs of
     config 2's par (1e-13 d; its delays card vs CPU 1e-12 s), zima at
     10,000 TOAs of config 2's par with --addnoise --addcorrnoise --seed
     0 (TOAs 1e-11 s, the other columns equal), pintpublish on the fit
     cell (the same table, a straddled last digit held as the fitted
     value to 1e-3 sigma), convert_parfile (ELL1 -> DD), t2binary2pint,
     tcb2tdb and compare_parfiles (the same output);
   (c) the port's linter over the tree it runs from exits 0 (its rule
     and allowlist counts and its seconds); a Sanitizer around a
     params_only sweep of the fit cell on the card counts one cache
     build; Sanitizer.wrap flags a numpy operand entering a CUDA call
     and a non-finite output;
   every device-side object made lives on cuda:0; its `cli_gui` JSON
   line holds the numbers and seconds;
19. the opt-in precision routes of the fit step (no hand-written
   kernel: K1 launches 0 times here), each check fatal, on phase 6's
   fit cell: torch's float32 matmul precision "highest" and TF32 off; a
   step built with every flag None and no route environment variable
   bitwise phase 6's step with the same launches; then each route of
   PRECISION_ROUTES (float64, anchored, jac_f32, matmul_f32, jac_f32
   with the Gram left to follow it, and the reference's TPU production
   stack anchored + jac_f32 + matmul_f32): its step against phase 6's
   (|d dparams| 1e-4 sigma and chi2 1e-6 relative on a float64 route;
   0.1 sigma and 1e-4 on a float32 one), launches and busy ms of an
   eager step, the step replayed from a CUDA graph bitwise its eager
   step (replay and eager ms), Sanitizer.dtype_probe on the card equal
   to graftflow.predict_profile, the same route on a CPU twin at 400
   TOAs within the CPU tests' limits, and a DeviceDownhillGLSFitter fit
   (1e-6 sigma from phase 6's float64 fit on a float64 route, 0.1 sigma
   on a float32 one); graftlint with G9 clean over the port; its
   `precision` JSON line holds the numbers;
20. print the card's name and power limit, and one JSON line of kernel
   measurements.

The last line of standard output is {"ok": true, "device": {...}}. The
script exits non-zero, and prints no result, without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np

# The par file of the path: a J0030+0451-like isolated MSP with proper
# motion and parallax.
PAR = """\
PSR J0030+0451
RAJ 00:30:27.4
DECJ 04:51:39.7
PMRA -6.1
PMDEC 0.5
PX 3.02
F0 205.53069927
F1 -4.3e-16
PEPOCH 56500
POSEPOCH 56500
DM 4.33
DMEPOCH 56500
TZRMJD 56500.0
TZRSITE @
TZRFRQ inf
UNITS TDB
"""
F0, F1, PEPOCH = 205.53069927, -4.3e-16, 56500.0
NICER_MJDREF = (56658, 7.775925925925926e-4)
FERMI_MJDREF = (51910, 7.428703703703703e-4)
PEAK, WIDTH, FRAC_PULSED = 0.3, 0.01, 0.8

H100_BYTES_PER_S = 3.35e12     # HBM3
H100_F32_OPS_PER_S = 67e12     # float32 outside the tensor cores
RTOL = 5e-4
MAIN_ERR_LIMIT = 0.05          # kernel vs float64 plain at the main shape
L2_FLUSH_BYTES = 256 << 20     # written before each timed launch (L2: 50 MB)
SLEEP_CYCLES = 20_000_000      # first device sleep while the host enqueues
# float64 ToaBatch leaves per photon without planets: tdb_day, tdb_frac
# (2), freq, error, three (N, 3) vectors, pulse_number
BATCH_BYTES_PER_PHOTON = 8 * 14

# The fit path's problem: bench.build_problem() (bench.py:280), copied —
# this script imports nothing of the JAX package's tree. DM/DM1/DM2 are
# frozen (the free DMX windows tile the span); two bands per cluster.
FIT_SPAN = (53000.0, 57000.0)
FIT_PAR = [
    "PSR J0000+0000", "RAJ 12:00:00.0 1", "DECJ 30:00:00.0 1",
    "PMRA 2.0 1", "PMDEC -3.0 1", "PX 1.2 1", "F0 300.123456789 1",
    "F1 -1.0e-15 1", "F2 1e-26 1", "DM 20.0", "DM1 1e-4", "DM2 1e-6",
    "PEPOCH 55000", "POSEPOCH 55000", "DMEPOCH 55000", "TZRMJD 55000.1",
    "TZRSITE @", "TZRFRQ 1400", "UNITS TDB", "EFAC -be X 1.1",
    "EQUAD -be X 0.3", "ECORR -be X 1.2", "TNREDAMP -13.7",
    "TNREDGAM 3.5", "TNREDC 30",
] + [f"JUMP -grp g{i} 1e-6 1" for i in range(4)]
DP_SIGMA, COV_REL, CHI2_REL, RESID_S = 1e-6, 1e-8, 1e-10, 1e-12

# The binary path's configurations, copied from bench.py like FIT_PAR:
# config 2 (bench.config2_b1855like, bench.py:1118), a B1855+09-like
# ELL1 binary with 12 free DMX windows over MJD 53000-56000, and config 4
# (bench.config4_j0613like_fullcov, bench.py:1244), a J0613-0200-like
# ELL1 binary with red noise for the dense full-covariance solve.
B1855_SPAN = (53000.0, 56000.0)
B1855_NTOA, B1855_NDMX = 5_000, 12
B1855_PAR = [
    "PSR B1855+09x", "RAJ 18:57:36.39 1", "DECJ 09:43:17.2 1",
    "PMRA -2.9 1", "PMDEC -5.5 1", "PX 0.3 1", "F0 186.49408156698235 1",
    "F1 -6.2049e-16 1", "DM 13.29", "PEPOCH 54500", "POSEPOCH 54500",
    "DMEPOCH 54500", "TZRMJD 54500.1", "TZRSITE @", "TZRFRQ 1400",
    "UNITS TDB", "BINARY ELL1", "PB 12.32717 1", "A1 9.2307805 1",
    "TASC 54500.03 1", "EPS1 -2.15e-5 1", "EPS2 -3.1e-7 1", "SINI 0.999 1",
    "M2 0.25 1", "EFAC -be X 1.1", "EQUAD -be X 0.2", "ECORR -be X 0.9",
    "TNREDAMP -14.1", "TNREDGAM 4.1", "TNREDC 20",
]
# the parameters the downhill fit starts ~3 sigma away from
B1855_OFFSET = ("PB", "A1", "TASC", "EPS1")
J0613_PAR = [
    "PSR J0613-0200x", "RAJ 06:13:43.97 1", "DECJ -02:00:47.2 1",
    "PMRA 1.84 1", "PMDEC -10.6 1", "PX 0.9 1", "F0 326.6005670074 1",
    "F1 -1.023e-15 1", "DM 38.77 1", "PEPOCH 54500", "POSEPOCH 54500",
    "TZRMJD 54500.1", "TZRSITE @", "TZRFRQ 1400", "UNITS TDB",
    "BINARY ELL1", "PB 1.198512575 1", "A1 1.09144 1", "TASC 54500.11 1",
    "EPS1 3.5e-6 1", "EPS2 -2.5e-6 1", "TNREDAMP -13.9", "TNREDGAM 3.1",
    "TNREDC 15",
]
FULLCOV_REL = 1e-8          # GPU vs CPU dense solve
WOODBURY_RTOL, WOODBURY_ATOL = 1e-6, 1e-13   # tests/test_gls.py:179-180
ZOO_DELAY_S, ZOO_DESIGN_REL = 1e-12, 1e-10
ZOO_NTOA = 10_000
# The binary zoo: one J1012+5307-like par per registered model (orbits as
# in tests/test_binary_zoo.py and tests/test_binary.py).
ZOO_BASE = [
    "PSR J1012+5307", "RAJ 10:12:33.43 1", "DECJ 53:07:02.5 1",
    "PMRA 2.6 1", "PMDEC -25.5 1", "PX 1.2 1", "F0 190.2678376220576 1",
    "F1 -6.2e-16 1", "PEPOCH 55000", "POSEPOCH 55000", "DM 9.02 1",
    "DMEPOCH 55000", "TZRMJD 55000.1", "TZRSITE @", "TZRFRQ 1400",
    "UNITS TDB",
]
_DD_ORBIT = ["PB 0.6 1", "A1 1.45 1", "T0 55000.2 1", "ECC 0.02 1",
             "OM 47.0 1"]
ZOO = {
    "ELL1": ["PB 0.60467271355 1", "A1 0.5818172 1", "TASC 55000.40712 1",
             "EPS1 1.2e-5 1", "EPS2 -3.4e-6 1", "M2 0.2 1", "SINI 0.9 1"],
    "ELL1H": ["PB 0.60467271355 1", "A1 0.5818172 1", "TASC 55000.40712 1",
              "EPS1 1.2e-5 1", "EPS2 -3.4e-6 1", "H3 2.1e-7 1", "STIG 0.6 1"],
    "ELL1k": ["PB 0.2 1", "A1 0.9 1", "TASC 55000.05 1", "EPS1 1.1e-5 1",
              "EPS2 -0.4e-5 1", "M2 0.2", "SINI 0.9", "OMDOT 1.5 1",
              "LNEDOT 1e-12"],
    "BT": ["PB 0.60467271355 1", "A1 0.5818172 1", "T0 55000.40712 1",
           "ECC 1.0e-5 1", "OM 45.0 1", "GAMMA 0.0"],
    "BT_piecewise": ["PB 1.2 1", "A1 3.5 1", "T0 55000.2 1", "ECC 0.01 1",
                     "OM 40.0 1", "T0X_0001 55000.2002 1",
                     "A1X_0001 3.5004 1", "XR1_0001 54800",
                     "XR2_0001 55200"],
    "DD": _DD_ORBIT + ["GAMMA 1e-4 1", "M2 0.3 1", "SINI 0.95 1"],
    "DDS": _DD_ORBIT + ["M2 0.3 1", "SHAPMAX 2.5 1"],
    "DDH": _DD_ORBIT + ["H3 2.0e-7 1", "STIG 0.7 1"],
    "DDGR": ["PB 0.4 1", "A1 2.34 1", "T0 55000.1 1", "ECC 0.17 1",
             "OM 30.0 1", "MTOT 2.8 1", "M2 1.3 1"],
    "DDK": _DD_ORBIT + ["M2 0.3 1", "KIN 71.0 1", "KOM 35.0 1"],
}
# The wideband path's configurations: config 3
# (bench.config3_j1713like_wideband, bench.py:1175), copied like FIT_PAR,
# and the wideband twin of the fit path's problem. The twin's two bands
# leave FD1, FD2 and the Offset spanning a two-point space (exactly
# singular, bench_stress.py:98-103), so FD2 stays frozen.
CONFIG3_SPAN = (53000.0, 56000.0)
CONFIG3_NTOA, CONFIG3_NDMX = 2_000, 10
CONFIG3_PAR = [
    "PSR J1713+0747x", "RAJ 17:13:49.53 1", "DECJ 07:47:37.5 1",
    "PMRA 4.9 1", "PMDEC -3.9 1", "PX 0.85 1", "F0 218.8118437960826 1",
    "F1 -4.08e-16 1", "DM 15.99", "PEPOCH 54500", "POSEPOCH 54500",
    "DMEPOCH 54500", "TZRMJD 54500.1", "TZRSITE @", "TZRFRQ 1400",
    "UNITS TDB", "BINARY ELL1", "PB 67.8251 1", "A1 32.34242 1",
    "TASC 54500.2 1", "EPS1 3.9e-5 1", "EPS2 -7.4e-5 1",
    "DMEFAC -be X 1.1", "DMEQUAD -be X 1e-5",
]
WB_TWIN_EXTRA = [
    "DMEFAC -be X 1.1", "DMEQUAD -be X 1e-5", "DMJUMP -grp g1 0 1",
    "FD1 1e-6 1", "FD2 -3e-7", "FDJUMP -grp g2 1e-7 1", "TNDMAMP -13.5",
    "TNDMGAM 3.0", "TNDMC 30",
]
DD_SUM_REL = 1e-28     # tests/test_torch_dd.py::test_dd_sum_is_compensated
DD_SUM_BIG = 1 << 20   # values of the large dd_sum check

# BASELINE's stress problem (bench_stress.build_stress_problem,
# bench_stress.py:27, recipe copied): a NANOGrav-like pulsar, 10,000 TOAs
# in four-TOA clusters over 12 years, 5 receivers each with its own
# EFAC/EQUAD/ECORR, JUMPs and FD jumps, an ELL1 binary, 100 free DMX
# windows, 30 red-noise and 30 DM-noise modes.
STRESS_SPAN = (53000.0, 57383.0)
STRESS_NTOA, STRESS_NDMX = 10_000, 100
RECEIVERS = ("rcvr800", "rcvr1400", "rcvr2100", "guppi", "puppi")
STRESS_PAR = [
    "PSR J1600-3053x", "RAJ 16:00:51.90 1", "DECJ -30:53:49.3 1",
    "PMRA -0.95 1", "PMDEC -6.9 1", "PX 0.5 1", "F0 277.9377112429746 1",
    "F1 -7.3387e-16 1", "DM 52.33", "DM1 0", "DM2 0", "PEPOCH 55000",
    "POSEPOCH 55000", "DMEPOCH 55000", "TZRMJD 55000.1", "TZRSITE @",
    "TZRFRQ 1400", "UNITS TDB", "BINARY ELL1", "PB 14.348466 1",
    "A1 8.8016531 1", "TASC 55000.2 1", "EPS1 2.0e-4 1", "EPS2 -1.7e-4 1",
    "M2 0.27 1", "SINI 0.87 1",
] + [f"{k} -be {r} {v}" for i, r in enumerate(RECEIVERS)
     for k, v in (("EFAC", 1.0 + 0.05 * i), ("EQUAD", 0.1 + 0.05 * i),
                  ("ECORR", 0.4 + 0.1 * i))] + [
    "DMEFAC -be rcvr1400 1.1", "DMEQUAD -be guppi 1e-4",
] + [f"JUMP -be {r} 1e-6 1" for r in RECEIVERS[1:]] + [
    line for r in RECEIVERS[3:]
    for line in (f"FDJUMP -be {r} 1e-6 1", f"FD2JUMP -be {r} 5e-7 1")] + [
    "FD1 1e-5 1", "FD2 -4e-6 1", "TNREDAMP -14.2", "TNREDGAM 3.8",
    "TNREDC 30",
]
STRESS_DM_NOISE = ["TNDMAMP -13.6", "TNDMGAM 2.9", "TNDMC 30"]
DEVICE_FIT_CHI2_REL = 1e-6    # tests/test_device_fitter.py:56
STRESS_TRUTH_SIGMA = 5.0      # bench_stress.py's ok: F0 within 5 sigma

# bench.build_problem_streaming (bench.py:1395, recipe copied): the
# north-star model without ECORR and its JUMPs, 15 red-noise modes,
# EFAC/EQUAD, 28 DMX, at 200,000 TOAs: Fitter.auto's streaming threshold
STREAM_PAR = [
    "PSR J0000+0001", "RAJ 12:00:00.0 1", "DECJ 30:00:00.0 1",
    "PMRA 2.0 1", "PMDEC -3.0 1", "PX 1.2 1", "F0 300.123456789 1",
    "F1 -1.0e-15 1", "F2 1e-26 1", "DM 20.0", "DM1 1e-4", "DM2 1e-6",
    "PEPOCH 55000", "POSEPOCH 55000", "DMEPOCH 55000", "TZRMJD 55000.1",
    "TZRSITE @", "TZRFRQ 1400", "UNITS TDB", "EFAC -be X 1.1",
    "EQUAD -be X 0.3", "TNREDAMP -13.7", "TNREDGAM 3.5", "TNREDC 15",
]
STREAM_SIGMA, STREAM_CHI2_REL = 1e-6, 1e-8   # bench.py:1520
# the fit cell's streamed chunk lengths: a power of two (its boundaries
# fall between the four-TOA epochs) and one whose boundaries split epochs
STREAM_ECORR_CHUNKS = (4096, 4094)
NGC = tuple(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "datafile", f"NGC6440E.{ext}")
            for ext in ("par", "tim"))

# BASELINE config 5, the pulsar array (bench_pta.build_pulsar,
# bench_pta.py:33, recipe copied): 67 pulsars over MJD 54000-56000, 100
# TOAs each by default, a third of them ELL1 binaries, F0 moved 1e-10 Hz
PTA_NPSR = 67
PTA_F0_MOVE = 1e-10
PTA_RTOL, PTA_ATOL = 1e-8, 1e-15     # tests/test_pta.py:93
PTA_TRUTH_SIGMA = 5.0                # bench_pta.py's recovered
GWB_RTOL = 1e-9                      # tests/test_gwb.py:235
GWB_GRID = 8                         # bench_pta.py's 8 x 8 sweep
POST_WALKERS, POST_STEPS, POST_BURN = 32, 600, 200
# the runtime phase: (a)'s injected hang against the short deadline on
# the faulted key, the chain chunk of (e), the sizes of the solve
# crossover, and the headroom every key's largest wall must leave
RT_HANG_S, RT_DEADLINE_S = 300.0, 5.0
RT_CHAIN_CHUNK = 64
# runtime-chain's depth: 4 chunks, the last two failing over. Its check
# is per chunk (bitwise the all-CPU chain), not statistical, so it runs
# shorter than phase 12's 600 steps, which it ran two chains of (on the
# card and on the CPU) inside the smoke's time limit
RT_CHAIN_STEPS = 200
RT_CROSSOVER_NTOA = (1_000,)     # and NGC6440E's 62, the fit cell's 10,000
RT_HEADROOM = 10.0
STEP_SIGMA_LIMIT = 1e-7           # one downhill step, card vs CPU (ROADMAP §3)
H100_F64_OPS_PER_S = 67e12           # float64 on the tensor cores (DGEMM)

# The Bayesian path on the fit cell: 40 timing parameters + ECORR1.log10,
# PLRedNoise.log10_A and .gamma sampled, with MCMCFitter's 2 * 43 + 2 = 88
# walkers (walkers(): 2 * ndim + 2). BAYES_REL: the GPU batch against the
# CPU's and the scalar calls (tests/test_torch_bayesian.py); NOISE_REL:
# the noise-sampled oracles (tests/test_sampling.py:228, :250).
BAYES_EXACT_STEPS, BAYES_TIMED_STEPS = 32, 64
BAYES_REL, NOISE_REL = 1e-10, 1e-9
BAYES_ETA_MOVE = (0.1, 0.3, -0.4)
# the moments check: tests/test_sampling.py's 60-TOA pulsar (PAR, _mk's
# recipe copied), its WLS fit, 32 walkers x 600 steps, 200 burned
MOMENT_PAR = """\
PSR J0006+0006
RAJ 06:00:00.0
DECJ 20:00:00.0
F0 220.0 1
F1 -1.5e-15 1
PEPOCH 55000
POSEPOCH 55000
DM 15.0
DMEPOCH 55000
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
"""
GRID_NODES, GRID_MAXITER, GRID_SIGMA = 8, 2, 3.5   # (F0, F1) +-3.5 sigma

# The rest of the timing-model zoo. zoo-msp: a NANOGrav-15-yr-style
# J1713+0747-like DD binary, 10,000 TOAs in four-TOA clusters (four
# sub-bands of +-2 and +-6 %) rotating over five receivers at gbt and
# arecibo, each with its EFAC/EQUAD/ECORR and all but one with a free
# JUMP; the troposphere, NE_SW, one SWX window of +-30 d about each
# December solar conjunction, DMWaveX at k/T (k = 1..40, T the span) in
# place of DMX, CM and CM1, CMWaveX at k/T (k = 1..20), FD1-FD3, red,
# chromatic and solar-wind noise: 159 free parameters. OM stays frozen
# (T0 and OM are degenerate at e ~ 7.5e-5). The TZR TOA is at gbt, as in
# a NANOGrav par file: at '@' with a finite TZRFRQ the Sun is ~0.005 AU
# from it, its solar-wind DM is a constant ~200 times the TOAs' own, and
# NE_SW's column is then nearly the offset's (the normal matrix's
# smallest correlation eigenvalue 4e-7 against 4e-4 at gbt, on the CPU
# at 10,000 TOAs; on an H100 the step's covariance then moved 8e-8
# relative between the GPU and the CPU, over the 1e-8 limit).
ZOO_MSP_SPAN = (53000.0, 59000.0)
ZOO_MSP_NTOA = 10_000
ZOO_MSP_RECEIVERS = (("gbt", "Rcvr_800", 820.0), ("gbt", "Rcvr1_2", 1400.0),
                     ("arecibo", "430", 430.0), ("arecibo", "L-wide", 1400.0),
                     ("arecibo", "S-wide", 2300.0))
ZOO_SUBBANDS = (-0.06, -0.02, 0.02, 0.06)
ZOO_CONJUNCTION = 53347.0   # J1713+0747's December solar conjunction, 2004
ZOO_MSP_PAR = [
    "PSR J1713+0747z", "RAJ 17:13:49.5331 1", "DECJ 07:47:37.492 1",
    "PMRA 4.918 1", "PMDEC -3.914 1", "PX 0.95 1", "F0 218.81184385472 1",
    "F1 -4.0838e-16 1", "DM 15.917", "PEPOCH 56000", "POSEPOCH 56000",
    "DMEPOCH 56000", "TZRMJD 56000.1", "TZRSITE gbt", "TZRFRQ 1400",
    "UNITS TDB", "CORRECT_TROPOSPHERE Y", "BINARY DD", "PB 67.8251309 1",
    "A1 32.342422 1", "T0 56000.4 1", "ECC 7.494e-5 1", "OM 176.2",
    "M2 0.29 1", "SINI 0.95 1", "NE_SW 8.0 1", "SWM 0", "CM 0.0 1",
    "CM1 0.0 1", "CMEPOCH 56000", "TNCHROMIDX 4", "FD1 1e-5 1",
    "FD2 -2e-6 1", "FD3 5e-7 1", "DMWXEPOCH 56000", "CMWXEPOCH 56000",
    "TNREDAMP -14.2", "TNREDGAM 3.5", "TNREDC 30", "TNCHROMAMP -14.5",
    "TNCHROMGAM 3.0", "TNCHROMC 30", "TNSWAMP -6.0", "TNSWGAM 2.0",
    "TNSWC 10",
]
ZOO_MSP_NDMWX, ZOO_MSP_NCMWX = 40, 20
ZOO_MSP_OFFSET = ("F0", "PB", "A1", "NE_SW", "CM")
# zoo-young: a Vela-like glitching pulsar, 3,000 TOAs at parkes (1400 and
# 3100 MHz) over MJD 55000-59000: astrometry, F0-F2, two glitches
# (GLPH/GLF0/GLF1/GLF0D free, GLEP and GLTD frozen), one spindown piece
# between them, WaveX at 30 frequencies k/T (k = 25..54, periods 74-160
# d) as the fittable whitening, four yearly CMX windows, EFAC/EQUAD. The
# lower harmonics are what F0-F2 and the glitch ramps fit already: with
# k = 1..30 the normal matrix's smallest correlation eigenvalue is 2e-13
# (k = 3..32: 1e-9, k = 25..54: 7.6e-6, on the CPU at 3,000 TOAs), and
# a 1-ulp difference of the design columns moves the step's covariance
# by up to 1e-4 relative.
ZOO_YOUNG_SPAN = (55000.0, 59000.0)
ZOO_YOUNG_NTOA = 3_000
ZOO_YOUNG_BASE = [
    "PSR J0835-4510z", "RAJ 08:35:20.61149 1", "DECJ -45:10:34.8751 1",
    "PMRA -49.68 1", "PMDEC 29.9 1", "PX 3.5", "F0 11.186693 1",
    "F1 -1.5583e-11 1", "F2 1.2e-21 1", "DM 67.97", "PEPOCH 57000",
    "POSEPOCH 57000", "DMEPOCH 57000", "TZRMJD 57000.1", "TZRSITE @",
]
ZOO_YOUNG_GLITCH = ["GLEP_1 55800", "GLPH_1 0.0 1", "GLF0_1 1.9e-5 1",
                    "GLF1_1 -1e-13 1", "GLF0D_1 8e-8 1", "GLTD_1 30"]
ZOO_YOUNG_PAR = ZOO_YOUNG_BASE + ["TZRFRQ 1400", "UNITS TDB"] \
    + ZOO_YOUNG_GLITCH + [
        "GLEP_2 57734.5", "GLPH_2 0.0 1", "GLF0_2 1.6e-5 1",
        "GLF1_2 -8e-14 1", "GLF0D_2 5e-8 1", "GLTD_2 12", "PWEP_1 56750",
        "PWSTART_1 56400", "PWSTOP_1 57100", "PWPH_1 0.0 1",
        "PWF0_1 0.0 1", "WXEPOCH 57000", "EFAC -f PDFB_1400 1.1",
        "EQUAD -f PDFB_1400 0.5", "EFAC -f PDFB_3100 1.2",
        "EQUAD -f PDFB_3100 0.8",
    ] + [line for k in range(4) for line in (
        f"CMX_{k + 1:04d} 0.0 1", f"CMXR1_{k + 1:04d} {55000.0 + 365.25 * k}",
        f"CMXR2_{k + 1:04d} {55000.0 + 365.25 * (k + 1)}")]
ZOO_YOUNG_NWX, ZOO_YOUNG_WX_K0 = 30, 25
ZOO_YOUNG_OFFSET = ("F0", "F1", "GLF0_1", "GLPH_2")
ZOO_TRUTH_SIGMA = 5.0
# zoo-photon: the young pulsar's ephemeris as a Fermi-LAT user folds it
# (one glitch, TEMPO's WAVE whitening at WAVE_OM with WAVE1-WAVE10, as
# in Kerr et al. 2015, ApJ 814, 128, and a 40-node IFUNC table), on
# barycentred photons over MJD 55000-59000
ZOO_PHOTON_SPAN = (55000.0, 59000.0)
ZOO_PHOTON_PAR = ZOO_YOUNG_BASE + ["TZRFRQ inf", "UNITS TDB"] \
    + ZOO_YOUNG_GLITCH[:1] + ["GLPH_1 0.2", "GLF0_1 1.9e-5",
                              "GLF1_1 -1e-13", "GLF0D_1 8e-8", "GLTD_1 30",
                              "WAVE_OM 0.0015", "WAVEEPOCH 57000"] \
    + [f"WAVE{k} {5e-3 / k!r} {-3e-3 / k!r}" for k in range(1, 11)] \
    + ["SIFUNC 2"] + [
        f"IFUNC{k + 1} {55000.0 + 4000.0 * k / 39:.4f} "
        f"{4e-3 * math.sin(0.7 * k)!r}" for k in range(40)]
ZOO_PHOTON_H_SHARE = 0.5   # of the J0030 path's H, same photons and profile
# zoo-sweep: each component alone on the fit path's pulsar (FIT_PAR's
# model lines, tests/test_torch_zoo.py's component lines), then SWM 1
# with SWP free, and DMWaveX + NE_SW + SWX without TZRFRQ on TOAs of which
# every tenth is barycentred (nu = inf)
ZOO_SWEEP_BASE = FIT_PAR[:FIT_PAR.index("UNITS TDB") + 1]
ZOO_SWEEP = {
    "Glitch": ["GLEP_1 54600", "GLPH_1 0.1 1", "GLF0_1 1e-8 1",
               "GLF1_1 -1e-17 1", "GLF0D_1 2e-8 1", "GLTD_1 50",
               "GLEP_2 55300", "GLF0_2 3e-9 1", "GLF2_2 1e-27 1"],
    "Wave": ["WAVE_OM 0.01", "WAVEEPOCH 55000", "WAVE1 1e-5 -2e-5",
             "WAVE2 3e-6 1e-6", "WAVE3 -1e-6 2e-6"],
    "WaveX": ["WXEPOCH 55000"] + [
        ln for k in range(1, 4) for ln in (
            f"WXFREQ_{k:04d} {0.0015 * k!r}", f"WXSIN_{k:04d} 1e-6 1",
            f"WXCOS_{k:04d} -2e-7 1")],
    "DMWaveX": ["DMWXEPOCH 55000"] + [
        ln for k in range(1, 4) for ln in (
            f"DMWXFREQ_{k:04d} {0.0015 * k!r}", f"DMWXSIN_{k:04d} 1e-4 1",
            f"DMWXCOS_{k:04d} -2e-5 1")],
    "SolarWindDispersion": ["NE_SW 8.0 1"],
    "TroposphereDelay": ["CORRECT_TROPOSPHERE Y"],
    "ChromaticCM": ["CM 0.02 1", "CM1 1e-10 1", "CMEPOCH 55000",
                    "TNCHROMIDX 4.4"],
    "ChromaticCMX": [ln for k, (a, b) in enumerate(
        ((54100, 54700), (54700, 55300), (55300, 55900)), 1) for ln in (
        f"CMX_{k:04d} 1e-3 1", f"CMXR1_{k:04d} {a}", f"CMXR2_{k:04d} {b}")],
    "CMWaveX": ["CMWXEPOCH 55000"] + [
        ln for k in range(1, 3) for ln in (
            f"CMWXFREQ_{k:04d} {0.002 * k!r}", f"CMWXSIN_{k:04d} 1e-4 1",
            f"CMWXCOS_{k:04d} 5e-5 1")],
    "IFunc": ["SIFUNC 2", "IFUNC1 53000 1e-5", "IFUNC2 54800 -2e-5",
              "IFUNC3 55600 3e-5", "IFUNC4 57000 0.5e-5"],
    "PiecewiseSpindown": ["PWEP_1 54650", "PWSTART_1 54550",
                          "PWSTOP_1 54750", "PWPH_1 0.02 1", "PWF0_1 2e-8 1",
                          "PWF1_1 1e-17 1"],
    "SolarWindDispersionX": [
        "SWXDM_0001 1e-4 1", "SWXR1_0001 54100", "SWXR2_0001 54500",
        "SWXDM_0002 2e-4 1", "SWXR1_0002 54500", "SWXR2_0002 55000"],
    "PLChromNoise": ["TNCHROMAMP -14", "TNCHROMGAM 3", "TNCHROMC 8"],
    "PLSWNoise": ["TNSWAMP -5", "TNSWGAM 2", "TNSWC 6"],
}
ZOO_WB_NDMWX = 10

# Phase 13, photon sampling, on the J0030 path's photons (--path-n,
# default 1,048,576) and PAR with F0 and F1 free (PH_PAR): the templates
# and LCFitter against the CPU on the first PH_LCFIT_N photons
# (LCEnergyFitter on PH_ENERGY_N), the photon likelihood of PH_WALKERS
# walkers (a half-ensemble of event_optimize's 32) against the CPU on the
# first PH_BATCH_N, the chains, event_optimize, the composite radio +
# photon fit (tests/test_mcmc.py:188's shape), fermiphase on a Fermi-LAT-
# like FT1 file and the TOA cache and tim writer on NGC6440E.
PH_PAR = PAR.replace("F0 205.53069927\n", "F0 205.53069927 1\n").replace(
    "F1 -4.3e-16\n", "F1 -4.3e-16 1\n")
PH_SPECS = {
    "gaussian": [("gaussian", 0.55, 0.3, 0.03)],
    "gaussian2": [("gaussian2", 0.5, 0.35, [0.02, 0.05])],
    "vonmises": [("vonmises", 0.5, 0.7, 0.04)],
    "lorentzian": [("lorentzian", 0.45, 0.95, 0.02)],
    "lorentzian2": [("lorentzian2", 0.5, 0.05, [0.02, 0.05])],
    "tophat": [("tophat", 0.6, 0.5, 0.2)],
    "skewgaussian": [("skewgaussian", 0.5, 0.3, [0.03, 2.0])],
    "mixed": [("gaussian", 0.4, 0.25, 0.03), ("vonmises", 0.2, 0.7, 0.05),
              ("lorentzian2", 0.15, 0.9, [0.01, 0.03])],
}
PH_ENERGY_BASE = [("gaussian", 0.45, 0.3, 0.04), ("vonmises", 0.2, 0.7, 0.05),
                  ("lorentzian", 0.1, 0.9, 0.02)]
PH_SLOPES = dict(e0_kev=1.0, dlogits=[0.0, 0.4, -0.2, 0.1],
                 dloc=[0.05, -0.02, 0.01], dlogw=[0.3, 0.0, -0.1])
PH_PDF_REL = 1e-12            # card vs CPU pdf, of the pdf's largest value
PH_DRAWS = 65_536             # LCTemplate.random draws, card vs CPU
PH_REL = 1e-9                 # card vs CPU log-likelihoods and posteriors
PH_LCFIT_N, PH_ENERGY_N, PH_BATCH_N = 262_144, 65_536, 65_536
PH_THETA_SIGMA, PH_ERR_REL = 1e-2, 1e-4   # LCFitter card vs CPU
PH_LOC_SIGMA, PH_WIDTH_REL = 3.0, 0.2     # the full-width fit vs the truth
PH_WALKERS = 16
PH_SCALES = (1e-10, 3e-17)    # F0 [Hz], F1 [Hz/s] spread of the batch points
PH_EXACT_STEPS = 16
PH_REC_WALKERS, PH_REC_STEPS, PH_REC_OFFSET = 32, 200, 3.0
PH_TRUTH_SIGMA = 5.0
PH_ACCEPT = (0.1, 0.95)
PH_EO_STEPS = 100             # event_optimize's chain (32 walkers, F0/F1)
COMPOSITE_NTOA, COMPOSITE_N = 500, 262_144
COMPOSITE_WALKERS, COMPOSITE_STEPS = 8, 60
FERMI_N = 262_144             # the ~1e5 weighted photons of a Fermi MSP
H_REL = 1e-3                  # phase 4's limit: H vs the float64 plain H


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def event_draws(n: int, seed: int) -> tuple:
    """(barycentric MJDs, target phases, weights) of `n` photons whose
    phases follow a Gaussian peak at PEAK plus a uniform background, the
    pulsed photons heavier: the recipe of the reference package's event
    tests (times placed on PAR's spin-down to first order in F1)."""
    rng = np.random.default_rng(seed)
    mjd0, mjd1 = 56400.0, 56600.0
    base = rng.uniform(mjd0, mjd1, n)
    pulsed = rng.uniform(size=n) < FRAC_PULSED
    phi_t = np.where(pulsed,
                     np.mod(PEAK + WIDTH * rng.standard_normal(n), 1.0),
                     rng.uniform(size=n))
    dt = (base - PEPOCH) * 86400.0
    k = np.floor(dt * F0)
    tsec = (k + phi_t) / F0 - 0.5 * F1 / F0 * ((k + phi_t) / F0) ** 2
    w = np.where(pulsed, rng.uniform(0.5, 1.0, n), rng.uniform(0.0, 0.5, n))
    return PEPOCH + tsec / 86400.0, phi_t, w


def event_columns(n: int, seed: int, mjdref=NICER_MJDREF,
                  weightcol: str = "WEIGHT") -> dict:
    """event_draws' photons as event columns: times in seconds since
    `mjdref` (the NICER MJDREF by default), in time order, and the
    weights in column `weightcol`."""
    mjd, _, w = event_draws(n, seed)
    times = ((mjd - mjdref[0]) - mjdref[1]) * 86400.0
    order = np.argsort(times)
    return {"TIME": times[order], weightcol: w[order]}


def write_events(path: str, cols: dict, mjdref=NICER_MJDREF,
                 telescop: str = "NICER") -> None:
    """Barycentred (TDB, SOLARSYSTEM) event FITS of `cols`."""
    from pint_tpu_torch.io.fits import write_events_fits

    write_events_fits(path, cols, header_extra={
        "TIMESYS": "TDB", "TIMEREF": "SOLARSYSTEM",
        "MJDREFI": mjdref[0], "MJDREFF": mjdref[1],
        "TELESCOP": telescop, "TIMEZERO": 0.0, "TIMEUNIT": "s"})


def cuda_ms(fn, reps: int = 20, warmup: int = 3,
            per_sleep: int | None = None) -> dict:
    """Device milliseconds of one fn() call: {"median", "min", "max"} over
    `reps` calls, each between its own pair of CUDA events.

    - Before each call, outside its events, a 256 MB buffer is written
      and then another one is read, so the call finds its inputs in
      device memory and not in the 50 MB L2, as the photon path does.
      The read matters: after the write alone the L2 holds up to 50 MB
      of dirty lines, and writing them back would be timed with the call
      (for a kernel that reads tens of MB, a large share of its time).
    - The device first sleeps (torch.cuda._sleep) until the host has
      enqueued the calls; otherwise the events would also time the
      host's work between them (argument checks, allocation, the ctypes
      call), which can exceed a short kernel. The sleep is lengthened
      until an event recorded after it is still pending when the
      enqueueing ends.
    - `per_sleep` calls are enqueued under one sleep (all `reps` by
      default). A call of hundreds of launches (a cuSOLVER factor and
      its solves) fills the device's launch queue within a few calls,
      and the host then waits for the sleeping device: give it 1.
    """
    import torch

    for _ in range(warmup):
        fn()
    written = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                          device="cuda")
    read = torch.zeros_like(written)
    total = torch.empty((), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    cycles, times = SLEEP_CYCLES, []
    while len(times) < reps:
        for _ in range(5):
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(min(per_sleep or reps, reps - len(times)))]
            torch.cuda._sleep(cycles)
            awake = torch.cuda.Event()
            awake.record()
            for a, b in ev:
                written.zero_()
                torch.sum(read, dim=0, out=total)
                a.record()
                fn()
                b.record()
            slept_through = not awake.query()
            torch.cuda.synchronize()
            if slept_through:
                break
            cycles *= 4
        else:
            fail("the device woke before the host had enqueued the timed "
                 "calls")
        times += [a.elapsed_time(b) for a, b in ev]
    return {"median": float(np.median(times)), "min": float(min(times)),
            "max": float(max(times))}


def check_close(name, got, want, n) -> None:
    import torch

    atol = 5e-3 * math.sqrt(max(n, 1))
    if not torch.allclose(got.double(), want.double(), rtol=RTOL, atol=atol):
        err = (got.double() - want.double()).abs().max().item()
        fail(f"{name}: kernel disagrees with the plain version "
             f"(max abs err {err:.3e}, atol {atol:.3e}, rtol {RTOL})")


def phase_kernel(zmod, dev, n_main: int, m_main: int, seed: int) -> dict:
    """Kernel against the plain version at every N and m; float64, mixed
    and misaligned inputs bitwise against float32 ones. Returns the error
    at the main shape."""
    import torch

    rng = np.random.default_rng(seed + 1)
    main_err = None
    ms = sorted({1, 2, m_main, 32, 33, 129})
    for n in (1, 1000, 8192 + 17, n_main):
        # one row more, so that [1:] is a view whose data are not 16-byte
        # aligned: the kernel's scalar-load path
        ph_all = torch.as_tensor(rng.uniform(size=n + 1),
                                 dtype=torch.float64, device=dev)
        w_all = torch.as_tensor(rng.uniform(0.1, 1.0, n + 1),
                                dtype=torch.float64, device=dev)
        ph64, w64 = ph_all[1:].clone(), w_all[1:].clone()
        ph32, w32 = ph64.float(), w64.float()
        for m in ms:
            k1 = zmod.z2_harmonics(ph32, w32, m)
            k2 = zmod.z2_harmonics(ph32, w32, m)
            other = {"float64": zmod.z2_harmonics(ph64, w64, m),
                     "float32/float64": zmod.z2_harmonics(ph32, w64, m),
                     "float64/float32": zmod.z2_harmonics(ph64, w32, m),
                     "misaligned float64": zmod.z2_harmonics(
                         ph_all[1:], w_all[1:], m)}
            torch.cuda.synchronize()
            if not torch.equal(k1, k2):
                fail(f"two launches differ at N={n} m={m}")
            if k1.shape != (2, m) or k1.dtype != torch.float64:
                fail(f"kernel output {tuple(k1.shape)} {k1.dtype}")
            for name, got in other.items():
                if not torch.equal(got, k1):
                    fail(f"{name} inputs differ from float32 ones at N={n} "
                         f"m={m} (max {(got - k1).abs().max().item():.3e})")
            p32 = zmod.z2_harmonics_plain(ph32, w32, m)
            p64 = zmod.z2_harmonics_plain(ph32.double(), w32.double(), m)
            check_close(f"N={n} m={m} vs f32 plain", k1, p32, n)
            check_close(f"N={n} m={m} vs f64 plain", k1, p64, n)
            if n == n_main and m == m_main:
                main_err = (k1 - p64).abs().max().item()
                if not main_err <= MAIN_ERR_LIMIT:
                    fail(f"max abs error {main_err:.3e} against the float64 "
                         f"plain version at N={n} m={m} (limit "
                         f"{MAIN_ERR_LIMIT})")
            del p32, p64
        print(f"kernel == plain at N={n}, m in {tuple(ms)}; float64, mixed "
              "and misaligned inputs bitwise equal to float32 ones")
    # zero-weight rows at the ragged edge (beyond 8192 and past the last
    # full block) must leave the sums of the first 8192 rows unchanged
    n = 8192 + 17
    ph = torch.zeros(n, dtype=torch.float32, device=dev)
    ph[:8192] = torch.as_tensor(rng.uniform(size=8192), device=dev)
    w = torch.zeros(n, dtype=torch.float32, device=dev)
    w[:8192] = torch.as_tensor(rng.uniform(0.5, 1.0, 8192), device=dev)
    full = zmod.z2_harmonics(ph, w, 3)
    head = zmod.z2_harmonics(ph[:8192].clone(), w[:8192].clone(), 3)
    check_close("zero-weight ragged rows", full, head, 8192)
    check_close("zero-weight ragged rows vs plain", full,
                zmod.z2_harmonics_plain(ph[:8192].double(),
                                        w[:8192].double(), 3), 8192)
    print("zero-weight ragged rows are inert")
    return {"max_abs_err": main_err}


def phase_path(zmod, dev, cols: dict, par: str, m: int, tmp: str) -> dict:
    """The photonphase CLI end to end on the GPU."""
    import torch

    from pint_tpu_torch.scripts import photonphase

    n = len(cols["TIME"])
    ev = os.path.join(tmp, "events.fits")
    npz = os.path.join(tmp, "phases.npz")
    write_events(ev, cols)
    zmod.launches = 0
    buf = io.StringIO()
    cuda_act = torch.profiler.ProfilerActivity.CUDA
    prof_cm = (torch.profiler.profile(activities=[cuda_act])
               if cuda_act in torch.profiler.supported_activities()
               else contextlib.nullcontext())
    with prof_cm as prof, contextlib.redirect_stdout(buf):
        rc = photonphase.main([ev, par, "--weightcol", "WEIGHT",
                               "--npz", npz])
    launches = zmod.launches
    out = buf.getvalue()
    print(out, end="")
    if rc != 0:
        fail(f"photonphase returned {rc}")
    if launches < 1:
        fail("the photonphase run launched the z2_harmonics kernel "
             f"{launches} times")
    stages = json.loads(re.search(r"Stage seconds: (\{.*\})", out).group(1))
    if stages["device"] != "cuda":
        fail(f"photonphase ran on {stages['device']}")
    h_cli = float(re.search(r"Htest.*?: (\S+)", out).group(1))

    d = np.load(npz)
    phases, weights = d["phases"], d["weights"]
    if phases.shape != (n,) or not np.all(np.isfinite(phases)):
        fail(f"phases {phases.shape}, finite={np.isfinite(phases).all()}")
    dist = np.abs(np.mod(phases - PEAK + 0.5, 1.0) - 0.5)
    med = float(np.median(dist))
    if not med < 0.02:
        fail(f"median distance from the injected peak {med:.4f} >= 0.02")
    h_plain = plain_h(zmod, phases, weights, m, dev)
    if not abs(h_cli - h_plain) <= H_REL * max(1.0, h_plain):
        fail(f"H from the kernel path {h_cli} vs f64 plain {h_plain}")
    print(f"path: median peak distance {med:.5f} turns, H {h_cli:.2f} "
          f"(f64 plain {h_plain:.2f}), kernel launches {launches}")
    return {"launches": launches, "stages": stages, "h": h_cli,
            "kernels_ms": device_kernel_ms(prof)}


def plain_h(zmod, phases, weights, m: int, dev) -> float:
    """The weighted H-test from K1's float64 plain version on `dev`."""
    import torch

    ph = torch.as_tensor(phases, dtype=torch.float64, device=dev)
    w = torch.as_tensor(weights, dtype=torch.float64, device=dev)
    cs = zmod.z2_harmonics_plain(ph, w, m)
    terms = 2.0 * (cs[0] ** 2 + cs[1] ** 2) / torch.sum(w ** 2)
    ks = torch.arange(1, m + 1, dtype=torch.float64, device=dev)
    return float(torch.max(torch.cumsum(terms, 0) - 4.0 * ks + 4.0))


def device_kernel_ms(prof) -> dict:
    """{kernel name: device ms} from a CUDA-activity profile (empty
    without one): the device's own events (kernels, copies and sets)
    only. An operator's entry on the host side would carry the device
    time of the kernels it launched as well; the photon path's profile
    records no host activity, so there is none today."""
    import torch

    out = {}
    for e in (prof.key_averages() if prof is not None else ()):
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def phase_exact(dev, cols: dict, par: str, tmp: str,
                nsub: int = 65536) -> float:
    """GPU double-double phase == CPU phase on the first photons.
    Returns the seconds of this first (cold) GPU phase evaluation."""
    import torch

    from pint_tpu_torch.event_toas import load_fits_TOAs
    from pint_tpu_torch.models import get_model

    sub = os.path.join(tmp, "events_head.fits")
    write_events(sub, {k: v[:nsub] for k, v in cols.items()})
    model = get_model(par, device=dev)
    toas = load_fits_TOAs(sub, weightcolumn="WEIGHT", device=dev)
    model.get_cache(toas)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = model.phase(toas)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cpu = model.phase(toas, device="cpu")
    gi, gf = gpu.int.cpu().numpy(), gpu.frac.cpu().numpy()
    ci, cf = cpu.int.numpy(), cpu.frac.numpy()
    if not np.array_equal(gi, ci):
        fail(f"pulse numbers differ at {int(np.sum(gi != ci))} photons")
    dfrac = float(np.max(np.abs(gf - cf)))
    if not dfrac <= 1e-11:
        fail(f"GPU vs CPU frac phase differ by {dfrac:.3e} turns")
    print(f"dd chain: GPU == CPU on {toas.ntoas} photons "
          f"(int exact, max |dfrac| {dfrac:.3e} turns)")
    return cold_s


def h2d_ms(nbytes: int) -> float:
    """Median ms of one host→device copy of `nbytes` from pageable
    memory, as TOAs.to_batch makes it."""
    import torch

    host = torch.from_numpy(np.ones(nbytes // 8))
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.to("cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound(n: int, m: int, in_bytes: int) -> tuple:
    """(ms, "bytes" or "operations", bytes, ops): the least time an H100
    could take for the sums, reading `in_bytes` per photon and writing
    (2, m) float64, at m sine-cosines and 4m FMAs of 2 flops a photon."""
    nbytes = in_bytes * n + 16 * m
    ops = m * n + 2 * 4 * m * n
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes
            else "bytes", nbytes, ops)


def phase_registers(zmod, kc_main: int) -> dict:
    """ptxas's registers and spills of every instantiation (a spill
    fails); returns those of the photon path's (float64 inputs)."""
    rep = zmod.ptxas_report()
    if len(rep) != 32:
        fail(f"ptxas reported {len(rep)} of the 32 kernel instantiations")
    spills = sum(v["spill_stores"] + v["spill_loads"] for v in rep.values())
    for p, w in (("f", "f"), ("d", "d"), ("f", "d"), ("d", "f")):
        regs = " ".join(f"{kc}:{v['regs']}" for (pp, ww, kc), v in
                        sorted(rep.items()) if (pp, ww) == (p, w))
        print(f"ptxas registers, inputs {p}/{w}, by harmonics per block: "
              f"{regs}")
    print(f"ptxas spill bytes over all instantiations: {spills}")
    if spills:
        fail(f"the kernel spills {spills} bytes")
    return {"regs": rep[("d", "d", kc_main)]["regs"], "spill_bytes": spills}


def baseline_kernel(zmod, src: str):
    """A launcher of a kernel built from `src` with the earlier,
    float32-only interface (phi, w, n, m, partials, nblocks, out, device,
    stream) and its wrapper's grid, for timing beside this one."""
    import ctypes

    import torch

    zmod._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = str(zmod._BUILD_DIR / "z2_harmonics-baseline.so")
    subprocess.run([zmod._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, src], check=True, capture_output=True,
                   timeout=600)
    fn = ctypes.CDLL(so).z2_harmonics_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launch(ph, w, m):
        n = ph.shape[0]
        nblocks = max(1, min(-(-n // 256), 4 * sms))
        partials = torch.empty((nblocks, 2, m), dtype=torch.float32,
                               device=ph.device)
        out = torch.empty((2, m), dtype=torch.float64, device=ph.device)
        err = fn(ph.data_ptr(), w.data_ptr(), n, m, partials.data_ptr(),
                 nblocks, out.data_ptr(), ph.device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"baseline kernel launch failed: CUDA error {err}")
        return out

    return launch


# ------------------------------------------------------- the GLS fit path


def with_dmx(par_lines, span, ndmx: int) -> list:
    """`par_lines` plus `ndmx` free DMX windows tiling `span`."""
    par = list(par_lines)
    edges = np.linspace(*span, ndmx + 1)
    for i in range(ndmx):
        par += [f"DMX_{i + 1:04d} 0.0 1", f"DMXR1_{i + 1:04d} {edges[i]:.4f}",
                f"DMXR2_{i + 1:04d} {edges[i + 1]:.4f}"]
    return par


def clustered_mjds(span, ntoa: int) -> np.ndarray:
    """ntoa/4 observing epochs of four TOAs within 30 minutes, spread
    over the span (bench._clustered_mjds)."""
    centers = np.linspace(span[0] + 1, span[1] - 1, ntoa // 4)
    return (centers[:, None] + np.linspace(0.0, 0.021, 4)[None, :]).ravel()


def sim_toas(par_lines, mjds, freqs, seed: int, dev, flags: bool):
    """(par text, model, TOAs): bench._make_model_toas's recipe run by the
    port on `dev`: the model, TOAs simulated onto integer phase with a
    white draw from default_rng(seed), then (with `flags`) the -be X flag
    (after the draw, as there)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    par = "\n".join(par_lines) + "\n"
    model = get_model(io.StringIO(par), device=dev)
    toas = make_fake_toas_fromMJDs(mjds, model, error_us=1.0,
                                   freq_mhz=freqs, add_noise=True,
                                   rng=np.random.default_rng(seed))
    if flags:
        for f in toas.flags:
            f["be"] = "X"
    return par, model, toas


def fit_build(ntoa: int, ndmx: int, seed: int, dev, extra=()) -> tuple:
    """(par text, model, TOAs) of bench.build_problem(), built by the port
    on `dev`: FIT_PAR (and the `extra` lines) with ndmx free DMX windows
    tiling the span, clustered epochs, two bands, simulated onto integer
    phase with a white draw from default_rng(seed), then the -be/-grp
    flags set (after the draw, as there)."""
    freqs = np.tile([1400.0, 1400.0, 820.0, 820.0], ntoa // 4)
    par, model, toas = sim_toas(with_dmx(FIT_PAR + list(extra), FIT_SPAN,
                                         ndmx),
                                clustered_mjds(FIT_SPAN, ntoa), freqs, seed,
                                dev, flags=True)
    for i, f in enumerate(toas.flags):
        f["grp"] = f"g{i % 5}"
    return par, model, toas


def chi2_tol(chi2: float, dr, sigma, rel: float) -> float:
    """How far two chi2 = r^T C^-1 r may differ when their residual
    vectors differ by `dr`: `rel` of chi2 for the arithmetic, plus what
    dr itself moves (C >= diag(sigma^2), so by Cauchy-Schwarz
    |chi2(r + dr) - chi2(r)| <= 2 sqrt(chi2) |dr/sigma| + |dr/sigma|^2).
    sin/cos/log round differently on the card and on the CPU, so a few
    delays differ by 1 ulp (~6e-14 s)."""
    d = float(np.linalg.norm(np.asarray(dr) / np.asarray(sigma)))
    return rel * abs(chi2) + 2.0 * math.sqrt(abs(chi2)) * d + d * d


def step_diff(got, want) -> dict:
    """The largest differences of step outputs `got` from `want` (numpy
    arrays), in the units of the limits DP_SIGMA, COV_REL, CHI2_REL and
    RESID_S."""
    sig = np.sqrt(np.diag(want[1]))
    return {"dp_sigma": float(np.max(np.abs(got[0] - want[0]) / sig)),
            "cov_rel": float(np.max(np.abs(np.diag(got[1])
                                           - np.diag(want[1]))
                                    / np.diag(want[1]))),
            "chi2_rel": float(abs(got[2] - want[2]) / abs(want[2])),
            "resid_s": float(np.max(np.abs(got[3] - want[3])))}


def within_limits(d: dict) -> bool:
    return (d["dp_sigma"] <= DP_SIGMA and d["cov_rel"] <= COV_REL
            and d["chi2_rel"] <= CHI2_REL and d["resid_s"] <= RESID_S)


def chi2_of_residuals(model, toas, rs, wideband: bool = False) -> list:
    """The step's chi2 as a function of its time residuals alone, on the
    CPU, for each vector in `rs`: the rows of build_fit_parts (stacked
    over the CPU's DM residuals with `wideband`) with those time
    residuals, solved by the step's own _gls_core (the same quadratic
    form as the step's chi2: r^T C^-1 r, the noise bases marginalized)."""
    import torch

    from pint_tpu_torch.parallel import build_fit_parts
    from pint_tpu_torch.parallel.fit_step import SegmentSum, _gls_core

    parts_fn, args, _, meta = build_fit_parts(model, toas, device="cpu",
                                              wideband=wideband)
    M, Fv, r0, nvec, valid, eid, _ = parts_fn(*args)
    n = toas.ntoas
    plan = SegmentSum(eid, meta["nseg"]) if meta["nseg"] > 1 else None
    return [float(_gls_core(M, Fv, args[7],
                            torch.cat([torch.as_tensor(r), r0[n:]]), nvec,
                            valid, args[11], plan)[2]) for r in rs]


def fit_step_check(model, toas, dev, label: str = "fit-step",
                   hybrid: bool = True, explain_chi2: bool = False,
                   wideband: bool = False) -> dict:
    """The step on the GPU twice (bitwise equal) and on the CPU, held to
    DP_SIGMA, COV_REL, CHI2_REL and RESID_S; with `hybrid`, the
    all-jacfwd step on the GPU against the hybrid_jac=True one, to the
    same limits. `wideband` checks build_fit_step(wideband=True).

    With `explain_chi2`, CHI2_REL holds the part of the chi2 difference
    that the two steps' residuals do not explain (`chi2_rel_unexplained`;
    `chi2_rel` stays the raw relative difference): chi2 is a quadratic
    form P in the residuals, and the GPU's and the CPU's differ by ~1 ulp
    of the delays (~1e-13 s) TOA by TOA, which moves a chi2 of thousands
    by ~1e-9 of itself. P(r_gpu) - P(r_cpu), evaluated in one place (the
    CPU, with the step's own _gls_core: chi2_of_residuals, which must
    give the CPU step's chi2 at its residuals), is subtracted first."""
    from pint_tpu_torch.parallel import build_fit_step

    step, args, names = build_fit_step(model, toas, device=dev,
                                       wideband=wideband)
    g1 = [x.cpu().numpy() for x in step(*args)]
    g2 = [x.cpu().numpy() for x in step(*args)]
    for nm, a, b in zip(("dparams", "cov", "chi2", "resids"), g1, g2):
        if not np.array_equal(a.view(np.int64), b.view(np.int64)):
            fail(f"{label}: two GPU steps differ in {nm}")
    cstep, cargs, cnames = build_fit_step(model, toas, device="cpu",
                                          wideband=wideband)
    cstep(*cargs)
    t0 = time.perf_counter()
    c = [x.numpy() for x in cstep(*cargs)]
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if cnames != names:
        fail(f"{label}: CPU and GPU steps have other parameters")
    got = {**step_diff(g1, c), "chi2_gpu": float(g1[2]),
           "chi2_cpu": float(c[2]), "cpu_step_ms": cpu_ms}
    held = dict(got)
    if explain_chi2:
        pg, pc = chi2_of_residuals(model, toas, (g1[3], c[3]), wideband)
        moved = pg - pc
        # the function is the CPU step's own chi2 at its own residuals
        if not abs(pc - float(c[2])) <= 1e-12 * abs(float(c[2])):
            fail(f"{label}: chi2_of_residuals gives {pc!r} at the CPU "
                 f"step's residuals, the step {float(c[2])!r}")
        got["chi2_moved_by_resids"] = moved
        got["chi2_rel_unexplained"] = held["chi2_rel"] = \
            abs(float(g1[2]) - float(c[2]) - moved) / abs(float(c[2]))
        print(f"{label}: the residual difference moves chi2 by {moved:.6e} "
              f"(GPU - CPU {float(g1[2]) - float(c[2]):.6e}, "
              f"{got['chi2_rel']:.3e} relative); the rest, "
              f"{held['chi2_rel']:.3e} relative, is held to {CHI2_REL}")
    out = {"step": step, "args": args, "names": names,
           "sigma": dict(zip(names, np.sqrt(np.diag(g1[1])))), **got}
    print(f"{label}: GPU vs CPU max |d dparams| {got['dp_sigma']:.3e} sigma "
          f"(limit {DP_SIGMA}), cov diagonal {got['cov_rel']:.3e} relative "
          f"(limit {COV_REL}), chi2 {got['chi2_gpu']!r} vs "
          f"{got['chi2_cpu']!r}: {held['chi2_rel']:.3e} relative"
          f"{' unexplained' if explain_chi2 else ''} (limit "
          f"{CHI2_REL}), residuals {got['resid_s']:.3e} s (limit "
          f"{RESID_S}); two GPU steps bitwise equal; the CPU step took "
          f"{cpu_ms:.1f} ms (second call, host clock)")
    if not (within_limits(held) and np.all(np.isfinite(g1[0]))):
        fail(f"{label}: the GPU step disagrees with the CPU step")
    if not hybrid:
        return out
    hy_step, hy_args, hy_names = build_fit_step(model, toas, device=dev,
                                                hybrid_jac=True,
                                                wideband=wideband)
    hy = step_diff([x.cpu().numpy() for x in hy_step(*hy_args)], g1)
    print(f"{label}: hybrid step vs all-jacfwd step on the GPU: "
          f"|d dparams| {hy['dp_sigma']:.3e} sigma, cov diagonal "
          f"{hy['cov_rel']:.3e}, chi2 {hy['chi2_rel']:.3e} relative, "
          f"residuals {hy['resid_s']:.3e} s (the limits above)")
    if hy_names != names or not within_limits(hy):
        fail(f"{label}: the hybrid step disagrees with the all-jacfwd one")
    return {**out, "hy_step": hy_step, "hy_args": hy_args,
            "hybrid_vs_step": hy}


def profile_window(fn, n: int) -> tuple:
    """(profiler, wall ms, spans, work, launches) of `n` calls of `fn`
    ending in a synchronize: the device events split into the spans of
    annotations ({name: [(start, end)]}, the fit_step.* ranges) and work
    ([(start, end, name)]: kernels, copies and sets), and the kernel
    launches counted on the host."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, work, launches = {}, [], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tr = e.time_range
            if e.name.startswith("fit_step.") or \
                    getattr(e, "is_user_annotation", False):
                spans.setdefault(e.name, []).append((tr.start, tr.end))
            else:
                work.append((tr.start, tr.end, e.name))
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    return prof, wall_ms, spans, work, launches


def busy_us(work) -> float:
    """Microseconds of the union of the (start, end, name) device
    intervals: overlapping streams count once."""
    total, end = 0.0, None
    for a, b, _ in sorted(work):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_busy(fn, label: str) -> dict:
    """One call of `fn` under the profiler: its wall, device busy time
    (the union of the intervals of kernels, copies and sets), idle share
    and kernel launches."""
    _, wall_ms, _, work, launches = profile_window(fn, 1)
    out = {"wall_ms": wall_ms, "busy_ms": None, "idle_share": None,
           "launches": launches}
    if not work:
        print(f"{label}: {launches} kernel launches; device busy not "
              "measured (the profiler recorded no device time)")
        return out
    busy = busy_us(work) / 1e3
    out.update(busy_ms=busy, idle_share=1 - busy / wall_ms)
    print(f"{label}: profiled call {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {out['idle_share']:.4f}), "
          f"{launches} kernel launches")
    return out


def fit_time(step, args, label: str, reps: int = 10) -> dict:
    """Host-clock and CUDA-event times of `reps` steps, then a profiler
    window of one step: device-busy share, launches per step, device time
    by stage (the fit_step.* spans) and by operation. One step, since
    reading the profiler's trace of a step takes seconds."""
    import torch

    for _ in range(3):
        step(*args)
    torch.cuda.synchronize()
    host, dev_ms = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        step(*args)
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(a.elapsed_time(b))
    out = {"host_ms": [float(np.median(host)), min(host), max(host)],
           "event_ms": [float(np.median(dev_ms)), min(dev_ms),
                        max(dev_ms)]}
    print(f"fit-time, {label}: {out['host_ms'][0]:.3f} ms median of "
          f"{reps} on the host clock to synchronize (min "
          f"{out['host_ms'][1]:.3f}, "
          f"max {out['host_ms'][2]:.3f}); {out['event_ms'][0]:.3f} ms "
          f"between CUDA events (min {out['event_ms'][1]:.3f}, max "
          f"{out['event_ms'][2]:.3f})")
    nsteps = 1
    prof, wall_ms, spans, work, launches = profile_window(
        lambda: step(*args), nsteps)
    busy = busy_us(work)
    out["busy_share"] = busy / 1e3 / wall_ms if work else None
    out["launches_per_step"] = launches / nsteps
    out["window_ms"] = wall_ms / nsteps
    stages = {}
    for name, ranges in spans.items():
        span = sum(b - a for a, b in ranges)
        inside = sum(b - a for a, b, _ in work
                     if any(lo <= a < hi for lo, hi in ranges))
        stages[name] = (inside / 1e3 / nsteps, span / 1e3 / nsteps)
    out["stages_ms"] = {k: v[0] for k, v in stages.items()}
    out["stage_spans_ms"] = {k: v[1] for k, v in stages.items()}
    ops = {}
    for e in prof.key_averages():
        sdt = getattr(e, "self_device_time_total", None)
        if sdt is None:
            sdt = getattr(e, "self_cuda_time_total", 0.0)
        if e.key.startswith("aten::") and sdt:
            ops[e.key] = sdt / 1e3 / nsteps
    out["top_ops_ms"] = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:10])
    kernels = {}
    for _, _, name in work:
        kernels[name] = kernels.get(name, 0) + 1
    if work:
        print(f"fit-time, {label}: a {nsteps}-step profiler window, "
              f"{out['window_ms']:.3f} ms a step: device busy "
              f"{busy / 1e3 / nsteps:.3f} ms a step (kernels, copies "
              f"and sets), busy share {out['busy_share']:.4f} (idle share "
              f"{1 - out['busy_share']:.4f}); "
              f"{out['launches_per_step']:.0f} kernel launches a step")
        for k, (ms, span) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
            print(f"  stage {k:28s} {ms:9.3f} ms device busy in a "
                  f"{span:9.3f} ms span, a step")
        for k, ms in out["top_ops_ms"].items():
            print(f"  op    {k:28s} {ms:9.3f} ms device a step")
    else:
        print(f"fit-time, {label}: {out['launches_per_step']:.0f} kernel "
              "launches a step; device busy share not measured (the "
              "profiler recorded no device time)")
    return out


def fit_downhill(par: str, toas, dev, label: str = "fit-downhill",
                 fitter=None, tim: str = None) -> dict:
    """`fitter` (DownhillGLSFitter by default) to convergence on the GPU
    and on the CPU from the par's values: the same optimum. With `tim`,
    `par` and `tim` are files read by get_model_and_toas (the GPU side
    with no device given: the default) and the fitter is Fitter.auto's,
    which must be a `fitter` on the device asked for."""
    import torch

    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.gls import DownhillGLSFitter
    from pint_tpu_torch.models import get_model, get_model_and_toas

    res = {}
    for tag, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        if tim is None:
            m = get_model(io.StringIO(par), device=d)
            f = (fitter or DownhillGLSFitter)(toas, m)
        else:
            m, t = get_model_and_toas(par, tim,
                                      device=None if tag == "gpu" else d)
            f = Fitter.auto(t, m)
            if type(f) is not fitter or f.device.type != d.type:
                fail(f"{label}: Fitter.auto gave a {type(f).__name__} on "
                     f"{f.device}, not a {fitter.__name__} on {d.type}")
        t0 = time.perf_counter()
        chi2 = f.fit_toas()
        if d.type == "cuda":
            torch.cuda.synchronize()
        res[tag] = (f, chi2, time.perf_counter() - t0)
    (fg, cg, tg), (fc, cc, tc) = res["gpu"], res["cpu"]
    dev_sigma = max(abs(fg.model.get_param(n).value
                        - fc.model.get_param(n).value) / fc.errors[n]
                    for n in fc.model.free_params)
    dr = fg.resids.time_resids.cpu().numpy() - \
        fc.resids.time_resids.numpy()
    tol = chi2_tol(cc, dr, fc.model.scaled_toa_uncertainty(fc.toas),
                   CHI2_REL)
    print(f"{label}: {type(fg).__name__} on {fg.device}: "
          f"{fg.stats.iterations} iterations in "
          f"{tg:.3f} s, chi2 {cg!r}; CPU {fc.stats.iterations} iterations "
          f"in {tc:.3f} s, chi2 {cc!r}; parameters within "
          f"{dev_sigma:.3e} sigma (limit {DP_SIGMA}), chi2 "
          f"{abs(cg - cc) / abs(cc):.3e} relative (limit "
          f"{tol / abs(cc):.3e})")
    if not (fg.converged and fc.converged and dev_sigma <= DP_SIGMA
            and abs(cg - cc) <= tol
            and fg.stats.iterations == fc.stats.iterations):
        fail(f"{label}: the GPU fit does not reach the CPU optimum")
    return {"iterations": fg.stats.iterations, "gpu_s": tg, "cpu_s": tc,
            "chi2": cg, "dp_sigma": dev_sigma, "fitter": fg,
            "cpu_fitter": fc}


def fit_pintempo(tmp: str) -> dict:
    """The pintempo CLI on NGC6440E on the GPU and on the CPU: the same
    fit (F0 within 1e-6 sigma; the CPU fit is held to the reference's in
    tests/test_torch_fit.py), F0 within 3 sigma of the par file's."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.scripts import pintempo

    f0, wall = {}, {}
    for tag in ("cuda", "cpu"):
        out = os.path.join(tmp, f"ngc6440e_post_{tag}.par")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = pintempo.main([*NGC, "--outfile", out, "--device", tag])
        wall[tag] = time.perf_counter() - t0
        text = buf.getvalue()
        if tag == "cuda":
            print(text, end="")
        if rc != 0 or f"on {tag}" not in text:
            fail(f"pintempo returned {rc} or did not run on {tag}")
        f0[tag] = get_model(out, device="cpu").F0
    f0_par = get_model(NGC[0], device="cpu").F0
    g, c = f0["cuda"], f0["cpu"]
    par_sigma = abs(g.value - f0_par.value) / g.uncertainty
    cpu_sigma = abs(g.value - c.value) / c.uncertainty
    print(f"pintempo: {wall['cuda']:.3f} s on the GPU, {wall['cpu']:.3f} s "
          f"on the CPU; fitted F0 {g.value!r} +- {g.uncertainty:.3e} Hz: "
          f"{cpu_sigma:.3e} sigma from the CPU fit's, {par_sigma:.3f} sigma "
          f"from the par file's {f0_par.value!r}")
    if not (cpu_sigma <= DP_SIGMA and par_sigma <= 3.0):
        fail("pintempo: the GPU fit of F0 disagrees with the CPU fit or "
             "with the par file")
    return {"wall_s": wall["cuda"], "cpu_wall_s": wall["cpu"],
            "f0_par_sigma": par_sigma, "f0_cpu_sigma": cpu_sigma}


# ------------------------------------------------------ the binary path


def b1855_build(ntoa: int, ndmx: int, dev) -> tuple:
    """bench.config2_b1855like()'s model and TOAs: ntoa/4 four-TOA
    clusters over the span at 1400/430 MHz, ndmx free DMX windows,
    seed 2."""
    freqs = np.tile([1400.0, 1400.0, 430.0, 430.0], ntoa // 4)
    return sim_toas(with_dmx(B1855_PAR, B1855_SPAN, ndmx),
                    clustered_mjds(B1855_SPAN, ntoa), freqs, 2, dev,
                    flags=True)


def dd_twin(par: str) -> str:
    """The config-2 par with its ELL1 orbit rewritten as the DD orbit it
    approximates (ECC, OM and T0 from EPS1, EPS2 and TASC), for the cost
    of kepler_E in the step."""
    lines, keep = {}, []
    for ln in par.splitlines():
        key = ln.split()[0] if ln.split() else ""
        if key in ("BINARY", "TASC", "EPS1", "EPS2"):
            lines[key] = ln.split()
        else:
            keep.append(ln)
    e1, e2 = float(lines["EPS1"][1]), float(lines["EPS2"][1])
    om = math.degrees(math.atan2(e1, e2)) % 360.0
    pb = next(float(ln.split()[1]) for ln in keep if ln.startswith("PB "))
    t0 = float(lines["TASC"][1]) + om / 360.0 * pb
    return "\n".join(keep + ["BINARY DD", f"T0 {t0!r} 1",
                             f"ECC {math.hypot(e1, e2)!r} 1",
                             f"OM {om!r} 1"]) + "\n"


def binary_downhill(par: str, toas, sigma: dict, dev) -> dict:
    """DownhillGLSFitter from B1855_OFFSET moved 3 sigma (of the step at
    the truth) away, on the GPU and on the CPU (fit_downhill's limits);
    every fitted parameter within 3 of its sigma of the simulated
    truth."""
    from pint_tpu_torch.models import get_model

    start = get_model(io.StringIO(par), device="cpu")
    for i, nm in enumerate(B1855_OFFSET):
        start.get_param(nm).add_delta((3.0 if i % 2 == 0 else -3.0)
                                      * float(sigma[nm]))
    out = fit_downhill(start.as_parfile(), toas, dev, "binary-downhill")
    out.pop("cpu_fitter")
    fitted, truth = out.pop("fitter"), get_model(io.StringIO(par),
                                                 device="cpu")
    dev_truth = {nm: abs(fitted.model.get_param(nm).value
                         - truth.get_param(nm).value) / fitted.errors[nm]
                 for nm in truth.free_params}
    worst = max(dev_truth, key=dev_truth.get)
    print(f"binary-downhill: from {', '.join(B1855_OFFSET)} 3 sigma off; "
          f"fitted parameters within {dev_truth[worst]:.3f} sigma of the "
          f"simulated truth ({worst}; limit 3), "
          + ", ".join(f"{nm} {dev_truth[nm]:.3f}" for nm in B1855_OFFSET))
    if dev_truth[worst] > 3.0:
        fail(f"binary-downhill: {worst} fitted {dev_truth[worst]:.3f} sigma "
             "from the simulated truth")
    return {**out, "truth_sigma_max": dev_truth[worst],
            "truth_sigma": {nm: dev_truth[nm] for nm in B1855_OFFSET}}


def binary_zoo(ntoa: int, dev) -> dict:
    """Every registered binary on a J1012+5307-like par at `ntoa` GBT
    TOAs: the GPU total delay against the CPU's (ZOO_DELAY_S) and the
    GPU design matrix against the CPU's (ZOO_DESIGN_REL of each column's
    largest entry). Runs kepler_E on the card for each Keplerian
    family."""
    import torch

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs_array

    rng = np.random.default_rng(7)
    mjds = np.sort(rng.uniform(54100.0, 55900.0, ntoa))
    toas = get_TOAs_array(mjds, obs="gbt",
                          freqs=np.tile([1400.0, 820.0], ntoa // 2),
                          errors=1.0, device=dev)
    worst = {"delay_s": 0.0, "design_rel": 0.0}
    per = {}
    for name, orbit in ZOO.items():
        par = "\n".join(ZOO_BASE + [f"BINARY {name}"] + orbit) + "\n"
        model = get_model(io.StringIO(par), device=dev)
        want = f"BINARY{name.replace('_', '')}".upper()
        if not any(c.upper() == want for c in model.components):
            fail(f"binary-zoo: BINARY {name} built {list(model.components)}")
        t0 = time.perf_counter()
        dg = model.delay(toas)
        Mg, names, _ = model.designmatrix(toas)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        dc = model.delay(toas, device="cpu")
        Mc, cnames, _ = model.designmatrix(toas, device="cpu")
        d_err = float(torch.max(torch.abs(dg.cpu() - dc)))
        Mc = Mc.numpy()
        m_err = float(np.max(np.max(np.abs(Mg.cpu().numpy() - Mc), axis=0)
                             / np.max(np.abs(Mc), axis=0)))
        ok = (names == cnames and np.all(np.isfinite(Mc))
              and d_err <= ZOO_DELAY_S and m_err <= ZOO_DESIGN_REL)
        print(f"binary-zoo {name:12s}: GPU vs CPU delay {d_err:.3e} s (limit "
              f"{ZOO_DELAY_S}), design matrix {m_err:.3e} of each column's "
              f"largest (limit {ZOO_DESIGN_REL}), {len(names)} columns; GPU "
              f"delay + design matrix {gpu_s:.3f} s")
        if not ok:
            fail(f"binary-zoo: BINARY {name} differs between GPU and CPU")
        per[name] = {"delay_s": d_err, "design_rel": m_err, "gpu_s": gpu_s}
        worst = {"delay_s": max(worst["delay_s"], d_err),
                 "design_rel": max(worst["design_rel"], m_err)}
    return {"ntoa": ntoa, "worst": worst, "models": per}


def fullcov(dev, n: int = 2000) -> dict:
    """bench.config4_j0613like_fullcov()'s problem (2,000 TOAs, 15
    red-noise modes, seed 4): one full_cov solve on the GPU against the
    same solve on the CPU (FULLCOV_REL of |x| + sigma, chi2 FULLCOV_REL
    relative), and against the GPU basis-Woodbury solve (the reference's
    test limits); both solves timed by cuda_ms, one call a sleep."""
    from pint_tpu_torch.gls import _gls_kernel, _gls_kernel_fullcov
    from pint_tpu_torch.residuals import Residuals

    rng = np.random.default_rng(4)
    mjds = np.sort(rng.uniform(53000, 56000, n))
    _, model, toas = sim_toas(J0613_PAR, mjds, np.tile([1400.0, 820.0],
                                                       n // 2), 4, dev,
                              flags=False)
    M, _, _ = model.designmatrix(toas)
    r = Residuals(toas, model).time_resids
    nvec, F, phi = model.noise_device(toas)
    args = (M, F, phi, r, nvec)
    g = [x.cpu().numpy() for x in _gls_kernel_fullcov(*args)]
    c = [x.numpy() for x in _gls_kernel_fullcov(*(x.cpu() for x in args))]
    sig = np.sqrt(np.diag(c[1]))
    dx = float(np.max(np.abs(g[0] - c[0]) / (np.abs(c[0]) + sig)))
    dchi2 = abs(float(g[2]) - float(c[2])) / abs(float(c[2]))
    w = [x.cpu().numpy() for x in _gls_kernel(*args)]
    w_ok = bool(w[5]) and np.allclose(g[0], w[0], rtol=WOODBURY_RTOL,
                                      atol=WOODBURY_ATOL) and \
        np.isclose(float(g[2]), float(w[2]), rtol=WOODBURY_RTOL, atol=0.0)
    wx = float(np.max(np.abs(g[0] - w[0]) / (WOODBURY_ATOL
                                             + WOODBURY_RTOL * np.abs(w[0]))))
    wchi2 = abs(float(g[2]) - float(w[2])) / abs(float(w[2]))
    t_full = cuda_ms(lambda: _gls_kernel_fullcov(*args), per_sleep=1)
    t_wood = cuda_ms(lambda: _gls_kernel(*args), per_sleep=1)
    print(f"fullcov: N = {n}, p = {M.shape[1]}, q = {F.shape[1]}; GPU vs CPU "
          f"dense solve |dx| {dx:.3e} of |x| + sigma (limit {FULLCOV_REL}), "
          f"chi2 {dchi2:.3e} relative (limit {FULLCOV_REL}); dense vs "
          f"Woodbury on the GPU: dx {wx:.3e} of (atol {WOODBURY_ATOL} + rtol "
          f"{WOODBURY_RTOL} |x|) (limit 1), chi2 {wchi2:.3e} relative (limit "
          f"{WOODBURY_RTOL}); dense solve {fmt(t_full)}; Woodbury "
          f"{fmt(t_wood)} (cuda_ms: device time, host enqueue hidden)")
    if not (np.all(np.isfinite(g[0])) and dx <= FULLCOV_REL
            and dchi2 <= FULLCOV_REL and w_ok):
        fail("fullcov: the dense solve disagrees")
    return {"ntoa": n, "dx_rel": dx, "chi2_rel": dchi2,
            "vs_woodbury_dx": wx, "vs_woodbury_chi2_rel": wchi2,
            "fullcov_ms": t_full, "woodbury_ms": t_wood}


# ------------------------------------------------------ the wideband path


def set_dm_flags(toas, dm, dme) -> None:
    """-pp_dm/-pp_dme on every TOA, from per-TOA values."""
    for f, v, e in zip(toas.flags, dm, dme):
        # repr(float(...)): numpy's scalar repr does not parse back
        f["pp_dm"], f["pp_dme"] = repr(float(v)), repr(float(e))


def config3_build(ntoa: int, ndmx: int, dev) -> tuple:
    """(truth par text, model, TOAs) of bench.config3_j1713like_wideband()
    on `dev`: MJDs drawn from default_rng(3), 1400/2100 MHz, TOAs
    simulated from seed 3 with -be X, then -pp_dm drawn from the same
    generator after the MJDs (15.99 + N(0, 1e-4), -pp_dme 1e-4), and F0
    moved by 5e-11 Hz, as there."""
    rng = np.random.default_rng(3)
    mjds = np.sort(rng.uniform(*CONFIG3_SPAN, ntoa))
    par, model, toas = sim_toas(with_dmx(CONFIG3_PAR, CONFIG3_SPAN, ndmx),
                                mjds, np.tile([1400.0, 2100.0], ntoa // 2),
                                3, dev, flags=True)
    set_dm_flags(toas, [15.99 + rng.normal(0, 1e-4) for _ in range(ntoa)],
                 [1e-4] * ntoa)
    model.F0.value += 5e-11
    model.invalidate_cache(params_only=True)
    return par, model, toas


def wideband_twin_build(ntoa: int, ndmx: int, dev) -> tuple:
    """(par text, model, TOAs): the fit path's problem with WB_TWIN_EXTRA
    and bench_stress.attach_wideband_dm's DM measurements: quoted sigma
    2e-4, drawn from default_rng(17) around the model DM with the
    DMEFAC/DMEQUAD-scaled sigma."""
    par, model, toas = fit_build(ntoa, ndmx, 1, dev, extra=WB_TWIN_EXTRA)
    dm = model.total_dm(toas).cpu().numpy()
    set_dm_flags(toas, np.zeros(ntoa), np.full(ntoa, 2e-4))
    sig = model.scaled_dm_uncertainty(toas)
    rng = np.random.default_rng(17)
    set_dm_flags(toas, [dm[i] + rng.normal(0.0, sig[i]) for i in range(ntoa)],
                 np.full(ntoa, 2e-4))
    return par, model, toas


def write_toas_tim(toas, path: str) -> None:
    """`toas` as a .tim file: each TOA's site-clock MJD (the clock
    correction taken back out, as the reference's write_TOA_file does) to
    20 digits of its day fraction (1e-20 d), its frequency, error, site
    and flags."""
    from pint_tpu_torch.io import TimTOA, write_tim
    from pint_tpu_torch.ops import dd_np
    from pint_tpu_torch.time.mjd import mjd_to_str

    corr = np.array([float(f.get("clkcorr", 0.0)) for f in toas.flags])
    fhi, flo = dd_np.sub(toas.mjd_frac,
                         dd_np.div_f(dd_np.dd(corr), 86400.0))
    write_tim(path, [
        TimTOA(mjd_to_str(toas.mjd_day[i], (fhi[i], flo[i]), 20),
               float(toas.freq_mhz[i]), float(toas.error_us[i]),
               toas.obs[i], toas.names[i],
               {k: v for k, v in toas.flags[i].items() if k != "clkcorr"})
        for i in range(toas.ntoas)])


def dd_sum_check(dev) -> dict:
    """ops.dd.dd_sum on the card on tests/test_torch_dd.py's inputs (400
    values of +-1e10 with their low words, whole and along each axis of
    a 20 x 20 view), and on DD_SUM_BIG such values whole, against the
    exact sum, within DD_SUM_REL of sum |hi|."""
    from fractions import Fraction

    import torch

    from pint_tpu_torch.ops import dd as tdd

    rng = np.random.default_rng(52)
    hi = rng.uniform(-1e10, 1e10, 400)
    lo = hi * rng.uniform(-1e-17, 1e-17, 400)
    m = (hi.reshape(20, 20), lo.reshape(20, 20))
    worst = 0.0
    for axis in (None, 0, 1):
        t = tdd.dd_sum(tdd.DD(*(torch.as_tensor(x, device=dev) for x in m)),
                       axis=axis)
        got_hi, got_lo = (np.atleast_1d(v.cpu().numpy()) for v in t)
        cols = [(m[0].ravel(), m[1].ravel())] if axis is None else \
            [(np.take(m[0], j, axis=1 - axis),
              np.take(m[1], j, axis=1 - axis)) for j in range(20)]
        for j, (h, low) in enumerate(cols):
            exact = sum(Fraction(float(v)) for v in np.concatenate([h, low]))
            err = abs(float(Fraction(float(got_hi[j]))
                            + Fraction(float(got_lo[j])) - exact))
            worst = max(worst, err / float(np.sum(np.abs(h))))
    # the whole-array sum of DD_SUM_BIG values, where the card's scan
    # spans many blocks; exact in integers of 2^-1074
    def exact(values):
        total = 0
        for v in values:
            num, den = float(v).as_integer_ratio()
            total += num << (1074 - (den.bit_length() - 1))
        return total

    hi = rng.uniform(-1e10, 1e10, DD_SUM_BIG)
    lo = hi * rng.uniform(-1e-17, 1e-17, DD_SUM_BIG)
    t = tdd.dd_sum(tdd.DD(*(torch.as_tensor(x, device=dev)
                            for x in (hi, lo))))
    got = exact([float(t.hi), float(t.lo)])
    big = float(Fraction(abs(got - exact(np.concatenate([hi, lo]).tolist())),
                         1 << 1074)) / float(np.sum(np.abs(hi)))
    print(f"dd-sum: dd_sum on {dev} within {worst:.3e} of sum |x| of the "
          f"exact sum at 400 values, {big:.3e} at {DD_SUM_BIG} (limit "
          f"{DD_SUM_REL})")
    if not max(worst, big) <= DD_SUM_REL:
        fail(f"dd-sum: dd_sum on the card is {max(worst, big):.3e} of "
             "sum |x| from the exact sum")
    return {"rel_err": worst, "rel_err_big": big, "n_big": DD_SUM_BIG}


# ------------------------------------- the device fit and the streaming GLS


def nu_inf_check(dev, tmp: str) -> dict:
    """NGC6440E's par without TZRFRQ (the TZR TOA at nu = inf) with its
    .tim: the design matrix on the card is finite, and Fitter.auto's fit
    on the card reaches the CPU's F0 (DP_SIGMA)."""
    import torch

    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.models import get_model_and_toas

    with open(NGC[0]) as f:
        text = re.sub(r"(?m)^TZRFRQ.*\n", "", f.read())
    par = os.path.join(tmp, "ngc6440e_no_tzrfrq.par")
    with open(par, "w") as f:
        f.write(text)
    res = {}
    for tag, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        m, t = get_model_and_toas(par, NGC[1], device=d)
        M = m.designmatrix(t)[0]
        finite = bool(torch.all(torch.isfinite(M)))
        fit = Fitter.auto(t, m)
        t0 = time.perf_counter()
        chi2 = fit.fit_toas()
        res[tag] = (finite, fit, chi2, time.perf_counter() - t0)
    (fin_g, fg, cg, tg), (fin_c, fc, cc, _) = res["gpu"], res["cpu"]
    f0_sigma = abs(fg.model.F0.value - fc.model.F0.value) / \
        fc.model.F0.uncertainty
    print(f"nu-inf: NGC6440E without TZRFRQ: design matrix finite on the "
          f"GPU {fin_g} (CPU {fin_c}); {type(fg).__name__} on {fg.device} "
          f"in {tg:.3f} s, chi2 {cg!r} (CPU {cc!r}); F0 {fg.model.F0.value!r}"
          f", {f0_sigma:.3e} sigma from the CPU fit's (limit {DP_SIGMA})")
    if not (fin_g and fin_c and fg.converged and fc.converged
            and fg.device.type == dev.type and f0_sigma <= DP_SIGMA):
        fail("nu-inf: the fit without TZRFRQ is not finite or disagrees "
             "with the CPU")
    return {"finite": fin_g, "gpu_s": tg, "chi2": cg, "f0_sigma": f0_sigma}


def stress_build(ntoa: int, ndmx: int, dev, dm_noise: bool = True) -> tuple:
    """(model, TOAs, truth) of bench_stress.build_stress_problem() on
    `dev`: clustered epochs over STRESS_SPAN, four sub-bands per cluster
    with +-6 % channel jitter and the receiver flags set before the draw,
    0.3 us errors, white and correlated noise from default_rng(7); then F0
    moved 3e-11 Hz and JUMP1 2e-7 s, as there."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    par = STRESS_PAR + (STRESS_DM_NOISE if dm_noise else [])
    par = "\n".join(with_dmx(par, STRESS_SPAN, ndmx)) + "\n"
    model = get_model(io.StringIO(par), device=dev)
    rng = np.random.default_rng(7)
    mjds = clustered_mjds(STRESS_SPAN, ntoa)
    freqs = (np.tile([430.0, 820.0, 1400.0, 2100.0], ntoa // 4)
             * (1.0 + rng.uniform(-0.06, 0.06, ntoa)))
    flags = [{"be": RECEIVERS[(i // 4) % len(RECEIVERS)]}
             for i in range(ntoa)]
    toas = make_fake_toas_fromMJDs(mjds, model, error_us=0.3,
                                   freq_mhz=freqs, add_noise=True,
                                   add_correlated_noise=True, rng=rng,
                                   flags=flags)
    truth = {"F0": model.F0.value, "PB": model.PB.value}
    model.F0.add_delta(3e-11)
    model.get_param("JUMP1").value += 2e-7
    model.invalidate_cache(params_only=True)
    return model, toas, truth


def attach_wideband_dm(model, toas) -> None:
    """bench_stress.attach_wideband_dm: -pp_dme 2e-4 on every TOA and
    -pp_dm the model DM plus a draw at the DMEFAC/DMEQUAD-scaled sigma
    from default_rng(17)."""
    dm = model.total_dm(toas).cpu().numpy()
    set_dm_flags(toas, np.zeros(toas.ntoas), np.full(toas.ntoas, 2e-4))
    sig = model.scaled_dm_uncertainty(toas)
    rng = np.random.default_rng(17)
    set_dm_flags(toas, [dm[i] + rng.normal(0.0, sig[i])
                        for i in range(toas.ntoas)],
                 np.full(toas.ntoas, 2e-4))


def step_ms(model, toas, dev, wideband: bool, label: str,
            reps: int = 5) -> tuple:
    """(median host ms of the eager fit step to synchronize, its
    device_busy record)."""
    import torch

    from pint_tpu_torch.parallel import build_fit_step

    step, args, _ = build_fit_step(model, toas, device=dev,
                                   wideband=wideband)
    step(*args)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), device_busy(lambda: step(*args),
                                             f"{label}, one eager step")


def device_fit_check(model, toas, truth, dev, label: str,
                     wideband: bool = False, maxiter: int = 12,
                     keep: dict = None) -> dict:
    """DeviceDownhillGLSFitter.fit_toas(maxiter) on the card, one step a
    trial and whole_fit=True, after a warm-up fit on a copy of the model
    (as bench_stress runs it), each held to the host downhill fitter
    (DownhillGLSFitter, or WidebandDownhillFitter with `wideband`) on the
    card: parameters within DP_SIGMA, chi2 within DEVICE_FIT_CHI2_REL of
    the step's chi2 at the host optimum; F0 within STRESS_TRUTH_SIGMA of
    the truth. `keep` receives the start par and each fit's parameter
    values (phase 16 refits them armed)."""
    import copy

    import torch

    from pint_tpu_torch.gls import DeviceDownhillGLSFitter, DownhillGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import build_fit_step
    from pint_tpu_torch.wideband_fitter import WidebandDownhillFitter, \
        WidebandTOAFitter

    start = model.as_parfile()
    start_model = copy.deepcopy(model) if keep is not None else None
    warm = get_model(io.StringIO(start), device=dev)
    t0 = time.perf_counter()
    DeviceDownhillGLSFitter(toas, warm, wideband=wideband).fit_toas(
        maxiter=maxiter)
    warm_s = time.perf_counter() - t0
    models = {k: copy.deepcopy(model) for k in ("whole", "host")}
    runs = {}
    for tag, m, kw in (("step", model, {}),
                       ("whole", models["whole"], {"whole_fit": True})):
        fit = DeviceDownhillGLSFitter(toas, m, wideband=wideband)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chi2 = fit.fit_toas(maxiter=maxiter, **kw)
        torch.cuda.synchronize()
        runs[tag] = (fit, chi2, time.perf_counter() - t0)
        if keep is not None:
            keep[tag] = [m.get_param(n).value for n in m.free_params]
    if keep is not None:
        keep.update(start=start, maxiter=maxiter, model=start_model)
    host_cls = WidebandDownhillFitter if wideband else DownhillGLSFitter
    hfit = host_cls(toas, models["host"])
    t0 = time.perf_counter()
    hchi2 = hfit.fit_toas(maxiter=maxiter)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    eager_ms, eager_busy = step_ms(model, toas, dev, wideband, label)
    # the host fitter's chi2 weighs the residuals' mean by the raw TOA
    # errors (Residuals), the step's by the EFAC/EQUAD-scaled ones, as in
    # the reference; with a white-noise model per receiver they differ,
    # so the device fit's chi2 is held to the step's at the host optimum
    hstep, hargs, _ = build_fit_step(models["host"], toas, device=dev,
                                     wideband=wideband)
    h_step_chi2 = float(hstep(*hargs)[2])
    out = {"ntoa": toas.ntoas, "nfree": len(model.free_params),
           "warmup_s": warm_s, "eager_step_ms": eager_ms,
           "eager_step_profile": eager_busy,
           "host_fitter": host_cls.__name__, "host_s": host_s,
           "host_iterations": hfit.stats.iterations, "host_chi2": hchi2,
           "host_step_chi2": h_step_chi2}
    ok = True
    for tag, (fit, chi2, wall) in runs.items():
        # the fit's last stage, the host refresh of residuals and noise
        # at the optimum (a design matrix and a solve), timed alone so
        # that the trials' share of the wall can be read
        t0 = time.perf_counter()
        (WidebandTOAFitter(toas, fit.model) if wideband
         else fit)._solve_once()
        torch.cuda.synchronize()
        refresh = time.perf_counter() - t0
        dp_sigma = max(abs(fit.model.get_param(n).value
                           - hfit.model.get_param(n).value)
                       / hfit.errors[n] for n in model.free_params)
        chi2_rel = abs(chi2 - h_step_chi2) / abs(h_step_chi2)
        # the gap the two chi2 weightings leave, recorded, not gated
        host_chi2_rel = abs(chi2 - hchi2) / abs(hchi2)
        truth_sigma = abs(fit.model.F0.value - truth["F0"]) / \
            fit.model.F0.uncertainty
        per_eval = (wall - refresh) * 1e3 / fit.step_evals
        out[tag] = {"wall_s": wall, "iterations": fit.stats.iterations,
                    "step_evals": fit.step_evals, "refresh_s": refresh,
                    "ms_per_eval": per_eval,
                    "chi2": chi2, "dof": fit.stats.dof,
                    "dp_sigma_vs_host": dp_sigma, "chi2_rel_vs_host": chi2_rel,
                    "host_chi2_rel": host_chi2_rel,
                    "f0_truth_sigma": truth_sigma,
                    "converged": fit.converged}
        print(f"{label}, {tag}: {fit.stats.iterations} iterations, "
              f"{fit.step_evals} step evaluations in {wall:.3f} s, of "
              f"which the final host refresh {refresh:.3f} s "
              f"({per_eval:.1f} ms an evaluation without it; eager step "
              f"{eager_ms:.1f} ms), chi2 {chi2!r} (dof {fit.stats.dof}); "
              f"against {host_cls.__name__} on {hfit.device} "
              f"({hfit.stats.iterations} iterations, {host_s:.3f} s): "
              f"parameters {dp_sigma:.3e} sigma (limit {DP_SIGMA}), chi2 "
              f"{chi2_rel:.3e} relative to the step's at the host optimum "
              f"(limit {DEVICE_FIT_CHI2_REL}; the host fitter's own chi2 "
              f"{hchi2!r}, {host_chi2_rel:.3e} relative); F0 "
              f"{truth_sigma:.3f} sigma from the truth (limit "
              f"{STRESS_TRUTH_SIGMA})")
        ok = ok and (fit.converged and dp_sigma <= DP_SIGMA
                     and chi2_rel <= DEVICE_FIT_CHI2_REL
                     and truth_sigma <= STRESS_TRUTH_SIGMA
                     and fit.device.type == torch.device(dev).type)
    print(f"{label}: warm-up fit {warm_s:.3f} s; N = {toas.ntoas}, "
          f"{len(model.free_params)} free parameters")
    if not (ok and hfit.converged):
        fail(f"{label}: the device fit does not reach the host fit or the "
             "truth")
    return out


def graph_step_check(step, args, names, label: str, reps: int = 10) -> dict:
    """One step captured into a torch.cuda.CUDAGraph with (th, tl) in
    static buffers copied in before each replay: the replayed outputs
    bitwise equal to the eager step's at the entry point and at a second
    point (the step's own correction applied); replay timed on the host
    clock (copies, replay, synchronize) and between CUDA events, and the
    eager step the same way in the same run."""
    import torch

    from pint_tpu_torch.ops.dd import dd, dd_add

    th, tl = args[0].clone(), args[1].clone()
    rest = args[2:]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step(th, tl, *rest)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = step(th, tl, *rest)

    def replay(a, b):
        th.copy_(a)
        tl.copy_(b)
        graph.replay()

    noff = 1 if names and names[0] == "Offset" else 0
    eager = [x.clone() for x in step(*args)]
    s = dd_add(dd(args[0], args[1]), dd(eager[0][noff:]))
    points = [(args[0], args[1]), (s.hi, s.lo)]
    for i, (a, b) in enumerate(points):
        want = [x.cpu().numpy() for x in step(a, b, *rest)]
        replay(a, b)
        torch.cuda.synchronize()
        got = [x.cpu().numpy() for x in static_out]
        for nm, x, y in zip(("dparams", "cov", "chi2", "resids"), got, want):
            if not np.array_equal(x.view(np.int64), y.view(np.int64)):
                fail(f"{label}: the replayed step differs from the eager "
                     f"step in {nm} at point {i}")

    def timed(fn):
        host, ev = [], []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(a.elapsed_time(b))
        return ([float(np.median(host)), min(host), max(host)],
                [float(np.median(ev)), min(ev), max(ev)])

    r_host, r_ev = timed(lambda: replay(args[0], args[1]))
    e_host, e_ev = timed(lambda: step(*args))
    out = {"replay_host_ms": r_host, "replay_event_ms": r_ev,
           "eager_host_ms": e_host, "eager_event_ms": e_ev,
           "speedup_host": e_host[0] / r_host[0]}
    print(f"{label}: one step captured in a CUDA graph, replay bitwise "
          f"equal to the eager step at 2 points; replay {r_host[0]:.3f} ms "
          f"median of {reps} on the host clock (min {r_host[1]:.3f}, max "
          f"{r_host[2]:.3f}), {r_ev[0]:.3f} ms between CUDA events; eager "
          f"{e_host[0]:.3f} ms (min {e_host[1]:.3f}, max {e_host[2]:.3f}), "
          f"{e_ev[0]:.3f} ms between events: {out['speedup_host']:.1f}x")
    del graph
    return out


def stream_check(ntoa: int, dev, keep: dict = None) -> dict:
    """bench.build_problem_streaming's model at `ntoa` TOAs on `dev`:
    Fitter.auto must pick StreamingGLSFitter on the card (with no
    streaming= argument from config.solve_streaming() TOAs on); one
    accumulate + solve pass at config.stream_chunk(ntoa), timed twice
    (the second kept), held to the dense step on the card at the same
    point (STREAM_SIGMA, STREAM_CHI2_REL, ok: bench.py:1520's limits),
    with the peak device memory of each; then a StreamingGLSFitter fit to
    convergence. `keep` receives the model and the TOAs (phase 16)."""
    import copy

    import torch

    from pint_tpu_torch.config import solve_streaming, stream_chunk
    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.gls import StreamingGLSFitter
    from pint_tpu_torch.parallel import build_fit_step
    from pint_tpu_torch.parallel.streaming import StreamingGLS

    t0 = time.perf_counter()
    _, model, toas = sim_toas(
        with_dmx(STREAM_PAR, FIT_SPAN, 28), clustered_mjds(FIT_SPAN, ntoa),
        np.tile([1400.0, 1400.0, 820.0, 820.0], ntoa // 4), 1, dev,
        flags=True)
    build_s = time.perf_counter() - t0
    if keep is not None:
        keep.update(model=copy.deepcopy(model), toas=toas)
    auto = ntoa >= solve_streaming()
    fit = Fitter.auto(toas, copy.deepcopy(model),
                      **({} if auto else {"streaming": True}))
    if type(fit) is not StreamingGLSFitter or \
            fit.device.type != torch.device(dev).type:
        fail(f"stream: Fitter.auto gave a {type(fit).__name__} on "
             f"{fit.device}, not a StreamingGLSFitter on {dev}")
    sg = StreamingGLS(model, toas, device=dev)
    if sg.chunk != stream_chunk(ntoa):
        fail("stream: the chunk is not config.stream_chunk's")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        dp, cov, chi2, chi2r, xf, ok, iters, resid = sg.solve(
            sg.accumulate(sg.th0, sg.tl0))
        walls.append(time.perf_counter() - t0)
        stream_peak = torch.cuda.max_memory_allocated() - base
    pass_profile = device_busy(
        lambda: sg.solve(sg.accumulate(sg.th0, sg.tl0)), "stream pass")
    step, args, names = build_fit_step(model, toas, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dpD, covD, chi2D, _ = (x.cpu().numpy() for x in step(*args))
    dense_s = time.perf_counter() - t0
    dense_peak = torch.cuda.max_memory_allocated() - base
    del step, args
    if names != sg.names:
        fail("stream: the streaming and dense steps have other parameters")
    sig = np.sqrt(np.abs(np.diag(covD)))
    worst = float(np.max(np.abs(dp - dpD) / sig))
    chi_rel = abs(chi2r - float(chi2D)) / abs(float(chi2D))
    t0 = time.perf_counter()
    fchi2 = fit.fit_toas(maxiter=8)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    out = {"ntoa": toas.ntoas, "build_s": build_s, "auto_route": auto,
           "chunk": sg.chunk, "nchunks": sg.nchunks, "p": sg.p, "q": sg.q,
           "pass_ms": walls[1] * 1e3, "first_pass_ms": walls[0] * 1e3,
           "toa_per_s": toas.ntoas / walls[1], "cg_iters": iters,
           "cg_budget": sg.default_budget, "cg_rel_residual": resid,
           "cg_ok": ok, "worst_sigma": worst, "chi2_rel": chi_rel,
           "pass_profile": pass_profile,
           "stream_peak_bytes": stream_peak, "dense_peak_bytes": dense_peak,
           "dense_step_ms": dense_s * 1e3, "fit_s": fit_s,
           "fit_passes": fit.passes, "fit_iterations": fit.stats.iterations,
           "fit_chi2": fchi2, "fit_converged": fit.converged}
    print(f"stream: N = {toas.ntoas} (host build {build_s:.3f} s), p = "
          f"{sg.p}, q = {sg.q}; Fitter.auto "
          f"{'with no streaming= argument' if auto else 'streaming=True'} "
          f"gave StreamingGLSFitter on {fit.device}; {sg.nchunks} chunks of "
          f"{sg.chunk}: pass {walls[1] * 1e3:.1f} ms (first "
          f"{walls[0] * 1e3:.1f} ms), {toas.ntoas / walls[1]:.0f} TOA/s; CG "
          f"{iters} iterations (budget {sg.default_budget}), relative "
          f"residual {resid:.3e}, ok {ok}; against the dense step on the card"
          f" ({dense_s * 1e3:.1f} ms): {worst:.3e} sigma (limit "
          f"{STREAM_SIGMA}), chi2 {chi_rel:.3e} relative (limit "
          f"{STREAM_CHI2_REL}); peak device memory above the inputs: pass "
          f"{stream_peak / 2**20:.1f} MiB, dense step "
          f"{dense_peak / 2**20:.1f} MiB; StreamingGLSFitter fit "
          f"{fit.stats.iterations} iterations, {fit.passes} passes in "
          f"{fit_s:.3f} s, converged {fit.converged}")
    if not (ok and worst < STREAM_SIGMA and chi_rel < STREAM_CHI2_REL
            and fit.converged):
        fail("stream: the streaming pass disagrees with the dense step or "
             "the fit did not converge")
    return out


def stream_ecorr_check(model, toas, dense, dev) -> dict:
    """The fit cell (ECORR on 2,500 four-TOA epochs) streamed in chunks of
    each of STREAM_ECORR_CHUNKS (fatal unless some boundary splits an
    epoch): the pass on the card against the dense step on the card
    (`dense`: its dparams, cov, chi2) and against the same pass on the
    CPU, each to STREAM_SIGMA and STREAM_CHI2_REL."""
    import torch

    from pint_tpu_torch.parallel.streaming import StreamingGLS

    sig = np.sqrt(np.abs(np.diag(dense[1])))
    res, ok, splits = {}, True, 0
    for chunk in STREAM_ECORR_CHUNKS:
        outs, walls = {}, {}
        for tag, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
            sg = StreamingGLS(model, toas, chunk=chunk, device=d)
            t0 = time.perf_counter()
            outs[tag] = sg.solve(sg.accumulate(sg.th0, sg.tl0))
            walls[tag] = time.perf_counter() - t0
        # chunk boundaries inside an epoch (the boundary carry's work)
        cuts = np.arange(chunk, sg.ntoa, chunk)
        split = int(np.sum(sg._eid[cuts - 1] == sg._eid[cuts]))
        splits += split
        g, c = outs["gpu"], outs["cpu"]
        vs_dense = (float(np.max(np.abs(g[0] - dense[0]) / sig)),
                    abs(g[3] - float(dense[2])) / abs(float(dense[2])))
        vs_cpu = (float(np.max(np.abs(g[0] - c[0]) / sig)),
                  abs(g[3] - c[3]) / abs(c[3]))
        print(f"stream-ecorr: N = {toas.ntoas} in chunks of {chunk} ({split}"
              f" of {len(cuts)} boundaries inside an epoch): GPU pass "
              f"{walls['gpu']:.3f} s, CPU pass {walls['cpu']:.3f} s, CG "
              f"{g[6]} iterations; against the dense GPU step "
              f"{vs_dense[0]:.3e} sigma, chi2 {vs_dense[1]:.3e} relative; "
              f"GPU against CPU {vs_cpu[0]:.3e} sigma, chi2 {vs_cpu[1]:.3e}"
              f" relative (limits {STREAM_SIGMA}, {STREAM_CHI2_REL})")
        ok = ok and (g[5] and c[5]
                     and max(vs_dense[0], vs_cpu[0]) < STREAM_SIGMA
                     and max(vs_dense[1], vs_cpu[1]) < STREAM_CHI2_REL)
        res[str(chunk)] = {
            "split_epochs": split, "gpu_pass_s": walls["gpu"],
            "cpu_pass_s": walls["cpu"], "cg_iters": g[6],
            "vs_dense_sigma": vs_dense[0], "vs_dense_chi2_rel": vs_dense[1],
            "vs_cpu_sigma": vs_cpu[0], "vs_cpu_chi2_rel": vs_cpu[1]}
    if not (ok and splits):
        fail("stream-ecorr: no epoch split, or a streamed ECORR pass "
             "disagrees")
    return res

# ------------------------------------------------------ the pulsar array


def pta_pulsar(k: int, ntoa: int, dev) -> tuple:
    """bench_pta.build_pulsar(k, ntoa): (model, toas, truth), the model's
    F0 moved PTA_F0_MOVE from the truth the TOAs were simulated with."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    binary = ""
    if k % 3 == 1:  # a third of the array is ELL1 binaries
        binary = (f"BINARY ELL1\nPB {0.4 + 0.02 * k}\nA1 1.3 1\n"
                  "TASC 55000.05\nEPS1 1e-5 1\nEPS2 -2e-5 1\n")
    par = f"""PSR J{1000 + k}
RAJ {(k * 17) % 24}:{(k * 7) % 60:02d}:00.0 1
DECJ {-30 + (k % 60)}:00:00.0 1
F0 {120.0 + 11.0 * k} 1
F1 {-1e-15 * (1 + k % 5)} 1
PEPOCH 55000
POSEPOCH 55000
DM {5.0 + 0.7 * k} 1
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
{binary}"""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = get_model(io.StringIO(par), device=dev)
        t = make_fake_toas_uniform(54000, 56000, ntoa, m, error_us=1.0,
                                   add_noise=True,
                                   rng=np.random.default_rng(k))
    truth = {"F0": m.F0.value, "DM": m.get_param("DM").value}
    m.F0.add_delta(PTA_F0_MOVE)
    m.invalidate_cache(params_only=True)
    return m, t, truth


def pta_trio_pulsar(psr, f0, ntoa, seed, dev, noise_lines="", perturb=0.0,
                    clustered=False) -> tuple:
    """tests/test_pta.py's _mk (recipe copied): clustered=True gives
    same-day TOA pairs, so ECORR has two-TOA epochs."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import dd_np
    from pint_tpu_torch.simulation import _noise_draw_s, _rebuild, \
        make_fake_toas_uniform, zero_residuals
    from pint_tpu_torch.toa import get_TOAs_array

    par = f"""PSR {psr}
RAJ 12:0{seed % 10}:00.0 1
DECJ 2{seed % 10}:00:00.0 1
F0 {f0} 1
F1 -1e-15 1
PEPOCH 55000
POSEPOCH 55000
DM {10 + seed} 1
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
{noise_lines}"""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = get_model(io.StringIO(par), device=dev)
        rng = np.random.default_rng(seed)
        if clustered:
            base = np.linspace(54500, 55500, ntoa // 2)
            mjds = np.sort(np.concatenate([base, base + 0.002]))
            t = get_TOAs_array(mjds, obs="gbt", freqs=1400.0, errors=1.0,
                               device=dev)
            for f in t.flags:
                f["be"] = "X"
            t = zero_residuals(t, m)
            noise_s = _noise_draw_s(t, m, rng, True, False)
            t = _rebuild(t, t.mjd_day, dd_np.add(
                t.mjd_frac, dd_np.div_f(dd_np.dd(noise_s), 86400.0)))
        else:
            t = make_fake_toas_uniform(54500, 55500, ntoa, m,
                                       error_us=1.0, add_noise=True,
                                       rng=rng)
        if noise_lines:
            for f in t.flags:
                f["be"] = "X"
    if perturb:
        m.F0.add_delta(perturb)
        m.invalidate_cache(params_only=True)
    return m, t


def rel_err(got, want, rtol: float, atol: float = 0.0) -> float:
    """max |got - want| / max(|want|, atol/rtol): at most rtol where
    np.allclose(got, want, rtol, atol) would hold entry by entry."""
    got, want = np.asarray(got), np.asarray(want)
    floor = atol / rtol if atol else 0.0
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), floor)))


def pta_solve_check(problems, dev, label: str) -> dict:
    """pta_solve on the GPU against the CPU and against pta_solve_np:
    dparams, cov diagonal, chi2 and chi2r within PTA_RTOL; two GPU
    solves bitwise equal; the batched solve timed between CUDA events on
    device-resident inputs, and pta_solve (upload, solve, read back) on
    the host clock."""
    import torch

    from pint_tpu_torch.parallel import pta_solve, stack_problems
    from pint_tpu_torch.parallel.pta import STACK_KEYS, _solve_one, \
        pta_solve_np, upload

    st = stack_problems(problems)
    gpu = pta_solve(st, device=dev)
    if not all(np.array_equal(a, b, equal_nan=True)
               for a, b in zip(gpu, pta_solve(st, device=dev))):
        fail(f"{label}: two GPU solves differ")
    res = {"shape": list(st["M"].shape) + [st["F"].shape[2]]}
    for name, ref in (("cpu", pta_solve(st, device="cpu")),
                      ("mirror", pta_solve_np(st))):
        e = {"dparams": rel_err(gpu[0], ref[0], PTA_RTOL, PTA_ATOL),
             "cov_diag": rel_err(np.diagonal(gpu[1], axis1=1, axis2=2),
                                 np.diagonal(ref[1], axis1=1, axis2=2),
                                 PTA_RTOL),
             "chi2": rel_err(gpu[2], ref[2], PTA_RTOL),
             "chi2r": rel_err(gpu[3], ref[3], PTA_RTOL)}
        res[f"vs_{name}"] = e
        if not all(v <= PTA_RTOL for v in e.values()):
            fail(f"{label}: GPU solve vs {name} {e} (limit {PTA_RTOL})")
    placed = upload(st, STACK_KEYS, dev)
    args = [placed[k] for k in STACK_KEYS]
    res["solve_ms"] = cuda_ms(lambda: _solve_one(*args), per_sleep=1)
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pta_solve(st, device=dev)
        host.append((time.perf_counter() - t0) * 1e3)
    res["pta_solve_host_ms"] = [float(np.median(host)), min(host),
                                max(host)]
    res["dparams"], res["cov"] = gpu[0], gpu[1]
    print(f"{label}: batch {res['shape']} (P, N, p, q); GPU vs CPU "
          f"{res['vs_cpu']}, vs numpy mirror {res['vs_mirror']}; solve "
          f"{fmt(res['solve_ms'])} between events, pta_solve "
          f"{res['pta_solve_host_ms'][0]:.3f} ms on the host clock")
    return res


def pta_fit_check(pulsars, dev) -> dict:
    """fit_pta(maxiter=2) on the GPU: F0 within PTA_TRUTH_SIGMA sigma of
    the truth for every pulsar."""
    import torch

    from pint_tpu_torch.parallel import fit_pta

    torch.cuda.synchronize()
    res = fit_pta([(t, m) for m, t, _ in pulsars], maxiter=2, device=dev)
    st = dict(res.stats)
    ok = [abs(m.F0.value - truth["F0"]) < PTA_TRUTH_SIGMA *
          r["errors"]["F0"] for (m, _, truth), r in zip(pulsars, res)]
    st["recovered"] = int(sum(ok))
    print(f"pta-fit: {st['npulsars']} pulsars, {st['ntoa_total']} TOAs, "
          f"{st['iterations']} batch solves in {st['wall_time_s']:.3f} s "
          f"({st['toas_per_sec']:.1f} TOA/s): build_problem "
          f"{st['build_problem_s']:.3f} s, device solves "
          f"{st['device_solve_s']:.3f} s; F0 within {PTA_TRUTH_SIGMA:g} "
          f"sigma of the truth: {st['recovered']}/{len(pulsars)}")
    if not all(ok):
        fail("pta-fit: F0 not recovered for every pulsar")
    return st


def gwb_check(problems, positions, dev, nfreq: int) -> dict:
    """GWBLikelihood on the GPU: the blocks against gwb_blocks_np, the
    GWB_GRID x GWB_GRID sweep (bench_pta.py's grid) against the numpy
    outer stage on the mirror's blocks, both within GWB_RTOL; the block
    assembly (best of 3 after a warm call), the sweep (points/s, its peak
    device memory) and one chunk between CUDA events at the default
    chunk and at one point a chunk."""
    import torch

    from pint_tpu_torch import config
    from pint_tpu_torch.parallel.pta import upload
    from pint_tpu_torch.pta import GWBLikelihood
    from pint_tpu_torch.pta.gwb import _gwb_outer_batch, _gwb_outer_np, \
        gwb_blocks_np

    like = GWBLikelihood(problems=problems, positions=positions,
                         nfreq=nfreq, device=dev)
    P, m = like.npulsars, like.m
    A, x, rdr_sum, ld_sum = like.build_blocks()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        like.build_blocks(force=True)
        best = min(best, time.perf_counter() - t0)
    t0 = time.perf_counter()
    An, xn, rdrn, ldn = gwb_blocks_np(like.stacked, like.U)
    mirror_blocks_s = time.perf_counter() - t0
    blocks = {"A": rel_err(A, An, GWB_RTOL, GWB_RTOL * np.max(np.abs(An))),
              "x": rel_err(x, xn, GWB_RTOL, GWB_RTOL * np.max(np.abs(xn))),
              "rdr_sum": rel_err(rdr_sum, rdrn.sum(), GWB_RTOL),
              "ld_sum": rel_err(ld_sum, ldn.sum(), GWB_RTOL)}
    if not all(v <= GWB_RTOL for v in blocks.values()):
        fail(f"gwb: GPU blocks vs gwb_blocks_np {blocks} (limit "
             f"{GWB_RTOL})")
    la2, ga2 = np.meshgrid(np.linspace(-15.5, -13.5, GWB_GRID),
                           np.linspace(2.0, 6.0, GWB_GRID))
    la, ga = la2.ravel(), ga2.ravel()
    K = config.gwb_chunk()
    like.loglik_grid(la, ga)          # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logL = like.loglik_grid(la, ga)
    sweep_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    want = _gwb_outer_np(An, xn, float(rdrn.sum()), float(ldn.sum()),
                         like.Gamma, like.fcols, like.tspan, la, ga)
    mirror_sweep_s = time.perf_counter() - t0
    sweep_rel = rel_err(logL, want, GWB_RTOL)
    kbest = int(np.argmax(logL))
    res = {"npulsars": P, "nfreq": nfreq, "Pm": P * m,
           "grid": f"{GWB_GRID}x{GWB_GRID}", "chunk": K,
           "blocks_vs_mirror": blocks, "sweep_vs_mirror": sweep_rel,
           "ptp_logL": float(np.ptp(logL)),
           "best": {"log10A": float(la[kbest]), "gamma": float(ga[kbest]),
                    "logL": float(logL[kbest])},
           "blocks_ms": best * 1e3,
           "mirror_blocks_s": mirror_blocks_s, "sweep_s": sweep_s,
           "points_per_s": len(la) / sweep_s,
           "mirror_sweep_s": mirror_sweep_s,
           "sweep_peak_bytes": int(peak), "counters": like.metrics.snapshot()}
    if not sweep_rel <= GWB_RTOL:
        # measure the CPU port against the mirror at the same size before
        # failing, so a limit set from a measurement can be argued
        cpu = GWBLikelihood(problems=problems, positions=positions,
                            nfreq=nfreq, device="cpu")
        res["cpu_port_vs_mirror"] = rel_err(cpu.loglik_grid(la, ga), want,
                                            GWB_RTOL)
        print(json.dumps({"gwb_failed": res}))
        fail(f"gwb: GPU sweep vs the numpy mirror {sweep_rel:.3e} (limit "
             f"{GWB_RTOL}; CPU port {res['cpu_port_vs_mirror']:.3e})")
    if not res["ptp_logL"] > 1.0:
        fail(f"gwb: the sweep does not discriminate (ptp {res['ptp_logL']})")
    placed = upload({"A": A, "x": x, "G": like.Gamma, "f": like.fcols,
                     "la": la, "ga": ga}, ("A", "x", "G", "f", "la", "ga"),
                    dev)
    for k in (K, 1):
        ms = cuda_ms(lambda: _gwb_outer_batch(
            placed["A"], placed["x"], rdr_sum, ld_sum, placed["G"],
            placed["f"], like.tspan, placed["la"][:k], placed["ga"][:k]),
            reps=5, warmup=1, per_sleep=1)
        res[f"chunk{k}_ms"] = ms
    n = P * m
    chol_flops = n ** 3 / 3.0
    res["bound_point_ms"] = chol_flops / H100_F64_OPS_PER_S * 1e3
    res["assembly_bytes_point"] = 8 * n * n
    res["assembly_bound_point_ms"] = 8 * n * n / H100_BYTES_PER_S * 1e3
    per_point = res[f"chunk{K}_ms"]["median"] / K
    print(f"gwb: P = {P}, m = {m} (Pm = {n}); blocks vs mirror {blocks}; "
          f"sweep vs mirror {sweep_rel:.3e}, ptp log L "
          f"{res['ptp_logL']:.2f}, best {res['best']}; blocks "
          f"{res['blocks_ms']:.3f} ms (best of 3; mirror "
          f"{mirror_blocks_s:.3f} s); sweep of {len(la)} points "
          f"{sweep_s * 1e3:.3f} ms ({res['points_per_s']:.1f} points/s; "
          f"mirror {mirror_sweep_s:.3f} s), peak {peak / 2**20:.1f} MiB; "
          f"chunk of {K}: {fmt(res[f'chunk{K}_ms'])} "
          f"({per_point:.4f} ms a point), one point a chunk: "
          f"{fmt(res['chunk1_ms'])}; bound a point: Cholesky "
          f"{chol_flops:.3e} flops at {H100_F64_OPS_PER_S:.3g} = "
          f"{res['bound_point_ms']:.4f} ms, S assembly "
          f"{res['assembly_bytes_point']} B at 3.35 TB/s = "
          f"{res['assembly_bound_point_ms']:.4f} ms")
    return res


def posterior_check(problems, dparams, cov, dev) -> dict:
    """sample_problems over the array (POST_WALKERS walkers, POST_STEPS
    steps, seed k for pulsar k): after POST_BURN steps every pulsar's
    chain mean within 0.5 sigma of the GLS dparams, the std ratio in
    (0.5, 2), the acceptance in (0.1, 0.95) (tests/test_sampling.py:387's
    limits); the default chunking and chunk=16 bitwise equal."""
    import torch

    from pint_tpu_torch import config
    from pint_tpu_torch.sampling import sample_problems

    seeds = list(range(len(problems)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sample_problems(problems, POST_WALKERS, POST_STEPS, seeds=seeds,
                          device=dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = sample_problems(problems, POST_WALKERS, POST_STEPS,
                            seeds=seeds, chunk=16, device=dev)
    wall16 = time.perf_counter() - t0
    if not all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(out, again)):
        fail("posterior: chunk=16 and the default chunking differ")
    worst = {"mean_sigma": 0.0, "ratio_lo": np.inf, "ratio_hi": 0.0,
             "acc_lo": np.inf, "acc_hi": 0.0}
    for k, (chain, _, acc) in enumerate(out):
        p = chain.shape[-1]
        sig = np.sqrt(np.diag(cov[k])[:p])
        flat = chain[POST_BURN:].reshape(-1, p)
        worst["mean_sigma"] = max(worst["mean_sigma"], float(np.max(
            np.abs(flat.mean(axis=0) - dparams[k][:p]) / sig)))
        ratio = flat.std(axis=0) / sig
        worst["ratio_lo"] = min(worst["ratio_lo"], float(ratio.min()))
        worst["ratio_hi"] = max(worst["ratio_hi"], float(ratio.max()))
        worst["acc_lo"] = min(worst["acc_lo"], acc)
        worst["acc_hi"] = max(worst["acc_hi"], acc)
    res = {"npulsars": len(problems), "walkers": POST_WALKERS,
           "steps": POST_STEPS,
           "chunk": config.chain_chunk_steps(POST_STEPS), "worst": worst,
           "wall_s": wall, "wall_chunk16_s": wall16,
           "steps_per_s": POST_STEPS / wall,
           "walker_steps_per_s": POST_STEPS * POST_WALKERS * len(problems)
           / wall}
    print(f"posterior: {len(problems)} pulsars x {POST_WALKERS} walkers x "
          f"{POST_STEPS} steps in {wall:.3f} s ({res['steps_per_s']:.1f} "
          f"steps/s, {res['walker_steps_per_s']:.0f} walker-steps/s; chunk "
          f"{res['chunk']}; chunk=16 {wall16:.3f} s, bitwise equal); worst "
          f"{worst}")
    if not (worst["mean_sigma"] < 0.5 and worst["ratio_lo"] > 0.5
            and worst["ratio_hi"] < 2.0 and worst["acc_lo"] > 0.1
            and worst["acc_hi"] < 0.95):
        fail(f"posterior: moments or acceptance out of limits {worst}")
    return res


def pta_phase(ntoa: int, nfreq: int, dev, keep: dict = None) -> dict:
    """Phase 10: BASELINE config 5 built, solved, noise-solved, fitted,
    its GWB likelihood swept and its per-pulsar posteriors sampled.
    `keep`, when given, receives the problems and pulsar positions."""
    import torch

    from pint_tpu_torch.parallel import build_problem
    from pint_tpu_torch.pta import pulsar_positions

    secs = {}
    t0 = time.perf_counter()
    pulsars = [pta_pulsar(k, ntoa, dev) for k in range(PTA_NPSR)]
    secs["build"] = time.perf_counter() - t0
    nbin = sum("BinaryELL1" in m.components for m, _, _ in pulsars)
    print(f"pta-build: {PTA_NPSR} pulsars x {ntoa} TOAs ({nbin} ELL1) "
          f"simulated by the port on {dev} in {secs['build']:.3f} s")
    t0 = time.perf_counter()
    problems = [build_problem(t, m) for m, t, _ in pulsars]
    torch.cuda.synchronize()
    secs["build_problems"] = time.perf_counter() - t0
    positions = pulsar_positions([m for m, _, _ in pulsars])
    if keep is not None:
        keep.update(problems=problems, positions=positions)
    t0 = time.perf_counter()
    solve = pta_solve_check(problems, dev, "pta-solve")
    secs["solve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trio = [pta_trio_pulsar("J0001+01", 101.1, 40, 1, dev, perturb=1e-10),
            pta_trio_pulsar("J0002+02", 317.9, 64, 2, dev, perturb=-2e-10),
            pta_trio_pulsar("J0003+03", 218.5, 50, 3, dev,
                            perturb=1.5e-10,
                            noise_lines="EFAC -be X 1.2\nECORR -be X 1.0\n",
                            clustered=True)]
    trio_problems = [build_problem(t, m) for m, t in trio]
    if trio_problems[2].F.shape[1] == 0:
        fail("pta-noise: the ECORR pulsar has no epochs")
    noise = pta_solve_check(trio_problems, dev, "pta-noise")
    secs["noise"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit = pta_fit_check(pulsars, dev)
    secs["fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gwb = gwb_check(problems, positions, dev, nfreq)
    secs["gwb"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    post = posterior_check(problems, solve.pop("dparams"), solve.pop("cov"),
                           dev)
    secs["posterior"] = time.perf_counter() - t0
    noise.pop("dparams")
    noise.pop("cov")
    print("pulsar array seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()))
    return {"ntoa": ntoa, "npulsars": PTA_NPSR, "solve": solve,
            "noise": noise, "fit": fit, "gwb": gwb, "posterior": post,
            "seconds": secs}


# ------------------------------------------------------------ the Bayesian path


def bayes_model(par: str, sigma: dict, dev):
    """The fit cell's model on `dev`, each free timing parameter's
    uncertainty set to the fit step's sigma (so the walkers start within
    the posterior, as after a fit)."""
    from pint_tpu_torch.models import get_model

    m = get_model(io.StringIO(par), device=dev)
    for name in m.free_params:
        m.get_param(name).uncertainty = float(sigma[name])
    return m


def walkers(ndim: int) -> int:
    """MCMCFitter's ensemble size for `ndim` dimensions at its default
    nwalkers=32: 2 * ndim + 2 (even)."""
    return max(32, 2 * ndim + 2)


def bayes_batch_check(mg, mc, toas, seed: int) -> tuple:
    """(a) BayesianTiming.lnlikelihood_batch at walkers(ndim) points drawn
    by init_walkers from default_rng(seed): the GPU's against the CPU's
    and against the GPU's scalar lnlikelihood at three of them, within
    BAYES_REL relative. Returns (results, posterior, walker array)."""
    import torch

    from pint_tpu_torch.bayesian import BayesianTiming
    from pint_tpu_torch.sampling import DevicePosterior

    t0 = time.perf_counter()
    post = DevicePosterior(mg, toas, sample_noise=True)
    build_s = time.perf_counter() - t0
    bt = post.bt
    nw = walkers(post.nparams)
    p0 = post.init_walkers(nw, rng=np.random.default_rng(seed))
    thetas = p0[:, :post.ntiming]
    bt.lnlikelihood_batch(thetas)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = bt.lnlikelihood_batch(thetas)
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ll_cpu = BayesianTiming(mc, toas).lnlikelihood_batch(thetas)
    cpu_s = time.perf_counter() - t0
    scalar = [bt.lnlikelihood(thetas[k]) for k in range(3)]
    res = {"walkers": nw, "ntiming": post.ntiming,
           "nparams": post.nparams, "labels_noise":
           post.param_labels[post.ntiming:], "posterior_build_s": build_s,
           "batch_ms": batch_ms, "cpu_batch_s": cpu_s,
           "gpu_vs_cpu_rel": rel_err(ll, ll_cpu, BAYES_REL),
           "batch_vs_scalar_rel": rel_err(ll[:3], scalar, BAYES_REL),
           "lnlike_range": [float(ll.min()), float(ll.max())]}
    print(f"bayes-batch: {nw} walkers x {post.ntiming} timing "
          f"parameters ({post.nparams} with the noise dimensions "
          f"{res['labels_noise']}), N = {toas.ntoas}: GPU batch "
          f"{batch_ms:.3f} ms (host clock), CPU batch {cpu_s:.3f} s; GPU vs "
          f"CPU {res['gpu_vs_cpu_rel']:.3e} relative, batch vs scalar "
          f"{res['batch_vs_scalar_rel']:.3e} (limit {BAYES_REL}); lnL in "
          f"[{res['lnlike_range'][0]:.6e}, {res['lnlike_range'][1]:.6e}]")
    if not (np.all(np.isfinite(ll)) and res["gpu_vs_cpu_rel"] <= BAYES_REL
            and res["batch_vs_scalar_rel"] <= BAYES_REL):
        fail("bayes-batch: the GPU batch likelihood disagrees")
    if post.nparams != post.ntiming + 3:
        fail(f"bayes-batch: {post.nparams - post.ntiming} noise dimensions, "
             "expected ECORR1.log10, PLRedNoise.log10_A and .gamma")
    return res, post, p0


def bayes_noise_check(par: str, post, p0, toas, dev) -> dict:
    """(b) SampledNoiseLikelihood on the GPU: at eta0 the fixed-noise
    BayesianTiming, at eta0 + BAYES_ETA_MOVE a BayesianTiming rebuilt at
    those hyperparameters, within NOISE_REL, at two walker points."""
    from pint_tpu_torch.bayesian import BayesianTiming
    from pint_tpu_torch.models import get_model

    sn, bt = post.noise, post.bt
    pts = p0[:2, :post.ntiming]
    pinned = rel_err([sn.lnlikelihood(th, sn.eta0) for th in pts],
                     [bt.lnlikelihood(th) for th in pts], NOISE_REL)
    eta1 = sn.eta0 + np.asarray(BAYES_ETA_MOVE)
    m2 = get_model(io.StringIO(par), device=dev)
    m2.get_param(sn.labels[0].split(".")[0]).value = 10.0 ** eta1[0]
    m2.get_param("TNREDAMP").value = eta1[1]
    m2.get_param("TNREDGAM").value = eta1[2]
    m2.invalidate_cache()
    bt2 = BayesianTiming(m2, toas)
    moved = rel_err([sn.lnlikelihood(th, eta1) for th in pts],
                    [bt2.lnlikelihood(th) for th in pts], NOISE_REL)
    shift = sn.lnlikelihood(pts[0], eta1) - sn.lnlikelihood(pts[0], sn.eta0)
    print(f"bayes-noise: pinned eta0 vs fixed-noise {pinned:.3e}, moved "
          f"eta0 + {BAYES_ETA_MOVE} vs rebuilt {moved:.3e} relative (limit "
          f"{NOISE_REL}); the move shifts lnL by {shift:.6e}")
    if not (pinned <= NOISE_REL and moved <= NOISE_REL and shift != 0.0):
        fail("bayes-noise: the noise-sampled likelihood disagrees")
    return {"pinned_rel": pinned, "moved_rel": moved, "lnl_shift": shift}


def bayes_chain_check(post, p0, dev) -> dict:
    """(c) DeviceEnsembleSampler over the 43 sampled dimensions: scan and
    host_loop bitwise equal after BAYES_EXACT_STEPS steps."""
    from pint_tpu_torch.sampling import DeviceEnsembleSampler

    out, secs = [], {}
    for mode in ("scan", "host_loop"):
        s = DeviceEnsembleSampler(len(p0), post.nparams, post.lnpost_batch,
                                  device=dev)
        t0 = time.perf_counter()
        pos = s.run_mcmc(p0, BAYES_EXACT_STEPS, seed=5, mode=mode)
        secs[mode] = time.perf_counter() - t0
        out.append((s, pos))
    (a, pa), (b, pb) = out
    same = (np.array_equal(pa, pb) and np.array_equal(a.chain, b.chain)
            and np.array_equal(a.lnprob, b.lnprob)
            and a.naccepted == b.naccepted)
    print(f"bayes-chain: {len(p0)} walkers x {post.nparams} "
          f"dimensions x {BAYES_EXACT_STEPS} steps, scan {secs['scan']:.3f}"
          f" s ({a.dispatches} chunk), host_loop {secs['host_loop']:.3f} s "
          f"({b.dispatches} calls): bitwise equal {same}; acceptance "
          f"{a.acceptance_fraction:.3f}, finite lnprob "
          f"{bool(np.all(np.isfinite(a.lnprob)))}")
    if not same or not np.all(np.isfinite(a.lnprob)):
        fail("bayes-chain: scan and host_loop differ on the GPU")
    return {"steps": BAYES_EXACT_STEPS, "scan_s": secs["scan"],
            "host_loop_s": secs["host_loop"],
            "acceptance": a.acceptance_fraction}


def bayes_time(par: str, sigma: dict, toas, dev) -> dict:
    """(d) MCMCFitter(sample_noise=True) on the fit cell: a timed chain of
    BAYES_TIMED_STEPS steps (steps/s, walker-steps/s, peak device memory),
    launches per lnpost_batch and one profiled chain step (device busy,
    idle share)."""
    import torch

    from pint_tpu_torch.mcmc_fitter import MCMCFitter

    fitter = MCMCFitter(toas, bayes_model(par, sigma, dev),
                        sample_noise=True, rng=np.random.default_rng(9))
    post, smp = fitter.post, fitter.sampler
    nw = fitter.nwalkers
    if nw != walkers(post.nparams):
        fail(f"bayes-time: MCMCFitter sized {nw} walkers")
    x = torch.as_tensor(post.init_walkers(nw, rng=np.random.default_rng(3)),
                        device=dev)
    half = x[:nw // 2]
    post.lnpost_batch(half)
    one = device_busy(lambda: post.lnpost_batch(half), "bayes lnpost_batch "
                      f"({nw // 2} walkers)")
    lp = post.lnpost_batch(x)
    chunk = smp._chunk(1)
    seed = torch.tensor(1, dtype=torch.int64, device=dev)
    chunk(x, lp, seed, 1, 0)
    step = device_busy(lambda: chunk(x, lp, seed, 1, 0),
                       "bayes chain step")
    cost = supervision_cost(lambda: chunk(x, lp, seed, 1, 0),
                            "sampling.chain", dev, "Bayesian chain step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    chi2 = fitter.fit_toas(nsteps=BAYES_TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    res = {"walkers": nw, "nparams": post.nparams,
           "steps": BAYES_TIMED_STEPS, "wall_s": wall,
           "steps_per_s": BAYES_TIMED_STEPS / wall,
           "walker_steps_per_s": BAYES_TIMED_STEPS * nw / wall,
           "launches_per_lnpost_batch": one["launches"],
           "lnpost_batch_ms": one["wall_ms"], "lnpost_batch_busy_ms":
           one["busy_ms"], "step": step, "peak_mib": peak / 2 ** 20,
           "acceptance": smp.acceptance_fraction, "chi2": chi2,
           "noise_estimates": fitter.noise_estimates, "supervision": cost}
    print(f"bayes-time: MCMCFitter(sample_noise=True), {nw} "
          f"walkers x {post.nparams} dimensions x {BAYES_TIMED_STEPS} steps "
          f"on N = {toas.ntoas}: {wall:.3f} s ({res['steps_per_s']:.3f} "
          f"steps/s, {res['walker_steps_per_s']:.1f} walker-steps/s), peak "
          f"{res['peak_mib']:.1f} MiB; acceptance {res['acceptance']:.3f}; "
          f"noise medians {fitter.noise_estimates}")
    if not (np.isfinite(chi2) and len(fitter.noise_estimates) == 3):
        fail("bayes-time: the fit gave no finite chi2 or noise estimates")
    return res


def bayes_moments(dev) -> dict:
    """(e) MOMENT_PAR's 60 TOAs, simulated (default_rng(11), as
    tests/test_sampling.py's _mk) and WLS-fitted on the GPU: 32 walkers x
    600 steps, after 200 the F0/F1 chain means within 0.5 sigma of the
    fit, std ratios in (0.5, 2), acceptance in (0.1, 0.95)
    (posterior_check's limits)."""
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.sampling import DeviceEnsembleSampler, \
        DevicePosterior
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    m = get_model(io.StringIO(MOMENT_PAR), device=dev)
    toas = make_fake_toas_uniform(54000, 56000, 60, m, error_us=1.0,
                                  freq_mhz=1400.0, add_noise=True,
                                  rng=np.random.default_rng(11), device=dev)
    wls = WLSFitter(toas, m)
    wls.fit_toas(maxiter=2)
    post = DevicePosterior(m, toas)
    s = DeviceEnsembleSampler(POST_WALKERS, post.nparams, post.lnpost_batch,
                              device=dev)
    t0 = time.perf_counter()
    s.run_mcmc(post.init_walkers(POST_WALKERS,
                                 rng=np.random.default_rng(12)),
               POST_STEPS, seed=13)
    wall = time.perf_counter() - t0
    flat = s.get_chain(discard=POST_BURN, flat=True)
    sig = np.array([wls.errors[n] for n in post.param_labels])
    mean_sigma = np.abs(flat.mean(axis=0) - post.theta0) / sig
    ratio = flat.std(axis=0) / sig
    acc = s.acceptance_fraction
    res = {"labels": post.param_labels, "mean_sigma": mean_sigma.tolist(),
           "std_ratio": ratio.tolist(), "acceptance": acc, "wall_s": wall,
           "steps_per_s": POST_STEPS / wall, "chunks": s.dispatches}
    print(f"bayes-moments: {post.param_labels} of the 60-TOA pulsar, "
          f"{POST_WALKERS} walkers x {POST_STEPS} steps in {wall:.3f} s "
          f"({res['steps_per_s']:.1f} steps/s, {s.dispatches} chunks): mean "
          f"{mean_sigma} sigma from the WLS fit, std ratio {ratio}, "
          f"acceptance {acc:.3f}")
    if not (np.all(mean_sigma < 0.5) and np.all((ratio > 0.5) & (ratio < 2))
            and 0.1 < acc < 0.95):
        fail("bayes-moments: the chain's moments disagree with the WLS fit")
    return res


def bayes_grid(mg, mc, toas, step: dict) -> dict:
    """(f) grid_chisq over (F0, F1), GRID_NODES x GRID_NODES nodes at
    +-GRID_SIGMA sigma about the fit (the GLS step's update added),
    maxiter=GRID_MAXITER: the minimum at the node nearest the fit in the
    metric of the step's (F0, F1) covariance; four nodes against the CPU
    within chi2_tol (the GPU-CPU residual difference at the entry point
    as dr); its wall, node chunk and peak device memory."""
    import torch

    from pint_tpu_torch import config
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.residuals import Residuals

    dp, cov, _, _ = [x.cpu().numpy() for x in step["step"](*step["args"])]
    k = [step["names"].index(n) for n in ("F0", "F1")]
    sig = np.sqrt(np.diag(cov)[k])
    fit = np.array([mg.F0.value, mg.F1.value]) + dp[k]
    off = np.linspace(-GRID_SIGMA, GRID_SIGMA, GRID_NODES)
    axes = [fit[i] + (off + 0.25) * sig[i] for i in range(2)]
    icov = np.linalg.inv(cov[np.ix_(k, k)])
    g0, g1 = np.meshgrid(*axes, indexing="ij")
    d = np.stack([g0 - fit[0], g1 - fit[1]], axis=-1)
    maha = np.einsum("...i,ij,...j->...", d, icov, d)
    nearest = np.unravel_index(np.argmin(maha), maha.shape)
    nparams = len(step["names"]) - 2
    chunk = config.grid_chunk(toas.ntoas, nparams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    chi2 = grid_chisq(mg, toas, ("F0", "F1"), axes, maxiter=GRID_MAXITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    kmin = np.unravel_index(np.argmin(chi2), chi2.shape)
    idx = [(0, 0), nearest, (GRID_NODES - 1, 2), (3, GRID_NODES - 1)]
    t0 = time.perf_counter()
    cpu = [grid_chisq(mc, toas, ("F0", "F1"),
                      ([axes[0][i]], [axes[1][j]]),
                      maxiter=GRID_MAXITER)[0, 0] for i, j in idx]
    cpu_s = time.perf_counter() - t0
    dr = (Residuals(toas, mg).time_resids.cpu().numpy()
          - Residuals(toas, mc).time_resids.numpy())
    sigma = mc.scaled_toa_uncertainty(toas)
    worst = 0.0
    for (i, j), c in zip(idx, cpu):
        tol = chi2_tol(c, dr, sigma, CHI2_REL)
        worst = max(worst, abs(chi2[i, j] - c) / tol)
    res = {"nodes": GRID_NODES ** 2, "maxiter": GRID_MAXITER,
           "chunk": chunk, "nparams": nparams, "wall_s": wall,
           "nodes_per_s": GRID_NODES ** 2 / wall, "peak_mib": peak / 2 ** 20,
           "min_node": [int(x) for x in kmin],
           "nearest_node": [int(x) for x in nearest],
           "chi2_min": float(chi2.min()), "chi2_max": float(chi2.max()),
           "cpu_nodes_s": cpu_s, "cpu_worst_over_tol": worst}
    print(f"bayes-grid: grid_chisq over (F0, F1), {GRID_NODES} x "
          f"{GRID_NODES} nodes at +-{GRID_SIGMA} sigma, maxiter "
          f"{GRID_MAXITER}, {nparams} columns refit, chunks of {chunk} "
          f"nodes: {wall:.3f} s ({res['nodes_per_s']:.2f} nodes/s), peak "
          f"{res['peak_mib']:.1f} MiB; minimum at {res['min_node']} (nearest "
          f"the fit {res['nearest_node']}), chi2 {res['chi2_min']:.6f} to "
          f"{res['chi2_max']:.6f}; 4 nodes on the CPU in {cpu_s:.3f} s, worst "
          f"|GPU - CPU| {worst:.3e} of chi2_tol")
    if not (np.all(np.isfinite(chi2)) and tuple(kmin) == tuple(nearest)
            and worst <= 1.0):
        fail("bayes-grid: the grid's minimum or its CPU nodes disagree")
    return res


def bayes_phase(zmod, par: str, toas, step: dict, dev,
                keep: dict = None) -> dict:
    """Phase 12: the Bayesian path on the fit cell (gates (a)-(f)). `keep`
    receives the posterior and the walkers' start (phase 16)."""
    secs = {}
    zmod.launches = 0
    t0 = time.perf_counter()
    mg, mc = (bayes_model(par, step["sigma"], d) for d in (dev, "cpu"))
    batch, post, p0 = bayes_batch_check(mg, mc, toas, 7)
    if keep is not None:
        keep.update(post=post, p0=p0)
    secs["batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    noise = bayes_noise_check(par, post, p0, toas, dev)
    secs["noise"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain = bayes_chain_check(post, p0, dev)
    secs["chain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timing = bayes_time(par, step["sigma"], toas, dev)
    secs["time"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moments = bayes_moments(dev)
    secs["moments"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = bayes_grid(mg, mc, toas, step)
    secs["grid"] = time.perf_counter() - t0
    print("bayes seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in secs.items())
          + f"; K1 launches on this path {zmod.launches} (no hand kernel "
          "on it)")
    if zmod.launches != 0:
        fail(f"bayes: K1 launched {zmod.launches} times on a path that "
             "reaches no Pallas kernel in the reference")
    return {"ntoa": toas.ntoas, "batch": batch, "noise": noise,
            "chain": chain, "time": timing, "moments": moments,
            "grid": grid, "k1_launches": zmod.launches, "seconds": secs}


# ------------------------------------------------------------ the model zoo


def conjunction_windows(span, first: float, half: float = 30.0) -> list:
    """(start, end) MJDs of +-`half` days about each yearly solar
    conjunction first + 365.25 k whose window lies inside `span`."""
    out, t = [], first
    while t - half < span[0]:
        t += 365.25
    while t + half <= span[1]:
        out.append((t - half, t + half))
        t += 365.25
    return out


def fourier_lines(pre: str, n: int, span_days: float, k0: int = 1) -> list:
    """Par lines of a WaveX-style family `pre` (WX, DMWX, CMWX) at the n
    frequencies k/span (k = k0..k0+n-1), amplitudes 0 and free."""
    return [ln for i, k in enumerate(range(k0, k0 + n), 1) for ln in (
        f"{pre}FREQ_{i:04d} {k / span_days!r}", f"{pre}SIN_{i:04d} 0.0 1",
        f"{pre}COS_{i:04d} 0.0 1")]


def zoo_msp_lines() -> list:
    """ZOO_MSP_PAR with its SWX windows, DMWaveX and CMWaveX families and
    the per-receiver white noise and JUMPs."""
    par = list(ZOO_MSP_PAR)
    for i, (lo, hi) in enumerate(conjunction_windows(ZOO_MSP_SPAN,
                                                     ZOO_CONJUNCTION), 1):
        par += [f"SWXDM_{i:04d} 0.0 1", f"SWXR1_{i:04d} {lo!r}",
                f"SWXR2_{i:04d} {hi!r}"]
    span = ZOO_MSP_SPAN[1] - ZOO_MSP_SPAN[0]
    par += fourier_lines("DMWX", ZOO_MSP_NDMWX, span)
    par += fourier_lines("CMWX", ZOO_MSP_NCMWX, span)
    for k, (_, fe, _) in enumerate(ZOO_MSP_RECEIVERS):
        par += [f"EFAC -fe {fe} 1.1", f"EQUAD -fe {fe} 0.1",
                f"ECORR -fe {fe} 0.5"]
        if k:
            par.append(f"JUMP -fe {fe} 0.0 1")
    return par


def zoo_msp_build(ntoa: int, dev) -> tuple:
    """(par text, model, TOAs) of zoo-msp on `dev`: ntoa/4 four-TOA
    clusters over the span, the receivers in turn, the receiver flag set
    before the draw, 1 us errors, white noise from default_rng(11)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    par = "\n".join(zoo_msp_lines()) + "\n"
    model = get_model(io.StringIO(par), device=dev)
    rec = [ZOO_MSP_RECEIVERS[(i // 4) % len(ZOO_MSP_RECEIVERS)]
           for i in range(ntoa)]
    freqs = np.array([r[2] * (1.0 + ZOO_SUBBANDS[i % 4])
                      for i, r in enumerate(rec)])
    toas = make_fake_toas_fromMJDs(
        clustered_mjds(ZOO_MSP_SPAN, ntoa), model, error_us=1.0,
        obs=[r[0] for r in rec], freq_mhz=freqs, add_noise=True,
        rng=np.random.default_rng(11), flags=[{"fe": r[1]} for r in rec])
    return par, model, toas


def zoo_young_build(ntoa: int, dev) -> tuple:
    """(par text, model, TOAs) of zoo-young on `dev`: ntoa parkes TOAs at
    MJDs from default_rng(13), 1400 and 3100 MHz in turn with their -f
    flags, 1 us errors, white noise from the same generator."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    span = ZOO_YOUNG_SPAN[1] - ZOO_YOUNG_SPAN[0]
    par = "\n".join(ZOO_YOUNG_PAR + fourier_lines(
        "WX", ZOO_YOUNG_NWX, span, ZOO_YOUNG_WX_K0)) + "\n"
    model = get_model(io.StringIO(par), device=dev)
    rng = np.random.default_rng(13)
    mjds = np.sort(rng.uniform(*ZOO_YOUNG_SPAN, ntoa))
    freqs = np.tile([1400.0, 3100.0], ntoa // 2)
    toas = make_fake_toas_fromMJDs(
        mjds, model, error_us=1.0, obs="parkes", freq_mhz=freqs,
        add_noise=True, rng=rng,
        flags=[{"f": f"PDFB_{int(f)}"} for f in freqs])
    return par, model, toas


def zoo_fit_phase(label: str, par: str, model, toas, dev, offsets,
                  build_s: float) -> dict:
    """fit_step_check (GPU vs CPU, hybrid vs default), fit_time, then
    DownhillGLSFitter from `offsets` moved 3 sigma (of the step at the
    truth), on the GPU and the CPU (fit_downhill's limits), every fitted
    parameter within ZOO_TRUTH_SIGMA of the simulated truth."""
    from pint_tpu_torch.models import get_model

    print(f"{label}: build {build_s:.3f} s on the host; N = {toas.ntoas}, "
          f"{len(model.free_params)} free parameters, components "
          f"{sorted(model.components)}, noise columns "
          f"{model.noise_model_dimensions(toas)}")
    step = fit_step_check(model, toas, dev, f"{label} step",
                          explain_chi2=True)
    tm = fit_time(step["step"], step["args"], f"{label} step")
    start = get_model(io.StringIO(par), device="cpu")
    for i, nm in enumerate(offsets):
        start.get_param(nm).add_delta((3.0 if i % 2 == 0 else -3.0)
                                      * float(step["sigma"][nm]))
    out = fit_downhill(start.as_parfile(), toas, dev, f"{label} downhill")
    out.pop("cpu_fitter")
    fitted, truth = out.pop("fitter"), get_model(io.StringIO(par),
                                                 device="cpu")
    dev_truth = {nm: abs(fitted.model.get_param(nm).value
                         - truth.get_param(nm).value) / fitted.errors[nm]
                 for nm in truth.free_params}
    worst = max(dev_truth, key=dev_truth.get)
    print(f"{label} downhill: from {', '.join(offsets)} 3 sigma off; "
          f"fitted parameters within {dev_truth[worst]:.3f} sigma of the "
          f"simulated truth ({worst}; limit {ZOO_TRUTH_SIGMA})")
    if dev_truth[worst] > ZOO_TRUTH_SIGMA:
        fail(f"{label}: {worst} fitted {dev_truth[worst]:.3f} sigma from "
             "the simulated truth")
    return {"ntoa": toas.ntoas, "nfree": len(model.free_params),
            "build_s": build_s,
            **{k: tm[k] for k in ("host_ms", "event_ms", "launches_per_step",
                                  "busy_share", "stages_ms",
                                  "stage_spans_ms", "top_ops_ms")},
            "cpu_step_ms": step["cpu_step_ms"],
            "gpu_vs_cpu": {k: step[k] for k in (
                "dp_sigma", "cov_rel", "chi2_rel", "chi2_moved_by_resids",
                "chi2_rel_unexplained", "resid_s")},
            "hybrid_vs_step": step["hybrid_vs_step"],
            "downhill": {**out, "truth_sigma_max": dev_truth[worst],
                         "truth_worst": worst}}


def zoo_wideband_phase(dev) -> dict:
    """zoo-msp-wb: config 3 (config3_build) plus its SWX windows about the
    December conjunctions and DMWaveX at k/T (k = 1..ZOO_WB_NDMWX), first
    without NE_SW and then with it free (astrometry's tangents then join
    the DM rows' jacfwd): each stacked step on the GPU against the CPU
    (fit_step_check, wideband), timed and profiled (the
    fit_step.dm_jacobian span); the model DM on the GPU against the
    CPU's within 1e-12 pc/cm^3."""
    import torch

    from pint_tpu_torch.models import get_model

    t0 = time.perf_counter()
    _, base, toas = config3_build(CONFIG3_NTOA, CONFIG3_NDMX, dev)
    build_s = time.perf_counter() - t0
    span = CONFIG3_SPAN[1] - CONFIG3_SPAN[0]
    extra = ["DMWXEPOCH 54500"] + fourier_lines("DMWX", ZOO_WB_NDMWX, span)
    for i, (lo, hi) in enumerate(conjunction_windows(CONFIG3_SPAN,
                                                     ZOO_CONJUNCTION), 1):
        extra += [f"SWXDM_{i:04d} 0.0 1", f"SWXR1_{i:04d} {lo!r}",
                  f"SWXR2_{i:04d} {hi!r}"]
    # the TZR TOA at gbt: at '@' with a finite TZRFRQ the Sun is ~0.005 AU
    # away, and that TOA's solar-wind DM makes NE_SW's column nearly the
    # offset's (see ZOO_MSP_PAR)
    text = re.sub(r"(?m)^TZRSITE.*$", "TZRSITE gbt", base.as_parfile())
    out = {"ntoa": toas.ntoas, "build_s": build_s}
    for tag, lines in (("without_ne_sw", extra),
                       ("with_ne_sw", ["NE_SW 8.0 1"] + extra)):
        model = get_model(io.StringIO(text + "\n".join(lines) + "\n"),
                          device=dev)
        label = f"zoo-msp-wb ({tag.replace('_', ' ')})"
        step = fit_step_check(model, toas, dev, f"{label} step",
                              hybrid=tag == "with_ne_sw", explain_chi2=True,
                              wideband=True)
        tm = fit_time(step["step"], step["args"], f"{label} step")
        dm_g = model.total_dm(toas)
        torch.cuda.synchronize()
        dm_c = model.total_dm(toas, device="cpu")
        dm_err = float(torch.max(torch.abs(dm_g.cpu() - dm_c)))
        ndm = len(model.dm_affecting_free_params() & set(model.free_params))
        span_ms = tm["stage_spans_ms"].get("fit_step.dm_jacobian")
        print(f"{label}: {len(model.free_params)} free, {ndm} of them move "
              f"the DM rows; fit_step.dm_jacobian span {span_ms} ms a "
              f"step; model DM GPU vs CPU {dm_err:.3e} pc/cm^3 (limit "
              "1e-12)")
        if not dm_err <= 1e-12:
            fail(f"{label}: the model DM differs between GPU and CPU")
        out[tag] = {
            "nfree": len(model.free_params), "ndm_params": ndm,
            "dm_jacobian_span_ms": span_ms, "dm_gpu_vs_cpu": dm_err,
            **{k: tm[k] for k in ("host_ms", "event_ms", "launches_per_step",
                                  "busy_share", "stages_ms",
                                  "stage_spans_ms")},
            "cpu_step_ms": step["cpu_step_ms"],
            "gpu_vs_cpu": {k: step[k] for k in (
                "dp_sigma", "cov_rel", "chi2_rel", "chi2_rel_unexplained",
                "resid_s")},
            "hybrid_vs_step": step.get("hybrid_vs_step")}
    return out


def pulsed_under_model(par: str, mjd, target, w, dev, tmp: str) -> dict:
    """Event columns of barycentred photons pulsed under the model of
    `par` itself: the photons at `mjd`, each moved within its pulse period
    by one Newton step on the model's own phase, computed by the port on
    `dev`, towards its `target` phase: t + (target - phase(t)) / F(t), F(t)
    the model's spin-down Taylor frequency. The step's error (for a
    glitch, WAVE or IFUNC ephemeris, their frequency terms over a shift of
    at most half a period) is under 1e-5 turns."""
    from pint_tpu_torch.event_toas import load_fits_TOAs
    from pint_tpu_torch.models import get_model

    order = np.argsort(mjd)
    mjd, target, w = mjd[order], target[order], w[order]
    times = ((mjd - NICER_MJDREF[0]) - NICER_MJDREF[1]) * 86400.0
    cand = os.path.join(tmp, "candidates.fits")
    write_events(cand, {"TIME": times, "WEIGHT": w})
    model = get_model(par, device=dev)
    frac = model.phase(load_fits_TOAs(cand, weightcolumn="WEIGHT",
                                      device=dev)).frac.cpu().numpy()
    dt = (mjd - model.PEPOCH.value) * 86400.0
    f = sum(model.get_param(name).value * dt ** k / math.factorial(k)
            for k, name in enumerate(
                model.components["Spindown"].f_terms()))
    times = times + (np.mod(target - frac + 0.5, 1.0) - 0.5) / f
    order = np.argsort(times)
    return {"TIME": times[order], "WEIGHT": w[order]}


def zoo_photon_columns(par: str, n: int, seed: int, dev, tmp: str) -> dict:
    """`n` barycentred photons pulsed under the model of `par` itself
    (pulsed_under_model): uniform times over ZOO_PHOTON_SPAN, each given
    a target phase (the J0030 path's profile: a Gaussian peak at PEAK for
    FRAC_PULSED of them, uniform for the rest)."""
    rng = np.random.default_rng(seed)
    mjd = np.sort(rng.uniform(*ZOO_PHOTON_SPAN, n))
    pulsed = rng.uniform(size=n) < FRAC_PULSED
    target = np.where(pulsed,
                      np.mod(PEAK + WIDTH * rng.standard_normal(n), 1.0),
                      rng.uniform(size=n))
    w = np.where(pulsed, rng.uniform(0.5, 1.0, n), rng.uniform(0.0, 0.5, n))
    return pulsed_under_model(par, mjd, target, w, dev, tmp)


def zoo_photon_phase(zmod, dev, n: int, m: int, seed: int,
                     h_j0030: float) -> dict:
    """zoo-photon: photons pulsed under ZOO_PHOTON_PAR (glitch, WAVE,
    IFUNC) through phase_exact (GPU vs CPU) and phase_path (photonphase
    through K1 on the GPU); H at least ZOO_PHOTON_H_SHARE of the J0030
    path's on as many photons with the same profile."""
    with tempfile.TemporaryDirectory() as tmp:
        par = os.path.join(tmp, "zoo_young.par")
        with open(par, "w") as f:
            f.write("\n".join(ZOO_PHOTON_PAR) + "\n")
        t0 = time.perf_counter()
        cols = zoo_photon_columns(par, n, seed, dev, tmp)
        draw_s = time.perf_counter() - t0
        cold_s = phase_exact(dev, cols, par, tmp)
        path = phase_path(zmod, dev, cols, par, m, tmp)
    print(f"zoo-photon: {n} photons drawn under the glitch/WAVE/IFUNC "
          f"ephemeris in {draw_s:.3f} s; H {path['h']:.2f} against the "
          f"J0030 path's {h_j0030:.2f} (limit {ZOO_PHOTON_H_SHARE} of it); "
          f"K1 launches {path['launches']}")
    if not path["h"] >= ZOO_PHOTON_H_SHARE * h_j0030:
        fail("zoo-photon: the H-test does not detect the pulsation")
    return {"n": n, "draw_s": draw_s, "cold_phase_s": cold_s,
            "h": path["h"], "h_j0030": h_j0030,
            "launches": path["launches"], "stages": path["stages"]}


def zoo_sweep(ntoa: int, dev) -> dict:
    """Each ZOO_SWEEP component alone on ZOO_SWEEP_BASE, then SWM 1 with
    SWP free, then DMWaveX + NE_SW + SWX without TZRFRQ on TOAs of which
    every tenth is barycentred: at `ntoa` TOAs (gbt and arecibo, 430 to
    2300 MHz), the GPU delay and phase against the CPU's (ZOO_DELAY_S,
    equal pulse numbers and fractions within F0 ZOO_DELAY_S, what that
    delay difference moves the phase by) and the GPU design matrix
    against the CPU's (finite, ZOO_DESIGN_REL of each column's largest
    entry)."""
    import torch

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs_array

    rng = np.random.default_rng(7)
    mjds = np.sort(rng.uniform(*FIT_SPAN, ntoa))
    odd = np.arange(ntoa) % 2 == 1
    obs = np.where(odd, "gbt", "arecibo")
    freqs = np.where(odd, np.tile([820.0, 1400.0], ntoa)[:ntoa],
                     np.tile([430.0, 1400.0, 2300.0], ntoa)[:ntoa])
    toas = get_TOAs_array(mjds, obs=list(obs), freqs=freqs, errors=1.0,
                          device=dev)
    bary = np.arange(ntoa) % 10 == 0
    toas_inf = get_TOAs_array(mjds, obs=list(np.where(bary, "@", obs)),
                              freqs=np.where(bary, np.inf, freqs),
                              errors=1.0, device=dev)
    rows = [(name, ZOO_SWEEP_BASE + lines, toas)
            for name, lines in ZOO_SWEEP.items()]
    rows.append(("SWM 1, SWP free", ZOO_SWEEP_BASE + [
        "NE_SW 8.0 1", "SWM 1", "SWP 2.3 1"], toas))
    rows.append(("nu = inf", [ln for ln in ZOO_SWEEP_BASE
                              if not ln.startswith("TZRFRQ")]
                 + ZOO_SWEEP["DMWaveX"] + ZOO_SWEEP["SolarWindDispersion"]
                 + ZOO_SWEEP["SolarWindDispersionX"], toas_inf))
    worst = {"delay_s": 0.0, "phase_turns": 0.0, "design_rel": 0.0}
    per = {}
    for name, lines, t in rows:
        model = get_model(io.StringIO("\n".join(lines) + "\n"), device=dev)
        if name in ZOO_SWEEP and name not in model.components:
            fail(f"zoo-sweep: {name} built {sorted(model.components)}")
        t0 = time.perf_counter()
        dg, pg = model.delay(t), model.phase(t)
        Mg, names, _ = model.designmatrix(t)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        dc, pc = model.delay(t, device="cpu"), model.phase(t, device="cpu")
        Mc, cnames, _ = model.designmatrix(t, device="cpu")
        d_err = float(torch.max(torch.abs(dg.cpu() - dc)))
        p_err = float(torch.max(torch.abs(pg.frac.cpu() - pc.frac)))
        Mg, Mc = Mg.cpu().numpy(), Mc.numpy()
        m_err = float(np.max(np.max(np.abs(Mg - Mc), axis=0)
                             / np.maximum(np.max(np.abs(Mc), axis=0),
                                          1e-300)))
        q = sum(k for _, k in model.noise_model_dimensions(t).values())
        ok = (names == cnames and np.all(np.isfinite(Mg))
              and torch.equal(pg.int.cpu(), pc.int) and d_err <= ZOO_DELAY_S
              and p_err <= model.F0.value * ZOO_DELAY_S
              and m_err <= ZOO_DESIGN_REL)
        print(f"zoo-sweep {name:22s}: GPU vs CPU delay {d_err:.3e} s, phase "
              f"{p_err:.3e} turns, design matrix {m_err:.3e} of each "
              f"column's largest, {len(names)} columns, {q} noise columns; "
              f"GPU delay + phase + design matrix {gpu_s:.3f} s")
        if not ok:
            fail(f"zoo-sweep: {name} differs between GPU and CPU")
        per[name] = {"delay_s": d_err, "phase_turns": p_err,
                     "design_rel": m_err, "ncols": len(names),
                     "noise_cols": q, "gpu_s": gpu_s}
        worst = {"delay_s": max(worst["delay_s"], d_err),
                 "phase_turns": max(worst["phase_turns"], p_err),
                 "design_rel": max(worst["design_rel"], m_err)}
    return {"ntoa": ntoa, "worst": worst, "rows": per}


# ------------------------------------------------------ photon sampling


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def peak_mib(fn) -> tuple:
    """(fn(), MiB allocated at the peak of the call above what was
    allocated before it)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def record_hmw() -> tuple:
    """(H values, restore): eventstats.hmw wrapped to record what it
    returns, in call order, for the CLIs that import it at run time."""
    from pint_tpu_torch import eventstats

    seen, real = [], eventstats.hmw

    def hmw(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    eventstats.hmw = hmw
    return seen, lambda: setattr(eventstats, "hmw", real)


def run_main(main, argv) -> tuple:
    """(return code, standard output) of a CLI's main(argv), its output
    echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    out = buf.getvalue()
    print(out, end="")
    return rc, out


def stage_seconds(out: str) -> dict:
    return json.loads(re.search(r"Stage seconds: (\{.*\})", out).group(1))


def photon_build(n: int, seed: int, tmp: str, dev) -> dict:
    """PH_PAR and event_draws' `n` photons made pulsed under its model
    (pulsed_under_model: the model delays barycentred photons by the
    Sun's Shapiro delay, which event_draws' spin-down leaves out, 5.7e-11
    Hz of F0 over the 200 days, ROADMAP.md §3) as files, the TOAs on
    `dev`, the model's phases there and the photon weights."""
    import torch

    from pint_tpu_torch.event_toas import get_event_weights, load_fits_TOAs
    from pint_tpu_torch.models import get_model

    par = os.path.join(tmp, "j0030_f0f1.par")
    with open(par, "w") as f:
        f.write(PH_PAR)
    t0 = time.perf_counter()
    cols = pulsed_under_model(par, *event_draws(n, seed), dev, tmp)
    draw_s = time.perf_counter() - t0
    ev = os.path.join(tmp, "photons.fits")
    write_events(ev, cols)
    t0 = time.perf_counter()
    toas = load_fits_TOAs(ev, weightcolumn="WEIGHT", device=dev)
    ingest_s = time.perf_counter() - t0
    model = get_model(par, device=dev)
    phases = torch.remainder(model.phase(toas).frac, 1.0)
    return {"par": par, "ev": ev, "cols": cols, "toas": toas,
            "phases": phases, "weights": get_event_weights(toas),
            "draw_s": draw_s, "ingest_s": ingest_s}


def seed_template(phases: np.ndarray, weights: np.ndarray, dev):
    """event_optimize's seeding recipe: one Gaussian at the first
    harmonic's phase, its norm the clamped pulsed fraction, width 0.05."""
    from pint_tpu_torch.templates import LCGaussian, LCTemplate

    c1 = np.sum(weights * np.exp(2j * np.pi * phases))
    loc0 = float(np.angle(c1) / (2 * np.pi)) % 1.0
    frac = min(0.9, max(0.1, 2.0 * np.abs(c1) / np.sum(weights)))
    return LCTemplate([LCGaussian()], norms=[frac], locs=[loc0],
                      widths=[0.05], device=dev)


def photon_templates_check(phases, seed: int, dev) -> dict:
    """(a) every primitive, PH_SPECS' mixed template and an LCEnergyTemplate
    with nonzero slopes: the pdf on the card against the CPU at the path's
    phases (energies log-uniform over 0.1-10 keV from default_rng(seed)),
    within PH_PDF_REL of the pdf's largest value; LCTemplate.random on the
    card gives the CPU's PH_DRAWS draws."""
    from pint_tpu_torch.templates import make_template
    from pint_tpu_torch.templates.energy import LCEnergyTemplate

    ph = phases.cpu().numpy()
    energies = 10.0 ** np.random.default_rng(seed).uniform(-1, 1, len(ph))
    errs, card_s = {}, {}
    for name, spec in PH_SPECS.items():
        g, c = (make_template(spec, device=d) for d in (dev, "cpu"))
        t0 = time.perf_counter()
        pg = g(ph)
        card_s[name] = time.perf_counter() - t0
        pc = c(ph)
        errs[name] = float(np.max(np.abs(pg - pc)) / np.max(pc))
        same = np.array_equal(g.random(PH_DRAWS, np.random.default_rng(1)),
                              c.random(PH_DRAWS, np.random.default_rng(1)))
        if not (errs[name] <= PH_PDF_REL and same):
            fail(f"photon-templates: {name} on the card differs from the "
                 f"CPU (pdf {errs[name]:.3e} of its largest value, limit "
                 f"{PH_PDF_REL}; draws equal {same})")
    g, c = (LCEnergyTemplate(make_template(PH_ENERGY_BASE, device=d),
                             device=d, **PH_SLOPES) for d in (dev, "cpu"))
    t0 = time.perf_counter()
    pg = g(ph, energies)
    card_s["energy"] = time.perf_counter() - t0
    pc = c(ph, energies)
    errs["energy"] = float(np.max(np.abs(pg - pc)) / np.max(pc))
    print(f"photon-templates: 7 primitives, a mixed template and an "
          f"LCEnergyTemplate at {len(ph)} phases: card vs CPU worst "
          f"{max(errs.values()):.3e} of the pdf's largest value (limit "
          f"{PH_PDF_REL}), {PH_DRAWS} random draws equal; pdf calls on the "
          f"card {sum(card_s.values()):.3f} s (host clock, copies included)")
    if not errs["energy"] <= PH_PDF_REL:
        fail(f"photon-templates: the energy template on the card differs "
             f"from the CPU by {errs['energy']:.3e}")
    return {"n": len(ph), "pdf_rel": errs, "card_s": card_s}


def counted_fitter(fitter) -> list:
    """Count the fitter's value-and-gradient calls (one a BFGS call)."""
    calls, vg = [0], fitter._valgrad

    def counted(theta):
        calls[0] += 1
        return vg(theta)

    fitter._valgrad = counted
    return calls


def hessian_err(nll, theta: np.ndarray, held) -> np.ndarray:
    """sqrt(diag(H^-1)) of `nll` at theta over the entries not `held`
    (0 at those)."""
    import torch

    keep = np.ones(len(theta), bool)
    keep[list(held)] = False
    H = torch.func.hessian(nll)(torch.as_tensor(theta)).cpu().numpy()
    err = np.zeros(len(theta))
    err[keep] = np.sqrt(np.diag(np.linalg.inv(H[np.ix_(keep, keep)])))
    return err


def softmax_gauge(theta: np.ndarray, m: int) -> np.ndarray:
    """An energy template's theta with the logits and the logit slopes
    taken relative to the background's (adding one number to every logit,
    or to every slope, changes no pdf)."""
    t = np.array(theta, dtype=np.float64)
    t[:m + 1] -= theta[0]
    t[3 * m + 1:4 * m + 2] -= theta[3 * m + 1]
    return t


def photon_lcfit_check(phases, weights: np.ndarray, seed: int,
                       dev) -> tuple:
    """(b) LCFitter from event_optimize's seed template on the first
    PH_LCFIT_N photons, on the card and on the CPU, the background logit
    held (softmax's one redundant direction, which leaves the Hessian
    singular when free): log-likelihoods within PH_REL relative, each free
    theta within PH_THETA_SIGMA of its Hessian error, the loc's and
    width's theta_err within PH_ERR_REL relative (the weights carry the
    background, so the norm runs to 1 and its logit's error is noise);
    then the fit at full width on the card (loc within
    PH_LOC_SIGMA errors of PEAK, width within PH_WIDTH_REL of WIDTH), and
    LCEnergyFitter card vs CPU on PH_ENERGY_N photons (theta in the
    softmax gauge). Returns (results, the full-width template)."""
    import torch

    from pint_tpu_torch.templates import LCFitter
    from pint_tpu_torch.templates.energy import (LCEnergyFitter,
                                                 LCEnergyTemplate)

    ph_all, n = phases.cpu().numpy(), min(PH_LCFIT_N, len(weights))
    fits = {}
    for tag, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        t = seed_template(ph_all[:n], weights[:n], d)
        free = t.param_mask()
        free[0] = False
        f = LCFitter(t, phases[:n].to(d), weights=weights[:n], device=d)
        calls = counted_fitter(f)
        t0 = time.perf_counter()
        res = f.fit(free=free)
        sync(d)
        fits[tag] = (t, res, time.perf_counter() - t0, calls[0])
    (tg, rg, sg, cg), (tc, rc, sc, cc) = fits["gpu"], fits["cpu"]
    ll_rel = abs(rg["loglikelihood"] - rc["loglikelihood"]) \
        / abs(rc["loglikelihood"])
    th_sigma = float(np.max(np.abs(tg.theta - tc.theta)[free]
                            / rc["theta_err"][free]))
    # theta_err of the locs and widths: the logits are held or flat (the
    # weights carry the background, so the fitted norm runs to 1)
    shape = np.arange(len(free)) > 1
    err_rel = float(np.max(np.abs(rg["theta_err"] - rc["theta_err"])[shape]
                           / rc["theta_err"][shape]))
    print(f"photon-lcfit: LCFitter on {n} photons, card {sg:.3f} s "
          f"({rg['iterations']} iterations, {cg} calls), CPU {sc:.3f} s "
          f"({rc['iterations']}, {cc}): logL {rg['loglikelihood']!r} vs "
          f"{rc['loglikelihood']!r} ({ll_rel:.3e} relative, limit {PH_REL}); "
          f"theta within {th_sigma:.3e} of its errors (limit "
          f"{PH_THETA_SIGMA}), theta_err {err_rel:.3e} relative (limit "
          f"{PH_ERR_REL})")
    if not (rg["success"] and rc["success"] and ll_rel <= PH_REL
            and th_sigma <= PH_THETA_SIGMA and err_rel <= PH_ERR_REL):
        fail("photon-lcfit: the card's LCFitter does not reach the CPU's "
             "optimum")
    # the full width on the card
    t = seed_template(ph_all, weights, dev)
    f = LCFitter(t, phases, weights=weights, device=dev)
    calls = counted_fitter(f)
    t0 = time.perf_counter()
    res = f.fit(free=free)
    sync(dev)
    wall = time.perf_counter() - t0
    theta = torch.as_tensor(t.theta, device=dev)
    times = []
    for _ in range(11):
        t0 = time.perf_counter()
        f._valgrad(theta)[0].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    call_ms = float(np.median(times[1:]))
    loc, loc_err, width = t.locs[0], res["theta_err"][2], t.widths[0][0]
    print(f"photon-lcfit: full width ({len(weights)} photons) on the card: "
          f"{res['iterations']} iterations, {calls[0]} value-and-gradient "
          f"calls in {wall:.3f} s ({wall / calls[0] * 1e3:.3f} ms a call in "
          f"the fit, {call_ms:.3f} ms alone, median of 10); loc {loc:.6f} +- {loc_err:.2e} "
          f"(truth {PEAK}), width {width:.6f} (truth {WIDTH}), norm "
          f"{t.norms[0]:.4f}")
    if not (res["success"] and abs(loc - PEAK) <= PH_LOC_SIGMA * loc_err
            and abs(width - WIDTH) <= PH_WIDTH_REL * WIDTH):
        fail("photon-lcfit: the full-width fit misses the injected peak")
    # LCEnergyFitter on energies log-uniform over 0.1-10 keV
    ne = min(PH_ENERGY_N, len(weights))
    en = 10.0 ** np.random.default_rng(seed).uniform(-1, 1, ne)
    efits = {}
    for tag, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        et = LCEnergyTemplate(seed_template(ph_all[:ne], weights[:ne], d),
                              device=d)
        ef = LCEnergyFitter(et, phases[:ne].to(d), en, weights=weights[:ne],
                            device=d)
        t0 = time.perf_counter()
        eres = ef.fit()
        sync(d)
        efits[tag] = (et, eres, time.perf_counter() - t0, ef)
    (eg, erg, esg, _), (ec, erc, esc, efc) = efits["gpu"], efits["cpu"]
    # softmax gauge: each logit and logit slope taken relative to the
    # background's, which carry no information of their own
    gauge = (0, 3 * ec.m + 1)
    eerr = hessian_err(efc._nll, ec.theta, gauge)
    keep = eerr > 0
    e_ll = abs(erg["loglikelihood"] - erc["loglikelihood"]) \
        / abs(erc["loglikelihood"])
    e_sigma = float(np.max(np.abs(softmax_gauge(eg.theta, ec.m)
                                  - softmax_gauge(ec.theta, ec.m))[keep]
                           / eerr[keep]))
    print(f"photon-lcfit: LCEnergyFitter on {ne} photons, card {esg:.3f} s "
          f"({erg['iterations']} iterations), CPU {esc:.3f} s: logL "
          f"{e_ll:.3e} relative (limit {PH_REL}), theta within "
          f"{e_sigma:.3e} of its Hessian errors (limit {PH_THETA_SIGMA})")
    if not (erg["success"] and erc["success"] and e_ll <= PH_REL
            and e_sigma <= PH_THETA_SIGMA):
        fail("photon-lcfit: the card's LCEnergyFitter does not reach the "
             "CPU's optimum")
    return {"n": n, "gpu_s": sg, "cpu_s": sc, "iterations": rg["iterations"],
            "calls": cg, "ll_rel": ll_rel, "theta_sigma": th_sigma,
            "theta_err_rel": err_rel,
            "full": {"n": len(weights), "wall_s": wall,
                     "iterations": res["iterations"], "calls": calls[0],
                     "ms_per_call_in_fit": wall / calls[0] * 1e3,
                     "ms_per_call": call_ms, "loc": loc, "loc_err": loc_err,
                     "width": width, "norm": float(t.norms[0])},
            "energy": {"n": ne, "gpu_s": esg, "cpu_s": esc,
                       "iterations": erg["iterations"], "ll_rel": e_ll,
                       "theta_sigma": e_sigma}}, t


def photon_fitter(toas, par: str, template, weights, dev, nwalkers: int,
                  seed: int, frozen=()):
    """PhotonMCMCFitter of the model of `par` on `dev`."""
    from pint_tpu_torch.mcmc_fitter import PhotonMCMCFitter
    from pint_tpu_torch.models import get_model

    model = get_model(par, device=dev)
    for name in frozen:
        model.get_param(name).frozen = True
    model.invalidate_cache()
    return PhotonMCMCFitter(toas, model, template, weights=weights,
                            nwalkers=nwalkers,
                            rng=np.random.default_rng(seed))


def photon_batch_check(pb: dict, template, seed: int, tmp: str,
                       dev) -> tuple:
    """(c) PhotonMCMCFitter._photon_lnlike_batch at PH_WALKERS points
    (PH_SCALES about the par's F0 and F1, default_rng(seed)): the card
    against the CPU on the first PH_BATCH_N photons (PH_REL relative), the
    vmapped device core (lnpost_batch) against the host _lp_batch at full
    width (bitwise); one half-ensemble profiled (launches, busy ms, idle
    share) and its peak device memory. Returns (results, fitter, points)."""
    import torch

    from pint_tpu_torch import config
    from pint_tpu_torch.event_toas import load_fits_TOAs

    w = pb["weights"]
    fitter = photon_fitter(pb["toas"], pb["par"], template, w, dev,
                           2 * PH_WALKERS, seed)
    th = fitter.theta0[None, :] + np.asarray(PH_SCALES)[None, :] \
        * np.random.default_rng(seed).standard_normal((PH_WALKERS, 2))
    n = min(PH_BATCH_N, len(w))
    head = os.path.join(tmp, "photons_batch_head.fits")
    write_events(head, {k: v[:n] for k, v in pb["cols"].items()})
    sub = load_fits_TOAs(head, weightcolumn="WEIGHT", device=dev)
    ll = {}
    for tag, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        f = photon_fitter(sub, pb["par"], template, w[:n], d,
                          2 * PH_WALKERS, seed)
        t0 = time.perf_counter()
        ll[tag] = f._photon_lnlike_batch(th)
        ll[tag + "_s"] = time.perf_counter() - t0
    rel = rel_err(ll["gpu"], ll["cpu"], PH_REL)
    host = fitter._lp_batch(th)
    half = torch.as_tensor(th, device=dev)
    dev_core = fitter.lnpost_batch(half).cpu().numpy()
    same = np.array_equal(host, dev_core)
    times = []
    for _ in range(5):
        sync(dev)
        t0 = time.perf_counter()
        fitter.lnpost_batch(half)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    prof = device_busy(lambda: fitter.lnpost_batch(half),
                       f"photon lnpost_batch ({PH_WALKERS} walkers x "
                       f"{len(w)} photons)")
    _, peak = peak_mib(lambda: fitter.lnpost_batch(half))
    cost = supervision_cost(lambda: fitter.lnpost_batch(half),
                            "sampling.chain", dev, "photon half-ensemble")
    chunk = config.photon_walker_chunk(len(w))
    per_wp = peak * 2 ** 20 / (PH_WALKERS * len(w) * 8)
    res = {"walkers": PH_WALKERS, "n": len(w), "n_cpu_check": n,
           "gpu_vs_cpu_rel": rel, "gpu_head_s": ll["gpu_s"],
           "cpu_head_s": ll["cpu_s"], "device_core_eq_host": same,
           "host_ms": float(np.median(times)), "host_ms_min_max":
           [min(times), max(times)], **prof, "peak_mib": peak,
           "peak_float64_per_walker_photon": per_wp, "walker_chunk": chunk,
           "lnlike_range": [float(host.min()), float(host.max())],
           "supervision": cost}
    print(f"photon-batch: {PH_WALKERS} walkers, card vs CPU on {n} photons "
          f"{rel:.3e} relative (limit {PH_REL}); device core == host "
          f"_lp_batch at {len(w)} photons: {same}; a half-ensemble "
          f"{res['host_ms']:.3f} ms (host clock, median of 5), peak "
          f"{peak:.1f} MiB ({per_wp:.1f} float64 a walker-photon; walker "
          f"chunk {chunk}); lnL in [{host.min():.6e}, {host.max():.6e}]")
    if not (rel <= PH_REL and same and np.all(np.isfinite(host))
            and np.ptp(host) > 1.0):
        fail("photon-batch: the card's photon likelihood disagrees")
    return res, fitter, th


def curvature_sigma(fitter, k: int = 0) -> float:
    """The photon log-likelihood's error in parameter k, from its
    curvature: a parabola through 5 points at +-2 sigma, sigma first
    taken from 3 points at +-4e-12."""
    x0 = fitter.theta0
    sigma = 4e-12
    for offs in ((-1.0, 0.0, 1.0), (-2.0, -1.0, 0.0, 1.0, 2.0)):
        th = np.repeat(x0[None, :], len(offs), 0)
        th[:, k] += sigma * np.asarray(offs)
        ll = fitter._photon_lnlike_batch(th)
        curv = np.polyfit(np.asarray(offs) * sigma, ll, 2)[0] * 2.0
        if not curv < 0:
            fail(f"photon-chain: the likelihood is not peaked in F0 "
                 f"(curvature {curv:.3e})")
        sigma = 1.0 / math.sqrt(-curv)
    return sigma


def photon_chain_check(pb: dict, fitter, template, seed: int, dev) -> dict:
    """(d) scan against host_loop over PH_EXACT_STEPS steps of the 32-walker
    ensemble (bitwise); then F1 frozen at the truth and F0 started
    PH_REC_OFFSET sigma off (sigma from the curvature of the photon
    log-likelihood in F0), PH_REC_WALKERS walkers x PH_REC_STEPS steps with
    scatter sigma/F0 (an initial spread of 1 sigma): the median within
    PH_TRUTH_SIGMA sigma of the truth, acceptance in PH_ACCEPT."""
    from pint_tpu_torch.mcmc_fitter import PhotonMCMCFitter
    from pint_tpu_torch.sampling import DeviceEnsembleSampler

    p0 = fitter.theta0[None, :] + np.asarray(PH_SCALES)[None, :] \
        * np.random.default_rng(seed).standard_normal((2 * PH_WALKERS, 2))
    out, secs = [], {}
    for mode in ("scan", "host_loop"):
        s = DeviceEnsembleSampler(2 * PH_WALKERS, 2, fitter.lnpost_batch,
                                  device=dev)
        t0 = time.perf_counter()
        pos = s.run_mcmc(p0, PH_EXACT_STEPS, seed=seed, mode=mode)
        secs[mode] = time.perf_counter() - t0
        out.append((s, pos))
    (a, pa), (b, pbb) = out
    same = (np.array_equal(pa, pbb) and np.array_equal(a.chain, b.chain)
            and np.array_equal(a.lnprob, b.lnprob)
            and a.naccepted == b.naccepted)
    print(f"photon-chain: {2 * PH_WALKERS} walkers x {PH_EXACT_STEPS} steps, "
          f"scan {secs['scan']:.3f} s, host_loop {secs['host_loop']:.3f} s: "
          f"bitwise equal {same}; acceptance {a.acceptance_fraction:.3f}")
    if not same or not np.all(np.isfinite(a.lnprob)):
        fail("photon-chain: scan and host_loop differ on the card")
    probe = photon_fitter(pb["toas"], pb["par"], template, pb["weights"],
                          dev, PH_REC_WALKERS, seed + 1, frozen=("F1",))
    sigma = curvature_sigma(probe)
    model = probe.model
    model.F0.value = F0 + PH_REC_OFFSET * sigma
    model.invalidate_cache(params_only=True)
    rec = PhotonMCMCFitter(pb["toas"], model, template,
                           weights=pb["weights"], nwalkers=PH_REC_WALKERS,
                           rng=np.random.default_rng(seed + 2))
    scatter = sigma / F0
    t0 = time.perf_counter()
    lnmax = rec.fit_toas(nsteps=PH_REC_STEPS, scatter=scatter)
    wall = time.perf_counter() - t0
    med, acc = rec.model.F0.value, rec.sampler.acceptance_fraction
    off = abs(med - F0) / sigma
    res = {"exact_steps": PH_EXACT_STEPS, "scan_s": secs["scan"],
           "host_loop_s": secs["host_loop"], "sigma_f0": sigma,
           "start_sigma": PH_REC_OFFSET, "scatter": scatter,
           "walkers": PH_REC_WALKERS, "steps": PH_REC_STEPS, "wall_s": wall,
           "steps_per_s": PH_REC_STEPS / wall,
           "walker_steps_per_s": PH_REC_STEPS * PH_REC_WALKERS / wall,
           "median_off_sigma": off, "std_over_sigma":
           rec.errors["F0"] / sigma, "acceptance": acc, "lnmax": lnmax,
           "chunks": rec.sampler.dispatches}
    print(f"photon-chain: recovery, F0 sigma {sigma:.4e} Hz (curvature on "
          f"the card), start {PH_REC_OFFSET} sigma off, scatter "
          f"{scatter:.4e} (1 sigma), {PH_REC_WALKERS} walkers x "
          f"{PH_REC_STEPS} steps in {wall:.3f} s ({res['steps_per_s']:.3f} "
          f"steps/s, {res['walker_steps_per_s']:.1f} walker-steps/s): median "
          f"{off:.3f} sigma from the truth (limit {PH_TRUTH_SIGMA}), std "
          f"{res['std_over_sigma']:.3f} sigma, acceptance {acc:.3f}")
    if not (off <= PH_TRUTH_SIGMA and PH_ACCEPT[0] < acc < PH_ACCEPT[1]):
        fail("photon-chain: the chain does not recover F0")
    return res


def photon_event_optimize(zmod, pb: dict, seed: int, tmp: str, m: int,
                          dev) -> dict:
    """(e) event_optimize on the path's events at full width on the card
    (PH_PAR, its template seeded by ML, 32 walkers x PH_EO_STEPS steps):
    it returns 0, writes a (nsteps, nwalkers, ndim) chain (the reference's
    layout) and a par file that get_model reads; K1 launched exactly twice,
    each H within H_REL of the float64 plain H of the same model's
    phases."""
    import torch

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.scripts import event_optimize

    out_par = os.path.join(tmp, "optimized.par")
    npz = os.path.join(tmp, "chains.npz")
    hs, restore = record_hmw()
    zmod.launches = 0
    try:
        rc, out = run_main(event_optimize.main, [
            pb["ev"], pb["par"], "--weightcol", "WEIGHT", "--nsteps",
            PH_EO_STEPS, "--seed", seed, "--outfile", out_par,
            "--chains-npz", npz])
    finally:
        restore()
    launches = zmod.launches
    if rc != 0:
        fail(f"event-optimize returned {rc}")
    d = np.load(npz)
    if d["chain"].shape != (PH_EO_STEPS, 32, 2) or \
            list(d["labels"]) != ["F0", "F1"]:
        fail(f"event-optimize: chain {d['chain'].shape} of {d['labels']}")
    plain = []
    for par in (pb["par"], out_par):
        model = get_model(par, device=dev)
        ph = torch.remainder(model.phase(pb["toas"]).frac, 1.0)
        plain.append(plain_h(zmod, ph, pb["weights"], m, dev))
    zmod.launches = 0
    worst = max(abs(h - p) / max(1.0, p) for h, p in zip(hs, plain))
    stages = stage_seconds(out)
    res = {"launches": launches, "h": hs, "h_plain": plain,
           "h_rel": worst, "stages": stages, "steps": PH_EO_STEPS,
           "f0": float(model.F0.value), "f1": float(model.F1.value)}
    print(f"event-optimize: {launches} K1 launches, H {hs} against the "
          f"float64 plain {plain} ({worst:.3e} relative, limit {H_REL}); "
          f"stages {stages}")
    if not (launches == 2 and len(hs) == 2 and worst <= H_REL
            and stages["device"] == torch.device(dev).type):
        fail("event-optimize: K1 was not launched exactly twice or an H "
             "disagrees with the plain version")
    return res


def photon_composite_check(cols: dict, template, seed: int, tmp: str,
                           dev) -> dict:
    """(f) CompositeMCMCFitter: COMPOSITE_NTOA gbt 1400 MHz TOAs simulated
    by the port from PAR with F0 free, plus the first COMPOSITE_N photons,
    COMPOSITE_WALKERS walkers x COMPOSITE_STEPS steps (tests/test_mcmc.py:
    188's shape): _lp_batch on the card against the CPU at 8 points
    (PH_REL), F0 within 5 of its errors of the truth."""
    import torch

    from pint_tpu_torch.event_toas import get_event_weights, load_fits_TOAs
    from pint_tpu_torch.mcmc_fitter import CompositeMCMCFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    par = PAR.replace("F0 205.53069927\n", "F0 205.53069927 1\n")
    n = min(COMPOSITE_N, len(cols["TIME"]))
    head = os.path.join(tmp, "photons_composite.fits")
    write_events(head, {k: v[:n] for k, v in cols.items()})
    toas_ev = load_fits_TOAs(head, weightcolumn="WEIGHT", device=dev)
    w = get_event_weights(toas_ev)
    radio = make_fake_toas_uniform(
        56400.0, 56600.0, COMPOSITE_NTOA, get_model(io.StringIO(par),
                                                    device=dev),
        error_us=1.0, obs="gbt", freq_mhz=1400.0, add_noise=True,
        rng=np.random.default_rng(seed), device=dev)
    fitters = {}
    for tag, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        fitters[tag] = CompositeMCMCFitter(
            radio, toas_ev, get_model(io.StringIO(par), device=d), template,
            weights=w, nwalkers=COMPOSITE_WALKERS,
            rng=np.random.default_rng(seed + 1))
    fg = fitters["gpu"]
    th = fg.theta0[None, :] + 2e-11 * np.random.default_rng(
        seed + 2).standard_normal((COMPOSITE_WALKERS, 1))
    lp = {}
    for tag, f in fitters.items():
        t0 = time.perf_counter()
        lp[tag] = f._lp_batch(th)
        lp[tag + "_s"] = time.perf_counter() - t0
    rel = rel_err(lp["gpu"], lp["cpu"], PH_REL)
    t0 = time.perf_counter()
    lnmax = fg.fit_toas(nsteps=COMPOSITE_STEPS)
    wall = time.perf_counter() - t0
    f0, unc = fg.model.F0.value, fg.model.F0.uncertainty
    res = {"ntoa": COMPOSITE_NTOA, "nphotons": n, "gpu_vs_cpu_rel": rel,
           "gpu_batch_s": lp["gpu_s"], "cpu_batch_s": lp["cpu_s"],
           "walkers": COMPOSITE_WALKERS, "steps": COMPOSITE_STEPS,
           "wall_s": wall, "steps_per_s": COMPOSITE_STEPS / wall,
           "f0_off_over_err": abs(f0 - F0) / unc, "f0_err": unc,
           "lnmax": lnmax, "acceptance": fg.sampler.acceptance_fraction}
    print(f"composite: {COMPOSITE_NTOA} radio TOAs + {n} photons, "
          f"_lp_batch card vs CPU {rel:.3e} relative (limit {PH_REL}; card "
          f"{lp['gpu_s']:.3f} s, CPU {lp['cpu_s']:.3f} s); {COMPOSITE_WALKERS}"
          f" walkers x {COMPOSITE_STEPS} steps in {wall:.3f} s: F0 "
          f"{res['f0_off_over_err']:.3f} of its error {unc:.3e} from the "
          f"truth (limit 5)")
    if not (rel <= PH_REL and np.isfinite(lnmax)
            and res["f0_off_over_err"] <= 5.0 and 0 < unc < 1e-5):
        fail("composite: the card's joint posterior disagrees or misses F0")
    return res


def fermi_check(zmod, seed: int, tmp: str, m: int, dev) -> dict:
    """(g) a Fermi-LAT-like barycentred FT1 file of FERMI_N photons (the
    path's recipe on Fermi's MJDREF, TELESCOP GLAST, a MODEL_WEIGHT
    column): fermiphase and photonphase --mission fermi --weightcol
    MODEL_WEIGHT on the card give bitwise the same phases and H, H within
    H_REL of the float64 plain H, one K1 launch each."""
    import torch

    from pint_tpu_torch.scripts import fermiphase, photonphase

    par = os.path.join(tmp, "j0030.par")
    with open(par, "w") as f:
        f.write(PAR)
    ft1 = os.path.join(tmp, "ft1.fits")
    write_events(ft1, event_columns(FERMI_N, seed, FERMI_MJDREF,
                                    "MODEL_WEIGHT"), FERMI_MJDREF, "GLAST")
    runs = {}
    for name, main, extra in (
            ("fermiphase", fermiphase.main, []),
            ("photonphase", photonphase.main,
             ["--mission", "fermi", "--weightcol", "MODEL_WEIGHT"])):
        npz = os.path.join(tmp, f"{name}.npz")
        hs, restore = record_hmw()
        zmod.launches = 0
        try:
            rc, out = run_main(main, [ft1, par, "--npz", npz] + extra)
        finally:
            restore()
        if rc != 0 or len(hs) != 1:
            fail(f"fermiphase: {name} returned {rc} ({len(hs)} H-tests)")
        runs[name] = (hs[0], zmod.launches, np.load(npz),
                      stage_seconds(out))
    (ha, la, da, sa), (hb, lb, db, sb) = runs.values()
    same = (ha == hb and np.array_equal(da["phases"], db["phases"])
            and np.array_equal(da["weights"], db["weights"]))
    hp = plain_h(zmod, da["phases"], da["weights"], m, dev)
    zmod.launches = 0
    rel = abs(ha - hp) / max(1.0, hp)
    print(f"fermiphase: {FERMI_N} Fermi-LAT-like photons, H {ha!r} "
          f"(photonphase --mission fermi: {hb!r}, bitwise equal {same}; "
          f"float64 plain {hp!r}, {rel:.3e} relative, limit {H_REL}); K1 "
          f"launches {la} and {lb}")
    if not (same and rel <= H_REL and la == 1 and lb == 1
            and sa["device"] == sb["device"] == torch.device(dev).type):
        fail("fermiphase: the runs differ, H disagrees with the plain "
             "version or K1 was not launched once each")
    return {"n": FERMI_N, "h": ha, "h_plain": hp, "h_rel": rel,
            "launches": [la, lb], "stages": {"fermiphase": sa,
                                             "photonphase": sb}}


def batch_numpy(batch) -> dict:
    out = {k: getattr(batch, k).cpu().numpy() for k in batch._fields
           if k != "tdb_frac"}
    out["tdb_frac_hi"] = batch.tdb_frac.hi.cpu().numpy()
    out["tdb_frac_lo"] = batch.tdb_frac.lo.cpu().numpy()
    return out


def toa_io_check(tmp: str, dev) -> dict:
    """(h) get_TOAs on NGC6440E.tim with usecache=True twice on the card,
    both timed: the second from the cache (tim parsing disabled), the two
    batches bitwise equal; write_TOA_file read back by get_TOAs within
    1e-16 d of the first batch's TDBs."""
    from pint_tpu_torch import toa as toamod

    cdir = os.path.join(tmp, "toacache")
    os.makedirs(cdir)
    t0 = time.perf_counter()
    a = toamod.get_TOAs(NGC[1], usecache=True, cachedir=cdir, device=dev)
    first_s = time.perf_counter() - t0
    real = toamod.parse_tim

    def no_parse(*args, **kw):
        fail("toa-io: the second get_TOAs parsed the tim file")

    toamod.parse_tim = no_parse
    try:
        t0 = time.perf_counter()
        b = toamod.get_TOAs(NGC[1], usecache=True, cachedir=cdir, device=dev)
        second_s = time.perf_counter() - t0
    finally:
        toamod.parse_tim = real
    ba, bb = batch_numpy(a.to_batch()), batch_numpy(b.to_batch())
    same = all(np.array_equal(ba[k], bb[k], equal_nan=True) for k in ba)
    tim = os.path.join(tmp, "ngc_written.tim")
    a.write_TOA_file(tim)
    c = batch_numpy(toamod.get_TOAs(tim, device=dev).to_batch())
    dt = float(np.max(np.abs((c["tdb_day"] - ba["tdb_day"])
                             + (c["tdb_frac_hi"] - ba["tdb_frac_hi"])
                             + (c["tdb_frac_lo"] - ba["tdb_frac_lo"]))))
    print(f"toa-io: NGC6440E ({a.ntoas} TOAs) get_TOAs {first_s:.3f} s, from "
          f"the cache {second_s:.3f} s, batches bitwise equal {same}; "
          f"write_TOA_file read back within {dt:.3e} d (limit 1e-16)")
    if not (same and dt <= 1e-16 and os.listdir(cdir)
            == [".NGC6440E.tim.toacache.npz"]):
        fail("toa-io: the cache or the tim writer does not round-trip")
    return {"ntoa": a.ntoas, "first_s": first_s, "cached_s": second_s,
            "tim_round_trip_d": dt}


def photon_sampling_phase(zmod, n: int, m: int, seed: int, dev) -> dict:
    """Phase 13: photon sampling on `n` photons of the J0030 path's recipe
    (photon_build; gates (a)-(h)); K1 launches are read for each check and
    must be 0 outside event_optimize's and the fermiphase/photonphase
    runs."""
    secs, k1 = {}, {}

    def timed(name, fn, *args):
        zmod.launches = 0
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        k1[name] = zmod.launches
        return out

    with tempfile.TemporaryDirectory() as tmp:
        pb = timed("build", photon_build, n, seed, tmp, dev)
        tmpl = timed("templates", photon_templates_check, pb["phases"],
                     seed + 13, dev)
        lcfit, template = timed("lcfit", photon_lcfit_check, pb["phases"],
                                pb["weights"], seed + 13, dev)
        batch, fitter, _ = timed("batch", photon_batch_check, pb, template,
                                 seed + 13, tmp, dev)
        chain = timed("chain", photon_chain_check, pb, fitter, template,
                      seed + 13, dev)
        del fitter
        eo = timed("event_optimize", photon_event_optimize, zmod, pb,
                   seed + 13, tmp, m, dev)
        comp = timed("composite", photon_composite_check, pb["cols"],
                     template, seed + 13, tmp, dev)
        fermi = timed("fermiphase", fermi_check, zmod, seed + 14, tmp, m,
                      dev)
        tio = timed("toa_io", toa_io_check, tmp, dev)
    k1["event_optimize"], k1["fermiphase"] = eo["launches"], \
        fermi["launches"]
    print("photon sampling seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items())
        + f"; K1 launches {k1} (event_optimize: the initial and final "
        "H-test; fermiphase and photonphase: one each)")
    stray = {k: v for k, v in k1.items()
             if k not in ("event_optimize", "fermiphase") and v}
    if stray:
        fail(f"photon sampling: K1 launched where no H-test runs: {stray}")
    return {"n": len(pb["weights"]), "draw_s": pb["draw_s"],
            "ingest_s": pb["ingest_s"],
            "templates": tmpl, "lcfit": lcfit, "batch": batch,
            "chain": chain, "event_optimize": eo, "composite": comp,
            "fermiphase": fermi, "toa_io": tio, "k1_launches": k1,
            "seconds": secs}


# ------------------------------------------------------ the dispatch runtime


def supervisor_clean(label: str) -> dict:
    """(g) The global supervisor's counters after a phase that injects no
    fault: any failover, timeout, breaker rejection or lost device is a
    hidden fallback, and fails the smoke."""
    from pint_tpu_torch.runtime import get_supervisor

    snap = get_supervisor().snapshot()
    keys = ("dispatches", "guarded", "failovers", "timeouts",
            "breaker_rejections", "device_lost", "retries")
    out = {k: snap[k] for k in keys}
    print(f"supervisor after {label}: {out}")
    bad = {k: out[k] for k in ("failovers", "timeouts", "breaker_rejections",
                               "device_lost") if out[k]}
    if bad:
        fail(f"{label}: a phase without injected faults fell back: {bad}")
    return out


@contextlib.contextmanager
def short_deadline(match: str, seconds: float):
    """Dispatches whose key holds `match` get a `seconds` deadline (the
    injected wedge's); every other dispatch a 600 s one (a plan makes CPU
    dispatches guarded, and a real CPU pass must not time out)."""
    from pint_tpu_torch.runtime.supervisor import DispatchSupervisor

    real = DispatchSupervisor._deadline_s

    def deadline(self, key, steps, backend, depth=1):
        return seconds * max(1, depth) if match in key else 600.0

    DispatchSupervisor._deadline_s = deadline
    try:
        yield
    finally:
        DispatchSupervisor._deadline_s = real


def fit_state(f) -> dict:
    """A fitter's outcome: chi2, the free parameters' values and
    uncertainties, the covariance."""
    m = f.model
    return {"chi2": f.stats.chi2,
            "values": [m.get_param(n).value for n in m.free_params],
            "errors": [m.get_param(n).uncertainty for n in m.free_params],
            "cov": np.asarray(f.parameter_covariance_matrix)}


def same_fit(got: dict, want: dict) -> bool:
    return (got["chi2"] == want["chi2"] and got["values"] == want["values"]
            and got["errors"] == want["errors"]
            and np.array_equal(got["cov"], want["cov"]))


def runtime_hang(par: str, toas, cpu_ref: dict, dev) -> dict:
    """(a) A wedged gls.fit: the device fit fails over to the CPU host fit,
    bitwise the CPU fit, within the deadline, labelled."""
    from pint_tpu_torch.gls import DeviceDownhillGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.runtime import Fault, FaultPlan, get_supervisor, \
        reset_runtime

    reset_runtime()
    fit = DeviceDownhillGLSFitter(toas, get_model(io.StringIO(par),
                                                  device=dev))
    plan = FaultPlan([Fault(match="gls.fit", kind="hang",
                            seconds=RT_HANG_S)])
    t0 = time.perf_counter()
    with short_deadline("gls.fit", RT_DEADLINE_S), plan.active(), \
            warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fit.fit_toas()
    wall = time.perf_counter() - t0
    snap = get_supervisor().snapshot()
    got = fit_state(fit)
    labelled = [str(w.message) for w in rec
                if "fell back to DownhillGLSFitter on cpu" in str(w.message)]
    res = {"wall_s": wall, "hang_s": RT_HANG_S, "deadline_s": RT_DEADLINE_S,
           "bitwise_cpu_fit": same_fit(got, cpu_ref),
           "model_device": str(fit.model.device), "applied": plan.applied,
           **{k: snap[k] for k in ("timeouts", "failovers",
                                   "abandoned_workers")}}
    print(f"runtime-hang: {plan.applied} -> {fit.model.device} in "
          f"{wall:.3f} s (hang {RT_HANG_S} s, deadline {RT_DEADLINE_S} s); "
          f"chi2 {got['chi2']!r} vs the CPU fit's {cpu_ref['chi2']!r}, "
          f"bitwise {res['bitwise_cpu_fit']}; timeouts {snap['timeouts']}, "
          f"failovers {snap['failovers']}, abandoned workers "
          f"{snap['abandoned_workers']}; labelled: {bool(labelled)}")
    if not (res["bitwise_cpu_fit"] and wall < RT_HANG_S and labelled
            and fit.model.device.type == "cpu"
            and min(snap["timeouts"], snap["failovers"],
                    snap["abandoned_workers"]) >= 1):
        fail("runtime-hang: the wedged device fit did not fail over to the "
             "CPU fit")
    return res


def sticky_child(tmp: str) -> int:
    """(b), in a child process: the device fit of the cell in `tmp`, its
    first gls.fit_step dispatch hitting a real device-side assert. Writes
    sticky.json and sticky.npz; exits 0 only when every check holds."""
    import torch

    import pint_tpu_torch.parallel as par_mod
    from pint_tpu_torch.gls import DeviceDownhillGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.runtime import LOST, breaker_for, get_supervisor
    from pint_tpu_torch.toa import load_pickle

    os.environ["PINT_TPU_BREAKER_COOLDOWN_S"] = "0"
    dev = torch.device("cuda", 0)
    with open(os.path.join(tmp, "cell.par")) as f:
        par = f.read()
    toas = load_pickle(os.path.join(tmp, "cell.pickle"), device=dev)
    model = get_model(io.StringIO(par), device=dev)
    real = par_mod.build_fit_loop
    fired = []

    def build_fit_loop(*a, **kw):
        loop_fn, args, names = real(*a, **kw)

        def poisoned(*x, **k):
            if not fired:
                fired.append(1)
                idx = torch.tensor([7], device=dev)
                torch.arange(4, device=dev)[idx].sum().item()
            return loop_fn(*x, **k)

        return poisoned, args, names

    par_mod.build_fit_loop = build_fit_loop
    fit = DeviceDownhillGLSFitter(toas, model)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fit.fit_toas()
    par_mod.build_fit_loop = real
    touched = []
    later = get_supervisor().dispatch(
        lambda: touched.append(1) or torch.ones(1, device=dev).item(),
        key="gls.fit_step", device=dev, fallback=lambda: "host")
    snap = get_supervisor().snapshot()
    state = fit_state(fit)
    out = {"assert_fired": bool(fired),
           "model_device": str(fit.model.device),
           "breaker": breaker_for("cuda:0").snapshot(),
           "later_dispatch": later, "later_touched_card": bool(touched),
           "counters": {k: snap[k] for k in (
               "device_lost", "failovers", "breaker_rejections", "retries",
               "transient_errors", "timeouts")},
           "warnings": [str(w.message)[:200] for w in rec
                        if issubclass(w.category, RuntimeWarning)],
           "chi2": state["chi2"]}
    ok = (out["assert_fired"] and fit.model.device.type == "cpu"
          and out["breaker"]["state"] == LOST and later == "host"
          and not touched and snap["device_lost"] == 1
          and snap["failovers"] >= 2 and snap["breaker_rejections"] >= 1
          and snap["retries"] == 0)
    out["ok"] = ok
    np.savez(os.path.join(tmp, "sticky.npz"), values=state["values"],
             errors=state["errors"], cov=state["cov"])
    with open(os.path.join(tmp, "sticky.json"), "w") as f:
        json.dump(out, f)
    return 0 if ok else 1


def runtime_sticky(par: str, toas, cpu_ref: dict, tmp: str) -> dict:
    """(b) The sticky error, in a child process so this one keeps its CUDA
    context: its CPU result against the CPU fit, bitwise."""
    from pint_tpu_torch.toa import save_pickle

    with open(os.path.join(tmp, "cell.par"), "w") as f:
        f.write(par)
    save_pickle(toas, os.path.join(tmp, "cell.pickle"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--sticky-child", tmp],
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    try:
        with open(os.path.join(tmp, "sticky.json")) as f:
            out = json.load(f)
        npz = np.load(os.path.join(tmp, "sticky.npz"))
    except OSError:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        fail(f"runtime-sticky: the child wrote no result (rc "
             f"{proc.returncode})")
    got = {"chi2": out["chi2"], "values": npz["values"].tolist(),
           "errors": npz["errors"].tolist(), "cov": npz["cov"]}
    out.update(child_rc=proc.returncode, child_wall_s=wall,
               bitwise_cpu_fit=same_fit(got, cpu_ref))
    print(f"runtime-sticky: child rc {proc.returncode} in {wall:.3f} s; "
          f"assert fired {out['assert_fired']}, model on "
          f"{out['model_device']}, breaker {out['breaker']}, a later dispatch "
          f"on the card gave {out['later_dispatch']!r} (card touched: "
          f"{out['later_touched_card']}), counters {out['counters']}; chi2 "
          f"{out['chi2']!r}, bitwise the CPU fit {out['bitwise_cpu_fit']}")
    if proc.returncode != 0 or not (out["ok"] and out["bitwise_cpu_fit"]):
        print(proc.stderr[-3000:])
        fail("runtime-sticky: the lost context did not end in the CPU fit "
             "with the breaker latched")
    return out


def runtime_breaker(par: str, toas, dev, tmp: str) -> dict:
    """(c) Injected transient errors at gls.solve: retried and recovered;
    then past breaker_threshold: tripped, a flight dump, the solve by the
    CPU mirror, later dispatches short-circuited, Fitter.auto on the
    host."""
    from pint_tpu_torch import config, obs
    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.gls import GLSFitter, _gls_host_failover_solve
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.runtime import OPEN, Fault, FaultPlan, breaker_for, \
        get_supervisor, reset_runtime

    reset_runtime()
    fdir = os.path.join(tmp, "flight")
    obs.configure(flight_dir=fdir)
    sup = get_supervisor()
    gf = GLSFitter(toas, get_model(io.StringIO(par), device=dev))
    want = gf._solve_once()
    plan = FaultPlan([Fault(match="gls.solve", kind="error", count=2)])
    with plan.active():
        got = gf._solve_once()
    retried = {k: sup.snapshot()[k] for k in ("retries", "transient_errors",
                                              "failovers")}
    same = (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and got[2] == want[2])
    plan = FaultPlan([Fault(match="gls.solve", kind="error")])
    with plan.active(), warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tripped = gf._solve_once()
    br = breaker_for("cuda:0")
    state = br.state
    M, r, nvec, F, phi, _, _ = gf._system("cpu")
    x, cov, chi2, _ = _gls_host_failover_solve(
        M.numpy(), F.numpy(), phi.numpy(), r.numpy(), nvec.numpy())
    mirror = (np.array_equal(tripped[0], -x) and
              np.array_equal(tripped[1], cov) and tripped[2] == chi2)
    dumps = sorted(os.listdir(fdir)) if os.path.isdir(fdir) else []
    touched = []
    short = sup.dispatch(lambda: touched.append(1), key="gls.solve",
                         device=dev, fallback=lambda: "host")
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        auto = Fitter.auto(toas, get_model(io.StringIO(par), device=dev))
    snap = sup.snapshot()
    res = {"recovered": retried, "recovered_bitwise": same,
           "threshold": config.breaker_threshold(), "state": state,
           "trips": br.trips, "flight_dumps": dumps,
           "mirror_bitwise": mirror, "short_circuit": short,
           "card_touched": bool(touched),
           "auto": [type(auto).__name__, str(auto.device)],
           "rejections": snap["breaker_rejections"],
           "failovers": snap["failovers"],
           "rehome_warned": any("moves to the CPU" in str(w.message)
                                for w in list(rec) + list(rec2))}
    print(f"runtime-breaker: 2 injected errors retried {retried}, bitwise "
          f"the unfaulted solve {same}; then every attempt failing: breaker "
          f"{state} after {config.breaker_threshold()} failures, flight "
          f"dumps {dumps}, the solve by the CPU mirror bitwise {mirror}; a "
          f"later dispatch gave {short!r} (card touched {bool(touched)}); "
          f"Fitter.auto gave {res['auto']}; rejections "
          f"{snap['breaker_rejections']}, failovers {snap['failovers']}")
    if not (same and retried["retries"] == 2 and retried["failovers"] == 0
            and state == OPEN and mirror and short == "host" and not touched
            and any("breaker_open" in d for d in dumps)
            and res["auto"] == ["DownhillGLSFitter", "cpu"]
            and res["rehome_warned"]):
        fail("runtime-breaker: retry, trip, dump or short-circuit failed")
    obs.reset()
    reset_runtime()
    return res


def runtime_nan(par: str, toas, gpu_ref: dict, dev) -> dict:
    """(d) NaN readback from gls.fit: the fit fails over to the host
    fitter on the card, bitwise fit-downhill's GPU fit."""
    from pint_tpu_torch.gls import DeviceDownhillGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.runtime import Fault, FaultPlan, get_supervisor, \
        reset_runtime

    reset_runtime()
    fit = DeviceDownhillGLSFitter(toas, get_model(io.StringIO(par),
                                                  device=dev))
    plan = FaultPlan([Fault(match="gls.fit", kind="nan")])
    with plan.active(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit.fit_toas()
    snap = get_supervisor().snapshot()
    got = fit_state(fit)
    res = {"bitwise_gpu_fit": same_fit(got, gpu_ref),
           "model_device": str(fit.model.device), "applied": plan.applied,
           "failovers": snap["failovers"]}
    print(f"runtime-nan: {plan.applied[:1]} -> host fitter on "
          f"{fit.model.device}, chi2 {got['chi2']!r}, bitwise the GPU "
          f"DownhillGLSFitter {res['bitwise_gpu_fit']}, failovers "
          f"{snap['failovers']}")
    if not (res["bitwise_gpu_fit"] and snap["failovers"] == 1
            and fit.model.device.type == "cuda"):
        fail("runtime-nan: the NaN step did not fail over to the host fit")
    reset_runtime()
    return res


def runtime_gwb(problems, positions, nfreq: int, dev) -> dict:
    """(e) Config 5's sweep losing the device after its first chunk: every
    chunk completes, by the numpy mirror from the chunk boundary, within
    GWB_RTOL of the CPU sweep, labelled."""
    from pint_tpu_torch.pta import GWBLikelihood
    from pint_tpu_torch.runtime import Fault, FaultPlan, get_supervisor, \
        reset_runtime

    reset_runtime()
    K = 8
    la = np.linspace(-15.0, -13.5, 3 * K)
    ga = np.full(3 * K, 13.0 / 3.0)
    t0 = time.perf_counter()
    cpu_vals = GWBLikelihood(problems=problems, positions=positions,
                             nfreq=nfreq, device="cpu").loglik_grid(
        la, ga, chunk=K)
    cpu_s = time.perf_counter() - t0
    like = GWBLikelihood(problems=problems, positions=positions, nfreq=nfreq,
                         device=dev)
    info = {}
    plan = FaultPlan([Fault(match="pta.gwb/", kind="hang", after=1,
                            seconds=RT_HANG_S)])
    t0 = time.perf_counter()
    with short_deadline("pta.gwb/", RT_DEADLINE_S), plan.active():
        vals = like.loglik_grid(la, ga, chunk=K, info=info)
    wall = time.perf_counter() - t0
    snap = get_supervisor().snapshot()
    worst = float(np.max(np.abs(vals - cpu_vals) / np.abs(cpu_vals)))
    res = {"points": len(la), "chunk": K, "applied": plan.applied,
           "used_pool": info.get("used_pool"), "wall_s": wall,
           "cpu_sweep_s": cpu_s, "vs_cpu_rel": worst,
           **{k: snap[k] for k in ("timeouts", "failovers")}}
    print(f"runtime-gwb: {len(la)} points in chunks of {K} on {dev}, "
          f"{plan.applied} -> used_pool {info.get('used_pool')}, "
          f"{wall:.3f} s; against the CPU sweep ({cpu_s:.3f} s) "
          f"{worst:.3e} relative (limit {GWB_RTOL}); timeouts "
          f"{snap['timeouts']}, failovers {snap['failovers']}")
    if not (info.get("used_pool") == "host-failover" and worst <= GWB_RTOL
            and np.all(np.isfinite(vals)) and snap["failovers"] >= 1
            and wall < RT_HANG_S):
        fail("runtime-gwb: the sweep did not finish on the host")
    reset_runtime()
    return res


def runtime_chain(dev) -> dict:
    """(e) The moments pulsar's chain on the card failing from chunk 2 on:
    each failed chunk re-runs on the CPU posterior from the carried state;
    the positions equal an all-CPU chain's bitwise."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.runtime import Fault, FaultPlan, get_supervisor, \
        reset_runtime
    from pint_tpu_torch.sampling import DeviceEnsembleSampler, \
        DevicePosterior
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    reset_runtime()
    toas = make_fake_toas_uniform(
        54000, 56000, 60, get_model(io.StringIO(MOMENT_PAR), device="cpu"),
        error_us=1.0, freq_mhz=1400.0, add_noise=True,
        rng=np.random.default_rng(11), device="cpu")
    posts = {tag: DevicePosterior(get_model(io.StringIO(MOMENT_PAR),
                                            device=d), toas)
             for tag, d in (("gpu", dev), ("cpu", "cpu"))}
    p0 = posts["cpu"].init_walkers(POST_WALKERS,
                                   rng=np.random.default_rng(12))
    os.environ["PINT_TPU_CHAIN_CHUNK"] = str(RT_CHAIN_CHUNK)
    try:
        t0 = time.perf_counter()
        cpu = DeviceEnsembleSampler(POST_WALKERS, posts["cpu"].nparams,
                                    posts["cpu"].lnpost_batch, device="cpu")
        cpu.run_mcmc(p0, RT_CHAIN_STEPS, seed=13)
        cpu_s = time.perf_counter() - t0
        s = DeviceEnsembleSampler(POST_WALKERS, posts["gpu"].nparams,
                                  posts["gpu"].lnpost_batch, device=dev,
                                  host_lnpost_batch=posts["cpu"].lnpost_batch)
        plan = FaultPlan([Fault(match="sampling.chain", kind="error",
                                after=2)])
        t0 = time.perf_counter()
        with plan.active():
            s.run_mcmc(p0, RT_CHAIN_STEPS, seed=13)
        wall = time.perf_counter() - t0
    finally:
        del os.environ["PINT_TPU_CHAIN_CHUNK"]
    snap = get_supervisor().snapshot()
    same = bool(np.array_equal(s.chain, cpu.chain))
    lnp_rel = float(np.max(np.abs(s.lnprob - cpu.lnprob)
                           / np.maximum(np.abs(cpu.lnprob), 1e-300)))
    nchunks = -(-RT_CHAIN_STEPS // RT_CHAIN_CHUNK)
    res = {"walkers": POST_WALKERS, "steps": RT_CHAIN_STEPS,
           "chunk": RT_CHAIN_CHUNK, "chunks": s.dispatches,
           "failovers": snap["failovers"],
           "positions_bitwise_cpu_chain": same, "lnprob_max_rel": lnp_rel,
           "acceptance": [s.acceptance_fraction, cpu.acceptance_fraction],
           "wall_s": wall, "cpu_chain_s": cpu_s}
    print(f"runtime-chain: {POST_WALKERS} x {RT_CHAIN_STEPS} in {nchunks} "
          f"chunks of {RT_CHAIN_CHUNK}, chunks 2.. failed "
          f"({snap['failovers']} failovers) in {wall:.3f} s; positions "
          f"bitwise the all-CPU chain's ({cpu_s:.3f} s) {same}, lnprob "
          f"within {lnp_rel:.3e} "
          f"(chunks 0-1 scored on the card), acceptance "
          f"{s.acceptance_fraction:.4f} / {cpu.acceptance_fraction:.4f}")
    if not (same and s.dispatches == nchunks
            and snap["failovers"] == nchunks - 2):
        fail("runtime-chain: the failed-over chain is not the CPU chain")
    reset_runtime()
    return res


def supervision_cost(fn, key: str, dev, label: str, reps: int = 6) -> dict:
    """(f) `fn` dispatched under `key` on the card, supervised (the guarded
    worker and its host read) and with guard=False (inline, its outputs
    left on the card): host-clock ms of `reps` calls of each, in turns
    (supervised, unguarded, unguarded, supervised, ...), each ending in a
    synchronize, before any profiler runs; then two profiled calls of
    each, in turns: the kernel launches on the host and the kernels on
    the device (the profiler sees both whichever thread launched them;
    the larger count of the two windows, as a window may drop events),
    device busy time and idle share, and the fit_step.* spans recorded
    (record_function ranges stay with the thread that opened them). The
    launch counts must be equal."""
    from pint_tpu_torch.runtime import get_supervisor

    sup = get_supervisor()
    calls = {tag: (lambda guard=guard: sup.dispatch(fn, key=key, device=dev,
                                                    guard=guard))
             for tag, guard in (("supervised", None), ("unguarded", False))}
    times = {tag: [] for tag in calls}
    for call in calls.values():
        call()
    order = ["supervised", "unguarded"]
    for r in range(reps):
        for tag in (order if r % 2 == 0 else order[::-1]):
            sync(dev)
            t0 = time.perf_counter()
            calls[tag]()
            sync(dev)
            times[tag].append((time.perf_counter() - t0) * 1e3)
    out = {tag: {"median_ms": float(np.median(ts)),
                 "min_max_ms": [min(ts), max(ts)], "launches": 0,
                 "kernels": 0, "fit_step_spans": []}
           for tag, ts in times.items()}
    for tag in order + order[::-1]:
        _, wall_ms, spans, work, launches = profile_window(calls[tag], 1)
        kernels = sum(1 for *_, n in work
                      if not n.startswith(("Memcpy", "Memset")))
        o = out[tag]
        if kernels >= o["kernels"]:
            busy = busy_us(work) / 1e3
            o.update(kernels=kernels, busy_ms=busy, profiled_ms=wall_ms,
                     idle_share=1 - busy / wall_ms if work else None)
        o["launches"] = max(o["launches"], launches)
        o["fit_step_spans"] = sorted(set(o["fit_step_spans"]) | {
            n for n in spans if n.startswith("fit_step.")})
    s, u = out["supervised"], out["unguarded"]
    out["overhead_ms"] = s["median_ms"] - u["median_ms"]
    print(f"runtime-cost, {label}: supervised {s['median_ms']:.3f} ms "
          f"(min {s['min_max_ms'][0]:.3f}), guard=False "
          f"{u['median_ms']:.3f} ms (min {u['min_max_ms'][0]:.3f}), {reps} "
          f"each in turns: {out['overhead_ms']:+.3f} ms; launches "
          f"{s['launches']} / {u['launches']}, device kernels "
          f"{s['kernels']} / {u['kernels']}; idle share {s['idle_share']} / "
          f"{u['idle_share']}; fit_step spans seen supervised "
          f"{len(s['fit_step_spans'])}, unguarded {len(u['fit_step_spans'])}"
          + (" (a guarded call's spans stay on its worker thread: the "
             "fit-time windows profile the step called directly)"
             if u["fit_step_spans"] and not s["fit_step_spans"] else ""))
    if s["launches"] != u["launches"] or not s["launches"]:
        fail(f"runtime-cost, {label}: the supervised call launches other "
             "kernels")
    return out


def carry_cost(dev) -> dict:
    """The host carry between chunks, alone: the state read back and
    placed again (median of 20, ms), for the streaming accumulator of the
    stream cell (p = 37, q = 30: Sigma (p+q)^2 and eight vectors) and for
    the Bayesian chain's (pos, lp) (88 walkers x 43 dimensions)."""
    import torch

    from pint_tpu_torch.parallel.streaming import _init_state

    states = {"stream_state": _init_state(37, 30, dev),
              "chain_state": (torch.zeros((88, 43), dtype=torch.float64,
                                          device=dev),
                              torch.zeros(88, dtype=torch.float64,
                                          device=dev))}
    out = {}
    for name, st in states.items():
        times = []
        for _ in range(21):
            sync(dev)
            t0 = time.perf_counter()
            host = [x.cpu() for x in st]
            st = tuple(x.to(dev) for x in host)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"bytes": sum(x.numel() * 8 for x in st),
                     "ms": float(np.median(times[1:]))}
    print(f"runtime-carry: {out}")
    return out


def runtime_deadlines() -> dict:
    """Each dispatch key's largest wall on the card against its steady
    deadline (and its first call's wall against the first-call deadline);
    the measured CUDA round trip."""
    from pint_tpu_torch import config
    from pint_tpu_torch.runtime import get_supervisor

    sup = get_supervisor()
    rtt = config.dispatch_rtt_ms("cuda:0")
    lat = sup.snapshot().get("latency", {})
    rows = {}
    for row, metrics in sorted(lat.items()):
        backend, key = row.split("/", 1)
        if not backend.startswith("cuda"):
            continue
        # the chunk keys of one sweep or chain are one row: "<tag>/chunk<c>"
        name = key.split("/chunk")[0] + ("/chunk*" if "/chunk" in key
                                         else "")
        wall_ms = metrics["dispatch_wall"]["max_ms"]
        dl_ms = sup._deadline_s(key, 1, backend) * 1e3
        r = rows.setdefault(name, {"count": 0, "max_wall_ms": 0.0,
                                   "deadline_ms": dl_ms})
        r["count"] += metrics["dispatch_wall"]["count"]
        r["max_wall_ms"] = max(r["max_wall_ms"], wall_ms)
        r["deadline_ms"] = min(r["deadline_ms"], dl_ms)
        r["headroom"] = r["deadline_ms"] / max(r["max_wall_ms"], 1e-9)
    worst = min(rows.items(), key=lambda kv: kv[1]["headroom"]) \
        if rows else (None, {"headroom": math.inf})
    print(f"runtime-deadlines: CUDA round trip {rtt * 1e3:.1f} us (drift "
          f"floor 5 ms); {len(rows)} dispatch sites on the card; least "
          f"headroom "
          f"{worst[1]['headroom']:.1f}x at {worst[0]}")
    for key, r in rows.items():
        print(f"  {key}: {r['count']} calls, largest wall "
              f"{r['max_wall_ms']:.3f} ms, deadline {r['deadline_ms']:.0f} "
              f"ms, headroom {r['headroom']:.1f}x")
    if worst[1]["headroom"] < RT_HEADROOM:
        fail(f"runtime-deadlines: {worst[0]} ran within {RT_HEADROOM}x of "
             "its deadline")
    return {"rtt_ms": rtt, "keys": rows}


def runtime_crossover(fit_par: str, fit_toas) -> dict:
    """WLS and GLS solves (one supervised linearized pass each) on the card
    and on the CPU, each device's model from the same par text and the
    same TOAs: NGC6440E's 62 TOAs, the fit cell's recipe at 1,000 TOAs
    (2 DMX) and the fit cell itself; median of 3 after a warm-up."""
    import torch

    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.gls import GLSFitter
    from pint_tpu_torch.models import get_model, get_model_and_toas

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, ngc_toas = get_model_and_toas(NGC[0], NGC[1], device="cpu")
    with open(NGC[0]) as f:
        ngc_par = f.read()
    mid_par, _, mid_toas = fit_build(RT_CROSSOVER_NTOA[0], 2, 1, "cpu")
    out = {}
    for par, toas in ((ngc_par, ngc_toas), (mid_par, mid_toas),
                      (fit_par, fit_toas)):
        row = {}
        for tag, d in (("gpu", torch.device("cuda")), ("cpu", "cpu")):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m = get_model(io.StringIO(par), device=d)
            for name, fn in (("wls", lambda: WLSFitter(toas, m)._solve(None)),
                             ("gls", lambda: GLSFitter(toas, m)._solve_once())):
                fn()
                times = []
                for _ in range(3):
                    sync(d)
                    t0 = time.perf_counter()
                    fn()
                    sync(d)
                    times.append((time.perf_counter() - t0) * 1e3)
                row[f"{name}_{tag}_ms"] = float(np.median(times))
        out[str(toas.ntoas)] = row
        print(f"runtime-crossover, {toas.ntoas} TOAs: WLS card "
              f"{row['wls_gpu_ms']:.2f} ms, CPU {row['wls_cpu_ms']:.2f} ms; "
              f"GLS card {row['gls_gpu_ms']:.2f} ms, CPU "
              f"{row['gls_cpu_ms']:.2f} ms")
    return out


def downhill_log(f) -> list:
    """Wrap fitter `f` so each downhill decision lands in the returned
    list: ("solve", proposed step) and ("trial", chi2)."""
    log = []
    solve, chi2_here = f._solve_once, f._chi2_here

    def logged_solve(*a, **kw):
        out = solve(*a, **kw)
        log.append(("solve", np.array(out[0])))
        return out

    def logged_chi2():
        c = chi2_here()
        log.append(("trial", c))
        return c

    f._solve_once, f._chi2_here = logged_solve, logged_chi2
    return log


def decisions(log: list) -> list:
    """[(step, [trial chi2], accepted halving or None)] of a downhill log:
    the first trial is the entry chi2; each iteration's solve is followed
    by its trials, the first within 1e-12 of the best accepted."""
    best = log[0][1]
    out, cur = [], None
    for kind, v in log[1:]:
        if kind == "solve":
            cur = [v, [], None]
            out.append(cur)
        elif cur is not None:
            cur[1].append(v)
            if cur[2] is None and v <= best + 1e-12:
                cur[2] = len(cur[1]) - 1
                best = v
    return out


def config3_decisions(w_model, w_toas, dev, tmp: str) -> dict:
    """ROADMAP §3's suspicion: config 3 written by TOAs.write_TOA_file (16
    digits), Fitter.auto's WidebandDownhillFitter on the card and on the
    CPU with every decision logged; the first decision that differs and
    the largest difference of one step in sigma. The first step (both
    devices at the same start) is taken apart: the stacked systems
    (design, residuals) of both devices solved on the CPU, so its
    difference splits into the solve's arithmetic on identical inputs,
    what the residuals' differences move and what the design's move."""
    import torch

    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.gls import _gls_kernel
    from pint_tpu_torch.models import get_model_and_toas

    par = os.path.join(tmp, "config3_16.par")
    tim = os.path.join(tmp, "config3_16.tim")
    with open(par, "w") as f:
        f.write(w_model.as_parfile())
    w_toas.write_TOA_file(tim)
    runs, start = {}, {}
    for tag, d in (("gpu", dev), ("cpu", "cpu")):
        m, t = get_model_and_toas(par, tim, device=d)
        f = Fitter.auto(t, m)
        M, r, nvec, F, phi, _, _ = f._system(d)
        start[tag] = [x.cpu() for x in (M, r, nvec, F, phi)]
        log = downhill_log(f)
        chi2 = f.fit_toas()
        runs[tag] = (f, chi2, decisions(log))
    (fg, cg, dg), (fc, cc, dc) = runs["gpu"], runs["cpu"]

    def step(M, r, nvec, F, phi):
        out = _gls_kernel(M, F, phi, r, nvec)
        return -out[0].numpy(), out[1].numpy()

    Mg, rg, nvg, Fg, phig = start["gpu"]
    Mc, rc, nvc, Fc, phic = start["cpu"]
    x_c, cov_c = step(Mc, rc, nvc, Fc, phic)
    x_gc, _ = step(Mg, rg, nvg, Fg, phig)     # the card's inputs, CPU solve
    x_mix, _ = step(Mc, rg, nvc, Fc, phic)    # CPU design, card residuals
    s0 = np.sqrt(np.abs(np.diag(cov_c)))

    def in_sigma(a, b):
        return float(np.max(np.abs(a - b) / s0))

    err_s = torch.sqrt(nvc)
    first_step = {
        "card_vs_cpu": in_sigma(dg[0][0], x_c),
        "solve_arithmetic": in_sigma(dg[0][0], x_gc),
        "moved_by_residuals": in_sigma(x_mix, x_c),
        "moved_by_design": in_sigma(x_gc, x_mix),
        "resid_max_abs": float(torch.max(torch.abs(rg - rc))),
        "resid_max_sigma": float(torch.max(torch.abs(rg - rc) / err_s)),
        "design_max_rel": float(torch.max(torch.abs(Mg - Mc))
                                / torch.max(torch.abs(Mc)))}
    names = fc.model.free_params
    sig = np.array([fc.errors[n] for n in names])
    steps, first = [], None
    for k in range(max(len(dg), len(dc))):
        if k >= len(dg) or k >= len(dc):
            first = first or {"iteration": k, "what": "iteration count",
                              "gpu": len(dg), "cpu": len(dc)}
            break
        xg, xc = dg[k][0], dc[k][0]
        noff = len(xg) - len(names)
        steps.append(float(np.max(np.abs(xg[noff:] - xc[noff:]) / sig)))
        if first is None and (dg[k][2] != dc[k][2]
                              or len(dg[k][1]) != len(dc[k][1])):
            first = {"iteration": k, "what": "accepted halving",
                     "gpu": dg[k][2], "cpu": dc[k][2],
                     "gpu_trials": dg[k][1], "cpu_trials": dc[k][1]}
    dev_sigma = max(abs(fg.model.get_param(n).value
                        - fc.model.get_param(n).value) / fc.errors[n]
                    for n in names)
    worst_step = max(steps) if steps else 0.0
    res = {"iterations": [len(dg), len(dc)], "chi2": [cg, cc],
           "fit_sigma": dev_sigma, "step_sigma": steps,
           "worst_step_sigma": worst_step, "first_difference": first,
           "halvings": [[x[2] for x in dg], [x[2] for x in dc]],
           "first_step": first_step}
    print(f"config3-16-digit: card {len(dg)} iterations, CPU {len(dc)}; "
          f"accepted halvings {res['halvings'][0]} / {res['halvings'][1]}; "
          f"each step card vs CPU {['%.2e' % s for s in steps]} sigma "
          f"(limit {STEP_SIGMA_LIMIT}); first decision that differs: "
          f"{first}; the fits part by {dev_sigma:.3e} sigma; the first step "
          f"(same start) taken apart: {first_step}")
    return res


def runtime_phase(par: str, toas, downhill: dict, step: dict, array: dict,
                  nfreq: int, costs: dict, dev) -> dict:
    """Phase 14's (a)-(f) and the deadline and crossover records."""
    secs = {}
    deadlines = runtime_deadlines()
    cpu_ref = fit_state(downhill["cpu_fitter"])
    gpu_ref = fit_state(downhill["fitter"])

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[name] = time.perf_counter() - t0
        return out

    costs["fit_step"] = timed("cost", supervision_cost,
                              lambda: step["step"](*step["args"]),
                              "gls.fit_step", dev, "fit step")
    with tempfile.TemporaryDirectory() as tmp:
        hang = timed("hang", runtime_hang, par, toas, cpu_ref, dev)
        sticky = timed("sticky", runtime_sticky, par, toas, cpu_ref, tmp)
        brk = timed("breaker", runtime_breaker, par, toas, dev, tmp)
    nan = timed("nan", runtime_nan, par, toas, gpu_ref, dev)
    gwb = timed("gwb", runtime_gwb, array["problems"], array["positions"],
                nfreq, dev)
    chain = timed("chain", runtime_chain, dev)
    carry = carry_cost(dev)
    cross = timed("crossover", runtime_crossover, par, toas)
    print("runtime seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in secs.items()))
    return {"hang": hang, "sticky": sticky, "breaker": brk, "nan": nan,
            "gwb": gwb, "chain": chain, "cost": costs,
            "deadlines": deadlines, "crossover": cross, "carry": carry,
            "seconds": secs}


# ------------------------------------------------- host API and polycos


# TEMPO's and PINT's polyco defaults: 60-minute blocks, 12 coefficients,
# 1400 MHz; one day of them at gbt
POLYCO_SEG_MIN, POLYCO_NCOEFF, POLYCO_FREQ = 60.0, 12, 1400.0
POLYCO_DAYS, POLYCO_NEPOCH = 1.0, 200
POLYCO_TURNS = 1e-6            # tests/test_polycos.py's folding limit
POLYCO_FILE_TURNS = 5e-6       # the TEMPO file's 6 decimals of RPHASE
SPIN_RTOL = 1e-9               # eval_spin_freq vs d_phase_d_toa
DPDT_RTOL = 1e-12              # d_phase_d_toa, card vs CPU
DPDP_REL = 1e-13               # d_phase_d_param vs F0 x the design column
ROUND_TRIP_S = 2e-9            # as_ECL -> as_ICRS (tests/test_cli_utils.py)
RANDOM_MODELS, RANDOM_MODELS_S = 100, 1e-12
# binaryconvert: tests/test_binary_zoo.py's 2e-9 s is at x e^2 = 8.82e-11
# lt-s, and the ELL1 expansion's error scales as x e^2
CONVERT_EXACT_S, CONVERT_XE2_RATIO = 1e-12, 2e-9 / 8.82e-11
CONVERT_TARGETS = ("ELL1H", "DD", "DDS", "DDH")


def coeff_turns(a, b) -> float:
    """The largest difference of two polyco sets' coefficients, each as
    the turns its term moves at the block's edge (|dc_k| (span/2)^k);
    their segments, integer phases and frequencies must be equal."""
    out = 0.0
    for ea, eb in zip(a.entries, b.entries):
        if (ea.rphase_int, ea.tmid, ea.f0) != (eb.rphase_int, eb.tmid, eb.f0):
            fail("polycos: the card's and the CPU's blocks differ in "
                 "segment, integer phase or frequency")
        scale = (ea.span_min / 2.0) ** np.arange(len(ea.coeffs))
        out = max(out, float(np.max(np.abs(ea.coeffs - eb.coeffs) * scale)))
    return out


def turns_mod1(a, b) -> np.ndarray:
    d = (a[0] + a[1]) - (b[0] + b[1])
    return np.abs(d - np.round(d))


def polycos_check(label: str, par: str, seed: int, dev, tmp: str) -> dict:
    """One day of polycos at gbt (TEMPO's defaults) from `par` on the
    card: the polyco phase at POLYCO_NEPOCH seeded epochs against
    model.phase on the card (POLYCO_TURNS mod 1), eval_spin_freq against
    d_phase_d_toa on the card (SPIN_RTOL), the coefficients against the
    same generation on the CPU (POLYCO_TURNS at the block edge) and the
    TEMPO file read back (POLYCO_FILE_TURNS)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.polycos import Polycos
    from pint_tpu_torch.toa import get_TOAs_array

    secs = {}
    t00 = time.perf_counter()
    mg = get_model(io.StringIO(par), device=dev)
    mjd0 = float(np.round(mg.PEPOCH.value))
    span = (mjd0, mjd0 + POLYCO_DAYS)
    kw = dict(seg_length_min=POLYCO_SEG_MIN, ncoeff=POLYCO_NCOEFF,
              obsfreq_mhz=POLYCO_FREQ)

    def generate(m, d):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Polycos.generate_polycos(m, *span, "gbt", device=d, **kw)

    generate(mg, dev)  # warm: the first call pays the ephemeris reads
    t0 = time.perf_counter()
    pc = generate(mg, dev)
    sync(dev)
    gen_s = time.perf_counter() - t0
    prof = device_busy(lambda: generate(mg, dev),
                       f"{label}: one generation ({len(pc.entries)} "
                       f"blocks)")
    nseg = int(np.ceil(POLYCO_DAYS * 1440.0 / POLYCO_SEG_MIN))
    if len(pc.entries) != nseg:
        fail(f"{label}: {len(pc.entries)} blocks, not {nseg}")
    rng = np.random.default_rng(seed)
    mjds = np.sort(rng.uniform(*span, POLYCO_NEPOCH))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ev = get_TOAs_array(mjds, obs="gbt", freqs=POLYCO_FREQ, errors=1.0,
                            device=dev)
    ph = mg.phase(ev, abs_phase=True, device=dev)
    full = (ph.int.cpu().numpy(), ph.frac.cpu().numpy())
    err = float(np.max(turns_mod1(pc.eval_abs_phase(mjds), full)))
    t0 = time.perf_counter()
    f_full = mg.d_phase_d_toa(ev, device=dev)
    dpdt_s = time.perf_counter() - t0
    spin = float(np.max(np.abs(pc.eval_spin_freq(mjds) / f_full - 1.0)))
    secs["generate_and_fold"] = time.perf_counter() - t00
    t0 = time.perf_counter()
    pc_cpu = generate(get_model(io.StringIO(par), device="cpu"), "cpu")
    cpu_s = time.perf_counter() - t0
    coeff = coeff_turns(pc, pc_cpu)
    cpu_turns = float(np.max(turns_mod1(pc.eval_abs_phase(mjds),
                                        pc_cpu.eval_abs_phase(mjds))))
    path = os.path.join(tmp, f"{label}.polyco.dat")
    pc.write_polyco_file(path)
    back = Polycos.read_polyco_file(path)
    file_turns = float(np.max(turns_mod1(back.eval_abs_phase(mjds),
                                         pc.eval_abs_phase(mjds))))
    secs["cpu_and_file"] = time.perf_counter() - t0
    doppler = float(np.ptp(f_full) / mg.F0.value)
    print(f"{label}: {len(pc.entries)} blocks of {POLYCO_SEG_MIN:g} min, "
          f"{POLYCO_NCOEFF} coefficients ({len(pc.entries) * 24} nodes in "
          f"one phase call on {dev}) in {gen_s:.3f} s (CPU {cpu_s:.3f} s); "
          f"polyco vs model.phase at {POLYCO_NEPOCH} epochs {err:.3e} turns "
          f"(limit {POLYCO_TURNS}); spin frequency vs d_phase_d_toa "
          f"{spin:.3e} relative (limit {SPIN_RTOL}; Doppler span "
          f"{doppler:.3e} of F0); coefficients vs the CPU's {coeff:.3e} "
          f"turns at the block edge, phases {cpu_turns:.3e} turns (limit "
          f"{POLYCO_TURNS}); TEMPO file read back {file_turns:.3e} turns "
          f"(limit {POLYCO_FILE_TURNS})")
    if not (err < POLYCO_TURNS and spin <= SPIN_RTOL
            and coeff <= POLYCO_TURNS and cpu_turns <= POLYCO_TURNS
            and file_turns < POLYCO_FILE_TURNS
            and len(back.entries) == len(pc.entries)):
        fail(f"{label}: the polycos do not reproduce the card's phase")
    return {"blocks": len(pc.entries), "nodes": len(pc.entries) * 24,
            "generate_s": gen_s, "cpu_generate_s": cpu_s,
            "d_phase_d_toa_s": dpdt_s, "generation_profile": prof,
            "max_turns": err, "spin_rel": spin, "coeff_turns_vs_cpu": coeff,
            "turns_vs_cpu": cpu_turns, "file_turns": file_turns,
            "doppler_span": doppler, "seconds": secs}


def host_api_fit_cell(par: str, toas, seed: int, dev) -> dict:
    """The host API on the fit cell (bench.build_problem()'s 10,000 TOAs
    and 40 free parameters): d_phase_d_toa card vs CPU (DPDT_RTOL), timed
    and profiled; d_phase_d_param for F0, F1 and a DMX against the card's
    designmatrix columns (DPDP_REL of the column); every other epoch
    selected, pulse-numbered and fitted by DownhillGLSFitter with
    track_mode="use_pulse_numbers" on the card and on the CPU (the
    fit-downhill limits); ecorr_average over the ECORR epochs card vs CPU;
    as_ECL -> as_ICRS keeping the phase on the card (ROUND_TRIP_S); and
    calculate_random_models after the card's fit, card vs CPU on the same
    fitted state and generator (RANDOM_MODELS_S)."""
    import types

    import torch

    from pint_tpu_torch.fitter import cpu_copy
    from pint_tpu_torch.gls import DownhillGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.simulation import calculate_random_models

    cpu = torch.device("cpu")
    secs, out = {}, {}
    mg = get_model(io.StringIO(par), device=dev)
    mc = get_model(io.StringIO(par), device=cpu)

    t0 = time.perf_counter()
    mg.d_phase_d_toa(toas, device=dev)  # warm
    t1 = time.perf_counter()
    fg = mg.d_phase_d_toa(toas, device=dev)
    sync(dev)
    out["d_phase_d_toa_ms"] = (time.perf_counter() - t1) * 1e3
    out["d_phase_d_toa_profile"] = device_busy(
        lambda: mg.d_phase_d_toa(toas, device=dev),
        "host-api: one d_phase_d_toa at 10,000 TOAs")
    fc = mc.d_phase_d_toa(toas, device=cpu)
    out["d_phase_d_toa_rel"] = float(np.max(np.abs(fg / fc - 1.0)))
    secs["d_phase_d_toa"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    M, names, _ = mg.designmatrix(toas, incoffset=False, device=dev)
    dpdp = 0.0
    for p in ("F0", "F1", "DMX_0001"):
        col = mg.d_phase_d_param(toas, p, device=dev)
        ref = M[:, names.index(p)] * mg.F0.value
        dpdp = max(dpdp, float((col - ref).abs().max() / ref.abs().max()))
    out["d_phase_d_param_rel"] = dpdp
    secs["d_phase_d_param"] = time.perf_counter() - t0
    print(f"host-api: d_phase_d_toa card vs CPU {out['d_phase_d_toa_rel']:.3e}"
          f" relative (limit {DPDT_RTOL}), {out['d_phase_d_toa_ms']:.1f} ms "
          f"a call on the host clock; d_phase_d_param of F0, F1, DMX_0001 vs "
          f"F0 x the card's design columns {dpdp:.3e} of the column "
          f"(limit {DPDP_REL})")
    if not (out["d_phase_d_toa_rel"] <= DPDT_RTOL and dpdp <= DPDP_REL):
        fail("host-api: d_phase_d_toa or d_phase_d_param disagrees")

    # every other four-TOA epoch, pulse-numbered, fitted on both devices
    t0 = time.perf_counter()
    sub = toas.select((np.arange(toas.ntoas) // 4) % 2 == 0)
    sub.compute_pulse_numbers(mg, device=dev)
    if sub.cache_key == toas.cache_key or sub.get_pulse_numbers() is None:
        fail("host-api: select kept the parent's serial or lost the -pn "
             "flags")
    fits = {}
    for tag, d in (("gpu", dev), ("cpu", cpu)):
        m = get_model(io.StringIO(par), device=d)
        f = DownhillGLSFitter(sub, m, track_mode="use_pulse_numbers")
        t1 = time.perf_counter()
        chi2 = f.fit_toas()
        sync(d)
        fits[tag] = (f, chi2, time.perf_counter() - t1)
    (fgpu, cg, tg), (fcpu, cc, tc) = fits["gpu"], fits["cpu"]
    dp = max(abs(fgpu.model.get_param(n).value - fcpu.model.get_param(n)
                 .value) / fcpu.errors[n] for n in fcpu.model.free_params)
    dr = fgpu.resids.time_resids.cpu().numpy() - \
        fcpu.resids.time_resids.numpy()
    tol = chi2_tol(cc, dr, fcpu.model.scaled_toa_uncertainty(sub), CHI2_REL)
    out["select_fit"] = {"ntoa": sub.ntoas, "iterations":
                         fgpu.stats.iterations, "gpu_s": tg, "cpu_s": tc,
                         "dp_sigma": dp, "chi2_rel": abs(cg - cc) / abs(cc),
                         "chi2_rel_limit": tol / abs(cc)}
    secs["select_fit"] = time.perf_counter() - t0
    print(f"host-api: select of every other epoch ({sub.ntoas} TOAs), "
          f"pulse-numbered: DownhillGLSFitter on {fgpu.device} "
          f"{fgpu.stats.iterations} iterations in {tg:.3f} s (CPU "
          f"{fcpu.stats.iterations} in {tc:.3f} s), parameters within "
          f"{dp:.3e} sigma (limit {DP_SIGMA}), chi2 "
          f"{abs(cg - cc) / abs(cc):.3e} relative (limit {tol / abs(cc):.3e})")
    if not (fgpu.converged and fcpu.converged and dp <= DP_SIGMA
            and abs(cg - cc) <= tol
            and fgpu.stats.iterations == fcpu.stats.iterations
            and fgpu.track_mode == "use_pulse_numbers"):
        fail("host-api: the card's fit of the selected TOAs does not reach "
             "the CPU's optimum")

    t0 = time.perf_counter()
    ea_g = Residuals(toas, mg).ecorr_average()
    sync(dev)
    ea_ms = (time.perf_counter() - t0) * 1e3
    ea_c = Residuals(toas, mc).ecorr_average()
    nep = len(ea_g["n"])
    same = list(ea_g["n"]) == list(ea_c["n"]) and all(
        np.array_equal(a, b) for a, b in zip(ea_g["indices"],
                                             ea_c["indices"]))
    ea_r = float((ea_g["time_resids"].cpu() - ea_c["time_resids"]).abs()
                 .max())
    ea_rel = max(float(((ea_g[k].cpu() - ea_c[k]) / ea_c[k]).abs().max())
                 for k in ("mjds", "errors", "freqs"))
    out["ecorr_average"] = {"epochs": nep, "ms": ea_ms, "resid_s": ea_r,
                            "rel": ea_rel}
    secs["ecorr_average"] = time.perf_counter() - t0
    print(f"host-api: ecorr_average over {nep} epochs on {dev} in "
          f"{ea_ms:.1f} ms; vs the CPU: epochs and members equal, residual "
          f"averages {ea_r:.3e} s (limit {RESID_S}), the rest {ea_rel:.3e} "
          f"relative (limit 1e-12)")
    if not (same and nep == toas.ntoas // 4 and ea_r <= RESID_S
            and ea_rel <= 1e-12):
        fail("host-api: ecorr_average on the card disagrees with the CPU")

    t0 = time.perf_counter()
    ecl = mg.as_ECL()
    back = ecl.as_ICRS()
    p0 = mg.phase(toas, device=dev).turns
    worst = 0.0
    for m in (ecl, back):
        p1 = m.phase(toas, device=dev).turns
        worst = max(worst, float(((p1.hi - p0.hi) + (p1.lo - p0.lo))
                                 .abs().max()) / mg.F0.value)
    out["ecl_round_trip_s"] = worst
    secs["ecl_round_trip"] = time.perf_counter() - t0
    print(f"host-api: as_ECL and as_ECL -> as_ICRS keep the card's phase to "
          f"{worst:.3e} s (limit {ROUND_TRIP_S})")
    if not (worst <= ROUND_TRIP_S and "AstrometryEquatorial"
            in back.components and back.device == mg.device):
        fail("host-api: the ecliptic round trip moves the phase")

    t0 = time.perf_counter()
    calculate_random_models(fgpu, sub, Nmodels=8,
                            rng=np.random.default_rng(seed))  # warm
    sync(dev)
    t1 = time.perf_counter()
    rg = calculate_random_models(fgpu, sub, Nmodels=RANDOM_MODELS,
                                 rng=np.random.default_rng(seed))
    sync(dev)
    crm_s = time.perf_counter() - t1
    host = types.SimpleNamespace(
        model=cpu_copy(fgpu.model), device=cpu,
        parameter_covariance_matrix=fgpu.parameter_covariance_matrix)
    rc = calculate_random_models(host, sub, Nmodels=RANDOM_MODELS,
                                 rng=np.random.default_rng(seed))
    # the reference's draws (np.random.multivariate_normal of the raw
    # covariance, ROADMAP.md section 3) can move a residual by millions
    # of turns; (int - pn) + frac then rounds to its own float64 ulp,
    # which the limit allows on top of RANDOM_MODELS_S
    rc_np, dr = rc.numpy(), (rg.cpu() - rc).abs().numpy()
    crm_err = float(dr.max())
    crm_ok = bool(np.all(dr <= RANDOM_MODELS_S + np.spacing(np.abs(rc_np))))
    out["random_models"] = {"n": RANDOM_MODELS, "ntoa": sub.ntoas,
                            "wall_s": crm_s, "max_abs_s": crm_err,
                            "within_limit": crm_ok,
                            "max_resid_s": float(np.abs(rc_np).max()),
                            "spread_s": float(rg.std(dim=0).max())}
    secs["random_models"] = time.perf_counter() - t0
    print(f"host-api: calculate_random_models({RANDOM_MODELS}) at "
          f"{sub.ntoas} TOAs on {rg.device} in {crm_s:.3f} s, "
          f"{tuple(rg.shape)} float64, largest |residual| "
          f"{out['random_models']['max_resid_s']:.3e} s; vs the CPU on the "
          f"same fitted state and generator {crm_err:.3e} s (limit "
          f"{RANDOM_MODELS_S} s plus one ulp of the residual: {crm_ok})")
    if not (rg.shape == (RANDOM_MODELS, sub.ntoas) and rg.device.type
            == torch.device(dev).type and rg.dtype == torch.float64
            and crm_ok):
        fail("host-api: calculate_random_models on the card disagrees")
    out["seconds"] = secs
    return out


def tcb_check(par: str, toas, dev) -> dict:
    """The fit cell's model written as UNITS TCB (convert_tcb_tdb(
    backwards=True), as_parfile) and read back by get_model (converted
    by default): its phase on the card against the original's, within
    what test_tcb_conversion_roundtrip's F0 limit (1e-15 relative)
    allows over the TOAs' span; allow_tcb=False raises ValueError."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.tcb_conversion import convert_tcb_tdb

    t0 = time.perf_counter()
    m = get_model(io.StringIO(par), device=dev)
    text = convert_tcb_tdb(m, backwards=True).as_parfile()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        back = get_model(io.StringIO(text), device=dev)
    p0, p1 = m.phase(toas).turns, back.phase(toas).turns
    turns = float(((p1.hi - p0.hi) + (p1.lo - p0.lo)).abs().max())
    dt = float(np.max(np.abs(toas.get_mjds() - m.PEPOCH.value))) * 86400.0
    limit = 1e-15 * m.F0.value * dt
    warned = any("TCB" in str(x.message) for x in w)
    try:
        get_model(io.StringIO(text), device=dev, allow_tcb=False)
        refused = False
    except ValueError:
        refused = True
    print(f"tcb: the fit cell written as UNITS TCB and read back (converted"
          f", warned: {warned}): phase on {dev} vs the original "
          f"{turns:.3e} turns (limit {limit:.3e}, 1e-15 F0 over "
          f"{dt / 86400:.0f} days); allow_tcb=False refused: {refused}")
    if not (back.UNITS.value == "TDB" and "TCB" in text and warned
            and turns <= limit and refused):
        fail("tcb: the TCB round trip moves the phase or is not refused")
    return {"turns": turns, "limit_turns": limit,
            "seconds": time.perf_counter() - t0}


def binaryconvert_check(par: str, toas, dev) -> dict:
    """Config 2's ELL1 model converted to CONVERT_TARGETS (ROADMAP's
    targets of tests/test_binary_zoo.py): each converted model's delay on
    the card against the CPU's (ZOO_DELAY_S) and, less the means (ELL1
    leaves -3/2 x eps1 to the phase offset), against the ELL1 model's
    on the card: CONVERT_EXACT_S for the exact ELL1H mapping, the test's
    2e-9 s scaled by this orbit's x e^2 for the eccentric models."""
    from pint_tpu_torch.binaryconvert import convert_binary
    from pint_tpu_torch.models import get_model

    t0 = time.perf_counter()
    m = get_model(io.StringIO(par), device=dev)
    x = m.A1.value
    xe2 = x * (m.EPS1.value ** 2 + m.EPS2.value ** 2)
    d0 = m.delay(toas).cpu().numpy()
    out = {}
    for target in CONVERT_TARGETS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cm = convert_binary(m, target)
        dg = cm.delay(toas).cpu().numpy()
        cpu = cm.delay(toas, device="cpu").numpy()
        diff = dg - d0
        vs_src = float(np.max(np.abs(diff - diff.mean())))
        limit = CONVERT_EXACT_S if target == "ELL1H" else \
            CONVERT_XE2_RATIO * xe2
        vs_cpu = float(np.max(np.abs(dg - cpu)))
        out[target] = {"vs_ell1_s": vs_src, "limit_s": limit,
                       "vs_cpu_s": vs_cpu}
        print(f"binaryconvert: ELL1 -> {target}: delay on {dev} vs the "
              f"ELL1 model's {vs_src:.3e} s (limit {limit:.3e}; x e^2 = "
              f"{xe2:.3e} lt-s), vs the CPU {vs_cpu:.3e} s (limit "
              f"{ZOO_DELAY_S})")
        if not (f"Binary{target}" in cm.components and vs_src <= limit
                and vs_cpu <= ZOO_DELAY_S):
            fail(f"binaryconvert: ELL1 -> {target} moves the delays")
    out["seconds"] = time.perf_counter() - t0
    return out


def mjdparse_check(toas, tmp: str) -> dict:
    """The fit cell's .tim written by TOAs.write_TOA_file, its MJD strings
    parsed by the native parser (which must build: native_available) and
    by the Python parser, bitwise equal, both timed."""
    from pint_tpu_torch import native
    from pint_tpu_torch.io.tim import parse_tim
    from pint_tpu_torch.time.mjd import parse_mjd_strings

    t0 = time.perf_counter()
    if not native.native_available():
        fail("mjdparse: the native parser did not build on this machine")
    path = os.path.join(tmp, "fit_cell.tim")
    toas.write_TOA_file(path)
    strs = [t.mjd_str for t in parse_tim(path)]
    t1 = time.perf_counter()
    nat = parse_mjd_strings(strs)
    nat_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    py = parse_mjd_strings(strs, use_native=False)
    py_s = time.perf_counter() - t1
    same = all(np.array_equal(a.view(np.int64), b.view(np.int64))
               for a, b in ((nat[0], py[0]), (nat[1][0], py[1][0]),
                            (nat[1][1], py[1][1])))
    print(f"mjdparse: {len(strs)} MJD strings of write_TOA_file's .tim: "
          f"native {nat_s * 1e3:.2f} ms, Python {py_s * 1e3:.2f} ms "
          f"({py_s / nat_s:.1f}x); bitwise equal: {same}")
    if not (same and len(strs) == toas.ntoas):
        fail("mjdparse: the native parse differs from the Python parse")
    return {"n": len(strs), "native_s": nat_s, "python_s": py_s,
            "seconds": time.perf_counter() - t0}


def host_api_phase(fit_par: str, fit_toas, b_par: str, b_toas, seed: int,
                   dev) -> dict:
    """Phase 15: polycos on config 2 and on the fit cell, the host API on
    the fit cell, the TCB round trip, binaryconvert on config 2 and the
    native MJD parser; one `host_api` JSON line. No hand-written kernel
    runs here (K1 launches 0 times)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pb = polycos_check("polycos-binary", b_par, seed + 11, dev, tmp)
        pf = polycos_check("polycos-fit", fit_par, seed + 12, dev, tmp)
        api = host_api_fit_cell(fit_par, fit_toas, seed + 13, dev)
        tcb = tcb_check(fit_par, fit_toas, dev)
        conv = binaryconvert_check(b_par, b_toas, dev)
        mjd = mjdparse_check(fit_toas, tmp)
    clean = supervisor_clean("the host API")
    seconds = {"polycos_binary": sum(pb["seconds"].values()),
               "polycos_fit": sum(pf["seconds"].values()),
               **{f"host_api.{k}": v for k, v in api["seconds"].items()},
               "tcb": tcb["seconds"], "binaryconvert": conv["seconds"],
               "mjdparse": mjd["seconds"],
               "total": time.perf_counter() - t0}
    return {
        "times": {
            "seconds": seconds,
            "polycos_generate_s": {"binary": pb["generate_s"],
                                   "fit": pf["generate_s"]},
            "polycos_cpu_generate_s": {"binary": pb["cpu_generate_s"],
                                       "fit": pf["cpu_generate_s"]},
            "d_phase_d_toa_ms": api["d_phase_d_toa_ms"],
            "random_models_s": api["random_models"]["wall_s"],
            "select_fit_s": {"gpu": api["select_fit"]["gpu_s"],
                             "cpu": api["select_fit"]["cpu_s"]},
            "ecorr_average_ms": api["ecorr_average"]["ms"]},
        "errors": {
            "polyco_max_turns": max(pb["max_turns"], pf["max_turns"]),
            "polycos": {"binary": {k: pb[k] for k in (
                "max_turns", "spin_rel", "coeff_turns_vs_cpu",
                "turns_vs_cpu", "file_turns", "doppler_span")},
                        "fit": {k: pf[k] for k in (
                "max_turns", "spin_rel", "coeff_turns_vs_cpu",
                "turns_vs_cpu", "file_turns", "doppler_span")}},
            "d_phase_d_toa_rel": api["d_phase_d_toa_rel"],
            "d_phase_d_param_rel": api["d_phase_d_param_rel"],
            "select_fit": api["select_fit"],
            "ecorr_average": api["ecorr_average"],
            "ecl_round_trip_s": api["ecl_round_trip_s"],
            "random_models": api["random_models"],
            "tcb": {k: tcb[k] for k in ("turns", "limit_turns")},
            "binaryconvert": {k: v for k, v in conv.items()
                              if k != "seconds"}},
        "counts": {
            "mjdparse": {k: mjd[k] for k in ("n", "native_s", "python_s")},
            "polycos_generation": {"binary": pb["generation_profile"],
                                   "fit": pf["generation_profile"]},
            "d_phase_d_toa": api["d_phase_d_toa_profile"],
            "polyco_nodes": {"binary": pb["nodes"], "fit": pf["nodes"]},
            "supervisor": clean}}


# ------------------------------------------- phase 16: health and perf

FIT_STEP_LAUNCHES = 1_849      # the disarmed fit-cell step (PERF.md §5)
HEALTH_REL = 1e-12             # health vector vs the host's reductions
HEALTH_PAIRS = 10              # disarmed/armed step pairs, in turns
DRIFT_BAND = 1e-5              # the float64 routes' shadow drift band
PAD_TO = 10_240                # the fit cell's 10,000 TOAs padded
PROFILE_WINDOW_S = 2.0
ROOFLINE_REL = 1e-3            # phase 16's share of bound vs phase 5's
PHASE16_ENV = ("PINT_TPU_HEALTH", "PINT_TPU_SHADOW_RATE", "PINT_TPU_PERF",
               "PINT_TPU_PROFILE_DIR", "PINT_TPU_PROFILE_MAX_S",
               "PINT_TPU_BREAKER_THRESHOLD")


def synced_ms(fn) -> float:
    """Host milliseconds of one call of `fn`, ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def shadows_idle(timeout: float = 300.0) -> None:
    """Wait for every shadow replay thread started so far (a dispatch
    starts its replay's thread before it returns)."""
    import threading

    for t in threading.enumerate():
        if t.name.startswith("pint-shadow"):
            t.join(timeout)


def wait_replays(n: int) -> int:
    """Wait for the replays in flight; the monitor must have finished
    `n` shadow replays by then."""
    from pint_tpu_torch.obs import health

    shadows_idle()
    got = health.get_monitor().status()["shadow_replays"]
    if got < n:
        fail(f"health: {got} shadow replays finished, {n} expected")
    return got


def drift_max(kind: str) -> float:
    """The largest shadow drift [sigma] recorded for `kind` (the drift
    histogram's exact maximum)."""
    from pint_tpu_torch.obs import metrics as om

    h = om.get_registry().get("pint_tpu_health_drift_sigma")
    rows = h.matching({"kind": kind}) if h is not None else []
    if not rows or not any(r.count for r in rows):
        fail(f"health: no shadow drift recorded for {kind}")
    return max(r.max_s for r in rows)


def health_verdict(key: str) -> dict:
    from pint_tpu_torch.obs import health

    w = health.get_monitor().status()["worst"].get(key)
    if w is None:
        fail(f"health: no {key} verdict")
    return {"ok": w["ok"], "reasons": w["reasons"]}


def health_taps(model, toas, dev) -> dict:
    """(a) The fit cell's step armed and disarmed: outputs 0-3 bitwise,
    the health vector the host's reductions of the outputs, the disarmed
    step's launches, the armed step's extra launches and ms in pairs."""
    import torch

    from pint_tpu_torch.parallel import build_fit_step

    off, off_args, _ = build_fit_step(model, toas, device=dev, health=False)
    on, on_args, _ = build_fit_step(model, toas, device=dev, health=True)
    a, b = off(*off_args), on(*on_args)
    same = len(a) == 4 and len(b) == 5 and all(
        torch.equal(x, y) for x, y in zip(a, b[:4]))
    r = b[3].cpu().numpy()
    dp = b[0].cpu().numpy()
    chi2 = float(b[2])
    nvec, valid = (x.cpu().numpy() for x in on_args[8:10])
    hv = b[4].cpu().numpy()
    host = [float(np.sum(~np.isfinite(r)) + np.sum(~np.isfinite(dp))
                  + (not math.isfinite(chi2))),
            float(np.max(np.abs(r) * valid / np.sqrt(nvec))), chi2]
    rel = [abs(hv[i] - host[i]) / abs(host[i]) for i in (1, 2)]
    launches = [profile_window(lambda: off(*off_args), 1)[4],
                profile_window(lambda: on(*on_args), 1)[4]]
    for _ in range(2):
        off(*off_args), on(*on_args)
    pairs = [[], []]
    for _ in range(HEALTH_PAIRS):
        pairs[0].append(synced_ms(lambda: off(*off_args)))
        pairs[1].append(synced_ms(lambda: on(*on_args)))
    diffs = [y - x for x, y in zip(*pairs)]
    out = {"outputs_bitwise": same, "hv": hv.tolist(), "host": host,
           "rel": rel, "launches_disarmed": launches[0],
           "launches_armed": launches[1],
           "extra_launches": launches[1] - launches[0],
           "disarmed_ms": pairs[0], "armed_ms": pairs[1],
           "armed_minus_disarmed_ms": diffs,
           "median_disarmed_ms": float(np.median(pairs[0])),
           "median_armed_ms": float(np.median(pairs[1])),
           "median_pair_diff_ms": float(np.median(diffs))}
    print(f"health-taps: armed step outputs 0-3 bitwise the disarmed "
          f"step's {same}; health vector {hv.tolist()} against the host's "
          f"reductions {host} (max |r|/sigma {rel[0]:.2e}, chi2 "
          f"{rel[1]:.2e} relative; limit {HEALTH_REL}); launches disarmed "
          f"{launches[0]} (expected {FIT_STEP_LAUNCHES}), armed "
          f"{launches[1]} (+{launches[1] - launches[0]}); {HEALTH_PAIRS} "
          f"pairs in turns, host ms to synchronize: disarmed median "
          f"{out['median_disarmed_ms']:.3f} (min {min(pairs[0]):.3f}, max "
          f"{max(pairs[0]):.3f}), armed median {out['median_armed_ms']:.3f}"
          f" (min {min(pairs[1]):.3f}, max {max(pairs[1]):.3f}), armed "
          f"minus disarmed median {out['median_pair_diff_ms']:.3f} ms")
    if not (same and hv[0] == 0.0 and host[0] == 0.0
            and max(rel) <= HEALTH_REL
            and launches[0] == FIT_STEP_LAUNCHES
            and launches[1] > launches[0]):
        fail("health-taps: the armed step disagrees with the disarmed step "
             "or with the host, or the disarmed step's launches moved")
    return out


def health_shadow(par: str, toas, dev) -> dict:
    """(b) GLSFitter on the fit cell with $PINT_TPU_HEALTH=1 and
    $PINT_TPU_SHADOW_RATE=1: every Cholesky solve replayed on the numpy
    mirror in the background, the drift inside the band, /healthz ok."""
    import torch

    from pint_tpu_torch.gls import GLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.obs import health
    from pint_tpu_torch.obs import metrics as om

    mon = health.get_monitor()
    if not (mon.enabled and mon.shadow_rate == 1):
        fail("health-shadow: the environment did not arm the monitor")
    shadows_idle()
    base = mon.status()["shadow_replays"]
    fit = GLSFitter(toas, get_model(io.StringIO(par), device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chi2 = fit.fit_toas(maxiter=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    replays = wait_replays(base + 2)
    wait_s = time.perf_counter() - t0
    drift = drift_max("gls")
    st = mon.status()
    h = om.default_health()
    out = {"fit_s": wall, "chi2": chi2, "replays": replays - base,
           "replay_wait_s": wait_s, "drift_sigma": drift,
           "band": mon.drift_band, "exceeded": st["shadow_drift_exceeded"],
           "healthz_ok": h["ok"], "incidents": st["incidents"]}
    print(f"health-shadow: GLSFitter on the fit cell, 2 solves in "
          f"{wall:.3f} s, {out['replays']} replays on the numpy mirror "
          f"(done {wait_s:.3f} s after the fit), drift {drift!r} sigma "
          f"(band {mon.drift_band}), exceeded {out['exceeded']}, incidents "
          f"{out['incidents']}; /healthz ok {h['ok']}")
    if not (out["replays"] >= 1 and drift <= DRIFT_BAND
            and out["exceeded"] == 0 and h["ok"]):
        fail("health-shadow: the card's solve drifts from the mirror")
    return out


def health_device_fit(keep: dict, toas, dev) -> dict:
    """(c) Phase 9's stress problem refitted armed, one step a trial and
    whole_fit=True: bitwise phase 9's parameters, fit.device ok."""
    import copy

    import torch

    from pint_tpu_torch.gls import DeviceDownhillGLSFitter

    out = {}
    for tag, kw in (("step", {}), ("whole", {"whole_fit": True})):
        m = copy.deepcopy(keep["model"])
        fit = DeviceDownhillGLSFitter(toas, m, health=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit.fit_toas(maxiter=keep["maxiter"], **kw)
        torch.cuda.synchronize()
        same = [m.get_param(n).value for n in m.free_params] == keep[tag]
        out[tag] = {"wall_s": time.perf_counter() - t0, "bitwise": same,
                    "iterations": fit.stats.iterations}
    out["verdict"] = health_verdict("device/fit.device")
    print(f"health-device-fit: stress problem armed, one step a trial "
          f"{out['step']['wall_s']:.3f} s, whole fit "
          f"{out['whole']['wall_s']:.3f} s; parameters bitwise phase 9's "
          f"{out['step']['bitwise']} / {out['whole']['bitwise']}; "
          f"fit.device verdict {out['verdict']}")
    if not (out["step"]["bitwise"] and out["whole"]["bitwise"]
            and out["verdict"]["ok"]):
        fail("health-device-fit: the armed fit moved or is not healthy")
    return out


def health_stream(keep: dict, dev) -> dict:
    """(c) The streaming fit at phase 9's 200,000 TOAs, armed and
    shadowed: the chunk vectors' worst rescale, the CG effort, the
    shadow's drift inside the band."""
    import copy

    import torch

    from pint_tpu_torch.gls import StreamingGLSFitter
    from pint_tpu_torch.obs import health
    from pint_tpu_torch.obs import metrics as om

    shadows_idle()
    base = health.get_monitor().status()["shadow_replays"]
    fit = StreamingGLSFitter(keep["toas"], copy.deepcopy(keep["model"]),
                             health=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chi2 = fit.fit_toas(maxiter=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wait_replays(base + fit.passes)
    drift = drift_max("stream")
    reg = om.get_registry()
    rescale = max(reg.value("pint_tpu_health_last_value", kind=k,
                            signal="rescale")
                  for k in ("stream.chunk", "stream.solve"))
    out = {"ntoa": keep["toas"].ntoas, "fit_s": wall, "chi2": chi2,
           "passes": fit.passes, "converged": fit.converged,
           "cg_iters": fit.cg_iters, "cg_budget": fit.cg_budget,
           "cg_rel_residual": fit.cg_rel_residual,
           "cg_iters_per_pass": fit.cg_iters_per_pass,
           "worst_rescale": rescale, "drift_sigma": drift,
           "verdicts": {k: health_verdict(k) for k in (
               "device/stream.chunk", "device/stream.solve",
               "shadow/stream")}}
    print(f"health-stream: {out['ntoa']} TOAs armed, {fit.passes} passes "
          f"in {wall:.3f} s, converged {fit.converged}; worst chunk rescale"
          f" {rescale!r}; CG {fit.cg_iters} iterations (budget "
          f"{fit.cg_budget}, per pass {fit.cg_iters_per_pass}), relative "
          f"residual {fit.cg_rel_residual!r}; shadow drift {drift!r} sigma "
          f"(band {DRIFT_BAND}); verdicts {out['verdicts']}")
    if not (fit.converged and drift <= DRIFT_BAND
            and all(v["ok"] for v in out["verdicts"].values())):
        fail("health-stream: the armed streaming fit is not healthy")
    return out


def health_chain(keep: dict, dev) -> dict:
    """(c) One armed chain chunk of the Bayesian fit cell: a
    posterior.chunk verdict."""
    from pint_tpu_torch.sampling import DeviceEnsembleSampler

    post, p0 = keep["post"], keep["p0"]
    s = DeviceEnsembleSampler(len(p0), post.nparams, post.lnpost_batch,
                              device=dev)
    t0 = time.perf_counter()
    s.run_mcmc(p0, 16, seed=11)
    out = {"walkers": len(p0), "steps": 16, "dispatches": s.dispatches,
           "wall_s": time.perf_counter() - t0,
           "verdict": health_verdict("device/posterior.chunk")}
    print(f"health-chain: {len(p0)} walkers x 16 steps in {s.dispatches} "
          f"chunk ({out['wall_s']:.3f} s): posterior.chunk verdict "
          f"{out['verdict']}")
    if not (s.dispatches == 1 and out["verdict"]["ok"]):
        fail("health-chain: the armed chunk is not healthy")
    return out


def health_incidents(par: str, toas, gpu_ref: dict, dev, tmp: str) -> dict:
    """(d) A NaN readback of the device fit: one numerics:nonfinite dump,
    and the fit fails over bitwise to phase 6's card fit (as phase 14
    (d)); a float32 Gram forced into the shadowed solve: numerics:drift."""
    from pint_tpu_torch import gls as pgls
    from pint_tpu_torch import obs
    from pint_tpu_torch.gls import DeviceDownhillGLSFitter, GLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.obs import health
    from pint_tpu_torch.runtime import Fault, FaultPlan, reset_runtime

    fdir = os.path.join(tmp, "flight")
    obs.configure(enabled=False, flight_dir=fdir)
    reset_runtime()
    fit = DeviceDownhillGLSFitter(toas, get_model(io.StringIO(par),
                                                  device=dev), health=True)
    with FaultPlan([Fault(match="gls.fit", kind="nan")]).active(), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit.fit_toas()
    nonfinite = [f for f in os.listdir(fdir) if "numerics_nonfinite" in f]
    bitwise = same_fit(fit_state(fit), gpu_ref)
    reset_runtime()
    mon = health.get_monitor()
    shadows_idle()    # the failover's own solves were shadowed too
    base = mon.status()["shadow_replays"]
    exceeded0 = mon.status()["shadow_drift_exceeded"]
    real = pgls._symm_mm
    pgls._symm_mm = lambda X, Y: (X.float().T @ Y.float()).double()
    try:
        GLSFitter(toas, get_model(io.StringIO(par), device=dev)).fit_toas(
            maxiter=1)
        wait_replays(base + 2)
    finally:
        pgls._symm_mm = real
    st = mon.status()
    drift_dumps = [f for f in os.listdir(fdir) if "numerics_drift" in f]
    out = {"nonfinite_dumps": len(nonfinite), "failover_bitwise": bitwise,
           "f32_drift_sigma": drift_max("gls"),
           "f32_exceeded": st["shadow_drift_exceeded"] - exceeded0,
           "last_incident": st["last_incident"]["reason"],
           "drift_dumps": len(drift_dumps)}
    print(f"health-incidents: NaN device fit -> {len(nonfinite)} "
          f"numerics:nonfinite dump, failover bitwise phase 6's card fit "
          f"{bitwise}; float32 Gram in the shadowed solve: drift up to "
          f"{out['f32_drift_sigma']!r} sigma (band {DRIFT_BAND}), "
          f"{out['f32_exceeded']} replays past the band, last incident "
          f"{out['last_incident']}, {len(drift_dumps)} numerics:drift dump")
    if not (len(nonfinite) == 1 and bitwise and out["f32_exceeded"] >= 1
            and out["last_incident"] == "drift" and drift_dumps):
        fail("health-incidents: an incident was missed or the failover "
             "moved")
    return out


def padding_check(model, toas, dev) -> dict:
    """(e) The fit cell padded to PAD_TO TOAs against the unpadded step on
    the card: fit-step's limits on the valid rows; both steps timed."""
    from pint_tpu_torch.parallel import build_fit_step

    n = toas.ntoas
    step, args, names = build_fit_step(model, toas, device=dev, health=False)
    pstep, pargs, pnames = build_fit_step(model, toas, device=dev,
                                          pad_to=PAD_TO, health=False)
    want = [x.cpu().numpy() for x in step(*args)]
    got = [x.cpu().numpy() for x in pstep(*pargs)]
    d = step_diff(got[:3] + [got[3][:n]], want)
    ms = [[], []]
    for _ in range(5):
        ms[0].append(synced_ms(lambda: step(*args)))
        ms[1].append(synced_ms(lambda: pstep(*pargs)))
    out = {"pad_to": PAD_TO, **d, "pad_rows_zero":
           bool(np.all(got[3][n:] == 0.0)),
           "unpadded_ms": float(np.median(ms[0])),
           "padded_ms": float(np.median(ms[1])), "ms": ms}
    print(f"padding: the fit cell padded {n} -> {PAD_TO} TOAs against the "
          f"unpadded step on the card: dparams {d['dp_sigma']:.3e} sigma, "
          f"cov {d['cov_rel']:.3e}, chi2 {d['chi2_rel']:.3e} relative, "
          f"residuals {d['resid_s']:.3e} s (limits {DP_SIGMA}, {COV_REL}, "
          f"{CHI2_REL}, {RESID_S}); host ms to synchronize, medians of 5 in "
          f"turns: unpadded {out['unpadded_ms']:.3f}, padded "
          f"{out['padded_ms']:.3f}")
    if not (within_limits(d) and pnames == names and out["pad_rows_zero"]):
        fail("padding: the padded step disagrees with the unpadded step")
    return out


def perf_plane(step: dict, k1: dict, dev) -> dict:
    """(f) $PINT_TPU_PERF=1: the guarded fit step's four phases against
    its wall; the compile ledger against the dispatched keys; K1's
    roofline block against phase 5's share of bound; one profiler window
    over fit steps; one auto window on a forced breaker-open."""
    import torch

    from pint_tpu_torch import obs
    from pint_tpu_torch.obs import perf
    from pint_tpu_torch.runtime import Fault, FaultPlan, get_supervisor, \
        reset_runtime
    from pint_tpu_torch.runtime.supervisor import backend_of

    from pint_tpu_torch import config

    # armed by the environment, so the ledger that holds the run's keys
    # stays the same instance
    pdir = config.profile_dir()
    if not (perf.enabled() and pdir):
        fail("perf: the environment did not arm the plane")
    sup = get_supervisor()
    backend = backend_of(dev)
    run = lambda: step["step"](*step["args"])  # noqa: E731
    names = ("queue_wait", "host_assembly", "device_wall", "collect")
    calls = []
    for _ in range(6):
        before = {p: (sup.metrics.perf.get((backend, "perf.fit_step"), p)
                      or types.SimpleNamespace(sum_s=0.0)).sum_s
                  for p in names}
        t0 = time.perf_counter()
        sup.dispatch(run, key="perf.fit_step", device=dev, guard=True)
        wall = time.perf_counter() - t0
        ph = {p: sup.metrics.perf.get((backend, "perf.fit_step"), p).sum_s
              - before[p] for p in names}
        calls.append({"wall_ms": wall * 1e3,
                      **{f"{p}_ms": v * 1e3 for p, v in ph.items()},
                      "sum_ms": sum(ph.values()) * 1e3})
    steady = calls[1:]
    within = all(c["sum_ms"] <= c["wall_ms"] + 1.0 for c in calls)
    print("perf-phases: guarded fit step, steady calls (ms): " + "; ".join(
        f"wall {c['wall_ms']:.3f} = queue {c['queue_wait_ms']:.3f} + "
        f"assembly {c['host_assembly_ms']:.3f} + device "
        f"{c['device_wall_ms']:.3f} + collect {c['collect_ms']:.3f} "
        f"(sum {c['sum_ms']:.3f})" for c in steady)
        + f"; first call {calls[0]['wall_ms']:.3f}")
    led = perf.get_ledger()
    lat = sup.snapshot().get("latency", {})
    keys = sorted({k.split("/", 1)[1] for k in lat})
    missing = [k for k in keys
               if (led.get(k) or {}).get("compile_wall_s") is None]
    snap = led.snapshot()
    walled = {k for k, e in snap["entries"].items()
              if e.get("compile_wall_s") is not None}
    prior_walled = set()
    if snap["path"] and os.path.exists(snap["path"]):
        with open(snap["path"], encoding="utf-8") as fh:
            for line in fh:
                rec = json.loads(line)
                if rec.get("compile_wall_s") is not None:
                    prior_walled.add(rec["key"])
    all_keys = sorted(walled | prior_walled)
    print(f"perf-ledger: {len(keys)} keys dispatched since the last reset, "
          f"each with its first-call wall: {not missing} (missing "
          f"{missing}); {len(all_keys)} dispatch keys ledgered across the "
          f"smoke ({snap['path']}): first-call walls "
          + ", ".join(f"{k} {(led.get(k) or {}).get('compile_wall_s')}"
                      for k in all_keys[:12]) + " ...")
    share5 = k1["share_phase5"]
    blk = k1["block"] or {}
    share16 = max(blk.get("achieved_frac_flops", 0.0),
                  blk.get("achieved_frac_hbm", 0.0))
    roof_rel = abs(share16 / share5 - 1.0) if share5 else float("inf")
    print(f"perf-roofline: roofline_block('z2_harmonics') at phase 5's "
          f"float64-input {k1['ms']:.4f} ms: {blk}; share of bound "
          f"{share16:.6f} against phase 5's {share5:.6f} ({roof_rel:.2e} "
          f"relative, limit {ROOFLINE_REL})")
    res = perf.request_window(PROFILE_WINDOW_S, reason="phase16")
    nsteps = 0
    t0 = time.perf_counter()
    while perf.get_profiler().status()["open"] is not None and \
            time.perf_counter() - t0 < PROFILE_WINDOW_S + 60.0:
        sup.dispatch(run, key="perf.fit_step", device=dev)
        nsteps += 1
    t_win = time.perf_counter() - t0
    meta = json.load(open(os.path.join(res["dir"], "window.json"),
                          encoding="utf-8")) if res.get("dir") else {}
    kernels = 0
    if meta.get("device_trace"):
        with open(meta["device_trace"], encoding="utf-8") as fh:
            kernels = sum(1 for e in json.load(fh)["traceEvents"]
                          if e.get("cat") == "kernel")
    print(f"perf-window: {res} -> status {meta.get('status')}, "
          f"{nsteps} fit steps in {t_win:.3f} s, window.json and "
          f"{meta.get('device_trace')} with {kernels} kernel events")
    os.environ["PINT_TPU_BREAKER_THRESHOLD"] = "1"
    with FaultPlan([Fault(match="perf.trip", kind="error",
                          count=8)]).active():
        trips = [sup.dispatch(lambda: 1.0, key="perf.trip", device=dev,
                              fallback=lambda: -1.0) for _ in range(2)]
    wins = [w for w in os.listdir(pdir) if "breaker_open" in w]
    t0 = time.perf_counter()
    while perf.get_profiler().status()["open"] is not None and \
            time.perf_counter() - t0 < 60.0:
        time.sleep(0.05)
    del os.environ["PINT_TPU_BREAKER_THRESHOLD"]
    reset_runtime()
    obs.reset()
    torch.cuda.synchronize()
    print(f"perf-breaker: two failing dispatches -> {trips}, "
          f"{len(wins)} breaker_open window ({wins})")
    out = {"calls": calls, "phases_within_wall": within,
           "ledger_keys": keys, "ledger_missing": missing,
           "ledger_all_keys": len(all_keys),
           "roofline": blk, "share_phase5": share5, "share_phase16": share16,
           "roofline_rel": roof_rel, "window": {**res, "meta": meta,
                                                "steps": nsteps,
                                                "kernels": kernels},
           "breaker_windows": len(wins)}
    checks = {"phases_within_wall": within, "every_key_ledgered": not missing,
              "roofline_as_phase5": roof_rel <= ROOFLINE_REL,
              "window_closed": bool(res.get("ok"))
              and meta.get("status") == "closed",
              "window_traced_kernels": kernels > 0,
              "breaker_failed_over": trips == [-1.0, -1.0],
              "one_breaker_window": len(wins) == 1}
    out["checks"] = checks
    if not all(checks.values()):
        fail(f"perf: {[k for k, v in checks.items() if not v]} failed")
    return out


def slo_check(step: dict, dev, tmp: str) -> dict:
    """(g) SLOWatchdog(default_specs()) over the run's registry across
    armed fit steps: no burn; a synthetic burn: one slo_burn dump and
    one window cross-linked to it."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.obs import health, perf
    from pint_tpu_torch.obs import metrics as om
    from pint_tpu_torch.obs.slo import SLOSpec, SLOWatchdog, default_specs
    from pint_tpu_torch.runtime import get_supervisor, reset_runtime

    reset_runtime()
    obs.reset()
    health.configure(enabled=True)
    sup = get_supervisor()
    wd = SLOWatchdog(specs=default_specs())
    fired = []
    for k in range(7):
        for _ in range(3):
            out = sup.dispatch(lambda: step["step"](*step["args"]),
                               key="slo.fit_step", device=dev)
            health.observe("fit.device", {"values": [out[0], out[2]],
                                          "chi2": float(out[2])},
                           key="slo.fit_step")
        fired += wd.tick(now=70.0 * k)
    healthy = {"fired": fired, "fires": wd.fires, "ticks": wd.ticks,
               "specs": [(s["name"], s["fast_burn"], s["slow_burn"])
                         for s in wd.status()["specs"]]}
    fdir, pdir = os.path.join(tmp, "slo-flight"), os.path.join(tmp,
                                                               "slo-prof")
    obs.configure(enabled=True, flight_dir=fdir)
    perf.configure(profile_dir=pdir, max_s=0.5)
    spec = SLOSpec(name="phase16", type="ratio", bad=["phase16_bad_total"],
                   total=["phase16_all_total"], budget=0.01, fast_s=10.0,
                   slow_s=30.0, min_events=1, min_samples=1)
    bad, allc = om.counter("phase16_bad_total"), om.counter(
        "phase16_all_total")
    swd = SLOWatchdog(specs=[spec], interval_s=1.0)
    allc.inc(10)
    burn = swd.tick(now=0.0)
    bad.inc(10)
    allc.inc(10)
    burn += swd.tick(now=40.0)
    bad.inc(10)
    allc.inc(10)
    burn += swd.tick(now=80.0)
    t0 = time.perf_counter()
    while perf.get_profiler().status()["open"] is not None and \
            time.perf_counter() - t0 < 60.0:
        time.sleep(0.05)
    dumps = [f for f in os.listdir(fdir) if "slo_burn" in f]
    wins = sorted(w for w in os.listdir(pdir) if w.startswith("window-"))
    meta = json.load(open(os.path.join(pdir, wins[0], "window.json"),
                          encoding="utf-8")) if wins else {}
    linked = (meta.get("extra") or {}).get("flight")
    out = {"healthy": healthy, "burn_fired": burn, "dumps": len(dumps),
           "windows": len(wins), "window_status": meta.get("status"),
           "crosslinked": bool(linked) and os.path.basename(linked) in dumps}
    print(f"slo: default specs over {wd.ticks} ticks of armed fit steps: "
          f"fired {fired}; synthetic burn fired {burn}, {len(dumps)} "
          f"slo_burn dump, {len(wins)} window ({meta.get('status')}), "
          f"cross-linked {out['crosslinked']}")
    if not (fired == [] and burn == ["phase16"] and len(dumps) == 1
            and len(wins) == 1 and out["crosslinked"]):
        fail("slo: a healthy card burned, or the synthetic burn did not "
             "fire exactly one dump and one window")
    obs.reset()
    reset_runtime()
    return out


def health_perf_phase(ctx: dict, dev) -> dict:
    """Phase 16: the numerical-health, performance-attribution and SLO
    planes and TOA padding on the fit cell and phases 6, 9 and 12's
    problems ((a)-(g), each fatal)."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.runtime import reset_runtime

    secs, out = {}, {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out[name] = fn(*a)
        secs[name] = time.perf_counter() - t0

    saved = {k: os.environ.get(k) for k in PHASE16_ENV}
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    os.environ.update({
        "PINT_TPU_HEALTH": "1", "PINT_TPU_SHADOW_RATE": "1",
        "PINT_TPU_PERF": "1",
        "PINT_TPU_PROFILE_DIR": os.path.join(tmp, "profile"),
        "PINT_TPU_PROFILE_MAX_S": str(PROFILE_WINDOW_S)})
    reset_runtime()
    obs.reset()
    try:
        timed("taps", health_taps, ctx["model"], ctx["toas"], dev)
        timed("shadow", health_shadow, ctx["par"], ctx["toas"], dev)
        timed("device_fit", health_device_fit, ctx["stress"],
              ctx["stress_toas"], dev)
        timed("stream", health_stream, ctx["stream"], dev)
        timed("chain", health_chain, ctx["bayes"], dev)
        timed("incidents", health_incidents, ctx["par"], ctx["toas"],
              ctx["gpu_ref"], dev, tmp)
        timed("padding", padding_check, ctx["model"], ctx["toas"], dev)
        timed("perf", perf_plane, ctx["step"], ctx["k1"], dev)
        timed("slo", slo_check, ctx["step"], dev, tmp)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_runtime()
        obs.reset()
        tmpdir.cleanup()
    print("health and perf seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()))
    out["seconds"] = secs
    return out


# ------------------------------------------------------------ serving (17)

SERVE_NREQ = 64                # bench_serve.py's mixed workload
SERVE_COPIES = 4               # (b): FitStepRequests of each full-width cell
SERVE_MODE_RTOL = 1e-9         # tests/test_serve.py: coalesced vs sequential
SERVE_ORACLE_RTOL = 1e-8       # tests/test_serve.py: the host oracles
SERVE_PHASE_TURNS = 2e-9       # 10 ps at the workload polyco's 200 Hz
SERVE_FULL_SIGMA, SERVE_FULL_COV, SERVE_FULL_CHI2 = 1e-6, 1e-8, 1e-10
SERVE_APPEND = (8_000, 500, 4)  # cold TOAs, TOAs an append, appends
SERVE_APPEND_SIGMA, SERVE_APPEND_CHI2 = 1e-7, 1e-8  # test_streaming_gls.py
SERVE_PHASE_NMJD = 100_000
SERVE_POLYCO_TURNS = 1e-9      # (d) against PolycoEntry.abs_phase
SERVE_POST = (32, 600)         # (e) walkers, steps
SERVE_WEDGE = (1.0, 3.0)       # (f) deadline and hang of the wedged card [s]
SERVE_PASSES = 5               # (a) timed passes a mode, after a warm one


def serve_close(a, b, rtol: float, atol: float) -> float:
    """The worst relative difference of two served results, at most rtol
    where tests/test_serve.py's assert_allclose(rtol, atol) holds
    (dparams; cov diagonal, chi2 and chi2r relative); for phases the
    turns apart. 0 when bitwise equal."""
    if hasattr(a, "phase_int"):
        return float(np.max(np.abs((a.phase_int - b.phase_int)
                                   + (a.phase_frac - b.phase_frac)),
                            initial=0.0))
    if hasattr(a, "dparams"):
        return max(rel_err(a.dparams, b.dparams, rtol, atol),
                   rel_err(np.diag(a.cov), np.diag(b.cov), rtol),
                   abs(a.chi2 - b.chi2) / abs(b.chi2),
                   abs(a.chi2r - b.chi2r) / abs(b.chi2r))
    return abs(a.chi2 - b.chi2) / abs(b.chi2)


def serve_within(name: str, got: list, want: list, rtol: float,
                 atol: float = 1e-15) -> float:
    """Every pair within tests/test_serve.py's limits (phases within 10
    ps); returns the worst difference."""
    worst = 0.0
    for a, b in zip(got, want):
        lim = SERVE_PHASE_TURNS if hasattr(a, "phase_int") else rtol
        err = serve_close(a, b, rtol, atol)
        if not err <= lim:
            fail(f"serve: {name}: a result is {err:.3e} off (limit {lim})")
        worst = max(worst, err)
    return worst


def serve_bitwise(a, b) -> bool:
    if hasattr(a, "phase_int"):
        return np.array_equal(a.phase_int, b.phase_int) and \
            np.array_equal(a.phase_frac, b.phase_frac)
    if hasattr(a, "dparams"):
        return np.array_equal(a.dparams, b.dparams) and \
            np.array_equal(a.cov, b.cov) and a.chi2 == b.chi2 \
            and a.chi2r == b.chi2r
    return a.chi2 == b.chi2


def serve_clean(eng, label: str, host_ok: bool = False) -> dict:
    """A fault-free part: the engine's supervisor counts no failover,
    timeout or breaker rejection, and every unit ran on the device pool."""
    snap = eng.metrics.snapshot()
    d, rt = snap["dispatch"], snap["router"]
    out = {"failovers": d["failovers"], "timeouts": d["timeouts"],
           "breaker_rejections": d["breaker_rejections"],
           "device_units": rt["device"]["dispatches"],
           "host_units": rt["host"]["dispatches"]}
    bad = out["failovers"] or out["timeouts"] or out["breaker_rejections"] \
        or (out["host_units"] and not host_ok)
    if bad or any(not k.startswith("device/") for k in snap["latency"]):
        fail(f"serve: {label}: a fault-free part left the device: {out}")
    return out


def serve_stats(eng, n: int, wall: float) -> dict:
    snap = eng.metrics.snapshot()
    units = sum(b.batches for b in eng.metrics.buckets.values())
    return {"requests": n, "wall_s": wall, "requests_per_s": n / wall,
            "units": units, "occupancy": snap["batch_occupancy"],
            "padded_waste": snap["padded_waste"], "p50_ms": snap["p50_ms"],
            "p99_ms": snap["p99_ms"], "compile_count": snap["compile_count"],
            "classes": snap["bucket_count"]}


def serve_mixed(dev) -> dict:
    """(a) bench_serve's mixed workload through the engine on the card in
    three modes, each against the others, a CPU engine and the host
    oracles; requests/s, occupancy, waste, latency, launches a dispatch
    and the idle share of the coalesced mode."""
    from pint_tpu_torch.parallel.pta import pta_solve_np, stack_problems
    from pint_tpu_torch.serve import ServeEngine
    from pint_tpu_torch.serve.workload import BENCH_SIZES, build_workload

    t0 = time.perf_counter()
    fresh = build_workload(SERVE_NREQ, sizes=BENCH_SIZES, prebuild=True,
                           device=dev)
    build_s = time.perf_counter() - t0

    def sequential(eng):
        out = []
        for r in fresh():
            f = eng.submit(r)
            eng.flush()
            out.append(f.result(timeout=0))
        return out

    def coalesced(eng):
        futs = [eng.submit(r) for r in fresh()]
        eng.flush()
        return [f.result(timeout=0) for f in futs]

    def threaded(eng):
        eng.start()
        try:
            futs = [eng.submit(r) for r in fresh()]
            return [f.result(timeout=300) for f in futs]
        finally:
            eng.stop()

    from pint_tpu_torch.obs import perf

    modes, results = {}, {}
    for name, run, kw in (("sequential", sequential, {"pipeline_depth": 1}),
                          ("coalesced", coalesced, {}),
                          ("threaded", threaded, {"window_s": 0.005,
                                                  "pipeline_depth": 2})):
        walls = []
        for _ in range(1 + SERVE_PASSES):   # a fresh engine a pass
            # a new class's FLOP probe runs on a background thread: let
            # it end before the timed pass, which must not share the host
            perf.join_cost_probes()
            eng = ServeEngine(device=dev, **kw)
            t1 = time.perf_counter()
            res = run(eng)
            sync(dev)
            walls.append(time.perf_counter() - t1)
        timed = sorted(walls[1:])
        modes[name] = {**serve_stats(eng, len(res), timed[len(timed) // 2]),
                       "first_pass_s": walls[0],
                       "pass_s_min_max": [timed[0], timed[-1]],
                       "supervisor": serve_clean(eng, f"(a) {name}")}
        if modes[name]["compile_count"] != modes[name]["classes"]:
            fail(f"serve: (a) {name}: compile_count "
                 f"{modes[name]['compile_count']} != "
                 f"{modes[name]['classes']} classes")
        results[name] = res
    prof_eng = ServeEngine(device=dev)
    prof = device_busy(lambda: coalesced(prof_eng),
                       "serve (a): one coalesced pass")
    units = sum(b.batches for b in prof_eng.metrics.buckets.values())
    prof["units"] = units
    prof["launches_per_unit"] = prof["launches"] / max(1, units)
    ref = results["coalesced"]
    errs = {name: serve_within(f"(a) {name} vs coalesced", results[name],
                               ref, SERVE_MODE_RTOL, atol=1e-18)
            for name in ("sequential", "threaded")}
    cpu = coalesced(ServeEngine(device="cpu"))
    errs["cpu_engine"] = serve_within("(a) card vs CPU engine", ref, cpu,
                                      SERVE_ORACLE_RTOL)
    host = []
    for r in fresh():
        if hasattr(r, "entry"):
            pi, pf = r.entry.abs_phase(r.mjds)
            host.append(types.SimpleNamespace(phase_int=pi, phase_frac=pf))
        else:
            d, c, x2, x2r = pta_solve_np(stack_problems([r.problem]))
            host.append(types.SimpleNamespace(chi2=float(x2r[0]))
                        if r.kind == "residuals" else types.SimpleNamespace(
                dparams=d[0], cov=c[0], chi2=float(x2[0]),
                chi2r=float(x2r[0])))
    errs["host_oracles"] = serve_within("(a) card vs host oracles", ref,
                                        host, SERVE_ORACLE_RTOL)
    speed = modes["coalesced"]["requests_per_s"] / \
        modes["sequential"]["requests_per_s"]
    print(f"serve (a): {SERVE_NREQ} requests, classes "
          f"{modes['coalesced']['classes']} (workload built in "
          f"{build_s:.3f} s); " + "; ".join(
              f"{k} {v['requests_per_s']:.1f} req/s (median of "
              f"{SERVE_PASSES} passes, {v['pass_s_min_max'][0]:.4f}-"
              f"{v['pass_s_min_max'][1]:.4f} s; first pass "
              f"{v['first_pass_s']:.3f} s), occupancy {v['occupancy']}, "
              f"waste {v['padded_waste']}, p50 {v['p50_ms']} ms, p99 "
              f"{v['p99_ms']} ms" for k, v in modes.items())
          + f"; coalesced/sequential {speed:.2f}x; {prof['launches']} "
          f"launches in {units} units; worst differences {errs}")
    return {"modes": modes, "coalesced_over_sequential": speed,
            "profile": prof, "errors": errs, "build_s": build_s}


def serve_unit_breakdown(pr, key, dev) -> dict:
    """Where one full-width unit's dispatch goes: the host's padded
    stack of SERVE_COPIES copies, its one upload (ending in a
    synchronize), the batched solve (the median of 5 between CUDA
    events recorded around the call, so the host's enqueue gaps count,
    as in a dispatch; the host clock on the CPU) and the read back."""
    import torch

    from pint_tpu_torch.parallel.pta import STACK_KEYS, _solve_one, \
        read_back, stack_problems, upload

    t0 = time.perf_counter()
    st = stack_problems([pr] * SERVE_COPIES,
                        shape=(SERVE_COPIES, key[1], key[2], key[3]))
    stack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    up = upload(st, STACK_KEYS, dev)
    sync(dev)
    upload_s = time.perf_counter() - t0

    def solve():
        return _solve_one(*(up[k] for k in STACK_KEYS))

    if torch.device(dev).type == "cuda":
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            solve()
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        solve_ms = sorted(times)[len(times) // 2]
    else:
        t0 = time.perf_counter()
        solve()
        solve_ms = (time.perf_counter() - t0) * 1e3
    out = solve()
    t0 = time.perf_counter()
    read_back(out)
    read_s = time.perf_counter() - t0
    nbytes = sum(st[k].nbytes for k in STACK_KEYS)
    return {"stack_ms": stack_s * 1e3, "upload_ms": upload_s * 1e3,
            "upload_bytes": nbytes, "solve_ms": solve_ms,
            "read_back_ms": read_s * 1e3}


def serve_full_width(cells: dict, dev) -> dict:
    """(b) the fit cell and the stress problem as full-width GLS classes:
    SERVE_COPIES FitStepRequests of each, coalesced, against pta_solve of
    the problem alone on the card and pta_solve_np."""
    import torch

    from pint_tpu_torch.parallel.pta import pta_solve, pta_solve_np, \
        stack_problems
    from pint_tpu_torch.serve import FitStepRequest, ServeEngine
    from pint_tpu_torch.serve.bucket import gls_shape_class, pad_dim

    eng = ServeEngine(device=dev)
    out = {"cells": {}}
    for name, pr in cells.items():
        n, p = pr.M.shape
        q = pr.F.shape[1]
        key = gls_shape_class(n, p, q, eng.bucket_edges)
        nbytes = SERVE_COPIES * key[1] * key[3] * 8
        out["cells"][name] = {"n": n, "p": p, "q": q, "class": list(key),
                              "F_bytes": nbytes}
        print(f"serve (b): {name}: N = {n}, p = {p}, q = {q} (ECORR "
              f"columns included) -> class {key}; F is ({SERVE_COPIES}, "
              f"{key[1]}, {pad_dim(q)}) float64 = {nbytes / 2 ** 30:.3f} GiB")
    reqs = [FitStepRequest(problem=pr) for pr in cells.values()
            for _ in range(SERVE_COPIES)]
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    futs = [eng.submit(r) for r in reqs]
    eng.flush()
    res = [f.result(timeout=0) for f in futs]
    sync(dev)
    wall = time.perf_counter() - t0
    peak = None
    if torch.device(dev).type == "cuda":
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    lat = eng.metrics.snapshot()["latency"]
    for k, (name, pr) in enumerate(cells.items()):
        st = stack_problems([pr])
        t1 = time.perf_counter()
        alone = pta_solve(st, device=dev)
        alone_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        host = pta_solve_np(st)
        host_s = time.perf_counter() - t1
        cell = out["cells"][name]
        for label, (d, c, x2, _) in (("alone", alone), ("host", host)):
            sig = np.sqrt(np.diag(c[0]))
            worst = {"dp_sigma": 0.0, "cov_rel": 0.0, "chi2_rel": 0.0}
            for r in res[k * SERVE_COPIES:(k + 1) * SERVE_COPIES]:
                worst["dp_sigma"] = max(worst["dp_sigma"], float(
                    np.max(np.abs(r.dparams - d[0]) / sig)))
                worst["cov_rel"] = max(worst["cov_rel"], rel_err(
                    np.diag(r.cov), np.diag(c[0]), 1.0))
                worst["chi2_rel"] = max(worst["chi2_rel"],
                                        abs(r.chi2 - x2[0]) / abs(x2[0]))
            cell[f"vs_{label}"] = worst
            if not (worst["dp_sigma"] <= SERVE_FULL_SIGMA
                    and worst["cov_rel"] <= SERVE_FULL_COV
                    and worst["chi2_rel"] <= SERVE_FULL_CHI2):
                fail(f"serve (b): {name} vs pta_solve {label}: {worst}")
        cell.update(alone_s=alone_s, host_s=host_s, dispatch_ms=[
            v["dispatch_wall"]["max_ms"] for kk, v in lat.items()
            if kk.endswith("/".join(str(x) for x in cell["class"]))])
        cell["breakdown"] = serve_unit_breakdown(pr, cell["class"], dev)
    out.update(wall_s=wall, peak_gib=peak,
               supervisor=serve_clean(eng, "(b)"),
               compile_count=eng.metrics.compile_count)
    print(f"serve (b): {len(reqs)} full-width requests in {wall:.3f} s, peak "
          f"device memory {peak} GiB; " + "; ".join(
              f"{k}: dispatch {v['dispatch_ms']} ms (a unit alone: "
              f"{v['breakdown']}), vs alone "
              f"{v['vs_alone']}, vs host {v['vs_host']} (alone "
              f"{v['alone_s']:.3f} s, host {v['host_s']:.3f} s)"
              for k, v in out["cells"].items()))
    return out


def serve_append_check(fit_par: str, toas, dev) -> dict:
    """(c) a cold build of the fit cell's first SERVE_APPEND[0] TOAs, then
    appends of SERVE_APPEND[1] TOAs, each held to a cold streaming solve
    of all the TOAs so far. The append path refuses ECORR models (the
    reference's contract: appended epochs grow the basis), so the model
    is the fit cell's without its ECORR line, and with its DMX windows
    frozen (at their simulated 0): the TOAs are in time order, so the
    cold build never sees the last windows, whose columns would be
    zero (a singular system)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.streaming import stream_solve_np
    from pint_tpu_torch.serve import AppendTOAsRequest, ServeEngine
    from pint_tpu_torch.serve.append import build_append_rows

    cold, step, napp = SERVE_APPEND
    par = "\n".join(" ".join(x.split()[:2]) if x.startswith("DMX_") else x
                    for x in fit_par.splitlines()
                    if not x.startswith("ECORR")) + "\n"
    model = get_model(io.StringIO(par), device=dev)
    idx = np.arange(toas.ntoas)
    eng = ServeEngine(device=dev)
    rows = []
    for k in range(napp + 1):
        hi = cold + k * step
        part = toas.select((idx >= (0 if k == 0 else hi - step))
                           & (idx < hi))
        t0 = time.perf_counter()
        r = eng.submit(AppendTOAsRequest("fit-cell", toas=part, model=model,
                                         cold=(k == 0))).result(timeout=600)
        sync(dev)
        wall = time.perf_counter() - t0
        entry = eng.append_store.get("fit-cell")
        pr = build_append_rows(toas.select(idx < hi), model,
                               tspan=entry.tspan, tref=entry.tref)
        dp, cov, _, chi2r, _, ok, _, _ = stream_solve_np(
            pr.M, pr.F, pr.phi, pr.r, pr.nvec, 4096, incoffset=pr.submean)
        sig = np.sqrt(np.abs(np.diag(cov)))
        row = {"ntoa": r.ntoa_total, "cold": r.cold, "cg_iters": r.cg_iters,
               "wall_s": wall,
               "dp_sigma": float(np.max(np.abs(r.dparams - dp) / sig)),
               "chi2r_rel": abs(r.chi2r - chi2r) / abs(chi2r)}
        rows.append(row)
        if not (ok and r.ntoa_total == hi
                and row["dp_sigma"] < SERVE_APPEND_SIGMA
                and row["chi2r_rel"] < SERVE_APPEND_CHI2):
            fail(f"serve (c): the append to {hi} TOAs: {row}")
    print(f"serve (c): the fit cell without ECORR, DMX frozen (p = "
          f"{len(r.names)}, q = "
          f"{len(entry.phi)}), cold {cold} TOAs then {napp} x {step}: " +
          "; ".join(f"{x['ntoa']} TOAs {x['wall_s'] * 1e3:.1f} ms, CG "
                    f"{x['cg_iters']}, {x['dp_sigma']:.2e} sigma, chi2r "
                    f"{x['chi2r_rel']:.2e}" for x in rows))
    return {"rows": rows, "supervisor": serve_clean(eng, "(c)"),
            "append": eng.metrics.snapshot()["append"]}


def serve_phase_check(b_par: str, seed: int, dev) -> dict:
    """(d) phase 15's day of polycos (config 2 at gbt): SERVE_PHASE_NMJD
    MJDs over its segments, one PhasePredictRequest a segment, against
    PolycoEntry.abs_phase on the host and model.phase on the card."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.polycos import Polycos
    from pint_tpu_torch.serve import PhasePredictRequest, ServeEngine
    from pint_tpu_torch.toa import get_TOAs_array

    mg = get_model(io.StringIO(b_par), device=dev)
    mjd0 = float(np.round(mg.PEPOCH.value))
    span = (mjd0, mjd0 + POLYCO_DAYS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pc = Polycos.generate_polycos(
            mg, *span, "gbt", seg_length_min=POLYCO_SEG_MIN,
            ncoeff=POLYCO_NCOEFF, obsfreq_mhz=POLYCO_FREQ, device=dev)
    mjds = np.sort(np.random.default_rng(seed).uniform(
        span[0], span[1] - 1e-6, SERVE_PHASE_NMJD))
    seg = pc._entry_for(mjds)
    reqs = [PhasePredictRequest(pc.entries[s], mjds[seg == s])
            for s in np.unique(seg)]
    eng = ServeEngine(device=dev)
    t0 = time.perf_counter()
    futs = [eng.submit(r) for r in reqs]
    eng.flush()
    res = [f.result(timeout=0) for f in futs]
    sync(dev)
    wall = time.perf_counter() - t0
    host = max(float(np.max(np.abs((x.phase_int - hi) + (x.phase_frac - hf))))
               for x, (hi, hf) in zip(res, (r.entry.abs_phase(r.mjds)
                                            for r in reqs)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ev = get_TOAs_array(mjds, obs="gbt", freqs=POLYCO_FREQ, errors=1.0,
                            device=dev)
    ph = mg.phase(ev, abs_phase=True, device=dev)
    full = (ph.int.cpu().numpy(), ph.frac.cpu().numpy())
    got = (np.concatenate([x.phase_int for x in res]),
           np.concatenate([x.phase_frac for x in res]))
    order = np.concatenate([np.flatnonzero(seg == s) for s in np.unique(seg)])
    model_turns = float(np.max(turns_mod1(got, (full[0][order],
                                                full[1][order]))))
    out = {"mjds": len(mjds), "requests": len(reqs), "wall_s": wall,
           "mjds_per_s": len(mjds) / wall, "turns_vs_abs_phase": host,
           "turns_vs_model": model_turns,
           "classes": eng.metrics.snapshot()["bucket_count"],
           "supervisor": serve_clean(eng, "(d)")}
    print(f"serve (d): {len(mjds)} MJDs in {len(reqs)} segment requests, "
          f"{out['classes']} class(es), {wall * 1e3:.1f} ms "
          f"({out['mjds_per_s']:.0f} MJDs/s); vs abs_phase {host:.3e} turns "
          f"(limit {SERVE_POLYCO_TURNS}), vs model.phase {model_turns:.3e} "
          f"(limit {POLYCO_TURNS})")
    if not (host <= SERVE_POLYCO_TURNS and model_turns < POLYCO_TURNS):
        fail("serve (d): the served phases miss their oracles")
    return out


def serve_posterior_gwb(array: dict, nfreq: int, dev) -> dict:
    """(e) config 5's pulsars as PosteriorRequests, bitwise
    sample_problems' chains at the served class; a GWBRequest at config 5,
    bitwise gwb_sweep_driver on its likelihood."""
    from pint_tpu_torch import config
    from pint_tpu_torch.pta.gwb import gwb_sweep_driver
    from pint_tpu_torch.sampling import sample_problems
    from pint_tpu_torch.serve import GWBRequest, PosteriorRequest, \
        ServeEngine
    from pint_tpu_torch.serve.bucket import posterior_shape_class

    problems, positions = array["problems"], array["positions"]
    W, nsteps = SERVE_POST
    eng = ServeEngine(device=dev)
    t0 = time.perf_counter()
    futs = [eng.submit(PosteriorRequest(problem=pr, nwalkers=W,
                                        nsteps=nsteps, seed=k))
            for k, pr in enumerate(problems)]
    eng.flush()
    res = [f.result(timeout=0) for f in futs]
    post_s = time.perf_counter() - t0
    # the direct path at each served class: the requests of one class,
    # in submission order, max_batch to a unit, padded as the engine pads
    groups: dict = {}
    for k, pr in enumerate(problems):
        n, p = pr.M.shape
        groups.setdefault(posterior_shape_class(
            n, p, pr.F.shape[1], W, config.chain_chunk_steps(nsteps), 1,
            eng.bucket_edges), []).append(k)
    t0 = time.perf_counter()
    classes = []
    for key, ks in groups.items():
        _, nb, pb, qb = key[:4]
        for i in range(0, len(ks), eng.max_batch):
            unit = ks[i:i + eng.max_batch]
            Pb = eng._batch_pad(len(unit))
            classes.append(list(key) + [Pb])
            direct = sample_problems([problems[k] for k in unit], W, nsteps,
                                     seeds=unit, shape=(Pb, nb, pb, qb),
                                     device=dev)
            if not all(np.array_equal(res[k].chain, c)
                       and np.array_equal(res[k].lnprob, lp)
                       for k, (c, lp, _) in zip(unit, direct)):
                fail(f"serve (e): the chains of class {key} differ from "
                     "sample_problems'")
    direct_s = time.perf_counter() - t0
    if sorted(map(tuple, classes)) != sorted(
            k for k in eng.metrics.buckets if k[0] == "posterior"):
        fail(f"serve (e): served classes {list(eng.metrics.buckets)} are "
             f"not {classes}")
    LA, GA = np.meshgrid(np.linspace(-15.5, -13.5, GWB_GRID),
                         np.linspace(2.0, 6.0, GWB_GRID))
    req = GWBRequest(problems=problems, positions=positions, nfreq=nfreq,
                     log10A=LA.ravel(), gamma=GA.ravel())
    t0 = time.perf_counter()
    g = eng.submit(req).result(timeout=600)
    gwb_s = time.perf_counter() - t0
    want = gwb_sweep_driver(req.likelihood, req.log10A, req.gamma,
                            config.gwb_chunk())()
    if not np.array_equal(g.logL, want):
        fail("serve (e): the served GWB grid differs from the sweep's")
    out = {"posterior": {"classes": classes, "wall_s": post_s,
                         "direct_s": direct_s,
                         "walker_steps_per_s": len(problems) * W * nsteps
                         / post_s},
           "gwb": {"points": len(req.log10A), "wall_s": gwb_s,
                   "points_per_s": len(req.log10A) / gwb_s,
                   "best": g.best()},
           "supervisor": serve_clean(eng, "(e)")}
    print(f"serve (e): {len(problems)} posteriors ({W} x {nsteps}, classes "
          f"{classes}) in {post_s:.3f} s, bitwise sample_problems ({direct_s:.3f}"
          f" s); GWB {len(req.log10A)} points in {gwb_s:.3f} s, bitwise the "
          f"sweep; best {g.best()}")
    return out


def serve_degraded(dev) -> dict:
    """(f) the card killed mid-pipeline (every unit after the second one
    hangs past its deadline): every future completes, the failed-over
    units bitwise the host pool's results; an open breaker demotes the
    device pool; a tenant over quota, an expired deadline and a graceful
    stop are each shed with their label."""
    from pint_tpu_torch.runtime import Fault, FaultPlan, backend_of, \
        breaker_for, reset_runtime
    from pint_tpu_torch.serve import DeadlineExceeded, FitStepRequest, \
        ServeEngine, ShutdownShed, TenantOverQuota
    from pint_tpu_torch.serve.workload import BENCH_SIZES, build_workload

    fresh = build_workload(SERVE_NREQ, sizes=BENCH_SIZES, prebuild=True,
                           device=dev)
    reset_runtime()
    out = {}
    # the host pool: the breaker open, every unit demoted to the mirrors
    br = breaker_for(backend_of(torch_device(dev)))
    for _ in range(br.threshold):
        br.on_result(False)
    eng = ServeEngine(device=dev)
    futs = [eng.submit(r) for r in fresh()]
    eng.flush()
    host = [f.result(timeout=0) for f in futs]
    rt = eng.metrics.snapshot()["router"]
    out["demoted"] = {"host_units": rt["host"]["dispatches"],
                      "demotions": rt["host"]["demotions"],
                      "device_units": rt["device"]["dispatches"]}
    if not (rt["device"]["dispatches"] == 0 and rt["host"]["demotions"] >= 1):
        fail(f"serve (f): an open breaker did not demote: {out['demoted']}")
    reset_runtime()
    # the card dies mid-pipeline
    deadline, hang = SERVE_WEDGE
    eng = ServeEngine(device=dev, pipeline_depth=2)
    t0 = time.perf_counter()
    with short_deadline("serve.", deadline), FaultPlan(
            [Fault(match="serve.", kind="hang", seconds=hang,
                   after=2)]).active():
        futs = [eng.submit(r) for r in fresh()]
        eng.flush()
    wall = time.perf_counter() - t0
    if not all(f.done() for f in futs):
        fail("serve (f): a future hung when the card died")
    got = [f.result(timeout=0) for f in futs]
    snap = eng.metrics.snapshot()
    failed_over = sum(v["e2e"]["count"] for k, v in snap["latency"].items()
                      if k.startswith("host-failover/"))
    bitwise = sum(serve_bitwise(a, b) for a, b in zip(got, host))
    worst = serve_within("(f) after the card died vs the host pool", got,
                         host, SERVE_ORACLE_RTOL)
    out["killed"] = {"wall_s": wall, "failovers": snap["dispatch"]["failovers"],
                     "timeouts": snap["dispatch"]["timeouts"],
                     "failed_over_requests": failed_over,
                     "bitwise_host": bitwise, "worst": worst}
    if not (failed_over >= 1 and bitwise >= failed_over
            and snap["dispatch"]["failovers"] >= 1):
        fail(f"serve (f): mid-pipeline death: {out['killed']}")
    reset_runtime()
    pr = fresh()[0].problem
    eng = ServeEngine(device=dev, tenant_qps=0.001, tenant_burst=1.0)
    eng.submit(FitStepRequest(problem=pr, tenant="noisy"))
    try:
        eng.submit(FitStepRequest(problem=pr, tenant="noisy"))
        fail("serve (f): a tenant over quota was admitted")
    except TenantOverQuota:
        pass
    late = eng.submit(FitStepRequest(problem=pr, deadline_s=1e-4))
    time.sleep(0.01)
    eng.flush()
    try:
        late.result(timeout=0)
        fail("serve (f): an expired request was served")
    except DeadlineExceeded:
        pass
    adm = eng.metrics.snapshot()["admission"]
    eng = ServeEngine(device=dev, window_s=60.0).start()
    queued = [eng.submit(FitStepRequest(problem=pr)) for _ in range(3)]
    eng.stop(timeout=0.0)
    shed = 0
    for f in queued:
        try:
            f.result(timeout=10)
        except ShutdownShed:
            shed += 1
    out["shed"] = {"quota": adm["shed_quota"], "expired": adm["shed_expired"],
                   "shutdown": shed}
    if out["shed"] != {"quota": 1, "expired": 1, "shutdown": 3}:
        fail(f"serve (f): sheds {out['shed']}")
    print(f"serve (f): breaker open -> {out['demoted']}; card killed after "
          f"2 units -> {out['killed']}; sheds {out['shed']}")
    return out


def torch_device(dev):
    import torch

    return torch.device(dev)


def serve_restart_fleet(dev) -> dict:
    """(g) kill the engine mid-journal, restart it warm and replay
    (bitwise an uninterrupted engine, no new class); a two-worker fleet
    loses a worker and re-homes its unacknowledged admits."""
    from pint_tpu_torch.serve import EngineKilled, FitStepRequest, \
        FleetFront, PhasePredictRequest, ServeEngine
    from pint_tpu_torch.runtime import Fault, FaultPlan, reset_runtime
    from pint_tpu_torch.serve.workload import BENCH_SIZES, build_workload

    base = build_workload(16, sizes=BENCH_SIZES, prebuild=True,
                          device=dev)()

    def factory(payload):
        r = base[payload["i"]]
        if hasattr(r, "entry"):
            return PhasePredictRequest(r.entry, r.mjds, payload=payload)
        return type(r)(problem=r.problem, payload=payload)

    def batch():
        return [factory({"i": i}) for i in range(len(base))]

    def serve(eng, reqs):
        t0 = time.perf_counter()
        futs = [eng.submit(r) for r in reqs]
        eng.flush()
        out = [f.result(timeout=0) for f in futs]
        sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    reset_runtime()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        aot, jpath = os.path.join(tmp, "aot"), os.path.join(tmp, "j.jsonl")
        eng_b = ServeEngine(device=dev, aot_dir=aot, journal=jpath)
        _, cold_ms = serve(eng_b, batch())
        futs = [eng_b.submit(r) for r in batch()]
        with FaultPlan([Fault(match="serve.drain",
                              kind="kill_restart")]).active():
            try:
                eng_b.flush()
                fail("serve (g): the injected kill did not kill")
            except EngineKilled:
                pass
        unacked = eng_b.journal.counts()["unacknowledged"]
        eng_r = ServeEngine(device=dev)
        serve(eng_r, batch())
        ref, _ = serve(eng_r, batch())
        t0 = time.perf_counter()
        eng_c = ServeEngine(device=dev, aot_dir=aot, journal=jpath)
        restore_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rfuts = eng_c.replay(factory)
        eng_c.flush()
        res = [f.result(timeout=0) for f in rfuts]
        sync(dev)
        warm_ms = (time.perf_counter() - t0) * 1e3
        aot_snap = eng_c.cache.aot.snapshot()
        out["restart"] = {
            "unacknowledged": unacked, "replayed": len(res),
            "restored": aot_snap["restored"], "hits": aot_snap["hits"],
            "misses": aot_snap["misses"],
            "new_classes": eng_c.metrics.compile_count,
            "cold_first_batch_ms": cold_ms, "warm_replay_ms": warm_ms,
            "restore_ms": restore_ms,
            "bitwise": all(serve_bitwise(a, b) for a, b in zip(res, ref))}
        if not (out["restart"]["bitwise"] and len(res) == len(base)
                and eng_c.metrics.compile_count == 0
                and aot_snap["misses"] == 0 and aot_snap["restored"] >= 1
                and eng_c.journal.counts()["unacknowledged"] == 0):
            fail(f"serve (g): restart {out['restart']}")
        serve_clean(eng_c, "(g) restart")
        eng_c.stop()
        front = FleetFront(factory, n=2, journal=os.path.join(tmp, "f.jsonl"),
                           heartbeat_s=3600.0, lease_ttl_s=7200.0,
                           start=False, engine_kwargs={"device": dev})
        futs = [front.submit(r) for r in batch()]
        front.kill_worker("w0")
        moved = front.sweep()
        front.workers["w1"].engine.flush()
        if not all(f.done() for f in futs):
            fail("serve (g): the fleet lost a request")
        got = [f.result(timeout=0) for f in futs]
        worst = serve_within("(g) fleet vs an uninterrupted engine", got,
                             ref, SERVE_MODE_RTOL, atol=1e-18)
        out["fleet"] = {"rehomed": moved,
                        "unacknowledged": front.journal.counts()[
                            "unacknowledged"],
                        "worst": worst, "workers": front.snapshot()["workers"]}
        front.stop()
        if not (moved == len(base) // 2 and
                out["fleet"]["unacknowledged"] == 0):
            fail(f"serve (g): fleet {out['fleet']}")
    print(f"serve (g): restart {out['restart']}; fleet {out['fleet']}")
    return out


def serve_cli(dev, tmp: str) -> dict:
    """(h) pint_serve --demo 64 on the card; a stdin JSONL session on
    NGC6440E (fit_step, residuals, phase, posterior, stats) with a
    journal and the metrics port, /metrics and /healthz scraped, then
    SIGTERM: one result line a request, the session snapshot last."""
    import queue
    import signal
    import threading
    import urllib.request

    cmd = [sys.executable, "-m", "pint_tpu_torch.scripts.pint_serve"]
    if torch_device(dev).type != "cuda":
        cmd += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    demo = subprocess.run(cmd + ["--demo", str(SERVE_NREQ)], env=env,
                          capture_output=True, text=True, timeout=900)
    demo_s = time.perf_counter() - t0
    lines = [json.loads(x) for x in demo.stdout.strip().splitlines()]
    if demo.returncode or lines[-1].get("metric") != "serve_session" or \
            sum(x.get("ok") is True for x in lines[:-1]) != SERVE_NREQ:
        fail(f"serve (h): --demo {SERVE_NREQ}: rc {demo.returncode}, "
             f"{demo.stderr[-2000:]}")
    out = {"demo": {"wall_s": demo_s, "completed": lines[-1]["completed"],
                    "compile_count": lines[-1]["compile_count"],
                    "classes": lines[-1]["bucket_count"],
                    "dispatch": {k: lines[-1]["dispatch"][k] for k in (
                        "failovers", "timeouts", "breaker_rejections")}}}
    par, tim = NGC
    jpath = os.path.join(tmp, "serve.jsonl")
    recs = [{"kind": "fit_step", "par": par, "tim": tim, "id": "fit"},
            {"kind": "residuals", "par": par, "tim": tim, "id": "res"},
            {"kind": "phase", "par": par, "mjds": [53801.02],
             "obs": "gbt", "id": "phase"},
            {"kind": "posterior", "par": par, "tim": tim, "nsteps": 64,
             "seed": 1, "id": "post"},
            {"kind": "stats", "id": "stats"}]
    proc = subprocess.Popen(cmd + ["--journal", jpath, "--metrics-port", "0",
                                   "--window-ms", "5"], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    q: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [q.put(x) for x in proc.stdout],
                              daemon=True)
    reader.start()
    err_tail: list = []
    threading.Thread(target=lambda: [err_tail.append(x) for x in proc.stderr],
                     daemon=True).start()
    t0 = time.perf_counter()
    for r in recs:
        proc.stdin.write(json.dumps(r) + "\n")
    proc.stdin.flush()
    got, port = [], None
    # one line a request (its result, or an error line), after the
    # metrics server's announcement
    while sum("event" not in x for x in got) < len(recs):
        try:
            x = json.loads(q.get(timeout=600))
        except Exception:
            proc.kill()
            fail(f"serve (h): the session stalled: {''.join(err_tail)[-2000:]}")
        if x.get("event") == "metrics_server":
            port = x["port"]
        got.append(x)
    session_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{port}"
    metrics = urllib.request.urlopen(base + "/metrics", timeout=30).read() \
        .decode()
    health = json.loads(urllib.request.urlopen(base + "/healthz",
                                               timeout=30).read().decode())
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=300)
    reader.join(timeout=60)
    rest = []
    while not q.empty():
        rest.append(json.loads(q.get()))
    lines = got + rest
    per_id = {r["id"]: [x for x in lines if x.get("id") == r["id"]]
              for r in recs}
    snap = lines[-1]
    out["session"] = {
        "wall_s": session_s, "returncode": proc.returncode,
        "lines_per_request": {k: len(v) for k, v in per_id.items()},
        "ok": {k: all(x.get("ok") for x in v) for k, v in per_id.items()},
        "metrics_bytes": len(metrics),
        "healthz_ok": health.get("ok"),
        "healthz_device_backend": health.get("pools", {}).get(
            "device", {}).get("backend"),
        "last_metric": snap.get("metric"),
        "shutdown_signal": snap.get("shutdown_signal"),
        "journal_unacknowledged": None}
    from pint_tpu_torch.serve.journal import RequestJournal

    j = RequestJournal(jpath)
    out["session"]["journal_unacknowledged"] = j.counts()["unacknowledged"]
    j.close()
    s = out["session"]
    if not (s["returncode"] == 0
            and all(n == 1 for n in s["lines_per_request"].values())
            and all(s["ok"].values()) and s["last_metric"] == "serve_session"
            and s["shutdown_signal"] == "SIGTERM" and s["healthz_ok"]
            and "pint_tpu_serve_completed_total" in metrics
            and s["journal_unacknowledged"] == 0):
        fail(f"serve (h): session {s}")
    print(f"serve (h): --demo {SERVE_NREQ} {out['demo']}; session {s}")
    return out


def serve_phase(ctx: dict, dev) -> dict:
    """Phase 17: the serving path on the card at full width, (a)-(h), each
    fatal."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.parallel import build_problem
    from pint_tpu_torch.runtime import reset_runtime

    reset_runtime()
    obs.reset()
    secs, out = {}, {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out[name] = fn(*a)
        secs[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cells = {"fit": build_problem(ctx["toas"], ctx["model"]),
             "stress": build_problem(ctx["stress_toas"], ctx["stress"])}
    secs["build_problems"] = time.perf_counter() - t0
    timed("mixed", serve_mixed, dev)
    timed("full_width", serve_full_width, cells, dev)
    timed("append", serve_append_check, ctx["par"], ctx["toas"], dev)
    timed("phase", serve_phase_check, ctx["b_par"], ctx["seed"], dev)
    timed("posterior_gwb", serve_posterior_gwb, ctx["array"], ctx["nfreq"],
          dev)
    timed("degraded", serve_degraded, dev)
    timed("restart_fleet", serve_restart_fleet, dev)
    with tempfile.TemporaryDirectory() as tmp:
        timed("cli", serve_cli, dev, tmp)
    reset_runtime()
    obs.reset()
    print("serve seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in secs.items()))
    out["seconds"] = secs
    return out


# ------------------------------------ phase 18: the CLIs, pintk, analysis


CLI_QUARTER = (54000.0, 55000.0)   # (a) a quarter of FIT_SPAN
CLI_DELETE = 100                   # (a) TOAs the session deletes
CLI_RANDOM = 100                   # (a) random_models draws
CLI_BARY_NMJD = 100_000            # (b) pintbary's MJDs
CLI_ZIMA_NTOA = 10_000             # (b) zima's TOAs
# tests/test_torch_scripts.py's limits: pintbary's last printed digit of
# the day, the delay, zima's TOAs, pintpublish's fitted values [sigma]
CLI_BARY_DAY, CLI_DELAY_S, CLI_ZIMA_S, CLI_PUB_SIGMA = \
    1e-13, 1e-12, 1e-11, 1e-3


def on_card(label: str, objs: dict, dev) -> None:
    """Every device-side object of the phase lives on the card (cuda:0
    on the card; the given device in a CPU rehearsal)."""
    import torch

    def where(v):
        d = torch.device(v.device if hasattr(v, "device") else v)
        # "cuda" alone is the current device
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return d

    want = torch.device("cuda", 0) if torch.device(dev).type == "cuda" \
        else torch.device(dev)
    bad = {k: str(where(v)) for k, v in objs.items() if where(v) != want}
    if bad:
        fail(f"{label}: objects off {want}: {bad}")


def pulsar_fit_same(label: str, pg, pc) -> dict:
    """The card's Pulsar fit against the CPU's, fit-downhill's limits:
    the same fitter kind and free set, parameters within DP_SIGMA of the
    CPU uncertainties, chi2 within CHI2_REL plus what the residual
    difference explains, residuals within RESID_S."""
    fg, fc = pg.fitter, pc.fitter
    if type(fg) is not type(fc) or \
            pg.model.free_params != pc.model.free_params:
        fail(f"{label}: {type(fg).__name__} {pg.model.free_params} on the "
             f"card, {type(fc).__name__} {pc.model.free_params} on the CPU")
    sig = max(abs(pg.model.get_param(n).value - pc.model.get_param(n).value)
              / fc.errors[n] for n in pc.model.free_params)
    rg, rc = pg.postfit_resids, pc.postfit_resids
    dr = rg.time_resids.cpu().numpy() - rc.time_resids.numpy()
    cg, cc = float(rg.chi2), float(rc.chi2)
    tol = chi2_tol(cc, dr, fc.model.scaled_toa_uncertainty(fc.toas),
                   CHI2_REL)
    out = {"fitter": type(fg).__name__, "nfree": len(pg.model.free_params),
           "dp_sigma": sig, "chi2": cg, "chi2_rel": abs(cg - cc) / abs(cc),
           "chi2_rel_limit": tol / abs(cc),
           "resid_s": float(np.max(np.abs(dr)))}
    print(f"{label}: {out}")
    if not (sig <= DP_SIGMA and abs(cg - cc) <= tol
            and out["resid_s"] <= RESID_S):
        fail(f"{label}: the card's fit does not reach the CPU optimum")
    return out


def pintk_session(par: str, tim: str, dev) -> dict:
    """(a) pintk on the fit cell: Pulsar on the card against Pulsar on
    the CPU — the fit (auto: downhill GLS), then one session on both
    (select a quarter, jump it, fit, unjump, delete CLI_DELETE TOAs,
    undo, fit), random_models(CLI_RANDOM) on the card, plot_data postfit
    and pulse numbers, each held to the CPU's."""
    import torch

    from pint_tpu_torch.pintk import Pulsar
    from pint_tpu_torch.pintk.plk import PlkState

    secs, out = {}, {}
    t0 = time.perf_counter()
    pg = Pulsar(par, tim, device=dev)
    secs["load_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pc = Pulsar(par, tim, device="cpu")
    secs["load_cpu"] = time.perf_counter() - t0

    def both(name, fn):
        for tag, p in (("card", pg), ("cpu", pc)):
            t0 = time.perf_counter()
            r = fn(p)
            sync(dev)
            secs[f"{name}_{tag}"] = time.perf_counter() - t0
            out.setdefault(name, []).append(r)
        if out[name][0] != out[name][1]:
            fail(f"pintk {name}: card {out[name][0]!r}, CPU "
                 f"{out[name][1]!r}")

    both("fit", lambda p: p.fit() is not None)
    out["fit"] = pulsar_fit_same("pintk fit", pg, pc)
    both("select", lambda p: (p.select_mjd_range(*CLI_QUARTER),
                              int(p.selected.sum()))[1])
    both("jump", lambda p: p.jump_selection())
    both("fit2", lambda p: p.fit() is not None)
    out["fit2"] = pulsar_fit_same("pintk jumped fit", pg, pc)
    both("unjump", lambda p: p.unjump_selection())
    drop = np.zeros(pg.all_toas.ntoas, bool)
    drop[np.linspace(0, pg.all_toas.ntoas - 1, CLI_DELETE).astype(int)] = \
        True
    both("delete", lambda p: (p.delete_TOAs(drop), p.all_toas.ntoas))
    both("undo", lambda p: (p.undo(), p.all_toas.ntoas, len(p._undo_stack)))
    both("fit3", lambda p: p.fit() is not None)
    out["fit3"] = pulsar_fit_same("pintk session end", pg, pc)
    t0 = time.perf_counter()
    curves = pg.random_models(n=CLI_RANDOM, rng=np.random.default_rng(7))
    sync(dev)
    secs["random_models_card"] = time.perf_counter() - t0
    spread = float(curves.std(dim=0).max())
    if curves.shape != (CLI_RANDOM, pg.all_toas.ntoas) or \
            not bool(torch.isfinite(curves).all()) or not spread > 0:
        fail(f"pintk random_models: shape {tuple(curves.shape)}, spread "
             f"{spread}")
    out["random_models"] = {"n": CLI_RANDOM, "spread_s": spread}
    t0 = time.perf_counter()
    dg, dc = pg.plot_data(), pc.plot_data()
    secs["plot_data"] = time.perf_counter() - t0
    plot = {"resid_s": float(np.max(np.abs(dg["resids_us"]
                                           - dc["resids_us"]))) * 1e-6}
    for k in ("mjds", "errors_us", "freqs", "elongation"):
        plot[k] = float(np.max(np.abs(dg[k] - dc[k])
                               / np.maximum(np.abs(dc[k]), 1e-300)))
    st_g, st_c = PlkState(pg), PlkState(pc)
    for ax in ("year", "day_of_year", "serial"):
        st_g.set_axis(xaxis=ax)
        st_c.set_axis(xaxis=ax)
        xg, xc = st_g.xy()[0], st_c.xy()[0]
        plot[f"x_{ax}"] = float(np.max(np.abs(xg - xc)
                                       / np.maximum(np.abs(xc), 1e-300)))
    out["plot_data"] = plot
    if plot["resid_s"] > RESID_S or \
            max(v for k, v in plot.items() if k != "resid_s") > 1e-12 or \
            dg["obs"] != dc["obs"] or \
            not np.array_equal(dg["selected"], dc["selected"]):
        fail(f"pintk plot_data: {plot}")
    both("pulse_numbers", lambda p: (p.compute_pulse_numbers(),
                                     p.all_toas.get_pulse_numbers())[1]
         .tolist())
    out["pulse_numbers"] = len(out["pulse_numbers"][0])
    on_card("pintk", {"model": pg.model.device, "toas": pg.all_toas.device,
                      "fitter": pg.fitter.device, "curves": curves,
                      "resids": pg.postfit_resids.time_resids,
                      "batch": pg.model.get_cache(pg.all_toas)["batch"]
                      .tdb_day}, dev)
    for k in ("select", "jump", "unjump", "delete", "undo"):
        out[k] = out[k][0]
    out["seconds"] = secs
    print(f"pintk: {json.dumps(out, default=str)}")
    return out


def capture_main(main, argv) -> tuple:
    """(return code, stdout) of a script's main, not echoed as run_main
    echoes it (pintbary prints 100,000 lines), its warnings silenced."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(argv)
    return rc, buf.getvalue()


def tim_columns(path: str) -> tuple:
    """(day, frac-dd, freqs, errors, obs, flags) of a written tim file."""
    from pint_tpu_torch.io.tim import parse_tim
    from pint_tpu_torch.time.mjd import parse_mjd_strings

    rows = parse_tim(path)
    day, frac = parse_mjd_strings([t.mjd_str for t in rows])
    return (day, frac, [t.freq_mhz for t in rows],
            [t.error_us for t in rows], [t.obs for t in rows],
            [dict(t.flags) for t in rows])


def scripts_on_card(fit_par: str, fit_tim: str, b_par: str, seed: int,
                    dev, tmp: str) -> dict:
    """(b) the scripts on the card against --device cpu, to
    tests/test_torch_scripts.py's limits: pintbary at CLI_BARY_NMJD MJDs
    of config 2's par (and its delays directly, card vs CPU), zima at
    CLI_ZIMA_NTOA TOAs with both noise draws, pintpublish on the fit
    cell, convert_parfile (ELL1 -> DD), t2binary2pint, tcb2tdb and
    compare_parfiles."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.timing_model import copy_model
    from pint_tpu_torch.scripts import (compare_parfiles, convert_parfile,
                                        pintbary, pintpublish,
                                        t2binary2pint, tcb2tdb, zima)
    from pint_tpu_torch.toa import get_TOAs_array

    devs = (("card", str(dev)), ("cpu", "cpu"))
    secs, out = {}, {}
    bpath = os.path.join(tmp, "config2.par")
    with open(bpath, "w") as f:
        f.write(b_par)

    def run(name, main, argv_of):
        res = {}
        for tag, d in devs:
            t0 = time.perf_counter()
            rc, text = capture_main(main, argv_of(tag) + ["--device", d])
            secs[f"{name}_{tag}"] = time.perf_counter() - t0
            if rc != 0:
                fail(f"{name} --device {d} returned {rc}")
            res[tag] = text
        return res

    # pintbary: 100,000 seeded MJDs over config 2's span at gbt, 1400 MHz
    rng = np.random.default_rng(seed + 18)
    mjds = np.round(rng.uniform(B1855_SPAN[0], B1855_SPAN[1],
                                CLI_BARY_NMJD), 6)
    args = [repr(float(m)) for m in mjds]
    txt = run("pintbary", pintbary.main,
              lambda t: args + ["--parfile", bpath, "--obs", "gbt",
                                "--freq", "1400"])
    bat = {t: np.array([float(ln.split("->")[1])
                        for ln in txt[t].splitlines() if "->" in ln])
           for t in txt}
    day_err = float(np.max(np.abs(bat["card"] - bat["cpu"])))
    # the delay pintbary subtracts, card against CPU, of one TOA table
    delays = {}
    for tag, d in devs:
        m = copy_model(get_model(bpath, device=d))
        for nm in [c for c in m.components if c.startswith("Binary")]:
            m.remove_component(nm)
        if not delays:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t = get_TOAs_array(mjds, obs="gbt", freqs=1400.0,
                                   errors=1.0, ephem=m.EPHEM.value,
                                   device="cpu")
        delays[tag] = m.delay(t)
    delay_err = float((delays["card"].cpu() - delays["cpu"]).abs().max())
    out["pintbary"] = {"n": len(bat["card"]), "day_err": day_err,
                       "delay_s_err": delay_err}
    if len(bat["card"]) != CLI_BARY_NMJD or \
            day_err > CLI_BARY_DAY * (1 + 1e-6) or delay_err > CLI_DELAY_S:
        fail(f"pintbary: {out['pintbary']}")
    on_card("pintbary", {"delay": delays["card"]}, dev)

    # zima: 10,000 TOAs from config 2's par, white and correlated draws
    run("zima", zima.main,
        lambda t: [bpath, os.path.join(tmp, f"zima_{t}.tim"), "--ntoa",
                   str(CLI_ZIMA_NTOA), "--startMJD", str(B1855_SPAN[0]),
                   "--duration", str(B1855_SPAN[1] - B1855_SPAN[0]),
                   "--addnoise", "--addcorrnoise", "--seed", "0"])
    zg = tim_columns(os.path.join(tmp, "zima_card.tim"))
    zc = tim_columns(os.path.join(tmp, "zima_cpu.tim"))
    ds = ((zg[1][0] - zc[1][0]) + (zg[1][1] - zc[1][1])) * 86400.0
    out["zima"] = {"n": len(zg[0]),
                   "toa_s_err": float(np.max(np.abs(ds))),
                   "same_days": bool(np.array_equal(zg[0], zc[0])),
                   "same_columns": zg[2:] == zc[2:]}
    if not (out["zima"]["n"] == CLI_ZIMA_NTOA and out["zima"]["same_days"]
            and out["zima"]["same_columns"]
            and out["zima"]["toa_s_err"] <= CLI_ZIMA_S):
        fail(f"zima: {out['zima']}")

    # pintpublish on the fit cell: the CLI on both devices, its fitters
    # kept (main calls the module's publish_table) for the numbers
    fitters = []
    table_fn = pintpublish.publish_table

    def keep(f, **kw):
        fitters.append(f)
        return table_fn(f, **kw)

    pintpublish.publish_table = keep
    try:
        txt = run("pintpublish", pintpublish.main,
                  lambda t: [fit_par, fit_tim])
    finally:
        pintpublish.publish_table = table_fn
    fg, fc = fitters
    straddled = []
    tg, tc = txt["card"].splitlines(), txt["cpu"].splitlines()
    if len(tg) != len(tc):
        fail("pintpublish: tables of different lengths")
    for g, c in zip(tg, tc):
        if g == c:
            continue
        nm = g.split(" & ", 1)[0].split(" (")[0].replace(r"\_", "_")
        if nm not in fc.model.free_params or \
                abs(fg.model.get_param(nm).value
                    - fc.model.get_param(nm).value) \
                > CLI_PUB_SIGMA * fc.errors[nm]:
            fail(f"pintpublish: card {g!r}, CPU {c!r}")
        straddled.append(nm)
    out["pintpublish"] = {"rows": len(tg), "fitter": type(fg).__name__,
                          "straddled": straddled}
    if len(straddled) > 2:
        fail(f"pintpublish: {out['pintpublish']}")
    on_card("pintpublish", {"fitter": fg.device}, dev)

    # the converters and compare_parfiles: the same text on both devices
    t2 = os.path.join(tmp, "t2.par")
    with open(t2, "w") as f:
        f.write(b_par.replace("BINARY ELL1", "BINARY T2"))
    tcb = os.path.join(tmp, "tcb.par")
    with open(tcb, "w") as f:
        f.write(b_par.replace("UNITS TDB", "UNITS TCB"))
    conv = {"convert_parfile": run(
                "convert_parfile", convert_parfile.main,
                lambda t: [bpath, "-o", os.path.join(tmp, f"dd_{t}.par"),
                           "--binary", "DD"]),
            "t2binary2pint": run(
                "t2binary2pint", t2binary2pint.main,
                lambda t: [t2, os.path.join(tmp, f"native_{t}.par")]),
            "tcb2tdb": run(
                "tcb2tdb", tcb2tdb.main,
                lambda t: [tcb, os.path.join(tmp, f"tdb_{t}.par")]),
            "compare_parfiles": run(
                "compare_parfiles", compare_parfiles.main,
                lambda t: [bpath, os.path.join(tmp, f"dd_{t}.par")])}
    files = {"convert_parfile": "dd", "t2binary2pint": "native",
             "tcb2tdb": "tdb"}
    for name, txt in conv.items():
        same = txt["card"].replace("_card", "_cpu") == txt["cpu"]
        if name in files:
            with open(os.path.join(tmp, f"{files[name]}_card.par")) as f:
                a = f.read()
            with open(os.path.join(tmp, f"{files[name]}_cpu.par")) as f:
                same = same and a == f.read()
        out[name] = {"same": same}
        if not same:
            fail(f"{name}: the card's output differs from the CPU's")
    dd = get_model(os.path.join(tmp, "dd_card.par"), device=dev)
    native = get_model(os.path.join(tmp, "native_card.par"), device=dev)
    if "BinaryDD" not in dd.components or \
            "BinaryELL1" not in native.components:
        fail(f"converters: {list(dd.components)}, {list(native.components)}")
    on_card("converters", {"dd": dd.device, "native": native.device}, dev)
    out["seconds"] = secs
    print(f"scripts: {json.dumps(out)}")
    return out


def analysis_plane(fit_par: str, toas, dev) -> dict:
    """(c) the port's linter over the tree it runs from (exit 0, its rule
    and allowlist counts, its seconds); a Sanitizer around a params_only
    sweep of the fit cell on the card (one device-cache build); wrap
    flagging a numpy operand that enters a CUDA call, and a non-finite
    output."""
    import torch

    from pint_tpu_torch.analysis import Sanitizer, graftlint
    from pint_tpu_torch.analysis.allowlist import ALLOWLIST
    from pint_tpu_torch.analysis.sanitizer import SanitizerError
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals

    out = {}
    t0 = time.perf_counter()
    rc, text = capture_main(graftlint.main, [
        "--root", os.path.dirname(os.path.abspath(__file__)),
        "--format", "json"])
    lint_s = time.perf_counter() - t0
    summary = json.loads(text.splitlines()[-1])
    out["lint"] = {"rc": rc, "rules": len(graftlint.RULES),
                   "allowlist": len(ALLOWLIST),
                   "files": summary["files_scanned"],
                   "suppressed": summary["suppressed"], "seconds": lint_s}
    print(f"graftlint: {out['lint']}")
    if rc != 0 or not summary["clean"]:
        fail(f"graftlint over the tree: {text[-2000:]}")

    model = get_model(io.StringIO(fit_par), device=dev)
    with Sanitizer() as san:
        t0 = time.perf_counter()
        first = Residuals(toas, model).time_resids
        for delta in (1e-11, 2e-11, -1e-11):
            model.F0.add_delta(delta)
            model.invalidate_cache(params_only=True)
            last = Residuals(toas, model).time_resids
        sync(dev)
        sweep_s = time.perf_counter() - t0
    out["sanitizer"] = {"builds": san.compiles("phase"), "seconds": sweep_s,
                        "moved_s": float((last - first).abs().max())}
    on_card("sanitizer", {"first": first, "last": last}, dev)
    if san.compiles("phase") != 1 or not out["sanitizer"]["moved_s"] > 0:
        fail(f"sanitizer: {out['sanitizer']}")

    wrap = Sanitizer(nan_check=True)
    call = wrap.wrap(lambda x: torch.as_tensor(x, device=dev) * 2.0,
                     "upload")
    call(torch.ones(8, dtype=torch.float64, device=dev))
    clean = list(wrap.host_crossings)
    call(np.ones(8))
    try:
        wrap.wrap(lambda: torch.full((2,), float("nan"), device=dev),
                  "nan")()
        nan_raised = False
    except SanitizerError:
        nan_raised = True
    out["wrap"] = {"device_operand": clean, "numpy_operand":
                   wrap.host_crossings, "nan_raised": nan_raised}
    if clean or wrap.host_crossings != [("upload", 1)] or not nan_raised:
        fail(f"sanitizer wrap: {out['wrap']}")
    print(f"analysis: {json.dumps(out)}")
    return out


def cli_gui_phase(ctx: dict, dev) -> dict:
    """Phase 18: pintk, the scripts and the analysis plane on the card,
    (a)-(c), each fatal."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.runtime import reset_runtime

    reset_runtime()
    obs.reset()
    secs, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        par = os.path.join(tmp, "fit.par")
        tim = os.path.join(tmp, "fit.tim")
        t0 = time.perf_counter()
        with open(par, "w") as f:
            f.write(ctx["par"])
        write_toas_tim(ctx["toas"], tim)
        secs["write"] = time.perf_counter() - t0
        for name, fn, args in (
                ("pintk", pintk_session, (par, tim, dev)),
                ("scripts", scripts_on_card,
                 (par, tim, ctx["b_par"], ctx["seed"], dev, tmp)),
                ("analysis", analysis_plane,
                 (ctx["par"], ctx["toas"], dev))):
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out[name] = fn(*args)
            secs[name] = time.perf_counter() - t0
    out["clean"] = supervisor_clean("the CLIs and pintk")
    reset_runtime()
    obs.reset()
    print("cli-gui seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in secs.items()))
    out["seconds"] = secs
    return out


# Phase 19: the opt-in precision routes of the fit step on the fit cell.
# Each route is a build_fit_step flag set; "jac_f32-auto" leaves the Gram
# unset, so it follows the float32 Jacobian (the reference's coupling);
# "production" is the reference's TPU configuration.
PRECISION_ROUTES = (
    ("float64", {}),
    ("anchored", {"anchored": True}),
    ("jac_f32", {"jac_f32": True, "matmul_f32": False}),
    ("matmul_f32", {"matmul_f32": True}),
    ("jac_f32-auto", {"jac_f32": True}),
    ("production", {"anchored": True, "jac_f32": True, "matmul_f32": True}),
)
ROUTE_ENV = ("PINT_TPU_ANCHORED", "PINT_TPU_JAC", "PINT_TPU_GLS_MATMUL")
# a float64 route against the float64 step: the CPU tests' anchored limit
# (tests/test_torch_precision_routes.py); a float32 route: a sanity bound
# above the float32 Gram's measured 0.041 sigma on this cell (phase 16)
ROUTE_F64_SIGMA, ROUTE_F32_SIGMA = 1e-4, 0.1
ROUTE_F64_CHI2, ROUTE_F32_CHI2 = 1e-6, 1e-4
# the CPU twin, at the CPU tests' limits: anchored 1e-4 sigma, chi2 1e-6
# relative, residuals 1e-11 s; float32 routes 1e-2 sigma, chi2 1e-6
TWIN_NTOA, TWIN_NDMX = 400, 4
TWIN_F64_SIGMA, TWIN_F32_SIGMA, TWIN_CHI2, TWIN_RESID_S = \
    1e-4, 1e-2, 1e-6, 1e-11


def route_against(got, want, wide: bool) -> dict:
    """A route's step outputs `got` against the float64 step's `want`
    (numpy): the largest |d dparams| in sigma, the chi2 gap (absolute
    and relative) and the largest residual difference."""
    sig = np.sqrt(np.diag(want[1]))
    gap = float(got[2]) - float(want[2])
    return {"dp_sigma": float(np.max(np.abs(got[0] - want[0]) / sig)),
            "chi2_gap": gap, "chi2_rel": abs(gap) / abs(float(want[2])),
            "resid_s": float(np.max(np.abs(got[3] - want[3]))),
            "float32": wide}


def route_twin(flags: dict, twin: tuple) -> dict:
    """The route on the CPU twin (the fit cell at TWIN_NTOA TOAs) against
    the twin's float64 step, at the CPU tests' limits."""
    from pint_tpu_torch.parallel import build_fit_step

    model, toas, want = twin
    step, args, _ = build_fit_step(model, toas, device="cpu", **flags)
    got = [x.numpy() for x in step(*args)]
    wide = bool(flags.get("jac_f32") or flags.get("matmul_f32"))
    d = route_against(got, want, wide)
    lim = TWIN_F32_SIGMA if wide else TWIN_F64_SIGMA
    if not (d["dp_sigma"] <= lim and d["chi2_rel"] <= TWIN_CHI2 and
            (wide or d["resid_s"] <= TWIN_RESID_S)):
        fail(f"precision: the CPU twin's route {flags} is off its float64 "
             f"step: {d}")
    return d


def precision_route(name: str, flags: dict, ctx: dict, dev) -> dict:
    """One route on the fit cell on the card: its step against phase 6's
    float64 step, launches and busy ms of an eager step, the replay from
    a CUDA graph (bitwise its eager step), the dtype probe against
    graftflow's prediction, the CPU twin, and a DeviceDownhillGLSFitter
    fit against phase 6's float64 fit."""
    from pint_tpu_torch.analysis import Sanitizer, graftflow
    from pint_tpu_torch.gls import DeviceDownhillGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.fit_step import _build_fit_core

    out = {"flags": flags}
    t0 = time.perf_counter()
    step, _, args, names, meta = _build_fit_core(
        ctx["model"], ctx["toas"], device=dev, **flags)
    sync(dev)
    out["build_s"] = time.perf_counter() - t0
    out["resolved"] = {k: bool(meta[k]) for k in
                       ("anchored", "jac32", "f32mm")}
    step(*args)
    got = [x.cpu().numpy() for x in step(*args)]
    if names != ctx["names"] or not all(np.all(np.isfinite(x))
                                        for x in got):
        fail(f"precision {name}: the step is not finite or has other "
             f"parameters")
    wide = meta["jac32"] or meta["f32mm"]
    out["vs_float64"] = route_against(got, ctx["f64"], wide)
    d = out["vs_float64"]
    if d["dp_sigma"] > (ROUTE_F32_SIGMA if wide else ROUTE_F64_SIGMA) or \
            d["chi2_rel"] > (ROUTE_F32_CHI2 if wide else ROUTE_F64_CHI2):
        fail(f"precision {name}: the step is off the float64 step: {d}")
    out["busy"] = device_busy(lambda: step(*args), f"precision {name}")
    out["graph"] = graph_step_check(step, args, names,
                                    f"precision {name} graph-step", reps=5)
    san = Sanitizer()
    with san.dtype_probe():
        step(*args)
    observed = {k: sorted(v["dtypes"])
                for k, v in san.observed_profile().items()}
    predicted = graftflow.predict_profile(
        jac32=meta["jac32"], f32mm=meta["f32mm"],
        anchored=meta["anchored"], hybrid=False)
    for label, pred in predicted.items():
        obs = observed.get(label)
        if (obs is not None) != pred["active"] or \
                (pred["active"] and pred["dtype"] not in obs):
            fail(f"precision {name}: dtype probe {label} observed {obs}, "
                 f"graftflow predicts {pred}")
    if not set(observed) <= set(predicted):
        fail(f"precision {name}: unpredicted probes {observed}")
    out["dtype_probe"] = observed
    out["cpu_twin"] = route_twin(flags, ctx["twin"])
    ref = ctx["f64_fit"]
    m = get_model(io.StringIO(ctx["par"]), device=dev)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f = DeviceDownhillGLSFitter(ctx["toas"], m, **flags)
        chi2 = f.fit_toas()
    sync(dev)
    fit_s = time.perf_counter() - t0
    dist = max(abs(m.get_param(n).value - ref.model.get_param(n).value)
               / ref.errors[n] for n in ref.model.free_params)
    out["fit"] = {"seconds": fit_s, "chi2": chi2, "sigma_from_f64": dist,
                  "step_evals": f.step_evals, "converged": f.converged}
    if not (f.converged and dist <= (ROUTE_F32_SIGMA if wide else
                                     DP_SIGMA)):
        fail(f"precision {name}: the device fit is {dist:.3e} sigma from "
             f"phase 6's float64 fit")
    print(f"precision {name}: {out['resolved']}, build {out['build_s']:.3f}"
          f" s; vs float64 |d dparams| {d['dp_sigma']:.3e} sigma, chi2 gap "
          f"{d['chi2_gap']:.6e} ({d['chi2_rel']:.3e} relative), residuals "
          f"{d['resid_s']:.3e} s; {out['busy']['launches']} launches, busy "
          f"{out['busy']['busy_ms']} ms; replay "
          f"{out['graph']['replay_event_ms'][0]:.3f} ms (events), eager "
          f"{out['graph']['eager_host_ms'][0]:.3f} ms (host); CPU twin "
          f"{out['cpu_twin']['dp_sigma']:.3e} sigma; device fit "
          f"{fit_s:.3f} s, {f.step_evals} steps, {dist:.3e} sigma from "
          f"phase 6's fit; dtype probe {observed}")
    return out


def precision_phase(ctx: dict, dev) -> dict:
    """Phase 19: the precision routes on the fit cell, each fatal: torch's
    float32 matmul precision "highest" with TF32 off; the default step
    (every flag None, no environment) bitwise phase 6's step with the same
    launches; each route of PRECISION_ROUTES (precision_route); graftlint
    with G9 clean over the port."""
    import torch

    from pint_tpu_torch.analysis import graftlint
    from pint_tpu_torch.analysis import precision_registry as reg
    from pint_tpu_torch.parallel import build_fit_step

    t_phase = time.perf_counter()
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        fail("precision: float32 matmuls would use TF32")
    if any(os.environ.get(k) for k in ROUTE_ENV):
        fail(f"precision: a route's environment variable is set: "
             f"{[k for k in ROUTE_ENV if os.environ.get(k)]}")
    model, toas, step = ctx["model"], ctx["toas"], ctx["step"]
    f64 = [x.cpu().numpy() for x in step["step"](*step["args"])]
    dstep, dargs, dnames = build_fit_step(model, toas, device=dev)
    got = [x.cpu().numpy() for x in dstep(*dargs)]
    same = dnames == step["names"] and all(
        np.array_equal(a.view(np.int64), b.view(np.int64))
        for a, b in zip(got, f64))
    l6 = device_busy(lambda: step["step"](*step["args"]),
                     "precision: phase 6's step")["launches"]
    l19 = device_busy(lambda: dstep(*dargs),
                      "precision: the default step")["launches"]
    print(f"precision: the default step bitwise phase 6's: {same}; "
          f"launches {l19} (phase 6's {l6})")
    if not same or l6 != l19:
        fail("precision: the default step is not phase 6's float64 step")
    t0 = time.perf_counter()
    _, tw_model, tw_toas = fit_build(TWIN_NTOA, TWIN_NDMX, 1, "cpu")
    tstep, targs, _ = build_fit_step(tw_model, tw_toas, device="cpu")
    twin = (tw_model, tw_toas, [x.numpy() for x in tstep(*targs)])
    twin_s = time.perf_counter() - t0
    rctx = {"model": model, "toas": toas, "names": step["names"],
            "f64": f64, "twin": twin, "par": ctx["par"],
            "f64_fit": ctx["f64_fit"]}
    routes, secs = {}, {"twin_build": twin_s}
    for name, flags in PRECISION_ROUTES:
        t0 = time.perf_counter()
        routes[name] = precision_route(name, flags, rctx, dev)
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = graftlint.run_lint(
        os.path.dirname(os.path.abspath(__file__)), dynamic=False)
    g9 = [v for v, _ in report.suppressed if v.rule == "G9"]
    lint = {"clean": report.clean, "g9_sanctioned": len(g9),
            "registry_entries": len(reg.DEMOTIONS),
            "seconds": time.perf_counter() - t0}
    print(f"precision: graftlint with G9 {lint}")
    if not report.clean or len(g9) != sum(e.get("max_hits", 1)
                                          for e in reg.DEMOTIONS):
        fail("precision: graftlint with G9 is not clean over the port")
    secs["lint"] = lint["seconds"]
    secs["total"] = time.perf_counter() - t_phase
    print("precision seconds: " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in secs.items()))
    return {"default_bitwise": same, "default_launches": l19,
            "phase6_launches": l6, "routes": routes, "lint": lint,
            "seconds": secs}


# ---------------------------------------------- phase 20: the device mesh


MESH_SHARDS = (1, 3, 4, 8)   # (a): 1 bitwise, 3 pads N, 4 and 8 divide it
MESH_TIMED_SHARDS = (1, 8)   # (a) profiled, timed eager and graph-replayed
MESH_GRAPH_REPS = 5
MESH_WB_SHARDS = 4           # (b)
MESH_PTA_SHARDS = 4          # (c), (d)
# tests/test_sharded_fit_step.py's limits (tests/test_torch_mesh.py)
MESH_DP_RTOL, MESH_DP_ATOL, MESH_COV_RTOL, MESH_CHI2_REL = \
    1e-7, 1e-14, 1e-7, 1e-8
MESH_R_RTOL, MESH_R_ATOL = 1e-7, 1e-12
MESH_WB_SIGMA = 1e-7         # (b) dparams [sigma] of the float64 route
# tests/test_pta.py's, test_gwb.py's and test_serve.py's mesh limits
MESH_SOLVE_RTOL, MESH_SOLVE_ATOL, MESH_RDR_RTOL = 1e-9, 1e-18, 1e-10


def mesh_close(got, want, n: int, label: str) -> dict:
    """A sharded step's outputs (resids padded) against the unsharded
    step's at the MESH_* limits, fatal: the worst excess of each output
    over its tolerance (<= 1 passes) and the pad rows' largest |value|
    (exactly 0)."""
    def excess(a, b, rtol, atol):
        return float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))

    out = {"dp": excess(got[0], want[0], MESH_DP_RTOL, MESH_DP_ATOL),
           "cov": excess(got[1], want[1], MESH_COV_RTOL, 0.0),
           "chi2_rel": float(abs(got[2] / want[2] - 1.0)),
           "resid": excess(got[3][:n], want[3][:n], MESH_R_RTOL,
                           MESH_R_ATOL),
           "pad_rows": int(got[3].shape[0] - n),
           "pad_max_abs": float(np.max(np.abs(got[3][n:]), initial=0.0))}
    if out["dp"] > 1 or out["cov"] > 1 or out["resid"] > 1 or \
            out["chi2_rel"] > MESH_CHI2_REL or out["pad_max_abs"] != 0.0:
        fail(f"{label}: the sharded step is off the unsharded one: {out}")
    return out


def mesh_phase(ctx: dict, dev) -> dict:
    """Phase 20: the device mesh, each check fatal. One process drives a
    mesh of k blocks, all on `dev` (cuda:0; one card): (a) the fit cell's
    step sharded over k in MESH_SHARDS TOA blocks, k = 1 bitwise phase
    6's step with its launches, the rest within mesh_close's limits,
    launches, busy, eager and graph-replayed ms at MESH_TIMED_SHARDS;
    (b) config 3's wideband step over MESH_WB_SHARDS blocks against its
    unsharded step in sigma; (c) pta_solve and the GWB blocks of config 5
    over a MESH_PTA_SHARDS-block pulsar mesh against the one-device
    results; (d) a mesh ServeEngine on 4 fit requests against the local
    engine; (e) with more than one card, (a)'s step over every card."""
    import torch

    from pint_tpu_torch.parallel import build_sharded_fit_step, pta_solve, \
        stack_problems
    from pint_tpu_torch.pta import GWBLikelihood
    from pint_tpu_torch.pta.shard import Mesh
    from pint_tpu_torch.serve import FitStepRequest, ServeEngine

    t_phase = time.perf_counter()
    d0 = torch.device(dev)
    if d0.type == "cuda" and d0.index is None:
        d0 = torch.device("cuda", torch.cuda.current_device())

    def mesh(k, axis, devs=None):
        return Mesh(np.array(devs or [d0] * k), (axis,))

    def host(outs):
        return [x.cpu().numpy() for x in outs]

    secs = {}
    model, toas, step = ctx["model"], ctx["toas"], ctx["step"]
    n = toas.ntoas
    want = host(step["step"](*step["args"]))
    l6 = device_busy(lambda: step["step"](*step["args"]),
                     "mesh: phase 6's step")
    fit, kept = {}, {}
    for k in MESH_SHARDS:
        t0 = time.perf_counter()
        sup, dargs, names = build_sharded_fit_step(model, toas,
                                                   mesh(k, "toa"))
        build_s = time.perf_counter() - t0
        got = host(sup(*dargs))
        if names != step["names"]:
            fail(f"mesh-fit k={k}: parameter names differ")
        busy = {"launches": None, "busy_ms": None, "wall_ms": None}
        if k in MESH_TIMED_SHARDS:
            busy = device_busy(lambda: sup.step(*dargs), f"mesh-fit k={k}")
        if k == 1:
            same = all(np.array_equal(a.view(np.int64), b.view(np.int64))
                       for a, b in zip(got, want))
            if not same or busy["launches"] != l6["launches"]:
                fail(f"mesh-fit k=1: not phase 6's step bitwise with its "
                     f"launches (bitwise {same}, launches "
                     f"{busy['launches']} against {l6['launches']})")
            check = {"bitwise": same}
        else:
            check = mesh_close(got, want, n, f"mesh-fit k={k}")
        fit[k] = {**check, "launches": busy["launches"],
                  "busy_ms": busy["busy_ms"], "wall_ms": busy["wall_ms"],
                  "build_s": build_s}
        print(f"mesh-fit k={k}: {check}; launches {busy['launches']} "
              f"(unsharded {l6['launches']}); build {build_s:.3f} s")
        if k in MESH_TIMED_SHARDS:
            kept[k] = (sup, dargs, names)
    secs["fit"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    graph = {k: graph_step_check(kept[k][0].step, kept[k][1], kept[k][2],
                                 f"mesh graph-step k={k}",
                                 reps=MESH_GRAPH_REPS)
             for k in MESH_TIMED_SHARDS}
    kept.clear()
    secs["graph"] = time.perf_counter() - t0

    # (b) config 3's wideband step over MESH_WB_SHARDS blocks
    t0 = time.perf_counter()
    w_model, w_toas, w_step = ctx["w_model"], ctx["w_toas"], ctx["w_step"]
    w_want = host(w_step["step"](*w_step["args"]))
    sup, dargs, _ = build_sharded_fit_step(
        w_model, w_toas, mesh(MESH_WB_SHARDS, "toa"), wideband=True)
    w_got = host(sup(*dargs))
    sig = np.sqrt(np.diag(w_want[1]))
    wb = {"dp_sigma": float(np.max(np.abs(w_got[0] - w_want[0]) / sig)),
          "chi2_rel": float(abs(w_got[2] / w_want[2] - 1.0)),
          "resid_s": float(np.max(np.abs(w_got[3][:w_toas.ntoas]
                                         - w_want[3]))),
          "pad_rows": int(w_got[3].shape[0] - w_toas.ntoas)}
    print(f"mesh-wideband: config 3 over {MESH_WB_SHARDS} blocks: {wb}")
    if wb["dp_sigma"] > MESH_WB_SIGMA or wb["chi2_rel"] > MESH_CHI2_REL \
            or wb["resid_s"] > MESH_R_ATOL:
        fail(f"mesh-wideband: off the unsharded step: {wb}")
    secs["wideband"] = time.perf_counter() - t0

    # (c) config 5's batch solve and GWB blocks over a pulsar mesh
    t0 = time.perf_counter()
    problems = ctx["array"]["problems"]
    pmesh = mesh(MESH_PTA_SHARDS, "pulsar")
    st = stack_problems(problems)
    plain, sharded = pta_solve(st, device=dev), pta_solve(st, mesh=pmesh)

    def rel(a, b, rtol, atol=0.0):
        return float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))

    solve = [rel(a, b, MESH_SOLVE_RTOL, MESH_SOLVE_ATOL)
             for a, b in zip(sharded, plain)]
    kw = dict(problems=problems, positions=ctx["array"]["positions"],
              nfreq=ctx["nfreq"])
    b0 = GWBLikelihood(device=dev, **kw).build_blocks()
    b1 = GWBLikelihood(mesh=pmesh, **kw).build_blocks()
    blocks = [rel(b1[0], b0[0], MESH_SOLVE_RTOL, MESH_SOLVE_ATOL),
              rel(b1[1], b0[1], MESH_SOLVE_RTOL, MESH_SOLVE_ATOL),
              rel(b1[2], b0[2], MESH_RDR_RTOL),
              rel(b1[3], b0[3], MESH_RDR_RTOL)]
    pta = {"npulsars": len(problems), "solve_excess": solve,
           "gwb_excess": blocks}
    print(f"mesh-pta: {len(problems)} pulsars over {MESH_PTA_SHARDS} "
          f"blocks, worst excess over the limits: solve {max(solve):.3g}, "
          f"GWB blocks {max(blocks):.3g}")
    if max(solve) > 1 or max(blocks) > 1:
        fail(f"mesh-pta: off the one-device results: {pta}")
    secs["pta"] = time.perf_counter() - t0

    # (d) a mesh engine against the local engine on 4 fit requests
    t0 = time.perf_counter()
    res = {}
    for label, kw in (("local", {"device": dev}), ("mesh", {"mesh": pmesh})):
        eng = ServeEngine(**kw)
        futs = [eng.submit(FitStepRequest(problem=pr))
                for pr in problems[:4]]
        eng.flush()
        res[label] = ([f.result(timeout=0) for f in futs],
                      list(eng.metrics.buckets))
    serve = {"dparams_excess": max(
        rel(b.dparams, a.dparams, MESH_SOLVE_RTOL, MESH_SOLVE_ATOL)
        for a, b in zip(res["local"][0], res["mesh"][0])),
        "chi2_rel": max(abs(b.chi2 / a.chi2 - 1.0) for a, b in
                        zip(res["local"][0], res["mesh"][0])),
        "mesh_batches": [k[-1] for k in res["mesh"][1]]}
    print(f"mesh-serve: {serve}")
    if serve["dparams_excess"] > 1 or serve["chi2_rel"] > MESH_SOLVE_RTOL \
            or any(b % MESH_PTA_SHARDS for b in serve["mesh_batches"]):
        fail(f"mesh-serve: the mesh engine is off the local one: {serve}")
    secs["serve"] = time.perf_counter() - t0

    # (e) the step over every card
    ncard = torch.cuda.device_count() if d0.type == "cuda" else 0
    cards = {"cards": ncard}
    if ncard > 1:
        sup, dargs, _ = build_sharded_fit_step(
            model, toas, mesh(ncard, "toa",
                              [torch.device("cuda", i) for i in range(ncard)]))
        cards.update(mesh_close(host(sup(*dargs)), want, n,
                                f"mesh-cards ({ncard} cards)"))
        print(f"mesh-cards: the fit cell's step over {ncard} cards: {cards}")
    else:
        print(f"mesh-cards: {ncard} card(s): cross-GPU placement not "
              "exercised")
    secs["total"] = time.perf_counter() - t_phase
    print("mesh seconds: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in secs.items()))
    return {"fit": fit, "unsharded_launches": l6["launches"],
            "unsharded_busy_ms": l6["busy_ms"], "graph": graph,
            "wideband": wb, "pta": pta, "serve": serve, "cards": cards,
            "seconds": secs}


def fmt(t: dict) -> str:
    return (f"{t['median']:.4f} ms median of 20 (min {t['min']:.4f}, "
            f"max {t['max']:.4f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=4_194_304,
                    help="photons of the kernel checks and timings "
                         "(default 4,194,304)")
    ap.add_argument("--path-n", type=int, default=1_048_576,
                    help="photons on the photonphase path (default "
                         "1,048,576)")
    ap.add_argument("--fit-ntoa", type=int, default=10_000,
                    help="TOAs of the fit path (default 10,000)")
    ap.add_argument("--fit-ndmx", type=int, default=28,
                    help="free DMX windows of the fit path (default 28)")
    ap.add_argument("--stream-ntoa", type=int, default=200_000,
                    help="TOAs of the streaming GLS phase (default "
                         "200,000, Fitter.auto's streaming threshold; "
                         "below it the phase asks for streaming=True)")
    ap.add_argument("--pta-ntoa", type=int, default=100,
                    help="TOAs of each pulsar of the array (default 100, "
                         "bench_pta.py's)")
    ap.add_argument("--pta-nfreq", type=int, default=14,
                    help="GWB frequencies (default 14, the NANOGrav "
                         "15-year common process's)")
    ap.add_argument("--m", type=int, default=20, help="harmonics")
    ap.add_argument("--baseline-src", default=None,
                    help="also time a kernel built from this .cu source "
                         "with the earlier float32-only interface")
    ap.add_argument("--sticky-child", default=None, metavar="DIR",
                    help="(internal) the runtime phase's child process: "
                         "fit the cell in DIR through a real device-side "
                         "assert")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    if args.sticky_child:
        # the child's CUDA context is lost by design: leave without the
        # interpreter's teardown touching it
        rc = sticky_child(args.sticky_child)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    from pint_tpu_torch.ops import z2_harmonics as zmod

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # the compile ledger persists across the phases' obs resets, so
    # phase 16 reads every dispatch key of the run (and a child process
    # appends its own)
    ledger_dir = tempfile.TemporaryDirectory()
    os.environ.setdefault("PINT_TPU_COMPILE_LEDGER", os.path.join(
        ledger_dir.name, "compile_ledger.jsonl"))

    t0 = time.perf_counter()
    zmod.build()
    print(f"build: z2_harmonics.cu compiled in "
          f"{time.perf_counter() - t0:.2f} s")
    kc_main = zmod._plan(zmod._load(), dev.index or 0, args.m)[0]
    regs = phase_registers(zmod, kc_main)

    kern = phase_kernel(zmod, dev, args.n, args.m, args.seed)
    cols = event_columns(args.path_n, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        par = os.path.join(tmp, "j0030.par")
        with open(par, "w") as f:
            f.write(PAR)
        cold_s = phase_exact(dev, cols, par, tmp)
        path = phase_path(zmod, dev, cols, par, args.m, tmp)

        # the GLS fit path
        t0 = time.perf_counter()
        fit_par_text, model, toas = fit_build(args.fit_ntoa, args.fit_ndmx,
                                              1, dev)
        build_s = time.perf_counter() - t0
        dense_q = sum(n for _, n in
                      model.noise_model_dimensions(toas).values())
        seg = model.noise_model_ecorr_segments(toas)
        step = fit_step_check(model, toas, dev)
        print(f"fit-build: {build_s:.3f} s on the host (model, simulated "
              f"TOAs on {dev}); N = {toas.ntoas}, p = {len(step['names'])}"
              f" (Offset + {len(model.free_params)} free), q = "
              f"{step['args'][6].shape[1]} Fourier columns, nseg = "
              f"{len(seg[1])} ({len(seg[1]) - 1} ECORR epochs + the "
              f"'no epoch' slot); the fitters' dense noise basis has "
              f"{dense_q} columns")
        ftime = fit_time(step["step"], step["args"], "step")
        hytime = fit_time(step["hy_step"], step["hy_args"], "hybrid step")
        downhill = fit_downhill(fit_par_text, toas, dev)
        tempo = fit_pintempo(tmp)
    fit_phases_s = time.perf_counter() - t0
    clean = {"photon_and_fit": supervisor_clean("the photon and fit paths")}

    # the binary path: BASELINE config 2 (ELL1), its DD twin, the zoo of
    # every binary model and config 4's dense full-covariance solve
    t0 = time.perf_counter()
    b_par, b_model, b_toas = b1855_build(B1855_NTOA, B1855_NDMX, dev)
    b_build_s = time.perf_counter() - t0
    print(f"binary-build: {b_build_s:.3f} s on the host (model, simulated "
          f"TOAs on {dev}); N = {b_toas.ntoas}, {len(b_model.free_params)} "
          f"free parameters")
    t1 = time.perf_counter()
    b_step = fit_step_check(b_model, b_toas, dev, "binary-step",
                            explain_chi2=True)
    b_time = fit_time(b_step["step"], b_step["args"], "binary step")
    b_hytime = fit_time(b_step["hy_step"], b_step["hy_args"],
                        "binary hybrid step")
    from pint_tpu_torch.models import get_model

    dd_par = dd_twin(b_par)
    dd_model = get_model(io.StringIO(dd_par), device=dev)
    dd_model.OM.frozen = True   # T0 and OM are degenerate at e ~ 2e-5
    dd_step = fit_step_check(dd_model, b_toas, dev, "binary-step (DD twin)",
                             hybrid=False, explain_chi2=True)
    dd_time = fit_time(dd_step["step"], dd_step["args"], "binary DD step")
    b_step_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    b_downhill = binary_downhill(b_par, b_toas, b_step["sigma"], dev)
    b_downhill_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    zoo = binary_zoo(ZOO_NTOA, dev)
    zoo_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    full = fullcov(dev)
    full_s = time.perf_counter() - t1
    binary_phases_s = time.perf_counter() - t0
    clean["binary"] = supervisor_clean("the binary path")
    print(f"binary path seconds: build {b_build_s:.3f}, step checks and "
          f"timings {b_step_s:.3f}, downhill {b_downhill_s:.3f}, zoo "
          f"{zoo_s:.3f}, fullcov {full_s:.3f}; total {binary_phases_s:.3f} "
          f"(fit path {fit_phases_s:.3f})")

    # the wideband path: BASELINE config 3 and the twin of the fit path
    t0 = time.perf_counter()
    from pint_tpu_torch.wideband_fitter import WidebandDownhillFitter

    w_par, w_model, w_toas = config3_build(CONFIG3_NTOA, CONFIG3_NDMX, dev)
    w_build_s = time.perf_counter() - t0
    print(f"wideband-config3 build: {w_build_s:.3f} s on the host; N = "
          f"{w_toas.ntoas} TOAs + {w_toas.ntoas} DM measurements, "
          f"{len(w_model.free_params)} free parameters")
    w_step = fit_step_check(w_model, w_toas, dev, "wideband-config3 step",
                            explain_chi2=True, wideband=True)
    w_time = fit_time(w_step["step"], w_step["args"], "wideband config-3 step")
    # the fit as a user runs it: the par and the .tim (its -pp_dm/-pp_dme
    # flags) read by get_model_and_toas, the fitter Fitter.auto's
    with tempfile.TemporaryDirectory() as tmp:
        w_par_path = os.path.join(tmp, "config3.par")
        w_tim_path = os.path.join(tmp, "config3.tim")
        with open(w_par_path, "w") as f:
            f.write(w_model.as_parfile())
        write_toas_tim(w_toas, w_tim_path)
        w_downhill = fit_downhill(w_par_path, None, dev,
                                  "wideband-config3 downhill",
                                  fitter=WidebandDownhillFitter,
                                  tim=w_tim_path)
        c3_16 = config3_decisions(w_model, w_toas, dev, tmp)
    w_downhill.pop("fitter")
    w_downhill.pop("cpu_fitter")
    w3_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, tw_model, tw_toas = wideband_twin_build(args.fit_ntoa, args.fit_ndmx,
                                               dev)
    tw_build_s = time.perf_counter() - t0
    tw_seg = tw_model.noise_model_ecorr_segments(tw_toas)
    print(f"wideband-twin build: {tw_build_s:.3f} s on the host; N = "
          f"{tw_toas.ntoas} TOAs + {tw_toas.ntoas} DM measurements, "
          f"{len(tw_model.free_params)} free parameters, nseg = "
          f"{len(tw_seg[1])}, noise columns "
          f"{tw_model.noise_model_dimensions(tw_toas)}")
    tw_step = fit_step_check(tw_model, tw_toas, dev, "wideband-twin step",
                             hybrid=False, explain_chi2=True, wideband=True)
    tw_time = fit_time(tw_step["step"], tw_step["args"], "wideband twin step")
    tw_s = time.perf_counter() - t0
    ddsum = dd_sum_check(dev)
    clean["wideband"] = supervisor_clean("the wideband path")
    print(f"wideband path seconds: config 3 {w3_s:.3f} (downhill "
          f"{w_downhill['gpu_s']:.3f} GPU, {w_downhill['iterations']} "
          f"iterations), twin {tw_s:.3f}")

    # the device downhill fit, CUDA-graph replay of the step, and the
    # matrix-free streaming GLS
    secs = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        nu_inf = nu_inf_check(dev, tmp)
    secs["nu_inf"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_model, s_toas, s_truth = stress_build(STRESS_NTOA, STRESS_NDMX, dev)
    secs["stress_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stress_keep: dict = {}
    dfit = device_fit_check(s_model, s_toas, s_truth, dev, "device-fit",
                            keep=stress_keep)
    secs["device_fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sw_model, sw_toas, sw_truth = stress_build(STRESS_NTOA, STRESS_NDMX, dev,
                                               dm_noise=False)
    attach_wideband_dm(sw_model, sw_toas)
    dfit_wb = device_fit_check(sw_model, sw_toas, sw_truth, dev,
                               "device-fit-wideband", wideband=True)
    secs["device_fit_wideband"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = {"fit": graph_step_check(step["step"], step["args"],
                                     step["names"], "graph-step, fit cell"),
             "config3": graph_step_check(w_step["step"], w_step["args"],
                                         w_step["names"],
                                         "graph-step, config 3")}
    secs["graph_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = [x.cpu().numpy() for x in step["step"](*step["args"])]
    secorr = stream_ecorr_check(model, toas, dense, dev)
    secs["stream_ecorr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream_keep: dict = {}
    stream = stream_check(args.stream_ntoa, dev, keep=stream_keep)
    secs["stream"] = time.perf_counter() - t0
    print("device-fit and streaming seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()))
    clean["device_fit_streaming"] = supervisor_clean(
        "the device fit and streaming")

    # the pulsar array: BASELINE config 5, its GWB likelihood and its
    # per-pulsar posteriors
    array: dict = {}
    pta = pta_phase(args.pta_ntoa, args.pta_nfreq, dev, keep=array)
    clean["pta"] = supervisor_clean("the pulsar array")

    # the rest of the model zoo
    zoo_s = {}
    t0 = time.perf_counter()
    zm_par, zm_model, zm_toas = zoo_msp_build(ZOO_MSP_NTOA, dev)
    zm = zoo_fit_phase("zoo-msp", zm_par, zm_model, zm_toas, dev,
                       ZOO_MSP_OFFSET, time.perf_counter() - t0)
    zoo_s["msp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zwb = zoo_wideband_phase(dev)
    zoo_s["msp_wb"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zy_par, zy_model, zy_toas = zoo_young_build(ZOO_YOUNG_NTOA, dev)
    zy = zoo_fit_phase("zoo-young", zy_par, zy_model, zy_toas, dev,
                       ZOO_YOUNG_OFFSET, time.perf_counter() - t0)
    zoo_s["young"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zph = zoo_photon_phase(zmod, dev, args.path_n, args.m, args.seed + 5,
                           path["h"])
    zoo_s["photon"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zsw = zoo_sweep(ZOO_NTOA, dev)
    zoo_s["sweep"] = time.perf_counter() - t0
    print("zoo seconds: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in zoo_s.items()))
    clean["zoo"] = supervisor_clean("the model zoo")

    # the Bayesian path on the fit cell
    t0 = time.perf_counter()
    bayes_keep: dict = {}
    bayes = bayes_phase(zmod, fit_par_text, toas, step, dev, keep=bayes_keep)
    bayes["seconds"]["total"] = time.perf_counter() - t0
    clean["bayes"] = supervisor_clean("the Bayesian path")

    # photon sampling on the photon path's events, and the TOA cache
    t0 = time.perf_counter()
    photon = photon_sampling_phase(zmod, args.path_n, args.m, args.seed,
                                   dev)
    photon["seconds"]["total"] = time.perf_counter() - t0
    clean["photon_sampling"] = supervisor_clean("photon sampling")

    # the dispatch runtime: (a)-(f) on the fit cell, the deadlines and the
    # solve crossover (after every earlier phase: (g) reads their counters)
    t0 = time.perf_counter()
    runtime = runtime_phase(
        fit_par_text, toas, downhill, step, array, args.pta_nfreq,
        {"chain_step": bayes["time"]["supervision"],
         "half_ensemble": photon["batch"]["supervision"]}, dev)
    runtime["clean"] = clean
    runtime["seconds"]["total"] = time.perf_counter() - t0

    # the host API of the core classes, polycos, UNITS TCB, binaryconvert
    # and the native MJD parser (phase 15)
    k1_before = zmod.launches
    host_api = host_api_phase(fit_par_text, toas, b_par, b_toas, args.seed,
                              dev)
    host_api["counts"]["k1_launches"] = zmod.launches - k1_before

    # timings at the main path's shape: float32 inputs (the TPU kernel's
    # contract) and float64 inputs (what the H-test hands the kernel)
    n, m = args.n, args.m
    rng = np.random.default_rng(args.seed + 2)
    ph64 = torch.as_tensor(rng.uniform(size=n), dtype=torch.float64,
                           device=dev)
    w64 = torch.as_tensor(rng.uniform(size=n), dtype=torch.float64,
                          device=dev)
    ph32, w32 = ph64.float(), w64.float()
    tiny = torch.zeros(1000, dtype=torch.float32, device=dev)
    k32 = cuda_ms(lambda: zmod.z2_harmonics(ph32, w32, m))
    k64 = cuda_ms(lambda: zmod.z2_harmonics(ph64, w64, m))
    # the perf plane's roofline of K1 at this shape (its launches just
    # registered their analytic cost), for phase 16 (f)
    from pint_tpu_torch.obs import perf

    k1_roof = {"ms": k64["median"], "entry": perf.get_ledger().get(
        "z2_harmonics"), "block": perf.roofline_block(
        "z2_harmonics", k64["median"] / 1e3)}
    casts = cuda_ms(lambda: (ph64.to(torch.float32), w64.to(torch.float32)))
    plain = cuda_ms(lambda: zmod.z2_harmonics_plain(ph32, w32, m))
    floor = cuda_ms(lambda: tiny.add_(1.0))
    earlier = None
    if args.baseline_src:
        base = baseline_kernel(zmod, args.baseline_src)
        check_close("earlier design", base(ph32, w32, m),
                    zmod.z2_harmonics_plain(ph64, w64, m), n)
        earlier = cuda_ms(lambda: base(ph32, w32, m))
    b32, by32, bytes32, ops = bound(n, m, 8)
    b64, by64, bytes64, _ = bound(n, m, 16)
    st = path["stages"]
    copy_ms = h2d_ms(args.path_n * BATCH_BYTES_PER_PHOTON)
    print(f"kernel z2_harmonics, float32 inputs: {fmt(k32)} (N={n}, m={m}); "
          f"bound {b32 * 1e3:.2f} us set by {by32} ({bytes32} B at "
          f"3.35 TB/s, {ops} ops at 67 TF/s), {b32 / k32['median']:.1%} "
          "of it")
    print(f"kernel z2_harmonics, float64 inputs: {fmt(k64)}; bound "
          f"{b64 * 1e3:.2f} us set by {by64} ({bytes64} B), "
          f"{b64 / k64['median']:.1%} of it")
    print(f"the two .to(torch.float32) casts the float64 read saves: "
          f"{fmt(casts)}")
    print(f"plain float32 version: {fmt(plain)}")
    print(f"timing floor (a 1,000-element add_ between the same events): "
          f"{fmt(floor)}")
    if earlier:
        print(f"earlier design ({args.baseline_src}), float32 inputs: "
              f"{fmt(earlier)}")
    print(f"stages: host ingest {st['ingest']:.3f} s, host->device "
          f"(batch packing + copy) {st['batch'] * 1e3:.2f} ms, device "
          f"phase {st['phase'] * 1e3:.2f} ms, H-test "
          f"{st['htest'] * 1e3:.2f} ms, total {st['total']:.3f} s")
    print(f"host->device copy alone: {copy_ms:.2f} ms for "
          f"{args.path_n * BATCH_BYTES_PER_PHOTON} B; first (cold) GPU phase "
          f"on 65,536 photons {cold_s * 1e3:.2f} ms")
    km = path["kernels_ms"]
    # the profile's K1 entry against K1 between CUDA events at the path's
    # shape (float64 inputs, --path-n photons; L2 flushed, so not faster)
    pn = args.path_n
    k_path = cuda_ms(lambda: zmod.z2_harmonics(ph64[:pn], w64[:pn], m))
    k1_entry = sum(v for k, v in km.items() if "z2_kernel" in k) \
        / max(1, path["launches"])
    # phase 16: the health, perf and SLO planes and TOA padding
    k1_roof["share_phase5"] = b64 / k64["median"]
    t0 = time.perf_counter()
    health_perf = health_perf_phase(
        {"par": fit_par_text, "model": model, "toas": toas, "step": step,
         "gpu_ref": fit_state(downhill["fitter"]), "stress": stress_keep,
         "stress_toas": s_toas, "stream": stream_keep, "bayes": bayes_keep,
         "k1": k1_roof}, dev)
    health_perf["seconds"]["total"] = time.perf_counter() - t0
    # phase 17: serving on the card at full width (K1 launches 0 times)
    k1_before = zmod.launches
    t0 = time.perf_counter()
    serve = serve_phase(
        {"par": fit_par_text, "model": model, "toas": toas,
         "stress": s_model, "stress_toas": s_toas, "b_par": b_par,
         "array": array, "nfreq": args.pta_nfreq, "seed": args.seed}, dev)
    serve["seconds"]["total"] = time.perf_counter() - t0
    serve["k1_launches"] = zmod.launches - k1_before
    if serve["k1_launches"]:
        fail(f"serve: K1 launched {serve['k1_launches']} times on a path "
             "that runs no H-test")
    # phase 18: pintk, the scripts and the analysis plane on the card
    # (K1 launches 0 times: no script or pintk action runs an H-test)
    k1_before = zmod.launches
    t0 = time.perf_counter()
    cli_gui = cli_gui_phase({"par": fit_par_text, "toas": toas,
                             "b_par": b_par, "seed": args.seed}, dev)
    cli_gui["seconds"]["total"] = time.perf_counter() - t0
    cli_gui["k1_launches"] = zmod.launches - k1_before
    print(f"cli-gui: {cli_gui['seconds']['total']:.3f} s, K1 launches "
          f"{cli_gui['k1_launches']}")
    if cli_gui["k1_launches"]:
        fail(f"cli-gui: K1 launched {cli_gui['k1_launches']} times on a "
             "path that runs no H-test")
    # phase 19: the opt-in precision routes on the fit cell (K1 launches
    # 0 times: the routes run on the fit path)
    k1_before = zmod.launches
    precision = precision_phase(
        {"par": fit_par_text, "model": model, "toas": toas, "step": step,
         "f64_fit": downhill["fitter"]}, dev)
    precision["k1_launches"] = zmod.launches - k1_before
    print(f"precision: {precision['seconds']['total']:.3f} s, K1 launches "
          f"{precision['k1_launches']}")
    if precision["k1_launches"]:
        fail(f"precision: K1 launched {precision['k1_launches']} times on "
             "a path that runs no H-test")
    # phase 20: the device mesh (K1 launches 0 times: the mesh runs the
    # fit, pulsar-array and serve paths)
    k1_before = zmod.launches
    mesh = mesh_phase(
        {"model": model, "toas": toas, "step": step, "w_model": w_model,
         "w_toas": w_toas, "w_step": w_step, "array": array,
         "nfreq": args.pta_nfreq}, dev)
    mesh["k1_launches"] = zmod.launches - k1_before
    if mesh["k1_launches"]:
        fail(f"mesh: K1 launched {mesh['k1_launches']} times on a path "
             "that runs no H-test")
    print(f"profile check: K1's entry {k1_entry:.4f} ms a launch in the "
          f"path's profile, K1 between events at its shape "
          f"{k_path['median']:.4f} ms")
    window_ms = (st["batch"] + st["phase"] + st["htest"]) * 1e3
    if km:
        busy = sum(km.values())
        print(f"device busy during the path (torch.profiler): {busy:.2f} ms "
              f"of the {window_ms:.2f} ms device stages (idle share "
              f"{1 - busy / window_ms:.4f}) and of {st['total']:.3f} s in "
              f"all (idle share {1 - busy / (st['total'] * 1e3):.6f})")
        for name, ms in sorted(km.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:9.3f} ms  {name[:100]}")
    else:
        print("device busy during the path: not measured (the profiler "
              "recorded no device time)")
    print(f"fit path: build {build_s:.3f} s, step "
          f"{ftime['host_ms'][0]:.3f} ms (host) / {ftime['event_ms'][0]:.3f}"
          f" ms (events), {ftime['launches_per_step']:.0f} launches a step "
          f"(hybrid step {hytime['host_ms'][0]:.3f} ms / "
          f"{hytime['event_ms'][0]:.3f} ms, "
          f"{hytime['launches_per_step']:.0f} launches), "
          f"downhill {downhill['iterations']} iterations in "
          f"{downhill['gpu_s']:.3f} s (CPU {downhill['cpu_s']:.3f} s), "
          f"pintempo {tempo['wall_s']:.3f} s")
    print(json.dumps({"fit_path": {
        "ntoa": toas.ntoas, "build_s": build_s,
        "step_host_ms": ftime["host_ms"], "step_event_ms": ftime["event_ms"],
        "launches_per_step": ftime["launches_per_step"],
        "busy_share": ftime["busy_share"], "stages_ms": ftime["stages_ms"],
        "stage_spans_ms": ftime["stage_spans_ms"],
        "cpu_step_ms": step["cpu_step_ms"],
        "top_ops_ms": ftime["top_ops_ms"],
        "hybrid": {k: hytime[k] for k in (
            "host_ms", "event_ms", "launches_per_step", "busy_share",
            "stages_ms", "stage_spans_ms")},
        "gpu_vs_cpu": {k: step[k] for k in (
            "dp_sigma", "cov_rel", "chi2_rel", "resid_s")},
        "hybrid_vs_step": step["hybrid_vs_step"],
        "downhill": {k: v for k, v in downhill.items()
                     if k not in ("fitter", "cpu_fitter")},
        "pintempo": tempo}}))
    print(f"binary path: N = {b_toas.ntoas}, step "
          f"{b_time['host_ms'][0]:.3f} ms (host) / "
          f"{b_time['event_ms'][0]:.3f} ms (events), "
          f"{b_time['launches_per_step']:.0f} launches a step; DD twin "
          f"{dd_time['host_ms'][0]:.3f} ms / {dd_time['event_ms'][0]:.3f} ms, "
          f"{dd_time['launches_per_step']:.0f} launches; downhill "
          f"{b_downhill['iterations']} iterations in "
          f"{b_downhill['gpu_s']:.3f} s (CPU {b_downhill['cpu_s']:.3f} s)")
    timing_keys = ("host_ms", "event_ms", "launches_per_step", "busy_share",
                   "stages_ms", "stage_spans_ms")
    check_keys = ("dp_sigma", "cov_rel", "chi2_rel", "chi2_moved_by_resids",
                  "chi2_rel_unexplained", "resid_s")
    print(json.dumps({"binary_path": {
        "ntoa": b_toas.ntoas, "build_s": b_build_s,
        "step_host_ms": b_time["host_ms"],
        "step_event_ms": b_time["event_ms"],
        "launches_per_step": b_time["launches_per_step"],
        "busy_share": b_time["busy_share"], "stages_ms": b_time["stages_ms"],
        "stage_spans_ms": b_time["stage_spans_ms"],
        "cpu_step_ms": b_step["cpu_step_ms"],
        "top_ops_ms": b_time["top_ops_ms"],
        "hybrid": {k: b_hytime[k] for k in timing_keys},
        "dd_twin": {**{k: dd_time[k] for k in timing_keys},
                    "gpu_vs_cpu": {k: dd_step[k] for k in check_keys}},
        "gpu_vs_cpu": {k: b_step[k] for k in check_keys},
        "hybrid_vs_step": b_step["hybrid_vs_step"],
        "downhill": b_downhill, "zoo": zoo, "fullcov": full,
        "seconds": {"build": b_build_s, "steps": b_step_s,
                    "downhill": b_downhill_s, "zoo": zoo_s,
                    "fullcov": full_s, "total": binary_phases_s}}}))
    print(f"wideband path: config 3 step {w_time['host_ms'][0]:.3f} ms "
          f"(host) / {w_time['event_ms'][0]:.3f} ms (events), "
          f"{w_time['launches_per_step']:.0f} launches a step; twin "
          f"{tw_time['host_ms'][0]:.3f} ms / {tw_time['event_ms'][0]:.3f} ms, "
          f"{tw_time['launches_per_step']:.0f} launches; config-3 downhill "
          f"{w_downhill['iterations']} iterations in {w_downhill['gpu_s']:.3f}"
          f" s (CPU {w_downhill['cpu_s']:.3f} s)")

    def wb_cell(ntoa, build_s, tm, st, secs):
        return {"ntoa": ntoa, "build_s": build_s,
                "step_host_ms": tm["host_ms"], "step_event_ms": tm["event_ms"],
                "launches_per_step": tm["launches_per_step"],
                "busy_share": tm["busy_share"], "stages_ms": tm["stages_ms"],
                "stage_spans_ms": tm["stage_spans_ms"],
                "top_ops_ms": tm["top_ops_ms"],
                "cpu_step_ms": st["cpu_step_ms"],
                "gpu_vs_cpu": {k: st[k] for k in check_keys},
                "seconds": secs}

    print(json.dumps({"wideband_path": {
        "config3": {**wb_cell(w_toas.ntoas, w_build_s, w_time, w_step, w3_s),
                    "hybrid_vs_step": w_step["hybrid_vs_step"],
                    "downhill": w_downhill},
        "twin": wb_cell(tw_toas.ntoas, tw_build_s, tw_time, tw_step, tw_s),
        "dd_sum": ddsum, "config3_16_digit": c3_16}}))
    print(json.dumps({"nu_inf": nu_inf}))
    print(json.dumps({"device_fit": {"stress": dfit,
                                     "stress_wideband": dfit_wb,
                                     "seconds": secs}}))
    print(json.dumps({"graph_step": graph}))
    print(json.dumps({"streaming": stream}))
    print(json.dumps({"stream_ecorr": secorr}))
    print(json.dumps({"pta": pta}))
    print(json.dumps({"zoo_msp": {**zm, "seconds": zoo_s["msp"]}}))
    print(json.dumps({"zoo_msp_wb": {**zwb, "seconds": zoo_s["msp_wb"]}}))
    print(json.dumps({"zoo_young": {**zy, "seconds": zoo_s["young"]}}))
    print(json.dumps({"zoo_photon": {**zph, "seconds": zoo_s["photon"]}}))
    print(json.dumps({"zoo_sweep": {**zsw, "seconds": zoo_s["sweep"]}}))
    print(json.dumps({"bayes": bayes}))
    print(json.dumps({"photon_sampling": photon}))
    print(json.dumps({"runtime": runtime}, default=str))
    print(json.dumps({"host_api": host_api}))
    print(json.dumps({"health_perf": health_perf}, default=str))
    print(json.dumps({"serve": serve}, default=str))
    print(json.dumps({"cli_gui": cli_gui}, default=str))
    print(json.dumps({"precision": precision}, default=str))
    print(json.dumps({"mesh": mesh}, default=str))
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    # a serve dispatch's deferred cost probe may still be writing the
    # compile ledger: let it finish before its directory goes
    from pint_tpu_torch.obs import perf as obs_perf

    obs_perf.join_cost_probes()
    ledger_dir.cleanup()
    print(card())
    print(json.dumps({"kernels": [{
        "name": "z2_harmonics", "route": "cuda",
        "source": "pint_tpu_torch/csrc/z2_harmonics.cu",
        "replaces": "pint_tpu/ops/pallas_kernels.py:81",
        "launches": path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": k32["median"], "plain_ms": plain["median"], "bound_ms": b32,
        "bound_by": by32, "library_ms": None,
        "ms_f64_in": k64["median"], "bound_ms_f64_in": b64,
        "bound_by_f64_in": by64, "ms_min_max": [k32["min"], k32["max"]],
        "ms_f64_in_min_max": [k64["min"], k64["max"]],
        "casts_ms": casts["median"], "timing_floor_ms": floor["median"],
        "path_profile_entry_ms": k1_entry, "path_shape_ms": k_path["median"],
        "ms_earlier_design": earlier["median"] if earlier else None,
        "regs": regs["regs"], "spill_bytes": regs["spill_bytes"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
