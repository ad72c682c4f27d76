"""Declared precision-boundary sites of the port — the only places in
``pint_tpu_torch/`` where float64 or dd values may be demoted to float32
(graftflow rule G9). A rewrite of pint_tpu/analysis/precision_registry.py
for the port's demotion sites.

Policy: the residual path runs the float64 dd error-free-transform
chain, and the fit step demotes precision only at the engineered
boundaries of its opt-in routes (``jac_f32``, ``matmul_f32``; the
anchored route's float32 twin). Every entry here is such a boundary: it
says why the demotion is numerically safe (what accuracy the consumer
needs, and which CPU equality oracle holds it). A demotion G9 finds
anywhere else is a violation: the failure it guards against is a silent
float32 creeping into the absolute-phase dd chain, which corrupts
residuals at the ~100 ns level without failing a test. Eager torch has
no trace boundary, so G9 reads every function of the package (the
linter's own ``analysis/`` modules, which spell dtypes as data, aside).

Entry fields:
  file      repo-relative path of the boundary site
  func      enclosing function name ("<module>" for module level)
  match     optional substring of the flagged source line
  flag      route expression over {jac32, f32mm, anchored, hybrid}
            telling WHEN the site is active — what the runtime
            differential validation checks against the dtypes the step
            actually runs (tests/test_torch_graftflow.py)
  guard     optional name that must appear in an enclosing `if` test
            or among the enclosing function's parameters — the static
            check that the declared flag really gates the site; None
            requires the `why` to say where the gate lives
  max_hits  how many demotion findings the entry may cover (default 1)
  why       mandatory justification

An entry that no longer matches any demotion site fails the lint run
(the allowlist's stale rule), so the registry cannot rot into a blanket
waiver.
"""

_FS = "pint_tpu_torch/parallel/fit_step.py"
_TM = "pint_tpu_torch/models/timing_model.py"

DEMOTIONS = [
    # ------------------------------------------- dd32 split primitives
    dict(file="pint_tpu_torch/ops/dd.py", func="f64_to_dd32",
         flag=None, guard=None, max_hits=4,
         why="the float64 -> dd32 error-free split itself (tensor and "
             "numpy forms): a float32 head and the float32 remainder, "
             "~2^-48 together; it splits, it does not truncate. Its "
             "callers are the registered float32 boundaries below; "
             "tests/test_torch_precision_routes.py holds it bitwise "
             "to the reference's."),
    dict(file="pint_tpu_torch/ops/dd.py", func="dd_to_dd32",
         flag=None, guard=None, max_hits=4,
         why="the dd64 -> dd32 narrowing itself (tensor and numpy "
             "forms): hi32 the top 24 bits, lo32 the next 24 plus what "
             "fits of lo. Only the registered float32 boundaries call "
             "it; the dd32 substrate tests hold it bitwise."),
    # ------------------------------------ float32 Jacobian input pack
    dict(file=_FS, func="conv", flag="jac32", guard=None, max_hits=2,
         why="_tree_to32's per-leaf converter is the declared float64 "
             "-> dd32 boundary of the float32 Jacobian: dd pairs are "
             "split by dd_to_dd32 (48 bits survive), plain float64 "
             "leaves cast. Design columns need ~1e-6 relative accuracy "
             "(they feed equilibrated normal equations). The gate lives "
             "at the call site: _tree_to32 runs only in _inputs32, "
             "defined inside `if jac32:`."),
    dict(file=_FS, func="_split32", flag="jac32", guard=None,
         why="the device-side float64 -> (float32, float32) split of "
             "the step's parameter pairs for the float32 re-run. The "
             "gate lives at the call site: _inputs32, defined inside "
             "`if jac32:`."),
    dict(file=_FS, func="_build_fit_core", flag="jac32", guard="jac32",
         why="the float32 twin of the power-of-two column scales "
             "(exact: a power of two is a float32), made once at build "
             "inside `if jac32:`."),
    dict(file=_FS, func="_inputs32", flag="jac32", guard="jac32",
         max_hits=4,
         why="the float32 Jacobian's inputs: batch, cache and the "
             "parameter pairs demote together, once a step, so the whole "
             "design-matrix re-run is dd32/float32 while the residuals "
             "stay on the float64 dd chain. Defined only inside `if "
             "jac32:`; oracles tests/test_jac32.py through both "
             "packages; the F8+ scale-window fallback clears jac32 "
             "where no safe exponent exists."),
    dict(file=_FS, func="_jacobian32", flag="jac32", guard="jac32",
         max_hits=2,
         why="f0 and the valid mask in float32 for the float32 design "
             "columns (defined only inside `if jac32:`)."),
    dict(file=_FS, func="_dm_rows", flag="jac32", guard="jac32",
         why="the wideband DM rows' Jacobian masked in the dtype of the "
             "time rows' (inside `if jac32:`); the DM residuals stay "
             "float64."),
    dict(file=_TM, func="reference", flag="jac32 and anchored",
         guard="float32", max_hits=2,
         why="the anchored delta phase's reference pairs (free and "
             "frozen) dd32-split for the float32 Jacobian's re-run, "
             "made only when a float32 operand asks for them; the "
             "float64 route takes the float64 pairs."),
    # ------------------------------------------- float32 Gram (matmul)
    dict(file="pint_tpu_torch/gls.py", func="_symm_mm", flag="f32mm",
         guard="f32", max_hits=2,
         why="the normal-equation Gram boundary: float32 products "
             "without TF32 give the ~1e-7 relative accuracy the "
             "equilibrated normal equations need, and the step's "
             "_gls_core takes the float64 Gram's solve where the float32 "
             "Cholesky fails. Gated by the f32 parameter (False "
             "upcasts and accumulates in float64)."),
]


# Runtime probe table: the differential validation between graftflow's
# static predictions and the dtypes the step actually runs. Each probe
# names a function that ``Sanitizer.dtype_probe`` intercepts while one
# built step runs; `flag` predicts when the probe fires and `dtype` (an
# expression over the same flags) the dtype it records. The tests assert
# observed == predicted for every route combination: the analyzer tests
# the code, the runtime tests the analyzer.
PROBES = [
    dict(label="dd32_split", file=_FS, callee="dd_to_dd32",
         flag="jac32", dtype="'float32'",
         why="the float64 -> dd32 split of the step's tensors runs only "
             "on the float32 Jacobian route; its pairs are float32"),
    dict(label="symm_mm", file=_FS, callee="_symm_mm", flag="True",
         dtype="'float32' if jac32 else 'float64'",
         why="the Gram product always runs; its input dtype follows the "
             "Jacobian's (M sets the dtype of the wide work)"),
    dict(label="symm_mm_f32", file=_FS, callee="_symm_mm",
         flag="f32mm", dtype="'float32'",
         why="a float32 Gram happens iff matmul_f32 (the float64 rescue "
             "runs too, so the probe looks for any float32 pass)"),
    dict(label="phase_frac", file=_FS, callee="dd_frac",
         flag="not anchored", dtype="'float64'",
         why="the direct chain takes the fractional phase of the "
             "absolute dd value in float64; the anchored route never "
             "forms the absolute phase in the step"),
    dict(label="linear_design_columns", file=_TM,
         callee="linear_design_columns", flag="hybrid",
         dtype="'float32' if jac32 else 'float64'",
         why="closed-form design columns are made only under the hybrid "
             "Jacobian, in the dtype of the Jacobian that takes them"),
]


def entry_count() -> int:
    return len(DEMOTIONS)


def probe_count() -> int:
    return len(PROBES)
