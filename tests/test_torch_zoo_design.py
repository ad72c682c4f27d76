"""The design matrix of each zoo component of the port (torch.func.jacfwd
through the delay and phase chain, and the closed-form columns of
``hybrid=True``) against the reference pint_tpu's on the CPU, on the
fixtures of test_torch_zoo.py. The reference runs eagerly with its
hybrid closed-form columns off, as the port's default is.

Tolerance: every column within 1e-10 of its largest entry (the index
families sum in another order than the reference's Python loops, and
the column's tangent runs through that sum)."""

import jax
import numpy as np
import torch

from test_torch_zoo import zoo  # noqa: F401  (the fixture)

COL_REL = 1e-10


def _col_err(a, b):
    return np.max(np.abs(a - b), axis=0) / np.maximum(
        np.max(np.abs(b), axis=0), 1e-300)


def test_designmatrix_matches_reference(zoo, monkeypatch):
    """The port's all-jacfwd design matrix against the reference's, with
    the same names and units."""
    _, rm, tm, rt, tt = zoo
    monkeypatch.setenv("PINT_TPU_HYBRID_JAC", "off")
    with jax.disable_jit():
        Mr, nr, ur = rm.designmatrix(rt)
    Mt, nt, ut = tm.designmatrix(tt)
    assert nt == nr and ut == ur
    err = _col_err(Mt.numpy(), np.asarray(Mr))
    assert np.all(err <= COL_REL), str(dict(zip(nr, err.tolist())))


def test_hybrid_columns_match_jacfwd(zoo):
    """The closed-form columns (``linear_design_local``, the reference's
    set of names) against the all-jacfwd design Jacobian."""
    name, rm, tm, _, tt = zoo
    assert tm.linear_design_names() == rm.linear_design_names()
    cache = tm.get_cache(tt, "cpu")
    th, tl, fh, fl = (torch.as_tensor(x, dtype=torch.float64)
                      for x in tm._pack()[2:])
    hyb = tm.design_jacobian(th, tl, fh, fl, cache["batch"], cache,
                             hybrid=True).numpy()
    ad = tm.design_jacobian(th, tl, fh, fl, cache["batch"], cache).numpy()
    assert np.all(np.isfinite(hyb))
    err = _col_err(hyb, ad)
    assert np.max(err) <= COL_REL, name
