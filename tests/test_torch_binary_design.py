"""The design matrix of every registered binary model of the port
(pint_tpu_torch.models.binary, torch.func.jacfwd through the delay
chain) against the reference pint_tpu's on the CPU, on the fixtures of
test_torch_binary.py. The reference runs eagerly, for the reason given
there (its compiled CPU code rounds the double-double phase of a binary
model ~1e-6 turns away from exact)."""

import jax
import numpy as np

from test_torch_binary import binary  # noqa: F401  (the fixture)


def test_designmatrix_matches_reference(binary, monkeypatch):
    """Every design column within 1e-12 of its largest entry, against
    the reference's all-jacfwd design matrix (its hybrid closed-form
    columns off, as the port's default is), with the same names and
    units."""
    _, rm, tm, rt, tt = binary
    monkeypatch.setenv("PINT_TPU_HYBRID_JAC", "off")
    with jax.disable_jit():
        Mr, nr, ur = rm.designmatrix(rt)
    Mt, nt, ut = tm.designmatrix(tt)
    assert nt == nr and ut == ur
    Mr = np.asarray(Mr)
    err = np.max(np.abs(Mr - Mt.numpy()), axis=0) / np.max(np.abs(Mr), axis=0)
    assert np.all(err <= 1e-12), str(dict(zip(nr, err.tolist())))
