"""Assign phases to Fermi-LAT FT1 photons with weights (a port of
pint_tpu/scripts/fermiphase.py; reference: src/pint/scripts/fermiphase.py
— photonphase specialized to Fermi with the gtsrcprob/MODEL_WEIGHT
column). It runs the port's photonphase with ``--weightcol
MODEL_WEIGHT --mission fermi`` unless the user gave either option; every
other option (``--device cpu`` among them) passes through:

    python -m pint_tpu_torch.scripts.fermiphase ft1.fits model.par
"""

from __future__ import annotations

import sys

__all__ = ["main"]


def main(argv=None) -> int:
    from pint_tpu_torch.scripts import photonphase

    argv = list(sys.argv[1:] if argv is None else argv)

    def has_opt(name):  # matches both '--opt value' and '--opt=value'
        return any(a == name or a.startswith(name + "=") for a in argv)

    if not has_opt("--weightcol"):
        argv += ["--weightcol", "MODEL_WEIGHT"]
    if not has_opt("--mission"):
        argv += ["--mission", "fermi"]
    return photonphase.main(argv)


if __name__ == "__main__":
    sys.exit(main())
