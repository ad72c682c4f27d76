"""Convert a TCB par file to TDB (a port of
pint_tpu/scripts/tcb2tdb.py; reference: src/pint/scripts/tcb2tdb.py).
The model is built on the GPU unless given ``--device cpu``:

    python -m pint_tpu_torch.scripts.tcb2tdb tcb.par tdb.par
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tcb2tdb", description="Convert a TCB par file to TDB")
    p.add_argument("input_par")
    p.add_argument("output_par")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: cuda; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    # the reference's JAX compile cache has no counterpart: eager torch
    # compiles nothing
    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.models import get_model

    # get_model converts TCB -> TDB on load
    model = get_model(args.input_par, device=resolve_device(args.device))
    if (model.UNITS.value or "").upper() != "TDB":
        raise SystemExit(f"conversion failed: UNITS={model.UNITS.value}")
    with open(args.output_par, "w") as fh:
        fh.write(model.as_parfile())
    print(f"Wrote TDB par file to {args.output_par}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
