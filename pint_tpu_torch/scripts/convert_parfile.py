"""Convert a par file: binary parameterization, units, and output
format (a port of pint_tpu/scripts/convert_parfile.py; reference:
src/pint/scripts/convert_parfile.py). The model is built on the GPU
unless given ``--device cpu``:

    python -m pint_tpu_torch.scripts.convert_parfile in.par --binary DD
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="convert_parfile",
        description="Rewrite a par file, optionally converting the "
                    "binary model (DD<->ELL1, H3/STIG<->M2/SINI, ...)")
    p.add_argument("input_par")
    p.add_argument("-o", "--out", default=None,
                   help="output par file (default: stdout)")
    p.add_argument("--binary", default=None,
                   help="target binary parameterization "
                        "(e.g. ELL1, ELL1H, DD, DDS, DDK, BT)")
    p.add_argument("--allow-tcb", action="store_true",
                   help="accept a TCB par file (converted to TDB); "
                        "without this flag TCB input is refused")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: cuda; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    # the reference's JAX compile cache has no counterpart: eager torch
    # compiles nothing
    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.models import get_model

    model = get_model(args.input_par, device=resolve_device(args.device),
                      allow_tcb=args.allow_tcb)
    if args.binary:
        from pint_tpu_torch.binaryconvert import convert_binary

        model = convert_binary(model, args.binary)
    text = model.as_parfile()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"Wrote {args.out}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
