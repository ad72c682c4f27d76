"""Convert a TEMPO2 "T2"-binary par file to a native parameterization
(a port of pint_tpu/scripts/t2binary2pint.py; reference:
src/pint/scripts/t2binary2pint.py).

TEMPO2's T2 model is a superset dispatcher: the actual orbit family is
implied by which parameters appear. This tool picks the matching
native model (ELL1 family for EPS1/EPS2, DDK for KIN/KOM, else DD/BT)
and rewrites the ``BINARY`` line. For DDK, the orbital-orientation
angles are converted from TEMPO2's IAU convention to the DT92
convention used by the DDK delay (reference BinaryDDK docs):

    KIN_DT92 = 180 deg - KIN_IAU
    KOM_DT92 =  90 deg - KOM_IAU

The converted file is proven by building it on the GPU, unless given
``--device cpu``:

    python -m pint_tpu_torch.scripts.t2binary2pint t2.par native.par
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main", "t2_to_native_parfile"]


def _fmt(v: float) -> str:
    return repr(float(v))


def t2_to_native_parfile(text: str) -> str:
    """Rewrite the par text: BINARY T2 -> native model + angle
    conventions. Non-T2 par files pass through unchanged."""
    import io

    from pint_tpu_torch.io.par import parse_parfile

    lines = parse_parfile(io.StringIO(text))
    keys = {ln.key.upper() for ln in lines}
    binary = next((ln.tokens[0].upper() for ln in lines
                   if ln.key.upper() == "BINARY" and ln.tokens), None)
    if binary != "T2":
        return text

    from pint_tpu_torch.models.model_builder import guess_binary_model

    target = guess_binary_model(keys)

    out = []
    for raw in text.splitlines():
        stripped = raw.strip()
        toks = stripped.split()
        key = toks[0].upper() if toks else ""
        if key == "BINARY":
            out.append(f"BINARY {target}")
        elif key == "KIN" and target == "DDK" and len(toks) >= 2:
            rest = " ".join(toks[2:])
            out.append(f"KIN {_fmt(180.0 - float(toks[1]))} "
                       f"{rest}".rstrip())
        elif key == "KOM" and target == "DDK" and len(toks) >= 2:
            rest = " ".join(toks[2:])
            out.append(f"KOM {_fmt(90.0 - float(toks[1]))} "
                       f"{rest}".rstrip())
        else:
            out.append(raw)
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="t2binary2pint",
        description="Convert a TEMPO2 T2-binary par file to a native "
                    "binary parameterization")
    p.add_argument("input_par")
    p.add_argument("output_par")
    p.add_argument("--device", default=None,
                   help="torch device the converted model is built on "
                        "(default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    # the reference's JAX compile cache has no counterpart: eager torch
    # compiles nothing
    with open(args.input_par) as fh:
        text = fh.read()
    converted = t2_to_native_parfile(text)

    # prove the converted file builds
    import io

    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.models import get_model

    model = get_model(io.StringIO(converted),
                      device=resolve_device(args.device))
    with open(args.output_par, "w") as fh:
        fh.write(converted)
    binary = next((n[len("Binary"):] for n in model.components
                   if n.startswith("Binary")), "none")
    print(f"Wrote {args.output_par} (binary model: {binary})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
