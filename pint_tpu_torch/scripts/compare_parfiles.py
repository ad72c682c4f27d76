"""Compare two par files parameter by parameter (a port of
pint_tpu/scripts/compare_parfiles.py; reference:
src/pint/scripts/compare_parfiles.py, using TimingModel.compare). The
models are built on the GPU unless given ``--device cpu``:

    python -m pint_tpu_torch.scripts.compare_parfiles a.par b.par
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="compare_parfiles",
        description="Diff two timing models parameter by parameter")
    p.add_argument("par1")
    p.add_argument("par2")
    p.add_argument("--device", default=None,
                   help="torch device of the models (default: cuda; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    # the reference's JAX compile cache has no counterpart: eager torch
    # compiles nothing
    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.models import get_model

    dev = resolve_device(args.device)
    m1 = get_model(args.par1, device=dev)
    m2 = get_model(args.par2, device=dev)
    print(m1.compare(m2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
