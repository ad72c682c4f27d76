"""Interactive fitting GUI (a port of pint_tpu/pintk; reference:
src/pint/pintk/: the `pintk` script with PlkWidget + par/tim editors
over a Pulsar facade).

Architecture: ALL behavior lives in headless classes —
:class:`pint_tpu_torch.pintk.pulsar.Pulsar` (fit/select/delete/jump/
undo, on a torch device), :class:`pint_tpu_torch.pintk.plk.PlkState`
(axes/colors/box-select), ``ParEditState``/``TimEditState`` — and the Tk
widgets are thin shells, so the whole GUI logic runs under pytest
without a display and the same facade is scriptable from notebooks.
Tk and matplotlib are imported only inside ``main`` and the widgets:

    python -c "import sys; from pint_tpu_torch.pintk import main; \
        sys.exit(main())" model.par toas.tim [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from pint_tpu_torch.pintk.pulsar import Pulsar  # noqa: F401

__all__ = ["Pulsar", "main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pintk", description="Interactive timing-model fitter")
    p.add_argument("parfile")
    p.add_argument("timfile")
    p.add_argument("--fitter", default="auto",
                   choices=["auto", "wls", "gls", "downhill",
                            "downhill_gls"])
    p.add_argument("--device", default=None,
                   help="torch device of the model and the fits "
                        "(default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    try:
        import tkinter as tk
    except ImportError as e:  # pragma: no cover - env without Tk
        raise SystemExit(f"pintk needs tkinter: {e}")

    from pint_tpu_torch.pintk.fitbox import FitboxWidget
    from pint_tpu_torch.pintk.paredit import ParWidget
    from pint_tpu_torch.pintk.plk import PlkWidget
    from pint_tpu_torch.pintk.timedit import TimWidget

    pulsar = Pulsar(args.parfile, args.timfile, fitter=args.fitter,
                    device=args.device)

    root = tk.Tk()
    root.title(f"pintk: {pulsar.name}")
    plk = PlkWidget(root, pulsar)
    plk.frame.pack(side=tk.LEFT, fill=tk.BOTH, expand=1)

    fitbox = FitboxWidget(root, pulsar, on_apply=plk.update_plot)
    fitbox.frame.pack(side=tk.LEFT, fill=tk.Y)
    # GUI jumps / par edits can add or free parameters; the fitbox
    # must rebuild its checkbutton set or Apply would re-freeze them
    plk.on_model_change = fitbox.refresh

    def _applied():
        plk.update_plot()
        fitbox.refresh()

    side = tk.Frame(root)
    side.pack(side=tk.RIGHT, fill=tk.BOTH)
    par = ParWidget(side, pulsar, on_apply=_applied)
    par.frame.pack(side=tk.TOP, fill=tk.BOTH, expand=1)
    tim = TimWidget(side, pulsar, on_apply=_applied)
    tim.frame.pack(side=tk.BOTTOM, fill=tk.BOTH, expand=1)

    root.mainloop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
