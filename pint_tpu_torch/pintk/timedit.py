"""Tim-file editor pane (a port of pint_tpu/pintk/timedit.py;
reference: src/pint/pintk/timedit.py TimWidget). The text-side logic
(TimEditState) is headless-testable; applied TOAs put their batch on
the pulsar's device."""

from __future__ import annotations

__all__ = ["TimEditState", "TimWidget"]


class TimEditState:
    def __init__(self, pulsar):
        self.pulsar = pulsar

    def current_text(self) -> str:
        import os
        import tempfile

        # round-trip through the writer so edits start from the
        # canonical serialization
        fd, path = tempfile.mkstemp(suffix=".tim")
        os.close(fd)
        try:
            self.pulsar.write_tim(path)
            with open(path) as fh:
                return fh.read()
        finally:
            os.unlink(path)

    def apply(self, text: str):
        """Reload TOAs from edited tim text."""
        import io

        import numpy as np

        from pint_tpu_torch.toa import get_TOAs

        p = self.pulsar
        p._push_undo()
        p.all_toas = get_TOAs(
            io.StringIO(text), model=p.model,
            ephem=p.model.EPHEM.value,
            planets=bool(p.model.PLANET_SHAPIRO.value),
            device=p.device)
        p.selected = np.zeros(p.all_toas.ntoas, dtype=bool)
        p.fitted = False
        p._fitter_obj = None

    def write(self, path: str):
        self.pulsar.write_tim(path)


class TimWidget:
    """Tk shell over TimEditState (requires a display)."""

    def __init__(self, master, pulsar, on_apply=None):
        import tkinter as tk
        from tkinter import filedialog, messagebox, scrolledtext

        self.state = TimEditState(pulsar)
        self._on_apply = on_apply
        self.frame = tk.Frame(master)
        bar = tk.Frame(self.frame)
        bar.pack(side=tk.TOP, fill=tk.X)
        tk.Button(bar, text="Apply", command=self.apply).pack(
            side=tk.LEFT)
        tk.Button(bar, text="Reset", command=self.reset).pack(
            side=tk.LEFT)
        tk.Button(bar, text="Write tim...", command=self.write).pack(
            side=tk.LEFT)
        self.text = scrolledtext.ScrolledText(self.frame, width=60)
        self.text.pack(side=tk.TOP, fill=tk.BOTH, expand=1)
        self._tk = tk
        self._filedialog = filedialog
        self._messagebox = messagebox
        self.reset()

    def reset(self):
        self.text.delete("1.0", self._tk.END)
        self.text.insert(self._tk.END, self.state.current_text())

    def apply(self):
        try:
            self.state.apply(self.text.get("1.0", self._tk.END))
        except Exception as e:
            self._messagebox.showerror("tim error", str(e))
            return
        if self._on_apply:
            self._on_apply()

    def write(self):
        path = self._filedialog.asksaveasfilename(
            defaultextension=".tim")
        if path:
            self.state.write(path)
