"""Fit-parameter checkbox column (a port of pint_tpu/pintk/fitbox.py;
reference: src/pint/pintk/plk.py's fitbox): toggle which parameters the
next fit frees. All logic lives in the Pulsar facade (fittable_params /
set_fit_params); this widget is a thin Tk shell of checkbuttons."""

from __future__ import annotations

__all__ = ["FitboxWidget"]


class FitboxWidget:
    """Tk shell: one checkbutton per fittable parameter."""

    def __init__(self, master, pulsar, on_apply=None):
        import tkinter as tk

        self._tk = tk
        self.pulsar = pulsar
        self._on_apply = on_apply
        self.frame = tk.Frame(master)
        tk.Button(self.frame, text="Apply fit params",
                  command=self.apply).pack(side=tk.TOP, fill=tk.X)
        canvas = tk.Canvas(self.frame, width=160)
        bar = tk.Scrollbar(self.frame, orient="vertical",
                           command=canvas.yview)
        self._inner = tk.Frame(canvas)
        self._inner.bind("<Configure>", lambda e: canvas.configure(
            scrollregion=canvas.bbox("all")))
        canvas.create_window((0, 0), window=self._inner, anchor="nw")
        canvas.configure(yscrollcommand=bar.set)
        canvas.pack(side="left", fill="both", expand=True)
        bar.pack(side="right", fill="y")
        self._vars = {}
        self.refresh()

    def refresh(self):
        """Rebuild the checkbutton set from the CURRENT model —
        must run after anything that adds/frees parameters (GUI
        jumps, par edits), or Apply would re-freeze them: the facade
        freezes every fittable param not listed."""
        for w in self._inner.winfo_children():
            w.destroy()
        self._vars = {}
        free = set(self.pulsar.model.free_params)
        for nm in self.pulsar.fittable_params():
            v = self._tk.BooleanVar(value=nm in free)
            self._tk.Checkbutton(self._inner, text=nm, variable=v,
                                 anchor="w").pack(fill="x")
            self._vars[nm] = v

    def apply(self):
        names = [nm for nm, v in self._vars.items() if v.get()]
        self.pulsar.set_fit_params(names)
        if self._on_apply:
            self._on_apply()
