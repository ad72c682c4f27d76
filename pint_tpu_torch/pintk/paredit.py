"""Par-file editor pane (a port of pint_tpu/pintk/paredit.py;
reference: src/pint/pintk/paredit.py ParWidget): edit the model as text,
apply, write out. The text-side logic (ParEditState) is
headless-testable; an applied model is built on the pulsar's device."""

from __future__ import annotations

__all__ = ["ParEditState", "ParWidget"]


class ParEditState:
    def __init__(self, pulsar):
        self.pulsar = pulsar

    def current_text(self) -> str:
        return self.pulsar.model.as_parfile()

    def apply(self, text: str):
        """Apply edited par text to the pulsar (rebuilds the model;
        raises on a malformed par so the GUI can show the error)."""
        self.pulsar.update_model_from_text(text)

    def write(self, path: str):
        self.pulsar.write_par(path)


class ParWidget:
    """Tk shell over ParEditState (requires a display)."""

    def __init__(self, master, pulsar, on_apply=None):
        import tkinter as tk
        from tkinter import filedialog, messagebox, scrolledtext

        self.state = ParEditState(pulsar)
        self._on_apply = on_apply
        self.frame = tk.Frame(master)
        bar = tk.Frame(self.frame)
        bar.pack(side=tk.TOP, fill=tk.X)
        tk.Button(bar, text="Apply", command=self.apply).pack(
            side=tk.LEFT)
        tk.Button(bar, text="Reset", command=self.reset).pack(
            side=tk.LEFT)
        tk.Button(bar, text="Write par...", command=self.write).pack(
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
        except Exception as e:  # surface parse errors to the user
            self._messagebox.showerror("par error", str(e))
            return
        if self._on_apply:
            self._on_apply()

    def write(self):
        path = self._filedialog.asksaveasfilename(
            defaultextension=".par")
        if path:
            self.state.write(path)
