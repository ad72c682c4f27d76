"""plk-style residual-plot widget (a port of pint_tpu/pintk/plk.py;
reference: src/pint/pintk/plk.py PlkWidget): matplotlib canvas embedded
in Tk with rectangle selection, fit/undo/delete/jump buttons, axis
choices, and color modes.

All plotting state transforms live on PlkState (headless-testable, host
numpy arrays from Pulsar.plot_data); the Tk widget is a thin shell so
the module imports fine without a display (tkinter and matplotlib are
only touched inside PlkWidget.__init__).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pint_tpu_torch.pintk.colormodes import point_colors

__all__ = ["PlkState", "PlkWidget", "XAXIS_CHOICES", "YAXIS_CHOICES"]

XAXIS_CHOICES = ["mjd", "year", "day_of_year", "orbital_phase",
                 "serial", "frequency", "toa_error", "elongation"]
YAXIS_CHOICES = ["residual", "residual_phase"]


class PlkState:
    """Pure plotting state: which axes, color mode, and the derived
    arrays for the current Pulsar."""

    def __init__(self, pulsar):
        self.pulsar = pulsar
        self.xaxis = "mjd"
        self.yaxis = "residual"
        self.color_mode = "default"
        self.show_prefit = False
        # view-limit state (zoom): None = autoscale to the data. A
        # stack of previous views backs zoom_out, like the
        # reference's plk zoom history.
        self.xlim: Optional[Tuple[float, float]] = None
        self.ylim: Optional[Tuple[float, float]] = None
        self._view_stack: list = []
        # random-models overlay curves (aligned with the current TOA
        # set; invalidated by any TOA-count or fit change)
        self.random_curves: Optional[list] = None

    # -------------------------------------------------------- arrays

    def _jump_ids(self):
        from pint_tpu_torch.pintk.pulsar import GUI_JUMP_FLAG

        return [int(f.get(GUI_JUMP_FLAG, 0))
                for f in self.pulsar.all_toas.flags]

    def xy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
        """(x, y, yerr, data) for the current axis selection."""
        data = self.pulsar.plot_data(postfit=not self.show_prefit
                                     and self.pulsar.fitted)
        data["jump_ids"] = self._jump_ids()
        if self.xaxis == "mjd":
            x = data["mjds"]
        elif self.xaxis == "year":
            # Julian-epoch year (reference plk "year" axis)
            x = 2000.0 + (data["mjds"] - 51544.5) / 365.25
        elif self.xaxis == "day_of_year":
            # EXACT civil (UTC) day-of-year via the calendar
            # conversion in time.mjd (a Julian-year 365.25 d
            # approximation drifts up to ~0.75 d within a year and
            # gives day-366 artifacts at non-leap year boundaries).
            # Jan 1 00:00 -> 1.0, fractional day rides the MJD
            # fraction.
            from pint_tpu_torch.time.mjd import mjd_to_calendar

            mjds = data["mjds"]
            _, _, _, doy = mjd_to_calendar(mjds)
            x = doy + (mjds - np.floor(mjds))
        elif self.xaxis == "orbital_phase":
            x = data.get("orbital_phase")
            if x is None:
                raise ValueError("model has no binary: no orbital "
                                 "phase axis")
        elif self.xaxis == "serial":
            x = np.arange(len(data["mjds"]), dtype=float)
        elif self.xaxis == "frequency":
            x = data["freqs"]
        elif self.xaxis == "toa_error":
            x = data["errors_us"]
        elif self.xaxis == "elongation":
            x = data.get("elongation")
            if x is None:
                raise ValueError("no solar-elongation data (TOAs "
                                 "lack Sun positions)")
        else:
            raise ValueError(f"unknown x axis {self.xaxis!r}")
        y = data["resids_us"]
        yerr = data["errors_us"]
        if self.yaxis == "residual_phase":
            f0 = self.pulsar.model.F0.value
            y = y * 1e-6 * f0
            yerr = yerr * 1e-6 * f0
        out = (np.asarray(x, dtype=float), np.asarray(y),
               np.asarray(yerr), data)
        self._last_xy = out[:2]  # reused by nearest_point (O(1) pick)
        return out

    def colors(self, data) -> list:
        return point_colors(self.color_mode, data)

    def select_rectangle(self, x1, x2, y1=None, y2=None,
                         extend: bool = False) -> int:
        """Box selection in current axis coordinates; returns the
        number of selected points."""
        x, y, _, _ = self.xy()
        lo, hi = min(x1, x2), max(x1, x2)
        m = (x >= lo) & (x <= hi)
        if y1 is not None and y2 is not None:
            ylo, yhi = min(y1, y2), max(y1, y2)
            m &= (y >= ylo) & (y <= yhi)
        if extend:
            m |= self.pulsar.selected
        self.pulsar.select(m)
        return int(m.sum())

    def zoom_rectangle(self, x1, x2, y1=None, y2=None) -> None:
        """Zoom to a box in current axis coordinates (reference: plk
        right-drag zoom). The previous view is pushed so zoom_out
        steps back through the history. Zero-area boxes (a plain
        click: RectangleSelector fires on release even without a
        drag) are ignored — they would blank the plot and pollute
        the history."""
        if x1 == x2 or (y1 is not None and y2 is not None
                        and y1 == y2):
            return
        self._view_stack.append((self.xlim, self.ylim))
        self.xlim = (min(x1, x2), max(x1, x2))
        if y1 is not None and y2 is not None:
            self.ylim = (min(y1, y2), max(y1, y2))

    def zoom_out(self) -> None:
        """Step back one zoom level (autoscale when the history is
        empty)."""
        if self._view_stack:
            self.xlim, self.ylim = self._view_stack.pop()
        else:
            self.xlim = self.ylim = None

    def reset_view(self) -> None:
        self.xlim = self.ylim = None
        self._view_stack.clear()

    def set_axis(self, xaxis: Optional[str] = None,
                 yaxis: Optional[str] = None) -> None:
        """Change plot axes AND reset the view: zoom limits are in
        axis units, so keeping them across an axis switch would show
        an empty plot (mjd limits applied to a 0-1 orbital phase)."""
        if xaxis is not None:
            self.xaxis = xaxis
        if yaxis is not None:
            self.yaxis = yaxis
        self.reset_view()

    def visible_mask(self) -> np.ndarray:
        """Boolean mask of points inside the current view limits —
        lets selection operations act on what the user sees."""
        x, y, _, _ = self.xy()
        m = np.ones(len(x), dtype=bool)
        if self.xlim is not None:
            m &= (x >= self.xlim[0]) & (x <= self.xlim[1])
        if self.ylim is not None:
            m &= (y >= self.ylim[0]) & (y <= self.ylim[1])
        return m

    def compute_random_models(self, n: int = 10, rng=None) -> list:
        """Fit-covariance draw curves [s] for the overlay, computed
        through the Pulsar facade on its device and cached on the state
        as one host array (the Tk widget is a pure view). Requires a
        completed fit."""
        curves = self.pulsar.random_models(n=n, rng=rng)
        self.random_curves = curves.cpu().numpy()
        return self.random_curves

    def clear_random_models(self) -> None:
        self.random_curves = None

    def overlay_arrays(self, x: np.ndarray) -> list:
        """Random-model curves as (x, y_us) pairs aligned with the
        current plot arrays; silently drops (and clears) the overlay
        when the TOA set changed under it."""
        if self.random_curves is None:
            return []
        out = []
        for curve in self.random_curves:
            if len(curve) != len(x):
                self.random_curves = None
                return []
            out.append((x, np.asarray(curve) * 1e6))
        return out

    def nearest_point(self, x, y=None,
                      max_frac: float = 0.02) -> Optional[int]:
        """Index of the plotted point nearest (x, y) in the current
        axis coordinates, or None if nothing is within ``max_frac``
        of the VISIBLE span (a click on empty space selects nothing,
        and a zoomed view picks what's under the cursor, not an
        off-screen point). Reuses the arrays of the last xy() call —
        update_plot just computed them — so a pick costs no model
        evaluation."""
        cached = getattr(self, "_last_xy", None)
        if cached is None or \
                len(cached[0]) != self.pulsar.all_toas.ntoas:
            self.xy()  # none cached / stale after a TOA edit
            cached = self._last_xy
        px, py = cached
        # normalize by (and restrict the pick to) the current view
        if self.xlim is not None:
            sx = self.xlim[1] - self.xlim[0] or 1.0
        else:
            sx = np.ptp(px) or 1.0
        if y is not None and self.ylim is not None:
            sy = self.ylim[1] - self.ylim[0] or 1.0
        else:
            sy = np.ptp(py) or 1.0
        vis = np.ones(len(px), dtype=bool)
        if self.xlim is not None:
            vis &= (px >= self.xlim[0]) & (px <= self.xlim[1])
        if self.ylim is not None:
            vis &= (py >= self.ylim[0]) & (py <= self.ylim[1])
        if not vis.any():
            return None
        d2 = ((px - x) / sx) ** 2
        if y is not None:
            d2 = d2 + ((py - y) / sy) ** 2
        d2 = np.where(vis, d2, np.inf)
        i = int(np.argmin(d2))
        return i if float(np.sqrt(d2[i])) <= max_frac else None

    def title(self, data: Optional[dict] = None) -> str:
        if data is None:
            data = self.pulsar.plot_data(postfit=self.pulsar.fitted
                                         and not self.show_prefit)
        kind = "post-fit" if self.pulsar.fitted and \
            not self.show_prefit else "pre-fit"
        return (f"{self.pulsar.name}  {kind}  "
                f"wrms={data['rms_us']:.3f} us  "
                f"chi2={data['chi2']:.2f}")


class PlkWidget:
    """Tk shell over PlkState (requires a display). Set
    ``on_model_change`` to be notified after actions that can change
    the model's parameter structure (fit/jump/unjump/undo) — the
    fitbox refreshes its checkbuttons from it."""

    on_model_change = None

    def __init__(self, master, pulsar):
        import tkinter as tk

        from matplotlib.backends.backend_tkagg import (
            FigureCanvasTkAgg, NavigationToolbar2Tk)
        from matplotlib.figure import Figure
        from matplotlib.widgets import RectangleSelector

        self.state = PlkState(pulsar)
        self.frame = tk.Frame(master)
        top = tk.Frame(self.frame)
        top.pack(side=tk.TOP, fill=tk.X)

        tk.Button(top, text="Fit", command=self.fit).pack(
            side=tk.LEFT)
        tk.Button(top, text="Undo", command=self.undo).pack(
            side=tk.LEFT)
        tk.Button(top, text="Delete", command=self.delete).pack(
            side=tk.LEFT)
        tk.Button(top, text="Jump", command=self.jump).pack(
            side=tk.LEFT)
        tk.Button(top, text="Unjump", command=self.unjump).pack(
            side=tk.LEFT)
        tk.Button(top, text="Pulse numbers",
                  command=self.track_pn).pack(side=tk.LEFT)
        tk.Button(top, text="Random models",
                  command=self.random_models).pack(side=tk.LEFT)

        self.xvar = tk.StringVar(value=self.state.xaxis)
        tk.OptionMenu(top, self.xvar, *XAXIS_CHOICES,
                      command=self.set_xaxis).pack(side=tk.LEFT)
        self.cvar = tk.StringVar(value=self.state.color_mode)
        from pint_tpu_torch.pintk.colormodes import COLOR_MODES

        tk.OptionMenu(top, self.cvar, *COLOR_MODES,
                      command=self.set_color_mode).pack(side=tk.LEFT)

        self.fig = Figure(figsize=(9, 5))
        self.ax = self.fig.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.fig, master=self.frame)
        self.canvas.get_tk_widget().pack(side=tk.TOP, fill=tk.BOTH,
                                         expand=1)
        # middle-click a point -> per-TOA info popup (reference: the
        # plk click-info behavior); all content comes from the
        # headless Pulsar.toa_info
        self.canvas.mpl_connect("button_press_event", self._on_click)
        NavigationToolbar2Tk(self.canvas, self.frame)
        # left-drag: box selection; right-drag: zoom (reference plk
        # bindings); both are thin event shims over PlkState
        self.selector = RectangleSelector(self.ax, self._on_select,
                                          useblit=True, button=[1])
        self.zoomer = RectangleSelector(self.ax, self._on_zoom,
                                        useblit=True, button=[3])
        tk.Button(top, text="Zoom out",
                  command=self.zoom_out).pack(side=tk.LEFT)
        self.update_plot()

    # ------------------------------------------------------- actions

    def _on_select(self, eclick, erelease):
        self.state.select_rectangle(eclick.xdata, erelease.xdata,
                                    eclick.ydata, erelease.ydata,
                                    extend=eclick.key == "shift")
        self.update_plot()

    def _on_click(self, event):
        if event.button != 2 or event.inaxes is not self.ax \
                or event.xdata is None:
            return
        idx = self.state.nearest_point(event.xdata, event.ydata)
        if idx is None:
            return
        info = self.state.pulsar.toa_info(idx)
        import tkinter.messagebox as mb

        lines = [f"TOA #{info['index']}  {info['name']}",
                 f"MJD {info['mjd']:.8f}",
                 f"freq {info['freq_mhz']:.3f} MHz",
                 f"resid {info['resid_us']:.3f} us "
                 f"+- {info['error_us']:.3f}",
                 f"obs {info['obs']}"]
        lines += [f"-{k} {v}" for k, v in
                  sorted(info["flags"].items())]
        mb.showinfo("TOA info", "\n".join(lines))

    def _on_zoom(self, eclick, erelease):
        self.state.zoom_rectangle(eclick.xdata, erelease.xdata,
                                  eclick.ydata, erelease.ydata)
        self.update_plot()

    def zoom_out(self):
        self.state.zoom_out()
        self.update_plot()

    def _model_changed(self):
        if self.on_model_change:
            self.on_model_change()

    def fit(self):
        self.state.pulsar.fit()
        self.state.clear_random_models()
        self.update_plot()
        self._model_changed()

    def undo(self):
        self.state.pulsar.undo()
        self.state.clear_random_models()  # TOA count may have changed
        self.update_plot()
        self._model_changed()

    def delete(self):
        self.state.pulsar.delete_TOAs()
        self.state.clear_random_models()
        self.update_plot()

    def jump(self):
        self.state.pulsar.jump_selection()
        self.update_plot()
        self._model_changed()  # may have added a free JUMP param

    def unjump(self):
        self.state.pulsar.unjump_selection()
        self.update_plot()
        self._model_changed()

    def track_pn(self):
        self.state.pulsar.compute_pulse_numbers()
        self.update_plot()

    def random_models(self):
        self.state.compute_random_models(n=10)
        self.update_plot()

    def set_xaxis(self, value):
        self.state.set_axis(xaxis=value)  # resets zoom (axis units)
        self.update_plot()

    def set_color_mode(self, value):
        self.state.color_mode = value
        self.update_plot()

    # ---------------------------------------------------------- draw

    def update_plot(self):
        x, y, yerr, data = self.state.xy()
        self.ax.clear()
        colors = self.state.colors(data)
        self.ax.errorbar(x, y, yerr=yerr, fmt="none", ecolor="#bbbbbb",
                         zorder=1)
        self.ax.scatter(x, y, c=colors, s=12, zorder=2)
        sel = data["selected"]
        if sel.any():
            self.ax.scatter(x[sel], y[sel], facecolors="none",
                            edgecolors="#e34a33", s=60, zorder=3)
        if self.state.xaxis == "mjd":
            for cx, cy in self.state.overlay_arrays(x):
                self.ax.plot(cx, cy, color="#31a354", alpha=0.3,
                             zorder=0)
        if self.state.xlim is not None:
            self.ax.set_xlim(*self.state.xlim)
        if self.state.ylim is not None:
            self.ax.set_ylim(*self.state.ylim)
        self.ax.set_xlabel(self.state.xaxis)
        self.ax.set_ylabel("residual (us)"
                           if self.state.yaxis == "residual"
                           else "residual (turns)")
        self.ax.set_title(self.state.title(data))
        self.ax.grid(alpha=0.2)
        self.canvas.draw_idle()
