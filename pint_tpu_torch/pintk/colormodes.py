"""Point-coloring modes for the plk residual plot (a port of
pint_tpu/pintk/colormodes.py; reference: src/pint/pintk/colormodes.py).
Each mode maps the Pulsar plot_data dict to per-point colors; pure host
functions of numpy arrays, so they're testable headless.
"""

from __future__ import annotations

import numpy as np

__all__ = ["COLOR_MODES", "point_colors"]

_DEFAULT = "#2c7fb8"
_SELECTED = "#e34a33"
_CYCLE = ["#2c7fb8", "#e34a33", "#31a354", "#756bb1", "#ff7f00",
          "#a6761d", "#e7298a", "#666666"]


def _mode_default(data):
    c = np.array([_DEFAULT] * len(data["mjds"]), dtype=object)
    c[data["selected"]] = _SELECTED
    return list(c)


def _mode_freq(data):
    """Blue->red across the observing band (log spacing)."""
    f = np.asarray(data["freqs"], dtype=float)
    finite = np.isfinite(f)
    lo = np.log10(f[finite].min()) if finite.any() else 0.0
    hi = np.log10(f[finite].max()) if finite.any() else 1.0
    span = (hi - lo) or 1.0
    out = []
    for fi in f:
        if not np.isfinite(fi):
            out.append("#666666")
            continue
        x = (np.log10(fi) - lo) / span
        r = int(255 * x)
        b = int(255 * (1 - x))
        out.append(f"#{r:02x}40{b:02x}")
    return out


def _mode_obs(data):
    sites = sorted(set(data["obs"]))
    cmap = {s: _CYCLE[i % len(_CYCLE)] for i, s in enumerate(sites)}
    return [cmap[o] for o in data["obs"]]


def _mode_jump(data):
    """Color by GUI jump id (0 = unjumped)."""
    ids = data.get("jump_ids")
    if ids is None:
        return _mode_default(data)
    out = []
    for j in ids:
        out.append("#bbbbbb" if j == 0 else _CYCLE[j % len(_CYCLE)])
    return out


COLOR_MODES = {
    "default": _mode_default,
    "frequency": _mode_freq,
    "observatory": _mode_obs,
    "jump": _mode_jump,
}


def point_colors(mode: str, data) -> list:
    try:
        return COLOR_MODES[mode](data)
    except KeyError:
        raise ValueError(f"unknown color mode {mode!r}; know "
                         f"{sorted(COLOR_MODES)}") from None
