"""Photon phaseogram plotting (reference: src/pint/plot_utils.py
phaseogram / phaseogram_binned). matplotlib is imported lazily with
the Agg backend so headless use works."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["phaseogram", "phaseogram_binned", "plot_priors"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def phaseogram(mjds, phases, weights=None, bins: int = 64,
               rotate: float = 0.0, title: Optional[str] = None,
               plotfile: Optional[str] = None):
    """2-D photon phaseogram (phase x time, two cycles) over a summed
    pulse profile (reference: plot_utils.phaseogram). Returns the
    matplotlib figure."""
    plt = _mpl()
    mjds = np.asarray(mjds, dtype=np.float64)
    ph = np.mod(np.asarray(phases, dtype=np.float64) + rotate, 1.0)
    w = np.ones_like(ph) if weights is None else np.asarray(weights)
    ph2 = np.concatenate([ph, ph + 1.0])
    mj2 = np.concatenate([mjds, mjds])
    w2 = np.concatenate([w, w])
    fig, (ax0, ax1) = plt.subplots(
        2, 1, sharex=True, figsize=(7, 8),
        gridspec_kw={"height_ratios": [1, 3]})
    prof, edges = np.histogram(ph2, bins=2 * bins, range=(0, 2),
                               weights=w2)
    ax0.step(edges[:-1], prof, where="post")
    ax0.set_ylabel("counts")
    if title:
        ax0.set_title(title)
    tb = max(16, min(64, mjds.size // 50))
    H, xe, ye = np.histogram2d(
        ph2, mj2, bins=[2 * bins, tb],
        range=[[0, 2], [mjds.min(), mjds.max()]], weights=w2)
    ax1.imshow(H.T, origin="lower", aspect="auto",
               extent=[0, 2, mjds.min(), mjds.max()], cmap="Greys")
    ax1.set_xlabel("pulse phase")
    ax1.set_ylabel("MJD")
    if plotfile:
        fig.savefig(plotfile, dpi=100)
        plt.close(fig)
    return fig


def phaseogram_binned(mjds, phases, weights=None, bins: int = 32,
                      **kw):
    """Pre-binned variant (reference: plot_utils.phaseogram_binned) —
    same figure at coarser default binning for sparse data."""
    return phaseogram(mjds, phases, weights=weights, bins=bins, **kw)


def plot_priors(model, chains, burnin: int = 0,
                bins: int = 40, plotfile: Optional[str] = None):
    """Posterior histograms per sampled parameter with the prior pdf
    overplotted (reference: plot_utils.plot_priors)."""
    plt = _mpl()
    names = list(chains.keys()) if isinstance(chains, dict) else None
    if names is None:
        raise ValueError("chains must be {param: samples}")
    n = len(names)
    fig, axes = plt.subplots(n, 1, figsize=(6, 2.2 * n), squeeze=False)
    for ax, nm in zip(axes[:, 0], names):
        samp = np.asarray(chains[nm])[burnin:]
        ax.hist(samp, bins=bins, density=True, alpha=0.6)
        p = model.get_param(nm)
        if getattr(p, "prior", None) is not None:
            xs = np.linspace(samp.min(), samp.max(), 200)
            ax.plot(xs, np.exp(np.asarray(p.prior.logpdf(xs))))
        ax.set_ylabel(nm)
    if plotfile:
        fig.savefig(plotfile, dpi=100)
        plt.close(fig)
    return fig
