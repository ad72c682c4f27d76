"""Counters of the array likelihood plane (a port of
pint_tpu/pta/metrics.py, as plain per-instance counters: the reference's
process-wide metrics registry is ROADMAP.md item 11)."""

from __future__ import annotations

__all__ = ["PTAMetrics"]


class PTAMetrics:
    """Counters of the GWB likelihood plane:

    - ``block_assemblies``: per-pulsar inner-block batch assemblies
      (one per ``GWBLikelihood.build_blocks`` evaluation);
    - ``hd_outer_solves``: cross-correlated (Npsr*m)^2 outer-system
      factorizations evaluated (grid points swept, padding included);
    - ``gwb_solves``: sweep chunks evaluated.
    """

    _COUNTERS = ("gwb_solves", "block_assemblies", "hd_outer_solves")

    def __init__(self):
        self._c = dict.fromkeys(self._COUNTERS, 0)

    def bump(self, name: str, n: int = 1):
        if name not in self._c:
            raise KeyError(name)
        self._c[name] += int(n)

    def __getattr__(self, name: str):
        c = self.__dict__.get("_c", {})
        if name in c:
            return c[name]
        raise AttributeError(name)

    def snapshot(self) -> dict:
        return dict(self._c)
