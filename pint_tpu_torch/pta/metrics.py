"""Registry-bound counters for the array likelihood plane (a port of
pint_tpu/pta/metrics.py).

Same contract as the supervisor's ``RuntimeMetrics``: each
``PTAMetrics`` instance holds bound children of the process-global
``obs.metrics`` registry (``pint_tpu_pta_<name>_total``, labelled by a
per-instance scope), ``snapshot()`` is a derived view of the same
values, and every mutation goes through ``bump()``.
"""

from __future__ import annotations

__all__ = ["PTAMetrics"]


class PTAMetrics:
    """Counters of the GWB likelihood plane:

    - ``block_assemblies``: per-pulsar inner-block batch assemblies
      (one per ``GWBLikelihood.build_blocks`` evaluation);
    - ``hd_outer_solves``: cross-correlated (Npsr*m)^2 outer-system
      factorizations evaluated (grid points swept, padding included);
    - ``gwb_solves``: supervised sweep-chunk dispatches.
    """

    _COUNTERS = ("gwb_solves", "block_assemblies", "hd_outer_solves")

    def __init__(self):
        from pint_tpu_torch.obs import metrics as om

        self.scope = om.new_scope("pta")
        self._c = {
            name: om.counter(
                f"pint_tpu_pta_{name}_total",
                f"GWB plane {name.replace('_', ' ')}"
            ).child(scope=self.scope)
            for name in self._COUNTERS}

    def bump(self, name: str, n: int = 1):
        self._c[name].inc(n)

    def __getattr__(self, name):
        c = self.__dict__.get("_c", {})
        if name in c:
            return int(c[name].value())
        raise AttributeError(name)

    def snapshot(self) -> dict:
        """Derived view of the registry children."""
        return {name: int(child.value())
                for name, child in self._c.items()}
