"""TimingModel core: Component registry + the delay/phase engine
(a port of pint_tpu/models/timing_model.py; reference:
src/pint/models/timing_model.py).

Host Python owns parameters, registries and orchestration; the delay and
phase stack is one eager function over

    (pv: dict[name, DD of 0-d tensors], batch: ToaBatch,
     cache: {"main": {...}, "tzr": {...}, "tzr_batch": ToaBatch})

on the model's device. ``pv`` comes from the packed parameter vector
(``_pack``, double-double so F0-class values keep 31 digits), ``cache``
holds host-precomputed per-TOA tensors (masks) and the TZR mini-batch.

The phase runs the direct double-double chain on any device: IEEE f64 is
correctly rounded on the GPU as on the CPU, so the reference's CPU
pinning of this chain (it exists for the TPU's emulated f64) is not
ported.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.models.convert import params_from_packed
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    Parameter,
    boolParameter,
    floatParameter,
    intParameter,
    strParameter,
)
from pint_tpu_torch.ops.dd import DD, dd_add, dd_add_f, dd_mul_f, dd_sub, \
    dd_sub_f
from pint_tpu_torch.phase import Phase

SECS_PER_DAY = 86400.0

# Registry: class name → Component subclass (reference: ModelMeta /
# Component.component_types).
component_types: Dict[str, type] = {}

# Fixed evaluation order of delay categories (reference:
# TimingModel.DEFAULT_ORDER) then phase categories.
DELAY_CATEGORY_ORDER = [
    "astrometry",
    "solar_system_shapiro",
    "troposphere",
    "solar_wind",
    "solar_windx",
    "dispersion",
    "chromatic",
    "chromatic_cmx",
    "cmwavex",
    "frequency_dependent",
    "fdjump",
    "wavex",
    "pulsar_system",  # binary: must be LAST so delay_so_far includes
    # every ISM/geometric delay when converting to pulsar-frame time
]
PHASE_CATEGORY_ORDER = [
    "spindown",
    "glitch",
    "wave",
    "ifunc",
    "phase_jump",
    "phase_offset",
]


class Component:
    """Base model component: a bag of Parameters plus device functions."""

    category = "misc"
    register = True

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.__dict__.get("register", True) and \
                not cls.__name__.startswith("_"):
            component_types[cls.__name__] = cls

    def __init__(self):
        self.params: Dict[str, Parameter] = {}
        self._parent: Optional["TimingModel"] = None

    def add_param(self, p: Parameter) -> Parameter:
        self.params[p.name] = p
        return p

    def __getattr__(self, name):
        params = self.__dict__.get("params")
        if params and name in params:
            return params[name]
        raise AttributeError(
            f"{type(self).__name__} has no attribute/param {name!r}")

    # -- lifecycle hooks (host) ---------------------------------------

    def setup(self):
        """Called after par parsing: materialize prefix/mask families."""

    def validate(self):
        """Raise on missing/contradictory parameters."""

    def param_dimensions(self) -> dict:
        """{param name or 'PREFIX*': units.Unit or callable(name) ->
        Unit}, checked against declared units at model build time
        (pint_tpu_torch.units.check_model_units)."""
        return {}

    def prepare(self, toas, cache: dict, prefix: str = ""):
        """Host precompute into `cache` (numpy masks etc.) for these
        TOAs; get_cache moves every array to the model's device."""


class DelayComponent(Component):
    category = "delay"

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        """This component's delay [seconds] as f64 (N,). `pv` maps param
        name → DD scalar; `delay_so_far` is the accumulated f64 delay of
        earlier categories."""
        raise NotImplementedError


class PhaseComponent(Component):
    category = "phase"

    def phase(self, pv, batch, cache, ctx, tb: DD) -> DD:
        """This component's phase [turns] as DD (N,). `tb` is barycentric
        time as DD seconds since the model's ref epoch."""
        raise NotImplementedError


class MiscParams(Component):
    """Header/control parameters that drive no physics directly
    (reference: these live on TimingModel itself)."""

    category = "misc"

    def __init__(self):
        super().__init__()
        self.add_param(strParameter("PSR", description="pulsar name",
                                    aliases=["PSRJ", "PSRB"]))
        self.add_param(strParameter("EPHEM", description="ephemeris name"))
        self.add_param(strParameter("CLK", description="clock realization"))
        self.add_param(strParameter("UNITS", value="TDB"))
        self.add_param(strParameter("TIMEEPH"))
        self.add_param(strParameter("T2CMETHOD"))
        self.add_param(strParameter("DILATEFREQ"))
        self.add_param(boolParameter("PLANET_SHAPIRO", value=False))
        self.add_param(MJDParameter("START"))
        self.add_param(MJDParameter("FINISH"))
        self.add_param(intParameter("NTOA"))
        self.add_param(floatParameter("CHI2", units=""))
        self.add_param(floatParameter("TRES", units="us"))
        self.add_param(strParameter("INFO"))
        self.add_param(strParameter("MODE"))

    def param_dimensions(self):
        from pint_tpu_torch.units import DIMENSIONLESS, parse_unit

        return {"START": parse_unit("d"), "FINISH": parse_unit("d"),
                "CHI2": DIMENSIONLESS, "TRES": parse_unit("us")}


def _category_rank(comp: Component) -> int:
    cats = DELAY_CATEGORY_ORDER + PHASE_CATEGORY_ORDER
    try:
        return cats.index(comp.category)
    except ValueError:
        return len(cats)


class TimingModel:
    """Ordered component container + eager evaluation engine. ``device``
    (None means "cuda") is where phase() and delay() run unless they are
    given another."""

    def __init__(self, components: Optional[List[Component]] = None,
                 name: str = "", device=None):
        self.name = name
        self.device = resolve_device(device)
        self.components: Dict[str, Component] = {}
        self._cache = None
        self._cache_key = None
        if not any(isinstance(c, MiscParams) for c in components or []):
            self.add_component(MiscParams())
        for c in components or []:
            self.add_component(c)

    # ---------------- component / parameter plumbing -----------------

    def add_component(self, comp: Component, setup=True):
        comp._parent = self
        self.components[type(comp).__name__] = comp
        if setup:
            comp.setup()
        self.invalidate_cache()

    @property
    def delay_components(self) -> List[DelayComponent]:
        out = [c for c in self.components.values()
               if isinstance(c, DelayComponent)]
        return sorted(out, key=_category_rank)

    @property
    def phase_components(self) -> List[PhaseComponent]:
        out = [c for c in self.components.values()
               if isinstance(c, PhaseComponent)]
        return sorted(out, key=_category_rank)

    def _ordered_components(self):
        return sorted(self.components.values(), key=_category_rank)

    def get_param(self, name: str) -> Parameter:
        for c in self.components.values():
            if name in c.params:
                return c.params[name]
            for p in c.params.values():
                if name in p.aliases:
                    return p
        raise KeyError(f"model has no parameter {name!r}")

    def __getattr__(self, name):
        if name.startswith("_") or name in ("components",):
            raise AttributeError(name)
        comps = self.__dict__.get("components") or {}
        for c in comps.values():
            if name in c.params:
                return c.params[name]
        for c in comps.values():
            for p in c.params.values():
                if name in p.aliases:
                    return p
        raise AttributeError(f"model has no parameter {name!r}")

    # ---------------- parameter packing -------------------------------

    def _device_params(self) -> List[Parameter]:
        """Numeric parameters visible to device code, in component order.
        str/bool/int params are host-only statics."""
        from pint_tpu_torch.models.parameter import pairParameter

        out = []
        for c in self._ordered_components():
            for p in c.params.values():
                if isinstance(p, (strParameter, boolParameter,
                                  intParameter, pairParameter)):
                    continue
                if p.value is None:
                    continue
                out.append(p)
        return out

    def _pack(self):
        dev = self._device_params()
        free = [p for p in dev if not p.frozen]
        frozen = [p for p in dev if p.frozen]
        th = np.array([p.dd[0] for p in free])
        tl = np.array([p.dd[1] for p in free])
        fh = np.array([p.dd[0] for p in frozen])
        fl = np.array([p.dd[1] for p in frozen])
        return ([p.name for p in free], [p.name for p in frozen],
                th, tl, fh, fl)

    # ---------------- evaluation ---------------------------------------

    @property
    def ref_day(self) -> float:
        """Integer MJD all device times are relative to."""
        cached = self.__dict__.get("_ref_day")
        if cached is not None:
            return cached
        day = None
        for nm in ("PEPOCH", "POSEPOCH", "TZRMJD"):
            try:
                p = self.get_param(nm)
                if p.value is not None:
                    day = float(np.round(p.value))
                    break
            except KeyError:
                continue
        self._ref_day = day if day is not None else 55000.0
        return self._ref_day

    def _delay_tb(self, pv, batch, cache, sub: str):
        """The delay chain + delay-subtracted barycentric time."""
        ctx: dict = {}
        delay = torch.zeros_like(batch.freq_mhz)
        for comp in self.delay_components:
            delay = delay + comp.delay(pv, batch, cache[sub], ctx, delay)
        tb = dd_mul_f(dd_addf_day(batch, self.ref_day), SECS_PER_DAY)
        tb = dd_sub_f(tb, delay)
        ctx["tb"] = tb
        return delay, tb, ctx

    def _raw_phase_fn(self, pv, batch, cache, sub: str):
        """The full delay→phase chain, absolute dd. Components with
        ``apply_to_tzr = False`` (PhaseOffset) are left out of the TZR
        row."""
        delay, tb, ctx = self._delay_tb(pv, batch, cache, sub)
        phase = DD(torch.zeros_like(delay), torch.zeros_like(delay))
        for comp in self.phase_components:
            if sub == "tzr" and not getattr(comp, "apply_to_tzr", True):
                continue
            phase = dd_add(phase, comp.phase(pv, batch, cache[sub], ctx, tb))
        return phase, delay

    def phase_fn(self, pv, batch, cache):
        """(phase DD, delay) for ``batch`` from the parameter dict ``pv``
        (see models.convert.params_from_packed); with a "tzr_batch" in
        ``cache`` the phase is referenced to the TZR point. The eager
        counterpart of the reference's jitted ``_build_phase_fn``."""
        phase, delay = self._raw_phase_fn(pv, batch, cache, "main")
        if "tzr_batch" in cache:
            tzr_phase, _ = self._raw_phase_fn(pv, cache["tzr_batch"], cache,
                                              "tzr")
            phase = dd_sub(phase, DD(tzr_phase.hi[0], tzr_phase.lo[0]))
        return phase, delay

    def invalidate_cache(self):
        """Drop the per-TOAs cache and the derived reference day."""
        self._cache = None
        self._cache_key = None
        self.__dict__.pop("_ref_day", None)

    def get_cache(self, toas, device=None) -> dict:
        """Per-TOAs device data: the batch, host-precomputed masks
        moved to ``device`` (the model's by default), and the TZR
        mini-batch. One slot, keyed on the TOAs state and the device."""
        dev = self.device if device is None else resolve_device(device)
        key = (getattr(toas, "cache_key", None) or id(toas), str(dev))
        if self._cache is not None and self._cache_key == key:
            return self._cache
        cache: dict = {"main": {}, "tzr": {},
                       "batch": toas.to_batch(dev)}
        for comp in self._ordered_components():
            comp.prepare(toas, cache["main"], prefix="")
        tzr_toas = self._make_tzr_toas(toas)
        if tzr_toas is not None:
            cache["tzr_batch"] = tzr_toas.to_batch(dev)
            for comp in self._ordered_components():
                comp.prepare(tzr_toas, cache["tzr"], prefix="tzr_")
        for sub in ("main", "tzr"):
            cache[sub] = {k: torch.as_tensor(v, dtype=torch.float64,
                                             device=dev)
                          for k, v in cache[sub].items()}
        self._cache = cache
        self._cache_key = key
        return cache

    def _make_tzr_toas(self, toas):
        """Build the one-TOA TZR set (reference:
        src/pint/models/absolute_phase.py AbsPhase.get_TZR_toa)."""
        if "AbsPhase" not in self.components:
            return None
        comp = self.components["AbsPhase"]
        if comp.TZRMJD.value is None:
            return None
        from pint_tpu_torch.toa import get_TOAs_array

        site = comp.TZRSITE.value or "ssb"
        freq = comp.TZRFRQ.value
        freq = np.inf if freq in (None, 0.0) else float(freq)
        day, frac = comp.TZRMJD.day_frac
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return get_TOAs_array(
                (np.array([day]), (np.array([frac[0]]),
                                   np.array([frac[1]]))),
                obs=site, freqs=freq, errors=1.0,
                ephem=self.EPHEM.value,
                planets=bool(self.PLANET_SHAPIRO.value),
                device=self.device)

    def _evaluate(self, toas, abs_phase, device):
        dev = self.device if device is None else resolve_device(device)
        cache = self.get_cache(toas, dev)
        if not abs_phase:
            cache = {k: v for k, v in cache.items() if k != "tzr_batch"}
        pv = params_from_packed(*self._pack(), device=dev)
        return self.phase_fn(pv, cache["batch"], cache)

    def phase(self, toas, abs_phase=True, device=None) -> Phase:
        """Total pulse phase at each TOA (reference: TimingModel.phase).
        With abs_phase and a TZR point, phase is anchored there. Runs on
        ``device``, the model's device when None."""
        phase, _ = self._evaluate(toas, abs_phase, device)
        return Phase(phase)

    def delay(self, toas, device=None) -> torch.Tensor:
        """Total barycentering delay [s] (reference:
        TimingModel.delay)."""
        _, delay = self._evaluate(toas, True, device)
        return delay

    def validate(self):
        for c in self.components.values():
            c.validate()
        from pint_tpu_torch.units import check_model_units

        check_model_units(self)

    def __repr__(self):
        comps = ", ".join(self.components)
        return f"<TimingModel {self.name or '?'} [{comps}] on {self.device}>"


# ---------------- small device helpers ----------------


def dd_addf_day(batch, ref_day: float) -> DD:
    """(tdb - ref_day) in days as DD: exact integer-day difference plus
    the dd fraction."""
    return dd_add_f(batch.tdb_frac, batch.tdb_day - ref_day)
