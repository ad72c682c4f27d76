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
    maskParameter,
    strParameter,
)
from pint_tpu_torch.ops.dd import DD, dd_add, dd_add_f, dd_frac, dd_mul_f, \
    dd_sub, dd_sub_f
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

    def remove_param(self, name: str):
        del self.params[name]

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

    # -- hybrid-Jacobian hooks (see TimingModel.linear_design_columns) -

    def linear_design_names(self) -> List[str]:
        """FREE params of this component whose design-matrix columns
        have a closed form (no AD tangent needed). Must agree with
        linear_design_local's claims."""
        return []

    def linear_design_local(self, pv, batch, cache, ctx) -> dict:
        """{claimed name: (kind, g)} with kind "pre_delay" (g =
        d(own delay)/d(param) [s/unit]; the model multiplies by the
        shared pre-binary stage sensitivity d(phase)/d(delay)) or
        "phase" (g = d(phase)/d(param) [turns/unit], used directly),
        evaluated at the current pv."""
        return {}

    # -- conveniences --------------------------------------------------

    @property
    def param_names(self) -> List[str]:
        return list(self.params)

    def mask_params_of(self, prefix: str) -> List[maskParameter]:
        return [p for p in self.params.values()
                if isinstance(p, maskParameter) and p.prefix == prefix]


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


def frozen_value(param, fallback=None):
    """The host value of a parameter that device code reads as a plain
    number: reference epochs (WXEPOCH, DMWXEPOCH, CMEPOCH, CMWXEPOCH and
    their PEPOCH fallback) and the solar-wind model switch SWM. That is
    sound only while the parameter is frozen: no tangent flows through a
    host number, so fitting such a parameter would leave its design
    column zero. A free one raises the reference's ValueError
    (frozen_trace_value). ``fallback`` (another Parameter) is read, under
    the same rule, when ``param`` has no value."""
    if not param.frozen:
        raise ValueError(
            f"{param.name} is free, but device code reads its value as a "
            f"constant: fitting it is not supported; freeze {param.name}")
    if param.value is not None:
        return float(param.value)
    if fallback is not None:
        return frozen_value(fallback)
    return None


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

    def remove_component(self, name: str):
        del self.components[name]
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

    @property
    def params(self) -> List[str]:
        out = []
        for c in self.components.values():
            out.extend(c.params)
        return out

    @property
    def free_params(self) -> List[str]:
        out = []
        for c in self._ordered_components():
            for p in c.params.values():
                if not p.frozen and p.value is not None:
                    out.append(p.name)
        return out

    # -------- introspection helpers (reference: TimingModel API) ------

    def get_params_of_type(self, param_type: str) -> List[str]:
        """Parameter names whose class (or any base class) matches
        ``param_type`` (e.g. 'maskParameter'; 'floatParameter' includes
        the mask and prefix subclasses, as the reference's
        get_params_of_type_top)."""
        want = param_type.lower()
        out = []
        for c in self.components.values():
            for p in c.params.values():
                if any(cls.__name__.lower() == want
                       for cls in type(p).__mro__):
                    out.append(p.name)
        return out

    def get_prefix_mapping(self, prefix: str) -> Dict[int, str]:
        """{index: name} for every parameter of the given prefix family,
        e.g. get_prefix_mapping('DMX_') -> {1: 'DMX_0001', ...}."""
        out: Dict[int, str] = {}
        for c in self.components.values():
            for p in c.params.values():
                if getattr(p, "prefix", None) == prefix:
                    out[p.index] = p.name
        return dict(sorted(out.items()))

    @property
    def components_by_category(self) -> Dict[str, List[str]]:
        """{category: [component names]} in evaluation order (reference:
        TimingModel.get_components_by_category)."""
        out: Dict[str, List[str]] = {}
        for c in self._ordered_components():
            out.setdefault(c.category, []).append(type(c).__name__)
        return out

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

    def __contains__(self, name):
        try:
            self.get_param(name)
            return True
        except KeyError:
            return False

    def set_param_values(self, values: Dict[str, float]):
        """Set parameter values by name; the next evaluation uses them."""
        for k, v in values.items():
            self.get_param(k).value = v
        self.invalidate_cache(params_only=True)

    def get_param_values(self, names=None) -> Dict[str, float]:
        names = names if names is not None else self.free_params
        return {n: self.get_param(n).value for n in names}

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

    def _delay_tb(self, pv, batch, cache, sub: str,
                  pre_binary_shift=None):
        """The delay chain + delay-subtracted barycentric time.
        ``pre_binary_shift`` is added to the accumulated delay just
        before the pulsar_system components (or at the end without
        one): the probe of the hybrid Jacobian's stage sensitivity."""
        ctx: dict = {}
        delay = torch.zeros_like(batch.freq_mhz)
        shifted = pre_binary_shift is None
        for comp in self.delay_components:
            if not shifted and comp.category == "pulsar_system":
                delay = delay + pre_binary_shift
                shifted = True
            delay = delay + comp.delay(pv, batch, cache[sub], ctx, delay)
        if not shifted:
            delay = delay + pre_binary_shift
        tb = dd_mul_f(dd_addf_day(batch, self.ref_day), SECS_PER_DAY)
        tb = dd_sub_f(tb, delay)
        ctx["tb"] = tb
        return delay, tb, ctx

    def _raw_phase_fn(self, pv, batch, cache, sub: str,
                      pre_binary_shift=None):
        """The full delay→phase chain, absolute dd. Components with
        ``apply_to_tzr = False`` (PhaseOffset) are left out of the TZR
        row."""
        delay, tb, ctx = self._delay_tb(pv, batch, cache, sub,
                                        pre_binary_shift)
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

    def _build_phase_fn(self):
        """(phase_fn(th, tl, fh, fl, batch, cache), (free, frozen)): the
        phase function of packed parameter vectors, as the reference's
        ``_build_phase_fn`` returns it; a thin wrapper over phase_fn."""
        free_names, frozen_names, *_ = self._pack()

        def fn(th, tl, fh, fl, batch, cache):
            return self.phase_fn(make_pv(free_names, frozen_names, th, tl,
                                         fh, fl), batch, cache)

        return fn, (free_names, frozen_names)

    # -------- anchored delta phase (the opt-in anchored route) --------
    #
    # The direct chain above carries the absolute pulse phase (~1e10
    # turns) in dd. The anchored form removes every large intermediate:
    # the host computes the exact reference phase and delays once, and
    # the step evaluates only the difference
    #   Delta = taylor(x, F - F_ref)                      [<= turns]
    #         + sum_i F_ref,i (x^(i+1) - y^(i+1))/(i+1)!  [powdiff,
    #           applied through the small difference d_ref - d]
    #         + (phi_other(theta) - phi_other(theta_ref)) [small]
    # (ops.taylor.taylor_powdiff). The reference needs it because TPU
    # float64 is emulated; on IEEE float64 it is an opt-in route
    # (parallel.fit_step, $PINT_TPU_ANCHORED).

    def _phase_pieces(self, pv, batch, cache, sub: str, skip=()):
        """(delay, tb_dd, other_phase): the delay chain, the
        delay-subtracted barycentric time, and the summed phase (hi +
        lo) of every PhaseComponent except those whose class name is in
        ``skip``."""
        delay, tb, ctx = self._delay_tb(pv, batch, cache, sub)
        other = torch.zeros_like(delay)
        for comp in self.phase_components:
            if type(comp).__name__ in skip:
                continue
            if sub == "tzr" and not getattr(comp, "apply_to_tzr", True):
                continue
            p = comp.phase(pv, batch, cache[sub], ctx, tb)
            other = other + (p.hi + p.lo)
        return delay, tb, other

    def supports_anchored(self) -> bool:
        """The anchored route needs Spindown with a frozen, set PEPOCH."""
        spin = self.components.get("Spindown")
        return spin is not None and "PEPOCH" not in self.free_params \
            and spin.PEPOCH.value is not None

    def build_anchor(self, toas, device=None):
        """(anchor arrays, anchor statics) of the anchored route: the
        reference fractional phase, the reference delays and non-spindown
        phase sums (main and TZR rows), computed once on the CPU in
        float64 dd from the cache the step is built on (``device``, the
        model's by default); the arrays are numpy. The statics hold the
        reference F coefficients, which of them are free, the PEPOCH
        shift and the time scale of ``taylor_powdiff``."""
        if not self.supports_anchored():
            raise ValueError("anchored step needs Spindown with a "
                             "frozen PEPOCH")
        free, frozen, th0, tl0, fh0, fl0 = self._pack()
        cache = _to_host(self.get_cache(toas, device))
        batch = cache["batch"]
        spin = self.components["Spindown"]
        pv0 = params_from_packed(free, frozen, th0, tl0, fh0, fl0,
                                 device="cpu")
        with torch.no_grad():
            ph, _ = self.phase_fn(pv0, batch, cache)
            fr = dd_frac(ph)
            d_ref, _, oth_ref = self._phase_pieces(
                pv0, batch, cache, "main", skip=("Spindown",))
            anc = {"r_ref": (fr.hi + fr.lo).numpy(),
                   "d_ref": d_ref.numpy(), "oth_ref": oth_ref.numpy()}
            if "tzr_batch" in cache:
                d_t, _, o_t = self._phase_pieces(
                    pv0, cache["tzr_batch"], cache, "tzr",
                    skip=("Spindown",))
                anc["d_ref_tzr"] = d_t.numpy()
                anc["oth_ref_tzr"] = o_t.numpy()
        fnames = spin.f_terms()
        name_to_val = {nm: th0[i] + tl0[i] for i, nm in enumerate(free)}
        name_to_val.update({nm: fh0[j] + fl0[j]
                            for j, nm in enumerate(frozen)})
        anc_static = {
            "fnames": fnames,
            "fref": [float(name_to_val[nm]) for nm in fnames],
            "fidx": [free.index(nm) if nm in free else None
                     for nm in fnames],
            "pepoch_shift": (float(spin.PEPOCH.value) - self.ref_day)
            * SECS_PER_DAY,
        }
        mjd = batch.tdb_day.numpy() + batch.tdb_frac.hi.numpy()
        anc_static["t_scale"] = max(
            float(np.max(np.abs((mjd - self.ref_day) * SECS_PER_DAY
                                - anc_static["pepoch_shift"]))), 1.0) \
            * 1.05
        return anc, anc_static

    def _build_anchored_fn(self, anc_static):
        """fn(dth, dtl, fh, fl, batch, cache) -> (frac_resid, delay),
        with ``fn.pv_of(dth, dtl, fh, fl)`` its parameter dict (for the
        step's auxiliary channels: the DM rows, the hybrid columns).

        (dth, dtl) is the exact delta theta - theta_ref of the free
        parameters; (fh, fl) are the full frozen pairs, the build-time
        values unless a caller substitutes others (``grid_chisq`` varies
        frozen parameters through these slots). batch and cache may be
        float64 or their float32/dd32 conversions (the dtype follows
        dth); cache["anchor"] holds ``build_anchor``'s arrays. The
        reference pairs reach each device once, at the first call in a
        dtype, so that later calls copy nothing from the host."""
        from pint_tpu_torch.ops.dd import dd_to_dd32, dd_to_f64
        from pint_tpu_torch.ops.taylor import taylor_horner, taylor_powdiff

        free, frozen, th0, tl0, fh0, fl0 = self._pack()
        fnames = anc_static["fnames"]
        fref = anc_static["fref"]
        fidx = anc_static["fidx"]
        # frozen-slot index of each F term (grid-varied frozen Fs)
        fjdx = [frozen.index(nm) if nm in frozen else None
                for nm in fnames]
        pep = anc_static["pepoch_shift"]
        t_scale = anc_static["t_scale"]
        ref_day = self.ref_day
        refs: dict = {}

        def reference(like):
            """The build-time (free, frozen) pairs in ``like``'s dtype
            (dd32-split for the float32 Jacobian) on its device."""
            key = (like.dtype, str(like.device))
            if key not in refs:
                src = (th0, tl0, fh0, fl0)
                if like.dtype == torch.float32:
                    src = tuple(dd_to_dd32(DD(np.asarray(th0),
                                              np.asarray(tl0)))) + \
                        tuple(dd_to_dd32(DD(np.asarray(fh0),
                                            np.asarray(fl0))))
                refs[key] = tuple(torch.as_tensor(a, dtype=like.dtype,
                                                  device=like.device)
                                  for a in src)
            return refs[key]

        def pv_of(dth, dtl, fh, fl):
            """The parameter dict at the reference + delta point."""
            rh, rl, _, _ = reference(dth)
            pv = {nm: dd_add(DD(rh[i], rl[i]), DD(dth[i], dtl[i]))
                  for i, nm in enumerate(free)}
            pv.update({nm: DD(fh[j], fl[j]) for j, nm in enumerate(frozen)})
            return pv

        def fn(dth, dtl, fh, fl, batch, cache):
            _, _, qh, ql = reference(dth)
            delta = dth + dtl
            pv = pv_of(dth, dtl, fh, fl)
            # frozen deltas against the anchor (zero unless a caller
            # substituted values through fh/fl)
            fdelta = dd_to_f64(dd_sub(DD(fh, fl), DD(qh, ql)))
            anc = cache["anchor"]

            def delta_phase(batch_x, sub, d_ref, oth_ref):
                d, _, oth = self._phase_pieces(pv, batch_x, cache, sub,
                                               skip=("Spindown",))
                # x = seconds since PEPOCH at the current delay
                t_rel = (batch_x.tdb_day - ref_day) * SECS_PER_DAY \
                    + (batch_x.tdb_frac.hi + batch_x.tdb_frac.lo) \
                    * SECS_PER_DAY
                x = t_rel - d - pep
                dxy = d_ref - d      # small: a cancellation of ~500 s
                coeffs = [0.0]
                for k in range(len(fnames)):
                    if fidx[k] is not None:
                        coeffs.append(delta[fidx[k]])
                    elif fjdx[k] is not None:
                        coeffs.append(fdelta[fjdx[k]])
                    else:
                        coeffs.append(0.0)
                A = taylor_horner(x, coeffs)
                B = taylor_powdiff(x, dxy, [0.0] + fref, t_scale=t_scale)
                return A + B + (oth - oth_ref), d

            dphi, d_main = delta_phase(batch, "main", anc["d_ref"],
                                       anc["oth_ref"])
            if "tzr_batch" in cache:
                dphi_t, _ = delta_phase(cache["tzr_batch"], "tzr",
                                        anc["d_ref_tzr"],
                                        anc["oth_ref_tzr"])
                dphi = dphi - dphi_t[0]
            v = anc["r_ref"] + dphi
            return v - torch.round(v), d_main

        fn.pv_of = pv_of
        return fn

    # -------- hybrid Jacobian: closed-form design columns -------------
    #
    # Every non-binary delay component is additive before the binary
    # stage, so d(phase)/d(p) = S_pre(t) * d(delay_comp)/d(p) with ONE
    # shared stage sensitivity S_pre = d(phase)/d(shift) (one JVP), and
    # phase-linear params (JUMP, PHOFF, spin F1+) have direct columns.
    # With the hybrid split on, the design Jacobian drops all such params
    # from the jacfwd tangent set. It is off by default: run eagerly, the
    # columns' second chain pass costs more than the tangents they save
    # (see parallel.fit_step._build_fit_core).

    def _abs_phase_shift(self, pv, batch, cache, sub: str, s):
        ph, _ = self._raw_phase_fn(pv, batch, cache, sub,
                                   pre_binary_shift=s)
        return ph.hi + ph.lo

    def linear_design_names(self) -> set:
        """Free-param names with closed-form design columns."""
        free = set(self.free_params)
        out: set = set()
        for comp in self.components.values():
            out |= set(comp.linear_design_names()) & free
        return out

    def _ld_rows(self, pv, batch, cache, sub: str, names):
        dt = batch.freq_mhz.dtype
        dev = batch.freq_mhz.device
        delay, tb, ctx = self._delay_tb(pv, batch, cache, sub)
        local = []  # (name, kind, g); same-name claims add up
        for comp in self._ordered_components():
            if sub == "tzr" and not getattr(comp, "apply_to_tzr", True):
                continue
            for nm, (kind, g) in comp.linear_design_local(
                    pv, batch, cache[sub], ctx).items():
                if nm in names:
                    local.append((nm, kind, g))
        # the stage-sensitivity JVP costs one full-chain tangent pass:
        # paid only when some claim is delay-kind
        s_pre = None
        if any(kind == "pre_delay" for _, kind, _ in local):
            zero = torch.zeros((), dtype=dt, device=dev)

            def f(s):
                return self._abs_phase_shift(pv, batch, cache, sub, s)

            _, s_pre = torch.func.jvp(f, (zero,), (torch.ones_like(zero),))
        out: dict = {}
        for nm, kind, g in local:
            contrib = s_pre * g if kind == "pre_delay" else g
            out[nm] = out[nm] + contrib if nm in out else contrib
        return out

    def linear_design_columns(self, pv, batch, cache, names) -> dict:
        """{name: exact d(phase)/d(param) column [turns/unit]} for the
        claimed ``names``, including the TZR-row subtraction (what
        jacfwd of the TZR-referenced phase gives)."""
        main = self._ld_rows(pv, batch, cache, "main", names)
        if "tzr_batch" in cache:
            tzr = self._ld_rows(pv, cache["tzr_batch"], cache, "tzr",
                                names)
            # a claim can be absent from the tzr row (apply_to_tzr =
            # False components, e.g. PhaseOffset): no subtraction then
            return {nm: main[nm] - tzr[nm][0] if nm in tzr
                    else main[nm] for nm in names}
        return main

    def design_jacobian(self, th, tl, fh, fl, batch, cache,
                        hybrid: bool = False):
        """(N, p) d(phase)/d(free_j) [turns/unit] at the packed point:
        ``torch.func.jacfwd`` tangents, or with ``hybrid`` closed-form
        columns for linear_design_names and tangents for the rest."""
        phase_fn, (free, frozen) = self._build_phase_fn()
        lin = self.linear_design_names() if hybrid else set()
        nl_idx = [i for i, nm in enumerate(free) if nm not in lin]
        if nl_idx:
            idx = torch.as_tensor(nl_idx, device=th.device)

            def sub(th_nl):
                ph, _ = phase_fn(th.index_put((idx,), th_nl), tl, fh, fl,
                                 batch, cache)
                return ph.hi + ph.lo

            jac_nl = torch.func.jacfwd(sub)(th[idx])
        if lin:
            cols = self.linear_design_columns(
                make_pv(free, frozen, th, tl, fh, fl), batch, cache, lin)
        out, k = [], 0
        for nm in free:
            if nm in lin:
                out.append(cols[nm])
            else:
                out.append(jac_nl[:, k])
                k += 1
        if not out:
            return torch.zeros((batch.freq_mhz.shape[0], 0),
                               dtype=batch.freq_mhz.dtype,
                               device=batch.freq_mhz.device)
        return torch.stack(out, dim=1)

    def designmatrix(self, toas, incoffset=True, device=None):
        """(M, names, units): M[i,j] = d(time-resid_i)/d(free-param_j)
        [s / param-unit] as a float64 tensor on ``device`` (the model's
        by default), with a leading offset column when incoffset
        (reference: TimingModel.designmatrix). PHOFF, when present,
        replaces the implicit offset column."""
        if "PhaseOffset" in self.components:
            incoffset = False
        dev = self.device if device is None else resolve_device(device)
        cache = self.get_cache(toas, dev)
        free, _, th, tl, fh, fl = self._pack()
        t = [torch.as_tensor(np.asarray(x, np.float64), device=dev)
             for x in (th, tl, fh, fl)]
        jac = self.design_jacobian(*t, cache["batch"], cache)
        f0 = self.F0.value
        M = jac / f0
        names = list(free)
        if incoffset:
            M = torch.cat([torch.full((M.shape[0], 1), 1.0 / f0,
                                      dtype=M.dtype, device=dev), M], dim=1)
            names = ["Offset"] + names
        units = ["turn"] + [self.get_param(n).units for n in free] \
            if incoffset else [self.get_param(n).units for n in free]
        return M, names, units

    def d_phase_d_toa(self, toas, sample_step_s: float = 1.0,
                      device=None) -> np.ndarray:
        """Instantaneous topocentric pulse frequency [Hz] at each TOA
        (reference: TimingModel.d_phase_d_toa), as a float64 numpy
        array: the central difference of the FULL pipeline at
        +-sample_step_s. The shifted TOA sets re-run clock, ephemeris
        and barycentring on the host (so the Doppler of the Earth's
        motion is in it) and their phase runs on ``device`` (the
        model's when None); the two phases are subtracted in dd on the
        host, so the ~1e10-turn absolute phases cancel exactly. The
        model's TOA cache holds the caller's entry again afterwards."""
        from pint_tpu_torch.ops import dd_np
        from pint_tpu_torch.toa import get_TOAs_array

        dev = self.device if device is None else resolve_device(device)
        step_d = sample_step_s / SECS_PER_DAY
        # the caller's mjd_frac is already clock-corrected and
        # get_TOAs_array corrects again: undo the correction first
        clk = np.zeros(toas.ntoas)
        if getattr(toas, "clock_applied", False):
            clk = np.array([float(f.get("clkcorr", 0.0))
                            for f in toas.flags])
        flags = [{k: v for k, v in f.items() if k != "clkcorr"}
                 for f in toas.flags]
        saved = (self._cache, self._cache_key)
        phases = []
        try:
            for sign in (+1.0, -1.0):
                frac = dd_np.add_f(
                    (np.asarray(toas.mjd_frac[0]),
                     np.asarray(toas.mjd_frac[1])),
                    sign * step_d - clk / SECS_PER_DAY)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    t2 = get_TOAs_array(
                        (np.asarray(toas.mjd_day), frac),
                        obs=list(toas.obs), freqs=toas.freq_mhz,
                        errors=toas.error_us, ephem=self.EPHEM.value,
                        planets=bool(self.PLANET_SHAPIRO.value),
                        flags=flags, device=dev)
                ph = self.phase(t2, abs_phase=False, device=dev).turns
                phases.append((ph.hi.cpu().numpy(), ph.lo.cpu().numpy()))
        finally:
            self._cache, self._cache_key = saved
        diff = dd_np.sub(phases[0], phases[1])
        return dd_np.to_f64(diff) / (2.0 * sample_step_s)

    def d_phase_d_param(self, toas, param: str,
                        device=None) -> torch.Tensor:
        """d(phase)/d(param) [turns/unit] at each TOA (reference:
        TimingModel.d_phase_d_param), a float64 tensor on ``device`` (the
        model's when None): one ``torch.func.jacfwd`` column through the
        phase function design_jacobian differentiates, so it equals
        F0 times the parameter's designmatrix column."""
        dev = self.device if device is None else resolve_device(device)
        free, _, th, tl, fh, fl = self._pack()
        if param not in free:
            raise ValueError(f"{param} is not a free parameter")
        cache = self.get_cache(toas, dev)
        phase_fn, _ = self._build_phase_fn()
        th, tl, fh, fl = (torch.as_tensor(np.asarray(x, np.float64),
                                          device=dev)
                          for x in (th, tl, fh, fl))
        idx = torch.as_tensor([free.index(param)], device=dev)

        def phase_of(x):
            ph, _ = phase_fn(th.index_put((idx,), x), tl, fh, fl,
                             cache["batch"], cache)
            return ph.hi + ph.lo

        return torch.func.jacfwd(phase_of)(th[idx])[:, 0]

    # ---------------- wideband DM channel ------------------------------

    def dm_total_device(self, pv, batch, cache_sub):
        """Total model DM [pc/cm^3] per TOA, summed over every component
        with a ``dm_value_device`` (DM polynomial, DMX, DMJUMP, DMWaveX,
        the solar wind and SWX). With a solar-wind component, the one
        reader of ctx, astrometry's delay runs first, on a zero delay, to
        put the pulsar direction in ctx for its line of sight (the
        reference runs it always; without a reader it changes no value
        and costs ~120 launches a wideband step). Shared by build_dm_fn
        and the wideband fit step, so the two channels cannot
        disagree."""
        ctx: dict = {}
        dm = torch.zeros_like(batch.freq_mhz)
        if self._has_solar_wind():
            for c in self.delay_components:
                if c.category == "astrometry":
                    c.delay(pv, batch, cache_sub, ctx, dm)
        for c in self._ordered_components():
            if hasattr(c, "dm_value_device"):
                dm = dm + c.dm_value_device(pv, batch, cache_sub, ctx)
        return dm

    def _has_solar_wind(self) -> bool:
        """A SolarWindDispersion (NE_SW) is present: its DM reads the
        pulsar direction astrometry puts in ctx."""
        return any(c.category == "solar_wind"
                   for c in self.components.values())

    def dm_affecting_free_params(self) -> set:
        """Names whose tangents can move dm_total_device: the parameters
        of every component with a ``dm_value_device``, and astrometry's
        when a solar-wind component (NE_SW) reads the pulsar direction
        it puts in ctx (SWX's geometry columns are host data, so it adds
        none). The wideband step restricts the DM-row Jacobian to these
        columns; every other one is structurally zero."""
        names: set = set()
        for c in self.components.values():
            if hasattr(c, "dm_value_device"):
                names.update(c.params)
        if self._has_solar_wind():
            for c in self.components.values():
                if c.category == "astrometry":
                    names.update(c.params)
        return names

    def build_dm_fn(self, toas, device=None):
        """(dm_fn, (free_names, th)): dm_fn(th) -> model DM per TOA
        [pc/cm^3] as a float64 tensor on ``device`` (the model's by
        default), a function of the free parameters' high words that
        ``torch.func.jacfwd`` can differentiate; ``th`` is their value."""
        dev = self.device if device is None else resolve_device(device)
        cache = self.get_cache(toas, dev)
        batch, main = cache["batch"], cache["main"]
        free, frozen, th, tl, fh, fl = self._pack()
        th, tl, fh, fl = (torch.as_tensor(np.asarray(x, np.float64),
                                          device=dev)
                          for x in (th, tl, fh, fl))

        def dm_fn(thx):
            return self.dm_total_device(
                make_pv(free, frozen, thx, tl, fh, fl), batch, main)

        return dm_fn, (free, th)

    def total_dm(self, toas, device=None) -> torch.Tensor:
        """Model DM at each TOA [pc/cm^3] (reference:
        TimingModel.total_dm)."""
        dm_fn, (_, th) = self.build_dm_fn(toas, device)
        return dm_fn(th)

    def as_ECL(self, ecl: str = "IERS2010") -> "TimingModel":
        """The model with ecliptic astrometry in the ``ecl`` obliquity
        convention (reference: TimingModel.as_ECL; see modelutils).
        Already ecliptic in the same convention returns self (not a
        copy); another convention converts through ICRS."""
        from pint_tpu_torch.models.astrometry import AstrometryEcliptic
        from pint_tpu_torch.modelutils import model_equatorial_to_ecliptic

        AstrometryEcliptic.obliquity_arcsec(ecl)  # strict, fail early
        cur = self.components.get("AstrometryEcliptic")
        if cur is not None:
            if (cur.ECL.value or "IERS2010").upper() == ecl.upper():
                return self
            return model_equatorial_to_ecliptic(self.as_ICRS(), ecl=ecl)
        return model_equatorial_to_ecliptic(self, ecl=ecl)

    def as_ICRS(self) -> "TimingModel":
        """The model with equatorial astrometry (reference:
        TimingModel.as_ICRS; see modelutils). Already equatorial returns
        self (not a copy)."""
        from pint_tpu_torch.modelutils import model_ecliptic_to_equatorial

        if "AstrometryEquatorial" in self.components:
            return self
        return model_ecliptic_to_equatorial(self)

    def invalidate_cache(self, params_only=False):
        """Drop the per-TOAs cache and the derived reference day.
        params_only=True (a parameter VALUE changed) keeps the per-TOAs
        cache and the noise bases: only the reference day is
        re-derived."""
        if not params_only:
            self._cache = None
            self._cache_key = None
            self.__dict__.pop("_noise_basis_cache", None)
            self.__dict__.pop("_noise_device_cache", None)
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

    def _host_psr_dir(self, toas) -> np.ndarray:
        """(N, 3) SSB->pulsar unit vectors (ICRS) at the catalogue
        position, without proper motion: for host precomputes whose
        dependence on astrometry updates is second order (the SWX
        geometry columns, the PLSWNoise basis)."""
        eq = self.components.get("AstrometryEquatorial")
        if eq is not None:
            a0, d0 = eq.RAJ.value, eq.DECJ.value
            n = np.array([np.cos(d0) * np.cos(a0),
                          np.cos(d0) * np.sin(a0), np.sin(d0)])
            return np.broadcast_to(n, (toas.ntoas, 3))
        ec = self.components.get("AstrometryEcliptic")
        if ec is not None:
            l0, b0 = ec.ELONG.value, ec.ELAT.value
            n_ecl = np.array([np.cos(b0) * np.cos(l0),
                              np.cos(b0) * np.sin(l0), np.sin(b0)])
            n = np.asarray(ec._ecl_matrix()) @ n_ecl
            return np.broadcast_to(n, (toas.ntoas, 3))
        raise ValueError("model has no astrometry component")

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

    # ---------------- noise-model aggregation -------------------------
    # (host numpy, as in the reference: the bases are static during a
    # least-squares fit; the fitters move them to the device once)

    @property
    def noise_components(self):
        out = [c for c in self.components.values()
               if getattr(c, "category", "") == "noise"]
        return sorted(out, key=lambda c: type(c).__name__)

    @property
    def has_correlated_errors(self) -> bool:
        return any(getattr(c, "is_basis_noise", False)
                   for c in self.noise_components)

    def scaled_toa_uncertainty(self, toas) -> np.ndarray:
        """Per-TOA white sigma [s] after EFAC/EQUAD scaling."""
        sigma2 = (toas.get_errors() * 1e-6) ** 2
        for c in self.noise_components:
            sigma2 = c.scale_toa_sigma_s2(toas, sigma2)
        return np.sqrt(sigma2)

    def scaled_dm_uncertainty(self, toas) -> np.ndarray:
        """Per-TOA wideband-DM sigma [pc/cm^3] after DMEFAC/DMEQUAD."""
        from pint_tpu_torch.wideband import get_wideband_dm

        _, dmerr = get_wideband_dm(toas)
        sigma2 = dmerr ** 2
        for c in self.noise_components:
            sigma2 = c.scale_dm_sigma2(toas, sigma2)
        return np.sqrt(sigma2)

    def noise_model_basis_weight_pairs(self, toas, exclude=(),
                                       tspan=None, tref_day=None):
        """[(component name, F, phi), ...] for every active basis,
        cached per (TOA state, noise hyperparameter values, exclude
        set); excluded components are never densified."""
        exclude = tuple(sorted(exclude))
        key = tuple(
            (p.name, p.value, getattr(p, "key", None),
             tuple(getattr(p, "key_value", ())))
            for c in self.noise_components for p in c.params.values()
        ) + (exclude, tspan, tref_day)
        cached = self.__dict__.get("_noise_basis_cache")
        serial = getattr(toas, "cache_key", None)
        if cached is not None and cached[0] is toas \
                and cached[1] == serial and cached[2] == key:
            return cached[3]
        out = []
        for c in self.noise_components:
            if not getattr(c, "is_basis_noise", False) or \
                    type(c).__name__ in exclude:
                continue
            pair = c.noise_basis_weight(toas, tspan=tspan,
                                         tref_day=tref_day)
            if pair is not None:
                out.append((type(c).__name__, pair[0], pair[1]))
        self._noise_basis_cache = (toas, serial, key, out)
        return out

    def noise_model_designmatrix(self, toas, exclude=(), tspan=None,
                                 tref_day=None):
        """Stacked (N, q) noise basis, or None when no basis is active."""
        pairs = self.noise_model_basis_weight_pairs(
            toas, exclude=exclude, tspan=tspan, tref_day=tref_day)
        if not pairs:
            return None
        return np.concatenate([F for _, F, _ in pairs], axis=1)

    def noise_model_basis_weight(self, toas, exclude=(), tspan=None,
                                 tref_day=None):
        """Stacked (q,) prior variances matching the designmatrix."""
        pairs = self.noise_model_basis_weight_pairs(
            toas, exclude=exclude, tspan=tspan, tref_day=tref_day)
        if not pairs:
            return None
        return np.concatenate([phi for _, _, phi in pairs])

    def noise_model_dm_designmatrix(self, toas, exclude=()):
        """(N, q) DM-channel block of the noise basis, column-aligned
        with ``noise_model_designmatrix(toas, exclude=exclude)``:
        components whose process is a DM perturbation (PLDMNoise) have a
        ``noise_dm_basis`` and couple into the wideband DM rows; all
        others contribute zeros. None when no basis is active."""
        pairs = self.noise_model_basis_weight_pairs(toas, exclude=exclude)
        if not pairs:
            return None
        comps = {type(c).__name__: c for c in self.noise_components}
        blocks = []
        for name, F, _ in pairs:
            comp = comps.get(name)
            if comp is not None and hasattr(comp, "noise_dm_basis"):
                blocks.append(np.asarray(comp.noise_dm_basis(toas,
                                                             F_time=F)))
            else:
                blocks.append(np.zeros_like(np.asarray(F)))
        return np.concatenate(blocks, axis=1)

    def noise_model_ecorr_segments(self, toas):
        """ECORR epoch-segment structure for the Sherman-Morrison GLS
        path: (epoch_ids (N,) int32 — value K means 'in no epoch' —,
        jvar (K+1,) per-epoch jitter variances [s^2] with jvar[K] = 0,
        consumed component names), or None when no segment-capable
        component is active or epochs overlap (callers then use the
        dense quantization basis)."""
        from pint_tpu_torch.models.noise import EcorrOverlapError

        eids, jvars, consumed = [], [], []
        for c in self.noise_components:
            fn = getattr(c, "noise_epoch_segments", None)
            if fn is None:
                continue
            try:
                seg = fn(toas)
            except EcorrOverlapError:
                return None
            if seg is not None:
                eids.append(seg[0])
                jvars.append(seg[1])
                consumed.append(type(c).__name__)
        if not eids:
            return None
        eid = np.full(toas.ntoas, -1, dtype=np.int32)
        jv: list = []
        for e, v in zip(eids, jvars):
            mask = e >= 0
            if np.any(eid[mask] >= 0):
                return None  # overlap across components: dense basis
            eid[mask] = e[mask] + len(jv)
            jv.extend(v.tolist())
        K = len(jv)
        eid[eid < 0] = K  # 'no epoch' slot with zero variance
        return eid, np.asarray(jv + [0.0]), tuple(consumed)

    def noise_model_dimensions(self, toas):
        """{component name: (start, length)} column spans in the stacked
        basis."""
        out = {}
        start = 0
        for name, F, _ in self.noise_model_basis_weight_pairs(toas):
            out[name] = (start, F.shape[1])
            start += F.shape[1]
        return out

    def noise_device(self, toas, device=None):
        """(nvec, F, phi) float64 tensors on ``device`` for the dense
        basis (F (N, 0) and phi (0,) without one), moved once per noise
        basis and kept beside it."""
        dev = self.device if device is None else resolve_device(device)
        pairs = self.noise_model_basis_weight_pairs(toas)
        nvec = self.scaled_toa_uncertainty(toas) ** 2
        cached = self.__dict__.get("_noise_device_cache")
        if cached is not None and cached[0] is pairs and \
                cached[1] == str(dev) and np.array_equal(cached[2], nvec):
            return cached[3]
        if pairs:
            F = np.concatenate([F for _, F, _ in pairs], axis=1)
            phi = np.concatenate([phi for _, _, phi in pairs])
        else:
            F, phi = np.zeros((toas.ntoas, 0)), np.ones(0)
        out = tuple(torch.as_tensor(np.asarray(x, np.float64), device=dev)
                    for x in (nvec, F, phi))
        self._noise_device_cache = (pairs, str(dev), nvec, out)
        return out

    def as_parfile(self) -> str:
        lines = []
        # the BINARY line names the binary component that is present
        binary = next(
            (name[len("Binary"):] for name in self.components
             if name.startswith("Binary")), None)
        if binary:
            lines.append(f"{'BINARY':<15} {binary:>25}\n")
        for c in self._ordered_components():
            for p in c.params.values():
                line = p.as_parfile_line()
                if line:
                    lines.append(line)
        return "".join(lines)

    def validate(self):
        for c in self.components.values():
            c.validate()
        from pint_tpu_torch.units import check_model_units

        check_model_units(self)

    def get_or_create_component(self, name: str):
        """components[name], made from the registry and attached when
        absent (used by the jump conversion)."""
        comp = self.components.get(name)
        if comp is None:
            comp = component_types[name]()
            self.add_component(comp)
        return comp

    def jump_flags_to_params(self, toas) -> list:
        """One free JUMP per distinct tim-file JUMP block (the
        ``-tim_jump`` flags the tim parser writes), making the PhaseJump
        component if needed (reference: jump_flags_to_params)."""
        if "PhaseJump" not in self.components and \
                not any("tim_jump" in f for f in toas.flags):
            return []
        return self.get_or_create_component(
            "PhaseJump").tim_jumps_to_params(toas)

    def compare(self, other: "TimingModel") -> str:
        """Parameter-by-parameter diff (reference: TimingModel.compare)."""
        rows = []
        names = dict.fromkeys(list(self.params) + list(other.params))
        for n in names:
            a = self.get_param(n).value if n in self else None
            b = other.get_param(n).value if n in other else None
            if a != b:
                rows.append(f"{n:<12} {a!r} -> {b!r}")
        return "\n".join(rows)

    def __repr__(self):
        comps = ", ".join(self.components)
        return f"<TimingModel {self.name or '?'} [{comps}] on {self.device}>"


def copy_model(model: TimingModel) -> TimingModel:
    """A deep copy of ``model`` on its device, made from host state
    only: the per-TOA and noise caches (tensors on the card) are left
    behind, not copied."""
    import copy

    skip = {id(model.__dict__[k]): None
            for k in ("_cache", "_noise_basis_cache", "_noise_device_cache")
            if model.__dict__.get(k) is not None}
    out = copy.deepcopy(model, memo=skip)
    out.invalidate_cache()
    return out


# ---------------- small device helpers ----------------


def make_pv(free_names, frozen_names, th, tl, fh, fl) -> dict:
    """{name: DD of 0-d tensors} from packed parameter tensors."""
    pv = {nm: DD(th[i], tl[i]) for i, nm in enumerate(free_names)}
    pv.update({nm: DD(fh[j], fl[j]) for j, nm in enumerate(frozen_names)})
    return pv


def dd_addf_day(batch, ref_day: float) -> DD:
    """(tdb - ref_day) in days as DD: exact integer-day difference plus
    the dd fraction."""
    return dd_add_f(batch.tdb_frac, batch.tdb_day - ref_day)


def _to_host(tree):
    """``tree`` (dicts, ToaBatch and DD NamedTuples of tensors) with
    every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v) for v in tree))
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree
