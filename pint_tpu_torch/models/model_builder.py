"""Model builder: .par file → TimingModel (a port of
pint_tpu/models/model_builder.py; reference:
src/pint/models/model_builder.py get_model).

Each registered Component contributes its parameter names and aliases to
an index; prefixed families (F2.., DM2..) and JUMP mask parameters are
recognized by pattern, as are DMX windows and the noise mask families
(EFAC, EQUAD, TNEQ, ECORR and their aliases). Keys nobody knows are
warned about and ignored, as in the reference. Keys of components the
reference has but this port does not have yet (binaries, DMJUMP, the
DM-noise and extra component families) raise NotImplementedError naming
the ROADMAP item: ignoring e.g. a BINARY line would give wrong phases
silently.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, List

from pint_tpu_torch.io.par import ParfileLine, parse_parfile
from pint_tpu_torch.models.parameter import (
    maskParameter,
    prefixParameter,
    split_prefixed_name,
)
from pint_tpu_torch.models.timing_model import (
    Component,
    TimingModel,
    component_types,
)

# components always present (reference: ModelBuilder default components)
DEFAULT_COMPONENTS = ["Spindown"]

_F_RE = re.compile(r"^F(\d+)$")
_DM_RE = re.compile(r"^DM(\d+)$")
_DMX_RE = re.compile(r"^(DMX_|DMXR1_|DMXR2_)(\d+)$")

# noise mask families → owning component, canonical name per alias and
# par-file units (reference: MASK_FAMILIES, MASK_CANONICAL, MASK_UNITS)
MASK_FAMILIES: Dict[str, str] = {
    "EFAC": "ScaleToaError", "T2EFAC": "ScaleToaError",
    "EQUAD": "ScaleToaError", "T2EQUAD": "ScaleToaError",
    "TNEQ": "ScaleToaError", "ECORR": "EcorrNoise", "TNECORR": "EcorrNoise",
}
MASK_CANONICAL = {"T2EFAC": "EFAC", "T2EQUAD": "EQUAD", "TNECORR": "ECORR"}
MASK_UNITS = {"EFAC": "", "EQUAD": "us", "TNEQ": "log10(s)", "ECORR": "us"}

# ---- what the reference knows and this port does not have yet ----------
# component → ROADMAP.md item that ports it
_BINARIES = "ROADMAP.md queue 1 item 7 (binary models)"
_ZOO = "ROADMAP.md queue 1 item 7 (rest of the model zoo)"
UNPORTED_COMPONENTS: Dict[str, str] = {
    **{c: _BINARIES for c in (
        "BinaryBT", "BinaryBTPiecewise", "BinaryDD", "BinaryDDGR",
        "BinaryDDH", "BinaryDDK", "BinaryDDS", "BinaryELL1", "BinaryELL1H",
        "BinaryELL1k")},
    **{c: _ZOO for c in (
        "DispersionJump", "ScaleDmError", "FDJump", "FD", "Glitch",
        "IFunc", "Wave", "WaveX", "DMWaveX", "CMWaveX", "ChromaticCM",
        "ChromaticCMX", "PiecewiseSpindown", "SolarWindDispersion",
        "SolarWindDispersionX", "TroposphereDelay", "PLDMNoise",
        "PLChromNoise", "PLSWNoise")},
}

# par key (name, alias or family prefix) → unported component, as the
# reference's parameter index routes it
UNPORTED_PARAMS: Dict[str, str] = {}
for _cls, _keys in {
    "BinaryBT": "E ECC EDOT GAMMA OM OMDOT T T0",
    "BinaryDD": "A0 B B0 DR DTH DTHETA",
    "BinaryDDGR": "MTOT XOMDOT XPBDOT",
    "BinaryDDK": "K K96 KIN KOM",
    "BinaryDDS": "SHAPMAX",
    "BinaryELL1": "A A1 A1DOT EPS EPS1 EPS1DOT EPS2 EPS2DOT M M2 PB PBDOT "
                  "SINI TASC XDOT",
    "BinaryELL1H": "H H3 H4 STIG VARSIGMA",
    "BinaryELL1k": "LNEDOT",
    "CMWaveX": "CMWXCOS CMWXCOS_ CMWXEPOCH CMWXFREQ CMWXFREQ_ CMWXSIN "
               "CMWXSIN_",
    "ChromaticCM": "CM CM1 CMEPOCH CMIDX TNCHROMIDX",
    "ChromaticCMX": "CMX CMXR1 CMXR1_ CMXR2 CMXR2_ CMX_",
    "DMWaveX": "DMWXCOS DMWXCOS_ DMWXEPOCH DMWXFREQ DMWXFREQ_ DMWXSIN "
               "DMWXSIN_",
    "FD": "FD FD1",
    "Glitch": "GLEP GLEP_ GLF0 GLF0D GLF0D_ GLF0_ GLF1 GLF1_ GLF2 GLF2_ "
              "GLPH GLPH_ GLTD GLTD_",
    "IFunc": "IFUNC SIFUNC",
    "PLChromNoise": "TNCHROMAMP TNCHROMC TNCHROMGAM TNChromAmp TNChromC "
                    "TNChromGam",
    "PLDMNoise": "TNDMAMP TNDMAmp TNDMC TNDMGAM TNDMGam",
    "PLSWNoise": "TNSWAMP TNSWAmp TNSWC TNSWGAM TNSWGam",
    "PiecewiseSpindown": "PWEP PWEP_ PWF0 PWF0_ PWF1 PWF1_ PWF2 PWF2_ PWPH "
                         "PWPH_ PWSTART PWSTART_ PWSTOP PWSTOP_",
    "SolarWindDispersion": "NE1AU NE_SW SOLARN0 SWM SWP",
    "SolarWindDispersionX": "SWXDM SWXDM_ SWXR1 SWXR1_ SWXR2 SWXR2_",
    "TroposphereDelay": "CORRECT_TROPOSPHERE",
    "Wave": "WAVE WAVEEPOCH WAVEOM WAVE_OM",
    "WaveX": "WXCOS WXCOS_ WXEPOCH WXFREQ WXFREQ_ WXSIN WXSIN_",
    # mask-parameter families
    "DispersionJump": "DMJUMP",
    "ScaleDmError": "DMEFAC DMEQUAD",
    "FDJump": "FDJUMP",
}.items():
    for _k in _keys.split():
        UNPORTED_PARAMS[_k] = _cls
# pattern families routed to unported components
_UNPORTED_RE = (
    (re.compile(r"^FB\d+$"), "BinaryELL1"),           # orbital-frequency series
    (re.compile(r"^(T0X_|A1X_|XR1_|XR2_)\d+$"), "BinaryBTPiecewise"),
    (re.compile(r"^FD\d+JUMP$"), "FDJump"),
)


def _refuse(key: str, cls: str):
    raise NotImplementedError(
        f"par key {key!r} belongs to {cls}, which pint_tpu_torch does "
        f"not have yet: {UNPORTED_COMPONENTS[cls]}")


def _unported_owner(key: str):
    """The unported component a par key routes to in the reference, or
    None."""
    if key in UNPORTED_PARAMS:
        return UNPORTED_PARAMS[key]
    for pat, cls in _UNPORTED_RE:
        if pat.match(key):
            return cls
    try:
        prefix, _, _ = split_prefixed_name(key)
    except ValueError:
        return None
    return UNPORTED_PARAMS.get(prefix) or \
        UNPORTED_PARAMS.get(prefix.rstrip("_"))


class UnknownParameterWarning(UserWarning):
    pass


def _build_param_index():
    """name/alias/family prefix → component class name."""
    idx: Dict[str, str] = {}
    for cls_name, cls in component_types.items():
        try:
            tmpl = cls()
        except Exception:
            continue
        for pname, p in tmpl.params.items():
            idx.setdefault(pname, cls_name)
            for a in p.aliases:
                idx.setdefault(a, cls_name)
            prefix = getattr(p, "prefix", None)
            if prefix is None:
                try:
                    prefix, _, _ = split_prefixed_name(pname)
                except ValueError:
                    prefix = None
            if prefix:
                idx.setdefault(prefix, cls_name)
                idx.setdefault(prefix.rstrip("_"), cls_name)
    return idx


class ModelBuilder:
    """One-shot builder; call with parsed par lines."""

    def __init__(self):
        # importing the component modules populates the registry
        import pint_tpu_torch.models.absolute_phase  # noqa: F401
        import pint_tpu_torch.models.astrometry  # noqa: F401
        import pint_tpu_torch.models.dispersion  # noqa: F401
        import pint_tpu_torch.models.jump  # noqa: F401
        import pint_tpu_torch.models.noise  # noqa: F401
        import pint_tpu_torch.models.phase_offset  # noqa: F401
        import pint_tpu_torch.models.solar_system_shapiro  # noqa: F401
        import pint_tpu_torch.models.spindown  # noqa: F401
        self.param_index = _build_param_index()

    def __call__(self, lines: List[ParfileLine], name="",
                 device=None) -> TimingModel:
        comps: Dict[str, Component] = {}
        unknown: List[str] = []
        jump_count = 0
        mask_counters: Dict[str, int] = {}

        def get_comp(cls_name: str) -> Component:
            if cls_name not in comps:
                comps[cls_name] = component_types[cls_name]()
            return comps[cls_name]

        for cls_name in DEFAULT_COMPONENTS:
            get_comp(cls_name)

        for ln in lines:
            key, toks = ln.key, ln.tokens
            if key == "BINARY":
                _refuse(key, "BinaryBT")
            if key == "UNITS":
                units = toks[0] if toks else "TDB"
                if units.upper() == "TCB":
                    raise NotImplementedError(
                        "UNITS TCB: the TCB->TDB conversion is not in "
                        "pint_tpu_torch yet (ROADMAP.md queue 1 item 12)")
                get_comp("MiscParams").UNITS.value = units
                continue

            # 1a. exact/alias match against instantiated components
            matched = False
            for comp in comps.values():
                try:
                    p = _param_by_name_or_alias(comp, key)
                except KeyError:
                    continue
                p.from_tokens(toks)
                matched = True
                break
            if matched:
                continue

            # 1b. exact/alias match against the registry index
            cls_name = self.param_index.get(key)
            if cls_name is not None:
                p = _param_by_name_or_alias(get_comp(cls_name), key)
                p.from_tokens(toks)
                continue

            # 2. prefix families
            m = _F_RE.match(key)
            if m:
                p = get_comp("Spindown").add_f_term(int(m.group(1)))
                p.from_tokens(toks)
                continue
            m = _DM_RE.match(key)
            if m:
                p = get_comp("DispersionDM").add_dm_term(int(m.group(1)))
                p.from_tokens(toks)
                continue

            m = _DMX_RE.match(key)
            if m:
                p = prefixParameter(name=key, units="pc cm^-3"
                                    if m.group(1) == "DMX_" else "MJD")
                get_comp("DispersionDMX").add_param(p)
                p.from_tokens(toks)
                continue

            # 3. mask parameters (one instance per line)
            if key == "JUMP":
                jump_count += 1
                p = maskParameter("JUMP", index=jump_count, units="s")
                get_comp("PhaseJump").add_param(p)
                p.from_tokens(toks)
                continue
            if key in MASK_FAMILIES:
                canonical = MASK_CANONICAL.get(key, key)
                mask_counters[canonical] = mask_counters.get(canonical,
                                                             0) + 1
                p = maskParameter(canonical,
                                  index=mask_counters[canonical],
                                  units=MASK_UNITS[canonical])
                get_comp(MASK_FAMILIES[key]).add_param(p)
                p.from_tokens(toks)
                continue

            # 4. known to the reference, not ported yet
            owner = _unported_owner(key)
            if owner is not None:
                _refuse(key, owner)

            unknown.append(key)

        # Shared astrometry params (PX/POSEPOCH) index to the equatorial
        # template; if the par is actually ecliptic, migrate them.
        if "AstrometryEquatorial" in comps and "AstrometryEcliptic" in comps:
            eq, ec = comps["AstrometryEquatorial"], comps["AstrometryEcliptic"]
            if eq.RAJ.value is None and ec.ELONG.value is not None:
                for nm in ("PX", "POSEPOCH"):
                    if eq.params[nm].value is not None:
                        ec.params[nm] = eq.params[nm]
                del comps["AstrometryEquatorial"]
            elif ec.ELONG.value is None and eq.RAJ.value is not None:
                for nm in ("PX", "POSEPOCH"):
                    if ec.params[nm].value is not None:
                        eq.params[nm] = ec.params[nm]
                del comps["AstrometryEcliptic"]

        # implied components (reference: ModelBuilder._get_components)
        if any(c in comps for c in ("AstrometryEquatorial",
                                    "AstrometryEcliptic")):
            get_comp("SolarSystemShapiro")

        model = TimingModel(list(comps.values()), name=name, device=device)
        if unknown:
            warnings.warn(
                f"ignoring unrecognized par parameters: {sorted(set(unknown))}",
                UnknownParameterWarning, stacklevel=2)
        model.unknown_params = sorted(set(unknown))
        for c in model.components.values():
            c.setup()
        model.validate()
        return model


def _param_by_name_or_alias(comp: Component, key: str):
    if key in comp.params:
        return comp.params[key]
    for p in comp.params.values():
        if key in p.aliases:
            return p
    raise KeyError(key)


def get_model(parfile, name="", device=None) -> TimingModel:
    """Build a TimingModel from a par file path/handle/string (reference:
    get_model). ``device`` (None means "cuda") is where the model's
    phase() runs."""
    lines = parse_parfile(parfile)
    model = ModelBuilder()(lines, name=name, device=device)
    psr = model.PSR.value
    if psr and not model.name:
        model.name = psr
    return model


def get_model_and_toas(parfile, timfile, device=None, **kw):
    """(model, toas) in one call (reference: get_model_and_toas), both
    on ``device`` (None means "cuda")."""
    from pint_tpu_torch.toa import get_TOAs

    model = get_model(parfile, device=device)
    toas = get_TOAs(timfile, model=model, device=device, **kw)
    return model, toas
