"""Model builder: .par file → TimingModel (a port of
pint_tpu/models/model_builder.py; reference:
src/pint/models/model_builder.py get_model).

Each registered Component contributes its parameter names and aliases to
an index; prefixed families (F2.., DM2..) and JUMP mask parameters are
recognized by pattern, as are DMX windows and the mask families (EFAC,
EQUAD, TNEQ, ECORR and their aliases, DMEFAC, DMEQUAD, DMJUMP, FDJUMP
and FD<n>JUMP). The BINARY line is read first, whatever its place in
the file, and selects the binary component that every binary parameter
(and the FB series, the BT_piecewise pieces) lands on; ``BINARY T2``
picks the family from the parameters present (``guess_binary_model``).
Other members of a prefix family (GLF0_2,
WXFREQ_0002, CMX_0003...) land on the family's component as a parameter
of its first member's class, so WAVE2 and IFUNC2 are pairs like WAVE1 and
IFUNC1. Keys nobody knows are warned about and ignored, as in the
reference. A ``UNITS TCB`` model is converted to TDB by get_model
(models.tcb_conversion), or refused with ``allow_tcb=False``.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, List

from pint_tpu_torch.io.par import ParfileLine, parse_parfile
from pint_tpu_torch.models.parameter import (
    maskParameter,
    pairParameter,
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
_BTX_RE = re.compile(r"^(T0X_|A1X_|XR1_|XR2_)(\d+)$")
_FB_RE = re.compile(r"^FB(\d+)$")

# noise mask families → owning component, canonical name per alias and
# par-file units (reference: MASK_FAMILIES, MASK_CANONICAL, MASK_UNITS)
MASK_FAMILIES: Dict[str, str] = {
    "EFAC": "ScaleToaError", "T2EFAC": "ScaleToaError",
    "EQUAD": "ScaleToaError", "T2EQUAD": "ScaleToaError",
    "TNEQ": "ScaleToaError", "ECORR": "EcorrNoise", "TNECORR": "EcorrNoise",
    "DMJUMP": "DispersionJump", "DMEFAC": "ScaleDmError",
    "DMEQUAD": "ScaleDmError", "FDJUMP": "FDJump",
}
# FD jumps of any order (FD1JUMP, FD2JUMP, ...)
_FDJUMP_RE = re.compile(r"^FD(\d+)JUMP$")
MASK_CANONICAL = {"T2EFAC": "EFAC", "T2EQUAD": "EQUAD", "TNECORR": "ECORR"}
MASK_UNITS = {"EFAC": "", "EQUAD": "us", "TNEQ": "log10(s)", "ECORR": "us",
              "DMEFAC": "", "DMEQUAD": "pc cm^-3", "DMJUMP": "pc cm^-3",
              "FDJUMP": "s"}

BINARY_COMPONENT_PREFIX = "Binary"


def guess_binary_model(keys) -> str:
    """The binary family a set of UPPERCASE par keys implies (reference:
    model_builder guess_binary_model; for TEMPO2's ``BINARY T2``, which
    dispatches on the parameters present). The most specific signature
    wins."""
    keys = set(keys)
    if "KIN" in keys or "KOM" in keys:
        return "DDK"
    if "EPS1" in keys or "EPS2" in keys or "TASC" in keys:
        if "LNEDOT" in keys:
            return "ELL1k"
        return "ELL1H" if "H3" in keys else "ELL1"
    if "MTOT" in keys:
        return "DDGR"
    if "SHAPMAX" in keys:
        return "DDS"
    if "H3" in keys and "STIG" in keys:
        return "DDH"
    if keys & {"SINI", "M2", "OMDOT", "GAMMA"}:
        return "DD"
    return "BT"


class T2BinaryWarning(UserWarning):
    """A BINARY T2 par file, loaded through guess_binary_model."""


class UnknownParameterWarning(UserWarning):
    pass


def _select_binary(lines: List[ParfileLine]):
    """(component class, model name) of the BINARY line, T2 resolved by
    guess_binary_model (its IAU KIN/KOM converted to DT92 in place for
    DDK); (None, None) without a BINARY line. Case and underscores in
    the name are ignored (``ELL1k``, ``BT_piecewise``)."""
    cls_name = binary_name = None
    for ln in lines:
        if ln.key != "BINARY" or not ln.tokens:
            continue
        binary_name = ln.tokens[0]
        if binary_name.upper() == "T2":
            binary_name = guess_binary_model({x.key.upper() for x in lines})
            if binary_name == "DDK":
                # T2 KIN/KOM are IAU-convention, the DDK model's DT92
                # (KIN -> 180-KIN, KOM -> 90-KOM, as t2binary2pint):
                # the raw values would corrupt the Kopeikin terms
                for x in lines:
                    k = x.key.upper()
                    if k in ("KIN", "KOM") and x.tokens:
                        ref = 180.0 if k == "KIN" else 90.0
                        x.tokens[0] = repr(ref - float(x.tokens[0]))
            warnings.warn(
                f"BINARY T2 interpreted as {binary_name!r} via "
                f"guess_binary_model"
                + (" (KIN/KOM converted IAU->DT92)"
                   if binary_name == "DDK" else ""),
                T2BinaryWarning, stacklevel=3)
        by_upper = {c.upper(): c for c in component_types}
        want = (BINARY_COMPONENT_PREFIX + binary_name).upper()
        cls_name = by_upper.get(want) or by_upper.get(want.replace("_", ""))
        if cls_name is None:
            raise NotImplementedError(
                f"binary model {binary_name!r} is not implemented (known: "
                f"{sorted(c for c in component_types if c.startswith('Binary'))})")
    return cls_name, binary_name


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
        import pint_tpu_torch.models.binary  # noqa: F401
        import pint_tpu_torch.models.components_extra  # noqa: F401
        import pint_tpu_torch.models.components_tail  # noqa: F401
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

        # BINARY first, whatever its place: binary parameters (T0, TASC,
        # PB...) exist on several Binary* classes and must land on the
        # one the BINARY line selects
        binary_cls, binary_name = _select_binary(lines)
        if binary_cls is not None:
            get_comp(binary_cls)

        def active_binary():
            return next((c for c in comps.values() if type(c).__name__
                         .startswith(BINARY_COMPONENT_PREFIX)), None)

        for ln in lines:
            key, toks = ln.key, ln.tokens
            if key == "BINARY":
                continue
            if key == "UNITS":
                units = toks[0] if toks else "TDB"
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
                if cls_name.startswith(BINARY_COMPONENT_PREFIX) and \
                        active_binary() is not None:
                    # a binary parameter the selected model does not
                    # carry (SINI in a DDK par: DDK takes the
                    # inclination from KIN) never builds a second binary
                    warnings.warn(
                        f"{key} is not used by the selected binary "
                        f"model; ignoring it",
                        UnknownParameterWarning, stacklevel=2)
                    unknown.append(key)
                    continue
                p = _param_by_name_or_alias(get_comp(cls_name), key)
                p.from_tokens(toks)
                continue

            # 1c. the FB orbital-frequency series → the active binary
            m = _FB_RE.match(key)
            if m and active_binary() is not None:
                p = active_binary().add_fb_term(int(m.group(1)))
                p.from_tokens(toks)
                continue

            # 1d. BT_piecewise pieces → the active binary
            m = _BTX_RE.match(key)
            if m:
                binary = next((c for c in comps.values()
                               if hasattr(c, "add_piece_param")), None)
                if binary is not None:
                    p = binary.add_piece_param(m.group(1), int(m.group(2)),
                                               index_str=m.group(2))
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
            if key in MASK_FAMILIES or _FDJUMP_RE.match(key):
                canonical = MASK_CANONICAL.get(key, key)
                mask_counters[canonical] = mask_counters.get(canonical,
                                                             0) + 1
                p = maskParameter(canonical,
                                  index=mask_counters[canonical],
                                  units=MASK_UNITS.get(canonical, "s"))
                get_comp(MASK_FAMILIES.get(key, "FDJump")).add_param(p)
                p.from_tokens(toks)
                continue

            # 4. other members of a prefix family (FD2, GLF0_2, WAVE2...):
            #    a new parameter of the first member's class and units
            p = _family_member(key, self.param_index, get_comp)
            if p is not None:
                p.from_tokens(toks)
                continue

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
        if binary_name:
            model.BINARY = binary_name
        if unknown:
            warnings.warn(
                f"ignoring unrecognized par parameters: {sorted(set(unknown))}",
                UnknownParameterWarning, stacklevel=2)
        model.unknown_params = sorted(set(unknown))
        for c in model.components.values():
            c.setup()
        model.validate()
        return model


def _family_member(key: str, index: Dict[str, str], get_comp):
    """A new parameter ``key`` on the component owning its prefix family,
    of the class of the family's first member (a pairParameter for WAVE
    and IFUNC, else a prefixParameter) and its units (reference:
    ModelBuilder step 4), or None when no component owns the prefix."""
    try:
        prefix, _, _ = split_prefixed_name(key)
    except ValueError:
        return None
    owner = index.get(prefix.rstrip("_")) or index.get(prefix)
    if owner is None:
        return None
    comp = get_comp(owner)
    tmpl = next((q for qn, q in comp.params.items()
                 if qn != key and qn.startswith(prefix)
                 and qn[len(prefix):].isdigit()), None)
    if isinstance(tmpl, pairParameter):
        p = pairParameter(key, units=tmpl.units)
    else:
        p = prefixParameter(name=key, units=getattr(tmpl, "units", ""))
    comp.add_param(p)
    return p


def _param_by_name_or_alias(comp: Component, key: str):
    if key in comp.params:
        return comp.params[key]
    for p in comp.params.values():
        if key in p.aliases:
            return p
    raise KeyError(key)


def get_model(parfile, name="", device=None,
              allow_tcb=True) -> TimingModel:
    """Build a TimingModel from a par file path/handle/string (reference:
    get_model). ``device`` (None means "cuda") is where the model's
    phase() runs. UNITS TCB models are converted to TDB with the IFTE_K
    linear scaling (reference: allow_tcb; allow_tcb=False refuses them
    with ValueError)."""
    lines = parse_parfile(parfile)
    model = ModelBuilder()(lines, name=name, device=device)
    psr = model.PSR.value
    if psr and not model.name:
        model.name = psr
    if (model.UNITS.value or "TDB").upper() == "TCB":
        if not allow_tcb:
            raise ValueError("UNITS TCB refused (allow_tcb=False)")
        from pint_tpu_torch.models.tcb_conversion import convert_tcb_tdb

        warnings.warn(
            "par file is in TCB units: converted to TDB with the "
            "IFTE_K linear scaling (periodic TDB-TCB terms ~ns are "
            "not applied)")
        model = convert_tcb_tdb(model)
    return model


def get_model_and_toas(parfile, timfile, device=None, **kw):
    """(model, toas) in one call (reference: get_model_and_toas), both
    on ``device`` (None means "cuda")."""
    from pint_tpu_torch.toa import get_TOAs

    model = get_model(parfile, device=device)
    toas = get_TOAs(timfile, model=model, device=device, **kw)
    return model, toas
