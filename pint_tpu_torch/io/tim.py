"""``.tim`` TOA-file parser/writer (TEMPO2 "FORMAT 1" plus the TEMPO
Princeton, Parkes and ITOA column formats — ITOA goes beyond the
reference, whose parse_TOA_line raises "not implemented" there).

Reference behavior: src/pint/toa.py (.tim parsing in get_TOAs / TOA
class). Key property preserved here: **the MJD never passes through a
single float64** — it stays a decimal string until
``pint_tpu_torch.time.mjd.parse_mjd_string`` splits it exactly into
(int day, double-double fraction).

Supported commands: FORMAT, MODE, INCLUDE, C/CC/# comments, SKIP/NOSKIP,
END, TIME (accumulated offset, seconds), PHASE (accumulated turns →
``-padd`` flag, applied by Residuals), EFAC/EQUAD (scoped error
scaling), EMIN/EMAX/FMIN/FMAX (cuts on the scaled error / frequency),
JUMP (toggle pairs → ``-tim_jump N`` flag, mirroring the reference's
jump-flag behavior), TRACK/INFO (ignored).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TimTOA:
    """One parsed TOA line, host-side."""

    mjd_str: str  # full-precision decimal string, scale = site clock (UTC)
    freq_mhz: float
    error_us: float
    obs: str
    name: str = ""
    flags: Dict[str, str] = field(default_factory=dict)


_COMMANDS = {
    "FORMAT", "MODE", "INCLUDE", "SKIP", "NOSKIP", "END", "TIME",
    "EFAC", "EQUAD", "EMIN", "EMAX", "FMIN", "FMAX", "JUMP", "PHASE",
    "TRACK", "INFO",
}


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _parse_format1_line(parts: List[str]) -> Optional[TimTOA]:
    # name freq mjd error site [-flag value]...
    if len(parts) < 5:
        return None
    name, freq, mjd, err, site = parts[:5]
    if not (_is_number(freq) and _is_number(mjd) and _is_number(err)):
        return None
    flags: Dict[str, str] = {}
    i = 5
    while i < len(parts):
        tok = parts[i]
        if tok.startswith("-") and not _is_number(tok):
            key = tok[1:]
            nxt = parts[i + 1] if i + 1 < len(parts) else None
            # a following token that itself looks like a flag means this
            # flag is value-less
            if nxt is not None and not (nxt.startswith("-")
                                        and not _is_number(nxt)):
                flags[key] = nxt
                i += 2
            else:
                flags[key] = ""
                i += 1
        else:
            i += 1  # stray token; tolerated like the reference
    return TimTOA(mjd_str=mjd, freq_mhz=float(freq), error_us=float(err),
                  obs=site, name=name, flags=flags)


def _parse_princeton_line(line: str) -> Optional[TimTOA]:
    """TEMPO Princeton format: observatory code in column 0, then
    fixed columns — name(2:15) freq(15:24) MJD(24:44) err(44:53)
    dmcorr(68:78). Parsed leniently by token position within slices.
    """
    if len(line) < 44:
        return None
    obs = line[0]
    name = line[1:15].strip()
    freq = line[15:24].strip()
    mjd = line[24:44].strip().replace(" ", "")
    err = line[44:53].strip()
    if not (freq and mjd and err):
        return None
    if not (_is_number(freq) and _is_number(mjd) and _is_number(err)):
        return None
    return TimTOA(mjd_str=mjd, freq_mhz=float(freq), error_us=float(err),
                  obs=obs, name=name)


def _parse_itoa_line(line: str) -> Optional[TimTOA]:
    """ITOA column format (detected by the TOA decimal point at
    column 15): name(1:2), blanks(3:9), MJD(10:28), error-us(29:34),
    freq-MHz(35:45), DM correction pc/cm^3 (46:55, recorded as the
    ``ddm`` flag), 2-char observatory code(58:59). Goes beyond the
    reference here: its parse_TOA_line raises 'not implemented' on
    ITOA lines."""
    if len(line) < 59 or line[14:15] != ".":
        return None
    if line[2:9].strip():  # cols 3-9 must be blank in ITOA
        return None
    name = line[0:2].strip()
    mjd = line[9:28].strip().replace(" ", "")
    err = line[28:34].strip()
    freq = line[34:45].strip()
    ddm = line[45:55].strip()
    obs = line[57:59].strip()
    if not (mjd and err and freq and obs):
        return None
    if not (_is_number(mjd) and _is_number(err) and _is_number(freq)):
        return None
    toa = TimTOA(mjd_str=mjd, freq_mhz=float(freq),
                 error_us=float(err), obs=obs, name=name)
    if ddm and _is_number(ddm) and float(ddm) != 0.0:
        toa.flags["ddm"] = ddm
    return toa


def _parse_parkes_line(line: str) -> Optional[TimTOA]:
    """TEMPO Parkes column format (detected by a blank first column
    and a decimal point at column 41): name(1:25), freq-MHz(25:34),
    MJD(34:55), phase offset(55:63), error-us(63:71), 1-char
    observatory(79). The MJD field is already one decimal string."""
    if len(line) < 80 or not line.startswith(" ") \
            or line[41:42] != ".":
        return None
    name = line[1:25].strip()
    freq = line[25:34].strip()
    mjd = line[34:55].strip().replace(" ", "")
    err = line[63:71].strip()
    obs = line[79:80].strip()
    if not (freq and mjd and err and obs):
        return None
    if not (_is_number(freq) and _is_number(mjd) and _is_number(err)):
        return None
    phoff = line[55:63].strip()
    if phoff and _is_number(phoff) and float(phoff) != 0.0:
        # a phase offset shifts the TOA by phoff*P0, which a parser
        # cannot apply (it needs the model's period). The reference
        # raises for exactly this reason — silent mis-timing otherwise
        raise ValueError(
            f"nonzero phase offset {phoff} in Parkes-format TOA line "
            f"is not supported (matches the reference): {line!r}")
    return TimTOA(mjd_str=mjd, freq_mhz=float(freq),
                  error_us=float(err), obs=obs, name=name)


def parse_tim(source, _depth: int = 0,
              _jump_base: int = 0) -> List[TimTOA]:
    """Parse a .tim file (path, file object, or literal multi-line string).

    INCLUDE is followed relative to the including file's directory.
    """
    state = _fresh_state()
    state["jump_count"] = _jump_base
    return _parse_tim_stream(source, state, _depth=_depth)


def _fresh_state() -> dict:
    """Command state of the expanded line stream. ONE dict is shared
    by the whole INCLUDE tree: every command (FORMAT, TIME, PHASE,
    EFAC/EQUAD, EMIN/EMAX/FMIN/FMAX, SKIP, JUMP toggling) is a
    property of the linear stream exactly as in the reference's
    single loop — a command inside an INCLUDEd file stays in force
    after the include returns."""
    return {
        "skipping": False,
        "fmt": "Unknown",  # FORMAT 1 switches later lines to TEMPO2
        "time_offset_s": 0.0,
        "phase_turns": 0.0,
        "efac": 1.0,
        "equad_us": 0.0,
        "emin_us": None, "emax_us": None,
        "fmin_mhz": None, "fmax_mhz": None,
        "jump_active": False,
        # jump ids number ACROSS include boundaries: physically
        # distinct JUMP blocks must not share a -tim_jump id (that
        # would merge them into one fitted parameter)
        "jump_count": 0,
        "ended": False,  # END terminates the WHOLE stream, not just
        # the file it appears in (an END inside an include stops the
        # includer too)
    }


def _parse_tim_stream(source, st: dict, _depth: int = 0):
    """parse_tim worker: one file/stream of the INCLUDE tree, sharing
    the command state ``st`` (see _fresh_state).

    **EMIN/EMAX cut ordering (intentional)**:
    the error cuts are applied to the SCALED uncertainty — after the
    scoped EFAC multiply and EQUAD quadrature add — not to the raw
    column value. Rationale: the cut then sees exactly the
    uncertainty the fit will see, so "drop TOAs worse than X" means
    what it says under any in-file rescaling. TEMPO-parity caveat:
    classic TEMPO applies EMIN/EMAX to the RAW quoted error before
    its own scaling, so a .tim file combining EFAC/EQUAD with
    EMIN/EMAX can select a (slightly) different TOA subset here than
    under TEMPO — files that keep the cuts ahead of any EFAC/EQUAD
    command in the stream are unaffected (the scale factors are
    still 1 when the cut state is set, and both orderings see raw ==
    scaled for TOAs parsed before the first scaling command).
    FMIN/FMAX have no such subtlety (frequency is never rescaled)."""
    from pint_tpu_torch.io.par import resolve_source

    lines, base_dir = resolve_source(source, kind="tim")

    toas: List[TimTOA] = []

    for raw in lines:
        line = raw.rstrip("\n")
        stripped = line.strip()
        if not stripped:
            continue
        if stripped.startswith(("#", "C ", "CC ")) or stripped in ("C", "CC"):
            continue
        parts = stripped.split()
        head = parts[0].upper()

        # inside SKIP...NOSKIP, commands are inert too (only NOSKIP exits)
        if st["skipping"] and head != "NOSKIP":
            continue

        if head in _COMMANDS:
            if head == "SKIP":
                st["skipping"] = True
            elif head == "NOSKIP":
                st["skipping"] = False
            elif head == "END":
                st["ended"] = True
                break
            elif head == "INCLUDE" and len(parts) > 1:
                if _depth > 10:
                    raise RecursionError("INCLUDE nesting too deep")
                inc = parts[1]
                if not os.path.isabs(inc):
                    inc = os.path.join(base_dir, inc)
                toas.extend(_parse_tim_stream(inc, st,
                                              _depth=_depth + 1))
                if st["ended"]:
                    break
            elif head == "TIME" and len(parts) > 1:
                st["time_offset_s"] += float(parts[1])
            elif head == "PHASE" and len(parts) > 1:
                # accumulated phase offset [turns] applied to later
                # TOAs via the -padd flag, which Residuals adds to
                # the phase residual (reference: PHASE command ->
                # padd flag -> calc_phase_resids)
                st["phase_turns"] += float(parts[1])
            elif head == "EFAC" and len(parts) > 1:
                st["efac"] = float(parts[1])
            elif head == "EQUAD" and len(parts) > 1:
                st["equad_us"] = float(parts[1])
            elif head == "EMIN" and len(parts) > 1:
                st["emin_us"] = float(parts[1])
            elif head == "EMAX" and len(parts) > 1:
                st["emax_us"] = float(parts[1])
            elif head == "FMIN" and len(parts) > 1:
                st["fmin_mhz"] = float(parts[1])
            elif head == "FMAX" and len(parts) > 1:
                st["fmax_mhz"] = float(parts[1])
            elif head == "JUMP":
                st["jump_active"] = not st["jump_active"]
                if st["jump_active"]:
                    st["jump_count"] += 1
            elif head == "FORMAT" and len(parts) > 1:
                st["fmt"] = "Tempo2" if parts[1] == "1" else "Unknown"
            # MODE/TRACK/INFO: recorded implicitly or ignored
            continue

        # per-line format detection (the reference's _toa_format):
        # after a FORMAT 1 command every line is TEMPO2-tokenized;
        # otherwise the Parkes column signature is checked FIRST (a
        # Parkes line tokenizes numerically and would be swallowed by
        # the free-form parser), then free-form/Princeton, then ITOA
        # (detected by its TOA decimal point in column 15, index 14)
        if st["fmt"] == "Tempo2":
            toa = _parse_format1_line(parts)
        elif line.startswith(" ") and line[41:42] == ".":
            toa = _parse_parkes_line(line)
        else:
            toa = None
            itoa_sig = line[14:15] == "." and not line[2:9].strip()
            if itoa_sig:
                # ITOA column signature, checked before free-form: a
                # real ITOA line tokenizes numerically and the
                # free-form parser would mis-assign its fields. On a
                # near-miss (signature matches but the columns don't
                # parse as ITOA) fall THROUGH to free-form — e.g. a
                # short-name free-form line whose frequency decimal
                # point happens to land in column 15.
                toa = _parse_itoa_line(line)
                fell_through = toa is None
            else:
                fell_through = False
            if toa is None:
                toa = _parse_format1_line(parts)
            if toa is None:
                toa = _parse_princeton_line(line)
            if toa is not None and fell_through:
                # ITOA-signature line swallowed by a fallback parser:
                # only accept it when the resulting MJD is plausible.
                # A truncated/misaligned ITOA line tokenizes
                # numerically with SWAPPED fields (a 57-char
                # ITOA-like line free-form-parses with mjd='5.00',
                # freq=50123.88) — an implausible
                # MJD is that swap, not a real TOA, and must fail at
                # the parse site instead of poisoning the dataset.
                try:
                    mjd_f = float(toa.mjd_str)
                except ValueError:
                    mjd_f = float("nan")
                if not (15000.0 <= mjd_f <= 100000.0):
                    raise ValueError(
                        f"ambiguous ITOA-like line (free-form "
                        f"fallback produced implausible MJD "
                        f"{toa.mjd_str!r} — truncated or misaligned "
                        f"ITOA columns?): {line!r}")
        if toa is None:
            raise ValueError(f"unparseable TOA line: {line!r}")
        if st["time_offset_s"] != 0.0:
            toa.flags["to"] = repr(st["time_offset_s"])
        if st["phase_turns"] != 0.0:
            toa.flags["padd"] = repr(st["phase_turns"])
        if st["efac"] != 1.0:
            toa.error_us *= st["efac"]
        if st["equad_us"] != 0.0:
            toa.error_us = (toa.error_us ** 2
                            + st["equad_us"] ** 2) ** 0.5
        # EMIN/EMAX/FMIN/FMAX cuts apply to the SCALED error, after
        # the scoped EFAC/EQUAD (reference command semantics: the cut
        # sees what the fit would see)
        if st["emin_us"] is not None and toa.error_us < st["emin_us"]:
            continue
        if st["emax_us"] is not None and toa.error_us > st["emax_us"]:
            continue
        if st["fmin_mhz"] is not None \
                and toa.freq_mhz < st["fmin_mhz"]:
            continue
        if st["fmax_mhz"] is not None \
                and toa.freq_mhz > st["fmax_mhz"]:
            continue
        if st["jump_active"]:
            toa.flags.setdefault("tim_jump", str(st["jump_count"]))
        toas.append(toa)
    return toas


def write_tim(path_or_file, toas: List[TimTOA], comment: str = "") -> None:
    """Write TOAs in TEMPO2 FORMAT 1 (round-trips through parse_tim)."""
    own = not hasattr(path_or_file, "write")
    f = open(path_or_file, "w") if own else path_or_file
    try:
        f.write("FORMAT 1\n")
        if comment:
            for c in comment.splitlines():
                f.write(f"C {c}\n")
        for t in toas:
            name = t.name or "unk"
            flags = "".join(
                f" -{k} {v}" for k, v in sorted(t.flags.items()) if v != ""
            )
            f.write(
                f"{name} {t.freq_mhz:.6f} {t.mjd_str} "
                f"{t.error_us:.3f} {t.obs}{flags}\n"
            )
    finally:
        if own:
            f.close()
