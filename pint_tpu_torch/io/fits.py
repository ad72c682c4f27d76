"""Minimal FITS binary-table I/O (host side).

The reference reads mission event files through astropy.io.fits
(src/pint/event_toas.py load_fits_TOAs); astropy does not exist in this
image, so this module implements the small slice of the FITS standard
the photon pipeline needs: header parsing, BINTABLE column decode
(big-endian scalar columns), and writing a compliant single-extension
event table (used both by tests and by the photonphase CLI to write
PULSE_PHASE back).
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["FitsHDU", "read_fits", "read_events_fits",
           "write_events_fits"]

BLOCK = 2880
CARD = 80

# TFORM letter -> numpy big-endian dtype
_TFORM_DTYPES = {
    "L": "u1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8",
}


class FitsHDU:
    """One header-data unit: header dict + (for BINTABLE) column data."""

    def __init__(self, header: Dict[str, object],
                 data: Optional[Dict[str, np.ndarray]] = None):
        self.header = header
        self.data = data or {}

    @property
    def name(self) -> str:
        return str(self.header.get("EXTNAME", ""))


def _parse_card(card: bytes) -> Optional[Tuple[str, object]]:
    key = card[:8].decode("ascii", "replace").strip()
    if key in ("", "COMMENT", "HISTORY", "END"):
        return None
    if card[8:10] != b"= ":
        return None
    raw = card[10:].decode("ascii", "replace")
    # strip inline comment (outside quoted strings)
    if raw.lstrip().startswith("'"):
        s = raw.lstrip()[1:]
        out, i = [], 0
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        return key, "".join(out).rstrip()
    val = raw.split("/")[0].strip()
    if val in ("T", "F"):
        return key, val == "T"
    try:
        return key, int(val)
    except ValueError:
        pass
    try:
        return key, float(val)
    except ValueError:
        return key, val


def _read_header(f) -> Optional[Dict[str, object]]:
    header: Dict[str, object] = {}
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            return None if not header else header
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD]
            if card[:3] == b"END":
                return header
            kv = _parse_card(card)
            if kv:
                header[kv[0]] = kv[1]


def _parse_tform(tform: str) -> Tuple[int, str]:
    """'1D' -> (1, 'D'); 'E' -> (1, 'E'); '10A' -> (10, 'A')."""
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    return repeat, tform[i:i + 1]


def _read_bintable(f, header) -> Dict[str, np.ndarray]:
    nrow = int(header["NAXIS2"])
    rowbytes = int(header["NAXIS1"])
    nfield = int(header["TFIELDS"])
    raw = f.read(nrow * rowbytes)
    pad = (-(nrow * rowbytes)) % BLOCK
    f.read(pad)
    cols: Dict[str, np.ndarray] = {}
    offset = 0
    for k in range(1, nfield + 1):
        name = str(header.get(f"TTYPE{k}", f"COL{k}")).strip()
        repeat, letter = _parse_tform(str(header[f"TFORM{k}"]).strip())
        if letter == "A":
            arr = np.frombuffer(
                raw, dtype=f"S{repeat}", count=nrow,
                offset=offset).astype(str) if nrow else np.array([])
            width = repeat
        else:
            dt = np.dtype(_TFORM_DTYPES[letter])
            width = dt.itemsize * repeat
            # strided view over rows
            full = np.frombuffer(raw, dtype=np.uint8).reshape(
                nrow, rowbytes) if nrow else np.zeros((0, rowbytes),
                                                      np.uint8)
            sub = full[:, offset:offset + width].copy()
            arr = sub.view(dt).reshape(nrow, repeat)
            if repeat == 1:
                arr = arr[:, 0]
            arr = arr.astype(dt.newbyteorder("="))
        cols[name] = arr
        offset += width
    return cols


def read_fits(path_or_bytes) -> List[FitsHDU]:
    """Parse all HDUs; BINTABLE extensions get decoded column data."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, "rb")
    try:
        hdus: List[FitsHDU] = []
        while True:
            header = _read_header(f)
            if header is None:
                break
            data: Dict[str, np.ndarray] = {}
            naxis = int(header.get("NAXIS", 0))
            if header.get("XTENSION", "").strip() == "BINTABLE":
                data = _read_bintable(f, header)
            elif naxis > 0:
                nbytes = abs(int(header.get("BITPIX", 8))) // 8
                for i in range(1, naxis + 1):
                    nbytes *= int(header[f"NAXIS{i}"])
                f.read(nbytes + ((-nbytes) % BLOCK))
            hdus.append(FitsHDU(header, data))
        return hdus
    finally:
        f.close()


def read_events_fits(path) -> Tuple[Dict[str, np.ndarray],
                                    Dict[str, object]]:
    """(columns, header) of the EVENTS extension (first BINTABLE named
    EVENTS, else the first BINTABLE)."""
    hdus = read_fits(path)
    tables = [h for h in hdus if h.data]
    if not tables:
        raise ValueError(f"no binary-table extension in {path}")
    for h in tables:
        if h.name.upper() == "EVENTS":
            return h.data, h.header
    return tables[0].data, tables[0].header


# ------------------------------------------------------------- writing


def _card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        s = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        s = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        s = f"{key:<8}= {value:>20.15G}"
    else:
        s = f"{key:<8}= '{value}'"
    if comment:
        s += f" / {comment}"
    return s[:CARD].ljust(CARD).encode("ascii")


def _pad_block(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((-len(b)) % BLOCK)


def write_events_fits(path, columns: Dict[str, np.ndarray],
                      header_extra: Optional[Dict[str, object]] = None,
                      extname: str = "EVENTS") -> None:
    """Write a minimal standard-compliant FITS file with an empty
    primary HDU and one BINTABLE of the given scalar columns (float64 ->
    D, float32 -> E, int -> J)."""
    names = list(columns)
    n = len(next(iter(columns.values()))) if names else 0
    enc = []
    for nm in names:
        a = np.asarray(columns[nm])
        if a.dtype.kind == "f" and a.dtype.itemsize == 4:
            enc.append((nm, "E", a.astype(">f4")))
        elif a.dtype.kind == "f":
            enc.append((nm, "D", a.astype(">f8")))
        else:
            enc.append((nm, "J", a.astype(">i4")))
    rowbytes = sum(a.dtype.itemsize for _, _, a in enc)

    primary = [_card("SIMPLE", True), _card("BITPIX", 8),
               _card("NAXIS", 0), _card("EXTEND", True),
               b"END".ljust(CARD)]
    out = _pad_block(b"".join(primary), b" ")

    cards = [_card("XTENSION", "BINTABLE"), _card("BITPIX", 8),
             _card("NAXIS", 2), _card("NAXIS1", rowbytes),
             _card("NAXIS2", n), _card("PCOUNT", 0), _card("GCOUNT", 1),
             _card("TFIELDS", len(enc)), _card("EXTNAME", extname)]
    for k, (nm, letter, _) in enumerate(enc, start=1):
        cards.append(_card(f"TTYPE{k}", nm))
        cards.append(_card(f"TFORM{k}", letter))
    for k, v in (header_extra or {}).items():
        cards.append(_card(k, v))
    cards.append(b"END".ljust(CARD))
    out += _pad_block(b"".join(cards), b" ")

    rec = np.zeros(n, dtype=[(nm, a.dtype) for nm, _, a in enc])
    for nm, _, a in enc:
        rec[nm] = a
    out += _pad_block(rec.tobytes())
    with open(path, "wb") as f:
        f.write(out)
