"""Binary SPK (DAF) ephemeris kernel reader + Chebyshev evaluation.

Replaces jplephem (SURVEY.md §2b): a pure-numpy DAF/SPK decoder for JPL
DE kernels (de421/de430/de440 .bsp), supporting segment types 2 (position
Chebyshev) and 3 (position+velocity Chebyshev), which cover all DE-series
planetary kernels.

DAF layout (NAIF "Double Precision Array File"):
- 1024-byte records; file record holds ND/NI/FWARD/BWARD and endianness
  tag ("LTL-IEEE"/"BIG-IEEE").
- Summary records: linked list from FWARD; 3 control doubles (NEXT, PREV,
  NSUM) then NSUM summaries of ND doubles + NI int32s.
- SPK summary: (et_begin, et_end) doubles; (target, center, frame, type,
  start_word, end_word) ints; words are 1-based double offsets.
- Type 2/3 segment tail: (INIT, INTLEN, RSIZE, N); N records of RSIZE
  doubles: MID, RADIUS, then per-component Chebyshev coefficients.

Coefficients are loaded once into contiguous arrays → Chebyshev
evaluation is vectorized numpy on host (and trivially jittable later for
on-device photon barycentering).
"""

from __future__ import annotations

import numpy as np

SSB = 0
SUN = 10
EMB = 3
EARTH = 399
MOON = 301

_NAIF_IDS = {
    "ssb": 0, "mercury": 1, "venus": 2, "emb": 3, "mars": 4,
    "jupiter": 5, "saturn": 6, "uranus": 7, "neptune": 8, "pluto": 9,
    "sun": 10, "moon": 301, "earth": 399,
    # barycenter aliases: DE kernels carry planet barycenters 1..9; for
    # giant planets the barycenter is the standard timing target
    "jupiter_barycenter": 5, "saturn_barycenter": 6,
}

# seconds TDB since J2000 epoch (SPK's ET) ↔ TDB MJD
_ET0_MJD = 51544.5
_SPD = 86400.0


class _Segment:
    __slots__ = ("target", "center", "frame", "dtype", "init", "intlen",
                 "rsize", "n", "coeffs", "mids", "radii", "ncomp", "degree",
                 "et0", "et1")

    def __init__(self, daf_words, summary):
        (et0, et1), (target, center, frame, dtype, start, end) = summary
        self.target, self.center, self.frame, self.dtype = (
            target, center, frame, dtype)
        self.et0, self.et1 = float(et0), float(et1)
        if dtype not in (2, 3):
            raise NotImplementedError(f"SPK segment type {dtype}")
        tail = daf_words[end - 4:end]
        self.init, self.intlen, rsize, n = tail
        self.rsize, self.n = int(rsize), int(n)
        data = daf_words[start - 1:start - 1 + self.rsize * self.n]
        recs = data.reshape(self.n, self.rsize)
        self.mids = recs[:, 0].copy()
        self.radii = recs[:, 1].copy()
        self.ncomp = 3 if dtype == 2 else 6
        self.degree = (self.rsize - 2) // self.ncomp
        # (n, ncomp, degree)
        self.coeffs = recs[:, 2:2 + self.ncomp * self.degree].reshape(
            self.n, self.ncomp, self.degree).copy()

    def eval(self, et):
        """Position [km] (and velocity [km/s]) at ET seconds (array).
        Caller guarantees et within [et0, et1] (enforced in SPKEphemeris).
        """
        et = np.asarray(et, np.float64)
        idx = np.clip(((et - self.init) // self.intlen).astype(np.int64),
                      0, self.n - 1)
        mid = self.mids[idx]
        rad = self.radii[idx]
        s = (et - mid) / rad  # in [-1, 1]
        c = self.coeffs[idx]  # (N, ncomp, deg)
        deg = self.degree
        s2 = (2 * s)[..., None]
        b0 = np.zeros(et.shape + (3,))
        b1 = np.zeros_like(b0)
        if self.ncomp == 6:
            # type 3 carries velocity coefficients directly — no
            # derivative recurrence needed
            for k in range(deg - 1, 0, -1):
                b0, b1 = c[..., :3, k] + s2 * b0 - b1, b0
            pos = c[..., :3, 0] + s[..., None] * b0 - b1
            bv0 = np.zeros_like(b0)
            bv1 = np.zeros_like(b0)
            for k in range(deg - 1, 0, -1):
                bv0, bv1 = c[..., 3:, k] + s2 * bv0 - bv1, bv0
            vel = c[..., 3:, 0] + s[..., None] * bv0 - bv1
        else:
            # Clenshaw for T_k plus derivative accumulation for velocity
            d0 = np.zeros_like(b0)
            d1 = np.zeros_like(b0)
            for k in range(deg - 1, 0, -1):
                ck = c[..., :3, k]
                b0, b1 = ck + s2 * b0 - b1, b0
                d0, d1 = 2 * b1 + s2 * d0 - d1, d0
            pos = c[..., :3, 0] + s[..., None] * b0 - b1
            vel = (b0 + s[..., None] * d0 - d1) / rad[..., None]
        return pos, vel


class SPKEphemeris:
    """A loaded SPK kernel; resolves (target wrt SSB) chains.

    API matches AnalyticEphemeris: ssb_posvel(body, tdb_mjd) → m, m/s in
    ICRS (DE kernels are ICRS/J2000-frame).
    """

    name = "spk"

    def __init__(self, path):
        self.path = path
        words, summaries = _read_daf(path)
        self.segments = [_Segment(words, s) for s in summaries]
        self._by_target = {}
        for seg in self.segments:
            self._by_target.setdefault(seg.target, []).append(seg)

    def _posvel_wrt(self, target, et):
        """Walk center chain target → SSB; km, km/s. Per-epoch segment
        selection by time coverage; epochs outside every segment raise
        (no silent Chebyshev extrapolation)."""
        pos = np.zeros(et.shape + (3,))
        vel = np.zeros_like(pos)
        body = target
        hops = 0
        while body != SSB:
            segs = self._by_target.get(body)
            if not segs:
                raise KeyError(
                    f"kernel {self.path} has no segment for body {body}")
            covered = np.zeros(et.shape, dtype=bool)
            center = segs[0].center
            for seg in segs:
                if seg.center != center:
                    raise NotImplementedError(
                        f"body {body}: segments with mixed centers")
                m = (~covered) & (et >= seg.et0) & (et <= seg.et1)
                if not m.any():
                    continue
                p, v = seg.eval(et[m])
                pos[m] += p
                vel[m] += v
                covered |= m
            if not covered.all():
                bad = et[~covered]
                raise ValueError(
                    f"kernel {self.path}: body {body} has no coverage for "
                    f"ET in [{bad.min():.0f}, {bad.max():.0f}] s past J2000 "
                    f"(kernel spans [{min(s.et0 for s in segs):.0f}, "
                    f"{max(s.et1 for s in segs):.0f}])")
            body = center
            hops += 1
            if hops > 10:
                raise RuntimeError("SPK center chain does not reach SSB")
        return pos, vel

    def ssb_posvel(self, body, tdb_mjd):
        if isinstance(body, (int, np.integer)):
            body_id = int(body)
        else:
            try:
                body_id = _NAIF_IDS[str(body).lower()]
            except KeyError:
                raise KeyError(
                    f"unknown body {body!r}; known: {sorted(_NAIF_IDS)}"
                ) from None
        tdb_mjd = np.atleast_1d(np.asarray(tdb_mjd, np.float64))
        et = (tdb_mjd - _ET0_MJD) * _SPD
        pos, vel = self._posvel_wrt(body_id, et)
        return pos * 1e3, vel * 1e3  # km → m


def _read_daf(path):
    """Return (word array: f64 view of whole file, SPK summaries)."""
    raw = np.fromfile(path, dtype=np.uint8)
    header = raw[:1024].tobytes()
    locidw = header[:8].decode("ascii", "replace")
    if not locidw.startswith("DAF/SPK"):
        raise ValueError(f"{path}: not an SPK DAF (LOCIDW={locidw!r})")
    locfmt = header[88:96].decode("ascii", "replace")
    if locfmt.startswith("BIG"):
        i4, f8 = ">i4", ">f8"
    else:
        i4, f8 = "<i4", "<f8"
    nd = int(np.frombuffer(header, i4, 1, 8)[0])
    ni = int(np.frombuffer(header, i4, 1, 12)[0])
    fward = int(np.frombuffer(header, i4, 1, 76)[0])
    if (nd, ni) != (2, 6):
        raise ValueError(f"{path}: unexpected DAF ND/NI = {nd}/{ni}")
    # reinterpret in place — no second copy of a ~100 MB kernel
    nwords = raw.size // 8
    words = raw[:nwords * 8].view(np.dtype(f8))
    if f8.startswith(">") and np.little_endian or \
       f8.startswith("<") and not np.little_endian:
        words = words.astype(np.float64)  # byteswap copy only if needed
    else:
        words = np.ascontiguousarray(words)
    summaries = []
    rec = fward
    ss = nd + (ni + 1) // 2  # summary size in doubles
    while rec > 0:
        base = (rec - 1) * 128  # record start in words
        nxt, _prev, nsum = words[base:base + 3]
        for i in range(int(nsum)):
            off = base + 3 + i * ss
            dbl = words[off:off + nd]
            # decode packed int32 pairs from the ORIGINAL bytes — the
            # native `words` array may have been lane-byteswapped, which
            # would scramble int32 order within each 8-byte word
            bo = (off + nd) * 8
            ints = np.frombuffer(
                raw[bo:bo + (ss - nd) * 8].tobytes(), dtype=i4)[:ni]
            summaries.append(((float(dbl[0]), float(dbl[1])),
                              tuple(int(x) for x in ints)))
        rec = int(nxt)
    return words, summaries
