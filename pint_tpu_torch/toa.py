"""TOA container and the ingestion pipeline (clock → TDB → posvels)
(a port of pint_tpu/toa.py; reference: src/pint/toa.py TOA, TOAs,
get_TOAs, get_TOAs_array, save_pickle, load_pickle).

All Earth-frame, clock and ephemeris physics is precomputed once, on the
host, into flat numpy columns (the reference's host code, copied); the
device then sees a ``ToaBatch``, a NamedTuple of float64 torch tensors,
made by ``TOAs.to_batch(device)`` with one host→device copy.

Times are carried as (int day f64, fraction as host double-double pair)
and never squeezed through a single float64.

A processed table persists as a columnar npz (``TOAs.to_npz``/
``from_npz``; ``get_TOAs(usecache=True)`` keeps one per tim file, keyed
on the tim content, the pipeline's settings and this package's name and
version), as a FORMAT-1 tim file (``write_TOA_file``) or as a pickle
(``save_pickle``/``load_pickle``). A table holds numpy columns only, no
tensor, so each of them loads on a machine without a GPU; the loaded
table's device is resolved at load.
"""

from __future__ import annotations

import itertools
import json
import os
import pickle
import threading
import uuid
import zipfile
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from pint_tpu_torch import __version__, c_m_s, config, resolve_device
from pint_tpu_torch.ephemeris import get_ephemeris
from pint_tpu_torch.io.tim import TimTOA, parse_tim, write_tim
from pint_tpu_torch.observatory import get_observatory
from pint_tpu_torch.ops import dd_np
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.time import mjd as mjdmod
from pint_tpu_torch.time import scales

SECS_PER_DAY = 86400.0

# Monotonic token identifying a TOAs *state* (object identity is not
# enough: Python reuses ids after GC, and a TOAs can be mutated in
# place by the pipeline). TimingModel keys its per-batch cache on this.
_TOAS_SERIAL = itertools.count(1)

# Planets used by PLANET_SHAPIRO, in reference order
# (src/pint/models/solar_system_shapiro.py _ss_obj_delay callers).
PLANETS = ("jupiter", "saturn", "venus", "uranus", "neptune")


class ToaBatch(NamedTuple):
    """Device struct-of-arrays view of a TOA set: float64 tensors on one
    device. Positions are in light-seconds, velocities in lt-s/s (v/c).
    """

    tdb_day: torch.Tensor        # (N,) integer TDB day (f64-exact)
    tdb_frac: DD                 # (N,) dd TDB day fraction
    freq_mhz: torch.Tensor       # (N,) barycentric obs frequency (inf ok)
    error_us: torch.Tensor       # (N,) raw TOA uncertainty
    ssb_obs_pos: torch.Tensor    # (N,3) SSB→observatory, lt-s
    ssb_obs_vel: torch.Tensor    # (N,3) d/dt of the above, lt-s/s
    obs_sun_pos: torch.Tensor    # (N,3) observatory→Sun, lt-s
    obs_planet_pos: torch.Tensor  # (P,N,3) observatory→planet, lt-s
    pulse_number: torch.Tensor   # (N,) f64, NaN where untracked

    @property
    def ntoas(self):
        return self.freq_mhz.shape[0]


# host column name (tdb_frac split in two) → leaf, in buffer order
_COLUMNS = ("tdb_day", "tdb_frac_hi", "tdb_frac_lo", "freq_mhz",
            "error_us", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos",
            "obs_planet_pos", "pulse_number")


def pack_batch(cols: Dict[str, np.ndarray], device) -> ToaBatch:
    """ToaBatch on ``device`` from float64 host columns, moved by ONE
    host→device copy: the columns are laid end to end in one buffer and
    every leaf is a contiguous view of the copy."""
    arrays = [np.ascontiguousarray(cols[k], dtype=np.float64)
              for k in _COLUMNS]
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
    dev_flat = flat.to(device)
    views, off = {}, 0
    for k, a in zip(_COLUMNS, arrays):
        views[k] = dev_flat[off:off + a.size].view(a.shape)
        off += a.size
    return ToaBatch(
        tdb_day=views["tdb_day"],
        tdb_frac=DD(views["tdb_frac_hi"], views["tdb_frac_lo"]),
        freq_mhz=views["freq_mhz"],
        error_us=views["error_us"],
        ssb_obs_pos=views["ssb_obs_pos"],
        ssb_obs_vel=views["ssb_obs_vel"],
        obs_sun_pos=views["obs_sun_pos"],
        obs_planet_pos=views["obs_planet_pos"],
        pulse_number=views["pulse_number"],
    )


class TOAs:
    """Host-side TOA table (reference: TOAs over an astropy Table; here a
    plain struct of numpy columns + python-side flags), made from parsed
    .tim lines (get_TOAs) or by get_TOAs_array. ``device`` is where
    ``to_batch()`` puts the batch by default; ``weights`` holds photon
    weights or None."""

    def __init__(self, timtoas: List[TimTOA], device=None):
        self.device = resolve_device(device)
        days, frac = mjdmod.parse_mjd_strings([t.mjd_str for t in timtoas])
        self.mjd_day = days                      # UTC (pulsar-MJD) int day
        self.mjd_frac = frac                     # dd day fraction
        self.freq_mhz = np.array(
            [t.freq_mhz if t.freq_mhz > 0 else np.inf for t in timtoas])
        self.error_us = np.array([t.error_us for t in timtoas])
        self.obs = [get_observatory(t.obs).name for t in timtoas]
        self.flags: List[Dict[str, str]] = [dict(t.flags) for t in timtoas]
        self.names = [t.name for t in timtoas]
        # applied "TIME" offsets from the tim file (seconds)
        toff = np.array([float(f.get("to", 0.0)) for f in self.flags])
        if np.any(toff != 0.0):
            self.mjd_frac = dd_np.add(
                self.mjd_frac, dd_np.div_f(dd_np.dd(toff), SECS_PER_DAY))
        self.clock_applied = False
        self.weights = None
        # populated by the pipeline:
        self.tdb_day = None
        self.tdb_frac = None
        self.ssb_obs_pos = None   # (N,3) meters
        self.ssb_obs_vel = None   # (N,3) m/s
        self.obs_sun_pos = None
        self.obs_planet_pos = None  # dict name -> (N,3) m
        self.ephem = None
        self.planets = False
        self._serial = next(_TOAS_SERIAL)

    def _touch(self):
        """Mark this TOAs state as changed (invalidates model caches)."""
        self._serial = next(_TOAS_SERIAL)

    def __setstate__(self, d):
        """A pickled serial is only unique in the ORIGIN process: an
        unpickled TOAs carrying it could collide with a local TOAs and
        make TimingModel.get_cache return the wrong batch — reassign a
        fresh process-local serial on load."""
        self.__dict__.update(d)
        self._serial = next(_TOAS_SERIAL)

    @property
    def cache_key(self):
        return self._serial

    # ---------------- basic container protocol ----------------

    def __len__(self):
        return len(self.obs)

    @property
    def ntoas(self):
        return len(self.obs)

    def get_mjds(self, high_precision=False):
        """UTC MJDs as f64 (or (day, frac-dd) when high_precision)."""
        if high_precision:
            return self.mjd_day, self.mjd_frac
        return self.mjd_day + dd_np.to_f64(self.mjd_frac)

    def get_errors(self):
        return self.error_us

    def get_freqs(self):
        return self.freq_mhz

    def get_obss(self):
        return list(self.obs)

    def get_flag_value(self, flag, fill_value=None, as_type=None):
        out = []
        for f in self.flags:
            v = f.get(flag, fill_value)
            if v is not None and as_type is not None:
                v = as_type(v)
            out.append(v)
        return out

    @property
    def index(self):
        """Original position of each TOA, surviving select() subsets
        (reference: the TOAs table "index" column); 0..N-1 until a
        subset or renumber() sets it."""
        ix = getattr(self, "_index", None)
        if ix is None or len(ix) != self.ntoas:
            self._index = np.arange(self.ntoas)
        return self._index

    def renumber(self, index_order=True):
        """Reset the index column (reference: TOAs.renumber):
        index_order=True numbers 0..N-1 in storage order; False keeps
        the relative order of the existing indices (ranks)."""
        if index_order:
            self._index = np.arange(self.ntoas)
        else:
            self._index = np.argsort(np.argsort(self.index))
        self._touch()

    def get_pulse_numbers(self):
        pn = self.get_flag_value("pn", fill_value="nan", as_type=float)
        arr = np.array(pn)
        return None if np.all(np.isnan(arr)) else arr

    def compute_pulse_numbers(self, model, device=None):
        """Attach -pn flags from the model's nearest-integer absolute
        phase (reference: TOAs.compute_pulse_numbers), evaluated on
        ``device`` (the model's when None)."""
        ph = model.phase(self, abs_phase=True, device=device)
        pn = ph.int.cpu().numpy()
        for f, p in zip(self.flags, pn):
            f["pn"] = repr(float(p))
        self._touch()

    # how select() carries each attribute a table can hold; a table
    # attribute without a rule here is lost by select(), which
    # tests/test_torch_host_api.py checks attribute by attribute
    _SELECT_ROWS = ("mjd_day", "freq_mhz", "error_us", "tdb_day",
                    "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos", "weights")
    _SELECT_ROW_PAIRS = ("mjd_frac", "tdb_frac")
    _SELECT_ROW_LISTS = ("obs", "names")
    _SELECT_SHARED = ("device", "clock_applied", "ephem", "planets")
    # scratch of compute_TDBs, read only by compute_posvels on the same
    # table
    _SELECT_DROPPED = ("_site_gcrs_cache",)

    def select(self, mask):
        """The subset at a boolean mask or an index array, as a new
        table with its own serial (reference: TOAs.select, here
        non-destructive): a model's TOA cache never serves the parent's
        batch for it. Every column is carried; ``index`` keeps the
        original positions."""
        mask = np.asarray(mask)
        idx = np.flatnonzero(mask) if mask.dtype == bool else mask
        out = object.__new__(TOAs)
        for k in self._SELECT_ROWS:
            v = getattr(self, k, None)
            setattr(out, k, None if v is None else v[idx])
        for k in self._SELECT_ROW_PAIRS:
            v = getattr(self, k, None)
            setattr(out, k, None if v is None else (v[0][idx], v[1][idx]))
        for k in self._SELECT_ROW_LISTS:
            v = getattr(self, k)
            setattr(out, k, [v[i] for i in idx])
        for k in self._SELECT_SHARED:
            setattr(out, k, getattr(self, k))
        out.flags = [dict(self.flags[i]) for i in idx]
        out.obs_planet_pos = None if self.obs_planet_pos is None else \
            {k: v[idx] for k, v in self.obs_planet_pos.items()}
        out._index = self.index[idx]
        out._serial = next(_TOAS_SERIAL)
        return out

    def first_MJD(self):
        return float(np.min(self.get_mjds()))

    def last_MJD(self):
        return float(np.max(self.get_mjds()))

    # ---------------- the pipeline ----------------

    def apply_clock_corrections(self, include_gps=True, include_bipm=True,
                                bipm_version="BIPM2021", limits="warn"):
        """Add observatory clock chain to the raw MJDs, per obs group
        (reference: TOAs.apply_clock_corrections)."""
        if self.clock_applied:
            return
        mjd_f64 = self.get_mjds()
        corr = np.zeros(self.ntoas)
        for site in set(self.obs):
            m = np.array([o == site for o in self.obs])
            obs = get_observatory(site)
            corr[m] = obs.clock_corrections(
                mjd_f64[m], include_gps=include_gps,
                include_bipm=include_bipm, bipm_version=bipm_version,
                limits=limits)
        self.mjd_frac = dd_np.add(
            self.mjd_frac, dd_np.div_f(dd_np.dd(corr), SECS_PER_DAY))
        for f, c in zip(self.flags, corr):
            f["clkcorr"] = repr(float(c))
        self.clock_applied = True
        self._touch()

    def compute_TDBs(self, ephem=None):
        """UTC(site) → TT → TDB per TOA (reference: TOAs.compute_TDBs).
        Barycenter-site TOAs are already TDB and pass through. Ground
        sites get the topocentric TDB−TT term +(v_earth . r_obs)/c^2 on
        top of the geocentric Fairhead–Bretagnon series."""
        tdb_day = np.array(self.mjd_day)
        fhi = np.array(self.mjd_frac[0])
        flo = np.array(self.mjd_frac[1])
        scale = np.array(
            [get_observatory(o).timescale for o in self.obs])
        utc_mask = scale != "tdb"
        if np.any(utc_mask):
            day = self.mjd_day[utc_mask]
            frac = (self.mjd_frac[0][utc_mask], self.mjd_frac[1][utc_mask])
            tt = scales.utc_mjd_to_tt_mjd(day, frac)
            tdb = scales.tt_mjd_to_tdb_mjd(tt)
            # topocentric term for every non-geocentric observer
            tt_f64 = dd_np.to_f64(tt)
            utc_f64 = (day + frac[0] + frac[1])
            dt_topo = np.zeros_like(tt_f64)
            sub_obs = [o for o, m in zip(self.obs, utc_mask) if m]
            sub_flags = [f for f, m in zip(self.flags, utc_mask) if m]
            self._site_gcrs_cache = {}
            if sub_obs:
                eph = get_ephemeris(ephem)
                _, v_earth = eph.ssb_posvel("earth", tt_f64)
                for site in set(sub_obs):
                    m = np.array([o == site for o in sub_obs])
                    obs = get_observatory(site)
                    if hasattr(obs, "posvel_from_flags"):
                        r_m, v_m = obs.posvel_from_flags(
                            [f for f, mm in zip(sub_flags, m) if mm])
                    else:
                        r_m, v_m = obs.gcrs_posvel(utc_f64[m],
                                                   tt_f64[m])
                    # reused by compute_posvels (same epochs)
                    self._site_gcrs_cache[site] = (m, r_m, v_m)
                    dt_topo[m] = np.sum(v_earth[m] * r_m,
                                        axis=-1) / c_m_s ** 2
            tdb = dd_np.add(tdb, dd_np.div_f(dd_np.dd(dt_topo),
                                             SECS_PER_DAY))
            # renormalize to (int day, frac) — keep day integral for exact
            # downstream (day − epoch) arithmetic
            d = np.round(tdb[0])
            rest = dd_np.add_f(dd_np.dd(tdb[0] - d, tdb[1]), 0.0)
            tdb_day[utc_mask] = d
            fhi[utc_mask] = rest[0]
            flo[utc_mask] = rest[1]
        self.tdb_day = tdb_day
        self._touch()
        self.tdb_frac = (fhi, flo)

    def compute_posvels(self, ephem=None, planets=False):
        """Observatory SSB position/velocity and Sun/planet geometry at
        each TDB (reference: TOAs.compute_posvels)."""
        if self.tdb_day is None:
            self.compute_TDBs(ephem=ephem)
        eph = get_ephemeris(ephem)
        self.ephem = getattr(eph, "name", str(ephem))
        self.planets = planets
        tdb = self.tdb_day + dd_np.to_f64(self.tdb_frac)
        utc = self.get_mjds()
        earth_pos, earth_vel = eph.ssb_posvel("earth", tdb)
        obs_pos = np.zeros((self.ntoas, 3))
        obs_vel = np.zeros((self.ntoas, 3))
        cache = getattr(self, "_site_gcrs_cache", {})
        for site in set(self.obs):
            m = np.array([o == site for o in self.obs])
            obs = get_observatory(site)
            if obs.name == "barycenter":
                # positions stay zero; earth contribution removed below
                continue
            cached = cache.get(site)
            if cached is not None and \
                    cached[0].sum() == int(m.sum()):
                obs_pos[m] = cached[1]
                obs_vel[m] = cached[2]
                continue
            if hasattr(obs, "posvel_from_flags"):  # T2SpacecraftObs
                p, v = obs.posvel_from_flags(
                    [f for f, mm in zip(self.flags, m) if mm])
                obs_pos[m] = p
                obs_vel[m] = v
                continue
            p, v = obs.gcrs_posvel(utc[m], tdb[m])
            obs_pos[m] = p
            obs_vel[m] = v
        bary = np.array([o == "barycenter" for o in self.obs])
        ssb_obs_pos = earth_pos + obs_pos
        ssb_obs_vel = earth_vel + obs_vel
        if np.any(bary):
            ssb_obs_pos[bary] = 0.0
            ssb_obs_vel[bary] = 0.0
        self.ssb_obs_pos = ssb_obs_pos
        self.ssb_obs_vel = ssb_obs_vel
        sun_pos, _ = eph.ssb_posvel("sun", tdb)
        self.obs_sun_pos = sun_pos - ssb_obs_pos
        self.obs_planet_pos = {}
        if planets:
            for pl in PLANETS:
                p, _ = eph.ssb_posvel(pl, tdb)
                self.obs_planet_pos[pl] = p - ssb_obs_pos
        self._touch()

    # ---------------- device view ----------------

    def to_batch(self, device=None) -> ToaBatch:
        """The device batch (meters → light-seconds), on ``device`` or
        this table's device, in one host→device copy."""
        if self.ssb_obs_pos is None:
            raise ValueError(
                "run compute_posvels() (or use get_TOAs_array) before "
                "to_batch()")
        dev = self.device if device is None else resolve_device(device)
        pn = self.get_pulse_numbers()
        if pn is None:
            pn = np.full(self.ntoas, np.nan)
        planet = np.stack(
            [self.obs_planet_pos[p] for p in PLANETS], axis=0
        ) / c_m_s if self.obs_planet_pos else np.zeros((0, self.ntoas, 3))
        return pack_batch({
            "tdb_day": self.tdb_day,
            "tdb_frac_hi": self.tdb_frac[0],
            "tdb_frac_lo": self.tdb_frac[1],
            "freq_mhz": self.freq_mhz,
            "error_us": self.error_us,
            "ssb_obs_pos": self.ssb_obs_pos / c_m_s,
            "ssb_obs_vel": self.ssb_obs_vel / c_m_s,
            "obs_sun_pos": self.obs_sun_pos / c_m_s,
            "obs_planet_pos": planet,
            "pulse_number": pn,
        }, dev)


    # ---------------- persistence ----------------

    def to_npz(self, path, cache_key=None):
        """Columnar snapshot of the fully-processed TOA table (reference:
        TOAs.to_npz; npz: no code execution on load). Photon weights are
        not stored. The write is atomic: a reader of a shared cache path
        never sees a half-written file."""
        arrays = {} if cache_key is None else \
            {"cache_key": np.array(cache_key)}
        arrays |= {
            "mjd_day": self.mjd_day,
            "mjd_frac_hi": self.mjd_frac[0],
            "mjd_frac_lo": self.mjd_frac[1],
            "freq_mhz": self.freq_mhz,
            "error_us": self.error_us,
            "obs": np.array(self.obs),
            "names": np.array(self.names),
            "flags_json": np.array(json.dumps(self.flags)),
            "meta_json": np.array(json.dumps({
                "clock_applied": bool(self.clock_applied),
                "ephem": self.ephem,
                "planets": bool(self.planets)})),
        }
        for col in ("tdb_day", "ssb_obs_pos", "ssb_obs_vel",
                    "obs_sun_pos"):
            v = getattr(self, col)
            if v is not None:
                arrays[col] = v
        if self.tdb_frac is not None:
            arrays["tdb_frac_hi"] = self.tdb_frac[0]
            arrays["tdb_frac_lo"] = self.tdb_frac[1]
        if self.obs_planet_pos is not None:
            arrays["planet_names"] = np.array(
                sorted(self.obs_planet_pos))
            for k, v in self.obs_planet_pos.items():
                arrays[f"planet_{k}"] = v
        # the tmp name is unique per process and thread
        tmp = (f"{path}.{os.getpid()}.{threading.get_ident()}."
               f"{uuid.uuid4().hex[:8]}.tmp")
        try:
            with open(tmp, "wb") as fh:
                np.savez_compressed(fh, **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def from_npz(cls, path, expect_key=None, device=None) -> "TOAs":
        """Load a snapshot onto ``device`` (None means "cuda").
        ``expect_key``: verify the embedded cache key from the SAME open
        file the arrays come from (a separate check-then-load would race
        a concurrent overwrite of the shared cache path)."""
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            if expect_key is not None and (
                    "cache_key" not in z.files
                    or str(z["cache_key"]) != expect_key):
                raise ValueError("cache key mismatch")
            out = object.__new__(cls)
            out.device = dev
            out.weights = None
            out.mjd_day = z["mjd_day"]
            out.mjd_frac = (z["mjd_frac_hi"], z["mjd_frac_lo"])
            out.freq_mhz = z["freq_mhz"]
            out.error_us = z["error_us"]
            out.obs = [str(o) for o in z["obs"]]
            out.names = [str(n) for n in z["names"]]
            out.flags = json.loads(str(z["flags_json"]))
            meta = json.loads(str(z["meta_json"]))
            out.clock_applied = meta["clock_applied"]
            out.ephem = meta["ephem"]
            out.planets = meta["planets"]
            for col in ("tdb_day", "ssb_obs_pos", "ssb_obs_vel",
                        "obs_sun_pos"):
                setattr(out, col, z[col] if col in z.files else None)
            out.tdb_frac = (z["tdb_frac_hi"], z["tdb_frac_lo"]) \
                if "tdb_frac_hi" in z.files else None
            out.obs_planet_pos = None
            if "planet_names" in z.files:
                out.obs_planet_pos = {
                    str(k): z[f"planet_{k}"]
                    for k in z["planet_names"]}
        out._serial = next(_TOAS_SERIAL)
        return out

    def write_TOA_file(self, path):
        """Write a FORMAT-1 tim file (reference: TOAs.write_TOA_file).
        Clock corrections, if applied, are subtracted so the file holds
        the original site-clock MJDs (16 digits of the day fraction);
        the ``clkcorr`` and ``to`` flags are dropped."""
        day, frac = self.mjd_day, self.mjd_frac
        if self.clock_applied:
            corr = np.array(
                [float(f.get("clkcorr", 0.0)) for f in self.flags])
            frac = dd_np.sub(frac, dd_np.div_f(dd_np.dd(corr), SECS_PER_DAY))
        out = []
        for i in range(self.ntoas):
            flags = {k: v for k, v in self.flags[i].items()
                     if k not in ("clkcorr", "to")}
            out.append(TimTOA(
                mjd_str=mjdmod.mjd_to_str(day[i], (frac[0][i], frac[1][i])),
                freq_mhz=float(self.freq_mhz[i])
                if np.isfinite(self.freq_mhz[i]) else 0.0,
                error_us=float(self.error_us[i]),
                obs=self.obs[i], name=self.names[i] or f"toa{i}",
                flags=flags))
        write_tim(path, out)


def save_pickle(toas: TOAs, picklefilename: str) -> None:
    """Pickle a TOAs object (reference: toa.save_pickle). It holds numpy
    columns and a torch.device, no tensor. The npz snapshot
    (TOAs.to_npz) runs no code on load; prefer it for shared caches."""
    with open(picklefilename, "wb") as fh:
        pickle.dump(toas, fh, protocol=pickle.HIGHEST_PROTOCOL)


def load_pickle(picklefilename: str, device=None) -> TOAs:
    """Unpickle a TOAs object (reference: toa.load_pickle) onto
    ``device`` (None means "cuda"). Only load files you wrote yourself:
    pickle executes code on load."""
    dev = resolve_device(device)
    with open(picklefilename, "rb") as fh:
        out = pickle.load(fh)
    if not isinstance(out, TOAs):
        raise TypeError(f"{picklefilename!r} did not contain a TOAs "
                        f"object (got {type(out).__name__})")
    out.device = dev
    return out


def _cache_key(timfile, knobs) -> str:
    """The TOA cache key of a tim file: a hash of its content, every
    pipeline setting, the clock and ephemeris override directories, and
    this package's name and version. The name keeps a cache the JAX
    package wrote (same file name, same version) from ever loading here."""
    import hashlib

    with open(timfile, "rb") as fh:
        digest = hashlib.sha256(fh.read())
    dirs = tuple(None if d is None else str(d)
                 for d in (config.clock_dir(), config.ephem_dir()))
    digest.update(repr(("pint_tpu_torch", __version__) + tuple(knobs)
                       + dirs).encode())
    return digest.hexdigest()


def merge_TOAs(toas_list: List[TOAs]) -> TOAs:
    """Concatenate TOA sets (reference: merge_TOAs). All inputs must be
    at the same pipeline stage; the result takes the first one's
    device."""
    first = toas_list[0]
    out = object.__new__(TOAs)
    out.device = first.device
    out.weights = None
    out.mjd_day = np.concatenate([t.mjd_day for t in toas_list])
    out.mjd_frac = (
        np.concatenate([t.mjd_frac[0] for t in toas_list]),
        np.concatenate([t.mjd_frac[1] for t in toas_list]))
    out.freq_mhz = np.concatenate([t.freq_mhz for t in toas_list])
    out.error_us = np.concatenate([t.error_us for t in toas_list])
    out.obs = sum((t.obs for t in toas_list), [])
    out.flags = sum(([dict(f) for f in t.flags] for t in toas_list), [])
    out.names = sum((t.names for t in toas_list), [])
    out.clock_applied = first.clock_applied
    out.ephem = first.ephem
    out.planets = first.planets
    stages = {t.clock_applied for t in toas_list}
    if len(stages) > 1:
        raise ValueError("cannot merge TOAs at different pipeline stages")
    for col in ("tdb_day", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos"):
        vals = [getattr(t, col) for t in toas_list]
        setattr(out, col,
                None if any(v is None for v in vals)
                else np.concatenate(vals))
    fracs = [t.tdb_frac for t in toas_list]
    out.tdb_frac = None if any(f is None for f in fracs) else (
        np.concatenate([f[0] for f in fracs]),
        np.concatenate([f[1] for f in fracs]))
    pls = [t.obs_planet_pos for t in toas_list]
    if any(p is None for p in pls):
        out.obs_planet_pos = None
    elif any(bool(p) != bool(pls[0]) for p in pls):
        raise ValueError(
            "cannot merge TOAs with and without planet positions; "
            "recompute with a consistent planets= setting")
    elif not pls[0]:
        out.obs_planet_pos = {}
    else:
        out.obs_planet_pos = {
            k: np.concatenate([p[k] for p in pls]) for k in pls[0]}
    out._serial = next(_TOAS_SERIAL)
    return out


def get_TOAs(timfile, ephem=None, planets=False, model=None,
             include_gps=True, include_bipm=True, bipm_version="BIPM2021",
             limits="warn", usecache=False, cachedir=None,
             device=None) -> TOAs:
    """One-call ingestion pipeline for a .tim file: parse → clock → TDB
    → posvels (reference: get_TOAs). ``device`` (None means "cuda") is
    where to_batch() puts the batch.

    With ``usecache`` (reference: usepickle), the fully-processed TOAs
    are stored as a columnar npz next to the tim file (or in
    ``cachedir``), one file per tim file, keyed as ``_cache_key`` says;
    a stale, foreign or unreadable cache is rebuilt silently."""
    dev = resolve_device(device)
    if model is not None:
        if ephem is None:
            ephem = getattr(model, "EPHEM", None) and model.EPHEM.value
        if not planets:
            ps = getattr(model, "PLANET_SHAPIRO", None)
            planets = bool(ps is not None and ps.value)
    cache_path = cache_key = None
    if usecache and isinstance(timfile, (str, os.PathLike)):
        fpath = os.fspath(timfile)
        try:
            cache_key = _cache_key(fpath, (ephem, planets, include_gps,
                                           include_bipm, bipm_version))
        except OSError:
            cache_key = None
        if cache_key is not None:
            cdir = cachedir or os.path.dirname(os.path.abspath(fpath))
            cache_path = os.path.join(
                cdir, f".{os.path.basename(fpath)}.toacache.npz")
            if os.path.exists(cache_path):
                try:
                    return TOAs.from_npz(cache_path, expect_key=cache_key,
                                         device=dev)
                except (OSError, ValueError, KeyError, EOFError,
                        zipfile.BadZipFile):
                    pass  # stale/foreign/corrupt cache: rebuild below
    t = TOAs(parse_tim(timfile), device=dev)
    t.apply_clock_corrections(include_gps=include_gps,
                              include_bipm=include_bipm,
                              bipm_version=bipm_version, limits=limits)
    t.compute_TDBs(ephem=ephem)
    t.compute_posvels(ephem=ephem, planets=planets)
    if cache_path is not None:
        try:
            t.to_npz(cache_path, cache_key=cache_key)
        except OSError:
            pass  # read-only dir: caching is best-effort
    return t


def get_TOAs_array(mjds, obs="barycenter", freqs=np.inf, errors=1.0,
                   ephem=None, planets=False, flags=None, include_gps=True,
                   include_bipm=True, bipm_version="BIPM2021",
                   limits="warn", device=None) -> TOAs:
    """Build TOAs directly from arrays (reference: get_TOAs_array). mjds
    may be f64 (splitting day/frac) or an (day, frac-dd) pair. ``device``
    (None means "cuda") is where to_batch() puts the batch."""
    dev = resolve_device(device)
    if isinstance(mjds, tuple):
        day, frac = mjds
        day = np.asarray(day, np.float64)
        frac = (np.asarray(frac[0], np.float64),
                np.asarray(frac[1], np.float64))
    else:
        m = np.atleast_1d(np.asarray(mjds, np.float64))
        day = np.floor(m)
        frac = dd_np.dd(m - day)
    day = np.atleast_1d(day)
    frac = (np.atleast_1d(frac[0]), np.atleast_1d(frac[1]))
    n = day.shape[0]
    freqs = np.broadcast_to(np.asarray(freqs, np.float64), (n,))
    errors = np.broadcast_to(np.asarray(errors, np.float64), (n,))
    obs_list = [obs] * n if isinstance(obs, str) else list(obs)
    out = object.__new__(TOAs)
    out.device = dev
    out.mjd_day = day
    out.mjd_frac = frac
    out.freq_mhz = np.array(freqs)
    out.error_us = np.array(errors)
    out.obs = [get_observatory(o).name for o in obs_list]
    out.flags = [dict(f) for f in flags] if flags is not None \
        else [{} for _ in range(n)]
    out.names = [f"fake{i}" for i in range(n)]
    out._serial = next(_TOAS_SERIAL)
    out.clock_applied = False
    out.weights = None
    out.tdb_day = None
    out.tdb_frac = None
    out.ssb_obs_pos = out.ssb_obs_vel = out.obs_sun_pos = None
    out.obs_planet_pos = None
    out.ephem = None
    out.planets = planets
    out.apply_clock_corrections(include_gps=include_gps,
                                include_bipm=include_bipm,
                                bipm_version=bipm_version, limits=limits)
    out.compute_TDBs(ephem=ephem)
    out.compute_posvels(ephem=ephem, planets=planets)
    return out
