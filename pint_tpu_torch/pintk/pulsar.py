"""Headless model/TOA facade backing the interactive fitter GUI (a port
of pint_tpu/pintk/pulsar.py; reference: src/pint/pintk/pulsar.py
Pulsar). Every piece of GUI behavior — fit, selection, per-TOA delete,
jumping, pulse-number tracking, undo, random-model draws — lives here so
it is fully scriptable and testable without a display; the Tk widgets in
``pint_tpu_torch.pintk.plk`` are a thin view over this class.

The model's phase, the residuals and the fits run on ``device`` (None
means "cuda"); the TOA table, the selection and the undo snapshots are
host state. ``plot_data`` hands the GUI host numpy arrays.
"""

from __future__ import annotations

import io
import warnings
from typing import List, Optional

import numpy as np

from pint_tpu_torch.models.timing_model import copy_model

__all__ = ["Pulsar"]

# flag used to mark GUI-created jumps on TOAs (reference pintk uses
# -gui_jump flags + JUMP maskParameters the same way)
GUI_JUMP_FLAG = "gui_jump"


class Pulsar:
    """One loaded pulsar: model + TOAs + fit state.

    Parameters
    ----------
    parfile, timfile:
        paths (or file-like) understood by get_model / get_TOAs.
    fitter:
        'auto', 'wls', 'gls', 'downhill', 'downhill_gls'.
    device:
        torch device of the model and the TOAs' batch (None: "cuda";
        without a GPU that raises, as every entry point of the port
        does).
    """

    def __init__(self, parfile, timfile, fitter: str = "auto",
                 ephem: Optional[str] = None, device=None):
        from pint_tpu_torch import resolve_device
        from pint_tpu_torch.models import get_model
        from pint_tpu_torch.toa import get_TOAs

        self.device = resolve_device(device)
        self.parfile = parfile
        self.timfile = timfile
        self.fitter_name = fitter
        self.model = get_model(parfile, device=self.device)
        self.all_toas = get_TOAs(
            timfile, model=self.model,
            ephem=ephem or self.model.EPHEM.value,
            planets=bool(self.model.PLANET_SHAPIRO.value),
            device=self.device)
        self.prefit_model = copy_model(self.model)
        self.selected = np.zeros(self.all_toas.ntoas, dtype=bool)
        self.fitted = False
        self.fit_results = None
        self.track_mode = None  # None -> nearest; or "use_pulse_numbers"
        self._undo_stack: List[dict] = []
        self._fitter_obj = None

    # ------------------------------------------------------ residuals

    @property
    def name(self) -> str:
        return self.model.name or (self.model.PSR.value or "?")

    def _residuals(self, model):
        from pint_tpu_torch.residuals import Residuals

        return Residuals(self.all_toas, model,
                         track_mode=self.track_mode or "nearest")

    @property
    def prefit_resids(self):
        return self._residuals(self.prefit_model)

    @property
    def postfit_resids(self):
        if not self.fitted:
            raise ValueError("no fit performed yet")
        return self._residuals(self.model)

    # ------------------------------------------------------ selection

    def select(self, mask):
        """Replace the selection with a boolean mask or index list."""
        mask = np.asarray(mask)
        if mask.dtype != bool:
            m = np.zeros(self.all_toas.ntoas, dtype=bool)
            m[mask] = True
            mask = m
        if mask.shape != (self.all_toas.ntoas,):
            raise ValueError("selection mask has wrong length")
        self.selected = mask

    def select_mjd_range(self, mjd1: float, mjd2: float):
        mjds = np.asarray(self.all_toas.get_mjds())
        self.select((mjds >= mjd1) & (mjds <= mjd2))

    def clear_selection(self):
        self.selected = np.zeros(self.all_toas.ntoas, dtype=bool)

    # ------------------------------------------------------- snapshot

    def _push_undo(self):
        self._undo_stack.append({
            "model": copy_model(self.model),
            "prefit_model": copy_model(self.prefit_model),
            "toas": self.all_toas.select(
                np.ones(self.all_toas.ntoas, dtype=bool)),
            "selected": self.selected.copy(),
            "fitted": self.fitted,
        })

    def undo(self) -> bool:
        """Revert the last mutating operation; False if nothing to
        undo."""
        if not self._undo_stack:
            return False
        st = self._undo_stack.pop()
        self.model = st["model"]
        self.prefit_model = st["prefit_model"]
        self.all_toas = st["toas"]
        self.selected = st["selected"]
        self.fitted = st["fitted"]
        self._fitter_obj = None
        return True

    # ------------------------------------------------------ mutations

    def delete_TOAs(self, mask=None):
        """Drop the masked (default: selected) TOAs."""
        mask = self.selected if mask is None else np.asarray(mask)
        if not mask.any():
            return 0
        self._push_undo()
        self.all_toas = self.all_toas.select(~mask)
        self.selected = np.zeros(self.all_toas.ntoas, dtype=bool)
        self._fitter_obj = None
        return int(mask.sum())

    def _jump_component(self):
        import pint_tpu_torch.models.jump  # register PhaseJump # noqa: F401

        return self.model.get_or_create_component("PhaseJump")

    def jump_selection(self, mask=None) -> Optional[str]:
        """JUMP the masked (default selected) TOAs: tag them with a
        -gui_jump flag and add a matching free JUMP maskParameter
        (reference: pintk Pulsar.add_jump)."""
        mask = self.selected if mask is None else np.asarray(mask)
        if not mask.any():
            return None
        self._push_undo()
        comp = self._jump_component()
        existing = [int(self.all_toas.flags[i].get(GUI_JUMP_FLAG, 0))
                    for i in range(self.all_toas.ntoas)]
        jump_id = max(existing, default=0) + 1
        for i in np.flatnonzero(mask):
            self.all_toas.flags[i][GUI_JUMP_FLAG] = str(jump_id)
        self.all_toas._touch()
        p = comp.add_jump(key=f"-{GUI_JUMP_FLAG}",
                          key_value=(str(jump_id),), value=0.0,
                          frozen=False)
        comp.setup()
        self.model.invalidate_cache()
        self._fitter_obj = None
        return p.name

    def unjump_selection(self, mask=None) -> int:
        """Remove GUI jumps covering the masked TOAs."""
        mask = self.selected if mask is None else np.asarray(mask)
        ids = {self.all_toas.flags[i].get(GUI_JUMP_FLAG)
               for i in np.flatnonzero(mask)}
        ids.discard(None)
        if not ids:
            return 0
        self._push_undo()
        comp = self.model.components.get("PhaseJump")
        removed = 0
        for i in range(self.all_toas.ntoas):
            if self.all_toas.flags[i].get(GUI_JUMP_FLAG) in ids:
                del self.all_toas.flags[i][GUI_JUMP_FLAG]
        self.all_toas._touch()
        if comp is not None:
            for nm in list(comp.params):
                p = comp.params[nm]
                if nm.startswith("JUMP") and \
                        getattr(p, "key", None) == f"-{GUI_JUMP_FLAG}" \
                        and p.key_value and p.key_value[0] in ids:
                    comp.remove_param(nm)
                    removed += 1
            comp.setup()
        self.model.invalidate_cache()
        self._fitter_obj = None
        return removed

    # -------------------------------------------------- pulse numbers

    def compute_pulse_numbers(self):
        """Freeze the current model's phase assignment into -pn flags
        and track them in subsequent fits (the phase on the model's
        device)."""
        self.all_toas.compute_pulse_numbers(self.model)
        self.track_mode = "use_pulse_numbers"

    def reset_pulse_numbers(self):
        for f in self.all_toas.flags:
            f.pop("pn", None)
        self.all_toas._touch()
        self.track_mode = None

    # ------------------------------------------------- fit-param box

    def fittable_params(self) -> list:
        """Parameter names the fit checkbox column offers (reference:
        pintk's fitbox): every value-carrying numeric parameter kind
        that the fitters can take a derivative against."""
        from pint_tpu_torch.models.parameter import (AngleParameter,
                                                     MJDParameter,
                                                     floatParameter)

        out = []
        for nm in self.model.params:
            p = self.model.get_param(nm)
            if getattr(p, "value", None) is None:
                continue
            if isinstance(p, (floatParameter, MJDParameter,
                              AngleParameter)):
                out.append(nm)
        return out

    def set_fit_params(self, names) -> None:
        """Freeze/unfreeze so that exactly ``names`` are free
        (reference: the pintk fitbox apply path). Names that are not
        fittable raise (a silently-ignored name would freeze
        everything and fail far from the cause); the structure change
        drops the model's device cache and the cached fitter."""
        names = set(names)
        fittable = self.fittable_params()
        unknown = names - set(fittable)
        if unknown:
            raise KeyError(
                f"not fittable parameter(s): {sorted(unknown)}")
        for nm in fittable:
            p = self.model.get_param(nm)
            p.frozen = nm not in names
        self.model.invalidate_cache()
        self._fitter_obj = None  # stale structure (like delete/jump)

    # ----------------------------------------------------- TOA info

    def toa_info(self, index: int) -> dict:
        """Everything the plk click-info popup shows for one TOA
        (reference: plk's per-point info): MJD, freq, error, obs,
        flags, pre/post-fit residual, and its serial index. Reuses
        the Residuals most recently computed by plot_data (every GUI
        redraw refreshes it), so a click-info popup doesn't pay an
        O(N) model evaluation for one scalar."""
        t = self.all_toas
        i = int(index)
        res = getattr(self, "_last_resids", None)
        if res is None or len(res.time_resids) != t.ntoas:
            res = (self.postfit_resids if self.fitted
                   else self.prefit_resids)
        return {
            "index": i,
            "mjd": float(np.asarray(t.get_mjds())[i]),
            "freq_mhz": float(np.asarray(t.get_freqs())[i]),
            "error_us": float(np.asarray(t.get_errors())[i]),
            "obs": t.get_obss()[i],
            "name": t.names[i] if getattr(t, "names", None) else "",
            "flags": dict(t.flags[i]),
            "resid_us": float(res.time_resids[i] * 1e6),
            "selected": bool(self.selected[i]),
        }

    # ------------------------------------------------------------ fit

    def _make_fitter(self):
        from pint_tpu_torch.fitter import (DownhillWLSFitter, Fitter,
                                           WLSFitter)
        from pint_tpu_torch.gls import DownhillGLSFitter, GLSFitter

        kinds = {"wls": WLSFitter, "gls": GLSFitter,
                 "downhill": DownhillWLSFitter,
                 "downhill_gls": DownhillGLSFitter}
        if self.fitter_name == "auto":
            return Fitter.auto(self.all_toas, self.model)
        return kinds[self.fitter_name](self.all_toas, self.model)

    def fit(self, maxiter: int = 5):
        """Fit the current model to the current TOAs (reference: pintk
        Pulsar.fit). Keeps the pre-fit model for plotting."""
        self._push_undo()
        self.prefit_model = copy_model(self.model)
        f = self._make_fitter()
        self.fit_results = f.fit_toas(maxiter=maxiter)
        self.model = f.model
        self._fitter_obj = f
        self.fitted = True
        return self.fit_results

    @property
    def fitter(self):
        if self._fitter_obj is None:
            raise ValueError("no fit performed yet")
        return self._fitter_obj

    def random_models(self, n: int = 10,
                      rng: Optional[np.random.Generator] = None):
        """Residual curves [s] for n draws from the post-fit covariance
        (the pintk random-models overlay): an (n, ntoa) float64 tensor on
        the fitter's device, as calculate_random_models returns them."""
        from pint_tpu_torch.simulation import calculate_random_models

        return calculate_random_models(self.fitter, self.all_toas,
                                       Nmodels=n, rng=rng)

    # ---------------------------------------------------- plot export

    def plot_data(self, postfit: bool = True) -> dict:
        """Everything the plk plot needs, as plain host arrays: mjds,
        residuals (us), errors (us), freqs, obs, orbital phase (if
        binary), selection mask."""
        res = (self.postfit_resids if postfit and self.fitted
               else self.prefit_resids)
        self._last_resids = res  # reused by toa_info (O(1) popup)
        mjds = np.asarray(self.all_toas.get_mjds())
        data = {
            "mjds": mjds,
            "resids_us": (res.time_resids * 1e6).cpu().numpy(),
            "errors_us": np.asarray(self.all_toas.get_errors()),
            "freqs": np.asarray(self.all_toas.get_freqs()),
            "obs": list(self.all_toas.get_obss()),
            "selected": self.selected.copy(),
            "rms_us": res.rms_weighted() * 1e6,
            "chi2": float(res.chi2),
        }

        def _opt(nm):
            try:
                return self.model.get_param(nm).value
            except KeyError:
                return None

        pb = _opt("PB")
        t0 = _opt("TASC")
        if t0 is None:
            t0 = _opt("T0")
        if pb and t0:
            data["orbital_phase"] = np.mod((mjds - t0) / pb, 1.0)
        # solar elongation [deg] (reference plk axis): angle between
        # the observatory->Sun and observatory->pulsar directions
        sun = getattr(self.all_toas, "obs_sun_pos", None)
        if sun is not None:
            sun = np.asarray(sun)
            try:  # _host_psr_dir owns the astrometry dispatch
                n = self.model._host_psr_dir(self.all_toas)
            except (KeyError, ValueError):
                n = None  # no astrometry component: no elongation
            if n is not None:
                cosd = np.sum(sun * n, axis=-1) / \
                    np.linalg.norm(sun, axis=-1)
                data["elongation"] = np.degrees(
                    np.arccos(np.clip(cosd, -1.0, 1.0)))
        return data

    # -------------------------------------------------------- file IO

    def write_par(self, path):
        with open(path, "w") as fh:
            fh.write(self.model.as_parfile())

    def write_tim(self, path):
        self.all_toas.write_TOA_file(path)

    def update_model_from_text(self, text: str):
        """Replace the model from edited par text (the ParWidget apply
        path), on this pulsar's device. The live TOAs are
        re-barycentered in place when EPHEM changes, and planet positions
        are (re)computed when either EPHEM or PLANET_SHAPIRO changes."""
        from pint_tpu_torch.models import get_model

        self._push_undo()
        old_ephem = self.model.EPHEM.value
        old_planets = bool(self.model.PLANET_SHAPIRO.value)
        self.model = get_model(io.StringIO(text), device=self.device)
        self.prefit_model = copy_model(self.model)
        new_planets = bool(self.model.PLANET_SHAPIRO.value)
        ephem_changed = self.model.EPHEM.value != old_ephem
        if ephem_changed or new_planets != old_planets:
            # recompute on the TOAs we HAVE (not the on-disk tim:
            # that would resurrect deleted TOAs and drop jump flags);
            # the TDB chain only depends on the ephemeris, so a pure
            # PLANET_SHAPIRO toggle skips straight to posvels
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if ephem_changed:
                    self.all_toas.compute_TDBs(
                        ephem=self.model.EPHEM.value)
                self.all_toas.compute_posvels(
                    ephem=self.model.EPHEM.value,
                    planets=new_planets)
        self.fitted = False
        self._fitter_obj = None
