"""Solar-system Shapiro delay: Sun always, planets when PLANET_SHAPIRO
(a port of pint_tpu/models/solar_system_shapiro.py; reference:
src/pint/models/solar_system_shapiro.py): Δ = −2·T_obj·ln(r − r·n̂),
up to a constant absorbed by the phase offset.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.timing_model import DelayComponent

# GM_body/c^3 [s] (reference: _ss_mass_sec table)
T_OBJ_S = {
    "sun": 4.925490947e-6,
    "jupiter": 4.70255e-9,
    "saturn": 1.40797e-9,
    "venus": 1.2061e-11,
    "uranus": 2.1501e-10,
    "neptune": 2.5356e-10,
}
# order matches pint_tpu_torch.toa.PLANETS stacking
PLANET_ORDER = ("jupiter", "saturn", "venus", "uranus", "neptune")


def shapiro_delay(obj_pos_ls, psr_dir, t_obj_s):
    """obj_pos_ls: obs→body (.., 3) lt-s; psr_dir: unit SSB→pulsar."""
    r = torch.sqrt(torch.sum(obj_pos_ls * obj_pos_ls, dim=-1))
    rcos = torch.sum(obj_pos_ls * psr_dir, dim=-1)
    return -2.0 * t_obj_s * torch.log(r - rcos)


class SolarSystemShapiro(DelayComponent):
    """Sun (and optionally planet) Shapiro delay (reference:
    SolarSystemShapiro.solar_system_shapiro_delay)."""

    category = "solar_system_shapiro"

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        n = ctx["psr_dir"]
        total = shapiro_delay(batch.obs_sun_pos, n, T_OBJ_S["sun"])
        # planet positions present in the batch ⇔ PLANET_SHAPIRO was on
        # at ingestion
        if (self._parent is not None
                and bool(self._parent.PLANET_SHAPIRO.value)
                and batch.obs_planet_pos.shape[0] == len(PLANET_ORDER)):
            for i, name in enumerate(PLANET_ORDER):
                total = total + shapiro_delay(
                    batch.obs_planet_pos[i], n, T_OBJ_S[name])
        return total
