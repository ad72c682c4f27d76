"""Embedded ground-station table: ITRF coordinates + aliases.

Replaces the reference's ``src/pint/data/runtime/observatories.json``
(loaded by src/pint/observatory/topo_obs.py TopoObs). Coordinates are
meter-level (1 m ~ 3.3 ns) — adequate for self-simulated fixtures; for
real-data work users can override via $PINT_TPU_OBS_OVERRIDE pointing at
a JSON file of the same shape.

Each entry: canonical name → dict(itrf=[x,y,z] meters, aliases=[...],
tempo_code=single-char or None).
"""

from __future__ import annotations

import json
import os

SITES = {
    "gbt": {
        "itrf": [882589.65, -4924872.32, 3943729.35],
        "aliases": ["gb", "green_bank"],
        "tempo_code": "1",
    },
    "arecibo": {
        "itrf": [2390490.0, -5564764.0, 1994727.0],
        "aliases": ["ao", "aoutc"],
        "tempo_code": "3",
    },
    "parkes": {
        "itrf": [-4554231.5, 2816759.1, -3454036.3],
        "aliases": ["pks", "atnf"],
        "tempo_code": "7",
    },
    "jodrell": {
        "itrf": [3822626.04, -154105.65, 5086486.04],
        "aliases": ["jb", "jbo", "jboafb", "jbodfb", "jbroach"],
        "tempo_code": "8",
    },
    "vla": {
        "itrf": [-1601192.0, -5041981.4, 3554871.4],
        "aliases": ["jvla"],
        "tempo_code": "6",
    },
    "effelsberg": {
        "itrf": [4033949.5, 486989.4, 4900430.8],
        "aliases": ["eff", "eb"],
        "tempo_code": "g",
    },
    "nancay": {
        "itrf": [4324165.8, 165927.1, 4670132.8],
        "aliases": ["ncy", "nuppi"],
        "tempo_code": "f",
    },
    "wsrt": {
        "itrf": [3828445.7, 445223.9, 5064921.6],
        "aliases": ["we"],
        "tempo_code": "i",
    },
    "chime": {
        "itrf": [-2059166.3, -3621302.97, 4814304.11],
        "aliases": ["chime_telescope"],
        "tempo_code": "y",
    },
    "meerkat": {
        "itrf": [5109360.1, 2006852.6, -3238948.1],
        "aliases": ["mk"],
        "tempo_code": "m",
    },
    "fast": {
        "itrf": [-1668557.2, 5506838.5, 2744934.6],
        "aliases": [],
        "tempo_code": "k",
    },
    "gmrt": {
        "itrf": [1656342.3, 5797947.8, 2073243.2],
        "aliases": [],
        "tempo_code": "r",
    },
    "lofar": {
        "itrf": [3826577.5, 461022.9, 5064892.7],
        "aliases": ["lf"],
        "tempo_code": "t",
    },
    "srt": {
        "itrf": [4865182.8, 791922.4, 4035137.2],
        "aliases": ["sardinia"],
        "tempo_code": "z",
    },
    "hobart": {
        "itrf": [-3950077.9, 2522377.7, -4311667.4],
        "aliases": ["hb"],
        "tempo_code": "4",
    },
    "mwa": {
        "itrf": [-2559454.1, 5095372.1, -2849057.2],
        "aliases": [],
        "tempo_code": "u",
    },
}


def load_sites() -> dict:
    """The site table, honoring $PINT_TPU_OBS_OVERRIDE (a JSON file of the
    same structure, merged over the built-ins)."""
    from pint_tpu_torch import config

    sites = {k: dict(v) for k, v in SITES.items()}
    override = config.obs_override()
    if override is not None and override.exists():
        with open(override) as f:
            for name, entry in json.load(f).items():
                sites[name.lower()] = entry
    return sites
