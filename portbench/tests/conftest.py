"""Shared pieces of the benchmark's tests. Tests that need a CUDA card
carry the ``card`` marker and take the ``card_device`` fixture, which
skips them where there is none (decided when the test runs, never at
import). Run them on the card with ``python -m pytest portbench/tests -m
card``."""

import copy

import pytest

from portbench import registry


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_gwb(npulsars=4, nfreq=3):
    """ng15-gwb67 at a size the CPU holds: fewer pulsars, TOAs and bins,
    every shape rule kept (16 TOAs an epoch, 9 base columns + DMX)."""
    cfg = registry.config("ng15-gwb67")
    a = copy.deepcopy(cfg["assumed"])
    a["toas"] = [640, 800, 480, 576, 704, 512, 672, 608][:npulsars]
    a["cadence_days"] = [30, 30, 60, 45, 30, 45, 30, 60][:npulsars]
    a["design_columns"] = [19, 21, 16, 18, 20, 17, 19, 18][:npulsars]
    return {"npulsars": npulsars, "gwb_nfreq": nfreq, "red_noise_modes": 5,
            "check_points": 6, "assumed": a}


def small_msp(ntoas=400, ndmx=4):
    """ng-msp-10k at a size the CPU holds: fewer TOAs and DMX windows,
    the same epochs' pattern, par file and noise model."""
    return {"ntoas": ntoas, "ndmx": ndmx, "check_nodes": 4}


# per configuration: its configuration and traffic keys at a CPU size
SMALL = {"ng15-gwb67": (small_gwb(), {}),
         "ng-msp-10k": (small_msp(), {"grid": [4, 4]})}


def small_of(cell_name):
    """(configuration override, traffic override) of a cell at a size
    the CPU holds."""
    spec = registry.load_spec()
    return SMALL[registry.cell(spec, cell_name)["config"]]


@pytest.fixture
def small():
    return small_gwb()
