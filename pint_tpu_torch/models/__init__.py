"""Timing-model layer (a port of pint_tpu/models; reference:
src/pint/models/__init__.py). Importing this package registers the
ported components and exposes the builder entry point."""

from pint_tpu_torch.models.timing_model import (  # noqa: F401
    Component,
    DelayComponent,
    PhaseComponent,
    TimingModel,
    component_types,
)
from pint_tpu_torch.models import absolute_phase  # noqa: F401
from pint_tpu_torch.models import astrometry  # noqa: F401
from pint_tpu_torch.models import dispersion  # noqa: F401
from pint_tpu_torch.models import jump  # noqa: F401
from pint_tpu_torch.models import noise  # noqa: F401
from pint_tpu_torch.models import phase_offset  # noqa: F401
from pint_tpu_torch.models import solar_system_shapiro  # noqa: F401
from pint_tpu_torch.models import spindown  # noqa: F401
# binaries register after the core components, as in the reference
from pint_tpu_torch.models import binary  # noqa: F401
from pint_tpu_torch.models import components_extra  # noqa: F401
from pint_tpu_torch.models import components_tail  # noqa: F401
from pint_tpu_torch.models.model_builder import (  # noqa: F401
    ModelBuilder,
    get_model,
    get_model_and_toas,
)

__all__ = [
    "Component",
    "DelayComponent",
    "PhaseComponent",
    "TimingModel",
    "component_types",
    "ModelBuilder",
    "get_model",
    "get_model_and_toas",
]
