"""Runtime cache-build/dispatch sanitizer (a port of
pint_tpu/analysis/sanitizer.py).

The invariant (the reference's "invalidate_cache(params_only=True) must
NOT drop the jit"): parameter VALUES are runtime arguments, so a value
sweep must not rebuild what the model derives from its TOAs. In eager
torch nothing is traced; what a model builds per TOAs is its device
cache (the batch on the card, the components' host precomputes moved
there, the TZR mini-batch), made by ``TimingModel.get_cache``. A
regression that rebuilt it per fitter iteration would re-upload every
column each step and no test would fail. ``Sanitizer`` makes the build
count observable:

- it wraps ``TimingModel.get_cache`` class-wide for the duration of the
  context and counts every time a FRESH cache is built (object identity
  change of the model's single slot), per model, as kind "phase" — the
  counterpart of the reference's ``_get_compiled``/``_get_compiled_jac``
  count (the port's design Jacobian reads the same cache, so there is no
  separate "jac" build to count). ``invalidate_cache(params_only=True)``
  keeps the cache, so a value sweep counts one build; unlike the
  reference, a structure change (freezing a parameter) under
  ``params_only`` rebuilds nothing either: eager torch has no trace for
  the free set to key;
- ``watch``/``executable_growth`` counted XLA executables in the
  reference; eager torch has none, and both raise NotImplementedError
  saying so;
- ``wrap(fn, label, expect_device=..., nan_check=...)`` returns a
  call-through proxy that records numpy (host) operands entering a CUDA
  dispatch (each one is an implicit host-to-device copy on every call)
  and optionally checks the outputs for non-finite values (a sync: debug
  only). The operand scan walks NESTED structures — dicts/tuples/lists,
  NamedTuples (``DD``) and plain objects (request/entry dataclasses
  reaching the serve bucket dispatch).

The reference's ``dtype_probe`` (the runtime half of graftflow's G9)
comes with the opt-in float32 routes, whose demotion sites it checks.

Usage::

    with Sanitizer() as san:
        ... sweep parameter values, re-evaluate ...
    assert san.compiles("phase") == 1   # one build, N reuses
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Sanitizer", "SanitizerError"]

EXECUTABLE_REFUSAL = (
    "Sanitizer.watch/executable_growth counted a jitted function's XLA "
    "executables; eager torch compiles nothing and has no executable "
    "cache to count. Count device-cache builds with compiles() instead")


class SanitizerError(AssertionError):
    """A sanitizer invariant (finite outputs, expected operand
    placement) failed."""


@dataclass
class Sanitizer:
    """Context manager counting per-TOAs device-cache builds and flagging
    stray host operands / NaN outputs. Re-entrant use is not supported
    (the class-level patch is process-global while active)."""

    nan_check: bool = False
    # (model id, kind) -> build count
    builds: Dict[Tuple[int, str], int] = field(default_factory=dict)
    host_crossings: List[Tuple[str, int]] = field(default_factory=list)
    _saved: Optional[tuple] = None

    # ---------------------------------------------------- build count

    def __enter__(self) -> "Sanitizer":
        from pint_tpu_torch.models.timing_model import TimingModel

        if self._saved is not None:
            raise RuntimeError("Sanitizer is not re-entrant")
        orig = TimingModel.get_cache
        san = self

        def patched(model, *a, **kw):
            before = model._cache
            cache = orig(model, *a, **kw)
            if cache is not before:
                san._record(model, "phase")
            return cache

        TimingModel.get_cache = patched
        self._saved = (TimingModel, orig)
        return self

    def __exit__(self, *exc):
        TimingModel, orig = self._saved
        TimingModel.get_cache = orig
        self._saved = None
        return False

    def _record(self, model, kind: str):
        key = (id(model), kind)
        self.builds[key] = self.builds.get(key, 0) + 1

    def compiles(self, kind: Optional[str] = None) -> int:
        """Total fresh device-cache builds observed (optionally one
        kind; the port records only "phase")."""
        return sum(n for (_, k), n in self.builds.items()
                   if kind is None or k == kind)

    def reset(self):
        """Zero the counters (e.g. after a deliberate warm-up phase
        inside the context)."""
        self.builds.clear()
        self.host_crossings.clear()

    # ----------------------------------------------- executable count

    def watch(self, jitted, label: str = "") -> None:
        raise NotImplementedError(EXECUTABLE_REFUSAL)

    def executable_growth(self) -> Dict[str, Optional[int]]:
        raise NotImplementedError(EXECUTABLE_REFUSAL)

    # ------------------------------------------------ dispatch checks

    def wrap(self, fn, label: str = "", expect_device: bool = True,
             nan_check: Optional[bool] = None):
        """Call-through proxy recording numpy operands (an implicit
        host-to-device copy per CUDA dispatch when expect_device) and,
        with nan_check (this Sanitizer's setting when None), checking
        that every floating output is finite. The operand scan recurses
        through nested containers AND plain objects (see
        _count_host_arrays)."""
        san = self
        name = label or getattr(fn, "__name__", repr(fn))

        def guarded(*args, **kw):
            if expect_device:
                nhost = _count_host_arrays((args, kw))
                if nhost:
                    san.host_crossings.append((name, nhost))
            out = fn(*args, **kw)
            check = san.nan_check if nan_check is None else nan_check
            if check:
                bad = [i for i, leaf in enumerate(_leaves(out))
                       if not _finite(leaf)]
                if bad:
                    raise SanitizerError(
                        f"{name}: non-finite output leaves {bad}")
            return out

        return guarded

    def assert_no_host_crossings(self):
        if self.host_crossings:
            raise SanitizerError(
                f"host ndarray operands entered device dispatches: "
                f"{self.host_crossings} — convert once with "
                f"torch.as_tensor(..., device=) at build time, not per "
                f"call")


def _leaves(obj) -> list:
    """Output leaves in order: tensors, arrays and numbers inside nested
    tuples (NamedTuples too), lists and dicts."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _leaves(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _leaves(v)]
    return [obj]


def _finite(leaf) -> bool:
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return True
        return bool(torch.isfinite(leaf).all())
    if isinstance(leaf, (float, np.floating, np.ndarray)):
        a = np.asarray(leaf)
        return not np.issubdtype(a.dtype, np.floating) or \
            bool(np.all(np.isfinite(a)))
    return True


def _count_host_arrays(obj) -> int:
    """np.ndarray count (subclasses included) across nested containers
    AND plain container objects: an opaque request/entry object hides
    its member arrays from a plain container walk, and the serve bucket
    dispatch carries exactly such operands. torch tensors never
    count."""
    import numpy as np
    import torch

    count = 0
    seen = set()
    stack = [(obj, 0)]
    while stack:
        cur, depth = stack.pop()
        if depth > 8 or id(cur) in seen:
            continue
        if isinstance(cur, (str, bytes, int, float, bool,
                            complex)) or cur is None:
            continue
        seen.add(id(cur))
        if isinstance(cur, torch.Tensor):
            continue
        if isinstance(cur, np.ndarray):
            count += 1
            continue
        if isinstance(cur, dict):
            stack.extend((v, depth + 1) for v in cur.values())
            continue
        if isinstance(cur, (list, tuple, set, frozenset)):
            stack.extend((v, depth + 1) for v in cur)
            continue
        d = getattr(cur, "__dict__", None)
        if isinstance(d, dict) and not isinstance(cur, type) and \
                not callable(cur):
            stack.extend((v, depth + 1) for v in d.values())
    return count
