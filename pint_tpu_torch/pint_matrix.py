"""Labeled matrix abstractions over the fitter linear algebra (a port of
pint_tpu/pint_matrix.py).

Reference: src/pint/pint_matrix.py (PintMatrix, DesignMatrix,
CovarianceMatrix, DesignMatrixMaker, combine_design_matrices_by_
quantity/param). The device code consumes plain tensors; these host
numpy wrappers carry the (parameter, unit) labels for display, wideband
stacking, and correlation-matrix reporting.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["PintMatrix", "DesignMatrix", "CovarianceMatrix",
           "combine_design_matrices_by_quantity",
           "combine_design_matrices_by_param"]


class PintMatrix:
    """A 2-D array with labeled columns (reference: PintMatrix; the
    row axis is the TOA/measurement index)."""

    def __init__(self, matrix, labels: Sequence[str],
                 units: Optional[Sequence[str]] = None,
                 quantity: str = "toa"):
        self.matrix = np.asarray(matrix)
        self.labels = list(labels)
        self.units = list(units) if units is not None else \
            [""] * len(self.labels)
        self.quantity = quantity
        if self.matrix.ndim != 2 or \
                self.matrix.shape[1] != len(self.labels):
            raise ValueError("matrix/labels shape mismatch: "
                             f"{self.matrix.shape} vs "
                             f"{len(self.labels)} labels")
        if len(self.units) != len(self.labels):
            raise ValueError("units/labels length mismatch: "
                             f"{len(self.units)} vs {len(self.labels)}")

    @property
    def shape(self):
        return self.matrix.shape

    def get_label_index(self, label: str) -> int:
        return self.labels.index(label)

    def get_column(self, label: str) -> np.ndarray:
        return self.matrix[:, self.get_label_index(label)]

    def __repr__(self):
        return (f"<{type(self).__name__} {self.matrix.shape} "
                f"labels={self.labels}>")


class DesignMatrix(PintMatrix):
    """d(residual)/d(param) with units s/param-unit (reference:
    DesignMatrix + DesignMatrixMaker)."""

    @classmethod
    def from_model(cls, model, toas, incoffset: bool = True,
                   quantity: str = "toa", device=None) -> "DesignMatrix":
        """The model's design matrix, computed on ``device`` (the
        model's when None) and held on the host."""
        M, names, units = model.designmatrix(toas, incoffset=incoffset,
                                             device=device)
        return cls(M.cpu().numpy(), names, units, quantity=quantity)

    def derivative_params(self) -> List[str]:
        return [p for p in self.labels if p != "Offset"]


class CovarianceMatrix(PintMatrix):
    """Symmetric parameter covariance with labels on both axes
    (reference: CovarianceMatrix)."""

    @classmethod
    def from_fitter(cls, fitter) -> "CovarianceMatrix":
        cov = fitter.parameter_covariance_matrix
        if cov is None:
            raise ValueError("fit first: no covariance available")
        names = ["Offset"] + list(fitter.model.free_params)
        return cls(np.asarray(cov), names)

    def to_correlation(self) -> "CovarianceMatrix":
        d = np.sqrt(np.diag(self.matrix))
        d[d == 0] = 1.0
        return CovarianceMatrix(self.matrix / np.outer(d, d),
                                self.labels, self.units)

    def prettyprint(self, prec: int = 3) -> str:
        """Lower-triangular correlation table (reference:
        CovarianceMatrix.prettyprint)."""
        corr = self.to_correlation().matrix
        w = max(8, prec + 5)
        lines = [" " * 10 + "".join(f"{nm[:w]:>{w + 1}}"
                                    for nm in self.labels)]
        for i, nm in enumerate(self.labels):
            row = "".join(f"{corr[i, j]:>{w + 1}.{prec}f}"
                          for j in range(i + 1))
            lines.append(f"{nm[:10]:<10}{row}")
        return "\n".join(lines)


def combine_design_matrices_by_quantity(matrices) -> DesignMatrix:
    """Stack row-blocks of different measured quantities (e.g. [TOA;
    DM] for wideband) sharing the same parameter columns (reference:
    combine_design_matrices_by_quantity)."""
    first = matrices[0]
    for m in matrices[1:]:
        if m.labels != first.labels:
            raise ValueError("parameter columns differ: "
                             f"{m.labels} vs {first.labels}")
        if m.units != first.units:
            raise ValueError("parameter column units differ: "
                             f"{m.units} vs {first.units}")
    return DesignMatrix(
        np.concatenate([m.matrix for m in matrices], axis=0),
        first.labels, first.units,
        quantity="+".join(m.quantity for m in matrices))


def combine_design_matrices_by_param(matrices) -> DesignMatrix:
    """Concatenate parameter columns for the same measurement rows
    (reference: combine_design_matrices_by_param)."""
    first = matrices[0]
    for m in matrices[1:]:
        if m.matrix.shape[0] != first.matrix.shape[0]:
            raise ValueError("row counts differ")
    labels: List[str] = []
    units: List[str] = []
    for m in matrices:
        for nm, u in zip(m.labels, m.units):
            if nm in labels:
                raise ValueError(f"duplicate column {nm!r}")
            labels.append(nm)
            units.append(u)
    return DesignMatrix(
        np.concatenate([m.matrix for m in matrices], axis=1),
        labels, units, quantity=first.quantity)
