"""Host-side file ingestion: .par and .tim microformats.

Pure Python, no device code — parsing happens once, on the host, and
produces plain data that the model/TOA layers turn into device arrays
(reference: src/pint/models/model_builder.py parse_parfile,
src/pint/toa.py .tim parsing).
"""

from pint_tpu_torch.io.par import parse_parfile, ParfileLine
from pint_tpu_torch.io.tim import parse_tim, write_tim, TimTOA

__all__ = [
    "parse_parfile",
    "ParfileLine",
    "parse_tim",
    "write_tim",
    "TimTOA",
]
