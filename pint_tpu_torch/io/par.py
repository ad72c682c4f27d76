"""TEMPO/TEMPO2/PINT ``.par`` file tokenizer.

Format (reference: src/pint/models/model_builder.py parse_parfile;
SURVEY.md Appendix A.7): one parameter per line,

    KEY  value  [fit-flag]  [uncertainty]

whitespace separated. Mask parameters carry extra key tokens before the
value (``JUMP -fe L-wide 0.000216 1 0.000002`` or
``JUMP MJD 55000 55100 ...``). Duplicate keys are legal and meaningful
(one line per JUMP/EFAC instance), so parsing preserves every line in
order rather than collapsing to a dict of scalars.

This module only tokenizes; semantic interpretation (units, component
routing, prefix/mask expansion) lives in ``pint_tpu_torch.models.model_builder``.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import List, Union


@dataclass
class ParfileLine:
    """One non-comment par line: the key plus its raw tokens."""

    key: str
    tokens: List[str] = field(default_factory=list)
    raw: str = ""


# Comment markers accepted by TEMPO-family tools.
_COMMENT_PREFIXES = ("#", "C ", "c ")


def resolve_source(source, kind: str = "par"):
    """Shared path-vs-literal resolution for par/tim inputs.

    Returns (lines, base_dir) — base_dir is the containing directory for
    file inputs (INCLUDE resolution), '.' otherwise.
    """
    import os

    if hasattr(source, "read"):
        return source.read().splitlines(), "."
    text = str(source)
    if os.path.exists(text):
        with open(text, "r") as f:
            return (f.read().splitlines(),
                    os.path.dirname(os.path.abspath(text)))
    # Not an existing file: literal content. A data line always contains
    # whitespace or a newline; a mistyped path contains neither, so fail
    # with the clearer file error in that case.
    if "\n" in text or " " in text or "\t" in text:
        return text.splitlines(), "."
    raise FileNotFoundError(f"no such {kind} file: {text!r}")


def _iter_lines(source) -> "list[str]":
    return resolve_source(source, kind="par")[0]


def parse_parfile(source: Union[str, io.IOBase]) -> List[ParfileLine]:
    """Tokenize a par file (path, file object, or literal content string).

    Returns the ordered list of lines; keys are upper-cased (par files are
    case-insensitive in keys, case-preserving in values).
    """
    out: List[ParfileLine] = []
    for raw in _iter_lines(source):
        line = raw.strip()
        if not line or line.startswith(_COMMENT_PREFIXES) or line == "C":
            continue
        parts = line.split()
        key = parts[0].upper()
        out.append(ParfileLine(key=key, tokens=parts[1:], raw=raw))
    return out


def parfile_dict(lines: List[ParfileLine]) -> "dict[str, list[list[str]]]":
    """key → list of token lists (one entry per occurrence, in file order)."""
    d: "dict[str, list[list[str]]]" = {}
    for ln in lines:
        d.setdefault(ln.key, []).append(ln.tokens)
    return d
