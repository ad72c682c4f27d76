"""nvcc builds of the port's hand-written CUDA sources (``csrc/*.cu``, each
with a plain C interface, loaded with ctypes): a source is compiled for
sm_90a into ``build/`` beside the package on first use, keyed on a hash of
the source and the flags, with ptxas's register and spill report beside
the library. Importing builds nothing."""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from pint_tpu_torch import config

__all__ = ["BUILD_DIR", "FLAGS", "nvcc", "paths", "library", "parse_ptxas",
           "ptxas_report"]

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = config.cuda_home() or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built (put the CUDA toolkit's bin/ on PATH)")


def paths(src: Path, stem: str) -> tuple:
    """(library, ptxas report) of ``src`` built with FLAGS."""
    key = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    so = BUILD_DIR / f"{stem}-{key.hexdigest()[:16]}.so"
    return so, so.with_suffix(".ptxas.txt")


def library(src: Path, stem: str) -> Path:
    """Compile ``src`` into build/ unless a library built from this exact
    source and these flags is already there. Returns its path."""
    so, log = paths(src, stem)
    if so.exists() and log.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    log_tmp.write_text(proc.stdout + proc.stderr)
    os.replace(log_tmp, log)
    os.replace(tmp, so)  # atomic against a concurrent build
    return so


def parse_ptxas(text: str) -> dict:
    """{mangled kernel name: {"regs", "spill_stores", "spill_loads"}} from
    ptxas -v output."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        mk = re.search(r"(?:Compiling entry function|Function properties "
                       r"for) '?(_Z\w+)", line)
        if mk:
            cur = mk.group(1)
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        ms = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if ms:
            out[cur]["spill_stores"] = int(ms.group(1))
            out[cur]["spill_loads"] = int(ms.group(2))
        mr = re.search(r"Used (\d+) registers", line)
        if mr:
            out[cur]["regs"] = int(mr.group(1))
    return out


def ptxas_report(src: Path, stem: str) -> dict:
    """ptxas's registers and spills for every kernel of ``src``'s build
    (``parse_ptxas``); builds first if needed."""
    library(src, stem)
    return parse_ptxas(paths(src, stem)[1].read_text())
