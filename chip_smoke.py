#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--n N] [--m M]

Phases, each fatal on failure:

1. build the z2_harmonics CUDA kernel with nvcc (into build/);
2. hold the kernel against its plain PyTorch version on the card, in
   float32 and float64, at N in {1, 1000, 8209, N} and m in {1, 2, 20,
   129}, with rtol 5e-4 and atol 5e-3*sqrt(N); two launches must be
   bitwise equal, and zero-weight rows at the ragged edge must be inert;
3. the double-double phase on the GPU must equal the port's CPU phase on
   the first 65,536 photons (integer part exactly, fraction to 1e-11);
4. run the photonphase path end to end on the GPU through the port's CLI
   (par file -> barycentred FITS events -> double-double phase -> weighted
   H-test) at N photons (default 4,194,304) and m harmonics (default 20),
   from a seeded, J0030+0451-like isolated millisecond pulsar: the phases
   must cluster at the injected peak, H must agree with H from the
   float64 plain version, and the kernel must have been launched;
5. print timings, the card's name and power limit, and one JSON line of
   kernel measurements.

The last line of standard output is {"ok": true, "device": {...}}. The
script exits non-zero, and prints no result, without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# The par file of the path: a J0030+0451-like isolated MSP with proper
# motion and parallax.
PAR = """\
PSR J0030+0451
RAJ 00:30:27.4
DECJ 04:51:39.7
PMRA -6.1
PMDEC 0.5
PX 3.02
F0 205.53069927
F1 -4.3e-16
PEPOCH 56500
POSEPOCH 56500
DM 4.33
DMEPOCH 56500
TZRMJD 56500.0
TZRSITE @
TZRFRQ inf
UNITS TDB
"""
F0, F1, PEPOCH = 205.53069927, -4.3e-16, 56500.0
NICER_MJDREF = (56658, 7.775925925925926e-4)
PEAK, WIDTH, FRAC_PULSED = 0.3, 0.01, 0.8

H100_BYTES_PER_S = 3.35e12     # HBM3
H100_F32_OPS_PER_S = 67e12     # float32 outside the tensor cores
RTOL = 5e-4
# float64 ToaBatch leaves per photon without planets: tdb_day, tdb_frac
# (2), freq, error, three (N, 3) vectors, pulse_number
BATCH_BYTES_PER_PHOTON = 8 * 14


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def event_columns(n: int, seed: int) -> dict:
    """Barycentric photon times (seconds since the NICER MJDREF) whose
    phases follow a Gaussian peak at PEAK plus a uniform background, and
    photon weights (pulsed photons heavier): the recipe of the reference
    package's event tests."""
    rng = np.random.default_rng(seed)
    mjd0, mjd1 = 56400.0, 56600.0
    base = rng.uniform(mjd0, mjd1, n)
    pulsed = rng.uniform(size=n) < FRAC_PULSED
    phi_t = np.where(pulsed,
                     np.mod(PEAK + WIDTH * rng.standard_normal(n), 1.0),
                     rng.uniform(size=n))
    dt = (base - PEPOCH) * 86400.0
    k = np.floor(dt * F0)
    tsec = (k + phi_t) / F0 - 0.5 * F1 / F0 * ((k + phi_t) / F0) ** 2
    mjd = PEPOCH + tsec / 86400.0
    times = ((mjd - NICER_MJDREF[0]) - NICER_MJDREF[1]) * 86400.0
    w = np.where(pulsed, rng.uniform(0.5, 1.0, n), rng.uniform(0.0, 0.5, n))
    order = np.argsort(times)
    return {"TIME": times[order], "WEIGHT": w[order]}


def write_events(path: str, cols: dict) -> None:
    from pint_tpu_torch.io.fits import write_events_fits

    write_events_fits(path, cols, header_extra={
        "TIMESYS": "TDB", "TIMEREF": "SOLARSYSTEM",
        "MJDREFI": NICER_MJDREF[0], "MJDREFF": NICER_MJDREF[1],
        "TELESCOP": "NICER", "TIMEZERO": 0.0, "TIMEUNIT": "s"})


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of one fn() call over `reps` calls
    enqueued back to back, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def check_close(name, got, want, n) -> None:
    import torch

    atol = 5e-3 * math.sqrt(max(n, 1))
    if not torch.allclose(got.double(), want.double(), rtol=RTOL, atol=atol):
        err = (got.double() - want.double()).abs().max().item()
        fail(f"{name}: kernel disagrees with the plain version "
             f"(max abs err {err:.3e}, atol {atol:.3e}, rtol {RTOL})")


def phase_kernel(zmod, dev, n_main: int, m_main: int, seed: int) -> dict:
    """Kernel against the plain version; returns the main-shape error."""
    import torch

    rng = np.random.default_rng(seed + 1)
    main_err = None
    for n in (1, 1000, 8192 + 17, n_main):
        ph = torch.as_tensor(rng.uniform(size=n), dtype=torch.float32,
                             device=dev)
        w = torch.as_tensor(rng.uniform(0.1, 1.0, n), dtype=torch.float32,
                            device=dev)
        for m in (1, 2, m_main, 129):
            k1 = zmod.z2_harmonics(ph, w, m)
            k2 = zmod.z2_harmonics(ph, w, m)
            torch.cuda.synchronize()
            if not torch.equal(k1, k2):
                fail(f"two launches differ at N={n} m={m}")
            if k1.shape != (2, m) or k1.dtype != torch.float64:
                fail(f"kernel output {tuple(k1.shape)} {k1.dtype}")
            p32 = zmod.z2_harmonics_plain(ph, w, m)
            p64 = zmod.z2_harmonics_plain(ph.double(), w.double(), m)
            check_close(f"N={n} m={m} vs f32 plain", k1, p32, n)
            check_close(f"N={n} m={m} vs f64 plain", k1, p64, n)
            if n == n_main and m == m_main:
                main_err = (k1 - p64).abs().max().item()
            del p32, p64
        print(f"kernel == plain at N={n}, m in (1, 2, {m_main}, 129)")
    # zero-weight rows at the ragged edge (beyond 8192 and past the last
    # full block) must leave the sums of the first 8192 rows unchanged
    n = 8192 + 17
    ph = torch.zeros(n, dtype=torch.float32, device=dev)
    ph[:8192] = torch.as_tensor(rng.uniform(size=8192), device=dev)
    w = torch.zeros(n, dtype=torch.float32, device=dev)
    w[:8192] = torch.as_tensor(rng.uniform(0.5, 1.0, 8192), device=dev)
    full = zmod.z2_harmonics(ph, w, 3)
    head = zmod.z2_harmonics(ph[:8192].clone(), w[:8192].clone(), 3)
    check_close("zero-weight ragged rows", full, head, 8192)
    check_close("zero-weight ragged rows vs plain", full,
                zmod.z2_harmonics_plain(ph[:8192].double(),
                                        w[:8192].double(), 3), 8192)
    print("zero-weight ragged rows are inert")
    return {"max_abs_err": main_err}


def phase_path(zmod, dev, cols: dict, par: str, m: int, tmp: str) -> dict:
    """The photonphase CLI end to end on the GPU."""
    import torch

    from pint_tpu_torch.scripts import photonphase

    n = len(cols["TIME"])
    ev = os.path.join(tmp, "events.fits")
    npz = os.path.join(tmp, "phases.npz")
    write_events(ev, cols)
    zmod.launches = 0
    buf = io.StringIO()
    cuda_act = torch.profiler.ProfilerActivity.CUDA
    prof_cm = (torch.profiler.profile(activities=[cuda_act])
               if cuda_act in torch.profiler.supported_activities()
               else contextlib.nullcontext())
    with prof_cm as prof, contextlib.redirect_stdout(buf):
        rc = photonphase.main([ev, par, "--weightcol", "WEIGHT",
                               "--npz", npz])
    launches = zmod.launches
    out = buf.getvalue()
    print(out, end="")
    if rc != 0:
        fail(f"photonphase returned {rc}")
    if launches < 1:
        fail("the photonphase run launched the z2_harmonics kernel "
             f"{launches} times")
    stages = json.loads(re.search(r"Stage seconds: (\{.*\})", out).group(1))
    if stages["device"] != "cuda":
        fail(f"photonphase ran on {stages['device']}")
    h_cli = float(re.search(r"Htest.*?: (\S+)", out).group(1))

    d = np.load(npz)
    phases, weights = d["phases"], d["weights"]
    if phases.shape != (n,) or not np.all(np.isfinite(phases)):
        fail(f"phases {phases.shape}, finite={np.isfinite(phases).all()}")
    dist = np.abs(np.mod(phases - PEAK + 0.5, 1.0) - 0.5)
    med = float(np.median(dist))
    if not med < 0.02:
        fail(f"median distance from the injected peak {med:.4f} >= 0.02")
    ph = torch.as_tensor(phases, dtype=torch.float64, device=dev)
    w = torch.as_tensor(weights, dtype=torch.float64, device=dev)
    cs = zmod.z2_harmonics_plain(ph, w, m)
    terms = 2.0 * (cs[0] ** 2 + cs[1] ** 2) / torch.sum(w ** 2)
    ks = torch.arange(1, m + 1, dtype=torch.float64, device=dev)
    h_plain = float(torch.max(torch.cumsum(terms, 0) - 4.0 * ks + 4.0))
    if not abs(h_cli - h_plain) <= 1e-3 * max(1.0, h_plain):
        fail(f"H from the kernel path {h_cli} vs f64 plain {h_plain}")
    print(f"path: median peak distance {med:.5f} turns, H {h_cli:.2f} "
          f"(f64 plain {h_plain:.2f}), kernel launches {launches}")
    return {"launches": launches, "stages": stages, "h": h_cli,
            "kernels_ms": device_kernel_ms(prof)}


def device_kernel_ms(prof) -> dict:
    """{kernel name: device ms} from a CUDA-activity profile (empty
    without one)."""
    out = {}
    for e in (prof.key_averages() if prof is not None else ()):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def phase_exact(dev, cols: dict, par: str, tmp: str,
                nsub: int = 65536) -> float:
    """GPU double-double phase == CPU phase on the first photons.
    Returns the seconds of this first (cold) GPU phase evaluation."""
    import torch

    from pint_tpu_torch.event_toas import load_fits_TOAs
    from pint_tpu_torch.models import get_model

    sub = os.path.join(tmp, "events_head.fits")
    write_events(sub, {k: v[:nsub] for k, v in cols.items()})
    model = get_model(par, device=dev)
    toas = load_fits_TOAs(sub, weightcolumn="WEIGHT", device=dev)
    model.get_cache(toas)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = model.phase(toas)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cpu = model.phase(toas, device="cpu")
    gi, gf = gpu.int.cpu().numpy(), gpu.frac.cpu().numpy()
    ci, cf = cpu.int.numpy(), cpu.frac.numpy()
    if not np.array_equal(gi, ci):
        fail(f"pulse numbers differ at {int(np.sum(gi != ci))} photons")
    dfrac = float(np.max(np.abs(gf - cf)))
    if not dfrac <= 1e-11:
        fail(f"GPU vs CPU frac phase differ by {dfrac:.3e} turns")
    print(f"dd chain: GPU == CPU on {toas.ntoas} photons "
          f"(int exact, max |dfrac| {dfrac:.3e} turns)")
    return cold_s


def h2d_ms(nbytes: int) -> float:
    """Median ms of one host→device copy of `nbytes` from pageable
    memory, as TOAs.to_batch makes it."""
    import torch

    host = torch.from_numpy(np.ones(nbytes // 8))
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.to("cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=4_194_304,
                    help="photons on the path (default 4,194,304)")
    ap.add_argument("--m", type=int, default=20, help="harmonics")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    from pint_tpu_torch.ops import z2_harmonics as zmod

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    zmod.build()
    print(f"build: z2_harmonics.cu compiled in "
          f"{time.perf_counter() - t0:.2f} s")

    kern = phase_kernel(zmod, dev, args.n, args.m, args.seed)
    cols = event_columns(args.n, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        par = os.path.join(tmp, "j0030.par")
        with open(par, "w") as f:
            f.write(PAR)
        cold_s = phase_exact(dev, cols, par, tmp)
        path = phase_path(zmod, dev, cols, par, args.m, tmp)

    # timings at the main path's shape
    rng = np.random.default_rng(args.seed + 2)
    ph = torch.as_tensor(rng.uniform(size=args.n), dtype=torch.float32,
                         device=dev)
    w = torch.as_tensor(rng.uniform(size=args.n), dtype=torch.float32,
                        device=dev)
    k_ms = cuda_ms(lambda: zmod.z2_harmonics(ph, w, args.m))
    p_ms = cuda_ms(lambda: zmod.z2_harmonics_plain(ph, w, args.m))
    n, m = args.n, args.m
    bytes_moved = 8 * n + 16 * m       # read phases+weights, write (2, m)
    ops = m * n + 2 * 4 * m * n        # sincospif + 4 FMAs of 2 flops each
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    st = path["stages"]
    copy_ms = h2d_ms(args.n * BATCH_BYTES_PER_PHOTON)
    print(f"kernel z2_harmonics: {k_ms:.4f} ms median of 20 "
          f"(N={n}, m={m})")
    print(f"plain float32 version: {p_ms:.4f} ms median of 20")
    print(f"bound: {bound_ms * 1e3:.2f} us, set by {bound_by} "
          f"({t_bytes * 1e3:.2f} us for {bytes_moved} B at 3.35 TB/s, "
          f"{t_ops * 1e3:.2f} us for {ops} ops at 67 TF/s)")
    print(f"stages: host ingest {st['ingest']:.3f} s, host->device "
          f"(batch packing + copy) {st['batch'] * 1e3:.2f} ms, device "
          f"phase {st['phase'] * 1e3:.2f} ms, H-test "
          f"{st['htest'] * 1e3:.2f} ms, total {st['total']:.3f} s")
    print(f"host->device copy alone: {copy_ms:.2f} ms for "
          f"{args.n * BATCH_BYTES_PER_PHOTON} B; first (cold) GPU phase "
          f"on 65,536 photons {cold_s * 1e3:.2f} ms")
    km = path["kernels_ms"]
    window_ms = (st["batch"] + st["phase"] + st["htest"]) * 1e3
    if km:
        busy = sum(km.values())
        print(f"device busy during the path (torch.profiler): {busy:.2f} ms "
              f"of the {window_ms:.2f} ms device stages (idle share "
              f"{1 - busy / window_ms:.4f}) and of {st['total']:.3f} s in "
              f"all (idle share {1 - busy / (st['total'] * 1e3):.6f})")
        for name, ms in sorted(km.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:9.3f} ms  {name[:100]}")
    else:
        print("device busy during the path: not measured (the profiler "
              "recorded no device time)")
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(card())
    print(json.dumps({"kernels": [{
        "name": "z2_harmonics", "route": "cuda",
        "source": "pint_tpu_torch/csrc/z2_harmonics.cu",
        "replaces": "pint_tpu/ops/pallas_kernels.py:81",
        "launches": path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
