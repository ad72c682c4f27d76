"""Readings that the limits of ``correct`` are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 3 [--control 3]

For each seed, in one process: the cell's set-up and a short window at
the cell's own load, then the gap that the run's comparison reads between
the program and the reference (the lower reading, from sound runs) and,
for the first ``--control`` seeds, the same gap with the reference put in
the program's place in the precision below the configuration's (the
upper reading). One JSON line a seed, then a summary. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3)
    a = p.parse_args(argv)
    run.pin_environment()
    import torch

    from portbench import registry

    cell = registry.cell(registry.load_spec(), a.workload)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    lower, upper = {}, []
    for i, seed in enumerate(int(x) for x in a.seeds.split(",")):
        r = run.execute(cell, seed, a.seconds, False, dev)
        line = {"seed": seed, "calls": len(r.calls),
                "failed": sum(not c["ok"] for c in r.calls),
                "program": r.system_mod.check(r.system, r.calls, r.ref,
                                              r.cfg, r.seed, dev)}
        for k, v in line["program"].items():
            lower.setdefault(k, []).append(v)
        if i < a.control:
            line["control"], line["control_no_value"] = \
                r.system_mod.control(r.system, r.calls, r.ref, r.cfg,
                                     r.seed, dev)
            upper.append(line["control"])
        print(json.dumps(line), flush=True)
        del r
    print(json.dumps({"workload": a.workload,
                      "lower": {k: max(v) for k, v in lower.items()},
                      "upper": min(upper) if upper else None,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
