"""The readings that a cell's limits are set from, on the chip at the cell's size.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --seconds 1 \
        [--faults control,state_unchanged,half_left_out,answer_altered]

For each seed, one set-up, then a short window of the program as it is
("none") and one of each named fault (drivers/<module>.py FAULTS: `control`
is the comparison's control, the others the timed path broken underneath),
each judged as a run judges it. One JSON line a window on stdout:
{"seed", "fault", "correct", "failed", "checks", "end_to_end"}. The benchmark's own runs
never run this. A cell kept out of BENCHMARK.json is read from held/<cell>.json.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import cells
from .run import log, set_environment


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", default="control,state_unchanged,half_left_out,answer_altered")
    args = ap.parse_args(argv)
    set_environment()
    if not torch.cuda.is_available():
        log("benchmark.control: torch sees no CUDA device")
        return 3
    device = torch.device("cuda", 0)
    cell = cells.find_cell(cells.with_held(cells.load_spec(), args.workload), args.workload)
    drv = cells.driver(cell)
    faults = ["none"] + [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        state = drv.setup(cell, seed, device, False)
        program = state.entry
        for fault in faults:
            state.entry = program
            if fault != "none":
                drv.FAULTS[fault](state)
            window = drv.measure(state, args.seconds, False)
            checks, failed = drv.judge(state)
            correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
            print(json.dumps(dict(seed=seed, fault=fault, correct=correct, failed=failed,
                                  checks=checks, end_to_end=window["end_to_end"])), flush=True)
        del state, program
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
