"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: set-up (build the program's kernels and parsers
once per checkout, make the inputs from --seed, warm up the cell's shapes),
then the window of --seconds, then the judgement of what the window produced
against the plain reference, then one JSON line on stdout:

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown",] "checks"}

With --trace 0 `metrics` holds the cell's end-to-end metrics; with --trace 1
its per-layer metrics, read from a profiled slice after the window. `checks`
holds each number compared beside its limit; the same lines end stderr. The
run needs a CUDA device and exits non-zero without one, as it does when the
program cannot be imported or when jax, jaxlib, flax or the JAX package is
loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()   # the set-up clock starts before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "telomeri_tpu")
CACHE = os.path.join(cells.BENCH_DIR, ".cache")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def set_environment() -> None:
    """Every cache the program or its libraries may write, at fixed paths
    inside the checkout."""
    for var, sub in (("TELOMERI_CACHE", "telomeri"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def device_info(device, chips: int) -> dict:
    import subprocess

    import torch

    info = dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=chips)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def read_per_layer(cell: cells.Cell, observed: dict) -> dict:
    """The cell's per-layer metrics that their readers found something for."""
    out = {}
    for m in cell.per_layer:
        read, args = cells.reader(m["name"])
        value = read(observed, **args)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START, fault=None) -> dict:
    """Set-up, window, judgement of one run; the result's keys but `device`'s
    name. `fault` (tests and benchmark/control.py only) breaks the timed path
    underneath, as drivers/<module>.py FAULTS names."""
    import torch

    drv = cells.driver(cell)
    state = drv.setup(cell, seed, device, trace)
    if fault is not None:
        drv.FAULTS[fault](state)
    # the benchmark's own making of inputs that a user brings as files is not set-up
    setup_s = time.perf_counter() - t_start - getattr(state, "inputs_s", 0.0)
    window = drv.measure(state, seconds, trace)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    drv.release(state)
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = drv.judge(state)
    observed = window["observed"]
    e2e = dict(window["end_to_end"], setup_s=setup_s)
    if trace:
        metrics = read_per_layer(cell, observed)
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise RuntimeError(f"the {cell.mix['driver']} driver measured no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = dict(memory_peak_bytes=int(peak))
    out = dict(correct=correct, attempted=int(window["attempted"]), failed=int(failed),
               metrics=metrics, device=dev)
    if trace:
        prof = observed.get("profile") or {}
        dev.update(busy_s=prof.get("busy_s"), window_s=prof.get("window_s"),
                   trace_source=prof.get("source"))
        out["breakdown"] = {"device_ops": prof.get("device_ops", []),
                            "idle_gaps": prof.get("idle_gaps", [])}
    out["checks"] = checks
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    try:
        cell = cells.find_cell(cells.load_spec(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        log(f"benchmark: cannot read the cell {args.workload!r}: {e}")
        return 2
    try:
        import torch
    except ImportError as e:
        log(f"benchmark: torch cannot be imported: {e}")
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), torch sees {n}; "
            "the benchmark never runs on the CPU")
        return 3
    try:
        import telomeri_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"benchmark: the program (telomeri_tpu_torch) cannot be imported: {e}")
        return 4
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        log(f"benchmark: loaded in this process after the window: {', '.join(found)}")
        return 5
    result["device"] = dict(device_info(device, cell.chips), **result["device"])
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
