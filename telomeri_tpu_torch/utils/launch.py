"""Child processes of the port's entry points: the ranks of a `--mesh N` world
started without a launcher, and the per-scaffold children of the validator.

A child must import the package its parent runs, wherever the parent found it
(an installed package, the working directory, a test runner's path), so the
parent hands its package's location on in PYTHONPATH; nothing is inserted into
sys.path and no directory layout is assumed."""

from __future__ import annotations

import os
import subprocess
import sys


def child_env(**extra: str) -> dict:
    """This process's environment, with the directory that holds the running
    telomeri_tpu_torch package first on PYTHONPATH."""
    import telomeri_tpu_torch

    parent = os.path.dirname(os.path.dirname(os.path.abspath(telomeri_tpu_torch.__file__)))
    path = os.pathsep.join(p for p in (parent, os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, **extra)


def launched() -> bool:
    """True where a launcher (torchrun) started this process as a rank."""
    return "WORLD_SIZE" in os.environ


def launch_ranks(n: int, module: str, argv: list[str], **extra_env: str) -> int:
    """Run `python -m module argv` as n ranks of one host under
    torch.distributed.run (its own rendezvous on a free local port); the exit
    code, which is not 0 if any rank failed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), "-m", module, *argv]
    return subprocess.run(cmd, env=child_env(**extra_env)).returncode


def check_devices_or_launch(parser, device: str, mesh: int, module: str,
                            argv: list[str]) -> int | None:
    """The preamble of an entry point that takes --device and --mesh N. A parser
    error where --device cuda finds no CUDA device, or fewer than this host's
    ranks need (one each): N with no launcher, the launcher's LOCAL_WORLD_SIZE
    under one, whose world may span hosts. Then, for N > 1 with no launcher,
    start the N ranks and return their exit code; else None: go on as a rank.

    is_available and device_count only ask how many cards there are and create
    no CUDA context, so the ranks started here find the cards untouched."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            parser.error("--device cuda: torch sees no CUDA device (use --device cpu)")
        here = int(os.environ.get("LOCAL_WORLD_SIZE", 1)) if launched() else mesh
        if here > torch.cuda.device_count():
            parser.error(f"--mesh {mesh} --device cuda needs {here} CUDA devices on this "
                         f"host, one rank each; torch sees {torch.cuda.device_count()}")
    if mesh > 1 and not launched():
        return launch_ranks(mesh, module, argv)
    return None
