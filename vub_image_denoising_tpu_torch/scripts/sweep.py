"""Run a grid of one runner's configurations in turn, as the repo's ``.sh``
sweeps do: the shared code of ``run_diffusion_gap``, ``run_rca_ablation``
and ``run_rca_balance``.

Each grid is a list of ``(name, argv)``: ``argv`` is the runner's command
line for one run.  ``--dry-run`` prints the commands, ``--only NAME``
(repeatable) keeps the named runs, and every other argument is appended to
each command, so a later flag overrides the grid's (argparse keeps the last
value): ``--epochs 1 --n-train 128`` cuts every run.  As the ``.sh`` files
(``set -x`` without ``-e``) do, a failed run does not stop the grid; the exit
code is 1 if any failed.
"""

import argparse
import subprocess
import sys


def command(module, argv):
    """The command line of one run of ``python -m <module>``."""
    return ["python", "-m", module, *argv]


def run_command(module, argv):
    """One run in a child process; returns its exit code."""
    return subprocess.call([sys.executable, "-m", module, *argv])


def main(grid, module, description, argv=None):
    names = [name for name, _ in grid]
    ap = argparse.ArgumentParser(description=description, allow_abbrev=False)
    ap.add_argument("--dry-run", action="store_true", help="print the commands only")
    ap.add_argument("--only", action="append", choices=names, metavar="NAME",
                    help=f"run only this configuration (repeatable; one of {', '.join(names)})")
    args, extra = ap.parse_known_args(argv)
    failed = []
    for name, run_argv in grid:
        if args.only and name not in args.only:
            continue
        run_argv = [*run_argv, *extra]
        print("+ " + " ".join(command(module, run_argv)), flush=True)
        if not args.dry_run:
            rc = run_command(module, run_argv)
            if rc != 0:
                print(f"{name}: exit code {rc}", flush=True)
                failed.append(name)
    if failed:
        print(f"failed: {failed}", flush=True)
    return 1 if failed else 0
