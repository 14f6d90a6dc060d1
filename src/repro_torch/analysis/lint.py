"""Lint example/program files with the static verifier (CLI), carried over
from ``repro.analysis.lint`` with the same hook contract and exit codes.

Usage::

    python -m repro_torch.analysis.lint examples/*_torch.py [...] [--strict]

Point it at the port's own files: a directory is walked whole, and the
reference's examples under ``examples/`` import jax.

Any ``.py`` file under the given paths that defines a ``lint_plans()``
function is imported and asked for its plans; each plan (or ``(plan,
routed_fabric)`` pair) runs through :func:`repro_torch.analysis.verify_plan`.
Files without the hook are skipped *without being imported* — demo scripts
with heavyweight deps (serving, training) stay untouched.

Exit status: ``--strict`` fails (1) on any deadlock verdict or
error-severity finding; without it every report prints but only crashes
fail.  Warnings print either way and never gate.

The hook contract::

    def lint_plans():
        yield map_2d(heat_2d(18, 24), workers=3)          # a bare plan
        yield plan, routed_fabric                          # or with fabric
"""
from __future__ import annotations

import argparse
import importlib.util
import pathlib
import sys

from repro_torch.analysis.static_verify import verify_plan

HOOK = "def lint_plans"


def iter_hook_files(paths: list[str]):
    """Yield ``.py`` files (under files/dirs in ``paths``) whose *text*
    contains the ``lint_plans`` hook — the no-import prefilter."""
    for raw in paths:
        p = pathlib.Path(raw)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            try:
                text = f.read_text()
            except OSError:
                continue
            if HOOK in text:
                yield f


def _load(path: pathlib.Path):
    name = f"_repro_lint_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod               # dataclasses et al. need the entry
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


def lint_paths(paths: list[str], out=sys.stdout) -> tuple[int, int]:
    """Lint every hooked file; returns ``(n_plans, n_failed)``."""
    n_plans = n_failed = 0
    for f in iter_hook_files(paths):
        try:
            mod = _load(f)
            plans = list(mod.lint_plans())
        except Exception as e:            # a broken example is a finding too
            print(f"{f}: FAIL — lint_plans() raised "
                  f"{type(e).__name__}: {e}", file=out)
            n_failed += 1
            continue
        for i, item in enumerate(plans):
            plan, fabric = item if isinstance(item, tuple) else (item, None)
            n_plans += 1
            rep = verify_plan(plan, fabric=fabric)
            bad = not rep.ok()
            n_failed += bad
            status = "FAIL" if bad else "ok"
            tag = f"{f.name}[{i}]"
            routed = " (routed)" if fabric is not None else ""
            print(f"{tag}: {status}{routed} — {rep.describe()}", file=out)
    return n_plans, n_failed


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", metavar="PATH",
                    help="files or directories to scan for lint_plans()")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any deadlock verdict or error finding")
    args = ap.parse_args(argv)
    n_plans, n_failed = lint_paths(args.paths)
    print(f"lint: {n_plans} plan(s) checked, {n_failed} failed")
    if n_plans == 0:
        print("lint: no lint_plans() hooks found", file=sys.stderr)
        return 1
    return 1 if (args.strict and n_failed) else 0


if __name__ == "__main__":
    sys.exit(main())
