"""ffcheck CLI for the PyTorch port.

    python -m dlrm_flexflow_tpu_torch.analysis                 # all passes
    python -m dlrm_flexflow_tpu_torch.analysis --pass lock-discipline
    python -m dlrm_flexflow_tpu_torch.analysis --format json -o artifacts/analysis_1.json
    python -m dlrm_flexflow_tpu_torch.analysis --changed-only          # vs HEAD
    python -m dlrm_flexflow_tpu_torch.analysis --sarif out.sarif
    python -m dlrm_flexflow_tpu_torch.analysis --update-baseline
    python -m dlrm_flexflow_tpu_torch.analysis --list-passes
    python -m dlrm_flexflow_tpu_torch.analysis --explain <waiver-key>

Exit 0 when every finding is clean or waived AND no waiver is stale;
1 otherwise; 2 on usage errors.  ``-o`` writes the JSON result as an
``artifacts/analysis_*.json`` sink the telemetry report CLI's
``== analysis ==`` section picks up; ``--sarif`` writes the same run
as SARIF 2.1.0 so CI can annotate findings by ``path:line``.
``--changed-only [REF]`` still analyzes the whole tree (the
interprocedural passes need the whole program) but reports only
findings in files ``git diff --name-only REF`` lists (default HEAD —
staged + unstaged); the stale-waiver check stays global.
``--update-baseline`` regenerates ``analysis/waivers.txt`` preserving
every justification, dropping stale entries, and REFUSING when active
findings would need a new (unjustified) waiver line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .engine import (BaselineError, WAIVER_FILE, Waivers, WaiverError,
                     all_passes, default_waivers, explain_key,
                     repo_root, run_analysis, update_baseline,
                     write_json, write_sarif)


def changed_paths(repo: str, ref: str):
    """Repo-relative paths ``git diff --name-only <ref>`` reports
    (plus untracked files — a brand-new module must not dodge the
    changed-only gate), or None when git is unusable here."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", ref, "--"],
            cwd=repo, capture_output=True, text=True, timeout=30)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=repo, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if diff.returncode != 0:
        return None
    paths = [p.strip() for p in diff.stdout.splitlines() if p.strip()]
    if untracked.returncode == 0:
        paths.extend(p.strip() for p in untracked.stdout.splitlines()
                     if p.strip())
    return sorted({p for p in paths if p.endswith(".py")})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dlrm_flexflow_tpu_torch.analysis",
        description=__doc__.split("\n")[0])
    p.add_argument("roots", nargs="*", default=None,
                   help="files/dirs to analyze, relative to --root "
                        "(default: the port package and chip_smoke.py)")
    p.add_argument("--pass", dest="passes", action="append", default=None,
                   metavar="NAME",
                   help="run only this pass (repeatable; see --list)")
    p.add_argument("--list", "--list-passes", action="store_true",
                   help="list available passes (name + description) "
                        "and exit")
    p.add_argument("--explain", default=None, metavar="WAIVER-KEY",
                   help="report one waiver key's status (ACTIVE/"
                        "WAIVED/STALE/UNKNOWN), the findings it "
                        "matches, and the caller chain into the "
                        "detail function with each call edge's "
                        "resolution mechanism — the why behind "
                        "waiver-key churn")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="findings as text lines (default) or one JSON "
                        "object")
    p.add_argument("--root", default=None,
                   help="repo root (default: the checkout containing "
                        "this package)")
    p.add_argument("--waivers", default=None,
                   help="waiver file (default: the package's "
                        "analysis/waivers.txt, if present)")
    p.add_argument("-o", "--output", default=None,
                   help="also write the JSON result here (e.g. "
                        "artifacts/analysis_1.json for the telemetry "
                        "report's == analysis == section)")
    p.add_argument("--sarif", default=None, metavar="PATH",
                   help="also write the run as SARIF 2.1.0 (CI "
                        "annotation by path:line)")
    p.add_argument("--changed-only", nargs="?", const="HEAD",
                   default=None, metavar="REF",
                   help="report only findings in files changed vs REF "
                        "(default HEAD: staged+unstaged+untracked); "
                        "the analysis itself stays whole-tree")
    p.add_argument("--update-baseline", action="store_true",
                   help="regenerate the waiver file from this run: "
                        "keep justifications, drop stale entries, "
                        "refuse over unwaived findings")
    args = p.parse_args(argv)

    if args.list:
        for name, cls in sorted(all_passes().items()):
            print(f"{name:18s} {cls.description}")
        return 0

    repo = args.root or repo_root()
    try:
        waivers = (Waivers.load(args.waivers) if args.waivers
                   else default_waivers(repo))
    except (WaiverError, OSError) as e:
        print(f"ffcheck: bad waiver file: {e}", file=sys.stderr)
        return 2

    if args.explain is not None:
        try:
            print(explain_key(args.explain, waivers=waivers,
                              repo=repo, roots=args.roots or None))
        except ValueError as e:
            print(f"ffcheck: {e}", file=sys.stderr)
            return 2
        return 0

    if args.update_baseline and (args.passes or args.roots):
        # a subset run sees a subset of findings: every other pass's
        # waivers would look stale and be DROPPED, destroying the
        # curated baseline — refuse, like --changed-only below
        print("ffcheck: --update-baseline needs the full all-pass "
              "whole-tree view; drop --pass/roots", file=sys.stderr)
        return 2

    only = None
    if args.changed_only is not None:
        if args.update_baseline:
            print("ffcheck: --update-baseline needs the whole-tree "
                  "view; drop --changed-only", file=sys.stderr)
            return 2
        only = changed_paths(repo, args.changed_only)
        if only is None:
            print(f"ffcheck: --changed-only: git diff vs "
                  f"{args.changed_only!r} failed in {repo}",
                  file=sys.stderr)
            return 2

    try:
        result = run_analysis(repo=repo, roots=args.roots or None,
                              pass_names=args.passes, waivers=waivers,
                              only_paths=only)
    except ValueError as e:
        print(f"ffcheck: {e}", file=sys.stderr)
        return 2
    except SyntaxError as e:
        print(f"ffcheck: unparseable source: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        path = args.waivers or os.path.join(repo, WAIVER_FILE)
        try:
            kept = update_baseline(result, waivers, path)
        except BaselineError as e:
            print(f"ffcheck: {e}", file=sys.stderr)
            return 1
        dropped = len(result.unused_waivers)
        print(f"ffcheck: baseline rewritten — {len(kept)} entr"
              f"{'y' if len(kept) == 1 else 'ies'} kept, "
              f"{dropped} stale dropped ({path})")
        return 0

    if args.output:
        write_json(result, args.output)
    if args.sarif:
        write_sarif(result, args.sarif)
    if args.format == "json":
        print(json.dumps(result.to_dict(), indent=1))
    else:
        print(result.format_text())
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
