"""graftlint CLI for the port: ``python -m trlx_tpu_torch.analysis [paths...]``.

Exit codes: 0 = clean (suppressed findings allowed), 1 = unsuppressed
findings, 2 = usage error (an unknown rule id, or a refused one).
``--json`` emits the machine-readable findings document (also containing
suppressed findings, flagged as such, so review tooling can audit the
waivers).
"""

import argparse
import sys

from trlx_tpu_torch.analysis.core import REFUSED, RULE_FAMILIES, RULE_TITLES, lint_paths, render_json, render_text


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.analysis",
        description="graftlint/graftrace for the port: repo-specific AST invariant and concurrency checks "
                    "(GL001-GL011)",
    )
    parser.add_argument("paths", nargs="*", default=["trlx_tpu_torch"],
                        help="files or directories to lint (default: trlx_tpu_torch)")
    parser.add_argument("--json", action="store_true", help="JSON findings output")
    parser.add_argument("--select", default="", help="comma-separated rule ids to run (default: all)")
    parser.add_argument("--list-rules", action="store_true", help="print the rule table and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        grouped = set()
        for family, members in RULE_FAMILIES.items():
            print(f"{family}:")
            for rule in members:
                if rule in RULE_TITLES:
                    print(f"  {rule}  {RULE_TITLES[rule]}")
                    grouped.add(rule)
        orphans = sorted(set(RULE_TITLES) - grouped)
        if orphans:
            print("unfamilied:")
            for rule in orphans:
                print(f"  {rule}  {RULE_TITLES[rule]}")
        print("refused (no check in the port):")
        for rule, why in sorted(REFUSED.items()):
            print(f"  {rule}  {why}")
        print(
            "\nsuppress with '# graftlint: disable=GLxxx -- <reason>' — the "
            "reason is REQUIRED; a reasonless disable is itself a finding "
            "(GL000) and waives nothing."
        )
        return 0

    select = [r.strip() for r in args.select.split(",") if r.strip()] or None
    if select:
        unknown = [r for r in select if r not in RULE_TITLES]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
        refused = [r for r in select if r in REFUSED]
        if refused:
            print("; ".join(f"{r} is refused: {REFUSED[r]}" for r in refused), file=sys.stderr)
            return 2

    findings, n_files = lint_paths(args.paths, select=select)
    if args.json:
        print(render_json(findings, n_files))
    else:
        print(render_text(findings, n_files))
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
