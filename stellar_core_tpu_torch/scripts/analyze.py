#!/usr/bin/env python3
"""Run the static analysis passes (docs/ANALYSIS.md) over the package.

    python -m stellar_core_tpu_torch.scripts.analyze             # all passes
    python -m stellar_core_tpu_torch.scripts.analyze --pass domains
    python -m stellar_core_tpu_torch.scripts.analyze --json out.json
    python -m stellar_core_tpu_torch.scripts.analyze --show-suppressed

Exit code 0 when no live findings (allowlisted suppressions with
justifications do not count; allowlist rot — unused or unjustified
entries — does). tests/test_torch_analysis.py runs it, so the
committed tree must always exit 0 here.
"""

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)

from stellar_core_tpu_torch import analysis  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="determinism / thread-domain / registry analyzer")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=("determinism", "domains", "registry"),
                    help="run only this pass (repeatable); default all")
    ap.add_argument("--root", default=None,
                    help="package root to analyze (default: the repo's "
                         "stellar_core_tpu_torch/)")
    ap.add_argument("--allowlist", default=analysis.DEFAULT_ALLOWLIST,
                    help="allowlist file ('' disables)")
    ap.add_argument("--json", dest="json_out", metavar="FILE",
                    help="write the findings artifact here ('-' for "
                         "stdout)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="print allowlisted findings too")
    args = ap.parse_args(argv)

    passes = tuple(args.passes) if args.passes else (
        "determinism", "domains", "registry")
    res = analysis.run_all(pkg_root=args.root,
                           allowlist_path=args.allowlist or None,
                           passes=passes)

    if args.json_out:
        doc = res.to_json()
        doc["passes"] = list(passes)
        # trend headline: allowlist size (undirected — shrinkage is
        # cleanup, growth is reviewed debt; live findings must be 0)
        doc["metric"] = "analysis.allowlist_size"
        doc["value"] = doc["allowlist_size"]
        doc["unit"] = "entries"
        if args.json_out == "-":
            # keep stdout pure JSON; human output moves to stderr below
            json.dump(doc, sys.stdout, indent=1)
            print()
            sys.stdout = sys.stderr
        else:
            with open(args.json_out, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")

    for f in res.findings:
        print(f.render())
    if args.show_suppressed:
        for f in res.suppressed:
            print("[suppressed] " + f.render())
    counts = res.counts()
    by_pass = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(f"analyzed {len(res.index.modules)} modules / "
          f"{len(res.index.funcs)} functions: "
          f"{len(res.findings)} finding(s) ({by_pass or 'none'}), "
          f"{len(res.suppressed)} suppressed by "
          f"{len(res.allowlist.entries)} allowlist entries")
    return 1 if res.findings else 0


if __name__ == "__main__":
    sys.exit(main())
