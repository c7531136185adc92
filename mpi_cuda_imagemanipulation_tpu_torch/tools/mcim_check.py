"""mcim-check for the port — run the static analysis gate over the
port's own files (the package, chip_smoke.py, tests/test_torch_*.py and
tests/_torch_*.py; analysis/core.py).

    python -m mpi_cuda_imagemanipulation_tpu_torch.tools.mcim_check
    python -m mpi_cuda_imagemanipulation_tpu_torch.tools.mcim_check --format json --out a.json
    python -m mpi_cuda_imagemanipulation_tpu_torch.tools.mcim_check --rules concurrency,obs
    python -m mpi_cuda_imagemanipulation_tpu_torch.tools.mcim_check --list-rules

Exit status: 0 when the tree is clean (no unsuppressed error-severity
findings), 1 otherwise. False positives are waived inline with
`# mcim-torch: allow(<rule>: reason)`; stale waivers are themselves
findings. The counterpart of the JAX package's root tools/mcim_check.py,
with the same flags; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

# the checkout that holds this package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mcim-check", description=__doc__)
    ap.add_argument(
        "--root", default=_ROOT, help="repo root to analyze (default: "
        "the checkout containing this script)"
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument(
        "--out", default=None,
        help="also write the report to this path (JSON when it ends in "
        ".json)",
    )
    ap.add_argument(
        "--rules", default=None,
        help="comma-separated rule families to run "
        "(concurrency,tracer,obs,surface; default: all)",
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    args = ap.parse_args(argv)

    from mpi_cuda_imagemanipulation_tpu_torch.analysis import core

    if args.list_rules:
        # importing the rule modules populates the catalog
        from mpi_cuda_imagemanipulation_tpu_torch.analysis import (  # noqa: F401
            rules_concurrency,
            rules_obs,
            rules_surface,
            rules_tracer,
        )

        for r in sorted(core.RULES.values(), key=lambda r: (r.family, r.id)):
            print(f"{r.family:12s} {r.id:28s} [{r.severity}] {r.doc}")
        return 0

    families = (
        {f.strip() for f in args.rules.split(",") if f.strip()}
        if args.rules
        else None
    )
    findings, repo = core.run(args.root, families=families)
    report = (
        core.render_json(findings, repo)
        if args.format == "json"
        else core.render_text(findings)
    )
    sys.stdout.write(report)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(
                core.render_json(findings, repo)
                if args.out.endswith(".json")
                else report
            )
    return 1 if any(f.severity == "error" for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
