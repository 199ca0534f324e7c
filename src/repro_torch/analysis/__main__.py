"""CLI gate: ``python -m repro_torch.analysis [lint|hygiene|audit|all]``.

With no subcommand, runs the fast static gates (contract lint + repo
hygiene) and exits non-zero on any unsuppressed violation.  ``audit``
runs every resident program under the dispatch recorder and writes the
JSON report (``--device``, default ``cuda``: it imports PyTorch and needs
a card unless ``--device cpu`` is given; the other gates do not).
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = "check"
    if argv and not argv[0].startswith("-"):
        cmd = argv.pop(0)

    if cmd == "lint":
        from . import lint

        return lint.main(argv)
    if cmd == "hygiene":
        from . import hygiene

        return hygiene.main()
    if cmd == "audit":
        from . import audit

        return audit.main(argv)
    if cmd in ("check", "all"):
        from . import hygiene, lint

        rc = lint.main(argv if cmd == "check" else [])
        rc |= hygiene.main()
        if cmd == "all":
            from . import audit

            rc |= audit.main(argv)
        return rc
    print(f"unknown command {cmd!r}; expected lint | hygiene | audit | all",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
