"""``python -m repro_torch.serve`` — boot the suite server (port of
``python -m repro.serve``).

Flags (env defaults in parens): ``--socket PATH``
(``$REPRO_SERVE_SOCKET``, default ``/tmp/repro-serve.sock``),
``--stdio`` (JSON lines on stdin/stdout instead of a socket),
``--max-wait-ms`` (``$REPRO_SERVE_MAX_WAIT_MS``, 20), ``--max-lanes``
(``$REPRO_SERVE_MAX_LANES``, 64), ``--no-compile-cache`` to skip the
kernels' prebuild into the build directory.

The port's own: ``--device`` (default ``cuda``; refused without a card,
never a fallback to the CPU), ``--build-dir`` (where the kernels' libraries
live across restarts, default the repo's ``build/``), and
``--buzen-backend`` / ``--sim-backend``, the process-wide routes (the JAX
package reads ``REPRO_BUZEN_BACKEND``; the port reads no environment
variable for backends).  On ``cuda`` both default to ``kernel``, so the
card runs the hand-written kernels; on ``cpu`` to ``torch`` and
``batched``.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description="always-on scenario-suite "
                                             "server (JSON lines)")
    # server process config: env read once at startup, flags win; the
    # README documents each variable
    env = os.environ.get
    ap.add_argument("--socket", default=env("REPRO_SERVE_SOCKET",
                                            "/tmp/repro-serve.sock"))
    ap.add_argument("--stdio", action="store_true",
                    help="serve stdin/stdout instead of a socket")
    ap.add_argument("--max-wait-ms", type=float,
                    default=float(env("REPRO_SERVE_MAX_WAIT_MS", "20")))
    ap.add_argument("--max-lanes", type=int,
                    default=int(env("REPRO_SERVE_MAX_LANES", "64")))
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="skip the kernels' prebuild into the build "
                         "directory")
    ap.add_argument("--device", default="cuda",
                    help="where requests run (default: cuda)")
    ap.add_argument("--build-dir", default=None,
                    help="the kernels' build directory (default: the "
                         "repo's build/)")
    ap.add_argument("--buzen-backend", choices=("torch", "kernel"),
                    default=None, help="Buzen DP route (default: kernel "
                                       "on cuda, torch on cpu)")
    ap.add_argument("--sim-backend", choices=("reference", "batched",
                                              "kernel", "sharded"),
                    default=None, help="event-engine route (default: "
                                       "kernel on cuda, batched on cpu)")
    args = ap.parse_args(argv)

    import torch

    from ..core import buzen
    from .. import sim
    from .server import ServeConfig, Server

    on_card = torch.device(args.device).type == "cuda"
    buzen.set_backend(args.buzen_backend
                      or ("kernel" if on_card else "torch"))
    sim.set_backend(args.sim_backend or ("kernel" if on_card else "batched"))
    config = ServeConfig(socket_path="" if args.stdio else args.socket,
                         max_wait=args.max_wait_ms / 1000.0,
                         max_lanes=args.max_lanes, device=args.device)
    try:
        server = Server(config)
    except RuntimeError as e:
        print(f"serve: {e}", file=sys.stderr, flush=True)
        sys.exit(2)

    if not args.no_compile_cache:
        from .build_cache import enable_build_cache, prebuild

        path = enable_build_cache(args.build_dir)
        built = prebuild(args.device)
        print(f"serve: kernels' build directory {path} ({built} built)",
              file=sys.stderr, flush=True)

    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    if not args.stdio:
        print(f"serve: listening on {args.socket} ({args.device}; buzen "
              f"{buzen.get_backend()}, sim {sim.get_backend()})",
              file=sys.stderr, flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
