"""Talk to the port's suite server: concurrent mixed load over one socket
(port of ``examples/serve_client.py``).

Boot the server in one terminal (on the card by default)::

    PYTHONPATH=src python -m repro_torch.serve --socket /tmp/repro-serve.sock

then run this client in another::

    PYTHONPATH=src python examples/serve_client_torch.py \
        --socket /tmp/repro-serve.sock --wait 60 --check --shutdown

It pipelines an analyze, two mixed-population simulates and a train
request from two concurrent connections, prints the streamed events and
the server's ``stats``, and (``--check``) asserts every payload is
bitwise-equal to a direct in-process ``ScenarioSuite.run`` of the port on
the same device and routes as the server's (``--device``,
``--buzen-backend``, ``--sim-backend``: the server CLI's flags and
defaults — ``kernel`` on ``cuda``, ``torch`` / ``batched`` on ``cpu``).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402


def make_scenarios():
    from repro_torch.core.complexity import LearningConstants
    from repro_torch.scenario import (DataSpec, LearningSpec, NetworkSpec,
                                      Scenario, StrategySpec)

    consts = LearningConstants(L=1.0, delta=1.0, sigma=1.0, M=2.0, G=5.0,
                               eps=1.0)

    def scn(n, seed):
        rng = np.random.default_rng(seed)
        return Scenario(
            network=NetworkSpec(mu_c=list(rng.uniform(1.0, 2.0, n)),
                                mu_d=[2.0] * n, mu_u=[2.0] * n),
            learning=LearningSpec(consts=consts),
            strategy=StrategySpec("explicit",
                                  p=list(np.full(n, 1.0 / n)), m=2),
            data=DataSpec(dataset="synthetic", num_classes=2,
                          samples_per_class=6))

    return scn(3, seed=1), scn(5, seed=2), scn(4, seed=3), scn(2, seed=4)


MODEL = {"kind": "mlp", "input_dim": 28 * 28, "num_classes": 2,
         "hidden": [4]}
SIM = dict(num_updates=80)
TRAIN = dict(horizon_time=4.0, batch_size=4, eval_every_time=2.0,
             model=MODEL)


def direct_payload(scn, mode, seeds, device, **options):
    from repro_torch.fl.models import mlp_classifier
    from repro_torch.scenario import ScenarioSuite
    from repro_torch.serve.protocol import encode_entry

    if mode == "train":
        options = dict(options)
        spec = options.pop("model")
        options["model"] = mlp_classifier(spec["input_dim"],
                                          spec["num_classes"],
                                          hidden=tuple(spec["hidden"]),
                                          device=device)
    res = ScenarioSuite(scn, seeds=seeds, device=device).run(mode=mode,
                                                             **options)
    (entry,) = res.entries.values()
    return encode_entry(mode, entry)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--socket",
                    default=os.environ.get("REPRO_SERVE_SOCKET",
                                           "/tmp/repro-serve.sock"))
    ap.add_argument("--wait", type=float, default=0.0, metavar="SECONDS",
                    help="poll for the socket to appear (server booting)")
    ap.add_argument("--check", action="store_true",
                    help="assert payloads == direct ScenarioSuite runs")
    ap.add_argument("--shutdown", action="store_true",
                    help="drain the server when done")
    ap.add_argument("--device", default="cuda",
                    help="the server's device, for --check (default cuda)")
    ap.add_argument("--buzen-backend", choices=("torch", "kernel"),
                    default=None)
    ap.add_argument("--sim-backend", choices=("reference", "batched",
                                              "kernel"), default=None)
    args = ap.parse_args(argv)

    deadline = time.monotonic() + args.wait
    while not os.path.exists(args.socket):
        if time.monotonic() >= deadline:
            break
        time.sleep(0.2)

    from repro_torch.serve.client import ServeClient

    if args.check:
        import torch

        from repro_torch import sim
        from repro_torch.core import buzen

        on_card = torch.device(args.device).type == "cuda"
        buzen.set_backend(args.buzen_backend
                          or ("kernel" if on_card else "torch"))
        sim.set_backend(args.sim_backend
                        or ("kernel" if on_card else "batched"))

    sim3, sim5, ana, tr = make_scenarios()
    with ServeClient(args.socket, timeout=600) as a, \
            ServeClient(args.socket, timeout=600) as b:
        # two connections pipeline into the same micro-batch windows:
        # the two simulates coalesce into ONE padded dispatch
        ra1 = a.submit(sim3, mode="simulate", seeds=(0, 1), **SIM)
        rb1 = b.submit(sim5, mode="simulate", seeds=(0, 1), **SIM)
        ra2 = a.submit(ana, mode="analyze")
        rb2 = b.submit(tr, mode="train", seeds=(0,), **TRAIN)
        got = {
            "simulate/n=3": (a, ra1, sim3, "simulate", (0, 1), SIM),
            "simulate/n=5": (b, rb1, sim5, "simulate", (0, 1), SIM),
            "analyze": (a, ra2, ana, "analyze", (0,), {}),
            "train": (b, rb2, tr, "train", (0,), TRAIN),
        }
        failures = 0
        for label, (client, rid, scn, mode, seeds, opts) in got.items():
            payload = client.unwrap(client.collect(rid))
            events = [e["event"] for e in client.events_for(rid)]
            sched = [e for e in client.events_for(rid)
                     if e["event"] == "scheduled"]
            width = (f" ({sched[0]['requests']} req / "
                     f"{sched[0]['lanes']} lanes)" if sched else " (cached)")
            print(f"{label}: {events or ['cached']}{width}")
            if args.check:
                direct = direct_payload(scn, mode, seeds, args.device,
                                        **opts)
                ok = json.dumps(payload) == json.dumps(direct)
                print(f"  bitwise-equal to direct run: {ok}")
                failures += 0 if ok else 1
        stats = a.stats()
        print("server stats:",
              json.dumps({k: v for k, v in stats["counters"].items()
                          if k.startswith("serve.")}, indent=1))
        if args.shutdown:
            print("shutdown:", a.shutdown())
    if args.check and failures:
        print(f"FAILED: {failures} payload(s) diverged", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
