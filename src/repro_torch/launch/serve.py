"""Scenario-serving CLI: continuous-batched what-if requests from the command line.

Port of ``repro.launch.serve``.  Reads a JSON request file (a list of
``ScenarioSpec`` keyword dicts), or builds a built-in demo mix, and serves
it through a resident ``ScenarioService`` on ``--device`` (the card by
default): requests are validated at parse time, grouped by compatibility
signature, and each group runs as one batched launch with engine-cache
reuse across rounds.  Per-request latency and tx accounting and the
service's counters go to stdout and (optionally) a JSON report with the
reference's fields.

  PYTHONPATH=src python -m repro_torch.launch.serve --demo --iters 40
  PYTHONPATH=src python -m repro_torch.launch.serve --requests reqs.json \
      --max-cells 8 --out serve_report.json
  PYTHONPATH=src python -m repro_torch.launch.serve --demo --device cpu

Request-file example:

  [{"m": 10, "policy": "efhc", "iters": 100, "seeds": [0, 1]},
   {"m": 10, "policy": "gossip", "iters": 100, "seeds": [0]}]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def load_requests(path: str):
    from repro_torch.api import ScenarioSpec

    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"{path}: cannot read request file: {e}") from e
    if not isinstance(raw, list) or not raw:
        raise SystemExit(f"{path}: expected a non-empty JSON list of "
                         f"ScenarioSpec keyword dicts")
    specs = []
    for i, kw in enumerate(raw):
        if not isinstance(kw, dict):
            raise SystemExit(f"{path}[{i}]: expected an object, got "
                             f"{type(kw).__name__}")
        try:
            specs.append(ScenarioSpec(**{k: tuple(v) if isinstance(v, list)
                                         else v for k, v in kw.items()}))
        except (TypeError, ValueError) as e:
            raise SystemExit(f"{path}[{i}]: invalid request: {e}") from e
    return specs


def demo_requests(iters: int):
    """Small mixed demo set: two signatures, heterogeneous policies/seeds."""
    from repro_torch.api import ScenarioSpec

    fleet_a = dict(m=10, dim=64, n_train=1200, n_test=300, iters=iters,
                   eval_every=10)
    fleet_b = dict(m=12, topology="ring", time_varying="static", dim=32,
                   n_train=1200, n_test=300, iters=iters, eval_every=10,
                   r=20.0)
    return [ScenarioSpec(**fleet_a, policy="efhc", seeds=(0, 1)),
            ScenarioSpec(**fleet_a, policy="gossip", seeds=(0,)),
            ScenarioSpec(**fleet_a, policy="zero", seeds=(1,)),
            ScenarioSpec(**fleet_b, policy="efhc", seeds=(0,)),
            ScenarioSpec(**fleet_b, policy="global", seeds=(1,))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--requests", help="JSON file: list of ScenarioSpec kwargs")
    src.add_argument("--demo", action="store_true",
                     help="serve the built-in mixed demo request set")
    ap.add_argument("--iters", type=int, default=60,
                    help="horizon for --demo requests (ignored with --requests)")
    ap.add_argument("--max-cells", type=int, default=16,
                    help="max (request, seed) cells per batched launch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="JSON report path")
    args = ap.parse_args(argv)

    from repro_torch.api import ScenarioService

    specs = (demo_requests(args.iters) if args.demo
             else load_requests(args.requests))
    svc = ScenarioService(max_cells=args.max_cells, device=args.device)
    t0 = time.time()
    reports = svc.serve(specs)
    wall = time.time() - t0
    stats = svc.stats()

    print(f"{'req':>3s} {'sig':>4s} {'launch':>6s} {'cells':>5s} "
          f"{'policy':>8s} {'queue_ms':>8s} {'run_ms':>7s} {'eng$':>4s} "
          f"{'prog$':>5s} {'acc':>6s}")
    sig_ids: dict[tuple, int] = {}
    rows = []
    for rep in reports:
        sig = sig_ids.setdefault(rep.spec.signature(), len(sig_ids))
        acc = sum(r.acc[-1] for r in rep.results.values()) / len(rep.results)
        print(f"{rep.request_id:3d} {sig:4d} {rep.launch_id:6d} "
              f"{len(rep.results):5d} {rep.spec.policy:>8s} "
              f"{1e3 * rep.queue_wait_s:8.1f} {1e3 * rep.run_s:7.0f} "
              f"{str(rep.engine_cache_hit)[0]:>4s} "
              f"{str(rep.program_cache_hit)[0]:>5s} {acc:6.3f}")
        rows.append({**rep.timing_dict(), "signature": sig,
                     "policy": rep.spec.policy, "mean_final_acc": float(acc),
                     "tx": {s: t.as_dict() for s, t in rep.tx.items()}})
    print(f"\n{len(reports)} requests / {stats.cells} cells / "
          f"{stats.launches} launches in {wall:.1f}s "
          f"({stats.cells / wall:.2f} sims/s); engine cache "
          f"{stats.engine.hits}h/{stats.engine.misses}m, program cache "
          f"{stats.program_hits}h/{stats.program_misses}m")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"requests": rows, "service": stats.as_dict(),
                       "wall_s": wall, "sims_per_s": stats.cells / wall},
                      f, indent=2)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
