"""Plan-store CLI (port of ``python -m repro.planstore``).

    python -m repro_torch.planstore inspect    (--dir DIR | --store URL)
    python -m repro_torch.planstore purge      (--dir DIR | --store URL)
    python -m repro_torch.planstore warm-check (--dir DIR | --store URL)
                                               [--devices 8] [--assert-warm]
                                               [--collective alltoallv
                                                  |allgatherv|reduce_scatter]
                                               [--device cuda|cpu]
    python -m repro_torch.planstore prewarm    --store URL
                                               [--from-dryrun PATH ...]
                                               [--profile arch:shape:DxD ...]
                                               [--reduced] [--seq-len N]
                                               [--global-batch N]
                                               [--device cuda|cpu]

Every subcommand accepts a plain directory (``--dir``) or a store URL
(``--store``: a path, ``fsremote://…``, or ``tiered:local=…,remote=…`` —
see ``planstore.parse_store_url``).  ``--device`` is the device the INITs
run on and the store keys are taken for: the card (``cuda``, the default)
unless ``cpu`` is asked for.

``warm-check`` runs one ``variant="auto"`` INIT of a canonical skewed
pattern (the JAX CLI's) on a ``VirtualMesh((2, P/2), ("o", "i"))`` of
``--devices`` P virtual ranks against the store and prints the
``init_stats`` counters as JSON.  ``--collective`` picks the exchange
family (default alltoallv).  The first invocation against an empty store
is cold (it measures, bakes, and populates); any later invocation on the
same device kind is warm.  ``--assert-warm`` turns the warm contract into
an exit code: zero autotune measurement bursts and zero table bakes, or
failure.

``prewarm`` is the deploy-time pipeline (``planstore.prewarm``): it
enumerates INIT requests from dryrun cell records (``--from-dryrun``, the
``plan_inits`` capture of the port's ``launch/dryrun.py``, or of the JAX
package's) and/or
serve profiles (``--profile``: prefill or decode shapes of a ported
architecture), replays them on ``--device``, and publishes the artifacts
into ``--store`` — so a fresh replica on that device kind pointed at the
store warm-starts its very first INIT.

Nothing runs at import: the subcommands import torch and the port lazily.
"""

from __future__ import annotations

import argparse
import json
import sys


def _open_store(args):
    from repro_torch.planstore import parse_store_url

    return parse_store_url(args.store or args.dir)


def _load_entry(store, key):
    """Decode one entry by key from either tier of ``store``."""
    from repro_torch.planstore.store import TieredPlanStore

    tiers = (store.local, store.remote) if isinstance(store, TieredPlanStore) \
        else (store,)
    for tier in tiers:
        try:
            return tier._load_key(key)
        except FileNotFoundError:
            continue
    raise FileNotFoundError(key)


def _cmd_inspect(args) -> int:
    store = _open_store(args)
    rows = []
    for e in store.entries():
        try:
            rows.append(dict(_load_entry(store, e["key"]).summary(),
                             key=e["key"], bytes=e["bytes"]))
        except Exception as exc:
            rows.append({"key": e["key"], "bytes": e["bytes"],
                         "error": str(exc)})
    print(json.dumps({"root": store.root, "entries": rows}, indent=2))
    return 0


def _cmd_purge(args) -> int:
    n = _open_store(args).purge()
    print(json.dumps({"removed": n}))
    return 0


def _warm_check_pattern(collective: str, p: int):
    """Canonical skewed pattern per family (the JAX CLI's): dense-ish with
    one hot rank — exercises every candidate variant (and its baked tables)
    meaningfully, and stays off the uniform identity fast path."""
    import numpy as np

    rng = np.random.default_rng(42)
    if collective == "alltoallv":
        counts = rng.integers(4, 24, size=(p, p)).astype(np.int64)
        counts[:, 0] += 40      # receiver skew: lock's worst case
        return counts
    counts = rng.integers(4, 24, p).astype(np.int64)
    counts[0] += 40             # hot contributor / hot destination
    return counts


def _cmd_warm_check(args) -> int:
    from repro_torch.core import (PlanCache, exchange_init, init_stats,
                                  reset_init_stats)
    from repro_torch.launch.mesh import VirtualMesh

    p = args.devices
    if p % 2:
        raise SystemExit("warm-check needs an even virtual rank count")
    counts = _warm_check_pattern(args.collective, p)
    mesh = VirtualMesh((2, p // 2), ("o", "i"), device=args.device)
    store = _open_store(args)

    reset_init_stats()
    plan = exchange_init(args.collective, counts, (16,), "float32", mesh,
                         axis=("o", "i"), variant="auto", cache=PlanCache(),
                         store=store, autotune_iters=args.iters)
    stats = init_stats()
    warm = stats["autotune_bursts"] == 0 and stats["table_bakes"] == 0
    report = {
        "warm": warm,
        "collective": plan.spec.collective,
        "chosen_variant": plan.spec.variant,
        "device": str(mesh.device),
        "device_kind": store.kind_for(mesh.device),
        "auto_times": (plan.auto_choice or {}).get("times"),
        "init_host_seconds": plan.init_host_seconds,
        "init_stats": stats,
        "store": store.stats,
    }
    print(json.dumps(report, indent=2))
    if args.assert_warm and not warm:
        print("warm-check: expected a warm INIT (zero autotune bursts, zero "
              "table bakes) but the store missed", file=sys.stderr)
        return 1
    return 0


def _parse_profile(spec: str):
    parts = spec.split(":")
    if len(parts) not in (3, 4):
        raise SystemExit(f"--profile must be arch:shape:DxD[:rules], got {spec!r}")
    arch, shape, mesh = parts[:3]
    if len(parts) == 4 and parts[3] != "default":
        raise SystemExit("the port's serve bundles use their own rule "
                         f"profiles; --profile takes no rules, got {parts[3]!r}")
    dims = tuple(int(d) for d in mesh.replace("x", ",").split(","))
    return arch, shape, dims


def _cmd_prewarm(args) -> int:
    from repro_torch import planstore as planstore_mod
    from repro_torch.planstore import prewarm as pw

    if not args.from_dryrun and not args.profile:
        raise SystemExit("prewarm needs --from-dryrun and/or --profile")
    reqs: list[dict] = []
    for path in args.from_dryrun or []:
        reqs.extend(pw.requests_from_dryrun(path))
    store = _open_store(args)
    # Profile capture publishes as it builds (its INITs see the default
    # store), so configure it process-wide before building any bundle.
    planstore_mod.configure(store)
    for arch, shape, dims in (_parse_profile(s) for s in args.profile or []):
        reqs.extend(pw.requests_from_profile(
            arch, shape, dims, reduced=args.reduced, seq_len=args.seq_len,
            global_batch=args.global_batch, device=args.device))

    report = pw.prewarm(reqs, store, autotune_iters=args.iters,
                        device=args.device)
    print(json.dumps(report, indent=2))
    if not report["prewarmed"] and not args.allow_empty:
        print("prewarm: no requests were replayed (empty capture) — pass "
              "--allow-empty to accept", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.planstore", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("inspect", _cmd_inspect), ("purge", _cmd_purge),
                     ("warm-check", _cmd_warm_check),
                     ("prewarm", _cmd_prewarm)):
        sp = sub.add_parser(name)
        sp.add_argument("--dir", default=None, help="store directory")
        sp.add_argument("--store", default=None,
                        help="store URL (path, fsremote://…, or "
                             "tiered:local=…,remote=…)")
        sp.set_defaults(fn=fn)
        if name in ("warm-check", "prewarm"):
            sp.add_argument("--device", default="cuda",
                            help="device the INITs run on and are keyed "
                                 "for: cuda (default) or cpu")
        if name == "warm-check":
            sp.add_argument("--devices", type=int, default=8,
                            help="virtual ranks P of the (2, P/2) mesh")
            sp.add_argument("--iters", type=int, default=6,
                            help="autotune iterations when cold")
            sp.add_argument("--assert-warm", action="store_true")
            sp.add_argument("--collective", default="alltoallv",
                            choices=("alltoallv", "allgatherv",
                                     "reduce_scatter"),
                            help="exchange family to warm-check")
        if name == "prewarm":
            sp.add_argument("--from-dryrun", action="append", metavar="PATH",
                            help="dryrun cell JSON file or directory of them "
                                 "(plan_inits capture); repeatable")
            sp.add_argument("--profile", action="append",
                            metavar="ARCH:SHAPE:DxD",
                            help="serve profile to capture+publish; repeatable")
            sp.add_argument("--reduced", action="store_true",
                            help="profiles use the smoke-scale configs")
            sp.add_argument("--seq-len", type=int, default=None)
            sp.add_argument("--global-batch", type=int, default=None)
            sp.add_argument("--iters", type=int, default=None,
                            help="override autotune iterations for replays")
            sp.add_argument("--allow-empty", action="store_true")
    args = ap.parse_args(argv)
    if not args.store and not args.dir:
        ap.error("one of --dir / --store is required")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
