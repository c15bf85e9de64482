"""The paper in miniature on the PyTorch port: persistent RMA-style
alltoallv on 8 virtual ranks of one device.

Builds an irregular (hugetrace-like) communication pattern, runs the
non-persistent baseline and the persistent fence / lock / hierarchy plans
(and ``variant="auto"``), validates every byte against the numpy oracle,
and prints the break-even analysis (paper Eq. 1-3).  The port of
``examples/persistent_alltoallv.py``.

    PYTHONPATH=src python examples/persistent_alltoallv_torch.py             # the card
    PYTHONPATH=src python examples/persistent_alltoallv_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (PlanCache, alltoallv_init, breakeven,
                              metadata as md, reference)
from repro_torch.core.baseline import make_nonpersistent
from repro_torch.launch.mesh import VirtualMesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the virtual ranks: cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)

    p, feature = 8, 128
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 64, size=(p, p))
    counts[:, 5] *= 4                      # one hot receiver (skew)
    print("count matrix (rows=senders):")
    print(counts)

    send_rows = md.round_up(md.max_total_send(counts), 8)
    recv_rows = md.round_up(md.max_total_recv(counts), 8)
    bufs = reference.make_testbufs(counts, (feature,), np.float32, send_rows)
    expect = reference.alltoallv_global(bufs, counts, recv_rows)
    rc = md.recv_counts(counts)

    mesh = VirtualMesh((p,), ("x",), device=args.device)
    x = torch.from_numpy(bufs.reshape(p * send_rows, feature)).to(mesh.device)
    print(f"{p} virtual ranks on {mesh.device}")

    def validate(out, label):
        got = out.cpu().numpy().reshape(p, recv_rows, feature)
        for r in range(p):
            n = int(rc[r].sum())
            np.testing.assert_array_equal(got[r, :n], expect[r, :n])
        print(f"  {label:24s} validated element-wise")

    # ---- INIT (one-time) + START/WAIT (per-iteration) ----
    cache = PlanCache()
    plans = {}
    for variant in ("fence", "lock"):
        plan = alltoallv_init(counts, (feature,), torch.float32, mesh,
                              axis="x", variant=variant, cache=cache)
        plan.compile()
        print(f"INIT {variant}: host metadata {plan.init_host_seconds*1e6:.0f} us, "
              f"compile {plan.init_compile_seconds*1e3:.2f} ms")
        validate(plan.wait(plan.start(x)), f"{variant}_persistent")
        plans[variant] = plan

    mesh2 = VirtualMesh((2, 4), ("node", "core"), device=args.device)
    plan_h = alltoallv_init(counts, (feature,), torch.float32, mesh2,
                            axis=("node", "core"), variant="fence_hierarchy",
                            cache=cache)
    plan_h.compile()
    validate(plan_h.wait(plan_h.start(x)), "fence_hierarchy")
    plans["fence_hierarchy"] = plan_h

    auto = alltoallv_init(counts, (feature,), torch.float32, mesh, axis="x",
                          variant="auto", cache=cache)
    validate(auto.wait(auto.start(x)), f"auto -> {auto.spec.variant}")
    print("  auto arm times (us): " + ", ".join(
        f"{v}={t*1e6:.1f}" for v, t in sorted(auto.auto_choice["times"].items())))

    base = make_nonpersistent(mesh, axis="x", p=p,
                              capacity=plans["fence"].capacity,
                              send_rows=send_rows, recv_rows=recv_rows,
                              feature_shape=(feature,), dtype=torch.float32)
    cnts = torch.tensor(counts.reshape(-1), dtype=torch.int32,
                        device=mesh.device)
    validate(base(x, cnts), "nonpersistent baseline")

    # ---- break-even (Eq. 1-3): each call blocked until the device idles ----
    print("\nbreak-even analysis:")
    for variant, plan in plans.items():
        be = breakeven.measure(lambda: plan.start(x), lambda: base(x, cnts),
                               t_init=plan.init_host_seconds
                               + plan.init_compile_seconds, iters=args.iters)
        print(f"  {variant:16s}: T_MPI={be.t_mpi*1e6:8.1f} us  "
              f"T_persist={be.t_persist*1e6:8.1f} us  "
              f"savings={be.savings_pct:5.1f}%  N_breakeven={be.n_breakeven}")


if __name__ == "__main__":
    main()
