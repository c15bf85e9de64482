"""End-to-end example on the PyTorch port: train a reduced OLMoE with
expert-parallel MoE dispatch running through the persistent alltoallv
engine, on a (data=2, model=4) mesh of virtual ranks on one device, with
checkpointing + auto-resume.  The port of ``examples/train_moe_ep.py``.

    PYTHONPATH=src python examples/train_moe_ep_torch.py [n_steps]              # the card
    PYTHONPATH=src python examples/train_moe_ep_torch.py [n_steps] --device cpu
"""

import argparse
import tempfile

from repro_torch.configs import ShapeConfig, get_reduced
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import ScheduleConfig, Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_steps", type=int, nargs="?", default=60)
    ap.add_argument("--device", default="cuda",
                    help="device of the virtual ranks: cuda (default) or cpu")
    args = ap.parse_args(argv)
    n_steps = args.n_steps

    cfg = get_reduced("olmoe-1b-7b")       # 8 experts, top-2, persistent a2a
    shape = ShapeConfig("moe_ep", "train", seq_len=256, global_batch=8)
    mesh = make_mesh((2, 4), ("data", "model"),
                     device=args.device)   # DP=2, EP=4

    bundle = steps_mod.make_train_bundle(
        cfg, shape, mesh,
        sched=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=6,
                             total_steps=n_steps, decay_steps=n_steps // 5))
    plan = bundle.meta["moe_plan"]
    print(f"MoE dispatch plan: EP={plan.ep_size}, {plan.e_local} experts/shard, "
          f"capacity={plan.capacity}, variant={plan.variant}, "
          f"plan_backed={plan.plan_backed}"
          + (f" (warm={plan.a2a.warm_loaded})" if plan.plan_backed else ""))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(bundle, TrainerConfig(
            n_steps=n_steps, ckpt_dir=ckpt_dir, ckpt_every=20, log_every=10))
        try:
            result = trainer.run()
        finally:
            trainer.close()
        print(f"\nfinished at step {result['final_step']}; "
              f"last: {result['last_metrics']}")
        first = trainer.history[0]["nll"]
        last = trainer.history[-1]["nll"]
        print(f"nll {first:.3f} -> {last:.3f}")
    return trainer


if __name__ == "__main__":
    main()
