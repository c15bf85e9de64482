"""Quickstart on the PyTorch port: train a small LM for a few steps and
watch the loss drop.  The port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py                # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

from repro_torch.configs import ShapeConfig, get_reduced
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import ScheduleConfig, Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="device of the mesh: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced("olmo-1b")                      # 4L/128d smoke config
    shape = ShapeConfig("quickstart", "train", seq_len=args.seq_len,
                        global_batch=args.batch)
    mesh = make_mesh((1, 1), ("data", "model"),       # one rank
                     device=args.device)

    bundle = steps_mod.make_train_bundle(
        cfg, shape, mesh,
        sched=ScheduleConfig(kind="cosine", peak_lr=3e-3,
                             warmup_steps=min(5, args.steps // 2),
                             total_steps=args.steps))
    trainer = Trainer(bundle, TrainerConfig(n_steps=args.steps,
                                            log_every=10))
    try:
        result = trainer.run()
    finally:
        trainer.close()

    first = trainer.history[0]["nll"]
    last = trainer.history[-1]["nll"]
    print(f"\nnll {first:.3f} -> {last:.3f} over {result['final_step']} steps")
    if not last < first:
        raise SystemExit(f"the loss did not fall: {first} -> {last}")
    return trainer


if __name__ == "__main__":
    main()
