"""Batched serving on the PyTorch port: prefill a batch of prompts, decode
with persistent KV caches written in place, report throughput.  The port
of ``examples/serve_batched.py``.

    PYTHONPATH=src python examples/serve_batched_torch.py                # the card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="device of the mesh: cuda (default) or cpu")
    args = ap.parse_args(argv)
    batch, prompt_len, n_tokens = args.batch, args.prompt_len, args.tokens

    cfg = get_reduced("minicpm-2b")
    mesh = make_mesh((1, 1), ("data", "model"), device=args.device)
    engine = ServeEngine(cfg, mesh, batch=batch, prompt_len=prompt_len,
                         max_seq=prompt_len + n_tokens + 8, seed=0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)

    tokens, stats = engine.generate(prompts, n_tokens)
    print(f"prompts {prompts.shape} -> generated {tokens.shape} "
          f"on {mesh.device}")
    print(f"prefill: {stats.prefill_seconds * 1e3:.1f} ms")
    print(f"decode:  {stats.decode_seconds_per_token * 1e3:.2f} ms/token "
          f"({batch / max(stats.decode_seconds_per_token, 1e-9):.1f} tok/s "
          f"batched)")
    print("first sequences:", tokens[:2].tolist())
    return tokens, stats


if __name__ == "__main__":
    main()
