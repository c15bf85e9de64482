"""The port's examples on the CPU (``--device cpu``) at reduced sizes:
``examples/quickstart_torch.py`` trains the reduced OLMo-1B and its NLL
falls; ``examples/serve_batched_torch.py`` serves the reduced MiniCPM-2B
and returns tokens of the stated shape.  Both run in process."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_nll_falls():
    trainer = _example("quickstart_torch").main(
        ["--device", "cpu", "--steps", "6", "--seq-len", "32", "--batch", "4"])
    nll = [h["nll"] for h in trainer.history]
    assert len(nll) == 6 and all(np.isfinite(nll)) and nll[-1] < nll[0]


def test_serve_batched_tokens():
    tokens, stats = _example("serve_batched_torch").main(
        ["--device", "cpu", "--batch", "3", "--prompt-len", "16",
         "--tokens", "5"])
    tokens = np.asarray(tokens)
    assert tokens.shape == (3, 5)
    vocab = get_reduced("minicpm-2b").padded_vocab
    assert ((0 <= tokens) & (tokens < vocab)).all()
    assert stats.prefill_seconds > 0


def test_examples_raise_without_a_card():
    """Without ``--device cpu`` they ask for CUDA, which this host lacks."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("serve_batched_torch").main(["--tokens", "2"])
