"""Checkpointing: atomic, resumable, optionally async (port of
``repro.ckpt.manager``).

Layout:  <dir>/step_<N>/
           manifest.json      step, tree structure, per-leaf file, dtype
                              and shape, extras
           <i>.npy            one file per flattened leaf, in tree order
           _COMPLETE          commit marker (atomic rename discipline)

The JAX package writes a msgpack manifest and one ``.npz``; this format
needs numpy and the standard library only.  bfloat16 leaves, which numpy
has no type for, are stored as their uint16 bits and named ``bfloat16`` in
the manifest.  Tensors are copied to host memory before ``save`` returns,
so an async write never races the next step's in-place update.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from .._tree import leaves_with_paths


def _template(tree):
    """JSON-able structure mirror with leaf markers (None)."""
    if isinstance(tree, dict):
        return {k: _template(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_template(v) for v in tree]
    return None


def _unflatten(template, flat: dict, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
    return flat[prefix[:-1]]


def _to_host(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", copy=True)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, trees: dict[str, Any], extras: dict | None = None):
        """trees: {"params": ..., "opt": ..., ...} trees of tensors."""
        self.wait()
        host = {name: [(p, _to_host(x)) for p, x in leaves_with_paths(tree)]
                for name, tree in trees.items()}
        templates = {name: _template(tree) for name, tree in trees.items()}
        args = (step, host, templates, extras or {})
        if self.async_save:
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=args)
            self._thread.start()
        else:
            self._write(*args)

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _write(self, step: int, host: dict, templates: dict, extras: dict):
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = {}
        i = 0
        for name, flat in host.items():
            for path, t in flat:
                arr, dtype = _to_numpy(t)
                fname = f"{i}.npy"
                np.save(os.path.join(tmp, fname), arr)
                entries[f"{name}/{path}"] = {"file": fname, "dtype": dtype,
                                             "shape": list(t.shape)}
                i += 1
        manifest = {"step": step, "template": templates, "leaves": entries,
                    "extras": extras, "time": time.time()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        open(os.path.join(tmp, "_COMPLETE"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        """Block until the async write in flight (if any) has published;
        re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- load ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            p = os.path.join(self.directory, d)
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(p, "_COMPLETE")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None):
        """Returns (step, {"name": tree of CPU tensors}, extras)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        trees = {}
        for name, template in manifest["template"].items():
            flat = {}
            for key, ent in manifest["leaves"].items():
                if key.startswith(name + "/"):
                    arr = np.load(os.path.join(d, ent["file"]))
                    flat[key[len(name) + 1:]] = _from_numpy(
                        arr, ent["dtype"]).reshape(ent["shape"])
            trees[name] = _unflatten(template, flat)
        return step, trees, manifest.get("extras", {})
