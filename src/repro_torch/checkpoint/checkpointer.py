"""Atomic, async checkpoints in the JAX package's on-disk format, so that
a checkpoint crosses between the two packages in either direction.

Format: one ``step_{step:08d}`` directory per step (written as ``.tmp``
and renamed), holding ``manifest.json`` ({"step", "treedef": null,
"n_leaves", "leaves": [{"shape", "dtype"}, ...]}) and one
``leaf_{i:05d}.npy`` per leaf, in the JAX package's flatten order: dict
keys sorted at every level, each per-layer list of the port stacked
into ``(L, ...)`` leaves as the JAX package keeps its layers
(``tree.stacked_leaves``).  Restore splits them back into the template's
lists.  The JAX package writes a serialized treedef where it can; its
restore reads only the structure of the abstract tree it is given, so
the port writes none.  bfloat16 leaves are written and read as raw
2-byte records under the manifest dtype ``bfloat16``, as ``ml_dtypes``
arrays land on disk; a leaf numpy cannot read raises, naming the leaf.

Fault-tolerance contract used by ``launch/train.py``: ``save`` is atomic,
``save_async`` snapshots to the host and writes on a thread,
``latest_step`` / ``restore`` restart after a preemption, ``keep`` bounds
the steps kept on disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device


def _to_host(path: str, parts: list, stacked: bool) -> np.ndarray:
    # a copy on the host (stack copies), never a view of a live tensor
    t = torch.stack([p.detach() for p in parts]).cpu() if stacked else \
        torch.as_tensor(parts[0]).detach().to("cpu", copy=True)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    try:
        return t.numpy()
    except TypeError as e:
        raise TypeError(f"checkpoint leaf {path!r}: {t.dtype} has no numpy "
                        f"form") from e


def _snapshot(tree) -> list:
    """(dtype name, host array) per JAX-ordered leaf of ``tree``."""
    out = []
    for path, parts, stacked in T.stacked_leaves(tree):
        a = _to_host(path, parts, stacked)
        out.append(("bfloat16" if a.dtype.kind == "V" else str(a.dtype), a))
    return out


def _from_host(a: np.ndarray, dtype_name: str, path: str) -> torch.Tensor:
    a = np.require(a, requirements="C")  # keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16" and a.dtype.itemsize == 2 and \
            a.dtype.kind in "Vu":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.kind == "V":
        raise ValueError(f"checkpoint leaf {path!r}: its {dtype_name} "
                         f"records cannot be read without that dtype")
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    # -- save ------------------------------------------------------------------
    def save(self, tree, step: int):
        """Blocking, atomic save of a tree of tensors."""
        self._write(_snapshot(tree), step)

    def _write(self, host: list, step: int):
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step, "treedef": None, "n_leaves": len(host),
            "leaves": [{"shape": list(a.shape), "dtype": name}
                       for name, a in host],
        }
        for i, (_, a) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def save_async(self, tree, step: int):
        """Non-blocking save: snapshots to the host first, so training can
        mutate the live tensors as soon as this returns."""
        host = _snapshot(tree)
        self.wait()
        self._thread = threading.Thread(target=self._write,
                                        args=(host, step), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, template, step: Optional[int] = None, *, device=None,
                take=None):
        """Restore into the structure, shapes and dtypes of ``template``
        (a tree of tensors; ``meta`` tensors will do).  Each leaf lands on
        its template leaf's device, or for a ``meta`` template on
        ``device`` (CUDA unless asked otherwise).  ``take(path, tensor)``,
        if given, maps each leaf read (the global array, on the host)
        before it moves there: the elastic restore takes a rank's block
        (the JAX package's ``shardings=``).  Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        entries = T.stacked_leaves(template)
        if len(entries) != manifest["n_leaves"]:
            raise ValueError(f"tree mismatch: {len(entries)} leaves vs "
                             f"{manifest['n_leaves']} in {d}")
        meta_dev = None
        restored = {}
        for i, ((path, parts, stacked), rec) in enumerate(
                zip(entries, manifest["leaves"])):
            ref = parts[0]
            want = ((len(parts),) if stacked else ()) + tuple(ref.shape)
            fname = os.path.join(d, f"leaf_{i:05d}.npy")
            try:
                a = np.load(fname)
            except Exception as e:
                raise ValueError(f"checkpoint leaf {path!r} ({fname}): numpy "
                                 f"cannot read it: {e}") from e
            if tuple(a.shape) != want:
                raise ValueError(f"checkpoint leaf {path!r}: shape "
                                 f"{a.shape}, expected {want}")
            dev = ref.device
            if dev.type == "meta":
                meta_dev = meta_dev or resolve_device(device)
                dev = meta_dev
            t = _from_host(a, rec["dtype"], path)
            if take is not None:
                t = take(path, t)
            t = t.to(device=dev, dtype=ref.dtype)
            for part, value in zip(parts, t.unbind(0) if stacked else [t]):
                restored[id(part)] = value
        leaves, spec = T.flatten(template)
        return T.unflatten(spec, [restored[id(l)] for l in leaves]), step
