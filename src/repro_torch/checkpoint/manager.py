"""Atomic, sha256-checked checkpoints of a tree of tensors (the counterpart
of ``repro/checkpoint/manager.py``, with the same on-disk layout).

Layout: ``<dir>/step_<N>/`` holding one ``arrays.npz`` (flattened
``"a/b/c"`` key -> array) and ``manifest.json`` (step, the sorted keys,
and the caller's ``meta``: the data-iterator state, the arch).  A save
writes ``step_<N>.tmp``, adds the ``sha256.json`` sidecar (a digest of
each payload file) and renames the directory into place through the
module's patchable ``_publish``, so a crash mid-write never corrupts the
latest checkpoint; ``restore`` takes the newest complete step, verifies
the digests before it reads an array and raises
:class:`CheckpointCorruptError` on a mismatch (``verify=False`` skips the
check, to salvage a damaged step; a step with no sidecar restores with a
warning).  The layout is the JAX package's, so a checkpoint written by
either package restores in the other; the port's trees keep the JAX keys.

Arrays are stored as numpy, unsharded; ``restore`` puts each one on the
device of the template's leaf in its place, in the stored dtype.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings

import numpy as np
import torch

#: files whose digests the sha256 sidecar covers
_PAYLOAD_FILES = ("arrays.npz", "manifest.json")

# the atomic rename, patchable: a test swaps it to simulate a crash after
# the temp write but before the publish
_publish = os.rename


class CheckpointCorruptError(RuntimeError):
    """A checkpoint payload does not match its sha256 sidecar."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat):
    def rebuild(t, prefix=""):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v, f"{prefix}{i}/")
                           for i, v in enumerate(t))
        arr = flat[prefix[:-1]]
        device = t.device if isinstance(t, torch.Tensor) else "cpu"
        # a copy: np.load hands out read-only arrays
        return torch.from_numpy(np.array(arr)).to(device)
    return rebuild(template)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------
    def save(self, step: int, state, *, meta: dict | None = None):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {k: _numpy(v) for k, v in _flatten(state).items()
                  if hasattr(v, "shape")}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"step": step, "keys": sorted(arrays)}
        manifest.update(meta or {})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        # the sidecar is written before the publish, so a published step
        # always carries its digests
        digests = {name: _sha256(os.path.join(tmp, name))
                   for name in _PAYLOAD_FILES}
        with open(os.path.join(tmp, "sha256.json"), "w") as f:
            json.dump(digests, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        _publish(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, name,
                                                    "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> None:
        """Check the step's payload files against the sha256 sidecar.

        Raises :class:`CheckpointCorruptError` on a mismatch or a missing
        payload.  A step with no ``sha256.json`` (written before the
        sidecar existed) warns and passes unverified.
        """
        path = os.path.join(self.dir, f"step_{step:08d}")
        sidecar = os.path.join(path, "sha256.json")
        if not os.path.exists(sidecar):
            warnings.warn(
                f"checkpoint step {step} predates integrity sidecars "
                "(no sha256.json) — restoring unverified", RuntimeWarning,
                stacklevel=2)
            return
        with open(sidecar) as f:
            digests = json.load(f)
        for name, want in digests.items():
            fpath = os.path.join(path, name)
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: payload {name} missing")
            got = _sha256(fpath)
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: {name} sha256 mismatch "
                    f"(stored {want[:12]}…, actual {got[:12]}…) — the "
                    "file is corrupt (bit-flip/truncation); restore an "
                    "older step or pass verify=False to salvage")

    def restore(self, state_template, step: int | None = None, *,
                verify: bool = True):
        """``state_template``'s structure rebuilt from the stored arrays,
        each a tensor on its template leaf's device -> ``(state,
        manifest)``, or ``(None, None)`` when there is no step.
        ``verify`` checks the sidecar before anything is read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        if verify:
            self.verify_step(step)
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: data[k] for k in data.files}
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return _unflatten_into(state_template, flat), manifest
