"""Checkpoint / resume for inverse-rendering fits.

The reference has no persistence of any kind — no state outlives the process
(``/root/reference/Code/src/main.cpp:103-107``).  Here fits checkpoint the
scene-parameter pytree + optimizer state (SURVEY.md §5): atomic single-file
snapshots of the pytree's leaves as a NumPy ``.npz`` file, with a JSON
manifest carrying the step counter and loss history.  Renders themselves are stateless.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import tempfile
from typing import Any

import jax
import numpy as np


def save_checkpoint(path: str | os.PathLike, state: Any, step: int, meta: dict | None = None) -> None:
    """Atomically write ``state`` (any pytree) + metadata to ``path``.

    Layout: ``<path>`` is a directory with ``state.npz`` (leaf ``i`` of
    ``jax.tree_util.tree_leaves(state)`` under key ``leaf_i``) and
    ``manifest.json``.  Writes go to a temp name then ``os.replace`` — a
    crash mid-write never corrupts the previous checkpoint.

    **Multi-host**: only process 0 writes (fit state is replicated, so its
    copy is complete); every other process is a silent no-op — N processes
    racing ``os.replace`` on one shared directory is corruption.  Resume
    (:func:`load_checkpoint`) runs on *all* processes, so the checkpoint path
    must be readable everywhere (shared filesystem, or replicated file).
    """
    if jax.process_index() != 0:
        return
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = jax.device_get(jax.tree_util.tree_leaves(state))
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    payload = buf.getvalue()

    def atomic_write(name: str, data: bytes):
        fd, tmp = tempfile.mkstemp(dir=path, prefix=name + ".")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path / name)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    atomic_write("state.npz", payload)
    manifest = {"step": int(step), **(meta or {})}
    atomic_write("manifest.json", json.dumps(manifest, indent=2).encode())


def load_checkpoint(path: str | os.PathLike, state_template: Any):
    """Restore ``(state, manifest)``; ``state_template`` supplies the pytree
    structure, whose leaves are replaced in order.  Returns ``(None,
    None)`` if no checkpoint exists — callers start fresh deterministically
    (the SURVEY §5 failure-recovery story: re-init from the last snapshot).
    """
    path = pathlib.Path(path)
    state_file = path / "state.npz"
    if not state_file.exists():
        return None, None
    treedef = jax.tree_util.tree_structure(state_template)
    with np.load(state_file) as data:
        leaves = [data[f"leaf_{i}"] for i in range(treedef.num_leaves)]
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    manifest = json.loads((path / "manifest.json").read_text())
    return state, manifest
