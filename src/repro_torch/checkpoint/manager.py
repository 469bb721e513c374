"""Checkpointing: atomic, retention-managed save/restore of params,
optimizer state, data-pipeline position, and gear plans (port of
``repro/checkpoint/manager.py``, in the same on-disk format, so either
package restores what the other saved).

Layout (one directory per step):
    <root>/step_000123/
        arrays.npz        flattened pytree leaves (params + opt state)
        meta.json         treedef string, step, timestamp, extra metadata
        gear_plan.json    (serving checkpoints)
    <root>/LATEST          text file with the newest complete step dir

Leaves are stored as ``leaf_{i}`` in ``jax.tree_util``'s flatten order
(``repro_torch.tree``: dict keys sorted, lists and tuples in order,
``None`` no leaf); a bfloat16 leaf is stored as its uint16 bits with
``"bfloat16"`` in ``meta["dtypes"]``. ``meta["treedef"]`` is this
package's own description of the structure; neither package's
``restore`` reads it (the template gives the structure). Writes go to a
temp dir + atomic rename, so a crash mid-save never corrupts the latest
checkpoint; a restart picks up LATEST.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

__all__ = ["CheckpointManager"]


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name) for one leaf: a tensor's bits on the
    host (bf16 as uint16), or a numpy array or scalar as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V" or "bfloat16" in name:
        arr = arr.view(np.uint16)   # npz can't round-trip bf16
    return arr, name


def _restored(arr: np.ndarray, dtype: str, like) -> Any:
    """A stored array back as a leaf like the template's: a tensor on the
    template leaf's device, else a numpy array (bf16 as its bits in a
    tensor: ``ml_dtypes`` is not needed)."""
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    if "bfloat16" in dtype:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return t if "bfloat16" in dtype else t.numpy()


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             gear_plan_json: Optional[str] = None) -> str:
        name = f"step_{step:09d}"
        final = os.path.join(self.root, name)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves, treedef = tree_lib.flatten(tree)
        arrays, dtypes = {}, []
        for i, leaf in enumerate(leaves):
            arr, dtype = _host_array(leaf)
            dtypes.append(dtype)
            arrays[f"leaf_{i}"] = arr
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {
            "step": step,
            "time": time.time(),
            "n_leaves": len(leaves),
            "dtypes": dtypes,
            "treedef": tree_lib.describe(treedef),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if gear_plan_json is not None:
            with open(os.path.join(tmp, "gear_plan.json"), "w") as f:
                f.write(gear_plan_json)
        os.replace(tmp, final)  # atomic publish
        self._update_latest(name)
        self._enforce_retention()
        return final

    def _update_latest(self, name: str) -> None:
        tmp = os.path.join(self.root, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(name)
        os.replace(tmp, os.path.join(self.root, "LATEST"))

    def _enforce_retention(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.root, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                name = f.read().strip()
            if os.path.isdir(os.path.join(self.root, name)):
                return int(name[5:])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``template``: each tensor leaf
        comes back as a tensor on that leaf's device (the stored dtype
        kept), any other leaf as a numpy array."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        leaves, treedef = tree_lib.flatten(template)
        if meta["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, "
                             f"template {len(leaves)}")
        dtypes = meta.get("dtypes", [])
        loaded = []
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for i, like in enumerate(leaves):
                dtype = dtypes[i] if i < len(dtypes) else ""
                loaded.append(_restored(data[f"leaf_{i}"], dtype, like))
        return tree_lib.unflatten(treedef, loaded), meta

    def restore_gear_plan(self, step: Optional[int] = None) -> Optional[str]:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.root, f"step_{step:09d}", "gear_plan.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()
