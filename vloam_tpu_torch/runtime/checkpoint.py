"""Checkpoint / resume of an engine's device-resident state (port of
vloam_tpu/runtime/checkpoint.py).

A LoamState, or a VloamEngine's (VisionLoState, MapState) pair (map, feature
slabs, pose chain), is saved to an .npz and restored into a template of the
same structure. The keys are the reference's: NamedTuple field names joined
by "/", tuple entries by their index ("0/vision/prev_kp", "1/cube/center",
...), so a checkpoint written by either package loads in the other. The
reference has no checkpointing (its map lives only in RAM).
"""

from __future__ import annotations

import numpy as np
import torch

# Format history (the reference's): v1 (unversioned) used FeatureGrid.cnt
# and a single VloamState tree; v2 renamed cnt -> n_live and split the
# engine state into VisionLoState + MapState. v1 cannot be migrated.
CHECKPOINT_FORMAT_VERSION = 2


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Leaves of nested NamedTuples / tuples of tensors by path, in field
    order (the order of the reference's tree_flatten_with_path)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    names = getattr(tree, "_fields", None) or range(len(tree))
    out = {}
    for name, sub in zip(names, tree):
        out.update(_flatten(sub, f"{prefix}/{name}" if prefix else str(name)))
    return out


def _rebuild(template, leaves):
    if isinstance(template, torch.Tensor):
        return next(leaves)
    subs = [_rebuild(t, leaves) for t in template]
    return type(template)(*subs) if hasattr(template, "_fields") \
        else type(template)(subs)


def save_state(path: str, state) -> None:
    """Write `state` (one download of every leaf) as a compressed .npz."""
    arrays = {k: v.detach().cpu().numpy() for k, v in _flatten(state).items()}
    arrays["__format_version__"] = np.int32(CHECKPOINT_FORMAT_VERSION)
    np.savez_compressed(path, **arrays)


def load_state(path: str, template):
    """Restore into the structure of `template` (e.g. LoamState.create(cfg,
    device)): every leaf cast to the template leaf's dtype and placed on its
    device."""
    data = np.load(path)
    version = int(data["__format_version__"]) if "__format_version__" in data \
        else 1
    if version != CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path} has format v{version}, this build reads "
            f"v{CHECKPOINT_FORMAT_VERSION}; pre-round-4 checkpoints "
            "(FeatureGrid.cnt / unified VloamState) cannot be migrated — "
            "regenerate with --save-state")
    leaves = []
    for key, tmpl in _flatten(template).items():
        if key not in data:
            raise KeyError(f"checkpoint missing field {key}")
        arr = data[key]
        if arr.shape != tuple(tmpl.shape):
            raise ValueError(
                f"shape mismatch for {key}: {arr.shape} vs "
                f"{tuple(tmpl.shape)}")
        np_dtype = torch.empty(0, dtype=tmpl.dtype).numpy().dtype
        leaves.append(torch.from_numpy(arr.astype(np_dtype)).to(tmpl.device))
    return _rebuild(template, iter(leaves))
