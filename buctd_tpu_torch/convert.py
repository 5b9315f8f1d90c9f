"""Weights across the two packages, and BUCTD checkpoint loading.

``from_flax`` turns a JAX variable tree of buctd_tpu (nested dicts of numpy
arrays, ``{"params": ..., "batch_stats": ...}``) into this package's
``state_dict``; it inverts buctd_tpu/convert/torch2jax.py::_torch_key and
``_convert_tensor``: path parts that start with "_" are wrapper levels and are
dropped, conv kernels go HWIO -> OIHW, linear kernels (in, out) -> (out, in),
BN scale -> weight, mean/var -> running_mean/running_var.  One wrapper level
is kept: ``_prenet_fused`` (the eval-only fused preNet of
buctd_tpu/models/fuse.py) becomes the port's ``prenet_fused`` module; the
reference has no such module.  TransPose's packed projection
``self_attn.in_proj.{kernel,bias}`` becomes the reference's
``self_attn.in_proj_{weight,bias}`` (buctd_tpu/models/transpose.py::
transpose_key_map), and a learnable ``pos_embedding`` keeps its (L, 1, d)
layout; the sine table, which the JAX tree lacks, is supplied by the model
when the state_dict loads (models/transpose.py::TransPoseH).  Since the port's
module names are the reference's, a BUCTD ``.pth`` loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF_FROM_FLAX = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}

# wrapper levels of the JAX tree that name a module of the port
_KEPT = {"_prenet_fused": "prenet_fused"}
# torch keys that the joined JAX path does not give as they are
_RENAMED = {"self_attn.in_proj.weight": "self_attn.in_proj_weight",
            "self_attn.in_proj.bias": "self_attn.in_proj_bias"}


def _leaves(tree, path=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _leaves(value, path + (str(key),))
        else:
            yield path + (str(key),), value


def from_flax(variables) -> dict:
    """JAX variable tree (nested mappings of arrays) -> torch state_dict.

    Every BatchNorm also gets its ``num_batches_tracked`` buffer (0), which the
    JAX tree has no counterpart for, so ``load_state_dict(strict=True)`` works.
    """
    sd = {}
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            *parts, leaf = path
            arr = np.asarray(value)
            if (collection, leaf) == ("params", "pos_embedding"):
                sd[leaf] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
                continue
            torch_leaf = _LEAF_FROM_FLAX[(collection, leaf)]
            parts = [_KEPT.get(p, p) for p in parts]
            key = ".".join([p for p in parts if not p.startswith("_")] + [torch_leaf])
            for old, new in _RENAMED.items():
                key = key.replace(old, new)
            if arr.ndim == 4:                       # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:                     # (in, out) -> (out, in)
                arr = arr.T
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
            if torch_leaf == "running_mean":
                sd[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def load_torch_checkpoint(path: str) -> dict:
    """Load a .pth file; prefers 'latest_state_dict' like tools/test.py:120-125,
    falling back to 'best_state_dict'/'state_dict' or the raw dict, and strips
    DataParallel 'module.' prefixes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("latest_state_dict", "best_state_dict", "state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    return {k[7:] if k.startswith("module.") else k: v for k, v in ckpt.items()}
