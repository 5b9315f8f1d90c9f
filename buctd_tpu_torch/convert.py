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
``load_state_dict(strict=True)``.  ``load_orbax_checkpoint`` reads a
directory that JAX's ``save_params`` wrote (train/checkpoint.py) through
``from_flax``, and ``load_checkpoint`` picks the reader by the path as JAX's
callers do.  ``load_pretrained_subset`` is the ImageNet warm start's subset
load (MODEL.PRETRAINED).
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


def load_orbax_checkpoint(path) -> dict:
    """The state_dict of an orbax directory of ``{params, batch_stats}``
    (JAX's ``save_params``, buctd_tpu/train/checkpoint.py:97).  Any other top
    level, such as the train state ``save_checkpoint`` writes (``step``,
    ``params``, ``batch_stats``, ``opt_state``, ``perf``), raises
    ``ValueError`` naming its keys, as JAX's ``load_params(path,
    template=variables)`` refuses it."""
    from .train.checkpoint import load_params

    tree = load_params(path)
    keys = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
    if keys != ["batch_stats", "params"]:
        raise ValueError(f"{path}: an orbax checkpoint of {{params, batch_stats}} loads "
                         f"(JAX's save_params); this one holds {keys}")
    return from_flax(tree)


def load_checkpoint(path) -> dict:
    """A checkpoint's state_dict: a ``.pth``/``.pt`` through
    ``load_torch_checkpoint``, anything else as an orbax directory through
    ``load_orbax_checkpoint`` (the test JAX's callers make, e.g.
    buctd_tpu/serving.py:66-74)."""
    path = str(path)
    if path.endswith((".pth", ".pt")):
        return load_torch_checkpoint(path)
    return load_orbax_checkpoint(path)


def load_pretrained_subset(model, state_dict: dict, pretrained_layers=("*",)) -> list:
    """ImageNet warm start (buctd_tpu/convert/torch2jax.py::load_pretrained_subset,
    the reference's init_weights, pose_hrnet.py:596-605): a key is loaded
    when its first dotted part is in ``pretrained_layers`` (or the list is
    ['*']) and the model has it at the same shape; every other parameter
    keeps its fresh init.  Returns the loaded keys."""
    allowed = set(pretrained_layers)
    own = model.state_dict()
    take = {k: v for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")
            and ("*" in allowed or k.split(".")[0] in allowed)
            and k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(take, strict=False)
    return sorted(take)
