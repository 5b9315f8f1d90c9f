"""Model registry, keyed by the reference's MODEL.NAME values.

Counterpart of buctd_tpu/models/__init__.py.  Only ``pose_hrnet_coam`` is
ported so far; the other names raise and name their ROADMAP item.  The
attention engine is ``cfg.TPU.ATTENTION_ENGINE``, passed to the constructors.
"""

from __future__ import annotations

import torch

from . import hrnet_coam

_REGISTRY = {"pose_hrnet_coam": hrnet_coam.get_pose_net}

_NOT_PORTED = {
    "pose_hrnet": "ROADMAP Queue 1, 'preNet-W48 + models/fuse.py'",
    "transpose_h": "ROADMAP Queue 1, 'TransPose-H on K1 at d=112'",
    "pose_resnet": "ROADMAP Queue 1, 'preNet-W48 + models/fuse.py' (ResNet follows it)",
}


def get_model(cfg, device=None) -> torch.nn.Module:
    """The cfg's model with the reference's init (N(0, 0.001) weights), in eval
    mode, on ``device``."""
    from .hrnet import init_weights

    name = cfg.MODEL.NAME
    if name in _NOT_PORTED:
        raise NotImplementedError(f"MODEL.NAME {name!r} is not ported to "
                                  f"buctd_tpu_torch yet: {_NOT_PORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown MODEL.NAME {name!r}; known: "
                       f"{sorted(_REGISTRY) + sorted(_NOT_PORTED)}")
    model = _REGISTRY[name](cfg, engine=str(cfg.TPU.ATTENTION_ENGINE))
    init_weights(model)
    if device is not None:
        model = model.to(device)
    return model.eval()


def compute_dtype(cfg, key: str = "COMPUTE_DTYPE") -> torch.dtype:
    """cfg.TPU.<key> -> torch dtype."""
    name = str(getattr(cfg.TPU, key, "float32")).lower()
    dtypes = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
              "float32": torch.float32, "f32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"TPU.{key}={name!r}: expected float32 or bfloat16")
    return dtypes[name]


__all__ = ["get_model", "compute_dtype"]
