"""Eval-time exact fusion of the BUCTD preNet stems, and BatchNorm folding.

Counterpart of buctd_tpu/models/fuse.py.  At eval every PreNet op is linear:
conv -> BN(affine) -> conv -> BN, plus a parallel conv -> BN on the condition,
summed (reference pose_hrnet.py:431-458, pose_resnet.py:160-171, no
activations inside the stems).  So:

  * each BatchNorm folds into the preceding conv:  BN(conv(x, K) + c)
    == conv(x, K * a) + (c * a + b)  with  a = scale / sqrt(var + eps),
    b = bias - a * mean;
  * the two parallel 7x7 convs (rgb-path 64->3 and cond-path 3->3, same
    stride and padding) merge into one 7x7 conv over 67 concatenated
    channels: conv(u, Ku) + conv(v, Kv) == conv(concat(u, v), concat(Ku, Kv)).

Both preNet layouts fold the same way under the same key names: HRNet's
(3x3 first RGB conv) into ``FusedPreNet(first_kernel=3)``, pose_resnet's
(7x7) into ``FusedPreNet(first_kernel=7)``.

The affine is computed in float64 on the host, once, and cast to f32, as in
JAX.  ``TPU.FUSED_PRENET`` keeps the JAX default "off"; "auto" (or any value
but off/false/0/none) fuses after the checkpoint load.  Training and the
converters always see the canonical PreNet state_dict.  ``fold_bn`` is the
BN-into-conv fold on its own, for any conv + BatchNorm2d pair (the fused
basic block, ops/fused_block.py, takes folded weights).
"""

from __future__ import annotations

import numpy as np
import torch

from .hrnet import BN_EPS, PoseHRNet
from .resnet import PoseResNet

_RGB, _COND, _FUSED = "rgb_preNet", "cond_preNet", "prenet_fused"


def _np64(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _bn_affine(sd: dict, bn: str, eps: float = BN_EPS):
    """BN ``bn`` of a state_dict at eval is y = a * x + b per channel."""
    a = _np64(sd[f"{bn}.weight"]) / np.sqrt(_np64(sd[f"{bn}.running_var"]) + eps)
    b = _np64(sd[f"{bn}.bias"]) - a * _np64(sd[f"{bn}.running_mean"])
    return a, b


def _fold(sd: dict, conv: str, bn: str, eps: float = BN_EPS):
    """Fold BN ``bn`` into conv ``conv`` of a state_dict: float64 (weight
    OIHW, bias); the affine broadcasts over the output-channel axis 0."""
    a, b = _bn_affine(sd, bn, eps)
    weight = _np64(sd[f"{conv}.weight"]) * a[:, None, None, None]
    bias = sd.get(f"{conv}.bias")
    bias = (np.zeros_like(a) if bias is None else _np64(bias)) * a + b
    return weight, bias


def fold_bn(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d):
    """(weight, bias) of the conv that computes ``bn(conv(x))`` at eval: f32
    tensors on the conv's device, weight OIHW, the fold in float64."""
    sd = {"c.weight": conv.weight, "b.weight": bn.weight, "b.bias": bn.bias,
          "b.running_mean": bn.running_mean, "b.running_var": bn.running_var}
    if conv.bias is not None:
        sd["c.bias"] = conv.bias
    weight, bias = _fold(sd, "c", "b", bn.eps)
    dev = conv.weight.device
    return (torch.from_numpy(weight.astype(np.float32)).to(dev),
            torch.from_numpy(bias.astype(np.float32)).to(dev))


def fuse_prenet_variables(state_dict: dict) -> dict:
    """A PoseHRNet or PoseResNet state_dict with the canonical stems (``rgb_preNet.*``,
    ``cond_preNet.*``) -> the same with ``prenet_fused.{a,b}`` in their place."""
    sd = dict(state_dict)
    ka, ca = _fold(sd, f"{_RGB}.0", f"{_RGB}.1")
    k2, c2 = _fold(sd, f"{_RGB}.2", f"{_RGB}.3")
    kc, cc = _fold(sd, f"{_COND}.0", f"{_COND}.1")
    kb = np.concatenate([k2, kc], axis=1)     # (3,64,7,7)+(3,3,7,7) -> (3,67,7,7)
    cb = c2 + cc
    for key in [k for k in sd if k.startswith((f"{_RGB}.", f"{_COND}."))]:
        del sd[key]
    for name, arr in ((f"{_FUSED}.a.weight", ka), (f"{_FUSED}.a.bias", ca),
                      (f"{_FUSED}.b.weight", kb), (f"{_FUSED}.b.bias", cb)):
        sd[name] = torch.from_numpy(arr.astype(np.float32))
    return sd


def maybe_fuse_prenet(cfg, model):
    """``model`` with its preNet fused when TPU.FUSED_PRENET allows and the
    model carries an unfused preNet; ``model`` itself otherwise (so it is
    idempotent).  Call after the checkpoint load.  The fused model is a new
    module on the same device, in eval mode."""
    knob = str(getattr(cfg.TPU, "FUSED_PRENET", "auto")).lower()
    if knob in ("off", "false", "0", "none"):
        return model
    if not isinstance(model, (PoseHRNet, PoseResNet)) or not model.spec.use_pre_net:
        return model
    if model.fused_prenet:
        return model
    device = next(model.parameters()).device
    if isinstance(model, PoseHRNet):
        fused = PoseHRNet(model.spec, in_channels=model.in_channels, fused_prenet=True,
                          lambda_head=model.lambda_head)
    else:
        fused = PoseResNet(model.spec, in_channels=model.in_channels, fused_prenet=True)
    fused.load_state_dict(fuse_prenet_variables(model.state_dict()), strict=True)
    return fused.to(device).eval()
