"""PoseResNet (SimpleBaseline): a ResNet backbone, three deconvolutions and a
1x1 head, NCHW, with the BUCTD preNet input fusion.

Counterpart of buctd_tpu/models/resnet.py and the reference's
lib/models/pose_resnet.py:103-235, the preNet variant included (:113-115,
:160-171; its RGB stem is a 7x7 conv, HRNet's a 3x3).  The blocks are
models/hrnet.py's (``BasicBlock``, ``Bottleneck``, ``conv``, BatchNorm with
the flax running-variance update), and the module attributes follow the
reference's dotted paths (``layer1.0.conv1``, ``deconv_layers.0``,
``final_layer``), so a BUCTD checkpoint loads with ``strict=True`` and
``convert.from_flax`` fills the same keys.  ``Deconv`` is torch's
``ConvTranspose2d``: the JAX module reproduces it as a dilated conv and
stores its kernel (kh, kw, O, I), which the converter's 4-D rule turns into
torch's (I, O, kh, kw).  ``fused_prenet`` builds the eval-only
``FusedPreNet(first_kernel=7)``; make one with
models/fuse.py::maybe_fuse_prenet.

Under bf16 autocast the deconvolutions run in bf16 like every other conv.
JAX's bf16 model cannot run them: its ``Deconv`` (resnet.py:49 there) hands
``lax.conv_general_dilated`` a bf16 input with its f32 kernel and raises, so
the port takes the rounding that flax's own bf16 convs take, both operands
in bf16 (tests/test_torch_port_resnet.py).
"""

from __future__ import annotations

import dataclasses

import torch.nn.functional as F
from torch import nn

from .hrnet import BasicBlock, Bottleneck, FusedPreNet, PreNet, batch_norm, conv

RESNET_SPEC = {
    18: ("BASIC", (2, 2, 2, 2)),
    34: ("BASIC", (3, 4, 6, 3)),
    50: ("BOTTLENECK", (3, 4, 6, 3)),
    101: ("BOTTLENECK", (3, 4, 23, 3)),
    152: ("BOTTLENECK", (3, 8, 36, 3)),
}

_DECONV_CFG = {4: (1, 0), 3: (1, 1), 2: (0, 0)}  # kernel -> (padding, output_padding)


def Deconv(cin: int, features: int, kernel: int, use_bias: bool = False) -> nn.ConvTranspose2d:
    """torch's ConvTranspose2d(kernel, stride 2) with the reference's padding
    for the kernel (pose_resnet.py:202-215); the JAX ``Deconv`` :31."""
    padding, output_padding = _DECONV_CFG[kernel]
    return nn.ConvTranspose2d(cin, features, kernel, stride=2, padding=padding,
                              output_padding=output_padding, bias=use_bias)


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    num_joints: int
    block: str
    layers: tuple
    deconv_filters: tuple
    deconv_kernels: tuple
    deconv_with_bias: bool
    final_conv_kernel: int
    use_pre_net: bool

    @staticmethod
    def from_cfg(cfg) -> "ResNetSpec":
        extra = cfg.MODEL.EXTRA
        block, layers = RESNET_SPEC[int(extra["NUM_LAYERS"])]
        return ResNetSpec(
            num_joints=int(cfg.MODEL.NUM_JOINTS),
            block=block,
            layers=tuple(layers),
            deconv_filters=tuple(extra.get("NUM_DECONV_FILTERS", [256, 256, 256])),
            deconv_kernels=tuple(extra.get("NUM_DECONV_KERNELS", [4, 4, 4])),
            deconv_with_bias=bool(extra.get("DECONV_WITH_BIAS", False)),
            final_conv_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
            use_pre_net=bool(extra.get("USE_PRE_NET", False)),
        )


class ResNetPreNet(PreNet):
    """pose_resnet's preNet (pose_resnet.py:160-171): the RGB stem is
    conv7x7(3->64)+BN then conv7x7(64->3)+BN, the condition stem
    conv7x7(3->3)+BN; summed.  The JAX ``ResNetPreNet`` :87."""

    def __init__(self):
        super().__init__()
        self.rgb_preNet[0] = conv(3, 64, 7, bias=True)


class PoseResNet(nn.Module):
    """(B, C, H, W) -> (B, num_joints, H/4, W/4) heatmaps (the JAX
    ``PoseResNet`` :104).  With ``spec.use_pre_net`` the input is RGB + a
    3-channel condition (channels :3 and 3:6), fused by the preNet stems
    whose parameters sit at the top level (``rgb_preNet.*``,
    ``cond_preNet.*``); without it the stem takes the ``in_channels`` of the
    input as they are."""

    def __init__(self, spec: ResNetSpec, in_channels: int = 3, fused_prenet: bool = False):
        super().__init__()
        self.spec = spec
        self.in_channels = in_channels
        self.fused_prenet = bool(fused_prenet and spec.use_pre_net)
        if self.fused_prenet:
            self.prenet_fused = FusedPreNet(first_kernel=7)
        elif spec.use_pre_net:
            stems = ResNetPreNet()
            self.rgb_preNet, self.cond_preNet = stems.rgb_preNet, stems.cond_preNet
        self.conv1 = conv(3 if spec.use_pre_net else in_channels, 64, 7, 2)
        self.bn1 = batch_norm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        block = BasicBlock if spec.block == "BASIC" else Bottleneck
        cin = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), spec.layers)):
            stride = 1 if li == 0 else 2
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                blocks.append(block(cin, planes, s, has_downsample=(
                    b == 0 and (s != 1 or cin != planes * block.expansion))))
                cin = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        deconvs = []
        for f, k in zip(spec.deconv_filters, spec.deconv_kernels):
            deconvs += [Deconv(cin, f, k, spec.deconv_with_bias), batch_norm(f), nn.ReLU()]
            cin = f
        self.deconv_layers = nn.Sequential(*deconvs)
        k = spec.final_conv_kernel
        self.final_layer = conv(cin, spec.num_joints, k, pad=k // 2, bias=True)

    def forward(self, x):
        if self.spec.use_pre_net:
            if x.shape[1] < 6:
                raise ValueError(f"preNet needs RGB + a 3-channel condition, got "
                                 f"{x.shape[1]} channels")
            if self.fused_prenet:
                if self.training:
                    raise RuntimeError("the fused preNet is an eval-only transform")
                x = self.prenet_fused(x[:, :3], x[:, 3:6])
            else:
                x = self.rgb_preNet(x[:, :3]) + self.cond_preNet(x[:, 3:6])
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.final_layer(self.deconv_layers(x))


def get_pose_net(cfg, engine: str = "auto") -> PoseResNet:
    """pose_resnet for ``cfg`` (the JAX ``get_pose_net`` :154); ``engine``
    (the attention engine) is unused: the model has no attention."""
    from ..data.pipeline import num_input_channels

    del engine
    return PoseResNet(ResNetSpec.from_cfg(cfg), in_channels=num_input_channels(cfg))
