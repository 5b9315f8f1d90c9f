"""HRNet trunk (W32/W48), NCHW, eval-focused.

Counterpart of buctd_tpu/models/hrnet.py and the reference's
lib/models/pose_hrnet.py:274-495: stem -> 4-Bottleneck layer1 -> three
multi-resolution stages with cross-resolution fusion.  Module attributes follow
the reference's dotted paths ("layer1.0.conv1", "transition1.1.0.0",
"stage2.0.fuse_layers.1.0.0.0", ...), so a BUCTD checkpoint loads with
``load_state_dict(strict=True)`` and ``convert.from_flax`` fills the same keys
from the JAX variables.  Rematerialization is training-only and not ported.
"""

from __future__ import annotations

import dataclasses

import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def conv(cin: int, cout: int, kernel: int, stride: int = 1, pad=None,
         bias: bool = False) -> nn.Conv2d:
    if pad is None:
        pad = (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad, bias=bias)


def batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class BasicBlock(nn.Module):
    """conv3x3-bn-relu-conv3x3-bn + residual (pose_hrnet.py:28-57)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = batch_norm(planes)
        self.downsample = (nn.Sequential(conv(inplanes, planes, 1, stride),
                                         batch_norm(planes))
                           if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 with 4x expansion (pose_hrnet.py:60-98)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv(planes, cout, 1)
        self.bn3 = batch_norm(cout)
        self.downsample = (nn.Sequential(conv(inplanes, cout, 1, stride),
                                         batch_norm(cout))
                           if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


@dataclasses.dataclass(frozen=True)
class StageSpec:
    num_modules: int
    num_branches: int
    block: str
    num_blocks: tuple
    num_channels: tuple

    @staticmethod
    def from_cfg(d) -> "StageSpec":
        return StageSpec(
            num_modules=int(d["NUM_MODULES"]),
            num_branches=int(d["NUM_BRANCHES"]),
            block=str(d["BLOCK"]),
            num_blocks=tuple(d["NUM_BLOCKS"]),
            num_channels=tuple(d["NUM_CHANNELS"]),
        )

    @property
    def out_channels(self) -> tuple:
        exp = BLOCKS[self.block].expansion
        return tuple(c * exp for c in self.num_channels)


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch block stacks + full cross-resolution
    fuse (pose_hrnet.py:101-265)."""

    def __init__(self, spec: StageSpec, in_channels: tuple,
                 multi_scale_output: bool = True):
        super().__init__()
        block = BLOCKS[spec.block]
        nb = spec.num_branches
        branches = []
        for i in range(nb):
            cin, cout = in_channels[i], spec.num_channels[i] * block.expansion
            blocks = []
            for k in range(spec.num_blocks[i]):
                blocks.append(block(cin if k == 0 else cout, spec.num_channels[i],
                                    has_downsample=(k == 0 and cin != cout)))
            branches.append(nn.Sequential(*blocks))
        self.branches = nn.ModuleList(branches)

        self.fuse_layers = None
        if nb > 1:
            chans = spec.out_channels
            fuse = []
            for i in range(nb if multi_scale_output else 1):
                row = []
                for j in range(nb):
                    if j == i:
                        row.append(None)
                    elif j > i:   # 1x1 conv, BN, nearest 2^(j-i) upsample (pixel repeat)
                        row.append(nn.Sequential(conv(chans[j], chans[i], 1),
                                                 batch_norm(chans[i]),
                                                 nn.Upsample(scale_factor=2 ** (j - i),
                                                             mode="nearest")))
                    else:   # j < i: chain of stride-2 3x3s
                        steps = []
                        for k in range(i - j):
                            last = k == i - j - 1
                            co = chans[i] if last else chans[j]
                            layers = [conv(chans[j], co, 3, 2), batch_norm(co)]
                            if not last:
                                layers.append(nn.ReLU())
                            steps.append(nn.Sequential(*layers))
                        row.append(nn.Sequential(*steps))
                fuse.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return outs
        fused = []
        for row in self.fuse_layers:
            y = None
            for j, layer in enumerate(row):
                t = outs[j] if layer is None else layer(outs[j])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


def _transition(pre: tuple, cur: tuple) -> nn.ModuleList:
    """Between-stage transition layers (pose_hrnet.py:338-377): None passes a
    branch through; a new branch is made from the LAST previous branch."""
    n_pre = len(pre)
    layers = []
    for i, c in enumerate(cur):
        if i < n_pre:
            layers.append(None if c == pre[i] else nn.Sequential(
                conv(pre[i], c, 3, 1), batch_norm(c), nn.ReLU()))
        else:
            steps = []
            for j in range(i + 1 - n_pre):
                co = c if j == i - n_pre else pre[-1]
                steps.append(nn.Sequential(conv(pre[-1], co, 3, 2), batch_norm(co),
                                           nn.ReLU()))
            layers.append(nn.Sequential(*steps))
    return nn.ModuleList(layers)


def _apply_transition(layers: nn.ModuleList, ys: list) -> list:
    # a present layer consumes the LAST previous branch (pose_hrnet.py:469-491)
    return [ys[i] if layer is None else layer(ys[-1]) for i, layer in enumerate(layers)]


@dataclasses.dataclass(frozen=True)
class HRNetSpec:
    num_joints: int
    stage2: StageSpec
    stage3: StageSpec
    stage4: StageSpec
    final_conv_kernel: int = 1

    @staticmethod
    def from_cfg(cfg) -> "HRNetSpec":
        extra = cfg.MODEL.EXTRA
        return HRNetSpec(
            num_joints=int(cfg.MODEL.NUM_JOINTS),
            stage2=StageSpec.from_cfg(extra["STAGE2"]),
            stage3=StageSpec.from_cfg(extra["STAGE3"]),
            stage4=StageSpec.from_cfg(extra["STAGE4"]),
            final_conv_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
        )

    @property
    def stages(self) -> tuple:
        return (self.stage2, self.stage3, self.stage4)


class HRNetTrunk(nn.Module):
    """Stem + layer1 + stages 2-4, NCHW.  Shared by pose_hrnet and
    pose_hrnet_coam, which subclass it so the trunk's parameters keep the
    reference's top-level names.

    ``forward(x, taps, tap_arg)``: ``taps`` holds up to four hooks
    ``f(list_of_branch_tensors, tap_arg) -> list``, applied right after
    transitions 1-3 and after stage4 (pose_hrnet_coam.py:521-563).
    """

    def __init__(self, spec: HRNetSpec, in_channels: int = 3):
        super().__init__()
        self.spec = spec
        self.conv1 = conv(in_channels, 64, 3, 2)
        self.bn1 = batch_norm(64)
        self.conv2 = conv(64, 64, 3, 2)
        self.bn2 = batch_norm(64)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if k == 0 else 256, 64,
                                                 has_downsample=(k == 0))
                                      for k in range(4)])
        pre = (256,)
        for si, stage in enumerate(spec.stages):
            cur = stage.out_channels
            setattr(self, f"transition{si + 1}", _transition(pre, cur))
            last = si == 2
            setattr(self, f"stage{si + 2}", nn.Sequential(*[
                HRModule(stage, cur,
                         multi_scale_output=not (last and m == stage.num_modules - 1))
                for m in range(stage.num_modules)]))
            pre = cur

    def forward(self, x, taps=(None, None, None, None), tap_arg=None) -> list:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        ys = [self.layer1(x)]
        for si in range(3):
            ys = _apply_transition(getattr(self, f"transition{si + 1}"), ys)
            if taps[si] is not None:
                ys = taps[si](ys, tap_arg)
            ys = getattr(self, f"stage{si + 2}")(ys)
        if taps[3] is not None:
            ys = taps[3](ys, tap_arg)
        return ys


def branch_sizes(image_hw, n_branches: int = 4) -> list:
    """(H, W) of each resolution branch for an input of ``image_hw``: the stem's
    two stride-2 3x3 convs, then one more per branch (ceil division)."""
    h, w = int(image_hw[0]), int(image_hw[1])
    h, w = -(-h // 4), -(-w // 4)
    sizes = []
    for _ in range(n_branches):
        sizes.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return sizes


def init_weights(model: nn.Module) -> None:
    """The reference's init (pose_hrnet.py:578-590): conv and linear weights
    N(0, 0.001), biases 0, BN weight 1 and bias 0."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            nn.init.normal_(mod.weight, std=0.001)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.BatchNorm2d):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
