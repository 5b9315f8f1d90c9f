"""HRNet trunk (W32/W48) and pose_hrnet / BUCTD-preNet, NCHW.

Counterpart of buctd_tpu/models/hrnet.py and the reference's
lib/models/pose_hrnet.py:274-495: stem -> 4-Bottleneck layer1 -> three
multi-resolution stages with cross-resolution fusion, and ``PoseHRNet`` with
the preNet input-fusion stems (:431-458) and their eval-time fused form
(models/fuse.py).  Module attributes follow
the reference's dotted paths ("layer1.0.conv1", "transition1.1.0.0",
"stage2.0.fuse_layers.1.0.0.0", ...), so a BUCTD checkpoint loads with
``load_state_dict(strict=True)`` and ``convert.from_flax`` fills the same keys
from the JAX variables.  BatchNorm updates its running variance as flax does
(``BatchNorm2d``).  In training, ``remat`` (models/remat.py, TPU.REMAT_MODE)
checkpoints the JAX package's units: the stem + layer1, the HRModules, the
residual blocks, the preNet stems.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .remat import checkpoint, recomputing

BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """torch's Conv2d, with the bias added where flax adds it under bf16.

    flax's ``nn.Conv(dtype=bfloat16)`` (buctd_tpu's bf16 models) rounds the
    product to bf16 and then adds the bf16 bias: two roundings.  Under
    autocast, torch's conv takes the bias inside the product and rounds once,
    and a one-step difference in the CoAM convs' outputs moves the sharp
    attention that follows by many steps.  So under autocast this adds the
    bias after the product, in the product's dtype; without autocast (f32) it
    is torch's module unchanged."""

    def forward(self, x):
        if self.bias is None or not torch.is_autocast_enabled(x.device.type):
            return super().forward(x)
        y = self._conv_forward(x, self.weight, None)
        return y + self.bias.to(y.dtype)[:, None, None]


class Linear(nn.Linear):
    """torch's Linear, with the bias added where flax's ``nn.Dense`` adds it
    under bf16 (as ``Conv2d``): after the product, in its dtype, under
    autocast; torch's module unchanged without it."""

    def forward(self, x):
        if self.bias is None or not torch.is_autocast_enabled(x.device.type):
            return super().forward(x)
        y = F.linear(x, self.weight)
        return y + self.bias.to(y.dtype)


class Upsample(nn.Upsample):
    """torch's nearest Upsample, run in its input's dtype.  On CUDA, autocast
    runs ``upsample_nearest2d`` in f32, so a bf16 branch came back f32 and
    the fuse sums that follow ran unrounded; JAX's bf16 HRModule (and
    torch's CPU autocast) keeps bf16 there.  The pixel repeat is exact in
    any dtype, so autocast is simply turned off for it."""

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x)


def conv(cin: int, cout: int, kernel: int, stride: int = 1, pad=None,
         bias: bool = False) -> nn.Conv2d:
    if pad is None:
        pad = (kernel - 1) // 2
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad, bias=bias)


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d with the flax running-variance update.

    In training, torch moves ``running_var`` toward the UNBIASED batch
    variance; flax (buctd_tpu/models/hrnet.py:25, momentum 0.9 == torch 0.1)
    moves it toward the BIASED one.  With c = (n - 1) / n, n = B*H*W, torch's
    update of a copy holding var / c, times c, is
    (1 - m) var + m c var_unbiased = (1 - m) var + m var_biased, flax's
    update, while the normalization still runs in torch's own kernel.  The
    recompute of a rematerialized unit runs the same op on copies of the
    statistics: its forward already moved them.
    """

    def forward(self, x):
        n = x.numel() // x.shape[1]
        if not (self.training and self.track_running_stats) or n < 2:
            return super().forward(x)
        c = (n - 1) / n
        var = self.running_var / c            # torch updates this copy in place
        if recomputing():                     # the same op, on copies
            return F.batch_norm(x, self.running_mean.clone(), var, self.weight, self.bias,
                                True, self.momentum, self.eps)
        self.num_batches_tracked.add_(1)
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True,
                           self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(var * c)
        return out


def batch_norm(c: int) -> nn.BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS)


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
                                                 Upsample(scale_factor=2 ** (j - i),
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

    def forward(self, xs, remat_blocks: bool = False):
        outs = [run_blocks(branch, x, remat_blocks) for branch, x in zip(self.branches, xs)]
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


def run_blocks(blocks: nn.Sequential, x, remat: bool = False):
    """A stack of residual blocks, each one rematerialized unit with ``remat``
    (without it the Sequential itself runs, so its hooks see the call)."""
    if not remat:
        return blocks(x)
    for block in blocks:
        x = checkpoint(block, x)
    return x


def run_stage(stage: nn.Sequential, ys: list, mode: str = "") -> list:
    """A stage's HRModules on the branch tensors ``ys``: each module one
    rematerialized unit in mode 'modules', each block one in 'blocks'."""
    if mode not in ("modules", "blocks"):
        return stage(ys)
    for module in stage:
        if mode == "modules":
            ys = list(checkpoint(lambda *xs, m=module: m(list(xs)), *ys))
        else:
            ys = module(ys, remat_blocks=True)
    return ys


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
    use_pre_net: bool = False

    @staticmethod
    def from_cfg(cfg) -> "HRNetSpec":
        extra = cfg.MODEL.EXTRA
        return HRNetSpec(
            num_joints=int(cfg.MODEL.NUM_JOINTS),
            stage2=StageSpec.from_cfg(extra["STAGE2"]),
            stage3=StageSpec.from_cfg(extra["STAGE3"]),
            stage4=StageSpec.from_cfg(extra["STAGE4"]),
            final_conv_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
            use_pre_net=bool(extra.get("USE_PRE_NET", False)),
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
    transitions 1-3 and after stage4 (pose_hrnet_coam.py:521-563).  They
    stay outside the rematerialized units, as in JAX.  ``remat`` is the
    TPU.REMAT_MODE of training ('' off; models/remat.py), which
    models/__init__.py::get_model sets.
    """

    def __init__(self, spec: HRNetSpec, in_channels: int = 3):
        super().__init__()
        self.spec = spec
        self.remat = ""
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

    def _stem_layer1(self, x, remat_blocks: bool = False):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return run_blocks(self.layer1, x, remat_blocks)

    def forward(self, x, taps=(None, None, None, None), tap_arg=None) -> list:
        mode = self.remat if self.training else ""
        if mode in ("modules", "stem"):
            ys = [checkpoint(self._stem_layer1, x)]
        else:
            ys = [self._stem_layer1(x, remat_blocks=mode == "blocks")]
        for si in range(3):
            ys = _apply_transition(getattr(self, f"transition{si + 1}"), ys)
            if taps[si] is not None:
                ys = taps[si](ys, tap_arg)
            ys = run_stage(getattr(self, f"stage{si + 2}"), ys, mode)
        if taps[3] is not None:
            ys = taps[3](ys, tap_arg)
        return ys


class PreNet(nn.Module):
    """BUCTD-preNet input fusion stems (pose_hrnet.py:431-442): the RGB stem is
    conv3x3(3->64)+BN then conv7x7(64->3)+BN; the condition stem is
    conv7x7(3->3)+BN.  Outputs are summed (pose_hrnet.py:456-458).  The convs
    carry biases (torch's default)."""

    def __init__(self):
        super().__init__()
        self.rgb_preNet = nn.Sequential(conv(3, 64, 3, bias=True), batch_norm(64),
                                        conv(64, 3, 7, bias=True), batch_norm(3))
        self.cond_preNet = nn.Sequential(conv(3, 3, 7, bias=True), batch_norm(3))

    def forward(self, rgb, cond):
        return self.rgb_preNet(rgb) + self.cond_preNet(cond)


class FusedPreNet(nn.Module):
    """Eval-only exact refactoring of PreNet (buctd_tpu/models/hrnet.py:380):
    the three BNs fold into the convs and the two parallel 7x7 convs merge
    into one over the 64 + 3 concatenated channels.  Its weights are made
    from a PreNet's by models/fuse.py, never trained."""

    def __init__(self, first_kernel: int = 3):
        super().__init__()
        self.a = conv(3, 64, first_kernel, bias=True)
        self.b = conv(67, 3, 7, bias=True)

    def forward(self, rgb, cond):
        h = self.a(rgb)
        return self.b(torch.cat([h, cond.to(h.dtype)], dim=1))


class PoseHRNet(HRNetTrunk):
    """pose_hrnet and BUCTD-preNet (buctd_tpu/models/hrnet.py:400), NCHW:
    (B, C, H, W) -> (B, num_joints, H/4, W/4) heatmaps.

    With ``spec.use_pre_net`` the input is RGB + a 3-channel condition
    (channels :3 and 3:6), fused by the preNet stems into the 3 channels the
    trunk takes; the stems' parameters sit at the top level under the
    reference's names (``rgb_preNet.0`` ... ``cond_preNet.1``), so a BUCTD
    checkpoint loads with ``strict=True``.  Without it the trunk takes the
    ``in_channels`` of the input as they are.  ``fused_prenet`` builds the
    eval-only FusedPreNet (``prenet_fused``) in the stems' place; make one with
    models/fuse.py::maybe_fuse_prenet, never directly.  ``lambda_head`` builds
    the lambda-conditioned FiLM head (``lambda_fc``, ``lambda_mu``,
    ``lambda_sigma``) that ``forward(x, lambda_vec=...)`` needs.
    """

    def __init__(self, spec: HRNetSpec, in_channels: int = 3, fused_prenet: bool = False,
                 lambda_head: bool = False):
        super().__init__(spec, in_channels=3 if spec.use_pre_net else in_channels)
        self.in_channels = in_channels
        self.fused_prenet = bool(fused_prenet and spec.use_pre_net)
        self.lambda_head = lambda_head
        if self.fused_prenet:
            self.prenet_fused = FusedPreNet(first_kernel=3)
        elif spec.use_pre_net:
            stems = PreNet()
            self.rgb_preNet, self.cond_preNet = stems.rgb_preNet, stems.cond_preNet
        c = spec.stage4.num_channels[0]
        if lambda_head:
            # the MIPNet-heritage lambda head: the last layers start at zero
            # (flax zeros kernel_init), so an untrained head is near-identity
            self.lambda_fc = nn.Linear(2, c)
            self.lambda_mu = nn.Linear(c, c)
            self.lambda_sigma = nn.Linear(c, c)
            self.lambda_mu.zero_init = self.lambda_sigma.zero_init = True
        k = spec.final_conv_kernel
        self.final_layer = conv(c, spec.num_joints, k, pad=k // 2, bias=True)

    def _prenet(self, rgb, cond):
        return self.rgb_preNet(rgb) + self.cond_preNet(cond)

    def forward(self, x, film=None, lambda_vec=None, return_features: bool = False):
        """``film=(mu, sigma)`` (B, C) modulates the final features as
        mu + y * sigma (forward_lamda, pose_hrnet.py:497-540);
        ``lambda_vec`` (B, 2) makes (mu, sigma) through the lambda head;
        ``return_features`` returns the pre-head trunk features
        (forward_feature, :542-576)."""
        if self.spec.use_pre_net:
            if x.shape[1] < 6:
                raise ValueError(f"preNet needs RGB + a 3-channel condition, got "
                                 f"{x.shape[1]} channels")
            if self.fused_prenet:
                if self.training:
                    raise RuntimeError("the fused preNet is an eval-only transform")
                x = self.prenet_fused(x[:, :3], x[:, 3:6])
            elif self.training and self.remat:
                x = checkpoint(self._prenet, x[:, :3], x[:, 3:6])
            else:
                x = self._prenet(x[:, :3], x[:, 3:6])
        feats = super().forward(x)[0]
        if return_features:
            return feats
        if lambda_vec is not None:
            if film is not None:
                raise ValueError("pass film or lambda_vec, not both")
            if not self.lambda_head:
                raise ValueError("lambda_vec needs the model built with lambda_head=True")
            # the head runs in f32 under autocast too: JAX's lambda Dense
            # layers are built without the model's dtype (hrnet.py:448-452)
            with torch.autocast(x.device.type, enabled=False):
                emb = F.relu(self.lambda_fc(lambda_vec.float()))
                film = (self.lambda_mu(emb), 1.0 + self.lambda_sigma(emb))
        if film is not None:
            mu, sigma = film
            feats = mu[:, :, None, None] + feats * sigma[:, :, None, None]
        return self.final_layer(feats)


def get_pose_net(cfg, engine: str = "auto", lambda_head: bool = False) -> PoseHRNet:
    """pose_hrnet for ``cfg``; ``engine`` (the attention engine) is unused:
    the model has no attention."""
    from ..data.pipeline import num_input_channels

    del engine
    return PoseHRNet(HRNetSpec.from_cfg(cfg), in_channels=num_input_channels(cfg),
                     lambda_head=lambda_head)


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


def random_init(model: nn.Module) -> None:
    """Redraw every weight with N(0, 1/fan_in), biases N(0, 0.1), and every BN
    affine and running statistic away from the identity, from torch's seeded
    generator.  The reference's N(0, 0.001) init leaves ~1e-10 heatmaps;
    these give maps with real peaks, so decodes and comparisons see decisive
    values (chip_smoke.py and the benchmarks use it).  The packed attention
    projection (``in_proj_weight``) and LayerNorm are drawn the same way; a
    position embedding is left as it is."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose2d):      # each output sums I*k*k/s^2 inputs
                fan_in = m.weight.numel() // m.weight.shape[1] // (m.stride[0] * m.stride[1])
                m.weight.normal_(0.0, fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.normal_(0.0, 0.1)
                    m.running_var.uniform_(0.5, 1.5)
            elif hasattr(m, "in_proj_weight"):
                m.in_proj_weight.normal_(0.0, m.in_proj_weight.shape[1] ** -0.5)
                m.in_proj_bias.normal_(0.0, 0.1)


def init_weights(model: nn.Module) -> None:
    """The reference's init (pose_hrnet.py:578-590, pose_resnet.py:237-255):
    conv, transposed-conv and linear weights N(0, 0.001), biases 0, BN and LayerNorm weight 1 and bias 0.  Layers
    marked ``zero_init`` (the lambda head's last layers) start at 0.  Other
    parameters (TransPose's packed attention projection, which draws its own
    N(0, 0.001), and its position embedding) are left as built."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if getattr(mod, "zero_init", False):
                nn.init.zeros_(mod.weight)
            else:
                nn.init.normal_(mod.weight, std=0.001)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
