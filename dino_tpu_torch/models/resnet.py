"""Truncated ResNet-50 backbones ('cnn1' / 'cnn2'): the counterpart of
``dino_tpu/models/resnet.py``.

The reference benchmarks the ViT against a DINO-pretrained ResNet-50 cut at

  * cnn1: conv1, bn1, relu, maxpool, layer1, layer2, with the last
    bottleneck's relu swapped for Identity (which silences all three of that
    block's relu call sites) -> (B, 512, H/8, W/8);
  * cnn2: ... layer3[0], layer3[1] (the last block's relu off too), then a
    ConvTranspose2d(1024 -> 512, k=1, s=2, output_padding=1), a ReLU and a
    3x3 Conv(512 -> 512) -> (B, 512, H/8, W/8).

The modules carry torchvision's key names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``/``.1``, ...; cnn2 adds
``upconv`` and ``conv``), so a torchvision / DINO ResNet-50 state dict loads
with its surplus layers dropped.  The forward is plain functions over those
modules, at ``dino_tpu``'s rounding points:

  * a convolution takes operands in the input dtype and rounds once from its
    float32 sum (cuDNN on the card; on the CPU float32 arithmetic on the
    same operands); float32 runs with TF32 off (the caller's
    ``true_fp32``);
  * BatchNorm in eval mode folds the running stats into one multiply-add in
    float32; in train mode (``bn_collect``, the train step's) it normalizes
    with the batch statistics (biased variance) and collects the EMA
    running stats (unbiased variance, momentum 0.1) for
    :func:`update_bn_stats`, as torch's ``train()`` and ``dino_tpu`` do,
    even with a frozen backbone;
  * the transposed conv is zero insertion plus a 1x1 product, exactly
    ConvTranspose2d(k=1, s=2, output_padding=1);
  * :func:`resnet_features` folds the (B, 512, h, w) map to (B*h*w, 512) in
    row-major (h, w) order, ``dino_tpu``'s NHWC order.

No TPU kernel of ``dino_tpu`` runs here: its convolutions are XLA convs.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dino_tpu_torch.checkpointing.pretrained import load_pretrained_resnet
from dino_tpu_torch.parallel.dist import GroupSum, get_world_size

VARIANTS = ("cnn1", "cnn2")
# resnet50 stage layout: (blocks, mid_planes, out_planes, stride)
_STAGES = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2)]
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
OUTPUT_DIM = 512  # both variants feed 512-dim patch features to the head


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        if downsample:
            self.downsample = nn.Sequential(nn.Conv2d(cin, out, 1, bias=False),
                                            nn.BatchNorm2d(out))


class ResNetBackbone(nn.Module):
    """The parameters of a truncated ResNet-50; ``forward`` is
    :func:`resnet_backbone_apply` in eval mode."""

    def __init__(self, variant: str = "cnn1"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown cnn backbone {variant!r}")
        self.variant = variant
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        n_stages = 2 if variant == "cnn1" else 3
        for si, (blocks, mid, out, _) in enumerate(_STAGES[:n_stages]):
            if variant == "cnn2" and si == 2:
                blocks = 2  # layer3[0:2] only
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(cin, mid, out, downsample=bi == 0))
                cin = out
            setattr(self, f"layer{si + 1}", nn.Sequential(*stage))
        if variant == "cnn2":
            self.upconv = nn.ConvTranspose2d(1024, 512, 1, stride=2,
                                             output_padding=1)
            self.conv = nn.Conv2d(512, 512, 3, padding=1)

    def stages(self):
        return [getattr(self, f"layer{i}") for i in (1, 2, 3)
                if hasattr(self, f"layer{i}")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resnet_backbone_apply(self, x)


@torch.no_grad()
def init_resnet_params(model: ResNetBackbone,
                       generator: torch.Generator) -> ResNetBackbone:
    """``dino_tpu``'s random init: every conv kernel normal * sqrt(2 /
    fan_in), BatchNorm scale 1, bias 0, mean 0, var 1, the cnn2 head's
    biases 0; drawn from ``generator`` on the CPU."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                      else w[0].numel())
            w.copy_(torch.randn(w.shape, generator=generator)
                    * (math.sqrt(2.0) / math.sqrt(fan_in)))
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model


# ---------------------------------------------------------------------------
# Primitives (NCHW)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_onednn():
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Convolution with operands in x's dtype, summed in float32 and rounded
    once to x's dtype: cuDNN on the card; on the CPU float32 arithmetic on
    the same operands, through PyTorch's own im2col + GEMM, oneDNN off:
    its float32 sums err half as much as oneDNN's against float64
    (tests/test_torch_port_resnet.py::
    test_cpu_step_gradients_against_float64), and with oneDNN's route the
    unfrozen cnn1 step of ``test_train_step_matches_dino_tpu`` failed its
    bound (ReLU units at 0 within rounding took the other side from
    dino_tpu's, and train-mode BatchNorm's backward carries that far)."""
    w = w.to(x.dtype)
    if x.device.type == "cuda":
        return F.conv2d(x, w, stride=stride, padding=padding)
    if x.device.type != "cpu":
        raise ValueError(f"conv2d: unsupported device {x.device}")
    with _no_onednn():
        return F.conv2d(x.float(), w.float(), stride=stride,
                        padding=padding).to(x.dtype)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor,
               eps: float = BN_EPS) -> torch.Tensor:
    """Eval-mode BatchNorm: the running stats folded into one float32
    multiply-add, rounded to x's dtype."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    bias = bn.bias.float() - bn.running_mean.float() * scale
    return (x.float() * scale[:, None, None]
            + bias[:, None, None]).to(x.dtype)


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor,
                     eps: float = BN_EPS, momentum: float = BN_MOMENTUM,
                     group=None):
    """Train-mode BatchNorm: normalize with the batch statistics (biased
    variance); returns (y, (new running mean, new running var)), the
    running var fed the unbiased variance.  The new stats are detached:
    state, not a differentiable output.  ``group`` (data parallelism, every
    rank a slab of the same size): the statistics of the global batch, the
    per-channel sums taken over the group (:class:`GroupSum`, whose
    backward sums the cotangents), as ``dino_tpu``'s on a sharded batch."""
    xf = x.float()
    world = get_world_size(group) if group is not None else 1
    if world > 1:
        n_all = x.shape[0] * x.shape[2] * x.shape[3] * world
        mean_b = GroupSum.apply(xf.sum(dim=(0, 2, 3)), group) / n_all
        var_b = GroupSum.apply(torch.square(
            xf - mean_b[:, None, None]).sum(dim=(0, 2, 3)), group) / n_all
    else:
        mean_b = xf.mean(dim=(0, 2, 3))
        var_b = torch.square(xf - mean_b[:, None, None]).mean(dim=(0, 2, 3))
    y = ((xf - mean_b[:, None, None])
         * torch.rsqrt(var_b + eps)[:, None, None]
         * bn.weight.float()[:, None, None]
         + bn.bias.float()[:, None, None]).to(x.dtype)
    n = x.shape[0] * x.shape[2] * x.shape[3] * world
    var_unbiased = var_b.detach() * (n / max(n - 1, 1))
    new = ((1 - momentum) * bn.running_mean + momentum * mean_b.detach(),
           (1 - momentum) * bn.running_var + momentum * var_unbiased)
    return y, new


def max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2, padding=1)


def conv_transpose_1x1_s2(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(kernel=1, stride=2, output_padding=1), ``w`` (in,
    out, 1, 1): the 1x1 product (float32 sum, one rounding) lands at the
    even output positions, everything else is the bias; the bias (rounded
    to x's dtype) adds in x's dtype, as ``dino_tpu``'s."""
    proj = conv2d(x, w.transpose(0, 1))
    b_, c, h, wd = proj.shape
    out = proj.new_zeros(b_, c, 2 * h, 2 * wd)
    out[:, :, ::2, ::2] = proj
    return out + b.to(x.dtype)[:, None, None]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _bottleneck(blk: Bottleneck, x: torch.Tensor, stride: int,
                relu_on: bool, bn) -> torch.Tensor:
    act = torch.relu if relu_on else (lambda y: y)
    out = act(bn(blk.bn1, conv2d(x, blk.conv1.weight)))
    out = act(bn(blk.bn2, conv2d(out, blk.conv2.weight, stride=stride,
                                 padding=1)))
    out = bn(blk.bn3, conv2d(out, blk.conv3.weight))
    identity = x
    if hasattr(blk, "downsample"):
        identity = bn(blk.downsample[1],
                      conv2d(x, blk.downsample[0].weight, stride=stride))
    return act(out + identity)


def resnet_backbone_apply(model: ResNetBackbone, x: torch.Tensor,
                          bn_collect: Optional[Dict] = None,
                          bn_group=None) -> torch.Tensor:
    """(B, H, W, 3) normalized image -> (B, 512, H/8, W/8) feature map.

    A dict as ``bn_collect`` switches BatchNorm to train mode (batch
    statistics, as the reference under PL's ``train()``, even with
    requires_grad off) and fills it with each BatchNorm module's new
    running stats; :func:`update_bn_stats` writes them back.  ``bn_group``:
    the batch statistics over every rank's slab (data parallelism)."""
    if bn_collect is None:
        bn = batch_norm
    else:
        def bn(mod, y):
            out, new = batch_norm_train(mod, y, group=bn_group)
            bn_collect[mod] = new
            return out
    x = x.permute(0, 3, 1, 2)
    x = torch.relu(bn(model.bn1, conv2d(x, model.conv1.weight, stride=2,
                                        padding=3)))
    x = max_pool(x)
    stages = model.stages()
    for si, stage in enumerate(stages):
        for bi, blk in enumerate(stage):
            last = si == len(stages) - 1 and bi == len(stage) - 1
            x = _bottleneck(blk, x, _STAGES[si][3] if bi == 0 else 1,
                            relu_on=not last, bn=bn)
    if model.variant == "cnn2":
        x = torch.relu(conv_transpose_1x1_s2(x, model.upconv.weight,
                                             model.upconv.bias))
        x = (conv2d(x, model.conv.weight, padding=1)
             + model.conv.bias.to(x.dtype)[:, None, None])
    return x


def resnet_features(model: ResNetBackbone, x: torch.Tensor,
                    bn_collect: Optional[Dict] = None,
                    bn_group=None) -> torch.Tensor:
    """(B, H, W, 3) -> (B*H/8*W/8, 512) patch features in row-major (h, w)
    order (NCHW permuted to NHWC before the fold)."""
    feats = resnet_backbone_apply(model, x, bn_collect, bn_group)
    return feats.permute(0, 2, 3, 1).reshape(-1, feats.shape[1])


@torch.no_grad()
def update_bn_stats(bn_collect: Dict) -> None:
    """Write the running stats a train-mode forward collected back into
    their BatchNorm modules (scale and bias untouched)."""
    for bn, (mean, var) in bn_collect.items():
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
        bn.num_batches_tracked += 1


def build_backbone(variant: str, generator: torch.Generator,
                   random_init: bool,
                   pretrained_path: Optional[str] = None) -> ResNetBackbone:
    """A ResNet backbone: random init from ``generator``, then (unless
    ``random_init``) the pretrained weights of
    ``checkpointing/pretrained.py``'s ladder; with none it warns and keeps
    the random init."""
    model = init_resnet_params(ResNetBackbone(variant), generator)
    if random_init:
        return model
    sd = load_pretrained_resnet(variant, pretrained_path)
    if sd is None:
        warnings.warn("pretrained dino_resnet50 unavailable; using random "
                      "init (pass pretrained_path or set "
                      "$DINO_TPU_PRETRAINED_RESNET)")
        return model
    model.load_state_dict(sd, strict=False)
    return model
