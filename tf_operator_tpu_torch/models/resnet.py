"""ResNet family (v1.5 bottleneck) for the port: training and eval forward.

Port of ``tf_operator_tpu/models/resnet.py``: ``ResNetConfig`` and its
presets (same numbers), init (same tree, keys, shapes and distributions:
``stem``, ``stage{i}`` lists of block dicts, ``head``; BN running
statistics in a separate ``state`` tree), batch norm in every mode the
JAX package has, the SAME convolution, the space-to-depth stem, the
bottleneck in its plain and fused forms, and ``resnet_forward``.

Layout: activations are NHWC and conv weights HWIO at every function
here, as in the JAX package, so params convert with a plain copy. A
convolution sees its input as a ``channels_last`` NCHW view of the same
memory, so cuDNN takes its NHWC kernels and the 1x1 convolutions' ``[b*h*w,
c]`` matrices are free views for the fused kernel.

Declared differences (ROADMAP Queue 3):

- SAME padding is computed as XLA computes it (``_same_pad``): where it is
  asymmetric (the stride-2 3x3 convolutions, the stems, the max pool) the
  input is padded explicitly (with -inf for the pool) and the convolution
  or pool runs unpadded; PyTorch's own ``padding`` is symmetric and would
  shift the window.
- Batch norm is written in plain tensor ops, not ``F.batch_norm``, whose
  momentum convention, unbiased running variance and single fused form
  are not JAX's.
- The new BN state is returned detached: in JAX it is an aux output with
  no gradient; a PyTorch state that kept its graph would hold every
  step's forward alive into the next.
- Init draws from a ``torch.Generator``; parity tests convert the JAX
  package's params instead of re-seeding.
- The 3x3 and stem convolutions and the head are cuDNN and cuBLAS calls
  (the JAX package leaves them to XLA); the 1x1 convolutions of
  ``fused_1x1`` go through ``ops/fused_linear_stats.py`` (K8 on the card).

Under a mesh (``resnet_forward(..., mesh=)``: this rank's rows of the
batch; params replicated, ``resnet_logical_axes``) train-mode batch norm
is synced, as JAX's mean over the sharded batch is: E[x] and E[x²] (or
the mean and then the mean squared deviation) are averaged over the data
axes before the affine, and under ``fused_1x1`` K8's column sum and sum
of squares are summed over them, so the running statistics are the
global batch's on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.ops.fused_linear_stats import fused_linear_stats
from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel.mesh import DATA_AXES

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@dataclass(frozen=True)
class ResNetConfig:
    """The JAX config's fields and defaults (see its comments for what each
    BN mode does and why); ``dtype`` is a torch dtype."""

    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    stem: str = "s2d"  # "s2d" (4x4 conv on space-to-depth input) | "conv7"
    bn_in_activation_dtype: bool = True
    bn_fused_stats: bool = True
    bn_stats_stop_gradient: Any = "var"  # False | True | "var"
    bn_ghost_stats: bool = False
    fused_1x1: bool = False

    @staticmethod
    def resnet50(num_classes: int = 1000) -> "ResNetConfig":
        return ResNetConfig((3, 4, 6, 3), (64, 128, 256, 512), num_classes)

    @staticmethod
    def resnet18(num_classes: int = 1000) -> "ResNetConfig":
        # bottlenecks-of-1, as in the JAX package
        return ResNetConfig((2, 2, 2, 2), (64, 128, 256, 512), num_classes)

    @staticmethod
    def tiny(num_classes: int = 10) -> "ResNetConfig":
        """Test scale: width/4, one block per stage."""
        return ResNetConfig((1, 1, 1, 1), (16, 32, 64, 128), num_classes)

    def flops_per_image(self, image_size: int = 224) -> float:
        """Approximate forward FLOPs per image (2*MACs), the JAX package's
        formula: ResNet-50 at 224 ~ 8.2e9, scaled by depth and area."""
        base = 8.2e9
        depth_ratio = sum(self.stage_sizes) / 16.0
        return base * depth_ratio * (image_size / 224.0) ** 2


def init_resnet(cfg: ResNetConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Tuple[Dict, Dict]:
    """(params, state), f32, with the JAX package's trees: conv weights HWIO
    N(0, 2/fan_in), BN scale 1 and bias 0, head N(0, 0.01²) and 0; state
    holds each BN's running mean 0 and var 1 (and, with ghost statistics,
    the last batch's). ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    ghost = cfg.bn_ghost_stats

    def conv(kh, kw, cin, cout):
        t = torch.randn((kh, kw, cin, cout), generator=generator, device=dev)
        return t.mul_((2.0 / (kh * kw * cin)) ** 0.5)

    def bn_params(c):
        return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}

    def bn_state(c):
        s = {"mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)}
        if ghost:
            s["bmean"] = torch.zeros(c, device=dev)
            s["bvar"] = torch.ones(c, device=dev)
        return s

    params: Dict[str, Any] = {"stem": {"conv": conv(7, 7, 3, 64), "bn": bn_params(64)}}
    state: Dict[str, Any] = {"stem": bn_state(64)}
    cin = 64
    for si, (n_blocks, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        stage_p: List[Dict] = []
        stage_s: List[Dict] = []
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            cout = width * 4
            bp = {"conv1": conv(1, 1, cin, width), "bn1": bn_params(width),
                  "conv2": conv(3, 3, width, width), "bn2": bn_params(width),
                  "conv3": conv(1, 1, width, cout), "bn3": bn_params(cout)}
            bs = {"bn1": bn_state(width), "bn2": bn_state(width), "bn3": bn_state(cout)}
            if stride != 1 or cin != cout:
                bp["proj"] = conv(1, 1, cin, cout)
                bp["proj_bn"] = bn_params(cout)
                bs["proj_bn"] = bn_state(cout)
            stage_p.append(bp)
            stage_s.append(bs)
            cin = cout
        params[f"stage{si}"] = stage_p
        state[f"stage{si}"] = stage_s
    head_w = torch.randn((cin, cfg.num_classes), generator=generator, device=dev).mul_(0.01)
    params["head"] = {"w": head_w, "b": torch.zeros(cfg.num_classes, device=dev)}
    return params, state


def resnet_logical_axes(params) -> Any:
    """Every conv and BN param replicated (all-None axes); only the batch
    is split. The JAX package's table."""
    if isinstance(params, dict):
        return {k: resnet_logical_axes(v) for k, v in params.items()}
    if isinstance(params, list):
        return [resnet_logical_axes(v) for v in params]
    return tuple(None for _ in params.shape)


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------


def _data_axes(mesh) -> tuple:
    """The data axes of size > 1 a batch statistic is averaged over."""
    return tuple(a for a in DATA_AXES if coll.axis_size(mesh, a) > 1)


def _batch_stats(x, fused_stats: bool, mesh=None):
    """Per-channel (mean, var) of NHWC x in f32: E[x] and E[x²] in one read
    (fused), or mean then the two-pass variance; over the global batch
    under a mesh (equal rows per rank: a mean of the ranks' means)."""
    dims = (0, 1, 2)
    axes = _data_axes(mesh)
    if fused_stats:
        mean = x.mean(dim=dims, dtype=torch.float32)
        m2 = x.float().square().mean(dim=dims)
        if axes:
            mean = coll.all_reduce_mean(mean, mesh, axes)
            m2 = coll.all_reduce_mean(m2, mesh, axes)
        return mean, torch.clamp(m2 - mean.square(), min=0.0)
    xf = x.float()
    if not axes:
        return xf.mean(dim=dims), xf.var(dim=dims, correction=0)
    mean = coll.all_reduce_mean(xf.mean(dim=dims), mesh, axes)
    return mean, coll.all_reduce_mean((xf - mean).square().mean(dim=dims), mesh, axes)


def _apply_affine(x, a, b, in_act_dtype: bool):
    """x * a + b per channel: in x's dtype, or in f32 and rounded back."""
    if in_act_dtype:
        return x * a.to(x.dtype) + b.to(x.dtype)
    return (x.float() * a + b).to(x.dtype)


def _batch_norm(x, p, s, train: bool, in_act_dtype: bool = True, fused_stats: bool = True,
                stats_stop_gradient: Any = False, ghost: bool = False, mesh=None):
    """x: [b, h, w, c] activations. Statistics in f32. Returns (y, new_state).

    The JAX package's modes: ``in_act_dtype`` folds the affine in f32 and
    applies it in x's dtype; ``fused_stats`` takes E[x] and E[x²] in one
    read; ``stats_stop_gradient`` True stops the gradient through both
    batch statistics, "var" through the variance only; ``ghost`` normalizes
    with the previous step's batch statistics (carried in state). Under
    ``mesh`` the statistics are the global batch's."""
    if train and ghost:
        bmean, bvar = _batch_stats(x, fused_stats, mesh)
        new_s = {"mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * bmean,
                 "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * bvar,
                 "bmean": bmean, "bvar": bvar}
        a, b = _bn_affine(p, s["bmean"], s["bvar"])  # the previous step's batch stats
        return _apply_affine(x, a, b, in_act_dtype), {k: v.detach() for k, v in new_s.items()}
    if train:
        mean, var = _batch_stats(x, fused_stats, mesh)
        new_s = _bn_update(s, mean, var)
        if stats_stop_gradient:
            if stats_stop_gradient != "var":
                mean = mean.detach()
            var = var.detach()
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    a, b = _bn_affine(p, mean, var)
    return _apply_affine(x, a, b, in_act_dtype), new_s


def _bn_affine(p, mean, var):
    """Folded BN affine from given statistics: y*a + b == normalize."""
    a = torch.rsqrt(var + BN_EPS) * p["scale"]
    return a, p["bias"] - mean * a


def _bn_update(s, mean, var):
    """Running statistics after one batch, detached (state carries no graph)."""
    return {"mean": (BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean).detach(),
            "var": (BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var).detach()}


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after), the extra
    one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_padded(x, w, stride: int, pad_h: Tuple[int, int], pad_w: Tuple[int, int]):
    """NHWC x, HWIO w (cast to x's dtype), explicit (before, after) zero
    padding of each spatial dim. Returns NHWC."""
    wt = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
    if pad_h[0] == pad_h[1] and pad_w[0] == pad_w[1]:
        out = F.conv2d(xc, wt, stride=stride, padding=(pad_h[0], pad_w[0]))
    else:
        out = F.conv2d(F.pad(xc, (pad_w[0], pad_w[1], pad_h[0], pad_h[1])), wt, stride=stride)
    return out.permute(0, 2, 3, 1)


def _conv(x, w, stride: int = 1):
    """SAME convolution, NHWC x and HWIO w, as the JAX package's _conv."""
    return _conv_padded(x, w, stride, _same_pad(x.shape[1], w.shape[0], stride),
                        _same_pad(x.shape[2], w.shape[1], stride))


def _max_pool_same(x, k: int = 3, stride: int = 2):
    """reduce_window max, SAME, -inf padding, on NHWC x."""
    ph, pw = _same_pad(x.shape[1], k, stride), _same_pad(x.shape[2], k, stride)
    xc = x.permute(0, 3, 1, 2)
    if ph != (0, 0) or pw != (0, 0):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(xc, k, stride).permute(0, 2, 3, 1)


def _space_to_depth(x, block: int = 2):
    """[b, h, w, c] -> [b, h/2, w/2, 4c]: 2x2 pixel blocks become channels."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block, block * block * c)


def _stem_s2d(x, w7):
    """The SAME 7x7/s2 conv as a 4x4/s1 conv on space-to-depth(2) input:
    the kernel zero-padded to 8x8 and its 2x2 phases folded into input
    channels; padding (1, 2) on each spatial dim."""
    xs = _space_to_depth(x, 2)
    k8 = F.pad(w7, (0, 0, 0, 0, 0, 1, 0, 1))
    cin, cout = w7.shape[2], w7.shape[3]
    k = k8.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * cin, cout)
    return _conv_padded(xs, k, 1, (1, 2), (1, 2))


# ---------------------------------------------------------------------------
# blocks and the network
# ---------------------------------------------------------------------------


def _bottleneck(x, bp, bs, stride, train, bn_act, bn_fused, bn_sg=False, bn_ghost=False,
                mesh=None):
    bn = lambda y, name: _batch_norm(y, bp[name], bs[name], train, bn_act, bn_fused,  # noqa: E731
                                     bn_sg, bn_ghost, mesh)
    y, s1 = bn(_conv(x, bp["conv1"]), "bn1")
    y, s2 = bn(_conv(torch.relu(y), bp["conv2"], stride), "bn2")
    y, s3 = bn(_conv(torch.relu(y), bp["conv3"]), "bn3")
    new_bs = {"bn1": s1, "bn2": s2, "bn3": s3}
    if "proj" in bp:
        shortcut, new_bs["proj_bn"] = bn(_conv(x, bp["proj"], stride), "proj_bn")
    else:
        shortcut = x
    return torch.relu(y + shortcut), new_bs


def _bottleneck_fused(x, bp, bs, stride, bn_act, bn_fused=True, bn_sg=False, mesh=None):
    """Train-mode bottleneck with the 1x1 convolutions (conv1, conv3, the
    projection) through ``fused_linear_stats``: their BN statistics come
    from the product's epilogue. The same math as _bottleneck with fused
    statistics; only the 3x3 conv and its BN take the plain path. ``bn_sg``
    applies to the kernel-derived statistics too. Under ``mesh`` the
    kernel's column sums are summed over the data axes."""
    b, h, w, cin = x.shape
    flat = x.reshape(b * h * w, cin)  # a view of NHWC x
    axes = _data_axes(mesh)
    n_data = 1
    for a in axes:
        n_data *= coll.axis_size(mesh, a)

    def stats(s, q, rows):
        if axes:
            s = coll.all_reduce_sum(s, mesh, axes)
            q = coll.all_reduce_sum(q, mesh, axes)
            rows = rows * n_data
        mean = s / rows
        var = torch.clamp(q / rows - mean.square(), min=0.0)
        if bn_sg:
            if bn_sg != "var":
                mean = mean.detach()
            var = var.detach()
        return mean, var

    y1, s1, q1 = fused_linear_stats(flat, bp["conv1"][0, 0].to(x.dtype))
    mean1, var1 = stats(s1, q1, float(flat.shape[0]))
    a1, b1 = _bn_affine(bp["bn1"], mean1, var1)
    y1n = torch.relu(_apply_affine(y1.reshape(b, h, w, -1), a1, b1, bn_act))
    y2n, s2 = _batch_norm(_conv(y1n, bp["conv2"], stride), bp["bn2"], bs["bn2"], True, bn_act,
                          bn_fused, bn_sg, mesh=mesh)
    y2n = torch.relu(y2n)

    oh, ow = y2n.shape[1], y2n.shape[2]
    rows = b * oh * ow
    y3, s3, q3 = fused_linear_stats(y2n.reshape(rows, -1), bp["conv3"][0, 0].to(x.dtype))
    mean3, var3 = stats(s3, q3, float(rows))
    a3, b3 = _bn_affine(bp["bn3"], mean3, var3)
    new_bs = {"bn1": _bn_update(bs["bn1"], mean1, var1), "bn2": s2,
              "bn3": _bn_update(bs["bn3"], mean3, var3)}

    if "proj" in bp:
        # the strided rows are a copy ([b, oh, ow, cin]): the kernel reads
        # contiguous rows
        xs = x[:, ::stride, ::stride, :].contiguous() if stride != 1 else x
        yp, sp, qp = fused_linear_stats(xs.reshape(rows, cin), bp["proj"][0, 0].to(x.dtype))
        meanp, varp = stats(sp, qp, float(rows))
        ap, bpb = _bn_affine(bp["proj_bn"], meanp, varp)
        shortcut = _apply_affine(yp.reshape(b, oh, ow, -1), ap, bpb, bn_act)
        new_bs["proj_bn"] = _bn_update(bs["proj_bn"], meanp, varp)
    else:
        shortcut = x
    y3n = _apply_affine(y3.reshape(b, oh, ow, -1), a3, b3, bn_act)
    return torch.relu(y3n + shortcut), new_bs


def resnet_forward(params, state, images, cfg: ResNetConfig, train: bool = True, mesh=None):
    """images: [b, h, w, 3] -> (logits [b, classes] f32, new_state). Under
    ``mesh`` the images are this rank's rows and train-mode BN is synced."""
    if cfg.bn_ghost_stats and cfg.fused_1x1:
        raise ValueError("bn_ghost_stats does not compose with fused_1x1")
    bn_act, bn_fused = cfg.bn_in_activation_dtype, cfg.bn_fused_stats
    bn_sg, bn_ghost = cfg.bn_stats_stop_gradient, cfg.bn_ghost_stats
    x = images.to(cfg.dtype)
    # s2d needs even spatial dims; odd sizes take the literal 7x7/s2 conv
    if cfg.stem == "s2d" and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
        x = _stem_s2d(x, params["stem"]["conv"])
    else:
        x = _conv(x, params["stem"]["conv"], stride=2)
    x, stem_s = _batch_norm(x, params["stem"]["bn"], state["stem"], train, bn_act, bn_fused,
                            bn_sg, bn_ghost, mesh)
    x = _max_pool_same(torch.relu(x))
    new_state: Dict[str, Any] = {"stem": stem_s}
    fused_1x1 = cfg.fused_1x1 and train  # eval folds the running stats either way
    for si, n_blocks in enumerate(cfg.stage_sizes):
        stage_s = []
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            bp, bs = params[f"stage{si}"][bi], state[f"stage{si}"][bi]
            if fused_1x1:
                x, new_bs = _bottleneck_fused(x, bp, bs, stride, bn_act, bn_fused, bn_sg, mesh)
            else:
                x, new_bs = _bottleneck(x, bp, bs, stride, train, bn_act, bn_fused, bn_sg,
                                        bn_ghost, mesh)
            stage_s.append(new_bs)
        new_state[f"stage{si}"] = stage_s
    x = x.float().mean(dim=(1, 2))
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, new_state
