"""Plain PyTorch reference of the benchmark's training steps.

It imports nothing of the measured package and computes from what the
benchmark hands it: the initial weights, the slices, the seed of the draws.
Everything else it works out again: the batches the device cache samples
and crops, the augmentation draws, the U-Net with its BatchNorm running
statistics, the hooks' heads and losses, RAdam with the warm-up schedule.
The draw functions repeat the calls the port makes on a ``torch.Generator``,
in the same order, so on the same device they give the same numbers.

``Precision("float32")`` is the reference (float32, TF32 off);
``Precision("fp8")`` is the control, computed in the step below the
bfloat16 compute the configurations state: every conv and matrix product
takes its operands rounded to float8 e4m3 and rounds its output to e4m3,
as the port rounds its products' outputs to bfloat16, and its output's
cotangent to e5m2 on the way back (each with a per-tensor scale).
``Precision("bfloat16")`` rounds the same tensors to bfloat16, the
configurations' own compute: a witness of what bfloat16 rounding alone does
to a number. Tensors are NHWC at the boundaries, as the port's.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ENCODER = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
#: (upsampling layer, conv block, skip) of each decoder level
DECODER = (("Up5", "Up_conv5", "Conv4"), ("Up4", "Up_conv4", "Conv3"),
           ("Up3", "Up_conv3", "Conv2"), ("Up2", "Up_conv2", "Conv1"))
LAYER_DIM = {"Conv1": 1, "Conv2": 2, "Conv3": 4, "Conv4": 8, "Conv5": 16,
             "Up_conv5": 8, "Up_conv4": 4, "Up_conv3": 2, "Up_conv2": 1}
BN_EPS = 1e-5
TEMPERATURE = 0.07
POINT_NUMS = 5
PROJ_DIM = 256


# --- precision -------------------------------------------------------------

def _fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x * scale).to(dtype).to(x.dtype) / scale)


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand rounded to e4m3; backward: the cotangent as it
    comes (the product's own cotangent is rounded where it enters)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Output(torch.autograd.Function):
    """Forward: the product's output rounded to e4m3; backward: its
    cotangent rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return _fp8_round(y, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


class _Bf16(torch.autograd.Function):
    """Forward: the tensor rounded to bfloat16; backward: with ``grad``, the
    cotangent rounded to bfloat16, else as it comes."""

    @staticmethod
    def forward(ctx, x, grad: bool):
        ctx.grad = grad
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return (g.to(torch.bfloat16).to(g.dtype) if ctx.grad else g), None


class Precision:
    """Where the reference rounds: ``float32`` nowhere; ``fp8`` and
    ``bfloat16`` the operands, the output and the output's cotangent of
    every conv and matrix product."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8", "bfloat16"):
            raise ValueError(f"precision {name!r}: float32, fp8 or bfloat16")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "bfloat16":
            return _Bf16.apply(x, False)
        return x if self.name == "float32" else _Fp8Operand.apply(x)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if self.name == "bfloat16":
            return _Bf16.apply(y, True)
        return y if self.name == "float32" else _Fp8Output.apply(y)

    def conv(self, x, w, b=None, padding=0):
        return self.output(F.conv2d(self.operand(x), self.operand(w), b, padding=padding))

    def linear(self, x, w, b=None):
        return self.output(F.linear(self.operand(x), self.operand(w), b))


# --- parameters ------------------------------------------------------------

def channel_dim(name: str, max_channel: int) -> int:
    return int(LAYER_DIM[name] / 16 * max_channel)


def unet_shapes(max_channel: int, num_classes: int, input_dim: int = 1
                ) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """(parameters, buffers): name -> shape of the U-Net, named as the
    published Contrast-You torch U-Net names them."""
    cd = lambda n: channel_dim(n, max_channel)  # noqa: E731
    params: Dict[str, tuple] = {}
    buffers: Dict[str, tuple] = {}

    def bn(prefix, f):
        params[f"{prefix}.weight"] = (f,)
        params[f"{prefix}.bias"] = (f,)
        buffers[f"{prefix}.running_mean"] = (f,)
        buffers[f"{prefix}.running_var"] = (f,)

    def block(name, cin, f):
        params[f"_{name}.conv.0.weight"] = (f, cin, 3, 3)
        bn(f"_{name}.conv.1", f)
        params[f"_{name}.conv.3.weight"] = (f, f, 3, 3)
        bn(f"_{name}.conv.4", f)

    cin = input_dim
    for name in ENCODER:
        block(name, cin, cd(name))
        cin = cd(name)
    for up, conv, _ in DECODER:
        params[f"_{up}.up.1.weight"] = (cd(conv), cin, 3, 3)
        bn(f"_{up}.up.2", cd(conv))
        block(conv, 2 * cd(conv), cd(conv))
        cin = cd(conv)
    params["_Deconv_1x1.weight"] = (num_classes, cin, 1, 1)
    params["_Deconv_1x1.bias"] = (num_classes,)
    return params, buffers


def head_shapes(kind: str, in_dim: int) -> Dict[str, tuple]:
    """Parameters of an InfoNCE projection head: ``encoder`` (pool, two dense
    layers) or ``dense`` (two 1x1 convs, pool to the grid)."""
    if kind == "encoder":
        return {"projector.Dense_0.weight": (PROJ_DIM, in_dim), "projector.Dense_0.bias": (PROJ_DIM,),
                "projector.Dense_1.weight": (PROJ_DIM, PROJ_DIM), "projector.Dense_1.bias": (PROJ_DIM,)}
    return {"projector.Conv_0.weight": (PROJ_DIM, in_dim, 1, 1), "projector.Conv_0.bias": (PROJ_DIM,),
            "projector.Conv_1.weight": (PROJ_DIM, PROJ_DIM, 1, 1), "projector.Conv_1.bias": (PROJ_DIM,)}


# --- the U-Net -------------------------------------------------------------

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class UNet:
    """The U-Net's forward on a parameter and buffer dict (NCHW inside).
    Train mode: batch mean and biased variance, running statistics
    ``(1 - m) * old + m * batch`` with the biased variance."""

    def __init__(self, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor], *,
                 momentum: float, prec: Precision):
        self.p, self.b, self.m, self.prec = params, buffers, momentum, prec

    def _bn_relu(self, x, prefix, update):
        mean = x.mean((0, 2, 3))
        var = (x - mean[:, None, None]).pow(2).mean((0, 2, 3))
        if update:
            with torch.no_grad():
                for key, v in (("running_mean", mean), ("running_var", var)):
                    buf = self.b[f"{prefix}.{key}"]
                    buf.mul_(1.0 - self.m).add_(v.detach(), alpha=self.m)
        a = self.p[f"{prefix}.weight"] * torch.rsqrt(var + BN_EPS)
        return torch.relu(x * a[:, None, None] + (self.p[f"{prefix}.bias"] - a * mean)[:, None, None])

    def _block(self, name, x, update):
        for conv, bn in ((0, 1), (3, 4)):
            x = self.prec.conv(x, self.p[f"_{name}.conv.{conv}.weight"], padding=1)
            x = self._bn_relu(x, f"_{name}.conv.{bn}", update)
        return x

    def __call__(self, x: torch.Tensor, *, until: Optional[str] = None,
                 taps: Sequence[str] = (), update: bool = True):
        """NHWC ``x`` -> (output at ``until`` or the logits, taps), NHWC."""
        out: Dict[str, torch.Tensor] = {}
        h = _nchw(x)
        skips = {}
        for i, name in enumerate(ENCODER):
            h = self._block(name, F.max_pool2d(h, 2) if i else h, update)
            skips[name] = h
            if name in taps:
                out[name] = _nhwc(h)
            if name == until:
                return _nhwc(h), out
        for up, conv, skip in DECODER:
            u = F.interpolate(h, scale_factor=2, mode="nearest")
            u = self._bn_relu(self.prec.conv(u, self.p[f"_{up}.up.1.weight"], padding=1),
                              f"_{up}.up.2", update)
            h = self._block(conv, torch.cat([skips[skip], u], 1), update)
            if conv in taps:
                out[conv] = _nhwc(h)
            if conv == until:
                return _nhwc(h), out
        logits = self.prec.conv(h, self.p["_Deconv_1x1.weight"], self.p["_Deconv_1x1.bias"])
        return _nhwc(logits), out


# --- transforms and draws (the port's, repeated call for call) --------------

class Geo(NamedTuple):
    scale: torch.Tensor
    angle: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    flip_h: torch.Tensor
    flip_w: torch.Tensor


def _uniform(g, n, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=g.device)


def draw_geo(g: torch.Generator, n: int) -> Geo:
    scale = _uniform(g, n, 0.8, 1.3)
    angle = _uniform(g, n, -45.0, 45.0) * (math.pi / 180.0)
    tx = _uniform(g, n, -0.1, 0.1) * 2.0
    ty = _uniform(g, n, -0.1, 0.1) * 2.0
    mirror = _uniform(g, n, 0.0, 1.0) < 0.9
    axis = _uniform(g, n, 0.0, 1.0) < 0.5
    return Geo(scale, angle, tx, ty, mirror & axis, mirror & ~axis)


def draw_gammas(g: torch.Generator, n: int) -> torch.Tensor:
    return _uniform(g, n, 0.5, 2.0)


def draw_points(g: torch.Generator, n: int, grid: Tuple[int, int]):
    def distinct(k):
        return torch.rand(n, k, generator=g, device=g.device).argsort(1)[:, :POINT_NUMS]
    return distinct(grid[0]), distinct(grid[1])


def draw_crops(g: torch.Generator, n_slices: int, size: int, crop: int, batch: int):
    """(idx, oy, ox) of a device-cache batch; ``n_slices`` None: offsets only."""
    idx = (None if n_slices is None else
           torch.randint(0, n_slices, (batch,), generator=g, device=g.device))
    oy = torch.randint(0, size - crop + 1, (batch,), generator=g, device=g.device)
    ox = torch.randint(0, size - crop + 1, (batch,), generator=g, device=g.device)
    return idx, oy, ox


def crop_at(images: torch.Tensor, idx, oy, ox, crop: int) -> torch.Tensor:
    """Slices ``idx`` of [N, S, S] cropped at (oy, ox) -> [B, c, c]."""
    ar = torch.arange(crop, device=images.device)
    return images[idx[:, None, None], (oy[:, None] + ar)[:, :, None], (ox[:, None] + ar)[:, None, :]]


def _affine(geo: Geo) -> torch.Tensor:
    inv_s = 1.0 / geo.scale
    c, s = torch.cos(geo.angle), torch.sin(geo.angle)
    a00, a01, a10, a11 = inv_s * c, inv_s * s, -inv_s * s, inv_s * c
    b0 = -(a00 * geo.tx + a01 * geo.ty)
    b1 = -(a10 * geo.tx + a11 * geo.ty)
    return torch.stack([torch.stack([a00, a01, b0], -1), torch.stack([a10, a11, b1], -1)], -2)


def warp(images: torch.Tensor, geo: Geo, *, order: int = 0) -> torch.Tensor:
    """Affine warp then mirror of NHWC ``images`` (zeros outside), sampled at
    normalized pixel centres; order 0 nearest (half to even), 1 bilinear."""
    B, H, W, C = images.shape
    sx = torch.where(geo.flip_w, -1.0, 1.0)
    sy = torch.where(geo.flip_h, -1.0, 1.0)
    mats = _affine(geo) * torch.stack([sx, sy, torch.ones_like(sx)], -1)[:, None, :]
    dev = images.device
    ys = (torch.arange(H, device=dev) + 0.5) / H * 2.0 - 1.0
    xs = (torch.arange(W, device=dev) + 0.5) / W * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    hom = torch.cat([torch.stack([gx, gy], -1).to(mats.dtype),
                     torch.ones(H, W, 1, device=dev, dtype=mats.dtype)], -1)
    coords = torch.einsum("bij,hwj->bhwi", mats, hom)
    x = (coords[..., 0] + 1.0) * 0.5 * W - 0.5
    y = (coords[..., 1] + 1.0) * 0.5 * H - 0.5
    flat = images.reshape(B, H * W, C)

    def gather(yi, xi):
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(*yi.shape, C)
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        return vals * valid[..., None].to(images.dtype)

    if order == 0:
        return gather(torch.round(y).long(), torch.round(x).long())
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    wx = (x - x0).to(images.dtype)[..., None]
    wy = (y - y0).to(images.dtype)[..., None]
    return (gather(y0, x0) * (1 - wx) * (1 - wy) + gather(y0, x0 + 1) * wx * (1 - wy)
            + gather(y0 + 1, x0) * (1 - wx) * wy + gather(y0 + 1, x0 + 1) * wx * wy)


def gamma(images: torch.Tensor, gammas: torch.Tensor) -> torch.Tensor:
    return images.clamp(0.0, 1.0) ** gammas.reshape(-1, 1, 1, 1)


def jitter(images: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor) -> torch.Tensor:
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return ((images - mean) * contrast.reshape(-1, 1, 1, 1)
            + mean * brightness.reshape(-1, 1, 1, 1)).clamp(0.0, 1.0)


# --- losses and heads ------------------------------------------------------

def kl_onehot(probs: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    onehot = F.one_hot(target.long(), num_classes).float()
    return (-onehot * torch.log((probs + 1e-16) / (onehot + 1e-16))).sum(-1).mean()


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.01 * x)


def encoder_head(p: Dict[str, torch.Tensor], feat: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Pool [B, H, W, C] -> dense, leaky ReLU, dense, L2 normalize."""
    x = feat.mean((1, 2))
    x = prec.linear(x, p["projector.Dense_0.weight"], p["projector.Dense_0.bias"])
    x = prec.linear(leaky_relu(x), p["projector.Dense_1.weight"], p["projector.Dense_1.bias"])
    return l2_normalize(x)


def dense_head(p: Dict[str, torch.Tensor], feat: torch.Tensor, grid: Tuple[int, int],
               prec: Precision) -> torch.Tensor:
    """[B, H, W, C] -> 1x1 conv, leaky ReLU, 1x1 conv, average pool to
    ``grid``, L2 normalize over channels -> [B, gh, gw, 256]."""
    w0 = p["projector.Conv_0.weight"][:, :, 0, 0]
    w1 = p["projector.Conv_1.weight"][:, :, 0, 0]
    x = leaky_relu(prec.linear(feat, w0, p["projector.Conv_0.bias"]))
    x = prec.linear(x, w1, p["projector.Conv_1.bias"])
    B, H, W, C = x.shape
    x = x.reshape(B, grid[0], H // grid[0], grid[1], W // grid[1], C).mean((2, 4))
    return l2_normalize(x)


def sup_con(f1: torch.Tensor, f2: torch.Tensor, labels: Optional[torch.Tensor],
            prec: Precision) -> torch.Tensor:
    """SupCon over two views' [N, d] rows: positives share a label (each
    row's other view alone without labels), the anchor itself left out."""
    n = f1.shape[0]
    z = torch.cat([f1, f2], 0)
    logits = prec.linear(z, z) / TEMPERATURE
    logits = logits - logits.max().detach()
    eq = (torch.eye(n, device=z.device, dtype=torch.bool) if labels is None
          else labels[:, None] == labels[None, :]).float()
    off = 1.0 - torch.eye(2 * n, device=z.device)
    pos, neg = eq.repeat(2, 2) * off, (1.0 - eq).repeat(2, 2) * off
    e = torch.exp(logits)
    log_frac = logits - torch.log((e * pos).sum(1, keepdim=True) + (e * neg).sum(1, keepdim=True)
                                  + 1e-16)
    return -((log_frac * pos).sum(1) / pos.sum(1).clamp(min=1.0)).mean()


# --- optimizer -------------------------------------------------------------

class Schedule:
    """Linear warm-up from ``lr`` to ``lr * multiplier`` over ``warmup``
    epochs, then a cosine to ``eta_min`` over the rest, counted in steps;
    update ``t`` takes the value at ``t - 1``."""

    def __init__(self, *, lr: float, multiplier: float, warmup: int, max_epoch: int,
                 steps_per_epoch: int, eta_min: float = 1e-7):
        self.base, self.peak, self.eta_min = lr, lr * multiplier, eta_min
        self.warm = max(warmup * steps_per_epoch, 1)
        self.rest = max((max_epoch - warmup) * steps_per_epoch, 1)

    def __call__(self, count: int) -> float:
        if count < self.warm:
            return self.base + (self.peak - self.base) * count / self.warm
        t = min(count - self.warm, self.rest)
        alpha = self.eta_min / max(self.peak, 1e-30)
        return self.peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / self.rest)) + alpha)


def radam_scalars(t: int, b1: float = 0.9, b2: float = 0.999):
    """(rho, r, 1/(1-b1^t), 1/(1-b2^t)) of update ``t``, rho and r rounded
    in float32 where optax rounds them."""
    f32 = np.float32
    b2t = f32(np.float64(f32(b2)) ** t)
    ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
    ro = ro_inf - f32(2 * t) * b2t / (f32(1.0) - b2t)
    r = (np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * ro_inf
                 / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)) if ro > 4.0 else f32(0.0))
    return float(ro), float(r), 1.0 / (1.0 - b1 ** t), 1.0 / (1.0 - b2 ** t)


class RAdam:
    """``g += wd * p``; first and second moments; a rectified step
    ``-lr * r * mu_hat / (sqrt(nu_hat) + eps)`` once rho >= 5, else
    ``-lr * mu_hat``."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Schedule, *,
                 weight_decay: float, eps: float = 1e-8, b1: float = 0.9, b2: float = 0.999):
        self.params, self.schedule = params, schedule
        self.wd, self.eps, self.b1, self.b2 = weight_decay, eps, b1, b2
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        lr = self.schedule(self.t - 1)
        ro, r, mu_scale, nu_scale = radam_scalars(self.t, self.b1, self.b2)
        for k, p in self.params.items():
            g = p.grad + self.wd * p if self.wd else p.grad
            self.mu[k].lerp_(g, 1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            if ro >= 5.0:
                upd = self.mu[k] / ((self.nu[k] * nu_scale).sqrt() + self.eps)
                p.add_(upd * (-lr * r * mu_scale))
            else:
                p.add_(self.mu[k] * (-lr * mu_scale))
            p.grad = None


def make_optimizer(params: Dict[str, torch.Tensor], config: dict) -> RAdam:
    optim, sched, trainer = config["Optim"], config["Scheduler"], config["Trainer"]
    if str(optim["name"]).lower() != "radam" or sched.get("name", "cosine") != "cosine":
        raise NotImplementedError("the reference has RAdam with the cosine warm-up schedule")
    schedule = Schedule(lr=float(optim["lr"]), multiplier=float(sched["multiplier"]),
                        warmup=int(sched["warmup_max"]), max_epoch=int(trainer["max_epoch"]),
                        steps_per_epoch=int(trainer["num_batches"]))
    return RAdam(params, schedule, weight_decay=float(optim.get("weight_decay", 0.0)))


# --- the steps -------------------------------------------------------------

class State:
    """Parameters (leaves that require grad), buffers and the optimizer of
    one reference run; ``heads`` maps a hook name to its parameters."""

    def __init__(self, weights: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                 trainable: Sequence[str], config: dict, prec: Precision):
        self.params = {k: v.detach().clone().float().requires_grad_(k in trainable)
                       for k, v in weights.items()}
        self.buffers = {k: v.detach().clone().float() for k, v in buffers.items()}
        self.opt = make_optimizer({k: self.params[k] for k in trainable}, config)
        self.net = UNet(self.params, self.buffers,
                        momentum=float(config["Arch"].get("momentum", 0.1)), prec=prec)
        self.prec = prec

    def head(self, hook: str) -> Dict[str, torch.Tensor]:
        pre = f"{hook}:"
        return {k[len(pre):]: v for k, v in self.params.items() if k.startswith(pre)}

    def update(self, loss: torch.Tensor) -> None:
        loss.backward()
        self.opt.step()


def semi_draws(g: torch.Generator, *, n_labeled: int, n_unlabeled: int, size: int, crop: int,
               batch_labeled: int, batch_unlabeled: int) -> dict:
    """One ``semi`` step's draws from the device cache's generator, in the
    port's order: labeled batch, unlabeled batch, transform, gammas."""
    return {"labeled": draw_crops(g, n_labeled, size, crop, batch_labeled),
            "unlabeled": draw_crops(g, n_unlabeled, size, crop, batch_unlabeled),
            "geo": draw_geo(g, batch_unlabeled), "gammas": draw_gammas(g, batch_unlabeled)}


def cached_batch(data: dict, d: dict, crop: int) -> tuple:
    """(labeled images, targets, unlabeled images) of a device-cache step."""
    return (crop_at(data["labeled_images"], *d["labeled"], crop)[..., None],
            crop_at(data["labeled_targets"], *d["labeled"], crop),
            crop_at(data["unlabeled_images"], *d["unlabeled"], crop)[..., None])


def host_batch(images: np.ndarray, targets: np.ndarray, idx: Sequence[int], seed: int,
               first_item: int, crop: int, device) -> tuple:
    """(images [B, c, c, 1], targets [B, c, c]) of a host loader's batch:
    uint8 slices scaled by float32 1/255, each item cropped at offsets drawn
    from ``default_rng((seed * 0x9E3779B1 + k) % 2**32)``, ``k`` the item's
    count in the loader's life."""
    ims, tgs = [], []
    for j, i in enumerate(idx):
        rng = np.random.default_rng((seed * 0x9E3779B1 + first_item + j) % 2 ** 32)
        h, w = images[i].shape
        y = int(rng.integers(0, h - crop + 1))
        x = int(rng.integers(0, w - crop + 1))
        ims.append(images[i, y:y + crop, x:x + crop].astype(np.float32) * np.float32(1.0 / 255.0))
        tgs.append(targets[i, y:y + crop, x:x + crop])
    return (torch.from_numpy(np.stack(ims)[..., None]).to(device),
            torch.from_numpy(np.stack(tgs).astype(np.int64)).to(device))


def semi_step(state: State, lab: torch.Tensor, tgt: torch.Tensor, unl: torch.Tensor,
              d: dict, *, num_classes: int, consistency_weight: float) -> float:
    """One two-stage ``semi`` step with the consistency hook on labeled
    images ``lab`` [B, H, W, 1] with targets ``tgt`` and unlabeled ``unl``
    -> its total loss."""
    logits, _ = state.net(lab)
    unl_tf = warp(gamma(unl, d["gammas"]), d["geo"], order=0)
    u_logits, _ = state.net(torch.cat([unl, unl_tf], 0))
    n = unl.shape[0]
    prob_tf = torch.softmax(warp(u_logits[:n], d["geo"], order=0), -1).detach()
    cons = torch.mean((prob_tf - torch.softmax(u_logits[n:], -1)) ** 2)
    total = kl_onehot(torch.softmax(logits, -1), tgt, num_classes) + consistency_weight * cons
    state.update(total)
    return float(total.detach())


class InfoNCESpec(NamedTuple):
    name: str                 # the hook's name
    layer: str                # tapped layer
    weight: float
    contrast_on: str          # "partition" or "self"
    grid: Optional[Tuple[int, int]]   # None: an encoder hook


def pretrain_draws(g: torch.Generator, *, size: int, crop: int, batch: int,
                   color_jitter: float, grids: Sequence[Tuple[int, int]]) -> dict:
    """One pretrain step's draws, in the port's order: crop offsets, the two
    views' geometry and gammas, their colour jitter, the hooks' transform and
    its gamma, then the points of each grid."""
    _, oy, ox = draw_crops(g, None, size, crop, batch)
    d = {"oy": oy, "ox": ox, "g1": draw_geo(g, batch), "gammas1": draw_gammas(g, batch),
         "g2": draw_geo(g, batch), "gammas2": draw_gammas(g, batch)}

    def jit():
        if color_jitter <= 0:
            return None
        lo, hi = 1.0 - color_jitter, 1.0 + color_jitter
        return tuple(lo + (hi - lo) * torch.rand(batch, generator=g, device=g.device)
                     for _ in range(2))

    d["jitter1"], d["jitter2"] = jit(), jit()
    d["geo"], d["gammas_int"] = draw_geo(g, batch), draw_gammas(g, batch)
    d["points"] = {tuple(gr): draw_points(g, batch, tuple(gr)) for gr in grids}
    return d


def pretrain_step(state: State, images: torch.Tensor, partition: torch.Tensor,
                  idx: torch.Tensor, d: dict, *, crop: int, until: str,
                  hooks: Sequence[InfoNCESpec]) -> float:
    """Two views of the slices ``idx``, one forward over both cut at
    ``until``, the InfoNCE hooks' summed loss, the update -> the loss."""
    image = crop_at(images, idx, d["oy"], d["ox"], crop)[..., None]
    v1 = gamma(warp(image, d["g1"], order=0), d["gammas1"])
    v2 = gamma(warp(image, d["g2"], order=0), d["gammas2"])
    if d["jitter1"] is not None:
        v1, v2 = jitter(v1, *d["jitter1"]), jitter(v2, *d["jitter2"])
    v2 = warp(gamma(v2, d["gammas_int"]), d["geo"], order=0)
    n = image.shape[0]
    _, taps = state.net(torch.cat([v1, v2], 0), until=until, taps=[h.layer for h in hooks])
    total = image.new_zeros(())
    labels = partition[idx]
    for h in hooks:
        feat = taps[h.layer]
        both = torch.cat([warp(feat[:n], d["geo"], order=0), feat[n:]], 0)
        p = state.head(h.name)
        if h.grid is None:
            proj = encoder_head(p, both, state.prec)
            f1, f2, lab = proj[:n], proj[n:], labels if h.contrast_on == "partition" else None
        else:
            proj = dense_head(p, both, h.grid, state.prec)
            ys, xs = d["points"][h.grid]
            b = torch.arange(n, device=proj.device)[:, None]
            f1 = proj[:n][b, ys, xs].reshape(-1, proj.shape[-1])
            f2 = proj[n:][b, ys, xs].reshape(-1, proj.shape[-1])
            lab = None
        total = total + h.weight * sup_con(f1, f2, lab, state.prec)
    state.update(total)
    return float(total.detach())


def random_order(n: int, seed: int):
    """The endless stream of a shuffled sampler: one permutation of
    ``range(n)`` after another from numpy's generator of ``seed``."""
    rng = np.random.default_rng(seed)
    while True:
        yield from rng.permutation(n).tolist()


def batches_of(stream, size: int) -> List[int]:
    return [next(stream) for _ in range(size)]


def partition_index(cur: int, max_len: int, partition_num: int) -> int:
    """Anatomical partition of slice ``cur`` of a scan of ``max_len`` slices."""
    cut = max(max_len // partition_num, 1)
    if partition_num > 3:
        part = cur // (cut + 1)
    elif cur <= cut - 1:
        part = 0
    elif cur <= 2 * cut:
        part = 1
    else:
        part = 2
    return min(part, partition_num - 1)
