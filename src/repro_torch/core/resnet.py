"""ResNet-CIFAR family for the paper-faithful reproduction (§IV). Port of
``repro/core/resnet.py``.

The paper evaluates on ResNet-20/CIFAR-100. No dataset or pretrained
weights are available offline, so the reproduction trains the same
ResNet-20 topology from scratch as the "GPU teacher" on a procedurally
generated classification task, then runs the paper's protocol: drift ->
accuracy drop -> feature-based DoRA calibration against LoRA and
backprop (``core/repro_experiments.py``).

Architecture: conv3x3(width) -> 3 stages x n blocks (width x 1, 2, 4,
stride 2 between stages) -> global average pool -> fc; depth = 6n + 2.
Parameter trees keep the reference's layout and names (``stem``,
``stem_bn``, ``blocks`` of ``conv1``/``bn1``/``conv2``/``bn2`` and, where
the shape changes, ``proj``/``proj_bn``, then ``fc``), weights HWIO,
activations NHWC, so ``interop.from_reference`` carries a reference tree
across. Every conv/fc weight is RRAM-resident (leaf name "w"); BatchNorm
is the reference's own (population variance, running statistics
``0.9 * old + 0.1 * batch``), not ``nn.BatchNorm2d``'s.

Every function that draws takes the draws as an optional argument (so a
test passes the reference's and compares bitwise) or else a
``torch.Generator``. On the card the convs must run in f32:
``f32_convs()`` turns cuDNN's TF32 off for a scope (the entry points
enter it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import dora
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import make_generator

TEMPLATE_SEED = 1234   # the class templates' own stream (the reference's PRNGKey(1234))


@dataclasses.dataclass(frozen=True)
class ResnetConfig:
    depth: int = 20  # 6n+2
    width: int = 16
    classes: int = 100
    image_size: int = 32
    adapter: AdapterConfig = AdapterConfig(rank=2, kind="dora")

    @property
    def n_blocks(self) -> int:
        if (self.depth - 2) % 6:
            raise ValueError(f"depth must be 6n + 2, got {self.depth}")
        return (self.depth - 2) // 6


@contextlib.contextmanager
def f32_convs():
    """cuDNN convs and cuBLAS matmuls in IEEE f32 (TF32 off) inside the
    scope, restored after. cuDNN's TF32 is on by default."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def block_stride(cfg: ResnetConfig, block_idx: int) -> int:
    """2 at each stage boundary after the first stage, 1 otherwise."""
    stage, b = divmod(block_idx, cfg.n_blocks)
    return 2 if (stage > 0 and b == 0) else 1


def _bn_init(c, device):
    def full(v):
        return torch.full((c,), v, dtype=torch.float32, device=device)

    return {"scale": full(1.0), "bias": full(0.0), "mean": full(0.0), "var": full(1.0)}


def conv_shapes(cfg: ResnetConfig) -> Dict[str, Tuple[int, ...]]:
    """Every RRAM weight's path and shape, in the reference's draw order."""
    shapes = {"stem/w": (3, 3, 3, cfg.width)}
    cin = cfg.width
    for stage, cout in enumerate((cfg.width, cfg.width * 2, cfg.width * 4)):
        for b in range(cfg.n_blocks):
            i = stage * cfg.n_blocks + b
            shapes[f"blocks/{i}/conv1/w"] = (3, 3, cin, cout)
            shapes[f"blocks/{i}/conv2/w"] = (3, 3, cout, cout)
            if block_stride(cfg, i) != 1 or cin != cout:
                shapes[f"blocks/{i}/proj/w"] = (1, 1, cin, cout)
            cin = cout
    shapes["fc/w"] = (cin, cfg.classes)
    return shapes


def init_resnet(generator: Optional[torch.Generator], cfg: ResnetConfig, *,
                normals: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """He-normal convs (``sqrt(2 / fan_in)``), fc ``cin ** -0.5``, BN at
    identity. ``normals`` maps each path of ``conv_shapes`` to its N(0, 1)
    draws; else they come from ``generator``, in that order."""
    device = (next(iter(normals.values())).device if normals is not None
              else generator.device)
    ws = {}
    for path, shape in conv_shapes(cfg).items():
        n = (normals[path].to(torch.float32) if normals is not None else
             torch.randn(shape, generator=generator, device=device, dtype=torch.float32))
        if len(shape) == 2:   # fc
            ws[path] = n * (shape[0] ** -0.5)
        else:
            ws[path] = n * math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
    base: Dict = {"stem": {"w": ws["stem/w"]}, "stem_bn": _bn_init(cfg.width, device)}
    blocks = []
    for i in range(3 * cfg.n_blocks):
        blk = {}
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("proj", "proj_bn")):
            w = ws.get(f"blocks/{i}/{conv}/w")
            if w is not None:
                blk[conv] = {"w": w}
                blk[bn] = _bn_init(w.shape[-1], device)
        blocks.append(blk)
    base["blocks"] = blocks
    base["fc"] = {"w": ws["fc/w"]}
    return base


def init_adapters(generator: Optional[torch.Generator], base: Dict, cfg: ResnetConfig,
                  *, uniforms: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """DoRA/LoRA side-cars mirroring every conv/fc weight, M from
    ``base`` (the drifted student). ``uniforms`` maps each adapter's path
    ("stem", "blocks/0/conv1", ..., "fc") to A's U(0, 1) draws."""
    acfg = cfg.adapter

    def draws(path):
        return uniforms[path] if uniforms is not None else None

    def conv_ad(path, w):
        kh, kw, cin, cout = w.shape
        return dora.init_conv_adapter(generator, kh, kw, cin, cout, acfg, w,
                                      uniforms=draws(path))

    ad: Dict = {"stem": conv_ad("stem", base["stem"]["w"]), "blocks": []}
    for i, blk in enumerate(base["blocks"]):
        ad["blocks"].append({name: conv_ad(f"blocks/{i}/{name}", blk[name]["w"])
                             for name in ("conv1", "conv2", "proj") if name in blk})
    d, c = base["fc"]["w"].shape
    ad["fc"] = dora.init_adapter(generator, d, c, acfg, w_base=base["fc"]["w"],
                                 uniforms=draws("fc"))
    return ad


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _bn(x, p, training: bool, momentum=0.9):
    if training:
        mean = torch.mean(x, dim=(0, 1, 2))
        var = torch.mean(torch.square(x - mean), dim=(0, 1, 2))  # ddof 0, as jnp.var
        new_stats = (momentum * p["mean"] + (1 - momentum) * mean,
                     momentum * p["var"] + (1 - momentum) * var)
    else:
        mean, var = p["mean"], p["var"]
        new_stats = (p["mean"], p["var"])
    y = (x - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return y, new_stats


def _conv(x, base, adapter, acfg, stride=1):
    if adapter:
        return dora.adapted_conv_forward(x, base["w"], adapter, acfg, stride=(stride, stride))
    return dora.conv2d_nhwc(x, base["w"].to(x.dtype), (stride, stride))


def forward(
    base: Dict,
    images: torch.Tensor,  # (B, H, W, 3)
    cfg: ResnetConfig,
    *,
    adapters: Optional[Dict] = None,
    training_bn: bool = False,
    collect_features: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    """``(logits, aux)``: ``aux["features"]`` holds every conv output
    (NHWC) and the logits when collecting; ``aux["bn_stats"]`` the
    running statistics, updated from the batch when ``training_bn``."""
    acfg = cfg.adapter
    ad = adapters or {}
    feats: List[torch.Tensor] = []
    new_bn: Dict = {}

    h = _conv(images, base["stem"], ad.get("stem"), acfg)
    if collect_features:
        feats.append(h)
    h, new_bn["stem_bn"] = _bn(h, base["stem_bn"], training_bn)
    h = torch.relu(h)
    new_bn["blocks"] = []
    for i, blk in enumerate(base["blocks"]):
        abk = ad["blocks"][i] if ad else {}
        stride = block_stride(cfg, i)
        y = _conv(h, blk["conv1"], abk.get("conv1"), acfg, stride)
        if collect_features:
            feats.append(y)
        y, s1 = _bn(y, blk["bn1"], training_bn)
        y = torch.relu(y)
        y = _conv(y, blk["conv2"], abk.get("conv2"), acfg)
        if collect_features:
            feats.append(y)
        y, s2 = _bn(y, blk["bn2"], training_bn)
        sc = h
        stats = {"bn1": s1, "bn2": s2}
        if "proj" in blk:
            sc = _conv(h, blk["proj"], abk.get("proj"), acfg, stride)
            sc, stats["proj_bn"] = _bn(sc, blk["proj_bn"], training_bn)
        h = torch.relu(y + sc)
        new_bn["blocks"].append(stats)
    h = torch.mean(h, dim=(1, 2))
    if ad.get("fc"):
        logits = dora.adapted_forward(h, base["fc"]["w"], ad["fc"], acfg)
    else:
        logits = h @ base["fc"]["w"]
    if collect_features:
        feats.append(logits)
    return logits, {"features": feats, "bn_stats": new_bn}


def apply_bn_stats(base: Dict, bn_stats: Dict) -> Dict:
    """A new tree whose BN ``mean``/``var`` are ``bn_stats``' (detached);
    every other leaf is ``base``'s own tensor."""
    def bn(p, stats):
        m, v = stats
        return dict(p, mean=m.detach(), var=v.detach())

    out = dict(base, stem_bn=bn(base["stem_bn"], bn_stats["stem_bn"]))
    out["blocks"] = [dict(blk, **{name: bn(blk[name], s) for name, s in stats.items()})
                     for blk, stats in zip(base["blocks"], bn_stats["blocks"])]
    return out


# ---------------------------------------------------------------------------
# procedural dataset (offline stand-in for CIFAR; see module docstring)
# ---------------------------------------------------------------------------


def procedural_dataset(
    generator: Optional[torch.Generator], n: int, cfg: ResnetConfig, noise: float = 0.35,
    *, draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class = a fixed random 8x8 template upsampled (nearest) to
    ``image_size``; sample = its template rolled by a jitter shift in
    [-2, 2] on each axis, plus ``noise`` times Gaussian noise. Returns
    (images (n, H, W, 3) f32, labels (n,) int64).

    The templates come from their own stream (``TEMPLATE_SEED``), so
    separate train and test draws share their classes; labels, shifts
    and noise from ``generator``. ``draws`` gives all four instead:
    ``templates`` (classes, 8, 8, 3), ``labels`` (n,), ``shifts`` (n, 2)
    and ``noise`` (n, H, W, 3) N(0, 1)."""
    size = cfg.image_size
    if size % 8:
        raise ValueError(f"image_size must be a multiple of 8, got {size}")
    if draws is None:
        device = generator.device
        kw = dict(generator=generator, device=device)
        tg = make_generator(device, TEMPLATE_SEED)
        draws = {
            "templates": torch.randn((cfg.classes, 8, 8, 3), generator=tg, device=device),
            "labels": torch.randint(0, cfg.classes, (n,), **kw),
            "shifts": torch.randint(-2, 3, (n, 2), **kw),
            "noise": torch.randn((n, size, size, 3), **kw),
        }
    f = size // 8  # nearest-neighbour resize by an integer factor: a repeat
    temps = draws["templates"].to(torch.float32)
    temps = temps.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
    labels = draws["labels"].to(torch.int64)
    shifts = draws["shifts"].to(torch.int64)
    ar = torch.arange(size, device=labels.device)
    rows = (ar[None, :] - shifts[:, :1]) % size
    cols = (ar[None, :] - shifts[:, 1:]) % size
    imgs = temps[labels[:, None, None], rows[:, :, None], cols[:, None, :]]
    imgs = imgs + noise * draws["noise"].to(torch.float32)
    return imgs, labels


@torch.no_grad()
def accuracy(base, images, labels, cfg, *, adapters=None, batch=256) -> float:
    hits = torch.zeros((), dtype=torch.int64, device=images.device)
    for i in range(0, images.shape[0], batch):
        logits, _ = forward(base, images[i:i + batch], cfg, adapters=adapters)
        hits += torch.sum(torch.argmax(logits, -1) == labels[i:i + batch])
    return int(hits) / images.shape[0]


def param_count(tree) -> int:
    """Elements over every tensor of ``tree``."""
    return sum(t.numel() for t in tree_lib.tensors(tree))
