"""End-to-end experiment harness for the paper-faithful reproduction.
Port of ``repro/core/repro_experiments.py``.

The protocol of §IV on the ResNet-CIFAR family and procedural data
(``core/resnet.py``): teacher training, drift injection, feature-based
DoRA/LoRA calibration (Algorithm 1 + 2) and the backpropagation
baseline the paper compares against. Every step is eager autograd over
plain PyTorch ops (cuDNN convs on the card; no kernel of the port),
with the port's AdamW. ``_teacher_step``, ``_feature_step`` and
``_backprop_step`` are the loops' single steps.

Streams: ``run_cell(seed=s)`` draws data, teacher, drift, adapters and
the calibration pick from five streams of ``s``
(``rram.make_generator(device, s, tag)``; the drift's per-leaf streams
from ``drift_seed(s)``), as the reference splits its key five ways.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import calibrate, dora, resnet
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.resnet import ResnetConfig
from repro_torch.core.rram import RramConfig, make_generator
from repro_torch.optim.adam import AdamW, adamw_init, adamw_update

# run_cell's five streams, as the reference's split(key, 5)
DATA, TEACHER, DRIFT, ADAPTERS, PICK = range(5)
TEST_SPLIT = 7   # the test set's stream under DATA (the reference's fold_in(k_data, 7))


def drift_seed(seed: int) -> int:
    """The seed of ``make_student``'s per-leaf streams in ``run_cell``."""
    return int(np.random.SeedSequence([seed, DRIFT]).generate_state(1, np.uint32)[0])


def _value_and_grad(fn: Callable, params) -> Tuple[torch.Tensor, object, object]:
    """``(loss, aux, grads)`` of ``fn(params) -> (loss, aux)`` with
    respect to every tensor of ``params``; a leaf the loss does not reach
    gets a zero gradient."""
    leaves = [t.detach().requires_grad_(True) for t in tree_lib.tensors(params)]
    loss, aux = fn(tree_lib.unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_lib.unflatten(params, grads)


def _cross_entropy(logits, y):
    rows = torch.arange(y.shape[0], device=y.device)
    return -torch.mean(torch.log_softmax(logits, dim=-1)[rows, y])


# ---------------------------------------------------------------------------
# teacher training ("DNN trained on GPU", Algorithm 1 line 1)
# ---------------------------------------------------------------------------


def teacher_loss(params: Dict, x, y, cfg: ResnetConfig):
    """Cross-entropy with batch statistics (gradients flow through them);
    ``(loss, bn_stats)``."""
    logits, aux = resnet.forward(params, x, cfg, training_bn=True)
    return _cross_entropy(logits, y), aux["bn_stats"]


def _zero_bn_stat_grads(grads):
    """BN running statistics are not trained: their gradients are zero."""
    return tree_lib.map_with_path(
        lambda path, g: torch.zeros_like(g) if path[-1] in ("mean", "var") else g, grads)


def _teacher_step(params, opt_state, x, y, cfg, opt):
    loss, bn_stats, grads = _value_and_grad(lambda p: teacher_loss(p, x, y, cfg), params)
    params, opt_state = adamw_update(_zero_bn_stat_grads(grads), opt_state, params, opt)
    return resnet.apply_bn_stats(params, bn_stats), opt_state, loss


def train_teacher(
    generator: torch.Generator,
    cfg: ResnetConfig,
    images: torch.Tensor,
    labels: torch.Tensor,
    *,
    epochs: int = 12,
    batch: int = 128,
    lr: float = 1e-3,
) -> Dict:
    """Init from ``generator``, then ``epochs`` passes of AdamW over
    random permutations (from ``generator``) in ``n // batch`` steps."""
    base = resnet.init_resnet(generator, cfg)
    opt = AdamW(lr=lr)
    opt_state = adamw_init(base)
    n = images.shape[0]
    steps_per_epoch = max(1, n // batch)
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator, device=generator.device)
        for s in range(steps_per_epoch):
            idx = perm[s * batch:(s + 1) * batch]
            base, opt_state, _ = _teacher_step(base, opt_state, images[idx], labels[idx],
                                               cfg, opt)
    return base


# ---------------------------------------------------------------------------
# drift injection (the "deployment" event)
# ---------------------------------------------------------------------------


def make_student(base: Dict, relative_drift: float, seed: int, *,
                 noise: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None
                 ) -> Dict:
    """Program + drift every RRAM leaf, read back as f32 (``mode=
    "dequant"``, the reference's default). A conv leaf is programmed per
    tap: its scale is the absmax over ``cin`` of each (kh, kw, :, cout).
    ``noise`` maps each RRAM path ("stem/w", ...) to its drift normals
    ``(n_pos, n_neg)`` of the leaf's shape; else each leaf draws from
    ``make_generator(device, seed, crc32(path), 0)``."""
    rcfg = RramConfig(relative_drift=relative_drift)
    return calibrate.program_model(base, rcfg, seed, mode="dequant", noise=noise)


# ---------------------------------------------------------------------------
# feature-based calibration (Algorithm 1 over the whole net, layer-local)
# ---------------------------------------------------------------------------


def calibration_loss_resnet(teacher: Dict, student: Dict, adapters: Dict,
                            images: torch.Tensor, cfg: ResnetConfig) -> torch.Tensor:
    """Interleaved teacher/student walk: every student conv sees the
    TEACHER's input activation, so per-conv MSE gradients never cross
    layers — Algorithm 1 as one step."""
    acfg = cfg.adapter

    def pair_conv(h_t, tb, sb, ad, stride=1):
        t_out = resnet._conv(h_t, tb, None, acfg, stride)
        s_out = resnet._conv(h_t, sb, ad, acfg, stride)
        d = (t_out - s_out).to(torch.float32)
        return t_out, torch.mean(d * d)

    h, loss = pair_conv(images, teacher["stem"], student["stem"], adapters["stem"])
    h, _ = resnet._bn(h, teacher["stem_bn"], False)
    h = torch.relu(h)
    for i, tblk in enumerate(teacher["blocks"]):
        sblk = student["blocks"][i]
        ablk = adapters["blocks"][i]
        stride = resnet.block_stride(cfg, i)
        y, l1 = pair_conv(h, tblk["conv1"], sblk["conv1"], ablk.get("conv1"), stride)
        loss = loss + l1
        y, _ = resnet._bn(y, tblk["bn1"], False)
        y = torch.relu(y)
        y2, l2 = pair_conv(y, tblk["conv2"], sblk["conv2"], ablk.get("conv2"))
        loss = loss + l2
        y2, _ = resnet._bn(y2, tblk["bn2"], False)
        sc = h
        if "proj" in tblk:
            sc, lp = pair_conv(h, tblk["proj"], sblk["proj"], ablk.get("proj"), stride)
            loss = loss + lp
            sc, _ = resnet._bn(sc, tblk["proj_bn"], False)
        h = torch.relu(y2 + sc)
    feat = torch.mean(h, dim=(1, 2))
    t_log = feat @ teacher["fc"]["w"]
    s_log = dora.adapted_forward(feat, student["fc"]["w"], adapters["fc"], acfg)
    d = (t_log - s_log).to(torch.float32)
    return loss + torch.mean(d * d)


def _feature_step(teacher, student, adapters, opt_state, x, cfg, opt):
    loss, _, grads = _value_and_grad(
        lambda a: (calibration_loss_resnet(teacher, student, a, x, cfg), None), adapters)
    adapters, opt_state = adamw_update(grads, opt_state, adapters, opt)
    return adapters, opt_state, loss


def feature_calibrate(
    teacher: Dict,
    student: Dict,
    adapters: Dict,
    images: torch.Tensor,
    cfg: ResnetConfig,
    *,
    epochs: int = 20,
    batch: int = 1,
    lr: float = 2e-3,
) -> Tuple[Dict, list]:
    """Paper setting: batch 1 over the calibration set, 20 epochs. Only
    the adapters train; ``(adapters, mean loss per epoch)``."""
    opt = AdamW(lr=lr)
    opt_state = adamw_init(adapters)
    n = images.shape[0]
    bs = min(batch, n) if batch else n
    losses = []
    for _ in range(epochs):
        epoch = []
        for i in range(0, n, bs):
            adapters, opt_state, loss = _feature_step(teacher, student, adapters, opt_state,
                                                      images[i:i + bs], cfg, opt)
            epoch.append(loss)
        losses.append(sum(torch.stack(epoch).tolist()) / max(1, n // bs))
    return adapters, losses


# ---------------------------------------------------------------------------
# backpropagation baseline (§II-B: full fine-tune with CE on the output)
# ---------------------------------------------------------------------------


def backprop_loss(params: Dict, x, y, cfg: ResnetConfig) -> torch.Tensor:
    """Cross-entropy through the whole net, BN in inference mode."""
    logits, _ = resnet.forward(params, x, cfg)
    return _cross_entropy(logits, y)


def _backprop_step(params, opt_state, x, y, cfg, opt):
    loss, _, grads = _value_and_grad(lambda p: (backprop_loss(p, x, y, cfg), None), params)
    params, opt_state = adamw_update(_zero_bn_stat_grads(grads), opt_state, params, opt)
    return params, opt_state, loss


def backprop_calibrate(
    student: Dict,
    images: torch.Tensor,
    labels: torch.Tensor,
    cfg: ResnetConfig,
    *,
    epochs: int = 20,
    batch: int = 1,
    lr: float = 1e-4,
) -> Tuple[Dict, int]:
    """Traditional retraining: every weight updates (each step would be
    an RRAM write-and-verify pass in the field). ``(params, updates)``."""
    opt = AdamW(lr=lr)
    opt_state = adamw_init(student)
    n = images.shape[0]
    bs = min(batch, n) if batch else n
    updates = 0
    for _ in range(epochs):
        for i in range(0, n, bs):
            student, opt_state, _ = _backprop_step(student, opt_state, images[i:i + bs],
                                                   labels[i:i + bs], cfg, opt)
            updates += 1
    return student, updates


# ---------------------------------------------------------------------------
# one full experiment cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReproResult:
    teacher_acc: float
    drifted_acc: float
    calibrated_acc: float
    method: str
    samples: int
    rank: int
    drift: float
    trainable_fraction: float


def cell_data(seed: int, cfg: ResnetConfig, device, n_train: int = 2048, n_test: int = 1024):
    """``(train_x, train_y, test_x, test_y)`` of ``run_cell``'s DATA stream."""
    train = resnet.procedural_dataset(make_generator(device, seed, DATA), n_train, cfg)
    test = resnet.procedural_dataset(make_generator(device, seed, DATA, TEST_SPLIT),
                                     n_test, cfg)
    return train + test


def run_cell(
    *,
    seed: int = 0,
    cfg: Optional[ResnetConfig] = None,
    method: str = "dora",  # 'dora' | 'lora' | 'backprop'
    rank: int = 2,
    drift: float = 0.20,
    samples: int = 10,
    calib_epochs: int = 20,
    teacher: Optional[Dict] = None,
    data=None,
    device="cuda",
) -> ReproResult:
    """Teacher -> drift -> calibrate -> evaluate, one cell of the paper's
    tables, on ``device`` (the card unless asked), with TF32 off."""
    from repro_torch.deploy.deployment import resolve_device

    device = resolve_device(device)
    cfg = cfg or ResnetConfig()
    if method in ("dora", "lora"):
        cfg = dataclasses.replace(cfg, adapter=AdapterConfig(rank=rank, kind=method))
    with resnet.f32_convs():
        train_x, train_y, test_x, test_y = (cell_data(seed, cfg, device) if data is None
                                            else data)
        if teacher is None:
            teacher = train_teacher(make_generator(device, seed, TEACHER), cfg,
                                    train_x, train_y)
        teacher_acc = resnet.accuracy(teacher, test_x, test_y, cfg)
        student = make_student(teacher, drift, drift_seed(seed))
        drifted_acc = resnet.accuracy(student, test_x, test_y, cfg)
        pick_g = make_generator(device, seed, PICK)
        pick = torch.randperm(train_x.shape[0], generator=pick_g, device=device)[:samples]
        cal_x, cal_y = train_x[pick], train_y[pick]
        n_total = resnet.param_count(teacher)
        if method == "backprop":
            student2, _ = backprop_calibrate(student, cal_x, cal_y, cfg, epochs=calib_epochs)
            acc = resnet.accuracy(student2, test_x, test_y, cfg)
            frac = 1.0
        else:
            adapters = resnet.init_adapters(make_generator(device, seed, ADAPTERS), student,
                                            cfg)
            adapters, _ = feature_calibrate(teacher, student, adapters, cal_x, cfg,
                                            epochs=calib_epochs)
            acc = resnet.accuracy(student, test_x, test_y, cfg, adapters=adapters)
            frac = resnet.param_count(adapters) / n_total
    return ReproResult(teacher_acc=teacher_acc, drifted_acc=drifted_acc, calibrated_acc=acc,
                       method=method, samples=samples, rank=rank, drift=drift,
                       trainable_fraction=frac)
