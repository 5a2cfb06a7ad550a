"""SAM fine-tuning step on one device (counterpart of
dlimgedit_tpu/train/step.py): focal + dice loss on the mask logits, MSE on
the predicted IoU, AdamW.

The model (``models/sam.py::Sam``) holds the float32 master weights, and
its trainable leaves are exactly the JAX tree's: the ``state_dict`` entries
(``leaves``), never the non-persistent index buffers (``bias_idxs``,
``rel_pos_idx``). A step runs the losses on detached copies of those
leaves that require gradients (``torch.func.functional_call``), whatever
the model's own ``requires_grad`` flags are, and updates the leaves in
place. The optimizer state is a dict of tensors on the model's device:
``count``, ``mu`` and ``nu`` (one tensor per leaf) and, with a schedule,
``schedule_count``, the leaves of optax's ``adamw`` state in its order.

Over a mesh (``place_train_state``; JAX's step inherits its shardings
from its inputs, the port's from the placed batch): each of this
process's mesh rows runs its part of the batch on its replica of the
model (``parallel/mesh.py::replica``; tensor-parallel over the row when tp
> 1), the rows' gradients are summed on the model's device in row order
and, when the mesh spans processes, over them with ONE all-reduce of the
loss, aux and gradients flattened into one buffer; divided by dp, they
are the global batch's mean, as JAX's. AdamW runs once on the model,
and the rows are brought in step with it. ``accum_steps`` splits each
row's part.

Float32 runs at full precision, the forward and the backward inside
``models/common.py::full_precision`` (PyTorch's TF32 defaults would round
the card's float32 products and convolutions). The models run their plain
paths: no kernel of either package has a backward, so a config that turns
a kernel on is refused.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..errors import DlimgError
from ..models import sam as sam_lib
from ..models.common import full_precision
from ..parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    Sharded,
    batch_sharding,
    put,
    replica_entry,
)
from ..parallel.multihost import all_reduce_sum

__all__ = ["TrainConfig", "adamw_init", "adamw_update", "init_train_state",
           "learning_rate_schedule", "leaves", "loss_and_grads",
           "make_train_step", "mask_loss", "place_train_state"]

# optax.adamw's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    dice_weight: float = 1.0
    focal_weight: float = 20.0
    iou_weight: float = 1.0
    # Linear warmup over `warmup_steps`, then cosine decay over
    # `decay_steps` counted after warmup (0 holds the peak); both 0: a
    # constant lr. A schedule adds `schedule_count` to the optimizer state.
    warmup_steps: int = 0
    decay_steps: int = 0
    # Recompute the encoder's activations in the backward pass
    # (torch.utils.checkpoint) instead of keeping them.
    remat_encoder: bool = False
    # "bfloat16": the encoder runs on bf16 shadows of the float32 masters
    # (and bf16 images); gradients return in float32. The decoder and the
    # loss stay float32.
    encoder_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Leaves, functional calls, gradients
# ---------------------------------------------------------------------------

def leaves(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's leaves of the JAX tree (its ``state_dict`` entries,
    not detached), by dotted path."""
    return dict(module.state_dict(keep_vars=True))


def sub_leaves(params: Dict[str, torch.Tensor], prefix: str
               ) -> Dict[str, torch.Tensor]:
    """The entries of ``params`` under ``prefix.``, with it stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


class _Bound(nn.Module):
    """``fn(module, *args)`` as a module's forward, for functional_call."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def call_with(module: nn.Module, params: Dict[str, torch.Tensor],
              fn: Callable, *args):
    """``fn(module, *args)`` with the module's leaves named in ``params``
    (paths relative to ``module``) replaced by those tensors."""
    return functional_call(_Bound(module, fn),
                           {f"module.{k}": v for k, v in params.items()}, args)


def shadow(params: Dict[str, torch.Tensor], dtype: torch.dtype
           ) -> Dict[str, torch.Tensor]:
    """Differentiable casts of the float32 leaves to ``dtype`` (the
    mixed-precision shadows); other leaves as they are."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def remat_call(run: Callable, params: Dict[str, torch.Tensor],
               x: torch.Tensor, remat: bool):
    """``run(params, x)``; with ``remat`` its activations are recomputed in
    the backward pass instead of kept (the leaves are checkpoint inputs,
    so the recomputation sees the same tensors)."""
    if remat:
        return checkpoint(run, params, x, use_reentrant=False)
    return run(params, x)


def run_encoder(encoder: nn.Module, enc_cfg, params: Dict[str, torch.Tensor],
                images: torch.Tensor, remat: bool) -> torch.Tensor:
    """``encoder(images, enc_cfg)`` on the leaves ``params``."""
    return remat_call(lambda p, x: functional_call(encoder, p, (x, enc_cfg)),
                      params, images, remat)


def plain_paths_only(enc_cfg) -> None:
    """Refuse an encoder config that turns a kernel on: no kernel has a
    backward, so its gradient would be lost on the card."""
    on = [f for f in ("use_fused_norm", "use_flash_attention",
                      "fused_window_blocks") if getattr(enc_cfg, f, False)]
    if on:
        raise DlimgError(f"a train step runs the plain paths (no kernel has a "
                         f"backward): turn off {', '.join(on)} in the "
                         f"encoder config")


def loss_and_grads(loss_fn: Callable, model: nn.Module, *args,
                   params: Optional[Dict[str, torch.Tensor]] = None):
    """((loss, aux), grads): ``loss_fn(model, *args, params=masters)`` and
    its gradient for every leaf of ``params`` (default: ``leaves(model)``),
    zeros where the loss does not reach a leaf, as JAX's tree gradient.
    The masters are detached views of the leaves that require grad; the
    forward and the backward run at full float32 precision."""
    params = leaves(model) if params is None else params
    masters = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with full_precision(), torch.enable_grad():
        loss, aux = loss_fn(model, *args, params=masters)
        grads = torch.autograd.grad(loss, list(masters.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(masters.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), grads


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, in its form."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def _focal_loss(logits, targets, alpha, gamma):
    p = torch.sigmoid(logits)
    ce = sigmoid_bce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return torch.mean(a_t * (1 - p_t) ** gamma * ce)


def _dice_loss(logits, targets, eps=1.0):
    p = torch.sigmoid(logits)
    num = 2 * torch.sum(p * targets, dim=(-2, -1)) + eps
    den = (torch.sum(p, dim=(-2, -1)) + torch.sum(targets, dim=(-2, -1))
           + eps)
    return torch.mean(1 - num / den)


def _on(model: nn.Module, batch: Dict) -> Dict[str, torch.Tensor]:
    device = next(model.parameters()).device
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def mask_loss(model: sam_lib.Sam, cfg: sam_lib.SamConfig, batch: Dict,
              tcfg: TrainConfig = TrainConfig(),
              params: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: images (B, S, S, 3) preprocessed, point_coords (B, 2, 2),
    point_labels (B, 2), masks (B, L, L) binary targets at low
    resolution. ``params``: leaves to use in place of the model's."""
    params = leaves(model) if params is None else params
    batch = _on(model, batch)
    enc = sub_leaves(params, "encoder")
    images = batch["images"]
    if tcfg.encoder_dtype == "bfloat16":
        enc, images = shadow(enc, torch.bfloat16), images.to(torch.bfloat16)
    emb = run_encoder(model.encoder, cfg.encoder_tiny or cfg.encoder_vit, enc, images,
                      tcfg.remat_encoder)
    rest = {k: v for k, v in params.items() if not k.startswith("encoder.")}
    pred, iou_pred = call_with(
        model, rest, lambda m, e, c, l: sam_lib.decode_masks(
            m, cfg, e, c, l, multimask=False),
        emb.float(), batch["point_coords"], batch["point_labels"])
    logits = pred[:, 0]
    targets = batch["masks"].float()
    focal = _focal_loss(logits, targets, tcfg.focal_alpha, tcfg.focal_gamma)
    dice = _dice_loss(logits, targets)
    # The IoU head regresses the actual IoU of the predicted mask.
    pred_bin = (logits > 0).float()
    inter = torch.sum(pred_bin * targets, dim=(-2, -1))
    union = torch.sum(torch.maximum(pred_bin, targets), dim=(-2, -1))
    actual_iou = inter / torch.clamp(union, min=1.0)
    iou_l = torch.mean((iou_pred[:, 0] - actual_iou) ** 2)
    loss = (tcfg.focal_weight * focal + tcfg.dice_weight * dice
            + tcfg.iou_weight * iou_l)
    return loss, {"focal": focal, "dice": dice, "iou_mse": iou_l}


# ---------------------------------------------------------------------------
# Learning-rate schedule and AdamW (optax.adamw with its defaults)
# ---------------------------------------------------------------------------

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def learning_rate_schedule(tcfg=TrainConfig()) -> Schedule:
    """The plain lr, or count -> lr (a float32 tensor) as JAX's: a linear
    warmup from 0 over ``warmup_steps`` (optax.linear_schedule), then a
    cosine over ``decay_steps`` counted after warmup
    (optax.cosine_decay_schedule) or the peak held, joined at the warmup's
    end (optax.join_schedules); a decay-only config starts the cosine at
    the peak. Evaluated at the count before the update: with warmup, step
    0 trains at lr 0. The arithmetic follows optax's, in float32."""
    lr, warm, decay = tcfg.learning_rate, tcfg.warmup_steps, tcfg.decay_steps
    if not (warm or decay):
        return lr

    def tail(count):
        if not decay:
            return torch.full_like(count, lr, dtype=torch.float32)
        c = torch.clamp(count.float(), max=float(decay))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay)))
        return lr * cosine

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        if not warm:
            return tail(count)
        frac = 1 - torch.clamp(count, 0, warm).float() / warm
        ramp = (0.0 - lr) * frac + lr
        return torch.where(count < warm, ramp, tail(count - warm))

    return schedule


def adamw_init(params: Dict[str, torch.Tensor], scheduled: bool) -> Dict:
    """The optimizer state of optax.adamw over ``params``."""
    p0 = next(iter(params.values()))
    state = {"count": torch.zeros((), dtype=torch.int32, device=p0.device),
             "mu": {k: torch.zeros_like(v) for k, v in params.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    if scheduled:
        state["schedule_count"] = torch.zeros((), dtype=torch.int32,
                                              device=p0.device)
    return state


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: Dict,
                 schedule: Schedule, weight_decay: float) -> None:
    """One optax.adamw step (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, weight
    decay on every leaf), in place on ``params`` and ``state``, in optax's
    order of operations:
      mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
      u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
      p = p + (-lr) (u + wd p)
    with lr the schedule at its count before the update. No host sync."""
    keys = list(params)
    p = [params[k] for k in keys]
    g = [grads[k] for k in keys]
    mu = [state["mu"][k] for k in keys]
    nu = [state["nu"][k] for k in keys]
    b1, b2 = ADAM_B1, ADAM_B2
    tmp = torch._foreach_mul(g, 1 - b1)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, tmp)
    tmp = torch._foreach_mul(g, g)
    torch._foreach_mul_(tmp, 1 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, tmp)
    state["count"].add_(1)
    count = state["count"].float()
    u = torch._foreach_div(mu, 1 - b1 ** count)
    den = torch._foreach_div(nu, 1 - b2 ** count)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    torch._foreach_div_(u, den)
    torch._foreach_add_(u, torch._foreach_mul(p, weight_decay))
    if callable(schedule):
        step_size = -schedule(state["schedule_count"]).to(p[0].device)
        state["schedule_count"].add_(1)
    else:
        step_size = -schedule
    torch._foreach_mul_(u, step_size)
    torch._foreach_add_(p, u)


def init_train_state(model: nn.Module, tcfg=TrainConfig()) -> Dict:
    """AdamW state over the model's leaves, on its device."""
    return adamw_init(leaves(model), callable(learning_rate_schedule(tcfg)))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _split(batch: Dict, n: int):
    for v in batch.values():
        if v.shape[0] % n:
            raise DlimgError(f"accum_steps={n} must divide the batch "
                             f"({v.shape[0]})")
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def accumulate(loss_fn: Callable, model: nn.Module, cfg, batch: Dict, tcfg,
               accum_steps: int):
    """((loss, aux), grads) of ``loss_fn`` over the batch, as the mean over
    ``accum_steps`` equal microbatches (each one's activations freed
    before the next): every loss term is a mean, so this is the full
    batch's update."""
    if accum_steps == 1:
        return loss_and_grads(loss_fn, model, cfg, batch, tcfg)
    total = None
    for mb in _split(_on(model, batch), accum_steps):
        (loss, aux), grads = loss_and_grads(loss_fn, model, cfg, mb, tcfg)
        if total is None:
            total = [loss, aux, grads]
            continue
        total[0] = total[0] + loss
        total[1] = {k: total[1][k] + v for k, v in aux.items()}
        torch._foreach_add_(list(total[2].values()), list(grads.values()))
    inv = 1.0 / accum_steps
    loss, aux, grads = total
    torch._foreach_mul_(list(grads.values()), inv)
    return (loss * inv, {k: v * inv for k, v in aux.items()}), grads


def to_device(tree, device):
    """A dict tree of tensors, detached, on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


def place_train_state(model: nn.Module, opt_state: Dict, batch: Dict,
                      mesh: Mesh, specs: Optional[Dict[str, P]] = None):
    """(model, opt_state, batch) placed for a step over ``mesh``: the
    model (the float32 masters) and the optimizer state on this process's
    first mesh device, each batch entry's leading (batch) axis dp-sharded
    (each process keeps its rows), or laid out as ``specs`` names it. The
    step makes each row's replica, with the tensor-parallel rule of
    ``parallel/mesh.py::sam_param_sharding`` when tp > 1."""
    device = mesh.first_device
    model.to(device)
    specs = specs or {}
    batch = {k: put(v, NamedSharding(mesh, specs[k]) if k in specs
                    else batch_sharding(mesh, np.ndim(v)))
             for k, v in batch.items()}
    return model, to_device(opt_state, device), batch


def is_placed(batch: Dict) -> bool:
    return any(isinstance(v, Sharded) for v in batch.values())


def _flat(loss, aux, grads) -> torch.Tensor:
    return torch.cat([loss.reshape(1).float()]
                     + [v.reshape(1).float() for v in aux.values()]
                     + [g.reshape(-1) for g in grads.values()])


def _unflat(flat, loss, aux, grads):
    sizes = [1] * (1 + len(aux)) + [g.numel() for g in grads.values()]
    parts = torch.split(flat, sizes)
    aux = {k: p.reshape(()).to(v.dtype) for (k, v), p in zip(aux.items(),
                                                             parts[1:])}
    grads = {k: p.view_as(g) for (k, g), p in
             zip(grads.items(), parts[1 + len(aux):])}
    return parts[0].reshape(()).to(loss.dtype), aux, grads


def _row_entries(model: nn.Module, mesh: Mesh, tp: bool):
    return [(r, replica_entry(model, devices if tp else devices[:1],
                              tp=tp and len(devices) > 1))
            for r, devices in mesh.rows()]


def mesh_loss_and_grads(loss_fn: Callable, model: nn.Module, cfg,
                        batch: Dict[str, Sharded], tcfg, accum_steps: int,
                        tp: bool):
    """((loss, aux), grads) of ``loss_fn`` over a placed batch, as the
    global batch's mean (see the module docstring); ``tp``: the rows run
    tensor-parallel."""
    mesh = next(iter(batch.values())).mesh
    parts = {k: dict(v.row_parts()) for k, v in batch.items()}
    device = next(model.parameters()).device
    total = None
    for r, entry in _row_entries(model, mesh, tp):
        part = {k: parts[k][r] for k in batch}
        (loss, aux), grads = accumulate(loss_fn, entry.module, cfg, part,
                                        tcfg, accum_steps)
        grads = entry.gather(grads, device)
        loss, aux = loss.to(device), {k: v.to(device) for k, v in aux.items()}
        if total is None:
            total = [loss, aux, grads]
            continue
        total[0] = total[0] + loss
        total[1] = {k: total[1][k] + v for k, v in aux.items()}
        torch._foreach_add_(list(total[2].values()), list(grads.values()))
    loss, aux, grads = total
    if mesh.processes is not None:  # a global mesh: one all-reduce
        loss, aux, grads = _unflat(all_reduce_sum(_flat(loss, aux, grads)),
                                   loss, aux, grads)
    inv = 1.0 / mesh.devices.shape[0]
    torch._foreach_mul_(list(grads.values()), inv)
    return (loss * inv, {k: v * inv for k, v in aux.items()}), grads


def sync_rows(model: nn.Module, batch: Dict[str, Sharded], tp: bool) -> None:
    """Copy the updated masters back to the rows' replicas."""
    _row_entries(model, next(iter(batch.values())).mesh, tp)


def make_train_step(cfg: sam_lib.SamConfig, tcfg: TrainConfig = TrainConfig(),
                    accum_steps: int = 1):
    """The train step: (model, opt_state, batch) -> (model, opt_state, loss,
    aux), the model's leaves and ``opt_state`` updated in place (JAX's
    donation). ``accum_steps > 1`` splits the batch into that many
    microbatches and averages their gradients: the same update as the
    full batch. ``batch`` may hold numpy arrays or tensors; it goes to the
    model's device; a batch from ``place_train_state`` runs over its mesh.
    ``loss`` and ``aux`` stay device tensors."""
    plain_paths_only(cfg.encoder_tiny or cfg.encoder_vit)
    schedule = learning_rate_schedule(tcfg)

    def step(model, opt_state, batch):
        placed = is_placed(batch)
        if placed:
            (loss, aux), grads = mesh_loss_and_grads(
                mask_loss, model, cfg, batch, tcfg, accum_steps, tp=True)
        else:
            (loss, aux), grads = accumulate(mask_loss, model, cfg, batch,
                                            tcfg, accum_steps)
        adamw_update(leaves(model), grads, opt_state, schedule,
                     tcfg.weight_decay)
        if placed:
            sync_rows(model, batch, tp=True)
        return model, opt_state, loss, aux

    return step
