"""BiRefNet fine-tuning step (counterpart of
dlimgedit_tpu/train/birefnet_step.py): pixel BCE and smoothed soft IoU on
the full-resolution logits (upstream BiRefNet weights them 30 : 0.5),
applied to exactly the graph ``segment_objects`` serves, so a fine-tuned
model serves unchanged. The model holds the float32 masters; the step
follows train/step.py (leaves, full precision, AdamW in place). Over a
('dp',) or ('dp', 'sp') mesh (``place_birefnet_train_state``) it is
train/step.py's mesh step with the parameters replicated; with 'sp' each
dp row's images and masks arrive as canvas-row bands over the row's
devices, the forward runs on them (parallel/spatial.py) with each band's
device on a replica bound to the row's leaves (``.to`` its device, so
autograd sums every band's gradient onto those leaves in float32), and
the loss runs on the logits gathered to the row's first device, as the
dense loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models.birefnet import BiRefNetConfig, birefnet_apply
from ..parallel import spatial
from ..parallel.mesh import P, replica
from .step import (
    _on,
    adamw_init,
    adamw_update,
    call_with,
    is_placed,
    learning_rate_schedule,
    leaves,
    loss_and_grads,
    mesh_loss_and_grads,
    place_train_state,
    remat_call,
    shadow,
    sigmoid_bce,
    sync_rows,
)

__all__ = ["BiRefNetTrainConfig", "birefnet_loss", "init_birefnet_train_state",
           "make_birefnet_train_step", "place_birefnet_train_state"]


@dataclass(frozen=True)
class BiRefNetTrainConfig:
    learning_rate: float = 1e-5  # fine-tune scale: the backbone is pretrained
    weight_decay: float = 0.01
    bce_weight: float = 30.0  # upstream BiRefNet's loss config (lambdas_pix)
    iou_weight: float = 0.5
    # The schedule of train/step.py's TrainConfig.
    warmup_steps: int = 0
    decay_steps: int = 0
    # Recompute the forward's activations in the backward pass.
    remat: bool = False
    # "bfloat16": bf16 shadows of the float32 masters for the forward and
    # backward; gradients return in float32.
    compute_dtype: str = "float32"


def _soft_iou_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 - (inter + 1) / (union + 1) on the sigmoid probabilities, per
    image: the +1 makes a correct near-zero prediction on an empty target
    a loss near 0 (the unsmoothed ratio is 0 / 0)."""
    p = torch.sigmoid(logits)
    inter = torch.sum(p * targets, dim=(-3, -2, -1))
    union = (torch.sum(p, dim=(-3, -2, -1))
             + torch.sum(targets, dim=(-3, -2, -1)) - inter)
    return torch.mean(1.0 - (inter + 1.0) / (union + 1.0))


def birefnet_loss(model: nn.Module, cfg: BiRefNetConfig, batch: Dict,
                  tcfg: BiRefNetTrainConfig = BiRefNetTrainConfig(),
                  params: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: images (B, S, S, 3) ImageNet-normalised, masks (B, S, S) in
    [0, 1] (soft targets are fine). ``params``: leaves to use in place of
    the model's."""
    params = leaves(model) if params is None else params
    images, masks = batch["images"], batch["masks"]
    banded = isinstance(images, spatial.Bands)
    if banded:  # a ('dp', 'sp') row: its canvas rows over its devices
        masks = spatial.gather(masks, images.devices[0])
    else:
        batch = _on(model, batch)
        images, masks = batch["images"], batch["masks"]
    if tcfg.compute_dtype == "bfloat16":
        params = shadow(params, torch.bfloat16)
        images = (spatial.local(lambda i, v: v.to(torch.bfloat16), images)
                  if banded else images.to(torch.bfloat16))

    if banded:
        def run(p, x):
            return spatial.gather(_band_logits(model, cfg, p, x),
                                  x.devices[0])
    else:
        def run(p, x):
            return call_with(model, p, lambda m, y: birefnet_apply(m, y, cfg),
                             x)
    logits = remat_call(run, params, images, tcfg.remat).float()
    targets = masks.float()[..., None]
    bce = torch.mean(sigmoid_bce(logits, targets))
    iou = _soft_iou_loss(logits, targets)
    loss = tcfg.bce_weight * bce + tcfg.iou_weight * iou
    return loss, {"bce": bce, "iou": iou}


def _band_logits(model: nn.Module, cfg: BiRefNetConfig,
                 params: Dict[str, torch.Tensor], x: spatial.Bands
                 ) -> spatial.Bands:
    """``birefnet_apply_bands`` with each band's device on a replica of
    ``model`` bound to ``params`` moved there (differentiably): one
    functional call nested inside the other, a device each."""
    devices = list(dict.fromkeys(x.devices))

    def nest(k, bound):
        if k == len(devices):
            return spatial.birefnet_apply_bands(
                spatial.PerBand([bound[d] for d in x.devices]), x, cfg)
        d = devices[k]
        moved = {n: v.to(d) for n, v in params.items()}
        return call_with(replica(model, (d,)), moved,
                         lambda m: nest(k + 1, {**bound, d: m}))

    return nest(0, {})


def init_birefnet_train_state(model: nn.Module,
                              tcfg: BiRefNetTrainConfig = BiRefNetTrainConfig()
                              ) -> Dict:
    """AdamW state over the model's leaves, on its device."""
    return adamw_init(leaves(model), callable(learning_rate_schedule(tcfg)))


def make_birefnet_train_step(cfg: BiRefNetConfig,
                             tcfg: BiRefNetTrainConfig = BiRefNetTrainConfig()):
    """The train step: (model, opt_state, batch) -> (model, opt_state, loss,
    aux), the model's leaves and ``opt_state`` updated in place."""
    schedule = learning_rate_schedule(tcfg)

    def step(model, opt_state, batch):
        placed = is_placed(batch)
        if placed:
            (loss, aux), grads = mesh_loss_and_grads(
                birefnet_loss, model, cfg, batch, tcfg, 1, tp=False)
        else:
            (loss, aux), grads = loss_and_grads(birefnet_loss, model, cfg,
                                                batch, tcfg)
        adamw_update(leaves(model), grads, opt_state, schedule,
                     tcfg.weight_decay)
        if placed:
            sync_rows(model, batch, tp=False)
        return model, opt_state, loss, aux

    return step


def place_birefnet_train_state(model: nn.Module, opt_state: Dict,
                               batch: Dict, mesh, dp_axis: str = "dp",
                               sp_axis: str = "sp"):
    """(model, opt_state, batch) placed for a step over a ('dp',) or
    ('dp', 'sp') mesh: the parameters replicated (each dp row's replica is
    made by the step), ``images`` and ``masks`` P(dp, sp) (batch over dp,
    canvas rows over sp) and every other entry P(dp), as JAX's."""
    axes = tuple(mesh.shape)
    if axes not in ((dp_axis,), (dp_axis, sp_axis)):
        raise ValueError(f"place_birefnet_train_state needs a ({dp_axis!r},) "
                         f"or ({dp_axis!r}, {sp_axis!r}) mesh, got axes "
                         f"{axes}")
    specs = None
    if sp_axis in mesh.shape:
        specs = {"images": P(dp_axis, sp_axis), "masks": P(dp_axis, sp_axis)}
    return place_train_state(model, opt_state, batch, mesh, specs)
