"""The port's SAM train step (dlimgedit_tpu_torch/train/step.py) against the
JAX package's (dlimgedit_tpu/train/step.py), on the CPU in float32: JAX's
seed-0 MobileSAM tree at image size 64 carried across by
``params_from_numpy``, numpy-seeded batches (JAX's
tests/test_train_step.py is the model).

Tolerances:
  * loss and aux: relative 1e-5;
  * each leaf's gradient: relative L2 1e-4 (``_torch_train_util``: a leaf
    whose JAX gradient is zero up to rounding is held against a floor);
  * AdamW against optax.adamw on identical gradients: 1e-6 (absolute and
    relative, parameters and moments) over 3 updates;
  * parameters after 3 whole steps (lr 1e-4, the default): where any
    step's JAX gradient element is below 1e-6 in size, within 1e-6 +
    2 lr x 3 (Adam moves such an element by about +-lr on the sign of its
    mean, which a gradient rounding may flip); the other elements of each
    leaf within relative L2 1e-5, plus 1e-4 of lr x 3 (a leaf that starts
    at zero, as a bias, is the sum of its updates). Per element this does
    not hold: where a gradient changes sign between steps at 1e-6..1e-5
    Adam's mean cancels, and gradients equal to 1e-4 moved such elements
    up to 1.1e-5 apart at lr 1e-3;
  * the learning-rate schedule: equal to JAX's within float32 rounding
    (relative 1e-6) at steps 0..20 for constant, warmup-only, decay-only
    and warmup-then-decay configs.
Also: accum_steps=2 equals the full batch, remat gives the identical loss,
the bf16 policy returns float32 gradients to float32 masters, the
trainable leaves are exactly the JAX tree's, and a config that turns a
kernel on is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_train_util import (
    assert_grads_close,
    flat_port,
    load,
    np_tree,
    rel_close,
    sam_batch,
)
from dlimgedit_tpu.models import sam as jsam
from dlimgedit_tpu.train import step as jstep
from dlimgedit_tpu.utils.pytree_io import flatten_tree
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.models import sam
from dlimgedit_tpu_torch.train import step as pstep

torch.set_num_threads(2)

S, B, STEPS = 64, 4, 3
TCFG = jstep.TrainConfig()
# Gradient elements below this in size at any of the 3 steps may move by
# up to 2 lr a step apart.
SMALL_GRAD = 1e-6


def _port_cfg(tcfg):
    return pstep.TrainConfig(**dataclasses.asdict(tcfg))


@pytest.fixture(scope="module")
def setup():
    jcfg = jsam.make_config("mobile_sam", S)
    jparams = jsam.init_sam(jax.random.PRNGKey(0), jcfg)
    cfg = sam.make_config("mobile_sam", S)
    batch = sam_batch(B, S, jcfg.mask_input_size, seed=0)
    return jcfg, jparams, cfg, batch


def _model(cfg, jparams):
    return load(sam.Sam(cfg), jparams)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX's three steps from the seed-0 tree, split into its jitted
    value_and_grad and its optax update: (losses, auxes, grads, params
    after each step)."""
    jcfg, jparams, _, batch = setup
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.mask_loss(p, jcfg, b, TCFG), has_aux=True))
    opt = jstep.make_optimizer(TCFG)

    @jax.jit
    def update(g, o, p):
        u, o = opt.update(g, o, p)
        return optax.apply_updates(p, u), o

    p, o = jparams, opt.init(jparams)
    out = {"loss": [], "aux": [], "grads": [], "params": []}
    for _ in range(STEPS):
        (loss, aux), g = vg(p, batch)
        p, o = update(g, o, p)
        out["loss"].append(float(loss))
        out["aux"].append({k: float(v) for k, v in aux.items()})
        out["grads"].append(np_tree(g))
        out["params"].append(np_tree(p))
    return out


def test_trainable_leaves_are_the_jax_tree(setup):
    _, jparams, cfg, _ = setup
    model = _model(cfg, jparams)
    model.requires_grad_(False)  # as a serving bundle leaves it
    names = set(pstep.leaves(model))
    assert names == {k.replace("/", ".")
                     for k in flatten_tree(np_tree(jparams))}
    buffers = {n for n, _ in model.named_buffers()}
    assert buffers and not names & {
        n for n in buffers if n.endswith("bias_idxs")}


def test_loss_and_grads_match_jax(setup, jax_steps):
    _, jparams, cfg, batch = setup
    (loss, aux), grads = pstep.loss_and_grads(
        pstep.mask_loss, _model(cfg, jparams), cfg, batch, _port_cfg(TCFG))
    rel_close(loss, jax_steps["loss"][0])
    assert set(aux) == set(jax_steps["aux"][0]) == {"focal", "dice", "iou_mse"}
    for k, v in aux.items():
        rel_close(v, jax_steps["aux"][0][k])
    assert_grads_close(grads, jax_steps["grads"][0])


@pytest.mark.parametrize("schedule", [dict(), dict(warmup_steps=2,
                                                   decay_steps=4)])
def test_adamw_matches_optax_on_identical_gradients(setup, jax_steps,
                                                    schedule):
    """Both optimizers fed JAX's three gradients (one per step): the port's
    parameters and moments equal optax's within 1e-6."""
    _, jparams, cfg, _ = setup
    tcfg = dataclasses.replace(TCFG, **schedule)
    opt = jstep.make_optimizer(tcfg)
    p, o = jparams, opt.init(jparams)
    model = _model(cfg, jparams)
    state = pstep.init_train_state(model, _port_cfg(tcfg))
    sched = pstep.learning_rate_schedule(_port_cfg(tcfg))
    for g in jax_steps["grads"]:
        u, o = opt.update(jax.tree_util.tree_map(jnp.asarray, g), o, p)
        p = optax.apply_updates(p, u)
        grads = params_from_numpy(g)
        pstep.adamw_update(pstep.leaves(model), grads, state, sched,
                           tcfg.weight_decay)
    got, want = flat_port(model), flatten_tree(np_tree(p))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    adam = o[0]
    assert int(state["count"]) == int(adam.count) == STEPS
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        moments = flat_port(state[name])
        for k, v in flatten_tree(np_tree(tree)).items():
            np.testing.assert_allclose(moments[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {k}")
    if schedule:
        assert int(state["schedule_count"]) == int(o[2].count) == STEPS


def test_params_after_three_steps_match_jax(setup, jax_steps):
    _, jparams, cfg, batch = setup
    model = _model(cfg, jparams)
    tcfg = _port_cfg(TCFG)
    state = pstep.init_train_state(model, tcfg)
    step = pstep.make_train_step(cfg, tcfg)
    for i in range(STEPS):
        model, state, loss, _ = step(model, state, batch)
        if i == 0:
            rel_close(loss, jax_steps["loss"][0])
    got = flat_port(model)
    want = flatten_tree(jax_steps["params"][-1])
    small = {k: np.min([np.abs(flatten_tree(g)[k])
                        for g in jax_steps["grads"]], axis=0) < SMALL_GRAD
             for k in want}
    flip = 1e-6 + 2 * TCFG.learning_rate * STEPS
    moved = 1e-4 * TCFG.learning_rate * STEPS
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert np.all(d[small[k]] <= flip), k
        rest = ~small[k]
        assert (np.linalg.norm(d[rest])
                <= 1e-5 * np.linalg.norm(w[rest]) + moved), k


def test_accum_steps_two_equals_the_full_batch(setup):
    _, jparams, cfg, batch = setup
    model = _model(cfg, jparams)
    tcfg = _port_cfg(TCFG)
    (l1, a1), g1 = pstep.accumulate(pstep.mask_loss, model, cfg, batch, tcfg, 1)
    (l2, a2), g2 = pstep.accumulate(pstep.mask_loss, model, cfg, batch, tcfg, 2)
    rel_close(l2, l1)
    for k in a1:
        rel_close(a2[k], a1[k])
    scale = max(float(g.norm()) for g in g1.values())
    for k in g1:
        err = float((g2[k] - g1[k]).norm())
        assert err <= 1e-4 * max(float(g1[k].norm()), 1e-4 * scale), k
    with pytest.raises(DlimgError, match="divide"):
        pstep.accumulate(pstep.mask_loss, model, cfg, batch, tcfg, 3)


def test_remat_gives_the_identical_loss(setup):
    _, jparams, cfg, batch = setup
    half = {k: v[:2] for k, v in batch.items()}
    model = _model(cfg, jparams)
    (l0, _), g0 = pstep.loss_and_grads(pstep.mask_loss, model, cfg, half,
                                       pstep.TrainConfig())
    (l1, _), g1 = pstep.loss_and_grads(pstep.mask_loss, model, cfg, half,
                                       pstep.TrainConfig(remat_encoder=True))
    assert float(l0) == float(l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7)
    assert float(g1["encoder.patch_embed.conv1.w"].abs().sum()) > 0


def test_bf16_policy_returns_f32_grads_to_f32_masters(setup):
    _, jparams, cfg, batch = setup
    half = {k: v[:2] for k, v in batch.items()}
    model = _model(cfg, jparams)
    before = model.encoder.patch_embed.conv1.w.clone()
    (l32, _), _ = pstep.loss_and_grads(pstep.mask_loss, model, cfg, half,
                                       pstep.TrainConfig())
    tcfg = pstep.TrainConfig(encoder_dtype="bfloat16")
    (l16, _), grads = pstep.loss_and_grads(pstep.mask_loss, model, cfg, half,
                                           tcfg)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert abs(float(l16) - float(l32)) / abs(float(l32)) < 0.05
    state = pstep.init_train_state(model, tcfg)
    pstep.make_train_step(cfg, tcfg)(model, state, half)
    assert all(t.dtype == torch.float32 for t in pstep.leaves(model).values())
    assert not torch.equal(model.encoder.patch_embed.conv1.w, before)


@pytest.mark.parametrize("sched", [dict(), dict(warmup_steps=4),
                                   dict(decay_steps=10),
                                   dict(warmup_steps=4, decay_steps=10)],
                         ids=["constant", "warmup", "decay", "both"])
def test_lr_schedule_matches_jax(sched):
    jcfg = jstep.TrainConfig(learning_rate=1e-3, **sched)
    want = jstep.learning_rate_schedule(jcfg)
    got = pstep.learning_rate_schedule(_port_cfg(jcfg))
    if not sched:
        assert got == want == 1e-3
        return
    for step in range(21):
        w = float(want(jnp.int32(step)))
        g = float(got(torch.tensor(step, dtype=torch.int32)))
        assert abs(g - w) <= 1e-6 * abs(w) + 1e-12, (step, g, w)
    if "warmup_steps" in sched:
        assert float(got(torch.tensor(0, dtype=torch.int32))) == 0.0


@pytest.mark.parametrize("flag", ["use_fused_norm", "use_flash_attention"])
def test_a_kernel_config_is_refused(setup, flag):
    _, _, cfg, _ = setup
    enc = dataclasses.replace(cfg.encoder_tiny, **{flag: True})
    with pytest.raises(DlimgError, match="plain paths"):
        pstep.make_train_step(dataclasses.replace(cfg, encoder_tiny=enc))
