"""The port's (dp, tp) mesh tier (dlimgedit_tpu_torch/parallel/mesh.py,
parallel/batch.py over a mesh, the train tier's ``place_*`` functions)
against the JAX package on the CPU, float32, the port's seeded trees
carried to JAX by ``numpy_from_params`` (JAX's own init of MobileSAM
takes ~20 s here) and numpy-seeded inputs. JAX's tests run on 8 virtual
CPU devices; the port's meshes here are explicit device lists: ``[cpu] *
n`` (one object repeated) and n distinct ``torch.device`` objects.
Models: JAX's tests/test_parallel.py, test_distill.py,
test_train_birefnet.py (dp, and dp x sp) and test_train_data.py.

Tolerances (JAX's own tests'):
  * dp and tp ``encode_frames`` against JAX's single-device
    ``encode_image`` of the batch: atol 2e-4, rtol 1e-3; a tp linear
    against the dense product: atol 1e-5 (its row-parallel partial sums
    are the only reassociation);
  * ``segment_frames`` over dp against JAX's ``birefnet_apply``: atol
    3e-4, rtol 1e-3;
  * the sharded SAM train step against JAX's single-device step: loss
    relative 1e-5, each leaf's gradient relative L2 1e-4
    (``_torch_train_util``);
  * ``teacher_embeddings`` over a mesh: atol 2e-5, rtol 1e-4; the
    sharded distillation step's loss relative 1e-5 and gradients relative
    L2 1e-4 against JAX's ``distill_loss`` (tests/test_torch_distill.py's
    tolerances), and loss relative 1e-6, gradients atol 1e-6, rtol 1e-4
    against the port's single-device step (JAX's
    test_distill.py::test_sharded_step_matches_single_device);
  * the BiRefNet dp step (learning rate 1e-3, as JAX's test) against
    JAX's single-device ``make_birefnet_train_step``: loss relative 1e-5,
    every parameter after the step within atol 5e-5, rtol 1e-4 (JAX's
    test_train_birefnet.py::test_sharded_step_matches_single_device).
"""

import dataclasses

import jax
import numpy as np
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
from dlimgedit_tpu.models import birefnet as jbn
from dlimgedit_tpu.models import sam as jsam
from dlimgedit_tpu.models import swin as jswin
from dlimgedit_tpu.models import vit_sam as jvit
from dlimgedit_tpu.parallel import mesh as jmesh
from dlimgedit_tpu.train import birefnet_step as jbstep
from dlimgedit_tpu.train import distill as jdistill
from dlimgedit_tpu.train import step as jstep
from dlimgedit_tpu.utils.pytree_io import flatten_tree
from dlimgedit_tpu_torch.convert.from_numpy import numpy_from_params
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.models import birefnet as bn
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.parallel import batch as pbatch
from dlimgedit_tpu_torch.parallel import mesh as pmesh
from dlimgedit_tpu_torch.runtime import birefnet as rbn
from dlimgedit_tpu_torch.train import birefnet_step, distill
from dlimgedit_tpu_torch.train import step as pstep
from dlimgedit_tpu_torch.train.data import prefetch_to_device

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _devices(n, kind):
    """n CPU devices: one object repeated, or n distinct objects."""
    return [CPU] * n if kind == "repeated" else [torch.device("cpu")
                                                 for _ in range(n)]


def _narrow_vit(mod, size):
    return mod.SamViTConfig(img_size=size, embed_dim=64, depth=2,
                            num_heads=2, window_size=4,
                            global_attn_indexes=(1,))


_SAMS = {}


def _sam(variant, size=64):
    """(JAX config, JAX params, port config, a fresh port model), the JAX
    side made once per variant."""
    if variant not in _SAMS:
        jcfg = jsam.make_config(variant, size)
        cfg = sam.make_config(variant, size)
        if variant == "vit_b":
            jcfg = dataclasses.replace(jcfg,
                                       encoder_vit=_narrow_vit(jvit, size))
            cfg = dataclasses.replace(cfg,
                                      encoder_vit=_narrow_vit(vit_sam, size))
        # The port's seeded init carried to JAX (JAX's own init of
        # MobileSAM takes ~20 s on this CPU; either side's tree is fine).
        jparams = numpy_from_params(sam.init_sam(
            torch.Generator().manual_seed(0), cfg))
        encode = jax.jit(lambda p, x: jsam.encode_image(p, jcfg, x))
        _SAMS[variant] = (jcfg, jparams, cfg, encode)
    jcfg, jparams, cfg, encode = _SAMS[variant]
    return jcfg, jparams, cfg, load(sam.Sam(cfg), jparams), encode


FRAMES = np.random.default_rng(0).standard_normal(
    (4, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def small_sam():
    """MobileSAM at 64 and JAX's single-device embeddings of FRAMES."""
    jcfg, jparams, cfg, model, encode = _sam("mobile_sam")
    return jcfg, jparams, cfg, model, np.asarray(encode(jparams, FRAMES))


def test_make_mesh_factorisation():
    mesh = pmesh.make_mesh(8, devices=[CPU] * 8)
    assert mesh.shape == {"dp": 4, "tp": 2}
    assert pmesh.make_mesh(8, dp=8, devices=[CPU] * 8).shape == {
        "dp": 8, "tp": 1}
    assert pmesh.make_mesh(8, tp=4, devices=[CPU] * 8).shape == {
        "dp": 2, "tp": 4}
    with pytest.raises(AssertionError):
        pmesh.make_mesh(8, dp=3, tp=2, devices=[CPU] * 8)


def test_a_mesh_built_by_itself_takes_cuda_devices_only(monkeypatch):
    """JAX falls back to CPU devices; the port raises instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="devices visible"):
        pmesh.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="only 2 devices visible"):
        pmesh.make_mesh(4)
    mesh = pmesh.make_mesh()
    assert mesh.shape == {"dp": 2, "tp": 1}
    assert [d.type for d in mesh.devices.reshape(-1)] == ["cuda", "cuda"]


@pytest.mark.parametrize("variant", ["mobile_sam", "vit_b"])
def test_param_sharding_rule_matches_jax_leaf_by_leaf(variant):
    _, jparams, _, model, _ = _sam(variant)
    jm = jmesh.make_mesh(8, devices=jax.devices("cpu")[:8])
    want = {k.replace("/", "."): tuple(v.spec) for k, v in jmesh._tree_paths(
        jmesh.sam_param_sharding(jparams, jm))}
    got = pmesh.sam_param_sharding(model, pmesh.make_mesh(8, devices=[CPU] * 8))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.spec) == want[k], k
    sharded = {k for k, v in want.items() if "tp" in v}
    assert any(k.endswith("qkv.w") for k in sharded)
    assert any(k.endswith("proj.w") for k in sharded)
    norm = got["encoder.neck.ln1.scale"]
    assert norm.spec == pmesh.P()


@pytest.mark.parametrize("dim", [0, 1])
def test_tp_linear_equals_the_dense_product_and_its_gradient(dim):
    gen = torch.Generator().manual_seed(dim)
    lin = pmesh.Linear(48, 96, gen)
    x = torch.randn(5, 48, generator=gen)
    tpl = pmesh.TPLinear(lin, _devices(4, "distinct"), dim)
    assert [tuple(w.shape) for w in tpl.w_shards] == (
        [(48, 24)] * 4 if dim == 1 else [(12, 96)] * 4)
    want = x @ lin.w + lin.b
    torch.testing.assert_close(tpl(x), want, atol=1e-5, rtol=0)
    xg = x.clone().requires_grad_(True)
    tpl(xg).square().sum().backward()
    xd = x.clone().requires_grad_(True)
    (xd @ lin.w + lin.b).square().sum().backward()
    torch.testing.assert_close(xg.grad, xd.grad, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("kind", ["repeated", "distinct"])
def test_encode_frames_dp_matches_jax(small_sam, kind):
    _, _, cfg, model, want = small_sam
    mesh = pmesh.make_mesh(4, dp=4, devices=_devices(4, kind))
    got = pbatch.encode_frames(model, cfg, torch.from_numpy(FRAMES), mesh=mesh)
    assert got.shape == want.shape == (4, 4, 4, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    one = pbatch.encode_frames(model, cfg, torch.from_numpy(FRAMES[3:4]))
    assert torch.equal(got[3], one[0])  # a row is the single-device program


@pytest.mark.parametrize("variant,dp,tp,kind", [
    ("mobile_sam", 1, 4, "repeated"), ("mobile_sam", 2, 2, "distinct"),
    ("vit_b", 2, 2, "repeated")])
def test_encode_frames_tp_matches_jax(variant, dp, tp, kind):
    _, jparams, cfg, model, encode = _sam(variant)
    want = np.asarray(encode(jparams, FRAMES))
    mesh = pmesh.make_mesh(dp * tp, dp=dp, tp=tp,
                           devices=_devices(dp * tp, kind))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = pbatch.encode_frames(model, cfg, torch.from_numpy(FRAMES), mesh=mesh)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    rep = pmesh.replica(model, tuple(mesh.devices[0]), tp=True)
    assert rep is not model and any(isinstance(m, pmesh.TPLinear)
                                    for m in rep.modules())
    assert not any(isinstance(m, pmesh.TPLinear) for m in model.modules())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k  # the model is left as it was


def test_a_replica_follows_weights_written_in_place():
    _, _, cfg, model, _ = _sam("mobile_sam")
    frames = torch.from_numpy(FRAMES[:2])
    mesh = pmesh.make_mesh(4, dp=2, tp=2, devices=_devices(4, "distinct"))
    first = pbatch.encode_frames(model, cfg, frames, mesh=mesh)
    with torch.no_grad():
        model.encoder.patch_embed.conv1.w.mul_(1.5)
        model.encoder.stages[1].blocks[0].attn.qkv.w.mul_(0.5)
    again = pbatch.encode_frames(model, cfg, frames, mesh=mesh)
    single = pbatch.encode_frames(model, cfg, frames)
    assert not torch.allclose(first, again)
    torch.testing.assert_close(again, single, atol=2e-4, rtol=1e-3)


def test_a_replica_that_holds_copies_is_copied_again_after_an_update():
    """On a device other than the model's a replica holds copies (here
    made by hand: every CPU device is one device). After the model's
    leaves are written in place, the next use copies them in again, the
    sharded weights as their shards."""
    _, _, cfg, model, _ = _sam("mobile_sam")
    entry = pmesh.replica_entry(model, _devices(2, "distinct"), tp=True)
    assert not entry._pairs  # on the model's device it shares them
    with torch.no_grad():
        for t in pmesh._leaves(entry.module).values():
            t.data = t.data.clone()
    entry._pairs = entry._copy_pairs()
    n_leaves = len(pmesh._leaves(model))
    assert len(entry._pairs) > n_leaves  # a sharded weight: one per shard
    frames = torch.from_numpy(FRAMES[:2])
    with torch.no_grad():
        model.encoder.stages[1].blocks[0].attn.qkv.w.mul_(0.5)
        model.encoder.stages[1].blocks[0].mlp.fc2.w.mul_(2.0)
    entry.sync()
    qkv = entry.module.encoder.stages[1].blocks[0].attn.qkv
    assert torch.equal(torch.cat(list(qkv.w_shards), dim=1),
                       model.encoder.stages[1].blocks[0].attn.qkv.w)
    with torch.inference_mode():
        got = sam.encode_image(entry.module, cfg, frames)
        want = sam.encode_image(model, cfg, frames)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)


def test_encode_frames_needs_dp_to_divide_the_batch(small_sam):
    _, _, cfg, model, _ = small_sam
    mesh = pmesh.make_mesh(4, dp=4, devices=[CPU] * 4)
    with pytest.raises(DlimgError, match="must divide"):
        pbatch.encode_frames(model, cfg, torch.zeros(2, 64, 64, 3), mesh=mesh)


def test_segment_frames_dp_matches_jax():
    """The slim BiRefNet of runtime/birefnet.py::slim_config with the
    port's seeded init, nonzero offsets and biases
    (``models/birefnet.py::seed_nonzero_init``), carried to JAX by
    ``numpy_from_params`` (JAX's own init of it takes ~20 s here)."""
    cfg = rbn.slim_config(64, False)
    model = _slim_birefnet(cfg)
    jcfg = _slim_jax_config()
    frames = FRAMES[:2]
    mesh = pmesh.make_mesh(4, dp=2, tp=2, devices=_devices(4, "distinct"))
    got = pbatch.segment_frames(model, cfg, torch.from_numpy(frames),
                                mesh=mesh)
    want = np.asarray(jax.jit(lambda p, x: jbn.birefnet_apply(p, x, jcfg))(
        numpy_from_params(model), frames))
    assert got.shape == want.shape == (2, 64, 64, 1)
    assert want.std() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def sharded_step(small_sam):
    """JAX's single-device loss and gradients on test_train_step_sharded's
    batch, and the port's over make_mesh(8) (dp 4, tp 2)."""
    jcfg, jparams, cfg, _, _ = small_sam
    batch = sam_batch(8, 64, jcfg.mask_input_size, seed=3)
    tcfg = jstep.TrainConfig()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.mask_loss(p, jcfg, b, tcfg), has_aux=True))(
        jparams, batch)
    model = load(sam.Sam(cfg), jparams)
    opt = pstep.init_train_state(model)
    mesh = pmesh.make_mesh(8, devices=_devices(8, "distinct"))
    placed = pstep.place_train_state(model, opt, batch, mesh)
    return dict(cfg=cfg, jparams=jparams, batch=batch, jl=float(jl),
                jg=np_tree(jg), placed=placed, mesh=mesh)


def test_sharded_train_step_matches_jax(sharded_step):
    cfg = sharded_step["cfg"]
    model, opt, placed = sharded_step["placed"]
    assert set(placed) == {"images", "point_coords", "point_labels", "masks"}
    assert [t.shape[0] for _, t in placed["images"].row_parts()] == [2] * 4
    (loss, _), grads = pstep.mesh_loss_and_grads(
        pstep.mask_loss, model, cfg, placed, pstep.TrainConfig(), 1, tp=True)
    rel_close(loss, sharded_step["jl"])
    assert_grads_close(grads, sharded_step["jg"])


def test_sharded_train_step_trains_and_composes_with_accum(sharded_step):
    cfg, jparams = sharded_step["cfg"], sharded_step["jparams"]
    model = load(sam.Sam(cfg), jparams)
    opt = pstep.init_train_state(model)
    m, o, placed = pstep.place_train_state(model, opt, sharded_step["batch"],
                                           sharded_step["mesh"])
    step = pstep.make_train_step(cfg)
    before = model.encoder.patch_embed.conv1.w.clone()
    losses = [float(step(m, o, placed)[2]) for _ in range(3)]
    assert not torch.allclose(before, model.encoder.patch_embed.conv1.w)
    assert losses[-1] < losses[0]
    # accum_steps 2 inside each row: the same mean over the global batch.
    (l1, _), g1 = pstep.mesh_loss_and_grads(
        pstep.mask_loss, m, cfg, placed, pstep.TrainConfig(), 1, tp=True)
    (l2, _), g2 = pstep.mesh_loss_and_grads(
        pstep.mask_loss, m, cfg, placed, pstep.TrainConfig(), 2, tp=True)
    rel_close(l2, l1)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], atol=1e-6, rtol=1e-4)


def test_teacher_embeddings_and_sharded_distill_step():
    """teacher_embeddings over a (dp, tp) mesh against JAX's; the dp
    distillation step's loss and gradients against JAX's distill_loss
    and against the port's single-device step (JAX's
    test_distill.py::test_sharded_step_matches_single_device)."""
    _, jteacher, t_cfg, teacher, encode = _sam("vit_b")
    images = FRAMES
    want = np.array(encode(jteacher, images))  # writable: a batch entry
    mesh = pmesh.make_mesh(4, dp=2, tp=2, devices=_devices(4, "repeated"))
    emb = distill.teacher_embeddings(teacher, t_cfg, torch.from_numpy(images),
                                     mesh=mesh)
    np.testing.assert_allclose(emb.numpy(), want, atol=2e-5, rtol=1e-4)

    js_cfg, jstudent, s_cfg, student, _ = _sam("mobile_sam")
    student = student.encoder
    batch = {"images": images, "teacher_emb": want}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda e, b: jdistill.distill_loss({"encoder": e}, js_cfg, b,
                                           jdistill.DistillConfig()),
        has_aux=True))(jstudent["encoder"], batch)
    tcfg = distill.DistillConfig()
    (l1, _), g1 = pstep.loss_and_grads(distill.distill_loss, student, s_cfg,
                                       batch, tcfg)
    opt = distill.init_distill_state(student, tcfg)
    dmesh = pmesh.make_mesh(2, dp=2, devices=_devices(2, "distinct"))
    enc, opt, placed = distill.place_distill_state(student, opt, batch, dmesh)
    (l2, _), g2 = pstep.mesh_loss_and_grads(distill.distill_loss, enc, s_cfg,
                                            placed, tcfg, 1, tp=False)
    rel_close(l2, jl)
    assert_grads_close(g2, jg)
    rel_close(l2, l1, 1e-6)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], atol=1e-6, rtol=1e-4)
    _, _, loss, _ = distill.make_distill_step(s_cfg, tcfg)(enc, opt, placed)
    rel_close(loss, l1, 1e-6)


def _slim_jax_config():
    """runtime/birefnet.py::slim_config(64) in the JAX package's terms."""
    return jbn.BiRefNetConfig(
        img_size=64, dec_inter_channels=8, aspp_channelster=12,
        gdt_channels=4, aspp_kernel_sizes=(1, 3),
        swin_cfg=jswin.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                                  num_heads=(2, 2, 2, 2), window=4))


def _slim_birefnet(cfg):
    model = bn.init_birefnet(torch.Generator().manual_seed(0), cfg)
    bn.seed_nonzero_init(model, seed=1)
    return model


def test_birefnet_dp_step_matches_the_single_device_step():
    """The port's step over a ('dp',) mesh of 2 against JAX's
    single-device step on the same tree and batch."""
    cfg = rbn.slim_config(64, False)
    model = _slim_birefnet(cfg)
    rng = np.random.default_rng(5)
    batch = {"images": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
             "masks": (rng.random((2, 64, 64)) > 0.5).astype(np.float32)}
    jtcfg = jbstep.BiRefNetTrainConfig(learning_rate=1e-3)
    jparams = numpy_from_params(model)
    before = flatten_tree(jparams)["backbone/patch_embed/w"].copy()
    jp, _, jl, _ = jbstep.make_birefnet_train_step(
        _slim_jax_config(), jtcfg, donate=False)(
        jparams, jbstep.init_birefnet_train_state(jparams, jtcfg), batch)
    want = flatten_tree(np_tree(jp))
    tcfg = birefnet_step.BiRefNetTrainConfig(learning_rate=1e-3)
    step = birefnet_step.make_birefnet_train_step(cfg, tcfg)
    mesh = pmesh.Mesh(_devices(2, "distinct"), ("dp",))
    m, o, placed = birefnet_step.place_birefnet_train_state(
        model, birefnet_step.init_birefnet_train_state(model, tcfg),
        dict(batch, weights=np.ones((2,), np.float32)), mesh)
    assert set(placed) == {"images", "masks", "weights"}
    assert placed["weights"].sharding.spec == pmesh.P("dp")
    del placed["weights"]
    _, _, loss, _ = step(m, o, placed)
    rel_close(loss, jl)
    got = flat_port(m)
    assert set(got) == set(want)
    assert not np.allclose(got["backbone/patch_embed/w"], before)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=5e-5, rtol=1e-4,
                                   err_msg=k)


def test_birefnet_dp_sp_step_matches_the_single_device_step():
    """The port's step over a ('dp', 'sp') mesh of [[cpu, cpu], [cpu,
    cpu]] (each dp row's image on 2 canvas-row bands) against JAX's
    single-device step on the same tree and batch."""
    cfg = rbn.slim_config(64, False)
    model = _slim_birefnet(cfg)
    rng = np.random.default_rng(6)
    batch = {"images": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
             "masks": (rng.random((2, 64, 64)) > 0.5).astype(np.float32)}
    jtcfg = jbstep.BiRefNetTrainConfig(learning_rate=1e-3)
    jparams = numpy_from_params(model)
    jp, _, jl, _ = jbstep.make_birefnet_train_step(
        _slim_jax_config(), jtcfg, donate=False)(
        jparams, jbstep.init_birefnet_train_state(jparams, jtcfg), batch)
    want = flatten_tree(np_tree(jp))
    tcfg = birefnet_step.BiRefNetTrainConfig(learning_rate=1e-3)
    mesh = pmesh.Mesh(np.asarray([[CPU, CPU], [CPU, CPU]], dtype=object),
                      ("dp", "sp"))
    m, o, placed = birefnet_step.place_birefnet_train_state(
        model, birefnet_step.init_birefnet_train_state(model, tcfg),
        dict(batch, weights=np.ones((2,), np.float32)), mesh)
    assert placed["images"].sharding.spec == pmesh.P("dp", "sp")
    assert placed["weights"].sharding.spec == pmesh.P("dp")
    assert [tuple(t.shape) for _, _, t in placed["images"].shards] == [
        (1, 32, 64, 3)] * 4
    del placed["weights"]
    _, _, loss, _ = birefnet_step.make_birefnet_train_step(cfg, tcfg)(
        m, o, placed)
    rel_close(loss, jl)
    got = flat_port(m)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=5e-5, rtol=1e-4,
                                   err_msg=k)
    with pytest.raises(ValueError, match="'sp'"):
        birefnet_step.place_birefnet_train_state(
            m, o, batch, pmesh.Mesh([CPU, CPU], ("sp",)))


def test_prefetch_dp_shards_over_mesh():
    mesh = pmesh.make_mesh(8, dp=8, devices=_devices(8, "distinct"))
    batches = ({"x": np.arange(8, dtype=np.float32).reshape(8, 1) + i}
               for i in range(3))
    for i, b in enumerate(prefetch_to_device(batches, depth=2, mesh=mesh)):
        x = b["x"]
        assert len(x.shards) == 8 and x.shape == (8, 1)
        got = torch.cat([t for _, t in x.row_parts()]).numpy()
        np.testing.assert_array_equal(
            got, np.arange(8, dtype=np.float32).reshape(8, 1) + i)
