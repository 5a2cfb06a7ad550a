"""Automatic mask generation (AMG) and batched prompt decode: the port
against the JAX package on the CPU, float32.

  * ops, from numpy inputs made from seeds: point_grid, stability_scores,
    mask_boxes, box_iou_matrix, greedy_nms_plain (M = 1, 7, 256, 2304,
    with duplicate boxes, IoU exactly at the threshold and invalid scores),
    the 8-connected labelling and the batched refine_mask_logits are
    bit-equal to JAX's; decode_prompt_batch is within the decoder parity
    tests' atol 1e-4;
  * the slice, from ONE weight bundle (the JAX seed-0 `init_sam` tree at
    image size 64, as tests/test_torch_segmentation.py writes it) on the
    golden image (rng 42, 96 x 64): the committed AMG goldens of
    tests/goldens/digests.json; 8 winners (nms_thresh 1.0), with and
    without the small-region filter, against JAX; JAX's numpy mirror of the
    selection (tests/test_amg.py) on the port's own pass-A statistics;
    generate_masks_image with one crop layer against JAX, and with none
    against generate_masks.

Masks must equal JAX's byte for byte; a flipped pixel is allowed only where
JAX's upsampled logit there is within 1e-4 of zero (a threshold decision
the float32 noise can move). Accuracies within 2e-5 (the goldens' 1e-3).
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.ops import amg as jax_amg
from dlimgedit_tpu.ops.connected import _label_components as jax_label
from dlimgedit_tpu.ops.postprocess import upsample_mask_logits as jax_upsample
from dlimgedit_tpu.ops.preprocess import pick_bucket
from dlimgedit_tpu.parallel.batch import decode_prompt_batch as jax_decode_batch
from dlimgedit_tpu.utils.pytree_io import save_pytree
from dlimgedit_tpu_torch.ops import amg as pamg
from dlimgedit_tpu_torch.ops.connected import _label_components as port_label
from dlimgedit_tpu_torch.parallel.batch import decode_prompt_batch
from dlimgedit_tpu_torch.runtime import amg as pramg

torch.set_num_threads(2)

IMAGE_SIZE = 64
NEAR_ZERO = 1e-4
GOLDENS = Path(__file__).parent / "goldens"
AMG_KW = dict(grid=4, iou_thresh=0.0, stability_thresh=0.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_jax_decode = jax.jit(jax_decode_batch, static_argnums=(1, 5))


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("n,crop_w,crop_h", [(1, 64, 43), (4, 64, 43),
                                             (32, 768, 1024), (7, 1024, 683)])
def test_point_grid_matches_jax(n, crop_w, crop_h):
    want = np.asarray(jax_amg.point_grid(n, jnp.int32(crop_w), jnp.int32(crop_h)))
    got = pamg.point_grid(n, torch.tensor(crop_w, dtype=torch.int32),
                          torch.tensor(crop_h, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_valid", [False, True])
def test_stability_scores_match_jax(with_valid):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (3, 5, 16, 16)).astype(np.float32)
    valid = np.zeros((16, 16), bool)
    valid[:11, :13] = True
    v = valid if with_valid else None
    want = np.asarray(jax_amg.stability_scores(
        jnp.asarray(logits), None if v is None else jnp.asarray(v)))
    got = pamg.stability_scores(_t(logits), None if v is None else _t(v))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_boxes_match_jax():
    rng = np.random.default_rng(0)
    masks = rng.random((2, 10, 12, 12)) > 0.8
    masks[0, 3] = False  # empty
    masks[1, 4] = False
    masks[1, 4, 7, 2] = True  # one pixel
    want = np.asarray(jax_amg.mask_boxes(jnp.asarray(masks)))
    np.testing.assert_array_equal(pamg.mask_boxes(_t(masks)).numpy(), want)


def _boxes(rng, M, side=64):
    """Seeded inclusive boxes: random ones, exact duplicates, and boxes
    whose IoU with an earlier one is exactly 0.5 (the lower half of it)."""
    x0 = rng.integers(0, side, M)
    y0 = rng.integers(0, side, M)
    w = rng.integers(1, side // 2, M)
    h = 2 * rng.integers(1, side // 4, M)
    boxes = np.stack([x0, y0, x0 + w - 1, y0 + h - 1], -1).astype(np.float32)
    for i in range(1, M):
        k = rng.integers(0, i)
        r = rng.random()
        if r < 0.15:
            boxes[i] = boxes[k]
        elif r < 0.3 and (boxes[k, 3] - boxes[k, 1] + 1) % 2 == 0:
            half = (boxes[k, 3] - boxes[k, 1] + 1) / 2
            boxes[i] = [boxes[k, 0], boxes[k, 1], boxes[k, 2],
                        boxes[k, 1] + half - 1]
    if M > 2:
        boxes[M // 2] = [side, side, -1, -1]  # an empty mask's box
    return boxes


def _scores(rng, M):
    """Descending scores with ties, one 0 and an invalid (-1) tail."""
    s = np.round(rng.random(M), 2).astype(np.float32)
    s = np.sort(s)[::-1].copy()
    n_bad = M // 8
    if n_bad:
        s[M - n_bad:] = -1.0
        s[M - n_bad - 1] = 0.0
    return s


def test_box_iou_matrix_matches_jax():
    boxes = _boxes(np.random.default_rng(1), 64)
    want = np.asarray(jax_amg.box_iou_matrix(jnp.asarray(boxes)))
    got = pamg.box_iou_matrix(_t(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0.5).sum() > 0 and (got == 1.0).sum() > 64


@pytest.mark.parametrize("M", [1, 7, 256, 2304])
def test_greedy_nms_plain_matches_jax(M):
    rng = np.random.default_rng(M)
    boxes, scores = _boxes(rng, M), _scores(rng, M)
    thresh = np.float32(0.5)
    want = np.asarray(jax.jit(jax_amg.greedy_nms)(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(thresh)))
    got = pamg.greedy_nms(_t(boxes), _t(scores), torch.tensor([thresh]))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if M >= 256:  # the ties sit at the threshold and stay
        iou = pamg.box_iou_matrix(_t(boxes)).numpy()
        kept = np.flatnonzero(want)
        assert (iou[np.ix_(kept, kept)] == 0.5).any()
        assert 0 < want.sum() < (scores > 0).sum()


def _label_masks():
    rng = np.random.default_rng(5)
    blobs = rng.random((3, 24, 24)) > 0.55
    H = W = 32
    serp = np.zeros((H, W), bool)
    for r in range(0, H - 2, 2):  # full even rows, one joint between them
        serp[r, :] = True
        serp[r + 1, W - 1 if (r // 2) % 2 == 0 else 0] = True
    stair = np.zeros((H, W), bool)  # joined only through corners
    for i in range(H):
        stair[i, i] = True
        stair[i, (W - 1 - i)] = i % 3 == 0
    return [blobs, np.stack([serp, stair])]


@pytest.mark.parametrize("conn8", [False, True])
@pytest.mark.parametrize("case", [0, 1], ids=["blobs", "serpentine"])
def test_label_components_match_jax(case, conn8):
    masks = _label_masks()[case]
    got = port_label(_t(masks), conn8=conn8).numpy()
    for m, g in zip(masks, got):
        want, _ = jax.jit(jax_label, static_argnums=(1, 2))(jnp.asarray(m), 64,
                                                           conn8)
        np.testing.assert_array_equal(g, np.asarray(want))


def _blobby_logits(seed, B=4, L=24):
    """Thresholded smoothed noise: regions with holes and islands at
    several scales (tests/test_amg.py's recipe)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        raw = rng.normal(0, 1, (L + 4, L + 4))
        sm = sum(raw[i:i + L, j:j + L] for i in range(5) for j in range(5)) / 25
        out.append((sm - np.median(sm)) * 40.0)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("seed,min_area", [(0, 4.0), (1, 7.0), (2, 12.0),
                                           (3, 1000.0)])
def test_refine_mask_logits_matches_jax(seed, min_area):
    """min_area 1000 is above every island: each mask keeps its largest."""
    logits = _blobby_logits(seed)
    L = logits.shape[-1]
    valid = np.zeros((L, L), bool)
    valid[:L - 3, :L - 2] = True
    want = np.asarray(jax.vmap(lambda m: jax_amg.refine_mask_logits(
        m, jnp.asarray(valid), jnp.float32(min_area)))(jnp.asarray(logits)))
    got = pamg.refine_mask_logits(_t(logits), _t(valid),
                                  torch.tensor(min_area)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got > 0, logits > 0)  # the filter did work


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    (d / "segmentation").mkdir()
    params = jax_sam.init_sam(jax.random.PRNGKey(0),
                              jax_sam.make_config("mobile_sam", IMAGE_SIZE))
    save_pytree(d / "segmentation" / "mobile_sam.npz",
                jax.tree_util.tree_map(np.asarray, params))
    return d


def _opts(mod, model_dir):
    return mod.Options(backend=mod.Backend.cpu, model_directory=str(model_dir),
                       compute_dtype="float32", sam_image_size=IMAGE_SIZE)


@pytest.fixture(scope="module")
def envs(model_dir):
    return (jdl.Environment(_opts(jdl, model_dir)),
            pdl.Environment(_opts(pdl, model_dir)))


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(42).integers(0, 256, (64, 96, 4), dtype=np.uint8)


def _process(envs, pixels):
    je, pe = envs
    h, w = pixels.shape[:2]
    return (jdl.Segmentation.process(
                jdl.Image(jdl.Extent(w, h), jdl.Channels.rgba, pixels), je),
            pdl.Segmentation.process(
                pdl.Image(pdl.Extent(w, h), pdl.Channels.rgba, pixels), pe))


@pytest.fixture(scope="module")
def segs(envs, pixels):
    return _process(envs, pixels)


@pytest.mark.parametrize("multimask", [False, True])
def test_decode_prompt_batch_matches_jax(envs, segs, multimask):
    je, pe = envs
    js, ps = segs
    rng = np.random.default_rng(11)
    coords = (rng.random((5, 2, 2)) * IMAGE_SIZE).astype(np.float32)
    labels = np.tile(np.array([[1.0, -1.0]], np.float32), (5, 1))
    labels[3] = [2.0, 3.0]  # a box prompt
    bundle = je.sam_model()
    want_m, want_i = _jax_decode(bundle.params, bundle.cfg, js.embedding,
                                 jnp.asarray(coords), jnp.asarray(labels),
                                 multimask)
    pb = pe.sam_model()
    with torch.inference_mode():
        got_m, got_i = decode_prompt_batch(pb.model, pb.cfg, ps.embedding,
                                           _t(coords), _t(labels), multimask)
    T = 4 if multimask else 1
    assert tuple(got_m.shape) == (5, T, 16, 16) and tuple(got_i.shape) == (5, T)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-4, rtol=0)


def _jax_winner_logits(je, js, grid, accuracies, min_area_lr=0.0):
    """JAX's upsampled logits (K, H, W) of the masks JAX's AMG returned
    with these accuracies: every grid candidate decoded by JAX, each
    winner found by its predicted IoU, refined as JAX's program does."""
    bundle = je.sam_model()
    cfg = bundle.cfg
    crop_h, crop_w = js._crop
    pts = np.asarray(jax_amg.point_grid(grid, jnp.int32(crop_w), jnp.int32(crop_h)))
    coords = np.stack([pts, np.zeros_like(pts)], 1)
    labels = np.tile(np.array([[1.0, -1.0]], np.float32), (len(pts), 1))
    m, iou = _jax_decode(bundle.params, cfg, js.embedding,
                         jnp.asarray(coords), jnp.asarray(labels), True)
    L = cfg.mask_input_size
    m = np.asarray(m[:, 1:4]).reshape(-1, L, L)
    iou = np.asarray(iou[:, 1:4]).reshape(-1)
    low = jnp.asarray(m[[int(np.argmin(np.abs(iou - a))) for a in accuracies]])
    if min_area_lr > 0:
        centre = (np.arange(L, dtype=np.float32) + 0.5) * (cfg.image_size / L)
        valid = jnp.asarray((centre[:, None] < crop_h) & (centre[None, :] < crop_w))
        low = jax.vmap(lambda x: jax_amg.refine_mask_logits(
            x, valid, jnp.float32(min_area_lr)))(low)
    h, w = js.extent.height, js.extent.width
    logits = jax_upsample(low[None], pick_bucket(js.extent), cfg.image_size,
                          h, w, crop_h, crop_w)
    return np.asarray(logits[0])[:, :h, :w]


def _assert_mask_matches(got: np.ndarray, want: np.ndarray, logits_fn):
    assert got.shape == want.shape and got.dtype == np.uint8
    flips = got.reshape(want.shape[:2]) != want.reshape(want.shape[:2])
    if not flips.any():
        return
    near = np.abs(logits_fn()[flips]) <= NEAR_ZERO
    assert near.all(), (
        f"{int(flips.sum())} pixels flipped, {int((~near).sum())} of them where "
        f"JAX's logit is not within {NEAR_ZERO} of zero")


def _assert_amg_matches(je, js, got, want, min_area_lr=0.0):
    assert len(got) == len(want)
    np.testing.assert_allclose([g.accuracy for g in got],
                               [w.accuracy for w in want], atol=2e-5, rtol=0)
    logits = []

    def jax_logits(i):
        if not logits:
            logits.append(_jax_winner_logits(
                je, js, AMG_KW["grid"], [w.accuracy for w in want], min_area_lr))
        return logits[0][i]

    for i, (g, w) in enumerate(zip(got, want)):
        _assert_mask_matches(g.image.pixels, w.image.pixels,
                             lambda i=i: jax_logits(i))


def test_amg_reproduces_the_committed_goldens(envs, segs):
    """ROADMAP A2's gate: tests/test_goldens.py::test_golden_amg's call."""
    digests = json.loads((GOLDENS / "digests.json").read_text())
    js, ps = segs
    got = ps.generate_masks(max_masks=4, **AMG_KW)
    assert len(got) == digests["amg_count"]
    np.testing.assert_allclose([round(g.accuracy, 6) for g in got],
                               digests["amg_accuracies"], atol=1e-3)
    for i, g in enumerate(got):
        mask = np.ascontiguousarray(g.image.pixels.squeeze())
        if hashlib.sha256(mask.tobytes()).hexdigest() == digests[f"mask_amg_{i}"]:
            continue
        golden = np.load(GOLDENS / f"mask_amg_{i}.npy")
        _assert_mask_matches(mask, golden, lambda: _jax_winner_logits(
            envs[0], js, AMG_KW["grid"], [g.accuracy])[0])


def test_eight_winners_match_jax(envs, segs):
    """nms_thresh 1.0 keeps every valid candidate: pass B decodes 8."""
    js, ps = segs
    want = js.generate_masks(max_masks=8, nms_thresh=1.0, **AMG_KW)
    got = ps.generate_masks(max_masks=8, nms_thresh=1.0, **AMG_KW)
    assert len(got) == 8
    _assert_amg_matches(envs[0], js, got, want)


def test_small_region_filter_matches_jax(envs, segs):
    js, ps = segs
    area = 400  # original pixels: 11.1 low-res pixels at this scale
    kw = dict(max_masks=8, nms_thresh=1.0, **AMG_KW)
    plain = ps.generate_masks(**kw)
    got = ps.generate_masks(min_mask_region_area=area, **kw)
    assert any(not np.array_equal(a.image.pixels, b.image.pixels)
               for a, b in zip(plain, got))
    want = js.generate_masks(min_mask_region_area=area, **kw)
    lr = js._scale * 16 / IMAGE_SIZE
    _assert_amg_matches(envs[0], js, got, want, area * lr * lr)
    # The flip rule's JAX logits are those of JAX's own winners.
    logits = _jax_winner_logits(envs[0], js, AMG_KW["grid"],
                                [w.accuracy for w in want], area * lr * lr)
    for lg, w in zip(logits, want):
        np.testing.assert_array_equal(np.where(lg > 0, 255, 0),
                                      w.image.pixels[..., 0])


# JAX's numpy mirror of the selection (tests/test_amg.py).

def _np_iou(boxes):
    n = len(boxes)
    out = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(n):
            ax0, ay0, ax1, ay1 = boxes[i]
            bx0, by0, bx1, by1 = boxes[j]
            a = max(ax1 - ax0 + 1, 0) * max(ay1 - ay0 + 1, 0)
            b = max(bx1 - bx0 + 1, 0) * max(by1 - by0 + 1, 0)
            iw = max(min(ax1, bx1) - max(ax0, bx0) + 1, 0)
            ih = max(min(ay1, by1) - max(ay0, by0) + 1, 0)
            inter = iw * ih
            out[i, j] = inter / max(a + b - inter, 1)
    return out


def _np_greedy_nms(boxes, scores, thresh):
    iou = _np_iou(boxes)
    keep = scores > 0.0
    for i in range(len(boxes)):
        if not keep[i]:
            continue
        for j in range(i + 1, len(boxes)):
            if keep[j] and iou[i, j] > thresh:
                keep[j] = False
    return keep


def _gap_threshold(values, q):
    s = np.unique(np.sort(values))
    if len(s) < 2:
        return float(s[0]) - 0.5
    k = int(np.clip(q * (len(s) - 1), 0, len(s) - 2))
    return float((s[k] + s[k + 1]) / 2)


@pytest.mark.parametrize("nms_t", [0.5, 1.0])
def test_selection_mirror_on_port_candidates(envs, segs, nms_t):
    """The port's program picks the winners that JAX's numpy mirror of the
    selection picks from the port's own pass-A statistics."""
    pe = envs[1]
    ps = segs[1]
    grid, max_masks = 4, 8
    bundle = pe.sam_model()
    with torch.inference_mode():
        iou, stab, area, boxes = (t.numpy() for t in pramg.amg_candidates(
            bundle, ps.embedding, ps._sizes(), grid))
    iou_t, stab_t = _gap_threshold(iou, 0.3), _gap_threshold(stab, 0.3)
    ok = (iou >= iou_t) & (stab >= stab_t) & (area >= 1.0)
    score = np.where(ok, iou, -1.0).astype(np.float32)
    order = np.argsort(-score, kind="stable")
    kept = order[_np_greedy_nms(boxes[order], score[order], nms_t)]
    exp = kept[np.argsort(-score[kept], kind="stable")][:max_masks]

    G = grid * grid
    run = pramg._build_amg_fn(bundle, pick_bucket(ps.extent), grid, max_masks,
                              pramg._prenms_pool(G, max_masks))
    thr = pe.floats_on_device((iou_t, stab_t, nms_t, 0.0, 1.0, 0.0))
    with torch.inference_mode():
        _, sc, st, ar = (t.numpy() for t in run(ps.embedding, ps._sizes(), thr))
    n = int((sc > 0).sum())
    assert n == len(exp) >= (1 if nms_t < 1 else max_masks)
    np.testing.assert_array_equal(sc[:n], iou[exp])
    np.testing.assert_array_equal(st[:n], stab[exp])
    np.testing.assert_array_equal(ar[:n], area[exp])


def test_generate_masks_image_crop_layer_matches_jax(envs, pixels):
    je, pe = envs
    kw = dict(max_masks=8, crop_n_layers=1, crop_nms_thresh=0.8, **AMG_KW)
    h, w = pixels.shape[:2]
    want = jdl.generate_masks_image(
        jdl.Image(jdl.Extent(w, h), jdl.Channels.rgba, pixels), je, **kw)
    got = pdl.generate_masks_image(
        pdl.Image(pdl.Extent(w, h), pdl.Channels.rgba, pixels), pe, **kw)
    assert 1 <= len(got) == len(want)
    np.testing.assert_allclose([g.accuracy for g in got],
                               [x.accuracy for x in want], atol=2e-5, rtol=0)

    def crop_logits():
        """JAX's full-extent logits of every crop's winners, by accuracy
        (-inf outside the crop)."""
        found = {}
        for (x0, y0, x1, y1, _) in pramg.crop_boxes(pdl.Extent(w, h), 1,
                                                    512 / 1500):
            sub = np.ascontiguousarray(pixels[y0:y1, x0:x1])
            js = jdl.Segmentation.process(jdl.Image(
                jdl.Extent(x1 - x0, y1 - y0), jdl.Channels.rgba, sub), je)
            accs = [m.accuracy for m in js.generate_masks(max_masks=8, **AMG_KW)]
            for a, lg in zip(accs, _jax_winner_logits(je, js, 4, accs)):
                full = np.full((h, w), -np.inf, np.float32)
                full[y0:y1, x0:x1] = lg
                found[a] = full
        return found

    cache = []
    for g, x in zip(got, want):
        def logits(x=x):
            if not cache:
                cache.append(crop_logits())
            return cache[0][x.accuracy]
        assert g.image.extent == pdl.Extent(w, h)
        _assert_mask_matches(g.image.pixels, x.image.pixels, logits)


def test_generate_masks_image_without_crops_is_generate_masks(envs, segs,
                                                              pixels):
    pe = envs[1]
    h, w = pixels.shape[:2]
    got = pdl.generate_masks_image(
        pdl.Image(pdl.Extent(w, h), pdl.Channels.rgba, pixels), pe,
        max_masks=6, nms_thresh=1.0, crop_n_layers=0, **AMG_KW)
    base = segs[1].generate_masks(max_masks=6, nms_thresh=1.0, **AMG_KW)
    assert len(got) == len(base) == 6
    for g, b in zip(got, base):
        assert g.accuracy == b.accuracy
        np.testing.assert_array_equal(g.image.pixels, b.image.pixels)


def test_crop_boxes_and_prenms_pool_match_jax():
    from dlimgedit_tpu.runtime import amg as jax_ramg

    for ext, n, ratio in ((pdl.Extent(100, 60), 1, 512 / 1500),
                          (pdl.Extent(1500, 1000), 2, 0.3),
                          (pdl.Extent(64, 96), 0, 0.5)):
        assert pramg.crop_boxes(ext, n, ratio) == jax_ramg.crop_boxes(
            jdl.Extent(ext.width, ext.height), n, ratio)
    for G, K in ((16, 8), (1024, 64), (100, 64), (100, 128), (400, 256),
                 (4096, 64)):
        assert pramg._prenms_pool(G, K) == jax_ramg._prenms_pool(G, K)
        assert pramg._chunk_size(G) == jax_ramg._chunk_size(G)
