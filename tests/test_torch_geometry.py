"""The geometries that the port's general attention body serves on the card
(csrc/attention_general.cuh), against the JAX package on the CPU, all
inputs from numpy seeds. JAX runs its Pallas kernels in interpret mode; on
CPU tensors the port's wrappers compute their plain versions, which the
card holds the general body against (tests/test_torch_cuda.py,
chip_smoke.py phase 20):

  * K2 ``levit_window_attention`` at kd 8, 12 and 48 (the tuned instances
    take kd 32 only) on windows of 49 and 576 tokens (576: TinyViT's 384
    variant's window of 24, above the tuned 256);
  * K4 (a 10 x 12 grid), K5 (7 x 7 windows, folded, with the pad-query
    skip; a 2 x 128 window, N = 256, unfolded: hd + gh + gw > 128) and K7
    at head widths 4, 36 and 136 (not multiples of 8, or above 128);
  * K6 ``windowed_attention_fused`` on windows of 15, 16 and 24 (225-576
    tokens, above the tuned 208) at head widths 36 and 64;
  * a TinyViT with a window of 24 (``use_flash_attention``) and a SAM ViT
    at head width 36 whose windowed block takes ``fused_window_blocks`` at
    window 16, each against JAX's with its kernels in interpret mode;
  * ``attention_body``, the routing rule: every main path's shape is
    "tuned", every geometry above "general".

Tolerances as the existing parity tests: float32 atol 2e-5 (1e-4 with
rtol 1e-4 through a whole encoder), bfloat16 atol 2e-2; K6 and K7 in bf16
one bf16 step at the output's largest magnitude, as
tests/test_torch_window_kernels.py holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlimgedit_tpu.models import tinyvit as jax_tinyvit
from dlimgedit_tpu.models import vit_sam as jax_vit
from dlimgedit_tpu.ops.flash_attention import (
    flash_attention_relpos as jax_flash_attention_relpos,
)
from dlimgedit_tpu.ops.flash_attention import (
    levit_window_attention as jax_levit_window_attention,
)
from dlimgedit_tpu.ops.flash_attention import (
    windowed_attention_fused as jax_windowed_attention_fused,
)
from dlimgedit_tpu.ops.flash_attention import (
    windowed_attention_qkv as jax_windowed_attention_qkv,
)
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import tinyvit, vit_sam
from dlimgedit_tpu_torch.ops.flash_attention import (
    ATTENTION_KERNELS,
    attention_body,
    flash_attention_relpos,
    levit_window_attention,
    relpos_attention_global,
    relpos_attention_qkv,
    relpos_attention_windowed,
    relpos_route,
    windowed_attention_fused,
    windowed_attention_qkv,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
WRAPPERS = (levit_window_attention, relpos_attention_global,
            relpos_attention_windowed, relpos_attention_qkv,
            windowed_attention_fused)


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _step_atol(want: np.ndarray, dtype: str) -> float:
    if dtype == "float32":
        return ATTN_ATOL["float32"]
    # One bf16 step (8 significant bits) at the largest magnitude.
    return float(2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))


def _counts():
    return [(w.launches, w.general_launches) for w in WRAPPERS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [49, 576])
@pytest.mark.parametrize("kd", [8, 12, 48])
def test_levit_attention_any_kd_and_window_matches_pallas(kd, N, dtype):
    G, nh = 2, 2
    rng = np.random.default_rng(kd + N)
    qkv = rng.standard_normal((G, N, nh * 3 * kd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((nh, N, N))).astype(np.float32)
    (jqkv, tqkv), (jb, tb) = (_pair(a, dtype) for a in (qkv, bias))
    want = jax_levit_window_attention(jqkv, jb, num_heads=nh, interpret=True)
    assert attention_body("levit_window_attention", tqkv.dtype, kd, n=N) == "general"
    before = _counts()
    got = levit_window_attention(tqkv, tb, nh)
    assert _counts() == before  # CPU: the plain version, no launch
    assert got.dtype == tqkv.dtype and got.shape == (G, N, nh * kd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATTN_ATOL[dtype],
                               rtol=0)


def _attn_inputs(G, gh, gw, hd, seed):
    rng = np.random.default_rng(seed)
    N = gh * gw
    q, k, v = (rng.standard_normal((G, N, hd)).astype(np.float32)
               for _ in range(3))
    rh = (0.3 * rng.standard_normal((gh, gh, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((gw, gw, hd))).astype(np.float32)
    return q, k, v, rh, rw


# (G, gh, gw, heads, n_w, valid_rows): K4 (no heads), K5 with 7 x 7 windows
# (folded where hd + 14 <= 128) and K5 with 2 x 128 windows (unfolded).
RELPOS_GEOMETRIES = {"K4 10x12": (2, 10, 12, None, None, None),
                     "K5 7x7 skip": (3 * 2, 7, 7, 2, 1, 4),
                     "K5 2x128 skip": (2 * 2, 2, 128, 2, 1, 1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RELPOS_GEOMETRIES))
@pytest.mark.parametrize("hd", [4, 36, 136])
def test_relpos_any_head_width_matches_pallas(hd, case, dtype):
    G, gh, gw, heads, n_w, valid_rows = RELPOS_GEOMETRIES[case]
    arrays = _attn_inputs(G, gh, gw, hd, seed=hd + gh)
    (jq, tq), (jk, tk), (jv, tv), (jrh, trh), (jrw, trw) = (
        _pair(a, dtype) for a in arrays)
    want = jax_flash_attention_relpos(jq, jk, jv, jrh, jrw, grid_h=gh,
                                      grid_w=gw, heads=heads, interpret=True,
                                      n_w=n_w, valid_rows=valid_rows)
    route = relpos_route(tq.dtype, G, gh, gw, heads)
    kernel = f"relpos_attention_{route}"
    assert attention_body(kernel, tq.dtype, hd, gh * gw, gh, gw) == "general"
    before = _counts()
    got = flash_attention_relpos(tq, tk, tv, trh, trw, grid_h=gh, grid_w=gw,
                                 heads=heads, n_w=n_w, valid_rows=valid_rows)
    assert _counts() == before
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATTN_ATOL[dtype],
                               rtol=0)
    if n_w:  # the skipped pad-query rows are zero on both sides
        assert not got[-n_w * heads:, valid_rows * gw:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [4, 36, 136])
def test_relpos_qkv_any_head_width_matches_pallas(hd, dtype):
    W, nh, g = 3, 2, 7
    rng = np.random.default_rng(hd)
    qkv = rng.standard_normal((W, 3, nh, g * g, hd)).astype(np.float32)
    rh = (0.3 * rng.standard_normal((2 * g - 1, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((2 * g - 1, hd))).astype(np.float32)
    (jqkv, tqkv), (jrh, trh), (jrw, trw) = (_pair(a, dtype)
                                            for a in (qkv, rh, rw))
    want = jax_windowed_attention_qkv(jqkv, jrh, jrw, grid_h=g, grid_w=g,
                                      interpret=True)
    assert attention_body("relpos_attention_qkv", tqkv.dtype, hd, g * g, g, g,
                          nh) == "general"
    before = _counts()
    got = windowed_attention_qkv(tqkv, trh, trw, grid_h=g, grid_w=g)
    assert _counts() == before
    assert got.dtype == tqkv.dtype and got.shape == (W, nh, g * g, hd)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               atol=_step_atol(_f32(want), dtype), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [36, 64])
@pytest.mark.parametrize("ws", [15, 16, 24])
def test_windowed_attention_fused_wide_windows_match_pallas(ws, hd, dtype):
    """Two windows (a ws x 2 ws padded grid) of 2 heads, q, k, v the
    channel slices of one qkv tensor."""
    heads = 2
    C = heads * hd
    rng = np.random.default_rng(ws + hd)
    qkv = rng.standard_normal((1, ws, 2 * ws, 3 * C)).astype(np.float32)
    rh = (0.3 * rng.standard_normal((ws, ws, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((ws, ws, hd))).astype(np.float32)
    (jqkv, tqkv), (jrh, trh), (jrw, trw) = (_pair(a, dtype)
                                            for a in (qkv, rh, rw))
    want = jax_windowed_attention_fused(
        jqkv[..., :C], jqkv[..., C:2 * C], jqkv[..., 2 * C:], jrh, jrw, ws=ws,
        num_heads=heads, interpret=True)
    assert attention_body("windowed_attention_fused", tqkv.dtype, hd, ws * ws,
                          ws, ws, heads) == "general"
    before = _counts()
    got = windowed_attention_fused(tqkv[..., :C], tqkv[..., C:2 * C],
                                   tqkv[..., 2 * C:], trh, trw, ws=ws,
                                   num_heads=heads)
    assert _counts() == before
    assert got.dtype == tqkv.dtype and got.shape == (1, ws, 2 * ws, C)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               atol=_step_atol(_f32(want), dtype), rtol=0)


def test_tinyvit_window_24_matches_jax():
    """TinyViT at image size 64 with stage 2's window 24 (its 4 x 4 grid
    pads to one window of 576 tokens: K2 general on the card), nonzero
    attention and qkv biases, JAX's levit kernel in interpret mode."""
    windows = (7, 7, 24, 7)
    jcfg = jax_tinyvit.TinyViTConfig(img_size=64, window_sizes=windows)
    params = jax.tree_util.tree_map(
        np.asarray, jax_tinyvit.init_tiny_vit(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(24)
    for stage in params["stages"][1:]:
        for b in stage["blocks"]:
            ab = b["attn"]["attention_biases"]
            b["attn"]["attention_biases"] = (
                0.5 * rng.standard_normal(ab.shape)).astype(np.float32)
            qb = b["attn"]["qkv"]["b"]
            b["attn"]["qkv"]["b"] = (0.3 * rng.standard_normal(qb.shape)
                                     ).astype(np.float32)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    jcfg = dataclasses.replace(jcfg, use_flash_attention=True,
                               fused_interpret=True)
    want = np.asarray(jax_tinyvit.tiny_vit_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jcfg))
    cfg = tinyvit.TinyViTConfig(img_size=64, window_sizes=windows,
                                use_flash_attention=True)
    model = tinyvit.TinyViT(cfg)
    model.load_state_dict(params_from_numpy(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 4, 4, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_sam_vit_head_width_36_fused_windows_matches_jax():
    """A SAM ViT of 2 heads of 36 at image size 320 (grid 20, padded to two
    by two windows of 16 x 16): block 0 on ``fused_window_blocks`` (K6 at
    ws 16, hd 36), block 1 global (K4 at hd 36), nonzero rel-pos tables,
    pos_embed and qkv bias; JAX's strip and grouped kernels in interpret
    mode."""
    def config(mod):
        return mod.SamViTConfig(img_size=320, embed_dim=72, depth=2,
                                num_heads=2, window_size=16,
                                global_attn_indexes=(1,),
                                fused_window_blocks=True,
                                use_flash_attention=True)
    jcfg = dataclasses.replace(config(jax_vit), flash_interpret=True)
    params = jax.tree_util.tree_map(
        np.asarray, jax_vit.init_sam_vit(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(36)

    def fill(a, std):
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    params["pos_embed"] = fill(params["pos_embed"], 0.5)
    for b in params["blocks"]:
        b["rel_pos_h"] = fill(b["rel_pos_h"], 0.3)
        b["rel_pos_w"] = fill(b["rel_pos_w"], 0.3)
        b["qkv"]["b"] = fill(b["qkv"]["b"], 0.3)
    x = rng.standard_normal((1, 320, 320, 3)).astype(np.float32)
    want = np.asarray(jax_vit.sam_vit_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jcfg))
    model = vit_sam.SamViT(config(vit_sam))
    model.load_state_dict(params_from_numpy(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 20, 20, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# The main paths' shapes: K2 (G, N, nh) at kd 32 (MobileSAM at 1024); K4
# the ViTs' 64 x 64 global grids, K5 / K7 their 14 x 14 windows, K6 the
# fused ViT-B's (and ViT-H's) 14 x 14 windows, at hd 64 (ViT-B / L) and 80
# (ViT-H).
MAIN_PATH_SHAPES = (
    [("levit_window_attention", 32, N, 0, 0, nh)
     for _, N, nh in ((361, 49, 4), (25, 196, 5), (100, 49, 10))]
    + [(k, hd, n, g, g, nh) for hd, nh in ((64, 12), (64, 16), (80, 16))
       for k, n, g in (("relpos_attention_global", 4096, 64),
                       ("relpos_attention_windowed", 196, 14),
                       ("relpos_attention_qkv", 196, 14),
                       ("windowed_attention_fused", 196, 14))])
# The geometries of the tests above, and of chip_smoke.py phase 20.
GENERAL_SHAPES = (
    [("levit_window_attention", kd, N, 0, 0, 2) for kd in (8, 12, 48)
     for N in (49, 576)]
    + [("levit_window_attention", 32, N, 0, 0, 5) for N in (576, 1024)]
    + [(k, hd, n, gh, gw, 2) for hd in (1, 4, 12, 36, 100, 136, 200, 256)
       for k in ATTENTION_KERNELS[1:]
       for n, gh, gw in ((49, 7, 7), (120, 10, 12))]
    + [("windowed_attention_fused", hd, ws * ws, ws, ws, 2) for hd in (36, 64)
       for ws in (15, 16, 24, 32)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_routing_main_paths_tuned_c12_general(dtype):
    for kernel, hd, n, gh, gw, heads in MAIN_PATH_SHAPES:
        assert attention_body(kernel, dtype, hd, n, gh, gw, heads) == "tuned", (
            kernel, hd, n)
    for kernel, hd, n, gh, gw, heads in GENERAL_SHAPES:
        assert attention_body(kernel, dtype, hd, n, gh, gw, heads) == "general", (
            kernel, hd, n, gh, gw)
    # 16-bit K5 / K7 windows with a side above 16 (8 x 32) are general on
    # the low-level wrappers (float32 tuned); the routers still send them
    # to K4, which is tuned there.
    wide = "tuned" if dtype == torch.float32 else "general"
    for kernel in ("relpos_attention_windowed", "relpos_attention_qkv"):
        assert attention_body(kernel, dtype, 64, 256, 8, 32, 2) == wide
    assert attention_body("relpos_attention_global", dtype, 64, 256, 8, 32) == "tuned"
    assert relpos_route(dtype, 6, 8, 32, heads=2) == (
        "windowed" if dtype == torch.float32 else "global")
    # K7 splits its launches by whole windows: more heads than a launch's
    # groups take the general body; any group count stays tuned.
    assert attention_body("relpos_attention_qkv", dtype, 64, 196, 14, 14,
                          70000) == "general"
    assert attention_body("relpos_attention_global", dtype, 64, 196, 14,
                          14) == "tuned"
