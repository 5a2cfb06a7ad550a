"""The executable cache (``Environment.executable``) on the CPU.

On the CPU every key runs eagerly; on CUDA each is a CUDA graph, which the
card tests (``tests/test_torch_cuda.py -k graph``) and ``chip_smoke.py``
hold bit for bit against the key's eager program. Here:

  * the CPU Environment's executables are eager, and a `process` in the
    same bucket leaves an earlier Segmentation's embedding and masks
    alone, with a narrow injected ``vit_b`` bundle;
  * the graph logic of ``Executable`` (copy-in, copy-out, launch
    counters), for a one-stage program and a (head, between, tail) one,
    with its CUDA steps (the side stream, the capture) replaced by CPU
    fakes: the capture's counter increments are taken back and each
    replay adds them again, while the warm-up's and the eager stage's
    count as they run;
  * the decode keys with largest_component are split around the
    labelling, which reads the device from the host (the eager stage
    between two graphs); their masks are held against JAX's in
    tests/test_torch_segmentation.py and tests/test_torch_vit_sam.py;
  * automatic mask generation: a threshold change reuses the key, a new
    grid or the small-region filter makes one new key, and the filter's
    program is (head, refine, tail); with the fake graphs each call equals
    the eager program on its own thresholds.

Marked `cuda` (skipped here): the AMG keys as real CUDA graphs, replays
bit-equal to `.eager`, with and without the small-region filter.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.ops import amg, fused_norm
from dlimgedit_tpu_torch.ops.flash_attention import levit_window_attention
from dlimgedit_tpu_torch.runtime.environment import (
    COUNTED_KERNELS,
    Executable,
    SamModelBundle,
    add_launches,
    launch_counts,
)
from dlimgedit_tpu_torch.runtime.amg import _build_amg_fn
from dlimgedit_tpu_torch.utils.profiling import Profiler

torch.set_num_threads(2)

IMAGE_SIZE = 256


def _narrow_vit_env():
    """A CPU Environment holding a narrow vit_b bundle (width 128, 2 heads,
    one windowed and one global block), as tests/test_torch_vit_sam.py
    injects one."""
    env = pdl.Environment(pdl.Options(
        backend=pdl.Backend.cpu, allow_random_weights=True,
        compute_dtype="float32", sam_variant="vit_b",
        sam_image_size=IMAGE_SIZE, largest_region_object=True,
        model_directory="no-such-directory"))
    enc = vit_sam.SamViTConfig(img_size=IMAGE_SIZE, embed_dim=128, depth=2,
                               num_heads=2, global_attn_indexes=(1,))
    cfg = dataclasses.replace(sam.make_config("vit_b", IMAGE_SIZE),
                              encoder_vit=enc)
    bundle = SamModelBundle(cfg, sam.init_sam(torch.Generator().manual_seed(1),
                                              cfg), torch.float32)
    assert env._sam_models["vit_b"].get_or_create(lambda: bundle) is bundle
    return env


def _image(seed):
    px = np.random.default_rng(seed).integers(0, 256, (200, 300, 4),
                                              dtype=np.uint8)
    return pdl.Image(pdl.Extent(300, 200), pdl.Channels.rgba, px)


def test_cpu_executables_are_eager_and_results_do_not_alias():
    env = _narrow_vit_env()
    a = pdl.Segmentation.process(_image(1), env)
    a_emb = a.embedding.clone()
    region = pdl.Region(pdl.Point(30, 20), pdl.Point(260, 180))
    a_masks = [a.compute_mask(pdl.Point(150, 100)).pixels,
               a.compute_mask(region).pixels]
    b = pdl.Segmentation.process(_image(2), env)  # the same bucket (512)
    assert not torch.equal(b.embedding, a_emb)
    assert torch.equal(a.embedding, a_emb)
    assert np.array_equal(a.compute_mask(pdl.Point(150, 100)).pixels, a_masks[0])
    assert np.array_equal(a.compute_mask(region).pixels, a_masks[1])
    assert {k[0] for k in env.executables} == {"embed", "decode"}
    for key, exe in env.executables.items():
        assert not exe.graphed and exe.input_buffer(0) is None, key
    emb_exe = env.executables[("embed", "vit_b", 512, "none")]
    canvas = torch.zeros((512, 512, 3), dtype=torch.uint8)
    sizes = torch.tensor([200, 300, 171, 256], dtype=torch.int32)
    assert torch.equal(emb_exe(canvas, sizes), emb_exe.eager(canvas, sizes))


class _CpuGraphed(Executable):
    """``Executable``'s graph path with the CUDA steps faked on the CPU: the
    capture runs the stage once (its Python, counters included, as a real
    capture does) and a replay reruns it into the static outputs with its
    counters taken back (a real replay runs no Python)."""

    def __init__(self, key, program):
        super().__init__(key, program, torch.device("cpu"), _clone_all,
                         Profiler())
        self.graphed = True
        self.replays = 0

    def _on_side_stream(self):
        return contextlib.nullcontext()

    def _capture(self, fn, static_inputs):
        exe, outputs = self, fn(*static_inputs)

        class Graph:
            def replay(self):
                exe.replays += 1
                before = launch_counts()
                with torch.inference_mode():
                    for o, n in zip(_flat(outputs), _flat(fn(*static_inputs))):
                        o.copy_(n)
                add_launches([b - a for a, b in zip(launch_counts(), before)])

        return Graph(), outputs


def _flat(t):
    return t if isinstance(t, tuple) else (t,)


def _clone_all(outputs):
    return tuple(t.clone() for t in _flat(outputs))


def _delta(start):
    return [b - a for a, b in zip(start, launch_counts())]


K1 = COUNTED_KERNELS.index(fused_norm.fused_layer_norm)
K2 = COUNTED_KERNELS.index(levit_window_attention)


def _head(x, scale):
    """Counts as two K1 launches (the plain versions on the CPU count
    nothing, so the stage counts itself)."""
    fused_norm.fused_layer_norm.launches += 2
    return x * scale, scale


def _between(y, scale):
    """An eager stage: one K2 launch, counted as it runs."""
    levit_window_attention.launches += 1
    return y + 1.0, scale


def _tail(y, scale):
    fused_norm.fused_layer_norm.launches += 1
    return y * scale


@pytest.mark.parametrize("stages", ["one", "head_between_tail"])
def test_graphed_executable_counts_replays_and_copies_in_and_out(stages):
    """Each call counts one call's launches: the warm-up's at the first,
    then each replay's and the eager stage's, never the capture's."""
    staged = stages == "head_between_tail"
    exe = _CpuGraphed(("probe",), (_head, _between, _tail) if staged
                      else _head)
    want = (3, 1) if staged else (2, 0)  # K1, K2 per call
    start = launch_counts()
    outs = []
    for i in range(4):
        x = torch.full((3,), float(i + 1))
        outs.append(exe(x, torch.tensor(2.0))[0])
        delta = _delta(start)
        assert (delta[K1], delta[K2]) == (want[0] * (i + 1), want[1] * (i + 1))
        assert sum(delta) == sum(want) * (i + 1)
    assert exe.replays == 3 * (2 if staged else 1)
    for i, out in enumerate(outs):  # each call's result is its own
        y = torch.full((3,), 2.0 * (i + 1))
        assert torch.equal(out, (y + 1.0) * 2.0 if staged else y)
    # An argument that is the static buffer is not copied over.
    buf = exe.input_buffer(0)
    buf.fill_(7.0)
    got = exe(buf, torch.tensor(3.0))[0]
    assert torch.equal(got, torch.full((3,), 66.0 if staged else 21.0))
    start = launch_counts()
    replayed, eager = exe.replay_against_eager()
    assert all(torch.equal(a, b) for a, b in zip(replayed, eager))
    assert launch_counts() == start


def test_labelled_decode_is_split_around_the_labelling():
    """The decode keys with largest_component are (decode, label, finish):
    their composition is the program, and the other keys one stage."""
    env = _narrow_vit_env()
    seg = pdl.Segmentation.process(_image(1), env)
    region = pdl.Region(pdl.Point(30, 20), pdl.Point(260, 180))
    seg.compute_mask(region)
    seg.compute_mask(region, largest_component=False)
    seg.compute_mask_batch([region, pdl.Point(50, 50)])
    stages = {k: len(e._stages) for k, e in env.executables.items()}
    assert stages == {("embed", "vit_b", 512, "none"): 1,
                      ("decode", "vit_b", 512, False, True): 3,
                      ("decode", "vit_b", 512, False, False): 1,
                      ("decode_batch", "vit_b", 512, 2, True): 3}


# -- automatic mask generation ----------------------------------------------

AMG_KW = dict(grid=4, max_masks=4, iou_thresh=0.0, stability_thresh=0.0)


def _mobile_env(backend=pdl.Backend.gpu, dtype="float32"):
    return pdl.Environment(pdl.Options(
        backend=backend, allow_random_weights=True, compute_dtype=dtype,
        sam_image_size=64, model_directory="no-such-directory"))


def _small_image(seed):
    px = np.random.default_rng(seed).integers(0, 256, (64, 96, 4), dtype=np.uint8)
    return pdl.Image(pdl.Extent(96, 64), pdl.Channels.rgba, px)


def test_amg_executable_per_key():
    """Thresholds are a device vector (no new key); the grid and the
    small-region filter are part of the key, as in JAX (tests/test_amg.py)."""
    env = _mobile_env(pdl.Backend.cpu)
    seg = pdl.Segmentation.process(_small_image(0), env)
    seg.generate_masks(**AMG_KW)
    n0 = len(env.executables)
    seg.generate_masks(**dict(AMG_KW, iou_thresh=0.5, stability_thresh=0.2,
                              nms_thresh=0.9))
    assert len(env.executables) == n0
    seg.generate_masks(**dict(AMG_KW, grid=2))
    assert len(env.executables) == n0 + 1
    seg.generate_masks(min_mask_region_area=9, **AMG_KW)
    assert len(env.executables) == n0 + 2
    seg.generate_masks(min_mask_region_area=25, **AMG_KW)
    assert len(env.executables) == n0 + 2
    stages = {k[3:]: len(e._stages) for k, e in env.executables.items()
              if k[0] == "amg"}
    assert stages == {(4, 4, 48, False): 1, (2, 4, 12, False): 1,
                      (4, 4, 48, True): 3}


@pytest.mark.parametrize("refine", [False, True])
def test_amg_graph_logic_follows_the_thresholds(refine):
    """Through the fake graphs: one capture, then each call's thresholds
    copied into the static input give that call's eager result."""
    env = _mobile_env(pdl.Backend.cpu)
    seg = pdl.Segmentation.process(_small_image(1), env)
    bundle = env.sam_model()
    exe = _CpuGraphed(("amg",), _build_amg_fn(bundle, 256, 4, 8, 48, refine))
    for thr in ((0.0, 0.0, 0.7, 0.0, 1.0, 6.0), (0.0, 0.0, 1.0, 0.0, 1.0, 6.0),
                (0.1, 0.5, 1.0, 0.0, 0.9, 40.0)):
        t = torch.tensor(thr)
        got = exe(seg.embedding, seg._sizes(), t)
        want = exe.eager(seg.embedding, seg._sizes(), t)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), thr
    assert exe.replays == 2 * (2 if refine else 1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the NMS kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_amg_graph_replay_equals_eager(dev, dtype):
    env = _mobile_env(dtype=dtype)
    seg = pdl.Segmentation.process(_small_image(2), env)
    calls = [dict(AMG_KW), dict(AMG_KW, nms_thresh=1.0, max_masks=8),
             dict(AMG_KW, min_mask_region_area=300)]
    first = None
    for rnd in range(3):  # warm-up and capture, then replays
        before = amg.greedy_nms.launches
        out = [seg.generate_masks(**kw) for kw in calls]
        assert amg.greedy_nms.launches == before + len(calls)
        masks = [m.image.pixels for ms in out for m in ms]
        first = first or masks
        assert len(masks) == len(first)
        assert all(np.array_equal(a, b) for a, b in zip(masks, first))
        for key, exe in env.executables.items():
            if key[0] != "amg":
                continue
            assert exe.graphed and exe.captured
            got, want = exe.replay_against_eager()
            for g, w in zip(got, want):
                assert torch.equal(g, w), key
    assert {len(e._stages) for k, e in env.executables.items()
            if k[0] == "amg"} == {1, 3}
    # A new threshold reuses the key's graph and gives the eager result.
    n0 = len(env.executables)
    seg.generate_masks(**dict(AMG_KW, nms_thresh=0.95, iou_thresh=0.05))
    assert len(env.executables) == n0
    key = next(k for k in env.executables if k[0] == "amg" and k[4] == 4
               and not k[6])
    got, want = env.executables[key].replay_against_eager()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
