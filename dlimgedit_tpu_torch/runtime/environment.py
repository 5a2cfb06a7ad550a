"""Inference environment: device selection, model registry, executable
cache (counterpart of dlimgedit_tpu/runtime/environment.py).

Model directory convention, shared with the JAX package:
``model_directory/segmentation/<name>.npz``, optionally pinned by a
``<name>.npz.sha256`` file beside it. Encoder weights follow the compute
dtype; the prompt encoder and decoder stay float32. With
``Options.quantize_encoder`` (or ``quantize_activations``, which implies
it) the encoder's attention and MLP linears are quantised to int8 first,
from the float32 weights (ops/quant.py), and their float32 scales survive
the cast. BiRefNet (``birefnet_model``, one per kind; runtime/birefnet.py)
follows the compute dtype whole and is never quantised.

On a CUDA device the encoders run the port's kernels: TinyViT K1
(LayerNorm) and K2 (window attention); the SAM ViTs K1 and K3 (LayerNorm,
residual add + LayerNorm), K4 (global rel-pos attention) and K5 (windowed
rel-pos attention); a w8a8 encoder's linears also P2 and P3
(ops/quant.py). On the CPU they run the plain path. Automatic mask
generation's greedy box NMS runs one kernel of its own
(``ops/amg.py::greedy_nms``).

Each (program, variant, bucket, ...) key is one ``Executable``. On a CUDA
device it is a captured ``torch.cuda.CUDAGraph``, the counterpart of the
JAX package's one XLA executable per key: its first call runs the program
eagerly on a side stream (the warm-up, whose result it returns) and then
captures it; every later call copies its inputs into the graph's static
buffers and replays it. On the CPU it runs the program eagerly. No
``torch.compile``.

``Options.scaleout_devices`` over 2 or more of the backend's distinct
devices (``backend_devices``) gives the environment an ('sp',) ``mesh``
(parallel/sp.py), as the JAX package's; the ViTs' embed program then runs
sequence-parallel over it, eagerly (it crosses devices).
"""

from __future__ import annotations

import contextlib
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..convert.from_numpy import load_into
from ..errors import DlimgError, ModelNotFoundError
from ..models import sam as sam_lib
from ..models.common import cast_tree, full_precision
from ..ops import amg, flash_attention, fused_norm, quant
from ..ops.preprocess import CanvasPool
from ..parallel.mesh import cuda_devices
from ..types import Backend, Options
from ..utils.profiling import Profiler
from ..utils.pytree_io import load_pytree
from .birefnet import BIREFNET_RESOLUTION, BiRefNetBundle, load_birefnet
from .lazy import Lazy

# Weight-bundle file names per SAM variant (the JAX package's names).
SAM_BUNDLES = {
    "mobile_sam": "mobile_sam.npz",
    "vit_b": "sam_vit_b.npz",
    "vit_l": "sam_vit_l.npz",
    "vit_h": "sam_vit_h.npz",
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def is_supported(backend: Backend) -> bool:
    """cpu is always available; gpu needs a CUDA device."""
    if backend == Backend.cpu:
        return True
    return torch.cuda.is_available()


def _variant(name: str) -> str:
    """The registry key of a SAM variant name ("vit_t" is MobileSAM)."""
    name = "mobile_sam" if name == "vit_t" else name
    if name not in SAM_BUNDLES:
        raise DlimgError(f"Unknown SAM variant {name!r} (have "
                         f"{sorted(SAM_BUNDLES)} and 'vit_t')")
    return name


def _reject_unported(o: Options) -> None:
    _variant(o.sam_variant)
    if o.compilation_cache_dir:
        raise DlimgError(
            "compilation_cache_dir has no counterpart in dlimgedit_tpu_torch: "
            "its executables are CUDA graphs, which live only as long as "
            "their process, and the kernel library is already cached on "
            "disk (dlimgedit_tpu_torch/_build/)")
    if o.compute_dtype not in _DTYPES:
        raise DlimgError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {o.compute_dtype!r}")


def backend_devices(device: torch.device) -> List[torch.device]:
    """The distinct devices of ``device``'s backend: every CUDA device, or
    the one CPU."""
    if device.type == "cuda":
        return cuda_devices()
    return [device]


def _scaleout(requested: int, device: torch.device):
    """``Options.scaleout_devices`` as the JAX package reads it: 1 is off,
    0 means every device of the backend, N means min(N, that count). With
    2 or more, a 1-D ('sp',) mesh over the first n of them (the latency
    tier: parallel/sp.py); fewer take the single-device path, so a
    serving config may set 0 whatever the machine. -> the mesh or None."""
    if requested == 1:
        return None
    devices = backend_devices(device)
    n = len(devices) if requested == 0 else min(requested, len(devices))
    if n < 2:
        return None
    from ..parallel.sp import make_sp_mesh

    return make_sp_mesh(n, devices=devices[:n])


# The kernel wrappers whose ``launches`` counters the executables keep: a
# replay launches the kernels its capture recorded, but no Python runs.
COUNTED_KERNELS = (
    fused_norm.fused_layer_norm, fused_norm.fused_add_layer_norm,
    flash_attention.levit_window_attention,
    flash_attention.relpos_attention_global,
    flash_attention.relpos_attention_windowed,
    flash_attention.relpos_attention_qkv,
    flash_attention.windowed_attention_fused,
    amg.greedy_nms,
    quant.quantize_rows_int8, quant.int8_epilogue,
)

# One capture at a time in the process (a rule of torch.cuda.graph).
_CAPTURE_LOCK = threading.Lock()


# Every count the executables keep: each kernel's ``launches``, then the
# attention wrappers' ``general_launches`` (their general-body launches).
_COUNTS = (tuple((k, "launches") for k in COUNTED_KERNELS)
           + tuple((k, "general_launches") for k in COUNTED_KERNELS
                   if hasattr(k, "general_launches")))


def launch_counts() -> Tuple[int, ...]:
    return tuple(getattr(k, attr) for k, attr in _COUNTS)


def add_launches(delta: Sequence[int]) -> None:
    for (k, attr), d in zip(_COUNTS, delta):
        setattr(k, attr, getattr(k, attr) + d)


def _as_tuple(outputs) -> Tuple[torch.Tensor, ...]:
    return outputs if isinstance(outputs, tuple) else (outputs,)


def _compose(stages: Sequence[Callable]) -> Callable:
    def run(*args):
        out = stages[0](*args)
        for stage in stages[1:]:
            out = stage(*_as_tuple(out))
        return out

    return run


def _scoped(fn: Callable) -> Callable:
    """``fn`` under inference mode with float32 at full precision (the
    caller's TF32 flags put back afterwards): its eager runs, its warm-up
    and its capture, so a graph keeps full-precision algorithms. Every
    program has float32 products, also in bf16: the device resample
    (ops/resample.py), the SAM decoder, BiRefNet's ASPP sums. This is the
    port's one precision scope; its flags are process-wide
    (``full_precision``)."""
    return torch.inference_mode()(full_precision()(fn))


class _Graph:
    """One captured stage: its static inputs and outputs, and the kernel
    launches its capture counted."""

    def __init__(self, graph, static_inputs, static_outputs, launches):
        self.graph = graph
        self.static_inputs = static_inputs
        self.static_outputs = static_outputs
        self.launches = launches


class Executable:
    """One program of the executable cache.

    ``build()`` gives the program: one callable, or a tuple (head, between,
    tail) of callables, each taking the previous one's outputs, whose
    ``between`` runs eagerly on every call (it reads the device from the
    host, which no graph may do: the component labelling). ``eager`` is the
    whole program; every stage runs under ``torch.inference_mode`` and
    ``models.common.full_precision`` (float32 whatever the caller's TF32
    flags, also in the capture). Tests and ``chip_smoke.py`` hold the
    graphs against ``eager``; the main path never calls it directly.
    ``copy_out`` turns the program's outputs into what the
    caller keeps: a replay overwrites its static outputs, so what outlives
    the call is copied out under ``lock`` (a device clone, or the host
    copy that ends a decode).

    On a CUDA device (``graphed``; a measurement may set it False to run
    the eager program through the same entry points) the first call runs
    the program eagerly on a side stream, the warm-up (this makes the
    lazily cached device tensors, e.g. the pixel statistics and rel-pos
    indices, outside any capture), returns that result, and then captures
    the head, and the tail, each into a ``CUDAGraph`` with static input
    buffers shaped like that call's. Every later call copies its arguments
    into the head's buffers (an argument that already is the buffer, such
    as a canvas packed with ``out=input_buffer(0)``, is not copied; host
    tensors go through a pinned staging buffer, asynchronously), replays,
    runs ``between`` on the head's outputs, copies its results into the
    tail's buffers, replays the tail, and copies out. ``lock``
    (re-entrant) covers all of it; a caller that fills a static buffer
    itself holds it around that and the call. A capture that fails raises
    ``DlimgError`` naming the key: nothing runs eagerly in its place.

    The graphs read the model's weights from the storages they had at
    capture: weights may be overwritten in place (``copy_``) at any time,
    but a model or config that is swapped (e.g. ``bundle.cfg`` replaced)
    must be so before the key's first call.

    Kernel launch counters: the Python counters run once, at capture, so
    the capture's increments are taken back and added again on each
    replay; the warm-up's launches, and ``between``'s, count as the real
    launches they are. (Like the counters themselves, this is exact when
    one thread drives the kernels.)
    """

    def __init__(self, key: Tuple, program, device: torch.device,
                 copy_out: Callable[[Any], Any], profiler: Profiler):
        stages = program if isinstance(program, tuple) else (program,)
        if len(stages) not in (1, 3):
            raise DlimgError(f"executable {key}: a program is one callable "
                             f"or (head, between, tail)")
        self.key = key
        self._stages = [_scoped(f) for f in stages]
        self.eager = _scoped(_compose(stages))
        self.graphed = device.type == "cuda"
        self.lock = threading.RLock()
        self._device = device
        self._copy_out = copy_out
        self._profile_key = "/".join(str(k) for k in key)
        self._profiler = profiler
        self._graphs: List[_Graph] = []  # the head's, then the tail's
        self._side = None
        self._staging: Dict[int, torch.Tensor] = {}
        self._staged = None  # event behind the last copy out of staging

    @property
    def captured(self) -> bool:
        return bool(self._graphs)

    @property
    def graphs(self) -> Tuple["torch.cuda.CUDAGraph", ...]:
        """The captured graphs, the head's then the tail's (none before the
        capture, and on the CPU). Each owns a private memory pool
        (``CUDAGraph.pool()``), which tools/memory_footprint.py reads."""
        return tuple(g.graph for g in self._graphs)

    @property
    def static_inputs(self) -> Optional[List[torch.Tensor]]:
        """The head graph's input buffers (None before the capture)."""
        return self._graphs[0].static_inputs if self._graphs else None

    def input_buffer(self, i: int) -> Optional[torch.Tensor]:
        """The static device buffer of argument ``i`` (None before the
        capture, and on the CPU)."""
        inputs = self.static_inputs
        return None if inputs is None else inputs[i]

    def __call__(self, *args: torch.Tensor):
        with self._profiler.measure(self._profile_key):
            if not self.graphed:
                return self._copy_out(
                    self.eager(*(a.to(self._device) for a in args)))
            with self.lock:
                if not self._graphs:
                    return self._warm_up_and_capture(args)
                self._copy_in(args)
                return self._copy_out(self._run())

    def replay_against_eager(self) -> Tuple[List[torch.Tensor],
                                            List[torch.Tensor]]:
        """Run the graphs on the last call's inputs, and the eager program
        on the same inputs: (replayed, eager) outputs, each a list of
        device tensors, for holding one against the other. The launch
        counters are left as they were."""
        if not self._graphs:
            raise DlimgError(f"executable {self.key} has no CUDA graph")
        counts = launch_counts()
        with self.lock:
            got = [t.clone() for t in _as_tuple(self._run())]
            want = list(_as_tuple(self.eager(*self.static_inputs)))
        add_launches([a - b for a, b in zip(counts, launch_counts())])
        return got, want

    def _run(self):
        """Replay the head; with (head, between, tail): run between on its
        outputs, copy them into the tail's inputs and replay the tail."""
        head = self._graphs[0]
        self._replay(head)
        if len(self._stages) == 1:
            return head.static_outputs
        mid = _as_tuple(self._stages[1](*_as_tuple(head.static_outputs)))
        tail = self._graphs[1]
        for buf, t in zip(tail.static_inputs, mid):
            if t is not buf:
                buf.copy_(t)
        self._replay(tail)
        return tail.static_outputs

    def _warm_up_and_capture(self, args):
        inputs = [a.to(self._device) for a in args]
        stage_inputs, result = self._warm_up(inputs)
        result = self._copy_out(result)
        graphs = []
        for i in range(0, len(self._stages), 2):
            static = [torch.empty_like(a) for a in stage_inputs[i]]
            for buf, a in zip(static, stage_inputs[i]):
                buf.copy_(a)
            before = launch_counts()
            try:
                graph, outputs = self._capture(self._stages[i], static)
            finally:
                launches = tuple(a - b for a, b in zip(launch_counts(),
                                                       before))
                add_launches([-d for d in launches])
            graphs.append(_Graph(graph, static, outputs, launches))
        self._graphs = graphs  # all captured, or none
        return result

    def _warm_up(self, inputs):
        """The program run eagerly, stage by stage, on the side stream.
        -> (each stage's inputs, the program's outputs)."""
        stage_inputs, out = [], tuple(inputs)
        with self._on_side_stream():
            for i, stage in enumerate(self._stages):
                stage_inputs.append(out)
                out = stage(*out)
                if i + 1 < len(self._stages):
                    out = _as_tuple(out)
        return stage_inputs, out

    @contextlib.contextmanager
    def _on_side_stream(self):
        """Run on the side stream that the captures then use (cuBLAS keeps
        a workspace per stream), ordered after the caller's work and
        before what the caller queues next."""
        caller = torch.cuda.current_stream(self._device)
        self._side = torch.cuda.Stream(self._device)
        self._side.wait_stream(caller)
        with torch.cuda.stream(self._side):
            yield
        caller.wait_stream(self._side)

    def _capture(self, fn, static_inputs):
        """-> (graph, static outputs) of ``fn`` on ``static_inputs``."""
        graph = torch.cuda.CUDAGraph()
        caller = torch.cuda.current_stream(self._device)
        try:
            with _CAPTURE_LOCK, torch.cuda.graph(
                    graph, stream=self._side, capture_error_mode="thread_local"):
                outputs = fn(*static_inputs)
        except RuntimeError as e:
            raise DlimgError(f"CUDA graph of executable {self.key}: capture "
                             f"failed: {e}") from e
        finally:
            # torch.cuda.graph leaves the capture stream current when ending
            # a broken capture raises.
            torch.cuda.set_stream(caller)
        return graph, outputs

    def _copy_in(self, args) -> None:
        for i, (buf, a) in enumerate(zip(self.static_inputs, args)):
            if a is buf:
                continue
            if a.device != buf.device:  # a host tensor: stage it pinned
                stage = self._staging.get(i)
                if stage is None:
                    stage = self._staging[i] = torch.empty(
                        a.shape, dtype=a.dtype, pin_memory=True)
                elif self._staged is not None:
                    self._staged.synchronize()
                stage.copy_(a)
                a = stage
            buf.copy_(a, non_blocking=True)
        if self._staging:
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(self._device))

    def _replay(self, g: _Graph) -> None:
        try:
            g.graph.replay()
        except RuntimeError as e:
            raise DlimgError(f"CUDA graph of executable {self.key}: replay "
                             f"failed: {e}") from e
        add_launches(g.launches)


class SamModelBundle:
    """A loaded SAM variant: config + model (moved to the device by the
    caller).

    The encoder follows ``compute_dtype``. With ``quantize`` or
    ``quantize_activations`` (which implies int8 weights) its linears are
    quantised BEFORE the cast, so the int8 scales come from the float32
    weights, and ``cast_tree`` keeps them float32. ``quant`` ("none", "w8"
    or "w8a8", read from the encoder once here) is part of the embed
    executable's key, so a graph of a float encoder is never replayed for
    a quantised one."""

    def __init__(self, cfg: sam_lib.SamConfig, model: sam_lib.Sam,
                 compute_dtype: torch.dtype, quantize: bool = False,
                 quantize_activations: bool = False):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        if quantize or quantize_activations:
            quant.quantize_encoder(model.encoder, act_int8=quantize_activations)
        cast_tree(model.encoder, compute_dtype)
        self.quant = quant.quant_mode(model.encoder)
        self.model = model.eval().requires_grad_(False)


class Environment:
    """Common inference infrastructure; caches models after first use.
    Thread-safe."""

    def __init__(self, options: Optional[Options] = None):
        self.options = options or Options()
        _reject_unported(self.options)
        self.model_directory = Path(self.options.model_directory)
        if (not self.options.allow_random_weights
                and not self.model_directory.is_dir()):
            raise DlimgError(
                f"Model path does not exist: {self.model_directory}")
        if self.options.backend == Backend.cpu:
            self.device = torch.device("cpu")
        elif is_supported(self.options.backend):
            self.device = torch.device("cuda", 0)
        else:
            raise DlimgError("GPU backend requested but no CUDA device is "
                             "available")
        # The latency scale-out mesh (Options.scaleout_devices), or None.
        self.mesh = _scaleout(self.options.scaleout_devices, self.device)
        self.compute_dtype = _DTYPES[self.options.compute_dtype]
        self._sam_models: Dict[str, Lazy] = {v: Lazy() for v in SAM_BUNDLES}
        self._birefnet_models: Dict[str, Lazy] = {
            k: Lazy() for k in BIREFNET_RESOLUTION}
        self._executables: Dict[Tuple, Executable] = {}
        self._exec_lock = threading.Lock()
        self._sizes_cache: Dict[Tuple[int, ...], torch.Tensor] = {}
        self.canvas_pool = CanvasPool() if self.device.type == "cuda" else None
        self.profiler = Profiler(enabled=self.options.enable_profiling,
                                 device=self.device)

    def sizes_on_device(self, values: Tuple[int, ...]) -> torch.Tensor:
        """Device-resident int32 sizes vector, cached per value tuple (extents
        repeat heavily in serving; each new tensor is a host copy). Bounded
        FIFO cache, thread-safe."""
        key = tuple(int(v) for v in values)
        return self._cached(key, lambda: torch.tensor(
            key, dtype=torch.int32, device=self.device))

    def floats_on_device(self, values: Tuple[float, ...]) -> torch.Tensor:
        """Device-resident float32 vector, cached per value tuple like
        ``sizes_on_device`` (the threshold vector of ``generate_masks``: a
        graph reads it as a static input, so a new value is a new input,
        never a new capture)."""
        key = ("f32",) + tuple(float(v) for v in values)
        return self._cached(key, lambda: torch.tensor(
            key[1:], dtype=torch.float32, device=self.device))

    def _cached(self, key: Tuple, make: Callable[[], torch.Tensor]
                ) -> torch.Tensor:
        with self._exec_lock:
            hit = self._sizes_cache.get(key)
            if hit is not None:
                return hit
        arr = make()
        with self._exec_lock:
            if len(self._sizes_cache) >= 256:
                self._sizes_cache.pop(next(iter(self._sizes_cache)))
            self._sizes_cache[key] = arr
        return arr

    # -- model registry ------------------------------------------------------

    def sam_model(self, variant: str = "mobile_sam") -> SamModelBundle:
        variant = _variant(variant)
        return self._sam_models[variant].get_or_create(
            lambda: self._load_sam(variant))

    def birefnet_model(self, kind: str = "general") -> BiRefNetBundle:
        """The BiRefNet of `kind` ("general" or "high_res"; see
        ``runtime/birefnet.py::load_birefnet``), loaded once."""
        if kind not in self._birefnet_models:
            raise DlimgError(f"Unknown BiRefNet kind {kind!r} (have "
                             f"{sorted(self._birefnet_models)})")
        return self._birefnet_models[kind].get_or_create(
            lambda: load_birefnet(self, kind))

    def _verified_load(self, path: Path):
        """Load a bundle, verifying a pinned sha256 when `<bundle>.sha256`
        exists next to it."""
        import hashlib

        pin = path.with_suffix(path.suffix + ".sha256")
        if pin.exists():
            expected = pin.read_text().split()[0].strip()
            with open(path, "rb") as f:
                actual = hashlib.file_digest(f, "sha256").hexdigest()
            if actual != expected:
                raise DlimgError(
                    f"Model bundle {path} failed integrity check: "
                    f"sha256 {actual} != pinned {expected}")
        return load_pytree(path)

    def _load_sam(self, variant: str) -> SamModelBundle:
        cfg = sam_lib.make_config(variant,
                                  image_size=self.options.sam_image_size)
        if self.device.type == "cuda":
            cfg = sam_lib.with_kernels(cfg)
        path = self.model_directory / "segmentation" / SAM_BUNDLES[variant]
        if path.exists():
            model = load_into(sam_lib.Sam(cfg), self._verified_load(path))
        elif self.options.allow_random_weights:
            model = sam_lib.init_sam(torch.Generator().manual_seed(0), cfg)
        else:
            raise ModelNotFoundError(
                f"Model file not found: {path} (convert a checkpoint with "
                f"dlimgedit_tpu_torch.convert, or set allow_random_weights)")
        o = self.options
        bundle = SamModelBundle(cfg, model, self.compute_dtype,
                                quantize=o.quantize_encoder,
                                quantize_activations=o.quantize_activations)
        bundle.model.to(self.device)
        return bundle

    # -- executable cache ----------------------------------------------------

    def executable(self, key: Tuple, build: Callable[[], Callable],
                   copy_out: Callable[[Any], Any],
                   graphed: bool = True) -> Executable:
        """Get-or-build the ``Executable`` of a key (see its docstring:
        on CUDA a CUDA graph, captured at its first call; eager with
        ``graphed=False``, for a program that crosses devices)."""
        fn = self._executables.get(key)
        if fn is not None:
            return fn
        with self._exec_lock:
            fn = self._executables.get(key)
            if fn is None:
                fn = Executable(key, build(), self.device, copy_out,
                                self.profiler)
                fn.graphed = fn.graphed and graphed
                self._executables[key] = fn
        return fn

    @property
    def executables(self) -> Dict[Tuple, Executable]:
        """The executables built so far, by key (a copy)."""
        with self._exec_lock:
            return dict(self._executables)
