"""Inference environment: device selection, model registry, executable
cache (counterpart of dlimgedit_tpu/runtime/environment.py).

Model directory convention, shared with the JAX package:
``model_directory/segmentation/<name>.npz``, optionally pinned by a
``<name>.npz.sha256`` file beside it. Encoder weights follow the compute
dtype; the prompt encoder and decoder stay float32.

On a CUDA device the encoders run the port's kernels: TinyViT K1
(LayerNorm) and K2 (window attention); the SAM ViTs K1 and K3 (LayerNorm,
residual add + LayerNorm), K4 (global rel-pos attention) and K5 (windowed
rel-pos attention). On the CPU they run the plain path. Executables are
plain eager callables: no ``torch.compile`` and no CUDA graphs yet.
"""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from ..convert.from_numpy import params_from_numpy
from ..errors import DlimgError, ModelNotFoundError, not_in_this_slice
from ..models import sam as sam_lib
from ..ops.preprocess import CanvasPool
from ..types import Backend, Options
from ..utils.profiling import Profiler
from ..utils.pytree_io import load_pytree
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
    if o.quantize_encoder or o.quantize_activations:
        raise not_in_this_slice("int8 quantisation (quantize_encoder, "
                                "quantize_activations)", "quantisation")
    if o.scaleout_devices != 1:
        raise not_in_this_slice("scaleout_devices != 1", "parallel")
    if o.compilation_cache_dir:
        raise not_in_this_slice("compilation_cache_dir", "CUDA graph")
    if o.compute_dtype not in _DTYPES:
        raise DlimgError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {o.compute_dtype!r}")


class SamModelBundle:
    """A loaded SAM variant: config + model resident on the device."""

    def __init__(self, cfg: sam_lib.SamConfig, model: sam_lib.Sam,
                 compute_dtype: torch.dtype):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
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
        self.compute_dtype = _DTYPES[self.options.compute_dtype]
        self._sam_models: Dict[str, Lazy] = {v: Lazy() for v in SAM_BUNDLES}
        self._executables: Dict[Tuple, Callable] = {}
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
        with self._exec_lock:
            hit = self._sizes_cache.get(key)
            if hit is not None:
                return hit
        arr = torch.tensor(key, dtype=torch.int32, device=self.device)
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
        if self.device.type == "cuda" and cfg.encoder_tiny is not None:
            # The port's kernels K1 (LayerNorm) and K2 (window attention).
            cfg = dataclasses.replace(cfg, encoder_tiny=dataclasses.replace(
                cfg.encoder_tiny, use_fused_norm=True, use_flash_attention=True))
        elif self.device.type == "cuda":
            # K4 / K5 (rel-pos attention); the LayerNorms (K1, K3) follow.
            cfg = dataclasses.replace(cfg, encoder_vit=dataclasses.replace(
                cfg.encoder_vit, use_flash_attention=True))
        path = self.model_directory / "segmentation" / SAM_BUNDLES[variant]
        if path.exists():
            model = sam_lib.Sam(cfg)
            model.load_state_dict(params_from_numpy(self._verified_load(path)),
                                  strict=True)
        elif self.options.allow_random_weights:
            model = sam_lib.init_sam(torch.Generator().manual_seed(0), cfg)
        else:
            raise ModelNotFoundError(
                f"Model file not found: {path} (convert a checkpoint with "
                f"dlimgedit_tpu.convert, or set allow_random_weights)")
        # The JAX package's cast_tree: with no int8 leaves in this slice it
        # is a plain cast of the encoder.
        model.encoder.to(self.compute_dtype)
        return SamModelBundle(cfg, model.to(self.device), self.compute_dtype)

    # -- executable cache ----------------------------------------------------

    def executable(self, key: Tuple, build: Callable[[], Callable]) -> Callable:
        """Get-or-build an eager program, one per key, run under
        ``torch.inference_mode``."""
        fn = self._executables.get(key)
        if fn is not None:
            return fn
        with self._exec_lock:
            fn = self._executables.get(key)
            if fn is None:
                fn = self.profiler.wrap("/".join(str(k) for k in key),
                                        torch.inference_mode()(build()))
                self._executables[key] = fn
        return fn
