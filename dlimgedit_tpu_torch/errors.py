"""Error model of the PyTorch port (counterpart of dlimgedit_tpu/errors.py)."""


class DlimgError(Exception):
    """Base exception for the dlimgedit_tpu_torch library."""


class ModelNotFoundError(DlimgError):
    """A required weight bundle is missing from the model directory."""


class UnsupportedImageError(DlimgError):
    """Unsupported channel count / format."""


def not_in_this_slice(what: str, slice_name: str) -> DlimgError:
    """The error for a feature of the JAX package the port does not have yet;
    `slice_name` names the later slice of the port that brings it."""
    return DlimgError(
        f"{what} is not ported to dlimgedit_tpu_torch yet (it comes with the "
        f"{slice_name} slice; see ROADMAP.md). Use dlimgedit_tpu for it.")


# The slice that brings canvas-row sharding (ROADMAP.md A3b): MobileSAM's
# and BiRefNet's scale-out and parallel/spatial.py.
CANVAS_ROWS = "canvas-row sharding (A3b)"
