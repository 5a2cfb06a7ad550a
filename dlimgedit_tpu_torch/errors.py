"""Error model of the PyTorch port (counterpart of dlimgedit_tpu/errors.py)."""


class DlimgError(Exception):
    """Base exception for the dlimgedit_tpu_torch library."""


class ModelNotFoundError(DlimgError):
    """A required weight bundle is missing from the model directory."""


class UnsupportedImageError(DlimgError):
    """Unsupported channel count / format."""


