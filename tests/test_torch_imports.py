"""The PyTorch port stands alone: no file of dlimgedit_tpu_torch/, not
chip_smoke.py and not the test helpers it imports, imports jax or the JAX
package (dlimgedit_tpu, whose __init__ imports jax)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dlimgedit_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_official_sd.py",
    ROOT / "tests" / "_torch_bridge_worker.py",
    ROOT / "tests" / "_torch_native_lib_worker.py"]
FORBIDDEN = ("jax", "jaxlib", "dlimgedit_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package_and_catches_a_jax_import(tmp_path):
    assert len(PORT_FILES) > 20
    assert (ROOT / "dlimgedit_tpu_torch" / "__init__.py") in PORT_FILES
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom dlimgedit_tpu.ops import quant\n"
                     "import jax.numpy as jnp\nimport dlimgedit_tpu_torch\n")
    assert [m for m in _imported_modules(probe) if _forbidden(m)] == [
        "dlimgedit_tpu.ops", "jax.numpy"]


@pytest.mark.parametrize("module", [
    "native_bridge.py", "convert/mobile_sam.py", "convert/hf_sam.py",
    "convert/birefnet.py", "native_build.py"])
def test_the_bridge_and_the_converters_are_scanned(module):
    """The C ABI's bridge, its build and the checkpoint converters are the
    port's own (the JAX package has modules of the same names, or a CMake
    build)."""
    assert ROOT / "dlimgedit_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "examples/__init__.py", "examples/interactive_segmentation.py",
    "examples/generate_masks.py", "examples/foreground_extraction.py",
    "examples/streaming_frames.py", "examples/latency_scaleout.py",
    "examples/distill_encoder.py", "examples/finetune_decoder.py",
    "examples/multihost_train.py", "tools/memory_footprint.py"])
def test_the_examples_and_the_memory_tool_are_scanned(module):
    """The examples and the device-memory tool are the port's own (the
    repo's examples/ and tools/ have JAX scripts of the same names)."""
    assert ROOT / "dlimgedit_tpu_torch" / module in PORT_FILES
