"""The port stands alone: a static scan of its imports, and its kernel sources.

The scan is over the source (AST), not `sys.modules`, because the test
process may have JAX preloaded. Names are matched exactly: `openstereo_tpu`
and `openstereo_tpu.*` are the JAX package, `openstereo_tpu_torch` is not.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "openstereo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "openstereo_tpu")


def forbidden_imports(source: str):
    """Absolute module names imported by `source` that are JAX or the JAX package."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [pytest.param(f, id=str(f.relative_to(ROOT))) for f in files]


@pytest.mark.parametrize("path", _sources())
def test_port_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("source,expected", [
    ("import openstereo_tpu_torch.ops", []),
    ("from openstereo_tpu_torch.models import build_model", []),
    ("import openstereo_tpu", ["openstereo_tpu"]),
    ("from openstereo_tpu.ops import correlation_volume", ["openstereo_tpu.ops"]),
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("def f():\n    from flax import linen", ["flax"]),
])
def test_scan_matches_exact_module_names(source, expected):
    assert forbidden_imports(source) == expected


def test_every_kernel_source_is_built_and_annotated():
    from openstereo_tpu_torch.ops.kernels import build, launch_counts

    assert set(build.SOURCES) == {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert sorted(e for es in build.ENTRIES.values() for e in es) == sorted(launch_counts)
    for name, entries in build.ENTRIES.items():
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        head = src.split("#include")[0]
        assert "openstereo_tpu/ops/pallas/" in head and "bounds it" in head, name
        for entry in entries:
            assert f'extern "C" cudaError_t {entry}_launch(' in src
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")


def test_scan_covers_the_training_modules():
    scanned = {str(p.values[0].relative_to(ROOT)) for p in _sources()}
    for rel in ("runtime/trainer.py", "runtime/optim.py", "runtime/train_state.py",
                "runtime/pretrained.py", "data/loader.py", "data/datasets.py",
                "data/transforms.py", "data/readers.py", "evaluation/metrics.py",
                "models/losses.py", "utils/seeds.py", "utils/logging.py", "registry.py",
                "tools/train.py", "tools/overfit_check.py"):
        assert f"openstereo_tpu_torch/{rel}" in scanned, rel


def test_scan_covers_the_coex_and_msnet_modules():
    scanned = {str(p.values[0].relative_to(ROOT)) for p in _sources()}
    for rel in ("models/coex/coex.py", "models/coex/__init__.py", "models/msnet/msnet.py",
                "models/msnet/__init__.py", "models/igev/blocks.py", "models/igev/__init__.py",
                "models/layers.py", "models/backbones/mobilenetv2.py", "ops/upsample.py",
                "ops/disp_regression.py", "utils/jax_weights.py", "tools/bench.py"):
        assert f"openstereo_tpu_torch/{rel}" in scanned, rel
