"""The port stands alone: no module of synergize_motion_appearance_tpu_torch,
and none of the card scripts (chip_smoke.py, chip_dp_spread.py,
chip_attention_choice.py, chip_attention_cols.py), imports JAX, flax, the JAX package or tools/.
Checked on the source with ``ast``, without importing anything. And the
port imports as on the card's machine, which has none of JAX, OpenCV, PIL,
imageio, PyYAML and lmdb: checked in a Python that hides them."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "synergize_motion_appearance_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "chip_dp_spread.py",
                             "chip_attention_choice.py",
                             "chip_attention_cols.py")]
FORBIDDEN = {"jax", "jaxlib", "flax", "synergize_motion_appearance_tpu",
             "tools"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_port_has_sources():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    for expected in ("inference.py", "weights.py", "configs.py",
                     "losses.py", "training/trainer.py",
                     "ops/fused_attention.py", "ops/conv3x3.py",
                     "ops/vq.py", "ops/tps.py", "models/vgg.py",
                     "models/appmotion_former.py", "train.py",
                     "model_api.py", "training/checkpoint.py",
                     "data/frames_dataset.py", "data/loader.py",
                     "data/native_loader.py", "data/sampler.py",
                     "data/transforms.py", "metrics/psnr_ssim.py",
                     "metrics/__init__.py", "utils/options.py",
                     "utils/misc.py", "utils/logger.py",
                     "utils/img_util.py", "utils/registry.py",
                     "demo.py", "test.py", "animate.py", "ops/color.py",
                     "metrics/inception.py", "metrics/lpips.py",
                     "metrics/openface.py", "metrics/external.py",
                     "metrics/pose_util.py", "serving.py",
                     "export_serving.py", "ops/dcn.py",
                     "ops/stylegan_ops.py", "models/arch_util.py",
                     "models/extended_blocks.py", "utils/env.py",
                     "utils/file_client.py", "utils/matlab_functions.py",
                     "data/data_util.py", "data/augmentation.py",
                     "utils/tiled_inference.py", "utils/video_util.py",
                     "utils/profiler.py", "utils/lmdb_util.py"):
        assert expected in names
    for source in ("fused_attention_packed.cu", "conv3x3.cu"):
        assert (PORT / "csrc" / source).exists()
    # the native frame cache's own copy of its C++ source
    assert (PORT / "native" / "framecache.cpp").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# absent on the card's machine; importing one there raises ImportError
CARD_ABSENT = ("cv2", "PIL", "imageio", "yaml", "lmdb", "jax", "jaxlib",
               "flax")


def _chip_smoke_imports():
    """Every module chip_smoke.py imports, at any depth of the script."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return sorted(names)


def test_port_imports_without_optional_packages():
    """In a fresh Python where the card machine's absent packages raise
    ImportError, every module of the port, chip_smoke.py and every module
    chip_smoke.py imports import; random_ff_mask raises a RuntimeError
    that names cv2."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts[:-1]
                 if p.name == "__init__.py"
                 else p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    script = f"""
import importlib, sys
for name in {CARD_ABSENT!r}:
    sys.modules[name] = None
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "tools")!r}]
for name in {modules!r} + ["chip_smoke"] + {_chip_smoke_imports()!r}:
    importlib.import_module(name)
from synergize_motion_appearance_tpu_torch.data.data_util import (
    random_ff_mask)
try:
    random_ff_mask((8, 8))
except RuntimeError as e:
    assert "cv2" in str(e), e
    print("IMPORTED", len(sys.modules))
"""
    run = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "IMPORTED" in run.stdout, (run.stdout, run.stderr[-3000:])
