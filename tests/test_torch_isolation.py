"""The port stands alone: no module of synergize_motion_appearance_tpu_torch,
and not chip_smoke.py, imports JAX, flax, the JAX package or tools/.
Checked on the source with ``ast``, without importing anything."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "synergize_motion_appearance_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
                     "models/extended_blocks.py"):
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
