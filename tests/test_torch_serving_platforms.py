"""Two-device serving artifacts on the CPU (options/tiny.yml, float32):
the layout ``serving.export_pipeline(..., platforms=("cpu", "cuda"))``
writes, the loader's choice of device and its errors, and the export's
refusal without a card.

This machine has no card, so the two-device artifact of this file is made
with ``torch.cuda.is_available`` patched to true and the card's copy of
the pipeline patched to the CPU pipeline itself: its ``cuda/`` programs
are CPU programs standing in for the card's (they keep the ``samt`` op,
as the card's do), its ``cpu/`` programs are the real thing (the plain
attention, no ``samt`` op). The card's programs are exported and run on
the card by chip_smoke.py's serving phase. Bound: the served CPU frames
equal the live pipeline's within 1e-5 (tests/test_torch_serving.py's).
"""
import json
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synergize_motion_appearance_tpu_torch import (  # noqa: E402
    demo, export_serving, serving,
)
from synergize_motion_appearance_tpu_torch.ops import (  # noqa: E402
    fused_attention,
)

from test_torch_serving import _inputs, _live  # noqa: E402
from test_torch_serving_cli import FLAGS, TINY_YML  # noqa: E402
from test_torch_vqgan_extras import two_torch_threads  # noqa: E402,F401

SAMT = "samt.fused_attention_packed.default"


def _samt_ops(path):
    ep = torch.export.load(path)
    return sum(str(n.target) == SAMT for n in ep.graph.nodes
               if n.op == "call_function")


@pytest.fixture(scope="module")
def two_device(tmp_path_factory):
    live = _live(compute_dtype=torch.float32)
    art = str(tmp_path_factory.mktemp("platforms") / "art")
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(serving, "_pipeline_on",
                              side_effect=lambda p, dev: p):
        serving.export_pipeline(live, art, platforms=("cpu", "cuda"))
    return live, art


def test_two_device_layout(two_device):
    """One manifest listing both devices, one params.pt, the four
    programs once per device; the CPU's hold no samt op, the card's do."""
    _, art = two_device
    assert sorted(os.listdir(art)) == ["cpu", "cuda", "manifest.json",
                                       "params.pt"]
    with open(os.path.join(art, "manifest.json")) as f:
        assert json.load(f)["platforms"] == ["cpu", "cuda"]
    for dev in ("cpu", "cuda"):
        assert sorted(os.listdir(os.path.join(art, dev))) == sorted(
            f"{s}.pt2" for s in serving._STAGES)
    assert _samt_ops(os.path.join(art, "cpu", "gen.pt2")) == 0
    assert _samt_ops(os.path.join(art, "cuda", "gen.pt2")) > 0


def test_cpu_programs_match_live(two_device):
    live, art = two_device
    served = serving.load_serving_pipeline(art, "cpu")
    assert served.device == torch.device("cpu")
    assert all(v.device.type == "cpu" for v in served.g_weights.values())
    _, _, src, drv = _inputs()
    fused_attention.reset_launches()
    np.testing.assert_allclose(served.animate(src, drv),
                               live.animate(src, drv), atol=1e-5, rtol=0)


def test_loader_defaults_to_the_card_and_refuses_without_one(two_device):
    _, art = two_device
    with pytest.raises(RuntimeError, match="loaded for cuda"):
        serving.load_serving_pipeline(art)
    with pytest.raises(RuntimeError, match="loaded for cuda"):
        serving.load_serving_pipeline(art, "cuda")


def test_loader_refuses_a_device_not_exported(two_device):
    _, art = two_device
    with pytest.raises(ValueError, match="exported for cpu, cuda, not meta"):
        serving.load_serving_pipeline(art, "meta")


@pytest.mark.parametrize("flag,device", [(["--cpu"], "cpu"), ([], "cuda")])
def test_demo_passes_its_device_on(two_device, flag, device):
    """demo --from_export asks the loader for the CPU's programs with
    --cpu, else the card's."""
    _, art = two_device
    with mock.patch.object(serving, "load_serving_pipeline",
                           side_effect=KeyboardInterrupt) as load:
        with pytest.raises(KeyboardInterrupt):
            demo.main(["--from_export", art, "--source_image", "s.png",
                       "--driving_video", "d.mp4", "--result_video",
                       "r.mp4"] + flag)
    assert load.call_args.args == (art, device)


def test_export_without_a_card_raises_and_writes_nothing(tmp_path):
    live = _live(compute_dtype=torch.float32)
    art = str(tmp_path / "art")
    with pytest.raises(RuntimeError, match="cuda programs needs a CUDA"):
        serving.export_pipeline(live, art, platforms=("cpu", "cuda"))
    assert not os.path.exists(art)
    with pytest.raises(ValueError, match="cpu and/or cuda"):
        serving.export_pipeline(live, art, platforms=("cpu", "tpu"))


def test_single_cpu_platform_keeps_the_layout(tmp_path):
    """--platforms cpu writes today's layout: the programs at the top,
    the samt op in gen, the manifest's one device."""
    art = str(tmp_path / "art")
    export_serving.main(["--config", TINY_YML, "--out", art, "--cpu",
                         "--platforms", "cpu"] + FLAGS)
    assert sorted(os.listdir(art)) == sorted(
        ["manifest.json", "params.pt"]
        + [f"{s}.pt2" for s in serving._STAGES])
    with open(os.path.join(art, "manifest.json")) as f:
        assert json.load(f)["platforms"] == ["cpu"]
    assert _samt_ops(os.path.join(art, "gen.pt2")) > 0
    assert serving.load_serving_pipeline(art).device == torch.device("cpu")


def test_plain_cpu_attention_scope():
    """Inside the scope a CPU call runs the plain version, equal to the
    op's CPU result; outside it the op runs."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 16, 8, generator=g)
    k = torch.randn(10, 8, generator=g)
    v = torch.randn(10, 8, generator=g)
    with mock.patch.object(fused_attention, "fused_attention_packed_reference",
                           wraps=fused_attention.
                           fused_attention_packed_reference) as ref:
        with fused_attention.plain_cpu_attention():
            inside = fused_attention.fused_attention_packed(q, k, v,
                                                            num_heads=2)
        assert ref.call_count == 1
        outside = fused_attention.fused_attention_packed(q, k, v,
                                                         num_heads=2)
    assert torch.equal(inside, outside)


def test_stale_roadmap_pointer_is_gone():
    src = open(export_serving.__file__).read()
    assert "item 5" not in src and "not ported yet" not in src
