"""``gpubench/roofline.py`` against the bound column of PERF.md's kernel
table and the launch counts ``chip_smoke.py`` checks on the H100."""

import pytest

from gpubench import roofline


def printed(ms: str):
    """PERF.md's printed value, to half its last digit."""
    return pytest.approx(float(ms), abs=0.5 * 10.0 ** -len(ms.split(".")[1]))


@pytest.mark.parametrize("kernel,shape,ms", [
    ("time_fwd", (16, 16, 196, 768), "0.0920"),
    ("space_fwd", (16, 4, 196, 768), "0.0230"),
    ("space_fwd", (32, 4, 196, 1024), "0.0614"),
    ("space_bwd", (16, 16, 196, 768), "0.1611"),
    ("time_bwd", (16, 4, 196, 768), "0.0403"),
    ("time_bwd", (32, 4, 196, 1024), "0.1074"),
])
def test_attention_bounds(kernel, shape, ms):
    assert roofline.attention_bound_ms(kernel, *shape) == printed(ms)


@pytest.mark.parametrize("direction,rows,D,ms", [
    ("fwd", 25088 + 32, 1024, "0.0307"),
    ("bwd", 25088 + 32, 1024, "0.0461"),
    ("fwd", 50176 + 16, 768, "0.0460"),
    ("bwd", 50176 + 16, 768, "0.0690"),
    ("fwd", 960, 768, "0.00088"),
    ("bwd", 960, 768, "0.00132"),
    ("fwd", 32, 1024, "0.00004"),
    ("bwd", 32, 1024, "0.00006"),
])
def test_layer_norm_bounds(direction, rows, D, ms):
    assert roofline.ln_bound_ms(direction, rows, D) == printed(ms)


def shape(depth=12, dim=768, frames=4, clips=32, remat="none"):
    return {"clips": clips, "frames": frames, "patches": 196,
            "depth": depth, "dim": dim, "remat": remat, "patch_size": 16,
            "proj_dim": 256, "texts": clips, "tokens": 30,
            "text_layers": 6, "text_dim": 768, "text_hidden": 3072}


@pytest.mark.parametrize("kw,fwd,bwd", [
    ({}, 50, 50),                                       # ViT-B step
    ({"depth": 24, "dim": 1024, "remat": "block"}, 158, 86),  # ViT-L 'block'
])
def test_layer_norm_launches_a_step(kw, fwd, bwd):
    launches = roofline.ln_launches(shape(**kw))
    assert sum(d == "fwd" for d, _, _ in launches) == fwd
    assert sum(d == "bwd" for d, _, _ in launches) == bwd


def test_step_flops_of_the_fine_tune():
    # 2 x 86M video parameters x 3,137 tokens x 16 clips x 3, plus the
    # attention and the text tower: about 35 TFLOP
    flops = roofline.step_flops(shape(frames=16, clips=16))
    assert 34e12 < flops < 37e12
    # the 4-frame step has half the clips' tokens per clip a quarter
    assert roofline.step_flops(shape()) < flops / 1.9
