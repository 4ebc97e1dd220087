"""The plain reference (``gpubench/reference``) against the port's plain
path at tiny widths on the CPU, float32: the towers and their gradients,
the train transform, the losses and AdamW."""

import sys

import numpy as np
import pytest
import torch

from gpubench.reference import model as ref_model
from gpubench.reference import train as ref_train
from gpubench.tests import tiny

FRAMES = 2


def port_model(weights, precision="fp32"):
    from egovlp_tpu_torch import build

    arch = tiny.tiny_arch(precision)
    arch["args"]["video_params"]["num_frames"] = FRAMES
    model, _ = build.build_model(arch, "cpu")
    model.load_state_dict(weights, strict=True)
    return model


def drawn(seed=3):
    arch = tiny.tiny_arch()
    d = ref_model.dims(arch, FRAMES)
    g = torch.Generator().manual_seed(seed)
    return d, ref_model.draw_weights(ref_model.param_spec(d), g)


def inputs(seed=4, B=3):
    g = torch.Generator().manual_seed(seed)
    video = torch.randn(B, FRAMES, 32, 32, 3, generator=g)
    ids = torch.randint(1000, 1100, (B, 8), generator=g)
    ids[:, 0] = 101
    mask = torch.ones(B, 8, dtype=torch.int32)
    mask[0, 5:] = 0
    mask[1, 3:] = 0
    return video, ids, mask


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_towers_and_gradients_match_the_port(impl):
    d, weights = drawn()
    model = port_model({k: v.clone() for k, v in weights.items()})
    for blk in model.video_model.blocks:
        for attn in (blk.attn, blk.timeattn):
            attn.impl = {"auto": "pallas", "xla": "xla"}[impl]
    model.train()
    video, ids, mask = inputs()
    t, v = model(video, ids, mask)
    (t.square().sum() + v.sin().sum()).backward()
    P = {k: w.clone().requires_grad_(True) for k, w in weights.items()}
    ref = ref_model.Reference(d, P)
    rt, rv = ref.encode_text(ids, mask), ref.encode_video(video)
    (rt.square().sum() + rv.sin().sum()).backward()
    torch.testing.assert_close(t, rt, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)
    # float32 summation order: leaf by leaf, the gap's norm against the
    # leaf's, or a thousandth of the median leaf's (a key bias's gradient
    # is nought to rounding)
    norms = {k: float(p.grad.norm()) for k, p in P.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    for name, p in model.named_parameters():
        gap = float((p.grad - P[name].grad).norm())
        assert gap <= 1e-4 * max(norms[name], floor), (name, gap, norms[name])


def test_parameter_names_and_shapes_are_the_port_state_dict():
    d, weights = drawn()
    from egovlp_tpu_torch import build

    arch = tiny.tiny_arch()
    arch["args"]["video_params"]["num_frames"] = FRAMES
    model, _ = build.build_model(arch, "meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in weights.items()} == want


def test_crop_boxes_and_transform_match_the_port():
    from egovlp_tpu_torch.data.transforms import (
        resized_crop_flip,
        sample_crop_boxes,
    )

    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (6, 2, 40, 40, 3), dtype=np.uint8))
    seed = ref_train.step_seed(123, 2, 0)
    boxes, flips = ref_train.crop_boxes(
        torch.Generator().manual_seed(seed), 6, 40)
    pb, pf = sample_crop_boxes(torch.Generator().manual_seed(seed), 6, 40)
    torch.testing.assert_close(boxes, pb, rtol=0, atol=0)
    assert torch.equal(flips, pf) and flips.any() and not flips.all()
    got = ref_train.train_transform(frames, boxes, flips, 32)
    want = resized_crop_flip(frames, pb, pf, out_size=32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_step_seed_is_the_loop_generator_seed():
    from egovlp_tpu_torch.train.recipes import step_generator

    for seed in (0, 7, 2 ** 31 + 5, 1234567890123):
        g = step_generator("cpu", seed, 3, 0)
        assert g.initial_seed() == ref_train.step_seed(seed, 3, 0)


def test_losses_match_the_port():
    from egovlp_tpu_torch.models.dual_encoder import sim_matrix
    from egovlp_tpu_torch.objectives.contrastive import egonce
    from egovlp_tpu_torch.objectives.ranking import max_margin

    g = torch.Generator().manual_seed(1)
    t, v = torch.randn(8, 16, generator=g), torch.randn(8, 16, generator=g)
    verb = (torch.rand(8, 5, generator=g) > 0.6).float()
    noun = (torch.rand(8, 7, generator=g) > 0.6).float()
    sim = ref_train.cosine(t, v)
    torch.testing.assert_close(sim, sim_matrix(t, v))
    torch.testing.assert_close(
        ref_train.egonce(sim, verb, noun),
        egonce(sim_matrix(t, v), sim_matrix(verb, verb),
               sim_matrix(noun, noun), 0.05))
    torch.testing.assert_close(ref_train.max_margin(sim, 0.2),
                               max_margin(sim_matrix(t, v), margin=0.2))


def test_adamw_matches_the_port():
    from egovlp_tpu_torch.train.state import make_optimizer

    g = torch.Generator().manual_seed(2)
    w = torch.nn.Parameter(torch.randn(5, 4, generator=g))
    opt, _ = make_optimizer(torch.nn.Linear(1, 1), base_lr=1e-2,
                            milestones=())
    opt.param_groups[0]["params"] = [w]
    P = {"w": w.detach().clone()}
    ref = ref_train.AdamW(P, 1e-2)
    for _ in range(3):
        grad = torch.randn(5, 4, generator=g)
        w.grad = grad.clone()
        opt.step()
        ref.step({"w": grad})
    # float32 order of the bias corrections: within a thousandth of a step
    torch.testing.assert_close(w.detach(), P["w"], rtol=1e-6, atol=1e-5)


def test_reference_imports_nothing_of_the_port_or_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, '.');"
            "import gpubench.reference.model, gpubench.reference.train;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('egovlp_tpu_torch', 'egovlp_tpu', 'jax', 'jaxlib', 'flax', "
            "'optax', 'orbax')); print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
