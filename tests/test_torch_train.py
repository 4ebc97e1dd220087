"""The port's EgoClip training slice vs the JAX package (CPU, float32).

Objectives, the train transform, AdamW, the step-LR schedule, a 3-step
EgoClip trajectory of the port's step against ``make_egoclip_train_step``
(plain attention on the JAX side; the port's Functions on CPU tensors run
the plain twins of the kernels), and the Trainer's monitor, early stop,
save cadence and bit-exact resume.  Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egovlp_tpu.data.transforms import _sample_crop_box
from egovlp_tpu.data.transforms import (
    random_resized_crop_flip as jax_random_resized_crop_flip,
)
from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.objectives import egonce as jax_egonce
from egovlp_tpu.objectives import info_nce as jax_info_nce
from egovlp_tpu.train.state import adamw_reference, create_train_state
from egovlp_tpu.train.state import make_optimizer as jax_make_optimizer
from egovlp_tpu.train.state import make_step_lr as jax_make_step_lr
from egovlp_tpu.train.steps import (
    make_egoclip_train_step as jax_make_egoclip_train_step,
)
from egovlp_tpu_torch.data.transforms import resized_crop_flip, sample_crop_boxes
from egovlp_tpu_torch.io.checkpoints import CheckpointManager
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.objectives.contrastive import egonce, info_nce
from egovlp_tpu_torch.train import steps as port_steps
from egovlp_tpu_torch.train.recipes import make_train_epoch_fn
from egovlp_tpu_torch.train.state import AdamW, make_optimizer, make_step_lr
from egovlp_tpu_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_models import (  # noqa: F401
    RES,
    TEXT,
    jax_config,
    jax_params,
    port_model,
)

SCALE, RATIO = (0.5, 1.0), (3 / 4, 4 / 3)


# --------------------------------------------------------------------------
# objectives
# --------------------------------------------------------------------------

def _sim_and_masks(seed, n=6):
    rng = np.random.default_rng(seed)
    sim = np.tanh(rng.normal(size=(n, n))).astype(np.float32)
    verbs = rng.integers(0, 2, (n, 5)).astype(np.float32)
    nouns = rng.integers(0, 2, (n, 7)).astype(np.float32)
    nouns[2] = 0.0  # a row with no noun: no off-diagonal positive
    verbs[4] = 0.0
    return sim, verbs @ verbs.T, nouns @ nouns.T


@pytest.mark.parametrize("noun,verb", [(True, True), (True, False),
                                       (False, True)])
def test_egonce_value_and_grad_match_jax(noun, verb):
    sim, mv, mn = _sim_and_masks(0)
    assert ((mv * mn + np.eye(6)) > 0).sum(1).min() == 1  # diagonal-only rows
    want, want_g = jax.jit(jax.value_and_grad(
        lambda s: jax_egonce(s, mv, mn, 0.05, noun=noun, verb=verb)))(sim)
    s = torch.from_numpy(sim).requires_grad_()
    got = egonce(s, torch.from_numpy(mv), torch.from_numpy(mn), 0.05,
                 noun=noun, verb=verb)
    got.backward()
    # float32 log-sum-exps of ~20-sized logits, summed in another order;
    # the gradients are up to ~7 in size (1 / temperature / n scale)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)


def test_info_nce_value_and_grad_match_jax():
    sim = _sim_and_masks(1)[0]
    want, want_g = jax.jit(jax.value_and_grad(
        lambda s: jax_info_nce(s, 0.05)))(sim)
    s = torch.from_numpy(sim).requires_grad_()
    got = info_nce(s, 0.05)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# train transform
# --------------------------------------------------------------------------

def jax_boxes(key, B, src):
    """The boxes and flips ``random_resized_crop_flip`` draws from ``key``
    (its own key split, transforms.py:145-150)."""
    keys = jax.random.split(key, B + 1)
    flips = np.asarray(jax.random.bernoulli(keys[0], 0.5, (B,)))
    boxes = np.stack([np.asarray(jnp.stack(_sample_crop_box(k, src, SCALE,
                                                            RATIO)))
                      for k in keys[1:]])
    return torch.from_numpy(boxes.astype(np.float32)), torch.from_numpy(
        flips.copy())


@pytest.mark.parametrize("seed", [0, 1])
def test_resized_crop_flip_matches_jax_on_jax_boxes(seed):
    B, T, pre, out = 4, 2, 40, 24
    frames = np.random.default_rng(seed).integers(
        0, 256, (B, T, pre, pre, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_random_resized_crop_flip(key, frames, out_size=out))
    boxes, flips = jax_boxes(key, B, pre)
    got = resized_crop_flip(torch.from_numpy(frames), boxes, flips, out)
    assert got.shape == (B, T, out, out, 3) and got.dtype == torch.float32
    # the same interpolation matrices in float32, contracted by another
    # matmul (the JAX side's channel-folded kron matrix); normalized values
    # reach ~2.6, largest gap seen 1.9e-5
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape),
                               rtol=1e-5, atol=5e-5)


def test_sample_crop_boxes_bounds_and_determinism():
    src = 256
    boxes, flips = sample_crop_boxes(torch.Generator().manual_seed(3), 512,
                                     src)
    again = sample_crop_boxes(torch.Generator().manual_seed(3), 512, src)
    assert torch.equal(boxes, again[0]) and torch.equal(flips, again[1])
    top, left, h, w = boxes.unbind(1)
    assert bool(((h >= 8) & (h <= src) & (w >= 8) & (w <= src)).all())
    assert bool(((top >= 0) & (top + h <= src + 1e-3)).all())
    assert bool(((left >= 0) & (left + w <= src + 1e-3)).all())
    area = (h * w / src ** 2)
    assert 0.45 < area.min() and area.max() <= 1.0 + 1e-6
    assert 0.3 < flips.float().mean() < 0.7


# --------------------------------------------------------------------------
# optimizer and schedule
# --------------------------------------------------------------------------

def test_step_lr_matches_jax_at_epoch_boundaries():
    want = jax_make_step_lr(1e-3, (2, 4), steps_per_epoch=3)
    got = make_step_lr(1e-3, (2, 4), steps_per_epoch=3)
    for count in range(16):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)
    # epoch e (1-based) trains at base * 0.1^{#milestones <= e - 1}
    assert [got(c) for c in (5, 6, 11, 12)] == pytest.approx(
        [1e-3, 1e-4, 1e-4, 1e-5])


@pytest.mark.parametrize("variant,mu_dtype,wd", [
    ("optax", None, 0.0), ("optax", None, 0.05), ("fused", None, 0.05),
    ("reference", None, 0.05), ("optax", "bfloat16", 0.0),
    ("reference", "bfloat16", 0.05)])
def test_adamw_matches_jax_leafwise_over_5_steps(variant, mu_dtype, wd):
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-7, 1)
                  ).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    sched = dict(base_lr=1e-2, milestones=(1, 2), steps_per_epoch=2)
    if variant == "optax":  # optax.adamw itself, not the package's wrapper
        tx = optax.adamw(jax_make_step_lr(**sched), eps=1e-6,
                         weight_decay=wd,
                         mu_dtype=jnp.dtype(mu_dtype) if mu_dtype else None)
    elif variant == "reference":
        tx = adamw_reference(jax_make_step_lr(**sched), eps=1e-6,
                             weight_decay=wd, mu_dtype=mu_dtype)
    else:
        tx = jax_make_optimizer(**sched, weight_decay=wd, mu_dtype=mu_dtype,
                                variant=variant)
    jp, st = dict(params), tx.init(params)

    model = torch.nn.Module()
    for k, v in params.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
    opt, _ = make_optimizer(model, **sched, weight_decay=wd,
                            mu_dtype=mu_dtype, variant=variant)
    assert isinstance(opt, AdamW)
    assert opt.param_groups[0]["rule"] == ("reference" if variant == "reference"
                                           else "optax")
    for g in grads:
        upd, st = jax.jit(tx.update)(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in model.named_parameters():
            # float32, the same formula; scalars rounded the same way
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            mu = opt.state[p]["mu"]
            assert mu.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
    assert opt.param_groups[0]["count"] == 5


# --------------------------------------------------------------------------
# the EgoClip step: a 3-step trajectory against the JAX step
# --------------------------------------------------------------------------

B, PRE, S = 3, 40, 8
SCHED = dict(base_lr=1e-3, milestones=(1,), steps_per_epoch=2)


def egoclip_batch(seed, b=B):
    """Seeded numpy batch shaped as the EgoClip collation, with scene
    negatives; several rows share a verb and a noun."""
    rng = np.random.default_rng(seed)
    batch = {}
    for suffix in ("", "_neg"):
        batch["frames" + suffix] = rng.integers(
            0, 256, (b, 4, PRE, PRE, 3)).astype(np.uint8)
        ids = rng.integers(4, TEXT["vocab_size"], (b, S)).astype(np.int32)
        mask = np.ones((b, S), np.int32)
        mask[0, 5:] = 0
        ids[mask == 0] = 0
        name = "text_neg" if suffix else "text"
        batch[f"{name}_ids"], batch[f"{name}_mask"] = ids, mask
        for key, dim in (("noun_vec", 12), ("verb_vec", 6)):
            vec = np.zeros((b, dim), np.float32)
            vec[np.arange(b), rng.integers(0, 2, b)] = 1.0
            batch[key + suffix] = vec
    batch["text"] = ["unused caption"] * b  # host metadata, dropped
    return batch


def test_egoclip_step_trajectory_matches_jax(jax_params, monkeypatch):  # noqa: F811
    jax_step = jax_make_egoclip_train_step(input_res=RES)
    state = create_train_state(
        JaxDualEncoder(jax_config("xla")), jax_params,
        jax_make_optimizer(**SCHED, variant="reference"))
    model = port_model(jax_params)
    opt, _ = make_optimizer(model, **SCHED, variant="reference")
    port_step = port_steps.make_egoclip_train_step(input_res=RES)
    keys = {}
    monkeypatch.setattr(port_steps, "sample_crop_boxes",
                        lambda gen, b, src: jax_boxes(keys["t"], b, src))

    for i in range(3):
        batch = egoclip_batch(100 + i)
        rng = jax.random.PRNGKey(i)
        keys["t"] = jax.random.split(rng)[0]  # the JAX step's transform key
        state, want = jax_step(state, batch, rng)
        got = port_step(model, opt, {k: torch.from_numpy(v) for k, v in
                                     port_steps.numeric_batch(batch).items()},
                        torch.Generator())
        # float32 through both towers, EgoNCE at temperature 0.05
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"loss, step {i}")
    want_sd = params_from_jax(jax.tree.map(np.asarray, state.params))
    got_sd = model.state_dict()
    assert set(want_sd) == set(got_sd)
    for k, w in want_sd.items():
        # AdamW normalises each step to ~lr (1e-3, then 1e-4): float32
        # gradient noise moves a parameter by at most a small part of it
        np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    assert opt.param_groups[0]["count"] == 3


def test_step_rejects_unported_options():
    # ring and GradCache each build; together they raise, as in JAX
    port_steps.make_egoclip_train_step(global_sim="ring")
    port_steps.make_egoclip_train_step(n_micro=2)
    with pytest.raises(ValueError, match="ring"):
        port_steps.make_egoclip_train_step(global_sim="ring", n_micro=2)
    with pytest.raises(ValueError, match="global_sim"):
        port_steps.make_egoclip_train_step(global_sim="chunked")


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------

def _scripted_epochs(values, key="loss_0"):
    def train_epoch(model, optimizer, epoch, logger):
        for p in model.parameters():
            p.grad = torch.full_like(p, 0.1 * epoch)
        optimizer.step()
        return {key: values[epoch - 1]}
    return train_epoch


def _linear():
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    return model, make_optimizer(model, base_lr=1e-2)[0]


def test_trainer_monitor_early_stop_and_save_cadence(tmp_path):
    model, opt = _linear()
    cfg = TrainerConfig(epochs=10, save_period=3, monitor="min loss_0",
                        early_stop=2, save_dir=str(tmp_path))
    trainer = Trainer(cfg, _scripted_epochs([5.0, 4.0, 4.5, 4.2, 4.1, 3.0,
                                             1.0, 1.0, 1.0, 1.0]))
    trainer.train(model, opt)
    # best at epochs 1 and 2; epochs 3, 4, 5 do not improve and the third
    # (> early_stop = 2) stops the run before epoch 5 is saved
    assert trainer.mnt_best == 4.0
    assert opt.param_groups[0]["count"] == 5
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["checkpoint-epoch1.pth", "checkpoint-epoch2.pth",
                     "checkpoint-epoch3.pth", "model_best.pth"]
    best = torch.load(tmp_path / "model_best.pth", weights_only=True)
    assert best["epoch"] == 2 and best["monitor_best"] == 4.0
    assert best["arch"] == "FrozenInTime" and best["step"] == 2
    assert set(best) == {"state_dict", "epoch", "monitor_best", "arch",
                         "optimizer", "step"}


def test_trainer_monitor_off_and_missing_metric(tmp_path):
    model, opt = _linear()
    cfg = TrainerConfig(epochs=3, save_period=2, monitor="max acc",
                        save_dir=str(tmp_path))
    trainer = Trainer(cfg, _scripted_epochs([1.0, 2.0, 3.0]))
    trainer.train(model, opt)  # 'acc' never logged: the monitor turns off
    assert trainer.mnt_mode == "off"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint-epoch2.pth"]


def test_trainer_resume_is_bit_exact(tmp_path, jax_params):  # noqa: F811
    """2 epochs of 2 real EgoClip steps on the tiny dual encoder, saved and
    resumed into a fresh model and optimizer: the state is bit-equal, and a
    third epoch from the resumed state equals a third epoch run straight
    through."""
    batches = [egoclip_batch(200 + i) for i in range(2)]
    step = port_steps.make_egoclip_train_step(input_res=RES)

    def run(epochs, save_dir, resume=False):
        model = port_model(jax_params)
        opt, _ = make_optimizer(model, **SCHED)
        trainer = Trainer(
            TrainerConfig(epochs=epochs, monitor="min loss_0",
                          save_dir=str(save_dir)),
            make_train_epoch_fn([batches], step, "cpu", seed=7))
        if resume:
            payload = trainer.resume(model, opt)
            assert payload["epoch"] == 2 and trainer.cfg.start_epoch == 3
        trainer.train(model, opt)
        return model, opt

    m2, o2 = run(2, tmp_path / "a")
    fresh = port_model(jax_params)
    fresh_opt, _ = make_optimizer(fresh, **SCHED)
    CheckpointManager(str(tmp_path / "a")).restore(fresh, fresh_opt)
    for k, v in m2.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert fresh_opt.param_groups[0]["count"] == o2.param_groups[0]["count"]
    for p, q in zip(m2.parameters(), fresh.parameters()):
        for name in ("mu", "nu"):
            assert torch.equal(o2.state[p][name], fresh_opt.state[q][name])

    m3, _ = run(3, tmp_path / "b")
    r3, r3_opt = run(3, tmp_path / "a", resume=True)
    assert r3_opt.param_groups[0]["count"] == 6
    for k, v in m3.state_dict().items():
        assert torch.equal(r3.state_dict()[k], v), k


def test_epoch_fn_keeps_per_loader_means_and_max_samples(jax_params):  # noqa: F811
    model = port_model(jax_params)
    opt, _ = make_optimizer(model, **SCHED)
    calls = []

    def step(model, optimizer, batch, gen):
        calls.append(batch["frames"].shape[0])
        assert batch["text_ids"].dtype == torch.int32
        return torch.tensor(float(len(calls)))

    loaders = [[egoclip_batch(i) for i in range(3)],
               [egoclip_batch(10 + i) for i in range(3)]]
    log = make_train_epoch_fn(loaders, step, "cpu", max_samples=2 * B)(
        model, opt, 1, __import__("logging").getLogger("test"))
    # two batch indices (max_samples), one step per loader each
    assert calls == [B] * 4
    assert log == {"loss_0": pytest.approx(2.0), "loss_1": pytest.approx(3.0)}


# --------------------------------------------------------------------------
# model gradients and training-mode options
# --------------------------------------------------------------------------

def test_dual_encoder_grads_match_jax(jax_params):  # noqa: F811
    """EgoNCE gradients of every parameter, one batch, no transform."""
    rng = np.random.default_rng(5)
    video = rng.normal(size=(4, 4, RES, RES, 3)).astype(np.float32)
    batch = egoclip_batch(300, b=4)
    ids, mask = batch["text_ids"], batch["text_mask"]
    mv = batch["verb_vec"] @ batch["verb_vec"].T
    mn = batch["noun_vec"] @ batch["noun_vec"].T
    from egovlp_tpu.models import sim_matrix as jax_sim_matrix

    jmodel = JaxDualEncoder(jax_config("xla"))

    def loss_fn(params):
        t, v = jmodel.apply({"params": params}, video, ids, mask,
                            deterministic=False)
        return jax_egonce(jax_sim_matrix(t, v), mv, mn, 0.05)

    want = params_from_jax(jax.tree.map(
        np.array, jax.jit(jax.grad(loss_fn))(jax_params)))
    for impl in ("auto", "xla"):
        model = port_model(jax_params, impl).train()
        t, v = model(torch.from_numpy(video), torch.from_numpy(ids),
                     torch.from_numpy(mask))
        from egovlp_tpu_torch.models.dual_encoder import sim_matrix

        egonce(sim_matrix(t, v), torch.from_numpy(mv),
               torch.from_numpy(mn), 0.05).backward()
        for k, p in model.named_parameters():
            # float32 through both towers; gradients up to ~1 in size
            np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                       rtol=1e-3, atol=2e-5,
                                       err_msg=f"{k}, impl={impl}")


def test_video_tower_drop_path_and_remat_options():
    from egovlp_tpu_torch.models.video_tower import (
        SpaceTimeTransformer,
        VideoTowerConfig,
    )

    with pytest.raises(ValueError, match="remat"):
        VideoTowerConfig(remat="blocks")
    assert VideoTowerConfig(remat="block").remat_mode == "block"
    assert VideoTowerConfig(remat="none").remat == "none"
    kw = dict(img_size=RES, patch_size=16, embed_dim=24, depth=3, num_heads=2,
              time_init="random")
    torch.manual_seed(0)
    plain = SpaceTimeTransformer(VideoTowerConfig(**kw))
    dropped = SpaceTimeTransformer(VideoTowerConfig(**kw, drop_path_rate=0.5))
    dropped.load_state_dict(plain.state_dict())
    assert [b.drop_path for b in dropped.blocks] == [0.0, 0.25, 0.5]
    video = torch.randn(8, 4, RES, RES, 3)
    with torch.no_grad():
        ref = plain.eval()(video)
        torch.testing.assert_close(dropped.eval()(video), ref)  # eval: identity
        dropped.train()
        with pytest.raises(ValueError, match="Generator"):
            dropped(video)
        a = dropped(video, torch.Generator().manual_seed(1))
        b = dropped(video, torch.Generator().manual_seed(1))
        c = dropped(video, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, ref)
