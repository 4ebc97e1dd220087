"""The port's GradCache (``train/grad_cache.py``), the EgoClip step with
``n_micro > 1`` and AdamW's ``max_grad_norm``, against the JAX package
(CPU, float32).  Mirrors JAX ``tests/test_grad_cache.py:23-80``:

* GradCache equals monolithic autograd on a coupled InfoNCE-style loss,
  and JAX ``grad_cache_value_and_grad`` on the same numbers, at 1, 2 and 4
  micro-batches (rtol 1e-5: float32 sums in another order);
* a batch that does not divide raises;
* pass 2 replays pass 1's random numbers: with drop-path on, GradCache
  equals autograd of the micro-batches embedded one after another from
  one generator; without the replay (the generator not handed over) the
  gradients differ;
* the EgoClip step at ``n_micro=2`` against JAX
  ``make_egoclip_train_step(n_micro=2)`` on the same weights, batch and
  crop boxes: the loss (rtol 1e-5) and every gradient (rtol 1e-3, atol
  2e-5: float32 through both towers, gradients up to ~1), the JAX
  gradients read from an optimizer that stores them;
* ``global_sim='ring'`` with ``n_micro > 1`` raises, as in JAX;
* ``grad_accum=2`` at world 2 over gloo (``tests/torch_ddp_worker.py
  step``) equals the one-process monolithic step on the global batch;
* AdamW with ``max_grad_norm`` equals optax's ``clip_by_global_norm``
  chained before the update (the JAX ``make_optimizer``), leafwise over 5
  steps whose gradients are clipped on some steps and not on others.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.train.grad_cache import (
    grad_cache_value_and_grad as jax_grad_cache_value_and_grad,
)
from egovlp_tpu.train.state import create_train_state
from egovlp_tpu.train.state import make_optimizer as jax_make_optimizer
from egovlp_tpu.train.steps import (
    make_egoclip_train_step as jax_make_egoclip_train_step,
)
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.models.video_tower import (
    SpaceTimeTransformer,
    VideoTowerConfig,
)
from egovlp_tpu_torch.train import steps as port_steps
from egovlp_tpu_torch.train.grad_cache import grad_cache_value_and_grad
from egovlp_tpu_torch.train.state import make_optimizer
from tests.test_torch_ddp import (
    one_process_step,
    port_inputs,
    start_workers,
    wait_all,
)
from tests.test_torch_models import (
    RES,
    TEXT,
    VIDEO,
    jax_config,
    port_model,
    random_params,
)
from tests.test_torch_ring import NoUpdate
from tests.test_torch_train import SCHED, egoclip_batch, jax_boxes


def _coupled_loss(t, v):
    t = t / t.norm(dim=-1, keepdim=True)
    v = v / v.norm(dim=-1, keepdim=True)
    return -torch.log_softmax(t @ v.T / 0.05, dim=-1).diagonal().mean()


def _jax_coupled_loss(emb):
    t, v = emb
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    return -jnp.mean(jnp.diag(jax.nn.log_softmax(t @ v.T / 0.05, axis=-1)))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_grad_cache_matches_monolithic_and_jax(k):
    rng = np.random.default_rng(0)
    B, D, H = 8, 6, 5
    w = {n: rng.normal(size=(D, H)).astype(np.float32) for n in ("t", "v")}
    x = {n: rng.normal(size=(B, D)).astype(np.float32) for n in ("t", "v")}
    params = {n: torch.nn.Parameter(torch.from_numpy(a)) for n, a in w.items()}
    batch = {n: torch.from_numpy(a) for n, a in x.items()}

    def embed(mb):
        return (torch.tanh(mb["t"] @ params["t"]),
                torch.tanh(mb["v"] @ params["v"]))

    want = _coupled_loss(*embed(batch))
    want_g = torch.autograd.grad(want, list(params.values()))
    loss = grad_cache_value_and_grad(embed, _coupled_loss, k)(batch)
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    for p, g in zip(params.values(), want_g):
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6)

    jl, jg = jax_grad_cache_value_and_grad(
        lambda p, mb, key: (jnp.tanh(mb["t"] @ p["t"]),
                            jnp.tanh(mb["v"] @ p["v"])),
        _jax_coupled_loss, k)(w, x)
    assert loss.item() == pytest.approx(float(jl), rel=1e-6)
    for n, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[n]),
                                   rtol=1e-5, atol=1e-6)


def test_grad_cache_divisibility_error():
    p = torch.nn.Parameter(torch.eye(4))
    vg = grad_cache_value_and_grad(lambda mb: (mb["x"] @ p,),
                                   lambda e: (e * e).sum(), 3)
    with pytest.raises(ValueError, match="divisible"):
        vg({"x": torch.ones(8, 4)})


def test_grad_cache_replays_the_drop_path_masks():
    kw = dict(img_size=RES, patch_size=16, embed_dim=24, depth=2, num_heads=2,
              time_init="random", drop_path_rate=0.5)
    torch.manual_seed(0)
    tower = SpaceTimeTransformer(VideoTowerConfig(**kw)).train()
    video = torch.randn(8, 4, RES, RES, 3)
    target = torch.randn(8, 24)

    def loss_fn(e):
        return ((e @ e.T) * (target @ target.T)).sum()

    def grads(run):
        tower.zero_grad(set_to_none=True)
        run()
        return [p.grad.clone() for p in tower.parameters()]

    def monolithic():  # the micro-batches one after another, one generator
        gen = torch.Generator().manual_seed(5)
        loss_fn(torch.cat([tower(v, gen) for v in video.chunk(4)])).backward()

    def cached(replay):
        gen = torch.Generator().manual_seed(5)
        grad_cache_value_and_grad(lambda mb: (tower(mb["v"], gen),), loss_fn,
                                  4)({"v": video}, gen if replay else None)

    want = grads(monolithic)
    for g, w in zip(grads(lambda: cached(True)), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # pass 2 drawing its own masks gives another gradient
    assert any(not torch.allclose(g, w, rtol=1e-3, atol=1e-3)
               for g, w in zip(grads(lambda: cached(False)), want))


def _grad_recorder():
    """An optax transformation that updates nothing and keeps the
    gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_egoclip_step_n_micro_2_matches_jax(monkeypatch):
    params = random_params(2)
    batch = egoclip_batch(21, b=4)
    rng = jax.random.PRNGKey(4)
    key = jax.random.split(rng)[0]  # the JAX step's transform key
    state = create_train_state(JaxDualEncoder(jax_config("xla")), params,
                               _grad_recorder())
    state, want = jax_make_egoclip_train_step(input_res=RES, n_micro=2)(
        state, batch, rng)
    want_g = params_from_jax(jax.tree.map(np.asarray, state.opt_state))

    model = port_model(params).train()
    monkeypatch.setattr(port_steps, "sample_crop_boxes",
                        lambda gen, b, src: jax_boxes(key, b, src))
    got = port_steps.make_egoclip_train_step(input_res=RES, n_micro=2)(
        model, NoUpdate(model), port_inputs(batch), torch.Generator())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   rtol=1e-3, atol=2e-5, err_msg=k)


def test_ring_with_grad_accum_raises():
    with pytest.raises(ValueError, match="ring"):
        port_steps.make_egoclip_train_step(global_sim="ring", n_micro=2)


def test_grad_accum_at_world_2_is_the_global_batch_step(tmp_path,
                                                        monkeypatch):
    world, b = 2, 2
    params = random_params(9)
    batch = egoclip_batch(13, b=world * b)
    key = jax.random.split(jax.random.PRNGKey(5))[0]
    boxes = jax_boxes(key, 2 * world * b, batch["frames"].shape[2])
    (tmp_path / "model.json").write_text(json.dumps({
        "video": {**VIDEO, "attention_impl": "auto"}, "text": TEXT,
        "sched": {**SCHED, "milestones": list(SCHED["milestones"])},
        "res": RES, "n_micro": 2}))
    torch.save(params_from_jax(params), tmp_path / "weights.pt")
    torch.save({"batch": port_inputs(batch), "boxes": boxes[0],
                "flips": boxes[1]}, tmp_path / "batch.pt")
    procs = start_workers("step", world, tmp_path)
    loss, grads, _ = one_process_step(params, batch, boxes, monkeypatch)
    wait_all(procs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    assert ranks[0]["loss"].item() == ranks[1]["loss"].item()
    np.testing.assert_allclose(ranks[0]["loss"].item(), loss.item(),
                               rtol=1e-5)
    # float32 sums in another order: each rank adds two micro-batches'
    # backward passes, then DDP the two ranks', where one backward sums
    # the whole batch.  An element that sums terms up to the largest
    # gradient g_max and cancels to ~1e-3 of it (a position embedding's)
    # keeps ~1e-5 of g_max of rounding: that floor, with rtol 1e-5
    g_max = max(g.abs().max().item() for g in grads.values())
    for k, want in grads.items():
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(),
                                   want.numpy(), rtol=1e-5,
                                   atol=1e-5 * g_max, err_msg=k)


@pytest.mark.parametrize("variant,max_norm", [
    ("optax", 0.5), ("optax", 1e-3), ("reference", 0.5)])
def test_adamw_with_max_grad_norm_matches_jax_over_5_steps(variant,
                                                           max_norm):
    rng = np.random.default_rng(1)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    # one scale a step across both leaves: global norms from ~1e-6 to ~4
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()}
             for scale in (1.0, 1e-6, 1e-2, 3e-4, 0.3)]
    sched = dict(base_lr=1e-2, milestones=(1, 2), steps_per_epoch=2)
    tx = jax_make_optimizer(**sched, max_grad_norm=max_norm, variant=variant)
    jp, st = dict(params), tx.init(params)
    model = torch.nn.Module()
    for k, v in params.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
    opt, _ = make_optimizer(model, **sched, max_grad_norm=max_norm,
                            variant=variant)
    clipped = 0
    for g in grads:
        clipped += optax.global_norm(g) >= max_norm
        upd, st = jax.jit(tx.update)(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in model.named_parameters():
            # float32, the same formula; the norm summed in another order
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert 0 < clipped < len(grads)
