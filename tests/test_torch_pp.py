"""Pipeline parallelism of the port's video tower on the CPU: gloo ranks
as subprocesses (``tests/torch_ddp_worker.py pipeline``), float32, the
tiny tower (2 blocks) at 2 stages x ``n_micro`` 4 on a batch of 8, alone
(world 2) and with a data axis (world 4: 2 stages x 2 data ranks, each
pipelining its row of every microbatch).

Forward: every rank's output rows against the sequential port tower and
JAX's ``tower.apply`` (the plain counterpart of its
``video_tower_pp_apply``) on the same bridged weights, within 1e-5.
Gradients of ``sum(out * cotangent)``: a block's summed over the stage
(and data) ranks, the embedding's likewise, the head's over the data
ranks of one stage, against the sequential tower's, within 1e-5
(relative to the largest gradient of the parameter).  Also the state
dict's block stacking, and the refusal of stochastic layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.models import SpaceTimeTransformer as JaxTower
from egovlp_tpu.models import VideoTowerConfig as JaxVideoConfig
from egovlp_tpu_torch.core.pp import (
    block_names,
    pp_rows,
    stack_block_params,
    stage_owner,
    unstack_block_params,
    video_tower_pp_apply,
)
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.models.video_tower import (
    SpaceTimeTransformer,
    VideoTowerConfig,
)
from tests.test_torch_ddp import start_workers, wait_all
from tests.test_torch_models import RES, VIDEO, random_params

B, N_MICRO, STAGES = 8, 4, 2
TOL = 1e-5


def tower_weights():
    sd = params_from_jax(random_params(9))
    return {k[len("video_model."):]: v for k, v in sd.items()
            if k.startswith("video_model.")}


def port_tower(weights, **cfg):
    tower = SpaceTimeTransformer(VideoTowerConfig(**{**VIDEO, **cfg}))
    tower.load_state_dict(weights)
    return tower.eval()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    rng = np.random.default_rng(4)
    weights = tower_weights()
    video = torch.from_numpy(rng.normal(size=(B, 4, RES, RES, 3))
                             .astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(B, VIDEO["embed_dim"]))
                           .astype(np.float32))
    procs = {}
    for world in (2, 4):
        out = tmp_path_factory.mktemp(f"pp{world}")
        torch.save({"video": VIDEO, "weights": weights, "video_in": video,
                    "cotangent": cot, "stages": STAGES, "n_micro": N_MICRO},
                   out / "pp.pt")
        procs[world] = (out, start_workers("pipeline", world, out))
    try:
        tower = port_tower(weights)
        want = tower(video)
        (want * cot).sum().backward()
        grads = {k: p.grad.clone() for k, p in tower.named_parameters()}
        params = random_params(9)["video_model"]
        jax_tower = JaxTower(JaxVideoConfig(**VIDEO, attention_impl="xla"))
        jax_out = np.asarray(jax.jit(lambda p, v: jax_tower.apply(
            {"params": p}, v))(params, jnp.asarray(video.numpy())))
    except BaseException:
        for _, ps in procs.values():
            for p in ps:
                p.kill()
        raise
    yield procs, want.detach(), grads, jax_out
    for _, ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


@pytest.mark.parametrize("world", [2, 4], ids=["stages2", "stages2-data2"])
def test_pipeline_matches_the_sequential_tower(world, launched):
    procs, want, grads, jax_out = launched
    out, ps = procs[world]
    wait_all(ps)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(world)]
    n_data = world // STAGES
    np.testing.assert_allclose(want.numpy(), jax_out, rtol=TOL, atol=TOL)
    for r, res in enumerate(ranks):
        rows = pp_rows(B, N_MICRO, r // STAGES, n_data)
        np.testing.assert_allclose(res["out"].numpy(), want[rows].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["out"].numpy(), jax_out[rows.numpy()],
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")
    depth = VIDEO["depth"]
    for k, g in grads.items():
        owner = stage_owner(k, depth, STAGES)
        parts = [res["grads"][k] for r, res in enumerate(ranks)
                 if owner is None and r % STAGES == 0
                 or owner is not None]
        got = sum(p for p in parts if p is not None)
        scale = g.abs().max().item()
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0,
                                   atol=TOL * max(scale, 1e-3), err_msg=k)
        # a block's gradient reaches its own stage alone
        if owner is not None and k.startswith("blocks."):
            for r, res in enumerate(ranks):
                if r % STAGES != owner:
                    assert res["grads"][k] is None, (k, r)


def test_block_stacking_round_trip():
    weights = tower_weights()
    names = block_names(weights)
    assert names == [f"blocks.{i}" for i in range(VIDEO["depth"])]
    stacked = stack_block_params(weights)
    assert stacked["attn.qkv.weight"].shape[0] == VIDEO["depth"]
    back = unstack_block_params(stacked, VIDEO["depth"])
    for k, v in back.items():
        assert torch.equal(v, weights[k]), k
    with pytest.raises(ValueError, match="no blocks"):
        block_names({"norm.weight": torch.zeros(2)})


def test_stochastic_layers_raise():
    tower = port_tower(tower_weights(), drop_path_rate=0.1).train()
    with pytest.raises(NotImplementedError, match="drop-path"):
        video_tower_pp_apply(tower, torch.zeros(8, 4, RES, RES, 3),
                             n_stages=2, n_micro=4, stage_group=None)
