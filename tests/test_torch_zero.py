"""ZeRO over the port's data group on the CPU: gloo ranks as subprocesses
(``tests/torch_ddp_worker.py mesh``), float32, tiny widths, leaves of at
least 256 elements split (the tiny model has none of JAX's default
16384).

* world 2 (data 2): stages 1 and 3 against the replicated run (the same
  data-parallel mesh without ZeRO) over 2 EgoClip steps: the losses, and
  every parameter after them within 1e-6 relative; each split leaf's
  moments are half its rows on the split dim (stage 3: the parameter too);
* world 4 (data 2 x model 2): ZeRO 1 composed with tensor parallelism
  against tensor parallelism alone, the same limits; then a checkpoint of
  the tensor-parallel run resumed onto another mesh (data 4, ZeRO 3)
  trains a third step, against the one-process port's third step: the
  loss within 1e-5 relative, the parameters within 1e-4 relative or the
  learning rate;
* world 4 with sequence parallelism (the video tower stored split over
  the model group): ZeRO 1 and 3 against sequence parallelism alone over
  2 steps, the same limits, and that run against one process (the
  losses within 1e-5 relative, the first step's gradients within 1e-4
  relative L2); ZeRO splits a model-split leaf's slice on its other dim;
* stage 2 raises, with JAX's message.
"""

import numpy as np
import pytest
import torch

from egovlp_tpu_torch.core.mesh import MeshSpec, create_mesh
from egovlp_tpu_torch.core.zero import apply_mesh
from egovlp_tpu_torch.train.state import make_optimizer
from tests.test_torch_ddp import start_workers, wait_all
from tests.test_torch_models import VIDEO, port_model
from tests.test_torch_tp_sp import (
    check_grads,
    one_process,
    setup,
    write_inputs,
)
from tests.test_torch_train import SCHED

MIN = 256
LAUNCHES = {
    "data2": (2, [
        {"name": "replicated", "mesh": {"data": 2}, "steps": 2},
        {"name": "zero1", "mesh": {"data": 2}, "zero": 1, "steps": 2,
         "min_size": MIN},
        {"name": "zero3", "mesh": {"data": 2}, "zero": 3, "steps": 2,
         "min_size": MIN}]),
    "data2-model2": (4, [
        {"name": "tp", "mesh": {"data": 2, "model": 2}, "steps": 2,
         "save": "ckpt"},
        {"name": "tp-zero1", "mesh": {"data": 2, "model": 2}, "zero": 1,
         "steps": 2, "min_size": MIN},
        {"name": "resumed", "mesh": {"data": 4}, "zero": 3, "steps": 1,
         "min_size": MIN, "resume": "ckpt"},
        {"name": "sp", "mesh": {"data": 2, "model": 2}, "sp": True,
         "steps": 2},
        *({"name": f"sp-zero{z}", "mesh": {"data": 2, "model": 2},
           "sp": True, "zero": z, "steps": 2, "min_size": MIN}
          for z in (1, 3))]),
}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    params, batch, boxes = setup(4)
    procs = {}
    for name, (world, runs) in LAUNCHES.items():
        out = tmp_path_factory.mktemp(name)
        write_inputs(out, runs, params, batch, boxes)
        procs[name] = (world, out, start_workers("mesh", world, out))
    try:
        ref = one_process(params, batch, boxes, n_steps=3)
    except BaseException:
        for *_, ps in procs.values():
            for p in ps:
                p.kill()
        raise
    yield procs, ref
    for *_, ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


def results(procs, name):
    world, out, ps = procs[name]
    wait_all(ps)
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_matches_replicated_at_data_2(stage, launched):
    procs, _ = launched
    ranks = results(procs, "data2")
    for r, res in enumerate(ranks):
        want, got = res["replicated"], res[f"zero{stage}"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for k, v in want["params"].items():
            torch.testing.assert_close(got["params"][k], v, rtol=1e-6,
                                       atol=0, msg=k)
        for k, v in want["moments"].items():
            for m in ("mu", "nu"):
                torch.testing.assert_close(got["moments"][k][m], v[m],
                                           rtol=1e-6, atol=1e-12)
        split = 0
        for k, moments in got["local_moments"].items():
            whole = tuple(want["params"][k].shape)
            local = moments["nu"]
            if local == whole:
                continue
            (d,) = [d for d, (a, b) in enumerate(zip(local, whole)) if a != b]
            assert local[d] * 2 == whole[d], (k, local, whole)
            assert got["local"][k] == (local if stage == 3 else whole), k
            split += 1
        assert split >= 10, split  # the tiny model's leaves of >= 256


def test_zero_composes_with_tensor_parallel_and_resumes_elsewhere(launched):
    procs, (losses, _, after, _) = launched
    ranks = results(procs, "data2-model2")
    for r, res in enumerate(ranks):
        want, got = res["tp"], res["tp-zero1"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for k, v in want["params"].items():
            torch.testing.assert_close(got["params"][k], v, rtol=1e-6,
                                       atol=0, msg=k)
        # a leaf split by both: its tensor-parallel shard halved again
        qkv = "video_model.blocks.0.attn.qkv.weight"
        whole = tuple(want["params"][qkv].shape)
        assert want["local"][qkv] == (whole[0] // 2, whole[1])
        assert got["local_moments"][qkv]["nu"] == (whole[0] // 2,
                                                   whole[1] // 2)
        # the checkpoint of 2 steps, resumed at data 4 with ZeRO 3
        res_run = res["resumed"]
        np.testing.assert_allclose(res_run["losses"][0], losses[2],
                                   rtol=1e-5)
        for k, ref in after.items():
            p = res_run["params"][k]
            np.testing.assert_allclose(p.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=SCHED["base_lr"], err_msg=k)


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_composes_with_sequence_parallel(stage, launched):
    procs, (losses, grads, _, _) = launched
    D = VIDEO["embed_dim"]
    for r, res in enumerate(results(procs, "data2-model2")):
        want, got = res["sp"], res[f"sp-zero{stage}"]
        np.testing.assert_allclose(want["losses"], losses[:2], rtol=1e-5)
        check_grads(want["grads"], grads, f"rank {r}")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        check_grads(got["grads"], grads, f"stage {stage} rank {r}")
        for k, v in want["params"].items():
            torch.testing.assert_close(got["params"][k], v, rtol=1e-6,
                                       atol=0, msg=k)
        for k, v in want["moments"].items():
            for m in ("mu", "nu"):
                torch.testing.assert_close(got["moments"][k][m], v[m],
                                           rtol=1e-6, atol=1e-12)
        # the model group splits qkv's rows and fc2's columns, ZeRO the
        # other dim of each slice: (whole, the model's slice, ZeRO's)
        for k, whole, model_split, split in (
                ("video_model.blocks.0.attn.qkv.weight", (3 * D, D),
                 (3 * D // 2, D), (3 * D // 2, D // 2)),
                ("video_model.blocks.1.mlp.fc2.weight", (D, 4 * D),
                 (D, 2 * D), (D // 2, 2 * D))):
            assert tuple(got["params"][k].shape) == whole, k
            assert want["local_moments"][k]["nu"] == model_split, k
            assert got["local_moments"][k]["nu"] == split, k
            assert got["local"][k] == (split if stage == 3
                                       else model_split), k


def test_zero_stage_2_raises():
    model = port_model(setup(2)[0])
    opt, _ = make_optimizer(model, **SCHED)
    with pytest.raises(ValueError, match="zero stage must be 1 or 3, got 2"):
        apply_mesh(model, opt, create_mesh(MeshSpec()), zero=2)
