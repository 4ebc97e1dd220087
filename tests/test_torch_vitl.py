"""The ViT-L EgoClip slice, ``configs/pt/egoclip_vitl_tp.json``, on the CPU.

* The config builds at its published width (D 1024, 24 blocks, 16 heads,
  ``remat: true`` -> ``'block'``) with the JAX model's parameter count.
* The weight bridge maps all 24 blocks: at depth 24 (width cut to 32) the
  port's ``params_from_jax`` gives the JAX ``export_dual_encoder`` state
  dict key for key and bit for bit, and it loads strictly into the model
  that ``build`` makes from the config.
* ``run_task`` on the config shrunk by overrides as a user passes them
  with ``-o`` (depth 2, D 64, 4 heads; ``remat='attn_out'``;
  ``mesh.model`` 1 with the config's ``sequence_parallel``;
  ``trainer.grad_accum`` 2; a tiny text tower, the synthetic EgoClip tree,
  2 + 2 clips a step), against JAX ``run_task`` on the same tree and
  ``.pth``: every step's loss within rtol 1e-4 (float32, AdamW at lr 1e-3,
  as ``tests/test_torch_recipes.py``), equal EgoMCQ accuracies, and
  both warn that sequence parallelism is off.  JAX's crop boxes are
  patched into the port as in that file.
* ``mesh.model`` 2, the config as shipped, raises naming A13.
"""

import copy
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import egovlp_tpu.train.recipes as jax_recipes
from egovlp_tpu.io.config import Config as JaxConfig
from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.models.convert import export_dual_encoder, save_torch_checkpoint
from egovlp_tpu.train.build import build_model_config as jax_build_model_config
from egovlp_tpu_torch import build
from egovlp_tpu_torch.io.config import Config
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.train import recipes
from tests.test_datasets import egoclip_root  # noqa: F401
from tests.test_torch_models import RES, TEXT
from tests.test_torch_recipes import VOCAB, jax_crops, record_jax, record_port

VITL = Path(__file__).resolve().parents[1] / "configs/pt/egoclip_vitl_tp.json"


def vitl_config(**overrides) -> Config:
    cfg = Config(json.loads(VITL.read_text()))
    for k, v in overrides.items():
        cfg.override(k, v)
    return cfg


def jax_params(arch, seed):
    """The JAX dual encoder of ``arch`` with its tree filled from a numpy
    seed (LayerNorm scales near 1, every other leaf normal, std 0.2)."""
    cfg = jax_build_model_config(arch)
    res = cfg.video.img_size
    shapes = jax.eval_shape(
        JaxDualEncoder(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4, res, res, 3), jnp.float32),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.normal(size=s.shape).astype(np.float32)
        return 1.0 + 0.1 * x if path[-1].key == "scale" else 0.2 * x

    return cfg, jax.tree_util.tree_map_with_path(leaf, shapes)


def test_vitl_config_builds_at_its_width():
    arch = vitl_config()["arch"]
    cfg = build.build_model_config(arch)
    assert (cfg.video.embed_dim, cfg.video.depth, cfg.video.num_heads,
            cfg.video.num_frames) == (1024, 24, 16, 4)
    assert cfg.video.remat_mode == "block"
    model, _ = build.build_model(arch, "meta")
    n = sum(p.numel() for p in model.parameters())
    jcfg = jax_build_model_config(arch)
    shapes = jax.eval_shape(
        JaxDualEncoder(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4, 224, 224, 3), jnp.float32),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert 470e6 < n < 472e6  # 470.9M, docs/SCALING.md:69


def test_weight_bridge_maps_all_24_blocks():
    cfg = vitl_config(**{"arch.args.video_params.embed_dim": 32,
                         "arch.args.video_params.num_heads": 2,
                         "arch.args.video_params.img_size": RES,
                         "arch.args.text_params": dict(TEXT),
                         "arch.args.projection_dim": 8})
    jcfg, params = jax_params(cfg["arch"], 0)
    assert jcfg.video.depth == 24
    got = params_from_jax(params)
    want = export_dual_encoder(params, jcfg)
    assert set(got) == set(want)
    assert {k.split(".")[2] for k in got
            if k.startswith("video_model.blocks.")} == {str(i)
                                                        for i in range(24)}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)
    model, _ = build.build_model(cfg["arch"], "cpu")
    model.load_state_dict(got, strict=True)


def shrunk(root, vocab, ckpt, save_dir) -> dict:
    """The ViT-L config with the overrides a user passes as ``-o``."""
    return {
        "arch.args.video_params.depth": 2,
        "arch.args.video_params.embed_dim": 64,
        "arch.args.video_params.num_heads": 4,
        "arch.args.video_params.remat": "attn_out",
        "arch.args.video_params.img_size": RES,
        "arch.args.video_params.time_init": "random",
        "arch.args.text_params": {**TEXT, "max_length": 8, "vocab": vocab},
        "arch.args.projection_dim": 8,
        "arch.args.load_checkpoint": ckpt,
        "arch.args.precision": "fp32",
        "data_loader.args.data_dir": root,
        "data_loader.args.meta_dir": root,
        "data_loader.args.batch_size": 2,
        "data_loader.args.num_workers": 2,
        "data_loader.args.shuffle": False,
        "data_loader.args.neg_param": 1,
        "data_loader.args.video_params": {"input_res": RES, "num_frames": 4,
                                          "pre_size": 40,
                                          "loading": "strict"},
        "optimizer.args.lr": 1e-3,
        "trainer.epochs": 1,
        "trainer.max_samples_per_epoch": 6,  # 3 steps of 2 clips
        "trainer.save_dir": save_dir,
        "trainer.grad_accum": 2,
        "mesh.model": 1,
        # one device: the JAX of these tests has 8 virtual CPU devices
        "n_devices": 1,
    }


def recording_steps(monkeypatch, module, losses):
    """Each EgoClip step the recipe of ``module`` builds records its
    loss."""
    make = module.make_egoclip_train_step

    def make_recorded(*a, **kw):
        step = make(*a, **kw)

        def recorded(*args):
            out = step(*args)
            losses.append(float(out[1] if isinstance(out, tuple) else out))
            return out

        return recorded

    monkeypatch.setattr(module, "make_egoclip_train_step", make_recorded)


@pytest.fixture(scope="module")
def vitl_runs(egoclip_root, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("vitl")
    vocab = tmp / "vocab.txt"
    vocab.write_text("\n".join(VOCAB))
    over = shrunk(egoclip_root, str(vocab), str(tmp / "init.pth"),
                  str(tmp / "jax"))
    cfg = vitl_config(**over)
    jcfg, params = jax_params(cfg["arch"], 3)
    assert jcfg.video.remat == "attn_out"
    save_torch_checkpoint(params, jcfg, str(tmp / "init.pth"))
    mp = pytest.MonkeyPatch()
    out = {"jax_logs": [], "port_logs": [], "jax_losses": [],
           "port_losses": []}
    handler = logging.Handler()
    warnings = []
    handler.emit = lambda r: warnings.append((r.name, r.getMessage()))
    handler.setLevel(logging.WARNING)
    logging.getLogger().addHandler(handler)
    try:
        record_jax(mp, out["jax_logs"])
        record_port(mp, out["port_logs"])
        recording_steps(mp, jax_recipes, out["jax_losses"])
        recording_steps(mp, recipes, out["port_losses"])
        jax_crops(mp)
        jax_recipes.run_task(JaxConfig(copy.deepcopy(dict(cfg))))
        port_cfg = vitl_config(**{**over, "trainer.save_dir": str(tmp / "port")})
        recipes.run_task(port_cfg, device="cpu")
    finally:
        mp.undo()
        logging.getLogger().removeHandler(handler)
    out["warnings"] = warnings
    return out


def test_vitl_run_task_matches_jax(vitl_runs):
    port, want = vitl_runs["port_logs"], vitl_runs["jax_logs"]
    assert [(kind, epoch) for kind, epoch, *_ in port] == [("train", 1),
                                                          ("val", 1)]
    assert [(kind, epoch) for kind, epoch, *_ in want] == [("train", 1),
                                                          ("val", 1)]
    got_l, want_l = vitl_runs["port_losses"], vitl_runs["jax_losses"]
    assert len(got_l) == len(want_l) == 3 and np.isfinite(got_l).all()
    # float32 through both towers, GradCache in both, AdamW at lr 1e-3
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    assert port[0][3] == want[0][3] == 3  # optimizer steps
    assert port[1][2] == want[1][2]
    assert set(port[1][2]) == {"Intra-video", "Inter-video"}


def test_sequence_parallel_at_model_1_warns_and_trains(vitl_runs):
    """C3: the config's ``mesh.sequence_parallel`` at ``model`` 1 logs JAX's
    warning in both packages and the epoch finishes."""
    said = [(name, msg) for name, msg in vitl_runs["warnings"]
            if "sequence parallelism is OFF" in msg]
    assert {name.split(".")[0] for name, _ in said} == {"egovlp_tpu",
                                                        "egovlp_tpu_torch"}
    assert vitl_runs["port_logs"][0][:2] == ("train", 1)
    assert np.isfinite(vitl_runs["port_logs"][0][2]["loss_0"])


def test_vitl_as_shipped_raises_naming_a13(tmp_path):
    cfg = vitl_config(**{"trainer.save_dir": str(tmp_path)})
    assert cfg["mesh"]["model"] == 2
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*A13"):
        recipes.run_task(cfg, device="cpu")
    assert not (tmp_path / "models").exists()
