"""Port weight bridge vs the JAX converter (CPU).

``params_from_jax`` must give exactly the keys and values of
``export_dual_encoder``; a ``.pth`` written by ``save_torch_checkpoint``
must load through ``load_pth`` / ``build.load_pretrained`` and reproduce
the JAX outputs (tolerance 1e-4, float32); the prefix and temporal-embed
helpers must match the JAX ones (exact, or 1e-6 for the interpolation).
"""

import numpy as np
import pytest
import torch

from egovlp_tpu.models.convert import (
    export_dual_encoder,
    inflate_temporal_embed as jax_inflate_temporal_embed,
    save_torch_checkpoint,
    strip_data_parallel_prefix as jax_strip_data_parallel_prefix,
)
from egovlp_tpu_torch import build
from egovlp_tpu_torch.models.convert import (
    inflate_temporal_embed,
    load_pth,
    params_from_jax,
    strip_data_parallel_prefix,
)
from tests.test_torch_models import (  # noqa: F401
    RES,
    TEXT,
    VIDEO,
    _video_outputs,
    jax_apply,
    jax_config,
    jax_params,
    port_model,
    text_inputs,
)


def test_params_from_jax_matches_export(jax_params):  # noqa: F811
    want = export_dual_encoder(jax_params, jax_config())
    got = params_from_jax(jax_params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the port's module names are the reference names: a strict load works
    assert sorted(port_model(jax_params).state_dict()) == sorted(want)


def test_pth_checkpoint_reproduces_jax(jax_params, tmp_path):  # noqa: F811
    path = str(tmp_path / "egovlp.pth")
    save_torch_checkpoint(jax_params, jax_config(), path)
    arch = {"args": {"video_params": {**VIDEO, "vit_weights": ""},
                     "text_params": {**TEXT, "weights": ""},
                     "projection_dim": 8, "load_checkpoint": path}}
    model, cfg = build.build_model(arch, "cpu", torch.float32)
    assert cfg.video.time_init == "random" and cfg.projection_dim == 8
    build.load_pretrained(model, arch)

    video = np.random.default_rng(3).normal(
        size=(2, 4, RES, RES, 3)).astype(np.float32)
    ids, mask = text_inputs()
    with torch.inference_mode():
        v = model.encode_video(torch.from_numpy(video))
        t = model.encode_text(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask))
    _, want_v = jax_apply(jax_params, _video_outputs, video)
    want_t = jax_apply(jax_params, "encode_text", ids, mask)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), want_t, rtol=1e-4, atol=1e-4)


def test_load_pth_strips_prefix_and_inflates(jax_params, tmp_path):  # noqa: F811
    sd = {f"module.{k}": torch.from_numpy(v) for k, v in
          export_dual_encoder(jax_params, jax_config()).items()}
    sd["module.video_model.temporal_embed"] = sd[
        "module.video_model.temporal_embed"][:, :2]
    path = str(tmp_path / "dp.pth")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    got = load_pth(path, num_frames=4, load_temporal_fix="nearest")
    assert not any(k.startswith("module.") for k in got)
    te = got["video_model.temporal_embed"]
    assert te.shape == (1, 4, VIDEO["embed_dim"])
    torch.testing.assert_close(te[:, 1], te[:, 0])


def test_strip_prefix_matches_jax():
    for keys in (["module.a", "module.b"], ["module.a", "b"], []):
        sd = {k: np.zeros(1) for k in keys}
        assert (sorted(strip_data_parallel_prefix(sd))
                == sorted(jax_strip_data_parallel_prefix(sd)))


@pytest.mark.parametrize("mode", ["zeros", "interp", "bilinear", "nearest"])
@pytest.mark.parametrize("src,target", [(2, 5), (3, 4), (6, 4), (4, 4)])
def test_inflate_temporal_embed_matches_jax(mode, src, target):
    embed = np.random.default_rng(src).normal(size=(1, src, 8)).astype(
        np.float32)
    want = jax_inflate_temporal_embed(embed, target, mode)
    got = inflate_temporal_embed(torch.from_numpy(embed), target, mode)
    assert got.shape == (1, target, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_init_params_is_seeded_and_zero_inits_time_attention():
    arch = {"args": {"video_params": {**VIDEO, "time_init": "zeros"},
                     "text_params": TEXT, "projection_dim": 8}}
    model, _ = build.build_model(arch, "cpu")
    assert model.video_model.dtype == torch.bfloat16  # precision default
    build.init_params(model, seed=0)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    build.init_params(model, seed=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, first[k]), k
    blk = model.video_model.blocks[0]
    assert not blk.timeattn.qkv.weight.any()
    assert bool((blk.timeattn.proj.weight == 1).all())
    assert blk.attn.qkv.weight.std() > 0


def test_load_pretrained_partial_tower_weights(tmp_path):
    """Without a full checkpoint, timm-ViT and DistilBERT files initialise
    their towers; keys a tower does not have are skipped."""
    arch = {"args": {"video_params": dict(VIDEO), "text_params": dict(TEXT),
                     "projection_dim": 8}}
    model, _ = build.build_model(arch, "cpu", torch.float32)
    build.init_params(model, seed=0)
    ref, _ = build.build_model(arch, "cpu", torch.float32)
    build.init_params(ref, seed=1)
    vit = {k: v for k, v in ref.video_model.state_dict().items()
           if "timeattn" not in k and "temporal" not in k}
    vit["head.weight"] = torch.zeros(3, VIDEO["embed_dim"])
    bert = {f"distilbert.{k}": v for k, v in ref.text_model.state_dict().items()}
    bert["vocab_projector.weight"] = torch.zeros(3, TEXT["dim"])
    arch["args"]["video_params"]["vit_weights"] = str(tmp_path / "vit.pth")
    arch["args"]["text_params"]["weights"] = str(tmp_path / "bert.bin")
    torch.save(vit, arch["args"]["video_params"]["vit_weights"])
    torch.save(bert, arch["args"]["text_params"]["weights"])
    before = model.video_model.blocks[0].timeattn.qkv.weight.clone()
    build.load_pretrained(model, arch)
    got, want = model.state_dict(), ref.state_dict()
    for k in want:
        if k.startswith("text_model.") or (k.startswith("video_model.") and
                                           "timeattn" not in k
                                           and "temporal" not in k):
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(model.video_model.blocks[0].timeattn.qkv.weight, before)


def test_orbax_checkpoint_dir_raises_a_clear_error(tmp_path):
    arch = {"args": {"video_params": dict(VIDEO), "text_params": dict(TEXT),
                     "projection_dim": 8, "load_checkpoint": str(tmp_path)}}
    model, _ = build.build_model(arch, "cpu", torch.float32)
    with pytest.raises(ValueError, match="Orbax"):
        build.load_pretrained(model, arch)
