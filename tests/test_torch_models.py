"""Port towers and dual encoder vs the JAX modules (float32, CPU).

Tiny widths (img 32, patch 16, D 24, 2 heads, depth 2) with a random,
non-zero time-attention init, so the time path carries signal.  The JAX
weights cross over through ``params_from_jax``; the JAX side runs with
``attention_impl`` 'xla' and 'pallas' (Pallas in interpret mode).
Tolerance 1e-4: float32 through a few layers, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.kernels.fused_ln import fused_layer_norm as jax_fused_layer_norm
from egovlp_tpu.models import (
    DualEncoder as JaxDualEncoder,
    DualEncoderConfig as JaxDualEncoderConfig,
    TextTowerConfig as JaxTextTowerConfig,
    VideoTowerConfig as JaxVideoTowerConfig,
)
from egovlp_tpu_torch.kernels.fused_ln import FusedLayerNorm, fused_layer_norm
from egovlp_tpu_torch.models import (
    DualEncoder,
    DualEncoderConfig,
    TextTowerConfig,
    VideoTowerConfig,
)
from egovlp_tpu_torch.models.convert import params_from_jax

TOL = 1e-4
RES = 32
VIDEO = dict(img_size=RES, patch_size=16, embed_dim=24, depth=2, num_heads=2,
             num_frames=4, time_init="random")
TEXT = dict(vocab_size=64, dim=24, n_layers=2, n_heads=2, hidden_dim=48,
            max_position_embeddings=16)


def jax_config(impl: str = "xla") -> JaxDualEncoderConfig:
    return JaxDualEncoderConfig(
        video=JaxVideoTowerConfig(**VIDEO, attention_impl=impl),
        text=JaxTextTowerConfig(**TEXT), projection_dim=8)


def port_model(params, impl: str = "auto") -> DualEncoder:
    cfg = DualEncoderConfig(video=VideoTowerConfig(**VIDEO, attention_impl=impl),
                            text=TextTowerConfig(**TEXT), projection_dim=8)
    model = DualEncoder(cfg).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def random_params(seed: int = 0):
    """The tiny JAX dual encoder's param tree filled from a numpy seed:
    LayerNorm scales near 1, every other leaf (time attention included)
    normal with std 0.2."""
    shapes = jax.eval_shape(
        JaxDualEncoder(jax_config()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4, RES, RES, 3), jnp.float32),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.normal(size=s.shape).astype(np.float32)
        return 1.0 + 0.1 * x if path[-1].key == "scale" else 0.2 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_params():
    return random_params()


def jax_apply(params, method, *args, impl="xla"):
    model = JaxDualEncoder(jax_config(impl))
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))
    return jax.tree.map(np.asarray, fn(params, *args))


def _video_outputs(m, video):
    cls = m.video_model(video)
    return cls, m.vid_proj(cls)


def _text_outputs(m, ids, mask):
    hidden = m.text_model(ids, mask)
    return hidden, m._project_text(hidden[:, 0]), m._project_text(hidden)


def text_inputs(seed=0, B=3, S=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TEXT["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    return ids, mask


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_fused_layer_norm_matches_jax(eps):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 7, 24)) * 3 + 1.5).astype(np.float32)
    scale = rng.normal(size=24).astype(np.float32)
    bias = rng.normal(size=24).astype(np.float32)
    want = np.asarray(jax_fused_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                           jnp.asarray(bias), eps))
    got = fused_layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    ln = FusedLayerNorm(24, eps)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(), want,
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("frames", [1, 4])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_video_tower_and_embedding_match_jax(jax_params, frames, jax_impl):
    video = np.random.default_rng(1).normal(
        size=(2, frames, RES, RES, 3)).astype(np.float32)
    want_cls, want_emb = jax_apply(jax_params, _video_outputs, video,
                                   impl=jax_impl)
    model = port_model(jax_params)
    with torch.inference_mode():
        cls = model.video_model(torch.from_numpy(video))
        emb = model.encode_video(torch.from_numpy(video))
    assert emb.shape == (2, 8) and emb.dtype == torch.float32
    np.testing.assert_allclose(cls.numpy(), want_cls, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(emb.numpy(), want_emb, rtol=TOL, atol=TOL)


def test_text_tower_and_embeddings_match_jax(jax_params):
    ids, mask = text_inputs()
    model = port_model(jax_params)
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.inference_mode():
        hidden = model.text_model(t_ids, t_mask)
        emb = model.encode_text(t_ids, t_mask)
        tokens = model.encode_text_tokens(t_ids, t_mask)
    wants = jax_apply(jax_params, _text_outputs, ids, mask)
    for got, want in zip((hidden, emb, tokens), wants):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_attention_impls_agree_on_cpu(jax_params):
    """'auto', 'pallas', 'xla' and 'mixed' all run the plain twins on a CPU
    tensor, so they give one result."""
    video = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 4, RES, RES, 3)).astype(np.float32))
    outs = []
    for impl in ("auto", "pallas", "xla", "mixed"):
        with torch.inference_mode():
            outs.append(port_model(jax_params, impl).encode_video(video))
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="attention_impl"):
        port_model(jax_params, "bogus")
