"""The port at bf16 vs the JAX package at bf16 (CPU).

Both sides round bf16 at the same points, so they agree to the bit or
nearly.  Three things make that hold:

* the JAX side is compiled with ``xla_allow_excess_precision`` off.  With
  XLA's default, fused bf16 ops keep float32 intermediates, and JAX's own
  output then depends on how XLA fuses;
* hd is 64, as in every shipped config.  There ``q * hd ** -0.5`` scales by
  0.125, which is exact in bf16.  At other hd, JAX rounds the scale to bf16
  first and torch multiplies by the float32 scale;
* the port rounds where JAX rounds: the ``Linear`` product before its bias
  add, the CLS row's patch sum before its CLS term, every op of the exact
  GELU, and the XLA attention paths at their own points.

Towers (``attention_impl='pallas'``: JAX's Pallas kernels in interpret
mode, the port's plain twins): the video tower at D 128, 2 heads, 2 blocks,
img 32, 4 frames; the text tower at D 128, 2 heads, 2 layers.  Limit:
relative L2 1e-4 on the video CLS feature and on the text hidden states
(0.0 seen: bit-equal).  What is left between the two is the order of
float32 sums (a LayerNorm's statistics, a matmul's accumulation): where it
flips one bf16 value, the flip spreads through the later layers and the
CLS feature reads 2e-3 to 5e-3.  The weights and inputs here flip none;
about half of other seeds do.  A rounding point put back to where the port
had it (the bias add, the CLS row, the GELU) fails the limit on its own.

``divided_attention_parts(impl='xla')`` on both axes and ``'xla2'`` on time
at f 4 n 49 and f 16 n 16, D 128, 2 heads.  Limit: relative L2 2e-4
(bf16 values that float32 sums of another order flip: time 0.0 at f 4 and
6.6e-5 at f 16, space up to 1.3e-4; the kernels' rounding points read
3.3e-3 to 3.5e-3).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.kernels.divided_attention import (
    divided_attention_parts as jax_divided_attention_parts,
)
from egovlp_tpu.models import (
    DualEncoder as JaxDualEncoder,
    DualEncoderConfig as JaxDualEncoderConfig,
    TextTowerConfig as JaxTextTowerConfig,
    VideoTowerConfig as JaxVideoTowerConfig,
)
from egovlp_tpu_torch.kernels.divided_attention import divided_attention_parts
from egovlp_tpu_torch.models import (
    DualEncoder,
    DualEncoderConfig,
    TextTowerConfig,
    VideoTowerConfig,
)
from egovlp_tpu_torch.models.convert import params_from_jax

RES = 32
VIDEO = dict(img_size=RES, patch_size=16, embed_dim=128, depth=2,
             num_heads=2, num_frames=4, time_init="random",
             attention_impl="pallas")
TEXT = dict(vocab_size=64, dim=128, n_layers=2, n_heads=2, hidden_dim=512,
            max_position_embeddings=16)
TOWER_TOL = 1e-4


def compile_strict(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's excess precision off,
    so every bf16 op rounds its result."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def rel_l2(got, want) -> float:
    g, w = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _jax_model():
    return JaxDualEncoder(JaxDualEncoderConfig(
        video=JaxVideoTowerConfig(**VIDEO), text=JaxTextTowerConfig(**TEXT),
        projection_dim=16), dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def params():
    """The JAX dual encoder's float32 param tree from a numpy seed:
    LayerNorm scales near 1, biases ~0.1, every other leaf normal with std
    1 / sqrt(fan-in), time attention included."""
    shapes = jax.eval_shape(
        _jax_model().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4, RES, RES, 3), jnp.float32),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(1)

    def leaf(path, s):
        x = rng.normal(size=s.shape).astype(np.float32)
        if path[-1].key == "scale":
            return 1.0 + 0.1 * x
        if path[-1].key == "bias":
            return 0.1 * x
        return x / np.float32(math.sqrt(max(1, math.prod(s.shape[:-1]))))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_model(params):
    cfg = DualEncoderConfig(video=VideoTowerConfig(**VIDEO),
                            text=TextTowerConfig(**TEXT), projection_dim=16)
    model = DualEncoder(cfg, dtype=torch.bfloat16).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def test_video_tower_bf16_matches_jax(params):
    video = np.random.default_rng(1).normal(
        size=(2, 4, RES, RES, 3)).astype(np.float32)
    model = _jax_model()

    def cls(p, v):
        return model.apply({"params": p}, v,
                           method=lambda m, v: m.video_model(v))

    want = compile_strict(cls, params, video)(params, video)
    with torch.inference_mode():
        got = _port_model(params).video_model(torch.from_numpy(video))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = rel_l2(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert err <= TOWER_TOL, err


def test_text_tower_bf16_matches_jax(params):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, TEXT["vocab_size"], (3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    model = _jax_model()

    def hidden(p, i, m):
        return model.apply({"params": p}, i, m,
                           method=lambda mod, i, m: mod.text_model(i, m))

    want = compile_strict(hidden, params, ids, mask)(params, ids, mask)
    with torch.inference_mode():
        got = _port_model(params).text_model(torch.from_numpy(ids).long(),
                                             torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = rel_l2(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert err <= TOWER_TOL, err


@pytest.mark.parametrize("axis,impl,tol", [("space", "xla", 2e-4),
                                           ("time", "xla", 2e-4),
                                           ("time", "xla2", 2e-4)])
@pytest.mark.parametrize("f,n", [(4, 49), (16, 16)])
def test_xla_parts_bf16_match_jax(axis, impl, tol, f, n):
    B, D, H = 2, 128, 2
    rng = np.random.default_rng(f * 100 + n)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in [(B, 1, D)] * 3 + [(B, f, n, D)] * 3]
    fn = functools.partial(jax_divided_attention_parts, heads=H, frames=f,
                           patches=n, axis=axis, impl=impl)
    xs = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    want = compile_strict(fn, *xs)(*xs)
    got = divided_attention_parts(
        *(torch.from_numpy(a).bfloat16() for a in arrs), heads=H, axis=axis,
        impl=impl)
    for name, g, w in zip(("cls", "grid"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        err = rel_l2(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= tol, (name, err)


def test_first_step_grads_bf16_near_jax(params):
    """EgoNCE gradients of every parameter at bf16, one batch of 4 clips.
    Backward passes round at other points in the two frameworks (autograd
    against JAX's VJPs and Pallas backward kernels), and at this batch a
    float32 summation-order difference flips bf16 values of the forward
    too, so the gap is pinned, not closed: relative L2 over all parameters
    8.4e-3 and cosine 0.999965 seen, against JAX's own bf16-vs-float32 gap
    of 2.6e-2 on the same batch."""
    from egovlp_tpu.models import sim_matrix as jax_sim_matrix
    from egovlp_tpu.objectives import egonce as jax_egonce
    from egovlp_tpu_torch.models.dual_encoder import sim_matrix
    from egovlp_tpu_torch.objectives.contrastive import egonce

    rng = np.random.default_rng(5)
    video = rng.normal(size=(4, 4, RES, RES, 3)).astype(np.float32)
    ids = rng.integers(4, TEXT["vocab_size"], (4, 8)).astype(np.int32)
    mask = np.ones((4, 8), np.int32)
    mask[1, 6:] = 0
    verbs = np.eye(3, dtype=np.float32)[[0, 1, 0, 2]]
    nouns = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    mv, mn = verbs @ verbs.T, nouns @ nouns.T
    model = _jax_model()

    def loss_fn(p):
        t, v = model.apply({"params": p}, video, ids, mask)
        return jax_egonce(jax_sim_matrix(t, v), mv, mn, 0.05)

    want = params_from_jax(jax.tree.map(
        lambda g: np.asarray(g, np.float32),
        compile_strict(jax.grad(loss_fn), params)(params)))
    port = _port_model(params).train()
    t, v = port(torch.from_numpy(video), torch.from_numpy(ids).long(),
                torch.from_numpy(mask))
    egonce(sim_matrix(t, v), torch.from_numpy(mv), torch.from_numpy(mn),
           0.05).backward()
    names = sorted(want)
    got = np.concatenate([port.get_parameter(k).grad.double().numpy().ravel()
                          for k in names])
    ref = np.concatenate([want[k].double().numpy().ravel() for k in names])
    cos = float(got @ ref / np.linalg.norm(got) / np.linalg.norm(ref))
    err = rel_l2(got, ref)
    assert err <= 2e-2 and cos >= 0.9999, (err, cos)
