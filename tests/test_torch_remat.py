"""The video tower's activation recompute (``remat``) vs the JAX package
and vs no recompute (CPU, float32; tiny widths of ``test_torch_models``).

* Each mode (``True``/``'block'``, ``'attn'``, ``'attn_out'``, ``'mlp'``)
  on the port's kernel route (the Functions' plain twins on CPU tensors)
  and on ``attention_impl='xla'``: the video embedding and the gradient of
  every video parameter against the JAX tower with the same mode (rtol
  1e-3, atol 2e-5, as the other float32 tower tests: float32 through two
  blocks, gradients up to ~1), and against the port without recompute
  (bit-equal: the recompute repeats the same ops on the same inputs).
* With ``drop_path_rate > 0`` and one generator seed, every mode's
  output and gradients equal no recompute's; drawing the masks inside the
  recomputed block instead (the mutation below) changes the gradients.
* ``'attn_out'`` runs the attention forward once a block per axis (the
  backward recomputes only the qkv projection); ``'attn'`` and
  ``'block'`` twice.  An unknown mode raises.
"""

import jax
import numpy as np
import pytest
import torch

from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.models import DualEncoderConfig as JaxDualEncoderConfig
from egovlp_tpu.models import TextTowerConfig as JaxTextTowerConfig
from egovlp_tpu.models import VideoTowerConfig as JaxVideoTowerConfig
from egovlp_tpu_torch.kernels import cuda_attention
from egovlp_tpu_torch.models import (
    DualEncoder,
    DualEncoderConfig,
    TextTowerConfig,
    VideoTowerConfig,
)
from egovlp_tpu_torch.models import video_tower
from egovlp_tpu_torch.models.convert import params_from_jax
from tests.test_torch_models import RES, TEXT, VIDEO, random_params

MODES = [True, "block", "attn", "attn_out", "mlp"]


@pytest.fixture(scope="module")
def params():
    return random_params(11)


def _video(seed=0, B=3):
    return np.random.default_rng(seed).normal(
        size=(B, 4, RES, RES, 3)).astype(np.float32)


def _weights(seed=1):
    return np.random.default_rng(seed).normal(size=(3, 8)).astype(np.float32)


def _port(params, remat, impl="auto", drop_path_rate=0.0):
    cfg = DualEncoderConfig(
        video=VideoTowerConfig(**VIDEO, attention_impl=impl, remat=remat,
                               drop_path_rate=drop_path_rate),
        text=TextTowerConfig(**TEXT), projection_dim=8)
    model = DualEncoder(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.train()


def _port_grads(model, video, w, seed=None):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    v = model.encode_video(torch.from_numpy(video), gen)
    (v * torch.from_numpy(w)).sum().backward()
    return v.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                        if p.grad is not None}


@pytest.fixture(scope="module")
def no_recompute(params):
    return {impl: _port_grads(_port(params, False, impl), _video(), _weights())
            for impl in ("auto", "xla")}


@pytest.mark.parametrize("remat", MODES)
def test_remat_matches_jax_and_no_recompute(params, no_recompute, remat):
    video, w = _video(), _weights()
    jcfg = JaxDualEncoderConfig(
        video=JaxVideoTowerConfig(**VIDEO, attention_impl="xla", remat=remat),
        text=JaxTextTowerConfig(**TEXT), projection_dim=8)
    jmodel = JaxDualEncoder(jcfg)

    def loss(p):
        v = jmodel.apply({"params": p}, video, deterministic=False,
                         method=JaxDualEncoder.encode_video)
        return (v * w).sum(), v

    (_, want_v), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = params_from_jax(jax.tree.map(np.asarray, want))
    for impl in ("auto", "xla"):
        v, grads = _port_grads(_port(params, remat, impl), video, w)
        ref_v, ref = no_recompute[impl]
        assert torch.equal(v, ref_v)
        assert grads.keys() == ref.keys()
        assert all(k.startswith(("video_model.", "vid_proj.")) for k in grads)
        np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-4,
                                   atol=1e-4)
        for k, g in grads.items():
            assert torch.equal(g, ref[k]), f"{k}, remat={remat}, impl={impl}"
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-3,
                                       atol=2e-5, err_msg=f"{k}, {remat}")


def _unreplayed_forward(self, xc, xp, generator=None, rows=None):
    """A block that draws its masks inside the recomputed region (one
    process: ``rows`` None)."""
    def body(xc, xp):
        masks = [video_tower.drop_path_mask(xc.shape[0], self.drop_path,
                                            generator)
                 for _ in range(2 if self.drop_path > 0 else 0)]
        return self._body(xc, xp, *masks)

    return video_tower._recompute(body, xc, xp)


def test_remat_replays_the_drop_path_masks(params, monkeypatch):
    video, w = _video(2, B=8), np.tile(_weights(3), (3, 1))[:8]
    want_v, want = _port_grads(_port(params, False, drop_path_rate=0.5),
                               video, w, seed=4)
    for remat in MODES:
        v, grads = _port_grads(_port(params, remat, drop_path_rate=0.5),
                               video, w, seed=4)
        assert torch.equal(v, want_v), remat
        for k, g in want.items():
            assert torch.equal(grads[k], g), f"{k}, remat={remat}"
    # the mutation: masks drawn again by the recompute
    monkeypatch.setattr(video_tower.SpaceTimeBlock, "forward",
                        _unreplayed_forward)
    v, grads = _port_grads(_port(params, "block", drop_path_rate=0.5), video,
                           w, seed=4)
    assert torch.equal(v, want_v)  # the forward drew the same masks
    assert any(not torch.allclose(grads[k], g, rtol=1e-3, atol=1e-5)
               for k, g in want.items())


@pytest.mark.parametrize("remat,forwards", [
    (False, 1), ("attn_out", 1), ("mlp", 1), ("attn", 2), ("block", 2)])
def test_attention_forwards_a_step(params, monkeypatch, remat, forwards):
    """Attention kernel calls of one forward + backward, 2 blocks: the
    last block's space backward is dead (the tower returns the CLS)."""
    calls = dict.fromkeys(("space_attention_fwd", "time_attention_fwd",
                           "space_attention_bwd", "time_attention_bwd"), 0)
    # the autograd Functions (and the 'attn_out' backward) launch through
    # ``direct``; a forward with grad mode off, as 'attn_out' runs its
    # attention, through the ops' wrappers
    direct = cuda_attention.direct

    def counted_direct(name, *a):
        calls[name] += name in calls
        return direct(name, *a)

    monkeypatch.setattr(cuda_attention, "direct", counted_direct)
    monkeypatch.setattr(video_tower, "direct", counted_direct)
    for name in ("space_attention_fwd", "time_attention_fwd"):
        fn = getattr(cuda_attention, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cuda_attention, name, counted)
    _port_grads(_port(params, remat), _video(), _weights())
    depth = VIDEO["depth"]
    assert calls == {"space_attention_fwd": forwards * depth,
                     "time_attention_fwd": forwards * depth,
                     "space_attention_bwd": depth - 1,
                     "time_attention_bwd": depth}


@pytest.mark.parametrize("remat", ["full", "attention", 2, None])
def test_unknown_remat_raises(remat):
    with pytest.raises(ValueError, match="remat"):
        VideoTowerConfig(remat=remat)
    assert VideoTowerConfig(remat="none").remat_mode == "none"
    assert VideoTowerConfig(remat=True).remat_mode == "block"
