"""K1's bf16 rounding points vs the JAX Pallas space kernels (CPU).

The JAX space bodies fold ``log2(e)`` into the q scaling, round ``q *
scale * log2(e)`` to bf16 and take ``exp2``; the backward multiplies dK by
``ln(2)`` (``pallas_attention.py`` :473-530 for ``_v2``, :590-666 for
``_v3``).  The plain K1 twins must round at the same points, which a
float32 comparison cannot see.  Here they are held at bf16, at hd 64,
against ``make_space_attention_bsd`` in interpret mode and its
``jax.vjp``, for both default bodies: D 128, H 2 (the head-packed ``_v3``)
and D 64, H 1 (``_v2``, one head a lane block).

Limits, relative L2 ``||port - jax|| / ||jax||``, from the gaps the
matched rounding leaves (a few bf16 outputs a thousand that a different
summation order rounds the other way):

* forward 1e-4 (largest seen 4.8e-5; rounding ``q * scale`` and taking
  ``exp`` instead gives 3.1e-3 to 3.3e-3);
* dq, dk, dv 5e-4 (largest seen 1.2e-4; the other rounding point gives
  3.0e-3 to 3.8e-3);
* the CLS grads 5e-4 at one frame, where both sides round once, and 6e-3
  at two frames: JAX rounds each frame's share to bf16 before the sum,
  the port sums in float32 and rounds once (largest gap seen 3.3e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.kernels.pallas_attention import make_space_attention_bsd
from egovlp_tpu_torch.kernels import cuda_attention as ca

B, N, HD = 2, 49, 64
SCALE = HD ** -0.5
GRAD_NAMES = ("dq", "dk", "dv", "dcls_k", "dcls_v")
FWD_TOL, GRAD_TOL, CLS_SUM_TOL = 1e-4, 5e-4, 6e-3


@functools.lru_cache(maxsize=None)
def _jax_fwd_vjp(heads: int):
    fn = make_space_attention_bsd(heads, SCALE)

    @jax.jit
    def run(q, k, v, ck, cv, do):
        out, vjp = jax.vjp(fn, q, k, v, ck, cv)
        return out, vjp(do)

    return run


def _rel_l2(got: torch.Tensor, want) -> float:
    g = got.double().numpy()
    w = np.asarray(want.astype(jnp.float32), np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("D,heads", [(128, 2), (64, 1)])
@pytest.mark.parametrize("f", [1, 2])
def test_space_plain_matches_pallas_at_bf16(D, heads, f):
    rng = np.random.default_rng(D + 10 * f)
    grid = [rng.normal(size=(B, f, N, D)).astype(np.float32) for _ in range(4)]
    cls = [rng.normal(size=(B, 1, D)).astype(np.float32) for _ in range(2)]
    arrs = (*grid[:3], *cls, grid[3])
    want_out, want = _jax_fwd_vjp(heads)(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    xs = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    out = ca.space_attention_fwd_plain(*xs[:5], heads=heads, scale=SCALE)
    grads = ca.space_attention_bwd_plain(*xs, heads=heads, scale=SCALE)

    assert out.dtype == torch.bfloat16 and out.shape == want_out.shape
    rel = _rel_l2(out, want_out)
    assert rel <= FWD_TOL, f"out: relative L2 {rel:.2e}"
    for name, g, w in zip(GRAD_NAMES, grads, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        tol = CLS_SUM_TOL if name.startswith("dcls") and f > 1 else GRAD_TOL
        rel = _rel_l2(g, w)
        assert rel <= tol, f"{name}: relative L2 {rel:.2e} > {tol:.0e}"
