"""The port's retrieval metrics vs the JAX package's (numpy both: exact).

The cases of ``tests/test_metrics.py``: identity, several captions a
video, the closest caption, tie averaging, the vectorized v2t against the
per-video loop with and without query masks, and one-row blocks; each
drawn from a numpy seed and fed to both packages, whose dicts must be
equal (NaN equal to NaN).
"""

import numpy as np
import pytest

import egovlp_tpu.metrics.retrieval as jax_retrieval
import egovlp_tpu_torch.metrics.retrieval as retrieval
from egovlp_tpu_torch.metrics import METRIC_REGISTRY


def same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k] == want[k]
                or (np.isnan(got[k]) and np.isnan(want[k]))), k


def cases():
    rng = np.random.default_rng(0)
    out = {
        "identity": (np.eye(6) * 2 + rng.uniform(0, 0.5, (6, 6)), None),
        "two_captions_a_video": (np.array([[0.9, 0.1], [0.2, 0.3],
                                           [0.1, 0.8], [0.7, 0.6]]), None),
        "closest_caption": (np.array([[0.1, 0.0], [0.9, 0.0],
                                      [0.0, 0.2], [0.0, 0.8]]), None),
        "all_ties": (np.zeros((3, 3)), None),
    }
    for cpv in (1, 3):
        for quantize in (False, True):
            sims = np.random.default_rng(7).normal(size=(23 * cpv, 23))
            if quantize:  # many exact ties
                sims = np.round(sims * 2) / 2
            out[f"cpv{cpv}_quantized{quantize}"] = (sims, None)
    mrng = np.random.default_rng(11)
    sims = np.round(mrng.normal(size=(24, 12)) * 3) / 3
    mask = mrng.integers(0, 2, size=24)
    mask[0] = 1
    out["masked"] = (sims, mask)
    return out


CASES = cases()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("direction", ["t2v_metrics", "v2t_metrics"])
def test_metrics_match_jax(name, direction):
    sims, mask = CASES[name]
    got = getattr(retrieval, direction)(sims, query_masks=mask)
    want = getattr(jax_retrieval, direction)(sims, query_masks=mask)
    same(got, want)
    assert METRIC_REGISTRY[direction] is getattr(retrieval, direction)


def test_identity_and_ties_values():
    sims = CASES["identity"][0]
    assert retrieval.t2v_metrics(sims)["R1"] == 100.0
    assert retrieval.v2t_metrics(sims)["MedR"] == 1.0
    # every rank the mean of 0, 1, 2 -> MedR 2
    assert retrieval.v2t_metrics(np.zeros((3, 3)))["MedR"] == 2.0
    assert retrieval.v2t_metrics(CASES["closest_caption"][0])["R1"] == 100.0
    assert retrieval.t2v_metrics(
        CASES["two_captions_a_video"][0])["R1"] == 50.0


def test_small_blocks_match_one_pass(monkeypatch):
    sims = np.round(np.random.default_rng(3).normal(size=(16, 8)) * 2) / 2
    full = retrieval.v2t_metrics(sims)
    monkeypatch.setattr(retrieval, "_V2T_BLOCK_BUDGET", 1)
    assert retrieval.v2t_metrics(sims) == full
    monkeypatch.setattr(jax_retrieval, "_V2T_BLOCK_BUDGET", 1)
    same(full, jax_retrieval.v2t_metrics(sims))


def test_bad_input_raises():
    with pytest.raises(ValueError, match="2-D"):
        retrieval.t2v_metrics(np.zeros(3))
