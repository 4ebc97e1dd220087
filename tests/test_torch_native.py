"""The port's binding of the native decoder (``egovlp_tpu_torch/data/
native.py``) against the JAX package's, on the CPU.

* a B-frame clip (``max_b_frames`` 2, keyframes 50 apart) written by the
  port's ``encode_video`` decodes to the same frames through the port's
  and the JAX package's ``NativeVideo``, random access equal to a
  sequential decode (the decoder's pts reordering and skip-roll paths);
* both bindings read the same ``decode_stats`` (one library in one
  process: the same counters), which count the reads, and a reset through
  either clears them for both;
* the encoder refuses frames that are not ``[n, h, w, 3]``.

Each test skips, naming ``make -C native``, where the library is not
built.
"""

import numpy as np
import pytest

from egovlp_tpu.data import native as jax_native
from egovlp_tpu_torch.data import native

N, GOP = 200, 50


@pytest.fixture
def library():
    if not native.available():
        pytest.skip("native/libegodecode.so is not built: make -C native")


@pytest.fixture
def bframe_clip(library, tmp_path):
    """A smooth, slightly noisy 128 x 96 clip of ``N`` frames, encoded by
    the port with B-frames."""
    w, h = 128, 96
    t = np.arange(N)[:, None, None, None]
    yy = np.arange(h)[None, :, None, None]
    xx = np.arange(w)[None, None, :, None]
    frames = ((np.sin(0.05 * t + 0.1 * yy) + np.cos(0.07 * t + 0.08 * xx)
               + 2) * 60).astype(np.uint8)
    frames = np.broadcast_to(frames, (N, h, w, 3)).copy()
    frames += np.random.default_rng(0).integers(
        0, 8, size=(1, h, w, 3)).astype(np.uint8)
    path = tmp_path / "b.mp4"
    assert native.encode_video(path, frames, fps=30, gop=GOP,
                               max_b_frames=2)
    return str(path)


def test_port_encoded_bframe_clip_decodes_alike(bframe_clip):
    with native.NativeVideo(bframe_clip) as v:
        assert v.frame_count == N
        seq, n_ok = v.read_frames(list(range(N)), pre_size=64)
    assert n_ok == N
    for targets in ([149], [3, 52, 90, 91, 180], [199]):
        with native.NativeVideo(bframe_clip) as v:
            got, n_ok = v.read_frames(targets, pre_size=64)
        with jax_native.NativeVideo(bframe_clip) as v:
            want, n_want = v.read_frames(targets, pre_size=64)
        assert n_ok == n_want == len(targets)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, seq[targets])


def test_both_bindings_read_the_same_decode_stats(bframe_clip):
    native.decode_stats(reset=True)
    with native.NativeVideo(bframe_clip) as v:
        v.read_frames([52, 149, 151], pre_size=64)
    ours = native.decode_stats()
    assert ours == jax_native.decode_stats(reset=True)
    assert ours["n_open"] >= 1 and ours["n_frames_out"] == 3
    assert 3 <= ours["n_frames_decoded"] < N
    assert ours["n_frames_skipped"] > 0  # the roll past B-frames
    assert native.decode_stats() == {**{k: 0.0 for k in ours
                                        if k.endswith("_s")},
                                     **{k: 0 for k in ours
                                        if k.startswith("n_")}}


def test_encoder_refuses_frames_without_channels(library, tmp_path):
    with pytest.raises(ValueError, match=r"\[n, h, w, 3\]"):
        native.encode_video(tmp_path / "x.mp4", np.zeros((4, 8, 8), np.uint8))
