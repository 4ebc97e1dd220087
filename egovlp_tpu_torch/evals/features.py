"""Dense feature extraction for Ego4D NLQ / MQ episodic memory.

Counterpart of ``egovlp_tpu/evals/features.py`` (:31-105).  Video mode:
each clip's dense frames are cut into ``[n_windows, num_frames, ...]``
windows (a tail shorter than a window dropped), embedded in
micro-batches of ``micro_batch`` windows through ``embed_video``, and
saved as one ``[n_windows, D]`` file a ``clip_uid``.  The JAX package
pads the last micro-batch to keep XLA's shapes static and drops the pad
rows; here the last micro-batch is just shorter.  Text mode: each query's
CLS feature ``[D]`` (``encode_text``) or token features ``[S, D]``
(``encode_text_tokens``), saved as ``{clip_uid}_sentence_{k}``, ``k``
counting the clip's queries.  Files are ``.npy``, or ``.pt`` (a tensor
through ``torch.save``) with ``save_format='pt'``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from egovlp_tpu_torch.train.steps import embed_video


def _save(path: Path, array: np.ndarray, save_format: str) -> None:
    if save_format == "pt":
        torch.save(torch.from_numpy(np.ascontiguousarray(array)),
                   str(path.with_suffix(".pt")))
    elif save_format == "npy":
        np.save(path.with_suffix(".npy"), array)
    else:
        raise ValueError(f"save_format {save_format!r}: expected 'npy' or "
                         "'pt'")


def extract_video_features(model, dataset, out_dir: str,
                           num_frames: int = 4, input_res: int = 224,
                           micro_batch: int = 4,
                           save_format: str = "npy") -> None:
    """``dataset``: an NLQ / MQ dataset in ``subsample='video'`` mode."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model.eval()
    rng = np.random.default_rng(0)
    for i in range(len(dataset)):
        item = dataset.get(i, rng)
        frames = item["frames"]
        n = (frames.shape[0] // num_frames) * num_frames
        if n == 0:
            continue
        windows = frames[:n].reshape(-1, num_frames, *frames.shape[1:])
        feats = [embed_video(model, windows[j:j + micro_batch], input_res)
                 .cpu().numpy()
                 for j in range(0, len(windows), micro_batch)]
        _save(out / item["meta"]["clip_uid"], np.concatenate(feats),
              save_format)


def extract_text_features(model, dataset, tokenizer, out_dir: str,
                          token_level: bool = False,
                          save_format: str = "npy") -> None:
    """``dataset``: an NLQ dataset in ``subsample='text'`` mode; one file a
    query."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model.eval()
    device = next(model.parameters()).device
    encode = model.encode_text_tokens if token_level else model.encode_text
    rng = np.random.default_rng(0)
    counter = {}
    for i in range(len(dataset)):
        item = dataset.get(i, rng)
        ids, mask = tokenizer([item["text"]])
        with torch.inference_mode():
            feat = encode(torch.as_tensor(ids).to(device),
                          torch.as_tensor(mask).to(device))[0]
        clip_uid = item["meta"]["clip_uid"]
        k = counter.get(clip_uid, 0)
        counter[clip_uid] = k + 1
        _save(out / f"{clip_uid}_sentence_{k}", feat.cpu().numpy(),
              save_format)
