"""Offline video preprocessing: resize to short side 256 and cut into
600-second chunks.

The port's own copy of ``egovlp_tpu/tools/video_prep.py`` (the
reference's ``utils/video_resize.py``, ffmpeg ``scale=trunc(oh*a/2)*2:256``,
and ``utils/video_chunk.py``, copy-codec splits of at most 600 s into
``{uid}/{chunk}.mp4``).  It runs the ``ffmpeg`` binary where one is on
PATH, else re-encodes with OpenCV (slower, no audio).

CLI:
    python -m egovlp_tpu_torch.tools.video_prep resize --src DIR --dst DIR [-j 8]
    python -m egovlp_tpu_torch.tools.video_prep chunk  --src DIR --dst DIR [-j 8]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
from multiprocessing.pool import ThreadPool
from pathlib import Path

CHUNK_SEC = 600


def _has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _video_meta(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return fps, n, w, h


def resize_video(src: str, dst: str, short_side: int = 256,
                 gop: "int | None" = None) -> None:
    """Short side -> ``short_side``, both sides even.  ``gop`` caps the
    encoder's keyframe interval (ffmpeg only): the default, x264's 250
    frames, makes a random read decode from a keyframe up to 250 frames
    back; chunks for training reads are better cut at 30."""
    if os.path.exists(dst):
        return
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    if _has_ffmpeg():
        # height the short side, width from the aspect (the reference's form)
        g = ["-g", str(int(gop))] if gop else []
        subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-i", src,
                        "-filter:v", f"scale=trunc(oh*a/2)*2:{short_side}",
                        *g, "-c:a", "copy", dst], check=True)
        return
    # cv2 fallback (video only)
    import cv2

    fps, n, w, h = _video_meta(src)
    if h <= w:
        nh, nw = short_side, int(round(w * short_side / h / 2)) * 2
    else:
        nw, nh = short_side, int(round(h * short_side / w / 2)) * 2
    cap = cv2.VideoCapture(src)
    out = cv2.VideoWriter(dst, cv2.VideoWriter_fourcc(*"mp4v"), fps, (nw, nh))
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        out.write(cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_LINEAR))
    cap.release()
    out.release()


def chunk_video(src: str, dst_dir: str, chunk_sec: int = CHUNK_SEC) -> None:
    """Split into {dst_dir}/{i}.mp4 chunks of at most chunk_sec seconds."""
    os.makedirs(dst_dir, exist_ok=True)
    fps, n_frames, _, _ = _video_meta(src)
    duration = n_frames / max(fps, 1e-6)
    if duration <= chunk_sec:
        target = os.path.join(dst_dir, "0.mp4")
        if not os.path.exists(target):
            shutil.copyfile(src, target)
        return
    n_chunks = int(duration // chunk_sec) + 1
    if _has_ffmpeg():
        for i in range(n_chunks):
            target = os.path.join(dst_dir, f"{i}.mp4")
            if os.path.exists(target):
                continue
            subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-ss",
                            str(i * chunk_sec), "-t", str(chunk_sec), "-i",
                            src, "-c", "copy", target], check=True)
        return
    import cv2

    cap = cv2.VideoCapture(src)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    per_chunk = int(chunk_sec * fps)
    for i in range(n_chunks):
        target = os.path.join(dst_dir, f"{i}.mp4")
        out = cv2.VideoWriter(target, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                              (w, h))
        for _ in range(per_chunk):
            ret, frame = cap.read()
            if not ret:
                break
            out.write(frame)
        out.release()
    cap.release()


def _run_pool(fn, jobs, n_workers):
    with ThreadPool(n_workers) as pool:
        pool.starmap(fn, jobs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("resize", "chunk"))
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--short_side", type=int, default=256)
    ap.add_argument("--gop", type=int, default=None,
                    help="keyframe interval for the resize re-encode "
                         "(default: encoder default, like the reference; "
                         "30 recommended for training-read chunks)")
    ap.add_argument("--chunk_sec", type=int, default=CHUNK_SEC)
    ap.add_argument("-j", "--jobs", type=int, default=8)
    args = ap.parse_args(argv)

    videos = sorted(Path(args.src).glob("*.mp4"))
    if args.mode == "resize":
        jobs = [(str(v), os.path.join(args.dst, v.name), args.short_side,
                 args.gop) for v in videos]
        _run_pool(resize_video, jobs, args.jobs)
    else:
        jobs = [(str(v), os.path.join(args.dst, v.stem), args.chunk_sec)
                for v in videos]
        _run_pool(chunk_video, jobs, args.jobs)


if __name__ == "__main__":
    main()
