"""HTML retrieval-ranking reports and alignment-path grids.

The port's own copy of ``egovlp_tpu/io/visualizer.py`` (numpy and the
standard library; no model code):

* ``RetrievalVisualizer``: one self-contained HTML page per epoch,
  ``{web_dir}/ranking_ep{N}.html``, showing randomly chosen queries (a
  ``random.Random(seed)``) with their top-k candidates and the ground
  truth, plus ``index.html``;
* ``visualise_path`` / ``batch_path_vis``: prediction-vs-target alignment
  paths rendered as float32 ``[3, H, W]`` RGB grids;
* ``build_visualizer``: a ``RetrievalVisualizer`` from a config's
  ``visualizer`` section when its ``type`` is set, else None.
"""

from __future__ import annotations

import html
import random
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; margin: 20px; }}
.query {{ margin: 24px 0; padding: 12px; border: 1px solid #ccc; }}
.rank {{ display: inline-block; margin: 4px; text-align: center;
        vertical-align: top; }}
.rank video, .rank img {{ width: 220px; }}
.gt {{ outline: 3px solid #2a2; }}
.label {{ font-size: 12px; color: #444; max-width: 220px; }}
</style></head><body>
<h1>{title}</h1>
{body}
</body></html>
"""


def _media_tag(path: str) -> str:
    p = html.escape(str(path))
    if p.endswith((".jpg", ".jpeg", ".png")):
        return f'<img src="{p}">'
    return f'<video controls muted src="{p}"></video>'


class RetrievalVisualizer:
    """Top-k retrieval report writer.

    Args:
      web_dir: output directory for the HTML pages.
      num_samples: number of (randomly chosen) queries per page.
      top_k: retrieved items shown per query.
    """

    def __init__(self, web_dir: str, num_samples: int = 20, top_k: int = 5,
                 seed: int = 0):
        self.web_dir = Path(web_dir)
        self.num_samples = num_samples
        self.top_k = top_k
        self.rng = random.Random(seed)
        self.web_dir.mkdir(parents=True, exist_ok=True)

    def visualize_ranking(self, sims: np.ndarray, epoch: int,
                          queries: Sequence[str],
                          paths: Sequence[str],
                          gt_index: Optional[Sequence[int]] = None,
                          show_gt: bool = True) -> Path:
        """sims: [num_queries, num_videos]; queries: raw caption strings;
        paths: video/image path per candidate (relative to web_dir);
        gt_index: ground-truth candidate per query (default: diagonal);
        show_gt=False omits GT highlighting (multi-label tasks like
        Charades, where no single candidate is 'the' ground truth)."""
        sims = np.asarray(sims)
        nq = sims.shape[0]
        gt = (np.arange(nq) if gt_index is None
              else np.asarray(gt_index).reshape(-1))
        chosen = sorted(self.rng.sample(range(nq), min(self.num_samples, nq)))

        sections: List[str] = []
        for qi in chosen:
            order = np.argsort(-sims[qi])[: self.top_k]
            cells = []
            for r, vi in enumerate(order):
                cls = ("rank gt" if show_gt and vi == gt[qi] else "rank")
                cells.append(
                    f'<div class="{cls}">{_media_tag(paths[vi])}'
                    f'<div class="label">#{r + 1} sim={sims[qi, vi]:.3f}'
                    f"</div></div>"
                )
            header = f"<b>{html.escape(str(queries[qi]))}</b>"
            if show_gt:
                gt_rank = int(np.where(
                    np.argsort(-sims[qi]) == gt[qi])[0][0]) + 1
                if gt[qi] not in order:
                    cells.append(
                        f'<div class="rank gt">{_media_tag(paths[gt[qi]])}'
                        f'<div class="label">GT (rank {gt_rank})</div></div>'
                    )
                header += f" — GT rank {gt_rank}"
            sections.append(
                f'<div class="query">{header}<br>{"".join(cells)}</div>'
            )

        page = self.web_dir / f"ranking_ep{epoch}.html"
        page.write_text(_PAGE.format(
            title=f"Retrieval ranking — epoch {epoch}",
            body="\n".join(sections),
        ))
        self._write_index()
        return page

    def _write_index(self):
        links = sorted(self.web_dir.glob("ranking_ep*.html"))
        body = "<ul>" + "".join(
            f'<li><a href="{p.name}">{p.name}</a></li>' for p in links
        ) + "</ul>"
        (self.web_dir / "index.html").write_text(
            _PAGE.format(title="Retrieval reports", body=body)
        )


# --------------------------------------------------------------------------
# alignment-path grids (reference: utils/visualisation.py)
# --------------------------------------------------------------------------

_PATH_TP = np.array([64, 191, 64], np.float32)    # predicted AND target
_PATH_FP = np.array([191, 64, 64], np.float32)    # predicted only
_PATH_GT = np.array([102, 153, 255], np.float32)  # target


def visualise_path(pred, target, window) -> np.ndarray:
    """Render a prediction-vs-target alignment path as an RGB grid.

    The reference's ``utils/visualisation.py`` (:8-38).
    ``pred``/``target`` are sequences of ``(clip_idx, j)`` coordinates;
    ``window`` is an ``[H, W]`` cost window whose NaN cells (outside the
    alignment band) render grey (130/255).  Target cells draw blue, correct
    predictions green, incorrect red; rows are re-indexed to the unique clip
    indices appearing in ``target`` (same quirk as the reference).  Returns
    float32 ``[3, H, W]`` in [0, 1] (CHW, matching the reference so image
    writers/TB consume it unchanged).
    """
    window = np.asarray(window, np.float32)
    grid = np.full((3,) + window.shape, 255.0, np.float32)
    grid = np.where(np.isnan(window)[None], 130.0, grid)

    local_idxs = np.unique([t[0] for t in target]).tolist()
    for t in target:
        grid[:, local_idxs.index(t[0]), int(t[1])] = _PATH_GT
    for p in pred:
        cell = (local_idxs.index(p[0]), int(p[1]))
        hit = (grid[:, cell[0], cell[1]] == _PATH_GT).all()
        grid[:, cell[0], cell[1]] = _PATH_TP if hit else _PATH_FP
    return grid / 255.0


def batch_path_vis(pred_dict, target, window) -> np.ndarray:
    """Stack one ``visualise_path`` grid per prediction method; the
    ``'min_dist'`` method renders on a zeroed window (no band), as the
    reference's ``utils/visualisation.py`` (:41-52).  Returns
    ``[M, 3, H, W]``."""
    window = np.asarray(window, np.float32)
    grids = []
    for key, pred in pred_dict.items():
        win = np.zeros_like(window) if key == "min_dist" else window
        grids.append(visualise_path(pred, target, win))
    return np.stack(grids)


def build_visualizer(config, default_web_dir: str
                     ) -> Optional[RetrievalVisualizer]:
    """Instantiate from the config's ``visualizer`` section (the reference's
    plumbing: run/train_epic.py:26-34 builds utils.visualizer.<type> when
    ``type`` is non-empty; all shipped configs ship it disabled).  Accepts
    the reference's arg names: ``web_dir`` and ``num_samples`` map directly;
    ``exp_name``/``src_video_dir``/``vis_vid_freq`` are torch-run specific
    and ignored."""
    section = config.get("visualizer", {}) or {}
    if not section.get("type"):
        return None
    args = dict(section.get("args", {}) or {})
    web_dir = args.get("web_dir") or default_web_dir
    kwargs = {}
    if "num_samples" in args:
        kwargs["num_samples"] = int(args["num_samples"])
    if "top_k" in args:
        kwargs["top_k"] = int(args["top_k"])
    return RetrievalVisualizer(web_dir, **kwargs)
