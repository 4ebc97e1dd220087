"""Generate the CharadesEgo per-action-segment training metadata.

The port's own copy of ``egovlp_tpu/tools/charades_meta.py``: each
video's ``actions`` column ("c092 11.9 21.2;...") becomes one training row
per action segment, narrated by its class sentence from
``Charades_v1_classes.txt`` (the ``cXXX `` prefix stripped).  Output: the
tab-separated ``metadata_{split}.csv`` (id, cls, t_start, t_end,
narration) that ``data/datasets/charades.py`` reads.

CLI:
    python -m egovlp_tpu_torch.tools.charades_meta --meta_dir DIR [--split train]
"""

from __future__ import annotations

import argparse
import csv
import os

SPLIT_FILES = {
    "train": "CharadesEgo_v1_train_only1st.csv",
    "val": "CharadesEgo_v1_test_only1st.csv",
    "test": "CharadesEgo_v1_test_only1st.csv",
}


def load_class_sentences(path: str) -> dict:
    """cls id -> narration sentence."""
    out = {}
    with open(path) as f:
        for line in csv.reader(f):
            out[int(line[0][1:4])] = line[0][5:]
    return out


def build_metadata(meta_dir: str, split: str = "train",
                   out_path: str | None = None) -> str:
    classes = load_class_sentences(
        os.path.join(meta_dir, "Charades_v1_classes.txt"))
    src = os.path.join(meta_dir, SPLIT_FILES[split])
    out_path = out_path or os.path.join(meta_dir, f"metadata_{split}.csv")

    rows = []
    with open(src) as f:
        for row in csv.DictReader(f):
            actions = row["actions"]
            if not actions:
                continue
            for action in actions.split(";"):
                cls_s, t_start, t_end = action.split(" ")
                cls = int(cls_s[1:])
                rows.append((row["id"], cls, float(t_start), float(t_end),
                             classes[cls]))

    with open(out_path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["id", "cls", "t_start", "t_end", "narration"])
        for r in rows:
            # dataset expects the 'cXXX' form in the cls column
            w.writerow([r[0], f"c{r[1]:03d}", r[2], r[3], r[4]])
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--meta_dir", required=True)
    ap.add_argument("--split", default="train", choices=list(SPLIT_FILES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    path = build_metadata(args.meta_dir, args.split, args.out)
    print("wrote", path)


if __name__ == "__main__":
    main()
