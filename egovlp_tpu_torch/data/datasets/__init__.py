"""Dataset registry.

Counterpart of ``egovlp_tpu/data/datasets/__init__.py``, under the names
of the reference's loader factory so that configs carry over.  Ported so
far: EgoClip pretraining, EgoMCQ evaluation, the EPIC-Kitchens MIR,
CharadesEgo and Ego4D OSCC / PNR fine-tunes, and the Ego4D NLQ / MQ
feature extraction.  The legacy Frozen-in-Time datasets the JAX registry
names raise until they are ported (``ROADMAP.md``, Queue A, A11).
"""

from egovlp_tpu_torch.data.datasets.base import DatasetConfig, TextVideoDataset
from egovlp_tpu_torch.data.datasets.charades import CharadesEgoDataset
from egovlp_tpu_torch.data.datasets.egoclip import EgoClipDataset, EgoMCQDataset
from egovlp_tpu_torch.data.datasets.epic import EpicMIRDataset
from egovlp_tpu_torch.data.datasets.nlq_mq import Ego4DMQDataset, Ego4DNLQDataset
from egovlp_tpu_torch.data.datasets.oscc_pnr import (
    Ego4DOSCCDataset,
    Ego4DPNRDataset,
)

NOT_PORTED = frozenset({"WebVid", "ConceptualCaptions3M"})


def _egoclip_dispatch(cfg: DatasetConfig):
    """The reference's EgoClip_EgoMCQ switches on the split: train reads the
    EgoClip csv, val/test the EgoMCQ json."""
    cls = EgoClipDataset if cfg.split == "train" else EgoMCQDataset
    return cls(cfg)


def dataset_factory(name: str):
    registry = {
        "EgoClip": EgoClipDataset,
        "EgoClip_EgoMCQ": _egoclip_dispatch,
        "EgoMCQ": EgoMCQDataset,
        "MultiInstanceRetrieval": EpicMIRDataset,
        "EpicKitchens_MIR": EpicMIRDataset,
        "CharadesEgo": CharadesEgoDataset,
        "Ego4D_OSCC": Ego4DOSCCDataset,
        "Ego4D_PNR": Ego4DPNRDataset,
        "Ego4D_NLQ": Ego4DNLQDataset,
        "Ego4D_MQ": Ego4DMQDataset,
    }
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md, Queue A, A11)")
    if name not in registry:
        raise NotImplementedError(f"unknown dataset {name!r}")
    return registry[name]


__all__ = ["DatasetConfig", "TextVideoDataset", "EgoClipDataset",
           "EgoMCQDataset", "EpicMIRDataset", "CharadesEgoDataset",
           "Ego4DOSCCDataset", "Ego4DPNRDataset", "Ego4DNLQDataset",
           "Ego4DMQDataset", "dataset_factory"]
