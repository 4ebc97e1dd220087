"""Dataset registry.

Counterpart of ``egovlp_tpu/data/datasets/__init__.py``, under the names
of the reference's loader factory so that configs carry over.  Ported so
far: EgoClip pretraining, EgoMCQ evaluation, the EPIC-Kitchens MIR,
CharadesEgo and Ego4D OSCC / PNR fine-tunes, the Ego4D NLQ / MQ feature
extraction, and the legacy Frozen-in-Time data, WebVid and CC3M: every
name of the JAX registry.
"""

from egovlp_tpu_torch.data.datasets.base import DatasetConfig, TextVideoDataset
from egovlp_tpu_torch.data.datasets.cc3m import ConceptualCaptionsDataset
from egovlp_tpu_torch.data.datasets.charades import CharadesEgoDataset
from egovlp_tpu_torch.data.datasets.egoclip import EgoClipDataset, EgoMCQDataset
from egovlp_tpu_torch.data.datasets.epic import EpicMIRDataset
from egovlp_tpu_torch.data.datasets.nlq_mq import Ego4DMQDataset, Ego4DNLQDataset
from egovlp_tpu_torch.data.datasets.oscc_pnr import (
    Ego4DOSCCDataset,
    Ego4DPNRDataset,
)
from egovlp_tpu_torch.data.datasets.webvid import WebVidDataset


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
        "WebVid": WebVidDataset,
        "ConceptualCaptions3M": ConceptualCaptionsDataset,
    }
    if name not in registry:
        raise NotImplementedError(f"unknown dataset {name!r}")
    return registry[name]


__all__ = ["DatasetConfig", "TextVideoDataset", "EgoClipDataset",
           "EgoMCQDataset", "EpicMIRDataset", "CharadesEgoDataset",
           "Ego4DOSCCDataset", "Ego4DPNRDataset", "Ego4DNLQDataset",
           "Ego4DMQDataset", "WebVidDataset", "ConceptualCaptionsDataset",
           "dataset_factory"]
