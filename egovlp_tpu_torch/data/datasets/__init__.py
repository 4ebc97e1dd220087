"""Dataset registry.

Counterpart of ``egovlp_tpu/data/datasets/__init__.py``, under the names
of the reference's loader factory so that configs carry over.  Ported so
far: EgoClip pretraining, EgoMCQ evaluation, and the EPIC-Kitchens MIR
and CharadesEgo fine-tunes.  The other datasets the JAX registry names
raise until they are ported (``ROADMAP.md``, Queue A, A11).
"""

from egovlp_tpu_torch.data.datasets.base import DatasetConfig, TextVideoDataset
from egovlp_tpu_torch.data.datasets.charades import CharadesEgoDataset
from egovlp_tpu_torch.data.datasets.egoclip import EgoClipDataset, EgoMCQDataset
from egovlp_tpu_torch.data.datasets.epic import EpicMIRDataset

NOT_PORTED = frozenset({
    "Ego4D_OSCC", "Ego4D_PNR", "Ego4D_NLQ", "Ego4D_MQ", "WebVid",
    "ConceptualCaptions3M",
})


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
    }
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md, Queue A, A11)")
    if name not in registry:
        raise NotImplementedError(f"unknown dataset {name!r}")
    return registry[name]


__all__ = ["DatasetConfig", "TextVideoDataset", "EgoClipDataset",
           "EgoMCQDataset", "EpicMIRDataset", "CharadesEgoDataset",
           "dataset_factory"]
