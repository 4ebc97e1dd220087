"""Evaluation metrics, numpy on the host, by the names configs use.

Counterpart of ``egovlp_tpu/metrics/__init__.py`` (:1-22).
"""

from egovlp_tpu_torch.metrics.charades import charades_map, charades_metrics
from egovlp_tpu_torch.metrics.egomcq import egomcq_accuracy_metrics
from egovlp_tpu_torch.metrics.map import calculate_mAP
from egovlp_tpu_torch.metrics.mir import mir_metrics
from egovlp_tpu_torch.metrics.ndcg import (
    calculate_DCG,
    calculate_IDCG,
    calculate_k_counts,
    calculate_nDCG,
)
from egovlp_tpu_torch.metrics.oscc_pnr import oscc_metrics, pnr_metrics
from egovlp_tpu_torch.metrics.retrieval import t2v_metrics, v2t_metrics

METRIC_REGISTRY = {
    "t2v_metrics": t2v_metrics,
    "v2t_metrics": v2t_metrics,
    "egomcq_accuracy_metrics": egomcq_accuracy_metrics,
    "charades_metrics": charades_metrics,
    "oscc_metrics": oscc_metrics,
    "pnr_metrics": pnr_metrics,
    "mir_metrics": mir_metrics,
}

__all__ = ["METRIC_REGISTRY", "calculate_DCG", "calculate_IDCG",
           "calculate_k_counts", "calculate_mAP", "calculate_nDCG",
           "charades_map", "charades_metrics", "egomcq_accuracy_metrics",
           "mir_metrics", "oscc_metrics", "pnr_metrics", "t2v_metrics",
           "v2t_metrics"]
