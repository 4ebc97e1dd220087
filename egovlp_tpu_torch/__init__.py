"""EgoVLP in PyTorch + CUDA for NVIDIA Hopper (H100).

The port of ``egovlp_tpu`` (the JAX/Pallas package, kept beside it as the
reference).  Module paths and class/function names mirror the JAX
package so each counterpart is easy to find.  This package imports torch
and numpy, never jax, flax or any module of the JAX package.

Covered so far: the embedding service (``serving.py``, ``cli/serve.py``)
and EgoClip pretraining with EgoMCQ validation on the full dual encoder:
``cli/train.py`` -> ``train/recipes.run_task`` -> the EgoClip / EgoMCQ
datasets (``data/datasets``) and the threaded ``data/pipeline.Loader`` ->
the EgoNCE step, AdamW with step-LR, the ``Trainer`` and torch-pickle
checkpoints; the EPIC-Kitchens MIR, CharadesEgo and Ego4D OSCC / PNR
fine-tunes the same way; ``cli/eval.py`` (EgoMCQ, EPIC, Charades, OSCC,
PNR) and ``cli/extract.py`` (Ego4D NLQ / MQ features).  One process
drives one GPU, under ``torch.distributed`` one process a GPU.
The divided space- and time-attention of every video block runs forward
and backward through hand-written CUDA kernels (``kernels/csrc``) on a
CUDA device and through their plain PyTorch twins on the CPU.
"""

__version__ = "0.2.0"
