"""The plain reference of a training step: the train transform, the
losses, AdamW, and the first steps of a run followed leaf by leaf.

* ``step_seed``: the per-step seed of the training loop, a fixed function
  of (run seed, epoch, step); ``crop_boxes`` draws each clip's random
  resized crop box and flip from a generator seeded with it (area uniform
  in [0.5, 1] of the frame, aspect log-uniform in [3/4, 4/3], sides
  clamped into [8, side], placed uniformly; flip with probability 1/2).
* ``train_transform``: bilinear resampling of each box (align_corners
  False, coordinates clamped into the frame) by ``F.grid_sample``, the
  flip, the ImageNet normalisation.
* ``egonce``, ``max_margin``: EgoVLP's losses on the cosine similarity.
* ``AdamW``: optax's rule (bias-corrected moments, eps 1e-6 outside the
  square root, decoupled decay), float32 moments.

Nothing here imports the program: the reference works the boxes, the
similarity and the updates out again from the run's seed and inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.model import Reference

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
B1, B2, EPS = 0.9, 0.999, 1e-6


def step_seed(seed: int, epoch: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, epoch, index]).generate_state(1)[0])


def crop_boxes(generator: torch.Generator, clips: int, side: int):
    """``(top, left, h, w)`` float32 ``[clips, 4]`` and flips ``[clips]``."""
    u = torch.rand(clips, 5, generator=generator, device=generator.device)
    area = (0.5 + 0.5 * u[:, 0]) * side * side
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    r = torch.exp(lo + u[:, 1] * (hi - lo))
    w = torch.sqrt(area * r).clamp(8.0, float(side))
    h = torch.sqrt(area / r).clamp(8.0, float(side))
    return (torch.stack([u[:, 2] * (side - h), u[:, 3] * (side - w), h, w], 1),
            u[:, 4] < 0.5)


def train_transform(frames: torch.Tensor, boxes, flips, out: int):
    """uint8 ``[B, T, H, W, 3]`` -> normalised float32 ``[B, T, out, out,
    3]``, each clip's box resampled (one box for its frames), flipped
    where asked."""
    B, T, H, W, C = frames.shape
    x = frames.float().div(255.0).reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    top, left, h, w = boxes.to(x.device).unbind(1)
    i = torch.arange(out, dtype=torch.float32, device=x.device)

    def coords(start, length, size):  # pixel centre -> grid_sample's [-1, 1]
        c = start[:, None] + (i + 0.5) * (length[:, None] / out) - 0.5
        return (2 * c + 1) / size - 1

    gy, gx = coords(top, h, H), coords(left, w, W)
    gx = torch.where(flips.to(x.device)[:, None], gx.flip(1), gx)
    grid = torch.stack([gx[:, None, :].expand(B, out, out),
                        gy[:, :, None].expand(B, out, out)], -1)
    grid = grid.repeat_interleave(T, 0)
    y = F.grid_sample(x, grid, mode="bilinear", padding_mode="border",
                      align_corners=False)
    y = y.permute(0, 2, 3, 1).reshape(B, T, out, out, C)
    mean = torch.tensor(IMAGENET_MEAN, device=y.device)
    std = torch.tensor(IMAGENET_STD, device=y.device)
    return (y - mean) / std


def cosine(a, b, eps: float = 1e-8):
    a = a / a.norm(dim=1, keepdim=True).clamp_min(eps)
    b = b / b.norm(dim=1, keepdim=True).clamp_min(eps)
    return a @ b.T


def egonce(sim, verb, noun, temperature: float = 0.05):
    """EgoNCE: positives share a verb and a noun (cosine > 0 of both
    multi-hot vectors), plus the diagonal; both directions."""
    pos = (cosine(verb, verb) * cosine(noun, noun)
           + torch.eye(sim.shape[0], device=sim.device)) > 0
    s = sim / temperature

    def direction(x, m):
        return (torch.logsumexp(x.masked_fill(~m, -torch.inf), 1)
                - torch.logsumexp(x, 1)).mean()

    return -(direction(s, pos) + direction(s.T, pos.T))


def max_margin(sim, margin: float = 0.2):
    """Max-margin ranking, both directions, diagonal terms left out, mean
    over the 2 n (n - 1) off-diagonal pairs."""
    n = sim.shape[0]
    d = sim.diagonal()[:, None]
    off = 1.0 - torch.eye(n, device=sim.device)
    terms = torch.relu(margin - (d - sim)) + torch.relu(margin - (d - sim.T))
    return (terms * off).sum() / (2.0 * n * (n - 1))


def task_loss(task: dict, batch: dict, t, v):
    """The loss of ``task`` (the traffic's ``loss`` section) on the text
    and video embeddings of ``batch``'s rows."""
    sim = cosine(t, v)
    kind, args = task["type"], task.get("args", {})
    if kind == "EgoNCE":
        return egonce(sim, batch["verb_vec"].float(), batch["noun_vec"].float(),
                      float(args.get("temperature", 0.05)))
    if kind == "MaxMarginRankingLoss":
        return max_margin(sim, float(args.get("margin", 0.2)))
    raise ValueError(f"no reference loss {kind!r}")


class AdamW:
    """optax.adamw(lr, b1 0.9, b2 0.999, eps 1e-6, weight decay ``wd``)."""

    def __init__(self, params: dict, lr: float, wd: float = 0.0):
        self.params, self.lr, self.wd, self.count = params, lr, wd, 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            u = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + EPS)
            p.sub_(self.lr * (u + self.wd * p))


def rows(batch: dict, negatives: bool) -> dict:
    """The step's rows: with scene negatives, each key's negatives after
    its positives."""
    keys = ("frames", "text_ids", "text_mask", "noun_vec", "verb_vec")
    neg = {"frames": "frames_neg", "text_ids": "text_neg_ids",
           "text_mask": "text_neg_mask", "noun_vec": "noun_vec_neg",
           "verb_vec": "verb_vec_neg"}
    if not negatives:
        return {k: batch[k] for k in keys if k in batch}
    return {k: np.concatenate([batch[k], batch[neg[k]]]) for k in keys}


def follow(d: dict, weights: dict, batches: list, traffic: dict, seed: int,
           steps: list, device, quant: str = "none") -> dict:
    """Train the reference from ``weights`` over ``batches`` (host numpy
    dicts, one a step, ``batches[i]`` the loop's step ``steps[i]``, an
    ``(epoch, index)`` pair) as the program's loop does, and read: each step's loss, the text and
    video embeddings of step 1, every leaf's gradient norm at step 1, and
    every leaf's change after the last step.
    float32 throughout, TF32 off."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(d, weights, batches, traffic, seed, steps, device,
                       quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _follow(d, weights, batches, traffic, seed, steps, device, quant):
    P = {k: w.detach().clone().float().requires_grad_(True)
         for k, w in weights.items()}
    opt = AdamW(P, float(traffic["optimizer"]["lr"]),
                float(traffic["optimizer"].get("weight_decay", 0.0)))
    model = Reference(d, P, quant=quant)
    losses, grad_norms, embeddings = [], None, None
    for batch, (epoch, index) in zip(batches, steps):
        b = {k: torch.as_tensor(v).to(device)
             for k, v in rows(batch, traffic["negatives"]).items()}
        g = torch.Generator(device=device).manual_seed(
            step_seed(seed, epoch, index))
        boxes, flips = crop_boxes(g, b["frames"].shape[0], b["frames"].shape[2])
        video = train_transform(b["frames"], boxes, flips, traffic["input_res"])
        t = model.encode_text(b["text_ids"].long(), b["text_mask"])
        v = model.encode_video(video)
        loss = task_loss(traffic["loss"], b, t, v)
        grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
        losses.append(float(loss.detach()))
        if embeddings is None:
            embeddings = (t.detach().cpu(), v.detach().cpu())
        del t, v, video, loss
        if grad_norms is None:
            grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
        opt.step(grads)
        del grads
    change = {k: float((P[k].detach().double() - weights[k].double()).norm())
              for k in P}
    return {"losses": losses, "grad_norms": grad_norms, "change": change,
            "embeddings": embeddings}

