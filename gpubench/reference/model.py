"""The plain reference of EgoVLP's dual encoder, in float32 PyTorch.

Written from the published model (showlab/EgoVLP ``model/video_transformer.py``
``SpaceTimeTransformer`` with divided space-time attention, Frozen in Time's
``VarAttention``; DistilBERT-base as HuggingFace ``transformers`` defines
it; EgoVLP's ``model/model.py`` projections), under the reference's
parameter names.  Functional: a dict of float32 tensors in, embeddings
out.  No kernel, no mixed precision, no cache.

* video: 16x16 patches by a strided convolution on channels-first
  frames; ``[CLS; frame-major patches]`` with the CLS token plus the first
  position, each patch plus its position and its frame's temporal
  embedding; each block ``t = x + timeattn(norm3(x))``, ``s =
  attn(norm1(t))``, ``r = x + s`` (the residual from the block's input, as
  EgoVLP's checkpoints have it), ``x = r + mlp(norm2(r))``; an attention's
  CLS query attends over every token, a patch query over [CLS; its patch
  column] (time) or [CLS; its frame] (space); exact GELU; LayerNorm eps
  1e-6; the final norm's CLS row through ``vid_proj.0``.
* text: DistilBERT, post-norm, learned positions, masked keys at the
  float32 minimum, LayerNorm eps 1e-12; the first token through ReLU and
  ``txt_proj.1``.

``quant='fp8'`` computes every linear layer as an fp8 matmul does
(``FP8Linear``: e4m3 operands forward, the output gradient in e5m2
backward, one scale a tensor) and rounds the patch convolution's operands
through e4m3: the lower-precision control.  ``recompute`` checkpoints
each video block, so that a float32 ViT-L step at 32 clips fits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

def dims(arch: dict, frames: int) -> dict:
    """The sizes the reference needs from a configuration's ``arch``."""
    a = arch.get("args", arch)
    vp, tp = a["video_params"], a["text_params"]
    return {"frames": frames, "img": int(vp["img_size"]),
            "patch": int(vp["patch_size"]), "dim": int(vp["embed_dim"]),
            "depth": int(vp["depth"]), "heads": int(vp["num_heads"]),
            "mlp": int(vp["embed_dim"] * vp.get("mlp_ratio", 4.0)),
            "vocab": int(tp["vocab_size"]), "tdim": int(tp["dim"]),
            "tlayers": int(tp["n_layers"]), "theads": int(tp["n_heads"]),
            "thidden": int(tp["hidden_dim"]),
            "positions": int(tp["max_position_embeddings"]),
            "proj": int(a["projection_dim"])}


def param_spec(d: dict) -> list:
    """``[(name, shape, init)]`` of every parameter, in a fixed order.
    ``init``: ``('fan_in', n)`` normal with std ``1/sqrt(n)``; ``('std',
    s)`` normal with std s; ``('one', s)`` 1 plus normal with std s."""
    D, T = d["dim"], d["tdim"]
    p = d["patch"]
    n = (d["img"] // p) ** 2
    spec = [("video_model.cls_token", (1, 1, D), ("std", 0.02)),
            ("video_model.pos_embed", (1, n + 1, D), ("std", 0.02)),
            ("video_model.temporal_embed", (1, d["frames"], D), ("std", 0.02)),
            ("video_model.patch_embed.proj.weight", (D, 3, p, p),
             ("fan_in", 3 * p * p)),
            ("video_model.patch_embed.proj.bias", (D,), ("std", 0.02))]

    def linear(name, out, inp):
        spec.extend([(f"{name}.weight", (out, inp), ("fan_in", inp)),
                     (f"{name}.bias", (out,), ("std", 0.02))])

    def norm(name, width):
        spec.extend([(f"{name}.weight", (width,), ("one", 0.02)),
                     (f"{name}.bias", (width,), ("std", 0.02))])

    for i in range(d["depth"]):
        b = f"video_model.blocks.{i}"
        for k in ("norm1", "norm2", "norm3"):
            norm(f"{b}.{k}", D)
        for a in ("timeattn", "attn"):
            linear(f"{b}.{a}.qkv", 3 * D, D)
            linear(f"{b}.{a}.proj", D, D)
        linear(f"{b}.mlp.fc1", d["mlp"], D)
        linear(f"{b}.mlp.fc2", D, d["mlp"])
    norm("video_model.norm", D)
    spec.extend([
        ("text_model.embeddings.word_embeddings.weight", (d["vocab"], T),
         ("std", 0.02)),
        ("text_model.embeddings.position_embeddings.weight",
         (d["positions"], T), ("std", 0.02))])
    norm("text_model.embeddings.LayerNorm", T)
    for i in range(d["tlayers"]):
        b = f"text_model.transformer.layer.{i}"
        for k in ("q_lin", "k_lin", "v_lin", "out_lin"):
            linear(f"{b}.attention.{k}", T, T)
        norm(f"{b}.sa_layer_norm", T)
        linear(f"{b}.ffn.lin1", d["thidden"], T)
        linear(f"{b}.ffn.lin2", T, d["thidden"])
        norm(f"{b}.output_layer_norm", T)
    linear("txt_proj.1", d["proj"], T)
    linear("vid_proj.0", d["proj"], D)
    return spec


def draw_weights(spec: list, generator: torch.Generator) -> dict:
    """Every parameter of ``spec`` from one normal draw on the generator's
    device, float32: a dict of views of that one buffer."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=generator, device=generator.device)
    out, at = {}, 0
    with torch.no_grad():
        for name, shape, (kind, v) in spec:
            size = math.prod(shape)
            t = flat[at:at + size].view(shape)
            at += size
            if kind == "fan_in":
                t.mul_(1.0 / math.sqrt(v))
            else:
                t.mul_(v)
                if kind == "one":
                    t.add_(1.0)
            out[name] = t
    return out


def fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded through a float8 type with one scale for the tensor
    (its largest magnitude at the type's largest value)."""
    top = torch.finfo(dtype).max
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class FP8Linear(torch.autograd.Function):
    """``x @ w.T + b`` as an fp8 matmul computes it: the forward's operands
    in e4m3, the output gradient in e5m2 for both backward products (the
    usual fp8 training recipe); accumulation in float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = fp8(x), fp8(w)
        ctx.save_for_backward(xq, wq)
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dq = fp8(dy, torch.float8_e5m2)
        dx = dq @ wq
        dw = dq.reshape(-1, dq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        return dx, dw, dy.reshape(-1, dy.shape[-1]).sum(0)


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through e4m3 in the forward; the gradient passes
    straight through (the patch convolution's operands)."""
    return t + (fp8(t.detach()) - t.detach())


class Reference:
    """The dual encoder over the parameter dict ``P`` (float32 tensors
    that may require grad)."""

    def __init__(self, d: dict, P: dict, quant: str = "none",
                 recompute: bool = True):
        if quant not in ("none", "fp8"):
            raise ValueError(f"quant={quant!r}")
        self.d, self.P, self.quant, self.recompute = d, P, quant, recompute

    def _q(self, t):
        return fake_fp8(t) if self.quant == "fp8" else t

    def linear(self, x, name):
        w, b = self.P[f"{name}.weight"], self.P[f"{name}.bias"]
        if self.quant == "fp8":
            return FP8Linear.apply(x, w, b)
        return F.linear(x, w, b)

    def norm(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], eps)

    # video tower ------------------------------------------------------
    def embed(self, video):
        """``[B, T, H, W, 3]`` normalised frames -> ``[B, 1 + T n, D]``."""
        B, T, H, W, C = video.shape
        P, p = self.P, self.d["patch"]
        x = video.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
        x = F.conv2d(self._q(x), self._q(P["video_model.patch_embed.proj.weight"]),
                     P["video_model.patch_embed.proj.bias"], stride=p)
        D = x.shape[1]
        n = x.shape[2] * x.shape[3]
        x = x.flatten(2).transpose(1, 2).reshape(B, T * n, D)
        pos = P["video_model.pos_embed"]
        x = x + pos[:, 1:].repeat(1, T, 1)
        x = x + P["video_model.temporal_embed"][:, :T].repeat_interleave(n, 1)
        cls = (P["video_model.cls_token"] + pos[:, :1]).expand(B, 1, D)
        return torch.cat([cls, x], dim=1)

    def var_attention(self, x, name, axis, T, n):
        B, S, D = x.shape
        H = self.d["heads"]
        hd = D // H
        qkv = self.linear(x, f"{name}.qkv").reshape(B, S, 3, H, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # [B, H, S, hd]
        q = q * hd ** -0.5
        cls_out = attend(q[:, :, :1], k, v)  # [B, H, 1, hd]

        def groups(t):  # patches -> [B, H, G, L, hd]
            t = t[:, :, 1:].reshape(B, H, T, n, hd)
            return t if axis == "space" else t.transpose(2, 3)

        qg, kg, vg = groups(q), groups(k), groups(v)
        G, L = qg.shape[2], qg.shape[3]
        kc = k[:, :, None, :1].expand(B, H, G, 1, hd)
        vc = v[:, :, None, :1].expand(B, H, G, 1, hd)
        out = attend(qg, torch.cat([kc, kg], 3), torch.cat([vc, vg], 3))
        if axis == "time":
            out = out.transpose(2, 3)
        out = out.reshape(B, H, T * n, hd)
        out = torch.cat([cls_out, out], dim=2).transpose(1, 2).reshape(B, S, D)
        return self.linear(out, f"{name}.proj")

    def block(self, x, i, T, n):
        b = f"video_model.blocks.{i}"
        t = x + self.var_attention(self.norm(x, f"{b}.norm3", 1e-6),
                                   f"{b}.timeattn", "time", T, n)
        s = self.var_attention(self.norm(t, f"{b}.norm1", 1e-6),
                               f"{b}.attn", "space", T, n)
        r = x + s
        h = self.norm(r, f"{b}.norm2", 1e-6)
        h = self.linear(F.gelu(self.linear(h, f"{b}.mlp.fc1")), f"{b}.mlp.fc2")
        return r + h

    def encode_video(self, video):
        T = video.shape[1]
        n = (video.shape[2] // self.d["patch"]) * (video.shape[3] // self.d["patch"])
        x = self.embed(video)
        for i in range(self.d["depth"]):
            if self.recompute and torch.is_grad_enabled():
                x = checkpoint(self.block, x, i, T, n, use_reentrant=False)
            else:
                x = self.block(x, i, T, n)
        cls = self.norm(x, "video_model.norm", 1e-6)[:, 0]
        return self.linear(cls, "vid_proj.0")

    # text tower -------------------------------------------------------
    def encode_text(self, ids, mask):
        P = self.P
        B, S = ids.shape
        H = self.d["theads"]
        pos = torch.arange(S, device=ids.device)
        x = (P["text_model.embeddings.word_embeddings.weight"][ids]
             + P["text_model.embeddings.position_embeddings.weight"][pos][None])
        x = self.norm(x, "text_model.embeddings.LayerNorm", 1e-12)
        keep = mask[:, None, None, :].bool()
        for i in range(self.d["tlayers"]):
            b = f"text_model.transformer.layer.{i}.attention"
            D = x.shape[-1]
            hd = D // H

            def heads(t):
                return t.reshape(B, S, H, hd).transpose(1, 2)

            q = heads(self.linear(x, f"{b}.q_lin")) / math.sqrt(hd)
            k = heads(self.linear(x, f"{b}.k_lin"))
            v = heads(self.linear(x, f"{b}.v_lin"))
            scores = (q @ k.transpose(-1, -2)).masked_fill(
                ~keep, torch.finfo(torch.float32).min)
            a = (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, S, D)
            a = self.linear(a, f"{b}.out_lin")
            layer = f"text_model.transformer.layer.{i}"
            x = self.norm(a + x, f"{layer}.sa_layer_norm", 1e-12)
            h = self.linear(F.gelu(self.linear(x, f"{layer}.ffn.lin1")),
                            f"{layer}.ffn.lin2")
            x = self.norm(h + x, f"{layer}.output_layer_norm", 1e-12)
        return self.linear(torch.relu(x[:, 0]), "txt_proj.1")


def attend(q, k, v):
    """Softmax attention of already scaled queries."""
    return (q @ k.transpose(-1, -2)).softmax(-1) @ v
