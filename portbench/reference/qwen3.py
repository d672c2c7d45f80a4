"""The plain reference of a dense Qwen3 decoder (Qwen3-14B's published
architecture): token embedding; per layer ``x + attn(rmsnorm(x))`` and
``x + mlp(rmsnorm(x))``, attention with RMS-normed queries and keys per
head, rotary position embedding over the two halves of each head
(theta from the configuration), grouped KV heads and a causal softmax,
the MLP ``wd(silu(wg x) * wu x)``; a final RMS norm and the unembedding.
The loss is the token mean of the cross entropy over the published
vocabulary; AdamW with a clipped global norm follows the configuration's
optimizer.

Everything runs in float32 with TF32 off, on weights made again from the
seed (:class:`portbench.generate.DenseWeights`), in blocks (a layer's
weights at a time, queries in chunks) so that it fits beside nothing.
``precision="fp8"`` is the control: every matrix product's two operands
rounded to float8 e4m3 at a per-tensor scale, the step below the
configuration's bfloat16.  Departures from the program: none intended;
the vocabulary's padded columns (random, as the program draws them) are
left in the logits and out of the loss, as in the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import generate
from portbench.generate import dtype_of

#: query rows per attention chunk
Q_CHUNK = 1024
#: tokens per chunk of the loss's and the logits' products
V_CHUNK = 2048


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale, back in float32;
    its gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Model:
    """One precision's arithmetic: ``mm`` is every matrix product."""

    def __init__(self, cfg: Dict[str, Any], precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.fp8 = precision == "fp8"
        self.eps = float(cfg["rms_norm_eps"])
        self.hd = int(cfg["head_dim"])
        self.h = int(cfg["num_attention_heads"])
        self.kv = int(cfg["num_key_value_heads"])

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return a @ b

    def rmsnorm(self, x, scale):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                               + self.eps) * scale

    def rope(self, x, pos):
        half = self.hd // 2
        freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                        device=x.device)
                          * (math.log(float(self.cfg["rope_theta"])) / half))
        ang = pos[:, None].float() * freqs                    # (S, half)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attn_chunk(self, q, k, v, start: int):
        """Queries ``start ..`` of q ``(B, H, c, hd)`` over keys ``(B, H,
        S, hd)``, causal."""
        c, S = q.shape[2], k.shape[2]
        s = self.mm(q, k.transpose(-1, -2)) / math.sqrt(self.hd)
        qpos = torch.arange(start, start + c, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        return self.mm(torch.softmax(s, -1), v)

    def attention(self, x, w, pos):
        B, S, _ = x.shape
        q = self.mm(x, w["attn.wq"]).view(B, S, self.h, self.hd)
        k = self.mm(x, w["attn.wk"]).view(B, S, self.kv, self.hd)
        v = self.mm(x, w["attn.wv"]).view(B, S, self.kv, self.hd)
        q = self.rope(self.rmsnorm(q, w["attn.gamma_q"]), pos)
        k = self.rope(self.rmsnorm(k, w["attn.gamma_k"]), pos)
        rep = self.h // self.kv
        q = q.transpose(1, 2)
        k = k.transpose(1, 2).repeat_interleave(rep, 1)
        v = v.transpose(1, 2).repeat_interleave(rep, 1)
        outs = []
        for i in range(0, S, Q_CHUNK):
            args = (q[:, :, i:i + Q_CHUNK], k, v, i)
            outs.append(checkpoint(self._attn_chunk, *args,
                                   use_reentrant=False)
                        if torch.is_grad_enabled() else
                        self._attn_chunk(*args))
        o = torch.cat(outs, 2).transpose(1, 2).reshape(B, S, self.h * self.hd)
        return self.mm(o, w["attn.wo"])

    def block(self, x, w, pos):
        x = x + self.attention(self.rmsnorm(x, w["ln1"]), w, pos)
        h = self.rmsnorm(x, w["ln2"])
        return x + self.mm(F.silu(self.mm(h, w["mlp.wg"]))
                           * self.mm(h, w["mlp.wu"]), w["mlp.wd"])

    def _ce_chunk(self, h, wout, labels):
        logits = self.mm(h, wout)
        logits[:, int(self.cfg["vocab_size"]):] = float("-inf")
        return F.cross_entropy(logits, labels.long(), reduction="sum")

    def loss(self, p: Dict[str, torch.Tensor], tokens, labels):
        """Token-mean cross entropy of ``tokens`` ``(B, S)`` against
        ``labels`` over the published vocabulary."""
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)
        x = p["embed.table"][tokens.long()]
        for i in range(int(self.cfg["num_hidden_layers"])):
            w = {n.split(".", 2)[2]: t for n, t in p.items()
                 if n.startswith(f"blocks.{i}.")}
            x = checkpoint(self.block, x, w, pos, use_reentrant=False)
        h = self.rmsnorm(x, p["final_norm"]).reshape(B * S, -1)
        lab = labels.reshape(-1)
        total = 0.0
        for i in range(0, B * S, V_CHUNK):
            total = total + checkpoint(self._ce_chunk, h[i:i + V_CHUNK],
                                       p["unembed.out"], lab[i:i + V_CHUNK],
                                       use_reentrant=False)
        return total / (B * S)


def lr_at(opt: Dict[str, Any], step: int) -> float:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac``
    of it at ``total_steps``."""
    lr, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return lr * step / max(1.0, warm)
    prog = min(max((step - warm) / max(1.0, total - warm), 0.0), 1.0)
    frac = opt["min_lr_frac"]
    return lr * (frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * prog)))


def train_readings(cfg: Dict[str, Any], opt: Dict[str, Any],
                   batches: torch.Tensor, seed: int, device: str, *,
                   steps: int = 3, precision: str = "float32",
                   fault: Optional[str] = None) -> Dict[str, Any]:
    """Train the configuration from the seed's weights on ``batches``
    ``(steps, B, S + 1)`` with AdamW for ``steps`` steps (every product
    in float32; each update computed in float32 and stored in the
    configuration's type, ``torch_dtype``, as the weights are served and
    as the published AdamW-on-bfloat16 recipe stores them); return each
    step's loss, each leaf's first gradient as the optimizer takes it
    (after clipping) and each leaf's change over the steps, as norms.
    ``fault`` plants one of the faults a training cell can have in the
    reference put in the program's place: ``"half_batch"`` (the second
    half of every batch left out, the mean taken over the rest) or
    ``"frozen"`` (the step returns its state unchanged)."""
    W = generate.DenseWeights(cfg, seed, device, dtype_of(cfg))
    names = generate.dense_leaf_names(cfg)
    model = Model(cfg, precision)
    store = dtype_of(cfg)
    with exact_float32():
        p = {n: W.leaf(n).float().requires_grad_(True) for n in names}
        m = {n: torch.zeros_like(t) for n, t in p.items()}
        v = {n: torch.zeros_like(t) for n, t in p.items()}
        losses: List[float] = []
        grad1: Dict[str, float] = {}
        b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], \
            opt["weight_decay"]
        for s in range(1, steps + 1):
            batch = batches[s - 1].to(device)
            if fault == "half_batch":
                batch = batch[: batch.shape[0] // 2]
            loss = model.loss(p, batch[:, :-1], batch[:, 1:])
            grads = torch.autograd.grad(loss, [p[n] for n in names])
            losses.append(float(loss.detach()))
            g = dict(zip(names, grads))
            del grads, loss
            with torch.no_grad():
                gn = torch.sqrt(sum(t.square().sum() for t in g.values()))
                scale = torch.clamp(opt["clip_norm"] / gn.clamp_min(1e-12),
                                    max=1.0)
                for t in g.values():
                    t.mul_(scale)
                if s == 1:
                    grad1 = {n: float(t.norm()) for n, t in g.items()}
                if fault == "frozen":
                    continue
                lr = lr_at(opt, s)
                for n in names:
                    m[n].mul_(b1).add_((1 - b1) * g[n])
                    v[n].mul_(b2).add_((1 - b2) * g[n] * g[n])
                    delta = (m[n] / (1 - b1 ** s)) / (
                        torch.sqrt(v[n] / (1 - b2 ** s)) + eps)
                    # kept in the configuration's type, as served
                    p[n].copy_((p[n] - lr * (delta + wd * p[n]))
                               .to(store).float())
            del g
        del m, v
        with torch.no_grad():
            change = {n: float((p[n] - W.leaf(n).float()).norm())
                      for n in names}
    return {"loss": losses, "grad1": grad1, "change": change}


@torch.no_grad()
def final_hidden(cfg: Dict[str, Any], seed: int,
                 prompts: List[torch.Tensor], device: str,
                 precision: str = "float32") -> List[torch.Tensor]:
    """Each prompt's final-normed hidden states ``(S, d)`` in float32, the
    model run a layer at a time over all prompts."""
    W = generate.DenseWeights(cfg, seed, device, dtype_of(cfg))
    model = Model(cfg, precision)
    with exact_float32():
        table = W.embed()
        xs = [table[t.to(device).long()].float() for t in prompts]
        del table
        for i in range(int(cfg["num_hidden_layers"])):
            w = {n: t.float() for n, t in W.layer(i).items()}
            xs = [model.block(x, w, torch.arange(x.shape[1], device=device))
                  for x in xs]
            del w
        fn = W.final_norm().float()
        return [model.rmsnorm(x, fn)[0] for x in xs]


@torch.no_grad()
def last_logits(cfg: Dict[str, Any], seed: int, prompts: List[torch.Tensor],
                device: str, precision: str = "float32") -> List[torch.Tensor]:
    """Each prompt's logits at its last position, ``(padded_vocab,)`` in
    float32: the reference's, or with ``precision="fp8"`` the control's."""
    hs = final_hidden(cfg, seed, prompts, device, precision)
    W = generate.DenseWeights(cfg, seed, device, dtype_of(cfg))
    wout = W.unembed().float()
    model = Model(cfg, precision)
    with exact_float32():
        return [model.mm(h[-1:], wout)[0] for h in hs]
