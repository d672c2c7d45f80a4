"""The plain reference of an AfMoE decoder (Trinity-Mini's published
architecture, ``model_type`` afmoe), a layer at a time:

* ``h = E[t] * sqrt(d)`` (``mup_enabled``);
* per layer, ``a = rmsnorm_in(h)``; q, k, v from ``a``, each head's q and k
  RMS-normed; on ``sliding_attention`` layers rotary position embedding
  (theta from the configuration, the two halves of each head) and the
  causal window ``q - k < sliding_window``, on ``full_attention`` layers
  no rotary and every earlier position; grouped KV heads; the heads'
  output times ``sigmoid(a @ W_gate)``, then ``W_o``;
  ``h = h + rmsnorm_post_attn(.)``;
* ``b = rmsnorm_pre_mlp(h)``; the first ``num_dense_layers`` layers a
  SwiGLU of ``intermediate_size``; the others
  ``s = sigmoid(b @ W_router)``, the ``num_experts_per_tok`` experts of
  ``s + bias`` selected, their weights ``route_scale * s_i / sum s`` over
  the selected, ``f = shared(b) + sum_i w_i SwiGLU_i(b)``, every expert
  computed for every token routed to it (no capacity) by a loop over all
  experts; ``h = h + rmsnorm_post_mlp(f)``;
* a final RMS norm and the unembedding.

Everything runs in float32 with TF32 off, on weights drawn again from the
seed (:class:`portbench.generate_afmoe.AfmoeWeights`), a layer's weights
at a time and queries in chunks.  ``precision="fp8"`` is the control:
every matrix product's two operands rounded to float8 e4m3 at a
per-tensor scale, the step below the configuration's bfloat16.  A
:class:`Model` built with ``follow`` takes another run's selected experts
and counts the rows where they differ from its own by more than a near
tie (:data:`TIE`; ``mismatches``); one built with ``record`` keeps its
own selections (``routes``).  Where the
published config is silent (the gate's placement, the four norms, no
rotary on the global layers, the embedding scale), this follows the
configuration file's ``assumed``; the vocabulary's padded columns, if any,
stay in the logits as the program keeps them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.generate import dtype_of
from portbench.generate_afmoe import AfmoeWeights, is_global
from portbench.reference.qwen3 import _fp8, exact_float32

#: query rows per attention chunk
Q_CHUNK = 1024
#: a near tie of the selection, in ``s + bias``: where a compared run chose
#: other experts than the reference, each expert it chose lies at most this
#: far below the reference's ``top_k``-th (see :meth:`Model.follow`).  A
#: bfloat16 run's flips lie ~0.002 below it at their median and ~0.01 at
#: their 99th percentile; a selection that leaves out the bias (spread
#: 0.01) lies farther below in many rows
TIE = 0.01


class Model:
    """One precision's arithmetic: ``mm`` is every matrix product."""

    def __init__(self, cfg: Dict[str, Any], precision: str = "float32",
                 follow: Optional[List[List[torch.Tensor]]] = None,
                 record: bool = False):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        # follow[p][j]: prompt p's experts ``(S, top_k)`` in the j-th MoE
        # layer, as another run selected them; record: keep this run's
        self.follow_ids, self.record = follow, record
        self.routes: List[List[torch.Tensor]] = []
        self.mismatches = 0
        self.moe_layer = 0
        self.fp8 = precision == "fp8"
        self.eps = float(cfg["rms_norm_eps"])
        self.hd = int(cfg["head_dim"])
        self.h = int(cfg["num_attention_heads"])
        self.kv = int(cfg["num_key_value_heads"])
        self.glob = is_global(cfg)

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

    def attention(self, a, w, i: int):
        """Layer ``i``'s attention of ``a`` ``(1, S, d)``, gate and ``W_o``
        included."""
        _, S, _ = a.shape
        pos = torch.arange(S, device=a.device)
        q = self.mm(a, w["attn.wq"]).view(S, self.h, self.hd)
        k = self.mm(a, w["attn.wk"]).view(S, self.kv, self.hd)
        v = self.mm(a, w["attn.wv"]).view(S, self.kv, self.hd)
        q = self.rmsnorm(q, w["attn.gamma_q"])
        k = self.rmsnorm(k, w["attn.gamma_k"])
        window = 0
        if not self.glob[i]:
            q, k = self.rope(q, pos), self.rope(k, pos)
            window = int(self.cfg["sliding_window"])
        rep = self.h // self.kv
        q = q.transpose(0, 1)                                  # (H, S, hd)
        k = k.transpose(0, 1).repeat_interleave(rep, 0)
        v = v.transpose(0, 1).repeat_interleave(rep, 0)
        outs = []
        for c0 in range(0, S, Q_CHUNK):
            c1 = min(S, c0 + Q_CHUNK)
            k0 = max(0, c0 - window + 1) if window else 0
            s = self.mm(q[:, c0:c1], k[:, k0:c1].transpose(-1, -2)) \
                / math.sqrt(self.hd)
            qpos = pos[c0:c1, None]
            kpos = pos[None, k0:c1]
            keep = kpos <= qpos
            if window:
                keep &= qpos - kpos < window
            s = s.masked_fill(~keep, float("-inf"))
            outs.append(self.mm(torch.softmax(s, -1), v[:, k0:c1]))
        o = torch.cat(outs, 1).transpose(0, 1).reshape(1, S, self.h * self.hd)
        o = o * torch.sigmoid(self.mm(a, w["attn.wgate"]))
        return self.mm(o, w["attn.wo"])

    def swiglu(self, x, wg, wu, wd):
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wu), wd)

    def moe(self, b, w):
        """The routed experts and the shared one over the rows of ``b``
        ``(N, d)``: every expert in turn over every token that selected
        it."""
        cfg = self.cfg
        s = torch.sigmoid(self.mm(b, w["moe.router"]))
        key = s + w["moe.expert_bias"]
        sel = torch.topk(key, int(cfg["num_experts_per_tok"]), dim=-1).indices
        if self.record:
            self.routes.append(sel)
        if self.follow_ids is not None:
            sel = self.follow(key, sel, torch.cat(
                [r[self.moe_layer] for r in self.follow_ids]).to(sel.device))
        self.moe_layer += 1
        ws = s.gather(1, sel)
        ws = float(cfg["route_scale"]) * ws / ws.sum(-1, keepdim=True)
        y = torch.zeros_like(b)
        for e in range(int(cfg["num_experts"])):
            tok, slot = (sel == e).nonzero(as_tuple=True)
            if tok.numel():
                out = self.swiglu(b[tok], w["moe.wg"][e], w["moe.wu"][e],
                                  w["moe.wd"][e])
                y.index_add_(0, tok, out * ws[tok, slot][:, None])
        return self.swiglu(b, w["moe.shared.wg"], w["moe.shared.wu"],
                           w["moe.shared.wd"]) + y

    def follow(self, key: torch.Tensor, own: torch.Tensor,
               theirs: torch.Tensor) -> torch.Tensor:
        """The compared run's experts of every row, the rows where they
        differ from this run's by more than a near tie (an expert of
        theirs more than :data:`TIE` below this run's ``top_k``-th ``s +
        bias``, or one chosen twice) counted in :attr:`mismatches`.  With
        random weights, top-k selections in bfloat16 and in float32 part on
        near ties in some token of most layers, and each such flip puts an
        unrelated expert's output in the token's sum: following every row
        keeps the compared logits a measure of the arithmetic, and the
        count a measure of the selection."""
        theirs = theirs.long()
        cut = key.gather(1, own).min(-1).values
        near = (key.gather(1, theirs).min(-1).values >= cut - TIE) & (
            theirs.sort(-1).values.diff(dim=-1) > 0).all(-1)
        self.mismatches += int((~near).sum())
        return theirs

    def mlp(self, b, w, i: int):
        if i < int(self.cfg["num_dense_layers"]):
            return self.swiglu(b, w["mlp.wg"], w["mlp.wu"], w["mlp.wd"])
        return self.moe(b, w)

    def layer(self, xs: List[torch.Tensor], w, i: int) -> List[torch.Tensor]:
        """Layer ``i`` over every prompt's ``(1, S, d)``; the feed-forward
        over all prompts' rows together (it is a function of each row)."""
        xs = [x + self.rmsnorm(self.attention(self.rmsnorm(x, w["ln1"]), w,
                                              i), w["ln1_post"]) for x in xs]
        rows = torch.cat([x[0] for x in xs])
        f = self.rmsnorm(self.mlp(self.rmsnorm(rows, w["ln2"]), w, i),
                         w["ln2_post"])
        out, at = [], 0
        for x in xs:
            S = x.shape[1]
            out.append(x + f[at:at + S][None])
            at += S
        return out


@torch.no_grad()
def final_hidden(cfg: Dict[str, Any], seed: int,
                 prompts: List[torch.Tensor], device: str,
                 precision: str = "float32",
                 weights: Optional[AfmoeWeights] = None,
                 model: Optional[Model] = None) -> List[torch.Tensor]:
    """Each prompt's final-normed hidden states ``(S, d)`` in float32, the
    model run a layer at a time over all prompts (on ``weights``, else on
    the seed's; by ``model``, else a plain :class:`Model` of
    ``precision``)."""
    W = weights or AfmoeWeights(cfg, seed, device, dtype_of(cfg))
    model = model or Model(cfg, precision)
    scale = math.sqrt(float(cfg["hidden_size"])) if cfg["mup_enabled"] else 1.0
    with exact_float32():
        table = W.embed()
        xs = [table[t.to(device).long()].float() * scale for t in prompts]
        del table
        for i in range(int(cfg["num_hidden_layers"])):
            w = {n: t.float() for n, t in W.layer(i).items()}
            xs = model.layer(xs, w, i)
            del w
        fn = W.final_norm().float()
        return [model.rmsnorm(x, fn)[0] for x in xs]


@torch.no_grad()
def logits(cfg: Dict[str, Any], seed: int, prompts: List[torch.Tensor],
           device: str, precision: str = "float32", last: int = 1,
           weights: Optional[AfmoeWeights] = None,
           model: Optional[Model] = None) -> List[torch.Tensor]:
    """Each prompt's logits at its ``last`` positions, ``(last,
    padded_vocab)`` in float32: the reference's, or with
    ``precision="fp8"`` the control's (``model``: as
    :func:`final_hidden`)."""
    W = weights or AfmoeWeights(cfg, seed, device, dtype_of(cfg))
    model = model or Model(cfg, precision)
    hs = final_hidden(cfg, seed, prompts, device, weights=W, model=model)
    wout = W.unembed().float()
    with exact_float32():
        return [model.mm(h[-last:], wout) for h in hs]


def last_logits(cfg: Dict[str, Any], seed: int, prompts: List[torch.Tensor],
                device: str, precision: str = "float32",
                model: Optional[Model] = None) -> List[torch.Tensor]:
    """Each prompt's logits at its last position, ``(padded_vocab,)``."""
    return [x[0] for x in logits(cfg, seed, prompts, device, precision,
                                 model=model)]


def split_routes(routes: List[torch.Tensor],
                 lengths: List[int]) -> List[List[torch.Tensor]]:
    """Experts recorded a MoE layer over all prompts' rows together
    (``Model.routes``), as each prompt's list over the MoE layers."""
    out, at = [], 0
    for S in lengths:
        out.append([r[at:at + S] for r in routes])
        at += S
    return out
