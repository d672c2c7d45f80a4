"""The inputs of an AfMoE (Trinity) cell, made from ``--seed`` on the run's
device: the model's weights in the program's layout, one draw a layer
(:class:`AfmoeWeights`), and prompts whose token ids follow a Zipf law
(:func:`zipf_prompts`).  Every size comes from the configuration file's
published keys; the references draw the same weights again from the seed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from portbench.generate import generator, host_rng, padded_vocab

#: the spread of the experts' selection bias (a float32 checkpoint buffer):
#: about the gap between a token's 8th and 9th largest sigmoid score at
#: Trinity-Mini's widths, so the bias changes the selection of many tokens
BIAS_STD = 0.01


def is_global(cfg: Dict[str, Any]) -> List[bool]:
    """Which layers attend over every earlier position (no window, no
    rope): the published ``layer_types``."""
    return [t == "full_attention" for t in cfg["layer_types"]]


def layer_shapes(cfg: Dict[str, Any], i: int) -> List[Tuple[str, Tuple[int, ...],
                                                            int]]:
    """Layer ``i``'s leaves in the program's layout, ``(name, shape,
    fan_in)``: fan-in 0 is a norm scale (all ones), -1 the experts'
    selection bias (float32, :data:`BIAS_STD`)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    out = [("ln1", (d,), 0), ("ln1_post", (d,), 0), ("ln2", (d,), 0),
           ("ln2_post", (d,), 0), ("attn.wq", (d, h * hd), d),
           ("attn.wk", (d, kv * hd), d), ("attn.wv", (d, kv * hd), d),
           ("attn.wo", (h * hd, d), h * hd), ("attn.gamma_q", (hd,), 0),
           ("attn.gamma_k", (hd,), 0), ("attn.wgate", (d, h * hd), d)]
    if i < cfg["num_dense_layers"]:
        f = cfg["intermediate_size"]
        return out + [("mlp.wg", (d, f), d), ("mlp.wu", (d, f), d),
                      ("mlp.wd", (f, d), f)]
    e, fe = cfg["num_experts"], cfg["moe_intermediate_size"]
    fs = fe * cfg["num_shared_experts"]
    return out + [("moe.router", (d, e), d), ("moe.expert_bias", (e,), -1),
                  ("moe.wg", (e, d, fe), d), ("moe.wu", (e, d, fe), d),
                  ("moe.wd", (e, fe, d), fe), ("moe.shared.wg", (d, fs), d),
                  ("moe.shared.wu", (d, fs), d),
                  ("moe.shared.wd", (fs, d), fs)]


def leaf_names(cfg: Dict[str, Any]) -> List[str]:
    names = ["embed.table"]
    for i in range(cfg["num_hidden_layers"]):
        names += [f"blocks.{i}.{n}" for n, _, _ in layer_shapes(cfg, i)]
    names += ["final_norm"]
    if not cfg.get("tie_word_embeddings", False):
        names += ["unembed.out"]
    return names


class AfmoeWeights:
    """An AfMoE model's weights, drawn from ``seed`` on ``device`` in
    ``dtype``, one large draw a layer (and one a table): every matrix
    normal with standard deviation ``1 / sqrt(fan_in)`` (an expert's
    matrices at their own fan-in; both tables at ``1 / sqrt(d)``), every
    norm scale one, the selection
    bias normal at :data:`BIAS_STD` in float32.  Any layer can be drawn
    again alone, bit for bit."""

    def __init__(self, cfg: Dict[str, Any], seed: int, device: str,
                 dtype: torch.dtype):
        self.cfg, self.seed, self.device, self.dtype = cfg, seed, device, dtype
        self.vocab = padded_vocab(cfg["vocab_size"])

    def _draw(self, stream: int, numel: int, dtype=None) -> torch.Tensor:
        g = generator(self.seed, 200 + stream, self.device)
        return torch.randn(numel, dtype=dtype or self.dtype,
                           device=self.device, generator=g)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        shapes = layer_shapes(self.cfg, i)
        mats = [(n, s, fan) for n, s, fan in shapes if fan > 0]
        flat = self._draw(i, sum(math.prod(s) for _, s, _ in mats))
        out: Dict[str, torch.Tensor] = {}
        at = 0
        for n, s, fan in mats:
            k = math.prod(s)
            out[n] = flat[at:at + k].view(s).mul_(1.0 / math.sqrt(fan))
            at += k
        for n, s, fan in shapes:
            if fan == 0:
                out[n] = torch.ones(s, dtype=self.dtype, device=self.device)
            elif fan < 0:
                out[n] = self._draw(5_000 + i, math.prod(s),
                                    torch.float32).mul_(BIAS_STD)
        return out

    def embed(self) -> torch.Tensor:
        d = self.cfg["hidden_size"]
        # rows at 1 / sqrt(d): muP's sqrt(d) scale (``mup_enabled``) makes
        # them unit-RMS, as large as one layer's normed output, so the
        # layers and not the embedding make the final hidden state
        return self._draw(10_000, self.vocab * d).view(self.vocab, d).mul_(
            1.0 / math.sqrt(d))

    def unembed(self) -> torch.Tensor:
        d = self.cfg["hidden_size"]
        return self._draw(10_001, d * self.vocab).view(d, self.vocab).mul_(
            1.0 / math.sqrt(d))

    def final_norm(self) -> torch.Tensor:
        return torch.ones(self.cfg["hidden_size"], dtype=self.dtype,
                          device=self.device)


def zipf_prompts(lengths: List[int], vocab: int, exponent: float,
                 id_seed: int, seed: int, device: str) -> List[torch.Tensor]:
    """One ``(1, S)`` int32 prompt per length, each id drawn independently
    by a Zipf law over the ``vocab`` ids: rank ``r`` (from 1) has
    probability proportional to ``r ** -exponent``, and the mix's own
    ``id_seed`` fixes which id holds each rank, so frequent ids repeat as
    in text and every ``seed`` sees the same distribution; ``seed`` draws
    the ids."""
    perm = torch.from_numpy(host_rng(id_seed, 5).permutation(vocab)).to(
        device)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow(-float(exponent)), 0)
    cdf /= cdf[-1].clone()
    total = sum(lengths)
    u = torch.rand(total, dtype=torch.float64, device=device,
                   generator=generator(seed, 4, device))
    ids = perm[torch.searchsorted(cdf, u).clamp_max(vocab - 1)].to(
        torch.int32)
    out, at = [], 0
    for s in lengths:
        out.append(ids[at:at + s].view(1, s))
        at += s
    return out

