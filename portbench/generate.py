"""The one generator of the benchmark's inputs, made from ``--seed`` on the
run's device: the matrices a factorization cell solves, the token batches
a training cell trains on, the prompts a scoring cell sends, and the
weights of a model configuration.  Every size comes from the cell's data
files; a seed changes the numbers and the order, never the set of sizes
(a scoring mix's prompt lengths are its own, and the seed draws only the
token ids).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device: str) -> torch.Generator:
    """A generator on ``device`` for one named stream of ``seed``'s draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919) & _MASK)
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & _MASK, stream])


# ---------------------------------------------------------------------------
# factorizations
# ---------------------------------------------------------------------------
def spd_pool(n: int, count: int, seed: int, dtype: torch.dtype,
             device: str) -> List[torch.Tensor]:
    """``count`` symmetric positive definite matrices ``M M^T + n I``, ``M``
    standard normal, formed on ``device`` in float64 (eigenvalues in [n,
    ~5n]: condition numbers of at most about 5)."""
    g = generator(seed, 1, device)
    eye = torch.eye(n, dtype=torch.float64, device=device) * n
    out = []
    for _ in range(count):
        m = torch.randn(n, n, dtype=torch.float64, device=device, generator=g)
        out.append(torch.addmm(eye, m, m.T).to(dtype))
        del m
    return out


# ---------------------------------------------------------------------------
# token streams
# ---------------------------------------------------------------------------
def lm_batches(vocab: int, seq: int, batch: int, count: int, seed: int,
               device: str) -> torch.Tensor:
    """``count`` training batches as one int32 tensor ``(count, batch, seq +
    1)`` of token ids (inputs ``[..., :-1]``, labels ``[..., 1:]``): the
    program's synthetic stream, ``x_t = (x_0 a^(t mod 7) + 13 t) mod V``
    with ``a`` in {17, 31} and 5% of the positions redrawn uniformly, so
    every row differs and the loss can fall."""
    g = generator(seed, 2, device)
    shape = (count, batch, 1)
    x0 = torch.randint(0, vocab, shape, device=device, generator=g)
    mult = torch.where(torch.rand(shape, device=device, generator=g) < 0.5,
                       17, 31)
    t = torch.arange(seq + 1, device=device)
    toks = (x0 * mult.pow(t % 7) + 13 * t) % vocab
    noise = torch.rand(count, batch, seq + 1, device=device,
                       generator=g) < 0.05
    redraw = torch.randint(0, vocab, (count, batch, seq + 1), device=device,
                           generator=g)
    return torch.where(noise, redraw, toks).to(torch.int32)


def prompt_lengths(lengths: List[int], count: int,
                   length_seed: int) -> List[int]:
    """``count`` prompt lengths, each drawn independently and uniformly from
    ``lengths`` by the mix's own ``length_seed``: every run of the mix sends
    the same sizes in the same order, whatever its ``--seed``, which draws
    the token ids."""
    rng = host_rng(length_seed, 3)
    ls = sorted(int(x) for x in lengths)
    return [ls[i] for i in rng.integers(0, len(ls), size=count)]


def prompts(lengths: List[int], vocab: int, seed: int,
            device: str) -> List[torch.Tensor]:
    """One ``(1, S)`` int32 prompt of uniform token ids per length."""
    g = generator(seed, 4, device)
    total = sum(lengths)
    ids = torch.randint(0, vocab, (total,), device=device, generator=g,
                        dtype=torch.int64).to(torch.int32)
    out, at = [], 0
    for s in lengths:
        out.append(ids[at:at + s].view(1, s))
        at += s
    return out


# ---------------------------------------------------------------------------
# weights of a dense (qwen3-style) model
# ---------------------------------------------------------------------------
def dtype_of(cfg: Dict[str, Any]) -> torch.dtype:
    """The type a configuration's weights are served in."""
    return getattr(torch, cfg["torch_dtype"])


def dense_layer_shapes(cfg: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...],
                                                          int]]:
    """One decoder layer's leaves in the program's layout, ``(name, shape,
    fan_in)`` (fan-in 0: a norm scale, all ones)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv, f = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["intermediate_size"])
    return [("ln1", (d,), 0), ("attn.wq", (d, h * hd), d),
            ("attn.wk", (d, kv * hd), d), ("attn.wv", (d, kv * hd), d),
            ("attn.wo", (h * hd, d), h * hd), ("attn.gamma_q", (hd,), 0),
            ("attn.gamma_k", (hd,), 0), ("ln2", (d,), 0),
            ("mlp.wg", (d, f), d), ("mlp.wu", (d, f), d),
            ("mlp.wd", (f, d), f)]


def padded_vocab(vocab: int) -> int:
    """The vocabulary rounded up to a multiple of 256, as the program pads
    its tables (the padded rows and columns are drawn too)."""
    return -(-vocab // 256) * 256


def dense_leaf_names(cfg: Dict[str, Any]) -> List[str]:
    names = ["embed.table"]
    for i in range(cfg["num_hidden_layers"]):
        names += [f"blocks.{i}.{n}" for n, _, _ in dense_layer_shapes(cfg)]
    names += ["final_norm"]
    if not cfg.get("tie_word_embeddings", False):
        names += ["unembed.out"]
    return names


class DenseWeights:
    """A dense model's weights, drawn from ``seed`` on ``device`` in
    ``dtype``, one large draw per layer (and one per table): every matrix
    normal with standard deviation ``1 / sqrt(fan_in)``, every norm scale
    one.  Any layer can be drawn again alone, bit for bit, which the
    references use instead of the program's tensors."""

    def __init__(self, cfg: Dict[str, Any], seed: int, device: str,
                 dtype: torch.dtype):
        self.cfg, self.seed, self.device, self.dtype = cfg, seed, device, dtype
        self.vocab = padded_vocab(cfg["vocab_size"])

    def _draw(self, stream: int, numel: int) -> torch.Tensor:
        g = generator(self.seed, 100 + stream, self.device)
        return torch.randn(numel, dtype=self.dtype, device=self.device,
                           generator=g)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        shapes = dense_layer_shapes(self.cfg)
        mats = [(n, s, fan) for n, s, fan in shapes if fan]
        flat = self._draw(i, sum(math.prod(s) for _, s, _ in mats))
        out: Dict[str, torch.Tensor] = {}
        at = 0
        for n, s, fan in mats:
            k = math.prod(s)
            out[n] = flat[at:at + k].view(s).mul_(1.0 / math.sqrt(fan))
            at += k
        for n, s, fan in shapes:
            if not fan:
                out[n] = torch.ones(s, dtype=self.dtype, device=self.device)
        return out

    def embed(self) -> torch.Tensor:
        d = self.cfg["hidden_size"]
        # the table is gathered, not multiplied: unit-scale rows
        return self._draw(10_000, self.vocab * d).view(self.vocab, d)

    def unembed(self) -> torch.Tensor:
        d = self.cfg["hidden_size"]
        return self._draw(10_001, d * self.vocab).view(d, self.vocab).mul_(
            1.0 / math.sqrt(d))

    def final_norm(self) -> torch.Tensor:
        return torch.ones(self.cfg["hidden_size"], dtype=self.dtype,
                          device=self.device)

    def leaf(self, name: str) -> torch.Tensor:
        if name == "embed.table":
            return self.embed()
        if name == "unembed.out":
            return self.unembed()
        if name == "final_norm":
            return self.final_norm()
        _, i, rest = name.split(".", 2)
        return self.layer(int(i))[rest]
