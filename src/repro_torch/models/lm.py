"""The LM: parameters, decode caches, prefill and one decode step.

The port of the reference's ``repro/models/lm.py`` for all six families.
The reference stacks its blocks along a leading ``layers`` axis and drives
them with ``lax.scan``; here :class:`LM` holds one block per layer in an
``nn.ModuleList`` and a Python loop drives them:

* ``dense``: :class:`~repro_torch.models.layers.Block` (attention and MLP);
  per-layer window and rope theta come from :func:`layer_flags`, so
  gemma3-style local/global stacks run too;
* ``moe``: the same block with the top-k
  :class:`~repro_torch.models.layers.MoE` in place of the MLP;
* ``encdec`` (seamless-m4t): ``enc_blocks``, an encoder of full
  (non-causal) self-attention with rope over the source positions and an
  MLP, no final norm, runs once over ``batch["enc_input"]`` ``(B, S_src,
  D)``; every decoder block cross-attends to its output after its
  self-attention;
* ``vlm`` (llama-3.2-vision): every block holds a gated cross-attention
  (``lnx``, ``xattn``, ``xgate``), which the layers whose
  ``layer_flags(cfg)["use_cross"]`` is set run over ``batch["patches"]``
  ``(B, n_patches, D)``, scaled by ``tanh(xgate)``;
* ``ssm`` (mamba2): :class:`SSMBlock`, ``x + ssm(ln1(x))``;
* ``hybrid`` (zamba2): SSM blocks plus one ``shared`` attention+MLP
  :class:`~repro_torch.models.layers.Block` (window 0, ``cfg.rope_theta``)
  that runs *before* the SSM block of every layer whose
  ``layer_flags(cfg)["use_attn"]`` is set, each such layer keeping its own
  K/V slot (``attn_slot``) in the cache.

Entry points:

* ``init_params(cfg, seed, device=None)``      -> :class:`LM`
* ``params_from_reference(cfg, tree, device)`` -> :class:`LM`
* ``abstract_params(cfg)``                     -> :class:`LM` on ``meta``
* ``forward(params, cfg, batch, ctx=None, remat=True)`` -> final hidden
* ``loss_fn(params, cfg, batch, ctx=None, remat=True)`` -> scalar CE loss
* ``zeros_cache(cfg, batch, max_len, device=None)`` -> decode cache
* ``prefill(params, cfg, batch, ctx=None, max_len=0)`` -> (cache, logits)
* ``PrefillGraphs(params, cfg)(tokens)`` -> (cache, logits), each prompt
  shape's prefill captured once as a CUDA graph and replayed
* ``decode_step(params, cfg, cache, tokens, ctx=None)`` -> (cache, logits)
* ``param_pspecs(cfg, ctx)`` / ``cache_pspecs(cfg, ctx)`` -> PartitionSpecs
* ``shard_params(model, ctx)`` / ``gather_params(local, ctx)``

With a mesh in ``ctx`` (a :class:`~repro_torch.sharding.ShardCtx` over a
``torch.distributed`` device mesh) every entry point is one rank's share
of the reference's SPMD program, as ``shard_map`` runs it: ``params`` is
the rank's :func:`shard_params` (heads, KV heads, ``ff``, vocabulary,
experts and SSM inner width on the model axis; ``embed`` dimensions on the
batch axes under FSDP), the batch is its rows, and the model issues its
collectives explicitly (:mod:`repro_torch.sharding.collectives`) where the
reference's ``shard_map`` does and where GSPMD puts them for it: the
vocab-sharded embedding and cross entropy, Megatron TP's all-reduces, the
MoE's expert-parallel sums or token gather, FSDP's per-block all-gathers,
and the sequence-sharded decode cache's log-sum-exp combine.  A mesh of one
rank runs the same path with no collective.

Every entry point that makes tensors defaults to the CUDA device and raises
when there is none; pass ``device="cpu"`` to run on the host.

The cross-attending families keep their memory (the encoder's output, or
the patches) in the decode cache as ``"memory"``; a decode step projects it
through each cross layer's ``wk``/``wv`` again, as the reference does.

Training and scoring (``forward``, ``loss_fn``) run all six families;
gradients flow once the parameters require grad
(``params.requires_grad_(True)``), through the SSD scan's and flash
attention's autograd Functions.  ``remat=True``, the reference's default,
checkpoints each layer with ``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint(nothing_saveable)``: its activations are recomputed in
the backward pass.  A hybrid's layer is the reference's unit: the shared
block (where the layer runs it) and the SSM block, checkpointed together.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..kernels import cuda_lib
from ..linalg.tiles import resolve_device
from ..sharding import collectives as C
from ..sharding.rules import (PartitionSpec, axes_of, local_shape,
                              local_slices, mesh_shape, params_pspecs)
from . import layers as L
from .config import ModelConfig
from .ssm import SSM, SSM_AXES, ssm_spec, ssm_state_spec

__all__ = ["CE_CHUNK", "LM", "PrefillGraphs", "SSMBlock", "abstract_params",
           "block_spec",
           "cache_pspecs", "cache_struct", "decode_step", "embed_lookup",
           "forward", "gather_leaves", "gather_params", "init_params", "layer_flags",
           "local_params", "logits_from_hidden", "loss_fn", "model_spec",
           "n_attn_slots", "padded_vocab", "param_pspecs",
           "params_from_reference", "prefill", "shard_params",
           "sharded_ce_loss", "spec_axes", "zeros_cache"]

#: tokens per chunk of the vocab-sharded cross entropy (bounds the float32
#: logit buffer), the reference's
CE_CHUNK = 2048

Device = Union[str, torch.device, None]

_SSM_FAMILIES = ("ssm", "hybrid")
#: the families whose decoder blocks cross-attend to a memory
_CROSS_FAMILIES = ("encdec", "vlm")


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256, as the reference pads it (the
    padded columns are real, random unembedding columns: greedy sampling
    over them can draw an id >= ``vocab_size``, as in the reference)."""
    return -(-cfg.vocab_size // 256) * 256


def _dense_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": (d,), "attn": L.attn_spec(cfg), "ln2": (d,),
            "mlp": L.mlp_spec(cfg)}


def block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter shapes of one layer's block: attention and MLP (dense), or
    MoE (moe; an MLP too where leading layers are dense, the union of both
    kinds of layer), plus ``lnx`` and ``xattn`` (encdec) and ``xgate``
    (vlm), and the post-sublayer norms with ``sandwich_norm``; or ``{ln1,
    ssm}`` (ssm, hybrid)."""
    fam, d = cfg.family, cfg.d_model
    if fam in _SSM_FAMILIES:
        return {"ln1": (d,), "ssm": ssm_spec(cfg)}
    s = {"ln1": (d,), "attn": L.attn_spec(cfg), "ln2": (d,)}
    if cfg.sandwich_norm:
        s["ln1_post"] = s["ln2_post"] = (d,)
    if fam == "moe":
        s["moe"] = L.moe_spec(cfg)
    if fam != "moe" or cfg.n_dense_layers:
        s["mlp"] = L.mlp_spec(cfg)
    if fam in _CROSS_FAMILIES:
        s["lnx"] = (d,)
        s["xattn"] = L.attn_spec(cfg)
    if fam == "vlm":
        s["xgate"] = (1,)
    return s


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter shapes by reference path (``blocks`` and ``enc_blocks``
    without the layer axis): the layout :func:`params_from_reference`
    reads.  A hybrid's ``shared`` block is one block, not stacked."""
    v, d = padded_vocab(cfg), cfg.d_model
    spec: Dict[str, Any] = {
        "embed": {"table": (v, d)},
        "final_norm": (d,),
        "blocks": block_spec(cfg),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = {"out": (d, v)}
    if cfg.family == "hybrid":
        spec["shared"] = _dense_block_spec(cfg)
    if cfg.family == "encdec":
        spec["enc_blocks"] = _dense_block_spec(cfg)
    return spec


def _dense_block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": ("embed",), "attn": L.attn_axes(cfg), "ln2": ("embed",),
            "mlp": L.mlp_axes(cfg)}


def _block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    fam = cfg.family
    if fam in _SSM_FAMILIES:
        return {"ln1": ("embed",), "ssm": dict(SSM_AXES)}
    s = {"ln1": ("embed",), "attn": L.attn_axes(cfg), "ln2": ("embed",)}
    if cfg.sandwich_norm:
        s["ln1_post"] = s["ln2_post"] = ("embed",)
    if fam == "moe":
        s["moe"] = L.moe_axes(cfg)
    if fam != "moe" or cfg.n_dense_layers:
        s["mlp"] = L.mlp_axes(cfg)
    if fam in _CROSS_FAMILIES:
        s["lnx"] = ("embed",)
        s["xattn"] = L.attn_axes(cfg)
    if fam == "vlm":
        s["xgate"] = (None,)
    return s


def _stack_axes(tree):
    if isinstance(tree, dict):
        return {k: _stack_axes(v) for k, v in tree.items()}
    return ("layers",) + tuple(tree)


def spec_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every leaf in the reference's layout (the
    reference's ``layers.spec_axes(model_spec(cfg))``): ``blocks`` and
    ``enc_blocks`` carry the leading ``layers`` axis."""
    out: Dict[str, Any] = {
        "embed": {"table": ("vocab", "embed")},
        "final_norm": ("embed",),
        "blocks": _stack_axes(_block_axes(cfg)),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = {"out": ("embed", "vocab")}
    if cfg.family == "hybrid":
        out["shared"] = _dense_block_axes(cfg)
    if cfg.family == "encdec":
        out["enc_blocks"] = _stack_axes(_dense_block_axes(cfg))
    return out


def param_pspecs(cfg: ModelConfig, ctx):
    """PartitionSpecs of every leaf in the reference's layout; equal to the
    reference's ``lm.param_pspecs``."""
    return params_pspecs(spec_axes(cfg), ctx)


@functools.lru_cache(maxsize=None)
def _param_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """``{port parameter name: logical axes}``, without the layer axis
    (``blocks.3.attn.wq`` -> ``("embed", "heads")``)."""
    tree = spec_axes(cfg)
    stacked = _stacked(cfg)
    out = {}
    for name, _ in LM(cfg, torch.device("meta")).named_parameters():
        parts = name.split(".")
        path = (parts[:1] + parts[2:]) if parts[0] in stacked else parts
        node = tree
        for k in path:
            node = node[k]
        out[name] = tuple(node[1:]) if parts[0] in stacked else tuple(node)
    return out


def _name_pspecs(cfg: ModelConfig, ctx) -> Dict[str, PartitionSpec]:
    """``{port parameter name: PartitionSpec}`` (no layer axis)."""
    r = ctx.rules()
    return {n: PartitionSpec(*[r.get(a) for a in axes])
            for n, axes in _param_axes(cfg).items()}


def _stacked(cfg: ModelConfig) -> Dict[str, int]:
    """The stacked parameter groups and their depths."""
    out = {"blocks": cfg.n_layers}
    if cfg.family == "encdec":
        out["enc_blocks"] = cfg.enc_layers
    return out


def n_attn_slots(cfg: ModelConfig) -> int:
    """K/V slots of the decode cache: one per layer, or for a hybrid one
    per layer that runs the shared attention block."""
    if cfg.family == "hybrid":
        return cfg.n_layers // max(1, cfg.attn_every)
    return cfg.n_layers


def layer_flags(cfg: ModelConfig) -> Dict[str, List]:
    """Per-layer flags, as host lists.

    * dense and moe: ``window`` (0 = full) and rope ``theta`` (0 = no
      rope); with ``local_global_ratio = r`` every ``(r+1)``-th layer is
      global (window 0, ``cfg.global_rope_theta``) and the rest local
      (``cfg.window``, ``cfg.rope_theta``);
    * hybrid: ``use_attn`` (layer ``l`` runs the shared block when ``l %
      attn_every == attn_every - 1``) and ``attn_slot``, the reference's
      ``max(cumsum(use_attn) - 1, 0)``: where ``use_attn``, the K/V slot the
      layer writes, the number of such layers before it;
    * vlm: also ``use_cross`` (layer ``l`` runs its cross-attention when
      ``l % cross_attn_every == cross_attn_every - 1``);
    * ssm: none."""
    n = cfg.n_layers
    if cfg.family in _SSM_FAMILIES:
        if cfg.family != "hybrid" or not cfg.attn_every:
            return {}
        use = [l % cfg.attn_every == cfg.attn_every - 1 for l in range(n)]
        slots, seen = [], 0
        for u in use:
            seen += u
            slots.append(max(seen - 1, 0))
        return {"use_attn": use, "attn_slot": slots}
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        is_global = [i % (r + 1) == r for i in range(n)]
        flags = {"window": [0 if g else cfg.window for g in is_global],
                 "theta": [cfg.global_rope_theta if g else cfg.rope_theta
                           for g in is_global]}
    else:
        flags = {"window": [cfg.window] * n, "theta": [cfg.rope_theta] * n}
    if cfg.family == "vlm" and cfg.cross_attn_every:
        c = cfg.cross_attn_every
        flags["use_cross"] = [i % c == c - 1 for i in range(n)]
    return flags


def _cross_layers(cfg: ModelConfig) -> List[bool]:
    """Which decoder layers cross-attend to the memory."""
    if cfg.family == "encdec":
        return [True] * cfg.n_layers
    return layer_flags(cfg).get("use_cross", [False] * cfg.n_layers)


class _Embed(nn.Module):
    def __init__(self, v: int, d: int, dtype, device):
        super().__init__()
        self.table = L._param((v, d), dtype, device)


class _Unembed(nn.Module):
    def __init__(self, d: int, v: int, dtype, device):
        super().__init__()
        self.out = L._param((d, v), dtype, device)


class SSMBlock(nn.Module):
    """One layer of the ssm and hybrid families: ``x + ssm(ln1(x))``."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L._param((cfg.d_model,), dtype, device)
        self.ssm = SSM(cfg, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, state=None, ctx=None):
        """Returns ``(x, new_state)``; see :meth:`SSM.forward`."""
        out, new_state = self.ssm(L.rmsnorm(x, self.ln1, self.cfg.norm_eps),
                                  state, ctx=ctx)
        return x + out, new_state


class LM(nn.Module):
    """The model: ``embed.table``, ``blocks`` (an ``nn.ModuleList`` of
    :class:`~repro_torch.models.layers.Block` for the dense, moe, encdec and
    vlm families, the first ``n_dense_layers`` of a moe stack with an MLP,
    of :class:`SSMBlock` for ssm and hybrid), ``final_norm``,
    ``unembed.out`` when embeddings are not tied, for a hybrid the
    ``shared`` attention+MLP :class:`~repro_torch.models.layers.Block` and
    for an encdec the encoder's ``enc_blocks``.  Parameters are made empty
    on ``device`` in ``cfg``'s dtype and filled by :func:`init_params` or
    :func:`params_from_reference`."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        fam = cfg.family
        dt = cfg.torch_dtype
        v, d = padded_vocab(cfg), cfg.d_model
        self.embed = _Embed(v, d, dt, device)
        if fam in _SSM_FAMILIES:
            self.blocks = nn.ModuleList(
                SSMBlock(cfg, dtype=dt, device=device)
                for _ in range(cfg.n_layers))
        else:
            self.blocks = nn.ModuleList(
                L.Block(cfg, dtype=dt, device=device,
                        moe=fam == "moe" and i >= cfg.n_dense_layers,
                        cross=fam in _CROSS_FAMILIES, gated=fam == "vlm")
                for i in range(cfg.n_layers))
        self.final_norm = L._param((d,), dt, device)
        if not cfg.tie_embeddings:
            self.unembed = _Unembed(d, v, dt, device)
        if fam == "hybrid":
            self.shared = L.Block(cfg, dtype=dt, device=device)
        if fam == "encdec":
            self.enc_blocks = nn.ModuleList(
                L.Block(cfg, dtype=dt, device=device)
                for _ in range(cfg.enc_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Device = None) -> LM:
    """A random :class:`LM` on ``device`` (CUDA by default), every leaf
    drawn on the device from ``torch.Generator(device).manual_seed(seed)``
    by the reference's truncated-normal fan-in rule
    (:func:`~repro_torch.models.layers.materialize_`).  The numbers differ
    from the reference's ``init_params(cfg, PRNGKey(seed))``: to compare
    the two on the same weights, convert the reference's with
    :func:`params_from_reference`."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L.materialize_(model, gen)
    return model


def abstract_params(cfg: ModelConfig) -> LM:
    """The :class:`LM`'s parameters as shapes and dtypes only: the model
    built on the ``meta`` device, which holds no storage (the reference's
    tree of ``ShapeDtypeStruct``)."""
    return LM(cfg, torch.device("meta"))


@torch.no_grad()
def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device: Device = None) -> LM:
    """The reference package's parameter pytree as an :class:`LM`.

    ``tree`` holds nested dicts of numpy arrays in the reference's layout:
    ``embed/table``, ``final_norm``, ``unembed/out`` (untied),
    ``blocks/...`` (and an encdec's ``enc_blocks/...``) with the leading
    ``layers`` axis stacked, and a hybrid's unstacked ``shared/...``; each
    layer's slice goes to ``blocks[i]`` (``enc_blocks[i]``) — the serving
    counterpart of ``linalg.tiles.from_numpy_tiles``."""
    model = LM(cfg, resolve_device(device))
    params = dict(model.named_parameters())
    stacked = _stacked(cfg)

    def put(name: str, x, where: str) -> None:
        p = params.pop(name)
        if tuple(x.shape) != tuple(p.shape):
            raise ValueError(f"{where}: shape {x.shape}, expected "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(x)).to(p.dtype))

    def leaves(spec, node, path):
        for key, sub in spec.items():
            if isinstance(sub, dict):
                yield from leaves(sub, node[key], path + (key,))
            else:
                yield path + (key,), np.asarray(node[key])

    for path, x in leaves(model_spec(cfg), tree, ()):
        where = "/".join(path)
        if path[0] in stacked:
            n = stacked[path[0]]
            if x.shape[:1] != (n,):
                raise ValueError(f"{where}: {x.shape[:1]} layers stacked, "
                                 f"expected {n}")
            for i in range(n):
                put(".".join((path[0], str(i)) + path[1:]), x[i],
                    f"{where}[{i}]")
        else:
            put(".".join(path), x, where)
    assert not params, f"no reference leaf for {sorted(params)}"
    return model


# ---------------------------------------------------------------------------
# shards of the parameters
# ---------------------------------------------------------------------------
def _set_param(model: nn.Module, name: str, t: torch.Tensor) -> None:
    mod, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(mod) if mod else model, leaf,
            nn.Parameter(t, requires_grad=False))


def local_params(cfg: ModelConfig, ctx, device: Device = None) -> LM:
    """An :class:`LM` of this rank's shard shapes (``param_pspecs`` over
    ``ctx``'s mesh), uninitialised, on ``device`` (CUDA by default; under
    ``FakeTensorMode`` its tensors are fake)."""
    dev = resolve_device(device)
    sizes = mesh_shape(ctx.mesh)
    pspecs = _name_pspecs(cfg, ctx)
    model = LM(cfg, torch.device("meta"))
    for name, p in list(model.named_parameters()):
        _set_param(model, name, torch.empty(
            local_shape(p.shape, pspecs[name], sizes), dtype=p.dtype,
            device=dev))
    return model


@torch.no_grad()
def shard_params(model: LM, ctx, copy: bool = True) -> LM:
    """This rank's :class:`LM`: every leaf of the whole ``model`` cut to
    its shard (``param_pspecs``).  With ``copy=False`` a shard that is a
    contiguous slice is a view of ``model``'s tensor (on a mesh of one
    rank, the tensor itself): no memory is taken twice."""
    pspecs = _name_pspecs(model.cfg, ctx)
    local = LM(model.cfg, torch.device("meta"))
    for name, p in model.named_parameters():
        t = p.detach()[local_slices(p.shape, pspecs[name], ctx.mesh)]
        t = (t.clone(memory_format=torch.contiguous_format) if copy
             else t.contiguous())
        _set_param(local, name, t)
    return local


@torch.no_grad()
def gather_leaves(cfg: ModelConfig, ctx,
                  leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every rank's shards of ``{parameter name: tensor}`` (parameters, or
    optimizer moments in their layout) gathered whole (collective: every
    rank calls it and gets every leaf whole)."""
    pspecs = _name_pspecs(cfg, ctx)
    out = {}
    for name, t in leaves.items():
        t = t.detach()
        for d, entry in enumerate(pspecs[name]):
            if entry is not None:
                t = C.all_gather(t, d, ctx.group(axes_of(entry)))
        out[name] = t.contiguous()
    return out


def gather_params(local: LM, ctx) -> LM:
    """The whole :class:`LM` from every rank's :func:`shard_params`
    (collective: every rank calls it and gets the whole model)."""
    full = LM(local.cfg, torch.device("meta"))
    for name, t in gather_leaves(local.cfg, ctx,
                                 dict(local.named_parameters())).items():
        _set_param(full, name, t)
    return full


class _Shard:
    """This rank's view of a model under ``ctx``: which leaves FSDP
    gathers (their ``embed`` dimension over the batch axes), and the
    blocks bound to their gathered leaves."""

    def __init__(self, cfg: ModelConfig, ctx):
        self.ctx = ctx
        self.bg = ctx.group(ctx.batch_axes)
        self.dims: Dict[str, Optional[int]] = {}
        for name, axes in _param_axes(cfg).items():
            # the token gather never gathers the experts' weights
            experts = ctx.moe_gather_tokens and name.endswith(
                (".moe.wg", ".moe.wu", ".moe.wd"))
            self.dims[name] = (axes.index("embed") if ctx.fsdp and not experts
                               and "embed" in axes else None)

    def param(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """``p`` whole over the batch axes (FSDP's per-use all-gather,
        reduce-scattered in the backward pass)."""
        dim = self.dims[name]
        return p if dim is None else C.all_gather(p, dim, self.bg)

    def bind(self, module: nn.Module, prefix: str) -> Callable:
        """``module`` as a function that gathers its FSDP leaves on every
        call (inside a checkpoint, again in the backward pass) and runs
        this rank's share of it."""
        def call(*args, **kw):
            leaves = {n: self.param(prefix + n, p)
                      for n, p in module.named_parameters()}
            return functional_call(module, leaves, args,
                                   dict(kw, ctx=self.ctx))
        return call


def _shard(cfg: ModelConfig, ctx) -> Optional[_Shard]:
    return _Shard(cfg, ctx) if L.sharded(ctx) else None


def _bound(sh: Optional[_Shard], module: nn.Module, prefix: str):
    return module if sh is None else sh.bind(module, prefix)


def _leaf(sh: Optional[_Shard], params: LM, name: str) -> torch.Tensor:
    p = params.get_parameter(name)
    return p if sh is None else sh.param(name, p)


def _unembedding(params: LM, cfg: ModelConfig,
                 sh: Optional[_Shard] = None) -> torch.Tensor:
    """``unembed.out``, or ``embed.table.T`` with tied embeddings (this
    rank's vocabulary columns, whole over the batch axes)."""
    if cfg.tie_embeddings:
        return _leaf(sh, params, "embed.table").T
    return _leaf(sh, params, "unembed.out")


def logits_from_hidden(params: LM, cfg: ModelConfig, h: torch.Tensor,
                       ctx=None) -> torch.Tensor:
    """``h @ unembed.out``, or ``h @ embed.table.T`` with tied embeddings;
    with a mesh, each rank's vocabulary columns gathered over the model
    axis (every rank returns all of its rows' logits)."""
    sh = _shard(cfg, ctx)
    logits = h @ _unembedding(params, cfg, sh)
    if sh is None:
        return logits
    return C.all_gather(logits, logits.dim() - 1, ctx.group(ctx.model_axis))


def _embed(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
           sh: Optional["_Shard"], ctx) -> torch.Tensor:
    """The tokens' embeddings, times ``sqrt(d_model)`` with
    ``cfg.embed_scale``."""
    x = embed_lookup(_leaf(sh, params, "embed.table"), tokens, ctx)
    return x * cfg.d_model ** 0.5 if cfg.embed_scale else x


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 ctx=None) -> torch.Tensor:
    """``table[ids]``; with a mesh, ``table`` is this rank's vocabulary
    rows: ids outside them give zeros, and the rows are added over the
    model axis (the reference's ``shard_map`` body)."""
    if not L.sharded(ctx):
        return table[ids]
    v_local = table.shape[0]
    local = ids - ctx.index(ctx.model_axis) * v_local
    ok = (local >= 0) & (local < v_local)
    # F.embedding's CUDA backward sums each row's gradients in a sorted
    # order: the same bits on every run (indexing's backward adds them
    # with atomics)
    rows = nn.functional.embedding(local.clamp(0, v_local - 1), table)
    rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
    return C.reduce_from(rows, ctx.group(ctx.model_axis))


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------
def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 n_patches: int = 0) -> Dict[str, Any]:
    """The decode cache's layout, the reference's, as ``(shape, dtype)``
    leaves and ``"index": int``:

    * ``"k"``, ``"v"`` (every family but ssm): ``(n_attn_slots, batch,
      max_len, n_kv_heads, head_dim)`` in the model's dtype;
    * ``"ssm"`` (ssm, hybrid): a dict of every layer's stacked state,
      ``"ssm"`` ``(n_layers, batch, H, N, P)`` float32 and ``"conv_x"``,
      ``"conv_b"``, ``"conv_c"`` ``(n_layers, batch, conv_width - 1, C)``
      in the model's dtype;
    * ``"memory"`` (encdec, vlm): ``(batch, M, d_model)`` in the model's
      dtype, ``M`` being ``n_patches`` (the memory's length: the patches,
      or the encoder's source positions), else ``cfg.n_patches``, at least
      1."""
    dt = cfg.torch_dtype
    out: Dict[str, Any] = {}
    if cfg.family != "ssm":
        kv = ((n_attn_slots(cfg), batch, max_len, cfg.n_kv_heads,
               cfg.head_dim), dt)
        out["k"] = kv
        out["v"] = kv
    if cfg.family in _SSM_FAMILIES:
        out["ssm"] = {name: ((cfg.n_layers,) + shape, sdt) for name, (shape, sdt)
                      in ssm_state_spec(cfg, batch, dt).items()}
    if cfg.family in _CROSS_FAMILIES:
        m = max(1, n_patches or cfg.n_patches)
        out["memory"] = ((batch, m, cfg.d_model), dt)
    out["index"] = int
    return out


def cache_pspecs(cfg: ModelConfig, ctx) -> Dict[str, Any]:
    """PartitionSpecs of the decode cache (the reference's, leaf for
    leaf): the batch on the batch axes; the KV heads on "model" when they
    divide it, else the cache's *sequence* on "model" (each rank attends
    its slice of the positions and the partials combine by their
    log-sum-exp); under ``seq_shard_cache`` the sequence on the batch axes
    too and the batch unsharded; the SSM state's heads and the conv
    state's inner width on "model"."""
    if ctx is None or ctx.mesh is None:
        def none(spec):
            if isinstance(spec, dict):
                return {k: none(v) for k, v in spec.items()}
            return None
        return none(cache_struct(cfg, 1, 1))
    m = ctx.model_axis
    seq = L.cache_seq_axes(cfg, ctx)
    kv_spec = PartitionSpec(None, None if ctx.seq_shard_cache
                            else ctx.batch_axes, seq or None,
                            None if m in seq else m, None)
    out: Dict[str, Any] = {}
    fam = cfg.family
    if fam != "ssm":
        out["k"] = kv_spec
        out["v"] = kv_spec
    if fam in _SSM_FAMILIES:
        b_ax = None if ctx.seq_shard_cache else ctx.batch_axes
        out["ssm"] = {
            "ssm": PartitionSpec(None, b_ax, m, None, None),
            "conv_x": PartitionSpec(None, b_ax, None, m),
            "conv_b": PartitionSpec(None, b_ax, None, None),
            "conv_c": PartitionSpec(None, b_ax, None, None),
        }
    if fam in _CROSS_FAMILIES:
        out["memory"] = PartitionSpec(
            None if ctx.seq_shard_cache else ctx.batch_axes, None, None)
    out["index"] = PartitionSpec()
    return out


def zeros_cache(cfg: ModelConfig, batch: int, max_len: int,
                device: Device = None, n_patches: int = 0,
                ctx=None) -> Dict[str, Any]:
    """An empty decode cache on ``device`` (CUDA by default).  ``index``,
    the fill, is a Python int kept on the host (the reference carries an
    int32 device scalar with the same values), so a decode step passes it
    to the attention kernel as a launch argument and never synchronises to
    read it.  An ssm cache has no K/V and no length limit.

    With a mesh in ``ctx``, ``batch`` and ``max_len`` are the whole
    cache's and each leaf is this rank's shard (:func:`cache_pspecs`);
    ``max_len`` is rounded up to a multiple of the ranks its sequence
    shards over."""
    dev = resolve_device(device)
    specs = cache_pspecs(cfg, ctx) if L.sharded(ctx) else None
    if specs is not None and "k" in specs:
        n = ctx.size(axes_of(specs["k"][2]))
        max_len = -(-max_len // n) * n
    sizes = mesh_shape(ctx.mesh) if specs is not None else None

    def make(spec, pspec):
        if isinstance(spec, dict):
            return {k: make(v, pspec[k] if pspec else None)
                    for k, v in spec.items()}
        if spec is int:
            return 0
        shape, dt = spec
        if pspec is not None:
            shape = local_shape(shape, pspec, sizes)
        return torch.zeros(shape, dtype=dt, device=dev)

    return make(cache_struct(cfg, batch, max_len, n_patches), specs)


def _put_prompt(dst: torch.Tensor, src: torch.Tensor, cfg: ModelConfig,
                ctx) -> None:
    """Write a prompt's K/V ``src`` ``(B, S, KV, hd)`` at positions ``[0,
    S)`` of one layer's cache ``dst``: with a mesh, the positions and KV
    heads of this rank's slice."""
    S = src.shape[1]
    if not L.sharded(ctx):
        dst[:, :S] = src
        return
    S_l, kv_c = dst.shape[1], dst.shape[2]
    if src.shape[2] != kv_c:
        src = src.narrow(2, ctx.index(ctx.model_axis) * kv_c, kv_c)
    start = ctx.index(L.cache_seq_axes(cfg, ctx)) * S_l
    hi = min(start + S_l, S)
    if hi > start:
        dst[:, :hi - start] = src[:, start:hi]


def _rope_by_theta(cfg: ModelConfig, flags, positions: torch.Tensor):
    """One ``(cos, sin)`` pair per distinct theta, shared by its layers;
    None for theta 0 (no rope)."""
    return {th: L.rope_tables(positions, th, cfg.head_dim) if th else None
            for th in dict.fromkeys(flags["theta"])}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------
def _ssm_layer(x: torch.Tensor, *, ssm: Callable, shared, rope_cs,
               state=None, kv_cache=None, cache_index: Optional[int] = None):
    """One layer of the ssm and hybrid families (the reference's
    ``forward`` body): the ``shared`` block first where it is given (over
    ``kv_cache`` at ``cache_index`` when decoding), then ``x +
    ssm(ln1(x))`` from ``state`` (None: a fresh state).  Returns ``(x,
    (the shared block's K/V or None, the SSM's new state))``; the caller
    decides what goes into a cache."""
    kv = None
    if shared is not None:
        x, kv = shared(x, window=0, rope_cs=rope_cs, cache=kv_cache,
                       cache_index=cache_index)
    x, new = ssm(x, state)
    return x, (kv, new)


def _ssm_layers(params: LM, cfg: ModelConfig, x: torch.Tensor,
                cache: Dict[str, Any], positions: torch.Tensor,
                decode: bool, ctx=None) -> torch.Tensor:
    """The layer loop of the ssm and hybrid families, writing the cache in
    place: each layer's SSM state (prefill: the state after the prompt;
    decode: the state after this token) and, for the layers that run the
    shared block, that block's K/V in the layer's slot (prefill: positions
    ``[:S]``; decode: position ``index``)."""
    sh = _shard(cfg, ctx)
    flags = layer_flags(cfg)
    use_attn = flags.get("use_attn", [False] * cfg.n_layers)
    tables = (L.rope_tables(positions, cfg.rope_theta, cfg.head_dim)
              if any(use_attn) else None)
    shared = _bound(sh, params.shared, "shared.") if any(use_attn) else None
    states = cache["ssm"]
    for i, blk in enumerate(params.blocks):
        slot = flags["attn_slot"][i] if use_attn[i] else None
        kv_cache = ({"k": cache["k"][slot], "v": cache["v"][slot]}
                    if use_attn[i] and decode else None)
        st = {name: t[i] for name, t in states.items()} if decode else None
        x, (kv, new) = _ssm_layer(
            x, ssm=_bound(sh, blk, f"blocks.{i}."),
            shared=shared if use_attn[i] else None,
            rope_cs=tables, state=st, kv_cache=kv_cache,
            cache_index=cache["index"] if decode else None)
        if use_attn[i] and not decode:
            _put_prompt(cache["k"][slot], kv["k"], cfg, ctx)
            _put_prompt(cache["v"][slot], kv["v"], cfg, ctx)
        for name, t in states.items():
            t[i] = new[name]
    return x


def _block_out(blk: Callable, x: torch.Tensor, **kw) -> torch.Tensor:
    """One block's output without the K/V it also returns."""
    return blk(x, **kw)[0]


def _run_layers(layers: Sequence[Callable], x: torch.Tensor, remat: bool,
                group: int = 1) -> torch.Tensor:
    """``x`` through each of ``layers`` (functions of x, returning
    ``(output, extra)``); with ``remat`` while grad is on, under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``): only each layer's input is kept, and its
    forward runs again in the backward pass.  ``group > 1`` (dividing the
    layer count) checkpoints every ``group`` layers as one, the
    reference's two-level remat: fewer inputs kept, ``group`` layers run
    again per backward step."""
    if not (remat and torch.is_grad_enabled()):
        for f in layers:
            x = _block_out(f, x)
        return x
    if group <= 1 or len(layers) % group:
        group = 1

    def run(x, fs):
        for f in fs:
            x = _block_out(f, x)
        return x

    for j in range(0, len(layers), group):
        x = checkpoint(run, x, layers[j:j + group], use_reentrant=False)
    return x


def _remat_group(ctx) -> int:
    return ctx.remat_group if L.sharded(ctx) else 1


def _encode(params: LM, cfg: ModelConfig, enc_input: torch.Tensor, *,
            remat: bool = True, ctx=None) -> torch.Tensor:
    """The encoder (the reference's ``lm._encode``): every ``enc_blocks``
    layer over ``enc_input`` ``(B, S_src, D)``, full (non-causal)
    self-attention with rope at ``cfg.rope_theta`` over the source
    positions, then the MLP; no final norm.  ``remat`` checkpoints each
    layer when grad is on."""
    sh = _shard(cfg, ctx)
    positions = torch.arange(enc_input.shape[1],
                             device=enc_input.device)[None, :]
    tables = L.rope_tables(positions, cfg.rope_theta, cfg.head_dim)
    layers = [functools.partial(_bound(sh, blk, f"enc_blocks.{i}."),
                                window=0, rope_cs=tables, causal=False)
              for i, blk in enumerate(params.enc_blocks)]
    return _run_layers(layers, enc_input, remat, _remat_group(ctx))


def _memory(params: LM, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: bool = True, ctx=None):
    """The memory the decoder cross-attends to, in the model's dtype: the
    encoder's output over ``batch["enc_input"]`` (encdec) or
    ``batch["patches"]`` (vlm); None for the other families."""
    key = {"encdec": "enc_input", "vlm": "patches"}.get(cfg.family)
    if key is None:
        return None
    if key not in batch:
        raise ValueError(f"family {cfg.family!r} needs batch[{key!r}] "
                         f"(B, S, d_model)")
    src = torch.as_tensor(batch[key], device=params.device,
                          dtype=cfg.torch_dtype)
    if key == "enc_input":
        return _encode(params, cfg, src, remat=remat, ctx=ctx)
    return src


def _final_norm(params: LM, cfg: ModelConfig, x: torch.Tensor,
                sh: Optional[_Shard]) -> torch.Tensor:
    return L.rmsnorm(x, _leaf(sh, params, "final_norm"), cfg.norm_eps)


# ---------------------------------------------------------------------------
# forward / loss (training and scoring)
# ---------------------------------------------------------------------------
def forward(params: LM, cfg: ModelConfig, batch: Dict[str, Any], ctx=None,
            *, remat: bool = True) -> torch.Tensor:
    """The final hidden states ``(B, S, d_model)`` of ``batch["tokens"]``
    ``(B, S)`` (plus an encdec's ``"enc_input"`` or a vlm's ``"patches"``),
    after the final norm: the reference's ``lm.forward``.  Runs under
    whatever grad mode the caller set; ``remat`` checkpoints each layer
    (and encoder layer) when grad is on (every ``ctx.remat_group`` layers
    with a mesh).  The ssm and hybrid families keep no cache: each layer's
    SSM state is dropped (prefill and decode keep theirs through
    ``_ssm_layers``).

    With a mesh in ``ctx``, ``params`` is this rank's
    :func:`shard_params` and ``batch`` its rows; every block gathers its
    FSDP leaves on entry and runs its heads, experts and inner width."""
    sh = _shard(cfg, ctx)
    dev = params.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    Sq = tokens.shape[1]
    x = _embed(params, cfg, tokens, sh, ctx)
    positions = torch.arange(Sq, device=dev)[None, :]
    flags = layer_flags(cfg)
    if cfg.family in _SSM_FAMILIES:
        use_attn = flags.get("use_attn", [False] * cfg.n_layers)
        tables = (L.rope_tables(positions, cfg.rope_theta, cfg.head_dim)
                  if any(use_attn) else None)
        shared = (_bound(sh, params.shared, "shared.") if any(use_attn)
                  else None)
        layers = [functools.partial(
            _ssm_layer, ssm=_bound(sh, blk, f"blocks.{i}."),
            shared=shared if use_attn[i] else None, rope_cs=tables)
            for i, blk in enumerate(params.blocks)]
    else:
        tables = _rope_by_theta(cfg, flags, positions)
        memory = _memory(params, cfg, batch, remat=remat, ctx=ctx)
        cross = _cross_layers(cfg)
        layers = [functools.partial(
            _bound(sh, blk, f"blocks.{i}."), window=flags["window"][i],
            rope_cs=tables[flags["theta"][i]],
            memory=memory if cross[i] else None)
            for i, blk in enumerate(params.blocks)]
    x = _run_layers(layers, x, remat, _remat_group(ctx))
    return _final_norm(params, cfg, x, sh)


def _ce_chunk(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              start: int, v_real: int, group) -> torch.Tensor:
    """The summed loss of one chunk of tokens over this rank's vocabulary
    columns ``[start, start + w.shape[1])``: the max taken outside
    autograd, the exponentials' sum and the picked logit added over the
    model axis; padded columns at -1e30, labels < 0 adding 0."""
    logits = (h @ w).float()
    gidx = start + torch.arange(w.shape[1], device=h.device)
    logits = torch.where(gidx < v_real, logits,
                         torch.full_like(logits, -1e30))
    lmax = C.all_reduce_max(logits.max(dim=-1).values, group)
    z = torch.exp(logits - lmax[:, None])
    lse = torch.log(C.reduce_from(z.sum(dim=-1), group)) + lmax
    onloc = labels[:, None] == gidx
    picked = C.reduce_from(torch.where(onloc, logits,
                                       torch.zeros_like(logits)).sum(-1),
                           group)
    return torch.where(labels >= 0, lse - picked,
                       torch.zeros_like(lse)).sum()


def sharded_ce_loss(h: torch.Tensor, wout: torch.Tensor,
                    labels: torch.Tensor, cfg: ModelConfig,
                    ctx=None) -> torch.Tensor:
    """Token-mean cross entropy of the logits ``h @ wout``, in float32:
    the padded vocabulary's columns are masked, and labels < 0 are masked
    out of the mean.

    Without a mesh, the reference's ``ctx=None`` form: the whole logit
    matrix, padded columns at -inf.  With one, ``wout`` is this rank's
    vocabulary columns (whole over the batch axes) and ``h``/``labels``
    its rows: :data:`CE_CHUNK` tokens at a time, each chunk under a
    checkpoint (its logits recomputed in the backward pass), the chunks'
    sums and token counts added over the batch axes."""
    if not L.sharded(ctx):
        logits = (h @ wout).float()
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -torch.inf)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
        mask = labels >= 0
        loss = torch.where(mask, lse - picked, torch.zeros_like(lse))
        return loss.sum() / mask.sum().clamp_min(1)
    g = ctx.group(ctx.model_axis)
    start = ctx.index(ctx.model_axis) * wout.shape[1]
    D = h.shape[-1]
    hf = C.copy_to(h.reshape(-1, D), g)
    lf = labels.reshape(-1)
    T = hf.shape[0]
    tc = min(CE_CHUNK, T)
    num = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, tc):
        args = (hf[i:i + tc], wout, lf[i:i + tc], start, cfg.vocab_size, g)
        num = num + (checkpoint(_ce_chunk, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _ce_chunk(*args))
    cnt = (lf >= 0).sum().float()
    bg = ctx.group(ctx.batch_axes)
    num = C.reduce_from(num, bg)
    cnt = C.reduce_from(cnt, bg)
    return num / cnt.clamp_min(1)


def loss_fn(params: LM, cfg: ModelConfig, batch: Dict[str, Any], ctx=None,
            *, remat: bool = True) -> torch.Tensor:
    """The scalar float32 loss of ``batch`` (``"tokens"``, ``"labels"``
    ``(B, S)``, labels < 0 masked): :func:`forward` then
    :func:`sharded_ce_loss` through ``unembed.out`` (or the tied
    embedding's transpose).  With a mesh, every rank returns the mean over
    all ranks' tokens; each rank's gradients are those of its own rows'
    share, which the train step adds over the batch axes."""
    h = forward(params, cfg, batch, ctx, remat=remat)
    labels = torch.as_tensor(batch["labels"], device=h.device)
    return sharded_ce_loss(h, _unembedding(params, cfg, _shard(cfg, ctx)),
                           labels, cfg, ctx)


def _whole_batch(cfg: ModelConfig, ctx, b_local: int) -> int:
    """The whole cache's batch for this rank's ``b_local`` rows: times the
    batch axes' ranks unless the cache's batch is unsharded
    (``seq_shard_cache``)."""
    if not L.sharded(ctx) or ctx.seq_shard_cache:
        return b_local
    return b_local * ctx.dp_size


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, batch: Dict[str, Any], ctx=None,
            max_len: int = 0):
    """Run the prompt ``batch["tokens"]`` ``(B, S)`` (a tensor or numpy
    array of ids) through the model; returns ``(cache, logits)`` with the
    cache filled to ``S`` of ``max_len`` (default ``S + 1``) positions and
    the last position's logits ``(B, 1, padded_vocab)``.  An encdec batch
    also holds ``"enc_input"`` ``(B, S_src, D)``, which the encoder runs
    over first, a vlm batch ``"patches"`` ``(B, n_patches, D)``; either
    memory is kept in the cache as ``"memory"``.

    With a mesh in ``ctx``: ``params`` and ``batch`` are this rank's (its
    rows; all rows under ``seq_shard_cache``), the cache is this rank's
    shard (:func:`cache_pspecs`) and the logits are its rows' over the
    whole vocabulary."""
    sh = _shard(cfg, ctx)
    dev = params.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, Sq = tokens.shape
    max_len = max_len or Sq + 1
    memory = _memory(params, cfg, batch, ctx=ctx)
    n_patches = memory.shape[1] if memory is not None else 0
    cache = zeros_cache(cfg, _whole_batch(cfg, ctx, B), max_len, device=dev,
                        n_patches=n_patches, ctx=ctx)
    if memory is not None:
        cache["memory"].copy_(memory)
    x = _embed(params, cfg, tokens, sh, ctx)
    positions = torch.arange(Sq, device=dev)[None, :]
    if cfg.family in _SSM_FAMILIES:
        x = _ssm_layers(params, cfg, x, cache, positions, decode=False,
                        ctx=ctx)
    else:
        flags = layer_flags(cfg)
        tables = _rope_by_theta(cfg, flags, positions)
        cross = _cross_layers(cfg)
        for i, blk in enumerate(params.blocks):
            x, kv = _bound(sh, blk, f"blocks.{i}.")(
                x, window=flags["window"][i],
                rope_cs=tables[flags["theta"][i]],
                memory=memory if cross[i] else None)
            _put_prompt(cache["k"][i], kv["k"], cfg, ctx)
            _put_prompt(cache["v"][i], kv["v"], cfg, ctx)
    cache["index"] = Sq
    h = _final_norm(params, cfg, x[:, -1:], sh)
    return cache, logits_from_hidden(params, cfg, h, ctx)


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: _clone_tree(v) for k, v in items}
        return out if isinstance(tree, dict) else tuple(out.values())
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (dict, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _tensors(v)


class PrefillGraphs:
    """:func:`prefill` of a plain token batch, each prompt shape captured
    once as a CUDA graph and replayed after.

    A long prompt's prefill is thousands of kernel launches (a MoE layer's
    is ~160), so a host that enqueues them slower than the card runs them
    paces the prefill and jitters it; a replay enqueues the whole prefill
    at once.  The first call of a shape runs :func:`prefill` eagerly on the
    capture stream (it builds the kernels, the library handles and their
    workspaces) and then captures it; later calls copy the tokens into the
    graph's input, replay, and return a cache and logits cloned out of the
    graph's outputs, so a later replay leaves what the caller holds as it
    was.  All graphs capture into one memory pool and each keeps its
    outputs for as long as it lives: a capture reuses only the earlier
    captures' intermediates, so the graphs replay in any order, one at a
    time.

    The prefill must read nothing back to the host (a transformer's does
    not, the dropless MoE's included).  Calls run :func:`prefill` eagerly
    on a model off CUDA and inside a traced call
    (:func:`repro_torch.obs.spans.current`), whose per-layer spans a
    replay would not record."""

    def __init__(self, params: LM, cfg: ModelConfig):
        self.params, self.cfg = params, cfg
        self._graphs: Dict[Any, tuple] = {}
        self._pool = None

    def __call__(self, tokens, max_len: int = 0):
        from ..obs import spans

        tokens = torch.as_tensor(tokens, device=self.params.device)
        if tokens.device.type != "cuda" or spans.current() is not None:
            return prefill(self.params, self.cfg, {"tokens": tokens},
                           max_len=max_len)
        key = (tuple(tokens.shape), tokens.dtype, max_len)
        g = self._graphs.get(key)
        if g is None:
            out, self._graphs[key] = self._capture(tokens, max_len)
            return out
        graph, static, outs, tally = g
        static.copy_(tokens)
        graph.replay()
        cuda_lib.add_launches(tally)
        return _clone_tree(outs)

    def _capture(self, tokens: torch.Tensor, max_len: int):
        from ..compile.capture import capture_stream

        stream = capture_stream(tokens.device)
        main = torch.cuda.current_stream()
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = prefill(self.params, self.cfg, {"tokens": tokens},
                          max_len=max_len)
            static = tokens.clone()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with cuda_lib.capturing_launches() as tally:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    outs = prefill(self.params, self.cfg,
                                   {"tokens": static}, max_len=max_len)
                finally:
                    graph.capture_end()
        main.wait_stream(stream)
        for t in _tensors(out):         # made on the capture stream
            t.record_stream(main)
        return out, (graph, static, outs, dict(tally))


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, ctx=None):
    """One decode step for ``tokens`` ``(B, 1)``; returns ``(cache,
    logits)`` with logits ``(B, 1, padded_vocab)``.

    Unlike the reference, which returns new arrays, the step writes the
    cache *in place*: this token's K/V into ``cache["k"]``/``cache["v"]``
    and every layer's new SSM and conv states into ``cache["ssm"]``; the
    returned cache is a new dict over the same tensors with ``index + 1``.
    An encdec or vlm step cross-attends to the cache's ``"memory"``.
    A cache with K/V holds ``max_len`` positions and raises when full; an
    ssm cache is a fixed-size state and never fills.  With a mesh in
    ``ctx`` the cache is this rank's shard from :func:`prefill` (the rank
    whose slice holds the position writes the token's K/V)."""
    sh = _shard(cfg, ctx)
    dev = params.device
    idx = cache["index"]
    if "k" in cache:
        cap = cache["k"].shape[2]
        if sh is not None:
            cap *= ctx.size(L.cache_seq_axes(cfg, ctx))
        if idx >= cap:
            raise ValueError(f"the cache is full ({idx} positions)")
    x = _embed(params, cfg, tokens, sh, ctx)
    positions = torch.full((1, 1), idx, dtype=torch.int64, device=dev)
    if cfg.family in _SSM_FAMILIES:
        x = _ssm_layers(params, cfg, x, cache, positions, decode=True,
                        ctx=ctx)
    else:
        flags = layer_flags(cfg)
        tables = _rope_by_theta(cfg, flags, positions)
        cross = _cross_layers(cfg)
        memory = cache.get("memory")
        ck, cv = cache["k"], cache["v"]
        for i, blk in enumerate(params.blocks):
            x, _ = _bound(sh, blk, f"blocks.{i}.")(
                x, window=flags["window"][i],
                rope_cs=tables[flags["theta"][i]],
                cache={"k": ck[i], "v": cv[i]}, cache_index=idx,
                memory=memory if cross[i] else None)
    new_cache = dict(cache)
    new_cache["index"] = idx + 1
    h = _final_norm(params, cfg, x, sh)
    return new_cache, logits_from_hidden(params, cfg, h, ctx)
