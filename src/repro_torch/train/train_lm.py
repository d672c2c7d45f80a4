"""Training driver: an LM on the synthetic data pipeline with the whole
training stack — the fault-tolerant trainer, async checkpoints, microbatch
buckets joined one microbatch late, AdamW.

The port of the reference's ``examples/train_lm.py``, with its flags and
its two deepseek-family configurations (``--scale small``: 4 layers, d
256; ``--scale 100m``: 12 layers, d 768, vocab 32,768; both float32).
``--arch`` trains a published configuration instead, at full width in
its own dtype, ``--layers N`` cutting its depth; every family trains,
mamba2-2.7b at its full depth.  It runs on the CUDA device unless
``--device cpu`` is given; a rerun with the same ``--ckpt`` resumes from
the latest checkpoint there.

Run:  python -m repro_torch.train.train_lm --device cpu --steps 40
      python -m repro_torch.train.train_lm --scale 100m --steps 300
      python -m repro_torch.train.train_lm --arch qwen3-14b --layers 4 \\
          --batch 4 --seq 1024 --steps 8
      python -m repro_torch.train.train_lm --arch mamba2-2.7b \\
          --batch 4 --seq 1024 --steps 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from ..configs import get_config
from ..data import DataConfig
from ..optim import AdamWConfig
from .steps import StepConfig
from .trainer import Trainer, TrainerConfig


def build_cfg(scale: str):
    """The reference example's configurations (``examples/train_lm.py::
    build_cfg``)."""
    base = get_config("deepseek-67b")
    if scale == "100m":
        return base.reduced(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                            head_dim=64, d_ff=2048, vocab_size=32768,
                            dtype="float32")
    return base.reduced(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=512, vocab_size=4096,
                        dtype="float32")


def model_config(scale: str, arch: str = "", layers: int = 0):
    """``arch``'s published configuration (cut to ``layers`` when > 0), or
    the reference example's ``scale``."""
    if not arch:
        return build_cfg(scale)
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=("small", "100m"), default="small")
    ap.add_argument("--arch", default="",
                    help="a published configuration (e.g. qwen3-14b) in "
                         "place of --scale")
    ap.add_argument("--layers", type=int, default=0,
                    help="with --arch: cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="cpu to train on the host (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = model_config(args.scale, args.arch, args.layers)
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f} M params, "
          f"{cfg.n_layers} layers, {cfg.dtype})")
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        TrainerConfig(steps=args.steps, ckpt_every=max(20, args.steps // 4),
                      ckpt_dir=args.ckpt, log_every=10),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch, seed=0),
        step_cfg=StepConfig(microbatches=args.micro, overlap="hybrid"),
        device=args.device,
    )
    out = trainer.run()
    print(f"finished at step {out['final_step']} "
          f"(restored+resumed runs continue from checkpoints in {args.ckpt})")
    for m in out["metrics"]:
        print(f"  step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}  t={m['sec']:.0f}s")
    if out["metrics"]:
        first, last = out["metrics"][0]["loss"], out["metrics"][-1]["loss"]
        print(f"loss: {first:.3f} -> {last:.3f} "
              f"({'OK' if last < first else 'NOT LEARNING'})")
    return out


if __name__ == "__main__":
    main()
