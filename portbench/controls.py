"""The controls of the benchmark's comparisons, and the training cells'
planted faults, read on the card at each cell's own size.

    python3 portbench/controls.py --workload <cell> --seeds 11 12 13

prints one JSON line per seed with the numbers the cell compares, read
from the control (the plain reference one precision below the
configuration's, put where the program's output would be) and, for a
training cell, from the reference with each fault planted: these are the
upper readings the cell's limits are set below (PERF.md).  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def factor_control(cell, seed: int, device: str) -> dict:
    import torch

    from portbench import generate
    from portbench.reference import cholesky as reference

    cfg, tr = cell.config, cell.traffic
    pool = generate.spd_pool(int(cfg["n"]), int(tr["pool"]), seed,
                             getattr(torch, cfg["dtype"]), device)
    worst = 0.0
    for a in pool[:int(tr["sample"])]:
        worst = max(worst, reference.factor_error(
            reference.control_factor(a), a))
    return {"factor_err": worst}


def train_control(cell, seed: int, device: str) -> dict:
    from portbench import generate
    from portbench.drivers import train
    from portbench.reference import qwen3

    cfg, tr = cell.config, cell.traffic
    first = int(tr["first_steps"])
    batches = generate.lm_batches(int(cfg["vocab_size"]), int(tr["seq"]),
                                  int(tr["global_batch"]), int(tr["batches"]),
                                  seed, device)[:first]

    def readings(**kw):
        return qwen3.train_readings(cfg, tr["optimizer"], batches, seed,
                                    device, steps=first, **kw)

    ref = readings()
    out = {"control": train.compare(readings(precision="fp8"), ref),
           "half_batch": train.compare(readings(fault="half_batch"), ref)}
    # a step that returns its state unchanged leaves every leaf's change
    # at 0 against the reference's: change_gap reads 1 by its definition
    out["frozen"] = {"change_gap": 1.0}
    return out


def score_control(cell, seed: int, device: str) -> dict:
    """The float8 reference's last-position logits in the program's place,
    through the driver's own comparison, on a sample of the mix's requests
    drawn as a run draws it (the longest among them), its greedy tokens
    served."""
    from portbench import generate
    from portbench.drivers import score
    from portbench.reference import qwen3

    cfg, tr = cell.config, cell.traffic
    lengths = generate.prompt_lengths(tr["lengths"], int(tr["prompts"]),
                                      int(tr["length_seed"]))
    pick = score.pick_sample(list(range(len(lengths))), dict(
        enumerate(lengths)), seed, int(tr["sample"]))
    prompts = generate.prompts(lengths, int(cfg["vocab_size"]), seed, device)
    sample = [prompts[i] for i in pick]
    ref = qwen3.last_logits(cfg, seed, sample, device)
    low = qwen3.last_logits(cfg, seed, sample, device, precision="fp8")
    return score.compare(low, ref, [int(x.argmax()) for x in low])


CONTROLS = {"factor": factor_control, "train": train_control,
            "score": score_control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.controls: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        out = CONTROLS[cell.driver](cell, seed, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
