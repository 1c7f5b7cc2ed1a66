"""The readings that set the check's limits, on the card at a cell's size.

``python3 -m knnbench.control --workload <cell> --seeds 1,2,3 --seconds 3
[--systems program,reference-tf32,reference-bf16,program-bf16]``

For each system and seed: a run of the cell as ``run.py`` makes it, with a
short window, and one JSON line of the numbers compared. ``program`` is the
system under test (the lower reading). ``reference-tf32`` and
``reference-bf16`` are the plain reference with its operands rounded to
TF32 or bfloat16 and its sums in float64, put in the program's place: the
precisions below the configurations' float32. ``program-bf16`` is the
program's own bfloat16 form, which only its ``predict`` entry has. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from knnbench import manifest, reference, run


def reference_at(operands: str):
    """The reference with ``operands``-rounded features in the program's
    place."""
    def make(cell: manifest.Cell, inputs: dict, device: str):
        k, entry = cell.traffic["k"], cell.traffic["entry"]

        def call(ds):
            d, i = reference.neighbors(inputs["train_x"],
                                       np.asarray(ds.features), k, device,
                                       operands=operands)
            if entry == "kneighbors":
                return d.astype(np.float32), i.astype(np.int32)
            return reference.vote(inputs["train_y"][i].astype(np.int64),
                                  cell.config["classes"]).astype(np.int32)

        return call, lambda: None
    return make


def program_bf16(cell: manifest.Cell, inputs: dict, device: str):
    """The program's own bfloat16 form (``predict`` only)."""
    if cell.traffic["entry"] != "predict":
        raise ValueError("only the program's predict has a precision option")
    traffic = {**cell.traffic, "precision": "bf16"}
    return run.program(dataclasses.replace(cell, traffic=traffic), inputs,
                       device)


SYSTEMS = {"program": run.program, "reference-tf32": reference_at("tf32"),
           "reference-bf16": reference_at("bf16"),
           "program-bf16": program_bf16}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="knnbench.control",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, each a run of every system")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--systems", default="program,reference-tf32")
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("knnbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    for system in args.systems.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            result = run.run_cell(cell, seed, args.seconds, False,
                                  make_system=SYSTEMS[system])
            print(json.dumps({"workload": cell.name, "system": system,
                              "seed": seed, "correct": result["correct"],
                              "metrics": result["metrics"],
                              "checks": result["checks"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
