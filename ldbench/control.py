"""The precision control of a cell: the plain reference computed in
float32, one step below the float64 that the tool's statistics are
stated in, put in the program's place and held to the float64 reference
by the comparison that decides `correct` (ldbench/check.py), on the
tiles a run would check.

    python3 -m ldbench.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed with the numbers the control gives. The
benchmark's own runs never run it; it sets the upper readings of the
limits in the cell files (PERF.md gives them).
"""

import argparse
import json
import sys

import numpy as np

from ldbench import check as chk
from ldbench.entries import engine as eng
from ldbench.run import ROOT, Run, load_cell, say, set_cache_dirs
from ldbench.tworead import RECORD


def records_from(refs: dict, stacked) -> np.ndarray:
    """The records a program would write for the kept pairs of `refs`
    (reference/ld.tile results by tile): each pair forward and reversed."""
    parts = []
    for (bi, bj, _diag), ref in refs.items():
        n_j = int(stacked["n_rec"][bj])
        rows, cols = ref["idx"] // n_j, ref["idx"] % n_j
        fwd = np.zeros(len(rows), RECORD)
        fwd["packA"] = stacked["pos"][bi][rows].astype(np.uint32) << 2
        fwd["packB"] = stacked["pos"][bj][cols].astype(np.uint32) << 2
        fwd["cnt"] = ref["cnt"]
        for f in ("D", "Dprime", "R", "R2", "P", "ChiSqFisher"):
            fwd[f] = ref[f]
        rev = fwd.copy()
        rev["packA"], rev["packB"] = fwd["packB"], fwd["packA"]
        parts += [fwd, rev]
    return np.concatenate(parts) if parts else np.zeros(0, RECORD)


def control_numbers(name: str, seed: int, device: str = "cuda", cell=None,
                    config=None) -> dict:
    """The comparison's numbers for the float32 control of one seed."""
    import torch
    if cell is None:
        cell, config = load_cell(name)
    run = Run(name, cell, config, seed, 0, 0, device, None)
    stacked, ids = eng.draw_planes(run)
    tiles = eng.tile_list(cell["layout"], ids)
    pick = chk.sample_tiles(tiles, seed, cell["check"]["off_diagonal"],
                            cell["check"].get("diagonal", 0))
    want = eng.reference_tiles(run, stacked, pick, torch.float64)
    got = eng.reference_tiles(run, stacked, pick, torch.float32)
    return chk.compare(records_from(got, stacked), stacked, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ldbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        say("the control runs on the card")
        return 3
    limits = load_cell(args.workload)[0]["limits"]
    for seed in map(int, args.seeds.split(",")):
        nums = control_numbers(args.workload, seed)
        fails = [k for k in nums if k in limits and nums[k] is not None
                 and nums[k] > limits[k]]
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              numbers=nums, fails=fails)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
