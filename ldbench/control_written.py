"""The precision control of a cell whose entry is `engine_written`: the
plain reference in float32, in the program's place, held to the float64
reference by that entry's check, both on the tiles a run would sample
(as ldbench/control.py does) and on the rows of the records a pass of
the program writes (one pass of the cell's engine, set up as a run
would).

    python3 -m ldbench.control_written --workload <cell> --seeds 1,2,3

prints one JSON line a seed with the numbers the control gives and the
limits they fail. The benchmark's own runs never run it.
"""

import argparse
import json
import shutil
import sys
import tempfile

from ldbench import check as chk
from ldbench import control
from ldbench.entries import engine as eng
from ldbench.run import ROOT, Run, load_cell, load_module, set_cache_dirs
from ldbench.tworead import read_records


def control_numbers(name: str, seed: int, device: str = "cuda", cell=None,
                    config=None) -> dict:
    """The check's numbers for the float32 control of one seed."""
    import torch
    if cell is None:
        cell, config = load_cell(name)
    entry = load_module("entries", cell["entry"])
    tmp = tempfile.mkdtemp(prefix="ldbench-", dir=tempfile.gettempdir())
    try:
        run = Run(name, cell, config, seed, 0, 0, device, tmp)
        state = entry.setup(run)
        entry.unit(run, state)
        recs = read_records(state["out"])
        entry.release(run, state)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stacked, tiles = state["stacked"], state["tiles"]
    pick = chk.sample_tiles(tiles, seed, cell["check"]["off_diagonal"],
                            cell["check"].get("diagonal", 0))
    want = eng.reference_tiles(run, stacked, pick, torch.float64)
    got = eng.reference_tiles(run, stacked, pick, torch.float32)
    sampled = chk.compare(control.records_from(got, stacked), stacked, want)
    sampled.pop("diffs")
    written = entry.written_numbers(run, recs, stacked, tiles,
                                    torch.float32)
    return dict(entry.merge(sampled, written), records=len(recs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ldbench.control_written")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    limits = load_cell(args.workload)[0]["limits"]
    for seed in map(int, args.seeds.split(",")):
        nums = control_numbers(args.workload, seed)
        fails = [k for k in limits if k in nums and nums[k] > limits[k]]
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              numbers=nums, fails=fails)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
