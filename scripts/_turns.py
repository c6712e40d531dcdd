"""What the scripts that time trees of the port in turns share
(torch_smooth_turns.py, torch_probe_turns.py, torch_peer_turns.py,
torch_loop_turns.py): the cards' name and power limit, the turn loop (one
process a turn, so two trees' packages never meet in one process) and the
medians a tree.  Each script keeps its own cases, what a turn measures,
and the checks of its outputs across turns.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys


def card() -> list[str]:
    """Each card's name and power limit, a line each, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()


def take_turns(order: str, command, show, timeout: float | None = None
               ) -> list:
    """One turn a letter of `order` (a tree's name), each in a process of
    its own: `command(name)` is the turn's argv, and what it prints as the
    last line of its standard output, one JSON object, is its record.
    Prints `turn NAME: show(record)` after each turn; a turn that fails
    ends the script with the end of its errors.  Returns [(name, record)]
    in turn order."""
    turns = []
    for name in order:
        proc = subprocess.run(command(name), capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode:
            sys.exit(f"turn {name} failed:\n{proc.stderr[-4000:]}")
        record = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append((name, record))
        print(f"turn {name}: {show(record)}", flush=True)
    return turns


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def medians(records: list):
    """The records of one tree's turns folded into one of the same shape:
    a dict key by key, a number into the median over the turns, a list of
    numbers into the median of all the turns' entries, and anything else
    (a hash, a flag, a list of them) into the first turn's."""
    first = records[0]
    if isinstance(first, dict):
        return {k: medians([r[k] for r in records]) for k in first}
    if _number(first):
        return statistics.median(records)
    if isinstance(first, list) and first and all(map(_number, first)):
        return statistics.median([v for r in records for v in r])
    return first


def by_tree(turns: list) -> dict:
    """{tree: the medians of its turns' records} for each tree that took a
    turn, in the order of their first turns."""
    return {name: medians([r for n, r in turns if n == name])
            for name in dict.fromkeys(n for n, _ in turns)}
