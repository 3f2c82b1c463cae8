"""Each cell at a size the CPU runs: the configuration's smoke sizes
(float32) and the cell's mix cut to two short prompts."""
from portbench.lib import spec


def small(name: str):
    cell = spec.cell(name)
    seq = 64 if cell.traffic["prompt_len"] >= 1024 else 32
    mix = dict(cell.traffic, batch=2, prompt_len=seq, distinct_batches=8)
    return cell, cell.config.smoke_dims(), mix


CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
