"""Trace emission for simulator runs (paper §4.1 uses Paraver).

Counterpart of ``repro.core.trace`` over the port's ``SimResult``: (a) a
Paraver-like ``.prv`` state-record text and (b) a compact ASCII Gantt
rendering for terminals.  Host code; the output strings are the
reference's for the same run.
"""
from __future__ import annotations

from repro_torch.core.simulator import Phase, SimResult

__all__ = ["to_prv", "ascii_gantt"]

# Paraver-ish numeric state encoding.
_STATE_CODE = {
    Phase.EXEC: 1,
    Phase.CKPT: 2,
    Phase.WAIT_ACTIVE: 3,
    Phase.WAIT_IDLE: 4,
    Phase.GO_SLEEP: 5,
    Phase.SLEEP: 6,
    Phase.WAKEUP: 7,
    Phase.DOWN: 8,
    Phase.RESTART: 9,
    Phase.REEXEC: 10,
}

_GLYPH = {
    Phase.EXEC: "=",
    Phase.CKPT: "#",
    Phase.WAIT_ACTIVE: "w",
    Phase.WAIT_IDLE: ".",
    Phase.GO_SLEEP: ">",
    Phase.SLEEP: "z",
    Phase.WAKEUP: "<",
    Phase.DOWN: "X",
    Phase.RESTART: "R",
    Phase.REEXEC: "r",
}


def to_prv(result: SimResult) -> str:
    """Serialize segments as Paraver-like state records:
    ``1:cpu:appl:task:thread:begin:end:state`` (times in microseconds)."""
    n_nodes = 1 + max(s.node for s in result.segments)
    horizon = max(s.t1 for s in result.segments)
    header = (
        f"#Paraver (repro:{result.config.name}):{int(horizon * 1e6)}_us:"
        f"1(1):{n_nodes}:{','.join('1' for _ in range(n_nodes))}\n"
    )
    lines = [header]
    for s in sorted(result.segments, key=lambda s: (s.node, s.t0)):
        lines.append(
            f"1:{s.node + 1}:1:{s.node + 1}:1:"
            f"{int(s.t0 * 1e6)}:{int(s.t1 * 1e6)}:{_STATE_CODE[s.phase]}\n"
        )
    return "".join(lines)


def ascii_gantt(result: SimResult, width: int = 100) -> str:
    """Render the run as one ASCII row per node.

    Legend: ``=`` exec  ``#`` ckpt  ``w`` active-wait  ``.`` idle-wait
    ``>z<`` go-sleep/sleep/wake  ``X`` down  ``R`` restart  ``r`` re-exec.
    """
    horizon = max(s.t1 for s in result.segments)
    nodes = sorted({s.node for s in result.segments})
    out = [f"{result.config.name}  (horizon {horizon / 60:.1f} min, "
           f"{'intervened' if result.intervene else 'reference'})"]
    for node in nodes:
        row = [" "] * width
        for s in result.node_segments(node):
            c0 = int(s.t0 / horizon * (width - 1))
            c1 = max(int(s.t1 / horizon * (width - 1)), c0 + 1)
            for c in range(c0, min(c1, width)):
                row[c] = _GLYPH[s.phase]
        label = "P0*" if node == 0 else f"P{node} "
        out.append(f"{label}|{''.join(row)}|")
    out.append("    legend: = exec  # ckpt  w wait(active)  . wait(idle)  "
               ">z< sleep  X down  R restart  r re-exec")
    return "\n".join(out)
