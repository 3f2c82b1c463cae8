"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W limit) and the work functions of the port's kernels, counted from
shapes only.  Frozen here so that the yardstick cannot move with the
program.  ``bound``, ``nbytes``, ``flash_work`` and ``ssd_work`` follow the
arithmetic ``chip_smoke.py`` used for the port's kernel table."""
from __future__ import annotations

PEAK_BF16_FLOP_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4, "int64": 8}


def nbytes(*shapes_and_dtypes) -> int:
    """Bytes of tensors given as ``(shape, dtype name)``, each counted once."""
    total = 0
    for shape, dtype in shapes_and_dtypes:
        n = 1
        for s in shape:
            n *= int(s)
        total += n * BYTES[dtype]
    return total


def bound(n_bytes: float, flop: float) -> float:
    """Least seconds the card could take: the larger of the byte and the
    bf16 flop term."""
    return max(n_bytes / PEAK_BYTES_PER_S, flop / PEAK_BF16_FLOP_PER_S)


def kept_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a causal mask keeps, queries the suffix of the
    keys."""
    return sum(i + (sk - sq) + 1 for i in range(sq))


def flash_work(bh: int, sq: int, sk: int, d: int) -> float:
    """flop of causal attention: 4 d per kept pair (q.k and p.v)."""
    return 4.0 * d * bh * kept_pairs(sq, sk)


def ssd_work(b: int, h: int, s: int, p: int, n: int, chunk: int) -> float:
    """flop of the chunked scan: per chunk the causal half of C.B^T and of
    its product with dt.x, the inter-chunk term and the state update."""
    q = min(chunk, s)
    return float(b * h * (s // q)) * (q * (q + 1) * (n + p) + 4.0 * q * n * p)
