"""Structural diffing of SSZ container values (compare_fields analog).

Parity surface: lighthouse/common/compare_fields(+derive) — the
reference derives CompareFields on consensus containers so tests can
pinpoint WHICH field diverged instead of eyeballing two giant states.
Here: a recursive runtime walk over the generated value classes."""

from __future__ import annotations


def compare_fields(a, b, path: str = "", max_diffs: int = 32) -> list[tuple[str, object, object]]:
    """Recursive field-by-field diff; returns [(path, a_val, b_val)]."""
    diffs: list[tuple[str, object, object]] = []

    def walk(x, y, p):
        if len(diffs) >= max_diffs:
            return
        if hasattr(x, "ssz_type") and hasattr(y, "ssz_type"):
            for f in x.ssz_type.fields:
                walk(getattr(x, f.name), getattr(y, f.name), f"{p}.{f.name}" if p else f.name)
            return
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            if len(x) != len(y):
                diffs.append((f"{p}.len", len(x), len(y)))
                return
            for i, (xi, yi) in enumerate(zip(x, y)):
                walk(xi, yi, f"{p}[{i}]")
            return
        if isinstance(x, (bytes, bytearray)) or isinstance(y, (bytes, bytearray)):
            if bytes(x) != bytes(y):
                diffs.append((p, bytes(x), bytes(y)))
            return
        if x != y:
            diffs.append((p, x, y))

    walk(a, b, path)
    return diffs


def assert_equal(a, b, what: str = "values") -> None:
    """Assert with a field-level report on mismatch."""
    diffs = compare_fields(a, b)
    if diffs:
        lines = "\n".join(
            f"  {p}: {x!r} != {y!r}" for p, x, y in diffs[:16]
        )
        raise AssertionError(f"{what} differ in {len(diffs)} field(s):\n{lines}")
