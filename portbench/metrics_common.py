"""Helpers that several per-layer readers share."""

from __future__ import annotations


def _template_args(name: str, kernel: str):
    """The template arguments of ``kernel`` in a demangled kernel name."""
    at = name.find(kernel + "<")
    if at < 0:
        return None
    depth, args, cur = 0, [], ""
    for ch in name[at + len(kernel) + 1:]:
        if ch == "<":
            depth += 1
        elif ch == ">":
            if depth == 0:
                args.append(cur.strip())
                return args
            depth -= 1
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return None


def selection_kind(name: str):
    """'fwd' or 'bwd' for the selection kernels of ``csrc/mrconv_select.cuh``
    (``mrconv_rows_kernel<T, KC, kBackward, ...>``, ``mrconv_keys_kernel``
    only in the backward), 'norm' for the row normalisation, else None."""
    if "mrconv_keys_kernel" in name:
        return "bwd"
    if "normalize_rows_kernel" in name:
        return "norm"
    args = _template_args(name, "mrconv_rows_kernel")
    if args is None or len(args) < 3:
        return None
    return "bwd" if args[2] in ("true", "1") else "fwd"


def selection_time_s(trace, backward: bool) -> float:
    """Device seconds of the forward or the backward selection kernels;
    each row normalisation counts with the selection kernel launched next
    after it."""
    want = "bwd" if backward else "fwd"
    total, pending = 0.0, 0.0
    for name, a, b in trace.kernels:
        kind = selection_kind(name)
        if kind == "norm":
            pending += b - a
        elif kind is not None:
            if kind == want:
                total += pending + b - a
            pending = 0.0
    return total / 1e6
