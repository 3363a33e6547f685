"""Masking of the serving lines' timing fields, shared by the CLI and
example parity tests and the card test (imports neither JAX nor the
reference): a printed line's seconds, tok/s and ms (ms/req included)
vary run to run; every other field is compared as printed."""

import re

_TIMING = [
    (re.compile(r"\bin \d+(\.\d+)?s\b"), "in <s>s"),
    (re.compile(r"\b(nan|\d+(\.\d+)?) tok/s"), "<t> tok/s"),
    (re.compile(r"\b(nan|\d+(\.\d+)?)((/| vs )(nan|\d+(\.\d+)?))? ms\b"),
     "<t> ms"),
]


def mask(line: str) -> str:
    """``line`` with its timing fields masked."""
    for pat, rep in _TIMING:
        line = pat.sub(rep, line)
    return line
