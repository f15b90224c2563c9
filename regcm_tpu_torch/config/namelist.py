"""Fortran namelist parser.

The reference model is configured entirely through Fortran namelist files
(read by ``initparam`` at ``Share/mod_dynparam.F90:445`` and ``param`` at
``Main/mod_params.F90:67``). To keep the ``Testing/test_*.in`` corpus usable
verbatim, this module parses real namelist syntax into plain Python dicts:

    parse_namelist(text) -> {group_name: {var: value}}

Supported syntax: ``&group ... /`` blocks, ``!`` comments, scalar ints /
reals (``150.``, ``1.0e-3``, Fortran double ``1.d0``), logicals
(``.true.``/``.false.``/``T``/``F``), quoted strings, comma/space separated
arrays, repetition counts (``3*0.0``), and array element assignment
(``a(2) = 4``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Union

Value = Union[int, float, bool, str, list]

_GROUP_RE = re.compile(r"&(\w+)", re.MULTILINE)
_LOG_TRUE = {".true.", ".t.", "t", "true"}
_LOG_FALSE = {".false.", ".f.", "f", "false"}
_NUM_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([edED][+-]?\d+)?$"
)


def _strip_comments(text: str) -> str:
    out_lines = []
    for line in text.splitlines():
        # '!' starts a comment unless inside a quoted string
        buf = []
        in_sq = in_dq = False
        for ch in line:
            if ch == "'" and not in_dq:
                in_sq = not in_sq
            elif ch == '"' and not in_sq:
                in_dq = not in_dq
            elif ch == "!" and not in_sq and not in_dq:
                break
            buf.append(ch)
        out_lines.append("".join(buf))
    return "\n".join(out_lines)


def _parse_token(tok: str) -> Value:
    t = tok.strip()
    if not t:
        return ""
    if (t[0] == "'" and t[-1] == "'") or (t[0] == '"' and t[-1] == '"'):
        return t[1:-1]
    low = t.lower()
    if low in _LOG_TRUE:
        return True
    if low in _LOG_FALSE:
        return False
    # Fortran doubles use d exponents
    if _NUM_RE.match(t):
        if re.match(r"^[+-]?\d+$", t):
            return int(t)
        return float(low.replace("d", "e"))
    return t  # bare string


def _split_values(raw: str) -> list:
    """Split a namelist RHS into value tokens (commas and/or whitespace)."""
    toks = []
    buf = []
    in_sq = in_dq = False
    for ch in raw:
        if ch == "'" and not in_dq:
            in_sq = not in_sq
            buf.append(ch)
        elif ch == '"' and not in_sq:
            in_dq = not in_dq
            buf.append(ch)
        elif ch in ", \t\n" and not in_sq and not in_dq:
            if buf:
                toks.append("".join(buf))
                buf = []
        else:
            buf.append(ch)
    if buf:
        toks.append("".join(buf))
    out = []
    for tok in toks:
        m = re.match(r"^(\d+)\*(.*)$", tok)
        if m and not (tok.startswith("'") or tok.startswith('"')):
            out.extend([_parse_token(m.group(2))] * int(m.group(1)))
        else:
            out.append(_parse_token(tok))
    return out


def _parse_group_body(body: str, group: Dict[str, Value]) -> None:
    # split into "name = values" assignments; names may be x or x(i)
    assign_re = re.compile(
        r"([A-Za-z_]\w*(?:\(\s*\d+\s*\))?)\s*=", re.MULTILINE
    )
    matches = list(assign_re.finditer(body))
    for n, m in enumerate(matches):
        name = m.group(1)
        start = m.end()
        end = matches[n + 1].start() if n + 1 < len(matches) else len(body)
        values = _split_values(body[start:end])
        if not values:
            continue
        idx_m = re.match(r"(\w+)\(\s*(\d+)\s*\)", name)
        if idx_m:
            base, idx = idx_m.group(1).lower(), int(idx_m.group(2))
            arr = group.setdefault(base, [])
            if not isinstance(arr, list):
                arr = [arr]
            while len(arr) < idx:
                arr.append(None)
            if len(values) == 1:
                arr[idx - 1] = values[0]
            else:
                arr[idx - 1 : idx - 1 + len(values)] = values
            group[base] = arr
        else:
            group[name.lower()] = values[0] if len(values) == 1 else values


def parse_namelist(text: str) -> Dict[str, Dict[str, Value]]:
    """Parse namelist file contents into ``{group: {var: value}}``.

    Later duplicate groups update (merge into) earlier ones, matching
    Fortran reader behaviour of sequential reads.
    """
    text = _strip_comments(text)
    groups: Dict[str, Dict[str, Value]] = {}
    for m in _GROUP_RE.finditer(text):
        name = m.group(1).lower()
        if name == "end":
            continue
        # body extends to the terminating '/' (not inside quotes)
        start = m.end()
        in_sq = in_dq = False
        end = len(text)
        for k in range(start, len(text)):
            ch = text[k]
            if ch == "'" and not in_dq:
                in_sq = not in_sq
            elif ch == '"' and not in_sq:
                in_dq = not in_dq
            elif ch == "/" and not in_sq and not in_dq:
                end = k
                break
            elif ch == "&" and not in_sq and not in_dq:
                end = k
                break
        body = text[start:end]
        grp = groups.setdefault(name, {})
        _parse_group_body(body, grp)
    return groups


def read_namelist(path: str) -> Dict[str, Dict[str, Value]]:
    with open(path) as fh:
        return parse_namelist(fh.read())
