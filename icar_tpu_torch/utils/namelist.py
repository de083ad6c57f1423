"""Copy of icar_tpu/utils/namelist.py, kept identical by tests/test_torch_setup.py.

Minimal Fortran-namelist reader.

Parses the subset of Fortran namelist syntax ICAR options files use
(run/short_icar_options.nml, complete_icar_options.nml):
``&group ... /`` blocks, ``key = value[, value...]`` entries spanning lines,
``!`` comments, Fortran logicals (``.True.``/``False``), strings in single or
double quotes, and ``n*value`` repetition.
"""

from __future__ import annotations

import re
from typing import Any, Dict


def _strip_comment(line: str) -> str:
    out = []
    in_sq = in_dq = False
    for ch in line:
        if ch == "'" and not in_dq:
            in_sq = not in_sq
        elif ch == '"' and not in_sq:
            in_dq = not in_dq
        elif ch == "!" and not in_sq and not in_dq:
            break
        out.append(ch)
    return "".join(out)


_LOGICALS = {".true.": True, "true": True, "t": True, ".t.": True,
             ".false.": False, "false": False, "f": False, ".f.": False}


def _convert(tok: str) -> Any:
    tok = tok.strip()
    if not tok:
        return None
    if tok[0] in "'\"" and tok[-1] == tok[0] and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in _LOGICALS:
        return _LOGICALS[low]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok.replace("d", "e").replace("D", "E"))
    except ValueError:
        pass
    return tok


def _split_values(text: str):
    """Split a value string on commas/whitespace, respecting quotes."""
    toks, cur, quote = [], "", None
    for ch in text:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch in ", \t\n":
            if cur:
                toks.append(cur)
                cur = ""
        else:
            cur += ch
    if cur:
        toks.append(cur)
    # expand Fortran n*value repetition
    out = []
    for t in toks:
        m = re.match(r"^(\d+)\*(.+)$", t)
        if m and t[0] not in "'\"":
            out.extend([_convert(m.group(2))] * int(m.group(1)))
        else:
            out.append(_convert(t))
    return out


def read_namelist(path_or_text: str, from_string: bool = False) -> Dict[str, Dict[str, Any]]:
    """Return {group_name: {key: value-or-list}}."""
    if from_string:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()

    groups: Dict[str, Dict[str, Any]] = {}
    cur_group = None
    cur_key = None
    buf: Dict[str, str] = {}

    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if line.startswith("&"):
            cur_group = line[1:].strip().lower()
            groups.setdefault(cur_group, {})
            buf = {}
            cur_key = None
            continue
        if line == "/" or line.startswith("/"):
            if cur_group is not None:
                for k, v in buf.items():
                    vals = _split_values(v)
                    groups[cur_group][k] = vals[0] if len(vals) == 1 else vals
            cur_group = None
            cur_key = None
            continue
        if cur_group is None:
            continue
        # Find 'ident =' assignment starts outside quoted spans; a line may
        # hold several assignments ('pbl = 0, lsm = 0, mp = 2') or be a pure
        # continuation of a value list.
        masked = re.sub(r"'[^']*'|\"[^\"]*\"", lambda m: " " * (m.end() - m.start()), line)
        matches = list(re.finditer(r"(?:^|[,\s])([A-Za-z_]\w*)\s*=", masked))
        if matches:
            lead = line[: matches[0].start()].strip().strip(",")
            if lead and cur_key is not None:
                buf[cur_key] += " " + lead
            for i, m in enumerate(matches):
                cur_key = m.group(1).lower()
                end = matches[i + 1].start() if i + 1 < len(matches) else len(line)
                buf[cur_key] = line[m.end():end].strip().strip(",").strip()
        elif cur_key is not None:
            # continuation line of a value list
            buf[cur_key] += " " + line
    return groups
