"""The flat subset of YAML the port reads and writes without PyYAML (the
card's machine has none): the EF vectors' files (meta, slots, mapping,
roots, steps and data) and a network's config.yaml."""

from __future__ import annotations


def _yaml_scalar(text: str):
    text = text.strip()
    if text in ("true", "false"):
        return text == "true"
    if text in ("null", "~", ""):
        return None
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        return text


def read_yaml(text: str):
    """The subset of YAML the vectors' files use (meta, slots, mapping,
    roots, steps and data), as yaml.safe_load reads it, without PyYAML:
    a scalar document, block mappings and block lists of scalars or of
    mappings, quoted strings, decimal ints, true/false/null."""
    lines = []
    for raw in text.splitlines():
        body = raw.split(" #", 1)[0].rstrip()
        stripped = body.strip()
        if stripped and not stripped.startswith("#") and stripped not in ("---", "..."):
            lines.append((len(body) - len(body.lstrip()), stripped))

    def node(i: int, indent: int):
        if lines[i][1].startswith("- ") or lines[i][1] == "-":
            items = []
            while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("-"):
                rest = lines[i][1][1:].strip()
                if ":" in rest and not rest[0] in "'\"":
                    # a mapping item: its first key on the dash's line, the
                    # rest indented to that key's column
                    lines[i] = (indent + len(lines[i][1]) - len(rest), rest)
                    value, i = node(i, lines[i][0])
                    items.append(value)
                else:
                    items.append(_yaml_scalar(rest))
                    i += 1
            return items, i
        if ":" not in lines[i][1]:
            return _yaml_scalar(lines[i][1]), i + 1
        out = {}
        while i < len(lines) and lines[i][0] == indent and not lines[i][1].startswith("- "):
            key, _, rest = lines[i][1].partition(":")
            i += 1
            nested = i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("- ")))
            if rest.strip() or not nested:
                out[key.strip()] = _yaml_scalar(rest)
            else:
                out[key.strip()], i = node(i, lines[i][0])
        return out, i

    if not lines:
        return None
    value, end = node(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unparsed YAML from line {end}: {lines[end][1]!r}")
    return value
