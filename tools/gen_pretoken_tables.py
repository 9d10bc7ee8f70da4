#!/usr/bin/env python3
"""Write the code-point tables of GPT-2's pre-tokenizer classes.

    python3 tools/gen_pretoken_tables.py [--out PATH]

GPT-2's pre-tokenizer pattern uses three classes, ``\\s``, ``\\p{L}`` and
``\\p{N}``, as the third-party ``regex`` package defines them. Neither
``unicodedata`` nor the standard library's ``re`` gives the same sets:
``regex`` does not count U+001C-U+001F as whitespace, and its Unicode
tables are newer than the interpreter's (letters and numbers added
since, which ``unicodedata`` calls unassigned). This script asks
``regex`` itself, over every code point, and writes the classes as
sorted, inclusive (first, last) ranges into
``replicatinggpt_tpu_torch/pretoken_tables.py``, so that the port's
tokenizer needs no ``regex`` at run time. Run it again only to move to
another ``regex`` release; ``tests/test_torch_port_bpe.py`` checks the
committed tables against the installed ``regex``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import regex

OUT = (pathlib.Path(__file__).resolve().parents[1]
       / "replicatinggpt_tpu_torch" / "pretoken_tables.py")
CLASSES = (("SPACE", r"\s"), ("LETTER", r"\p{L}"), ("NUMBER", r"\p{N}"))


def class_ranges(pattern: str) -> list:
    """Inclusive (first, last) code-point ranges of ``pattern`` (a
    one-character class), from one scan over every code point."""
    every = "".join(map(chr, range(sys.maxunicode + 1)))
    return [(m.start(), m.end() - 1)
            for m in regex.finditer(f"(?:{pattern})+", every)]


def render(tables: dict) -> str:
    lines = [
        '"""Code-point classes of GPT-2\'s pre-tokenizer: ``\\\\s``, '
        '``\\\\p{L}``',
        f"and ``\\\\p{{N}}`` as ``regex`` {regex.__version__} defines them,"
        " as sorted",
        "inclusive (first, last) ranges.",
        "",
        "Generated by ``tools/gen_pretoken_tables.py``; do not edit.",
        '"""',
        "",
        f"REGEX_VERSION = {regex.__version__!r}",
    ]
    for name, ranges in tables.items():
        lines += ["", f"{name} = ("]
        row = "   "
        for a, b in ranges:
            item = f" (0x{a:X}, 0x{b:X}),"
            if len(row) + len(item) > 79:
                lines.append(row)
                row = "   "
            row += item
        lines += [row, ")"]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    tables = {name: class_ranges(pat) for name, pat in CLASSES}
    pathlib.Path(args.out).write_text(render(tables))
    print(f"wrote {args.out}: " + ", ".join(
        f"{name} {len(r)} ranges" for name, r in tables.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
