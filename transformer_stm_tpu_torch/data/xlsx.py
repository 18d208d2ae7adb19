"""Minimal dependency-free xlsx IO (stdlib zipfile + ElementTree).

The port's own copy of transformer_stm_tpu/data/xlsx.py (``read_xlsx``
:48, ``read_table`` :136, ``write_xlsx`` :203), so that the port imports nothing of the JAX
package and needs no openpyxl:

- ``read_xlsx(path)``  -> {sheet_name: list-of-rows}, numbers as float,
  shared strings and inline strings resolved, empty cells as None.
- ``read_table(path)`` -> (columns, rows) of one sheet, like a dataframe.
- ``write_xlsx(path, sheets)`` writes one or more sheets of rows (str /
  int / float / None), the Predictions_Metrics_{freq}.xlsx schema included.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
import zipfile
from typing import Any, Dict, List, Optional, Sequence

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
       "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships"}


def _col_to_index(ref: str) -> int:
    """'A'->0, 'B'->1, ..., 'AA'->26."""
    idx = 0
    for ch in ref:
        if ch.isalpha():
            idx = idx * 26 + (ord(ch.upper()) - ord("A") + 1)
    return idx - 1


def _index_to_col(idx: int) -> str:
    col = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        col = chr(ord("A") + rem) + col
    return col


def read_xlsx(path: str) -> Dict[str, List[List[Any]]]:
    """Read every sheet into a dict of row-major 2D lists."""
    with zipfile.ZipFile(path) as zf:
        # shared strings
        shared: List[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                text = "".join(t.text or "" for t in si.iter(
                    "{%s}t" % _NS["m"]))
                shared.append(text)

        # workbook sheet name -> rel id -> target path
        wb = ET.fromstring(zf.read("xl/workbook.xml"))
        rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
        rel_map = {}
        for rel in rels:
            tgt = rel.get("Target")
            if tgt.startswith("/"):
                tgt = tgt[1:]
            elif not tgt.startswith("xl/"):
                tgt = "xl/" + tgt
            rel_map[rel.get("Id")] = tgt

        # precomputed qualified tags — the namespaced findall path is ~10x
        # slower on big sheets (committed metrics files are 8k rows)
        M = "{%s}" % _NS["m"]
        ROW, CELL, V, IS, T = (M + "row", M + "c", M + "v", M + "is", M + "t")
        strip_digits = re.compile(r"\d+")

        sheets: Dict[str, List[List[Any]]] = {}
        for sh in wb.find("m:sheets", _NS):
            name = sh.get("name")
            rid = sh.get("{%s}id" % _NS["r"])
            target = rel_map[rid]
            root = ET.fromstring(zf.read(target))
            data = root.find("m:sheetData", _NS)
            max_col = 0
            parsed: List[List[tuple]] = []
            for row in data:
                if row.tag != ROW:
                    continue
                cells = []
                auto_col = 0
                for c in row:
                    if c.tag != CELL:
                        continue
                    ref = c.get("r")
                    col = _col_to_index(strip_digits.sub("", ref)) if ref \
                        else auto_col
                    auto_col = col + 1
                    ctype = c.get("t")
                    v = None
                    is_el = None
                    for child in c:
                        if child.tag == V:
                            v = child
                        elif child.tag == IS:
                            is_el = child
                    if ctype is None or ctype == "n":  # numeric (common)
                        val = float(v.text) if v is not None and v.text \
                            else None
                    elif ctype == "s":
                        val = shared[int(v.text)] if v is not None else None
                    elif ctype == "inlineStr":
                        val = "".join(t.text or "" for t in
                                      is_el.iter(T)) \
                            if is_el is not None else None
                    elif ctype == "b":
                        val = bool(int(v.text)) if v is not None else None
                    elif ctype == "str":
                        val = v.text if v is not None else None
                    else:
                        val = v.text if v is not None else None
                    cells.append((col, val))
                    if col >= max_col:
                        max_col = col + 1
                parsed.append(cells)
            rows: List[List[Any]] = []
            for cells in parsed:
                r = [None] * max_col
                for col, val in cells:
                    r[col] = val
                rows.append(r)
            sheets[name] = rows
        return sheets



def read_table(path: str, sheet: Optional[str] = None,
               header: bool = True):
    """Read one sheet as (columns, rows) like a dataframe.  columns is None
    when header=False."""
    sheets = read_xlsx(path)
    if sheet is None:
        sheet = next(iter(sheets))
    rows = sheets[sheet]
    if not rows:
        return ([], []) if header else (None, [])
    if header:
        cols = [str(c) if c is not None else "" for c in rows[0]]
        return cols, rows[1:]
    return None, rows

# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{overrides}
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
{rels}
</Relationships>"""


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _sheet_xml(rows: Sequence[Sequence[Any]]) -> str:
    out = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
           '<worksheet xmlns="http://schemas.openxmlformats.org/'
           'spreadsheetml/2006/main"><sheetData>']
    for ri, row in enumerate(rows, start=1):
        out.append(f'<row r="{ri}">')
        for ci, val in enumerate(row):
            if val is None:
                continue
            ref = f"{_index_to_col(ci)}{ri}"
            if isinstance(val, bool):
                out.append(f'<c r="{ref}" t="b"><v>{int(val)}</v></c>')
            elif isinstance(val, (int, float)):
                out.append(f'<c r="{ref}"><v>{val!r}</v></c>')
            else:
                out.append(f'<c r="{ref}" t="inlineStr"><is><t'
                           f' xml:space="preserve">{_esc(str(val))}'
                           '</t></is></c>')
        out.append("</row>")
    out.append("</sheetData></worksheet>")
    return "".join(out)


def write_xlsx(path: str, sheets: Dict[str, Sequence[Sequence[Any]]]) -> None:
    """sheets: {name: rows}; each row a sequence of str/int/float/bool/None."""
    names = list(sheets)
    overrides = "\n".join(
        f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
        'worksheet+xml"/>' for i in range(len(names)))
    wb_sheets = "".join(
        f'<sheet name="{_esc(n)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
        for i, n in enumerate(names))
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/'
        '2006/main" xmlns:r="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships"><sheets>'
        f"{wb_sheets}</sheets></workbook>")
    rels = "\n".join(
        f'<Relationship Id="rId{i + 1}" Type="http://schemas.openxmlformats'
        '.org/officeDocument/2006/relationships/worksheet" '
        f'Target="worksheets/sheet{i + 1}.xml"/>'
        for i in range(len(names)))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml",
                    _CONTENT_TYPES.format(overrides=overrides))
        zf.writestr("_rels/.rels", _RELS)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", _WB_RELS.format(rels=rels))
        for i, n in enumerate(names):
            zf.writestr(f"xl/worksheets/sheet{i + 1}.xml",
                        _sheet_xml(sheets[n]))
